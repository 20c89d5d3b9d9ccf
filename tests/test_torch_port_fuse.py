"""Conv+BN folding in the port (frlw_evd_tpu_torch/models/fuse.py) against
the unfolded model and against the JAX package's fuse_conv_bn_params, on
the CPU.

A narrow AED (32 wide, 64x64 input) with spread BatchNorm statistics and
affines: the folded state_dict loads into the same model and its forward
matches the unfolded one in f32 to 1e-4 (tests/test_fuse_ema.py:14-33's
gate), and the folded state_dict equals JAX's folded tree, converted by
weights.flax_to_state_dict, to 1e-6 (both fold in f32; rsqrt may round
differently by an ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models.fuse import fuse_conv_bn_params as jax_fuse
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.fuse import fuse_conv_bn_params
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables

NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)


def _spread_stats(variables, rng):
    out = {}
    for col, tree in variables.items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            a = np.array(a, np.float32)
            if path[-1] == "var":
                a = rng.uniform(0.5, 2.0, a.shape)
            elif path[-1] == "mean":
                a = rng.normal(0, 0.2, a.shape)
            elif path[-2] == "bn":
                a = (rng.uniform(0.5, 1.5, a.shape) if path[-1] == "scale"
                     else rng.normal(0, 0.2, a.shape))
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module", params=["bfm", "focus"])
def folded(request):
    stem = request.param
    jmodel = jax_build(2, family="aed", stem=stem, **NARROW)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, 64, 64, 16), jnp.float32), False)
    variables = _spread_stats(variables, np.random.default_rng(0))
    model = load_flax_variables(build_detector(2, stem=stem, **NARROW),
                                variables)
    return stem, variables, model, fuse_conv_bn_params(model.state_dict())


def test_fold_preserves_the_forward(folded):
    stem, _, model, fused_sd = folded
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 16)).astype(np.float32))
    with torch.inference_mode():
        ref = model(x)
        fused = build_detector(2, stem=stem, **NARROW)
        fused.load_state_dict(fused_sd)
        out = fused(x)
    n_bn = sum(1 for k in fused_sd if k.endswith("bn.running_var"))
    assert n_bn > 20
    for k in fused_sd:
        if k.endswith("bn.running_mean"):
            assert not fused_sd[k].any(), k
    for a, b in zip(ref, out):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_fold_matches_jax(folded):
    _, variables, _, fused_sd = folded
    fp, fb = jax_fuse(variables["params"], variables["batch_stats"])
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, fp),
                               "batch_stats": jax.tree.map(np.asarray, fb)})
    assert set(want) <= set(fused_sd)
    for key, w in want.items():
        torch.testing.assert_close(fused_sd[key], w, atol=1e-6, rtol=1e-6,
                                   msg=key)
