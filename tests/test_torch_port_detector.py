"""Port AED detector, decode and NMS against the JAX package on the CPU.

A narrow AED (stem 16, pyramid and head 32 wide, input 64x96) runs in f32
on both sides with the JAX variables carried across by
frlw_evd_tpu_torch.weights; BatchNorm statistics, weight-norm gains and
biases are randomised first so every mapping is exercised. Head outputs
match to 2e-4 (the torch-import parity gate of tests/test_torch_import.py).
Decode matches to 1e-5, keep masks exactly, on fixtures with tied scores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models.detector import eval_decode as jax_eval_decode
from frlw_evd_tpu.models.postprocess import \
    postprocess_batch as jax_postprocess
from frlw_evd_tpu.train.checkpoints import import_torch_checkpoint
from frlw_evd_tpu_torch.models import (build_detector, eval_decode,
                                       postprocess_batch)
from frlw_evd_tpu_torch.weights import flax_path, load_flax_variables

NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
H, W = 64, 96
STRIDES = (8, 16, 32)


def randomize_variables(variables, rng):
    """numpy copy of flax variables with non-trivial BN statistics, BN
    affine, weight-norm gains and biases (the init leaves them 0/1)."""
    out = {}
    for col, tree in variables.items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            a = np.asarray(a, np.float32)
            leaf = path[-1]
            if leaf == "var":
                a = rng.uniform(0.5, 2.0, a.shape)
            elif leaf in ("mean", "bias"):
                a = a + rng.normal(0, 0.1, a.shape)
            elif leaf in ("scale", "g"):
                a = rng.uniform(0.5, 1.5, a.shape)
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module", params=["bfm", "focus"])
def narrow_pair(request):
    stem = request.param
    jmodel = jax_build(2, family="aed", stem=stem, **NARROW)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, H, W, 16), jnp.float32), False)
    variables = randomize_variables(variables, np.random.default_rng(0))
    tmodel = build_detector(2, stem=stem, **NARROW)
    load_flax_variables(tmodel, variables)
    return stem, jmodel, variables, tmodel


def test_forward_matches_flax(narrow_pair):
    stem, jmodel, variables, tmodel = narrow_pair
    x = np.random.default_rng(1).uniform(0, 1, (2, H, W, 16)).astype(
        np.float32)
    j_outs = jax.jit(lambda v, xx: jmodel.apply(v, xx, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        t_outs = tmodel(torch.from_numpy(x))
    assert len(t_outs) == 3
    for lvl, (t, j) in enumerate(zip(t_outs, j_outs)):
        assert t.shape == j.shape == (2, H // STRIDES[lvl], W // STRIDES[lvl],
                                      4 + 1 + 2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4,
                                   err_msg=f"{stem} level {lvl}")


def test_weights_round_trip_through_jax_importer(narrow_pair, tmp_path):
    """The port's state_dict, saved with torch.save and read back by the
    JAX package's own importer (checkpoints.py:156), gives back the
    original arrays — which also checks the HWIO ↔ OIHW transposes against
    its _convert_tensor."""
    stem, jmodel, variables, tmodel = narrow_pair
    path = tmp_path / "port.pth"
    torch.save(tmodel.state_dict(), path)
    params, stats, report = import_torch_checkpoint(
        str(path), variables["params"], variables["batch_stats"],
        rename_fn=flax_path, strict=True)
    n_keys = sum(1 for k in tmodel.state_dict()
                 if not k.endswith("num_batches_tracked"))
    assert report["loaded"] == n_keys and report["unmatched"] == []
    for col, tree in (("params", params), ("batch_stats", stats)):
        got, want = flatten_dict(tree), flatten_dict(variables[col])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg="/".join(k))


def test_patch_fused_conv_equals_patchify_then_conv():
    """The fused 6x6 stride-2 stem conv equals space_to_depth_patches (the
    [tl, bl, tr, br] order, checked against the JAX function) followed by
    the canonical 3x3 conv with the same (O, 4C, 3, 3) weight."""
    from frlw_evd_tpu.models.blocks import \
        space_to_depth_patches as jax_s2d
    from frlw_evd_tpu_torch.models.blocks import (PatchFusedConv2d,
                                                  space_to_depth_patches)

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)       # NHWC
    s2d = space_to_depth_patches(torch.from_numpy(x))
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jax_s2d(x)))
    conv = PatchFusedConv2d(3, 5)
    torch.nn.init.normal_(conv.weight)
    with torch.no_grad():
        fused = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        plain = torch.nn.functional.conv2d(s2d.permute(0, 3, 1, 2),
                                           conv.weight, padding=1)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)


def _tied_level_outputs(rng, n=3, num_classes=2):
    """Raw head maps at the narrow model's 64x96 levels with many exact
    ties: obj and cls logits drawn from a few values, overlapping boxes."""
    outs = []
    for s in STRIDES:
        h, w = H // s, W // s
        o = np.empty((n, h, w, 5 + num_classes), np.float32)
        o[..., :2] = rng.normal(0, 0.6, (n, h, w, 2))
        o[..., 2:4] = rng.normal(1.6, 0.4, (n, h, w, 2))
        o[..., 4] = rng.choice([-3.0, -0.5, 0.2, 1.0, 2.0], (n, h, w))
        o[..., 5:] = rng.choice([-1.0, 0.0, 1.0], (n, h, w, num_classes))
        outs.append(o)
    return outs


@pytest.mark.parametrize("nms_impl", ["fixpoint", "sequential"])
def test_decode_and_nms_match_jax_with_ties(nms_impl):
    outs = _tied_level_outputs(np.random.default_rng(3))
    j_dec = jax_eval_decode([jnp.asarray(o) for o in outs], STRIDES)
    t_dec = eval_decode([torch.from_numpy(o) for o in outs], STRIDES)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=1e-5)

    j_dets, j_keep = jax_postprocess(j_dec, max_detections=100,
                                     nms_impl=nms_impl)
    t_dets, t_keep = postprocess_batch(t_dec, max_detections=100,
                                       nms_impl=nms_impl)
    j_keep = np.asarray(j_keep)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    np.testing.assert_allclose(t_dets.numpy(), np.asarray(j_dets), atol=1e-5)

    # the fixture exercises what it claims: tied scores among the valid
    # candidates, and both kept and suppressed boxes
    top = np.sort(np.asarray(j_dec)[..., 4], axis=1)[:, ::-1][:, :100]
    valid = top > 0.3
    assert all(len(np.unique(t[v])) < v.sum() for t, v in zip(top, valid))
    assert j_keep.any() and (valid & ~j_keep).any()
