"""The port's Video Swin 3D and the TAF swin and correlation stems
(models/swin3d.py) against the JAX package's on the CPU, f32.

Weights go across with weights.load_flax_variables (Dense kernels
transposed, the Conv3d kernel DHWIO → OIDHW, LayerNorm scale → weight, the
relative position bias tables as they are) from JAX's variables tree, its
shapes by jax.eval_shape, filled from a numpy seed (seeded_variables).
Tokens compare in the JAX layout (B, D, H, W, C); stems return NCHW and
compare transposed. Gates: every output within 2e-4 (ROADMAP's f32
forward gate); the numpy tables (relative position index, shift mask)
and the window partitions exactly. The helpers here (seeded_variables,
EqualDropout, fast_jit) serve the other parity files of the new stems.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import swin3d as J
from frlw_evd_tpu_torch.models import swin3d as P
from frlw_evd_tpu_torch.models.blocks import Dropout
from frlw_evd_tpu_torch.weights import (flax_path, flax_to_state_dict,
                                        load_flax_variables, state_dict_key)
from test_torch_port_memory import _two_torch_threads  # noqa: F401

TOL = 2e-4
# Each JAX reference is compiled once and run once, and the XLA compile is
# most of its time: LLVM at -O0 (a 16-wide detector's f64 train step
# compiled in 4.6 s at level 0 and 6.6 s at the default level on the CPU
# backend). The numbers differ from the default level's by rounding.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def fast_jit(fn, **kw):
    """jax.jit compiling with FAST_COMPILE."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def variable_shapes(module, *args):
    """The tree of module.init(key, *args) by jax.eval_shape (traced,
    nothing compiled)."""
    return jax.eval_shape(lambda: module.init(jax.random.key(0), *args))


def seeded_variables(module, rng, *args, shapes=None):
    """The variables of module.init(key, *args), their tree
    variable_shapes' (or `shapes`), filled from rng: conv and Dense
    kernels and weight-norm v N(0, 1 / fan_in), the bias tables N(0, 0.5)
    (large enough that a wrong row shows), BatchNorm variances U(0.5, 2),
    scales and gains U(0.5, 1.5), means and biases N(0, 0.1)."""
    if shapes is None:
        shapes = variable_shapes(module, *args)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            leaf = path[-1]
            if leaf in ("kernel", "v"):
                v = rng.normal(0, 1 / np.sqrt(np.prod(a.shape[:-1])),
                               a.shape)
            elif leaf == "relative_position_bias_table":
                v = rng.normal(0, 0.5, a.shape)
            elif leaf == "var":
                v = rng.uniform(0.5, 2.0, a.shape)
            elif leaf in ("scale", "g"):
                v = rng.uniform(0.5, 1.5, a.shape)
            else:
                assert leaf in ("mean", "bias"), path
                v = rng.normal(0, 0.1, a.shape)
            flat[path] = v.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


class EqualDropout:
    """The same dropout masks in both packages: the i-th dropout call of a
    forward keeps default_rng(seed + i).random(shape) < 1 - rate, the
    shape in the JAX layout (NHWC for 4-D inputs), scaled by 1 / (1 -
    rate) as both do. JAX's side intercepts nn.Dropout.__call__ with
    flax.linen.intercept_methods (nothing in the package changes), the
    port's replaces Dropout.forward; each context yields its list of the
    masked calls' shapes."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def mask(self, i, shape, rate):
        return np.random.default_rng(self.seed + i).random(shape) < 1 - rate

    @contextlib.contextmanager
    def jax(self):
        calls = []

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if not (isinstance(mod, linen.Dropout)
                    and context.method_name == "__call__"):
                return next_fun(*args, **kwargs)
            det = kwargs.get("deterministic")
            det = mod.deterministic if det is None else det
            x = args[0]
            if det or mod.rate == 0:
                return x
            keep = jnp.asarray(self.mask(len(calls), x.shape, mod.rate))
            calls.append(tuple(x.shape))
            return jnp.where(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))

        with linen.intercept_methods(interceptor):
            yield calls

    @contextlib.contextmanager
    def torch(self):
        calls = []

        def forward(mod, x):
            if not mod.training or mod.rate == 0:
                return x
            shape = ((x.shape[0], *x.shape[2:], x.shape[1]) if x.dim() == 4
                     else tuple(x.shape))
            m = torch.from_numpy(self.mask(len(calls), shape, mod.rate))
            calls.append(shape)
            if x.dim() == 4:
                m = m.permute(0, 3, 1, 2)
            return torch.where(m.to(x.device), x / (1.0 - mod.rate), 0.0)

        with mock.patch.object(Dropout, "forward", forward):
            yield calls


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want), (what, got.shape, np.shape(want))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0,
                               err_msg=what)


def _pair(jm, tm, x, *rest, seed=0):
    """(JAX output, port output) of a module pair on the JAX-layout input
    x (and more inputs), the variables carried from a seeded tree."""
    variables = seeded_variables(jm, np.random.default_rng(seed), x, *rest)
    want = fast_jit(jm.apply)(variables, x, *rest)
    load_flax_variables(tm, variables).eval()
    with torch.no_grad():
        got = tm(_t(x), *[_t(r) if isinstance(r, np.ndarray) else r
                          for r in rest])
    return want, got


@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("bf16", "bf16"),
                                    ("f32", "bf16")],
                         ids=["f32", "bf16", "f32-input-bf16-params"])
def test_layer_norm_matches_flax(dtypes):
    """flax's epsilon 1e-6, not torch's 1e-5: on features of variance
    about 1e-6 the two epsilons differ by a factor of 3 in the output.
    The statistics in f32, the result in the wider of the input's and the
    parameters' dtypes, as flax's. The variance is centred (ROADMAP §C):
    on features whose mean is 500 times their spread, flax's
    E[x^2] - E[x]^2 in f32 loses 1.5% of the variance; the port's output
    stays within 1e-4 of the f64 one there."""
    xd, pd = ({"f32": jnp.float32, "bf16": jnp.bfloat16}[d] for d in dtypes)
    rng = np.random.default_rng(8)
    x = (1e-3 * rng.normal(size=(3, 5, 16))).astype(np.float32)
    if dtypes == ("f32", "f32"):
        off = x + np.float32(0.5)
        mu = off.astype(np.float64).mean(-1, keepdims=True)
        exact = (off - mu) / np.sqrt(off.astype(np.float64).var(
            -1, keepdims=True) + 1e-6)
        with torch.no_grad():
            np.testing.assert_allclose(P.LayerNorm(16)(_t(off)).numpy(),
                                       exact, atol=1e-4, rtol=0)
    jm = linen.LayerNorm()
    variables = seeded_variables(jm, rng, x)
    want = jm.apply(jax.tree.map(lambda a: jnp.asarray(a, pd), variables),
                    jnp.asarray(x, xd))
    tm = load_flax_variables(P.LayerNorm(16), variables)
    td = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    with torch.no_grad():
        got = tm.to(td[pd])(_t(x).to(td[xd]))
    assert got.dtype == td[want.dtype.type]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL if xd == pd == jnp.float32 else 2e-2,
                               rtol=0)


def test_window_partitions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 8, 12, 3)).astype(np.float32)
    ws = (2, 4, 4)
    w = P.window_partition(_t(x), ws)
    np.testing.assert_array_equal(w.numpy(), np.asarray(J.window_partition(
        x, ws)))
    np.testing.assert_array_equal(
        P.window_reverse(w, ws, 2, 4, 8, 12).numpy(), x)
    xr = rng.normal(size=(2, 3, 4, 8, 12, 5)).astype(np.float32)
    c = P.corr_window_partition(_t(xr), ws)
    np.testing.assert_array_equal(c.numpy(), np.asarray(
        J.corr_window_partition(xr, ws)))
    np.testing.assert_array_equal(
        P.corr_window_reverse(c, ws, 2, 3, 4, 8, 12).numpy(), xr)


@pytest.mark.parametrize("size,window,shift", [
    ((4, 8, 12), (2, 4, 4), (0, 2, 2)), ((2, 8, 10), (2, 4, 4), (1, 2, 2)),
    ((1, 3, 12), (2, 4, 4), (1, 2, 2)), ((4, 4, 4), (2, 4, 4), (0, 2, 2))],
    ids=["shifted", "time-clamped", "two-clamped", "hw-clamped"])
def test_window_sizes_and_shift_masks_equal_jax(size, window, shift):
    """get_window_size clamps the window and zeroes the shift where the
    input is no larger; the mask of the clamped window (slice(-0, None)
    covering an unshifted axis) equals JAX's numpy table."""
    ws, ss = P.get_window_size(size, window, shift)
    assert (ws, ss) == J.get_window_size(size, window, shift)
    assert P.get_window_size(size, window) == J.get_window_size(size, window)
    padded = tuple(-(-n // w) * w for n, w in zip(size, ws))
    np.testing.assert_array_equal(P.compute_shift_mask(*padded, ws, ss),
                                  J.compute_shift_mask(*padded, ws, ss))
    np.testing.assert_array_equal(P._relative_position_index(ws),
                                  J._relative_position_index(ws))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_window_attention_matches_flax(masked):
    ws, nh, dim = (2, 4, 4), 2, 8
    rng = np.random.default_rng(1)
    mask = (P.compute_shift_mask(4, 8, 8, ws, (1, 2, 2)) if masked
            else None)
    n_w = 8 if masked else 3
    x = rng.normal(size=(2 * n_w, 32, dim)).astype(np.float32)
    jm = J.WindowAttention3D(dim, ws, nh)
    variables = seeded_variables(jm, rng, x, mask)
    want = fast_jit(jm.apply)(variables, x, mask)
    tm = load_flax_variables(P.WindowAttention3D(dim, ws, nh), variables)
    with torch.no_grad():
        got = tm(_t(x), None if mask is None else _t(mask))
    _close(got, want)


@pytest.mark.parametrize("size,shift", [
    ((4, 8, 12), (0, 2, 2)), ((4, 7, 10), (0, 2, 2)), ((4, 8, 12), (0, 0, 0)),
    ((2, 8, 10), (1, 2, 2))],
    ids=["shifted", "shifted-padded", "plain", "clamped"])
def test_swin_block_matches_flax(size, shift):
    """The roll before the partition and its inverse after, the padding
    and, where the input clamps the window to its declared size (D = 2,
    as in the swin stem's last time stage), the shift zeroed in D."""
    x = np.random.default_rng(2).normal(size=(2, *size, 8)).astype(
        np.float32)
    want, got = _pair(J.SwinBlock3D(8, 2, (2, 4, 4), shift),
                      P.SwinBlock3D(8, 2, (2, 4, 4), shift), x)
    _close(got, want)


def test_swin_block_refuses_an_input_that_clamps_its_window():
    """An input that would clamp the window to another size than declared
    (JAX sizes the bias table by the clamped window at trace time) raises,
    in a Swin block and in a correlation layer."""
    block = P.SwinBlock3D(8, 2, (2, 4, 4), (0, 2, 2))
    with pytest.raises(ValueError, match="clamps the window"):
        block(torch.zeros(1, 2, 3, 8, 8))
    layer = P.CorrLayer3D(8, 3)
    with pytest.raises(ValueError, match="clamps the window"):
        layer(torch.zeros(1, 1, 2, 8, 3, 8), torch.zeros(1, 3, 2, 8, 3, 8))


@pytest.mark.parametrize("case", ["merge", "merge_odd", "merge_time",
                                  "layer_time", "layer_spatial", "embed",
                                  "embed_norm"])
def test_swin_parts_match_flax(case):
    rng = np.random.default_rng(3)
    size = {"merge_odd": (2, 5, 7), "embed": (3, 9, 10),
            "embed_norm": (3, 9, 10)}.get(case, (4, 8, 12))
    cin = 2 if case.startswith("embed") else 8
    x = rng.normal(size=(2, *size, cin)).astype(np.float32)
    jm, tm = {
        "merge": (J.PatchMerging(8), P.PatchMerging(8)),
        "merge_odd": (J.PatchMerging(8), P.PatchMerging(8)),
        "merge_time": (J.PatchMergingTime(8, 12), P.PatchMergingTime(8, 12)),
        "layer_time": (J.BasicLayer3D(8, 16, 2, 2, (2, 4, 4), "time"),
                       P.BasicLayer3D(8, 16, 2, 2, (2, 4, 4), "time")),
        "layer_spatial": (J.BasicLayer3D(8, 16, 3, 2, (1, 4, 5), "spatial"),
                          P.BasicLayer3D(8, 16, 3, 2, (1, 4, 5), "spatial")),
        "embed": (J.PatchEmbed3D((2, 2, 4), 8),
                  P.PatchEmbed3D(2, (2, 2, 4), 8)),
        "embed_norm": (J.PatchEmbed3D((1, 2, 2), 8, True),
                       P.PatchEmbed3D(2, (1, 2, 2), 8, True)),
    }[case]
    want, got = _pair(jm, tm, x)
    _close(got, want, case)


def test_swin_transformer3d_matches_flax():
    """Two temporal stages and the 2, 2, 6, 2 spatial pyramid on a
    (4, 68, 84) video embedded at (1, 2, 2): the last stage sees 5 x 6
    tokens, more than its (4, 5) window, and every stage pads."""
    x = np.random.default_rng(4).uniform(0, 1, (1, 4, 68, 84, 2)).astype(
        np.float32)
    jm = J.SwinTransformer3D(2, depth_time_stages=2, embed_dim=8,
                             num_heads=1, patch_size=(1, 2, 2))
    tm = P.SwinTransformer3D(2, depth_time_stages=2, embed_dim=8,
                             num_heads=1, patch_size=(1, 2, 2))
    want, got = _pair(jm, tm, x)
    _close(got, want)


def test_corr_attention_and_layer_match_flax():
    """CorrAttention3D's (2wd-1)(2wh-1)(2ww-1)-row table indexed by the
    (1, wh, ww) index tiled (wd, wd), and CorrLayer3D over its windows."""
    rng = np.random.default_rng(5)
    xw = rng.normal(size=(6, 32, 8)).astype(np.float32)
    rw = rng.normal(size=(6, 3, 32, 8)).astype(np.float32)
    want, got = _pair(J.CorrAttention3D(8, 3, (2, 4, 4)),
                      P.CorrAttention3D(8, 3, (2, 4, 4)), xw, rw)
    assert dict(P.CorrAttention3D(8, 3, (2, 4, 4)).named_parameters())[
        "relative_position_bias_table"].shape == (3 * 7 * 7, 3)
    _close(got, want, "attention")
    x = rng.normal(size=(2, 1, 4, 8, 12, 8)).astype(np.float32)
    r = rng.normal(size=(2, 3, 4, 8, 12, 8)).astype(np.float32)
    want, got = _pair(J.CorrLayer3D(8, 3), P.CorrLayer3D(8, 3), x, r)
    _close(got, want, "layer")


@pytest.mark.parametrize("stem,K", [("swin", 4), ("swin", 8), ("corr", 4),
                                    ("corr", 8)])
def test_taf_stems_match_flax(stem, K):
    """TemporalActiveFocusSwin and TemporalActiveFocusCorr on a (2, 16,
    24, 2K) volume, U(0, 1) as TAF volumes are: eval, then training mode
    (the stem's BaseConv on its batch statistics, the corr stem's dropout
    masks equal) with the running statistics after it within 1e-5."""
    x = np.random.default_rng(6).uniform(0, 1, (2, 16, 24, 2 * K)).astype(
        np.float32)
    jcls, tcls = {"swin": (J.TemporalActiveFocusSwin,
                           P.TemporalActiveFocusSwin),
                  "corr": (J.TemporalActiveFocusCorr,
                           P.TemporalActiveFocusCorr)}[stem]
    jm, tm = jcls(12, embed_dim=8), tcls(2 * K, 12, embed_dim=8)
    variables = seeded_variables(jm, np.random.default_rng(7), x, False)
    load_flax_variables(tm, variables).eval()
    with torch.no_grad():
        got = tm(_t(x)).permute(0, 2, 3, 1)
    _close(got, fast_jit(lambda v, xx: jm.apply(v, xx, False))(variables,
                                                                x),
           "eval")

    drops = EqualDropout(11)
    with drops.jax() as j_calls:
        want, upd = fast_jit(lambda v, xx: jm.apply(
            v, xx, True, mutable=["batch_stats"]))(variables, x)
    with drops.torch() as t_calls, torch.no_grad():
        got = tm.train()(_t(x)).permute(0, 2, 3, 1)
    assert j_calls == t_calls and (stem == "swin") == (not j_calls)
    _close(got, want, "train")
    sd = tm.state_dict()
    for key, v in flax_to_state_dict(upd).items():
        np.testing.assert_allclose(sd[key].numpy(), v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


def test_new_leaves_map_back_to_flax():
    """Every state_dict key of both stems maps back to its flax path
    (flax_path), so JAX's importer takes the port's checkpoints: the
    LayerNorms' weight to scale, the bias tables to themselves, the
    Dense kernels and the Conv3d kernel to kernel."""
    for jm in (J.TemporalActiveFocusSwin(12, embed_dim=8),
               J.TemporalActiveFocusCorr(12, embed_dim=8)):
        variables = seeded_variables(jm, np.random.default_rng(0),
                                     np.zeros((1, 16, 24, 8), np.float32))
        seen = 0
        for col, tree in variables.items():
            for path, a in flatten_dict(tree).items():
                assert flax_path(state_dict_key(col, path)) == (col, path)
                seen += 1
        sd = flax_to_state_dict(variables)
        assert len(sd) == seen
        kinds = {k.rsplit(".", 1)[-1] for k in sd}
        assert "relative_position_bias_table" in kinds
