"""The port's int8 serving path (frlw_evd_tpu_torch/models/quantize.py)
against the JAX package's (frlw_evd_tpu/models/quantize.py), on the CPU.

A small AED (BFM stem, every trunk, neck and head conv 64 wide so that the
sites engage, 64x96 input) carries JAX's variables into the port
(weights.load_flax_variables). Gates:
- weight codes and scales equal JAX's exactly (same f32 division and
  round-half-even), the weight tables equal after HWIO -> OIHW;
- the twin's int32 conv equals lax.conv_general_dilated(...,
  preferred_element_type=int32) exactly (integer sums);
- the site keys equal JAX's calibrated keys, the scales to rtol 1e-6 in f32
  (both record max|x| of f32 activations that agree to f32 rounding);
- empty scales leave the forward bit for bit;
- with JAX's scales and tables fed to both, the port's int8 head maps are
  within relative L2 0.02 of JAX's (tests/test_quantize.py:277's gate
  between two int8 forms), and the int8 maps within 0.08 of the port's
  bf16 maps (:132);
- an input 100x past its calibration clips to finite outputs (:215);
- int8_ctx with act_dtype bf16 on the f32 model: every site exactly the
  twin on its bf16-rounded input, the maps within 0.02 of the f32 sites'.
The kernel itself is held to the twin on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models import quantize as jq
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models import quantize as q
from frlw_evd_tpu_torch.weights import load_flax_variables

WIDE = dict(in_channels=(64, 64, 64), stem_out_channels=64, head_width=64)
H, W = 64, 96


def _spread(variables, rng):
    """numpy copy with BatchNorm statistics and affines spread, so that the
    activations are not near-constant at init."""
    out = {}
    for col, tree in variables.items():
        flat = {}
        for path, a in flatten_dict(tree).items():
            a = np.array(a, np.float32)
            if path[-1] == "var":
                a = rng.uniform(0.5, 2.0, a.shape)
            elif path[-1] == "mean":
                a = rng.normal(0, 0.1, a.shape)
            elif path[-1] == "scale" and path[-2] == "bn":
                a = rng.uniform(0.8, 1.5, a.shape)
            elif path[-1] == "bias" and path[-2] == "bn":
                a = rng.normal(0, 0.3, a.shape)
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX model, f32 numpy variables, port model in f32 on the CPU,
    calibration batches, test input)."""
    jmodel = jax_build(2, family="aed", stem="bfm", **WIDE)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, H, W, 16), jnp.float32), False)
    variables = _spread(variables, np.random.default_rng(0))
    tmodel = load_flax_variables(build_detector(2, stem="bfm", **WIDE),
                                 variables)
    rng = np.random.default_rng(1)
    calib = [rng.uniform(0, 1, (2, H, W, 16)).astype(np.float32)
             for _ in range(2)]
    x = rng.uniform(0, 1, (2, H, W, 16)).astype(np.float32)
    return jmodel, variables, tmodel, calib, x


@pytest.fixture(scope="module")
def jax_quant(pair):
    """JAX's scales and table on the pair's variables and batches, and its
    int8 and f32 forwards of the test input."""
    jmodel, variables, _, calib, x = pair
    scales = jq.calibrate_int8(jmodel, variables,
                               [jnp.asarray(c) for c in calib])
    table = jq.build_weight_table(variables["params"], scales)

    @jax.jit
    def quant_fwd(v, xx):
        with jq.int8_ctx(scales, table):
            return jmodel.apply(v, xx, False)

    maps = [np.asarray(o, np.float64)
            for o in quant_fwd(variables, jnp.asarray(x))]
    return scales, table, maps


def _port_table(table):
    """JAX's table with its codes HWIO -> OIHW, as torch tensors."""
    return {k: (torch.from_numpy(np.asarray(kq).transpose(3, 2, 0, 1).copy()),
                torch.from_numpy(np.array(sw)))
            for k, (kq, sw) in table.items()}


def _heads(model, x, dtype=torch.float32):
    with torch.inference_mode():
        return [o.double().numpy()
                for o in model(torch.from_numpy(x).to(dtype))]


def _rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.mark.parametrize("shape,std", [((3, 3, 64, 64), 0.1),
                                       ((1, 1, 128, 64), 1.0),
                                       ((3, 3, 32, 8), 1e-3)])
def test_quantize_kernel_equals_jax(shape, std):
    """Codes and per-channel scales bit for bit, on an HWIO kernel (one
    output channel all zero: the 1e-12 floor)."""
    k = np.random.default_rng(2).normal(0, std, shape).astype(np.float32)
    k[..., 0] = 0.0
    kq, sw = jq.quantize_kernel(jnp.asarray(k))
    pq, psw = q.quantize_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert pq.dtype == torch.int8 and psw.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(),
                                  np.asarray(kq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(psw.numpy(), np.asarray(sw))


def test_weight_table_equals_jax(pair, jax_quant):
    """The port's table from its state_dict equals JAX's from the same
    variables, HWIO -> OIHW, for every calibrated site."""
    _, _, tmodel, _, _ = pair
    scales, table, _ = jax_quant
    ptable = q.build_weight_table(tmodel.state_dict(), scales)
    assert set(ptable) == set(table)
    for key, (kq, sw) in _port_table(table).items():
        assert torch.equal(ptable[key][0], kq), key
        assert torch.equal(ptable[key][1], sw), key


@pytest.mark.parametrize("hw", [(9, 12), (10, 7)], ids=["even-w", "odd-w"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_int8_conv_twin_equals_jax_int32(k, stride, hw):
    """The twin's int32 sums equal XLA's int8 conv with int32 accumulation
    (quantize.py:283-286) exactly; its output is the dequant of them."""
    rng = np.random.default_rng(3)
    cin, cout = 64, 40
    x = rng.normal(0, 1.5, (2, *hw, cin)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, cin, cout)).astype(np.float32)
    sx = float(np.abs(x).max()) * 0.8 / 127.0     # some inputs clip
    kq, sw = jq.quantize_kernel(jnp.asarray(w))
    xq = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / sx)), -127,
                  127).astype(jnp.int8)
    pad = (k - 1) // 2
    want = np.asarray(jax.lax.conv_general_dilated(
        xq, kq, (stride, stride), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    wq = torch.from_numpy(np.asarray(kq).transpose(3, 0, 1, 2).copy())
    scale = torch.from_numpy(np.array(sw)) * torch.tensor(
        sx, dtype=torch.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    out, acc = q.int8_conv2d_plain(xt, wq, scale, 1.0 / sx, stride=stride,
                                   return_acc=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().transpose(0, 2, 3, 1), want)
    deq = np.asarray(want.astype(np.float32) * (sw * sx))
    np.testing.assert_array_equal(out.numpy().transpose(0, 2, 3, 1), deq)
    got = q.int8_conv2d(xt, wq, scale, 1.0 / sx, stride=stride)
    assert torch.equal(got, out)


def test_site_keys_and_scales_equal_jax(pair, jax_quant):
    """Same sites as JAX's calibration (no pred conv, no stem conv), scales
    to rtol 1e-6 in f32."""
    _, _, tmodel, calib, _ = pair
    scales, _, _ = jax_quant
    pscales = q.calibrate_int8(tmodel, [torch.from_numpy(c) for c in calib])
    assert set(pscales) == set(scales) == set(q.eligible_sites(tmodel))
    assert len(scales) > 20
    assert not any("preds" in k or k.startswith("backbone/stem/")
                   for k in pscales)
    for key, sx in scales.items():
        np.testing.assert_allclose(pscales[key], sx, rtol=1e-6, err_msg=key)


def test_empty_scales_leave_the_forward_bit_exact(pair):
    _, _, tmodel, _, x = pair
    base = _heads(tmodel, x)
    with q.int8_ctx(tmodel, {}, {}):
        quant = _heads(tmodel, x)
    for b, o in zip(base, quant):
        np.testing.assert_array_equal(b, o)
    assert all(type(m).forward is m.forward.__func__
               for m in q.eligible_sites(tmodel).values())


def test_int8_maps_close_to_jax_and_to_bf16(pair, jax_quant):
    """JAX's scales and tables in both frameworks: the port's int8 maps
    (f32 model) within relative L2 0.02 of JAX's int8 maps, and the int8
    serving form (bf16 model) within 0.08 of the port's bf16 maps. Every
    site went through the int8 conv and then back to its own forward."""
    _, variables, tmodel, _, x = pair
    scales, table, jmaps = jax_quant
    ptable = _port_table(table)
    ctx = q.int8_ctx(tmodel, scales, ptable)
    assert set(ctx.sites) == set(scales)
    with ctx:
        maps = _heads(tmodel, x)
    for lvl, (m, j) in enumerate(zip(maps, jmaps)):
        assert _rel(m, j) < 0.02, (lvl, _rel(m, j))
    assert not any("forward" in vars(m)
                   for m in q.eligible_sites(tmodel).values())

    bf16 = load_flax_variables(build_detector(2, stem="bfm", **WIDE),
                               variables).to(torch.bfloat16)
    base = _heads(bf16, x, torch.bfloat16)
    with q.int8_ctx(bf16, scales, ptable):
        quant = _heads(bf16, x, torch.bfloat16)
    for lvl, (m, b) in enumerate(zip(quant, base)):
        assert 1e-4 < _rel(m, b) < 0.08, (lvl, _rel(m, b))


def test_act_dtype_rounds_each_site_input(pair, jax_quant):
    """int8_ctx with act_dtype bf16 on the f32 model (what the f32 eval
    step's sites run on the card, whose kernel reads bf16): every site's
    output is int8_conv2d_plain on its bf16-rounded input, cast back to
    f32, exactly; the head maps differ from those of the f32 sites but lie
    within relative L2 0.02 of them."""
    _, _, tmodel, _, x = pair
    scales, table, _ = jax_quant
    ctx = q.int8_ctx(tmodel, scales, _port_table(table),
                     act_dtype=torch.bfloat16)
    seen = []

    def check(site):
        def hook(_module, args, out):
            want = q.int8_conv2d_plain(args[0].to(torch.bfloat16), site.wq,
                                       site.scale, site.inv, site.bias,
                                       stride=site.stride).float()
            assert out.dtype == torch.float32 and torch.equal(out, want)
            seen.append(1)
        return hook
    handles = [conv.register_forward_hook(check(site))
               for conv, site in ctx.sites.values()]
    try:
        with ctx:
            maps = _heads(tmodel, x)
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == len(ctx.sites) == len(scales)
    with q.int8_ctx(tmodel, scales, _port_table(table)):
        f32_maps = _heads(tmodel, x)
    for lvl, (m, f) in enumerate(zip(maps, f32_maps)):
        assert 0 < _rel(m, f) < 0.02, (lvl, _rel(m, f))


def test_uncalibrated_input_clips_safely(pair, jax_quant):
    _, _, tmodel, _, x = pair
    scales, table, _ = jax_quant
    with q.int8_ctx(tmodel, scales, _port_table(table)):
        maps = _heads(tmodel, 100.0 * x)
    assert all(np.isfinite(m).all() for m in maps)


def test_sites_the_kernel_does_not_take_raise():
    """A site with Cin % 32 != 0 raises at int8_ctx entry, and the wrapper
    raises on it and on a device mix."""
    conv = torch.nn.Conv2d(80, 64, 3, 1, 1, bias=False)
    model = torch.nn.Sequential(conv)
    with pytest.raises(ValueError, match="Cin % 32"):
        q.int8_ctx(model, {"0": 0.01})
    wq, sw = q.quantize_kernel(conv.weight)
    x = torch.zeros(1, 80, 4, 4)
    with pytest.raises(ValueError, match="Cin % 32"):
        q.int8_conv2d(x, wq.permute(0, 2, 3, 1).contiguous(), sw, 1.0)
    x64 = torch.zeros(1, 64, 4, 4)
    wq64 = torch.zeros(64, 3, 3, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="on meta"):
        q.int8_conv2d(x64, wq64, sw.to("meta"), 1.0)
