"""The conv blocks' fused eval epilogue (models/epilogue.py: bn_act, its
twin bn_act_plain; blocks.conv_epilogue, which chooses it) on the CPU.

The kernel runs only on the card (tests/test_torch_port_cuda.py); here
the twin stands in for it. Its arithmetic is held to the unfused f32
steps rounded once, within one bf16 ulp. The choice is held by running
the fused path's twin through the same dispatch on the CPU
(`epilogue.KERNEL_DEVICE` set to "cpu"): a bf16 channels_last eval
forward fuses; training, NCHW, f32 and C % 8 != 0 keep the separate
passes bit for bit. An AED eval forward counts its 62 sites, torch.export
traces them as frlw_evd_torch::bn_act, and the benchmark's reader of the
counters gives their share. The identity activation ("linear") and the
gated residual (RED's SE gate on its shortcut) are cases of the same twin
and of `refusal` (RED's model-level tests: tests/test_torch_port_red.py).

Tolerance: one bf16 ulp of the larger of the two results, plus 2^-20 of
the magnitude of the terms summed (|x * scale| + |shift| + |gate *
residual|), which covers f32 steps taken in another order where the terms
cancel.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models import build_detector, epilogue
from frlw_evd_tpu_torch.models.blocks import (BaseConv, Bottleneck, DWConv,
                                              ResLayer, get_activation)
from frlw_evd_tpu_torch.models.epilogue import bn_act, bn_act_plain
from frlw_evd_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
TINY = dict(in_channels=(16, 16, 16), stem_out_channels=8, head_width=16)
SITES = 62     # conv epilogues in an AED forward (6 with a residual)


def _params(C, dtype, g):
    mean = torch.randn(C, generator=g)
    var = torch.rand(C, generator=g) * 2 + 0.05
    weight = torch.randn(C, generator=g)
    bias = torch.randn(C, generator=g)
    return [t.to(dtype) for t in (mean, var, weight, bias)]


def _unfused(x, mean, var, weight, bias, eps, act, residual,
             dtype=torch.float32, gate=None):
    """The unfused steps in `dtype`, as separate ops, not rounded."""
    shape = (1, -1, 1, 1)
    y = ((x.to(dtype) - mean.to(dtype).view(shape))
         * torch.rsqrt(var.to(dtype).view(shape) + eps)
         * weight.to(dtype).view(shape) + bias.to(dtype).view(shape))
    y = get_activation(act)(y)
    if gate is not None:
        return y + gate.to(dtype).reshape(*gate.shape[:2], 1, 1) * \
            residual.to(dtype)
    return y if residual is None else y + residual.to(dtype)


def assert_within_ulps(got, want, x, mean, var, weight, bias, eps,
                       residual=None, ulps=1, gate=None):
    """|got - want| within `ulps` bf16 ulps of the larger, plus 2^-20 of
    the terms' magnitude (see the module's docstring)."""
    a, b = got.double(), want.double()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(big > 0, torch.ldexp(torch.ones_like(big),
                                           torch.frexp(big).exponent - 8),
                      torch.zeros_like(big))
    shape = (1, -1, 1, 1)
    scale = (weight.double() * torch.rsqrt(var.double() + eps)).view(shape)
    shift = bias.double().view(shape) - mean.double().view(shape) * scale
    mag = (x.double() * scale).abs() + shift.abs()
    if residual is not None:
        r = residual.double()
        if gate is not None:
            r = r * gate.double().reshape(*gate.shape[:2], 1, 1)
        mag = mag + r.abs()
    err = (a - b).abs() - ulps * ulp - mag * 2.0 ** -20
    assert err.max().item() <= 0, (err.max().item(),
                                   (a - b).abs().max().item())


def _x(N, C, H, W, g, scale=3.0):
    x = torch.randn(N, C, H, W, generator=g) * scale
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _gate(N, C, g, shape=None):
    """A bf16 gate in (0, 1), as RED's SE sigmoid gives: (N, C, 1, 1), or
    `shape`."""
    gate = torch.sigmoid(torch.randn(N, C, generator=g) * 2)
    return gate.to(torch.bfloat16).reshape(shape or (N, C, 1, 1))


@pytest.mark.parametrize("C", [8, 64, 512])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("res", ["plain", "residual", "gated"])
@pytest.mark.parametrize("act", ["silu", "relu", "lrelu", "linear"])
def test_twin_within_one_ulp_of_unfused_f32(act, res, pdtype, C):
    """Each activation without a residual, with one, and with one gated
    per sample and channel (3 samples, the gate (N, C) at C = 64, else
    (N, C, 1, 1))."""
    g = torch.Generator().manual_seed(C + 7 * len(res))
    N = 3 if res == "gated" else 2
    x = _x(N, C, 5, 3, g)
    residual = _x(N, C, 5, 3, g) if res != "plain" else None
    gate = (_gate(N, C, g, (N, C) if C == 64 else None) if res == "gated"
            else None)
    params = _params(C, pdtype, g)
    got = bn_act_plain(x, *params, 1e-5, act, residual, gate)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = _unfused(x, *params, 1e-5, act, residual,
                    gate=gate).to(torch.bfloat16)
    assert_within_ulps(got, want, x, *params, 1e-5, residual, gate=gate)
    # the CPU wrapper is the twin, and so is the registered operator
    assert torch.equal(bn_act(x, *params, 1e-5, act, residual, gate), got)
    assert torch.equal(torch.ops.frlw_evd_torch.bn_act(
        x, *params, 1e-5, act, residual, gate), got)


def test_gated_twin_equals_the_separate_f32_passes():
    """The gated linear form is RED's block end, bn(down) + se * c3, as
    the separate passes compute it in f32 (conv_epilogue's plain path),
    rounded once: bit for bit."""
    g = torch.Generator().manual_seed(11)
    x, r = _x(3, 16, 4, 6, g), _x(3, 16, 4, 6, g)
    gate = _gate(3, 16, g)
    params = _params(16, torch.float32, g)
    bn = torch.nn.BatchNorm2d(16).eval()
    with torch.no_grad():
        for t, v in zip((bn.running_mean, bn.running_var, bn.weight,
                         bn.bias), params):
            t.copy_(v)
        sep = bn(x.float()) + gate.float() * r.float()
    got = bn_act_plain(x, *params, 1e-5, "linear", r, gate)
    assert torch.equal(got, sep.to(torch.bfloat16))


def test_one_rounding_is_closer_than_three():
    """The fused result lies at least as close to the f64 result as the
    three bf16-rounded passes do, and closer on the whole."""
    g = torch.Generator().manual_seed(3)
    x, r = _x(4, 64, 9, 9, g), _x(4, 64, 9, 9, g)
    params = _params(64, torch.bfloat16, g)
    exact = _unfused(x, *params, 1e-5, "silu", r, dtype=torch.float64)
    mean, var, weight, bias = params
    y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, 1e-5)
    three = F.silu(y) + r
    fused = bn_act_plain(x, *params, 1e-5, "silu", r)
    e_fused = (fused.double() - exact).norm()
    e_three = (three.double() - exact).norm()
    assert e_fused < e_three


def _block(kind, C, dtype, g):
    with torch.random.fork_rng():
        torch.manual_seed(int(torch.randint(1 << 30, (1,), generator=g)))
        block = {"base": lambda: BaseConv(C, C, 3),
                 "res": lambda: ResLayer(C),
                 "bottleneck": lambda: Bottleneck(C, C),
                 "dw": lambda: Bottleneck(C, C, depthwise=True)}[kind]()
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
            m.weight.data.normal_(1, 0.3)
            m.bias.data.normal_(0, 0.3)
    return block.to(dtype).eval()


def _old_path(block, x):
    """The separate passes, as the blocks ran them before the epilogue:
    each BaseConv's BatchNorm, dropout and activation, then the add."""
    def base(b, h):
        y = b.bn(b.conv(h))
        if b.drop is not None:
            y = b.drop(y)
        return get_activation(b.act_name)(y)

    if isinstance(block, BaseConv):
        return base(block, x)
    if isinstance(block, ResLayer):
        return x + base(block.layer2, base(block.layer1, x))
    c2 = block.conv2
    h = base(block.conv1, x)
    y = (base(c2.pconv, base(c2.dconv, h)) if isinstance(c2, DWConv)
         else base(c2, h))
    return y + x if block.add else y


def _counted(fn):
    profiling.clear_spans()
    with profiling.recording(), profiling.span("f"):
        out = fn()
    counts = profiling.spans_summary()["counts"]
    profiling.clear_spans()
    return out, counts


@pytest.fixture
def on_cpu(monkeypatch):
    """The fused path's dispatch on CPU tensors (the twin in the kernel's
    place)."""
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "cpu")


@pytest.mark.parametrize("kind,sites", [("base", 1), ("res", 2),
                                        ("bottleneck", 2), ("dw", 3)])
def test_bf16_channels_last_eval_fuses_with_the_residual(on_cpu, kind,
                                                         sites):
    g = torch.Generator().manual_seed(sites)
    block = _block(kind, 16, torch.bfloat16, g)
    pipeline.channels_last_(block)
    x = _x(2, 16, 6, 10, g)
    with torch.no_grad():
        got, counts = _counted(lambda: block(x))
        old = _old_path(block, x)
    assert counts == {"epilogue_fused": sites}
    assert got.is_contiguous(memory_format=torch.channels_last)
    # one rounding where the old path had two or three: close, not equal
    rel = ((got.float() - old.float()).norm() / old.float().norm()).item()
    assert 0 < rel < 1e-2, rel


@pytest.mark.parametrize("case", ["train", "nchw", "f32", "c12", "grad",
                                  "dropout"])
def test_other_forwards_keep_the_old_path_bit_for_bit(on_cpu, case):
    g = torch.Generator().manual_seed(5)
    C = 12 if case == "c12" else 16
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    block = _block("res", C, dtype, g)
    if case == "dropout":
        block = BaseConv(C, C, 1, dropout=0.25).to(dtype).eval()
        block.drop.train()
        block.drop.generator = torch.Generator().manual_seed(1)
    if case != "nchw":
        pipeline.channels_last_(block)
    x = _x(2, C, 6, 10, g).to(dtype)
    if case == "nchw":
        x = x.contiguous()
    if case == "train":
        block.train()
    with torch.set_grad_enabled(case in ("train", "grad")):
        if case == "dropout":
            block.drop.generator.manual_seed(1)
        got, counts = _counted(lambda: block(x))
        if case == "dropout":
            block.drop.generator.manual_seed(1)
        want = _old_path(block, x)
    assert torch.equal(got, want)
    sites = 1 if case == "dropout" else 2
    assert counts == ({} if case == "train" else {"epilogue_plain": sites})
    if case in ("train", "grad"):
        got.float().sum().backward()
        assert block.layer1.conv.weight.grad is not None


def test_cpu_tensors_take_the_old_path_without_the_seam():
    g = torch.Generator().manual_seed(2)
    block = _block("res", 16, torch.bfloat16, g)
    pipeline.channels_last_(block)
    x = _x(2, 16, 6, 10, g)
    with torch.no_grad():
        got, counts = _counted(lambda: block(x))
        assert torch.equal(got, _old_path(block, x))
    assert counts == {"epilogue_plain": 2}


def _aed(stem, dtype, channels_last=True):
    torch.manual_seed(0)
    model = build_detector(2 if stem == "bfm" else 7, stem=stem, **TINY)
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    model.to(dtype).eval()
    if channels_last:
        pipeline.channels_last_(model)
    return model


def _volume(stem, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (2, 32, 64, 16) if stem == "bfm" else (2, 16, 32 * 64)
    return torch.rand(shape, generator=g).to(dtype)


@pytest.mark.parametrize("stem", ["bfm", "bfm_folded"])
def test_aed_eval_forward_counts_its_62_sites(on_cpu, stem, monkeypatch):
    model = _aed(stem, torch.bfloat16)
    vol = _volume(stem, torch.bfloat16)
    with torch.inference_mode():
        fused, counts = _counted(lambda: model(vol))
    assert counts == {"epilogue_fused": SITES}
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "cuda")
    with torch.inference_mode():
        plain, counts = _counted(lambda: model(vol))
    assert counts == {"epilogue_plain": SITES}
    for f, p in zip(fused, plain):
        rel = ((f.float() - p.float()).norm() / p.float().norm()).item()
        assert rel < 1e-2, rel


def test_export_traces_the_sites_as_the_operator(on_cpu, tmp_path):
    """torch.export of a bf16 channels_last AED (the fused path's dispatch
    on the CPU): every site is one frlw_evd_torch::bn_act call, nothing is
    counted while tracing, and the saved and loaded program gives the
    live model's maps."""
    model = _aed("bfm", torch.bfloat16)
    vol = _volume("bfm", torch.bfloat16)
    profiling.clear_spans()
    with torch.no_grad(), profiling.recording(), profiling.span("export"):
        program = torch.export.export(model, (vol,))
    assert profiling.spans_summary()["counts"] == {}
    calls = [n for n in program.graph.nodes if n.op == "call_function"
             and "bn_act" in str(n.target)]
    assert len(calls) == SITES
    path = tmp_path / "aed.pt2"
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    with torch.no_grad():
        live = model(vol)
        got = loaded(vol)
    for a, b in zip(got, live):
        assert torch.equal(a, b)


def _refusal_operands(case):
    """A gated site's operands on the CPU (x 3 x 16 x 4 x 6 bf16
    channels_last), with the gate or residual made wrong as `case` says."""
    g = torch.Generator().manual_seed(4)
    x, r = _x(3, 16, 4, 6, g), _x(3, 16, 4, 6, g)
    gate = _gate(3, 16, g)
    gate = {"sound": gate, "flat": gate.reshape(3, 16),
            "shape": _gate(2, 16, g), "channels": _gate(3, 8, g),
            "dtype": gate.float(), "device": gate.to("meta"),
            "strided": _gate(3, 32, g)[:, ::2],
            "no_residual": gate}.get(case)
    return x, _params(16, torch.float32, g), (
        None if case == "no_residual" else r), gate


@pytest.mark.parametrize("case", ["sound", "flat", "shape", "channels",
                                  "dtype", "device", "strided",
                                  "no_residual"])
def test_refusal_checks_the_gate(case):
    """`refusal` takes a bf16 (N, C) or (N, C, 1, 1) contiguous gate on x's
    device beside a residual, and names what is wrong with any other."""
    x, params, r, gate = _refusal_operands(case)
    why = epilogue.refusal(x, *params, "linear", r, gate)
    if case in ("sound", "flat"):
        assert why is None
    else:
        assert why is not None and "gate" in why


def test_refusal_takes_the_identity_activation():
    x, params, r, gate = _refusal_operands("sound")
    assert epilogue.refusal(x, *params, "linear") is None
    assert "act must be" in epilogue.refusal(x, *params, "identity")


def test_kernel_wrapper_refuses_what_it_does_not_take():
    g = torch.Generator().manual_seed(0)
    params = _params(8, torch.float32, g)
    with pytest.raises(ValueError, match="unsupported device"):
        bn_act(torch.zeros(1, 8, 2, 2, device="meta"),
               *[p.to("meta") for p in params], 1e-5, "silu")


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    sys.path.insert(0, str(REPO))
    from evd_bench import harness
    from evd_bench.tests.conftest import write_tiny
    root = tmp_path_factory.mktemp("tiny")
    return harness, harness.Bench(write_tiny(root, dtype="bfloat16"),
                                  roots=(root, harness.HERE))


@pytest.mark.parametrize("seam", ["cpu", "cuda"])
def test_the_share_reader_over_a_tiny_traced_cell(tiny_bench, monkeypatch,
                                                  seam):
    """epilogue_fused_share over the tiny bf16 GEN1 cell: 100 with the
    fused path's dispatch on the CPU, 0 without (every site plain)."""
    harness, bench = tiny_bench
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", seam)
    result, _ = harness.run(bench, "tiny_gen1_cell", 2 ** 31 + 19, 0.2, True,
                            torch.device("cpu"), time.perf_counter())
    share = result["metrics"]["epilogue_fused_share"]
    assert share["unit"] == "%"
    assert share["value"] == (100.0 if seam == "cpu" else 0.0)
