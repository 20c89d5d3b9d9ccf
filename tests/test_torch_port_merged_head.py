"""The port's merged head towers (heads.YOLOXHead with `merged`,
build_detector's head_merged) and their int8 hook (quantize.merged_heads,
MergedSites) against the JAX package's merged head and against the
port's canonical head, on the CPU.

Gates: the merged head's maps within 2e-4 of flax's merged head in eval
and training mode (f32), its running statistics after a training forward
within 1e-5 of flax's (each branch updated from its own slice); merged
against canonical in the port: the same state_dict keys, the same maps
within 1e-5 (the BatchNorm arithmetic's order differs) and the same
statistics and losses after a train step; int8 on the CPU twin as JAX's
tests/test_quantize.py::test_merged_head_int8_composes: the merged
calibration has the canonical keys and equal ranges (rtol 1e-5, and
JAX's merged ranges rtol 1e-6), the merged int8 maps within relative L2
0.08 of the merged f32 maps and within 0.02 of JAX's merged int8 maps,
and equal to the canonical int8 maps to f32 rounding (1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models import quantize as jq
from frlw_evd_tpu.models.heads import YOLOXHead as JYOLOXHead
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models import quantize as q
from frlw_evd_tpu_torch.models.heads import YOLOXHead
from frlw_evd_tpu_torch.train import TrainState, make_train_step, sgd
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from test_torch_port_memory import _two_torch_threads  # noqa: F401
from test_torch_port_memory import random_labels
from test_torch_port_quantize import _heads, _port_table, _rel
from test_torch_port_swin3d import fast_jit, seeded_variables

TOL, BN_TOL = 2e-4, 1e-5
WIDE = dict(in_channels=(64, 64, 64), stem_out_channels=64, head_width=64)
H, W = 64, 96


def _features(rng, n=2, widths=(16, 16, 16), hw=((8, 12), (4, 6), (2, 3))):
    return [rng.normal(0, 1, (n, *s, c)).astype(np.float32)
            for s, c in zip(hw, widths)]


def test_merged_head_matches_flax():
    """YOLOXHead(merged) on flax's merged head's variables (the canonical
    tree): the maps at eval, then in training mode with the running
    statistics after it."""
    feats = _features(np.random.default_rng(0))
    jm = JYOLOXHead(num_classes=3, width=16, merged_branches=True)
    variables = seeded_variables(jm, np.random.default_rng(1), feats, False)
    tm = load_flax_variables(YOLOXHead(3, (16, 16, 16), width=16,
                                       merged=True), variables)
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    want = fast_jit(lambda v, f: jm.apply(v, f, False))(variables, feats)
    with torch.no_grad():
        got = tm.eval()(tfeats)
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"eval {lvl}")
    want, upd = fast_jit(lambda v, f: jm.apply(
        v, f, True, mutable=["batch_stats"]))(variables, feats)
    with torch.no_grad():
        got = tm.train()(tfeats)
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"train {lvl}")
    sd = tm.state_dict()
    stats = flax_to_state_dict(upd)
    assert any("reg_convs_2_1" in k for k in stats)
    for key, v in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), v.numpy(), atol=BN_TOL,
                                   rtol=0, err_msg=key)


def _pair_models(**kw):
    """(merged, canonical) port detectors on one seeded state_dict."""
    merged = build_detector(2, head_merged=True, stem="bfm",
                            dropout_rate=0.0, **kw)
    canon = build_detector(2, head_merged=False, stem="bfm",
                           dropout_rate=0.0, **kw)
    sd = merged.state_dict()
    rng = np.random.default_rng(2)
    for k, v in sd.items():
        if k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)))
        elif k.endswith(("running_mean", "bn.bias")):
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape)))
        elif k.endswith("bn.weight"):
            v.copy_(torch.from_numpy(rng.uniform(0.8, 1.5, v.shape)))
    assert sd.keys() == canon.state_dict().keys()
    canon.load_state_dict(sd)
    return merged, canon


def test_merged_matches_canonical_in_the_port():
    """One checkpoint serves both heads: the same keys, the same maps at
    eval, and one SGD train step from the same state gives the same
    losses and the same running statistics of every tower branch."""
    narrow = dict(in_channels=(32, 32, 32), stem_out_channels=16,
                  head_width=32)
    merged, canon = _pair_models(**narrow)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (2, H, W, 16)).astype(np.float32))
    with torch.no_grad():
        for lvl, (a, b) in enumerate(zip(merged.eval()(x), canon.eval()(x))):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5,
                                       msg=f"level {lvl}")
    labels = torch.from_numpy(random_labels(rng, 2, (H, W)))
    step = make_train_step((8, 16, 32), 2, 2.5, device="cpu")
    losses = []
    for model in (merged, canon):
        state = TrainState(0, model.train(),
                           sgd(1e-2).make(model.named_parameters()))
        losses.append(step(state, x, labels, torch.Generator()))
    for k in losses[0]:
        torch.testing.assert_close(losses[0][k], losses[1][k], rtol=1e-5,
                                   atol=0, msg=k)
    want = canon.state_dict()
    for k, v in merged.state_dict().items():
        if "convs_" in k and k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, want[k], rtol=0, atol=1e-5,
                                       msg=k)


@pytest.fixture(scope="module")
def int8_pair():
    """JAX's merged detector (focus stem, 64 wide, as
    test_merged_head_int8_composes), its seeded variables, the port's
    merged and canonical detectors on them, calibration batches, an
    input."""
    kw = dict(family="aed", stem="focus", **WIDE)
    jm = jax_build(2, head_merged=True, **kw)
    rng = np.random.default_rng(4)
    x0 = np.zeros((1, H, W, 16), np.float32)
    variables = seeded_variables(jm, rng, x0, False)
    merged, canon = (load_flax_variables(build_detector(
        2, head_merged=m, **kw), variables) for m in (True, False))
    calib = [rng.uniform(0, 1, (2, H, W, 16)).astype(np.float32)
             for _ in range(2)]
    x = rng.uniform(0, 1, (2, H, W, 16)).astype(np.float32)
    return jm, variables, merged, canon, calib, x


def test_merged_int8_composes(int8_pair):
    jm, variables, merged, canon, calib, x = int8_pair
    batches = [torch.from_numpy(c) for c in calib]
    scales_m = q.calibrate_int8(merged, batches)
    scales_c = q.calibrate_int8(canon, batches)
    tower = [k for k in scales_c if "cls_convs" in k or "reg_convs" in k]
    assert len(tower) == 12
    assert set(scales_m) == set(scales_c)
    for k in scales_c:
        np.testing.assert_allclose(scales_m[k], scales_c[k], rtol=1e-5,
                                   err_msg=k)
    j_scales = jq.calibrate_int8(jm, variables, [jnp.asarray(c)
                                                 for c in calib])
    assert set(j_scales) == set(scales_m)
    for k, sx in j_scales.items():
        np.testing.assert_allclose(scales_m[k], sx, rtol=1e-6, err_msg=k)

    table = jq.build_weight_table(variables["params"], j_scales)

    @fast_jit
    def j_quant(v, xx):
        with jq.int8_ctx(j_scales, table):
            return jm.apply(v, xx, False)

    j_maps = [np.asarray(o, np.float64)
              for o in j_quant(variables, jnp.asarray(x))]
    ptable = _port_table(table)
    base_m = _heads(merged, x)
    ctx = q.int8_ctx(merged, j_scales, ptable)
    assert not set(ctx.sites) & set(tower)
    (head, sites), = ctx.merged.values()
    assert head is merged.head and len(sites.sites) == 6
    assert [len(s) for s in sites.sites.values()] == [1, 2] * 3
    launches = q.int8_conv2d.launches
    with ctx:
        quant_m = _heads(merged, x)
    assert q.int8_conv2d.launches == launches      # the CPU twin: none
    assert merged.head.merged_hook is None
    with q.int8_ctx(canon, j_scales, ptable):
        quant_c = _heads(canon, x)
    for lvl, (b, qm, qc, j) in enumerate(zip(base_m, quant_m, quant_c,
                                             j_maps)):
        assert 1e-4 < _rel(qm, b) < 0.08, (lvl, _rel(qm, b))
        assert _rel(qm, j) < 0.02, (lvl, _rel(qm, j))
        np.testing.assert_allclose(qm, qc, rtol=0, atol=1e-5,
                                   err_msg=f"level {lvl}")


def test_merged_layer0_dequantizes_with_branch0s_scale(int8_pair):
    """A hand-edited scales dict whose reg branch disagrees at layer 0:
    the shared input is quantized once with the cls branch's sx, and both
    branches are dequantized with it (quantize.py:100-106), so the maps do
    not move; at layer 1 each half takes its own sx, so they do."""
    _, variables, merged, _, calib, x = int8_pair
    scales = q.calibrate_int8(merged, [torch.from_numpy(c) for c in calib])
    with q.int8_ctx(merged, scales):
        base = _heads(merged, x)
    for layer, moves in ((0, False), (1, True)):
        edited = dict(scales)
        key = f"head/reg_convs_0_{layer}/conv"
        edited[key] = scales[key] * 3.0
        with q.int8_ctx(merged, edited):
            maps = _heads(merged, x)
        assert (not np.array_equal(maps[0], base[0])) == moves, layer
