"""The port's 1 Mpx (p64) slice against the JAX package on the CPU.

Kernel B1 in the p64 cell order and kernel B3 (through
`taf_stream_step_kernel_p64`) against JAX `taf_stream_step_kernel_p64`;
kernels B4 and B7 (`bfm_chain_apply_folded`, `bfm_chain_apply`) against
their Pallas counterparts; the p64 stems against the JAX modules of the
same names and against the canonical stems on the raw grid; one JAX
variable tree loaded into every BFM variant; and the gen4 serving slice
(`make_pipeline_p64`, stem `bfm_folded`) end to end. The Pallas kernels run
in interpret mode on the CPU backend that conftest.py forces; the port runs
its kernels' plain twins.

Tolerances, and why:
  * counts exact; t-sums within cnt * 2.5e-3 (the JAX path's 12-bit, bf16
    t; see tests/test_torch_port_encode.py);
  * step: state atol 1e-2, volume 2e-2, the gates of the GEN1 step;
  * chain: the output is bf16 and every bf16-rounded intermediate (y0, y1,
    y2, act(u)) may round the other way by one ulp where the two sides sum
    in another order, so atol 1e-2 and rtol 1e-2 (about two bf16 ulps at
    the output's magnitude); B4's 16 pad channels are exactly zero;
  * stems: atol 3e-2 / rtol 1e-2 for the bf16-chain forms (the JAX
    package's own gate, tests/test_pallas_scatter.py:293), 1e-5 for the
    plain forms (the same f32 math in another order);
  * slice: event times snapped to multiples of 1/256 in [0, 0.5), where the
    JAX path's quantised t is exact, so states and volumes agree bit for
    bit (and so do the B4 chain outputs on them). The folded stem's 3x3
    conv runs in bf16 on both sides (stems.py:346-348) and the two
    frameworks' bf16 convs round about 3 in 10^4 outputs the other way by
    one ulp; the f32 network carries those flips to the head at a relative
    size of about 5e-4, so head outputs atol 1e-2 (measured at most 4.7e-3
    here); keep masks equal; kept dets: each JAX det has a distinct port det
    of the same stream (two near-tied candidates may trade ranks) within
    what a head difference d <= 1e-2 allows after the decode: centre
    stride * d (at most 0.32 px), size a factor e^d (rtol 1e-2), score and
    class probabilities 2 * d / 4 (5e-3); the class equal, or one whose JAX
    probability at that anchor is within 1e-2 of the JAX class's (the
    random weights leave near-tied class logits, whose argmax such a
    difference may flip).
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.encode.pallas_scatter import scatter_cnt_tsum_pallas_sorted
from frlw_evd_tpu.encode.pallas_update import p64_init_state as jax_p64_init
from frlw_evd_tpu.encode.pallas_update import \
    taf_stream_step_kernel_p64 as jax_step_p64
from frlw_evd_tpu.models import blocks as jax_blocks
from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models import stems as jax_stems
from frlw_evd_tpu.models.detector import eval_decode as jax_eval_decode
from frlw_evd_tpu.models.pallas_stem import bfm_chain_apply as jax_chain
from frlw_evd_tpu.models.pallas_stem import \
    bfm_chain_apply_folded as jax_chain_folded
from frlw_evd_tpu.models.postprocess import \
    postprocess_batch as jax_postprocess
from frlw_evd_tpu.train.checkpoints import import_torch_checkpoint
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.encode import (p64_init_state, scatter_cnt_tsum,
                                       taf_stream_step_kernel_p64)
from frlw_evd_tpu_torch.models import blocks, build_detector, stems
from frlw_evd_tpu_torch.models.stem_chain import (bfm_chain_apply,
                                                  bfm_chain_apply_folded)
from frlw_evd_tpu_torch.weights import (flax_path, flax_to_state_dict,
                                        load_flax_variables)
from test_torch_port_detector import randomize_variables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

K = 8
T_TOL = 2.5e-3
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)


def _events(rng, B, E, H, W):
    ev = np.zeros((B, E, 4), np.float32)
    ev[..., 0] = rng.integers(0, W, (B, E))
    ev[..., 1] = rng.integers(0, H, (B, E))
    ev[..., 2] = np.sort(rng.uniform(0, 1, (B, E)), axis=1)
    ev[..., 3] = rng.integers(0, 2, (B, E))
    return ev


def test_p64_scatter_counts_match_jax(rng):
    """B1's p64 cell order (the twin) against the sorted Pallas scatter fed
    the JAX p64 step's own indices (pallas_update.py:331-341), with
    out-of-range events and a partial n_valid."""
    B, H, W, E = 2, 32, 64, 800
    ev = _events(rng, B, E, H, W)
    ev[0, :40, 0] = W + 1.0
    ev[1, :40, 3] = 2.0
    n_valid = np.array([E, 530], np.int32)
    cnt, tsum, any_ev = scatter_cnt_tsum(torch.from_numpy(ev),
                                         torch.from_numpy(n_valid),
                                         height=H, width=W, layout="p64")

    j = jnp.asarray(ev)
    x, y = j[..., 0].astype(jnp.int32), j[..., 1].astype(jnp.int32)
    p = j[..., 3].astype(jnp.int32)
    valid = ((jnp.arange(E)[None, :] < jnp.asarray(n_valid)[:, None])
             & (x >= 0) & (x < W) & (y >= 0) & (y < H) & (p >= 0) & (p < 2))
    cell = ((y >> 1) * (W // 2) + (x >> 1)) * 4 + (x & 1) * 2 + (y & 1)
    idx = jnp.where(valid, cell * 2 + p, H * W * 2)
    j_cnt, j_tsum = scatter_cnt_tsum_pallas_sorted(
        idx, (j[..., 2] - 1.0) * valid, valid, H * W * 2, False)
    j_cnt, j_tsum = np.asarray(j_cnt), np.asarray(j_tsum)
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)
    np.testing.assert_array_less(np.abs(tsum.numpy() - j_tsum),
                                 j_cnt * T_TOL + 1e-6)
    np.testing.assert_array_equal(any_ev.numpy(), [1, 1])
    assert j_cnt.sum() == int(np.asarray(valid).sum())


@pytest.mark.parametrize("fold_output", [True, False])
def test_p64_step_matches_jax_over_windows(rng, fold_output):
    """taf_stream_step_kernel_p64 at the geometry of
    test_pallas_scatter.py::test_p64_state_matches_packed (B = 2, 32x64,
    E = 800) over three windows carrying state; stream 1 has a partial
    n_valid, then no events at all (the freeze)."""
    B, H, W, E = 2, 32, 64, 800
    st = p64_init_state(B, H, W, device="cpu")
    j_st = jax_p64_init(B, H, W)
    for i, n1 in enumerate((E, 300, 0)):
        ev = _events(rng, B, E, H, W)
        nv = np.array([E, n1], np.int32)
        prev = st.clone()
        st, vol = taf_stream_step_kernel_p64(
            st, torch.from_numpy(ev), torch.from_numpy(nv), height=H,
            width=W, fold_output=fold_output)
        j_st, j_vol = jax_step_p64(j_st, jnp.asarray(ev), jnp.asarray(nv),
                                   height=H, width=W,
                                   fold_output=fold_output)
        want = ((B, H // 2, (W // 2) * 64) if fold_output
                else (B, H // 2, W // 2, 64))
        assert vol.shape == want == j_vol.shape
        assert vol.dtype == torch.bfloat16
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=1e-2,
                                   err_msg=f"state, window {i}")
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        if n1 == 0:
            torch.testing.assert_close(st[1], prev[1], rtol=0, atol=0)


def test_p64_step_global_any_events_flag(rng):
    """any_events replaces the per-stream flag (pallas_update.py:353-356):
    a shard whose stream 1 got no local events still ages when the global
    flag says the frame had events, and a flag of 0 freezes stream 0."""
    B, H, W, E = 2, 32, 64, 800
    ev = _events(rng, B, E, H, W)
    nv = np.array([E, 0], np.int32)
    flags = np.array([0, 1], np.int32)
    st = p64_init_state(B, H, W, device="cpu")
    st.uniform_(-40.0, 0.0, generator=torch.Generator().manual_seed(0))
    prev = st.clone()
    j_st, j_vol = jax_step_p64(jnp.asarray(st.numpy()), jnp.asarray(ev),
                               jnp.asarray(nv), jnp.asarray(flags),
                               height=H, width=W)
    st, vol = taf_stream_step_kernel_p64(st, torch.from_numpy(ev),
                                         torch.from_numpy(nv),
                                         torch.from_numpy(flags), height=H,
                                         width=W)
    torch.testing.assert_close(st[0], prev[0], rtol=0, atol=0)
    torch.testing.assert_close(st[1], prev[1] - 1.0, rtol=0, atol=0)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    np.testing.assert_allclose(vol.float().numpy(),
                               np.asarray(j_vol, np.float32), atol=2.0 ** -8)


@pytest.mark.parametrize("height,width,K_", [(32, 40, 8), (32, 64, 4),
                                             (31, 64, 8)],
                         ids=["w2_not_16", "k4", "odd_height"])
def test_p64_step_refuses_what_the_kernel_refuses(height, width, K_):
    """(W/2) % 16 != 0, K != 8 and an odd sensor raise on CPU tensors too,
    so the twin accepts no geometry that the kernel path refuses."""
    st = torch.full((1, height // 2, (width // 2) * 8 * K_), -6000.0)
    ev = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="p64"):
        taf_stream_step_kernel_p64(st, ev, torch.ones(1, dtype=torch.int32),
                                   height=height, width=width)


def _chain_tree(rng):
    """Random f32 params of the K = 8 BFM chain in the JAX layout, with
    biases that keep the ReLUs half open."""
    def wn(i, o):
        return {"v": rng.normal(0, 1, (1, 1, i, o)),
                "g": rng.uniform(0.5, 1.5, o), "bias": rng.normal(0.1, 0.2, o)}

    tree = {"convs_0": wn(4, 16), "convs_1": wn(8, 8), "convs_2": wn(8, 4),
            "trans_up": {"kernel": rng.normal(0, 0.3, (1, 1, 12, 48)),
                         "bias": rng.normal(0, 0.3, 48)},
            "trans_down": {"kernel": rng.normal(0, 0.15, (1, 1, 48, 12)),
                           "bias": rng.normal(0, 0.1, 12)}}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("folded", [True, False], ids=["B4", "B7"])
def test_chain_matches_jax(rng, folded):
    tree = _chain_tree(rng)
    params = flax_to_state_dict({"params": tree})
    x = rng.uniform(0, 1, (2, 8, 12, 64)).astype(np.float32)
    if folded:
        xf = x.reshape(2, 8, 12 * 64)
        out = bfm_chain_apply_folded(torch.from_numpy(xf).to(torch.bfloat16),
                                     params, width=12)
        want = jax_chain_folded(jnp.asarray(xf, jnp.bfloat16), tree,
                                width=12)
        assert out.shape == (2, 8, 12 * 64)
        pad = out.view(2, 8, 12, 64)[..., 48:]
        assert torch.equal(pad, torch.zeros_like(pad))
    else:
        out = bfm_chain_apply(torch.from_numpy(x).to(torch.bfloat16), params)
        want = jax_chain(jnp.asarray(x, jnp.bfloat16), tree)
        assert out.shape == (2, 8, 12, 48)
    assert out.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert (want > 0.05).mean() > 0.2          # the chain is not all zero
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


@pytest.fixture(scope="module")
def stem_variables():
    """One JAX BinsFusionModule / Focus variable tree each, randomised,
    and the input (2, 16, 24, 16) with its patchified forms."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 16, 24, 16)).astype(np.float32)
    xp = np.asarray(jax_blocks.space_to_depth_patches(jnp.asarray(x)))
    out = {"x": x, "xp": xp, "xf": xp.reshape(2, 8, 12 * 64)}
    for name, mod in (("bfm", jax_stems.BinsFusionModule(out_channels=24)),
                      ("focus", jax_blocks.Focus(out_channels=24))):
        v = jax.jit(mod.init, static_argnums=(2,))(jax.random.key(0), x,
                                                   False)
        out[name] = randomize_variables(v, rng)
    return out


# (port stem, JAX stem, canonical, input, tolerance)
STEMS = {
    "bfm_folded": (stems.BinsFusionModuleFolded,
                   jax_stems.BinsFusionModuleFolded, "bfm", "xf",
                   dict(atol=3e-2, rtol=1e-2)),
    "bfm_p64_kernel": (stems.BinsFusionModulePatchedKernel,
                       jax_stems.BinsFusionModulePatchedKernel, "bfm", "xp",
                       dict(atol=3e-2, rtol=1e-2)),
    "bfm_p64": (stems.BinsFusionModulePatched,
                jax_stems.BinsFusionModulePatched, "bfm", "xp",
                dict(atol=1e-5, rtol=1e-5)),
    "focus_p64": (stems.FocusPatched, jax_stems.FocusPatched, "focus", "xp",
                  dict(atol=1e-5, rtol=1e-5)),
}


@pytest.mark.parametrize("name", list(STEMS))
def test_p64_stem_matches_jax_and_canonical(stem_variables, name):
    port_cls, jax_cls, canon, inp, tol = STEMS[name]
    variables = stem_variables[canon]
    x = stem_variables[inp]
    want = np.asarray(jax_cls(out_channels=24).apply(variables,
                                                     jnp.asarray(x), False))
    sd = flax_to_state_dict(variables)
    stem = port_cls(16, 24)
    canon_stem = (stems.BinsFusionModule if canon == "bfm"
                  else blocks.Focus)(16, 24)
    for mod in (stem, canon_stem):
        mod.load_state_dict(sd, strict=False)
        assert set(mod.state_dict()) - {k for k in mod.state_dict()
                                        if k.endswith("num_batches_tracked")
                                        } == set(sd)
        mod.eval()
    with torch.no_grad():
        got = stem(torch.from_numpy(x)).permute(0, 2, 3, 1).float().numpy()
        ref = canon_stem(torch.from_numpy(stem_variables["x"])).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 12, 24)
    np.testing.assert_allclose(got, want, err_msg=f"{name} vs JAX", **tol)
    np.testing.assert_allclose(got, ref, err_msg=f"{name} vs canonical",
                               **tol)


@pytest.fixture(scope="module")
def folded_detector_variables():
    """The variables of JAX build_detector(7, stem='bfm_folded'), narrow,
    randomised."""
    jmodel = jax_build(7, family="aed", stem="bfm_folded", **NARROW)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, 32, 48 * 64), jnp.float32), False)
    return randomize_variables(variables, np.random.default_rng(2))


@pytest.mark.parametrize("stem", ["bfm", "bfm_p64", "bfm_p64_kernel",
                                  "bfm_folded"])
def test_one_tree_loads_into_every_bfm_variant(folded_detector_variables,
                                               stem, tmp_path):
    """The bfm_folded tree loads into each port BFM detector with no missing
    or unexpected key, and round-trips through the JAX package's importer
    (checkpoints.py:156) with identical arrays."""
    variables = folded_detector_variables
    tmodel = load_flax_variables(build_detector(7, stem=stem, **NARROW),
                                 variables)
    path = tmp_path / f"{stem}.pth"
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


SENSOR = (64, 96)                 # (W/2) % 16 == 0, as the p64 update needs
B, E = 2, 1024
OBJ_BIAS = 2.0


def _serving_variables():
    """JAX bfm_folded init with the BatchNorm affines spread and the obj
    biases raised (as tests/test_torch_port_pipeline.py does)."""
    jmodel = jax_build(7, family="aed", stem="bfm_folded", **NARROW)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0),
        jnp.zeros((1, SENSOR[0] // 2, SENSOR[1] // 2 * 64), jnp.float32),
        False)
    rng = np.random.default_rng(0)
    flat = {}
    for path, a in flatten_dict(variables["params"]).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 2.0, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.5, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = OBJ_BIAS
        flat[path] = a
    stats = jax.tree.map(lambda a: np.array(a, np.float32),
                         variables["batch_stats"])
    return jmodel, {"params": unflatten_dict(flat), "batch_stats": stats}


def _windows():
    ev_u, nv_u = pipeline.synth_events(np.random.default_rng(0), 2, B, E,
                                       SENSOR)
    ev_s, nv_s = pipeline.synth_events_skewed(np.random.default_rng(1), 1, B,
                                              E, SENSOR)
    out = [(ev_u[0], nv_u[0]), (ev_s[0], nv_s[0]), (ev_u[1], nv_u[1])]
    for ev, _ in out:
        ev[..., 2] = np.floor(ev[..., 2] * 128.0) / 256.0
    return out


def _assert_same_dets(got, want, decoded):
    """Every det of `want` (n, 6: cx, cy, w, h, class, score) matches a
    distinct det of `got` within the decode's image of the head gate
    (module docstring); `decoded` (A, 5 + C) holds the JAX decoded anchors,
    whose class probabilities say which classes tie at the det's anchor."""
    assert len(got) == len(want)
    free = list(range(len(got)))
    for w in want:
        anchor = decoded[np.abs(decoded[:, :4] - w[:4]).max(1).argmin()]
        probs = anchor[5:]
        tied = np.abs(probs - probs[int(w[4])]) <= 1e-2
        hits = [j for j in free if tied[int(got[j, 4])]
                and abs(got[j, 5] - w[5]) <= 5e-3
                and np.allclose(got[j, :4], w[:4], rtol=1e-2, atol=0.32)]
        assert hits, f"no port det matches {w}"
        free.remove(hits[0])


def test_gen4_slice_matches_jax_pipeline():
    """bench.make_pipeline_p64(folded=True) → apply → eval_decode →
    postprocess_batch(100) against the port's make_pipeline_p64 on the CPU,
    narrow AED with 7 classes, three windows carrying state."""
    jmodel, variables = _serving_variables()
    j_enc = bench.make_pipeline_p64(jmodel, variables, SENSOR,
                                    folded=True).stages["encode_transform"]
    j_apply = jax.jit(lambda v, x: jmodel.apply(v, x, False))

    tmodel = load_flax_variables(
        build_detector(7, stem="bfm_folded", **NARROW), variables)
    run = pipeline.make_pipeline_p64(tmodel, SENSOR, folded=True,
                                     device="cpu", dtype=torch.float32)
    enc = run.stages["encode_transform"]

    H2, WF = SENSOR[0] // 2, SENSOR[1] // 2 * 64
    state = pipeline.new_state(B, SENSOR, p64=True, device="cpu")
    j_state = jax_p64_init(B, *SENSOR)
    n_kept = n_suppressed = 0
    for i, (ev, nv) in enumerate(_windows()):
        state, vol = enc(state, torch.from_numpy(ev), torch.from_numpy(nv))
        j_state, j_vol = j_enc(j_state, jnp.asarray(ev), jnp.asarray(nv))
        assert vol.shape == (B, H2, WF) and vol.dtype == torch.bfloat16
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        np.testing.assert_array_equal(state.numpy(), np.asarray(j_state),
                                      err_msg=f"state, window {i}")

        with torch.inference_mode():
            outs = [o.float() for o in tmodel(vol)]
        j_outs = [o.astype(jnp.float32)
                  for o in j_apply(variables, j_vol.astype(jnp.float32))]
        for lvl, (o, jo) in enumerate(zip(outs, j_outs)):
            assert o.shape == jo.shape and o.shape[-1] == 4 + 1 + 7
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-2,
                                       err_msg=f"level {lvl}, window {i}")
        dets, keep = run.stages["detect"](vol)
        j_dec = jax_eval_decode(j_outs, pipeline.STRIDES)
        j_dets, j_keep = jax_postprocess(j_dec, max_detections=100)
        j_keep = np.asarray(j_keep)
        np.testing.assert_array_equal(keep.numpy(), j_keep,
                                      err_msg=f"keep, window {i}")
        for b in range(B):
            _assert_same_dets(dets.numpy()[b][j_keep[b]],
                              np.asarray(j_dets)[b][j_keep[b]],
                              np.asarray(j_dec)[b])
        valid = np.asarray(j_dets)[..., 5] > 0
        n_kept += int(j_keep.sum())
        n_suppressed += int((valid & ~j_keep).sum())
    assert n_kept > 0 and n_suppressed > 0, (n_kept, n_suppressed)
