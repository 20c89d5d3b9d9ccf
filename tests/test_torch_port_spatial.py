"""The port's H-sharded TAF steps (frlw_evd_tpu_torch/parallel/spatial.py)
against the JAX package's (frlw_evd_tpu/parallel/spatial.py) on the CPU.

The port runs its n shards one after another, each on its rows of the
queue and the whole event set; JAX runs them under shard_map on a mesh of
the 8 host devices that tests/conftest.py makes. Three windows carry the
state: events on every shard's first and last rows, one stream empty in
the second window, and the third window an empty bin for one stream in
every shard but the first (its events all fall in shard 0's rows), so the
global any-event flag, not the shard's, must decide the freeze.

Gates: against JAX, the GEN1 step within JAX's atol 1e-4 (tests/
test_spatial_sharding.py:15-56), the p64 step's state within 1e-5 and
its volume within 1e-3 (:91-136); against the port's unsharded step, the
shards' rows bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from frlw_evd_tpu.encode import pallas_scatter, pallas_update
from frlw_evd_tpu.parallel import spatial as jspatial
from frlw_evd_tpu.parallel.mesh import make_mesh
from frlw_evd_tpu_torch.encode.streaming import taf_stream_step
from frlw_evd_tpu_torch.encode.update import (p64_init_state,
                                              taf_stream_step_kernel_p64)
from frlw_evd_tpu_torch.parallel import spatial

INIT = -6000.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process while the file runs: small ops
    stall on the thread pool's barriers when the suite's other workers
    hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(B, E, H, W, n_shards, seed=0, snap_t=False):
    """Three (xytp, n_valid) windows as numpy: uniform events plus, in
    each stream, one event on each shard's first and last row; stream
    B - 1 empty in window 1; in window 2 stream 0's events all in shard
    0's rows. snap_t: t sorted and snapped to multiples of 1/256 in
    [0, 0.5), where JAX's 12-bit, bf16-rounded t equals the port's exact
    t (ROADMAP.md §C: "t is kept exact"), as
    tests/test_torch_port_pipeline.py snaps it."""
    rng = np.random.default_rng(seed)
    h = H // n_shards
    edges = np.array([r for s in range(n_shards)
                      for r in (s * h, s * h + h - 1)], np.float32)
    out = []
    for i in range(3):
        ev = np.zeros((B, E, 4), np.float32)
        ev[..., 0] = rng.integers(0, W, (B, E))
        ev[..., 1] = rng.integers(0, H, (B, E))
        ev[..., 2] = rng.uniform(0, 1, (B, E))
        if snap_t:
            ev[..., 2] = np.floor(np.sort(ev[..., 2], axis=1) * 128) / 256
        ev[..., 3] = rng.integers(0, 2, (B, E))
        ev[:, :len(edges), 1] = edges
        nv = np.full(B, E, np.int32)
        if i == 1:
            nv[-1] = 0
        if i == 2:
            ev[0, :, 1] = rng.integers(0, h, E)
        out.append((ev, nv))
    return out


def _port_sharded(step_fn, state, windows, n, shard_state, **kw):
    """The port's n shards run one after another over the windows: the
    concatenated shard states (and volumes) after each window."""
    shards = [shard_state(state, n, s) for s in range(n)]
    steps = [step_fn(n_shards=n, shard=s, **kw) for s in range(n)]
    out = []
    for ev, nv in windows:
        res = [steps[s](shards[s], torch.from_numpy(ev),
                        torch.from_numpy(nv)) for s in range(n)]
        if isinstance(res[0], tuple):
            shards = [r[0] for r in res]
            out.append((torch.cat(shards, 1).clone(),
                        torch.cat([r[1] for r in res], 1)))
        else:
            shards = res
            out.append(torch.cat(shards, 1).clone())
    return out


@pytest.mark.parametrize("use_mxu", [True, False], ids=["mxu", "exact"])
def test_gen1_step_matches_jax_and_unsharded(use_mxu):
    B, E, H, W, K, n = 3, 512, 64, 48, 4, 4
    windows = _windows(B, E, H, W, n)
    got = _port_sharded(
        lambda **kw: spatial.make_spatial_taf_step(H, use_mxu=use_mxu, **kw),
        torch.full((B, H, W, 2, K), INIT), windows, n,
        spatial.shard_taf_state)

    ref = torch.full((B, H, W, 2, K), INIT)
    mesh = make_mesh(n)
    j_step = jspatial.make_spatial_taf_step(mesh, H, use_mxu=use_mxu)
    j_state = jspatial.shard_taf_state(mesh, jnp.full((B, H, W, 2, K), INIT))
    for i, (ev, nv) in enumerate(windows):
        ref = taf_stream_step(ref, torch.from_numpy(ev),
                              torch.from_numpy(nv), use_mxu=use_mxu)
        assert torch.equal(got[i], ref), i
        j_state = j_step(j_state, jnp.asarray(ev), jnp.asarray(nv))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(j_state),
                                   atol=1e-4, rtol=0, err_msg=str(i))
    # the freeze is global: stream 0's rows outside shard 0 aged in window 2
    assert not torch.equal(got[2][0, H // n:], got[1][0, H // n:])
    # and the empty stream kept its queue in window 1
    assert torch.equal(got[1][-1], got[0][-1])


def test_gen1_step_2d_layout_matches_jax():
    """Batch halves x 4 H shards (the JAX (2, 4) mesh, batch over 'data',
    H over 'model'): each tile is the port's step on its streams' rows."""
    B, E, H, W, K = 4, 512, 32, 48, 4
    ev, nv = _windows(B, E, H, W, 4, seed=1)[0]
    nv = np.array([E, E - 100, E - 200, 0], np.int32)
    state = torch.full((B, H, W, 2, K), INIT)
    tiles = []
    for b in range(2):
        rows = slice(b * B // 2, (b + 1) * B // 2)
        tiles.append(torch.cat(_port_sharded(
            lambda **kw: spatial.make_spatial_taf_step(H, **kw),
            state[rows], [(ev[rows], nv[rows])], 4,
            spatial.shard_taf_state), 0))
    got = torch.cat(tiles, 0)
    assert torch.equal(got, taf_stream_step(
        state.clone(), torch.from_numpy(ev), torch.from_numpy(nv)))

    mesh = make_mesh(8, axis_names=("data", "model"), shape=(2, 4))
    step = jspatial.make_spatial_taf_step(mesh, H, axis="model",
                                          batch_axis="data")
    out = step(jax.device_put(jnp.full((B, H, W, 2, K), INIT),
                              NamedSharding(mesh, P("data", "model"))),
               jax.device_put(jnp.asarray(ev), NamedSharding(mesh, P("data"))),
               jax.device_put(jnp.asarray(nv), NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("scatter", ["sorted", "pallas"])
def test_p64_step_matches_jax_and_unsharded(monkeypatch, scatter):
    """scatter "pallas" is the raw path (B1 in the p64 order, then B3) and
    "sorted" the sorted histogram, then B5; JAX's Pallas kernels run in
    interpret mode, as its own test runs them; t snapped (_windows)."""
    orig = jax.experimental.pallas.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_scatter.pl, "pallas_call", interp_call)
    monkeypatch.setattr(pallas_update.pl, "pallas_call", interp_call)

    B, H, W, K, E, n = 2, 64, 64, 8, 700, 4
    windows = _windows(B, E, H, W, n, seed=2, snap_t=True)
    got = _port_sharded(
        lambda **kw: spatial.make_spatial_taf_step_p64(H, W, scatter=scatter,
                                                       **kw),
        p64_init_state(B, H, W, K, device="cpu"), windows, n,
        spatial.shard_taf_state_p64)

    ref = p64_init_state(B, H, W, K, device="cpu")
    mesh = make_mesh(n)
    j_step = jspatial.make_spatial_taf_step_p64(mesh, H, W, scatter=scatter)
    j_state = jspatial.shard_taf_state_p64(
        mesh, jnp.full((B, H // 2, (W // 2) * 8 * K), INIT, jnp.float32))
    for i, (ev, nv) in enumerate(windows):
        ref, vol = taf_stream_step_kernel_p64(
            ref, torch.from_numpy(ev), torch.from_numpy(nv), height=H,
            width=W, scatter=scatter, fold_output=True)
        assert torch.equal(got[i][0], ref), i
        assert torch.equal(got[i][1], vol), i
        with mesh:
            j_state, j_vol = j_step(j_state, jnp.asarray(ev),
                                    jnp.asarray(nv))
        np.testing.assert_allclose(got[i][0].numpy(), np.asarray(j_state),
                                   atol=1e-5, rtol=0, err_msg=str(i))
        np.testing.assert_allclose(got[i][1].float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=1e-3,
                                   rtol=0, err_msg=str(i))


def test_shards_must_split_the_rows():
    with pytest.raises(ValueError, match="equal shards"):
        spatial.make_spatial_taf_step(30, n_shards=4, shard=0)
    with pytest.raises(ValueError, match="equal shards"):
        spatial.shard_taf_state(torch.zeros(1, 8, 4, 2, 4), 4, 4)
