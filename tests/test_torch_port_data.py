"""The port's data layer (frlw_evd_tpu_torch/data) against the JAX
package's on the mini fixture (tests/fixtures.py: 60x76 sensor, 64x96
input): the synthetic tree byte for byte, dataset samples with and
without augmentation at one seed, the Loader's batch order and
collation, and the streaming Fetcher. Exact equality, except the
Fetcher's volumes: test_torch_port_streaming.py's event-volume gates
(2e-3 on the first window, 2e-2 after)."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from frlw_evd_tpu.data import dataset as j_dataset
from frlw_evd_tpu.data import fetcher as j_fetcher
from frlw_evd_tpu.data import loader as j_loader
from frlw_evd_tpu.encode import streaming as j_streaming
from frlw_evd_tpu_torch.data import dataset as t_dataset
from frlw_evd_tpu_torch.data import fetcher as t_fetcher
from frlw_evd_tpu_torch.data import loader as t_loader
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.encode import streaming as t_streaming

SENSOR, INPUT = fixtures.SENSOR_HW, fixtures.INPUT_HW


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return fixtures.build_mini_gen1(str(tmp_path_factory.mktemp("mini")))


def _strip_date(data: bytes) -> bytes:
    return b"\n".join(ln for ln in data.split(b"\n")
                      if not ln.startswith(b"% Date"))


def test_synthetic_tree_equals_fixture_bytes(tmp_path):
    kw = dict(streams=("seq0", "seq1"), splits=("train", "val"),
              ann_times=(600_000, 700_000))
    fixtures.build_mini_gen1(str(tmp_path / "jax"),
                             np.random.default_rng(5), **kw)
    synthetic.build_mini_gen1(str(tmp_path / "port"),
                              np.random.default_rng(5), **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 2 * 2 * (2 + 2 + 2 * 2)
    for rel in files:
        a = (tmp_path / "jax" / rel).read_bytes()
        b = (tmp_path / "port" / rel).read_bytes()
        if rel.suffix == ".dat":
            a, b = _strip_date(a), _strip_date(b)
        assert a == b, rel


def _datasets(mini, kind, mode, augment, seed=0):
    if kind == "taf":
        args = (mini["labels"], mini["taf_dir"], "gen1", INPUT, INPUT, 10000,
                8, mode, augment)
        return (t_dataset.PropheseeTafDataset(*args, seed=seed,
                                              sensor_hw=SENSOR),
                j_dataset.PropheseeTafDataset(*args, seed=seed,
                                              sensor_hw=SENSOR))
    args = (mini["labels"], mini["ev_dir"], "gen1", INPUT, INPUT, 5, 10000,
            mode, augment)
    return (t_dataset.PropheseeDataset(*args, seed=seed, sensor_hw=SENSOR),
            j_dataset.PropheseeDataset(*args, seed=seed, sensor_hw=SENSOR))


def _assert_same_sample(got, want):
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("kind,mode,augment", [
    ("taf", "train", False), ("taf", "train", True), ("taf", "val", False),
    ("ev", "train", True), ("ev", "test", False)])
def test_dataset_samples_equal_jax(mini, kind, mode, augment):
    """Samples drawn in order (the augmentation's one random.Random)."""
    port, jax_ds = _datasets(mini, kind, mode, augment, seed=3)
    assert len(port) == len(jax_ds) == 6
    assert port.file_name == jax_ds.file_name
    assert port.sequence_end_t == jax_ds.sequence_end_t
    for _ in range(2):                     # two epochs of draws
        for i in range(len(port)):
            _assert_same_sample(port[i], jax_ds[i])
    assert t_dataset.dataset_geometry("gen4") == \
        j_dataset.dataset_geometry("gen4")


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 4),
                                                     (False, False, 4),
                                                     (True, False, 5)])
def test_loader_batches_equal_jax(mini, shuffle, drop_last, batch):
    port_ds, jax_ds = _datasets(mini, "taf", "train", False)
    for ds in (port_ds, jax_ds):       # more samples: the index repeated
        ds.file_name, ds.sequence_end_t = (ds.file_name * 3,
                                           ds.sequence_end_t * 3)
    port = t_loader.Loader(port_ds, batch, num_workers=2, shuffle=shuffle,
                           drop_last=drop_last, seed=7)
    ref = j_loader.Loader(jax_ds, batch, num_workers=2, shuffle=shuffle,
                          drop_last=drop_last, seed=7)
    assert len(port) == len(ref)
    for _ in range(2):                               # two epochs
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for g, w in zip(got, want):
            assert isinstance(g[0], torch.Tensor)
            assert g[0].dtype == torch.float32 and g[1].dtype == torch.float32
            np.testing.assert_array_equal(g[0].numpy(), w[0])
            np.testing.assert_array_equal(g[1].numpy(), w[1])
            assert g[2] == w[2]
            np.testing.assert_array_equal(g[3], w[3])
    assert port.epoch == ref.epoch == 2


def test_loader_surfaces_a_worker_error(mini):
    port_ds, _ = _datasets(mini, "taf", "train", False)
    port_ds.sequence_end_t = [1] * len(port_ds)    # no such blob
    with pytest.raises(FileNotFoundError):
        list(t_loader.Loader(port_ds, 2, num_workers=1, shuffle=False))


def _stream_events(rng, n=6000, duration=120_000):
    events = np.zeros((n, 5), np.float32)
    events[:, 1] = rng.integers(0, 20, n)
    events[:, 2] = rng.integers(0, 16, n)
    events[:, 3] = np.sort(rng.integers(0, duration, n))
    events[:, 4] = rng.integers(0, 2, n)
    labels = np.array([[0, 8, 6, 4, 4, 1, 60_000],
                       [0, 9, 7, 5, 3, 0, 70_000],
                       [0, 3, 3, 2, 2, 1, 100_000]], np.float32)
    return events, labels, np.array([[0, duration]])


@pytest.mark.parametrize("cls", ["Fetcher", "FetcherTrain"])
def test_fetcher_windows_equal_jax(cls):
    """Both fetchers over the same stream, each with its package's
    event-volume stream as `to_volume` (B = 1, exact scatter)."""
    H, W = 16, 20
    events, labels, timestamps = _stream_events(np.random.default_rng(0))
    fetchers = {}

    def to_volume_port(ev, n, state):
        f = fetchers["port"]
        xytp = torch.from_numpy(np.asarray(ev)[None, :, 1:5].copy())
        return t_streaming.event_volume_stream(
            xytp, torch.tensor([n]), state, float(f.iter), height=H, width=W,
            use_mxu=False)

    def to_volume_jax(ev, n, state):
        f = fetchers["jax"]
        return j_streaming.event_volume_stream(
            jnp.asarray(np.asarray(ev)[None, :, 1:5]), jnp.asarray([n]),
            state, float(f.iter), height=H, width=W, use_mxu=False)

    kw = dict(events_window=50_000, event_volume_bins=5, infer_time=10_000,
              max_events=4096)
    fetchers["port"] = getattr(t_fetcher, cls)(
        events, (H, W), labels, timestamps, ["s0"], to_volume=to_volume_port,
        **kw)
    fetchers["jax"] = getattr(j_fetcher, cls)(
        events, (H, W), labels, timestamps, ["s0"], to_volume=to_volume_jax,
        **kw)
    i = 0
    while not fetchers["jax"].finish:
        got = fetchers["port"].fetch()
        want = fetchers["jax"].fetch()
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=2e-3 if i == 0 else 2e-2)
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3] and got[4] >= 0
        i += 1
    assert fetchers["port"].finish and i == 8
    assert fetchers["port"].iter == fetchers["jax"].iter


def test_collate_pins_only_when_asked(mini):
    port_ds, _ = _datasets(mini, "taf", "val", False)
    imgs, labels, names, tss = t_loader.collate_batch(
        [port_ds[0], port_ds[1]])
    assert not imgs.is_pinned() and imgs.shape == (2, *INPUT, 16)
    assert labels.shape == (2, t_dataset.MAX_LABELS, 8)
    assert names == port_ds.file_name[:2] and list(tss) == \
        port_ds.sequence_end_t[:2]
    assert os.path.basename(port_ds.root) == "val"
