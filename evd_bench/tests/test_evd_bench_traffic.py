"""The traffic repeats from the seed, every seed gets the same windows in
another order, and the pool keeps the mix's rules."""

from __future__ import annotations

import json

import torch

from evd_bench import generate, harness

MIX = json.loads((harness.HERE / "traffic" / "events_mixed.json")
                 .read_text())


def pool(seed, batch=3, events=512, hw=(24, 40)):
    return generate.make_pool(harness.Bench(), MIX, batch, events, hw, seed,
                              "cpu")


def test_same_seed_same_pool_other_seed_other_pool():
    a, b, c = pool(2 ** 31 + 5), pool(2 ** 31 + 5), pool(2 ** 31 + 6)
    assert torch.equal(a.xytp, b.xytp) and torch.equal(a.n_valid, b.n_valid)
    assert not torch.equal(a.xytp, c.xytp)
    assert a.xytp.shape == c.xytp.shape == (MIX["pool"], 3, 512, 4)


def test_pool_keeps_the_mix():
    p = pool(11)
    ev, nv = p.xytp, p.n_valid
    assert (nv[0::2] == 512).all()               # uniform windows are full
    hot = MIX["kinds"][1]
    assert (nv[1::2] >= hot["min_events"]).all() and (nv <= 512).all()
    assert torch.equal(ev[..., :2], ev[..., :2].floor())
    assert (ev[..., 0] >= 0).all() and (ev[..., 0] <= 39).all()
    assert (ev[..., 1] >= 0).all() and (ev[..., 1] <= 23).all()
    assert ((ev[..., 2] >= 0) & (ev[..., 2] < 1)).all()
    assert set(ev[..., 3].unique().tolist()) == {0.0, 1.0}
    t = ev[1::2, ..., 2]
    assert (t[..., 1:] >= t[..., :-1]).all()     # sorted in hotspot windows
    assert torch.equal(p.window(MIX["pool"] + 1)[0], ev[1])


def test_every_seed_serves_the_same_windows_in_another_order():
    """Each stream of a seed plays one drawn stream's sequence from a start
    a whole cycle of the kinds along; the streams of two seeds are the same
    sequences."""
    a, c = pool(2 ** 31 + 5, batch=6), pool(2 ** 31 + 6, batch=6)
    assert not torch.equal(a.xytp, c.xytp)
    assert int(a.n_valid.sum()) == int(c.n_valid.sum())

    def sequences(p):
        """Each stream's windows from its start, the least rotation of its
        counts by whole cycles of the two kinds."""
        out = []
        for s in range(p.xytp.shape[1]):
            nv = p.n_valid[:, s]
            k = min(range(0, MIX["pool"], 2),
                    key=lambda k: nv.roll(k).tolist())
            out.append(p.xytp[:, s].roll(k, 0))
        return sorted(out, key=lambda t: t.sum().item())

    for x, y in zip(sequences(a), sequences(c), strict=True):
        assert torch.equal(x, y)
