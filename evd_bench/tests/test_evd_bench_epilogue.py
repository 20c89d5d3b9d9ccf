"""The reader of `epilogue_fused_share` (metrics/epilogue_fused_share.py)
on span summaries made by hand: None where the program left no records
or counted neither counter, else 100 * fused / (fused + plain)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from evd_bench import harness


def _read(summary):
    reader = harness.Bench().code("metrics", "epilogue_fused_share")
    return reader.read(SimpleNamespace(spans=summary))


def test_none_without_records_or_counters():
    assert _read({}) is None
    assert _read({"steps": 3, "spans": {}, "counts": {"nms_rounds": 40}}) \
        is None


@pytest.mark.parametrize("fused,plain,share", [(124, 0, 100.0),
                                               (0, 124, 0.0),
                                               (93, 31, 75.0)])
def test_share_from_the_counters(fused, plain, share):
    counts = {"epilogue_fused": fused, "epilogue_plain": plain}
    got = _read({"steps": 2, "spans": {}, "counts": counts})
    assert got == pytest.approx(share)
