"""What decides `correct`, in general: a cell's check module
(checks/<name>.py, named in the cell file's "check") compares what the
timed path produced with the plain reference once the window has closed
and returns a reading for each of its numbers; the cell file gives each
number its limit, and this module judges the readings against them.

A check module has `compare(ctx, window) -> {number: reading}`, where
`window` is what the cell's driver returned, and whatever its driver asks
of it during the window (the serving driver's `recorder`)."""

from __future__ import annotations


def judge(readings: dict, limits: dict):
    """(correct, [(name, reading, limit)]) over the numbers of `limits`:
    correct when every reading is at most its limit (a NaN reading is
    not)."""
    rows = [(k, readings[k], lim) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
