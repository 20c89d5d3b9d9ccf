"""Prophesee Event2D `.dat` binary codec (a copy of
frlw_evd_tpu/events/dat_codec.py, kept here so the port imports nothing of
the JAX package).

File layout (reference: data/prophesee/dat_events_tools.py):
  * ASCII header lines starting with ``"% "`` (Date / Height / Width / ...)
  * if any header line was present: 1 byte event type + 1 byte event size
  * packed little-endian records: ``ts:u4`` then an ``i4`` word holding
    x (bits 0-13), y (bits 14-27), p (bit 28).

All functions are numpy-only and bit-exact with the reference unpack masks
(dat_events_tools.py:96-98) and repack (dat_events_tools.py:202-225).
"""

from __future__ import annotations

import datetime
import os

import numpy as np

# Packed on-disk record: timestamp + bit-packed (x, y, p) word.
EV_TYPE = [("ts", "u4"), ("_", "i4")]
EV_STRING = "Event2D"

# Decoded in-memory record.
DECODE_DTYPE = [("ts", "u4"), ("x", "u2"), ("y", "u2"), ("p", "u1")]

_X_MASK = 16383  # bits 0-13
_Y_MASK = 268419072  # bits 14-27
_P_MASK = 268435456  # bit 28


def unpack_events(raw: np.ndarray) -> np.ndarray:
    """Decode packed Event2D records into (ts, x, y, p) structured array."""
    out = np.empty(raw.shape[0], dtype=DECODE_DTYPE)
    out["ts"] = raw["ts"]
    word = raw["_"]
    out["x"] = np.bitwise_and(word, _X_MASK).astype(np.uint16)
    out["y"] = np.right_shift(np.bitwise_and(word, _Y_MASK), 14).astype(np.uint16)
    out["p"] = np.right_shift(np.bitwise_and(word, _P_MASK), 28).astype(np.uint8)
    return out


def pack_events(ts, x, y, p) -> np.ndarray:
    """Pack (ts, x, y, p) arrays into on-disk Event2D records."""
    out = np.empty(len(ts), dtype=EV_TYPE)
    out["ts"] = np.asarray(ts, dtype=np.uint32)
    xi = np.asarray(x).astype("i4")
    yi = np.left_shift(np.asarray(y).astype("i4"), 14)
    pi = np.left_shift((np.asarray(p) == 1).astype("i4"), 28)
    out["_"] = xi + yi + pi
    return out


def parse_dat_header(f):
    """Parse a .dat header from an open binary file handle.

    Returns ``(start_of_data, ev_type, ev_size, (height, width))``; height and
    width are None when absent from the header.
    """
    f.seek(0, os.SEEK_SET)
    bod = f.tell()
    size = [None, None]
    num_comment_lines = 0
    while True:
        bod = f.tell()
        line = f.readline()
        if line.decode("latin-1")[:2] != "% ":
            break
        words = line.split()
        if len(words) > 2:
            if words[1] in (b"Height", "Height"):
                size[0] = int(words[2])
            elif words[1] in (b"Width", "Width"):
                size[1] = int(words[2])
        num_comment_lines += 1
    f.seek(bod, os.SEEK_SET)
    if num_comment_lines > 0:
        ev_type = int(np.frombuffer(f.read(1), dtype=np.uint8)[0])
        ev_size = int(np.frombuffer(f.read(1), dtype=np.uint8)[0])
    else:
        ev_type = 0
        ev_size = sum(int(desc[-1]) for _, desc in EV_TYPE)
    bod = f.tell()
    return bod, ev_type, ev_size, tuple(size)


def stream_td_data(f, buffer: np.ndarray, dtype, ev_count: int = -1) -> None:
    """Read up to ev_count packed records from f, decoding into buffer."""
    raw = np.fromfile(f, dtype=dtype, count=ev_count)
    n = len(raw)
    decoded = unpack_events(raw)
    for name in ("ts", "x", "y", "p"):
        buffer[name][:n] = decoded[name]


def count_events(path: str) -> int:
    with open(path, "rb") as f:
        bod, _, ev_size, _ = parse_dat_header(f)
        f.seek(0, os.SEEK_END)
        eod = f.tell()
        if (eod - bod) % ev_size != 0:
            raise ValueError(f"truncated .dat file: {path}")
        return (eod - bod) // ev_size


def load_td_data(path: str, ev_count: int = -1, ev_start: int = 0) -> np.ndarray:
    """Load decoded events from a .dat file (all by default)."""
    with open(path, "rb") as f:
        _, _, ev_size, _ = parse_dat_header(f)
        if ev_start > 0:
            f.seek(ev_start * ev_size, 1)
        raw = np.fromfile(f, dtype=EV_TYPE, count=ev_count)
    return unpack_events(raw)


def write_dat_header(path: str, height: int = 240, width: int = 320, ev_type: int = 0):
    """Create a .dat file and write its header; returns the open file object."""
    if max(height, width) > 2**14 - 1:
        raise ValueError("coordinates exceed the 14-bit .dat range")
    f = open(path, "w")
    f.write(f"% Data file containing {EV_STRING} events.\n% Version 2\n")
    now = datetime.datetime.now(datetime.timezone.utc)
    f.write(
        "% Date {}-{}-{} {}:{}:{}\n".format(
            now.year, now.month, now.day, now.hour, now.minute, now.second
        )
    )
    f.write(f"% Height {height:d}\n% Width {width:d}\n")
    ev_size = sum(int(desc[-1]) for _, desc in EV_TYPE)
    np.array([ev_type, ev_size], dtype=np.uint8).tofile(f)
    f.flush()
    return f


def write_event_buffer(f, events: np.ndarray) -> None:
    """Append decoded (ts/x/y/p) structured events to an open .dat file."""
    packed = pack_events(events["ts"], events["x"], events["y"], events["p"])
    packed.tofile(f)
    f.flush()


def write_dat_file(path: str, events: np.ndarray, height: int, width: int) -> None:
    f = write_dat_header(path, height=height, width=width)
    write_event_buffer(f, events)
    f.close()
