"""Structured `.npy` codec for Prophesee annotation / event files (a copy of
frlw_evd_tpu/events/npy_codec.py).

The GEN1 / 1MEGAPIXEL bounding-box files are standard numpy structured arrays;
the reference streams them with a hand-rolled header parse so it can seek
(reference: data/prophesee/npy_events_tools.py). Field names are normalised:
``ts`` → ``t`` and ``confidence`` → ``class_confidence``.
"""

from __future__ import annotations

import numpy as np


_RENAME = {"ts": "t", "confidence": "class_confidence"}


def parse_npy_header(f, exact: bool = False):
    """Parse the header of an open .npy file handle.

    Returns ``(start_of_data, ev_type, ev_size, (None, None))``. By default
    ``ev_type`` is a list of (name, dtype-string) pairs with normalised names
    (reference-compatible); with ``exact=True`` it is the on-disk numpy dtype,
    preserving padding/offsets.
    """
    version = np.lib.format.read_magic(f)
    shape, fortran, dtype = np.lib.format._read_array_header(f, version)
    if fortran:
        raise ValueError("Fortran-order arrays are not supported")
    ev_size = dtype.itemsize
    if ev_size == 0:
        raise ValueError("zero-size dtype")
    start = f.tell()
    if exact:
        return start, dtype, ev_size, (None, None)
    ev_type = [(name, str(dtype.fields[name][0])) for name in dtype.names]
    ev_type = [(_RENAME.get(n, n), d) for n, d in ev_type]
    return start, ev_type, ev_size, (None, None)


def stream_td_data(f, buffer: np.ndarray, dtype, ev_count: int = -1) -> None:
    """Read up to ev_count structured records from f into buffer, normalising
    legacy field names on the fly."""
    dat = np.fromfile(f, dtype=dtype, count=ev_count)
    count = len(dat)
    for name in dat.dtype.names:
        buffer[_RENAME.get(name, name)][:count] = dat[name]


def load_bboxes(path: str) -> np.ndarray:
    """Load a full *_bbox.npy annotation file as a structured array.

    Reads with the exact on-disk dtype (preserving any padding/offsets that the
    flattened ``parse_npy_header`` field list would lose), then normalises the
    legacy field names ts → t / confidence → class_confidence.
    """
    boxes = np.load(path)
    names = list(boxes.dtype.names)
    rename = {"ts": "t", "confidence": "class_confidence"}
    if any(n in rename for n in names):
        boxes = boxes.astype(
            [(rename.get(n, n), boxes.dtype.fields[n][0]) for n in names]
        )
    return boxes
