"""Seekable streaming reader for Prophesee .dat / .npy event files (a copy
of frlw_evd_tpu/events/psee_loader.py).

Behavioral contract (matching the reference data/prophesee/psee_loader.py):
  * ``current_time == t`` means the next event loaded has timestamp >= t; an
    event stamped exactly t has NOT been loaded yet.
  * ``seek_time`` is an exact binary search (psee_loader.py:187) returning the
    event index at the seek point, or None past end-of-file.
  * ``load_delta_t`` never returns an event stamped exactly at the window end.
"""

from __future__ import annotations

import os

import numpy as np

from . import dat_codec
from . import npy_codec


class PSEELoader:
    def __init__(self, path: str):
        self._extension = path.split(".")[-1]
        if self._extension not in ("dat", "npy"):
            raise ValueError(f"unsupported event file: {path}")
        self._file = open(path, "rb")
        if self._extension == "dat":
            self._t_flag = "ts"
            self._start, self.ev_type, self._ev_size, self._size = (
                dat_codec.parse_dat_header(self._file)
            )
            self._dtype = dat_codec.EV_TYPE
            self._decode_dtype = list(dat_codec.DECODE_DTYPE)
            self._stream = dat_codec.stream_td_data
        else:
            self._t_flag = "t"
            # Read with the exact on-disk dtype (keeps padding/offsets intact),
            # decode into a packed buffer with normalised field names.
            self._start, exact_dtype, self._ev_size, self._size = (
                npy_codec.parse_npy_header(self._file, exact=True)
            )
            self.ev_type = [
                (npy_codec._RENAME.get(n, n), str(exact_dtype.fields[n][0]))
                for n in exact_dtype.names
            ]
            self._dtype = exact_dtype
            self._decode_dtype = list(self.ev_type)
            self._stream = npy_codec.stream_td_data
        if self._ev_size == 0:
            raise ValueError("zero event size")

        self._file.seek(0, os.SEEK_END)
        self._end = self._file.tell()
        self._ev_count = (self._end - self._start) // self._ev_size
        self.done = False
        self._file.seek(self._start)
        self.current_time = 0
        self.duration_s = self.total_time() * 1e-6

    # -- introspection -----------------------------------------------------
    def event_count(self) -> int:
        return self._ev_count

    def get_size(self):
        """(height, width) of the sensor, possibly (None, None)."""
        return self._size

    def reset(self):
        self._file.seek(self._start)
        self.done = False
        self.current_time = 0

    # -- streaming reads ---------------------------------------------------
    def load_n_events(self, ev_count: int) -> np.ndarray:
        """Load the next ev_count events (fewer at end of file)."""
        buffer = np.empty((ev_count + 1,), dtype=self._decode_dtype)
        pos = self._file.tell()
        remaining = (self._end - pos) // self._ev_size
        if ev_count >= remaining:
            self.done = True
            ev_count = remaining
            self._stream(self._file, buffer, self._dtype, ev_count)
            if ev_count > 0:
                self.current_time = buffer[self._t_flag][ev_count - 1] + 1
        else:
            # read one extra event to learn the next timestamp, then rewind
            self._stream(self._file, buffer, self._dtype, ev_count + 1)
            self.current_time = buffer[self._t_flag][ev_count]
            self._file.seek(pos + ev_count * self._ev_size)
        return buffer[:ev_count]

    def load_delta_t(self, delta_t: int) -> np.ndarray:
        """Load all events within the next delta_t microseconds."""
        if delta_t < 1:
            raise ValueError("delta_t must be at least 1 us")
        if self.done or self._file.tell() >= self._end:
            self.done = True
            return np.empty((0,), dtype=self._decode_dtype)

        final_time = self.current_time + delta_t
        tmp_time = self.current_time
        start = self._file.tell()
        pos = start
        batch = 100000
        chunks = []
        while tmp_time < final_time and pos < self._end:
            count = (min(self._end, pos + batch * self._ev_size) - pos) // self._ev_size
            buf = np.empty((count,), dtype=self._decode_dtype)
            self._stream(self._file, buf, self._dtype, count)
            tmp_time = buf[self._t_flag][-1]
            chunks.append(buf)
            pos = self._file.tell()
        if tmp_time >= final_time:
            self.current_time = final_time
        else:
            self.current_time = tmp_time + 1
        idx = np.searchsorted(chunks[-1][self._t_flag], final_time)
        chunks[-1] = chunks[-1][:idx]
        events = np.concatenate(chunks)
        self._file.seek(start + len(events) * self._ev_size)
        self.done = self._file.tell() >= self._end
        return events

    # -- seeking -----------------------------------------------------------
    def seek_event(self, ev_count: int) -> None:
        """Position the cursor just after ev_count events."""
        if ev_count <= 0:
            self._file.seek(self._start)
            self.current_time = 0
        elif ev_count >= self._ev_count:
            self._file.seek(self._start + (self._ev_count - 1) * self._ev_size)
            last = np.fromfile(self._file, dtype=self._dtype, count=1)
            self.current_time = last[self._t_flag][0] + 1
        else:
            self._file.seek(self._start + ev_count * self._ev_size)
            nxt = np.fromfile(self._file, dtype=self._dtype, count=1)
            self.current_time = nxt[self._t_flag][0]
            self._file.seek(self._start + ev_count * self._ev_size)
        self.done = self._file.tell() >= self._end

    def seek_time(self, final_time: int, term_criterion: int = 100000):
        """Exact binary-search seek to final_time; returns the event index,
        or None when final_time is past the last event."""
        if final_time > self.total_time():
            self._file.seek(self._end)
            self.done = True
            self.current_time = self.total_time() + 1
            return None
        if final_time <= 0:
            self.reset()
            return 0

        low, high = 0, self._ev_count
        while high - low > term_criterion:
            middle = (low + high) // 2
            self.seek_event(middle)
            mid = np.fromfile(self._file, dtype=self._dtype, count=1)[self._t_flag][0]
            if mid > final_time:
                high = middle
            elif mid < final_time:
                low = middle + 1
            else:
                self.current_time = final_time
                self.done = self._file.tell() >= self._end
                return middle
        self.seek_event(low)
        ts = np.fromfile(self._file, dtype=self._dtype, count=high - low)[self._t_flag]
        final_index = int(np.searchsorted(ts, final_time))
        self.seek_event(low + final_index)
        self.current_time = final_time
        self.done = self._file.tell() >= self._end
        return low + final_index

    def total_time(self) -> int:
        """Timestamp of the last event in the file (microseconds)."""
        if not self._ev_count:
            return 0
        pos, current_time, done = self._file.tell(), self.current_time, self.done
        self.seek_event(self._ev_count - 1)
        t = np.fromfile(self._file, dtype=self._dtype, count=1)[self._t_flag][0]
        self._file.seek(pos)
        self.current_time, self.done = current_time, done
        return t

    def __repr__(self):
        return (
            f"PSEELoader(events={self._ev_count}, ev_size={self._ev_size}B, "
            f"duration={self.duration_s:.3f}s)"
        )

    def __del__(self):
        try:
            self._file.close()
        except Exception:
            pass
