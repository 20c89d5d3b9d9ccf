"""Streaming window fetcher: raw events → per-window on-device encode (a
copy of frlw_evd_tpu/data/fetcher.py; the reference's dormant online path,
data/fetcher.py + data/sparse_ops.py).

The fetcher slices a batch of raw event streams into `infer_time`-sized
windows (the first window spans `events_window`), hands each slice to an
on-device encoder that carries state across windows, and looks up labels
within ±(infer_time/2 - 1) µs of each window end.

Encoders plug in via the `to_volume(events, n_valid, state) -> (volume,
state)` protocol — see frlw_evd_tpu_torch.encode.streaming for the four
representations' streaming adapters. `represent_time` is read after a
synchronize on the volume's device, so it holds the encode's device time.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

MAX_LABELS = 80


class Fetcher:
    """Iterates windows over a pre-loaded batch of event streams.

    Args:
      events: (N, 5) float array [batch, x, y, t, p], t relative to each
        stream's start.
      labels: (M, 8) rows [batch, class/box..., t] in the reference layout
        [batch, cx, cy, w, h, cls?, t] — columns 1:5 box+cls, col 6 timestamp
        (matching data/fetcher.py:28 indexing).
      timestamps: (B, 2) [t_start, t_end] per stream.
      events_window: µs of history for the first window.
      infer_time: µs step per subsequent window.
      to_volume: encoder callable (events_xytp (E, 5), n_valid, state) →
        (volume, state).
    """

    def __init__(self, events, shape, labels, timestamps, filenames,
                 events_window, event_volume_bins, infer_time,
                 to_volume: Callable, max_events: int = 2**19,
                 train_mode: bool = False):
        self.events_window_abin = infer_time
        self.events_window = events_window
        self.event_volume_bins = event_volume_bins
        self.shape = shape
        self.state = None
        self.total_time = int(timestamps[0, 1] - timestamps[0, 0])
        self.iter = 0
        self.events = np.asarray(events)
        self.labels = np.asarray(labels)
        self.timestamps = np.asarray(timestamps)
        self.filenames = filenames
        self.finish = False
        self.to_volume = to_volume
        self.max_events = max_events
        self.train_mode = train_mode

    def get_labels(self, timestamps):
        """Window labels within ±(infer_time/2 - 1) µs (data/fetcher.py:22-33).
        Returns None when any stream has no label in the window."""
        tol = self.events_window_abin / 2 - 1
        B = len(self.timestamps)
        padded = np.zeros((B, MAX_LABELS, self.labels.shape[1] - 1),
                          np.float32)
        for b in range(B):
            ts = timestamps[b]
            sel = ((self.labels[:, 0] == b)
                   & (self.labels[:, 6] + tol >= ts)
                   & (self.labels[:, 6] - tol <= ts))
            rows = self.labels[sel]
            if len(rows) == 0:
                return None
            padded[b, :len(rows)] = rows[:, 1:]
        if self.train_mode and len(padded):
            # train rows: [class, cx, cy, w, h] (fetcherTrain, :64-70)
            padded = np.concatenate([padded[:, :, 4:5], padded[:, :, :4]], -1)
        return padded

    def fetch(self):
        """One window step → (volume, labels, timestamps, filenames,
        represent_time)."""
        t = self.events[..., 3]
        if self.iter == 0:
            buf = self.events[t < self.events_window]
            self.iter += self.events_window
        else:
            buf = self.events[(t >= self.iter)
                              & (t < self.iter + self.events_window_abin)]
            self.iter += self.events_window_abin
        if self.iter >= self.total_time:
            self.finish = True

        n = min(len(buf), self.max_events)
        padded = np.zeros((self.max_events, buf.shape[1]), np.float32)
        padded[:n] = buf[len(buf) - n:]

        start = time.time()
        volume, self.state = self.to_volume(padded, n, self.state)
        if isinstance(volume, torch.Tensor) and volume.device.type == "cuda":
            torch.cuda.synchronize(volume.device)
        represent_time = time.time() - start

        timestamps = self.timestamps[..., 0] + self.iter
        labels = self.get_labels(timestamps)
        return volume, labels, timestamps, self.filenames, represent_time


class FetcherTrain(Fetcher):
    def __init__(self, *args, **kwargs):
        kwargs["train_mode"] = True
        super().__init__(*args, **kwargs)


class FetcherVal(Fetcher):
    pass
