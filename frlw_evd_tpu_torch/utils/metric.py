"""Metric meters (counterpart of frlw_evd_tpu/utils/metric.py; reference
core/yolox/utils/metric.py:51-121), host Python over numpy."""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class AverageMeter:
    """Running average over a sliding window plus a global average."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        self._deque.append(value)
        self._count += 1
        self._total += value

    @property
    def median(self):
        return float(np.median(self._deque)) if self._deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self._deque)) if self._deque else 0.0

    @property
    def global_avg(self):
        return self._total / max(self._count, 1e-5)

    @property
    def latest(self):
        return self._deque[-1] if self._deque else None

    @property
    def total(self):
        return self._total

    def reset(self):
        self._deque.clear()
        self._total = 0.0
        self._count = 0

    def clear(self):
        self._deque.clear()


class MeterBuffer(defaultdict):
    """Dict of AverageMeters keyed by metric name."""

    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size))

    def reset(self):
        for v in self.values():
            v.reset()

    def get_filtered_meter(self, filter_key: str = "time"):
        return {k: v for k, v in self.items() if filter_key in k}

    def update(self, values=None, **kwargs):
        if values is None:
            values = {}
        values.update(kwargs)
        for k, v in values.items():
            if hasattr(v, "item"):      # a one-element tensor or array
                v = v.item()
            self[k].update(v)

    def clear_meters(self):
        for v in self.values():
            v.clear()
