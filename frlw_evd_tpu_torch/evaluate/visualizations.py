"""In-loop tensor→PNG renderers (counterpart of
frlw_evd_tpu/evaluate/visualizations.py; reference
evaluate/visualizations.py), drawn with utils/draw.py in numpy.

Render an encoded representation with GT/DT boxes during evaluation —
lightweight hooks for debugging a running experiment; the full offline
renderer is tools/visualization.py.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import draw


def _host(a) -> np.ndarray:
    """A numpy array of a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _to_image(volume: np.ndarray) -> np.ndarray:
    """(C, H, W) float → uint8 heat image (mean over channels)."""
    img = volume.mean(0)
    img = img / max(float(img.max()), 1e-8) * 255.0
    return img.astype(np.uint8)


def _draw_boxes(img, boxes, color):
    for row in boxes:
        x1, y1 = int(row[0] - row[2] / 2), int(row[1] - row[3] / 2)
        x2, y2 = int(row[0] + row[2] / 2), int(row[1] + row[3] / 2)
        draw.rectangle(img, (x1, y1), (x2, y2), color)
    return img


def _render(volume, gt, dt, out):
    img = draw.apply_colormap(_to_image(volume), draw.COLORMAP_JET)
    img = _draw_boxes(img, _host(gt), (0, 255, 0))
    if dt is not None and len(dt):
        img = _draw_boxes(img, _host(dt), (0, 0, 255))
    return draw.write_png(out, img)


def visualize_volume(volume, gt, dt, filename, path, time_stamp_end):
    """Event Volume + boxes → <path>/<stream>_<ts>.png (reference
    visualizeVolume:30). volume (C, H, W); gt/dt rows cxcywh."""
    os.makedirs(path, exist_ok=True)
    return _render(_host(volume), gt, dt, os.path.join(
        path, f"{filename}_{int(time_stamp_end)}.png"))


def visualize_taf(volume, gt, dt, filename, path, time_stamp_end):
    """TAF representation render (reference visualize_taf:49): shows the
    newest bin pair rather than the channel mean."""
    os.makedirs(path, exist_ok=True)
    return _render(_host(volume)[:2], gt, dt, os.path.join(
        path, f"{filename}_{int(time_stamp_end)}_taf.png"))


class Visualizer:
    """Callable hook collecting renders during an eval epoch (reference
    visualizer:81)."""

    def __init__(self, path: str, renderer=visualize_volume):
        self.path = path
        self.renderer = renderer

    def __call__(self, volume, gt, dt, filename, time_stamp_end):
        return self.renderer(volume, gt, dt, filename, self.path,
                             time_stamp_end)
