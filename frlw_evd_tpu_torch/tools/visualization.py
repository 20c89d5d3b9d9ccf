"""Representation + detection visualisation (counterpart of
tools/visualization.py; reference visualization.py), drawn with
utils/draw.py in numpy: no cv2.

Renders an encoded representation (Event Volume / TAF / count frame / SAE
time surface), the optional optical flow (Middlebury color wheel) and the
GT / DT boxes to PNG per annotation timestamp. The labels are in the
bitmap font of utils/draw.py, not cv2's Hershey glyphs.

    python -m frlw_evd_tpu_torch.tools.visualization -item <stream> \\
        -end 600000 -data_path <blob dir> -bbox_path <label dir> \\
        -result_path out/ -dataset gen1 -event_type taf [-exp_name NAME]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..events.box_loading import boxes_to_array
from ..events.npy_codec import load_bboxes
from ..utils import draw
from .generate_common import GEOMETRY

LABELMAP = {
    "gen1": ["car", "pedestrian"],
    "gen1_mini": ["car", "pedestrian"],
    "gen4": ["pedestrian", "two wheeler", "car", "truck", "bus",
             "traffic sign", "traffic light"],
}


# ---------------------------------------------------------------------------
# Middlebury flow color wheel (visualization.py:64-199)
# ---------------------------------------------------------------------------

def make_color_wheel():
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros([ncols, 3])
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    u, v = flow[:, :, 0], flow[:, :, 1]
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255
        col1 = wheel[k1, i] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.floor(255 * col)
    return img


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def draw_bboxes(img, boxes, is_dt, labelmap):
    """GT solid / DT labeled boxes (visualization.py:39-62)."""
    colors = draw.COLORMAP_HSV[:255]
    for row in boxes:
        x1, y1 = int(row[1]), int(row[2])
        size = (int(row[3]), int(row[4]))
        pt2 = (x1 + size[0], y1 + size[1])
        cls_id = int(row[5])
        color = colors[(cls_id * 60) % 255].tolist()
        draw.rectangle(img, (x1, y1), pt2, color)
        label = labelmap[cls_id % len(labelmap)]
        if is_dt:
            label += f" {row[7]:.2f}"
        draw.put_text(img, label, (x1, max(y1 - 2, 0)), color)
    return img


def render_volume(volume: np.ndarray) -> np.ndarray:
    """(C, H, W) float volume → its channel mean through the JET map."""
    img = volume.mean(0)
    img = (img / max(img.max(), 1e-8) * 255).astype(np.uint8)
    return draw.apply_colormap(img, draw.COLORMAP_JET)


def load_representation(args, shape):
    h, w = shape
    if args.event_type == "taf":
        p1 = os.path.join(args.data_path, "test", "bins4",
                          f"{args.item}_{args.end}.npy")
        p2 = os.path.join(args.data_path, "test", "bins8",
                          f"{args.item}_{args.end}.npy")
        v1 = np.fromfile(p1, dtype=np.uint8).reshape(8, h, w)
        v2 = np.fromfile(p2, dtype=np.uint8).reshape(8, h, w)
        return np.concatenate([v1, v2]).astype(np.float32)
    path = os.path.join(args.data_path, "test", f"{args.item}_{args.end}.npy")
    blob = np.fromfile(path, dtype=np.uint8).astype(np.float32)
    c = blob.size // (h * w)
    return blob.reshape(c, h, w)


def main(argv=None):
    """Writes the PNGs; returns {"image": the drawn representation, and
    "flow" where a flow file exists: the drawn flow}, each as written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-item", type=str, required=True)
    parser.add_argument("-end", type=int, required=True)
    parser.add_argument("-data_path", type=str, required=True)
    parser.add_argument("-bbox_path", type=str, required=True)
    parser.add_argument("-result_path", type=str, default="visualization")
    parser.add_argument("-dataset", type=str, default="gen1")
    parser.add_argument("-event_type", type=str, default="taf")
    parser.add_argument("-exp_name", type=str, default=None)
    parser.add_argument("-log_path", type=str, default="log/")
    parser.add_argument("-flow_dir", type=str, default="optical_flow_buffer")
    parser.add_argument("-tol", type=int, default=4999)
    args = parser.parse_args(argv)

    geo = GEOMETRY[args.dataset]
    shape = geo["target_shape"]
    sensor = geo["shape"]
    labelmap = LABELMAP[args.dataset]
    os.makedirs(args.result_path, exist_ok=True)

    volume = load_representation(args, shape)
    img = render_volume(volume)
    img = draw.resize_nearest(img, (sensor[1], sensor[0]))

    # GT boxes at this timestamp
    boxes = boxes_to_array(load_bboxes(
        os.path.join(args.bbox_path, "test", f"{args.item}_bbox.npy")))
    gt = boxes[np.abs(boxes[:, 0] - args.end) <= args.tol]
    img = draw_bboxes(img, gt, False, labelmap)

    # DT boxes from a recorded run
    if args.exp_name:
        dump = np.load(os.path.join(args.log_path, args.exp_name,
                                    "summarise.npz"))
        dts = np.asarray(dump["dts"], np.float64)
        names = np.asarray(dump["file_names"])
        sel = (names == args.item) & (np.abs(dts[:, 0] - args.end) <= args.tol)
        img = draw_bboxes(img, dts[sel], True, labelmap)

    out = os.path.join(args.result_path,
                       f"{args.item}_{args.end}_{args.event_type}.png")
    draw.write_png(out, img)
    print("saved", out)
    drawn = {"image": img}

    # optional flow rendering
    flow_path = os.path.join(args.flow_dir, f"{args.item}_{args.end}.npy")
    if os.path.exists(flow_path):
        flow_img = flow_to_image(np.load(flow_path))
        out = os.path.join(args.result_path,
                           f"{args.item}_{args.end}_flow.png")
        draw.write_png(out, flow_img)
        print("saved", out)
        drawn["flow"] = flow_img
    return drawn


if __name__ == "__main__":
    main()
