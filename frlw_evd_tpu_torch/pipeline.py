"""Streaming TAF-K8 → AED serving paths (counterpart of bench.py's
make_pipeline_kernel, make_pipeline_p64 and _detect_body).

Per 10 ms bin, for B parallel streams:
  encode_transform(state_f, xytp, n_valid):
      GEN1 (`make_pipeline_kernel`): kernel B1 histogram → kernel B2 queue
      update + leaky on the folded queue (state in place) → nearest resize
      of the (B, H, W, 2K) bf16 volume to the input size;
      1 Mpx (`make_pipeline_p64`): B1 in the p64 cell order → kernel B3 on
      the patchified queue; the volume is already space-to-depth'd for a
      p64 stem (folded (B, H/2, (W/2)*64) for `bfm_folded`), no resize;
      with scatter="sorted", the plain sorted histogram and kernel B5 (on
      the GEN1 path, that histogram and B2);
  detect(vol):
      AED forward in the serving dtype → f32 decode → conf 0.3, top-100,
      NMS 0.6 → (dets (B, 100, 6), keep (B, 100)); with quant=(scales,
      table) the forward runs under models.quantize.int8_ctx, its calibrated
      convs through the int8 kernel (bench.py --dtype int8;
      `calibrate_pipeline` makes the pair from the live encode output)

Each make_pipeline_* function returns `run_step(state, xytp, n_valid) ->
(state, (dets, keep))` with the two stages under `run_step.stages`, as
bench.py's `_attach_stages` does. Entry points run on the card unless the
caller passes device="cpu", which runs the kernels' plain twins.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode.update import (init_state, p64_init_state,
                            taf_stream_step_kernel,
                            taf_stream_step_kernel_p64)
from .models.detector import EventDetector, eval_decode
from .models.postprocess import postprocess_batch
from .models.quantize import build_weight_table, calibrate_int8, int8_ctx
from .models.stems import BinsFusionModuleFolded

K = 8
STRIDES = (8, 16, 32)
MAX_DETECTIONS = 100


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (no entry point falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch twins instead of the CUDA kernels")
    return dev


def nearest_resize_indices(sensor_hw, input_hw, device=None):
    """Row and column source indices of the nearest resize, computed as
    the JAX pipeline does: float32 arange * (h / H) truncated
    (bench.py:204-205; 304/320 is not exact in binary, so the f32 product
    decides the indices)."""
    (h, w), (H, W) = sensor_hw, input_hw
    ys = (np.arange(H, dtype=np.float32) * np.float32(h / H)).astype(np.int64)
    xs = (np.arange(W, dtype=np.float32) * np.float32(w / W)).astype(np.int64)
    return (torch.from_numpy(ys).to(device), torch.from_numpy(xs).to(device))


def nearest_resize(vol, ys, xs):
    """(B, h, w, C) → (B, len(ys), len(xs), C) as two index selects
    (bench.py:197-206)."""
    return vol.index_select(1, ys).index_select(2, xs)


def _serving_model(model: EventDetector, device, dtype) -> torch.device:
    """Move `model` to `device` and cast it IN PLACE to the serving `dtype`:
    every float parameter and buffer, BatchNorm running statistics
    included (bench.py:856-858). On the card it runs channels_last."""
    dev = resolve_device(device)
    model.to(device=dev, dtype=dtype).eval()
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return dev


def _attach_stages(encode_transform, model: EventDetector, quant=None):
    """run_step with the encode_transform and detect stages; detect runs
    the forward under int8_ctx(model, *quant) when `quant` is given
    (bench.py:156-175) and decodes the head outputs in f32 (bench.py:170)."""
    ctx = int8_ctx(model, *(quant or (None, None)))  # no sites: a no-op

    @torch.inference_mode()
    def detect(vol):
        with ctx:
            outs = model(vol)
        decoded = eval_decode([o.float() for o in outs], STRIDES)
        return postprocess_batch(decoded, max_detections=MAX_DETECTIONS)

    def run_step(state_f, xytp, n_valid):
        state_f, vol = encode_transform(state_f, xytp, n_valid)
        return state_f, detect(vol)

    run_step.stages = {"encode_transform": encode_transform, "detect": detect}
    return run_step


def make_pipeline_kernel(model: EventDetector, sensor_hw, input_hw,
                         scatter: str = "pallas", *, device="cuda",
                         dtype=torch.bfloat16, quant=None):
    """Folded-state serving pipeline at any geometry (bench.py:254-276),
    with a canonical-input stem (`focus`, `bfm`). `scatter` ("pallas" or
    "sorted") goes to the step with precise=False, as bench.py passes it.
    quant: None (the serving dtype throughout) or (scales, table) of
    models.quantize (the int8 path); the model keeps its serving dtype."""
    dev = _serving_model(model, device, dtype)
    h, w = sensor_hw
    ys, xs = nearest_resize_indices(sensor_hw, input_hw, dev)

    def encode_transform(state_f, xytp, n_valid):
        state_f, vol = taf_stream_step_kernel(state_f, xytp, n_valid,
                                              height=h, width=w,
                                              scatter=scatter, precise=False)
        if tuple(input_hw) != tuple(sensor_hw):
            vol = nearest_resize(vol, ys, xs)
        return state_f, vol

    return _attach_stages(encode_transform, model, quant)


def make_pipeline_p64(model: EventDetector, sensor_hw,
                      scatter: str = "pallas", *, folded: bool, device="cuda",
                      dtype=torch.bfloat16, quant=None):
    """Patchified-state serving pipeline (bench.py:209-229), the 1 Mpx
    recipe: input == sensor, (W/2) % 16 == 0. The model's stem is a p64
    one, `bfm_folded` when `folded` (the volume stays (B, H/2, (W/2)*64)),
    else `bfm_p64_kernel`, `bfm_p64` or `focus_p64` on its (B, H/2, W/2, 64)
    view; `folded` must agree with the stem. `scatter` ("pallas" or
    "sorted") goes to the step with precise=False, as bench.py passes it.
    quant as in make_pipeline_kernel."""
    stem = type(model.backbone.stem).__name__
    if folded != isinstance(model.backbone.stem, BinsFusionModuleFolded):
        raise ValueError(f"make_pipeline_p64(folded={folded}) does not fit "
                         f"the model's stem {stem}: folded=True goes with "
                         f"bfm_folded only")
    _serving_model(model, device, dtype)
    h, w = sensor_hw

    def encode_transform(state_f, xytp, n_valid):
        return taf_stream_step_kernel_p64(state_f, xytp, n_valid, height=h,
                                          width=w, scatter=scatter,
                                          precise=False, fold_output=folded)

    return _attach_stages(encode_transform, model, quant)


def calibrate_pipeline(run_step, model: EventDetector, f32_state, state,
                       windows):
    """The int8 path's (scales, table), as bench.py:925-945 makes them:
    encode the first two windows ((xytp, n_valid) pairs) with run_step's
    encode stage from `state` (advanced in place), calibrate the serving
    model on the first min(8, B) volumes of each, and quantize the weights
    of the calibrated convs from `f32_state`, the f32 master state_dict
    taken before the serving cast. Pass the pair as make_pipeline_*'s
    quant."""
    encode = run_step.stages["encode_transform"]
    vols = []
    for xytp, n_valid in windows[:2]:
        state, vol = encode(state, xytp, n_valid)
        vols.append(vol[:min(8, vol.shape[0])])
    scales = calibrate_int8(model, vols)
    return scales, build_weight_table(f32_state, scales)


def spread_random_weights_(model: EventDetector, generator: torch.Generator,
                           obj_bias: float = 2.0) -> EventDetector:
    """Make seeded random weights produce boxes, for smoke runs and tests
    (real serving loads trained weights): BatchNorm affines drawn from
    scale U(1, 2), bias N(0, 0.5), so the head outputs are not nearly
    constant as at the identity init, and the obj biases raised from
    -log 99 (heads.py:141-142) so that scores pass conf 0.3."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(1.0, 2.0, generator=generator)
                mod.bias.normal_(0.0, 0.5, generator=generator)
        for name, mod in model.head.named_children():
            if name.startswith("obj_preds_"):
                mod.bias.fill_(obj_bias)
    return model


def new_state(batch: int, sensor_hw, *, p64: bool = False,
              device="cuda") -> torch.Tensor:
    """Fresh TAF-K8 queue for `batch` streams on `device`: folded
    (B, H, W*2K) for make_pipeline_kernel, or patchified (B, H/2,
    (W/2)*8K) for make_pipeline_p64 when `p64`."""
    h, w = sensor_hw
    make = p64_init_state if p64 else init_state
    return make(batch, h, w, K, device=resolve_device(device))


def synth_events(rng, steps, batch, e_per_bin, sensor_hw):
    """Uniform synthetic events, numpy (bench.py:356-364): returns
    (ev (steps, B, E, 4) f32, n_valid (steps, B) int32)."""
    h, w = sensor_hw
    ev = np.zeros((steps, batch, e_per_bin, 4), np.float32)
    ev[..., 0] = rng.integers(0, w, ev.shape[:-1])
    ev[..., 1] = rng.integers(0, h, ev.shape[:-1])
    ev[..., 2] = rng.uniform(0, 1, ev.shape[:-1])
    ev[..., 3] = rng.integers(0, 2, ev.shape[:-1])
    n_valid = np.full((steps, batch), e_per_bin, np.int32)
    return ev, n_valid


def synth_events_skewed(rng, steps, batch, e_per_bin, sensor_hw):
    """Spatially clustered, bursty synthetic events, numpy
    (bench.py:367-408): ~70% of events in 6 moving Gaussian hotspots per
    stream, lognormal per-window event counts."""
    h, w = sensor_hw
    n_hot = 6
    S_, B_, E_ = steps, batch, e_per_bin
    burst = np.clip(rng.lognormal(-0.3, 0.6, (S_, B_)), 0.05, 1.0)
    n_valid = np.maximum((E_ * burst).astype(np.int32), 256)

    cx0 = rng.uniform(0, w, (B_, n_hot))
    cy0 = rng.uniform(0, h, (B_, n_hot))
    vx = rng.uniform(-40, 40, (B_, n_hot))
    vy = rng.uniform(-20, 20, (B_, n_hot))
    sig = rng.uniform(4, max(h, w) / 12, (B_, n_hot))
    t_idx = np.arange(S_)[:, None, None]
    cx = np.clip(cx0[None] + vx[None] * 0.01 * t_idx, 0, w - 1)
    cy = np.clip(cy0[None] + vy[None] * 0.01 * t_idx, 0, h - 1)

    k = rng.integers(0, n_hot, (S_, B_, E_))
    hx = np.take_along_axis(cx, k, axis=2)
    hy = np.take_along_axis(cy, k, axis=2)
    hs = np.take_along_axis(np.broadcast_to(sig[None], (S_, B_, n_hot)),
                            k, axis=2)
    x = hx + rng.normal(0, 1, (S_, B_, E_)) * hs
    y = hy + rng.normal(0, 1, (S_, B_, E_)) * hs
    bg = rng.random((S_, B_, E_)) < 0.3
    x = np.where(bg, rng.uniform(0, w, (S_, B_, E_)), x)
    y = np.where(bg, rng.uniform(0, h, (S_, B_, E_)), y)

    ev = np.zeros((S_, B_, E_, 4), np.float32)
    ev[..., 0] = np.clip(x, 0, w - 1)
    ev[..., 1] = np.clip(y, 0, h - 1)
    ev[..., 2] = np.sort(rng.uniform(0, 1, (S_, B_, E_)), axis=2)
    ev[..., 3] = rng.integers(0, 2, (S_, B_, E_))
    return ev, n_valid
