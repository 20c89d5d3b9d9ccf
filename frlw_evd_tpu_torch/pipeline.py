"""Streaming TAF-K8 → AED serving paths (counterpart of bench.py's
make_pipeline, make_pipeline_packed, make_pipeline_kernel,
make_pipeline_p64 and _detect_body) and the streaming encoder runner
(bench.py's run_encoder_bench).

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
      unpacked (`make_pipeline`, state (B, H, W, 2, K)): the MXU histogram
      function (kernel B6 on the card), the sorted one or an exact
      index_add_ → the queue update in torch → packed leaky volume →
      nearest resize, or with p64_input four block gathers into the
      patchified input of a `bfm_p64` stem;
      packed (`make_pipeline_packed`, state (B, H, W, 2K)): B1, B6, the
      sorted, MXU or exact histogram → the update in torch → leaky →
      resize;
      recurrent (`make_pipeline_recurrent`, state a `RecurrentState`: the
      folded queue and RED's memory): B1 → B2 as GEN1's, then the resize
      where the input differs from the sensor; passes the volume on with
      the state (`RecurrentInput`);
  detect(vol):
      AED forward in the serving dtype → f32 decode → conf 0.3, top-100,
      NMS 0.6 → (dets (B, 100, 6), keep (B, 100)); with quant=(scales,
      table) the forward runs under models.quantize.int8_ctx, its calibrated
      convs through the int8 kernel (bench.py --dtype int8;
      `calibrate_pipeline` makes the pair from the live encode output);
      recurrent: RED on each stream's memory, which it advances in the
      state → f32 SSD decode → conf 0.01, top-15, NMS 0.45

Each make_pipeline_* function returns `run_step(state, xytp, n_valid) ->
(state, (dets, keep))` with the two stages under `run_step.stages`, as
bench.py's `_attach_stages` does. Entry points run on the card unless the
caller passes device="cpu", which runs the kernels' plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .encode.common import nearest_resize_indices
from .encode.count_image import encode_count_image_batch
from .encode.streaming import (PACKED_SCATTERS, event_frame_stream,
                               event_volume_stream, sae_stream,
                               taf_pack_state, taf_stream_step,
                               taf_stream_step_packed)
from .encode.taf import INIT_VALUE, leaky_transform
from .encode.update import (init_state, p64_init_state,
                            taf_stream_step_kernel,
                            taf_stream_step_kernel_p64)
from .models import red
from .models.detector import EventDetector, eval_decode
from .models.postprocess import postprocess_batch
from .models.quantize import build_weight_table, calibrate_int8, int8_ctx
from .models.stems import BinsFusionModuleFolded
from .utils.profiling import count, span

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


def channels_last_(model: torch.nn.Module) -> torch.nn.Module:
    """Lay each 4-D parameter and buffer of `model` out channels_last, in
    place, and leave the others (model.to(memory_format=...) refuses the
    5-D Conv3d weight of the swin stem's patch embedding)."""
    for t in (*model.parameters(), *model.buffers()):
        if t.dim() == 4:
            t.data = t.data.contiguous(memory_format=torch.channels_last)
    return model


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
        channels_last_(model)
    return dev


def _yolox_decode(outs):
    """The AED's per-level head maps → rows, decoded in f32 (bench.py:170)."""
    return eval_decode([o.float() for o in outs], STRIDES)


_YOLOX_POST = {"max_detections": MAX_DETECTIONS}


def _attach_stages(encode_transform, model, quant=None, *, forward=None,
                   decode=_yolox_decode, post=_YOLOX_POST):
    """run_step with the encode_transform and detect stages; detect runs
    the forward (`forward(vol)`, by default `model(vol)`) under
    int8_ctx(model, *quant) when `quant` is given (bench.py:156-175; the
    context is `run_step.int8`), then `decode` of its outputs and
    postprocess_batch with the settings `post`. The defaults are the
    AED's: its head maps decoded in f32 (bench.py:170), conf 0.3, top-100,
    NMS 0.6."""
    ctx = int8_ctx(model, *(quant or (None, None)))  # no sites: a no-op
    forward = model if forward is None else forward

    def encode(state_f, xytp, n_valid):
        with span("serve.encode", new_step=True):
            return encode_transform(state_f, xytp, n_valid)

    @torch.inference_mode()
    def detect(vol):
        with span("serve.detect"):
            with span("serve.forward"), ctx:
                outs = forward(vol)
            with span("serve.decode"):
                decoded = decode(outs)
            with span("serve.post"):
                return postprocess_batch(decoded, **post)

    def run_step(state_f, xytp, n_valid):
        state_f, vol = encode(state_f, xytp, n_valid)
        return state_f, detect(vol)

    run_step.stages = {"encode_transform": encode, "detect": detect}
    run_step.int8 = ctx
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
    return _attach_stages(_folded_encode(sensor_hw, input_hw, scatter, dev),
                          model, quant)


def _folded_encode(sensor_hw, input_hw, scatter: str, dev):
    """encode_transform(state_f, xytp, n_valid) -> (state_f, vol) on the
    folded queue: taf_stream_step_kernel (precise=False), then the nearest
    resize where input_hw differs from sensor_hw."""
    h, w = sensor_hw
    ys, xs = nearest_resize_indices(sensor_hw, input_hw, dev)

    def encode_transform(state_f, xytp, n_valid):
        state_f, vol = taf_stream_step_kernel(state_f, xytp, n_valid,
                                              height=h, width=w,
                                              scatter=scatter, precise=False)
        if tuple(input_hw) != tuple(sensor_hw):
            vol = nearest_resize(vol, ys, xs)
        return state_f, vol

    return encode_transform


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


class RecurrentState:
    """The state of B streams on a recurrent serving path: the folded TAF
    queue `queue` (B, H, W*2K) f32 and the detector's memory `memory`, a
    tuple of RED's five (h, c) NHWC f32 pairs, or None where every stream
    starts from zero (the port's convention for a None carry). `reset`
    starts chosen streams afresh; `fresh` holds the streams reset since
    the memory last advanced."""

    __slots__ = ("queue", "memory", "fresh")

    def __init__(self, queue: torch.Tensor):
        self.queue, self.memory, self.fresh = queue, None, set()

    def reset(self, streams) -> None:
        """Streams `streams` (indices) start afresh: the queue's rows back
        to -6000 and their memory to zero, the other streams untouched."""
        rows = sorted(set(int(i) for i in streams))
        if not rows:
            return
        idx = torch.tensor(rows, device=self.queue.device)
        self.queue.index_fill_(0, idx, INIT_VALUE)
        if self.memory is not None:
            with torch.inference_mode():
                for pair in self.memory:
                    for t in pair:
                        t.index_fill_(0, idx, 0.0)
            self.fresh.update(rows)


class RecurrentInput(NamedTuple):
    """What a recurrent path's encode stage passes its detect stage: the
    detector's input volume and the state whose memory detect advances."""
    volume: torch.Tensor
    state: RecurrentState


def make_pipeline_recurrent(model: red.REDDetector, sensor_hw, input_hw,
                            scatter: str = "pallas", *, device="cuda",
                            dtype=torch.bfloat16):
    """RED served over B streams, each keeping its memory on the device
    from one window to the next. The state is a `RecurrentState`; a bare
    folded queue (`new_state`) is B fresh streams, whose memory starts at
    zero. encode_transform advances the queue as make_pipeline_kernel's
    does (`scatter` "pallas": B1, then B2, precise=False; the nearest
    resize only where input_hw differs from sensor_hw) and returns (state,
    RecurrentInput(volume, state)). detect runs RED on the stream state's
    memory (f32 carries, as the trainer's; the backbone and head in
    `dtype`, channels_last on the card), stores the new memory in that
    state, so that the next step carries it whichever of run_step or the
    two stages the caller runs, and decodes the SSD outputs in f32
    (red_eval_decode) for postprocess_batch at conf 0.01, NMS 0.45 and 15
    detections (the red eval step's settings). It counts the stream-windows
    whose memory came from the previous window (`memory_carried`) and
    those that started from zero (`memory_fresh`) in the `serve.forward`
    span. No host sync beyond the NMS rounds'."""
    if not isinstance(model, red.REDDetector):
        raise ValueError(f"make_pipeline_recurrent serves a REDDetector, got "
                         f"{type(model).__name__}")
    dev = _serving_model(model, device, dtype)
    H, W = input_hw
    priors = torch.as_tensor(red.build_priors(H, W), device=dev)
    scale = red.pixel_scale(H, W, dev)
    encode_queue = _folded_encode(sensor_hw, input_hw, scatter, dev)

    def encode_transform(state, xytp, n_valid):
        if isinstance(state, torch.Tensor):
            state = RecurrentState(state)
        state.queue, vol = encode_queue(state.queue, xytp, n_valid)
        return state, RecurrentInput(vol, state)

    def forward(inp: RecurrentInput):
        state, n = inp.state, inp.volume.shape[0]
        memory, fresh = state.memory, len(state.fresh)
        if memory is None:
            memory, fresh = model.init_carries(n, H, W, device=dev), n
        count("memory_fresh", fresh)
        count("memory_carried", n - fresh)
        state.memory, outs = model(memory, inp.volume)
        state.fresh.clear()
        return outs

    def decode(outs):
        cls_logits, bbox_pred = outs
        return red.red_eval_decode(cls_logits.float(), bbox_pred.float(),
                                   priors, H, W, scale=scale)

    return _attach_stages(encode_transform, model, forward=forward,
                          decode=decode, post={
                              "conf_threshold": red.CONFIDENCE_THRESHOLD,
                              "nms_threshold": red.NMS_THRESHOLD,
                              "max_detections": red.TOPK})


UNPACKED_SCATTERS = ("mxu", "sorted", "xla")
# the 2x2 blocks of the patchified input, s-major [tl, bl, tr, br]
# (bench.py:316-320): (row, column) offset of each
P64_BLOCKS = ((0, 0), (1, 0), (0, 1), (1, 1))


def make_pipeline(model: EventDetector, sensor_hw, input_hw,
                  scatter: str = "mxu", *, p64_input: bool = False,
                  device="cuda", dtype=torch.bfloat16, quant=None):
    """Unpacked-state serving pipeline (bench.py:279-353), the queue
    (B, H, W, 2, K) f32 updated in place by `taf_stream_step`
    (precise=False) with scatter "mxu" (`scatter_cnt_tsum_mxu`, kernel B6
    on the card), "sorted" or "xla" (exact index_add_); "pallas" is refused,
    as in JAX. The volume is the packed leaky volume / 255 in bf16, then
    the nearest resize to input_hw (indices from f64 products, as
    bench.py:310-311 computes them); with p64_input, four quarter-resolution
    block gathers [tl, bl, tr, br] make the patchified (B, h/2, w/2, 8K)
    input of a `bfm_p64` stem. JAX's `fused` switch chooses how XLA
    compiles the window; eager PyTorch has no counterpart, so it is not
    taken: the stages run as JAX's fused=False does. quant as in
    make_pipeline_kernel."""
    if scatter not in UNPACKED_SCATTERS:
        raise ValueError(f"make_pipeline supports scatter 'mxu', 'sorted' "
                         f"or 'xla' (serial), got {scatter!r}: the pallas "
                         f"formulation needs the packed/kernel/p64 pipeline")
    dev = _serving_model(model, device, dtype)
    ys, xs = nearest_resize_indices(sensor_hw, input_hw, dev, torch.float64)

    def encode_transform(state, xytp, n_valid):
        state = taf_stream_step(state, xytp, n_valid, precise=False,
                                use_sorted=scatter == "sorted",
                                use_mxu=scatter == "mxu")
        vol = (leaky_transform(taf_pack_state(state)) / 255.0).to(
            torch.bfloat16)
        if p64_input:
            return state, torch.cat(
                [nearest_resize(vol, ys[sy::2], xs[sx::2])
                 for sy, sx in P64_BLOCKS], -1)
        if tuple(input_hw) != tuple(sensor_hw):
            vol = nearest_resize(vol, ys, xs)
        return state, vol

    return _attach_stages(encode_transform, model, quant)


def make_pipeline_packed(model: EventDetector, sensor_hw, input_hw,
                         scatter: str = "pallas", *, device="cuda",
                         dtype=torch.bfloat16, quant=None):
    """Packed-state serving pipeline (bench.py:232-251): the queue
    (B, H, W, 2K) f32 in the network channel order, updated in place by
    `taf_stream_step_packed` (precise=False; scatter "pallas" is kernel
    B1, "mxu" kernel B6 on the card, "sorted", "xla"), then leaky / 255 in
    bf16 and the nearest resize to input_hw. quant as in
    make_pipeline_kernel."""
    if scatter not in PACKED_SCATTERS:
        raise ValueError(f"make_pipeline_packed supports scatter "
                         f"{PACKED_SCATTERS}, got {scatter!r}")
    dev = _serving_model(model, device, dtype)
    ys, xs = nearest_resize_indices(sensor_hw, input_hw, dev)

    def encode_transform(state, xytp, n_valid):
        state = taf_stream_step_packed(state, xytp, n_valid,
                                       scatter=scatter, precise=False)
        vol = (leaky_transform(state) / 255.0).to(torch.bfloat16)
        if tuple(input_hw) != tuple(sensor_hw):
            vol = nearest_resize(vol, ys, xs)
        return state, vol

    return _attach_stages(encode_transform, model, quant)


def new_stream_state(batch: int, sensor_hw, layout: str, *,
                     device="cuda") -> torch.Tensor:
    """Fresh TAF-K8 queue filled with -6000 for `make_pipeline` (layout
    "unpacked": (B, H, W, 2, K)) or `make_pipeline_packed` ("packed":
    (B, H, W, 2K))."""
    h, w = sensor_hw
    shapes = {"unpacked": (batch, h, w, 2, K), "packed": (batch, h, w, 2 * K)}
    if layout not in shapes:
        raise ValueError(f"layout must be one of {sorted(shapes)}, got "
                         f"{layout!r}")
    return torch.full(shapes[layout], INIT_VALUE, dtype=torch.float32,
                      device=resolve_device(device))


ENCODERS = ("eci", "frame", "ev", "sae")
WINDOW_US = 10000


def make_encoder_step(kind: str, sensor_hw, *, sae_impl: str = "sorted",
                      device="cuda"):
    """The per-window step of one streaming encoder, as run_encoder_bench
    builds it (bench.py:586-610): `step(state, xytp, n_valid, now) ->
    (out, state)` with xytp (B, E, 4) [x, y, t (µs), p] on `device`, now
    the window's end in µs, state None at the first window and carried on
    the device after it. kind: "eci" (count image, stateless), "frame"
    (occupancy, stateless), "ev" (incremental event volume, 5 bins) or
    "sae" (`sae_impl` "sorted" or "max")."""
    if kind not in ENCODERS:
        raise ValueError(f"kind must be one of {ENCODERS}, got {kind!r}")
    dev = resolve_device(device)
    h, w = sensor_hw
    encoders = {
        "eci": lambda state, ev, nv, now: (encode_count_image_batch(
            ev[..., :4], nv, height=h, width=w), None),
        "frame": lambda state, ev, nv, now: event_frame_stream(
            ev, nv, None, height=h, width=w),
        "ev": lambda state, ev, nv, now: event_volume_stream(
            ev, nv, state, now, height=h, width=w, bins=5),
        "sae": lambda state, ev, nv, now: sae_stream(
            ev, nv, state, now, height=h, width=w, impl=sae_impl),
    }
    encode = encoders[kind]

    def step(state, xytp, n_valid, now):
        if xytp.device.type != dev.type or n_valid.device.type != dev.type:
            raise ValueError(f"make_encoder_step({kind!r}) runs on {dev}; "
                             f"got inputs on {xytp.device}, "
                             f"{n_valid.device}")
        return encode(state, xytp, n_valid, now)

    return step


def encoder_events(events: np.ndarray) -> np.ndarray:
    """Synthetic windows with real µs timestamps, as run_encoder_bench
    makes them (bench.py:582-585): window i spans [i*10 ms, (i+1)*10 ms).
    events: (steps, B, E, 4) with t in [0, 1] (synth_events); returns a
    copy."""
    out = np.array(events)
    for i in range(out.shape[0]):
        out[i, ..., 2] = (i + out[i, ..., 2]) * float(WINDOW_US)
    return out


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
