"""The check of a served TAF detector (the serve_closed driver): the timed
path's outputs against the plain reference, once the window has closed.

During the window the recorder keeps, at a few steps drawn from the seed,
the detector's input volume of a sample of streams and the head maps and
host-read boxes of every stream. Afterwards the reference makes the
weights again from the configuration's seed, builds the detector of the
configuration's family (reference/<family>.py), replays the TAF queue of
every stream over every step the state went through (in blocks of
streams), and compares:

- state_gap: the largest |program - reference| of the queue after the
  last step, over every stream (f32 state);
- volume_gap: the largest |program - reference| of the detector input at
  the captured steps, sampled streams;
- head_gap: the relative L2 error, ||program - reference|| / ||reference||
  over every head output (all levels and channels) of the sampled
  streams, against the f32 detector run on the reference's own volume;
  the worst captured step;
- post_mismatch: the kept boxes that differ from the reference's decode,
  top-K and NMS run on the program's own head maps (every stream,
  captured steps; bit for bit, so the limit is 0);
- kernel_shortfall: on the card, the window's steps that a kernel the
  cell names did not launch in (limit 0).
"""

from __future__ import annotations

import math

import torch

from evd_bench import weights
from evd_bench.reference import post, taf


class Recorder:
    """Keeps what the check compares at the steps `steps`; hooks on the
    system's detector module take its input (rows `streams`) and its
    head maps while a captured step runs."""

    def __init__(self, model, steps, streams):
        self.steps = sorted(set(int(s) for s in steps))
        self.streams = streams
        self.records = {}
        self._now = None
        self._forget = False
        self._hooks = [
            model.register_forward_pre_hook(self._pre),
            model.register_forward_hook(self._post)]

    def _pre(self, module, args):
        if self._now is not None:
            self.records[self._now] = {
                "vol": args[0].index_select(0, self.streams).clone()}

    def _post(self, module, args, out):
        if self._now is not None:
            self.records[self._now]["heads"] = list(out)

    def begin(self, step: int):
        self._now = step if step in self.steps else None

    def rehearse(self, step: int):
        """Capture `step` as a sampled step is captured, and forget it at
        its end: the driver's warm-up runs this, so that what the capture
        launches is loaded before the window."""
        self._now, self._forget = step, True

    def end(self, step: int, dets, keep):
        if self._now is not None and self._forget:
            self.records.pop(step, None)
        elif self._now is not None:
            self.records[step].update(dets=dets, keep=keep)
        self._now, self._forget = None, False

    def done(self) -> bool:
        return all(s in self.records for s in self.steps)

    def close(self):
        for h in self._hooks:
            h.remove()


def draw(seed: int, chk: dict, batch: int):
    """The captured steps and the sampled streams of a run, from its
    seed."""
    gen = weights.generator(seed, 3, "cpu")
    lo, hi = chk["steps_from"], chk["steps_to"]
    steps = (lo + torch.randperm(hi - lo, generator=gen)[:chk["steps"]])
    streams = torch.randperm(batch, generator=gen)[:chk["streams"]]
    return steps.tolist(), streams.sort().values


def recorder(ctx, system, batch: int) -> Recorder:
    """The recorder of a run of ctx's cell over `system`."""
    steps, streams = draw(ctx.seed, ctx.cell["check"], batch)
    return Recorder(system.model, steps, streams.to(ctx.device))


def _gap(a, b) -> float:
    d = (a.float() - b.float()).abs().nan_to_num(nan=math.inf)
    return float(d.max()) if d.numel() else 0.0


class _HeadError:
    """Sums of squares of the error and of the reference over every head
    output of the sampled streams, a captured step each."""

    def __init__(self):
        self.err, self.ref = {}, {}

    def add(self, step, prog_levels, ref_levels):
        for p, r in zip(prog_levels, ref_levels):
            d = (p.float() - r).nan_to_num(nan=math.inf)
            self.err[step] = self.err.get(step, 0.0) + float((d * d).sum())
            self.ref[step] = self.ref.get(step, 0.0) + float((r * r).sum())

    def worst(self) -> float:
        return max((math.sqrt(self.err[k] / max(self.ref[k], 1e-30))
                    for k in self.err), default=0.0)


def compare(ctx, window) -> dict:
    """The readings of one run; window["state"] is the system's queue
    after window["steps_run"] steps from a fresh one."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return _compare(ctx, window)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _compare(ctx, window):
    cfg, device, rec = ctx.cfg, ctx.device, window["recorder"]
    pool, state = window["pool"], window.pop("state")
    K, (H, W) = cfg["K"], cfg["sensor_hw"]
    layout, C = cfg["layout"], 2 * cfg["K"]
    B, block = pool.xytp.shape[1], ctx.cell["check"]["block"]
    family = ctx.bench.code("reference", cfg["model"]["family"])
    params = weights.make_params(family.param_spec(cfg["model"]),
                                 cfg["weights_seed"], device)
    net = family.Net(params, cfg["model"])
    heads = _HeadError()
    streams = rec.streams.tolist()
    state_gap = volume_gap = 0.0
    for lo in range(0, B, block):
        rows = slice(lo, min(lo + block, B))
        b = rows.stop - rows.start
        mine = [i for i, s in enumerate(streams) if rows.start <= s
                < rows.stop]
        local = torch.tensor([streams[i] - lo for i in mine],
                             dtype=torch.long, device=device)
        q = taf.new_queue(b, H, W, K, device=device)
        for step in range(window["steps_run"]):
            xytp, n_valid = pool.window(step)
            q = taf.queue_step(q, xytp[rows], n_valid[rows])
            got = rec.records.get(step)
            if got is None or not mine:
                continue
            vol = taf.resize(taf.volume(q.index_select(0, local)), (H, W),
                             cfg["input_hw"])
            volume_gap = max(volume_gap, _gap(got["vol"][mine],
                                              taf.to_layout(vol, layout)))
            heads.add(step, [h[rec.streams[mine].to(h.device)]
                             for h in got["heads"]], net(vol))
        prog = taf.from_layout(state[rows], layout, C)
        state_gap = max(state_gap, _gap(prog, q.reshape(b, H, W, C)))
    mismatch = 0
    for step, got in rec.records.items():
        dets, keep = post.detections([h.float() for h in got["heads"]],
                                     cfg["post"], cfg["model"]["strides"])
        dets, keep = dets.cpu(), keep.cpu()
        p_dets, p_keep = got["dets"].float(), got["keep"]
        both = keep & p_keep
        mismatch += int((keep != p_keep).sum()) + int(
            (both & ((dets != p_dets).any(-1))).sum())
    shortfall = 0
    if device.type == "cuda":
        shortfall = sum(max(0, window["steps"] - n)
                        for n in window["launches"].values())
    return {"state_gap": state_gap, "volume_gap": volume_gap,
            "head_gap": heads.worst(), "post_mismatch": mismatch,
            "kernel_shortfall": shortfall}
