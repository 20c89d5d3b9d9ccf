"""The check of a served recurrent detector (RED, the serve_closed driver):
the timed path's outputs against the plain reference, once the window has
closed.

During the window the recorder keeps, at a few steps drawn from the seed,
the detector's input volume and its memory before and after the step for
a sample of streams, and the head outputs and host-read boxes of every
stream. Afterwards the reference makes the weights again from the
configuration's seed, replays the TAF queue of every stream over every
step the state went through (in blocks of streams), and, for the sampled
streams, rolls RED forward in f32 from the window's fresh state (zero
memory) through every step up to the last captured one, on its own
volumes and its own memory (in blocks of streams). It compares:

- state_gap, volume_gap, kernel_shortfall: as checks/aed_serve.py (the
  queue after the last step, every stream; the detector input at the
  captured steps; the steps in which a kernel the cell names did not
  launch);
- memory_gap: the relative L2 error over one level's h and c, before
  and after each captured step, ||program - reference|| / ||reference||;
  the worst level at the worst captured step. Each level is its own
  share: the stride-32 level holds 160 times the values of the stride-512
  one, so a sum over all levels would not see a fault in the deepest;
- head_gap: the relative L2 error over the class logits and box
  regressions of the sampled streams, against the reference's forward on
  its own memory and volume; the worst captured step;
- post_mismatch: the kept boxes that differ from the reference's decode,
  top-K and NMS run on the program's own head outputs (every stream,
  captured steps; bit for bit, so the limit is 0).
"""

from __future__ import annotations

import torch

from evd_bench import weights
from evd_bench.reference import red, taf


def _rows(memory, streams):
    return tuple((h.index_select(0, streams).clone(),
                  c.index_select(0, streams).clone()) for h, c in memory)


def _pre(self, module, args):
    if self._now is not None:
        memory, vol = args
        self.records[self._now] = {
            "vol": vol.index_select(0, self.streams).clone(),
            "memory_in": _rows(memory, self.streams)}


def _post(self, module, args, out):
    if self._now is not None:
        memory, heads = out
        self.records[self._now].update(
            memory_out=_rows(memory, self.streams),
            heads=[h.clone() for h in heads])


def recorder(ctx, system, batch: int):
    """The recorder of a run of ctx's cell over `system`: aed_serve's, its
    hooks taking the detector's memory and input (rows `streams`) before a
    captured step runs and its memory and head outputs after (the module
    is called as model(memory, volume))."""
    aed = ctx.bench.code("checks", "aed_serve")
    steps, streams = aed.draw(ctx.seed, ctx.cell["check"], batch)
    cls = type("Recorder", (aed.Recorder,), {"_pre": _pre, "_post": _post})
    return cls(system.model, steps, streams.to(ctx.device))


def compare(ctx, window) -> dict:
    """The readings of one run; window["state"] is the system's state (its
    queue `queue`) after window["steps_run"] steps from a fresh one."""
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
    aed = ctx.bench.code("checks", "aed_serve")
    cfg, device, rec = ctx.cfg, ctx.device, window["recorder"]
    pool, state = window["pool"], window.pop("state")
    queue = getattr(state, "queue", state)
    K, (H, W), hw = cfg["K"], cfg["sensor_hw"], cfg["input_hw"]
    layout, C = cfg["layout"], 2 * cfg["K"]
    B, block = pool.xytp.shape[1], ctx.cell["check"]["block"]
    state_gap = 0.0
    for lo in range(0, B, block):
        rows = slice(lo, min(lo + block, B))
        q = taf.new_queue(rows.stop - rows.start, H, W, K, device=device)
        for step in range(window["steps_run"]):
            xytp, n_valid = pool.window(step)
            q = taf.queue_step(q, xytp[rows], n_valid[rows])
        prog = taf.from_layout(queue[rows], layout, C)
        state_gap = max(state_gap, aed._gap(prog, q.reshape(q.shape[0], H, W,
                                                            C)))
        del q

    params = weights.make_params(red.param_spec(cfg["model"]),
                                 cfg["weights_seed"], device)
    net = red.Net(params, cfg["model"])
    memory_err = [aed._HeadError() for _ in range(red.LEVELS)]
    head_err = aed._HeadError()
    volume_gap = 0.0
    streams = rec.streams
    last = max(rec.records, default=-1)
    for lo in range(0, len(streams), block):
        sub = streams[lo:lo + block]
        q = taf.new_queue(len(sub), H, W, K, device=device)
        memory = red.zero_memory(len(sub), *hw, device)
        for step in range(last + 1):
            xytp, n_valid = pool.window(step)
            q = taf.queue_step(q, xytp[sub], n_valid[sub])
            vol = taf.resize(taf.volume(q), (H, W), hw)
            before = memory
            memory, heads = net(memory, vol)
            got = rec.records.get(step)
            if got is None:
                continue
            mine = slice(lo, lo + len(sub))
            volume_gap = max(volume_gap, aed._gap(
                got["vol"][mine], taf.to_layout(vol, layout)))
            for level, err in enumerate(memory_err):
                err.add(step, [t[mine] for t in got["memory_in"][level]
                               + got["memory_out"][level]],
                        before[level] + memory[level])
            head_err.add(step, [h.index_select(0, sub.to(h.device))
                                for h in got["heads"]], heads)
    mismatch = 0
    for step, got in rec.records.items():
        dets, keep = red.detections([h.float() for h in got["heads"]],
                                    cfg["post"], *hw)
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
            "memory_gap": max(err.worst() for err in memory_err),
            "head_gap": head_err.worst(),
            "post_mismatch": mismatch, "kernel_shortfall": shortfall}
