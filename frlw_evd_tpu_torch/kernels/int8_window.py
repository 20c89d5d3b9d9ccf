"""The int8 conv's GEN1 window on one GPU, timed two ways: for holding two
trees of the repository against each other in turns.

    python3 frlw_evd_tpu_torch/kernels/int8_window.py [--root DIR]

Imports frlw_evd_tpu_torch from DIR (default: the checkout that holds this
file), so its kernels build under DIR/build/; run it once a tree, in turns,
in one call. At each int8 site shape of the GEN1 AED (stem bfm, 2 classes,
a 256x320 input of 16 channels) at B = 128 it makes an Int8Site of random
codes, as the serving path does, holds its output to the twin
(int8_conv2d_plain) bit for bit, and times 10 launches with CUDA events:
  device  queued behind a sleep of ~10 ms on the card, so that the events
          time the device alone (chip_smoke.py's time_ms);
  back    back to back after a sync, no sleep: where the host takes longer
          to launch a site than the card to run it, the host's time.
cuDNN's bf16 conv of each site is timed the same two ways. Prints one line
a shape, the per-window sums (61 sites) and a JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

B, INPUT = 128, (256, 320, 16)


def time_ms(fn, queued: bool, n: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def site_shapes(quantize, build_detector) -> Counter:
    """{(k, stride, Cin, Cout, H, W): sites} of the GEN1 AED's int8 sites,
    from one forward of a zero input on the CPU under hooks."""
    model = build_detector(2, stem="bfm",
                           generator=torch.Generator().manual_seed(0))
    shapes = Counter()

    def record(conv):
        def hook(_module, args):
            shapes[(conv.kernel_size[0], conv.stride[0], conv.in_channels,
                    conv.out_channels, *args[0].shape[2:])] += 1
        return hook
    handles = [m.register_forward_pre_hook(record(m))
               for m in quantize.eligible_sites(model).values()]
    with torch.inference_mode():
        model(torch.zeros(1, *INPUT))
    for h in handles:
        h.remove()
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("int8_window needs a CUDA device")
    sys.path[0] = str(root)     # this tree's package, not the script's
    from frlw_evd_tpu_torch.models import build_detector, quantize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{root} on {card}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    sx = 3.0 / 127.0
    totals, rows = Counter(), []
    for (k, s, cin, cout, h, w), n in sorted(
            site_shapes(quantize, build_detector).items()):
        x = torch.randn(B, cin, h, w, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        q = torch.randint(-127, 128, (cout, cin, k, k), device="cuda",
                          generator=g, dtype=torch.int8)
        sw = torch.rand(cout, device="cuda", generator=g) * 1e-3
        site = quantize.Int8Site(q, sw, sx, s)
        if not torch.equal(site(x), quantize.int8_conv2d_plain(
                x, site.wq, site.scale, site.inv, stride=s)):
            raise SystemExit(f"k{k} s{s} {cin}->{cout} {h}x{w}: the site "
                             f"differs from the twin")
        w_bf = torch.randn(cout, cin, k, k, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def cudnn():
            return torch.nn.functional.conv2d(x, w_bf, stride=s,
                                              padding=(k - 1) // 2)
        row = dict(k=k, stride=s, cin=cin, cout=cout, hw=[h, w], sites=n)
        for how, queued in (("device", True), ("back", False)):
            row[how] = time_ms(lambda: site(x), queued)
            row[f"cudnn_{how}"] = time_ms(cudnn, queued)
        for key in ("device", "back", "cudnn_device", "cudnn_back"):
            totals[key] += n * row[key]
            if k == 1:
                totals[f"{key}_1x1"] += n * row[key]
        print(f"k{k} s{s} {cin}->{cout} {h}x{w} (x{n}): device "
              f"{row['device']:.4f} ms, back to back {row['back']:.4f}; "
              f"cuDNN bf16 {row['cudnn_device']:.4f} / "
              f"{row['cudnn_back']:.4f}; outputs bitwise", flush=True)
        rows.append(row)
        del x, site, w_bf
        torch.cuda.empty_cache()
    print(f"per window ({sum(r['sites'] for r in rows)} sites): device "
          f"{totals['device']:.3f} ms, back to back {totals['back']:.3f}; "
          f"1x1 sites {totals['device_1x1']:.3f} / {totals['back_1x1']:.3f}; "
          f"cuDNN bf16 {totals['cudnn_device']:.3f} / "
          f"{totals['cudnn_back']:.3f}", flush=True)
    print(json.dumps({"int8_window": dict(totals), "root": str(root),
                      "card": card, "sites": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
