"""Ablations of the int8 conv (csrc/int8_conv.cu) on one GPU: where its
time goes.

    python -m frlw_evd_tpu_torch.kernels.int8_probe     # repository root

Builds csrc/int8_conv.cu four times into build/probes/int8/ (all nvcc at
once), each with one part switched off by an edit of its source text
(`VARIANTS`; tests/test_torch_port_int8_plan.py checks that every edit
still applies):
  base         the kernel as the library builds it;
  no_epilogue  no output stored (the sums are computed and dropped);
  no_quantize  the activation's bf16 bits stored in place of its codes;
  no_loads     no activation read (zero-filled copies, zero halo).
At GEN1 site shapes (B = 128, `SHAPES`) it times each variant with CUDA
events around 10 launches queued behind a sleep (the device alone),
variants in turns, and prints one line a shape and a JSON line. Only
`base` computes the conv; the others' outputs are not checked.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from . import _build
from ..models import quantize as q

PROBE_DIR = _build.BUILD_DIR.parent / "probes" / "int8"
VARIANTS = {
    "base": (),
    "no_epilogue": (
        ("int lane, uint8_t* scratch) {\n",
         "int lane, uint8_t* scratch) {\n  if (p.N > 0) return;\n"),),
    "no_quantize": (
        ("quantize8(raw[0], p.inv, p.hi2, p.lo2)",
         "make_uint2(raw[0].x, raw[0].y)"),
        ("quantize8(raw[1], p.inv, p.hi2, p.lo2)",
         "make_uint2(raw[1].x, raw[1].y)"),
        ("quantize8(raw[u][0], p.inv, p.hi2, p.lo2)",
         "make_uint2(raw[u][0].x, raw[u][0].y)"),
        ("quantize8(raw[u][1], p.inv, p.hi2, p.lo2)",
         "make_uint2(raw[u][1].x, raw[u][1].y)")),
    "no_loads": (
        ("const int bytes = ok ? 16 : 0;", "const int bytes = 0;"),
        ("if (pos < p.Ph && n < p.N && yi >= 0",
         "if (p.N < 0 && pos < p.Ph && n < p.N && yi >= 0")),
}
# (k, stride, Cin, Cout, H, W) of GEN1 sites: 1x1 (general kernel), 3x3
# stride 1 (halo), 3x3 stride 2 with Cin 64 (general kernel)
SHAPES = ((1, 1, 256, 256, 32, 40), (1, 1, 512, 128, 32, 40),
          (1, 1, 128, 64, 64, 80), (1, 1, 256, 256, 8, 10),
          (3, 1, 256, 256, 32, 40), (3, 1, 256, 256, 8, 10),
          (3, 2, 64, 128, 128, 160))
B = 128


def variant_source(name: str) -> str:
    """csrc/int8_conv.cu with variant `name`'s edits; raises if an edit
    does not apply exactly once."""
    text = (_build.CSRC / "int8_conv.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"int8 probe {name}: {old!r} found "
                             f"{text.count(old)} times in int8_conv.cu")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    procs = {}
    for name in VARIANTS:
        d = PROBE_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "int8_conv.cu").write_text(variant_source(name))
        shutil.copy(_build.CSRC / "wgmma_s8.cuh", d / "wgmma_s8.cuh")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "int8_conv.cu"), *_build.EXTRA_FLAGS["int8_conv"]]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"int8 probe build {name} failed:\n{out}")
        fn = ctypes.CDLL(str(PROBE_DIR / name / "lib.so")).int8_conv2d
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 17
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_device_ms(fn, n: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)       # the n launches queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int8_probe needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    entries = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    inv = q._f32(127.0 / 3.0)
    rows = []
    for k, s, cin, cout, h, w in SHAPES:
        x = torch.randn(B, cin, h, w, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wq = torch.randint(-127, 128, (cout, k, k, cin), device="cuda",
                           generator=g, dtype=torch.int8)
        scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        plan = q.tile_plan(B, h, w, cin, cout, k, s)
        ho, wo = q._out_size(h, k, s), q._out_size(w, k, s)
        out = torch.empty(B, ho, wo, cout, dtype=torch.bfloat16,
                          device="cuda")
        wmap = q.weight_map(wq, plan.slab)
        ints = (B, h, w, cin, cout, k, s, q._f32_bits(inv),
                q.clamp_bits(inv), plan.bm, plan.bn, plan.stages, plan.smem,
                plan.grid, plan.producers, plan.slab if plan.halo else 0,
                int(plan.pingpong))
        ms = {}
        for name in (*entries, *reversed(entries)):   # in turns
            fn = entries[name]

            def launch():
                _build.check(fn(x.data_ptr(), scale.data_ptr(), None,
                                out.data_ptr(), None, wmap.data_ptr(),
                                *ints,
                                torch.cuda.current_stream().cuda_stream),
                             f"int8 probe {name}")
            ms.setdefault(name, []).append(time_device_ms(launch))
        kind = "halo" if plan.halo else "general"
        print(f"k{k} s{s} {cin}->{cout} {h}x{w} ({kind}): " + ", ".join(
            f"{name} {v[0]:.4f} / {v[1]:.4f} ms" for name, v in ms.items()),
            flush=True)
        rows.append(dict(k=k, stride=s, cin=cin, cout=cout, hw=[h, w],
                         kernel=kind, ms=ms))
        del x, out
        torch.cuda.empty_cache()
    print(json.dumps({"int8_probe": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
