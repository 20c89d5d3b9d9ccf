"""Probes of the chain kernels B4 and B7 (csrc/bfm_chain.cu) on one GPU:
where their time goes, and which silu form to keep.

    python -m frlw_evd_tpu_torch.kernels.chain_probe     # repository root

Builds csrc/bfm_chain.cu four times into build/probes/ with the source's
switches (all four nvcc at once) and prints each build's ptxas report:
  ieee     silu as u / (1 + expf(-u)) with IEEE division;
  approx   silu as u * rcp.approx(1 + ex2.approx(-u log2 e));
  no_silu  the activation replaced by the identity (the products, the
           roundings and the bytes, no silu);
  copy     each tile's input words stored in place of the chain (the loads,
           the stores and the tile walk alone).
At the full gen4 shape (B = 128, 512x640 sensor, so H2, W2 = 256, 320) it
holds ieee and approx against the plain twin (max |d|, values beyond atol
1e-2 + rtol 1e-2, the share of outputs that differ at all) and times every
variant through both entries with CUDA events, in turns (each variant,
then all again in reverse order). The library (`_build`) is the approx
form.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from . import _build

VARIANTS = {"ieee": ("-DBFM_CHAIN_SILU_APPROX=0",),
            "approx": ("-DBFM_CHAIN_SILU_APPROX=1",),
            "no_silu": ("-DBFM_CHAIN_PROBE=1",),
            "copy": ("-DBFM_CHAIN_PROBE=2",)}
PROBE_DIR = _build.BUILD_DIR.parent / "probes"


def build_variants() -> dict[str, ctypes.CDLL]:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        so = PROBE_DIR / f"libbfm_chain_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
               str(_build.CSRC / "bfm_chain.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe build {name} failed:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def caller(lib, entry):
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(vol, weights, out, B, H2, W2):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(vol.data_ptr(), weights.data_ptr(), out.data_ptr(),
                        B, H2, W2, stream), entry)
        return out
    return call


def time_ms(fn, n=10, warm=2):
    for _ in range(warm):
        fn()
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
        raise SystemExit("chain_probe needs a CUDA device")
    from ..models import stem_chain
    from ..models.stems import BinsFusionModuleFolded

    libs = build_variants()
    B, H2, W2 = 128, 256, 320
    stem = BinsFusionModuleFolded(16, 64)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for pname, p in stem.chain_params().items():
            p.normal_(0.1 if pname.endswith("bias") else 0.0, 0.3,
                      generator=g)
    params = {k: v.to("cuda", torch.bfloat16)
              for k, v in stem.chain_params().items()}
    weights = stem_chain._pack(stem_chain.chain_weights(params), "cuda")
    gd = torch.Generator(device="cuda").manual_seed(1)
    vol = torch.rand(B, H2, W2 * 64, device="cuda", generator=gd).to(
        torch.bfloat16)
    outs = {64: torch.empty_like(vol),
            48: torch.empty(B, H2, W2 * 48, dtype=torch.bfloat16,
                            device="cuda")}
    entries = {64: "bfm_chain_apply_folded", 48: "bfm_chain_apply"}
    result = {}
    for out_c, entry in entries.items():
        want = (stem_chain.bfm_chain_apply_folded_plain(vol, params, width=W2)
                if out_c == 64 else stem_chain.bfm_chain_apply_plain(
                    vol.view(B, H2, W2, 64), params).view(B, H2, -1)).float()
        for name in ("ieee", "approx"):
            got = caller(libs[name], entry)(vol, weights, outs[out_c], B, H2,
                                            W2).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            bad = int((err > 1e-2 + 1e-2 * want.abs()).sum().item())
            differ = float((got != want).float().mean().item())
            result[f"{entry}/{name}/check"] = dict(
                max_abs_err=err.max().item(), beyond_tol=bad, differ=differ)
            print(f"{entry} {name}: max |d| {err.max().item():.3e}, {bad} "
                  f"beyond atol 1e-2 + rtol 1e-2, {differ:.4%} of outputs "
                  f"differ from the twin", flush=True)
            del got, err
        del want
        order = list(libs)
        ms = {name: [] for name in order}
        for name in order + order[::-1]:
            call = caller(libs[name], entry)
            ms[name].append(time_ms(lambda: call(vol, weights, outs[out_c],
                                                 B, H2, W2)))
        for name, times in ms.items():
            result[f"{entry}/{name}/ms"] = times
            print(f"{entry} {name}: " + " / ".join(f"{t:.3f}" for t in times)
                  + " ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
