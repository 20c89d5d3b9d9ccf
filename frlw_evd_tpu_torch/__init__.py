"""PyTorch + CUDA port of the frlw_evd_tpu event-camera detection stack.

The package mirrors the JAX package's module layout (`encode/`, `models/`)
so each port module sits at the same relative path as its reference. It
imports torch only: never jax, and nothing of `frlw_evd_tpu`.

Hand-written Hopper kernels live in `csrc/*.cu`; they are compiled with
nvcc for sm_90a at first use (`kernels/_build.py`) and bound with ctypes.
Every kernel wrapper runs its plain-PyTorch twin for CPU tensors and
launches the kernel (or raises) for CUDA tensors.

Entry point of the GEN1 TAF-K8 → AED serving path: `pipeline.py`.
"""

__all__ = ["encode", "models", "pipeline", "weights"]
