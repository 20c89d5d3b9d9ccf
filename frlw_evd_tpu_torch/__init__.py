"""PyTorch + CUDA port of the frlw_evd_tpu event-camera detection stack.

The package mirrors the JAX package's module layout (`encode/`, `models/`,
`train/`, `utils/`) so each port module sits at the same relative path as
its reference. It imports torch only: never jax, and nothing of
`frlw_evd_tpu`.

Hand-written Hopper kernels live in `csrc/*.cu`; they are compiled with
nvcc for sm_90a at first use (`kernels/_build.py`) and bound with ctypes.
Every kernel wrapper runs its plain-PyTorch twin for CPU tensors and
launches the kernel (or raises) for CUDA tensors.

Entry points: the GEN1 and 1 Mpx TAF-K8 → AED serving paths,
`pipeline.py`; the AED SimOTA training step, `train/`; data-parallel
training and the H-sharded TAF steps, `parallel/`; the exported serving
step, `tools/export_model.py`. Importing the package registers its
torch.library operators (`ops.py`), which a loaded `.pt2` calls.
"""

from . import ops  # noqa: F401  (registers frlw_evd_torch::int8_conv2d, bn_act)

__all__ = ["encode", "models", "ops", "parallel", "pipeline", "train",
           "utils", "weights"]
