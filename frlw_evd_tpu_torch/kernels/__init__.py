"""Build and load the port's hand-written CUDA kernels (see `_build.py`)."""
