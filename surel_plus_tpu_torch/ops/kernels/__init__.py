"""Hand-written CUDA kernels (sources in `surel_plus_tpu_torch/csrc/`)
with their plain PyTorch versions. Nothing here builds or loads a kernel
at import time."""
