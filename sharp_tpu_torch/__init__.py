"""sharp_tpu_torch — the SHARP clustering engine on PyTorch and CUDA.

A port of `sharp_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package become CUDA kernels written
by hand for Hopper (`csrc/`), built by `nvcc` at first use.

    sharp(X, ..., device="cuda")   ~ SHARP()
    run_mtimes(...)                ~ run_Mtimes_SHARP
    sharp_unlimited(blocks, ...)   ~ SHARP_unlimited (blocks in memory or SBLK files)
    get_opt_hclust(...)            ~ get_opt_hclust

The port imports nothing of JAX and nothing of the JAX package: it keeps
its own copies of the numpy-only modules it needs (`config`, `types`,
`analysis/ari`).

Float32 matrix products must be full float32 (`ops/distance.py`): TF32 is
turned off for matmuls and cuDNN here, on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_LAZY = {
    "sharp": ("sharp_tpu_torch.api", "sharp"),
    "sharp_unlimited": ("sharp_tpu_torch.api", "sharp_unlimited"),
    "run_mtimes": ("sharp_tpu_torch.api", "run_mtimes"),
    "summarize_mtimes": ("sharp_tpu_torch.api", "summarize_mtimes"),
    "get_opt_hclust": ("sharp_tpu_torch.ops.select", "get_opt_hclust"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sharp_tpu_torch' has no attribute {name!r}")


__all__ = list(_LAZY)
