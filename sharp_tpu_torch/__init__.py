"""sharp_tpu_torch — the SHARP clustering engine on PyTorch and CUDA.

A port of `sharp_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays beside it as the reference. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package become CUDA kernels written
by hand for Hopper (`csrc/`), built by `nvcc` at first use.

    sharp(X, ..., device="cuda")        ~ SHARP()
    run_mtimes(...)                     ~ run_Mtimes_SHARP
    sharp_unlimited(blocks, ...)        ~ SHARP_unlimited (blocks in memory or SBLK files)
    get_opt_hclust(...), gethclust(...) ~ get_opt_hclust, gethclust
    ari(truth, pred)                    ~ ARI
    get_marker_genes(...)               ~ get_marker_genes (and _unlimited2)
    get_percluster_exp(...)             ~ get_percluster_exp
    visualization_embedding(...)        ~ visualization_SHARP (embedding part)

and `python -m sharp_tpu_torch {cluster,unlimited,markers,embed}`. Every
entry point that computes takes `device` (default "cuda"; raises without
a card).

The port imports nothing of JAX and nothing of the JAX package: it keeps
its own copies of the numpy-only modules it needs (`config`, `types`,
`analysis/ari`, `analysis/percluster`, `io/rdata`, ...). matplotlib is
imported only inside the plot functions.

Float32 matrix products must be full float32 (`ops/distance.py`): TF32 is
turned off for matmuls and cuDNN here, on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_LAZY = {
    "SharpConfig": ("sharp_tpu_torch.config", "SharpConfig"),
    "resolve_config": ("sharp_tpu_torch.config", "resolve_config"),
    "sharp": ("sharp_tpu_torch.api", "sharp"),
    "sharp_unlimited": ("sharp_tpu_torch.api", "sharp_unlimited"),
    "run_mtimes": ("sharp_tpu_torch.api", "run_mtimes"),
    "summarize_mtimes": ("sharp_tpu_torch.api", "summarize_mtimes"),
    "ari": ("sharp_tpu_torch.analysis.ari", "ari"),
    "get_marker_genes": ("sharp_tpu_torch.analysis.markers", "get_marker_genes"),
    "get_marker_genes_unlimited2": (
        "sharp_tpu_torch.analysis.markers", "get_marker_genes_unlimited2"
    ),
    "get_percluster_exp": ("sharp_tpu_torch.analysis.percluster", "get_percluster_exp"),
    "visualization_embedding": ("sharp_tpu_torch.analysis.embed", "visualization_embedding"),
    "get_opt_hclust": ("sharp_tpu_torch.ops.select", "get_opt_hclust"),
    "gethclust": ("sharp_tpu_torch.ops.select", "gethclust"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'sharp_tpu_torch' has no attribute {name!r}")


__all__ = list(_LAZY)
