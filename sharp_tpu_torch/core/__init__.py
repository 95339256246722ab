from sharp_tpu_torch.core.wmetac import wmetac
from sharp_tpu_torch.core.block import cluster_block_ensemble

__all__ = ["wmetac", "cluster_block_ensemble"]
