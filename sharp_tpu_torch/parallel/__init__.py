from sharp_tpu_torch.parallel.mesh import make_mesh
from sharp_tpu_torch.parallel.sharded import process_folds_sharded

__all__ = ["make_mesh", "process_folds_sharded"]
