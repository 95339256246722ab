from sharp_tpu_torch.ops.rp import ternary_rp_matrix, rp_project, rp_project_ensemble
from sharp_tpu_torch.ops.distance import pearson_distance, standardize_rows

__all__ = [
    "ternary_rp_matrix",
    "rp_project",
    "rp_project_ensemble",
    "pearson_distance",
    "standardize_rows",
]
