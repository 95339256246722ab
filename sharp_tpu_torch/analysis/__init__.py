from sharp_tpu_torch.analysis.ari import ari, rand_metrics

__all__ = ["ari", "rand_metrics"]
