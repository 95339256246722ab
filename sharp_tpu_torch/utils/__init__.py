# the JAX package's threefry helpers seed_to_key and member_key have no
# counterpart: the port seeds torch.Generator streams (utils/prng.py)
from sharp_tpu_torch.utils.timers import StageTimer, log

__all__ = ["StageTimer", "log"]
