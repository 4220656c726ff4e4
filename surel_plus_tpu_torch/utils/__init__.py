from surel_plus_tpu_torch.utils.logger import ResultLogger, set_up_log
from surel_plus_tpu_torch.utils.seeding import set_random_seed

__all__ = ["ResultLogger", "set_up_log", "set_random_seed"]
