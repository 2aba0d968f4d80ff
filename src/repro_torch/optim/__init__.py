from .adamw import (OptConfig, init_opt_state, lr_at_step,
                    opt_state_from_numpy, opt_state_to_numpy, opt_update)

__all__ = ["OptConfig", "init_opt_state", "opt_update", "lr_at_step",
           "opt_state_from_numpy", "opt_state_to_numpy"]
