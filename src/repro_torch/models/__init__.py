from .model import (ModelConfig, abstract_params, init_params, forward,
                    loss_fn, param_count, active_param_count,
                    params_from_numpy)

__all__ = ["ModelConfig", "abstract_params", "init_params", "forward",
           "loss_fn", "param_count", "active_param_count",
           "params_from_numpy"]
