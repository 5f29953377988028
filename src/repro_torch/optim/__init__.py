from repro_torch.optim.adamw import (AdamState, OptConfig, adamw_update,
                                     global_norm, init_adam_state,
                                     lr_schedule, opt_path_desc)

__all__ = ["AdamState", "OptConfig", "adamw_update", "global_norm",
           "init_adam_state", "lr_schedule", "opt_path_desc"]
