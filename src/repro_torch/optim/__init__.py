"""The optimizer on torch (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (OptConfig, adamw_update, init_opt_state,
                                     learning_rate)

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "learning_rate"]
