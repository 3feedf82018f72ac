"""Architecture registry of the port: importing this package registers
the configs the port runs (the G-only dense archs; the other families of
``repro.configs`` wait for their layer kinds, ROADMAP A12)."""
from repro_torch.configs.base import (ArchConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, RGLRUConfig, SSMConfig,
                                      get_config, list_archs)

from repro_torch.configs import (  # noqa: F401
    granite_34b, qwen3_32b, stablelm_3b,
)
