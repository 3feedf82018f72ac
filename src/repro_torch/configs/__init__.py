"""Architecture registry of the port: importing this package registers
the configs the port runs (the dense, sliding-window, recurrent,
state-space, vision and audio archs; the MoE/MLA families of
``repro.configs`` wait for their layer kinds, ROADMAP A12)."""
from repro_torch.configs.base import (ArchConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, RGLRUConfig, SSMConfig,
                                      get_config, list_archs)

from repro_torch.configs import (  # noqa: F401
    gemma3_27b, granite_34b, llama32_vision_11b, mamba2_1p3b,
    musicgen_medium, qwen3_32b, recurrentgemma_2b, stablelm_3b,
)
