"""Architecture registry of the port: importing this package registers
every config of ``repro.configs``, each a copy the port runs: the dense,
sliding-window, recurrent, state-space, vision, audio, latent-attention
and mixture-of-experts archs."""
from repro_torch.configs.base import (ArchConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, RGLRUConfig, SSMConfig,
                                      get_config, list_archs)

from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b, gemma3_27b, granite_34b, llama32_vision_11b,
    mamba2_1p3b, moonshot_v1_16b_a3b, musicgen_medium, qwen3_32b,
    recurrentgemma_2b, stablelm_3b,
)
