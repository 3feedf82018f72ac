"""mamba2-1.3b [ssm]: 48L, d=2048, attention-free, v=50280, state=128.

SSD (state-space duality) blocks: expand=2 (d_inner=4096), head_dim=64
(64 heads), n_groups=1, conv_width=4.  [arXiv:2405.21060; unverified]

The port's copy of ``repro.configs.mamba2_1p3b``.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280,
    layer_pattern=("D",),
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, conv_width=4,
                  expand=2, chunk=256),
    tie_embeddings=True,
    supports_long_context=True,   # O(1) recurrent state
)

SMOKE = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=256,
    layer_pattern=("D",),
    ssm=SSMConfig(state_dim=16, head_dim=16, n_groups=1, conv_width=4,
                  expand=2, chunk=32),
    tie_embeddings=True, supports_long_context=True, attn_chunk=32,
)

register(FULL, SMOKE)
