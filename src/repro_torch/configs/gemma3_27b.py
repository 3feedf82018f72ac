"""gemma3-27b [dense]: 62L, d=5376, 32H (GQA kv=16), d_ff=21504, v=262144.

5:1 local:global attention interleave, 1024-token sliding window on local
layers, separate RoPE base for global layers (128k-context recipe).
head_dim is not derivable from d_model/n_heads in gemma3; the published
model uses 128.  [hf:google/gemma-3-1b-pt; unverified]

The port's copy of ``repro.configs.gemma3_27b``.
"""
from repro_torch.configs.base import ArchConfig, register

PATTERN = ("L", "L", "L", "L", "L", "G")

FULL = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab_size=262144, head_dim=128,
    layer_pattern=PATTERN, sliding_window=1024,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    qk_norm=True, scale_embed=True, tie_embeddings=True,
    supports_long_context=True,   # 5-in-6 layers are 1024-window local
)

SMOKE = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    layer_pattern=PATTERN, sliding_window=16,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    qk_norm=True, scale_embed=True, tie_embeddings=True,
    supports_long_context=True, attn_chunk=32,
)

register(FULL, SMOKE)
