"""qwen3-32b [dense]: 64L, d=5120, 64H (GQA kv=8), d_ff=25600, v=151936.

qk-norm on query/key heads (Qwen3 signature); published head_dim=128.
[hf:Qwen/Qwen3-8B; hf]

The port's copy of ``repro.configs.qwen3_32b``.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab_size=151936, head_dim=128, qk_norm=True, tie_embeddings=False,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, qk_norm=True, tie_embeddings=False,
    attn_chunk=32,
)

register(FULL, SMOKE)
