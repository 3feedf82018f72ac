"""stablelm-3b [dense]: 32L, d=2560, 32H (MHA kv=32), d_ff=6912, v=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified]

The port's copy of ``repro.configs.stablelm_3b``.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
