"""granite-34b [dense]: 88L, d=6144, 48H (MQA kv=1), d_ff=24576, v=49152.

Llama-architecture code model with multi-query attention.
[arXiv:2405.04324; hf]

The port's copy of ``repro.configs.granite_34b``.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
