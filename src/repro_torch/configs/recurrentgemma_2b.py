"""recurrentgemma-2b [hybrid]: 26L, d=2560, 10H (MQA kv=1), d_ff=7680,
v=256000.  Griffin temporal pattern (RG-LRU, RG-LRU, local attention),
lru_width=2560, 2048-token attention window, head_dim=256.
[arXiv:2402.19427; hf]

The port's copy of ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig, register

FULL = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256,
    layer_pattern=("R", "R", "L"), sliding_window=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, attn_window=2048),
    scale_embed=True, tie_embeddings=True,
    supports_long_context=True,   # recurrent + bounded-window attention
)

SMOKE = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, head_dim=16,
    layer_pattern=("R", "R", "L"), sliding_window=16,
    rglru=RGLRUConfig(lru_width=64, conv_width=4, attn_window=16),
    scale_embed=True, tie_embeddings=True,
    supports_long_context=True, attn_chunk=32,
)

register(FULL, SMOKE)
