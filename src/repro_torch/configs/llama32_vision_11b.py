"""llama-3.2-vision-11b [vlm]: 40L, d=4096, 32H (GQA kv=8), d_ff=14336,
v=128256.  Cross-attention to image tokens every 5th layer; the vision
frontend is a STUB per spec — input_specs provides precomputed patch
embeddings (n=1601, width 1280).  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]

The port's copy of ``repro.configs.llama32_vision_11b``.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, head_dim=128,
    layer_pattern=("G", "G", "G", "G", "X"),
    cross_attn_every=5, n_image_tokens=1601, d_image=1280,
    rope_theta=500_000.0, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    layer_pattern=("G", "G", "G", "G", "X"),
    cross_attn_every=5, n_image_tokens=16, d_image=32,
    tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
