"""musicgen-medium [audio]: 48L, d=1536, 24H (MHA kv=24), d_ff=6144,
v=2048 per codebook.  Decoder-only over EnCodec tokens with 4 parallel
codebooks (delay pattern handled by the data pipeline); the EnCodec
frontend is a STUB per spec.  [arXiv:2306.05284; hf]

The port's copy of ``repro.configs.musicgen_medium``.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, n_codebooks=4, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=64, n_codebooks=4, tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
