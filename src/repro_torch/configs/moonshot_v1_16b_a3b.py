"""moonshot-v1-16b-a3b [moe]: 48L, d=2048, 16H (kv=16), v=163840.

Kimi/Moonlight family: 64 routed experts top-6 + 2 shared, expert
d_ff=1408; first layer dense (d_ff=11264).
[hf:moonshotai/Moonlight-16B-A3B; hf]

The port's copy of ``repro.configs.moonshot_v1_16b_a3b``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=11264,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, first_dense_layers=1,
                  dispatch="ep_shardmap", ep_reduce="rs_ag"),
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                  n_shared_experts=1, first_dense_layers=1),
    tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
