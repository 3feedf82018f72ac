"""deepseek-v2-236b [moe]: 60L, d=5120, 128H, v=102400.

MLA with kv_lora_rank=512 (+64 rotary); MoE: 160 routed experts top-6
+ 2 shared, expert d_ff=1536; first layer dense (d_ff=12288).
[arXiv:2405.04434; hf]

The port's copy of ``repro.configs.deepseek_v2_236b``.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

FULL = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab_size=102400,
    layer_pattern=("M",),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared_experts=2, first_dense_layers=1,
                  dispatch="ep_shardmap", ep_reduce="rs_ag"),
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
    layer_pattern=("M",),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                  n_shared_experts=1, first_dense_layers=1),
    tie_embeddings=False, attn_chunk=32,
)

register(FULL, SMOKE)
