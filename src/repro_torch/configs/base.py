"""Architecture configuration schema (port of ``repro.configs.base``).

The port's own copy of the reference's pure-data config module: one
frozen dataclass describes every family (dense / moe / hybrid / ssm /
vlm / audio), with the same fields and defaults, so
``dataclasses.asdict`` of a reference config builds the port's
(``repro_torch.convert.arch_config``).  ``remat`` and ``attn_chunk``
steer training, ``attn_scores_dtype`` its attention scores, and the MoE
``dispatch``/``ep_reduce`` the MoE FFN on a process grid
(``models.lm.moe.apply_moe_ep``); ``seq_parallel`` and
``scan_unroll``, which steer the reference's XLA/TPU lowering, are kept
as data and read by nothing here.
``repro_torch/configs/<id>.py`` hold the archs the port runs, each as
``FULL`` and ``SMOKE``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    first_dense_layers: int = 0     # leading dense layers (deepseek-style)
    # "xla"         — dense gather/scatter, SPMD partitioner chooses comms
    #                 (baseline; replicates token buffers — see §Perf).
    # "ep_shardmap" — explicit expert-parallel routing: fixed-capacity
    #                 per-expert send buffers moved by ONE all_to_all over
    #                 the data axis (the paper's §IV/§V DLB executor applied
    #                 to MoE tokens), expert FFN row/col-split over model.
    dispatch: str = "xla"
    # expert-output reduction over the model axis (ep_shardmap only):
    # "psum"  — all-reduce the full-D output buffer (baseline);
    # "rs_ag" — reduce-scatter along D, return-route D/TP slices, single
    #           all-gather after combine (≈16× less return traffic).
    ep_reduce: str = "psum"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 2560
    conv_width: int = 4
    block_pattern: tuple[str, ...] = ("R", "R", "A")   # recurrent/attention
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 ⇒ d_model // n_heads
    # attention features
    rope_theta: float = 10000.0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    sliding_window: int = 0         # 0 ⇒ full attention
    # local:global interleave, e.g. ("L","L","L","L","L","G") for gemma3
    layer_pattern: tuple[str, ...] = ()
    rope_theta_global: float = 0.0  # separate theta for "G" layers (gemma3)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # vlm: cross-attention to precomputed image embeddings every k-th layer
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # audio: parallel codebooks (musicgen)
    n_codebooks: int = 1
    d_image: int = 1280             # stub vision-frontend embedding width
    tie_embeddings: bool = True
    scale_embed: bool = False       # gemma-style sqrt(D) embedding scale
    norm_eps: float = 1e-6
    # numeric / execution policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512           # q-chunk for lax flash attention
    # "bfloat16" keeps the (Tq, Tk) score/prob intermediates in bf16 with
    # f32 softmax statistics — halves the dominant attention HBM term of
    # the train cells (§Perf); "float32" is the conservative baseline.
    attn_scores_dtype: str = "float32"
    # Megatron-style sequence parallelism: between matmuls the residual
    # stream is sharded (batch, seq/TP, D) instead of replicated over the
    # model axis — elementwise/norm/residual HBM traffic drops by TP×, and
    # the TP all-reduce splits into the equivalent all-gather +
    # reduce-scatter pair (§Perf cell 2).
    seq_parallel: bool = False
    # Unroll every internal lax.scan (layer stack, attention chunks, SSD
    # chunks, xent chunks).  Used by the roofline depth-variant compiles:
    # XLA's HloCostAnalysis counts a while body ONCE regardless of trip
    # count, so exact FLOP/byte/collective totals are extrapolated from
    # fully-unrolled depth-1 and depth-2 variants (launch/roofline.py).
    scan_unroll: bool = False
    # which serve shapes are valid (long_500k needs sub-quadratic attention)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_for(self, n_layers: int) -> tuple[str, ...]:
        """Per-layer kind string of length n_layers from layer_pattern."""
        if not self.layer_pattern:
            return tuple("G" for _ in range(n_layers))
        reps = -(-n_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[:n_layers]


# registry populated by the per-arch config modules
_REGISTRY: dict[str, "ArchConfig"] = {}
_SMOKE: dict[str, "ArchConfig"] = {}


def register(full: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[full.name] = full
    _SMOKE[full.name] = smoke
    return full


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (per-arch registration)
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
