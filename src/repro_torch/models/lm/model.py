"""Decoder assembly on torch (port of ``repro.models.lm.model``).

This slice runs the ``G`` layer kind (global causal attention) with a
dense gated-MLP FFN, which is every layer of the G-only dense archs
(qwen3-32b, stablelm-3b, granite-34b).  The other kinds (``L``
sliding-window, ``M`` latent attention, ``X`` cross-attention, ``R``
RG-LRU, ``D`` Mamba-2), MoE FFNs, multi-codebook audio heads and
``forward_train`` wait for ROADMAP A12 and raise ``NotImplementedError``.

The reference scans stacked parameters over layer groups and casts its
float32 master weights to the compute dtype on every call
(``cast_params``).  Here the decoder is an ``nn.Module`` (embedding,
blocks, final norm, head) whose weights are held once in the compute
dtype — the same numbers — and the scan is a loop over layers.  KV caches
are a list with one ``{"k", "v"}`` dict of ``(B, Hkv, max_len, hd)``
buffers per layer; ``forward_decode`` writes the new token's K/V into
them in place (the reference's ``dynamic_update_slice`` returns a new
cache), so a decode step never copies a cache.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as L


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Head (unrolled) + ``n_groups`` repeats of ``unit`` + tail, each a
    tuple of ``(kind, ffn)`` per layer, as the reference lays them out."""

    head: tuple[tuple[str, str], ...]
    unit: tuple[tuple[str, str], ...]
    n_groups: int
    tail: tuple[tuple[str, str], ...]

    def layers(self) -> tuple[tuple[str, str], ...]:
        """Every layer's ``(kind, ffn)`` in depth order."""
        return self.head + self.unit * self.n_groups + self.tail


def make_plan(cfg: ArchConfig) -> LayerPlan:
    """The reference's layer plan of ``cfg``."""
    kinds = cfg.pattern_for(cfg.n_layers)
    first_dense = cfg.moe.first_dense_layers if cfg.moe else 0

    def ffn_of(i: int) -> str:
        if kinds[i] == "D":
            return "none"
        if cfg.moe and i >= first_dense:
            return "moe"
        return "dense"

    per_layer = tuple((kinds[i], ffn_of(i)) for i in range(cfg.n_layers))
    head = per_layer[:first_dense]
    rest = per_layer[first_dense:]
    unit_len = max(len(cfg.layer_pattern), 1)
    n_groups = len(rest) // unit_len
    tail = rest[n_groups * unit_len:]
    unit = rest[:unit_len] if n_groups else ()
    return LayerPlan(head=head, unit=unit, n_groups=n_groups, tail=tail)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A12 for anything but
    G layers with dense FFNs and a single-codebook head."""
    for i, (kind, ffn) in enumerate(make_plan(cfg).layers()):
        if kind != "G":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is kind {kind!r}; the port runs G "
                f"layers only (L, M, X, R, D wait for ROADMAP A12)")
        if ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} has a {ffn!r} FFN; MoE waits for "
                f"ROADMAP A12")
    if cfg.n_codebooks > 1 or cfg.cross_attn_every:
        raise NotImplementedError(f"{cfg.name}: multi-codebook and image "
                                  f"inputs wait for ROADMAP A12")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One ``G`` + dense decoder layer: pre-norm attention, then a
    pre-norm gated MLP, both residual."""

    def __init__(self, attn: dict, mlp: dict, pre_norm: torch.Tensor,
                 ffn_norm: torch.Tensor):
        super().__init__()
        self.pre_norm = _frozen(pre_norm)
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in attn.items()})
        self.ffn_norm = _frozen(ffn_norm)
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in mlp.items()})


class Decoder(nn.Module):
    """The decoder of one arch config: embedding, blocks, final norm and
    (untied) LM head, all in the compute dtype.  Build it with
    ``init_params`` (random weights from a seed) or
    ``repro_torch.convert.lm_params`` (the reference's weights)."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 blocks: list[Block], final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} "
                             f"layers")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given exactly when the "
                             "embeddings are untied")
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)

    @property
    def device(self) -> torch.device:
        """The device the weights live on."""
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype the weights are held in."""
        return self.embed.dtype


def init_params(cfg: ArchConfig, seed: int, *, device,
                dtype: torch.dtype | None = None) -> Decoder:
    """A decoder with random weights drawn on ``device`` from a seeded
    ``torch.Generator``, with the reference's shapes and scales
    (``N(0, 1/D)`` embedding and head, zero norm gains), in ``dtype``
    (default ``cfg.compute_dtype``)."""
    check_supported(cfg)
    dtype = dtype or L.dtype_of(cfg.compute_dtype)
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    embed = L.normal_weight((cfg.vocab_size, d), d ** -0.5, g, dtype)
    blocks = [Block(L.attn_params(g, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                  cfg.qk_norm, dtype),
                    L.mlp_params(g, d, cfg.d_ff, dtype), zeros(d), zeros(d))
              for _ in range(cfg.n_layers)]
    head = (None if cfg.tie_embeddings
            else L.normal_weight((d, cfg.vocab_size), d ** -0.5, g, dtype))
    return Decoder(cfg, embed, blocks, zeros(d), head)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device,
                dtype: torch.dtype) -> list[dict]:
    """Zeroed KV caches: per layer ``{"k", "v"}`` of
    ``(batch, Hkv, max_len, hd)``."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _theta(cfg: ArchConfig) -> float:
    return cfg.rope_theta_global or cfg.rope_theta


def _block_forward(blk: Block, x: torch.Tensor, cfg: ArchConfig, mode: str,
                   cache: dict, positions: torch.Tensor,
                   pos: int | None) -> torch.Tensor:
    """One G + dense layer; fills (prefill) or extends (decode) ``cache``
    in place.  Returns the new residual stream."""
    eps, hd = cfg.norm_eps, cfg.resolved_head_dim
    h = L.rms_norm(x, blk.pre_norm, eps)
    q, k, v = L.apply_qkv(blk.attn, h, cfg.n_heads, cfg.n_kv_heads, hd,
                          positions, _theta(cfg), cfg.qk_norm, eps)
    if mode == "decode":
        # in place: the reference's dynamic_update_slice at pos
        cache["k"][:, :, pos] = k[:, :, 0]
        cache["v"][:, :, pos] = v[:, :, 0]
        o = L.decode_attention(q, cache["k"], cache["v"], pos,
                               softcap=cfg.logit_softcap)
    else:
        o = L.causal_attention(q, k, v, softcap=cfg.logit_softcap)
        t = k.shape[2]
        cache["k"][:, :, :t] = k
        cache["v"][:, :, :t] = v
    b, t = x.shape[:2]
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)
    x = x + o @ blk.attn["wo"]
    hf = L.rms_norm(x, blk.ffn_norm, eps)
    return x + L.apply_mlp(blk.mlp, hf)


def _embed(model: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens.long()]
    if model.cfg.scale_embed:
        x = x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(model: Decoder, x: torch.Tensor) -> torch.Tensor:
    """Hidden states ``(B, T, D)`` → logits ``(B, T, V)``."""
    head = model.lm_head if model.lm_head is not None else model.embed.T
    return x @ head


def forward_train(model: Decoder, tokens: torch.Tensor, img=None):
    """The training forward (hidden states for the chunked loss) waits for
    the training slice, ROADMAP A12."""
    raise NotImplementedError("forward_train waits for the training slice "
                              "(ROADMAP A12)")


def forward_prefill(model: Decoder, tokens: torch.Tensor,
                    max_len: int) -> tuple[torch.Tensor, list[dict]]:
    """``tokens`` ``(B, T)`` → the final-normed last hidden state
    ``(B, 1, D)`` and KV caches of ``max_len`` slots holding positions
    ``0..T-1``."""
    cfg = model.cfg
    b, t = tokens.shape
    caches = init_caches(cfg, b, max_len, device=model.device,
                         dtype=model.dtype)
    x = _embed(model, tokens)
    positions = torch.arange(t, device=model.device)
    for blk, cache in zip(model.blocks, caches):
        x = _block_forward(blk, x, cfg, "prefill", cache, positions, None)
    x = L.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return x, caches


def forward_decode(model: Decoder, tokens: torch.Tensor, pos: int,
                   caches: list[dict]) -> tuple[torch.Tensor, list[dict]]:
    """``tokens`` ``(B, 1)`` at position ``pos`` against ``caches`` →
    logits ``(B, 1, V)``; the caches gain slot ``pos`` in place and are
    returned."""
    cfg = model.cfg
    pos = int(pos)
    x = _embed(model, tokens)
    positions = torch.full((1,), pos, dtype=torch.int32, device=model.device)
    for blk, cache in zip(model.blocks, caches):
        x = _block_forward(blk, x, cfg, "decode", cache, positions, pos)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed(model, x), caches
