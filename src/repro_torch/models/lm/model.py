"""Decoder assembly on torch (port of ``repro.models.lm.model``).

Layer kinds, as the reference names them:

  G — global causal attention            L — sliding-window attention
  M — multi-head latent attention        R — RG-LRU recurrent block
  X — cross-attention to image tokens    D — Mamba-2 SSD block

each with the reference's FFN: the dense gated MLP, a mixture of
experts (``moe``, past an arch's ``first_dense_layers``) or none (after
a ``D`` layer); and the multi-codebook audio head (K summed codebook
embeddings in, ``(B, T, K, V)`` logits out).

Training (``forward_train``) runs every kind, FFN and head on a
trainable decoder (``trainable``, ``init_train_params``): float32 master
weights with ``requires_grad``, cast to the compute dtype inside the
graph on every call (``cast_params``, the reference's), so the gradients
arrive in float32.  Its attention (G, L, the M kind's decompressed
heads, the X kind's image tokens) is ``layers.chunked_causal_attention``,
never the flash kernel; the R and D kinds differentiate their scans; a
MoE FFN's aux values come back summed over the layers.  With
``cfg.remat`` each layer of a scanned group runs under
``torch.utils.checkpoint``.

The reference scans stacked parameters over layer groups and casts its
float32 master weights to the compute dtype on every call
(``cast_params``).  Here the decoder is an ``nn.Module`` (embedding,
blocks, final norm, head, image projection) whose weights are held once
in the compute dtype — the same numbers — and the scan is a loop over
layers.  Caches are a list with one dict per layer: ``{"k", "v"}`` of
``(B, Hkv, max_len, hd)`` (G, L), ``{"xk", "xv"}`` of ``(B, Hkv,
n_image, hd)`` (X, filled at prefill), ``{"c", "pe"}`` of ``(B, max_len,
kv_lora_rank)`` and ``(B, max_len, qk_rope_dim)`` (M: the latent and the
shared rotary key), ``{"rec", "conv"}`` (R: the float32 ``(B, W)`` state
and the last ``conv_width - 1`` inputs) and ``{"ssm", "conv"}`` (D).
``forward_decode`` writes the new token's K/V (M: its latent and rotary
key) into the attention caches in place (the reference's
``dynamic_update_slice`` returns a new cache), so a decode step never
copies a KV cache; the recurrent leaves are replaced by the step's new
tensors.

Over a process grid's ``model`` axis (``launch.sharding``) every kind is
tensor-parallel: a rank computes whole heads (``_Heads``; where
``model`` does not divide them, from weights gathered over ``model``)
or its channels (the R kind's RG-LRU width, the D kind's SSD heads with
``w_in`` re-cut by head), and each mixer's output is a partial sum that
``_block_forward`` reduces.  Caches hold the rank's part
(``init_caches``); an attention cache laid by length (the M kind's
always, a G or L kind's where ``model`` does not divide its key/value
heads) makes the decode sequence-parallel over the shards.

A MoE layer's aux diagnostics (load-balance loss, dropped fraction,
largest expert load) are summed over the layers, as the reference's
``_run_blocks`` sums them, into an ``aux`` dict the caller may pass to
``forward_prefill`` or ``forward_decode``; their returns stay as they
are.  ``route_groups`` splits the rows into equal groups that each
route to the experts on their own (``moe.apply_moe``'s ``groups``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import runtime
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.models.lm import layers as L
from repro_torch.models.lm import mla as MLA
from repro_torch.models.lm import moe as MOE
from repro_torch.models.lm import rglru as RG
from repro_torch.models.lm import ssm as SSM

# the reference's name of each kind's mixer leaf and each FFN's leaf in a
# layer's params
MIXERS = {"G": "attn", "L": "attn", "M": "mla", "X": "xattn", "R": "rglru",
          "D": "ssm"}
FFNS = {"dense": "mlp", "moe": "moe", "none": None}


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

    def scanned(self) -> range:
        """The depth indices of the layers the reference scans in groups
        (their leaves stacked on a leading group axis)."""
        lo = len(self.head)
        return range(lo, lo + len(self.unit) * self.n_groups)


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
    """Raise ``ValueError`` for a layer kind or FFN the reference does not
    define (every one it defines is ported)."""
    for i, (kind, ffn) in enumerate(make_plan(cfg).layers()):
        if kind not in MIXERS or ffn not in FFNS:
            raise ValueError(f"{cfg.name}: layer {i} is a {kind!r} layer "
                             f"with FFN {ffn!r}; the kinds are "
                             f"{sorted(MIXERS)}, the FFNs {sorted(FFNS)}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(d: dict) -> nn.ParameterDict:
    """The reference's leaf dict as frozen parameters, a nested dict (a
    MoE layer's ``shared`` MLP) as a nested ``ParameterDict``."""
    return nn.ParameterDict({
        k: _frozen_dict(v) if isinstance(v, dict) else _frozen(v)
        for k, v in d.items()})


class Block(nn.Module):
    """One decoder layer of kind ``kind`` with FFN ``ffn`` (``"dense"``,
    ``"moe"`` or ``"none"``), from the reference's per-layer leaves:
    ``pre_norm``, the mixer's dict under its reference name (``attn``,
    ``mla``, ``xattn`` with the scalar ``xattn_gate``, ``rglru`` or
    ``ssm``), and for a dense or MoE FFN ``ffn_norm`` and ``mlp`` or
    ``moe`` (the router, the experts' ``we_gate``/``we_up``/``we_down``
    and, with shared experts, the ``shared`` MLP).  The mixer's and the
    FFN's weights are attributes of those names (``block.attn``,
    ``block.moe``, ...)."""

    def __init__(self, kind: str, ffn: str, leaves: dict):
        super().__init__()
        self.kind, self.ffn = kind, ffn
        name, ffn_name = MIXERS[kind], FFNS[ffn]
        if name not in leaves or any(
                (f in leaves) != (f == ffn_name) for f in ("mlp", "moe")):
            raise ValueError(f"a {kind}/{ffn} layer with leaves "
                             f"{sorted(leaves)}")
        self.pre_norm = _frozen(leaves["pre_norm"])
        setattr(self, name, _frozen_dict(leaves[name]))
        if kind == "X":
            self.xattn_gate = _frozen(leaves["xattn_gate"])
        if ffn_name is not None:
            self.ffn_norm = _frozen(leaves["ffn_norm"])
            setattr(self, ffn_name, _frozen_dict(leaves[ffn_name]))


class Decoder(nn.Module):
    """The decoder of one arch config: embedding, blocks, final norm,
    (untied) LM head and, with cross-attention, the image projection,
    all in the compute dtype.  With K > 1 codebooks the embedding is
    ``(K, V, D)`` and the head ``(K, D, V)``.  Build it with
    ``init_params`` (random weights from a seed) or
    ``repro_torch.convert.lm_params`` (the reference's weights)."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 blocks: list[Block], final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None,
                 img_proj: torch.Tensor | None = None):
        super().__init__()
        check_supported(cfg)
        plan = make_plan(cfg).layers()
        if [(b.kind, b.ffn) for b in blocks] != list(plan):
            raise ValueError(f"blocks {[(b.kind, b.ffn) for b in blocks]} "
                             f"do not follow the plan {list(plan)}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given exactly when the "
                             "embeddings are untied")
        if (img_proj is None) != (not cfg.cross_attn_every):
            raise ValueError("img_proj must be given exactly when the arch "
                             "cross-attends to image tokens")
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)
        self.img_proj = None if img_proj is None else _frozen(img_proj)

    @property
    def device(self) -> torch.device:
        """The device the weights live on."""
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the weights are held in."""
        return self.embed.dtype

    def reference_ndims(self) -> dict[str, int]:
        """Each weight's rank in the reference's params pytree, by name:
        a layer of a scanned group is stacked there on a leading group
        axis (``init_params``' vmap), one rank more than here."""
        scanned = make_plan(self.cfg).scanned()
        out = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            stacked = parts[0] == "blocks" and int(parts[1]) in scanned
            out[name] = p.dim() + stacked
        return out


class _MetaGenerator:
    """Stands in for a generator on the ``meta`` device (shapes alone)."""

    device = torch.device("meta")


def _kept(leaves: dict, keep, prefix: str) -> dict:
    """``keep(name, leaf)`` of every leaf of a (nested) dict of weights."""
    return {k: _kept(v, keep, f"{prefix}{k}.") if isinstance(v, dict)
            else keep(prefix + k, v) for k, v in leaves.items()}


def init_params(cfg: ArchConfig, seed: int, *, device,
                dtype: torch.dtype | None = None, keep=None) -> Decoder:
    """A decoder with random weights drawn on ``device`` from a seeded
    ``torch.Generator``, with the reference's shapes and scales
    (``N(0, 1/D)`` embedding and head, zero norm gains, the recurrent
    blocks' fixed decay inits), in ``dtype`` (default
    ``cfg.compute_dtype``).  On the ``meta`` device it holds the shapes
    alone.  ``keep(name, weight)`` (``launch.sharding.RankBlocks``)
    replaces each full weight as soon as its layer is drawn, by its
    block: a rank's decoder is drawn one layer at a time with the same
    draws as the whole one, and never holds more than one full layer."""
    check_supported(cfg)
    dtype = dtype or L.dtype_of(cfg.compute_dtype)
    device = torch.device(device)
    if device.type == "meta":
        g = _MetaGenerator()
    else:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
    d, hd, v = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size
    keep = keep or (lambda name, x: x)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer(i: int, kind: str, ffn: str) -> Block:
        leaves = {"pre_norm": zeros(d)}
        if kind in ("G", "L", "X"):
            leaves[MIXERS[kind]] = L.attn_params(
                g, d, cfg.n_heads, cfg.n_kv_heads, hd, cfg.qk_norm, dtype)
        elif kind == "M":
            leaves["mla"] = MLA.mla_params(g, d, cfg.n_heads, cfg.mla, dtype)
        elif kind == "R":
            leaves["rglru"] = RG.rglru_params(g, d, cfg.rglru, dtype)
        else:
            leaves["ssm"] = SSM.ssm_params(g, d, cfg.ssm, dtype)
        if kind == "X":
            leaves["xattn_gate"] = zeros()
        if ffn == "dense":
            leaves["ffn_norm"] = zeros(d)
            leaves["mlp"] = L.mlp_params(g, d, cfg.d_ff, dtype)
        elif ffn == "moe":
            leaves["ffn_norm"] = zeros(d)
            leaves["moe"] = MOE.moe_params(g, d, cfg.moe, dtype)
        return Block(kind, ffn, _kept(leaves, keep, f"blocks.{i}."))

    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    embed = keep("embed", L.normal_weight(books + (v, d), d ** -0.5, g,
                                          dtype))
    blocks = [layer(i, kind, ffn)
              for i, (kind, ffn) in enumerate(make_plan(cfg).layers())]
    head = (None if cfg.tie_embeddings
            else keep("lm_head", L.normal_weight(books + (d, v), d ** -0.5,
                                                 g, dtype)))
    img = (keep("img_proj", L.normal_weight((cfg.d_image, d),
                                            cfg.d_image ** -0.5, g, dtype))
           if cfg.cross_attn_every else None)
    return Decoder(cfg, embed, blocks, keep("final_norm", zeros(d)), head,
                   img)


def trainable(model: Decoder) -> Decoder:
    """``model`` (float32 weights) as training's master weights: every
    weight gets ``requires_grad``, in place."""
    if model.dtype != torch.float32:
        raise TypeError(f"master weights are float32, got {model.dtype}")
    return model.requires_grad_(True)


def init_train_params(cfg: ArchConfig, seed: int, *, device,
                      grid=None) -> Decoder:
    """A trainable decoder: ``init_params``' random weights in float32
    (the reference's ``param_dtype``), drawn on ``device``, with
    ``requires_grad``; with ``grid``, this rank's blocks of them (see
    ``shard_params``)."""
    return trainable(shard_params(cfg, seed, device=device, grid=grid,
                                  dtype=L.dtype_of(cfg.param_dtype)))


def shard_params(cfg: ArchConfig, seed: int, *, device, grid=None,
                 dtype: torch.dtype | None = None, coords=None) -> Decoder:
    """``init_params``, or with ``grid`` the blocks of the rank at
    ``coords`` (default this rank's) of the same weights, drawn a layer
    at a time (``launch.sharding.RankBlocks``) and marked with their
    specs.  Raises ``ValueError`` for what the grid cannot run yet, before
    it draws anything."""
    if grid is None:
        return init_params(cfg, seed, device=device, dtype=dtype)
    SH.check_supported(cfg, grid)
    keep = SH.RankBlocks(grid, coords)
    return keep.attach(init_params(cfg, seed, device=device, dtype=dtype,
                                   keep=keep))


def _block_leaves(blk: Block) -> dict:
    """A block's weights as the nested dict ``Block`` is built from."""
    def leaves(mod):
        out = {n: p.detach() for n, p in mod.named_parameters(recurse=False)}
        out.update({n: leaves(c) for n, c in mod.named_children()})
        return out
    return leaves(blk)


def shard_decoder(model: Decoder, grid, coords=None) -> Decoder:
    """The decoder of the rank at ``coords`` (default this rank's) of
    ``grid``, cut from the full ``model``'s tensors (each block in
    storage of its own; a trainable model's blocks are trainable)."""
    SH.check_supported(model.cfg, grid)
    keep = SH.RankBlocks(grid, coords)
    blocks = [Block(b.kind, b.ffn, _kept(_block_leaves(b), keep,
                                         f"blocks.{i}."))
              for i, b in enumerate(model.blocks)]
    out = Decoder(model.cfg, keep("embed", model.embed.detach()), blocks,
                  keep("final_norm", model.final_norm.detach()),
                  None if model.lm_head is None
                  else keep("lm_head", model.lm_head.detach()),
                  None if model.img_proj is None
                  else keep("img_proj", model.img_proj.detach()))
    keep.attach(out)
    return out.requires_grad_(model.embed.requires_grad)


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                 device, dtype: torch.dtype, grid=None) -> dict:
    """A layer's zeroed cache; on a grid the rank's part of it
    (``launch.specs._cache_leaf_spec``'s layout, ``init_caches``)."""
    hd = cfg.resolved_head_dim
    m = SH.model_size(grid)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("G", "L"):
        if _Heads(cfg, grid).divided:
            shape = (batch, cfg.n_kv_heads // m, max_len, hd)
        else:                       # the length over model (SP decode)
            shape = (batch, cfg.n_kv_heads, SH.length_slots(max_len, grid),
                     hd)
        return {"k": zeros(shape), "v": zeros(shape)}
    if kind == "M":
        slots = SH.length_slots(max_len, grid)
        return {"c": zeros((batch, slots, cfg.mla.kv_lora_rank)),
                "pe": zeros((batch, slots, cfg.mla.qk_rope_dim))}
    if kind == "X":
        heads = _Heads(cfg, grid)
        shape = (batch, heads.k1 - heads.k0, cfg.n_image_tokens, hd)
        return {"xk": zeros(shape), "xv": zeros(shape)}
    if kind == "R":
        w = cfg.rglru.lru_width // m
        return {"rec": zeros((batch, w), torch.float32),
                "conv": zeros((batch, cfg.rglru.conv_width - 1, w))}
    s = cfg.ssm
    heads, _, _, groups = _ssd_heads(cfg, grid)
    channels = heads * s.head_dim + 2 * groups * s.state_dim
    return {"ssm": zeros((batch, heads, s.head_dim, s.state_dim)),
            "conv": zeros((batch, s.conv_width - 1, channels))}


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device,
                dtype: torch.dtype, grid=None) -> list[dict]:
    """Zeroed caches, one dict per layer (the module docstring's layout);
    the recurrent ``rec`` state is float32, every other leaf ``dtype``.
    On a grid, ``batch`` is the rank's rows and each leaf the rank's part
    (``launch.specs._cache_leaf_spec``'s layout): a G or L layer's
    key/value heads over ``model`` where it divides them, else the cache
    length (``launch.sharding.length_slots``: the decode is then
    sequence-parallel), the M layer's latent cache by length, the X
    layer's image keys and values of the key/value heads the rank's query
    heads read, the R and D layers' states of the rank's channels and
    heads (their conv caches hold the rank's channels, where the
    reference replicates them)."""
    return [_layer_cache(cfg, kind, batch, max_len, device, dtype, grid)
            for kind, _ in make_plan(cfg).layers()]


def _theta_window(cfg: ArchConfig, kind: str) -> tuple[float, int]:
    """RoPE base and attention window of an attention layer: an ``L``
    layer takes ``rope_theta`` and the window (``sliding_window``, else
    the RG-LRU config's), any other ``rope_theta_global`` (else
    ``rope_theta``) and no window."""
    if kind == "L":
        window = cfg.sliding_window or (cfg.rglru.attn_window if cfg.rglru
                                        else 0)
        return cfg.rope_theta, window
    return cfg.rope_theta_global or cfg.rope_theta, 0


class _Heads:
    """The rank's query heads ``q0 … q1-1`` over ``model``
    (``launch.sharding.head_range``: whole heads, every head on one
    device) and the key/value heads ``k0 … k1-1`` they read.  ``divided``:
    ``model`` divides both counts, so the rank's column blocks of ``wq``,
    ``wk``, ``wv`` and row block of ``wo`` are exactly those heads;
    otherwise the layer takes them from the weights gathered over
    ``model`` (``weights``).  ``kv_of`` maps the rank's query heads to its
    key/value heads, by GQA's grouping where they group evenly, else one
    key/value head a query head."""

    def __init__(self, cfg: ArchConfig, grid):
        self.hq, self.hkv = cfg.n_heads, cfg.n_kv_heads
        self.hd = cfg.resolved_head_dim
        m = SH.model_size(grid)
        self.divided = self.hq % m == 0 and self.hkv % m == 0
        self.q0, self.q1 = SH.head_range(self.hq, grid)
        g = self.hq // self.hkv
        self.nq = self.q1 - self.q0
        self.k0 = self.q0 // g
        self.k1 = (self.q1 - 1) // g + 1 if self.nq else self.k0
        # each query head's key/value head among the rank's
        self.index = [(self.q0 + j) // g - self.k0 for j in range(self.nq)]
        per = self.nq // max(self.k1 - self.k0, 1)
        self.even = self.index == [j // per for j in range(self.nq)] \
            if per else True

    def weights(self, p: dict, grid) -> dict:
        """``wq`` of the rank's query heads, ``wk``/``wv`` of every
        key/value head, ``wo``'s rows of the rank's heads (and the norm
        gains as they are)."""
        hd, q0, q1 = self.hd, self.q0, self.q1
        out = dict(p)
        if self.hq % SH.model_size(grid):
            out["wq"] = SH.model_gather(p["wq"], grid, 1,
                                       self.hq * hd)[:, q0 * hd:q1 * hd]
            out["wo"] = SH.model_gather(p["wo"], grid, 0,
                                       self.hq * hd)[q0 * hd:q1 * hd]
        for name in ("wk", "wv"):
            out[name] = SH.model_gather(p[name], grid, 1, self.hkv * hd)
        return out

    def kv_of(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``(B, Hkv, T, hd)`` of every key/value head → those the
        rank's query heads read, grouped for GQA."""
        if self.even:
            return x[:, self.k0:self.k1]
        return torch.stack([x[:, self.k0 + i] for i in self.index], 1)

    def all_queries(self, q: torch.Tensor, grid) -> torch.Tensor:
        """The rank's query heads ``(B, nq, Lq, hd)`` → every rank's, in
        head order (a gather over ``model`` padded to the largest count)."""
        m = SH.model_size(grid)
        if m == 1:
            return q
        most = -(-self.hq // m)
        pad = q.new_zeros((q.shape[0], most) + tuple(q.shape[2:]))
        pad[:, :self.nq] = q
        every = SH.model_all(pad, grid, 1)
        keep = [r * most + j for r in range(m)
                for j in range(self.hq * (r + 1) // m - self.hq * r // m)]
        return every[:, keep]


def _sp_decode(q: torch.Tensor, cache: dict, pos: int, window: int,
               softcap: float, grid, heads: _Heads) -> torch.Tensor:
    """A sequence-parallel decode (flash-decode over the cache's length
    shards): every query head ``q`` ``(B, Hq, 1, hd)`` attends the rank's
    shard over the keys it may see (``pos`` and the window's, an explicit
    range: a shard wholly past ``pos`` or before the window gives ``o =
    0``, ``lse = -inf``), B6's partials (``ops.attention_partials``),
    combined over the ranks (``_combine_over_model``).  Returns the rank's
    heads' output ``(B, nq, 1, hd)``."""
    slots = cache["k"].shape[2]
    first = SH.model_index(grid) * slots
    lo = max(first, pos - window + 1 if window > 0 else 0)
    hi = min(first + slots, pos + 1)
    o, lse = ops.attention_partials(q, cache["k"], cache["v"],
                                    key_lo=lo - first, key_hi=hi - first,
                                    scale=q.shape[-1] ** -0.5,
                                    logit_softcap=softcap)
    return _combine_over_model(o, lse, grid)[:, heads.q0:heads.q1]


def _combine_over_model(o: torch.Tensor, lse: torch.Tensor,
                        grid) -> torch.Tensor:
    """Every rank's length-shard partial ``(o, lse)`` gathered over
    ``model`` and combined in rank order (``ops.combine_partials``): the
    attention over the whole cache, the same bits on every rank."""
    m = SH.model_size(grid)
    o_all = SH.model_all(o[None], grid, 0)
    lse_all = SH.model_all(lse[None], grid, 0)
    return ops.combine_partials(o_all.reshape((m,) + tuple(o.shape)),
                                lse_all.reshape((m,) + tuple(lse.shape)))


def _write_shard(leaf: torch.Tensor, x: torch.Tensor, first: int,
                 dim: int) -> None:
    """Write the positions of ``x`` (from 0, along ``dim``) that fall in
    the shard of ``leaf`` (its slots hold positions ``first`` on) in
    place."""
    n = min(x.shape[dim] - first, leaf.shape[dim])
    if n > 0:
        leaf.narrow(dim, 0, n).copy_(x.narrow(dim, first, n))


def _attention(blk: Block, h: torch.Tensor, cfg: ArchConfig, mode: str,
               cache: dict, positions: torch.Tensor,
               pos: int | None, grid=None) -> torch.Tensor:
    """A G or L layer's attention output after ``wo`` ``(B, T, D)``; fills
    (prefill) or extends (decode) its KV cache in place, or (train) runs
    the chunked attention with no cache.  On a grid with a ``model`` axis
    the output is the rank's partial sum (``_block_forward`` reduces it):
    ``h`` enters through Megatron's ``f``, the rank computes its query
    heads (``_Heads``) and the key/value heads they read, and ``wo``'s
    rows of its heads; the replicated qk-norm gains enter through ``f``
    too (each ``f`` the identity without one).  Where ``model`` divides
    the heads, the rank's weights hold them and the cache its key/value
    heads.  Where it does not, the weights are gathered over ``model``
    (their gradients reduce-scattered back), the cache holds every
    key/value head over the rank's length shard, which prefill fills,
    and the decode is sequence-parallel (``_sp_decode``)."""
    hd = cfg.resolved_head_dim
    theta, window = _theta_window(cfg, blk.kind)
    heads = _Heads(cfg, grid)
    h = SH.tp_copy(h, grid)
    # the qk-norm gains act on the rank's heads alone: their gradients
    # are partial sums over model
    p = {k: SH.tp_copy(w, grid) if k.endswith("_norm") else w
         for k, w in blk.attn.items()}
    b, t = h.shape[:2]
    if heads.divided:
        m = SH.model_size(grid)
        q, k, v = L.apply_qkv(p, h, cfg.n_heads // m, cfg.n_kv_heads // m,
                              hd, positions, theta, cfg.qk_norm,
                              cfg.norm_eps)
        kv = (k, v)
    else:
        p = heads.weights(p, grid)
        q, k_all, v_all = L.apply_qkv(p, h, heads.nq, heads.hkv, hd,
                                      positions, theta, cfg.qk_norm,
                                      cfg.norm_eps)
        kv = (heads.kv_of(k_all), heads.kv_of(v_all))
    if mode == "train":
        o = L.chunked_causal_attention(
            q, *kv, window=window, chunk=cfg.attn_chunk,
            softcap=cfg.logit_softcap,
            scores_dtype=L.dtype_of(cfg.attn_scores_dtype)) \
            if heads.nq else None
    elif mode == "decode" and heads.divided:
        # in place: the reference's dynamic_update_slice at pos
        cache["k"][:, :, pos] = kv[0][:, :, 0]
        cache["v"][:, :, pos] = kv[1][:, :, 0]
        o = L.decode_attention(q, cache["k"], cache["v"], pos, window=window,
                               softcap=cfg.logit_softcap)
    elif mode == "decode":
        slots = cache["k"].shape[2]
        first = SH.model_index(grid) * slots
        if first <= pos < first + slots:
            cache["k"][:, :, pos - first] = k_all[:, :, 0]
            cache["v"][:, :, pos - first] = v_all[:, :, 0]
        o = _sp_decode(heads.all_queries(q, grid), cache, pos, window,
                       cfg.logit_softcap, grid, heads)
    else:
        o = L.causal_attention(q, *kv, window=window,
                               softcap=cfg.logit_softcap) \
            if heads.nq else None
        if heads.divided:
            cache["k"][:, :, :t] = kv[0]
            cache["v"][:, :, :t] = kv[1]
        else:
            first = SH.model_index(grid) * cache["k"].shape[2]
            _write_shard(cache["k"], k_all, first, 2)
            _write_shard(cache["v"], v_all, first, 2)
    return _heads_out(o, q, kv, p["wo"], heads.nq * hd)


def _heads_out(o: torch.Tensor | None, q: torch.Tensor, kv: tuple,
               wo: torch.Tensor, width: int) -> torch.Tensor:
    """The rank's heads' output ``o`` ``(B, nq, T, hd)`` through its rows
    of ``wo``.  ``o`` is ``None`` on a rank with no query head (more ranks
    than heads): a zero partial that keeps the gathered weights in the
    graph, so that each collective's backward runs on every rank."""
    b, t = q.shape[0], q.shape[2]
    if o is None:
        zero = q.transpose(1, 2).reshape(b, t, 0) @ wo
        return zero + 0.0 * (kv[0].sum() + kv[1].sum()).to(zero.dtype)
    return o.transpose(1, 2).reshape(b, t, width) @ wo


def _cross_attention(blk: Block, h: torch.Tensor, cfg: ArchConfig, mode: str,
                     cache: dict, img: torch.Tensor | None,
                     grid=None) -> torch.Tensor:
    """An X layer's gated cross-attention update: no RoPE and no qk-norm,
    full attention over the image tokens' K/V (projected at prefill and
    kept in the cache; in training projected with no cache and attended
    by ``chunked_causal_attention(causal=False)``, the reference's
    ``model.py:276-292``), gated by ``tanh(xattn_gate)`` (float32,
    cast).  On a grid with a ``model`` axis it is the rank's partial sum
    (``_block_forward`` reduces it): ``h``, the whole image tokens and
    the gate enter through ``f``, the rank's query heads and the
    key/value heads they read (``_Heads``; the cache holds those) attend
    by B6, and ``wo``'s rows of its heads make the partial."""
    hd = cfg.resolved_head_dim
    heads = _Heads(cfg, grid)
    p = dict(blk.xattn) if heads.divided else heads.weights(blk.xattn, grid)
    b, t = h.shape[:2]
    h = SH.tp_copy(h, grid)
    q = (h @ p["wq"]).reshape(b, t, heads.nq, hd).transpose(1, 2)
    if mode != "decode":
        if img is None:
            raise ValueError(f"{cfg.name} cross-attends to image tokens: "
                             f"{mode} needs img (B, n_image, d_image)")
        img = SH.tp_copy(img, grid)
        n = img.shape[1]
        if heads.divided:
            xk, xv = ((img @ w).reshape(b, n, -1, hd).transpose(1, 2)
                      for w in (p["wk"], p["wv"]))
        else:
            xk, xv = (heads.kv_of((img @ w).reshape(b, n, heads.hkv, hd)
                                  .transpose(1, 2))
                      for w in (p["wk"], p["wv"]))
        if mode == "train":
            o = L.chunked_causal_attention(q, xk, xv, chunk=cfg.attn_chunk,
                                           causal=False) \
                if heads.nq else None
        else:
            cache["xk"], cache["xv"] = xk.contiguous(), xv.contiguous()
    if mode != "train":
        o = L.cross_attention(q, cache["xk"], cache["xv"]) \
            if heads.nq else None
    gate = torch.tanh(SH.tp_copy(blk.xattn_gate, grid).float()).to(h.dtype)
    kv = (xk, xv) if mode != "decode" else (cache["xk"], cache["xv"])
    return gate * _heads_out(o, q, kv, p["wo"], heads.nq * hd)


def _latent_attention(blk: Block, h: torch.Tensor, cfg: ArchConfig,
                      mode: str, cache: dict, positions: torch.Tensor,
                      pos: int | None, grid=None) -> torch.Tensor:
    """An M layer's update: at prefill the decompressed attention (B6),
    filling the latent cache; in training the same heads through the
    chunked attention, with no cache; at decode the token's latent and
    rotary key written at slot ``pos`` in place, then the absorbed
    decode.  On a grid with a ``model`` axis it is the rank's partial sum
    (``_block_forward`` reduces it): the rank's heads' ``wq_b``, ``wk_b``,
    ``wv_b`` columns and ``wo`` rows, ``h`` and the replicated ``wq_a``,
    ``wkv_a`` and norm gains through ``f``, the shared rotary key on
    every rank; the latent cache holds the rank's length shard
    (``launch.sharding.length_slots``), which prefill fills, and the
    decode is sequence-parallel (``_latent_sp_decode``; on one device
    the one shard, ``mla.mla_decode_absorbed``'s bits)."""
    theta, eps, mc = cfg.rope_theta, cfg.norm_eps, cfg.mla
    p = {k: SH.tp_copy(w, grid) if k in MLA.REPLICATED else w
         for k, w in blk.mla.items()}
    h = SH.tp_copy(h, grid)
    n_heads = p["wq_b"].shape[1] // (mc.qk_nope_dim + mc.qk_rope_dim)
    first = 0 if cache is None else SH.model_index(grid) * cache["c"].shape[1]
    if mode == "train":
        return MLA.mla_attention(
            p, h, n_heads, mc, positions=positions,
            theta=theta, eps=eps, chunk=cfg.attn_chunk,
            scores_dtype=L.dtype_of(cfg.attn_scores_dtype))
    if mode == "prefill":
        return MLA.mla_attention(p, h, n_heads, mc, positions=positions,
                                 theta=theta, eps=eps, cache=cache,
                                 cache_first=first)
    c_new, pe_new = MLA.mla_compress(p, h, positions, theta, eps)
    if first <= pos < first + cache["c"].shape[1]:
        cache["c"][:, pos - first] = c_new[:, 0]
        cache["pe"][:, pos - first] = pe_new[:, 0]
    return _latent_sp_decode(p, h, n_heads, cfg, cache, first, pos, grid)


def _latent_sp_decode(p: dict, h: torch.Tensor, n_heads: int,
                      cfg: ArchConfig, cache: dict, first: int, pos: int,
                      grid) -> torch.Tensor:
    """The M layer's absorbed decode over the latent cache's length
    shards: each rank absorbs ``W^UK`` into its heads' queries, the
    ``(B, H, r + drope)`` absorbed queries are gathered over ``model``
    (every rank scores every head; an all-to-all of each rank's heads'
    partials would be the other layout), each rank scores its shard's
    visible positions and keeps the float32 partials (the normalized
    latent sum ``(B, H, r)`` and its log-sum-exp), which are combined over
    the ranks as B6's are (``_combine_over_model``); each rank then
    applies its heads' ``W^UV`` and ``wo`` rows: the partial sum."""
    mc = cfg.mla
    r = mc.kv_lora_rank
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    q_lat, q_pe = MLA.absorbed_query(p, h, n_heads, mc, positions,
                                     cfg.rope_theta, cfg.norm_eps)
    qa = SH.model_all(torch.cat([q_lat, q_pe], -1), grid, 1)
    n = max(0, min(cache["c"].shape[1], pos + 1 - first))
    o, lse = MLA.latent_partials(qa[..., :r], qa[..., r:],
                                 cache["c"][:, :n], cache["pe"][:, :n],
                                 (mc.qk_nope_dim + mc.qk_rope_dim) ** -0.5)
    o_lat = _combine_over_model(o, lse, grid)
    q0 = SH.head_range(cfg.n_heads, grid)[0]
    return MLA.absorbed_output(p, o_lat[:, q0:q0 + n_heads].to(h.dtype),
                               n_heads, mc)


def _moe(blk: Block, h: torch.Tensor, cfg: ArchConfig, aux: dict | None,
         groups: int, grid=None) -> torch.Tensor:
    """A MoE FFN's output; its aux values are added into ``aux``.  On one
    device every dispatch is ``apply_moe`` (the reference's
    ``dispatch="ep_shardmap"`` falls back to it there,
    ``repro/models/lm/moe.py:146-154``).  On a grid the config's
    ``dispatch`` chooses: ``ep_shardmap`` is ``apply_moe_ep`` where
    ``launch.sharding.moe_expert_parallel`` allows it; anything else (or
    a fallback) routes the global tokens, as GSPMD runs ``apply_moe``
    (``apply_moe_global``)."""
    if grid is not None:
        if groups != 1:
            raise ValueError("route groups on a grid are not supported")
        if SH.moe_expert_parallel(cfg, grid):
            out, layer_aux = MOE.apply_moe_ep(blk.moe, h, cfg.moe, grid)
        else:
            out, layer_aux = MOE.apply_moe_global(blk.moe, h, cfg.moe, grid)
    else:
        out, layer_aux = MOE.apply_moe(blk.moe, h, cfg.moe, groups)
    if aux is not None:
        for name, v in layer_aux.items():
            aux[name] = aux[name] + v if name in aux else v
    return out


def _rglru_local(p, cfg: ArchConfig, grid):
    """The R layer's leaves on the rank and the gather of the conv output
    its gate products take: on a grid with a ``model`` axis the rank's
    channels (column blocks of ``w_x``, ``w_gate_in``, ``w_rec_gate``,
    ``w_in_gate``, row block of ``w_out``; the replicated ``conv_w``,
    ``conv_b`` and ``lam`` enter through ``f`` and are sliced to them, so
    their gradients sum over ``model``), the gate products fed the conv
    output of every channel (``launch.sharding.model_gather``: its
    backward reduce-scatters).  On one device the leaves and ``None``."""
    if SH.model_size(grid) == 1:
        return p, None
    c0, c1 = SH.head_range(cfg.rglru.lru_width, grid)
    out = dict(p)
    for k in ("conv_w", "conv_b", "lam"):
        out[k] = SH.tp_copy(p[k], grid)[..., c0:c1]
    return out, lambda xw: SH.model_gather(xw, grid, -1)


def _ssd_heads(cfg: ArchConfig, grid) -> tuple[int, int, int, int]:
    """``(heads, first head, first group, groups)`` of the rank's SSD heads
    over ``model`` and the B/C groups they read."""
    s = cfg.ssm
    total = s.expand * cfg.d_model // s.head_dim
    h0, h1 = SH.head_range(total, grid)
    hpg = total // s.n_groups
    g0 = h0 // hpg
    return h1 - h0, h0, g0, (h1 - 1) // hpg + 1 - g0


def _ssd_local(p, cfg: ArchConfig, grid):
    """The D layer's leaves on the rank and its gated norm's reduction: on
    a grid with a ``model`` axis the rank's heads.  The fused ``w_in``
    ``[z | x | B | C | dt]`` is gathered over ``model`` (its column block
    does not fall on head boundaries) and re-cut to the heads' ``z``,
    ``x`` and ``dt`` columns and their groups' ``B`` and ``C``; the
    replicated ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``
    and ``out_norm`` enter through ``f`` and are sliced to the rank's
    channels and heads; ``w_out``'s row block holds the heads' channels.
    The norm over the whole ``d_inner`` sums its squares over ``model``
    (``launch.sharding.tp_sum``).  On one device the leaves and
    ``None``."""
    if SH.model_size(grid) == 1:
        return p, None
    s = cfg.ssm
    hd, n = s.head_dim, s.state_dim
    d = s.expand * cfg.d_model
    total, gn = d // hd, s.n_groups * s.state_dim
    nh, h0, g0, ng = _ssd_heads(cfg, grid)
    heads = (h0 * hd, (h0 + nh) * hd)      # the heads' channels of d_inner
    groups = (g0 * n, (g0 + ng) * n)       # their groups' of B and of C

    def cols(w, *parts):
        """The columns ``base + lo … base + hi - 1`` of each ``(base, (lo,
        hi))``, side by side."""
        return torch.cat([w[..., b + lo:b + hi] for b, (lo, hi) in parts],
                         -1)

    w_in = SH.model_gather(p["w_in"], grid, 1, 2 * d + 2 * gn + total)
    out = dict(p)
    out["w_in"] = cols(w_in, (0, heads), (d, heads), (2 * d, groups),
                       (2 * d + gn, groups), (2 * d + 2 * gn, (h0, h0 + nh)))
    for k in ("conv_w", "conv_b"):
        out[k] = cols(SH.tp_copy(p[k], grid), (0, heads), (d, groups),
                      (d + gn, groups))
    for k in ("a_log", "dt_bias", "d_skip"):
        out[k] = SH.tp_copy(p[k], grid)[h0:h0 + nh]
    out["out_norm"] = SH.tp_copy(p["out_norm"], grid)[heads[0]:heads[1]]
    return out, (lambda ss: SH.tp_sum(ss, grid), d)


def _block_forward(blk: Block, x: torch.Tensor, cfg: ArchConfig, mode: str,
                   cache: dict, positions: torch.Tensor, pos: int | None,
                   img: torch.Tensor | None, aux: dict | None = None,
                   groups: int = 1, grid=None) -> torch.Tensor:
    """One layer; fills (prefill) or extends (decode) ``cache`` (none in
    training) and adds a MoE FFN's aux values into ``aux``.  Returns the
    new residual stream.  On a grid, ``blk`` holds the weights gathered
    over the batch axes (``_gathered_block``) and every mixer and the MLP
    are tensor-parallel over ``model``: Megatron's ``f`` in, the rank's
    heads or channels, the row-parallel product's partial sums reduced by
    ``g`` (both the identity on one device or without a ``model``
    axis)."""
    eps = cfg.norm_eps
    h = L.rms_norm(x, blk.pre_norm, eps)
    if blk.kind in ("G", "L"):
        x = x + SH.tp_reduce(_attention(blk, h, cfg, mode, cache, positions,
                                        pos, grid), grid)
    elif blk.kind == "M":
        x = x + SH.tp_reduce(_latent_attention(blk, h, cfg, mode, cache,
                                               positions, pos, grid), grid)
    elif blk.kind == "X":
        x = x + SH.tp_reduce(_cross_attention(blk, h, cfg, mode, cache, img,
                                              grid), grid)
    elif blk.kind == "R":
        p, gather = _rglru_local(blk.rglru, cfg, grid)
        hr = SH.tp_copy(h, grid)
        if mode == "train":
            o = RG.rglru_forward(p, hr, cfg.rglru, gather=gather)
        else:
            if mode == "decode":
                o, rec, conv = RG.rglru_decode_step(
                    p, hr, cfg.rglru, rec_state=cache["rec"],
                    conv_state=cache["conv"], gather=gather)
            else:
                o, rec, conv = RG.rglru_forward(p, hr, cfg.rglru,
                                                return_state=True,
                                                gather=gather)
            # own storage: a prefill's are slices of (B, T, W) activations
            cache["rec"] = rec.contiguous()
            cache["conv"] = conv.to(cache["conv"].dtype).contiguous()
        x = x + SH.tp_reduce(o, grid).to(x.dtype)
    else:
        p, norm = _ssd_local(blk.ssm, cfg, grid)
        hs = SH.tp_copy(h, grid)
        if mode == "train":
            o = SSM.ssd_forward(p, hs, cfg.ssm, cfg.d_model, eps, norm=norm)
        else:
            if mode == "decode":
                o, state, conv = SSM.ssd_decode_step(
                    p, hs, cfg.ssm, cfg.d_model, eps,
                    ssm_state=cache["ssm"], conv_state=cache["conv"],
                    norm=norm)
            else:
                o, state, conv = SSM.ssd_forward(p, hs, cfg.ssm,
                                                 cfg.d_model, eps,
                                                 return_state=True,
                                                 norm=norm)
            cache["ssm"] = state.to(cache["ssm"].dtype)
            cache["conv"] = conv.to(cache["conv"].dtype).contiguous()
        x = x + SH.tp_reduce(o, grid).to(x.dtype)
    if blk.ffn == "dense":
        hf = SH.tp_copy(L.rms_norm(x, blk.ffn_norm, eps), grid)
        x = x + SH.tp_reduce(L.apply_mlp(blk.mlp, hf), grid)
    elif blk.ffn == "moe":
        hf = L.rms_norm(x, blk.ffn_norm, eps)
        x = x + _moe(blk, hf, cfg, aux, groups, grid)
    return x


class _Lookup(torch.autograd.Function):
    """``weight[ids]`` whose backward sums each id's rows in a fixed order:
    the one-hot product ``onehot(ids)ᵀ @ grad`` (a cuBLAS product, which
    repeats bit for bit), where torch's own index backward accumulates
    with float atomics on CUDA and would not repeat."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return weight[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        flat = ids.reshape(-1, 1)
        onehot = grad.new_zeros((flat.shape[0], ctx.rows)).scatter_(
            1, flat, 1.0)
        return onehot.T @ grad.reshape(flat.shape[0], -1), None


def _lookup(weight: torch.Tensor, ids: torch.Tensor, lo: int, split: bool
            ) -> torch.Tensor:
    """The rows of ``weight`` for ``ids``; with ``split``, ``weight`` is a
    vocabulary shard (ids ``lo`` on) and an id another shard owns gives a
    zero row (its gradient then zero, added to row 0)."""
    if not split:
        return _Lookup.apply(weight, ids)
    local = ids - lo
    own = (local >= 0) & (local < weight.shape[0])
    rows = _Lookup.apply(weight, torch.where(own, local, 0))
    return torch.where(own[..., None], rows, 0.0)


def _embed(model: Decoder, tokens: torch.Tensor, grid=None) -> torch.Tensor:
    """Token ids ``(B, T)`` (``(B, T, K)`` with K codebooks, whose
    embeddings are summed) → ``(B, T, D)``.  On a grid the table is
    gathered over the batch axes and, with a ``model`` axis, split by
    vocabulary: each rank looks up the ids in its range and the ranks'
    rows are summed (``g``: the sum has one nonzero term a token, so it
    is the row itself)."""
    tokens = tokens.long()
    weight = _over_batch(model, "embed", grid)
    split = SH.model_line(grid) is not None
    lo = SH.model_index(grid) * weight.shape[-2]
    if model.cfg.n_codebooks > 1:
        x = _lookup(weight[0], tokens[..., 0], lo, split)
        for k in range(1, model.cfg.n_codebooks):
            x = x + _lookup(weight[k], tokens[..., k], lo, split)
    else:
        x = _lookup(weight, tokens, lo, split)
    x = SH.tp_reduce(x, grid)
    if model.cfg.scale_embed:
        x = x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _over_batch(model, name: str, grid) -> torch.Tensor:
    """Weight ``name`` of ``model`` (a decoder or its view) gathered over
    the batch axes that shard it (FSDP), or itself on one device."""
    w = getattr(model, name)
    if grid is None:
        return w
    return SH.gather_leaf(w, model.specs[name], grid, SH.batch_axes(grid))


def _image_tokens(model, img: torch.Tensor, grid) -> torch.Tensor:
    """Image embeddings ``(B, n, d_image)`` projected to ``(B, n, D)``:
    ``img_proj``'s column block gives the rank ``D / m`` channels, which
    are gathered over ``model`` (``tp_gather``: each X layer takes them
    through ``f``, so the gradient reaching the gather is whole and it
    keeps the rank's block)."""
    out = img @ _over_batch(model, "img_proj", grid)
    line = SH.model_line(grid)
    if line is None or out.shape[-1] == model.cfg.d_model:
        return out
    return SH.on_line(runtime.tp_gather, out, line, out.dim())


def head_of(model, grid=None) -> torch.Tensor:
    """The unembedding ``(D, V)`` (``(K, D, V)``): the head, or the
    embedding's transpose when they are tied.  On a grid, gathered over
    the batch axes: the rank's vocabulary shard with a ``model`` axis."""
    w = _over_batch(model, "lm_head" if model.lm_head is not None
                    else "embed", grid)
    return w if model.lm_head is not None else w.transpose(-1, -2)


def logits_of(x: torch.Tensor, head: torch.Tensor,
              codebooks: int) -> torch.Tensor:
    """``x`` ``(B, T, D)`` against ``head`` → ``(B, T, V)`` (``(B, T, K,
    V)``)."""
    if codebooks > 1:
        return torch.einsum("btd,kdv->btkv", x, head)
    return x @ head


def unembed(model: Decoder, x: torch.Tensor, grid=None) -> torch.Tensor:
    """Hidden states ``(B, T, D)`` → logits ``(B, T, V)`` (``(B, T, K,
    V)`` with K codebooks).  On a grid the rank's vocabulary shard's
    logits are gathered over ``model`` into the whole vocabulary (for
    serving; the training loss keeps them split)."""
    logits = logits_of(x, head_of(model, grid), model.cfg.n_codebooks)
    spec = (None,) * (logits.dim() - 1) + ("model",)
    return SH.gather_full(logits, spec, grid)


class CastDecoder:
    """A decoder's weights cast to a config's compute dtype inside the
    graph (``cast_params``): the attributes the forward passes read
    (``cfg``, ``embed``, ``blocks`` with each layer's ``kind``, ``ffn``
    and leaves, ``final_norm``, ``lm_head``, ``img_proj``, ``device``,
    ``dtype``), the mixer's and FFN's leaves as plain dicts.  A weight
    already in that dtype is the weight itself."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)


def _cast(x, dtype: torch.dtype):
    if isinstance(x, (dict, nn.ParameterDict)):
        return {k: _cast(v, dtype) for k, v in x.items()}
    return None if x is None else x.to(dtype)


def cast_params(model, cfg: ArchConfig | None = None) -> CastDecoder:
    """The reference's ``cast_params``: ``model``'s weights in the compute
    dtype of ``cfg`` (default the model's), as differentiable casts of the
    master weights, so their gradients arrive in the masters' float32.
    ``cfg`` may differ from the model's in its numeric and execution
    fields (compute dtype, remat, chunks), not in its layers.  A
    ``CastDecoder`` with that config is returned as it is.  A rank's
    sharded decoder's view carries its blocks' specs (``specs``, by
    weight name) and each block view its ``index``."""
    cfg = cfg or model.cfg
    if isinstance(model, CastDecoder):
        if model.cfg != cfg:
            raise ValueError("a CastDecoder runs its own config")
        return model
    if make_plan(cfg).layers() != make_plan(model.cfg).layers():
        raise ValueError(f"{cfg.name}'s layers are not the model's "
                         f"({model.cfg.name})")
    ct = L.dtype_of(cfg.compute_dtype)
    blocks = []
    for i, blk in enumerate(model.blocks):
        leaves = {n: _cast(p, ct) for n, p in
                  blk.named_parameters(recurse=False)}
        leaves.update({n: _cast(d, ct) for n, d in blk.named_children()})
        blocks.append(CastDecoder(kind=blk.kind, ffn=blk.ffn, index=i,
                                  **leaves))
    return CastDecoder(cfg=cfg, embed=_cast(model.embed, ct), blocks=blocks,
                       final_norm=_cast(model.final_norm, ct),
                       lm_head=_cast(model.lm_head, ct),
                       img_proj=_cast(model.img_proj, ct),
                       device=model.device, dtype=ct,
                       specs=getattr(model, "shard_specs", None),
                       grid_shape=getattr(model, "grid_shape", None))


_BLOCK_FIELDS = ("kind", "ffn", "index")


def _gathered_block(blk: CastDecoder, specs: dict, grid, ep: bool
                    ) -> CastDecoder:
    """A block view whose weights are gathered over the batch axes that
    shard them (FSDP, on use: under remat the backward gathers them
    again, and the gathers' backwards reduce-scatter the gradients), the
    expert banks left as they are under the expert-parallel dispatch
    (``ep``).  It takes the specs, not the decoder's view: a checkpointed
    layer that held the view would keep every layer's weights alive until
    the last layer's backward.  On one device (``grid`` ``None``) the
    block itself."""
    if grid is None:
        return blk
    prefix = f"blocks.{blk.index}."
    leaves = {k: _gathered(v, prefix + k, specs, grid, ep)
              for k, v in vars(blk).items() if k not in _BLOCK_FIELDS}
    return CastDecoder(kind=blk.kind, ffn=blk.ffn, index=blk.index, **leaves)


def _gathered(x, name: str, specs: dict, grid, ep: bool):
    """A leaf (or a dict of leaves) gathered over the batch axes that
    shard it.  (A module function: a recursive closure would hold the
    step's weights in a reference cycle until the garbage collector ran.)"""
    if isinstance(x, dict):
        return {k: _gathered(v, f"{name}.{k}", specs, grid, ep)
                for k, v in x.items()}
    axes = SH.gather_axes_of(name, specs[name], grid, ep)
    return SH.gather_leaf(x, specs[name], grid, axes) if axes else x


def _grid_of(model):
    """The active grid, checked against the blocks ``model`` (a decoder or
    its view) holds, or ``None`` on one device."""
    grid = SH.active_mesh()
    if grid is None:
        return None
    held = getattr(model, "grid_shape", None)
    if held != dict(grid.shape):
        raise ValueError(f"a grid {dict(grid.shape)} is active but the "
                         f"decoder holds blocks for {held or 'one device'}")
    SH.check_supported(model.cfg, grid)
    return grid


def forward_train(model, tokens: torch.Tensor,
                  img: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """The training forward, the reference's (``model.py:473-486``):
    ``tokens`` ``(B, T)`` (``(B, T, K)`` with K codebooks) →
    final-normed hidden states ``(B, T, D)`` (the chunked loss unembeds
    them) and the aux dict: a MoE arch's ``moe_aux_loss``,
    ``moe_drop_frac`` and ``moe_max_load`` summed over its MoE layers, in
    depth order (the reference's ``acc0`` sum), else empty.  An arch with
    cross-attention takes ``img``, ``(B, n_image, d_image)`` image
    embeddings, projected by ``img_proj``; without it, or with ``img``
    for another arch, it raises ``ValueError``.  ``model`` is a decoder
    (cast here by ``cast_params``) or a ``CastDecoder``, whose config the
    forward runs.  Every layer runs in "train" mode: no caches,
    ``chunked_causal_attention``; with ``cfg.remat`` each layer of a
    scanned group runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its scan body, nothing saved; the layer's aux
    values are outputs of the checkpointed call, so the recompute adds
    nothing twice), the unrolled head and tail layers do not.

    Under ``launch.sharding.mesh_context(grid)`` ``model`` is a rank's
    sharded decoder (``init_train_params(..., grid=)``) and ``tokens``
    its rows: each layer gathers its weights over the batch axes inside
    the checkpointed call, every mixer and MLP runs tensor-parallel over
    ``model`` (the rank's heads or channels, ``_block_forward``), the
    embedding by vocabulary shard, a MoE FFN by the config's dispatch;
    the hidden states are the rank's rows, replicated over ``model``, and
    the aux values global."""
    cfg = model.cfg
    if cfg.cross_attn_every and img is None:
        raise ValueError(f"{cfg.name} cross-attends to image tokens: "
                         f"training needs img (B, n_image, d_image)")
    if img is not None and not cfg.cross_attn_every:
        raise ValueError(f"{cfg.name} does not cross-attend: no img")
    view = cast_params(model)
    grid = _grid_of(view)
    x = _embed(view, tokens, grid)
    positions = torch.arange(tokens.shape[1], device=view.device)
    if img is not None:
        img = _image_tokens(view, img.to(x.dtype), grid)
    scanned = make_plan(cfg).scanned()
    specs = view.specs
    ep = SH.moe_expert_parallel(cfg, grid)

    def layer(x, blk):
        layer_aux = {}
        blk = _gathered_block(blk, specs, grid, ep)
        x = _block_forward(blk, x, cfg, "train", None, positions, None,
                           img, layer_aux, grid=grid)
        return x, layer_aux

    aux = {}
    for i, blk in enumerate(view.blocks):
        if cfg.remat and i in scanned:
            x, layer_aux = checkpoint(layer, x, blk, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, layer_aux = layer(x, blk)
        for name, v in layer_aux.items():
            aux[name] = aux[name] + v if name in aux else v
    return L.rms_norm(x, view.final_norm, cfg.norm_eps), aux


def forward_prefill(model: Decoder, tokens: torch.Tensor, max_len: int,
                    img: torch.Tensor | None = None, *,
                    aux: dict | None = None, route_groups: int = 1
                    ) -> tuple[torch.Tensor, list[dict]]:
    """``tokens`` ``(B, T)`` (``(B, T, K)`` with K codebooks) → the
    final-normed last hidden state ``(B, 1, D)`` and caches of ``max_len``
    slots holding positions ``0..T-1``.  An arch with cross-attention
    takes ``img``, ``(B, n_image, d_image)`` image embeddings.  The MoE
    layers' aux values, summed over the layers, are added into ``aux``;
    with ``route_groups`` > 1 the B rows form that many equal groups,
    each routed to the experts on its own (the aux values then
    ``(route_groups,)``).  Under ``launch.sharding.mesh_context(grid)``
    ``model`` is a rank's sharded decoder and ``tokens`` its rows: the
    caches hold those rows and the rank's part of each leaf
    (``init_caches``), each layer gathers its weights over the batch
    axes, and the attention kinds run B6 on the rank's heads."""
    cfg = model.cfg
    b, t = tokens.shape[:2]
    grid = _grid_of(model)
    if grid is not None:
        model = cast_params(model)
    caches = init_caches(cfg, b, max_len, device=model.device,
                         dtype=model.dtype, grid=grid)
    x = _embed(model, tokens, grid)
    positions = torch.arange(t, device=model.device)
    if img is not None and model.img_proj is not None:
        img = _image_tokens(model, img.to(x.dtype), grid)
    ep = SH.moe_expert_parallel(cfg, grid)
    specs = None if grid is None else model.specs
    for blk, cache in zip(model.blocks, caches):
        blk = _gathered_block(blk, specs, grid, ep)
        x = _block_forward(blk, x, cfg, "prefill", cache, positions, None,
                           img, aux, route_groups, grid)
    x = L.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return x, caches


def forward_decode(model: Decoder, tokens: torch.Tensor, pos: int,
                   caches: list[dict], *, aux: dict | None = None,
                   route_groups: int = 1) -> tuple[torch.Tensor, list[dict]]:
    """``tokens`` ``(B, 1)`` (``(B, 1, K)``) at position ``pos`` against
    ``caches`` → logits ``(B, 1, V)`` (``(B, 1, K, V)``); the KV and
    latent caches gain slot ``pos`` in place, the recurrent leaves are
    replaced, and the caches are returned.  ``aux`` and ``route_groups``
    are ``forward_prefill``'s.  Under a grid (``forward_prefill``'s) the
    logits cover the whole vocabulary; a cache laid by length makes the
    attention's decode sequence-parallel (B6's partials on the rank's
    shard, combined over ``model``)."""
    cfg = model.cfg
    pos = int(pos)
    grid = _grid_of(model)
    if grid is not None:
        model = cast_params(model)
    x = _embed(model, tokens, grid)
    positions = torch.full((1,), pos, dtype=torch.int32, device=model.device)
    ep = SH.moe_expert_parallel(cfg, grid)
    specs = None if grid is None else model.specs
    for blk, cache in zip(model.blocks, caches):
        blk = _gathered_block(blk, specs, grid, ep)
        x = _block_forward(blk, x, cfg, "decode", cache, positions, pos,
                           None, aux, route_groups, grid)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed(model, x, grid), caches
