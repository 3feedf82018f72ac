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


def init_params(cfg: ArchConfig, seed: int, *, device,
                dtype: torch.dtype | None = None) -> Decoder:
    """A decoder with random weights drawn on ``device`` from a seeded
    ``torch.Generator``, with the reference's shapes and scales
    (``N(0, 1/D)`` embedding and head, zero norm gains, the recurrent
    blocks' fixed decay inits), in ``dtype`` (default
    ``cfg.compute_dtype``)."""
    check_supported(cfg)
    dtype = dtype or L.dtype_of(cfg.compute_dtype)
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, hd, v = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer(kind: str, ffn: str) -> Block:
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
        return Block(kind, ffn, leaves)

    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    embed = L.normal_weight(books + (v, d), d ** -0.5, g, dtype)
    blocks = [layer(kind, ffn) for kind, ffn in make_plan(cfg).layers()]
    head = (None if cfg.tie_embeddings
            else L.normal_weight(books + (d, v), d ** -0.5, g, dtype))
    img = (L.normal_weight((cfg.d_image, d), cfg.d_image ** -0.5, g, dtype)
           if cfg.cross_attn_every else None)
    return Decoder(cfg, embed, blocks, zeros(d), head, img)


def trainable(model: Decoder) -> Decoder:
    """``model`` (float32 weights) as training's master weights: every
    weight gets ``requires_grad``, in place."""
    if model.dtype != torch.float32:
        raise TypeError(f"master weights are float32, got {model.dtype}")
    return model.requires_grad_(True)


def init_train_params(cfg: ArchConfig, seed: int, *, device) -> Decoder:
    """A trainable decoder: ``init_params``' random weights in float32
    (the reference's ``param_dtype``), drawn on ``device``, with
    ``requires_grad``."""
    return trainable(init_params(cfg, seed, device=device,
                                 dtype=L.dtype_of(cfg.param_dtype)))


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                 device, dtype: torch.dtype) -> dict:
    hd = cfg.resolved_head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("G", "L"):
        shape = (batch, cfg.n_kv_heads, max_len, hd)
        return {"k": zeros(shape), "v": zeros(shape)}
    if kind == "M":
        return {"c": zeros((batch, max_len, cfg.mla.kv_lora_rank)),
                "pe": zeros((batch, max_len, cfg.mla.qk_rope_dim))}
    if kind == "X":
        shape = (batch, cfg.n_kv_heads, cfg.n_image_tokens, hd)
        return {"xk": zeros(shape), "xv": zeros(shape)}
    if kind == "R":
        w = cfg.rglru.lru_width
        return {"rec": zeros((batch, w), torch.float32),
                "conv": zeros((batch, cfg.rglru.conv_width - 1, w))}
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    channels = d_inner + 2 * s.n_groups * s.state_dim
    return {"ssm": zeros((batch, d_inner // s.head_dim, s.head_dim,
                          s.state_dim)),
            "conv": zeros((batch, s.conv_width - 1, channels))}


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device,
                dtype: torch.dtype) -> list[dict]:
    """Zeroed caches, one dict per layer (the module docstring's layout);
    the recurrent ``rec`` state is float32, every other leaf ``dtype``."""
    return [_layer_cache(cfg, kind, batch, max_len, device, dtype)
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


def _attention(blk: Block, h: torch.Tensor, cfg: ArchConfig, mode: str,
               cache: dict, positions: torch.Tensor,
               pos: int | None) -> torch.Tensor:
    """A G or L layer's attention output ``(B, T, Hq·hd)``; fills
    (prefill) or extends (decode) its KV cache in place, or (train) runs
    the chunked attention with no cache."""
    hd = cfg.resolved_head_dim
    theta, window = _theta_window(cfg, blk.kind)
    q, k, v = L.apply_qkv(blk.attn, h, cfg.n_heads, cfg.n_kv_heads, hd,
                          positions, theta, cfg.qk_norm, cfg.norm_eps)
    if mode == "train":
        o = L.chunked_causal_attention(
            q, k, v, window=window, chunk=cfg.attn_chunk,
            softcap=cfg.logit_softcap,
            scores_dtype=L.dtype_of(cfg.attn_scores_dtype))
    elif mode == "decode":
        # in place: the reference's dynamic_update_slice at pos
        cache["k"][:, :, pos] = k[:, :, 0]
        cache["v"][:, :, pos] = v[:, :, 0]
        o = L.decode_attention(q, cache["k"], cache["v"], pos, window=window,
                               softcap=cfg.logit_softcap)
    else:
        o = L.causal_attention(q, k, v, window=window,
                               softcap=cfg.logit_softcap)
        t = k.shape[2]
        cache["k"][:, :, :t] = k
        cache["v"][:, :, :t] = v
    b, t = h.shape[:2]
    return o.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)


def _cross_attention(blk: Block, h: torch.Tensor, cfg: ArchConfig, mode: str,
                     cache: dict, img: torch.Tensor | None) -> torch.Tensor:
    """An X layer's gated cross-attention update: no RoPE and no qk-norm,
    full attention over the image tokens' K/V (projected at prefill and
    kept in the cache; in training projected with no cache and attended
    by ``chunked_causal_attention(causal=False)``, the reference's
    ``model.py:276-292``), gated by ``tanh(xattn_gate)`` (float32,
    cast)."""
    hd, p = cfg.resolved_head_dim, blk.xattn
    b, t = h.shape[:2]
    q = (h @ p["wq"]).reshape(b, t, cfg.n_heads, hd).transpose(1, 2)
    if mode != "decode":
        if img is None:
            raise ValueError(f"{cfg.name} cross-attends to image tokens: "
                             f"{mode} needs img (B, n_image, d_image)")
        n = img.shape[1]
        xk, xv = ((img @ w).reshape(b, n, cfg.n_kv_heads, hd).transpose(1, 2)
                  for w in (p["wk"], p["wv"]))
        if mode == "train":
            o = L.chunked_causal_attention(q, xk, xv, chunk=cfg.attn_chunk,
                                           causal=False)
        else:
            cache["xk"], cache["xv"] = xk.contiguous(), xv.contiguous()
    if mode != "train":
        o = L.cross_attention(q, cache["xk"], cache["xv"])
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)
    gate = torch.tanh(blk.xattn_gate.float()).to(h.dtype)
    return gate * (o @ p["wo"])


def _latent_attention(blk: Block, h: torch.Tensor, cfg: ArchConfig,
                      mode: str, cache: dict, positions: torch.Tensor,
                      pos: int | None) -> torch.Tensor:
    """An M layer's update: at prefill the decompressed attention (B6),
    filling the latent cache; in training the same heads through the
    chunked attention, with no cache; at decode the token's latent and
    rotary key written at slot ``pos`` in place, then the absorbed
    decode."""
    theta, eps = cfg.rope_theta, cfg.norm_eps
    if mode == "train":
        return MLA.mla_attention(
            blk.mla, h, cfg.n_heads, cfg.mla, positions=positions,
            theta=theta, eps=eps, chunk=cfg.attn_chunk,
            scores_dtype=L.dtype_of(cfg.attn_scores_dtype))
    if mode == "prefill":
        return MLA.mla_attention(blk.mla, h, cfg.n_heads, cfg.mla,
                                 positions=positions, theta=theta, eps=eps,
                                 cache=cache)
    c_new, pe_new = MLA.mla_compress(blk.mla, h, positions, theta, eps)
    cache["c"][:, pos] = c_new[:, 0]
    cache["pe"][:, pos] = pe_new[:, 0]
    return MLA.mla_decode_absorbed(blk.mla, h, cfg.n_heads, cfg.mla,
                                   c_cache=cache["c"], pe_cache=cache["pe"],
                                   pos=pos, theta=theta, eps=eps)


def _moe(blk: Block, h: torch.Tensor, cfg: ArchConfig, aux: dict | None,
         groups: int) -> torch.Tensor:
    """A MoE FFN's output; its aux values are added into ``aux``.  The
    reference's ``dispatch="ep_shardmap"`` runs ``apply_moe`` on one
    device (``repro/models/lm/moe.py:148-149``), and so does every
    dispatch here."""
    out, layer_aux = MOE.apply_moe(blk.moe, h, cfg.moe, groups)
    if aux is not None:
        for name, v in layer_aux.items():
            aux[name] = aux[name] + v if name in aux else v
    return out


def _block_forward(blk: Block, x: torch.Tensor, cfg: ArchConfig, mode: str,
                   cache: dict, positions: torch.Tensor, pos: int | None,
                   img: torch.Tensor | None, aux: dict | None = None,
                   groups: int = 1) -> torch.Tensor:
    """One layer; fills (prefill) or extends (decode) ``cache`` (none in
    training) and adds a MoE FFN's aux values into ``aux``.  Returns the
    new residual stream."""
    eps = cfg.norm_eps
    h = L.rms_norm(x, blk.pre_norm, eps)
    if blk.kind in ("G", "L"):
        x = x + _attention(blk, h, cfg, mode, cache, positions, pos) \
            @ blk.attn["wo"]
    elif blk.kind == "M":
        x = x + _latent_attention(blk, h, cfg, mode, cache, positions, pos)
    elif blk.kind == "X":
        x = x + _cross_attention(blk, h, cfg, mode, cache, img)
    elif blk.kind == "R":
        if mode == "train":
            o = RG.rglru_forward(blk.rglru, h, cfg.rglru)
        else:
            if mode == "decode":
                o, rec, conv = RG.rglru_decode_step(
                    blk.rglru, h, cfg.rglru, rec_state=cache["rec"],
                    conv_state=cache["conv"])
            else:
                o, rec, conv = RG.rglru_forward(blk.rglru, h, cfg.rglru,
                                                return_state=True)
            # own storage: a prefill's are slices of (B, T, W) activations
            cache["rec"] = rec.contiguous()
            cache["conv"] = conv.to(cache["conv"].dtype).contiguous()
        x = x + o.to(x.dtype)
    else:
        if mode == "train":
            o = SSM.ssd_forward(blk.ssm, h, cfg.ssm, cfg.d_model, eps)
        else:
            if mode == "decode":
                o, state, conv = SSM.ssd_decode_step(
                    blk.ssm, h, cfg.ssm, cfg.d_model, eps,
                    ssm_state=cache["ssm"], conv_state=cache["conv"])
            else:
                o, state, conv = SSM.ssd_forward(blk.ssm, h, cfg.ssm,
                                                 cfg.d_model, eps,
                                                 return_state=True)
            cache["ssm"] = state.to(cache["ssm"].dtype)
            cache["conv"] = conv.to(cache["conv"].dtype).contiguous()
        x = x + o.to(x.dtype)
    if blk.ffn == "dense":
        hf = L.rms_norm(x, blk.ffn_norm, eps)
        x = x + L.apply_mlp(blk.mlp, hf)
    elif blk.ffn == "moe":
        hf = L.rms_norm(x, blk.ffn_norm, eps)
        x = x + _moe(blk, hf, cfg, aux, groups)
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


def _embed(model: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids ``(B, T)`` (``(B, T, K)`` with K codebooks, whose
    embeddings are summed) → ``(B, T, D)``."""
    tokens = tokens.long()
    if model.cfg.n_codebooks > 1:
        x = _Lookup.apply(model.embed[0], tokens[..., 0])
        for k in range(1, model.cfg.n_codebooks):
            x = x + _Lookup.apply(model.embed[k], tokens[..., k])
    else:
        x = _Lookup.apply(model.embed, tokens)
    if model.cfg.scale_embed:
        x = x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(model: Decoder, x: torch.Tensor) -> torch.Tensor:
    """Hidden states ``(B, T, D)`` → logits ``(B, T, V)`` (``(B, T, K,
    V)`` with K codebooks)."""
    if model.cfg.n_codebooks > 1:
        head = model.lm_head if model.lm_head is not None \
            else model.embed.transpose(-1, -2)
        return torch.einsum("btd,kdv->btkv", x, head)
    head = model.lm_head if model.lm_head is not None else model.embed.T
    return x @ head


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
    ``CastDecoder`` with that config is returned as it is."""
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
    for blk in model.blocks:
        leaves = {n: _cast(p, ct) for n, p in
                  blk.named_parameters(recurse=False)}
        leaves.update({n: _cast(d, ct) for n, d in blk.named_children()})
        blocks.append(CastDecoder(kind=blk.kind, ffn=blk.ffn, **leaves))
    return CastDecoder(cfg=cfg, embed=_cast(model.embed, ct), blocks=blocks,
                       final_norm=_cast(model.final_norm, ct),
                       lm_head=_cast(model.lm_head, ct),
                       img_proj=_cast(model.img_proj, ct),
                       device=model.device, dtype=ct)


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
    nothing twice), the unrolled head and tail layers do not."""
    cfg = model.cfg
    if cfg.cross_attn_every and img is None:
        raise ValueError(f"{cfg.name} cross-attends to image tokens: "
                         f"training needs img (B, n_image, d_image)")
    if img is not None and not cfg.cross_attn_every:
        raise ValueError(f"{cfg.name} does not cross-attend: no img")
    view = cast_params(model)
    x = _embed(view, tokens)
    positions = torch.arange(tokens.shape[1], device=view.device)
    if img is not None:
        img = img.to(x.dtype) @ view.img_proj
    scanned = make_plan(cfg).scanned()

    def layer(x, blk):
        layer_aux = {}
        x = _block_forward(blk, x, cfg, "train", None, positions, None,
                           img, layer_aux)
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
    ``(route_groups,)``)."""
    cfg = model.cfg
    b, t = tokens.shape[:2]
    caches = init_caches(cfg, b, max_len, device=model.device,
                         dtype=model.dtype)
    x = _embed(model, tokens)
    positions = torch.arange(t, device=model.device)
    if img is not None and model.img_proj is not None:
        img = img.to(x.dtype) @ model.img_proj
    for blk, cache in zip(model.blocks, caches):
        x = _block_forward(blk, x, cfg, "prefill", cache, positions, None,
                           img, aux, route_groups)
    x = L.rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return x, caches


def forward_decode(model: Decoder, tokens: torch.Tensor, pos: int,
                   caches: list[dict], *, aux: dict | None = None,
                   route_groups: int = 1) -> tuple[torch.Tensor, list[dict]]:
    """``tokens`` ``(B, 1)`` (``(B, 1, K)``) at position ``pos`` against
    ``caches`` → logits ``(B, 1, V)`` (``(B, 1, K, V)``); the KV and
    latent caches gain slot ``pos`` in place, the recurrent leaves are
    replaced, and the caches are returned.  ``aux`` and ``route_groups``
    are ``forward_prefill``'s."""
    cfg = model.cfg
    pos = int(pos)
    x = _embed(model, tokens)
    positions = torch.full((1,), pos, dtype=torch.int32, device=model.device)
    for blk, cache in zip(model.blocks, caches):
        x = _block_forward(blk, x, cfg, "decode", cache, positions, pos,
                           None, aux, route_groups)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return unembed(model, x), caches
