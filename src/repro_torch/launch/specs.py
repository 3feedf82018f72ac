"""Input shapes and layouts for every (arch × shape) cell (port of
``repro.launch.specs``).

The reference builds weak-typed ``ShapeDtypeStruct`` stand-ins with
``jax.eval_shape``; the port builds tensors on the ``meta`` device, which
allocate nothing.  Per-shape layout:

* ``train_4k`` / ``prefill_32k`` / ``decode_32k`` — the batch over
  ``(pod, data)``, TP over ``model``, the weights FSDP×TP
  (``launch.sharding``'s rules);
* ``long_500k`` (batch 1) — the batch cannot be split, so a KV cache or
  recurrent state splits its own parallel axis: the cache length over
  ``data`` (sequence parallelism for decode), heads or state width over
  ``model``.

The port's caches are a list of per-layer dicts (``model.init_caches``),
its weights are named and not stacked on a group axis: every rule
addresses a leaf's trailing dims and pads the leading ones, so a spec
here is the reference's without the stacked axis.  Layouts are tuples
of per-dimension axis names (``launch.sharding.Spec``).

The grid's serving caches (``model.init_caches(grid=)``) follow
``_cache_leaf_spec``'s blocks, with three differences where a rank holds
less than the reference's block: a cache length that ``model`` does not
divide is still cut, ``ceil(L / m)`` slots a rank
(``launch.sharding.length_slots``; the reference replicates it); the R
and D conv caches hold the rank's channels (replicated there); the X
image caches of key/value heads ``model`` does not divide hold the heads
the rank's query heads read (replicated there).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import (Spec, fit_spec,
                                         make_param_shardings)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# microbatch counts of the reference's train cells
TRAIN_MICROBATCHES = {
    "gemma3-27b": 8, "granite-34b": 16, "stablelm-3b": 4, "qwen3-32b": 16,
    "deepseek-v2-236b": 16, "moonshot-v1-16b-a3b": 8,
    "recurrentgemma-2b": 4, "mamba2-1.3b": 4,
    "llama-3.2-vision-11b": 8, "musicgen-medium": 4,
}

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def token_shape(cfg: ArchConfig, batch: int, seq: int) -> tuple[int, ...]:
    """``(batch, seq)``, or ``(batch, seq, K)`` with K codebooks."""
    if cfg.n_codebooks > 1:
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def batch_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Meta tensors of a cell's data batch: int32 ``tokens`` (and
    ``targets`` for training), float32 ``image_embeds`` for a
    cross-attending arch; a decode cell's one new token, its int32
    ``pos`` and the caches of a ``seq``-long context."""
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import model as M
    info = SHAPES[shape_name]
    b, t = info["batch"], info["seq"]
    if info["kind"] in ("train", "prefill"):
        out = {"tokens": _meta(token_shape(cfg, b, t), torch.int32)}
        if info["kind"] == "train":
            out["targets"] = _meta(token_shape(cfg, b, t), torch.int32)
        if cfg.cross_attn_every:
            out["image_embeds"] = _meta((b, cfg.n_image_tokens, cfg.d_image),
                                        torch.float32)
        return out
    caches = M.init_caches(cfg, b, t, device=META,
                           dtype=L.dtype_of(cfg.compute_dtype))
    return {"tokens": _meta(token_shape(cfg, b, 1), torch.int32),
            "pos": _meta((), torch.int32), "caches": caches}


def param_and_opt_specs(cfg: ArchConfig, with_opt: bool,
                        moments_bf16: bool = False):
    """The weights (a meta decoder in the reference's ``param_dtype``) and,
    with ``with_opt``, the AdamW state's meta tensors."""
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import model as M
    params = M.init_params(cfg, 0, device=META,
                           dtype=L.dtype_of(cfg.param_dtype))
    if not with_opt:
        return params, None
    mdt = torch.bfloat16 if moments_bf16 else torch.float32
    moments = {n: _meta(p.shape, mdt) for n, p in params.named_parameters()}
    return params, {"m": moments, "v": dict(moments),
                    "step": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def _batch_axes(mesh):
    ax = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return ax if len(ax) > 1 else ax[0]


def _n_batch_shards(mesh) -> int:
    n = 1
    for name in ("pod", "data"):
        if name in mesh.axis_names:
            n *= mesh.shape[name]
    return n


def _cache_leaf_spec(name: str, shape, cfg: ArchConfig, mesh) -> Spec:
    """The layout of a cache leaf by its name (the reference's rules,
    addressing the trailing dims): a KV cache's heads over ``model`` when
    they divide, else its length (flash-decode sequence parallelism); the
    batch over the batch axes when it divides, else the length over
    ``data``; the latent, SSM, recurrent and conv states alike.  Where the
    grid's caches hold less than this block, the module docstring says
    so."""
    bsh = _n_batch_shards(mesh)
    ba = _batch_axes(mesh)
    model_n = mesh.shape["model"]

    def model_if(dim: int):
        return "model" if dim % model_n == 0 else None

    rank = {"k": 4, "v": 4, "xk": 4, "xv": 4, "c": 3, "pe": 3,
            "ssm": 4, "rec": 2, "conv": 3}.get(name)
    if rank is None or len(shape) < rank:
        return (None,) * len(shape)
    ts = tuple(shape[-rank:])
    batch_ok = ts[0] % bsh == 0

    if name in ("k", "v", "xk", "xv"):           # (B, Hkv, L, hd)
        h_ax = model_if(ts[1])
        l_ax = model_if(ts[2]) if (h_ax is None and name in ("k", "v")) \
            else None
        if batch_ok:
            tail = (ba, h_ax, l_ax, None)
        else:
            both = tuple(a for a in ("data", "model")
                         if a in mesh.axis_names)
            l_axes = both if (h_ax is None and
                              ts[2] % (mesh.shape["data"] * model_n) == 0) \
                else "data"
            tail = (None, h_ax, l_axes, None)
    elif name in ("c", "pe"):                    # (B, L, r)
        tail = ((ba, model_if(ts[1]), None) if batch_ok
                else (None, "data", None))
    elif name == "ssm":                          # (B, H, P, N)
        tail = ((ba, model_if(ts[1]), None, None) if batch_ok
                else (None, model_if(ts[1]), None, None))
    elif name == "rec":                          # (B, W)
        tail = (ba, model_if(ts[1])) if batch_ok else (None, model_if(ts[1]))
    else:                                        # conv: (B, K-1, C)
        tail = ((ba, None, None) if batch_ok
                else (None, None, model_if(ts[2])))
    pad = (None,) * (len(shape) - rank)
    return fit_spec(pad + tail, tuple(shape), mesh)


def make_batch_shardings(batch_spec: dict, cfg: ArchConfig, mesh) -> dict:
    """The layout of every leaf of ``batch_specs``: caches by
    ``_cache_leaf_spec``, ``pos`` replicated, tokens, targets and image
    embeddings over the batch axes when their rows divide."""
    ba = _batch_axes(mesh)
    bsh = _n_batch_shards(mesh)

    def leaf(name, x):
        if name == "pos":
            return ()
        if x.shape[0] % bsh == 0:
            return (ba,) + (None,) * (x.dim() - 1)
        return (None,) * x.dim()

    out = {k: leaf(k, v) for k, v in batch_spec.items() if k != "caches"}
    if "caches" in batch_spec:
        out["caches"] = [{k: _cache_leaf_spec(k, v.shape, cfg, mesh)
                          for k, v in layer.items()}
                         for layer in batch_spec["caches"]]
    return out


def make_opt_shardings(mesh, opt_spec, param_shardings: dict) -> dict:
    """AdamW's moments take their weights' layouts; the step is
    replicated."""
    return {"m": param_shardings, "v": param_shardings, "step": ()}


def cell_shardings(cfg: ArchConfig, shape_name: str, mesh,
                   moments_bf16: bool = False):
    """``(layouts, specs)`` of a cell's step: ``((params, opt, batch),
    (params, opt, batch))`` for training, ``((params, batch), (params,
    batch))`` otherwise; the layouts are by weight name and by batch
    leaf, the specs meta tensors."""
    info = SHAPES[shape_name]
    with_opt = info["kind"] == "train"
    params, opt = param_and_opt_specs(cfg, with_opt, moments_bf16)
    p_sh = make_param_shardings(mesh, params)
    batch = batch_specs(cfg, shape_name)
    b_sh = make_batch_shardings(batch, cfg, mesh)
    if with_opt:
        o_sh = make_opt_shardings(mesh, opt, p_sh)
        return (p_sh, o_sh, b_sh), (params, opt, batch)
    return (p_sh, b_sh), (params, batch)
