"""train_step / serve_step builders on torch (port of
``repro.train.step``): the chunked vocab loss, gradient accumulation,
mixed precision and remat.

* **Chunked cross-entropy**: per chunk of positions, logits →
  logsumexp → target logit, each chunk under ``torch.utils.checkpoint``,
  so no ``(B, chunk, V)`` logits outlive their chunk.
* **Gradient accumulation**: the global batch splits into
  ``num_microbatches`` row blocks in the reference's order; their
  gradients accumulate in the float32 masters' ``.grad`` (``g1 + g2 +
  ...``, the reference's scan sum) and are divided by the count, and so
  are the metrics (a MoE arch's ``moe_aux_loss`` and ``moe_drop_frac``
  too, the reference's ``met0``).  Each microbatch routes its own tokens
  to the experts, at ``capacity_for`` its own token count.
* **MoE aux loss**: the layers' summed load-balance loss is added to the
  cross-entropy (``_loss_fn``, the reference's ``step.py:94-108``).
* **Mixed precision**: ``models.lm.model.cast_params`` casts the float32
  masters to the compute dtype inside the graph; remat is
  ``ArchConfig.remat`` inside ``forward_train``.

The step repeats bit for bit on the card: no backward on its path
accumulates with float atomics.  Two torch ops that do were replaced:
the target logit's gather (``take_along_dim``, whose backward is a
``scatter_add``) is ``_TakeTarget``, whose backward writes each row's one
target with ``scatter_`` (no two writes meet); the embedding's index
backward (``index_put_`` with accumulate) is ``model._Lookup``, a
one-hot product.  The MoE dispatch and combine have gathers for
backwards (``moe._Dispatch``, ``moe._Combine``), the SSD's head
broadcast is an ``expand``.  Every other backward is cuBLAS products,
fixed-shape reductions, torch's scans and elementwise ops.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import model as M
from repro_torch.optim import OptConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    xent_chunk: int = 512            # sequence positions per loss chunk
    z_loss: float = 1e-4             # logit normalizer regularization
    # "bfloat16" stores the chunk logits in bf16; the logsumexp and the
    # target logit still reduce from one float32 upcast
    xent_logits_dtype: str = "float32"


class _TakeTarget(torch.autograd.Function):
    """``logits.gather(-1, ids[..., None])[..., 0]``; the backward scatters
    each row's gradient to its one target (``scatter_``: no two writes
    meet, so it repeats bit for bit; ``gather``'s own backward is a
    ``scatter_add`` with float atomics on CUDA)."""

    @staticmethod
    def forward(ctx, logits, ids):
        ctx.save_for_backward(ids)
        ctx.shape = logits.shape
        return logits.gather(-1, ids[..., None])[..., 0]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape).scatter_(-1, ids[..., None],
                                                 grad[..., None])
        return out, None


def chunked_xent(hidden: torch.Tensor, params, cfg: ArchConfig,
                 targets: torch.Tensor, chunk: int, z_loss: float,
                 logits_dtype: str = "float32") -> torch.Tensor:
    """Mean cross-entropy over ``(B, T)`` targets (``(B, T, K)`` with K
    codebooks) of ``hidden`` ``(B, T, D)`` without materializing ``(B, T,
    V)`` logits; ``params`` is the decoder or its ``CastDecoder``, cast
    to ``cfg``'s compute dtype (the head the logits come from).

    As the reference: T need not divide ``chunk`` (the sequence is padded
    to whole chunks and the padding masked out of every term); the chunk
    logits are stored in ``logits_dtype``, and the logsumexp and the
    target logit both reduce from one float32 upcast; the z-loss adds
    ``z_loss · lse²``; the sum is divided by ``B·T`` (times K)."""
    b, t, _ = hidden.shape
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    books = cfg.n_codebooks if cfg.n_codebooks > 1 else 1
    pad = n_chunks * chunk - t
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(
            targets, (0, 0) * (targets.dim() - 2) + (0, pad))
    targets = targets.long()
    ldt = M.L.dtype_of(logits_dtype)
    params = M.cast_params(params, cfg)

    def body(h_c, y_c, i):
        logits32 = M.unembed(params, h_c).to(ldt).float()
        lse = torch.logsumexp(logits32, dim=-1)
        tgt = _TakeTarget.apply(logits32, y_c)
        valid = i * chunk + torch.arange(chunk, device=h_c.device) < t
        m = valid.reshape((1, chunk) + (1,) * (lse.dim() - 2))
        return (torch.where(m, lse - tgt, 0.0).sum()
                + z_loss * torch.where(m, torch.square(lse), 0.0).sum())

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(body, hidden[:, sl], targets[:, sl], i,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * t * books)


def _loss_fn(params, cfg: ArchConfig, tc: TrainConfig, batch: dict):
    """``(loss, metrics)`` of ``batch`` under ``cfg``: the weights cast
    once to the compute dtype, ``forward_train`` (with the batch's
    ``image_embeds`` for a cross-attending arch), ``chunked_xent``, plus
    a MoE arch's summed ``moe_aux_loss``; the metrics are ``xent``,
    ``loss`` and, with MoE layers, ``moe_aux_loss`` and
    ``moe_drop_frac`` (the reference's ``step.py:94-108``)."""
    view = M.cast_params(params, cfg)
    hidden, aux = M.forward_train(view, batch["tokens"],
                                  batch.get("image_embeds"))
    loss = chunked_xent(hidden, view, cfg, batch["targets"], tc.xent_chunk,
                        tc.z_loss, logits_dtype=tc.xent_logits_dtype)
    metrics = {"xent": loss}
    if "moe_aux_loss" in aux:
        loss = loss + aux["moe_aux_loss"]
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
        metrics["moe_drop_frac"] = aux["moe_drop_frac"]
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(cfg: ArchConfig, opt: OptConfig,
                    tc: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``, the reference's signature: ``params`` is a trainable
    decoder (``model.trainable``) and ``opt_state`` its
    ``init_opt_state``, both updated in place and returned; ``batch``
    holds the GLOBAL batch, split here into ``tc.num_microbatches`` row
    blocks.  ``metrics`` are float32 tensors on the device: ``xent``,
    ``loss`` (and with MoE layers ``moe_aux_loss`` and ``moe_drop_frac``;
    averaged over the microbatches), ``grad_norm``, ``lr`` and
    ``clip_scale``."""

    def train_step(params, opt_state, batch):
        metrics = accumulate_grads(params, cfg, tc, batch)
        named = dict(params.named_parameters())
        grads = {n: p.grad for n, p in named.items()}
        params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                opt)
        for p in named.values():
            p.grad = None
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def accumulate_grads(params, cfg: ArchConfig, tc: TrainConfig,
                     batch: dict) -> dict:
    """The gradient half of a train step: the batch's microbatch
    gradients summed into the masters' ``.grad`` (cleared first) and
    divided by their count; returns ``_loss_fn``'s metrics averaged over
    the microbatches (summed in order, then divided)."""
    m = tc.num_microbatches
    rows = batch["tokens"].shape[0]
    if rows % m:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{m} microbatches")
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    metrics = {}
    with torch.enable_grad():
        for j in range(m):
            mb = {k: v.chunk(m)[j] for k, v in batch.items()}
            loss, met = _loss_fn(params, cfg, tc, mb)
            loss.backward()
            for k, v in met.items():
                v = v.detach()
                metrics[k] = metrics[k] + v if k in metrics else v
    if m > 1:
        for p in named.values():
            p.grad.div_(m)
        metrics = {k: v / m for k, v in metrics.items()}
    return metrics


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_serve_step(model, mode: str, max_len: int = 0):
    """mode ∈ {prefill, decode}, on ``model`` (a serving or a trainable
    decoder, cast to its compute dtype on every call as the reference
    casts its params; a serving decoder's cast is the decoder itself).

    prefill: ``step(batch{tokens[, image_embeds]})`` → (last-token logits,
             caches)
    decode:  ``step(batch{tokens, pos, caches})`` → (logits, caches)
    """
    if mode == "prefill":
        @torch.no_grad()
        def prefill_step(batch):
            view = M.cast_params(model)
            tokens = batch["tokens"]
            h_last, caches = M.forward_prefill(
                view, tokens, max_len or tokens.shape[1],
                img=batch.get("image_embeds"))
            return M.unembed(view, h_last), caches
        return prefill_step

    if mode == "decode":
        @torch.no_grad()
        def decode_step(batch):
            return M.forward_decode(M.cast_params(model), batch["tokens"],
                                    batch["pos"], batch["caches"])
        return decode_step

    raise ValueError(mode)
