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

Under ``launch.sharding.mesh_context(grid)`` (a ``runtime.ProcessGrid``
with ``data`` and optionally ``pod`` and ``model`` axes) the same
builders run a rank's share: ``params`` is the rank's sharded decoder
(``model.init_train_params(..., grid=)``) and ``opt_state`` its
``init_opt_state``; the step takes the rank's rows of each microbatch of
the global batch (``sharding.batch_slice``), the loss divides by the
global token count and the vocabulary-parallel ``chunked_xent`` reduces
its max, sum of exponentials and target logit over ``model``, so the
gradients the FSDP gathers reduce-scatter over the batch axes are the
global batch's; weights no batch axis shards have theirs summed after the
backward (``sharding.reduce_replicated_grads``), and AdamW's global norm
counts every weight once (``sharding.sharded_sq_norm``).  The metrics are
the global batch's, the same on every rank.  ``make_serve_step`` takes
the global batch too and returns the global logits, the caches holding
the rank's rows and key/value heads.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as SH
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


def _lse_target(logits32: torch.Tensor, ids: torch.Tensor, grid, lo: int):
    """The logsumexp and the target logit of a rank's vocabulary shard of
    float32 logits (ids ``lo`` on) over ``model``: the max by ``pmax``
    (held constant: the logsumexp does not depend on it), the sum of
    exponentials by ``g``, the target logit from its owner by ``g``."""
    v_loc = logits32.shape[-1]
    m = SH.pmax_over(logits32.detach().amax(-1), grid, ("model",))
    s = torch.exp(logits32 - m[..., None]).sum(-1)
    lse = m + torch.log(SH.tp_reduce(s, grid))
    local = ids - lo
    own = (local >= 0) & (local < v_loc)
    tgt = _TakeTarget.apply(logits32, torch.where(own, local, 0))
    return lse, SH.tp_reduce(torch.where(own, tgt, 0.0), grid)


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
    ``z_loss · lse²``; the sum is divided by ``B·T`` (times K).

    Under a grid ``hidden`` and ``targets`` are the rank's rows and the
    sum is divided by the global count (``B·T`` times the batch shards),
    so the ranks' values add up to the global mean; the head is gathered
    over the batch axes once, and with a ``model`` axis each rank holds a
    vocabulary shard of the logits (``_lse_target``)."""
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
    grid = SH.active_mesh()
    shards, head = SH.batch_shards(grid), M.head_of(params, grid)
    split = SH.model_line(grid) is not None
    lo = SH.model_index(grid) * head.shape[-1]

    def body(h_c, y_c, i, head):
        logits32 = M.logits_of(SH.tp_copy(h_c, grid), head,
                               books).to(ldt).float()
        if split:
            lse, tgt = _lse_target(logits32, y_c, grid, lo)
        else:
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
                                   head, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * t * books * shards)


def _loss_fn(params, cfg: ArchConfig, tc: TrainConfig, batch: dict):
    """``(loss, metrics)`` of ``batch`` under ``cfg``: the weights cast
    once to the compute dtype, ``forward_train`` (with the batch's
    ``image_embeds`` for a cross-attending arch), ``chunked_xent``, plus
    a MoE arch's summed ``moe_aux_loss``; the metrics are ``xent``,
    ``loss`` and, with MoE layers, ``moe_aux_loss`` and
    ``moe_drop_frac`` (the reference's ``step.py:94-108``).

    Under a grid ``batch`` is the rank's rows; the returned loss is the
    rank's share of the objective (its cross-entropy terms over the
    global count, plus the global aux loss over the batch shards, which
    every rank computes), the metrics the global batch's."""
    view = M.cast_params(params, cfg)
    hidden, aux = M.forward_train(view, batch["tokens"],
                                  batch.get("image_embeds"))
    loss = chunked_xent(hidden, view, cfg, batch["targets"], tc.xent_chunk,
                        tc.z_loss, logits_dtype=tc.xent_logits_dtype)
    grid = SH.active_mesh()
    xent = SH.psum_over(loss.detach(), grid, SH.batch_axes(grid))
    metrics = {"xent": xent, "loss": xent}
    if "moe_aux_loss" in aux:
        loss = loss + aux["moe_aux_loss"] / SH.batch_shards(grid)
        metrics["moe_aux_loss"] = aux["moe_aux_loss"].detach()
        metrics["moe_drop_frac"] = aux["moe_drop_frac"].detach()
        metrics["loss"] = xent + metrics["moe_aux_loss"]
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
    ``clip_scale``.  ``grads_out``, if given, receives the step's
    gradients by name (before the update; the rank's blocks on a grid).
    Under a grid (the module docstring) ``params`` and
    ``opt_state`` are the rank's and ``batch`` the global batch; an
    arch or layout the grid cannot run raises ``ValueError`` before any
    work."""

    def train_step(params, opt_state, batch, grads_out=None):
        grid = SH.active_mesh()
        if grid is not None:
            SH.check_model_grid(params, grid)
            SH.check_supported(cfg, grid)
        metrics = accumulate_grads(params, cfg, tc, batch)
        if grid is not None:
            SH.reduce_replicated_grads(params, grid)
        named = dict(params.named_parameters())
        grads = {n: p.grad for n, p in named.items()}
        if grads_out is not None:
            grads_out.update(grads)
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
    grid = SH.active_mesh()
    if grid is not None:
        batch = {k: SH.batch_slice(v, grid, m) for k, v in batch.items()}
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

    Under a grid, ``model`` is a rank's sharded decoder, the batch's
    tokens (and image embeddings) are global and split here over the
    batch axes, the logits come back global on every rank, and the
    caches hold the rank's rows and key/value heads.
    """
    def rows(x):
        grid = SH.active_mesh()
        return x if grid is None or x is None else SH.batch_slice(x, grid)

    def whole(logits):
        grid = SH.active_mesh()
        spec = (SH.batch_axes(grid),) + (None,) * (logits.dim() - 1)
        return SH.gather_full(logits, spec, grid)

    if mode == "prefill":
        @torch.no_grad()
        def prefill_step(batch):
            view = M.cast_params(model)
            tokens = rows(batch["tokens"])
            h_last, caches = M.forward_prefill(
                view, tokens, max_len or tokens.shape[1],
                img=rows(batch.get("image_embeds")))
            return whole(M.unembed(view, h_last, SH.active_mesh())), caches
        return prefill_step

    if mode == "decode":
        @torch.no_grad()
        def decode_step(batch):
            logits, caches = M.forward_decode(
                M.cast_params(model), rows(batch["tokens"]), batch["pos"],
                batch["caches"])
            return whole(logits), caches
        return decode_step

    raise ValueError(mode)
