"""Mixture-of-experts FFN on torch (port of ``repro.models.lm.moe``).

Sort-based capacity dispatch, as the reference's ``apply_moe``: a
float32 router softmax, top-k experts a token with their gates
renormalized, each (token, k) entry ranked within its expert's queue by
a stable sort (so the entries kept at ``rank < capacity`` are the
reference's), the experts' gated MLPs as dense ``(E, C, D) x (E, D, F)``
batched products, the outputs weighted by the gates and summed back
into their tokens, the shared experts added, and the reference's aux
diagnostics (load-balance loss, dropped fraction, largest expert load).

Where the reference scatters, the port gathers: each expert slot reads
the entry the sort put there (or a zero row past the expert's count),
so only kept entries are written and no slot is written twice; and the
reference's scatter-add of the k weighted outputs into their token
(``.at[tok_idx].add``) is a sum over each token's k slots in slot order,
in the compute dtype, with no float atomics, so a run repeats bit for
bit on the card.  The products are plain torch products, as the
reference leaves them to XLA outside any Pallas kernel.

The backward has no float atomics either (torch's CUDA backward of an
index accumulates with them).  The dispatch and the combine are
``torch.autograd.Function``s whose backwards are gathers: a kept slot
holds exactly one (token, k) entry, so the combine's backward reads each
slot's gradient from its entry (zero for an empty slot), and the
dispatch's backward sums each token's k slot gradients in slot order
(zero for a dropped entry), the forward's own combine loop.  The
router's ``topk`` backward writes unique indices.  The load-balance
loss is differentiable through the mean router probability only: the
top-1 counts are integers, as the reference's ``.at[].add(1.0)`` gives
them no gradient either.

``groups`` splits the rows into equal groups that route on their own
(capacity, ranks, drops and aux per group): the reference's
``smc_decode`` vmaps its step over prompts, so each prompt's K rows
share the experts among themselves alone, and ``decode_ssm`` asks for a
group a prompt.

On a process grid (``launch.sharding.mesh_context``) two dispatches
run, as the config's ``dispatch`` asks:

* ``apply_moe_ep`` (``"ep_shardmap"``, the reference's
  ``repro/models/lm/moe.py:133-243``): each rank routes its own tokens
  at ``capacity_for`` its own token count (so its drops are the
  reference's per-shard ones, not the single device's), packs a
  ``(P, E/P, C, D)`` buffer, one ``all_to_all`` over ``data`` takes each
  block to the rank holding its experts, the experts' F split over
  ``model`` is reduced by ``psum`` (``ep_reduce="psum"``) or by a
  reduce-scatter over D, the combine on D/TP, then an all-gather
  (``"rs_ag"``), a second ``all_to_all`` brings the outputs home, and
  the aux values are means (the loss, the dropped fraction) and a max
  (the largest load) over every axis;
* ``apply_moe_global`` (``"xla"``, and the reference's fallbacks: no
  ``data`` axis, or experts that ``data`` does not divide): the global
  tokens, gathered over the batch axes, routed as on one device at the
  capacity of the global count (what GSPMD computes for the
  reference's ``apply_moe``), every rank keeping its own rows.

Both split the experts' F over ``model`` (Megatron's ``f`` on the
buffer, ``g`` on the outputs) and keep the gather backwards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import runtime
from repro_torch.launch import sharding as SH
from repro_torch.models.lm.layers import apply_mlp, mlp_params, normal_weight


def moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig,
               dtype: torch.dtype) -> dict:
    """Random MoE weights with the reference's shapes and scales: the
    router ``(D, E)``, the experts' ``we_gate``/``we_up`` ``(E, D, F)``
    and ``we_down`` ``(E, F, D)``, and with shared experts their gated
    MLP of width ``n_shared_experts · F``."""
    g, e, f = generator, cfg.n_experts, cfg.d_ff_expert
    s_in = d_model ** -0.5
    p = {"router": normal_weight((d_model, e), s_in, g, dtype),
         "we_gate": normal_weight((e, d_model, f), s_in, g, dtype),
         "we_up": normal_weight((e, d_model, f), s_in, g, dtype),
         "we_down": normal_weight((e, f, d_model), f ** -0.5, g, dtype)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(g, d_model, cfg.n_shared_experts * f, dtype)
    return p


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert has for ``n_tokens`` routed tokens: ``n·k·cf / E``
    rounded down, then up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _rank_within_expert(key: torch.Tensor, n_buckets: int):
    """Each entry's position within its bucket's queue (bucket ``key``,
    in ``0 .. n_buckets - 1``), in entry order: a stable sort by bucket.
    Returns ``(rank, order, start, end)``: ``order`` the sorting
    permutation and ``[start, end)`` each bucket's span of it."""
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    buckets = torch.arange(n_buckets, device=key.device, dtype=key.dtype)
    start = torch.searchsorted(sorted_key, buckets)
    end = torch.searchsorted(sorted_key, buckets, right=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(key.numel(), device=key.device) \
        - start[sorted_key]
    return rank, order, start, end


def _entries(y: torch.Tensor, at: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Each (token, k) entry's slot row of ``y`` (row ``at``), zero for a
    dropped entry."""
    return torch.where(keep[:, None], y[at.clamp(max=y.shape[0] - 1)], 0.0)


def _sum_slots(parts: torch.Tensor, k: int) -> torch.Tensor:
    """``(N·k, D)`` entry rows -> ``(N, D)``: each token's k rows summed
    in slot order."""
    parts = parts.view(-1, k, parts.shape[-1])
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """``xf`` ``(N, D)`` -> the expert slots' rows ``(S, D)``: slot ``s``
    reads token ``tok[s]`` (``N``: a zero row).  Backward: each token's k
    slot gradients, gathered through ``at`` (zero for a dropped entry)
    and summed in slot order, so no two writes meet."""

    @staticmethod
    def forward(ctx, xf, tok, at, keep, k):
        ctx.save_for_backward(at, keep)
        ctx.k = k
        return torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])[tok]

    @staticmethod
    def backward(ctx, grad):
        at, keep = ctx.saved_tensors
        return (_sum_slots(_entries(grad, at, keep), ctx.k), None, None,
                None, None)


class _Combine(torch.autograd.Function):
    """The experts' slot rows ``y`` ``(S, D)`` -> each (token, k) entry's
    row ``(N·k, D)`` (``_entries``).  Backward: slot ``s`` takes the
    gradient of its one entry ``ent[s]`` (``N·k``: an empty slot, zero),
    a gather."""

    @staticmethod
    def forward(ctx, y, at, keep, ent):
        ctx.save_for_backward(ent)
        return _entries(y, at, keep)

    @staticmethod
    def backward(ctx, grad):
        ent, = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return pad[ent], None, None, None


def _shared(p, xf: torch.Tensor, grid) -> torch.Tensor:
    """The shared experts' MLP, tensor-parallel on a grid (``f`` and ``g``
    the identity on one device)."""
    return SH.tp_reduce(apply_mlp(p["shared"], SH.tp_copy(xf, grid)), grid)


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig,
              groups: int = 1, grid=None) -> tuple[torch.Tensor, dict]:
    """``x`` ``(B, T, D)`` -> ``(B, T, D)`` and the aux dict
    ``{moe_aux_loss, moe_drop_frac, moe_max_load}``.  The ``B·T`` rows
    form ``groups`` equal groups in row order, each routed on its own at
    ``capacity_for`` its own rows; the aux values are then ``(groups,)``
    tensors (scalars for one group).  With ``grid`` (from
    ``apply_moe_global``) the experts' and the shared MLP's F are the
    rank's ``model`` shard."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    if n % groups:
        raise ValueError(f"{n} rows do not form {groups} equal groups")
    n_g = n // groups
    cap = capacity_for(n_g, cfg)
    dev = x.device
    xf = x.reshape(n, d)

    probs = torch.softmax((xf @ p["router"]).float(), -1)       # (N, E)
    gate, eid = probs.topk(k, -1)                                # (N, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- rank of each (token, k) entry within its (group, expert) -------
    entry_group = torch.arange(n * k, device=dev) // (n_g * k)
    flat_e = eid.reshape(-1)
    bucket = entry_group * e + flat_e
    rank, order, start, end = _rank_within_expert(bucket, groups * e)
    keep = rank < cap

    # ---- dispatch: slot (expert, group, c) reads its entry's token ------
    slot_bucket = (torch.arange(groups, device=dev)[None, :, None] * e
                   + torch.arange(e, device=dev)[:, None, None])  # (E, G, 1)
    src = start[slot_bucket] + torch.arange(cap, device=dev)    # (E, G, C)
    filled = src < end[slot_bucket]
    ent = torch.where(filled, order[src.clamp(max=n * k - 1)],
                      n * k).reshape(-1)                         # (E·G·C,)
    tok = torch.where(ent < n * k, ent // k, n)                  # n: zero row
    at = flat_e * (groups * cap) + entry_group * cap + rank
    buf = SH.tp_copy(_Dispatch.apply(xf, tok, at, keep, k)
                     .view(e, groups * cap, d), grid)

    # ---- the experts' gated MLPs, one batched product per weight --------
    h = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    y = SH.tp_reduce(torch.bmm(F.silu(h) * u, p["we_down"]).view(-1, d),
                     grid)                                       # (E·G·C, D)

    # ---- combine: each token's k slots, weighted, summed in slot order ---
    got = _Combine.apply(y, at, keep, ent)
    out = _sum_slots(got * gate.reshape(-1, 1).to(got.dtype), k)
    if "shared" in p:
        out = out + _shared(p, xf, grid)

    # ---- aux: load-balance loss and the DLB-style diagnostics ------------
    me = probs.view(groups, n_g, e).mean(1)                     # (G, E)
    top1 = torch.arange(n, device=dev) // n_g * e + eid[:, 0]
    ce = torch.bincount(top1, minlength=groups * e).view(groups, e) \
        .float() / n_g
    load = torch.bincount(bucket, minlength=groups * e).view(groups, e)
    # 1 - kept · fl(1 / (n·k)), rounded once: the reference's 1 - mean as
    # XLA compiles it (the division by the constant count becomes a
    # product with its float32 reciprocal, fused with the subtraction)
    inv = float(torch.tensor(1.0 / (n_g * k), dtype=torch.float32))
    kept = keep.view(groups, -1).sum(-1).double()
    aux = {"moe_aux_loss": cfg.router_aux_loss * e * (me * ce).sum(-1),
           "moe_drop_frac": (1.0 - kept * inv).float(),
           "moe_max_load": load.amax(-1).to(torch.int32)}
    if groups == 1:
        aux = {name: v[0] for name, v in aux.items()}
    return out.reshape(b, t, d), aux


def apply_moe_global(p, x: torch.Tensor, cfg: MoEConfig,
                     grid) -> tuple[torch.Tensor, dict]:
    """``apply_moe`` of the global tokens on a grid: the rank's rows ``x``
    ``(B_loc, T, D)`` are gathered over the batch axes (the gather's
    backward reduce-scatters, so the aux loss's gradient, which every
    rank computes on every token, counts once between them), routed at
    the capacity of the global count, and the rank keeps its rows.  The
    expert banks arrive gathered over ``data``; their F and the shared
    MLP's are split over ``model``.  Returns the rank's rows and the
    global aux values (the single device's, every rank)."""
    axes = SH.batch_axes(grid)
    b = x.shape[0]
    xg = SH.gather_leaf(x, (axes,) + (None,) * (x.dim() - 1), grid, axes)
    out, aux = apply_moe(p, xg, cfg, 1, grid)
    return out.narrow(0, SH.batch_index(grid) * b, b), aux


def _drop_frac(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` as XLA compiles it (``apply_moe``'s rounding)."""
    inv = float(torch.tensor(1.0 / keep.numel(), dtype=torch.float32))
    return (1.0 - keep.sum().double() * inv).float()


def apply_moe_ep(p, x: torch.Tensor, cfg: MoEConfig, grid,
                 record: dict | None = None) -> tuple[torch.Tensor, dict]:
    """The expert-parallel MoE (the reference's ``apply_moe_ep``) on a
    grid with a ``data`` axis that divides the experts: ``x`` is the
    rank's rows ``(B_loc, T, D)``, replicated over ``model``; ``p``
    holds the full router (gathered) and the rank's expert banks
    ``(E/P, D, F/TP)``, ``(E/P, F/TP, D)``.  The layout and collectives
    are the module docstring's.  Returns the rank's rows and the aux
    values, replicated: ``moe_aux_loss`` a mean over every axis whose
    backward passes the gradient on as it is (each rank's objective
    counts it once between the batch shards), ``moe_drop_frac`` a mean
    and ``moe_max_load`` a max.  ``record``, if given, receives the
    rank's routing: each (token, k) entry's ``slot`` (``cap`` when
    dropped), ``keep``, the per-expert ``load`` and ``capacity``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    data = grid.axis("data")
    p_data = data.shards
    e_loc = e // p_data
    n = b * t
    cap = capacity_for(n, cfg)                   # per (source, expert)
    dev = x.device
    xf = x.reshape(n, d)

    probs = torch.softmax((xf @ p["router"]).float(), -1)       # (N, E)
    gate, eid = probs.topk(k, -1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = eid.reshape(-1)
    rank, order, start, end = _rank_within_expert(flat_e, e)
    keep = rank < cap

    # ---- pack: slot (expert, c) reads its entry's token; (P, E/P, C, D) -
    src = start[:, None] + torch.arange(cap, device=dev)        # (E, C)
    filled = src < end[:, None]
    ent = torch.where(filled, order[src.clamp(max=n * k - 1)],
                      n * k).reshape(-1)
    tok = torch.where(ent < n * k, ent // k, n)
    at = flat_e * cap + rank
    send = _Dispatch.apply(xf, tok, at, keep, k).view(p_data, e_loc, cap, d)

    # ---- one all_to_all over data: (P_src, E/P, C, D) on the owner ------
    recv = SH.on_line(runtime.all_to_all_grad, send, data)
    hbuf = recv.transpose(0, 1).reshape(e_loc, p_data * cap, d)
    hbuf = SH.tp_copy(hbuf, grid)

    # ---- the rank's experts, F split over model -------------------------
    h = torch.bmm(hbuf, p["we_gate"])
    u = torch.bmm(hbuf, p["we_up"])
    y = torch.bmm(F.silu(h) * u, p["we_down"])              # (E/P, S, D)
    line = SH.model_line(grid)
    use_rs = (line is not None and cfg.ep_reduce == "rs_ag"
              and d % line.shards == 0)
    if use_rs:
        # the partial sums reduce-scattered along D: the return route
        # and the combine carry D/TP a rank
        y = SH.on_line(runtime.tp_scatter, y, line, 3)
    else:
        y = SH.tp_reduce(y, grid)
    d_eff = y.shape[-1]

    # ---- the second all_to_all brings each block home -------------------
    yb = y.reshape(e_loc, p_data, cap, d_eff).transpose(0, 1).contiguous()
    back = SH.on_line(runtime.all_to_all_grad, yb, data)
    got = _Combine.apply(back.reshape(e * cap, d_eff), at, keep, ent)
    if use_rs:
        # the combine sees a rank's D/TP columns: the gates' gradients
        # are partial sums over model
        gate = SH.on_line(runtime.tp_copy, gate, line)
    out = _sum_slots(got * gate.reshape(-1, 1).to(got.dtype), k)
    if use_rs:
        out = SH.on_line(runtime.tp_gather, out, line, 2)
    if "shared" in p:
        out = out + _shared(p, xf, grid)

    # ---- aux, over every axis ------------------------------------------
    me = probs.mean(0)
    ce = torch.bincount(eid[:, 0], minlength=e).float() / n
    aux_l = cfg.router_aux_loss * e * (me * ce).sum()
    load = torch.bincount(flat_e, minlength=e)
    drop = _drop_frac(keep)
    axes = tuple(grid.axis_names)
    for a in reversed(axes):
        if grid.shape[a] > 1:
            aux_l = SH.on_line(runtime.tp_mean, aux_l, grid.axis(a))
    with torch.no_grad():
        for a in reversed(axes):
            if grid.shape[a] > 1:
                drop = SH.on_line(runtime.pmean, drop, grid.axis(a))
    maxl = SH.pmax_over(load.amax().to(torch.int32), grid, axes)
    if record is not None:
        record.update(slot=torch.where(keep, rank, cap), keep=keep,
                      load=load, capacity=cap)
    return out.reshape(b, t, d), {"moe_aux_loss": aux_l,
                                  "moe_drop_frac": drop,
                                  "moe_max_load": maxl}
