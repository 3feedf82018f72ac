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

``groups`` splits the rows into equal groups that route on their own
(capacity, ranks, drops and aux per group): the reference's
``smc_decode`` vmaps its step over prompts, so each prompt's K rows
share the experts among themselves alone, and ``decode_ssm`` asks for a
group a prompt.  The expert-parallel dispatch (``apply_moe_ep``, a
``shard_map`` over the data axis) is not ported: on one device the
reference runs ``apply_moe`` (``repro/models/lm/moe.py:148-149``), and
the port runs one device (ROADMAP A8b's rest).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
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


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig,
              groups: int = 1) -> tuple[torch.Tensor, dict]:
    """``x`` ``(B, T, D)`` -> ``(B, T, D)`` and the aux dict
    ``{moe_aux_loss, moe_drop_frac, moe_max_load}``.  The ``B·T`` rows
    form ``groups`` equal groups in row order, each routed on its own at
    ``capacity_for`` its own rows; the aux values are then ``(groups,)``
    tensors (scalars for one group)."""
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
    tok = torch.where(filled, order[src.clamp(max=n * k - 1)] // k, n)
    rows = torch.cat([xf, xf.new_zeros((1, d))])                # a zero row
    buf = rows[tok.reshape(-1)].view(e, groups * cap, d)

    # ---- the experts' gated MLPs, one batched product per weight --------
    h = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    y = torch.bmm(F.silu(h) * u, p["we_down"]).view(-1, d)     # (E·G·C, D)

    # ---- combine: each token's k slots, weighted, summed in slot order ---
    at = flat_e * (groups * cap) + entry_group * cap + rank
    got = torch.where(keep[:, None], y[at.clamp(max=y.shape[0] - 1)], 0.0)
    parts = (got * gate.reshape(-1, 1).to(got.dtype)).view(n, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    if "shared" in p:
        out = out + apply_mlp(p["shared"], xf)

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
