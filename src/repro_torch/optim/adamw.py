"""AdamW with global-norm clipping and LR schedules on torch (port of
``repro.optim.adamw``).

The reference's arithmetic, leaf by leaf: moments in float32 (or
bfloat16 with ``moment_dtype``), bias correction from the incremented
step, the clip scale ``min(1, clip_norm / max(gnorm, 1e-9))``, the update
computed in float32 and cast back to the leaf's dtype.  The schedule and
every scalar are float32 tensors on the weights' device, so a step never
waits on the card.

Parameters are a trainable decoder (``repro_torch.models.lm.model``):
its float32 master weights are updated in place under ``torch.no_grad()``
and the state's moments are dicts keyed by the weights' names
(``named_parameters``).  Weight decay follows the reference's pytree:
it decays a leaf of rank >= 2 there (``p.ndim >= 2``), and the reference
stacks every scanned group's leaves on a leading group axis, so a norm
gain inside a group is decayed while the unrolled layers' gains and the
final norm are not.  The rank is read from ``model.reference_ndims()``,
not from the port's tensor.

A rank's sharded decoder (``launch.sharding``) is updated on its local
blocks, elementwise as on one device; only the global norm needs the
grid: ``sharding.sharded_sq_norm`` sums each block's squares over the
axes that shard it and counts a replicated weight once, so every rank
gets the same clip scale.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | linear | constant
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # or "bfloat16"


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def learning_rate(cfg: OptConfig, step) -> torch.Tensor:
    """The rate at ``step`` (an int or an integer tensor): linear warm-up
    over ``warmup_steps``, then ``cosine``, ``linear`` or ``constant``
    decay to ``min_lr_frac`` at ``total_steps``; a float32 tensor."""
    s = _f32(step, step.device if torch.is_tensor(step) else None)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones_like(s)
    return cfg.lr * warm * decay


def init_opt_state(params, moment_dtype: str = "float32") -> dict:
    """Zero moments ``{"m", "v"}`` (dicts by weight name, ``moment_dtype``)
    and ``"step"``, a 0-d int32 tensor, on the weights' device."""
    dt = _MOMENT_DTYPES[moment_dtype]
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=dt) for n, p in named.items()},
            "v": {n: torch.zeros_like(p, dtype=dt) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum(x²))`` over every tensor, each reduced in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params,
                 cfg: OptConfig) -> tuple:
    """One AdamW step of ``params`` (updated in place) from ``grads`` (a
    dict by weight name; not modified).  Returns ``(params, state,
    stats)`` with the state updated in place and ``stats`` the float32
    tensors ``grad_norm``, ``lr`` and ``clip_scale``."""
    named = dict(params.named_parameters())
    ndims = params.reference_ndims()
    step = state["step"].add_(1)
    specs = getattr(params, "shard_specs", None)
    if specs is None:
        gnorm = global_norm(grads[n] for n in named)
    else:
        from repro_torch.launch import sharding
        grid = sharding.active_mesh()
        sharding.check_model_grid(params, grid)
        gnorm = torch.sqrt(sharding.sharded_sq_norm(
            {n: grads[n] for n in named}, specs, grid))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = learning_rate(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    s = step.float()
    bc1 = 1.0 - _f32(b1, s.device) ** s
    bc2 = 1.0 - _f32(b2, s.device) ** s
    for name, p in named.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        # .float() of a float32 tensor is the tensor itself: those
        # moments and weights are updated where they lie
        m32, v32, p32 = m.float(), v.float(), p.float()
        m32.mul_(b1).add_(g, alpha=1 - b1)
        v32.mul_(b2).add_(torch.square(g), alpha=1 - b2)
        delta = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
        if cfg.weight_decay and ndims[name] >= 2:   # decay matrices
            delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta.mul_(lr))
        for dst, src in ((m, m32), (v, v32), (p, p32)):
            if dst is not src:
                dst.copy_(src)
    return params, state, {"grad_norm": gnorm, "lr": lr,
                           "clip_scale": scale}
