"""User-facing filter entry points (port of ``repro.core.filters``).

``ParallelParticleFilter`` runs one SIR filter over a frame sequence,
on one device or — with ``mesh=EmulatedMesh(P)`` and a ``DRAConfig`` —
as the paper's distributed filter: P shards of ``C = N / P`` slots held
as one ``(P, C, ...)`` ensemble on the card, resampled by MPF, RNA,
ARNA, RPA or butterfly through the emulated collectives of
``repro_torch.core.runtime``.  With ``mesh=ProcessMesh`` (one process a
shard over a ``torch.distributed`` group,
``repro_torch.launch.mesh.init_process_mesh``) every rank runs the same
program on its ``(1, C, ...)`` shard, returns the replicated outputs and
its own shard as ``final``, and gets the bits the emulated mesh gives
that shard (``runtime.gather_shards`` collects the ensemble).  On a grid
(``EmulatedGrid`` or ``ProcessGrid``) the particles are sharded over
``axis_name`` and replicated over the other axes, as the reference's
specs name only that axis.  With ``domain=`` (a
``repro_torch.core.domain.DomainSpec``) each shard holds only its halo
slab of every frame and reweights its tile's particles against it.
``FilterBank`` runs B independent filters of one model as one batched
program, member ``i`` reproducing ``ParallelParticleFilter.run(keys[i],
observations[i])`` — on one device, or over the mesh (the reference's
"many users, one program" layout): a ``(B, P, C, ...)`` ensemble whose
every member runs the DRA through collectives that act for all members
at once (``make_sharded_bank_step``).  Both run on the CUDA device unless
built with ``device="cpu"``; with no CUDA device and no explicit
``device`` they raise rather than run elsewhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import distributed as dist
from repro_torch.core import domain as domain_mod
from repro_torch.core import particles, runtime, smc
from repro_torch.core.draws import (BankDraws, as_draws, bank_shard_draws,
                                    shard_draws)


class FilterResult(NamedTuple):
    """Stacked per-frame outputs plus the posterior ensemble: ``(K, ...)``
    for one filter, ``(B, K, ...)`` for a bank."""

    estimates: torch.Tensor
    ess: torch.Tensor
    log_marginal: torch.Tensor
    resampled: torch.Tensor
    ancestors: torch.Tensor
    diag: dict
    final: particles.ParticleEnsemble


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port's entry points run "
                               "on the card unless given device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def _to_device(observations, device) -> torch.Tensor:
    return torch.as_tensor(observations, dtype=torch.float32, device=device)


@dataclasses.dataclass
class ParallelParticleFilter:
    """SIR particle filter, on one device or distributed over an emulated
    mesh.

    With ``mesh=None`` (or a 1-shard mesh without a domain) it runs the
    single-device path; otherwise the configured DRA (``dra``, default
    RNA) over the mesh's ``P`` shards, each of ``C = n_particles / P``
    slots.  ``domain`` (a ``DomainSpec`` of ``P`` tiles; it needs a mesh)
    decomposes the input space: each shard reads only its halo slab of
    every frame, and the trajectory is the replicated filter's.
    ``observations`` may then be ``(K, H, W)`` frames (tiled here) or a
    pre-tiled ``(K, P, sh, sw)`` slab stack
    (``repro_torch.data.synthetic_movie.tile_shard_frames``).
    """

    model: Any
    sir: smc.SIRConfig
    device: Any = None
    mesh: Any = None
    dra: dist.DRAConfig = dataclasses.field(default_factory=dist.DRAConfig)
    domain: Any = None
    axis_name: str = "data"

    def __post_init__(self):
        _check_mesh(self.mesh)
        # the 1-D mesh of the particle axis (raises if the mesh lacks it)
        self._axis = None if self.mesh is None \
            else self.mesh.axis(self.axis_name)
        if not isinstance(self.dra, dist.DRAConfig):
            raise TypeError(f"dra must be a DRAConfig, got "
                            f"{type(self.dra).__name__}")
        if self.domain is not None:
            if not isinstance(self.domain, domain_mod.DomainSpec):
                raise TypeError(f"domain must be a DomainSpec, got "
                                f"{type(self.domain).__name__}")
            if self.mesh is None:
                raise ValueError("domain decomposition needs a mesh: the "
                                 "tile grid maps onto the mesh's shards "
                                 "(pass mesh=, or drop domain= for the "
                                 "single-device path)")
            if self.domain.tiles != self._axis.shards:
                raise ValueError(f"domain grid {self.domain.grid} has "
                                 f"{self.domain.tiles} tiles but mesh axis "
                                 f"{self.axis_name!r} has "
                                 f"{self._axis.shards} shards")
        self.device = resolve_device(self.device)

    def run(self, key, observations) -> FilterResult:
        """Filter a ``(K, ...)`` observation stack.  ``key`` is an int
        seed, a ``torch.Generator`` or a draws provider; on a mesh, an
        int seed or a provider with ``batch_shape (P,)`` (one stream per
        shard)."""
        obs = _to_device(observations, self.device)
        if self.mesh is None or (_mesh_size(self.mesh) == 1
                                 and self.domain is None):
            carry, outs = smc.run_sir(as_draws(key, self.device),
                                      self.model, self.sir, obs)
        else:
            if self.domain is not None:
                # the slabs of the shards this process holds
                obs = runtime.own_shards(
                    _tiled_observations(self.domain, obs), self._axis, 1)
            carry, outs = self._run_sharded(key, obs)
        return FilterResult(outs.estimate, outs.ess, outs.log_marginal,
                            outs.resampled, outs.ancestors, outs.diag,
                            carry.ensemble)

    def _run_sharded(self, key, obs):
        n = self.sir.n_particles
        mesh = self._axis
        carry = shard_carry(shard_draws(key, mesh, self.device),
                            self.model, _shard_capacity(n, mesh.shards), n)
        step = smc.make_distributed_sir_step(self.model, self.sir, self.dra,
                                             mesh, domain=self.domain)
        outs = []
        for k in range(obs.shape[0]):
            carry, out = step(carry, obs[k])
            outs.append(out)
        return carry, smc.stack_outputs(outs)


@dataclasses.dataclass
class FilterBank:
    """B independent SIR filters (shared model and config) in one
    program; member ``i`` consumes ``observations[i]`` with stream
    ``keys[i]`` and reproduces ``ParallelParticleFilter(mesh=mesh,
    dra=dra).run(keys[i], observations[i])`` bit for bit.

    * ``mesh=None`` (or a one-shard mesh) — every member's ``N``
      particles on one device, batched along a leading slot dim; the
      fused weight phase and the patch likelihood are one kernel launch
      each for the whole bank.
    * ``mesh`` (an ``EmulatedMesh``, or an ``EmulatedGrid`` from
      ``runtime.make_mesh`` holding the ``axis_name`` axis) — every
      member's particles are sharded over ``axis_name``'s ``P`` shards:
      a ``(B, P, C, ...)`` ensemble, ``C = N / P``, and the DRA runs for
      all members in one pass (one launch of each kernel a frame).  A
      ``ProcessMesh`` (or a ``ProcessGrid``'s ``axis_name`` line) spreads
      those shards over its ranks: every rank holds all members' ``(B,
      1, C, ...)`` shard.
    * ``bank_axis`` — the members are also sharded over that axis of the
      grid: ``B / P_b`` members a bank shard, bank shard ``b`` holding
      members ``[b·B/P_b, (b+1)·B/P_b)`` (the reference's ``P(bank)``).
      On one card that is a layout: the ensemble becomes ``(P_b, B /
      P_b, P, C, ...)`` and the collectives act behind both member dims;
      the bits are those of the bank without it, and the results come
      back as ``(B, ...)``.  On a ``ProcessGrid`` a rank steps only its
      bank shard's members, ``(B / P_b, 1, C, ...)``, the DRA running on
      its ``axis_name`` line; the outputs are gathered over its
      ``bank_axis`` line in member order, so every rank returns all ``(B,
      ...)``, and ``final`` is the rank's own shard.  Each member draws
      from its own streams wherever it is held.
    """

    model: Any
    sir: smc.SIRConfig
    device: Any = None
    mesh: Any = None
    dra: dist.DRAConfig = dataclasses.field(default_factory=dist.DRAConfig)
    axis_name: str = "data"
    bank_axis: str | None = None

    def __post_init__(self):
        _check_mesh(self.mesh)
        if not isinstance(self.dra, dist.DRAConfig):
            raise TypeError(f"dra must be a DRAConfig, got "
                            f"{type(self.dra).__name__}")
        if self.mesh is not None:
            for axis in (self.axis_name, self.bank_axis):
                if axis is not None and axis not in self.mesh.shape:
                    raise ValueError(f"axis {axis!r} not in mesh axes "
                                     f"{tuple(self.mesh.shape)}")
        self.device = resolve_device(self.device)

    def run(self, keys, observations) -> FilterResult:
        """Run every member over its stream.  ``keys`` holds one seed,
        generator or provider per member (over a mesh: a seed or a
        provider with ``batch_shape (P,)``); ``observations`` is ``(B, K,
        ...)``.  Every result field has a leading bank dim."""
        obs = _to_device(observations, self.device)
        if self.mesh is None or _mesh_size(self.mesh) == 1:
            return self._run_local(keys, obs)
        return self._run_sharded(keys, obs)

    def _run_local(self, keys, obs) -> FilterResult:
        carry = member_carry([as_draws(k, self.device) for k in keys],
                             self.model, self.sir)
        return _run_bank(make_bank_step(self.model, self.sir), carry, obs,
                         (obs.shape[0],))

    def _run_sharded(self, keys, obs) -> FilterResult:
        p = self.mesh.shape[self.axis_name]
        n = self.sir.n_particles
        c = _shard_capacity(n, p)
        b = len(keys)
        p_bank = self.mesh.shape[self.bank_axis] if self.bank_axis else 1
        if b % p_bank:
            raise ValueError(f"bank size {b} not divisible by {p_bank} "
                             f"bank shards")
        data = self.mesh.axis(self.axis_name)
        step = make_sharded_bank_step(self.model, self.sir, self.dra, data)
        per = b // p_bank
        if self.bank_axis and isinstance(self.mesh, runtime.ProcessGrid):
            # this rank's bank shard: members [lo, lo + B / P_b)
            line = self.mesh.axis(self.bank_axis)
            lo = line.rank * per
            carry = shard_carry(bank_shard_draws(keys[lo:lo + per], data,
                                                 self.device),
                                self.model, c, n)
            res = _run_bank(step, carry, obs[lo:lo + per], (per,))
            return _gather_members(res, line)
        members = (p_bank, per) if self.bank_axis else (b,)
        draws = bank_shard_draws(keys, data, self.device)
        if self.bank_axis:
            # one sub-bank a bank shard: draws (P_b, B / P_b, P)
            draws = BankDraws([BankDraws(draws.members[j * per:(j + 1) * per])
                               for j in range(p_bank)])
        carry = shard_carry(draws, self.model, c, n)
        return _run_bank(step, carry, obs.reshape(members + obs.shape[1:]),
                         members)


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, runtime.MESHES):
        raise TypeError(f"mesh must be an EmulatedMesh, EmulatedGrid, "
                        f"ProcessMesh or ProcessGrid, got "
                        f"{type(mesh).__name__}")


def _mesh_size(mesh) -> int:
    """Shards of every axis together (the reference's
    ``mesh.devices.size``)."""
    return math.prod(mesh.shape.values())


def _gather_members(res: FilterResult, line: runtime.ProcessMesh
                    ) -> FilterResult:
    """A bank shard's ``(B / P_b, ...)`` outputs and diag gathered over
    its bank line in member order, ``(B, ...)`` on every rank; ``final``
    stays the rank's own."""
    def gather(x):
        every = runtime.gather_shards(x.unsqueeze(0), line)
        return every.reshape((line.shards * x.shape[0],)
                             + tuple(x.shape[1:]))

    return res._replace(**{f: particles.tree_map(gather, getattr(res, f))
                           for f in ("estimates", "ess", "log_marginal",
                                     "resampled", "ancestors", "diag")})


def _run_bank(step, carry: smc.SIRCarry, obs: torch.Tensor,
              members: tuple[int, ...]) -> FilterResult:
    """Drive a bank step over ``members + (K, ...)`` observations with
    every slot active; the results lead with one bank dim ``B``."""
    d = len(members)
    active = torch.ones(members, dtype=torch.bool, device=obs.device)
    outs = []
    for k in range(obs.shape[d]):
        carry, out = step(carry, (obs.select(d, k), active))
        outs.append(out)
    outs = smc.stack_outputs(outs, axis=d)

    def bank(x):
        return x.reshape((math.prod(members),) + x.shape[d:])

    final = carry.ensemble
    return FilterResult(*(particles.tree_map(bank, getattr(outs, f)) for f in (
        "estimate", "ess", "log_marginal", "resampled", "ancestors", "diag")),
        final=particles.ParticleEnsemble(*(particles.tree_map(bank, x) for x in (
            final.state, final.log_weights, final.counts))))


def make_bank_step(model, sir: smc.SIRConfig):
    """The single-frame bank step ``step(carry, (observations (B, ...),
    active (B,))) -> (carry, StepOutput)``: the batched SIR step under
    the per-slot mask (``smc.make_masked_step``)."""
    return smc.make_masked_step(smc.make_sir_step(model, sir))


def make_sharded_bank_step(model, sir: smc.SIRConfig, dra: dist.DRAConfig,
                           mesh: runtime.Mesh):
    """The bank step over a mesh (the reference's per-shard bank step,
    its distributed SIR step ``vmap``ped over slots): ``step(carry,
    (observations (B, ...), active (B,)))`` on a ``(B, P, C, ...)``
    carry whose draws are ``(B, P)`` (``shard_carry`` over
    ``draws.bank_shard_draws``).  One pass
    serves every member — each collective and kernel launches once for
    the bank, not once a member — under the per-slot mask of
    ``make_bank_step``: an inactive member keeps its ensemble and its
    streams bit for bit and emits zeros.  Any number of member dims may
    lead (``bank_axis``'s ``(P_b, B / P_b)``)."""
    return smc.make_masked_step(smc.make_distributed_sir_step(
        model, sir, dra, mesh))


def member_carry(members, model, sir: smc.SIRConfig) -> smc.SIRCarry:
    """A fresh ``(B, ...)`` bank carry from one draws provider per
    member: each member draws its own ensemble exactly as
    ``smc.run_sir`` would, so member ``i`` continues the trajectory of a
    standalone filter with the same provider."""
    draws = BankDraws(members)
    ens = particles.init_ensemble(draws, model.init, sir.n_particles)
    return smc.SIRCarry(draws, ens)


def _tiled_observations(dom: domain_mod.DomainSpec,
                        obs: torch.Tensor) -> torch.Tensor:
    """``(K, H, W)`` frames, tiled here, or an already tiled ``(K, P, sh,
    sw)`` slab stack, as it is."""
    if obs.dim() == 3 and tuple(obs.shape[1:]) == dom.frame_shape:
        return domain_mod.tile_frames(dom, obs)
    if obs.dim() == 4 and obs.shape[1] == dom.tiles \
            and tuple(obs.shape[2:]) == dom.slab_shape:
        return obs
    raise ValueError(
        f"domain observations must be (K,) + {dom.frame_shape} frames or "
        f"(K, {dom.tiles}) + {dom.slab_shape} slabs, got "
        f"{tuple(obs.shape)}")


def _shard_capacity(n: int, p: int) -> int:
    if n % p:
        raise ValueError(f"n_particles={n} not divisible by {p} shards")
    return n // p


def shard_carry(draws, model, c: int, n: int) -> smc.SIRCarry:
    """A fresh ``(P, C, ...)`` carry of the distributed filter: each
    shard draws its ``C``-slot piece of the ``n``-particle ensemble from
    its own stream, every slot weighted ``-log n`` (float32).  With
    ``(B, P)`` draws it is a bank's ``(B, P, C, ...)`` carry, every member
    drawn as its standalone filter draws it (the reference's
    ``_shard_carry`` under ``vmap``)."""
    ens = particles.init_ensemble(draws, model.init, c,
                                  log_weight=-dist.log_f32(n))
    return smc.SIRCarry(draws, ens)
