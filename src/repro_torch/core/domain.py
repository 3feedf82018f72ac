"""Input-space domain decomposition on the emulated mesh (port of
``repro.core.domain``).

Each shard owns one tile of the frame and evaluates the likelihood only
against its halo slab (the tile plus a ring of the patch radius), so no
shard needs the whole observation:

* ``DomainSpec`` maps the ``P`` shards onto a row-major tile grid and
  carries the halo width (= the patch radius);
* ``owner_of`` gives each particle the tile of its clipped, rounded patch
  centre — the centre the likelihood evaluates — so an owned particle's
  whole patch lies in its owner's slab and the tile-local likelihood is
  the full-frame one, bit for bit;
* ``migration_plan`` + ``migrate`` move each particle to its owner over
  the DLB routing executor (``dlb.pack_windows``/``route_compressed``/
  ``merge_routed``) with an ownership-derived schedule;
* ``exchange_log_likelihood`` is the step's migrate-after-advance hook:
  particles travel to their owners, are reweighted against the owner's
  slab, and the log-likelihoods travel back to their home slots, so every
  draw and resampling decision stays with the home shard and the domain
  filter follows the replicated-frame filter's trajectory exactly.

As everywhere on the emulated mesh, every per-shard tensor carries a
leading shard dim ``P``: an ensemble is ``(P, C, ...)``, ``my`` is
``runtime.axis_index(mesh)`` and the collectives act on dim 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import dlb, particles, runtime
from repro_torch.core.particles import ParticleEnsemble


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Tile grid of one ``(H, W)`` frame over the mesh's shards.

    Shard ``t`` owns tile ``(t // gx, t % gx)`` of the ``(gy, gx)`` grid,
    whose extents must divide the frame; ``halo`` is the ring around each
    tile (the patch radius); ``k_cap`` the migration window per peer,
    ``None`` meaning the shard capacity ``C``, which cannot overflow (exact
    parity with the replicated filter needs it).  Field for field the
    reference's spec.
    """

    frame_shape: tuple[int, int]
    grid: tuple[int, int]
    halo: int
    k_cap: int | None = None

    def __post_init__(self):
        h, w = self.frame_shape
        gy, gx = self.grid
        if gy < 1 or gx < 1:
            raise ValueError(f"grid must be positive, got {self.grid}")
        if h % gy or w % gx:
            raise ValueError(
                f"grid {self.grid} does not divide frame {self.frame_shape}")
        if self.halo < 0:
            raise ValueError(f"halo must be >= 0, got {self.halo}")
        if 2 * self.halo >= min(h, w):
            raise ValueError(f"halo {self.halo} too large for frame "
                             f"{self.frame_shape}")

    @property
    def tiles(self) -> int:
        """Tile count ``gy * gx`` (= the shard count)."""
        return self.grid[0] * self.grid[1]

    @property
    def tile_shape(self) -> tuple[int, int]:
        """``(th, tw)`` of one owned tile, halo excluded."""
        return (self.frame_shape[0] // self.grid[0],
                self.frame_shape[1] // self.grid[1])

    @property
    def slab_shape(self) -> tuple[int, int]:
        """``(sh, sw)`` of one halo slab: the tile and the halo ring."""
        th, tw = self.tile_shape
        return (th + 2 * self.halo, tw + 2 * self.halo)

    def frame_bytes(self, dtype_bytes: int = 4) -> int:
        """Bytes of one full frame (what a shard no longer holds)."""
        h, w = self.frame_shape
        return h * w * dtype_bytes

    def slab_bytes(self, dtype_bytes: int = 4) -> int:
        """Bytes of one shard's slab."""
        sh, sw = self.slab_shape
        return sh * sw * dtype_bytes

    @classmethod
    def for_mesh(cls, frame_shape: tuple[int, int], tiles: int, halo: int,
                 *, k_cap: int | None = None) -> "DomainSpec":
        """The squarest ``(gy, gx)`` factorization of ``tiles`` whose tile
        extents divide the frame (the least halo perimeter); of equally
        square grids, the one with the fewest rows."""
        h, w = frame_shape
        best = None
        for gy in range(1, tiles + 1):
            if tiles % gy:
                continue
            gx = tiles // gy
            if h % gy or w % gx:
                continue
            score = abs(h // gy - w // gx)
            if best is None or score < best[0]:
                best = (score, gy, gx)
        if best is None:
            raise ValueError(
                f"no (gy, gx) factorization of {tiles} tiles divides a "
                f"{frame_shape} frame")
        return cls(frame_shape=(h, w), grid=(best[1], best[2]), halo=halo,
                   k_cap=k_cap)

    def tile_origin(self, t):
        """``(y0, x0)`` of tile ``t``'s owned region in frame coordinates
        (``t`` an int or an integer tensor)."""
        gx = self.grid[1]
        th, tw = self.tile_shape
        return (t // gx) * th, (t % gx) * tw

    def slab_origin(self, t):
        """Frame coordinates of the slab's ``[0, 0]`` pixel (negative at a
        frame edge, where the ring hangs over the border and is
        zero-filled; ``owner_of`` keeps every read inside the frame)."""
        y0, x0 = self.tile_origin(t)
        return y0 - self.halo, x0 - self.halo

    def slab_origins(self) -> tuple[tuple[int, int], ...]:
        """Every shard's slab origin, in shard order."""
        return tuple(self.slab_origin(t) for t in range(self.tiles))


# ---------------------------------------------------------------------------
# Ownership
# ---------------------------------------------------------------------------

def owner_of(spec: DomainSpec, y: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Owning shard of each ``(y, x)``: the tile of the clipped rounded
    patch centre ``clip(round(·), halo, dim-1-halo)`` (``torch.round`` is
    half to even, as ``jnp.round``).  The tiles partition the positions,
    and the owner's slab holds the particle's whole patch."""
    h, w = spec.frame_shape
    th, tw = spec.tile_shape
    r = spec.halo
    cy = torch.round(y).to(torch.int32).clamp(r, h - 1 - r)
    cx = torch.round(x).to(torch.int32).clamp(r, w - 1 - r)
    return (cy // th) * spec.grid[1] + (cx // tw)


# ---------------------------------------------------------------------------
# Halo slabs
# ---------------------------------------------------------------------------

def _padded(spec: DomainSpec, frames: torch.Tensor) -> torch.Tensor:
    r = spec.halo
    return F.pad(frames, (r, r, r, r))


def extract_slab(spec: DomainSpec, frame: torch.Tensor, t: int
                 ) -> torch.Tensor:
    """Tile ``t``'s halo slab of an ``(H, W)`` frame, zero-filled where the
    ring hangs over the border."""
    y0, x0 = spec.tile_origin(t)
    sh, sw = spec.slab_shape
    return _padded(spec, frame[None])[0, y0:y0 + sh, x0:x0 + sw]


def tile_frames(spec: DomainSpec, frames: torch.Tensor) -> torch.Tensor:
    """``(K, H, W)`` frames -> ``(K, P, sh, sw)`` halo slabs (dim 1 is the
    shard dim: shard ``t`` reads only its own slabs)."""
    if frames.dim() != 3 or tuple(frames.shape[1:]) != spec.frame_shape:
        raise ValueError(f"expected (K,) + {spec.frame_shape} frames, got "
                         f"{tuple(frames.shape)}")
    padded = _padded(spec, frames)
    sh, sw = spec.slab_shape
    slabs = []
    for t in range(spec.tiles):
        y0, x0 = spec.tile_origin(t)
        slabs.append(padded[:, y0:y0 + sh, x0:x0 + sw])
    return torch.stack(slabs, 1)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------

class MigrationPlan(NamedTuple):
    """Every shard's ownership-derived routing schedule."""

    owner: torch.Tensor      # (P, C) owning shard (dead slots pinned home)
    order: torch.Tensor      # (P, C) home layout -> routing layout
    row_send: torch.Tensor   # (P, P) units shard i ships to shard j


def migration_plan(spec: DomainSpec, ensemble: ParticleEnsemble,
                   yx: torch.Tensor, my: torch.Tensor) -> MigrationPlan:
    """The routing schedule of each shard (no collective): slot ``i`` must
    reach ``owner[i]``.  A stable sort puts the self-owned slots first,
    then the peers' by index, so each destination's window is a
    contiguous range of the unit line; dead slots (``-inf`` weight or
    count 0) stay home and take no window room."""
    my = my.to(torch.int32)[:, None]
    owner = owner_of(spec, yx[..., 0], yx[..., 1])
    live = torch.isfinite(ensemble.log_weights) & (ensemble.counts > 0)
    owner = torch.where(live, owner, my)
    home = owner == my
    order = torch.argsort(torch.where(home, torch.full_like(owner, -1),
                                      owner), dim=-1, stable=True)
    units = torch.where(live & ~home, ensemble.counts,
                        torch.zeros_like(ensemble.counts)).to(torch.int32)
    row_send = torch.zeros(owner.shape[:-1] + (spec.tiles,),
                           dtype=torch.int32, device=owner.device)
    row_send.scatter_add_(-1, owner.long(), units)
    return MigrationPlan(owner, order, row_send)


def _migrate_route(spec: DomainSpec, ensemble: ParticleEnsemble,
                   yx: torch.Tensor, mesh: runtime.EmulatedMesh):
    """Plan, permute, route (one ``all_to_all`` of (state, count,
    log-weight) windows) and merge: the sequence behind ``migrate`` and
    ``exchange_log_likelihood``.  Returns the plan, the route with its
    received windows dropped (the merged ensemble holds them), the merged
    ensemble (capacity ``C + P·K``) and the migration diagnostics."""
    plan = migration_plan(spec, ensemble, yx,
                          runtime.axis_index(mesh, yx.device))
    perm = particles.permute(ensemble, plan.order)
    k_cap = spec.k_cap or ensemble.capacity
    route = dlb.route_compressed(perm, plan.row_send, k_cap=k_cap,
                                 mesh=mesh)
    merged = dlb.merge_routed(perm, route)
    route = route._replace(recv_state=None, recv_counts=None,
                           recv_log_weights=None)
    # units that shipped: the scheduled volume less the overflow residue
    # that stayed on the sender
    diag = {"mig_moved": runtime.psum(
                plan.row_send.sum(-1) - route.overflow_units, mesh)[0],
            "mig_overflow": runtime.psum(route.overflow_units, mesh)[0]}
    return plan, route, merged, diag


def migrate(spec: DomainSpec, ensemble: ParticleEnsemble, yx: torch.Tensor,
            *, mesh: runtime.EmulatedMesh) -> tuple[ParticleEnsemble, dict]:
    """Move every particle to its owner: the compressed ``(P, C + P·K,
    ...)`` merged ensemble and the diagnostics.  Units beyond a window
    stay on the sender; logical size and per-replica log-weights are
    conserved either way."""
    _, _, merged, diag = _migrate_route(spec, ensemble, yx, mesh)
    return merged, diag


def scatter_returned_ll(ll_local: torch.Tensor, ll_back: torch.Tensor,
                        send_slots: torch.Tensor, send_units: torch.Tensor,
                        order: torch.Tensor) -> torch.Tensor:
    """Recombine the likelihoods evaluated at home and by the owners.

    ``ll_local`` ``(P, C)`` (routing layout) holds the home slab's values:
    exact for self-owned slots, clamped for overflow residents, unused for
    shipped and dead ones.  ``ll_back`` ``(P, P, K)``: row ``j`` of shard
    ``i`` is its window to ``j``, evaluated by ``j``.  Every live slot sits
    in at most one window entry with ``send_units > 0``, so each shipped
    slot is written once by a plain scatter (padding entries go to a
    spare half, dropped), with no float atomics; the home layout comes
    back by scattering through ``order``."""
    p, c = ll_local.shape
    slots = send_slots.reshape(p, -1).long()
    sent = send_units.reshape(p, -1) > 0
    # padding entries land in a spare half, spread so that no address
    # takes more than P·K / C of them
    spare = c + torch.arange(slots.shape[-1], device=slots.device) % c
    dest = torch.where(sent, slots, spare.expand_as(slots))
    remote = ll_local.new_zeros((p, 2 * c)).scatter_(
        -1, dest, ll_back.reshape(p, -1))[:, :c]
    shipped = torch.zeros((p, 2 * c), dtype=torch.bool,
                          device=ll_local.device).scatter_(
        -1, dest, sent)[:, :c]
    ll = torch.where(shipped, remote, ll_local)
    return torch.empty_like(ll).scatter_(-1, order.long(), ll)


def exchange_log_likelihood(
        spec: DomainSpec, ensemble: ParticleEnsemble, yx: torch.Tensor,
        tile_ll_fn: Callable[[torch.Tensor], torch.Tensor], *,
        mesh: runtime.EmulatedMesh) -> tuple[torch.Tensor, dict]:
    """The migrate-after-advance hook: particles migrate to their owners,
    ``tile_ll_fn`` evaluates every shard's merged (kept + received) slots
    against its own slab — one call for all shards, ``(P, C + P·K, ...)``
    states in, ``(P, C + P·K)`` out — and the values travel back to their
    home slots with one ``all_to_all``.  Returns ``(P, C)`` home-slot
    log-likelihoods and the diagnostics."""
    p, c = ensemble.log_weights.shape
    plan, route, merged, diag = _migrate_route(spec, ensemble, yx, mesh)
    ll_all = tile_ll_fn(merged.state)
    del merged
    ll_local = ll_all[:, :c]
    ll_recv = ll_all[:, c:].reshape(p, p, -1)
    # row j of ll_back is my window to shard j, evaluated by j
    ll_back = runtime.all_to_all(ll_recv, mesh)
    ll = scatter_returned_ll(ll_local, ll_back, route.send_slots,
                             route.send_units, plan.order)
    return ll, diag
