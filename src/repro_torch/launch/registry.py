"""Multi-bank fleet registry and placement policies (port of
``repro.launch.registry``; pure Python).

The paper's dynamic load balancing (§III) schedules *particles* onto
*processes*; the fleet schedules *sessions* onto *banks*, each bank a
resident ``ParticleSessionServer`` behind a ``ParticleFrontend``
(``repro_torch.serve.fleet`` runs them).  This module is that layer's
control-plane vocabulary:

* ``BankSpec`` — one bank's declarative description (name, capacity
  tier, standby flag); the registry round-trips through
  ``repro_torch.checkpoint.store.save_json``.
* ``FleetRegistry`` — the named spec collection, standbys included.
* Placement policies — ``LeastLoaded`` (default) and
  ``CapacityTierAware`` pick a destination from ``BankView`` load
  snapshots; pure functions of the views.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.checkpoint import store


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """Declarative description of one fleet bank.

    Attributes:
      name: fleet-unique bank name (also its metrics/report label).
      capacity: ``B_max`` slot count of the bank's resident server —
        the bank's capacity tier, which ``CapacityTierAware`` placement
        keys on.
      standby: ``True`` for a spec that is registered but not started;
        the controller activates standbys on scale-out (DESIGN.md
        §16.3).
    """

    name: str
    capacity: int
    standby: bool = False

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not self.name:
            raise ValueError("bank name must be non-empty")


class FleetRegistry:
    """Named collection of ``BankSpec``\\ s, durable via the checkpoint
    store.

    The registry is pure control-plane data: it knows which banks exist
    and which are standby capacity, never how to build a server (that
    factory belongs to the controller).  ``save``/``load`` round-trip
    it through ``checkpoint.store.save_json`` — the "controller
    snapshot of the registry itself" half of the fleet's durability
    story (DESIGN.md §16.4).
    """

    def __init__(self, specs: Sequence[BankSpec] = ()):
        self._specs: dict[str, BankSpec] = {}
        for spec in specs:
            self.register(spec)

    def register(self, spec: BankSpec) -> None:
        """Add a spec; re-registering an existing name is an error
        (remove first — silent replacement of a live bank's spec is how
        capacity accounting drifts)."""
        if spec.name in self._specs:
            raise ValueError(f"bank {spec.name!r} already registered")
        self._specs[spec.name] = spec

    def remove(self, name: str) -> BankSpec:
        """Drop and return the named spec (KeyError if absent)."""
        return self._specs.pop(name)

    def get(self, name: str) -> BankSpec:
        """The named spec (KeyError if absent)."""
        return self._specs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    def names(self) -> list[str]:
        """All registered names, in registration order."""
        return list(self._specs)

    def active(self) -> list[BankSpec]:
        """Specs the controller starts at boot (non-standby)."""
        return [s for s in self._specs.values() if not s.standby]

    def standbys(self) -> list[BankSpec]:
        """Scale-out capacity: registered but not started at boot."""
        return [s for s in self._specs.values() if s.standby]

    def total_capacity(self, include_standby: bool = False) -> int:
        """Sum of bank capacities (the fleet's slot budget)."""
        return sum(s.capacity for s in self._specs.values()
                   if include_standby or not s.standby)

    # -- durability (DESIGN.md §16.4) ---------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready form (inverse of ``from_dict``)."""
        return {"banks": [dataclasses.asdict(s) for s in self._specs.values()]}

    @classmethod
    def from_dict(cls, data: dict) -> "FleetRegistry":
        """Rebuild from ``to_dict`` output."""
        return cls([BankSpec(**row) for row in data["banks"]])

    def save(self, directory: str) -> str:
        """Persist atomically via ``checkpoint.store.save_json``."""
        return store.save_json(directory, "registry", self.to_dict())

    @classmethod
    def load(cls, directory: str) -> "FleetRegistry":
        """Restore a registry written by ``save``."""
        return cls.from_dict(store.load_json(directory, "registry"))


@dataclasses.dataclass(frozen=True)
class BankView:
    """Load snapshot of one live bank, as placement policies see it.

    Built by the fleet controller from the bank's
    ``repro_torch.serve.metrics`` snapshot each time a placement or rebalance
    decision is made.

    Attributes:
      name: bank name (what ``choose`` returns).
      capacity: resident slot count.
      live_streams: open fleet streams currently homed on the bank
        (may exceed ``capacity`` — the overflow is parked).
      occupancy: attached sessions (≤ ``capacity``).
      queue_depth: undelivered frames across the bank's streams.
      step_ms_p50: median bank-step wall time (ms) over the metrics
        window (0 before the first step).
      ess_mean: mean per-frame ESS over the window (0 before the first
        frame) — a quality signal: a bank whose sessions degenerate
        together is doing harder inference per frame.
    """

    name: str
    capacity: int
    live_streams: int
    occupancy: int
    queue_depth: int
    step_ms_p50: float = 0.0
    ess_mean: float = 0.0

    @property
    def load(self) -> float:
        """Residency pressure: live streams per slot."""
        return self.live_streams / self.capacity


class LeastLoaded:
    """Default placement: the bank with the lowest residency pressure
    (ties broken by queue depth, then name for determinism)."""

    def choose(self, views: Sequence[BankView]) -> str:
        """Pick a destination bank name from live-bank ``views``."""
        if not views:
            raise ValueError("no live banks to place on")
        return min(views,
                   key=lambda v: (v.load, v.queue_depth, v.name)).name


class CapacityTierAware:
    """Tier-aware placement: smallest-capacity bank with a free slot.

    Rationale (DESIGN.md §16.1): a single-device bank's step cost is
    set by its occupancy *tier* (§15.2), so packing small banks tight
    keeps big banks' high tiers cold — the fleet steps small programs.
    When every bank is at residency, falls back to ``LeastLoaded`` (the
    overflow parks wherever pressure is lowest).
    """

    def choose(self, views: Sequence[BankView]) -> str:
        """Pick a destination bank name from live-bank ``views``."""
        free = [v for v in views if v.live_streams < v.capacity]
        if free:
            return min(free, key=lambda v: (v.capacity, v.load, v.name)).name
        return LeastLoaded().choose(views)
