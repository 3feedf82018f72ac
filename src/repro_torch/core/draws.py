"""Random draws for the port — one small provider per filter.

Torch's Philox cannot reproduce JAX's threefry, so the port never splits
keys.  Every random number goes through a provider that hands out draws
in the order the reference consumes its keys (``run_sir``: the init draws,
then per frame the dynamics normals and the comb uniform).  Three
providers:

* ``TorchDraws`` wraps one ``torch.Generator`` (the default: one per
  filter, one per bank member);
* ``ReplayDraws`` replays a fixed list of arrays — the tests feed it
  numbers taken from the JAX key stream so both packages see the same
  draws;
* ``BankDraws`` stacks the draws of B member providers along a leading
  slot dim.  An inactive member is not asked for draws (it receives
  zeros), so its stream stays frozen exactly like its carry.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class TorchDraws:
    """Draws from one ``torch.Generator`` on the generator's device."""

    batch_shape = ()

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    @classmethod
    def from_seed(cls, seed: int, device) -> "TorchDraws":
        """A fresh generator on ``device`` seeded with ``seed``."""
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(int(seed))
        return cls(g)

    def uniform(self, shape) -> torch.Tensor:
        """U[0, 1) float32 draws of ``shape``."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape) -> torch.Tensor:
        """Standard-normal float32 draws of ``shape``."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def exponential(self, shape) -> torch.Tensor:
        """Exp(1) float32 draws of ``shape``."""
        out = torch.empty(tuple(shape), device=self.device,
                          dtype=torch.float32)
        return out.exponential_(generator=self.generator)


class ReplayDraws:
    """Replays ``(kind, array)`` pairs in order; raises on any mismatch
    of kind or shape, so a test cannot silently feed the wrong draw."""

    batch_shape = ()

    def __init__(self, draws: Sequence[tuple[str, np.ndarray]], device="cpu"):
        self._draws = list(draws)
        self._pos = 0
        self.device = torch.device(device)

    @property
    def remaining(self) -> int:
        """Draws not consumed yet."""
        return len(self._draws) - self._pos

    def _next(self, kind: str, shape) -> torch.Tensor:
        if self._pos >= len(self._draws):
            raise IndexError(f"replay exhausted at draw {self._pos} "
                             f"({kind} {tuple(shape)})")
        want_kind, arr = self._draws[self._pos]
        arr = np.asarray(arr, np.float32)
        if want_kind != kind or arr.shape != tuple(shape):
            raise ValueError(f"draw {self._pos}: asked {kind} {tuple(shape)},"
                             f" replay holds {want_kind} {arr.shape}")
        self._pos += 1
        return torch.from_numpy(arr.copy()).to(self.device)

    def uniform(self, shape) -> torch.Tensor:
        """The next replayed uniform draw of ``shape``."""
        return self._next("uniform", shape)

    def normal(self, shape) -> torch.Tensor:
        """The next replayed normal draw of ``shape``."""
        return self._next("normal", shape)

    def exponential(self, shape) -> torch.Tensor:
        """The next replayed exponential draw of ``shape``."""
        return self._next("exponential", shape)


class BankDraws:
    """Per-member draws stacked along a leading slot dim ``B``.

    ``active`` (a sequence of bools, default all) selects the members
    that draw; the others get zeros and their providers are untouched.
    """

    def __init__(self, members: Sequence, active: Sequence[bool] | None = None):
        self.members = list(members)
        self.active = ([True] * len(self.members) if active is None
                       else [bool(a) for a in active])
        self.device = self.members[0].device
        self.batch_shape = (len(self.members),)

    def _stack(self, kind: str, shape) -> torch.Tensor:
        outs = [getattr(m, kind)(shape) if a else
                torch.zeros(tuple(shape), device=self.device)
                for m, a in zip(self.members, self.active)]
        return torch.stack(outs)

    def uniform(self, shape) -> torch.Tensor:
        """``(B,) + shape`` uniform draws."""
        return self._stack("uniform", shape)

    def normal(self, shape) -> torch.Tensor:
        """``(B,) + shape`` normal draws."""
        return self._stack("normal", shape)

    def exponential(self, shape) -> torch.Tensor:
        """``(B,) + shape`` exponential draws."""
        return self._stack("exponential", shape)


def as_draws(key, device):
    """Turn a run's ``key`` into a provider: an ``int`` seeds a fresh
    ``torch.Generator`` on ``device``, a ``torch.Generator`` is wrapped,
    and a provider (anything with ``uniform``/``normal``) passes through.
    """
    if isinstance(key, (int, np.integer)):
        return TorchDraws.from_seed(int(key), device)
    if isinstance(key, torch.Generator):
        return TorchDraws(key)
    if hasattr(key, "uniform") and hasattr(key, "normal"):
        return key
    raise TypeError(f"cannot make draws from {type(key).__name__}")
