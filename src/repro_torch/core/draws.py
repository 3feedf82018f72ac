"""Random draws for the port — one small provider per filter.

Torch's Philox cannot reproduce JAX's threefry, so the port never splits
keys.  Every random number goes through a provider that hands out draws
in the order the reference consumes its keys (``run_sir``: the init draws,
then per frame the dynamics normals and the resampler's draws).  Six
kinds: ``uniform``, ``normal``, ``exponential``, ``randint`` (int32, the
proposals of the collective-free resamplers), ``permutation`` (RNA's
slot shuffle) and ``gumbel`` (the noise of a categorical draw:
``jax.random.categorical`` is ``argmax(gumbel + logits)``, with JAX's
default "low" Gumbel ``-log(-log(u))``, ``u`` uniform on
``[tiny, 1)``).  Three providers:

* ``TorchDraws`` wraps one ``torch.Generator`` (the default: one per
  filter, one per bank member);
* ``ReplayDraws`` replays a fixed list of arrays — the tests feed it
  numbers taken from the JAX key stream so both packages see the same
  draws;
* ``BankDraws`` stacks the draws of B member providers along a leading
  slot dim.  An inactive member is not asked for draws (it receives
  zeros of the kind's dtype), so its stream stays frozen exactly like
  its carry.  The distributed filter stacks one provider per shard the
  same way (``shard_draws``), where the reference folds the shard index
  into its key, and a bank over a mesh stacks those: ``(B, P)``
  (``bank_shard_draws``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


# dtype of each draw kind (what a replay is cast to, and the zeros an
# inactive bank member receives)
KIND_DTYPES = {"uniform": torch.float32, "normal": torch.float32,
               "exponential": torch.float32, "randint": torch.int32,
               "permutation": torch.int64, "gumbel": torch.float32}


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

    def randint(self, shape, high: int) -> torch.Tensor:
        """Uniform int32 draws in ``[0, high)`` of ``shape``."""
        return torch.randint(int(high), tuple(shape), generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        """A uniformly random permutation of ``arange(n)``."""
        return torch.randperm(int(n), generator=self.generator,
                              device=self.device)

    def gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel float32 draws ``-log(-log(u))`` of ``shape``,
        ``u`` uniform on ``[tiny, 1)`` (JAX's default "low" mode)."""
        u = self.uniform(shape).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


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
        arr = np.asarray(arr)
        if want_kind != kind or arr.shape != tuple(shape):
            raise ValueError(f"draw {self._pos}: asked {kind} {tuple(shape)},"
                             f" replay holds {want_kind} {arr.shape}")
        self._pos += 1
        return torch.from_numpy(arr.copy()).to(self.device, KIND_DTYPES[kind])

    def uniform(self, shape) -> torch.Tensor:
        """The next replayed uniform draw of ``shape``."""
        return self._next("uniform", shape)

    def normal(self, shape) -> torch.Tensor:
        """The next replayed normal draw of ``shape``."""
        return self._next("normal", shape)

    def exponential(self, shape) -> torch.Tensor:
        """The next replayed exponential draw of ``shape``."""
        return self._next("exponential", shape)

    def randint(self, shape, high: int) -> torch.Tensor:
        """The next replayed int32 draw of ``shape`` (``high`` is the
        caller's bound; the replay holds the reference's numbers)."""
        return self._next("randint", shape)

    def permutation(self, n: int) -> torch.Tensor:
        """The next replayed permutation of ``arange(n)``."""
        return self._next("permutation", (int(n),))

    def gumbel(self, shape) -> torch.Tensor:
        """The next replayed Gumbel draw of ``shape``."""
        return self._next("gumbel", shape)


class BankDraws:
    """Per-member draws stacked along a leading slot dim ``B``.

    ``active`` (a sequence of bools, default all) selects the members
    that draw; the others get zeros and their providers are untouched.
    A member may itself be batched (every member's ``batch_shape`` the
    same): a bank over a mesh stacks one ``shard_draws`` provider per
    member, ``(B, P)``, and member ``i`` draws exactly what its provider
    draws alone.
    """

    def __init__(self, members: Sequence, active: Sequence[bool] | None = None):
        self.members = list(members)
        self.active = ([True] * len(self.members) if active is None
                       else [bool(a) for a in active])
        self.device = self.members[0].device
        inner = {tuple(getattr(m, "batch_shape", ())) for m in self.members}
        if len(inner) != 1:
            raise ValueError(f"bank members of different batch shapes "
                             f"{sorted(inner)}")
        self.member_shape = inner.pop()
        self.batch_shape = (len(self.members),) + self.member_shape

    def set_active(self, active) -> None:
        """Set which members draw from a nested list of bools shaped like
        the member dims (``(B,)``, or ``(B1, B2)`` for a bank of banks:
        a sub-bank draws where any of its members does)."""
        active = list(active)
        if len(active) != len(self.members):
            raise ValueError(f"{len(active)} activity flags for "
                             f"{len(self.members)} members")
        flags = []
        for m, a in zip(self.members, active):
            if isinstance(a, (list, tuple)):
                m.set_active(a)
                a = any(m.active)
            flags.append(bool(a))
        self.active = flags

    def _stack(self, kind: str, shape, *args) -> torch.Tensor:
        outs = [getattr(m, kind)(shape, *args) if a else
                torch.zeros(self.member_shape + tuple(shape),
                            dtype=KIND_DTYPES[kind], device=self.device)
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

    def randint(self, shape, high: int) -> torch.Tensor:
        """``(B,) + shape`` int32 draws in ``[0, high)``."""
        return self._stack("randint", shape, high)

    def gumbel(self, shape) -> torch.Tensor:
        """``(B,) + shape`` Gumbel draws."""
        return self._stack("gumbel", shape)

    def permutation(self, n: int) -> torch.Tensor:
        """``(B, n)``: one permutation per member."""
        ident = torch.arange(int(n), device=self.device)
        outs = [m.permutation(n) if a else
                ident.expand(self.member_shape + (int(n),))
                for m, a in zip(self.members, self.active)]
        return torch.stack(outs)


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s stream in a run seeded ``seed`` (the
    counterpart of the reference's ``fold_in(key, shard)``)."""
    return int(np.random.SeedSequence([int(seed), int(shard)])
               .generate_state(1, np.uint64)[0] >> 1)


def shard_draws(key, shards: int, device):
    """Per-shard draws stacked on a leading ``P`` dim for the distributed
    filter.  An int seed gives each shard a ``torch.Generator`` seeded
    from ``shard_seed``; a provider whose ``batch_shape`` is ``(P,)``
    passes through (the tests hand in one replay per shard)."""
    if isinstance(key, (int, np.integer)):
        return BankDraws([TorchDraws.from_seed(shard_seed(key, i), device)
                          for i in range(shards)])
    if tuple(getattr(key, "batch_shape", ())) == (shards,):
        return key
    raise TypeError(f"distributed draws need an int seed or a provider "
                    f"with batch_shape ({shards},), got {type(key).__name__}")


def bank_shard_draws(keys, shards: int, device) -> BankDraws:
    """The ``(B, P)`` draws of a bank over a ``shards``-shard mesh: member
    ``i``'s shard ``s`` draws exactly the stream ``shard_draws(keys[i],
    shards)`` gives shard ``s`` of a standalone distributed filter."""
    return BankDraws([shard_draws(k, shards, device) for k in keys])


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
