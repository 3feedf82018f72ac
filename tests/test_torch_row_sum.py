"""The fixed-order row sum (``csrc/row_sum.cu``) through its torch
emulation, and the CPU path of the sums that use it, on the CPU.

* ``row_sum_emulated`` (the kernel's order: 1024-element tiles by a fixed
  shuffle tree in float32, the tile partials combined in float64 by
  another) within 1e-6 of a float64 sum, relative to ``Σ|x|``, at ragged
  lengths about the tile and at ``inner`` > 1; with a shift, against a
  float64 ``Σ exp(x - shift)``.  A float32 tile tree of 1024 elements
  carries at most ~10 roundings of 6e-8 each; the float64 combine adds
  none that show.
* A row gives the same bits alone and in a batch of any size, and in
  any position of it (what a bank member needs).
* On the CPU ``invariant_sum``/``invariant_logsumexp`` are torch's own
  sums, unchanged, and ``ops.row_sum`` is the plain version; the kernel
  wrapper refuses a CPU tensor instead of falling back.
On the card chip_smoke.py's phase 2 holds the kernel bit for bit to the
emulation.
"""
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro_torch.core import particles
from repro_torch.kernels import ops
from repro_torch.kernels.row_sum import (TILE, row_sum_emulated,
                                         row_sum_kernel, row_sum_ref)

SHAPES = [(3, 1, 1), (2, 7, 1), (4, TILE - 1, 1), (2, TILE, 1),
          (3, TILE + 1, 1), (2, 5 * TILE + 3, 1), (2, 3000, 5),
          (1, 2 ** 17 + 5, 1), (2, 40, 3)]


def _x(shape, seed, signed=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) if signed else \
        torch.rand(shape, generator=g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("signed", [False, True])
def test_emulation_against_float64(shape, signed):
    x = _x(shape, sum(shape), signed)
    got = row_sum_emulated(x).double()
    want = x.double().sum(1)
    scale = x.double().abs().sum(1).clamp(min=1e-30)
    assert float(((got - want).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES[:6])
def test_shifted_emulation_against_float64(shape):
    x = _x(shape, 7, signed=True) * 4
    shift = x.amax(1)
    got = row_sum_emulated(x, shift).double()
    want = torch.exp(x.double() - shift.double()[:, None]).sum(1)
    assert float(((got - want).abs() / want).max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 1000, TILE + 1, 3 * TILE + 17])
def test_a_row_has_the_same_bits_alone_and_batched(n):
    x = _x((8, n, 2), n, signed=True)
    whole = row_sum_emulated(x)
    shift = x.amax(1)
    whole_s = row_sum_emulated(x, shift)
    for rows in (slice(0, 1), slice(3, 4), slice(2, 6), slice(7, 8)):
        part = x[rows].contiguous()
        assert torch.equal(row_sum_emulated(part), whole[rows])
        assert torch.equal(row_sum_emulated(part, shift[rows]),
                           whole_s[rows])


def test_emulation_orders_by_tile_tree():
    """Inside one tile the order is the shuffle tree, not a running sum:
    a value that the tree cancels early shows in the bits."""
    x = torch.zeros((1, TILE, 1))
    x[0, 0, 0], x[0, 16, 0], x[0, 1, 0] = 1e8, -1e8, 1.0
    # lane 0 + lane 16 cancel at the tree's first level; lane 1 survives
    assert float(row_sum_emulated(x)) == 1.0
    assert float(row_sum_ref(x)) in (0.0, 1.0)      # torch's own order


def test_cpu_sums_are_torch_sums_unchanged():
    x = _x((4, 3000, 5), 3, signed=True)
    for dim in (0, 1, 2, -1):
        for keepdim in (False, True):
            assert torch.equal(particles.invariant_sum(x, dim, keepdim),
                               x.sum(dim, keepdim=keepdim))
            assert torch.equal(
                particles.invariant_logsumexp(x, dim, keepdim),
                torch.logsumexp(x, dim, keepdim=keepdim))
    assert torch.equal(ops.row_sum(x), x.sum(1))
    shift = x.amax(1)
    assert torch.equal(ops.row_sum(x, shift),
                       torch.exp(x - shift[:, None]).sum(1))


def test_kernel_wrapper_refuses_cpu_tensors():
    launches = row_sum_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        row_sum_kernel(torch.zeros((1, 4, 1)))
    assert row_sum_kernel.launches == launches


def test_invariant_sum_reshapes_to_the_kernel_view(monkeypatch):
    """On the card every sum goes to ``ops.row_sum`` as ``(outer, n,
    inner)``, lone rows included, and comes back in the caller's shape;
    here a recording plain version stands for the kernel."""
    calls = []

    def fake(x, shift=None):
        calls.append((tuple(x.shape), None if shift is None
                      else tuple(shift.shape)))
        return row_sum_emulated(x, shift)

    monkeypatch.setattr(particles, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "row_sum", fake)
    x = _x((2, 3, 50, 4), 5, signed=True)
    assert particles.invariant_sum(x, 2).shape == (2, 3, 4)
    assert particles.invariant_sum(x, 2, keepdim=True).shape == (2, 3, 1, 4)
    lone = particles.invariant_sum(x[0, 0, :, 0], 0)
    assert lone.shape == ()
    lse = particles.invariant_logsumexp(x, -1)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(x, -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert calls == [((6, 50, 4), None), ((6, 50, 4), None),
                     ((1, 50, 1), None), ((300, 4, 1), (300, 1))]
