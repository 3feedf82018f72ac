"""The fixed-order row sum (``csrc/row_sum.cu``) through its torch
emulation, and the CPU path of the sums that use it, on the CPU.

* ``row_sum_emulated`` (the kernel's order: 4096-element tiles, each of
  256 threads adding its quads of 4 floats a column in sequence, then a
  fixed shuffle tree in float32; the tile partials combined in float64 by
  another) within 1e-6 of a float64 sum, relative to ``Σ|x|``, at ragged
  lengths about the tile (the first design's 1024 and this one's 4096),
  at ``n * inner`` not a multiple of 4 and at ``inner`` 1 to 8 and past
  8 (the kernel's generic path); with a shift, against a float64
  ``Σ exp(x - shift)``.  A thread's run of 16 floats a column and the
  8-level tree carry at most ~24 roundings of 6e-8 each, relative to
  ``Σ|x|``; the float64 combine adds none that show.
* A row gives the same bits alone and in a batch of any size, and in
  any position of it (what a bank member needs), and from a 16-byte
  aligned or a misaligned start (the kernel's vector and scalar loads).
* On the CPU ``invariant_sum``/``invariant_logsumexp`` are torch's own
  sums, unchanged, and ``ops.row_sum`` is the plain version; the kernel
  wrapper refuses a CPU tensor instead of falling back.
On the card chip_smoke.py's phase 2 holds the kernel bit for bit to the
emulation.
"""
import pathlib
import re

import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro_torch.core import particles
from repro_torch.kernels import ops
from repro_torch.kernels import row_sum as row_sum_mod
from repro_torch.kernels.row_sum import (FIRST_TILE, THREADS, TILE,
                                         first_design_kernel,
                                         row_sum_emulated, row_sum_kernel,
                                         row_sum_ref)

SHAPES = [(3, 1, 1), (2, 7, 1), (4, FIRST_TILE - 1, 1), (2, FIRST_TILE, 1),
          (3, FIRST_TILE + 1, 1), (2, 5 * FIRST_TILE + 3, 1), (2, 3000, 5),
          (1, 2 ** 17 + 5, 1), (2, 40, 3),
          # the tile's boundaries, n * inner % 4 != 0, inner 2, 5, 8 and
          # past 8 (the generic path)
          (2, TILE - 1, 1), (2, TILE, 1), (3, TILE + 1, 1),
          (2, 3 * TILE + 3, 1), (3, 1001, 3), (2, TILE + 7, 5),
          (2, 2 * TILE + 1, 2), (2, TILE + 3, 8), (2, 700, 5),
          (2, TILE + 5, 11), (1, 300, 40)]


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


@pytest.mark.parametrize("shape", SHAPES[:6] + SHAPES[9:])
def test_shifted_emulation_against_float64(shape):
    x = _x(shape, 7, signed=True) * 4
    shift = x.amax(1)
    got = row_sum_emulated(x, shift).double()
    want = torch.exp(x.double() - shift.double()[:, None]).sum(1)
    assert float(((got - want).abs() / want).max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 1000, 1025, 3089, TILE - 1, TILE + 1,
                               2 * TILE + 3])
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
    """Inside one tile the order is each thread's run of its quads in
    sequence, then the shuffle tree: values that the run cancels early
    show in the bits, where a tree over neighbours (the first design's
    order) loses them."""
    x = torch.zeros((1, TILE, 1))
    # thread 0's run: 1e8 - 1e8 cancels before the 1 comes; a tree over
    # lanes (x0 + x2) + (x1 + x3) rounds the 1 away
    x[0, 0, 0], x[0, 1, 0], x[0, 2, 0] = 1e8, -1e8, 1.0
    assert float(row_sum_emulated(x)) == 1.0
    assert float(row_sum_ref(x)) in (0.0, 1.0)      # torch's own order
    # thread 0's second quad is float 4 * THREADS, not float 4: its run
    # cancels 1e8 by itself and thread 1's 1 survives the tree
    x = torch.zeros((1, TILE, 1))
    x[0, 0, 0], x[0, 4 * THREADS, 0], x[0, 4, 0] = 1e8, -1e8, 1.0
    assert float(row_sum_emulated(x)) == 1.0


def test_emulation_columns_are_float_index_mod_inner():
    """At inner > 1 a tile's floats go to the threads as quads whatever
    the column (float f is column f % inner): at inner = 5 thread 0 holds
    floats 0-3, 1024-1027, 2048-2051, ... and float 5 is thread 1's."""
    x = torch.zeros((1, TILE, 5))
    flat = x.view(-1)
    # column 0: thread 0's run 1e8 - 1e8 (floats 0, 1025), thread 1's 1
    flat[0], flat[1025], flat[5] = 1e8, -1e8, 1.0
    # column 4: thread 0's run in sequence, floats 1024, 2049, 3074: the 2
    # is lost against 1e8 before -1e8 comes
    flat[1024], flat[2049], flat[3074] = 1e8, 2.0, -1e8
    got = row_sum_emulated(x)
    assert float(got[0, 0]) == 1.0
    assert float(got[0, 4]) == 0.0
    assert torch.equal(got[0, 1:4], torch.zeros(3))


@pytest.mark.parametrize("shape", [(2, TILE + 1, 1), (3, 1001, 3),
                                   (2, TILE + 7, 5)])
def test_a_misaligned_row_has_the_same_bits(shape):
    """The order is on logical indices: a row read from a start 4 bytes
    past a 16-byte boundary (the kernel's scalar loads) sums as the same
    row at an aligned start (its vector loads)."""
    outer, n, inner = shape
    base = _x((outer * n * inner + 1,), n, signed=True)
    shifted = base[1:].view(outer, n, inner)
    assert shifted.data_ptr() % 16 != 0
    aligned = shifted.clone()
    assert aligned.data_ptr() % 16 == 0
    shift = aligned.amax(1)
    assert torch.equal(row_sum_emulated(shifted), row_sum_emulated(aligned))
    assert torch.equal(row_sum_emulated(shifted, shift),
                       row_sum_emulated(aligned, shift))


def test_emulation_constants_match_the_kernel_source():
    """The emulation's tile and block are the kernel's (csrc/row_sum.cu),
    and the first design's tile is tile_reduce.cuh's."""
    csrc = pathlib.Path(row_sum_mod.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "row_sum.cu").read_text()
    consts = dict(re.findall(r"constexpr int (RS_\w+) = (\d+);", src))
    assert int(consts["RS_TILE"]) == TILE
    assert int(consts["RS_THREADS"]) == THREADS
    reduce = (csrc / "tile_reduce.cuh").read_text()
    assert f"constexpr int TILE = {FIRST_TILE};" in reduce


def test_scratch_is_kept_per_stream_and_grown():
    """The counters and partials stay per (device, stream), are reused by
    smaller calls and grown by larger ones (counters zeroed)."""
    saved = dict(row_sum_mod._COUNTERS), dict(row_sum_mod._PARTIALS)

    def held(stream):
        return (row_sum_mod._COUNTERS[(7, stream)],
                row_sum_mod._PARTIALS[(7, stream)])

    try:
        ptrs = row_sum_mod._scratch(7, 123, "cpu", 8, 1000)
        (count, n_count, _), (part, n_part, _) = held(123)
        assert ptrs == (count.data_ptr(), part.data_ptr())
        assert n_count == count.numel() >= 8 and n_part == part.numel() >= 1000
        assert not count.any()
        assert row_sum_mod._scratch(7, 123, "cpu", 4, 10) == ptrs
        assert held(123)[0][0] is count and held(123)[1][0] is part
        other = row_sum_mod._scratch(7, 124, "cpu", 4, 10)
        assert held(124)[0][0] is not count and held(124)[1][0] is not part
        assert other == (held(124)[0][2], held(124)[1][2])
        row_sum_mod._scratch(7, 123, "cpu", 1000, 1 << 20)
        (count, n_count, _), (part, n_part, p_ptr) = held(123)
        assert n_count >= 1000 and n_part >= 1 << 20 and not count.any()
        assert row_sum_mod._scratch(7, 123, "cpu", 8, 10)[1] == p_ptr
    finally:
        row_sum_mod._COUNTERS.clear()
        row_sum_mod._COUNTERS.update(saved[0])
        row_sum_mod._PARTIALS.clear()
        row_sum_mod._PARTIALS.update(saved[1])


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
    with pytest.raises(ValueError, match="CUDA"):
        first_design_kernel(torch.zeros((1, 4, 1)))
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
