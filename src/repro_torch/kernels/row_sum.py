"""Fixed-order row sums on the card.

``row_sum_kernel`` launches ``csrc/row_sum.cu`` on an ``(outer, n, inner)``
float32 CUDA tensor: the sum over ``n`` of every row and column, or of
``exp(x - shift)`` with a per-row-and-column ``shift``, in one launch,
giving ``(outer, inner)``.  The order of every addition depends on ``n``
alone (1024-element tiles reduced by a fixed shuffle tree, their partials
combined in float64 by another), so a row gives the same bits alone and
in any batch: the property ``repro_torch.core.particles.invariant_sum``
needs on the card, where torch's own sum of a long row is split by the
whole tensor's shape.

``row_sum_ref`` is the plain version, torch's sum (the CPU's path);
``row_sum_emulated`` is the kernel's own order of sums written in torch,
bit for bit the kernel's on any device for the plain sum (with a shift
the exponential is torch's, the kernel's ``expf`` on the card).  The
``repro_torch.core`` sums reach the kernel through
``repro_torch.kernels.ops.row_sum``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scan import _warp_tree

TILE = 1024           # elements a tile == threads a block (tile_reduce.cuh)
WARPS = TILE // 32


def _exp_shifted(x: torch.Tensor, shift) -> torch.Tensor:
    return x if shift is None else torch.exp(x - shift[:, None, :])


def row_sum_ref(x: torch.Tensor, shift: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``(outer, inner)``: torch's sum over dim 1 of ``x`` ``(outer, n,
    inner)``, of ``exp(x - shift[:, None])`` with a shift (the plain
    version)."""
    return _exp_shifted(x, shift).sum(1)


def _block_tree(v: torch.Tensor) -> torch.Tensor:
    """``block_sum``'s result for ``(..., TILE)`` thread values: each
    warp's shuffle tree, then the tree over the 32 warp sums."""
    return _warp_tree(_warp_tree(v.unflatten(-1, (WARPS, 32))))


def row_sum_emulated(x: torch.Tensor, shift: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """``k_row_sum``'s float32 result for ``(outer, n, inner)`` float32
    ``x``: tile sums in float32 by the block tree, their partials
    accumulated in float64 in sequence per thread and combined by the
    same tree, rounded once."""
    outer, n, inner = x.shape
    v = _exp_shifted(x, shift)
    tiles = -(-n // TILE)
    pad = v.new_zeros((outer, tiles * TILE, inner))
    pad[:, :n] = v
    # (outer, inner, tiles, TILE): a tile's threads last
    part = _block_tree(pad.reshape(outer, tiles, TILE, inner)
                       .permute(0, 3, 1, 2))
    rounds = -(-tiles // TILE)
    p = part.new_zeros((outer, inner, rounds * TILE), dtype=torch.float64)
    p[..., :tiles] = part.double()
    p = p.reshape(outer, inner, rounds, TILE)
    acc = torch.zeros((outer, inner, TILE), dtype=torch.float64,
                      device=x.device)
    for r in range(rounds):           # thread j: partials j, j + TILE, ...
        acc = acc + p[:, :, r]
    return _block_tree(acc).to(torch.float32)


@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("row_sum")
    lib.ppf_row_sum.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ppf_row_sum.restype = ctypes.c_int
    return lib


# (device index, raw stream) -> zeroed int32 counters, one a row: the
# kernel's last block of a row resets its counter, so they stay zero
# between calls on the stream
_COUNTERS: dict = {}


def row_sum_kernel(x: torch.Tensor, shift: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """The row sum on the card: ``(outer, inner)`` float32 sums over dim 1
    of a contiguous CUDA float32 ``x`` ``(outer, n, inner)``, of
    ``exp(x - shift)`` with a contiguous ``(outer, inner)`` float32
    ``shift``, in one launch."""
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (outer, n, inner), got "
                         f"{tuple(x.shape)}")
    outer, n, inner = x.shape
    if shift is not None and (shift.device != x.device
                              or shift.dtype != torch.float32
                              or tuple(shift.shape) != (outer, inner)
                              or not shift.is_contiguous()):
        raise ValueError(f"shift must be a contiguous float32 ({outer}, "
                         f"{inner}) tensor on {x.device}, got "
                         f"{tuple(shift.shape)} {shift.dtype} on "
                         f"{shift.device}")
    if n >= 2 ** 31 or inner >= 2 ** 31:
        raise ValueError(f"rows of {n} x {inner} are beyond the kernel")
    if outer == 0 or inner == 0 or n == 0:
        return torch.zeros((outer, inner), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((outer, inner), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    count = _COUNTERS.get((dev, stream))
    if count is None or count.numel() < outer:
        count = torch.zeros((max(outer, 64),), dtype=torch.int32,
                            device=x.device)
        _COUNTERS[(dev, stream)] = count
    part = torch.empty((outer * -(-n // TILE) * inner,), dtype=torch.float32,
                       device=x.device)
    err = _lib().ppf_row_sum(
        x.data_ptr(), 0 if shift is None else shift.data_ptr(),
        out.data_ptr(), part.data_ptr(), count.data_ptr(), outer, n, inner,
        stream)
    if err != 0:
        raise RuntimeError(f"row_sum kernel launch failed: cudaError {err}")
    row_sum_kernel.launches += 1
    return out


row_sum_kernel.launches = 0
