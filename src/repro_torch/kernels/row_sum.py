"""Fixed-order row sums on the card.

``row_sum_kernel`` launches ``csrc/row_sum.cu`` on an ``(outer, n, inner)``
float32 CUDA tensor: the sum over ``n`` of every row and column, or of
``exp(x - shift)`` with a per-row-and-column ``shift``, in one launch,
giving ``(outer, inner)``.  The order of every addition depends on the
row's shape alone (4096-element tiles, each thread of 256 adding its own
quads of 4 floats in sequence, a fixed shuffle tree over the threads, the
tile partials combined in float64 by another), so a row gives the same
bits alone and in any batch: the property
``repro_torch.core.particles.invariant_sum`` needs on the card, where
torch's own sum of a long row is split by the whole tensor's shape.

``row_sum_ref`` is the plain version, torch's sum (the CPU's path);
``row_sum_emulated`` is the kernel's own order of sums written in torch,
bit for bit the kernel's on any device for the plain sum (with a shift
the exponential is torch's, the kernel's ``expf`` on the card).  The
``repro_torch.core`` sums reach the kernel through
``repro_torch.kernels.ops.row_sum``.  ``first_design_kernel`` launches
the first design (1024-element tiles, a tree each), for timing beside it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

TILE = 4096           # elements of a row a tile
THREADS = 256         # threads a block: a tile's runs, the partials' combine
FIRST_TILE = 1024     # the first design's tile


def _exp_shifted(x: torch.Tensor, shift) -> torch.Tensor:
    return x if shift is None else torch.exp(x - shift[:, None, :])


def row_sum_ref(x: torch.Tensor, shift: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``(outer, inner)``: torch's sum over dim 1 of ``x`` ``(outer, n,
    inner)``, of ``exp(x - shift[:, None])`` with a shift (the plain
    version)."""
    return _exp_shifted(x, shift).sum(1)


def _tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum of the last dim (a power of 2) by ``__shfl_down_sync``
    halvings: lane l adds lane l + o for o = size/2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _block_tree(v: torch.Tensor) -> torch.Tensor:
    """The kernel's tree over ``(..., THREADS)`` thread values: each warp's
    shuffle tree, then the 8 warp sums by offsets 4, 2, 1."""
    return _tree(_tree(v.unflatten(-1, (THREADS // 32, 32))))


def row_sum_emulated(x: torch.Tensor, shift: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """``k_row_sum``'s float32 result for ``(outer, n, inner)`` float32
    ``x``: a tile's ``TILE * inner`` floats as quads, thread t adding the
    floats of quads ``j * THREADS + t`` of each column (float f's column
    is ``f % inner``) in sequence, the runs summed by the block tree; the
    tile partials accumulated in float64 in sequence per thread and
    combined by the same tree, rounded once."""
    outer, n, inner = x.shape
    v = _exp_shifted(x, shift)
    tiles = -(-n // TILE)
    pad = v.new_zeros((outer, tiles * TILE, inner))
    pad[:, :n] = v
    quads = TILE // (4 * THREADS) * inner  # a thread's quads a tile
    q = pad.reshape(outer, tiles, quads, THREADS, 4)
    cols = torch.arange(inner, device=x.device)[:, None]
    f = (torch.arange(quads, device=x.device)[:, None, None] * THREADS
         + torch.arange(THREADS, device=x.device)[None, :, None]) * 4 \
        + torch.arange(4, device=x.device)
    run = v.new_zeros((outer, tiles, inner, THREADS))
    for j in range(quads):                 # each thread's run, in sequence
        for k in range(4):
            e = q[:, :, j, None, :, k]
            run = run + (e if inner == 1 else
                         torch.where(f[j, :, k] % inner == cols, e, 0.0))
    part = _block_tree(run)                # (outer, tiles, inner)
    rounds = -(-tiles // THREADS)
    p = part.new_zeros((outer, inner, rounds * THREADS), dtype=torch.float64)
    p[..., :tiles] = part.transpose(1, 2).double()
    p = p.reshape(outer, inner, rounds, THREADS)
    acc = torch.zeros((outer, inner, THREADS), dtype=torch.float64,
                      device=x.device)
    for r in range(rounds):               # thread j: partials j, j + 256, ...
        acc = acc + p[:, :, r]
    return _block_tree(acc).to(torch.float32)


@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("row_sum")
    for fn in (lib.ppf_row_sum, lib.ppf_row_sum_v1):
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ppf_row_sum_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.ppf_row_sum_occupancy.restype = ctypes.c_int
    return lib


# (device index, raw stream) -> (tensor, size, pointer) of the zeroed
# int32 counters, one a row: the kernel's last block of a row resets its
# counter, so they stay zero between calls on the stream
_COUNTERS: dict = {}
# (device index, raw stream) -> (tensor, size, pointer) of the tile
# partials (written before read within a launch; launches on one stream
# run in order)
_PARTIALS: dict = {}


def _scratch(dev: int, stream: int, device, outer: int,
             floats: int) -> tuple[int, int]:
    """Pointers to the stream's counters and partials, grown to a call's
    need (a call reads no attribute of the cached tensors)."""
    key = (dev, stream)
    count = _COUNTERS.get(key)
    if count is None or count[1] < outer:
        t = torch.zeros((max(outer, 64),), dtype=torch.int32, device=device)
        count = _COUNTERS[key] = (t, t.numel(), t.data_ptr())
    part = _PARTIALS.get(key)
    if part is None or part[1] < floats:
        t = torch.empty((max(floats, 1 << 16),), dtype=torch.float32,
                        device=device)
        part = _PARTIALS[key] = (t, t.numel(), t.data_ptr())
    return count[2], part[2]


def _check(x: torch.Tensor, shift) -> None:
    """Raise on what the kernel does not take (the launch's slow path)."""
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (outer, n, inner) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] >= 2 ** 31:
        raise ValueError(f"rows of {x.shape[1]} are beyond the kernel")
    outer, _, inner = x.shape
    raise ValueError(f"shift must be a contiguous float32 ({outer}, "
                     f"{inner}) tensor on {x.device}, got "
                     f"{tuple(shift.shape)} {shift.dtype} on {shift.device}")


def _launch(entry: str, tile: int, x: torch.Tensor,
            shift) -> tuple[torch.Tensor, bool]:
    """The sums by one launch of the C ``entry`` (``ppf_row_sum`` or its
    first design) on ``x``, and whether it launched (an empty ``x`` does
    not); the C entry refuses what its grid cannot hold."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3
            and x.is_contiguous() and x.shape[1] < 2 ** 31
            and (shift is None or (shift.device == x.device
                                   and shift.dtype == torch.float32
                                   and shift.shape == (x.shape[0],
                                                       x.shape[2])
                                   and shift.is_contiguous()))):
        _check(x, shift)
    outer, n, inner = x.shape
    out = x.new_empty((outer, inner))
    if n == 0 or out.numel() == 0:
        return out.zero_(), False
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    count, part = _scratch(dev, stream, x.device, outer,
                           outer * -(-n // tile) * inner)
    err = getattr(_lib(), entry)(
        x.data_ptr(), 0 if shift is None else shift.data_ptr(),
        out.data_ptr(), part, count, outer, n, inner, stream)
    if err != 0:
        raise RuntimeError(f"row_sum kernel launch failed: cudaError {err} "
                           f"at {tuple(x.shape)}")
    return out, True


def row_sum_kernel(x: torch.Tensor, shift: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """The row sum on the card: ``(outer, inner)`` float32 sums over dim 1
    of a contiguous CUDA float32 ``x`` ``(outer, n, inner)``, of
    ``exp(x - shift)`` with a contiguous ``(outer, inner)`` float32
    ``shift``, in one launch."""
    out, launched = _launch("ppf_row_sum", TILE, x, shift)
    row_sum_kernel.launches += launched
    return out


row_sum_kernel.launches = 0


def first_design_kernel(x: torch.Tensor, shift: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The first design of the row sum (``k_row_sum_v1``), same contract,
    another order; for timing beside ``row_sum_kernel`` only."""
    return _launch("ppf_row_sum_v1", FIRST_TILE, x, shift)[0]


def occupancy(inner: int, shift: bool = False) -> dict:
    """Registers a thread and resident blocks an SM of the kernel that a
    call with this ``inner`` launches."""
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = _lib().ppf_row_sum_occupancy(inner, int(shift), ctypes.byref(regs),
                                       ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"row_sum occupancy query failed: cudaError {err}")
    return {"registers": regs.value, "blocks_per_sm": blocks.value,
            "threads": THREADS}
