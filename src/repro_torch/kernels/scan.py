"""The comb's CDF on the card: a fixed-order float32 scan.

``prefix_sum_kernel`` launches ``csrc/comb_scan.cu`` on a ``(rows, n)``
CUDA tensor: one launch of ``k_scan_lookback`` at every shape, x read once
and y written once.  ``prefix_sum_ref`` is its plain version, a scan
accumulated in float64 and rounded once per prefix, as the kernel does.
On the CPU that is bit for bit ``torch.cumsum(x, -1)`` of a float32 row
(torch's CPU scan accumulates float32 in double); on the card it is the
CPU's answer.  The comb schemes of ``repro_torch.core.resampling`` reach
either through ``repro_torch.kernels.ops.prefix_sum``.

``prefix_sum_emulated`` is the kernel's own order of sums written in
torch: the tile of ``SPAN`` elements, a thread's ``PER`` in sequence, the
shuffle trees, the group sums.  It gives the kernel's bits on any device,
so the CPU tests hold the kernel's arithmetic against the reference.

torch's own CUDA ``cumsum`` of one long row is CUB's device scan, whose
float32 result changes from run to run; the kernel's sums have a fixed
order, so it repeats bit for bit and a row never depends on the others.

``plan`` is pure Python: ``"lookback"`` for every call.  The first design
(``"three_pass"``: tile totals, a one-block-per-row offset walk, the
apply pass) stays launchable through ``_launch`` for same-run timing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_c_p = ctypes.c_void_p
_c_i = ctypes.c_int

# k_scan_lookback's shape (csrc/comb_scan.cu): THREADS threads a tile, PER
# consecutive elements each, GROUP tiles a group sum; a scratch slot is a
# double and its epoch flag (16 B)
THREADS, PER, GROUP = 256, 16, 32
SPAN = THREADS * PER
SLOT_BYTES = 16
EPOCHS = 2 ** 32


class ScanPlan(NamedTuple):
    variant: str        # "lookback", or "three_pass" (the first design)
    tiles: int          # tiles of SPAN elements a row
    blocks: int         # blocks of the launch: rows x tiles
    scratch_bytes: int  # the ticket, a slot a tile and a slot a group


def plan(rows: int, n: int) -> ScanPlan:
    """The launch of a ``(rows, n)`` scan: one block a tile of ``SPAN``
    elements, and the scratch layout ``ppf_prefix_sum`` reads (a 16-byte
    ticket, then a slot per tile and per group of ``GROUP`` tiles, row by
    row).  Pure Python; the kernel checks the grid again."""
    tiles = -(-n // SPAN)
    groups = -(-tiles // GROUP)
    return ScanPlan("lookback", tiles, rows * tiles,
                    16 + rows * (tiles + groups) * SLOT_BYTES)


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``x`` along its last dim, accumulated in float64
    and rounded to ``x``'s dtype (the plain version)."""
    return torch.cumsum(x.double(), -1).to(x.dtype)


def _shift_scan(v: torch.Tensor, width: int) -> torch.Tensor:
    """Kogge-Stone inclusive scan over the last dim (``width`` lanes), as
    ``__shfl_up_sync`` steps: lane l adds lane l - o for o = 1, 2, 4..."""
    o = 1
    while o < width:
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], -1)
        o *= 2
    return v


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum of 32 lanes (last dim) in ``__shfl_down_sync``'s tree:
    lane l adds lane l + o for o = 16, 8, 4, 2, 1."""
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def prefix_sum_emulated(x: torch.Tensor) -> torch.Tensor:
    """``k_scan_lookback``'s float32 result for a ``(rows, n)`` float32
    ``x``, from its own order of float64 sums (every sum a plain add, so
    the bits are the kernel's on any device)."""
    rows, n = x.shape
    p = plan(rows, n)
    nt = p.tiles
    v = torch.zeros((rows, nt * SPAN), dtype=torch.float64, device=x.device)
    v[:, :n] = x.double()
    v = v.reshape(rows, nt, THREADS, PER)
    # a thread's elements in sequence
    run = [v[..., 0] + 0.0]                   # the kernel's 0.0 + x0
    for k in range(1, PER):
        run.append(run[-1] + v[..., k])
    run = torch.stack(run, -1)                         # (rows, nt, T, PER)
    warp = _shift_scan(run[..., -1].reshape(rows, nt, THREADS // 32, 32), 32)
    scanned = _shift_scan(warp[..., 31], THREADS // 32)   # warp totals
    zero = torch.zeros_like(scanned[..., :1])
    earlier = torch.cat([zero, scanned[..., :-1]], -1)[..., None]
    prev = torch.cat([torch.zeros_like(warp[..., :1]), warp[..., :-1]], -1)
    has_earlier = torch.arange(THREADS // 32, device=x.device)[:, None] > 0
    lane0 = torch.arange(32, device=x.device) == 0
    excl = torch.where(lane0, earlier.expand_as(warp),
                       torch.where(has_earlier, earlier + prev, prev))
    excl = excl.reshape(rows, nt, THREADS)
    total = scanned[..., -1]                           # (rows, nt)
    # tile offsets: the groups before (lane-strided partial sums, then the
    # tree) plus the tiles before in the group (the tree, zeros above)
    ng = -(-nt // GROUP)
    agg = torch.zeros((rows, ng * GROUP), dtype=torch.float64,
                      device=x.device)
    agg[:, :nt] = total
    agg = agg.reshape(rows, ng, GROUP)
    gsum = _warp_tree(agg)                             # (rows, ng)
    lanes = torch.arange(GROUP, device=x.device)
    below = lanes[None, :] < lanes[:, None]            # [r, l]: l < r
    in_group = _warp_tree(torch.where(below, agg[:, :, None, :], 0.0))
    kk = -(-ng // 32)
    gpad = torch.zeros((rows, kk * 32), dtype=torch.float64, device=x.device)
    gpad[:, :ng] = gsum
    gpad = gpad.reshape(rows, kk, 32)
    gidx = torch.arange(ng, device=x.device)[:, None]  # the tile's group
    part = torch.zeros((rows, ng, 32), dtype=torch.float64, device=x.device)
    for k in range(kk):
        take = (k * 32 + lanes)[None, :] < gidx        # (ng, 32)
        part = torch.where(take, part + gpad[:, None, k, :], part)
    before = _warp_tree(part)                          # (rows, ng)
    off = (before[:, :, None] + in_group).reshape(rows, ng * GROUP)[:, :nt]
    base = off[..., None] + excl                       # (rows, nt, T)
    y = (base[..., None] + run).to(torch.float32)
    return y.reshape(rows, nt * SPAN)[:, :n]


@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("comb_scan")
    lib.ppf_prefix_sum.argtypes = [_c_p, _c_p, _c_p, _c_i, _c_i,
                                   ctypes.c_uint, _c_p]
    lib.ppf_prefix_sum.restype = _c_i
    lib.ppf_prefix_sum_three_pass.argtypes = [_c_p, _c_p, _c_p, _c_i, _c_i,
                                              _c_p]
    lib.ppf_prefix_sum_three_pass.restype = _c_i
    lib.ppf_prefix_sum_three_pass_scratch_bytes.argtypes = [_c_i, _c_i]
    lib.ppf_prefix_sum_three_pass_scratch_bytes.restype = ctypes.c_longlong
    return lib


# (device index, raw stream) -> [zeroed uint8 scratch, its pointer, the
# last epoch]: k_scan_lookback's flags carry the call's epoch, so the
# scratch is zeroed only when it is made (or grown, or the epochs wrap)
_SCRATCH: dict = {}


def _launch(p: ScanPlan, x: torch.Tensor, y: torch.Tensor) -> None:
    """Run plan ``p``'s kernel on checked inputs; count nothing."""
    rows, n = x.shape
    dev = x.get_device()
    # the raw handle of torch's current stream (a fraction of
    # current_stream()'s host time)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    lib = _lib()
    if p.variant == "lookback":
        s = _SCRATCH.get((dev, stream))
        if s is None or s[0].numel() < p.scratch_bytes:
            t = torch.zeros((p.scratch_bytes,), dtype=torch.uint8,
                            device=x.device)
            s = _SCRATCH[(dev, stream)] = [t, t.data_ptr(), 0]
        s[2] += 1
        if s[2] == EPOCHS:
            s[0].zero_()
            s[2] = 1
        err = lib.ppf_prefix_sum(x.data_ptr(), y.data_ptr(), s[1], rows, n,
                                 s[2], stream)
    else:
        nbytes = lib.ppf_prefix_sum_three_pass_scratch_bytes(rows, n)
        scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                              device=x.device)
        err = lib.ppf_prefix_sum_three_pass(x.data_ptr(), y.data_ptr(),
                                            scratch.data_ptr(), rows, n,
                                            stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum {p.variant} kernel launch failed: "
                           f"cudaError {err}")


_PLANS: dict = {}       # shapes that passed the size checks -> ScanPlan


def prefix_sum_kernel(x: torch.Tensor) -> torch.Tensor:
    """The scan on the card: ``(rows, n)`` float32 prefix sums of a
    contiguous CUDA float32 ``x`` of that shape, in one launch.  A shape
    that passed the size checks keeps its plan: the per-call host time
    counts beside the kernel's."""
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (rows, n), got "
                         f"{tuple(x.shape)}")
    p = _PLANS.get(x.shape)
    if p is None:
        rows, n = x.shape
        p = plan(rows, n)
        if rows >= 2 ** 31 or n >= 2 ** 31 or p.blocks >= 2 ** 31:
            raise ValueError(f"{rows} rows of {n} are beyond the kernel")
        if len(_PLANS) >= 4096:
            _PLANS.clear()
        _PLANS[x.shape] = p
    y = torch.empty_like(x)
    if p.blocks:
        _launch(p, x, y)
        prefix_sum_kernel.launches += 1
    return y


prefix_sum_kernel.launches = 0
