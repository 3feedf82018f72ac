"""What B1 and B2 share around the comb scan (``csrc/comb_merge.cuh``).

Both kernels build a member's comb in three steps: a normalizer in one
launch (each tile publishes its max and its double sum of
``exp(v - max)``; the member's last tile combines them in a tree fixed by
tile index), the CDF on the comb scan's look-back machinery
(``csrc/lookback.cuh``), and the comb by a load-balanced merge of the CDF
with the comb points.  This module holds the torch emulation of each step's
order (the kernels' bits on any device, so the CPU tests can hold the
arithmetic against the plain versions and the reference), the per-lane
bisection the merge replaces, and the scratch the wrappers keep per device
and stream.

The merge: CDF value ``k`` comes before comb point ``i`` iff ``cdf[k] <=
pos_i``; ancestor ``i`` is the number of CDF values before point ``i``,
clamped to ``n_in - 1`` — exactly the first design's upper-bound
bisection, also for a CDF that is NaN throughout (ancestor 0).  The merged
sequence is cut into diagonals of ``MERGE_SPAN`` items, a block each; the
diagonals' ends (splits) come first, a warp's two-level 32-way search each
(``merge_split``: the CDF's every ``COARSE``-th value, which the CDF pass
writes beside it, then the window left), the threads' from a bisection of
the block's slice, and each thread merges ``MERGE_PER`` items in
sequence.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import scan
from repro_torch.kernels.scan import _warp_tree

THREADS, PER, SPAN = scan.THREADS, scan.PER, scan.SPAN
WARPS = THREADS // 32
MERGE_THREADS, MERGE_PER = 128, 32
MERGE_SPAN = MERGE_THREADS * MERGE_PER
COARSE = 64                # CDF values a coarse sample covers
PART_BYTES = 32            # cm::Part: s, q (double), m (float), padding
SLOT_BYTES = scan.SLOT_BYTES
MAX_MEMBERS = 65535        # the grids' y dim
# the flag scratch's fixed head: the look-back ticket (16 B), then two
# counters a member (normalizer, estimate) for any batch
COUNTERS_AT = 16
FLAGS_HEAD = COUNTERS_AT + 2 * (MAX_MEMBERS + 1) * 4


def tiles(n: int) -> int:
    """Tiles of ``SPAN`` elements in a row of ``n``."""
    return -(-n // SPAN)


def coarse_samples(n: int) -> int:
    """The CDF's coarse samples (every ``COARSE``-th value) in a row of
    ``n``."""
    return -(-n // COARSE)


def merge_blocks(n_in: int, n_out: int) -> int:
    """Blocks (diagonals of ``MERGE_SPAN`` items) of a member's merge."""
    return -(-(n_in + n_out) // MERGE_SPAN)


def align(n: int, to: int = 256) -> int:
    return -(-n // to) * to


# ---------------------------------------------------------------------------
# The normalizer's order
# ---------------------------------------------------------------------------

def _thread_rows(v: torch.Tensor, fill: float) -> torch.Tensor:
    """``(rows, n)`` -> ``(rows, tiles, THREADS, 16)``: thread t's values in
    its order (chunks t, t + 256, t + 512, t + 768 of 4), ``fill`` past n."""
    rows, n = v.shape
    nt = tiles(n)
    out = torch.full((rows, nt * SPAN), fill, dtype=v.dtype, device=v.device)
    out[:, :n] = v
    return (out.reshape(rows, nt, PER // 4, THREADS, 4)
            .permute(0, 1, 3, 2, 4).reshape(rows, nt, THREADS, PER))


def _fmax(v: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``fmaxf``'s max over ``dims``: NaN loses to any number, all NaN
    gives NaN."""
    nan = torch.isnan(v)
    m = torch.where(nan, -torch.inf, v).amax(dims)
    return torch.where(nan.to(torch.uint8).amin(dims).bool(), torch.nan, m)


def block_tree(v: torch.Tensor) -> torch.Tensor:
    """``cm::block_tree`` over the last dim (THREADS values): each warp's
    ``warp_tree``, then the warp sums' (zeros above) in warp 0."""
    w = _warp_tree(v.reshape(v.shape[:-1] + (WARPS, 32)))
    pad = torch.zeros(v.shape[:-1] + (32 - WARPS,), dtype=v.dtype,
                      device=v.device)
    return _warp_tree(torch.cat([w, pad], -1))


def _sequence(terms: torch.Tensor) -> torch.Tensor:
    """The sum of the last dim in order from 0.0 (``acc += t``)."""
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float64,
                      device=terms.device)
    for k in range(terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


def tile_parts(v: torch.Tensor, squares: bool = False):
    """``cm::tile_part`` of every tile of a ``(rows, n)`` float32 row:
    ``(m, s, q)``, each ``(rows, tiles)``: the tile's max, and its double
    sums of ``e = exp(v - m)`` and ``e^2`` (``q`` None unless
    ``squares``)."""
    t = _thread_rows(v, -torch.inf)
    m = _fmax(t, (-2, -1))
    live = (m != -torch.inf)[..., None, None]
    e = torch.exp(t - torch.where(live, m[..., None, None], 0.0))
    e = torch.where(live, e, 0.0).double()
    s = block_tree(_sequence(e))
    q = block_tree(_sequence(e * e)) if squares else None
    return m, s, q


def combine_parts(m: torch.Tensor, s: torch.Tensor, q=None,
                  finite_shift: bool = False):
    """``cm::combine_parts`` of ``(rows, tiles)`` parts: ``(M, S, Q)`` per
    row — the max of the tiles' maxima, and the sums of ``s_t exp(m_t -
    shift)`` and ``q_t exp(2 (m_t - shift))`` over the tiles with a finite
    max, thread t taking tiles t, t + 256, ... in order, then the tree.
    ``shift`` is M, or for ``finite_shift`` M if finite else 0."""
    rows, nt = m.shape
    big = _fmax(m, (-1,))
    shift = big.double()
    if finite_shift:
        shift = torch.where(torch.isfinite(big), shift, 0.0)
    live = m != -torch.inf
    dm = m.double() - shift[:, None]
    per = -(-nt // THREADS)

    def tree(part, scale):
        terms = torch.where(live, part * torch.exp(scale * dm), 0.0)
        pad = torch.zeros((rows, per * THREADS), dtype=torch.float64,
                          device=m.device)
        pad[:, :nt] = terms
        # thread t's terms in order k: tile t + 256 k
        return block_tree(_sequence(pad.reshape(rows, per, THREADS)
                                    .transpose(1, 2)))

    return big, tree(s, 1.0), None if q is None else tree(q, 2.0)


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

def comb_points(u: torch.Tensor, idx: torch.Tensor, n_out: int
                ) -> torch.Tensor:
    """The reference's f32 comb point ``((float)i + u) / n_out`` at int64
    indices ``idx`` ``(rows, ...)`` for per-row offsets ``u``."""
    uu = u.reshape(u.shape + (1,) * (idx.dim() - 1)).float()
    nf = torch.tensor(float(n_out), dtype=torch.float32, device=idx.device)
    return (idx.to(torch.float32) + uu) / nf


def upper_bound_bisect(cdf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The first design's per-lane search: for each ``(rows, n_out)`` point
    the first ``k`` with ``cdf[k] > pos`` by bisection (``cdf[mid] <= pos``
    goes right), clamped to ``n_in - 1``; int32."""
    n_in = cdf.shape[-1]
    lo = torch.zeros(pos.shape, dtype=torch.long, device=pos.device)
    hi = torch.full(pos.shape, n_in, dtype=torch.long, device=pos.device)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        right = cdf.gather(-1, mid.clamp(max=n_in - 1)) <= pos
        act = lo < hi
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    return lo.clamp(max=n_in - 1).to(torch.int32)


def warp_least(lo: torch.Tensor, hi: torch.Tensor, pred) -> torch.Tensor:
    """``cm::warp_least``, vectorized: for each ``[lo, hi)`` (int64, any
    shape) the least ``a`` with ``pred(a)`` true, else ``hi``, by the
    kernel's 32-way search (the same probes).  ``pred`` maps an int64
    tensor of shape ``lo.shape + (32,)`` to bools."""
    lanes = torch.arange(1, 33, device=lo.device)
    while bool((lo < hi).any()):
        act = lo < hi
        a = lo[..., None] + ((hi - lo)[..., None] * lanes) // 33
        after = pred(a)
        hit = after.any(-1)
        f = after.int().argmax(-1, keepdim=True)
        first = a.gather(-1, f)[..., 0]
        before = a.gather(-1, (f - 1).clamp(min=0))[..., 0]
        new_lo = torch.where(hit, torch.where(f[..., 0] > 0, before + 1, lo),
                             a[..., 31] + 1)
        new_hi = torch.where(hit, first, hi)
        lo = torch.where(act, new_lo, lo)
        hi = torch.where(act, new_hi, hi)
    return lo


def merge_split(cdf: torch.Tensor, u: torch.Tensor, n_out: int,
                d: torch.Tensor) -> torch.Tensor:
    """``cm::merge_split`` at diagonals ``d`` ``(rows, k)`` int64: the number
    of CDF values among the first ``d`` items of each row's merge, by the
    kernel's two-level 32-way search — over the coarse samples
    ``cdf[COARSE j]``, then over the window of at most ``COARSE`` values
    they leave."""
    rows, n_in = cdf.shape
    coarse = cdf[:, ::COARSE]
    lo = (d - n_out).clamp(min=0)
    hi = d.clamp(max=n_in)

    def after(values, step):
        def pred(a):
            v = values.gather(-1, a.clamp(0, values.shape[-1] - 1)
                              .reshape(rows, -1)).reshape(a.shape)
            return ~(v <= comb_points(u, d[..., None] - 1 - a * step, n_out))
        return pred

    jlo = (lo + COARSE - 1) // COARSE
    jhi = (hi + COARSE - 1) // COARSE
    j = warp_least(jlo, jhi, after(coarse, COARSE))
    flo = torch.where(j > jlo, (j - 1) * COARSE + 1, lo)
    fhi = torch.where(j < jhi, j * COARSE, hi)
    return warp_least(flo, fhi, after(cdf, 1))


def merge_ancestors(cdf: torch.Tensor, u: torch.Tensor, n_out: int
                    ) -> torch.Tensor:
    """``(rows, n_out)`` int32 ancestors of a ``(rows, n_in)`` float32 CDF
    and per-row offsets ``u`` by the kernel's merge: the blocks' splits
    (``merge_split``), each thread's split of its block's slice by
    bisection, then ``MERGE_PER`` merge steps a thread."""
    rows, n_in = cdf.shape
    dev = cdf.device
    total = n_in + n_out
    anc = torch.zeros((rows, n_out), dtype=torch.int32, device=dev)
    if rows == 0 or n_out == 0:
        return anc
    nblk = merge_blocks(n_in, n_out)
    d0 = torch.arange(nblk, device=dev) * MERGE_SPAN
    d1 = (d0 + MERGE_SPAN).clamp(max=total)
    ends = merge_split(cdf, u, n_out,
                       torch.cat([d0, d1])[None].expand(rows, -1).contiguous())
    a0, a1 = ends[:, :nblk], ends[:, nblk:]
    b0 = d0 - a0                                  # (rows, nblk)
    na, nb = a1 - a0, (d1 - a1) - b0
    # thread t of block j starts at local diagonal k0 = t * MERGE_PER
    k0 = torch.arange(MERGE_THREADS, device=dev) * MERGE_PER   # (T,)
    shape = (rows, nblk, MERGE_THREADS)
    k0 = k0.expand(shape)
    a0, b0, na, nb = (t[..., None].expand(shape) for t in (a0, b0, na, nb))
    live = k0 < na + nb

    def at(a):          # the slice's value a (global cdf[a0 + a])
        idx = (a0 + a).clamp(0, n_in - 1).reshape(rows, -1)
        return cdf.gather(-1, idx).reshape(shape)

    lo = (k0 - nb).clamp(min=0)
    hi = torch.minimum(k0, na)
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi) // 2
        right = at(mid) <= comb_points(u, b0 + k0 - 1 - mid, n_out)
        lo = torch.where(act & right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    a, b = lo, k0 - lo
    k1 = torch.minimum(k0 + MERGE_PER, na + nb)
    for step in range(MERGE_PER):
        go = live & (k0 + step < k1)
        take = go & (b < nb) & ((a >= na)
                                | ~(at(a) <= comb_points(u, b0 + b, n_out)))
        val = torch.minimum(a0 + a, torch.full_like(a, n_in - 1))
        r = torch.arange(rows, device=dev)[:, None, None].expand(shape)
        anc[r[take], (b0 + b)[take]] = val[take].to(torch.int32)
        a = torch.where(go & ~take, a + 1, a)
        b = torch.where(take, b + 1, b)
    return anc


# ---------------------------------------------------------------------------
# Scratch, per device and stream
# ---------------------------------------------------------------------------

# (kind, device index, raw stream) -> [flags (zeroed uint8), its pointer,
# work (uint8), its pointer, the last epoch].  The flags hold the look-back
# ticket and the counters at fixed places and the look-back slots after
# them; counters and ticket reset themselves at the end of every call and
# slots carry the call's epoch, so the flags are zeroed only when made or
# grown (or the epochs wrap).  The work buffer (parts, scalars, the CDF)
# is written before it is read in every call.
_SCRATCH: dict = {}


def scratch(kind: str, t: torch.Tensor, stream: int, flag_bytes: int,
            work_bytes: int) -> tuple[int, int, int]:
    """``(flags pointer, work pointer, epoch)`` for a call on ``t``'s
    device and ``stream``."""
    key = (kind, t.get_device(), stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < flag_bytes or s[2].numel() < work_bytes:
        flags = torch.zeros((max(flag_bytes, 16),), dtype=torch.uint8,
                            device=t.device)
        work = torch.empty((max(work_bytes, 16),), dtype=torch.uint8,
                           device=t.device)
        s = _SCRATCH[key] = [flags, flags.data_ptr(), work, work.data_ptr(),
                             0]
    s[4] += 1
    if s[4] == scan.EPOCHS:
        s[0].zero_()
        s[4] = 1
    return s[1], s[3], s[4]
