"""The comb's CDF on the card: a fixed-order float32 scan.

``prefix_sum_kernel`` launches ``csrc/comb_scan.cu`` on a ``(rows, n)``
CUDA tensor; ``prefix_sum_ref`` is its plain version, a scan accumulated
in float64 and rounded once per prefix, as the kernel does.  On the CPU
that is bit for bit ``torch.cumsum(x, -1)`` of a float32 row (torch's CPU
scan accumulates float32 in double); on the card it is the CPU's answer.
The comb schemes of ``repro_torch.core.resampling`` reach either through
``repro_torch.kernels.ops.prefix_sum``.

torch's own CUDA ``cumsum`` of one long row is CUB's device scan, whose
float32 result changes from run to run; the kernel's sums have a fixed
order, so it repeats bit for bit and a row never depends on the others.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_c_p = ctypes.c_void_p
_c_i = ctypes.c_int


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``x`` along its last dim, accumulated in float64
    and rounded to ``x``'s dtype (the plain version)."""
    return torch.cumsum(x.double(), -1).to(x.dtype)


@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("comb_scan")
    lib.ppf_prefix_sum.argtypes = [_c_p, _c_p, _c_p, _c_i, _c_i, _c_p]
    lib.ppf_prefix_sum.restype = _c_i
    lib.ppf_prefix_sum_scratch_bytes.argtypes = [_c_i, _c_i]
    lib.ppf_prefix_sum_scratch_bytes.restype = ctypes.c_longlong
    return lib


def prefix_sum_kernel(x: torch.Tensor) -> torch.Tensor:
    """The scan on the card: ``(rows, n)`` float32 prefix sums of a
    contiguous CUDA float32 ``x`` of that shape."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (rows, n), got "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    if rows >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{rows} rows of {n} are beyond the kernel")
    y = torch.empty_like(x)
    if rows == 0 or n == 0:
        return y
    lib = _lib()
    # rows of one tile take one launch and no scratch (SMC decoding's)
    nbytes = lib.ppf_prefix_sum_scratch_bytes(rows, n)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
               if nbytes else None)
    err = lib.ppf_prefix_sum(x.data_ptr(), y.data_ptr(),
                             scratch.data_ptr() if nbytes else None, rows, n,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum kernel launch failed: cudaError {err}")
    prefix_sum_kernel.launches += 1
    return y


prefix_sum_kernel.launches = 0
