"""Flash attention on the card (port of ``repro.kernels.flash_attention``).

B6: causal GQA attention ``(B, Hq, Lq, D) x (B, Hkv, Lk, D)`` with an
online float32 softmax, the decode offset ``Lk - Lq`` and an optional
tanh soft-cap, in ``csrc/flash_attention.cu``: mma.sync bf16 products
with float32 accumulation for bfloat16 inputs (head dims 16, 32, ...,
128), plain FMA for float32 inputs (head dims up to 256).  The wrapper
takes strided views: a decode step hands it the KV cache's
``[..., :pos+1, :]`` view as it lies in memory, never a copy.  The
plain version is ``ref.mha_ref``.  The reference's block sizes and its
``lq % block_q == 0``/``lk % block_k == 0`` rule have no counterpart:
the kernel masks ragged tails at any length.

The kernel wrapper takes CUDA tensors only and raises on anything else;
``repro_torch.kernels.ops.attention`` dispatches on the device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_f = ctypes.c_float

BF16_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
F32_MAX_HEAD_DIM = 256


def _lib():
    lib = build.library("flash_attention")
    lib.ppf_flash_attention.argtypes = ([_c_p] * 4 + [_c_ll] * 9
                                        + [_c_i] * 8 + [_c_f, _c_f, _c_p])
    lib.ppf_flash_attention.restype = _c_i
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    """Raise on anything the kernel does not take.  The device comes last,
    so the shape rules can be exercised on CPU tensors."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if tuple(k.shape) != (b, hkv, lk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if lq < 1 or lk < 1 or (causal and lk < lq):
        raise ValueError(f"Lq={lq}, Lk={lk}: a causal call needs "
                         f"1 <= Lq <= Lk")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"batch {b} x {hkv} KV heads is beyond the grid")
    if q.dtype == torch.bfloat16:
        if d not in BF16_HEAD_DIMS:
            raise ValueError(f"bf16 head dim {d} not in {BF16_HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
                raise ValueError(f"{name}'s rows must be 16-byte aligned")
    elif d > F32_MAX_HEAD_DIM:
        raise ValueError(f"float32 head dim {d} > {F32_MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (a CUDA "
                             f"device), got {t.device}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           scale: float | None = None,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """B6 on the card: ``(B, Hq, Lq, D)`` attention output, contiguous, in
    q's dtype, of CUDA ``q`` and ``k``/``v`` ``(B, Hkv, Lk, D)`` (strided
    views with a contiguous last dim).  ``scale`` defaults to
    ``1/sqrt(D)``."""
    _check(q, k, v, causal)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else float(d ** -0.5)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    err = _lib().ppf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, hq, hkv, lq, lk, d, int(q.dtype == torch.bfloat16), int(causal),
        scale, float(logit_softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
