"""Flash attention on the card (port of ``repro.kernels.flash_attention``).

B6: causal or full GQA attention ``(B, Hq, Lq, D) x (B, Hkv, Lk, D)``
with an online float32 softmax, the decode offset ``Lk - Lq``, an
optional sliding window (a causal query at position ``p = i + Lk - Lq``
sees the keys ``p - window < j <= p``) and an optional tanh soft-cap.
``plan`` chooses one of four kernels from the shapes:

* ``"split"`` (``csrc/flash_attention_sm90.cu``): bfloat16 with at most
  ``SPLIT_ROWS`` query rows (``G·Lq``) per KV head, every decode step.
  The keys are cut into splits, one block each, and a combine pass
  reduces them in split order.  ``flash_partials_kernel`` runs it
  non-causally and also writes each row's log-sum-exp (B6's partials:
  a key shard's ``(o, lse)`` for a sequence-parallel decode);
* ``"wgmma"`` (the same source): bfloat16 prefill at head dims 64 and
  128, wgmma products on TMA-loaded K/V tiles;
* ``"mma"`` (``csrc/flash_attention.cu``): every other bfloat16 call,
  mma.sync products, head dims 16, 32, ..., 128 and 256;
* ``"f32"`` (the same source): float32 inputs, plain FMA, head dims up
  to 256.

V's head dim equals q and k's, except for the pairs in
``UNEQUAL_HEAD_DIMS``: latent attention's (192, 128) (deepseek-v2's M
layer: 128 nope + 64 rope dims of q and k, 128 of v), which the mma and
f32 variants serve; the output takes V's head dim.

The wrapper takes strided views: a decode step hands it the KV cache's
``[..., :pos+1, :]`` view as it lies in memory, never a copy.  With a
window every variant walks only the key tiles its query tile can see: a
windowed decode reads about ``window`` keys of the view, whatever its
length (``plan`` cuts the split variant's keys from ``Plan.key0``, the
first key a query of the call sees).  The
plain version is ``ref.mha_ref``.  The reference's block sizes and its
``lq % block_q == 0``/``lk % block_k == 0`` rule have no counterpart:
the kernels mask ragged tails at any length.

The kernel wrapper takes CUDA tensors only and raises on anything else,
and refuses inputs that require grad (it has no backward);
``repro_torch.kernels.ops.attention`` dispatches on the device.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_f = ctypes.c_float

BF16_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256)
# (q/k head dim, v head dim) pairs with Dv != Dqk, on "mma" and "f32" only
UNEQUAL_HEAD_DIMS = ((192, 128),)
F32_MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)
SPLIT_ROWS = 64          # query rows per KV head up to which "split" serves
SPLIT_TILE = 16          # keys of a warp's tile in the split kernel
MIN_SPLIT_KEYS = 128     # the shortest split worth a block
# about two split blocks on each of the H100's 132 SMs: on the card, twice
# as many splits lost more to the combine pass than they gained
SPLIT_BLOCKS = 2 * 132


@functools.cache
def _lib():
    lib = build.library("flash_attention")
    lib.ppf_flash_attention.argtypes = ([_c_p] * 4 + [_c_ll] * 9
                                        + [_c_i] * 10 + [_c_f, _c_f, _c_p])
    lib.ppf_flash_attention.restype = _c_i
    return lib


@functools.cache
def _lib_sm90():
    lib = build.library("flash_attention_sm90")
    for fn in (lib.ppf_flash_wgmma, lib.ppf_flash_split):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = _c_i
    return lib


# csrc/flash_attention_sm90.cu's `FlashCall`: q, k, v, o, scratch, lse and
# stream pointers; q, k, v strides; b, hq, hkv, lq, lk, d, causal, split_keys,
# n_split, window, key0; scale, softcap.  One packed pointer costs a
# fraction of the host time of 28 ctypes arguments, and a decode step is
# host-bound.
_CALL = struct.Struct("@7Q9q11i2f")


class Plan(NamedTuple):
    """The kernel a call takes, and for ``"split"`` how its keys are cut:
    ``splits`` ranges of ``split_keys`` keys from key ``key0`` (the last
    may be shorter), each holding at least one key."""
    variant: str
    splits: int = 1
    split_keys: int = 0
    key0: int = 0


def _split(b: int, hkv: int, lk: int, key0: int = 0) -> Plan:
    """As many splits per (batch row, KV head) pair of the keys ``key0 ..
    lk - 1`` as fill one wave of SPLIT_BLOCKS blocks, at least one, none
    under MIN_SPLIT_KEYS keys; split lengths a multiple of SPLIT_TILE."""
    n = lk - key0
    want = max(1, min(SPLIT_BLOCKS // (b * hkv), n // MIN_SPLIT_KEYS))
    keys = -(-(-(-n // want)) // SPLIT_TILE) * SPLIT_TILE
    return Plan("split", -(-n // keys), keys, key0)


def first_key(lq: int, lk: int, window: int) -> int:
    """The first key a query of a causal call sees: its first query's
    window's lower edge (0 without a window)."""
    return max(0, lk - lq - window + 1) if window > 0 else 0


def plan(q_shape, k_shape, dtype, tma_strides: bool = True,
         window: int = 0, dv: int | None = None) -> Plan:
    """The variant for q ``(B, Hq, Lq, D)`` against k ``(B, Hkv, Lk, D)``
    and v ``(B, Hkv, Lk, dv)`` (``dv`` defaults to D), from the shapes
    (and the window) alone: float32 takes ``"f32"``; bfloat16 with ``dv
    != D`` ``"mma"``; bfloat16 with ``G·Lq <= SPLIT_ROWS`` rows per KV
    head ``"split"``, its splits cut from the first key a query sees; a
    longer bfloat16 call at a head dim in WGMMA_HEAD_DIMS ``"wgmma"``,
    unless k or v steps a dim by 0 (``tma_strides=False``), which TMA
    cannot; anything else ``"mma"``.  The 16-byte row alignment that
    every bfloat16 kernel needs is ``_check``'s."""
    b, hq, lq, d = q_shape
    hkv, lk = k_shape[1], k_shape[2]
    if dtype == torch.float32:
        return Plan("f32")
    if dv is not None and dv != d:
        return Plan("mma")
    if hq // hkv * lq <= SPLIT_ROWS:
        return _split(b, hkv, lk, first_key(lq, lk, window))
    if d in WGMMA_HEAD_DIMS and tma_strides:
        return Plan("wgmma")
    return Plan("mma")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int = 0) -> None:
    """Raise on anything the kernel does not take.  The device comes last,
    so the shape rules can be exercised on CPU tensors."""
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a window is a positive key "
                         f"count on a causal call")
    qkv = (("q", q), ("k", k), ("v", v))
    for name, t in qkv:
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
    dv = v.shape[-1]
    if k.shape != (b, hkv, lk, d) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if dv != d and (d, dv) not in UNEQUAL_HEAD_DIMS:
        raise ValueError(f"q/k head dim {d} with v head dim {dv}: the "
                         f"kernels take equal head dims or the pairs "
                         f"{UNEQUAL_HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if lq < 1 or lk < 1 or (causal and lk < lq):
        raise ValueError(f"Lq={lq}, Lk={lk}: a causal call needs "
                         f"1 <= Lq <= Lk")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"batch {b} x {hkv} KV heads is beyond the grid")
    if q.dtype == torch.bfloat16:
        if dv == d and d not in BF16_HEAD_DIMS:
            raise ValueError(f"bf16 head dim {d} not in {BF16_HEAD_DIMS}")
        for name, t in qkv:
            st = t.stride()
            if t.data_ptr() % 16 or (st[0] | st[1] | st[2]) % 8:
                raise ValueError(f"{name}'s rows must be 16-byte aligned")
    elif d > F32_MAX_HEAD_DIM:
        raise ValueError(f"float32 head dim {d} > {F32_MAX_HEAD_DIM}")
    dev = q.get_device()
    for name, t in qkv:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name} must be on {q.device} (a CUDA "
                             f"device), got {t.device}")


def _launch(p: Plan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: float, softcap: float,
            window: int = 0, lse: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Run plan ``p``'s kernel on checked inputs; count nothing.  With
    ``lse`` (``(B, Hq, Lq)`` float32, the split variant only) the kernel
    writes each row's log-sum-exp there too."""
    b, hq, lq, d = q.shape
    hkv, lk, dv = k.shape[1], k.shape[2], v.shape[-1]
    if dv != d and p.variant not in ("mma", "f32"):
        raise ValueError(f"the {p.variant} variant takes equal head dims, "
                         f"not ({d}, {dv})")
    out = q.new_empty((b, hq, lq, dv))
    # the raw handle of torch's current stream (what torch's own Triton
    # launcher reads: a fraction of current_stream()'s host time)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if p.variant in ("split", "wgmma"):
        part = None
        if p.splits > 1:
            part = q.new_empty(b * hkv * p.splits * (hq // hkv) * lq
                               * (d + 2), dtype=torch.float32)
        call = _CALL.pack(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(),
            0 if lse is None else lse.data_ptr(), stream,
            qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            b, hq, hkv, lq, lk, d, int(causal), p.split_keys, p.splits,
            window, p.key0, scale, softcap)
        lib = _lib_sm90()
        fn = lib.ppf_flash_split if p.variant == "split" \
            else lib.ppf_flash_wgmma
        err = fn(call)
    elif lse is not None:
        raise ValueError(f"the {p.variant} variant writes no log-sum-exp")
    else:
        err = _lib().ppf_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *qs[:3], *ks[:3], *vs[:3], b, hq, hkv, lq, lk, d, dv,
            int(p.variant == "mma"), int(causal), window, scale, softcap,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {p.variant} kernel launch "
                           f"failed: error {err}")
    return out


_CHECKED: dict = {}      # call signatures that passed _check -> their plan


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           scale: float | None = None,
                           logit_softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """B6 on the card: ``(B, Hq, Lq, Dv)`` attention output, contiguous,
    in q's dtype, of CUDA ``q`` ``(B, Hq, Lq, D)``, ``k`` ``(B, Hkv, Lk,
    D)`` and ``v`` ``(B, Hkv, Lk, Dv)`` (strided views with a contiguous
    last dim; ``Dv`` is D or, for a pair in UNEQUAL_HEAD_DIMS, v's own),
    through the kernel ``plan`` chooses.  ``scale`` defaults to ``1/sqrt(D)``; ``window > 0`` (causal
    calls) limits each query to its last ``window`` keys.

    A decode step is host-bound, so a signature (shapes, strides, dtypes,
    devices, causal, window) that passed the checks keeps its plan; only
    the pointers' alignment is checked again.

    The kernel has no backward (nor has the reference's Pallas kernel),
    and its output would carry no ``grad_fn``: with grad enabled and any
    of q, k, v requiring grad it raises ``RuntimeError`` before anything
    else.  Training attends through ``layers.chunked_causal_attention``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention (B6) has no backward: inputs "
                           "that require grad would get no gradient; "
                           "training runs chunked_causal_attention")
    window = int(window)
    sig = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, causal,
           window)
    p = _CHECKED.get(sig)
    if p is None or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        _check(q, k, v, causal, window)
        p = plan(q.shape, k.shape, q.dtype,
                 0 not in k.stride() and 0 not in v.stride(), window,
                 v.shape[-1])
        if len(_CHECKED) >= 4096:
            _CHECKED.clear()
        _CHECKED[sig] = p
    scale = float(scale) if scale is not None else float(q.shape[-1] ** -0.5)
    out = _launch(p, q, k, v, causal, scale, float(logit_softcap), window)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.variants[p.variant] += 1
    return out


flash_attention_kernel.launches = 0
flash_attention_kernel.variants = dict.fromkeys(
    ("wgmma", "split", "mma", "f32"), 0)


def flash_partials_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float | None = None,
                          logit_softcap: float = 0.0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """B6's partials on the card: ``(o, lse)`` of every query of CUDA
    ``q`` ``(B, Hq, Lq, D)`` over every key of the views ``k``/``v``
    ``(B, Hkv, Lk, D)`` (non-causal: the caller cuts the key range a query
    may see, ``ops.attention_partials``), ``o`` normalized in bfloat16 and
    ``lse`` ``(B, Hq, Lq)`` float32 in natural-log units, through the
    split variant (bfloat16, ``G·Lq <= SPLIT_ROWS``, equal head dims),
    whose blocks and combine write each row's log-sum-exp beside its
    output.  A sequence-parallel decode combines the shards' pairs in
    rank order (``ops.combine_partials``).  Anything else raises; it has
    no backward.  Adds one to ``flash_partials_kernel.launches`` a
    call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention (B6) has no backward")
    _check(q, k, v, False)
    p = plan(q.shape, k.shape, q.dtype, True, 0, v.shape[-1])
    if p.variant != "split":
        raise ValueError(f"B6's partials run the split variant (bfloat16, "
                         f"at most {SPLIT_ROWS} rows a KV head); q "
                         f"{tuple(q.shape)} {q.dtype} plans {p.variant}")
    scale = float(scale) if scale is not None else float(q.shape[-1] ** -0.5)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch(p, q, k, v, False, scale, float(logit_softcap), 0, lse)
    flash_partials_kernel.launches += 1
    return out, lse


flash_partials_kernel.launches = 0
