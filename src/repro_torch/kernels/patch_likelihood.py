"""Gaussian-PSF patch log-likelihood on the card (port of
``repro.kernels.patch_likelihood``).

``patch_log_likelihood_kernel`` wraps ``csrc/patch_likelihood.cu``'s
``k_patch_sep``: one thread per (member, particle), reading y, x and i0 in
place from the strided ``(B, N, S)`` state, with the separable PSF (one exp
a window row and one a window column), the matched form's sum of squared
model values in closed form, each window row read whole in aligned
float4s, from a box of the frame a block stages in shared memory when its
windows cluster, else from the frame itself in 16-byte loads where the
frames allow (``plan``).  One geometry (centre clamp and frame origin)
serves every member, or a ``(B, 6)`` table (``member_geometry``, checked
once on the host) gives each member its own: a domain's halo slabs, all
in one launch.  It takes CUDA tensors only; the plain version is
``repro_torch.kernels.ref.patch_log_likelihood_ref``.

``patch_log_likelihood_emulated`` is the kernel's arithmetic written in
torch (its slots, weights, masks and order of float32 sums; torch's exp in
place of the card's), which the CPU tests hold against the reference.

``plan`` is pure Python.  The first design (``"direct"``: 81 exps and 81
4-byte gathers a particle, the reference's per-pixel order) stays
launchable through ``_launch`` for same-run timing (shared geometry
only).
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import default_geometry, geometry_columns

# csrc/patch_likelihood.cu's `PatchCall`: state, its member and particle
# strides, frames, their member and row strides, out, the stream and the
# per-member geometry table (0: none); B, N, R, H, W, matched, vec and the
# six shared geometry integers; inv2s2, sl2, i_bg
_CALL = struct.Struct("@PqqPqqPPP13i3f")


class PatchPlan(NamedTuple):
    variant: str        # "separable", or "direct" (the first design)
    vec: bool           # 16-byte window-row loads


def plan(frames_ptr: int, f_b: int, f_row: int, w: int) -> PatchPlan:
    """``"separable"`` for every call, with 16-byte window-row loads when
    the frames' base is 16-byte aligned and their member stride, row
    stride and width are multiples of 4 floats (every aligned float4 that
    holds a window pixel then lies inside its row), 4-byte loads
    otherwise.  Pure Python: ``ppf_patch_log_likelihood`` checks the
    alignment again."""
    return PatchPlan("separable", frames_ptr % 16 == 0 and f_b % 4 == 0
                     and f_row % 4 == 0 and w % 4 == 0)


def _nq(radius: int) -> int:
    """float4 chunks that hold a (2R+1)-column window at any start."""
    return (2 * radius + 7) // 4


def _fma(a, b, c):
    """float32 a*b + c rounded once (through float64, exact for the
    product)."""
    return (a.double() * b.double() + c.double()).float()


def patch_log_likelihood_emulated(y: torch.Tensor, x: torch.Tensor,
                                  i0: torch.Tensor, image: torch.Tensor, *,
                                  radius: int = 4, sigma_psf: float = 1.16,
                                  sigma_like: float = 2.0, i_bg: float = 0.0,
                                  matched: bool = True, center_bounds=None,
                                  frame_origin=None,
                                  geometry=None) -> torch.Tensor:
    """``k_patch_sep``'s arithmetic in torch for ``(..., N)`` particles and
    ``(..., H, W)`` frames: the window's columns in ``4·NQ`` slots from the
    aligned column ``c & ~3``, the separable weights (0 off the window),
    each row's slot sums, then the rows, in float32 in the kernel's order.
    ``geometry`` (``(..., 6)``) gives each member its own bounds and
    origin, as the kernel reads them.  torch's exp stands in for the
    card's, so it agrees with the kernel to an exp's rounding, not bit for
    bit."""
    h, w = image.shape[-2:]
    lo_y, hi_y, lo_x, hi_x, oy, ox = geometry_columns(
        radius, h, w, y.shape[:-1], center_bounds, frame_origin, geometry,
        y.device)
    f32 = torch.float32
    k2 = torch.tensor(0.5 / (sigma_psf * sigma_psf), dtype=f32)
    bg = torch.tensor(i_bg, dtype=f32)
    width = 2 * radius + 1
    cy = torch.clamp(torch.round(y).to(torch.int64), lo_y, hi_y)
    cx = torch.clamp(torch.round(x).to(torch.int64), lo_x, hi_x)
    c0 = cx - radius - ox
    a = c0 - c0 % 4
    sft = c0 - a
    zero = torch.zeros_like(y)
    slots = 4 * _nq(radius)
    ins, ex = [], []
    sex, sex2 = zero, zero
    for j in range(slots):
        inj = (j >= sft) & (j < sft + width)
        d = (a + ox + j).to(f32) - x
        e = torch.where(inj, torch.exp(-d * d * k2), zero)
        ins.append(inj)
        ex.append(e)
        sex = sex + e
        sex2 = _fma(e, e, sex2)
    flat = image.reshape(image.shape[:-2] + (h * w,))
    sey, sey2, szm, sz, acc = zero, zero, zero, zero, zero
    for ry in range(width):
        dy = (cy - radius + ry).to(f32) - y
        ey = torch.exp(-dy * dy * k2)
        sey = sey + ey
        sey2 = _fma(ey, ey, sey2)
        i0ey = i0 * ey
        row = (cy - radius + ry - oy) * w
        rs, rz = zero, zero
        for j in range(slots):
            col = (a + j).clamp(max=w - 1)
            z = torch.where(ins[j], torch.gather(flat, -1, row + col), zero)
            if matched:
                rs = _fma(ex[j], z, rs)
                rz = rz + z
            else:
                m = _fma(i0ey, ex[j], bg.expand_as(y))
                r = torch.where(ins[j], z - m, zero)
                rs = _fma(r, r, rs)
        if matched:
            szm = _fma(ey, rs, szm)
            sz = sz + rz
        else:
            acc = acc + rs
    if matched:
        zm = i0 * szm
        mm = (i0 * i0) * (sey2 * sex2)
        if i_bg != 0.0:
            zm = _fma(bg.expand_as(y), sz, zm)
            mm = _fma((2.0 * i0) * bg, sey * sex, mm)
            mm = _fma(torch.full_like(y, width * width), bg * bg
                      * torch.ones_like(y), mm)
        val = _fma(torch.full_like(y, -0.5), mm, zm)
    else:
        val = -0.5 * acc
    return val / torch.tensor(sigma_like * sigma_like, dtype=f32)


@functools.cache
def _lib():
    """The library, bound once: a launch pays no ctypes set-up."""
    lib = build.library("patch_likelihood")
    for fn in (lib.ppf_patch_log_likelihood,
               lib.ppf_patch_log_likelihood_direct):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return lib


def check_geometry(geom, radius: int, h: int, w: int) -> tuple[int, ...]:
    """Raise unless the ``(lo_y, hi_y, lo_x, hi_x, oy, ox)`` geometry keeps
    every radius-``radius`` window inside an ``h`` x ``w`` frame; return it
    as six ints."""
    lo_y, hi_y, lo_x, hi_x, oy, ox = geom = tuple(int(v) for v in geom)
    if not (lo_y <= hi_y and lo_x <= hi_x and lo_y - radius - oy >= 0
            and hi_y + radius - oy <= h - 1 and lo_x - radius - ox >= 0
            and hi_x + radius - ox <= w - 1):
        raise ValueError(f"geometry {geom} lets a radius-{radius} window "
                         f"leave the {h}x{w} frame")
    return geom


# per-member geometry tables that passed check_geometry, by id: (the
# table, its version counter then, radius, h, w)
_GEOMETRIES: dict = {}


def member_geometry(rows, radius: int, h: int, w: int,
                    device) -> torch.Tensor:
    """A ``(B, 6)`` int32 per-member geometry table on ``device``, every
    row checked on the host here (``check_geometry``), so that a launch
    with it costs no check and no sync.  Build it once and keep it: the
    wrapper knows the table by identity and checks any other table again
    on the host (a sync)."""
    rows = [check_geometry(r, radius, h, w) for r in rows]
    table = torch.tensor(rows, dtype=torch.int32,
                         device=torch.device(device)).reshape(-1, 6)
    _remember(table, radius, h, w)
    return table


def _remember(table: torch.Tensor, radius: int, h: int, w: int) -> None:
    if len(_GEOMETRIES) >= 256:
        _GEOMETRIES.clear()
    _GEOMETRIES[id(table)] = (table, table._version, radius, h, w)


def _check_table(table, b: int, radius: int, h: int, w: int,
                 device) -> None:
    """Raise unless ``table`` is a ``(B, 6)`` int32 contiguous table on
    ``device`` whose rows pass ``check_geometry``; a table that
    ``member_geometry`` made (and nothing changed since) skips the rows'
    check."""
    if not isinstance(table, torch.Tensor) or table.dtype != torch.int32 \
            or tuple(table.shape) != (b, 6) or not table.is_contiguous():
        raise ValueError(f"geometry must be a contiguous int32 ({b}, 6) "
                         f"tensor, got {getattr(table, 'dtype', None)} "
                         f"{tuple(getattr(table, 'shape', ()))}")
    if table.device != device:
        raise ValueError(f"geometry on {table.device}, state on {device}")
    known = _GEOMETRIES.get(id(table))
    if known is None or known[0] is not table \
            or known[1:] != (table._version, radius, h, w):
        for row in table.tolist():
            check_geometry(row, radius, h, w)
        _remember(table, radius, h, w)


def _check(state: torch.Tensor, frames: torch.Tensor, radius: int,
           center_bounds, frame_origin) -> tuple[int, ...]:
    """Raise on anything the kernel does not take; return the shared
    geometry."""
    if state.dim() != 3 or frames.dim() != 3:
        raise ValueError(f"state (B,N,S) and frames (B,H,W) expected, got "
                         f"{tuple(state.shape)} and {tuple(frames.shape)}")
    for name, t in (("state", state), ("frames", frames)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if frames.device != state.device:
        raise ValueError("state and frames on different devices")
    b, n, s = state.shape
    h, w = frames.shape[1:]
    if frames.shape[0] != b or s < 5:
        raise ValueError(f"state {tuple(state.shape)} / frames "
                         f"{tuple(frames.shape)} do not match")
    if state.stride(2) != 1 or frames.stride(2) != 1:
        raise ValueError("state and frames need a unit last stride")
    if radius < 0:
        raise ValueError(f"radius {radius} must be >= 0")
    return check_geometry(default_geometry(radius, h, w, center_bounds,
                                           frame_origin), radius, h, w)


def _launch(p: PatchPlan, state: torch.Tensor, frames: torch.Tensor,
            geom: tuple[int, ...], radius: int, sigma_psf: float,
            sigma_like: float, i_bg: float, matched: bool,
            table: torch.Tensor | None = None) -> torch.Tensor:
    """Run plan ``p``'s kernel on checked ``(B, N, S)`` state and ``(B, H,
    W)`` frames, with the shared geometry ``geom`` or, where ``table`` is
    given, each member's row of it; count nothing."""
    b, n = state.shape[:2]
    out = torch.empty((b, n), dtype=torch.float32, device=state.device)
    # the raw handle of torch's current stream (a fraction of
    # current_stream()'s host time)
    stream = torch._C._cuda_getCurrentRawStream(state.get_device())
    ss, fs = state.stride(), frames.stride()
    call = _CALL.pack(state.data_ptr(), ss[0], ss[1], frames.data_ptr(),
                      fs[0], fs[1], out.data_ptr(), stream,
                      0 if table is None else table.data_ptr(), b, n, radius,
                      frames.shape[1], frames.shape[2], int(matched),
                      int(p.vec), *geom, 0.5 / (sigma_psf * sigma_psf),
                      sigma_like * sigma_like, i_bg)
    lib = _lib()
    fn = (lib.ppf_patch_log_likelihood if p.variant == "separable"
          else lib.ppf_patch_log_likelihood_direct)
    err = fn(call)
    if err != 0:
        raise RuntimeError(f"patch_log_likelihood {p.variant} kernel launch "
                           f"failed: cudaError {err}")
    return out


_CHECKED: dict = {}     # call signatures that passed _check -> geometry


def patch_log_likelihood_kernel(state: torch.Tensor, frames: torch.Tensor, *,
                                radius: int = 4, sigma_psf: float = 1.16,
                                sigma_like: float = 2.0, i_bg: float = 0.0,
                                matched: bool = True, center_bounds=None,
                                frame_origin=None,
                                geometry=None) -> torch.Tensor:
    """``(B, N)`` (or ``(N,)``) log-likelihoods on the card.

    ``state`` is ``(B, N, S)`` or ``(N, S)`` float32 with ``S ≥ 5`` and a
    unit last stride; ``frames`` is ``(B, H, W)`` or ``(H, W)`` float32
    with a unit last stride (any row and member strides, so a slab view
    of a larger frame needs no copy).  ``center_bounds`` and
    ``frame_origin`` follow the reference (frame coordinates; only the
    gather is offset); ``geometry``, a ``(B, 6)`` int32 table on the
    state's device (``member_geometry``), gives each member its own
    ``lo_y, hi_y, lo_x, hi_x, oy, ox`` instead, in the same launch.
    Raises on anything else, and when the geometry would let a window
    leave the frame.

    The filters call it once a frame on the same shapes, so a signature
    (shapes, strides, dtypes, devices, radius; default geometry) that
    passed the checks keeps its geometry; a table from ``member_geometry``
    is known by identity; the loads are planned again from each call's
    pointer."""
    if geometry is not None and (center_bounds is not None
                                 or frame_origin is not None):
        raise ValueError("give a per-member geometry table or "
                         "center_bounds/frame_origin, not both")
    single = state.dim() == 2
    if single:
        state, frames = state[None], frames[None]
        if geometry is not None:
            geometry = geometry.reshape(1, 6)
    sig = None
    if center_bounds is None and frame_origin is None:
        sig = (state.shape, state.stride(), frames.shape, frames.stride(),
               state.dtype, frames.dtype, state.device, frames.device,
               radius)
    geom = _CHECKED.get(sig)
    if geom is None:
        geom = _check(state, frames, radius, center_bounds, frame_origin)
        if sig is not None:
            if len(_CHECKED) >= 4096:
                _CHECKED.clear()
            _CHECKED[sig] = geom
    if geometry is not None:
        _check_table(geometry, state.shape[0], radius, *frames.shape[1:],
                     state.device)
    fs = frames.stride()
    p = plan(frames.data_ptr(), fs[0], fs[1], frames.shape[2])
    out = _launch(p, state, frames, geom, radius, sigma_psf, sigma_like,
                  i_bg, matched, geometry)
    patch_log_likelihood_kernel.launches += 1
    patch_log_likelihood_kernel.variants[p.variant] += 1
    if geometry is not None:
        patch_log_likelihood_kernel.per_member_launches += 1
    return out[0] if single else out


patch_log_likelihood_kernel.launches = 0
# launches that took a per-member geometry table (of `launches`)
patch_log_likelihood_kernel.per_member_launches = 0
patch_log_likelihood_kernel.variants = {"separable": 0, "direct": 0}
