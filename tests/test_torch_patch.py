"""B3's Hopper design (``csrc/patch_likelihood.cu``, ``k_patch_sep``) on the
CPU.

The kernel runs only on the card.  Its arithmetic — the window's columns
in ``4·NQ`` slots from the aligned column, the separable weights (one exp
a row and one a slot, 0 off the window), the matched form's sum of
squared model values in closed form, the Eq. 4 residuals summed in
float32, each row's slots first and then the rows — is written out in
``patch_likelihood.patch_log_likelihood_emulated``.  Here that emulation
is held against the live JAX reference, ``repro.kernels.ref``'s
``patch_log_likelihood_ref``, and the Pallas kernel in interpret mode, at
rtol = atol = ``PATCH_TOL`` = 3e-5 (the reference's own kernel bound), on:

* a converged cloud and a uniform spread over the frame;
* centres at the frame's edge (clamped) and at exact .5 positions;
* the halo-slab geometry (``center_bounds``/``frame_origin``), whose
  result must also equal the full frame's bit for bit;
* R in {2, 4, 6}, both forms, a background;
* an Eq. 4 close fit, where every residual is near 0.

``plan`` picks the loads from the frames' alignment alone, and the CUDA
wrapper refuses CPU tensors before it plans, builds or counts anything.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.kernels import ref as jref
from repro.kernels.patch_likelihood import patch_log_likelihood_kernel
from repro_torch.kernels import build
from repro_torch.kernels import patch_likelihood as tpatch

PATCH_TOL = 3e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _particles(cloud, n, h, w, seed):
    """y, x, i0 of ``n`` particles: a converged cloud (1 px around one
    spot), a uniform spread that reaches past every edge, or edge-of-frame
    centres and exact .5 positions."""
    rng = np.random.default_rng(seed)
    if cloud == "converged":
        y = 0.4 * h + rng.standard_normal(n)
        x = 0.6 * w + rng.standard_normal(n)
    elif cloud == "uniform":
        y = rng.random(n) * (h + 8) - 4
        x = rng.random(n) * (w + 8) - 4
    else:
        y = np.concatenate([[0.0, 0.49, 3.5, 3.99, 4.0, h - 1.0, h - 1.49],
                            np.arange(n - 7) % (h - 8) + 4.5])
        x = np.concatenate([[0.0, w - 1.0, 0.7, w - 1.7, 5.0, 0.0, w - 1.0],
                            (np.arange(n - 7) * 3) % (w - 8) + 4.5])
    i0 = rng.random(n) * 3
    return (y.astype(np.float32), x.astype(np.float32),
            i0.astype(np.float32))


def _emulated(y, x, i0, img, **kw):
    return tpatch.patch_log_likelihood_emulated(_t(y), _t(x), _t(i0),
                                                _t(img), **kw).numpy()


@pytest.mark.parametrize("cloud", ["converged", "uniform", "edges"])
@pytest.mark.parametrize("radius", [2, 4, 6])
@pytest.mark.parametrize("matched", [True, False])
def test_emulated_kernel_matches_reference(cloud, radius, matched):
    h, w = 48, 68
    y, x, i0 = _particles(cloud, 256, h, w, radius + 7)
    img = np.random.default_rng(radius).standard_normal((h, w)).astype(
        np.float32)
    got = _emulated(y, x, i0, img, radius=radius, matched=matched)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius,
                                         matched=matched)
    np.testing.assert_allclose(got, want, rtol=PATCH_TOL, atol=PATCH_TOL)
    if radius == 4:     # the slice's radius; interpret mode is slow
        pallas = patch_log_likelihood_kernel(y, x, i0, img, radius=radius,
                                             matched=matched, block_n=256,
                                             interpret=True)
        np.testing.assert_allclose(got, pallas, rtol=PATCH_TOL,
                                   atol=PATCH_TOL)


@pytest.mark.parametrize("matched", [True, False])
def test_emulated_kernel_with_background(matched):
    """A background level takes the matched form's sum of z and both
    cross terms of its closed-form sum of squares."""
    h, w = 40, 44
    y, x, i0 = _particles("uniform", 256, h, w, 21)
    img = (0.7 + np.random.default_rng(4).standard_normal((h, w))).astype(
        np.float32)
    kw = dict(radius=3, i_bg=0.7, matched=matched)
    got = _emulated(y, x, i0, img, **kw)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, **kw)
    np.testing.assert_allclose(got, want, rtol=PATCH_TOL, atol=PATCH_TOL)


@pytest.mark.parametrize("origin", [(5, 5), (4, 2)])
def test_emulated_kernel_slab_geometry(origin):
    """A halo slab whose origin moves the slots' alignment gives the full
    frame's bits (the kernel's sums do not depend on the slot a column
    falls in), and the reference's and the Pallas kernel's values."""
    radius, h, w = 3, 40, 40
    img = np.random.default_rng(9).standard_normal((h, w)).astype(np.float32)
    oy, ox = origin
    slab = img[oy:32 + radius, ox:32 + radius]
    bounds = (8, 31, 8, 31)
    rng = np.random.default_rng(11)
    y = (8.0 + rng.random(64) * 23.0).astype(np.float32)
    x = (8.0 + rng.random(64) * 23.0).astype(np.float32)
    i0 = (rng.random(64) * 3).astype(np.float32)
    full = _emulated(y, x, i0, img, radius=radius)
    got = _emulated(y, x, i0, slab, radius=radius, center_bounds=bounds,
                    frame_origin=origin)
    np.testing.assert_array_equal(got, full)
    pallas = patch_log_likelihood_kernel(
        y, x, i0, slab, radius=radius, block_n=64,
        center_bounds=jnp.asarray(bounds, jnp.int32),
        frame_origin=jnp.asarray(origin, jnp.int32), interpret=True)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, radius=radius)
    np.testing.assert_allclose(got, pallas, rtol=PATCH_TOL, atol=PATCH_TOL)
    np.testing.assert_allclose(got, want, rtol=PATCH_TOL, atol=PATCH_TOL)


def test_emulated_kernel_eq4_close_fit():
    """Eq. 4 near a perfect fit: far-apart spots rendered at the
    particles' own positions, so each particle's residuals are ~1e-7 and
    its log-likelihood ~0.  The kernel keeps each pixel's residual (no
    expansion into sum z^2 - 2 sum z m + sum m^2), so it stays at the
    reference's ~0 to well inside the tolerance."""
    h = w = 64
    y = np.asarray([12.3, 12.5, 40.0, 50.7], np.float32)
    x = np.asarray([14.6, 44.5, 20.2, 50.1], np.float32)
    i0 = np.full(4, 2.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img = sum(i0[k] * np.exp(-((yy - y[k]) ** 2 + (xx - x[k]) ** 2)
                             / (2 * 1.16 ** 2)) for k in range(4))
    img = img.astype(np.float32)
    got = _emulated(y, x, i0, img, matched=False)
    want = jref.patch_log_likelihood_ref(y, x, i0, img, matched=False)
    assert np.abs(want).max() < 1e-6
    np.testing.assert_allclose(got, want, rtol=PATCH_TOL, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=PATCH_TOL, atol=PATCH_TOL)


@pytest.mark.parametrize("ptr,f_b,f_row,w,vec", [
    (0, 512 * 512, 512, 512, True),          # a contiguous 512x512 stack
    (0, 0, 512, 512, True),                  # one frame broadcast (stride 0)
    (4 * 124 * 513, 512 * 512, 512, 264, True),   # an aligned slab view
    (4 * 123, 512 * 512, 512, 264, False),   # a slab at an odd column
    (0, 64 * 66, 66, 66, False),             # rows not a multiple of 4
    (0, 64 * 64, 64, 62, False),             # width not a multiple of 4
])
def test_patch_plan(ptr, f_b, f_row, w, vec):
    assert tpatch.plan(ptr, f_b, f_row, w) == tpatch.PatchPlan("separable",
                                                               vec)


def test_patch_kernel_refuses_cpu_tensors_before_planning(monkeypatch):
    """No silent fallback: the wrapper refuses CPU tensors before it plans,
    builds or counts anything."""
    planned = []
    monkeypatch.setattr(tpatch, "plan", lambda *a: planned.append(a))
    kern = tpatch.patch_log_likelihood_kernel
    launches, variants = kern.launches, dict(kern.variants)
    for state, frames in ((torch.zeros(1, 8, 5), torch.zeros(1, 16, 16)),
                          (torch.zeros(8, 5), torch.zeros(16, 16))):
        with pytest.raises(ValueError, match="CUDA"):
            kern(state, frames)
    assert not planned and not build._LIBS
    assert kern.launches == launches and kern.variants == variants
