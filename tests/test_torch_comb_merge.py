"""B1 and B2's redesign (the normalizer, the look-back CDF and the merge
comb of ``csrc/comb_merge.cuh``) held on the CPU through its torch
emulation.

* The merge partition: ``comb_merge.merge_ancestors`` (the kernel's block
  splits by a two-level 32-way search, its threads' splits by bisection,
  the merge steps) equals the first design's per-lane upper-bound
  bisection on the same CDF, exactly — on fixed cases (one slot with all the mass, half of
  it, dead runs, a member with no finite weight, NaN, n_out below and above
  n_in, ragged tails, one tile, 4097) and on hypothesis' draws (no example
  database, derandomized: a run replays nothing).
* The normalizer's parts and tree against float64 sums.
* ``systematic_ancestors_emulated`` (B1) against ``systematic_ancestors_ref``
  and the Pallas kernel in interpret mode, and
  ``fused_weight_step_emulated`` (B2) against ``fused_weight_step_ref`` and
  the Pallas megakernel in interpret mode, on the same numpy-seeded inputs:
  ancestors equal except at comb points within ``TIE_DELTA`` of the float64
  CDF (tests/test_torch_resample.py's rule), B2's decision equal and its
  floats within ``FUSED_TOL``; a member's result never depends on the batch.
* B2's plain comb CDF sums in float64 and rounds once: bit for bit the
  float32 ``cumsum`` the CPU ran before, and B1's plain comb on the same
  weights.
* Each ``plan()``'s launches and scratch layout, and that the wrappers
  refuse CPU tensors before they plan, build or count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.kernels import resample as jresample
from repro.kernels import sir_fused as jfused
from repro_torch.kernels import build, comb_merge, ref, resample, scan
from repro_torch.kernels import sir_fused

TIE_DELTA = 1e-5
FUSED_TOL = 2e-6
SPAN = comb_merge.SPAN
PROFILES = ["spread", "all_mass", "half_mass", "dead_runs", "no_finite",
            "nan"]


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _log_weights(profile, b, n, seed):
    rng = np.random.default_rng(seed)
    lw = (3.0 * rng.standard_normal((b, n))).astype(np.float32)
    if profile == "all_mass":
        lw[:] = -np.inf
        lw[:, rng.integers(0, n, b)] = 0.0
    elif profile == "half_mass":
        hot = rng.integers(0, n, b)
        rest = np.log(np.exp(lw.astype(np.float64)).sum(-1))
        lw[np.arange(b), hot] = rest.astype(np.float32)
    elif profile == "dead_runs":
        for r in range(b):
            for _ in range(3):
                a = int(rng.integers(0, n))
                lw[r, a:a + int(rng.integers(1, max(2, n // 3)))] = -np.inf
    elif profile == "no_finite":
        lw[:] = -np.inf
    elif profile == "nan":
        lw[:, ::7] = np.nan
    return lw


def _cdf(lw):
    """The normalized weights' CDF as the plain versions build it."""
    x = _t(lw)
    w = torch.exp(x - x.amax(-1, keepdim=True))
    return scan.prefix_sum_ref(w / w.sum(-1, keepdim=True))


def _bisect(cdf, u, n_out):
    pos = comb_merge.comb_points(u, torch.arange(n_out).expand(
        cdf.shape[0], n_out), n_out)
    return comb_merge.upper_bound_bisect(cdf, pos)


# ---------------------------------------------------------------------------
# The merge partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("n_in,n_out", [
    (SPAN, SPAN), (4097, 4097), (3 * SPAN + 17, SPAN - 5), (777, 2 * SPAN + 9),
    (1, 1), (1, 37), (37, 1), (5, 4096)])
def test_merge_equals_per_lane_bisection(profile, n_in, n_out):
    """The merge's ancestors are the bisection's, lane for lane, whatever
    the mass does: ragged tails, one tile, n_out below and above n_in, a
    member whose CDF is NaN throughout (ancestor 0 on both)."""
    b = 3
    cdf = _cdf(_log_weights(profile, b, n_in, n_in + n_out))
    u = _t(np.random.default_rng(n_out).random(b))
    got = comb_merge.merge_ancestors(cdf, u, n_out)
    want = _bisect(cdf, u, n_out)
    assert got.dtype == torch.int32 and got.shape == (b, n_out)
    assert torch.equal(got, want)
    if profile == "no_finite":
        assert not bool(got.any())


@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_in=st.integers(1, 3 * SPAN), n_out=st.integers(1, 3 * SPAN),
       profile=st.sampled_from(PROFILES), seed=st.integers(0, 2 ** 16),
       u=st.floats(0.0, 1.0, exclude_max=True, width=32))
def test_merge_equals_bisection_on_drawn_cases(n_in, n_out, profile, seed, u):
    cdf = _cdf(_log_weights(profile, 1, n_in, seed))
    uu = torch.tensor([u], dtype=torch.float32)
    assert torch.equal(comb_merge.merge_ancestors(cdf, uu, n_out),
                       _bisect(cdf, uu, n_out))


@pytest.mark.parametrize("profile", ["spread", "all_mass", "no_finite"])
def test_merge_split_is_the_merge_path_split(profile):
    """A block's split (the two-level 32-way search: the coarse samples,
    then the window they leave) is the least a with cdf[a] after comb point
    d - 1 - a, for every diagonal of the merged sequence."""
    n_in, n_out = 2 * SPAN + 3, SPAN + 11
    cdf = _cdf(_log_weights(profile, 1, n_in, 5))
    u = torch.tensor([0.37])
    d = torch.arange(n_in + n_out + 1)[None]
    a = comb_merge.merge_split(cdf, u, n_out, d)[0]
    pos = comb_merge.comb_points(u, torch.arange(n_out)[None], n_out)[0]
    for dd in range(0, n_in + n_out + 1, 97):
        lo, hi = max(0, dd - n_out), min(dd, n_in)
        after = [not bool(cdf[0, k] <= pos[dd - 1 - k])
                 for k in range(lo, hi)] + [True]
        assert int(a[dd]) == lo + after.index(True)


# ---------------------------------------------------------------------------
# The normalizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, SPAN, SPAN + 1, 70 * SPAN + 5])
@pytest.mark.parametrize("profile", ["spread", "dead_runs", "all_mass"])
def test_normalizer_parts_and_tree_match_float64(n, profile):
    """(max, sum exp(v - max)) from the tiles' parts and the fixed tree
    equals the float64 sum within 1e-6 (the tiles' exps are float32, the
    sums double), the max exactly; a row with no finite weight sums to 0."""
    lw = _log_weights(profile, 2, n, n)
    m, s, q = comb_merge.tile_parts(_t(lw), squares=True)
    big, total, sq = comb_merge.combine_parts(m, s, q)
    assert m.shape == (2, comb_merge.tiles(n))
    np.testing.assert_array_equal(big.numpy(), lw.max(-1))
    m = lw.max(-1, keepdims=True).astype(np.float64)
    e = np.where(np.isfinite(lw),
                 np.exp(lw - np.where(np.isfinite(m), m, 0.0)), 0.0)
    np.testing.assert_allclose(total.numpy(), e.sum(-1), rtol=1e-6)
    np.testing.assert_allclose(sq.numpy(), (e * e).sum(-1), rtol=1e-6)
    dead = np.full((1, n), -np.inf, np.float32)
    _, total, _ = comb_merge.combine_parts(
        *comb_merge.tile_parts(_t(dead))[:2])
    assert float(total[0]) == 0.0


# ---------------------------------------------------------------------------
# B1's emulation against the plain version and the Pallas kernel
# ---------------------------------------------------------------------------

def _ties(got, want, lw, u, n_out):
    """tests/test_torch_resample.py's rule: each lane where the ancestors
    differ has its comb point within TIE_DELTA of the float64 CDF at both
    boundaries; returns the number of such lanes."""
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w / w.sum())
    pos = (np.arange(n_out) + u) / n_out
    lanes = np.nonzero(got != want)[0]
    for i in lanes:
        lo, hi = sorted((int(got[i]), int(want[i])))
        assert abs(cdf[lo] - pos[i]) <= TIE_DELTA
        assert abs(cdf[hi - 1] - pos[i]) <= TIE_DELTA
    return len(lanes)


@pytest.mark.parametrize("n_in,n_out", [(2 * SPAN, 2 * SPAN),
                                         (3 * SPAN + 77, SPAN),
                                         (SPAN - 100, 2 * SPAN)])
@pytest.mark.parametrize("profile", ["spread", "half_mass", "dead_runs"])
def test_systematic_emulation_matches_plain_and_pallas(n_in, n_out, profile):
    b = 2
    lw = _log_weights(profile, b, n_in, n_in + 3 * n_out)
    u = np.random.default_rng(n_out).random(b).astype(np.float32)
    got = resample.systematic_ancestors_emulated(_t(lw), _t(u), n_out)
    plain = ref.systematic_ancestors_ref(_t(lw), _t(u), n_out)
    assert got.shape == (b, n_out) and got.dtype == torch.int32
    for r in range(b):
        _ties(got[r].numpy(), plain[r].numpy(), lw[r], u[r], n_out)
        pallas = np.asarray(jresample.systematic_ancestors_kernel(
            jnp.asarray(lw[r]), jnp.asarray(u[r]), n_out=n_out, block=1024,
            interpret=True))
        _ties(got[r].numpy(), pallas, lw[r], u[r], n_out)
        # a member alone gives the batch's bits
        solo = resample.systematic_ancestors_emulated(
            _t(lw[r:r + 1]), _t(u[r:r + 1]), n_out)
        assert torch.equal(solo[0], got[r])


def test_systematic_emulation_of_a_member_with_no_finite_weight():
    """Its CDF is NaN throughout: ancestor 0 everywhere, as the first
    design's bisection gives."""
    lw = np.full((1, SPAN + 9), -np.inf, np.float32)
    got = resample.systematic_ancestors_emulated(_t(lw), _t([0.5]), 300)
    assert not bool(got.any())


# ---------------------------------------------------------------------------
# B2's emulation against the plain version and the Pallas megakernel
# ---------------------------------------------------------------------------

def _fused_case(seed, b, n, d, kind):
    rng = np.random.default_rng(seed)
    lw = (np.full((b, n), -np.log(n)) + 0.1 * rng.standard_normal((b, n))
          ).astype(np.float32)
    ll = (2.0 * rng.standard_normal((b, n))).astype(np.float32)
    if kind == "dead":
        lw[:] = -np.inf
    elif kind == "flat":
        ll = (1e-3 * ll).astype(np.float32)
    elif kind == "some_dead":
        lw[rng.random((b, n)) < 0.3] = -np.inf
    elif kind == "skewed":
        lw[:, n // 4:n // 4 + n // 16] = -np.inf
        ll[:, 7] = 30.0
    state = (rng.random((b, n, d)) * 64).astype(np.float32)
    u = rng.random(b).astype(np.float32)
    return lw, ll, state, u


def _fused_ties(anc_got, anc_want, lw, ll, u):
    lwp = np.where(np.isfinite(lw), lw.astype(np.float64) + ll, -np.inf)
    m = lwp.max()
    n = lw.shape[0]
    w = (np.exp(lwp - m) / np.exp(lwp - m).sum() if np.isfinite(m)
         else np.full(n, 1.0 / n))
    cdf = np.cumsum(w)
    for i in np.nonzero(anc_got != anc_want)[0]:
        lo, hi = sorted((int(anc_got[i]), int(anc_want[i])))
        pos = (i + float(u)) / n
        assert abs(cdf[lo] - pos) <= TIE_DELTA, (i, lo, hi)
        assert abs(cdf[hi - 1] - pos) <= TIE_DELTA, (i, lo, hi)


@pytest.mark.parametrize("kind,ess_frac,always,comb", [
    ("normal", 0.9, False, True), ("normal", 0.5, True, True),
    ("flat", 0.5, False, True), ("dead", 0.5, False, True),
    ("some_dead", 0.9, False, True), ("skewed", 0.5, False, True),
    ("normal", 0.5, True, False), ("skewed", 0.5, True, False)])
def test_fused_emulation_matches_plain_and_pallas(kind, ess_frac, always,
                                                  comb):
    b, n, d = 2, 2 * SPAN, 5
    lw, ll, state, u = _fused_case(11, b, n, d, kind)
    anc, new_lw, est, stats = sir_fused.fused_weight_step_emulated(
        _t(lw), _t(ll), _t(state), _t(u), ess_frac=ess_frac, always=always,
        comb=comb)
    plain = sir_fused.fused_weight_step_ref(
        _t(lw), _t(ll), _t(state), _t(u), ess_frac=ess_frac, always=always,
        comb=comb)
    tol = dict(rtol=FUSED_TOL, atol=FUSED_TOL)
    assert torch.equal(stats[:, 2] > 0, plain.resampled)
    for got, want in ((stats[:, 0], plain.ess), (stats[:, 1], plain.log_z),
                      (stats[:, 5], plain.weight_skew),
                      (est, plain.estimate),
                      (new_lw, plain.new_log_weights)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    if kind == "dead":
        assert float(stats[0, 0]) == n and np.isneginf(float(stats[0, 1]))
    for r in range(b):
        _fused_ties(anc[r].numpy(), plain.ancestors[r].numpy(), lw[r], ll[r],
                    u[r])
        if not comb or not bool(stats[r, 2] > 0):
            assert torch.equal(anc[r], torch.arange(n, dtype=torch.int32))
        p_anc, p_lw, p_est, p_stats = jfused.fused_weight_step_kernel(
            jnp.asarray(lw[r]), jnp.asarray(ll[r]), jnp.asarray(state[r]),
            jnp.asarray(u[r]), block=1024, ess_frac=ess_frac, always=always,
            comb=comb, interpret=True)
        assert bool(stats[r, 2] > 0) == bool(p_stats[2] > 0)
        np.testing.assert_allclose(stats[r, [0, 1, 5]].numpy(),
                                   np.asarray(p_stats)[[0, 1, 5]], **tol)
        np.testing.assert_allclose(est[r].numpy(), np.asarray(p_est)[0],
                                   **tol)
        np.testing.assert_allclose(new_lw[r].numpy(), np.asarray(p_lw),
                                   **tol)
        _fused_ties(anc[r].numpy(), np.asarray(p_anc), lw[r], ll[r], u[r])


def test_fused_emulation_members_do_not_depend_on_the_batch():
    b, n, d = 3, SPAN + 300, 3
    lw, ll, state, u = _fused_case(12, b, n, d, "normal")
    lw[1] = -np.inf
    batch = sir_fused.fused_weight_step_emulated(
        _t(lw), _t(ll), _t(state), _t(u), always=True)
    for r in range(b):
        solo = sir_fused.fused_weight_step_emulated(
            _t(lw[r:r + 1]), _t(ll[r:r + 1]), _t(state[r:r + 1]),
            _t(u[r:r + 1]), always=True)
        for a, s in zip(batch, solo):
            assert torch.equal(a[r].view(torch.int32), s[0].view(torch.int32))


# ---------------------------------------------------------------------------
# B2's plain comb CDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 2 ** 20 + 333])
def test_fused_plain_cdf_is_the_double_scan_bit_for_bit(n):
    """On the CPU the float64 scan rounded once is bit for bit the float32
    cumsum, so B2's plain comb did not move; and with ll = 0 it is B1's
    plain comb on the same weights, lane for lane."""
    rng = np.random.default_rng(n)
    lw = _t(3.0 * rng.standard_normal((1, n)))
    w = torch.softmax(lw, -1)
    assert torch.equal(torch.cumsum(w.double(), -1).to(w.dtype).view(
        torch.int32), torch.cumsum(w, -1).view(torch.int32))
    u = torch.tensor([0.41])
    dec = sir_fused.fused_weight_step_ref(
        lw, torch.zeros_like(lw), torch.zeros((1, n, 1)), u, always=True)
    assert torch.equal(dec.ancestors, ref.systematic_ancestors_ref(lw, u, n))


# ---------------------------------------------------------------------------
# Plans and the wrappers' refusal
# ---------------------------------------------------------------------------

def _regions(p, fields, sizes):
    spans = sorted((getattr(p, f), getattr(p, f) + size)
                   for f, size in zip(fields, sizes))
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    return spans


@pytest.mark.parametrize("b,n_in,n_out", [(8, 2 ** 22, 2 ** 22), (1, 1, 1),
                                          (2, 4097, 300), (3, SPAN, 9000)])
def test_systematic_plan(b, n_in, n_out):
    p = resample.systematic_plan(b, n_in, n_out)
    nt = -(-n_in // SPAN)
    ng = -(-nt // scan.GROUP)
    assert (p.variant, p.tiles, p.groups) == ("merge", nt, ng)
    assert p.diagonals == -(-(n_in + n_out) // comb_merge.MERGE_SPAN)
    assert p.agg_at >= comb_merge.FLAGS_HEAD and p.agg_at % 16 == 0
    assert p.grp_at == p.agg_at + b * nt * 16
    assert p.flag_bytes == p.grp_at + b * ng * 16
    assert p.ms_at == b * nt * comb_merge.PART_BYTES
    assert p.cdf_at % 256 == 0 and p.coarse_at % 256 == 0
    coarse = b * -(-n_in // comb_merge.COARSE) * 4
    splits = b * (p.diagonals + 1) * 4
    assert p.work_bytes == p.splits_at + splits
    _regions(p, ("ms_at", "cdf_at", "coarse_at", "splits_at"),
             (b * 8, b * n_in * 4, coarse, splits))
    # the first design stays launchable under its own plan
    assert resample.SysPlan("seven_pass").variant == "seven_pass"
    if (b, n_in) == (8, 2 ** 22):
        assert (nt, p.diagonals) == (1024, 2048)


@pytest.mark.parametrize("b,n,d", [(1, 2 ** 22, 5), (8, 2 ** 20, 5),
                                   (2, 4097, 13), (1, 1, 1)])
def test_fused_plan(b, n, d):
    p = sir_fused.plan(b, n, d)
    nt = -(-n // SPAN)
    ng = -(-nt // scan.GROUP)
    assert (p.variant, p.tiles, p.groups) == ("merge", nt, ng)
    assert p.diagonals == -(-2 * n // comb_merge.MERGE_SPAN)
    assert p.agg_at >= comb_merge.FLAGS_HEAD
    assert p.flag_bytes == p.grp_at + b * ng * 16
    assert p.scal_at == b * nt * comb_merge.PART_BYTES
    assert p.est_at % 16 == 0 and p.cdf_at % 256 == 0
    coarse = b * -(-n // comb_merge.COARSE) * 4
    splits = b * (p.diagonals + 1) * 4
    _regions(p, ("scal_at", "est_at", "cdf_at", "coarse_at", "splits_at"),
             (b * sir_fused.SCAL_BYTES, b * nt * d * 8, b * n * 4, coarse,
              splits))
    assert p.work_bytes == p.splits_at + splits
    assert sir_fused.FusedPlan("seven_pass").variant == "seven_pass"


def test_wrappers_refuse_cpu_tensors_before_planning(monkeypatch):
    planned = []
    monkeypatch.setattr(resample, "systematic_plan",
                        lambda *a: planned.append(a))
    monkeypatch.setattr(sir_fused, "plan", lambda *a: planned.append(a))
    sys_launches = resample.systematic_ancestors_kernel.launches
    fused_launches = sir_fused.fused_weight_step_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        resample.systematic_ancestors_kernel(torch.zeros(2, 64),
                                             torch.zeros(2), 64)
    with pytest.raises(ValueError, match="CUDA"):
        sir_fused.fused_weight_step_kernel(
            torch.zeros(1, 64), torch.zeros(1, 64), torch.zeros(1, 64, 5),
            torch.zeros(1))
    assert not planned and not build._LIBS
    assert resample.systematic_ancestors_kernel.launches == sys_launches
    assert sir_fused.fused_weight_step_kernel.launches == fused_launches
