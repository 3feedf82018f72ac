"""The comb scan (``repro_torch.kernels.ops.prefix_sum``) on the CPU.

* ``ops.prefix_sum`` runs the plain version for a CPU tensor: bit for bit
  ``torch.cumsum(x, -1)`` (the CPU path before the scan existed, so every
  comb stays exactly as it was) and the float64 scan rounded once, and
  within rtol = atol = 1e-6 of the reference's ``jnp.cumsum`` on the same
  numpy inputs (two float32 scans in different orders: ``jnp.cumsum`` is
  within ~2.5e-7 relative of the float64 scan at these sizes).
* The comb schemes' counts equal the live reference's on shared draws for
  RPA's per-shard comb: a per-shard ``n_out`` vector over a comb of twice
  the shard capacity, through ``resample_compressed``.
* On a CUDA tensor every float scan of the comb schemes goes through the
  kernel wrapper, never ``torch.cumsum`` (the wrapper is stood in for, so
  the routing is checked on the CPU), and no float ``torch.cumsum``
  remains in ``src/repro_torch/core`` (an AST scan).
* The kernel wrapper refuses a CPU tensor before it builds or counts.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import particles as jparticles
from repro_torch.core import particles as tparticles
from repro_torch.core import resampling as tresampling
from repro_torch.core.draws import BankDraws, ReplayDraws
from repro_torch.kernels import build, ops, scan

TOL = dict(rtol=1e-6, atol=1e-6)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CORE = ROOT / "src" / "repro_torch" / "core"
COMB_SCHEMES = ["systematic", "stratified", "multinomial", "residual"]


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _comb_weights(shape, seed):
    """Normalized float32 weights of ``3 N(0, 1)`` log-weights, the rows a
    comb scans."""
    rng = np.random.default_rng(seed)
    lw = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    w = np.exp(lw - lw.max(-1, keepdims=True, initial=-np.inf))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape", [(4096,), (8, 4096), (4, 8), (0,),
                                   (3, 0), (2, 5000)])
def test_prefix_sum_on_cpu_is_cumsum_and_matches_reference(shape):
    w = _comb_weights(shape, sum(shape) + 1)
    got = ops.prefix_sum(_t(w))
    assert got.shape == shape and got.dtype == torch.float32
    assert torch.equal(got, torch.cumsum(_t(w), -1))
    assert torch.equal(got, scan.prefix_sum_ref(_t(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.cumsum(
        jnp.asarray(w), -1)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.cumsum(
        w.astype(np.float64), -1), rtol=2.0 ** -24, atol=0)


@pytest.mark.parametrize("scheme", COMB_SCHEMES)
def test_rpa_comb_counts_match_reference(scheme):
    """RPA's per-shard comb: ``n_out`` per shard (0 included) over a comb
    of capacity 2C, counts and fill weights exactly the reference's."""
    p, c = 4, 24
    rng = np.random.default_rng(5)
    state = rng.standard_normal((p, c, 3)).astype(np.float32)
    counts = rng.integers(0, 5, (p, c)).astype(np.int32)
    lw = np.where(counts > 0, rng.standard_normal((p, c)),
                  -np.inf).astype(np.float32)
    n_outs = np.array([48, 0, 31, 17])
    keys = [jax.random.key(80 + i) for i in range(p)]
    draws = []
    for key in keys:
        if scheme == "systematic":
            arr = ("uniform", np.asarray(jax.random.uniform(key, ())))
        elif scheme == "stratified":
            arr = ("uniform", np.asarray(jax.random.uniform(key, (2 * c,))))
        else:
            arr = ("exponential", np.asarray(jax.random.exponential(
                key, (2 * c + 1,))))
        draws.append(ReplayDraws([arr]))
    ens = tparticles.ParticleEnsemble(_t(state), _t(lw),
                                      _t(counts, np.int32))
    got = tparticles.resample_compressed(
        BankDraws(draws), ens, torch.tensor(n_outs), scheme=scheme,
        capacity=2 * c, fill_log_weight=-np.log(np.float32(p * c)))
    for i, key in enumerate(keys):
        ref = jparticles.ParticleEnsemble(jnp.asarray(state[i]),
                                          jnp.asarray(lw[i]),
                                          jnp.asarray(counts[i]))
        want = jparticles.resample_compressed(
            key, ref, jnp.asarray(n_outs[i]), scheme=scheme, capacity=2 * c,
            fill_log_weight=-np.log(np.float32(p * c)))
        np.testing.assert_array_equal(got.counts[i].numpy(),
                                      np.asarray(want.counts))
        np.testing.assert_array_equal(got.log_weights[i].numpy(),
                                      np.asarray(want.log_weights))
        assert int(got.counts[i].sum()) == n_outs[i]


# float scans per call: the CDF, and for the multinomial comb (also inside
# the residual scheme) the exponential spacings first
SCANS = {"systematic": 1, "stratified": 1, "multinomial": 2, "residual": 2}


@pytest.mark.parametrize("scheme", COMB_SCHEMES)
def test_comb_float_scans_take_the_kernel_on_cuda(scheme, monkeypatch):
    """With the tensors taken for CUDA ones, each float scan of a comb
    scheme reaches the scan kernel's wrapper, once per scan and batched
    over the members, and ``torch.cumsum`` sees integer scans only."""
    cumsum = torch.cumsum
    calls = []

    def kernel(x):
        calls.append(tuple(x.shape))
        return cumsum(x.double(), -1).float()

    def integer_cumsum(x, *args, **kw):
        assert not x.is_floating_point(), "a float scan reached cumsum"
        return cumsum(x, *args, **kw)

    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(scan, "prefix_sum_kernel", kernel)
    monkeypatch.setattr(torch, "cumsum", integer_cumsum)
    one = {"systematic": ("uniform", np.full((), 0.3)),
           "stratified": ("uniform", np.linspace(0.0, 0.99, 64)),
           "multinomial": ("exponential", np.linspace(0.1, 2.0, 65)),
           "residual": ("exponential", np.linspace(0.1, 2.0, 65))}[scheme]
    draws = BankDraws([ReplayDraws([one]) for _ in range(3)])
    lw = _t(np.log(_comb_weights((3, 64), 9)))
    counts = tresampling.RESAMPLERS[scheme](draws, lw, 64)
    anc = tresampling.counts_to_ancestors(counts, 64)
    assert calls == [(3, 65)] * (SCANS[scheme] - 1) + [(3, 64)]
    assert anc.shape == (3, 64) and bool((counts.sum(-1) == 64).all())


# integer scans of core/: the function and why its scan is exact
INTEGER_SCANS = {
    ("resampling.py", "row_cumsum"): "int64 multiplicities",
    ("dlb.py", "_interval_overlap_matrix"): "int32 surplus/deficit units",
    ("dlb.py", "proportional_allocation"): "int32 room per shard",
    ("dlb.py", "pack_windows"): "int64 units sent per destination",
}


def _cumsum_sites():
    for path in sorted(CORE.glob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "cumsum"):
                    yield path.name, fn.name, node.lineno


def test_no_float_cumsum_in_core():
    """Every ``cumsum`` left in ``src/repro_torch/core`` is an integer
    scan named in INTEGER_SCANS; the float scans go through
    ``ops.prefix_sum``."""
    sites = list(_cumsum_sites())
    assert sites, "the scan found no cumsum at all"
    for name, fn, line in sites:
        assert (name, fn) in INTEGER_SCANS, (
            f"core/{name}:{line} ({fn}) calls cumsum; a float scan must go "
            f"through ops.prefix_sum")
    uses = [n for path in sorted(CORE.glob("*.py"))
            for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Attribute) and n.attr == "prefix_sum"]
    assert len(uses) == 3


def test_prefix_sum_kernel_refuses_cpu_tensors():
    """No silent fallback: the wrapper refuses a CPU tensor before it
    builds, allocates or counts anything."""
    launches = scan.prefix_sum_kernel.launches
    for x in (torch.zeros(2, 16), torch.zeros(16, dtype=torch.float64)):
        with pytest.raises(ValueError, match="CUDA"):
            scan.prefix_sum_kernel(x)
    assert scan.prefix_sum_kernel.launches == launches
    assert not build._LIBS


# ---------------------------------------------------------------------------
# The kernel's fixed order (k_scan_lookback), emulated on the CPU
# ---------------------------------------------------------------------------

SPAN = scan.SPAN


def _scan_rows(kind, rows, n, seed):
    """float32 rows to scan: comb weights over a wide range of exponents,
    all the mass in the last element, or signed values."""
    rng = np.random.default_rng(seed)
    if kind == "weights":
        return _comb_weights((rows, n), seed)
    if kind == "last":
        x = np.zeros((rows, n), np.float32)
        x[:, -1] = 1.0
        return x
    return (rng.standard_normal((rows, n)) * 2.0 ** rng.integers(
        -20, 20, (rows, n))).astype(np.float32)


@pytest.mark.parametrize("kind", ["weights", "last", "signed"])
@pytest.mark.parametrize("rows,n", [(1, SPAN - 1), (2, SPAN + 1), (4, 8),
                                    (3, 33 * SPAN + 17), (1, 70 * SPAN + 5)])
def test_emulated_scan_within_one_ulp_of_plain(kind, rows, n):
    """The kernel's order of float64 sums (a thread's 16 elements in
    sequence, Kogge-Stone over the block, the tile offsets from group sums
    and in-group totals in fixed trees) rounds each prefix once, so it is
    within one float32 ulp of the plain version's float64 scan."""
    x = _scan_rows(kind, rows, n, rows * n)
    got = scan.prefix_sum_emulated(_t(x)).numpy()
    want = scan.prefix_sum_ref(_t(x)).numpy()
    assert got.shape == (rows, n) and got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= np.spacing(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=2.0 ** -23)


@pytest.mark.parametrize("rows,n", [(5, 40 * SPAN + 3), (4, 8),
                                    (3, 2 * SPAN)])
def test_emulated_scan_rows_do_not_depend_on_the_batch(rows, n):
    """A row's tiles and trees depend on the row alone: each row scanned
    alone gives the batch's bits."""
    x = _scan_rows("signed", rows, n, 7 + n)
    batch = scan.prefix_sum_emulated(_t(x))
    for r in range(rows):
        alone = scan.prefix_sum_emulated(_t(x[r:r + 1]))
        assert torch.equal(alone[0].view(torch.int32),
                           batch[r].view(torch.int32))


@pytest.mark.parametrize("rows,n,tiles", [
    (1, 2 ** 22, 1024), (8, 2 ** 22, 1024), (4, 8, 1), (1024, 4097, 2),
    (1, SPAN, 1), (1, 33 * SPAN, 33), (3, 0, 0)])
def test_scan_plan(rows, n, tiles):
    """One launch of one block a tile at every shape; the scratch holds
    the 16-byte ticket, then a 16-byte slot per tile and per group of 32
    tiles."""
    groups = -(-tiles // scan.GROUP)
    assert scan.plan(rows, n) == scan.ScanPlan(
        "lookback", tiles, rows * tiles, 16 + rows * (tiles + groups) * 16)


def test_prefix_sum_kernel_refuses_cpu_tensors_before_planning(monkeypatch):
    """The CPU refusal comes before the plan, the build and the count."""
    planned = []
    monkeypatch.setattr(scan, "plan", lambda *a: planned.append(a))
    launches = scan.prefix_sum_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        scan.prefix_sum_kernel(torch.zeros(4, 8))
    assert not planned and not build._LIBS
    assert scan.prefix_sum_kernel.launches == launches
