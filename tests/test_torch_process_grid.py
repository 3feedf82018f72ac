"""The process grid (``runtime.ProcessGrid``): ranks on a grid of named
axes, each axis's collectives on its own sub-group, and the filter, the
bank and the session server over it, on the CPU with gloo.

One module-scoped ``launch.mesh.spawn`` of 4 ranks runs every check on a
``(2, 2)`` ``("bank", "data")`` grid (``launch.grid.grid_checks``; the
ranks import neither ``jax`` nor this module, one intra-op thread each,
the group's 60 s timeout and a deadline).  Rank ``r`` sits at
``(r // 2, r % 2)``.  Against the same call on the emulated grid in this
process:

* every verb on each axis's line (its own inputs a line) bit for bit the
  emulated verb on that line's shard;
* ``FilterBank(bank_axis="bank")`` for RNA, RPA and MPF (16x16 frames, 2
  x 32 particles, 4 members): every rank's ``(B, ...)`` outputs and diag
  the emulated grid bank's, its final shard ``(B / 2, 1, C, ...)`` its
  bank shard's members on its data shard, and the emulated grid bank the
  bank without ``bank_axis`` on ``EmulatedMesh(2)``;
* ``ParallelParticleFilter`` on the grid's data axis, with and without a
  domain (2 tiles), bit for bit ``EmulatedMesh(2)``'s run;
* a session server over the grid (capacity 4, 2 slots a bank shard) under
  churn on the linear-Gaussian demo model: every session bit for bit its
  standalone filter and the emulated grid server's run, one step
  program; a session suspended on the ranks resumes on a single-device
  server bit for bit, and one suspended on a single-device server
  resumes on the ranks bit for bit;
* an RNA bank on the reference's draws replayed (member ``i``, data
  shard ``s`` takes ``fold_in(keys[i], s)``'s stream) against
  ``repro.core.filters.make_sharded_bank_step`` under
  ``test_torch_bank_mesh.ref_bank``, at its tolerances (atol 1e-5).

Validation runs on a world-size-1 group in this process: a grid whose
ranks do not number the world, and a missing axis, raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bank_mesh import ref_bank
from test_torch_dra_more import dra_stream
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import distributed as jdist
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import tracking as jtracking
from repro_torch.core import FilterBank, ParallelParticleFilter, SIRConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.runtime import EmulatedGrid, EmulatedMesh, ProcessGrid
from repro_torch.data.synthetic_movie import generate_movie
from repro_torch.launch import grid as launch_grid
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.serve import lg_demo_model
from repro_torch.models.tracking import TrackingConfig, TrackingSSM
from repro_torch.serve import ParticleSessionServer

SHAPE, NAMES = (2, 2), ("bank", "data")
WORLD = 4
C, FRAMES, IMG = 32, 4, (16, 16)
BANK = [11, 12, 13, 14]
ATOL = 1e-5


def _coords(r):
    return (r // SHAPE[1], r % SHAPE[1])


def _frames():
    return generate_movie(TorchDraws.from_seed(0, "cpu"),
                          TrackingConfig(img_size=IMG),
                          n_frames=FRAMES).frames.numpy()


BASE = {"particles": SHAPE[1] * C}
FILTERS = {
    "bank-rna": {"dra": {"kind": "rna"}, "bank": BANK, "bank_axis": "bank"},
    "bank-rpa": {"dra": {"kind": "rpa", "scheduler": "lgs", "k_cap": 8},
                 "bank": BANK, "bank_axis": "bank"},
    "bank-mpf": {"dra": {"kind": "mpf"}, "bank": BANK, "bank_axis": "bank"},
    "rna": {"dra": {"kind": "rna"}, "key": 11},
    "domain-rna": {"dra": {"kind": "rna"}, "key": 11, "domain": True},
}

# the reference case: test_torch_bank_mesh's size over the 2 data shards
REF_C, REF_FRAMES, REF_IMG, REF_B = 64, 4, 48, 2
REF_CFG = jtracking.TrackingConfig(img_size=(REF_IMG, REF_IMG), v_init=1.5)


def _ref_inputs():
    frames = np.stack([np.array(ref_movie(jax.random.key(i), REF_CFG,
                                          n_frames=REF_FRAMES).frames)
                       for i in range(REF_B)])
    keys = jax.random.split(jax.random.key(7), REF_B)
    return frames, keys


def _ref_case():
    frames, keys = _ref_inputs()
    p = SHAPE[1]
    return {"frames": frames, "cfg": {"v_init": 1.5},
            "particles": p * REF_C, "dra": {"kind": "rna"},
            "bank_axis": "bank",
            "bank": [[dra_stream(keys[i], s, "rna", REF_C, REF_FRAMES, p)
                      for s in range(p)] for i in range(REF_B)]}


# -- sessions: the linear-Gaussian demo model, capacity 4 over the grid ------

N_SESS, CAP, K_SESS = 64, 4, 10
SESS_SIR = {"n_particles": N_SESS, "ess_frac": 0.5}


def _zs(seed):
    return (np.random.default_rng(seed).standard_normal(K_SESS) * 0.8
            ).astype(np.float32)


SEEDS = {"a": 41, "b": 42, "c": 43, "d": 44, "e": 45}
ZS = {sid: _zs(i) for i, sid in enumerate(SEEDS)}
ZS["moved"] = _zs(9)           # suspended on one device, resumed on ranks
MOVED_SEED, MOVED_AT = 50, 4   # ...after MOVED_AT frames there
OUT_AT = 6                     # "b" leaves the ranks after OUT_AT frames


def _session_ops(moved):
    """Churn on the grid: a, b, c attach; c detaches at tick 3 and d takes
    its slot; "moved" (suspended on one device) resumes at tick 4; a is
    suspended and resumed at ticks 5 and 6; b is suspended for good at
    tick OUT_AT; e attaches at tick 7.  Every session's stream starts at
    its first frame."""
    ops = [("attach", s, SEEDS[s]) for s in "abc"]
    fed = {s: 0 for s in "abc"}
    for t in range(K_SESS):
        if t == 3:
            ops.append(("detach", "c"))
            del fed["c"]
            ops.append(("attach", "d", SEEDS["d"]))
            fed["d"] = 0
        if t == 4:
            ops.append(("resume", "moved", moved))
            fed["moved"] = MOVED_AT
        if t == 5:
            ops.append(("suspend", "a"))
            paused = fed.pop("a")
        if t == 6:
            ops.append(("resume", "a", None))     # filled in by the ranks
            fed["a"] = paused
        if t == OUT_AT:
            ops.append(("suspend", "b"))
            del fed["b"]
        if t == 7:
            ops.append(("attach", "e", SEEDS["e"]))
            fed["e"] = 0
        for s in list(fed):
            if fed[s] < K_SESS:
                ops.append(("submit", s, fed[s]))
                fed[s] += 1
        ops.append(("step",))
        ops.append(("latest", "d" if "d" in fed else "a"))
    for s in fed:
        while fed[s] < K_SESS:
            ops.append(("submit", s, fed[s]))
            fed[s] += 1
        ops.append(("result", s))
    return ops


def _moved_suspended():
    """"moved": MOVED_AT frames on a single-device server, suspended."""
    srv = _server()
    h = srv.attach(MOVED_SEED)
    for k in range(MOVED_AT):
        srv.submit(h, ZS["moved"][k])
    return srv.suspend(h)


def _server(mesh=None, capacity=1):
    return ParticleSessionServer(lg_demo_model(), SIRConfig(**SESS_SIR),
                                 capacity=capacity, mesh=mesh, device="cpu")


def _session_case():
    ops = _session_ops(_moved_suspended())
    # the ranks keep their own snapshot of "a" between ticks 5 and 6:
    # resume it from the suspend op's result (serve_ops keeps snapshots)
    return {"sir": SESS_SIR, "capacity": CAP, "bank_axis": "bank",
            "frames": ZS, "ops": ops}


def _standalone(seed, zs):
    return ParallelParticleFilter(lg_demo_model(), SIRConfig(**SESS_SIR),
                                  device="cpu").run(seed, zs)


# ---------------------------------------------------------------------------
# The spawn
# ---------------------------------------------------------------------------

def _verb_inputs():
    """One input set a line: axis a's line j seeded 10 a + j."""
    return {name: [launch_mesh.verb_inputs(SHAPE[a], seed=10 * a + j)
                   for j in range(WORLD // SHAPE[a])]
            for a, name in enumerate(NAMES)}


@pytest.fixture(scope="module")
def ranks():
    frames = _frames()
    spec = {"axis_shapes": SHAPE, "axis_names": NAMES,
            "verbs": _verb_inputs(),
            "filters": [dict(BASE, frames=frames, **FILTERS[c])
                        for c in FILTERS] + [_ref_case()],
            "sessions": [_session_case()]}
    return launch_mesh.spawn(launch_grid.grid_checks, WORLD, (spec, "cpu"),
                             deadline=240, timeout=60)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} " \
        f"{want.dtype}"
    assert torch.equal(_bits(got), _bits(want)), f"{what} differs"


def test_ranks_sit_row_major(ranks):
    for r, got in enumerate(ranks):
        assert got["rank"] == r and got["coords"] == _coords(r)
        assert got["staged_bytes"] == 0     # host tensors: nothing staged


# ---------------------------------------------------------------------------
# The verbs on each axis's sub-group
# ---------------------------------------------------------------------------

VERBS = ("psum", "psum_int", "pmax", "all_gather", "ppermute_ring",
         "ppermute_partial", "all_to_all", "all_to_all_int", "shard0",
         "from_shard", "axis_index", "gather_shards", "grouped_0",
         "grouped_1", "grouped_a", "grouped_b", "bank_psum",
         "bank_all_gather", "bank_ppermute")


@pytest.mark.parametrize("axis", NAMES)
@pytest.mark.parametrize("verb", VERBS)
def test_axis_verbs_match_the_emulated_line(ranks, axis, verb):
    a = NAMES.index(axis)
    inputs = _verb_inputs()[axis]
    for r, got in enumerate(ranks):
        c = _coords(r)
        line, pos = c[1 - a], c[a]
        want = launch_mesh.verbs(EmulatedMesh(SHAPE[a], axis), inputs[line],
                                 "cpu")[verb]
        assert_same(got["verbs"][axis][verb], want[pos:pos + 1],
                    f"{verb} on {axis} rank {r}")


# ---------------------------------------------------------------------------
# The bank with bank_axis, and the filter on the data axis
# ---------------------------------------------------------------------------

def _assert_outputs(got, want, what):
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert_same(got[f], want[f], f"{what} {f}")
    assert set(got["diag"]) == set(want["diag"])
    for k, v in want["diag"].items():
        assert_same(got["diag"][k], v, f"{what} diag {k}")


@pytest.mark.parametrize("case", [c for c in FILTERS if c.startswith("bank")])
def test_bank_axis_matches_the_emulated_grid(ranks, case):
    spec = dict(BASE, frames=_frames(), **FILTERS[case])
    want = launch_mesh.filter_run(EmulatedGrid(SHAPE, NAMES), spec, "cpu")
    # 5f's rule: the grid's layout gives the bank's bits without it
    flat = launch_mesh.filter_run(EmulatedMesh(SHAPE[1]), dict(
        spec, bank_axis=None), "cpu")
    _assert_outputs(flat, want, f"{case} without bank_axis")
    per = len(BANK) // SHAPE[0]
    i = list(FILTERS).index(case)
    for r, rank in enumerate(ranks):
        b, d = _coords(r)
        got = rank["filters"][i]
        _assert_outputs(got, want, f"{case} rank {r}")
        for f, v in want["final"].items():
            mine = v[b * per:(b + 1) * per]
            assert_same(got["final"][f], mine[:, d:d + 1], f"final {f}")
            assert_same(got["gathered"][f], mine, f"gathered {f}")
    assert bool(torch.isfinite(want["estimates"]).all())


@pytest.mark.parametrize("case", ["rna", "domain-rna"])
def test_filter_on_the_data_axis_matches_the_emulated_mesh(ranks, case):
    spec = dict(BASE, frames=_frames(), **FILTERS[case])
    want = launch_mesh.filter_run(EmulatedMesh(SHAPE[1]), spec, "cpu")
    i = list(FILTERS).index(case)
    for r, rank in enumerate(ranks):
        d = _coords(r)[1]
        got = rank["filters"][i]
        _assert_outputs(got, want, f"{case} rank {r}")
        for f, v in want["final"].items():
            assert_same(got["final"][f], v[d:d + 1], f"final {f}")
            assert_same(got["gathered"][f], v, f"gathered {f}")


def test_bank_axis_matches_the_reference(ranks):
    """Every rank's bank on the reference's replayed draws against the
    reference's sharded bank step (``ref_bank``), at test_torch_bank_mesh's
    tolerances; its final shard the reference's shard."""
    frames, keys = _ref_inputs()
    p = SHAPE[1]
    outs, final = ref_bank(jtracking.TrackingSSM(REF_CFG),
                           RefSIR(n_particles=p * REF_C),
                           jdist.DRAConfig(kind="rna"), keys,
                           jnp.asarray(frames), p)

    def shard0(x):                  # (P, K, B, ...) -> (B, K, ...)
        return np.moveaxis(np.asarray(x)[0], 0, 1)

    for r, rank in enumerate(ranks):
        b, d = _coords(r)
        got = rank["filters"][len(FILTERS)]
        assert got["replay_left"] == 0
        np.testing.assert_allclose(got["estimates"].numpy(),
                                   shard0(outs.estimate), atol=ATOL)
        np.testing.assert_allclose(got["log_marginal"].numpy(),
                                   shard0(outs.log_marginal), atol=ATOL)
        np.testing.assert_allclose(got["ess"].numpy(), shard0(outs.ess),
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["resampled"].numpy(),
                                      shard0(outs.resampled))
        for k, v in got["diag"].items():
            want = shard0(outs.diag[k])
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        # final (P, B, C, ...): member b on data shard d
        np.testing.assert_array_equal(got["final"]["counts"][0, 0].numpy(),
                                      np.asarray(final.counts)[d, b])
        np.testing.assert_allclose(got["final"]["state"][0, 0].numpy(),
                                   np.asarray(final.state)[d, b], atol=1e-4)
        np.testing.assert_allclose(
            got["final"]["log_weights"][0, 0].numpy(),
            np.asarray(final.log_weights)[d, b], atol=ATOL)


# ---------------------------------------------------------------------------
# The session server over the grid
# ---------------------------------------------------------------------------

def _emulated_sessions():
    return launch_grid.session_run(EmulatedGrid(SHAPE, NAMES),
                                   _session_case(), "cpu")


def _assert_session(got, ref, what):
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert_same(got[f], getattr(ref, f), f"{what} {f}")
    for f in ("state", "log_weights", "counts"):
        assert_same(got["final"][f], getattr(ref.final, f),
                    f"{what} final {f}")


def test_sessions_under_churn_match_standalone(ranks):
    """Every session finished on the ranks is bit for bit its standalone
    filter and the emulated grid server's run; one step program, the
    full-capacity tier; ``latest`` the same rows on every rank."""
    emu = _emulated_sessions()
    refs = {s: _standalone(SEEDS[s], ZS[s]) for s in "ade"}
    refs["moved"] = _standalone(MOVED_SEED, ZS["moved"])
    for r, rank in enumerate(ranks):
        got = rank["sessions"][0]
        assert set(got["results"]) == set(refs) == set(emu["results"])
        for s, ref in refs.items():
            _assert_session(got["results"][s], ref, f"rank {r} session {s}")
            _assert_session(emu["results"][s], ref, f"emulated session {s}")
        assert got["step_traces"] == 1 and got["tiers"] == (CAP,)
        assert got["ticks"] == emu["ticks"]
        for s, row in emu["latest"].items():
            for g, w in zip(got["latest"][s], row):
                assert_same(g, w, f"rank {r} latest {s}")


def test_suspend_on_processes_resume_on_one_device(ranks):
    """"b", suspended on the ranks after OUT_AT frames (the same bits on
    every rank), resumes on a single-device server and finishes bit for
    bit its standalone filter."""
    sus = [rank["sessions"][0]["suspended"]["b"] for rank in ranks]
    for other in sus[1:]:
        for f, v in sus[0].as_tree().items():
            np.testing.assert_array_equal(np.asarray(other.as_tree()[f]),
                                          np.asarray(v), err_msg=f)
    assert sus[0].frames_done == OUT_AT
    srv = _server(capacity=2)
    h = srv.resume(sus[0])
    for k in range(OUT_AT, K_SESS):
        srv.submit(h, ZS["b"][k])
    res = srv.result(h)
    ref = _standalone(SEEDS["b"], ZS["b"])
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert_same(getattr(res, f), getattr(ref, f), f)
    for f in ("state", "log_weights", "counts"):
        assert_same(getattr(res.final, f), getattr(ref.final, f), f)


def test_resume_on_processes_from_one_device(ranks):
    """"moved", suspended on a single-device server after MOVED_AT frames,
    resumed on the ranks: its whole history is its standalone filter's."""
    ref = _standalone(MOVED_SEED, ZS["moved"])
    for r, rank in enumerate(ranks):
        got = rank["sessions"][0]["results"]["moved"]
        assert got["estimates"].shape[0] == K_SESS
        _assert_session(got, ref, f"rank {r} moved")


# ---------------------------------------------------------------------------
# Validation on a world-size-1 group
# ---------------------------------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    mesh = launch_mesh.init_process_mesh(
        "gloo", rank=0, world=1, init_method=f"file://{tmp_path}/rdv",
        axis_shapes=(1, 1), axis_names=NAMES)
    yield mesh
    torch.distributed.destroy_process_group()


def test_world_one_grid_validates(world1):
    assert isinstance(world1, ProcessGrid)
    assert world1.shape == {"bank": 1, "data": 1} and world1.coords == (0, 0)
    assert world1.axis("data").shards == 1 and world1.axis("bank").rank == 0
    assert world1.axis("bank").staged is world1.staged
    with pytest.raises(ValueError, match="not in mesh axes"):
        world1.axis("model")
    with pytest.raises(ValueError, match="holds 2 ranks"):
        ProcessGrid("gloo", (2, 1), NAMES)
    with pytest.raises(ValueError, match="pair up"):
        ProcessGrid("gloo", (1, 1), ("a", "a"))
    model = TrackingSSM(TrackingConfig(img_size=IMG))
    with pytest.raises(ValueError, match="not in mesh axes"):
        FilterBank(model, SIRConfig(n_particles=8), device="cpu",
                   mesh=world1, bank_axis="members")
    with pytest.raises(ValueError, match="not in mesh axes"):
        ParallelParticleFilter(model, SIRConfig(n_particles=8), device="cpu",
                               mesh=world1, axis_name="model")
    # a one-rank grid serves as one device, as the reference's one-device
    # mesh does
    assert _server(world1, capacity=2).mesh is None
