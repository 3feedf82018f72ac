"""The process-group backend of the runtime facade (``ProcessMesh``): one
process a shard over gloo on the CPU, held to the emulated mesh bit for
bit and to the reference.

One module-scoped ``launch.mesh.spawn`` of 4 ranks (one intra-op thread
each) runs every filter case below, and another every verb; the worker
functions (``launch.mesh.filter_runs`` and ``launch.mesh.verbs``) live in
``repro_torch.launch``, so the ranks import neither ``jax`` nor this
module.  Every run passes ``device="cpu"``: the workers, like the
port's entry points, take the card otherwise (checked below).  Rank ``r``'s results are compared with shard
``r`` of the same call on ``EmulatedMesh(4)`` in this process.

* The verbs — float and int ``psum``, ``pmax``, ``all_gather``,
  ``ppermute`` along the ring and along a butterfly stage that leaves a
  rank with nothing, ``all_to_all``, ``grouped_ppermute``, the
  collectives behind a member dim, ``shard0``, ``axis_index`` and
  ``gather_shards`` — bit for bit the emulated mesh's, and against the
  reference's collectives under ``jax.vmap`` (``tests/emesh.py``) at
  ``test_torch_distributed.py``'s tolerances: ints exactly, floats at
  rtol = atol = 1e-6.
* ``ParallelParticleFilter(mesh=ProcessMesh)`` bit for bit the emulated
  run on the same seed (estimates, ESS, log-marginals, ``resampled``,
  every diag and comm count, each rank's final shard and the gathered
  ensemble): MPF, RNA, ARNA, RPA with gs, sgs and lgs, butterfly, the
  domain-decomposed RNA and RPA on 2 x 2 tiles, and a 2-member RNA
  ``FilterBank``; 64x64 frames, 4 x 2^10 particles, 8 frames.
* RNA and RPA on every shard's JAX draws replayed (``batch_shape (1,)``
  a rank) against ``emesh.run_filter``, at
  ``test_dra_filter_matches_emulated_reference``'s configs, size (4 x 64
  particles, 32x32, 4 frames) and tolerances (atol 1e-5 on estimates and
  log-marginals, ESS at rtol 1e-5, ints exactly, the final state at
  1e-4).
* ``spawn`` fails within its deadline when a rank raises (the others,
  blocked in a collective, are killed) and when the deadline passes; a
  world-size-1 group in this process: the verbs equal
  ``EmulatedMesh(1)``'s (each rank's ppermute to itself copies),
  ``bank_axis`` over processes raises naming A8b's rest, and a
  transport other than the group's backend is refused.
* ``python -m torch.distributed.run ... -m repro_torch.launch.track``
  (the CLI under torchrun, 2 ranks) writes rank files bit for bit the
  emulated run.
* Without a device, ``track.run``, its CLI and the checks' workers take
  the card and raise without one: none falls back to the host.
"""
import os
import subprocess
import sys
import time

import emesh
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import shard_stream
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import distributed as jdist
from repro.core import runtime as jruntime
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import tracking as jtracking
from repro_torch.core import FilterBank, SIRConfig, runtime
from repro_torch.core.draws import TorchDraws
from repro_torch.core.runtime import EmulatedMesh, ProcessMesh
from repro_torch.data.synthetic_movie import generate_movie
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import track
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
C, FRAMES, IMG = 1024, 8, (64, 64)
TOL = dict(rtol=1e-6, atol=1e-6)
ATOL = 1e-5


def _frames():
    cfg = TrackingConfig(img_size=IMG)
    return generate_movie(TorchDraws.from_seed(0, "cpu"), cfg,
                          n_frames=FRAMES).frames.numpy()


BASE = {"particles": P * C, "key": 11}
CASES = {
    "mpf": {"dra": {"kind": "mpf"}},
    "rna": {"dra": {"kind": "rna"}},
    "arna": {"dra": {"kind": "arna"}},
    "rpa-gs": {"dra": {"kind": "rpa", "scheduler": "gs"}},
    "rpa-sgs": {"dra": {"kind": "rpa", "scheduler": "sgs"}},
    "rpa-lgs": {"dra": {"kind": "rpa", "scheduler": "lgs"}},
    "butterfly": {"dra": {"kind": "butterfly"}},
    "domain-rna": {"dra": {"kind": "rna"}, "domain": True},
    "domain-rpa": {"dra": {"kind": "rpa"}, "domain": True},
    "bank-rna": {"dra": {"kind": "rna"}, "bank": [11, 12], "key": None},
}
# the reference cases: test_dra_filter_matches_emulated_reference's
# configs, movie, key and size.  At 4 x 2^10 over 8 frames the port's and
# the reference's float orders (the comb's CDF, the estimate's sums) part
# by more than its 1e-5 from frame 3 on, on the emulated mesh alike; the
# process mesh is held to the emulated one bit for bit above.
REF_CASES = {"rna": dict(kind="rna"), "rpa": dict(kind="rpa", k_cap=8)}
REF_CFG = jtracking.TrackingConfig(img_size=(32, 32), v_init=1.5)
REF_C, REF_FRAMES, REF_KEY = 64, 4, 7


def _ref_frames():
    return np.array(ref_movie(jax.random.key(0), REF_CFG,
                              n_frames=REF_FRAMES).frames)


def _ref_spec(kind):
    key = jax.random.key(REF_KEY)
    return {"frames": _ref_frames(), "cfg": {"v_init": 1.5},
            "dra": REF_CASES[kind], "particles": P * REF_C,
            "key": [shard_stream(key, i, kind, REF_C, REF_FRAMES)
                    for i in range(P)]}


@pytest.fixture(scope="module")
def ranks():
    """Every filter case on 4 spawned gloo ranks: one list of per-case
    results a rank."""
    frames = _frames()
    specs = [dict(BASE, frames=frames, **CASES[c]) for c in CASES]
    specs += [_ref_spec(k) for k in REF_CASES]
    return launch_mesh.spawn(launch_mesh.filter_runs, P, (specs, "cpu"),
                             deadline=240)


@pytest.fixture(scope="module")
def verb_ranks():
    inputs = launch_mesh.verb_inputs(P)
    return inputs, launch_mesh.spawn(launch_mesh.verbs, P, (inputs, "cpu"),
                                     deadline=120)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} " \
        f"{want.dtype}"
    assert torch.equal(_bits(got), _bits(want)), f"{what} differs"


# ---------------------------------------------------------------------------
# The verbs
# ---------------------------------------------------------------------------

VERBS = ("psum", "psum_int", "pmax", "all_gather", "ppermute_ring",
         "ppermute_partial", "all_to_all", "all_to_all_int", "shard0",
         "axis_index", "gather_shards", "grouped_0", "grouped_1",
         "grouped_a", "grouped_b", "bank_psum", "bank_all_gather",
         "bank_ppermute")


@pytest.mark.parametrize("verb", VERBS)
def test_verbs_match_the_emulated_mesh(verb_ranks, verb):
    inputs, got = verb_ranks
    want = launch_mesh.verbs(EmulatedMesh(P), inputs, "cpu")[verb]
    for r in range(P):
        assert_same(got[r][verb], want[r:r + 1], f"{verb} rank {r}")


def test_partial_ppermute_leaves_a_rank_with_zeros(verb_ranks):
    inputs, got = verb_ranks
    # the last butterfly stage without its pair into shard 1
    assert not got[1]["ppermute_partial"].any()
    assert torch.equal(got[3]["ppermute_partial"][0],
                       torch.from_numpy(inputs["xi"][1]))


def _vmap(fn, *args):
    return jax.jit(jax.vmap(fn, axis_name=emesh.AXIS))(*args)


@pytest.mark.parametrize("verb", ["psum", "psum_int", "pmax", "all_gather",
                                  "ppermute_ring", "all_to_all_int"])
def test_verbs_match_the_reference(verb_ranks, verb):
    inputs, got = verb_ranks
    ring = [(i, (i + 1) % P) for i in range(P)]
    ax = emesh.AXIS
    ref = {"psum": lambda x, xi, b: jruntime.psum(x, ax),
           "psum_int": lambda x, xi, b: jruntime.psum(xi, ax),
           "pmax": lambda x, xi, b: jruntime.pmax(x, ax),
           "all_gather": lambda x, xi, b: jruntime.all_gather(x, ax),
           "ppermute_ring": lambda x, xi, b: jruntime.ppermute(x, ax, ring),
           "all_to_all_int": lambda x, xi, b: jruntime.all_to_all(
               b, ax, 0, 0)}[verb]
    want = np.asarray(_vmap(ref, *(jnp.asarray(inputs[k]) for k in (
        "x", "xi", "iblocks"))))
    for r in range(P):
        g = got[r][verb][0].numpy()
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, want[r], err_msg=verb)
        else:
            np.testing.assert_allclose(g, want[r], **TOL, err_msg=verb)


# ---------------------------------------------------------------------------
# The filter against the emulated mesh
# ---------------------------------------------------------------------------

def _assert_run_matches(got, want, rank, bank):
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert_same(got[f], want[f], f)
    assert set(got["diag"]) == set(want["diag"])
    for k, v in want["diag"].items():
        assert_same(got["diag"][k], v, f"diag {k}")
    d = 1 if bank else 0              # the shard dim of the final ensemble
    for f, v in want["final"].items():
        assert_same(got["final"][f], v.narrow(d, rank, 1), f"final {f}")
        assert_same(got["gathered"][f], v, f"gathered final {f}")


@pytest.mark.parametrize("case", list(CASES))
def test_filter_matches_the_emulated_mesh(ranks, case):
    spec = dict(BASE, frames=_frames(), **CASES[case])
    want = launch_mesh.filter_run(EmulatedMesh(P), spec, "cpu")
    i = list(CASES).index(case)
    for r in range(P):
        got = ranks[r][i]
        _assert_run_matches(got, want, r, spec.get("bank"))
        assert got["staged_bytes"] == 0      # host tensors: nothing staged
    assert bool(torch.isfinite(want["estimates"]).all())


# ---------------------------------------------------------------------------
# The filter against the reference, on replayed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(REF_CASES))
def test_filter_matches_the_reference(ranks, kind):
    key = jax.random.key(REF_KEY)
    outs, final = emesh.run_filter(
        jtracking.TrackingSSM(REF_CFG), RefSIR(n_particles=P * REF_C),
        jdist.DRAConfig(**REF_CASES[kind]), key, jnp.asarray(_ref_frames()),
        P)
    ref_final = jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((P, REF_C) + x.shape[2:]), final)
    i = len(CASES) + list(REF_CASES).index(kind)
    for r in range(P):
        got = ranks[r][i]
        assert got["replay_left"] == 0
        np.testing.assert_allclose(got["estimates"].numpy(),
                                   outs.estimate[0], atol=ATOL)
        np.testing.assert_allclose(got["log_marginal"].numpy(),
                                   outs.log_marginal[0], atol=ATOL)
        np.testing.assert_allclose(got["ess"].numpy(), outs.ess[0],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["resampled"].numpy(),
                                      outs.resampled[0])
        assert set(got["diag"]) == set(outs.diag)
        for k, v in got["diag"].items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(outs.diag[k][0]),
                                          err_msg=k)
        np.testing.assert_array_equal(got["final"]["counts"][0].numpy(),
                                      ref_final.counts[r])
        np.testing.assert_allclose(got["final"]["state"][0].numpy(),
                                   ref_final.state[r], atol=1e-4)
        np.testing.assert_allclose(got["final"]["log_weights"][0].numpy(),
                                   ref_final.log_weights[r], atol=ATOL)


# ---------------------------------------------------------------------------
# Failures, and a world-size-1 group in this process
# ---------------------------------------------------------------------------

def test_a_failed_rank_fails_spawn_before_its_peers_time_out():
    """Ranks 2 and 3 raise on inputs too short for them; ranks 0 and 1
    block in the first collective until ``spawn`` kills them, well
    inside the group's 60 s timeout."""
    inputs = launch_mesh.verb_inputs(P)
    inputs["x"] = inputs["x"][:2]
    start = time.monotonic()
    # the first failure's traceback: the rank's own error, not a peer's
    # closed connection
    with pytest.raises(RuntimeError, match=r"rank [23] of 4 failed[\s\S]*"
                                           r"exceeds dimension size"):
        launch_mesh.spawn(launch_mesh.verbs, P, (inputs, "cpu"),
                          deadline=120, timeout=60)
    assert time.monotonic() - start < 45


def test_spawn_kills_every_rank_at_its_deadline():
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="not done after"):
        launch_mesh.spawn(launch_mesh.verbs, 2,
                          (launch_mesh.verb_inputs(2), "cpu"), deadline=0.5)
    assert time.monotonic() - start < 15


@pytest.fixture
def world1(tmp_path):
    """A world-size-1 gloo group in this process, torn down after."""
    mesh = launch_mesh.init_process_mesh(
        "gloo", rank=0, world=1, init_method=f"file://{tmp_path}/rdv")
    yield mesh
    torch.distributed.destroy_process_group()


def test_world_one_verbs_match_the_one_shard_mesh(world1):
    inputs = launch_mesh.verb_inputs(1)
    got = launch_mesh.verbs(world1, inputs, "cpu")
    want = launch_mesh.verbs(EmulatedMesh(1), inputs, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k], k)
    assert world1.shards == 1 and world1.rank == 0
    assert world1.shape == {"data": 1} and world1.axis("data") is world1


def test_bank_axis_and_other_transports_are_refused(world1):
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    with pytest.raises(NotImplementedError, match="ROADMAP A8b's rest"):
        FilterBank(model, SIRConfig(n_particles=8), device="cpu",
                   mesh=world1, bank_axis="data")
    with pytest.raises(ValueError, match="backend is 'gloo'"):
        ProcessMesh("nccl")
    with pytest.raises(ValueError, match="unknown transport"):
        ProcessMesh("mpi")
    # a view over member dims shares the staging count
    over = world1.over((2,))
    assert over.lead == (2,) and over.staged is world1.staged
    with pytest.raises(ValueError, match="leading dims"):
        runtime.psum(torch.zeros(2, 3), world1)


def test_track_cli_under_torchrun(tmp_path):
    """The CLI on 2 gloo ranks on the CPU: each rank file bit for bit the
    emulated run of the same arguments."""
    frames = _frames()[:3]
    np.save(tmp_path / "movie.npy", frames)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.track",
           "--transport", "gloo", "--device", "cpu", "--dra", "rna", "rpa",
           "--bank", "2", "--particles", "512", "--seed", "3",
           "--movie", str(tmp_path / "movie.npy"),
           "--out", str(tmp_path / "out")]
    subprocess.run(cmd, env=env, check=True, timeout=180,
                   capture_output=True)
    want = {k: track.run(EmulatedMesh(2), frames, k, 512, seed=3,
                         device="cpu") for k in ("rna", "rpa")}
    want["bank-rna"] = track.run(EmulatedMesh(2), frames, "rna", 512,
                                 bank=[3, 4], device="cpu")
    for r in range(2):
        rec = torch.load(tmp_path / "out" / f"rank{r}.pt",
                         weights_only=False)
        assert (rec["rank"], rec["world"], rec["transport"]) == (r, 2, "gloo")
        assert set(rec["runs"]) == set(want)
        for label, w in want.items():
            got = rec["runs"][label]
            for f in ("estimates", "ess", "log_marginal", "resampled"):
                assert_same(got[f], w[f], f"{label} {f}")
            d = 1 if label.startswith("bank") else 0
            for f, v in w["final"].items():
                assert_same(got["final"][f], v.narrow(d, r, 1),
                            f"{label} final {f}")


ENTRY_POINTS = {
    "track.run": lambda tmp: track.run(EmulatedMesh(1), _frames()[:1],
                                       "rna", 64),
    "track.main": lambda tmp: track.main([
        "--transport", "gloo", "--particles", "64",
        "--movie", str(tmp / "movie.npy"), "--out", str(tmp / "out")]),
    "filter_run": lambda tmp: launch_mesh.filter_run(EmulatedMesh(1), {
        "frames": _frames()[:1], "dra": {"kind": "rna"}, "particles": 64,
        "key": 0}),
    "verbs": lambda tmp: launch_mesh.verbs(EmulatedMesh(1),
                                           launch_mesh.verb_inputs(1)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_take_the_card_unless_told(entry, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, SystemExit), match="no CUDA device"):
        ENTRY_POINTS[entry](tmp_path)
    assert not torch.distributed.is_initialized()
