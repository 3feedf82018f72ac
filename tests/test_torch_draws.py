"""The port's draws providers, and the JAX key streams the port's tests
replay.

Torch cannot reproduce JAX's threefry, so the tests take the reference's
numbers from its own key stream — split exactly as ``run_sir``,
``TrackingSSM.init``, the SIR step and ``generate_movie`` split it — and
feed them to the port through ``ReplayDraws``.  The stream functions here
are imported by the other ``test_torch_*`` files (``import
test_torch_draws``, like ``import stats``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_movie as ref_movie
from repro.models import tracking as ref_tracking
from repro_torch.core.draws import BankDraws, ReplayDraws, TorchDraws
from repro_torch.data import synthetic_movie as port_movie
from repro_torch.models import tracking as port_tracking


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU tests share the machine with other test files under xdist;
    one torch intra-op thread per worker keeps them from crowding the
    timing-sensitive asyncio tests of the serving stack.  Imported by
    every ``test_torch_*`` file; results do not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(x, np.float32)


def tracking_init_draws(k_init, n: int) -> list:
    """``TrackingSSM.init``: uniform (n,2), normal (n,2), normal (n,1)."""
    k1, k2, k3 = jax.random.split(k_init, 3)
    return [("uniform", _np(jax.random.uniform(k1, (n, 2)))),
            ("normal", _np(jax.random.normal(k2, (n, 2)))),
            ("normal", _np(jax.random.normal(k3, (n, 1))))]


def normal_init_draws(k_init, n: int, d: int) -> list:
    """An init that takes one ``normal (n, d)`` (``LinearGaussianSSM``)."""
    return [("normal", _np(jax.random.normal(k_init, (n, d))))]


def sir_step_draws(key, n: int, d: int):
    """One SIR step: ``split(key, 3)`` into (carry, dynamics, comb);
    the dynamics take ``normal (n, d)``, the systematic comb
    ``uniform ()``.  Returns ``(next_key, draws)``."""
    key, k_dyn, k_res = jax.random.split(key, 3)
    return key, [("normal", _np(jax.random.normal(k_dyn, (n, d)))),
                 ("uniform", _np(jax.random.uniform(k_res, ())))]


def run_sir_draws(key, n: int, d: int, n_frames: int, init=None) -> list:
    """Every draw of ``run_sir(key, ...)`` in order: ``split(key)`` into
    init and run streams, the init draws, then each frame's step draws.
    ``init(k_init, n)`` defaults to the tracking init."""
    k_init, k_run = jax.random.split(key)
    draws = (init or tracking_init_draws)(k_init, n)
    for _ in range(n_frames):
        k_run, step = sir_step_draws(k_run, n, d)
        draws += step
    return draws


def movie_draws(key, cfg, n_frames: int, n_spots: int = 1) -> list:
    """``generate_movie``: uniform (M,2), uniform (M,2), normal (K,H,W)."""
    k_pos, k_tgt, k_noise = jax.random.split(key, 3)
    h, w = cfg.img_size
    return [("uniform", _np(jax.random.uniform(k_pos, (n_spots, 2)))),
            ("uniform", _np(jax.random.uniform(k_tgt, (n_spots, 2)))),
            ("normal", _np(jax.random.normal(k_noise, (n_frames, h, w))))]


def generate_draws(key, b: int, vocab: int, steps: int) -> list:
    """``serve.engine.generate`` at a temperature: the first token's
    ``gumbel (B, V)`` from ``fold_in(key, 7)``, then one from each
    ``split(key)`` of the decode scan (its last sample is dropped, so
    ``steps - 1`` of them)."""
    draws = [("gumbel", _np(jax.random.gumbel(jax.random.fold_in(key, 7),
                                              (b, vocab))))]
    for _ in range(steps - 1):
        key, k_s = jax.random.split(key)
        draws.append(("gumbel", _np(jax.random.gumbel(k_s, (b, vocab)))))
    return draws


def smc_decode_draws(key, b: int, k: int, vocab: int, steps: int) -> list:
    """``serve.smc_decode`` with the systematic resampler: prompt ``i``
    takes ``split(key, B)[i]``, split into init and run streams; the
    init stream draws the prefill token (``gumbel (K, V)``), each of the
    ``steps - 1`` decode steps splits the run stream into three (carry,
    the proposal's ``gumbel (K, V)``, the comb's ``uniform ()``).
    Returns one draw list per prompt."""
    out = []
    for key_i in jax.random.split(key, b):
        k_init, k_run = jax.random.split(key_i)
        draws = [("gumbel", _np(jax.random.gumbel(k_init, (k, vocab))))]
        for _ in range(steps - 1):
            k_run, k_dyn, k_res = jax.random.split(k_run, 3)
            draws += [("gumbel", _np(jax.random.gumbel(k_dyn, (k, vocab)))),
                      ("uniform", _np(jax.random.uniform(k_res, ())))]
        out.append(draws)
    return out


def port_config(cfg):
    """The port's ``TrackingConfig`` with the reference config's fields."""
    return port_tracking.TrackingConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# The providers
# ---------------------------------------------------------------------------

def test_replay_hands_out_draws_in_order():
    a, b = np.zeros((3, 2), np.float32), np.ones((), np.float32)
    d = ReplayDraws([("normal", a), ("uniform", b)])
    assert torch.equal(d.normal((3, 2)), torch.zeros(3, 2))
    assert float(d.uniform(())) == 1.0
    assert d.remaining == 0
    with pytest.raises(IndexError):
        d.uniform(())


@pytest.mark.parametrize("kind,shape", [("uniform", (3, 2)),
                                        ("normal", (2, 3))])
def test_replay_rejects_wrong_kind_or_shape(kind, shape):
    d = ReplayDraws([("normal", np.zeros((3, 2), np.float32))])
    with pytest.raises(ValueError):
        getattr(d, kind)(shape)


def test_torch_draws_repeat_from_a_seed():
    a, b = TorchDraws.from_seed(3, "cpu"), TorchDraws.from_seed(3, "cpu")
    for _ in range(3):
        assert torch.equal(a.normal((4, 5)), b.normal((4, 5)))
        assert torch.equal(a.uniform(()), b.uniform(()))
        assert torch.equal(a.exponential((7,)), b.exponential((7,)))
    u = a.uniform((1000,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_bank_draws_stack_members_and_freeze_inactive():
    members = [TorchDraws.from_seed(s, "cpu") for s in (1, 2, 3)]
    solo = [TorchDraws.from_seed(s, "cpu") for s in (1, 2, 3)]
    bank = BankDraws(members, active=[True, False, True])
    out = bank.normal((4, 2))
    assert out.shape == (3, 4, 2)
    assert torch.equal(out[0], solo[0].normal((4, 2)))
    assert torch.equal(out[1], torch.zeros(4, 2))
    assert torch.equal(out[2], solo[2].normal((4, 2)))
    # the inactive member's stream did not move
    assert torch.equal(members[1].normal((4, 2)), solo[1].normal((4, 2)))


def test_int_kinds_repeat_and_stack():
    """``randint`` is int32 in ``[0, high)``, ``permutation`` a permutation;
    both repeat from a seed, and an inactive bank member gets int zeros
    (and the identity permutation) without moving its stream."""
    from repro_torch.core.draws import shard_draws, shard_seed
    a, b = TorchDraws.from_seed(5, "cpu"), TorchDraws.from_seed(5, "cpu")
    r = a.randint((40, 8), 13)
    assert r.dtype == torch.int32 and torch.equal(r, b.randint((40, 8), 13))
    assert int(r.min()) >= 0 and int(r.max()) < 13
    p = a.permutation(50)
    assert torch.equal(p, b.permutation(50))
    assert torch.equal(p.sort().values, torch.arange(50))
    bank = BankDraws([TorchDraws.from_seed(s, "cpu") for s in (1, 2)],
                     active=[True, False])
    out = bank.randint((3, 4), 9)
    assert out.dtype == torch.int32 and not out[1].any()
    assert torch.equal(bank.permutation(6)[1], torch.arange(6))
    shards = shard_draws(7, 3, "cpu")
    assert shards.batch_shape == (3,)
    assert len({shard_seed(7, i) for i in range(3)}) == 3
    with pytest.raises(TypeError):
        shard_draws(ReplayDraws([]), 3, "cpu")


def test_gumbel_kind_repeats_stacks_and_has_the_gumbel_mean():
    a, b = TorchDraws.from_seed(6, "cpu"), TorchDraws.from_seed(6, "cpu")
    g = a.gumbel((4000, 50))
    assert g.dtype == torch.float32 and torch.equal(g, b.gumbel((4000, 50)))
    assert bool(torch.isfinite(g).all())
    # E[G] = Euler's gamma, sd pi/sqrt(6) over 200k draws: 5 sigma ~ 0.014
    assert abs(float(g.double().mean()) - 0.5772156649) < 0.015
    bank = BankDraws([TorchDraws.from_seed(s, "cpu") for s in (1, 2)],
                     active=[False, True])
    out = bank.gumbel((3, 5))
    assert out.shape == (2, 3, 5) and not out[0].any()
    assert torch.equal(out[1], TorchDraws.from_seed(2, "cpu").gumbel((3, 5)))


# ---------------------------------------------------------------------------
# The streams reproduce the reference's own draws
# ---------------------------------------------------------------------------

def test_replayed_gumbel_is_jax_categorical():
    """``jax.random.categorical(key, logits)`` is
    ``argmax(jax.random.gumbel(key, logits.shape) + logits)``: the port's
    argmax over the replayed noise draws the reference's tokens."""
    key = jax.random.key(12)
    logits = jax.random.normal(jax.random.key(13), (64, 300)) * 3.0
    want = jax.random.categorical(key, logits, axis=-1)
    noise = ReplayDraws([("gumbel", _np(jax.random.gumbel(key, (64, 300))))])
    got = (noise.gumbel((64, 300)) + torch.tensor(_np(logits))).argmax(-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_reproduces_tracking_init():
    cfg = ref_tracking.TrackingConfig(img_size=(40, 56))
    k_init = jax.random.key(4)
    want = ref_tracking.TrackingSSM(cfg).init(k_init, 257)
    got = port_tracking.TrackingSSM(port_config(cfg)).init(
        ReplayDraws(tracking_init_draws(k_init, 257)), 257)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_stream_reproduces_tracking_transition():
    cfg = ref_tracking.TrackingConfig(img_size=(40, 56))
    key = jax.random.key(8)
    state = ref_tracking.TrackingSSM(cfg).init(jax.random.key(9), 300)
    _, step = sir_step_draws(key, 300, 5)
    _, k_dyn, _ = jax.random.split(key, 3)
    want = ref_tracking.TrackingSSM(cfg).transition_sample(k_dyn, state)
    got = port_tracking.TrackingSSM(port_config(cfg)).transition_sample(
        ReplayDraws(step[:1]), torch.from_numpy(np.array(state)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_stream_reproduces_generate_movie():
    cfg = ref_tracking.TrackingConfig(img_size=(48, 40), v_init=1.5)
    key = jax.random.key(2)
    want = ref_movie.generate_movie(key, cfg, n_frames=7, n_spots=2)
    got = port_movie.generate_movie(
        ReplayDraws(movie_draws(key, cfg, 7, 2)), port_config(cfg),
        n_frames=7, n_spots=2)
    np.testing.assert_allclose(got.trajectories.numpy(),
                               np.asarray(want.trajectories), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got.frames.numpy(), np.asarray(want.frames),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.intensities.numpy(),
                                  np.asarray(want.intensities))


def test_stream_covers_every_run_sir_draw():
    """The stream holds exactly the draws a port ``run_sir`` takes: the
    replay ends empty, with no draw left over or missing."""
    from repro_torch.core import SIRConfig, run_sir
    cfg = ref_tracking.TrackingConfig(img_size=(32, 32))
    pcfg = port_config(cfg)
    frames = torch.from_numpy(np.array(ref_movie.generate_movie(
        jax.random.key(0), cfg, n_frames=3).frames))
    for backend in ("composed", "fused"):
        draws = ReplayDraws(run_sir_draws(jax.random.key(1), 64, 5, 3))
        run_sir(draws, port_tracking.TrackingSSM(pcfg),
                SIRConfig(n_particles=64, step_backend=backend), frames)
        assert draws.remaining == 0, backend


def test_reference_split_convention_is_what_the_streams_assume():
    """``run_sir`` splits the key once into (init, run) and each step
    splits the run key into three — pinned on the reference itself by
    replaying a closure model that records the keys it is handed."""
    from repro.core import SIRConfig as RefSIR
    from repro.core.smc import StateSpaceModel, run_sir as ref_run_sir
    n = 16

    def init_sampler(key, n):
        return jax.random.normal(key, (n, 1))

    def dynamics(key, state):
        return state + jax.random.normal(key, state.shape)

    model = StateSpaceModel(init_sampler, dynamics,
                            lambda s, z: -0.5 * (s[:, 0] - z) ** 2,
                            state_dim=1)
    key = jax.random.key(5)
    carry, _ = ref_run_sir(key, model, RefSIR(n_particles=n),
                           jnp.zeros((2,)))
    draws = run_sir_draws(key, n, 1, 2,
                          init=lambda k, n: normal_init_draws(k, n, 1))
    # the replayed init draw is the reference's initial cloud
    k_init, _ = jax.random.split(key)
    np.testing.assert_array_equal(draws[0][1],
                                  np.asarray(init_sampler(k_init, n)))
    assert len(draws) == 1 + 2 * 2
    assert np.isfinite(np.asarray(carry.ensemble.state)).all()
