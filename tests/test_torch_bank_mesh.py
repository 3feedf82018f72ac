"""A FilterBank over the emulated mesh (``FilterBank(mesh=..., dra=...)``,
``make_sharded_bank_step``, ``bank_axis``) against the port's standalone
distributed filter and the reference's sharded bank step.

* The collectives with member dims in front of the shard dim give every
  member the bits they give it alone.
* ``FilterBank(mesh=EmulatedMesh(4), dra=d)`` on the port's own RNG:
  member ``i`` equals ``ParallelParticleFilter(mesh=EmulatedMesh(4),
  dra=d).run(keys[i], obs[i])`` bit for bit, for MPF, RNA, ARNA, RPA
  (LGS) and butterfly; ``bank_axis`` on an emulated ``(B, 4)`` bank x
  data grid gives the same bits (and a ``(2, 4)`` grid on the replayed
  draws below).
* The same bank on the reference's draws replayed (member ``i``, shard
  ``s`` takes ``fold_in(keys[i], s)``'s stream) against
  ``repro.core.filters.make_sharded_bank_step``, run by ``ref_bank``
  below: ``jax.vmap`` over shards with the mesh's ``axis_name`` around
  the reference's own vmap over slots (``tests/emesh.py`` does the same
  for one filter).  Estimates and log-marginals at atol 1e-5
  (tests/test_parity.py), ESS at rtol 1e-5, ``resampled``, every
  diagnostic and the final counts exactly, the final state within 1e-4
  (tests/test_torch_distributed.py's rules: the port's comb and the
  reference's build their CDFs in different orders, so a comb point on
  a 1-ulp CDF tie could flip an ancestor; these inputs have none, and
  the test allows none).
* A masked step with one inactive member keeps that member's ensemble
  and its draws frozen bit for bit and emits zeros for it.
* The reference's validation errors, and the converter's ``(B, P·C)`` <->
  ``(B, P, C)`` layout round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_draws as draws_mod
import torch
from test_torch_dra_more import dra_stream
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import distributed as jdist
from repro.core import filters as jfilters
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import (FilterBank, ParallelParticleFilter, SIRConfig,
                              make_sharded_bank_step)
from repro_torch.core import runtime as truntime
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.draws import (BankDraws, ReplayDraws, TorchDraws,
                                    bank_shard_draws)
from repro_torch.core.filters import shard_carry
from repro_torch.core.runtime import EmulatedMesh, make_mesh
from repro_torch.data.synthetic_movie import generate_movie
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

P, C, FRAMES, IMG = 4, 64, 4, 48
AXIS = "data"
ATOL = 1e-5
KINDS = {"mpf": dict(kind="mpf"), "rna": dict(kind="rna"),
         "arna": dict(kind="arna"),
         "rpa": dict(kind="rpa", scheduler="lgs", k_cap=8),
         "butterfly": dict(kind="butterfly", butterfly_cap=8)}


def _movies(b, seed=0):
    cfg = TrackingConfig(img_size=(IMG, IMG), v_init=1.5)
    frames = torch.stack([generate_movie(TorchDraws.from_seed(seed + i,
                                                             "cpu"),
                                         cfg, n_frames=FRAMES).frames
                          for i in range(b)])
    return cfg, frames


# ---------------------------------------------------------------------------
# The collectives behind member dims
# ---------------------------------------------------------------------------

def test_collectives_act_per_member():
    """Each collective on a ``(B, P, ...)`` tensor gives member ``i`` the
    bits it gives ``x[i]`` alone."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, P, 5, 2, generator=g)
    blocks = torch.randn(3, P, P, 2, generator=g)
    alone, bank = EmulatedMesh(P), EmulatedMesh(P).over((3,))
    perm = truntime.ring(alone)[:3]
    for i in range(3):
        for fn in (truntime.psum, truntime.pmax, truntime.all_gather):
            assert torch.equal(fn(x, bank)[i], fn(x[i], alone))
        assert torch.equal(truntime.ppermute(x, bank, perm)[i],
                           truntime.ppermute(x[i], alone, perm))
        assert torch.equal(truntime.all_to_all(blocks, bank)[i],
                           truntime.all_to_all(blocks[i], alone))
    with pytest.raises(ValueError, match="leading dims"):
        truntime.psum(x, alone.over((2,)))


def test_grid_axes():
    grid = make_mesh((2, P), ("bank", AXIS))
    assert grid.shape == {"bank": 2, AXIS: P}
    assert grid.axis(AXIS) == EmulatedMesh(P, AXIS)
    with pytest.raises(ValueError, match="not in mesh axes"):
        grid.axis("model")
    with pytest.raises(ValueError, match="pair up"):
        make_mesh((2, 2), ("a", "a"))


# ---------------------------------------------------------------------------
# Member i == the standalone distributed filter, bank_axis == no bank_axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_member_equals_standalone_filter(kind):
    b = 3
    cfg, frames = _movies(b)
    model, sir = TrackingSSM(cfg), SIRConfig(n_particles=P * C)
    dra = DRAConfig(**KINDS[kind])
    keys = [11, 12, 13]
    res = FilterBank(model, sir, device="cpu", mesh=EmulatedMesh(P),
                     dra=dra).run(keys, frames)
    assert res.final.state.shape == (b, P, C, 5)
    for i in range(b):
        solo = ParallelParticleFilter(model, sir, device="cpu",
                                      mesh=EmulatedMesh(P), dra=dra).run(
            keys[i], frames[i])
        for f in ("estimates", "ess", "log_marginal", "resampled"):
            assert torch.equal(getattr(res, f)[i], getattr(solo, f)), f
        assert set(res.diag) == set(solo.diag)
        for k, v in solo.diag.items():
            assert torch.equal(res.diag[k][i], v), k
        for f in ("state", "log_weights", "counts"):
            assert torch.equal(getattr(res.final, f)[i],
                               getattr(solo.final, f)), f
    grid = make_mesh((b, P), ("bank", AXIS))
    laid = FilterBank(model, sir, device="cpu", mesh=grid, dra=dra,
                      bank_axis="bank").run(keys, frames)
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert torch.equal(getattr(laid, f), getattr(res, f)), f
    for k, v in res.diag.items():
        assert torch.equal(laid.diag[k], v), k
    for f in ("state", "log_weights", "counts"):
        assert torch.equal(getattr(laid.final, f), getattr(res.final, f)), f


# ---------------------------------------------------------------------------
# The reference's sharded bank step on replayed draws
# ---------------------------------------------------------------------------

def ref_bank(model, sir, dra, keys, frames, p):
    """The reference's bank over a ``p``-shard mesh: ``jax.vmap`` over
    shards with ``axis_name`` around ``make_sharded_bank_step`` (itself a
    vmap over slots), every slot active, the carry the reference's
    ``_shard_carry`` vmapped over members.  Returns ``(outs, final)``:
    outputs ``(P, K, B, ...)``, the final ensemble ``(P, B, C, ...)``."""
    step = jfilters.make_sharded_bank_step(model, sir, dra, AXIS)
    n = sir.n_particles
    b, k = frames.shape[:2]

    def per_shard(_):
        carry = jax.vmap(lambda key: jfilters._shard_carry(
            key, model, AXIS, n // p, n))(keys)
        active = jnp.ones((k, b), bool)
        carry, outs = jax.lax.scan(step, carry,
                                   (jnp.moveaxis(frames, 0, 1), active))
        return outs, carry.ensemble

    return jax.jit(jax.vmap(per_shard, axis_name=AXIS))(jnp.arange(p))


@pytest.mark.parametrize("kind", list(KINDS))
def test_bank_matches_reference_sharded_bank_step(kind):
    b = 2
    fields = KINDS[kind]
    jcfg = jtracking.TrackingConfig(img_size=(IMG, IMG), v_init=1.5)
    frames = np.stack([np.array(ref_movie(jax.random.key(i), jcfg,
                                          n_frames=FRAMES).frames)
                       for i in range(b)])
    keys = jax.random.split(jax.random.key(7), b)
    outs, final = ref_bank(jtracking.TrackingSSM(jcfg),
                           RefSIR(n_particles=P * C),
                           jdist.DRAConfig(**fields), keys,
                           jnp.asarray(frames), P)
    def replayed():
        return [BankDraws([ReplayDraws(dra_stream(keys[i], s, fields["kind"],
                                                  C, FRAMES, P))
                           for s in range(P)]) for i in range(b)]

    def bank(**mesh):
        return FilterBank(TrackingSSM(draws_mod.port_config(jcfg)),
                          SIRConfig(n_particles=P * C), device="cpu",
                          dra=DRAConfig(**fields), **mesh)

    members = replayed()
    res = bank(mesh=EmulatedMesh(P)).run(members, frames)
    assert all(r.remaining == 0 for m in members for r in m.members)
    # the (2, 4) bank x data grid with bank_axis: the same bits
    laid = bank(mesh=make_mesh((2, P), ("bank", AXIS)),
                bank_axis="bank").run(replayed(), frames)
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert torch.equal(getattr(laid, f), getattr(res, f)), f
    assert torch.equal(laid.final.state, res.final.state)

    def shard0(x):                  # (P, K, B, ...) -> (B, K, ...)
        return np.moveaxis(np.asarray(x)[0], 0, 1)

    np.testing.assert_allclose(res.estimates.numpy(), shard0(outs.estimate),
                               atol=ATOL)
    np.testing.assert_allclose(res.log_marginal.numpy(),
                               shard0(outs.log_marginal), atol=ATOL)
    np.testing.assert_allclose(res.ess.numpy(), shard0(outs.ess), rtol=1e-5)
    np.testing.assert_array_equal(res.resampled.numpy(),
                                  shard0(outs.resampled))
    assert set(res.diag) == set(outs.diag)
    for k, v in res.diag.items():
        want = shard0(outs.diag[k])
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    # the reference's (B, P·C, ...) global layout, through the converter
    ref_final = convert.bank_shard_ensemble_from_numpy(*(
        np.moveaxis(np.asarray(x), 0, 1).reshape(
            (b, P * C) + np.shape(x)[3:])
        for x in (final.state, final.log_weights, final.counts)), P)
    np.testing.assert_array_equal(res.final.counts.numpy(),
                                  ref_final.counts.numpy())
    np.testing.assert_allclose(res.final.state.numpy(),
                               ref_final.state.numpy(), atol=1e-4)
    np.testing.assert_allclose(res.final.log_weights.numpy(),
                               ref_final.log_weights.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# The masked step: an inactive member stays frozen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rna", "rpa"])
def test_inactive_member_stays_frozen(kind):
    b = 3
    cfg, frames = _movies(b, seed=4)
    model, sir = TrackingSSM(cfg), SIRConfig(n_particles=P * C)
    dra = DRAConfig(**KINDS[kind])
    step = make_sharded_bank_step(model, sir, dra, EmulatedMesh(P))

    def fresh():
        return shard_carry(bank_shard_draws([5, 6, 7], P, "cpu"), model, C,
                           P * C)

    all_on = torch.ones(b, dtype=torch.bool)
    one_off = torch.tensor([True, False, True])
    carry = fresh()
    carry, _ = step(carry, (frames[:, 0], all_on))
    before = carry.ensemble
    gens = [[g.generator.get_state() for g in m.members]
            for m in carry.draws.members]
    carry, out = step(carry, (frames[:, 1], one_off))
    for f in ("state", "log_weights", "counts"):
        assert torch.equal(getattr(carry.ensemble, f)[1],
                           getattr(before, f)[1]), f
    assert all(torch.equal(g.generator.get_state(), s)
               for g, s in zip(carry.draws.members[1].members, gens[1]))
    assert not any(torch.equal(g.generator.get_state(), s)
                   for g, s in zip(carry.draws.members[0].members, gens[0]))
    for x in (out.estimate, out.ess, out.log_marginal, out.resampled,
              *out.diag.values()):
        assert not x[1].any()
    # the active members go on exactly as in a bank with every slot on
    ref = fresh()
    ref, _ = step(ref, (frames[:, 0], all_on))
    ref, ref_out = step(ref, (frames[:, 1], all_on))
    for i in (0, 2):
        assert torch.equal(out.estimate[i], ref_out.estimate[i])
        assert torch.equal(carry.ensemble.state[i], ref.ensemble.state[i])


# ---------------------------------------------------------------------------
# Validation and layout
# ---------------------------------------------------------------------------

def _bank(**kw):
    return FilterBank(TrackingSSM(TrackingConfig(img_size=(16, 16))),
                      SIRConfig(n_particles=kw.pop("n", 8)), device="cpu",
                      **kw)


@pytest.mark.parametrize("case", ["bank_axis", "members", "particles"])
def test_validation_errors(case):
    frames = torch.zeros(3, 2, 16, 16)
    grid = make_mesh((2, 2), ("bank", AXIS))
    if case == "bank_axis":
        with pytest.raises(ValueError, match="not in mesh axes"):
            _bank(mesh=grid, bank_axis="members")
    elif case == "members":
        with pytest.raises(ValueError, match="not divisible by 2 bank"):
            _bank(mesh=grid, bank_axis="bank").run([0, 1, 2], frames)
    else:
        with pytest.raises(ValueError, match="not divisible by 2 shards"):
            _bank(mesh=grid, n=9).run([0, 1, 2], frames)


def test_bank_shard_layout_round_trips():
    """The reference bank's sharded leaves are ``(B, P·C, ...)``, the
    port's ``(B, P, C, ...)``."""
    rng = np.random.default_rng(4)
    state = rng.standard_normal((2, P * 6, 5)).astype(np.float32)
    lw = rng.standard_normal((2, P * 6)).astype(np.float32)
    counts = rng.integers(0, 3, (2, P * 6)).astype(np.int32)
    ens = convert.bank_shard_ensemble_from_numpy(state, lw, counts, P)
    assert ens.state.shape == (2, P, 6, 5)
    assert torch.equal(ens.state[1, 2], torch.from_numpy(state[1, 12:18]))
    for got, want in zip(convert.bank_ensemble_to_numpy(ens),
                         (state, lw, counts)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="do not split"):
        convert.bank_shard_ensemble_from_numpy(state, lw, counts, 5)
