"""The port's input-space domain decomposition (``repro_torch.core.domain``
and its tracking hooks) against the reference and against the port's own
replicated-frame filter.

* **Exact** against ``repro.core.domain``: ``DomainSpec`` geometry and
  ``for_mesh`` over a grid of frames and tile counts, with its
  validation errors; ``owner_of`` on random, edge and out-of-frame
  positions; ``extract_slab``/``tile_frames``; ``migration_plan``; the
  migration's windows (slots, units), merged ensemble and
  ``mig_moved``/``mig_overflow``, the reference's per-shard program
  running under ``jax.vmap`` with an ``axis_name``.
* **Bit for bit within the port**: the tile likelihood of owned
  particles against the full frame's; the per-member-geometry plain
  version and kernel emulation against per-member loops of the
  shared-geometry calls; the domain filter against the replicated filter
  (MPF, RNA, ARNA, RPA, butterfly), with pre-tiled observations too.
* **Within the reference's tolerances**: ``exchange_log_likelihood``
  against the reference's (``PATCH_TOL``, the reference's kernel bound);
  the domain filter against the live JAX domain filter — a ``jax.vmap``
  over the tiled ``(K, P, sh, sw)`` stack, every shard's draws replayed —
  at atol 1e-5 on estimates and log-marginals (tests/test_parity.py),
  ``mig_moved``/``mig_overflow`` and the other integers exact.  The
  reference's 1-device goldens are stale (ROADMAP C1), so nothing here
  reads ``tests/golden``.
* Conservation and overflow residency (ports of ``tests/test_domain.py``'s
  properties, fixed seeds) and the filter's validation errors.
"""
import dataclasses

import emesh
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_draws as draws_mod
import torch
from test_torch_dra_more import assert_filter_matches, replayed
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.core import distributed as jdist
from repro.core import domain as jdomain
from repro.core import filters as jfilters
from repro.core import particles as jparticles
from repro.core import smc as jsmc
from repro.data.synthetic_movie import generate_movie as ref_movie
from repro.data.synthetic_movie import tile_shard_frames as ref_tile_shard
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import ParallelParticleFilter, SIRConfig, smc
from repro_torch.core import domain as tdomain
from repro_torch.core import particles as tparticles
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.domain import DomainSpec
from repro_torch.core.draws import TorchDraws
from repro_torch.core.runtime import EmulatedMesh
from repro_torch.data.synthetic_movie import generate_movie, tile_shard_frames
from repro_torch.kernels import patch_likelihood as tpatch
from repro_torch.kernels import ref as tref
from repro_torch.models.ssm import LinearGaussianSSM
from repro_torch.models.tracking import (TrackingConfig, TrackingSSM,
                                         make_domain_spec,
                                         patch_log_likelihood,
                                         tile_patch_log_likelihood)

PATCH_TOL = 3e-5
ATOL = 1e-5


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def _vmap(fn, *args):
    return jax.jit(jax.vmap(fn, axis_name=emesh.AXIS))(*args)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

FRAMES_SHAPES = [(48, 48), (64, 64), (48, 64), (24, 36), (512, 512), (7, 7)]


@pytest.mark.parametrize("frame", FRAMES_SHAPES)
def test_domain_spec_geometry_matches_reference(frame):
    """``for_mesh``'s grid (the squarest, ties to the fewest rows), every
    derived extent, byte count and per-tile origin, or the same refusal,
    over tile counts 1-16."""
    for tiles in (1, 2, 3, 4, 6, 8, 9, 12, 16):
        for halo in (0, 2, 3):
            try:
                want = jdomain.DomainSpec.for_mesh(frame, tiles, halo,
                                                   k_cap=7)
            except ValueError:
                with pytest.raises(ValueError):
                    DomainSpec.for_mesh(frame, tiles, halo, k_cap=7)
                continue
            got = DomainSpec.for_mesh(frame, tiles, halo, k_cap=7)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert (got.tiles, got.tile_shape, got.slab_shape) == (
                want.tiles, want.tile_shape, want.slab_shape)
            assert (got.frame_bytes(), got.slab_bytes(2)) == (
                want.frame_bytes(), want.slab_bytes(2))
            for t in range(got.tiles):
                assert got.tile_origin(t) == tuple(
                    int(v) for v in want.tile_origin(t))
                assert got.slab_origins()[t] == tuple(
                    int(v) for v in want.slab_origin(t))
            assert convert.domain_spec(dataclasses.asdict(want)) == got


@pytest.mark.parametrize("fields", [
    dict(frame_shape=(48, 48), grid=(5, 2), halo=4),
    dict(frame_shape=(48, 48), grid=(0, 2), halo=4),
    dict(frame_shape=(48, 48), grid=(2, 2), halo=-1),
    dict(frame_shape=(16, 48), grid=(2, 2), halo=8)])
def test_domain_spec_validation_matches_reference(fields):
    with pytest.raises(ValueError):
        jdomain.DomainSpec(**fields)
    with pytest.raises(ValueError):
        DomainSpec(**fields)


def test_domain_spec_at_the_chip_shape():
    """512x512 over 8 shards: a 2 x 4 grid of 256 x 128 tiles, 264 x 136
    slabs of 143,616 bytes against a 1,048,576-byte frame."""
    spec = make_domain_spec(TrackingConfig(), 8)
    assert spec.grid == (2, 4) and spec.slab_shape == (264, 136)
    assert (spec.slab_bytes(), spec.frame_bytes()) == (143616, 1048576)
    assert spec.slab_origins()[5] == (252, 124)


def _positions(seed, n, h, w):
    rng = np.random.default_rng(seed)
    y = rng.random(n) * (h + 10) - 5
    x = rng.random(n) * (w + 10) - 5
    edges_y = [0.0, 0.49, 0.5, 3.5, 3.99, 4.5, h - 1.0, h - 4.5, h / 2 - 0.5,
               h / 2 + 0.5, -3.0, h + 2.0]
    edges_x = [0.0, w - 1.0, 1.5, w - 4.5, w / 4 - 0.5, w / 4 + 0.5, 4.5,
               w / 2 + 0.49, 0.7, 63.5, w + 3.0, -2.5]
    y[:12], x[:12] = edges_y, edges_x
    return y.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("frame,tiles,halo", [((48, 64), 8, 4),
                                              ((64, 64), 4, 4),
                                              ((24, 36), 6, 3),
                                              ((32, 32), 1, 2)])
def test_owner_of_matches_reference(frame, tiles, halo):
    spec = DomainSpec.for_mesh(frame, tiles, halo)
    want_spec = jdomain.DomainSpec.for_mesh(frame, tiles, halo)
    y, x = _positions(tiles, 600, *frame)
    want = np.asarray(jdomain.owner_of(want_spec, jnp.asarray(y),
                                       jnp.asarray(x)))
    got = tdomain.owner_of(spec, _t(y), _t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((want >= 0) & (want < tiles)).all()


@pytest.mark.parametrize("frame,tiles,halo", [((48, 64), 8, 4),
                                              ((24, 36), 6, 3)])
def test_slabs_match_reference(frame, tiles, halo):
    spec = DomainSpec.for_mesh(frame, tiles, halo)
    want_spec = jdomain.DomainSpec.for_mesh(frame, tiles, halo)
    frames = np.random.default_rng(1).standard_normal(
        (3,) + frame).astype(np.float32)
    want = np.asarray(jdomain.tile_frames(want_spec, jnp.asarray(frames)))
    got = tdomain.tile_frames(spec, _t(frames))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tile_shard_frames(_t(frames), spec).numpy(),
        np.asarray(ref_tile_shard(jnp.asarray(frames), want_spec)))
    for t in range(tiles):
        np.testing.assert_array_equal(
            tdomain.extract_slab(spec, _t(frames[1]), t).numpy(),
            np.asarray(jdomain.extract_slab(want_spec,
                                            jnp.asarray(frames[1]), t)))
    with pytest.raises(ValueError, match="frames"):
        tdomain.tile_frames(spec, _t(frames[:, :-1]))


# ---------------------------------------------------------------------------
# Migration against the reference's per-shard program
# ---------------------------------------------------------------------------

def _shard_ensembles(seed, spec, p, c, dead=0.15):
    """Per-shard ensembles over the frame (and a little past its edges),
    a fraction dead, each log-weight a function of its particle's state
    (so a weight that leaves its particle shows)."""
    h, w = spec.frame_shape
    rng = np.random.default_rng(seed)
    state = np.zeros((p, c, 5), np.float32)
    state[..., 0] = rng.random((p, c)) * (h + 2) - 1
    state[..., 1] = rng.random((p, c)) * (w + 2) - 1
    state[..., 2] = rng.standard_normal((p, c))
    state[..., 4] = rng.random((p, c)) * 3
    lw = (-0.1 * state[..., 0] - 0.03 * state[..., 1]).astype(np.float32)
    is_dead = rng.random((p, c)) < dead
    lw[is_dead] = -np.inf
    counts = np.where(is_dead, 0, 1).astype(np.int32)
    return state, lw, counts


def _port_ens(state, lw, counts):
    return tparticles.ParticleEnsemble(_t(state), _t(lw),
                                       _t(counts, np.int32))


@pytest.mark.parametrize("p", [4, 8])
def test_migration_plan_matches_reference(p):
    spec = DomainSpec.for_mesh((64, 64), p, 4)
    want_spec = jdomain.DomainSpec.for_mesh((64, 64), p, 4)
    state, lw, counts = _shard_ensembles(p, spec, p, 256)

    def shard(s, l, c_, my):
        return jdomain.migration_plan(
            want_spec, jparticles.ParticleEnsemble(s, l, c_), s[:, 0:2], my)

    want = _vmap(shard, jnp.asarray(state), jnp.asarray(lw),
                 jnp.asarray(counts), jnp.arange(p))
    got = tdomain.migration_plan(spec, _port_ens(state, lw, counts),
                                 _t(state[..., 0:2]), torch.arange(p))
    for f in tdomain.MigrationPlan._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # dead slots stay home, and nobody ships to itself
    home = torch.arange(p)[:, None].expand(p, 256)
    assert torch.equal(got.owner[counts == 0].long(),
                       home[counts == 0])
    assert not got.row_send.diagonal().any()


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("k_cap", [None, 4, 24])
def test_migration_matches_reference(p, k_cap):
    """The migration's windows (slots, units, overflow), the merged
    compressed ensemble and the diagnostics, exactly."""
    c = 256
    spec = DomainSpec.for_mesh((64, 64), p, 4, k_cap=k_cap)
    want_spec = jdomain.DomainSpec.for_mesh((64, 64), p, 4, k_cap=k_cap)
    state, lw, counts = _shard_ensembles(10 + p, spec, p, c)

    def shard(s, l, c_):
        ens = jparticles.ParticleEnsemble(s, l, c_)
        plan, route, merged, diag = jdomain._migrate_route(
            want_spec, ens, s[:, 0:2], axis_name=emesh.AXIS)
        return route.send_slots, route.send_units, route.overflow_units, \
            route.kept_counts, merged, diag

    want = _vmap(shard, jnp.asarray(state), jnp.asarray(lw),
                 jnp.asarray(counts))
    mesh = EmulatedMesh(p)
    plan, route, merged, diag = tdomain._migrate_route(
        spec, _port_ens(state, lw, counts), _t(state[..., 0:2]), mesh)
    got = (route.send_slots, route.send_units, route.overflow_units,
           route.kept_counts)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f in ("state", "log_weights", "counts"):
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(want[4], f)))
    for k in ("mig_moved", "mig_overflow"):
        assert int(diag[k]) == int(np.asarray(want[5][k])[0]), k
    merged2, diag2 = tdomain.migrate(spec, _port_ens(state, lw, counts),
                                     _t(state[..., 0:2]), mesh=mesh)
    assert torch.equal(merged2.counts, merged.counts)
    assert {k: int(v) for k, v in diag2.items()} == {
        k: int(v) for k, v in diag.items()}


def _conserves(spec, p, c, seed, dead, k_cap):
    """Migrate and check: the logical size is conserved, every live
    replica keeps its own log-weight, and without overflow every live
    unit sits on its owner.  Returns the overflow."""
    state, lw, counts = _shard_ensembles(seed, spec, p, c, dead)
    spec = dataclasses.replace(spec, k_cap=k_cap)
    merged, diag = tdomain.migrate(spec, _port_ens(state, lw, counts),
                                   _t(state[..., 0:2]), mesh=EmulatedMesh(p))
    assert int(tparticles.logical_size(merged).sum()) == int(counts.sum())
    m_state = merged.state.numpy()
    m_lw = merged.log_weights.numpy()
    live = np.isfinite(m_lw) & (merged.counts.numpy() > 0)
    want = -0.1 * m_state[..., 0] - 0.03 * m_state[..., 1]
    assert np.abs(np.where(live, m_lw - want, 0.0)).max() < 1e-6
    overflow = int(diag["mig_overflow"])
    if overflow == 0:
        own = tdomain.owner_of(spec, merged.state[..., 0],
                               merged.state[..., 1]).numpy()
        shard = np.arange(p)[:, None]
        assert (np.where(live, own, shard) == shard).all()
    return overflow


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_migration_conserves_size_and_weights(seed):
    spec = DomainSpec.for_mesh((48, 48), 8, 4)
    assert _conserves(spec, 8, 64, seed, 0.15, None) == 0


@pytest.mark.parametrize("seed,k_cap,dead", [(99, 4, 0.0), (5, 2, 0.3),
                                             (7, 9, 0.6)])
def test_migration_overflow_residency_still_conserves(seed, k_cap, dead):
    """Small windows overflow; the residue stays on its sender, and the
    logical size and weights are still conserved."""
    spec = DomainSpec.for_mesh((48, 48), 8, 4)
    overflow = _conserves(spec, 8, 64, seed, dead, k_cap)
    if dead == 0.0:
        assert overflow > 0


# ---------------------------------------------------------------------------
# The tile likelihood and the exchange
# ---------------------------------------------------------------------------

def _tile_case(seed, frame=(48, 64), tiles=8, n=400):
    cfg = TrackingConfig(img_size=frame)
    spec = make_domain_spec(cfg, tiles)
    rng = np.random.default_rng(seed)
    image = rng.standard_normal(frame).astype(np.float32)
    y, x = _positions(seed, n, frame[0] - 1, frame[1] - 1)
    state = np.zeros((n, 5), np.float32)
    state[:, 0], state[:, 1] = np.clip(y, 0, frame[0] - 1), np.clip(
        x, 0, frame[1] - 1)
    state[:, 4] = rng.random(n) * 3
    return cfg, spec, image, state


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_likelihood_bitwise_equals_full_frame(seed):
    """For every particle its tile owns, the tile likelihood on the
    owner's slab — one slab at a time, and all slabs in one batched call
    with the per-member geometry — is the full frame's, bit for bit."""
    cfg, spec, image, state = _tile_case(seed)
    full = patch_log_likelihood(_t(state), _t(image), cfg)
    owner = tdomain.owner_of(spec, _t(state[:, 0]), _t(state[:, 1]))
    slabs = tdomain.tile_frames(spec, _t(image)[None])[0]
    batched = tile_patch_log_likelihood(
        _t(state)[None].expand(spec.tiles, -1, -1).contiguous(), slabs,
        spec.slab_origins(), cfg)
    for t in range(spec.tiles):
        one = tile_patch_log_likelihood(_t(state), slabs[t],
                                        spec.slab_origin(t), cfg)
        mask = owner == t
        assert bool(mask.any())
        assert torch.equal(one[mask], full[mask])
        assert torch.equal(batched[t][mask], full[mask])
        assert torch.equal(batched[t], one)


def _geometry_rows(spec, cfg):
    return [(max(cfg.patch_radius, oy + cfg.patch_radius),
             min(cfg.img_size[0] - 1 - cfg.patch_radius,
                 oy + spec.slab_shape[0] - 1 - cfg.patch_radius),
             max(cfg.patch_radius, ox + cfg.patch_radius),
             min(cfg.img_size[1] - 1 - cfg.patch_radius,
                 ox + spec.slab_shape[1] - 1 - cfg.patch_radius), oy, ox)
            for oy, ox in spec.slab_origins()]


@pytest.mark.parametrize("matched", [True, False])
@pytest.mark.parametrize("fn", ["ref", "emulated"])
def test_per_member_geometry_equals_per_member_loop(fn, matched):
    """The plain version and the kernel emulation with a ``(B, 6)``
    geometry table equal, bit for bit, a loop over the members of the
    same function with each member's geometry as ``center_bounds`` /
    ``frame_origin`` — particles clamped into foreign slabs included."""
    cfg, spec, image, state = _tile_case(4, n=130)
    slabs = tdomain.tile_frames(spec, _t(image)[None])[0]
    rows = _geometry_rows(spec, cfg)
    table = tpatch.member_geometry(rows, cfg.patch_radius,
                                   *spec.slab_shape, "cpu")
    assert table.dtype == torch.int32 and table.shape == (spec.tiles, 6)
    call = (tref.patch_log_likelihood_ref if fn == "ref"
            else tpatch.patch_log_likelihood_emulated)
    st = _t(state)[None].expand(spec.tiles, -1, -1)
    kw = dict(radius=cfg.patch_radius, matched=matched, i_bg=0.25)
    got = call(st[..., 0], st[..., 1], st[..., 4], slabs, geometry=table,
               **kw)
    for t, row in enumerate(rows):
        want = call(st[t, :, 0], st[t, :, 1], st[t, :, 4], slabs[t],
                    center_bounds=row[:4], frame_origin=row[4:], **kw)
        assert torch.equal(got[t], want)


def test_per_member_emulation_matches_reference_within_tol():
    """The kernel emulation with per-member geometry against the live
    JAX reference on each slab, at PATCH_TOL."""
    cfg, spec, image, state = _tile_case(6, n=200)
    jcfg = jtracking.TrackingConfig(img_size=cfg.img_size)
    slabs = tdomain.tile_frames(spec, _t(image)[None])[0]
    table = tpatch.member_geometry(_geometry_rows(spec, cfg),
                                   cfg.patch_radius, *spec.slab_shape, "cpu")
    st = _t(state)[None].expand(spec.tiles, -1, -1)
    got = tpatch.patch_log_likelihood_emulated(
        st[..., 0], st[..., 1], st[..., 4], slabs, geometry=table)
    for t in range(spec.tiles):
        want = np.asarray(jtracking.tile_patch_log_likelihood(
            jnp.asarray(state), jnp.asarray(slabs[t].numpy()),
            spec.slab_origin(t), jcfg))
        np.testing.assert_allclose(got[t].numpy(), want, rtol=PATCH_TOL,
                                   atol=PATCH_TOL)


def test_geometry_tables_are_checked():
    """A row that lets a window leave the slab is refused where the table
    is made, a table beside a shared geometry is refused, and the CUDA
    wrapper takes no CPU tensor."""
    with pytest.raises(ValueError, match="leave"):
        tpatch.member_geometry([(4, 40, 4, 20, 0, 0)], 4, 40, 24, "cpu")
    with pytest.raises(ValueError, match="leave"):
        tpatch.check_geometry((3, 10, 4, 10, 0, 0), 4, 40, 24)
    ok = tpatch.member_geometry([(4, 31, 4, 15, 0, 0)], 4, 40, 24, "cpu")
    assert ok.tolist() == [[4, 31, 4, 15, 0, 0]]
    with pytest.raises(ValueError, match="not both"):
        tref.patch_log_likelihood_ref(
            torch.zeros(1, 3), torch.zeros(1, 3), torch.zeros(1, 3),
            torch.zeros(1, 40, 24), geometry=ok, frame_origin=(0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tpatch.patch_log_likelihood_kernel(torch.zeros(1, 3, 5),
                                           torch.zeros(1, 40, 24),
                                           geometry=ok)


@pytest.mark.parametrize("p,k_cap", [(4, None), (8, None), (8, 6)])
def test_exchange_log_likelihood_matches_reference(p, k_cap):
    """Migrate, reweight against the owners' slabs, return: the port's
    home-slot likelihoods against the reference's at PATCH_TOL, and on
    every live slot bit for bit the port's full-frame likelihood when
    nothing overflows."""
    cfg = TrackingConfig(img_size=(64, 64))
    jcfg = jtracking.TrackingConfig(img_size=(64, 64))
    spec = make_domain_spec(cfg, p, k_cap=k_cap)
    want_spec = jtracking.make_domain_spec(jcfg, p, k_cap=k_cap)
    state, lw, counts = _shard_ensembles(20 + p, spec, p, 128)
    state[..., 0:2] = np.clip(state[..., 0:2], 0, 63)
    image = np.random.default_rng(p).standard_normal((64, 64)).astype(
        np.float32)
    slabs = tdomain.tile_frames(spec, _t(image)[None])[0]

    def shard(s, l, c_, slab):
        origin = want_spec.slab_origin(jax.lax.axis_index(emesh.AXIS))
        return jdomain.exchange_log_likelihood(
            want_spec, jparticles.ParticleEnsemble(s, l, c_), s[:, 0:2],
            lambda st: jtracking.tile_patch_log_likelihood(st, slab, origin,
                                                           jcfg),
            axis_name=emesh.AXIS)

    want_ll, want_diag = _vmap(shard, jnp.asarray(state), jnp.asarray(lw),
                               jnp.asarray(counts), jnp.asarray(
                                   slabs.numpy()))
    model = TrackingSSM(cfg)
    ll, diag = tdomain.exchange_log_likelihood(
        spec, _port_ens(state, lw, counts), _t(state[..., 0:2]),
        lambda st: model.tile_observation_log_prob(st, slabs,
                                                   spec.slab_origins()),
        mesh=EmulatedMesh(p))
    live = counts > 0
    np.testing.assert_allclose(ll.numpy()[live], np.asarray(want_ll)[live],
                               rtol=PATCH_TOL, atol=PATCH_TOL)
    for k in ("mig_moved", "mig_overflow"):
        assert int(diag[k]) == int(np.asarray(want_diag[k])[0]), k
    if int(diag["mig_overflow"]) == 0:
        full = model.observation_log_prob(_t(state), _t(image))
        assert torch.equal(ll[torch.from_numpy(live)],
                           full[torch.from_numpy(live)])
    else:
        assert k_cap is not None


def test_scatter_returned_ll_writes_each_slot_once():
    """Shipped slots take their owner's value, padding entries (0 units)
    change nothing, and the home layout comes back through ``order``."""
    ll_local = torch.arange(6, dtype=torch.float32)[None] * 10
    ll_back = torch.tensor([[[100.0, 101.0, 102.0], [200.0, 201.0, 202.0]]])
    slots = torch.tensor([[[1, 5, 5], [3, 5, 5]]], dtype=torch.int32)
    units = torch.tensor([[[1, 0, 0], [1, 1, 0]]], dtype=torch.int32)
    order = torch.tensor([[2, 0, 1, 3, 5, 4]])
    ll = tdomain.scatter_returned_ll(ll_local, ll_back.reshape(1, 2, 3),
                                     slots, units, order)
    routed = torch.tensor([0.0, 100.0, 20.0, 200.0, 40.0, 201.0])
    want = torch.empty(6)
    want[order[0]] = routed
    assert torch.equal(ll[0], want)


# ---------------------------------------------------------------------------
# The domain filter
# ---------------------------------------------------------------------------

DRAS = {"mpf": dict(kind="mpf"), "rna": dict(kind="rna"),
        "arna": dict(kind="arna"), "rpa": dict(kind="rpa", k_cap=8),
        "butterfly": dict(kind="butterfly", butterfly_cap=8)}


def _movie(frames=5, img=64):
    cfg = TrackingConfig(img_size=(img, img), v_init=1.5)
    return cfg, generate_movie(TorchDraws.from_seed(0, "cpu"), cfg,
                               n_frames=frames)


@pytest.mark.parametrize("kind", list(DRAS))
def test_domain_filter_equals_replicated_filter(kind):
    """Bit for bit: estimates, ESS, log-marginals, decisions, every DRA
    diagnostic and the final ensemble; full frames and the pre-tiled
    stack give the same run; nothing overflows at ``k_cap=None``."""
    cfg, movie = _movie()
    p = 4
    sir = SIRConfig(n_particles=p * 256)
    kw = dict(device="cpu", mesh=EmulatedMesh(p), dra=DRAConfig(**DRAS[kind]))
    rep = ParallelParticleFilter(TrackingSSM(cfg), sir, **kw).run(
        3, movie.frames)
    spec = make_domain_spec(cfg, p)
    pf = ParallelParticleFilter(TrackingSSM(cfg), sir, domain=spec, **kw)
    dom = pf.run(3, movie.frames)
    for f in ("estimates", "ess", "log_marginal", "resampled"):
        assert torch.equal(getattr(dom, f), getattr(rep, f)), f
    for f in ("state", "log_weights", "counts"):
        assert torch.equal(getattr(dom.final, f), getattr(rep.final, f)), f
    assert set(dom.diag) == set(rep.diag) | {"mig_moved", "mig_overflow"}
    for k, v in rep.diag.items():
        assert torch.equal(dom.diag[k], v), k
    assert not dom.diag["mig_overflow"].any()
    assert bool((dom.diag["mig_moved"] > 0).all())
    again = pf.run(3, tile_shard_frames(movie.frames, spec))
    assert torch.equal(again.estimates, dom.estimates)


def ref_domain_filter(model, sir, dra, spec, key, tiled, p):
    """The reference's domain-decomposed filter on an emulated ``p``-shard
    mesh: ``make_distributed_sir_step(domain=spec)`` and ``_shard_carry``
    scanned over each shard's ``(K, sh, sw)`` slabs, under ``jax.vmap``
    with an ``axis_name`` over the tiled ``(K, P, sh, sw)`` stack (the
    ``shard_map`` of ``ParallelParticleFilter._run_sharded``)."""
    step = jsmc.make_distributed_sir_step(model, sir, dra, emesh.AXIS,
                                          domain=spec)
    n = sir.n_particles

    def per_shard(obs):
        carry = jfilters._shard_carry(key, model, emesh.AXIS, n // p, n)
        carry, outs = jax.lax.scan(step, carry, obs)
        return outs, carry.ensemble

    return jax.jit(jax.vmap(per_shard, axis_name=emesh.AXIS))(
        jnp.moveaxis(tiled, 1, 0))


@pytest.mark.parametrize("kind,p,k_cap", [("mpf", 4, None), ("rna", 4, None),
                                          ("rpa", 4, None), ("rna", 8, None),
                                          ("rna", 4, 16)])
def test_domain_filter_matches_jax_domain_filter(kind, p, k_cap):
    fields = DRAS[kind]
    c, n_frames = 64, 4
    jcfg = jtracking.TrackingConfig(img_size=(64, 64), v_init=1.5)
    frames = np.array(ref_movie(jax.random.key(0), jcfg,
                                n_frames=n_frames).frames)
    want_spec = jtracking.make_domain_spec(jcfg, p, k_cap=k_cap)
    key = jax.random.key(7)
    outs, final = ref_domain_filter(
        jtracking.TrackingSSM(jcfg), RefSIR(n_particles=p * c),
        jdist.DRAConfig(**fields), want_spec, key,
        jdomain.tile_frames(want_spec, jnp.asarray(frames)), p)
    draws = replayed(key, fields["kind"], c, n_frames, p)
    cfg = draws_mod.port_config(jcfg)
    res = ParallelParticleFilter(
        TrackingSSM(cfg), SIRConfig(n_particles=p * c), device="cpu",
        mesh=EmulatedMesh(p), dra=DRAConfig(**fields),
        domain=make_domain_spec(cfg, p, k_cap=k_cap)).run(draws, frames)
    assert_filter_matches(res, outs, final, p, c, draws)
    if k_cap is None:
        assert not res.diag["mig_overflow"].any()


def test_one_shard_mesh_with_a_domain_takes_the_sharded_path():
    """With a 1-tile domain a 1-shard mesh runs the distributed step (as
    the reference's does): it equals the 1-shard sharded replicated run,
    and moves nothing."""
    cfg, movie = _movie(frames=3, img=32)
    sir = SIRConfig(n_particles=128)
    kw = dict(device="cpu", mesh=EmulatedMesh(1), dra=DRAConfig(kind="rna"))
    rep = ParallelParticleFilter(TrackingSSM(cfg), sir, **kw)
    carry, outs = rep._run_sharded(2, movie.frames)
    dom = ParallelParticleFilter(TrackingSSM(cfg), sir,
                                 domain=make_domain_spec(cfg, 1),
                                 **kw).run(2, movie.frames)
    assert torch.equal(dom.estimates, outs.estimate)
    assert torch.equal(dom.final.state, carry.ensemble.state)
    assert not dom.diag["mig_moved"].any()
    assert not dom.diag["mig_overflow"].any()


@pytest.mark.parametrize("case", ["no mesh", "tiles", "type", "observations",
                                  "hooks"])
def test_domain_filter_validates_its_inputs(case):
    cfg = TrackingConfig(img_size=(32, 32))
    model = TrackingSSM(cfg)
    sir = SIRConfig(n_particles=64)
    spec = make_domain_spec(cfg, 2)
    if case == "no mesh":
        with pytest.raises(ValueError, match="mesh"):
            ParallelParticleFilter(model, sir, device="cpu", domain=spec)
    elif case == "tiles":
        with pytest.raises(ValueError, match="tiles"):
            ParallelParticleFilter(model, sir, device="cpu",
                                   mesh=EmulatedMesh(4), domain=spec)
    elif case == "type":
        with pytest.raises(TypeError, match="DomainSpec"):
            ParallelParticleFilter(model, sir, device="cpu",
                                   mesh=EmulatedMesh(2), domain=object())
    elif case == "observations":
        pf = ParallelParticleFilter(model, sir, device="cpu",
                                    mesh=EmulatedMesh(2), domain=spec)
        with pytest.raises(ValueError, match="observations"):
            pf.run(0, torch.zeros(3, 16, 16))
    else:
        lg = LinearGaussianSSM(torch.eye(2), torch.eye(2), torch.zeros(2),
                               torch.eye(2), torch.eye(2), torch.eye(2))
        with pytest.raises(ValueError, match="tile_observation_log_prob"):
            smc.make_distributed_sir_step(lg, sir, DRAConfig(),
                                          EmulatedMesh(2), domain=spec)
