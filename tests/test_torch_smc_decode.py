"""The port's SMC decoding against the reference on the CPU.

* ``smc_decode`` on the smoke configs at float32, with each prompt's
  draws replayed from the reference's key stream
  (``test_torch_draws.smc_decode_draws``), against the live
  ``repro.serve.smc_decode``: sequences, ancestors, emissions and
  resample flags exactly; ``log_z``, ESS, per-step increments and the
  final log-weights within 1e-5 (the shared SIR convention holds
  logsumexp(lw) == 0 to float32 rounding; measured up to ~3e-6).  The
  proposal temperatures are chosen so that some runs resample.
* The reference's own properties, on the port's own RNG:
  τ = 1 keeps the weights uniform (tests/test_serve.py::
  test_smc_tau1_keeps_uniform_weights), and returned sequences are
  root-to-leaf paths of the recorded genealogy, by the reference's
  ``repro.core.genealogy`` and by the port's.
* The port's lineage functions against the reference's on random
  ancestor stacks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import stats
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_draws import smc_decode_draws

from repro.configs import get_config
from repro.core import genealogy as jgen
from repro.models.lm import model as JM
from repro.serve import SMCDecodeConfig as RefSMC
from repro.serve import smc_decode as ref_smc_decode
from repro_torch import convert
from repro_torch.core import genealogy as tgen
from repro_torch.core.draws import ReplayDraws
from repro_torch.core.particles import gather_particles
from repro_torch.models.lm.decode_ssm import LMDecodeSSM
from repro_torch.serve import SMCDecodeConfig, smc_decode

KEY = jax.random.key(0)
ATOL = 1e-5
INT_FIELDS = ("sequences", "resampled", "ancestors", "emissions")
FLOAT_FIELDS = ("log_weights", "log_z", "ess", "log_marginal")


def _models(arch):
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32")
    params = JM.init_params(KEY, jcfg)
    model = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                              convert.arch_config(dataclasses.asdict(jcfg)))
    return jcfg, params, model


def _prompt(cfg, b, t0, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t0)).astype(np.int32)


@pytest.mark.parametrize("arch,tau", [("qwen3-32b", 2.0),
                                      ("stablelm-3b", 1.5),
                                      ("granite-34b", 3.0)])
def test_smc_decode_matches_reference(arch, tau):
    jcfg, params, model = _models(arch)
    knobs = dict(n_particles=4, steps=8, proposal_temperature=tau)
    prompt = _prompt(jcfg, 2, 16, seed=len(arch))
    key = jax.random.key(3)
    want = ref_smc_decode(params, jcfg, jnp.asarray(prompt), RefSMC(**knobs),
                          key=key)
    draws = [ReplayDraws(d) for d in
             smc_decode_draws(key, 2, 4, jcfg.vocab_size, 8)]
    got = smc_decode(model, torch.from_numpy(prompt),
                     SMCDecodeConfig(**knobs), key=draws, device="cpu")
    assert all(d.remaining == 0 for d in draws)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    if arch == "qwen3-32b":
        assert bool(got.resampled.any())     # the case exercises the gather


def test_smc_tau1_keeps_uniform_weights():
    """τ = 1: proposal == target, every increment 0, no resample."""
    jcfg, _, model = _models("stablelm-3b")
    res = smc_decode(model, torch.from_numpy(_prompt(jcfg, 1, 16)),
                     SMCDecodeConfig(n_particles=4, steps=6,
                                     proposal_temperature=1.0),
                     key=5, device="cpu")
    np.testing.assert_allclose(res.ess.numpy(), 4.0, atol=1e-3)
    np.testing.assert_allclose(res.log_z.numpy(), 0.0, atol=1e-4)
    assert not bool(res.resampled.any())


def test_sequences_are_ancestral_paths():
    """On the port's own RNG: the returned sequences equal the
    trajectories the recorded genealogy reconstructs (the reference's
    oracle and the port's), ``log_z`` sums the increments and the final
    weights are normalized."""
    jcfg, _, model = _models("qwen3-32b")
    res = smc_decode(model, torch.from_numpy(_prompt(jcfg, 2, 16, seed=9)),
                     SMCDecodeConfig(n_particles=4, steps=8,
                                     proposal_temperature=2.0),
                     key=7, device="cpu")
    assert bool(res.resampled.any())
    stats.ess_sane(res.ess.numpy(), 4)
    for b in range(2):
        anc, em = res.ancestors[:, b], res.emissions[:, b]
        ref_paths = jgen.reconstruct_trajectories(jnp.asarray(anc.numpy()),
                                                  jnp.asarray(em.numpy()))
        np.testing.assert_array_equal(res.sequences[b].numpy(),
                                      np.asarray(ref_paths))
        assert torch.equal(tgen.reconstruct_trajectories(anc, em),
                           res.sequences[b])
    np.testing.assert_allclose(res.log_z.numpy(),
                               res.log_marginal.sum(0).numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.logsumexp(res.log_weights, -1).numpy(),
                               0.0, atol=1e-5)


@pytest.mark.parametrize("t_steps,n", [(1, 5), (6, 8), (12, 3)])
def test_lineage_matches_reference(t_steps, n):
    rng = np.random.default_rng(t_steps * n)
    anc = rng.integers(0, n, (t_steps, n)).astype(np.int32)
    anc[::3] = np.arange(n)                  # frames that did not resample
    emissions = {"tok": rng.integers(0, 100, (t_steps, n)).astype(np.int32),
                 "x": rng.standard_normal((t_steps, n, 2)).astype(np.float32)}
    ja, ta = jnp.asarray(anc), torch.from_numpy(anc)
    for name in ("ancestral_lineage", "smoothing_lineage"):
        np.testing.assert_array_equal(getattr(tgen, name)(ta).numpy(),
                                      np.asarray(getattr(jgen, name)(ja)))
    want = jgen.reconstruct_trajectories(
        ja, {k: jnp.asarray(v) for k, v in emissions.items()})
    got = tgen.reconstruct_trajectories(
        ta, {k: torch.from_numpy(v) for k, v in emissions.items()})
    for k in emissions:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_gather_state_is_a_row_gather_within_each_prompt():
    """``gather_state`` equals the generic per-slot gather on every leaf
    (caches, tokens, histories), and hands an all-identity step's state
    back as it is."""
    g = torch.Generator().manual_seed(2)
    state = {"caches": [{"k": torch.randn(2, 3, 2, 5, 4, generator=g),
                         "v": torch.randn(2, 3, 2, 5, 4, generator=g)}],
             "token": torch.randint(0, 9, (2, 3), generator=g),
             "tokens": torch.randint(0, 9, (2, 3, 6), generator=g)}
    ssm = LMDecodeSSM(model=None, decode=SMCDecodeConfig(n_particles=3),
                      prompt_len=4)
    anc = torch.tensor([[2, 2, 0], [0, 1, 2]], dtype=torch.int32)
    got = ssm.gather_state(state, anc)
    assert torch.equal(got["token"], gather_particles(state["token"], anc))
    assert torch.equal(got["tokens"], gather_particles(state["tokens"], anc))
    for name in ("k", "v"):
        assert torch.equal(got["caches"][0][name],
                           gather_particles(state["caches"][0][name], anc))
    ident = torch.arange(3, dtype=torch.int32).expand(2, 3)
    assert ssm.gather_state(state, ident) is state


def test_blank_state_has_the_prefilled_layout():
    """``LMDecodeSSM.init`` (the shape template) lays its leaves out as
    ``prefill_state`` does: ``(B, K, ...)`` with one cache per layer."""
    from repro_torch.core.draws import BankDraws, TorchDraws
    from repro_torch.models.lm.decode_ssm import prefill_state
    jcfg, _, model = _models("granite-34b")
    ssm = LMDecodeSSM(model=model, decode=SMCDecodeConfig(n_particles=3,
                                                          steps=5),
                      prompt_len=7)
    draws = BankDraws([TorchDraws.from_seed(s, "cpu") for s in (1, 2)])
    blank = ssm.init(draws, 3)
    full, _, _ = prefill_state(ssm, draws, torch.from_numpy(
        _prompt(jcfg, 2, 7)).long())
    assert len(blank["caches"]) == len(full["caches"]) == jcfg.n_layers
    for key in ("token", "pos", "emitted", "inc", "logp", "tokens"):
        assert blank[key].shape == full[key].shape, key
        assert blank[key].dtype == full[key].dtype, key
    for b_layer, f_layer in zip(blank["caches"], full["caches"]):
        for name in ("k", "v"):
            assert b_layer[name].shape == f_layer[name].shape
