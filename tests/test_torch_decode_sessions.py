"""Session-hosted SMC decoding in the port
(``repro_torch.serve.smc_decode.suspended_decode_session``) on the CPU.

tests/test_serve.py's hosted-decode case, written for the port: prompts
prefilled together and hosted as resident ``ParticleSessionServer``
sessions decode bit for bit as the port's ``smc_decode`` of the same
prompts with the same seed, every field, on the smoke qwen3-32b config
(its own dtype, so the KV caches are bfloat16).  A decode session also
survives suspension through the checkpoint store mid-decode (the
bfloat16 caches and the generator state round-trip), and sessions at
different positions cannot share a step.  The port's ``smc_decode``
against the reference's is tests/test_torch_smc_decode.py's.
"""
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core.draws import TorchDraws, shard_seed
from repro_torch.models.lm import model as M
from repro_torch.serve import (LMDecodeSSM, ParticleSessionServer,
                               SMCDecodeConfig, SuspendedSession, smc_decode,
                               suspended_decode_session)

SMC = SMCDecodeConfig(n_particles=4, steps=6, proposal_temperature=2.0,
                      ess_frac=0.9)
T0, SEED = 16, 3


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-32b", smoke=True)
    model = M.init_params(cfg, 0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, T0)))
    ref = smc_decode(model, prompt, SMC, key=SEED, device="cpu")
    assert bool(ref.resampled.any()), "the case must exercise resampling"
    return model, prompt, ref


def hosted(model, sessions, steps=SMC.steps, capacity=2):
    ssm = LMDecodeSSM(model=model, decode=SMC, prompt_len=T0)
    server = ParticleSessionServer(model=ssm, sir=SMC.sir(),
                                   capacity=capacity, device="cpu")
    handles = [server.resume(s) for s in sessions]
    for t in range(1, steps):
        for h in handles:
            server.submit(h, np.float32(t))
        server.step()
    return server, handles


def assert_matches(r, ref, i) -> None:
    assert torch.equal(r.final.state["tokens"], ref.sequences[i])
    for got, want in ((r.final.log_weights, ref.log_weights[i]),
                      (r.log_marginal, ref.log_marginal[:, i]),
                      (r.ess, ref.ess[:, i])):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(r.ancestors, ref.ancestors[:, i])
    assert torch.equal(r.resampled, ref.resampled[:, i])


def test_hosted_decode_is_smc_decode_bitwise(setup):
    model, prompt, ref = setup
    ssm = LMDecodeSSM(model=model, decode=SMC, prompt_len=T0)
    sessions = suspended_decode_session(ssm, SEED, prompt)
    assert [s.frames_done for s in sessions] == [1, 1]
    server, handles = hosted(model, sessions)
    assert server.tier_hits == {1: 0, 2: SMC.steps - 1}
    for i, h in enumerate(handles):
        r = server.result(h)
        assert r.log_marginal.shape == (SMC.steps,)
        assert_matches(r, ref, i)


def test_one_prompt_session_takes_its_own_stream(setup):
    """The one-prompt form with prompt i's generator: a lone session
    decodes, its history spans the prefill, and the payload is host-side
    (the bfloat16 caches as CPU tensors)."""
    model, prompt, _ = setup
    ssm = LMDecodeSSM(model=model, decode=SMC, prompt_len=T0)
    sus = suspended_decode_session(
        ssm, TorchDraws.from_seed(shard_seed(SEED, 1), "cpu"), prompt[1])
    assert isinstance(sus, SuspendedSession)
    assert sus.state["caches"][0]["k"].dtype == torch.bfloat16
    assert sus.state["caches"][0]["k"].device.type == "cpu"
    assert isinstance(sus.state["tokens"], np.ndarray)
    assert sus.ancestors.shape == (1, SMC.n_particles)
    server, (h,) = hosted(model, [sus], capacity=1)
    r = server.result(h)
    assert r.final.state["tokens"].shape == (SMC.n_particles, SMC.steps)
    assert bool(torch.isfinite(r.log_marginal).all())


def test_decode_session_suspends_through_the_store(setup, tmp_path):
    """Both sessions suspended to directories after 3 steps and resumed
    on a fresh server: the decode is still smc_decode's, bit for bit."""
    model, prompt, ref = setup
    ssm = LMDecodeSSM(model=model, decode=SMC, prompt_len=T0)
    server, handles = hosted(model, suspended_decode_session(
        ssm, SEED, prompt), steps=4)
    dirs = [str(tmp_path / f"s{i}") for i in range(2)]
    for h, d in zip(handles, dirs):
        server.suspend(h, directory=d)
    fresh = ParticleSessionServer(model=ssm, sir=SMC.sir(), capacity=2,
                                  device="cpu")
    handles = [fresh.resume_from(d) for d in dirs]
    for t in range(4, SMC.steps):
        for h in handles:
            fresh.submit(h, np.float32(t))
        fresh.step()
    for i, h in enumerate(handles):
        assert_matches(fresh.result(h), ref, i)


def test_sessions_at_different_positions_cannot_share_a_step(setup):
    model, prompt, _ = setup
    ssm = LMDecodeSSM(model=model, decode=SMC, prompt_len=T0)
    a, b = suspended_decode_session(ssm, SEED, prompt)
    server, (ha,) = hosted(model, [a], steps=3)
    hb = server.resume(b)
    server.submit(ha, np.float32(3))
    server.submit(hb, np.float32(1))
    with pytest.raises(ValueError, match="positions"):
        server.step()
