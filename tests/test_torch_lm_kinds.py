"""The port's L, R, D and X layer kinds and the multi-codebook head
against the reference on the CPU, for the smoke configs of the five
archs that use them: gemma3-27b (L/G, window 16, per-kind RoPE base),
recurrentgemma-2b (R/R/L, MQA, window 16), mamba2-1.3b (D), llama-3.2-
vision-11b (G/X over 16 image tokens) and musicgen-medium (4 codebooks).

The weights are the reference's own ``init_params`` carried across by
``convert.lm_params``; tokens and image embeddings are drawn with numpy.
Held against the live reference:

* ``lm_params`` carries every leaf of ``init_params``, by name;
* ``forward_prefill``'s last hidden state and three ``forward_decode``
  steps' logits, past the window, at float32 (rtol = atol = 1e-4) and
  bfloat16 (5e-2): tests/test_torch_lm.py's ``TOL`` and reasons;
* the recurrent layers' prefill states (``return_state``) and decode
  steps;
* greedy ``generate`` token for token at float32 (per codebook for
  musicgen, with an image for llama-3.2-vision) and temperature
  sampling of the codebooks on the reference's replayed Gumbel noise;
* ``smc_decode`` on replayed draws for the three archs the reference's
  ``smc_decode`` runs (exact tokens and ancestry, weights within 1e-5);
  the two it cannot run (image inputs, codebooks) raise ``ValueError``
  in the port;
* the port against itself: decode after prefill equals a longer prefill
  (float32), with a prefill length that is not a multiple of mamba2's
  chunk (the port pads it; the reference asserts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_draws import _np as np32
from test_torch_draws import smc_decode_draws

from repro.configs import get_config
from repro.models.lm import model as JM
from repro.models.lm import rglru as jrglru
from repro.models.lm import ssm as jssm
from repro.serve import SMCDecodeConfig as RefSMC
from repro.serve import generate as jgenerate
from repro.serve import smc_decode as ref_smc_decode
from repro_torch import convert
from repro_torch.core.draws import ReplayDraws
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import rglru as trglru
from repro_torch.models.lm import ssm as tssm
from repro_torch.serve import SMCDecodeConfig, generate, smc_decode

ARCHS = ["gemma3-27b", "recurrentgemma-2b", "mamba2-1.3b",
         "llama-3.2-vision-11b", "musicgen-medium"]
SMC_ARCHS = {"gemma3-27b": 2.0, "recurrentgemma-2b": 2.5,
             "mamba2-1.3b": 3.0}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KEY = jax.random.key(0)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _models(arch, dtype="float32"):
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=dtype)
    params = JM.init_params(KEY, jcfg)
    model = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                              convert.arch_config(dataclasses.asdict(jcfg)))
    return jcfg, params, model


def _tokens(cfg, b, t, seed=0):
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t) + books).astype(np.int32)


def _img(cfg, b, seed=1):
    if not cfg.cross_attn_every:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)


def _maybe(x, fn):
    return None if x is None else fn(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_carries_every_leaf(arch):
    """Every leaf of the reference's ``init_params`` is in the port's
    decoder, bit for bit at float32, under its reference name."""
    jcfg, params, model = _models(arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    layers = list(convert._layer_leaves(params))
    assert len(layers) == len(model.blocks) == jcfg.n_layers
    for blk, (kind, ffn), layer in zip(model.blocks,
                                       TM.make_plan(model.cfg).layers(),
                                       layers):
        assert (blk.kind, blk.ffn) == (kind, ffn)
        leaves = dict(blk.named_parameters())
        flat = jax.tree_util.tree_flatten_with_path(layer)[0]
        assert len(flat) == len(leaves)
        for path, want in flat:
            name = ".".join(p.key for p in path)
            np.testing.assert_array_equal(leaves[name].numpy(), want,
                                          err_msg=name)
    for name in ("embed", "final_norm", "lm_head", "img_proj"):
        got = getattr(model, name)
        assert (got is None) == (name not in params), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), params[name])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype):
    """Prefill 24 tokens (past the smoke window of 16) into a 30-slot
    cache, then decode three more."""
    jcfg, params, model = _models(arch, dtype)
    toks = _tokens(jcfg, 2, 27, seed=len(arch))
    img = _img(jcfg, 2)
    h, caches, _ = JM.forward_prefill(
        params, jcfg, jnp.asarray(toks[:, :24]), max_len=30,
        img=_maybe(img, jnp.asarray))
    th, tcaches = TM.forward_prefill(model, torch.from_numpy(toks[:, :24]),
                                     30, img=_maybe(img, torch.from_numpy))
    assert th.dtype == model.dtype and th.shape == h.shape
    _close(th, h, dtype)
    for pos in range(24, 27):
        logits, caches = JM.forward_decode(
            params, jcfg, jnp.asarray(toks[:, pos:pos + 1]), pos, caches)
        tlogits, tcaches = TM.forward_decode(
            model, torch.from_numpy(toks[:, pos:pos + 1]), pos, tcaches)
        assert tlogits.shape == logits.shape
        _close(tlogits, logits, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_is_consistent_with_prefill(arch):
    """The port against itself at float32: prefill 40 tokens then decode
    one gives the logits of prefilling 41 (mamba2's chunk is 32, so both
    prefills pad their last chunk)."""
    jcfg, _, model = _models(arch)
    toks = torch.from_numpy(_tokens(jcfg, 2, 41, seed=3))
    img = _maybe(_img(jcfg, 2), torch.from_numpy)
    _, caches = TM.forward_prefill(model, toks[:, :40], 48, img=img)
    dec, _ = TM.forward_decode(model, toks[:, 40:], 40, caches)
    full, _ = TM.forward_prefill(model, toks, 48, img=img)
    _close(dec[:, 0], TM.unembed(model, full)[:, 0].numpy(), "float32")


@pytest.mark.parametrize("dtype", list(TOL))
def test_rglru_states_match_reference(dtype):
    """``rglru_forward(return_state=True)`` (output, final recurrent
    state, conv cache) and two decode steps from that state."""
    jcfg, params, model = _models("recurrentgemma-2b", dtype)
    jp = jax.tree_util.tree_map(
        lambda a: a[0], JM.cast_params(params, jcfg)["blocks"]["l0_R_dense"])
    x = np.random.default_rng(4).standard_normal(
        (2, 21, jcfg.d_model)).astype(np.float32)
    tdt = model.dtype
    want = jrglru.rglru_forward(jp["rglru"], jnp.asarray(x).astype(
        jp["rglru"]["w_x"].dtype), jcfg.rglru, return_state=True)
    got = trglru.rglru_forward(model.blocks[0].rglru,
                               torch.from_numpy(x).to(tdt), model.cfg.rglru,
                               return_state=True)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, dtype)
    rec, conv, trec, tconv = want[1], want[2], got[1], got[2]
    for i in range(2):
        xi = x[:, i:i + 1] * 0.5
        out, rec, conv = jrglru.rglru_decode_step(
            jp["rglru"], jnp.asarray(xi).astype(jp["rglru"]["w_x"].dtype),
            jcfg.rglru, rec_state=rec, conv_state=conv)
        tout, trec, tconv = trglru.rglru_decode_step(
            model.blocks[0].rglru, torch.from_numpy(xi).to(tdt),
            model.cfg.rglru, rec_state=trec, conv_state=tconv)
        _close(tout, out, dtype)
        _close(trec, rec, dtype)


@pytest.mark.parametrize("t", [32, 64, 19])
@pytest.mark.parametrize("dtype", list(TOL))
def test_ssd_states_match_reference(dtype, t):
    """``ssd_forward(return_state=True)`` (output, final SSM state, conv
    cache) at one chunk, two chunks and a length under one chunk, then a
    decode step from that state."""
    jcfg, params, model = _models("mamba2-1.3b", dtype)
    jp = jax.tree_util.tree_map(
        lambda a: a[0], JM.cast_params(params, jcfg)["blocks"]["l0_D_none"])
    x = np.random.default_rng(t).standard_normal(
        (2, t, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jp["ssm"]["w_in"].dtype)
    tx = torch.from_numpy(x).to(model.dtype)
    d, eps = jcfg.d_model, jcfg.norm_eps
    want = jssm.ssd_forward(jp["ssm"], jx, jcfg.ssm, d, eps,
                            return_state=True)
    got = tssm.ssd_forward(model.blocks[0].ssm, tx, model.cfg.ssm, d, eps,
                           return_state=True)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    state, tstate = (want[1].astype(jx.dtype),
                     got[1].to(model.dtype))
    out, state, _ = jssm.ssd_decode_step(
        jp["ssm"], jx[:, :1], jcfg.ssm, d, eps, ssm_state=state,
        conv_state=want[2])
    tout, tstate, _ = tssm.ssd_decode_step(
        model.blocks[0].ssm, tx[:, :1], model.cfg.ssm, d, eps,
        ssm_state=tstate, conv_state=got[2])
    _close(tout, out, dtype)
    _close(tstate, state, dtype)


def test_ssd_decode_carries_a_float32_state():
    """A bfloat16 decode step handed a float32 SSM state keeps it in
    float32 and returns a float32 output, as the reference's promotion
    does, through three steps."""
    jcfg, params, model = _models("mamba2-1.3b", "bfloat16")
    jp = jax.tree_util.tree_map(
        lambda a: a[0], JM.cast_params(params, jcfg)["blocks"]["l0_D_none"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    d, eps, s = jcfg.d_model, jcfg.norm_eps, jcfg.ssm
    state = rng.standard_normal(
        (2, s.expand * d // s.head_dim, s.head_dim, s.state_dim)
    ).astype(np.float32)
    conv = rng.standard_normal(
        (2, s.conv_width - 1, s.expand * d + 2 * s.n_groups * s.state_dim)
    ).astype(np.float32)
    jstate, jconv = jnp.asarray(state), jnp.asarray(conv, jnp.bfloat16)
    tstate = torch.from_numpy(state)
    tconv = torch.from_numpy(conv).to(torch.bfloat16)
    for i in range(3):
        out, jstate, jconv = jssm.ssd_decode_step(
            jp["ssm"], jnp.asarray(x[:, i:i + 1], jnp.bfloat16), jcfg.ssm, d,
            eps, ssm_state=jstate, conv_state=jconv)
        tout, tstate, tconv = tssm.ssd_decode_step(
            model.blocks[0].ssm, torch.from_numpy(x[:, i:i + 1]).to(
                torch.bfloat16), model.cfg.ssm, d, eps, ssm_state=tstate,
            conv_state=tconv)
        assert jstate.dtype == jnp.float32 and tstate.dtype == torch.float32
        assert out.dtype == jnp.float32 and tout.dtype == torch.float32
        _close(tout, out, "bfloat16")
        _close(tstate, jstate, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, params, model = _models(arch)
    prompt = _tokens(jcfg, 2, 20, seed=5)
    img = _img(jcfg, 2)
    want = jgenerate(params, jcfg, jnp.asarray(prompt), steps=6,
                     img=_maybe(img, jnp.asarray))
    got = generate(model, torch.from_numpy(prompt), steps=6,
                   img=_maybe(img, torch.from_numpy), device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_codebook_sampling_replays_reference():
    """musicgen at a temperature: each codebook drawn on the reference's
    own ``(B, K, V)`` Gumbel noise (``fold_in(key, 7)`` for the first
    token, then one split per decode step) gives its tokens."""
    jcfg, params, model = _models("musicgen-medium")
    prompt = _tokens(jcfg, 2, 12, seed=6)
    key, steps = jax.random.key(11), 5
    want = jgenerate(params, jcfg, jnp.asarray(prompt), steps=steps,
                     temperature=0.8, key=key)
    shape = (2, jcfg.n_codebooks, jcfg.vocab_size)
    draws = [("gumbel", np32(jax.random.gumbel(jax.random.fold_in(key, 7),
                                               shape)))]
    k = key
    for _ in range(steps - 1):
        k, k_s = jax.random.split(k)
        draws.append(("gumbel", np32(jax.random.gumbel(k_s, shape))))
    replay = ReplayDraws(draws)
    got = generate(model, torch.from_numpy(prompt), steps=steps,
                   temperature=0.8, key=replay, device="cpu")
    assert replay.remaining == 0 and got.shape == (2, steps, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", list(SMC_ARCHS))
def test_smc_decode_matches_reference(arch):
    """Prompts of 20 tokens (past the window), K = 4, 8 steps, on the
    reference's replayed key streams: tokens, ancestry and resampling
    exactly, weights and normalizers within 1e-5."""
    jcfg, params, model = _models(arch)
    knobs = dict(n_particles=4, steps=8, proposal_temperature=SMC_ARCHS[arch])
    prompt = _tokens(jcfg, 2, 20, seed=len(arch))
    key = jax.random.key(3)
    want = ref_smc_decode(params, jcfg, jnp.asarray(prompt), RefSMC(**knobs),
                          key=key)
    draws = [ReplayDraws(d) for d in
             smc_decode_draws(key, 2, 4, jcfg.vocab_size, 8)]
    got = smc_decode(model, torch.from_numpy(prompt),
                     SMCDecodeConfig(**knobs), key=draws, device="cpu")
    assert all(d.remaining == 0 for d in draws)
    assert bool(got.resampled.any())
    for f in ("sequences", "resampled", "ancestors", "emissions"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("log_weights", "log_z", "ess", "log_marginal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_smc_decode_refuses_what_the_reference_cannot_run(arch):
    """The reference's ``smc_decode`` fails on these (its prefill gets no
    image; a codebook prompt is not ``(B, T0)``): the port says why."""
    jcfg, params, model = _models(arch)
    prompt = _tokens(jcfg, 2, 8)
    with pytest.raises(Exception):
        ref_smc_decode(params, jcfg, jnp.asarray(prompt),
                       RefSMC(n_particles=2, steps=3), key=KEY)
    with pytest.raises(ValueError, match="reference's smc_decode cannot"):
        smc_decode(model, torch.from_numpy(prompt[:, :, 0] if prompt.ndim
                                           == 3 else prompt),
                   SMCDecodeConfig(n_particles=2, steps=3), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_carry_across(arch):
    """The port's FULL and SMOKE configs equal the reference's, and
    ``init_params`` builds the smoke decoder with every leaf's shape of
    the reference's."""
    from repro_torch.configs import get_config as tget
    for smoke in (False, True):
        assert (dataclasses.asdict(tget(arch, smoke))
                == dataclasses.asdict(get_config(arch, smoke)))
    _, _, want = _models(arch)
    got = TM.init_params(tget(arch, smoke=True), 0, device="cpu",
                         dtype=torch.float32)
    shapes = {n: tuple(p.shape) for n, p in want.named_parameters()}
    assert {n: tuple(p.shape) for n, p in got.named_parameters()} == shapes
