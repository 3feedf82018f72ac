"""The port's LM stack against the reference on the CPU, for the smoke
configs of the three G-only dense archs (qwen3-32b: GQA 8/2 with
qk-norm; stablelm-3b: MHA 4/4; granite-34b: MQA 4/1).

The weights are the reference's own ``init_params`` carried across by
``convert.lm_params``; the tokens are drawn with numpy.  Held against
the live reference:

* ``rms_norm``, ``rope``, ``apply_qkv`` and ``apply_mlp``;
* ``forward_prefill`` (last hidden state and every layer's KV cache)
  and ``forward_decode`` logits, with ``compute_dtype="float32"`` at
  rtol = atol = 1e-4 (the bound of
  tests/test_models.py::test_decode_consistency_f32) and in bfloat16 at
  rtol = atol = 5e-2: values up to ~4, bf16 steps of 2^-8 relative, and
  the two packages round the bf16 products and elementwise steps at
  different places over three layers (measured up to ~0.047 at |x| ~ 3);
* greedy ``generate`` tokens exactly at float32, and temperature
  sampling exactly on the reference's replayed Gumbel noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_draws import generate_draws

from repro.configs import get_config
from repro.models.lm import layers as jlayers
from repro.models.lm import model as JM
from repro.serve import generate as jgenerate
from repro_torch import convert
from repro_torch.core.draws import ReplayDraws
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as TM
from repro_torch.serve import generate as tgenerate

ARCHS = ["qwen3-32b", "stablelm-3b", "granite-34b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KEY = jax.random.key(0)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _models(arch, dtype):
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=dtype)
    params = JM.init_params(KEY, jcfg)
    tcfg = convert.arch_config(dataclasses.asdict(jcfg))
    model = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg)
    return jcfg, params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_arch_configs_carry_across():
    """The port's FULL and SMOKE configs equal the reference's, field for
    field, and ``convert.arch_config`` rebuilds any reference config,
    sub-configs included."""
    from repro.configs import list_archs
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import list_archs as tlist
    for arch in tlist():
        for smoke in (False, True):
            assert (dataclasses.asdict(tget(arch, smoke))
                    == dataclasses.asdict(get_config(arch, smoke)))
    for arch in list_archs():
        cfg = get_config(arch)
        assert (dataclasses.asdict(convert.arch_config(dataclasses.asdict(
            cfg))) == dataclasses.asdict(cfg))
    assert tget("qwen3-32b").resolved_head_dim == 128
    # the port registers every arch whose layer kinds it runs
    # (tests/test_torch_lm_kinds.py holds the other five,
    # tests/test_torch_lm_moe.py the latent-attention and MoE two)
    assert sorted(tlist()) == sorted(ARCHS + [
        "gemma3-27b", "llama-3.2-vision-11b", "mamba2-1.3b",
        "musicgen-medium", "recurrentgemma-2b", "deepseek-v2-236b",
        "moonshot-v1-16b-a3b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_carries_every_weight(arch):
    jcfg, params, model = _models(arch, "float32")
    blocks = params["blocks"]["l0_G_dense"]
    assert len(model.blocks) == jcfg.n_layers
    for i, blk in enumerate(model.blocks):
        for name, w in blk.attn.items():
            np.testing.assert_array_equal(_np(w), blocks["attn"][name][i])
        for name, w in blk.mlp.items():
            np.testing.assert_array_equal(_np(w), blocks["mlp"][name][i])
        np.testing.assert_array_equal(_np(blk.pre_norm),
                                      blocks["pre_norm"][i])
    np.testing.assert_array_equal(_np(model.embed), params["embed"])
    np.testing.assert_array_equal(_np(model.lm_head), params["lm_head"])


@pytest.mark.parametrize("dtype", list(TOL))
def test_norm_and_rope_match(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    gamma = 0.1 * rng.standard_normal(16).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = tlayers.dtype_of(dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    _close(tlayers.rms_norm(tx, torch.from_numpy(gamma).to(tdt)),
           jlayers.rms_norm(jx, jnp.asarray(gamma).astype(jdt)), dtype)
    pos = np.arange(3, 12)
    _close(tlayers.rope(tx, torch.from_numpy(pos), 1e6),
           jlayers.rope(jx, jnp.asarray(pos), 1e6), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_and_mlp_match(arch):
    jcfg, params, model = _models(arch, "float32")
    hd = jcfg.resolved_head_dim
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["l0_G_dense"])
    x = np.random.default_rng(2).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.arange(7)
    want = jlayers.apply_qkv(jp["attn"], jnp.asarray(x), jcfg.n_heads,
                             jcfg.n_kv_heads, hd, jnp.asarray(pos),
                             jcfg.rope_theta, jcfg.qk_norm, jcfg.norm_eps)
    got = tlayers.apply_qkv(model.blocks[0].attn, torch.from_numpy(x),
                            jcfg.n_heads, jcfg.n_kv_heads, hd,
                            torch.from_numpy(pos), jcfg.rope_theta,
                            jcfg.qk_norm, jcfg.norm_eps)
    for g, w in zip(got, want):
        _close(g, w, "float32")
    _close(tlayers.apply_mlp(model.blocks[0].mlp, torch.from_numpy(x)),
           jlayers.apply_mlp(jp["mlp"], jnp.asarray(x)), "float32")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype):
    """Prefill 19 tokens into a 24-slot cache, then decode token 20."""
    jcfg, params, model = _models(arch, dtype)
    toks = _tokens(jcfg, (2, 20), seed=len(arch))
    h, caches, _ = JM.forward_prefill(params, jcfg, jnp.asarray(toks[:, :19]),
                                      max_len=24)
    th, tcaches = TM.forward_prefill(model, torch.from_numpy(toks[:, :19]), 24)
    assert th.dtype == tlayers.dtype_of(dtype) and th.shape == h.shape
    _close(th, h, dtype)
    for i, c in enumerate(tcaches):
        for name in ("k", "v"):
            _close(c[name], caches["blocks"]["l0_G_dense"][name][i], dtype)
    logits, _ = JM.forward_decode(params, jcfg, jnp.asarray(toks[:, 19:]), 19,
                                  caches)
    tlogits, tcaches = TM.forward_decode(model, torch.from_numpy(toks[:, 19:]),
                                         19, tcaches)
    _close(tlogits, logits, dtype)
    # the decode wrote slot 19 in place, and nothing past it
    assert bool(tcaches[0]["k"][:, :, 19].abs().sum() > 0)
    assert not bool(tcaches[0]["k"][:, :, 20:].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_is_consistent_with_prefill(arch):
    """The port against itself at float32: prefill T tokens then decode
    one gives the logits of prefilling T + 1 (tests/test_models.py's
    bound)."""
    jcfg, _, model = _models(arch, "float32")
    toks = torch.from_numpy(_tokens(jcfg, (2, 32), seed=3))
    _, caches = TM.forward_prefill(model, toks[:, :31], 40)
    dec, _ = TM.forward_decode(model, toks[:, 31:], 31, caches)
    full, _ = TM.forward_prefill(model, toks, 40)
    _close(dec[:, 0], TM.unembed(model, full)[:, 0].numpy(), "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, params, model = _models(arch, "float32")
    prompt = _tokens(jcfg, (2, 16), seed=5)
    want = jgenerate(params, jcfg, jnp.asarray(prompt), steps=6)
    got = tgenerate(model, torch.from_numpy(prompt), steps=6, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_generate_replays_reference():
    """Temperature sampling on the reference's own Gumbel noise (its
    ``fold_in(key, 7)`` first draw, then one split per decode step)
    gives the reference's tokens."""
    jcfg, params, model = _models("qwen3-32b", "float32")
    prompt = _tokens(jcfg, (2, 12), seed=6)
    key = jax.random.key(11)
    want = jgenerate(params, jcfg, jnp.asarray(prompt), steps=7,
                     temperature=0.8, key=key)
    draws = ReplayDraws(generate_draws(key, 2, jcfg.vocab_size, 7))
    got = tgenerate(model, torch.from_numpy(prompt), steps=7,
                    temperature=0.8, key=draws, device="cpu")
    assert draws.remaining == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
