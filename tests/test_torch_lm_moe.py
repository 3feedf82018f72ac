"""The port's latent attention (the M kind) and mixture-of-experts FFNs
against the reference on the CPU, for the smoke configs of the two archs
that use them: deepseek-v2-236b (M layers, one dense then MoE FFNs) and
moonshot-v1-16b-a3b (G layers, one dense then MoE FFNs).

The weights are the reference's own ``init_params`` carried across by
``convert.lm_params``; tokens and activations are drawn with numpy.
Held against the live reference:

* ``lm_params`` carries every leaf of ``init_params``, by name;
* ``forward_prefill``'s last hidden state and three ``forward_decode``
  steps' logits at float32 (rtol = atol = 1e-4) and bfloat16 (5e-2),
  tests/test_torch_lm.py's ``TOL`` and reasons, at the configs'
  ``capacity_factor`` 1.25, where the prefill drops tokens; the MoE aux
  summed over the layers: the dropped fraction and the largest load
  exactly, the load-balance loss within 1e-6 (its router-mass mean sums
  floats in another order);
* ``apply_moe`` alone at a forced overflow: the same experts and kept
  (token, k) entries, the output within tolerance; and with groups, the
  reference's ``apply_moe`` vmapped over them (its ``smc_decode`` vmaps
  the step over prompts); the reference compiled (``jit``), as the model
  runs it inside its layer scan, so its dropped fraction is XLA's;
* ``mla_attention`` and ``mla_decode_absorbed`` alone; ``mha_ref``
  with a v head dim below q's against ``chunked_causal_attention``;
* greedy ``generate`` token for token at float32, and ``smc_decode`` on
  replayed draws (exact tokens and ancestry, weights within 1e-5) with
  K = 16 particles, so that a prompt's rows overflow an expert at decode;
* the port against itself: decode after prefill equals a longer prefill
  at ``capacity_factor`` 8.0, where nothing drops (the reference's own
  remedy in tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_draws import smc_decode_draws

from repro.configs import get_config
from repro.models.lm import layers as jlayers
from repro.models.lm import mla as jmla
from repro.models.lm import model as JM
from repro.models.lm import moe as jmoe
from repro.serve import SMCDecodeConfig as RefSMC
from repro.serve import generate as jgenerate
from repro.serve import smc_decode as ref_smc_decode
from repro_torch import convert
from repro_torch.core.draws import ReplayDraws
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.lm import mla as tmla
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import moe as tmoe
from repro_torch.serve import SMCDecodeConfig, generate, smc_decode

ARCHS = ["deepseek-v2-236b", "moonshot-v1-16b-a3b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bfloat16 decode logits of the full smoke models: the two frameworks
# round the attention, norms and expert sums at other places, and a
# token near a tie of its k-th and (k+1)-th expert can take the other
# one; over three layers that reaches 0.082 on a few of 512 logits
# (deepseek, read on the CPU), past TOL's 5e-2 + 5e-2·|x|
LOGIT_TOL_BF16 = 1e-1
KEY = jax.random.key(0)


def _close(got, want, dtype, tol=None):
    tol = tol or TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _models(arch, dtype="float32", capacity_factor=None):
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=dtype)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    params = JM.init_params(KEY, jcfg)
    model = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                              convert.arch_config(dataclasses.asdict(jcfg)))
    return jcfg, params, model


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _layer(params, jcfg, name):
    """The first scanned layer's weights, cast as the reference casts."""
    return jax.tree_util.tree_map(
        lambda a: a[0], JM.cast_params(params, jcfg)["blocks"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_carries_every_leaf(arch):
    """Every leaf of the reference's ``init_params`` is in the port's
    decoder, bit for bit at float32, under its reference name (a MoE
    layer's shared MLP nested as ``moe.shared.*``)."""
    jcfg, params, model = _models(arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    layers = list(convert._layer_leaves(params))
    assert len(layers) == len(model.blocks) == jcfg.n_layers
    plan = TM.make_plan(model.cfg).layers()
    assert [ffn for _, ffn in plan] == ["dense", "moe", "moe"]
    for blk, (kind, ffn), layer in zip(model.blocks, plan, layers):
        assert (blk.kind, blk.ffn) == (kind, ffn)
        leaves = dict(blk.named_parameters())
        flat = jax.tree_util.tree_flatten_with_path(layer)[0]
        assert len(flat) == len(leaves)
        for path, want in flat:
            name = ".".join(p.key for p in path)
            np.testing.assert_array_equal(leaves[name].numpy(), want,
                                          err_msg=name)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      params[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_shapes(arch):
    """``init_params`` builds the smoke decoder with every leaf's shape of
    the reference's (the configs themselves are held field for field by
    tests/test_torch_lm.py)."""
    from repro_torch.configs import get_config as tget
    _, _, want = _models(arch)
    got = TM.init_params(tget(arch, smoke=True), 0, device="cpu",
                         dtype=torch.float32)
    shapes = {n: tuple(p.shape) for n, p in want.named_parameters()}
    assert {n: tuple(p.shape) for n, p in got.named_parameters()} == shapes


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype):
    """Prefill 24 tokens into a 30-slot cache, then decode three more (at
    bfloat16 the logits within LOGIT_TOL_BF16); the
    prefill drops tokens at the config's capacity factor, and its summed
    aux is the reference's: exactly at float32 (the aux loss within
    1e-6).  At bfloat16 the two frameworks round the attention and norms
    differently, so a token near a tie between its k-th and (k+1)-th
    expert can route elsewhere (on the same bfloat16 input the routing is
    the same: ``test_apply_moe_matches_at_overflow``), and the aux is
    held within two entries' worth of dropped fraction and load."""
    jcfg, params, model = _models(arch, dtype)
    assert jcfg.moe.capacity_factor == 1.25
    toks = _tokens(jcfg, 2, 27, seed=len(arch))
    h, caches, jaux = JM.forward_prefill(params, jcfg,
                                         jnp.asarray(toks[:, :24]), max_len=30)
    aux = {}
    th, tcaches = TM.forward_prefill(model, torch.from_numpy(toks[:, :24]),
                                     30, aux=aux)
    assert th.dtype == model.dtype and th.shape == h.shape
    _close(th, h, dtype)
    assert sorted(aux) == sorted(jaux) and float(jaux["moe_drop_frac"]) > 0
    drop, jdrop = float(aux["moe_drop_frac"]), float(jaux["moe_drop_frac"])
    load, jload = int(aux["moe_max_load"]), int(jaux["moe_max_load"])
    if dtype == "float32":
        assert drop == jdrop and load == jload
        assert abs(float(aux["moe_aux_loss"])
                   - float(jaux["moe_aux_loss"])) <= 1e-6
    else:
        # per layer 2·24 tokens × top-2 = 96 entries; two MoE layers
        assert abs(drop - jdrop) <= 2 * 2 / 96 and abs(load - jload) <= 4
    for pos in range(24, 27):
        logits, caches = JM.forward_decode(
            params, jcfg, jnp.asarray(toks[:, pos:pos + 1]), pos, caches)
        tlogits, tcaches = TM.forward_decode(
            model, torch.from_numpy(toks[:, pos:pos + 1]), pos, tcaches)
        assert tlogits.shape == logits.shape
        _close(tlogits, logits, dtype,
               LOGIT_TOL_BF16 if dtype == "bfloat16" else None)


def _moe_inputs(arch, n_tokens, seed, dtype="float32"):
    jcfg, params, model = _models(arch, dtype)
    moe_cfg = dataclasses.replace(jcfg.moe, capacity_factor=0.5)
    x = np.random.default_rng(seed).standard_normal(
        (2, n_tokens, jcfg.d_model)).astype(np.float32)
    return moe_cfg, _layer(params, jcfg, "l0_" + TM.make_plan(
        model.cfg).unit[0][0] + "_moe")["moe"], model.blocks[1].moe, x


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_at_overflow(arch, dtype):
    """At capacity factor 0.5 over 64 tokens (cap 8 of 128 entries) the
    port routes every token to the reference's experts, keeps the same
    (token, k) entries (ranks by a stable sort), and gives the output
    within tolerance and the aux (exactly; the loss within 1e-6), at
    float32 and on the same bfloat16 inputs."""
    cfg, jp, tp, x = _moe_inputs(arch, 32, 11, dtype)
    jdt = jp["router"].dtype
    want, jaux = jax.jit(lambda xx: jmoe.apply_moe(jp, xx, cfg))(
        jnp.asarray(x).astype(jdt))
    got, aux = tmoe.apply_moe(tp, torch.from_numpy(x).to(
        tp["router"].dtype), cfg)
    _close(got, want, dtype)
    x = np.asarray(jnp.asarray(x).astype(jdt), np.float32)
    # the kept set, from each side's own routing
    xf = x.reshape(-1, x.shape[-1])
    n, k, e = xf.shape[0], cfg.top_k, cfg.n_experts
    cap = jmoe.capacity_for(n, cfg)
    assert tmoe.capacity_for(n, cfg) == cap == 8
    _, jeid = jax.lax.top_k(jax.nn.softmax(
        (jnp.asarray(xf).astype(jdt) @ jp["router"]).astype(jnp.float32),
        -1), k)
    jkeep = np.asarray(jmoe._rank_within_expert(jeid.reshape(-1), n * k,
                                                e)) < cap
    _, teid = torch.softmax((torch.from_numpy(xf).to(tp["router"].dtype)
                             @ tp["router"]).float(), -1).topk(k)
    trank = tmoe._rank_within_expert(teid.reshape(-1), e)[0]
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(trank.numpy() < cap, jkeep)
    assert 0 < (~jkeep).sum() and float(jaux["moe_drop_frac"]) > 0.1
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    assert int(aux["moe_max_load"]) == int(jaux["moe_max_load"])
    assert abs(float(aux["moe_aux_loss"])
               - float(jaux["moe_aux_loss"])) <= 1e-6


@pytest.mark.parametrize("groups", [2, 4])
def test_apply_moe_groups_are_the_vmapped_reference(groups):
    """With ``groups`` the rows (32 a group) route group by group: the
    reference's ``apply_moe`` vmapped over the groups (its smc_decode's
    step over prompts), output and per-group aux, drops included."""
    cfg, jp, tp, x = _moe_inputs("deepseek-v2-236b", 16 * groups, 12)
    d = x.shape[-1]
    xg = x.reshape(groups, -1, 1, d)
    want, jaux = jax.jit(jax.vmap(lambda xx: jmoe.apply_moe(jp, xx, cfg)))(
        jnp.asarray(xg))
    got, aux = tmoe.apply_moe(tp, torch.from_numpy(x.reshape(-1, 1, d)), cfg,
                              groups=groups)
    _close(got.reshape(xg.shape), want, "float32")
    assert float(jaux["moe_drop_frac"].max()) > 0
    np.testing.assert_array_equal(aux["moe_drop_frac"].numpy(),
                                  np.asarray(jaux["moe_drop_frac"]))
    np.testing.assert_array_equal(aux["moe_max_load"].numpy(),
                                  np.asarray(jaux["moe_max_load"]))
    np.testing.assert_allclose(aux["moe_aux_loss"].numpy(),
                               np.asarray(jaux["moe_aux_loss"]), rtol=0,
                               atol=1e-6)


def test_rank_within_expert_is_the_references():
    """Ranks of 300 entries over 8 experts, with runs of one expert: the
    reference's, exactly."""
    flat = np.random.default_rng(3).integers(0, 8, 300)
    flat[100:140] = 5
    want = jmoe._rank_within_expert(jnp.asarray(flat), 300, 8)
    got = tmoe._rank_within_expert(torch.from_numpy(flat), 8)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_attention_matches_reference(dtype):
    """The prefill path alone: decompressed K/V and one attention call at
    scale ``(dqk + drope)^-0.5``, against the reference's chunked
    attention (two chunks of 16)."""
    jcfg, params, model = _models("deepseek-v2-236b", dtype)
    jp = _layer(params, jcfg, "l0_M_moe")["mla"]
    x = np.random.default_rng(5).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    kw = dict(theta=jcfg.rope_theta, eps=jcfg.norm_eps)
    want = jmla.mla_attention(jp, jnp.asarray(x).astype(jp["wo"].dtype),
                              jcfg.n_heads, jcfg.mla,
                              positions=jnp.arange(32), chunk=16, **kw)
    got = tmla.mla_attention(model.blocks[1].mla,
                             torch.from_numpy(x).to(model.dtype),
                             jcfg.n_heads, model.cfg.mla,
                             positions=torch.arange(32), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_decode_absorbed_matches_reference(dtype):
    """The absorbed decode alone at position 9 of 16 cache slots (the
    slots past 9 hold values the reference masks and the port never
    reads)."""
    jcfg, params, model = _models("deepseek-v2-236b", dtype)
    jp = _layer(params, jcfg, "l0_M_moe")["mla"]
    rng = np.random.default_rng(6)
    m = jcfg.mla
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, 16, m.kv_lora_rank)).astype(np.float32)
    pe = rng.standard_normal((2, 16, m.qk_rope_dim)).astype(np.float32)
    kw = dict(pos=9, theta=jcfg.rope_theta, eps=jcfg.norm_eps)
    jd = jp["wo"].dtype
    want = jmla.mla_decode_absorbed(
        jp, jnp.asarray(x).astype(jd), jcfg.n_heads, m,
        c_cache=jnp.asarray(c).astype(jd), pe_cache=jnp.asarray(pe).astype(
            jd), **kw)
    td = model.dtype
    got = tmla.mla_decode_absorbed(
        model.blocks[1].mla, torch.from_numpy(x).to(td), jcfg.n_heads,
        model.cfg.mla, c_cache=torch.from_numpy(c).to(td),
        pe_cache=torch.from_numpy(pe).to(td), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("hkv", [4, 2])
def test_mha_ref_takes_a_smaller_v_head_dim(hkv):
    """``mha_ref`` (and ``ops.attention`` on the CPU) with q/k head dim 24
    and v head dim 16, MHA and GQA: the reference's
    ``chunked_causal_attention`` at the same explicit scale."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 32, 24)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 32, 24)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 32, 16)).astype(np.float32)
    want = jlayers.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16,
        scale=40 ** -0.5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.mha_ref(tq, tk, tv, scale=40 ** -0.5)
    assert got.shape == (2, 4, 32, 16)
    _close(got, want, "float32")
    assert torch.equal(ops.attention(tq, tk, tv, scale=40 ** -0.5), got)


@pytest.mark.parametrize("lq", [1, 200])
def test_kernel_plans_the_latent_pair_on_mma(lq):
    """(192, 128) never goes to the wgmma or split variants, at a prefill
    or a one-row decode; float32 stays "f32"; the wrapper takes the pair
    and refuses the CPU tensors only at its device check, before it
    loads anything."""
    q_shape, k_shape = (1, 128, lq, 192), (1, 128, 256, 192)
    assert fa.plan(q_shape, k_shape, torch.bfloat16, dv=128).variant == "mma"
    assert fa.plan(q_shape, k_shape, torch.float32, dv=128).variant == "f32"
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 4, 3, 192), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 4, 5, 192), generator=g).to(torch.bfloat16)
    v = torch.randn((1, 4, 5, 128), generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(q, k, v)
    assert not build._LIBS


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_is_consistent_with_prefill(arch):
    """The port against itself at float32 and capacity factor 8.0 (no
    drops): prefill 40 tokens then decode one gives the logits of
    prefilling 41."""
    jcfg, _, model = _models(arch, capacity_factor=8.0)
    toks = torch.from_numpy(_tokens(jcfg, 2, 41, seed=3))
    aux = {}
    _, caches = TM.forward_prefill(model, toks[:, :40], 48, aux=aux)
    # nothing drops: the fraction is 0 up to the float32 reciprocal of
    # the entry count (moe.apply_moe computes it as XLA does)
    assert abs(float(aux["moe_drop_frac"])) < 1e-6
    dec, _ = TM.forward_decode(model, toks[:, 40:], 40, caches)
    full, _ = TM.forward_prefill(model, toks, 48)
    _close(dec[:, 0], TM.unembed(model, full)[:, 0].numpy(), "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jcfg, params, model = _models(arch)
    prompt = _tokens(jcfg, 2, 20, seed=5)
    want = jgenerate(params, jcfg, jnp.asarray(prompt), steps=6)
    got = generate(model, torch.from_numpy(prompt), steps=6, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_smc_decode_matches_reference(arch, monkeypatch):
    """Prompts of 16 tokens, K = 16, 6 steps, τ = 2, on the reference's
    replayed key streams: tokens, ancestry and resampling exactly,
    weights and normalizers within 1e-5.  Each prompt's 16 rows route on
    their own (the reference vmaps its step over prompts), and some
    decode step overflows an expert (cap 8), so the drops at decode are
    held to the reference's too."""
    jcfg, params, model = _models(arch)
    knobs = dict(n_particles=16, steps=6, proposal_temperature=2.0)
    prompt = _tokens(jcfg, 2, 16, seed=len(arch))
    key = jax.random.key(3)
    want = ref_smc_decode(params, jcfg, jnp.asarray(prompt), RefSMC(**knobs),
                          key=key)
    drops = []
    apply = tmoe.apply_moe

    def recording(p, x, cfg, groups=1):
        out, aux = apply(p, x, cfg, groups)
        if x.shape[1] == 1:                       # a decode step
            assert groups == 2
            drops.append(float(aux["moe_drop_frac"].max()))
        return out, aux

    monkeypatch.setattr(tmoe, "apply_moe", recording)
    draws = [ReplayDraws(d) for d in
             smc_decode_draws(key, 2, 16, jcfg.vocab_size, 6)]
    got = smc_decode(model, torch.from_numpy(prompt),
                     SMCDecodeConfig(**knobs), key=draws, device="cpu")
    assert all(d.remaining == 0 for d in draws)
    assert max(drops) > 0
    for f in ("sequences", "resampled", "ancestors", "emissions"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("log_weights", "log_z", "ess", "log_marginal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
