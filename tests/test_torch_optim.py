"""The port's AdamW (``repro_torch.optim``) against the reference's
``repro.optim`` on the CPU.

* ``learning_rate`` at every schedule, step by step, at rtol 1e-6 (both
  compute in float32; the cosine's last bit may differ between XLA's and
  torch's ``cos``).
* ``adamw_update`` over three steps on gemma3-27b's smoke weights (a
  scanned group of six layers and an unrolled tail of two, so both sides
  of the decay rule show), drawn with numpy in the reference's pytree and
  converted, norm gains non-zero, with numpy gradients: weights at rtol
  1e-5, atol 1e-7 and moments at rtol 1e-5, atol 1e-6 of the leaf's
  largest moment with float32 moments (the same float32 operations; only
  fused multiply-adds may round apart, and ``b1·m + (1-b1)·g`` cancels to
  small moments whose rounding is that of their terms), and with
  bfloat16 moments at rtol 2^-7 and atol 2^-8 of the leaf's largest
  moment (a float32 value a rounding apart can round to the neighbouring
  bf16 value, and a cancelled moment carries its terms' bf16 rounding)
  and atol 1e-5 on the weights (such a moment moves the next update by
  2^-8 of lr).
* The decay set leaf by leaf: with zero gradients a step moves exactly
  the decayed leaves, and the port moves the reference's set: every leaf
  of the scanned group (its ``pre_norm`` and qk-norm gains included) and
  the matrices, not the tail's gains or ``final_norm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_train import np_params

from repro.configs import get_config
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import optim as topt

ARCH = "gemma3-27b"
NAMES = ("cosine", "linear", "constant")


@pytest.mark.parametrize("schedule", NAMES)
def test_learning_rate_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=110, schedule=schedule,
              min_lr_frac=0.1)
    steps = np.arange(0, 130)
    want = np.asarray(jax.vmap(lambda s: jadamw.learning_rate(
        jadamw.OptConfig(**kw), s))(jnp.asarray(steps)))
    got = np.array([float(topt.learning_rate(topt.OptConfig(**kw),
                                             torch.tensor(s)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(topt.learning_rate(topt.OptConfig(**kw), 0)) == 0.0


@pytest.fixture(scope="module")
def setup():
    """Smoke weights of the reference's shapes with non-zero norm gains,
    three steps of numpy gradients, and the port's config."""
    jcfg = get_config(ARCH, smoke=True)
    params = np_params(jcfg)
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda x: (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        params) for _ in range(3)]
    return jcfg, convert.arch_config(dataclasses.asdict(jcfg)), params, grads


def _ref_steps(params, grads, opt):
    state = jadamw.init_opt_state(params, opt.moment_dtype)
    step = jax.jit(lambda g, s, p: jadamw.adamw_update(g, s, p, opt))
    p, stats = params, []
    for g in grads:
        p, state, st = step(g, state, p)
        stats.append({k: float(v) for k, v in st.items()})
    return (jax.tree_util.tree_map(np.asarray, p),
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   state), stats)


def _port_steps(tcfg, params, grads, opt):
    model = convert.train_params(params, tcfg)
    state = topt.init_opt_state(model, opt.moment_dtype)
    stats = []
    for g in grads:
        named = {n: torch.from_numpy(x)
                 for n, x in convert.lm_named(g).items()}
        _, _, st = topt.adamw_update(named, state, model, opt)
        stats.append({k: float(v) for k, v in st.items()})
    return model, state, stats


def _pairs(want, got):
    """(path, want, got) over two pytrees of the same structure."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        yield jax.tree_util.keystr(path), np.asarray(w), np.asarray(g)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(setup, moments):
    jcfg, tcfg, params, grads = setup
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, moment_dtype=moments)
    want_p, want_s, want_stats = _ref_steps(params, grads,
                                            jadamw.OptConfig(**kw))
    model, state, stats = _port_steps(tcfg, params, grads,
                                      topt.OptConfig(**kw))
    assert model.embed.dtype == torch.float32
    assert all(x.dtype == getattr(torch, moments)
               for x in (state["m"]["embed"], state["v"]["embed"]))
    assert int(state["step"]) == 3 == int(want_s["step"])
    for a, b in zip(stats, want_stats):
        for k in ("grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    p_atol = 1e-7 if moments == "float32" else 1e-5
    m_rtol, m_atol = (1e-5, 1e-6) if moments == "float32" else (2.0 ** -7,
                                                                 2.0 ** -8)
    got_p = convert.lm_tree(tcfg, dict(model.named_parameters()))
    for name, w, g in _pairs(want_p, got_p):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=p_atol,
                                   err_msg=name)
    got_s = convert.opt_state_to_numpy(state, tcfg)
    for k in ("m", "v"):
        for name, w, g in _pairs(want_s[k], got_s[k]):
            np.testing.assert_allclose(g, w, rtol=m_rtol,
                                       atol=m_atol * np.abs(w).max(),
                                       err_msg=f"{k} {name}")
    # the state crosses both ways: the reference's as the port's, and back
    back = convert.opt_state(got_s, tcfg)
    assert int(back["step"]) == 3
    for k in ("m", "v"):
        assert back[k].keys() == state[k].keys()
        assert all(torch.equal(back[k][n].float(), state[k][n].float())
                   for n in state[k])


def test_decay_set_is_the_references(setup):
    """Zero gradients: a step moves a leaf by -lr·wd·p exactly when it is
    decayed.  The port moves the reference's leaves, among them the
    scanned group's ``pre_norm`` and qk-norm gains; the tail's gains and
    ``final_norm`` stay."""
    jcfg, tcfg, params, _ = setup
    zeros = [jax.tree_util.tree_map(np.zeros_like, params)]
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    want_p, _, _ = _ref_steps(params, zeros, jadamw.OptConfig(**kw))
    model, _, _ = _port_steps(tcfg, params, zeros, topt.OptConfig(**kw))
    got_p = convert.lm_tree(tcfg, dict(model.named_parameters()))
    moved_ref, moved_port = set(), set()
    for (name, w, g), (_, p0, _) in zip(_pairs(want_p, got_p),
                                        _pairs(params, params)):
        if not np.array_equal(w, p0):
            moved_ref.add(name)
        if not np.array_equal(g, p0):
            moved_port.add(name)
    assert moved_port == moved_ref
    group = "['blocks']['l0_L_dense']"
    for leaf in ("['pre_norm']", "['ffn_norm']", "['attn']['q_norm']",
                 "['attn']['k_norm']", "['attn']['wq']", "['mlp']['w_up']"):
        assert group + leaf in moved_ref, leaf
    for name in ("['tail_blocks'][0]['pre_norm']",
                 "['tail_blocks'][1]['attn']['k_norm']", "['final_norm']"):
        assert name not in moved_ref, name
    assert "['tail_blocks'][0]['attn']['wq']" in moved_ref
    # the port reads the rank each leaf has in the reference's pytree
    ndims = model.reference_ndims()
    assert ndims["blocks.0.pre_norm"] == 2 and ndims["blocks.6.pre_norm"] == 1
    assert ndims["blocks.6.attn.wq"] == 2 and ndims["final_norm"] == 1
