"""The port's training path (``repro_torch.data.tokens``,
``models.lm.layers.chunked_causal_attention``, ``models.lm.model``'s
``forward_train``, ``repro_torch.train``, ``repro_torch.launch.train``)
against the live reference on the CPU, at smoke size.

* ``make_batch`` bit for bit on the reference's own uniforms (replayed
  from its threefry keys and handed in), with the saturating cast: ``u``
  in ``[1e-6, 1.47e-6)`` gives ``vocab - 1``; the port's own draws a pure
  function of ``(seed, step)``.
* ``chunked_xent`` against the reference at T = 13 with chunks 4, 5, 13
  and 64 (tests/test_train.py's cases), float32 and bfloat16 logits, with
  the z-loss: rtol 1e-5 (float32; one float32 product of the same
  operands) and 1e-4 (bf16 logits: a float32 product an ulp apart can
  round to the neighbouring bf16 logit).
* ``chunked_causal_attention`` against the reference's with and without
  a window (sliced keys) and a soft-cap, grouped heads, and non-causal:
  float32 at rtol = atol = 1e-5, bf16 at 2e-2 (bf16 probabilities).
* ``forward_train`` and the gradients of ``_loss_fn`` against
  ``jax.value_and_grad`` of the reference's, for stablelm-3b, qwen3-32b
  and gemma3-27b (L kind, window, tail layers): float32 hidden states at
  rtol = atol = 1e-4 and every leaf's gradient within 1e-4 relative L2
  (measured ≤ 2.3e-6); bfloat16 hidden states at rtol = atol = 0.1
  (values up to ~4, eight layers of bf16 roundings placed differently by
  the two frameworks; measured up to 0.07) and each leaf's gradient
  within 0.1 relative L2 (measured up to 0.047).
* The weights after 3 steps of ``make_train_step`` (float32 compute,
  remat on and off) against the reference's at rtol 2e-3, atol 2e-5
  (tests/test_train.py's bounds), losses at rtol 1e-5.
* ``num_microbatches`` 1 against 4 (the reference's test, on the port),
  the loss-decrease rule on the port's own draws, an atomic checkpoint
  resume that gives the same bits, and the launcher run and resumed.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.configs import get_config
from repro.data import tokens as jtokens
from repro.models.lm import layers as jlayers
from repro.models.lm import model as JM
from repro.optim import OptConfig as RefOpt
from repro.optim import init_opt_state as ref_init_opt
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.data import tokens as ttokens
from repro_torch.launch.train import restore_state, save_state
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as TM
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import step as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.key(0)
ARCHS = ["stablelm-3b", "qwen3-32b", "gemma3-27b"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.1, 0.1)}   # hidden, grads


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    return jcfg, convert.arch_config(dataclasses.asdict(jcfg))


def np_params(jcfg, seed=0):
    """Weights of the reference's ``init_params`` shapes drawn with numpy
    (``jax.eval_shape`` only traces, where compiling the init costs
    seconds): matrices N(0, 1/fan_in) (the embedding N(0, 1/D)), norm
    gains N(0, 0.01), so every gain's gradient shows."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            std = 0.1
        elif name == "['embed']":
            std = leaf.shape[-1] ** -0.5
        else:
            std = leaf.shape[-2] ** -0.5
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY)
    return jax.tree_util.tree_map_with_path(draw, shapes)


_PARAMS = {}


def _np_params(jcfg):
    """``np_params`` of an arch, drawn once a module."""
    if jcfg.name not in _PARAMS:
        _PARAMS[jcfg.name] = np_params(jcfg)
    return _PARAMS[jcfg.name]


def _pairs(want, got):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        yield jax.tree_util.keystr(path), np.asarray(w), np.asarray(g)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

def _ref_uniforms(seed, step, jcfg, batch, seq):
    """The reference's draws for batch (seed, step), replayed from its
    keys (``make_batch``'s splits; ``bernoulli`` is ``uniform < p``)."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_tok, k_rep, k_img = jax.random.split(key, 3)
    shape = ttokens.stream_shape(jcfg, batch, seq)
    out = {"tokens": jax.random.uniform(k_tok, shape, minval=1e-6,
                                        maxval=1.0),
           "repeat": jax.random.uniform(k_rep, shape)}
    if jcfg.cross_attn_every:
        out["image"] = jax.random.normal(
            k_img, (batch, jcfg.n_image_tokens, jcfg.d_image))
    return {k: _t(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", ["qwen3-32b", "musicgen-medium",
                                  "llama-3.2-vision-11b"])
def test_make_batch_bit_for_bit_on_reference_uniforms(arch):
    jcfg, tcfg = _cfgs(arch)
    for seed, step in ((0, 0), (3, 17)):
        want = jtokens.make_batch(seed, step, jcfg, 4, 32)
        u = _ref_uniforms(seed, step, jcfg, 4, 32)
        got = ttokens.make_batch(seed, step, tcfg, 4, 32, device="cpu",
                                 uniforms=u)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        assert got["tokens"].dtype == torch.int32


def test_saturating_cast_gives_the_last_token():
    """u in [1e-6, 2^-19.375) makes u^-1.6 > 2^31: XLA's cast saturates
    and the clip gives vocab - 1 (torch's cast alone would wrap to 0)."""
    _, tcfg = _cfgs("qwen3-32b")
    v = tcfg.vocab_size
    u = np.array([1e-6, 1.2e-6, 1.46e-6, 1.48e-6, 1e-3, 0.5, 0.999999],
                 np.float32)
    want = np.asarray(jnp.clip(jnp.power(jnp.asarray(u), -1.6).astype(
        jnp.int32), 0, v - 1))
    got = ttokens.zipf_tokens(torch.from_numpy(u), v).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:3]) == [v - 1] * 3
    assert torch.tensor(3.9e9).to(torch.int32) < 0      # torch alone wraps


def test_make_batch_is_a_function_of_seed_and_step():
    _, tcfg = _cfgs("qwen3-32b")
    a = ttokens.make_batch(0, 5, tcfg, 4, 32, device="cpu")
    b = ttokens.make_batch(0, 5, tcfg, 4, 32, device="cpu")
    c = ttokens.make_batch(0, 6, tcfg, 4, 32, device="cpu")
    d = ttokens.make_batch(1, 5, tcfg, 4, 32, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"], b["targets"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].shape == a["targets"].shape == (4, 32)
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 256


# ---------------------------------------------------------------------------
# the loss and the attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xent_case():
    jcfg, tcfg = _cfgs("stablelm-3b", compute_dtype="float32")
    params = _np_params(jcfg)
    batch = jtokens.make_batch(0, 0, jcfg, 2, 13)
    hidden, _ = jax.jit(JM.forward_train, static_argnums=1)(
        params, jcfg, batch["tokens"])
    cast = JM.cast_params(params, jcfg)
    model = convert.train_params(params, tcfg)
    return jcfg, tcfg, cast, model, batch, hidden


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_reference(xent_case, logits_dtype):
    jcfg, tcfg, cast, model, batch, hidden = xent_case
    rtol = 1e-5 if logits_dtype == "float32" else 1e-4
    h = _t(hidden).requires_grad_()
    for chunk in (4, 5, 13, 64):   # remainder, remainder, exact, clamp
        want = float(JS.chunked_xent(hidden, cast, jcfg, batch["targets"],
                                     chunk, 1e-4, logits_dtype=logits_dtype))
        got = TS.chunked_xent(h, model, tcfg, _t(batch["targets"]), chunk,
                              1e-4, logits_dtype=logits_dtype)
        np.testing.assert_allclose(float(got.detach()), want, rtol=rtol,
                                   err_msg=f"chunk={chunk}")
    got.backward()
    assert torch.isfinite(h.grad).all() and h.grad.abs().sum() > 0


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (16, 0.0, True), (0, 30.0, True), (8, 30.0, True),
    (0, 0.0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_attention_matches_reference(window, softcap, causal,
                                                    dtype):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 4, 64, 16), (2, 2, 64, 16), (2, 2, 64, 16)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    sdt = tlayers.dtype_of(dtype)
    kw = dict(window=window, chunk=16, softcap=softcap, causal=causal)
    want = jlayers.chunked_causal_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), **kw)
    got = tlayers.chunked_causal_attention(
        *(torch.from_numpy(x).to(sdt) for x in (q, k, v)), **kw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# forward_train and the gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, compute_dtype=dtype)
    params = _np_params(jcfg)
    rng = np.random.default_rng(7)
    toks, tgts = (rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
                  for _ in range(2))
    tc = JS.TrainConfig(xent_chunk=32)

    def ref(p, tokens, targets):
        hidden, _ = JM.forward_train(p, jcfg, tokens)
        loss = JS.chunked_xent(hidden, JM.cast_params(p, jcfg), jcfg,
                               targets, tc.xent_chunk, tc.z_loss)
        return loss, hidden

    (want_loss, want_h), want_g = jax.jit(jax.value_and_grad(
        ref, has_aux=True))(params, toks, tgts)
    model = convert.train_params(params, tcfg)
    got_h, aux = TM.forward_train(model, _t(toks))
    assert aux == {}
    h_tol, g_tol = TOL[dtype]
    np.testing.assert_allclose(got_h.detach().float().numpy(),
                               np.asarray(want_h, np.float32), rtol=h_tol,
                               atol=h_tol)
    loss, met = TS._loss_fn(model, tcfg, TS.TrainConfig(xent_chunk=32),
                            {"tokens": _t(toks), "targets": _t(tgts)})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    loss.backward()
    got_g = convert.lm_tree(tcfg, {n: p.grad for n, p in
                                   model.named_parameters()})
    for name, w, g in _pairs(want_g, got_g):
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err < g_tol, f"{name}: relative L2 {err:.3g}"


def test_serve_steps_wrap_prefill_and_decode():
    """``make_serve_step`` on a trainable decoder: its prefill and decode
    steps are ``forward_prefill`` + ``unembed`` and ``forward_decode`` on
    the serving decoder of the same weights in the compute dtype."""
    jcfg, tcfg = _cfgs("qwen3-32b")
    params = _np_params(jcfg)
    train = convert.train_params(params, tcfg)
    serve = convert.lm_params(params, tcfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 8)))
    prefill = TS.make_serve_step(train, "prefill", max_len=12)
    decode = TS.make_serve_step(train, "decode")
    logits, caches = prefill({"tokens": tokens})
    h, want_caches = TM.forward_prefill(serve, tokens, 12)
    assert torch.equal(logits, TM.unembed(serve, h))
    assert not logits.requires_grad
    nxt = logits.argmax(-1)
    got, caches = decode({"tokens": nxt, "pos": 8, "caches": caches})
    want, _ = TM.forward_decode(serve, nxt, 8, want_caches)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        TS.make_serve_step(train, "train")


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _batches(jcfg, n, b=4, t=32):
    return [jtokens.make_batch(0, s, jcfg, b, t) for s in range(n)]


STEP_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEP_TC = dict(xent_chunk=16, num_microbatches=2)


@pytest.fixture(scope="module")
def ref_three_steps():
    """The reference's three steps (qwen3-32b smoke, float32 compute,
    remat on: its remat recomputes, it changes no value) and their
    metrics, on its own batches."""
    jcfg, _ = _cfgs("qwen3-32b", compute_dtype="float32")
    params = _np_params(jcfg)
    step = jax.jit(JS.make_train_step(jcfg, RefOpt(**STEP_KW),
                                      JS.TrainConfig(**STEP_TC)))
    p, st, mets = params, ref_init_opt(params), []
    batches = _batches(jcfg, 3)
    for batch in batches:
        p, st, met = step(p, st, batch)
        mets.append({k: float(v) for k, v in met.items()})
    return params, batches, jax.tree_util.tree_map(np.asarray, p), mets


@pytest.mark.parametrize("remat", [True, False])
def test_three_train_steps_match_reference(ref_three_steps, remat):
    params, batches, want, want_mets = ref_three_steps
    _, tcfg = _cfgs("qwen3-32b", compute_dtype="float32", remat=remat)
    model = convert.train_params(params, tcfg)
    state = init_opt_state(model)
    tstep = TS.make_train_step(tcfg, OptConfig(**STEP_KW),
                               TS.TrainConfig(**STEP_TC))
    for batch, met in zip(batches, want_mets):
        _, _, tmet = tstep(model, state, {k: _t(v) for k, v in
                                          batch.items()})
        assert sorted(tmet) == sorted(met)
        for k in met:
            np.testing.assert_allclose(float(tmet[k]), met[k], rtol=1e-5,
                                       err_msg=k)
    got = convert.lm_tree(tcfg, dict(model.named_parameters()))
    for name, w, g in _pairs(want, got):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-5, err_msg=name)
    assert int(state["step"]) == 3


def test_grad_accumulation_matches_full_batch():
    """num_microbatches must not change the update (the reference's
    test_grad_accumulation_matches_full_batch, on the port)."""
    _, tcfg = _cfgs("qwen3-32b", compute_dtype="float32", remat=False)
    batch = ttokens.make_batch(0, 0, tcfg, 8, 64, device="cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    outs = {}
    for m in (1, 4):
        model = TM.init_train_params(tcfg, 0, device="cpu")
        step = TS.make_train_step(tcfg, opt, TS.TrainConfig(
            num_microbatches=m, xent_chunk=32))
        _, _, met = step(model, init_opt_state(model), batch)
        outs[m] = (model, float(met["loss"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-4
    for (n, a), b in zip(outs[1][0].named_parameters(),
                         outs[4][0].parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=n)


def test_loss_decreases():
    """The reference's rule (tests/test_train.py::test_loss_decreases) on
    the port's own draws and weights."""
    tcfg = tget("stablelm-3b", smoke=True)
    model = TM.init_train_params(tcfg, 0, device="cpu")
    state = init_opt_state(model)
    step = TS.make_train_step(tcfg, OptConfig(lr=3e-3, warmup_steps=3),
                              TS.TrainConfig(xent_chunk=32))
    losses = []
    for s in range(15):
        batch = ttokens.make_batch(0, s, tcfg, 8, 64, device="cpu")
        _, _, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, losses


def _state_bits(model, state):
    out = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": x.clone() for n, x in state[k].items()})
    return out


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Three uninterrupted steps against two, an atomic checkpoint, a
    reload into fresh tensors and the third: the same bits."""
    tcfg = tget("stablelm-3b", smoke=True)
    step = TS.make_train_step(tcfg, OptConfig(lr=3e-3, warmup_steps=1),
                              TS.TrainConfig(xent_chunk=16))
    batches = [ttokens.make_batch(0, s, tcfg, 4, 32, device="cpu")
               for s in range(3)]
    model = TM.init_train_params(tcfg, 0, device="cpu")
    state = init_opt_state(model)
    for b in batches:
        _, _, met = step(model, state, b)
    want, want_loss = _state_bits(model, state), met["loss"]

    model = TM.init_train_params(tcfg, 0, device="cpu")
    state = init_opt_state(model)
    for b in batches[:2]:
        step(model, state, b)
    save_state(str(tmp_path), 2, model, state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    fresh = TM.init_train_params(tcfg, 1, device="cpu")
    fresh_state = init_opt_state(fresh)
    restore_state(str(tmp_path), 2, fresh, fresh_state)
    assert int(fresh_state["step"]) == 2
    _, _, met = step(fresh, fresh_state, batches[2])
    assert torch.equal(met["loss"], want_loss)
    got = _state_bits(fresh, fresh_state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --smoke --steps 4``
    with a checkpoint directory, then resumed to step 6 (in process)."""
    from repro_torch.launch import train as launcher
    args = ["--device", "cpu", "--smoke", "--arch", "stablelm-3b",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args, "--steps", "4"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished 4 steps" in out.stdout and "resumed" not in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    launcher.main(args + ["--steps", "6"])
    again = capsys.readouterr().out
    assert "resumed step 4" in again and "finished 2 steps" in again
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000006"
