"""Training of the M, X, R and D kinds, MoE FFNs with their aux loss and
the codebook head (``repro_torch.models.lm.model.forward_train``,
``repro_torch.train``, ``models.lm.moe``, ``models.lm.rglru``,
``repro_torch.launch.train``) against the live reference on the CPU, at
smoke size.

The weights are drawn with numpy in the reference's ``init_params``
shapes (``kind_params``: N(0, 1/fan_in) matrices, N(0, 0.01) norm gains,
``xattn_gate`` 0.5, so the X layers' leaves get gradient, and the
recurrent blocks' decay leaves about their reference inits); tokens,
targets and image embeddings are numpy draws too.

* For deepseek-v2-236b (M, dense then MoE), moonshot-v1-16b-a3b (G,
  dense then MoE), llama-3.2-vision-11b (G, X), recurrentgemma-2b (R,
  L), mamba2-1.3b (D) and musicgen-medium (4 codebooks), in float32 and
  bfloat16: ``forward_train``'s hidden states (rtol = atol = 1e-4 and
  0.1, tests/test_torch_train.py's ``TOL``), the loss with the MoE aux
  (rtol 1e-5 and 1e-3), the aux values, and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's ``_loss_fn`` (relative L2
  1e-4 and 0.1).  Each MoE layer's expert sets are recorded on both
  sides (``jax.debug.callback`` in a wrapper of the reference's
  ``apply_moe``): in float32 they agree on every token.  In bfloat16 a
  token whose k-th and (k+1)-th router logits nearly tie can take
  another expert (the two frameworks round the router product's inputs
  apart by ~0.03 at smoke width, against a mean gap of ~0.4 between
  those logits of 8 experts: ~3% of (token, layer) pairs).  There every
  flip must be a near tie on the port's side (gap ≤ ``NEAR_TIE``), at
  most ``MAX_FLIPS`` of the pairs flip, the hidden rows of tokens that
  never flipped hold 0.1, and a leaf's gradient holds 0.1 plus twice
  ``sqrt(2 f / (k n))``: f flips each move 2 of a layer's k·n expert
  contributions.
* moonshot's ``_loss_fn`` metrics at the config's capacity factor 1.25
  (tokens dropped) and at E / k (none dropped), with remat on and off
  (the checkpointed layers' recompute adds no aux twice); a
  2-microbatch ``make_train_step`` step of moonshot and of llama-vision
  (its image embeddings split with the rows) against the reference's:
  metrics at rtol 1e-5 (the dropped fraction to 1e-7) and the updated
  weights at tests/test_train.py's rtol 2e-3, atol 2e-5.
* The MoE dispatch and combine ``autograd.Function``s' float64
  gradients against torch's own autograd of the plain indexing they
  replace, with dropped entries and routing groups.
* The out-of-place RG-LRU scan bit for bit the in-place Hillis–Steele
  passes it replaced (the prefill's bits), and its gradient against
  ``jax.grad`` of the reference's ``associative_scan``.
* An X arch without ``img`` raises ``ValueError``, and so does ``img``
  for an arch without cross-attention.
* ``convert.lm_tree``/``lm_named`` round-trip every kind's leaves
  (``xattn_gate``, ``img_proj``, the MLA, MoE, RG-LRU and SSD leaves,
  stacked groups) exactly.
* ``python -m repro_torch.launch.train --smoke --device cpu`` for
  moonshot and llama-vision: 2 steps with checkpoints, then resumed.
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
from repro.models.lm import model as JM
from repro.models.lm import moe as jmoe
from repro.optim import OptConfig as RefOpt
from repro.optim import init_opt_state as ref_init_opt
from repro.train import step as JS
from repro_torch import convert
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm import rglru as trglru
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import step as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.key(0)
ARCHS = ["deepseek-v2-236b", "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
         "recurrentgemma-2b", "mamba2-1.3b", "musicgen-medium"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.1, 0.1)}   # hidden, grads
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
XC = 32                          # loss chunk (T = 64: two chunks)
NEAR_TIE = 0.1                   # router logit gap a bf16 flip may have
MAX_FLIPS = 0.1                  # share of (token, layer) pairs


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    return jcfg, convert.arch_config(dataclasses.asdict(jcfg))


def kind_params(jcfg, seed=0):
    """Numpy weights in the shapes of the reference's ``init_params``
    (``jax.eval_shape``): matrices N(0, 1/fan_in) (the embedding N(0,
    1/D), conv taps N(0, 0.01)), norm gains and biases N(0, 0.01),
    ``xattn_gate`` 0.5, and the decay leaves about their reference
    inits (``lam``, ``a_log``; ``d_skip`` about 1), so every leaf's
    gradient shows."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        last = name.rsplit("['", 1)[-1][:-2]
        shape = leaf.shape
        noise = rng.standard_normal(shape)
        if last == "xattn_gate":
            out = np.full(shape, 0.5)
        elif last == "lam":
            w = shape[-1]
            out = np.log(np.expm1(np.linspace(2.0, 6.0, w))) + 0.1 * noise
        elif last == "a_log":
            out = np.log(np.linspace(1.0, 16.0, shape[-1])) + 0.1 * noise
        elif last == "d_skip":
            out = 1.0 + 0.1 * noise
        elif "norm" in name or last in ("conv_b", "dt_bias"):
            out = 0.1 * noise
        elif last == "conv_w":
            out = 0.1 * noise
        elif name == "['embed']":
            out = shape[-1] ** -0.5 * noise
        else:
            out = shape[-2] ** -0.5 * noise
        return out.astype(np.float32)

    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY)
    return jax.tree_util.tree_map_with_path(draw, shapes)


_PARAMS = {}


def _params(jcfg):
    if jcfg.name not in _PARAMS:
        _PARAMS[jcfg.name] = kind_params(jcfg)
    return _PARAMS[jcfg.name]


def _batch(jcfg, b=2, t=64, seed=7):
    """Numpy tokens and targets ``(b, t[, K])`` and, for a cross-attending
    arch, image embeddings."""
    rng = np.random.default_rng(seed)
    books = (jcfg.n_codebooks,) if jcfg.n_codebooks > 1 else ()
    out = {k: rng.integers(0, jcfg.vocab_size, (b, t) + books).astype(
        np.int32) for k in ("tokens", "targets")}
    if jcfg.cross_attn_every:
        out["image_embeds"] = (0.5 * rng.standard_normal(
            (b, jcfg.n_image_tokens, jcfg.d_image))).astype(np.float32)
    return out


def _pairs(want, got):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(got)
    for (path, w), g in zip(flat, got):
        yield jax.tree_util.keystr(path), np.asarray(w), np.asarray(g)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# forward_train, the loss and every gradient
# ---------------------------------------------------------------------------

def _routes(monkeypatch, jcfg, params, batch, model, tb):
    """Each MoE layer's routes on the reference's forward and the port's,
    ``(L, 2, n, k)``: a token's top-k expert ids and its kept ones (-1
    for an entry dropped at capacity), each sorted; and the port's gap
    between each token's k-th and (k+1)-th router logits."""
    ref_seen, seen, gaps = [], [], []
    ref_moe, port_moe = jmoe.apply_moe, tmoe.apply_moe

    def ref_recording(p, x, cfg):
        n = x.shape[0] * x.shape[1]
        logits = (x.reshape(n, -1) @ p["router"]).astype(jnp.float32)
        eid = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)[1]
        rank = jmoe._rank_within_expert(eid.reshape(-1), eid.size,
                                        cfg.n_experts)
        keep = (rank < jmoe.capacity_for(n, cfg)).reshape(eid.shape)
        jax.debug.callback(lambda e, kept: ref_seen.append(np.sort(
            np.stack([e, kept]), -1)), eid, jnp.where(keep, eid, -1),
            ordered=True)
        return ref_moe(p, x, cfg)

    def port_recording(p, x, cfg, groups=1):
        n = x.shape[0] * x.shape[1]
        logits = (x.reshape(n, -1) @ p["router"]).float()
        top = logits.topk(cfg.top_k + 1, -1).values
        gaps.append((top[:, -2] - top[:, -1]).detach().numpy())
        eid = torch.softmax(logits, -1).topk(cfg.top_k, -1).indices
        rank = tmoe._rank_within_expert(eid.reshape(-1), cfg.n_experts)[0]
        keep = (rank < tmoe.capacity_for(n, cfg)).view(eid.shape)
        seen.append(np.sort(torch.stack([eid, torch.where(keep, eid, -1)])
                            .numpy(), -1))
        return port_moe(p, x, cfg, groups)

    monkeypatch.setattr(jmoe, "apply_moe", ref_recording)
    monkeypatch.setattr(tmoe, "apply_moe", port_recording)
    jax.jit(lambda p, t: JM.forward_train(p, jcfg, t))(params,
                                                       batch["tokens"])
    jax.effects_barrier()
    with torch.no_grad():
        TM.forward_train(model, tb["tokens"])
    monkeypatch.undo()
    return np.stack(ref_seen), np.stack(seen), np.stack(gaps)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_reference(arch, dtype, monkeypatch):
    jcfg, tcfg = _cfgs(arch, compute_dtype=dtype)
    params = _params(jcfg)
    batch = _batch(jcfg)
    tc = JS.TrainConfig(xent_chunk=XC)

    def ref(p, b):
        hidden, aux = JM.forward_train(p, jcfg, b["tokens"],
                                       b.get("image_embeds"))
        loss, met = JS._loss_fn(p, jcfg, tc, b)
        return loss, (hidden, aux, met)

    (want_loss, (want_h, want_aux, want_met)), want_g = jax.jit(
        jax.value_and_grad(ref, has_aux=True))(params, batch)
    model = convert.train_params(params, tcfg)
    tb = _tbatch(batch)
    got_h, aux = TM.forward_train(model, tb["tokens"],
                                  tb.get("image_embeds"))
    h_tol, g_tol = TOL[dtype]
    moe = jcfg.moe is not None
    rows = np.ones(got_h.shape[:2], bool)
    if moe:
        want_r, got_r, gaps = _routes(monkeypatch, jcfg, params, batch,
                                      model, tb)
        choice, flip = (want_r != got_r).any(-1).transpose(1, 0, 2)
        if dtype == "float32":
            assert not flip.any(), np.argwhere(flip)
        # another expert set is a near tie; another entry dropped or kept
        # follows one, later in its expert's queue of the same layer
        assert (gaps[choice] <= NEAR_TIE).all(), gaps[choice]
        assert choice[flip.any(1)].any(1).all()
        assert flip.mean() <= MAX_FLIPS, flip.mean()
        rows = ~flip.any(0).reshape(rows.shape)
        k, n = jcfg.moe.top_k, flip.shape[1]
        g_tol += 2 * np.sqrt(2 * flip.sum() / (k * n))
    np.testing.assert_allclose(got_h.detach().float().numpy()[rows],
                               np.asarray(want_h, np.float32)[rows],
                               rtol=h_tol, atol=h_tol)
    assert sorted(aux) == sorted(want_aux) == (
        ["moe_aux_loss", "moe_drop_frac", "moe_max_load"] if moe else [])
    loss, met = TS._loss_fn(model, tcfg, TS.TrainConfig(xent_chunk=XC), tb)
    assert sorted(met) == sorted(want_met)
    rtol = LOSS_RTOL[dtype]
    for k in want_met:
        np.testing.assert_allclose(float(met[k].detach()),
                                   float(want_met[k]), rtol=rtol,
                                   atol=1e-7 if dtype == "float32" else 1e-2,
                                   err_msg=k)
    if moe:
        assert float(want_met["moe_aux_loss"]) > 0
        np.testing.assert_allclose(
            float(loss.detach()),
            float(met["xent"].detach()) + float(met["moe_aux_loss"].detach()),
            rtol=1e-6)
    loss.backward()
    got_g = convert.lm_tree(tcfg, {n: p.grad for n, p in
                                   model.named_parameters()})
    for name, w, g in _pairs(want_g, got_g):
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        norm = np.linalg.norm(w)
        assert norm > 0, f"{name}: the reference's gradient is zero"
        err = np.linalg.norm(g - w) / norm
        assert err < g_tol, f"{name}: relative L2 {err:.3g}"


# ---------------------------------------------------------------------------
# MoE metrics and microbatched steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drops", [True, False])
def test_moe_loss_metrics_match_reference(drops):
    """moonshot's ``_loss_fn`` metrics at the config's capacity factor
    (tokens dropped) and at E / k (none), with remat on and off."""
    base = get_config("moonshot-v1-16b-a3b", smoke=True)
    cf = base.moe.capacity_factor if drops else (
        base.moe.n_experts / base.moe.top_k)
    moe = dataclasses.replace(base.moe, capacity_factor=cf)
    jcfg, _ = _cfgs("moonshot-v1-16b-a3b", compute_dtype="float32", moe=moe)
    params = _params(jcfg)
    batch = _batch(jcfg, seed=11)
    tc = JS.TrainConfig(xent_chunk=XC)
    _, want = jax.jit(lambda p, b: JS._loss_fn(p, jcfg, tc, b))(params,
                                                               batch)
    drop = float(want["moe_drop_frac"])
    assert (drop > 0.01) if drops else (abs(drop) < 1e-6), drop
    for remat in (True, False):
        _, tcfg = _cfgs("moonshot-v1-16b-a3b", compute_dtype="float32",
                        moe=moe, remat=remat)
        model = convert.train_params(params, tcfg)
        loss, met = TS._loss_fn(model, tcfg, TS.TrainConfig(xent_chunk=XC),
                                _tbatch(batch))
        loss.backward()                # runs the checkpointed recompute
        assert sorted(met) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(met[k].detach()),
                                       float(want[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} {remat}")


STEP_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b"])
def test_microbatched_step_matches_reference(arch):
    """One ``make_train_step`` step in 2 microbatches (float32 compute)
    from the same weights on the same batch: the metrics (a MoE arch's
    averaged aux loss and dropped fraction among them) and the updated
    weights."""
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    params = _params(jcfg)
    batch = jtokens.make_batch(0, 0, jcfg, 4, 32)
    tc = dict(xent_chunk=16, num_microbatches=2)
    step = jax.jit(JS.make_train_step(jcfg, RefOpt(**STEP_KW),
                                      JS.TrainConfig(**tc)))
    want_p, _, want = step(params, ref_init_opt(params), batch)
    model = convert.train_params(params, tcfg)
    state = init_opt_state(model)
    tstep = TS.make_train_step(tcfg, OptConfig(**STEP_KW),
                               TS.TrainConfig(**tc))
    _, _, met = tstep(model, state, _tbatch(batch))
    assert sorted(met) == sorted(want)
    if jcfg.moe:
        assert "moe_drop_frac" in met and "moe_aux_loss" in met
    for k in want:
        np.testing.assert_allclose(float(met[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = convert.lm_tree(tcfg, dict(model.named_parameters()))
    for name, w, g in _pairs(jax.tree_util.tree_map(np.asarray, want_p),
                             got):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the new backwards, alone
# ---------------------------------------------------------------------------

def _plain_moe(p, x, cfg, groups):
    """``apply_moe``'s dispatch and combine as plain indexing (what the
    Functions replace), on the same routing: for torch's own autograd."""
    saved = tmoe._Dispatch.apply, tmoe._Combine.apply

    def dispatch(xf, tok, at, keep, k):
        return torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])[tok]

    def combine(y, at, keep, ent):
        return torch.where(keep[:, None], y[at.clamp(max=y.shape[0] - 1)],
                           0.0)

    tmoe._Dispatch.apply, tmoe._Combine.apply = dispatch, combine
    try:
        return tmoe.apply_moe(p, x, cfg, groups)
    finally:
        tmoe._Dispatch.apply, tmoe._Combine.apply = saved


@pytest.mark.parametrize("cf,groups", [(1.25, 1), (0.5, 1), (0.5, 2),
                                       (4.0, 2)])
def test_moe_dispatch_and_combine_grads(cf, groups):
    """Float64 gradients of ``apply_moe`` (input, router, experts, shared
    MLP) through the gather-backward Functions against torch's autograd
    of plain indexing, at capacities that drop entries and that do not;
    the forward bit for bit."""
    _, tcfg = _cfgs("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    g = torch.Generator().manual_seed(3)
    p = tmoe.moe_params(g, 16, cfg, torch.float64)
    x = torch.randn((4, 12, 16), generator=g, dtype=torch.float64)
    w = torch.randn((4, 12, 16), generator=g, dtype=torch.float64)
    leaves = [x] + [v for v in p.values() if torch.is_tensor(v)] + list(
        p["shared"].values())
    outs = []
    for run in (tmoe.apply_moe, _plain_moe):
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        out, aux = run(p, x, cfg, groups)
        ((out * w).sum() + aux["moe_aux_loss"].sum()).backward()
        outs.append((out.detach(), aux, [t.grad.clone() for t in leaves]))
    (o1, a1, g1), (o2, a2, g2) = outs
    assert torch.equal(o1, o2)
    drop = a1["moe_drop_frac"]
    if cf < 1.0:
        assert bool((drop > 0).all()), drop
    if cf == 4.0:
        assert bool((drop.abs() < 1e-6).all()), drop
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12,
                                   msg=f"leaf {i}")
    assert g1[0].abs().sum() > 0


def _inplace_scan(a, b):
    """The in-place Hillis–Steele passes ``_linear_scan`` ran before it
    became out of place (the prefill's bits)."""
    a, h = a.clone(), b.clone()
    t, s = a.shape[1], 1
    while s < t:
        h[:, s:] = a[:, s:] * h[:, :-s] + h[:, s:]
        a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return h


@pytest.mark.parametrize("t", [1, 2, 7, 64, 100])
def test_rglru_scan_out_of_place_keeps_bits_and_grads(t):
    """The out-of-place scan: bit for bit the in-place passes, and its
    gradient against ``jax.grad`` of the reference's combine under
    ``associative_scan`` (float32, relative L2 1e-5)."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.8, 0.999, (2, t, 8)).astype(np.float32)
    b = rng.standard_normal((2, t, 8)).astype(np.float32)
    w = rng.standard_normal((2, t, 8)).astype(np.float32)
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    h = trglru._linear_scan(ta, tb)
    assert torch.equal(h.detach(), _inplace_scan(_t(a), _t(b)))
    (h * _t(w)).sum().backward()

    def ref(a, b):
        def combine(c1, c2):
            return c1[0] * c2[0], c1[1] * c2[0] + c2[1]
        return jnp.sum(jax.lax.associative_scan(combine, (a, b),
                                                axis=1)[1] * w)

    want = jax.jit(jax.grad(ref, argnums=(0, 1)))(a, b)
    for got, wa in zip((ta.grad, tb.grad), want):
        wa = np.asarray(wa)
        got = np.zeros_like(wa) if got is None else got.numpy()  # T = 1
        err = np.linalg.norm(got - wa) / max(np.linalg.norm(wa), 1e-30)
        assert err < 1e-5, err


# ---------------------------------------------------------------------------
# refusals, conversion, the launcher
# ---------------------------------------------------------------------------

def test_image_embeddings_are_required_exactly_for_x_archs():
    _, tcfg = _cfgs("llama-3.2-vision-11b")
    model = TM.init_train_params(tcfg, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs img"):
        TM.forward_train(model, tokens)
    with pytest.raises(ValueError, match="needs img"):
        TS._loss_fn(model, tcfg, TS.TrainConfig(xent_chunk=8),
                    {"tokens": tokens, "targets": tokens})
    img = torch.zeros((1, tcfg.n_image_tokens, tcfg.d_image))
    h, aux = TM.forward_train(model, tokens, img)
    assert h.shape == (1, 8, tcfg.d_model) and aux == {}
    _, other = _cfgs("stablelm-3b")
    with pytest.raises(ValueError, match="does not cross-attend"):
        TM.forward_train(TM.init_train_params(other, 0, device="cpu"),
                         tokens, img)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_params_round_trip_every_kind(arch):
    """``lm_named`` then ``lm_tree`` gives the reference's pytree back,
    leaf for leaf and bit for bit, through a trainable decoder too."""
    jcfg, tcfg = _cfgs(arch)
    params = _params(jcfg)
    named = convert.lm_named(params)
    model = convert.train_params(params, tcfg)
    assert sorted(named) == sorted(n for n, _ in model.named_parameters())
    for tree in (convert.lm_tree(tcfg, named), convert.lm_tree(
            tcfg, dict(model.named_parameters()))):
        for name, w, g in _pairs(params, tree):
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b"])
def test_launcher_trains_and_resumes(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: 2 steps
    with a checkpoint each, then resumed to step 3 in process; a MoE
    arch prints its aux loss and dropped fraction."""
    from repro_torch.launch import train as launcher
    args = ["--device", "cpu", "--smoke", "--arch", arch, "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args, "--steps", "2"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished 2 steps" in out.stdout
    assert ("moe_drop_frac" in out.stdout) == (arch.startswith("moonshot"))
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
    launcher.main(args + ["--steps", "3"])
    again = capsys.readouterr().out
    assert "resumed step 2" in again and "finished 1 steps" in again
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000003"
