"""The sharded LM over a ``(2, 2)`` ``(data, model)`` process grid (four
gloo ranks spawned once by ``launch.mesh.spawn`` for every case) against
the reference computed live.

* A train step for qwen3-32b, stablelm-3b, gemma3-27b (L kind, tied
  embeddings) and moonshot-v1-16b-a3b (MoE, its config's ``"xla"``
  dispatch) at smoke size in float32: FSDP over ``data``, TP over
  ``model`` (column- and row-parallel products, heads, the vocabulary of
  the embedding and the loss), against the reference's
  ``make_train_step`` under ``mesh_context`` of a ``(2, 2)`` host mesh
  (``tests/lm_grid_ref.py``, a subprocess run while the ranks run):
  metrics at rtol 1e-5, weights at rtol 2e-3, atol 2e-5
  (``tests/test_torch_train.py``'s bounds); the gradients against the
  port's own on one device within 1e-5 relative L2.
* ``make_serve_step`` prefill and greedy decode on the grid against the
  port's one-device steps: logits at rtol = atol = 1e-4 (float32), the
  same tokens, the caches holding each rank's rows and key/value heads.
* ``moe.apply_moe_ep`` with ``ep_reduce`` ``"psum"`` and ``"rs_ag"``
  against the reference's ``apply_moe_ep`` on the same host mesh: each
  shard's slots, keeps and loads exactly (the reference's routing of that
  shard's tokens at its per-shard capacity; capacity factor 0.5, so
  tokens drop); the output, aux values and
  the gradients of ``sum(out · cotangent) + aux loss`` at float32
  tolerance.  ``apply_moe_global`` against the reference's one-device
  ``apply_moe`` (GSPMD's global routing) and its gradients, the
  reference jitted in the subprocess.
* Elastic resume: a checkpoint written on ``(2, 2)`` restores onto a
  ``(4,)`` grid and onto one device with every full tensor the same
  bits.
* The raises: the M, X, R and D kinds over a ``model`` axis, key/value
  heads that ``model`` does not divide (qwen3's smoke config at 4), a
  decoder's blocks for another grid.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_grid_archs import cells, check_train, port_case, run_both

from repro.configs import get_config
from repro.models.lm import moe as JMOE
from repro_torch import convert
from repro_torch.configs.base import MoEConfig
from repro_torch.core.runtime import make_mesh
from repro_torch.launch import lm_grid, sharding
from repro_torch.launch.train import restore_state
from repro_torch.models.lm import model as TM
from repro_torch.optim import init_opt_state
from repro_torch.train import step as TS

GRID = dict(shape=(2, 2), names=("data", "model"))
TRAIN_ARCHS = ["qwen3-32b", "stablelm-3b", "gemma3-27b",
               "moonshot-v1-16b-a3b"]
SERVE_ARCHS = ["qwen3-32b", "gemma3-27b"]
MOE = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
           capacity_factor=0.5)


def _moe_inputs(seed=11):
    rng = np.random.default_rng(seed)
    d, e, f = 64, MOE["n_experts"], MOE["d_ff_expert"]

    def w(*shape):
        return (shape[-2] ** -0.5 * rng.standard_normal(shape)).astype(
            np.float32)

    weights = {"router": w(d, e), "we_gate": w(e, d, f), "we_up": w(e, d, f),
               "we_down": w(e, f, d),
               "shared": {"w_gate": w(d, f), "w_up": w(d, f),
                          "w_down": w(f, d)}}
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    cot = rng.standard_normal((4, 16, d)).astype(np.float32)
    return x, weights, cot


def _serve_case(arch, seed):
    jcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32")
    from test_torch_train_kinds import kind_params
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int64)
    return {"fn": "serve", "cfg": convert.arch_config(
        dataclasses.asdict(jcfg)), "params": kind_params(jcfg),
        "tokens": tokens, "steps": 4, **GRID}


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Every case of the module on one spawn of four ranks, the reference's
    cells in a subprocess meanwhile; the last two cases write a checkpoint
    on (2, 2) and restore it on a (4,) grid of the same ranks."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    ref_cells = cells((2, 2), TRAIN_ARCHS)
    x, weights, cot = _moe_inputs()
    for reduce in ("psum", "rs_ag"):
        ref_cells.append({"kind": "moe_ep", "shape": (2, 2),
                          "names": ("data", "model"), "x": x,
                          "weights": weights, "cotangent": cot,
                          "moe": dict(MOE, dispatch="ep_shardmap",
                                      ep_reduce=reduce)})
    ref_cells.append({"kind": "moe_global", "x": x, "weights": weights,
                      "cotangent": cot, "moe": MOE})
    cases = [port_case(c) for c in ref_cells[:len(TRAIN_ARCHS)]]
    for reduce in ("psum", "rs_ag"):
        cases.append({"fn": "moe", "x": x, "weights": weights,
                      "cotangent": cot, "dispatch": "ep",
                      "moe": MoEConfig(**MOE, dispatch="ep_shardmap",
                                       ep_reduce=reduce), **GRID})
    cases.append({"fn": "moe", "x": x, "weights": weights, "cotangent": cot,
                  "dispatch": "global", "moe": MoEConfig(**MOE), **GRID})
    cases += [_serve_case(a, i) for i, a in enumerate(SERVE_ARCHS)]
    stable = ref_cells[1]
    cases.append(dict(port_case(stable), batches=stable["batches"] * 2,
                      ckpt=(ckpt, 2), grads=False))
    cases.append({"fn": "restore", "cfg": cases[-1]["cfg"], "ckpt": (ckpt, 2),
                  "shape": (4,), "names": ("data",)})
    ref, ranks = run_both(ref_cells, cases, 4)
    return ref_cells, ref, ranks, ckpt


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_over_grid_matches_reference(grid_runs, arch):
    ref_cells, ref, ranks, *_ = grid_runs
    i = TRAIN_ARCHS.index(arch)
    check_train(ref[i], ranks[0][i], ref_cells[i])
    for r in range(1, 4):
        assert ranks[r][i]["metrics"] == ranks[0][i]["metrics"]


def _ref_routing(x, router, cfg_fields, shards):
    """Each data shard's routing as the reference's ``apply_moe_ep`` does
    it: its tokens' top-k experts ranked within each expert's queue, kept
    below the per-shard capacity."""
    cfg = JMOE.MoEConfig(**cfg_fields)
    out = []
    for xs in np.split(x, shards):
        xf = jnp.asarray(xs.reshape(-1, xs.shape[-1]))
        n = xf.shape[0]
        cap = JMOE.capacity_for(n, cfg)
        probs = jax.nn.softmax((xf @ router).astype(jnp.float32), -1)
        _, eid = jax.lax.top_k(probs, cfg.top_k)
        flat = eid.reshape(-1)
        rank = JMOE._rank_within_expert(flat, n * cfg.top_k, cfg.n_experts)
        keep = rank < cap
        out.append({"slot": np.asarray(jnp.where(keep, rank, cap)),
                    "keep": np.asarray(keep), "capacity": cap,
                    "load": np.bincount(np.asarray(flat),
                                        minlength=cfg.n_experts)})
    return out


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-5, err_msg=name)


def _check_moe_grads(res, want_gx, want_grads):
    _close(res["grad_x"], want_gx, "grad x")
    for k, v in want_grads.items():
        if isinstance(v, dict):
            for j, w in v.items():
                _close(res["grads"][f"moe.{k}.{j}"], w, f"grad {k}.{j}")
        else:
            _close(res["grads"][f"moe.{k}"], v, f"grad {k}")


@pytest.mark.parametrize("reduce", ["psum", "rs_ag"])
def test_apply_moe_ep_matches_reference(grid_runs, reduce):
    ref_cells, ref, ranks, *_ = grid_runs
    i = len(TRAIN_ARCHS) + ["psum", "rs_ag"].index(reduce)
    cell = ref_cells[i]
    want = ref[i]
    routing = _ref_routing(cell["x"], cell["weights"]["router"], MOE, 2)
    saw_drop = False
    for r, rank in enumerate(ranks):
        res = rank[i]
        shard = routing[r // 2]              # rank (d, m): data shard d
        rec = res["record"]
        assert rec["capacity"] == shard["capacity"]
        np.testing.assert_array_equal(rec["slot"].numpy(), shard["slot"])
        np.testing.assert_array_equal(rec["keep"].numpy(), shard["keep"])
        np.testing.assert_array_equal(rec["load"].numpy(), shard["load"])
        saw_drop |= not shard["keep"].all()
        _close(res["out"], want["out"], "out")
        for k in ("moe_aux_loss", "moe_drop_frac"):
            _close(res["aux"][k], want["aux"][k], k)
        assert int(res["aux"]["moe_max_load"]) == int(
            want["aux"]["moe_max_load"])
        _check_moe_grads(res, want["grad_x"], want["grads"])
    assert saw_drop                          # the capacity binds


def test_apply_moe_global_matches_reference_apply_moe(grid_runs):
    """dispatch "xla" on the grid routes the global tokens at the global
    capacity: the reference's one-device ``apply_moe`` (GSPMD's
    semantics), its output, aux values and gradients."""
    _, ref, ranks, *_ = grid_runs
    i = len(TRAIN_ARCHS) + 2
    want = ref[i]
    for rank in ranks:
        res = rank[i]
        _close(res["out"], want["out"], "out")
        for k in ("moe_aux_loss", "moe_drop_frac"):
            _close(res["aux"][k], want["aux"][k], k)
        assert int(res["aux"]["moe_max_load"]) == int(
            want["aux"]["moe_max_load"])
        _check_moe_grads(res, want["grad_x"], want["grads"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_steps_over_grid_match_one_device(grid_runs, arch):
    _, _, ranks, *_ = grid_runs
    i = len(TRAIN_ARCHS) + 3 + SERVE_ARCHS.index(arch)
    case = _serve_case(arch, SERVE_ARCHS.index(arch))
    model = convert.lm_params(case["params"], case["cfg"])
    want = lm_grid.greedy(TS.make_serve_step(model, "prefill",
                                             12 + case["steps"]),
                          TS.make_serve_step(model, "decode"),
                          torch.from_numpy(case["tokens"]), case["steps"],
                          torch.device("cpu"))
    hkv = case["cfg"].n_kv_heads
    for rank in ranks:
        res = rank[i]
        for g, w in zip(res["logits"], want["logits"], strict=True):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        for g, w in zip(res["tokens"], want["tokens"], strict=True):
            assert torch.equal(g, w)
        assert res["cache_shape"] == (2, hkv // 2, 16, 16)
        assert res["plain_calls"] > 0 and res["launches"] == 0   # the CPU


def test_elastic_resume_onto_a_line_and_one_device(grid_runs):
    """The (2, 2) run's checkpoint at step 2 restores onto (4,) and onto
    one device with its full tensors' bits: the weights the (2, 2) run
    gathered, and both moments."""
    ref_cells, _, ranks, ckpt = grid_runs
    saved = ranks[0][-2]["params"]
    got = ranks[0][-1]
    assert got["step"] == 2
    assert sorted(got["params"]) == sorted(saved)
    for n, w in saved.items():
        assert torch.equal(got["params"][n], w), n
    tcfg = convert.arch_config(ref_cells[1]["fields"])
    model = TM.init_train_params(tcfg, 3, device="cpu")
    state = init_opt_state(model)
    restore_state(ckpt, 2, model, state)
    assert int(state["step"]) == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
        for k in ("m", "v"):
            assert torch.equal(state[k][n], got[k][n]), (k, n)


@pytest.mark.parametrize("arch,shape,match", [
    ("deepseek-v2-236b", (2, 2), "A13 part b"),
    ("recurrentgemma-2b", (1, 2), "A13 part b"),
    ("mamba2-1.3b", (2, 2), "A13 part b"),
    ("llama-3.2-vision-11b", (1, 2), "A13 part b"),
    ("qwen3-32b", (1, 4), "A13 part b"),
])
def test_unsupported_layouts_raise_before_any_work(arch, shape, match):
    """A kind other than G and L over a ``model`` axis, or key/value heads
    the axis does not divide (qwen3's 2 over 4: its 32 columns would
    split 8 a rank), raise ``ValueError`` before a weight is drawn; over a
    data axis alone every arch builds."""
    from repro_torch.configs import get_config as tget
    cfg = tget(arch, smoke=True)
    grid = make_mesh(shape, ("data", "model"))
    with pytest.raises(ValueError, match=match):
        sharding.check_supported(cfg, grid)
    with pytest.raises(ValueError, match=match):
        TM.shard_params(cfg, 0, device="cpu", grid=grid, coords=(0, 0))
    line = make_mesh((2,), ("data",))
    sharding.check_supported(cfg, line)
    TM.shard_params(cfg, 0, device="meta", grid=line, coords=(1,))


def test_blocks_for_another_grid_raise():
    """A rank's decoder runs under its own grid only, and a one-device
    decoder under none."""
    from repro_torch.configs import get_config as tget
    cfg = tget("stablelm-3b", smoke=True)
    one = TM.init_train_params(cfg, 0, device="cpu")
    grid = make_mesh((2,), ("data",))
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with sharding.mesh_context(grid), pytest.raises(ValueError,
                                                    match="one device"):
        TM.forward_train(one, tokens)
    part = TM.shard_params(cfg, 0, device="cpu", grid=grid, coords=(0,),
                           dtype=torch.float32)
    with sharding.mesh_context(make_mesh((4,), ("data",))), \
            pytest.raises(ValueError, match="blocks for"):
        TM.forward_train(part, tokens)
    assert tuple(part.embed.shape) == (256, 32)


def test_checkpoint_writes_full_tensors(grid_runs):
    """The grid's checkpoint, each rank writing its blocks, holds full
    tensors by name, as a one-device checkpoint does (the layout does not
    depend on the grid)."""
    *_, ckpt = grid_runs
    names = sorted(os.listdir(os.path.join(ckpt, "step_00000002")))
    assert "manifest.json" in names
    arr = np.load(os.path.join(ckpt, "step_00000002",
                               "params__embed.npy"))
    assert arr.shape == (256, 64)


def test_rank_decoders_cut_the_same_weights():
    """A rank's decoder drawn a layer at a time (``shard_params``), cut
    from the port's full tensors (``shard_decoder``) and cut from the
    reference's numpy weights (``convert.lm_params(grid=)``) hold the
    same blocks, bit for bit, and the four ranks' blocks tile every full
    weight of a ``(2, 2)`` grid."""
    from repro_torch.configs import get_config as tget
    from test_torch_train_kinds import kind_params
    cfg = tget("qwen3-32b", smoke=True)
    full = TM.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    grid = make_mesh((2, 2), ("data", "model"))
    jcfg = get_config("qwen3-32b", smoke=True)
    params_np = kind_params(jcfg)
    named_np = convert.lm_named(params_np)
    seen = {n: torch.zeros_like(p) for n, p in full.named_parameters()}
    for coords in np.ndindex(2, 2):
        drawn = TM.shard_params(cfg, 0, device="cpu", grid=grid,
                                coords=coords, dtype=torch.float32)
        cut = TM.shard_decoder(full, grid, coords)
        ref = convert.lm_params(params_np, cfg, dtype=torch.float32,
                                grid=grid, coords=coords)
        assert drawn.shard_specs == cut.shard_specs == ref.shard_specs
        for (n, a), b, r in zip(drawn.named_parameters(),
                                cut.parameters(), ref.parameters()):
            assert torch.equal(a, b), n
            sl = sharding.block_slices(drawn.shard_specs[n],
                                       tuple(seen[n].shape), grid, coords)
            np.testing.assert_array_equal(r.numpy(), named_np[n][sl])
            seen[n][sl] += 1
    for n, count in seen.items():
        spec = sharding.make_param_shardings(grid, full)[n]
        copies = 4 // math.prod(
            grid.shape[a] for e in spec for a in sharding.axes_of(e))
        assert bool((count == copies).all()), n
