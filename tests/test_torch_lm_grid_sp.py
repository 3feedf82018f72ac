"""Heads that ``model`` does not divide, the sequence-parallel decode and
``check_supported`` after ROADMAP A13 part b (items a and b):

* ``launch.sharding.check_supported`` passes every registered arch's
  full config on ``(2, 2)``, ``(1, 2)``, ``(1, 4)`` and the reference's
  production ``(16, 16)``, except item c's cases (mamba2's vocabulary of
  50280 over 16), which raise naming "ROADMAP A13 part b item c".
* A train step on a ``(1, 4)`` ``(data, model)`` grid (four gloo ranks)
  against the reference's ``make_train_step`` under ``mesh_context`` of a
  ``(1, 4)`` host mesh (``tests/lm_grid_ref.py``, one subprocess for the
  file's cells, run while the ranks run), at ``tests/test_torch_train.py``'s
  bounds, and the gradients against the port's own on one device within
  1e-5 relative L2: recurrentgemma-2b with 10 query heads
  (``dataclasses.replace`` on both sides; the full config's 10 over 4)
  and its one key/value head; qwen3-32b with 10 query and 5 key/value
  heads (qk-norm, and ranks whose query heads read their key/value heads
  unevenly); granite-34b with 2 query heads, so that two of the four
  ranks hold none (their collectives still run, forward and backward).
* Serving over ``(1, 4)`` against the port's one-device steps (logits at
  rtol = atol = 1e-4, the same tokens): granite-34b's one key/value head
  and the 10/5 qwen3 (their caches laid by length, the decode a
  flash-decode over the shards), recurrentgemma with 10 query heads and a
  prompt past its window (16 at smoke size: shards wholly before the
  window contribute nothing), deepseek's latent cache by length (the
  absorbed decode over the shards), the 2-head granite; every rank's
  cache leaves against
  the reference's ``_cache_leaf_spec`` blocks (an ``AbstractMesh`` stands
  in for the devices), the R and D conv caches holding the rank's
  channels and the X image caches the key/value heads its query heads
  read.
* The plain B6 partials (``ref.attention_lse_ref``) over key shards,
  combined by ``ops.combine_partials``, against whole attention at
  ``ATTN_TOL``'s float32 2e-5, a shard with no visible key included.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from test_torch_lm_grid_archs import OPT, TC, check_train, port_case, \
    run_both
from test_torch_train_kinds import kind_params

from repro.configs import get_config, list_archs
from repro.data import tokens as jtokens
from repro.launch import specs as jspecs
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.core.runtime import make_mesh
from repro_torch.kernels import ops, ref
from repro_torch.launch import lm_grid, sharding
from repro_torch.models.lm import model as TM
from repro_torch.train import step as TS

GRID = (1, 4)
NAMES = ("data", "model")
# the module's one-device comparisons run on ``THREADS`` torch threads
# (``few_threads``; its grid runs on ``run_both``'s cores), so the file
# never takes the machine from the other test files running beside it
# (timing-sensitive ones among them)
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The module's torch ops in this process on THREADS threads."""
    held = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(held)
# (arch, fields replaced on both sides): query heads 4 does not divide;
# granite's 2 query heads leave ranks 0 and 2 with none
UNDIVIDED = [("recurrentgemma-2b", {"n_heads": 10}),
             ("qwen3-32b", {"n_heads": 10, "n_kv_heads": 5}),
             ("granite-34b", {"n_heads": 2})]
# (arch, fields, prompt length, steps)
SERVES = [("granite-34b", {}, 12, 4),
          ("qwen3-32b", {"n_heads": 10, "n_kv_heads": 5}, 12, 4),
          ("recurrentgemma-2b", {"n_heads": 10}, 40, 4),
          ("deepseek-v2-236b", {}, 12, 4),
          ("granite-34b", {"n_heads": 2}, 12, 4)]


def _label(arch, fields):
    return arch + "".join(f"-{k}{v}" for k, v in fields.items())


def _jcfg(arch, fields=None):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32", **(fields or {}))


def serve_case(arch, seed, shape, t, steps, fields=None):
    """A serve case of the arch's smoke model (``kind_params`` weights,
    float32) on ``shape``: 4 prompts of ``t`` tokens (and image
    embeddings), ``steps`` greedy positions, a cache of ``t + steps``
    slots, which ``model`` divides."""
    jcfg = _jcfg(arch, fields)
    rng = np.random.default_rng(seed)
    lead = (4, t, jcfg.n_codebooks) if jcfg.n_codebooks > 1 else (4, t)
    img = None
    if jcfg.cross_attn_every:
        img = rng.standard_normal((4, jcfg.n_image_tokens, jcfg.d_image)
                                  ).astype(np.float32)
    return {"fn": "serve", "cfg": convert.arch_config(
        dataclasses.asdict(jcfg)), "params": kind_params(jcfg, seed),
        "tokens": rng.integers(0, jcfg.vocab_size, lead).astype(np.int64),
        "img": img, "steps": steps, "max_len": t + steps, "shape": shape,
        "names": NAMES[:len(shape)]}


def check_serve(case, ranks):
    """Every rank's logits and tokens against the port's one-device
    serve steps of the same weights."""
    model = convert.lm_params(case["params"], case["cfg"])
    img = None if case["img"] is None else torch.from_numpy(case["img"])
    want = lm_grid.greedy(TS.make_serve_step(model, "prefill",
                                             case["max_len"]),
                          TS.make_serve_step(model, "decode"),
                          torch.from_numpy(case["tokens"]), case["steps"],
                          torch.device("cpu"), img=img)
    for res in ranks:
        for g, w in zip(res["logits"], want["logits"], strict=True):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        for g, w in zip(res["tokens"], want["tokens"], strict=True):
            assert torch.equal(g, w)
        assert res["launches"] == 0 and res["partial_launches"] == 0


def check_caches(case, ranks):
    """Every rank's cache leaves in the reference's ``_cache_leaf_spec``
    blocks of the global caches (``model.init_caches`` on one device:
    the reference's shapes, ``tests/test_torch_sharding.py``): the block
    a spec gives, except the R and D conv caches (the rank's channels,
    where the reference replicates them) and the X image caches of heads
    ``model`` does not divide (the key/value heads the rank reads)."""
    tcfg = case["cfg"]
    jcfg = _jcfg(tcfg.name, {k: getattr(tcfg, k)
                             for k in ("n_heads", "n_kv_heads", "n_layers")})
    shape = tuple(case["shape"])
    mesh = AbstractMesh(shape, NAMES[:len(shape)])
    grid = make_mesh(shape, NAMES[:len(shape)])
    m = grid.shape.get("model", 1)
    full = TM.init_caches(tcfg, 4, case["max_len"], device="meta",
                          dtype=torch.float32)
    kinds = [k for k, _ in TM.make_plan(tcfg).layers()]
    for r, res in enumerate(ranks):
        for kind, whole, got in zip(kinds, full, res["cache_shapes"],
                                    strict=True):
            assert sorted(got) == sorted(whole)
            for name, leaf in whole.items():
                spec = tuple(jspecs._cache_leaf_spec(name, leaf.shape, jcfg,
                                                     mesh))
                spec += (None,) * (leaf.dim() - len(spec))
                want = [d // math.prod(mesh.shape[a] for a in
                                       sharding.axes_of(e))
                        for d, e in zip(leaf.shape, spec)]
                if name == "conv":
                    want[-1] = (leaf.shape[-1] // m if kind == "R"
                                else _ssd_channels(tcfg, m))
                if name in ("xk", "xv") and tcfg.n_kv_heads % m:
                    h0, h1 = sharding.head_range(tcfg.n_heads, _At(grid, r))
                    g = tcfg.n_heads // tcfg.n_kv_heads
                    want[1] = (h1 - 1) // g + 1 - h0 // g
                assert got[name] == tuple(want), (kind, name, r)


class _At:
    """The grid seen from the rank at ``rank`` (its coordinates)."""

    def __init__(self, grid, rank):
        self.shape, self.axis_names = grid.shape, grid.axis_names
        self.coords = tuple(np.unravel_index(rank, tuple(grid.shape.values())))


def _ssd_channels(cfg, m):
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim // m
    return heads * s.head_dim + 2 * s.n_groups * s.state_dim


def _train_cells():
    out = []
    for arch, fields in UNDIVIDED:
        jcfg = _jcfg(arch, fields)
        batch = jtokens.make_batch(0, 0, jcfg, 4, 32)
        out.append({"kind": "train", "arch": arch,
                    "fields": dataclasses.asdict(jcfg), "shape": GRID,
                    "names": NAMES, "params": kind_params(jcfg),
                    "batches": [{k: np.asarray(v) for k, v in
                                 batch.items()}], "opt": OPT, "tc": TC})
    return out


@pytest.fixture(scope="module")
def sp_runs():
    """The reference's (1, 4) train cells in a subprocess while four ranks
    run the train and serve cases."""
    ref_cells = _train_cells()
    serves = [serve_case(a, 20 + i, GRID, t, n, f)
              for i, (a, f, t, n) in enumerate(SERVES)]
    cases = [port_case(c) for c in ref_cells] + serves
    got, ranks = run_both(ref_cells, cases, 4)
    return ref_cells, got, ranks, serves


@pytest.mark.parametrize("label", [_label(*c) for c in UNDIVIDED])
def test_undivided_heads_train_step_matches_reference(sp_runs, label):
    ref_cells, want, ranks, _ = sp_runs
    i = [_label(*c) for c in UNDIVIDED].index(label)
    assert ref_cells[i]["fields"]["n_heads"] % GRID[1]
    check_train(want[i], ranks[0][i], ref_cells[i])
    for r in range(1, 4):
        assert ranks[r][i]["metrics"] == ranks[0][i]["metrics"]


@pytest.mark.parametrize("label", [_label(a, f) for a, f, *_ in SERVES])
def test_sequence_parallel_serve_matches_one_device(sp_runs, label):
    *_, ranks, serves = sp_runs
    i = [_label(a, f) for a, f, *_ in SERVES].index(label)
    res = [rank[len(UNDIVIDED) + i] for rank in ranks]
    check_serve(serves[i], res)
    check_caches(serves[i], res)
    if label.startswith("recurrentgemma-2b"):
        # ranks 0 and 1 hold positions 0-21, all before the window of
        # every decode step: their partials are empty (no plain call)
        calls = [r["plain_partials"] for r in res]
        assert calls[0] == calls[1] == 0 and min(calls[2:]) > 0, calls


def _arch_ids():
    return list_archs()


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (1, 4), (16, 16)],
                         ids=["2x2", "1x2", "1x4", "16x16"])
def test_check_supported_every_arch(shape):
    """Every registered arch's full config lays out on the grid but item
    c's cases, which raise naming item c."""
    grid = make_mesh(shape, NAMES)
    raised = {}
    for arch in _arch_ids():
        try:
            sharding.check_supported(tget(arch), grid)
        except ValueError as err:
            raised[arch] = str(err)
    want = {"mamba2-1.3b"} if shape == (16, 16) else set()
    assert set(raised) == want, raised
    for msg in raised.values():
        assert "ROADMAP A13 part b item c" in msg and "embed" in msg


def _whole(q, k, v, pos, window):
    """Whole-cache attention of one decode query at ``pos``."""
    return ref.mha_ref(q, k[:, :, :pos + 1], v[:, :, :pos + 1], causal=True,
                       scale=q.shape[-1] ** -0.5, window=window)


@pytest.mark.parametrize("window", [0, 5])
def test_plain_partials_combine_to_whole_attention(window):
    """A decode query's attention over four key shards of a 24-slot cache,
    each shard's visible range cut explicitly (the query at 13: the last
    shard lies wholly past it, and with a 5-key window the first two
    wholly before it), combined in shard order, equals whole attention;
    an empty shard gives o = 0 and lse = -inf, never NaN."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn((2, 6, 1, 16), generator=g)
    k, v = (torch.randn((2, 3, 24, 16), generator=g) for _ in range(2))
    pos, slots = 13, 6
    os_, lses = [], []
    for s in range(4):
        lo = max(s * slots, pos - window + 1 if window else 0)
        hi = min((s + 1) * slots, pos + 1)
        shard = (k[:, :, s * slots:(s + 1) * slots],
                 v[:, :, s * slots:(s + 1) * slots])
        o, lse = ops.attention_partials(q, *shard, key_lo=lo - s * slots,
                                        key_hi=hi - s * slots)
        if hi <= lo:
            assert torch.equal(o, torch.zeros_like(o))
            assert bool(torch.isneginf(lse).all())
        else:
            assert torch.isfinite(lse).all()
        os_.append(o)
        lses.append(lse)
    got = ops.combine_partials(torch.stack(os_), torch.stack(lses))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _whole(q, k, v, pos, window), rtol=0,
                               atol=2e-5)
    # the log-sum-exp of a shard is the whole row's over its keys
    o, lse = ref.attention_lse_ref(q, k[:, :, :pos + 1], v[:, :, :pos + 1])
    want = torch.logsumexp(torch.einsum(
        "bhqd,bhkd->bhqk", q, k[:, :, :pos + 1].repeat_interleave(2, 1))
        * 16 ** -0.5, -1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_item_c_raises_name_item_c():
    """What still raises names item c: a weight whose model split
    ``fit_spec`` drops (every smoke config's vocabulary of 256 over a
    model axis of 3)."""
    cfg = tget("qwen3-32b", smoke=True)
    with pytest.raises(ValueError, match="ROADMAP A13 part b item c"):
        sharding.check_supported(cfg, make_mesh((1, 3), NAMES))
    sharding.check_supported(cfg, make_mesh((3, 1), NAMES))


def test_partials_kernel_refuses_cpu_tensors_and_grad():
    """B6's partials wrapper takes CUDA tensors only (on the CPU the op
    runs the plain version, ``ops.attention_partials``) and has no
    backward; neither refusal counts a launch."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 8, 16), dtype=torch.bfloat16)
    n = fa.flash_partials_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_partials_kernel(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_partials_kernel(q.float().requires_grad_(), k.float(),
                                 k.float())
    assert fa.flash_partials_kernel.launches == n
