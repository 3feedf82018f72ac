"""The M, X, R and D kinds over a ``model`` axis (ROADMAP A13 part b): one
train step of deepseek-v2-236b (M), llama-3.2-vision-11b (X, with
``tanh(xattn_gate)`` = tanh(0.5), so its leaves get gradients),
recurrentgemma-2b (R, and its L layer's one key/value head) and
mamba2-1.3b (D) at smoke size, cut to a unit of each arch's layer pattern
(``DEPTH``), in float32 on a ``(2, 2)`` ``(data, model)`` process grid
(four gloo ranks) and on a ``(1, 2)`` one (two ranks: tensor
parallelism without FSDP, every weight whole over ``data``), against the
reference's ``make_train_step`` under ``mesh_context`` of a host mesh of
the same shape (``tests/lm_grid_ref.py``, one subprocess for the file's
cells, run while the ranks run): metrics at rtol 1e-5, weights after the
step at rtol 2e-3, atol 2e-5 (``tests/test_torch_train.py``'s bounds),
the gradients against the port's own on one device within 1e-5 relative
L2, except the leaves in ``NOISY`` (mamba2's ``a_log``), held to a fixed
5e-4.  Then ``make_serve_step`` prefill and greedy decode of each kind
on ``(2, 2)`` against the port's one-device steps (logits at rtol = atol
= 1e-4, the same tokens), with every rank's caches in the reference's
``_cache_leaf_spec`` blocks (``tests/test_torch_lm_grid_sp.py``'s
check), the R and D conv caches holding the rank's channels.
"""
import pytest
from test_torch_lm_grid_archs import (cells, check_train, port_case,
                                      run_spawns)
from test_torch_lm_grid_sp import (check_caches, check_serve,  # noqa: F401
                                   few_threads, serve_case)

from repro_torch import convert

KINDS = ["deepseek-v2-236b", "llama-3.2-vision-11b", "recurrentgemma-2b",
         "mamba2-1.3b"]
# the smoke configs cut to a unit of each arch's pattern (deepseek its M
# layer with the dense FFN, recurrentgemma R, R, L), on both sides: the
# reference's jit compiles of these cells are most of the file's time
DEPTH = {"deepseek-v2-236b": {"n_layers": 1},
         "recurrentgemma-2b": {"n_layers": 3},
         "mamba2-1.3b": {"n_layers": 2}}
GRIDS = [(2, 2), (1, 2)]
# (arch, leaf suffix) of the leaves whose one-device float32 gradient is
# itself noisier than 1e-5: mamba2's ``a_log`` gradient is a sum that
# cancels, and one float32 ulp on ``w_out`` moves it by 1.2e-4 relative
# L2 at the smoke model's last layer (the (2, 2) grid read 1.05e-4).
# Those leaves are held to NOISY_TOL, every other to 1e-5.
NOISY = [("mamba2-1.3b", "ssm.a_log")]
NOISY_TOL = 5e-4


@pytest.fixture(scope="module")
def kind_runs():
    """Every cell of the module: the ``(2, 2)`` train and serve cases on
    one spawn of four ranks, then the ``(1, 2)`` train cases on one of
    two, the reference's train cells of both grids in one subprocess
    meanwhile."""
    ref_cells = [c for g in GRIDS for c in cells(g, KINDS, fields=DEPTH)]
    serves = [serve_case(a, i, (2, 2), 12, 4, DEPTH.get(a))
              for i, a in enumerate(KINDS)]
    port = [port_case(c) for c in ref_cells]
    n = len(KINDS)
    ref, (square, line) = run_spawns(ref_cells, [(port[:n] + serves, 4),
                                                 (port[n:], 2)])
    return ref_cells, ref, {GRIDS[0]: square, GRIDS[1]: line}, serves


@pytest.mark.parametrize("shape", GRIDS, ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", KINDS)
def test_kind_train_step_over_model_matches_reference(kind_runs, arch,
                                                      shape):
    """The arch's train cell on ``shape``: rank 0 against the reference
    and the one-device gradients, every rank the same metrics."""
    ref_cells, ref, runs, _ = kind_runs
    i = GRIDS.index(shape) * len(KINDS) + KINDS.index(arch)
    cell, ranks = ref_cells[i], runs[shape]
    assert tuple(cell["shape"]) == shape and cell["arch"] == arch
    j = KINDS.index(arch)
    limits = {n: NOISY_TOL for n in ranks[0][j]["grads"]
              for a, leaf in NOISY if a == arch and n.endswith(leaf)}
    check_train(ref[i], ranks[0][j], cell, limits=limits)
    for rank in ranks[1:]:
        assert rank[j]["metrics"] == ranks[0][j]["metrics"]


@pytest.mark.parametrize("arch", KINDS)
def test_kind_serve_over_model_matches_one_device(kind_runs, arch):
    *_, runs, serves = kind_runs
    i = KINDS.index(arch)
    case = serves[i]
    res = [rank[len(KINDS) + i] for rank in runs[(2, 2)]]
    check_serve(case, res)
    check_caches(case, res)


def test_xattn_gate_gets_a_gradient(kind_runs):
    """The X cells train the gate and the image path: their first step's
    gradients are nonzero on every X leaf and ``img_proj``."""
    ref_cells, _, runs, _ = kind_runs
    got = runs[(2, 2)][0][KINDS.index("llama-3.2-vision-11b")]["grads"]
    tcfg = convert.arch_config(ref_cells[1]["fields"])
    x_layer = tcfg.cross_attn_every - 1
    for leaf in ("xattn_gate", "xattn.wq", "xattn.wk", "xattn.wv",
                 "xattn.wo"):
        assert float(got[f"blocks.{x_layer}.{leaf}"].abs().sum()) > 0, leaf
    assert float(got["img_proj"].abs().sum()) > 0
