"""The expert-parallel MoE inside the sharded train step: moonshot-v1-16b-a3b's
smoke config with the dispatch its full config asks for
(``dispatch="ep_shardmap"``) and each ``ep_reduce`` (``"rs_ag"``, the
config's, and ``"psum"``), at capacity factor 0.5 so each data shard's
tokens overflow its experts, trained one step on a ``(2, 2)`` ``(data,
model)`` process grid (four gloo ranks spawned once) against the
reference's ``make_train_step`` under ``mesh_context`` of a ``(2, 2)``
host mesh, where it runs ``apply_moe_ep`` (``tests/lm_grid_ref.py``).
This holds what ``tests/test_torch_lm_grid.py``'s function-level
``apply_moe_ep`` check does not: the expert banks left out of the FSDP
gathers, the aux loss shared over the batch shards, the replicated
weights' gradient sums beside the all-to-all's backward, the
``rs_ag`` combine's gathers.  Metrics (the loss, the aux loss, the
dropped fraction, the gradient norm) at rtol 1e-5 and the weights after
the step at rtol 2e-3, atol 2e-5 (``tests/test_torch_train.py``'s
bounds), as ``tests/test_torch_lm_grid_archs.py`` holds the other cells;
the per-shard drops differ from one device's, so no one-device gradient
is compared here.
"""
import pytest
from test_torch_lm_grid_archs import cells, check_train, port_case, run_both

REDUCES = ["rs_ag", "psum"]
ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def ep_runs():
    ref_cells = [c for r in REDUCES for c in cells(
        (2, 2), [ARCH], moe=dict(dispatch="ep_shardmap", ep_reduce=r,
                                 capacity_factor=0.5))]
    ref, ranks = run_both(ref_cells, [port_case(c) for c in ref_cells], 4)
    return ref_cells, ref, ranks


@pytest.mark.parametrize("reduce", REDUCES)
def test_expert_parallel_train_step_matches_reference(ep_runs, reduce):
    ref_cells, ref, ranks = ep_runs
    i = REDUCES.index(reduce)
    assert ref_cells[i]["fields"]["moe"]["ep_reduce"] == reduce
    # the capacity binds: the reference drops tokens, and the port the same
    assert ref[i]["metrics"][0]["moe_drop_frac"] > 0.05
    check_train(ref[i], ranks[0][i], ref_cells[i], one_device=False)
    for r in range(1, 4):
        assert ranks[r][i]["metrics"] == ranks[0][i]["metrics"]
