"""The sharded LM over a data axis of two ranks, the archs with other
kinds than G and L, MoE FFNs or image tokens (deepseek-v2-236b's M kind
and MoE, llama-3.2-vision-11b's X kind, mamba2-1.3b's D kind,
moonshot-v1-16b-a3b's MoE, recurrentgemma-2b's R kind): one train step on
a ``(2,)`` process grid against the reference's under its host mesh, as
``tests/test_torch_lm_grid_archs.py`` holds the dense archs (FSDP alone:
these kinds do not split over ``model`` yet).  The MoE archs run their
config's dispatch (``"xla"``: the global tokens at the global capacity).
"""
import pytest
from test_torch_lm_grid_archs import KINDS, check_data_axis, data_axis


@pytest.fixture(scope="module")
def data_axis_runs():
    return data_axis(KINDS, collectives=False)


@pytest.mark.parametrize("arch", KINDS)
def test_train_step_over_data_matches_reference(data_axis_runs, arch):
    check_data_axis(data_axis_runs, KINDS, arch)
