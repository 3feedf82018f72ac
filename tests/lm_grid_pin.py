"""The grid tests' spawned ranks on a few cores: ``run_cases`` is
``launch.lm_grid.run_cases`` in a rank that has first set its own CPU
affinity, so that only the processes a grid test starts are held to the
cores ``test_torch_lm_grid_archs.run_spawns`` names (``GRID_CPUS``).
"""
import os

from repro_torch.launch import lm_grid


def run_cases(mesh, cpus, cases: list) -> list:
    os.sched_setaffinity(0, cpus)
    return lm_grid.run_cases(mesh, cases)
