"""The sharded LM over a data axis of two ranks, the dense G and L archs
(the M, X, R, D, MoE and codebook ones in
``tests/test_torch_lm_grid_kinds.py``, with this file's helpers): one
train step of the port's ``make_train_step`` on a ``(2,)`` process
grid (gloo ranks spawned by ``launch.mesh.spawn``; FSDP: each rank holds
its blocks, gathers a layer's weights on use and reduce-scatters their
gradients) against the reference's own ``make_train_step`` under
``mesh_context`` of a two-device host mesh (``tests/lm_grid_ref.py``, a
subprocess with four simulated host devices, run while the ranks run).
Smoke configs in float32, weights drawn with numpy
(``test_torch_train_kinds.kind_params``), numpy batches: the metrics at
rtol 1e-5 and the weights after the step at rtol 2e-3, atol 2e-5
(``tests/test_torch_train.py``'s bounds).  MoE archs run their config's
dispatch (``"xla"``: the global tokens routed at the global capacity,
as GSPMD runs the reference's ``apply_moe``).

Also here: each differentiable collective of ``core.runtime`` against
central finite differences of its logical function on an emulated mesh,
and on two gloo ranks against the emulated mesh, bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from test_torch_train_kinds import kind_params

from repro.configs import get_config, list_archs
from repro.data import tokens as jtokens
from repro_torch import convert
from repro_torch.core import runtime
from repro_torch.launch import lm_grid
from repro_torch.launch.mesh import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TC = dict(xent_chunk=16)


def cells(shape, archs, moe=None):
    """One train cell an arch on ``shape``: the reference's config
    fields (float32 compute; ``moe`` replaces fields of its MoE config),
    the weights and batch of ``tests/test_torch_train_kinds.py``'s
    one-device comparison (``kind_params``, the reference's
    ``make_batch(0, 0, cfg, 4, 32)``)."""
    names = ("data", "model")[:len(shape)]
    out = []
    for arch in archs:
        jcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   compute_dtype="float32")
        if moe:
            jcfg = dataclasses.replace(
                jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        batch = jtokens.make_batch(0, 0, jcfg, 4, 32)
        out.append({"kind": "train", "arch": arch,
                    "fields": dataclasses.asdict(jcfg), "shape": shape,
                    "names": names, "params": kind_params(jcfg),
                    "batches": [{k: np.asarray(v) for k, v in
                                 batch.items()}], "opt": OPT, "tc": TC})
    return out


def run_both(ref_cells, port_cases, world):
    """The reference's cells in a subprocess while ``world`` spawned ranks
    run the port's cases; returns (the reference's results, every rank's
    results)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(ref_cells, f)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "lm_grid_ref.py"),
             src, dst], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ranks = spawn(lm_grid.run_cases, world, (port_cases,),
                          deadline=240.0)
            _, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        with open(dst, "rb") as f:
            return pickle.load(f), ranks


def port_case(cell):
    tcfg = convert.arch_config(cell["fields"])
    return {"fn": "train", "cfg": tcfg, "shape": cell["shape"],
            "names": cell["names"], "params": cell["params"],
            "batches": cell["batches"], "opt": OPT, "tc": TC,
            "grads": True}


def one_device_grads(cell):
    """The port's one-device gradients of the cell's first batch."""
    from repro_torch.train import step as TS
    tcfg = convert.arch_config(cell["fields"])
    model = convert.train_params(cell["params"], tcfg)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in cell["batches"][0].items()}
    TS.accumulate_grads(model, tcfg, TS.TrainConfig(**TC), batch)
    return {n: p.grad for n, p in model.named_parameters()}


def check_train(ref, got, cell, one_device=True):
    """The port's metrics (the gradient norm among them) and weights after
    the step against the reference's; with ``one_device`` the sharded
    gradients against the port's own on one device too (not where the
    expert-parallel dispatch drops other tokens than one device does)."""
    tcfg = convert.arch_config(cell["fields"])
    for want, met in zip(ref["metrics"], got["metrics"], strict=True):
        assert sorted(met) == sorted(want), cell["arch"]
        for k in want:
            np.testing.assert_allclose(met[k], want[k], rtol=1e-5,
                                       err_msg=f"{cell['arch']} {k}")
    for name, w in (one_device_grads(cell) if one_device else {}).items():
        g = got["grads"][name]
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err < 1e-5, f"{cell['arch']} {name}: relative L2 {err:.3g}"
    want = convert.lm_named(ref["params"])
    assert sorted(got["params"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["params"][name].numpy(), w,
                                   rtol=2e-3, atol=2e-5,
                                   err_msg=f"{cell['arch']} {name}")
    assert tcfg.name == cell["arch"]


KINDS = ["deepseek-v2-236b", "llama-3.2-vision-11b", "mamba2-1.3b",
         "moonshot-v1-16b-a3b", "recurrentgemma-2b"]
DENSE = [a for a in list_archs() if a not in KINDS]


def data_axis(archs, collectives: bool):
    """Each arch's cell on (2,) (and with ``collectives`` the
    differentiable verbs) in one spawn of two ranks, the reference's cells
    meanwhile."""
    ref_cells = cells((2,), archs)
    cases = [port_case(c) for c in ref_cells]
    if collectives:
        cases.append({"fn": "collectives",
                      "inputs": lm_grid.collective_inputs(2, seed=3)})
    ref, ranks = run_both(ref_cells, cases, 2)
    return ref_cells, ref, ranks


def check_data_axis(runs, archs, arch):
    ref_cells, ref, ranks = runs
    i = archs.index(arch)
    check_train(ref[i], ranks[0][i], ref_cells[i])
    # both ranks report the same global metrics
    assert ranks[1][i]["metrics"] == ranks[0][i]["metrics"]


@pytest.fixture(scope="module")
def data_axis_runs():
    return data_axis(DENSE, collectives=True)


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_over_data_matches_reference(data_axis_runs, arch):
    check_data_axis(data_axis_runs, DENSE, arch)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

def _logical(verb, p):
    """The function of each verb as its pair of forward and backward
    defines it, on one logical value: inputs and outputs a rank holds as
    its copy of a replicated value count once (``tp_copy``'s input,
    ``tp_reduce``'s and ``tp_gather``'s outputs: the ranks of a ``model``
    line share one loss), every other per-shard value is its own;
    ``tp_mean``'s copies each count (the ranks of a batch line sum their
    objectives, and each adds the mean once over their number).  A
    replicated output's cotangent is the same on every shard."""
    def f(x, cot):                       # x, cot: per-shard (P, ...)
        if verb == "fsdp_gather":        # blocks -> each shard's full copy
            full = torch.cat(list(x), -1)
            return sum((full * cot[i]).sum() for i in range(p))
        if verb == "tp_copy":            # one value -> each shard's copy
            return sum((x[0] * cot[i]).sum() for i in range(p))
        if verb == "tp_reduce":          # partials -> one sum
            return (x.sum(0) * cot[0]).sum()
        if verb == "tp_mean":            # every shard counts its copy
            return sum((x.mean(0) * cot[i]).sum() for i in range(p))
        if verb == "tp_scatter":         # partials -> block i of the sum
            s = x.sum(0)
            n = s.shape[-1] // p
            return sum((s[..., i * n:(i + 1) * n] * cot[i]).sum()
                       for i in range(p))
        if verb == "tp_gather":          # blocks -> one whole value
            return (torch.cat(list(x), -1) * cot[0]).sum()
        return (x.transpose(0, 1) * cot).sum()        # all_to_all
    return f


@pytest.mark.parametrize("verb", sorted(lm_grid.VERBS))
def test_collective_gradients_match_finite_differences(verb):
    """Each verb's backward on an emulated mesh against central
    differences of its logical function; a replicated input's copies all
    carry the whole gradient (``tp_copy``)."""
    p = 3
    inputs = lm_grid.collective_inputs(p, seed=5)
    got = lm_grid.collectives(runtime.EmulatedMesh(p), inputs)[verb]
    x = torch.from_numpy(inputs[verb]["x"])
    cot = torch.from_numpy(inputs[verb]["cot"])
    f = _logical(verb, p)
    if verb == "tp_copy":                # the copies of one value
        x = x[:1].expand_as(x).clone()
    eps = 1e-6
    num = torch.zeros_like(x)
    for idx in np.ndindex(*x.shape):
        if verb == "tp_copy" and idx[0]:
            continue
        for sgn in (1, -1):
            xp = x.clone()
            xp[idx] += sgn * eps
            if verb == "tp_copy":
                xp = xp[:1].expand_as(xp)
            num[idx] += sgn * f(xp, cot) / (2 * eps)
    if verb == "tp_copy":
        num = num[:1].expand_as(num)
    if verb in ("tp_reduce", "tp_mean", "tp_gather"):
        # a replicated output: every shard holds the same cotangent
        cot0 = cot[:1].expand_as(cot).contiguous()
        inputs[verb]["cot"] = cot0.numpy()
        got = lm_grid.collectives(runtime.EmulatedMesh(p), inputs)[verb]
        num = torch.zeros_like(x)
        for idx in np.ndindex(*x.shape):
            for sgn in (1, -1):
                xp = x.clone()
                xp[idx] += sgn * eps
                num[idx] += sgn * f(xp, cot0) / (2 * eps)
    torch.testing.assert_close(got["grad"], num, rtol=1e-6, atol=1e-8)


def test_process_collectives_match_emulated(data_axis_runs):
    """On two gloo ranks each verb's output and gradient are the emulated
    mesh's shard for shard, bit for bit."""
    *_, ranks = data_axis_runs
    want = lm_grid.collectives(runtime.EmulatedMesh(2),
                               lm_grid.collective_inputs(2, seed=3))
    for r, res in enumerate(ranks):
        got = res[-1]
        for verb, w in want.items():
            for k in ("y", "grad"):
                assert torch.equal(got[verb][k][0], w[k][r]), (verb, k, r)

