"""Workers of the process grid's checks (``runtime.ProcessGrid``): the
verbs on each axis's sub-group, filter runs on the grid and resident
sessions under a scripted churn, on this process's shards.

* ``line_index(grid, name)`` — which line along ``name`` this rank is on
  (lines numbered row-major over the other axes).
* ``serve_ops(server, ops, frames)`` — drive a ``ParticleSessionServer``
  through a script of session operations, the same calls in the same
  order on every rank (the server over processes is SPMD).
* ``session_run(mesh, case)`` — one scripted server on ``mesh`` (or on
  one device with ``mesh=None``).
* ``grid_checks(mesh, spec)`` — the spawned ranks' entry: build the grid
  over the world and run the spec's verbs, filter runs and session
  scripts on it.

The CPU tests (``tests/test_torch_process_grid.py``) and ``chip_smoke.py``
hold the results to the emulated grid and the standalone filter.
Nothing here imports ``jax``, starts a process group or touches CUDA at
import.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.filters import resolve_device
from repro_torch.core.smc import SIRConfig
from repro_torch.launch.mesh import filter_run, to_host, verbs

# the kernel wrappers a tracking session launches on the card
from repro_torch.launch.track import KERNELS


def line_index(grid, name: str) -> int:
    """The index of this rank's line along axis ``name``: its coordinates
    on the other axes, flattened row-major."""
    a = grid.axis_names.index(name)
    i = 0
    for c, n in zip(grid.coords[:a] + grid.coords[a + 1:],
                    grid.axis_shapes[:a] + grid.axis_shapes[a + 1:]):
        i = i * n + c
    return i


def digest(tree) -> str:
    """A sha256 of a tensor or array tree's bits, leaves in order (dict
    keys sorted): equal digests mean equal bits."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        else:
            t = torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x).detach().cpu().contiguous()
            h.update(str((tuple(t.shape), t.dtype)).encode())
            h.update(t.view(-1).view(torch.uint8).numpy().tobytes()
                     if t.numel() else b"")
    feed(tree)
    return h.hexdigest()


def _result(res, digest_final: bool) -> dict:
    out = {f: getattr(res, f) for f in ("estimates", "ess", "log_marginal",
                                        "resampled")}
    final = {f: getattr(res.final, f)
             for f in ("state", "log_weights", "counts")}
    out["final"] = digest(final) if digest_final else final
    return to_host(out)


def serve_ops(server, ops, frames, digest_final: bool = False) -> dict:
    """Run the script ``ops`` on ``server``; each op is a tuple:

    * ``("attach", sid, seed)`` / ``("resume", sid, suspended)`` — start
      session ``sid`` from a seed, or from a ``SuspendedSession`` (``None``:
      the snapshot this script's ``suspend`` of ``sid`` kept);
    * ``("submit", sid, k)`` — submit ``frames[sid][k]``;
    * ``("step",)`` — one tick;
    * ``("detach", sid)``, ``("suspend", sid)`` (the snapshot is kept),
      ``("latest", sid)`` (kept), ``("result", sid)`` (kept, then the
      session detaches).

    Returns the kept ``results`` (host tensors; the final ensemble as a
    ``digest`` with ``digest_final``), ``suspended`` snapshots,
    ``latest`` rows, the ``ticks`` that stepped a session and the
    ``check_seconds`` spent keeping results (host copies, digests), not
    serving."""
    handles = {}
    out = {"results": {}, "suspended": {}, "latest": {}, "ticks": 0,
           "check_seconds": 0.0}
    for op in ops:
        kind = op[0]
        if kind == "step":
            out["ticks"] += server.step() > 0
        elif kind == "attach":
            handles[op[1]] = server.attach(op[2])
        elif kind == "resume":
            sus = op[2] if op[2] is not None else out["suspended"].pop(op[1])
            handles[op[1]] = server.resume(sus)
        elif kind == "submit":
            server.submit(handles[op[1]], frames[op[1]][op[2]])
        elif kind == "detach":
            server.detach(handles.pop(op[1]))
        elif kind == "suspend":
            out["suspended"][op[1]] = server.suspend(handles.pop(op[1]))
        elif kind == "latest":
            out["latest"][op[1]] = server.latest(handles[op[1]])
        elif kind == "result":
            h = handles.pop(op[1])
            res = server.result(h)
            t0 = time.perf_counter()
            out["results"][op[1]] = _result(res, digest_final)
            out["check_seconds"] += time.perf_counter() - t0
            server.detach(h)
        else:
            raise ValueError(f"unknown session op {op!r}")
    return out


def _session_model(case: dict, device):
    """The case's model and its sessions' frames: the 1-D linear-Gaussian
    demo model over ``frames`` (``{sid: (K,)}``), or the tracking model
    (``tracking``: ``TrackingConfig`` fields) over movies made here from
    ``movies`` (``{sid: seed}``, ``n_frames`` each)."""
    if "tracking" not in case:
        from repro_torch.launch.serve import lg_demo_model
        return lg_demo_model(), case["frames"]
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data.synthetic_movie import generate_movie
    from repro_torch.models.tracking import TrackingConfig, TrackingSSM
    cfg = TrackingConfig(**case["tracking"])
    frames = {sid: generate_movie(TorchDraws.from_seed(seed, device), cfg,
                                  n_frames=case["n_frames"]).frames
              for sid, seed in case["movies"].items()}
    return TrackingSSM(cfg), frames


def session_run(mesh, case: dict, device=None) -> dict:
    """A ``ParticleSessionServer`` on ``mesh`` (``None``: one device) of
    ``case["capacity"]`` slots over ``case["bank_axis"]``, with
    ``SIRConfig(**case["sir"])``, driven by ``serve_ops(case["ops"])``.
    ``device=None`` is the card, and raises without one.  Returns
    ``serve_ops``'s record with the kernels' launches and the seconds the
    script took, less the time spent keeping its results; with
    ``case["digest"]`` the final ensembles and every snapshot but global
    rank 0's are digests."""
    from repro_torch.serve.sessions import ParticleSessionServer
    device = resolve_device(device)
    model, frames = _session_model(case, device)
    server = ParticleSessionServer(model, SIRConfig(**case["sir"]),
                                   capacity=case["capacity"], mesh=mesh,
                                   bank_axis=case.get("bank_axis", "bank"),
                                   device=device)
    for k in KERNELS.values():
        k.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_ops(server, case["ops"], frames,
                    digest_final=case.get("digest", False))
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0 - out["check_seconds"]
    out["launches"] = {n: k.launches for n, k in KERNELS.items()}
    out["step_traces"] = server.step_traces
    out["tiers"] = server.tiers
    out["latest"] = {k: to_host(tuple(map(torch.as_tensor, v)))
                     for k, v in out["latest"].items()}
    if case.get("digest"):
        keep = not (torch.distributed.is_initialized()
                    and torch.distributed.get_rank() != 0)
        out["suspended_digest"] = {k: digest(v.as_tree())
                                   for k, v in out["suspended"].items()}
        if not keep:
            out["suspended"] = {}
    return out


def grid_checks(mesh: runtime.ProcessMesh, spec: dict, device=None) -> dict:
    """A spawned rank's checks on the ``ProcessGrid`` of
    ``spec["axis_shapes"]`` over ``spec["axis_names"]`` (built over the
    world ``mesh``'s group), with one intra-op thread:

    * ``verbs`` — ``{axis: [inputs of line j]}``: ``launch.mesh.verbs`` on
      this rank's line of each axis, on its line's inputs;
    * ``filters`` — ``launch.mesh.filter_run`` cases on the grid;
    * ``sessions`` — ``session_run`` cases on the grid.

    Returns the rank's coordinates and each part's results."""
    torch.set_num_threads(1)
    grid = runtime.ProcessGrid(mesh.transport, spec["axis_shapes"],
                               spec["axis_names"])
    out = {"coords": grid.coords, "rank": grid.rank}
    if "verbs" in spec:
        out["verbs"] = {name: verbs(grid.axis(name),
                                    spec["verbs"][name][line_index(grid,
                                                                   name)],
                                    device)
                        for name in grid.axis_names}
    out["filters"] = [filter_run(grid, c, device)
                      for c in spec.get("filters", [])]
    out["sessions"] = [session_run(grid, c, device)
                       for c in spec.get("sessions", [])]
    out["staged_bytes"] = grid.staged.bytes
    return out
