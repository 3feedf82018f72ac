"""Meshes for the port's distributed filter (counterpart of
``repro.launch.mesh``): an emulated mesh on one device, or one process a
shard over a ``torch.distributed`` group.

* ``make_host_mesh(n)`` — ``n`` emulated shards on one device.
* ``init_process_mesh(transport)`` — joins the process group and returns
  the ``ProcessMesh`` of its ranks, from ``torchrun``'s environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``)
  or from an explicit rank, world size and init method; with
  ``axis_shapes`` and ``axis_names``, the ``ProcessGrid`` of its ranks.
* ``spawn(fn, world)`` — starts ``world`` ranks on this host with the
  ``spawn`` start method (a parent that has touched CUDA cannot
  ``fork``), runs ``fn(mesh, *args)`` on each and returns the ranks'
  results in rank order.  It keeps an overall deadline: the first rank
  to fail, or the deadline, kills every rank and raises, so a dead rank
  never leaves the others blocked in a collective.
* ``verbs(mesh, inputs)`` and ``filter_runs(mesh, cases)`` — the
  checks' workers: every collective of the facade, and tracking-filter
  runs (on replayed draws, with a domain, the final ensemble gathered),
  on this process's shards, for the checks that hold the process mesh to
  the emulated one and to the reference (the CPU tests, and
  ``chip_smoke.py`` on the nccl transport).

Nothing here starts a process group or touches CUDA at import.
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.draws import BankDraws, ReplayDraws
from repro_torch.core.filters import (FilterBank, ParallelParticleFilter,
                                      resolve_device)
from repro_torch.core.smc import SIRConfig
from repro_torch.models.tracking import (TrackingConfig, TrackingSSM,
                                         make_domain_spec)

# seconds a collective waits for a peer before the group fails (gloo's
# and nccl's default is 30 minutes)
GROUP_TIMEOUT = 60.0


def make_host_mesh(n: int | None = None, axis: str = "data"
                   ) -> runtime.EmulatedMesh:
    """``n`` emulated shards of axis ``axis`` on one device."""
    return runtime.host_mesh(n, axis)


def init_process_mesh(transport: str, *, rank: int | None = None,
                      world: int | None = None,
                      init_method: str | None = None,
                      timeout: float = GROUP_TIMEOUT,
                      axis_shapes=None, axis_names=None
                      ) -> runtime.ProcessMesh | runtime.ProcessGrid:
    """Join the default process group and return its ``ProcessMesh``
    (axis ``"data"``), or with ``axis_shapes`` and ``axis_names`` its
    ``ProcessGrid`` (whose ranks must number the world size, or it
    raises).

    Without ``rank`` the rank, world size and local rank come from
    ``torchrun``'s environment (``init_method`` ``env://``); with it, the
    caller gives ``world`` and an ``init_method`` (a ``file://`` path or
    ``tcp://localhost:<port>``), and the local rank is the rank (one
    host).  The ``"nccl"`` transport binds the rank to card
    ``LOCAL_RANK`` and raises without one; ``"gloo"`` carries host
    tensors.  ``timeout`` bounds every collective's wait for a peer."""
    if transport not in runtime.TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} "
                         f"({runtime.TRANSPORTS})")
    if rank is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    elif world is None or init_method is None:
        raise ValueError("an explicit rank needs world and init_method")
    else:
        local = rank
    if transport == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl transport needs a CUDA device")
        torch.cuda.set_device(local)
    torch.distributed.init_process_group(
        transport, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    if axis_shapes is not None:
        return runtime.ProcessGrid(transport, tuple(axis_shapes),
                                   tuple(axis_names))
    return runtime.ProcessMesh(transport)


def _rank_main(fn, rank: int, world: int, transport: str, init_method: str,
               timeout: float, args_path: str, out: str) -> None:
    """One spawned rank: join the group, run ``fn`` on the arguments saved
    at ``args_path``, save its result to ``out`` (or its traceback to
    ``out + '.err'``, before the group closes and its peers fail) and
    leave the group."""
    try:
        args = torch.load(args_path, weights_only=False)
        mesh = init_process_mesh(transport, rank=rank, world=world,
                                 init_method=init_method, timeout=timeout)
        result = fn(mesh, *args)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    torch.save(result, out + ".tmp")
    os.replace(out + ".tmp", out)


def spawn(fn, world: int, args: tuple = (), *, transport: str = "gloo",
          deadline: float = 300.0, timeout: float = 30.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks of one process
    group and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and
    ``args`` picklable (saved once to a file the ranks load: through the
    start pipe, large arguments would start the ranks one at a time);
    the ranks join through a ``file://`` rendezvous in a fresh
    directory, with ``timeout`` seconds for any collective.
    If a rank fails, or the ranks are not all done within ``deadline``
    seconds, every rank still running is killed and ``spawn`` raises
    (``RuntimeError`` with the failed rank's traceback, or
    ``TimeoutError``)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ppf-spawn-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        args_path = os.path.join(tmp, "args.pt")
        torch.save(tuple(args), args_path)
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, transport, init, timeout, args_path, outs[r]),
            name=f"ppf-rank{r}") for r in range(world)]
        end = time.monotonic() + deadline
        try:
            for p in procs:
                p.start()
            while True:
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    # name the first rank to fail, whose traceback is the
                    # oldest (its peers' collectives fail after it, and
                    # may exit before it does)
                    errs = [(os.path.getmtime(e), r) for r, e in
                            ((r, o + ".err") for r, o in enumerate(outs))
                            if os.path.exists(e)]
                    r = min(errs)[1] if errs else failed[0]
                    why = open(outs[r] + ".err").read() if errs else ""
                    raise RuntimeError(f"rank {r} of {world} failed (exit "
                                       f"code {procs[r].exitcode})\n{why}")
                alive = [p for p in procs if p.exitcode is None]
                if not alive:
                    break
                left = end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(alive)} of {world} ranks not "
                                       f"done after {deadline} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in alive], timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
        return [torch.load(o, weights_only=False) for o in outs]


# ---------------------------------------------------------------------------
# The verbs on a set of inputs (the checks' worker)
# ---------------------------------------------------------------------------

def verb_inputs(p: int, seed: int = 0) -> dict:
    """Numpy inputs for ``verbs`` over ``p`` shards, made from ``seed``:
    float and int per-shard values, ``(P, P, ...)`` blocks, and (ARNA's
    lost-mode test) values with ``-inf`` entries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, 3, 2)).astype(np.float32)
    x[0, 0, 0] = -np.inf
    return {"x": x,
            "xi": rng.integers(-50, 50, (p, 4)).astype(np.int32),
            "blocks": rng.standard_normal((p, p, 2, 3)).astype(np.float32),
            "iblocks": np.arange(p * p * 2, dtype=np.int32).reshape(p, p, 2),
            "bank": rng.standard_normal((2, p, 5)).astype(np.float32)}


def verbs(mesh: runtime.Mesh, inputs: dict, device=None) -> dict:
    """Every verb of the facade on this process's shards of ``inputs``
    (``verb_inputs``; each value's shard dim is its first, behind the
    bank's member dim for ``"bank"``): float and int ``psum``, ``pmax``,
    ``all_gather``, ``ppermute`` along the ring and along a butterfly
    stage that leaves shard 1 with nothing, ``all_to_all`` of float and
    int blocks,
    ``grouped_ppermute`` of a tuple and a dict, the collectives behind a
    member dim, ``shard0``, ``from_shard`` of the last shard,
    ``axis_index`` and ``gather_shards``.
    ``device=None`` is the card, and raises without one.  Returns host
    tensors, each with the held shards' dim first."""
    device = resolve_device(device)
    held = runtime.shard_range(mesh)

    def own(name, dim=0):
        t = torch.from_numpy(np.ascontiguousarray(inputs[name])).to(device)
        return t.narrow(dim, held.start, len(held))

    p = mesh.shards
    x, xi = own("x"), own("xi")
    ring = runtime.ring(mesh)
    stage = runtime.butterfly_schedule(p)[-1] if p > 1 else ring
    partial = [(s, d) for s, d in stage if d != 1 % p]
    bank = mesh.over((2,))
    b = own("bank", 1)
    out = {
        "psum": runtime.psum(x, mesh),
        "psum_int": runtime.psum(xi, mesh),
        "pmax": runtime.pmax(x, mesh),
        "all_gather": runtime.all_gather(x, mesh),
        "ppermute_ring": runtime.ppermute(x, mesh, ring),
        "ppermute_partial": runtime.ppermute(xi, mesh, partial),
        "all_to_all": runtime.all_to_all(own("blocks"), mesh),
        "all_to_all_int": runtime.all_to_all(own("iblocks"), mesh),
        "shard0": runtime.shard0(xi, mesh)[None].expand(len(held), 4),
        "from_shard": runtime.from_shard(x, mesh, p - 1)[None].expand(
            len(held), 3, 2),
        "axis_index": runtime.axis_index(mesh, device),
        "gather_shards": runtime.gather_shards(xi, mesh)[None].expand(
            len(held), p, 4),
    }
    g_tuple = runtime.grouped_ppermute((x, xi), mesh, stage)
    g_dict = runtime.grouped_ppermute({"a": x, "b": xi}, mesh, ring)
    out.update({"grouped_0": g_tuple[0], "grouped_1": g_tuple[1],
                "grouped_a": g_dict["a"], "grouped_b": g_dict["b"]})
    # behind a member dim: (2, held, ...) -> held first
    for k, v in {"bank_psum": runtime.psum(b, bank),
                 "bank_all_gather": runtime.all_gather(b, bank),
                 "bank_ppermute": runtime.ppermute(b, bank, ring)}.items():
        out[k] = v.movedim(1, 0)
    return {k: v.cpu() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Tracking-filter runs (the checks' worker)
# ---------------------------------------------------------------------------

def to_host(tree):
    """Every tensor of a dict tree on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


def outputs(res) -> dict:
    """A ``FilterResult``'s replicated outputs and diag, and this
    process's shards of its final ensemble (``"final"``)."""
    return {"estimates": res.estimates, "ess": res.ess,
            "log_marginal": res.log_marginal, "resampled": res.resampled,
            "diag": dict(res.diag),
            "final": {f: getattr(res.final, f)
                      for f in ("state", "log_weights", "counts")}}


def filter_run(mesh: runtime.Mesh, case: dict, device=None) -> dict:
    """One tracking-filter run on ``mesh``, described by ``case``:

    * ``frames`` — ``(K, H, W)`` numpy frames (a bank's may be ``(B, K,
      H, W)``, one movie a member); ``cfg`` — further
      ``TrackingConfig`` fields (``img_size`` is the frames');
    * ``dra`` — ``DRAConfig`` fields; ``particles`` — the global ``N``;
    * ``key`` — an int seed, or every shard's replayed draws (one list of
      ``(kind, array)`` draws a shard); or ``bank`` — one such key a
      member, for a ``FilterBank`` over the mesh (``bank_axis``: its
      members sharded over that axis of a grid);
    * ``axis_name`` — the particle axis of a grid (default ``"data"``);
    * ``domain`` — decompose the frame into one tile a shard.

    ``device=None`` is the card, and raises without one.  Returns host
    tensors: ``outputs``, every shard's final ensemble
    (``"gathered"``, ``runtime.gather_shards``), the bytes staged and the
    replayed draws the run left unused."""
    frames = np.asarray(case["frames"], dtype=np.float32)
    cfg = TrackingConfig(**{"img_size": tuple(frames.shape[-2:]),
                            **case.get("cfg", {})})
    model = TrackingSSM(cfg)
    sir = SIRConfig(n_particles=int(case["particles"]))
    dra = DRAConfig(**case["dra"])
    device = resolve_device(device)
    processes = isinstance(mesh, (runtime.ProcessMesh, runtime.ProcessGrid))
    staged = mesh.staged.bytes if processes else 0
    name = case.get("axis_name", "data")
    axis = mesh.axis(name)

    def replayed(key):
        # every held shard's replayed draws
        return BankDraws([ReplayDraws(key[i])
                          for i in runtime.shard_range(axis)])

    if case.get("bank") is not None:
        keys = [k if isinstance(k, (int, np.integer)) else replayed(k)
                for k in case["bank"]]
        obs = torch.from_numpy(frames)
        if obs.dim() == 3:                   # one movie for every member
            obs = obs.expand((len(keys),) + tuple(obs.shape))
        res = FilterBank(model, sir, device=device, mesh=mesh, dra=dra,
                         axis_name=name,
                         bank_axis=case.get("bank_axis")).run(keys, obs)
        held = [k for k in keys if isinstance(k, BankDraws)]
        if held and case.get("bank_axis") and processes:
            # the members this rank's bank shard holds
            line = mesh.axis(case["bank_axis"])
            per = len(keys) // line.shards
            held = held[line.rank * per:(line.rank + 1) * per]
        left = sum(m.remaining for k in held for m in k.members)
    else:
        domain = make_domain_spec(cfg, axis.shards) if case.get("domain") \
            else None
        key = case["key"]
        if not isinstance(key, (int, np.integer)):
            key = replayed(key)
        res = ParallelParticleFilter(model, sir, device=device, mesh=mesh,
                                     dra=dra, domain=domain,
                                     axis_name=name).run(key, frames)
        left = sum(m.remaining for m in key.members) \
            if isinstance(key, BankDraws) else 0
    out = outputs(res)
    over = axis.over(res.final.log_weights.shape[:-2])
    out["gathered"] = {f: runtime.gather_shards(v, over)
                       for f, v in out["final"].items()}
    out["staged_bytes"] = mesh.staged.bytes - staged if processes else 0
    out["replay_left"] = left
    return to_host(out)


def filter_runs(mesh: runtime.Mesh, cases: list, device=None) -> list:
    """``filter_run`` every case in turn on one mesh (one spawn for many
    runs), with one intra-op thread (the CPU tests' setting)."""
    torch.set_num_threads(1)
    return [filter_run(mesh, c, device) for c in cases]
