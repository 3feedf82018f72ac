"""Track a spot with the paper's distributed filter, one process a shard
(counterpart of ``examples/tracking_microscopy.py --devices P``).

    torchrun --standalone --nproc-per-node P -m repro_torch.launch.track \\
        --transport {gloo,nccl} --dra rna [rpa ...] [--bank B] \\
        --particles N --frames K --seed S --movie FILE.npy --out DIR

Each rank joins the process group from ``torchrun``'s environment
(``launch.mesh.init_process_mesh``), runs the distributed filter of every
``--dra`` kind over the movie's first ``K`` frames (a ``(K, H, W)``
float32 array) with ``N`` particles in all (``N / P`` a rank), and, with
``--bank B``, a ``FilterBank`` of ``B`` members of the first ``--dra``
kind over the same movie (member ``i`` seeded ``S + i``).  The model is
``TrackingConfig`` at the movie's frame size.  Each rank writes
``DIR/rank<r>.pt``: for every run its replicated outputs, its shard of
the final ensemble, its kernels' launch counts, the bytes the gloo
transport staged between the card and host memory, and its wall time.
On the gloo transport every rank computes on the current card (several
ranks may share one) and the messages go through host memory; on nccl
each rank takes card ``LOCAL_RANK``.  ``--device cpu`` computes on the
host instead (gloo only).

``run(mesh, frames, kind, particles, ...)`` is one such run on any mesh.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.filters import (FilterBank, ParallelParticleFilter,
                                      resolve_device)
from repro_torch.core.smc import SIRConfig
from repro_torch.kernels import patch_likelihood, resample, row_sum, scan
from repro_torch.launch.mesh import init_process_mesh, outputs, to_host
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

# the kernel wrappers a tracking run launches on the card
KERNELS = {"patch_log_likelihood": patch_likelihood.patch_log_likelihood_kernel,
           "systematic_ancestors": resample.systematic_ancestors_kernel,
           "prefix_sum": scan.prefix_sum_kernel,
           "row_sum": row_sum.row_sum_kernel}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(mesh: runtime.Mesh, frames, kind: str, particles: int, *,
        seed: int = 0, bank=None, device=None) -> dict:
    """One tracking run of DRA ``kind`` on ``mesh`` over ``(K, H, W)``
    ``frames`` (``TrackingConfig`` at their size) with ``particles`` in
    all: the filter seeded ``seed``, or with ``bank`` (one int seed a
    member) a ``FilterBank`` over the mesh.  ``device=None`` is the card,
    and raises without one.

    Returns host tensors: the replicated outputs, this process's shards
    of the final ensemble, the kernels' launches, the bytes staged
    between the card and host memory and the seconds the run took."""
    frames = np.asarray(frames, dtype=np.float32)
    model = TrackingSSM(TrackingConfig(img_size=tuple(frames.shape[-2:])))
    sir = SIRConfig(n_particles=int(particles))
    dra = DRAConfig(kind=kind)
    device = resolve_device(device)
    staged = mesh.staged.bytes if isinstance(mesh, runtime.ProcessMesh) \
        else 0
    for k in KERNELS.values():
        k.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    if bank is None:
        res = ParallelParticleFilter(model, sir, device=device, mesh=mesh,
                                     dra=dra).run(seed, frames)
    else:
        keys = [int(s) for s in bank]
        res = FilterBank(model, sir, device=device, mesh=mesh, dra=dra).run(
            keys, torch.from_numpy(frames).expand((len(keys),)
                                                  + frames.shape))
    _sync(device)
    seconds = time.perf_counter() - t0
    return to_host({**outputs(res),
                    "launches": {n: k.launches for n, k in KERNELS.items()},
                    "staged_bytes": (mesh.staged.bytes - staged
                                     if isinstance(mesh, runtime.ProcessMesh)
                                     else 0),
                    "seconds": seconds,
                    "frames_per_s": frames.shape[0] / seconds})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", choices=runtime.TRANSPORTS,
                    required=True)
    ap.add_argument("--dra", nargs="+", default=["rna"],
                    choices=("mpf", "rna", "arna", "rpa", "butterfly"))
    ap.add_argument("--bank", type=int, default=0,
                    help="also run a FilterBank of this many members, of "
                         "the first --dra kind")
    ap.add_argument("--particles", type=int, required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--movie", required=True,
                    help="(K, H, W) float32 frames, .npy")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("track: no CUDA device (pass --device cpu)")
    mesh = init_process_mesh(args.transport)
    frames = np.load(args.movie)[:args.frames]
    t0 = time.perf_counter()
    try:
        runs = {}
        for kind in args.dra:
            runs[kind] = run(mesh, frames, kind, args.particles,
                             seed=args.seed, device=args.device)
        if args.bank:
            runs[f"bank-{args.dra[0]}"] = run(
                mesh, frames, args.dra[0], args.particles,
                bank=[args.seed + i for i in range(args.bank)],
                device=args.device)
        record = {"rank": mesh.rank, "world": mesh.shards,
                  "transport": mesh.transport,
                  "device": (torch.cuda.get_device_name()
                             if args.device != "cpu" else "cpu"),
                  "runs": runs, "staged_bytes": mesh.staged.bytes,
                  "wall_s": time.perf_counter() - t0}
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"rank{mesh.rank}.pt")
        torch.save(record, path + ".tmp")
        os.replace(path + ".tmp", path)
        for label, r in runs.items():
            print(f"rank {mesh.rank}/{mesh.shards} {label}: "
                  f"{r['frames_per_s']:.3f} frames/s, staged "
                  f"{r['staged_bytes']} B, launches {r['launches']}",
                  flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
