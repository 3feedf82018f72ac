"""Training launcher on the card (port of ``repro.launch.train``):
random weights from a seed + optimizer state + the (seed, step)-indexed
data pipeline + atomic checkpoints with resume + a straggler-aware step
loop.

Fault-tolerance contract, as the reference's:

* checkpoints of ``{"params", "opt"}`` are atomic
  (``repro_torch.checkpoint.store``) and taken every ``--ckpt-every``
  steps;
* the data pipeline is ``(seed, step)``-indexed, so a restart needs no
  data state: it resumes from ``latest_step`` of ``--ckpt-dir``.

It trains on the card unless ``--device cpu`` is given, and without a
card and without it the launcher fails rather than run elsewhere.
``--devices N > 1`` spawns N ranks (``launch.mesh.spawn``) on the
reference's grid: ``(N // 2, 2)`` as ``(data, model)`` when N >= 4, else
``(N,)`` as ``data``; each rank holds its blocks of the weights and the
optimizer state (``launch.sharding``) and runs the sharded step
(``repro_torch.train``).  ``--transport gloo`` (the default) carries the
collectives through host memory and lets every rank share one card;
``nccl`` needs a card a rank.  Every kind runs over the ``model``
axis, and so do heads it does not divide; what the grid cannot run yet
(ROADMAP A13 part b item c: a weight whose ``model`` split ``fit_spec``
drops) exits before any rank starts.  Checkpoints hold full tensors by
name whatever the grid: each rank writes its own blocks into them
(``checkpoint.store.save_blocks``; nothing is gathered), and each rank
restores its blocks of them: a run resumes on another grid, or on one
device, with the same full tensors (elastic resume).  Every
registered arch trains on one device: ``make_batch`` draws a
cross-attending arch's image embeddings, and a MoE arch's step also
prints its load-balance loss and dropped fraction.

    python -m repro_torch.launch.train --arch stablelm-3b --smoke \\
        --steps 50 --batch 8 --seq 128 [--device cpu] [--devices 4]
"""
from __future__ import annotations

import argparse
import math
import time

import torch


def _state_tree(params, opt_state) -> dict:
    return {"params": dict(params.named_parameters()), "opt": opt_state}


def save_state(directory: str, step: int, params, opt_state,
               grid=None) -> str | None:
    """Checkpoint ``step`` of the master weights (by name) and the
    optimizer state, atomically; returns its path.  With ``grid`` every
    rank calls it and writes its blocks of each full tensor
    (``store.save_blocks``; a block replicated over an axis is written by
    the axis's first rank): the same layout, by name, whatever the grid.
    Rank 0 returns the path, the others ``None``."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import leaf_paths, save_blocks
    tree = _state_tree(params, opt_state)
    if grid is None:
        return save_checkpoint(directory, step, tree)
    from repro_torch.launch import sharding
    at = dict(zip(grid.axis_names, grid.coords))
    leaves = []
    for path in leaf_paths(tree):
        x = tree
        for k in path:
            x = x[k]
        x = x.detach()
        if path[:2] == ("opt", "step"):
            shape, blocks = (), ([((), x)] if grid.rank == 0 else [])
        else:
            name = path[-1]
            spec = params.shard_specs[name]
            shape = params.full_shapes[name]
            used = {a for e in spec for a in sharding.axes_of(e)}
            # one writer a block: the first rank of every axis it is
            # replicated over
            first = all(at[a] == 0 for a in grid.axis_names if a not in used)
            slices = sharding.block_slices(spec, shape, grid)
            blocks = [(slices, x)] if first else []
        leaves.append((path, shape, x.dtype, blocks))
    return save_blocks(directory, step, leaves, rank=grid.rank,
                       barrier=torch.distributed.barrier)


@torch.no_grad()
def restore_state(directory: str, step: int, params, opt_state) -> None:
    """Load checkpoint ``step`` into ``params`` and ``opt_state`` in place
    (the same bits).  A rank's sharded decoder (``shard_specs``) loads its
    blocks of each full tensor, read memory-mapped, whatever grid wrote
    it."""
    from repro_torch.checkpoint import load_checkpoint
    like = _state_tree(params, opt_state)
    cut = None
    if getattr(params, "shard_specs", None) is not None:
        from repro_torch.launch import sharding
        grid = sharding.active_mesh()
        sharding.check_model_grid(params, grid)

        def cut(path, arr):
            if path[:2] == ("opt", "step"):
                return arr
            spec = params.shard_specs[path[-1]]
            return sharding.local_block(arr, spec, grid)
    tree = load_checkpoint(directory, step, like, params.device, cut)
    for name, p in like["params"].items():
        p.copy_(tree["params"][name])
    for k in ("m", "v"):
        for name, x in opt_state[k].items():
            x.copy_(tree["opt"][k][name])
    opt_state["step"].copy_(tree["opt"]["step"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--transport", default="gloo",
                    choices=("gloo", "nccl"),
                    help="the ranks' collectives with --devices N > 1")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if args.devices > 1:
        shape, names = grid_of(args.devices)
        check_grid(args.arch, args.smoke, shape, names)
        from repro_torch.launch.mesh import spawn
        spawn(_rank_main, args.devices, (vars(args), shape, names),
              transport=args.transport, deadline=24 * 3600.0,
              timeout=600.0)
        return
    run(args, device)


def grid_of(n: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The reference's grid for ``n`` ranks: ``(n // 2, 2)`` over
    ``(data, model)`` from 4 ranks on, else ``(n,)`` over ``data``."""
    if n >= 4:
        if n % 2:
            raise SystemExit(f"--devices {n}: the (data, model) grid needs "
                             f"an even count")
        return (n // 2, 2), ("data", "model")
    return (n,), ("data",)


def check_grid(arch: str, smoke: bool, shape, names) -> None:
    """Exit before any rank starts for what the grid cannot run yet
    (``launch.sharding.check_supported``: ROADMAP A13 part b item c)."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import make_mesh
    from repro_torch.launch import sharding
    try:
        sharding.check_supported(get_config(arch, smoke=smoke),
                                 make_mesh(shape, names))
    except ValueError as err:
        raise SystemExit(f"--devices {math.prod(shape)}: {err}") from err


def _rank_main(mesh, args: dict, shape, names) -> None:
    """One spawned rank of ``--devices N``: the grid over the world, the
    card this rank uses (one a rank on nccl, the first on gloo), then the
    loop."""
    import argparse as _ap
    from repro_torch.core.runtime import ProcessGrid
    from repro_torch.launch import sharding
    args = _ap.Namespace(**args)
    torch.set_num_threads(1)
    grid = ProcessGrid(mesh.transport, shape, names, staged=mesh.staged)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    with sharding.mesh_context(grid):
        run(args, device, grid)


def run(args, device, grid=None) -> None:
    """The training loop on one device, or as a rank of ``grid`` (rank 0
    prints)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    lead = grid is None or grid.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    cfg = get_config(args.arch, smoke=args.smoke)
    say(f"device: {device}")
    if grid is not None:
        say(f"mesh: {dict(grid.shape)} over {args.transport}")
    opt = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    tc = TrainConfig(num_microbatches=args.microbatches,
                     xent_chunk=min(64, args.seq))
    step_fn = make_train_step(cfg, opt, tc)
    params = M.init_train_params(cfg, args.seed, device=device, grid=grid)
    opt_state = init_opt_state(params)

    start = 0
    if args.ckpt_dir:
        resume = latest_step(args.ckpt_dir)
        if resume is not None:
            restore_state(args.ckpt_dir, resume, params, opt_state)
            start = resume
            where = "" if grid is None else \
                f" onto {dict(grid.shape)} (elastic)"
            say(f"resumed step {resume}{where}")

    slow_steps = 0
    t_hist = []
    for s in range(start, args.steps):
        batch = make_batch(args.seed, s, cfg, args.batch, args.seq,
                           device=device)
        t0 = time.time()
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])            # waits for the step
        dt = time.time() - t0
        t_hist.append(dt)
        # straggler detection: flag steps ≥3× trailing median (on a real
        # cluster this triggers the launcher's requeue path)
        if len(t_hist) > 5:
            med = sorted(t_hist[-20:])[len(t_hist[-20:]) // 2]
            if dt > 3 * med:
                slow_steps += 1
                say(f"[straggler] step {s} took {dt:.2f}s "
                    f"(median {med:.2f}s)")
        if (s + 1) % 10 == 0 or s + 1 == args.steps:
            moe = "".join(f"  {k} {float(m[k]):.4g}" for k in
                          ("moe_aux_loss", "moe_drop_frac") if k in m)
            say(f"step {s + 1:4d}  loss {loss:.4f}  "
                f"gnorm {float(m['grad_norm']):.3f}{moe}  "
                f"{dt * 1e3:.0f} ms", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, s + 1, params, opt_state, grid)
    say(f"finished {args.steps - start} steps; "
        f"{slow_steps} straggler events")


if __name__ == "__main__":
    main()
