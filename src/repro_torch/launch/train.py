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

It trains on one device: the card unless ``--device cpu`` is given, and
without a card and without it the launcher fails rather than run
elsewhere.  ``--devices N > 1`` (the reference's host-device mesh and
``launch.sharding``) waits for ROADMAP A13.  Every registered arch
trains: ``make_batch`` draws a cross-attending arch's image embeddings,
and a MoE arch's step also prints its load-balance loss and dropped
fraction.

    python -m repro_torch.launch.train --arch stablelm-3b --smoke \\
        --steps 50 --batch 8 --seq 128 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch


def save_state(directory: str, step: int, params, opt_state) -> str:
    """Checkpoint ``step`` of the master weights (by name) and the
    optimizer state, atomically; returns its path."""
    from repro_torch.checkpoint import save_checkpoint
    return save_checkpoint(directory, step, {
        "params": dict(params.named_parameters()), "opt": opt_state})


@torch.no_grad()
def restore_state(directory: str, step: int, params, opt_state) -> None:
    """Load checkpoint ``step`` into ``params`` and ``opt_state`` in place
    (the same bits)."""
    from repro_torch.checkpoint import load_checkpoint
    like = {"params": dict(params.named_parameters()), "opt": opt_state}
    tree = load_checkpoint(directory, step, like, params.device)
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
    args = ap.parse_args(argv)
    if args.devices > 1:
        raise SystemExit(f"--devices {args.devices}: training over a mesh "
                         f"(the reference's host-device mesh and "
                         f"launch.sharding) waits for ROADMAP A13")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"device: {device}")
    opt = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    tc = TrainConfig(num_microbatches=args.microbatches,
                     xent_chunk=min(64, args.seq))
    step_fn = make_train_step(cfg, opt, tc)
    params = M.init_train_params(cfg, args.seed, device=device)
    opt_state = init_opt_state(params)

    start = 0
    if args.ckpt_dir:
        resume = latest_step(args.ckpt_dir)
        if resume is not None:
            restore_state(args.ckpt_dir, resume, params, opt_state)
            start = resume
            print(f"resumed step {resume}")

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
                print(f"[straggler] step {s} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
        if (s + 1) % 10 == 0 or s + 1 == args.steps:
            moe = "".join(f"  {k} {float(m[k]):.4g}" for k in
                          ("moe_aux_loss", "moe_drop_frac") if k in m)
            print(f"step {s + 1:4d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}{moe}  "
                  f"{dt * 1e3:.0f} ms", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, s + 1, params, opt_state)
    print(f"finished {args.steps - start} steps; "
          f"{slow_steps} straggler events")


if __name__ == "__main__":
    main()
