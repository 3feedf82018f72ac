"""Serving launchers on the card (port of ``repro.launch.serve``): the LM
decode path and the particle request plane.

* ``--mode greedy|sample|smc`` — batched LM decoding
  (``repro_torch.serve.engine.generate``, or SMC particle decoding,
  ``repro_torch.serve.smc_decode``) on random weights drawn from a seed.
  ``--warmup`` runs go before the measured one; the reported tokens/s is
  the measured run's, its first-call time printed on its own line.
* ``--mode sessions`` — the asyncio request plane: a ``ParticleFrontend``
  over a resident ``ParticleSessionServer``, driven by a synthetic
  Poisson client fleet, reporting p50/p99 per-frame latency and the
  scheduler's counters, all read from the frontend's ``Metrics``
  snapshot.
* ``--mode fleet`` — the multi-bank controller: two active banks plus a
  standby, skewed Poisson clients with mid-run churn, printing the
  migration/scale counters and the per-bank report.

Both particle modes filter the 1-D linear-Gaussian demo model
(``lg_demo_model``) with 1024 particles a session.  Everything runs on
the card unless ``--device cpu`` is given; without a card and without it
the launcher fails rather than run elsewhere.

    python -m repro_torch.launch.serve --mode sessions \\
        --sessions 12 --capacity 8 --duration 3
    python -m repro_torch.launch.serve --mode fleet \\
        --sessions 8 --capacity 8 --duration 4
    python -m repro_torch.launch.serve --arch qwen3-32b --smoke \\
        --batch 4 --prompt-len 32 --steps 32 --mode greedy
"""
from __future__ import annotations

import argparse
import asyncio
import math
import time

import numpy as np
import torch

# the demo model's constants: x' = A x + sqrt(Q) e, z = H x + sqrt(R0) v
A, Q, H, R0 = 0.9, 0.5, 1.0, 0.4


def main(argv=None) -> None:
    """Parse args and dispatch to the LM or the particle front ends."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--mode", default="greedy",
                    choices=["greedy", "sample", "smc", "sessions", "fleet"])
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--particles", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed runs before the measured one (LM modes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    # sessions/fleet-mode knobs
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=8,
                    help="total slot budget (fleet mode splits it across "
                         "two banks + a standby)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="seconds of synthetic Poisson load")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="per-session mean frames/s")
    ap.add_argument("--max-delay", type=float, default=0.005,
                    help="scheduler deadline trigger in seconds")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if args.mode == "sessions":
        asyncio.run(_serve_sessions(args, device))
    elif args.mode == "fleet":
        asyncio.run(_serve_fleet(args, device))
    else:
        _serve_lm(args, device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _serve_lm(args, device) -> None:
    """LM decode modes: warm-up runs, then one measured run."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as M
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode

    cfg = get_config(args.arch, smoke=args.smoke)
    model = M.init_params(cfg, 0, device=device)
    rng = np.random.default_rng(1)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len) + books))
    img = None               # image embeddings of a cross-attending arch
    if cfg.cross_attn_every:
        img = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_image_tokens, cfg.d_image)).astype(np.float32))
    smc = SMCDecodeConfig(n_particles=args.particles, steps=args.steps)
    temp = 0.0 if args.mode == "greedy" else args.temperature

    def run(seed):
        if args.mode == "smc":
            out = smc_decode(model, prompt, smc, key=seed, device=device)
        else:
            out = generate(model, prompt, steps=args.steps, temperature=temp,
                           key=seed, img=img, device=device)
        _sync(device)
        return out

    t0 = time.perf_counter()
    for i in range(max(args.warmup, 0)):
        run(100 + i)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run(2)
    steady_s = time.perf_counter() - t0
    print(f"warmup ({args.warmup} runs): {first_s:.2f}s")
    if args.mode == "smc":
        print(f"SMC decode {tuple(out.sequences.shape)}: {steady_s:.2f}s "
              f"steady ({steady_s / args.steps * 1e3:.1f} ms/token-step), "
              f"logZ={[round(float(z), 3) for z in out.log_z]}")
    else:
        print(f"{args.mode} decode {tuple(out.shape)}: {steady_s:.2f}s "
              f"steady ({args.batch * args.steps / steady_s:.1f} tok/s "
              f"batch throughput)")


def lg_demo_model():
    """The 1-D linear-Gaussian model both particle modes drive (the
    reference launcher's ``_lg_demo_model``), as a closure
    ``StateSpaceModel`` over draws providers: a bank's draws lead with
    its slot dim, and an observation per slot broadcasts over the slot's
    particles."""
    from repro_torch.core.smc import StateSpaceModel

    def init_sampler(draws, n):
        return draws.normal((n, 1)) * 2.0

    def dynamics_sample(draws, s):
        return A * s + math.sqrt(Q) * draws.normal(
            s.shape[len(draws.batch_shape):])

    def log_likelihood(s, z):
        z = torch.as_tensor(z, dtype=torch.float32, device=s.device)
        z = z.reshape(z.shape + (1,) * (s.dim() - 1 - z.dim()))
        return -0.5 * (z - H * s[..., 0]) ** 2 / R0

    return StateSpaceModel(init_sampler, dynamics_sample, log_likelihood,
                           state_dim=1)


def _demo_server(capacity: int, device):
    from repro_torch.core import SIRConfig
    from repro_torch.serve import ParticleSessionServer
    return ParticleSessionServer(
        model=lg_demo_model(), sir=SIRConfig(n_particles=1024, ess_frac=0.5),
        capacity=capacity, device=device)


def _print_plane_report(snap: dict, label: str) -> None:
    """One request plane's report, read from its ``Metrics`` snapshot."""
    c = snap["counters"]
    lat = snap["series"].get("latency", {})
    coalesce = snap["series"].get("coalesce", {})
    print(f"{label} frames={c.get('frames', 0):.0f} "
          f"p50={lat.get('p50', 0.0) * 1e3:.1f}ms "
          f"p99={lat.get('p99', 0.0) * 1e3:.1f}ms "
          f"steps={c.get('steps', 0):.0f} "
          f"coalesce_mean={coalesce.get('mean', 0.0):.2f} "
          f"parks={c.get('park_events', 0):.0f} "
          f"resumes={c.get('resume_events', 0):.0f}")


async def _client(plane, sid, rate, until):
    """One Poisson client: open a stream seeded ``sid``, submit frames
    until ``until`` (loop clock), await them all, close."""
    rng = np.random.default_rng(sid)
    stream = await plane.open(sid)
    futs = []
    loop = asyncio.get_running_loop()
    while loop.time() < until:
        await asyncio.sleep(rng.exponential(1.0 / rate))
        futs.append(await plane.submit(stream, np.float32(rng.normal())))
    await asyncio.gather(*futs)
    await plane.close(stream)


async def _serve_sessions(args, device) -> None:
    """Drive the request plane with a synthetic Poisson fleet."""
    from repro_torch.serve import FrontendConfig, ParticleFrontend

    server = _demo_server(args.capacity, device)
    async with ParticleFrontend(
            server, FrontendConfig(max_delay=args.max_delay)) as fe:
        t0 = time.perf_counter()
        await fe.warmup(np.float32(0.0))
        print(f"warmup ({len(server.tiers)} tiers): "
              f"{time.perf_counter() - t0:.2f}s")
        until = asyncio.get_running_loop().time() + args.duration
        await asyncio.gather(*(_client(fe, i, args.rate, until)
                               for i in range(args.sessions)))
        snap = fe.snapshot()
    _print_plane_report(snap, f"sessions={args.sessions} "
                              f"capacity={args.capacity} device={device}")
    print(f"tier_hits={snap['tier_hits']} step_traces={snap['step_traces']}")


async def _serve_fleet(args, device) -> None:
    """Two active banks + a standby under skewed Poisson load with mid-run
    churn, so the rebalancer has work to do."""
    from repro_torch.launch.registry import BankSpec, FleetRegistry
    from repro_torch.serve import FleetConfig, FleetController, FrontendConfig

    per_bank = max(args.capacity // 2, 1)
    registry = FleetRegistry([BankSpec("a", per_bank),
                              BankSpec("b", per_bank),
                              BankSpec("spare", per_bank, standby=True)])
    cfg = FleetConfig(rebalance_interval=0.05,
                      frontend=FrontendConfig(max_delay=args.max_delay))
    async with FleetController(lambda spec: _demo_server(spec.capacity,
                                                         device),
                               registry, cfg) as fleet:
        t0 = time.perf_counter()
        await fleet.warmup(np.float32(0.0))
        print(f"warmup (2 banks): {time.perf_counter() - t0:.2f}s")
        now = asyncio.get_running_loop().time()
        # every 4th stream is hot (4x rate); the even half leaves early,
        # skewing residency so the rebalancer migrates survivors
        await asyncio.gather(*(
            _client(fleet, i, args.rate * (4.0 if i % 4 == 0 else 1.0),
                    now + args.duration * (0.4 if i % 2 == 0 else 1.0))
            for i in range(args.sessions)))
        snap = fleet.snapshot()
    c = snap["counters"]
    stall = snap["series"].get("migration_stall_frames", {})
    print(f"sessions={args.sessions} total_capacity={args.capacity} "
          f"device={device} migrations={c.get('migrations', 0):.0f} "
          f"stall_frames_mean={stall.get('mean', 0.0):.2f} "
          f"scale_out={c.get('scale_out_events', 0):.0f} "
          f"scale_in={c.get('scale_in_events', 0):.0f} "
          f"bank_failures={c.get('bank_failures', 0):.0f}")
    for name, bank in sorted(snap["banks"].items()):
        _print_plane_report(bank["frontend"],
                            f"bank {name} cap={bank['capacity']} "
                            f"streams={bank['live_streams']} "
                            f"dead={bank['dead']}")


if __name__ == "__main__":
    main()
