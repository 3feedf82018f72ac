"""Workers of the sharded LM's checks (``launch.sharding``): each runs on
the spawned ranks of ``launch.mesh.spawn``, builds the process grid a
case names over the world, and returns host tensors for the caller to
hold against one device or the reference.

* ``train_case`` — train steps of a rank's sharded decoder (the
  reference's numpy weights cut to the rank's blocks, or drawn from a
  seed a layer at a time) on global batches: every step's metrics, the
  first step's gradients and the weights after the last step, gathered
  whole (rank 0 returns them), a checkpoint if asked.
* ``restore_case`` — a checkpoint restored onto the grid (elastic
  resume), its full tensors gathered back.
* ``serve_case`` — ``make_serve_step`` prefill and greedy decode steps:
  the global logits of every step, the tokens, the flash kernel's
  launches on this rank and the plain version's calls.
* ``moe_ep_case`` — ``moe.apply_moe_ep`` (or ``apply_moe_global``) on
  the rank's rows, its routing and, with a cotangent, its gradients.
* ``collective_case`` — each differentiable collective of
  ``core.runtime`` on the rank's shard, forward and backward.
* ``grid_phase`` — the card's checks at full width (``chip_smoke.py``
  phase 5n): a train step held leaf by leaf to one device's, the loss
  over steps, repeat runs and an elastic resume compared by grid-invariant
  digests, the expert-parallel MoE step, and serving with the flash
  kernel on each rank's heads; the one-device baselines run on rank 0
  before the grid's work starts and are freed first.

Nothing here imports ``jax``, starts a process group or touches CUDA at
import.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.launch import sharding as SH


def grid_of(mesh, case: dict) -> runtime.ProcessGrid:
    """The case's grid (``shape``, ``names``) over the spawned world."""
    return runtime.ProcessGrid(mesh.transport, tuple(case["shape"]),
                               tuple(case["names"]), staged=mesh.staged)


def _device(case: dict) -> torch.device:
    dev = torch.device(case.get("device", "cpu"))
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _decoder(case: dict, grid, device, train: bool):
    """The rank's decoder of the case's weights: ``params`` (the
    reference's numpy pytree) or ``seed``."""
    from repro_torch import convert
    from repro_torch.models.lm import model as M
    cfg = case["cfg"]
    if case.get("params") is not None:
        if train:
            return convert.train_params(case["params"], cfg, device, grid)
        return convert.lm_params(case["params"], cfg, device, grid=grid)
    if train:
        return M.init_train_params(cfg, case["seed"], device=device,
                                   grid=grid)
    return M.shard_params(cfg, case["seed"], device=device, grid=grid)


def full_named(model, grid, only_rank0: bool = True) -> dict | None:
    """Every weight of a rank's decoder gathered whole, by name, on the
    host (``None`` off rank 0 with ``only_rank0``; every rank gathers)."""
    out = {}
    for name, p in model.named_parameters():
        full = SH.gather_full(p.detach(), model.shard_specs[name], grid)
        out[name] = full.cpu()
    return out if grid.rank == 0 or not only_rank0 else None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_case(mesh, case: dict) -> dict:
    """``case``: ``cfg``, ``shape``/``names``, ``params`` or ``seed``,
    ``opt`` (``OptConfig`` fields), ``tc`` (``TrainConfig`` fields),
    ``batches`` (global numpy batches, or ``make_batch`` arguments
    ``{"make": (seed, batch, seq), "steps": n}``), optionally ``grads``
    (return the first step's gradients whole), ``ckpt`` (``(dir, step)``:
    save after that step), ``final`` (return the weights whole after the
    last step, default true), ``device``.  Returns ``metrics`` (a dict
    of floats a step), ``ms`` (each step's wall time), ``grads`` and
    ``params`` (rank 0), the staged bytes and the peak device memory."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch.train import save_state
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    torch.set_num_threads(int(case.get("threads", 1)))
    grid = grid_of(mesh, case)
    device = _device(case)
    cfg = case["cfg"]
    out = {"metrics": [], "ms": []}
    with SH.mesh_context(grid):
        params = _decoder(case, grid, device, train=True)
        state = init_opt_state(params)
        step = make_train_step(cfg, OptConfig(**case.get("opt", {})),
                               TrainConfig(**case.get("tc", {})))
        batches = case["batches"]
        if isinstance(batches, dict):
            seed, b, t = batches["make"]
            batches = [lambda s=s: make_batch(seed, s, cfg, b, t,
                                              device=device)
                       for s in range(batches["steps"])]
        staged = mesh.staged.bytes
        for s, batch in enumerate(batches):
            batch = batch() if callable(batch) else _tensors(batch, device)
            grads = {} if (s == 0 and case.get("grads")) else None
            _sync(device)
            t0 = time.perf_counter()
            _, _, met = step(params, state, batch, grads_out=grads)
            met = {k: float(v) for k, v in met.items()}
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(met)
            if grads is not None:
                out["grads"] = {n: SH.gather_full(g, params.shard_specs[n],
                                                  grid).cpu()
                                for n, g in grads.items()}
                if grid.rank:
                    out["grads"] = None
            if case.get("ckpt") and s + 1 == case["ckpt"][1]:
                save_state(case["ckpt"][0], s + 1, params, state, grid)
        out["staged_bytes"] = mesh.staged.bytes - staged
        if case.get("final", True):
            out["params"] = full_named(params, grid)
        if case.get("digest"):
            from repro_torch.launch.grid import digest
            out["digest"] = digest({n: p.detach() for n, p in
                                    params.named_parameters()})
        if device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def restore_case(mesh, case: dict) -> dict:
    """Restore checkpoint ``case["ckpt"]`` (``(dir, step)``) onto the
    case's grid and return its full tensors gathered (rank 0): the
    weights and both moments by name, and the step."""
    from repro_torch.launch.train import restore_state
    from repro_torch.models.lm import model as M
    from repro_torch.optim import init_opt_state
    torch.set_num_threads(1)
    grid = grid_of(mesh, case)
    device = _device(case)
    with SH.mesh_context(grid):
        params = M.init_train_params(case["cfg"], case.get("seed", 1),
                                     device=device, grid=grid)
        state = init_opt_state(params)
        restore_state(case["ckpt"][0], case["ckpt"][1], params, state)
        out = {"params": full_named(params, grid), "step": int(state["step"])}
        for k in ("m", "v"):
            full = {n: SH.gather_full(x, params.shard_specs[n], grid).cpu()
                    for n, x in state[k].items()}
            out[k] = full if grid.rank == 0 else None
    return out


def greedy(prefill, decode, prompt, steps: int, device, forced=None,
           staged=None) -> dict:
    """``steps`` greedy positions after ``prompt``'s prefill through the
    serve steps (``make_serve_step``'s): the last position's logits of the
    prefill and of each of ``steps - 1`` decode steps (float32, host),
    each one's argmax ``(B, 1)``, the caches, the prefill's and the
    decodes' seconds and, with ``staged`` (a ``runtime.Staged``), the
    bytes the prefill staged.  With ``forced`` decode step ``j`` is fed
    ``forced[j - 1]`` instead of the argmax before it."""
    t = prompt.shape[1]
    out = {"logits": [], "tokens": []}
    before = staged.bytes if staged is not None else 0
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill({"tokens": prompt})
    _sync(device)
    t1 = time.perf_counter()
    out["prefill_staged"] = staged.bytes - before if staged is not None \
        else 0
    for j in range(steps):
        if j:
            feed = out["tokens"][-1] if forced is None else forced[j - 1]
            logits, caches = decode({"tokens": feed.to(device),
                                     "pos": t + j - 1, "caches": caches})
        out["logits"].append(logits[:, -1].float().cpu())
        out["tokens"].append(logits[:, -1:].argmax(-1).cpu())
    _sync(device)
    out.update(caches=caches, prefill_s=t1 - t0,
               decode_s=time.perf_counter() - t1)
    return out


def serve_case(mesh, case: dict) -> dict:
    """``case``: ``cfg``, ``shape``/``names``, ``params`` or ``seed``,
    ``tokens`` (global ``(B, T)`` prompts), ``steps`` (greedy positions),
    ``max_len``, ``device``.  Returns ``greedy``'s logits and tokens
    (global), the flash kernel's launches (by variant) and the plain
    version's calls on this rank, the staged bytes, the times and a
    layer's cache shape."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.train import make_serve_step
    torch.set_num_threads(int(case.get("threads", 1)))
    grid = grid_of(mesh, case)
    device = _device(case)
    kernel = flash_attention.flash_attention_kernel
    with SH.mesh_context(grid), torch.no_grad():
        model = _decoder(case, grid, device, train=False)
        tokens = torch.as_tensor(np.asarray(case["tokens"])).to(device)
        max_len = case.get("max_len") or tokens.shape[1] + case["steps"]
        launches, variants = kernel.launches, dict(kernel.variants)
        plain, staged = ref.mha_ref.calls, mesh.staged.bytes
        run = greedy(make_serve_step(model, "prefill", max_len),
                     make_serve_step(model, "decode"), tokens,
                     case["steps"], device)
    caches = run.pop("caches")
    return dict(run, launches=kernel.launches - launches,
                variants={k: v - variants.get(k, 0)
                          for k, v in kernel.variants.items()},
                plain_calls=ref.mha_ref.calls - plain,
                staged_bytes=mesh.staged.bytes - staged,
                cache_shape=tuple(caches[0]["k"].shape)
                if "k" in caches[0] else None)


def moe_ep_case(mesh, case: dict) -> dict:
    """``case``: ``moe`` (a ``MoEConfig``), ``shape``/``names``, ``x``
    (global ``(B, T, D)`` numpy), ``weights`` (the full MoE leaves by
    name, numpy; ``shared`` a dict), ``dispatch`` (``"ep"`` or
    ``"global"``), optionally ``cotangent`` (global, like ``x``: the
    gradients of ``sum(out · cotangent) + aux loss`` are returned whole).
    Returns the rank's routing record, the global output and aux values
    and (with a cotangent) the gradients of ``x`` and of every weight,
    whole."""
    from repro_torch.models.lm import moe as MOE
    torch.set_num_threads(1)
    grid = grid_of(mesh, case)
    cfg = case["moe"]
    want_grad = case.get("cotangent") is not None
    with SH.mesh_context(grid):
        keep = SH.RankBlocks(grid)
        ep = case.get("dispatch", "ep") == "ep"

        def leaf(name, x):
            spec = SH.fit_spec(SH.param_spec(name, x.shape, grid), x.shape,
                               grid)
            t = torch.from_numpy(np.ascontiguousarray(keep(name, x)))
            t.requires_grad_(want_grad)
            blocks[name] = (t, spec)
            axes = SH.gather_axes_of(name, spec, grid, ep)
            return SH.gather_leaf(t, spec, grid, axes) if axes else t

        blocks = {}
        p = {}
        for k, v in case["weights"].items():
            if isinstance(v, dict):
                p[k] = {j: leaf(f"moe.{k}.{j}", np.asarray(w, np.float32))
                        for j, w in v.items()}
            else:
                p[k] = leaf(f"moe.{k}", np.asarray(v, np.float32))
        rows = SH.batch_slice(torch.from_numpy(
            np.asarray(case["x"], np.float32)), grid).requires_grad_(
                want_grad)
        record = {}
        if ep:
            out, aux = MOE.apply_moe_ep(p, rows, cfg, grid, record)
        else:
            out, aux = MOE.apply_moe_global(p, rows, cfg, grid)
        res = {"record": _host(record),
               "aux": {k: v.detach().clone() for k, v in aux.items()}}
        spec_rows = (SH.batch_axes(grid),) + (None,) * (out.dim() - 1)
        res["out"] = SH.gather_full(out.detach(), spec_rows, grid)
        if want_grad:
            cot = SH.batch_slice(torch.from_numpy(
                np.asarray(case["cotangent"], np.float32)), grid)
            ((out * cot).sum() + aux["moe_aux_loss"]
             / SH.batch_shards(grid)).backward()
            res["grad_x"] = SH.gather_full(rows.grad, spec_rows, grid)
            grads = {}
            for name, (t, spec) in blocks.items():
                g = t.grad
                if not any(a in SH.axes_of(e) for e in spec
                           for a in SH.batch_axes(grid)):
                    g = SH.psum_over(g, grid, SH.batch_axes(grid))
                grads[name] = SH.gather_full(g, spec, grid)
            res["grads"] = grads
    return res


def collective_case(mesh, case: dict) -> dict:
    """Each differentiable collective of ``core.runtime`` on this rank's
    shard of ``case``'s per-shard numpy inputs (shard dim first), its
    output and the gradient of ``sum(output · cotangent)``: a 1-D mesh of
    the world (``case["axis"]``)."""
    torch.set_num_threads(1)
    line = runtime.ProcessMesh(mesh.transport, case.get("axis", "data"),
                               staged=mesh.staged)
    return collectives(line, case["inputs"])


VERBS = {
    "fsdp_gather": lambda x, m: runtime.fsdp_gather(x, m, 2),
    "tp_copy": runtime.tp_copy,
    "tp_reduce": runtime.tp_reduce,
    "tp_mean": runtime.tp_mean,
    "tp_scatter": lambda x, m: runtime.tp_scatter(x, m, 2),
    "tp_gather": lambda x, m: runtime.tp_gather(x, m, 2),
    "all_to_all_grad": runtime.all_to_all_grad,
}


def collectives(mesh, inputs: dict) -> dict:
    """``VERBS`` on the shards ``mesh`` holds of ``inputs[verb]`` (``x``
    and ``cotangent``, per-shard numpy with the shard dim first): each
    verb's output and input gradient, host tensors with the held shards
    first."""
    held = runtime.shard_range(mesh)
    out = {}
    for name, verb in VERBS.items():
        x, cot = (torch.from_numpy(np.ascontiguousarray(
            inputs[name][k][held.start:held.stop])) for k in ("x", "cot"))
        x.requires_grad_(True)
        y = verb(x, mesh)
        (y * cot).sum().backward()
        out[name] = {"y": y.detach().clone(), "grad": x.grad.clone()}
    return out


def collective_inputs(p: int, seed: int = 0) -> dict:
    """Per-shard inputs and cotangents for ``collectives`` over ``p``
    shards (float64, so finite differences resolve them)."""
    rng = np.random.default_rng(seed)

    def pair(x_shape, y_shape):
        return {"x": rng.standard_normal(x_shape),
                "cot": rng.standard_normal(y_shape)}

    n = 2 * p
    return {"fsdp_gather": pair((p, 3, 2), (p, 3, 2 * p)),
            "tp_copy": pair((p, 3, 4), (p, 3, 4)),
            "tp_reduce": pair((p, 3, 4), (p, 3, 4)),
            "tp_mean": pair((p, 3, 4), (p, 3, 4)),
            "tp_scatter": pair((p, 3, n), (p, 3, n // p)),
            "tp_gather": pair((p, 3, 2), (p, 3, 2 * p)),
            "all_to_all_grad": pair((p, p, 2, 3), (p, p, 2, 3))}



# ---------------------------------------------------------------------------
# the card's checks at full width
# ---------------------------------------------------------------------------

def _say(msg: str) -> None:
    """Rank 0's progress line (the ranks share the caller's stdout)."""
    if torch.distributed.get_rank() == 0:
        print(f"[rank 0] {msg}", flush=True)


def _memory(device) -> str:
    if device.type != "cuda":
        return ""
    return (f", {torch.cuda.memory_allocated(device) / 2**30:.1f} GiB "
            f"allocated, {torch.cuda.memory_reserved(device) / 2**30:.1f} "
            f"reserved")


def _barrier(device):
    _sync(device)
    torch.distributed.barrier()


def _free(device):
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _state_digest(params, state, grid) -> dict:
    """The grid-invariant digest of every master weight and both moments."""
    tensors = {f"p.{n}": p for n, p in params.named_parameters()}
    specs = {f"p.{n}": params.shard_specs[n] for n in params.shard_specs}
    for k in ("m", "v"):
        tensors.update({f"{k}.{n}": x for n, x in state[k].items()})
        specs.update({f"{k}.{n}": params.shard_specs[n] for n in state[k]})
    return SH.grid_digest(tensors, specs, grid)


def _one_device_grads(cfg, seed, tc, batch, device) -> dict:
    """Rank 0's baseline: the one-device step-0 loss and gradients (on the
    host) of the same weights, drawn whole from the seed."""
    from repro_torch.models.lm import model as M
    from repro_torch.train.step import accumulate_grads
    model = M.init_train_params(cfg, seed, device=device)
    met = accumulate_grads(model, cfg, tc, batch)
    out = {"loss": float(met["loss"]),
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}
    del model, met
    return out


def _grad_errors(grads: dict, specs: dict, grid, base: dict | None) -> dict:
    """Each leaf's gradient gathered to rank 0's host memory and its
    relative L2 error against the baseline's there (``{}`` on the other
    ranks)."""
    errs = {}
    for name, g in grads.items():
        full = SH.gather_to_root(g, specs[name], grid, "cpu")
        if full is None:
            continue
        want = base["grads"][name]
        ok = bool(torch.isfinite(full).all())
        norm = float(torch.linalg.vector_norm(want.float()))
        errs[name] = (float(torch.linalg.vector_norm(full.float()
                                                     - want.float()))
                      / norm if ok and norm > 0 else float("inf"))
    return errs


def _train_run(cfg, s, grid, device, steps, *, compare=False, base=None,
               ckpt=None, digest_at=()):
    """``steps`` sharded steps from the seed's weights on ``grid``: the
    losses, step times, with ``compare`` the step-0 gradient errors
    against ``base`` (rank 0's; every rank gathers), the
    digests after each step of ``digest_at``, a checkpoint
    (``(dir, step)``), the MoE metrics, staged bytes and peak memory."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch.train import save_state
    from repro_torch.models.lm import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    out = {"losses": [], "ms": [], "digests": {}, "metrics": []}
    with SH.mesh_context(grid):
        params = M.init_train_params(cfg, s["seed"], device=device,
                                     grid=grid)
        _free(device)            # the full layers drawn before each cut
        state = init_opt_state(params)
        step = make_train_step(cfg, OptConfig(**s["opt"]),
                               TrainConfig(**s["tc"]))
        _say(f"{cfg.name} on {dict(grid.shape)}: drawn{_memory(device)}")
        staged = grid.staged.bytes
        for i in range(steps):
            batch = make_batch(s["seed"], i, cfg, s["batch"], s["seq"],
                               device=device)
            grads = {} if (i == 0 and compare) else None
            _sync(device)
            t0 = time.perf_counter()
            _, _, met = step(params, state, batch, grads_out=grads)
            out["losses"].append(float(met["loss"]))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append({k: float(v) for k, v in met.items()})
            _say(f"step {i + 1}: loss {out['losses'][-1]:.4f}, "
                 f"{out['ms'][-1]:.0f} ms{_memory(device)}")
            if grads is not None:
                out["grad_errors"] = _grad_errors(grads, params.shard_specs,
                                                  grid, base)
                del grads
            if ckpt is not None and i + 1 == ckpt[1]:
                t0 = time.perf_counter()
                save_state(ckpt[0], i + 1, params, state, grid)
                out["ckpt_s"] = time.perf_counter() - t0
                _say(f"checkpoint in {out['ckpt_s']:.1f} s")
                out["digests"][f"ckpt {i + 1}"] = _state_digest(params,
                                                                state, grid)
            if i + 1 in digest_at:
                out["digests"][i + 1] = _state_digest(params, state, grid)
        out["staged_bytes"] = grid.staged.bytes - staged
        out["params_local"] = sum(p.numel() for p in params.parameters())
        if cfg.moe is not None:
            # the MoE layers' aux values of a forward of the first batch
            # at the trained weights (the step reports no largest load)
            with torch.no_grad():
                tokens = SH.batch_slice(make_batch(
                    s["seed"], 0, cfg, s["batch"], s["seq"],
                    device=device)["tokens"], grid)
                _, aux = M.forward_train(params, tokens)
            out["aux"] = {k: float(v) for k, v in aux.items()}
        if device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        del params, state, step
    return out


def _train_checks(mesh, s: dict, device) -> dict:
    """Phase 5n a and b on the ranks: rank 0's one-device baseline, then
    on ``s["shape"]`` a run of ``s["steps"]`` (the step-0 gradients
    against the baseline, a checkpoint, digests), with ``s["repeat"]`` a
    second run of that many steps (the same digest), with ``s["elastic"]``
    the checkpoint restored onto that grid (its digest); with
    ``s["drops"]`` also the config ``s["drops"]["cfg"]`` twice."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch.train import restore_state
    from repro_torch.models.lm import model as M
    from repro_torch.optim import init_opt_state
    from repro_torch.train import TrainConfig
    cfg = s["cfg"]
    rec = {}
    base = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        base = _one_device_grads(
            cfg, s["seed"], TrainConfig(**s["tc"]),
            make_batch(s["seed"], 0, cfg, s["batch"], s["seq"],
                       device=device), device)
        rec["baseline_loss"] = base["loss"]
        rec["baseline_s"] = time.perf_counter() - t0
        _say(f"{cfg.name}: one device's step-0 in {rec['baseline_s']:.1f} "
             f"s{_memory(device)}")
        if device.type == "cuda":
            rec["baseline_peak_gib"] = \
                torch.cuda.max_memory_allocated(device) / 2**30
    _free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _barrier(device)
    grid = runtime.ProcessGrid(mesh.transport, tuple(s["shape"]),
                               tuple(s["names"]), staged=mesh.staged)
    t0 = time.perf_counter()
    rec["run"] = _train_run(cfg, s, grid, device, s["steps"], compare=True,
                            base=base, ckpt=s.get("ckpt"),
                            digest_at=(s["repeat"],))
    rec["run_s"] = time.perf_counter() - t0
    del base
    _free(device)
    if s.get("repeat"):
        t0 = time.perf_counter()
        rec["repeat"] = _train_run(cfg, s, grid, device, s["repeat"],
                                   digest_at=(s["repeat"],))
        rec["repeat_s"] = time.perf_counter() - t0
        _free(device)
    if s.get("elastic"):
        t0 = time.perf_counter()
        line = runtime.ProcessGrid(mesh.transport, tuple(s["elastic"]),
                                   ("data",), staged=mesh.staged)
        with SH.mesh_context(line):
            params = M.init_train_params(cfg, s["seed"] + 1, device=device,
                                         grid=line)
            state = init_opt_state(params)
            restore_state(s["ckpt"][0], s["ckpt"][1], params, state)
            rec["restored_step"] = int(state["step"])
            rec["restored"] = _state_digest(params, state, line)
            del params, state
        rec["restore_s"] = time.perf_counter() - t0
        _free(device)
    if s.get("drops"):
        d = dict(s, cfg=s["drops"]["cfg"])
        rec["drops"] = [_train_run(d["cfg"], d, grid, device,
                                   s["drops"]["steps"],
                                   digest_at=(s["drops"]["steps"],))
                        for _ in range(2)]
        _free(device)
    return rec


def _serve_checks(mesh, s: dict, device) -> dict:
    """Phase 5n c on the ranks: rank 0's one-device greedy run of the
    seed's model, then on ``s["shape"]`` the same positions through
    ``make_serve_step``, fed the baseline's tokens: every step's logits
    (rank 0's gap to the baseline), the argmax, the flash kernel's
    launches and variants and the plain version's calls on each rank,
    times and staged bytes."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models.lm import model as M
    from repro_torch.train import make_serve_step
    cfg, steps = s["cfg"], s["steps"]
    kernel = flash_attention.flash_attention_kernel
    prompt = torch.as_tensor(np.asarray(s["prompt"])).to(device)
    max_len = prompt.shape[1] + steps + 1

    def reset():
        kernel.launches = 0
        kernel.variants.update(dict.fromkeys(kernel.variants, 0))

    rec = {}
    base = None
    with torch.no_grad():
        if mesh.rank == 0:
            model = M.init_params(cfg, s["seed"], device=device)
            reset()
            base = greedy(make_serve_step(model, "prefill", max_len),
                          make_serve_step(model, "decode"), prompt, steps,
                          device)
            rec["baseline_launches"] = kernel.launches
            rec["baseline_variants"] = dict(kernel.variants)
            del model, base["caches"]
            _say(f"serving {cfg.name}: one device's run done")
        _free(device)
        # every rank feeds the baseline's tokens (rank 0 sends them)
        objs = [None if base is None else base["tokens"]]
        torch.distributed.broadcast_object_list(objs, src=0)
        _barrier(device)
        grid = runtime.ProcessGrid(mesh.transport, tuple(s["shape"]),
                                   tuple(s["names"]), staged=mesh.staged)
        with SH.mesh_context(grid):
            model = M.shard_params(cfg, s["seed"], device=device, grid=grid)
            _free(device)
            _say(f"serving {cfg.name} on {dict(grid.shape)}: drawn"
                 f"{_memory(device)}")
            reset()
            plain, staged = ref.mha_ref.calls, grid.staged.bytes
            run = greedy(make_serve_step(model, "prefill", max_len),
                         make_serve_step(model, "decode"), prompt, steps,
                         device, forced=objs[0], staged=grid.staged)
            rec.update(launches=kernel.launches,
                       variants=dict(kernel.variants),
                       plain_calls=ref.mha_ref.calls - plain,
                       prefill_s=run["prefill_s"], decode_s=run["decode_s"],
                       prefill_staged_bytes=run["prefill_staged"],
                       decode_staged_bytes=grid.staged.bytes - staged
                       - run["prefill_staged"],
                       cache_shape=tuple(run["caches"][0]["k"].shape),
                       params_local=sum(p.numel()
                                        for p in model.parameters()))
            if device.type == "cuda":
                rec["peak_gib"] = \
                    torch.cuda.max_memory_allocated(device) / 2**30
            del model, run["caches"]
        if base is not None:
            gaps, ties, flips = [], 0, 0
            for g, w, tg, tw in zip(run["logits"], base["logits"],
                                    run["tokens"], base["tokens"]):
                gaps.append(float((g - w).abs().max()))
                top2 = w.topk(2, -1).values
                tie = (top2[:, 0] - top2[:, 1]) <= s["tol"]
                other = tg[:, 0] != tw[:, 0]
                flips += int((other & ~tie).sum())
                ties += int((other & tie).sum())
            rec.update(max_gap=max(gaps), gaps=gaps, flips=flips,
                       tie_flips=ties, steps=len(gaps))
    _free(device)
    return rec


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process, by name."""
    from repro_torch.kernels import (flash_attention, patch_likelihood,
                                     resample, row_sum, scan, sir_fused)
    kernels = {
        "patch_log_likelihood": patch_likelihood.patch_log_likelihood_kernel,
        "fused_weight_step": sir_fused.fused_weight_step_kernel,
        "systematic_ancestors": resample.systematic_ancestors_kernel,
        "metropolis_ancestors": resample.metropolis_ancestors_kernel,
        "rejection_ancestors": resample.rejection_ancestors_kernel,
        "flash_attention": flash_attention.flash_attention_kernel,
        "prefix_sum": scan.prefix_sum_kernel,
        "row_sum": row_sum.row_sum_kernel}
    return {n: k.launches for n, k in kernels.items()}


def grid_phase(mesh, spec: dict) -> dict:
    """The card's grid checks (``chip_smoke.py`` phase 5n) on this rank:
    ``spec["train"]`` (a), ``spec["moe"]`` (b) and ``spec["serve"]`` (c),
    each optional, on the spawned world's ranks, which share the card
    (gloo).  Returns the rank's record."""
    torch.set_num_threads(int(spec.get("threads", 1)))
    device = _device(spec)
    out = {}
    for part, fn in (("train", _train_checks), ("moe", _train_checks),
                     ("serve", _serve_checks)):
        if part in spec:
            t0 = time.perf_counter()
            before = kernel_launches()
            out[part] = fn(mesh, spec[part], device)
            out[part]["seconds"] = time.perf_counter() - t0
            out[part]["kernel_launches"] = {
                n: v - before[n] for n, v in kernel_launches().items()}
    return out


CASES = {"train": train_case, "restore": restore_case, "serve": serve_case,
         "moe": moe_ep_case, "collectives": collective_case}


def run_cases(mesh, cases: list) -> list:
    """Every case in turn on one spawn (``case["fn"]`` names its worker in
    ``CASES``): the checks spawn a world once for many cases."""
    return [CASES[c["fn"]](mesh, c) for c in cases]
