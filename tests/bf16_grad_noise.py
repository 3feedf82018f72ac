"""How far a bfloat16-compute gradient lies from the float32-compute one,
leaf by leaf, in the reference and in the port, at one depth and narrow
width (the CPU's).

    PYTHONPATH=src python tests/bf16_grad_noise.py [--arch mamba2-1.3b]
        [--layers 48] [--d-model 256] [--seq 1024]

Both packages take the reference's ``init_params`` weights (float32
masters, the seed's decay leaves) and one batch of tokens; each computes
its ``_loss_fn`` gradient twice, with ``compute_dtype`` bfloat16 and
float32.  For every leaf and layer it prints the relative L2 distance
``|g_bf16 - g_f32| / |g_f32|`` of each package, the largest and the
median over the layers.  The port is held to chip_smoke.py's gate b on
the card against the float32-compute gradient; this script shows what
the reference's own semantics (every float weight cast to the compute
dtype, ``a_log`` and ``dt_bias`` inside exponentials) give at the same
depth, which the card's full width cannot be compared with directly
(the reference does not run there).
"""
import argparse
import dataclasses
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro.configs import get_config  # noqa: E402
from repro.models.lm import model as JM  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402


def grads(params, jcfg, batch, chunk):
    """``{compute dtype: (reference grads, port grads)}`` as numpy
    pytrees in the reference's layout."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(jcfg, compute_dtype=dt)
        tc = JS.TrainConfig(xent_chunk=chunk)
        ref = jax.jit(jax.grad(lambda p, b: JS._loss_fn(p, cfg, tc, b)[0]))(
            params, batch)
        tcfg = convert.arch_config(dataclasses.asdict(cfg))
        model = convert.train_params(params, tcfg)
        loss, _ = TS._loss_fn(model, tcfg, TS.TrainConfig(xent_chunk=chunk),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        loss.backward()
        port = convert.lm_tree(tcfg, {n: p.grad for n, p in
                                      model.named_parameters()})
        out[dt] = (jax.tree_util.tree_map(np.asarray, ref), port)
    return out


def rel_l2_by_layer(g32, g16):
    """``{leaf path: [relative L2 a layer]}`` (a stacked group's leaves
    split on their layer axis; an unstacked leaf is one entry)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(g32)[0]
    for (path, a), b in zip(flat, jax.tree_util.tree_leaves(g16)):
        name = jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.asarray(b)
        rows = (range(a.shape[0]) if name.startswith("['blocks']")
                else [None])
        out[name] = [float(np.linalg.norm(b[i] - a[i])
                           / np.linalg.norm(a[i])) if i is not None else
                     float(np.linalg.norm(b - a) / np.linalg.norm(a))
                     for i in rows]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    jcfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                               d_model=args.d_model,
                               vocab_size=args.vocab)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.key(args.seed), jcfg))
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, args.vocab, (args.batch, args.seq)).astype(
        np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    g = grads(params, jcfg, batch, min(512, args.seq))
    ref = rel_l2_by_layer(g["float32"][0], g["bfloat16"][0])
    port = rel_l2_by_layer(g["float32"][1], g["bfloat16"][1])
    print(f"{args.arch}: {args.layers} layers, d_model {args.d_model}, "
          f"{args.batch} x {args.seq} tokens; bf16 vs float32 gradient, "
          f"relative L2 a layer (max over layers, median)")
    for name in ref:
        r, p = ref[name], port[name]
        print(f"  {name:45s} reference {max(r):.4f} ({np.median(r):.4f})"
              f"  port {max(p):.4f} ({np.median(p):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
