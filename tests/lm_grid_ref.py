"""The reference side of the sharded LM's checks, run in a subprocess of
its own with four simulated host devices (the flag must be set before
JAX starts):

    python tests/lm_grid_ref.py IN.pkl OUT.pkl

``IN.pkl`` holds a list of cells:

* ``{"kind": "train", "arch", "fields", "shape", "names", "params",
  "batches", "opt", "tc"}`` — the reference's ``make_train_step`` under
  ``mesh_context`` of a host mesh of ``shape`` (its weights and moments
  placed by ``make_param_shardings``), one jitted step a batch: every
  step's metrics and the weights after the last;
* ``{"kind": "moe_ep", "moe", "shape", "names", "x", "weights",
  "cotangent"}`` — ``apply_moe_ep`` under ``mesh_context``: the output,
  the aux values and the gradients of ``sum(out · cotangent) + aux
  loss`` with respect to ``x`` and every weight;
* ``{"kind": "moe_global", "moe", "x", "weights", "cotangent"}`` — the
  same of the one-device ``apply_moe`` (GSPMD's global routing).

``OUT.pkl`` receives one result a cell, numpy.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro.launch.sharding import (make_param_shardings,  # noqa: E402
                                   mesh_context)
from repro.models.lm import moe as MOE  # noqa: E402
from repro.optim import OptConfig, init_opt_state  # noqa: E402
from repro.train import step as S  # noqa: E402


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))


def _arch(fields: dict) -> ArchConfig:
    from repro.configs import base
    fields = dict(fields)
    subs = {"moe": base.MoEConfig, "mla": base.MLAConfig,
            "ssm": base.SSMConfig, "rglru": base.RGLRUConfig}
    for name, cls in subs.items():
        if fields.get(name) is not None:
            sub = dict(fields[name])
            if "block_pattern" in sub:
                sub["block_pattern"] = tuple(sub["block_pattern"])
            fields[name] = cls(**sub)
    fields["layer_pattern"] = tuple(fields.get("layer_pattern", ()))
    return ArchConfig(**fields)


def train(cell):
    cfg = _arch(cell["fields"])
    mesh = _mesh(cell["shape"], cell["names"])
    with mesh_context(mesh):
        params = jax.tree_util.tree_map(jnp.asarray, cell["params"])
        sh = make_param_shardings(mesh, params)
        params = jax.device_put(params, sh)
        state = init_opt_state(params)
        step = jax.jit(S.make_train_step(cfg, OptConfig(**cell["opt"]),
                                         S.TrainConfig(**cell["tc"])))
        mets = []
        for batch in cell["batches"]:
            params, state, met = step(params, state, batch)
            mets.append({k: float(v) for k, v in met.items()})
    return {"metrics": mets,
            "params": jax.tree_util.tree_map(np.asarray, params)}


def moe(cell):
    cfg = MoEConfig(**cell["moe"])
    ep = cell["kind"] == "moe_ep"
    apply = MOE.apply_moe_ep if ep else MOE.apply_moe

    def f(x, p):
        out, aux = apply(p, x, cfg)
        return jnp.sum(out * cell["cotangent"]) + aux["moe_aux_loss"], \
            (out, aux)

    w = jax.tree_util.tree_map(jnp.asarray, cell["weights"])
    run = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    if ep:
        with mesh_context(_mesh(cell["shape"], cell["names"])):
            (_, (out, aux)), (gx, gp) = run(jnp.asarray(cell["x"]), w)
    else:
        (_, (out, aux)), (gx, gp) = run(jnp.asarray(cell["x"]), w)
    return {"out": np.asarray(out),
            "aux": {k: np.asarray(v) for k, v in aux.items()},
            "grad_x": np.asarray(gx),
            "grads": jax.tree_util.tree_map(np.asarray, gp)}


def main(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        cells = pickle.load(f)
    out = [{"train": train, "moe_ep": moe, "moe_global": moe}[c["kind"]](c)
           for c in cells]
    with open(dst + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(dst + ".tmp", dst)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
