"""Carry state, configs and weights across from the reference, as plain
data.

What crosses between the packages is the particle state, the configs
and, for the language models, the weights of the reference's
``init_params``.  Every function takes numpy arrays and plain field
dicts (``dataclasses.asdict`` of the reference's configs), never JAX
objects, so this module needs neither package's runtime.

A distributed ensemble is laid out differently on the two sides: the
reference's sharded leaves are ``(P·C, ...)``, shard-major (what its
``shard_map`` returns), the port's ``(P, C, ...)``; a bank over a mesh
has ``(B, P·C, ...)`` there and ``(B, P, C, ...)`` here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import base as configs
from repro_torch.core.asir import ASIRConfig
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.domain import DomainSpec
from repro_torch.core.particles import ParticleEnsemble
from repro_torch.core.smc import SIRConfig
from repro_torch.models.lm import model as lm
from repro_torch.models.ssm.lgssm import LinearGaussianSSM
from repro_torch.models.ssm.lorenz96 import Lorenz96SSM
from repro_torch.models.ssm.stochvol import StochasticVolatilitySSM
from repro_torch.models.tracking import TrackingConfig


def ensemble_from_numpy(state, log_weights, counts,
                        device="cpu") -> ParticleEnsemble:
    """The reference ensemble's leaves (``state``, ``log_weights``,
    ``counts`` as numpy arrays) as the port's ensemble on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return ParticleEnsemble(state=t(state, torch.float32),
                            log_weights=t(log_weights, torch.float32),
                            counts=t(counts, torch.int32))


def shard_ensemble_from_numpy(state, log_weights, counts, shards: int,
                              device="cpu") -> ParticleEnsemble:
    """The reference's sharded ``(P·C, ...)`` leaves as the port's
    ``(P, C, ...)`` distributed ensemble."""
    n = np.shape(log_weights)[0]
    if n % shards:
        raise ValueError(f"{n} slots do not split over {shards} shards")
    ens = ensemble_from_numpy(state, log_weights, counts, device)
    return ParticleEnsemble(*(
        x.reshape((shards, n // shards) + x.shape[1:])
        for x in (ens.state, ens.log_weights, ens.counts)))


def bank_shard_ensemble_from_numpy(state, log_weights, counts, shards: int,
                                   device="cpu") -> ParticleEnsemble:
    """The reference bank's sharded ``(B, P·C, ...)`` leaves as the port's
    ``(B, P, C, ...)`` ensemble of a bank over a mesh."""
    b, n = np.shape(log_weights)[:2]
    if n % shards:
        raise ValueError(f"{n} slots do not split over {shards} shards")
    ens = ensemble_from_numpy(state, log_weights, counts, device)
    return ParticleEnsemble(*(
        x.reshape((b, shards, n // shards) + x.shape[2:])
        for x in (ens.state, ens.log_weights, ens.counts)))


def bank_ensemble_to_numpy(ensemble: ParticleEnsemble) -> tuple:
    """``(state, log_weights, counts)`` numpy arrays of a bank in the
    reference's layout: ``(B, P, C, ...)`` flattens to ``(B, P·C, ...)``
    (a single-device bank's ``(B, N, ...)`` stays as it is)."""
    lead = ensemble.log_weights.dim() - 1
    return tuple(x.detach().cpu().reshape(
        (x.shape[0], -1) + x.shape[lead + 1:]).numpy()
        for x in (ensemble.state, ensemble.log_weights, ensemble.counts))


def ensemble_to_numpy(ensemble: ParticleEnsemble) -> tuple:
    """``(state, log_weights, counts)`` numpy arrays in the reference's
    layout: a ``(P, C, ...)`` distributed ensemble flattens to
    ``(P·C, ...)``."""
    lead = ensemble.log_weights.dim() - 1
    return tuple(x.detach().cpu().reshape((-1,) + x.shape[lead + 1:]).numpy()
                 for x in (ensemble.state, ensemble.log_weights,
                           ensemble.counts))


def tracking_config(fields: dict) -> TrackingConfig:
    """``TrackingConfig`` from the reference config's fields."""
    fields = dict(fields)
    fields["img_size"] = tuple(int(v) for v in fields["img_size"])
    return TrackingConfig(**fields)


def sir_config(fields: dict) -> SIRConfig:
    """``SIRConfig`` from the reference config's fields.  The reference's
    ``fused_backend`` must be unset (``None``): the port picks the kernel
    or its plain version by device, so it cannot honor a forced backend."""
    fields = dict(fields)
    backend = fields.pop("fused_backend", None)
    if backend is not None:
        raise ValueError(f"fused_backend={backend!r}: the port chooses the "
                         f"fused backend by the tensors' device")
    return SIRConfig(**fields)


def lgssm(fields: dict) -> LinearGaussianSSM:
    """``LinearGaussianSSM`` from the reference model's matrices (numpy
    arrays), stored as float32 tensors."""
    return LinearGaussianSSM(**{
        k: torch.as_tensor(np.array(v, np.float32)) for k, v in
        fields.items()})


def stochvol(fields: dict) -> StochasticVolatilitySSM:
    """``StochasticVolatilitySSM`` from the reference model's fields."""
    return StochasticVolatilitySSM(**{k: float(v) for k, v in
                                      fields.items()})


def lorenz96(fields: dict) -> Lorenz96SSM:
    """``Lorenz96SSM`` from the reference model's fields."""
    ints = ("dim", "obs_stride")
    return Lorenz96SSM(**{k: int(v) if k in ints else float(v)
                          for k, v in fields.items()})


def asir_config(fields: dict) -> ASIRConfig:
    """``ASIRConfig`` from the reference config's fields."""
    fields = dict(fields)
    return ASIRConfig(grid=int(fields.pop("grid")),
                      intensity_bins=int(fields.pop("intensity_bins")),
                      **fields)


def dra_config(fields: dict) -> DRAConfig:
    """``DRAConfig`` from the reference config's fields.  Its
    ``resample_backend`` must be the default ``"auto"``: the port takes
    the B1 kernel or its plain version by device."""
    fields = dict(fields)
    backend = fields.pop("resample_backend", "auto")
    if backend != "auto":
        raise ValueError(f"resample_backend={backend!r}: the port chooses "
                         f"the local-resample kernel by the tensors' device")
    return DRAConfig(**fields)


def domain_spec(fields: dict) -> DomainSpec:
    """The port's ``DomainSpec`` from the reference spec's fields
    (``dataclasses.asdict`` of ``repro.core.domain.DomainSpec``)."""
    fields = dict(fields)
    return DomainSpec(frame_shape=tuple(int(v) for v in
                                        fields.pop("frame_shape")),
                      grid=tuple(int(v) for v in fields.pop("grid")),
                      **fields)


_SUB_CONFIGS = {"moe": configs.MoEConfig, "mla": configs.MLAConfig,
                "ssm": configs.SSMConfig, "rglru": configs.RGLRUConfig}


def arch_config(fields: dict) -> configs.ArchConfig:
    """``ArchConfig`` from the reference config's fields (nested dicts for
    the MoE/MLA/SSM/RG-LRU sub-configs, as ``dataclasses.asdict`` gives
    them)."""
    fields = dict(fields)
    for name, cls in _SUB_CONFIGS.items():
        if fields.get(name) is not None:
            sub = dict(fields[name])
            if "block_pattern" in sub:
                sub["block_pattern"] = tuple(sub["block_pattern"])
            fields[name] = cls(**sub)
    fields["layer_pattern"] = tuple(fields.get("layer_pattern", ()))
    return configs.ArchConfig(**fields)


def _layer_leaves(params: dict):
    """The reference's per-layer parameter dicts in depth order: the
    unrolled head, then each scanned group's unit layers (the stacked
    ``blocks`` leaves, indexed on their leading group axis), then the
    tail."""
    yield from params.get("head_blocks", [])
    blocks = params.get("blocks", {})
    names = sorted(blocks, key=lambda k: int(k[1:k.index("_")]))
    n_groups = (np.shape(blocks[names[0]]["pre_norm"])[0] if names else 0)
    for g in range(n_groups):
        for name in names:
            yield _index(blocks[name], g)
    yield from params.get("tail_blocks", [])


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def lm_params(params_np: dict, cfg: configs.ArchConfig, device="cpu",
              dtype: torch.dtype | None = None, grid=None,
              coords=None) -> lm.Decoder:
    """The port's ``Decoder`` holding the reference's ``init_params``
    weights (a pytree of numpy arrays), cast once to ``dtype`` (default
    ``cfg.compute_dtype``) — what the reference's ``cast_params`` does on
    every call.  Every layer kind and FFN crosses, with its leaves as
    the reference names them (head, scanned groups, tail, in depth
    order; an M layer's ``mla``, a MoE layer's ``moe`` with its router,
    ``we_gate``/``we_up``/``we_down`` and nested ``shared`` MLP).  With
    ``grid``, the decoder holds the blocks of the rank at ``coords``
    (default this rank's) of those weights
    (``launch.sharding.RankBlocks``): each is cut from the numpy array
    before it crosses, so the whole model is never on the device."""
    lm.check_supported(cfg)
    dtype = dtype or lm.L.dtype_of(cfg.compute_dtype)
    keep = None
    if grid is not None:
        from repro_torch.launch import sharding
        sharding.check_supported(cfg, grid)
        keep = sharding.RankBlocks(grid, coords)

    def t(x, name):
        if isinstance(x, dict):
            return {k: t(v, f"{name}.{k}") for k, v in x.items()}
        x = np.asarray(x)
        if keep is not None:
            x = keep(name, x)
        return torch.from_numpy(np.array(x, np.float32)).to(device=device,
                                                             dtype=dtype)

    plan = lm.make_plan(cfg).layers()
    leaves = list(_layer_leaves(params_np))
    if len(leaves) != len(plan):
        raise ValueError(f"{len(leaves)} layers of weights for the "
                         f"{len(plan)} layers of {cfg.name}")
    blocks = [lm.Block(kind, ffn, t(layer, f"blocks.{i}"))
              for i, ((kind, ffn), layer) in enumerate(zip(plan, leaves))]
    head = params_np.get("lm_head")
    img = params_np.get("img_proj")
    model = lm.Decoder(cfg, t(params_np["embed"], "embed"), blocks,
                       t(params_np["final_norm"], "final_norm"),
                       None if head is None else t(head, "lm_head"),
                       None if img is None else t(img, "img_proj"))
    return model if keep is None else keep.attach(model)


# ---------------------------------------------------------------------------
# Training: trainable weights and optimizer state, both ways
# ---------------------------------------------------------------------------

def _named_leaves(tree: dict, prefix: str):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_named(params_np: dict) -> dict:
    """The reference's params pytree (numpy, stacked groups) as numpy
    arrays by the port's weight names (``Decoder.named_parameters``:
    ``embed``, ``blocks.<layer>.<leaf path>``, ``final_norm``,
    ``lm_head``, ``img_proj``)."""
    out = {}
    for i, layer in enumerate(_layer_leaves(params_np)):
        out.update(_named_leaves(layer, f"blocks.{i}."))
    for name in ("embed", "final_norm", "lm_head", "img_proj"):
        if name in params_np:
            out[name] = np.asarray(params_np[name])
    return out


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def lm_tree(cfg: configs.ArchConfig, named: dict) -> dict:
    """Tensors (or arrays) by the port's weight names as the reference's
    params pytree of numpy arrays: the unrolled ``head_blocks`` and
    ``tail_blocks`` lists, each scanned group's layers stacked on a
    leading group axis under ``blocks["l<i>_<kind>_<ffn>"]``."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    layers: dict[int, dict] = {}
    out = {}
    for name, x in named.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = host(x)
            continue
        leaf = layers.setdefault(int(parts[1]), {})
        for k in parts[2:-1]:
            leaf = leaf.setdefault(k, {})
        leaf[parts[-1]] = host(x)
    plan = lm.make_plan(cfg)
    if sorted(layers) != list(range(len(plan.layers()))):
        raise ValueError(f"{len(layers)} layers of weights for the "
                         f"{len(plan.layers())} layers of {cfg.name}")
    lo, unit, hi = len(plan.head), len(plan.unit), plan.scanned().stop
    if plan.head:
        out["head_blocks"] = [layers[i] for i in range(lo)]
    if plan.n_groups:
        out["blocks"] = {
            f"l{j}_{kind}_{ffn}": _stack([layers[lo + g * unit + j]
                                          for g in range(plan.n_groups)])
            for j, (kind, ffn) in enumerate(plan.unit)}
    if plan.tail:
        out["tail_blocks"] = [layers[i] for i in range(hi, len(layers))]
    return out


def train_params(params_np: dict, cfg: configs.ArchConfig,
                 device="cpu", grid=None, coords=None) -> lm.Decoder:
    """A trainable decoder (float32 master weights with ``requires_grad``)
    holding the reference's ``init_params`` weights (numpy pytree), or
    with ``grid`` a rank's blocks of them (``lm_params``)."""
    return lm.trainable(lm_params(params_np, cfg, device, torch.float32,
                                  grid, coords))


def opt_state(state_np: dict, cfg: configs.ArchConfig,
              device="cpu") -> dict:
    """The reference's ``init_opt_state``/``adamw_update`` state (numpy
    pytrees ``m``, ``v`` and the int32 ``step``) as the port's: moments by
    weight name in their dtype (float32 or bfloat16, which crosses as
    float32 numpy and is cast back by ``moment_dtype``)."""
    def t(x):
        arr = np.asarray(x)
        dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" \
            else torch.float32
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=dtype)

    return {k: {n: t(x) for n, x in lm_named(state_np[k]).items()}
            for k in ("m", "v")} | {
        "step": torch.tensor(int(np.asarray(state_np["step"])),
                             dtype=torch.int32, device=device)}


def opt_state_to_numpy(state: dict, cfg: configs.ArchConfig) -> dict:
    """The port's optimizer state as the reference's: ``m`` and ``v`` as
    params pytrees (float32 numpy; bfloat16 moments upcast exactly) and
    ``step``."""
    return {k: lm_tree(cfg, {n: x.float() for n, x in state[k].items()})
            for k in ("m", "v")} | {
        "step": np.asarray(int(state["step"]), np.int32)}
