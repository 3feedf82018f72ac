"""Carry state and configs across from the reference, as plain data.

The system has no weights; what crosses between the packages is the
particle state and the configs.  Every function takes numpy arrays and
plain field dicts (``dataclasses.asdict`` of the reference's configs),
never JAX objects, so this module needs neither package's runtime.

A distributed ensemble is laid out differently on the two sides: the
reference's sharded leaves are ``(P·C, ...)``, shard-major (what its
``shard_map`` returns), the port's ``(P, C, ...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import DRAConfig
from repro_torch.core.particles import ParticleEnsemble
from repro_torch.core.smc import SIRConfig
from repro_torch.models.ssm.lgssm import LinearGaussianSSM
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


def dra_config(fields: dict) -> DRAConfig:
    """``DRAConfig`` from the reference config's fields.  Its
    ``resample_backend`` must be the default ``"auto"``: the port takes
    the B1 kernel or its plain version by device.  ARNA and butterfly
    raise ``NotImplementedError`` until their slice."""
    fields = dict(fields)
    backend = fields.pop("resample_backend", "auto")
    if backend != "auto":
        raise ValueError(f"resample_backend={backend!r}: the port chooses "
                         f"the local-resample kernel by the tensors' device")
    return DRAConfig(**fields)
