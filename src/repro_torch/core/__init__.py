"""PPF core on torch: particle ensembles, local resampling, the SIR step,
the distributed resampling algorithms and the domain decomposition on an
emulated mesh or one process a shard (one filter or a bank of them), and
the entry points.
ASIR (``repro_torch.core.asir``) and the genealogy smoothers
(``repro_torch.core.genealogy``) are imported from their modules, as in
the reference."""
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.domain import DomainSpec
from repro_torch.core.draws import (BankDraws, ReplayDraws, TorchDraws,
                                    as_draws)
from repro_torch.core.filters import (FilterBank, FilterResult,
                                      ParallelParticleFilter, make_bank_step,
                                      make_sharded_bank_step, member_carry)
from repro_torch.core.particles import (ParticleEnsemble, advance,
                                        effective_sample_size,
                                        init_ensemble, log_sum_weights,
                                        logical_size, materialize,
                                        normalized_weights, permute,
                                        resample_compressed, reweight,
                                        weighted_mean)
from repro_torch.core.runtime import (EmulatedGrid, EmulatedMesh, ProcessGrid,
                                     ProcessMesh, make_mesh)
from repro_torch.core.smc import (SIRCarry, SIRConfig, StateSpaceModel,
                                  ess_resample, make_sir_step, run_sir)

__all__ = [
    "DRAConfig", "DomainSpec", "EmulatedGrid", "EmulatedMesh", "ProcessGrid",
    "ProcessMesh", "make_mesh",
    "BankDraws", "ReplayDraws", "TorchDraws", "as_draws",
    "FilterBank", "FilterResult", "ParallelParticleFilter",
    "make_bank_step", "make_sharded_bank_step", "member_carry",
    "ParticleEnsemble", "advance", "effective_sample_size", "init_ensemble",
    "log_sum_weights", "logical_size", "materialize", "normalized_weights",
    "permute", "resample_compressed", "reweight", "weighted_mean",
    "SIRCarry", "SIRConfig", "StateSpaceModel", "ess_resample",
    "make_sir_step", "run_sir",
]
