"""Generic state-space model layer on torch: the protocol and the
linear-Gaussian family with its Kalman oracle (the stochastic-volatility
and Lorenz-96 families wait for ROADMAP A10)."""
from repro_torch.models.ssm.base import (StateSpaceModel, domain_hooks,
                                         simulate)
from repro_torch.models.ssm.lgssm import (LinearGaussianSSM, kalman_filter,
                                          make_lgssm, oracle_configs)

__all__ = [
    "StateSpaceModel", "domain_hooks", "simulate", "LinearGaussianSSM",
    "kalman_filter", "make_lgssm", "oracle_configs",
]
