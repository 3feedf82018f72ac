"""Generic state-space model layer on torch: the protocol and three
families — linear-Gaussian with its Kalman filter and RTS smoother
oracle, stochastic volatility and Lorenz-96."""
from repro_torch.models.ssm.base import (StateSpaceModel, domain_hooks,
                                         simulate)
from repro_torch.models.ssm.lgssm import (LinearGaussianSSM, kalman_filter,
                                          kalman_smoother, make_lgssm,
                                          oracle_configs)
from repro_torch.models.ssm.lorenz96 import Lorenz96SSM
from repro_torch.models.ssm.stochvol import StochasticVolatilitySSM

__all__ = [
    "StateSpaceModel", "domain_hooks", "simulate", "LinearGaussianSSM",
    "kalman_filter", "kalman_smoother", "make_lgssm", "oracle_configs",
    "StochasticVolatilitySSM", "Lorenz96SSM",
]
