"""Serving on torch: batched generation (``generate``) and SMC particle
decoding (``smc_decode``) on the shared filter substrate."""
from repro_torch.serve.engine import generate
from repro_torch.serve.smc_decode import (LMDecodeSSM, SMCDecodeConfig,
                                          SMCDecodeResult, smc_decode)

__all__ = ["generate", "LMDecodeSSM", "SMCDecodeConfig", "SMCDecodeResult",
           "smc_decode"]
