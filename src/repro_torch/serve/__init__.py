"""Serving on torch: batched generation (``generate``), SMC particle
decoding (``smc_decode``) on the shared filter substrate, the resident
filter sessions (``repro_torch.serve.sessions``), the asyncio request
plane (``repro_torch.serve.frontend``) and the multi-bank fleet
(``repro_torch.serve.fleet``)."""
from repro_torch.serve.engine import generate
from repro_torch.serve.fleet import (BankFailure, FleetConfig, FleetController,
                                     FleetStream)
from repro_torch.serve.frontend import (FrameResult, FrontendConfig, Handoff,
                                        ParticleFrontend, StreamHandle)
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.sessions import (ParticleSessionServer, SessionHandle,
                                        SuspendedSession)
from repro_torch.serve.smc_decode import (LMDecodeSSM, SMCDecodeConfig,
                                          SMCDecodeResult, smc_decode,
                                          suspended_decode_session)

__all__ = ["generate", "smc_decode", "SMCDecodeConfig", "SMCDecodeResult",
           "LMDecodeSSM", "suspended_decode_session",
           "ParticleSessionServer", "SessionHandle", "SuspendedSession",
           "ParticleFrontend", "FrontendConfig", "FrameResult",
           "StreamHandle", "Handoff", "Metrics",
           "FleetController", "FleetConfig", "FleetStream", "BankFailure"]
