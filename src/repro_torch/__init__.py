"""PPF on PyTorch and CUDA — the port of the JAX package ``repro``.

Module paths mirror the reference one for one (``repro.core.smc`` ↔
``repro_torch.core.smc``).  The JAX package stays the reference the port
is held against; this package imports ``torch``, numpy and the standard
library only, never ``jax`` and nothing of ``repro``.

Entry points (``ParallelParticleFilter``, ``FilterBank``, and the LM
serving calls ``repro_torch.serve.generate`` and ``smc_decode``) run on
the CUDA device unless the caller passes ``device="cpu"``.  On a CUDA tensor
every kernel op launches its hand-written Hopper kernel (built from
``csrc/`` at first use) or raises; the plain torch versions beside each
kernel run only for tensors that lie on the CPU.
"""
