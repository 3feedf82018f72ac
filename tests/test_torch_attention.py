"""The port's attention (B6's plain version and ``ops.attention``) against
the reference on the CPU.

* ``repro_torch.kernels.ref.mha_ref`` against ``repro.kernels.ref.mha_ref``
  on the same numpy inputs: GQA, MHA and MQA head groupings, the decode
  offset (``Lq < Lk``), the tanh soft-cap, ragged lengths, the default
  and an explicit scale, float32 and bfloat16.
* ``ops.attention`` on the CPU against the Pallas kernel run as the
  reference's own tests run it (``flash_attention(..., interpret=True)``),
  at lengths the Pallas kernel takes (a multiple of its block or under
  one block), and on a strided KV-cache view against the reference LM's
  full-cache ``decode_attention``.

Tolerances: float32 at rtol = atol = 2e-5 (the bound of
tests/test_kernels.py::test_flash_attention_matches_oracle); bfloat16 at
rtol = atol = 2e-2 (tests/test_kernels.py::test_flash_attention_dtypes:
the packages round the bf16 products and probabilities at different
places).  The CUDA kernel itself runs only on the card: chip_smoke.py
holds it against this plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models.lm import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hkv, lq, lk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# b, hq, hkv, lq, lk, d, causal, softcap
REF_CASES = {
    "gqa": (2, 8, 2, 24, 24, 16, True, 0.0),
    "mha": (1, 4, 4, 17, 17, 32, True, 0.0),
    "mqa": (2, 6, 1, 9, 9, 16, True, 0.0),
    "decode": (3, 8, 2, 1, 41, 16, True, 0.0),
    "chunk-offset": (1, 4, 2, 7, 30, 16, True, 0.0),
    "softcap": (2, 4, 2, 37, 100, 64, True, 50.0),
    "full": (1, 4, 2, 12, 20, 16, False, 0.0),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(REF_CASES))
def test_mha_ref_matches_reference(case, dtype):
    b, hq, hkv, lq, lk, d, causal, cap = REF_CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(len(case), b, hq, hkv, lq, lk, d,
                                      dtype)
    for scale in (None, 0.3):
        want = jref.mha_ref(jq, jk, jv, causal=causal, scale=scale,
                            logit_softcap=cap)
        got = tref.mha_ref(q, k, v, causal=causal, scale=scale,
                           logit_softcap=cap)
        assert got.dtype == q.dtype and got.shape == q.shape
        _close(got, want, dtype)


# b, hq, hkv, lq, lk, d, softcap: lengths the Pallas kernel tiles exactly
PALLAS_CASES = {
    "gqa-prefill": (2, 8, 2, 64, 64, 16, 0.0),
    "mha-prefill": (1, 4, 4, 128, 128, 32, 0.0),
    "mqa-prefill": (1, 6, 1, 40, 40, 16, 0.0),
    "decode": (2, 8, 2, 1, 77, 16, 0.0),
    "ragged-offset": (2, 4, 2, 37, 100, 64, 50.0),
    "two-blocks": (1, 4, 2, 256, 256, 16, 0.0),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_ops_attention_matches_pallas_interpret(case, dtype):
    b, hq, hkv, lq, lk, d, cap = PALLAS_CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(7 + len(case), b, hq, hkv, lq, lk, d,
                                      dtype)
    want = jflash(jq, jk, jv, causal=True, logit_softcap=cap,
                  interpret=True)
    got = ops.attention(q, k, v, causal=True, logit_softcap=cap)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (6, 1)])
def test_decode_on_a_strided_cache_view(hq, hkv, dtype):
    """One query against the first ``pos + 1`` slots of a longer cache,
    passed as a view (strides of the whole cache, no copy), equals the
    reference LM's masked attention over the whole cache."""
    b, max_len, d, pos = 2, 40, 16, 26
    (jq, jk, jv), (q, k, v) = _inputs(hq * 10 + hkv, b, hq, hkv, 1, max_len,
                                      d, dtype)
    view_k, view_v = k[:, :, :pos + 1], v[:, :, :pos + 1]
    assert not view_k.is_contiguous()
    assert view_k.data_ptr() == k.data_ptr()
    got = ops.attention(q, view_k, view_v, causal=True)
    want = jlayers.decode_attention(jq, jk, jv, pos)
    _close(got, want, dtype)


def test_default_scale_is_the_kernels():
    """``ops.attention`` resolves ``scale=None`` to the Python float
    ``1/sqrt(D)`` (the kernel's default) on the CPU too; the plain version
    called directly keeps the reference's dtype-rounded default."""
    _, (q, k, v) = _inputs(3, 1, 4, 2, 9, 9, 16, "bfloat16")
    assert torch.equal(ops.attention(q, k, v),
                       tref.mha_ref(q, k, v, scale=0.25))
    (jq, jk, jv), _ = _inputs(3, 1, 4, 2, 9, 9, 16, "bfloat16")
    _close(tref.mha_ref(q, k, v), jref.mha_ref(jq, jk, jv), "bfloat16")


def test_plain_version_counts_its_calls():
    _, (q, k, v) = _inputs(4, 1, 2, 1, 3, 5, 16, "float32")
    before = tref.mha_ref.calls
    ops.attention(q, k, v)
    tref.mha_ref(q, k, v)
    assert tref.mha_ref.calls == before + 2
