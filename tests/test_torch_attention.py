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


# -- the kernel plan (which of B6's kernels a call takes) -----------------

from repro_torch.kernels import flash_attention as tflash  # noqa: E402

BF16 = torch.bfloat16
# q shape, k shape, the variant: the LM path's four shapes (qwen3-32b,
# 64/8 heads of 128, a 1024-token prompt, a 1040-slot cache view) and the
# edge cases chip_smoke.py holds on the card
PLAN_CASES = {
    "smc-prefill": ((32, 64, 1024, 128), (32, 8, 1024, 128), "wgmma"),
    "generate-prefill": ((4, 64, 1024, 128), (4, 8, 1024, 128), "wgmma"),
    "smc-decode": ((32, 64, 1, 128), (32, 8, 1040, 128), "split"),
    "generate-decode": ((4, 64, 1, 128), (4, 8, 1040, 128), "split"),
    "decode-one-split": ((4, 64, 1, 128), (4, 8, 100, 128), "split"),
    "decode-16k": ((1, 64, 1, 128), (1, 8, 16384, 128), "split"),
    "decode-lq2": ((2, 64, 2, 128), (2, 8, 1153, 128), "split"),
    "decode-lq8": ((2, 64, 8, 128), (2, 8, 1040, 128), "split"),
    "granite-decode": ((4, 48, 1, 128), (4, 1, 1040, 128), "split"),
    "prefill-1000": ((2, 64, 1000, 128), (2, 8, 1000, 128), "wgmma"),
    "prefill-chunk": ((2, 64, 256, 128), (2, 8, 1024, 128), "wgmma"),
    "prefill-d64": ((2, 32, 512, 64), (2, 8, 512, 64), "wgmma"),
    "mha-d80": ((2, 32, 512, 80), (2, 32, 512, 80), "mma"),
    "gqa-d16": ((2, 8, 37, 16), (2, 2, 100, 16), "mma"),
    "rows-64": ((2, 64, 8, 128), (2, 8, 100, 128), "split"),
    "rows-72": ((2, 64, 9, 128), (2, 8, 100, 128), "wgmma"),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_sends_each_shape_to_its_variant(case):
    qs, ks, want = PLAN_CASES[case]
    got = tflash.plan(torch.Size(qs), torch.Size(ks), BF16)
    assert got.variant == want
    assert tflash.plan(torch.Size(qs), torch.Size(ks), torch.float32) \
        == tflash.Plan("f32")
    if want == "wgmma":        # a broadcast (stride-0) K/V view: no TMA
        assert tflash.plan(torch.Size(qs), torch.Size(ks), BF16,
                           False).variant == "mma"


def test_plan_split_counts_at_the_lm_shapes():
    """smc decode fills the card with one split per (row, KV head) pair;
    generate decode cuts its 32 pairs 8 ways; a 100-key view is one
    split; a 16k cache 32 splits of 512 keys."""
    def cut(case):
        qs, ks, _ = PLAN_CASES[case]
        p = tflash.plan(torch.Size(qs), torch.Size(ks), BF16)
        return p.splits, p.split_keys
    assert cut("smc-decode") == (1, 1040)
    assert cut("generate-decode") == (8, 144)
    assert cut("decode-one-split") == (1, 112)
    assert cut("decode-16k") == (32, 512)
    # the last of 9 splits holds key 1152 alone
    assert cut("decode-lq2") == (9, 144)


@pytest.mark.parametrize("b,hkv", [(1, 1), (1, 8), (4, 8), (32, 8), (4, 1),
                                   (64, 8), (300, 1)])
@pytest.mark.parametrize("lk", [1, 15, 16, 17, 100, 128, 129, 897, 1040,
                                4097, 16384])
def test_split_count_is_a_pure_function_of_the_shape(b, hkv, lk):
    """The split plan depends on (B, Hkv, Lk) alone, so a second call
    repeats bit for bit; every split holds at least one key, their lengths
    are whole warp tiles, and no split but a lone one is under
    MIN_SPLIT_KEYS keys."""
    p = tflash._split(b, hkv, lk)
    assert p == tflash._split(b, hkv, lk)
    assert p == tflash.plan(torch.Size((b, hkv * 8, 1, 128)),
                            torch.Size((b, hkv, lk, 128)), BF16)
    assert p.split_keys % tflash.SPLIT_TILE == 0
    assert (p.splits - 1) * p.split_keys < lk <= p.splits * p.split_keys
    assert p.splits == 1 or p.split_keys >= tflash.MIN_SPLIT_KEYS
    assert p.splits == 1 or b * hkv * p.splits <= tflash.SPLIT_BLOCKS


def _split_attention(q, k, v, p, causal=True):
    """The split variant's arithmetic in torch: per split, base-2 logits,
    the split's own max, P rounded to bf16, (m, l, acc) in float32; then
    the combine in split order, where a split that saw no key of a row
    (m = -inf, l = 0) weighs 2^-inf = 0."""
    b, hq, lq, d = q.shape
    group, lk = hq // k.shape[1], k.shape[2]
    kk = k.repeat_interleave(group, 1).float()
    vv = v.repeat_interleave(group, 1).float()
    log2_scale = d ** -0.5 / np.log(2)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * log2_scale
    if causal:
        pos = torch.arange(lq)[:, None] + lk - lq
        s = s.masked_fill(torch.arange(lk)[None, :] > pos, -torch.inf)
    parts = []
    for j in range(p.splits):
        sj = s[..., j * p.split_keys:(j + 1) * p.split_keys]
        m = sj.amax(-1, keepdim=True)
        pj = torch.exp2(sj - torch.where(m == -torch.inf, 0.0, m))
        pj = pj.to(torch.bfloat16).float()
        acc = pj @ vv[:, :, j * p.split_keys:(j + 1) * p.split_keys]
        parts.append((m, pj.sum(-1, keepdim=True), acc))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    mu = torch.where(m == -torch.inf, 0.0, m)
    num = sum(torch.exp2(pm - mu) * pa for pm, _, pa in parts)
    den = sum(torch.exp2(pm - mu) * pl for pm, pl, _ in parts)
    return (num / den).to(q.dtype)


@pytest.mark.parametrize("shape", [
    ((2, 16, 2, 16), (2, 2, 97, 16)),      # Lq = 2: a 1-key last split
    ((1, 8, 1, 32), (1, 2, 300, 32)),
    ((3, 12, 1, 16), (3, 1, 41, 16)),      # MQA, G = 12
])
def test_split_combine_arithmetic_matches_the_reference(shape):
    """The split-then-combine order of operations, emulated in torch at
    a forced split of 16 keys, agrees with the reference attention within
    the bf16 tolerance, and a split no key of which a row sees adds 0."""
    (qs, ks) = shape
    (jq, jk, jv), (q, k, v) = _inputs(sum(qs), qs[0], qs[1], ks[1], qs[2],
                                      ks[2], qs[3], "bfloat16")
    lk = ks[2]
    p = tflash.Plan("split", -(-lk // 16), 16)
    got = _split_attention(q, k, v, p)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, jref.mha_ref(jq, jk, jv, causal=True), "bfloat16")
