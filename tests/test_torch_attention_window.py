"""B6's sliding window and cross-attention shapes on the CPU: the plain
version and the port's attention layers against the reference, and the
wrapper's plan and checks at the new shapes.

* ``ref.mha_ref(window=...)`` and ``layers.causal_attention`` against the
  reference's ``chunked_causal_attention(window=...)`` (which slices its
  keys per query chunk), with windows shorter and longer than T, of one
  key, at several chunk sizes; with a decode offset (Lq < Lk) against the
  reference's ``decode_attention`` row by row.
* ``layers.decode_attention(window=...)`` on a strided cache view
  against the reference's full-cache ``decode_attention`` at positions
  inside and past the window.
* ``layers.cross_attention`` (an X layer's full attention over ragged
  image keys) against ``chunked_causal_attention(causal=False)``.
* The split variant's key range: ``plan`` starts the splits at the first
  key a query sees, and the split-then-combine arithmetic over that range
  (emulated in torch) agrees with the reference; ``plan`` and ``_check``
  take head dim 256, 1601 image keys and a window on CPU tensors (the
  device check comes last), and refuse a window on a non-causal call.

Tolerances are tests/test_torch_attention.py's: float32 at rtol = atol =
2e-5, bfloat16 at 2e-2.  The CUDA kernel runs only on the card:
chip_smoke.py holds each variant's window against this plain version.
"""
import numpy as np
import pytest
import torch
from test_torch_attention import DTYPES, _close, _inputs
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.models.lm import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.models.lm import layers as tlayers

BF16 = torch.bfloat16

# b, hq, hkv, t, d, window, chunk
WINDOW_CASES = {
    "short": (2, 8, 2, 24, 16, 5, 8),
    "smoke": (1, 4, 2, 40, 16, 16, 8),
    "longer-than-t": (2, 4, 2, 24, 16, 64, 8),
    "one-key": (1, 4, 4, 17, 32, 1, 17),
    "mqa": (2, 6, 1, 33, 16, 7, 11),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_prefill_matches_reference(case, dtype):
    b, hq, hkv, t, d, window, chunk = WINDOW_CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(t + window, b, hq, hkv, t, t, d, dtype)
    want = jlayers.chunked_causal_attention(jq, jk, jv, window=window,
                                            chunk=chunk)
    _close(tref.mha_ref(q, k, v, causal=True, scale=d ** -0.5,
                        window=window), want, dtype)
    _close(tlayers.causal_attention(q, k, v, window=window), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_with_a_decode_offset(dtype):
    """Lq = 5 rows at the end of 30 keys, window 6: row i sits at
    position 25 + i, as the reference's one-token decode there."""
    (jq, jk, jv), (q, k, v) = _inputs(7, 2, 8, 2, 5, 30, 16, dtype)
    got = tref.mha_ref(q, k, v, causal=True, scale=16 ** -0.5, window=6)
    for i in range(5):
        want = jlayers.decode_attention(jq[:, :, i:i + 1], jk, jv, 25 + i,
                                        window=6)
        _close(got[:, :, i:i + 1], want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos", [0, 3, 11, 12, 30])
def test_windowed_decode_on_a_strided_cache_view(pos, dtype):
    """One token at ``pos`` against a 40-slot cache, window 12 (inside,
    at and past the window's length)."""
    (jq, jk, jv), (q, k, v) = _inputs(pos, 3, 8, 2, 1, 40, 16, dtype)
    want = jlayers.decode_attention(jq, jk, jv, pos, window=12)
    _close(tlayers.decode_attention(q, k, v, pos, window=12), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lq", [1, 8])
def test_cross_attention_matches_reference(lq, dtype):
    """Full attention of ``lq`` queries over 19 image keys (ragged)."""
    (jq, jk, jv), (q, k, v) = _inputs(lq, 2, 4, 2, lq, 19, 16, dtype)
    want = jlayers.chunked_causal_attention(jq, jk, jv, chunk=lq,
                                            causal=False)
    _close(tlayers.cross_attention(q, k, v), want, dtype)


def _split_attention(q, k, v, p, window):
    """The split variant's order over its plan's keys ``key0 ..``: base-2
    logits masked by the window, each split's own max, P rounded to bf16,
    then the combine in split order."""
    b, hq, lq, d = q.shape
    group, lk = hq // k.shape[1], k.shape[2]
    keys = slice(p.key0, lk)
    kk = k[:, :, keys].repeat_interleave(group, 1).float()
    vv = v[:, :, keys].repeat_interleave(group, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
        d ** -0.5 / np.log(2))
    pos = torch.arange(lq)[:, None] + lk - lq
    key = torch.arange(p.key0, lk)[None, :]
    s = s.masked_fill((key > pos) | (pos - key >= window), -torch.inf)
    parts = []
    for j in range(p.splits):
        cut = slice(j * p.split_keys, (j + 1) * p.split_keys)
        sj = s[..., cut]
        m = sj.amax(-1, keepdim=True)
        pj = torch.exp2(sj - torch.where(m == -torch.inf, 0.0, m))
        pj = pj.to(BF16).float()
        parts.append((m, pj.sum(-1, keepdim=True), pj @ vv[:, :, cut]))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    mu = torch.where(m == -torch.inf, 0.0, m)
    num = sum(torch.exp2(pm - mu) * pa for pm, _, pa in parts)
    den = sum(torch.exp2(pm - mu) * pl for pm, pl, _ in parts)
    return (num / den).to(q.dtype)


@pytest.mark.parametrize("lq,lk,window", [(1, 300, 40), (4, 300, 100),
                                          (1, 30, 64), (2, 129, 16)])
def test_split_keys_start_at_the_window(lq, lk, window):
    """A windowed decode's splits cover the keys ``key0 .. Lk - 1``
    alone, ``key0`` the first key its first query sees, so the kernel
    reads O(window) keys of the view; over that range the split order
    agrees with the reference."""
    b, hq, hkv, d = 2, 16, 2, 16
    p = tflash.plan(torch.Size((b, hq, lq, d)), torch.Size((b, hkv, lk, d)),
                    BF16, window=window)
    assert p.variant == "split"
    assert p.key0 == max(0, lk - lq - window + 1)
    n = lk - p.key0
    assert (p.splits - 1) * p.split_keys < n <= p.splits * p.split_keys
    assert p == tflash._split(b, hkv, lk, p.key0)
    (jq, jk, jv), (q, k, v) = _inputs(lk, b, hq, hkv, lq, lk, d, "bfloat16")
    # force short splits, so that several cross the window's edge
    forced = tflash.Plan("split", -(-n // 16), 16, p.key0)
    got = _split_attention(q, k, v, forced, window)
    for i in range(lq):
        want = jlayers.decode_attention(jq[:, :, i:i + 1], jk, jv,
                                        lk - lq + i, window=window)
        _close(got[:, :, i:i + 1], want, "bfloat16")


# q shape, k shape, causal, window, variant
NEW_SHAPES = {
    "gemma3-local-prefill": ((4, 32, 2048, 128), (4, 16, 2048, 128), True,
                             1024, "wgmma"),
    "gemma3-local-decode": ((32, 32, 1, 128), (32, 16, 2081, 128), True,
                            1024, "split"),
    "recurrentgemma-prefill": ((4, 10, 2560, 256), (4, 1, 2560, 256), True,
                               2048, "mma"),
    "recurrentgemma-decode": ((32, 10, 1, 256), (32, 1, 2600, 256), True,
                              2048, "split"),
    "xattn-prefill": ((4, 32, 1024, 128), (4, 8, 1601, 128), False, 0,
                      "wgmma"),
    "xattn-decode": ((4, 32, 1, 128), (4, 8, 1601, 128), False, 0, "split"),
    "xattn-d256-rows-70": ((2, 10, 7, 256), (2, 1, 1601, 256), False, 0,
                           "mma"),
}


@pytest.mark.parametrize("case", list(NEW_SHAPES))
def test_plan_and_check_take_the_new_shapes(case):
    """Each new shape goes to its variant, and ``_check`` passes it on
    CPU tensors (broadcast views) up to the device rule, its last."""
    qs, ks, causal, window, variant = NEW_SHAPES[case]
    assert tflash.plan(torch.Size(qs), torch.Size(ks), BF16,
                       window=window).variant == variant
    q = torch.zeros((1, 1, 1, qs[3]), dtype=BF16).expand(qs)
    k = torch.zeros((1, 1, 1, ks[3]), dtype=BF16).expand(ks)
    with pytest.raises(ValueError, match="CUDA"):
        tflash._check(q, k, k, causal, window)


def test_a_window_needs_a_causal_call():
    q = torch.zeros((1, 2, 4, 16), dtype=BF16)
    for causal, window in ((False, 3), (True, -1)):
        with pytest.raises(ValueError, match="window"):
            tflash._check(q, q, q, causal, window)
        with pytest.raises(ValueError, match="window"):
            tref.mha_ref(q, q, q, causal=causal, window=window)
    # a window as long as the keys, or longer, changes nothing
    (_, _, _), (q, k, v) = _inputs(3, 1, 4, 2, 9, 9, 16, "float32")
    full = tref.mha_ref(q, k, v)
    assert torch.equal(tref.mha_ref(q, k, v, window=9), full)
    assert torch.equal(tref.mha_ref(q, k, v, window=100), full)
    assert not torch.equal(tref.mha_ref(q, k, v, window=8), full)
