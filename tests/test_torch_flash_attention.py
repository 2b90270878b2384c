"""Port flash attention forward against the JAX twin.

On the CPU the wrapper runs `_flash_fwd_plain`; the JAX side runs its
Pallas kernel in interpret mode. Tolerance 1e-4 at fp32: both compute the
same softmax, the JAX kernel blockwise (online rescaling, per-block sums)
and the port over the whole row, so only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu_torch.ops import flash_attention as tfa

CASES = [
    # id, (B, S, T, H, KH, D), mask kind, mask kwargs, segments
    ("causal_ragged", (2, 40, 40, 4, 2, 16), "causal", {}, False),
    ("full_s_ne_t", (1, 24, 56, 4, 2, 16), "full", {}, False),
    ("prefix_lm", (1, 40, 40, 4, 1, 16), "prefix_lm", {"prefix": 13}, False),
    ("sliding_window", (1, 40, 40, 4, 2, 16), "sliding_window",
     {"window": 9}, False),
    ("causal_segments", (2, 40, 40, 4, 2, 16), "causal", {}, True),
    ("sliding_segments", (1, 40, 40, 2, 2, 16), "sliding_window",
     {"window": 7}, True),
]


def _inputs(shape, segments, seed=0):
    b, s, t, h, kh, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    seg = (np.cumsum(rng.random((b, s)) < 0.15, axis=1).astype(np.int32)
           if segments else None)
    return q, k, v, seg


@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_flash_fwd_matches_jax(shape, kind, mkw, segments):
    q, k, v, seg = _inputs(shape, segments)
    # Blocks of 16 (S, T not multiples of 16 in the ragged cases) make the
    # JAX kernel pad and skip blocks the way it does at serving sizes.
    out, (_, lse3) = jfa._attn_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 16, 16, None,
        None if seg is None else jnp.asarray(seg), jfa.MaskSpec(kind, **mkw))
    want_lse = np.asarray(jfa._lse_bshl(lse3, q.shape))
    got, got_lse = tfa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        mask=tfa.MaskSpec(kind, **mkw))
    np.testing.assert_allclose(got.numpy(), np.asarray(out),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-4,
                               rtol=1e-4)
    if kind == "causal" and not segments:  # the public lse entry point
        jo, jl = jfa.flash_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), True, 16, 16)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
    want_out = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 16, 16,
        segment_ids=None if seg is None else jnp.asarray(seg),
        mask=jfa.MaskSpec(kind, **mkw))
    np.testing.assert_allclose(
        tfa.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            segment_ids=None if seg is None else torch.from_numpy(seg),
            mask=tfa.MaskSpec(kind, **mkw)).numpy(),
        np.asarray(want_out), atol=1e-4, rtol=1e-4)


def test_flash_refuses_prefix_lm_with_segments():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="prefix_lm"):
        tfa.flash_attention(x, x, x, mask=tfa.MaskSpec("prefix_lm", prefix=3),
                            segment_ids=torch.zeros(1, 8, dtype=torch.int32))


def test_flash_refuses_head_mismatch():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, kv, kv)


def test_flash_grad_flows_on_cpu():
    """Inputs that require grad go through the autograd Function (the plain
    backward on the CPU); under no_grad nothing is recorded."""
    q, k, v, _ = _inputs((1, 8, 2, 2, 1, 16), False)
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    out = tfa.flash_attention(tq, tk, torch.from_numpy(v))
    assert out.grad_fn is not None
    out.sum().backward()
    assert tq.grad.shape == tq.shape and tk.grad.shape == tk.shape
    assert bool(torch.isfinite(tq.grad).all()) and tq.grad.abs().sum() > 0
    with torch.no_grad():
        assert tfa.flash_attention(tq, tk, torch.from_numpy(v)).grad_fn is None


def test_flash_refuses_bad_segment_shape():
    x = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_attention(x, x, x, segment_ids=torch.zeros(1, 8))
