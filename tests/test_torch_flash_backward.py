"""Port flash attention backward against the JAX twin (fp32, CPU).

On the CPU the port's autograd Function runs `_flash_bwd_plain`; the JAX
side differentiates its custom_vjp, whose backward runs the Pallas dq and
dk/dv kernels in interpret mode. Tolerance 1e-4: both compute the same
gradients, the JAX kernels blockwise and the port over whole rows, so only
summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_attention import CASES, _inputs

TOL = dict(atol=1e-4, rtol=1e-4)
# JAX blocks of 32: S, T of 24..56 still leave ragged, padded and skipped
# blocks, at fewer interpret-mode grid steps than the forward tests' 16.
BLOCK = 32


def _cotangent(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_vjp(f, primals, cotangent):
    """Gradients of `f` at `primals` for `cotangent`, as numpy (one jitted
    program: cheaper than eager dispatch of the interpret-mode kernels)."""
    grads = jax.jit(lambda p, c: jax.vjp(f, *p)[1](c))(
        tuple(jnp.asarray(x) for x in primals),
        jax.tree.map(jnp.asarray, cotangent))
    return [np.asarray(g) for g in grads]


def _torch_leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_flash_bwd_matches_jax(shape, kind, mkw, segments):
    q, k, v, seg = _inputs(shape, segments)
    do = _cotangent(q.shape)
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, True, BLOCK, BLOCK,
                                   segment_ids=jseg,
                                   mask=jfa.MaskSpec(kind, **mkw))

    want = _jax_vjp(f, (q, k, v), do)
    tq, tk, tv = _torch_leaves(q, k, v)
    out = tfa.flash_attention(
        tq, tk, tv, segment_ids=None if seg is None else torch.from_numpy(seg),
        mask=tfa.MaskSpec(kind, **mkw))
    out.backward(torch.from_numpy(do))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_lse_cotangent_matches_jax(causal):
    """Both outputs of flash_attention_lse carry a cotangent; g_lse folds
    into delta on both sides."""
    q, k, v, _ = _inputs((2, 40, 40, 4, 2, 16), False)
    do, g_lse = _cotangent(q.shape), _cotangent(q.shape[:3] + (1,), seed=8)
    want = _jax_vjp(
        lambda q, k, v: jfa.flash_attention_lse(q, k, v, causal, BLOCK,
                                                BLOCK),
        (q, k, v), (do, g_lse))
    tq, tk, tv = _torch_leaves(q, k, v)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, causal=causal)
    torch.autograd.backward((out, lse), (torch.from_numpy(do),
                                         torch.from_numpy(g_lse)))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_flash_lse_alone_matches_jax():
    """Only lse is used: the output's cotangent is zero on both sides."""
    q, k, v, _ = _inputs((1, 24, 24, 2, 1, 16), False)
    g_lse = _cotangent(q.shape[:3] + (1,))
    want = _jax_vjp(
        lambda q, k, v: jfa.flash_attention_lse(q, k, v, True, BLOCK, BLOCK),
        (q, k, v), (np.zeros(q.shape, np.float32), g_lse))
    tq, tk, tv = _torch_leaves(q, k, v)
    _, lse = tfa.flash_attention_lse(tq, tk, tv)
    lse.backward(torch.from_numpy(g_lse))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("kind,mkw,segments", [
    ("causal", {}, False), ("full", {}, False),
    ("prefix_lm", {"prefix": 3}, False),
    ("sliding_window", {"window": 3}, True),
], ids=["causal", "full", "prefix_lm", "sliding_segments"])
def test_flash_autograd_gradcheck_float64(kind, mkw, segments):
    """Finite differences in float64 against the plain backward, through
    both outputs (out and lse)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shp)).requires_grad_()
               for shp in ((1, 7, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8)))
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 1]]) if segments else None
    mask = tfa.MaskSpec(kind, **mkw)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention_lse(q, k, v, segment_ids=seg,
                                                mask=mask),
        (q, k, v), eps=1e-6, atol=1e-5)


def test_plain_backward_is_the_autograd_backward():
    """The CPU autograd path and a direct `_flash_bwd_plain` call on the
    saved residuals give the same gradients bit for bit."""
    q, k, v, seg = _inputs((2, 40, 40, 4, 2, 16), True)
    do = torch.from_numpy(_cotangent(q.shape))
    tseg = torch.from_numpy(seg)
    tq, tk, tv = _torch_leaves(q, k, v)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, segment_ids=tseg)
    out.backward(do)
    want = tfa._flash_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                out.detach(), lse.detach(), do, None,
                                tfa.MaskSpec("causal"), tseg)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
