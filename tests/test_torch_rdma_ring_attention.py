"""Context-parallel ring attention: the port's `rdma_ring_attention` against
the JAX op, and the port's mesh.

Both sides get the same fp32 inputs, made with numpy from a seed. The JAX op
runs its Pallas kernels in interpret mode on n virtual CPU devices (as
tests/test_attention.py does); the port runs its plain per-rank ring walk
with all n ranks on the CPU. Tolerance 1e-4, absolute and relative: both
compute the same fp32 function and differ only in summation order (the JAX
kernel scales q before the product and updates the softmax once per shard;
the port scales the scores and updates once per visible shard too, but
einsum sums in another order).

Each JAX result is computed once per module and shared by the cases that
compare against it: an interpret-mode ring takes several seconds here.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kubeflow_tpu.ops.rdma_ring_attention import \
    rdma_ring_attention as jax_rdma_ring_attention
from kubeflow_tpu_torch.ops import rdma_ring_attention as trr
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.reference import naive_attention
from kubeflow_tpu_torch.parallel import Mesh, current_mesh

TOL = 1e-4
GRADS = ("dq", "dk", "dv")
# (b, s, h, kh, d, seed) of the JAX package's own RDMA tests.
FWD_CASE = (2, 128, 4, 2, 16, 21)
GRAD_CASE = (1, 64, 2, 2, 8, 23)
GQA_CASE = (2, 64, 4, 2, 8, 29)


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shp).astype(np.float32)
            for shp in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]


# Losses, (JAX, torch).
SQUARE = (lambda o: jnp.sum(o ** 2), lambda o: (o ** 2).sum())
COS = (lambda o: jnp.sum(o * jnp.cos(o)), lambda o: (o * torch.cos(o)).sum())


def _torch_grads(arrays, n, loss):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = trr.rdma_ring_attention(q, k, v, "seq", Mesh(["cpu"] * n, "seq"))
    loss[1](out).backward()
    return [x.grad.numpy() for x in (q, k, v)]


@pytest.fixture(scope="module")
def jax_ring(devices8):
    """jax_ring(kind, n): the JAX op's forward output ("fwd", FWD_CASE) or
    gradients ("grad": sum(out²) at GRAD_CASE; "gqa": sum(out·cos(out)) at
    GQA_CASE), each computed once."""
    cache = {}

    def run(kind, n):
        if (kind, n) in cache:
            return cache[kind, n]
        mesh = JaxMesh(np.array(devices8[:n]), ("seq",))
        case, loss = {"fwd": (FWD_CASE, None), "grad": (GRAD_CASE, SQUARE),
                      "gqa": (GQA_CASE, COS)}[kind]
        q, k, v = (jnp.asarray(a) for a in _inputs(*case))
        if loss is None:
            res = np.asarray(jax_rdma_ring_attention(q, k, v, "seq", mesh))
        else:
            res = [np.asarray(g) for g in jax.grad(
                lambda q, k, v: loss[0](jax_rdma_ring_attention(
                    q, k, v, "seq", mesh)), argnums=(0, 1, 2))(q, k, v)]
        cache[kind, n] = res
        return res

    return run


@pytest.mark.parametrize("n", [4, 8])
def test_forward_matches_jax(jax_ring, n):
    q, k, v = (torch.from_numpy(a) for a in _inputs(*FWD_CASE))
    out = trr.rdma_ring_attention(q, k, v, "seq", Mesh(["cpu"] * n, "seq"))
    np.testing.assert_allclose(out.numpy(), jax_ring("fwd", n), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("grad", range(3), ids=GRADS)
@pytest.mark.parametrize("n", [4, 8])
def test_gradients_match_jax(jax_ring, n, grad):
    """dq, dk, dv of sum(out²) through the two-pass backward."""
    got = _torch_grads(_inputs(*GRAD_CASE), n, SQUARE)
    np.testing.assert_allclose(got[grad], jax_ring("grad", n)[grad],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("grad", range(3), ids=GRADS)
def test_gqa_batched_gradients_match_jax(jax_ring, grad):
    """GQA (group 2) and batch 2: dk/dv sum over each kv head's group."""
    got = _torch_grads(_inputs(*GQA_CASE), 4, COS)
    np.testing.assert_allclose(got[grad], jax_ring("gqa", 4)[grad],
                               rtol=TOL, atol=TOL)


def test_single_rank_ring_is_flash_attention():
    """n == 1 takes the port's flash_attention, forward and backward, as
    the JAX op does."""
    arrays = _inputs(2, 48, 4, 2, 8, 3)
    got = _torch_grads(arrays, 1, SQUARE)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    SQUARE[1](flash_attention(q, k, v, True)).backward()
    for g, x in zip(got, (q, k, v)):
        np.testing.assert_array_equal(g, x.grad.numpy())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_ring_matches_naive_attention(n):
    """The per-rank walk (shards of 12 rows, so tiles and shards do not
    line up) equals causal attention on the global sequence: out, lse and
    the gradients of a random cotangent."""
    b, s, h, kh, d = 2, 96, 4, 2, 8
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(b, s, h, kh, d, 7 + n))
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (b, s, h, d)).astype(np.float32))
    mesh = Mesh(["cpu"] * n, ("seq",))
    out = trr.rdma_ring_attention(q, k, v, "seq", mesh)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = naive_attention(q, k, v, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=TOL, atol=TOL)
    _, lse = trr._rdma_fwd_plain(q.detach(), k.detach(), v.detach(), n)
    scores = torch.einsum("bshd,bthd->bhst", q.detach(),
                          k.detach().repeat_interleave(h // kh, 2))
    scores = scores / d ** 0.5 + torch.triu(
        torch.full((s, s), -torch.inf), diagonal=1)
    torch.testing.assert_close(lse, scores.logsumexp(-1).transpose(1, 2),
                               rtol=1e-5, atol=1e-5)


def test_plain_ring_gradcheck_float64():
    """The plain forward and backward are exact derivatives of each other
    (float64 finite differences)."""
    q, k, v = (torch.from_numpy(a.astype(np.float64)).requires_grad_()
               for a in _inputs(1, 16, 2, 1, 4, 5))
    mesh = Mesh(["cpu"] * 4, ("seq",))
    assert torch.autograd.gradcheck(
        lambda q, k, v: trr.rdma_ring_attention(q, k, v, "seq", mesh),
        (q, k, v))


def test_ring_orders_follow_the_tpu_kernel():
    """Forward and dq read src = me, me-1, ..., 0; dk/dv read src = me, then
    n-1, ..., me+1: the TPU ring order without the shards masked in full."""
    assert trr._kv_order(2, 4) == [2, 1, 0]
    assert trr._q_order(2, 4) == [2, 3]
    assert trr._q_order(1, 8) == [1, 7, 6, 5, 4, 3, 2]
    for n in (2, 4, 8):
        for me in range(n):
            assert sorted(trr._kv_order(me, n) + trr._q_order(me, n)) == (
                sorted([*range(n), me]))


@pytest.mark.parametrize("case", ["no_mesh", "multi_axis", "mixed_devices",
                                  "ragged_split", "wrong_device"])
def test_refusals(case):
    q = torch.zeros(1, 64, 2, 8)
    mesh, exc, match = {
        "no_mesh": (None, ValueError, "needs a mesh"),
        "multi_axis": (Mesh([["cpu"] * 2] * 2, ("data", "seq")),
                       NotImplementedError, "A5"),
        "mixed_devices": (Mesh(["cpu", "cuda:0"], ("seq",)),
                          NotImplementedError, "B5–B7 across four cards"),
        "ragged_split": (Mesh(["cpu"] * 3, ("seq",)), ValueError,
                         "equal shards"),
        "wrong_device": (Mesh(["meta"] * 2, ("seq",)), ValueError,
                         "mesh on meta"),
    }[case]
    with pytest.raises(exc, match=match):
        trr.rdma_ring_attention(q, q, q, "seq", mesh)


def test_mesh_context_and_shape():
    outer = Mesh(["cpu"] * 4, ("seq",))
    inner = Mesh([["cpu", "cpu"]] * 3, ("data", "seq"))
    assert (outer.shape, inner.shape) == ({"seq": 4}, {"data": 3, "seq": 2})
    assert inner.devices == (torch.device("cpu"),) * 6
    assert current_mesh() is None
    seen = []
    with outer:
        with inner:
            assert current_mesh() is inner
            worker = threading.Thread(target=lambda: seen.append(
                current_mesh()))
            worker.start()
            worker.join()
        assert current_mesh() is outer
        q = torch.from_numpy(_inputs(1, 32, 2, 2, 8, 9)[0])
        out = trr.rdma_ring_attention(q, q, q)
    assert current_mesh() is None and seen == [None]
    torch.testing.assert_close(out, naive_attention(q, q, q), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="regular grid"):
        Mesh([["cpu"], ["cpu", "cpu"]], ("data", "seq"))
