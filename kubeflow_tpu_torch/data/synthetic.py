"""Synthetic batches for tests and the chip smoke run.

The port's copy of `kubeflow_tpu/data/synthetic.py` (the two LM
generators and the MNIST-shaped classification stream): the same numpy
generator calls in the same order, so a seed gives batches byte-equal to
the JAX package's.
"""

from __future__ import annotations

import numpy as np


def token_batches(batch_size: int, seq_len: int, vocab_size: int,
                  seed: int = 0, sharded_by: int = 1):
    """Infinite causal-LM batches: inputs/targets shifted by one.
    `sharded_by` ensures the global batch divides the dp axis."""
    if batch_size % sharded_by:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"sharded_by {sharded_by}")
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab_size, (batch_size, seq_len + 1),
                            dtype=np.int32)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def learnable_token_batches(batch_size: int, seq_len: int, vocab_size: int,
                            seed: int = 0):
    """A *learnable* sequence task (next token = (token + 1) mod V with a
    fixed random permutation) so convergence tests can assert loss ↓."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab_size).astype(np.int32)
    while True:
        start = rng.integers(0, vocab_size, (batch_size, 1), dtype=np.int32)
        seq = [start]
        for _ in range(seq_len):
            seq.append(perm[seq[-1]])
        toks = np.concatenate(seq, axis=1)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def mnist_like(batch_size: int, seed: int = 0, num_classes: int = 10):
    """MNIST-shaped separable classification data: class = argmax of a fixed
    linear projection of the image; an MLP must drive loss near zero."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(784, num_classes)).astype(np.float32)
    while True:
        x = rng.normal(size=(batch_size, 784)).astype(np.float32)
        y = np.argmax(x @ w, axis=-1).astype(np.int32)
        yield {"inputs": x, "targets": y}
