"""Block-paged KV memory management for the generation engine.

The port's own copy of `kubeflow_tpu/serve/paging.py` (jax-free there too;
the port imports nothing of the JAX package). The paged engine keeps its KV
cache as a pool of fixed-size blocks `[L, n_blocks + 1, block_size, KH, D]`;
each request owns a block table (a host-side list of block ids), and each
decode dispatch gathers the tables into a contiguous view and scatters it
back (serve/generation.py). Everything here is plain-Python bookkeeping
mutated only by the engine's worker thread, at admission and retirement,
off the decode critical path.

  * block id 0 is the reserved NULL block, the pad target for table
    entries past a request's allocation: it receives garbage from padded
    scatters and is never read as meaningful data (absolute-position
    masking hides every row past a request's write index);
  * a block referenced by more than one table is immutable in value: the
    prefix cache shares a stored prefix's full blocks by reference, and a
    hit forks a partially filled tail block before writing;
  * quantized pools (`kv_quant`) change nothing here: their scale planes
    are addressed by the same block ids.
"""

from __future__ import annotations


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold `tokens` cache rows (ceil division)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(block_size))


class BlockAllocator:
    """Fixed-pool block allocator with refcounted sharing.

    Ids are indices into the device pool's block axis; id 0 is reserved
    (NULL). `alloc` is all-or-nothing — a request either gets its whole
    allocation or nothing, so admission can never strand a half-admitted
    request holding blocks it cannot use. Free ids are handed out in
    LIFO order: recently freed blocks are re-written first, keeping the
    pool's cold tail untouched (and making use-after-free bugs loud in
    tests, since stale readers see fresh writes immediately)."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        #: usable ids are 1..n_blocks (0 is NULL); the device pool is
        #: therefore n_blocks + 1 blocks long.
        self._free: list[int] = list(range(self.n_blocks, 0, -1))
        self._ref: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Take `n` blocks (refcount 1 each), or None if the pool can't
        cover the whole request right now (caller queues/sheds)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def incref(self, ids) -> None:
        """Add one reference to each id (prefix-cache store / zero-copy
        hit). Double-incref of the same id in one call is legal — each
        occurrence counts."""
        for b in ids:
            if b not in self._ref:
                raise ValueError(f"incref of unallocated block {b}")
            self._ref[b] += 1

    def decref(self, ids) -> int:
        """Drop one reference per id; blocks reaching zero return to the
        free list. Returns how many blocks were actually freed."""
        freed = 0
        for b in ids:
            c = self._ref.get(b)
            if c is None:
                raise ValueError(f"decref of unallocated block {b}")
            if c == 1:
                del self._ref[b]
                self._free.append(b)
                freed += 1
            else:
                self._ref[b] = c - 1
        return freed

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)
