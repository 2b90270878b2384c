"""File-backed input pipeline with a checkpointable iterator.

The port of `kubeflow_tpu/data/loader.py`. A token corpus (`load_tokens`:
`.npy` memory-mapped, `.bin`/`.tokens` raw int32, text as UTF-8 bytes)
becomes random-access rows: `_Windows` (non-overlapping seq_len+1 token
windows) or `_PackedRows` (whole documents first-fit into rows, with
segment ids, restarting positions and a loss mask). `MapDataset` then does
what the JAX package's grain pipeline tail does: the per-process shard
`rows[index::count]`, an optional shuffle, repeat, and batches with the
remainder dropped.

The iterator of a `MapDataset` is checkpointable: `get_state()` is a small
JSON dict (epoch, position in the epoch, seed) and `set_state()` seeks to
it in O(1), so a resumed job continues the exact row stream. With
`shuffle=False` the batches are byte-equal to the JAX loader's. The
shuffle is this package's own: one `numpy.random.Generator(PCG64)`
permutation per (seed, epoch); it does not reproduce grain's order.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Mapping

import numpy as np


class _Windows:
    """Random-access view of a flat token array as non-overlapping
    (seq_len+1)-token windows: window i -> tokens[i*S : i*S + S + 1].
    The +1 overlap gives the shifted-by-one LM targets."""

    def __init__(self, tokens: np.ndarray, seq_len: int):
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be flat, got shape {tokens.shape}")
        self._tokens = tokens
        self._seq = int(seq_len)
        self._n = max((len(tokens) - 1) // self._seq, 0)
        if self._n == 0:
            raise ValueError(
                f"{len(tokens)} tokens can't fill one window of "
                f"{seq_len + 1}")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        s = int(i) * self._seq
        return np.asarray(self._tokens[s:s + self._seq + 1], np.int32)


def load_tokens(source: Any) -> np.ndarray:
    """Resolve a token source to a flat int32 array.

    Accepts an in-memory array/list, an `.npy` file (memory-mapped so epoch
    shuffles never load the corpus into RAM), a raw `.bin`/`.tokens` file of
    little-endian int32, or a `.txt`/other text file tokenized as UTF-8
    bytes (vocab 256)."""
    if isinstance(source, (list, tuple, np.ndarray)):
        return np.asarray(source, np.int32).reshape(-1)
    path = os.fspath(source)
    if not os.path.exists(path):
        raise FileNotFoundError(f"token source {path!r} does not exist")
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.dtype == np.int32:
            return arr
        if arr.dtype.kind in "iu":
            # Wrong-width integer export: converting materializes the
            # corpus in RAM, so check the ids fit rather than wrapping.
            if arr.size:
                lo, hi = int(arr.min()), int(arr.max())
                info = np.iinfo(np.int32)
                if lo < info.min or hi > info.max:
                    raise ValueError(
                        f"token file {path!r} holds {arr.dtype} ids "
                        f"spanning [{lo}, {hi}], which overflow int32 — "
                        "re-export the corpus as int32")
            return np.ascontiguousarray(arr, dtype=np.int32)
        raise ValueError(
            f"token file {path!r} holds dtype {arr.dtype}; token ids "
            "must be integers (re-export the corpus as int32)")
    if path.endswith((".bin", ".tokens")):
        return np.memmap(path, dtype=np.int32, mode="r")
    with open(path, "rb") as fh:
        return np.frombuffer(fh.read(), dtype=np.uint8).astype(np.int32)


def _checked_tokens(source: Any, vocab_size: int | None) -> np.ndarray:
    tokens = load_tokens(source)
    if vocab_size is not None:
        # One O(corpus) scan at startup beats training silently on
        # out-of-vocab ids.
        lo, hi = int(np.min(tokens)), int(np.max(tokens))
        if lo < 0 or hi >= vocab_size:
            raise ValueError(
                f"corpus token ids span [{lo}, {hi}] but the model vocab "
                f"is {vocab_size} — wrong tokenizer for this model?")
    return tokens


class MapDataset:
    """rows -> per-process shard -> (shuffle) -> repeat -> batch, with
    random access by batch index.

    Row stream position p (rows consumed across epochs) reads shard row
    `perm[p % n]` of epoch p // n, where perm is the identity or, with
    `shuffle`, `numpy.random.default_rng([seed, epoch]).permutation(n)`.
    Batch i is positions [i·B, (i+1)·B), so a batch may span an epoch
    boundary; the last partial batch of a finite stream is dropped.
    `fn` maps each assembled batch."""

    def __init__(self, rows, *, what: str, batch_size: int, seed: int,
                 shuffle: bool, num_epochs: int | None,
                 process_index: int, process_count: int,
                 fn: Callable[[Any], Any] | None = None):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"[0, {process_count})")
        self._rows = rows
        self._start, self._stride = int(process_index), int(process_count)
        self._n = len(range(self._start, len(rows), self._stride))
        if self._n < batch_size:
            raise ValueError(
                f"shard has {self._n} {what} < batch_size {batch_size}; "
                f"corpus too small for {process_count} procs")
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._shuffle = bool(shuffle)
        self._num_batches = (None if num_epochs is None
                             else self._n * int(num_epochs) // batch_size)
        self._fn = fn
        self._perms: dict[int, np.ndarray] = {}

    @property
    def rows_per_epoch(self) -> int:
        return self._n

    def __len__(self) -> int:
        if self._num_batches is None:
            raise TypeError("an endlessly repeated dataset has no length")
        return self._num_batches

    def _perm(self, epoch: int) -> np.ndarray:
        perm = self._perms.get(epoch)
        if perm is None:
            if len(self._perms) > 2:  # a batch spans at most two epochs
                self._perms.clear()
            perm = np.random.default_rng([self.seed, epoch]).permutation(
                self._n)
            self._perms[epoch] = perm
        return perm

    def _row(self, position: int):
        epoch, j = divmod(position, self._n)
        if self._shuffle:
            j = int(self._perm(epoch)[j])
        return self._rows[self._start + j * self._stride]

    def __getitem__(self, i: int):
        i = int(i)
        if i < 0 or (self._num_batches is not None
                     and i >= self._num_batches):
            raise IndexError(f"batch {i} out of range")
        rows = [self._row(p) for p in range(i * self.batch_size,
                                            (i + 1) * self.batch_size)]
        if isinstance(rows[0], Mapping):
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        else:
            batch = np.stack(rows)
        return self._fn(batch) if self._fn is not None else batch

    def __iter__(self) -> "MapIterator":
        return MapIterator(self)


class MapIterator:
    """Iterator over a MapDataset's batches with get_state/set_state."""

    def __init__(self, ds: MapDataset):
        self._ds = ds
        self._next = 0  # index of the next batch

    def __iter__(self) -> "MapIterator":
        return self

    def __next__(self):
        try:
            batch = self._ds[self._next]
        except IndexError:
            raise StopIteration from None
        self._next += 1
        return batch

    def get_state(self) -> dict:
        epoch, position = divmod(self._next * self._ds.batch_size,
                                 self._ds.rows_per_epoch)
        return {"epoch": epoch, "position": position, "seed": self._ds.seed}

    def set_state(self, state: Mapping[str, Any]) -> None:
        if int(state["seed"]) != self._ds.seed:
            raise ValueError(f"iterator state of seed {state['seed']} "
                             f"does not fit a stream of seed "
                             f"{self._ds.seed}")
        rows = (int(state["epoch"]) * self._ds.rows_per_epoch
                + int(state["position"]))
        if rows % self._ds.batch_size:
            raise ValueError(f"iterator state {dict(state)} is not at a "
                             f"batch boundary of {self._ds.batch_size}")
        self._next = rows // self._ds.batch_size


def _pipeline_tail(rows, *, what: str, batch_size: int, seed: int,
                   shuffle: bool, num_epochs: int | None,
                   process_index: int | None, process_count: int | None,
                   fn=None) -> MapDataset:
    if process_index is None or process_count is None:
        process_index, process_count = 0, 1  # one process
    return MapDataset(rows, what=what, batch_size=batch_size, seed=seed,
                      shuffle=shuffle, num_epochs=num_epochs,
                      process_index=process_index,
                      process_count=process_count, fn=fn)


def _split_window_batch(b: np.ndarray) -> dict:
    return {"inputs": b[:, :-1], "targets": b[:, 1:]}


def lm_dataset(
    source: Any,
    *,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: int | None = None,
    process_index: int | None = None,
    process_count: int | None = None,
    vocab_size: int | None = None,
) -> MapDataset:
    """windows -> per-process shard -> (shuffle) -> repeat -> batch ->
    {"inputs", "targets"}. `iter()` on the result is checkpointable;
    `batch_size` is the per-process batch."""
    tokens = _checked_tokens(source, vocab_size)
    return _pipeline_tail(
        _Windows(tokens, seq_len), what="windows", batch_size=batch_size,
        seed=seed, shuffle=shuffle, num_epochs=num_epochs,
        process_index=process_index, process_count=process_count,
        fn=_split_window_batch)


class _PackedRows:
    """Random-access packed rows: each row is seq_len+1 tokens of WHOLE
    documents (first-fit in corpus order — a document that does not fit
    the current row's remaining space closes the row with loss-masked
    padding rather than being split mid-document). Only documents longer
    than a whole row are chunked, each chunk its own segment. Stored as a
    CSR span table into the (memmapped) corpus — O(docs) memory. Padding
    spans are (start=-1, len); their tokens are eos, their segment id is
    -1, and their targets are masked."""

    def __init__(self, tokens: np.ndarray, seq_len: int, eos_id: int):
        self._tokens = tokens
        self._seq = int(seq_len)
        self._eos = int(eos_id)
        row_cap = self._seq + 1
        # Document spans (start, length), eos kept as the doc's last token.
        ends = np.flatnonzero(np.asarray(tokens) == eos_id)
        starts = np.concatenate([[0], ends + 1]).astype(np.int64)
        stops = np.concatenate([ends + 1, [len(tokens)]]).astype(np.int64)
        lens = stops - starts
        keep = lens > 0
        starts, lens = starts[keep], lens[keep]
        n = len(starts)
        # First-fit packing by searchsorted over the cumulative lengths:
        # one python iteration per ROW (plus one per over-long doc).
        csum = np.concatenate([[0], np.cumsum(lens)])
        rows: list[list[tuple[int, int]]] = []
        cur: list[tuple[int, int]] = []
        used = 0

        def close_row():
            nonlocal cur, used
            if used and row_cap - used:
                cur.append((-1, row_cap - used))  # pad span
            if used:
                rows.append(cur)
            cur, used = [], 0

        i = 0
        while i < n:
            ln = int(lens[i])
            if ln > row_cap:  # over-long doc: chunk across dedicated rows
                close_row()
                off = 0
                while ln > 0:
                    piece = min(ln, row_cap)
                    cur.append((int(starts[i] + off), piece))
                    used += piece
                    off += piece
                    ln -= piece
                    if used == row_cap:
                        close_row()
                i += 1
                continue
            # Longest run of whole documents fitting the open row.
            j = int(np.searchsorted(
                csum, csum[i] + (row_cap - used), side="right")) - 1
            if j <= i:  # next doc alone doesn't fit the remaining space
                close_row()
                continue
            cur.extend(zip(starts[i:j].tolist(), lens[i:j].tolist()))
            used += int(csum[j] - csum[i])
            i = j
            if used == row_cap:
                close_row()
        close_row()
        if not rows:
            raise ValueError(
                f"corpus has no packed row of {row_cap} tokens")
        self._row_ptr = np.concatenate(
            [[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
        flat = [sp for r in rows for sp in r]
        self._span_start = np.asarray([s for s, _ in flat], np.int64)
        self._span_len = np.asarray([ln for _, ln in flat], np.int64)

    def __len__(self) -> int:
        return len(self._row_ptr) - 1

    def __getitem__(self, i: int) -> dict:
        row_cap = self._seq + 1
        n = len(self._row_ptr) - 1
        i = int(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"row {i} out of range for {n} packed rows")
        a, b = self._row_ptr[i], self._row_ptr[i + 1]
        starts = self._span_start[a:b]
        lens = self._span_len[a:b]
        # Per-token span id and within-span position, then one gather.
        offs = np.repeat(np.concatenate([[0], np.cumsum(lens[:-1])]), lens)
        sid = np.repeat(np.arange(b - a), lens)
        pos = (np.arange(row_cap, dtype=np.int64) - offs)
        src = starts[sid] + pos
        pad = starts[sid] < 0
        toks = np.where(
            pad, self._eos,
            np.asarray(self._tokens[np.where(pad, 0, src)])).astype(
                np.int32)
        segs = np.where(pad, -1, sid).astype(np.int32)
        pos = pos.astype(np.int32)
        return {
            "inputs": toks[:-1],
            "targets": toks[1:],
            "segment_ids": segs[:-1],
            "positions": pos[:-1],
            # A target in the NEXT document — or inside padding — is not
            # this segment's to predict.
            "mask": ((segs[:-1] == segs[1:]) & (segs[:-1] >= 0)).astype(
                np.float32),
        }


def packed_lm_dataset(
    source: Any,
    *,
    batch_size: int,
    seq_len: int,
    eos_id: int,
    seed: int = 0,
    shuffle: bool = True,
    num_epochs: int | None = None,
    process_index: int | None = None,
    process_count: int | None = None,
    vocab_size: int | None = None,
) -> MapDataset:
    """Document-packed LM pipeline: eos-delimited documents packed into
    fixed rows with per-token segment ids, restarting positions and a
    cross-document loss mask. Same checkpointable iterator as
    `lm_dataset`."""
    tokens = _checked_tokens(source, vocab_size)
    return _pipeline_tail(
        _PackedRows(tokens, seq_len, eos_id), what="packed rows",
        batch_size=batch_size, seed=seed, shuffle=shuffle,
        num_epochs=num_epochs, process_index=process_index,
        process_count=process_count)


def iterator_state(it: Any) -> Mapping[str, Any] | None:
    """The iterator's resume state, or None for plain generators."""
    get = getattr(it, "get_state", None)
    return get() if callable(get) else None


def restore_iterator(it: Any, state: Mapping[str, Any] | None) -> bool:
    """Seek a checkpointable iterator to a saved state. Returns True when
    the seek happened (caller then skips replay)."""
    set_state = getattr(it, "set_state", None)
    if state is None or not callable(set_state):
        return False
    set_state(dict(state))
    return True
