"""KV blocks as a wire format, and the host-RAM block tier.

The port's copy of `kubeflow_tpu/serve/kv_transfer.py`: the same frame,
the same header, the same meta fields and format versions, so a frame
packed here is byte-identical to the JAX package's for the same arrays and
each side reads the other's. The one change is the array type: arrays come
back as torch tensors, and every dtype, bfloat16 and the float8 codes of a
quantized pool included, is carried by its numpy-style name in the header
and its raw bytes, reinterpreted with torch (numpy needs `ml_dtypes` for
those, which the card's machine does not have).

  * **Wire format.** `pack_shipment`/`unpack_shipment` frame a JSON
    metadata header plus raw array payloads (per-layer K/V block gathers)
    into one byte string: magic-prefixed, versioned, no pickle. A
    prefill engine ships a prompt's committed blocks to a decode engine
    in it, and the paged engine's host tier spills evicted prefix-cache
    blocks through the same bytes.
  * **HostKVTier.** A bounded LRU of packed block payloads keyed as the
    engine's prefix cache is, `(adapter, prefix_len, hash(tokens))`, with
    the token tuple stored for hash-collision verification and a
    per-adapter length index for longest-prefix probes. Capacity is
    counted in blocks (the pool's own currency).

Format versions (the `fmt` meta field; the frame itself never changes):

  * fmt 1: full-precision K/V blocks;
  * fmt 2: fmt 1 plus a draft-KV section (a speculative prefill
    handoff): `draft_k`/`draft_v` hold the draft model's prompt blocks
    and `meta["draft"]` their identity (block_size, vocab_size, n_blocks,
    kv_shape, num_layers, dtype);
  * fmt 3: quantized blocks: `k`/`v` carry the raw int8/fp8 codes,
    `ks`/`vs` the per-row-per-head fp32 scale planes, and
    `meta["kv_quant"]` names the mode.
"""

from __future__ import annotations

import json
import struct
import threading
from collections import OrderedDict

import numpy as np
import torch

#: Wire magic + format version. Unpack refuses anything else loudly (a
#: silently misparsed KV payload would decode garbage tokens, not crash).
MAGIC = b"TPKV1\n"

_LEN = struct.Struct(">Q")

#: Header dtype names (numpy's `str(dtype)`, ml_dtypes' for bfloat16 and
#: float8) -> torch dtypes.
DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


class ShipmentError(ValueError):
    """Malformed / incompatible shipment bytes (bad magic, truncated
    frame, unknown version, dtype/shape mismatch with this engine)."""


def _spec_and_bytes(arr) -> tuple[str, list, bytes]:
    """(dtype name, shape, C-order bytes) of a torch tensor or a numpy
    array. A 0-d array ships as shape [1], as numpy's ascontiguousarray
    makes it on the JAX side."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype not in _NAMES:
            raise ShipmentError(f"cannot ship dtype {arr.dtype}")
        t = arr.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return _NAMES[t.dtype], list(t.shape) or [1], raw
    a = np.ascontiguousarray(arr)
    return str(a.dtype), list(a.shape), a.tobytes()


def pack_shipment(meta: dict, arrays: dict) -> bytes:
    """Frame `meta` (JSON-safe dict) + named arrays (torch tensors or
    numpy arrays) into one byte string: MAGIC, u64 header length, JSON
    header, raw buffers in header order. Arrays round-trip
    byte-identically (C-order)."""
    specs, bufs = [], []
    for name in sorted(arrays):
        dtype, shape, raw = _spec_and_bytes(arrays[name])
        specs.append({"name": name, "dtype": dtype, "shape": shape})
        bufs.append(raw)
    header = json.dumps({"meta": meta, "arrays": specs},
                        sort_keys=True).encode()
    return b"".join([MAGIC, _LEN.pack(len(header)), header] + bufs)


def _parse_header(data) -> tuple[dict, memoryview, int]:
    """Shared frame parse: validate magic + length, decode the JSON header
    -> (header, data_view, payload_offset). unpack_shipment, peek_meta and
    rewrite_meta all go through it. Every malformation raises
    ShipmentError."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise ShipmentError(f"shipment must be bytes, got {type(data)}")
    data = memoryview(data)
    if bytes(data[:len(MAGIC)]) != MAGIC:
        raise ShipmentError(
            f"bad shipment magic {bytes(data[:len(MAGIC)])!r} "
            f"(want {MAGIC!r})")
    off = len(MAGIC)
    if len(data) < off + _LEN.size:
        raise ShipmentError("truncated shipment header length")
    (hlen,) = _LEN.unpack(bytes(data[off:off + _LEN.size]))
    off += _LEN.size
    if len(data) < off + hlen:
        raise ShipmentError("truncated shipment header")
    try:
        header = json.loads(bytes(data[off:off + hlen]))
    except ValueError as e:
        raise ShipmentError(f"bad shipment header: {e}") from e
    if not isinstance(header, dict):
        raise ShipmentError(
            f"bad shipment header: expected object, got "
            f"{type(header).__name__}")
    return header, data, off + hlen


def unpack_shipment(data) -> tuple[dict, dict]:
    """Inverse of `pack_shipment` -> (meta, {name: torch.Tensor on the
    CPU}), each tensor holding its own copy of the payload bytes. Every
    malformation raises ShipmentError: truncated or alien bytes never come
    back as a half-parsed cache."""
    header, data, off = _parse_header(data)
    try:
        meta = header["meta"]
        specs = header["arrays"]
    except KeyError as e:
        raise ShipmentError(f"bad shipment header: {e}") from e
    arrays = {}
    for spec in specs:
        try:
            dt = DTYPES[spec["dtype"]]
            shape = tuple(int(s) for s in spec["shape"])
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise ShipmentError(f"bad array spec {spec!r}: {e}") from e
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if n < 0 or len(data) < off + n:
            raise ShipmentError(
                f"truncated shipment payload for {spec.get('name')!r}")
        raw = torch.frombuffer(bytearray(data[off:off + n]),
                               dtype=torch.uint8) if n else torch.empty(
                                   0, dtype=torch.uint8)
        arrays[spec["name"]] = raw.view(dt).reshape(shape)
        off += n
    if off != len(data):
        raise ShipmentError(
            f"{len(data) - off} trailing bytes after shipment payload")
    return meta, arrays


def rewrite_meta(data, **updates) -> bytes:
    """A copy of a shipment with `updates` merged into its meta header;
    the array payload bytes are spliced through untouched (no unpack, no
    array copies)."""
    header, data, off = _parse_header(data)
    try:
        header["meta"].update(updates)
    except (KeyError, AttributeError) as e:
        raise ShipmentError(f"bad shipment header: {e}") from e
    new_header = json.dumps(header, sort_keys=True).encode()
    return b"".join([MAGIC, _LEN.pack(len(new_header)), new_header,
                     bytes(data[off:])])


def peek_meta(data) -> dict:
    """Parse only the metadata header of a shipment (no array copies)."""
    header, _data, _off = _parse_header(data)
    try:
        return header["meta"]
    except KeyError as e:
        raise ShipmentError(f"bad shipment header: {e}") from e


class HostKVTier:
    """Host-RAM LRU tier for spilled KV block payloads.

    Keys follow the engine prefix cache's family, `(aid, n, hash(tokens))`,
    with the token tuple stored for verification and a per-adapter length
    index for longest-prefix probes, so a spilled prefix is findable by
    exactly the probe that would have hit it on the device. `take()`
    removes the entry (restore-on-hit moves blocks back to the pool; the
    tier never holds a second copy of resident state).

    All state is mutated under one lock: the engine worker spills and
    restores, while metrics readers snapshot counters from other
    threads."""

    def __init__(self, capacity_blocks: int):
        if capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}")
        self.capacity_blocks = int(capacity_blocks)
        # key -> (token_tuple, n_blocks, payload_bytes)
        self._lru: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._lens: dict[int, dict[int, int]] = {}  # guarded-by: _lock
        self._blocks = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self.stats = {  # guarded-by: _lock
            "spilled_blocks": 0, "restored_blocks": 0,
            "evicted_blocks": 0, "rejected_blocks": 0,
        }

    @property
    def resident_blocks(self) -> int:
        with self._lock:
            return self._blocks

    def stats_snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats, resident_blocks=self._blocks,
                        entries=len(self._lru))

    @staticmethod
    def _drop(lru: OrderedDict, lens: dict, stats: dict, key: tuple,
              counter: str) -> int:
        """Remove one entry from the passed-in table state (callers hold
        `_lock`). Returns the freed block count."""
        _, n, _ = lru.pop(key)
        stats[counter] += n
        aid, ln, _ = key
        per = lens.get(aid, {})
        if per.get(ln, 0) <= 1:
            per.pop(ln, None)
            if not per:
                lens.pop(aid, None)
        else:
            per[ln] -= 1
        return n

    def put(self, aid: int, kt: tuple, n_blocks: int,
            payload: bytes) -> bool:
        """Spill one prefix's packed blocks. Evicts LRU entries to make
        room; an entry larger than the whole tier is refused (False):
        spilling it would just wipe the tier for nothing."""
        n_blocks = int(n_blocks)
        if n_blocks > self.capacity_blocks:
            with self._lock:
                self.stats["rejected_blocks"] += n_blocks
            return False
        key = (aid, len(kt), hash(kt))
        with self._lock:
            existing = self._lru.get(key)
            if existing is not None:
                if existing[0] == kt:
                    self._lru.move_to_end(key)
                    return True  # already resident: pure LRU touch
                self._blocks -= self._drop(  # hash collision
                    self._lru, self._lens, self.stats, key,
                    "evicted_blocks")
            while self._blocks + n_blocks > self.capacity_blocks:
                oldest = next(iter(self._lru))
                self._blocks -= self._drop(
                    self._lru, self._lens, self.stats, oldest,
                    "evicted_blocks")
            per = self._lens.setdefault(aid, {})
            per[len(kt)] = per.get(len(kt), 0) + 1
            self._lru[key] = (kt, n_blocks, payload)
            self._blocks += n_blocks
            self.stats["spilled_blocks"] += n_blocks
        return True

    def take(self, aid: int, kt: tuple) -> tuple[int, bytes] | None:
        """Remove and return (n_blocks, payload) for an exact prefix, or
        None. The caller re-materializes the blocks in the pool, so the
        tier copy is retired here."""
        key = (aid, len(kt), hash(kt))
        with self._lock:
            entry = self._lru.get(key)
            if entry is None or entry[0] != kt:
                return None
            _, n, payload = entry
            self._blocks -= self._drop(self._lru, self._lens,
                                       self.stats, key,
                                       "restored_blocks")
        return n, payload

    def probe_longest(self, aid: int, ids) -> int | None:
        """Longest spilled prefix strictly shorter than `ids` (the
        contract of the engine's `_prefix_probe`), or None. Read
        only: the caller follows up with `take()` once it has blocks to
        restore into."""
        with self._lock:
            lens = self._lens.get(aid)
            if not lens:
                return None
            for n in sorted(lens, reverse=True):
                if n >= len(ids):
                    continue
                kt = tuple(ids[:n])
                entry = self._lru.get((aid, n, hash(kt)))
                if entry is not None and entry[0] == kt:
                    return n
        return None
