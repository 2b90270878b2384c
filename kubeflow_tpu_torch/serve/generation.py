"""Generative LLM serving: KV-cache decode, sampling, continuous batching.

The port of the flat and paged paths of `kubeflow_tpu/serve/generation.py`,
with its overlapped scheduler:

  * flat (the default): one slot-batched KV cache [L, slots, max_len, KH,
    D] on the device; stale slot content needs no eviction — absolute-
    position masking hides anything past a slot's write index;
  * paged (`kv_block_size` > 0): a pool of fixed-size blocks [L, kv_blocks
    + 1, block_size, KH, D] with the NULL block 0 (serve/paging.py); each
    request reserves its worst-case blocks whole at admission (or waits,
    head of line, until retirements free them) and frees them at
    retirement; each decode dispatch gathers the block tables into a
    contiguous [L, slots, bucket, ...] view, runs the flat chunk on it
    verbatim (view row t is logical position t) and scatters it back, so
    paged decode is token- and logprob-identical to flat;
  * `kv_quant` "int8"/"fp8" (paged only) stores the pool as codes with
    per-row fp32 scale planes; admission quantizes the full-precision
    prefill fragment as it scatters it (the same row encode as the model's
    decode writes), and decode attends over the raw codes with the scales
    applied to scores and probabilities (models/llama.py);
  * admission prefills a prompt into a one-row fragment cache, in chunks of
    the largest prompt bucket when it is longer (the first chunk a plain
    prefill — flash attention — the rest continuation chunks over the
    fragment), then copies the fragment into the slot (flat) or its
    blocks (paged);
  * decode runs `chunk` steps per dispatch over the smallest cache-length
    bucket covering every active row, sampling on the device;
  * up to `pipeline_depth` (default 2, as in JAX) decode chunks are in
    flight: chunk k+1 is enqueued, chained through the cache and chunk k's
    last tokens on the device, before chunk k's tokens are fetched, and an
    admission is enqueued behind the chunks in flight with its first token
    left on the device until a later poll or fetch. Host-to-device
    arguments go through pinned buffers without a stream sync, and each
    chunk's tokens come back by a non-blocking copy and an event: the
    fetch's wait on that event is the one designed host sync. Rows of a
    chunk dispatched for a request that has since finished are dropped at
    the fetch (`decode_dead_slot_chunks`, `decode_wasted_tokens`); the
    dead rows' writes land in the retired slot's tail (flat) or its freed
    blocks and the NULL block (paged), all enqueued, on the one stream,
    before the next admission's insert overwrites them. Depth 1 is the
    synchronous loop: dispatch, fetch, repeat;
  * finished slots are re-admitted between chunks;
  * a request's `deadline` (utils/resilience.Deadline, from the server's
    timeout header) is checked at admission and at every chunk boundary:
    an expired waiter is never admitted, and an expired running request
    frees its slot (and, paged, its blocks) at the next boundary, its
    rows of chunks already in flight dropped at their fetch like a
    retirement's. `submit` wakes at the deadline and raises
    DeadlineExceeded; the engine counts no expiry (the server does, once);
  * `on_tokens(tokens, done)` streams each request's tokens from the
    worker thread as they are emitted, the last call with done=True
    before `submit` returns;
  * `adapters` ({name: PEFT adapter dir}) stacks LoRA adapters on the
    device (serve/multilora.py) and `submit(..., adapter=name)` picks one
    per request: each slot carries its adapter id, which reaches the
    device by the pinned copy at admission and at each dispatch, and each
    decode chunk gathers its rows' factors once, for all of its steps.
    Base rows get exact zeros: their ids equal a base-only engine's. An
    engine without adapters runs exactly the base path.

Sampling is greedy (temperature 0), temperature, top-k and top-p, per row,
with draws from the engine's own seeded `torch.Generator`, taken as work is
enqueued. The draws are not the JAX package's: only greedy output is
comparable across packages. Depth 2 may order an admission's draws
differently from depth 1 when requests overlap (as in JAX); a single
request draws the same stream at any depth.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque
from typing import Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import adapter_rows, init_cache
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.paging import BlockAllocator, blocks_for
from kubeflow_tpu_torch.serve.quant import KV_QUANT_MODES, kv_quantize_rows
from kubeflow_tpu_torch.serve.tokenizer_util import decode_ids, resolve_ids
from kubeflow_tpu_torch.utils.resilience import Deadline, DeadlineExceeded

NEG_INF = -1e30


class KVCapacityExceeded(RuntimeError):
    """The request's worst-case KV footprint exceeds the whole paged pool:
    it can never be admitted. The HTTP server answers 503 + Retry-After
    (a shed, not a bad request: this replica's pool is just too small)."""


class _NeedKVBlocks(Exception):
    """Internal admission signal: the pool cannot cover the request's
    worst-case need right now (it fits in principle). The request waits at
    the head of the line until retirements free blocks."""


def _chosen_logprob(logits, tok):
    """log P(tok) under the untempered distribution. logits [..., V],
    tok [...] -> [...] fp32."""
    l32 = logits.float()
    gold = l32.gather(-1, tok[..., None].long())[..., 0]
    return gold - torch.logsumexp(l32, dim=-1)


def sample_tokens(logits, temperature, generator, top_k=None, top_p=None):
    """Per-row sampling: argmax where temperature <= 0, else categorical at
    that temperature with optional top-k / nucleus truncation. logits
    [B, V]; temperature/top_p [B] fp32; top_k [B] int (<= 0 disables);
    draws come from `generator`. Returns [B] int64."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    safe_t = temperature.clamp_min(1e-4)[:, None]
    scaled = logits.float() / safe_t
    if top_k is not None or top_p is not None:
        sorted_desc = scaled.sort(dim=-1, descending=True).values
        keep = torch.ones_like(scaled, dtype=torch.bool)
        if top_k is not None:
            idx = (top_k.long() - 1).clamp(0, v - 1)[:, None]
            kth = sorted_desc.gather(-1, idx)
            keep &= torch.where(top_k[:, None] > 0, scaled >= kth, True)
        if top_p is not None:
            probs = torch.softmax(sorted_desc, dim=-1)
            # Keep the smallest prefix whose mass reaches p (the top token
            # always survives): a token is kept iff the mass STRICTLY
            # before it is < p.
            cum_before = probs.cumsum(dim=-1) - probs
            kept_sorted = cum_before < top_p[:, None]
            cutoff_idx = (kept_sorted.sum(dim=-1, keepdim=True) - 1
                          ).clamp_min(0)
            cutoff = sorted_desc.gather(-1, cutoff_idx)
            keep &= torch.where(top_p[:, None] < 1.0, scaled >= cutoff, True)
        scaled = torch.where(keep, scaled, NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    # torch.multinomial's own draw for one sample, an exponential race
    # (argmax p / E with E ~ Exp(1)): the same draws and the same ids,
    # without its input checks, which are two host syncs a call on CUDA.
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    sampled = (probs / race).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def build_engine_fns(model, *, max_len: int, chunk: int,
                     prefill_buckets: Sequence[int], kv_block_size: int = 0,
                     kv_quant: str = "none") -> dict:
    """The engine's device functions as closures over `model`.

    Caches are written in place: `prefill` returns a fresh fragment,
    `extend`/`extend_mid` write into the fragment they are given, `insert`
    copies a fragment into one slot of the engine cache, and a decode
    chunk writes into the engine cache through a view of its first
    `bucket` rows.

    `kv_block_size` > 0 adds the paged functions: `make_decode_paged`
    (gather the block tables into a view, the flat chunk on it, scatter it
    back) and `insert_paged` (scatter a fragment into a request's blocks,
    quantizing its rows when `kv_quant` is set).

    Every function that runs the model takes an optional trailing
    `adapter`, each row's multi-LoRA factors (`models.llama.AdapterRows`);
    None runs the base model exactly as without adapters."""
    cfg = model.cfg
    dev = model.device
    big = max(prefill_buckets)
    # Fragment headroom of one largest bucket when a prompt may chunk: a
    # continuation chunk writes a whole bucket at a nonzero offset, and its
    # padding may reach past max_len. Pad rows land in the headroom and are
    # dropped at insert.
    frag_len = max_len + (big if big < max_len - 1 else 0)

    def _last(hidden, length, temperature, top_k, top_p, gen):
        """Sample from the logits of the last real token only: the other
        rows of the bucket are never unembedded."""
        last = model.unembed(hidden[:, length - 1])
        tok = sample_tokens(last, temperature, gen, top_k, top_p)
        return tok, _chosen_logprob(last, tok)

    def prefill(tokens, length, temperature, top_k, top_p, gen,
                adapter=None):
        """tokens [1, bucket] right-padded, `length` real tokens; returns
        (fragment cache, first sampled token [1], its logprob [1])."""
        frag = init_cache(cfg, 1, frag_len, device=dev)
        hidden, frag = model(tokens, cache=frag,
                             cache_index=torch.zeros(1, dtype=torch.int32,
                                                     device=dev),
                             return_hidden=True, adapter=adapter)
        return (frag,) + _last(hidden, length, temperature, top_k, top_p, gen)

    def _continue(frag, tokens, index, return_hidden, adapter):
        positions = (index + torch.arange(tokens.shape[1], device=dev))[None]
        cache_index = torch.full((1,), index, dtype=torch.int32, device=dev)
        return model(tokens, positions=positions, cache=frag,
                     cache_index=cache_index, attend_full_cache=True,
                     return_hidden=return_hidden, adapter=adapter)

    def extend(frag, tokens, length, index, temperature, top_k, top_p, gen,
               adapter=None):
        """Final continuation chunk of a long prompt, written at offset
        `index` and attending over the whole fragment; samples like
        prefill."""
        hidden, frag = _continue(frag, tokens, index, True, adapter)
        return (frag,) + _last(hidden, length, temperature, top_k, top_p, gen)

    def extend_mid(frag, tokens, index, adapter=None):
        """Intermediate continuation chunk: cache write and attention only
        (no unembedding — its sampled token would be discarded)."""
        _continue(frag, tokens, index, True, adapter)
        return frag

    def insert(cache, frag, slot):
        """Copy a fragment (batch 1) into slot `slot`, dropping its
        headroom rows past max_len."""
        for name in ("k", "v"):
            cache[name][:, slot] = frag[name][:, 0, :cache[name].shape[2]]
        return cache

    def make_decode(truncate: bool, bucket: int):
        def decode_chunk(cache, last_tok, index, temperature, top_k, top_p,
                         gen, adapter=None):
            """`chunk` decode steps; last_tok/index/temperature [B].
            Attention runs over the first `bucket` cache rows only. Returns
            (cache, tokens [B, chunk], logprobs [B, chunk]). Only the
            truncating variant pays the full-vocab sort of top-k/top-p."""
            view = {n: c[:, :, :bucket] for n, c in cache.items()}
            tok, idx = last_tok, index
            toks, lps = [], []
            for _ in range(chunk):
                logits, _ = model(tok[:, None], cache=view,
                                  cache_index=idx.clamp_max(bucket - 1),
                                  adapter=adapter)
                last = logits[:, 0]
                if truncate:
                    tok = sample_tokens(last, temperature, gen, top_k, top_p)
                else:
                    tok = sample_tokens(last, temperature, gen)
                toks.append(tok)
                lps.append(_chosen_logprob(last, tok))
                idx = idx + 1
            return cache, torch.stack(toks, dim=1), torch.stack(lps, dim=1)
        return decode_chunk

    fns = {"prefill": prefill, "extend": extend, "extend_mid": extend_mid,
           "insert": insert, "make_decode": make_decode}
    if kv_block_size <= 0:
        return fns
    bs = int(kv_block_size)

    def _gather_view(pool_leaf, tables):
        """[L, NB, bs, ...] x [B, nb] -> a contiguous [L, B, nb*bs, ...]
        copy: view row j*bs + r is block tables[b, j] row r, logical
        position j*bs + r, because tables are position-ordered."""
        g = pool_leaf[:, tables]
        return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                         *g.shape[4:])

    def _scatter_view(pool_leaf, view_leaf, tables):
        """Write the view back to its blocks. Duplicate ids are only the
        NULL block (table pads, idle rows), which receives garbage nobody
        reads."""
        b, nb = tables.shape
        v = view_leaf.reshape(view_leaf.shape[0], b * nb, bs,
                              *view_leaf.shape[3:])
        pool_leaf[:, tables.reshape(-1)] = v

    def make_decode_paged(truncate: bool, bucket: int):
        flat_chunk = make_decode(truncate, bucket)

        def decode_chunk(pool, tables, last_tok, index, temperature, top_k,
                         top_p, gen, adapter=None):
            """The flat chunk over a gathered block view: tables [B,
            bucket/bs] (pad entries 0 = the NULL block). Returns (pool,
            tokens [B, chunk], logprobs [B, chunk])."""
            view = {n: _gather_view(p, tables) for n, p in pool.items()}
            _, toks, lps = flat_chunk(view, last_tok, index, temperature,
                                      top_k, top_p, gen, adapter)
            for n, p in pool.items():
                _scatter_view(p, view[n], tables)
            return pool, toks, lps
        return decode_chunk

    def insert_paged(pool, frag, table):
        """Scatter a fragment's first len(table)*bs rows into the blocks
        `table` [nb] (a request's reservation, position-ordered), layer by
        layer. A quantized pool gets the rows' codes and scales, by the
        same encode as the model's decode writes."""
        nb = table.numel()
        # One layer at a time keeps the quantizer's fp32 temporaries small.
        for layer in range(cfg.num_layers):
            rows = {n: f[layer, 0, :nb * bs] for n, f in frag.items()}
            if kv_quant != "none":
                rows["k"], rows["ks"] = kv_quantize_rows(rows["k"], kv_quant)
                rows["v"], rows["vs"] = kv_quantize_rows(rows["v"], kv_quant)
            for n, r in rows.items():
                pool[n][layer, table] = r.reshape(nb, bs, *r.shape[1:]).to(
                    pool[n].dtype)
        return pool

    fns.update(make_decode_paged=make_decode_paged, insert_paged=insert_paged)
    return fns


def _wait(event) -> None:
    """Block the host until `event` has passed: the engine's one designed
    host sync (a chunk's fetch, or a first token read before its copy was
    seen to land)."""
    event.synchronize()


class GenerationEngine:
    """Slot-based continuous-batching decode loop over one global cache.

    `submit()` is thread-safe and blocks until the request completes; one
    worker thread runs every device call, multiplexing the in-flight
    requests onto the slot batch: admit waiting requests into free slots,
    keep up to `pipeline_depth` decode chunks in flight, fetch the oldest,
    emit, repeat. `pipeline_depth` 1 fetches each chunk before the next is
    dispatched.

    `kv_block_size` > 0 pages the cache: `slots` is then the decode width
    and memory is the pool of `kv_blocks` blocks (0 sizes it to the flat
    cache, slots * max_len rows). `kv_quant` "int8"/"fp8" needs the pool.

    `adapters` ({name: PEFT adapter dir}) loads multi-LoRA stacks on the
    engine's device; `submit(..., adapter=name)` serves a request through
    one of them."""

    #: Disaggregated roles are not ported: every engine prefills and
    #: decodes (rendered as the `tpk_engine_role` gauge).
    role = "unified"

    def __init__(self, model, *, slots: int = 4, max_len: int = 256,
                 chunk: int = 16, prefill_buckets: Sequence[int] = (32, 128),
                 decode_buckets: Sequence[int] | None = None, seed: int = 0,
                 pipeline_depth: int = 2, kv_block_size: int = 0,
                 kv_blocks: int = 0, kv_quant: str = "none",
                 adapters: dict | None = None):
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.device = model.device
        self.max_len, self.chunk = int(max_len), int(chunk)
        self.n_slots = int(slots)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's position "
                f"range (max_seq_len={cfg.max_seq_len})")
        if cfg.mask_kind == "sliding_window":
            raise NotImplementedError(
                "sliding-window serving (rolling-window cache) is not "
                "supported by this package yet")
        if cfg.mask_kind != "causal":
            raise ValueError(f"generative serving needs a causal model; got "
                             f"mask_kind={cfg.mask_kind!r}")
        if int(pipeline_depth) < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        #: Decode chunks in flight right now (read by metadata).
        self.inflight_depth = 0
        self.prefill_buckets = sorted(
            {min(int(b), self.max_len) for b in prefill_buckets})
        # Length-aware decode: attention cost tracks the longest active
        # sequence, not max_len. Default buckets: powers of two from
        # max(64, 2*chunk) up to max_len.
        if decode_buckets is None:
            b, decode_buckets = max(64, 2 * self.chunk), []
            while b < self.max_len:
                decode_buckets.append(b)
                b *= 2
        self.decode_buckets = sorted(
            {int(b) for b in decode_buckets
             if self.chunk < int(b) < self.max_len} | {self.max_len})
        self._paged = int(kv_block_size) > 0
        self._kv_bs = int(kv_block_size)
        if self._paged:
            if self.max_len % self._kv_bs:
                raise ValueError(
                    f"kv_block_size {self._kv_bs} must divide max_len "
                    f"{self.max_len} (block tables address whole blocks)")
            bad = [b for b in self.decode_buckets if b % self._kv_bs]
            if bad:
                raise ValueError(
                    f"kv_block_size {self._kv_bs} must divide every "
                    f"decode bucket; offending: {bad} (pass explicit "
                    "decode_buckets or a power-of-two block size)")
            n_blocks = int(kv_blocks) or -(-self.n_slots * self.max_len
                                           // self._kv_bs)
            self._kv_alloc = BlockAllocator(n_blocks, self._kv_bs)
        self.kv_quant = str(kv_quant or "none")
        if self.kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"kv_quant {self.kv_quant!r}: must be one of "
                             f"{KV_QUANT_MODES}")
        if self.kv_quant != "none" and not self._paged:
            raise ValueError(
                "kv_quant requires the paged KV cache (quantization is a "
                "property of pool blocks); set kv_block_size > 0")
        # Admissions waiting for pool blocks, head of line first.
        self._kv_stash: deque = deque()
        # Multi-LoRA (serve/multilora.py): every adapter stacked on the
        # device, entry 0 the base; None when the engine has none.
        self._ml_stacks = None
        self._ml_ids: dict[str, int] = {}
        if adapters:
            from kubeflow_tpu_torch.serve.multilora import \
                build_adapter_stacks

            t0 = time.monotonic()
            self._ml_stacks, self._ml_ids = build_adapter_stacks(
                dict(adapters), cfg, device=self.device)
            #: Seconds spent reading and stacking the adapters.
            self.adapter_load_s = time.monotonic() - t0
        self._ml_names = {i: n for n, i in self._ml_ids.items()}
        fns = build_engine_fns(model, max_len=self.max_len, chunk=self.chunk,
                               prefill_buckets=self.prefill_buckets,
                               kv_block_size=self._kv_bs,
                               kv_quant=self.kv_quant)
        self._fns = fns
        make = fns["make_decode_paged" if self._paged else "make_decode"]
        self._decode = {(b, trunc): make(trunc, b)
                        for b in self.decode_buckets for trunc in (False, True)}
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if self._paged:  # the pool: kv_blocks usable blocks + NULL block 0
            self._cache = init_cache(cfg, self._kv_alloc.n_blocks + 1,
                                     self._kv_bs, kv_quant=self.kv_quant,
                                     device=self.device)
        else:
            self._cache = init_cache(cfg, self.n_slots, self.max_len,
                                     device=self.device)
        self._queue: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._stats_lock = threading.Lock()
        # decode_seconds is the union of the intervals in which some chunk
        # was in flight, so throughput() does not count overlap twice.
        # host_stall_seconds: time blocked in the fetch's wait.
        self.stats = {"requests": 0, "prompt_tokens": 0, "decode_tokens": 0,
                      "decode_seconds": 0.0, "decode_dispatches": 0,
                      "prefill_chunks": 0, "decode_fetch_overlapped": 0,
                      "decode_fetch_blocking": 0, "admit_overlap": 0,
                      "decode_dead_slot_chunks": 0, "decode_wasted_tokens": 0,
                      "host_stall_seconds": 0.0}
        self._busy_mark: float | None = None
        self._slots: list[dict | None] = [None] * self.n_slots
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="generate-engine")
        self._thread.start()

    # -- public API ----------------------------------------------------------

    def adapter_names(self) -> list:
        """Loaded multi-LoRA adapter names (the OpenAI model-id routing and
        metadata() read this)."""
        return sorted(self._ml_ids)

    def _resolve_adapter(self, name) -> int:
        if name is None:
            return 0
        if self._ml_stacks is None:
            raise ValueError(
                f"adapter {name!r} requested but the engine has no "
                "adapters configured")
        try:
            return self._ml_ids[name]
        except KeyError:
            raise ValueError(
                f"unknown adapter {name!r}; loaded: "
                f"{sorted(self._ml_ids)}") from None

    def _adapter_rows(self, aids: np.ndarray):
        """Rows' multi-LoRA factors for adapter ids `aids` (None without
        adapters): the ids go over by the pinned copy, the gather runs on
        the device."""
        if self._ml_stacks is None:
            return None
        return adapter_rows(self._ml_stacks, self._to_device(aids),
                            self.cfg.dtype)

    def submit(self, input_ids: Sequence[int], *, max_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: int | None = None, timeout: float = 300.0,
               adapter: str | None = None,
               deadline: Deadline | None = None, on_tokens=None) -> dict:
        """Generate up to `max_tokens` tokens after `input_ids`; blocks.
        `adapter` names one of the engine's LoRA adapters (None: the
        base).

        `on_tokens(tokens, done)` (optional) is called from the worker
        thread as tokens are emitted, the final call with done=True;
        its exceptions are swallowed (a broken stream consumer must not
        stall the decode loop). `deadline` is the request's end-to-end
        budget: checked at admission and at every chunk boundary, where
        an expired request frees its slot; this call returns when it
        expires, raising DeadlineExceeded."""
        if not input_ids:
            raise ValueError("input_ids must be non-empty")
        ids = [int(t) for t in input_ids]
        if len(ids) > self.max_len - 1:
            raise ValueError(f"prompt of {len(ids)} tokens exceeds max_len "
                             f"{self.max_len}")
        bad = [t for t in ids if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids outside [0, {self.cfg.vocab_size}): "
                             f"{bad[:8]}")
        if int(max_tokens) < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        aid = self._resolve_adapter(adapter)
        if self._paged:
            need = self._need_blocks(len(ids), int(max_tokens))
            if need > self._kv_alloc.n_blocks:
                # Permanent: even an empty pool cannot cover it.
                raise KVCapacityExceeded(
                    f"request needs {need} KV blocks worst-case (prompt "
                    f"{len(ids)} + max_tokens {int(max_tokens)}) but the "
                    f"pool has {self._kv_alloc.n_blocks}")
        req = {"input_ids": ids, "max_tokens": int(max_tokens),
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "aid": aid, "eos_id": eos_id,
               "out": [], "out_logprobs": [], "done": threading.Event(),
               "error": None, "deadline": deadline, "cb": on_tokens,
               "t0": time.monotonic()}
        self._queue.put(req)
        self._wake.set()
        # Wake at the deadline: the worker frees the slot at its next
        # chunk boundary, but the caller's 504 does not wait for it.
        wait_s = timeout if deadline is None else deadline.bound(timeout)
        if not req["done"].wait(wait_s):
            if deadline is not None and deadline.expired():
                req["error"] = DeadlineExceeded(
                    "request deadline expired during generation")
            else:
                req["error"] = f"generation timed out after {timeout}s"
        if isinstance(req["error"], BaseException):
            raise req["error"]
        if req["error"]:
            raise RuntimeError(req["error"])
        return {"output_ids": req["out"],
                "output_logprobs": req["out_logprobs"],
                "num_input_tokens": len(ids),
                "num_output_tokens": len(req["out"]),
                "latency_s": time.monotonic() - req["t0"]}

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30.0)

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    def throughput(self) -> float:
        """Decode tokens per second of engine decode time."""
        s = self.stats_snapshot()
        return (s["decode_tokens"] / s["decode_seconds"]
                if s["decode_seconds"] else 0.0)

    @property
    def kv_blocks_free(self) -> int | None:
        """Free pool blocks (None = flat): the `tpk_kv_blocks_free` gauge."""
        return self._kv_alloc.free_blocks if self._paged else None

    @property
    def kv_blocks_used(self) -> int | None:
        return self._kv_alloc.used_blocks if self._paged else None

    def kv_info(self) -> dict | None:
        """Paged-pool snapshot for metadata (None = flat)."""
        if not self._paged:
            return None
        return {"block_size": self._kv_bs, "blocks": self._kv_alloc.n_blocks,
                "blocks_free": self._kv_alloc.free_blocks,
                "blocks_used": self._kv_alloc.used_blocks}

    # -- worker --------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _need_blocks(self, prompt: int, max_tokens: int) -> int:
        """Blocks covering the worst-case cache rows a request can ever
        write: the prompt plus its decode budget rounded up to whole
        dispatch chunks (the retirement chunk still writes its full
        width), capped at max_len (decode indices clamp at bucket - 1).
        They are reserved whole at admission, never on the decode path."""
        chunks = -(-max(int(max_tokens), 1) // self.chunk)
        return blocks_for(min(self.max_len, prompt + chunks * self.chunk),
                          self._kv_bs)

    def _free_slot_blocks(self, st: dict) -> None:
        """Return a retired request's blocks to the pool (idempotent)."""
        blocks = st.pop("blocks", None)
        if blocks:
            self._kv_alloc.decref(blocks)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a stream sync. On
        CUDA it goes through a pinned staging copy and a non-blocking
        transfer (a pageable copy would wait for every chunk in flight);
        PyTorch's pinned-memory allocator hands the staging block out again
        only after the transfer that reads it has run."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, *tensors) -> tuple:
        """Start copying device tensors to the host: (host tensors, event).
        On CUDA the copies land in pinned buffers behind everything
        enqueued so far and the event marks their arrival; on the CPU the
        tensors are their own host copies and the event is None."""
        if self.device.type != "cuda":
            return tensors, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _admit(self, slot: int, req: dict) -> None:
        """Chunked prefill into a fragment, insert it into `slot` (flat) or
        into the request's reserved blocks (paged). At depth 1 the first
        sampled token is fetched and emitted here; deeper, it stays on the
        device as the slot's `pending` decode carry (its host copy under
        way) and is emitted at a later poll or fetch. Paged: raises
        _NeedKVBlocks when the pool is short now."""
        table = None
        if self._paged:
            table = self._kv_alloc.alloc(self._need_blocks(
                len(req["input_ids"]), req["max_tokens"]))
            if table is None:
                raise _NeedKVBlocks()
        try:
            frag, tok0, lp0 = self._prefill_fragment(req)
            if table is None:
                self._fns["insert"](self._cache, frag, slot)
            else:
                self._fns["insert_paged"](
                    self._cache, frag,
                    self._to_device(np.asarray(table, np.int64)))
        except BaseException:
            if table is not None:
                self._kv_alloc.decref(table)
            raise
        ids = req["input_ids"]
        st = {"req": req, "idx": len(ids), "disp": len(ids), "last": None,
              "pending": None}
        if table is not None:
            st["blocks"] = table
        if self.pipeline_depth > 1:
            st["pending"] = (tok0, *self._to_host(tok0, lp0))
        else:
            st["last"] = int(tok0[0])
        self._slots[slot] = st
        with self._stats_lock:
            self.stats["prefill_chunks"] += -(-len(ids)
                                              // self.prefill_buckets[-1])
            self.stats["requests"] += 1
            self.stats["prompt_tokens"] += len(ids)
            if req["aid"]:
                per = dict(self.stats.get("adapter_requests", {}))
                name = self._ml_names[req["aid"]]
                per[name] = per.get(name, 0) + 1
                self.stats["adapter_requests"] = per
        if st["pending"] is None:
            self._emit(slot, st, [st["last"]], [float(lp0[0])])

    def _prefill_fragment(self, req: dict):
        """The prompt's chunked prefill into a one-row fragment cache:
        (fragment, first sampled token [1], its logprob [1])."""
        ids = req["input_ids"]
        samp = (self._to_device(np.array([req["temperature"]], np.float32)),
                self._to_device(np.array([req["top_k"]], np.int64)),
                self._to_device(np.array([req["top_p"]], np.float32)))
        big = self.prefill_buckets[-1]
        fns = self._fns
        ad = self._adapter_rows(np.array([req["aid"]], np.int64))
        frag, done = None, 0
        while done < len(ids):
            piece = ids[done:done + big]
            final = done + len(piece) >= len(ids)
            toks = np.zeros((1, self._bucket_for(len(piece))), np.int64)
            toks[0, :len(piece)] = piece
            toks = self._to_device(toks)
            if done == 0:
                frag, tok0, lp0 = fns["prefill"](toks, len(piece), *samp,
                                                 self._gen, ad)
            elif final:
                frag, tok0, lp0 = fns["extend"](frag, toks, len(piece), done,
                                                *samp, self._gen, ad)
            else:  # intermediate chunk: no sampling, no unembedding
                frag = fns["extend_mid"](frag, toks, done, ad)
            done += len(piece)
        return frag, tok0, lp0

    def _emit(self, slot: int, st: dict, tokens: list[int],
              logprobs: list[float]) -> None:
        """Append generated tokens to `st`'s request and stream them to its
        `on_tokens`; retire on EOS / budget / context end. `st` is passed,
        not read from the slot: a fetched chunk may belong to a request
        that already retired and whose slot holds another; a finished
        request takes no more tokens, and only the slot that still holds
        it is freed."""
        req = st["req"]
        new: list[int] = []
        finished = req["done"].is_set()
        for tok, lp in zip(tokens, logprobs):
            if finished:
                break
            req["out"].append(tok)
            req["out_logprobs"].append(lp)
            new.append(tok)
            if ((req["eos_id"] is not None and tok == req["eos_id"])
                    or len(req["out"]) >= req["max_tokens"]):
                finished = True
        if st["idx"] >= self.max_len - 1:
            finished = True
        # Stream before done.set(): that wakes submit() in the caller's
        # thread, and a final summary overtaking the last token frame
        # would truncate the stream.
        if req["cb"] is not None and (new or finished):
            try:
                req["cb"](new, finished)
            except Exception:
                pass
        if finished:
            req["done"].set()
            if self._slots[slot] is st:
                self._slots[slot] = None
            if self._paged:
                self._free_slot_blocks(st)

    def _expire(self, req: dict) -> bool:
        """Finish `req` with DeadlineExceeded when its budget is gone.
        True means the request is done and must not (or no longer) hold a
        slot. No metrics here: the serving surface that returns the error
        counts each expired request exactly once."""
        if req["done"].is_set():
            return True  # already finished (e.g. EOS raced the sweep)
        dl = req["deadline"]
        if dl is None or not dl.expired():
            return False
        req["error"] = DeadlineExceeded(
            "request deadline expired during generation")
        req["done"].set()
        return True

    def _sweep_expired(self) -> None:
        """Chunk-boundary deadline sweep: an expired request frees its slot
        (and, paged, its blocks) now instead of decoding tokens its caller,
        already answered 504, will never read. Rows of its chunks still in
        flight are dropped at their fetch (`decode_dead_slot_chunks`)."""
        for i, st in enumerate(self._slots):
            if st is not None and self._expire(st["req"]):
                self._slots[i] = None
                if self._paged:
                    self._free_slot_blocks(st)

    def _emit_pending(self, slot: int, st: dict) -> None:
        """Deliver a deferred first token. Its copy was enqueued right after
        the prefill, ahead of any chunk that carries the slot, so by a
        fetch of such a chunk the wait is already over."""
        _, (tok_h, lp_h), event = st["pending"]
        st["pending"] = None
        if event is not None:
            _wait(event)
        st["last"] = int(tok_h[0])
        self._emit(slot, st, [st["last"]], [float(lp_h[0])])

    def _poll_pending_first(self) -> None:
        """Emit deferred first tokens whose host copy has landed (the
        event's query does not block): time to first token is not held to
        the next fetch, and a request done at its first token (EOS,
        max_tokens 1) frees its slot before a chunk is spent on it."""
        for slot, st in enumerate(self._slots):
            if st is None or st["pending"] is None:
                continue
            event = st["pending"][2]
            if event is not None and not event.query():
                continue
            self._emit_pending(slot, st)

    def _worth_speculating(self, active: list[int]) -> bool:
        """Gate for dispatching a chunk while others are in flight: never
        past the context end, and never when the tokens in flight (and
        pending first tokens) already cover every active row's budget.
        EOS is unknowable on the host: a retirement wastes at most
        pipeline_depth - 1 chunks, counted in decode_wasted_tokens."""
        if (max(self._slots[i]["disp"] for i in active) + self.chunk
                > self.max_len):
            return False
        for i in active:
            st = self._slots[i]
            inflight = st["disp"] - st["idx"] + (st["pending"] is not None)
            if len(st["req"]["out"]) + inflight < st["req"]["max_tokens"]:
                return True
        return False

    def _admit_waiting(self, overlap: bool) -> None:
        """Fill free slots from the queue. Paged: a request the pool cannot
        cover yet waits at the head of the line (FIFO: nothing jumps it),
        and admission resumes as retirements free blocks. With `overlap`
        (chunks in flight) the admission's work is enqueued behind them
        with no host sync, counted by `admit_overlap`. A waiter whose
        deadline has passed is dropped, never admitted."""
        for slot in range(self.n_slots):
            while self._slots[slot] is None:
                if self._kv_stash:
                    req = self._kv_stash.popleft()
                else:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        return
                if self._expire(req):  # never admitted
                    continue
                try:
                    self._admit(slot, req)
                except _NeedKVBlocks:
                    self._kv_stash.appendleft(req)
                    return
                except Exception as e:  # surface to the caller
                    req["error"] = f"{type(e).__name__}: {e}"
                    req["done"].set()
                    self._slots[slot] = None
                    continue
                if overlap:
                    with self._stats_lock:
                        self.stats["admit_overlap"] += 1

    def _dispatch_chunk(self, active: list[int],
                        carry: dict | None = None) -> dict:
        """Enqueue one decode chunk over the slot batch without fetching
        it. `carry` is the newest record still in flight: its last tokens,
        on the device, are this chunk's inputs. Rows that did not ride it (a
        mid-pipe admission's pending first token, a row whose host value is
        current after a drain) are written into that vector on the device.
        The cache-length bucket is the smallest covering every active row
        after this chunk."""
        n = self.n_slots
        last = np.zeros((n,), np.int64)
        idx = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        ks = np.zeros((n,), np.int64)
        ps = np.ones((n,), np.float32)
        for i in active:
            st = self._slots[i]
            idx[i] = st["disp"]
            temps[i] = st["req"]["temperature"]
            ks[i] = st["req"]["top_k"]
            ps[i] = st["req"]["top_p"]
            if st["pending"] is None:
                last[i] = st["last"]
        trunc = any(ks[i] > 0 or ps[i] < 1.0 for i in active)
        need = int(idx.max()) + self.chunk
        bucket = next((b for b in self.decode_buckets if b >= need),
                      self.decode_buckets[-1])
        t0 = time.monotonic()
        if carry is None:
            last_dev = self._to_device(last)
        else:  # a copy: the record's own tokens are still to be fetched
            last_dev = carry["toks"][:, -1].clone()
        for i in active:
            st = self._slots[i]
            if carry is not None and carry["parts"].get(i) is st:
                continue  # rides the carry
            # In place on the device: an element assignment from a host
            # value would be a pageable copy, which waits for the stream.
            if st["pending"] is not None:
                last_dev[i].copy_(st["pending"][0][0])
            elif carry is not None:
                last_dev[i].fill_(st["last"])
        args = [last_dev] + [self._to_device(a) for a in (idx, temps, ks, ps)]
        if self._paged:
            # Per-row block tables, padded with the NULL block, from host
            # lists fixed at admission.
            nb = bucket // self._kv_bs
            tables = np.zeros((n, nb), np.int64)
            for i in active:
                blk = self._slots[i]["blocks"][:nb]
                tables[i, :len(blk)] = blk
            args.insert(0, self._to_device(tables))
        rows = None
        if self._ml_stacks is not None:
            # Each row's adapter factors, gathered once for the chunk's
            # steps (idle rows take the base entry).
            aids = np.zeros((n,), np.int64)
            for i in active:
                aids[i] = self._slots[i]["req"]["aid"]
            rows = self._adapter_rows(aids)
        self._cache, toks, lps = self._decode[(bucket, trunc)](
            self._cache, *args, self._gen, rows)
        host, event = self._to_host(toks, lps)
        with self._stats_lock:
            self.stats["decode_dispatches"] += 1
        for i in active:
            self._slots[i]["disp"] += self.chunk
        return {"toks": toks, "host": host, "event": event, "t0": t0,
                "chunk": self.chunk,
                "parts": {i: self._slots[i] for i in active}}

    def _fetch_chunk(self, rec: dict, overlapped: bool) -> None:
        """Wait for one record's tokens (the designed host sync) and
        reconcile: a part whose slot no longer holds its request, or whose
        request finishes on its pending first token, is dead and its rows
        are dropped. `overlapped`: another chunk was in flight meanwhile."""
        t0 = time.monotonic()
        if rec["event"] is not None:
            _wait(rec["event"])
        toks, lps = (h.numpy() for h in rec["host"])
        now = time.monotonic()
        start = (rec["t0"] if self._busy_mark is None
                 else max(self._busy_mark, rec["t0"]))
        with self._stats_lock:
            self.stats["host_stall_seconds"] += now - t0
            self.stats["decode_fetch_overlapped" if overlapped
                       else "decode_fetch_blocking"] += 1
            self.stats["decode_seconds"] += now - start
        self._busy_mark = now
        for i, st in rec["parts"].items():
            if self._slots[i] is st and st["pending"] is not None:
                self._emit_pending(i, st)  # the chunk decoded from it
            if self._slots[i] is not st:
                with self._stats_lock:
                    self.stats["decode_dead_slot_chunks"] += 1
                    self.stats["decode_wasted_tokens"] += rec["chunk"]
                continue
            st["idx"] += rec["chunk"]
            st["last"] = int(toks[i, -1])
            with self._stats_lock:
                self.stats["decode_tokens"] += rec["chunk"]
            self._emit(i, st, [int(t) for t in toks[i]],
                       [float(v) for v in lps[i]])

    def _fail_all(self, err: str, inflight: deque) -> None:
        """A device call failed: fail every request in a slot or in a chunk
        in flight, free its blocks once, drop the records."""
        owners = {id(st): st for st in self._slots if st is not None}
        for rec in inflight:
            owners.update((id(st), st) for st in rec["parts"].values())
        for st in owners.values():
            if not st["req"]["done"].is_set():
                st["req"]["error"] = f"decode failed:\n{err}"
                st["req"]["done"].set()
            if self._paged:
                self._free_slot_blocks(st)
        self._slots[:] = [None] * self.n_slots
        inflight.clear()
        self.inflight_depth = 0
        self._busy_mark = None

    def _loop(self) -> None:
        """Admit, poll pending first tokens, dispatch while fewer than
        `pipeline_depth` chunks are in flight (and another one is worth
        it), fetch the oldest. At depth 1 each round dispatches one chunk
        and fetches it: the synchronous loop."""
        inflight: deque = deque()
        with torch.inference_mode():
            while not self._stop:
                try:
                    self._admit_waiting(overlap=bool(inflight))
                    self._sweep_expired()
                    self._poll_pending_first()
                    active = [i for i, s in enumerate(self._slots)
                              if s is not None]
                    if not active and not inflight:
                        self._busy_mark = None
                        self._wake.wait(0.05)
                        self._wake.clear()
                        continue
                    while (active and len(inflight) < self.pipeline_depth
                           and (not inflight
                                or self._worth_speculating(active))):
                        inflight.append(self._dispatch_chunk(
                            active, inflight[-1] if inflight else None))
                        self.inflight_depth = len(inflight)
                    if inflight:
                        rec = inflight.popleft()
                        self.inflight_depth = len(inflight)
                        self._fetch_chunk(rec, overlapped=bool(inflight))
                except Exception:  # fail the batch, keep serving
                    self._fail_all(traceback.format_exc(), inflight)


#: Bundle `generative` keys of the JAX engine's features that this package
#: does not port yet, with the value that asks for nothing. A bundle that
#: sets one to anything else is refused by name (501 at the server).
_UNPORTED = {
    "prefix_cache": ("prefix cache", 0),
    "draft": ("speculative decoding", None),
    "kv_host_tier_blocks": ("paged KV host tier", 0),
    "mesh": ("tensor-parallel mesh", None),
    "role": ("disaggregated prefill/decode roles", "unified"),
}


class GenerativeTorchModel(Model):
    """KServe-Model-shaped wrapper: load() builds the engine; generate()
    and generate_stream() are the request surface. `generation`'s
    `tokenizer` ("bytes", or an HF-style object with encode/decode) lets
    requests pass `text` and adds `text` to the output."""

    def __init__(self, name: str, model, *, generation: dict | None = None):
        super().__init__(name)
        self._model, self.cfg = model, model.cfg
        gen = dict(generation or {})
        for key, (what, off) in _UNPORTED.items():
            if gen.pop(key, off) not in (off, None, {}, []):
                raise NotImplementedError(
                    f"{what} ({key!r}) is not supported by this package yet")
        self.eos_id = gen.pop("eos_id", None)
        self.tokenizer = gen.pop("tokenizer", None)
        self._gen_cfg = gen
        self.engine: GenerationEngine | None = None
        #: {"mode", "quantized", "full"} when the weights are int8
        #: (serve/runtimes.py sets it), else None.
        self.quantization: dict | None = None

    def load(self) -> bool:
        t0 = time.monotonic()
        self.engine = GenerationEngine(self._model, **self._gen_cfg)
        self.load_time_s = time.monotonic() - t0
        self.ready = True
        return True

    def unload(self) -> None:
        self.ready = False
        if self.engine:
            self.engine.close()
            self.engine = None

    def _resolve_ids(self, payload: dict) -> list[int]:
        """The request's prompt ids: `input_ids`, or `text` through the
        tokenizer."""
        if not self.ready or self.engine is None:
            raise RuntimeError(f"model {self.name} is not loaded")
        ids = payload.get("input_ids")
        if ids is not None and (not isinstance(ids, list) or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in ids)):
            raise ValueError('"input_ids" must be a list of integers')
        return resolve_ids(self.tokenizer, payload)

    def _decode_text(self, ids: list[int]) -> str:
        return decode_ids(self.tokenizer, ids)

    def _submit_kwargs(self, payload: dict) -> dict:
        return dict(
            max_tokens=int(payload.get("max_tokens", 32)),
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            eos_id=payload.get("eos_id", self.eos_id),
            timeout=float(payload.get("timeout", 300.0)),
            adapter=payload.get("adapter"),
            # In-process only: the server puts the request's Deadline
            # under "_deadline" (and strips a wire-supplied one).
            deadline=payload.get("_deadline"))

    def generate(self, payload: dict) -> dict:
        ids = self._resolve_ids(payload)
        out = self.engine.submit(ids, **self._submit_kwargs(payload))
        if self.tokenizer is not None:
            out["text"] = self._decode_text(out["output_ids"])
        out["decode_tokens_per_sec"] = round(self.engine.throughput(), 2)
        return out

    def generate_stream(self, payload: dict):
        """Generator of streaming events: {"tokens": [...]} (plus
        "text_delta" when a tokenizer is set) per emitted chunk, then a
        final {"done": true, ...summary}: chunk-granular, the engine's
        scheduling quantum. Closing the generator leaves the request
        decoding to its end."""
        ids = self._resolve_ids(payload)
        kwargs = self._submit_kwargs(payload)
        events: queue.Queue = queue.Queue()

        def on_tokens(tokens, done):
            events.put(("tok", tokens, done))

        def run():
            try:
                events.put(("final", self.engine.submit(
                    ids, on_tokens=on_tokens, **kwargs), None))
            except Exception as e:  # surfaced to the consumer
                events.put(("error", e, None))

        threading.Thread(target=run, daemon=True,
                         name="tpk-generate-stream").start()
        emitted: list[int] = []
        # Windowed incremental detokenization (the vLLM recipe): decode
        # only from a trailing offset, emit the suffix beyond the
        # previously rendered window, and hold back while the tail is an
        # incomplete codepoint — O(window) per chunk instead of
        # re-decoding the whole prefix (quadratic in output length), and
        # deltas telescope to the exact full decode.
        prefix_off = read_off = 0
        sent_text = ""
        deadline = time.monotonic() + kwargs["timeout"] + 10.0
        while True:
            try:
                kind, val, done = events.get(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except queue.Empty:
                raise RuntimeError(
                    f"generation stream timed out after "
                    f"{kwargs['timeout']}s") from None
            if kind == "error":
                raise val
            if kind == "final":
                out = dict(val)
                if self.tokenizer is not None:
                    out["text"] = self._decode_text(out["output_ids"])
                    # Flush anything still held back by the window.
                    out["text_delta"] = (
                        out["text"][len(sent_text):]
                        if out["text"].startswith(sent_text) else "")
                out["decode_tokens_per_sec"] = round(
                    self.engine.throughput(), 2)
                yield {"done": True, **out}
                return
            if not val:
                continue
            emitted.extend(val)
            ev: dict = {"tokens": [int(t) for t in val]}
            if self.tokenizer is not None:
                prev = self._decode_text(emitted[prefix_off:read_off])
                text = self._decode_text(emitted[prefix_off:])
                # Emit ONLY when the new rendering strictly extends the
                # previous one and its tail is not a possibly-incomplete
                # codepoint (U+FFFD). Anything else — a held partial, or
                # a rewrite where a completing codepoint replaces an
                # earlier U+FFFD — stays buffered: an emitted delta can
                # never be retracted, and the final event's residue flush
                # delivers whatever was held, so deltas always join to
                # the exact full decode.
                if (len(text) > len(prev) and text.startswith(prev)
                        and not text.endswith("\ufffd")):
                    ev["text_delta"] = text[len(prev):]
                    prefix_off, read_off = read_off, len(emitted)
                else:
                    ev["text_delta"] = ""
                sent_text += ev["text_delta"]
            yield ev

    def metadata(self) -> dict:
        md = super().metadata()
        md.update({"generative": True,
                   "max_len": self._gen_cfg.get("max_len", 256),
                   "vocab_size": self.cfg.vocab_size,
                   "stats": self.engine.stats_snapshot() if self.engine else {}})
        if self.engine:
            md["decode_buckets"] = list(self.engine.decode_buckets)
            md["pipeline_depth"] = self.engine.pipeline_depth
            md["inflight_depth"] = self.engine.inflight_depth
            md["role"] = self.engine.role
            md["paged_kv"] = self.engine.kv_info()
            md["kv_quant"] = self.engine.kv_quant
            if self.engine.adapter_names():
                md["adapters"] = self.engine.adapter_names()
        if self.quantization is not None:
            md["quantize"] = dict(self.quantization)
        return md
