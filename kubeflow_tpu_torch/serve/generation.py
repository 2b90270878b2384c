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
  * `prefix_cache` (entries; 0 is off) keeps prompt prefixes at chunk
    boundaries, keyed by adapter and tokens, and an admission resumes its
    chunked prefill after the longest one strictly shorter than its
    prompt, with a continuation chunk (no flash prefill for the cached
    part). Flat, an entry is a fragment copy and a hit clones it. Paged,
    an entry holds block references: a hit maps the full blocks into the
    new table zero-copy, rebuilds the fragment from the blocks (a
    quantized pool's one full-width dequant, `kv_dequant_fallbacks`), and
    the insert forks the partial tail block into a fresh one
    (`kv_cow_copies`) while shared blocks are never rewritten. Entries
    yield their blocks to live admissions under pool pressure
    (`_kv_fits`);
  * `kv_host_tier_blocks` (paged) spills an evicted entry's blocks to host
    RAM in the KV wire format (serve/kv_transfer.py) and restores them into
    the pool on a later hit, when the restore and the admission fit
    together;
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
    engine without adapters runs exactly the base path;
  * `draft` ({"model", "gamma"}; a bundle's `generative.draft` names an HF
    checkpoint) decodes speculatively: each spec step, the draft proposes
    gamma tokens by single-token steps over its own cache (flat slots, or
    its own blocks in the target's pool) and the target verifies them in
    one continuation forward; greedy rows accept by exact match (ids equal
    vanilla decode's), plain-temperature rows by rejection sampling (the
    target's tempered marginal). Top-k/top-p rows decode in a vanilla
    sub-batch beside the spec one; each kind keeps its own chain of up to
    `pipeline_depth` records in flight, a chained spec record decoding
    from the previous one's all-accepted carry and dropped at its fetch
    when an acceptance fell short. A row that rode a vanilla chunk is
    demoted (its draft rows are stale) and re-admitted by replaying its
    history when that is worth it. The draft replays every prompt whole,
    never from the prefix cache, and proposes from base weights under
    adapters. `kv_quant` does not compose with a draft;
  * `role` (paged only) splits prefill from decode. A "prefill" engine
    takes `prefill_ship` alone: it chunk-prefills the prompt into blocks
    reserved for the prompt only, copies the committed blocks to the host
    through pinned memory, packs them with the prompt, the first token,
    the sampling parameters, the adapter's name, the caller's timeout and
    its generator state into a KV wire frame (serve/kv_transfer.py: fmt 1,
    fmt 2 with the draft's prompt blocks, fmt 3 for a quantized pool), and
    frees the blocks; it holds no slot and decodes nothing. A "decode"
    engine takes `submit_remote` alone: it checks the frame against
    itself, reserves the full decode budget as a local admission does,
    scatters the blocks in by pinned non-blocking copies (a fmt-1 frame
    into a quantized pool is encoded there as the decode writes are;
    without a draft section a draft engine replays the prompt), adopts the
    generator state and decodes from the shipped first token, never
    running a prefill chunk. A "unified" engine (the default) takes all
    three calls.

Sampling is greedy (temperature 0), temperature, top-k and top-p, per row,
with draws from the engine's own seeded `torch.Generator`, taken as work is
enqueued. The draws are not the JAX package's: only greedy output is
comparable across packages. Depth 2 may order an admission's draws
differently from depth 1 when requests overlap (as in JAX); a single
request draws the same stream at any depth. A shipment's `rng_key` is the
prefill engine's `torch.Generator.get_state()` (uint8), where JAX ships
`jax.random.key_data`: a decode engine adopts it only from a generator of
its own kind (a JAX frame's key, or a CPU engine's state on a CUDA engine,
is refused by name), and then continues the stream the unified engine
would have drawn, so a single request through the pair is token- and
logprob-identical to the unified engine on the same seed.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt2 import GPT2
from kubeflow_tpu_torch.models.llama import (adapter_rows, config_view,
                                             init_cache, rolling_window,
                                             serving_field)
from kubeflow_tpu_torch.serve.kv_transfer import (_NAMES, HostKVTier,
                                                  ShipmentError,
                                                  pack_shipment, peek_meta,
                                                  unpack_shipment)
from kubeflow_tpu_torch.serve.model import Model, check_token_ids
from kubeflow_tpu_torch.serve.paging import BlockAllocator, blocks_for
from kubeflow_tpu_torch.serve.quant import (KV_QUANT_MODES,
                                            kv_dequantize_rows,
                                            kv_quantize_rows)
from kubeflow_tpu_torch.serve.tokenizer_util import decode_ids, resolve_ids
from kubeflow_tpu_torch.utils.resilience import (Deadline, DeadlineExceeded,
                                                 metrics as res_metrics)

#: `tpk_kv_shipment_bytes` buckets: wire-payload-shaped, from 1 KiB frames
#: of tiny models to 64 MiB, as JAX's.
_SHIPMENT_BUCKETS = (1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
                     1048576.0, 4194304.0, 16777216.0, 67108864.0)

#: Engine roles: "unified" serves both phases; a "prefill" engine only
#: ships (`prefill_ship`), a "decode" engine only admits shipments
#: (`submit_remote`) and never runs a prefill chunk.
ENGINE_ROLES = ("unified", "prefill", "decode")

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


def _gather_view(pool_leaf, tables):
    """[L, NB, bs, ...] x [B, nb] -> a contiguous [L, B, nb*bs, ...] copy:
    view row j*bs + r is block tables[b, j] row r, logical position j*bs +
    r, because tables are position-ordered."""
    g = pool_leaf[:, tables]
    return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                     *g.shape[4:])


def _scatter_view(pool_leaf, view_leaf, tables):
    """Write a gathered view back to its blocks. Duplicate ids are only the
    NULL block (table pads, idle rows), which receives garbage nobody
    reads."""
    b, nb = tables.shape
    v = view_leaf.reshape(view_leaf.shape[0], b * nb, pool_leaf.shape[2],
                          *view_leaf.shape[3:])
    pool_leaf[:, tables.reshape(-1)] = v


def build_engine_fns(model, *, max_len: int, chunk: int,
                     prefill_buckets: Sequence[int], kv_block_size: int = 0,
                     kv_quant: str = "none",
                     offset_writes: bool = False) -> dict:
    """The engine's device functions as closures over `model`.

    Caches are written in place: `prefill` returns a fresh fragment,
    `extend`/`extend_mid` write into the fragment they are given, `insert`
    copies a fragment into one slot of the engine cache, and a decode
    chunk writes into the engine cache through a view of its first
    `bucket` rows.

    `kv_block_size` > 0 adds the paged functions: `make_decode_paged`
    (gather the block tables into a view, the flat chunk on it, scatter it
    back), `insert_paged` (scatter a fragment into a request's blocks,
    quantizing its rows when `kv_quant` is set), `frag_from_pool` (gather
    a prefix-cache hit's blocks back into a fragment, dequantizing a
    quantized pool's rows) and `export_blocks`/`import_blocks` (the device
    halves of the KV wire format, serve/kv_transfer.py).

    `offset_writes` (the prefix cache is on) gives the fragment its
    one-bucket headroom even where no prompt chunks: a hit resumes
    `extend` at a nonzero offset with a bucket-wide write.

    Every function that runs the model takes an optional trailing
    `adapter`, each row's multi-LoRA factors (`models.llama.AdapterRows`);
    None runs the base model exactly as without adapters. `frag_len` is
    the rows a fragment is asked for.

    A sliding-window model past its window (`rolling_window(cfg, max_len)`
    > 0) has every cache in the rolling layout of `window` rows
    (models/llama.py init_cache): prefill and the final continuation
    chunk pass explicit positions whose pad tail is the sentinel
    -(window+1), which keeps pad rows out of the modular writes and of
    attention; intermediate chunks are always full; decode passes the raw
    absolute index over the whole window (the model wraps it). Within its
    window such a model is served through its causal view
    (GenerationEngine builds it), and is refused here. An alternating
    model (Gemma-2/3: a `sliding_pattern` other than "all") never rolls:
    past its window it keeps the full-length cache and its mask, and its
    sliding layers band their reads."""
    cfg = model.cfg
    dev = model.device
    big = max(prefill_buckets)
    window = rolling_window(cfg, max_len)
    rolling = window > 0
    if rolling and kv_block_size > 0:
        raise ValueError("paged KV does not compose with the rolling cache")
    if (serving_field(cfg, "mask_kind") == "sliding_window" and not rolling
            and serving_field(cfg, "sliding_pattern") == "all"):
        # Its fragments (max_len plus headroom rows) could roll while the
        # slots do not: serve the causal view, whose band never clips.
        raise ValueError(
            f"a sliding-window model (window {cfg.mask_window}) that does "
            f"not roll at max_len {max_len} is served through its causal "
            "view")
    sentinel = -(window + 1)
    # Fragment headroom of one largest bucket when a prompt may chunk or a
    # prefix-cache hit may resume mid-prompt: a continuation chunk writes a
    # whole bucket at a nonzero offset, and its padding may reach past
    # max_len. Pad rows land in the headroom and are dropped at insert.
    frag_len = max_len + (big if big < max_len - 1 or offset_writes else 0)

    def _last(hidden, length, temperature, top_k, top_p, gen):
        """Sample from the logits of the last real token only: the other
        rows of the bucket are never unembedded."""
        last = model.unembed(hidden[:, length - 1])
        tok = sample_tokens(last, temperature, gen, top_k, top_p)
        return tok, _chosen_logprob(last, tok)

    def _chunk_positions(index, length, width):
        """A right-padded chunk's absolute positions [1, width] from
        `index`, its pad tail (from `length` on) at the sentinel: rolling
        mode only."""
        ar = torch.arange(width, device=dev)
        return torch.where(ar < length, index + ar, sentinel)[None]

    def prefill(tokens, length, temperature, top_k, top_p, gen,
                adapter=None):
        """tokens [1, bucket] right-padded, `length` real tokens; returns
        (fragment cache, first sampled token [1], its logprob [1])."""
        frag = init_cache(cfg, 1, frag_len, device=dev)
        positions = (_chunk_positions(0, length, tokens.shape[1]) if rolling
                     else None)
        hidden, frag = model(tokens, positions=positions, cache=frag,
                             cache_index=torch.zeros(1, dtype=torch.int32,
                                                     device=dev),
                             return_hidden=True, adapter=adapter)
        return (frag,) + _last(hidden, length, temperature, top_k, top_p, gen)

    def _continue(frag, tokens, index, return_hidden, adapter, length=None):
        if rolling and length is not None:
            positions = _chunk_positions(index, length, tokens.shape[1])
        else:
            positions = (index
                         + torch.arange(tokens.shape[1], device=dev))[None]
        cache_index = torch.full((1,), index, dtype=torch.int32, device=dev)
        return model(tokens, positions=positions, cache=frag,
                     cache_index=cache_index, attend_full_cache=True,
                     return_hidden=return_hidden, adapter=adapter)

    def extend(frag, tokens, length, index, temperature, top_k, top_p, gen,
               adapter=None):
        """Final continuation chunk of a long prompt, written at offset
        `index` and attending over the whole fragment; samples like
        prefill."""
        hidden, frag = _continue(frag, tokens, index, True, adapter, length)
        return (frag,) + _last(hidden, length, temperature, top_k, top_p, gen)

    def extend_mid(frag, tokens, index, adapter=None):
        """Intermediate continuation chunk: cache write and attention only
        (no unembedding — its sampled token would be discarded)."""
        _continue(frag, tokens, index, True, adapter)
        return frag

    def insert(cache, frag, slot):
        """Copy every leaf of a fragment (batch 1) into slot `slot`,
        dropping its headroom rows past max_len. A rolling cache's "pos"
        plane goes with K and V: the slot's next occupant must not read the
        last one's positions as live rows."""
        for name, leaf in cache.items():
            leaf[:, slot] = frag[name][:, 0, :leaf.shape[2]]
        return cache

    def make_decode(truncate: bool, bucket: int):
        def decode_chunk(cache, last_tok, index, temperature, top_k, top_p,
                         gen, adapter=None):
            """`chunk` decode steps; last_tok/index/temperature [B].
            Attention runs over the first `bucket` cache rows only (a
            rolling cache's one bucket is the window, at the raw index).
            Returns (cache, tokens [B, chunk], logprobs [B, chunk]). Only
            the truncating variant pays the full-vocab sort of
            top-k/top-p."""
            view = {n: c[:, :, :bucket] for n, c in cache.items()}
            tok, idx = last_tok, index
            toks, lps = [], []
            for _ in range(chunk):
                logits, _ = model(tok[:, None], cache=view,
                                  cache_index=(idx if rolling else
                                               idx.clamp_max(bucket - 1)),
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
           "insert": insert, "make_decode": make_decode,
           "frag_len": frag_len}
    if kv_block_size <= 0:
        return fns
    bs = int(kv_block_size)

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
        layer. Entries of shared prefix blocks are masked to the NULL block
        0: their committed rows stay untouched (a quantized pool's would be
        re-encoded from dequantized rows), and the fragment's rows for them
        land in the garbage block. A freshly forked tail block receives its
        committed rows from the fragment: that write is the copy-on-write
        copy. A quantized pool gets the rows' codes and scales, by the same
        encode as the model's decode writes."""
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

    def frag_from_pool(pool, table):
        """A fragment cache [L, 1, frag_len, ...] rebuilt from the blocks
        `table` [n] (a prefix-cache hit's, its partial tail included): the
        admission-side gather that lets chunked prefill resume after a hit.
        Rows past the gathered blocks are zeros, and rows past the stored
        prefix hold whatever the blocks hold; each is overwritten before
        any query position can attend it. A quantized pool's codes and
        scales are dequantized here, layer by layer: the one full-width
        dequant of the quantized design (the engine counts each in
        `kv_dequant_fallbacks`)."""
        frag = init_cache(cfg, 1, frag_len, device=dev)
        n = table.numel()
        for layer in range(cfg.num_layers):
            for name in ("k", "v"):
                g = pool[name][layer, table]
                if kv_quant != "none":
                    g = kv_dequantize_rows(g, pool[name + "s"][layer, table],
                                           cfg.dtype)
                frag[name][layer, 0, :n * bs] = g.reshape(n * bs,
                                                          *g.shape[2:])
        return frag

    def export_blocks(pool, table):
        """The blocks `table` [n] of every pool leaf, gathered off the pool
        ({name: [L, n, bs, ...]}): the device half of the KV wire format.
        Committed rows come back exactly as the pool holds them, so pool ->
        wire -> pool round-trips byte-identically."""
        return {name: p[:, table] for name, p in pool.items()}

    def import_blocks(pool, blocks, table):
        """Scatter shipped blocks ({name: [L, n, bs, ...]}) into the pool
        at `table` [n]: the host-to-device half."""
        for name, p in pool.items():
            p[:, table] = blocks[name].to(p.dtype)
        return pool

    fns.update(make_decode_paged=make_decode_paged, insert_paged=insert_paged,
               frag_from_pool=frag_from_pool, export_blocks=export_blocks,
               import_blocks=import_blocks)
    return fns


def spec_acceptance(drafts, dlogits, tlogits, temperature, generator):
    """Per-row speculative acceptance: greedy rows (temperature <= 0) by
    exact match with the target's argmax, sampled rows by the rejection
    scheme (Leviathan et al., Chen et al.): a proposal d_j ~ p_d (the
    draft's tempered softmax) is accepted with probability min(1,
    p_t(d_j) / p_d(d_j)); the first rejection emits a draw from
    normalize(max(p_t - p_d, 0)), and full acceptance a bonus draw from
    p_t at position gamma. The emitted marginal at every position is the
    target's tempered distribution, whatever the draft.

    drafts [B, gamma] int64, dlogits [B, gamma, V], tlogits [B, gamma+1,
    V], temperature [B]. The uniforms and the residual draw (the
    exponential race `sample_tokens` uses) come from `generator`; nothing
    here syncs the host. Returns (out [B, gamma+1]: the accepted proposals,
    then the correction or bonus, then zeros; k [B] accepted counts; the
    next input token [B])."""
    b, gamma = drafts.shape
    dev = tlogits.device
    sampled = temperature > 0
    safe_t = temperature.clamp_min(1e-4)[:, None, None]
    tprobs = torch.softmax(tlogits.float() / safe_t, dim=-1)
    dprobs = torch.softmax(dlogits.float() / safe_t, dim=-1)
    tgreedy = tlogits.argmax(dim=-1)                       # [B, gamma+1]
    pt_d = tprobs[:, :gamma].gather(-1, drafts[..., None])[..., 0]
    pd_d = dprobs.gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((b, gamma), generator=generator, device=dev)
    accept = torch.where(sampled[:, None], u < pt_d / pd_d.clamp_min(1e-30),
                         drafts == tgreedy[:, :gamma])
    k = accept.long().cumprod(dim=1).sum(dim=1)
    # The residual at the first rejection; on full acceptance p_d is 0 at
    # position gamma, so the "residual" there is p_t itself.
    v = tprobs.shape[-1]
    at_k = k[:, None, None].expand(b, 1, v)
    pt_k = tprobs.gather(1, at_k)[:, 0]
    pd_k = torch.cat([dprobs, torch.zeros_like(dprobs[:, :1])],
                     dim=1).gather(1, at_k)[:, 0]
    resid = (pt_k - pd_k).clamp_min(0.0)
    # Identical distributions leave no residual mass: draw from p_t.
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-30, resid, pt_k)
    race = torch.empty_like(resid).exponential_(1.0, generator=generator)
    corr = torch.where(sampled, (resid / race).argmax(dim=-1),
                       tgreedy.gather(1, k[:, None])[:, 0])
    j = torch.arange(gamma + 1, device=dev)[None]
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = torch.where(j < k[:, None], padded,
                      torch.where(j == k[:, None], corr[:, None], 0))
    return out, k, corr


def build_spec_decode(model, draft, *, gamma: int, n_spec: int,
                      kv_block_size: int = 0):
    """Speculative decode chunks: per spec step the `draft` model proposes
    `gamma` tokens autoregressively (single-token decode steps over its own
    cache), then the target scores all gamma+1 positions in one
    continuation forward (explicit positions, `attend_full_cache`), which
    writes the candidate rows before attending: rejected rows are
    overwritten by the next step's write at the rewound index. Acceptance
    is `spec_acceptance`; each step emits k accepted tokens and one
    correction or bonus. `n_spec` steps ride one dispatch (worst case
    n_spec * (gamma+1) tokens a row; the caller sizes the bucket for it).

    make(bucket) -> spec_chunk(cache, dcache, last_tok, index, temperature,
    gen, adapter=None) -> (cache, dcache, tokens [B, n_spec, gamma+1],
    logprobs [B, n_spec, gamma+1], accepted [B, n_spec]); both caches are
    written in place through views of their first `bucket` rows. `adapter`
    (each row's multi-LoRA factors) applies to the target's verify only:
    the draft proposes from its base weights, which can cost acceptance,
    never correctness, since every emitted token comes from the target's
    logits.

    `kv_block_size` > 0: make(bucket) returns spec_chunk(pool, dpool,
    tables, dtables, last_tok, index, temperature, gen, adapter=None),
    which gathers each row's blocks of the target and draft pools into
    views, runs the flat chunk on them and scatters both back; the draft
    pool shares the target's block-id space, its tables per slot.

    A rolling target cache (its "pos" plane, models/llama.py init_cache:
    window rows, modular writes) beside the draft's causal one: neither is
    sliced, the target takes the raw index and the draft's index is capped
    by its cache's rows. The verify writes all gamma+1 candidate rows, and
    in a rolling cache a rejected candidate's row has evicted a live one:
    each step saves the gamma+1 target rows of every leaf before the
    verify and writes back the old rows past the accepted count after it,
    so the cache holds exactly the committed stream. A target with a
    sliding window on every layer here is a rolling one (the engine serves
    one within its window through its causal view), and the paged pool
    does not take it; an alternating target past its window keeps a
    full-length cache and pages like a causal one."""
    if (kv_block_size > 0
            and serving_field(model.cfg, "mask_kind") == "sliding_window"
            and serving_field(model.cfg, "sliding_pattern") == "all"):
        raise ValueError(
            "paged spec decode does not compose with the rolling cache")

    def make(bucket: int):
        def spec_chunk(cache, dcache, last_tok, index, temperature, gen,
                       adapter=None):
            rolling = "pos" in cache
            if rolling:
                view, dview = cache, dcache
                window, dcap = cache["k"].shape[2], dcache["k"].shape[2]
                batch = torch.arange(index.shape[0],
                                     device=index.device)[:, None]
            else:
                view = {n: c[:, :, :bucket] for n, c in cache.items()}
                dview = {n: c[:, :, :bucket] for n, c in dcache.items()}
                dcap = bucket
            steps = torch.arange(gamma + 1, device=index.device)
            tok, idx = last_tok, index
            outs, lps, ks = [], [], []
            for _ in range(n_spec):
                t, i = tok, idx
                drafts, dlogits = [], []
                for _ in range(gamma):
                    logits, _ = draft(t[:, None], cache=dview,
                                      cache_index=i.clamp_max(dcap - 1))
                    row = logits[:, 0]
                    t = sample_tokens(row, temperature, gen)
                    drafts.append(t)
                    dlogits.append(row)
                    i = i + 1
                # One more draft step for gamma proposals: each step caches
                # its input, so without it the last proposal's K/V row
                # would stay stale after a fully accepted step and every
                # later proposal would attend it. Its output is not read.
                draft(t[:, None], cache=dview,
                      cache_index=i.clamp_max(dcap - 1), return_hidden=True)
                drafts = torch.stack(drafts, dim=1)
                if rolling:
                    rows = (idx.to(torch.long)[:, None] + steps) % window
                    saved = {n: c[:, batch, rows] for n, c in view.items()}
                tlogits, _ = model(
                    torch.cat([tok[:, None], drafts], dim=1),
                    positions=idx[:, None] + steps, cache=view,
                    cache_index=(idx if rolling
                                 else idx.clamp_max(bucket - 1)),
                    attend_full_cache=True, adapter=adapter)
                out, k, tok = spec_acceptance(
                    drafts, torch.stack(dlogits, dim=1), tlogits,
                    temperature, gen)
                if rolling:
                    # Candidate j <= k is committed (the input token and
                    # the accepted proposals); the rest is rolled back.
                    keep = steps[None] <= k[:, None]
                    for n, c in view.items():
                        sel = keep.view(1, *keep.shape,
                                        *([1] * (c.dim() - 3)))
                        c[:, batch, rows] = torch.where(
                            sel, c[:, batch, rows], saved[n])
                outs.append(out)
                lps.append(_chosen_logprob(tlogits, out))
                ks.append(k)
                idx = idx + k + 1
            return (cache, dcache, torch.stack(outs, dim=1),
                    torch.stack(lps, dim=1), torch.stack(ks, dim=1))
        if kv_block_size <= 0:
            return spec_chunk

        def spec_chunk_paged(pool, dpool, tables, dtables, last_tok, index,
                             temperature, gen, adapter=None):
            view = {n: _gather_view(p, tables) for n, p in pool.items()}
            dview = {n: _gather_view(p, dtables) for n, p in dpool.items()}
            _, _, toks, lps, acc = spec_chunk(view, dview, last_tok, index,
                                              temperature, gen, adapter)
            for n, p in pool.items():
                _scatter_view(p, view[n], tables)
            for n, p in dpool.items():
                _scatter_view(p, dview[n], dtables)
            return pool, dpool, toks, lps, acc
        return spec_chunk_paged
    return make


def _causal_config(cfg):
    """A sliding-window config served within its window, as causal: the
    band never clips there, so causal attention is exact."""
    return dataclasses.replace(cfg, mask_kind="causal", mask_window=0,
                               attention_impl="auto")


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
    one of them.

    `prefix_cache` > 0 keeps that many prompt prefixes, keyed by adapter
    and tokens, at prompt-chunk boundaries: flat, as fragment copies;
    paged, as block references (a hit maps the full blocks zero-copy and
    forks the partial tail). `kv_host_tier_blocks` > 0 (paged only) spills
    evicted prefixes to host RAM through the KV wire format and restores
    them on a hit.

    `draft` ({"model": a causal Llama of the target's vocabulary, "gamma":
    proposals a spec step, default 4}) decodes greedy and plain-temperature
    requests speculatively, `max(1, chunk // (gamma + 1))` spec steps a
    dispatch.

    `role` (one of ENGINE_ROLES, paged only; rendered as the
    `tpk_engine_role` gauge) restricts the engine to one phase: "prefill"
    takes only `prefill_ship`, "decode" only `submit_remote`."""

    def __init__(self, model, *, slots: int = 4, max_len: int = 256,
                 chunk: int = 16, prefill_buckets: Sequence[int] = (32, 128),
                 decode_buckets: Sequence[int] | None = None, seed: int = 0,
                 pipeline_depth: int = 2, kv_block_size: int = 0,
                 kv_blocks: int = 0, kv_quant: str = "none",
                 adapters: dict | None = None, prefix_cache: int = 0,
                 kv_host_tier_blocks: int = 0, draft: dict | None = None,
                 role: str = "unified"):
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.device = model.device
        self.max_len, self.chunk = int(max_len), int(chunk)
        self.n_slots = int(slots)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's position "
                f"range (max_seq_len={cfg.max_seq_len})")
        #: The rolling cache's window when a sliding-window model is served
        #: past it, else 0.
        self._rolling = rolling_window(cfg, self.max_len)
        mask_kind = serving_field(cfg, "mask_kind")
        if mask_kind == "sliding_window":
            if int(cfg.mask_window) < 1:
                raise ValueError(
                    "sliding-window checkpoint with window=0 cannot be "
                    "served")
            # Alternating sliding/full layers (Gemma-2/3) past the window
            # keep the mask and the full-length cache: the full layers
            # need all history, so nothing rolls, and the sliding layers
            # band their reads (models/llama.py, the decode branch).
            if self.max_len <= int(cfg.mask_window):
                # Within the window the band never clips: serve a causal
                # view of the model (its weights shared), which takes the
                # causal paths (flash prefill, bucketed decode).
                cfg = _causal_config(cfg)
                self.model = config_view(model, cfg)
                self.cfg = cfg
        elif mask_kind != "causal":
            raise ValueError(f"generative serving needs a causal model; got "
                             f"mask_kind={mask_kind!r}")
        if isinstance(model, GPT2) and str(kv_quant or "none") != "none":
            # The JAX engine's decode scan fails on a GPT-2 over a
            # quantized pool; refused here, up front. (Its multi-LoRA
            # `adapters` are refused by the PEFT import, as in JAX.)
            raise ValueError(
                f"kv_quant={kv_quant!r} does not compose with GPT-2 (its "
                "cache has no quantized path); set kv_quant='none'")
        if int(pipeline_depth) < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        #: Decode chunks in flight right now (read by metadata).
        self.inflight_depth = 0
        # A rolling cache clamps prompt buckets to the window: a wider
        # chunk would wrap onto its own rows.
        cap = min(self.max_len, self._rolling or self.max_len)
        self.prefill_buckets = sorted(
            {min(int(b), cap) for b in prefill_buckets})
        # Length-aware decode: attention cost tracks the longest active
        # sequence, not max_len. Default buckets: powers of two from
        # max(64, 2*chunk) up to max_len. A rolling cache has one bucket,
        # the window: its rows are not position-ordered, so no prefix of
        # them can stand for the live ones.
        if self._rolling:
            self.decode_buckets = [self._rolling]
        else:
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
        if role not in ENGINE_ROLES:
            raise ValueError(f"role {role!r}: must be one of {ENGINE_ROLES}")
        if role != "unified" and not self._paged:
            raise ValueError(
                f"role={role!r} needs the paged KV cache (KV blocks are "
                "the prefill→decode wire unit); set kv_block_size > 0")
        self.role = role
        if self._paged:
            if self._rolling:
                raise ValueError(
                    "kv_block_size > 0 does not compose with rolling "
                    "sliding-window serving (rolling rows are not "
                    "prefix-ordered, so block tables cannot address "
                    "them); set kv_block_size=0")
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
        if int(kv_host_tier_blocks) and not self._paged:
            raise ValueError(
                "kv_host_tier_blocks > 0 needs the paged KV cache (the "
                "host tier spills whole blocks); set kv_block_size > 0")
        self._host_tier = (HostKVTier(int(kv_host_tier_blocks))
                           if self._paged and int(kv_host_tier_blocks)
                           else None)
        self._spec = self._check_draft(draft) if draft is not None else None
        # Prefix cache: an LRU of prompt-chunk-boundary prefixes keyed
        # (aid, prefix_len, hash(tokens)); each value is (token tuple,
        # fragment) flat or (token tuple, block ids) paged. The tuple
        # verifies the hash; the per-adapter length index {aid: {len:
        # count}} lets a lookup probe by length. Capacity in entries; 0 is
        # off.
        self._prefix_cap = int(prefix_cache)
        self._prefix_lru: OrderedDict = OrderedDict()
        self._prefix_lens: dict[int, dict[int, int]] = {}
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
        fns = build_engine_fns(self.model, max_len=self.max_len,
                               chunk=self.chunk,
                               prefill_buckets=self.prefill_buckets,
                               kv_block_size=self._kv_bs,
                               kv_quant=self.kv_quant,
                               offset_writes=self._prefix_cap > 0)
        self._fns = fns
        make = fns["make_decode_paged" if self._paged else "make_decode"]
        self._decode = {(b, trunc): make(trunc, b)
                        for b in self.decode_buckets for trunc in (False, True)}
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        #: The shape of this generator's state: a shipment's `rng_key` of
        #: another shape is another kind of generator's.
        self._gen_state_shape = tuple(self._gen.get_state().shape)
        # The pool: kv_blocks usable blocks + NULL block 0; or the slots.
        dims = ((self._kv_alloc.n_blocks + 1, self._kv_bs) if self._paged
                else (self.n_slots, self.max_len))
        self._cache = init_cache(cfg, *dims, kv_quant=self.kv_quant,
                                 device=self.device)
        if self._spec is not None:
            # The draft replays prompts by continuation chunks into its own
            # fragment (no sampling) and lands them in its cache: a slot of
            # its own flat, its own blocks of the target's id space paged.
            spec = self._spec
            self._dfns = build_engine_fns(
                spec["model"], max_len=self.max_len, chunk=self.chunk,
                prefill_buckets=self.prefill_buckets,
                kv_block_size=self._kv_bs, offset_writes=True)
            self._dcache = init_cache(spec["cfg"], *dims, device=self.device)
            spec_make = build_spec_decode(
                self.model, spec["model"], gamma=spec["gamma"],
                n_spec=spec["n_spec"], kv_block_size=self._kv_bs)
            self._spec_decode = {b: spec_make(b) for b in self.decode_buckets}
        self._queue: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._stats_lock = threading.Lock()
        # decode_seconds is the union of the intervals in which some chunk
        # was in flight, so throughput() does not count overlap twice.
        # host_stall_seconds: time blocked in the fetch's wait. The
        # prefix-cache and host-tier keys are the JAX engine's, 0 while
        # their features are off.
        self.stats = {"requests": 0, "prompt_tokens": 0, "decode_tokens": 0,
                      "decode_seconds": 0.0, "decode_dispatches": 0,
                      "prefill_chunks": 0, "decode_fetch_overlapped": 0,
                      "decode_fetch_blocking": 0, "admit_overlap": 0,
                      "decode_dead_slot_chunks": 0, "decode_wasted_tokens": 0,
                      "host_stall_seconds": 0.0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefix_misses": 0,
                      "prefix_stores": 0, "kv_cow_copies": 0,
                      "prefix_zero_copy_hits": 0, "kv_spilled_blocks": 0,
                      "kv_restored_blocks": 0, "kv_dequant_fallbacks": 0,
                      "spec_dispatches": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_demotions": 0,
                      "spec_readmissions": 0, "spec_stale_rides": 0,
                      "remote_admits": 0, "kv_blocks_shipped": 0,
                      "kv_blocks_received": 0, "kv_shipment_bytes": 0}
        self._busy_mark: float | None = None
        self._slots: list[dict | None] = [None] * self.n_slots
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="generate-engine")
        self._thread.start()

    def _check_draft(self, draft: dict) -> dict:
        """The speculative-decoding state of `draft` ({"model", "gamma"?}),
        refused with the JAX engine's messages where it cannot serve: a
        quantized pool, a draft that is not causal (a sliding window within
        max_len is served through a causal view, as the band never clips),
        another vocabulary, a position range short of max_len, gamma < 1,
        or more candidate rows a step than a rolling window holds."""
        if self.kv_quant != "none":
            raise ValueError(
                "kv_quant does not compose with speculative decoding "
                "(draft): a rejection rewind would re-quantize committed "
                "rows; drop the draft or set kv_quant='none'")
        dmodel = draft["model"]
        dcfg = dmodel.cfg
        dmask = serving_field(dcfg, "mask_kind")
        if dmask == "sliding_window":
            if self.max_len > dcfg.mask_window:
                raise ValueError(
                    f"sliding-window draft (window={dcfg.mask_window}): "
                    f"serving max_len={self.max_len} exceeds the window; "
                    "set max_len <= window or use a causal draft")
            dcfg = _causal_config(dcfg)
            dmodel = config_view(dmodel, dcfg)
        elif dmask != "causal":
            raise ValueError(
                f"speculative decoding needs a causal-class draft; got "
                f"mask_kind={dmask!r}")
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size} — speculative acceptance compares "
                "token ids, so the vocabularies must be identical")
        if self.max_len > dcfg.max_seq_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the draft model's position "
                f"range (max_seq_len={dcfg.max_seq_len})")
        gamma = int(draft.get("gamma", 4))
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if self._rolling and gamma + 1 > self._rolling:
            raise ValueError(
                f"gamma={gamma} writes {gamma + 1} candidate rows per "
                f"spec step, more than the rolling window "
                f"({self._rolling}) holds")
        # Spec steps a dispatch: the vanilla chunk's best-case tokens.
        return {"model": dmodel, "cfg": dcfg, "gamma": gamma,
                "n_spec": max(1, self.chunk // (gamma + 1))}

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
        if self.role != "unified":
            raise RuntimeError(
                f"{self.role}-role engine refuses a local generate: "
                "prefill engines take prefill_ship(), decode engines "
                "take submit_remote()")
        ids = self._check_request(input_ids, max_tokens, top_k, top_p)
        req = {"input_ids": ids, "max_tokens": int(max_tokens),
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "aid": self._resolve_adapter(adapter),
               "eos_id": eos_id, "cb": on_tokens}
        if self._paged:
            self._check_fits(req, f"request needs {{}} KV blocks worst-case "
                                  f"(prompt {len(ids)} + max_tokens "
                                  f"{int(max_tokens)})")
        return self._run(req, timeout, deadline, "generation")

    def _check_fits(self, req: dict, what: str) -> None:
        """KVCapacityExceeded (permanent: even an empty pool cannot cover
        it) when the request's reservation, a spec-able one's draft blocks
        with it, exceeds the pool; `what` says so with a {} for the
        blocks."""
        need = self._reserve_blocks(req) + self._draft_need_blocks(req)
        if need > self._kv_alloc.n_blocks:
            raise KVCapacityExceeded(f"{what.format(need)} but the pool "
                                     f"has {self._kv_alloc.n_blocks}")

    def _check_request(self, input_ids, max_tokens, top_k, top_p) -> list:
        """The prompt as ints, after the checks every admission path
        shares (an out-of-range id would be a device-side assert on
        CUDA)."""
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
        return ids

    def _run(self, req: dict, timeout: float, deadline, what: str) -> dict:
        """Queue `req` for the worker and wait for it: until the worker
        sets it done, `timeout` seconds, or the deadline (the caller's 504
        does not wait for the next chunk boundary, where the worker frees
        the slot). A ship-mode request returns its result; any other its
        output."""
        req.update(out=[], out_logprobs=[], done=threading.Event(),
                   error=None, deadline=deadline, t0=time.monotonic())
        self._queue.put(req)
        self._wake.set()
        wait_s = timeout if deadline is None else deadline.bound(timeout)
        if not req["done"].wait(wait_s):
            if deadline is not None and deadline.expired():
                req["error"] = DeadlineExceeded(
                    f"request deadline expired during {what}")
            else:
                req["error"] = f"{what} timed out after {timeout}s"
        if isinstance(req["error"], BaseException):
            raise req["error"]
        if req["error"]:
            raise RuntimeError(req["error"])
        if req.get("mode") == "ship":
            return dict(req["result"],
                        latency_s=time.monotonic() - req["t0"])
        return {"output_ids": req["out"],
                "output_logprobs": req["out_logprobs"],
                "num_input_tokens": len(req["input_ids"]),
                "num_output_tokens": len(req["out"]),
                "latency_s": time.monotonic() - req["t0"]}

    def prefill_ship(self, input_ids: Sequence[int], *, max_tokens: int = 32,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, eos_id: int | None = None,
                     timeout: float = 300.0, adapter: str | None = None,
                     deadline: Deadline | None = None,
                     extra: dict | None = None) -> dict:
        """Chunk-prefill a prompt into pool blocks and return them as a
        KV shipment instead of decoding it: the committed blocks, the
        prompt, the first token and its logprob, the sampling parameters,
        the adapter's name, `timeout` (the decode side's wait) and this
        engine's generator state after the prefill, packed by
        serve/kv_transfer.py (`extra` rides the meta verbatim). The blocks
        return to the pool as soon as the frame is packed. Returns
        {"shipment": bytes, "num_input_tokens", "first_token",
        "kv_blocks", "latency_s"}."""
        if self.role == "decode":
            raise RuntimeError(
                "decode-role engine refuses prefill work (zero prefill "
                "chunks is the disaggregation invariant)")
        if not self._paged:
            raise RuntimeError(
                "prefill_ship needs the paged KV cache (KV blocks are "
                "the wire unit); set kv_block_size > 0")
        ids = self._check_request(input_ids, max_tokens, top_k, top_p)
        req = {"mode": "ship", "input_ids": ids,
               "max_tokens": int(max_tokens),
               "temperature": float(temperature), "top_k": int(top_k),
               "top_p": float(top_p), "aid": self._resolve_adapter(adapter),
               "adapter": adapter, "eos_id": eos_id,
               "timeout": float(timeout), "extra": dict(extra or {}),
               "cb": None}
        # Prompt blocks only (a spec-able request's draft ones with them).
        self._check_fits(req, "prompt needs {} KV blocks")
        return self._run(req, timeout, deadline, "prefill")

    def submit_remote(self, shipment, *, timeout: float | None = None,
                      deadline: Deadline | None = None,
                      on_tokens=None) -> dict:
        """Admit a shipped prefill (`prefill_ship`'s bytes) straight into
        decode; blocks like `submit`. The frame is checked against this
        engine (format, kv_quant, draft section, block size, vocabulary,
        prompt length, block shapes, generator kind) and its worst case
        against the pool (KVCapacityExceeded if it can never fit); the
        worker then reserves the full decode budget as a local admission
        does (waiting head of line while the pool is short), scatters the
        blocks in, adopts the shipped generator state and emits the
        shipped first token. It never runs a prefill chunk. The sampling
        parameters and, when `timeout` is None, the wait come from the
        frame."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role engine refuses decode work; route "
                "shipments to a decode or unified replica")
        if not self._paged:
            raise RuntimeError(
                "submit_remote needs the paged KV cache; set "
                "kv_block_size > 0")
        meta, arrays = unpack_shipment(shipment)
        fmt = int(meta.get("fmt", 0))
        self._check_frame(meta, fmt)
        ids = [int(t) for t in meta["tokens"]]
        if not ids or len(ids) > self.max_len - 1:
            raise ShipmentError(
                f"shipped prompt of {len(ids)} tokens does not fit "
                f"max_len {self.max_len}")
        first = int(meta["first_token"])
        bad = [t for t in ids + [first] if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ShipmentError(f"shipped token ids outside [0, "
                                f"{self.cfg.vocab_size}): {bad[:8]}")
        n_blocks = blocks_for(len(ids), self._kv_bs)
        quantized = self.kv_quant != "none"
        # A fmt-1 frame into a quantized pool ships k and v only: the
        # worker encodes them at import.
        names = (("k", "v", "ks", "vs") if quantized and fmt == 3
                 else ("k", "v"))
        blocks = {}
        for name in names:
            arr = arrays.get(name)
            if arr is None:
                raise ShipmentError(f"shipment missing {name!r} blocks")
            ref = self._cache[name].shape  # scale planes drop the D axis
            want = (ref[0], n_blocks, *ref[2:])
            if tuple(arr.shape) != want:
                raise ShipmentError(
                    f"shipment {name} blocks shaped {tuple(arr.shape)}, "
                    f"this engine needs {want}")
            blocks[name] = arr
        draft_blocks, dn_blocks = None, 0
        if fmt == 2:
            draft_blocks, dn_blocks = self._draft_section(meta, arrays)
        key = arrays.get("rng_key")
        if key is not None and (key.dtype != torch.uint8 or tuple(
                key.shape) != self._gen_state_shape):
            raise ShipmentError(
                f"shipment rng_key ({_NAMES.get(key.dtype, key.dtype)} "
                f"{list(key.shape)}) is not the state of this engine's "
                f"{self.device.type} torch.Generator (uint8 "
                f"{list(self._gen_state_shape)}): pair replicas of one "
                "package on one kind of device")
        if timeout is None:
            timeout = float(meta.get("timeout", 300.0))
        req = {"mode": "remote", "input_ids": ids,
               "max_tokens": int(meta.get("max_tokens", 32)),
               "temperature": float(meta.get("temperature", 0.0)),
               "top_k": int(meta.get("top_k", 0)),
               "top_p": float(meta.get("top_p", 1.0)),
               "aid": self._resolve_adapter(meta.get("adapter")),
               "eos_id": meta.get("eos_id"), "first_tok": first,
               "first_lp": float(meta["first_logprob"]),
               "kv_blocks": blocks, "n_blocks": n_blocks,
               "draft_blocks": draft_blocks, "dn_blocks": dn_blocks,
               "rng_key": key, "cb": on_tokens}
        self._check_fits(req, "shipped request needs {} KV blocks "
                              "worst-case")
        return self._run(req, timeout, deadline, "generation")

    def _check_frame(self, meta: dict, fmt: int) -> None:
        """Refuse, by name, a frame this engine cannot decode: an unknown
        format, a meta without the prompt or the first token, quantized
        blocks of another (or no) kv_quant, a draft section without a
        draft, another block size or vocabulary."""
        if fmt not in (1, 2, 3):
            raise ShipmentError(f"unknown shipment fmt {meta.get('fmt')!r}")
        missing = [k for k in ("tokens", "first_token", "first_logprob")
                   if k not in meta]
        if missing:
            raise ShipmentError(f"shipment meta lacks {missing}")
        if fmt == 3 and self.kv_quant == "none":
            # Never a silent dequant-upcast: the stream's numerics would
            # depend on which replica prefilled it.
            raise ShipmentError(
                f"shipment fmt 3 carries {meta.get('kv_quant')!r}-"
                "quantized KV blocks but this engine runs "
                "kv_quant='none'; pair quantized prefill replicas with "
                "decode replicas running the same kv_quant (or drop "
                "generative.kv_quant fleet-wide)")
        if fmt == 3 and str(meta.get("kv_quant")) != self.kv_quant:
            raise ShipmentError(
                f"shipment kv_quant {meta.get('kv_quant')!r} != this "
                f"engine's {self.kv_quant!r} — mixed-precision fleets "
                "cannot exchange KV blocks (align generative.kv_quant)")
        if fmt == 2 and self._spec is None:
            # Refused, never dropped: the decode side would re-pay the
            # replay the shipment exists to avoid.
            raise ShipmentError(
                "shipment fmt 2 carries a draft-KV section but this "
                "engine has no draft model; pair draft-carrying "
                "prefill replicas with draft-configured decode "
                "replicas (or drop generative.draft fleet-wide)")
        if int(meta.get("block_size", 0)) != self._kv_bs:
            raise ShipmentError(
                f"shipment block_size {meta.get('block_size')} != this "
                f"pool's {self._kv_bs} (pair replicas with identical "
                "kv_block_size)")
        if int(meta.get("vocab_size", 0)) != int(self.cfg.vocab_size):
            raise ShipmentError(
                f"shipment vocab {meta.get('vocab_size')} != model "
                f"vocab {self.cfg.vocab_size}")

    def _draft_meta(self, n_blocks: int) -> dict:
        """The draft section's identity in a fmt-2 frame."""
        ref = self._dcache["k"]
        return {"block_size": self._kv_bs,
                "vocab_size": int(self._spec["cfg"].vocab_size),
                "n_blocks": n_blocks, "kv_shape": list(ref.shape[2:]),
                "num_layers": int(ref.shape[0]),
                "dtype": _NAMES[ref.dtype]}

    def _draft_section(self, meta: dict, arrays: dict) -> tuple:
        """A fmt-2 frame's draft blocks ({"k", "v"}: [L, n, bs, KH, D]) and
        their count, after its identity is checked against this engine's
        draft model."""
        dmeta = dict(meta.get("draft") or {})
        dn = int(dmeta.get("n_blocks", 0))
        mine = self._draft_meta(dn)
        if any(dmeta.get(k) != v for k, v in mine.items()
               if k != "n_blocks"):
            raise ShipmentError(
                f"shipment draft section {dmeta} does not match this "
                f"engine's draft model (layers={mine['num_layers']}, "
                f"kv_shape={mine['kv_shape']}, dtype={mine['dtype']}, "
                f"block_size={self._kv_bs}) — mixed-precision or "
                "mixed-config fleets cannot exchange draft KV")
        mb = self.max_len // self._kv_bs
        if dn < 1 or dn > mb:
            raise ShipmentError(
                f"shipment draft section claims {dn} blocks; this engine "
                f"fits at most {mb}")
        ref = self._dcache["k"].shape
        want = (ref[0], dn, *ref[2:])
        out = {}
        for name in ("k", "v"):
            arr = arrays.get("draft_" + name)
            if arr is None:
                raise ShipmentError(
                    f"fmt 2 shipment missing draft_{name!r} blocks")
            if tuple(arr.shape) != want:
                raise ShipmentError(
                    f"shipment draft_{name} blocks shaped "
                    f"{tuple(arr.shape)}, this engine needs {want}")
            out[name] = arr
        return out, dn

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
        """Paged-pool snapshot for metadata (None = flat), with the host
        tier's counters under "host_tier" when it has one."""
        if not self._paged:
            return None
        info = {"block_size": self._kv_bs, "blocks": self._kv_alloc.n_blocks,
                "blocks_free": self._kv_alloc.free_blocks,
                "blocks_used": self._kv_alloc.used_blocks}
        if self._host_tier is not None:
            info["host_tier"] = self._host_tier.stats_snapshot()
        return info

    @property
    def kv_spill_blocks(self) -> int | None:
        """Host-tier resident blocks (None = no tier): the
        `tpk_kv_spill_blocks` gauge."""
        return (self._host_tier.resident_blocks
                if self._host_tier is not None else None)

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

    def _reserve_blocks(self, req: dict) -> int:
        """Blocks a request's admission reserves: a ship-mode one only its
        prompt's (the decode engine reserves the decode budget), any other
        the worst case."""
        n = len(req["input_ids"])
        if req.get("mode") == "ship":
            return blocks_for(n, self._kv_bs)
        return self._need_blocks(n, req["max_tokens"])

    def _spec_able(self, req: dict) -> bool:
        """Does the request ride the spec sub-batch? Greedy and
        plain-temperature rows do (exact match, rejection sampling);
        top-k/top-p rows decode in the vanilla sub-batch."""
        return (self._spec is not None and req["top_k"] == 0
                and req["top_p"] >= 1.0)

    def _draft_need_blocks(self, req: dict) -> int:
        """Draft-pool blocks a spec-able request reserves beside the
        target's: the same worst case, since the draft cache mirrors the
        committed index. Draft blocks are the slot's own: never shared by a
        prefix hit, never discounted by one."""
        if not (self._paged and self._spec_able(req)):
            return 0
        return self._reserve_blocks(req)

    def _free_slot_blocks(self, st: dict) -> None:
        """Return a retired request's target and draft blocks to the pool
        (idempotent)."""
        for key in ("blocks", "dblocks"):
            blocks = st.pop(key, None)
            if blocks:
                self._kv_alloc.decref(blocks)

    def _to_device(self, a) -> torch.Tensor:
        """A host array (numpy, or a CPU tensor) on the engine's device
        without a stream sync. On CUDA it goes through a pinned staging
        copy and a non-blocking transfer (a pageable copy would wait for
        every chunk in flight); PyTorch's pinned-memory allocator hands the
        staging block out again only after the transfer that reads it has
        run."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
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
        into the request's reserved blocks (paged), resuming after the
        longest prefix-cache hit when the cache is on. At depth 1 the first
        sampled token is fetched and emitted here; deeper, it stays on the
        device as the slot's `pending` decode carry (its host copy under
        way) and is emitted at a later poll or fetch. Paged: raises
        _NeedKVBlocks when the pool is short now. A ship-mode request is
        packed and released here (`_finish_ship`) and holds no slot; a
        remote one is admitted without a prefill (`_admit_remote_paged`)."""
        if req.get("mode") == "remote":
            self._admit_remote_paged(slot, req)
            return
        ids, aid = req["input_ids"], req["aid"]
        dtable = None
        if self._paged:
            table, dtable, tok0, lp0, start = self._admit_paged(req)
        else:
            table, frag, done = None, None, 0
            if self._prefix_cap:
                hit = self._prefix_lookup(ids, aid)
                if hit is not None:
                    done, frag = hit
                self._count_lookup(done, hit is not None)
            start = done
            frag, tok0, lp0 = self._prefill_fragment(
                req, frag, done,
                lambda m, f: self._prefix_store(aid, tuple(ids[:m]), f,
                                                copy=m < len(ids)))
            self._fns["insert"](self._cache, frag, slot)
            if self._spec_able(req):
                # The draft holds the same prompt history: its replay lands
                # in its own slot (top-k/top-p rows never speculate).
                self._dfns["insert"](self._dcache, self._draft_replay(ids),
                                     slot)
        with self._stats_lock:
            self.stats["prefill_chunks"] += -(-(len(ids) - start)
                                              // self.prefill_buckets[-1])
        if req.get("mode") == "ship":
            self._finish_ship(req, table, dtable, tok0, lp0)
            return
        st = {"req": req, "idx": len(ids), "disp": len(ids), "last": None,
              "pending": None,
              "draft_ok": self._spec_able(req)}
        if table is not None:
            st["blocks"] = table
        if dtable is not None:
            st["dblocks"] = dtable
        if self.pipeline_depth > 1:
            st["pending"] = (tok0, *self._to_host(tok0, lp0))
        else:
            st["last"] = int(tok0[0])
        self._slots[slot] = st
        self._count_request(req)
        if st["pending"] is None:
            self._emit(slot, st, [st["last"]], [float(lp0[0])])

    def _count_request(self, req: dict, **more: int) -> None:
        """Count a prefilled request (a local admission or a shipment):
        requests, prompt tokens, its adapter's requests, and `more`."""
        aid = req["aid"]
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["prompt_tokens"] += len(req["input_ids"])
            for key, n in more.items():
                self.stats[key] += n
            if aid:
                per = dict(self.stats.get("adapter_requests", {}))
                name = self._ml_names[aid]
                per[name] = per.get(name, 0) + 1
                self.stats["adapter_requests"] = per

    def _finish_ship(self, req: dict, table: list[int],
                     dtable: list[int] | None, tok0, lp0) -> None:
        """Pack a ship-mode admission's committed blocks (and a spec-able
        request's prompt-width draft blocks, as fmt 2) into a KV frame and
        release them; the request's result is the frame. The gathers and
        the first token come back through pinned memory behind one event,
        whose wait is a host sync: a prefill engine has no decode chunk in
        flight to stall (a unified engine's ship waits for its chunks)."""
        try:
            gathered = self._fns["export_blocks"](
                self._cache, self._to_device(np.asarray(table, np.int64)))
            if dtable is not None:
                dgathered = self._dfns["export_blocks"](
                    self._dcache,
                    self._to_device(np.asarray(dtable, np.int64)))
                gathered.update({"draft_" + n: t
                                 for n, t in dgathered.items()})
            names = sorted(gathered)
            host, event = self._to_host(tok0, lp0,
                                        *(gathered[n] for n in names))
            if event is not None:
                _wait(event)
        finally:
            self._kv_alloc.decref(table)
            if dtable is not None:
                self._kv_alloc.decref(dtable)
        arrays = dict(zip(names, host[2:]))
        # The generator after the prefill's draws: a decode engine that
        # adopts it draws what this one would have drawn next.
        arrays["rng_key"] = self._gen.get_state()
        first_tok = int(host[0][0])
        meta = {"fmt": (2 if dtable is not None
                        else 3 if self.kv_quant != "none" else 1),
                "block_size": self._kv_bs,
                "vocab_size": int(self.cfg.vocab_size),
                "tokens": list(req["input_ids"]),
                "committed": len(req["input_ids"]),
                "first_token": first_tok,
                "first_logprob": float(host[1][0]),
                "max_tokens": req["max_tokens"],
                "temperature": req["temperature"], "top_k": req["top_k"],
                "top_p": req["top_p"], "eos_id": req["eos_id"],
                "adapter": req["adapter"],
                # The caller's budget: the decode engine waits as long as
                # the unified engine would have.
                "timeout": req["timeout"], "extra": req["extra"]}
        if dtable is not None:
            meta["draft"] = self._draft_meta(len(dtable))
        if self.kv_quant != "none":
            meta["kv_quant"] = self.kv_quant
        payload = pack_shipment(meta, arrays)
        res_metrics.observe("tpk_kv_shipment_bytes", len(payload),
                            buckets=_SHIPMENT_BUCKETS)
        self._count_request(req, kv_blocks_shipped=len(table),
                            kv_shipment_bytes=len(payload))
        req["result"] = {"shipment": payload,
                         "num_input_tokens": len(req["input_ids"]),
                         "first_token": first_tok, "kv_blocks": len(table)}
        req["done"].set()

    def _admit_remote_paged(self, slot: int, req: dict) -> None:
        """Admit a shipped prefill into `slot` with no prefill chunk:
        reserve the full decode budget (and a spec-able request's draft
        blocks: both or neither, as `_admit_paged`), scatter the shipped
        blocks into the table's first entries by pinned non-blocking copies
        (a fmt-1 frame into a quantized pool encoded by the decode writes'
        row encode; the budget's tail keeps stale rows, each written before
        any query attends it), the draft's from a fmt-2 frame or replayed
        from the prompt, adopt the shipped generator state and emit the
        shipped first token. Nothing here waits for the device, so a remote
        admission rides behind the chunks in flight. Raises _NeedKVBlocks
        when the pool is short now."""
        ids = req["input_ids"]
        table = self._kv_alloc.alloc(self._reserve_blocks(req))
        if table is None:
            raise _NeedKVBlocks()
        dtable = None
        dneed = self._draft_need_blocks(req)
        if dneed:
            dtable = self._kv_alloc.alloc(dneed)
            if dtable is None:
                self._kv_alloc.decref(table)
                raise _NeedKVBlocks()
        n = req["n_blocks"]
        try:
            blocks = {name: self._to_device(t)
                      for name, t in req["kv_blocks"].items()}
            if self.kv_quant != "none" and "ks" not in blocks:
                for name in ("k", "v"):
                    blocks[name], blocks[name + "s"] = kv_quantize_rows(
                        blocks[name], self.kv_quant)
            self._fns["import_blocks"](
                self._cache, blocks,
                self._to_device(np.asarray(table[:n], np.int64)))
            if dtable is not None and req["draft_blocks"] is not None:
                dn = min(req["dn_blocks"], len(dtable))
                self._dfns["import_blocks"](
                    self._dcache,
                    {name: self._to_device(t[:, :dn])
                     for name, t in req["draft_blocks"].items()},
                    self._to_device(np.asarray(dtable[:dn], np.int64)))
            elif dtable is not None:
                # A frame without a draft section: the draft replays the
                # prompt here (the cost a fmt-2 frame saves).
                self._dfns["insert_paged"](
                    self._dcache, self._draft_replay(ids),
                    self._to_device(np.asarray(dtable, np.int64)))
        except BaseException:
            self._kv_alloc.decref(table)
            if dtable is not None:
                self._kv_alloc.decref(dtable)
            raise
        if req["rng_key"] is not None:
            # Concurrent shipments share this one generator, as concurrent
            # local admissions do (the last admission's state wins); a
            # request alone draws the unified engine's stream.
            self._gen.set_state(req["rng_key"])
        st = {"req": req, "idx": len(ids), "disp": len(ids),
              "last": req["first_tok"], "pending": None,
              "draft_ok": dtable is not None, "blocks": table}
        if dtable is not None:
            st["dblocks"] = dtable
        self._slots[slot] = st
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["remote_admits"] += 1
            self.stats["kv_blocks_received"] += n
        self._emit(slot, st, [req["first_tok"]], [req["first_lp"]])

    def _count_lookup(self, done: int, hit: bool, zero_copy: bool = False,
                      cow: bool = False) -> None:
        with self._stats_lock:
            if hit:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += done
                self.stats["prefix_zero_copy_hits"] += int(zero_copy)
                self.stats["kv_cow_copies"] += int(cow)
            else:
                self.stats["prefix_misses"] += 1

    def _admit_paged(self, req: dict):
        """Paged admission: the fragment pipeline is the flat one; the
        fragment lands in this request's blocks. A prefix hit (in the pool,
        or restored from the host tier) maps the stored prefix's full blocks
        into the table by reference, and its partial tail block is forked:
        the tail's committed rows ride the fragment into a fresh block
        (`kv_cow_copies`). The whole worst-case need is reserved here, a
        spec-able request's draft blocks with it (the draft replays the
        whole prompt into them, never from the cache); the boundary stores
        wait until the insert has written their blocks. Returns (table,
        draft table or None, first token, its logprob, the prompt position
        prefill resumed at)."""
        ids, aid = req["input_ids"], req["aid"]
        bs = self._kv_bs
        done, shared, gather, hit = 0, [], None, None
        if self._prefix_cap:
            hit = self._prefix_probe(ids, aid, touch=True)
            if hit is None and self._host_tier is not None:
                hit = self._restore_spilled(ids, aid, req)
            if hit is not None:
                done, gather = hit
                shared = list(gather[:done // bs])
        # _admit_waiting's _kv_fits precheck makes this failure unreachable
        # in the normal flow.
        fresh = self._kv_alloc.alloc(max(0, self._reserve_blocks(req)
                                         - len(shared)))
        if fresh is None:
            raise _NeedKVBlocks()
        # The draft's blocks, with the target's: both or neither, so the
        # _kv_fits precheck (which counts both) stays the one gate.
        dtable = None
        dneed = self._draft_need_blocks(req)
        if dneed:
            dtable = self._kv_alloc.alloc(dneed)
            if dtable is None:
                self._kv_alloc.decref(fresh)
                raise _NeedKVBlocks()
        if self._prefix_cap:
            self._count_lookup(done, hit is not None, bool(shared),
                               done % bs > 0)
        self._kv_alloc.incref(shared)
        table = shared + fresh
        boundaries: list[int] = []
        try:
            frag = None
            if gather is not None:
                frag = self._fns["frag_from_pool"](
                    self._cache, self._to_device(np.asarray(gather,
                                                            np.int64)))
                if self.kv_quant != "none":
                    with self._stats_lock:
                        self.stats["kv_dequant_fallbacks"] += 1
            frag, tok0, lp0 = self._prefill_fragment(
                req, frag, done, lambda m, f: boundaries.append(m))
            scatter = np.zeros((len(table),), np.int64)
            scatter[len(shared):] = fresh  # shared blocks: the NULL block
            self._fns["insert_paged"](self._cache, frag,
                                      self._to_device(scatter))
            if dtable is not None:
                self._dfns["insert_paged"](
                    self._dcache, self._draft_replay(ids),
                    self._to_device(np.asarray(dtable, np.int64)))
        except BaseException:
            self._kv_alloc.decref(table)
            if dtable is not None:
                self._kv_alloc.decref(dtable)
            raise
        for m in boundaries:
            self._prefix_store_paged(aid, tuple(ids[:m]),
                                     table[:blocks_for(m, bs)])
        return table, dtable, tok0, lp0, done

    def _prefill_fragment(self, req: dict, frag=None, done: int = 0,
                          on_boundary=None):
        """The prompt's chunked prefill into a one-row fragment cache from
        prompt position `done` (0, or a prefix-cache hit's length with its
        fragment `frag`): (fragment, first sampled token [1], its logprob
        [1]). With the prefix cache on, `on_boundary(position, fragment)`
        is called after each chunk, except where a later boundary of this
        admission would evict that entry at once (fewer entries than
        chunks left)."""
        ids = req["input_ids"]
        samp = (self._to_device(np.array([req["temperature"]], np.float32)),
                self._to_device(np.array([req["top_k"]], np.int64)),
                self._to_device(np.array([req["top_p"]], np.float32)))
        big = self.prefill_buckets[-1]
        fns = self._fns
        ad = self._adapter_rows(np.array([req["aid"]], np.int64))
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
            if self._prefix_cap and -(-(len(ids) - done)
                                      // big) < self._prefix_cap:
                on_boundary(done, frag)
        return frag, tok0, lp0

    def _draft_replay(self, ids: list[int]) -> dict:
        """The draft's fragment over `ids`, built by continuation chunks
        of the largest bucket from position 0 (no sampling): the one recipe
        of admission and re-admission."""
        big = self.prefill_buckets[-1]
        dfrag = init_cache(self._spec["cfg"], 1, self._dfns["frag_len"],
                           device=self.device)
        for done in range(0, len(ids), big):
            piece = ids[done:done + big]
            toks = np.zeros((1, self._bucket_for(len(piece))), np.int64)
            toks[0, :len(piece)] = piece
            dfrag = self._dfns["extend_mid"](dfrag, self._to_device(toks),
                                             done)
        return dfrag

    def _readmit_worthwhile(self, st: dict) -> bool:
        """Is replaying a demoted slot's history worth it? Not to
        speculate a handful of remaining tokens, nor for a history far
        longer than the remainder; such a slot rides spec chunks with
        stale draft rows instead (`spec_stale_rides`)."""
        req = st["req"]
        remaining = req["max_tokens"] - len(req["out"])
        history = len(req["input_ids"]) + len(req["out"]) - 1
        return remaining >= self.chunk and history <= 32 * remaining

    def _readmit_draft(self, slot: int, st: dict) -> None:
        """Rebuild a demoted slot's draft cache from its history (the
        prompt and every emitted token but the last, positions 0..idx-1)
        after vanilla chunks left its draft rows unwritten."""
        req = st["req"]
        dfrag = self._draft_replay(req["input_ids"] + req["out"][:-1])
        if self._paged:
            self._dfns["insert_paged"](
                self._dcache, dfrag,
                self._to_device(np.asarray(st["dblocks"], np.int64)))
        else:
            self._dfns["insert"](self._dcache, dfrag, slot)
        st["draft_ok"] = True
        with self._stats_lock:
            self.stats["spec_readmissions"] += 1

    # -- prefix cache ----------------------------------------------------------

    def _prefix_probe(self, ids: list[int], aid: int, touch: bool):
        """Longest cached prefix strictly shorter than the prompt (the final
        token's logits must still be computed) under adapter `aid` (a
        prefix computed under one adapter holds its K/V deltas and never
        serves another): (length, stored payload: a fragment flat, block
        ids paged) or None. One hash per distinct cached length, longest
        first; the stored token tuple verifies each hash hit, so a
        collision costs a miss, never a wrong prefix. `touch` moves the hit
        to the LRU's end (`_kv_fits` only peeks)."""
        lens = self._prefix_lens.get(aid)
        if not lens:
            return None
        for n in sorted(lens, reverse=True):
            if n >= len(ids):
                continue
            kt = tuple(ids[:n])
            key = (aid, n, hash(kt))
            entry = self._prefix_lru.get(key)
            if entry is None or entry[0] != kt:
                continue  # absent, or a same-hash different prefix
            if touch:
                self._prefix_lru.move_to_end(key)
            return n, entry[1]
        return None

    def _prefix_lookup(self, ids: list[int], aid: int = 0):
        """Flat: (matched length, a clone of the stored fragment) or None.
        The clone is what the admission extends: `extend` writes into the
        fragment it is given."""
        hit = self._prefix_probe(ids, aid, touch=True)
        if hit is None:
            return None
        return hit[0], {n: t.clone() for n, t in hit[1].items()}

    def _prefix_insert(self, aid: int, kt: tuple, make_payload) -> None:
        """Store `make_payload(displaced)` under kt's key (`displaced` is
        the payload of a same-hash different prefix it replaces, or None),
        then evict the oldest entries past the cap. A key already holding
        kt is a pure LRU touch."""
        key = (aid, len(kt), hash(kt))
        existing = self._prefix_lru.get(key)
        if existing is not None and existing[0] == kt:
            self._prefix_lru.move_to_end(key)
            return
        if existing is None:
            per = self._prefix_lens.setdefault(aid, {})
            per[len(kt)] = per.get(len(kt), 0) + 1
        self._prefix_lru[key] = (kt, make_payload(
            None if existing is None else existing[1]))
        self._prefix_lru.move_to_end(key)
        with self._stats_lock:
            self.stats["prefix_stores"] += 1
        while len(self._prefix_lru) > self._prefix_cap:
            self._prefix_evict(next(iter(self._prefix_lru)))

    def _prefix_store(self, aid: int, kt: tuple, frag, *,
                      copy: bool = True) -> None:
        """Flat: store the fragment at a prompt-chunk boundary. An
        intermediate boundary's fragment is cloned (`copy`): the admission
        goes on writing into it. The final one is taken by reference:
        nothing writes into it after the insert, and every hit clones it.
        Rows past the keyed prefix may hold pad or stale K/V, overwritten
        before any query position can attend them."""
        self._prefix_insert(aid, kt, lambda _: (
            {n: t.clone() for n, t in frag.items()} if copy else frag))

    def _prefix_store_paged(self, aid: int, kt: tuple,
                            blocks: list[int]) -> None:
        """Paged: publish a prompt-boundary prefix as block references (a
        refcount bump, no device work). The stored tail block may be
        partially filled; its owner keeps writing at rows >= len(kt),
        which never disturbs the committed rows a later hit reads, and the
        hit forks that block before writing. A hash-collision overwrite
        drops the displaced entry's references."""
        def payload(displaced):
            if displaced is not None:
                self._kv_alloc.decref(displaced)
            self._kv_alloc.incref(blocks)
            return tuple(blocks)
        self._prefix_insert(aid, kt, payload)

    def _prefix_evict(self, key: tuple) -> None:
        """Drop one prefix entry and its length-index bookkeeping. Paged,
        the entry's block references return to the allocator, after the
        blocks are spilled to the host tier when there is one."""
        if self._paged and self._host_tier is not None:
            kt, blocks = self._prefix_lru[key]
            self._spill_prefix(key, kt, blocks)
        _, payload = self._prefix_lru.pop(key)
        eaid, en, _ = key
        per = self._prefix_lens.get(eaid, {})
        if per.get(en, 0) <= 1:
            per.pop(en, None)
            if not per:
                self._prefix_lens.pop(eaid, None)
        else:
            per[en] -= 1
        if self._paged:
            self._kv_alloc.decref(payload)

    def _kv_fits(self, req: dict) -> bool:
        """Can the pool cover this request's worst-case need right now,
        counting a zero-copy prefix hit's shared blocks? Under pressure,
        prefix-cache entries are evicted first: cached prefixes yield to
        live traffic, or a pool pinned by cache references would deadlock
        an idle engine against a stashed admission.

        The feasibility bound is computed once (a block is reclaimable
        only when every reference to it is the cache's) for both outcomes:
        keeping the peeked hit (discounted need, its blocks kept) and
        giving it up (full need, everything reclaimable). If neither can
        fit, nothing is evicted. Otherwise non-hit entries go first,
        oldest first, and the hit itself only when giving up its discount
        is the only way to fit."""
        ids, aid = req["input_ids"], req["aid"]
        # A spec-able request also covers its draft blocks, in full.
        total = self._reserve_blocks(req) + self._draft_need_blocks(req)
        # A remote admission's blocks arrive on the wire and its reserve
        # takes the full need: a hit's discount could pass a request the
        # reserve never satisfies.
        hit = (self._prefix_probe(ids, aid, touch=False)
               if self._prefix_cap and req.get("mode") != "remote"
               else None)
        shared = hit[0] // self._kv_bs if hit is not None else 0
        hit_key = ((aid, hit[0], hash(tuple(ids[:hit[0]])))
                   if hit is not None else None)
        if self._kv_alloc.can_alloc(total - shared):
            return True
        if not self._prefix_lru:
            return False
        cache_refs: dict[int, int] = {}
        for _, eblocks in self._prefix_lru.values():
            for b in eblocks:
                cache_refs[b] = cache_refs.get(b, 0) + 1
        hit_blocks = set(hit[1]) if hit is not None else set()
        free = self._kv_alloc.free_blocks
        reclaim = [b for b, c in cache_refs.items()
                   if self._kv_alloc.refcount(b) == c]
        reclaim_keep_hit = sum(1 for b in reclaim if b not in hit_blocks)
        keep_hit = (hit_key is not None
                    and free + reclaim_keep_hit >= total - shared)
        if not keep_hit and free + len(reclaim) < total:
            return False
        protect = hit_key if keep_hit else None
        while True:
            resident = hit_key is not None and hit_key in self._prefix_lru
            if self._kv_alloc.can_alloc(total - (shared if resident else 0)):
                return True
            victim = next((k for k in self._prefix_lru if k != protect),
                          None)
            if victim is None:
                return False  # unreachable under the exact bounds above
            self._prefix_evict(victim)

    # -- host tier ---------------------------------------------------------------

    def _spill_prefix(self, key: tuple, kt: tuple, blocks: tuple) -> None:
        """Serialize one evicted prefix entry's blocks into the host tier,
        in the KV wire format. Called before the eviction's decref: the
        gather must read the blocks while they still hold the committed
        rows. The copy to the host waits for the device (a host sync, at
        an admission under pool pressure). A quantized pool charges the
        tier by payload weight in full-precision block units (D bytes of
        codes and 4 of scale per row-head against D * itemsize), so a
        budget holds about twice the entries."""
        aid = key[0]
        gathered = self._fns["export_blocks"](
            self._cache, self._to_device(np.asarray(blocks, np.int64)))
        arrays = {name: leaf.cpu() for name, leaf in gathered.items()}
        meta = {"fmt": 3 if self.kv_quant != "none" else 1,
                "block_size": self._kv_bs,
                "vocab_size": int(self.cfg.vocab_size),
                "tokens": list(kt), "committed": len(kt)}
        charge = len(blocks)
        if self.kv_quant != "none":
            meta["kv_quant"] = self.kv_quant
            d = int(self._cache["k"].shape[-1])
            fitem = torch.empty((), dtype=self.cfg.dtype).element_size()
            charge = max(1, -(-len(blocks) * (d + 4) // (d * fitem)))
        if self._host_tier.put(aid, kt, charge, pack_shipment(meta, arrays)):
            with self._stats_lock:
                self.stats["kv_spilled_blocks"] += len(blocks)

    def _restore_spilled(self, ids: list[int], aid: int, req: dict):
        """Restore the longest host-tier prefix of `ids` into pool blocks
        and publish it as a prefix-cache entry: (matched length, block ids)
        as `_prefix_probe` returns paged, or None (nothing spilled, no room,
        or a payload this engine cannot verify, which is dropped: the pool
        recomputes rather than serve bytes it cannot validate).

        Livelock guard: the restore must leave room for this admission's
        own reserve (its full need less the restored full blocks it maps
        zero-copy). Checking the restore alone would let a tight pool
        ping-pong: _kv_fits gives up the hit (spill), the admission
        restores it (taking the last headroom), its reserve fails and
        stashes, and the next pass spills and restores again. So the
        restore happens only when both fit together; otherwise the
        admission proceeds cold, which always ends."""
        tier = self._host_tier
        n = tier.probe_longest(aid, ids)
        if n is None:
            return None
        bs = self._kv_bs
        n_blocks = blocks_for(n, bs)
        total = self._reserve_blocks(req)
        if not self._kv_alloc.can_alloc(n_blocks + total - n // bs):
            return None  # leave it spilled; admission proceeds cold
        kt = tuple(ids[:n])
        taken = tier.take(aid, kt)
        if taken is None:
            return None
        names = tuple(self._cache)
        try:
            meta, arrays = unpack_shipment(taken[1])
            # A quantized pool restores only payloads of its own mode with
            # scale planes; anything else drops to recompute.
            if (int(meta.get("block_size", 0)) != bs
                    or list(meta.get("tokens", ())) != list(kt)
                    or str(meta.get("kv_quant", "none")) != self.kv_quant
                    or any(x not in arrays
                           or tuple(arrays[x].shape)
                           != (self._cache[x].shape[0], n_blocks,
                               *self._cache[x].shape[2:])
                           for x in names)):
                raise ShipmentError("spilled payload mismatch")
        except ShipmentError:
            return None
        blocks = self._kv_alloc.alloc(n_blocks)
        if blocks is None:
            return None
        self._fns["import_blocks"](
            self._cache, {x: self._to_device(arrays[x]) for x in names},
            self._to_device(np.asarray(blocks, np.int64)))
        # Publish as a cache entry (its incref owns the blocks), then drop
        # the allocation's reference: the refcounts an entry resident all
        # along would have.
        self._prefix_store_paged(aid, kt, blocks)
        self._kv_alloc.decref(blocks)
        with self._stats_lock:
            self.stats["kv_restored_blocks"] += n_blocks
        return n, tuple(blocks)

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
        return self._budget_open(active)

    def _budget_open(self, rows: list[int]) -> bool:
        """Is some row's budget not yet covered by the tokens in flight
        (and a pending first token)? Else a chained dispatch is waste."""
        for i in rows:
            st = self._slots[i]
            inflight = st["disp"] - st["idx"] + (st["pending"] is not None)
            if len(st["req"]["out"]) + inflight < st["req"]["max_tokens"]:
                return True
        return False

    def _admit_waiting(self, overlap: bool) -> None:
        """Fill free slots from the queue. Paged: a request the pool cannot
        cover yet (`_kv_fits`, which first reclaims prefix-cache blocks)
        waits at the head of the line (FIFO: nothing jumps it), and
        admission resumes as retirements free blocks. With `overlap`
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
                if self._paged and not self._kv_fits(req):
                    self._kv_stash.appendleft(req)
                    return
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

    def _van_riders_fit(self, van_batch: list[int]) -> bool:
        """Flat: live rows outside the vanilla sub-batch (spec rows) park
        their batch-wide write at their own `disp`; near the context end
        that write would be clamped back over committed rows, so the
        dispatch waits until they retire. On a rolling cache any parked
        write wraps onto live window rows, so the dispatch waits for every
        such row (a spec record in flight). Paged riders write the NULL
        block."""
        if self._paged:
            return True
        vb = set(van_batch)
        return not any(st is not None and j not in vb
                       and (self._rolling
                            or st["disp"] + self.chunk > self.max_len)
                       for j, st in enumerate(self._slots))

    def _spec_batch(self, active: list[int], van_covered: set,
                    spec_chain: list) -> tuple[list[int], list[int]]:
        """This round's spec sub-batch: (parts, fallback). `parts` ride a
        spec dispatch now; `fallback` rows join the vanilla sub-batch this
        round, which only happens with no spec chunk in flight (a row that
        rides one has its true last token on the device only)."""
        if self._spec is None:
            return [], []
        rows = [i for i in active if self._spec_able(self._slots[i]["req"])
                and i not in van_covered]
        if not rows:
            return [], []
        chained = bool(spec_chain)
        if chained and spec_chain[-1]["doomed"]:
            return [], []  # drain the doomed chain before dispatching again
        if chained and self._rolling:
            # A doomed over-dispatch would have wrap-written window rows
            # that later queries still attend: a rolling spec chain stays
            # at depth 1.
            return [], []
        if self._rolling and len(rows) != len(active):
            # Riders would wrap-write live window rows the same way:
            # mixed traffic decodes all-vanilla on a rolling cache.
            return [], rows
        worst = self._spec["n_spec"] * (self._spec["gamma"] + 1)
        if self._paged:
            # Per-row tables: a row short of a worst-case advance falls
            # back to the vanilla sub-batch alone.
            fit = [i for i in rows
                   if self._slots[i]["disp"] + worst <= self.max_len]
        else:
            # One batch-wide bucket, and riders park at their own disp: the
            # headroom must cover every live row.
            high = max(st["disp"] for st in self._slots if st is not None)
            fit = rows if high + worst <= self.max_len else []
        tail = [i for i in rows if i not in fit]

        def usable(i: int) -> bool:
            st = self._slots[i]
            return st["draft_ok"] or (
                st["disp"] == st["idx"] and st["pending"] is None
                and self._readmit_worthwhile(st))
        if fit and not any(usable(i) for i in fit):
            # No row would propose from a live (or replayable) draft cache.
            tail, fit = rows, []
        if not fit or (chained and not self._budget_open(fit)):
            return [], (tail if not chained else [])
        return fit, (tail if not chained else [])

    def _gather_rows(self, rows: list[int]):
        """Host arrays of the dispatched rows' state: (last, idx,
        temperature, top_k, top_p), idle rows at 0 (top_p 1). Flat, a live
        row outside `rows` (of the other sub-batch) parks its batch-wide
        write at its own `disp`, its uncommitted tail: index 0 would
        overwrite its committed prompt rows (paged riders write the NULL
        block)."""
        n = self.n_slots
        last = np.zeros((n,), np.int64)
        idx = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        ks = np.zeros((n,), np.int64)
        ps = np.ones((n,), np.float32)
        for i in rows:
            st = self._slots[i]
            idx[i] = st["disp"]
            temps[i] = st["req"]["temperature"]
            ks[i] = st["req"]["top_k"]
            ps[i] = st["req"]["top_p"]
            if st["pending"] is None:
                last[i] = st["last"]
        if not self._paged:
            part = set(rows)
            for j, st in enumerate(self._slots):
                if st is not None and j not in part:
                    idx[j] = st["disp"]
        return last, idx, temps, ks, ps

    def _carry_in(self, rows: list[int], last, carry: dict | None,
                  carry_last) -> torch.Tensor:
        """The dispatch's input tokens on the device: `last` from the host
        without a carry, else `carry_last`, a copy of the newest in-flight
        record's last tokens (its own are still to be fetched). A pending
        first token (its host copy not yet seen) is written in on the
        device either way; with a carry, so is the host value of a row
        that did not ride it."""
        last_dev = self._to_device(last) if carry is None else carry_last
        for i in rows:
            st = self._slots[i]
            if carry is not None and carry["parts"].get(i) is st:
                continue  # rides the carry
            # In place on the device: an element assignment from a host
            # value would be a pageable copy, which waits for the stream.
            if st["pending"] is not None:
                last_dev[i].copy_(st["pending"][0][0])
            elif carry is not None:
                last_dev[i].fill_(st["last"])
        return last_dev

    def _tables(self, rows: list[int], key: str, nb: int):
        """Per-row block tables [n_slots, nb] of `key` ("blocks" or
        "dblocks") on the device, padded with the NULL block, from host
        lists fixed at admission."""
        tables = np.zeros((self.n_slots, nb), np.int64)
        for i in rows:
            blk = self._slots[i][key][:nb]
            tables[i, :len(blk)] = blk
        return self._to_device(tables)

    def _adapter_batch(self, rows: list[int]):
        """Each row's adapter factors, gathered once for the dispatch's
        steps (other rows take the base entry); None without adapters."""
        if self._ml_stacks is None:
            return None
        aids = np.zeros((self.n_slots,), np.int64)
        for i in rows:
            aids[i] = self._slots[i]["req"]["aid"]
        return self._adapter_rows(aids)

    def _dispatch_chunk(self, active: list[int],
                        carry: dict | None = None) -> dict:
        """Enqueue one vanilla decode chunk over the rows `active` without
        fetching it. `carry` is the newest vanilla record still in flight:
        its last tokens, on the device, are this chunk's inputs. The
        cache-length bucket is the smallest covering every row written
        after this chunk."""
        last, idx, temps, ks, ps = self._gather_rows(active)
        trunc = any(ks[i] > 0 or ps[i] < 1.0 for i in active)
        need = int(idx.max()) + self.chunk
        bucket = next((b for b in self.decode_buckets if b >= need),
                      self.decode_buckets[-1])
        t0 = time.monotonic()
        last_dev = self._carry_in(active, last, carry, None if carry is None
                                  else carry["toks"][:, -1].clone())
        args = [last_dev] + [self._to_device(a) for a in (idx, temps, ks, ps)]
        if self._paged:
            args.insert(0, self._tables(active, "blocks",
                                        bucket // self._kv_bs))
        self._cache, toks, lps = self._decode[(bucket, trunc)](
            self._cache, *args, self._gen, self._adapter_batch(active))
        host, event = self._to_host(toks, lps)
        with self._stats_lock:
            self.stats["decode_dispatches"] += 1
        for i in active:
            self._slots[i]["disp"] += self.chunk
        return {"kind": "van", "toks": toks, "host": host, "event": event,
                "t0": t0, "chunk": self.chunk,
                "parts": {i: self._slots[i] for i in active}}

    def _dispatch_spec_chunk(self, parts: list[int],
                             carry: dict | None = None) -> dict:
        """Enqueue one speculative dispatch over the spec sub-batch without
        fetching it. `carry` chains it on the newest spec record's
        worst-case carry: its last bonus token, which is the true one only
        if every proposal was accepted; `_fetch_spec_chunk` drops a record
        whose start that assumption made false. A demoted row whose draft
        is worth replaying (no chunk in flight for it) is re-admitted here;
        another rides with stale draft rows (`spec_stale_rides`), which can
        cost acceptance, never correctness."""
        spec = self._spec
        worst = spec["n_spec"] * (spec["gamma"] + 1)
        stale = 0
        for i in parts:
            st = self._slots[i]
            if st["draft_ok"]:
                continue
            if (st["disp"] == st["idx"] and st["pending"] is None
                    and self._readmit_worthwhile(st)):
                self._readmit_draft(i, st)
            else:
                stale += 1
        if stale:
            with self._stats_lock:
                self.stats["spec_stale_rides"] += stale
        last, idx, temps, _, _ = self._gather_rows(parts)
        assumed = {i: self._slots[i]["disp"] for i in parts}
        need = int(idx.max()) + worst
        bucket = next((b for b in self.decode_buckets if b >= need),
                      self.decode_buckets[-1])
        t0 = time.monotonic()
        last_dev = self._carry_in(parts, last, carry, None if carry is None
                                  else carry["toks"][:, -1, -1].clone())
        args = [last_dev, self._to_device(idx), self._to_device(temps)]
        if self._paged:
            nb = bucket // self._kv_bs
            args[:0] = [self._tables(parts, "blocks", nb),
                        self._tables(parts, "dblocks", nb)]
        self._cache, self._dcache, toks, lps, acc = self._spec_decode[bucket](
            self._cache, self._dcache, *args, self._gen,
            self._adapter_batch(parts))
        host, event = self._to_host(toks, lps, acc)
        with self._stats_lock:
            self.stats["decode_dispatches"] += 1
            self.stats["spec_dispatches"] += 1
        for i in parts:
            self._slots[i]["disp"] += worst
        return {"kind": "spec", "toks": toks, "host": host, "event": event,
                "t0": t0, "worst": worst, "assumed": assumed,
                "doomed": False,
                "parts": {i: self._slots[i] for i in parts}}

    def _fetch_wait(self, rec: dict, overlapped: bool) -> list:
        """Wait for one record's host copies (the designed host sync) and
        account the wait; returns them as numpy arrays. `overlapped`:
        another chunk was in flight meanwhile."""
        t0 = time.monotonic()
        if rec["event"] is not None:
            _wait(rec["event"])
        host = [h.numpy() for h in rec["host"]]
        now = time.monotonic()
        start = (rec["t0"] if self._busy_mark is None
                 else max(self._busy_mark, rec["t0"]))
        with self._stats_lock:
            self.stats["host_stall_seconds"] += now - t0
            self.stats["decode_fetch_overlapped" if overlapped
                       else "decode_fetch_blocking"] += 1
            self.stats["decode_seconds"] += now - start
        self._busy_mark = now
        return host

    def _live_part(self, i: int, st: dict, waste: int) -> bool:
        """Is record part (i, st) still live? Its pending first token is
        emitted first (the record decoded from it); a part whose slot no
        longer holds its request, or whose request finished at that token,
        is dead and its `waste` tokens dropped."""
        if self._slots[i] is st and st["pending"] is not None:
            self._emit_pending(i, st)
        if self._slots[i] is st:
            return True
        with self._stats_lock:
            self.stats["decode_dead_slot_chunks"] += 1
            self.stats["decode_wasted_tokens"] += waste
        return False

    def _fetch_chunk(self, rec: dict, overlapped: bool) -> None:
        """Fetch one vanilla record and reconcile: dead parts are dropped.
        A live row's draft rows were not written by this chunk, so its
        draft is not trusted until re-admission replays its history
        (`spec_demotions`)."""
        toks, lps = self._fetch_wait(rec, overlapped)
        for i, st in rec["parts"].items():
            if not self._live_part(i, st, rec["chunk"]):
                continue
            st["idx"] += rec["chunk"]
            st["last"] = int(toks[i, -1])
            with self._stats_lock:
                self.stats["spec_demotions"] += int(st["draft_ok"])
                self.stats["decode_tokens"] += rec["chunk"]
            st["draft_ok"] = False
            self._emit(i, st, [int(t) for t in toks[i]],
                       [float(v) for v in lps[i]])

    def _fetch_spec_chunk(self, rec: dict, inflight: deque,
                          overlapped: bool) -> None:
        """Fetch one spec record and reconcile each part: dead (its request
        retired: rows dropped); over-advanced (the record was doomed, or an
        earlier record's partial acceptance made its start index false:
        rows dropped, `disp` rolled back by its worst case; the rows it
        wrote lie past the committed index and are overwritten before they
        are attended); or valid (emit per the accepted counts). A valid
        part short of the worst case dooms every later spec record in
        flight, whose carry and start were fabrications."""
        toks, lps, acc = self._fetch_wait(rec, overlapped)
        spec, worst = self._spec, rec["worst"]
        for i, st in rec["parts"].items():
            if not self._live_part(i, st, worst):
                continue
            if rec["doomed"] or st["idx"] != rec["assumed"][i]:
                st["disp"] -= worst
                with self._stats_lock:
                    self.stats["decode_wasted_tokens"] += worst
                continue
            emit_t: list[int] = []
            emit_l: list[float] = []
            for s in range(spec["n_spec"]):
                kk = int(acc[i, s])
                emit_t += [int(t) for t in toks[i, s, :kk + 1]]
                emit_l += [float(v) for v in lps[i, s, :kk + 1]]
            st["idx"] += len(emit_t)
            st["disp"] -= worst - len(emit_t)
            st["last"] = emit_t[-1]
            if len(emit_t) < worst:
                for r in inflight:
                    if r["kind"] == "spec":
                        r["doomed"] = True
            with self._stats_lock:
                self.stats["spec_proposed"] += spec["gamma"] * spec["n_spec"]
                self.stats["spec_accepted"] += len(emit_t) - spec["n_spec"]
                self.stats["decode_tokens"] += len(emit_t)
            self._emit(i, st, emit_t, emit_l)

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

    def _dispatch_round(self, active: list[int], inflight: deque) -> None:
        """Dispatch while a sub-batch's chain has room: the spec sub-batch
        (greedy and plain-temperature rows, with a draft) and the vanilla
        one (top-k/top-p rows, and spec rows falling back) each keep up to
        `pipeline_depth` records in flight, the vanilla chain only while
        another chunk is worth it. Without a draft this is the one chain
        of vanilla chunks."""
        while True:
            dispatched = False
            spec_chain = [r for r in inflight if r["kind"] == "spec"]
            van_chain = [r for r in inflight if r["kind"] == "van"]
            van_covered = {i for r in van_chain
                           for i, st in r["parts"].items()
                           if self._slots[i] is st}
            parts, fallback = self._spec_batch(active, van_covered,
                                               spec_chain)
            if parts and len(spec_chain) < self.pipeline_depth:
                inflight.append(self._dispatch_spec_chunk(
                    parts, spec_chain[-1] if spec_chain else None))
                self.inflight_depth = len(inflight)
                dispatched = True
            fb = set(fallback)
            van_batch = [i for i in active
                         if not self._spec_able(self._slots[i]["req"])
                         or i in fb]
            if (van_batch and len(van_chain) < self.pipeline_depth
                    and (not van_chain or self._worth_speculating(van_batch))
                    and self._van_riders_fit(van_batch)):
                inflight.append(self._dispatch_chunk(
                    van_batch, van_chain[-1] if van_chain else None))
                self.inflight_depth = len(inflight)
                dispatched = True
            if not dispatched:
                return

    def _loop(self) -> None:
        """Admit, sweep deadlines, poll pending first tokens, dispatch
        (`_dispatch_round`), fetch the oldest record of either kind. At
        depth 1 each round dispatches and fetches: the synchronous loop."""
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
                    if active:
                        self._dispatch_round(active, inflight)
                    if inflight:
                        rec = inflight.popleft()
                        self.inflight_depth = len(inflight)
                        if rec["kind"] == "spec":
                            self._fetch_spec_chunk(rec, inflight,
                                                   overlapped=bool(inflight))
                        else:
                            self._fetch_chunk(rec, overlapped=bool(inflight))
                except Exception:  # fail the batch, keep serving
                    self._fail_all(traceback.format_exc(), inflight)


#: Bundle `generative` keys of the JAX engine's features that this package
#: does not port yet, with the value that asks for nothing. A bundle that
#: sets one to anything else is refused by name (501 at the server).
_UNPORTED = {
    "mesh": ("tensor-parallel mesh", None),
}


class GenerativeTorchModel(Model):
    """KServe-Model-shaped wrapper: load() builds the engine; generate()
    and generate_stream() are the request surface, and prefill_ship(),
    decode_remote() and decode_remote_stream() the :prefill and :decode
    routes'. `generation`'s `tokenizer` ("bytes", or an HF-style object
    with encode/decode) lets requests pass `text` and adds `text` to the
    output."""

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
        # Speculative decoding: {"checkpoint": HF dir of the draft, "gamma":
        # N, "model_overrides": {...}}, loaded at load() like the target.
        self._draft_spec = dict(gen.pop("draft", None) or {})
        self._gen_cfg = gen
        self.engine: GenerationEngine | None = None
        #: {"checkpoint", "load_s", "bytes"} of the loaded draft, else None.
        self.draft_info: dict | None = None
        #: {"mode", "quantized", "full"} when the weights are int8
        #: (serve/runtimes.py sets it), else None.
        self.quantization: dict | None = None

    def load(self) -> bool:
        t0 = time.monotonic()
        kwargs = dict(self._gen_cfg)
        if self._draft_spec:
            kwargs["draft"] = self._load_draft()
        self.engine = GenerationEngine(self._model, **kwargs)
        self.load_time_s = time.monotonic() - t0
        self.ready = True
        return True

    def _load_draft(self) -> dict:
        """The engine's `draft` from `generative.draft`: its keys checked
        before the checkpoint is read (a typo fails at once), then the HF
        checkpoint through build_from_hf onto the target's device."""
        spec = dict(self._draft_spec)
        ckpt = spec.pop("checkpoint", None)
        overrides = spec.pop("model_overrides", None) or {}
        gamma = spec.pop("gamma", None)
        if spec:
            raise ValueError(f"unknown generative.draft keys {sorted(spec)}")
        if not ckpt:
            raise ValueError("generative.draft needs a 'checkpoint' (HF dir "
                             "of the draft model)")
        from kubeflow_tpu_torch.models.gpt2 import GPT2Config
        from kubeflow_tpu_torch.models.hf_import import build_from_hf
        from kubeflow_tpu_torch.models.llama import LlamaConfig
        from kubeflow_tpu_torch.models.moe import causal_lm

        t0 = time.monotonic()
        dcfg, sd = build_from_hf(ckpt, **overrides)
        if not isinstance(dcfg, (LlamaConfig, GPT2Config)):
            raise ValueError(f"generative.draft needs a causal-LM "
                             f"checkpoint, not {type(dcfg).__name__}")
        dmodel = causal_lm(dcfg, device=self._model.device)
        dmodel.load_state_dict(sd)
        nbytes = sum(t.numel() * t.element_size() for t in sd.values())
        del sd
        dmodel.eval()
        self.draft_info = {"checkpoint": ckpt, "bytes": nbytes,
                           "load_s": time.monotonic() - t0}
        draft = {"model": dmodel}
        if gamma is not None:
            draft["gamma"] = int(gamma)
        return draft

    def unload(self) -> None:
        self.ready = False
        if self.engine:
            self.engine.close()
            self.engine = None

    def _check_loaded(self) -> None:
        if not self.ready or self.engine is None:
            raise RuntimeError(f"model {self.name} is not loaded")

    def _resolve_ids(self, payload: dict) -> list[int]:
        """The request's prompt ids: `input_ids`, or `text` through the
        tokenizer."""
        self._check_loaded()
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

    def prefill_ship(self, payload: dict) -> dict:
        """The :prefill route: the :generate body in, the engine's KV
        shipment out. The caller's stream flag rides the frame's `extra`,
        so the decode side answers in the shape asked for."""
        ids = self._resolve_ids(payload)
        return self.engine.prefill_ship(
            ids, extra={"stream": bool(payload.get("stream"))},
            **self._submit_kwargs(payload))

    def decode_remote(self, shipment, *, deadline=None) -> dict:
        """The :decode route, not streamed: admit a shipment straight into
        decode and return the :generate response."""
        self._check_loaded()
        out = self.engine.submit_remote(shipment, deadline=deadline)
        if self.tokenizer is not None:
            out["text"] = self._decode_text(out["output_ids"])
        out["decode_tokens_per_sec"] = round(self.engine.throughput(), 2)
        return out

    def decode_remote_stream(self, shipment, *, deadline=None):
        """The streamed :decode route: generate_stream's events over a
        remote admission. The frame's `resume_skip` (in [0, max_tokens])
        is how many leading tokens the caller already holds from an earlier
        decode of the same frame: the engine replays the same stream (the
        frame carries the generator state and the sampling parameters) and
        those tokens are left out of the chunk events; the final event
        still carries the whole output. The wait is bounded by the frame's
        timeout plus 10 s."""
        self._check_loaded()
        meta = peek_meta(shipment)
        skip = int(meta.get("resume_skip", 0))
        if skip < 0 or skip > int(meta.get("max_tokens", 32)):
            raise ValueError(
                f"resume_skip {skip} outside [0, max_tokens="
                f"{meta.get('max_tokens')}]")
        events = self._events(lambda on_tokens: self.engine.submit_remote(
            shipment, deadline=deadline, on_tokens=on_tokens),
            "tpk-decode-remote-stream")
        timeout = float(meta.get("timeout", 300.0))
        for ev in self._pump(events, timeout, "remote decode stream"):
            if not ev.get("done") and skip:
                dropped = min(skip, len(ev["tokens"]))
                skip -= dropped
                ev = {"tokens": ev["tokens"][dropped:]}
                if not ev["tokens"]:
                    continue
            yield ev

    def _events(self, submit, name: str) -> queue.Queue:
        """Run `submit(on_tokens)` on a thread of its own: its token
        callbacks, then its result or its error, arrive on the queue."""
        events: queue.Queue = queue.Queue()

        def on_tokens(tokens, done):
            events.put(("tok", tokens, done))

        def run():
            try:
                events.put(("final", submit(on_tokens), None))
            except Exception as e:  # surfaced to the consumer
                events.put(("error", e, None))

        threading.Thread(target=run, daemon=True, name=name).start()
        return events

    def _pump(self, events: queue.Queue, timeout: float, what: str):
        """The events of `_events` as {"tokens": [...]} per emitted chunk
        and a final {"done": true, ...summary}, each waited for at most
        until `timeout` plus 10 s from the start."""
        deadline = time.monotonic() + timeout + 10.0
        while True:
            try:
                kind, val, _ = events.get(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except queue.Empty:
                raise RuntimeError(
                    f"{what} timed out after {timeout}s") from None
            if kind == "error":
                raise val
            if kind == "final":
                out = dict(val)
                if self.tokenizer is not None:
                    out["text"] = self._decode_text(out["output_ids"])
                out["decode_tokens_per_sec"] = round(
                    self.engine.throughput(), 2)
                yield {"done": True, **out}
                return
            if val:
                yield {"tokens": [int(t) for t in val]}

    def generate_stream(self, payload: dict):
        """Generator of streaming events: {"tokens": [...]} (plus
        "text_delta" when a tokenizer is set) per emitted chunk, then a
        final {"done": true, ...summary}: chunk-granular, the engine's
        scheduling quantum. Closing the generator leaves the request
        decoding to its end."""
        ids = self._resolve_ids(payload)
        kwargs = self._submit_kwargs(payload)
        events = self._events(lambda on_tokens: self.engine.submit(
            ids, on_tokens=on_tokens, **kwargs), "tpk-generate-stream")
        emitted: list[int] = []
        # Windowed incremental detokenization (the vLLM recipe): decode
        # only from a trailing offset, emit the suffix beyond the
        # previously rendered window, and hold back while the tail is an
        # incomplete codepoint — O(window) per chunk instead of
        # re-decoding the whole prefix (quadratic in output length), and
        # deltas telescope to the exact full decode.
        prefix_off = read_off = 0
        sent_text = ""
        for ev in self._pump(events, kwargs["timeout"], "generation stream"):
            if self.tokenizer is None:
                yield ev
                continue
            if ev.get("done"):
                # Flush anything still held back by the window.
                ev["text_delta"] = (ev["text"][len(sent_text):]
                                    if ev["text"].startswith(sent_text)
                                    else "")
                yield ev
                return
            emitted.extend(ev["tokens"])
            prev = self._decode_text(emitted[prefix_off:read_off])
            text = self._decode_text(emitted[prefix_off:])
            # Emit ONLY when the new rendering strictly extends the
            # previous one and its tail is not a possibly-incomplete
            # codepoint (U+FFFD). Anything else — a held partial, or a
            # rewrite where a completing codepoint replaces an earlier
            # U+FFFD — stays buffered: an emitted delta can never be
            # retracted, and the final event's residue flush delivers
            # whatever was held, so deltas always join to the exact full
            # decode.
            if (len(text) > len(prev) and text.startswith(prev)
                    and not text.endswith("\ufffd")):
                ev["text_delta"] = text[len(prev):]
                prefix_off, read_off = read_off, len(emitted)
            else:
                ev["text_delta"] = ""
            sent_text += ev["text_delta"]
            yield ev

    def predict(self, inputs):
        """Full-forward logits in fp32 (no cache) of token ids [B, S]: the
        v1 :predict and v2 /infer surface of a generative model, as JAX's.
        Ids are checked on the host (an out-of-range id would be a
        device-side assert on CUDA)."""
        self._check_loaded()
        ids = np.asarray(inputs[0], np.int32)
        check_token_ids(ids, self.cfg.vocab_size)
        with torch.inference_mode():
            logits = self._model(torch.from_numpy(ids).to(self._model.device))
        return [logits.float().cpu().numpy()]

    def metadata(self) -> dict:
        md = super().metadata()
        md.update({"generative": True,
                   "max_len": self._gen_cfg.get("max_len", 256),
                   "vocab_size": self.cfg.vocab_size,
                   "stats": self.engine.stats_snapshot() if self.engine else {}})
        if self.engine:
            md["decode_buckets"] = list(self.engine.decode_buckets)
            md["pipeline_depth"] = self.engine.pipeline_depth
            md["speculative"] = self.engine._spec is not None
            md["inflight_depth"] = self.engine.inflight_depth
            md["role"] = self.engine.role
            md["paged_kv"] = self.engine.kv_info()
            md["kv_quant"] = self.engine.kv_quant
            if self.engine.adapter_names():
                md["adapters"] = self.engine.adapter_names()
        if self.quantization is not None:
            md["quantize"] = dict(self.quantization)
        return md
