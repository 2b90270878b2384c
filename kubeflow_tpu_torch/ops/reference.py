"""Reference (einsum) attention — the numerics golden for the fused path.

The port of `kubeflow_tpu/ops/reference.py`: GQA softmax attention with the
full score matrix materialised. Models call it for decode and continuation
chunks (attention over the KV cache), and the CPU tests hold it against the
JAX twin. O(S·T) memory — correct at any size, efficient only at small ones.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def naive_attention(q, k, v, *, causal: bool = True,
                    positions_q=None, positions_kv=None,
                    segment_ids=None, segment_ids_kv=None,
                    mask=None, softcap: float = 0.0,
                    windowed=None, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,T,KH,D] with H % KH == 0; fp32 softmax.

    Causality is masked by absolute positions when given (offset or packed
    sequences), else by array index. `segment_ids` [B,S] (and optionally a
    separate kv set) confine attention within equal-id spans. `mask` (a
    flash_attention.MaskSpec) selects causal/full/prefix_lm/sliding_window,
    overriding `causal`. `softcap` > 0 applies tanh(s/cap)*cap after
    scaling, before masking. `windowed` (a bool tensor) gates a
    sliding_window mask's band: where False the mask degrades to causal.

    Scores are computed in the input dtype and then widened to fp32, and
    the probabilities are cast back to the input dtype before P·V — the
    same rounding points as the JAX twin. Masked scores are the finite
    -1e30, not -inf, so a fully masked row is a uniform average, not NaN.

    `k_scale`/`v_scale` [B,T,KH] fp32 are the per-row scales of a
    quantized cache: k/v arrive as the raw codes cast to the input dtype,
    and the scales land on the score and probability tensors (`scores *
    k_scale` after Q·Kᵀ, `probs * v_scale` before the cast and P·V), so no
    cache-width `[..., T, KH, D]` multiply exists."""
    if (mask is not None and mask.kind == "prefix_lm"
            and segment_ids is not None):
        raise ValueError(
            "prefix_lm mask is incompatible with packed segment_ids: "
            "the prefix boundary is global but packed positions restart "
            "per document")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    group = h // kh
    qg = q.reshape(b, s, kh, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(d)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    dev = q.device
    if mask is not None or causal:
        pq = (positions_q if positions_q is not None
              else torch.arange(s, device=dev)[None])
        pk = (positions_kv if positions_kv is not None
              else torch.arange(t, device=dev)[None])
        rows = pq[:, None, None, :, None]
        cols = pk[:, None, None, None, :]
        kind = "causal" if mask is None else mask.kind
        if kind == "causal":
            m = rows >= cols
        elif kind == "prefix_lm":
            m = (rows >= cols) | (cols < mask.prefix)
        elif kind == "sliding_window":
            band = rows - cols < mask.window
            if windowed is not None:
                band = band | torch.logical_not(torch.as_tensor(
                    windowed, device=dev))
            m = (rows >= cols) & band
        else:  # full
            m = None
        if m is not None:
            scores = torch.where(m, scores, NEG_INF)
    if segment_ids is not None:
        sk = segment_ids_kv if segment_ids_kv is not None else segment_ids
        seg = (segment_ids[:, None, None, :, None]
               == sk[:, None, None, None, :])
        scores = torch.where(seg, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)
