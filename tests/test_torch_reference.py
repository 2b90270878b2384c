"""Port `naive_attention` against the JAX twin at fp32 on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu.ops.reference import naive_attention as jax_naive
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops.reference import naive_attention as torch_naive

B, S, D = 2, 12, 8

# (id, heads, kv heads, kwargs) — positions/segments are built per case.
CASES = [
    ("group1_index_causal", 2, 2, {}),
    ("group2_index_causal", 4, 2, {}),
    ("group4_index_causal", 4, 1, {}),
    ("not_causal", 4, 2, {"causal": False}),
    ("decode_positions", 4, 2, {"decode": True}),
    ("offset_positions", 4, 2, {"offset": 5}),
    ("segments", 4, 2, {"segments": True}),
    ("segments_kv", 4, 2, {"segments": True, "segments_kv": True}),
    ("mask_causal", 4, 2, {"mask": ("causal", {})}),
    ("mask_full", 4, 2, {"mask": ("full", {})}),
    ("mask_prefix_lm", 4, 2, {"mask": ("prefix_lm", {"prefix": 5})}),
    ("mask_sliding", 4, 2, {"mask": ("sliding_window", {"window": 3})}),
    ("mask_sliding_windowed_true", 4, 2,
     {"mask": ("sliding_window", {"window": 3}), "windowed": True}),
    ("mask_sliding_windowed_false", 4, 2,
     {"mask": ("sliding_window", {"window": 3}), "windowed": False}),
    ("mask_sliding_segments", 4, 2,
     {"mask": ("sliding_window", {"window": 4}), "segments": True}),
    ("softcap", 4, 2, {"softcap": 2.0}),
]


@pytest.mark.parametrize("h,kh,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_naive_attention_matches_jax(h, kh, kw):
    rng = np.random.default_rng(0)
    decode = kw.get("decode", False)
    s = 1 if decode else S
    q = rng.standard_normal((B, s, h, D)).astype(np.float32)
    k = rng.standard_normal((B, S, kh, D)).astype(np.float32)
    v = rng.standard_normal((B, S, kh, D)).astype(np.float32)
    jargs, targs = {}, {}
    if decode:  # one query per row at its own cache offset
        pq = np.array([[4], [9]], np.int32)
        pk = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        jargs.update(positions_q=jnp.asarray(pq), positions_kv=jnp.asarray(pk))
        targs.update(positions_q=torch.from_numpy(pq),
                     positions_kv=torch.from_numpy(pk))
    if "offset" in kw:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32) + kw["offset"],
                              (B, S)).copy()
        jargs.update(positions_q=jnp.asarray(pos), positions_kv=jnp.asarray(pos))
        targs.update(positions_q=torch.from_numpy(pos),
                     positions_kv=torch.from_numpy(pos))
    if kw.get("segments"):
        seg = np.cumsum(rng.random((B, S)) < 0.3, axis=1).astype(np.int32)
        jargs["segment_ids"] = jnp.asarray(seg)
        targs["segment_ids"] = torch.from_numpy(seg)
        if kw.get("segments_kv"):
            skv = seg.copy()
            skv[:, -3:] = -1  # padded keys never match a real segment
            jargs["segment_ids_kv"] = jnp.asarray(skv)
            targs["segment_ids_kv"] = torch.from_numpy(skv)
    if "mask" in kw:
        kind, mkw = kw["mask"]
        jargs["mask"] = jfa.MaskSpec(kind, **mkw)
        targs["mask"] = tfa.MaskSpec(kind, **mkw)
    if "windowed" in kw:
        jargs["windowed"] = jnp.asarray(kw["windowed"])
        targs["windowed"] = torch.tensor(kw["windowed"])
    for key in ("causal", "softcap"):
        if key in kw:
            jargs[key] = targs[key] = kw[key]
    want = np.asarray(jax_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **jargs))
    got = torch_naive(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), **targs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_naive_attention_refuses_prefix_lm_with_segments():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="prefix_lm"):
        torch_naive(x, x, x, mask=tfa.MaskSpec("prefix_lm", prefix=2),
                    segment_ids=torch.zeros(1, 4, dtype=torch.int32))
