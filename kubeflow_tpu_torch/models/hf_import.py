"""Hugging Face checkpoints: a safetensors reader and writer, and the
imports onto the port's models.

The port of `kubeflow_tpu/models/hf_import.py` for the families on the
Llama trunk (Llama, Llama 3.1's rope scaling, Mistral's window, Qwen2's
QKV biases, Gemma 1/2/3), for BERT (`import_bert`), GPT-2 (`import_gpt2`)
and T5/MT5/UMT5 (`import_t5`), with its own
safetensors codec: the `safetensors` package is not a dependency of this
package.

A safetensors file is an 8-byte little-endian header length N, N bytes of
JSON header ({name: {"dtype", "shape", "data_offsets": [begin, end]}} plus
an optional "__metadata__" of strings), then the tensors' raw bytes,
little-endian, each at [8 + N + begin, 8 + N + end). The reader maps the
file (copy-on-write, so nothing is read until used and nothing is written
back) and returns CPU tensors that view the mapping: an 8B checkpoint's
gigabytes are not copied once more on the host before they reach the card.
A tensor whose bytes are not aligned to its element size is copied. A file
must not be truncated in place while such tensors live (their pages would
fault); `save_safetensors` replaces a file by a rename, never in place.

The Llama import translates names only: HF stores a Linear as [out, in],
the port's layout, so no transposes and no head reshapes; RoPE needs no
permutation (HF Llama rotates halves, as `models/llama.apply_rope`). The
mixture-of-experts families (Mixtral, Qwen2-MoE: `import_mixtral`,
`import_qwen2_moe`) load onto `models/moe.py`, whose expert stacks keep the
JAX layout: each expert's Linear is transposed and stacked.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import struct
import sys
from typing import Any

import torch

from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.gpt2 import GPT2Config
from kubeflow_tpu_torch.models.llama import LlamaConfig, _check_supported
from kubeflow_tpu_torch.models.moe import MoEConfig
from kubeflow_tpu_torch.models.t5 import T5Config

#: safetensors dtype names -> torch dtypes (the F8 names are the torch
#: float8 types of the same encoding).
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
#: The header's size cap (the safetensors format's own, 100 MB).
MAX_HEADER_BYTES = 100_000_000
INDEX_FILE = "model.safetensors.index.json"


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def _parse_header(path: str, size: int, raw: bytes) -> tuple[dict, dict]:
    """({name: (dtype, shape, begin, end)}, metadata) of a header, checked
    against the data section's size."""
    try:
        header = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: unreadable header JSON ({e})") \
            from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    meta = header.pop("__metadata__", None) or {}
    if not isinstance(meta, dict) or not all(
            isinstance(v, str) for v in meta.values()):
        raise SafetensorsError(f"{path}: __metadata__ must map names to "
                               "strings")
    entries = {}
    for name, info in header.items():
        try:
            dtype = DTYPES[info["dtype"]]
        except KeyError:
            raise SafetensorsError(
                f"{path}: tensor {name!r} has unknown dtype "
                f"{info.get('dtype')!r} (have {sorted(DTYPES)})") from None
        except TypeError:
            raise SafetensorsError(f"{path}: tensor {name!r}: entry is not "
                                   "an object") from None
        shape, offs = info.get("shape"), info.get("data_offsets")
        if (not isinstance(shape, list) or not all(
                isinstance(d, int) and d >= 0 for d in shape)):
            raise SafetensorsError(f"{path}: tensor {name!r} has bad shape "
                                   f"{shape!r}")
        if (not isinstance(offs, list) or len(offs) != 2 or not all(
                isinstance(o, int) for o in offs)):
            raise SafetensorsError(f"{path}: tensor {name!r} has bad "
                                   f"data_offsets {offs!r}")
        begin, end = offs
        if not 0 <= begin <= end <= size:
            raise SafetensorsError(
                f"{path}: tensor {name!r} data_offsets {offs} out of range "
                f"of the {size}-byte data section (truncated file?)")
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != math.prod(shape) * itemsize:
            raise SafetensorsError(
                f"{path}: tensor {name!r} spans {end - begin} bytes, its "
                f"{info['dtype']} shape {shape} needs "
                f"{math.prod(shape) * itemsize}")
        entries[name] = (dtype, tuple(shape), begin, end)
    last_end, last = 0, None
    for name, (_, _, begin, end) in sorted(entries.items(),
                                           key=lambda e: e[1][2:]):
        if begin < last_end:
            raise SafetensorsError(f"{path}: tensors {last!r} and {name!r} "
                                   "overlap")
        last_end, last = max(last_end, end), name
    return entries, meta


def load_safetensors(path: str, with_metadata: bool = False):
    """{name: CPU tensor} of one safetensors file (and its __metadata__
    when `with_metadata`). Refuses, by name, a truncated file, a header
    that does not parse, overlapping or out-of-range offsets and an
    unknown dtype."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors files are little-endian; this host "
                           "is not")
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(f"{path}: {size} bytes, shorter than the "
                                   "8-byte header length (truncated file)")
        n = struct.unpack("<Q", head)[0]
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise SafetensorsError(
                f"{path}: header length {n} does not fit the {size}-byte "
                "file (truncated or not a safetensors file)")
        entries, meta = _parse_header(path, size - 8 - n, f.read(n))
        mm = None
        if any(end > begin for _, _, begin, end in entries.values()):
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, (dtype, shape, begin, end) in entries.items():
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                               offset=8 + n + begin)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if raw.data_ptr() % itemsize:
            raw = raw.clone()  # a fresh, aligned buffer
        out[name] = raw.view(dtype).reshape(shape)
    return (out, meta) if with_metadata else out


def save_safetensors(tensors: dict, path: str,
                     metadata: dict | None = None) -> int:
    """Write `tensors` ({name: tensor}, any device) as one safetensors file
    readable by the `safetensors` package; returns the bytes written.
    Tensors are laid out by element size, largest first, then by name, so
    every offset is a multiple of its element size, and the header is
    padded with spaces to a multiple of 8, as the format's own writer
    does."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"tensor {name!r}: dtype {t.dtype} has "
                                   "no safetensors name")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    # Written aside, then renamed over `path`: tensors that still map the
    # old file (this module's reader) keep its bytes; truncating it in
    # place would fault them.
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8)
                        .numpy())
    os.replace(tmp, path)
    return 8 + len(raw) + offset


def safetensors_files(path: str) -> list[str]:
    """The checkpoint files of a directory: the shards its
    model.safetensors.index.json names, else model.safetensors, else every
    *.safetensors file, sorted."""
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(path, s)
                for s in sorted(set(weight_map.values()))]
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    cands = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not cands:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return [os.path.join(path, f) for f in cands]


def load_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """All tensors of a HF checkpoint dir (single-file, sharded with a
    model.safetensors.index.json, or any-named *.safetensors files), as
    CPU tensors. A sharded checkpoint must hold every tensor its index
    names, in the shard the index names."""
    tensors: dict[str, torch.Tensor] = {}
    for file in safetensors_files(path):
        tensors.update(load_safetensors(file))
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        missing = sorted(k for k in weight_map if k not in tensors)
        if missing:
            raise KeyError(f"{INDEX_FILE} names tensors no shard holds: "
                           f"{missing[:8]}")
    return tensors


def read_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Llama family
# ---------------------------------------------------------------------------

_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(LlamaConfig))


def llama_config_from_hf(hf: dict, **overrides: Any) -> LlamaConfig:
    """Map HF LlamaConfig fields onto the port's. `overrides` win (dtype,
    attention_impl, a shorter max_seq_len for serving memory).

    Unsupported config features fail loudly here: importing a checkpoint
    whose math this model does not implement must never give silently
    wrong logits. Qwen2's QKV biases map onto `attention_bias`."""
    unknown = sorted(set(overrides) - _CONFIG_FIELDS)
    if unknown:
        raise ValueError(f"model_overrides {unknown} are not LlamaConfig "
                         "fields")
    heads = hf["num_attention_heads"]
    fields = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        max_seq_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    # Qwen2 ships QKV biases (HF LlamaConfig names attention_bias;
    # Qwen2Config implies it).
    fields["attention_bias"] = bool(
        hf.get("attention_bias", hf.get("model_type") == "qwen2"))
    scaling = hf.get("rope_scaling")
    if scaling:
        rtype = scaling.get("rope_type") or scaling.get("type")
        if rtype not in ("llama3", "default"):
            raise ValueError(
                f"unsupported rope_scaling type {rtype!r} (only the "
                "Llama-3.1 'llama3' frequency remap is implemented)")
        if rtype == "llama3":
            fields.update(
                rope_scaling_factor=float(scaling["factor"]),
                rope_scaling_low_freq_factor=float(
                    scaling.get("low_freq_factor", 1.0)),
                rope_scaling_high_freq_factor=float(
                    scaling.get("high_freq_factor", 4.0)),
                rope_scaling_original_max_len=int(
                    scaling.get("original_max_position_embeddings", 8192)))
    if hf.get("sliding_window") and hf.get("use_sliding_window", True):
        # Mistral's windowed attention: the flash kernel's banded mask.
        # (Qwen2 configs carry a sliding_window with use_sliding_window
        # false, so both fields are read.) The serving engine serves it
        # causal within the window and on a rolling cache past it.
        fields.update(mask_kind="sliding_window",
                      mask_window=int(hf["sliding_window"]),
                      attention_impl="flash")
    fields.update(overrides)
    return LlamaConfig(**fields)


def llama_hf_names(cfg: LlamaConfig) -> dict:
    """{HF tensor name: the port's state-dict key} of a Llama-family
    checkpoint of `cfg` (no lm_head when the embeddings are tied): Qwen2's
    QKV biases with `attention_bias`; with `sandwich_norms`, Gemma-2/3's
    post_attention_layernorm on the attention output (`attn_out_norm`),
    pre_feedforward_layernorm on the MLP input (`post_attn_norm`) and
    post_feedforward_layernorm on the MLP output (`mlp_out_norm`); with
    `qk_norm`, Gemma-3's q_norm and k_norm."""
    names = {"model.embed_tokens.weight": "embed",
             "model.norm.weight": "final_norm.scale"}
    if not cfg.tie_embeddings:  # tied: the unembedding reuses `embed`
        names["lm_head.weight"] = "lm_head.weight"
    norms = {"input_layernorm": "input_norm"}
    if cfg.sandwich_norms:
        norms.update(post_attention_layernorm="attn_out_norm",
                     pre_feedforward_layernorm="post_attn_norm",
                     post_feedforward_layernorm="mlp_out_norm")
    else:
        norms["post_attention_layernorm"] = "post_attn_norm"
    if cfg.qk_norm:
        norms.update({"self_attn.q_norm": "attn.q_norm",
                      "self_attn.k_norm": "attn.k_norm"})
    for i in range(cfg.num_layers):
        hf, port = f"model.layers.{i}.", f"layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj", "o_proj"):
            names[f"{hf}self_attn.{p}.weight"] = f"{port}attn.{p}.weight"
        if cfg.attention_bias:
            for p in ("q_proj", "k_proj", "v_proj"):
                names[f"{hf}self_attn.{p}.bias"] = f"{port}attn.{p}.bias"
        if not isinstance(cfg, MoEConfig):  # the routed MLP: _moe_state_dict
            for p in ("gate_proj", "up_proj", "down_proj"):
                names[f"{hf}mlp.{p}.weight"] = f"{port}mlp.{p}.weight"
        for name, key in norms.items():
            names[f"{hf}{name}.weight"] = f"{port}{key}.scale"
    return names


def _llama_state_dict(t: dict, cfg: LlamaConfig) -> dict:
    """The port's state dict from HF Llama-family tensors: projections and
    the embedding in cfg.storage_dtype, norm scales in fp32. A tensor
    already in its target dtype is the given tensor (no copy)."""
    if not cfg.tie_embeddings and "lm_head.weight" not in t:
        raise KeyError(
            "checkpoint says tie_word_embeddings=false but has no "
            "lm_head.weight — refusing to guess (corrupt export?)")
    sd = {}
    for name, key in llama_hf_names(cfg).items():
        if name not in t:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        sd[key] = t[name].to(torch.float32 if key.endswith(".scale")
                             else cfg.storage_dtype)
    return sd


_LLAMA_FAMILIES = ("Llama", "Mistral", "Qwen2")


def _load(path: str, cfg: LlamaConfig,
          family: str | None = None) -> tuple[LlamaConfig, dict]:
    """(cfg, state dict) of a checkpoint; an MoE `family` ("mixtral" or
    "qwen2_moe", `_moe_family`) names its routed MLP's tensors."""
    _check_supported(cfg)
    t = load_safetensors_dir(path)
    sd = _llama_state_dict(t, cfg)
    if family is not None:
        sd.update(_moe_state_dict(t, cfg, path, family == "qwen2_moe"))
    return cfg, sd


def _llama_config(hf: dict, overrides: dict) -> LlamaConfig:
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if "Qwen2Moe" in arch or not any(f in arch for f in _LLAMA_FAMILIES):
        raise ValueError(f"import_llama: {arch!r} is not a Llama-family "
                         "checkpoint (use build_from_hf)")
    return llama_config_from_hf(hf, **overrides)


def import_llama(path: str, **overrides: Any) -> tuple[LlamaConfig, dict]:
    """HF Llama-family checkpoint dir (Llama, Mistral, Qwen2) ->
    (LlamaConfig, state dict for `Llama(cfg).load_state_dict`). The config
    is checked against what the port implements before any tensor is
    read."""
    return _load(path, _llama_config(read_hf_config(path), overrides))


def _gemma_act(hf: dict, family: str) -> None:
    act = (hf.get("hidden_activation") or hf.get("hidden_act")
           or "gelu_pytorch_tanh")
    if act not in ("gelu_pytorch_tanh", "gelu"):
        # HF treats legacy "gelu" configs as the tanh approximation too
        # (the Gemma release-time config bug); anything else is a model
        # this trunk does not implement.
        raise ValueError(f"unsupported {family} activation {act!r}")


def _tied(cfg: LlamaConfig, family: str, layout: str = "") -> None:
    if not cfg.tie_embeddings:
        raise ValueError(
            f"{family} checkpoints tie embeddings; tie_word_embeddings="
            f"false is not a {layout or family} layout")


def _gemma_config(hf: dict, overrides: dict) -> LlamaConfig:
    arch = (hf.get("architectures") or ["GemmaForCausalLM"])[0]
    if "Gemma" in arch and arch != "GemmaForCausalLM":
        raise ValueError(f"import_gemma cannot load architecture {arch!r}")
    if hf.get("model_type") in ("gemma2", "gemma3", "gemma3_text"):
        raise ValueError(
            f"import_gemma cannot load model_type "
            f"{hf['model_type']!r} (use import_gemma2 / build_from_hf)")
    if arch != "GemmaForCausalLM" and hf.get("model_type") != "gemma":
        raise ValueError(f"import_gemma cannot load architecture {arch!r}")
    _gemma_act(hf, "Gemma")
    fields = dict(
        norm_plus_one=True, embed_scale=True, mlp_act="gelu_tanh",
        # GemmaConfig's class default is tied embeddings; saved configs
        # omit the field (Llama's absent-key default is False).
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
    fields.update(overrides)  # the caller's overrides win, then validate
    cfg = llama_config_from_hf(hf, **fields)
    _tied(cfg, "Gemma", "Gemma-v1")
    return cfg


def import_gemma(path: str, **overrides: Any) -> tuple[LlamaConfig, dict]:
    """HF Gemma (v1) checkpoint dir -> (LlamaConfig, state dict). Gemma is
    the Llama trunk with (1 + w) norms, the sqrt(hidden) embedding scale
    and a tanh-GeLU gate, and tied embeddings; its tensor names are
    Llama's. A Gemma-2/3 checkpoint never imports as v1, whatever its
    architectures or model_type say."""
    return _load(path, _gemma_config(read_hf_config(path), overrides))


def _alternate(cfg: LlamaConfig, pattern: str, overrides: dict):
    """A windowed Gemma-2/3 config marked alternating, with the einsum
    attention path: each only where the caller did not choose it."""
    if cfg.mask_kind != "sliding_window" or "sliding_pattern" in overrides:
        return cfg
    forced = {"sliding_pattern": pattern}
    if "attention_impl" not in overrides:
        forced["attention_impl"] = "naive"
    return dataclasses.replace(cfg, **forced)


def _gemma2_config(hf: dict, overrides: dict) -> LlamaConfig:
    arch = (hf.get("architectures") or [""])[0]
    if hf.get("model_type") in ("gemma3", "gemma3_text") or "Gemma3" in arch:
        raise ValueError(
            f"import_gemma2 cannot load {arch or hf.get('model_type')!r} "
            "(Gemma-3 is not implemented)")
    if not (arch in ("", "Gemma2ForCausalLM")
            or hf.get("model_type") == "gemma2"):
        raise ValueError(f"import_gemma2 cannot load architecture {arch!r}")
    _gemma_act(hf, "Gemma-2")
    lt = hf.get("layer_types")
    if lt is not None:
        want = ["sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(hf["num_hidden_layers"])]
        if list(lt) != want:
            raise ValueError(
                "unsupported Gemma-2 layer_types pattern (expected "
                "alternating sliding/full starting sliding at layer 0)")
    fields = dict(
        norm_plus_one=True, embed_scale=True, mlp_act="gelu_tanh",
        sandwich_norms=True,
        attn_softcap=float(hf.get("attn_logit_softcapping") or 0.0),
        final_softcap=float(hf.get("final_logit_softcapping") or 0.0),
        query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar") or 0.0),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
        attention_impl="naive")
    fields.update(overrides)
    cfg = _alternate(llama_config_from_hf(hf, **fields), "even", overrides)
    _tied(cfg, "Gemma-2")
    return cfg


def import_gemma2(path: str, **overrides: Any) -> tuple[LlamaConfig, dict]:
    """HF Gemma-2 checkpoint dir -> (LlamaConfig, state dict): Gemma's
    conventions plus sandwich norms, the attention and final tanh
    soft-caps, the query_pre_attn_scalar score scale and alternating
    layers (HF layer_types: even layers sliding, odd ones full;
    `sliding_pattern="even"`), on the einsum attention path unless the
    caller overrides it. Within its window the engine serves a causal
    view; past it the cache stays full-length and the sliding layers band
    their reads."""
    return _load(path, _gemma2_config(read_hf_config(path), overrides))


def _gemma3_config(hf: dict, overrides: dict) -> LlamaConfig:
    arch = (hf.get("architectures") or [""])[0]
    if "ConditionalGeneration" in arch or hf.get("vision_config"):
        raise ValueError(
            f"{arch or hf.get('model_type')!r} is multimodal Gemma-3 "
            "(vision tower + text); only text checkpoints "
            "(Gemma3ForCausalLM / gemma3_text) are supported")
    if not (arch in ("", "Gemma3ForCausalLM", "Gemma3TextModel")
            or hf.get("model_type") in ("gemma3", "gemma3_text")):
        raise ValueError(f"import_gemma3 cannot load architecture {arch!r}")
    _gemma_act(hf, "Gemma-3")
    lt = hf.get("layer_types")
    if lt is not None:
        want = ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                for i in range(hf["num_hidden_layers"])]
        if list(lt) != want:
            raise ValueError(
                "unsupported Gemma-3 layer_types pattern (expected 5 "
                "sliding : 1 full, full at every 6th layer)")
    elif int(hf.get("sliding_window_pattern", 6)) != 6:
        # Release-era configs carry sliding_window_pattern instead of
        # layer_types; any other period puts the full layers elsewhere.
        raise ValueError(
            f"unsupported sliding_window_pattern "
            f"{hf['sliding_window_pattern']} (only the 5:1 interleave "
            "is implemented)")
    scaling = hf.get("rope_scaling")
    linear_factor = 1.0
    if scaling:
        rtype = scaling.get("rope_type") or scaling.get("type")
        if rtype != "linear":
            raise ValueError(
                f"unsupported Gemma-3 rope_scaling type {rtype!r} "
                "(global layers use 'linear')")
        linear_factor = float(scaling.get("factor", 1.0))
    fields = dict(
        norm_plus_one=True, embed_scale=True, mlp_act="gelu_tanh",
        sandwich_norms=True, qk_norm=True,
        query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar") or 0.0),
        rope_theta_local=float(hf.get("rope_local_base_freq", 10000.0)),
        rope_global_scaling_factor=linear_factor,
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
        attention_impl="naive")
    fields.update(overrides)
    # llama_config_from_hf reads rope_scaling as Llama-3.1's; Gemma-3's
    # linear scaling is taken above, so shadow it.
    cfg = _alternate(llama_config_from_hf(dict(hf, rope_scaling=None),
                                          **fields), "5to1", overrides)
    _tied(cfg, "Gemma-3")
    return cfg


def import_gemma3(path: str, **overrides: Any) -> tuple[LlamaConfig, dict]:
    """HF Gemma-3 text checkpoint dir -> (LlamaConfig, state dict): Gemma-2
    without the soft-caps, plus qk-norms, the 5:1 local/global interleave
    (`sliding_pattern="5to1"`: every 6th layer full) and two RoPE bases
    (rope_local_base_freq on sliding layers, rope_theta with an optional
    linear scaling on full ones). Multimodal Gemma-3 (a vision tower) is
    refused: this imports the text stack only."""
    return _load(path, _gemma3_config(read_hf_config(path), overrides))


# ---------------------------------------------------------------------------
# Mixture of experts (Mixtral, Qwen2-MoE)
# ---------------------------------------------------------------------------

_MOE_FIELDS = frozenset(f.name for f in dataclasses.fields(MoEConfig))


def _moe_config(base: LlamaConfig, overrides: dict, **fields) -> MoEConfig:
    """`base`'s fields plus the MoE ones, then the caller's overrides (MoE
    fields included), as the JAX importers replace them last."""
    unknown = sorted(set(overrides) - _MOE_FIELDS)
    if unknown:
        raise ValueError(f"model_overrides {unknown} are not MoEConfig "
                         "fields")
    cfg = MoEConfig(**{**{f.name: getattr(base, f.name)
                          for f in dataclasses.fields(base) if f.init},
                       **fields})
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _mixtral_config(hf: dict, overrides: dict) -> MoEConfig:
    arch = (hf.get("architectures") or ["MixtralForCausalLM"])[0]
    if "Mixtral" not in arch:
        raise ValueError(f"import_mixtral cannot load architecture {arch!r}")
    e, k = int(hf["num_local_experts"]), int(hf["num_experts_per_tok"])
    return _moe_config(
        llama_config_from_hf(hf), overrides, num_experts=e,
        experts_per_token=k, capacity_factor=e / k,
        router_aux_coef=float(hf.get("router_aux_loss_coef", 0.01)))


def import_mixtral(path: str, **overrides: Any) -> tuple[MoEConfig, dict]:
    """HF Mixtral checkpoint dir -> (MoEConfig, state dict for
    `MoELlama(cfg)`). HF Mixtral routes softmax, top-k, renormalise over
    all experts (`gshard_route`'s recipe) and serves DROPLESS, so the
    config pins capacity_factor = E/K (capacity = S per expert: nothing
    drops). Per layer: `block_sparse_moe.gate` [E, H] becomes the router
    [H, E] (fp32), experts' w1/w3 [M, H] `w_gate`/`w_up` [E, H, M], w2
    [H, M] `w_down` [E, M, H]."""
    return _load(path, _mixtral_config(read_hf_config(path), overrides),
                 "mixtral")


def _qwen2_moe_config(hf: dict, overrides: dict) -> MoEConfig:
    arch = (hf.get("architectures") or [""])[0]
    if not ("Qwen2Moe" in arch or hf.get("model_type") == "qwen2_moe"):
        raise ValueError(
            f"import_qwen2_moe cannot load architecture {arch!r}")
    if hf.get("mlp_only_layers"):
        raise ValueError(
            f"mlp_only_layers={hf['mlp_only_layers']}: dense layers "
            "interleaved into the MoE trunk are not supported (the "
            "scanned trunk is homogeneous)")
    if int(hf.get("decoder_sparse_step", 1)) != 1:
        raise ValueError(
            f"decoder_sparse_step={hf['decoder_sparse_step']}: only "
            "every-layer-sparse checkpoints are supported")
    e, k = int(hf["num_experts"]), int(hf["num_experts_per_tok"])
    base = llama_config_from_hf(hf, attention_bias=True)
    # The dense intermediate_size is the shared expert's width; routed
    # experts use moe_intermediate_size.
    base = dataclasses.replace(
        base, intermediate_size=int(hf["moe_intermediate_size"]))
    return _moe_config(
        base, overrides, num_experts=e, experts_per_token=k,
        capacity_factor=e / k,  # dropless (see import_mixtral)
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
        shared_expert_size=int(hf["shared_expert_intermediate_size"]),
        router_aux_coef=float(hf.get("router_aux_loss_coef", 0.001)))


def import_qwen2_moe(path: str, **overrides: Any) -> tuple[MoEConfig, dict]:
    """HF Qwen2-MoE checkpoint dir -> (MoEConfig, state dict for
    `MoELlama(cfg)`): Mixtral's recipe (dropless at E/K) plus the shared
    expert (an always-on SwiGLU of `shared_expert_intermediate_size`
    scaled by a sigmoid gate, `shared_expert_gate` [1, H] -> [H, 1]),
    `norm_topk_prob` (false by default: raw softmax mass), Qwen2's QKV
    biases and expert width `moe_intermediate_size`. Heterogeneous layouts
    (`mlp_only_layers`, `decoder_sparse_step` != 1) are refused, and so is
    a dense Qwen2 checkpoint labelled qwen2_moe."""
    return _load(path, _qwen2_moe_config(read_hf_config(path), overrides),
                 "qwen2_moe")


def _moe_family(hf: dict) -> str | None:
    """"mixtral", "qwen2_moe" or None: the JAX dispatch's tests."""
    arch = (hf.get("architectures") or [hf.get("model_type", "")])[0]
    mtype = hf.get("model_type", "")
    if "Mixtral" in arch or mtype == "mixtral":
        return "mixtral"
    if "Qwen2Moe" in arch or mtype == "qwen2_moe":
        return "qwen2_moe"
    return None


def _moe_state_dict(t: dict, cfg: MoEConfig, path: str, qwen: bool) -> dict:
    """The routed MLP's leaves (models/moe.py names, the JAX layout) from
    HF Mixtral or Qwen2-MoE tensors: the router in fp32, expert and
    shared leaves transposed to [in, out] and stacked, in the storage
    dtype."""
    if qwen and "model.layers.0.mlp.gate.weight" not in t:
        raise ValueError(
            f"config at {path!r} says qwen2_moe but the checkpoint has "
            "no expert router tensors (model.layers.*.mlp.gate.weight) — "
            "a dense-Qwen2 or truncated export mislabeled as MoE")
    block = "mlp" if qwen else "block_sparse_moe"
    names = (("gate_proj", "up_proj", "down_proj") if qwen
             else ("w1", "w3", "w2"))
    dt = cfg.storage_dtype

    def get(name):
        if name not in t:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        return t[name]

    sd = {}
    for i in range(cfg.num_layers):
        hf, port = f"model.layers.{i}.{block}.", f"layers.{i}.mlp."
        sd[port + "router"] = get(hf + "gate.weight").t().float().contiguous()
        for leaf, name in zip(("w_gate", "w_up", "w_down"), names):
            sd[port + leaf] = torch.stack([
                get(f"{hf}experts.{e}.{name}.weight").t().to(dt)
                for e in range(cfg.num_experts)])
        if qwen and cfg.shared_expert_size:
            for leaf, name in (("w_shared_gate", "shared_expert.gate_proj"),
                               ("w_shared_up", "shared_expert.up_proj"),
                               ("w_shared_down", "shared_expert.down_proj"),
                               ("shared_gate", "shared_expert_gate")):
                sd[port + leaf] = get(f"{hf}{name}.weight").t().to(
                    dt).contiguous()
    return sd


def hf_tensors(sd: dict, cfg: LlamaConfig,
               family: str | None = None) -> dict:
    """The inverse of the import: a Llama-family state dict of `cfg` as
    {HF tensor name: tensor}, for an MoE `family` ("mixtral",
    "qwen2_moe") each expert's Linear split out of its stack and
    transposed back to [out, in]. Writes synthetic checkpoints."""
    out = {h: sd[k] for h, k in llama_hf_names(cfg).items()}
    if family is None:
        return out
    qwen = family == "qwen2_moe"
    block = "mlp" if qwen else "block_sparse_moe"
    names = (("gate_proj", "up_proj", "down_proj") if qwen
             else ("w1", "w3", "w2"))
    for i in range(cfg.num_layers):
        hf, port = f"model.layers.{i}.{block}.", f"layers.{i}.mlp."
        out[hf + "gate.weight"] = sd[port + "router"].t().contiguous()
        for leaf, name in zip(("w_gate", "w_up", "w_down"), names):
            for e in range(cfg.num_experts):
                out[f"{hf}experts.{e}.{name}.weight"] = sd[
                    port + leaf][e].t().contiguous()
        if qwen and cfg.shared_expert_size:
            for leaf, name in (("w_shared_gate", "shared_expert.gate_proj"),
                               ("w_shared_up", "shared_expert.up_proj"),
                               ("w_shared_down", "shared_expert.down_proj"),
                               ("shared_gate", "shared_expert_gate")):
                out[f"{hf}{name}.weight"] = sd[port + leaf].t().contiguous()
    return out


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def _bert_task_from_arch(hf: dict) -> str:
    """HF `architectures` -> serving task: ForSequenceClassification /
    ForTokenClassification / ForMaskedLM (or ForPreTraining) / a bare
    BertModel -> embedding. Other head architectures (QuestionAnswering,
    MultipleChoice, ...) are refused: their classifier would be misapplied
    as a sequence-classification head."""
    arch = (hf.get("architectures") or [""])[0]
    if "TokenClassification" in arch:
        return "token_classification"
    if "MaskedLM" in arch or "PreTraining" in arch:
        return "fill_mask"
    if "SequenceClassification" in arch:
        return "sequence_classification"
    if arch in ("BertModel", ""):
        # A bare encoder export serves sentence embeddings (HF configs carry
        # a default id2label even here, so the architecture decides).
        return "embedding"
    raise ValueError(
        f"unsupported BERT head architecture {arch!r}; implemented tasks: "
        "sequence_classification, token_classification, fill_mask, "
        "embedding (pass model_overrides={'task': ...} to force one)")


def bert_config_from_hf(hf: dict, **overrides: Any) -> BertConfig:
    """Map HF BertConfig fields onto the port's; `overrides` win."""
    pet = hf.get("position_embedding_type", "absolute")
    if pet != "absolute":
        raise ValueError(
            f"unsupported position_embedding_type {pet!r} (only absolute "
            "position embeddings are implemented)")
    act = hf.get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu"):
        raise ValueError(f"unsupported hidden_act {act!r}")
    fields = dict(
        task=_bert_task_from_arch(hf),
        hidden_act=act,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        max_seq_len=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
        num_labels=len(hf.get("id2label") or {0: 0, 1: 1}),
    )
    fields.update(overrides)
    return BertConfig(**fields)


def bert_hf_names(cfg: BertConfig, prefix: str = "bert.") -> dict:
    """{port state-dict name: HF tensor name} of a checkpoint of `cfg`'s
    task (`prefix` on the encoder's names; the heads carry none). HF
    stores a Linear as [out, in], the port's layout, and a LayerNorm's
    weight is the port's `scale`."""
    names = {f"{n}": f"{prefix}embeddings.{n}.weight"
             for n in ("word_embeddings", "position_embeddings",
                       "token_type_embeddings")}

    def add(port, hf, norm=False):
        names[port + (".scale" if norm else ".weight")] = hf + ".weight"
        names[port + ".bias"] = hf + ".bias"

    add("ln_embed", prefix + "embeddings.LayerNorm", norm=True)
    for i in range(cfg.num_layers):
        hp, key = f"{prefix}encoder.layer.{i}.", f"layers.{i}."
        for port, hf in (("q", "attention.self.query"),
                         ("k", "attention.self.key"),
                         ("v", "attention.self.value"),
                         ("o", "attention.output.dense"),
                         ("ffn_in", "intermediate.dense"),
                         ("ffn_out", "output.dense")):
            add(key + port, hp + hf)
        add(key + "ln_attn", hp + "attention.output.LayerNorm", norm=True)
        add(key + "ln_ffn", hp + "output.LayerNorm", norm=True)
    if cfg.task == "fill_mask":
        add("mlm_transform", "cls.predictions.transform.dense")
        add("mlm_ln", "cls.predictions.transform.LayerNorm", norm=True)
        names["mlm_bias"] = "cls.predictions.bias"
    if cfg.task in ("sequence_classification", "token_classification"):
        add("classifier", "classifier")
    if cfg.task == "sequence_classification" and cfg.use_pooler:
        add("pooler", prefix + "pooler.dense")
    return names


def import_bert(path: str, *, allow_headless: bool = False,
                **config_overrides: Any) -> tuple[BertConfig, dict]:
    """HF BERT checkpoint dir -> (BertConfig, state dict for `Bert(cfg)`),
    the task from the checkpoint's `architectures`: the sequence or token
    classification head, the tied MLM head, or the parameter-free
    embedding pooling of a bare encoder. Names are translated
    (`bert_hf_names`), nothing is transposed.

    A sequence-classification checkpoint without `classifier.weight`
    raises unless `allow_headless` (a zero head serves constant logits;
    it is only for fine-tuning a fresh head). A missing pooler alone is
    not headless: such an export serves with `use_pooler=False`, the
    classifier on the raw [CLS] state. The encoder's `bert.` prefix is
    optional. An MLM decoder not tied to `word_embeddings` is refused."""
    cfg = bert_config_from_hf(read_hf_config(path), **config_overrides)
    t = load_safetensors_dir(path)
    pre = "bert." if any(k.startswith("bert.") for k in t) else ""
    headless = False
    if cfg.task == "fill_mask":
        dec = "cls.predictions.decoder.weight"
        if dec in t and not torch.equal(
                t[dec], t[pre + "embeddings.word_embeddings.weight"]):
            raise ValueError(
                "MaskedLM checkpoint has an UNTIED decoder weight; the "
                "MLM head ties the decoder to word_embeddings")
    elif cfg.task == "sequence_classification":
        headless = "classifier.weight" not in t
        if headless and not allow_headless:
            raise KeyError(
                "checkpoint has no classification head (classifier.weight)"
                " — serving it would return constant zero logits; pass "
                "allow_headless=True only to fine-tune a fresh head")
        if pre + "pooler.dense.weight" not in t:
            cfg = dataclasses.replace(cfg, use_pooler=False)
    sd = {}
    for port, hf in bert_hf_names(cfg, pre).items():
        if headless and port == "classifier.weight":
            sd[port] = torch.zeros(cfg.num_labels, cfg.hidden_size)
        elif headless and port == "classifier.bias":
            sd[port] = torch.zeros(cfg.num_labels)
        else:
            sd[port] = t[hf]
    pd = cfg.param_dtype
    return cfg, {k: v.to(pd) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

def gpt2_config_from_hf(hf: dict, **overrides: Any) -> GPT2Config:
    """Map HF GPT2Config fields onto the port's; `overrides` win. The
    attention variants this model does not implement are refused, never
    imported with plain 1/sqrt(d) scaling (silently wrong logits)."""
    act = hf.get("activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported activation_function {act!r}")
    if not hf.get("scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False is not implemented")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if hf.get(flag):
            raise ValueError(f"{flag}=true is not implemented")
    fields = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        num_layers=hf["n_layer"],
        num_heads=hf["n_head"],
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        max_seq_len=hf.get("n_positions", 1024),
        layer_norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
    )
    fields.update(overrides)
    return GPT2Config(**fields)


def _gpt2_state_dict(t: dict, cfg: GPT2Config) -> dict:
    """The port's GPT-2 state dict from HF tensors. HF's Conv1D stores
    [in, out], so every projection is transposed to [out, in], and the
    fused c_attn [H, 3H] splits into q/k/v thirds; the `transformer.`
    prefix is optional and a tied lm_head is not read. Projections and
    tables in cfg.storage_dtype, LayerNorms in fp32."""
    pre = ("transformer."
           if any(k.startswith("transformer.") for k in t) else "")
    dt, f32 = cfg.storage_dtype, torch.float32

    def get(name):
        if pre + name not in t:
            raise KeyError(f"checkpoint has no tensor {pre + name!r}")
        return t[pre + name]

    def ln(key, name):
        sd[key + ".scale"] = get(name + ".weight").to(f32)
        sd[key + ".bias"] = get(name + ".bias").to(f32)

    def conv(key, weight, bias):
        sd[key + ".weight"] = weight.t().to(dt).contiguous()
        sd[key + ".bias"] = bias.to(dt)

    sd = {"wte": get("wte.weight").to(dt), "wpe": get("wpe.weight").to(dt)}
    ln("ln_f", "ln_f")
    for i in range(cfg.num_layers):
        hf, port = f"h.{i}.", f"blocks.{i}."
        qkv_w = get(hf + "attn.c_attn.weight").split(cfg.hidden_size, dim=1)
        qkv_b = get(hf + "attn.c_attn.bias").split(cfg.hidden_size)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            conv(port + name, qkv_w[j], qkv_b[j])
        conv(port + "o_proj", get(hf + "attn.c_proj.weight"),
             get(hf + "attn.c_proj.bias"))
        conv(port + "fc", get(hf + "mlp.c_fc.weight"),
             get(hf + "mlp.c_fc.bias"))
        conv(port + "proj", get(hf + "mlp.c_proj.weight"),
             get(hf + "mlp.c_proj.bias"))
        ln(port + "ln_1", hf + "ln_1")
        ln(port + "ln_2", hf + "ln_2")
    return sd


def gpt2_hf_tensors(sd: dict, cfg: GPT2Config) -> dict:
    """The inverse of the import: a GPT-2 state dict as HF GPT2LMHeadModel
    tensors (Conv1D [in, out] layout, fused c_attn, `transformer.`
    prefix, the tied lm_head written out as HF saves it). Writes synthetic
    checkpoints."""
    pre = "transformer."
    out = {pre + "wte.weight": sd["wte"], pre + "wpe.weight": sd["wpe"],
           "lm_head.weight": sd["wte"]}

    def ln(name, key):
        out[pre + name + ".weight"] = sd[key + ".scale"]
        out[pre + name + ".bias"] = sd[key + ".bias"]

    ln("ln_f", "ln_f")
    for i in range(cfg.num_layers):
        hf, port = f"h.{i}.", f"blocks.{i}."
        out[pre + hf + "attn.c_attn.weight"] = torch.cat(
            [sd[port + p + ".weight"].t() for p in
             ("q_proj", "k_proj", "v_proj")], dim=1).contiguous()
        out[pre + hf + "attn.c_attn.bias"] = torch.cat(
            [sd[port + p + ".bias"] for p in ("q_proj", "k_proj", "v_proj")])
        for name, key in (("attn.c_proj", "o_proj"), ("mlp.c_fc", "fc"),
                          ("mlp.c_proj", "proj")):
            out[pre + hf + name + ".weight"] = sd[
                port + key + ".weight"].t().contiguous()
            out[pre + hf + name + ".bias"] = sd[port + key + ".bias"]
        ln(hf + "ln_1", port + "ln_1")
        ln(hf + "ln_2", port + "ln_2")
    return out


def import_gpt2(path: str, **overrides: Any) -> tuple[GPT2Config, dict]:
    """HF GPT2LMHeadModel checkpoint dir -> (GPT2Config, state dict for
    `GPT2(cfg)`)."""
    cfg = gpt2_config_from_hf(read_hf_config(path), **overrides)
    return cfg, _gpt2_state_dict(load_safetensors_dir(path), cfg)


# ---------------------------------------------------------------------------
# T5 / MT5 / UMT5
# ---------------------------------------------------------------------------

_T5_ARCHS = ("T5ForConditionalGeneration", "MT5ForConditionalGeneration",
             "UMT5ForConditionalGeneration")


def t5_config_from_hf(hf: dict, **overrides: Any) -> T5Config:
    """Map HF T5Config fields onto the port's; `overrides` win. UMT5 (a
    table per layer) is detected through model_type OR the architecture,
    as the dispatch detects it: an UMT5 architecture with a stale
    model_type must not import with block 0's table shared."""
    proj = hf.get("feed_forward_proj", "relu")
    if proj not in ("relu", "gated-gelu"):
        raise ValueError(f"unsupported feed_forward_proj {proj!r}")
    fields = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        d_kv=hf["d_kv"],
        d_ff=hf["d_ff"],
        num_layers=hf["num_layers"],
        num_decoder_layers=hf.get("num_decoder_layers", hf["num_layers"]),
        num_heads=hf["num_heads"],
        rel_buckets=hf.get("relative_attention_num_buckets", 32),
        rel_max_distance=hf.get("relative_attention_max_distance", 128),
        layer_norm_eps=float(hf.get("layer_norm_epsilon", 1e-6)),
        feed_forward_proj=proj,
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
        decoder_start_id=int(hf.get("decoder_start_token_id") or 0),
        eos_id=int(hf.get("eos_token_id") or 1),
        per_layer_rel_bias=(
            hf.get("model_type") == "umt5"
            or "UMT5" in (hf.get("architectures") or [""])[0]),
    )
    fields.update(overrides)
    return T5Config(**fields)


def t5_hf_names(cfg: T5Config) -> dict:
    """{port state-dict name: HF tensor name} of a T5ForConditional-
    Generation checkpoint of `cfg`. HF stores each Linear as [out, in],
    the port's layout, so names translate and nothing transposes. The
    relative-position tables are block 0's of each stack (every block's
    under UMT5)."""
    names = {"shared": "shared.weight",
             "enc_final_ln.scale": "encoder.final_layer_norm.weight",
             "dec_final_ln.scale": "decoder.final_layer_norm.weight"}
    if not cfg.tie_embeddings:
        names["lm_head.weight"] = "lm_head.weight"
    ffn = ("wi_0", "wi_1", "wo") if cfg.gated else ("wi", "wo")

    def rel(port, stem):
        names[port + ".table"] = (
            stem + ".SelfAttention.relative_attention_bias.weight")

    def attn(port, stem):
        for p in ("q", "k", "v", "o"):
            names[f"{port}.{p}.weight"] = f"{stem}.{p}.weight"

    def block(port, stem):
        for p in ffn:
            names[f"{port}.{p}.weight"] = f"{stem}.DenseReluDense.{p}.weight"

    if not cfg.per_layer_rel_bias:
        rel("enc_rel", "encoder.block.0.layer.0")
        rel("dec_rel", "decoder.block.0.layer.0")
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        if cfg.per_layer_rel_bias:
            rel(f"enc_rels.{i}", f"{b}.0")
        attn(f"enc_attn.{i}", f"{b}.0.SelfAttention")
        names[f"enc_attn_ln.{i}.scale"] = f"{b}.0.layer_norm.weight"
        block(f"enc_ffn.{i}", f"{b}.1")
        names[f"enc_ffn_ln.{i}.scale"] = f"{b}.1.layer_norm.weight"
    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}.layer"
        if cfg.per_layer_rel_bias:
            rel(f"dec_rels.{i}", f"{b}.0")
        attn(f"dec_self.{i}", f"{b}.0.SelfAttention")
        names[f"dec_self_ln.{i}.scale"] = f"{b}.0.layer_norm.weight"
        attn(f"dec_cross.{i}", f"{b}.1.EncDecAttention")
        names[f"dec_cross_ln.{i}.scale"] = f"{b}.1.layer_norm.weight"
        block(f"dec_ffn.{i}", f"{b}.2")
        names[f"dec_ffn_ln.{i}.scale"] = f"{b}.2.layer_norm.weight"
    return names


def import_t5(path: str, **overrides: Any) -> tuple[T5Config, dict]:
    """HF T5/MT5/UMT5 ForConditionalGeneration checkpoint dir ->
    (T5Config, state dict for `T5(cfg)`): projections and `shared` (and an
    untied lm_head) in cfg.storage_dtype, norm scales and the
    relative-position tables in fp32. A classic-T5 checkpoint labelled
    UMT5 fails on the missing per-layer tables (KeyError), never imports
    with one table shared."""
    cfg = t5_config_from_hf(read_hf_config(path), **overrides)
    return cfg, _t5_state_dict(load_safetensors_dir(path), cfg)


def _t5_state_dict(t: dict, cfg: T5Config) -> dict:
    sd = {}
    for port, name in t5_hf_names(cfg).items():
        if name not in t:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        keep_fp32 = port.endswith((".scale", ".table"))
        sd[port] = t[name].to(torch.float32 if keep_fp32
                              else cfg.storage_dtype)
    return sd


def _is_bert(hf: dict) -> bool:
    arch = (hf.get("architectures") or [hf.get("model_type", "")])[0]
    return "Bert" in arch or hf.get("model_type") == "bert"


def config_from_hf(hf: dict, **overrides: Any):
    """The config `build_from_hf` gives a checkpoint whose config.json is
    `hf`, with every refusal, without reading a tensor, in the JAX
    `build_from_hf`'s dispatch order: BERT first (a `BertConfig`; whether
    the checkpoint has a pooler shows only in its tensors), GPT-2 (a
    `GPT2Config`), T5/MT5/UMT5 by exact architecture or model_type (a
    `T5Config`), Mixtral, the Gemmas, Qwen2-MoE (`MoEConfig` for the two
    MoE families), the catch-all refusal of other T5 variants, else a
    Llama-family `LlamaConfig`."""
    if _is_bert(hf):
        overrides.pop("allow_headless", None)
        return bert_config_from_hf(hf, **overrides)
    arch = (hf.get("architectures") or [hf.get("model_type", "")])[0]
    mtype = hf.get("model_type", "")
    if arch == "GPT2LMHeadModel" or mtype == "gpt2":
        return gpt2_config_from_hf(hf, **overrides)
    if arch in _T5_ARCHS or mtype in ("t5", "mt5", "umt5"):
        return t5_config_from_hf(hf, **overrides)
    family = _moe_family(hf)
    if family == "mixtral":
        return _mixtral_config(hf, overrides)
    if "Gemma3" in arch or mtype in ("gemma3", "gemma3_text"):
        return _gemma3_config(hf, overrides)
    if arch == "Gemma2ForCausalLM" or mtype == "gemma2":
        return _gemma2_config(hf, overrides)
    if "Gemma" in arch and arch != "GemmaForCausalLM":
        # Any other non-v1 Gemma variant: refuse rather than guess.
        raise ValueError(f"unsupported architecture {arch!r}")
    if arch == "GemmaForCausalLM" or mtype == "gemma":
        return _gemma_config(hf, overrides)
    if family == "qwen2_moe":
        return _qwen2_moe_config(hf, overrides)
    if "T5" in arch or mtype.endswith("t5"):
        # Future T5 variants, declared by architecture or model_type alone:
        # the Llama import would fail on a missing tensor instead.
        raise ValueError(
            f"unsupported T5-family architecture {arch!r} "
            "(T5/MT5/UMT5 are implemented)")
    return _llama_config(hf, overrides)


def build_from_hf(path: str, **overrides: Any) -> tuple[Any, dict]:
    """Architecture-dispatched import (`config_from_hf`): (BertConfig,
    state dict) for BERT, (GPT2Config, ...) for GPT-2, (T5Config, ...) for
    T5/MT5/UMT5, else (LlamaConfig or MoEConfig, state dict). Callers
    build the model from the config's type (`models.moe.causal_lm` builds
    any causal LM)."""
    hf = read_hf_config(path)
    if _is_bert(hf):
        return import_bert(path, **overrides)
    cfg = config_from_hf(hf, **overrides)
    if isinstance(cfg, GPT2Config):
        return cfg, _gpt2_state_dict(load_safetensors_dir(path), cfg)
    if isinstance(cfg, T5Config):
        return cfg, _t5_state_dict(load_safetensors_dir(path), cfg)
    return _load(path, cfg,
                 _moe_family(hf) if isinstance(cfg, MoEConfig) else None)
