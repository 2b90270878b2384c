"""PEFT LoRA adapters: an HF `adapter_model.safetensors` onto the port's
adapter parameters.

The port of `kubeflow_tpu/models/peft_import.py`. A PEFT adapter dir
(`adapter_config.json` + `adapter_model.safetensors`) becomes the port's
`<proj>_lora_a` / `<proj>_lora_b` parameters (models/llama.py), which use
PEFT's own layouts, A [r, in] and B [out, r]: the import renames and
casts, with no transposes and no head reshapes. Run the adapted model
directly (`Llama(adapted_cfg)`), or fold it flat with `train/lora.merge`
and serve a plain base model. Scaling is PEFT's alpha/r; every adapter
feature the model does not implement is refused by name, never dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from kubeflow_tpu_torch.models.hf_import import load_safetensors_dir
from kubeflow_tpu_torch.models.llama import LlamaConfig

#: target_modules set -> the port's lora_targets mode.
TARGET_MODES = {
    frozenset({"q_proj", "v_proj"}): "attn",
    frozenset({"q_proj", "v_proj", "gate_proj", "up_proj",
               "down_proj"}): "attn_mlp",
}
#: A Llama layer's projections, as PEFT names them, with their block.
_MODULES = {"q_proj": "self_attn", "k_proj": "self_attn",
            "v_proj": "self_attn", "o_proj": "self_attn",
            "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}
_PORT_BLOCK = {"self_attn": "attn", "mlp": "mlp"}


def read_adapter_config(path: str) -> dict:
    with open(os.path.join(path, "adapter_config.json")) as f:
        return json.load(f)


def _targets(raw) -> frozenset:
    """PEFT's target_modules as a set of projection names. The string
    form is a regex FULLMATCHED against the full dotted module path
    (peft.tuners.tuners_utils), or the bare name."""
    if not isinstance(raw, str):
        return frozenset(raw or ())

    def hits(m):
        return (re.fullmatch(raw, f"model.layers.0.{_MODULES[m]}.{m}")
                or re.fullmatch(raw, m))

    return frozenset(m for m in _MODULES if hits(m))


def load_peft_adapter(path: str, cfg) -> tuple[LlamaConfig, dict]:
    """(adapter dir, base LlamaConfig) -> (cfg with lora_rank, lora_alpha
    and lora_targets set, {state-dict key: tensor} of the adapter
    parameters in cfg.storage_dtype, e.g. "layers.0.attn.q_proj_lora_a"
    [r, in] and "..._lora_b" [out, r]).

    Unsupported adapters fail loudly: silently dropping a target module
    would serve a model that quietly differs from what was tuned. An MLP
    adapter on an MoE base is refused (the routed experts have none)."""
    ac = read_adapter_config(path)
    if ac.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(
            f"unsupported peft_type {ac.get('peft_type')!r} (LoRA only)")
    if ac.get("use_rslora"):
        raise ValueError(
            "use_rslora=true scales by alpha/sqrt(r); this build "
            "implements classic alpha/r scaling only")
    if ac.get("use_dora"):
        raise ValueError("DoRA adapters are not supported")
    if (ac.get("bias") or "none") != "none":
        raise ValueError(
            f"adapter bias={ac.get('bias')!r}: bias deltas are not "
            "implemented (bias='none' only)")
    if ac.get("modules_to_save"):
        raise ValueError(
            f"modules_to_save={ac['modules_to_save']} holds fully-tuned "
            "modules this importer would silently drop — not supported")
    if ac.get("alpha_pattern") or ac.get("rank_pattern"):
        raise ValueError(
            "per-module alpha_pattern/rank_pattern are not supported "
            "(one global r/alpha only)")
    targets = _targets(ac.get("target_modules"))
    mode = TARGET_MODES.get(targets)
    if mode is None:
        raise ValueError(
            f"unsupported target_modules {sorted(targets)}; supported: "
            f"{[sorted(k) for k in TARGET_MODES]}")
    if not isinstance(cfg, LlamaConfig):
        raise ValueError(
            f"peft_adapter needs a Llama-family base model; "
            f"{type(cfg).__name__} has no adapter path")
    if mode == "attn_mlp" and hasattr(cfg, "num_experts"):
        from kubeflow_tpu_torch.models.moe import ADAPTER_REFUSAL

        raise ValueError(ADAPTER_REFUSAL)
    r = int(ac["r"])
    alpha = float(ac.get("lora_alpha", r))
    cfg = dataclasses.replace(cfg, lora_rank=r, lora_alpha=alpha,
                              lora_targets=mode)
    t = load_safetensors_dir(path)
    dims = {"q_proj": (cfg.hidden_size, cfg.num_heads * cfg.head_dim),
            "v_proj": (cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}

    def find(i: int, module: str, which: str) -> torch.Tensor:
        suffix = f"layers.{i}.{_MODULES[module]}.{module}.{which}.weight"
        hits = [k for k in t if k.endswith(suffix)]
        if len(hits) != 1:
            raise KeyError(
                f"expected exactly one tensor ending in {suffix!r}, "
                f"found {hits}")
        return t[hits[0]]

    leaves = {}
    for m in sorted(targets, key=list(_MODULES).index):
        n_in, n_out = dims[m]
        for i in range(cfg.num_layers):
            a, b = find(i, m, "lora_A"), find(i, m, "lora_B")
            if tuple(a.shape) != (r, n_in) or tuple(b.shape) != (n_out, r):
                raise ValueError(
                    f"layer {i} {m}: lora_A {tuple(a.shape)} / lora_B "
                    f"{tuple(b.shape)}, expected ({r}, {n_in}) / "
                    f"({n_out}, {r}) for r={r}")
            key = f"layers.{i}.{_PORT_BLOCK[_MODULES[m]]}.{m}"
            leaves[key + "_lora_a"] = a.to(cfg.storage_dtype)
            leaves[key + "_lora_b"] = b.to(cfg.storage_dtype)
    return cfg, leaves


def attach_peft_adapter(path: str, cfg, state_dict: dict
                        ) -> tuple[LlamaConfig, dict]:
    """Overlay a PEFT adapter on a base state dict: (adapted cfg, state
    dict with the `*_lora_*` entries) — load it into `Llama(adapted_cfg)`,
    or fold it flat with `train.lora.merge(state_dict, adapted_cfg)`."""
    cfg, leaves = load_peft_adapter(path, cfg)
    return cfg, {**state_dict, **leaves}
