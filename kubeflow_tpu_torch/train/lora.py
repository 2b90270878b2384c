"""LoRA fine-tuning: adapters apart from the frozen base, and the merge.

The port of `kubeflow_tpu/train/lora.py`. The model side is in
`models/llama.py`: `cfg.lora_rank` > 0 gives each adapted projection a
pair of parameters `<proj>_lora_a` [r, in] and `<proj>_lora_b` [out, r]
beside it (B starts at zero, so step 0 is the base model). This module
works on parameter names:

  * `partition` splits `named_parameters()` (or any name-keyed mapping)
    into the adapters and the base; `freeze_base` also turns the base's
    `requires_grad` off, so the backward computes no weight gradient for
    it and the optimizer state covers only the adapters (the LoRA memory
    win: no fp32 gradients or Adam moments for the base);
  * `merge` folds every adapter pair into its projection's weight (W +=
    alpha/r · B·A in fp32, cast back to W's dtype) and drops the adapter
    entries: a state dict that a `lora_rank=0` model, and so the serving
    engine and `serve.runtimes.export_for_serving`, load unchanged.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

_A, _B = "_lora_a", "_lora_b"


def is_lora_path(path: str | tuple) -> bool:
    """Whether a parameter name ("layers.0.attn.q_proj_lora_a") or a path
    of name parts names an adapter."""
    parts = path.split(".") if isinstance(path, str) else path
    return any("_lora_" in str(p) for p in parts)


def _named(params: nn.Module | Mapping[str, Any]) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def partition(params: nn.Module | Mapping[str, Any]) -> tuple[dict, dict]:
    """(adapters, base): name-keyed dicts of a model's parameters (or of a
    state dict), each in the given order. Raises when there is no
    adapter."""
    named = _named(params)
    train = {n: p for n, p in named.items() if is_lora_path(n)}
    if not train:
        raise ValueError("no *_lora_* parameters found — build the model "
                         "with lora_rank > 0")
    return train, {n: p for n, p in named.items() if not is_lora_path(n)}


def combine(train: Mapping[str, Any], frozen: Mapping[str, Any]) -> dict:
    """The two halves of `partition` as one name-keyed dict."""
    return {**frozen, **train}


def freeze_base(model: nn.Module) -> dict:
    """Mark only the adapters trainable (`requires_grad`) and return them,
    name-keyed, in parameter order."""
    train, frozen = partition(model)
    for p in frozen.values():
        p.requires_grad_(False)
    for p in train.values():
        p.requires_grad_(True)
    return train


@torch.no_grad()
def merge(params: nn.Module | Mapping[str, torch.Tensor], cfg: Any) -> dict:
    """A state dict with every adapter folded into its projection and the
    adapter entries dropped. The adapted forward computes x·Wᵀ + (x·Aᵀ)·Bᵀ
    · s and the merged weight W + s·B·A reproduces it (s = alpha/rank;
    the rank contraction is associative). The fold is in fp32 and the
    result takes W's dtype; entries that no adapter touches are the given
    tensors, not copies."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    scale = cfg.lora_alpha / cfg.lora_rank
    out = {k: v for k, v in sd.items() if not is_lora_path(k)}
    for key, a in sd.items():
        if not key.endswith(_A):
            continue
        base = key[:-len(_A)]
        w = out[base + ".weight"]
        delta = sd[base + _B].float() @ a.float()  # [out, r] @ [r, in]
        out[base + ".weight"] = (w.float() + scale * delta).to(w.dtype)
    return out
