"""Model and dataset registries: a bundle or a job spec names them by
string.

The port of the Llama and synthetic-LM entries of
`kubeflow_tpu/utils/registry.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from kubeflow_tpu_torch.data import synthetic
from kubeflow_tpu_torch.models import llama

_MODELS: dict[str, Callable[[], llama.LlamaConfig]] = {
    "llama_tiny": llama.llama_tiny,
    "llama_1b": llama.llama_1b,
    "llama3_8b": llama.llama3_8b,
}


def list_models() -> list[str]:
    return sorted(_MODELS)


def model_config(name: str, **kwargs) -> llama.LlamaConfig:
    """The named config with `kwargs` overriding its fields."""
    try:
        base = _MODELS[name]()
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; have {list_models()}") from None
    return dataclasses.replace(base, **kwargs)


def build_model(name: str, device=None, **kwargs):
    """Returns (Llama module with allocated, uninitialised weights, info
    dict) — the same (module, info) shape as the JAX registry."""
    cfg = model_config(name, **kwargs)
    return llama.Llama(cfg, device=device), {
        "task": "lm", "num_params": cfg.num_params,
        "vocab_size": cfg.vocab_size, "config": cfg}


def _synthetic_lm(batch_size=8, seq_len=128, vocab_size=512, seed=0, **kw):
    return synthetic.token_batches(batch_size, seq_len, vocab_size, seed)


def _learnable_lm(batch_size=8, seq_len=32, vocab_size=64, seed=0, **kw):
    return synthetic.learnable_token_batches(batch_size, seq_len,
                                             vocab_size, seed)


#: Dataset factories with the JAX registry's names and kwargs (extra kwargs
#: such as process_index are accepted and ignored, as there).
_DATASETS: dict[str, Callable] = {
    "synthetic_lm": _synthetic_lm,
    "learnable_lm": _learnable_lm,
}


def list_datasets() -> list[str]:
    return sorted(_DATASETS)


def build_dataset(name: str, **kwargs):
    """An iterator of {"inputs", "targets"} numpy batches."""
    try:
        factory = _DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; have {list_datasets()}") from None
    return factory(**kwargs)
