"""Model and dataset registries: a bundle or a job spec names them by
string.

The port of the Llama, synthetic-LM and token-corpus entries of
`kubeflow_tpu/utils/registry.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from kubeflow_tpu_torch.data import loader, synthetic
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


def _token_file(path, batch_size=8, seq_len=128, seed=0, shuffle=True,
                vocab_size=None, process_index=None, process_count=None,
                **kw):
    """Tokenized corpus (.npy/.bin/.txt) with a checkpointable iterator.
    The trainer passes the model's vocab_size, so a wrong-tokenizer corpus
    fails at startup, and its process shard."""
    return loader.lm_dataset(
        path, batch_size=batch_size, seq_len=seq_len, seed=seed,
        shuffle=shuffle, vocab_size=vocab_size,
        process_index=process_index, process_count=process_count)


def _packed_lm(path, batch_size=8, seq_len=128, eos_id=0, seed=0,
               shuffle=True, vocab_size=None, **kw):
    """Document-packed corpus: batches carry segment_ids, positions and
    mask, so attention and loss respect document boundaries."""
    return loader.packed_lm_dataset(
        path, batch_size=batch_size, seq_len=seq_len, eos_id=eos_id,
        seed=seed, shuffle=shuffle, vocab_size=vocab_size,
        process_index=kw.get("process_index"),
        process_count=kw.get("process_count"))


#: Dataset factories with the JAX registry's names and kwargs (extra kwargs
#: such as process_index are accepted and ignored where unused, as there).
_DATASETS: dict[str, Callable] = {
    "synthetic_lm": _synthetic_lm,
    "learnable_lm": _learnable_lm,
    "token_file": _token_file,
    "packed_lm": _packed_lm,
}


def list_datasets() -> list[str]:
    return sorted(_DATASETS)


def build_dataset(name: str, **kwargs):
    """An iterable of {"inputs", "targets", ...} numpy batches (a
    generator, or a checkpointable `loader.MapDataset`)."""
    try:
        factory = _DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; have {list_datasets()}") from None
    return factory(**kwargs)
