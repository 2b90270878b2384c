"""Model and dataset registries: a bundle or a job spec names them by
string.

The port of the Llama, MoE, MLP, BERT, GPT-2, synthetic-LM, `mnist_like`
and token-corpus entries of `kubeflow_tpu/utils/registry.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from kubeflow_tpu_torch.data import loader, synthetic
from kubeflow_tpu_torch.models import bert, gpt2, llama, mlp, moe

#: name -> (config factory, example row length); the config's type picks
#: the module. The MLP's row is its config's `in_dim`.
_MODELS: dict[str, tuple[Callable[[], object], int | None]] = {
    "mnist_mlp": (mlp.MLPConfig, None),
    "llama_tiny": (llama.llama_tiny, 16),
    "llama_1b": (llama.llama_1b, 16),
    "llama3_8b": (llama.llama3_8b, 16),
    "moe_tiny": (moe.moe_tiny, 16),
    "mixtral_8x7b": (moe.mixtral_8x7b, 16),
    "bert_tiny": (bert.bert_tiny, 16),
    "bert_base": (bert.bert_base, 128),
    "gpt2_tiny": (gpt2.gpt2_tiny, 16),
}


def list_models() -> list[str]:
    return sorted(_MODELS)


def _entry(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; have {list_models()}") from None


def model_config(name: str, **kwargs):
    """The named config with `kwargs` overriding its fields."""
    return dataclasses.replace(_entry(name)[0](), **kwargs)


def build_model(name: str, device=None, **kwargs):
    """Returns (module with allocated, uninitialised weights, info dict):
    the same (module, info) shape as the JAX registry, with its `task`,
    `example_shape` (a batch of one), `example_dtype` and `config`, and
    for an MoE model its `active_params`. A Llama-family model may be
    built on device="meta" (`serve.quant.init_quantized` fills it); a
    `GPT2Config` builds `GPT2`."""
    cfg = model_config(name, **kwargs)
    seq = _entry(name)[1]
    if isinstance(cfg, mlp.MLPConfig):
        return mlp.MLP(cfg, device=device), {
            "task": "classify", "example_shape": (1, cfg.in_dim),
            "example_dtype": "float32", "num_params": None, "config": cfg}
    if isinstance(cfg, bert.BertConfig):
        return bert.Bert(cfg, device=device), {
            "task": "classify", "example_shape": (1, seq),
            "example_dtype": "int32", "num_params": None, "config": cfg}
    info = {"task": "lm", "example_shape": (1, seq), "example_dtype": "int32",
            "num_params": cfg.num_params, "vocab_size": cfg.vocab_size,
            "config": cfg}
    if isinstance(cfg, moe.MoEConfig):
        info["active_params"] = cfg.active_params
    return moe.causal_lm(cfg, device=device), info


def _synthetic_lm(batch_size=8, seq_len=128, vocab_size=512, seed=0, **kw):
    return synthetic.token_batches(batch_size, seq_len, vocab_size, seed)


def _learnable_lm(batch_size=8, seq_len=32, vocab_size=64, seed=0, **kw):
    return synthetic.learnable_token_batches(batch_size, seq_len,
                                             vocab_size, seed)


def _mnist_like(batch_size=64, seed=0, **kw):
    return synthetic.mnist_like(batch_size, seed)


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
    "mnist_like": _mnist_like,
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
