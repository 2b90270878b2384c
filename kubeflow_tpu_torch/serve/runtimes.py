"""Serving bundles: export a model directory, load it back as a Model.

The port of `kubeflow_tpu/serve/runtimes.py`: a bundle's `model.json`
names its format, and the format's runtime builds the Model.

  * "torch-registry" (written by `export_for_serving`): a registry model
    with `params.pt`, an optional `torch.save`d state dict; without it the
    weights are a seeded random init made on the target device;

        model.json   {"format": "torch-registry", "model": "...",
                      "model_kwargs": {}, "batch_buckets": [...],
                      "seed": 0, "generative": {...}}

  * "huggingface" (KServe's huggingfaceserver): the bundle is an HF
    checkpoint dir (`config.json` + safetensors, read by
    models/hf_import.py) plus a model.json {"format": "huggingface"};
    `checkpoint` may point elsewhere (relative to the bundle) and
    `model_overrides` sets config fields. A Llama-family or GPT-2
    checkpoint with a "generative" block is served by the generation
    engine: a `peft_adapter` dir is folded flat into a Llama's weights
    (train/lora.merge), and the checkpoint's own tokenizer is bundled, its
    eos the default. A T5/MT5/UMT5 checkpoint is the text2text task
    (`serve/text2text.py`, behind `:generate`): its "generative" block
    gives `in_buckets` and `max_tokens`.

Without a "generative" block a bundle is a fixed forward (`TorchModel`)
behind `:predict` and v2 `/infer`: a registry model over inputs of its
`example_shape` and `example_dtype`; a BERT checkpoint over token ids
[B, seq_len] (default min(max_seq_len, 128)) with the key mask `ids !=
pad_token_id`; a Llama-family or GPT-2 checkpoint as full-forward
logits at seq_len 128. An `explainer` block ({"method": "occlusion" |
"integrated_gradients", ...}) attaches serve/explain.py's explainer.

`"quantize": "int8"` serves the weights as int8 codes with per-channel
scales (serve/quant.py), quantized after they load, as the JAX runtime's
`_maybe_quantize` does: a Llama (or MoE Llama) through `quantize_model`,
BERT, the MLP, GPT-2 and T5 through `quantize_fixed`. A Llama-family registry bundle
without `params.pt` (or LoRA factors) is built int8 part by part from its
seed (`init_quantized`): the same weights, never a whole float model in
memory (Mixtral-8x7B is 93 GB in bf16). The "generative" block reaches
`GenerativeTorchModel` as on the JAX paths: its `"tokenizer": "bytes"`
gives text in and out, and its `adapters` ({name: PEFT adapter dir}) serve
multi-LoRA (the huggingface format resolves them relative to the bundle,
the registry format passes them on as given, as in JAX). A JAX bundle
(orbax `params/`) is refused.
"""

from __future__ import annotations

import json
import os

import torch

from kubeflow_tpu_torch.models.llama import LlamaConfig
from kubeflow_tpu_torch.serve.model import Model, TorchModel
from kubeflow_tpu_torch.utils import registry
from kubeflow_tpu_torch.utils.devices import resolve_device

FORMAT = "torch-registry"
PARAMS_FILE = "params.pt"


def export_for_serving(model_dir: str, *, model: str, params=None,
                       model_kwargs: dict | None = None,
                       batch_buckets=(1, 2, 4, 8, 16, 32),
                       seed: int = 0, extra: dict | None = None) -> str:
    """Write the serving bundle: model.json plus, when `params` (a state
    dict or a module) is given, params.pt. `model_kwargs` must be JSON
    (dtype as a name, e.g. "float32")."""
    os.makedirs(model_dir, exist_ok=True)
    spec = {"format": FORMAT, "model": model,
            "model_kwargs": model_kwargs or {},
            "batch_buckets": list(batch_buckets), "seed": seed}
    spec.update(extra or {})
    with open(os.path.join(model_dir, "model.json"), "w") as f:
        json.dump(spec, f, indent=1)
    if params is not None:
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        torch.save({k: v.detach().cpu() for k, v in params.items()},
                   os.path.join(model_dir, PARAMS_FILE))
    return model_dir


def load_model(model_dir: str, name: str | None = None,
               device=None) -> Model:
    """Build the Model a bundle describes, its weights on `device` (CUDA by
    default; raises when CUDA is absent unless device="cpu")."""
    with open(os.path.join(model_dir, "model.json")) as f:
        spec = json.load(f)
    fmt = spec.get("format", "jax-registry")
    if fmt not in _RUNTIMES:
        raise ValueError(
            f"bundle format {fmt!r} is not served by this package (it "
            f"serves {sorted(_RUNTIMES)}); a JAX bundle (orbax params/) "
            "must be re-exported with kubeflow_tpu_torch.serve.runtimes."
            "export_for_serving")
    mode = spec.get("quantize")
    if mode and mode != "int8":
        raise ValueError(f"unsupported quantize mode {mode!r} (have: int8)")
    model = _RUNTIMES[fmt](model_dir, spec, resolve_device(device))
    if name:
        model.name = name
    if spec.get("explainer"):
        from kubeflow_tpu_torch.serve.explain import build_explainer

        attach = getattr(model, "attach_explainer", None)
        if attach is None:
            raise ValueError(
                f"runtime {fmt!r} model does not support explainers")
        attach(build_explainer(spec["explainer"]))
    return model


def _fixed(name: str, module, spec: dict, apply_fn, seq_spec,
           buckets=(1, 2, 4, 8, 16, 32), warm=(1, 8)) -> TorchModel:
    """The fixed-forward Model over `module`, quantized first under
    `quantize: int8`; the bundle's buckets override the defaults. Integer
    inputs are token ids of the config's vocabulary."""
    module.eval()
    quantization = _quantize(module, spec)
    vocab = (module.cfg.vocab_size if seq_spec[1].startswith("int")
             else None)
    model = TorchModel(name, apply_fn, module, input_spec=[seq_spec],
                       batch_buckets=spec.get("batch_buckets", buckets),
                       warm_buckets=spec.get("warm_buckets", warm),
                       vocab_size=vocab)
    model.quantization = quantization
    return model


def _last(module, x):
    out = module(x)
    return out[-1] if isinstance(out, tuple) else out


def _registry_runtime(model_dir: str, spec: dict, device) -> Model:
    """A registry model with the bundle's weights (or a seeded init):
    behind the generation engine with a "generative" block, else a fixed
    forward over inputs of its example shape."""
    if os.path.isdir(os.path.join(model_dir, "params")):
        raise ValueError(
            "bundle holds orbax params/ (a JAX checkpoint), which this "
            f"package cannot read; save a state dict as {PARAMS_FILE}")
    if spec.get("peft_adapter"):
        raise ValueError(
            "'peft_adapter' is read by the 'huggingface' format; a "
            f"{FORMAT!r} bundle carries merged weights (train.lora.merge)")
    path = os.path.join(model_dir, PARAMS_FILE)
    kwargs = spec.get("model_kwargs", {})
    cfg = registry.model_config(spec["model"], **kwargs)
    lazy = (not os.path.exists(path) and spec.get("quantize")
            and isinstance(cfg, LlamaConfig) and not cfg.lora_rank)
    module, info = registry.build_model(spec["model"],
                                        device="meta" if lazy else device,
                                        **kwargs)
    if lazy:  # int8 from the recorded seed, a part at a time
        from kubeflow_tpu_torch.serve.quant import init_quantized

        init_quantized(module, int(spec.get("seed", 0)), device)
    elif os.path.exists(path):
        module.load_state_dict(torch.load(path, map_location=device,
                                          weights_only=True))
    else:  # no trained weights: init from the recorded seed
        module.init_weights(int(spec.get("seed", 0)))
    name = spec.get("name") or spec["model"]
    if spec.get("generative"):
        return _generative(name, module, spec, dict(spec["generative"]))
    shape = (tuple(info["example_shape"][1:]),
             info.get("example_dtype", "float32"))
    return _fixed(name, module, spec, _last, shape)


def _huggingface_runtime(model_dir: str, spec: dict, device) -> Model:
    """An HF checkpoint (models/hf_import.py): T5/MT5/UMT5 as the
    text2text task (`Text2TextTorchModel`, the "generative" block its
    `in_buckets` and `max_tokens`); BERT as a fixed forward; a causal LM
    (the Llama family, GPT-2) behind the generation engine with a
    "generative" block (an optional PEFT adapter folded flat), else as
    full-forward logits. A bundled tokenizer is used where one loads."""
    from kubeflow_tpu_torch.models.bert import Bert, BertConfig
    from kubeflow_tpu_torch.models.hf_import import (build_from_hf,
                                                     read_hf_config)
    from kubeflow_tpu_torch.models.moe import causal_lm
    from kubeflow_tpu_torch.models.t5 import T5, T5Config
    from kubeflow_tpu_torch.serve.tokenizer_util import load_bundled_tokenizer

    root = os.path.abspath(model_dir)

    def in_bundle(path):
        return path if os.path.isabs(path) else os.path.join(root, path)

    ckpt = in_bundle(spec.get("checkpoint") or ".")
    cfg, sd = build_from_hf(ckpt, **dict(spec.get("model_overrides") or {}))
    name = spec.get("name") or os.path.basename(root)
    if spec.get("peft_adapter") and not isinstance(cfg, LlamaConfig):
        # JAX's words: its adapter import takes only the Llama family.
        raise ValueError(f"peft_adapter needs a Llama-family base model; "
                         f"{type(cfg).__name__} has no adapter path")
    if isinstance(cfg, T5Config):
        # Encoder-decoder: the text2text task (one greedy decode on the
        # device a request, serve/text2text.py).
        from kubeflow_tpu_torch.serve.text2text import Text2TextTorchModel

        module = T5(cfg, device=device)
        module.load_state_dict(sd)
        del sd
        module.eval()
        quantization = _quantize(module, spec)
        gen = dict(spec.get("generative") or {})
        if "tokenizer" not in gen:
            tok = load_bundled_tokenizer(ckpt, name)
            if tok is not None:
                gen["tokenizer"] = tok
        model = Text2TextTorchModel(name, module, generation=gen)
        model.quantization = quantization
        return model
    if isinstance(cfg, BertConfig):
        module = Bert(cfg, device=device)
        module.load_state_dict(sd)
        del sd
        # Pad tokens must not enter attention: the mask comes from the
        # checkpoint's pad_token_id (HF tokenizers right-pad with it).
        pad_id = int(read_hf_config(ckpt).get("pad_token_id") or 0)

        def apply_fn(m, input_ids):
            return m(input_ids, attention_mask=input_ids != pad_id)[1]

        seq = int(spec.get("seq_len", min(cfg.max_seq_len, 128)))
        if seq > cfg.max_seq_len:
            raise ValueError(f"seq_len {seq} exceeds the checkpoint's "
                             f"{cfg.max_seq_len} positions")
        return _fixed(name, module, spec, apply_fn, ((seq,), "int32"))
    if spec.get("peft_adapter"):
        # Fold the adapter into the weights (its factors as stored, in
        # fp32, as the JAX runtime folds them): the engine serves a plain
        # base model.
        import dataclasses

        from kubeflow_tpu_torch.models.peft_import import attach_peft_adapter
        from kubeflow_tpu_torch.train.lora import merge

        acfg, sd = attach_peft_adapter(
            in_bundle(spec["peft_adapter"]),
            dataclasses.replace(cfg, param_dtype=torch.float32), sd)
        sd = merge(sd, acfg)
    module = causal_lm(cfg, device=device)
    module.load_state_dict(sd)
    del sd
    if not spec.get("generative"):
        seq = int(spec.get("seq_len", 128))
        return _fixed(name, module, spec, lambda m, ids: m(ids),
                      ((seq,), "int32"), buckets=(1, 2, 4, 8), warm=(1,))
    gen = dict(spec["generative"])
    if gen.get("adapters"):
        gen["adapters"] = {k: in_bundle(v)
                           for k, v in dict(gen["adapters"]).items()}
    if "tokenizer" not in gen:
        tok = load_bundled_tokenizer(ckpt, name)
        if tok is not None:
            gen["tokenizer"] = tok
            if tok.eos_token_id is not None:
                gen.setdefault("eos_id", int(tok.eos_token_id))
    return _generative(name, module, spec, gen)


def _quantize(module, spec: dict) -> dict | None:
    """Under `quantize: int8`, quantize `module` in place (a Llama by
    `quantize_model`, any other model by `quantize_fixed`; one built int8
    by `init_quantized` as it is) and return {"mode", "quantized", "full"}
    bytes; else None."""
    if not spec.get("quantize"):
        return None
    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.serve.quant import (quantize_fixed,
                                                quantize_model,
                                                quantized_bytes)

    if not isinstance(module, Llama):
        quantize_fixed(module)
    elif not module.cfg.quantized_dense:
        quantize_model(module)
    return {"mode": spec["quantize"], **quantized_bytes(module)}


def _generative(name: str, module, spec: dict, gen: dict) -> Model:
    """The engine's Model over `module` (a Llama-family model or GPT-2),
    quantized first under `quantize: int8`."""
    from kubeflow_tpu_torch.models.gpt2 import GPT2
    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel

    if not isinstance(module, (Llama, GPT2)):
        raise ValueError(f"a 'generative' block needs a causal LM (the "
                         f"Llama family or GPT-2), not "
                         f"{type(module).__name__}")
    module.eval()
    quantization = _quantize(module, spec)
    model = GenerativeTorchModel(name, module, generation=gen)
    model.quantization = quantization
    return model


#: model.json "format" -> runtime(model_dir, spec, device) -> Model.
_RUNTIMES = {FORMAT: _registry_runtime, "huggingface": _huggingface_runtime}
