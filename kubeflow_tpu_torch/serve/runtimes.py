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
    Llama-family checkpoint dir (`config.json` + safetensors, read by
    models/hf_import.py) plus a model.json {"format": "huggingface",
    "generative": {...}}; `checkpoint` may point elsewhere (relative to
    the bundle), `model_overrides` sets LlamaConfig fields, a
    `peft_adapter` dir is folded flat into the weights (train/lora.merge),
    and the checkpoint's own tokenizer is bundled, its eos the default.

`"quantize": "int8"` serves the weights as int8 codes with per-channel
scales (serve/quant.py), quantized after they load, as the JAX runtime's
`_maybe_quantize` does. The "generative" block reaches
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

from kubeflow_tpu_torch.serve.model import Model
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
    if spec.get("explainer"):
        raise NotImplementedError(
            "explainers ('explainer') are not supported by this package yet")
    if not spec.get("generative"):
        raise NotImplementedError(
            "non-generative (fixed-forward predict) serving is not "
            "supported by this package yet; add a 'generative' block")
    model = _RUNTIMES[fmt](model_dir, spec, resolve_device(device))
    if name:
        model.name = name
    return model


def _registry_runtime(model_dir: str, spec: dict, device) -> Model:
    """A registry Llama with the bundle's weights (or a seeded init) behind
    the generation engine."""
    if os.path.isdir(os.path.join(model_dir, "params")):
        raise ValueError(
            "bundle holds orbax params/ (a JAX checkpoint), which this "
            f"package cannot read; save a state dict as {PARAMS_FILE}")
    if spec.get("peft_adapter"):
        raise ValueError(
            "'peft_adapter' is read by the 'huggingface' format; a "
            f"{FORMAT!r} bundle carries merged weights (train.lora.merge)")
    module, _ = registry.build_model(spec["model"], device=device,
                                     **spec.get("model_kwargs", {}))
    path = os.path.join(model_dir, PARAMS_FILE)
    if os.path.exists(path):
        module.load_state_dict(torch.load(path, map_location=device,
                                          weights_only=True))
    else:  # no trained weights: init from the recorded seed
        module.init_weights(int(spec.get("seed", 0)))
    return _generative(spec.get("name") or spec["model"], module, spec,
                       dict(spec["generative"]))


def _huggingface_runtime(model_dir: str, spec: dict, device) -> Model:
    """An HF Llama-family checkpoint (models/hf_import.py) behind the
    generation engine, with an optional PEFT adapter folded flat."""
    from kubeflow_tpu_torch.models.hf_import import build_from_hf
    from kubeflow_tpu_torch.models.llama import Llama
    from kubeflow_tpu_torch.serve.tokenizer_util import load_bundled_tokenizer

    root = os.path.abspath(model_dir)

    def in_bundle(path):
        return path if os.path.isabs(path) else os.path.join(root, path)

    ckpt = in_bundle(spec.get("checkpoint") or ".")
    cfg, sd = build_from_hf(ckpt, **dict(spec.get("model_overrides") or {}))
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
    module = Llama(cfg, device=device)
    module.load_state_dict(sd)
    del sd
    name = spec.get("name") or os.path.basename(root)
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


def _generative(name: str, module, spec: dict, gen: dict) -> Model:
    """The engine's Model over `module`, quantized first under
    `quantize: int8`."""
    from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel

    module.eval()
    quantization = None
    if spec.get("quantize"):
        from kubeflow_tpu_torch.serve.quant import (quantize_model,
                                                    quantized_bytes)

        quantize_model(module)
        quantization = {"mode": spec["quantize"], **quantized_bytes(module)}
    model = GenerativeTorchModel(name, module, generation=gen)
    model.quantization = quantization
    return model


#: model.json "format" -> runtime(model_dir, spec, device) -> Model.
_RUNTIMES = {FORMAT: _registry_runtime, "huggingface": _huggingface_runtime}
