"""Serving bundles: export a model directory, load it back as a Model.

The port of `kubeflow_tpu/serve/runtimes.py` for registry models. A bundle
is a directory with

    model.json   {"format": "torch-registry", "model": "...",
                  "model_kwargs": {}, "batch_buckets": [...], "seed": 0,
                  "generative": {...}}
    params.pt    optional `torch.save`d state dict; without it the weights
                 are a seeded random init made on the target device

`"quantize": "int8"` serves the weights as int8 codes with per-channel
scales (serve/quant.py), quantized after they load, as the JAX runtime's
`_maybe_quantize` does.

The `model.json` keys are the JAX package's; only the format name and the
params file differ. A JAX bundle (orbax `params/`) is refused. The
"generative" block reaches `GenerativeTorchModel` unchanged, as on the JAX
registry path: its `"tokenizer": "bytes"` gives text in and out.
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
    if fmt != FORMAT:
        raise ValueError(
            f"bundle format {fmt!r} is not served by this package (it "
            f"serves {FORMAT!r}); a JAX bundle (orbax params/) must be "
            "re-exported with kubeflow_tpu_torch.serve.runtimes."
            "export_for_serving")
    if os.path.isdir(os.path.join(model_dir, "params")):
        raise ValueError(
            "bundle holds orbax params/ (a JAX checkpoint), which this "
            f"package cannot read; save a state dict as {PARAMS_FILE}")
    mode = spec.get("quantize")
    if mode and mode != "int8":
        raise ValueError(f"unsupported quantize mode {mode!r} (have: int8)")
    for key, what in (("explainer", "explainers"),
                      ("peft_adapter", "LoRA adapters")):
        if spec.get(key):
            raise NotImplementedError(
                f"{what} ({key!r}) is not supported by this package yet")
    if not spec.get("generative"):
        raise NotImplementedError(
            "non-generative (fixed-forward predict) serving is not "
            "supported by this package yet; add a 'generative' block")
    model = _registry_runtime(model_dir, spec, resolve_device(device))
    if name:
        model.name = name
    return model


def _registry_runtime(model_dir: str, spec: dict, device) -> Model:
    """A registry Llama with the bundle's weights (or a seeded init) behind
    the generation engine."""
    from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel

    module, _ = registry.build_model(spec["model"], device=device,
                                     **spec.get("model_kwargs", {}))
    path = os.path.join(model_dir, PARAMS_FILE)
    if os.path.exists(path):
        module.load_state_dict(torch.load(path, map_location=device,
                                          weights_only=True))
    else:  # no trained weights: init from the recorded seed
        module.init_weights(int(spec.get("seed", 0)))
    module.eval()
    quantization = None
    if spec.get("quantize"):
        from kubeflow_tpu_torch.serve.quant import (quantize_model,
                                                    quantized_bytes)

        quantize_model(module)
        quantization = {"mode": spec["quantize"], **quantized_bytes(module)}
    model = GenerativeTorchModel(spec.get("name") or spec["model"], module,
                                 generation=dict(spec["generative"]))
    model.quantization = quantization
    return model
