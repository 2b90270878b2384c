"""MNIST-class MLP: the smoke-test model, and the one continuous-input
model (integrated gradients explains it).

The port of `kubeflow_tpu/models/mlp.py`: flatten, ReLU hidden layers
`dense_{i}`, then a `head`, every layer with a bias. `Dense` here is the
flax `nn.Dense` with `dtype` and `param_dtype`: the weight stored in fp32
([out, in], the nn.Linear layout), input and weight cast to the compute
dtype, the product rounded to it, then the bias added in it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.utils.devices import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def as_dtype(val) -> torch.dtype:
    """A torch dtype from a dtype or its name (bundles carry names)."""
    if isinstance(val, torch.dtype):
        return val
    try:
        return _DTYPES[str(val)]
    except KeyError:
        raise ValueError(f"dtype {val!r}: one of {sorted(_DTYPES)}") from None


class Dense(nn.Linear):
    """nn.Linear stored in `param_dtype` and applied in `dtype` as flax's
    Dense: the product rounded to `dtype`, then the bias, cast to it,
    added."""

    def __init__(self, in_features: int, out_features: int, dtype, device,
                 bias: bool = True, param_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


@torch.no_grad()
def init_dense_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights on the module's own device: every `Dense`
    N(0, 1/fan_in) (LeCun normal, untruncated) with zero biases."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, Dense):
            mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
    return module


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: tuple[int, ...] = (256, 128)
    num_classes: int = 10
    dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "hidden", tuple(self.hidden))


class MLP(nn.Module):
    """Logits [B, num_classes] of inputs [B, ...] flattened to in_dim.
    `device` defaults to CUDA and raises when CUDA is absent."""

    def __init__(self, cfg: MLPConfig = MLPConfig(), device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dims = (cfg.in_dim, *cfg.hidden)
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            self.add_module(f"dense_{i}", Dense(a, b, cfg.dtype, device))
        self.head = Dense(dims[-1], cfg.num_classes, cfg.dtype, device)

    def init_weights(self, seed: int = 0) -> "MLP":
        return init_dense_weights(self, seed)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.cfg.dtype)
        for i in range(len(self.cfg.hidden)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)
