"""Serving model abstraction — the KServe `Model` contract.

The port of `kubeflow_tpu/serve/model.py`: the `Model` base class
(load/preprocess/predict/postprocess, with `ready` gating the readiness
probes), `TorchModel`, the fixed forward behind `:predict` and v2 `/infer`,
and the open-inference dtype names.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch


class Model:
    """Lifecycle + request hooks. Subclasses override load()/predict()."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False
        self.load_time_s: float | None = None

    def load(self) -> bool:
        self.ready = True
        return self.ready

    def unload(self) -> None:
        self.ready = False

    def preprocess(self, payload: Any) -> Any:
        return payload

    def predict(self, inputs: Any) -> Any:
        raise NotImplementedError

    def postprocess(self, outputs: Any) -> Any:
        return outputs

    def explain(self, instances: Any) -> Any:
        raise NotImplementedError(
            f"model {self.name!r} has no explainer configured")

    def __call__(self, payload: Any) -> Any:
        return self.postprocess(self.predict(self.preprocess(payload)))

    def metadata(self) -> dict:
        """For the v2 protocol's GET /v2/models/{name}."""
        return {"name": self.name, "platform": "pytorch-cuda",
                "inputs": [], "outputs": []}


def check_token_ids(ids: np.ndarray, vocab: int) -> None:
    """Raise ValueError unless every id lies in [0, vocab): checked on the
    host, since an out-of-range index on CUDA is a device-side assert
    (JAX's gather clamps it instead)."""
    if ids.size and (ids.min() < 0 or ids.max() >= vocab):
        raise ValueError(f"token ids must lie in [0, {vocab}), got "
                         f"[{ids.min()}, {ids.max()}]")


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TorchModel(Model):
    """A fixed forward over a module, run per batch bucket: the JAXModel of
    `kubeflow_tpu/serve/model.py`.

    `apply_fn(module, *inputs)` takes one tensor per `input_spec` entry
    (the per-example shape and numpy dtype name of each positional input),
    each with a leading batch dim, on the module's device, and returns a
    tensor or a tuple of them. A request is padded up to the next bucket by
    repeating its last row, split into chunks of the largest bucket above
    it, and stripped of its padding. There is no AOT compile: `compiles`
    counts the buckets the first time each runs, and `load()` runs one
    forward per warm bucket so the first request of that size pays no
    first-use cost. Every forward runs under `torch.inference_mode()`, one
    at a time. With `vocab_size`, input 0 holds token ids, checked on the
    host (`check_token_ids`) before they reach the device."""

    def __init__(self, name: str, apply_fn, module,
                 input_spec: Sequence[tuple[tuple[int, ...], str]],
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 warm_buckets: Sequence[int] = (1, 8),
                 vocab_size: int | None = None):
        super().__init__(name)
        self._apply = apply_fn
        self.vocab_size = vocab_size
        self._module = module
        self.input_spec = [(tuple(s), str(d)) for s, d in input_spec]
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        self.warm_buckets = [b for b in warm_buckets
                             if b in self.batch_buckets]
        self._warm: set[int] = set()
        self._lock = threading.Lock()
        self.explainer = None  # serve/explain.py; set via attach_explainer
        #: {"mode", "quantized", "full"} when the weights are int8
        #: (serve/runtimes.py sets it), else None.
        self.quantization: dict | None = None
        self.stats = {"requests": 0, "examples": 0, "padded_examples": 0,
                      "compiles": 0, "predict_s": 0.0}

    @property
    def device(self) -> torch.device:
        """Where the module's tensors live (the CPU for one with none)."""
        first = next(itertools.chain(self._module.parameters(),
                                     self._module.buffers()), None)
        return torch.device("cpu") if first is None else first.device

    def attach_explainer(self, explainer) -> None:
        self.explainer = explainer

    def apply_and_params(self):
        """(apply_fn, module) for explainers that differentiate through
        the model (integrated gradients) rather than calling predict."""
        return self._apply, self._module

    def explain(self, instances) -> Any:
        if self.explainer is None:
            raise NotImplementedError(
                f"model {self.name!r} has no explainer configured")
        if not self.ready:
            raise RuntimeError(f"model {self.name} is not loaded")
        return self.explainer.explain(self, instances)

    def _forward(self, batch: int, arrays: list) -> list:
        """One bucket's forward: numpy in, numpy leaves out."""
        dev = self.device
        with self._lock, torch.inference_mode():
            out = self._apply(self._module, *(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays))
            leaves = list(out) if isinstance(out, (tuple, list)) else [out]
            res = [x.float().cpu().numpy() if x.dtype == torch.bfloat16
                   else x.cpu().numpy() for x in leaves]
            if batch not in self._warm:
                self._warm.add(batch)
                self.stats["compiles"] += 1
        return res

    def load(self) -> bool:
        t0 = time.monotonic()
        self._module.eval()
        for b in self.warm_buckets:
            if b not in self._warm:
                self._forward(b, [np.zeros((b, *s), np.dtype(d))
                                  for s, d in self.input_spec])
        self.load_time_s = time.monotonic() - t0
        self.ready = True
        return True

    def unload(self) -> None:
        # Keep the weights: unload/load through the repository API must
        # round-trip for models registered without a model_dir. Only the
        # warm state goes.
        self.ready = False
        with self._lock:
            self._warm.clear()

    def predict(self, inputs: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Pads the batch up to the nearest bucket, runs the forward, and
        strips the padding. Returns a list of output arrays."""
        if not self.ready:
            raise RuntimeError(f"model {self.name} is not loaded")
        arrays = [np.asarray(x, dtype=np.dtype(d))
                  for x, (_, d) in zip(inputs, self.input_spec)]
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("inputs disagree on batch size")
        for a, (shape, _) in zip(arrays, self.input_spec):
            if a.shape[1:] != shape:
                # JAX's AOT executable refuses a wrong-shaped instance with
                # a TypeError; the :explain route answers it with 400.
                raise TypeError(f"per-example shape {a.shape[1:]} != the "
                                f"served shape {shape}")
        if self.vocab_size is not None:
            check_token_ids(arrays[0], self.vocab_size)
        bucket = _next_bucket(n, self.batch_buckets)
        t0 = time.monotonic()
        if n > bucket:  # above the largest bucket: split into max-size chunks
            outs = [self.predict([a[i:i + bucket] for a in arrays])
                    for i in range(0, n, bucket)]
            return [np.concatenate(parts) for parts in zip(*outs)]
        if n < bucket:
            arrays = [np.concatenate(
                [a, np.repeat(a[-1:], bucket - n, axis=0)]) for a in arrays]
        leaves = [x[:n] for x in self._forward(bucket, arrays)]
        self.stats["requests"] += 1
        self.stats["examples"] += n
        self.stats["padded_examples"] += bucket - n
        self.stats["predict_s"] += time.monotonic() - t0
        return leaves

    def metadata(self) -> dict:
        return {
            "name": self.name, "platform": "pytorch-cuda",
            "inputs": [{"name": f"input_{i}", "shape": [-1, *shape],
                        "datatype": _v2_dtype(dtype)}
                       for i, (shape, dtype) in enumerate(self.input_spec)],
            "outputs": [{"name": "output_0", "shape": [-1],
                         "datatype": "FP32"}],
            "batch_buckets": self.batch_buckets,
        }


#: numpy dtype names <-> the open-inference (v2) datatypes, as the JAX
#: server maps them.
_V2_DTYPES = {
    "float32": "FP32", "float16": "FP16", "bfloat16": "BF16",
    "float64": "FP64", "int32": "INT32", "int64": "INT64",
    "int8": "INT8", "int16": "INT16", "uint8": "UINT8",
    "uint16": "UINT16", "uint32": "UINT32", "uint64": "UINT64",
    "bool": "BOOL",
}
_NP_DTYPES = {v: k for k, v in _V2_DTYPES.items()}


def _v2_dtype(np_dtype: str) -> str:
    return _V2_DTYPES.get(str(np_dtype), "FP32")


def v2_to_numpy_dtype(v2: str) -> str:
    try:
        return _NP_DTYPES[v2.upper()]
    except KeyError:
        raise ValueError(f"unsupported v2 datatype {v2!r}") from None
