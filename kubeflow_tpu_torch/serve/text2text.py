"""Text2text serving: the huggingfaceserver text2text_generation task.

The port of `kubeflow_tpu/serve/text2text.py`. Encoder-decoder checkpoints
(the T5 family) serve through `models/t5.greedy_generate`: a request's
ids are padded to its input bucket and sent to the device without a sync
(a pinned staging copy), the whole greedy decode runs there (encoder,
cross K/V, `max_tokens` decoder steps with the argmax and the EOS state on
the device), and the tokens come back in one fetch: one host sync a
request, as JAX's one executable a bucket gives one dispatch.

No continuous batching and no streaming, as in JAX: text2text outputs are
short (translation, summarisation), so whole-request latency is the right
shape; the engine's slots would cost a per-token host loop.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from kubeflow_tpu_torch.serve.model import Model, check_token_ids
from kubeflow_tpu_torch.serve.tokenizer_util import decode_ids, resolve_ids


def _wait(event) -> None:
    """Block the host until `event` has passed: a request's one designed
    host sync, the fetch of its tokens."""
    event.synchronize()


class Text2TextTorchModel(Model):
    """KServe-Model-shaped wrapper over T5-class greedy generation.

    `generation` spec: {"in_buckets": [...], "max_tokens": N,
    "tokenizer": "bytes" | an HF-style tokenizer, "pad_id": 0}."""

    def __init__(self, name: str, model, *, generation: dict | None = None):
        super().__init__(name)
        gen = dict(generation or {})
        self._model, self.cfg = model, model.cfg
        self.in_buckets = sorted({int(b) for b in
                                  gen.get("in_buckets", (16, 64))})
        self.max_tokens = int(gen.get("max_tokens", 64))
        self.pad_id = int(gen.get("pad_id", 0))
        self.tokenizer = gen.get("tokenizer")
        # Requests run on the server's connection threads: the stats need
        # the lock.
        self._lock = threading.Lock()
        # "compiles" counts the buckets run so far (JAX compiles one
        # executable a bucket; here a bucket's first run makes its
        # allocations).
        self.stats = {"requests": 0, "generated_tokens": 0,
                      "generate_s": 0.0, "compiles": 0}
        self._warm: set[int] = set()
        #: {"mode", "quantized", "full"} when the weights are int8
        #: (serve/runtimes.py sets it), else None.
        self.quantization: dict | None = None

    @property
    def device(self) -> torch.device:
        return self._model.device

    def _run(self, toks: np.ndarray, mask: np.ndarray):
        """greedy_generate over one padded request: (tokens [1, max_tokens],
        n_valid [1]) as host tensors, fetched once."""
        from kubeflow_tpu_torch.models.t5 import greedy_generate

        with self._lock:
            if toks.shape[1] not in self._warm:
                self._warm.add(toks.shape[1])
                self.stats["compiles"] += 1
        dev = self.device
        cuda = dev.type == "cuda"
        ids, m = torch.from_numpy(toks), torch.from_numpy(mask)
        if cuda:
            ids = ids.pin_memory().to(dev, non_blocking=True)
            m = m.pin_memory().to(dev, non_blocking=True)
        out, n_valid = greedy_generate(self._model, ids, m,
                                       max_tokens=self.max_tokens)
        if not cuda:
            return out, n_valid
        host = (torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
                torch.empty(n_valid.shape, dtype=n_valid.dtype,
                            pin_memory=True))
        host[0].copy_(out, non_blocking=True)
        host[1].copy_(n_valid, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        _wait(event)
        return host

    def load(self) -> bool:
        """Warm the smallest bucket (the first call's allocations), then
        ready."""
        t0 = time.monotonic()
        self._model.eval()
        bucket = self.in_buckets[0]
        self._run(np.full((1, bucket), self.pad_id, np.int64),
                  np.ones((1, bucket), bool))
        self.load_time_s = time.monotonic() - t0
        self.ready = True
        return True

    def unload(self) -> None:
        self.ready = False
        self._warm.clear()

    def _resolve_ids(self, payload: dict) -> list[int]:
        ids = resolve_ids(self.tokenizer, payload)
        if len(ids) > self.in_buckets[-1]:
            raise ValueError(
                f"input of {len(ids)} tokens exceeds the largest bucket "
                f"{self.in_buckets[-1]}")
        return ids

    def generate(self, payload: dict) -> dict:
        if not self.ready:
            raise RuntimeError(f"model {self.name} is not loaded")
        ids = self._resolve_ids(payload)
        max_tokens = int(payload.get("max_tokens", self.max_tokens))
        if max_tokens > self.max_tokens:
            raise ValueError(
                f"max_tokens {max_tokens} exceeds the compiled budget "
                f"{self.max_tokens}")
        check_token_ids(np.asarray(ids), self.cfg.vocab_size)
        bucket = next(b for b in self.in_buckets if len(ids) <= b)
        toks = np.full((1, bucket), self.pad_id, np.int64)
        toks[0, :len(ids)] = ids
        mask = np.zeros((1, bucket), bool)
        mask[0, :len(ids)] = True
        t0 = time.monotonic()
        out_toks, n_valid = self._run(toks, mask)
        n = min(int(n_valid[0]), max_tokens)
        out_ids = [int(t) for t in out_toks[0, :n].tolist()]
        dt = time.monotonic() - t0
        with self._lock:
            self.stats["requests"] += 1
            self.stats["generated_tokens"] += n
            self.stats["generate_s"] += dt
        result = {
            "output_ids": out_ids,
            "num_input_tokens": len(ids),
            "num_output_tokens": n,
            "latency_s": round(dt, 4),
        }
        if self.tokenizer is not None:
            result["text"] = decode_ids(self.tokenizer, out_ids)
        return result

    def metadata(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        md = {"name": self.name, "platform": "pytorch-cuda",
              "task": "text2text_generation",
              "in_buckets": self.in_buckets,
              "max_tokens": self.max_tokens, "stats": stats}
        if self.quantization is not None:
            md["quantize"] = dict(self.quantization)
        return md
