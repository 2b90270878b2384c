"""Explainers: the KServe explainer component, native to the server.

The port of `kubeflow_tpu/serve/explain.py`:

  * `OcclusionExplainer`: model-agnostic token attribution. Each position
    is replaced by a baseline id and the predicted class's logit drop is
    measured; all S occluded variants plus the original row go through
    the model's own bucketed `predict` as ONE batch (S + 1 rows, split at
    the largest bucket as any request is).
  * `IntegratedGradientsExplainer`: for continuous inputs, the midpoint
    rule along the straight line from a baseline, gradients by
    `torch.autograd` on the model's device. All `steps` points go through
    one batched forward and backward (JAX runs a `lax.scan`); the sum is
    the same within fp32 rounding. Attributions sum to f(x) - f(baseline)
    up to the reported `completeness_gap`.

Served by `POST /v1/models/{name}:explain` with the v1 body
(`{"instances": [...]}`), answering `{"explanations": [...]}`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class OcclusionExplainer:
    """attribution[s] = logit_target(x) - logit_target(x with x[s] :=
    baseline): positive means the token supports the predicted class.
    `target` is the argmax class of the unoccluded row (per instance)."""

    method = "occlusion"

    def __init__(self, baseline_id: int = 0):
        self.baseline_id = int(baseline_id)

    def explain(self, model, instances: np.ndarray) -> list[dict]:
        x = np.asarray(instances)
        if x.ndim != 2 or not np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                "occlusion explains integer token batches [B, S]; got "
                f"shape {x.shape} dtype {x.dtype}")
        b, s = x.shape
        out = []
        for row in x:
            variants = np.tile(row, (s + 1, 1))
            for i in range(s):
                variants[i + 1, i] = self.baseline_id
            logits = model.predict([variants])[-1]
            if logits.ndim != 2:
                raise ValueError(
                    "occlusion needs per-instance class logits [B, C]; "
                    f"model returned shape {logits.shape} (sequence-level "
                    "heads are not class explanations)")
            target = int(np.argmax(logits[0]))
            attr = logits[0, target] - logits[1:, target]
            out.append({
                "method": self.method,
                "target": target,
                "target_logit": float(logits[0, target]),
                "attributions": [float(a) for a in attr],
            })
        return out


class IntegratedGradientsExplainer:
    """IG_i(x) = (x_i - x'_i) * (1/m) * sum_k d f_target / d x_i at
    x' + (k + 0.5)/m * (x - x'), f_target the argmax logit of the real
    input (the midpoint rule)."""

    method = "integrated_gradients"

    def __init__(self, steps: int = 32, baseline: Any | None = None):
        self.steps = int(steps)
        self.baseline = baseline

    def _attributions(self, apply_fn, module, x: np.ndarray, x0: np.ndarray,
                      target: np.ndarray, device) -> np.ndarray:
        """The midpoint sum for every row at once: steps x B points in one
        forward, their input gradients in one backward."""
        m = self.steps
        xt = torch.from_numpy(x).to(device)
        x0t = torch.from_numpy(np.ascontiguousarray(x0)).to(device)
        alpha = ((torch.arange(m, dtype=torch.float32, device=device) + 0.5)
                 / m).view(m, 1, *([1] * (x.ndim - 1)))
        pts = (x0t + alpha * (xt - x0t)).reshape(m * x.shape[0],
                                                 *x.shape[1:])
        pts.requires_grad_(True)
        with torch.enable_grad():
            out = apply_fn(module, pts)
            out = out[-1] if isinstance(out, (tuple, list)) else out
            idx = torch.from_numpy(target).to(device).long().repeat(m)
            f = out.float().gather(-1, idx[:, None]).sum()
            (grad,) = torch.autograd.grad(f, pts)
        total = grad.view(m, *x.shape).sum(dim=0)
        return ((xt - x0t) * total / m).cpu().numpy()

    def explain(self, model, instances: np.ndarray) -> list[dict]:
        x = np.asarray(instances, np.float32)
        apply_fn, module = model.apply_and_params()
        x0 = (np.zeros_like(x) if self.baseline is None
              else np.broadcast_to(
                  np.asarray(self.baseline, np.float32), x.shape))
        logits = model.predict([x])[-1]
        if logits.ndim != 2:
            raise ValueError(
                "integrated_gradients needs class logits [B, C]; model "
                f"returned shape {logits.shape}")
        target = np.argmax(logits, axis=-1).astype(np.int32)
        attr = self._attributions(apply_fn, module, x, x0, target,
                                  model.device)
        base_logits = model.predict([x0.astype(np.float32)])[-1]
        return [{
            "method": self.method,
            "target": int(t),
            "target_logit": float(logits[i, t]),
            "baseline_logit": float(base_logits[i, t]),
            # Completeness: sum(attr) ~= f(x) - f(baseline); reported so
            # callers can judge whether `steps` was enough.
            "completeness_gap": float(
                (logits[i, t] - base_logits[i, t]) - attr[i].sum()),
            "attributions": attr[i].tolist(),
        } for i, t in enumerate(target)]


def build_explainer(spec: dict):
    """model.json `explainer` block -> explainer instance."""
    method = spec.get("method", "occlusion")
    if method == "occlusion":
        return OcclusionExplainer(baseline_id=spec.get("baseline_id", 0))
    if method == "integrated_gradients":
        return IntegratedGradientsExplainer(
            steps=spec.get("steps", 32), baseline=spec.get("baseline"))
    raise ValueError(
        f"unknown explainer method {method!r} "
        "(have: occlusion, integrated_gradients)")
