"""InferenceGraph executor: KServe's router, in-process.

The port of `kubeflow_tpu/serve/graph.py`. A graph is a spec interpreted
by `GraphModel`, which plugs into the ModelRepository like any model, so a
graph is served through the same v1/v2 HTTP and gRPC surfaces, composing
models hosted in-process (or any callable).

Node types (KServe parity):
  sequence  steps run in order, each output feeding the next input
  switch    route by a request field against per-case targets
  ensemble  run members on the same input, merge outputs
  splitter  weighted random routing across targets (canary/AB); the
            picks come from `random.Random(seed)`, so one spec and seed
            pick the same targets as the JAX package's executor

Spec:
  {"root": "pre",
   "nodes": {
     "pre":  {"type": "sequence", "steps": [{"model": "tokenizer"},
                                             {"node": "route"}]},
     "route": {"type": "switch", "field": "lang",
               "cases": {"en": {"model": "clf_en"}},
               "default": {"model": "clf_multi"}},
     "ab":   {"type": "splitter", "targets": [{"model": "v1"},
                                               {"model": "v2"}],
              "weights": [0.9, 0.1]},
     "vote": {"type": "ensemble", "members": [{"model": "a"},
                                               {"model": "b"}],
              "merge": "average"}}}
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Mapping

import numpy as np

from kubeflow_tpu_torch.serve.model import Model


class GraphError(ValueError):
    pass


# A target is {"model": name} (resolved through predict_fn) or
# {"node": name} (recurse into the graph).
PredictFn = Callable[[str, Any], Any]


class GraphExecutor:
    def __init__(self, spec: Mapping[str, Any], predict_fn: PredictFn,
                 seed: int | None = None):
        self.nodes = dict(spec.get("nodes") or {})
        self.root = spec.get("root")
        if not self.root or self.root not in self.nodes:
            raise GraphError(f"graph root {self.root!r} not in nodes")
        self.predict_fn = predict_fn
        self._rng = random.Random(seed)
        for name, node in self.nodes.items():
            self._validate_node(name, node)

    def _validate_node(self, name: str, node: Mapping[str, Any]) -> None:
        t = node.get("type")
        if t == "sequence":
            if not node.get("steps"):
                raise GraphError(f"sequence node {name!r} has no steps")
            targets = node["steps"]
        elif t == "switch":
            if not node.get("field"):
                raise GraphError(f"switch node {name!r} needs `field`")
            targets = list((node.get("cases") or {}).values())
            if node.get("default"):
                targets.append(node["default"])
            if not targets:
                raise GraphError(f"switch node {name!r} has no cases")
        elif t == "ensemble":
            if not node.get("members"):
                raise GraphError(f"ensemble node {name!r} has no members")
            targets = node["members"]
        elif t == "splitter":
            targets = node.get("targets") or []
            weights = node.get("weights") or []
            if not targets or len(weights) != len(targets):
                raise GraphError(
                    f"splitter node {name!r} needs targets + matching "
                    f"weights")
            if any(w < 0 for w in weights) or sum(weights) <= 0:
                raise GraphError(
                    f"splitter node {name!r}: weights must be >= 0 with a "
                    f"positive sum, got {weights}")
        else:
            raise GraphError(f"node {name!r}: unknown type {t!r}")
        for tgt in targets:
            if "node" in tgt:
                if tgt["node"] not in self.nodes:
                    raise GraphError(
                        f"node {name!r} references unknown node "
                        f"{tgt['node']!r}")
            elif "model" not in tgt:
                raise GraphError(
                    f"node {name!r}: target needs `model` or `node`: {tgt}")

    def _run_target(self, target: Mapping[str, Any], payload: Any,
                    depth: int) -> Any:
        if "node" in target:
            return self._run_node(target["node"], payload, depth + 1)
        return self.predict_fn(target["model"], payload)

    def _run_node(self, name: str, payload: Any, depth: int = 0) -> Any:
        if depth > 32:
            raise GraphError("graph recursion depth exceeded (cycle?)")
        node = self.nodes[name]
        t = node["type"]
        if t == "sequence":
            for step in node["steps"]:
                payload = self._run_target(step, payload, depth)
            return payload
        if t == "switch":
            key = None
            if isinstance(payload, Mapping):
                key = payload.get(node["field"])
            case = (node.get("cases") or {}).get(str(key))
            if case is None:
                case = node.get("default")
            if case is None:
                raise GraphError(
                    f"switch {name!r}: no case for {key!r} and no default")
            return self._run_target(case, payload, depth)
        if t == "ensemble":
            outs = [self._run_target(m, payload, depth)
                    for m in node["members"]]
            return self._merge(node.get("merge", "all"), outs)
        if t == "splitter":
            (target,) = self._rng.choices(node["targets"],
                                          weights=node["weights"])
            return self._run_target(target, payload, depth)
        raise GraphError(f"unknown node type {t!r}")  # unreachable

    @staticmethod
    def _merge(mode: str, outs: list) -> Any:
        # Normalize member outputs to arrays: {"instances": ...} payload
        # dicts (the GraphModel HTTP flow), [tensor, ...] lists (direct
        # model outputs), or bare arrays.
        def arr(o):
            if isinstance(o, Mapping):
                return np.asarray(o["instances"])
            if isinstance(o, (list, tuple)):
                return np.asarray(o[0])
            return np.asarray(o)

        vals = [arr(o) for o in outs]
        if mode == "all":
            merged = [v.tolist() for v in vals]
        elif mode == "average":
            merged = np.mean(vals, axis=0)
        elif mode == "concat":
            merged = np.concatenate(vals, axis=-1)
        else:
            raise GraphError(f"unknown ensemble merge {mode!r}")
        if isinstance(outs[0], Mapping):
            rest = {k: v for k, v in outs[0].items() if k != "instances"}
            return {**rest, "instances": merged}
        if isinstance(outs[0], (list, tuple)) and mode != "all":
            return [merged]
        return merged

    def __call__(self, payload: Any) -> Any:
        return self._run_node(self.root, payload)


class GraphModel(Model):
    """Serves an InferenceGraph through the model server: registered in the
    ModelRepository like any model, its predict() walks the graph against
    sibling models in the same repository.

    Graphs take the RAW request body (`wants_raw_payload`): the server
    hands predict() the JSON dict (`{"instances": ..., **fields}`) instead
    of pre-extracted tensors, so switch nodes can route on request fields —
    per-request routing is fundamentally incompatible with cross-request
    batch coalescing, so graphs bypass the batcher entirely (sibling models
    invoked through the graph still use their own batch buckets)."""

    wants_raw_payload = True

    # Guards mutual recursion BETWEEN GraphModels (A -> B -> A): each
    # predict() walk shares one thread-local depth budget.
    _recursion = threading.local()

    def __init__(self, name: str, spec: Mapping[str, Any], repo,
                 seed: int | None = None):
        super().__init__(name)
        self.spec = dict(spec)
        self.repo = repo
        self.executor = GraphExecutor(spec, self._predict_model, seed=seed)

    def _predict_model(self, model_name: str, payload: Any) -> Any:
        if model_name == self.name:
            raise GraphError("graph cannot reference itself")
        model = self.repo.get(model_name)
        if isinstance(payload, Mapping):
            # HTTP flow: pull tensors out, run the model, thread the
            # routing fields through so downstream switches still see them.
            inputs = [np.asarray(payload["instances"])]
            outs = model.predict(inputs)
            out = outs[0] if isinstance(outs, (list, tuple)) else outs
            rest = {k: v for k, v in payload.items() if k != "instances"}
            return {**rest, "instances": np.asarray(out)}
        if isinstance(payload, (list, tuple)):
            return model.predict(payload)
        return model(payload)

    def load(self) -> bool:
        self.ready = True
        return True

    def predict(self, inputs: Any) -> Any:
        depth = getattr(self._recursion, "depth", 0)
        if depth > 16:
            raise GraphError(
                "graph recursion depth exceeded (mutually referencing "
                "graphs?)")
        self._recursion.depth = depth + 1
        try:
            return self.executor(inputs)
        finally:
            self._recursion.depth = depth

    def metadata(self) -> dict:
        return {"name": self.name, "platform": "tpk-inference-graph",
                "inputs": [], "outputs": [],
                "nodes": sorted(self.executor.nodes)}
