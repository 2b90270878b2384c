"""Multi-LoRA serving: N PEFT adapters stacked over one base model, chosen
per request.

The port of `kubeflow_tpu/serve/multilora.py`. Every adapter lives on the
device in one stack per adapted projection, entry 0 all zeros (the base,
no adapter), so one decode dispatch serves a batch whose rows use
different adapters: each row gathers its own entry (`adapter_rows`) and
adds (x @ a) @ b to the projection's output (models/llama.py). Ranks may
differ: narrower ones are zero-padded to the widest (zero columns add
nothing); alpha/r is folded into b, so the model applies no further
scaling; an adapter that does not target a projection has zeros there.
"""

from __future__ import annotations

import dataclasses

import torch

#: Projections a stack can adapt, with their (in, out) widths.
_DIMS = {
    "q_proj": lambda c: (c.hidden_size, c.num_heads * c.head_dim),
    "v_proj": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "gate_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "up_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "down_proj": lambda c: (c.intermediate_size, c.hidden_size),
}


def build_adapter_stacks(adapter_dirs: dict[str, str], cfg, device=None
                         ) -> tuple[dict, dict]:
    """{name: PEFT adapter dir} + base LlamaConfig -> (stacks, ids).

    stacks: {projection: {"a": [L, N+1, in, rmax], "b": [L, N+1, rmax,
    out]}} in cfg.dtype on `device`, for `Llama.forward(...,
    adapter=stacks, adapter_ids=...)`; ids: {name: index >= 1} in sorted
    name order (0 is the base). Each adapter's B is multiplied by its
    alpha/r in fp32 before the cast. On an MoE base (models/moe.py) an
    adapter of the MLP is refused with JAX MoEBlock's words: the routed
    experts have no adapter path."""
    from kubeflow_tpu_torch.models.peft_import import load_peft_adapter

    if not adapter_dirs:
        raise ValueError("adapter_dirs must name at least one adapter")
    names = sorted(adapter_dirs)
    # fp32 leaves, so the fold rounds once, at the cast to cfg.dtype.
    fcfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    loaded = [load_peft_adapter(adapter_dirs[n], fcfg) for n in names]
    rmax = max(acfg.lora_rank for acfg, _ in loaded)
    n_layers = cfg.num_layers
    modules = [m for m in _DIMS
               if any(k.endswith(f".{m}_lora_a") for _, leaves in loaded
                      for k in leaves)]
    if hasattr(cfg, "num_experts") and not {"gate_proj", "up_proj",
                                            "down_proj"}.isdisjoint(modules):
        from kubeflow_tpu_torch.models.moe import ADAPTER_REFUSAL

        raise ValueError(ADAPTER_REFUSAL)
    stacks = {}
    for m in modules:
        n_in, n_out = _DIMS[m](cfg)
        a = torch.zeros(n_layers, len(names) + 1, n_in, rmax)
        b = torch.zeros(n_layers, len(names) + 1, rmax, n_out)
        block = "attn" if m in ("q_proj", "v_proj") else "mlp"
        for j, (acfg, leaves) in enumerate(loaded, start=1):
            r = acfg.lora_rank
            if f"layers.0.{block}.{m}_lora_a" not in leaves:
                continue  # this adapter leaves the projection alone
            scale = acfg.lora_alpha / r
            for i in range(n_layers):
                key = f"layers.{i}.{block}.{m}"
                a[i, j, :, :r] = leaves[key + "_lora_a"].T  # [in, r]
                b[i, j, :r] = leaves[key + "_lora_b"].T * scale  # [r, out]
        stacks[m] = {"a": a.to(device=device, dtype=cfg.dtype),
                     "b": b.to(device=device, dtype=cfg.dtype)}
    return stacks, {n: i + 1 for i, n in enumerate(names)}


def stack_bytes(stacks: dict) -> int:
    """Device bytes of the stacks."""
    return sum(t.numel() * t.element_size()
               for ab in stacks.values() for t in ab.values())


def write_synthetic_adapter(cfg, path: str, seed: int, r: int = 8,
                            alpha: float | None = None,
                            targets: str = "attn") -> str:
    """Write a PEFT-format LoRA adapter of random factors (A and B both
    N(0, 0.02), from `seed`) for a model of `cfg`'s widths: the port's
    copy of the JAX bench's `_synth_adapter_dir`, with the port's
    safetensors writer and `targets` "attn" (q/v) or "attn_mlp"; alpha
    defaults to 2r. Exercises the adapter path without training one."""
    import json
    import os

    from kubeflow_tpu_torch.models.hf_import import save_safetensors

    modules = ["q_proj", "v_proj"] + (
        ["gate_proj", "up_proj", "down_proj"] if targets == "attn_mlp" else [])
    os.makedirs(path, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    tensors = {}
    for i in range(cfg.num_layers):
        for m in modules:
            n_in, n_out = _DIMS[m](cfg)
            block = "self_attn" if m in ("q_proj", "v_proj") else "mlp"
            pre = f"base_model.model.model.layers.{i}.{block}.{m}"
            tensors[f"{pre}.lora_A.weight"] = torch.randn(
                r, n_in, generator=g) * 0.02
            tensors[f"{pre}.lora_B.weight"] = torch.randn(
                n_out, r, generator=g) * 0.02
    save_safetensors(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r,
                   "lora_alpha": 2 * r if alpha is None else alpha,
                   "target_modules": modules, "bias": "none"}, f)
    return path
