"""Train-step factory: loss, gradients and the optimizer update, eagerly.

The port of `kubeflow_tpu/train/step.py` for one device. JAX jits the whole
step (forward, backward, optimizer) into one donated executable; here the
step is eager PyTorch: autograd for the gradients (the flash backward
kernels among them), then `optim.AdamW.update` in place. Nothing in the
step waits for the device: the metrics it returns are device tensors.

`make_eval_step` is the JAX eval step. Mesh, FSDP, pipeline parallelism
and LoRA (`trainable="lora"`) are not ported and are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.train.optim import AdamW, AdamWState, global_norm


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters are the params) and the
    optimizer with its state. Updated in place by the step."""

    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: AdamW

    @property
    def params(self) -> list:
        return list(self.model.parameters())


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in fp32. logits [..., V], targets
    [...]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _ce_block(hx, head, tx, mx):
    """(Σ nll·mask, Σ mask) of one chunk of rows."""
    logits = F.linear(hx, head.to(hx.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tx[:, None].long())[:, 0]
    return ((logz - gold) * mx).sum(), mx.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor,
                          mask: torch.Tensor | None = None, *,
                          chunk: int = 1024) -> torch.Tensor:
    """Blockwise cross entropy: logits are computed per chunk of rows
    against the unembedding and never materialised as the [B·S, V] fp32
    buffer. Each chunk runs under `torch.utils.checkpoint`, so the
    backward recomputes its logits (the JAX `jax.checkpoint` on the scan
    body). Chunk sums are added in row order, as the JAX scan adds them.

    hidden [B,S,D]; head [V,D] (the port's lm_head weight or the tied
    embedding; the JAX function also takes the flax [D,V] kernel); targets
    [B,S]. Padded rows carry mask 0."""
    b, s, d = hidden.shape
    n = b * s
    h = hidden.reshape(n, d)
    t = targets.reshape(n)
    m = (torch.ones(n, dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(n).float())
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        t = F.pad(t, (0, pad))
        m = F.pad(m, (0, pad))  # padded rows carry mask 0
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n + pad, chunk):
        bt, bc = checkpoint(_ce_block, h[i:i + chunk], head, t[i:i + chunk],
                            m[i:i + chunk], use_reentrant=False)
        tot, cnt = tot + bt, cnt + bc
    return tot / cnt.clamp_min(1.0)


def _unembed_head(model: nn.Module) -> torch.Tensor:
    """The chunked loss's head [V,D]: the lm_head weight, or the tied
    embedding."""
    head = getattr(model, "lm_head", None)
    if head is not None:
        return head.weight
    embed = getattr(model, "embed", None)
    if embed is not None:
        return embed
    raise ValueError("chunked loss needs an 'lm_head' or tied 'embed' "
                     "parameter")


def init_train_state(model: nn.Module, tx: AdamW, seed: int | None = 0,
                     params: dict | None = None) -> TrainState:
    """Weights from `seed` (`model.init_weights`) or from a state dict
    (`params`, e.g. converted from a JAX tree), and a fresh optimizer
    state at step 0."""
    if params is not None:
        model.load_state_dict(params)
    else:
        model.init_weights(seed)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(list(model.parameters())), tx=tx)


def _refuse(pipeline, trainable, fsdp, mesh) -> None:
    refused = [
        (pipeline, "pipeline parallelism (pipeline=...)"),
        (trainable is not None, f"trainable={trainable!r} (LoRA)"),
        (fsdp, "FSDP master-state sharding (fsdp=...)"),
        (mesh is not None, "a device mesh (mesh=...)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not supported by this "
                                      "package yet")


def make_train_step(model: nn.Module, loss_fn: Callable | None = None,
                    loss_impl: str = "full", loss_chunk: int = 1024,
                    accum_steps: int = 1, pipeline: dict | None = None,
                    trainable: str | None = None, fsdp=None, mesh=None
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    """The train step for a causal-LM batch:
      batch = {"inputs": [B,S] int, "targets": [B,S] int,
               "mask": optional [B,S], "segment_ids"/"positions": optional}
    of tensors on the model's device. Returns (state, {"loss", "aux_loss",
    "grad_norm", "step"}); loss, aux_loss and grad_norm stay on the device.

    loss_impl="chunked" computes the cross entropy blockwise against the
    unembedding (`chunked_cross_entropy`). accum_steps > 1 differentiates
    accum_steps row slices in order, sums their fp32 grads and divides by
    accum_steps before the single optimizer update (the JAX scan's
    arithmetic). grad_norm is the pre-clip global norm."""
    _refuse(pipeline, trainable, fsdp, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if loss_impl not in ("full", "chunked"):
        raise ValueError(f"loss_impl {loss_impl!r}: full | chunked")
    if loss_impl == "chunked" and loss_fn is not None:
        raise ValueError("loss_impl='chunked' implies the built-in LM loss")
    if loss_chunk < 1:
        raise ValueError(f"loss_chunk must be >= 1, got {loss_chunk}")

    def compute_loss(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        kwargs = {key: batch[key] for key in ("segment_ids", "positions")
                  if key in batch}
        if loss_impl == "chunked":
            hidden = model(batch["inputs"], return_hidden=True, **kwargs)
            main = chunked_cross_entropy(
                hidden, _unembed_head(model), batch["targets"],
                batch.get("mask"), chunk=loss_chunk)
        else:
            logits = model(batch["inputs"], **kwargs)
            if loss_fn is not None:
                main = loss_fn(logits, batch)
            else:
                main = cross_entropy_loss(logits, batch["targets"],
                                          batch.get("mask"))
        aux = torch.zeros((), dtype=torch.float32, device=main.device)
        return main + aux, aux

    def loss_and_grads(params: list, batch: dict):
        if accum_steps == 1:
            loss, aux = compute_loss(batch)
            return loss.detach(), aux, torch.autograd.grad(loss, params)
        rows = batch["inputs"].shape[0]
        if rows % accum_steps:
            raise ValueError(f"batch dim {rows} not divisible by "
                             f"accum_steps {accum_steps}")
        size = rows // accum_steps
        gsum = lsum = asum = None
        for i in range(accum_steps):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, aux = compute_loss(micro)
            grads = torch.autograd.grad(loss, params)
            if gsum is None:
                gsum = [g.float() for g in grads]
                lsum, asum = loss.detach(), aux
            else:
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
                lsum, asum = lsum + loss.detach(), asum + aux
        grads = [(g / accum_steps).to(p.dtype) for g, p in zip(gsum, params)]
        return lsum / accum_steps, asum / accum_steps, grads

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.params
        loss, aux, grads = loss_and_grads(params, batch)
        gnorm = global_norm(grads)
        state.opt_state = state.tx.update(params, grads, state.opt_state,
                                          grad_norm=gnorm)
        state.step += 1
        return state, {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                       "step": state.step}

    return step


def make_eval_step(model: nn.Module) -> Callable[[list, dict], dict]:
    """The eval step of `kubeflow_tpu/train/step.py`: `(params, batch) ->
    {"loss", "accuracy"}`, device scalars, without gradients. Like the JAX
    step it runs the model on `batch["inputs"]` alone (segment ids and
    positions are not passed) and takes the cross entropy and the argmax
    accuracy under `batch["mask"]` when there is one. `params` is
    accepted for the JAX signature; the model's own parameters are
    used."""

    @torch.no_grad()
    def step(params, batch: dict) -> dict:
        logits = model(batch["inputs"]).float()
        mask = batch.get("mask")
        loss = cross_entropy_loss(logits, batch["targets"], mask)
        hits = (logits.argmax(-1) == batch["targets"]).float()
        if mask is not None:
            m = mask.float()
            acc = (hits * m).sum() / m.sum().clamp_min(1.0)
        else:
            acc = hits.mean()
        return {"loss": loss, "accuracy": acc}

    return step
