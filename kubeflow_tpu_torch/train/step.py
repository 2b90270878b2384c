"""Train-step factory: loss, gradients and the optimizer update, eagerly.

The port of `kubeflow_tpu/train/step.py` for one device. JAX jits the whole
step (forward, backward, optimizer) into one donated executable; here the
step is eager PyTorch: autograd for the gradients (the flash backward
kernels among them), then `optim.AdamW.update` in place. Nothing in the
step waits for the device: the metrics it returns are device tensors.

`trainable="lora"` differentiates and updates the LoRA adapters alone
(the JAX `lora_step`): the base is frozen, gets no gradient and no
optimizer state. A model with routed experts (`sows_aux`) adds its
layers' load-balance terms to the loss, as JAX adds the sown `aux_loss`
collection. `make_eval_step` is the JAX eval step. Mesh, FSDP and
pipeline parallelism are not ported and are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.train import lora
from kubeflow_tpu_torch.train.optim import AdamW, AdamWState, global_norm

TRAINABLE = (None, "lora")
# The JAX step's and trainer's refusal of fsdp with LoRA, as one message.
FSDP_WITH_LORA = ("fsdp master sharding doesn't compose with trainable="
                  "'lora' (the adapter-only optimizer state is the memory "
                  "win there)")


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters are the params, all of them,
    frozen base included) and the optimizer with its state over the
    trainable ones (`trainable` None: every parameter; "lora": the
    adapters). `train_named` ({name: parameter} of what the optimizer
    updates, in parameter order; the moments follow it) is decided once,
    when the state is made. Updated in place by the step."""

    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: AdamW
    trainable: str | None = None
    train_named: dict | None = None

    def __post_init__(self):
        if self.train_named is None:
            self.train_named = (lora.partition(self.model)[0]
                                if self.trainable == "lora"
                                else dict(self.model.named_parameters()))

    @property
    def params(self) -> list:
        return list(self.model.parameters())

    @property
    def train_params(self) -> list:
        return list(self.train_named.values())


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


def _ce_block(hx, head, tx, mx, final_softcap):
    """(Σ nll·mask, Σ mask) of one chunk of rows."""
    logits = F.linear(hx, head.to(hx.dtype)).float()
    if final_softcap:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tx[:, None].long())[:, 0]
    return ((logz - gold) * mx).sum(), mx.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor,
                          mask: torch.Tensor | None = None, *,
                          chunk: int = 1024,
                          final_softcap: float = 0.0) -> torch.Tensor:
    """Blockwise cross entropy: logits are computed per chunk of rows
    against the unembedding and never materialised as the [B·S, V] fp32
    buffer. Each chunk runs under `torch.utils.checkpoint`, so the
    backward recomputes its logits (the JAX `jax.checkpoint` on the scan
    body). Chunk sums are added in row order, as the JAX scan adds them.

    hidden [B,S,D]; head [V,D] (the port's lm_head weight or the tied
    embedding; the JAX function also takes the flax [D,V] kernel); targets
    [B,S]. Padded rows carry mask 0. `final_softcap` applies Gemma-2's
    logit cap tanh(l/cap)*cap to each chunk's fp32 logits, as JAX's does:
    the hidden states skip the model's own cap."""
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
                            m[i:i + chunk], final_softcap,
                            use_reentrant=False)
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


def _check_trainable(trainable) -> None:
    if trainable not in TRAINABLE:
        raise ValueError(f"trainable {trainable!r}: None or 'lora'")


def init_train_state(model: nn.Module, tx: AdamW, seed: int | None = 0,
                     params: dict | None = None,
                     trainable: str | None = None) -> TrainState:
    """Weights from `seed` (`model.init_weights`) or from a state dict
    (`params`, e.g. converted from a JAX tree), and a fresh optimizer
    state at step 0. `trainable="lora"` freezes the base
    (`lora.freeze_base`) and gives the optimizer state to the adapters
    alone."""
    _check_trainable(trainable)
    if params is not None:
        model.load_state_dict(params)
    else:
        model.init_weights(seed)
    if trainable == "lora":
        lora.freeze_base(model)
    state = TrainState(step=0, model=model, opt_state=None, tx=tx,
                       trainable=trainable)
    state.opt_state = tx.init(state.train_params)
    return state


def _refuse(pipeline, fsdp, mesh) -> None:
    refused = [
        (pipeline, "pipeline parallelism (pipeline=...)"),
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
    arithmetic). grad_norm is the pre-clip global norm.

    trainable="lora" differentiates only the adapters (`torch.autograd.grad`
    over them: the frozen base gets no `.grad` and no weight-gradient
    product) and updates them alone; grad_norm is theirs. The step trains
    what the state's optimizer covers (`state.train_named`); `trainable`
    is the JAX signature's, checked here against the model and at each
    call against the state it must come from
    (`init_train_state(..., trainable="lora")`). JAX raises for fsdp with
    LoRA; so does this (before refusing fsdp as unported)."""
    _check_trainable(trainable)
    if trainable == "lora":
        lora.partition(model)  # raises without adapters
        if fsdp:
            raise ValueError(FSDP_WITH_LORA)
    _refuse(pipeline, fsdp, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if loss_impl not in ("full", "chunked"):
        raise ValueError(f"loss_impl {loss_impl!r}: full | chunked")
    if loss_impl == "chunked" and loss_fn is not None:
        raise ValueError("loss_impl='chunked' implies the built-in LM loss")
    if loss_chunk < 1:
        raise ValueError(f"loss_chunk must be >= 1, got {loss_chunk}")

    # Routed experts return their load-balance terms (JAX's mutable
    # "aux_loss" collection); other models add a zero.
    sows_aux = getattr(model, "sows_aux", False)

    def compute_loss(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        kwargs = {key: batch[key] for key in ("segment_ids", "positions")
                  if key in batch}
        if loss_impl == "chunked":
            kwargs["return_hidden"] = True
        if sows_aux:
            kwargs["return_aux"] = True
        out = model(batch["inputs"], **kwargs)
        aux = None
        if sows_aux:
            out, aux = out
        if loss_impl == "chunked":
            main = chunked_cross_entropy(
                out, _unembed_head(model), batch["targets"],
                batch.get("mask"), chunk=loss_chunk,
                final_softcap=getattr(getattr(model, "cfg", None),
                                      "final_softcap", 0.0))
        elif loss_fn is not None:
            main = loss_fn(out, batch)
        else:
            main = cross_entropy_loss(out, batch["targets"],
                                      batch.get("mask"))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=main.device)
        return main + aux, aux

    def loss_and_grads(params: list, batch: dict):
        if accum_steps == 1:
            loss, aux = compute_loss(batch)
            return (loss.detach(), aux.detach(),
                    torch.autograd.grad(loss, params))
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
                lsum, asum = loss.detach(), aux.detach()
            else:
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
                lsum, asum = lsum + loss.detach(), asum + aux.detach()
        grads = [(g / accum_steps).to(p.dtype) for g, p in zip(gsum, params)]
        return lsum / accum_steps, asum / accum_steps, grads

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if state.trainable != trainable:
            raise ValueError(f"the state's optimizer covers trainable="
                             f"{state.trainable!r}, the step trains "
                             f"trainable={trainable!r}")
        params = state.train_params
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
