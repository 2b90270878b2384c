"""The port's optimizer: optax's adamw, clip_by_global_norm and schedules.

The counterpart of the optax calls of `kubeflow_tpu/train/step.py` and
`kubeflow_tpu/train/trainer.py` (`optax.adamw(schedule, weight_decay)`,
optionally chained after `optax.clip_by_global_norm`), written as plain
tensor arithmetic with optax 0.2.6's semantics:

  * scale_by_adam: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, bias
    corrections at the incremented count, update = mu_hat / (sqrt(nu_hat)
    + eps) (optax's eps_root = 0). The update uses the fp32 mu; mu is then STORED in
    `mu_dtype` (b1·mu is taken in the stored dtype, b1 rounded to it, as
    optax's weak typing does). `torch.optim.AdamW` does not do this, hence
    this module;
  * add_decayed_weights: + weight_decay·p on every leaf (no mask);
  * scale_by_learning_rate: × -lr, the schedule evaluated at the count
    BEFORE this update;
  * clip_by_global_norm (when max_grad_norm > 0): g·max_norm/‖g‖ when
    ‖g‖ ≥ max_norm.

Parameters are updated in place (the port keeps one copy of the fp32
master weights instead of returning a new tree). Schedules are functions
of the Python step count, evaluated on the host in float64 (optax: fp32 on
the device), so nothing here waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial_schedule with power 1)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i+1 takes over at boundary i, fed
    the step count relative to it."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup to the peak, then
    cosine decay to end_value at `decay_steps` (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha=alpha)],
        [warmup_steps])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ Σ x²) over every tensor, in fp32, on the tensors' device."""
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


@dataclasses.dataclass
class AdamWState:
    """optax ScaleByAdamState: the update count and both moments, one
    tensor per parameter in parameter order."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(learning_rate, b1, b2, eps, mu_dtype, weight_decay),
    chained after clip_by_global_norm(max_grad_norm) when
    max_grad_norm > 0. `learning_rate` is a float or a Schedule."""

    learning_rate: float | Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: torch.dtype | None = None
    max_grad_norm: float = 0.0

    def __post_init__(self):
        if self.max_grad_norm < 0:
            raise ValueError(f"max_grad_norm must be >= 0, got "
                             f"{self.max_grad_norm}")

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: AdamWState,
               grad_norm: torch.Tensor | None = None) -> AdamWState:
        """One step: params updated in place, moments in place; returns
        the state with the incremented count. `grad_norm` (the pre-clip
        global norm) is computed when not given."""
        if self.max_grad_norm:
            if grad_norm is None:
                grad_norm = global_norm(grads)
            factor = torch.where(grad_norm < self.max_grad_norm,
                                 torch.ones_like(grad_norm),
                                 self.max_grad_norm / grad_norm)
            grads = [g * factor.to(g.dtype) for g in grads]
        step_size = -self.lr(state.count)  # at the pre-increment count
        count = state.count + 1
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            # b1·mu in mu's dtype with b1 rounded to it first (JAX's weak
            # typing: bf16 mu decays by bf16(0.9)); the sum is fp32.
            m = (1 - self.b1) * g + mu * torch.tensor(self.b1, dtype=mu.dtype)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            upd = (m / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd = upd + self.weight_decay * p
            p.add_(step_size * upd)
            mu.copy_(m)  # stored in mu_dtype
        return AdamWState(count=count, mu=state.mu, nu=state.nu)
