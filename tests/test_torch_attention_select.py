"""Which attention path `attention_impl="auto"` takes, and which kernels.

The wgmma flash kernels take bf16 q/k/v with head_dim 64 or 128 on a CUDA
device (`cuda_kernel_takes`); the CUDA-core kernels take fp32, bf16 or fp16
up to head_dim 256 (`simt_kernel_takes`); `cuda_flash_takes` is either. The
model's `auto` takes flash wherever a kernel takes the inputs on CUDA, as
the JAX model's auto takes its Pallas kernel on the TPU for any dtype and
head dim, and naive on the CPU. These run on the CPU: the rules are tested
on dtype, head dim and device arguments, and the model's choice with the
predicate and the flash entry point replaced by recorders.
"""

import dataclasses

import pytest
import torch

from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops.reference import naive_attention


@pytest.mark.parametrize("dtype,head_dim,device,takes", [
    (torch.bfloat16, 64, "cuda", True),
    (torch.bfloat16, 128, "cuda", True),
    (torch.bfloat16, 128, torch.device("cuda", 0), True),
    (torch.float32, 128, "cuda", False),
    (torch.float16, 128, "cuda", False),
    (torch.bfloat16, 16, "cuda", False),
    (torch.bfloat16, 32, "cuda", False),
    (torch.bfloat16, 256, "cuda", False),
    (torch.bfloat16, 128, "cpu", False),
    (torch.float32, 16, "cpu", False),
])
def test_cuda_kernel_takes(dtype, head_dim, device, takes):
    assert tfa.cuda_kernel_takes(dtype, head_dim, device) is takes


@pytest.mark.parametrize("dtype,head_dim,device,takes", [
    (torch.float32, 16, "cuda", True),
    (torch.float32, 128, "cuda", True),
    (torch.bfloat16, 16, "cuda", True),
    (torch.float16, 96, "cuda", True),
    (torch.bfloat16, 256, "cuda", True),
    (torch.float32, 1, "cuda", True),
    (torch.bfloat16, 257, "cuda", False),
    (torch.float64, 64, "cuda", False),
    (torch.float32, 16, "cpu", False),
])
def test_simt_kernel_takes(dtype, head_dim, device, takes):
    assert tfa.simt_kernel_takes(dtype, head_dim, device) is takes
    assert tfa.cuda_flash_takes(dtype, head_dim, device) is takes


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 16, "simt"),    # llama_tiny
    (torch.bfloat16, 96, "simt"),
    (torch.float32, 128, "simt"),    # an fp32 model
    (torch.float16, 128, "simt"),
    (torch.bfloat16, 512, None),
    (torch.float64, 64, None),
])
def test_cuda_route(dtype, head_dim, route):
    """The wgmma kernels where they take the inputs, else the CUDA-core
    kernels; neither raises, naming both limits."""
    if route is None:
        with pytest.raises(ValueError, match="no CUDA flash kernel takes"):
            tfa._cuda_route(dtype, head_dim, "cuda")
    else:
        assert tfa._cuda_route(dtype, head_dim, "cuda") == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_rule_matches_the_wrappers_dtype_check(dtype):
    """One rule: the kernel wrappers' input check refuses exactly the
    dtypes the predicate says the kernels do not take (the check itself
    runs on any device)."""
    x = torch.zeros(1, 8, 2, 64, dtype=dtype)
    if tfa.cuda_kernel_takes(dtype, 64, "cuda"):
        tfa._check_kernel_inputs((("q", x),), x.device)
    else:
        with pytest.raises(TypeError, match="bf16"):
            tfa._check_kernel_inputs((("q", x),), x.device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
def test_simt_rule_matches_its_wrappers_dtype_check(dtype):
    """The CUDA-core wrappers' input check refuses exactly the dtypes their
    rule says they do not take, and a k of another dtype than q."""
    x = torch.zeros(1, 8, 2, 16, dtype=dtype)
    if tfa.simt_kernel_takes(dtype, 16, "cuda"):
        tfa._check_simt_inputs((("q", x),), x.device, dtype)
        other = torch.float64 if dtype != torch.float64 else torch.float32
        with pytest.raises(TypeError, match="k is"):
            tfa._check_simt_inputs((("k", x.to(other)),), x.device, dtype)
    else:
        with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
            tfa._check_simt_inputs((("q", x),), x.device, dtype)


def _tiny(**kw):
    cfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32, **kw)
    return tl.Llama(cfg, device="cpu").init_weights(0)


class _Recorder:
    """Stands in for flash_attention (computing the naive result) and for
    the predicate (answering `takes`), recording what each was asked."""

    def __init__(self, takes):
        self.takes, self.asked, self.flash_calls = takes, [], 0

    def predicate(self, dtype, head_dim, device):
        self.asked.append((dtype, head_dim, torch.device(device).type))
        return self.takes

    def flash(self, q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        self.flash_calls += 1
        return naive_attention(q, k, v, causal=causal, mask=mask,
                               segment_ids=segment_ids)


@pytest.mark.parametrize("takes", [True, False])
def test_auto_asks_the_rule_with_the_inputs(monkeypatch, takes):
    """auto takes flash exactly when the rule holds for q's dtype, the head
    dim and q's device, once per layer."""
    rec = _Recorder(takes)
    monkeypatch.setattr(tl, "cuda_flash_takes", rec.predicate)
    monkeypatch.setattr(tl, "flash_attention", rec.flash)
    model = _tiny()
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 12))
    with torch.no_grad():
        model(tokens)
    layers = model.cfg.num_layers
    assert rec.asked == [(torch.float32, model.cfg.head_dim, "cpu")] * layers
    assert rec.flash_calls == (layers if takes else 0)


def test_auto_on_cpu_stays_naive(monkeypatch):
    """On the CPU the real rule is false, so auto never reaches flash (as
    before the rule existed)."""
    rec = _Recorder(True)
    monkeypatch.setattr(tl, "flash_attention", rec.flash)
    model = _tiny()
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 12))
    with torch.no_grad():
        model(tokens)
    assert rec.flash_calls == 0


@pytest.mark.parametrize("impl,calls", [("flash", 2), ("naive", 0)])
def test_explicit_impl_does_not_ask_the_rule(monkeypatch, impl, calls):
    """An explicit impl is taken as given: the rule is not consulted, so an
    explicit "flash" still reaches the kernel wrappers (which raise on
    inputs no kernel takes)."""
    rec = _Recorder(False)
    monkeypatch.setattr(tl, "cuda_flash_takes", rec.predicate)
    monkeypatch.setattr(tl, "flash_attention", rec.flash)
    model = _tiny(attention_impl=impl)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 12))
    with torch.no_grad():
        model(tokens)
    assert rec.asked == []
    assert rec.flash_calls == calls
