"""The port's CheckpointManager on the CPU (llama_tiny, fp32).

A saved step restores bit-equal (parameters, both AdamW moments, the
count, the step, the data state); the save schedule is the JAX manager's
(orbax: the first save of a directory, then every `interval`, never at or
below the latest step), checked against it step by step; `keep` prunes;
an async save snapshots before the next in-place update; torn `*.tmp-*`
directories are swept; a truncated latest step is quarantined and the
one before restored; the `checkpoint.save` and `checkpoint.restore` fault
points fire.
"""

import os

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import checkpoint as jckpt
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.train import checkpoint as ckpt
from kubeflow_tpu_torch.train.optim import AdamW
from kubeflow_tpu_torch.train.step import init_train_state, make_train_step
from kubeflow_tpu_torch.utils import faults, resilience


@pytest.fixture(autouse=True)
def _fresh_port_metrics():
    resilience.metrics.reset()
    yield


def _state(seed=0, steps=0):
    cfg = llama.llama_tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32,
                       "param_dtype": torch.float32, "num_layers": 2})
    model = llama.Llama(cfg, device="cpu")
    state = init_train_state(model, AdamW(1e-3), seed=seed)
    if steps:
        step_fn = make_train_step(model)
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            batch = {k: torch.from_numpy(rng.integers(0, 512, (2, 8)))
                     for k in ("inputs", "targets")}
            state, _ = step_fn(state, batch)
    return state


def _tensors(state):
    return [t.detach() for t in (list(state.params)
                                 + list(state.opt_state.mu)
                                 + list(state.opt_state.nu))]


def _assert_same(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(_tensors(a), _tensors(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_equal(tmp_path, async_save):
    src = _state(seed=0, steps=2)
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=async_save)
    data = {"process_count": 1, "state": {"epoch": 1, "position": 6,
                                          "seed": 3}, "fsdp": 0}
    assert mgr.maybe_save(2, src, data_state=data)
    mgr.wait()
    dst = _state(seed=5)
    assert dst.step == 0
    got = mgr.restore(dst)
    assert got is dst
    _assert_same(src, dst)
    assert mgr.restore_data_state() == data
    assert set(os.listdir(tmp_path)) == {"2"}
    assert set(os.listdir(tmp_path / "2")) == {ckpt.STATE_FILE,
                                               ckpt.DATA_FILE}
    mgr.close()


@pytest.mark.parametrize("interval", [1, 3, 50])
def test_save_schedule_is_the_jax_managers(tmp_path, interval):
    """should_save over steps 1..12, saving wherever it says yes, against
    the JAX package's orbax-backed manager doing the same."""
    import jax.numpy as jnp

    state = _state()
    port = ckpt.CheckpointManager(tmp_path / "port", interval=interval,
                                  async_save=False)
    jax_mgr = jckpt.CheckpointManager(str(tmp_path / "jax"),
                                      interval=interval, async_save=False)
    tree = {"w": jnp.ones(2)}
    try:
        for step in range(1, 13):
            want = jax_mgr.should_save(step)
            assert port.should_save(step) == want, step
            if want:
                jax_mgr.maybe_save(step, tree)
                assert port.maybe_save(step, state)
            assert port.latest_step() == jax_mgr.latest_step()
        assert not port.should_save(port.latest_step())
    finally:
        jax_mgr.close()


def test_keep_prunes_old_steps_and_force_saves_off_schedule(tmp_path):
    state = _state()
    mgr = ckpt.CheckpointManager(tmp_path, interval=2, keep=2,
                                 async_save=False)
    for step in range(1, 8):
        mgr.maybe_save(step, state)
    assert mgr.all_steps() == [4, 6]
    assert not mgr.maybe_save(7, state)
    assert mgr.maybe_save(7, state, force=True)
    assert mgr.all_steps() == [6, 7]
    with pytest.raises(ValueError, match="already exists"):
        mgr.maybe_save(7, state, force=True)
    with pytest.raises(ValueError, match="interval"):
        ckpt.CheckpointManager(tmp_path, interval=0)


def test_async_save_snapshots_before_the_next_in_place_update(tmp_path):
    state = _state(steps=1)
    want = [t.clone() for t in _tensors(state)]
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=True)
    assert mgr.maybe_save(1, state)
    assert mgr.latest_step() == 1  # in flight counts, as in orbax
    with torch.no_grad():  # the optimizer's in-place update, next step
        for t in _tensors(state):
            t.add_(1.0)
    mgr.wait()
    dst = mgr.restore(_state(seed=3))
    for got, ref in zip(_tensors(dst), want, strict=True):
        assert got.numpy().tobytes() == ref.numpy().tobytes()


def test_stale_tmp_dirs_are_swept(tmp_path):
    (tmp_path / "5.tmp-123").mkdir()
    (tmp_path / "5.tmp-123" / ckpt.STATE_FILE).write_bytes(b"torn")
    (tmp_path / "3").mkdir()
    mgr = ckpt.CheckpointManager(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["3"]
    assert mgr.all_steps() == [3]
    assert resilience.metrics.get("tpk_checkpoint_tmp_swept_total",
                                  component="train") == 1


def test_truncated_latest_step_is_quarantined(tmp_path):
    first = _state(seed=0, steps=1)
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=False)
    mgr.maybe_save(1, first)
    second = _state(seed=0, steps=2)
    mgr.maybe_save(2, second)
    path = tmp_path / "2" / ckpt.STATE_FILE
    path.write_bytes(path.read_bytes()[:1000])
    dst = _state(seed=9)
    got, step, bad = ckpt.CheckpointManager(tmp_path).restore_latest_good(
        dst)
    assert (step, bad) == (1, [2])
    _assert_same(first, got)
    assert os.listdir(tmp_path / ckpt.QUARANTINE_DIR) == ["2"]
    assert resilience.metrics.get("tpk_checkpoint_quarantined_total",
                                  component="train") == 1
    # Everything torn: nothing restorable, the state untouched.
    (tmp_path / "1" / ckpt.STATE_FILE).write_bytes(b"")
    fresh = _state(seed=4)
    want = [t.clone() for t in _tensors(fresh)]
    got, step, bad = mgr.restore_latest_good(fresh)
    assert (step, bad) == (None, [1])
    for t, w in zip(_tensors(got), want):
        assert torch.equal(t, w)


def test_a_state_that_does_not_fit_raises_before_copying(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=False)
    mgr.maybe_save(1, _state(steps=1))
    cfg = llama.llama_tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32,
                       "param_dtype": torch.float32, "num_layers": 3})
    other = init_train_state(llama.Llama(cfg, device="cpu"), AdamW(1e-3))
    want = [t.clone() for t in _tensors(other)]
    with pytest.raises(ValueError, match="parameters|does not fit"):
        mgr.restore(other)
    for t, w in zip(_tensors(other), want):
        assert torch.equal(t, w)


def test_data_state_missing_or_unreadable_is_none(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=False)
    assert mgr.restore_data_state() is None
    mgr.maybe_save(1, _state())
    assert mgr.restore_data_state() is None
    mgr.maybe_save(2, _state(), data_state={"a": 1})
    assert mgr.restore_data_state() == {"a": 1}
    (tmp_path / "2" / ckpt.DATA_FILE).write_text("{torn")
    assert mgr.restore_data_state() is None
    assert mgr.restore_data_state(1) is None


@pytest.mark.parametrize("point", ["checkpoint.save", "checkpoint.restore"])
def test_fault_points_fire(tmp_path, point):
    state = _state()
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=False)
    if point == "checkpoint.restore":
        mgr.maybe_save(1, state)
    with faults.harness(seed=0) as h:
        h.arm(point, faults.FailN(1, match={"step": 1}))
        with pytest.raises(faults.FaultError):
            if point == "checkpoint.save":
                mgr.maybe_save(1, state)
            else:
                mgr.restore(state)
        # The fault was transient: the retry lands.
        if point == "checkpoint.save":
            assert mgr.maybe_save(1, state)
        else:
            assert mgr.restore(state) is state
    assert h.counts[point] == {"fired": 2, "injected": 1, "delayed": 0}


def test_an_async_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    state = _state()
    mgr = ckpt.CheckpointManager(tmp_path, interval=1, async_save=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    assert mgr.maybe_save(1, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    mgr.wait()  # the error is raised once
