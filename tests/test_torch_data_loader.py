"""The port's file-backed loader and prefetcher against the JAX package's.

Corpora are written from a numpy seed into tmp_path. With shuffle=False
the port's batches (windows and packed rows: inputs, targets, segment ids,
positions, mask) are byte-equal to the grain pipeline's, over epoch
boundaries, over-long documents and padding, for every process shard.
The shuffled stream is the port's own order (one PCG64 permutation per
seed and epoch, not grain's): each epoch holds the same rows, and seeking
to a saved state equals replaying to it. The prefetcher pairs its resume
state with the batch handed out, not with its read-ahead.
"""

import json

import numpy as np
import pytest

from kubeflow_tpu.data import loader as jloader
from kubeflow_tpu_torch.data import loader as tloader
from kubeflow_tpu_torch.data.prefetch import Prefetcher
from kubeflow_tpu_torch.utils import faults, registry

VOCAB = 300


def _docs_corpus(seed=0, n_docs=80, lo=2, hi=70, vocab=VOCAB):
    """eos(0)-terminated documents; hi above the row cap of seq 16 makes
    over-long documents that are chunked."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        doc = rng.integers(1, vocab, int(rng.integers(lo, hi)),
                           dtype=np.int32)
        doc[-1] = 0
        docs.append(doc)
    return np.concatenate(docs)


def _build(kind, mod, source, **kw):
    if kind == "lm":
        return mod.lm_dataset(source, **kw)
    return mod.packed_lm_dataset(source, eos_id=0, **kw)


def _assert_equal_batches(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("kind", ["lm", "packed"])
@pytest.mark.parametrize("shard", [(0, 1), (0, 3), (1, 3), (2, 3)],
                         ids=lambda s: f"proc{s[0]}of{s[1]}")
def test_batches_are_byte_equal_to_the_jax_loader(kind, shard):
    tokens = _docs_corpus()
    kw = dict(batch_size=3, seq_len=16, shuffle=False,
              process_index=shard[0], process_count=shard[1],
              vocab_size=VOCAB)
    want, got = (iter(_build(kind, m, tokens, **kw))
                 for m in (jloader, tloader))
    # Enough batches to cross the shard's epoch boundary at least once.
    rows = len(_build(kind, tloader, tokens, **kw)._rows)
    for _ in range(2 * rows // (3 * shard[1]) + 2):
        _assert_equal_batches(next(want), next(got))


@pytest.mark.parametrize("kind", ["lm", "packed"])
@pytest.mark.parametrize("epochs", [1, 2])
def test_finite_epochs_drop_the_remainder_as_grain_does(kind, epochs):
    tokens = _docs_corpus(seed=3)
    kw = dict(batch_size=4, seq_len=16, shuffle=False, num_epochs=epochs,
              process_index=0, process_count=1)
    want = list(_build(kind, jloader, tokens, **kw))
    ds = _build(kind, tloader, tokens, **kw)
    got = list(ds)
    assert len(got) == len(want) == len(ds)
    for a, b in zip(want, got):
        _assert_equal_batches(a, b)


def test_packed_rows_cover_long_documents_and_padding():
    tokens = _docs_corpus(seed=1)
    rows = tloader._PackedRows(tokens, 16, 0)
    jrows = jloader._PackedRows(tokens, 16, 0)
    assert len(rows) == len(jrows)
    seen_pad = seen_chunk = False
    for i in range(len(rows)):
        _assert_equal_batches(jrows[i], rows[i])
        r = rows[i]
        seen_pad |= bool((r["segment_ids"] == -1).any())
        # A chunk of an over-long document fills a whole row, no eos.
        seen_chunk |= bool((r["segment_ids"] == 0).all()
                           and (r["inputs"] != 0).all())
        assert (r["mask"][r["segment_ids"] < 0] == 0).all()
    assert seen_pad and seen_chunk
    with pytest.raises(IndexError):
        rows[len(rows)]


@pytest.mark.parametrize("suffix", [".npy", ".bin", ".txt"])
def test_token_files_load_as_the_jax_loader_loads_them(tmp_path, suffix):
    tokens = _docs_corpus(seed=2, vocab=256)
    path = tmp_path / f"corpus{suffix}"
    if suffix == ".npy":
        np.save(path, tokens)
    elif suffix == ".bin":
        tokens.tofile(path)
    else:
        path.write_bytes(tokens.astype(np.uint8).tobytes())
    got, want = tloader.load_tokens(path), jloader.load_tokens(path)
    assert got.dtype == np.int32 and got.tobytes() == want.tobytes()
    ds = registry.build_dataset("token_file", path=str(path), batch_size=2,
                                seq_len=8, shuffle=False, vocab_size=256,
                                process_index=0, process_count=1)
    jds = jloader.lm_dataset(str(path), batch_size=2, seq_len=8,
                             shuffle=False, vocab_size=256,
                             process_index=0, process_count=1)
    for a, b in zip(iter(jds), [ds[i] for i in range(4)]):
        _assert_equal_batches(a, b)


@pytest.mark.parametrize("kind", ["lm", "packed"])
@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_epochs_hold_the_same_rows(kind, seed):
    tokens = _docs_corpus(seed=4)
    kw = dict(batch_size=4, seq_len=16, seed=seed, process_index=0,
              process_count=1)
    plain = _build(kind, tloader, tokens, shuffle=False, **kw)
    shuffled = _build(kind, tloader, tokens, shuffle=True, **kw)
    n = plain.rows_per_epoch

    def rows(ds, count):
        out = []
        it = iter(ds)
        while len(out) < count:
            b = next(it)
            first = b["inputs"]
            out += [b"".join(b[k][r].tobytes() for k in sorted(b))
                    for r in range(first.shape[0])]
        return out[:count]

    base = sorted(rows(plain, n))
    epochs = rows(shuffled, 2 * n)
    assert sorted(epochs[:n]) == base
    assert sorted(epochs[n:]) == base
    assert epochs[:n] != epochs[n:]  # a fresh permutation each epoch
    assert epochs[:n] != rows(plain, n)
    other = rows(_build(kind, tloader, tokens, shuffle=True,
                        **{**kw, "seed": seed + 1}), n)
    assert other != epochs[:n]


@pytest.mark.parametrize("kind", ["lm", "packed"])
@pytest.mark.parametrize("skip", [0, 1, 5, 13])
def test_set_state_equals_replay(kind, skip):
    tokens = _docs_corpus(seed=5)
    ds = _build(kind, tloader, tokens, batch_size=3, seq_len=16, seed=11,
                shuffle=True)
    it = iter(ds)
    for _ in range(skip):
        next(it)
    state = json.loads(json.dumps(tloader.iterator_state(it)))
    assert set(state) == {"epoch", "position", "seed"}
    want = [next(it) for _ in range(6)]
    fresh = iter(ds)
    assert tloader.restore_iterator(fresh, state)
    for a in want:
        _assert_equal_batches(a, next(fresh))


def test_iterator_state_errors_and_plain_generators():
    ds = tloader.lm_dataset(_docs_corpus(), batch_size=3, seq_len=16)
    it = iter(ds)
    state = it.get_state()
    with pytest.raises(ValueError, match="seed"):
        it.set_state({**state, "seed": 99})
    with pytest.raises(ValueError, match="batch boundary"):
        it.set_state({**state, "position": 1})
    gen = (x for x in range(3))
    assert tloader.iterator_state(gen) is None
    assert not tloader.restore_iterator(gen, {"epoch": 0})
    assert not tloader.restore_iterator(it, None)


def test_loader_errors(tmp_path):
    tokens = _docs_corpus()
    with pytest.raises(ValueError, match="batch_size"):
        tloader.lm_dataset(tokens[:100], batch_size=8, seq_len=16)
    with pytest.raises(ValueError, match="corpus too small for 3 procs"):
        tloader.packed_lm_dataset(tokens, eos_id=0, batch_size=400,
                                  seq_len=16, process_index=1,
                                  process_count=3)
    with pytest.raises(ValueError, match="model vocab is 100"):
        tloader.lm_dataset(tokens, batch_size=2, seq_len=16, vocab_size=100)
    np.save(tmp_path / "f.npy", tokens.astype(np.float32))
    with pytest.raises(ValueError, match="must be integers"):
        tloader.load_tokens(tmp_path / "f.npy")
    np.save(tmp_path / "big.npy", np.array([1, 2**40], np.int64))
    with pytest.raises(ValueError, match="overflow int32"):
        tloader.load_tokens(tmp_path / "big.npy")
    np.save(tmp_path / "i64.npy", tokens.astype(np.int64))
    assert tloader.load_tokens(tmp_path / "i64.npy").tobytes() == \
        tokens.tobytes()
    with pytest.raises(FileNotFoundError):
        tloader.load_tokens(tmp_path / "missing.npy")
    with pytest.raises(ValueError, match="can't fill one window"):
        tloader.lm_dataset(tokens[:10], batch_size=1, seq_len=16)
    with pytest.raises(ValueError, match="no packed row"):
        tloader._PackedRows(np.zeros(0, np.int32), 16, 0)
    with pytest.raises(ValueError, match="process_index"):
        tloader.lm_dataset(tokens, batch_size=1, seq_len=16,
                           process_index=3, process_count=3)


def test_registry_builds_the_corpus_datasets(tmp_path):
    path = tmp_path / "c.npy"
    np.save(path, _docs_corpus())
    assert {"token_file", "packed_lm"} <= set(registry.list_datasets())
    packed = registry.build_dataset("packed_lm", path=str(path),
                                    batch_size=2, seq_len=16, seed=3,
                                    vocab_size=VOCAB, process_index=1,
                                    process_count=2)
    want = jloader.packed_lm_dataset(str(path), eos_id=0, batch_size=2,
                                     seq_len=16, shuffle=False,
                                     process_index=1, process_count=2)
    plain = registry.build_dataset("packed_lm", path=str(path),
                                   batch_size=2, seq_len=16, shuffle=False,
                                   process_index=1, process_count=2)
    _assert_equal_batches(next(iter(want)), next(iter(plain)))
    assert set(next(iter(packed))) == {"inputs", "targets", "segment_ids",
                                       "positions", "mask"}
    with pytest.raises(ValueError, match="model vocab"):
        registry.build_dataset("token_file", path=str(path), batch_size=2,
                               seq_len=16, vocab_size=10)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_consumed_state_is_the_batch_handed_out(depth):
    ds = tloader.lm_dataset(_docs_corpus(), batch_size=2, seq_len=16,
                            seed=1)
    ref = iter(ds)
    want_states = [ref.get_state()]
    for _ in range(5):
        next(ref)
        want_states.append(ref.get_state())
    with Prefetcher(iter(ds), depth=depth, device="cpu") as pf:
        assert pf.consumed_state() == want_states[0]
        for k in range(1, 6):
            next(pf)
            assert pf.consumed_state() == want_states[k]
    assert pf.consumed_state() == want_states[5]  # after close too


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_transform_and_the_data_next_fault_point(depth):
    def numbered():
        for i in range(6):
            yield {"inputs": np.full((1, 2), i, np.int32)}

    def double(raw):
        return {k: v * 2 for k, v in raw.items()}

    with faults.harness(seed=0) as h:
        h.arm("data.next", faults.FailN(1, match={"n": 3}))
        pf = Prefetcher(numbered(), depth=depth, device="cpu",
                        transform=double)
        try:
            got = [int(next(pf)["inputs"][0, 0]) for _ in range(3)]
            with pytest.raises(faults.FaultError):
                next(pf)
        finally:
            pf.close()
    assert got == [0, 2, 4]
    assert h.counts["data.next"]["injected"] == 1
    assert pf.consumed_state() is None  # a plain generator
