"""The port's safetensors codec (models/hf_import.py) against the
`safetensors` package: files the package writes read back equal, files the
port writes are read by the package, across every dtype the reader takes
(0-d and empty tensors included), single, sharded and any-named layouts;
and every malformed file is refused by name."""

import json
import os
import struct

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu_torch.models import hf_import as th

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool, torch.float8_e4m3fn, torch.float8_e5m2]
SHAPES = [(3, 5), (), (0,), (2, 0, 3), (7,)]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape,
                         generator=g, dtype=torch.int64).to(dtype)


def _same(a, b):
    """Bit equality (float8 compared through its bytes)."""
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    if a.element_size() == 1 and a.dtype.is_floating_point:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    assert torch.equal(a, b)


def _all_dtypes():
    return {f"{str(dt)[6:]}_{i}": _tensor(dt, shp, 10 * j + i)
            for j, dt in enumerate(DTYPES) for i, shp in enumerate(SHAPES)}


def test_reads_what_safetensors_writes(tmp_path):
    ts = _all_dtypes()
    path = str(tmp_path / "a.safetensors")
    st_save(ts, path, metadata={"format": "pt", "note": "x"})
    got, meta = th.load_safetensors(path, with_metadata=True)
    assert meta == {"format": "pt", "note": "x"}
    assert sorted(got) == sorted(ts)
    for name, t in ts.items():
        _same(got[name], t)


def test_safetensors_reads_what_the_port_writes(tmp_path):
    ts = _all_dtypes()
    path = str(tmp_path / "b.safetensors")
    n = th.save_safetensors(ts, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    back = st_load(path)
    assert sorted(back) == sorted(ts)
    for name, t in ts.items():
        _same(back[name], t)
    for name, t in th.load_safetensors(path).items():
        _same(t, ts[name])
    with open(path, "rb") as f:
        hlen = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(hlen))
    assert hlen % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    for name, info in header.items():
        if name != "__metadata__":  # every offset aligned to its dtype
            assert info["data_offsets"][0] % ts[name].element_size() == 0


def test_numpy_written_files_match_the_jax_reader(tmp_path):
    """safetensors.numpy writes (the JAX package's writer); the port's
    directory reader gives the JAX reader's arrays."""
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "h": rng.standard_normal((3,)).astype(np.float16),
            "i": rng.integers(-9, 9, (2, 2)).astype(np.int64),
            "s": np.array(2.5), "e": np.zeros((0, 4), np.int32),
            "b": np.array([True, False])}
    np_save(arrs, str(tmp_path / "model.safetensors"))
    ref = jh.load_safetensors_dir(str(tmp_path))
    got = th.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(ref)
    for k, arr in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), arr)
        assert got[k].numpy().dtype == arr.dtype


@pytest.mark.parametrize("layout", ["single", "sharded", "any_named"])
def test_directory_layouts_match_the_jax_reader(tmp_path, layout):
    rng = np.random.default_rng(1)
    arrs = {f"t{i}": rng.standard_normal((i + 1, 3)).astype(np.float32)
            for i in range(6)}
    if layout == "single":
        np_save(arrs, str(tmp_path / "model.safetensors"))
    elif layout == "sharded":
        names = sorted(arrs)
        shards = {"model-00001-of-00002.safetensors": names[:4],
                  "model-00002-of-00002.safetensors": names[4:]}
        for shard, keys in shards.items():
            np_save({k: arrs[k] for k in keys}, str(tmp_path / shard))
        with open(tmp_path / th.INDEX_FILE, "w") as f:
            json.dump({"metadata": {}, "weight_map": {
                k: s for s, keys in shards.items() for k in keys}}, f)
    else:
        np_save({k: arrs[k] for k in ("t0", "t1")},
                str(tmp_path / "part-b.safetensors"))
        np_save({k: arrs[k] for k in ("t2", "t3", "t4", "t5")},
                str(tmp_path / "part-a.safetensors"))
    ref = jh.load_safetensors_dir(str(tmp_path))
    got = th.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(ref) == sorted(arrs)
    for k in arrs:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_index_naming_a_missing_tensor_is_refused(tmp_path):
    np_save({"a": np.zeros(2, np.float32)},
            str(tmp_path / "s1.safetensors"))
    with open(tmp_path / th.INDEX_FILE, "w") as f:
        json.dump({"weight_map": {"a": "s1.safetensors",
                                  "b": "s1.safetensors"}}, f)
    with pytest.raises(KeyError, match="'b'"):
        th.load_safetensors_dir(str(tmp_path))
    os.remove(tmp_path / th.INDEX_FILE)
    os.remove(tmp_path / "s1.safetensors")
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        th.load_safetensors_dir(str(tmp_path))


def _raw_file(path, header, data: bytes, hlen=None):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw) if hlen is None else hlen))
        f.write(raw)
        f.write(data)
    return str(path)


def test_unaligned_offsets_read_correctly(tmp_path):
    """Nothing in the format aligns a tensor to its element size: a U8
    first puts the F32 and BF16 after it at odd offsets."""
    f32 = torch.tensor([1.5, -2.25, 3.0])
    bf = torch.tensor([0.5, 7.0]).bfloat16()
    data = (bytes([9]) + f32.numpy().tobytes()
            + bf.view(torch.uint8).numpy().tobytes())
    path = _raw_file(tmp_path / "u.safetensors", {
        "u": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
        "f": {"dtype": "F32", "shape": [3], "data_offsets": [1, 13]},
        "g": {"dtype": "BF16", "shape": [2], "data_offsets": [13, 17]}},
        data)
    got = th.load_safetensors(path)
    assert got["u"].tolist() == [9]
    _same(got["f"], f32)
    _same(got["g"], bf)
    assert st_load(path)["f"].tolist() == got["f"].tolist()


def test_tensors_are_private_to_the_reader(tmp_path):
    """The mapping is copy-on-write: writing a returned tensor leaves the
    file as it was."""
    path = str(tmp_path / "m.safetensors")
    st_save({"w": torch.arange(6, dtype=torch.float32)}, path)
    before = open(path, "rb").read()
    t = th.load_safetensors(path)["w"]
    t.fill_(-1.0)
    assert open(path, "rb").read() == before
    assert th.load_safetensors(path)["w"].tolist() == list(range(6))


GOOD = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
        "b": {"dtype": "I8", "shape": [4], "data_offsets": [8, 12]}}


@pytest.mark.parametrize("case,header,data,hlen,match", [
    ("truncated_data", GOOD, bytes(10), None, "out of range"),
    ("truncated_header", GOOD, b"", 10_000, "does not fit"),
    ("short_file", None, None, None, "8-byte header length"),
    ("bad_json", "{not json", bytes(12), None, "unreadable header"),
    ("not_an_object", [1, 2], bytes(12), None, "not a JSON object"),
    ("overlap", {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                 "b": {"dtype": "I8", "shape": [4],
                       "data_offsets": [6, 10]}},
     bytes(12), None, "overlap"),
    ("out_of_range", {"a": {"dtype": "F32", "shape": [2],
                            "data_offsets": [8, 16]}},
     bytes(12), None, "out of range"),
    ("negative", {"a": {"dtype": "F32", "shape": [2],
                        "data_offsets": [-4, 4]}},
     bytes(12), None, "out of range"),
    ("unknown_dtype", {"a": {"dtype": "C64", "shape": [1],
                             "data_offsets": [0, 8]}},
     bytes(8), None, "unknown dtype 'C64'"),
    ("size_mismatch", {"a": {"dtype": "F32", "shape": [3],
                             "data_offsets": [0, 8]}},
     bytes(8), None, "needs 12"),
    ("bad_shape", {"a": {"dtype": "F32", "shape": [-2],
                         "data_offsets": [0, 8]}},
     bytes(8), None, "bad shape"),
    ("bad_metadata", {"__metadata__": {"k": 1}}, b"", None, "__metadata__"),
])
def test_malformed_files_are_refused(tmp_path, case, header, data, hlen,
                                     match):
    path = tmp_path / f"{case}.safetensors"
    if header is None:
        path.write_bytes(b"\x01\x02")
    elif isinstance(header, str):
        raw = header.encode()
        path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    else:
        _raw_file(path, header, data, hlen)
    with pytest.raises(th.SafetensorsError, match=match):
        th.load_safetensors(str(path))


def test_writer_refuses_a_dtype_without_a_name(tmp_path):
    with pytest.raises(th.SafetensorsError, match="complex64"):
        th.save_safetensors({"c": torch.zeros(2, dtype=torch.complex64)},
                            str(tmp_path / "c.safetensors"))
