"""The CUDA sources of the port, read as text: what nvcc and chip_smoke.py
would find wrong on the card, caught where neither can run.

Every quoted `#include` under `kubeflow_tpu_torch/ops/csrc/` must name a
file there, every kernel whose ptxas report chip_smoke.py checks for
spills (`NO_SPILL_KERNELS`) must be a `__global__` function of some `.cu`
file there, and every `extern "C"` entry point must take as many arguments
as `_build.SIGNATURES` declares for it (ctypes would pass a short list
without complaint). chip_smoke.py is parsed, not imported.
"""

import ast
import re
from pathlib import Path

import pytest

from kubeflow_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "kubeflow_tpu_torch" / "ops" / "csrc"
SOURCES = sorted(p.name for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
# __launch_bounds__'s arguments may hold one level of parentheses.
GLOBAL = re.compile(r"__global__\s+void\s+"
                    r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                    r"(\w+)\s*\(")


def _no_spill_kernels() -> tuple:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None)
                == "NO_SPILL_KERNELS"):
            return tuple(ast.literal_eval(node.value))
    raise AssertionError("chip_smoke.py assigns no NO_SPILL_KERNELS")


def _global_functions() -> set:
    return {name for p in CSRC.glob("*.cu")
            for name in GLOBAL.findall(p.read_text())}


def test_the_sources_are_there():
    """The parametrised checks below are not run over an empty list."""
    assert {"attn_fwd_sm90.cuh", "attn_bwd_sm90.cuh", "gemm_sm90.cuh",
            "flash_fwd.cu", "flash_bwd.cu", "rdma_ring.cu",
            "w8a16.cu"} <= set(SOURCES)


@pytest.mark.parametrize("source", SOURCES)
def test_every_quoted_include_names_a_file_beside_it(source):
    for name in INCLUDE.findall((CSRC / source).read_text()):
        assert (CSRC / name).is_file(), f"{source} includes missing {name}"


@pytest.mark.parametrize("kernel", _no_spill_kernels())
def test_every_no_spill_kernel_is_a_global_function(kernel):
    assert kernel in _global_functions(), (
        f"chip_smoke.NO_SPILL_KERNELS names {kernel}, which no .cu file "
        f"under {CSRC.relative_to(ROOT)} defines as __global__")


def test_the_include_pattern_sees_a_missing_header():
    """The check above is not vacuous: a dangling include is found."""
    text = '#include "attn_bwd_sm90.cuh"\n#include "gone.cuh"\n'
    missing = [n for n in INCLUDE.findall(text) if not (CSRC / n).is_file()]
    assert missing == ["gone.cuh"]


def test_the_global_pattern_reads_the_kernel_declarations():
    text = ("template <int D>\n__global__ void __launch_bounds__(fwd90::"
            "kThreads, 1)\nrdma_bwd_dq_kernel(const __grid_constant__ "
            "DqParams p) {\n}\n__global__ void plain_kernel(int x) {}\n"
            "__global__ void __launch_bounds__(kBwdThreads, (Tile<T, R>::"
            "kMinBlocks))\nflash_simt_dq_kernel(const Params p) {}\n")
    assert GLOBAL.findall(text) == ["rdma_bwd_dq_kernel", "plain_kernel",
                                    "flash_simt_dq_kernel"]


def _entry_points(source: str) -> dict:
    """{symbol: argument count} of the extern "C" functions of a source."""
    text = (CSRC / source).read_text()
    return {name: len([a for a in args.split(",") if a.strip()])
            for name, args in EXTERN_C.findall(text)}


def test_the_new_matmul_kernel_is_checked_for_spills():
    """The wgmma int8 matmul is in NO_SPILL_KERNELS, and it is a
    __global__ function of qmm.cu."""
    assert "qmm_wgmma_kernel" in _no_spill_kernels()
    assert "qmm_wgmma_kernel" in GLOBAL.findall((CSRC / "qmm.cu").read_text())


def test_the_w8a16_tile_kernel_is_checked_for_spills():
    """The wgmma W8A16 kernel is in NO_SPILL_KERNELS and a __global__
    function of w8a16.cu, and the mma.sync tile kernel it replaced is gone
    from every source."""
    assert "w8a16_wgmma_kernel" in _no_spill_kernels()
    assert "w8a16_wgmma_kernel" in GLOBAL.findall(
        (CSRC / "w8a16.cu").read_text())
    assert "w8a16_mma_kernel" not in _global_functions()


def test_the_cuda_core_backward_kernels_are_checked_for_spills():
    """The register-tiled dq and dk/dv kernels are in NO_SPILL_KERNELS and
    __global__ functions of flash_simt.cu."""
    text = (CSRC / "flash_simt.cu").read_text()
    for kernel in ("flash_simt_dq_kernel", "flash_simt_dkv_kernel"):
        assert kernel in _no_spill_kernels()
        assert kernel in GLOBAL.findall(text)


def test_both_forward_kernels_of_flash_simt_are_checked_for_spills():
    """The tensor-core forward (bf16/fp16) and the register-tiled fp32
    forward are in NO_SPILL_KERNELS and __global__ functions of
    flash_simt.cu, and the simple design they replaced (its load_rows and
    scalar dot()) is gone."""
    text = (CSRC / "flash_simt.cu").read_text()
    for kernel in ("flash_simt_fwd_kernel", "flash_simt_fwd_mma_kernel"):
        assert kernel in _no_spill_kernels()
        assert kernel in GLOBAL.findall(text)
    assert "load_rows" not in text
    assert not re.search(r"\bfloat dot\(", text)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in text


def test_the_forward_entry_point_takes_its_kernel_and_rows():
    """tpk_flash_simt_fwd takes the plan's kernel and rows before the
    stream: 20 arguments (18 without them), as _build.SIGNATURES says."""
    counts = _entry_points("flash_simt.cu")
    sigs = _build.SIGNATURES["flash_simt.cu"]
    assert counts["tpk_flash_simt_fwd"] == len(
        sigs["tpk_flash_simt_fwd"]) == 20


def test_the_cuda_core_backward_entry_points_take_their_grid():
    """dq takes its rows, dk/dv its rows, splits, workspace and tickets:
    the extern "C" argument counts are _build.SIGNATURES' (without the
    grid they were 20 and 21)."""
    counts = _entry_points("flash_simt.cu")
    sigs = _build.SIGNATURES["flash_simt.cu"]
    assert counts["tpk_flash_simt_bwd_dq"] == len(
        sigs["tpk_flash_simt_bwd_dq"]) == 21
    assert counts["tpk_flash_simt_bwd_dkv"] == len(
        sigs["tpk_flash_simt_bwd_dkv"]) == 25


@pytest.mark.parametrize("source,symbol", [
    (src, sym) for src, syms in _build.SIGNATURES.items() for sym in syms])
def test_every_entry_point_takes_the_declared_argument_count(source, symbol):
    assert _entry_points(source).get(symbol) == len(
        _build.SIGNATURES[source][symbol]), (
        f"{source}: extern \"C\" {symbol} and _build.SIGNATURES differ")


def test_the_entry_point_pattern_counts_arguments():
    text = ('extern "C" int tpk_x(const void* a, void* b,\n'
            '                     int M, void* stream) {\n}\n')
    assert EXTERN_C.findall(text)[0][0] == "tpk_x"
    assert len(EXTERN_C.findall(text)[0][1].split(",")) == 4
