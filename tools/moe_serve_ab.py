"""Time the routed-expert block's serving call and phase 4l of two trees on
one card, in turns.

    python3 tools/moe_serve_ab.py --parent build/parent [--rounds N] \
        [--out FILE]
    python3 tools/moe_serve_ab.py --parent build/parent --block-only \
        --device cpu --model moe_tiny

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> | tar -x -C build/parent`). Each turn is a
process of its own over one tree, in the order parent, this, this, parent
(`--rounds` times), and each turn measures, with that tree's package and
its `chip_smoke.py`:

- one `MoEBlock` forward at decode shape (x [4, 1, H] in the compute dtype,
  no grad, `--model`'s widths at one layer, weights drawn from a seed): the
  ATen ops it dispatches (by name), the CUDA kernels it launches
  (torch.profiler; CUDA only) and the median host microseconds to enqueue
  one call (`BLOCK_CALLS` calls, the device drained before each);
- unless `--block-only` (CUDA only), chip_smoke.py's phase 4l (i)
  (`_mixtral_bf16`: Mixtral-8x7B's widths at 4 layers in bf16) and (ii)
  (`_mixtral_int8`: mixtral_8x7b whole in int8 over HTTP): each one's
  4-row decode step, wall and device ms, and whether its gates passed.

The kernels are built once into this tree's `build/torch_kernels/` and the
libraries copied into the parent's (a library is named by a hash of its
source, headers and flags, so an unchanged source keeps its name). Every
turn's numbers go to `--out` (default `chiprun_out/moe_serve_ab.json`) and
one summary line per turn to standard output. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK_SHAPE = (4, 1)  # phase 4l's four decoding rows, one token each
BLOCK_CALLS = 200
SEED = 0


def block_cost(moe_mod, registry, model: str, device: str) -> dict:
    """Ops, kernels and host us of one no-grad MoEBlock forward."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = registry.model_config(model, num_layers=1)
    blk = moe_mod.MoEBlock(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        blk.draw_weights(gen)
    x = torch.randn(*BLOCK_SHAPE, cfg.hidden_size, generator=gen,
                    device=device).to(cfg.dtype)
    ops: Counter = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func.overloadpacket.__name__)] += 1
            return func(*args, **(kwargs or {}))

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    with torch.no_grad():
        for _ in range(10):
            blk(x)
        with Count():
            blk(x)
        host = []
        for _ in range(BLOCK_CALLS):
            sync()
            t0 = time.perf_counter()
            blk(x)
            host.append((time.perf_counter() - t0) * 1e6)
        sync()
        kernels = None
        if device != "cpu":
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                blk(x)
                sync()
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            kernels = {"launches": sum(e.count for e in kern),
                       "device_us": sum(e.self_device_time_total
                                        for e in kern)}
    return {"model": model, "x": [*BLOCK_SHAPE, cfg.hidden_size],
            "ops": sum(ops.values()), "ops_by_name": dict(sorted(ops.items())),
            "host_us_median": statistics.median(host), "kernels": kernels}


def child(tree: Path, args) -> dict:
    """One turn over one tree (run with that tree first on sys.path)."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    from kubeflow_tpu_torch.models import moe as moe_mod
    from kubeflow_tpu_torch.utils import registry

    res = {"tree": str(tree),
           "block": block_cost(moe_mod, registry, args.model, args.device)}
    if args.block_only:
        return res
    import chip_smoke as cs

    cs._build.build_all()
    gates: dict = {}
    bf16 = cs._mixtral_bf16(gates)
    cs._free()
    work = tempfile.mkdtemp(prefix="moe_serve_ab_", dir=tree / "build")
    try:
        int8 = cs._mixtral_int8(work, cs._gpu_tests(), gates)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["4l_i_step"] = bf16["step"]
    res["4l_ii_step"] = int8["step"]
    res["gates_ok"] = all(gates.values())
    res["card"] = cs.smi()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "moe_serve_ab.json")
    ap.add_argument("--model", default="mixtral_8x7b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block-only", action="store_true")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the turns parent, this, this, parent")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print("AB " + json.dumps(child(args.child.resolve(), args)))
        return 0
    parent = args.parent.resolve()
    if args.device != "cpu":
        sys.path.insert(0, str(ROOT))
        from kubeflow_tpu_torch.ops import _build

        _build.build_all()
        dst = parent / "build" / "torch_kernels"
        dst.mkdir(parents=True, exist_ok=True)
        for lib in _build.BUILD_DIR.iterdir():
            if lib.suffix in (".so", ".log"):
                shutil.copy2(lib, dst / lib.name)
    turns = []
    for name, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)) * args.rounds:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--parent",
               str(parent), "--child", str(tree), "--model", args.model,
               "--device", args.device]
        if args.block_only:
            cmd.append("--block-only")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode or not lines:
            sys.stdout.write(proc.stdout[-4000:])
            sys.stderr.write(proc.stderr[-4000:])
            print(f"turn {len(turns)} ({name}) failed: exit {proc.returncode}")
            return 1
        turn = {"name": name, **json.loads(lines[-1][3:])}
        turns.append(turn)
        b = turn["block"]
        line = (f"{name}: block ops {b['ops']}, host {b['host_us_median']:.1f}"
                f" us")
        if b["kernels"]:
            line += (f", kernels {b['kernels']['launches']}, device "
                     f"{b['kernels']['device_us']:.1f} us")
        for key in ("4l_i_step", "4l_ii_step"):
            if key in turn:
                s = turn[key]
                dev = s.get("device_ms")
                line += (f"; {key} wall {s['ms']:.2f} ms"
                         + (f" device {dev:.2f} ms" if dev is not None
                            else ""))
        if "gates_ok" in turn:
            line += f"; gates {'OK' if turn['gates_ok'] else 'FAIL'}"
        print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(turns, indent=1))
    return 0 if all(t.get("gates_ok", True) for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
