"""Process bootstrap: the env contract a JAXJob worker is launched with.

The port's copy of `kubeflow_tpu/comms/bootstrap.py`'s `ProcessEnv` and
`read_env`. The C++ controller (`cpp/jaxjob.cc`) injects, per worker:

    TPK_COORDINATOR   host:port of process 0 (only when there are several)
    TPK_NUM_PROCS     total process count
    TPK_PROC_ID       this process's index
    TPK_NUM_SLICES    number of slices (default 1)
    TPK_SLICE_ID      this process's slice index

The port trains in one process: `initialize` accepts exactly that and
refuses more by name (multi-process training waits for the port of
`parallel/`).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    coordinator: str | None
    num_processes: int
    process_id: int
    num_slices: int = 1
    slice_id: int = 0

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1


def read_env(environ=None) -> ProcessEnv:
    env = environ if environ is not None else os.environ
    coord = env.get("TPK_COORDINATOR")
    num = int(env.get("TPK_NUM_PROCS", "1"))
    pid = int(env.get("TPK_PROC_ID", "0"))
    if num > 1 and not coord:
        raise ValueError("TPK_NUM_PROCS > 1 requires TPK_COORDINATOR")
    if not 0 <= pid < num:
        raise ValueError(f"TPK_PROC_ID {pid} out of range [0, {num})")
    num_slices = int(env.get("TPK_NUM_SLICES", "1"))
    slice_id = int(env.get("TPK_SLICE_ID", "0"))
    if not 0 <= slice_id < num_slices:
        raise ValueError(
            f"TPK_SLICE_ID {slice_id} out of range [0, {num_slices})")
    return ProcessEnv(
        coordinator=coord, num_processes=num, process_id=pid,
        num_slices=num_slices, slice_id=slice_id)


def initialize(penv: ProcessEnv) -> ProcessEnv:
    """The process env, checked: one process needs no initialization;
    several raise NotImplementedError."""
    if penv.distributed:
        raise NotImplementedError(
            f"TPK_NUM_PROCS={penv.num_processes}: multi-process training "
            "is not supported by this package yet")
    return penv
