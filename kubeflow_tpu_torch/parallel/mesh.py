"""A device mesh: named axes over torch devices, and the installed mesh.

The port's counterpart of the part of `jax.sharding.Mesh` and
`kubeflow_tpu/parallel/mesh.py::current_mesh` that the ring attention op
uses. A mesh names its axes and holds one device per position; a device may
repeat, so n ranks of a ring can share one card (or the CPU), as the JAX
package's tests place n ranks on virtual CPU devices. `with mesh:` installs
it for the current thread, and `current_mesh()` returns the innermost one.

Building meshes from a config, sharding rules and FSDP are not here yet
(ROADMAP A5).
"""

from __future__ import annotations

import threading

import torch

_local = threading.local()


def _shape_of(devices) -> tuple:
    """The nested list's shape; a leaf is anything that is not a list or
    tuple (a torch.device or a device string)."""
    if not isinstance(devices, (list, tuple)):
        return ()
    if not devices:
        raise ValueError("a mesh axis needs at least one device")
    inner = {_shape_of(d) for d in devices}
    if len(inner) != 1:
        raise ValueError("mesh devices must form a regular grid")
    return (len(devices), *inner.pop())


def _flatten(devices):
    if isinstance(devices, (list, tuple)):
        for d in devices:
            yield from _flatten(d)
    else:
        yield torch.device(devices)


class Mesh:
    """Named axes over a grid of devices.

    `devices` is a (nested) sequence of `torch.device`s or device strings
    whose nesting depth equals the number of `axis_names`; `.devices` is
    the flat tuple in row-major order, `.shape` maps each axis name to its
    size (as `jax.sharding.Mesh.shape` does)."""

    def __init__(self, devices, axis_names):
        axis_names = (axis_names,) if isinstance(axis_names, str) else tuple(
            axis_names)
        sizes = _shape_of(list(devices))
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a device grid "
                             f"of shape {sizes}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = tuple(_flatten(list(devices)))
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))

    def __enter__(self):
        _local.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        return False


def current_mesh() -> Mesh | None:
    """The mesh installed by `with mesh:` on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None
