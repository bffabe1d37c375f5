"""A device mesh for the port: the counterpart of `jax.sharding.Mesh` as
the JAX package uses it (`webaudio_tpu/parallel/batch.py`,
`webaudio_tpu/parallel/segments.py`).

JAX drives every device of a mesh from one controller, and the batch and
time shards need no collectives.  The same holds here: a mesh is a list of
torch devices with one axis name, walked from one host thread.  It is not
`torch.distributed`'s `DeviceMesh`, which needs a process group and one
process a device.  Entries may repeat: `["cpu"] * 8` gives eight shards on
the CPU and `["cuda:0"] * 4` four shards on one card, each rendered in
turn.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def indexed(device) -> torch.device:
    """`device` as a torch.device with its index where it is CUDA: a bare
    "cuda" names the current card, and `torch.cuda.device` (which the
    shards' walks run under) refuses a device without an index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device):
    """Make `device` current while a shard or segment walks or bounces on
    it: the kernel wrappers refuse a tensor that is not on the current
    card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(indexed(device))
    return contextlib.nullcontext()


class Mesh:
    """A one-axis mesh of torch devices.

    devices: a sequence of devices (torch.device or strings), repeats
    allowed; `.devices` is a 1-d numpy object array of torch.device, so
    `mesh.devices.size` reads as in JAX.  axis_names: a one-element tuple,
    "graphs" for a batch, "time" for time segments."""

    def __init__(self, devices, axis_names):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"the port's mesh has one axis, got {axis_names}")
        devs = [indexed(d) for d in np.asarray(devices, dtype=object).ravel()]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = axis_names

    def require(self, axis: str) -> None:
        """Raise ValueError unless this mesh's axis is `axis`."""
        if self.axis_names != (axis,):
            raise ValueError(f"expected a mesh over the {axis!r} axis, got "
                             f"{self.axis_names}")

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def default_mesh(axis: str = "graphs") -> Mesh:
    """A mesh over every visible CUDA device, one entry each.  Raises
    RuntimeError where none is visible (it does not fall back to the CPU)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("default_mesh: no CUDA device is visible; build "
                           "a Mesh of the devices to use")
    return Mesh([f"cuda:{i}" for i in range(n)], (axis,))
