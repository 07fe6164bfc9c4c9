"""The solve device: the one place every solver entry point takes its
`torch.device` from.

The default is the first card, `cuda:0`. A caller that wants the CPU (the
tests, a box with no card) asks for it with `use_device("cpu")`; a process
started by another (an agent, the node simulator) is asked through the
environment: `NOMAD_SOLVER_DEVICE=cpu` (or `cuda:N`), read once at import.
With no card present and no such request, the first solve raises: the
solver never carries on on the CPU by itself.

`devices()` is the device set the solver's mesh may span (sharding.py):
every visible card, or the one CPU device when the CPU was asked for.
`use_devices(list)` installs an explicit shard list instead, in which a
torch device may repeat — virtual shards, `["cpu"] * 8` in the tests,
`["cuda:0"] * 4` in chip_smoke.py — so a mesh of S shards runs on a box
with fewer cards. Entry i is shard i (the `d<i>` of the
`device.lost.d<i>` fault sites and of the quarantine). The server never
calls it; it is the counterpart of the reference's forced host-device
count, set by a call instead of an environment variable.
"""
from __future__ import annotations

import os

import torch

ENV = "NOMAD_SOLVER_DEVICE"


def _requested(value: str) -> torch.device:
    """The device `NOMAD_SOLVER_DEVICE` asks for (`cuda:0` when unset);
    raises ValueError, naming the variable, on anything but `cpu`,
    `cuda` or `cuda:N`."""
    if not value:
        return torch.device("cuda:0")
    try:
        dev = torch.device(value)
    except RuntimeError as e:
        raise ValueError(f"{ENV}={value!r} is not a device: {e}") from None
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{ENV}={value!r}: the solver runs on 'cpu' or "
                         "'cuda[:N]'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda:0")
    return dev


_device = _requested(os.environ.get(ENV, ""))


def use_device(dev) -> torch.device:
    """Set the solve device (`"cpu"`, `"cuda:0"`, a `torch.device`);
    returns the previous one so a caller can restore it."""
    global _device
    prev = _device
    _device = torch.device(dev)
    return prev


_devices: "list[torch.device] | None" = None


def use_devices(devs) -> "list[torch.device] | None":
    """Install an explicit shard list (torch devices or their names; an
    entry may repeat), or None to go back to the visible devices.
    Returns the previous list. Tests and chip_smoke.py only."""
    global _devices
    prev = _devices
    _devices = None if devs is None else [torch.device(d) for d in devs]
    return prev


def devices() -> list:
    """The device set the mesh may span, one entry a shard: the list
    `use_devices` installed, else every visible card (`cuda:0` ..
    `cuda:N-1`) when the solve device is a card, else the solve device
    alone. Nothing here checks that a card is present: solve_device
    does."""
    if _devices is not None:
        return list(_devices)
    dev = _device
    if dev.type == "cuda" and torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def device_program(fn):
    """Names `fn` a device program: it queues its work on the solve
    device's stream and returns results still there, with no host sync;
    its caller brings them back at one copy (cuda_kernels.fused_to_host,
    convex.to_host). A no-op when the program runs; the analyzer's JIT001
    holds the body to it (nomad_tpu_torch/analysis/rules_jit.py)."""
    return fn


def solve_device() -> torch.device:
    """The device solves run on. Raises when it is a card and none is
    present."""
    dev = _device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"solve device is {dev} but no CUDA device is present; "
            "call nomad_tpu_torch.solver.device.use_device('cpu') (or "
            f"start the process with {ENV}=cpu) to solve on the CPU")
    return dev
