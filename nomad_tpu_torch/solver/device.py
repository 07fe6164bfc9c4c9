"""The solve device: the one place every solver entry point takes its
`torch.device` from.

The default is the first card, `cuda:0`. A caller that wants the CPU (the
tests, a box with no card) asks for it with `use_device("cpu")`. With no
card present and no such request, the first solve raises: the solver never
carries on on the CPU by itself.
"""
from __future__ import annotations

import torch

_device = torch.device("cuda:0")


def use_device(dev) -> torch.device:
    """Set the solve device (`"cpu"`, `"cuda:0"`, a `torch.device`);
    returns the previous one so a caller can restore it."""
    global _device
    prev = _device
    _device = torch.device(dev)
    return prev


def solve_device() -> torch.device:
    """The device solves run on. Raises when it is a card and none is
    present."""
    dev = _device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"solve device is {dev} but no CUDA device is present; "
            "call nomad_tpu_torch.solver.device.use_device('cpu') to "
            "solve on the CPU")
    return dev
