"""nomad_tpu_torch — the PyTorch/CUDA port of nomad_tpu.

The same orchestrator, layer for layer, with the placement solver's
device work in PyTorch and its hand kernels in CUDA C++ for Hopper
(sm_90a). The package keeps nomad_tpu's layout so each module has a
counterpart there:

  structs/    shared data model + fit/scoring math (copies)
  state/      in-memory MVCC state store (copies)
  scheduler/  schedulers, reconciler, stacks (copies)
  solver/     batched placement solver on the card (the port proper)
  server/     FSM and the serial plan applier (copies)
  carry.py    loads a cluster exported as API JSON into a port store

Solves run on `cuda:0` unless the caller asks for the CPU with
`nomad_tpu_torch.solver.device.use_device("cpu")`.
"""

__version__ = "0.1.0"
