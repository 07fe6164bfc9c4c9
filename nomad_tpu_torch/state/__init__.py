"""Replicated-state layer (ref nomad/state/): the in-memory MVCC store the
FSM applies to and schedulers snapshot from."""
from .store import StateStore, StateSnapshot  # noqa: F401
