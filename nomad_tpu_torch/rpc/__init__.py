"""RPC pieces the FSM and the plan applier need: the wire codec's error
types and the replicated dedup table. The socket client and server are
not ported yet."""
from . import codec, dedup  # noqa: F401

__all__ = ["codec", "dedup"]
