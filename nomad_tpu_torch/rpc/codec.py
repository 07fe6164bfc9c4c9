"""Wire codec: length-prefixed, HMAC-authenticated frames carrying
restricted-pickle payloads (ref nomad/rpc.go msgpack codec; the reference
trusts its wire via TLS + serf encrypt keys — here the shared cluster key
authenticates every frame, and deserialization is allow-listed to framework
modules so a hostile peer cannot instantiate arbitrary classes).

Frame layout:  4-byte big-endian length | 32-byte HMAC-SHA256 | payload
"""
from __future__ import annotations

import hashlib
import hmac
import io
import pickle
import pickletools  # noqa: F401  (kept importable for debugging frames)
import socket
import struct

MAX_FRAME = 64 * 1024 * 1024      # 64 MiB: snapshots cross this transport
_HDR = struct.Struct(">I")

# modules whose classes may be reconstructed from the wire
_ALLOWED_PREFIXES = ("nomad_tpu_torch.",)
_ALLOWED_EXACT = {
    ("builtins", "set"), ("builtins", "frozenset"), ("builtins", "bytearray"),
    ("builtins", "complex"), ("builtins", "bytes"),
    ("collections", "OrderedDict"), ("collections", "defaultdict"),
    ("collections", "deque"), ("datetime", "datetime"),
    ("datetime", "timedelta"),
}


class FrameError(Exception):
    """Malformed, oversized, or unauthenticated frame."""


class RpcError(Exception):
    """Remote handler raised; .kind carries the remote exception class name."""

    def __init__(self, message: str, kind: str = "RpcError"):
        super().__init__(message)
        self.kind = kind


class RateLimitError(RpcError):
    """The server's ingress admission bucket rejected the call (ISSUE 8
    overload protection). `retry_after_s` is the server's earliest-retry
    hint; callers back off (with jitter) instead of hammering — the RPC
    twin of HTTP 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message, kind="RateLimitError")
        self.retry_after_s = max(0.0, float(retry_after_s))


class DeadlineExceededError(RpcError):
    """The request's propagated deadline expired (ISSUE 18). Raised
    client-side when the retry budget runs dry, and returned server-side
    when a request arrives (or surfaces from a queue) after its envelope
    `deadline` — the server SHEDS such work instead of spending raft
    throughput on a result nobody is waiting for. Never retried: by
    definition there is no budget left."""

    def __init__(self, message: str = "rpc deadline exceeded"):
        super().__init__(message, kind="DeadlineExceededError")


class NotLeaderError(Exception):
    """Write hit a follower (ref nomad/rpc.go forward). .leader_addr may
    name the current leader's rpc address ("host:port") or be empty."""

    def __init__(self, leader_addr: str = ""):
        super().__init__(f"node is not the leader (leader={leader_addr or '?'})")
        self.leader_addr = leader_addr


class LeadershipLostError(NotLeaderError):
    """Leadership was lost AFTER the entry was appended (ref
    hashicorp/raft ErrLeadershipLost vs ErrNotLeader): the write may
    still commit under the new leader, so it must NOT be transparently
    retried or forwarded — the outcome is unknown and a resubmit can
    double-apply a non-idempotent write."""

    def __init__(self, leader_addr: str = ""):
        Exception.__init__(
            self, "leadership lost while committing; outcome unknown "
            f"(leader={leader_addr or '?'})")
        self.leader_addr = leader_addr


class FencedWriteError(NotLeaderError):
    """A fenced write (apply(fence=token)) was rejected because the term
    moved since the token was captured (ISSUE 6). Unlike
    LeadershipLostError the entry was NEVER appended — commit is provably
    impossible, so the caller may safely treat the write as not-happened
    (the plan applier reports the whole batch as leadership-lost and the
    new leader's broker restore re-drives the work)."""

    def __init__(self, current_term: int = -1, fence: int = -1,
                 leader_addr: str = ""):
        Exception.__init__(
            self, f"fenced write rejected: term moved {fence} -> "
            f"{current_term} since the fence token was captured "
            f"(leader={leader_addr or '?'})")
        self.leader_addr = leader_addr
        self.current_term = current_term
        self.fence = fence


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _ALLOWED_EXACT or \
                any(module.startswith(p) for p in _ALLOWED_PREFIXES):
            return super().find_class(module, name)
        raise FrameError(f"disallowed wire type {module}.{name}")


def encode(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode(data: bytes):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _mac(key: bytes, payload: bytes) -> bytes:
    return hmac.new(key, payload, hashlib.sha256).digest()


def send_msg(sock: socket.socket, obj, key: bytes) -> None:
    payload = encode(obj)
    if len(payload) > MAX_FRAME:
        raise FrameError(f"frame too large ({len(payload)} bytes)")
    sock.sendall(_HDR.pack(len(payload)) + _mac(key, payload) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket, key: bytes):
    (length,) = _HDR.unpack(_recv_exact(sock, 4))
    if length > MAX_FRAME:
        raise FrameError(f"frame too large ({length} bytes)")
    mac = _recv_exact(sock, 32)
    payload = _recv_exact(sock, length)
    if not hmac.compare_digest(mac, _mac(key, payload)):
        raise FrameError("frame failed HMAC authentication")
    return decode(payload)
