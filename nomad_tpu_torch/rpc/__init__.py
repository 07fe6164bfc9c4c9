"""Network RPC layer (ref nomad/rpc.go: msgpack-RPC over TCP with yamux +
TLS, leader/region forwarding; ref client/rpc.go + client/servers/ for the
client-side server registry with failover).

TPU-native design note (SURVEY.md §2.7): control-plane RPC rides DCN between
hosts — it is deliberately independent of the JAX/ICI compute path. The
transport here is length-prefixed frames over TCP with HMAC-SHA256 message
authentication (the analog of the reference's TLS+gossip-key trust boundary)
and a restricted unpickler so only framework types cross the wire.
"""
from .codec import FrameError, RpcError, NotLeaderError, recv_msg, send_msg
from .client import RpcClient, ServerRpc
from .server import RpcServer

__all__ = [
    "FrameError", "RpcError", "NotLeaderError", "recv_msg", "send_msg",
    "RpcClient", "RpcServer", "ServerRpc",
]
