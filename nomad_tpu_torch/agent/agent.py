"""Agent: embeds a Server and/or Client in one process (ref
command/agent/agent.go:115 NewAgent, -dev mode presets) and serves the
HTTP API."""
from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Optional

from ..client import Client
from ..server import Server
from .http import HTTPAPI, make_http_server


@dataclasses.dataclass
class AgentConfig:
    """ref command/agent/config.go (subset)"""
    data_dir: str = ""
    bind_addr: str = "127.0.0.1"
    advertise_addr: str = ""    # address peers use; required if bind is 0.0.0.0
    http_port: int = 4646
    rpc_port: int = -1          # -1 = no network RPC (-dev default); 0 = any
    servers: tuple = ()         # client-only mode: server "host:port" list
    encrypt_key: str = ""       # cluster RPC/gossip key (HMAC)
    server_enabled: bool = True
    client_enabled: bool = True
    num_workers: int = 2
    region: str = "global"
    authoritative_region: str = ""     # ACL replication source region
    datacenter: str = "dc1"
    node_class: str = ""
    node_name: str = ""
    dev_mode: bool = False
    acl_enabled: bool = False
    gossip_port: int = -1              # -1 = gossip off; 0 = any port
    join: tuple = ()                   # gossip seed "host:port" addrs
    # ref -bootstrap-expect: 1 = bootstrap immediately (single server or
    # first of a cluster); 0 = never bootstrap, wait for adoption; N>1 =
    # wait until gossip sees N same-region servers, then all bootstrap
    # with the same config (safe to pass the same N to every server)
    bootstrap_expect: int = 1
    replication_token: str = ""        # ACL replication auth (federation)
    plugin_dir: str = ""               # external driver plugin executables
    # tls { } stanza (ref structs/config/tls.go): mutual TLS over the
    # RPC transport when all three files are set
    tls_enabled: bool = False
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_verify_server_hostname: bool = False
    # telemetry { } stanza (ref command/agent/config.go:638 Telemetry)
    telemetry_prometheus: bool = True
    telemetry_collection_interval: float = 1.0
    # vault { } analog: path of the durable secrets/KV store (empty =
    # in-memory dev provider)
    secrets_file: str = ""

    def key_bytes(self) -> bytes:
        from ..rpc.server import DEFAULT_KEY
        return self.encrypt_key.encode() if self.encrypt_key else DEFAULT_KEY

    def tls_config(self):
        """TLSConfig for the RPC transport, or None when disabled."""
        if not self.tls_enabled:
            return None
        if not (self.tls_ca_file and self.tls_cert_file
                and self.tls_key_file):
            raise ValueError(
                "tls enabled requires ca_file, cert_file and key_file")
        from ..tlsutil import TLSConfig
        return TLSConfig(
            enable_rpc=True, ca_file=self.tls_ca_file,
            cert_file=self.tls_cert_file, key_file=self.tls_key_file,
            verify_server_hostname=self.tls_verify_server_hostname,
            region=self.region)


class Agent:
    def __init__(self, config: Optional[AgentConfig] = None, logger=None):
        self.config = config or AgentConfig(dev_mode=True)
        if not self.config.data_dir:
            self.config.data_dir = tempfile.mkdtemp(prefix="nomad_tpu_")
        from .monitor import LogMonitor
        self.monitor = LogMonitor()
        _user_logger = logger or (lambda msg: None)

        def _log(msg: str) -> None:
            _user_logger(msg)
            self.monitor.logger(msg)
        self.logger = _log
        self.server: Optional[Server] = None
        self.client: Optional[Client] = None
        self.http = None
        self._http_thread: Optional[threading.Thread] = None

        self._server_rpc = None
        if self.config.server_enabled:
            self.server = Server(
                num_workers=self.config.num_workers,
                logger=self.logger,
                acl_enabled=self.config.acl_enabled,
                region=self.config.region,
                authoritative_region=self.config.authoritative_region,
                name=self.config.node_name or self._stable_server_name(),
                secrets_file=self.config.secrets_file)
        if self.config.client_enabled:
            if self.server is not None:
                rpc = self.server       # in-process fast path (-dev)
            elif self.config.servers:
                from ..rpc import ServerRpc
                self._server_rpc = ServerRpc(list(self.config.servers),
                                             key=self.config.key_bytes(),
                                             tls=self.config.tls_config())
                rpc = self._server_rpc
            else:
                raise ValueError("client-only agents need config.servers")
            self.client = Client(
                rpc,
                data_dir=os.path.join(self.config.data_dir, "client"),
                datacenter=self.config.datacenter,
                node_class=self.config.node_class,
                name=self.config.node_name,
                logger=self.logger,
                plugin_dir=self.config.plugin_dir)
        self.api = HTTPAPI(self)

    def _stable_server_name(self) -> str:
        """A server's raft identity must survive restarts (ISSUE 13
        restart-from-disk): the on-disk raft configuration names THIS
        server as a voter, so a fresh random name on every boot would
        make the restarted process an unknown peer that can never
        self-elect from its own WAL — it would sit as a permanent
        follower of a one-member cluster whose sole voter no longer
        exists. Persist the generated name under data_dir on first
        boot and reuse it, the way the reference persists its node-id
        (-dev runs with an auto tempdir keep today's per-boot names)."""
        from ..structs import new_id
        path = os.path.join(self.config.data_dir, "server_name")
        try:
            with open(path, encoding="utf-8") as f:
                name = f.read().strip()
            if name:
                return name
        except OSError:
            pass
        name = f"server-{new_id()[:8]}"
        try:
            # first boot may precede every other data_dir consumer
            os.makedirs(self.config.data_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(name)
        except OSError as e:
            self.logger(f"agent: could not persist server name: {e}")
        return name

    def start(self) -> None:
        # compiled sidecars (executor, logmon, allocstamp) are built from
        # source at startup, not committed (ADVICE r4); quiet no-op when
        # current, pure-Python fallbacks when no toolchain — but say so,
        # because the fallbacks cost ~20x on the materialize hot path
        from ..runtime import ensure_native
        if not ensure_native():
            self.logger("agent: native sidecars unavailable (no toolchain?);"
                        " using pure-Python fallbacks")
        # bind HTTP FIRST (serving starts below): the bound port feeds
        # both the node's advertised http_addr and the server's gossip
        # http_addr tag, which follower->leader HTTP forwarding resolves
        self.http = make_http_server(self.api, self.config.bind_addr,
                                     self.config.http_port)
        # pick up the OS-assigned port when asked for :0
        self.config.http_port = self.http.server_address[1]
        adv = self.config.advertise_addr or self.config.bind_addr
        if adv in ("0.0.0.0", "::", ""):
            import socket as _socket
            try:
                adv = _socket.gethostbyname(_socket.gethostname())
            except OSError:
                adv = "127.0.0.1"
        http_advertise = f"{adv}:{self.config.http_port}"
        try:
            self._start_rest(http_advertise)
        except BaseException:
            # the HTTP socket bound above must not outlive a failed
            # start: a caller that fixes config and retries on the same
            # fixed port would hit EADDRINUSE until this object is GC'd
            self.http.server_close()
            raise

    def _start_rest(self, http_advertise: str) -> None:
        if self.server is not None:
            # persistent XLA compile cache: a restarted server replays
            # serialized solver executables instead of paying the ~14s
            # cold compile as placement blackout (VERDICT r4 #3)
            from ..runtime import enable_compile_cache
            enable_compile_cache(
                os.path.join(self.config.data_dir, "xla_cache")
                if self.config.data_dir else "")
            if self.config.rpc_port >= 0 and self.config.acl_enabled and \
                    not self.config.encrypt_key:
                # the RPC surface trusts the HMAC key as its auth boundary
                # (like the reference trusts TLS+gossip keys); a public
                # default key + ACLs would let anyone bypass every token
                # check by speaking RPC directly
                raise ValueError(
                    "acl_enabled with network RPC requires encrypt_key")
            if self.config.rpc_port >= 0:
                self.server.rpc_listen(self.config.bind_addr,
                                       self.config.rpc_port,
                                       key=self.config.key_bytes(),
                                       tls=self.config.tls_config())
            if self.config.gossip_port >= 0:
                # gossiping agents MUST run real consensus: without it
                # every server is its own immediate leader and two
                # same-region agents that discover each other split-brain
                if self.server.rpc_server is None:
                    raise ValueError("gossip requires rpc_port >= 0")
                self.server.bootstrap_expect = self.config.bootstrap_expect
                self.server.replication_token = \
                    self.config.replication_token
                self.server.enable_raft(
                    self.server.name,
                    {self.server.name: self.server.rpc_addr},
                    data_dir=os.path.join(self.config.data_dir, "raft"),
                    bootstrap=(self.config.bootstrap_expect == 1))
            self.server.http_advertise = http_advertise
            self.server.start()
            if self.config.gossip_port >= 0:
                self.server.gossip_listen(self.config.bind_addr,
                                          self.config.gossip_port,
                                          key=self.config.key_bytes())
                if self.config.join:
                    self.server.gossip_join(list(self.config.join))
        self._http_thread = threading.Thread(
            target=self.http.serve_forever, daemon=True, name="http")
        self._http_thread.start()
        if self.client is not None:
            # the node advertises its agent's HTTP address so peers can
            # migrate ephemeral disks from it (ref structs.Node.HTTPAddr;
            # bind vs advertise split as in command/agent/config.go)
            self.client.node.http_addr = http_advertise
            self.client.start()
        self._start_runtime_sampler()

    def _start_runtime_sampler(self) -> None:
        """Publish runtime gauges (RSS, thread count, GC counts) every
        telemetry.collection_interval (ref command/agent config.go:638
        Telemetry.CollectionInterval driving go-metrics runtime stats)."""
        from ..metrics import metrics
        interval = max(self.config.telemetry_collection_interval, 0.1)
        self._sampler_stop = threading.Event()

        def sample():
            import gc
            import resource
            while not self._sampler_stop.wait(interval):
                try:
                    ru = resource.getrusage(resource.RUSAGE_SELF)
                    metrics.set_gauge("nomad.runtime.rss_kb",
                                      float(ru.ru_maxrss))
                    metrics.set_gauge("nomad.runtime.threads",
                                      float(threading.active_count()))
                    counts = gc.get_count()
                    metrics.set_gauge("nomad.runtime.gc_gen0",
                                      float(counts[0]))
                except Exception:   # noqa: BLE001 — monitoring only
                    pass

        self._sampler_thread = threading.Thread(
            target=sample, daemon=True, name="telemetry-sampler")
        self._sampler_thread.start()

    def shutdown(self) -> None:
        if getattr(self, "_sampler_stop", None) is not None:
            self._sampler_stop.set()
        if self.http is not None:
            self.http.shutdown()
        if self.client is not None:
            self.client.shutdown()
        if self._server_rpc is not None:
            self._server_rpc.close()
        if self.server is not None:
            self.server.shutdown()

    @property
    def http_addr(self) -> str:
        return f"http://{self.config.bind_addr}:{self.config.http_port}"

    def stats(self) -> dict:
        from ..metrics import metrics
        from ..obs import devruntime
        # re-sample the device-runtime gauges per scrape (pull-driven —
        # memory watermarks/live buffers land in the snapshot below, the
        # device+mesh rows ride alongside for the UI Metrics page)
        device_runtime = devruntime.snapshot()
        out = {"telemetry": metrics.snapshot(),
               "device_runtime": device_runtime}
        if self.server is not None:
            out["broker"] = dict(self.server.eval_broker.stats)
            out["blocked_evals"] = dict(self.server.blocked_evals.stats)
            out["state_index"] = self.server.state.latest_index()
            out["nodes"] = len(self.server.state.nodes)
            out["jobs"] = len(self.server.state.jobs)
            out["allocs"] = len(self.server.state.allocs)
        if self.client is not None:
            out["client_allocs"] = self.client.num_allocs()
        return out
