"""Alloc network hook: bridge-mode network namespaces with port mapping
(behavioral ref client/allocrunner/network_hook.go +
networking_bridge_linux.go + the CNI bridge plugin conf it drives).

A task group with ``network { mode = "bridge" }`` gets its own network
namespace joined to a shared ``nomad`` bridge, an IP from the bridge
subnet, and DNAT rules mapping each reserved/dynamic host port to the
group's ``to`` port inside the namespace — so tasks bind container-side
ports while the scheduler keeps owning host ports.

All privileged operations run through a Commander so the manager is
fully testable without root: the default ExecCommander shells out to
``ip``/``iptables`` (and requires CAP_NET_ADMIN), while tests inject a
recording fake. On hosts without the tooling the hook degrades to
host-mode networking with a logged warning, mirroring the reference's
fingerprint-gated behavior (bridge networking only activates on nodes
that fingerprint the kernel support).
"""
from __future__ import annotations

import ipaddress
import shutil
import subprocess
import threading
from typing import Optional

BRIDGE_NAME = "nomad"                     # ref nomadBridgeName
# ref defaultNomadAllocSubnet (networking_bridge_linux.go)
BRIDGE_SUBNET = "172.26.64.0/20"
IPTABLES_CHAIN = "NOMAD-ADMIN"            # ref cniAdminChainName


class Commander:
    """Shell-out boundary (swap for a fake in tests)."""

    def run(self, *argv: str) -> str:
        raise NotImplementedError

    def available(self) -> bool:
        raise NotImplementedError


class ExecCommander(Commander):
    def run(self, *argv: str) -> str:
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=10)
        if out.returncode != 0:
            raise RuntimeError(
                f"{' '.join(argv)}: rc={out.returncode}: "
                f"{out.stderr.strip()}")
        return out.stdout

    def available(self) -> bool:
        import os
        return bool(shutil.which("ip")) and bool(shutil.which("iptables")) \
            and os.geteuid() == 0


class BridgeNetworkManager:
    """Creates/destroys per-alloc namespaces on the shared nomad bridge.

    IP assignment is a simple in-process allocator over the bridge
    subnet (the reference delegates this to the CNI host-local IPAM
    plugin with the same subnet); .1 is the bridge gateway.
    """

    def __init__(self, commander: Optional[Commander] = None, logger=None):
        self.cmd = commander or ExecCommander()
        self.logger = logger or (lambda msg: None)
        self._lock = threading.Lock()
        self._bridge_ready = False
        net = ipaddress.ip_network(BRIDGE_SUBNET)
        self._gateway = str(net.network_address + 1)
        self._prefix_len = net.prefixlen
        self._ip_pool = iter(net.hosts())
        next(self._ip_pool)               # skip the gateway
        self._leases: dict[str, str] = {}   # alloc_id -> ip
        self._free_ips: list[str] = []      # recycled leases, LIFO

    # ------------------------------------------------------------- bridge
    def _ensure_bridge(self) -> None:
        """ref networking_bridge_linux.go ensureForwardingRules + the CNI
        bridge plugin's lazy bridge creation."""
        if self._bridge_ready:
            return
        try:
            self.cmd.run("ip", "link", "show", BRIDGE_NAME)
        except RuntimeError:
            self.cmd.run("ip", "link", "add", BRIDGE_NAME, "type", "bridge")
            self.cmd.run("ip", "addr", "add",
                         f"{self._gateway}/{self._prefix_len}",
                         "dev", BRIDGE_NAME)
        self.cmd.run("ip", "link", "set", BRIDGE_NAME, "up")
        # admin chain ensuring bridge traffic is forwarded (ref
        # ensureForwardingRules): `-C` probes for the jump rule and
        # exits non-zero when absent — that is the fresh-host case, so
        # insert it then
        try:
            self.cmd.run("iptables", "-N", IPTABLES_CHAIN)
        except RuntimeError:
            pass                          # chain exists
        try:
            self.cmd.run("iptables", "-C", "FORWARD", "-j", IPTABLES_CHAIN)
        except RuntimeError:
            self.cmd.run("iptables", "-I", "FORWARD", "-j", IPTABLES_CHAIN)
        self._bridge_ready = True

    # -------------------------------------------------------------- setup
    @staticmethod
    def netns_name(alloc_id: str) -> str:
        # full alloc id (ADVICE r4): netns names allow 255 chars, and an
        # 8-hex prefix collides across live allocs often enough that the
        # failure mode (cross-alloc teardown) is worth avoiding outright
        return f"nomad-{alloc_id}"

    def setup(self, alloc_id: str, ports: list[dict]) -> dict:
        """Create the alloc namespace; returns {"ip", "netns", "gateway"}.

        ports: [{"label", "value" (host), "to" (container)}] — one DNAT
        rule per mapped port (ref getPortMapping + the CNI portmap
        plugin).
        """
        ns = self.netns_name(alloc_id)
        # IFNAMSIZ caps interface names at 15 chars: "veth" + 11 id chars
        # (dashes stripped) is the most entropy that fits
        veth_host = f"veth{alloc_id.replace('-', '')[:11]}"
        veth_ns = "eth0"
        with self._lock:
            self._ensure_bridge()
            ip = self._leases.get(alloc_id)
            if ip is None:
                # recycled leases first so a long-lived client never
                # exhausts the subnet (the host-local IPAM plugin the
                # reference drives recycles the same way)
                ip = (self._free_ips.pop() if self._free_ips
                      else str(next(self._ip_pool)))
                self._leases[alloc_id] = ip
        try:
            self.cmd.run("ip", "netns", "add", ns)
            self.cmd.run("ip", "link", "add", veth_host, "type", "veth",
                         "peer", "name", veth_ns, "netns", ns)
            self.cmd.run("ip", "link", "set", veth_host, "master",
                         BRIDGE_NAME)
            self.cmd.run("ip", "link", "set", veth_host, "up")
            self.cmd.run("ip", "-n", ns, "addr", "add",
                         f"{ip}/{self._prefix_len}", "dev", veth_ns)
            self.cmd.run("ip", "-n", ns, "link", "set", veth_ns, "up")
            self.cmd.run("ip", "-n", ns, "link", "set", "lo", "up")
            self.cmd.run("ip", "-n", ns, "route", "add", "default", "via",
                         self._gateway)
            for p in ports:
                to = int(p.get("to") or p.get("value") or 0)
                host_port = int(p.get("value") or 0)
                if host_port <= 0 or to <= 0:
                    continue
                self.cmd.run(
                    "iptables", "-t", "nat", "-A", "PREROUTING",
                    "-p", "tcp", "--dport", str(host_port),
                    "-j", "DNAT", "--to-destination", f"{ip}:{to}",
                    "-m", "comment", "--comment", f"nomad-alloc-{alloc_id}")
        except RuntimeError:
            self.teardown(alloc_id, ports)
            raise
        return {"ip": ip, "netns": ns, "gateway": self._gateway}

    # ------------------------------------------------------------ teardown
    def teardown(self, alloc_id: str, ports: list[dict]) -> None:
        ns = self.netns_name(alloc_id)
        with self._lock:
            ip = self._leases.pop(alloc_id, None)
            if ip is not None:
                self._free_ips.append(ip)
        if ip is not None:
            for p in ports or []:
                to = int(p.get("to") or p.get("value") or 0)
                host_port = int(p.get("value") or 0)
                if host_port <= 0 or to <= 0:
                    continue
                try:
                    self.cmd.run(
                        "iptables", "-t", "nat", "-D", "PREROUTING",
                        "-p", "tcp", "--dport", str(host_port),
                        "-j", "DNAT", "--to-destination", f"{ip}:{to}",
                        "-m", "comment", "--comment",
                        f"nomad-alloc-{alloc_id}")
                except RuntimeError:
                    pass
        else:
            # no lease (client restarted since setup): find this alloc's
            # rules by their comment tag in iptables-save output and
            # delete each by exact spec. Rules stamped by a pre-upgrade
            # client carry the legacy short tag, so match both formats
            # (quoted exactly — a bare prefix match could hit another
            # alloc sharing the 8-char id prefix)
            try:
                saved = self.cmd.run("iptables-save", "-t", "nat")
            except RuntimeError:
                saved = ""
            tags = (f'"nomad-alloc-{alloc_id}"',
                    f'"nomad-alloc-{alloc_id[:8]}"')
            for line in (saved or "").splitlines():
                if line.startswith("-A ") and any(t in line for t in tags):
                    # iptables-save quotes comment values; the live rule
                    # has no quotes, so strip them or -D never matches
                    spec = [tok.strip('"') for tok in line.split()[1:]]
                    try:
                        self.cmd.run("iptables", "-t", "nat", "-D", *spec)
                    except RuntimeError:
                        pass
        # also reap the legacy short-named namespace a pre-upgrade client
        # may have created for this alloc
        for name in {ns, f"nomad-{alloc_id[:8]}"}:
            try:
                self.cmd.run("ip", "netns", "delete", name)
            except RuntimeError:
                pass                      # already gone (idempotent stop)


class CNINetworkManager:
    """Execute a CNI plugin chain from a .conflist (ref
    client/allocrunner/networking_cni.go + the CNI spec's exec protocol):
    a group with ``network { mode = "cni/<name>" }`` runs every plugin in
    the named conflist with CNI_COMMAND=ADD at alloc start and DEL (in
    reverse order) at stop. Plugin invocation goes through an injectable
    runner so the chain is testable without CNI binaries; the default
    runner executes ``<cni_bin_dir>/<type>`` with the conf on stdin, per
    the spec."""

    def __init__(self, config_dir: str = "/opt/cni/config",
                 bin_dir: str = "/opt/cni/bin", runner=None, logger=None,
                 netns=None):
        self.config_dir = config_dir
        self.bin_dir = bin_dir
        self.logger = logger or (lambda msg: None)
        self.runner = runner or self._exec_runner
        # netns lifecycle is NOMAD's job, not the plugins' (ref
        # networking_bridge_linux.go: the runtime creates the sandbox,
        # CNI wires it). Injectable alongside the runner for tests; when
        # a custom runner is supplied without a netns fn, default to
        # no-op (the fake plugin world has no kernel namespaces).
        if netns is not None:
            self.netns = netns
        elif runner is not None:
            self.netns = lambda action, name: None
        else:
            self.netns = self._exec_netns
        # (alloc, net) -> (ADD result, conflist used) — DEL must run the
        # SAME config ADD ran even if the file was removed meanwhile
        self._results: dict[tuple, tuple] = {}

    @staticmethod
    def _exec_netns(action: str, name: str) -> None:
        out = subprocess.run(["ip", "netns", action, name],
                             capture_output=True, text=True, timeout=10)
        if out.returncode != 0 and action == "add":
            raise RuntimeError(f"ip netns {action} {name}: "
                               f"{out.stderr.strip()}")

    def _exec_runner(self, plugin_type: str, env: dict,
                     conf_json: str) -> str:
        import os
        binary = f"{self.bin_dir}/{plugin_type}"
        out = subprocess.run([binary], input=conf_json, env={
            **os.environ, **env}, capture_output=True, text=True,
            timeout=30)
        if out.returncode != 0:
            raise RuntimeError(f"CNI {plugin_type} "
                               f"{env.get('CNI_COMMAND')}: "
                               f"{out.stderr.strip() or out.stdout.strip()}")
        return out.stdout

    def available(self, net_name: str) -> bool:
        return self._load_conflist(net_name) is not None

    def _load_conflist(self, net_name: str):
        import json
        import os
        try:
            names = sorted(os.listdir(self.config_dir))
        except OSError:
            return None
        for fn in names:
            if not (fn.endswith(".conflist") or fn.endswith(".conf")):
                continue
            try:
                with open(os.path.join(self.config_dir, fn)) as f:
                    conf = json.load(f)
            except (OSError, ValueError):
                continue
            if conf.get("name") == net_name:
                if "plugins" not in conf:       # bare .conf -> one-plugin
                    conf = {"name": conf.get("name"),
                            "cniVersion": conf.get("cniVersion", "1.0.0"),
                            "plugins": [conf]}
                return conf
        return None

    def _env(self, command: str, alloc_id: str) -> dict:
        return {
            "CNI_COMMAND": command,
            "CNI_CONTAINERID": alloc_id,
            "CNI_NETNS": f"/var/run/netns/nomad-{alloc_id}",
            "CNI_IFNAME": "eth0",
            "CNI_PATH": self.bin_dir,
        }

    @staticmethod
    def _port_mappings(ports: list[dict]) -> list[dict]:
        return [{"hostPort": p.get("value"),
                 "containerPort": p.get("to") or p.get("value"),
                 "protocol": "tcp"} for p in ports]

    def _plugin_conf(self, plugin: dict, conf: dict, prev,
                     ports: list[dict]) -> dict:
        """Per-plugin stdin config: name/version injection, prevResult
        chaining, and capability args delivered as runtimeConfig — the
        ONLY channel real plugins read them from (libcni injects
        runtimeConfig for each capability the plugin declares; ref
        getPortMapping + the CNI conventions doc)."""
        pconf = {**plugin, "name": conf["name"],
                 "cniVersion": conf.get("cniVersion", "1.0.0")}
        if prev is not None:
            pconf["prevResult"] = prev
        if (plugin.get("capabilities") or {}).get("portMappings"):
            pconf["runtimeConfig"] = {
                "portMappings": self._port_mappings(ports)}
        return pconf

    def setup(self, alloc_id: str, net_name: str,
              ports: list[dict]):
        """Run the ADD chain; returns the netns status dict, or None when
        the named network has no conflist (caller falls back to host
        networking — returning None instead of raising closes the
        available()/setup() TOCTOU window)."""
        import json
        conf = self._load_conflist(net_name)
        if conf is None:
            return None
        ns = f"nomad-{alloc_id}"
        self.netns("add", ns)
        env = self._env("ADD", alloc_id)
        prev = None
        added: list = []
        try:
            for plugin in conf["plugins"]:
                pconf = self._plugin_conf(plugin, conf, prev, ports)
                out = self.runner(plugin.get("type", ""), env,
                                  json.dumps(pconf))
                added.append(plugin)
                try:
                    prev = json.loads(out) if out.strip() else prev
                except ValueError:
                    pass                 # plugins may emit empty output
        except Exception:
            # mid-chain failure: unwind what DID run (reverse DEL) and
            # drop the netns, or every scheduler retry leaks an IPAM
            # lease + namespace
            del_env = self._env("DEL", alloc_id)
            for plugin in reversed(added):
                try:
                    self.runner(plugin.get("type", ""), del_env,
                                json.dumps(self._plugin_conf(
                                    plugin, conf, prev, ports)))
                except Exception as e:  # noqa: BLE001
                    self.logger(f"CNI rollback {plugin.get('type')}: "
                                f"{e!r}")
            try:
                self.netns("delete", ns)
            # unwind path: the ORIGINAL setup error re-raises below and
            # carries the diagnosis; a secondary netns-delete failure
            # must not mask it
            except Exception:  # nomadlint: disable=EXC001 — rollback
                pass
            raise
        result = prev or {}
        ips = result.get("ips") or []
        status = {"mode": f"cni/{net_name}", "netns": ns,
                  "ip": (ips[0].get("address", "").split("/")[0]
                         if ips else ""),
                  "result": result}
        self._results[(alloc_id, net_name)] = (result, conf)
        return status

    def teardown(self, alloc_id: str, net_name: str,
                 ports: list[dict]) -> None:
        import json
        cached = self._results.pop((alloc_id, net_name), None)
        if cached is not None:
            prev, conf = cached
        else:
            # client restarted since ADD: fall back to the on-disk conf
            prev, conf = None, self._load_conflist(net_name)
        ns = f"nomad-{alloc_id}"
        if conf is not None:
            env = self._env("DEL", alloc_id)
            # DEL runs the chain in REVERSE (CNI spec §4), with the SAME
            # config ADD used even if the file changed/vanished meanwhile
            for plugin in reversed(conf["plugins"]):
                try:
                    self.runner(plugin.get("type", ""), env,
                                json.dumps(self._plugin_conf(
                                    plugin, conf, prev, ports)))
                except Exception as e:  # noqa: BLE001 — keep deleting
                    self.logger(f"CNI DEL {plugin.get('type')}: {e!r}")
        try:
            self.netns("delete", ns)
        except Exception as e:          # noqa: BLE001 — already gone
            self.logger(f"CNI netns delete {ns}: {e!r}")


class NetworkHook:
    """The alloc-runner-facing hook (ref network_hook.go): no-ops unless
    the group requests bridge or cni/<name> mode AND the host supports
    it."""

    def __init__(self, manager: Optional[BridgeNetworkManager] = None,
                 logger=None, cni: Optional[CNINetworkManager] = None):
        self.logger = logger or (lambda msg: None)
        self.manager = manager or BridgeNetworkManager(logger=self.logger)
        self.cni = cni or CNINetworkManager(logger=self.logger)
        self.status: dict[str, dict] = {}    # alloc_id -> netns status

    @staticmethod
    def _bridge_requested(tg) -> bool:
        return bool(tg and tg.networks
                    and tg.networks[0].mode == "bridge")

    @staticmethod
    def _alloc_ports(alloc) -> list[dict]:
        res = alloc.allocated_resources
        if res is None or res.shared is None:
            return []
        return [dict(p) for p in (res.shared.ports or [])]

    @staticmethod
    def _cni_net(tg) -> str:
        mode = (tg.networks[0].mode if tg and tg.networks else "") or ""
        return mode[4:] if mode.startswith("cni/") else ""

    def prerun(self, alloc, tg) -> Optional[dict]:
        net = self._cni_net(tg)
        if net:
            st = self.cni.setup(alloc.id, net, self._alloc_ports(alloc))
            if st is None:
                self.logger(
                    f"network_hook: cni/{net} requested by alloc "
                    f"{alloc.id[:8]} but no conflist found; using host "
                    f"networking")
                return None
            self.status[alloc.id] = st
            return st
        if not self._bridge_requested(tg):
            return None
        if not self.manager.cmd.available():
            # degrade to host networking, as the reference does on nodes
            # whose fingerprint lacks bridge support
            self.logger(
                f"network_hook: bridge mode requested by alloc "
                f"{alloc.id[:8]} but host tooling unavailable; using "
                f"host networking")
            return None
        st = self.manager.setup(alloc.id, self._alloc_ports(alloc))
        self.status[alloc.id] = st
        return st

    def postrun(self, alloc, tg) -> None:
        net = self._cni_net(tg)
        if net:
            self.cni.teardown(alloc.id, net, self._alloc_ports(alloc))
            self.status.pop(alloc.id, None)
            return
        if alloc.id not in self.status:
            # a bridge alloc restored after a client restart has no
            # in-memory status (restore never re-runs prerun) — still
            # tear down the namespace so it isn't orphaned on the host;
            # teardown is idempotent when nothing exists
            if not (self._bridge_requested(tg)
                    and self.manager.cmd.available()):
                return
        self.manager.teardown(alloc.id, self._alloc_ports(alloc))
        self.status.pop(alloc.id, None)

