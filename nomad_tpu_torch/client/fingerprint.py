"""Host fingerprinting (ref client/fingerprint/ — arch, cpu, memory,
storage, network, host, nomad version — one fingerprinter per concern,
merged into the Node)."""
from __future__ import annotations

import os
import platform
import shutil
import socket
import uuid

from ..structs import (
    NetworkResource, Node, NodeCpuResources, NodeDiskResources,
    NodeMemoryResources, NodeNetworkResource, NodeResources,
)
from .. import __version__


def _cpu_mhz_total() -> tuple[int, int]:
    """(total MHz across cores, core count)"""
    cores = os.cpu_count() or 1
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except OSError:
        pass
    return int(mhz * cores), cores


def _memory_mb() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 1024


def _host_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


# --------------------------------------------------------- fingerprinters
#
# One function per concern, the reference's registry shape
# (client/fingerprint/fingerprint.go hostFingerprinters): each takes the
# node + a config dict and merges attributes/resources/links in. All are
# best-effort — a fingerprinter that can't read its source contributes
# nothing, it never fails node startup.

def fp_arch(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/arch.go"""
    node.attributes["arch"] = platform.machine()


def fp_cpu(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/cpu.go"""
    cpu_mhz, cores = _cpu_mhz_total()
    node.attributes["cpu.numcores"] = str(cores)
    node.attributes["cpu.totalcompute"] = str(cpu_mhz)
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    node.attributes["cpu.modelname"] = \
                        line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    node.node_resources.cpu = NodeCpuResources(
        cpu_shares=cpu_mhz, total_core_count=cores,
        reservable_cores=list(range(cores)))


def fp_memory(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/memory.go"""
    mb = _memory_mb()
    node.attributes["memory.totalbytes"] = str(mb * 1024 * 1024)
    node.node_resources.memory = NodeMemoryResources(memory_mb=mb)


def fp_storage(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/storage.go: free/total bytes of the alloc
    dir's volume."""
    path = cfg.get("data_dir", "/tmp")
    try:
        usage = shutil.disk_usage(path)
        free_mb = usage.free // (1024 * 1024)
        node.attributes["unique.storage.volume"] = path
        node.attributes["unique.storage.bytestotal"] = str(usage.total)
        node.attributes["unique.storage.bytesfree"] = str(usage.free)
    except OSError:
        free_mb = 10 * 1024     # keep the node schedulable (stale mount)
    node.node_resources.disk = NodeDiskResources(disk_mb=free_mb)


def fp_host(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/host.go"""
    node.attributes["kernel.name"] = platform.system().lower()
    node.attributes["kernel.version"] = platform.release()
    node.attributes["os.name"] = platform.system().lower()
    node.attributes["os.version"] = platform.version()
    node.attributes["unique.hostname"] = platform.node()


def fp_nomad(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/nomad.go"""
    node.attributes["nomad.version"] = __version__
    node.attributes["nomad.revision"] = "tpu"


def fp_signal(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/signal.go: signals drivers can deliver."""
    import signal as _signal
    names = sorted(s.name for s in _signal.Signals
                   if s.name.startswith("SIG") and
                   not s.name.startswith("SIGRT"))
    node.attributes["os.signals"] = ",".join(names)


def fp_cgroup(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/cgroup_linux.go: cgroup mount + version."""
    if os.path.isdir("/sys/fs/cgroup"):
        v2 = os.path.exists("/sys/fs/cgroup/cgroup.controllers")
        node.attributes["unique.cgroup.mountpoint"] = "/sys/fs/cgroup"
        node.attributes["unique.cgroup.version"] = "v2" if v2 else "v1"


def fp_bridge(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/bridge_linux.go: bridge kernel module."""
    for probe in ("/sys/module/bridge",
                  "/proc/sys/net/bridge"):
        if os.path.exists(probe):
            node.attributes["plugins.cni.version.bridge"] = "host"
            node.attributes["nomad.bridge.available"] = "true"
            return


def fp_network(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/network.go: default-route interface + all
    link-up interfaces from /sys/class/net with speeds."""
    ip = _host_ip()
    node.attributes["unique.network.ip-address"] = ip
    dev, speed = "eth0", 1000
    try:
        ifaces = sorted(os.listdir("/sys/class/net"))
    except OSError:
        ifaces = []
    up = []
    for i in ifaces:
        if i == "lo":
            continue
        try:
            with open(f"/sys/class/net/{i}/operstate") as f:
                state = f.read().strip()
        except OSError:
            state = "unknown"
        if state not in ("up", "unknown"):
            continue
        mbits = 1000
        try:
            with open(f"/sys/class/net/{i}/speed") as f:
                mbits = max(int(f.read().strip()), 0) or 1000
        except (OSError, ValueError):
            pass
        up.append((i, mbits))
    if up:
        dev, speed = up[0]
    node.attributes["unique.network.interface"] = dev
    node.node_resources.networks = [NetworkResource(
        device=dev, ip=ip, cidr=f"{ip}/32", mbits=speed)]
    node.node_resources.node_networks = [NodeNetworkResource(
        mode="host", device=dev, speed=speed,
        addresses=[{"alias": "default", "address": ip}])]


def _metadata_get(url: str, headers: dict, timeout: float) -> str:
    import urllib.request
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def _probe_cloud(node: Node, cfg: dict, name: str, base: str,
                 headers: dict, gate: str, keys: list) -> bool:
    """Shared metadata prober for the per-cloud fingerprinters. The GATE
    key must answer (that's the platform-detection signal, ref
    env_aws.go isAWS / env_gce.go isGCE); remaining keys are collected
    best-effort, each behind the same short timeout. Returns detected."""
    if node.attributes.get("platform"):
        return False                     # an earlier cloud already won
    get = cfg.get("metadata_get", _metadata_get)
    timeout = float(cfg.get("metadata_timeout", 0.2))
    try:
        gate_val = get(base + gate, headers, timeout).strip()
    except Exception:                    # noqa: BLE001 — not on this cloud
        return False
    collected = {}
    for path, attr in keys:
        if path == gate:
            collected[attr] = gate_val
            continue
        try:
            collected[attr] = get(base + path, headers, timeout).strip()
        # absent metadata keys are the NORMAL case off-cloud
        except Exception:  # nomadlint: disable=EXC001 — probe, absent is fine
            pass
    node.attributes.update(collected)
    node.attributes["platform"] = name
    return True


def fp_env_aws(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/env_aws.go: EC2 IMDS attribute set."""
    keys = [
        ("instance-type", "platform.aws.instance-type"),
        ("ami-id", "platform.aws.ami-id"),
        ("placement/availability-zone",
         "platform.aws.placement.availability-zone"),
        ("local-ipv4", "unique.platform.aws.local-ipv4"),
        ("local-hostname", "unique.platform.aws.local-hostname"),
        ("public-ipv4", "unique.platform.aws.public-ipv4"),
        ("public-hostname", "unique.platform.aws.public-hostname"),
        ("mac", "unique.platform.aws.mac"),
        ("instance-life-cycle", "platform.aws.instance-life-cycle"),
    ]
    _probe_cloud(node, cfg, "aws",
                 "http://169.254.169.254/latest/meta-data/", {},
                 "instance-type", keys)


def fp_env_gce(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/env_gce.go: GCE metadata attribute set."""
    keys = [
        ("machine-type", "platform.gce.machine-type"),
        ("zone", "platform.gce.zone"),
        ("hostname", "unique.platform.gce.hostname"),
        ("id", "unique.platform.gce.id"),
        ("network-interfaces/0/ip", "unique.platform.gce.network.ip"),
        ("network-interfaces/0/access-configs/0/external-ip",
         "unique.platform.gce.network.external-ip"),
        ("scheduling/automatic-restart", "platform.gce.scheduling.automatic-restart"),
        ("scheduling/preemptible", "platform.gce.scheduling.preemptible"),
    ]
    _probe_cloud(node, cfg, "gce",
                 "http://169.254.169.254/computeMetadata/v1/instance/",
                 {"Metadata-Flavor": "Google"}, "machine-type", keys)


def fp_env_azure(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/env_azure.go: Azure IMDS attribute set."""
    q = "?api-version=2019-06-04&format=text"
    keys = [
        ("vmSize" + q, "platform.azure.compute.vm-size"),
        ("location" + q, "platform.azure.compute.location"),
        ("name" + q, "unique.platform.azure.compute.name"),
        ("resourceGroupName" + q,
         "platform.azure.compute.resource-group-name"),
        ("vmId" + q, "unique.platform.azure.compute.vm-id"),
        ("zone" + q, "platform.azure.compute.zone"),
        ("vmScaleSetName" + q, "platform.azure.compute.scale-set-name"),
    ]
    _probe_cloud(node, cfg, "azure",
                 "http://169.254.169.254/metadata/instance/compute/",
                 {"Metadata": "true"}, "vmSize" + q, keys)


def fp_cni(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/cni.go: scan the CNI config dir for
    .conf/.conflist networks -> plugins.cni.network.<name>."""
    import json as _json
    cni_dir = cfg.get("cni_config_dir", "/opt/cni/config")
    if not os.path.isdir(cni_dir):
        return
    for fn in sorted(os.listdir(cni_dir)):
        if not (fn.endswith(".conf") or fn.endswith(".conflist")
                or fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(cni_dir, fn)) as f:
                conf = _json.load(f)
        except (OSError, ValueError):
            continue
        name = conf.get("name")
        if name:
            node.attributes[f"plugins.cni.network.{name}"] = \
                str(conf.get("cniVersion", "unknown"))


def fp_os(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/host.go os.name/os.version via os-release."""
    try:
        with open("/etc/os-release") as f:
            kv = dict(line.strip().split("=", 1)
                      for line in f if "=" in line)
    except OSError:
        return
    name = kv.get("ID", kv.get("NAME", "")).strip('"')
    version = kv.get("VERSION_ID", "").strip('"')
    if name:
        node.attributes["os.name"] = name
    if version:
        node.attributes["os.version"] = version


def fp_virtual(node: Node, cfg: dict) -> None:
    """Virtualization detection (ref client/fingerprint: the reference
    tags cloud instances via env_*; the generic host analog reads DMI +
    the cpu hypervisor flag)."""
    try:
        with open("/sys/class/dmi/id/product_name") as f:
            product = f.read().strip()
        if product:
            node.attributes["unique.platform.product-name"] = product
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            if " hypervisor" in f.read():
                node.attributes["cpu.arch.virtual"] = "true"
                node.attributes["virtualization"] = "guest"
    except OSError:
        pass


def fp_consul(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/consul.go: probe the local Consul agent
    (or the analog service-catalog endpoint) and tag its presence."""
    addr = cfg.get("consul_addr", os.environ.get(
        "CONSUL_HTTP_ADDR", "http://127.0.0.1:8500"))
    try:
        body = _metadata_get(addr.rstrip("/") + "/v1/agent/self", {}, 0.5)
    except Exception:       # noqa: BLE001 — absent is the common case
        return
    node.attributes["consul.available"] = "true"
    import json as _json
    try:
        info = _json.loads(body)
        node.attributes["consul.version"] = \
            info.get("Config", {}).get("Version", "")
        node.attributes["consul.datacenter"] = \
            info.get("Config", {}).get("Datacenter", "")
    except ValueError:
        pass


def fp_vault(node: Node, cfg: dict) -> None:
    """ref client/fingerprint/vault.go: probe the Vault (analog
    secrets provider) health endpoint."""
    addr = cfg.get("vault_addr", os.environ.get("VAULT_ADDR", ""))
    if not addr:
        return
    try:
        _metadata_get(addr.rstrip("/") + "/v1/sys/health", {}, 0.5)
    except Exception:       # noqa: BLE001
        return
    node.attributes["vault.accessible"] = "true"


FINGERPRINTERS = [
    ("arch", fp_arch),
    ("cpu", fp_cpu),
    ("memory", fp_memory),
    ("storage", fp_storage),
    ("host", fp_host),
    ("os", fp_os),
    ("virtual", fp_virtual),
    ("nomad", fp_nomad),
    ("signal", fp_signal),
    ("cgroup", fp_cgroup),
    ("bridge", fp_bridge),
    ("network", fp_network),
    ("env_aws", fp_env_aws),
    ("env_gce", fp_env_gce),
    ("env_azure", fp_env_azure),
    ("cni", fp_cni),
    ("consul", fp_consul),
    ("vault", fp_vault),
]


def fingerprint_node(data_dir: str = "/tmp", datacenter: str = "dc1",
                     node_class: str = "", name: str = "",
                     node_id: str = "", cfg: dict | None = None) -> Node:
    """Assemble a Node by running every fingerprinter (ref
    client/fingerprint_manager.go + client.go:1462
    updateNodeFromFingerprint)."""
    cfg = dict(cfg or {})
    cfg.setdefault("data_dir", data_dir)
    node = Node(
        id=node_id or str(uuid.uuid4()),
        name=name or platform.node() or "node",
        datacenter=datacenter,
        node_class=node_class,
        node_resources=NodeResources(),
    )
    for fp_name, fp in FINGERPRINTERS:
        try:
            fp(node, cfg)
        # a fingerprinter that can't detect its facet just contributes
        # nothing; the node registers with what the others found
        except Exception:  # nomadlint: disable=EXC001 — probe, absent is fine
            pass
    return node


def fingerprint_drivers(drivers: dict) -> dict:
    """Driver fingerprints -> node.drivers + attributes
    (ref pluginmanager/drivermanager)."""
    out = {}
    for name, driver in drivers.items():
        out[name] = driver.fingerprint()
    return out
