"""Task environment construction (ref client/taskenv/env.go): the NOMAD_*
variables and ${...} interpolation tasks see."""
from __future__ import annotations

import re

from ..structs import Allocation, Node, Task, alloc_name_index


def build_task_env(alloc: Allocation, task: Task, node: Node,
                   task_dir: str, alloc_dir: str, secrets_dir: str,
                   network_status: dict = None) -> dict[str, str]:
    env: dict[str, str] = {}
    job = alloc.job
    env["NOMAD_ALLOC_ID"] = alloc.id
    if network_status:
        # bridge-mode netns (ref network_hook.go: the alloc's network
        # status feeds NOMAD_ALLOC_IP and friends)
        env["NOMAD_ALLOC_IP"] = network_status.get("ip", "")
        env["NOMAD_ALLOC_NETNS"] = network_status.get("netns", "")
    env["NOMAD_SHORT_ALLOC_ID"] = alloc.id[:8]
    env["NOMAD_ALLOC_NAME"] = alloc.name
    env["NOMAD_ALLOC_INDEX"] = str(max(0, alloc_name_index(alloc.name)))
    env["NOMAD_TASK_NAME"] = task.name
    env["NOMAD_GROUP_NAME"] = alloc.task_group
    env["NOMAD_JOB_ID"] = alloc.job_id
    env["NOMAD_JOB_NAME"] = job.name if job else alloc.job_id
    env["NOMAD_JOB_PARENT_ID"] = job.parent_id if job else ""
    env["NOMAD_NAMESPACE"] = alloc.namespace
    env["NOMAD_REGION"] = job.region if job else "global"
    env["NOMAD_DC"] = node.datacenter
    env["NOMAD_ALLOC_DIR"] = alloc_dir
    env["NOMAD_TASK_DIR"] = task_dir
    env["NOMAD_SECRETS_DIR"] = secrets_dir
    env["NOMAD_CPU_LIMIT"] = str(task.resources.cpu)
    env["NOMAD_MEMORY_LIMIT"] = str(task.resources.memory_mb)
    if task.resources.memory_max_mb:
        env["NOMAD_MEMORY_MAX_LIMIT"] = str(task.resources.memory_max_mb)

    # ports: NOMAD_PORT_<label>, NOMAD_ADDR_<label>, NOMAD_HOST_PORT_<label>
    tr = alloc.allocated_resources.tasks.get(task.name)
    networks = list(tr.networks) if tr else []
    networks += list(alloc.allocated_resources.shared.networks)
    for net in networks:
        for p in list(net.reserved_ports) + list(net.dynamic_ports):
            label = _env_key(p.label)
            env[f"NOMAD_PORT_{label}"] = str(p.to or p.value)
            env[f"NOMAD_HOST_PORT_{label}"] = str(p.value)
            if net.ip:
                env[f"NOMAD_ADDR_{label}"] = f"{net.ip}:{p.value}"
                env[f"NOMAD_IP_{label}"] = net.ip

    for k, v in (job.meta if job else {}).items():
        env[f"NOMAD_META_{_env_key(k)}"] = v
    if job:
        tg = job.lookup_task_group(alloc.task_group)
        if tg:
            for k, v in tg.meta.items():
                env[f"NOMAD_META_{_env_key(k)}"] = v
    for k, v in task.meta.items():
        env[f"NOMAD_META_{_env_key(k)}"] = v

    # user env last (may reference NOMAD_* via ${...})
    for k, v in task.env.items():
        env[k] = interpolate(v, env, node)
    return env


_KEY_RE = re.compile(r"[^A-Za-z0-9_]")


def _env_key(k: str) -> str:
    return _KEY_RE.sub("_", k)


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def interpolate(value: str, env: dict[str, str], node: Node) -> str:
    """${env.X} / ${NOMAD_*} / ${attr.*} / ${meta.*} / ${node.*}
    interpolation (ref client/taskenv ReplaceEnv)."""

    def repl(m: re.Match) -> str:
        key = m.group(1).strip()
        if key.startswith("env."):
            return env.get(key[4:], "")
        if key in env:
            return env[key]
        if key.startswith("attr."):
            return str(node.attributes.get(key[5:], ""))
        if key.startswith("meta."):
            return str(node.meta.get(key[5:], ""))
        if key == "node.unique.id":
            return node.id
        if key == "node.unique.name":
            return node.name
        if key == "node.datacenter":
            return node.datacenter
        if key == "node.class":
            return node.node_class
        return m.group(0)

    return _INTERP_RE.sub(repl, value)
