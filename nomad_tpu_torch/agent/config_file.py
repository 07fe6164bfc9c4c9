"""Agent configuration files (ref command/agent/config.go +
config_parse.go): HCL or JSON files loaded with `agent -config <path>`
(repeatable — later files and explicit CLI flags override earlier
values, exactly the reference's merge order).

    region     = "east"
    datacenter = "dc1"
    data_dir   = "/var/lib/nomad"
    name       = "node-1"

    ports { http = 4646  rpc = 4647  serf = 4648 }

    server {
      enabled          = true
      bootstrap_expect = 3
      authoritative_region = "east"
    }

    client {
      enabled    = true
      servers    = ["10.0.0.1:4647"]
      node_class = "compute"
      plugin_dir = "/opt/nomad/plugins"
    }

    acl {
      enabled           = true
      replication_token = "..."
    }
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..jobspec.hcl import Body, EvalContext, HCLError, parse
from .agent import AgentConfig


class ConfigError(Exception):
    pass


def _body_to_dict(body: Body, ev: EvalContext) -> dict:
    out: dict = {}
    for name, attr in body.attributes().items():
        out[name] = ev.evaluate(attr.expr)
    for block in body.items:
        if not hasattr(block, "body"):
            continue
        sub = _body_to_dict(block.body, ev)
        # repeated blocks within ONE file deep-merge, matching how the
        # same stanzas split across files merge via merge_config
        if isinstance(out.get(block.type), dict):
            out[block.type] = merge_config(out[block.type], sub)
        else:
            out[block.type] = sub
    return out


def parse_config_file(path: str) -> dict:
    """One file -> plain nested dict of settings."""
    with open(path) as f:
        src = f.read()
    if path.endswith(".json"):
        try:
            return json.loads(src)
        except ValueError as e:
            raise ConfigError(f"{path}: {e}") from e
    try:
        body = parse(src)
    except HCLError as e:
        raise ConfigError(f"{path}: {e}") from e
    return _body_to_dict(body, EvalContext({"env": dict(os.environ)}))


def merge_config(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def load_config(paths: list[str]) -> dict:
    """Merge config files in order; a directory loads its *.hcl/*.json
    sorted (ref config.go LoadConfigDir)."""
    merged: dict = {}
    for path in paths:
        if os.path.isdir(path):
            entries = sorted(
                os.path.join(path, e) for e in os.listdir(path)
                if e.endswith((".hcl", ".json")))
        else:
            entries = [path]
        for entry in entries:
            merged = merge_config(merged, parse_config_file(entry))
    return merged


def _duration(v) -> float:
    """Go-style duration literal -> seconds; delegates to the jobspec
    parser's full implementation (compound literals like "1m30s",
    sub-ms units) and treats a bare number as seconds."""
    s = str(v).strip()
    try:
        return float(s)
    except ValueError:
        pass
    from ..jobspec.parse import ParseError, duration
    try:
        return duration(s)
    except ParseError as e:
        # apply_to_agent_config converts ValueError to ConfigError; a
        # jobspec ParseError would escape as a raw traceback
        raise ValueError(str(e)) from e


def apply_to_agent_config(cfg: AgentConfig, raw: dict) -> AgentConfig:
    """Overlay a parsed config-file dict onto an AgentConfig. Bad scalar
    values surface as ConfigError, not raw tracebacks."""
    try:
        return _apply(cfg, raw)
    except (ValueError, TypeError) as e:
        raise ConfigError(f"invalid config value: {e}") from e


def _apply(cfg: AgentConfig, raw: dict) -> AgentConfig:
    top = {
        "region": "region", "datacenter": "datacenter",
        "data_dir": "data_dir", "bind_addr": "bind_addr",
        "advertise_addr": "advertise_addr", "name": "node_name",
    }
    for key, field in top.items():
        if key in raw:
            setattr(cfg, field, raw[key])
    ports = raw.get("ports", {})
    if "http" in ports:
        cfg.http_port = int(ports["http"])
    if "rpc" in ports:
        cfg.rpc_port = int(ports["rpc"])
    if "serf" in ports:
        cfg.gossip_port = int(ports["serf"])
    server = raw.get("server", {})
    if server:
        cfg.server_enabled = bool(server.get("enabled",
                                             cfg.server_enabled))
        if "bootstrap_expect" in server:
            cfg.bootstrap_expect = int(server["bootstrap_expect"])
        if "authoritative_region" in server:
            cfg.authoritative_region = server["authoritative_region"]
        if "num_schedulers" in server:
            cfg.num_workers = int(server["num_schedulers"])
        if "encrypt" in server:
            cfg.encrypt_key = server["encrypt"]
        if "retry_join" in server or "start_join" in server:
            cfg.join = tuple(server.get("retry_join",
                                        server.get("start_join", [])))
    client = raw.get("client", {})
    if client:
        cfg.client_enabled = bool(client.get("enabled",
                                             cfg.client_enabled))
        if "servers" in client:
            cfg.servers = tuple(client["servers"])
        if "node_class" in client:
            cfg.node_class = client["node_class"]
        if "plugin_dir" in client:
            cfg.plugin_dir = client["plugin_dir"]
    acl = raw.get("acl", {})
    if acl:
        cfg.acl_enabled = bool(acl.get("enabled", cfg.acl_enabled))
        if "replication_token" in acl:
            cfg.replication_token = acl["replication_token"]
    telemetry = raw.get("telemetry", {})
    if telemetry:
        # ref config.go:638 Telemetry (subset)
        if "prometheus_metrics" in telemetry:
            cfg.telemetry_prometheus = bool(telemetry["prometheus_metrics"])
        if "collection_interval" in telemetry:
            cfg.telemetry_collection_interval = _duration(
                telemetry["collection_interval"])
    tls = raw.get("tls", {})
    if tls:
        # ref structs/config/tls.go: `rpc = true` turns on mutual TLS
        # for the RPC transport
        cfg.tls_enabled = bool(tls.get("rpc", cfg.tls_enabled))
        for key, field in (("ca_file", "tls_ca_file"),
                           ("cert_file", "tls_cert_file"),
                           ("key_file", "tls_key_file")):
            if key in tls:
                setattr(cfg, field, tls[key])
        if "verify_server_hostname" in tls:
            cfg.tls_verify_server_hostname = \
                bool(tls["verify_server_hostname"])
    return cfg
