"""External-system integrations re-designed as built-in subsystems.

The reference delegates service discovery to Consul (nomad/consul.go,
command/agent/consul/) and secrets to Vault (nomad/vault.go,
client/vaultclient/). Here both are first-class framework services behind
pluggable interfaces: a state-store-backed service catalog (the native
service discovery the reference later grew in 1.3, designed in from the
start) and a token-issuing secrets provider. Real Consul/Vault backends can
implement the same interfaces; nothing else changes.
"""
from .secrets import (  # noqa: F401
    InMemorySecretsProvider, SecretsProvider, VaultToken,
)
from .services import (  # noqa: F401
    CheckRunner, ServiceInstance, check_service,
)
from .template import render_template  # noqa: F401

__all__ = [
    "CheckRunner", "InMemorySecretsProvider", "SecretsProvider",
    "ServiceInstance", "VaultToken", "check_service", "render_template",
]
