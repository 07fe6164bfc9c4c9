"""ACL policy + token records (ref nomad/structs/structs.go ACLPolicy
:11160-ish and ACLToken; replication/bootstrap semantics in nomad/acl.go,
nomad/leader.go:1288)."""
from __future__ import annotations

import dataclasses
import time
import uuid
from dataclasses import dataclass, field

TOKEN_TYPE_CLIENT = "client"
TOKEN_TYPE_MANAGEMENT = "management"

ANONYMOUS_TOKEN_SECRET = ""


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""             # HCL policy source
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "ACLPolicy":
        return dataclasses.replace(self)


@dataclass
class ACLToken:
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = TOKEN_TYPE_CLIENT          # client | management
    policies: list[str] = field(default_factory=list)
    global_: bool = False
    create_time_unix: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "ACLToken":
        return dataclasses.replace(self, policies=list(self.policies))

    def is_management(self) -> bool:
        return self.type == TOKEN_TYPE_MANAGEMENT

    @staticmethod
    def new(name: str = "", type: str = TOKEN_TYPE_CLIENT,
            policies: list[str] | None = None,
            global_: bool = False) -> "ACLToken":
        return ACLToken(
            accessor_id=str(uuid.uuid4()), secret_id=str(uuid.uuid4()),
            name=name, type=type, policies=list(policies or []),
            global_=global_, create_time_unix=time.time())


def anonymous_token() -> ACLToken:
    """ref nomad/structs AnonymousACLToken"""
    return ACLToken(accessor_id="anonymous", secret_id="", name="Anonymous",
                    type=TOKEN_TYPE_CLIENT, policies=["anonymous"])
