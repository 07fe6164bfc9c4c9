"""Typed API client SDK (ref api/ package: api.Client and the per-resource
wrappers — api/jobs.go, api/allocations.go, api/nodes.go, api/event_stream.go
et al.). Pure stdlib HTTP; every endpoint family the agent serves has a
typed handle here, with blocking-query support mirroring api/api.go
QueryOptions/QueryMeta.
"""
from .client import (  # noqa: F401
    APIError, Client, QueryMeta, QueryOptions, WriteOptions, event_stream,
)

__all__ = ["APIError", "Client", "QueryMeta", "QueryOptions",
           "WriteOptions", "event_stream"]
