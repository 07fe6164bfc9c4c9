"""Carry a cluster across: the scheduler's counterpart of loading
weights. A scheduler has no weights; its state is the cluster — nodes,
jobs, allocations and the scheduler configuration.

`load_cluster(store, docs)` takes that state as API JSON (the dicts the
reference's `api_codec.to_api` produces, which is also what the HTTP API
serves), decodes it with this package's own `api_codec.from_api` and
upserts it into a port `StateStore`, in order: configuration, nodes, jobs,
allocations. The usage index then holds the same cap/used matrices, row
for row, as the store the documents came from.

    docs = {"scheduler_config": {...},      # optional
            "nodes": [{...}, ...],          # in the source's row order
            "jobs": [{...}, ...],
            "allocs": [{...}, ...]}
"""
from __future__ import annotations

from .api_codec import from_api
from .structs import Allocation, Job, Node, SchedulerConfiguration


def load_cluster(store, docs: dict) -> int:
    """Upsert the API-JSON cluster `docs` into `store`; returns the last
    raft index used (one index per upsert, after the store's latest)."""
    index = store.latest_index()
    cfg = docs.get("scheduler_config")
    if cfg is not None:
        index += 1
        store.set_scheduler_config(
            index, from_api(SchedulerConfiguration, cfg))
    for doc in docs.get("nodes", ()):
        index += 1
        store.upsert_node(index, from_api(Node, doc))
    for doc in docs.get("jobs", ()):
        index += 1
        store.upsert_job(index, from_api(Job, doc))
    allocs = [from_api(Allocation, doc) for doc in docs.get("allocs", ())]
    if allocs:
        index += 1
        store.upsert_allocs(index, allocs)
    return index
