"""A client's batch of allocation updates on the CPU: the port's
`StateStore.update_allocs_from_client` (one summary copy and one job
status pass a job an update, a shallow copy an alloc) against the
reference's store, its snapshots, and `Server.node_update_allocs` (the
follow-up evals' allocs read in one hold of the store's lock).

The parity cases drive the SAME seeded updates through a reference store
and a port store (pinned ids, explicit modify times) and compare every
alloc, summary, job status, deployment, the usage index with its delta
log, and the ordered events, after every update. They part in one
place: a job's status that flips and flips back within one update (a
terminal alloc reported live again) keeps its index in the port, which
writes a job's status once an update as Nomad's setJobStatuses, where
the reference stamps it with the update's index on each flip. The
`flip_back` case makes that happen and holds every job to that rule;
the other cases hold the jobs to the reference's exactly.
"""
import dataclasses
import random
import types

import pytest

import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.state import StateStore as RefStore

import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.obs import trace
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state import StateStore as PortStore

REF = types.SimpleNamespace(mock=ref_mock, structs=ref_structs, Store=RefStore)
PORT = types.SimpleNamespace(mock=port_mock, structs=port_structs,
                             Store=PortStore)
SIDES = (REF, PORT)

LIVE = ("pending", "running")
TERMINAL = ("complete", "failed", "lost")


# ------------------------------------------------------------ the scenario


def _scenario(case: str, seed: int) -> dict:
    """A plain description of one case: nodes, jobs, allocs, and the
    client updates, drawn from `seed` (no package's objects)."""
    rng = random.Random(seed)
    kinds = {"deployment": ["service"] * 4,
             "dead_mid_batch": ["batch"] * 4,
             "flip_back": ["batch"] * 4}.get(
        case, ["batch", "service", "batch", "sysbatch", "service", "batch"])
    jobs, allocs = [], {}
    for j, kind in enumerate(kinds):
        job_id = f"job-{j}"
        # a job with an outstanding eval reads pending, not dead, once
        # its allocs are terminal
        jobs.append({"id": job_id, "kind": kind,
                     "pending_eval": j % 3 == 2,
                     "deployment": ("running" if j % 4 != 3 else "successful")
                     if kind == "service" else None})
        for k in range(rng.randint(6, 14)):
            status = rng.choice(("pending", "running", "running",
                                 "running", "complete"))
            allocs[f"{job_id}-a{k}"] = {
                "job": job_id, "node": rng.randrange(8), "status": status,
                "desired": "stop" if rng.random() < 0.1 else "run",
                "healthy": rng.choice((None, True, False))
                if kind == "service" else None}
    ids = list(allocs)
    current = {aid: a["status"] for aid, a in allocs.items()}
    healthy = {aid: a["healthy"] for aid, a in allocs.items()}

    def one(aid):
        if aid not in current:
            return {"id": aid, "status": rng.choice(TERMINAL + LIVE),
                    "healthy": None}
        if current[aid] in TERMINAL:
            status = rng.choice(TERMINAL)
        else:
            status = rng.choice(("running", "running", "complete",
                                 "failed", "lost"))
        current[aid] = status
        h = None
        if allocs[aid]["healthy"] is not None or \
                allocs[aid]["job"] in {j["id"] for j in jobs
                                       if j["kind"] == "service"}:
            h = rng.choice((None, True, False, not healthy[aid]))
            if h is not None:
                healthy[aid] = h
        return {"id": aid, "status": status, "healthy": h}

    updates = []
    if case == "single":
        for _ in range(40):
            updates.append([one(rng.choice(ids + ["unknown-0"]))])
    elif case == "dead_mid_batch":
        # each update ends one job's live allocs first, then reports on
        # the others
        for j in jobs:
            ups = []
            for aid in ids:
                if allocs[aid]["job"] == j["id"] and \
                        current[aid] not in TERMINAL:
                    current[aid] = "complete"
                    ups.append({"id": aid, "status": "complete",
                                "healthy": None})
            rest = [aid for aid in ids if allocs[aid]["job"] != j["id"]]
            ups += [one(aid) for aid in rng.sample(rest, 10)]
            updates.append(ups)
    elif case == "flip_back":
        # each update ends one job's live allocs, then reports one of its
        # terminal allocs live again: the job's status flips (dead, or
        # pending with an outstanding eval) and flips back within it
        for j in jobs:
            mine = [aid for aid in ids if allocs[aid]["job"] == j["id"]]
            ended = [aid for aid in mine if current[aid] in TERMINAL]
            ups = []
            for aid in mine:
                if current[aid] not in TERMINAL:
                    current[aid] = "complete"
                    ups.append({"id": aid, "status": "complete",
                                "healthy": None})
            again = rng.choice(ended or mine)
            current[again] = "running"
            ups.append({"id": again, "status": "running", "healthy": None})
            rest = [aid for aid in ids if allocs[aid]["job"] != j["id"]]
            ups += [one(aid) for aid in rng.sample(rest, 10)]
            updates.append(ups)
    else:
        for _ in range(8):
            batch = rng.sample(ids, rng.randint(8, len(ids) // 2))
            ups = [one(aid) for aid in batch]
            ups.insert(rng.randrange(len(ups) + 1),
                       one(f"unknown-{len(updates)}"))
            updates.append(ups)
    return {"jobs": jobs, "allocs": allocs, "updates": updates}


def _build(side, sc: dict):
    """(store, next index, events) for `sc` on one side."""
    s = side.structs
    store = side.Store()
    events = []
    store.event_sinks.append(
        lambda topic, etype, index, payload:
        events.append((topic, etype, index, payload.id)))
    store.event_batch_sinks.append(
        lambda batch: events.extend((t, e, i, p.id) for t, e, i, p in batch))
    idx = 1
    nodes = []
    for i in range(8):
        n = side.mock.node()
        n.id, n.name = f"node-{i:04d}", f"cu-{i}"
        store.upsert_node(idx, n)
        nodes.append(n)
        idx += 1
    jobs = {}
    for spec in sc["jobs"]:
        job = side.mock.batch_job() if spec["kind"] != "service" \
            else side.mock.job()
        job.id = job.name = spec["id"]
        job.type = spec["kind"]
        store.upsert_job(idx, job)
        idx += 1
        jobs[spec["id"]] = job
        ev = s.Evaluation(id=f"ev-{spec['id']}", job_id=job.id,
                          type=job.type, priority=job.priority,
                          status="pending" if spec["pending_eval"]
                          else "complete")
        store.upsert_evals(idx, [ev])
        idx += 1
        if spec["deployment"]:
            tg = job.task_groups[0].name
            store.upsert_deployment(idx, s.Deployment(
                id=f"dep-{spec['id']}", job_id=job.id,
                status=spec["deployment"],
                task_groups={tg: s.DeploymentState(desired_total=10)}))
            idx += 1
    allocs = []
    for k, (aid, a) in enumerate(sc["allocs"].items()):
        job = jobs[a["job"]]
        alloc = side.mock.alloc_for(job, nodes[a["node"]], index=k)
        alloc.id, alloc.eval_id = aid, f"ev-{a['job']}"
        alloc.client_status = a["status"]
        alloc.desired_status = a["desired"]
        alloc.desired_transition = s.DesiredTransition(
            migrate=a["desired"] == "stop")
        if job.type == "service":
            alloc.deployment_id = f"dep-{a['job']}"
            if a["healthy"] is not None:
                alloc.deployment_status = s.AllocDeploymentStatus(
                    healthy=a["healthy"], timestamp_unix=5.0)
        allocs.append(alloc)
    store.upsert_allocs(idx, allocs)
    return store, idx + 1, events


def _update(side, u: dict, t: float):
    s = side.structs
    alloc = s.Allocation(id=u["id"], client_status=u["status"],
                         client_description=f"{u['status']} at {t}",
                         modify_time_unix=t)
    alloc.task_states = {"web": s.TaskState(
        state="dead" if u["status"] in TERMINAL else "running",
        failed=u["status"] == "failed", finished_at=t)}
    if u["healthy"] is not None:
        alloc.deployment_status = s.AllocDeploymentStatus(
            healthy=u["healthy"], timestamp_unix=t)
    return alloc


def _jobs(store) -> dict:
    return {k: (j.status, j.modify_index) for k, j in sorted(store.jobs.items())}


def _state(store) -> dict:
    """Everything a client update writes, as plain values."""
    def alloc(a):
        d = dataclasses.asdict(a)
        d.pop("job")
        return d

    u = store.usage
    u._flush()
    n = u._n
    return {
        "allocs": {aid: alloc(a) for aid, a in sorted(store.allocs.items())},
        "summaries": {k: dataclasses.asdict(v)
                      for k, v in sorted(store.job_summaries.items())},
        "jobs": _jobs(store),
        "deployments": {k: dataclasses.asdict(d)
                        for k, d in sorted(store.deployments.items())},
        "used": u.used[:n].tolist(), "counts": u.counts[:n].tolist(),
        "contrib": dict(u._contrib), "seq_rows": dict(u.seq_rows),
        "delta_log": (u.delta_log.tail[0], list(u.delta_log.tail[1])),
        "version": u.version, "index": store.latest_index(),
    }


# --------------------------------------------------------------- parity


@pytest.mark.parametrize("seed", [3, 2024])
@pytest.mark.parametrize("case", ["mixed", "single", "deployment",
                                  "dead_mid_batch", "window", "flip_back"])
def test_client_updates_match_the_reference(case, seed):
    sc = _scenario(case, seed)
    built = {id(side): _build(side, sc) for side in SIDES}
    (ref, idx, ref_events), (port, _, port_events) = \
        built[id(REF)], built[id(PORT)]
    assert _state(port) == _state(ref)
    flipped_back = 0
    for k, ups in enumerate(sc["updates"]):
        t = 1000.0 + k
        ref_before, port_before = _jobs(ref), _jobs(port)
        for side, store in ((REF, ref), (PORT, port)):
            batch = [_update(side, u, t) for u in ups]
            if case == "window":
                with store.batch_window():
                    store.update_allocs_from_client(idx + k, batch)
            else:
                store.update_allocs_from_client(idx + k, batch)
        ref_state, port_state = _state(ref), _state(port)
        ref_jobs, port_jobs = ref_state.pop("jobs"), port_state.pop("jobs")
        assert port_state == ref_state, f"after update {k}"
        assert port_events == ref_events, f"after update {k}"
        # the reference's job, but one whose status the update left as it
        # was keeps the port's index from before the update
        assert port_jobs == {
            key: port_before[key] if status == ref_before[key][0]
            else (status, index)
            for key, (status, index) in ref_jobs.items()}, f"after update {k}"
        flipped_back += sum(ref_jobs[key][1] == idx + k and
                            port_jobs[key] == port_before[key]
                            for key in ref_jobs)
        if case != "flip_back":
            assert port_jobs == ref_jobs, f"after update {k}"
    assert len(port_events) > len(sc["allocs"])
    if case == "flip_back":
        assert flipped_back
    statuses = {j.status for j in port.jobs.values()}
    if case == "dead_mid_batch":
        assert statuses == {"dead", "pending"}
    if case == "deployment":
        moved = [d for d in port.deployments.values()
                 for st in d.task_groups.values()
                 if st.healthy_allocs or st.unhealthy_allocs]
        assert moved


def test_a_job_status_that_returns_within_an_update_is_not_rewritten():
    """Nomad computes a job's status once after the update's allocs: a
    status that flips and flips back within one update (a terminal alloc
    reported live again) leaves the job as it was, where a write an
    alloc would stamp it with the update's index."""
    store = PortStore()
    job = port_mock.batch_job()
    store.upsert_job(1, job)
    node = port_mock.node()
    store.upsert_node(2, node)
    a, b = (port_mock.alloc_for(job, node, index=i) for i in range(2))
    a.client_status, b.client_status = "running", "complete"
    store.upsert_allocs(3, [a, b])
    store.update_allocs_from_client(4, [a.copy()])
    before = store.jobs[(job.namespace, job.id)]
    assert (before.status, before.modify_index) == ("running", 4)
    done, back = a.copy(), b.copy()
    done.client_status, back.client_status = "complete", "running"
    assert store.update_allocs_from_client(5, [done, back]) == 1
    assert store.jobs[(job.namespace, job.id)] is before
    done = store.allocs[b.id].copy()
    done.client_status = "complete"
    store.update_allocs_from_client(6, [done])
    after = store.jobs[(job.namespace, job.id)]
    assert (after.status, after.modify_index) == ("dead", 6)


# ----------------------------------------------------------------- MVCC


def test_a_snapshot_keeps_its_allocs_through_a_client_update():
    store = PortStore()
    job = port_mock.job()
    store.upsert_job(1, job)
    node = port_mock.node()
    store.upsert_node(2, node)
    allocs = []
    for i in range(4):
        a = port_mock.alloc_for(job, node, index=i)
        a.client_status = "running"
        a.task_states = {"web": port_structs.TaskState(state="running")}
        a.deployment_status = port_structs.AllocDeploymentStatus(
            healthy=None, timestamp_unix=1.0)
        a.desired_transition = port_structs.DesiredTransition(
            migrate=i % 2 == 0)
        a.reschedule_tracker = port_structs.RescheduleTracker(
            events=[port_structs.RescheduleEvent(prev_alloc_id=f"p{i}")])
        allocs.append(a)
    store.upsert_allocs(3, allocs)
    snap = store.snapshot()
    held = {a.id: snap.alloc_by_id(a.id) for a in allocs}
    before = {aid: (a.client_status, dict(a.task_states),
                    dataclasses.replace(a.deployment_status),
                    dataclasses.replace(a.desired_transition),
                    a.deployment_status, a.desired_transition)
              for aid, a in held.items()}
    ups = []
    for a in allocs:
        u = port_structs.Allocation(id=a.id, client_status="complete",
                                    modify_time_unix=9.0)
        u.task_states = {"web": port_structs.TaskState(state="dead")}
        u.deployment_status = port_structs.AllocDeploymentStatus(
            healthy=True, timestamp_unix=9.0)
        ups.append(u)
    store.update_allocs_from_client(4, ups)
    for aid, (status, states, ds, dt, ds_obj, dt_obj) in before.items():
        old = snap.alloc_by_id(aid)
        assert old is held[aid]
        assert (old.client_status, old.task_states) == (status, states)
        assert old.deployment_status is ds_obj and old.deployment_status == ds
        assert old.desired_transition is dt_obj and \
            old.desired_transition == dt
        new = store.alloc_by_id(aid)
        assert new is not old and new.client_status == "complete"
        assert new.task_states["web"].state == "dead"
        assert new.deployment_status.healthy is True
        assert new.desired_transition == dt
        assert new.reschedule_tracker == old.reschedule_tracker
        assert new.modify_index == 4
    # the next snapshot reads the update
    assert store.snapshot().alloc_by_id(allocs[0].id).client_status == \
        "complete"


# --------------------------------------------------------------- server


class _CountingLock:
    """Counts every acquisition of the store's lock, re-entry included."""

    def __init__(self, lock):
        self.inner = lock
        self.n = 0

    def acquire(self, blocking=True, timeout=-1):
        self.n += 1
        return self.inner.acquire(blocking, timeout)

    def release(self):
        self.inner.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.inner.release()


def _evals_per_alloc(state, allocs):
    """The follow-up evals as the loop that read the store once an
    alloc made them: (namespace, priority, type, trigger, job, status)."""
    out, seen = [], set()
    for alloc in allocs:
        stored = state.alloc_by_id(alloc.id)
        if stored is None or stored.job is None:
            continue
        key = (stored.namespace, stored.job_id)
        if key in seen:
            continue
        if alloc.client_status == "failed":
            trigger = "alloc-failure"
        elif alloc.client_status == "complete" and \
                stored.job.type in ("batch", "sysbatch"):
            trigger = "alloc-stop"
        else:
            continue
        seen.add(key)
        out.append((stored.namespace, stored.job.priority, stored.job.type,
                    trigger, stored.job_id, "pending"))
    return out


def _server_with_jobs(n_allocs: int):
    srv = Server(num_workers=0, gc_interval=9999)
    st = srv.state
    nodes = []
    for i in range(4):
        n = port_mock.node()
        st.upsert_node(1 + i, n)
        nodes.append(n)
    jobs = []
    for k, kind in enumerate(("batch", "service", "sysbatch", "batch")):
        job = port_mock.batch_job() if kind != "service" else port_mock.job()
        job.type = kind
        job.priority = 40 + k
        st.upsert_job(10 + k, job)
        jobs.append(job)
    allocs = []
    for i in range(n_allocs):
        job = jobs[i % len(jobs)]
        a = port_mock.alloc_for(job, nodes[i % len(nodes)], index=i)
        a.client_status = "running"
        allocs.append(a)
    st.upsert_allocs(20, allocs)
    return srv, allocs


def _update_and_count(n_allocs: int):
    """One mixed update of `n_allocs` allocs over four jobs (and an
    unknown id): the evals it made, the per-alloc loop's, and the
    acquisitions of the store's lock it took."""
    rng = random.Random(n_allocs)
    srv, allocs = _server_with_jobs(n_allocs)
    try:
        ups = []
        for a in allocs:
            u = a.copy()
            u.client_status = rng.choice(("running", "complete", "failed",
                                          "lost", "complete"))
            ups.append(u)
        unknown = port_mock.alloc()
        unknown.client_status = "failed"
        ups.insert(len(ups) // 2, unknown)
        lock = srv.state._lock
        counting = srv.state._lock = _CountingLock(lock)
        try:
            out = srv.node_update_allocs(ups)
        finally:
            srv.state._lock = lock
        made = [srv.state.eval_by_id(i) for i in out["eval_ids"]]
        return ([(e.namespace, e.priority, e.type, e.triggered_by, e.job_id,
                  e.status) for e in made],
                _evals_per_alloc(srv.state, ups), counting.n)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("n_allocs", [12, 120])
def test_node_update_allocs_makes_the_evals_of_the_per_alloc_loop(n_allocs):
    made, per_alloc, _ = _update_and_count(n_allocs)
    assert made and made == per_alloc


def test_node_update_allocs_takes_the_store_lock_a_fixed_number_of_times():
    """As many acquisitions for 120 allocs as for 12, over the same four
    jobs: none an alloc."""
    small, large = _update_and_count(12), _update_and_count(120)
    assert len(small[0]) == len(large[0])
    assert small[2] == large[2] < 12


def test_the_fsm_apply_span_counts_the_jobs_an_update_touched(monkeypatch):
    monkeypatch.setattr(trace.tracer, "_enabled", True)
    monkeypatch.setattr(trace.tracer, "_sample_rate", 1.0)
    srv, allocs = _server_with_jobs(10)
    try:
        ups = []
        for a in allocs[:6]:
            u = a.copy()
            u.client_status = "running"
            ups.append(u)
        srv.node_update_allocs(ups)
        rec = next(trace.get(t["trace_id"]) for t in trace.traces()
                   if t["name"] == "client.update_alloc")
        (apply,) = [s for s in rec["spans"] if s["name"] == "fsm.apply"]
        assert apply["attrs"]["type"] == "alloc_client_update"
        assert (apply["attrs"]["allocs"], apply["attrs"]["jobs"]) == (6, 4)
    finally:
        srv.shutdown()
