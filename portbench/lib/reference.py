"""The plain reference: what the committed store must hold, worked out
again from the fleet and the job records, in NumPy.

It imports nothing of the program and takes nothing the program made but
the output it judges: each allocation's job, instance index, node, the
raft indexes at which it was committed and ended, and the evals that the
clients waited on. Capacities come from the fleet table, asks and
datacenters from the job records.

Each number is a count (or, for the spread, a width), read beside its
limit; `correct` holds where every number is within its limit.

    over_capacity  (node, commit index) pairs at which the allocations
                   live on the node ask more cpu, memory or disk than the
                   node has less its reserve; every commit replayed in
                   index order, allocations ending before those that
                   start at the same index
    unplaced       instances that a completed register eval was asked
                   for and did not commit
    duplicates     instances committed twice with overlapping lives
    ineligible     allocations on an unknown node or one outside the
                   job's datacenters
    not_stopped    allocations still live of a job whose deregister eval
                   completed
    never_done     evals a client waited on that reached no terminal
                   status by the deadline (an eval that failed, say after
                   its plan's last attempt, answered: it counts as failed,
                   and what it committed is judged as the rest is)
    bad_victims    evicted allocations whose preemptor is unknown or of a
                   job whose priority is not above the victim's
    rack_skew      the widest gap, over the evals of jobs spread over
                   ${meta.rack}, between the most and the fewest
                   instances that the eval put in one rack, of the racks
                   that hold a node in the job's datacenters

A limit with no reader here is read by checks/<limit>.py, found by its
name (spec.check_reader): read(run), given the harness's Run once the
window has closed (its fleet, jobs, evals, committed allocs, proposed
plans, configuration and mix).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import spec

LIVE = np.iinfo(np.int64).max          # the end index of a live allocation
TOL = 1e-6


@dataclass
class Allocs:
    """The committed allocations as plain arrays (one entry each)."""
    ids: list = field(default_factory=list)
    job: list = field(default_factory=list)        # job id
    name: np.ndarray = None                        # instance index
    row: np.ndarray = None                         # fleet row, -1 unknown
    create: np.ndarray = None                      # commit index
    end: np.ndarray = None                         # end index or LIVE
    evicted: np.ndarray = None                     # bool
    eval_id: list = field(default_factory=list)
    preempted_by: list = field(default_factory=list)   # alloc id or ""

    def __len__(self) -> int:
        return len(self.ids)


def _asks(allocs: Allocs, jobs: dict) -> np.ndarray:
    table = {j: (r["cpu_mhz"], r["memory_mb"], r["disk_mb"])
             for j, r in jobs.items()}
    return np.asarray([table[j] for j in allocs.job],
                      np.float64).reshape(-1, 3)


def over_capacity(capacity: np.ndarray, allocs: Allocs,
                  jobs: dict) -> int:
    known = allocs.row >= 0
    ask = _asks(allocs, jobs)[known]
    row, create, end = allocs.row[known], allocs.create[known], \
        allocs.end[known]
    ended = end != LIVE
    rows = np.concatenate([row, row[ended]])
    idx = np.concatenate([create, end[ended]])
    sign = np.concatenate([np.ones(len(row)), -np.ones(int(ended.sum()))])
    delta = np.concatenate([ask, ask[ended]]) * sign[:, None]
    if not len(rows):
        return 0
    order = np.lexsort((sign, idx, rows))        # row, index, ends first
    rows, idx, delta = rows[order], idx[order], delta[order]
    total = np.cumsum(delta, axis=0)
    first = np.r_[True, rows[1:] != rows[:-1]]
    group = np.cumsum(first) - 1
    usage = total - (total - delta)[first][group]
    over = (usage > capacity[rows] + TOL).any(axis=1)
    if not over.any():
        return 0
    return len({(int(r), int(i)) for r, i in zip(rows[over], idx[over])})


def unplaced(allocs: Allocs, jobs: dict, evals: list) -> int:
    by_eval: dict = {}
    for e, j, n in zip(allocs.eval_id, allocs.job, allocs.name):
        by_eval.setdefault((e, j), set()).add(int(n))
    missing = 0
    for ev in evals:
        if ev["kind"] != "register" or ev["status"] != "complete":
            continue
        want = jobs[ev["job_id"]]["count"]
        got = by_eval.get((ev["eval_id"], ev["job_id"]), set())
        missing += want - len(got & set(range(want)))
    return missing


def duplicates(allocs: Allocs) -> int:
    if not len(allocs):
        return 0
    jobs = {j: i for i, j in enumerate(sorted(set(allocs.job)))}
    key = np.asarray([jobs[j] for j in allocs.job], np.int64) * (1 << 32) \
        + allocs.name
    order = np.lexsort((allocs.create, key))
    k, c, e = key[order], allocs.create[order], allocs.end[order]
    top = int(c.max()) + 1
    e = np.where(e == LIVE, top, e)
    # each group of copies of one instance on a range of its own, so a
    # running maximum of the ends never reaches into the next group
    group = np.cumsum(np.r_[True, k[1:] != k[:-1]])
    off = group * (top + 2)
    ran = np.maximum.accumulate(e + off)
    same = np.r_[False, k[1:] == k[:-1]]
    prev = np.r_[-1, ran[:-1]]
    return int((same & (c + off < prev)).sum())


def ineligible(fleet_dc: list, allocs: Allocs, jobs: dict) -> int:
    allowed = {j: set(r["datacenters"]) for j, r in jobs.items()}
    bad = 0
    for j, r in zip(allocs.job, allocs.row.tolist()):
        if r < 0 or fleet_dc[r] not in allowed[j]:
            bad += 1
    return bad


def not_stopped(allocs: Allocs, evals: list) -> int:
    stopped = {ev["job_id"] for ev in evals
               if ev["kind"] == "deregister" and ev["status"] == "complete"}
    if not stopped:
        return 0
    live = allocs.end == LIVE
    return sum(1 for j, lv in zip(allocs.job, live.tolist())
               if lv and j in stopped)


TERMINAL = ("complete", "failed", "cancelled")


def never_done(evals: list) -> int:
    return sum(1 for ev in evals if ev["status"] not in TERMINAL)


def bad_victims(allocs: Allocs, jobs: dict) -> int:
    """The preemptor is named by the victim's preempted_by_allocation:
    an allocation id, or (as the port's schedulers write it) the id of
    the eval whose plan evicted it."""
    job_of = dict(zip(allocs.ids, allocs.job))
    job_of.update(zip(allocs.eval_id, allocs.job))
    bad = 0
    for victim, by, ev in zip(allocs.job, allocs.preempted_by,
                              allocs.evicted.tolist()):
        if not ev:
            continue
        winner = job_of.get(by)
        if winner is None or \
                jobs[victim]["priority"] >= jobs[winner]["priority"]:
            bad += 1
    return bad


def rack_skew(fleet_rack: list, fleet_dc: list, allocs: Allocs,
              jobs: dict, evals: list) -> int:
    spread = {ev["eval_id"]: ev["job_id"] for ev in evals
              if ev["kind"] == "register" and ev["status"] == "complete"
              and (jobs[ev["job_id"]].get("spread") or {}).get(
                  "attribute") == "${meta.rack}"}
    if not spread:
        return 0
    counts: dict = {}
    for e, job in spread.items():
        dcs = set(jobs[job]["datacenters"])
        counts[e] = {r: 0 for r, d in zip(fleet_rack, fleet_dc)
                     if r and d in dcs}
    for e, r in zip(allocs.eval_id, allocs.row.tolist()):
        if e in counts and r >= 0 and fleet_rack[r] in counts[e]:
            counts[e][fleet_rack[r]] += 1
    return max((max(c.values()) - min(c.values()) for c in counts.values()
                if c), default=0)


def judge(fleet, allocs: Allocs, jobs: dict, evals: list,
          limits: dict, run=None, bench_dir=spec.BENCH_DIR) -> dict:
    """{number: {"value": v, "limit": l}} for every number `limits`
    names (a cell's configuration and mix decide which apply); a number
    with no reader here is checks/<name>.py's read(run)."""
    cap = fleet.capacity()
    readers = {
        "over_capacity": lambda: over_capacity(cap, allocs, jobs),
        "unplaced": lambda: unplaced(allocs, jobs, evals),
        "duplicates": lambda: duplicates(allocs),
        "ineligible": lambda: ineligible(fleet.dc, allocs, jobs),
        "not_stopped": lambda: not_stopped(allocs, evals),
        "never_done": lambda: never_done(evals),
        "bad_victims": lambda: bad_victims(allocs, jobs),
        "rack_skew": lambda: rack_skew(fleet.rack, fleet.dc, allocs, jobs,
                                       evals),
    }
    found = {k: spec.check_reader(k, bench_dir) for k in limits
             if k not in readers}
    return {k: {"value": readers[k]() if k in readers
                else found[k].read(run), "limit": lim}
            for k, lim in limits.items()}


def correct(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
