"""The reference's checks on a tiny fleet, each shown to find the fault
it is for, and to pass a sound history."""
import numpy as np

from portbench.lib import fleet, reference
from portbench.lib.reference import LIVE

SPEC = {"nodes": 4, "cpu_mhz_choices": [1100], "memory_mb_choices": [2100],
        "disk_mb": 1100, "reserved": {"cpu_mhz": 100, "memory_mb": 100,
                                      "disk_mb": 100},
        "datacenters": ["dc1", "dc2"], "racks": 4, "node_classes": 1}
FLEET = fleet.make(SPEC, 1)                 # each node: 1000 / 2000 / 1000
JOBS = {"a": {"count": 3, "cpu_mhz": 500, "memory_mb": 100, "disk_mb": 10,
              "priority": 50, "datacenters": ["dc1", "dc2"]},
        "b": {"count": 2, "cpu_mhz": 400, "memory_mb": 100, "disk_mb": 10,
              "priority": 70, "datacenters": ["dc1"],
              "spread": {"attribute": "${meta.rack}", "weight": 100}}}


def allocs(rows):
    """rows: (id, job, name, row, create, end, eval, evicted_by)"""
    a = reference.Allocs()
    a.ids = [r[0] for r in rows]
    a.job = [r[1] for r in rows]
    a.name = np.array([r[2] for r in rows], np.int64)
    a.row = np.array([r[3] for r in rows], np.int64)
    a.create = np.array([r[4] for r in rows], np.int64)
    a.end = np.array([r[5] for r in rows], np.int64)
    a.eval_id = [r[6] for r in rows]
    a.preempted_by = [r[7] for r in rows]
    a.evicted = np.array([bool(r[7]) for r in rows])
    return a


SOUND = [("a0", "a", 0, 0, 10, 20, "ea", ""), ("a1", "a", 1, 0, 10, LIVE,
                                                 "ea", ""),
         ("a2", "a", 2, 1, 10, LIVE, "ea", ""),
         # at index 20 a0 ends and b0 starts on node 0: 500 + 400 fits
         ("b0", "b", 0, 0, 20, LIVE, "eb", ""),
         ("b1", "b", 1, 2, 20, LIVE, "eb", "")]
EVALS = [{"eval_id": "ea", "job_id": "a", "kind": "register",
          "status": "complete"},
         {"eval_id": "eb", "job_id": "b", "kind": "register",
          "status": "complete"}]
LIMITS = {k: 0 for k in ("over_capacity", "unplaced", "duplicates",
                         "ineligible", "not_stopped", "never_done",
                         "bad_victims", "rack_skew")}


def judge(rows, evals=EVALS):
    return {k: v["value"] for k, v in reference.judge(
        FLEET, allocs(rows), JOBS, evals, LIMITS).items()}


def test_a_sound_history_passes():
    nums = reference.judge(FLEET, allocs(SOUND), JOBS, EVALS, LIMITS)
    assert reference.correct(nums), nums


def test_capacity_is_held_at_every_commit():
    # b0 committed one index before a0 ended: 1,400 MHz on a 1,000 node
    rows = [r if r[0] != "b0" else ("b0", "b", 0, 0, 19, LIVE, "eb", "")
            for r in SOUND]
    assert judge(rows)["over_capacity"] == 1
    # a third instance of a on node 1, which holds a2: 1,000 fits exactly
    rows = SOUND + [("a9", "a", 9, 1, 11, LIVE, "ex", "")]
    assert judge(rows)["over_capacity"] == 0
    rows = SOUND + [("a9", "a", 9, 1, 11, LIVE, "ex", ""),
                    ("a8", "a", 8, 1, 12, LIVE, "ex", "")]
    assert judge(rows)["over_capacity"] == 1


def test_unplaced_duplicates_ineligible():
    assert judge([r for r in SOUND if r[0] != "a2"])["unplaced"] == 1
    dup = SOUND + [("a1x", "a", 1, 3, 15, LIVE, "ea", "")]
    assert judge(dup)["duplicates"] == 1
    # a copy that starts after the first ended is a replacement
    rep = SOUND + [("a0x", "a", 0, 3, 20, LIVE, "ea", "")]
    assert judge(rep)["duplicates"] == 0
    # b on node 1, in dc2, which b does not name
    bad = [r if r[0] != "b1" else ("b1", "b", 1, 1, 20, LIVE, "eb", "")
           for r in SOUND]
    assert judge(bad)["ineligible"] == 1


def test_stops_victims_and_waits():
    stop = EVALS + [{"eval_id": "sa", "job_id": "a", "kind": "deregister",
                     "status": "complete"}]
    assert judge(SOUND, stop)["not_stopped"] == 2
    pending = EVALS + [{"eval_id": "x", "job_id": "a", "kind": "register",
                        "status": "pending"}]
    assert judge(SOUND, pending)["never_done"] == 1
    failed = EVALS + [{"eval_id": "x", "job_id": "a", "kind": "register",
                       "status": "failed"}]
    assert judge(SOUND, failed)["never_done"] == 0
    # a0 evicted by b's eval (priority 70 over 50): sound; the reverse not
    ok = [r if r[0] != "a0" else ("a0", "a", 0, 0, 10, 20, "ea", "eb")
          for r in SOUND]
    assert judge(ok)["bad_victims"] == 0
    rev = [r if r[0] != "b1" else ("b1", "b", 1, 2, 20, 30, "eb", "ea")
           for r in SOUND]
    assert judge(rev)["bad_victims"] == 1


def test_rack_skew():
    # b's datacenter dc1 holds nodes 0 and 2, in racks r0 and r2: one
    # instance in each is even
    assert judge(SOUND)["rack_skew"] == 0
    skew = [r if r[0] != "b1" else ("b1", "b", 1, 0, 20, LIVE, "eb", "")
            for r in SOUND]
    assert judge(skew)["rack_skew"] == 2


def test_the_controls_rack_skew_at_the_spread_mix_size():
    """The spread mix's rack_skew limit (10) lies between its sound runs'
    readings on the card (2-3) and the control's: a first fit blind to
    the spread puts 15 instances on each of 40 nodes, 40 racks of 100."""
    import json
    from portbench.lib import control, spec
    cfg = json.loads((spec.BENCH_DIR / "configs/sched-service-5k.json")
                     .read_text())
    mix = spec.traffic("spread")
    f = fleet.make(cfg["fleet"], 12345)
    job = dict(mix["job"], count=mix["count"]["fixed"])
    rows = control.first_fit_blind(f.capacity(), (job["cpu_mhz"],
                                   job["memory_mb"], job["disk_mb"]), 600)
    a = allocs([(f"x{i}", "s", i, r, 1, LIVE, "e", "")
                for i, r in enumerate(rows.tolist())])
    ev = [{"eval_id": "e", "job_id": "s", "kind": "register",
           "status": "complete"}]
    skew = reference.rack_skew(f.rack, f.dc, a, {"s": job}, ev)
    assert skew == 15 > mix["limits"]["rack_skew"]
