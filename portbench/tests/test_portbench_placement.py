"""The reference of the solve layer on hand-sized fleets: the binpack
choices it makes, its draws from the eval's id, the pipelined chunks,
and the count of instances placed elsewhere."""
import random

import numpy as np
import pytest

from portbench.lib import fleet, placement, reference
from portbench.lib.reference import LIVE

F32 = np.float32
ASK = np.asarray([250, 512, 300], F32)


def _nodes(cpu_used):
    """Equal nodes (4,000 MHz, 8,192 MB, 10,000 MB), node i with
    cpu_used[i] MHz and twice as many MB of memory in use."""
    cap = np.tile(np.asarray([4000, 8192, 10000], F32), (len(cpu_used), 1))
    used = np.zeros_like(cap)
    used[:, 0] = cpu_used
    used[:, 1] = np.asarray(cpu_used, F32) * 2
    return cap, used


def test_the_greedy_solve_takes_the_fullest_node_first():
    cap, used = _nodes([0, 2000, 1000, 3750])
    feas = np.ones(4, bool)
    placed = placement.greedy(cap, used, ASK, 1, feas)
    assert placed.tolist() == [0, 0, 0, 1]
    placed = placement.greedy(cap, used, ASK, 3, feas)
    # the full node holds one; the next fullest takes the rest
    assert placed.tolist() == [0, 2, 0, 1]


def test_the_greedy_solve_never_passes_capacity_or_feasibility():
    cap, used = _nodes([0, 0, 3900, 0])
    feas = np.asarray([True, False, True, True])
    placed = placement.greedy(cap, used, ASK, 40, feas)
    assert placed[1] == 0 and placed[2] == 0
    assert placed.sum() == 32            # 16 a free node, two feasible


def test_the_deterministic_depth_solve_goes_by_density_first():
    cap, used = _nodes([0, 2000, 1000, 0, 0, 0, 0, 0])
    feas = np.ones(8, bool)
    coll = np.zeros(8, np.int64)
    d, k, kc = placement.depth_curve(cap, used, ASK, feas, coll, 40, 16,
                                     None)
    # the used nodes score best; the job's anti-affinity halves the
    # score of a second instance on a node, so their best depth is 1
    assert d[1] > d[2] > d[0] == d[3]
    assert k[1] == k[2] == 1 and k[0] == 16
    assert kc.tolist() == [16, 8, 12, 16, 16, 16, 16, 16]
    # m = 2 * 40 / 8 = 10 > 3: no jitter, full depth, best density first
    placed = placement.solve(cap, used, ASK, 40, feas, coll, 40, 1, True,
                             None)
    assert placed.tolist() == [16, 1, 1, 16, 6, 0, 0, 0]


def test_the_jittered_depth_solve_caps_each_node_and_follows_the_seed():
    n = 64
    cap, used = _nodes([0] * n)
    feas = np.ones(n, bool)
    coll = np.zeros(n, np.int64)
    # m = 2 * 20 / 64 < 3: E-S order, at most ceil(m) + 1 = 2 a node
    a = placement.solve(cap, used, ASK, 20, feas, coll, 20, 11, True, None)
    b = placement.solve(cap, used, ASK, 20, feas, coll, 20, 11, True, None)
    c = placement.solve(cap, used, ASK, 20, feas, coll, 20, 12, True, None)
    assert a.sum() == 20 and a.max() <= 2
    assert (a == b).all() and not (a == c).all()


def test_a_pipelined_solve_feeds_each_chunk_the_usage_before_it():
    cap, used = _nodes([0] * 8)
    feas = np.ones(8, bool)
    coll = np.zeros(8, np.int64)
    whole = placement.solve(cap, used, ASK, 100, feas, coll, 100, 3, True,
                            None)
    piped = placement.solve(cap, used, ASK, 100, feas, coll, 100, 3, True,
                            {"min_count": 64, "chunks": 4})
    assert whole.sum() == piped.sum() == 100
    assert (piped <= 16).all()


def test_the_streams_follow_the_schedulers_order_of_draws():
    perm, jseed = placement.streams("eval-1", 10)
    rng = random.Random("eval-1")
    rng.shuffle(list(range(10)))
    want = np.random.default_rng(rng.getrandbits(64)).permutation(10)
    assert (perm == want).all() and jseed == rng.getrandbits(64)
    assert sorted(perm.tolist()) == list(range(10))


@pytest.mark.parametrize("n,bucket", [(1, 8), (8, 8), (9, 16), (200, 256),
                                      (10000, 16384)])
def test_the_node_axis_pads_to_a_power_of_two(n, bucket):
    assert placement.node_bucket(n) == bucket


def test_misplaced_counts_instances_beyond_the_references():
    ref = np.asarray([2, 0, 1, 0])
    assert placement.misplaced(ref, ref) == 0
    assert placement.misplaced(np.asarray([0, 2, 1, 0]), ref) == 2
    assert placement.misplaced(np.asarray([1, 0, 1, 0]), ref) == 0
    # nodes 0 and 1 alike: trading their places is no misplacement
    alike = np.asarray([0, 0, 1, 2])
    assert placement.misplaced(np.asarray([0, 2, 1, 0]), ref, alike) == 0
    assert placement.misplaced(np.asarray([0, 2, 0, 1]), ref, alike) == 1


SPEC = {"nodes": 8, "cpu_mhz_choices": [4100], "memory_mb_choices": [8448],
        "disk_mb": 10100, "reserved": {"cpu_mhz": 100, "memory_mb": 256,
                                       "disk_mb": 100},
        "datacenters": ["dc1"], "racks": 0, "node_classes": 1}


def _judge(counts, earlier=()):
    fl = fleet.make(SPEC, 5)
    jobs = {"j": {"type": "batch", "count": 20, "cpu_mhz": 250,
                  "memory_mb": 512, "disk_mb": 300, "datacenters": ["dc1"]},
            "old": {"type": "batch", "count": 8, "cpu_mhz": 1000,
                    "memory_mb": 2048, "disk_mb": 300,
                    "datacenters": ["dc1"]}}
    a = reference.Allocs()
    rows = list(earlier)
    a.ids = [f"x{i}" for i in range(len(rows))]
    a.job = ["old"] * len(rows)
    a.name = np.arange(len(rows), dtype=np.int64)
    a.row = np.asarray(rows, np.int64)
    a.create = np.full(len(rows), 5, np.int64)
    a.end = np.full(len(rows), LIVE, np.int64)
    a.evicted = np.zeros(len(rows), bool)
    a.eval_id = ["e0"] * len(rows)
    a.preempted_by = [""] * len(rows)
    p = placement.Pass("e1", 7, "j")
    p.add([(fl.ids[r], k) for r, k in counts.items()])
    row_of = {nid: i for i, nid in enumerate(fl.ids)}
    return placement.judge(fl, a, jobs, [p], row_of, None, 0, 1)


def test_judge_works_the_pass_out_from_the_state_at_its_snapshot():
    # node 3 holds three of an older job's instances: binpack fills it
    earlier = [3, 3, 3]
    fl = fleet.make(SPEC, 5)
    cap = fl.capacity().astype(F32)
    used = np.zeros_like(cap)
    used[3] = [3000, 6144, 900]
    perm, jseed = placement.streams("e1", 8)
    want = placement.solve(cap[perm],
                           used[perm], ASK, 20, np.ones(8, bool),
                           np.zeros(8, np.int64), 20, jseed, True, None)
    counts = {int(perm[i]): int(k) for i, k in enumerate(want) if k}
    assert 3 in counts
    got = _judge(counts, earlier)
    assert got == {"misplaced": 0, "compared": 20, "passes": 1}
    moved = dict(counts)
    moved.pop(3)
    spare = next(r for r in range(8) if r not in counts)
    moved[spare] = counts[3]
    got = _judge(moved, earlier)
    assert got["misplaced"] == counts[3]


def test_judge_samples_passes_from_the_seed_with_the_largest_in():
    fl = fleet.make(SPEC, 5)
    jobs = {f"j{i}": {"type": "batch", "count": 1 + i, "cpu_mhz": 250,
                      "memory_mb": 512, "disk_mb": 300,
                      "datacenters": ["dc1"]} for i in range(6)}
    passes = []
    for i in range(6):
        p = placement.Pass(f"e{i}", 1, f"j{i}")
        p.add([(fl.ids[0], 1 + i)])
        passes.append(p)
    a = reference.Allocs()
    a.ids, a.job, a.eval_id, a.preempted_by = [], [], [], []
    for k in ("name", "row", "create", "end"):
        setattr(a, k, np.zeros(0, np.int64))
    a.evicted = np.zeros(0, bool)
    row_of = {nid: i for i, nid in enumerate(fl.ids)}
    got = placement.judge(fl, a, jobs, passes, row_of, None, 3, 9)
    assert got["passes"] == 3
    assert got["compared"] >= 6           # the pass of 6 is always in
