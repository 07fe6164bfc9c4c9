"""Each kernel's bytes and operations, against chip_smoke.py's bound
arithmetic at the main path's shapes."""
import sys

import pytest
import torch

from portbench.lib import peaks, spec

sys.path.insert(0, str(spec.ROOT))
import chip_smoke as cs  # noqa: E402

ROOFS = spec.rooflines()
N, LIVE = cs.N_BUCKET, cs.N_LIVE


def test_peaks_and_bound_match_chip_smoke():
    assert peaks.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert peaks.F32_OPS_PER_S == cs.F32_OPS_PER_S
    for nbytes, ops in ((1_000_000, 10), (10, 10 ** 9)):
        want = cs._bound(nbytes, ops)
        assert peaks.bound_s(nbytes, ops) * 1e3 == pytest.approx(
            want["bound_ms"])
        assert peaks.bound_by(nbytes, ops) == want["bound_by"]


def test_k1_plain_entry_bytes():
    nbytes, ops = ROOFS["depth_curve"].cost({"n": N, "lanes": 1})
    assert nbytes == N * (2 * 5 * 4 + 1 + 4 + 4 + 3 * 4) + 5 * 4
    assert ops == N * cs.DEPTH_OPS_NODE


def test_gather_entries_bytes():
    call = {"n": N, "lanes": 1, "live": LIVE}
    assert ROOFS["depth_curve_gather"].cost(call)[0] == \
        cs._fused_gather_bytes(1 + 4 + 4 + 3 * 4)
    assert ROOFS["score_capacity_gather"].cost(call)[0] == \
        cs._fused_gather_bytes(1 + 2 * 4)
    assert ROOFS["fit_verdict"].cost(call) == (
        cs._fused_gather_bytes(4 + 4 + 1), N * cs.FIT_OPS_ROW)


def test_k2_plain_entry():
    assert ROOFS["score_capacity"].cost({"n": N, "lanes": 1}) == (
        N * (2 * 5 * 4 + 1 + 4 + 4) + 5 * 4, N * cs.SCORE_OPS_NODE)


@pytest.mark.parametrize("placed_init", [False, True])
def test_scan_matches_scan_bound(placed_init):
    n, n_s, n_p, n_d, n_dp = 1024, 2, 128, 1, 128
    feasible = torch.zeros(n, dtype=torch.bool)
    feasible[:700] = True
    args = [torch.zeros(n, 5)] + [None] * 3 + [feasible] + [None] * 3 + \
        [torch.zeros(n_s, n_p)] + [None] * 5 + [torch.zeros(n_d, n_dp)]
    want = cs._scan_bound(args, steps=40, selected=90,
                          placed_init=placed_init)
    got = ROOFS["chunked_scan"].cost({
        "n": n, "feasible": 700, "selected": 90, "steps": 40, "n_s": n_s,
        "n_p": n_p, "n_d": n_d, "n_dp": n_dp, "placed_init": placed_init})
    assert got == (want["bytes"], want["ops"])
