"""csrc/chunked_scan.cu, the whole scan in one launch (chip_smoke.py
_scan_bound). Bytes: every row reads its usage and feasible byte (and
placed_init where given) and writes its usage and placements; a feasible
row also reads cap, collisions, affinity, spread and distinct ids; the
[S, P] and [D, P] tables are read and written once, the targets read
once. Operations: each feasible row's full score once, then each step
the part that reads the running tables for every feasible row, and the
full score again for each selected row; `steps` is what the kernel ran."""
KERNEL = "chunked_scan_kernel"
STEP_OPS_NODE, STEP_OPS_STANZA, SCAN_OPS_STEP = 38, 8, 6


def cost(call: dict) -> tuple:
    n, n_feas = call["n"], call["feasible"]
    n_s, n_p, n_d, n_dp = call["n_s"], call["n_p"], call["n_d"], \
        call["n_dp"]
    nbytes = (n * (5 * 4 * 2 + 1 + 4 + (4 if call["placed_init"] else 0))
              + n_feas * (5 * 4 + 4 + 4 + 4 * n_s + 4 * n_d)
              + 2 * (n_s * n_p * 4 + n_d * n_dp * 4) + n_s * n_p * 4
              + 5 * 4 + n_s * 8)
    full = STEP_OPS_NODE + STEP_OPS_STANZA * n_s + 2 * n_d
    ops = (n_feas + call["selected"]) * full + call["steps"] * n_feas * (
        SCAN_OPS_STEP + STEP_OPS_STANZA * n_s + 2 * n_d)
    return nbytes, ops
