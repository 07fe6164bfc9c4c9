"""K2, csrc/score_capacity.cu, its plain entry: each row reads cap and
used, feasible, and writes two 32-bit results; 35 float32 operations a
row (chip_smoke.py SCORE_OPS_NODE)."""
KERNEL = "score_capacity_kernel"
OPS_ROW = 35


def cost(call: dict) -> tuple:
    n = call["n"]
    return n * (2 * 5 * 4 + 1 + 4 + 4) + 5 * 4, n * OPS_ROW
