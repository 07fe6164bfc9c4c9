"""K2's greedy gather entry (the fused route): each row reads idx, valid
and feasible and writes two 32-bit results; each live row reads its two
twin rows; 35 float32 operations a row."""
KERNEL = "score_capacity_kernel"
OPS_ROW = 35


def cost(call: dict) -> tuple:
    n = call["n"]
    nbytes = n * (4 + 1 + 1 + 2 * 4) + call["live"] * 2 * 5 * 4 + 5 * 4
    return nbytes, n * OPS_ROW
