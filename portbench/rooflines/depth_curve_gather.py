"""K1's gather entry (the fused route): each lane's rows read idx and
valid, feasible, collisions and affinity, and write d_star, k_star and
k_cap; each live row reads its two twin rows (5 float32 each); the ask
read once a lane (chip_smoke.py _fused_gather_bytes). Operations as the
plain entry's: 30 a row, the depths left out."""
KERNEL = "depth_curve_kernel"
OPS_ROW = 30


def cost(call: dict) -> tuple:
    n, lanes = call["n"], call["lanes"]
    nbytes = lanes * (n * (4 + 1 + 1 + 4 + 4 + 3 * 4) + 5 * 4) \
        + call["live"] * 2 * 5 * 4
    return nbytes, lanes * n * OPS_ROW
