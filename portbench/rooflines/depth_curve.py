"""K1, csrc/depth_curve.cu, its plain entry: each lane's rows read cap
and used (5 float32 each), feasible, collisions and affinity, and write
d_star, k_star and k_cap; the ask read once a lane. Operations: 30 float32
a row (chip_smoke.py DEPTH_OPS_NODE); the 31 a depth evaluated that the
data decides are left out, so the bound is a lower one."""
KERNEL = "depth_curve_kernel"
OPS_ROW = 30


def cost(call: dict) -> tuple:
    n, lanes = call["n"], call["lanes"]
    nbytes = lanes * (n * (2 * 5 * 4 + 1 + 4 + 4 + 3 * 4) + 5 * 4)
    return nbytes, lanes * n * OPS_ROW
