"""csrc/fit_verdict.cu: each lane's rows read idx, valid and placed and
write placed and the verdict; each live row reads its two twin rows; 20
float32 operations a row (chip_smoke.py FIT_OPS_ROW)."""
KERNEL = "fit_verdict_kernel"
OPS_ROW = 5 * 4


def cost(call: dict) -> tuple:
    n, lanes = call["n"], call["lanes"]
    nbytes = lanes * (n * (4 + 1 + 4 + 4 + 1) + 5 * 4) \
        + call["live"] * 2 * 5 * 4
    return nbytes, lanes * n * OPS_ROW
