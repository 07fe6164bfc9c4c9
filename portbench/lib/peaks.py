"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's 700 W limit), and the least time a call could take
on them: each byte moved once at HBM3's rate, each float32 operation at
the CUDA cores' rate, whichever is longer."""
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def bound_by(nbytes: float, ops: float) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S \
        else "operations"
