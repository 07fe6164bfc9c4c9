"""solve layer: nomad.solver.solve_cpu, the solving thread's CPU seconds
over the blocks nomad.solver.solve times, their sum in the window over
the evals processed in it (ms); the rest of solve_ms is time off the CPU
(the interpreter lock, a lock, the card). Nothing where the timer
recorded nothing in the window."""

TIMER = "nomad.solver.solve_cpu"


def read(w):
    return w.per_eval_ms(TIMER)
