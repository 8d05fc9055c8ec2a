"""K4's least time for one vanilla training step's launches
(``costs.k4_step``) over its ``layer_bwd_rows_*`` and ``xtg_*`` device
time per step in the trace, in %."""

from benchmark import costs


def read(r):
    t = r.kernel_time(costs.KERNELS["K4"])
    if r.kind != "train" or r.shapes["model"] != "flexible" or not t:
        return None
    return costs.bound_ms(costs.k4_step(r.shapes))[0] / (t * 1e3) * 100
