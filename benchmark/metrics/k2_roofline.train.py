"""K2's least time for one training step's launches (recompute, dX and
dW; ``costs.k2_step``) over its row pass and ``xtg_*`` products' device
time per step in the trace, in %."""

from benchmark import costs


def read(r):
    t = r.kernel_time(costs.KERNELS["K2"])
    if r.kind != "train" or not t:
        return None
    return costs.bound_ms(costs.k2_step(r.shapes))[0] / (t * 1e3) * 100
