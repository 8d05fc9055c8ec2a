"""K2's least time for one TTO step's launches with the trunk frozen
(recompute and dX, no dW work; ``costs.k2_step(need_dw=False)``) over
its device time per step in the trace, in %."""

from benchmark import costs


def read(r):
    t = r.kernel_time(costs.KERNELS["K2"])
    if r.kind != "tto" or not t:
        return None
    bound = costs.bound_ms(costs.k2_step(r.shapes, need_dw=False))[0]
    return bound / (t * 1e3) * 100
