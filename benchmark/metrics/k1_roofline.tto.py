"""K1's least time for one step's launches at the step's shapes
(``costs.k1_step``) over K1's device time per step in the trace, in %."""

from benchmark import costs


def read(r):
    t = r.kernel_time(costs.KERNELS["K1"])
    if r.kind != "tto" or not t:
        return None
    return costs.bound_ms(costs.k1_step(r.shapes))[0] / (t * 1e3) * 100
