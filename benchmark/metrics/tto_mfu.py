"""Model FLOPs of a TTO step (forward and input grads, no weight grads:
the models are frozen) over the traced step time and the card's bf16
peak, in %."""

from benchmark import costs


def read(r):
    if r.kind != "tto" or not r.busy_s:
        return None
    step_s = r.window_s / r.steps
    return (costs.model_flops(r.shapes, weight_grads=False) / step_s
            / costs.PEAK_BF16 * 100)
