"""Model FLOPs of a training step (forward, input and weight grads of
both networks over every pass; ``costs.model_flops``) over the traced
step time and the card's bf16 peak, in % of one card."""

from benchmark import costs


def read(r):
    if r.kind != "train" or not r.busy_s:
        return None
    step_s = r.window_s / r.steps
    return costs.model_flops(r.shapes) / step_s / costs.PEAK_BF16 * 100
