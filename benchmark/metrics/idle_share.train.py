"""1 - (union of the device's activity) / (the traced slice's wall
time), from the trace's own timeline, in %."""


def read(r):
    if r.kind != "train" or not r.busy_s:
        return None
    return (1 - r.busy_s / r.window_s) * 100
