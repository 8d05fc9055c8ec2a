"""Mean host wait per step in ``next()`` on the port's PrefetchIterator
(a span in the benchmark's loop), in ms; the loader layer."""


def read(r):
    if r.kind != "train" or not r.steps:
        return None
    return r.loader_wait_s / r.steps * 1e3
