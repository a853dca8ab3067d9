"""prove_s: seconds a task spends in the benchmark's "prove" spans (host
clock, each span ending in a synchronize), over the window's tasks, less
the benchmark's own work inside them."""


def read(r):
    secs = r.tracer.seconds("prove")
    return secs / r.tasks if r.tasks and secs else None
