"""proof_s: the window's seconds over its completed proof tasks (host
clock, each task ending in a synchronize; the benchmark's own work, such
as making the next task's inputs and copying the checked samples, left
out)."""


def read(r):
    return r.window_s / r.tasks if r.tasks else None
