"""setup_s: seconds from the process's start to the window's: imports,
loading the kernels, the SRS, keygen and the warm-up task (host clock)."""


def read(r):
    return r.setup_s
