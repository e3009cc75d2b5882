"""setup_s (s): the process's start to the window's start — imports,
the matrix made, the port's conversion and planning, the inputs drawn and
the warm-up (the kernels' build too, in a checkout's first run)."""


def read(rec):
    return rec.setup_s
