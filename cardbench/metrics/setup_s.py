"""setup_s: from the start of the process to the start of the window:
imports, the pool, every plan's first solve and capture, the warm-up calls
(and, in a checkout's first run, the kernels' nvcc builds)."""


def read(run):
    return run.setup_s
