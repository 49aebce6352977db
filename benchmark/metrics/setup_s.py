"""setup_s: from the start of the run's process to the start of the
window: imports, scene load, the kernels' libraries (built at the first
run in a checkout), warm-up frames.  Host clock."""


def read(run):
    return run.setup_s
