"""From the process's start to the window's: imports and CUDA start, the
data, its registration, and the warm-up (with any build it needs)."""


def read(run):
    return run.setup.get("setup_s")
