"""setup_s: seconds from the process's start to the window's (imports, the
card, the weights, the warm-up steps or round, and a first build)."""


def read(run):
    return run.setup_s
