"""Set-up: from the process's start to the window's: imports, the drawn
weights, the offline build, the kernels' build where it is missing, the
server's start and the warm-up traffic."""


def read(run):
    return run.setup_s
