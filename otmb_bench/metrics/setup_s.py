"""setup_s: seconds from the process's start to the first timed request:
the case, the program's set-up path, the kernels' build or load, and one
warm request."""


def read(run):
    return run.setup_s
