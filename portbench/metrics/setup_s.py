"""setup_s: seconds from the process's start to the first timed request:
imports, the card's context, the kernels' library, weights and inputs drawn,
the program's capture and the warm-up requests."""


def read(run):
    return run.setup_s
