"""Process start to the window's start: imports, the kernel library's
build or load, the inputs made on the card, the driver's set-up and the
warm-up call."""


def read(run):
    return run.setup_s
