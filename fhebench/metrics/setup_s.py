"""Process start to the first timed request: imports, loading the built
kernels, keys drawn on the card, the pipeline's build, the pool of the mix
and the warm-up requests that capture every graph."""


def read(win):
    return win.setup_s
