"""The host encode of a request's 49 input slot vectors
(``run.encode`` → ``core/ckks_encoding.py``), from the pipeline's stage
clock."""


def read(win):
    return win.mean_stage_ms(lambda k: k == "encode")
