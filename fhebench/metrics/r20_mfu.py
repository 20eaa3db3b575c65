"""A ResNet request's share of the card's peak: the byte floor of one
request (``floors/resnet20_boot.py``) at 3.35 TB/s over the measured time a
profiled request took; the same reading as ``mfu``."""

from fhebench.metrics import mfu


def read(win):
    return mfu.read(win)
