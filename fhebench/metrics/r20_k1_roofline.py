"""K1's share of its bandwidth roofline in the profiled ResNet requests: the
same reading as ``k1_roofline``."""

from fhebench.metrics import k1_roofline


def read(win):
    return k1_roofline.read(win)
