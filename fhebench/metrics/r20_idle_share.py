"""The device's idle share over the profiled ResNet requests: the same
reading as ``idle_share``."""

from fhebench.metrics import idle_share


def read(win):
    return idle_share.read(win)
