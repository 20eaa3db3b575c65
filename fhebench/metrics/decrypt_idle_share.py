"""The device's idle share with the host in decrypt and decode: idle gaps
under a ``toyfhe.decrypt`` span or one below it (the raw decrypt, the
download, the C++ CRT, the FFT), over the profiled requests' host-clock
span."""

from fhebench import spans


def read(win):
    return spans.idle_share(win, spans.DECRYPT)
