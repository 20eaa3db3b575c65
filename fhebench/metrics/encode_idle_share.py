"""The device's idle share with the host in the pipeline's encode: idle
gaps under a ``toyfhe.encode`` span or one below it (preprocess, slots, FFT,
quantize, upload), over the profiled requests' host-clock span."""

from fhebench import spans


def read(win):
    return spans.idle_share(win, spans.ENCODE)
