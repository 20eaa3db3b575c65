"""The device's idle share with the host in the compiled stages' own code:
idle gaps under ``toyfhe.forward``, a ``toyfhe.stage.*`` span, a replay's
``toyfhe.replay.*``, a ``toyfhe.capture`` or a graph's launch
(``cudaGraphLaunch``, called only in a replay), over the profiled requests'
host-clock span."""

from fhebench import spans


def read(win):
    return spans.idle_share(win, spans.STAGES)
