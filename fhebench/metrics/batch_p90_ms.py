"""The 90th percentile of the latency of every request of the window, from
the call to the returned logits."""

import numpy as np


def read(win):
    return float(np.percentile(win.latencies_s, 90)) * 1e3
