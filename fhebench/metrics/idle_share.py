"""The device's idle share over the profiled requests: one minus the union
of the kernels' intervals over the requests' host-clock span."""


def read(win):
    wall = sum(c["wall_s"] for c in win.chunks)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(c["busy_s"] for c in win.chunks) / wall)
