"""K1's share of its bandwidth roofline: the limb polynomials the program's
counter says K1 transformed in the profiled requests, at the least bytes of
a transform (``work.ntt_bytes``) over the H100's 3.35 TB/s, against the
device time of the K1 kernels in the trace of the same requests."""

from fhebench import work


def read(win):
    device_s = sum(c["k1_device_s"] for c in win.chunks)
    transforms = sum(c["k1_transforms"] for c in win.chunks)
    if device_s <= 0 or transforms <= 0:
        return None
    n = 1 << win.config["model"]["ring_logn"]
    return 100.0 * work.seconds_at_hbm(transforms * work.ntt_bytes(n, 1)) / device_s
