"""The whole request's share of the card's peak: the least time any
implementation needs for one request — the bytes it must move at least
once (``work.floor_bytes``) at 3.35 TB/s; no compute floor, since the
int64 modular products have no published peak — over the measured time a
profiled request took."""

from fhebench import work


def read(win):
    requests = sum(c["requests"] for c in win.chunks)
    wall = sum(c["wall_s"] for c in win.chunks)
    if requests <= 0 or wall <= 0:
        return None
    floor_s = work.seconds_at_hbm(work.floor_bytes(win.config, win.encoded_inputs))
    return 100.0 * floor_s * requests / wall
