"""Encrypted images whose logits came back in the window, over the window's
seconds (first request sent to last answer back)."""


def read(win):
    return win.images_per_request * len(win.latencies_s) / win.seconds
