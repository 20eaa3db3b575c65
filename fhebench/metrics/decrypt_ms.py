"""Decrypt and decode of the logits ciphertext (``rlwe.decrypt`` and the C++
CRT), from the pipeline's stage clock or the harness's synced span."""


def read(win):
    return win.mean_stage_ms(lambda k: k == "decrypt")
