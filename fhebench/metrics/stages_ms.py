"""The replayed device stages, encryption to the logits ciphertext: every
stage of the pipeline's clock but the encode and the decrypt (in the server
mix, the harness's synced span around ``forward``)."""


def read(win):
    return win.mean_stage_ms(lambda k: k not in ("encode", "decrypt"))
