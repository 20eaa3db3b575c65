"""The CKKS refresh of the bootstrapped pipeline: ModRaise + CoeffToSlot,
EvalMod and SlotToCoeff, from the pipeline's stage clock."""


REFRESH = ("modraise_c2s", "evalmod", "s2c")


def read(win):
    return win.mean_stage_ms(lambda k: k in REFRESH)
