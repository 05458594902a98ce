"""The whole extraction's share of the card's bf16 peak: the ViT's
operations for the frames of the traced window over its length."""


def read(t):
    return t.mfu(t.cell.cfg["peaks"]["extract"])
