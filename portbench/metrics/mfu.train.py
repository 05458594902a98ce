"""The training step's share of the card's float32-accurate peak (three
TF32 products a float32 product): the temporal model's operations over
valid tokens and pairs, over the window's length."""


def read(t):
    return t.mfu(t.cell.cfg["peaks"]["train"])
