"""The DINO step's share of the card's bf16 peak: the operations of
student, teacher, head and loss for the window's images over its length."""


def read(t):
    return t.mfu(t.cell.cfg["peak"])
