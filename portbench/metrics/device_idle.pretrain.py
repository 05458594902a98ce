"""Share of the traced window in which no kernel or copy ran on the card
(rank 0 on several cards)."""


def read(t):
    return t.idle_share()
