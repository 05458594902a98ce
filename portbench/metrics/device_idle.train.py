"""Share of the traced window in which no kernel or copy ran on the card."""


def read(t):
    return t.idle_share()
