"""K1's share of its roofline: the least time its calls need (operations at
the bf16 peak or bytes at the memory rate) over the device time of the
kernels they launched."""


def read(t):
    return t.roofline("k1")
