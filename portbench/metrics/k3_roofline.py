"""K3's share of its roofline: 10 Dh flops a (valid query, valid key) pair
at the float32-accurate rate, or its bytes at the memory rate, over its
device time."""


def read(t):
    return t.roofline("k3")
