"""K4, K5 and K6 together against their roofline: the least time of their
calls over the device time of the kernels they launched."""


def read(t):
    return t.roofline(["k4", "k5", "k6"])
