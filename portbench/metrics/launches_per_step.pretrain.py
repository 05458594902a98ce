"""Device operations (kernels, copies, sets) a DINO step launches, counted
in the trace."""


def read(t):
    return t.launches() / t.steps
