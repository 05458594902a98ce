"""The gradient all-reduce's rate on rank 0: the bytes of the flat buffer
the program counts on its `sais.parallel.allreduce` spans over the device
time of the window's NCCL kernels (which include waits for the peers)."""

from portbench import program_spans


def read(t):
    nbytes = program_spans.counted(program_spans.session(t),
                                   "sais.parallel.allreduce", "bytes")
    nccl = t.device_time(
        lambda o: o["cat"] == "kernel" and o["name"].startswith("nccl"))
    return program_spans.rate_gbps(nbytes, nccl)
