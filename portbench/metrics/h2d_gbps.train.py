"""The training step's upload rate: the bytes the program counts on its
`sais.train.upload` spans (`h2d_bytes`) over the device time of the
window's host-to-device copies."""

from portbench import program_spans


def read(t):
    nbytes = program_spans.counted(program_spans.session(t),
                                   "sais.train.upload", "h2d_bytes")
    copies = t.device_time(
        lambda o: o["cat"] == "gpu_memcpy" and "HtoD" in o["name"])
    return program_spans.rate_gbps(nbytes, copies)
