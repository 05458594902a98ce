"""Share of the traced window in which host-to-device copies ran on the
card (the frames' upload)."""


def read(t):
    copies = t.device_time(
        lambda o: o["cat"] == "gpu_memcpy" and "HtoD" in o["name"])
    return 100.0 * copies / t.window_s
