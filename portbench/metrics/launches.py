"""launches: device operations (kernels, copies, sets) of one frame, from
the profiler's raw records of a frame traced on the device alone."""


def read(run):
    n = run.device_profile()["launches"]
    return n or None
