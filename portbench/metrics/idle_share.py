"""idle_share (%): 1 - device busy / wall of one frame.  Busy is the union
of the device operations' intervals in a frame traced on the device
alone; wall is the median of the window's unprofiled frames (tracing
stretches the traced frame's own wall time)."""


def read(run):
    busy = run.device_profile()["busy_s"]
    if not busy:
        return None
    return 100.0 * (1.0 - busy / run.wall_s)
