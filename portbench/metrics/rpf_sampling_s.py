"""rpf_sampling_s: the RPF sampling pass's seconds (``render_rpf_job``'s
``sampling_time``: host clock around the pass, synchronised), averaged
over the traced run's window."""


def read(run):
    vals = [e["sampling_time"] for e in run.extras if "sampling_time" in e]
    return sum(vals) / len(vals) if vals else None
