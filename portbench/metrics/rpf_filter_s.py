"""rpf_filter_s: the RPF filter's seconds (``render_rpf_job``'s
``filter_time``: host clock around every box size's pass, synchronised),
averaged over the traced run's window."""


def read(run):
    vals = [e["filter_time"] for e in run.extras if "filter_time" in e]
    return sum(vals) / len(vals) if vals else None
