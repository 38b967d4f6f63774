"""The program under test, driven only through its public entry points:
``tpurt_torch.render.driver.load_scene`` and ``build_job`` in set-up,
``tpurt_torch.rpf.driver.render_rpf_job`` (entry "rpf") or
``tpurt_torch.render.driver.render_job`` (entry "render": any other
integrator) for a frame.  A configuration names its entry; tpurt_torch
is imported at the first call, never when this module is imported."""

from __future__ import annotations


def build(scene_path: str, device: str):
    """Parse the scene text and build and upload the job on ``device``."""
    from tpurt_torch.render.driver import build_job, load_scene

    return build_job(load_scene(scene_path), device)


def frame_fn(config: dict, job):
    """A callable rendering one whole frame of ``job``: returns (the
    (H, W, 3) float32 image on the host, the entry's extras)."""
    entry = config["entry"]
    if entry == "rpf":
        from tpurt_torch.rpf.driver import render_rpf_job

        boxes = tuple(config["rpf"]["box_sizes"])
        exrs = config["rpf"]["write_feature_exrs"]
        return lambda: render_rpf_job(job, box_sizes=boxes,
                                      write_feature_exrs=exrs)
    if entry == "render":
        from tpurt_torch.render.driver import render_job

        return lambda: (render_job(job), {})
    raise ValueError(f"entry {entry!r}: not rpf or render")
