"""scene_build_s: host seconds of the scene's parse, table build and
upload (``load_scene`` + ``build_job``, ending in a synchronise)."""


def read(run):
    return run.spans.get("scene_build_s")
