"""The knobs the ported slice reads (counterpart of tpurt/config.py).

tpurt's other knobs select TPU-only paths (Pallas, the XLA compile cache,
the deterministic film, fused shadow rays, the lax.scan driver) or
features outside this slice, so they have no counterpart here.
"""

from __future__ import annotations

from pathlib import Path

import torch

# Where the port builds what it compiles (the CUDA kernels, the native
# SAH builder) and caches host tables: build/tpurt_torch/ at the
# repository root, which .gitignore lists.
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "tpurt_torch"

# Curve handling of the scene loader (tpurt's config.curve_mode default).
CURVE_MODE = "raytrace"

# Lanes per wavefront chunk: a frame of up to 2^20 camera paths runs whole,
# larger frames in 2^20-lane chunks.  (tpurt's 2^18 was set by a TPU
# watchdog on long device calls; nothing here needs it.)
WAVEFRONT_SIZE = 1 << 20

# Loop budgets of the media code (tpurt's config.shadow_walk_steps and
# grid_track_steps): the null-boundary crossings a shadow ray walks and
# the steps of delta and ratio tracking through a grid medium.  A lane
# that exhausts one is counted (render/volpath.py:TRACK_STATS); these set
# images, so they keep tpurt's values.
SHADOW_WALK_STEPS = 4
GRID_TRACK_STEPS = 256

# tpurt's wavefront_size default: its non-compacted driver (the one its
# volpath runs in) hashes the grid-tracking uniforms by each lane's
# position in a chunk of tpurt_chunk(total) lanes.
TPURT_WAVEFRONT_SIZE = 1 << 18


def tpurt_chunk(total: int) -> int:
    """The lanes of one chunk of tpurt's scan driver for a frame of
    ``total`` camera paths (tpurt/render/driver.py:477-482): the least
    power of two >= total, at least 2^14, capped by tpurt's wavefront
    size and 2^20."""
    min_chunk = 1 << 14
    bucket = min_chunk
    while bucket < total:
        bucket *= 2
    return max(min(bucket, TPURT_WAVEFRONT_SIZE, 1 << 20), min_chunk)


def resolve_device(device) -> torch.device:
    """The explicit render device.  Raises when CUDA is asked for and is
    absent: there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to render on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device type {dev.type!r}")
    return dev
