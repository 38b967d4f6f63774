"""The realistic camera's lens system (port of tpurt/render/lenses.py:
load_lens_file :37, _refract_np, trace_from_film_np :76,
_trace_from_scene_np :131, _cardinal_points, focus_thick_lens :190,
bound_exit_pupil :228, _radical_inverse2, build_lens_system :264;
cameras/realistic.cpp).

A lens description is a table of spherical interfaces [curvature radius,
thickness, ior, aperture diameter] in mm, the scene side first; it is
read in metres with the aperture halved.  The rear element's thickness
is set by the thick-lens approximation to focus at the focus distance,
and the exit pupil is bounded over radial film zones, so that ray
generation samples only the useful region of the rear element.

The file, the focus and the single rays of the cardinal points stay on
the host, as in tpurt.  One film-side trace serves every caller,
``trace_lenses_from_film`` over torch tensors of any float dtype: the
camera's rays in float32 on the job's device (tpurt's jnp trace), the
focus's single ray in float64 on the host (``trace_from_film_np``, tpurt's
numpy one), and ``bound_exit_pupil``'s 2^18 Hammersley rays a zone (64
zones: tpurt's 20 s of numpy) in float64 on the job's device.  Its
float64 operations keep numpy's order, so its bounds are numpy's (torch's
vectorized CPU sqrt can differ from numpy's by an ulp; the card's is
correctly rounded).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Tuple

import numpy as np
import torch

log = logging.getLogger("tpurt_torch.render")

# exit-pupil zones over the film's half diagonal and Hammersley rays a
# zone (realistic.cpp:534-571; tpurt's build_lens_system defaults)
N_ZONES = 64
N_PUPIL_SAMPLES = 1 << 18


class LensSystem(NamedTuple):
    elements: np.ndarray  # (M, 4): radius, thickness, eta, aperture radius (m)
    exit_pupil: np.ndarray  # (Z, 4): x0, y0, x1, y1 on the rear element
    rear_z: float  # LensRearZ(): z of the rear element (camera space, +z)
    diagonal: float  # film diagonal (m)


def load_lens_file(path: str, aperture_diameter_mm: float) -> np.ndarray:
    """Parse the pbrt lens .dat format: whitespace rows of 4 floats, '#'
    comments; mm -> m, aperture diameter -> radius (realistic.cpp:58-71).
    The stop row takes ``aperture_diameter_mm`` unless that exceeds its
    own diameter."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                vals.extend(float(t) for t in line.split())
    if len(vals) % 4:
        raise ValueError(f"lens file {path}: element count not divisible by 4")
    el = np.asarray(vals, np.float64).reshape(-1, 4)
    for i in range(len(el)):
        if el[i, 0] == 0:  # aperture stop row
            if aperture_diameter_mm > el[i, 3]:
                log.warning("aperture diameter %f > max %f; clamping",
                            aperture_diameter_mm, el[i, 3])
            else:
                el[i, 3] = aperture_diameter_mm
    out = el.copy()
    out[:, 0] *= 0.001
    out[:, 1] *= 0.001
    out[:, 3] *= 0.001 / 2.0
    return out


def _refract_np(wi, n, eta_rel):
    """Refract unit wi about unit n (wi on n's side); eta_rel = etaI/etaT.
    Returns (ok, wt) (geometry.h Refract)."""
    cos_i = np.sum(n * wi, axis=-1)
    sin2_i = np.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_rel * eta_rel * sin2_i
    ok = sin2_t < 1.0
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
    wt = (-wi * eta_rel[..., None]
          + (eta_rel * cos_i - cos_t)[..., None] * n)
    return ok, wt


def trace_lenses_from_film(lens_el, o, d):
    """TraceLensesFromFilm (realistic.cpp:100-152; tpurt's
    trace_from_film_np :76 and, on the device, _trace_lenses_from_film,
    camera.py:220-280) over (N, 3) lens-space rays of any float dtype:
    the loop runs over the host rows of ``lens_el`` (radius, thickness,
    eta, aperture radius), each a few elementwise ops, and a lane that
    misses an element or reflects totally is masked (ok False) and keeps
    its last o and d.  Sums run left to right, as numpy's over 3 terms,
    so float64 results are numpy's.  Returns (ok, o, d); d is not
    normalized."""
    ok = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    element_z = 0.0
    for i in range(len(lens_el) - 1, -1, -1):
        radius, thickness, eta, ap = (float(v) for v in lens_el[i])
        element_z -= thickness
        if radius == 0:  # aperture stop plane
            live = ok & (d[:, 2] < 0)
            t = torch.where(live, (element_z - o[:, 2])
                            / torch.where(d[:, 2] == 0, -1e-9, d[:, 2]), 0.0)
            ok = live & (t >= 0)
        else:
            z_center = element_z + radius
            oc = o.clone()
            oc[:, 2] = o[:, 2] - z_center
            a = _dot3(d, d)
            b = 2.0 * _dot3(d, oc)
            c = _dot3(oc, oc) - radius * radius
            disc = b * b - 4 * a * c
            has = disc >= 0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            q = -0.5 * (b + torch.where(b < 0, -sq, sq))
            t0 = q / torch.where(a == 0, 1e-30, a)
            t1 = c / torch.where(q == 0, 1e-30, q)
            closer = (d[:, 2] > 0) ^ (radius < 0)
            t = torch.where(closer, torch.minimum(t0, t1),
                            torch.maximum(t0, t1))
            ok = ok & has & (t >= 0)
            n = o + t[:, None] * d
            n[:, 2] = n[:, 2] - z_center
            n = n / torch.clamp(torch.sqrt(_dot3(n, n)), min=1e-30)[:, None]
            n = torch.where((_dot3(n, -d) < 0)[:, None], -n, n)
        p_hit = o + t[:, None] * d
        r2 = p_hit[:, 0] ** 2 + p_hit[:, 1] ** 2
        ok = ok & (r2 <= ap * ap)
        o = torch.where(ok[:, None], p_hit, o)
        if radius != 0:
            eta_t = (float(lens_el[i - 1][2])
                     if (i > 0 and lens_el[i - 1][2] != 0) else 1.0)
            eta_rel = eta / eta_t
            dn = d / torch.clamp(torch.sqrt(_dot3(d, d)), min=1e-30)[:, None]
            wi = -dn
            cos_i = _dot3(n, wi)
            sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i,
                                                     min=0.0)
            ok = ok & (sin2_t < 1.0)
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            wt = -wi * eta_rel + (eta_rel * cos_i - cos_t)[:, None] * n
            d = torch.where(ok[:, None], wt, d)
    return ok, o, d


def _dot3(a, b):
    """Row dot products summed left to right, as numpy sums 3 terms."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def trace_from_film_np(el: np.ndarray, o, d) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
    """trace_lenses_from_film in float64 on the host's arrays: (ok,
    o_out, d_out) as numpy."""
    out = trace_lenses_from_film(
        el, torch.tensor(np.asarray(o, np.float64)),
        torch.tensor(np.asarray(d, np.float64)))
    return tuple(x.numpy() for x in out)


def _trace_from_scene_np(el: np.ndarray, o, d):
    """TraceLensesFromScene (realistic.cpp:175-224), lens space."""
    o = np.array(o, np.float64, copy=True)
    d = np.array(d, np.float64, copy=True)
    ok = np.ones(o.shape[0], bool)
    element_z = -float(np.sum(el[:, 1]))  # -LensFrontZ
    for i in range(len(el)):
        radius, thickness, eta, ap = el[i]
        is_stop = radius == 0
        if is_stop:
            t = (element_z - o[:, 2]) / np.where(d[:, 2] == 0, 1e-30,
                                                 d[:, 2])
        else:
            z_center = element_z + radius
            oc = o - np.asarray([0.0, 0.0, z_center])
            a = np.sum(d * d, axis=-1)
            b = 2.0 * np.sum(d * oc, axis=-1)
            c = np.sum(oc * oc, axis=-1) - radius * radius
            disc = b * b - 4 * a * c
            has = disc >= 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            q = -0.5 * (b + np.where(b < 0, -sq, sq))
            t0 = q / np.where(a == 0, 1e-30, a)
            t1 = c / np.where(q == 0, 1e-30, q)
            closer = (d[:, 2] > 0) ^ (radius < 0)
            t = np.where(closer, np.minimum(t0, t1), np.maximum(t0, t1))
            ok = ok & has & (t >= 0)
            n = o + t[:, None] * d - np.asarray([0.0, 0.0, z_center])
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
            flip = np.sum(n * -d, axis=-1) < 0
            n = np.where(flip[:, None], -n, n)
        p_hit = o + t[:, None] * d
        r2 = p_hit[:, 0] ** 2 + p_hit[:, 1] ** 2
        ok = ok & (r2 <= ap * ap)
        o = np.where(ok[:, None], p_hit, o)
        if not is_stop:
            eta_i = el[i - 1, 2] if (i > 0 and el[i - 1, 2] != 0) else 1.0
            eta_t = eta if eta != 0 else 1.0
            dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True),
                                1e-30)
            rok, wt = _refract_np(-dn, n, np.full(o.shape[0],
                                                  eta_i / eta_t))
            ok = ok & rok
            d = np.where(ok[:, None], wt, d)
        element_z += thickness
    return ok, o, d


def _cardinal_points(o_in_x, o_out, d_out):
    """ComputeCardinalPoints (realistic.cpp:427-434): (pz, fz)."""
    tf = -o_out[0] / d_out[0]
    fz = -(o_out[2] + tf * d_out[2])
    tp = (o_in_x - o_out[0]) / d_out[0]
    pz = -(o_out[2] + tp * d_out[2])
    return pz, fz


def focus_thick_lens(el: np.ndarray, focus_distance: float,
                     diagonal: float) -> float:
    """FocusThickLens (realistic.cpp:458-474): the rear element's
    thickness that focuses at ``focus_distance``.  Raises ValueError when
    a focusing ray does not pass or the distance is too short."""
    x = 0.001 * diagonal
    front_z = float(np.sum(el[:, 1]))
    rear_z = float(el[-1, 1])

    def to_cam(o, d):  # lens space -> camera space (flip z)
        oc, dc = o.copy(), d.copy()
        oc[2] = -oc[2]
        dc[2] = -dc[2]
        return oc, dc

    # a scene-side parallel ray to the film, then a film-side one out
    ok, oo, dd = _trace_from_scene_np(
        el, np.asarray([[x, 0.0, -(front_z + 1.0)]]),
        np.asarray([[0.0, 0.0, 1.0]]))
    if not ok[0]:
        raise ValueError("cannot trace scene->film ray for focusing")
    pz0, fz0 = _cardinal_points(x, *to_cam(oo[0], dd[0]))
    ok, oo, dd = trace_from_film_np(
        el, np.asarray([[x, 0.0, -(rear_z - 1.0)]]),
        np.asarray([[0.0, 0.0, -1.0]]))
    if not ok[0]:
        raise ValueError("cannot trace film->scene ray for focusing")
    pz1, fz1 = _cardinal_points(x, *to_cam(oo[0], dd[0]))

    f = fz0 - pz0
    z = -focus_distance
    c = (pz1 - z - pz0) * (pz1 - z - 4 * f - pz0)
    if c <= 0:
        raise ValueError("focus distance too short for this lens")
    delta = 0.5 * (pz1 - z + pz0 - np.sqrt(c))
    return float(el[-1, 1] + delta)


def _radical_inverse2(i):
    """Base-2 radical inverse of int64 lane indices, as float64 (the bit
    reversal of a 32-bit word over 2^32)."""
    m = 0xFFFFFFFF
    v = ((i >> 16) | (i << 16)) & m
    v = (((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)) & m
    v = (((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)) & m
    v = (((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)) & m
    v = (((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)) & m
    return v.to(torch.float64) * (1.0 / (1 << 32))


def bound_exit_pupil(el: np.ndarray, film_x0: float, film_x1: float,
                     n_samples: int = N_PUPIL_SAMPLES,
                     device="cuda") -> np.ndarray:
    """BoundExitPupil (realistic.cpp:534-571): [x0, y0, x1, y1] on the
    rear element's plane of the film radii [film_x0, film_x1), from
    ``n_samples`` Hammersley rays traced in float64 on ``device``."""
    rear_radius = float(el[-1, 3])
    rear_z = float(el[-1, 1])
    lim = 1.5 * rear_radius
    i = torch.arange(n_samples, dtype=torch.int64, device=device)
    u0 = (i.to(torch.float64) + 0.5) / n_samples
    fx = film_x0 + u0 * (film_x1 - film_x0)
    # Hammersley points over the projected rear bounds
    px = -lim + 2 * lim * u0
    py = -lim + 2 * lim * _radical_inverse2(i)
    zero = torch.zeros_like(fx)
    # lens space: film at z=0, elements toward -z (camera z flipped)
    o = torch.stack([fx, zero, zero], -1)
    d = torch.stack([px - fx, py, zero - rear_z], -1)
    ok = trace_lenses_from_film(el, o, d)[0]
    if not bool(ok.any()):
        return np.asarray([-lim, -lim, lim, lim])
    pxo, pyo = px[ok], py[ok]
    b = torch.stack([pxo.min(), pyo.min(), pxo.max(), pyo.max()]).cpu()
    expand = 2.0 * np.sqrt((2 * lim) ** 2 * 2) / np.sqrt(n_samples)
    return b.numpy() + np.asarray([-expand, -expand, expand, expand])


def build_lens_system(path: str, aperture_diameter_mm: float,
                      focus_distance: float, diagonal_m: float,
                      n_zones: int = None, device="cuda",
                      n_samples: int = None) -> LensSystem:
    """The lens table focused at ``focus_distance`` and its exit-pupil
    bounds over ``n_zones`` zones of the half diagonal (N_ZONES, read at
    the call), ``n_samples`` rays a zone (N_PUPIL_SAMPLES), traced on
    ``device``."""
    n_zones = N_ZONES if n_zones is None else n_zones
    n_samples = N_PUPIL_SAMPLES if n_samples is None else n_samples
    el = load_lens_file(path, aperture_diameter_mm)
    el[-1, 1] = focus_thick_lens(el, focus_distance, diagonal_m)
    bounds = np.zeros((n_zones, 4))
    half_diag = diagonal_m / 2.0
    for i in range(n_zones):
        r0 = i / n_zones * half_diag
        r1 = (i + 1) / n_zones * half_diag
        bounds[i] = bound_exit_pupil(el, r0, r1, n_samples, device)
    return LensSystem(elements=el.astype(np.float32),
                      exit_pupil=bounds.astype(np.float32),
                      rear_z=float(el[-1, 1]), diagonal=diagonal_m)
