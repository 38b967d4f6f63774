"""Perspective and orthographic cameras with thin lens, the environment
camera and the realistic camera (port of tpurt/render/camera.py:
make_camera, as camera_tables + camera_from_tables, Camera.generate_rays
for "perspective", "orthographic", "environment" and "realistic", with
_generate_rays_realistic; its _trace_lenses_from_film is
render/lenses.py's trace_lenses_from_film).

Screen-window convention as in tpurt (camera.h:84): [-1,1] in the
narrower image axis, scaled by the aspect in the wider one.  Ray
differentials are taken by the integrator, which calls generate_rays at
the film point shifted one pixel in x and in y; ``fp_slope`` is the
isotropic footprint model of the deeper bounces (``fp_base`` its width at
the camera, the orthographic camera's).  An animated camera (a transform
given for the end time with ``ActiveTransform EndTime``) interpolates
its camera-to-world per lane at the ray's shutter time (``_interp_c2w``).

The realistic camera (cameras/realistic.cpp) traces each film ray
through a lens system that render/lenses.py reads, focuses and bounds:
the film point picks its exit-pupil zone, the lens sample a point of
that zone's bound on the rear element, and ``trace_lenses_from_film``
refracts the ray element by element, over a host list of rows.  A
vignetted lane keeps weight 0.  As in tpurt, its rays ignore the shutter
time and an animated transform, its camera-to-screen is the identity,
and a missing or unreadable lens file (or a focus it cannot reach)
raises, where tpurt warns and renders a 45-degree perspective camera.

Camera importance for the bidirectional integrators (tpurt's
camera_screen_area, _camera_frame, camera_we, camera_pdf_we and
camera_sample_wi, camera.py:426-502; perspective.cpp:150-239) is the
perspective camera's, thin lens included, and reads the static
camera-to-world; its constants are computed once, at upload.  As in
tpurt the same formulas serve the orthographic, environment and
realistic cameras too, whose importance they do not describe: the
realistic camera's raster-to-camera maps onto the screen plane z = 0,
so its screen area is infinite and its We and directional pdf are 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.geom import transform as xf
from tpurt_torch.render.lenses import (build_lens_system,
                                       trace_lenses_from_film)
from tpurt_torch.scene.paramset import ParamSet
from tpurt_torch.render.sampling_warps import (concentric_sample_disk,
                                               matvec_lanes, norm,
                                               slerp_rotation)


def _xform_point_batch(m, p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    w = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    out = torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3],
    ], dim=-1)
    return out / w[:, None]


def _xform_vector_batch(m, v):
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    return torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
    ], dim=-1)


@dataclasses.dataclass
class Camera:
    camera_to_world: torch.Tensor  # (4,4)
    raster_to_camera: torch.Tensor  # (4,4)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    res_x: int
    res_y: int
    # world-space filter width at distance t ~= fp_base + t * fp_slope
    fp_base: float = 0.0
    fp_slope: float = 0.0
    kind: str = "perspective"  # perspective | orthographic | environment
    # | realistic
    # animated camera-to-world (AnimatedTransform, transform.h:412): the
    # decomposed endpoint pair; a static camera leaves animated False
    anim_t: torch.Tensor = None  # (2, 3) translations
    anim_q: torch.Tensor = None  # (2, 4) rotations (w, x, y, z)
    anim_s: torch.Tensor = None  # (2, 3, 3) scale factors
    time0: float = 0.0
    time1: float = 1.0
    animated: bool = False
    # the constants camera importance reads (camera_we, camera_pdf_we,
    # camera_sample_wi), computed once on the host by camera_from_tables
    world_to_camera: torch.Tensor = None  # (4,4)
    camera_to_raster: torch.Tensor = None  # (4,4)
    screen_area: torch.Tensor = None  # () camera_screen_area
    origin: torch.Tensor = None  # (3,) world position (_camera_frame)
    forward: torch.Tensor = None  # (3,) unit world forward
    # the realistic camera (cameras/realistic.cpp): the element rows
    # (curvature radius, thickness, eta, aperture radius; m) as a host
    # tuple, the exit-pupil bounds of each radial film zone, the rear
    # element's z, the film diagonal and the weighting's constants
    lens_el: tuple = ()
    exit_pupil: torch.Tensor = None  # (Z, 4) x0, y0, x1, y1
    rear_z: float = 0.0
    diagonal_m: float = 0.035
    simple_weighting: bool = True
    epb0_area: float = 1.0

    def _interp_c2w(self, time):
        """Per-lane T-lerp, quaternion slerp and S-lerp, composed
        (tpurt's _interp_c2w, camera.py:94-121;
        AnimatedTransform::Interpolate, transform.cpp:467-500).  Returns
        (rs (N, 3, 3), trans (N, 3)); time (N,) is mapped through the
        TransformTimes interval."""
        dt = torch.clamp((time - self.time0)
                         / max(self.time1 - self.time0, 1e-9), 0.0, 1.0)
        trans = ((1 - dt)[:, None] * self.anim_t[0]
                 + dt[:, None] * self.anim_t[1])
        s = ((1 - dt)[:, None, None] * self.anim_s[0]
             + dt[:, None, None] * self.anim_s[1])
        q0, q1 = self.anim_q[0], self.anim_q[1]
        cos_t = (q0 * q1).sum()
        q1 = torch.where(cos_t < 0, -q1, q1)
        cos_t = cos_t.abs()
        r = slerp_rotation(q0, q1, cos_t, dt)
        return torch.einsum("nij,njk->nik", r, s), trans

    def generate_rays(self, p_film, p_lens, time=None):
        """p_film: (N,2) raster points; p_lens: (N,2) in [0,1)^2; time
        (N,) the shutter time, read only by an animated camera.
        Returns (o, d, weight); d normalized (tpurt's generate_rays,
        camera.py:129-173: perspective.cpp:79-93, orthographic.cpp,
        environment.cpp).  The realistic camera reads no time."""
        if self.kind == "realistic":
            return self._generate_rays_realistic(p_film, p_lens)
        n = p_film.shape[0]
        p_raster = torch.cat(
            [p_film, torch.zeros((n, 1), dtype=p_film.dtype,
                                 device=p_film.device)], dim=-1)
        p_cam = _xform_point_batch(self.raster_to_camera, p_raster)
        if self.kind == "perspective":
            d = p_cam / norm(p_cam, keepdim=True)
            o = torch.zeros_like(d)
        elif self.kind == "orthographic":
            o = p_cam
            d = torch.zeros_like(p_cam)
            d[:, 2] = 1.0
        else:  # environment: theta over the height, phi over the width
            theta = np.pi * p_film[:, 1] / self.res_y
            phi = 2 * np.pi * p_film[:, 0] / self.res_x
            d = torch.stack([torch.sin(theta) * torch.cos(phi),
                             torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], dim=-1)
            o = torch.zeros_like(d)
        if self.lens_radius > 0 and self.kind != "environment":
            p_disk = self.lens_radius * torch.stack(
                concentric_sample_disk(p_lens[:, 0], p_lens[:, 1]), dim=-1)
            dz = torch.where(d[:, 2] == 0, 1e-9, d[:, 2])
            ft = torch.full_like(dz, self.focal_distance) / dz
            p_focus = o + ft[:, None] * d
            o = torch.cat([p_disk, torch.zeros((n, 1), dtype=p_disk.dtype,
                                               device=p_disk.device)], -1)
            d = p_focus - o
            d = d / norm(d, keepdim=True)
        if self.animated and time is not None:
            rs, trans = self._interp_c2w(time)
            o_w = matvec_lanes(rs, o) + trans
            d_w = matvec_lanes(rs, d)
        else:
            o_w = _xform_point_batch(self.camera_to_world, o)
            d_w = _xform_vector_batch(self.camera_to_world, d)
        d_w = d_w / norm(d_w, keepdim=True)
        return o_w, d_w, torch.ones(n, dtype=p_film.dtype,
                                    device=p_film.device)

    def _generate_rays_realistic(self, p_film, p_lens):
        """RealisticCamera::GenerateRay (realistic.cpp:679-714; tpurt's
        camera.py:170-218): film point -> a point of its zone's exit-pupil
        bound on the rear element -> the element-by-element trace.
        Vignetted lanes get weight 0."""
        aspect = self.res_y / self.res_x
        ext_x = float(np.sqrt(self.diagonal_m ** 2 / (1 + aspect * aspect)))
        ext_y = aspect * ext_x
        sx = p_film[:, 0] / self.res_x
        sy = p_film[:, 1] / self.res_y
        pfx = -(-ext_x / 2 + sx * ext_x)  # pFilm.x = -physical.x
        pfy = -ext_y / 2 + sy * ext_y

        # exit-pupil sample (SampleExitPupil, realistic.cpp:613-633)
        r_film = torch.sqrt(pfx * pfx + pfy * pfy)
        zones = self.exit_pupil.shape[0]
        r_idx = torch.clamp((r_film / (self.diagonal_m / 2) * zones).to(
            torch.int32), max=zones - 1)
        b = self.exit_pupil[r_idx.long()]  # (N, 4)
        area = torch.clamp((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]),
                           min=0.0)
        lx = b[:, 0] + p_lens[:, 0] * (b[:, 2] - b[:, 0])
        ly = b[:, 1] + p_lens[:, 1] * (b[:, 3] - b[:, 1])
        r_pos = r_film > 0
        r_safe = torch.clamp(r_film, min=1e-20)
        sin_t = torch.where(r_pos, pfy / r_safe, 0.0)
        cos_t = torch.where(r_pos, pfx / r_safe, 1.0)
        prx = cos_t * lx - sin_t * ly
        pry = sin_t * lx + cos_t * ly

        # lens space: film at z=0, rear element at z=-rear_z
        o = torch.stack([pfx, pfy, torch.zeros_like(pfx)], dim=-1)
        d = torch.stack([prx - pfx, pry - pfy,
                         torch.full_like(pfx, -self.rear_z)], dim=-1)
        cos4 = (self.rear_z ** 2 / torch.clamp(
            (d * d).sum(dim=-1), min=1e-30)) ** 2

        ok, o, d = trace_lenses_from_film(self.lens_el, o, d)

        # lens -> camera space (flip z) -> world
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32,
                            device=o.device)
        o_w = _xform_point_batch(self.camera_to_world, o * flip)
        d_w = _xform_vector_batch(self.camera_to_world, d * flip)
        d_w = d_w / torch.clamp(norm(d_w, keepdim=True), min=1e-30)
        if self.simple_weighting:
            w = cos4 * area / max(self.epb0_area, 1e-20)
        else:
            w = ((self.shutter_close - self.shutter_open) * cos4 * area
                 / (self.rear_z * self.rear_z))
        return o_w, d_w, torch.where(ok, w, 0.0).to(p_film.dtype)


def _screen_window(res_x: int, res_y: int, ps: ParamSet):
    aspect = res_x / res_y
    if aspect > 1:
        default = [-aspect, aspect, -1.0, 1.0]
    else:
        default = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
    sw = ps.find_float_array("screenwindow")
    if sw is not None and len(sw) == 4:
        return [float(v) for v in sw]
    return default


def _raster_to_screen_to_camera(camera_to_screen: xf.Transform, sw,
                                res_x: int, res_y: int) -> np.ndarray:
    x0, x1, y0, y1 = sw
    screen_to_raster = (
        xf.scale(res_x, res_y, 1.0)
        * xf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        * xf.translate([-x0, -y1, 0.0])
    )
    raster_to_screen = screen_to_raster.inverse()
    raster_to_camera = camera_to_screen.inverse() * raster_to_screen
    return raster_to_camera.m.astype(np.float32)


def camera_tables(name: str, ps: ParamSet, camera_to_world: xf.Transform,
                  res_x: int, res_y: int,
                  camera_to_world_end: xf.Transform = None,
                  transform_times=(0.0, 1.0), diagonal_m: float = 0.035,
                  device="cuda") -> dict:
    """Host-side camera constants (MakeCamera, api.cpp:786-815; tpurt's
    make_camera, camera.py:308-424).  With ``camera_to_world_end`` the
    camera is animated over ``transform_times``: both endpoints are
    decomposed into translation, rotation and scale.  ``diagonal_m`` is
    the film's diagonal; the realistic camera's exit pupil is traced on
    ``device``."""
    if name not in ("perspective", "orthographic", "environment",
                    "realistic"):
        raise NotImplementedError(f'Camera "{name}"')
    anim = dict(anim_t=None, anim_q=None, anim_s=None, animated=False)
    if camera_to_world_end is not None:
        t0, q0, s0 = xf.decompose_trs(camera_to_world.m)
        t1, q1, s1 = xf.decompose_trs(camera_to_world_end.m)
        anim = dict(anim_t=np.stack([t0, t1]).astype(np.float32),
                    anim_q=np.stack([q0, q1]).astype(np.float32),
                    anim_s=np.stack([s0, s1]).astype(np.float32),
                    animated=True)
    if name == "perspective":
        fov = ps.find_one_float("fov", 90.0)
        half_fov = ps.find_one_float("halffov", -1.0)
        if half_fov > 0:
            fov = 2 * half_fov
        cam_to_screen = xf.perspective(fov, 1e-2, 1000.0)
    elif name == "orthographic":
        cam_to_screen = xf.orthographic(0.0, 1.0)
    else:
        cam_to_screen = xf.Transform()
    lens = (_realistic_tables(ps, diagonal_m, device) if name == "realistic"
            else {})
    sw = _screen_window(res_x, res_y, ps)
    r2c = _raster_to_screen_to_camera(cam_to_screen, sw, res_x, res_y)

    def thru(px, py):
        v = r2c.astype(np.float64) @ np.array([px, py, 0.0, 1.0])
        return v[:3] / (v[3] if abs(v[3]) > 1e-12 else 1.0)

    fp_base = fp_slope = 0.0
    pa = thru(res_x / 2, res_y / 2)
    pb = thru(res_x / 2 + 1, res_y / 2 + 1)
    if name == "perspective":
        # angle between the rays of two diagonal pixel neighbours at the
        # centre
        d0 = pa / max(np.linalg.norm(pa), 1e-12)
        d1 = pb / max(np.linalg.norm(pb), 1e-12)
        fp_slope = float(np.arccos(np.clip(d0 @ d1, -1, 1)) / np.sqrt(2))
    elif name == "orthographic":
        fp_base = float(np.linalg.norm((pb - pa)[:2]) / np.sqrt(2))
    elif name == "environment":
        fp_slope = float(np.pi / res_y)
    return dict(
        kind=name, camera_to_world=camera_to_world.m.astype(np.float32),
        raster_to_camera=r2c, fp_base=fp_base, fp_slope=fp_slope,
        lens_radius=ps.find_one_float("lensradius", 0.0),
        focal_distance=ps.find_one_float("focaldistance", 1e6),
        shutter_open=ps.find_one_float("shutteropen", 0.0),
        shutter_close=ps.find_one_float("shutterclose", 1.0),
        res_x=res_x, res_y=res_y, time0=float(transform_times[0]),
        time1=float(transform_times[1]), **anim, **lens)


def _realistic_tables(ps: ParamSet, diagonal_m: float, device) -> dict:
    """The realistic camera's set-up (tpurt's camera.py:333-357): the
    lens file read, focused and bounded on ``device``.  A missing or
    unreadable file, or a focus distance the lens cannot reach, raises
    ValueError naming the camera and the file (tpurt warns and renders a
    45-degree perspective camera instead)."""
    lensfile = ps.find_one_string("lensfile", "")
    if not lensfile:
        raise ValueError('Camera "realistic": no "string lensfile" given')
    try:
        ls = build_lens_system(lensfile,
                               ps.find_one_float("aperturediameter", 1.0),
                               ps.find_one_float("focusdistance", 10.0),
                               diagonal_m, device=device)
    except (OSError, ValueError) as e:
        raise ValueError(f'Camera "realistic": lens file "{lensfile}": {e}'
                         ) from e
    b0 = ls.exit_pupil[0]
    return dict(
        lens_el=tuple(tuple(float(v) for v in row) for row in ls.elements),
        exit_pupil=ls.exit_pupil, rear_z=ls.rear_z, diagonal_m=diagonal_m,
        simple_weighting=ps.find_one_bool("simpleweighting", True),
        epb0_area=float(max((b0[2] - b0[0]) * (b0[3] - b0[1]), 1e-20)))


def camera_from_tables(tab: dict, device) -> Camera:
    """The Camera of camera_tables' constants on ``device``, with the
    constants of camera importance computed here on the host: the
    inverses of camera-to-world and raster-to-camera (in float64, rounded
    to float32), the screen area and the camera's frame."""
    inv = {k: np.linalg.inv(np.asarray(tab[m], np.float64)).astype(
        np.float32) for k, m in (("world_to_camera", "camera_to_world"),
                                 ("camera_to_raster", "raster_to_camera"))}
    host = Camera(**{k: (torch.tensor(v) if isinstance(v, np.ndarray)
                         else v) for k, v in {**tab, **inv}.items()})
    host.origin, host.forward = _camera_frame(host)
    host.screen_area = camera_screen_area(host)
    return Camera(**{f.name: (v.to(device) if isinstance(v, torch.Tensor)
                              else v)
                     for f in dataclasses.fields(Camera)
                     for v in [getattr(host, f.name)]})


# ---------------------------------------------------------------------------
# camera importance (We / Pdf_We / Sample_Wi) for bdpt and mlt
# ---------------------------------------------------------------------------

def camera_screen_area(cam: Camera):
    """Area A of the screen window on the z=1 camera plane (a 0-dim
    tensor)."""
    corners = torch.tensor([[0.0, 0.0, 0.0],
                            [float(cam.res_x), float(cam.res_y), 0.0]],
                           dtype=torch.float32,
                           device=cam.raster_to_camera.device)
    pc = _xform_point_batch(cam.raster_to_camera, corners)
    pc = pc / pc[:, 2:3]
    return ((pc[1, 0] - pc[0, 0]) * (pc[1, 1] - pc[0, 1])).abs()


def _camera_frame(cam: Camera):
    """(origin (3,), unit forward (3,)) of the static camera-to-world."""
    c2w = cam.camera_to_world
    o_w = _xform_point_batch(c2w, torch.zeros((1, 3), dtype=torch.float32,
                                              device=c2w.device))[0]
    fwd = _xform_vector_batch(c2w, torch.tensor(
        [[0.0, 0.0, 1.0]], dtype=torch.float32, device=c2w.device))[0]
    return o_w, fwd / torch.linalg.vector_norm(fwd)


def _lens_area(cam: Camera) -> float:
    return np.pi * cam.lens_radius ** 2 if cam.lens_radius > 0 else 1.0


def camera_we(cam: Camera, o, d):
    """Importance We(ray) and its raster point (PerspectiveCamera::We).
    o, d: (N, 3) world.  Returns (we (N,), p_raster (N, 2), valid (N,))."""
    d_c = _xform_vector_batch(cam.world_to_camera, d)
    o_c = _xform_point_batch(cam.world_to_camera, o)
    cos_t = d_c[:, 2] / norm(d_c)
    focus = cam.focal_distance if cam.lens_radius > 0 else 1.0
    t = focus / torch.where(cos_t == 0, 1e-9, d_c[:, 2])
    p_focus = o_c + t[:, None] * d_c
    p_raster3 = _xform_point_batch(cam.camera_to_raster, p_focus)
    inside = ((p_raster3[:, 0] >= 0) & (p_raster3[:, 0] < cam.res_x)
              & (p_raster3[:, 1] >= 0) & (p_raster3[:, 1] < cam.res_y))
    valid = (cos_t > 0) & inside
    a = cam.screen_area
    cos4 = torch.clamp(cos_t, min=1e-9) ** 4
    we = torch.where(valid, 1.0 / (a * _lens_area(cam) * cos4), 0.0)
    return we, p_raster3[:, :2], valid


def camera_pdf_we(cam: Camera, d):
    """(pdf_pos, pdf_dir) of GenerateRay producing the world direction d
    (PerspectiveCamera::Pdf_We)."""
    d_c = _xform_vector_batch(cam.world_to_camera, d)
    cos_t = d_c[:, 2] / torch.clamp(norm(d_c), min=1e-12)
    a = cam.screen_area
    pdf_dir = torch.where(cos_t > 0,
                          1.0 / (a * torch.clamp(cos_t, min=1e-9) ** 3), 0.0)
    pdf_pos = torch.full(d.shape[:1], 1.0 / _lens_area(cam),
                         dtype=torch.float32, device=d.device)
    return pdf_pos, pdf_dir


def camera_sample_wi(cam: Camera, ref_p, u_lens):
    """A direction from ref_p to the camera (PerspectiveCamera::Sample_Wi,
    the t=1 strategies).  u_lens (N, 2).  Returns (wi (N, 3), pdf (N,),
    we (N,), p_raster (N, 2), p_lens_w (N, 3), cam_fwd (3,))."""
    o_w, fwd = cam.origin, cam.forward
    if cam.lens_radius > 0:
        p_disk = cam.lens_radius * torch.stack(
            concentric_sample_disk(u_lens[:, 0], u_lens[:, 1]), dim=-1)
        p_lens_c = torch.cat([p_disk, torch.zeros_like(p_disk[:, :1])], -1)
        p_lens_w = _xform_point_batch(cam.camera_to_world, p_lens_c)
    else:
        p_lens_w = o_w[None, :].expand(ref_p.shape)
    to_cam = p_lens_w - ref_p
    dist = torch.clamp(norm(to_cam), min=1e-9)
    wi = to_cam / dist[:, None]
    cos_lens = (wi * fwd[None, :]).sum(dim=-1).abs()
    pdf = (dist * dist) / torch.clamp(cos_lens * _lens_area(cam), min=1e-12)
    we, p_raster, valid = camera_we(cam, p_lens_w, -wi)
    pdf = torch.where(valid, pdf, 0.0)
    return wi, pdf, we, p_raster, p_lens_w, fwd
