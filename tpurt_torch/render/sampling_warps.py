"""Monte-Carlo warps shared by BSDFs and lights (port of
tpurt/render/sampling_warps.py).

Batched elementwise over (N,) lanes.  Expressions keep tpurt's operation
order, so float32 results agree with the JAX package to the last ulp
wherever both sides round each operation once.
"""

from __future__ import annotations

import numpy as np
import torch

INV_PI = float(np.float32(1.0 / np.pi))
INV_2PI = float(np.float32(1.0 / (2 * np.pi)))
INV_4PI = float(np.float32(1.0 / (4 * np.pi)))


def concentric_sample_disk(u1, u2):
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    zero = (ux == 0) & (uy == 0)
    use_x = ux.abs() > uy.abs()
    r = torch.where(use_x, ux, uy)
    theta = torch.where(
        use_x,
        (np.pi / 4) * (uy / torch.where(ux == 0, 1.0, ux)),
        (np.pi / 2) - (np.pi / 4) * (ux / torch.where(uy == 0, 1.0, uy)),
    )
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return x, y


def cosine_sample_hemisphere(u1, u2):
    """(N,) pair -> (N,3) direction in local (+z up) frame."""
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2 * np.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_cone(u1, u2, cos_theta_max):
    cos_t = (1.0 - u1) + u1 * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2 * 2 * np.pi
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2 * np.pi * torch.clamp(1.0 - cos_theta_max, min=1e-9))


def uniform_sample_triangle(u1, u2):
    """Barycentrics (b0, b1) (sampling.cpp UniformSampleTriangle)."""
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """beta=2 power heuristic (integrator.cpp PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f * f + g * g > 0, (f * f) / (f * f + g * g), 0.0)


def build_onb(n):
    """Branchless orthonormal basis from unit normals (Duff et al. 2017).
    n: (N,3) -> (t, b) each (N,3)."""
    z = n[:, 2]
    sign = torch.where(z >= 0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], dim=-1)
    bt = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def to_local(t, b, n, v):
    """World (N,3) -> local shading frame coordinates."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    return v[:, 0:1] * t + v[:, 1:2] * b + v[:, 2:3] * n


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def norm(v, keepdim: bool = False):
    """Euclidean length over the last axis of 3-vectors."""
    n = torch.sqrt(dot(v, v))
    return n.unsqueeze(-1) if keepdim else n


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v):
    return v / torch.clamp(norm(v, keepdim=True), min=1e-20)


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[:, None] * n


def face_forward(n, v):
    return torch.where(dot(n, v)[:, None] < 0, -n, n)


def matvec_lanes(m, v):
    """Per-lane matrices' upper-left 3x3 blocks times vectors: m (N, 3|4,
    3|4), v (N, 3) -> (N, 3), each row's products summed from the left."""
    return (m[:, :3, 0] * v[:, 0:1] + m[:, :3, 1] * v[:, 1:2]
            + m[:, :3, 2] * v[:, 2:3])


def slerp_rotation(q0, q1, cos_t, dt):
    """The rotation matrix of slerp(q0, q1, dt) per lane, as tpurt's
    animated transforms build it (camera.py:_interp_c2w,
    intersect.py:interp_quad_transform; Quaternion Slerp,
    quaternion.cpp:20-30): q0, q1 (4,) or (N, 4) in wxyz with q1 already
    on q0's hemisphere, cos_t = |q0 . q1|, dt (N,).  Returns (N, 3, 3)."""
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    sin_t = torch.clamp(torch.sin(theta), min=1e-9)
    near = cos_t > 0.9995
    w0 = torch.where(near, 1 - dt, torch.sin((1 - dt) * theta) / sin_t)
    w1 = torch.where(near, dt, torch.sin(dt * theta) / sin_t)
    q = w0[:, None] * q0 + w1[:, None] * q1
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
