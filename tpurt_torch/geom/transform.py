"""Host-side 4x4 transforms (numpy, float64 build / float32 ship).

Reference analog: core/transform.{h,cpp} (Matrix4x4 + Transform with cached
inverse; LookAt, Rotate, Scale, Translate, Perspective builders).  On device
transforms are plain (4, 4) arrays applied to batched point/vector/normal
tensors, so this module is only the scene-construction algebra.  pbrt is
left-handed: +z points into the screen.
"""

from __future__ import annotations

import numpy as np


class Transform:
    """An affine/projective transform with its cached inverse."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float64)
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m)
        self.m = m
        self.m_inv = np.asarray(m_inv, dtype=np.float64).reshape(4, 4)

    # -- algebra ------------------------------------------------------------
    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __eq__(self, other) -> bool:
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def is_identity(self) -> bool:
        return np.array_equal(self.m, np.eye(4))

    def swaps_handedness(self) -> bool:
        return np.linalg.det(self.m[:3, :3]) < 0

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    # -- application (host-side; device code uses the raw matrices) ---------
    def apply_point(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return r / w[..., None] if not np.allclose(w, 1.0) else r

    def apply_vector(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v, dtype=np.float64) @ self.m[:3, :3].T

    def apply_normal(self, n: np.ndarray) -> np.ndarray:
        # Normals transform by the inverse transpose.
        return np.asarray(n, dtype=np.float64) @ self.m_inv[:3, :3]


def translate(delta) -> Transform:
    d = np.asarray(delta, dtype=np.float64)
    m = np.eye(4)
    m[:3, 3] = d
    mi = np.eye(4)
    mi[:3, 3] = -d
    return Transform(m, mi)


def scale(sx, sy, sz) -> Transform:
    m = np.diag([sx, sy, sz, 1.0])
    mi = np.diag([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0])
    return Transform(m, mi)


def rotate_x(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])
    return Transform(m, m.T)


def rotate_y(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1.0]])
    return Transform(m, m.T)


def rotate_z(deg) -> Transform:
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    return Transform(m, m.T)


def rotate(deg, axis) -> Transform:
    """Rotation of ``deg`` degrees about an arbitrary axis (Rodrigues)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    x, y, z = a
    m = np.eye(4)
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return Transform(m, m.T)


def look_at(eye, look, up) -> Transform:
    """Camera-to-world transform; columns are (right, newUp, dir, eye)
    (transform.cpp LookAt).  Degenerate up||dir falls back to identity
    orientation with a warning, like the reference."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    dir_ = look - eye
    dir_ = dir_ / np.linalg.norm(dir_)
    upn = up / np.linalg.norm(up)
    right = np.cross(upn, dir_)
    rlen = np.linalg.norm(right)
    if rlen == 0:
        import warnings

        warnings.warn('"up" vector and viewing direction are parallel in LookAt')
        return translate(eye)
    right = right / rlen
    new_up = np.cross(dir_, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = dir_
    m[:3, 3] = eye
    return Transform(m)


def perspective(fov_deg, n, f) -> Transform:
    """Perspective projection: camera space -> NDC-ish screen space with
    z in [0, 1] between near/far (transform.cpp Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, f / (f - n), -f * n / (f - n)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2)
    return scale(inv_tan, inv_tan, 1.0) * Transform(persp)


def orthographic(znear, zfar) -> Transform:
    return scale(1.0, 1.0, 1.0 / (zfar - znear)) * translate([0, 0, -znear])


def decompose_trs(m: np.ndarray):
    """AnimatedTransform::Decompose (transform.cpp:412+): M = T R S with
    R extracted by polar iteration.  Returns (t (3,), q (4,) wxyz, s (3,3))."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.abs(r_next - r).sum() < 1e-10:
            r = r_next
            break
        r = r_next
    s = np.linalg.inv(r) @ m[:3, :3]
    # rotation matrix -> quaternion (quaternion.cpp Quaternion(Transform))
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(tr + 1.0) / 2
        f = 0.25 / w
        q = np.array([w, (r[2, 1] - r[1, 2]) * f, (r[0, 2] - r[2, 0]) * f,
                      (r[1, 0] - r[0, 1]) * f])
    else:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        sq = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 0.0))
        qv = np.zeros(3)
        qv[i] = 0.5 * sq
        f = 0.5 / max(sq, 1e-12)
        w = (r[k, j] - r[j, k]) * f
        qv[j] = (r[j, i] + r[i, j]) * f
        qv[k] = (r[k, i] + r[i, k]) * f
        q = np.array([w, qv[0], qv[1], qv[2]])
    q /= np.linalg.norm(q)
    return t, q, s


def from_param_matrix(values) -> Transform:
    """pbrt scene files store Transform/ConcatTransform matrices
    column-major; api.cpp transposes on read (pbrtTransform)."""
    m = np.asarray(values, dtype=np.float64).reshape(4, 4).T
    return Transform(m)
