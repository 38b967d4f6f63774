"""Texture evaluation over batched hit lanes (port of
tpurt/render/texeval.py: Perlin noise, the MIP pyramid with trilinear and
EWA lookups, the 2D mappings, eval_texture for constant, scale, mix,
bilerp, uv, checkerboard, dots, imagemap, fbm, wrinkled, windy and
marble, ptex (_load_ptex and _ptex_sample, as load_ptex and
_ptex_sample), bump mapping, and make_texture_eval).  A ptex file's
texel table is read and uploaded once a job, by make_texture_eval; its
lookups read the interactions' face index.

TextureRecords form a static DAG, so evaluation unrolls in Python into
tensor ops over the (N,) lanes.  Unlike tpurt, which evaluates every
textured slot on every lane and blends by material id, the evaluator here
runs each texture only on the lanes of its material (a boolean index):
the values are the same and the other lanes cost nothing.

EWA.  tpurt evaluates the elliptical filter in two tiers: every lane at
an anisotropy clamp of 2.9 over a window its own tests hold equal to a
static 13x13 tap window, and, where the texture's ``maxanisotropy``
exceeds 2.9, the lanes whose footprint ratio exceeds 2.9 again at that
anisotropy (at most 8) over a window held equal to 35x35 taps.  Its
block and strip texel layouts and its cap on the number of second-tier
lanes per batch serve the TPU's gather engine and XLA's static shapes;
they are not carried over.  Here each tier is one (lanes, taps*taps)
gather and a weighted sum per level, chunked to bound memory, and the
second tier takes every lane that needs it.
"""

from __future__ import annotations

import logging
import zlib
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from tpurt_torch.render.sampling_warps import cross, dot, norm
from tpurt_torch.scene.records import TextureRecord

log = logging.getLogger("tpurt_torch.render")

# Ken Perlin's canonical permutation (public domain reference noise).
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int32)
_PERM2 = np.concatenate([_PERM, _PERM]).astype(np.int64)


@lru_cache(maxsize=4)
def _perm_on(device: str):
    return torch.tensor(_PERM2, device=device)


def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) != 0, -u, u)
            + torch.where((h & 2) != 0, -v, v))


def perlin_noise(p):
    """Improved Perlin noise at (N,3) points, in [-1, 1]."""
    perm = _perm_on(str(p.device))
    pfl = torch.floor(p)
    pi = pfl.to(torch.int64) & 255
    pf = p - pfl
    x, y, z = pf[:, 0], pf[:, 1], pf[:, 2]

    def fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    u, v, w = fade(x), fade(y), fade(z)
    ix, iy, iz = pi[:, 0], pi[:, 1], pi[:, 2]
    a = perm[ix] + iy
    aa = perm[a] + iz
    ab = perm[a + 1] + iz
    b = perm[ix + 1] + iy
    ba = perm[b] + iz
    bb = perm[b + 1] + iz

    def lerp(t, a, b):
        return a + t * (b - a)

    return lerp(w,
                lerp(v, lerp(u, _grad(perm[aa], x, y, z),
                             _grad(perm[ba], x - 1, y, z)),
                     lerp(u, _grad(perm[ab], x, y - 1, z),
                          _grad(perm[bb], x - 1, y - 1, z))),
                lerp(v, lerp(u, _grad(perm[aa + 1], x, y, z - 1),
                             _grad(perm[ba + 1], x - 1, y, z - 1)),
                     lerp(u, _grad(perm[ab + 1], x, y - 1, z - 1),
                          _grad(perm[bb + 1], x - 1, y - 1, z - 1))))


def fbm(p, octaves: int, omega: float):
    """Fractional Brownian motion (texture.cpp FBm) with a fixed octave
    count, as in tpurt."""
    total = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max(1, octaves)):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, octaves: int, omega: float):
    total = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max(1, octaves)):
        total = total + o * perlin_noise(p * lam).abs()
        lam *= 1.99
        o *= omega
    return total


# ---------------------------------------------------------------------------
# image pyramid
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _load_image_pyramid(filename: str, gamma: bool):
    """MIPMap pyramid (mipmap.h): level 0 = full res, box-downsampled.
    read_image already linearizes 8-bit formats."""
    from tpurt_torch.io.image import read_image

    levels = [read_image(filename).astype(np.float32)]
    cur = levels[0]
    while max(cur.shape[0], cur.shape[1]) > 1:
        h2 = max(1, cur.shape[0] // 2)
        w2 = max(1, cur.shape[1] // 2)
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 3).mean((1, 3))
        levels.append(cur.astype(np.float32))
    return levels


@lru_cache(maxsize=64)
def _load_image_pyramid_flat(filename: str, gamma: bool):
    """Pyramid packed into one flat (D,3) array + per-level (offset, w,
    h): a per-lane MIP lookup is then one gather per tap."""
    levels = _load_image_pyramid(filename, gamma)
    offs, ws, hs, parts = [], [], [], []
    off = 0
    for lv in levels:
        h, w = lv.shape[:2]
        offs.append(off)
        ws.append(w)
        hs.append(h)
        parts.append(lv.reshape(-1, 3))
        off += h * w
    return (np.concatenate(parts).astype(np.float32),
            np.asarray(offs, np.int64), np.asarray(ws, np.int64),
            np.asarray(hs, np.int64))


@lru_cache(maxsize=64)
def _device_pyramid(filename: str, gamma: bool, device: str):
    """(flat (D,3) f32, offs, ws, hs (L,) i64) on ``device``, cached by
    file name like the host pyramid."""
    return tuple(torch.tensor(a, device=device) for a in
                 _load_image_pyramid_flat(filename, gamma))


def _wrap_index(i, n, wrap: str):
    if wrap == "repeat":
        return i % n
    return torch.minimum(i.clamp(min=0), n - 1)


def _trilinear_sample(filename: str, gamma: bool, u, v, width, wrap: str):
    """MIPMap::Lookup(st, width) trilinear: pick the level whose texel
    spacing matches the uv-space filter width and blend the two nearest
    levels.  width: (N,) per lane."""
    flat, offs, ws, hs = _device_pyramid(filename, gamma, str(u.device))
    n_levels = offs.shape[0]
    lvl = (n_levels - 1) + torch.log2(torch.clamp(width, min=1e-8))
    lvl = torch.clamp(lvl, 0.0, n_levels - 1)
    l0 = torch.floor(lvl).to(torch.int64)
    dl = lvl - l0.to(torch.float32)

    def sample_level(li):
        w_l, h_l, off = ws[li], hs[li], offs[li]
        x = u * w_l.to(torch.float32) - 0.5
        y = v * h_l.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]

        def fetch(xi, yi):
            idx = (off + _wrap_index(yi, h_l, wrap) * w_l
                   + _wrap_index(xi, w_l, wrap))
            val = flat[idx.clamp(0, flat.shape[0] - 1)]
            if wrap == "black":
                ok = (xi >= 0) & (xi < w_l) & (yi >= 0) & (yi < h_l)
                val = torch.where(ok[:, None], val, 0.0)
            return val

        top = fetch(x0, y0) * (1 - fx) + fetch(x0 + 1, y0) * fx
        bot = fetch(x0, y0 + 1) * (1 - fx) + fetch(x0 + 1, y0 + 1) * fx
        return top * (1 - fy) + bot * fy

    s0 = sample_level(l0)
    s1 = sample_level(torch.clamp(l0 + 1, max=n_levels - 1))
    return s0 * (1 - dl)[:, None] + s1 * dl[:, None]


# ---------------------------------------------------------------------------
# EWA
# ---------------------------------------------------------------------------

# First tier: a 13x13 window provably bounds the ellipse at an anisotropy
# clamp of 2.9 (the level choice puts the minor axis in [1, 2) texels, so
# the major half-axis is < 2 * 2.9 and, with EWA's +1 texel widening, the
# half-extent is < sqrt(5.8^2 + 1) < 6 = 13 // 2).
_EWA_MAX_ANISO = 2.9
_EWA_TAPS = 13
# Second tier: the reference's "maxanisotropy" default; 35 taps bound the
# aniso-8 ellipse the same way (sqrt(16^2 + 1) < 17 = 35 // 2).
_EWA_WIDE_ANISO = 8.0
_EWA_WIDE_TAPS = 35
# lanes * taps^2 per chunk of one level's gather (bounds transient memory)
_EWA_CHUNK_ELEMS = 1 << 23
_EXP_M2 = float(np.float32(np.exp(-2.0)))


def _ewa_level_taps(pyr, u, v, dst0, dst1, li, wrap: str,
                    taps: int = _EWA_TAPS):
    """EWA filter at one MIP level (MIPMap::EWA, mipmap.h): elliptical
    Gaussian weights over a (taps x taps) window centred at (u, v), as one
    gather of all the window's texels and one weighted sum."""
    chunk = max(1, _EWA_CHUNK_ELEMS // (taps * taps))
    if u.shape[0] > chunk:
        return torch.cat([
            _ewa_level_taps(pyr, u[s:s + chunk], v[s:s + chunk],
                            dst0[s:s + chunk], dst1[s:s + chunk],
                            li[s:s + chunk], wrap, taps)
            for s in range(0, u.shape[0], chunk)])
    flat, offs, ws, hs = pyr
    wi_i, hi_i, off = ws[li], hs[li], offs[li]
    w_l = wi_i.to(torch.float32)
    h_l = hi_i.to(torch.float32)
    # to texel coordinates at this level
    su = u * w_l - 0.5
    sv = v * h_l - 0.5
    d0u = dst0[:, 0] * w_l
    d0v = dst0[:, 1] * h_l
    d1u = dst1[:, 0] * w_l
    d1v = dst1[:, 1] * h_l
    # ellipse coefficients (mipmap.h EWA)
    A = d0v * d0v + d1v * d1v + 1.0
    B = -2.0 * (d0u * d0v + d1u * d1v)
    C = d0u * d0u + d1u * d1u + 1.0
    inv_f = 1.0 / (A * C - B * B * 0.25)
    A = A * inv_f
    B = B * inv_f
    C = C * inv_f

    cu = torch.round(su).to(torch.int64)
    cv = torch.round(sv).to(torch.int64)
    k = torch.arange(taps, device=u.device) - taps // 2
    ti = cu[:, None] + k[None, :]  # (n, taps) texel columns
    tj = cv[:, None] + k[None, :]  # (n, taps) texel rows
    uu = ti.to(torch.float32) - su[:, None]
    vv = tj.to(torch.float32) - sv[:, None]
    # r2[n, row, col] = A uu^2 + B uu vv + C vv^2
    r2 = ((A[:, None] * uu * uu)[:, None, :]
          + (B[:, None] * uu)[:, None, :] * vv[:, :, None]
          + (C[:, None] * vv * vv)[:, :, None])
    w = torch.where(r2 < 1.0,
                    torch.exp(-2.0 * torch.clamp(r2, max=1.0)) - _EXP_M2, 0.0)
    if wrap == "black":
        okb = (((ti >= 0) & (ti < wi_i[:, None]))[:, None, :]
               & ((tj >= 0) & (tj < hi_i[:, None]))[:, :, None])
        w = torch.where(okb, w, 0.0)
    xi = _wrap_index(ti, wi_i[:, None], wrap)
    yi = _wrap_index(tj, hi_i[:, None], wrap)
    idx = (off[:, None, None] + yi[:, :, None] * wi_i[:, None, None]
           + xi[:, None, :]).clamp(0, flat.shape[0] - 1)
    n = u.shape[0]
    acc = torch.einsum("nt,ntc->nc", w.reshape(n, -1),
                       flat[idx.reshape(n, -1)])
    wsum = w.reshape(n, -1).sum(dim=1)
    # degenerate ellipses (sub-texel): fall back to the centre texel
    cx = _wrap_index(cu, wi_i, wrap)
    cy = _wrap_index(cv, hi_i, wrap)
    centre = flat[(off + cy * wi_i + cx).clamp(0, flat.shape[0] - 1)]
    return torch.where((wsum > 1e-8)[:, None],
                       acc / torch.clamp(wsum, min=1e-8)[:, None], centre)


def _vec_len(v):
    return torch.sqrt(torch.clamp(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1],
                                  min=1e-24))


def _ewa_two_levels(pyr, u, v, major_v, minor_v, minor, wrap: str,
                    taps: int):
    """Level from the minor axis, blend of two EWA evaluations."""
    n_levels = pyr[1].shape[0]
    lod = torch.clamp((n_levels - 1)
                      + torch.log2(torch.clamp(minor, min=1e-8)),
                      0.0, n_levels - 1)
    li = torch.floor(lod).to(torch.int64)
    dl = lod - li.to(torch.float32)
    s0 = _ewa_level_taps(pyr, u, v, major_v, minor_v, li, wrap, taps)
    s1 = _ewa_level_taps(pyr, u, v, major_v, minor_v,
                         torch.clamp(li + 1, max=n_levels - 1), wrap, taps)
    return s0 * (1 - dl)[:, None] + s1 * dl[:, None]


def _ewa_sample(filename: str, gamma: bool, u, v, dst0, dst1, wrap: str,
                max_aniso: float = 8.0):
    """MIPMap::Lookup(st, dst0, dst1) (mipmap.h:56-63 + EWA): order the
    axes, clamp the anisotropy, pick the level from the minor axis, blend
    two EWA evaluations; in two tiers (module docstring).  A max_aniso of
    2.9 or less ends after the first tier."""
    pyr = _device_pyramid(filename, gamma, str(u.device))
    if wrap == "repeat":
        # tpurt's default path wraps the centre first; window and texels
        # shift together
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    swap = (dst0 * dst0).sum(dim=-1) < (dst1 * dst1).sum(dim=-1)
    major_v = torch.where(swap[:, None], dst1, dst0)
    minor_raw_v = torch.where(swap[:, None], dst0, dst1)
    major = _vec_len(major_v)
    minor_raw = _vec_len(minor_raw_v)

    def clamped_minor(aniso: float, major, minor_raw, minor_raw_v):
        scale = torch.where(minor_raw * aniso < major,
                            major / (minor_raw * aniso), 1.0)
        return minor_raw_v * scale[:, None], minor_raw * scale

    tier1 = min(float(max_aniso), _EWA_MAX_ANISO)
    minor_v, minor = clamped_minor(tier1, major, minor_raw, minor_raw_v)
    res = _ewa_two_levels(pyr, u, v, major_v, minor_v, minor, wrap,
                          _EWA_TAPS)
    if float(max_aniso) <= _EWA_MAX_ANISO:
        return res
    hi = major / torch.clamp(minor_raw, min=1e-12) > _EWA_MAX_ANISO
    if bool(hi.any()):
        minor_v, minor = clamped_minor(
            min(float(max_aniso), _EWA_WIDE_ANISO), major[hi],
            minor_raw[hi], minor_raw_v[hi])
        res[hi] = _ewa_two_levels(pyr, u[hi], v[hi], major_v[hi], minor_v,
                                  minor, wrap, _EWA_WIDE_TAPS)
    return res


# ---------------------------------------------------------------------------
# mappings and slots
# ---------------------------------------------------------------------------

def _apply_mapping2d(mapping: Dict, si):
    """TextureMapping2D::Map (texture.h:51-133)."""
    typ = mapping.get("type", "uv")
    if typ == "uv":
        u = si.uv[:, 0] * mapping["uscale"] + mapping["udelta"]
        v = si.uv[:, 1] * mapping["vscale"] + mapping["vdelta"]
        return u, v
    if typ == "planar":
        v1 = torch.tensor(mapping["v1"], dtype=torch.float32,
                          device=si.p.device)
        v2 = torch.tensor(mapping["v2"], dtype=torch.float32,
                          device=si.p.device)
        u = (si.p * v1).sum(-1) + mapping["udelta"]
        v = (si.p * v2).sum(-1) + mapping["vdelta"]
        return u, v
    if typ == "spherical":
        d = si.p / torch.clamp(norm(si.p, keepdim=True), min=1e-9)
        theta = torch.acos(torch.clamp(d[:, 2], -1, 1))
        phi = torch.atan2(d[:, 1], d[:, 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return theta / np.pi, phi / (2 * np.pi)
    if typ == "cylindrical":
        phi = torch.atan2(si.p[:, 1], si.p[:, 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return phi / (2 * np.pi), si.p[:, 2]
    raise ValueError(typ)


def _tex_p(rec: TextureRecord, si):
    """World -> texture-space point for 3D/noise textures."""
    if rec.world_to_texture is None:
        return si.p
    m = rec.world_to_texture.m.astype(np.float32)
    x, y, z = si.p[:, 0], si.p[:, 1], si.p[:, 2]
    return torch.stack([
        float(m[r, 0]) * x + float(m[r, 1]) * y + float(m[r, 2]) * z
        + float(m[r, 3]) for r in range(3)], dim=-1)


def _const3(val, n: int, device):
    arr = np.asarray(val, np.float32) * np.ones(3, np.float32)
    return torch.tensor(arr, device=device).expand(n, 3)


def _eval_slot(slot, si, want3: bool, ptex=None):
    """A ('constant', v) | ('texture', rec) slot -> (N,) or (N,3)."""
    kind, val = slot
    n = si.p.shape[0]
    if kind == "constant":
        if want3:
            return _const3(val, n, si.p.device)
        return torch.full((n,), float(np.asarray(val).reshape(-1)[0]),
                          dtype=torch.float32, device=si.p.device)
    return eval_texture(val, si, want3, ptex)


def _bilinear_sample(level: np.ndarray, u, v, wrap: str):
    h, w = level.shape[:2]
    img = torch.tensor(level, device=u.device)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0

    def wrapc(i, n):
        if wrap == "repeat":
            return i % n
        return i.clamp(0, n - 1)  # black: masked below

    def fetch(xi, yi):
        val = img[wrapc(yi, h), wrapc(xi, w)]
        if wrap == "black":
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            val = torch.where(ok[:, None], val, 0.0)
        return val

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx)[:, None] + c10 * fx[:, None]
    bot = c01 * (1 - fx)[:, None] + c11 * fx[:, None]
    return top * (1 - fy)[:, None] + bot * fy[:, None]


_MARBLE_C1 = (0.58, 0.58, 0.6)
_MARBLE_C2 = (0.88, 0.85, 0.82)

TEXTURE_NAMES = ("constant", "scale", "mix", "bilerp", "uv", "checkerboard",
                 "dots", "imagemap", "fbm", "wrinkled", "windy", "marble",
                 "ptex")


# ---------------------------------------------------------------------------
# ptex
# ---------------------------------------------------------------------------

def load_ptex(filename: str):
    """A Ptex file as flat host arrays: (texels (T, 3) f32, face offset
    (F,) i64, face res u (F,) i64, face res v (F,) i64) (tpurt's
    _load_ptex, texeval.py:730-755).  One- and two-channel files
    replicate to three (fromResult, ptex.cpp:113-135).  A missing or
    unreadable file raises ValueError naming the texture and the file:
    tpurt renders 0.5 gray."""
    from tpurt_torch.io.ptex import read_ptex

    if not filename:
        raise ValueError('Texture "ptex": no "string filename" given')
    try:
        data = read_ptex(filename)
    except (OSError, ValueError, RuntimeError, zlib.error) as e:
        raise ValueError(f'Texture "ptex": file "{filename}": {e}') from e
    offs = np.zeros(data.nfaces, np.int64)
    rus = np.zeros(data.nfaces, np.int64)
    rvs = np.zeros(data.nfaces, np.int64)
    parts = []
    t = 0
    for i, face in enumerate(data.faces):
        rv, ru, nc = face.shape
        if nc == 1:
            face = np.repeat(face, 3, axis=2)
        elif nc == 2:
            face = np.concatenate([face, face[:, :, :1]], axis=2)
        offs[i], rus[i], rvs[i] = t, ru, rv
        parts.append(face[:, :, :3].reshape(-1, 3))
        t += ru * rv
    return (np.concatenate(parts).astype(np.float32), offs, rus, rvs)


def _ptex_sample(tab, gamma: float, face_index, u, v):
    """Per-face bilinear lookup at level 0 with clamped face-local uv
    (tpurt's _ptex_sample, texeval.py:757-790; the reference filters with
    Ptex's bspline over the footprint and across faces, tpurt does not).
    Gamma is applied after filtering, to values in [0, 1]
    (ptex.cpp:154-158).  tab: load_ptex's arrays on the lanes' device."""
    texels, offs, rus, rvs = tab
    fi = torch.clamp(face_index.long(), 0, offs.shape[0] - 1)
    off = offs[fi]
    ru = rus[fi]
    rv = rvs[fi]
    x = torch.clamp(u, 0.0, 1.0) * ru.to(torch.float32) - 0.5
    y = torch.clamp(v, 0.0, 1.0) * rv.to(torch.float32) - 0.5
    x0 = torch.minimum(torch.floor(x).long().clamp(min=0), ru - 1)
    y0 = torch.minimum(torch.floor(y).long().clamp(min=0), rv - 1)
    x1 = torch.minimum(x0 + 1, ru - 1)
    y1 = torch.minimum(y0 + 1, rv - 1)
    fx = torch.clamp(x - x0.to(torch.float32), 0.0, 1.0)[:, None]
    fy = torch.clamp(y - y0.to(torch.float32), 0.0, 1.0)[:, None]

    def fetch(xi, yi):
        return texels[off + yi * ru + xi]

    out = ((1 - fx) * (1 - fy) * fetch(x0, y0)
           + fx * (1 - fy) * fetch(x1, y0)
           + (1 - fx) * fy * fetch(x0, y1)
           + fx * fy * fetch(x1, y1))
    if gamma != 1.0:
        out = torch.where((out >= 0) & (out <= 1),
                          torch.pow(torch.clamp(out, min=1e-10), gamma), out)
    return out


def _ptex_files(rec: TextureRecord, out: set) -> set:
    """The ptex file names of the texture DAG under ``rec``."""
    if rec.name == "ptex":
        out.add(rec.params["filename"])
    for v in rec.params.values():
        if isinstance(v, tuple) and len(v) == 2 and isinstance(
                v[1], TextureRecord):
            _ptex_files(v[1], out)
    return out


def eval_texture(rec: TextureRecord, si, want3: bool, ptex=None):
    """Evaluate a TextureRecord over the hit lanes ``si`` (p, uv and,
    where the scene filters textures, tex_wu/tex_wv/tex_dst0/tex_dst1;
    face_index where it holds a ptex texture).  ptex: {file name: the
    device texel table of load_ptex_tables}."""
    n = si.p.shape[0]
    dev = si.p.device
    prm = rec.params
    name = rec.name

    def as_out(x):
        if want3 and x.ndim == 1:
            return x[:, None].expand(n, 3)
        if not want3 and x.ndim == 2:
            return x.mean(-1)
        return x

    def zeros():
        return as_out(torch.zeros(n, dtype=torch.float32, device=dev))

    if name == "constant":
        if want3:
            return _const3(prm["value"], n, dev)
        return torch.full((n,), float(np.asarray(prm["value"],
                                                 np.float32).reshape(-1)[0]),
                          dtype=torch.float32, device=dev)
    if name == "scale":
        return as_out(_eval_slot(prm["tex1"], si, want3, ptex)
                      * _eval_slot(prm["tex2"], si, want3, ptex))
    if name == "mix":
        amt = _eval_slot(prm["amount"], si, False, ptex)
        t1 = _eval_slot(prm["tex1"], si, want3, ptex)
        t2 = _eval_slot(prm["tex2"], si, want3, ptex)
        a = amt[:, None] if want3 else amt
        return t1 * (1 - a) + t2 * a
    if name == "bilerp":
        u, v = _apply_mapping2d(prm["mapping"], si)
        v00 = _eval_slot(prm["v00"], si, want3, ptex)
        v01 = _eval_slot(prm["v01"], si, want3, ptex)
        v10 = _eval_slot(prm["v10"], si, want3, ptex)
        v11 = _eval_slot(prm["v11"], si, want3, ptex)
        uu = u[:, None] if want3 else u
        vv = v[:, None] if want3 else v
        return ((1 - uu) * (1 - vv) * v00 + (1 - uu) * vv * v01
                + uu * (1 - vv) * v10 + uu * vv * v11)
    if name == "uv":
        u, v = _apply_mapping2d(prm["mapping"], si)
        return as_out(torch.stack([u - torch.floor(u), v - torch.floor(v),
                                   torch.zeros_like(u)], dim=-1))
    if name == "checkerboard":
        tex1 = _eval_slot(prm["tex1"], si, want3, ptex)
        tex2 = _eval_slot(prm["tex2"], si, want3, ptex)
        if prm["dimension"] == 2:
            u, v = _apply_mapping2d(prm["mapping"], si)
            cell = torch.floor(u) + torch.floor(v)
        else:
            p = _tex_p(rec, si)
            cell = (torch.floor(p[:, 0]) + torch.floor(p[:, 1])
                    + torch.floor(p[:, 2]))
        even = cell.to(torch.int32) % 2 == 0
        point = torch.where(even[:, None] if want3 else even, tex1, tex2)
        have_diff = si.tex_dst0 is not None or si.tex_wu is not None
        if (prm["dimension"] == 2 and have_diff
                and prm.get("aamode", "closedform") == "closedform"):
            # Closed-form box-filtered checker (checkerboard.cpp:101-140):
            # where the filter extent (ds, dt) spans a check boundary,
            # blend tex1/tex2 by the box-filtered area of the step
            # function via its integral bumpInt.
            mp = prm["mapping"]
            if mp.get("type", "uv") == "uv":
                su_s = abs(mp.get("uscale", 1.0))
                sv_s = abs(mp.get("vscale", 1.0))
            else:
                su_s = sv_s = 1.0  # tex_dst covers the uv mapping only
            if si.tex_dst0 is not None:
                ds = torch.maximum(si.tex_dst0[:, 0].abs(),
                                   si.tex_dst1[:, 0].abs()) * su_s
                dt_ = torch.maximum(si.tex_dst0[:, 1].abs(),
                                    si.tex_dst1[:, 1].abs()) * sv_s
            else:
                ds = si.tex_wu * su_s
                dt_ = si.tex_wv * sv_s
            ds = torch.clamp(ds, min=1e-8)
            dt_ = torch.clamp(dt_, min=1e-8)
            s_lo, s_hi = u - ds, u + ds
            t_lo, t_hi = v - dt_, v + dt_
            one_check = ((torch.floor(s_lo) == torch.floor(s_hi))
                         & (torch.floor(t_lo) == torch.floor(t_hi)))

            def bump_int(x):
                return (torch.floor(x / 2) + 2 * torch.clamp(
                    x / 2 - torch.floor(x / 2) - 0.5, min=0.0))

            sint = (bump_int(s_hi) - bump_int(s_lo)) / (2 * ds)
            tint = (bump_int(t_hi) - bump_int(t_lo)) / (2 * dt_)
            area2 = sint + tint - 2 * sint * tint
            area2 = torch.where((ds > 1) | (dt_ > 1), 0.5, area2)
            a = area2[:, None] if want3 else area2
            filtered = tex1 * (1 - a) + tex2 * a
            return torch.where(one_check[:, None] if want3 else one_check,
                               point, filtered)
        return point
    if name == "dots":
        u, v = _apply_mapping2d(prm["mapping"], si)
        # per-cell noise decides presence and centre
        su, sv = torch.floor(u + 0.5), torch.floor(v + 0.5)
        cell = torch.stack([su + 0.5, sv + 0.5, torch.zeros_like(su)], -1)
        has_dot = perlin_noise(cell) > 0

        def shifted(dx, dy):
            return cell + torch.tensor([dx, dy, 0.0], dtype=torch.float32,
                                       device=dev)

        cx = su + 0.35 * perlin_noise(shifted(1.5, 2.8))
        cy = sv + 0.35 * perlin_noise(shifted(4.5, 9.8))
        du, dv = u - cx, v - cy
        inside = has_dot & (du * du + dv * dv < 0.35 * 0.35)
        t1 = _eval_slot(prm["inside"], si, want3, ptex)
        t2 = _eval_slot(prm["outside"], si, want3, ptex)
        return torch.where(inside[:, None] if want3 else inside, t1, t2)
    if name == "ptex":
        if prm["filename"] not in (ptex or {}):
            raise ValueError(f'Texture "ptex": file "{prm["filename"]}" is '
                             "not loaded (make_texture_eval loads it)")
        face = (si.face_index if si.face_index is not None
                else torch.zeros(n, dtype=torch.int32, device=dev))
        return as_out(_ptex_sample(ptex[prm["filename"]],
                                   float(prm.get("gamma", 2.2)), face,
                                   si.uv[:, 0], si.uv[:, 1]))
    if name == "imagemap":
        fname = prm["filename"]
        if not fname:
            return zeros()
        gamma = prm.get("gamma", False)
        try:
            pyr = _load_image_pyramid(fname, gamma)
        except (OSError, ValueError) as e:
            log.error("imagemap %s unreadable: %s", fname, e)
            return zeros()
        u, v = _apply_mapping2d(prm["mapping"], si)
        wrap = prm.get("wrap", "repeat")
        mp = prm["mapping"]
        is_uv = mp.get("type", "uv") == "uv"
        su = abs(mp.get("uscale", 1.0)) if is_uv else 1.0
        sv = abs(mp.get("vscale", 1.0)) if is_uv else 1.0
        if si.tex_dst0 is not None:
            # anisotropic EWA from ray differentials (camera hits) or the
            # isotropic cone (indirect); mapping scales stretch the
            # derivative vectors in uv space
            sc = torch.tensor([su, sv], dtype=torch.float32, device=dev)
            rgb = _ewa_sample(fname, gamma, u, v, si.tex_dst0 * sc,
                              si.tex_dst1 * sc, wrap,
                              max_aniso=float(prm.get("maxanisotropy", 8.0)))
        elif si.tex_wu is not None:
            # trilinear MIP filtering from the ray-footprint width
            width = torch.maximum(si.tex_wu * su, si.tex_wv * sv)
            rgb = _trilinear_sample(fname, gamma, u, v, width, wrap)
        else:
            rgb = _bilinear_sample(pyr[0], u, v, wrap)
        return as_out(rgb * prm.get("scale", 1.0))
    if name == "fbm":
        return as_out(fbm(_tex_p(rec, si), prm["octaves"], prm["roughness"]))
    if name == "wrinkled":
        return as_out(turbulence(_tex_p(rec, si), prm["octaves"],
                                 prm["roughness"]))
    if name == "windy":
        p = _tex_p(rec, si)
        return as_out(fbm(0.1 * p, 3, 0.5).abs() * fbm(p, 6, 0.5))
    if name == "marble":
        p = _tex_p(rec, si) * prm["scale"]
        marble = p[:, 1] + prm["variation"] * fbm(p, prm["octaves"],
                                                  prm["roughness"])
        t = 0.5 + 0.5 * torch.sin(marble)
        # tpurt's warm ramp in place of pbrt's marble spline
        c1 = torch.tensor(_MARBLE_C1, dtype=torch.float32, device=dev)
        c2 = torch.tensor(_MARBLE_C2, dtype=torch.float32, device=dev)
        return as_out(c1 * (1 - t[:, None]) + c2 * t[:, None])
    raise NotImplementedError(f'Texture "{name}"')


def check_texture(rec: TextureRecord) -> None:
    """Raise NotImplementedError, naming it, for any texture class in the
    DAG under ``rec`` that eval_texture does not evaluate."""
    if rec.name not in TEXTURE_NAMES:
        raise NotImplementedError(f'Texture "{rec.name}"')
    for v in rec.params.values():
        if isinstance(v, tuple) and len(v) == 2 and isinstance(
                v[1], TextureRecord):
            check_texture(v[1])


# ---------------------------------------------------------------------------
# the evaluator a render job carries
# ---------------------------------------------------------------------------

def _take(si, sel):
    """The lanes of ``si`` picked by the boolean mask ``sel``."""
    return type(si)(*[None if f is None else f[sel] for f in si])


def _textured_records(records, slot_names):
    out = []
    for i, r in enumerate(records):
        if r is None:
            continue
        for name in slot_names:
            s = r.slots.get(name)
            if isinstance(s, tuple) and s[0] == "texture":
                out.append((i, name, s[1]))
    return out


def make_bump_eval(records, ptex=None):
    """Material::Bump (material.cpp:50-87) as a wavefront pass: evaluate
    the displacement texture at uv, uv+du and uv+dv (the reference's
    constant fallback du = .0005) and rebuild the shading normal from the
    displaced dpdu/dpdv.  Returns None when no material has a bump map.
    ptex: the job's ptex tables (eval_texture's)."""
    recs = [(i, rec) for i, _n, rec in _textured_records(records,
                                                         ("bumpmap",))]
    if not recs:
        return None

    def apply(si):
        if si.dpdu is None:
            return si
        du = 5e-4
        ns_new = si.ns.clone()
        for mat_idx, rec in recs:
            m = (si.material_id == mat_idx) & si.valid
            if not bool(m.any()):
                continue
            s = _take(si, m)
            dev = s.p.device
            disp = eval_texture(rec, s, False, ptex)
            e_u = torch.tensor([5e-4, 0.0], dtype=torch.float32, device=dev)
            e_v = torch.tensor([0.0, 5e-4], dtype=torch.float32, device=dev)
            ud = eval_texture(rec, s._replace(uv=s.uv + e_u,
                                              p=s.p + du * s.dpdu), False,
                              ptex)
            vd = eval_texture(rec, s._replace(uv=s.uv + e_v,
                                              p=s.p + du * s.dpdv), False,
                              ptex)
            dpdu2 = s.dpdu + ((ud - disp) / du)[:, None] * s.ns
            dpdv2 = s.dpdv + ((vd - disp) / du)[:, None] * s.ns
            n2 = cross(dpdu2, dpdv2)
            n2 = n2 / torch.clamp(norm(n2, keepdim=True), min=1e-12)
            # keep the original orientation (Faceforward in Bump)
            n2 = torch.where((dot(n2, s.ns) < 0)[:, None], -n2, n2)
            ns_new[m] = n2
        return si._replace(ns=ns_new)

    return apply


class TexEval:
    """Per-wavefront texture callbacks: calling it gives the fetch_lobes
    overrides; ``bump`` (optional) perturbs the shading normals.
    ``has_ptex``: a texture reads the interactions' face index."""

    def __init__(self, overrides_fn, bump_fn, has_ptex: bool = False):
        self._fn = overrides_fn
        self.bump = bump_fn
        self.has_ptex = has_ptex

    def __call__(self, si):
        return self._fn(si) if self._fn is not None else None


_COL3 = ("Kd", "Ks", "Kr", "Kt")


def make_texture_eval(records, textured, mt_table) -> Optional[TexEval]:
    """The texture callbacks of a render job.  records: the material
    records (index == material id); textured: build_material_table's
    [(material id, slot)]; mt_table: the fused table on the device (the
    untextured lanes keep its values).  Returns None when no material has
    a textured slot or a bump map.

    Only the slots fetch_lobes reads are evaluated.  tpurt's slot maps
    (texeval.py:1136-1158) also evaluate "reflect" and "transmit" into
    overrides fetch_lobes never reads, and skip "eta", "k", "opacity", a
    mix's "amount", "uroughness", "vroughness" and the Disney parameters:
    either way the table's default renders.  The port renders the same
    default and logs a warning naming the slot."""
    from tpurt_torch.render.materials_build import (C_KD0, C_KR0, C_KS0,
                                                    C_KT0, C_ROUGH, C_SIGMA)

    cols = {"Kd": C_KD0, "Ks": C_KS0, "Kr": C_KR0, "Kt": C_KT0,
            "roughness": C_ROUGH, "sigma": C_SIGMA}
    slots = []
    for i, name in textured:
        rec = records[i].slots[name] if records[i] is not None else None
        if not (isinstance(rec, tuple) and rec[0] == "texture"):
            continue  # a slot held as None (metal's unset u/v roughness)
        check_texture(rec[1])
        col = cols.get(name)
        if col is None:
            log.warning('textured "%s" on Material "%s" is not read by the '
                        'renderer (as in tpurt); using its default', name,
                        records[i].name)
            continue
        slots.append((i, name, rec[1], col))
    bumps = [rec for _i, _name, rec in _textured_records(records,
                                                         ("bumpmap",))]
    files = set()
    for rec in bumps:
        check_texture(rec)
    for rec in bumps + [rec for _i, _n, rec, _c in slots]:
        _ptex_files(rec, files)
    # each ptex file's texel table, uploaded once a job
    dev = mt_table.device
    ptex = {f: tuple(torch.tensor(a, device=dev) for a in load_ptex(f))
            for f in sorted(files)}
    bump = make_bump_eval(records, ptex)
    if not slots:
        return TexEval(None, bump, bool(ptex)) if bump is not None else None

    def evaluate(si):
        overrides = {}
        row = None
        for mat_idx, slot, rec, c in slots:
            want3 = slot in _COL3
            if slot not in overrides:
                if row is None:
                    row = mt_table[si.material_id.clamp(min=0).long()]
                overrides[slot] = (row[:, c:c + 3] if want3
                                   else row[:, c]).clone()
            m = si.material_id == mat_idx
            if bool(m.any()):
                overrides[slot][m] = eval_texture(rec, _take(si, m), want3,
                                                  ptex)
        return overrides

    return TexEval(evaluate, bump, bool(ptex))
