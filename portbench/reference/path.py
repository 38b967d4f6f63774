"""The reference's sampling pass: every sample of a set of pixels traced
by the unidirectional path estimator that the RPF integrator runs, with
the sample's RPF features, as one row of 19 floats (the layout of
RayTracer-RPF's ``SampleData``, ``custom/sd.h``):
[0:2] the film position, [2:5] the radiance, [5:7] the lens sample (the
random parameters), [7:10] the geometric normal and [10:13] the point of
the first hit, [13:16] and [16:19] those of the second (zeros where the
path has no such hit).

The estimator (pbrt-v3's PathIntegrator, ``integrators/path.cpp``, with
the choices tpurt documents for its wavefront form):
- the camera: pbrt-v3's PerspectiveCamera (``cameras/perspective.cpp``),
  film position = pixel + (dimension 0, dimension 1), the lens sample
  dimensions 3 and 4, no lens;
- bounce b (0 .. maxdepth) draws dimensions 5 + 7b + (0: light choice,
  1-2: the light sample, 3: the lobe choice, 4-5: the BSDF sample,
  6: Russian roulette);
- at a hit: emitted radiance, weighted against light sampling by the
  power heuristic (the BSDF-sampled half of next-event estimation); past
  maxdepth nothing more; then one light chosen uniformly, sampled by the
  sphere's cone of directions (pbrt-v3 ``shapes/sphere.cpp``
  Sphere::Sample(ref, u)), weighted by the power heuristic; then one
  lobe chosen uniformly among the material's (pbrt-v3 BSDF::Sample_f),
  its direction sampled; Russian roulette after bounce 3 with
  q = max(0.05, 1 - max(beta)).
- materials (pbrt-v3 ``materials/matte.cpp``, ``plastic.cpp``): matte a
  Lambertian lobe; plastic a Lambertian lobe plus a Trowbridge-Reitz
  microfacet reflection (``core/microfacet.cpp``; roughness remapped by
  RoughnessToAlpha; directions from the distribution of visible normals
  of Heitz 2018, "Sampling the GGX Distribution of Visible Normals",
  JCGT 7(4)) under the Fresnel reflectance of a dielectric of index 1.5
  seen from outside.  The shading frame is the orthonormal basis of the
  geometric normal of Duff et al. 2017, "Building an Orthonormal Basis,
  Revisited", JCGT 6(1).
- spawned rays leave the surface by 2e-4 max(1, |p|_inf) along the
  normal on the side of their direction; a shadow ray stops short of its
  light point by a share 1e-4 of the distance and 2e-3 max(1, |p_light|).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CAMERA_DIMS = 5
DIMS_PER_BOUNCE = 7
INV_PI = 1.0 / math.pi
EPS = 1e-9


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                    keepdim=True), min=1e-20)


def onb(n):
    """Duff et al. 2017: (t, b) completing the unit normals n (N, 3)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], -1)
    bt = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return t, bt


def camera_rays(scene, p_film, device, dtype=torch.float32):
    """pbrt-v3 PerspectiveCamera::GenerateRay, worked in float64: (o, d)
    world rays in ``dtype`` through the raster points ``p_film`` (N, 2)."""
    rx, ry = scene.res
    aspect = rx / ry
    x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1
                      else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
    tan = math.tan(math.radians(scene.fov) / 2)
    pf = p_film.double()
    xs = x0 + pf[:, 0] / rx * (x1 - x0)
    ys = y1 - pf[:, 1] / ry * (y1 - y0)
    dc = torch.stack([xs * tan, ys * tan, torch.ones_like(xs)], -1)
    m = torch.tensor(scene.camera_to_world, dtype=torch.float64,
                     device=device)
    dw = normalize(dc @ m[:3, :3].T)
    o = m[:3, 3].expand_as(dw)
    return o.to(dtype), dw.to(dtype)


# -- BSDF --------------------------------------------------------------------

def roughness_to_alpha(r):
    x = math.log(max(r, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = cos_i.clamp(-1.0, 1.0)
    enter = cos_i > 0
    ei = torch.where(enter, eta_i, eta_t)
    et = torch.where(enter, eta_t, eta_i)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt((1 - ci * ci).clamp(min=0))
    ct = torch.sqrt((1 - sin_t * sin_t).clamp(min=0))
    rpar = (et * ci - ei * ct) / (et * ci + ei * ct)
    rperp = (ei * ci - et * ct) / (ei * ci + et * ct)
    return torch.where(sin_t >= 1, 1.0, 0.5 * (rpar * rpar + rperp * rperp))


def ggx_d(wh, a):
    t = (wh[:, 0] ** 2 + wh[:, 1] ** 2) / (a * a) + wh[:, 2] ** 2
    return 1.0 / (math.pi * a * a * t * t)


def ggx_lambda(w, a):
    c2 = w[:, 2] ** 2
    tan2 = (1 - c2).clamp(min=0) / c2.clamp(min=1e-30)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a * a * tan2))


def ggx_sample(wo, a, u1, u2):
    """Heitz 2018's visible-normal sample for wo on either side."""
    flip = wo[:, 2] < 0
    w = torch.where(flip[:, None], -wo, wo)
    vh = normalize(torch.stack([a * w[:, 0], a * w[:, 1], w[:, 2]], -1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    il = 1.0 / torch.sqrt(lensq.clamp(min=1e-30))
    t1 = torch.where((lensq > 0)[:, None],
                     torch.stack([-vh[:, 1] * il, vh[:, 0] * il,
                                  torch.zeros_like(il)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=wo.device))
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1 - s) * torch.sqrt((1 - p1 * p1).clamp(min=0)) + s * p2
    nh = (p1[:, None] * t1 + p2[:, None] * t2
          + torch.sqrt((1 - p1 * p1 - p2 * p2).clamp(min=0))[:, None] * vh)
    wh = normalize(torch.stack([a * nh[:, 0], a * nh[:, 1],
                                nh[:, 2].clamp(min=0)], -1))
    return torch.where(flip[:, None], -wh, wh)


def concentric_disk(u1, u2):
    ux, uy = 2 * u1 - 1, 2 * u2 - 1
    big_x = ux.abs() > uy.abs()
    r = torch.where(big_x, ux, uy)
    th = torch.where(big_x, (math.pi / 4) * uy / torch.where(ux == 0, 1.0, ux),
                     math.pi / 2 - (math.pi / 4) * ux
                     / torch.where(uy == 0, 1.0, uy))
    zero = (ux == 0) & (uy == 0)
    return (torch.where(zero, 0.0, r * torch.cos(th)),
            torch.where(zero, 0.0, r * torch.sin(th)))


class Lobes:
    """Per-lane matte / plastic lobes in the local frame (+z the normal)."""

    def __init__(self, kd, ks, alpha):
        self.kd, self.ks, self.alpha = kd, ks, alpha
        self.diff = (kd > 0).any(-1)
        self.gloss = (ks > 0).any(-1)
        self.n = self.diff.float() + self.gloss.float()

    def f_pdf(self, wo, wi):
        same = wo[:, 2] * wi[:, 2] > 0
        co, ci = wo[:, 2].abs(), wi[:, 2].abs()
        f_d = self.kd * INV_PI
        pdf_d = ci * INV_PI
        wh = wo + wi
        whl = torch.linalg.vector_norm(wh, dim=-1)
        wh = wh / whl.clamp(min=EPS)[:, None]
        a = self.alpha
        d = ggx_d(wh, a)
        g = 1.0 / (1.0 + ggx_lambda(wo, a) + ggx_lambda(wi, a))
        wh_up = torch.where(wh[:, 2:3] < 0, -wh, wh)
        fr = fr_dielectric(dot(wi, wh_up), torch.ones_like(co),
                           torch.full_like(co, 1.5))
        ok_g = (ci > EPS) & (co > EPS) & (whl > EPS)
        f_g = self.ks * (fr * d * g / (4 * ci * co).clamp(min=EPS))[:, None]
        g1 = 1.0 / (1.0 + ggx_lambda(wo, a))
        pdf_g = d * g1 / co.clamp(min=EPS) / 4.0
        f = (torch.where((self.diff & same)[:, None], f_d, 0.0)
             + torch.where((self.gloss & same & ok_g)[:, None], f_g, 0.0))
        pdf = (torch.where(self.diff & same, pdf_d, 0.0)
               + torch.where(self.gloss & same & (whl > EPS), pdf_g, 0.0))
        return f, torch.where(self.n > 0, pdf / self.n.clamp(min=1), 0.0)

    def sample(self, wo, u_lobe, u1, u2):
        target = torch.minimum((u_lobe * self.n).long(),
                               (self.n.long() - 1).clamp(min=0))
        take_gloss = self.gloss & ((target == 1) | ~self.diff)
        x, y = concentric_disk(u1, u2)
        z = torch.sqrt((1 - x * x - y * y).clamp(min=0))
        wi_d = torch.stack([x, y, torch.where(wo[:, 2] < 0, -z, z)], -1)
        wh = ggx_sample(wo, self.alpha, u1, u2)
        wi_g = -wo + 2 * dot(wo, wh)[:, None] * wh
        wi = torch.where(take_gloss[:, None], wi_g, wi_d)
        f, pdf = self.f_pdf(wo, wi)
        bad = (self.n == 0) | (pdf <= 0)
        return wi, torch.where(bad[:, None], 0.0, f), torch.where(bad, 0.0,
                                                                  pdf)


def power(f, g):
    return torch.where(f * f + g * g > 0, f * f / (f * f + g * g), 0.0)


def offset(p, ng, w):
    eps = 2e-4 * p.abs().amax(-1).clamp(min=1.0)
    sign = torch.where(dot(ng, w) >= 0, 1.0, -1.0)
    return p + (sign * eps)[:, None] * ng


class Tracer:
    """The scene's lights, materials and ray queries on ``device``."""

    def __init__(self, scene, geom, sampler):
        self.scene, self.geom, self.sampler = scene, geom, sampler
        dev, dt = geom.device, geom.dtype
        self.dtype = dt
        mats = scene.materials
        self.mat_kd = torch.tensor([m.kd for m in mats], device=dev).to(dt)
        self.mat_ks = torch.tensor([m.ks for m in mats], device=dev).to(dt)
        self.mat_alpha = torch.tensor(
            [roughness_to_alpha(m.roughness) if m.remap
             else max(m.roughness, 1e-3) for m in mats],
            device=dev).to(dt)
        lt = scene.lights
        self.n_lights = len(lt)
        self.l_c = torch.tensor(np.array([x["center"] for x in lt],
                                         np.float32), device=dev).to(dt)
        self.l_r = torch.tensor([x["radius"] for x in lt],
                                device=dev).to(dt)
        self.l_L = torch.tensor([x["L"] for x in lt], device=dev).to(dt)
        self.l_two = torch.tensor([bool(x["two_sided"]) for x in lt],
                                  device=dev)

    def u(self, lanes, d: int):
        x, y, s = lanes
        return torch.tensor(self.sampler.dim(x, y, s, d),
                            device=self.geom.device).to(self.dtype)

    def interaction(self, hit, o, d):
        g = self.geom
        valid = hit["hit"]
        prim = hit["prim"].clamp(min=0)
        v = g.tri_v[prim]
        p_tri = (hit["b0"][:, None] * v[:, 0] + hit["b1"][:, None] * v[:, 1]
                 + hit["b2"][:, None] * v[:, 2])
        n_tri = normalize(torch.linalg.cross(v[:, 0] - v[:, 2],
                                             v[:, 1] - v[:, 2]))
        sph = hit["sphere"]
        is_s = sph >= 0
        p_ray = o + hit["t"].to(self.dtype)[:, None] * d
        n_sph = normalize(p_ray - g.sph_c[sph.clamp(min=0)].to(self.dtype))
        p = torch.where(is_s[:, None], p_ray, p_tri)
        n = torch.where(is_s[:, None], n_sph, n_tri)
        mat = torch.where(is_s, g.sph_mat[sph.clamp(min=0)],
                          g.tri_mat[prim])
        light = torch.where(is_s, g.sph_light[sph.clamp(min=0)], -1)
        return valid, p, n, mat, torch.where(valid, light, -1)

    def sample_light(self, p, u_choice, u1, u2):
        """(wi, Li, pdf, p_light, pmf): uniform choice, cone sampling."""
        k = torch.clamp((u_choice * self.n_lights).long(),
                        max=self.n_lights - 1)
        c, r = self.l_c[k], self.l_r[k]
        to_c = c - p
        dc2 = dot(to_c, to_c)
        dc = torch.sqrt(dc2)
        wz = to_c / dc[:, None]
        tx, ty = onb(wz)
        cos_max = torch.sqrt((1 - r * r / dc2).clamp(0, 1))
        cos_t = (1 - u1) + u1 * cos_max
        sin_t = torch.sqrt((1 - cos_t * cos_t).clamp(min=0))
        phi = 2 * math.pi * u2
        wi = (tx * (torch.cos(phi) * sin_t)[:, None]
              + ty * (torch.sin(phi) * sin_t)[:, None] + wz * cos_t[:, None])
        ds = dc * cos_t - torch.sqrt((r * r - dc2 * sin_t * sin_t)
                                     .clamp(min=0))
        pl = p + ds[:, None] * wi
        nl = normalize(pl - c)
        pl = c + r[:, None] * nl
        pdf = 1.0 / (2 * math.pi * (1 - cos_max).clamp(min=1e-9))
        outside = dc2 > r * r * (1 + 1e-4)
        emits = self.l_two[k] | (dot(nl, -wi) > 0)
        li = torch.where((emits & outside)[:, None], self.l_L[k], 0.0)
        return wi, li, torch.where(outside, pdf, 0.0), pl, 1.0 / self.n_lights

    def light_pdf(self, k, p):
        c, r = self.l_c[k], self.l_r[k]
        to_c = c - p
        dc2 = dot(to_c, to_c)
        cos_max = torch.sqrt((1 - r * r / dc2).clamp(0, 1))
        return 1.0 / (2 * math.pi * (1 - cos_max).clamp(min=1e-9))

    def trace(self, lanes):
        """The rows (N, 19) of the lanes (x, y, s) (host int arrays)."""
        sc, g = self.scene, self.geom
        dev = g.device
        n, dt = len(lanes[0]), self.dtype
        xs = torch.tensor(lanes[0], device=dev, dtype=dt)
        ys = torch.tensor(lanes[1], device=dev, dtype=dt)
        p_film = torch.stack([xs + self.u(lanes, 0), ys + self.u(lanes, 1)],
                             -1)
        p_lens = torch.stack([self.u(lanes, 3), self.u(lanes, 4)], -1)
        o, d = camera_rays(sc, p_film, dev, dt)
        inf = torch.full((n,), float("inf"), device=dev, dtype=dt)
        hit = g.closest(o, d, inf)
        z3 = torch.zeros((n, 3), device=dev, dtype=dt)
        beta, L = z3 + 1.0, z3.clone()
        feats = [z3.clone() for _ in range(4)]
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        prev_pdf, prev_p = torch.ones(n, device=dev, dtype=dt), o
        for b in range(sc.maxdepth + 1):
            valid, p, ng, mat, light = self.interaction(hit, o, d)
            wo = -d
            if b < 2:
                m = (alive & valid)[:, None]
                feats[2 * b] = torch.where(m, ng, feats[2 * b])
                feats[2 * b + 1] = torch.where(m, p, feats[2 * b + 1])
            # emitted radiance
            lk = light.clamp(min=0)
            le = torch.where(((light >= 0) & (self.l_two[lk]
                                              | (dot(ng, wo) > 0)))[:, None],
                             self.l_L[lk], 0.0)
            w = (torch.ones(n, device=dev, dtype=dt) if b == 0 else
                 power(prev_pdf, self.light_pdf(lk, prev_p) / self.n_lights))
            L = L + torch.where((alive & valid)[:, None],
                                beta * le * w[:, None], 0.0)
            alive = alive & valid & (b < sc.maxdepth)
            lobes = Lobes(self.mat_kd[mat], self.mat_ks[mat],
                          self.mat_alpha[mat])
            alive = alive & (lobes.n > 0)
            t, bt = onb(ng)

            def local(v):
                return torch.stack([dot(v, t), dot(v, bt), dot(v, ng)], -1)

            d0 = CAMERA_DIMS + b * DIMS_PER_BOUNCE
            # next-event estimation
            wi_l, li, lpdf, pl, pmf = self.sample_light(
                p, self.u(lanes, d0), self.u(lanes, d0 + 1),
                self.u(lanes, d0 + 2))
            f, spdf = lobes.f_pdf(local(wo), local(wi_l))
            f = f * dot(wi_l, ng).abs()[:, None]
            usable = (alive & (lpdf > 0) & (li > 0).any(-1)
                      & (f > 0).any(-1))
            o_sh = offset(p, ng, wi_l)
            t_sh = torch.where(
                usable, torch.linalg.vector_norm(pl - o_sh, dim=-1)
                * (1 - 1e-4) - 2e-3 * pl.abs().amax(-1).clamp(min=1.0), 0.0)
            nee = (f * li * (power(lpdf, spdf)
                             / (lpdf * pmf).clamp(min=1e-20))[:, None])
            beta_nee = beta
            # the continuation
            wl, fs, pdf = lobes.sample(local(wo), self.u(lanes, d0 + 3),
                                       self.u(lanes, d0 + 4),
                                       self.u(lanes, d0 + 5))
            wi = t * wl[:, 0:1] + bt * wl[:, 1:2] + ng * wl[:, 2:3]
            ok = alive & (pdf > 0) & (fs > 0).any(-1)
            beta = torch.where(
                ok[:, None], beta * fs * (dot(wi, ng).abs()
                                          / pdf.clamp(min=1e-20))[:, None],
                beta)
            alive = ok
            prev_pdf, prev_p = pdf.clamp(min=1e-20), p
            o, d = offset(p, ng, wi), wi
            if b > 3:
                u_rr = self.u(lanes, d0 + 6)
                rb = beta.amax(-1)
                q = (1 - rb).clamp(min=0.05)
                roll = (rb < 1.0) & alive
                killed = roll & (u_rr < q)
                alive = alive & ~killed
                beta = torch.where((roll & ~killed)[:, None],
                                   beta / (1 - q).clamp(min=1e-6)[:, None],
                                   beta)
            occl = g.occluded(o_sh, wi_l, t_sh.clamp(min=0))
            hit = g.closest(o, d, torch.where(alive, inf, 0.0))
            L = L + beta_nee * torch.where((usable & ~occl)[:, None], nee,
                                           0.0)
        return torch.cat([p_film, L, p_lens] + feats, -1)
