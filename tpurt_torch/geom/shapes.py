"""Shape factories: pbrt Shape directives -> host-side geometry records.

Reference analog: src/shapes/* Create*Shape factories dispatched from
api.cpp MakeShapes (:427-534).  Triangle meshes are flattened to world
space at creation (triangle.cpp mesh ctor); quadrics keep their transform
pair and are intersected analytically on device.  Tessellating shapes
(heightfield, loopsubdiv, nurbs) become triangle meshes host-side.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from tpurt_torch.geom.transform import Transform
from tpurt_torch.scene.paramset import ParamSet
from tpurt_torch.scene.records import QuadricRecord, TriangleMeshRecord

log = logging.getLogger("tpurt.scene")


def make_shapes(name: str, object_to_world: Transform, reverse_orientation: bool,
                params: ParamSet, camera_pos=None) -> List[object]:
    if name == "trianglemesh":
        return _create_triangle_mesh(object_to_world, params)
    if name == "plymesh":
        return _create_ply_mesh(object_to_world, params)
    if name == "heightfield":
        return _create_heightfield(object_to_world, params)
    if name == "loopsubdiv":
        return _create_loop_subdiv(object_to_world, params)
    if name in ("sphere", "cylinder", "disk", "cone", "paraboloid", "hyperboloid"):
        return _create_quadric(name, object_to_world, params)
    if name == "curve":
        return _create_curve(object_to_world, params, camera_pos=camera_pos)
    if name == "nurbs":
        return _create_nurbs(object_to_world, params)
    log.warning('shape "%s" unknown or not yet supported', name)
    return []


# -- quadrics ----------------------------------------------------------------

def _create_quadric(kind: str, o2w: Transform, ps: ParamSet) -> List[QuadricRecord]:
    if kind == "sphere":
        radius = ps.find_one_float("radius", 1.0)
        zmin = ps.find_one_float("zmin", -radius)
        zmax = ps.find_one_float("zmax", radius)
        phimax = ps.find_one_float("phimax", 360.0)
        return [QuadricRecord("sphere", o2w, radius=radius, z_min=zmin,
                              z_max=zmax, phi_max=phimax)]
    if kind == "cylinder":
        radius = ps.find_one_float("radius", 1.0)
        zmin = ps.find_one_float("zmin", -1.0)
        zmax = ps.find_one_float("zmax", 1.0)
        phimax = ps.find_one_float("phimax", 360.0)
        return [QuadricRecord("cylinder", o2w, radius=radius, z_min=zmin,
                              z_max=zmax, phi_max=phimax)]
    if kind == "disk":
        return [QuadricRecord(
            "disk", o2w,
            radius=ps.find_one_float("radius", 1.0),
            height=ps.find_one_float("height", 0.0),
            inner_radius=ps.find_one_float("innerradius", 0.0),
            phi_max=ps.find_one_float("phimax", 360.0),
        )]
    if kind == "cone":
        return [QuadricRecord(
            "cone", o2w,
            radius=ps.find_one_float("radius", 1.0),
            z_min=0.0,
            z_max=ps.find_one_float("height", 1.0),
            phi_max=ps.find_one_float("phimax", 360.0),
        )]
    if kind == "paraboloid":
        return [QuadricRecord(
            "paraboloid", o2w,
            radius=ps.find_one_float("radius", 1.0),
            z_min=ps.find_one_float("zmin", 0.0),
            z_max=ps.find_one_float("zmax", 1.0),
            phi_max=ps.find_one_float("phimax", 360.0),
        )]
    if kind == "hyperboloid":
        return [QuadricRecord(
            "hyperboloid", o2w,
            p1=ps.find_one_point3("p1", [0, 0, 0]),
            p2=ps.find_one_point3("p2", [1, 1, 1]),
            phi_max=ps.find_one_float("phimax", 360.0),
        )]
    raise AssertionError(kind)


# -- triangle meshes -----------------------------------------------------------

def _mesh_from_arrays(o2w: Transform, P, indices, N=None, UV=None, S=None,
                      face_indices=None) -> List[TriangleMeshRecord]:
    P = np.asarray(P, dtype=np.float64).reshape(-1, 3)
    indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    if indices.size and (indices.min() < 0 or indices.max() >= len(P)):
        log.error("trianglemesh has out of-bounds vertex index; discarding")
        return []
    world_P = o2w.apply_point(P)
    world_N = None
    if N is not None:
        n = o2w.apply_normal(np.asarray(N, dtype=np.float64).reshape(-1, 3))
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        world_N = n / np.where(norm > 0, norm, 1.0)
    world_S = None
    if S is not None:
        world_S = o2w.apply_vector(np.asarray(S, dtype=np.float64).reshape(-1, 3))
    uv = np.asarray(UV, dtype=np.float64).reshape(-1, 2) if UV is not None else None
    return [TriangleMeshRecord(
        vertices=world_P.astype(np.float32),
        indices=indices.astype(np.int32),
        normals=None if world_N is None else world_N.astype(np.float32),
        uvs=None if uv is None else uv.astype(np.float32),
        tangents=None if world_S is None else world_S.astype(np.float32),
        face_indices=(None if face_indices is None
                      else np.asarray(face_indices, np.int32).reshape(-1)),
    )]


def _create_triangle_mesh(o2w: Transform, ps: ParamSet) -> List[TriangleMeshRecord]:
    indices = ps.find_int_array("indices")
    P = ps.find_point3_array("P")
    if indices is None:
        log.error("vertex indices \"indices\" not provided with trianglemesh")
        return []
    if P is None:
        log.error("vertex positions \"P\" not provided with trianglemesh")
        return []
    if len(indices) % 3:
        log.error("number of vertex indices not multiple of 3; discarding")
        return []
    uv = ps.find_point2_array("uv")
    if uv is None:
        uv = ps.find_point2_array("st")
    if uv is not None and len(uv) != len(P):
        log.error("number of uvs != number of vertices; discarding uvs")
        uv = None
    N = ps.find_normal3_array("N")
    if N is not None and len(N) != len(P):
        log.error("number of normals != number of vertices; discarding normals")
        N = None
    S = ps.find_vector3_array("S")
    if S is not None and len(S) != len(P):
        S = None
    fi = ps.find_int_array("faceIndices")
    if fi is not None and len(fi) != len(indices) // 3:
        log.error("# of face indices != # of triangles; discarding "
                  "(triangle.cpp:710-716)")
        fi = None
    return _mesh_from_arrays(o2w, P, indices, N, uv, S, face_indices=fi)


def _create_heightfield(o2w: Transform, ps: ParamSet) -> List[TriangleMeshRecord]:
    """Grid of z values -> triangle mesh (shapes/heightfield.cpp)."""
    nu = ps.find_one_int("nu", -1)
    nv = ps.find_one_int("nv", -1)
    Pz = ps.find_float_array("Pz")
    if nu <= 0 or nv <= 0 or Pz is None or len(Pz) != nu * nv:
        log.error("heightfield requires nu, nv and nu*nv Pz values")
        return []
    u = np.arange(nu) / (nu - 1)
    v = np.arange(nv) / (nv - 1)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    P = np.stack([uu.ravel(), vv.ravel(), np.asarray(Pz)], axis=-1)
    uvs = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    idx = []
    for y in range(nv - 1):
        for x in range(nu - 1):
            vi = y * nu + x
            idx.append([vi, vi + 1, vi + nu + 1])
            idx.append([vi, vi + nu + 1, vi + nu])
    return _mesh_from_arrays(o2w, P, np.asarray(idx), UV=uvs)


def _create_loop_subdiv(o2w: Transform, ps: ParamSet) -> List[TriangleMeshRecord]:
    """Loop subdivision surface -> triangle mesh (shapes/loopsubdiv.cpp):
    ``levels`` rounds of standard Loop weights (boundary rule 1/8,3/4,1/8),
    then the push to the LIMIT surface (weightOneRing with loopGamma /
    weightBoundary 1/5, loopsubdiv.cpp:334-341) and analytic limit
    normals from the cos/sin tangent masks (:345-378)."""
    levels = ps.find_one_int("levels", ps.find_one_int("nlevels", 3))
    indices = ps.find_int_array("indices")
    P = ps.find_point3_array("P")
    if indices is None or P is None:
        log.error("loopsubdiv requires indices and P")
        return []
    V = P.copy()
    F = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    for _ in range(levels):
        V, F = _loop_subdivide_once(V, F)
    V, vn = _loop_limit(V, F)
    return _mesh_from_arrays(o2w, V, F, N=vn)


def _loop_ordered_rings(V: np.ndarray, F: np.ndarray):
    """Ordered one-rings per vertex (SDVertex::oneRing semantics):
    interior rings follow the face winding; boundary rings run from one
    boundary neighbor to the other in the reference's prev-walk order.
    Returns (rings, boundary_flags)."""
    succ = [dict() for _ in range(len(V))]
    for a, b, c in F:
        # per face (v, next, prev): the ring successor of prev is next
        succ[a][c] = b
        succ[b][a] = c
        succ[c][b] = a
    rings, boundary = [], []
    for v in range(len(V)):
        s = succ[v]
        if not s:
            rings.append([])
            boundary.append(False)
            continue
        starts = set(s.keys()) - set(s.values())
        if starts:  # boundary vertex: succ chain is a path
            path = [starts.pop()]
            while path[-1] in s and len(path) <= len(s):
                path.append(s[path[-1]])
            # oneRing walks nextFace to the end then collects prevVerts:
            # that is the succ path REVERSED
            rings.append(path[::-1])
            boundary.append(True)
        else:  # interior: succ chain is a cycle
            a0 = next(iter(s))
            ring = [a0]
            while s[ring[-1]] != a0 and len(ring) <= len(s):
                ring.append(s[ring[-1]])
            rings.append(ring)
            boundary.append(False)
    return rings, boundary


def _loop_limit(V: np.ndarray, F: np.ndarray):
    """Push vertices to the Loop limit surface and compute limit normals
    (loopsubdiv.cpp:334-378; tangents evaluated at the LIMIT positions,
    matching the reference's update order)."""
    rings, boundary = _loop_ordered_rings(V, F)
    Vl = V.copy()
    for v, ring in enumerate(rings):
        n = len(ring)
        if n == 0:
            continue
        R = V[np.asarray(ring)]
        if not boundary[v]:
            beta = 3.0 / 16.0 if n == 3 else 3.0 / (8.0 * n)
            gamma = 1.0 / (n + 3.0 / (8.0 * beta))  # loopGamma(:144)
            Vl[v] = (1 - n * gamma) * V[v] + gamma * R.sum(0)
        else:
            Vl[v] = 0.6 * V[v] + 0.2 * (R[0] + R[-1])  # weightBoundary 1/5
    N = np.zeros_like(V)
    for v, ring in enumerate(rings):
        n = len(ring)
        if n == 0:
            continue
        R = Vl[np.asarray(ring)]
        if not boundary[v]:
            ang = 2.0 * np.pi * np.arange(n) / n
            S = (np.cos(ang)[:, None] * R).sum(0)
            T = (np.sin(ang)[:, None] * R).sum(0)
        else:
            S = R[-1] - R[0]
            if n == 2:
                T = R[0] + R[1] - 2 * Vl[v]
            elif n == 3:
                T = R[1] - Vl[v]
            elif n == 4:  # regular crease
                T = -R[0] + 2 * R[1] + 2 * R[2] - R[3] - 2 * Vl[v]
            else:
                theta = np.pi / (n - 1)
                T = np.sin(theta) * (R[0] + R[-1])
                for k in range(1, n - 1):
                    T = T + (2 * np.cos(theta) - 2) * np.sin(k * theta) * R[k]
                T = -T
        N[v] = np.cross(S, T)
    ln = np.linalg.norm(N, axis=-1, keepdims=True)
    N = N / np.where(ln > 0, ln, 1.0)
    return Vl, N


def _loop_subdivide_once(V: np.ndarray, F: np.ndarray):
    nV = len(V)
    # Edge midpoint vertices.
    edges = {}
    edge_faces = {}
    for fi, f in enumerate(F):
        for k in range(3):
            e = (min(f[k], f[(k + 1) % 3]), max(f[k], f[(k + 1) % 3]))
            edges.setdefault(e, len(edges))
            edge_faces.setdefault(e, []).append((fi, f[(k + 2) % 3]))
    # New edge-vertex positions.
    EV = np.zeros((len(edges), 3))
    for e, ei in edges.items():
        opp = edge_faces[e]
        if len(opp) == 2:
            EV[ei] = 0.375 * (V[e[0]] + V[e[1]]) + 0.125 * (V[opp[0][1]] + V[opp[1][1]])
        else:  # boundary edge
            EV[ei] = 0.5 * (V[e[0]] + V[e[1]])
    # Even (old) vertex positions.
    from collections import defaultdict

    neighbors = defaultdict(set)
    boundary_nb = defaultdict(set)
    for e, opp in edge_faces.items():
        neighbors[e[0]].add(e[1])
        neighbors[e[1]].add(e[0])
        if len(opp) == 1:
            boundary_nb[e[0]].add(e[1])
            boundary_nb[e[1]].add(e[0])
    NV = V.copy()
    for v in range(nV):
        nb = neighbors[v]
        if not nb:
            continue
        if v in boundary_nb and boundary_nb[v]:
            b = list(boundary_nb[v])
            if len(b) >= 2:
                NV[v] = 0.75 * V[v] + 0.125 * (V[b[0]] + V[b[1]])
            continue
        n = len(nb)
        beta = (0.1875 if n == 3 else 3.0 / (8.0 * n))
        NV[v] = (1 - n * beta) * V[v] + beta * sum(V[u] for u in nb)
    # New faces: 4 per old face.
    newF = []
    for f in F:
        m = [edges[(min(f[k], f[(k + 1) % 3]), max(f[k], f[(k + 1) % 3]))] + nV
             for k in range(3)]
        newF += [[f[0], m[0], m[2]], [f[1], m[1], m[0]],
                 [f[2], m[2], m[1]], [m[0], m[1], m[2]]]
    return np.concatenate([NV, EV]), np.asarray(newF, dtype=np.int64)


# -- PLY ------------------------------------------------------------------------

def _create_ply_mesh(o2w: Transform, ps: ParamSet) -> List[TriangleMeshRecord]:
    filename = ps.find_one_filename("filename", "")
    if not filename:
        log.error("plymesh requires \"filename\"")
        return []
    try:
        P, N, UV, F = read_ply(filename)
    except (OSError, ValueError) as e:
        log.error("PLY read failed for %s: %s", filename, e)
        return []
    return _mesh_from_arrays(o2w, P, F, N=N, UV=UV)


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Minimal PLY reader (ascii / binary little/big endian) for vertex
    x/y/z[/nx/ny/nz][/u/v or s/t] + face vertex_indices.  Reference analog:
    the vendored rply loader used by shapes/plymesh.cpp."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, val_t, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))  # (name, type)
            elif parts[0] == "end_header":
                break
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        P = N = UV = None
        faces = []
        for name, count, props in elements:
            if name == "vertex":
                scalar_props = [(pn, pt) for pn, pt in props if pn != "list"]
                if endian:
                    dt = np.dtype([(pn, endian + _PLY_DTYPES[pt]) for pn, pt in scalar_props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                else:
                    rows = [f.readline().split() for _ in range(count)]
                    data = {pn: np.array([float(r[i]) for r in rows])
                            for i, (pn, _pt) in enumerate(scalar_props)}
                def col(n):
                    try:
                        return np.asarray(data[n], dtype=np.float64)
                    except (KeyError, ValueError):
                        return None
                x, y, z = col("x"), col("y"), col("z")
                if x is None:
                    raise ValueError("PLY vertex element lacks x/y/z")
                P = np.stack([x, y, z], axis=-1)
                if col("nx") is not None:
                    N = np.stack([col("nx"), col("ny"), col("nz")], axis=-1)
                for ua, va in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
                    if col(ua) is not None and col(va) is not None:
                        UV = np.stack([col(ua), col(va)], axis=-1)
                        break
            elif name == "face":
                list_prop = next((p for p in props if p[0] == "list"), None)
                if list_prop is None:
                    raise ValueError("PLY face element lacks a list property")
                _tag, idx_t, val_t, _pn = list_prop
                if endian:
                    idt = np.dtype(endian + _PLY_DTYPES[idx_t])
                    vdt = np.dtype(endian + _PLY_DTYPES[val_t])
                    for _ in range(count):
                        (n,) = np.frombuffer(f.read(idt.itemsize), dtype=idt)
                        vs = np.frombuffer(f.read(vdt.itemsize * int(n)), dtype=vdt)
                        for k in range(1, int(n) - 1):  # fan-triangulate
                            faces.append([vs[0], vs[k], vs[k + 1]])
                else:
                    for _ in range(count):
                        row = f.readline().split()
                        n = int(row[0])
                        vs = [int(v) for v in row[1 : 1 + n]]
                        for k in range(1, n - 1):
                            faces.append([vs[0], vs[k], vs[k + 1]])
            else:
                # skip unknown elements
                if endian:
                    scalar_props = [(pn, pt) for pn, pt in props if pn != "list"]
                    if len(scalar_props) == len(props):
                        size = sum(np.dtype(_PLY_DTYPES[pt]).itemsize for _, pt in scalar_props)
                        f.read(size * count)
                    else:
                        raise ValueError("cannot skip PLY element with list property")
                else:
                    for _ in range(count):
                        f.readline()
        if P is None:
            raise ValueError("PLY file has no vertex element")
        return P, N, UV, np.asarray(faces, dtype=np.int64)


# -- curves (tessellated) ------------------------------------------------------

def _bezier_eval(cp: np.ndarray, u: np.ndarray):
    """Evaluate a degree-(len(cp)-1) Bezier at u (M,) by de Casteljau.
    Returns (points (M,3), tangents (M,3))."""
    pts = [np.broadcast_to(c, (len(u), 3)).astype(np.float64) for c in cp]
    while len(pts) > 2:
        pts = [(1 - u)[:, None] * pts[i] + u[:, None] * pts[i + 1]
               for i in range(len(pts) - 1)]
    tan = (len(cp) - 1) * (pts[1] - pts[0])
    p = (1 - u)[:, None] * pts[0] + u[:, None] * pts[1]
    return p, tan


def _bspline_to_bezier(cp: np.ndarray, degree: int) -> List[np.ndarray]:
    """Uniform B-spline control points -> per-span Bezier control points
    (blossoming; curve.cpp:470-500 does the same per segment)."""
    segs = []
    n = len(cp)
    if degree == 2:
        for i in range(n - 2):
            p0, p1, p2 = cp[i], cp[i + 1], cp[i + 2]
            segs.append(np.stack([(p0 + p1) / 2, p1, (p1 + p2) / 2]))
    else:
        for i in range(n - 3):
            p0, p1, p2, p3 = cp[i], cp[i + 1], cp[i + 2], cp[i + 3]
            b0 = (p0 + 4 * p1 + p2) / 6
            b1 = (2 * p1 + p2) / 3
            b2 = (p1 + 2 * p2) / 3
            b3 = (p1 + 4 * p2 + p3) / 6
            segs.append(np.stack([b0, b1, b2, b3]))
    return segs


def _elevate_to_cubic(seg: np.ndarray) -> np.ndarray:
    """Degree-elevate a quadratic Bezier to cubic (curve.cpp:491-497)."""
    if len(seg) == 4:
        return np.asarray(seg, np.float64)
    p0, p1, p2 = np.asarray(seg, np.float64)
    return np.stack([p0, p0 + (2.0 / 3.0) * (p1 - p0),
                     p1 + (1.0 / 3.0) * (p2 - p1), p2])


def _blossom_cubic(cp: np.ndarray, u0: np.ndarray, u1: np.ndarray) -> np.ndarray:
    """Blossomed control points of the cubic Bezier sub-spans [u0_i, u1_i]
    (BlossomBezier, curve.cpp:43-53).  cp (4,3); u0,u1 (M,) -> (M,4,3)."""
    def blossom(ua, ub, uc):
        a = [cp[i] + ua[:, None] * (cp[i + 1] - cp[i]) for i in range(3)]
        b = [a[i] + ub[:, None] * (a[i + 1] - a[i]) for i in range(2)]
        return b[0] + uc[:, None] * (b[1] - b[0])
    return np.stack([blossom(u0, u0, u0), blossom(u0, u0, u1),
                     blossom(u0, u1, u1), blossom(u1, u1, u1)], axis=1)


def _curve_refinement_depth(spans: np.ndarray, eps: float) -> np.ndarray:
    """The reference's per-intersect refinement depth (curve.cpp:204-225),
    evaluated at build time on the span control points.  The C++ takes the
    max per-AXIS second difference of the RAY-space points; the vector
    norm used here upper-bounds that for every ray orientation, so the
    resulting depth is always >= the reference's."""
    d1 = spans[:, 0] - 2.0 * spans[:, 1] + spans[:, 2]
    d2 = spans[:, 1] - 2.0 * spans[:, 2] + spans[:, 3]
    l0 = np.maximum(np.linalg.norm(d1, axis=-1), np.linalg.norm(d2, axis=-1))
    v = np.maximum(1.41421356237 * 6.0 * l0 / (8.0 * max(eps, 1e-12)),
                   1e-30).astype(np.float32)
    bits = v.view(np.int32)
    # round-to-nearest integer log2 via the float exponent bit trick
    # (curve.cpp:215-222), then log4 = log2 / 2
    log2 = ((bits >> 23) - 127) + ((bits >> 22) & 1)
    log2 = np.where(v < 1.0, 0, log2)
    return np.clip(log2 // 2, 0, 10)


def _slerp_normals(n0: np.ndarray, n1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical lerp between unit normals (curve.cpp:313-319 sin-weight
    form).  t (M,) -> (M,3)."""
    cos_a = float(np.clip(np.dot(n0, n1), 0.0, 1.0))
    ang = np.arccos(cos_a)
    if ang < 1e-6:
        out = (1 - t)[:, None] * n0 + t[:, None] * n1
    else:
        inv_sin = 1.0 / np.sin(ang)
        out = (np.sin((1 - t) * ang) * inv_sin)[:, None] * n0 + \
              (np.sin(t * ang) * inv_sin)[:, None] * n1
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


def _curve_records(o2w: Transform, segs, width0: float, width1: float,
                   ctype: str, norms, splitdepth: int):
    """Build pre-split world-space CurveRecord spans for the ray-traced
    curve path (config.curve_mode="raytrace").

    Mirrors CreateCurveShape (curve.cpp:397-557): per cubic segment the
    widths are lerped to the segment ends and ribbons take the segment's
    two endpoint normals; CreateCurve's 2^splitdepth static u-spans
    become the top-level spans here.  On top of that, each span is
    pre-split until its residual refinement depth (the width/20 criterion
    of curve.cpp:204-225) fits the device kernel's fixed unroll
    (geometry_build.CURVE_LEAF_SUBDIV), so device leaf tests need no
    data-dependent recursion."""
    from tpurt_torch.render.geometry_build import CURVE_LEAF_SUBDIV
    from tpurt_torch.scene.records import CurveRecord

    n_seg = len(segs)
    # uniform-scale factor for widths: the reference intersects in object
    # space; baking o2w into the control points means widths scale by the
    # transform's (assumed uniform) scale
    lin = np.asarray(o2w.m, np.float64)[:3, :3]
    svals = np.linalg.svd(lin, compute_uv=False)
    if svals[0] > 1.01 * max(svals[-1], 1e-12):
        log.warning("curve: non-uniform transform scale (%.3g..%.3g); "
                    "ray-traced widths use the mean scale", svals[-1], svals[0])
    wscale = float(np.mean(svals))

    all_cp, all_w, all_u, all_n = [], [], [], []
    max_presplit = 7  # storage cap; beyond this the device unroll absorbs
    for seg_i, seg in enumerate(segs):
        cp = _elevate_to_cubic(seg)
        w0 = width0 + (width1 - width0) * (seg_i / n_seg)
        w1 = width0 + (width1 - width0) * ((seg_i + 1) / n_seg)
        if ctype == "ribbon" and norms is not None:
            if len(norms) == n_seg + 1:
                sn0, sn1 = norms[seg_i], norms[seg_i + 1]
            else:
                sn0, sn1 = norms[0], norms[-1]
            sn0 = sn0 / max(np.linalg.norm(sn0), 1e-12)
            sn1 = sn1 / max(np.linalg.norm(sn1), 1e-12)
        else:
            sn0 = sn1 = None

        ns = 1 << splitdepth
        iu = np.arange(ns, dtype=np.float64)
        u0, u1 = iu / ns, (iu + 1) / ns
        spans = _blossom_cubic(cp, u0, u1)
        eps = max(w0, w1) * 0.05
        depth = _curve_refinement_depth(spans, eps)
        m = np.clip(depth - CURVE_LEAF_SUBDIV, 0, max_presplit)
        for mm in np.unique(m):
            sel = m == mm
            k = 1 << int(mm)
            js = np.arange(k, dtype=np.float64)
            du = (u1[sel] - u0[sel])[:, None]
            uu0 = (u0[sel][:, None] + du * (js / k)[None]).reshape(-1)
            uu1 = (u0[sel][:, None] + du * ((js + 1) / k)[None]).reshape(-1)
            sub = _blossom_cubic(cp, uu0, uu1)
            all_cp.append(sub)
            all_u.append(np.stack([uu0, uu1], axis=1))
            all_w.append(np.stack([w0 + (w1 - w0) * uu0,
                                   w0 + (w1 - w0) * uu1], axis=1))
            if sn0 is not None:
                all_n.append(np.stack([_slerp_normals(sn0, sn1, uu0),
                                       _slerp_normals(sn0, sn1, uu1)], axis=1))

    cp = np.concatenate(all_cp)
    cp_w = o2w.apply_point(cp.reshape(-1, 3)).reshape(-1, 4, 3)
    u = np.concatenate(all_u)
    w = np.concatenate(all_w) * wscale
    normals = None
    if all_n:
        nrm = o2w.apply_normal(np.concatenate(all_n).reshape(-1, 3))
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        normals = nrm.reshape(-1, 2, 3).astype(np.float32)
    return [CurveRecord(cp=cp_w.astype(np.float32),
                        width=w.astype(np.float32),
                        u=u.astype(np.float32),
                        normals=normals, ctype=ctype)]


def _parallel_frames(tangents: np.ndarray, n0=None) -> np.ndarray:
    """Rotation-minimizing normals along a polyline of tangents (M,3)."""
    t = tangents / np.maximum(np.linalg.norm(tangents, axis=-1,
                                             keepdims=True), 1e-12)
    if n0 is None:
        a = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(t[0], a)) > 0.9:
            a = np.array([1.0, 0.0, 0.0])
        n0 = np.cross(t[0], a)
    n = n0 / max(np.linalg.norm(n0), 1e-12)
    out = np.zeros_like(t)
    for i in range(len(t)):
        n = n - t[i] * np.dot(n, t[i])
        ln = np.linalg.norm(n)
        if ln < 1e-9:
            a = np.array([0.0, 0.0, 1.0])
            if abs(np.dot(t[i], a)) > 0.9:
                a = np.array([1.0, 0.0, 0.0])
            n = np.cross(t[i], a)
            ln = np.linalg.norm(n)
        n = n / ln
        out[i] = n
    return out


def _create_curve(o2w: Transform, ps: ParamSet,
                  camera_pos=None) -> List[TriangleMeshRecord]:
    """Curve shape (shapes/curve.cpp CreateCurveShape :397-470).

    TPU deviation (documented): the reference intersects Bezier ribbons
    analytically with recursive splitting; here curves are TESSELLATED
    host-side into triangle strips/tubes that ride the standard wavefront
    triangle kernels.  'flat' curves (view-facing in the reference) use a
    rotation-minimizing frame instead of the camera-facing orientation;
    'cylinder' curves become 6-sided tubes; 'ribbon' curves interpolate
    the supplied normals."""
    width = ps.find_one_float("width", 1.0)
    width0 = ps.find_one_float("width0", width)
    width1 = ps.find_one_float("width1", width)
    degree = ps.find_one_int("degree", 3)
    if degree not in (2, 3):
        log.error("curve: only degree 2/3 supported (got %d)", degree)
        return []
    basis = ps.find_one_string("basis", "bezier")
    cp = ps.find_point3_array("P")
    if cp is None:
        log.error("curve: missing P")
        return []
    cp = np.asarray(cp, np.float64).reshape(-1, 3)
    ctype = ps.find_one_string("type", "flat")
    norms = ps.find_normal3_array("N")
    if norms is not None:
        norms = np.asarray(norms, np.float64).reshape(-1, 3)

    if basis == "bezier":
        if (len(cp) - 1 - degree) % degree != 0:
            log.error("curve: bad control point count %d", len(cp))
            return []
        segs = [cp[i * degree:i * degree + degree + 1]
                for i in range((len(cp) - 1) // degree)]
    elif basis == "bspline":
        if len(cp) < degree + 1:
            log.error("curve: bad control point count %d", len(cp))
            return []
        segs = _bspline_to_bezier(cp, degree)
    else:
        log.error('curve: unknown basis "%s"', basis)
        return []

    splitdepth = ps.find_one_int("splitdepth", 3)

    from tpurt_torch.config import CURVE_MODE

    if CURVE_MODE == "raytrace":
        if ctype == "ribbon" and norms is None:
            log.error('curve: must provide normals "N" at curve endpoints '
                      'with ribbon curves')
            return []
        if ctype not in ("flat", "cylinder", "ribbon"):
            log.warning('curve: unknown type "%s"; using "cylinder"', ctype)
            ctype = "cylinder"
        return _curve_records(o2w, segs, width0, width1, ctype, norms,
                              splitdepth)

    steps = max(2, 1 << splitdepth)
    n_seg = len(segs)
    # sample all segments: global u in [0,1] across the whole curve
    P_rows, T_rows, U_rows = [], [], []
    for si, seg in enumerate(segs):
        u = np.linspace(0.0, 1.0, steps + 1)
        if si > 0:
            u = u[1:]  # shared point with previous segment
        p, t = _bezier_eval(seg, u)
        P_rows.append(p)
        T_rows.append(t)
        U_rows.append((si + u) / n_seg)
    P = np.concatenate(P_rows)
    T = np.concatenate(T_rows)
    U = np.concatenate(U_rows)
    half_w = 0.5 * ((1 - U) * width0 + U * width1)

    if ctype == "ribbon" and norms is not None and len(norms) >= 2:
        # interpolate the supplied normals along u (normalized lerp)
        n_along = ((1 - U)[:, None] * norms[0] + U[:, None] * norms[-1])
        n_along /= np.maximum(np.linalg.norm(n_along, axis=-1,
                                             keepdims=True), 1e-12)
        side = np.cross(T, n_along)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True),
                           1e-12)
    elif ctype == "flat" and camera_pos is not None:
        # camera-facing ribbon: side ⟂ tangent and ⟂ the view direction
        cam_h = np.append(np.asarray(camera_pos, np.float64), 1.0)
        cam_obj = (o2w.m_inv @ cam_h)[:3]
        view = P - cam_obj[None, :]
        side = np.cross(T, view)
        nrm = np.linalg.norm(side, axis=-1, keepdims=True)
        # degenerate (view ∥ tangent): fall back to the RMF side
        rmf_side = np.cross(T, _parallel_frames(T))
        side = np.where(nrm > 1e-9, side / np.maximum(nrm, 1e-12), rmf_side)
    else:
        n_frames = _parallel_frames(T)
        side = np.cross(T / np.maximum(np.linalg.norm(T, axis=-1,
                                                      keepdims=True), 1e-12),
                        n_frames)

    m = len(P)
    # uv convention matches curve.cpp Intersect: u along the curve, v
    # across the width (so hair's h = -1+2v works); tangents = fiber
    # direction for the hair BSDF frame
    if ctype == "cylinder":
        n_sides = 6
        # Cauchy mean-width correction: an inscribed hexagon's mean
        # projected width is (6 R / pi); scaling R by pi/(n sin(pi/n))
        # makes the tessellated tube's average silhouette match the true
        # cylinder's (measured 23% coverage deficit before the fix)
        half_w = half_w * (np.pi / (n_sides * np.sin(np.pi / n_sides)))
        tn = T / np.maximum(np.linalg.norm(T, axis=-1, keepdims=True), 1e-12)
        nf = _parallel_frames(T)
        bf = np.cross(tn, nf)
        verts, vnorms, vuv, vtan = [], [], [], []
        for k in range(n_sides):
            ang = 2 * np.pi * k / n_sides
            dirv = np.cos(ang) * nf + np.sin(ang) * bf
            verts.append(P + half_w[:, None] * dirv)
            vnorms.append(dirv)
            # v from the ring angle: h = sin(ang) = signed offset across
            # the width seen along the ring normal
            vv = 0.5 * (1.0 + np.sin(ang))
            vuv.append(np.stack([U, np.full_like(U, vv)], axis=-1))
            vtan.append(tn)
        V = np.concatenate(verts)         # (n_sides*m, 3) ring-major
        VN = np.concatenate(vnorms)
        idx = []
        for k in range(n_sides):
            k2 = (k + 1) % n_sides
            for i in range(m - 1):
                a, b = k * m + i, k * m + i + 1
                c, d = k2 * m + i, k2 * m + i + 1
                idx.append([a, b, c])
                idx.append([b, d, c])
        return _mesh_from_arrays(o2w, V, np.asarray(idx), N=VN,
                                 UV=np.concatenate(vuv),
                                 S=np.concatenate(vtan))
    # flat / ribbon: two-vertex strip
    v0 = P - half_w[:, None] * side
    v1 = P + half_w[:, None] * side
    V = np.concatenate([v0, v1])
    uv = np.concatenate([np.stack([U, np.zeros_like(U)], axis=-1),
                         np.stack([U, np.ones_like(U)], axis=-1)])
    tn = T / np.maximum(np.linalg.norm(T, axis=-1, keepdims=True), 1e-12)
    S = np.concatenate([tn, tn])
    idx = []
    for i in range(m - 1):
        a, b, c, d = i, i + 1, m + i, m + i + 1
        idx.append([a, b, c])
        idx.append([b, d, c])
    return _mesh_from_arrays(o2w, V, np.asarray(idx), UV=uv, S=S)


# -- NURBS (diced to a triangle mesh) ------------------------------------------

def _bspline_basis(knots: np.ndarray, order: int, n_cp: int,
                   u: np.ndarray):
    """Cox-de Boor: returns (basis (M, n_cp), dbasis (M, n_cp))."""
    m = len(u)
    deg = order - 1
    # zeroth degree
    b = np.zeros((m, len(knots) - 1))
    for i in range(len(knots) - 1):
        b[:, i] = (u >= knots[i]) & (u < knots[i + 1])
    # ensure u == last knot lands in the final nonempty span
    last = np.max(np.nonzero(knots < knots[-1])[0]) if np.any(
        knots < knots[-1]) else 0
    b[u >= knots[-1] - 1e-12, :] = 0
    b[u >= knots[-1] - 1e-12, last] = 1
    db = np.zeros_like(b)
    for d in range(1, deg + 1):
        nb = np.zeros_like(b)
        ndb = np.zeros_like(b)
        for i in range(len(knots) - 1 - d):
            den1 = knots[i + d] - knots[i]
            den2 = knots[i + d + 1] - knots[i + 1]
            t1 = np.where(den1 > 0, (u - knots[i]) / max(den1, 1e-30), 0.0)
            t2 = np.where(den2 > 0, (knots[i + d + 1] - u)
                          / max(den2, 1e-30), 0.0)
            nb[:, i] = t1 * b[:, i] + t2 * b[:, i + 1]
            d1 = d / max(den1, 1e-30) if den1 > 0 else 0.0
            d2 = d / max(den2, 1e-30) if den2 > 0 else 0.0
            ndb[:, i] = d1 * b[:, i] - d2 * b[:, i + 1]
        b, db = nb, ndb
    return b[:, :n_cp], db[:, :n_cp]


def _create_nurbs(o2w: Transform, ps: ParamSet) -> List[TriangleMeshRecord]:
    """NURBS surface diced into triangles (shapes/nurbs.cpp CreateNURBS
    :145-280; the reference likewise tessellates into a trianglemesh)."""
    nu = ps.find_one_int("nu", -1)
    nv = ps.find_one_int("nv", -1)
    uorder = ps.find_one_int("uorder", -1)
    vorder = ps.find_one_int("vorder", -1)
    uknots = ps.find_float_array("uknots")
    vknots = ps.find_float_array("vknots")
    if min(nu, nv, uorder, vorder) < 0 or uknots is None or vknots is None:
        log.error("nurbs: missing nu/nv/uorder/vorder/uknots/vknots")
        return []
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    if len(uknots) != nu + uorder or len(vknots) != nv + vorder:
        log.error("nurbs: knot count mismatch")
        return []
    u0 = ps.find_one_float("u0", float(uknots[uorder - 1]))
    u1 = ps.find_one_float("u1", float(uknots[nu]))
    v0 = ps.find_one_float("v0", float(vknots[vorder - 1]))
    v1 = ps.find_one_float("v1", float(vknots[nv]))

    P = ps.find_point3_array("P")
    if P is None:
        # "Pw" is already in homogeneous (wx, wy, wz, w) form — the
        # reference uses the values verbatim (nurbs.cpp:253-258)
        Pw = ps.find_float_array("Pw")
        if Pw is None:
            log.error("nurbs: missing P/Pw")
            return []
        cp = np.asarray(Pw, np.float64).reshape(-1, 4)
    else:
        cp = np.asarray(P, np.float64).reshape(-1, 3)
        cp = np.concatenate([cp, np.ones((len(cp), 1))], axis=-1)
    if len(cp) != nu * nv:
        log.error("nurbs: control point count %d != nu*nv", len(cp))
        return []
    grid = cp.reshape(nv, nu, 4)  # v-major like the reference

    diceu, dicev = 30, 30
    us = np.linspace(u0, u1, diceu)
    vs = np.linspace(v0, v1, dicev)
    bu, dbu = _bspline_basis(uknots, uorder, nu, us)
    bv, dbv = _bspline_basis(vknots, vorder, nv, vs)
    # S(u,v) in homogeneous coords: (dicev, diceu, 4)
    s = np.einsum('vj,ui,jik->vuk', bv, bu, grid)
    su = np.einsum('vj,ui,jik->vuk', bv, dbu, grid)
    sv = np.einsum('vj,ui,jik->vuk', dbv, bu, grid)
    w = np.maximum(np.abs(s[..., 3:4]), 1e-12) * np.sign(
        np.where(s[..., 3:4] == 0, 1.0, s[..., 3:4]))
    p = s[..., :3] / w
    # rational derivative: (su*w - s*wu)/w^2
    dpu = (su[..., :3] * w - s[..., :3] * su[..., 3:4]) / (w * w)
    dpv = (sv[..., :3] * w - s[..., :3] * sv[..., 3:4]) / (w * w)
    n = np.cross(dpu, dpv)
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nl > 1e-12, n / np.maximum(nl, 1e-30), 0.0)

    uu, vv = np.meshgrid(us, vs)
    uvs = np.stack([uu.ravel(), vv.ravel()], -1)
    V = p.reshape(-1, 3)
    VN = n.reshape(-1, 3)
    idx = []
    for j in range(dicev - 1):
        for i in range(diceu - 1):
            a = j * diceu + i
            b = a + 1
            c = a + diceu
            d = c + 1
            idx.append([a, b, c])
            idx.append([b, d, c])
    has_n = bool(np.any(np.linalg.norm(VN, axis=-1) > 0.5))
    return _mesh_from_arrays(o2w, V, np.asarray(idx),
                             N=VN if has_n else None, UV=uvs)
