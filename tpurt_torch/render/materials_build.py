"""Material table and per-lane lobe fetch for matte, plastic, mirror and
glass (port of tpurt/render/materials_build.py: the host half of
build_material_table with its list of textured slots, fuse_material_rows
and fetch_lobes with texture overrides).

The table keeps tpurt's fused 53-column row layout, so a tpurt table and
this one can be compared bit for bit (tpurt_torch.convert).  A textured
slot keeps its default in the table and is listed in ``textured``; the
texture evaluator (render/texeval.py) overrides it per lane.  Every other
material raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpurt_torch.scene.records import MaterialRecord
from tpurt_torch.render.bsdf import (ALL_SLOTS, FRESNEL_DIELECTRIC,
                                     FRESNEL_NOOP, SLOT_DIFFUSE, SLOT_FS,
                                     SLOT_GLOSSY, SLOT_GTRANS, SLOT_MIRROR,
                                     LobeParams, lobe_activity,
                                     roughness_to_alpha)

# columns of the constant-parameter table (tpurt's layout)
_N_COLS = 39
(C_KD0, C_KD1, C_KD2, C_KS0, C_KS1, C_KS2, C_KR0, C_KR1, C_KR2,
 C_KT0, C_KT1, C_KT2, C_ROUGH, C_UROUGH, C_VROUGH, C_ETA, C_SIGMA,
 C_ETA30, C_ETA31, C_ETA32, C_REMAP, C_FRESNEL,
 C_TR0, C_TR1, C_TR2, C_TT0, C_TT1, C_TT2,
 C_METALLIC, C_SPECTRANS, C_ANISO, C_SHEEN, C_SHEENTINT, C_CC, C_CCGLOSS,
 C_SPECTINT, C_FLAT, C_DIFFTRANS, C_THIN) = range(_N_COLS)
# fused-row extension columns: kind, conductor k, mix sub-ids, hair,
# fourier table index
C_KIND = _N_COLS
C_FK30 = _N_COLS + 1
C_MIX0 = _N_COLS + 4
C_HAIR0 = _N_COLS + 6
C_FTIX = _N_COLS + 13
N_FUSED_COLS = _N_COLS + 14

MAT_NONE = 0
MAT_MATTE = 1
MAT_PLASTIC = 2
MAT_MIRROR = 3
MAT_GLASS = 4
_KIND_CODES = {"matte": MAT_MATTE, "plastic": MAT_PLASTIC,
               "mirror": MAT_MIRROR, "glass": MAT_GLASS}
# slots a texture can drive (tpurt's make_texture_eval col3/col1)
TEXTURABLE = ("Kd", "Ks", "Kr", "Kt", "roughness", "sigma")


def _const(slot):
    kind, val = slot
    if kind == "constant":
        return np.asarray(val, dtype=np.float64)
    return None  # textured


def build_material_table(materials: List[Optional[MaterialRecord]]):
    """Deduplicated material list (index == material id) -> (table
    (M, 39) f32, kinds (M,) i32, textured [(material id, slot)]), tpurt's
    constant-table layout."""
    m = len(materials)
    table = np.zeros((max(m, 1), _N_COLS), np.float32)
    kinds = np.zeros(max(m, 1), np.int32)
    textured: List[Tuple[int, str]] = []
    for i, rec in enumerate(materials):
        if rec is None:
            raise NotImplementedError('Material "none" (media boundaries)')
        kind = _KIND_CODES.get(rec.name)
        if kind is None:
            raise NotImplementedError(f'Material "{rec.name}"')
        kinds[i] = kind
        s = rec.slots

        def value(slot_name, default):
            v = _const(s[slot_name]) if slot_name in s else None
            if v is None and slot_name in s:
                if slot_name not in TEXTURABLE:
                    raise NotImplementedError(
                        f'textured "{slot_name}" on Material "{rec.name}"')
                textured.append((i, slot_name))
            return np.asarray(default, dtype=np.float64) if v is None else v

        def put3(slot_name, cols, default):
            v = value(slot_name, default) * np.ones(3)
            for k, c in enumerate(cols):
                table[i, c] = v[k]

        def put1(slot_name, col, default):
            table[i, col] = float(np.asarray(value(slot_name, default))
                                  .reshape(-1)[0])

        put3("Kd", (C_KD0, C_KD1, C_KD2), 0.0)
        put3("Ks", (C_KS0, C_KS1, C_KS2), 0.0)
        put3("Kr", (C_KR0, C_KR1, C_KR2), 0.0)
        put3("Kt", (C_KT0, C_KT1, C_KT2), 0.0)
        put1("roughness", C_ROUGH, 0.1)
        put1("uroughness", C_UROUGH, -1.0)
        put1("vroughness", C_VROUGH, -1.0)
        put1("sigma", C_SIGMA, 0.0)
        put1("eta", C_ETA, 1.5)
        put3("reflect", (C_TR0, C_TR1, C_TR2), 0.5)
        put3("transmit", (C_TT0, C_TT1, C_TT2), 0.5)
        put1("metallic", C_METALLIC, 0.0)
        put1("spectrans", C_SPECTRANS, 0.0)
        put1("anisotropic", C_ANISO, 0.0)
        put1("sheen", C_SHEEN, 0.0)
        put1("sheentint", C_SHEENTINT, 0.5)
        put1("clearcoat", C_CC, 0.0)
        put1("clearcoatgloss", C_CCGLOSS, 1.0)
        put1("speculartint", C_SPECTINT, 0.0)
        put1("flatness", C_FLAT, 0.0)
        put1("difftrans", C_DIFFTRANS, 1.0)
        # an absent flag slot reads as off, as in tpurt
        table[i, C_THIN] = float("thin" in s and _const(s["thin"]) in (True, 1.0))
        table[i, C_REMAP] = float("remaproughness" in s and
                                  _const(s["remaproughness"]) in (True, 1.0))
        table[i, C_FRESNEL] = (FRESNEL_NOOP if kind == MAT_MIRROR
                               else FRESNEL_DIELECTRIC)
    return table, kinds, textured


def fuse_material_rows(table: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Append tpurt's side-table columns (kind, conductor k, mix ids, hair,
    fourier index) so rows match tpurt's fused layout."""
    m = table.shape[0]
    return np.concatenate([
        table, kinds.astype(np.float32)[:, None],
        np.zeros((m, 3), np.float32), np.full((m, 2), -1.0, np.float32),
        np.zeros((m, 7), np.float32), np.full((m, 1), -1.0, np.float32),
    ], axis=1)


def lobe_slots(mt_table: np.ndarray) -> Tuple[int, ...]:
    """The lobe slots that some row of the fused material table can
    activate, by its kind (and, for glass, by its u/v roughness, which no
    texture drives): what fetch_lobes maps each kind to."""
    slots = set()
    for row in np.asarray(mt_table):
        kind = int(row[C_KIND])
        if kind in (MAT_MATTE, MAT_PLASTIC):
            slots.add(SLOT_DIFFUSE)
        if kind == MAT_PLASTIC:
            slots.add(SLOT_GLOSSY)
        if kind == MAT_MIRROR:
            slots.add(SLOT_MIRROR)
        if kind == MAT_GLASS:
            rough = row[C_UROUGH] > 0 or row[C_VROUGH] > 0
            slots.update((SLOT_GLOSSY, SLOT_GTRANS) if rough else (SLOT_FS,))
    return tuple(sorted(slots))


def fetch_lobes(mt_table: torch.Tensor, mat_id: torch.Tensor,
                texture_overrides: Optional[Dict[str, torch.Tensor]] = None,
                slots: Tuple[int, ...] = ALL_SLOTS) -> LobeParams:
    """Per-lane lobe parameters from the fused material table: matte ->
    diffuse (Oren-Nayar), plastic -> diffuse + GGX glossy, mirror ->
    specular reflection, glass -> fresnel-specular when smooth, GGX
    reflection + microfacet transmission when u/v roughness is given.
    mat_id (N,) i32, -1 = no material -> all lobes inactive.
    texture_overrides: {slot: per-lane values} from the texture evaluator.
    slots: lobe_slots of the table (the slots worth looking at)."""
    row = mt_table[mat_id.clamp(min=0).long()]
    kind = torch.where(mat_id >= 0, row[:, C_KIND].to(torch.int32), MAT_NONE)
    ov = texture_overrides or {}
    kd = ov.get("Kd", row[:, C_KD0:C_KD0 + 3])
    ks = ov.get("Ks", row[:, C_KS0:C_KS0 + 3])
    kr = ov.get("Kr", row[:, C_KR0:C_KR0 + 3])
    kt = ov.get("Kt", row[:, C_KT0:C_KT0 + 3])
    rough = ov.get("roughness", row[:, C_ROUGH])
    sigma = ov.get("sigma", row[:, C_SIGMA])
    urough = row[:, C_UROUGH]
    vrough = row[:, C_VROUGH]
    remap = row[:, C_REMAP] > 0

    # roughness -> alpha (per-axis when u/v given)
    ur = torch.where(urough >= 0, urough, rough)
    vr = torch.where(vrough >= 0, vrough, rough)
    ax = torch.where(remap, roughness_to_alpha(ur), torch.clamp(ur, min=1e-3))
    ay = torch.where(remap, roughness_to_alpha(vr), torch.clamp(vr, min=1e-3))

    # Oren-Nayar A/B from sigma degrees (reflection.h:364-372)
    sig_rad = torch.clamp(sigma, min=0.0) * float(np.float32(np.pi / 180))
    s2 = sig_rad * sig_rad
    oren_a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    oren_b = 0.45 * s2 / (s2 + 0.09)

    is_matte = kind == MAT_MATTE
    is_plastic = kind == MAT_PLASTIC
    # glass.cpp: specular unless a u/v roughness is given
    glass_rough = (kind == MAT_GLASS) & ((urough > 0) | (vrough > 0))
    glass_smooth = (kind == MAT_GLASS) & ~glass_rough
    z3 = torch.zeros_like(kd)
    lobe_ks = torch.where(is_plastic[:, None], ks, z3)
    lobes = dict(
        kd=torch.where((is_matte | is_plastic)[:, None], kd, z3),
        ks=torch.where(glass_rough[:, None], kr, lobe_ks),
        kr=torch.where((kind == MAT_MIRROR)[:, None], kr, z3),
        kt=torch.where(glass_smooth[:, None], kt, z3),
        fs_kr=torch.where(glass_smooth[:, None], kr, z3),
        kt_g=torch.where(glass_rough[:, None], kt, z3))
    return LobeParams(
        oren_a=torch.where(is_matte, oren_a, 1.0),
        oren_b=torch.where(is_matte, oren_b, 0.0),
        alpha_x=ax, alpha_y=ay,
        fresnel_kind=row[:, C_FRESNEL].to(torch.int32),
        eta=row[:, C_ETA], t_alpha_x=ax, t_alpha_y=ay,
        active=lobe_activity(slots=slots, **lobes), **lobes)
