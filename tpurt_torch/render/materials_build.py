"""Material table and per-lane lobe fetch (port of
tpurt/render/materials_build.py: build_material_table with its list of
textured slots and its mix sub-rows, fuse_material_rows, and fetch_lobes
with texture overrides and the mix blend).

The table keeps tpurt's fused 53-column row layout, so a tpurt table and
this one can be compared bit for bit (tpurt_torch.convert).  A textured
slot keeps its default in the table and is listed in ``textured``; the
texture evaluator (render/texeval.py) overrides the slots fetch_lobes
reads per lane.  A hair row carries its Marschner parameters in the
``C_HAIR0`` columns, which the integrator reads (render/hair.py), and
tpurt's gray diffuse stand-in in its lobe columns.  A fourier row
carries the same stand-in and, in ``C_FTIX``, the index of its baked
.bsdf table (render/fourier.py; one table per distinct file), which the
integrators read in its place; a missing or unreadable file raises
ValueError naming the material and the file, where tpurt logs and
renders the material black.  ``Material "none"`` (a medium boundary) is
a row of zeros of kind ``MAT_NONE``, which activates no lobe.
Subsurface and kdsubsurface rows are glass (their surface lobes) and
carry the tabulated BSSRDF in ``bss`` [sigma_t rgb, rho rgb, eta] and
``bss_tix``, the index of their diffusion table (render/bssrdf.py; one
table per distinct (g, eta)), which the path integrator's subsurface hop
reads.  A material name tpurt does not know raises NotImplementedError
(tpurt maps it to matte with a warning).
"""

from __future__ import annotations

import logging
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpurt_torch.render.fourier import bake_fourier_table, read_bsdf_file
from tpurt_torch.render.bsdf import (ALL_SLOTS, FRESNEL_CONDUCTOR,
                                     FRESNEL_DIELECTRIC, FRESNEL_DISNEY,
                                     FRESNEL_NOOP, FRESNEL_SCHLICK,
                                     SLOT_CLEARCOAT, SLOT_DIFFUSE, SLOT_DTRANS,
                                     SLOT_FS, SLOT_GLOSSY, SLOT_GTRANS,
                                     SLOT_MIRROR, LobeParams, LobeSet,
                                     lobe_activity, roughness_to_alpha)
from tpurt_torch.render.hair import (sigma_a_from_concentration,
                                     sigma_a_from_reflectance)
from tpurt_torch.render.materials import COPPER_ETA_RGB, COPPER_K_RGB
from tpurt_torch.scene.records import MaterialRecord
from tpurt_torch.spectrum_sampled import lift_refl

log = logging.getLogger("tpurt_torch.render")

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
MAT_METAL = 5
MAT_UBER = 6
MAT_SUBSTRATE = 7
MAT_TRANSLUCENT = 8
MAT_DISNEY = 9
MAT_MIX = 10
MAT_HAIR = 11
MAT_FOURIER = 12
_KIND_CODES = {"matte": MAT_MATTE, "plastic": MAT_PLASTIC,
               "mirror": MAT_MIRROR, "glass": MAT_GLASS, "metal": MAT_METAL,
               "uber": MAT_UBER, "substrate": MAT_SUBSTRATE,
               "translucent": MAT_TRANSLUCENT, "disney": MAT_DISNEY,
               "mix": MAT_MIX, "hair": MAT_HAIR, "fourier": MAT_FOURIER,
               # subsurface materials: glass-like surface lobes
               # (subsurface.cpp ComputeScatteringFunctions) + the
               # tabulated BSSRDF hop
               "subsurface": MAT_GLASS, "kdsubsurface": MAT_GLASS,
               "metal_": MAT_METAL}


class MaterialTable(NamedTuple):
    """Host half of tpurt's MaterialTable for the ported kinds."""

    table: np.ndarray  # (M, 39) f32 constants
    kinds: np.ndarray  # (M,) i32 material kind
    textured: List[Tuple[int, str]]  # (material id, slot) of textured slots
    k3: np.ndarray  # (M, 3) f32 conductor k
    mix: np.ndarray  # (M, 2) i32 mix sub-material rows (-1 = none)
    records: List[Optional[MaterialRecord]]  # index == row, mix subs appended
    # hair columns [sigma_a rgb, eta, beta_m, beta_n, alpha]; zero rows
    # for other kinds
    hair: np.ndarray  # (M, 7) f32
    # fourier rows' table index (-1 = none), the baked tables
    # (bake_fourier_table's host arrays) and each table's eta
    fourier_tix: np.ndarray = None  # (M,) i32
    fourier_tables: tuple = ()
    fourier_etas: tuple = ()
    # tabulated-BSSRDF columns [sigma_t rgb, rho rgb, eta] and each row's
    # diffusion-table index (-1 = no BSSRDF); the tables
    # (bssrdf.BSSRDFTableHost) of the distinct (g, eta) pairs
    bss: np.ndarray = None  # (M, 7) f32
    bss_tix: np.ndarray = None  # (M,) i32
    bss_tables: tuple = ()

    @property
    def has_bssrdf(self) -> bool:
        return bool(self.bss_tables)


def _const(slot):
    """A constant slot's value; None for a textured or absent slot (a
    record may hold None, as metal's unset u/v roughness: read as
    absent, as tpurt's _const does)."""
    if slot is None:
        return None
    kind, val = slot
    if kind == "constant":
        return np.asarray(val, dtype=np.float64)
    return None  # textured


def build_material_table(materials: List[Optional[MaterialRecord]]
                         ) -> MaterialTable:
    """Deduplicated material list (index == material id) -> MaterialTable
    (tpurt's build_material_table, materials_build.py:141-261, :378-383).
    A mix pulls its resolved sub-records into rows appended after the
    list (appended records may be mixes too); its row keeps their ids
    (mix) and its "amount" in the C_TR columns."""
    materials = list(materials)
    mix_pairs = {}
    i = 0
    while i < len(materials):
        rec = materials[i]
        if rec is not None and rec.name == "mix" and i not in mix_pairs:
            subs = []
            for slot in ("submaterial1", "submaterial2"):
                sub = rec.slots.get(slot, (None, None))[1]
                if sub is None:
                    subs.append(-1)
                    continue
                for j, e in enumerate(materials):
                    if e is sub:
                        subs.append(j)
                        break
                else:
                    materials.append(sub)
                    subs.append(len(materials) - 1)
            mix_pairs[i] = tuple(subs)
        i += 1

    m = len(materials)
    table = np.zeros((max(m, 1), _N_COLS), np.float32)
    k3 = np.zeros((max(m, 1), 3), np.float32)
    kinds = np.zeros(max(m, 1), np.int32)
    mix = np.full((max(m, 1), 2), -1, np.int32)
    hair = np.zeros((max(m, 1), 7), np.float32)
    fourier_tix = np.full(max(m, 1), -1, np.int32)
    fourier_tables, fourier_etas, fourier_keys = [], [], {}
    bss = np.zeros((max(m, 1), 7), np.float32)
    bss_tix = np.full(max(m, 1), -1, np.int32)
    bss_tables, bss_keys = [], {}
    for i, pair in mix_pairs.items():
        mix[i] = pair
    textured: List[Tuple[int, str]] = []
    for i, rec in enumerate(materials):
        if rec is None:
            # Material "none": a row of zeros of kind MAT_NONE, no lobe
            # (tpurt's materials_build.py:186-187); volpath passes through
            # it, the other integrators end the path there
            kinds[i] = MAT_NONE
            continue
        kind = _KIND_CODES.get(rec.name)
        if kind is None:
            raise NotImplementedError(f'Material "{rec.name}"')
        kinds[i] = kind
        s = rec.slots

        def value(slot_name, default):
            v = _const(s.get(slot_name))
            if v is None and slot_name in s:
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
        # disney extras (disney.cpp:589-643 defaults)
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
        table[i, C_THIN] = float(_const(s.get("thin")) in (True, 1.0))
        table[i, C_REMAP] = float(_const(s.get("remaproughness"))
                                  in (True, 1.0))
        if kind == MAT_MIX:
            # mix "amount" rides the (otherwise translucent-only) C_TR cols
            put3("amount", (C_TR0, C_TR1, C_TR2), 0.5)
        if kind == MAT_METAL:
            eta3 = _const(s.get("eta"))
            kk = _const(s.get("k"))
            table[i, C_ETA30:C_ETA30 + 3] = (
                COPPER_ETA_RGB if eta3 is None else eta3 * np.ones(3))
            k3[i] = COPPER_K_RGB if kk is None else kk * np.ones(3)
        table[i, C_FRESNEL] = {MAT_METAL: FRESNEL_CONDUCTOR,
                               MAT_SUBSTRATE: FRESNEL_SCHLICK,
                               MAT_MIRROR: FRESNEL_NOOP,
                               MAT_DISNEY: FRESNEL_DISNEY}.get(
                                   kind, FRESNEL_DIELECTRIC)
        if kind in (MAT_HAIR, MAT_FOURIER):
            # tpurt's gray diffuse stand-in in the lobe columns; the
            # integrators replace it on hair and fourier lanes
            table[i, C_KD0:C_KD0 + 3] = 0.5
        if kind == MAT_HAIR:
            hair[i] = _hair_columns(s)
        if kind == MAT_FOURIER:
            fname = s.get("bsdffile", ("constant", ""))[1]
            if fname not in fourier_keys:
                host = _read_fourier(fname)
                fourier_keys[fname] = len(fourier_tables)
                fourier_tables.append(bake_fourier_table(host))
                fourier_etas.append(host.eta)
            fourier_tix[i] = fourier_keys[fname]
        if rec.name in ("subsurface", "kdsubsurface"):
            bss[i], bss_tix[i] = _bss_columns(rec, bss_tables, bss_keys)
    return MaterialTable(table=table, kinds=kinds, textured=textured, k3=k3,
                         mix=mix, records=materials, hair=hair,
                         fourier_tix=fourier_tix,
                         fourier_tables=tuple(fourier_tables),
                         fourier_etas=tuple(fourier_etas), bss=bss,
                         bss_tix=bss_tix, bss_tables=tuple(bss_tables))


def _bss_columns(rec: MaterialRecord, tables: list, keys: dict):
    """([sigma_t rgb, rho rgb, eta], table index) of a subsurface or
    kdsubsurface record (subsurface.cpp:55-58, kdsubsurface.cpp
    ComputeScatteringFunctions; tpurt's materials_build.py:334-376).  A
    (g, eta) pair not in ``keys`` appends its diffusion table to
    ``tables``.  subsurface scales sigma_a and sigma_s by "scale";
    kdsubsurface inverts Kd through the table (subsurface_from_diffuse)
    at its mean free path.  A textured slot warns and takes its default,
    as in tpurt."""
    from tpurt_torch.render.bssrdf import (compute_beam_diffusion_table,
                                           subsurface_from_diffuse)

    s = rec.slots

    def bconst(key, default):
        v = _const(s.get(key))
        if v is None and key in s:
            log.warning('%s: textured "%s" not supported; using default',
                        rec.name, key)
        return np.asarray(default if v is None else v, np.float64)

    g_b = float(bconst("g", 0.0).reshape(-1)[0])
    eta_b = float(bconst("eta", 1.33).reshape(-1)[0])
    key = (round(g_b, 6), round(eta_b, 6))
    if key not in keys:
        keys[key] = len(tables)
        tables.append(compute_beam_diffusion_table(g_b, eta_b))
    tix = keys[key]
    if rec.name == "subsurface":
        scale_b = float(bconst("scale", 1.0).reshape(-1)[0])
        sig_a_b = np.clip(bconst("sigma_a", [0.0011, 0.0024, 0.014])
                          * np.ones(3), 0, None) * scale_b
        sig_s_b = np.clip(bconst("sigma_s", [2.55, 3.21, 3.77])
                          * np.ones(3), 0, None) * scale_b
    else:
        kd_b = np.clip(bconst("Kd", 0.5) * np.ones(3), 0.0, 1.0)
        mfp_b = bconst("mfp", 1.0) * np.ones(3)
        sig_a_b, sig_s_b = subsurface_from_diffuse(tables[tix], kd_b, mfp_b)
    sig_t_b = sig_a_b + sig_s_b
    rho_b = np.where(sig_t_b > 0, sig_s_b / np.maximum(sig_t_b, 1e-20), 0.0)
    return np.concatenate([sig_t_b, rho_b, [eta_b]]).astype(np.float32), tix


def _read_fourier(fname: str):
    """The SCATFUN table of a fourier material (tpurt's
    materials_build.py:311-332).  A missing or unreadable file raises
    ValueError naming the material and the file: tpurt logs and renders
    the material black."""
    if not fname:
        raise ValueError('Material "fourier": no "string bsdffile" given')
    try:
        return read_bsdf_file(fname)
    except (OSError, ValueError, struct.error) as e:
        raise ValueError(f'Material "fourier": bsdffile "{fname}": {e}'
                         ) from e


def _hair_columns(s) -> np.ndarray:
    """[sigma_a rgb, eta, beta_m, beta_n, alpha] of a hair record, sigma_a
    by CreateHairMaterial's precedence (hair.cpp:151-166; tpurt's
    materials_build.py:270-309).  A textured hair parameter warns and
    takes its default, as in tpurt."""

    def hconst(key):
        v = _const(s.get(key))
        if v is None and key in s:
            log.warning('hair: textured "%s" not supported; using its '
                        'default', key)
        return v

    out = np.zeros(7, np.float32)
    bn = hconst("beta_n")
    bn = 0.3 if bn is None else float(bn.reshape(-1)[0])
    sa = hconst("sigma_a")
    if sa is not None:
        sa = np.clip(sa * np.ones(3), 0.0, None)
    elif hconst("color") is not None:
        sa = sigma_a_from_reflectance(
            np.clip(hconst("color") * np.ones(3), 0.0, 1.0), bn)
    elif "eumelanin" in s or "pheomelanin" in s:
        ce = hconst("eumelanin")
        cp = hconst("pheomelanin")
        sa = sigma_a_from_concentration(
            max(0.0, 0.0 if ce is None else float(ce)),
            max(0.0, 0.0 if cp is None else float(cp)))
    else:
        sa = sigma_a_from_concentration(1.3, 0.0)
    for key, col, default in (("eta", 3, 1.55), ("beta_m", 4, 0.3),
                              ("alpha", 6, 2.0)):
        v = hconst(key)
        out[col] = default if v is None else float(v.reshape(-1)[0])
    out[0:3] = sa
    out[5] = bn
    return out


def fuse_material_rows(mt: MaterialTable) -> np.ndarray:
    """Append tpurt's side-table columns (kind, conductor k, mix ids, hair,
    fourier index) so rows match tpurt's fused layout."""
    return np.concatenate([
        mt.table, mt.kinds.astype(np.float32)[:, None],
        mt.k3.astype(np.float32), mt.mix.astype(np.float32),
        mt.hair.astype(np.float32),
        mt.fourier_tix.astype(np.float32)[:, None],
    ], axis=1)


def _row_slots(row: np.ndarray) -> set:
    """The slots that fetch_lobes can activate on lanes of one non-mix
    row, by its kind: a superset where the values come from a texture."""
    kind = int(row[C_KIND])
    if kind in (MAT_MATTE, MAT_PLASTIC, MAT_UBER, MAT_SUBSTRATE,
                MAT_TRANSLUCENT, MAT_DISNEY, MAT_HAIR, MAT_FOURIER):
        slots = {SLOT_DIFFUSE}
    else:
        slots = set()
    if kind in (MAT_PLASTIC, MAT_METAL, MAT_UBER, MAT_SUBSTRATE,
                MAT_TRANSLUCENT, MAT_DISNEY):
        slots.add(SLOT_GLOSSY)
    if kind in (MAT_MIRROR, MAT_UBER):
        slots.add(SLOT_MIRROR)
    if kind == MAT_UBER:
        slots.add(SLOT_FS)
    if kind == MAT_TRANSLUCENT:
        slots.update((SLOT_GTRANS, SLOT_DTRANS))
    if kind == MAT_GLASS:
        rough = row[C_UROUGH] > 0 or row[C_VROUGH] > 0
        slots.update((SLOT_GLOSSY, SLOT_GTRANS) if rough else (SLOT_FS,))
    if kind == MAT_DISNEY:
        # spectrans, clearcoat, thin and difftrans are never textured
        # (tpurt reads their table values)
        if row[C_SPECTRANS] > 0:
            slots.add(SLOT_GTRANS)
        if row[C_CC] > 0:
            slots.add(SLOT_CLEARCOAT)
        if row[C_THIN] > 0 and row[C_DIFFTRANS] > 0:
            slots.add(SLOT_DTRANS)
    return slots


def lobe_slots(mt_table: np.ndarray) -> LobeSet:
    """What the rows of the fused material table can activate: the lobe
    slots (a mix row adds the union of its two sub-rows'), the glossy
    slot's Fresnel kinds, the material kinds and whether any row is
    Disney, a mix or hair.  fetch_lobes, the BSDF and the integrator's hair
    terms compute nothing else."""
    mt_table = np.asarray(mt_table)
    slots, fresnel, disney, mix = set(), set(), False, False
    kinds = set(mt_table[:, C_KIND].astype(int).tolist())
    for row in mt_table:
        kind = int(row[C_KIND])
        if kind == MAT_NONE:
            continue  # Material "none": no slot, no Fresnel kind
        if kind == MAT_MIX:
            mix = True
            for sub in row[C_MIX0:C_MIX0 + 2].astype(int):
                slots |= _row_slots(mt_table[max(sub, 0)])
        else:
            slots |= _row_slots(row)
        fresnel.add(int(row[C_FRESNEL]))
        disney |= kind == MAT_DISNEY
    return LobeSet(slots, fresnel, disney, mix, kinds,
                   hair=MAT_HAIR in kinds)


# the colour fields of LobeParams, promoted to bins in spectral mode
_LOBE_COLOR_FIELDS = ("kd", "ks", "eta3", "k3", "kr", "kt", "fs_kr",
                      "kt_g", "kd_t", "r0", "sheen", "retro", "kd_ss")


def fetch_lobes(mt_table: torch.Tensor, mat_id: torch.Tensor,
                texture_overrides: Optional[Dict[str, torch.Tensor]] = None,
                slots=ALL_SLOTS, channels: int = 3) -> LobeParams:
    """Per-lane lobe parameters from the fused material table (tpurt's
    fetch_lobes, materials_build.py:435-491).  mat_id (N,) i32, -1 = no
    material -> all lobes inactive.  texture_overrides: {slot: per-lane
    values} from the texture evaluator.  slots: lobe_slots of the table
    (ALL_SLOTS computes every slot, Fresnel kind and material kind).

    Mix lanes blend their two sub-rows' parameters by "amount" as tpurt
    does: exact for the linear scale fields, the dominant side's value
    for the distribution shapes and flags (tpurt's documented
    approximation); the sub-rows take no texture overrides.

    channels 60: every colour field, textured ones included, is promoted
    to the bins through the reflectance basis after the mix blend
    (tpurt's _lift_lobeparams, materials_build.py:422-491; conductor eta
    and k given as RGB promote the same way), and the lobe activity is
    read from the promoted fields, as tpurt's LobeParams.active is."""
    idx = mat_id.clamp(min=0).long()
    row = mt_table[idx]
    kind = torch.where(mat_id >= 0, row[:, C_KIND].to(torch.int32), MAT_NONE)
    lp = _fetch_lobes_one(row, kind, texture_overrides, slots)
    if slots.mix:
        is_mix = kind == MAT_MIX
        sub = row[:, C_MIX0:C_MIX0 + 2].to(torch.int64)
        id1 = torch.where(is_mix, sub[:, 0].clamp(min=0), idx)
        id2 = torch.where(is_mix, sub[:, 1].clamp(min=0), idx)
        r1, r2 = mt_table[id1], mt_table[id2]
        lp1 = _fetch_lobes_one(r1, r1[:, C_KIND].to(torch.int32), None, slots)
        lp2 = _fetch_lobes_one(r2, r2[:, C_KIND].to(torch.int32), None, slots)
        amt3 = torch.clamp(row[:, C_TR0:C_TR0 + 3], 0.0, 1.0)
        amt1 = amt3.mean(dim=-1)
        take1 = amt1 >= 0.5
        linear = ("kd", "ks", "kr", "kt", "fs_kr", "kt_g", "kd_t",
                  "sheen", "retro", "kd_ss", "r0")
        for f, b in lp.items():
            if b is None:
                continue
            p, q = lp1[f], lp2[f]
            if f in linear:
                mixed = amt3 * p + (1.0 - amt3) * q
            elif f == "cc":
                mixed = amt1 * p + (1.0 - amt1) * q
            else:
                mixed = torch.where(take1[:, None] if p.dim() == 2 else take1,
                                    p, q)
            lp[f] = torch.where(is_mix[:, None] if b.dim() == 2 else is_mix,
                                mixed, b)
    if channels != 3:
        for f in _LOBE_COLOR_FIELDS:
            if lp.get(f) is not None:
                lp[f] = lift_refl(lp[f])
    act = lobe_activity(slots=slots, **{
        k: lp.get(k) for k in ("kd", "ks", "kr", "fs_kr", "kt", "kt_g", "cc",
                               "kd_t", "retro", "sheen", "kd_ss")})
    return LobeParams(active=act, **lp)


def _fetch_lobes_one(row, kind, texture_overrides, slots) -> dict:
    """The LobeParams fields of one gathered fused row per lane (tpurt's
    _fetch_lobes_one, materials_build.py:494-652): every kind mapped onto
    the slots.  Fields that no material of ``slots`` needs are None."""
    n = row.shape[0]
    ov = texture_overrides or {}
    kd = ov.get("Kd", row[:, C_KD0:C_KD0 + 3])
    ks = ov.get("Ks", row[:, C_KS0:C_KS0 + 3])
    kr = ov.get("Kr", row[:, C_KR0:C_KR0 + 3])
    kt = ov.get("Kt", row[:, C_KT0:C_KT0 + 3])
    rough = ov.get("roughness", row[:, C_ROUGH])
    sigma = ov.get("sigma", row[:, C_SIGMA])
    urough = row[:, C_UROUGH]
    vrough = row[:, C_VROUGH]
    eta = row[:, C_ETA]
    remap = row[:, C_REMAP] > 0
    fresnel_kind = row[:, C_FRESNEL].to(torch.int32)

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

    present = slots.kinds

    def is_(*codes):
        """The lanes of any of the kinds ``codes``; None where the table
        holds none of them (the select that would use it is skipped)."""
        m = None
        for c in codes:
            if present is None or c in present:
                m = (kind == c) if m is None else m | (kind == c)
        return m

    def by(mask, val, other):
        return other if mask is None else torch.where(mask[:, None], val,
                                                      other)

    z3 = torch.zeros_like(kd)
    is_matte = is_(MAT_MATTE)
    # hair and fourier expose tpurt's gray diffuse stand-in (the
    # integrators replace it on their lanes)
    lobe_kd = by(is_(MAT_MATTE, MAT_PLASTIC, MAT_UBER, MAT_SUBSTRATE,
                     MAT_HAIR, MAT_FOURIER), kd, z3)
    lobe_ks = by(is_(MAT_PLASTIC, MAT_UBER, MAT_SUBSTRATE), ks, z3)
    # metal's glossy slot carries ks=1 with conductor fresnel
    lobe_ks = by(is_(MAT_METAL), torch.ones_like(ks), lobe_ks)
    lobe_kt = by(is_(MAT_UBER), kt, z3)
    lobe_kr = by(is_(MAT_MIRROR, MAT_UBER), kr, z3)
    # glass: smooth -> fresnel-specular; rough -> GGX reflection +
    # microfacet transmission (glass.cpp: specular when u/v rough == 0)
    lobe_fs_kr, lobe_kt_g = z3, z3
    is_glass = is_(MAT_GLASS)
    if is_glass is not None:
        glass_rough = is_glass & ((urough > 0) | (vrough > 0))
        glass_smooth = is_glass & ~glass_rough
        lobe_fs_kr = by(glass_smooth, kr, z3)
        lobe_kt = by(glass_smooth, kt, lobe_kt)
        lobe_ks = by(glass_rough, kr, lobe_ks)
        lobe_kt_g = by(glass_rough, kt, z3)
    t_ax, t_ay = ax, ay
    out = dict(fresnel_kind=fresnel_kind, eta=eta)
    if SLOT_DTRANS in slots:
        out["kd_t"] = z3
    if SLOT_CLEARCOAT in slots:
        out["cc"] = torch.zeros_like(eta)
        out["cc_gloss"] = torch.zeros_like(eta)

    if SLOT_DTRANS in slots or SLOT_GTRANS in slots:
        # translucent (translucent.cpp): reflect/transmit split both the
        # diffuse and glossy components
        is_tl = (kind == MAT_TRANSLUCENT)[:, None]
        trefl = row[:, C_TR0:C_TR0 + 3]
        ttrans = row[:, C_TT0:C_TT0 + 3]
        lobe_kd = torch.where(is_tl, trefl * kd, lobe_kd)
        lobe_ks = torch.where(is_tl, trefl * ks, lobe_ks)
        lobe_kt_g = torch.where(is_tl, ttrans * ks, lobe_kt_g)
        if SLOT_DTRANS in slots:
            out["kd_t"] = torch.where(is_tl, ttrans * kd, out["kd_t"])
    if FRESNEL_CONDUCTOR in slots.fresnel:
        out["eta3"] = row[:, C_ETA30:C_ETA30 + 3]
        out["k3"] = row[:, C_FK30:C_FK30 + 3]

    if slots.disney:
        # disney.cpp ComputeScatteringFunctions (:474-587)
        is_dis = kind == MAT_DISNEY
        metallic = torch.where(is_dis, row[:, C_METALLIC], 0.0)
        strans = row[:, C_SPECTRANS]
        thin = row[:, C_THIN] > 0
        dw = (1.0 - metallic) * (1.0 - strans)  # diffuseWeight
        dt = row[:, C_DIFFTRANS] / 2.0
        lum = (0.212671 * kd[:, 0] + 0.715160 * kd[:, 1]
               + 0.072169 * kd[:, 2])
        ctint = torch.where(lum[:, None] > 0,
                            kd / torch.clamp(lum, min=1e-9)[:, None], 1.0)
        sheen_w = row[:, C_SHEEN]
        tint = row[:, C_SHEENTINT]
        csheen = (1.0 - tint)[:, None] + tint[:, None] * ctint
        flat = row[:, C_FLAT]
        d_kd_w = torch.where(thin, (1.0 - flat) * (1.0 - dt), 1.0)
        lobe_kd = by(is_dis, (dw * d_kd_w)[:, None] * kd, lobe_kd)
        out["kd_ss"] = by(is_dis & thin, (dw * flat * (1.0 - dt))[:, None] * kd,
                          z3)
        out["retro"] = by(is_dis, dw[:, None] * kd, z3)
        out["sheen"] = by(is_dis, (dw * sheen_w)[:, None] * csheen, z3)
        if SLOT_DTRANS in slots:
            out["kd_t"] = by(is_dis & thin, dt[:, None] * kd, out["kd_t"])
        # specular: white scale, disney fresnel (R0 tinted), disney alphas
        lobe_ks = by(is_dis, torch.ones_like(ks), lobe_ks)
        spec_tint = row[:, C_SPECTINT]
        em1, ep1 = eta - 1.0, eta + 1.0
        r0_eta = (em1 * em1) / torch.clamp(ep1 * ep1, min=1e-9)
        out["r0"] = ((1.0 - metallic)[:, None] * r0_eta[:, None]
                     * ((1.0 - spec_tint)[:, None]
                        + spec_tint[:, None] * ctint)
                     + metallic[:, None] * kd)
        aspect = torch.sqrt(torch.clamp(1.0 - row[:, C_ANISO] * 0.9,
                                        min=1e-6))
        d_ax = torch.clamp(rough * rough / aspect, min=0.001)
        d_ay = torch.clamp(rough * rough * aspect, min=0.001)
        ax = torch.where(is_dis, d_ax, ax)
        ay = torch.where(is_dis, d_ay, ay)
        # transmission: strans*sqrt(c); thin scales roughness by IOR
        lobe_kt_g = by(is_dis, strans[:, None]
                       * torch.sqrt(torch.clamp(kd, min=0.0)), lobe_kt_g)
        rscaled = (0.65 * eta - 0.35) * rough
        t_ax = torch.where(is_dis, torch.where(
            thin, torch.clamp(rscaled * rscaled / aspect, min=0.001), d_ax),
            t_ax)
        t_ay = torch.where(is_dis, torch.where(
            thin, torch.clamp(rscaled * rscaled * aspect, min=0.001), d_ay),
            t_ay)
        if SLOT_CLEARCOAT in slots:
            ccg = row[:, C_CCGLOSS]
            out["cc"] = torch.where(is_dis, row[:, C_CC], 0.0)
            out["cc_gloss"] = torch.clamp(0.1 * (1.0 - ccg) + 0.001 * ccg,
                                          min=1e-4)
        out["disney"] = is_dis
        out["metallic"] = metallic
        out["d_rough"] = torch.where(is_dis, rough, 0.5)
    elif SLOT_CLEARCOAT in slots:
        ccg = row[:, C_CCGLOSS]
        out["cc_gloss"] = torch.clamp(0.1 * (1.0 - ccg) + 0.001 * ccg,
                                      min=1e-4)

    out.update(kd=lobe_kd, ks=lobe_ks, kr=lobe_kr, kt=lobe_kt,
               fs_kr=lobe_fs_kr, kt_g=lobe_kt_g, alpha_x=ax, alpha_y=ay,
               t_alpha_x=t_ax, t_alpha_y=t_ay,
               oren_a=(torch.ones_like(eta) if is_matte is None
                       else torch.where(is_matte, oren_a, 1.0)),
               oren_b=(torch.zeros_like(eta) if is_matte is None
                       else torch.where(is_matte, oren_b, 0.0)))
    for f in LobeParams._fields:
        out.setdefault(f, None)
    del out["active"]
    return out
