"""Ptex per-face texture container: reader + writer (port of
tpurt/io/ptex.py: PtexError, PtexData, read_ptex, write_ptex; the host
numpy code copied whole, since the port imports nothing of tpurt).

Reference analog: textures/ptex.cpp evaluates per-face Ptex lookups via
the vendored Ptex library (src/ext/ptex — an EMPTY submodule in the
reference snapshot, so the C++ binary cannot render ptex scenes at all;
tpurt's support therefore exceeds the local reference build).

This module implements the Ptex v1 on-disk container (ptex.us) for the
subset that per-face texturing needs:

  core header (52 bytes, little-endian):
    u32 magic 'Ptex' (0x78657450)   u32 version (1)
    u32 meshtype (0 tri, 1 quad)    u32 datatype (0 u8, 1 u16,
                                                  2 half, 3 float)
    i32 alphachan (-1 none)         u16 nchannels   u16 nlevels
    u32 nfaces                      u32 extheadersize
    u32 faceinfosize (zipped)       u32 constdatasize (zipped)
    u32 levelinfosize (zipped)      u64 leveldatasize
    u32 metadatazipsize             u32 metadatamemsize
  sections, in order, each zlib-deflated:
    faceinfo:  nfaces x 20 B {i8 ulog2, i8 vlog2, u8 adjedges,
                              u8 flags, i32 adjfaces[4]}
    constdata: nfaces x nchannels x dtype   (per-face average)
    levelinfo: u64 leveldatasize, u32 levelheadersize, u32 nfaces
    leveldata: nfaces x u32 fdh (blocksize<<2 | encoding; encoding
               0=constant 2=zipped) followed by the per-face blocks

  unsupported (PtexError on read): multiple mip levels, tiled faces
  (encoding 3), difference-zipped faces (1), metadata, subfaces.

The writer emits exactly this subset so reader/writer are consistent by
construction; tests roundtrip both and pin the renderer-visible
semantics (per-face lookup by si.faceIndex, textures/ptex.cpp:63-101;
render/texeval.py's "ptex" branch).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List

import numpy as np

MAGIC = 0x78657450  # 'Ptex' little-endian

MESH_TRIANGLE = 0
MESH_QUAD = 1

_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float16, 3: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                np.dtype(np.float16): 2, np.dtype(np.float32): 3}

_HEADER = struct.Struct("<IIIIiHHIIIIIQII")

ENC_CONSTANT = 0
ENC_ZIPPED = 2


class PtexError(RuntimeError):
    pass


@dataclass
class PtexData:
    """Decoded per-face texture: faces[i] is (res_v, res_u, nchannels)
    float32 (u8/u16 normalized to [0,1]; gamma NOT applied — the
    texture layer owns that, like ptex.cpp:94-98)."""

    meshtype: int
    nchannels: int
    alphachan: int
    datatype: int
    faces: List[np.ndarray]

    @property
    def nfaces(self) -> int:
        return len(self.faces)


def _to_f32(raw: np.ndarray) -> np.ndarray:
    if raw.dtype == np.uint8:
        return raw.astype(np.float32) / 255.0
    if raw.dtype == np.uint16:
        return raw.astype(np.float32) / 65535.0
    return raw.astype(np.float32)


def read_ptex(path: str) -> PtexData:
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HEADER.size:
        raise PtexError(f"{path}: truncated header")
    (magic, version, meshtype, datatype, alphachan, nchannels, nlevels,
     nfaces, extheadersize, faceinfosize, constdatasize, levelinfosize,
     leveldatasize, metadatazipsize, _metadatamemsize) = _HEADER.unpack(
        blob[:_HEADER.size])
    if magic != MAGIC:
        raise PtexError(f"{path}: not a Ptex file (magic {magic:#x})")
    if datatype not in _DTYPES:
        raise PtexError(f"{path}: unknown datatype {datatype}")
    if nlevels != 1:
        raise PtexError(f"{path}: {nlevels} mip levels unsupported "
                        "(single-level subset)")
    dt = np.dtype(_DTYPES[datatype])
    pos = _HEADER.size + extheadersize

    def section(zsize):
        nonlocal pos
        out = zlib.decompress(blob[pos:pos + zsize])
        pos += zsize
        return out

    fi = np.frombuffer(section(faceinfosize), dtype=np.uint8)
    if len(fi) != 20 * nfaces:
        raise PtexError(f"{path}: faceinfo size mismatch")
    fi = fi.reshape(nfaces, 20)
    ulog2 = fi[:, 0].view(np.int8).astype(np.int32)
    vlog2 = fi[:, 1].view(np.int8).astype(np.int32)
    const = np.frombuffer(section(constdatasize), dtype=dt)
    const = const.reshape(nfaces, nchannels)
    li = section(levelinfosize)
    _lsize, _lhdr, lfaces = struct.unpack("<QII", li[:16])
    if lfaces != nfaces:
        raise PtexError(f"{path}: levelinfo face count mismatch")
    level = blob[pos:pos + leveldatasize]
    fdh = np.frombuffer(level[:4 * nfaces], dtype=np.uint32)
    enc = fdh & 3
    bsize = (fdh >> 2).astype(np.int64)
    if (enc == 3).any() or (enc == 1).any():
        raise PtexError(f"{path}: tiled/diff-zipped faces unsupported")
    faces: List[np.ndarray] = []
    off = 4 * nfaces
    for i in range(nfaces):
        ru, rv = 1 << int(ulog2[i]), 1 << int(vlog2[i])
        if enc[i] == ENC_CONSTANT:
            face = np.broadcast_to(_to_f32(const[i]),
                                   (rv, ru, nchannels)).copy()
        else:
            raw = np.frombuffer(
                zlib.decompress(level[off:off + int(bsize[i])]), dtype=dt)
            face = _to_f32(raw).reshape(rv, ru, nchannels)
        off += int(bsize[i])
        faces.append(face)
    return PtexData(meshtype=int(meshtype), nchannels=int(nchannels),
                    alphachan=int(alphachan), datatype=int(datatype),
                    faces=faces)


def write_ptex(path: str, faces: List[np.ndarray],
               meshtype: int = MESH_QUAD, alphachan: int = -1,
               datatype=np.float32) -> None:
    """Write per-face data (each (rv, ru, nc) with power-of-two dims;
    u8/u16 inputs are stored raw, floats as given)."""
    dt = np.dtype(datatype)
    if dt not in _DTYPE_CODES:
        raise PtexError(f"unsupported datatype {dt}")
    nfaces = len(faces)
    if nfaces == 0:
        raise PtexError("no faces")
    nc = faces[0].shape[2]
    fi = np.zeros((nfaces, 20), np.uint8)
    const = np.zeros((nfaces, nc), dt)
    blocks = []
    fdh = np.zeros(nfaces, np.uint32)
    for i, face in enumerate(faces):
        rv, ru, c = face.shape
        if c != nc:
            raise PtexError("inconsistent channel counts")
        if ru & (ru - 1) or rv & (rv - 1):
            raise PtexError(f"face {i}: non-power-of-two res {ru}x{rv}")
        fi[i, 0] = np.uint8(np.int8(int(np.log2(ru))))
        fi[i, 1] = np.uint8(np.int8(int(np.log2(rv))))
        fi[i, 4:20] = np.full(4, -1, np.int32).view(np.uint8)  # no adjacency
        fdata = np.ascontiguousarray(face, dt)
        const[i] = fdata.reshape(-1, nc).mean(0).astype(dt)
        if ru == 1 and rv == 1:
            fdh[i] = ENC_CONSTANT
            blocks.append(b"")
        else:
            z = zlib.compress(fdata.tobytes(), 6)
            fdh[i] = (np.uint32(len(z)) << 2) | ENC_ZIPPED
            blocks.append(z)
    face_z = zlib.compress(fi.tobytes(), 6)
    const_z = zlib.compress(const.tobytes(), 6)
    level_payload = fdh.tobytes() + b"".join(blocks)
    level_info = struct.pack("<QII", len(level_payload), 16, nfaces)
    li_z = zlib.compress(level_info, 6)
    header = _HEADER.pack(
        MAGIC, 1, meshtype, _DTYPE_CODES[dt] if dt in _DTYPE_CODES else 3,
        alphachan, nc, 1, nfaces, 0, len(face_z), len(const_z), len(li_z),
        len(level_payload), 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(face_z)
        f.write(const_z)
        f.write(li_z)
        f.write(level_payload)
