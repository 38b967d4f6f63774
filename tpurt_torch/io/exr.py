"""Minimal OpenEXR 2.0 scanline reader/writer in pure numpy.

The reference links the vendored OpenEXR library for image IO
(core/imageio.cpp, visualization/vis.cpp:15-31); this image has no OpenEXR
Python bindings, so we implement the subset of the format the renderer
needs: single-part scanline files, HALF/FLOAT/UINT channels, NONE / ZIPS /
ZIP compression (ZIP is what OpenEXR writes by default), increasing-Y line
order.  That is sufficient to round-trip our own output and read images
written by pbrt.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

MAGIC = 0x01312F76

# Compression enum (OpenEXR ImfCompression.h)
NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2
ZIP_COMPRESSION = 3
PIZ_COMPRESSION = 4

_LINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1, ZIP_COMPRESSION: 16}

# Channel pixel types
UINT = 0
HALF = 1
FLOAT = 2
_DTYPES = {UINT: np.dtype("<u4"), HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}


def _zip_compress(raw: bytes) -> bytes:
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    # Reorder: even bytes then odd bytes (ImfZip.cpp compress()).
    tmp = np.empty(n, dtype=np.uint8)
    half = (n + 1) // 2
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    # Delta predictor.
    out = np.empty(n, dtype=np.uint8)
    out[0] = tmp[0]
    d = tmp.astype(np.int16)
    out[1:] = ((d[1:] - d[:-1] + 128) & 0xFF).astype(np.uint8)
    comp = zlib.compress(out.tobytes())
    # OpenEXR stores raw data if compression doesn't help.
    return comp if len(comp) < n else raw


def _zip_decompress(buf: bytes, raw_size: int) -> bytes:
    if len(buf) == raw_size:  # stored uncompressed
        return buf
    data = np.frombuffer(zlib.decompress(buf), dtype=np.uint8)
    assert len(data) == raw_size, (len(data), raw_size)
    # Undo predictor: cumulative sum of (b - 128) from the first byte.
    acc = np.cumsum(
        np.concatenate([data[:1].astype(np.int64), data[1:].astype(np.int64) - 128])
    )
    tmp = (acc & 0xFF).astype(np.uint8)
    # Undo reorder.
    out = np.empty(raw_size, dtype=np.uint8)
    half = (raw_size + 1) // 2
    out[0::2] = tmp[:half]
    out[1::2] = tmp[half:]
    return out.tobytes()


def _write_attr(f, name: str, typ: str, data: bytes) -> None:
    f.write(name.encode() + b"\x00" + typ.encode() + b"\x00")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def write_exr(
    path: str,
    channels: Dict[str, np.ndarray],
    half: bool = True,
    compression: int = ZIP_COMPRESSION,
) -> None:
    """Write a scanline EXR.  ``channels`` maps channel name -> (H, W) float
    array.  Channels are stored in OpenEXR's canonical sorted order."""
    names = sorted(channels)
    arrs = [np.asarray(channels[n]) for n in names]
    h, w = arrs[0].shape
    for a in arrs:
        assert a.shape == (h, w), "all channels must share one resolution"
    ptype = HALF if half else FLOAT
    dt = _DTYPES[ptype]
    arrs = [np.ascontiguousarray(a.astype(dt)) for a in arrs]

    lines_per_block = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        # channels attribute
        ch = b""
        for n in names:
            ch += n.encode() + b"\x00"
            ch += struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
        ch += b"\x00"
        _write_attr(f, "channels", "chlist", ch)
        _write_attr(f, "compression", "compression", struct.pack("<B", compression))
        box = struct.pack("<4i", 0, 0, w - 1, h - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("<B", 0))
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        offset_table_pos = f.tell()
        f.write(b"\x00" * (8 * n_blocks))  # placeholder

        offsets = []
        for b in range(n_blocks):
            y0 = b * lines_per_block
            y1 = min(y0 + lines_per_block, h)
            # Block layout: per scanline, per channel, all pixels.
            parts = []
            for y in range(y0, y1):
                for a in arrs:
                    parts.append(a[y].tobytes())
            raw = b"".join(parts)
            if compression in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
                data = _zip_compress(raw)
            else:
                data = raw
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)

        f.seek(offset_table_pos)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))


def _read_attr_stream(f):
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            return
        typ = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            typ += c
        (size,) = struct.unpack("<i", f.read(4))
        data = f.read(size)
        yield name.decode(), typ.decode(), data


def read_exr(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a single-part scanline EXR.  Returns ({channel: (H, W) float32
    array}, header_info)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise NotImplementedError("multi-part EXR not supported")
        if version & 0x800:
            raise NotImplementedError("deep EXR not supported")
        if version & 0x8:  # tiled single-part
            raise NotImplementedError("tiled EXR not supported")

        chans = []  # (name, pixel_type)
        compression = ZIP_COMPRESSION
        dw = None
        for name, typ, data in _read_attr_stream(f):
            if name == "channels":
                i = 0
                while data[i] != 0:
                    j = data.index(b"\x00", i)
                    cname = data[i:j].decode()
                    ptype, _pl, _r0, _r1, _r2, _xs, _ys = struct.unpack(
                        "<iBBBBii", data[j + 1 : j + 17]
                    )
                    chans.append((cname, ptype))
                    i = j + 17
            elif name == "compression":
                compression = data[0]
            elif name == "dataWindow":
                dw = struct.unpack("<4i", data)

        if compression not in _LINES_PER_BLOCK:
            raise NotImplementedError(
                f"EXR compression {compression} not supported (NONE/ZIP/ZIPS only)"
            )
        xmin, ymin, xmax, ymax = dw
        w, h = xmax - xmin + 1, ymax - ymin + 1
        lines_per_block = _LINES_PER_BLOCK[compression]
        n_blocks = (h + lines_per_block - 1) // lines_per_block
        offsets = struct.unpack(f"<{n_blocks}Q", f.read(8 * n_blocks))

        bytes_per_px = sum(_DTYPES[pt].itemsize for _, pt in chans)
        out = {
            cname: np.empty((h, w), dtype=_DTYPES[pt]) for cname, pt in chans
        }
        for off in offsets:
            f.seek(off)
            y, size = struct.unpack("<ii", f.read(8))
            buf = f.read(size)
            y -= ymin
            n_lines = min(lines_per_block, h - y)
            raw_size = n_lines * w * bytes_per_px
            if compression in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
                raw = _zip_decompress(buf, raw_size)
            else:
                raw = buf
            pos = 0
            for line in range(y, y + n_lines):
                for cname, pt in chans:
                    dt = _DTYPES[pt]
                    n = w * dt.itemsize
                    out[cname][line] = np.frombuffer(raw[pos : pos + n], dtype=dt)
                    pos += n

        info = dict(
            width=w, height=h, data_window=dw, compression=compression,
            channels=[c for c, _ in chans],
        )
        return {k: v.astype(np.float32) for k, v in out.items()}, info


def read_exr_rgb(path: str) -> np.ndarray:
    """Convenience: read R,G,B channels into an (H, W, 3) float32 array."""
    chans, _ = read_exr(path)
    return np.stack([chans["R"], chans["G"], chans["B"]], axis=-1)


def write_exr_rgb(path: str, rgb: np.ndarray, half: bool = True) -> None:
    rgb = np.asarray(rgb)
    write_exr(path, {"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]}, half=half)
