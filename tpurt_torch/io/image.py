"""Image IO dispatch by extension: EXR / PFM / PNG / TGA.

Reference analog: core/imageio.{h,cpp} ReadImage/WriteImage dispatch.
Gamma handling mirrors the reference: 8-bit formats are sRGB-encoded on
write and decoded on read; float formats are linear.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from tpurt_torch.io import exr as _exr


def gamma_correct(v: np.ndarray) -> np.ndarray:
    """Linear -> sRGB (core/pbrt.h GammaCorrect)."""
    v = np.asarray(v, dtype=np.float32)
    return np.where(v <= 0.0031308, 12.92 * v, 1.055 * np.power(np.maximum(v, 1e-10), 1.0 / 2.4) - 0.055)


def inverse_gamma_correct(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


# --- PFM ------------------------------------------------------------------

def write_pfm(path: str, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb, dtype="<f4")
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if rgb.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # little-endian
        # PFM scanlines are bottom-to-top.
        f.write(np.ascontiguousarray(rgb[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if kind == b"PF" else 1)
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dt).astype(np.float32)
    shape = (h, w, 3) if kind == b"PF" else (h, w)
    return data.reshape(shape)[::-1].copy()


# --- PNG (minimal, 8-bit RGB) ----------------------------------------------

def write_png(path: str, rgb8: np.ndarray) -> None:
    rgb8 = np.asarray(rgb8, dtype=np.uint8)
    h, w = rgb8.shape[:2]
    if rgb8.ndim == 2:
        rgb8 = np.repeat(rgb8[..., None], 3, axis=-1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        sig = f.read(8)
        assert sig == b"\x89PNG\r\n\x1a\n", "not a PNG"
        w = h = bitdepth = coltype = None
        idat = b""
        while True:
            (length,) = struct.unpack(">I", f.read(4))
            tag = f.read(4)
            data = f.read(length)
            f.read(4)  # crc
            if tag == b"IHDR":
                w, h, bitdepth, coltype, _comp, _filt, interlace = struct.unpack(
                    ">IIBBBBB", data
                )
                if bitdepth != 8 or interlace != 0:
                    raise NotImplementedError("only 8-bit non-interlaced PNG")
            elif tag == b"IDAT":
                idat += data
            elif tag == b"IEND":
                break
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[coltype]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], dtype=np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(nch, stride):
                line[i] = (int(line[i]) + int(line[i - nch])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                a = int(line[i - nch]) if i >= nch else 0
                line[i] = (int(line[i]) + (a + int(prev[i])) // 2) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - nch]) if i >= nch else 0
                b = int(prev[i])
                c = int(prev[i - nch]) if i >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (int(line[i]) + pred) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, nch)


# --- TGA (uncompressed 24-bit) ---------------------------------------------

def write_tga(path: str, rgb8: np.ndarray) -> None:
    rgb8 = np.asarray(rgb8, dtype=np.uint8)
    h, w = rgb8.shape[:2]
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20)
    bgr = rgb8[..., ::-1]
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(np.ascontiguousarray(bgr).tobytes())


# --- dispatch ---------------------------------------------------------------

def write_image(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) linear float RGB; 8-bit formats get sRGB encoding,
    mirroring imageio.cpp WriteImage."""
    ext = os.path.splitext(path)[1].lower()
    rgb = np.asarray(rgb, dtype=np.float32)
    if ext == ".exr":
        _exr.write_exr_rgb(path, rgb)
    elif ext == ".pfm":
        write_pfm(path, rgb)
    elif ext in (".png", ".tga"):
        u8 = np.clip(gamma_correct(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        (write_png if ext == ".png" else write_tga)(path, u8)
    else:
        raise ValueError(f"unsupported image extension: {ext}")


def read_image(path: str) -> np.ndarray:
    """Read an image as (H, W, 3) linear float32 RGB."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return _exr.read_exr_rgb(path)
    if ext == ".pfm":
        img = read_pfm(path)
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    if ext == ".png":
        img = read_png(path).astype(np.float32) / 255.0
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        return inverse_gamma_correct(img[..., :3])
    raise ValueError(f"unsupported image extension: {ext}")
