"""Radiance RGBE (.hdr) image reader/writer — pure numpy.

A copy of ``largesteps_tpu/io/hdr.py`` (the port imports nothing of the
JAX package).

The reference loads envmaps with imageio's FreeImage HDR plugin
(scripts/load_xml.py:105-108); that plugin needs a network download, so we
implement the RGBE codec directly (format: "#?RADIANCE" header, optional
RLE-compressed scanlines, shared-exponent 4-byte pixels).
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_hdr", "write_hdr"]


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 128 + 8
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros((*rgb.shape[:-1], 4), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(maxc[nz])
    scale = mant * 256.0 / maxc[nz]
    rgbe[nz, :3] = np.clip(rgb[nz] * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[nz, 3] = (exp + 128).astype(np.uint8)
    return rgbe


def read_hdr(path) -> np.ndarray:
    """Read a Radiance .hdr file → (H, W, 3) float32."""
    with open(path, "rb") as fh:
        magic = fh.readline()
        if not magic.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = fh.readline()
            if line in (b"\n", b""):
                break
        dims = fh.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported orientation: {dims}")
        height, width = int(dims[1]), int(dims[3])
        data = fh.read()

    img = np.zeros((height, width, 4), np.uint8)
    pos = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and data[pos] == 2
            and data[pos + 1] == 2
            and (data[pos + 2] << 8 | data[pos + 3]) == width
        ):
            pos += 4  # new-style RLE scanline, per-channel runs
            for c in range(4):
                x = 0
                while x < width:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos
                        )
                        pos += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            img[y] = row
            pos += width * 4
    return _rgbe_to_float(img)


def write_hdr(path, rgb: np.ndarray):
    """Write (H, W, 3) float32 as an uncompressed Radiance .hdr file."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    rgbe = _float_to_rgbe(rgb[..., :3])
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())
