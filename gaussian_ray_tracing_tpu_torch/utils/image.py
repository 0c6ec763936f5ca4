"""Image utilities: RGB8 quantization, PNG writing, PSNR (numpy; a copy of
gaussian_ray_tracing_tpu/utils/image.py so the port needs no jax)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize_rgb8(rgb: np.ndarray) -> np.ndarray:
    """Clamp to [0, 1] and quantize as min(uint(x * 256), 255)."""
    x = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    return np.minimum((x * 256.0).astype(np.uint32), 255).astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 or float image as PNG bytes (stdlib zlib)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = quantize_rgb8(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 or float image as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
