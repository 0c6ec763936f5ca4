"""Image utilities: RGB8 quantization, PNG writing, PSNR (numpy; a copy of
gaussian_ray_tracing_tpu/utils/image.py so the port needs no jax), and the
PNG reading and Lanczos downscaling the JAX package takes from PIL, in
stdlib zlib and numpy (the GPU machine has no PIL)."""

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


_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type: gray, RGB, RGBA


def _unfilter_sequential(line: np.ndarray, prior: np.ndarray, bpp: int, ftype: int):
    """Average (3) and Paeth (4) filters, pixel by pixel along the row."""
    out = np.zeros(line.size, np.int32)
    raw, up = line.astype(np.int32), prior.astype(np.int32)
    for x in range(0, line.size, bpp):
        left = out[x - bpp : x] if x else np.zeros(bpp, np.int32)
        above = up[x : x + bpp]
        if ftype == 3:
            pred = (left + above) // 2
        else:
            ul = up[x - bpp : x] if x else np.zeros(bpp, np.int32)
            p = left + above - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - above), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, above, ul))
        out[x : x + bpp] = (raw[x : x + bpp] + pred) & 255
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced gray, RGB or RGBA PNG (filters 0-4)
    into an (H, W) or (H, W, C) uint8 array."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(f"{path}: PNG bit depth {depth}, colour type {ctype}, "
                                  f"interlace {interlace} (8-bit gray/RGB/RGBA, no interlace)")
    bpp = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 per channel
            cur = np.add.accumulate(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = _unfilter_sequential(line, prior, bpp, ftype)
        else:
            raise ValueError(f"{path}: unknown PNG filter {ftype}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


_PRECISION = 22  # PIL's fixed-point bits for 8-bit resampling (32 - 8 - 2)


def _lanczos(x: np.ndarray) -> np.ndarray:
    sinc = lambda v: np.where(v == 0.0, 1.0, np.sin(np.pi * v) / np.where(v == 0.0, 1.0, np.pi * v))
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _resample_weights(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the Lanczos filter: per output pixel the
    first input pixel, and (out, ksize) fixed-point weights."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.float64)
    xmins = np.zeros(out_size, np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _lanczos((np.arange(xmax) + xmin - center + 0.5) / fscale)
        ww = w.sum()
        kk[xx, :xmax] = w / ww if ww != 0.0 else w
        xmins[xx] = xmin
    k_int = np.where(kk < 0, -0.5 + kk * (1 << _PRECISION), 0.5 + kk * (1 << _PRECISION))
    return xmins, np.trunc(k_int).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit Lanczos pass along `axis` of an (H, W, C) uint8 image."""
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    xmins, k = _resample_weights(x.shape[0], out_size)
    idx = np.clip(xmins[:, None] + np.arange(k.shape[1])[None, :], 0, x.shape[0] - 1)
    acc = np.einsum("ok,ok...->o...", k, x[idx]) + (1 << (_PRECISION - 1))
    out = np.clip(acc >> _PRECISION, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's Image.resize((width, height), Image.LANCZOS) of an 8-bit gray,
    RGB or RGBA image: separable (horizontal pass first), support 3 x the
    scale factor, normalised weights in 22-bit fixed point, uint8 rounding
    between the passes; RGBA is resampled premultiplied by alpha, as PIL
    does (RGBa), and unpremultiplied after."""
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    rgba = x.shape[-1] == 4
    if rgba:  # PIL's rgba2rgbA: MULDIV255 with rounding
        a = x[..., 3:].astype(np.int64)
        t = x[..., :3].astype(np.int64) * a + 128
        pre = np.where(a == 255, x[..., :3], ((t >> 8) + t) >> 8)
        x = np.concatenate([pre.astype(np.uint8), x[..., 3:]], axis=-1)
    if width != x.shape[1]:
        x = _resample_axis(x, width, 1)
    if height != x.shape[0]:
        x = _resample_axis(x, height, 0)
    if rgba:  # PIL's rgbA2rgba
        a = x[..., 3:].astype(np.int64)
        rgb = np.where((a == 0) | (a == 255), x[..., :3],
                       np.clip(255 * x[..., :3].astype(np.int64) // np.maximum(a, 1), 0, 255))
        x = np.concatenate([rgb.astype(np.uint8), x[..., 3:]], axis=-1)
    return x[..., 0] if gray else x


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
