"""Image IO and the pipeline's mask conventions.

Conventions (reference para_gen.py):
- Annotation masks (DAVIS-style): 0 = background, nonzero = object segment id.
- ARAP solver masks: 0 = solve region (object), ARAP_BG = 255 = excluded
  (para_gen.py:30, 514-517, 526-528; the solver excludes pixels with mask != 0,
  arap_plan.t:11).

PNG is read and written by a small zlib+numpy codec (8-bit gray, gray+alpha,
RGB, RGBA and palette at 1-8 bits, non-interlaced) — every product and every
mask the pipeline touches. Pillow is optional: it is imported here only, and
only for what the codec does not cover (JPEG and other formats, 16-bit or
interlaced PNG, resizing); without it those raise an error that names the
file and Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

ARAP_BG = 255  # para_gen.py:30

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class _Unsupported(Exception):
    """A PNG variant the codec does not decode (handed to Pillow)."""


def _pillow(what: str, path=None):
    """The Pillow Image module, or an ImportError naming the file."""
    try:
        from PIL import Image
    except ImportError as exc:
        where = f" ({path})" if path is not None else ""
        raise ImportError(
            f"{what}{where} needs Pillow, which is not installed; the "
            "built-in codec reads and writes 8-bit non-interlaced PNG only"
        ) from exc
    return Image


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters: raw (h, 1 + stride) -> (h, stride) u8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            lanes = lanes.reshape(-1, bpp).astype(np.uint64)
            cur = (np.cumsum(lanes, 0) % 256).astype(np.uint8).ravel()[:stride]
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = _unfilter_row(line.tolist(), prev.tolist(), bpp, ftype)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_row(line: list, prev: list, bpp: int, ftype: int) -> np.ndarray:
    cur = [0] * len(line)
    for i, v in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            cur[i] = (v + ((a + b) >> 1)) & 255
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (v + pred) & 255
    return np.asarray(cur, np.uint8)


def _decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """-> (pixels (H, W[, C]) u8 as stored, color type, palette (N, 3) or
    None). Palette images return their indices, like np.array of a
    Pillow 'P' image."""
    if data[:8] != _PNG_SIG:
        raise _Unsupported("not a PNG")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or ctype not in _PNG_CHANNELS or depth > 8 or (
        depth < 8 and ctype not in (0, 3)
    ):
        raise _Unsupported(f"PNG depth {depth} color {ctype} "
                           f"interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[: h * (stride + 1)].reshape(h, stride + 1), h,
                     stride, max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, : w * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits.reshape(h, w, depth) * weights).sum(-1).astype(np.uint8)
        if ctype == 0:  # scale gray to 0..255 as Pillow's 'L' does
            px = (px.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(
                np.uint8)
    else:
        px = rows.reshape(h, w, ch)
        if ch == 1:
            px = px[:, :, 0]
    return px, ctype, palette


def png_bytes(arr: np.ndarray, level: int = 1) -> bytes:
    """Encode an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 array.

    Every row uses the Up filter (vectorised); zlib level 1 is ~4× faster
    than level 6 at ~20% larger files."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = a.shape[:2]
    ch = 1 if a.ndim == 2 else a.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = a.reshape(h, w * ch)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def _read(path) -> tuple[np.ndarray, str, np.ndarray | None]:
    """-> (pixels as stored, mode, palette); mode is a Pillow mode name."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        px, ctype, palette = _decode_png(data)
        return px, {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ctype], \
            palette
    except _Unsupported:
        pass
    Image = _pillow("decoding this image", path)
    with Image.open(path) as im:
        if im.mode == "P":
            pal = np.asarray(im.getpalette()[:768], np.uint8).reshape(-1, 3)
            return np.array(im), "P", pal
        if im.mode not in ("L", "LA", "RGB", "RGBA"):
            im = im.convert("RGB")
        return np.array(im), im.mode, None


def image_size(path) -> tuple[int, int]:
    """(w, h) from the header alone (PNG IHDR; other formats via Pillow)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    Image = _pillow("reading this image's size", path)
    with Image.open(path) as im:
        return im.size


def load_image(path) -> np.ndarray:
    """Pixels as stored: (H, W) gray or palette indices, (H, W, C) color —
    what np.array(Image.open(path)) gives."""
    return _read(path)[0]


def load_rgb(path) -> np.ndarray:
    """Load an RGB image as (H, W, 3) uint8 (alpha dropped, gray replicated,
    palette mapped)."""
    px, mode, palette = _read(path)
    if mode == "P":
        return palette[px]
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, 2)
    if mode == "LA":
        return np.repeat(px[:, :, :1], 3, 2)
    return np.ascontiguousarray(px[:, :, :3])


def load_mask(path) -> np.ndarray:
    """Load a mask as (H, W); keeps palette/gray ids, takes channel 0 of RGB.

    Matches the reference's use of np.array(Image.open(...)) on annotation masks
    (para_gen.py:457, 468-479) and mLib's .x channel read in the solver app
    (CombinedSolver.h:213).
    """
    arr = load_image(path)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr


def save_image(path, arr: np.ndarray) -> None:
    """Save an (H, W[, 3|4]) uint8 array; PNG by the built-in codec, any
    other extension through Pillow."""
    arr = np.asarray(arr, dtype=np.uint8)
    if str(path).lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(png_bytes(arr))
        return
    Image = _pillow("encoding this image", path)
    Image.fromarray(arr).save(path)


def resize(arr: np.ndarray, size: tuple, nearest: bool = False) -> np.ndarray:
    """Resize to `size` = (w, h): Lanczos, or nearest-neighbour for masks
    (the reference's PIL resampling, para_gen.py:36-48, 253-291)."""
    Image = _pillow("resizing frames (--size, backgrounds)")
    resample = Image.NEAREST if nearest else Image.LANCZOS
    return np.array(Image.fromarray(arr).resize(tuple(size), resample))


def mask_to_arap(annot_mask: np.ndarray) -> np.ndarray:
    """Single-segment conversion: background (annot==0) -> ARAP_BG, object -> 0.

    Parity with para_gen.py:514-517.
    """
    out = np.zeros_like(annot_mask, dtype=np.uint8)
    out[annot_mask == 0] = ARAP_BG
    return out


def segment_mask_to_arap(annot_mask: np.ndarray, segment_id: int) -> np.ndarray:
    """Per-segment conversion for --multseg: segment s -> 0, all else -> ARAP_BG.

    Parity with para_gen.py:526-528.
    """
    out = np.full_like(annot_mask, ARAP_BG, dtype=np.uint8)
    out[annot_mask == segment_id] = 0
    return out
