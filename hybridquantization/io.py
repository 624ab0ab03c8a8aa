"""Image I/O and layout utilities.

Replaces the reference's Icy Sequence plumbing (HybridQuantization.java:95,
111-125): float [0,1] sRGB (H, W, 3) arrays are the interchange format.
Layout converters mirror makeinline/makeChannels
(HybridQuantization.java:279-309) for users porting planar data.

PIL is used when available; PPM/PGM load/save is implemented natively so the
engine has zero hard I/O dependencies.
"""

from __future__ import annotations

import os

import numpy as np

try:  # pragma: no cover - availability depends on environment
    from PIL import Image  # type: ignore

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


# ---------------------------------------------------------------------------
# Layout converters (reference parity helpers)
# ---------------------------------------------------------------------------

def planar_to_hwc(planar: np.ndarray, width: int) -> np.ndarray:
    """[C][X*Y] planar (Icy layout) -> (H, W, C)."""
    c, n = planar.shape
    return np.ascontiguousarray(
        planar.reshape(c, n // width, width).transpose(1, 2, 0)
    )


def hwc_to_planar(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> [C][X*Y] planar."""
    h, w, c = image.shape
    return np.ascontiguousarray(image.transpose(2, 0, 1).reshape(c, h * w))


def hwc_to_interleaved_rgba(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) -> flat RGBARGBA... with zero padding lane
    (HybridQuantization.makeinline, :279-291)."""
    h, w, _ = image.shape
    out = np.zeros((h * w, 4), dtype=np.float32)
    out[:, :3] = image.reshape(-1, 3)
    return out.reshape(-1)


def interleaved_rgba_to_hwc(flat: np.ndarray, width: int) -> np.ndarray:
    """Flat RGBARGBA... -> (H, W, 3) (HybridQuantization.makeChannels, :293-309)."""
    px = flat.reshape(-1, 4)[:, :3]
    return px.reshape(-1, width, 3)


# ---------------------------------------------------------------------------
# File I/O
# ---------------------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """Load an image file as float32 sRGB (H, W, 3) in [0, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm", ".pnm"):
        return _load_ppm(path)
    if not _HAVE_PIL:
        raise RuntimeError(f"PIL unavailable; cannot load {ext} files")
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def _to_u8(image) -> np.ndarray:
    return np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def as_stored(image) -> np.ndarray:
    """The float image that save_image + load_image give back (8-bit)."""
    return _to_u8(image).astype(np.float32) / 255.0


def save_image(path: str, image: np.ndarray) -> None:
    """Save float [0,1] sRGB (H, W, 3) as an 8-bit image.

    Uses round-half-up like the reference's UBYTE conversion
    (HybridQuantization.java:122).
    """
    u8 = _to_u8(image)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pnm"):
        _save_ppm(path, u8)
        return
    if not _HAVE_PIL:
        raise RuntimeError(f"PIL unavailable; cannot save {ext} files")
    Image.fromarray(u8).save(path)


def _load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()

    # Parse header tokens (magic, width, height, maxval), skipping comments.
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i : i + 1].isspace():
            i += 1
        elif data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
        else:
            j = i
            while j < len(data) and not data[j : j + 1].isspace():
                j += 1
            tokens.append(data[i:j])
            i = j
    magic = tokens[0]
    if magic not in (b"P6", b"P5"):
        raise ValueError(f"unsupported PNM magic {magic!r}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    dtype = np.uint8 if maxval < 256 else ">u2"
    channels = 3 if magic == b"P6" else 1
    raw = np.frombuffer(data, dtype=dtype, count=w * h * channels, offset=i)
    img = raw.reshape(h, w, channels).astype(np.float32) / maxval
    if channels == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def _save_ppm(path: str, u8: np.ndarray) -> None:
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())
