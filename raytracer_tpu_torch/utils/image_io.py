"""Host-side image loading and output.

Counterpart of raytracer_tpu/utils/image_io.py: the asset search path
(`add_asset_root`, `resolve_asset`), `load_image` with its /255
normalisation (the JAX package's fix of sightpy's /256), PNG output
(`save_image`, `array_to_pil`) and Radiance RGBE files (`save_hdr`,
`load_hdr`, plain and run-length scanlines).  Pillow is imported only
when a PNG / JPEG file is read or written, so ndarray textures, `.hdr`
files and `render(output="linear")` work on machines without it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .colour import srgb_to_srgb_linear

# Scenes name textures by bare filename (sightpy's API); files are looked
# up in each root and its textures/ backgrounds/ normalmaps/ subdirectories.
_DEFAULT_ROOTS = [Path(__file__).resolve().parent.parent / "assets"]
if os.environ.get("SIGHTPY_ASSETS"):
    _DEFAULT_ROOTS.insert(0, Path(os.environ["SIGHTPY_ASSETS"]))

_SUBDIRS = ("", "textures", "backgrounds", "normalmaps", "backgrounds/lightmaps")


def add_asset_root(path):
    """Prepend a directory to the asset search path."""
    _DEFAULT_ROOTS.insert(0, Path(path))


def resolve_asset(name, subdir_hint=None):
    """Find an asset file by name (or return the path unchanged if it exists)."""
    p = Path(name)
    if p.is_absolute() or p.exists():
        return p
    subdirs = ([subdir_hint] if subdir_hint else []) + list(_SUBDIRS)
    for root in _DEFAULT_ROOTS:
        for sub in subdirs:
            cand = root / sub / name
            if cand.exists():
                return cand
    raise FileNotFoundError(
        f"asset {name!r} not found under roots {[str(r) for r in _DEFAULT_ROOTS]}; "
        "set SIGHTPY_ASSETS or call add_asset_root()")


def load_image(path, subdir_hint=None, blur=0.0):
    """Load an image as a float32 array in [0, 1], shape (H, W, 3)."""
    found = resolve_asset(path, subdir_hint)
    from PIL import Image, ImageFilter

    img = Image.open(found)
    if blur != 0.0:
        img = img.filter(ImageFilter.GaussianBlur(radius=blur))
    a = np.asarray(img, dtype=np.float32) / 255.0
    if a.ndim == 2:
        a = np.stack([a, a, a], axis=-1)
    return a[..., :3]


def load_image_with_blur(path, blur=0.0, subdir_hint=None):
    return load_image(path, subdir_hint=subdir_hint, blur=blur)


def load_image_as_linear_srgb(path, blur=0.0, subdir_hint=None):
    """Load an image and linearise it (sightpy image_functions.py:19-33)."""
    return srgb_to_srgb_linear(
        load_image(path, subdir_hint=subdir_hint, blur=blur)).astype(np.float32)


def array_to_pil(array):
    """Convert a (H, W, 3) float [0, 1] array to a PIL RGB image."""
    from PIL import Image

    a = np.clip(np.asarray(array), 0.0, 1.0)
    return Image.fromarray((a * 255).astype(np.uint8), "RGB")


def save_image(array, path):
    """Save a (H, W, 3) float [0, 1] array as PNG."""
    array_to_pil(array).save(path)


def save_hdr(array, path):
    """Save a (H, W, 3) linear float array as a Radiance .hdr (RGBE) file.

    Plain (uncompressed) RGBE scanlines: shared-exponent u8 quadruples,
    which every HDR tool reads.  For `render(output="linear")` and
    `Scene.render_environment`; sightpy writes 8-bit PNGs only.
    """
    a = np.asarray(array, np.float64)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) linear radiance, got {a.shape}")
    a = np.maximum(a, 0.0)
    h, w, _ = a.shape
    m = a.max(axis=2)
    # m = frac * 2**exp with frac in [0.5, 1); RGBE stores each channel
    # as channel * 256 / 2**exp, truncated, and exp biased by 128
    frac, exp = np.frexp(m)
    scale = np.where(m > 1e-38, np.ldexp(256.0, -exp), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(a * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-38, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _rle_scanlines(raw, h, w, path):
    """(h, w, 4) uint8 RGBE of new-RLE scanlines (0x02 0x02 marker)."""
    rgbe = np.empty((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if raw[pos] != 2 or raw[pos + 1] != 2 or \
                (raw[pos + 2] << 8 | raw[pos + 3]) != w:
            raise ValueError(f"{path}: bad RLE scanline header at row {y}")
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                n = raw[pos]
                pos += 1
                if n > 128:                       # a run of one value
                    rgbe[y, x:x + n - 128, c] = raw[pos]
                    pos += 1
                    x += n - 128
                else:                             # a literal span
                    rgbe[y, x:x + n, c] = np.frombuffer(raw[pos:pos + n],
                                                        np.uint8)
                    pos += n
                    x += n
            if x != w:
                raise ValueError(f"{path}: RLE overrun at row {y}")
    return rgbe


def load_hdr(path):
    """Load a Radiance .hdr / .rgbe file, plain or new-RLE scanlines.

    Returns (H, W, 3) float32 linear radiance.  Reads both the plain
    layout save_hdr writes and the run-length scanlines that almost every
    distributed .hdr uses.
    """
    with open(path, "rb") as f:
        if f.readline().rstrip() not in (b"#?RADIANCE", b"#?RGBE"):
            raise ValueError(f"{path}: not a Radiance file")
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            if line.strip() == b"":
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported orientation {dims}")
        h, w = int(dims[1]), int(dims[3])
        raw = f.read()

    if not (8 <= w < 32768) or len(raw) < 4 or raw[0] != 2 or raw[1] != 2:
        if len(raw) < h * w * 4:
            raise ValueError(f"{path}: truncated pixel data")
        rgbe = np.frombuffer(raw[:h * w * 4], np.uint8).reshape(h, w, 4)
    else:
        rgbe = _rle_scanlines(raw, h, w, path)
    e = rgbe[..., 3].astype(np.float64)
    scale = np.where(e > 0, np.ldexp(1.0, (e - 136).astype(np.int32)), 0.0)
    return ((rgbe[..., :3].astype(np.float64) + 0.5)
            * scale[..., None]).astype(np.float32)
