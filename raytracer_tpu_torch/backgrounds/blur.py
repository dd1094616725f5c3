"""Skybox blur preprocessing (host side).

Counterpart of raytracer_tpu/backgrounds/blur.py, the same numpy code and
the same lazy Pillow import (Pillow is needed only when blur > 0).

Reference-exact per-face neighbour stitching
(sightpy/backgrounds/util/blur_background.py:17-132): each cubemap face is
blurred inside a 3N x 3N montage with its four adjacent faces pasted in —
rot90'd so their content lines up across the shared edge — and the blurred
center crop is reassembled into the 4x3 cross.  The montage corners stay
black, the blur runs on the 8-bit sRGB image and the result is read back as
/256, exactly as the reference does, so blurred lightmaps match bit-close.

`_fill_empty_cells` (edge replication) remains for the HDR path
(environment.py): HDR crosses blur in unbounded linear radiance where the
reference's uint8 round-trip does not apply.
"""

from __future__ import annotations

import numpy as np

from ..utils.colour import srgb_to_srgb_linear

# cross cells present in a 4x3 cubemap: (col, row) with row 0 = bottom strip
_FILLED = {(1, 0), (0, 1), (1, 1), (2, 1), (3, 1), (1, 2)}

# neighbour montage per face (blur_background.py): cell -> (source face,
# np.rot90 quarter turns).  Verified line-by-line against the reference's
# six per-face paste blocks.
_MONTAGE = {
    "front":  {"left": ("left", 0), "right": ("right", 0),
               "top": ("top", 0), "bottom": ("bottom", 0)},
    "right":  {"left": ("front", 0), "right": ("back", 0),
               "top": ("top", -1), "bottom": ("bottom", 1)},
    "back":   {"left": ("right", 0), "right": ("left", 0),
               "top": ("top", 2), "bottom": ("bottom", 2)},
    "left":   {"left": ("back", 0), "right": ("front", 0),
               "top": ("top", 1), "bottom": ("bottom", -1)},
    "top":    {"left": ("left", -1), "right": ("right", 1),
               "top": ("back", 2), "bottom": ("front", 0)},
    "bottom": {"left": ("left", 1), "right": ("right", -1),
               "top": ("front", 0), "bottom": ("back", 2)},
}


def _fill_empty_cells(img):
    """Replicate adjacent-face edges into the empty cross cells."""
    H, W = img.shape[:2]
    ch, cw = H // 3, W // 4
    out = img.copy()
    for col in range(4):
        for row in range(3):
            if (col, row) in _FILLED:
                continue
            y0, y1 = row * ch, (row + 1) * ch
            x0, x1 = col * cw, (col + 1) * cw
            # prefer horizontal neighbour, else vertical neighbour
            if (col - 1, row) in _FILLED:
                out[y0:y1, x0:x1] = img[y0:y1, x0 - 1:x0][:, :1]
            elif (col + 1, row) in _FILLED:
                out[y0:y1, x0:x1] = img[y0:y1, x1:x1 + 1][:, :1]
            elif (col, row - 1) in _FILLED:
                out[y0:y1, x0:x1] = img[y0 - 1:y0, x0:x1][:1, :]
            elif (col, row + 1) in _FILLED:
                out[y0:y1, x0:x1] = img[y1:y1 + 1, x0:x1][:1, :]
    return out


def blur_skybox(img_array, blur, cubemap=None):
    """Reference-exact signature (blur_background.py:17).  The third
    argument is only a progress-print label there; ignored here."""
    return blur_skybox_array(img_array, blur)


def blur_skybox_array(img, blur_radius):
    """Gaussian-blur a [0,1] float cubemap cross and return *linear* sRGB.

    Matches the reference blur_skybox (blur_background.py:17-132): per-face
    neighbour montage, PIL GaussianBlur on the (255*x) uint8 image, /256
    readback, linearized output.
    """
    from PIL import Image, ImageFilter

    arr = np.asarray(img, dtype=np.float64)[..., :3]
    H = arr.shape[0]
    N = H // 3
    faces = {
        "left": arr[N:2 * N, 0:N], "front": arr[N:2 * N, N:2 * N],
        "right": arr[N:2 * N, 2 * N:3 * N], "back": arr[N:2 * N, 3 * N:4 * N],
        "top": arr[0:N, N:2 * N], "bottom": arr[2 * N:3 * N, N:2 * N],
    }
    cells = {"left": (slice(N, 2 * N), slice(0, N)),
             "right": (slice(N, 2 * N), slice(2 * N, 3 * N)),
             "top": (slice(0, N), slice(N, 2 * N)),
             "bottom": (slice(2 * N, 3 * N), slice(N, 2 * N))}

    blurred = {}
    for name, layout in _MONTAGE.items():
        canvas = np.zeros((3 * N, 3 * N, 3))
        canvas[N:2 * N, N:2 * N] = faces[name]
        for cell, (src, k) in layout.items():
            canvas[cells[cell]] = np.rot90(faces[src], k=k)
        pil = Image.fromarray((255 * np.clip(canvas, 0, 1)).astype(np.uint8))
        out = pil.filter(ImageFilter.GaussianBlur(radius=blur_radius))
        # /256 readback — the reference's to_array (blur_background.py:14)
        blurred[name] = (np.asarray(out) / 256.0)[N:2 * N, N:2 * N]

    cross = np.zeros((3 * N, 4 * N, 3))
    cross[N:2 * N, 0:N] = blurred["left"]
    cross[N:2 * N, N:2 * N] = blurred["front"]
    cross[N:2 * N, 2 * N:3 * N] = blurred["right"]
    cross[N:2 * N, 3 * N:4 * N] = blurred["back"]
    cross[0:N, N:2 * N] = blurred["top"]
    cross[2 * N:3 * N, N:2 * N] = blurred["bottom"]
    return srgb_to_srgb_linear(cross.astype(np.float32)).astype(np.float32)
