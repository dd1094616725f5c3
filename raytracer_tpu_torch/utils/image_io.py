"""Image output.

Counterpart of `array_to_pil` in raytracer_tpu/utils/image_io.py.  Pillow
is imported only when an image is actually made, so `render(output=
"linear")` works on machines without it.
"""

from __future__ import annotations

import numpy as np


def array_to_pil(array):
    """Convert a (H, W, 3) float [0, 1] array to a PIL RGB image."""
    from PIL import Image

    a = np.clip(np.asarray(array), 0.0, 1.0)
    return Image.fromarray((a * 255).astype(np.uint8), "RGB")
