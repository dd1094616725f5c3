"""Radiance .hdr files and image output in the port (utils/image_io.py,
backgrounds/environment.py) against the JAX package's.

save_hdr must write the same bytes, load_hdr read the same floats from
plain and run-length scanlines, and an .hdr environment render its
linear radiance unclipped (its compiled tables are held against the JAX
package's in tests/test_torch_compile.py).
"""

import numpy as np
import pytest

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.utils import image_io as jio
from raytracer_tpu_torch.utils import image_io as tio


def _arrays():
    rng = np.random.default_rng(7)
    hdr = (rng.uniform(0, 1, (16, 24, 3)) ** 2) * rng.choice(
        [0.01, 1.0, 37.5], (16, 24, 1))
    hdr[0, :4] = 0.0
    hdr[1, :4] = 1e-40                       # below RGBE's range: written 0
    hdr[2, :4] = 6.0e4
    return {"mixed": hdr, "zeros": np.zeros((4, 8, 3)),
            "negative": -hdr[:4], "float32": hdr.astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_save_hdr_writes_jax_bytes(tmp_path, name):
    a = _arrays()[name]
    tio.save_hdr(a, tmp_path / "t.hdr")
    jio.save_hdr(a, tmp_path / "j.hdr")
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    got = tio.load_hdr(tmp_path / "t.hdr")
    assert got.dtype == np.float32
    assert np.array_equal(got, jio.load_hdr(tmp_path / "j.hdr"))


def test_hdr_round_trip(tmp_path):
    """Linear radiance survives to RGBE precision, far above 1.0 too."""
    a = _arrays()["mixed"][3:]
    tio.save_hdr(a, tmp_path / "t.hdr")
    b = tio.load_hdr(tmp_path / "t.hdr")
    m = a.max(axis=2, keepdims=True)
    assert (np.abs(b - a) <= m / 256.0 + 1e-7).all()


def _rle_file(plain, out):
    """Re-encode the RGBE quadruples of a plain file as new-RLE scanlines
    (tests/test_components.py test_hdr_rle_load)."""
    raw = plain.read_bytes()
    head_end = raw.index(b"\n\n") + 2
    dims_end = raw.index(b"\n", head_end) + 1
    h, w = (int(x) for x in raw[head_end:dims_end].split()[1::2])
    rgbe = np.frombuffer(raw[dims_end:], np.uint8).reshape(h, w, 4)
    buf = bytearray(raw[:dims_end])
    for y in range(h):
        buf += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and row[x + run] == row[x] and run < 127:
                    run += 1
                if run >= 3:
                    buf += bytes([128 + run, int(row[x])])
                    x += run
                else:
                    lit = min(2, w - x)
                    buf += bytes([lit]) + row[x:x + lit].tobytes()
                    x += lit
    out.write_bytes(bytes(buf))


def test_load_hdr_rle_matches_jax_and_plain(tmp_path):
    rng = np.random.default_rng(3)
    a = np.repeat(rng.uniform(0, 20, (12, 4, 3)), 8, axis=1)
    a[5] = rng.uniform(0, 20, (32, 3))       # a row of literals
    plain, rle = tmp_path / "p.hdr", tmp_path / "r.hdr"
    tio.save_hdr(a, plain)
    _rle_file(plain, rle)
    got = tio.load_hdr(rle)
    assert np.array_equal(got, tio.load_hdr(plain))
    assert np.array_equal(got, jio.load_hdr(rle))


def test_load_hdr_rejects_bad_files(tmp_path):
    p = tmp_path / "x.hdr"
    p.write_bytes(b"P6\n2 2\n255\n")
    with pytest.raises(ValueError, match="not a Radiance file"):
        tio.load_hdr(p)
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n")
    with pytest.raises(ValueError, match="orientation"):
        tio.load_hdr(p)
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n\x01")
    with pytest.raises(ValueError, match="truncated"):
        tio.load_hdr(p)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        tio.save_hdr(np.zeros((2, 2)), p)


def test_hdr_environment_renders_linear_radiance(tmp_path):
    """Values above 1 reach the image unclipped through the record
    path's plain version (tests/test_components.py
    test_hdr_environment_is_linear_and_gated)."""
    env = np.full((8, 16, 3), 5.0, np.float32)
    env[:, :, 1] = 2.0
    p = tmp_path / "env.hdr"
    tio.save_hdr(env, p)
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 0), look_at=T.vec3(0, 0, -1),
                  screen_width=8, screen_height=8)
    sc.add(T.Panorama(str(p)))
    lin = sc.render(samples_per_pixel=1, seed=0, output="linear", device="cpu")
    assert np.allclose(lin[..., 0], 5.0, rtol=0.02)
    assert np.allclose(lin[..., 1], 2.0, rtol=0.02)


def test_hdr_env_blur_wide_kernel(tmp_path):
    env = np.zeros((8, 16, 3), np.float32)
    env[4, 8] = 500.0
    p = tmp_path / "e.hdr"
    tio.save_hdr(env, p)
    bt = T.Panorama(str(p), blur=6.0).material.blur_texture
    assert bt.shape == (8, 16, 3) and np.isfinite(bt).all()
    assert bt.max() > 1.0
    assert np.array_equal(bt, J.Panorama(str(p), blur=6.0).material.blur_texture)


def test_png_output_and_blurred_load_match_jax(tmp_path):
    from PIL import Image

    a = np.random.default_rng(2).uniform(-0.2, 1.2, (6, 10, 3))
    tio.save_image(a, tmp_path / "t.png")
    jio.save_image(a, tmp_path / "j.png")
    got = np.asarray(Image.open(tmp_path / "t.png"))
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "j.png")))
    assert np.array_equal(got, np.asarray(tio.array_to_pil(a)))
    for blur in (0.0, 1.5):
        assert np.array_equal(
            tio.load_image_with_blur(str(tmp_path / "t.png"), blur=blur),
            jio.load_image_with_blur(str(tmp_path / "t.png"), blur=blur))
