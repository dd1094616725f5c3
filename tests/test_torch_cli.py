"""The port's command line (raytracer_tpu_torch/cli.py) against the JAX
package's (raytracer_tpu/cli.py), on the CPU (`--device cpu`).

The scene files are the JAX CLI tests' emissive sphere written for each
package; an emissive scene draws nothing past the camera jitter, so the
two CLIs' PNGs agree but at the silhouette (at most 5% of the pixels
differ), and `convert` writes the same JSON document.  Also: every
command's output line and files, the JAX scene refused by name,
`--sharded` on one CPU shard giving the unsharded image, the card default raising
without a card, and `python -m raytracer_tpu_torch devices` as a
process.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from raytracer_tpu.cli import main as jmain
from raytracer_tpu_torch.cli import main

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent

SCENE = '''
from {pkg} import *

def build_scene(width=24, height=16):
    sc = Scene()
    sc.add_Camera(look_from=vec3(0, 0, 1), look_at=vec3(0, 0, -1),
                  screen_width=width, screen_height=height)
    sc.add(Sphere(material=Emissive(color=rgb(1.0, 0.6, 0.3)),
                  center=vec3(0, 0, -3), radius=1.2))
    return sc

Sc = build_scene()

import numpy as np
def update_scene(scene, t):
    scene.scene_primitives[0].center = np.asarray(
        [1.5 * t - 0.75, 0.0, -3.0], np.float32)
'''


@pytest.fixture()
def files(tmp_path):
    out = {}
    for pkg in ("raytracer_tpu_torch", "raytracer_tpu"):
        p = tmp_path / f"{pkg}_scene.py"
        p.write_text(SCENE.format(pkg=pkg))
        out[pkg] = p
    return out["raytracer_tpu_torch"], out["raytracer_tpu"]


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _img(p):
    return np.asarray(Image.open(p)).astype(int)


CPU = ["--device", "cpu"]


def test_render_against_jax(files, tmp_path, capsys):
    port, jax_file = files
    main(["render", str(port), "--spp", "2", "-o", str(tmp_path / "t.png")]
         + CPU)
    line = _line(capsys)
    assert line["device"] == "cpu" and line["samples_per_pixel_traced"] == 2
    jmain(["render", str(jax_file), "--spp", "2", "-o",
           str(tmp_path / "j.png")])
    capsys.readouterr()
    a, b = _img(tmp_path / "t.png"), _img(tmp_path / "j.png")
    assert a.shape == b.shape == (16, 24, 3) and a.max() > 100
    assert (np.abs(a - b).max(-1) > 0).mean() < 0.05
    main(["render", str(port), "--spp", "2", "--width", "12", "--height",
          "8", "--hdr", "-o", str(tmp_path / "t.png")] + CPU)
    line = _line(capsys)
    assert line["out"].endswith(".hdr") and Path(line["out"]).exists()


def test_render_options(files, tmp_path, capsys):
    port, _ = files
    base = tmp_path / "base.png"
    main(["render", str(port), "--spp", "4", "-o", str(base), "--preview",
          str(tmp_path / "live.png")] + CPU)
    capsys.readouterr()
    assert np.array_equal(_img(base), _img(tmp_path / "live.png"))
    main(["render", str(port), "--spp", "2", "--tonemap", "reinhard",
          "--exposure", "1", "-o", str(tmp_path / "up.png")] + CPU)
    capsys.readouterr()
    lit = _img(base).sum(-1) > 30
    assert lit.any() and _img(tmp_path / "up.png")[lit].mean() != \
        _img(base)[lit].mean()
    main(["render", str(port), "--spp", "2", "--denoise", "-o",
          str(tmp_path / "dn.png")] + CPU)
    assert Path(_line(capsys)["out"]).exists()
    main(["render", str(port), "--spp", "8", "--motion-blur", "--slices", "4",
          "-o", str(tmp_path / "mb.png")] + CPU)
    assert _line(capsys)["motion_blur"] is True
    assert ((_img(tmp_path / "mb.png").sum(-1) > 30).any(axis=0)).sum() > 10
    main(["render", str(port), "--spp", "2", "--profile-dir",
          str(tmp_path / "prof"), "-o", str(tmp_path / "p.png")] + CPU)
    capsys.readouterr()
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    # --sharded: one CPU shard, the unsharded image pixel for pixel
    main(["render", str(port), "--spp", "4", "--sharded", "-o",
          str(tmp_path / "sh.png")] + CPU)
    assert _line(capsys)["sharded"] is True
    assert np.abs(_img(tmp_path / "sh.png") - _img(base)).max() <= 1
    with pytest.raises(SystemExit, match="sharded"):
        main(["render", str(port), "--sharded", "--hdr"] + CPU)
    with pytest.raises(SystemExit, match="tonemap"):
        main(["render", str(port), "--hdr", "--exposure", "1"] + CPU)


def test_aovs_ods_animate_bake_convert(files, tmp_path, capsys):
    port, jax_file = files
    main(["aovs", str(port), "--spp", "2", "--ao-samples", "2", "-o",
          str(tmp_path / "aov_{}.png")] + CPU)
    line = _line(capsys)
    jmain(["aovs", str(jax_file), "--spp", "2", "--ao-samples", "2", "-o",
           str(tmp_path / "jaov_{}.png")])
    assert line["planes"] == _line(capsys)["planes"]
    assert all(Path(f).exists() for f in line["files"])
    main(["ods", str(port), "--spp", "1", "--ipd", "0.1", "-o",
          str(tmp_path / "ods.png")] + CPU)
    assert _line(capsys)["layout"] == "top-bottom"
    assert _img(tmp_path / "ods.png").shape == (32, 24, 3)
    main(["animate", str(port), "--spp", "1", "--fps", "4", "-o",
          str(tmp_path / "frames")] + CPU)
    assert _line(capsys)["frames_per_s"] > 0
    assert len(list((tmp_path / "frames").glob("*.png"))) == 4
    main(["bake", str(port), "--spp", "2", "--width", "32", "--height", "16",
          "-o", str(tmp_path / "env.hdr")] + CPU)
    assert _line(capsys)["shape"] == [16, 32, 3]
    main(["convert", str(port), "-o", str(tmp_path / "t.json")])
    jmain(["convert", str(jax_file), "-o", str(tmp_path / "j.json")])
    capsys.readouterr()
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    main(["render", str(tmp_path / "t.json"), "--spp", "1", "-o",
          str(tmp_path / "json.png")] + CPU)
    assert _line(capsys)["out"].endswith("json.png")


def test_scene_files_are_checked(files, tmp_path):
    port, jax_file = files
    with pytest.raises(SystemExit, match="not a raytracer_tpu_torch.Scene"):
        main(["render", str(jax_file)] + CPU)
    with pytest.raises(SystemExit, match="not found"):
        main(["render", str(tmp_path / "nope.py")] + CPU)
    empty = tmp_path / "empty.py"
    empty.write_text("x = 1\n")
    with pytest.raises(SystemExit, match="neither"):
        main(["render", str(empty)] + CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["render", str(port), "--spp", "1", "-o",
                  str(tmp_path / "x.png")])


def test_devices_as_a_process():
    out = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch",
                          "devices"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device_count"] == torch.cuda.device_count()
    assert line["torch"] == torch.__version__
