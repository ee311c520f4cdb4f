"""CLI smoke tests: argument wiring, outputs, resume flag plumbing."""

import numpy as np
import pytest

from vrenderer_pathtracer.cli import main


def test_render_cornell_outputs(tmp_path):
    out = tmp_path / "c.png"
    depth = tmp_path / "d.png"
    exr = tmp_path / "c.exr"
    rc = main([
        "render", "--cornell", "--width", "32", "--height", "32",
        "--spp", "4", "--bounces", "2", "--cpu", "--quiet",
        "--out", str(out), "--depth-out", str(depth), "--out-exr", str(exr),
    ])
    assert rc == 0
    assert out.exists() and depth.exists() and exr.exists()

    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (32, 32, 3)
    assert img.mean() > 10  # lit scene

    from vrenderer_pathtracer.native import load_exr

    linear = load_exr(str(exr))
    assert linear.shape == (32, 32, 3)
    assert np.isfinite(linear).all()


def test_render_with_camera_and_fresnel_flags(tmp_path):
    out = tmp_path / "c2.png"
    rc = main([
        "render", "--cornell", "--width", "16", "--height", "16",
        "--spp", "2", "--bounces", "2", "--cpu", "--quiet",
        "--camera", "5", "0", "140", "--yaw", "0.05", "--fov", "60",
        "--fresnel-coef", "0.3", "--fxaa", "--out", str(out),
    ])
    assert rc == 0 and out.exists()


def test_missing_subcommand_errors():
    with pytest.raises(SystemExit):
        main([])
