"""NaN-guard utilities (SURVEY §5.2 sanitizer discipline)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vrenderer_pathtracer.utils import assert_finite_tree, checked


def test_checked_passes_clean_fn():
    f = checked(lambda x: x * 2.0)
    np.testing.assert_allclose(np.asarray(f(jnp.ones(4))), 2.0)


def test_checked_catches_nan():
    f = checked(lambda x: jnp.log(x))  # log(-1) -> NaN
    with pytest.raises(Exception):
        f(jnp.asarray([-1.0]))


def test_checked_render_pass_is_finite():
    """The shading path produces no NaN/Inf on the golden config."""
    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene

    S = RenderSettings(width=16, height=16, samples_per_pass=2, bounces=3,
                       use_cornell_box=True, has_hdr=False)
    scene = Scene.analytic(S)
    cam = Camera.default()
    ro, rd = generate_rays(cam, 16, 16)
    ids = pixel_ids(16, 16)
    f = checked(lambda: render_pass(
        scene, S, ro, rd, ids, jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0)))
    rgb, depth = f()
    assert_finite_tree((rgb, depth), "render")


def test_assert_finite_tree_raises():
    with pytest.raises(AssertionError, match="non-finite"):
        assert_finite_tree({"a": jnp.asarray([1.0, jnp.nan])}, "t")


def test_metrics_logger_coercion(tmp_path):
    """Device scalars / numpy types must coerce to plain JSON values."""
    import json

    import numpy as np

    from vrenderer_pathtracer.utils.metrics import MetricsLogger

    path = tmp_path / "m.jsonl"
    with MetricsLogger(str(path)) as log:
        log.log("x", a=np.float32(1.5), b=np.int64(7), c="s", d=None,
                e=True, f=np.float64(2.0))
    rec = json.loads(path.read_text().splitlines()[0])
    assert rec["event"] == "x" and rec["a"] == 1.5 and rec["b"] == 7
    assert rec["c"] == "s" and rec["d"] is None and rec["e"] is True
    assert rec["f"] == 2 and isinstance(rec["f"], int)  # integral float
    assert "t" in rec and "wall" in rec
