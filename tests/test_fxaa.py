"""FXAA property tests: identity on flat images, smoothing on jaggies,
local boundedness, and toggle wiring through the renderer."""

import numpy as np
import jax.numpy as jnp

from vrenderer_pathtracer.ops.fxaa import fxaa


def _staircase(h=48, w=48):
    """Hard diagonal edge: the canonical aliasing case."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = (xs + 0.8 * ys > w * 0.7).astype(np.float32)
    return np.stack([img, img, img], axis=-1)


def test_flat_image_unchanged():
    img = jnp.full((32, 32, 3), 0.4, jnp.float32)
    out = fxaa(img)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)


def test_below_threshold_unchanged():
    rng = np.random.default_rng(0)
    base = 0.5 + 0.005 * rng.standard_normal((32, 32, 3)).astype(np.float32)
    out = fxaa(jnp.asarray(base))
    np.testing.assert_allclose(np.asarray(out), base, atol=1e-6)


def test_diagonal_edge_smoothed():
    img = jnp.asarray(_staircase())
    out = np.asarray(fxaa(img))
    # Intermediate values appear along the edge (anti-aliasing happened)...
    frac_mid = ((out[..., 1] > 0.05) & (out[..., 1] < 0.95)).mean()
    assert frac_mid > 0.01, "no blended pixels along the edge"
    # ...and edge "jaggedness" (gradient total variation along rows) drops.
    def tv(a):
        return np.abs(np.diff(a[..., 1], axis=1)).sum()
    assert tv(out) <= tv(np.asarray(img)) + 1e-3


def test_output_locally_bounded():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (40, 40, 3)).astype(np.float32)
    out = np.asarray(fxaa(jnp.asarray(img)))
    assert out.min() >= img.min() - 1e-5
    assert out.max() <= img.max() + 1e-5


def test_renderer_toggle():
    from vrenderer_pathtracer import Renderer, RenderSettings

    r = Renderer(32, 32, settings=RenderSettings(
        use_cornell_box=True, has_hdr=False, samples_per_pass=2, bounces=2))
    img_off, _ = r.render()
    r.toggle_fxaa(True)
    assert r.settings.use_fxaa
    # Same accumulation state: FXAA applies at display time only.
    img_on, _ = r.render()
    assert np.isfinite(np.asarray(img_on)).all()
    assert img_on.shape == img_off.shape
