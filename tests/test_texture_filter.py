"""Bilinear filter mode: smooth texture/env gradients for optimization."""

import numpy as np
import jax
import jax.numpy as jnp

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.ops.envmap import sample_env_bilinear, sample_env_nearest
from vrenderer_pathtracer.ops.texture import fetch_bilinear, fetch_nearest
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import Scene


def test_bilinear_matches_nearest_at_texel_centers():
    rng = np.random.default_rng(0)
    tex = jnp.asarray(rng.uniform(0, 1, (8, 8, 3)).astype(np.float32))
    # Texel centers: u = (i + 0.5)/W
    u = (jnp.arange(8, dtype=jnp.float32) + 0.5) / 8.0
    v = jnp.full((8,), (3 + 0.5) / 8.0)
    a = fetch_nearest(tex, u, v)
    b = fetch_bilinear(tex, u, v)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_env_bilinear_continuous_across_texels():
    """Bilinear env fetch has no nearest-fetch jumps for nearby directions."""
    rng = np.random.default_rng(1)
    hdr = jnp.asarray(rng.uniform(0, 2, (16, 32, 3)).astype(np.float32))
    base = np.array([0.3, 0.2, 0.93])
    base /= np.linalg.norm(base)
    # Sweep far enough to cross several texel boundaries (32-wide map:
    # a texel spans ~0.2 rad of yaw).
    eps_dirs = [base + np.array([e, 0, 0]) for e in np.linspace(0, 0.5, 60)]
    d = jnp.asarray(np.stack([v / np.linalg.norm(v) for v in eps_dirs]),
                    jnp.float32)
    smooth = np.asarray(sample_env_bilinear(hdr, d))
    hard = np.asarray(sample_env_nearest(hdr, d))
    hard_steps = np.abs(np.diff(hard, axis=0)).max()
    steps = np.abs(np.diff(smooth, axis=0)).max()
    assert hard_steps > 0.1, "sweep failed to cross a texel boundary"
    assert steps < 0.5 * hard_steps, (steps, hard_steps)


def test_bilinear_mode_renders_and_differentiates():
    settings = RenderSettings(
        width=12, height=12, bounces=2, samples_per_pass=2,
        use_example_sphere=True, has_hdr=True, has_diffuse_map=True,
        texture_filter="bilinear",
    )
    rng = np.random.default_rng(2)
    hdr = jnp.asarray(rng.uniform(0.2, 1.0, (8, 16, 3)).astype(np.float32))
    tex = jnp.asarray(rng.uniform(0.2, 0.9, (8, 8, 3)).astype(np.float32))
    scene = Scene.analytic(settings, hdr=hdr)._replace(diffuse_map=tex)
    cam = Camera.default()
    ray_o, ray_d = generate_rays(cam, 12, 12)
    ids = pixel_ids(12, 12)

    def loss(t, h):
        rgb, _ = render_pass(
            scene._replace(diffuse_map=t, hdr=h), settings, ray_o, ray_d,
            ids, jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
        return jnp.mean(rgb)

    g_tex, g_hdr = jax.grad(loss, argnums=(0, 1))(tex, hdr)
    assert np.isfinite(np.asarray(g_tex)).all()
    assert np.isfinite(np.asarray(g_hdr)).all()
    # Bilinear spreads each fetch over 4 texels: more texels receive grads
    # than in nearest mode.
    n_bilinear = int((np.abs(np.asarray(g_hdr)).sum(-1) > 0).sum())
    assert n_bilinear > 0
