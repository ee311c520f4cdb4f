"""MERL importance sampling (ops/brdf_sampling.py).

North-star item "BRDF importance sampling" (BASELINE.json): the lobe-CDF MIS
sampler must (a) be a valid pdf, (b) estimate the SAME integral as the
reference's cosine estimator (``24 * lookup`` about a cosine draw,
``/root/reference/cuda/src/PathTracer.cu:724-764``), (c) cut variance >=4x on
a glossy (gold-metallic-paint-like) table, and (d) keep gradients w.r.t. the
table exact under the detached-PDF convention.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.ops.brdf import (
    RES_PHI_D, RES_THETA_D, RES_THETA_H, TABLE_SIZE, lookup_brdf)
from vrenderer_pathtracer.ops.brdf_sampling import (
    build_merl_sampler, pdf_cosine, pdf_lobe, sample_brdf_mis, sample_lobe)
from vrenderer_pathtracer.ops.shading import cosine_hemisphere


def glossy_table(width=0.08, amp=3000.0, floor=2.0):
    """Synthetic gold-paint-like MERL table: sharp theta_h lobe + tiny floor."""
    th_centers = (((np.arange(RES_THETA_H) + 0.5) / RES_THETA_H) ** 2
                  * (np.pi / 2))
    prof = amp * np.exp(-((th_centers / width) ** 2)) + floor
    t = np.broadcast_to(
        prof[None, :, None], (3, RES_THETA_H, RES_THETA_D * RES_PHI_D))
    return jnp.asarray(t.reshape(3, TABLE_SIZE).astype(np.float32))


def _fixed_geom(n_lanes):
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n_lanes, 1))
    t = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (n_lanes, 1))
    d = jnp.asarray([0.6, -0.8, 0.0], jnp.float32)
    ray_d = jnp.tile(d[None, :], (n_lanes, 1))
    return ray_d, n, t


def test_lobe_pdf_integrates_to_one():
    """MC integral of pdf_lobe over the sphere ~ 1 (valid density)."""
    table = glossy_table(width=0.25)  # wide enough for uniform-MC accuracy
    sampler = build_merl_sampler(table)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(400_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray_d, n, _ = _fixed_geom(d.shape[0])
    p = pdf_lobe(sampler, ray_d, n, jnp.asarray(d))
    integral = float(jnp.mean(p) * 4.0 * np.pi)
    assert abs(integral - 1.0) < 0.05, integral


def test_lobe_samples_match_pdf_histogram():
    """Sampled theta_h mass per bin matches the sampler's mass table."""
    table = glossy_table()
    sampler = build_merl_sampler(table)
    n_s = 200_000
    ray_d, n, _ = _fixed_geom(n_s)
    rng = np.random.default_rng(1)
    u1, u2, u3 = [jnp.asarray(rng.random(n_s, np.float32)) for _ in range(3)]
    out = sample_lobe(sampler, ray_d, n, u1, u2, u3)
    # recover theta_h of each sample's half vector
    wi = -ray_d
    h = wi + out
    h = h / jnp.linalg.norm(h, axis=-1, keepdims=True)
    # fold to the upper-hemisphere preimage (wi.H < 0 samples flip the sign)
    th = np.arccos(np.abs(np.clip(np.asarray(jnp.sum(n * h, axis=-1)), -1, 1)))
    idx = np.clip((np.sqrt(th * 2 / np.pi) * RES_THETA_H).astype(int),
                  0, RES_THETA_H - 1)
    emp = np.bincount(idx, minlength=RES_THETA_H) / n_s
    mass = np.asarray(sampler.mass)
    # compare where mass is non-trivial
    sel = mass > 1e-3
    np.testing.assert_allclose(emp[sel], mass[sel], rtol=0.08, atol=2e-3)


def test_mis_estimator_unbiased_vs_cosine():
    """Both strategies estimate (24/pi) * int f cos — means must agree."""
    table = glossy_table(width=0.3, amp=300.0, floor=30.0)
    sampler = build_merl_sampler(table)
    n_s = 300_000
    ray_d, n, t = _fixed_geom(n_s)
    rng = np.random.default_rng(2)
    us = [jnp.asarray(rng.random(n_s, np.float32)) for _ in range(5)]
    u_sel, u_phi, u_r, u_b1, u_b2 = us

    cos_dir = cosine_hemisphere(n, u_phi, u_r)
    # reference-style cosine estimator
    f_cos = jnp.maximum(lookup_brdf(table, cos_dir, ray_d, n, t), 0.0)
    est_cos = 24.0 * f_cos
    # MIS estimator
    _, est_mis = sample_brdf_mis(sampler, table, ray_d, n, t, cos_dir,
                                 u_sel, u_b1, u_b2, u_phi)
    m_cos = np.asarray(jnp.mean(est_cos, axis=0))
    m_mis = np.asarray(jnp.mean(est_mis, axis=0))
    np.testing.assert_allclose(m_mis, m_cos, rtol=0.04)


def test_mis_variance_reduction_glossy():
    """>=4x lower per-sample variance on the glossy table (north star)."""
    table = glossy_table()
    sampler = build_merl_sampler(table)
    n_s = 200_000
    ray_d, n, t = _fixed_geom(n_s)
    rng = np.random.default_rng(3)
    us = [jnp.asarray(rng.random(n_s, np.float32)) for _ in range(5)]
    u_sel, u_phi, u_r, u_b1, u_b2 = us

    cos_dir = cosine_hemisphere(n, u_phi, u_r)
    f_cos = jnp.maximum(lookup_brdf(table, cos_dir, ray_d, n, t), 0.0)
    est_cos = 24.0 * f_cos[:, 0]
    _, est_mis = sample_brdf_mis(sampler, table, ray_d, n, t, cos_dir,
                                 u_sel, u_b1, u_b2, u_phi)
    est_mis = est_mis[:, 0]
    v_cos = float(jnp.var(est_cos))
    v_mis = float(jnp.var(est_mis))
    assert v_mis * 4.0 <= v_cos, (v_mis, v_cos)


def _render_once(scene, settings, frame):
    from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
    from vrenderer_pathtracer.render.integrator import render_pass

    cam = Camera.default()
    o, d = generate_rays(cam, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)
    rgb, _ = render_pass(scene, settings, o, d, ids, jnp.uint32(frame),
                         jnp.float32(0.1), jnp.float32(3.0))
    return rgb


def _merl_scene(table):
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    rng = np.random.default_rng(4)
    hdr = jnp.asarray(rng.uniform(0.0, 2.0, (32, 64, 3)).astype(np.float32))
    return Scene(spheres=build_sphere_set(False), hdr=hdr, brdf=table)


def test_image_variance_reduction_equal_spp():
    """Per-pixel variance across independent 1-spp frames drops >=4x on
    BRDF-hit pixels when importance sampling is enabled."""
    table = glossy_table()
    scene = _merl_scene(table)
    base = RenderSettings(width=48, height=32, samples_per_pass=1, bounces=2,
                          use_example_sphere=True, use_brdf=True,
                          has_brdf=True, has_hdr=True)
    frames = range(1, 9)
    imgs_cos = np.stack([np.asarray(_render_once(scene, base, f))
                         for f in frames])
    st_is = base.replace(brdf_importance_sampling=True)
    imgs_is = np.stack([np.asarray(_render_once(scene, st_is, f))
                        for f in frames])
    # means must agree (same integral), variance must drop on lit pixels
    m_cos = imgs_cos.mean(axis=0)
    sel = m_cos.sum(-1) > np.percentile(m_cos.sum(-1), 80)  # sphere pixels
    v_cos = imgs_cos.var(axis=0)[sel].mean()
    v_is = imgs_is.var(axis=0)[sel].mean()
    assert v_is * 4.0 <= v_cos, (v_is, v_cos)
    # Same-integral sanity: with only ~15 effective lobe hits in the cosine
    # stack the cosine mean itself carries ~25% SE, so the bound is loose —
    # the tight unbiasedness check is test_mis_estimator_unbiased_vs_cosine.
    np.testing.assert_allclose(imgs_is.mean(axis=0)[sel].mean(),
                               m_cos[sel].mean(), rtol=0.5)


def test_gradients_exact_directional_derivative():
    """d/ds L(s*table) at s=1 equals <grad L, table> — the detached-PDF
    convention makes L polynomial in the table with detached coefficients,
    so FD along the table direction matches jax.grad to high accuracy."""
    table = glossy_table(width=0.2, amp=100.0, floor=10.0)
    scene = _merl_scene(table)
    st = RenderSettings(width=16, height=16, samples_per_pass=1, bounces=2,
                        use_example_sphere=True, use_brdf=True,
                        has_brdf=True, has_hdr=True,
                        brdf_importance_sampling=True)

    def loss(tab):
        return jnp.mean(_render_once(scene._replace(brdf=tab), st, 1))

    g = jax.grad(loss)(table)
    inner = float(jnp.sum(g * table))
    # L(s) is exactly polynomial in s (directions/pdfs detached and
    # scale-invariant), so the CENTRAL difference is exact at any eps —
    # a large eps sidesteps f32 cancellation in the numerator.
    eps = 0.1
    fd = (float(loss((1 + eps) * table)) - float(loss((1 - eps) * table))) / (2 * eps)
    assert np.isfinite(inner) and inner != 0.0
    np.testing.assert_allclose(inner, fd, rtol=2e-3)
