"""Camera basis + ray generation vs the reference's conventions."""

import numpy as np
import jax.numpy as jnp

from vrenderer_pathtracer.core.camera import Camera, generate_rays
from tests import reference_tracer as ref


def test_default_basis():
    origin, view_dir, up, right, fov_scale = Camera.default().basis()
    np.testing.assert_allclose(np.asarray(origin), [0, 0, 150])
    np.testing.assert_allclose(np.asarray(view_dir), [0, 0, -1], atol=1e-7)
    np.testing.assert_allclose(np.asarray(up), [0, 1, 0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(right), [1, 0, 0], atol=1e-7)
    assert abs(float(fov_scale) - np.tan(75 * np.pi / 360)) < 1e-6


def test_yawed_basis_matches_reference_formula():
    cam = Camera.default()._replace(yaw=jnp.float32(0.7), pitch=jnp.float32(-0.3))
    o, d, u, r, fs = cam.basis()
    eo, ed, eu, er, efs = ref.camera_basis((0, 0, 150), 0.7, -0.3, 75.0)
    np.testing.assert_allclose(np.asarray(d), ed, atol=1e-6)
    np.testing.assert_allclose(np.asarray(u), eu, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), er, atol=1e-6)


def test_ray_directions_match_reference():
    w, h = 8, 6
    cam = Camera.default()
    ro, rd = generate_rays(cam, w, h)
    origin, view_dir, up, right, fov_scale = ref.camera_basis((0, 0, 150), 0.0, 0.0, 75.0)
    cx = fov_scale * np.float32(w / h) * right
    cy = fov_scale * up
    for y in range(h):
        for x in range(w):
            u = np.float32((0.25 + x) / w - 0.5)
            v = np.float32((0.25 + y) / h - 0.5)
            d = ref.norm(view_dir + cx * u + cy * v)
            np.testing.assert_allclose(np.asarray(rd[x + y * w]), d, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ro), np.tile(origin, (w * h, 1)))


def test_rays_unit_length():
    _, rd = generate_rays(Camera.default(), 32, 32)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(rd), axis=1), 1.0, atol=1e-6)


def test_pitch_clamped():
    cam = Camera.default()._replace(pitch=jnp.float32(2.5)).with_pitch_clamped()
    assert abs(float(cam.pitch) - np.pi / 2) < 1e-6
