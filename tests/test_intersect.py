"""Ray-primitive intersection unit tests (analytic cases + reference parity)."""

import numpy as np
import jax.numpy as jnp

from vrenderer_pathtracer.ops.intersect import (
    INF,
    intersect_spheres,
    intersect_triangles,
    safe_inv_dir,
    slab_test,
)


def test_sphere_head_on():
    ro = jnp.array([[0.0, 0.0, 10.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    d = intersect_spheres(ro, rd, jnp.zeros((1, 3)), jnp.array([2.0]))
    np.testing.assert_allclose(np.asarray(d), [[8.0]], atol=1e-5)


def test_sphere_from_inside_returns_far_root():
    ro = jnp.array([[0.0, 0.0, 0.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    d = intersect_spheres(ro, rd, jnp.zeros((1, 3)), jnp.array([2.0]))
    np.testing.assert_allclose(np.asarray(d), [[2.0]], atol=1e-5)


def test_sphere_miss():
    ro = jnp.array([[0.0, 5.0, 10.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    d = intersect_spheres(ro, rd, jnp.zeros((1, 3)), jnp.array([2.0]))
    assert float(d[0, 0]) == np.float32(INF)


def test_sphere_behind_is_miss():
    ro = jnp.array([[0.0, 0.0, 10.0]])
    rd = jnp.array([[0.0, 0.0, 1.0]])  # pointing away
    d = intersect_spheres(ro, rd, jnp.zeros((1, 3)), jnp.array([2.0]))
    assert float(d[0, 0]) == np.float32(INF)


def test_triangle_hit_and_barycentrics():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[1.0, 0.0, 0.0]])
    v2 = jnp.array([[0.0, 1.0, 0.0]])
    ro = jnp.array([[0.25, 0.25, 1.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    t, u, v = intersect_triangles(ro, rd, v0, v1, v2)
    np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(u[0]), 0.25, atol=1e-6)
    np.testing.assert_allclose(float(v[0]), 0.25, atol=1e-6)
    # hit point reconstruction from barycentrics
    p = (1 - u - v)[:, None] * v0 + u[:, None] * v1 + v[:, None] * v2
    np.testing.assert_allclose(np.asarray(p[0]), [0.25, 0.25, 0.0], atol=1e-6)


def test_triangle_edge_cases():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[1.0, 0.0, 0.0]])
    v2 = jnp.array([[0.0, 1.0, 0.0]])
    # outside the triangle
    ro = jnp.array([[0.9, 0.9, 1.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    t, _, _ = intersect_triangles(ro, rd, v0, v1, v2)
    assert float(t[0]) == np.float32(INF)
    # parallel ray
    ro = jnp.array([[0.25, 0.25, 1.0]])
    rd = jnp.array([[1.0, 0.0, 0.0]])
    t, _, _ = intersect_triangles(ro, rd, v0, v1, v2)
    assert float(t[0]) == np.float32(INF)
    # behind the origin
    ro = jnp.array([[0.25, 0.25, -1.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    t, _, _ = intersect_triangles(ro, rd, v0, v1, v2)
    assert float(t[0]) == np.float32(INF)


def test_slab_test():
    ro = jnp.array([[0.0, 0.0, 5.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    inv = safe_inv_dir(rd)
    lo = jnp.array([-1.0, -1.0, -1.0])
    hi = jnp.array([1.0, 1.0, 1.0])
    t0, t1, hit = slab_test(ro, inv, lo, hi)
    assert bool(hit[0])
    np.testing.assert_allclose(float(t0[0]), 4.0, atol=1e-6)
    np.testing.assert_allclose(float(t1[0]), 6.0, atol=1e-6)
    # miss
    ro2 = jnp.array([[3.0, 0.0, 5.0]])
    _, _, hit2 = slab_test(ro2, inv, lo, hi)
    assert not bool(hit2[0])
