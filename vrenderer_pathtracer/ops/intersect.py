"""Vectorized ray-primitive intersection ([B] ray batches).

Re-derivations, not translations, of the reference device code:

* sphere quadratic — ``Sphere::intersect`` (``cuda/src/PathTracer.cu:87-104``):
  ``b = dot(op, d)``, ``det = b^2 - |op|^2 + r^2``; nearest positive root with
  epsilon 1e-4, 0 means miss.
* Möller–Trumbore ray/triangle with barycentrics —
  ``intersectTriangle`` (``cuda/include/RayIntersection.cuh:54-111``), epsilon
  3e-10 (``cuda/include/MathHelpers.cuh:17``).
* AABB slab test — ``spanBeginKepler``/``spanEndKepler``
  (``cuda/include/MathHelpers.cuh``), used by the BVH traversal in accel/.

Where the reference branches per-thread, we compute all lanes and mask with
``jnp.where``, which XLA fuses into branch-free elementwise kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

SPHERE_EPS = 1e-4
TRI_EPS = 3e-10
INF = 1e20


def intersect_spheres(ray_o, ray_d, pos, radius):
    """Batched ray-sphere intersection.

    ray_o/ray_d: [B,3]; pos: [N,3]; radius: [N].
    Returns dist [B,N] with INF for misses (reference semantics: nearest root
    greater than 1e-4, else the far root, else miss).
    """
    op = pos[None, :, :] - ray_o[:, None, :]              # [B,N,3]
    b = jnp.sum(op * ray_d[:, None, :], axis=-1)           # [B,N]
    det = b * b - jnp.sum(op * op, axis=-1) + (radius * radius)[None, :]
    ok = det >= 0.0
    sq = jnp.sqrt(jnp.where(ok, det, 0.0))
    t_near = b - sq
    t_far = b + sq
    t = jnp.where(t_near > SPHERE_EPS, t_near, jnp.where(t_far > SPHERE_EPS, t_far, 0.0))
    return jnp.where(ok & (t > 0.0), t, INF)


def intersect_triangles(ray_o, ray_d, v0, v1, v2):
    """Batched Möller–Trumbore: one ray against one triangle per lane.

    All inputs [B,3].  Returns (dist [B], u [B], v [B]); dist=INF on miss.
    Barycentrics: hit point = (1-u-v)*v0 + u*v1 + v*v2.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(ray_d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    parallel = jnp.abs(det) < TRI_EPS
    inv_det = 1.0 / jnp.where(parallel, 1.0, det)
    tvec = ray_o - v0
    u = jnp.sum(tvec * p, axis=-1) * inv_det
    q = jnp.cross(tvec, e1)
    v = jnp.sum(ray_d * q, axis=-1) * inv_det
    dist = jnp.sum(e2 * q, axis=-1) * inv_det
    miss = parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) | (dist <= TRI_EPS)
    return jnp.where(miss, INF, dist), u, v


def slab_test(ray_o, inv_d, box_lo, box_hi, t_min=0.0, t_max=INF):
    """Ray-AABB slab test on precomputed inverse directions.

    ray_o: [B,3] (pre-divided: pass ``od = ray_o * inv_d`` externally when
    batching nodes); here takes raw origin for clarity.
    box_lo/box_hi broadcast against [B,3].
    Returns (t_enter [B], t_exit [B], hit [B]).
    """
    lo = box_lo * inv_d - ray_o * inv_d
    hi = box_hi * inv_d - ray_o * inv_d
    t0 = jnp.minimum(lo, hi)
    t1 = jnp.maximum(lo, hi)
    t_enter = jnp.maximum(jnp.max(t0, axis=-1), t_min)
    t_exit = jnp.minimum(jnp.min(t1, axis=-1), t_max)
    return t_enter, t_exit, t_exit >= t_enter


def safe_inv_dir(ray_d, eps: float = 1e-8):
    """1/d with the reference's epsilon guard (``cuda/src/PathTracer.cu:289-291``)."""
    d = jnp.where(jnp.abs(ray_d) > eps, ray_d, jnp.where(ray_d >= 0, eps, -eps))
    return 1.0 / d
