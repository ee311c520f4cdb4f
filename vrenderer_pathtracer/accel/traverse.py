"""BVH traversal + mesh hit shading: the framework's hot loop.

Re-design of the reference's SBVH megakernel traversal
(``cuda/src/PathTracer.cu:269-463``).  The reference uses per-thread
traversal stacks with warp votes and a postponed-leaf trick; the XLA version
runs all ray lanes in lockstep through a ``lax.while_loop``: each iteration
pops one node per lane, slab-tests both children, pushes inner children in
near-to-far order, and resolves leaf children inline with a static
``MAX_LEAF``-wide vectorized Möller–Trumbore test (masked lanes idle).
On a GPU the per-ray stack kernel (accel/triton_traverse.py) replaces this
loop; this implementation is its numerics oracle and the CPU path.

Differentiability (detached-hit convention, SURVEY §7): the while-loop
traversal only produces the *discrete* winning triangle slot per lane
(non-differentiable by construction); the hit attributes (t, barycentrics,
point, interpolated normal/tangent/uv) are then **recomputed outside the
loop** with pure differentiable ops from the gathered triangle — gradients
flow to vertex data and ray parameters without differentiating the search.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from vrenderer_pathtracer.accel.mesh import MAX_LEAF, STACK_DEPTH
from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.ops import texture as tex_ops
from vrenderer_pathtracer.scene.scene import MeshData, Scene
from vrenderer_pathtracer.scene.spheres import BRDF, DIFF

# Triangle-test epsilon (reference: 3e-10 CUDA / 3e-4 CL — the divergence
# between its own backends bounds the meaningful precision; we sit between).
TRI_EPS = 1e-7


class _TraversalState(NamedTuple):
    sp: jnp.ndarray        # [B] int32 stack pointer
    stack: jnp.ndarray     # [B, STACK_DEPTH] int32 pending node ids
    best_t: jnp.ndarray    # [B] closest hit distance so far
    best_slot: jnp.ndarray # [B] winning tri slot, -1 = none
    iters: jnp.ndarray     # [] safety counter


def _moller_trumbore(ray_o, ray_d, v0, e1, e2):
    """Batched Möller–Trumbore over gathered triangles.

    ray_o/ray_d: [B,3]; v0/e1/e2: [B,K,3].  Returns (t, u, v, ok) each [B,K].
    Semantics follow ``cuda/include/RayIntersection.cuh:54-111`` (barycentric
    u along e1, v along e2; double-sided).
    """
    d = ray_d[:, None, :]
    o = ray_o[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = (
        (jnp.abs(det) > TRI_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > TRI_EPS)
    )
    return t, u, v, ok


def _slab_test(ray_o, inv_d, lo, hi, t_max):
    """Robust slab test. lo/hi: [B,3]. Returns (hit [B], t_near [B])."""
    t0 = (lo - ray_o) * inv_d
    t1 = (hi - ray_o) * inv_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t_near_c = jnp.maximum(t_near, 0.0)
    t_far_c = jnp.minimum(t_far, t_max)
    return t_near_c <= t_far_c, t_near


def _leaf_intersect(mesh: MeshData, ray_o, ray_d, start, count, active, best_t,
                    best_slot):
    """Test up to MAX_LEAF triangles of one leaf child per lane."""
    k = jnp.arange(MAX_LEAF, dtype=jnp.int32)
    slots = start[:, None] + k[None, :]                    # [B,K]
    valid = active[:, None] & (k[None, :] < count[:, None])
    slots_safe = jnp.where(valid, slots, 0)
    v0 = mesh.tri_v0[slots_safe]
    e1 = mesh.tri_e1[slots_safe]
    e2 = mesh.tri_e2[slots_safe]
    t, _, _, ok = _moller_trumbore(ray_o, ray_d, v0, e1, e2)
    ok = ok & valid & (t < best_t[:, None])
    t = jnp.where(ok, t, jnp.inf)
    j = jnp.argmin(t, axis=-1)
    t_min = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
    slot_min = jnp.take_along_axis(slots_safe, j[:, None], axis=-1)[:, 0]
    won = jnp.isfinite(t_min)
    return jnp.where(won, t_min, best_t), jnp.where(won, slot_min, best_slot)


def traverse(mesh: MeshData, ray_o, ray_d, t_max):
    """Find the nearest triangle hit per ray lane.

    Returns ``(slot [B] int32, t [B])`` with slot == -1 on miss.  The result
    is detached (wrapped in stop_gradient by the caller's recompute).
    """
    b = ray_o.shape[0]
    lanes = jnp.arange(b)
    inv_d = 1.0 / jnp.where(jnp.abs(ray_d) > 1e-12,
                            ray_d, jnp.where(ray_d >= 0, 1e-12, -1e-12))
    max_iters = jnp.int32(4 * mesh.nodes_i.shape[0] + STACK_DEPTH)

    init = _TraversalState(
        sp=jnp.ones((b,), jnp.int32),
        stack=jnp.zeros((b, STACK_DEPTH), jnp.int32),  # stack[0] = root = 0
        best_t=jnp.asarray(t_max, jnp.float32) * jnp.ones((b,), jnp.float32),
        best_slot=jnp.full((b,), -1, jnp.int32),
        iters=jnp.int32(0),
    )

    def cond(s: _TraversalState):
        return jnp.any(s.sp > 0) & (s.iters < max_iters)

    def body(s: _TraversalState):
        active = s.sp > 0
        sp1 = jnp.maximum(s.sp - 1, 0)
        node = jnp.where(active, s.stack[lanes, sp1], 0)
        sp = jnp.where(active, sp1, s.sp)

        nf = mesh.nodes_f[node]   # [B,12]
        ni = mesh.nodes_i[node]   # [B,4]

        best_t, best_slot = s.best_t, s.best_slot
        hits, nears = [], []
        for c in range(2):
            lo = nf[:, 6 * c: 6 * c + 3]
            hi = nf[:, 6 * c + 3: 6 * c + 6]
            hit, t_near = _slab_test(ray_o, inv_d, lo, hi, best_t)
            hit = hit & active & (ni[:, 2 * c + 1] >= 0)
            hits.append(hit)
            nears.append(t_near)
            # Leaf child: resolve inline.
            is_leaf = hit & (ni[:, 2 * c + 1] > 0)
            best_t, best_slot = _leaf_intersect(
                mesh, ray_o, ray_d, ni[:, 2 * c], ni[:, 2 * c + 1],
                is_leaf, best_t, best_slot,
            )

        # Inner children: push in far-then-near order so near pops first.
        push0 = hits[0] & (ni[:, 1] == 0)
        push1 = hits[1] & (ni[:, 3] == 0)
        both = push0 & push1
        near0 = nears[0] <= nears[1]
        c0, c1 = ni[:, 0], ni[:, 2]
        first = jnp.where(both, jnp.where(near0, c1, c0),  # far child first
                          jnp.where(push0, c0, c1))
        second = jnp.where(near0, c0, c1)                  # near child on top
        any_push = push0 | push1

        idx_a = jnp.minimum(sp, STACK_DEPTH - 1)
        idx_b = jnp.minimum(sp + both.astype(jnp.int32), STACK_DEPTH - 1)
        stack = s.stack.at[lanes, idx_a].set(
            jnp.where(any_push, first, s.stack[lanes, idx_a]))
        stack = stack.at[lanes, idx_b].set(
            jnp.where(any_push, jnp.where(both, second, first),
                      stack[lanes, idx_b]))
        sp = jnp.minimum(sp + push0 + push1, STACK_DEPTH - 1)

        return _TraversalState(sp, stack, best_t, best_slot, s.iters + 1)

    out = lax.while_loop(cond, body, init)
    return out.best_slot, out.best_t


def brute_force(mesh: MeshData, ray_o, ray_d, t_max):
    """All-triangles oracle for traversal tests: O(B*T), CPU-sized only.

    Padding slots (the contiguous tail of pack_mesh) hold degenerate
    triangles with zero edges, so they can never pass the determinant
    test — no validity mask needed.
    """
    t, _, _, ok = _moller_trumbore(
        ray_o, ray_d,
        jnp.broadcast_to(mesh.tri_v0[None], (ray_o.shape[0],) + mesh.tri_v0.shape),
        jnp.broadcast_to(mesh.tri_e1[None], (ray_o.shape[0],) + mesh.tri_e1.shape),
        jnp.broadcast_to(mesh.tri_e2[None], (ray_o.shape[0],) + mesh.tri_e2.shape),
    )
    ok = ok & (t < jnp.asarray(t_max)[..., None])
    t = jnp.where(ok, t, jnp.inf)
    j = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_min = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
    hit = jnp.isfinite(t_min)
    return jnp.where(hit, j, -1), jnp.where(hit, t_min, jnp.asarray(t_max))


def shade_mesh_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d, slot,
                   prev):
    """Differentiable hit-attribute recompute + reference shading semantics.

    Reference leaf shading (``cuda/src/PathTracer.cu:385-455``): barycentric
    uv/tangent interpolation; diffuse/specular maps gated by ``!kViewBRDF``;
    smooth interpolated normal ONLY on the normal-map path, otherwise the
    flat geometric face normal; emission 0; hit type BRDF or DIFF.
    """
    from vrenderer_pathtracer.render.integrator import HitData

    mesh = scene.mesh
    safe = jnp.maximum(slot, 0)
    # ONE wide-row gather for every per-slot attribute instead of six
    # narrow ones; the concatenation is loop-invariant, so XLA builds the
    # [R,64] table once per call, not per bounce.
    r_tris = mesh.tri_v0.shape[0]
    attr = jnp.concatenate([
        mesh.tri_v0, mesh.tri_e1, mesh.tri_e2,
        mesh.tri_uv.reshape(r_tris, 6),
        mesh.tri_t.reshape(r_tris, 9),
        mesh.tri_n.reshape(r_tris, 9),
    ], axis=1)
    attr = jnp.pad(attr, ((0, 0), (0, 64 - attr.shape[1])))
    # Keep the gather 64 lanes wide: barriers on BOTH sides, or XLA
    # re-narrows it to [B,33].  Input side: XLA commutes constant padding
    # out of the gather (gather(pad(x)) -> pad(gather(x))); output side:
    # consumer slices push through and dead-code the columns.
    attr = jax.lax.optimization_barrier(attr)
    rows = jax.lax.optimization_barrier(attr[safe])
    # Hot math runs on FLAT [B] components; [B,3] results are assembled
    # only at the end.
    oc = [ray_o[:, k] for k in range(3)]
    dc = [ray_d[:, k] for k in range(3)]
    v0c = [rows[:, k] for k in range(3)]
    e1c = [rows[:, 3 + k] for k in range(3)]
    e2c = [rows[:, 6 + k] for k in range(3)]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    # Recompute (t, u, v) differentiably for the winning triangle
    # (Möller–Trumbore, cuda/include/RayIntersection.cuh:54-111 semantics).
    pvec = cross(dc, e2c)
    det = dot(e1c, pvec)
    inv_det = jnp.where(jnp.abs(det) > TRI_EPS, 1.0 / det, 0.0)
    tvec = [oc[k] - v0c[k] for k in range(3)]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1c)
    v = dot(dc, qvec) * inv_det
    t = dot(e2c, qvec) * inv_det
    w = 1.0 - u - v
    point = ray_o + ray_d * t[:, None]

    def bary_mix(base):
        """w*c0 + u*c1 + v*c2 over column-triple-packed corners."""
        return [w * rows[:, base + k] + u * rows[:, base + 3 + k]
                + v * rows[:, base + 6 + k] for k in range(3)]

    def norm3(a, eps=1e-20):
        inv = 1.0 / jnp.maximum(jnp.sqrt(dot(a, a)), eps)
        return [a[k] * inv for k in range(3)]

    # uv corners are packed per corner (u0,v0,u1,v1,u2,v2) at cols 9:15.
    uv = jnp.stack([
        w * rows[:, 9] + u * rows[:, 11] + v * rows[:, 13],
        w * rows[:, 10] + u * rows[:, 12] + v * rows[:, 14],
    ], axis=-1)
    tangent_c = norm3(bary_mix(15))
    tangent = jnp.stack(tangent_c, axis=-1)

    use_tex = not settings.use_brdf
    # One combined gather for every map sampled at this uv.
    texd, texn, texs = tex_ops.fetch_maps(
        [scene.diffuse_map if settings.has_diffuse_map and use_tex else None,
         scene.normal_map if settings.has_normal_map else None,
         scene.specular_map if settings.has_specular_map and use_tex
         else None],
        uv[:, 0], uv[:, 1], settings.texture_filter)
    color = texd if texd is not None else jnp.ones_like(point)

    ne1 = [-rows[:, 3 + k] for k in range(3)]
    ne2 = [-rows[:, 6 + k] for k in range(3)]
    # cross(v0-v1, v0-v2), reference orientation
    face_n = jnp.stack(norm3(cross(ne1, ne2)), axis=-1)
    if settings.has_normal_map:
        smooth_n = jnp.stack(norm3(bary_mix(24)), axis=-1)
        n_ts = tex_ops.decode_normal_map(texn)
        normal = tex_ops.apply_tbn(smooth_n, tangent, n_ts)
    else:
        normal = face_n

    spec = texs if texs is not None else jnp.zeros_like(point)

    hit_type = jnp.full(t.shape, BRDF if settings.use_brdf else DIFF, jnp.int32)
    closer = slot >= 0

    def sel3(a, b):
        return jnp.where(closer[:, None], a, b)

    return HitData(
        hit=prev.hit | closer,
        t=jnp.where(closer, t, prev.t),
        point=sel3(point, prev.point),
        normal=sel3(normal, prev.normal),
        tangent=sel3(tangent, prev.tangent),
        color=sel3(color, prev.color),
        spec_color=sel3(spec, prev.spec_color),
        emission=sel3(jnp.zeros_like(point), prev.emission),
        hit_type=jnp.where(closer, hit_type, prev.hit_type),
    )


def _kernel_search(mesh: MeshData, ray_o, ray_d, t_max):
    from vrenderer_pathtracer.accel import triton_traverse

    return triton_traverse.traverse_triton(mesh, ray_o, ray_d, t_max)


def nearest_hit(mesh: MeshData, ray_o, ray_d, t_max):
    """``(slot [B] int32, t [B])`` for the platform the program is compiled
    for — the one place the program picks code by platform: the Triton
    kernel (accel/triton_traverse.py) on a GPU, :func:`traverse` elsewhere.
    The choice is made when the program is lowered, so it holds under a
    caller's own ``jit``, ``grad`` and ``shard_map`` alike."""
    return lax.platform_dependent(mesh, ray_o, ray_d, t_max,
                                  cuda=_kernel_search, default=traverse)


def mesh_search(scene: Scene, settings: RenderSettings, ray_o, ray_d, t_max):
    """Detached nearest-triangle search, ``(slot [B] int32, t [B])``: the
    one traversal entry point of the integrator.  Rays are stop-gradient'd
    (the winning slot is discrete); :func:`shade_mesh_hit` recomputes the
    hit attributes differentiably."""
    search = nearest_hit
    if settings.sort_rays:
        from vrenderer_pathtracer.accel.sorting import sorted_traverse

        search = functools.partial(sorted_traverse, search)
    slot, t = search(
        scene.mesh,
        lax.stop_gradient(ray_o),
        lax.stop_gradient(ray_d),
        lax.stop_gradient(t_max),
    )
    return lax.stop_gradient(slot), lax.stop_gradient(t)


def mesh_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d, prev):
    """Mesh intersection vs the running closest hit (integrator hook)."""
    slot, _ = mesh_search(scene, settings, ray_o, ray_d, prev.t)
    return shade_mesh_hit(scene, settings, ray_o, ray_d, slot, prev)
