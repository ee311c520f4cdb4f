"""Per-ray stack BVH traversal: one Pallas kernel lowered through Triton.

GPU re-expression of the reference's SBVH traversal kernel
(``cuda/src/PathTracer.cu:269-463``): one ray per lane, each with its own
stack, and a block of ``BLOCK`` rays that loops until all of its rays are
done — so a block's trip count is set by its own slowest ray, not by the
slowest ray of the whole wave as in the lock-step :func:`traverse` (this
kernel's oracle, together with :func:`brute_force`).

It reads the arrays :func:`traverse` reads: the binary SBVH (``nodes_f`` /
``nodes_i``) and the leaf-slot triangles in Möller–Trumbore form.  Each loop
iteration does one unit of work per ray: visit one inner node (slab-test
both children, continue into the nearer hit child, push the farther one),
or test one triangle of the current leaf.  Stack entries encode both kinds:
``e >= 0`` is an inner node, ``e < 0`` a leaf ``(start, count)`` packed as
``-(start * 16 + count) - 1``.

The stack lives in device memory as a ``[STACK_DEPTH, B]`` buffer (an extra
kernel output), column per ray, so that rays of one warp at the same depth
touch adjacent words.  Pallas-Triton has no scratch memory, and a stack held
in registers cannot be indexed per lane.

The result is detached, like :func:`traverse`'s: callers pass
stop-gradient'd rays and recompute hit attributes differentiably
(accel/traverse.py ``shade_mesh_hit``), so the kernel needs no VJP.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vrenderer_pathtracer.accel.mesh import MAX_LEAF, STACK_DEPTH
from vrenderer_pathtracer.scene.scene import MeshData

# Rays per program (one per thread at NUM_WARPS=4).
BLOCK = 128
NUM_WARPS = 4
TRI_EPS = 1e-7  # same epsilon as accel/traverse.py
_LEAF_BITS = 4  # count field of a packed leaf entry (MAX_LEAF <= 15)
assert MAX_LEAF < (1 << _LEAF_BITS)


def _decode(e):
    """Stack entry -> (inner node or -1, leaf start, leaf count)."""
    leaf = e < 0
    code = jnp.where(leaf, -e - 1, 0)
    return (jnp.where(leaf, -1, e), code >> _LEAF_BITS,
            code & ((1 << _LEAF_BITS) - 1))


def _kernel(nodes_f_ref, nodes_i_ref, v0_ref, e1_ref, e2_ref, rays_ref,
            tmax_ref, slot_ref, t_ref, stack_ref, *, max_iters):
    lane = jnp.arange(BLOCK, dtype=jnp.int32)
    o = [rays_ref[k, :] for k in range(3)]
    d = [rays_ref[3 + k, :] for k in range(3)]
    inv_d = [1.0 / jnp.where(jnp.abs(x) > 1e-12, x,
                             jnp.where(x >= 0, 1e-12, -1e-12)) for x in d]
    t_max = tmax_ref[:]

    def load(ref, row, col, mask, other):
        return plgpu.load(ref.at[row, col], mask=mask, other=other)

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def body(c):
        it, node, lstart, lcount, sp, best_t, best_slot = c

        # One Möller–Trumbore test (cuda/include/RayIntersection.cuh:54-111)
        # for lanes inside a leaf.
        in_leaf = lcount > 0
        s = jnp.where(in_leaf, lstart, 0)
        v0 = [load(v0_ref, s, k, in_leaf, 0.0) for k in range(3)]
        e1 = [load(e1_ref, s, k, in_leaf, 0.0) for k in range(3)]
        e2 = [load(e2_ref, s, k, in_leaf, 0.0) for k in range(3)]
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        ok_det = jnp.abs(det) > TRI_EPS
        inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
        tvec = [o[k] - v0[k] for k in range(3)]
        u = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, e1)
        v = dot(d, qvec) * inv_det
        t = dot(e2, qvec) * inv_det
        won = (in_leaf & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > TRI_EPS) & (t < best_t))
        best_t = jnp.where(won, t, best_t)
        best_slot = jnp.where(won, lstart, best_slot)
        step = in_leaf.astype(jnp.int32)
        lstart = lstart + step
        lcount = lcount - step

        # One inner-node visit for lanes not inside a leaf.
        visit = ~in_leaf & (node >= 0)
        n = jnp.where(visit, node, 0)
        nf = [load(nodes_f_ref, n, j, visit, 0.0) for j in range(12)]
        ni = [load(nodes_i_ref, n, j, visit, -1) for j in range(4)]
        hits, nears, entries = [], [], []
        for ch in range(2):
            t_lo = [(nf[6 * ch + k] - o[k]) * inv_d[k] for k in range(3)]
            t_hi = [(nf[6 * ch + 3 + k] - o[k]) * inv_d[k] for k in range(3)]
            t_near = jnp.maximum(jnp.maximum(
                jnp.minimum(t_lo[0], t_hi[0]), jnp.minimum(t_lo[1], t_hi[1])),
                jnp.minimum(t_lo[2], t_hi[2]))
            t_far = jnp.minimum(jnp.minimum(
                jnp.maximum(t_lo[0], t_hi[0]), jnp.maximum(t_lo[1], t_hi[1])),
                jnp.maximum(t_lo[2], t_hi[2]))
            ref, cnt = ni[2 * ch], ni[2 * ch + 1]
            hits.append(visit & (cnt >= 0) & (
                jnp.maximum(t_near, 0.0) <= jnp.minimum(t_far, best_t)))
            nears.append(t_near)
            entries.append(jnp.where(cnt > 0, -(ref * (1 << _LEAF_BITS) + cnt)
                                     - 1, ref))
        both = hits[0] & hits[1]
        near0 = nears[0] <= nears[1]
        first = jnp.where(both, jnp.where(near0, entries[0], entries[1]),
                          jnp.where(hits[0], entries[0], entries[1]))
        far = jnp.where(near0, entries[1], entries[0])
        plgpu.store(stack_ref.at[jnp.minimum(sp, STACK_DEPTH - 1), lane], far,
                    mask=both)
        sp = jnp.minimum(sp + both.astype(jnp.int32), STACK_DEPTH - 1)
        go = visit & (hits[0] | hits[1])
        f_node, f_start, f_count = _decode(first)
        node = jnp.where(visit, jnp.where(go, f_node, -1), node)
        lstart = jnp.where(go, f_start, lstart)
        lcount = jnp.where(go, f_count, lcount)

        # Lanes left without work pop their next entry.
        pop = (lcount == 0) & (node < 0) & (sp > 0)
        sp = sp - pop.astype(jnp.int32)
        e = plgpu.load(stack_ref.at[sp, lane], mask=pop, other=0)
        p_node, p_start, p_count = _decode(e)
        node = jnp.where(pop, p_node, node)
        lstart = jnp.where(pop, p_start, lstart)
        lcount = jnp.where(pop, p_count, lcount)
        return it + 1, node, lstart, lcount, sp, best_t, best_slot

    def cond(c):
        it, node, _, lcount, _, _, _ = c
        busy = ((node >= 0) | (lcount > 0)).astype(jnp.int32)
        return (jnp.max(busy) > 0) & (it < max_iters)

    zeros = jnp.zeros((BLOCK,), jnp.int32)
    init = (jnp.int32(0), jnp.where(t_max > 0.0, 0, -1), zeros, zeros, zeros,
            t_max, jnp.full((BLOCK,), -1, jnp.int32))
    out = lax.while_loop(cond, body, init)
    slot_ref[:] = out[6]
    t_ref[:] = out[5]


@functools.partial(jax.jit, static_argnames=("interpret",))
def traverse_triton(mesh: MeshData, ray_o, ray_d, t_max, *,
                    interpret: bool = False):
    """Nearest triangle hit per ray: ``(slot [B] int32, t [B])``, slot -1
    on a miss and ``t = t_max`` there — the contract of :func:`traverse`.

    Lanes with ``t_max <= 0`` (or NaN) are not traversed.  ``interpret``
    runs the kernel in the Pallas interpreter (CPU tests only).
    """
    b = ray_o.shape[0]
    bp = -(-max(b, 1) // BLOCK) * BLOCK
    rays = jnp.concatenate([ray_o.T, ray_d.T]).astype(jnp.float32)  # [6,B]
    rays = jnp.pad(rays, ((0, 0), (0, bp - b)))
    t_max = jnp.pad(jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (b,)),
                    (0, bp - b))
    n_nodes = mesh.nodes_i.shape[0]
    n_slots = mesh.tri_v0.shape[0]
    full = pl.BlockSpec()
    lanes = pl.BlockSpec((BLOCK,), lambda i: (i,))
    slot, t, _ = pl.pallas_call(
        functools.partial(_kernel, max_iters=2 * (n_nodes + n_slots) + 8),
        grid=(bp // BLOCK,),
        in_specs=[full, full, full, full, full,
                  pl.BlockSpec((6, BLOCK), lambda i: (0, i)), lanes],
        out_specs=[lanes, lanes,
                   pl.BlockSpec((STACK_DEPTH, BLOCK), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((bp,), jnp.int32),
                   jax.ShapeDtypeStruct((bp,), jnp.float32),
                   jax.ShapeDtypeStruct((STACK_DEPTH, bp), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(mesh.nodes_f, mesh.nodes_i, mesh.tri_v0, mesh.tri_e1, mesh.tri_e2,
      rays, t_max)
    return slot[:b], t[:b]
