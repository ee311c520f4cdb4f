"""Ray sorting: restore packet coherence for bounce rays.

A traversal block runs until its slowest ray is done, so its efficiency
tracks the coherence of the rays it holds.  Primary rays are raster-ordered
and already coherent; bounce rays are not — this module re-orders them by a
(direction octant, origin Morton) key before traversal and scatters results
back, as wavefront GPU/CPU tracers sort ray streams (e.g. Ailä/Karras ray
sorting).

The key packs the 3-bit direction octant above a 27-bit Morton code of the
quantized origin: lanes in the same block then start near each other and
march the same way, which is exactly what block-synchronous traversal wants.
"""

from __future__ import annotations

import jax.numpy as jnp


def _spread3(v):
    """Spread 9 bits to every 3rd bit (uint32)."""
    v = v & jnp.uint32(0x1FF)
    v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
    v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
    v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
    v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
    return v


def ray_sort_keys(ray_o, ray_d, lo, hi):
    """[B] uint32 keys: octant (3) | origin Morton (15) | direction Morton (14).

    Origin locality dominates (bounce rays from nearby surface points march
    through the same subtrees); the direction Morton below it splits ties —
    crucially, for *pinhole primaries* every origin is identical, so the key
    degenerates to a direction sort, which tiles the image into compact 2-D
    footprints instead of full raster rows (a 1024-lane row spanning the
    whole silhouette visits the union of the entire tree; a compact tile
    does not — the round-1 mixed hit/miss collapse)."""
    octant = (
        (ray_d[:, 0] >= 0).astype(jnp.uint32)
        | ((ray_d[:, 1] >= 0).astype(jnp.uint32) << jnp.uint32(1))
        | ((ray_d[:, 2] >= 0).astype(jnp.uint32) << jnp.uint32(2))
    )
    span = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((ray_o - lo) / span, 0.0, 1.0)
    q = (q * 511.0).astype(jnp.uint32)
    morton_o = (
        (_spread3(q[:, 0]) << jnp.uint32(2))
        | (_spread3(q[:, 1]) << jnp.uint32(1))
        | _spread3(q[:, 2])
    )  # 27 bits, keep top 15
    qd = jnp.clip((ray_d + 1.0) * 0.5, 0.0, 1.0)
    qd = (qd * 511.0).astype(jnp.uint32)
    morton_d = (
        (_spread3(qd[:, 0]) << jnp.uint32(2))
        | (_spread3(qd[:, 1]) << jnp.uint32(1))
        | _spread3(qd[:, 2])
    )  # 27 bits, keep top 14
    return (
        (octant << jnp.uint32(29))
        | ((morton_o >> jnp.uint32(12)) << jnp.uint32(14))
        | (morton_d >> jnp.uint32(13))
    )


def mesh_bounds(mesh):
    """Scene AABB: the root's two child boxes bound the whole tree."""
    root = mesh.nodes_f[0]
    return (jnp.minimum(root[0:3], root[6:9]),
            jnp.maximum(root[3:6], root[9:12]))


def sorted_traverse(search, mesh, ray_o, ray_d, t_max):
    """Run ``search`` (a traverse-like fn) on coherence-sorted rays.

    Returns (slot, t) in the ORIGINAL ray order.  Terminated lanes
    (``t_max <= 0``, see integrator.intersect_scene's alive hint) sort to
    the END regardless of their stale ray: they then fill whole all-dead
    blocks, instead of wasting lanes inside live blocks.
    """
    lo, hi = mesh_bounds(mesh)
    keys = ray_sort_keys(ray_o, ray_d, lo, hi)
    keys = jnp.where(t_max > 0.0, keys, jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(keys)
    slot_s, t_s = search(mesh, ray_o[perm], ray_d[perm], t_max[perm])
    # Invert with one O(B) scatter, not a second sort.
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(perm.shape[0], dtype=perm.dtype))
    return slot_s[inv], t_s[inv]
