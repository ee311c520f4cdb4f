"""Mesh packing: host SBVH output -> device-resident SoA arrays.

Re-design of the reference's BVH flattener / GPU packer
(``src/vRendererCuda.cpp:201-318``).  The reference packs Aila/Laine float4
quads with bit-cast child indices and per-leaf triangle triplet streams
terminated by a ``0x80000000`` sentinel; here we keep the same *content*
(duplicated per-leaf triangles, preorder nodes) but in plain SoA arrays with
integer child records — gather-friendly, no bit tricks, static shapes.

Triangles are stored per leaf slot in Möller–Trumbore form (v0, e1, e2)
plus per-corner normals/tangents/uvs for barycentric interpolation
(``cuda/src/PathTracer.cu:385-455``).  Arrays are padded with degenerate
triangles (zero edges -> zero determinant -> never hit) so leaf gathers of
``MAX_LEAF`` slots never read out of bounds.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from vrenderer_pathtracer.native import FlatBVH, HostMesh, build_sbvh
from vrenderer_pathtracer.scene.scene import MeshData

# Leaf capacity: the builder (csrc/sbvh.cc kMaxLeaf) forces splits above this,
# giving the traversal loop a static triangle-test bound.
MAX_LEAF = 8
# Traversal stack depth.  The builder switches to index-balanced median
# splits at depth 48 (kSahDepthLimit), bounding total depth by
# 48 + ceil(log2(T)) < 80 for any T < 2^31 — so 96 slots can never
# overflow.  The builder reports its actual max depth and
# ``_check_stack_bound`` hard-errors if the invariant is ever violated,
# making the traversals' defensive clamp provably dead code.
STACK_DEPTH = 96


def _check_stack_bound(max_depth: int):
    if max_depth + 2 > STACK_DEPTH:
        raise ValueError(
            f"SBVH depth {max_depth} would overflow the traversal stack "
            f"(STACK_DEPTH={STACK_DEPTH}); rebuild with a shallower tree"
        )


def pack_mesh(mesh: HostMesh, pad_to: int = 128) -> MeshData:
    """Build the SBVH and gather triangle data into leaf-slot order.

    Every mesh size gets the same single-level layout, resident in device
    memory as a whole."""
    return pack_from_bvh(mesh, build_sbvh(mesh.verts, mesh.tris), pad_to)


def pack_from_bvh(mesh: HostMesh, bvh: FlatBVH, pad_to: int = 128) -> MeshData:
    _check_stack_bound(bvh.max_depth)
    order = bvh.tri_order  # [R] original tri index per leaf slot
    tri = mesh.tris[order]  # [R,3] vertex ids
    v0 = mesh.verts[tri[:, 0]]
    v1 = mesh.verts[tri[:, 1]]
    v2 = mesh.verts[tri[:, 2]]

    def corners(attr):
        return np.stack([attr[tri[:, 0]], attr[tri[:, 1]], attr[tri[:, 2]]], axis=1)

    r = len(order)
    t_pad = -(-max(r, 1) // pad_to) * pad_to + MAX_LEAF  # slack for leaf gathers

    def pad(a, fill=0.0):
        out = np.full((t_pad,) + a.shape[1:], fill, a.dtype)
        out[:r] = a
        return out

    return MeshData(
        nodes_f=jnp.asarray(bvh.nodes_f),
        nodes_i=jnp.asarray(bvh.nodes_i),
        tri_v0=jnp.asarray(pad(v0)),
        tri_e1=jnp.asarray(pad(v1 - v0)),
        tri_e2=jnp.asarray(pad(v2 - v0)),
        tri_n=jnp.asarray(pad(corners(mesh.normals))),
        tri_t=jnp.asarray(pad(corners(mesh.tangents))),
        tri_uv=jnp.asarray(pad(corners(mesh.uvs))),
        tri_count=jnp.int32(r),
    )
