"""Scene container: everything the integrator reads, as one pytree.

The reference scatters scene state across device buffers, texture binds and
constant symbols (``src/vRendererCuda.cpp:154-216``,
``cuda/src/PathTracer.cu:24-48``).  Here the whole scene is a single NamedTuple
pytree handed to the jitted render step; under multi-device sharding every
leaf is *replicated* into each device's memory (the reference's single-GPU
resident set, generalised), while rays/tiles are the sharded axis.

Optional assets are `None` when absent — pytree structure then encodes the
same information as the reference's ``kHas*`` flags, and a change of structure
triggers a recompile exactly like the reference's constant-symbol flips.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.scene.spheres import SphereSet, build_sphere_set


class MeshData(NamedTuple):
    """Flattened SBVH + leaf-ordered triangle streams (see accel/mesh.py).

    Node encoding (``nodes_i[n] = (c0, n0, c1, n1)``): count 0 -> child is
    inner node ``c``; count > 0 -> leaf of ``n`` tri slots starting at ``c``;
    count < 0 -> empty child (its AABB is inverted so slab tests miss).
    Triangle slots are duplicated per leaf (spatial splits), stored in
    Möller–Trumbore (v0, e1, e2) form with per-corner attributes.
    """

    nodes_f: jnp.ndarray   # [M,12] float32 — child AABBs (lo0,hi0,lo1,hi1)
    nodes_i: jnp.ndarray   # [M,4]  int32   — (ref,count) per child
    tri_v0: jnp.ndarray    # [T,3] float32
    tri_e1: jnp.ndarray    # [T,3]
    tri_e2: jnp.ndarray    # [T,3]
    tri_n: jnp.ndarray     # [T,3,3] per-corner normals
    tri_t: jnp.ndarray     # [T,3,3] per-corner tangents
    tri_uv: jnp.ndarray    # [T,3,2] per-corner uvs
    tri_count: jnp.ndarray # [] int32 — valid slots (rest is padding)


class Scene(NamedTuple):
    spheres: SphereSet
    hdr: Optional[jnp.ndarray] = None          # [H,W,3] float32 lat-long env map
    diffuse_map: Optional[jnp.ndarray] = None  # [H,W,3] linearised
    normal_map: Optional[jnp.ndarray] = None   # [H,W,3] raw
    specular_map: Optional[jnp.ndarray] = None # [H,W,3] raw
    brdf: Optional[jnp.ndarray] = None         # [3, 90*90*180] MERL table
    mesh: Optional[MeshData] = None

    @classmethod
    def analytic(cls, settings: RenderSettings, hdr: Optional[jnp.ndarray] = None) -> "Scene":
        """Sphere-only scene matching the settings' cornell flag."""
        return cls(spheres=build_sphere_set(settings.use_cornell_box), hdr=hdr)


def settings_for_scene(scene: Scene, settings: RenderSettings
                       ) -> RenderSettings:
    """Derive the ``has_*`` static flags from which assets are present."""
    return settings.replace(
        has_diffuse_map=scene.diffuse_map is not None,
        has_normal_map=scene.normal_map is not None,
        has_specular_map=scene.specular_map is not None,
        has_brdf=scene.brdf is not None,
        has_mesh=scene.mesh is not None,
        has_hdr=scene.hdr is not None,
    )
