"""Every mesh size packs into the one single-level layout.

Meshes of these sizes used to be split into pages for a small on-die
memory; now each is one SBVH resident in device memory, traversed by the
same code as the smallest mesh.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.test_mesh_render import write_uv_sphere
from tests.test_mesh_traversal import _aimed_rays
from vrenderer_pathtracer import native
from vrenderer_pathtracer.accel.mesh import MAX_LEAF, STACK_DEPTH, pack_mesh
from vrenderer_pathtracer.accel.traverse import brute_force, traverse
from vrenderer_pathtracer.scene.scene import MeshData


@pytest.mark.parametrize("n_theta", [200, 300, 500])  # 80k, 180k, 499k tris
def test_large_mesh_packs_single_level(n_theta, tmp_path):
    p = tmp_path / "s.obj"
    write_uv_sphere(str(p), radius=12.0, n_theta=n_theta, n_phi=n_theta)
    host = native.load_obj(str(p))
    mesh = pack_mesh(host)
    assert isinstance(mesh, MeshData)
    assert set(MeshData._fields) == {
        "nodes_f", "nodes_i", "tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_t",
        "tri_uv", "tri_count"}
    r = int(mesh.tri_count)
    assert r >= len(host.tris)
    assert mesh.tri_v0.shape[0] >= r + MAX_LEAF
    assert mesh.nodes_f.shape == (mesh.nodes_i.shape[0], 12)
    # Every leaf range lies inside the valid slots.
    ni = np.asarray(mesh.nodes_i)
    for c in (0, 2):
        leaf = ni[:, c + 1] > 0
        assert (ni[leaf, c] + ni[leaf, c + 1] <= r).all()
        assert (ni[leaf, c + 1] <= MAX_LEAF).all()
    assert native.build_sbvh(host.verts, host.tris).max_depth + 2 <= STACK_DEPTH

    o, d = _aimed_rays(host, 32, seed=n_theta, extent=40.0)
    t_max = jnp.full((32,), 1e6, jnp.float32)
    slot_a, t_a = traverse(mesh, o, d, t_max)
    slot_b, t_b = brute_force(mesh, o, d, t_max)
    hit = np.asarray(slot_a) >= 0
    assert hit.sum() >= 16
    np.testing.assert_array_equal(hit, np.asarray(slot_b) >= 0)
    np.testing.assert_allclose(np.asarray(t_a)[hit], np.asarray(t_b)[hit],
                               rtol=1e-5)
