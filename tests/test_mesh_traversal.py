"""SBVH + traversal tests: invariants, brute-force oracle, loaders, grads.

SURVEY §4 test pyramid items: SBVH invariants (every triangle reachable,
child AABBs valid), traversal vs an all-triangles oracle (our analog of the
reference's dual-backend cross-check), OBJ loader behavior parity
(centroid recentering, v-flip), and detached-hit differentiability.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrenderer_pathtracer import native
from vrenderer_pathtracer.accel.mesh import MAX_LEAF, pack_mesh
from vrenderer_pathtracer.accel.traverse import brute_force, mesh_hit, traverse
from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.native import HostMesh
from vrenderer_pathtracer.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer.scene.spheres import build_sphere_set


def _soup(n_tris=120, seed=0, extent=30.0):
    """Random triangle soup as a HostMesh."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-extent, extent, (n_tris, 1, 3))
    jitter = rng.uniform(-4, 4, (n_tris, 3, 3))
    verts = (base + jitter).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n, 3, axis=0).astype(np.float32)
    tangents = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-12)
    tangents = np.repeat(tangents, 3, axis=0).astype(np.float32)
    uvs = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    return HostMesh(verts, normals, tangents, uvs, tris)


def _rays(n=256, seed=1, extent=60.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _aimed_rays(host, n=256, seed=1, extent=60.0):
    """Rays aimed at random triangle centroids — guaranteed hit-rich."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    which = rng.integers(0, len(host.tris), n)
    centroids = host.verts[host.tris[which]].mean(axis=1)
    d = centroids - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def _walk_invariants(bvh, n_tris):
    seen = set()

    def walk(node, depth=0):
        assert depth < 64
        f, q = bvh.nodes_f[node], bvh.nodes_i[node]
        for k in range(2):
            ref, cnt = int(q[2 * k]), int(q[2 * k + 1])
            lo, hi = f[6 * k: 6 * k + 3], f[6 * k + 3: 6 * k + 6]
            if cnt < 0:
                assert (lo > hi).all(), "empty child must carry an inverted box"
                continue
            assert (lo <= hi).all()
            if cnt == 0:
                walk(ref, depth + 1)
            else:
                assert cnt <= MAX_LEAF
                for s in range(ref, ref + cnt):
                    seen.add(int(bvh.tri_order[s]))

    walk(0)
    assert seen == set(range(n_tris)), "unreachable triangles"


@pytest.mark.parametrize("n_tris", [1, 5, 120, 600])
def test_sbvh_invariants(n_tris):
    mesh = _soup(n_tris, seed=n_tris)
    bvh = native.build_sbvh(mesh.verts, mesh.tris)
    _walk_invariants(bvh, n_tris)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traversal_matches_brute_force(seed):
    host = _soup(200, seed=seed)
    mesh = pack_mesh(host)
    o1, d1 = _rays(256, seed=seed + 10)
    o2, d2 = _aimed_rays(host, 256, seed=seed + 20)
    ray_o = jnp.concatenate([o1, o2])
    ray_d = jnp.concatenate([d1, d2])
    t_max = jnp.full((512,), 1e6, jnp.float32)

    slot_a, t_a = traverse(mesh, ray_o, ray_d, t_max)
    slot_b, t_b = brute_force(mesh, ray_o, ray_d, t_max)

    hit_a, hit_b = np.asarray(slot_a >= 0), np.asarray(slot_b >= 0)
    assert hit_a.sum() > 100  # the aimed half must actually hit
    np.testing.assert_array_equal(hit_a, hit_b)
    np.testing.assert_allclose(
        np.asarray(t_a)[hit_a], np.asarray(t_b)[hit_b], rtol=1e-5, atol=1e-5
    )


def test_rays_from_inside_and_axis_aligned():
    """Degenerate directions (zero components) and origins inside the tree."""
    host = _soup(64, seed=7, extent=10.0)
    mesh = pack_mesh(host)
    o = jnp.zeros((6, 3), jnp.float32)
    d = jnp.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.float32,
    )
    t_max = jnp.full((6,), 1e6, jnp.float32)
    slot_a, t_a = traverse(mesh, o, d, t_max)
    slot_b, t_b = brute_force(mesh, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(slot_a >= 0), np.asarray(slot_b >= 0))
    m = np.asarray(slot_a >= 0)
    np.testing.assert_allclose(np.asarray(t_a)[m], np.asarray(t_b)[m], rtol=1e-5)


def test_obj_loader_roundtrip(tmp_path):
    """Write a cube OBJ, load it: counts, centroid recentering, v-flip."""
    p = tmp_path / "cube.obj"
    verts = [
        (10, 0, 0), (12, 0, 0), (12, 2, 0), (10, 2, 0),
        (10, 0, 2), (12, 0, 2), (12, 2, 2), (10, 2, 2),
    ]
    faces = [  # quads, 1-based
        (1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2),
        (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8),
    ]
    with open(p, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.write("vt 0.25 0.75\n")
        for q in faces:
            f.write("f " + " ".join(f"{i}/1" for i in q) + "\n")
    m = native.load_obj(str(p))
    assert m.tris.shape == (12, 3)  # quads fan-triangulated
    # Recentered at the centroid (reference MeshLoader.cpp:50-60).
    np.testing.assert_allclose(m.verts.mean(axis=0), 0.0, atol=1e-5)
    assert m.verts.min() == -1.0 and m.verts.max() == 1.0
    # v-flip: vt 0.75 -> 0.25 (reference MeshLoader.cpp:74).
    np.testing.assert_allclose(m.uvs[:, 1], 0.25, atol=1e-6)
    # Generated smooth normals are unit length.
    np.testing.assert_allclose(np.linalg.norm(m.normals, axis=-1), 1.0, atol=1e-4)
    # Rendered BVH over it behaves: ray straight at the cube hits at z=1.
    mesh = pack_mesh(m)
    o = jnp.asarray([[0.0, 0.0, 10.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    slot, t = traverse(mesh, o, d, jnp.asarray([1e6], jnp.float32))
    assert int(slot[0]) >= 0
    np.testing.assert_allclose(float(t[0]), 9.0, rtol=1e-5)


def test_merl_loader(tmp_path):
    p = tmp_path / "fake.binary"
    n = 90 * 90 * 180
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 2, 3 * n)
    with open(p, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        data.tofile(f)
    table = native.load_merl(str(p))
    assert table.shape == (3, n)
    np.testing.assert_allclose(table, data.reshape(3, n).astype(np.float32))


def test_mesh_hit_differentiable():
    """Gradients flow through the detached-hit recompute to the ray."""
    host = _soup(50, seed=3, extent=15.0)
    mesh_data = pack_mesh(host)
    scene = Scene(spheres=build_sphere_set(False), mesh=mesh_data)
    settings = settings_for_scene(
        scene, RenderSettings(width=4, height=4, has_hdr=False)
    )

    ray_o, ray_d = _aimed_rays(host, 64, seed=4, extent=40.0)

    def f(o):
        from vrenderer_pathtracer.render.integrator import HitData

        b = o.shape[0]
        prev = HitData(
            hit=jnp.zeros((b,), bool),
            t=jnp.full((b,), 1e6, jnp.float32),
            point=jnp.zeros((b, 3)), normal=jnp.zeros((b, 3)),
            tangent=jnp.zeros((b, 3)), color=jnp.zeros((b, 3)),
            spec_color=jnp.zeros((b, 3)), emission=jnp.zeros((b, 3)),
            hit_type=jnp.zeros((b,), jnp.int32),
        )
        hd = mesh_hit(scene, settings, o, ray_d, prev)
        return jnp.sum(jnp.where(hd.hit[:, None], hd.point, 0.0))

    g = jax.grad(f)(ray_o)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0  # some rays hit -> nonzero grads
