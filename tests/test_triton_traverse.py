"""Triton traversal kernel (accel/triton_traverse.py) vs its oracles.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
the ``gpu`` tests compile it for the card and skip elsewhere.  Results are
compared by hit/miss, hit distance and ORIGINAL triangle id
(``tri_order[slot]``): SBVH spatial splits duplicate a triangle across
leaves, so two correct traversals may report different slots for one hit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.test_mesh_render import write_uv_sphere
from tests.test_mesh_traversal import _aimed_rays, _rays, _soup
from vrenderer_pathtracer import native
from vrenderer_pathtracer.accel.mesh import pack_from_bvh
from vrenderer_pathtracer.accel.traverse import brute_force, traverse
from vrenderer_pathtracer.accel.triton_traverse import BLOCK, traverse_triton


def _uv_sphere(tmp_path_factory):
    p = tmp_path_factory.mktemp("m") / "s.obj"
    write_uv_sphere(str(p), radius=12.0, n_theta=20, n_phi=24)
    return native.load_obj(str(p))


def _packed(host):
    bvh = native.build_sbvh(host.verts, host.tris)
    return host, pack_from_bvh(host, bvh), np.asarray(bvh.tri_order)


@pytest.fixture(scope="module", params=["soup120", "soup600", "sphere"])
def mesh_case(request, tmp_path_factory):
    if request.param == "soup120":
        host = _soup(120, seed=11)
    elif request.param == "soup600":
        host = _soup(600, seed=12, extent=20.0)
    else:
        host = _uv_sphere(tmp_path_factory)
    return _packed(host)


def _primaries(n=96):
    """A coherent pinhole fan aimed at the origin from +z."""
    side = int(np.ceil(np.sqrt(n)))
    u, v = np.meshgrid(np.linspace(-0.4, 0.4, side), np.linspace(-0.4, 0.4, side))
    d = np.stack([u.ravel(), v.ravel(), -np.ones(side * side)], -1)[:n]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile([[0.0, 0.0, 60.0]], (n, 1))
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.full((n,), 1e6, jnp.float32))


def _ray_set(name, host):
    if name == "primaries":
        return _primaries()
    if name == "inside":
        o = jnp.zeros((64, 3), jnp.float32)
        _, d = _rays(64, seed=3)
        return o, d, jnp.full((64,), 1e6, jnp.float32)
    if name == "axis_aligned":
        axes = np.concatenate([np.eye(3), -np.eye(3)])
        d = np.repeat(axes, 8, axis=0)
        o = np.random.default_rng(4).uniform(-5, 5, (48, 3))
        o[np.arange(48), np.repeat(np.arange(6) % 3, 8)] = 0.0
        return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
                jnp.full((48,), 1e6, jnp.float32))
    if name == "tmax_clip":
        o, d = _aimed_rays(host, 64, seed=5)
        t_max = jnp.asarray(np.random.default_rng(6).uniform(0.0, 80.0, 64),
                            jnp.float32)
        return o, d, t_max
    if name == "nan_lanes":
        o, d = _aimed_rays(host, 64, seed=7)
        d = d.at[::5].set(jnp.nan)
        o = o.at[3::7].set(jnp.nan)
        return o, d, jnp.full((64,), 1e6, jnp.float32)
    raise ValueError(name)


def _check(mesh, order, ray, got, want, rtol=1e-5):
    slot_k, t_k = (np.asarray(x) for x in got)
    slot_o, t_o = (np.asarray(x) for x in want)
    hit_k, hit_o = slot_k >= 0, slot_o >= 0
    np.testing.assert_array_equal(hit_k, hit_o)
    np.testing.assert_allclose(t_k[hit_k], t_o[hit_o], rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(order[slot_k[hit_k]], order[slot_o[hit_o]])
    # Misses report t_max, like traverse.
    np.testing.assert_array_equal(np.isnan(t_k), np.isnan(t_o))
    return hit_k


@pytest.mark.parametrize("oracle", ["brute_force", "traverse"])
@pytest.mark.parametrize(
    "rays", ["primaries", "inside", "axis_aligned", "tmax_clip", "nan_lanes"])
def test_kernel_matches_oracle(mesh_case, rays, oracle):
    host, mesh, order = mesh_case
    o, d, t_max = _ray_set(rays, host)
    want = (brute_force if oracle == "brute_force" else traverse)(
        mesh, o, d, t_max)
    got = traverse_triton(mesh, o, d, t_max, interpret=True)
    # The lock-step loop accumulates t in another order: 1e-4 relative.
    hit = _check(mesh, order, rays, got, want,
                 rtol=1e-5 if oracle == "brute_force" else 1e-4)
    if rays == "nan_lanes":
        bad = np.isnan(np.asarray(o)).any(-1) | np.isnan(np.asarray(d)).any(-1)
        assert not hit[bad].any()


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK + 1])
@pytest.mark.parametrize("mesh_name", ["soup120", "sphere"])
def test_kernel_batch_padding(n, mesh_name, tmp_path_factory):
    host = (_soup(120, seed=11) if mesh_name == "soup120"
            else _uv_sphere(tmp_path_factory))
    host, mesh, order = _packed(host)
    o, d = _aimed_rays(host, n, seed=n)
    t_max = jnp.full((n,), 1e6, jnp.float32)
    slot, t = traverse_triton(mesh, o, d, t_max, interpret=True)
    assert slot.shape == (n,) and t.shape == (n,)
    assert slot.dtype == jnp.int32 and t.dtype == jnp.float32
    _check(mesh, order, "aimed", (slot, t), brute_force(mesh, o, d, t_max))


def test_kernel_dead_lanes_are_skipped():
    """t_max <= 0 marks a terminated lane: it must report a miss with t
    unchanged, whatever its ray hits."""
    host, mesh, _ = _packed(_soup(120, seed=11))
    o, d = _aimed_rays(host, 32, seed=2)
    t_max = jnp.where(jnp.arange(32) % 2 == 0, 0.0, 1e6).astype(jnp.float32)
    slot, t = traverse_triton(mesh, o, d, t_max, interpret=True)
    assert (np.asarray(slot)[::2] == -1).all()
    np.testing.assert_array_equal(np.asarray(t)[::2], 0.0)
    assert (np.asarray(slot)[1::2] >= 0).any()


def test_gradient_through_render_pass_with_kernel(kernel_in_interpreter):
    """jax.grad flows through render_pass with the kernel as the mesh
    search (its inputs are detached; attributes are recomputed outside
    it), and matches the XLA-traversal gradient w.r.t. the env map."""
    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    host, mesh, _ = _packed(_soup(200, seed=4, extent=15.0))
    hdr = jnp.asarray(np.random.default_rng(0).uniform(0.2, 1.5, (8, 16, 3)),
                      jnp.float32)
    scene = Scene(spheres=build_sphere_set(False), mesh=mesh, hdr=hdr)
    settings = RenderSettings(width=16, height=16, samples_per_pass=2,
                              bounces=2, has_mesh=True)
    cam = Camera.default()._replace(origin=jnp.asarray([0.0, 0.0, 60.0]))
    ro, rd = generate_rays(cam, 16, 16)
    ids = pixel_ids(16, 16)

    def loss(env):
        rgb, _ = render_pass(scene._replace(hdr=env), settings, ro, rd, ids,
                             jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
        return jnp.mean(rgb ** 2)

    l_x, g_x = jax.value_and_grad(loss)(hdr)
    kernel_in_interpreter()
    l_k, g_k = jax.value_and_grad(loss)(hdr)
    assert np.isfinite(np.asarray(g_k)).all()
    assert float(jnp.abs(g_k).sum()) > 0.0
    np.testing.assert_allclose(float(l_k), float(l_x), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x),
                               rtol=2e-2, atol=2e-4)


@pytest.mark.gpu
def test_kernel_on_gpu_matches_traverse(gpu_device):
    """The kernel compiled for the card vs the XLA loop and brute force."""
    host, mesh, order = _packed(_soup(600, seed=12, extent=20.0))
    mesh = jax.device_put(mesh, gpu_device)
    for name in ("primaries", "inside", "axis_aligned", "tmax_clip",
                 "nan_lanes"):
        o, d, t_max = (jax.device_put(x, gpu_device)
                       for x in _ray_set(name, host))
        got = traverse_triton(mesh, o, d, t_max)
        _check(mesh, order, name, got, traverse(mesh, o, d, t_max),
               rtol=1e-4)
        _check(mesh, order, name, got, brute_force(mesh, o, d, t_max))


@pytest.mark.gpu
def test_render_pass_on_gpu_resolves_to_kernel(gpu_device):
    """On a GPU the integrator's mesh search compiles to the kernel, and
    gives the kernel's answers."""
    from vrenderer_pathtracer.accel.traverse import nearest_hit

    host, mesh, order = _packed(_soup(120, seed=11))
    mesh = jax.device_put(mesh, gpu_device)
    o, d, t_max = (jax.device_put(x, gpu_device)
                   for x in _ray_set("tmax_clip", host))
    search = jax.jit(nearest_hit)
    assert 'name = "bvh_traverse"' in search.lower(mesh, o, d, t_max).as_text()
    got = search(mesh, o, d, t_max)
    _check(mesh, order, "tmax_clip", got, brute_force(mesh, o, d, t_max))
