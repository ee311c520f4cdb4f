"""Config-3 pipeline: mesh + diffuse/normal/specular maps (CI scale).

BASELINE config 3 is "bunny with SBVH, diffuse+normal+specular maps, 512²";
at CI scale a UV-sphere stands in for the bunny.  Checks the texture paths
the reference wires through the leaf-hit shader
(``cuda/src/PathTracer.cu:385-455``): diffuse fetch colors the mesh,
TBN normal mapping perturbs shading, specular map drives the Fresnel branch.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer import Renderer, RenderSettings

SETTINGS = RenderSettings(
    use_cornell_box=True, has_hdr=False, samples_per_pass=4, bounces=2
)


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("m") / "s.obj"
    write_uv_sphere(p, radius=14.0, n_theta=24, n_phi=32)
    return str(p)


def _render(sphere_obj, *, diffuse=None, normal=None, specular=None, frames=3):
    r = Renderer(48, 48, settings=SETTINGS)
    r.load_mesh(sphere_obj)
    if diffuse is not None:
        r.load_texture(diffuse, 2.2, 0)
    if normal is not None:
        r.load_texture(normal, 2.2, 1)
    if specular is not None:
        r.load_texture(specular, 2.2, 2)
    img, depth = r.render_frames(frames)
    return img, depth, r


CENTER = np.s_[18:30, 18:30]


def test_diffuse_map_colors_mesh(sphere_obj):
    red = np.zeros((16, 16, 3), np.float32)
    red[..., 0] = 0.9
    img_red, _, r = _render(sphere_obj, diffuse=red)
    assert r.settings.has_diffuse_map
    img_plain, _, _ = _render(sphere_obj)
    # Red-tinted mesh: R dominates G/B in the center where the mesh is.
    c = img_red[CENTER].mean(axis=(0, 1))
    assert c[0] > 1.5 * c[1] and c[0] > 1.5 * c[2], c
    cp = img_plain[CENTER].mean(axis=(0, 1))
    assert abs(cp[0] - cp[1]) < 0.1 * cp[0]  # plain mesh is neutral


def test_captured_attrs_wavefront_parity(sphere_obj, kernel_in_interpreter):
    """The wavefront with the Triton traversal kernel matches the XLA
    traversal on a diffuse+normal+specular-mapped mesh scene under the usual
    cross-program outlier contract (kernel in interpret mode on CPU)."""
    from vrenderer_pathtracer.accel.mesh import pack_mesh
    from vrenderer_pathtracer.core.camera import (
        Camera, generate_rays, pixel_ids)
    from vrenderer_pathtracer.native import load_obj
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    rng = np.random.default_rng(9)
    nmap = jnp.asarray((rng.uniform(0, 1, (16, 16, 3)) * 0.3
                        + (0.35, 0.35, 0.7)).astype(np.float32))
    smap = jnp.asarray(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    dmap = jnp.asarray(rng.uniform(0.2, 1, (16, 16, 3)).astype(np.float32))
    mesh = pack_mesh(load_obj(sphere_obj))
    scene = Scene(spheres=build_sphere_set(True), mesh=mesh,
                  diffuse_map=dmap, normal_map=nmap, specular_map=smap)
    settings = SETTINGS.replace(
        width=32, height=32, has_mesh=True, has_diffuse_map=True,
        has_normal_map=True, has_specular_map=True)
    cam = Camera.default()
    ro, rd = generate_rays(cam, 32, 32)
    ids = pixel_ids(32, 32)
    args = (jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
    rgb_a, dep_a = render_pass(scene, settings, ro, rd, ids, *args)
    kernel_in_interpreter()
    rgb_b, dep_b = render_pass(scene, settings, ro, rd, ids, *args)
    d = np.abs(np.asarray(rgb_a) - np.asarray(rgb_b)).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.02, f"{(d > 1e-3).mean():.3%} diverge"
    assert d[d <= 1e-3].mean() <= 1e-4


def test_pre_tiled_pallas_matches_xla_traversal(sphere_obj,
                                                 kernel_in_interpreter):
    """render_pass with the Triton traversal kernel matches the
    XLA-traversal render on a normal-mapped mesh under the usual
    cross-program bounds (kernel in interpret mode on CPU)."""
    from vrenderer_pathtracer.accel.mesh import pack_mesh
    from vrenderer_pathtracer.core.camera import (
        Camera, generate_rays, pixel_ids)
    from vrenderer_pathtracer.native import load_obj
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    rng = np.random.default_rng(5)
    nmap = jnp.asarray((rng.uniform(0, 1, (16, 16, 3)) * 0.3
                        + (0.35, 0.35, 0.7)).astype(np.float32))
    mesh = pack_mesh(load_obj(sphere_obj))
    scene = Scene(spheres=build_sphere_set(True), mesh=mesh,
                  normal_map=nmap)
    base = SETTINGS.replace(width=32, height=32, has_mesh=True,
                            has_normal_map=True,
                            samples_per_pass=2, bounces=2)
    cam = Camera.default()
    ro, rd = generate_rays(cam, 32, 32)
    ids = pixel_ids(32, 32)
    args = (jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
    rgb_x, dep_x = render_pass(scene, base, ro, rd, ids, *args)
    kernel_in_interpreter()
    rgb_p, dep_p = render_pass(scene, base, ro, rd, ids, *args)
    d = np.abs(np.asarray(rgb_x) - np.asarray(rgb_p)).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.02, f"{(d > 1e-3).mean():.3%} diverge"
    dd = np.abs(np.asarray(dep_x) - np.asarray(dep_p))
    assert (dd > 1e-3).mean() <= 0.02


def test_normal_map_changes_shading(sphere_obj):
    flat = np.zeros((16, 16, 3), np.float32)
    flat[..., 2] = 1.0  # (0,0,1) tangent space = unperturbed
    flat = flat * 0.5 + 0.5  # encode to [0,1] texel range
    bumpy = np.random.default_rng(0).uniform(0.2, 0.8, (16, 16, 3)).astype(np.float32)

    img_flat, _, r = _render(sphere_obj, normal=flat)
    assert r.settings.has_normal_map
    img_bumpy, _, _ = _render(sphere_obj, normal=bumpy)
    # Perturbed normals change the mesh shading measurably.
    d = np.abs(img_flat[CENTER] - img_bumpy[CENTER]).mean()
    assert d > 0.01, d


def test_specular_map_enables_fresnel(sphere_obj):
    spec = np.ones((8, 8, 3), np.float32)
    img_spec, _, r = _render(sphere_obj, specular=spec, frames=4)
    assert r.settings.has_specular_map
    img_diff, _, _ = _render(sphere_obj, frames=4)
    # With specular=1 the Fresnel branch fires (reference: spec color feeds
    # the fresnel estimate); images must differ on the mesh.
    d = np.abs(img_spec[CENTER] - img_diff[CENTER]).mean()
    assert d > 0.005, d


def test_textured_example_sphere(sphere_obj):
    """The same maps drive the example-sphere path (reference :192-268)."""
    red = np.zeros((8, 8, 3), np.float32)
    red[..., 0] = 0.9
    r = Renderer(32, 32, settings=SETTINGS.replace(use_example_sphere=True))
    r.load_texture(red, 2.2, 0)
    img, _ = r.render_frames(2)
    c = img[12:20, 12:20].mean(axis=(0, 1))
    assert c[0] > 1.5 * c[1], c
