"""Compact bounce-wave tail (render/integrator.py, round 5).

The tail gathers live lanes after bounce 0 and runs the remaining bounces
at reduced width; per-lane arithmetic (RNG streams, traversal running-min,
scatter math) is identical, so images must match the full-width tail
exactly.  The lax.cond fallback (live count > capacity) must also be
exercised, plus gradients through the gather/scatter/cond structure.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer.accel.mesh import pack_mesh
from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.native import load_obj
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer.scene.spheres import build_sphere_set


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("m") / "s.obj"
    write_uv_sphere(str(p), radius=10.0, n_theta=24, n_phi=24)
    mesh = pack_mesh(load_obj(str(p)))
    rng = np.random.default_rng(0)
    hdr = jnp.asarray(rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32))
    return Scene(spheres=build_sphere_set(False), mesh=mesh, hdr=hdr)


def _render(scene, settings, w=64, h=64):
    cam = Camera.default()  # z=150: low hit rate -> sparse bounce waves
    ro, rd = generate_rays(cam, w, h)
    ids = pixel_ids(w, h)
    return render_pass(scene, settings, ro, rd, ids, jnp.uint32(1),
                       jnp.float32(0.1), jnp.float32(3.0))


def test_compact_tail_matches_full(mesh_scene):
    base = settings_for_scene(mesh_scene, RenderSettings(
        width=64, height=64, samples_per_pass=2, bounces=3,
        use_cornell_box=False))
    assert not base.compact_waves  # CPU mesh -> xla traversal -> gate off
    img0, dep0 = _render(mesh_scene, base)
    img1, dep1 = _render(mesh_scene, base.replace(compact_waves=True))
    assert float(jnp.abs(img0).mean()) > 1e-3
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1),
                               rtol=1e-6, atol=1e-6)
    # Depth: fp-association differences between the two differently-fused
    # programs flip the discrete hit winner on ~2% of silhouette/edge
    # pixels (adjacent triangles sharing the hit point — the documented
    # outlier-tolerant convention); the surviving depth delta is ~1e-4.
    ddiff = np.abs(np.asarray(dep0) - np.asarray(dep1))
    assert (ddiff > 1e-6).mean() < 0.05
    assert ddiff.max() < 1e-3


def test_compact_fallback_when_capacity_exceeded(mesh_scene):
    """A capacity below the live count must take the exact full-width
    branch of the cond (identical image)."""
    base = settings_for_scene(mesh_scene, RenderSettings(
        width=64, height=64, samples_per_pass=2, bounces=3,
        use_cornell_box=False))
    img0, _ = _render(mesh_scene, base)
    tiny = base.replace(compact_waves=True,
                        compact_capacity_frac=1.0 / 8192.0)
    img1, _ = _render(mesh_scene, tiny)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1),
                               rtol=1e-6, atol=1e-6)


def test_compact_tail_gradients_match(mesh_scene):
    """value_and_grad w.r.t. the env map flows through the compact tail's
    gather/scatter/cond and matches the full-width gradients."""
    base = settings_for_scene(mesh_scene, RenderSettings(
        width=32, height=32, samples_per_pass=2, bounces=3,
        use_cornell_box=False))
    cam = Camera.default()
    ro, rd = generate_rays(cam, 32, 32)
    ids = pixel_ids(32, 32)

    def loss(hdr, settings):
        s2 = mesh_scene._replace(hdr=hdr)
        rgb, _ = render_pass(s2, settings, ro, rd, ids, jnp.uint32(1),
                             jnp.float32(0.1), jnp.float32(3.0))
        return jnp.mean(rgb ** 2)

    l0, g0 = jax.value_and_grad(loss)(mesh_scene.hdr, base)
    l1, g1 = jax.value_and_grad(loss)(
        mesh_scene.hdr, base.replace(compact_waves=True))
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                               rtol=1e-5, atol=1e-7)
    assert float(jnp.abs(g1).sum()) > 0.0


def test_compact_ladder_engages_mid_chain(mesh_scene):
    """A view-filling mesh exceeds capacity at bounce 0 but its convex
    surface kills most bounce-1 rays — the ladder must compact at a later
    bounce and still match the full-width render."""
    base = settings_for_scene(mesh_scene, RenderSettings(
        width=64, height=64, samples_per_pass=2, bounces=3,
        use_cornell_box=False))
    cam = Camera.default()._replace(
        origin=jnp.asarray([0.0, 0.0, 26.0], jnp.float32))
    ro, rd = generate_rays(cam, 64, 64)
    ids = pixel_ids(64, 64)

    def render(settings):
        return render_pass(mesh_scene, settings, ro, rd, ids, jnp.uint32(1),
                           jnp.float32(0.1), jnp.float32(3.0))

    img0, _ = render(base)
    # Capacity 25%: primary hits (~50% of pixels) overflow it; bounce-1
    # live lanes (escaping cosine rays) fit.
    img1, _ = render(base.replace(compact_waves=True,
                                  compact_capacity_frac=0.25))
    assert float(jnp.abs(img0).mean()) > 1e-3
    diff = np.abs(np.asarray(img0) - np.asarray(img1))
    # Outlier-tolerant: fp-association slot flips on silhouette pixels.
    assert (diff.max(axis=-1) > 1e-5).mean() < 0.02


def test_renderer_forces_compact_after_measured_first_pass(tmp_path):
    """Adaptive static specialization: after pass 1 the Renderer measures
    the (pass-invariant) primary hit count and hard-wires the compact
    chain; accumulation stays consistent with a never-compacted renderer,
    and any camera change reverts to the safe cond mode."""
    from vrenderer_pathtracer import Renderer, RenderSettings

    p = tmp_path / "s.obj"
    write_uv_sphere(str(p), radius=10.0, n_theta=16, n_phi=16)
    hdr = np.full((8, 16, 3), 0.5, np.float32)

    def make(compact):
        r = Renderer(32, 32, settings=RenderSettings(
            samples_per_pass=2, bounces=2, compact_waves=compact))
        r.load_hdr(hdr)
        r.load_mesh(str(p))
        return r

    r = make(True)
    assert r.settings.compact_mode == "cond"
    img1, _ = r.render_frames(1)
    assert r.settings.compact_mode == "forced"   # ~3% hit rate fits B/8
    img3, _ = r.render_frames(2)                 # two passes in forced mode

    r0 = make(False)
    ref3 = None
    for _ in range(3):
        ref3 = r0.render_frames(1)[0]
    np.testing.assert_allclose(np.asarray(img3), np.asarray(ref3),
                               rtol=1e-5, atol=1e-5)

    r.set_camera(r.camera.orbit(30.0, 0.0))      # camera edit -> cond
    assert r.settings.compact_mode == "cond"
