"""Where the traversal is chosen: one platform choice, made at lowering.

``accel/traverse.py`` ``nearest_hit`` is the integrator's only mesh search.
It picks the Triton kernel when the program is lowered for a GPU and the
XLA loop ``traverse`` otherwise; no setting chooses it, and nothing
resolves to the kernel in interpret mode.  These tests lower programs for
``cuda`` here on the CPU (lowering needs no GPU) and read which search the
lowered module holds: the kernel is one ``xla.gpu.triton`` custom call
named ``bvh_traverse``; ``traverse`` is one ``stablehlo.while``.
"""

import collections
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.test_mesh_traversal import _aimed_rays, _soup
from vrenderer_pathtracer import Renderer, RenderSettings
from vrenderer_pathtracer.accel import traverse as traverse_mod
from vrenderer_pathtracer.accel.mesh import pack_mesh
from vrenderer_pathtracer.accel.traverse import (
    mesh_search, nearest_hit, traverse)
from vrenderer_pathtracer.accel.triton_traverse import traverse_triton
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer.scene.spheres import build_sphere_set

KERNEL = 'name = "bvh_traverse"'
WHILE = "stablehlo.while"


def _mesh_scene():
    return Scene(spheres=build_sphere_set(False),
                 mesh=pack_mesh(_soup(40, seed=1)))


def _rays(n=8):
    host = _soup(40, seed=1)
    o, d = _aimed_rays(host, n, seed=1)
    return o, d, jnp.full((n,), 1e6, jnp.float32)


def _lowered(fn, *args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def _search_text(platform):
    scene = _mesh_scene()
    settings = settings_for_scene(scene, RenderSettings())

    def fn(scene, o, d, t):
        return mesh_search(scene, settings, o, d, t)

    return _lowered(fn, scene, *_rays(), platform=platform)


def test_cpu_mesh_resolves_to_xla():
    txt = _search_text("cpu")
    assert KERNEL not in txt and "xla.gpu.triton" not in txt
    assert txt.count(WHILE) == 1


def test_gpu_mesh_resolves_to_kernel():
    txt = _search_text("cuda")
    assert txt.count(KERNEL) == 1 and "xla.gpu.triton" in txt
    assert WHILE not in txt  # the lock-step loop is not lowered at all


def test_gpu_analytic_scene_resolves_to_xla():
    """An analytic scene has no mesh search: nothing to dispatch."""
    settings = RenderSettings(width=8, height=8, samples_per_pass=1,
                              bounces=1, has_hdr=False)
    txt = _lowered(_pass_fn(settings), Scene.analytic(settings),
                   Camera.default(), platform="cuda")
    assert KERNEL not in txt


def _pass_fn(settings, grad=False):
    w, h = settings.width, settings.height

    def fwd(scene, camera):
        ro, rd = generate_rays(camera, w, h)
        rgb, _ = render_pass(scene, settings, ro, rd, pixel_ids(w, h),
                             jnp.uint32(1), jnp.float32(0.1),
                             jnp.float32(3.0))
        return jnp.mean(rgb ** 2)

    if not grad:
        return fwd
    return lambda scene, camera: jax.value_and_grad(
        lambda o: fwd(scene, camera._replace(origin=o)))(camera.origin)


def _pass_text(platform, has_mesh, grad=False):
    scene = _mesh_scene() if has_mesh else Scene.analytic(RenderSettings())
    settings = settings_for_scene(scene, RenderSettings(
        width=8, height=8, samples_per_pass=1, bounces=2, has_hdr=False))
    return _lowered(_pass_fn(settings, grad), scene, Camera.default(),
                    platform=platform)


def _ops(txt):
    """Histogram of the lowered ops, less the platform switch's own."""
    ops = collections.Counter(re.findall(r"stablehlo\.\w+", txt))
    for own in ("stablehlo.case", "stablehlo.constant", "stablehlo.return"):
        ops.pop(own, None)
    return ops


@pytest.mark.parametrize("platform", ["cpu", "cuda", "rocm"])
@pytest.mark.parametrize("has_mesh", [False, True])
def test_never_resolves_to_interpret(platform, has_mesh, monkeypatch):
    """The lowered pass holds the compiled kernel (mesh scene on a GPU) or
    exactly the XLA loop's ops, never the kernel run through the Pallas
    interpreter — whose lowering this test first shows to differ."""
    txt = _pass_text(platform, has_mesh)
    gpu_mesh = has_mesh and platform == "cuda"
    assert (KERNEL in txt) == gpu_mesh
    monkeypatch.setattr(traverse_mod, "nearest_hit", traverse)
    as_xla = _pass_text(platform, has_mesh)
    monkeypatch.setattr(traverse_mod, "nearest_hit",
                        functools.partial(traverse_triton, interpret=True))
    as_interpreted = _pass_text(platform, has_mesh)
    if has_mesh:
        assert _ops(as_interpreted) != _ops(as_xla)
    if gpu_mesh:
        assert txt.count(WHILE) < as_xla.count(WHILE)
    else:
        assert _ops(txt) == _ops(as_xla)


@pytest.mark.parametrize("grad", [False, True])
def test_render_pass_under_user_jit_picks_by_platform(grad):
    """render_pass traced inside the caller's own jit (and grad), as in
    inverse rendering: a GPU lowering still holds the kernel, a CPU one
    the XLA loop — the scene's arrays need not be concrete."""
    assert KERNEL in _pass_text("cuda", True, grad)
    assert KERNEL not in _pass_text("cpu", True, grad)


def test_search_matches_traverse_on_cpu():
    mesh = pack_mesh(_soup(40, seed=1))
    o, d, t = _rays(32)
    for got, want in zip(jax.jit(nearest_hit)(mesh, o, d, t),
                         traverse(mesh, o, d, t)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_step_resolves_for_its_device_mesh():
    """A sharded render step lowered for a GPU mesh holds the kernel; the
    same step lowered for the CPU holds the XLA loop."""
    from vrenderer_pathtracer.parallel import sharding

    mesh = sharding.make_render_mesh(devices=jax.devices("cpu")[:1])
    scene = _mesh_scene()
    settings = RenderSettings(width=8, height=8, samples_per_pass=1,
                              bounces=1, has_hdr=False)
    step = sharding.sharded_render_step(mesh, settings, scene=scene)
    args = (scene, Camera.default(), jnp.zeros((64, 3), jnp.float32),
            jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
    for platform, n in (("cuda", 1), ("cpu", 0)):
        txt = step.trace(*args).lower(lowering_platforms=(platform,)).as_text()
        assert txt.count(KERNEL) == n


def test_settings_have_no_traversal_option():
    with pytest.raises(TypeError):
        RenderSettings(traversal="xla")


def test_renderer_resolves_traversal_per_scene():
    """The renderer's flags follow the scene; no traversal is stored."""
    r = Renderer(8, 8, settings=RenderSettings(has_hdr=False))
    assert not r.settings.has_mesh
    r.init_mesh(pack_mesh(_soup(40, seed=1)))
    assert r.settings.has_mesh
    assert not hasattr(r.settings, "traversal")


def test_compact_waves_is_a_request_not_sticky():
    """compact_waves is re-resolved from the user's request on every scene
    change: a value set on the live settings (as scene resolution used to
    do for paged meshes) must not outlive the scene."""
    r = Renderer(8, 8, settings=RenderSettings(has_hdr=False))
    r.settings = r.settings.replace(compact_waves=True)
    r.init_mesh(pack_mesh(_soup(40, seed=1)))
    assert not r.settings.compact_waves
    r2 = Renderer(8, 8, settings=RenderSettings(has_hdr=False,
                                                compact_waves=True))
    r2.init_mesh(pack_mesh(_soup(40, seed=1)))
    assert r2.settings.compact_waves
    r2.use_cornell_box(True)
    assert r2.settings.compact_waves
