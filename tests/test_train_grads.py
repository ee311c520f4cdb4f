"""Gradients of the sharded training step vs finite differences.

The step's gradients come from ``jax.value_and_grad`` of the wavefront,
psum-reduced inside the backward program; they are recovered here from the
SGD update, ``(p0 - p1) / lr``.  Material parameters are checked against
central differences of the same loss on a scene with well-conditioned
intersections (the real Cornell box's r=1e5 walls flip silhouette pixels
between any two compilations, independently of the parameters).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import cpu_devices
from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.parallel.sharding import (
    TrainParams, make_render_mesh, replicate, shard_pixels,
    sharded_opt_step, sharded_train_step)
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import Scene

SETTINGS = RenderSettings(width=32, height=16, samples_per_pass=2, bounces=3,
                          use_cornell_box=True, has_hdr=False)
LR = 0.05


def _benign_scene() -> Scene:
    """Cornell-like spheres with normal radii (well-conditioned hits)."""
    from vrenderer_pathtracer.scene.spheres import DIFF, SPEC, SphereSet

    rows = [
        # (radius, pos, emission, color, refl, spec_color)
        (20.0, (0.0, 45.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), DIFF, (0, 0, 0)),
        (60.0, (95.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25),
         DIFF, (0, 0, 0)),
        (60.0, (-95.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25),
         DIFF, (0, 0, 0)),
        (60.0, (0.0, 0.0, -120.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),
        (60.0, (0.0, -95.0, 0.0), (0, 0, 0), (0.9, 0.9, 0.9), DIFF, (0, 0, 0)),
        (12.0, (18.0, -5.0, 20.0), (0, 0, 0), (0, 0, 0), SPEC, (1, 1, 1)),
        (12.0, (-18.0, -5.0, 20.0), (0, 0, 0), (1, 1, 1), DIFF, (1, 1, 1)),
    ]

    def col(i, dtype=np.float32):
        return jnp.asarray(np.array([r[i] for r in rows], dtype))

    return Scene(spheres=SphereSet(
        pos=col(1), radius=col(0), emission=col(2), color=col(3),
        refl=col(4, np.int32), spec_color=col(5)))


def _loss_fn(scene, settings, target):
    ro, rd = generate_rays(Camera.default(), settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)
    inv_n = 1.0 / (settings.n_pixels * 3)

    @jax.jit
    def loss(p):
        s2 = scene._replace(spheres=scene.spheres._replace(
            color=p.color, emission=p.emission))
        rgb, _ = render_pass(s2, settings, ro, rd, ids, jnp.uint32(1),
                             p.fresnel_coef, p.fresnel_pow)
        return jnp.sum((rgb - target) ** 2) * inv_n

    return loss


def _step_grads(scene, settings, target, n_tiles=2, n_samples=1):
    mesh = make_render_mesh(n_tiles=n_tiles, n_samples=n_samples,
                            devices=cpu_devices()[:n_tiles * n_samples])
    p0 = TrainParams.from_scene(scene)
    p1, loss = sharded_train_step(mesh, settings, lr=LR)(
        replicate(mesh, p0), replicate(mesh, scene),
        replicate(mesh, Camera.default()), shard_pixels(mesh, target),
        jnp.uint32(1))
    return p0, jax.tree.map(lambda a, b: (a - b) / LR, p0, p1), float(loss)


def _target(settings, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0, 0.5, (settings.n_pixels, 3)),
                       jnp.float32)


@pytest.mark.parametrize("leaf,index,h", [
    ("emission", (0, 1), 0.05),   # light sphere, green (loss is quadratic)
    ("color", (1, 0), 0.02),      # red wall albedo, red channel
])
def test_train_step_grads_match_fd(leaf, index, h):
    scene = _benign_scene()
    target = _target(SETTINGS)
    p0, g, loss = _step_grads(scene, SETTINGS, target)
    f = _loss_fn(scene, SETTINGS, target)
    np.testing.assert_allclose(loss, float(f(p0)), rtol=1e-4)

    def bump(d):
        arr = getattr(p0, leaf)
        return p0._replace(**{leaf: arr.at[index].add(d)})

    fd = (float(f(bump(h))) - float(f(bump(-h)))) / (2 * h)
    got = float(getattr(g, leaf)[index])
    assert abs(got) > 1e-6
    np.testing.assert_allclose(got, fd, rtol=5e-3, atol=1e-6)


def test_odd_size_train_grads_match_fd():
    """Tiles of an odd frame (32x25 px: 400 px per tile) give the same
    gradient as a finite difference of the whole-frame loss."""
    settings = SETTINGS.replace(height=25)
    scene = _benign_scene()
    target = _target(settings, seed=3)
    p0, g, _ = _step_grads(scene, settings, target)
    f = _loss_fn(scene, settings, target)
    h = 0.05
    e = p0.emission
    fd = (float(f(p0._replace(emission=e.at[0, 0].add(h))))
          - float(f(p0._replace(emission=e.at[0, 0].add(-h))))) / (2 * h)
    np.testing.assert_allclose(float(g.emission[0, 0]), fd, rtol=5e-3,
                               atol=1e-6)


def test_camera_grads_through_train_step():
    """Camera gradients through the sharded step (tiles x samples) match
    value_and_grad of the single-device loss; camera motion moves
    silhouettes, so finite differences are not the oracle here."""
    settings = SETTINGS.replace(samples_per_pass=2)
    scene = _benign_scene()
    target = _target(settings, seed=1)
    cam = Camera.default()
    ids = pixel_ids(settings.width, settings.height)
    inv_n = 1.0 / (settings.n_pixels * 3)

    def loss_fn(c):
        ro, rd = generate_rays(c, settings.width, settings.height)
        rgb, _ = render_pass(scene, settings, ro, rd, ids, jnp.uint32(1),
                             jnp.float32(0.1), jnp.float32(3.0))
        return jnp.sum((rgb - target) ** 2) * inv_n

    ref_g = jax.grad(loss_fn)(cam)
    mesh = make_render_mesh(n_tiles=2, n_samples=2, devices=cpu_devices()[:4])
    p0 = TrainParams.from_scene(scene, camera=cam)
    # A large step, so that lr * g is resolvable next to origin.z = 150
    # and fov = 75 in float32.
    lr = 1e3
    p1, _ = sharded_train_step(mesh, settings, lr=lr)(
        replicate(mesh, p0), replicate(mesh, scene), replicate(mesh, cam),
        shard_pixels(mesh, target), jnp.uint32(1))
    g = jax.tree.map(lambda a, b: (a - b) / lr, p0.camera, p1.camera)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(ref_g)):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-2, atol=2e-5)
    assert float(jnp.abs(g.origin).sum()) > 0.0


def test_adam_train_step_recovers_emission():
    """A few optax steps through sharded_opt_step pull the light's
    emission toward a brighter target render."""
    import optax

    settings = SETTINGS.replace(bounces=2)
    scene = _benign_scene()
    bright = scene.spheres.emission.at[0].mul(1.5)
    ro, rd = generate_rays(Camera.default(), settings.width, settings.height)
    target, _ = render_pass(
        scene._replace(spheres=scene.spheres._replace(emission=bright)),
        settings, ro, rd, pixel_ids(settings.width, settings.height),
        jnp.uint32(1), jnp.float32(0.1), jnp.float32(3.0))
    mesh = make_render_mesh(n_tiles=2, n_samples=1, devices=cpu_devices()[:2])
    opt = optax.adam(0.1)
    params = TrainParams.from_scene(scene)
    step = sharded_opt_step(mesh, settings, opt)
    state = replicate(mesh, opt.init(params))
    params = replicate(mesh, params)
    scene_r = replicate(mesh, scene)
    cam = replicate(mesh, Camera.default())
    target = shard_pixels(mesh, target)
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, scene_r, cam, target,
                                jnp.uint32(1))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses
