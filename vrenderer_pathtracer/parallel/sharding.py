"""Multi-device execution: tile × sample sharding over a device mesh.

The reference's only parallelism is single-GPU SIMT over pixels
(``cuda/src/PathTracer.cu:887-891``: one thread per pixel, 16×16 blocks).
The generalisation (SURVEY §2 "parallelism inventory") keeps the
same work decomposition — per-pixel radiance estimates are independent and
accumulation is a sum — and shards it over a 2-D device mesh:

* axis ``"tiles"``   — the flattened pixel axis is split into contiguous
  tiles, one shard per mesh column; no communication is needed on this axis
  (the reference's thread-block grid, lifted to devices).
* axis ``"samples"`` — sample batches are split across mesh rows; each
  device draws *disjoint RNG sample streams* (counter-based threefry,
  core/rng.py) and partial radiance estimates are combined with
  ``lax.pmean``.

Scene data (spheres, BVH arrays, textures, HDRI, MERL table) is **replicated**
into every device's memory — exactly the reference's single-GPU resident set — so
the only collectives on the forward path are the sample-axis mean, and on the
backward path one ``psum`` of parameter gradients (overlapped by XLA with the
rest of the backward pass).

Everything here also runs on CPU meshes created with
``--xla_force_host_platform_device_count=N`` — the scaling tests and the
multi-device dry run use the same code path as the cards.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.ops.tonemap import tonemap
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import Scene, settings_for_scene

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_render_mesh(n_tiles: Optional[int] = None, n_samples: int = 1,
                     devices=None) -> Mesh:
    """A 2-D ``(tiles, samples)`` device mesh.

    With one device this degenerates to a 1×1 mesh, so one card and four
    share the same jitted program — scaling changes only the mesh
    (SURVEY §4.4).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_tiles is None:
        n_tiles = n // n_samples
    if n_tiles * n_samples != n:
        raise ValueError(f"{n_tiles}x{n_samples} mesh != {n} devices")
    dev_array = np.asarray(devices).reshape(n_tiles, n_samples)
    return Mesh(dev_array, (TILE_AXIS, SAMPLE_AXIS))


def _check_divisible(settings: RenderSettings, mesh: Mesh):
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if settings.n_pixels % n_tiles:
        raise ValueError(f"{settings.n_pixels} pixels not divisible by {n_tiles} tiles")
    if settings.samples_per_pass % n_samp and settings.samples_per_pass != 0:
        # each sample-shard renders samples_per_pass/n_samp estimates
        raise ValueError(
            f"samples_per_pass={settings.samples_per_pass} not divisible by "
            f"{n_samp} sample shards"
        )


def _shard_pass(scene, camera, frame, fresnel_coef, fresnel_pow,
                settings: RenderSettings, seed: int, local_spp: int):
    """Per-shard body: render my pixel tile with my sample sub-batch."""
    my_tile = lax.axis_index(TILE_AXIS)
    my_samp = lax.axis_index(SAMPLE_AXIS)
    n_tiles = lax.axis_size(TILE_AXIS)

    tile_px = settings.n_pixels // n_tiles
    start = my_tile * tile_px
    local = settings.replace(samples_per_pass=local_spp)

    # Reconstruct this shard's primary rays from the global pixel ids —
    # ray gen is cheap and local, so nothing is scattered from the host.
    all_o, all_d = generate_rays(camera, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)
    ray_o = lax.dynamic_slice_in_dim(all_o, start * 1, tile_px, axis=0)
    ray_d = lax.dynamic_slice_in_dim(all_d, start * 1, tile_px, axis=0)
    ids = lax.dynamic_slice_in_dim(ids, start, tile_px, axis=0)

    rgb, depth = render_pass(
        scene, local, ray_o, ray_d, ids, frame, fresnel_coef, fresnel_pow,
        seed, sample_offset=my_samp * local_spp,
    )
    # Combine sample sub-batches: mean of means over disjoint RNG streams.
    rgb = lax.pmean(rgb, SAMPLE_AXIS)
    depth = _last_shard_depth(depth)
    return rgb, depth


def _last_shard_depth(depth):
    """Depth from the LAST sample shard only (single-device semantics).

    ``render_pass`` keeps the globally *last* sample's depth; Cornell kill
    zeroes escaped samples, so shards disagree and a pmean would halve the
    value whenever any shard's path escaped.  The last shard holds the
    globally-last sample id, so selecting it reproduces the single-device
    last-write convention bitwise.
    """
    n_samp = lax.axis_size(SAMPLE_AXIS)
    is_last = lax.axis_index(SAMPLE_AXIS) == n_samp - 1
    return lax.psum(jnp.where(is_last, depth, 0.0), SAMPLE_AXIS)


def sharded_render_step(mesh: Mesh, settings: RenderSettings, seed: int = 0,
                        scene: Optional[Scene] = None):
    """Build a jitted progressive-pass function sharded over ``mesh``.

    Returns ``step(scene, camera, accum, frame, fresnel_coef, fresnel_pow)
    -> (accum', img, depth)`` where ``accum``/``img`` are sharded over the
    pixel axis (tiles) and replicated over samples.

    Pass ``scene`` (the scene this step will render) to derive the
    ``has_*`` flags from its assets; without it the settings' own flags
    hold.
    """
    if scene is not None:
        settings = settings_for_scene(scene, settings)
    _check_divisible(settings, mesh)
    n_samp = mesh.shape[SAMPLE_AXIS]
    local_spp = max(settings.samples_per_pass // n_samp, 1)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS), P(), P(), P()),
        out_specs=(P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        check_vma=False,
    )
    def _body(scene, camera, accum, frame, fresnel_coef, fresnel_pow):
        rgb, depth = _shard_pass(
            scene, camera, frame, fresnel_coef, fresnel_pow, settings, seed,
            local_spp,
        )
        accum = accum + rgb
        img = tonemap(accum, frame, settings.gamma)
        return accum, img, depth

    return jax.jit(_body)


def replicate(mesh: Mesh, tree):
    """Put a pytree on every device (the scene upload: replicated)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_pixels(mesh: Mesh, tree):
    """Shard leading (pixel) axis over the tile axis of the mesh."""
    sharding = NamedSharding(mesh, P(TILE_AXIS))
    return jax.device_put(tree, sharding)


# ---------------------------------------------------------------------------
# Inverse rendering: the distributed training step
# ---------------------------------------------------------------------------

class TrainParams(NamedTuple):
    """Differentiable scene parameters for inverse rendering.

    The reference has no training; differentiability is the new axis
    (BASELINE north star: gradients w.r.t. camera, material, texture and
    env map, all-reduced via psum).  ``camera`` and ``hdr`` are optional
    pytree extensions — None leaves are empty subtrees, so enabling them
    only changes which gradients flow, not the step's code path.
    """

    color: jnp.ndarray      # [N_spheres, 3] albedo
    emission: jnp.ndarray   # [N_spheres, 3]
    fresnel_coef: jnp.ndarray  # []
    fresnel_pow: jnp.ndarray   # []
    camera: Optional[Camera] = None       # optimize the camera too
    hdr: Optional[jnp.ndarray] = None     # optimize the environment map

    @classmethod
    def from_scene(cls, scene: Scene, fresnel_coef=0.1, fresnel_pow=3.0,
                   camera: Optional[Camera] = None,
                   optimize_hdr: bool = False):
        return cls(
            color=scene.spheres.color,
            emission=scene.spheres.emission,
            fresnel_coef=jnp.float32(fresnel_coef),
            fresnel_pow=jnp.float32(fresnel_pow),
            camera=camera,
            hdr=scene.hdr if optimize_hdr else None,
        )


@jax.custom_vjp
def _id_allreduce(v):
    return v


def _id_fwd(v):
    return v, None


def _id_bwd(_, g):
    return (lax.psum(lax.pmean(g, SAMPLE_AXIS), TILE_AXIS),)


_id_allreduce.defvjp(_id_fwd, _id_bwd)


def allreduce_grads_in_bwd(params):
    """Identity on ``params`` whose VJP all-reduces each leaf's cotangent.

    Wrapping the parameters at the TOP of the loss function plants one
    psum+pmean per parameter *inside the backward program, at the point
    where that parameter's gradient is finalized* — instead of one
    bulk reduction after ``value_and_grad`` returns.  XLA's latency-hiding
    scheduler can then overlap each collective with the remaining backward
    compute (BASELINE north star: grads "all-reduced via psum overlapped
    with the backward pass").  Each array leaf is wrapped separately so
    independent parameters reduce independently; values are identical to
    the post-hoc reduction (psum placement commutes with the pure
    per-shard backward), which the sharded-vs-single-device parity tests
    in tests/test_sharding.py pin down.

    Overlap realism: parameters touched at every bounce (env map, MERL
    table) finalize only at the END of the backward pass, so their psum
    can only overlap the loss-head epilogue; small scalars (fresnel)
    finalize earlier and overlap fully.  The mechanism costs nothing
    either way and removes the all-at-once reduction barrier.
    """
    return jax.tree.map(_id_allreduce, params)


def _apply_params(scene: Scene, params: TrainParams) -> Scene:
    scene = scene._replace(
        spheres=scene.spheres._replace(color=params.color, emission=params.emission)
    )
    if params.hdr is not None:
        scene = scene._replace(hdr=params.hdr)
    return scene


def sharded_opt_step(mesh: Mesh, settings: RenderSettings, optimizer,
                     seed: int = 0):
    """Like :func:`sharded_train_step` but with an optax optimizer.

    ``step(params, opt_state, scene, camera, target, frame) ->
    (params', opt_state', metrics)`` — gradients are psum-reduced over the
    mesh exactly as in the SGD step, then fed through
    ``optimizer.update``; the optimizer state (replicated, it is a pure
    function of replicated grads) threads through the jitted step so
    momentum/Adam moments live on device.  Initialise with
    ``optimizer.init(jax.device_get(params))`` and ``replicate``.
    """
    _check_divisible(settings, mesh)
    n_samp = mesh.shape[SAMPLE_AXIS]
    local_spp = max(settings.samples_per_pass // n_samp, 1)
    inv_n = 1.0 / (settings.n_pixels * 3)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(TILE_AXIS), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def _step(params, opt_state, scene, camera, target, frame):
        def loss_fn(p):
            p = allreduce_grads_in_bwd(p)
            cam = p.camera if p.camera is not None else camera
            rgb, _ = _shard_pass(
                _apply_params(scene, p), cam, frame,
                p.fresnel_coef, p.fresnel_pow, settings, seed, local_spp,
            )
            return jnp.sum((rgb - target) ** 2) * inv_n

        # Per-leaf psums ride in the BACKWARD program (allreduce_grads_in_bwd),
        # so grads arrive already reduced over both mesh axes.
        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = lax.psum(loss, TILE_AXIS)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        sq = [jnp.sum(g * g) for g in jax.tree.leaves(grads)]
        gnorm = jnp.sqrt(sum(sq[1:], sq[0]))
        return params, opt_state, {"loss": loss, "grad_global_norm": gnorm}

    return jax.jit(_step)


class DeferredParams(NamedTuple):
    """Table-valued scene parameters: environment map, diffuse texture and
    MERL table — the BASELINE config-4/5 gradient set (material table + env
    map), optimized with the scene geometry held fixed.

    Leaves are optional; None leaves are empty subtrees (no gradient).
    """

    hdr: Optional[jnp.ndarray] = None          # [H,W,3] environment map
    diffuse_map: Optional[jnp.ndarray] = None  # [H,W,3] linearised texture
    brdf: Optional[jnp.ndarray] = None         # [3, TABLE_SIZE] MERL table

    @classmethod
    def from_scene(cls, scene: Scene, hdr=True, diffuse_map=False,
                   brdf=False):
        return cls(
            hdr=scene.hdr if hdr else None,
            diffuse_map=scene.diffuse_map if diffuse_map else None,
            brdf=scene.brdf if brdf else None,
        )


def _apply_deferred(scene: Scene, p: DeferredParams) -> Scene:
    if p.hdr is not None:
        scene = scene._replace(hdr=p.hdr)
    if p.diffuse_map is not None:
        scene = scene._replace(diffuse_map=p.diffuse_map)
    if p.brdf is not None:
        scene = scene._replace(brdf=p.brdf)
    return scene


def sharded_deferred_opt_step(mesh: Mesh, settings: RenderSettings,
                              optimizer, scene: Optional[Scene] = None,
                              seed: int = 0):
    """Optimize :class:`DeferredParams` through the XLA wavefront.

    Pass ``scene`` so the step's settings take their ``has_*`` flags from
    the scene's assets (see :func:`sharded_render_step`).

    ``step(params, opt_state, scene, camera, target, frame, fresnel_coef,
    fresnel_pow) -> (params', opt_state', metrics)``; gradients are
    pmean/psum-reduced over the mesh exactly as in the other train steps.
    """
    if scene is not None:
        settings = settings_for_scene(scene, settings)
    _check_divisible(settings, mesh)
    n_samp = mesh.shape[SAMPLE_AXIS]
    local_spp = max(settings.samples_per_pass // n_samp, 1)
    inv_n = 1.0 / (settings.n_pixels * 3)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(TILE_AXIS), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def _step(params, opt_state, scene, camera, target, frame,
              fresnel_coef, fresnel_pow):
        def loss_fn(p):
            p = allreduce_grads_in_bwd(p)
            rgb, _ = _shard_pass(
                _apply_deferred(scene, p), camera, frame,
                fresnel_coef, fresnel_pow, settings, seed, local_spp,
            )
            return jnp.sum((rgb - target) ** 2) * inv_n

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = lax.psum(loss, TILE_AXIS)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        sq = [jnp.sum(g * g) for g in jax.tree.leaves(grads)]
        gnorm = jnp.sqrt(sum(sq[1:], sq[0])) if sq else jnp.float32(0.0)
        return params, opt_state, {"loss": loss, "grad_global_norm": gnorm}

    return jax.jit(_step)


def sharded_train_step(mesh: Mesh, settings: RenderSettings, seed: int = 0,
                       lr: float = 0.05, with_metrics: bool = False):
    """Build a jitted inverse-rendering SGD step sharded over ``mesh``.

    With ``with_metrics=True`` the step returns ``(params', metrics)``
    where metrics is a dict of replicated scalars (loss, gradient global
    norm, update norm) computed inside the jitted step (SURVEY §5.5).

    ``step(params, scene, camera, target, frame) -> (params', loss)``:
    renders with ``params`` grafted into ``scene``, L2 loss against the
    (pixel-sharded) ``target`` image, gradients ``psum``-reduced over both
    mesh axes (the gradient all-reduce overlaps the backward pass in XLA's
    schedule), followed by an SGD update computed redundantly per device.
    """
    _check_divisible(settings, mesh)
    n_samp = mesh.shape[SAMPLE_AXIS]
    local_spp = max(settings.samples_per_pass // n_samp, 1)
    inv_n = 1.0 / (settings.n_pixels * 3)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(TILE_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _step(params, scene, camera, target, frame):
        def loss_fn(p):
            # Under unchecked shard_map, psum transposes to psum, so the
            # pmean on the forward path hands each sample shard the FULL
            # cotangent: local grads are d(rgb_k)·g.  The gradient of the
            # sample-MEAN, tile-SUM loss is pmean over samples, psum over
            # tiles — planted per-leaf in the backward program here.
            p = allreduce_grads_in_bwd(p)
            cam = p.camera if p.camera is not None else camera
            rgb, _ = _shard_pass(
                _apply_params(scene, p), cam, frame,
                p.fresnel_coef, p.fresnel_pow, settings, seed, local_spp,
            )
            # Local mean-squared error over my pixel tile (already the
            # sample-axis pmean, so this value is replicated over samples).
            return jnp.sum((rgb - target) ** 2) * inv_n

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = lax.psum(loss, TILE_AXIS)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        if not with_metrics:
            return params, loss
        # Structured metrics straight from the jitted step (SURVEY §5.5):
        # everything here is already replicated across the mesh, so the
        # dict costs no extra collectives.
        sq = [jnp.sum(g * g) for g in jax.tree.leaves(grads)]
        gnorm = jnp.sqrt(sum(sq[1:], sq[0]))
        return params, {
            "loss": loss,
            "grad_global_norm": gnorm,
            "update_norm": lr * gnorm,
        }

    return jax.jit(_step)
