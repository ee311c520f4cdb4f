"""Renderer façade — the JAX re-expression of the ``vRenderer`` API.

The reference's backend-neutral surface (``include/vRenderer.h:48-151``):
``init / registerTextureBuffer / render / cleanUp / updateCamera / initMesh /
loadHDR / loadTexture / useBRDF / useExampleSphere / useCornellBox /
clearBuffer / loadBRDF / getFrameCount / setFresnelCoef / setFresnelPower /
setCamera``.  GL-interop registration has no meaning here; its role (getting
pixels out) is served by returning device arrays / writing images.

Progressive accumulation state is exactly the reference's
(``float4`` accumulation buffer + frame counter, ``src/vRendererCuda.cpp:
100-105``): every scene mutation resets ``frame=1`` and zeroes the buffer.
That state triple (accum, frame, rng seed) is also the checkpoint payload —
see render/progressive.py.

All hot work happens in one jitted step; static flags live in
:class:`RenderSettings` so flag flips recompile (the reference's
constant-symbol semantics) while camera/fresnel edits do not.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer.ops.tonemap import tonemap
from vrenderer_pathtracer.render.integrator import render_pass
from vrenderer_pathtracer.scene.scene import MeshData, Scene, settings_for_scene
from vrenderer_pathtracer.scene.spheres import build_sphere_set

DIFFUSE, NORMAL, SPECULAR = 0, 1, 2  # texture types (reference vTextureType)


@functools.partial(jax.jit, static_argnames=("settings", "seed"))
def _render_step(scene, camera, accum, frame, fresnel_coef, fresnel_pow,
                 fxaa_params, settings, seed):
    ray_o, ray_d = generate_rays(camera, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)
    rgb, depth = render_pass(
        scene, settings, ray_o, ray_d, ids, frame, fresnel_coef, fresnel_pow,
        seed
    )
    accum = accum + rgb
    img = tonemap(accum, frame, settings.gamma)
    if settings.use_fxaa:
        from vrenderer_pathtracer.ops.fxaa import fxaa

        h, w = settings.height, settings.width
        subpix, edge_thr = fxaa_params
        img = fxaa(img.reshape(h, w, 3), subpix, edge_thr).reshape(-1, 3)
    return accum, img, depth


class Renderer:
    """Stateful progressive renderer with the reference API surface."""

    def __init__(self, width: int = 512, height: int = 512, *,
                 settings: Optional[RenderSettings] = None, seed: int = 0,
                 device_mesh=None):
        """``device_mesh`` — an optional ``jax.sharding.Mesh`` with axes
        ("tiles", "samples") (parallel.make_render_mesh): progressive passes
        then run through the shard_map step with the scene replicated and
        pixels tile-sharded.  None = single-device execution."""
        base = settings or RenderSettings()
        # Remember the user's request so every scene mutation re-resolves
        # it against the CURRENT scene.
        self._compact_request = base.compact_waves
        # The measured compact-mode switch tightens capacity per camera;
        # remember the requested fraction to restore on scene/camera edits.
        self._compact_frac_request = base.compact_capacity_frac
        self.settings = base.replace(width=width, height=height)
        self.scene = Scene(spheres=build_sphere_set(self.settings.use_cornell_box))
        self.camera = Camera.default()
        self.seed = seed
        self.device_mesh = device_mesh
        self._sharded_step = None
        self.fresnel_coef = jnp.float32(0.1)
        self.fresnel_pow = jnp.float32(3.0)
        # FXAA slider state (reference defaults, src/NGLScene.cpp:42-44).
        self.fxaa_subpix_quality = jnp.float32(0.75)
        self.fxaa_edge_threshold = jnp.float32(0.166)
        self.frame = 1
        self._accum = None
        self._sync_settings()  # flags for the initial scene
        self.clear_buffer()

    # -- state management ---------------------------------------------------

    def _maybe_force_compact(self, depth):
        """Measured static specialization of the compact-wave chain.

        The runtime lax.cond fallback copies its branch operands, but a
        camera's primary hit set is EXACTLY constant across progressive
        passes (same rays, fixed 0.25 sub-pixel jitter) — so after the
        first pass we count the hit pixels from the depth buffer and, if
        the hit lanes fit compact capacity, recompile once with the
        compact chain hard-wired
        (``compact_mode="forced"``).  Any camera/scene change clears the
        buffer, which reverts to the safe "cond" mode.
        """
        s = self.settings
        if (not s.compact_waves or s.compact_mode != "cond"
                or not s.has_mesh or s.use_example_sphere
                or s.use_cornell_box or s.bounces <= 1):
            return
        import numpy as _np
        hit_px = int((_np.asarray(depth) != 1.0).sum())
        # The integrator sizes capacity per CHUNK (render_pass batches
        # samples_per_chunk sample copies into the lane axis).
        chunk = min(s.samples_per_chunk or s.samples_per_pass,
                    s.samples_per_pass)
        n_lanes = s.n_pixels * chunk
        cap = -(-int(n_lanes * s.compact_capacity_frac) // 1024) * 1024
        if not 0 < cap < n_lanes:
            return
        if hit_px * chunk <= cap:
            # Tighten capacity to the measurement too: the compact tail's
            # fusions/gathers scale with cap.  Hits are exact per camera;
            # a 25% margin + 2048-lane slack is pure safety.
            tight = min(cap, -(-int(hit_px * chunk * 1.25) // 1024) * 1024
                        + 2048)
            self.settings = s.replace(
                compact_mode="forced",
                compact_capacity_frac=tight / n_lanes)
            self._sharded_step = None  # step must rebuild on new statics

    def clear_buffer(self):
        """frame=1 + zeroed accumulation (reference ``clearBuffer``)."""
        self.frame = 1
        if self.settings.compact_mode != "cond":
            self.settings = self.settings.replace(
                compact_mode="cond",
                compact_capacity_frac=self._compact_frac_request)
            self._sharded_step = None
        n = self.settings.n_pixels
        self._accum = jnp.zeros((n, 3), jnp.float32)
        self._last_depth = None  # persistent depth buffer (reference GL tex)
        if self.device_mesh is not None:
            from vrenderer_pathtracer.parallel.sharding import shard_pixels

            self._accum = shard_pixels(self.device_mesh, self._accum)
            self._sharded_step = None  # settings may have changed

    def _sync_settings(self):
        self.settings = settings_for_scene(
            self.scene,
            self.settings.replace(compact_waves=self._compact_request),
        )

    def _mutate(self, **scene_updates):
        if scene_updates:
            self.scene = self.scene._replace(**scene_updates)
        self._sync_settings()
        self.clear_buffer()

    # -- reference API ------------------------------------------------------

    def set_camera(self, camera: Camera):
        self.camera = camera.with_pitch_clamped()
        self.clear_buffer()

    def update_camera(self, *, origin=None, yaw=None, pitch=None, fov_deg=None):
        kw = {}
        if origin is not None:
            kw["origin"] = jnp.asarray(origin, jnp.float32)
        if yaw is not None:
            kw["yaw"] = jnp.float32(yaw)
        if pitch is not None:
            kw["pitch"] = jnp.float32(pitch)
        if fov_deg is not None:
            kw["fov_deg"] = jnp.float32(fov_deg)
        self.set_camera(self.camera._replace(**kw))

    def load_hdr(self, hdr):
        """Set the lat-long environment map: [H,W,3] float array or an EXR
        path (reference ``loadHDR``, ``src/NGLScene.cpp:368-401``)."""
        if isinstance(hdr, (str, bytes)) or hasattr(hdr, "__fspath__"):
            from vrenderer_pathtracer.native import load_exr

            hdr = load_exr(hdr)
        self._mutate(hdr=jnp.asarray(hdr, jnp.float32))

    def load_texture(self, image, gamma: float = 2.2, texture_type: int = DIFFUSE):
        """Set a surface map.  Diffuse maps are linearised with ``c**gamma``
        inverted — the reference applies ``pow(c, 1/gamma)``**(sic)** to
        diffuse texels at load (``src/NGLScene.cpp:403-424``) so display gamma
        re-applies it; we reproduce that contract."""
        img = jnp.asarray(image, jnp.float32)
        if texture_type == DIFFUSE:
            img = jnp.power(img, 1.0 / gamma)
            self._mutate(diffuse_map=img)
        elif texture_type == NORMAL:
            self._mutate(normal_map=img)
        elif texture_type == SPECULAR:
            self._mutate(specular_map=img)
        else:
            raise ValueError(f"unknown texture type {texture_type}")

    def load_brdf(self, table):
        """Set a MERL table: [3, 90*90*180] array or a .binary path
        (reference ``loadBRDF``, ``src/BRDFLoader.cpp:15-50``)."""
        if isinstance(table, (str, bytes)) or hasattr(table, "__fspath__"):
            from vrenderer_pathtracer.native import load_merl

            table = load_merl(table)
        self._mutate(brdf=jnp.asarray(table, jnp.float32))

    def init_mesh(self, mesh: MeshData):
        self._mutate(mesh=mesh)

    def load_mesh(self, path: str):
        """Load an OBJ/PLY, build the SBVH, upload (reference ``loadMesh``
        slot: ``src/NGLScene.cpp:345-366`` — Assimp import + SBVH + GPU
        pack; the dialog accepts obj/ply/fbx)."""
        from vrenderer_pathtracer.accel.mesh import pack_mesh
        from vrenderer_pathtracer.native import load_mesh_file

        self.init_mesh(pack_mesh(load_mesh_file(path)))

    def use_brdf(self, enable: bool):
        self.settings = self.settings.replace(use_brdf=enable)
        self._mutate()

    def use_example_sphere(self, enable: bool):
        self.settings = self.settings.replace(use_example_sphere=enable)
        self._mutate()

    def use_cornell_box(self, enable: bool):
        self.settings = self.settings.replace(use_cornell_box=enable)
        self.scene = self.scene._replace(spheres=build_sphere_set(enable))
        self._mutate()

    def toggle_fxaa(self, enable: bool):
        """Display-time toggle: does NOT clear accumulation (the reference
        only switches the display shader, ``src/NGLScene.cpp:266-310``)."""
        self.settings = self.settings.replace(use_fxaa=enable)

    def set_fxaa_params(self, *, subpix_quality=None, edge_threshold=None):
        if subpix_quality is not None:
            self.fxaa_subpix_quality = jnp.float32(subpix_quality)
        if edge_threshold is not None:
            self.fxaa_edge_threshold = jnp.float32(edge_threshold)

    def set_fresnel_coef(self, value: float):
        self.fresnel_coef = jnp.float32(value)
        self.clear_buffer()

    def set_fresnel_power(self, value: float):
        self.fresnel_pow = jnp.float32(value)
        self.clear_buffer()

    def get_frame_count(self) -> int:
        return self.frame

    @property
    def samples_per_pixel(self) -> int:
        """HUD 'spp' = frame * samples_per_pass (``src/NGLScene.cpp:331``)."""
        return (self.frame - 1) * self.settings.samples_per_pass

    # -- the frame loop -----------------------------------------------------

    def render(self, sync: bool = False):
        """One progressive pass; returns (image01 [H,W,3], depth [H,W]).

        ``sync=True`` blocks on the device and records wall-clock stats
        (the reference HUD's fps / ms / spp role, SURVEY §5.5) in
        ``self.last_stats``; the default stays async so progressive frames
        pipeline.
        """
        import time as _time

        t0 = _time.perf_counter() if sync else 0.0
        if self.device_mesh is not None:
            self._accum, img, depth = self._render_sharded()
        else:
            self._accum, img, depth = _render_step(
                self.scene,
                self.camera,
                self._accum,
                jnp.uint32(self.frame),
                self.fresnel_coef,
                self.fresnel_pow,
                (self.fxaa_subpix_quality, self.fxaa_edge_threshold),
                self.settings,
                self.seed,
            )
        self.frame += 1
        self._last_depth = depth
        if self.frame == 2:
            self._maybe_force_compact(depth)
        if sync:
            import time as _time

            import jax as _jax

            from vrenderer_pathtracer.utils.profiling import RenderStats

            _jax.block_until_ready(self._accum)
            s = self.settings
            self.last_stats = RenderStats(
                width=s.width, height=s.height,
                samples_per_pass=s.samples_per_pass, bounces=s.bounces,
                seconds_per_pass=_time.perf_counter() - t0,
            )
        h, w = self.settings.height, self.settings.width
        return img.reshape(h, w, 3), depth.reshape(h, w)

    def _render_sharded(self):
        """Progressive pass through the shard_map step (tiles x samples).

        FXAA needs cross-tile halos, so in sharded mode it applies to the
        gathered full image after the step (display-time, like the
        reference's screen pass) rather than inside it.
        """
        from vrenderer_pathtracer.parallel.sharding import (
            replicate, sharded_render_step)

        if self._sharded_step is None:
            self._sharded_step = sharded_render_step(
                self.device_mesh, self.settings.replace(use_fxaa=False),
                seed=self.seed,
            )
            self._scene_repl = replicate(self.device_mesh, self.scene)
        accum, img, depth = self._sharded_step(
            self._scene_repl,
            replicate(self.device_mesh, self.camera),
            self._accum,
            jnp.uint32(self.frame),
            self.fresnel_coef,
            self.fresnel_pow,
        )
        if self.settings.use_fxaa:
            from vrenderer_pathtracer.ops.fxaa import fxaa

            h, w = self.settings.height, self.settings.width
            img = fxaa(
                img.reshape(h, w, 3),
                self.fxaa_subpix_quality, self.fxaa_edge_threshold,
            ).reshape(-1, 3)
        return accum, img, depth

    def current_frame(self):
        """Display the EXISTING accumulation without advancing state.

        Returns (image01 [H,W,3], depth [H,W]) from the stored (accum,
        frame, depth) triple — what the reference shows between kernel
        launches.  Used when a restored checkpoint is already at the target
        sample count so displaying must not append another pass."""
        h, w = self.settings.height, self.settings.width
        frames_done = max(self.frame - 1, 1)
        img = tonemap(self._accum, frames_done, self.settings.gamma)
        if self.settings.use_fxaa:
            from vrenderer_pathtracer.ops.fxaa import fxaa

            img = fxaa(
                img.reshape(h, w, 3),
                self.fxaa_subpix_quality, self.fxaa_edge_threshold,
            ).reshape(-1, 3)
        depth = self._last_depth
        if depth is None:
            depth = jnp.ones((self.settings.n_pixels,), jnp.float32)
        return img.reshape(h, w, 3), depth.reshape(h, w)

    def hud_line(self) -> str:
        """fps / ms / spp / Mrays one-liner (reference ``src/NGLScene.cpp:
        324-342``); requires a prior ``render(sync=True)``."""
        stats = getattr(self, "last_stats", None)
        if stats is None:
            return "no synced frame yet - call render(sync=True)"
        return stats.hud_line(self.samples_per_pixel)

    def render_frames(self, n: int):
        """Run n progressive passes, return the final image (host numpy)."""
        img = depth = None
        for _ in range(n):
            img, depth = self.render()
        return np.asarray(img), np.asarray(depth)
