"""Headline benchmark: Mrays/s, forward+backward, Cornell 1024², 4 bounces.

The reference publishes no numbers (BASELINE.md) — this establishes ours.
Rays are counted as pixels × spp × bounces for the forward pass, doubled for
forward+backward (one grad step w.r.t. material/fresnel params).  Prints ONE
JSON line naming the device it ran on; measures the GPU and fails without
one.  (The per-cell benchmark is ROADMAP S1.)
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def main():
    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera
    from vrenderer_pathtracer.parallel.sharding import (
        TrainParams, make_render_mesh, replicate, shard_pixels,
        sharded_render_step, sharded_train_step,
    )
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform}")
    enable_compile_cache()
    settings = RenderSettings(
        width=1024, height=1024, samples_per_pass=2, bounces=4,
        use_cornell_box=True, has_hdr=False,
    )
    mesh = make_render_mesh(n_tiles=len(jax.devices()), n_samples=1)
    scene = replicate(mesh, Scene.analytic(settings))
    camera = replicate(mesh, Camera.default())
    accum = shard_pixels(mesh, jnp.zeros((settings.n_pixels, 3), jnp.float32))

    render = sharded_render_step(mesh, settings, scene=scene)
    train = sharded_train_step(mesh, settings)
    params = replicate(mesh, TrainParams.from_scene(jax.device_get(scene)))

    fc, fp = jnp.float32(0.1), jnp.float32(3.0)

    # --- forward-only warmup + timing -------------------------------------
    accum, img, depth = render(scene, camera, accum, jnp.uint32(1), fc, fp)
    jax.block_until_ready(img)
    n_iters = 10
    t0 = time.perf_counter()
    for i in range(n_iters):
        accum, img, depth = render(scene, camera, accum, jnp.uint32(2 + i), fc, fp)
    jax.block_until_ready(img)
    fwd_s = (time.perf_counter() - t0) / n_iters

    # --- forward+backward (training step) ---------------------------------
    target = shard_pixels(mesh, jnp.zeros_like(img))
    params, loss = train(params, scene, camera, target, jnp.uint32(1))
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for i in range(n_iters):
        params, loss = train(params, scene, camera, target, jnp.uint32(2 + i))
    jax.block_until_ready(loss)
    fwdbwd_s = (time.perf_counter() - t0) / n_iters

    rays = settings.n_pixels * settings.samples_per_pass * settings.bounces
    record = {
        "metric": "mrays_per_s_fwdbwd_cornell1024_4bounce",
        "value": round(2 * rays / fwdbwd_s / 1e6, 3),
        "unit": "Mrays/s",
        "extra": {
            "mrays_per_s_forward": round(rays / fwd_s / 1e6, 3),
            "fwd_ms": round(fwd_s * 1e3, 3),
            "fwdbwd_ms": round(fwdbwd_s * 1e3, 3),
            "n_devices": len(jax.devices()),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "loss": float(loss),
            **_nm_wavefront_bench(),
            **_config5_bench(),
        },
    }
    print(json.dumps(record))


def _config5_bench() -> dict:
    """Config-5 AT SPEC steady-state pass (1920x1080, 2 spp, 4 bounces,
    ~500k-tri mesh, HDRI + MERL + FXAA) through the Renderer."""
    import tempfile

    from examples.config5 import synth_assets
    from vrenderer_pathtracer import Renderer, RenderSettings

    with tempfile.TemporaryDirectory() as tmp:
        obj, hdr, brdf = synth_assets(tmp)
        r = Renderer(1920, 1080, settings=RenderSettings(
            samples_per_pass=2, bounces=4, use_fxaa=True, use_brdf=True,
            remat_bounces=True))
        r.load_hdr(hdr)
        r.load_brdf(brdf)
        r.load_mesh(obj)
    r.render()
    jax.block_until_ready(r._accum)
    n_pass = 3
    t0 = time.perf_counter()
    for _ in range(n_pass):
        r.render()
    jax.block_until_ready(r._accum)
    dt = (time.perf_counter() - t0) / n_pass
    rays = 1920 * 1080 * 2 * 4
    return {
        "c5_spec_pass_ms": round(dt * 1e3, 1),
        "c5_spec_mrays_per_s": round(rays / dt / 1e6, 1),
    }


def _nm_wavefront_bench() -> dict:
    """The wavefront on the config-3 scene (28.8k-tri textured sphere)
    PLUS normal+specular maps."""
    import tempfile

    import numpy as np

    from tests.test_mesh_render import write_uv_sphere
    from vrenderer_pathtracer.accel.mesh import pack_mesh
    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import (
        Camera, generate_rays, pixel_ids)
    from vrenderer_pathtracer.native import load_obj
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import (
        Scene, settings_for_scene)
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "bench_sphere_nm.obj")
        write_uv_sphere(p, radius=12.0, n_theta=120, n_phi=120)
        mesh = pack_mesh(load_obj(p))
    rng = np.random.default_rng(0)
    hdr = jnp.asarray(rng.uniform(0, 1.5, (64, 128, 3)).astype(np.float32))
    tex = jnp.asarray(rng.uniform(0.1, 1, (256, 256, 3)).astype(np.float32))
    nmap = jnp.asarray((rng.uniform(0, 1, (256, 256, 3)) * 0.2
                        + (0.4, 0.4, 0.8)).astype(np.float32))
    smap = jnp.asarray(rng.uniform(0, 1, (256, 256, 3)).astype(np.float32))
    scene = Scene(spheres=build_sphere_set(False), mesh=mesh, hdr=hdr,
                  diffuse_map=tex, normal_map=nmap, specular_map=smap)
    settings = settings_for_scene(scene, RenderSettings(
        width=1024, height=1024, samples_per_pass=2, bounces=4,
        use_cornell_box=False))
    cams = [Camera.default()._replace(
        origin=jnp.asarray([1e-4 * i, 0.0, 40.0], jnp.float32))
        for i in range(11)]

    @jax.jit
    def run(scene, cam, frame):
        ro, rd = generate_rays(cam, settings.width, settings.height)
        ids = pixel_ids(settings.width, settings.height)
        return render_pass(scene, settings, ro, rd, ids,
                           jnp.uint32(frame), jnp.float32(0.1),
                           jnp.float32(3.0))

    jax.block_until_ready(run(scene, cams[-1], 1))
    t0 = time.perf_counter()
    outs = [run(scene, cams[i], 2 + i) for i in range(10)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / 10
    rays = settings.n_pixels * settings.samples_per_pass * settings.bounces
    return {
        "nm_wavefront_mrays_per_s": round(rays / dt / 1e6, 1),
        "nm_wavefront_pass_ms": round(dt * 1e3, 3),
    }


if __name__ == "__main__":
    main()
