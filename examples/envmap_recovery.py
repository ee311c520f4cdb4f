"""Environment-map recovery (table-parameter training).

Renders a target image of the two analytic spheres under a known HDRI, then
recovers the environment map from a flat initial guess with adam through
the differentiable wavefront (parallel/sharding.py
``sharded_deferred_opt_step``).

    python examples/envmap_recovery.py --steps 80 --out env.png
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--env", type=int, nargs=2, default=(16, 32),
                    metavar=("H", "W"))
    ap.add_argument("--out", default=None, help="recovered env map PNG")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import (
        Camera, generate_rays, pixel_ids)
    from vrenderer_pathtracer.parallel.sharding import (
        DeferredParams, make_render_mesh, replicate, shard_pixels,
        sharded_deferred_opt_step)
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene, settings_for_scene
    from vrenderer_pathtracer.scene.spheres import build_sphere_set

    rng = np.random.default_rng(0)
    eh, ew = args.env
    # A structured ground truth: smooth gradient + a bright "sun" disc.
    yy, xx = np.mgrid[0:eh, 0:ew].astype(np.float32)
    truth = np.stack([
        0.3 + 0.7 * yy / eh,
        0.2 + 0.5 * xx / ew,
        0.6 - 0.4 * yy / eh,
    ], axis=-1)
    # Place the sun in the part of the sky the default camera actually sees
    # (miss directions near -z map to u ~ 0/1 wrap, v ~ 0.5).
    cy, cx = eh // 2, ew // 8
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < (eh / 6) ** 2
    truth[mask] = (6.0, 5.5, 5.0)
    hdr_true = jnp.asarray(truth)

    settings = RenderSettings(
        width=args.size, height=args.size, samples_per_pass=args.spp,
        bounces=3, use_cornell_box=False, has_hdr=True)
    scene = Scene(spheres=build_sphere_set(False), hdr=hdr_true)
    settings = settings_for_scene(scene, settings)
    cam = Camera.default()
    mesh = make_render_mesh(n_tiles=len(jax.devices()), n_samples=1)

    ray_o, ray_d = generate_rays(cam, args.size, args.size)
    target_rgb, _ = render_pass(
        scene, settings, ray_o, ray_d,
        pixel_ids(args.size, args.size), jnp.uint32(1), jnp.float32(0.1),
        jnp.float32(3.0))
    target = shard_pixels(mesh, target_rgb)

    p = DeferredParams(hdr=jnp.full_like(hdr_true, 0.5))
    opt = optax.adam(args.lr)
    opt_state = jax.device_get(opt.init(jax.device_get(p)))
    step = sharded_deferred_opt_step(mesh, settings, opt, scene=scene)
    params = replicate(mesh, p)
    opt_state = replicate(mesh, opt_state)
    scene_r = replicate(mesh, scene)
    cam_r = replicate(mesh, cam)

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, metrics = step(
            params, opt_state, scene_r, cam_r, target, jnp.uint32(2 + i),
            jnp.float32(0.1), jnp.float32(3.0))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(metrics['loss']):.6f}  "
                  f"|g| {float(metrics['grad_global_norm']):.4f}")
    jax.block_until_ready(params)
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.1f} ms/step)")

    got = np.asarray(params.hdr)
    err = np.abs(got - np.asarray(hdr_true))
    # Texels are recovered in proportion to their visibility from the scene
    # (barely-visible ones only random-walk on sample noise), so report the
    # strongly-constrained region: the bright sun disc.
    sun0 = float(np.abs(0.5 - truth)[mask].mean())
    print(f"sun-disc mean |err|: {err[mask].mean():.3f} (init {sun0:.3f}); "
          f"final loss {float(metrics['loss']):.6f}")

    if args.out:
        from vrenderer_pathtracer.io import save_png

        disp = np.clip(got / max(truth.max(), 1e-6), 0, 1) ** (1 / 2.2)
        save_png(args.out, np.repeat(np.repeat(disp, 8, 0), 8, 1),
                 flip_y=False)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
