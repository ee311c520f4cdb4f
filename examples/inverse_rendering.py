"""Inverse rendering demo: recover scene parameters from a target image.

The capability the reference renderer cannot offer (it is forward-only
CUDA/OpenCL): render a Cornell box with known materials, then start from
perturbed sphere albedos / emission / Fresnel parameters and recover them
by gradient descent on the pixel L2 loss — every step differentiates the
full path tracer (detached-hit convention for discrete events, ratio-trick
score gradients through the Fresnel branch; see README "Differentiable
end-to-end").

Runs on one device or a device mesh (tiles x samples `shard_map`); each SGD
step renders a fresh sample batch (frame id advances), so the optimizer
sees unbiased gradient estimates rather than one fixed noise realisation.

    python examples/inverse_rendering.py --steps 60 --out recovered.png
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
    ap.add_argument("--spp", type=int, default=4, help="samples per step")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--out", default=None, help="PNG of the recovered render")
    ap.add_argument("--metrics", default=None, help="JSONL metrics log")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera
    from vrenderer_pathtracer.parallel.sharding import (
        TrainParams, make_render_mesh, replicate, shard_pixels,
        sharded_opt_step, sharded_render_step,
    )
    from vrenderer_pathtracer.scene.scene import Scene
    from vrenderer_pathtracer.utils.metrics import MetricsLogger

    settings = RenderSettings(
        width=args.size, height=args.size, samples_per_pass=args.spp,
        bounces=4, use_cornell_box=True, has_hdr=False,
    )
    mesh = make_render_mesh(n_tiles=len(jax.devices()), n_samples=1)
    scene_true = replicate(mesh, Scene.analytic(settings))
    camera = replicate(mesh, Camera.default())
    render = sharded_render_step(mesh, settings, scene=scene_true)
    accum0 = shard_pixels(
        mesh, jnp.zeros((settings.n_pixels, 3), jnp.float32))

    # ---- ground-truth target: a converged render with the TRUE params ----
    # The loss compares RAW radiance (what the train step renders), so the
    # target is the linear accumulation mean — NOT the tonemapped display
    # image the renderer also returns.
    fc_true, fp_true = jnp.float32(0.1), jnp.float32(3.0)
    accum = accum0
    n_target = 8
    for i in range(n_target):
        accum, _, _ = render(
            scene_true, camera, accum, jnp.uint32(1 + i), fc_true, fp_true)
    target = accum / n_target  # already pixel-sharded

    # ---- perturbed start ----
    true_params = TrainParams.from_scene(jax.device_get(scene_true))
    rng = np.random.default_rng(0)

    def perturb(x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(
            np.clip(x + rng.uniform(-0.25, 0.25, x.shape), 0.0, None))

    params = true_params._replace(
        color=perturb(true_params.color),
        emission=perturb(true_params.emission),
        fresnel_coef=jnp.float32(0.4),
        fresnel_pow=jnp.float32(1.5),
    )
    params = replicate(mesh, params)

    import optax

    opt = optax.adam(args.lr)
    opt_state = replicate(mesh, jax.device_get(
        opt.init(jax.device_get(params))))
    step = sharded_opt_step(mesh, settings, opt)
    log = MetricsLogger(args.metrics) if args.metrics else None

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, metrics = step(
            params, opt_state, scene_true, camera, target,
            jnp.uint32(100 + i))
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_global_norm"])
            print(f"step {i:3d}  loss {loss:.6f}  |g| {gn:.4f}", file=sys.stderr)
            if log:
                log.log("train_step", step=i, loss=loss, grad_norm=gn)
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step)", file=sys.stderr)

    # Success metric: CONVERGED renders (fresh frames) with the recovered
    # vs the true parameters, both against the target.  Per-step losses on
    # single noisy passes are not comparable across parameter sets (MSE on
    # a noisy estimate rewards variance reduction); converged means are.
    # The recovered MSE can legitimately come out BELOW the true-params
    # one: E||R(p)-t||^2 = bias^2 + Var R(p), so L2 on noisy renders
    # trades a little bias for lower variance — raise --spp / target
    # passes to shrink the effect.
    # Individually unobservable parameters (the light sphere's albedo
    # under its own emission) may drift — the image defines what is
    # recoverable.
    from vrenderer_pathtracer.parallel.sharding import _apply_params

    got = jax.device_get(params)

    def converged_mse(p, fc, fp, frame0):
        sc = _apply_params(scene_true, replicate(mesh, p))
        rs = sharded_render_step(mesh, settings, scene=sc)
        acc = accum0
        for i in range(n_target):
            acc, _, _ = rs(sc, camera, acc, jnp.uint32(frame0 + i), fc, fp)
        return float(jnp.mean((acc / n_target - target) ** 2))

    rec_mse = converged_mse(got, got.fresnel_coef, got.fresnel_pow, 200)
    true_mse = converged_mse(true_params, fc_true, fp_true, 300)
    err_fc = float(np.abs(got.fresnel_coef - 0.1))
    print(f"converged-render MSE: recovered {rec_mse:.5f} vs true-params "
          f"{true_mse:.5f}; |fresnel_coef error| {err_fc:.4f}",
          file=sys.stderr)

    if args.out:
        from vrenderer_pathtracer.io import save_png
        from vrenderer_pathtracer.parallel.sharding import _apply_params

        accum = accum0
        # Render with the recovered parameters for a visual check.
        scene_rec = _apply_params(scene_true, params)
        rset = sharded_render_step(mesh, settings, scene=scene_rec)
        for i in range(8):
            accum, img, _ = rset(
                scene_rec, camera, accum, jnp.uint32(1 + i),
                got.fresnel_coef, got.fresnel_pow)
        save_png(args.out,
                 np.asarray(img).reshape(settings.height, settings.width, 3))
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
