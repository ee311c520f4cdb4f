"""BASELINE config 5: high-poly mesh + HDRI + MERL + FXAA at 1080p, with
gradients w.r.t. material and environment map.

The full pipeline on one device: a ~500k-triangle mesh (one single-level
SBVH in device memory), EXR environment light, measured BRDF shading, FXAA
display pass, progressive accumulation with checkpointing — then one
optimization step differentiating the render w.r.t. the MERL table and the
env map (bounce rematerialization keeps backward memory bounded).

Defaults are scaled down (960x540, 16 spp); pass --full for the
1920x1080 / 1024 spp headline shape.

    python examples/config5.py --out config5.png
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def synth_assets(tmp, n_theta=500):
    """Procedural stand-ins: dense UV sphere, gradient sky, Lambertian MERL."""
    from tests.test_mesh_render import write_uv_sphere
    from vrenderer_pathtracer.native import write_exr
    from vrenderer_pathtracer.ops.brdf import TABLE_SIZE

    obj = os.path.join(tmp, "mesh.obj")
    write_uv_sphere(obj, radius=12.0, n_theta=n_theta, n_phi=n_theta)

    hdr = os.path.join(tmp, "sky.exr")
    h, w = 128, 256
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.concatenate(
        [1.2 * (1 - v), 0.7 * np.ones((h, 1, 1), np.float32), 1.2 * v], axis=2
    )
    write_exr(hdr, np.broadcast_to(img, (h, w, 3)).copy())

    brdf = os.path.join(tmp, "lambert.binary")
    scales = np.array([1.0, 1.15, 1.66]) / 1500.0
    raw = (0.05 / scales)[:, None] * np.ones((3, TABLE_SIZE))
    with open(brdf, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        raw.reshape(-1).astype(np.float64).tofile(f)
    return obj, hdr, brdf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="1920x1080, 1024 spp (headline shape)")
    ap.add_argument("--mesh"), ap.add_argument("--hdr"), ap.add_argument("--brdf")
    ap.add_argument("--out", default="config5.png")
    ap.add_argument("--sort-rays", action="store_true",
                    help="Morton-sort bounce rays for packet coherence")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--spp-per-pass", type=int, default=2,
                    help="samples per progressive pass (reference parity: "
                         "2 per frame; larger batches amortize per-wave "
                         "costs at the price of checkpoint granularity)")
    ap.add_argument("--checkpoint-dir")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vrenderer_pathtracer import Renderer, RenderSettings
    from vrenderer_pathtracer.io import save_png
    from vrenderer_pathtracer.render.progressive import ProgressiveScheduler
    from vrenderer_pathtracer.utils.cache import enable_compile_cache

    enable_compile_cache()

    w, h, spp = (1920, 1080, 1024) if args.full else (960, 540, 16)
    if args.spp:
        spp = args.spp

    tmp = tempfile.mkdtemp()
    if not (args.mesh and args.hdr and args.brdf):
        print("synthesizing assets (dense sphere / sky / lambert MERL)...",
              file=sys.stderr)
        obj, hdr, brdf = synth_assets(tmp)
    if args.mesh:
        obj = args.mesh
    if args.hdr:
        hdr = args.hdr
    if args.brdf:
        brdf = args.brdf

    r = Renderer(w, h, settings=RenderSettings(
        samples_per_pass=args.spp_per_pass, bounces=4, use_fxaa=True,
        use_brdf=True, remat_bounces=True, sort_rays=args.sort_rays,
    ))
    t0 = time.perf_counter()
    r.load_hdr(hdr)
    r.load_brdf(brdf)
    r.load_mesh(obj)
    print(f"assets loaded+packed in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    sched = ProgressiveScheduler(
        r, target_spp=spp, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=64 if args.full else 0,
        on_pass=lambda i, s: print(
            f"pass {i}: {s} spp, {time.perf_counter()-t0:.1f}s",
            file=sys.stderr) if i % 2 == 0 else None,
    )
    img, depth = sched.run()
    save_png(args.out, img)
    print(f"wrote {args.out} ({w}x{h}, {r.samples_per_pixel} spp, "
          f"{time.perf_counter()-t0:.1f}s total)", file=sys.stderr)

    # --- gradient w.r.t. material (MERL table) and environment map --------
    from vrenderer_pathtracer.core.camera import generate_rays, pixel_ids
    from vrenderer_pathtracer.render.integrator import render_pass

    gset = r.settings.replace(use_fxaa=False)
    ray_o, ray_d = generate_rays(r.camera, w, h)
    ids = pixel_ids(w, h)
    target = jnp.asarray(np.clip(img.reshape(-1, 3) * 0.9, 0, 1))

    # The scene must be a jit ARGUMENT, not a closure: closed-over device
    # arrays embed as program constants (hundreds of MB for this mesh).
    @jax.jit
    def env_material_grads(scene, brdf_table, env):
        def loss_fn(bt, e):
            s2 = scene._replace(brdf=bt, hdr=e)
            rgb, _ = render_pass(
                s2, gset, ray_o, ray_d, ids, jnp.uint32(1),
                r.fresnel_coef, r.fresnel_pow,
            )
            return jnp.mean((rgb - target) ** 2)

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(brdf_table, env)

    t0 = time.perf_counter()
    loss, (g_brdf, g_env) = env_material_grads(r.scene, r.scene.brdf, r.scene.hdr)
    jax.block_until_ready((g_brdf, g_env))
    print(
        f"grad step: loss={float(loss):.5f}, |dL/dBRDF|={float(jnp.abs(g_brdf).sum()):.4g}, "
        f"|dL/denv|={float(jnp.abs(g_env).sum()):.4g} "
        f"({time.perf_counter()-t0:.1f}s incl. compile)", file=sys.stderr)
    assert np.isfinite(float(loss))


if __name__ == "__main__":
    main()
