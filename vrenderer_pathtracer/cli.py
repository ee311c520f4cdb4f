"""Command-line frontend: render to PNG/EXR.

The replacement for the reference's Qt GUI (components #1-3 in
SURVEY §2: ``src/main.cpp``, ``src/mainwindow.cpp``, ``src/NGLScene.cpp``).
Every UI affordance maps to a flag: asset-load slots become ``--mesh /
--hdr / --brdf / --*-map``, toggle slots become ``--cornell /
--example-sphere / --use-brdf / --fxaa``, sliders become ``--fresnel-* /
--fxaa-*``, mouse camera control becomes ``--camera / --yaw / --pitch /
--fov``, and the progressive frame loop becomes ``--spp`` with optional
``--checkpoint-dir`` resume.

Example:
    python -m vrenderer_pathtracer render --cornell --width 512 \
        --height 512 --spp 64 --out cornell.png --depth-out depth.png
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=32, help="target samples per pixel")
    p.add_argument("--samples-per-pass", type=int, default=2,
                   help="samples per progressive pass (reference kSamps=2)")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    # scene toggles
    p.add_argument("--cornell", action="store_true", help="Cornell box mode")
    p.add_argument("--example-sphere", action="store_true")
    p.add_argument("--use-brdf", action="store_true",
                   help="shade mesh/example sphere with the loaded MERL BRDF")
    p.add_argument("--brdf-importance-sampling", action="store_true",
                   help="importance-sample the measured BRDF lobe (MIS with "
                        "cosine; lower variance on glossy tables)")
    # assets
    p.add_argument("--mesh", help="OBJ path")
    p.add_argument("--hdr", help="EXR lat-long environment map")
    p.add_argument("--brdf", help="MERL .binary path")
    p.add_argument("--diffuse-map", help="image path (linearised at load)")
    p.add_argument("--normal-map", help="image path")
    p.add_argument("--specular-map", help="image path")
    p.add_argument("--texture-gamma", type=float, default=2.2)
    # camera
    p.add_argument("--camera", type=float, nargs=3, metavar=("X", "Y", "Z"),
                   default=None, help="camera origin (default 0 0 150)")
    p.add_argument("--yaw", type=float, default=None, help="radians")
    p.add_argument("--pitch", type=float, default=None, help="radians")
    p.add_argument("--fov", type=float, default=None, help="degrees (default 75)")
    # materials
    p.add_argument("--fresnel-coef", type=float, default=0.1)
    p.add_argument("--fresnel-power", type=float, default=3.0)
    # post
    p.add_argument("--fxaa", action="store_true")
    p.add_argument("--fxaa-subpix", type=float, default=0.75)
    p.add_argument("--fxaa-edge-threshold", type=float, default=0.166)
    # outputs
    p.add_argument("--out", help="PNG output path")
    p.add_argument("--out-exr", help="EXR (linear accumulation) output path")
    p.add_argument("--depth-out", help="PNG depth-channel output path")
    # progressive / fault tolerance
    p.add_argument("--checkpoint-dir")
    p.add_argument("--metrics", help="JSONL metrics log path (per-pass ms, Mrays/s, checkpoint/resume events)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="passes between checkpoints (0 = off)")
    # execution
    p.add_argument("--cpu", action="store_true", help="force host CPU")
    p.add_argument("--tiles", type=int, default=0,
                   help="tile shards (0 = one per device)")
    p.add_argument("--sample-shards", type=int, default=1)
    p.add_argument("--quiet", action="store_true")


def _load_image(path):
    from vrenderer_pathtracer.io import load_image

    return load_image(path)


def cmd_render(args) -> int:
    import contextlib

    import jax

    ctx = (
        jax.default_device(jax.devices("cpu")[0])
        if args.cpu
        else contextlib.nullcontext()
    )
    with ctx:
        return _render_body(args)


def _build_renderer(args):
    """Renderer configured from the shared scene/camera/material flags."""
    from vrenderer_pathtracer import Renderer, RenderSettings

    settings = RenderSettings(
        samples_per_pass=args.samples_per_pass,
        bounces=args.bounces,
        use_cornell_box=args.cornell,
        use_example_sphere=args.example_sphere,
        use_fxaa=args.fxaa,
    )
    device_mesh = None
    if args.tiles or args.sample_shards > 1:
        import jax

        from vrenderer_pathtracer.parallel.sharding import make_render_mesh

        devices = jax.devices("cpu") if args.cpu else jax.devices()
        n_tiles = args.tiles or max(len(devices) // args.sample_shards, 1)
        device_mesh = make_render_mesh(
            n_tiles=n_tiles, n_samples=args.sample_shards,
            devices=devices[: n_tiles * args.sample_shards],
        )
    r = Renderer(args.width, args.height, settings=settings, seed=args.seed,
                 device_mesh=device_mesh)
    if args.hdr:
        r.load_hdr(args.hdr)
    if args.mesh:
        r.load_mesh(args.mesh)
    if args.brdf:
        r.load_brdf(args.brdf)
    if args.diffuse_map:
        r.load_texture(_load_image(args.diffuse_map), args.texture_gamma, 0)
    if args.normal_map:
        r.load_texture(_load_image(args.normal_map), args.texture_gamma, 1)
    if args.specular_map:
        r.load_texture(_load_image(args.specular_map), args.texture_gamma, 2)
    if args.use_brdf:
        r.use_brdf(True)
    if args.brdf_importance_sampling:
        r.settings = r.settings.replace(brdf_importance_sampling=True)
    r.set_fresnel_coef(args.fresnel_coef)
    r.set_fresnel_power(args.fresnel_power)
    r.set_fxaa_params(subpix_quality=args.fxaa_subpix,
                      edge_threshold=args.fxaa_edge_threshold)
    cam_kw = {}
    if args.camera is not None:
        cam_kw["origin"] = args.camera
    if args.yaw is not None:
        cam_kw["yaw"] = args.yaw
    if args.pitch is not None:
        cam_kw["pitch"] = args.pitch
    if args.fov is not None:
        cam_kw["fov_deg"] = args.fov
    if cam_kw:
        r.update_camera(**cam_kw)
    return r


def _render_body(args) -> int:
    import numpy as np

    from vrenderer_pathtracer.render.progressive import ProgressiveScheduler

    r = _build_renderer(args)
    t0 = time.perf_counter()

    def on_pass(i, spp):
        if not args.quiet:
            dt = time.perf_counter() - t0
            print(f"pass {i}: {spp} spp, {dt:.2f}s, "
                  f"{dt / max(i, 1) * 1e3:.1f} ms/pass", file=sys.stderr)

    sched = ProgressiveScheduler(
        r, target_spp=args.spp,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        on_pass=on_pass,
        metrics_path=args.metrics,
    )
    if args.checkpoint_dir and sched.resume_if_possible() and not args.quiet:
        print(f"resumed at {r.samples_per_pixel} spp", file=sys.stderr)
    img, depth = sched.run()

    from vrenderer_pathtracer.io import save_depth_png, save_png

    if args.out:
        save_png(args.out, img)
        if not args.quiet:
            print(f"wrote {args.out}", file=sys.stderr)
    if args.out_exr:
        from vrenderer_pathtracer.native import write_exr

        linear = np.asarray(r._accum, np.float32).reshape(
            args.height, args.width, 3) / max(r.frame - 1, 1)
        write_exr(args.out_exr, linear[::-1])
        if not args.quiet:
            print(f"wrote {args.out_exr}", file=sys.stderr)
    if args.depth_out:
        save_depth_png(args.depth_out, depth)
        if not args.quiet:
            print(f"wrote {args.depth_out}", file=sys.stderr)
    if not (args.out or args.out_exr or args.depth_out):
        print(f"rendered {r.samples_per_pixel} spp "
              f"(mean luminance {float(np.mean(img)):.4f}); "
              "no output path given (--out/--out-exr)", file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    """Live progressive viewer (the reference's interactive window role)."""
    import contextlib

    import jax

    ctx = (
        jax.default_device(jax.devices("cpu")[0])
        if args.cpu
        else contextlib.nullcontext()
    )
    with ctx:
        from vrenderer_pathtracer.view import TerminalViewer

        r = _build_renderer(args)
        viewer = TerminalViewer(r, max_cols=args.cols or 0,
                                max_rows=args.rows or 0)
        viewer.run(max_passes=args.passes or None,
                   interactive=None if not args.headless else False)
    return 0


def cmd_bench(args) -> int:
    del args
    import pathlib
    import sys as _sys

    _sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import bench  # repo-root benchmark, one JSON line

    bench.main()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vrenderer_pathtracer",
        description="differentiable path tracer (JAX)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("render", help="render a scene to PNG/EXR")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)
    pv = sub.add_parser(
        "view", help="live terminal viewer (arrows orbit, w/s dolly, "
        "enter toggles depth, q quits)")
    _add_render_args(pv)
    pv.add_argument("--cols", type=int, default=0, help="max display columns")
    pv.add_argument("--rows", type=int, default=0, help="max display rows")
    pv.add_argument("--passes", type=int, default=0,
                    help="stop after N passes (0 = until quit)")
    pv.add_argument("--headless", action="store_true",
                    help="no key input (for scripts/tests)")
    pv.set_defaults(fn=cmd_view)
    pb = sub.add_parser("bench", help="run the headline benchmark (one JSON line)")
    pb.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    return args.fn(args)


def run() -> int:
    """Console entry point: the CLI with the persistent compile cache."""
    from vrenderer_pathtracer.utils.cache import enable_compile_cache

    enable_compile_cache()
    return main()


if __name__ == "__main__":
    raise SystemExit(run())
