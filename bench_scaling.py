"""Scaling-efficiency harness: rays/s vs device count (BASELINE north star).

The BASELINE target is "rays/s scaling efficiency 1 device -> 1 host ->
N>=2 hosts >= 85%" (BASELINE.json).  The harness has two modes:

* default (virtual sweep): spawn one subprocess per device count N in
  {1,2,4,8}, each a CPU-only JAX process (``JAX_PLATFORMS=cpu``, so no
  child opens an accelerator) with
  ``--xla_force_host_platform_device_count=N``, and run the SAME
  ``sharded_render_step`` / ``sharded_train_step`` used on real meshes.
  CAVEAT printed with the results: virtual CPU devices share one host's
  cores, so throughput-derived "efficiency" mostly measures sharding +
  collective overhead, not device scaling.  The identical entry point runs
  unchanged on real devices.
* ``--real``: run in-process on whatever ``jax.devices()`` provides
  (e.g. four GPUs), sweeping mesh sizes over prefixes of the device list.

Output: one JSON line per (mode, N) plus a summary efficiency table.

Reference counterpart: none — the reference is single-GPU
(``/root/reference/cuda/src/PathTracer.cu:887-891``); this is the
scaling axis from SURVEY §2's parallelism inventory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _worker(n: int, mode: str, train: bool, width: int, base_h: int,
            spp: int, bounces: int, iters: int, devices=None) -> dict:
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera
    from vrenderer_pathtracer.parallel.sharding import (
        TrainParams, make_render_mesh, replicate, shard_pixels,
        sharded_render_step, sharded_train_step,
    )
    from vrenderer_pathtracer.scene.scene import Scene

    devices = list(devices) if devices is not None else jax.devices()
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    height = base_h * n if mode == "weak" else base_h
    settings = RenderSettings(
        width=width, height=height, samples_per_pass=spp, bounces=bounces,
        use_cornell_box=True, has_hdr=False,
    )
    mesh = make_render_mesh(n_tiles=n, n_samples=1, devices=devices[:n])
    scene = replicate(mesh, Scene.analytic(settings))
    camera = replicate(mesh, Camera.default())
    accum = shard_pixels(mesh, jnp.zeros((settings.n_pixels, 3), jnp.float32))
    fc, fp = jnp.float32(0.1), jnp.float32(3.0)

    if train:
        step = sharded_train_step(mesh, settings)
        params = replicate(mesh, TrainParams.from_scene(jax.device_get(scene)))
        target = shard_pixels(
            mesh, jnp.zeros((settings.n_pixels, 3), jnp.float32))
        params, loss = step(params, scene, camera, target, jnp.uint32(1))
        jax.block_until_ready(loss)
        t0 = time.perf_counter()
        for i in range(iters):
            params, loss = step(params, scene, camera, target,
                                jnp.uint32(2 + i))
        jax.block_until_ready(loss)
        dt = (time.perf_counter() - t0) / iters
        ray_mult = 2  # fwd + bwd
    else:
        step = sharded_render_step(mesh, settings, scene=scene)
        accum, img, _ = step(scene, camera, accum, jnp.uint32(1), fc, fp)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        for i in range(iters):
            accum, img, _ = step(scene, camera, accum, jnp.uint32(2 + i),
                                 fc, fp)
        jax.block_until_ready(img)
        dt = (time.perf_counter() - t0) / iters
        ray_mult = 1

    rays = settings.n_pixels * spp * bounces * ray_mult
    return {
        "n_devices": n, "mode": mode, "train": train,
        "width": width, "height": height, "spp": spp, "bounces": bounces,
        "pass_ms": round(dt * 1e3, 3),
        "mrays_per_s": round(rays / dt / 1e6, 4),
        "platform": devices[0].platform,
    }


def _spawn(n: int, argv_tail: list[str]) -> dict:
    """Run one worker as a CPU-only process with N virtual devices (one
    process per card: these workers never open an accelerator)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--as-worker",
         "--devices", str(n)] + argv_tail,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=1800,
    )
    if out.returncode != 0:
        raise RuntimeError(f"worker n={n} failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--as-worker", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--base-h", type=int, default=None,
                    help="height (strong) / height per device (weak)")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--counts", type=str, default="1,2,4,8")
    ap.add_argument("--real", action="store_true",
                    help="run in-process on jax.devices() (real devices)")
    args = ap.parse_args()
    base_h = args.base_h or (256 if args.mode == "strong" else 64)

    if args.as_worker:
        rec = _worker(args.devices, args.mode, args.train, args.width,
                      base_h, args.spp, args.bounces, args.iters)
        print(json.dumps(rec))
        return

    counts = [int(c) for c in args.counts.split(",")]
    results = {}
    for mode in ("strong", "weak"):
        for train in (False, True):
            rows = []
            for n in counts:
                tail = ["--mode", mode, "--width", str(args.width),
                        "--base-h", str(base_h), "--spp", str(args.spp),
                        "--bounces", str(args.bounces),
                        "--iters", str(args.iters)]
                if train:
                    tail.append("--train")
                if args.real:
                    sys.argv = [sys.argv[0]]
                    rec = _worker(n, mode, train, args.width, base_h,
                                  args.spp, args.bounces, args.iters)
                else:
                    rec = _spawn(n, tail)
                rows.append(rec)
                print(json.dumps(rec), flush=True)
            t1 = rows[0]["pass_ms"]
            for r in rows:
                n, tn = r["n_devices"], r["pass_ms"]
                r["efficiency_pct"] = round(
                    100.0 * (t1 / (n * tn) if mode == "strong" else t1 / tn),
                    1)
            results[f"{mode}{'_train' if train else '_render'}"] = rows

    summary = {
        "metric": "scaling_efficiency",
        "unit": "%",
        "counts": counts,
        "virtual_cpu_sweep": not args.real,
        "caveat": (None if args.real else
                   "virtual CPU devices share one host's cores: this sweep "
                   "validates the harness and bounds sharding/collective "
                   "overhead; real efficiency requires real devices "
                   "(rerun with --real there)"),
        "tables": {
            k: [{kk: r[kk] for kk in
                 ("n_devices", "pass_ms", "mrays_per_s", "efficiency_pct")}
                for r in v]
            for k, v in results.items()
        },
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
