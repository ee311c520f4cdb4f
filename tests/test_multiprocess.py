"""Two-process distributed execution: jax.distributed bootstrap + gather.

Round-1 gap: parallel/multihost.py was never exercised with more than one
process.  This test spawns two REAL processes (CPU-only jax, so no child
ever opens an accelerator), each owning 4 virtual CPU devices of an
8-device global mesh, renders one sharded Cornell pass, and checks:

* ``multihost.initialize`` brings up the coordination service
  (process_count == 2, global device_count == 8);
* ``gather_image`` (process_allgather) returns the identical full frame on
  both processes;
* ``local_shard`` / ``local_tile_bounds`` round-trip against the gathered
  frame (asserted inside the workers);
* the 2-process image equals a 1-process run of the SAME sharded program
  (8 local devices) bitwise — process topology never changes arithmetic;
* a differently-compiled plain (unsharded) render agrees up to the
  documented fp-association branch flips (cross-program comparisons are
  outlier-tolerant, never bitwise).
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_two_process_render_and_gather(tmp_path):
    port = _free_port()
    env = os.environ.copy()
    # CPU-only jax in the children: one process per card is the rule, so
    # these workers never open an accelerator.
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    worker = str(REPO / "tests" / "two_process_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"

    full0 = np.load(tmp_path / "full_0.npy")
    full1 = np.load(tmp_path / "full_1.npy")
    np.testing.assert_array_equal(full0, full1)

    # Disjoint tile ownership covering the whole frame.
    b0 = tuple(map(int, (tmp_path / "bounds_0.txt").read_text().split()))
    b1 = tuple(map(int, (tmp_path / "bounds_1.txt").read_text().split()))
    assert {b0, b1} == {(0, 128), (128, 256)}

    # Bitwise parity with a 1-process run of the SAME sharded program over
    # 8 local devices: process topology must not change arithmetic.
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    env1 = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run(
        [sys.executable, worker, str(_free_port()), "0", str(single_dir), "1"],
        env=env1, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300,
    )
    assert p.returncode == 0, f"1-process worker failed:\n{p.stdout.decode(errors='replace')}"
    np.testing.assert_array_equal(full0, np.load(single_dir / "full_0.npy"))

    # Cross-program sanity vs a plain unsharded render: differently-compiled
    # programs flip discrete branches on a few pixels (fp association), so
    # this comparison is outlier-tolerant by repo convention.
    import jax
    import jax.numpy as jnp

    with jax.default_device(jax.devices("cpu")[0]):
        from vrenderer_pathtracer.config import RenderSettings
        from vrenderer_pathtracer.core.camera import Camera, generate_rays, pixel_ids
        from vrenderer_pathtracer.ops.tonemap import tonemap
        from vrenderer_pathtracer.render.integrator import render_pass
        from vrenderer_pathtracer.scene.scene import Scene

        settings = RenderSettings(
            width=16, height=16, samples_per_pass=2, bounces=2,
            use_cornell_box=True, has_hdr=False,
        )
        cam = Camera.default()
        ray_o, ray_d = generate_rays(cam, 16, 16)
        ids = pixel_ids(16, 16)
        rgb, _ = render_pass(scene := Scene.analytic(settings), settings,
                             ray_o, ray_d, ids, jnp.uint32(1),
                             jnp.float32(0.1), jnp.float32(3.0))
        img_single = np.asarray(tonemap(rgb, 1, settings.gamma))
    agree = np.isclose(full0, img_single, atol=1e-5).mean()
    assert agree > 0.8, f"only {agree:.1%} of elements agree with plain render"
