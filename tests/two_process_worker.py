"""Worker for the two-process distributed test (test_multiprocess.py).

Runs as a CPU-only subprocess (the parent sets ``JAX_PLATFORMS=cpu``): bootstraps
``jax.distributed`` via parallel.multihost.initialize, renders one sharded
Cornell pass over the 2-process x 4-device global mesh, and dumps the
full gathered frame + this process's local shard for the parent to verify.
"""

import pathlib
import sys

import numpy as np

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    coord_port, process_id, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    num_processes = int(sys.argv[4]) if len(sys.argv) > 4 else 2

    import jax.numpy as jnp

    from vrenderer_pathtracer.config import RenderSettings
    from vrenderer_pathtracer.core.camera import Camera
    from vrenderer_pathtracer.parallel import multihost
    from vrenderer_pathtracer.parallel.sharding import (
        TILE_AXIS, make_render_mesh, replicate, sharded_render_step)
    from vrenderer_pathtracer.scene.scene import Scene
    from jax.sharding import NamedSharding, PartitionSpec as P

    multihost.initialize(f"localhost:{coord_port}", num_processes=num_processes,
                         process_id=process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.local_device_count() == 8 // num_processes
    assert jax.device_count() == 8, jax.device_count()

    settings = RenderSettings(
        width=16, height=16, samples_per_pass=2, bounces=2,
        use_cornell_box=True, has_hdr=False,
    )
    mesh = make_render_mesh(n_tiles=8, n_samples=1)
    scene = replicate(mesh, Scene.analytic(settings))
    camera = replicate(mesh, Camera.default())
    sharding = NamedSharding(mesh, P(TILE_AXIS))
    accum = jax.make_array_from_callback(
        (settings.n_pixels, 3), sharding,
        lambda idx: np.zeros((settings.n_pixels // 8, 3), np.float32))

    render = sharded_render_step(mesh, settings)
    accum, img, depth = render(scene, camera, accum, jnp.uint32(1),
                               jnp.float32(0.1), jnp.float32(3.0))
    jax.block_until_ready(img)

    full = multihost.gather_image(img)
    local = multihost.local_shard(img)
    start, stop = multihost.local_tile_bounds(img)
    # Round-trip: the gathered frame's rows [start:stop] are my local shard.
    np.testing.assert_array_equal(full[start:stop], local)

    out = pathlib.Path(out_dir)
    np.save(out / f"full_{process_id}.npy", full)
    np.save(out / f"local_{process_id}.npy", local)
    (out / f"bounds_{process_id}.txt").write_text(f"{start} {stop}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
