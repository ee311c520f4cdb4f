"""The Cornell box through the XLA wavefront vs the NumPy reference tracer.

The wavefront is the one integrator on every device; these cases pin its
Cornell estimator to tests/reference_tracer.py (which shares only the RNG
spec) across frames, Fresnel sliders, odd frame sizes, the depth channel
and the sharded step, under the golden-image outlier bounds
(tests/test_golden_cornell.py ``_compare``).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests import reference_tracer as ref
from tests.conftest import cpu_devices
from tests.test_golden_cornell import _compare
from vrenderer_pathtracer import Renderer, RenderSettings
from vrenderer_pathtracer.core.camera import Camera
from vrenderer_pathtracer.parallel.sharding import (
    make_render_mesh, replicate, shard_pixels, sharded_render_step)
from vrenderer_pathtracer.scene.scene import Scene

CORNELL = RenderSettings(use_cornell_box=True, has_hdr=False,
                         samples_per_pass=4, bounces=4)


# Frame sizes: the grazing-wall flip pixels (see test_golden_cornell.py)
# are a roughly fixed handful per image, so frames of ~2k pixels keep
# them well inside the outlier bounds.
@pytest.mark.parametrize("frames,spp,bounces", [(1, 4, 4), (3, 2, 3)])
def test_wavefront_matches_reference(frames, spp, bounces):
    size = 48 if frames == 1 else 40
    r = Renderer(size, size, settings=CORNELL.replace(
        samples_per_pass=spp, bounces=bounces))
    img, depth = r.render_frames(frames)
    eimg, edepth = ref.render_image(size, size, spp_per_frame=spp,
                                    frames=frames, bounces=bounces,
                                    use_cornell=True)
    _compare(img, depth, eimg, edepth)


def test_fresnel_sliders_match_reference():
    r = Renderer(40, 40, settings=CORNELL.replace(bounces=3))
    r.set_fresnel_coef(0.9)
    r.set_fresnel_power(1.0)
    img, depth = r.render_frames(1)
    eimg, edepth = ref.render_image(40, 40, spp_per_frame=4, frames=1,
                                    bounces=3, use_cornell=True,
                                    fresnel_coef=0.9, fresnel_pow=1.0)
    _compare(img, depth, eimg, edepth)


@pytest.mark.parametrize("size", [(56, 33), (41, 47)])
def test_odd_frame_size_matches_reference(size):
    w, h = size
    r = Renderer(w, h, settings=CORNELL.replace(bounces=2))
    img, depth = r.render_frames(2)
    eimg, edepth = ref.render_image(w, h, spp_per_frame=4, frames=2,
                                    bounces=2, use_cornell=True)
    _compare(img, depth, eimg, edepth)


def test_depth_channel_matches_reference():
    r = Renderer(24, 24, settings=CORNELL.replace(bounces=1,
                                                  samples_per_pass=1))
    _, depth = r.render_frames(1)
    _, edepth = ref.render_image(24, 24, spp_per_frame=1, frames=1,
                                 bounces=1, use_cornell=True)
    assert (np.abs(depth - edepth) > 1e-3).mean() <= 0.02
    assert np.asarray(depth).min() >= 0.0


def _sharded(settings, n_tiles, n_samples):
    mesh = make_render_mesh(n_tiles=n_tiles, n_samples=n_samples,
                            devices=cpu_devices()[:n_tiles * n_samples])
    step = sharded_render_step(mesh, settings)
    accum = shard_pixels(mesh, jnp.zeros((settings.n_pixels, 3), jnp.float32))
    accum, img, depth = step(
        replicate(mesh, Scene.analytic(settings)),
        replicate(mesh, Camera.default()), accum, jnp.uint32(1),
        jnp.float32(0.1), jnp.float32(3.0))
    return (np.asarray(img).reshape(settings.height, settings.width, 3),
            np.asarray(depth).reshape(settings.height, settings.width))


def test_sharded_wavefront_matches_reference():
    """Tiles x samples sharding keeps pixel and sample identity: the
    sharded image matches the reference like the plain one."""
    settings = CORNELL.replace(width=48, height=48, bounces=2)
    img, depth = _sharded(settings, 2, 2)
    eimg, edepth = ref.render_image(48, 48, spp_per_frame=4, frames=1,
                                    bounces=2, use_cornell=True)
    _compare(img, depth, eimg, edepth)


def test_sharded_odd_tile_size_matches_single_device():
    """Tiles that are no multiple of any block size (72x16 px over two
    tiles: 576 px each) are bitwise the single-device image."""
    settings = CORNELL.replace(width=72, height=16, samples_per_pass=2,
                               bounces=2)
    img2, depth2 = _sharded(settings, 2, 1)
    img1, depth1 = _sharded(settings, 1, 1)
    np.testing.assert_array_equal(img2, img1)
    np.testing.assert_array_equal(depth2, depth1)
