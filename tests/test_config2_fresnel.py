"""Config-2 goldens: Fresnel specular + depth channel, non-default params.

BASELINE config 2 at CI scale: the Fresnel mix and depth normalization are
compared against the independent NumPy tracer with NON-default slider values
and a moved camera, so the parameter plumbing (not just the defaults) is
what's being validated.  Also checks the inverse-rendering loop end-to-end:
gradient descent on sphere emission recovers a brighter target.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tests import reference_tracer as ref
from tests.test_golden_cornell import _compare
from vrenderer_pathtracer import Renderer, RenderSettings


def test_fresnel_params_and_camera_match_reference():
    w = h = 16
    settings = RenderSettings(
        use_cornell_box=True, bounces=4, samples_per_pass=2, has_hdr=False
    )
    r = Renderer(w, h, settings=settings)
    r.set_fresnel_coef(0.35)
    r.set_fresnel_power(5.0)
    r.update_camera(origin=(5.0, -3.0, 140.0), yaw=0.05, pitch=-0.03)
    img, depth = r.render_frames(2)

    eimg, edepth = ref.render_image(
        w, h, spp_per_frame=2, frames=2, bounces=4, use_cornell=True,
        camera=dict(origin=(5.0, -3.0, 140.0), yaw=0.05, pitch=-0.03,
                    fov_deg=75.0),
        fresnel_coef=0.35, fresnel_pow=5.0,
    )
    _compare(img, depth, eimg, edepth)


def test_depth_channel_scale():
    """Depth = |origin-hit| / 150, 1.0 on miss-into-kill (reference parity:
    ``cuda/src/PathTracer.cu:656-661``)."""
    w = h = 8
    settings = RenderSettings(
        use_cornell_box=True, bounces=2, samples_per_pass=2, has_hdr=False
    )
    r = Renderer(w, h, settings=settings)
    _, depth = r.render()
    # Center pixel looks down -z from (0,0,150) to the back wall at z=-100:
    # depth ~ 250/150 = 1.667 (not clamped in the buffer; clamp is display).
    assert abs(float(depth[4, 4]) - 250.0 / 150.0) < 0.05


def test_inverse_rendering_recovers_emission():
    """SGD through the renderer pulls emission toward a brighter target."""
    from vrenderer_pathtracer.core.camera import generate_rays, pixel_ids
    from vrenderer_pathtracer.render.integrator import render_pass
    from vrenderer_pathtracer.scene.scene import Scene

    settings = RenderSettings(
        width=24, height=24, use_cornell_box=True, bounces=2,
        samples_per_pass=4, has_hdr=False,
    )
    scene = Scene.analytic(settings)
    from vrenderer_pathtracer.core.camera import Camera

    cam = Camera.default()
    ray_o, ray_d = generate_rays(cam, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)

    def render_with_emission(emission):
        s2 = scene._replace(spheres=scene.spheres._replace(emission=emission))
        rgb, _ = render_pass(
            s2, settings, ray_o, ray_d, ids, jnp.uint32(1),
            jnp.float32(0.1), jnp.float32(3.0),
        )
        return rgb

    target_emission = scene.spheres.emission.at[0].mul(1.6)  # brighter light
    target = render_with_emission(target_emission)

    import optax

    emission = scene.spheres.emission
    opt = optax.adam(0.1)
    opt_state = opt.init(emission)

    @jax.jit
    def step(e, s):
        def loss_fn(e):
            return jnp.mean((render_with_emission(e) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(e)
        updates, s = opt.update(g, s)
        return optax.apply_updates(e, updates), s, loss

    losses = []
    for _ in range(30):
        emission, opt_state, loss = step(emission, opt_state)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], losses
    # The light's emission moved toward the target.
    err0 = float(jnp.abs(scene.spheres.emission[0] - target_emission[0]).sum())
    err1 = float(jnp.abs(emission[0] - target_emission[0]).sum())
    assert err1 < 0.5 * err0
