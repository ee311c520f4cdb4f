"""Static render configuration.

The reference splits configuration across three tiers (compile-time backend
defines, compile-time kernel constants like ``kSamps=2`` / 4 bounces /
``kInvGamma=1/2.2`` at ``cuda/src/PathTracer.cu:38-42,624``, and runtime
``__constant__`` flags set via ``cudaMemcpyToSymbol`` at
``cuda/src/PathTracer.cu:894-1001``).  Here the same split is expressed the
XLA way: everything in :class:`RenderSettings` is a *static* (hashable) jit
argument — changing it recompiles, exactly like the reference re-uploading
constant symbols forces divergent kernel paths — while continuously-varying
quantities (camera, fresnel sliders) travel as traced arrays.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Hashable static settings for a jitted render step.

    Mirrors the reference's constant symbols / kernel constants:

    * ``width/height``     — framebuffer size (reference: GL texture size)
    * ``samples_per_pass`` — ``kSamps`` (reference default 2)
    * ``bounces``          — fixed bounce budget (reference: literal 4)
    * ``use_cornell_box``  — ``kUseCornellBox``
    * ``use_example_sphere`` — ``kUseExampleSphere``
    * ``use_brdf``         — ``kViewBRDF`` (shade mesh/example sphere with the
                              measured BRDF instead of diffuse)
    * ``has_*_map`` / ``has_brdf`` / ``has_mesh`` — ``kHas*`` / ``kMeshInitialised``
    * ``gamma``            — display gamma (reference ``kInvGamma = 1/2.2``)
    * ``depth_scale``      — depth normalisation (reference: ``dist/150`` at
                              ``cuda/src/PathTracer.cu:660``)
    """

    width: int = 512
    height: int = 512
    samples_per_pass: int = 2
    bounces: int = 4
    use_cornell_box: bool = False
    use_example_sphere: bool = False
    use_brdf: bool = False
    has_diffuse_map: bool = False
    has_normal_map: bool = False
    has_specular_map: bool = False
    has_brdf: bool = False
    has_mesh: bool = False
    has_hdr: bool = True
    use_fxaa: bool = False
    # Rematerialize each bounce in the backward pass (jax.checkpoint):
    # trades recompute FLOPs for per-bounce activation memory — needed for
    # high-res/high-spp gradient renders (config 5).
    remat_bounces: bool = False
    # Sort rays by (direction octant, origin Morton) before traversal to
    # restore coherence for bounce rays (accel/sorting.py).
    sort_rays: bool = False
    # Importance-sample measured BRDFs: one-sample MIS between a tabulated
    # half-angle lobe CDF and the cosine strategy (ops/brdf_sampling.py).
    # Same limit image as the reference's cosine estimator, lower variance
    # on glossy MERL tables.
    brdf_importance_sampling: bool = False
    # Compact bounce waves (opt-in): after the primary traversal, gather the
    # lanes that hit something into a dense array of capacity
    # compact_capacity_frac * B and run shading and the remaining bounces
    # at that width, scattering radiance / env contributions back.  A
    # lax.cond falls back to the full-width tail when the live count
    # exceeds capacity, so results are always exact.  Meant for views in
    # which few primary rays hit the mesh.
    compact_waves: bool = False
    compact_capacity_frac: float = 0.125
    # "cond": runtime lax.cond picks compact vs full per pass (always
    # exact).  "forced": the compact chain is hard-wired — set by the
    # Renderer once a pass has MEASURED that the camera's primary hit
    # count fits capacity (the hit set is constant across progressive
    # passes: same camera, fixed 0.25 sub-pixel jitter), reverted on any
    # camera/scene change.
    compact_mode: str = "cond"
    # Texture/env fetch mode: "nearest" is reference parity (integer texel
    # fetch); "bilinear" makes d(pixel)/d(texel) piecewise-linear and the
    # image smooth in uv/direction — use when optimizing textures/env maps.
    texture_filter: str = "nearest"
    gamma: float = 2.2
    depth_scale: float = 150.0
    # Number of rays traced per integrator call; the sample loop is chunked so
    # that one chunk is width*height*samples_per_chunk rays (memory control).
    samples_per_chunk: int = 0  # 0 => all samples in one chunk

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
