"""vrenderer_pathtracer — a differentiable path-tracing framework in JAX.

A from-scratch JAX / XLA / Pallas re-design with the capabilities of the
reference renderer ``v0q/vRenderer_PathTracer`` (C++/CUDA/OpenCL/Qt):

* analytic sphere scenes (Cornell box, mirror + Fresnel spheres, example sphere)
* triangle meshes with an SBVH acceleration structure (C++ builder; a Pallas
  Triton traversal kernel on GPUs, an XLA loop elsewhere)
* diffuse / normal / specular texture maps
* EXR HDRI environment lighting
* MERL-100 measured BRDFs
* progressive sample accumulation, depth channel, FXAA post-process

Unlike the reference it is differentiable end-to-end (pixels w.r.t. camera,
material, texture and environment-map parameters) and scales over device
meshes (several GPUs) via ``shard_map`` + ``psum`` ray/tile sharding.
"""

__version__ = "0.1.0"

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core.camera import Camera
from vrenderer_pathtracer.scene.scene import Scene
from vrenderer_pathtracer.render.renderer import Renderer

__all__ = ["RenderSettings", "Camera", "Scene", "Renderer", "__version__"]
