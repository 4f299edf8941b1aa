"""gpuraytracer_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/Pallas framework with the capabilities of
Nishad-Sharma/gpuRaytracer (Swift + Metal), running on NVIDIA GPUs:

  * ``types``     SoA pytree scene (the ABI-struct layer, shaderTypes.h)
  * ``scene``     Cornell-box constructors (scene.swift)
  * ``sampling``  Halton/hash RNG, hemisphere/light/VNDF samplers + PDFs
  * ``intersect`` brute-force vectorized ray-scene queries (the BVH analog)
  * ``brdf``      metallic-roughness microfacet BRDF
  * ``render``    pure-jnp reference integrators (path / mis / direct)
  * ``ops``       Pallas kernels (Triton route) for the hot path
  * ``grad``      differentiable + inverse rendering
  * ``parallel``  mesh sharding, multi-host, collectives
  * ``image``     tonemap + PNG I/O
"""

from .types import (BoxLights, Camera, CompiledScene, RenderConfig, Scene,
                    SphereLights, Spheres, SquareLight, TriangleScene)
from .scene import cornell_box, cornell_box_with_spheres, legacy_cornell
from .intersect import closest_hit, any_hit, compile_scene
from .render import render, render_jit, RenderOutput
from .renderer import Renderer

__version__ = "0.1.0"
