"""mcpt — a Monte Carlo path tracing framework in JAX/XLA/Pallas for the GPU.

Built from scratch with the capabilities of the reference OpenCL/C++ renderer
(SiodomeHuu/MonteCarloPathTracing):

- ``mcpt.config``   — config.json schema (reference ``config.cpp:70-125``)
- ``mcpt.types``    — SoA scene / BVH / ray-pool pytrees (reference ``objdef.h``)
- ``mcpt.io``       — obj/mtl loading, HDR/PNG/EXR image IO
- ``mcpt.scenes``   — procedural test scenes (cornell box et al.)
- ``mcpt.bvh``      — LBVH build, treelet SAH optimization, quality metrics
- ``mcpt.render``   — camera ray gen, BVH traversal, BSDF shading, integrator
- ``mcpt.pallas``   — the small-scene megakernel (Pallas, Triton route)
- ``mcpt.dist``     — device-mesh sharding of the render loop
"""

__version__ = "0.1.0"

from mcpt import config  # noqa: F401
from mcpt.bvh import lbvh  # noqa: F401
