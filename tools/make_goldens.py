#!/usr/bin/env python
"""Render the committed golden images (the framework's own 2048-spp ground
truths, mirroring the course's shipped EXRs, ``Scene/README.md:19``).

Run on the GPU (minutes); outputs land in ``tests/goldens/`` and are committed
so CI can gate low-spp renders against them (``tests/test_golden.py``) without
touching an accelerator.  The committed files were rendered by earlier
versions of these engines on other hardware; they are physics references, and
any engine that converges to the same image passes their gates.  Small resolutions keep the repo light; the
estimator (NEE+MIS) and per-scene geometry are identical to what the tests
re-render.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDENS = [
    # (scene builder name, width, height, spp, max_depth, nee, mis, engine)
    ("cornell_box", 128, 128, 2048, 16, True, True, "mega"),
    ("veach_mis", 192, 128, 2048, 8, True, True, "mega"),
    ("quad_light_plane", 128, 128, 2048, 6, True, True, "mega"),
    # the reference's third workload class (large BVH, NEE from small
    # emitters) through the wavefront's BVH walk
    ("diningroom", 160, 90, 2048, 8, True, True, "wavefront"),
]


def main() -> int:
    import jax

    from mcpt import runtime, scenes
    from mcpt.io import image as im
    from mcpt.pallas import megakernel as mk
    from mcpt.render import camera as camera_mod
    from mcpt.render import integrator as integ
    from mcpt.scene import build_scene

    only = set(sys.argv[1:])  # optional scene-name filter: render only these
    unknown = only - {g[0] for g in GOLDENS}
    if unknown:
        # fail fast: a typo must not silently render nothing and exit 0
        # (that can make a stale golden look regenerated)
        sys.exit(f"unknown scenes: {sorted(unknown)}")

    runtime.enable_compile_cache()
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "goldens")
    os.makedirs(out_dir, exist_ok=True)

    for name, w, h, spp, depth, nee, mis, engine in GOLDENS:
        if only and name not in only:
            continue
        loaded, camcfg = getattr(scenes, name)()
        camcfg = dataclasses.replace(camcfg, resolution=(w, h))
        scene, lights = build_scene(loaded)
        cam = camera_mod.make_camera(camcfg)
        if engine == "wavefront":
            opts = integ.RenderOptions(max_depth=depth, nee=nee, mis=mis,
                                       method="bvh")

            def render_step(s0, n):
                return integ.render_batch(scene, lights, cam, w, h,
                                          jax.random.key(1000 + s0), opts,
                                          spp=n)
        else:
            mega = mk.build_megascene(scene, lights)

            def render_step(s0, n):
                rad, _ = mk.render_mega(
                    mega, cam, w, h, spp=n, seed=1000 + s0,
                    max_depth=depth, nee=nee, mis=mis,
                )
                return rad

        t0 = time.time()
        total = None
        step = 256 if engine == "mega" else 32
        for s0 in range(0, spp, step):
            rad = render_step(s0, min(step, spp - s0))
            total = rad if total is None else total + rad
        import numpy as np

        img = (np.asarray(total) / spp).reshape(h, w, 3)
        path = os.path.join(out_dir, f"{name}.exr")
        im.write_exr(path, img[::-1])
        print(f"{name}: {w}x{h} @ {spp} spp in {time.time()-t0:.1f}s "
              f"mean {img.mean():.4f} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
