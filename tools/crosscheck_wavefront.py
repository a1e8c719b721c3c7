#!/usr/bin/env python
"""Wavefront cross-check of the diningroom golden at 1024 spp.

Renders the golden's crop (``tests/goldens/diningroom.exr``, 2048 spp) through
the wavefront integrator (``mcpt.render.integrator.render`` with
``method="bvh"``, the XLA stack-walk intersector) and gates the rel-RMSE
against the golden at the measured-noise level.  The golden was rendered by a
different engine on other hardware, so agreement means two independent
implementations converge to the same image (reference analogue: comparing the
renderer's .hdr against the course-provided EXRs, ``Scene/README.md:19``).
Run it on the GPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "goldens")

# Noise model: 1024-spp wavefront ≈ 2.7%, 2048-spp golden ≈ 1.9%, combined
# ≈ 3.3% ⇒ gate 4.5% (×1.4 headroom).
NAME, W, H, SPP, DEPTH, TOL = "diningroom", 160, 90, 1024, 8, 0.045


def main() -> int:
    import numpy as np

    from mcpt import runtime, scenes
    from mcpt.io import image as im
    from mcpt.render import camera as camera_mod
    from mcpt.render import integrator as integ
    from mcpt.scene import build_scene
    from tools.compare import compare

    runtime.enable_compile_cache()

    golden = im.read_exr_rgb(os.path.join(_GOLDEN_DIR, f"{NAME}.exr"))[::-1]
    loaded, camcfg = getattr(scenes, NAME)()
    camcfg = dataclasses.replace(camcfg, resolution=(W, H))
    scene, lights = build_scene(loaded)
    cam = camera_mod.make_camera(camcfg)
    opts = integ.RenderOptions(max_depth=DEPTH, nee=True, mis=True,
                               method="bvh")

    t0 = time.time()
    fb = integ.render(scene, lights, cam, W, H, opts, spp=SPP, seed=7,
                      spp_per_step=64)
    img = np.asarray(integ.framebuffer_image(fb, W, H), np.float64)
    dt = time.time() - t0

    stats = compare(img, golden.astype(np.float64))
    ok = stats["rel_rmse"] < TOL
    print(
        f"{NAME:12s} {W}x{H} spp={SPP} depth={DEPTH} wavefront(method=bvh) "
        f"rel_rmse={stats['rel_rmse']:.4f} (gate {TOL}) "
        f"mean={img.mean():.4f} golden_mean={golden.mean():.4f} "
        f"{dt:6.1f}s {'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
