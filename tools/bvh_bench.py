#!/usr/bin/env python
"""BVH construction-quality benchmark — the reference's testbvh/testall modes.

Mirrors ``BVH::TEST::test`` / ``testall`` (``bvhtest.cpp:448-530,613-649``,
dispatched from ``main.cpp:12-19``): for each configured scene, build the
configured BVH type, print triangle count, build times, SAH, EPO and (when a
camera is configured) LCV.

Usage:
    python tools/bvh_bench.py [--config PATH] [--configid N]
    python tools/bvh_bench.py --scene procedural:cornell_box --bvhtype treelet
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_model(loaded, bvhtype: str, camera_cfg, width: int, height: int):
    import jax

    from mcpt.bvh import lbvh, metrics
    from mcpt.render import camera as camera_mod

    verts = loaded.verts
    print(f"  triangles: {len(verts)}")

    t0 = time.time()
    dverts = jax.numpy.asarray(verts)
    bvh = lbvh.build_lbvh(dverts)
    jax.block_until_ready(bvh.bbmin)
    t_lbvh = time.time() - t0
    print(f"  LBVH build time: {t_lbvh*1e3:.2f} ms")

    if bvhtype == "treeletGPU":
        # the accelerator-side batched optimizer (reference GPU path,
        # treeletBVH.cl:230-531); prints its own build time
        from mcpt.bvh import treelet_device

        bvh = treelet_device.optimize_treelets_device(bvh, verbose=True)
    elif bvhtype in ("treelet", "treelet_opt"):
        from mcpt.bvh import treelet

        t0 = time.time()
        bvh = treelet.optimize_treelets(bvh)
        jax.block_until_ready(bvh.bbmin)
        print(f"  treelet optimize time: {(time.time()-t0)*1e3:.2f} ms")

    print(f"  SAH: {metrics.sah(bvh):.4f}")
    t0 = time.time()
    e = metrics.epo(bvh, verts)
    print(f"  EPO: {e:.4f}  ({time.time()-t0:.1f}s)")

    if camera_cfg is not None and camera_cfg.fov:
        cam = camera_mod.make_camera(camera_cfg)
        v = metrics.lcv(bvh, cam, width or 512, height or 512)
        print(f"  LCV: {v:.4f}")
    else:
        # testall entries carry no camera; reference skips LCV then
        # (bvhtest.cpp:604)
        print("  LCV: skipped (no camera in config)")


def _load(cfg, name: str):
    from mcpt import scenes as procedural
    from mcpt.io.objloader import load_object

    if name.startswith("procedural:"):
        loaded, cam_default = getattr(procedural, name.split(":", 1)[1])()
        return loaded, cfg.camera or cam_default
    return load_object(cfg.directory, name), cfg.camera


def run_from_config(cfg) -> int:
    for name in cfg.objnames:
        print(f"model: {name} (bvhtype={cfg.bvhtype})")
        try:
            loaded, cam = _load(cfg, name)
        except FileNotFoundError as e:
            print(f"  SKIPPED: {e}")
            continue
        bench_model(loaded, cfg.bvhtype, cam, cfg.width, cfg.height)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--configid", type=int, default=None)
    ap.add_argument("--scene", default=None,
                    help="render a single scene instead of using the config")
    ap.add_argument("--bvhtype", default="hlbvh")
    args = ap.parse_args(argv)

    from mcpt import runtime
    from mcpt.config import Config, load_config

    runtime.enable_compile_cache()

    if args.scene:
        cfg = Config(objname=args.scene, bvhtype=args.bvhtype, testbvh=True)
    else:
        cfg = load_config(args.config, args.configid)
    return run_from_config(cfg)


if __name__ == "__main__":
    sys.exit(main())
