#!/usr/bin/env python
"""Progressive render driver — the framework's main entry point.

Replaces the reference's GLUT window + frame loop (``main.cpp:21-23``,
``openglapp.cpp:40-63``, ``OpenCLApp.cpp:57-82``) for headless GPU hosts: the
"display" is a progressive PNG/HDR/EXR snapshot sink plus a live samples/sec +
Mrays/s line (the reference prints FPS in the window title,
``openglapp.cpp:52-56``).  Modes mirror ``main.cpp:11-25``: ``testbvh``/``testall``
dispatch to the BVH-metrics harness (``tools/bvh_bench.py``), otherwise render.

Usage:
    python tools/render.py [--config PATH] [--configid N] [--spp N] [--out DIR]
                           [--snapshot-every N] [--resume]

The config schema is the reference's ``config.json`` (``mcpt.config``).  When the
scene ``.obj`` is missing (the reference repo gitignores all geometry), an
``objname`` of the form ``procedural:<name>`` renders a built-in scene
(``mcpt.scenes``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


# Largest scene the auto engine gives the megakernel; larger scenes take the
# wavefront's BVH walk.  Measured on an H100 80GB HBM3 at a 700 W power limit
# (tools/engine_ab.py, boxfield(n) 640x360 depth 8 plain, megakernel vs
# wavefront Mrays/s): 1204 tris 681.5 vs 11.7, 3004 262.0 vs 8.6, 12004 75.1
# vs 6.2, 36004 26.6 vs 5.0, 108004 9.7 vs 3.4; diningroom (96216 tris,
# 1280x720 depth 8 NEE+MIS) 14.5 vs 14.4.  The megakernel's chunk loop is
# linear in the triangle count and the BVH walk is not, so the cut sits at
# the largest size measured; past it the engines were not compared.
MEGA_MAX_TRIS = 110_000


def pick_engine(engine: str, n_tris: int) -> str:
    """The engine ``tools/render.py`` runs: the config's ``engine``, with
    ``auto`` resolved by scene size."""
    if engine == "auto":
        return "mega" if n_tris <= MEGA_MAX_TRIS else "wavefront"
    if engine not in ("mega", "wavefront"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def build_from_config(cfg):
    from mcpt import scenes as procedural
    from mcpt.io.objloader import load_object
    from mcpt.scene import build_scene

    name = cfg.objname if isinstance(cfg.objname, str) else cfg.objnames[0]
    if name.startswith("procedural:"):
        builder = getattr(procedural, name.split(":", 1)[1])
        loaded, cam_default = builder()
        cam_cfg = cfg.camera or cam_default
    else:
        loaded = load_object(cfg.directory, name)
        cam_cfg = cfg.camera
        if cam_cfg is None:
            raise SystemExit("config has no camera block")
    scene, lights = build_scene(loaded, cfg.bvhtype)
    return scene, lights, cam_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--configid", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None, help="override 'attempt'")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write a progressive PNG every N samples")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save (sum, count) every N samples for --resume")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --out")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage timing report at exit (runtime.StageTimer"
                         " — the reference's profiling queue + timeCost, "
                         "oclbasic.cpp:117,232-247)")
    args = ap.parse_args(argv)

    from mcpt import runtime
    from mcpt.config import load_config

    cfg = load_config(args.config, args.configid)
    runtime.enable_compile_cache()

    if cfg.testall or cfg.testbvh:
        # mode dispatch parity with main.cpp:12-19
        from tools import bvh_bench

        return bvh_bench.run_from_config(cfg)

    import jax

    from mcpt.io import image as im
    from mcpt.render import camera as camera_mod
    from mcpt.render import integrator as integ
    from mcpt.types import Framebuffer, make_framebuffer

    scene, lights, cam_cfg = build_from_config(cfg)
    width = args.width or cfg.width or cam_cfg.resolution[0]
    height = args.height or cfg.height or cam_cfg.resolution[1]
    if cam_cfg.resolution != (width, height):
        import dataclasses

        cam_cfg = dataclasses.replace(cam_cfg, resolution=(width, height))
    spp = args.spp or cfg.attempt or 64
    cam = camera_mod.make_camera(cam_cfg)

    opts = integ.RenderOptions(
        max_depth=cfg.maxdepth or 16,
        nee=cfg.integrator.nee,
        mis=cfg.integrator.mis,
        russian_roulette=cfg.integrator.russian_roulette,
        rr_start_depth=cfg.integrator.rr_start_depth,
        method=cfg.intersector,
    )
    stem = cfg.output_stem or "render"
    stem = stem.replace("procedural:", "")
    os.makedirs(args.out, exist_ok=True)
    ckpt_path = os.path.join(args.out, f"{stem}.ckpt.npz")

    fb = make_framebuffer(width * height)
    start_s = 0
    if args.resume and os.path.exists(ckpt_path):
        import jax.numpy as jnp

        z = np.load(ckpt_path)
        fb = Framebuffer(sum=jnp.asarray(z["sum"]), count=jnp.asarray(z["count"]))
        start_s = int(z["done"])
        print(f"resumed at {start_s} spp from {ckpt_path}")

    d0 = jax.devices()[0]
    print(
        f"scene: {scene.n_tris} tris, {lights.count} light tris | "
        f"{width}x{height} @ {spp} spp, depth {opts.max_depth}, "
        f"nee={opts.nee} mis={opts.mis} rr={opts.russian_roulette} "
        f"intersector={opts.method} bvh={cfg.bvhtype} | devices: "
        f"{len(jax.devices())} x {d0.platform} {d0.device_kind}"
    )

    engine = pick_engine(cfg.engine, scene.n_tris)

    # multi-device: the config's ``mesh`` key ({"samples": s, "pixels": p})
    # routes both engines through their shard_map twins in mcpt.dist; the
    # reference is single-queue (oclbasic.cpp:14,117)
    mesh = None
    if cfg.mesh and len(jax.devices()) > 1:
        from mcpt import dist

        mesh = dist.make_mesh(
            samples=int(cfg.mesh.get("samples", 1)),
            pixels=int(cfg.mesh.get("pixels", 0)) or None,
        )
        print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} devices")
    elif cfg.mesh:
        print("config requests a device mesh but only one device is "
              "visible — rendering on one device")
    if engine == "mega":
        from mcpt.pallas import megakernel as mk

        mega = mk.build_megascene(scene, lights)

        if mesh is not None:
            from mcpt import dist

            def render_step(seed_step, step):
                return dist.render_mega_sharded(
                    mega, cam, width, height, spp=step, mesh=mesh,
                    seed=seed_step, max_depth=opts.max_depth,
                    nee=opts.nee, mis=opts.mis, rr=opts.russian_roulette,
                    clamp=cfg.integrator.clamp,
                )
        else:
            def render_step(seed_step, step):
                return mk.render_mega(
                    mega, cam, width, height, spp=step, seed=seed_step,
                    max_depth=opts.max_depth, rr=opts.russian_roulette,
                    rr_start=opts.rr_start_depth, nee=opts.nee, mis=opts.mis,
                    clamp=cfg.integrator.clamp,
                )
    else:
        if mesh is not None:
            from mcpt import dist

            def render_step(seed_step, step):
                return dist.render_batch_sharded(
                    scene, lights, cam, width, height,
                    jax.random.fold_in(jax.random.key(cfg.seed), seed_step),
                    opts, step, mesh, with_stats=True,
                )
        else:
            def render_step(seed_step, step):
                return integ.render_batch(
                    scene, lights, cam, width, height,
                    jax.random.fold_in(jax.random.key(cfg.seed), seed_step),
                    opts, spp=step, with_stats=True,
                )

    print(f"engine: {engine}")
    t0 = time.time()
    t_last, s_last = t0, start_s
    step_size = max(1, cfg.spp_per_step)
    if mesh is not None:
        # every sharded step renders a samples-axis multiple
        d_s = mesh.shape["samples"]
        step_size = max(d_s, (step_size // d_s) * d_s)
        if spp % d_s:
            spp = ((spp + d_s - 1) // d_s) * d_s
            print(f"spp rounded up to {spp} (samples axis = {d_s})")
    done = start_s
    timer = runtime.StageTimer() if args.profile else None
    # measured Mrays/s: both engines, on one device or sharded, count live
    # segments (closest-hit queries on live paths + NEE shadow rays) — the
    # number the reference shows as FPS (openglapp.cpp:52-56)
    segs_done, segs_last = 0.0, 0.0
    # interval triggers track the last fire (done advances in spp_per_step
    # strides, which may never land on an exact multiple of the interval)
    snap_last, ckpt_last = done, done
    while done < spp:
        step = min(step_size, spp - done)
        if timer is not None:
            with timer.stage("render_step"):
                radiance, segs = render_step(cfg.seed + done * 7919, step)
                timer.sync(radiance)
            with timer.stage("accumulate"):
                fb = integ.accumulate(fb, radiance, spp=step)
                timer.sync(fb.sum)
        else:
            radiance, segs = render_step(cfg.seed + done * 7919, step)
            fb = integ.accumulate(fb, radiance, spp=step)
        done += step
        segs_done += float(segs)  # forces the step (device scalar read)
        now = time.time()
        if now - t_last > 2.0 or done == spp:
            jax.block_until_ready(fb.sum)
            now = time.time()
            sps = (done - s_last) / max(now - t_last, 1e-9)
            rays = (segs_done - segs_last) / max(now - t_last, 1e-9)
            print(
                f"  {done}/{spp} spp | {sps:6.2f} spp/s | "
                f"{rays/1e6:8.2f} Mrays/s | {now - t0:6.1f}s elapsed",
                flush=True,
            )
            t_last, s_last = now, done
            segs_last = segs_done
        if (args.snapshot_every and done - snap_last >= args.snapshot_every
                and done < spp):
            snap_last = done
            img = integ.framebuffer_image(fb, width, height)
            im.write_png(
                os.path.join(args.out, f"{stem}.png"), im.tonemap_srgb(img[::-1])
            )
        if args.checkpoint_every and done - ckpt_last >= args.checkpoint_every:
            ckpt_last = done
            np.savez(
                ckpt_path, sum=np.asarray(fb.sum), count=np.asarray(fb.count),
                done=done,
            )

    img = integ.framebuffer_image(fb, width, height)

    def write_images():
        # .hdr like the reference (colorout.cpp:63-68) + png + exr
        im.write_hdr(os.path.join(args.out, f"{stem}.hdr"), img)
        im.write_png(os.path.join(args.out, f"{stem}.png"),
                     im.tonemap_srgb(img[::-1]))
        im.write_exr(os.path.join(args.out, f"{stem}.exr"), img[::-1])

    if timer is not None:
        with timer.stage("image_io"):
            write_images()
    else:
        write_images()
    print("Finished Attempting")  # parity with colorout.cpp:65
    print(f"wrote {stem}.hdr/.png/.exr in {args.out}")
    if timer is not None:
        print("\nprofile: CLI stage totals (first render_step includes "
              "compile)")
        print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
