#!/usr/bin/env python
"""Engine A/B on the GPU: the Triton megakernel against the XLA wavefront.

Times both small-scene engines in one process, alternating them batch by
batch, on the cells ``bench.py`` uses (cbox 1024² depth 16 plain, veach_mis
768×512 depth 16 NEE+MIS), and the large-scene cut: megakernel against the
wavefront BVH walk on ``boxfield(n)`` at several sizes (the input of
``tools/render.py``'s auto engine choice).  Rates are live-segment Mrays/s
(closest-hit queries on live paths + NEE shadow rays), host clock around
work that ends in a device readback.  One extra traced batch per engine gives
the device idle share (1 − union of device-op intervals / traced window).

    python tools/engine_ab.py [--batches 5] [--cut 100,250,1000]
                              [--skip-small] [--diningroom]

Needs a GPU: it measures, so it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_idle_share(run) -> float:
    """Idle share of device 0 over one traced call of ``run()``: 1 − (union
    of the device planes' event intervals) / (first start → last end)."""
    import jax

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            run()
        path = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        data = jax.profiler.ProfileData.from_file(path)
        spans = []
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU:0"):
                continue
            for line in plane.lines:
                spans += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in line.events]
    if not spans:
        return float("nan")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return 1.0 - busy / max(window, 1.0)


def _scene(name, width, height, **kw):
    from mcpt import scenes
    from mcpt.render import camera as camera_mod
    from mcpt.scene import build_scene

    loaded, camcfg = getattr(scenes, name)(**kw)
    scene, lights = build_scene(loaded)
    cam = camera_mod.make_camera(
        dataclasses.replace(camcfg, resolution=(width, height)))
    return scene, lights, cam


def _engines(scene, lights, cam, width, height, depth, nee, spp_mega,
             spp_wave, method):
    """{name: (step(seed) -> segments, spp per batch)} for both engines."""
    import jax

    from mcpt.pallas import megakernel as mk
    from mcpt.render import integrator as integ

    mega = mk.build_megascene(scene, lights)
    opts = integ.RenderOptions(max_depth=depth, nee=nee, mis=nee,
                               method=method)

    def mega_step(seed):
        return float(mk.render_mega(mega, cam, width, height, spp=spp_mega,
                                    seed=seed, max_depth=depth, nee=nee,
                                    mis=nee)[1])

    def wave_step(seed):
        return float(integ.render_batch(
            scene, lights, cam, width, height, jax.random.key(seed), opts,
            spp=spp_wave, with_stats=True)[1])

    return {"megakernel": (mega_step, spp_mega),
            f"wavefront-{method}": (wave_step, spp_wave)}


def ab(label, engines, batches, trace=True):
    import jax

    dev = jax.devices()[0]
    rates = {k: [] for k in engines}
    for name, (step, spp) in engines.items():
        t0 = time.perf_counter()
        step(0)  # compile + warm
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30
        print(f"{label} {name}: spp/batch {spp}, warm-up (compile) "
              f"{time.perf_counter() - t0:.1f} s, process peak memory so "
              f"far {peak:.2f} GiB", flush=True)
    for i in range(batches):
        order = list(engines) if i % 2 == 0 else list(engines)[::-1]
        for name in order:
            step, spp = engines[name]
            t0 = time.perf_counter()
            segs = step(i + 1)
            dt = time.perf_counter() - t0
            rates[name].append(segs / dt / 1e6)
    for name, r in rates.items():
        q = statistics.quantiles(r, n=4) if len(r) >= 2 else [r[0]] * 3
        idle = (device_idle_share(lambda: engines[name][0](99))
                if trace else float("nan"))
        print(f"{label} {name}: median {statistics.median(r):.1f} Mrays/s, "
              f"quartiles {q[0]:.1f}..{q[2]:.1f}, min {min(r):.1f} max "
              f"{max(r):.1f} over {len(r)} batches; device idle share "
              f"{idle:.3f}; per batch {[round(x, 1) for x in r]}",
              flush=True)
    return {k: statistics.median(v) for k, v in rates.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--cut", default="100,250,1000",
                    help="boxfield(n) sizes for the engine cut (~12n tris)")
    ap.add_argument("--skip-small", action="store_true",
                    help="skip the cbox and veach_mis cells")
    ap.add_argument("--diningroom", action="store_true",
                    help="also compare the engines on diningroom 1280x720 "
                         "d8 NEE+MIS")
    args = ap.parse_args(argv)

    import jax

    from mcpt import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())} | "
          f"nvidia-smi: {runtime.gpu_name_and_power_limit()}", flush=True)

    if not args.skip_small:
        scene, lights, cam = _scene("cornell_box", 1024, 1024)
        ab("cbox 1024x1024 d16 plain",
           _engines(scene, lights, cam, 1024, 1024, 16, False, 64, 4,
                    "brute"), args.batches)
        scene, lights, cam = _scene("veach_mis", 768, 512)
        ab("veach_mis 768x512 d16 NEE+MIS",
           _engines(scene, lights, cam, 768, 512, 16, True, 32, 2, "brute"),
           args.batches)
    for n in (int(x) for x in args.cut.split(",") if x):
        scene, lights, cam = _scene("boxfield", 640, 360, n_boxes=n)
        ab(f"boxfield({n}) {scene.n_tris} tris 640x360 d8 plain",
           _engines(scene, lights, cam, 640, 360, 8, False, 16, 4, "bvh"),
           3, trace=False)
    if args.diningroom:
        scene, lights, cam = _scene("diningroom", 1280, 720)
        ab(f"diningroom {scene.n_tris} tris 1280x720 d8 NEE+MIS",
           _engines(scene, lights, cam, 1280, 720, 8, True, 4, 2, "bvh"),
           3, trace=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
