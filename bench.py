#!/usr/bin/env python
"""Headline benchmarks: path-tracing throughput on one GPU.

Four regimes (the reference's three workload shapes + the large-BVH stress
scene), one JSON line each, then a summary line that carries every regime:

1. ``veach_mis`` 768×512 depth 16 NEE+MIS (the reference veach workload
   shape, ``config.json:31-56``) — the megakernel's chunk-culled tier.
2. ``cbox`` 1024² depth 16, plain BSDF sampling — the megakernel's dense
   tier.
3. ``boxfield`` — 108k-triangle scene (the reference diningroom workload
   shape, ``config.json:58-84``), depth 8.
4. ``diningroom`` — procedural interior ~96k tris, 1280×720 depth-8 NEE+MIS
   (the reference's actual third workload).

Each regime runs the engine ``tools/render.py``'s auto choice gives its scene
(``pick_engine``), so the bench follows the CLI.
"Rays" counts *live* ray segments actually traced (closest-hit queries on
live paths + NEE shadow rays), measured by the engine itself, not the
W·H·depth upper bound.  Each regime reports the median and quartiles over
``n_batches`` timed batches; every batch ends in a device readback.  The first
batch (compilation included) is reported as set-up.  Every line names the
device it ran on.  The run needs a GPU, and a regime that fails fails the
run.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _device() -> dict:
    import jax

    from mcpt.runtime import gpu_name_and_power_limit

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": gpu_name_and_power_limit()}


def _setup(name, width, height, **kw):
    from mcpt import scenes
    from mcpt.render import camera as camera_mod
    from mcpt.scene import build_scene

    loaded, camcfg = getattr(scenes, name)(**kw)
    camcfg = dataclasses.replace(camcfg, resolution=(width, height))
    scene, lights = build_scene(loaded)
    return scene, lights, camera_mod.make_camera(camcfg)


def _time(step, metric: str, n_batches: int, **extra) -> dict:
    """Compile/warm with one batch, then time ``n_batches`` batches."""
    t0 = time.perf_counter()
    step(0)
    setup_s = time.perf_counter() - t0
    rates = []
    for i in range(n_batches):
        t0 = time.perf_counter()
        segs = step(i + 1)  # float(...) inside: the batch has completed
        rates.append(segs / (time.perf_counter() - t0) / 1e6)
    q = statistics.quantiles(rates, n=4)
    return {
        "metric": metric,
        "value": round(statistics.median(rates), 2),
        "unit": "Mrays/s",
        "q1": round(q[0], 2),
        "q3": round(q[2], 2),
        "n_batches": n_batches,
        "first_batch_s": round(setup_s, 2),
        **extra,
    }


def _bench(name, width, height, max_depth, nee, spp_mega, spp_wavefront,
           metric, n_batches=5, **kw):
    """One regime through the engine tools/render.py's auto choice picks."""
    import jax

    from mcpt.pallas import megakernel as mk
    from mcpt.render import integrator as integ
    from tools.render import pick_engine

    scene, lights, cam = _setup(name, width, height, **kw)
    engine = pick_engine("auto", scene.n_tris)
    if engine == "mega":
        mega = mk.build_megascene(scene, lights)
        spp = spp_mega

        def step(seed):
            return float(mk.render_mega(
                mega, cam, width, height, spp=spp, seed=seed,
                max_depth=max_depth, nee=nee, mis=nee)[1])
    else:
        opts = integ.RenderOptions(max_depth=max_depth, nee=nee, mis=nee)
        spp = spp_wavefront

        def step(seed):
            return float(integ.render_batch(
                scene, lights, cam, width, height, jax.random.key(seed), opts,
                spp=spp, with_stats=True)[1])

    return _time(step, metric, n_batches, engine=engine, spp_per_batch=spp)


# spp per batch: the megakernel's lanes are pixels (path regeneration), so
# its memory does not grow with spp and a large batch amortizes the block
# tails; the wavefront's pool is W·H·spp rays, so its batch is bounded by
# memory (diningroom 1280x720 at 2 spp peaks at 0.9 GiB on the card)
REGIMES = {
    "veach_mis": lambda: _bench(
        "veach_mis", 768, 512, 16, True, 32, 2,
        "veach_mis 768x512 depth-16 NEE+MIS throughput"),
    "cbox": lambda: _bench(
        "cornell_box", 1024, 1024, 16, False, 64, 4,
        "cbox 1024x1024 depth-16 path tracing throughput"),
    "boxfield": lambda: _bench(
        "boxfield", 1280, 720, 8, False, 8, 2,
        "boxfield 108k-tri 1280x720 depth-8 path tracing", n_boxes=9000),
    "diningroom": lambda: _bench(
        "diningroom", 1280, 720, 8, True, 8, 2,
        "diningroom 96k-tri 1280x720 depth-8 NEE+MIS path tracing"),
}


def main() -> int:
    from mcpt import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    device = _device()
    print(f"device: {json.dumps(device)}", flush=True)
    results = {}
    for name, fn in REGIMES.items():
        r = fn()
        r["device"] = device
        results[name] = r
        print(json.dumps(r), flush=True)
    vals = [r["value"] for r in results.values()]
    geomean = math.exp(sum(math.log(max(v, 1e-9)) for v in vals) / len(vals))
    summary = {
        "metric": "all-regime throughput (geomean of "
                  f"{'/'.join(results)} Mrays/s)",
        "value": round(geomean, 2),
        "unit": "Mrays/s",
        **{k: r["value"] for k, r in results.items()},
        "device": device,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
