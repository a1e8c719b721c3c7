#!/usr/bin/env python
"""Smoke test on the GPU: the renderer's main path, end to end, checked.

Runs ``tools/render.py`` (the user's entry point) in this process at the
reference presets' full sizes, with every kernel compiled for the card, and
checks each result against the repository's own oracles: the furnace identity,
the committed 2048-spp goldens (``tests/goldens``, with the rel-RMSE gates of
``tests/test_golden.py``), the BVH harness, and the card-only tests
(``pytest -m gpu``).  Each phase prints one line; any failure exits non-zero
and the result line is not printed.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

``--four`` runs only the four-card path instead: the sample-sharded megakernel
against one card (stream-exact up to f32 sum order), and config 9 (diningroom
1920×1080) on a samples=4 mesh through the CLI and through the sharded
wavefront, against one card.

    python chip_smoke.py [--four]

It needs a GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# (golden, width, height, depth, rel-RMSE gate at the gate's spp) — the
# gates of tests/test_golden.py; more samples only lower the error
GOLDEN_GATES = {
    "cornell_box": (128, 128, 16, 0.22),
    "veach_mis": (192, 128, 8, 0.30),
    "diningroom": (160, 90, 8, 0.35),
}


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def render_cli(out_dir, *args):
    """Run tools/render.py in this process; return (image as it is written,
    the CLI's stdout)."""
    from mcpt.io import image as im
    from tools import render

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = render.main(["--out", out_dir, *args])
    log = buf.getvalue()
    check(rc == 0, f"render.py {' '.join(args)} returned {rc}")
    check("engine:" in log, "render.py printed no engine line")
    engine = log.split("engine:")[1].split()[0]
    exrs = [f for f in os.listdir(out_dir) if f.endswith(".exr")]
    check(len(exrs) == 1, f"expected one .exr in {out_dir}, found {exrs}")
    img = im.read_exr_rgb(os.path.join(out_dir, exrs[0]))
    os.remove(os.path.join(out_dir, exrs[0]))
    return img, engine, log


def last_rate(log):
    lines = [ln for ln in log.splitlines() if "Mrays/s" in ln]
    return lines[-1].strip() if lines else "no rate line"


def golden_gate(tmp, name, configid, spp):
    """Render the golden's crop through the CLI and gate its rel-RMSE."""
    import numpy as np

    from mcpt.io import image as im
    from tools.compare import compare

    w, h, _depth, tol = GOLDEN_GATES[name]
    img, engine, _ = render_cli(tmp, "--configid", str(configid), "--width",
                                str(w), "--height", str(h), "--spp", str(spp))
    golden = im.read_exr_rgb(os.path.join(ROOT, "tests", "goldens",
                                          f"{name}.exr"))
    stats = compare(np.asarray(img, np.float64), golden.astype(np.float64))
    check(stats["rel_rmse"] < tol,
          f"{name} golden gate: rel-RMSE {stats['rel_rmse']:.4f} >= {tol}")
    return (f"golden {name} {w}x{h} {spp} spp ({engine}): rel-RMSE "
            f"{stats['rel_rmse']:.4f} < {tol}, mean {img.mean():.4f} vs "
            f"{golden.mean():.4f}")


def phase_furnace(tmp):
    import numpy as np

    img, engine, log = render_cli(tmp, "--configid", "1", "--spp", "8")
    h, w, _ = img.shape
    centre, corner = img[h // 2, w // 2], img[1, 1]
    check(np.all(np.abs(centre - 0.5) <= 1e-5),
          f"furnace centre {centre} != 0.5 ± 1e-5")
    check(np.all(np.abs(corner - 1.0) <= 1e-5),
          f"furnace background {corner} != 1.0 ± 1e-5")
    return (f"furnace {w}x{h} ({engine}): centre {centre[0]:.6f}, "
            f"background {corner[0]:.6f}")


def phase_cbox(tmp):
    import numpy as np

    img, engine, log = render_cli(tmp, "--configid", "0", "--spp", "64")
    check(img.shape == (512, 512, 3), f"cbox image shape {img.shape}")
    check(np.isfinite(img).all(), "cbox image has non-finite values")
    mean = float(img.mean())
    check(0.10 <= mean <= 0.16, f"cbox mean radiance {mean:.4f} not in "
                                "[0.10, 0.16]")
    gate = golden_gate(tmp, "cornell_box", 0, 256)
    return (f"cbox 512x512 d16 NEE+MIS+RR 64 spp ({engine}): mean "
            f"{mean:.4f}; {last_rate(log)} | {gate}")


def phase_veach(tmp):
    import numpy as np

    img, engine, log = render_cli(tmp, "--configid", "6", "--spp", "64")
    check(img.shape == (512, 768, 3), f"veach image shape {img.shape}")
    check(np.isfinite(img).all(), "veach image has non-finite values")
    gate = golden_gate(tmp, "veach_mis", 6, 256)
    return (f"veach_mis 768x512 d8 NEE+MIS 64 spp ({engine}): mean "
            f"{img.mean():.4f}; {last_rate(log)} | {gate}")


def phase_diningroom(tmp):
    import numpy as np

    img, engine, log = render_cli(tmp, "--configid", "8", "--spp", "8")
    check(img.shape == (720, 1280, 3), f"diningroom image shape {img.shape}")
    check(np.isfinite(img).all(), "diningroom image has non-finite values")
    check(img.mean() > 0.0, "diningroom image is black")
    gate = golden_gate(tmp, "diningroom", 8, 64)
    return (f"diningroom 1280x720 d8 NEE+MIS+RR 2x4 spp ({engine}): mean "
            f"{img.mean():.4f}; {last_rate(log)} | {gate}")


def phase_testbvh(tmp):
    from tools import render

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = render.main(["--out", tmp, "--configid", "4"])
    log = buf.getvalue()
    check(rc == 0, f"testbvh returned {rc}")
    vals = {}
    for key in ("SAH", "EPO", "LCV"):
        lines = [ln for ln in log.splitlines() if ln.strip().startswith(key)]
        check(lines, f"testbvh printed no {key} line")
        vals[key] = float(lines[0].split(":")[1].split()[0])
    check(vals["SAH"] > 1.0 and vals["EPO"] >= 0.0 and vals["LCV"] >= 0.0,
          f"testbvh metrics out of range: {vals}")
    return "testbvh cbox: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        vals.items())


def phase_gpu_tests(tmp):
    import pytest

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main([os.path.join(ROOT, "tests"), "-q", "-m", "gpu",
                          "-p", "no:cacheprovider", "-p", "no:randomly"])
    out = buf.getvalue().strip().splitlines()
    tail = out[-1:]
    errors = [ln for ln in out if ln.startswith(("E ", "ERROR", "FAILED"))]
    check(rc == 0, f"pytest -m gpu returned {rc}: {tail} {errors[:6]}")
    check("skipped" not in tail[0], f"card tests skipped: {tail}")
    return f"pytest -m gpu: {tail[0]}"


def _setup(name, width, height):
    from mcpt import scenes
    from mcpt.render import camera as camera_mod
    from mcpt.scene import build_scene

    loaded, camcfg = getattr(scenes, name)()
    scene, lights = build_scene(loaded)
    cam = camera_mod.make_camera(
        dataclasses.replace(camcfg, resolution=(width, height)))
    return scene, lights, cam


def phase_four_mega(tmp):
    """Sample-sharded megakernel ≡ one card, same seed (stream-exact; only
    the f32 order of the per-sample sums differs)."""
    import jax
    import numpy as np

    from mcpt import dist
    from mcpt.pallas import megakernel as mk

    scene, lights, cam = _setup("cornell_box", 512, 512)
    mega = mk.build_megascene(scene, lights)
    kw = dict(seed=11, max_depth=16, nee=True, mis=True, rr=True)
    mesh = dist.make_mesh(samples=4)
    rad4, segs4 = dist.render_mega_sharded(mega, cam, 512, 512, spp=16,
                                           mesh=mesh, **kw)
    with jax.default_device(jax.devices()[0]):
        rad1, segs1 = mk.render_mega(mega, cam, 512, 512, spp=16, **kw)
    rad4, rad1 = np.asarray(rad4), np.asarray(rad1)
    err = np.abs(rad4 - rad1).max() / max(np.abs(rad1).max(), 1e-30)
    check(np.allclose(rad4, rad1, rtol=1e-5, atol=1e-5 * np.abs(rad1).max()),
          f"sharded megakernel differs from one card: max rel err {err:.2e}")
    # segment counts are f32 sums past 2**24: exact only up to sum order
    check(abs(float(segs4) - float(segs1)) <= 1e-6 * float(segs1),
          f"segment counts differ: {float(segs4)} vs {float(segs1)}")
    return (f"megakernel samples=4 mesh vs one card, cbox 512x512 16 spp: "
            f"max |diff| / max {err:.2e} (rtol 1e-5), segments "
            f"{float(segs4):.0f} vs {float(segs1):.0f}")


def phase_four_config9(tmp):
    """Config 9 (diningroom 1920x1080) on the samples=4 mesh, through the
    CLI (its auto engine) and through the sharded wavefront, each against a
    one-card render in mean; the furnace identity holds exactly when
    sharded."""
    import jax
    import numpy as np

    from mcpt import dist
    from mcpt.render import integrator as integ

    img4, engine, log = render_cli(tmp, "--configid", "9", "--spp", "8")
    check("mesh: {'samples': 4" in log, "config 9 did not run on a "
                                        "samples=4 mesh")
    check(np.isfinite(img4).all(), "sharded image has non-finite values")
    scene, lights, cam = _setup("diningroom", 1920, 1080)
    opts = integ.RenderOptions(max_depth=8, nee=True, mis=True,
                               russian_roulette=True, method="bvh")
    mesh = dist.make_mesh(samples=4)
    rad_w4 = dist.render_batch_sharded(scene, lights, cam, 1920, 1080,
                                       jax.random.key(6), opts, spp=8,
                                       mesh=mesh)
    with jax.default_device(jax.devices()[0]):
        rad1 = integ.render_batch(scene, lights, cam, 1920, 1080,
                                  jax.random.key(5), opts, spp=8)
    m1 = float(np.asarray(rad1).mean()) / 8
    m_cli = float(img4.mean())
    m_w4 = float(np.asarray(rad_w4).mean()) / 8
    # 8 spp over 2 M pixels: the image mean's own noise is well under 1%;
    # 3% leaves room for the fireflies of glass and metal at 8 spp
    for label, m in (("CLI", m_cli), ("sharded wavefront", m_w4)):
        check(abs(m - m1) <= 0.03 * m1,
              f"{label} mean {m:.5f} vs one card {m1:.5f}")

    fscene, flights, fcam = _setup("furnace_sphere", 64, 64)
    rad = dist.render_batch_sharded(
        fscene, flights, fcam, 64, 64, jax.random.key(0),
        integ.RenderOptions(max_depth=8, method="bvh"), spp=4, mesh=mesh)
    img = np.asarray(rad).reshape(64, 64, 3) / 4
    check(np.all(np.abs(img[32, 32] - 0.5) <= 1e-5) and
          np.all(np.abs(img[1, 1] - 1.0) <= 1e-5),
          f"sharded furnace {img[32, 32]} / {img[1, 1]}")
    return (f"config 9 diningroom 1920x1080 8 spp on samples=4: CLI "
            f"({engine}) mean {m_cli:.5f}, sharded wavefront {m_w4:.5f}, "
            f"one-card wavefront {m1:.5f}; {last_rate(log)}; sharded "
            f"furnace exact")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    import jax

    from mcpt import runtime

    # phase 1: the device — there is no CPU fallback
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {backend!r})",
              file=sys.stderr)
        return 1
    devs = jax.devices()
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    print(runtime.gpu_name_and_power_limit(), flush=True)
    print(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}",
          flush=True)
    runtime.enable_compile_cache()

    if args.four:
        phases = [("four_mega", phase_four_mega),
                  ("four_config9", phase_four_config9)]
    else:
        phases = [("furnace", phase_furnace), ("cbox", phase_cbox),
                  ("veach", phase_veach), ("diningroom", phase_diningroom),
                  ("testbvh", phase_testbvh), ("gpu_tests", phase_gpu_tests)]
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                msg = fn(tmp)
                print(f"[ok]   {name} ({time.perf_counter() - t0:.1f} s): "
                      f"{msg}", flush=True)
            except Exception as e:  # noqa: BLE001 - report every phase
                failed.append(name)
                print(f"[FAIL] {name} ({time.perf_counter() - t0:.1f} s): "
                      f"{type(e).__name__}: {e}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
