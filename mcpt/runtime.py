"""Runtime utilities: the device policy, compile cache, profiling, device info.

The slice of the reference's ``OpenCLBasic`` runtime layer (``oclbasic.{h,cpp}``)
that still has meaning under JAX: per-stage timing (the analogue of CL event
profiling, ``oclbasic.cpp:232-247`` ``timeCost``), a device-info dump
(``oclbasic.cpp:265-267``), a persistent compilation cache (JIT compiles are
the analogue of the reference's runtime ``clBuildProgram``,
``oclbasic.cpp:134-152``, and worth caching across processes) and throughput
accounting.  It is also the one place that decides whether a Pallas kernel is
compiled for the GPU or run by the Pallas interpreter (``pallas_interpret``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

# Used when JAX_COMPILATION_CACHE_DIR is not set: a fixed directory inside the
# checkout (listed in .gitignore), so every process of one checkout shares it.
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def pallas_interpret(interpret: bool) -> bool:
    """The ``interpret`` argument for every Pallas kernel of this package.

    Kernels are written for the GPU (Pallas's Triton route).  ``interpret=True``
    runs them in the Pallas interpreter on any backend; it is an explicit
    choice of the caller (tests, CPU rehearsals), never inferred from the
    backend.  Without it, a backend other than the GPU is an error: a compiled
    kernel must not quietly become an interpreted one.
    """
    if interpret:
        return True
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"Pallas kernels compile only for the GPU, and the backend is "
            f"{backend!r}; pass interpret=True to run them in the Pallas "
            "interpreter"
        )
    return False


def require_gpu() -> None:
    """Raise unless JAX's default backend is the GPU (measurement paths)."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU found: JAX's backend is {backend!r}")


def enable_compile_cache() -> str:
    """Persist XLA compilations across processes.

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads
    that variable itself, so nothing is overridden); otherwise a fixed
    directory inside the checkout.  Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def device_info() -> str:
    """Human-readable device summary (reference device-info dump analogue)."""
    import jax

    lines = [f"backend: {jax.default_backend()}"]
    for d in jax.devices():
        mem = getattr(d, "memory_stats", lambda: None)()
        memline = ""
        if mem:
            total = mem.get("bytes_limit", 0) / 2**30
            used = mem.get("bytes_in_use", 0) / 2**30
            memline = f", hbm {used:.2f}/{total:.2f} GiB"
        lines.append(
            f"  {d.device_kind} id={d.id} process={d.process_index}{memline}"
        )
    return "\n".join(lines)


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports it
    (a card set below its maximum power runs slower under load, so every
    recorded number carries this line); "not available" without nvidia-smi."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out[0].strip() if out else "not available"


class StageTimer:
    """Accumulating per-stage wall timer with forced device sync.

    The analogue of the reference's profiling-enabled queue + ``timeCost``:
    JAX dispatch is asynchronous, so each stage ends in
    ``block_until_ready`` before its clock stops.

        timer = StageTimer()
        with timer.stage("intersect"):
            out = f(x)
            timer.sync(out)
        print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    @staticmethod
    def sync(tree) -> None:
        """Wait until every array of ``tree`` is computed."""
        import jax

        jax.block_until_ready(jax.tree.leaves(tree))

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<{width}}  {total*1e3:9.2f} ms total  "
                f"{total/n*1e3:9.2f} ms/call  ×{n}"
            )
        return "\n".join(lines)


def mrays(segments: float, seconds: float) -> float:
    return segments / max(seconds, 1e-12) / 1e6
