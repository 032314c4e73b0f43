"""Device selection and the persistent XLA compilation cache.

The shells (cli, parallel cli, bench, chip_smoke.py) decode on the GPU
unless asked for another platform, and stop with a clear message when
there is none: a decoder that quietly carried on on the CPU would be
hundreds of times slower than its users expect.

Deep-scan pipeline compiles cost tens of seconds; every CLI invocation
re-pays them for identical graphs. JAX's persistent compilation cache keys
on (HLO, compile options, platform version), so an on-disk cache turns
those into sub-second loads. The reference has no analog (CUDA kernels are
AOT-compiled into the binary; its one runtime compile is the cuFFT plan,
/root/reference/src/analytic_fft.cu:23). The cache lives where
JAX_COMPILATION_CACHE_DIR says, else at a fixed path inside the checkout
(`.jax_cache/`, git-ignored). Opt out with MSK144_TPU_JAX_CACHE=0.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_PLATFORM = "cuda"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


class NoDeviceError(RuntimeError):
    """The requested JAX platform has no device on this host."""


def use_platform(platform: str | None = None) -> list:
    """Restrict JAX to `platform` (default: cuda) before its first use and
    return that platform's devices. Raises NoDeviceError when it has none —
    never falls back to another platform."""
    import jax

    name = platform or DEFAULT_PLATFORM
    jax.config.update("jax_platforms", name)
    try:
        devices = jax.devices()
    except Exception as e:  # RuntimeError, or an assert when no plugin
        why = str(e).splitlines()[0] if str(e) else type(e).__name__
        raise NoDeviceError(
            f"no {name} device found ({why}); pass --platform=cpu to "
            f"decode on the CPU") from None
    want = "gpu" if name in ("gpu", "cuda", "rocm") else name
    if devices[0].platform != want:
        raise NoDeviceError(
            f"asked for platform {name!r} but JAX runs on "
            f"{devices[0].platform!r}")
    return devices


def default_cache_dir() -> pathlib.Path:
    return _REPO_ROOT / ".jax_cache"


def enable_persistent_cache() -> str | None:
    """Enable the on-disk compilation cache (idempotent). Returns the cache
    dir, or None when disabled. Call before the first jit compilation."""
    if os.environ.get("MSK144_TPU_JAX_CACHE", "") == "0":
        return None

    import jax

    # JAX reads JAX_COMPILATION_CACHE_DIR itself; set no other directory
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir)
    try:
        if not path:
            path = str(default_cache_dir())
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        # cache every graph: the pipeline's many small helper jits add up
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except OSError:  # read-only checkout
        return None
    return path
