"""Runtime configuration: matmul precision, compile cache, profiling.

Matmul precision: every DFT, FIR and comb synthesis in this framework is a
float32 matmul, and XLA's GPU backend runs float32 matmuls at the
process-wide default precision.  'tensorfloat32' means one TF32 pass (10
mantissa bits) on Hopper tensor cores, which puts the 1000-point
DFT-as-matmul near 70 dB against the float64 oracle — below the >90 dB
parity bar a readout instrument needs (golden.snr_db, tests).  The
default is therefore 'float32' (full float32 products); set
GPU_SDR_MATMUL_PRECISION to any value `jax_default_matmul_precision`
accepts (e.g. a dot-algorithm preset such as 'BF16_BF16_F32_X3') to trade
precision for speed.  The SNR each setting reaches on the card is
recorded in PERF.md.
"""

from __future__ import annotations

import os

DEFAULT_PRECISION = "float32"

_applied = False
_precision = None


class maybe_profile:
    """Context manager: jax.profiler trace when GPU_SDR_PROFILE is set
    to a directory (the first-class tracing the reference lacked —
    SURVEY.md section 5)."""

    def __init__(self, tag: str = "run"):
        self.dir = os.environ.get("GPU_SDR_PROFILE")
        self.tag = tag
        self._cm = None

    def __enter__(self):
        if self.dir:
            import jax
            self._cm = jax.profiler.trace(os.path.join(self.dir, self.tag))
            self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            self._cm.__exit__(*exc)
        return False


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: $JAX_COMPILATION_CACHE_DIR
    when set, else a fixed `.jax_cache` directory at the checkout root (the
    path is part of the cache key, so it must not move between runs)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    When the environment variable is set JAX already honours it, so
    nothing is changed.  Returns the directory in use."""
    import jax
    d = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d


def configure_precision(precision: str | None = None, force: bool = False):
    """Set the global matmul precision and enable the persistent
    compilation cache (idempotent unless force=True).  An unknown
    precision name raises."""
    global _applied, _precision
    if _applied and not force:
        return
    import jax
    p = precision or os.environ.get("GPU_SDR_MATMUL_PRECISION",
                                    DEFAULT_PRECISION)
    jax.config.update("jax_default_matmul_precision", p)
    _precision = p
    enable_compile_cache()
    _applied = True


def matmul_precision() -> str:
    """The framework's resolved matmul precision (a value of
    `jax_default_matmul_precision`)."""
    return _precision or os.environ.get("GPU_SDR_MATMUL_PRECISION",
                                        DEFAULT_PRECISION)
