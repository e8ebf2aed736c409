"""Global numeric configuration.

The ``direct`` and ``mixed`` solvers are f32 matrix products whose
precision XLA takes from ``jax.lax.Precision``.  On an NVIDIA GPU,
``HIGH`` runs them on the tensor cores in TF32 (a 10-bit mantissa, about
three decimal digits) and ``HIGHEST`` in full f32.  The Karatsuba complex
product (``ops/c2c.py`` ``cmatmul``) subtracts such products, so TF32's
rounding reaches the result.  Each platform's default is the cheaper
precision that held FFTW's single-precision contract (max rel err <= 1e-3,
``fftw/libbench2/bench-main.c:70``) with a 10x margin when measured on the
card (``_PLATFORM_PRECISION``).  f64 transforms ignore the f32 precision
enum.
"""
from __future__ import annotations

from typing import Optional

import jax

#: f32 matmul precision of the matrix-product solvers: None = the
#: platform's measured default (_PLATFORM_PRECISION), or one of 'highest'
#: | 'high' | 'default' to override it.
matmul_precision: Optional[str] = None

#: Measured on one NVIDIA H200 at 700 W, batch 65536 (PERF.md):
#: TF32 ("high") leaves ``direct`` n=128 at 4.3e-4 and ``mixed`` n=1024 at
#: 5.8e-4 relative error — inside 1e-3 but without the 10x margin — and
#: "highest" at 4.5e-7 / 3.5e-7, so the GPU computes in full f32.  The CPU
#: computes f32 products exactly at either setting.
_PLATFORM_PRECISION = {"gpu": "highest", "cpu": "high"}

#: Route plan-time host work (ESTIMATE search, hashing, wisdom) through the
#: native C++ tier when the shared library is available (fftw3_tpu/native.py)
use_native: bool = True

#: MEASURE-mode problem sizing: total points per timing array.  Large
#: enough that one call's device work dwarfs its launch cost; tests drop
#: it to keep CPU timing cheap.
measure_points: int = 1 << 23

#: FFTW_RANDOM_ESTIMATOR analog (fftw/fftw_api.c:15090-15104): an integer
#: seed makes the planner's cost estimator return deterministic
#: pseudo-random values, so repeated planning under different seeds walks
#: plans the calibrated estimator would never pick — the fuzzer's tool for
#: exercising every solver composition path.  None = off (real costs).
random_estimator = None

#: Disable the compensated-f32 double-float tier for complex128/f64 plans
#: (ops/df32.py): with ``strict_f64 = True`` every f64 plan computes in
#: true f64 arithmetic, ~1e-16 instead of ~1e-13.
strict_f64: bool = False

#: MEASURE hysteresis: a measured winner must satisfy
#: t_winner < measure_hysteresis * t_estimate_choice to override the
#: ESTIMATE ranking (fftw evaluates plans purely by time; this engine keeps
#: a 5% margin so run-to-run timing noise does not flip near-ties).  Set
#: 1.0 to always trust the measurement.
measure_hysteresis: float = 0.95

#: Surface best-effort failures instead of silently degrading.  When True,
#: paths that normally fall back (the threads-tier parallel executor, which
#: mirrors FFTW's silent serial fallback for loops with fewer iterations
#: than threads) re-raise their exception instead of returning the serial
#: plan.  Tests enable this so engine bugs cannot hide behind the fallback.
debug: bool = False


def precision_name(platform: Optional[str] = None) -> str:
    """The f32 matmul precision in force on ``platform`` (default: JAX's
    default backend): ``matmul_precision`` if set, else the platform's."""
    if matmul_precision is not None:
        return matmul_precision
    platform = platform or jax.default_backend()
    try:
        return _PLATFORM_PRECISION[platform]
    except KeyError:
        raise ValueError(f"no default matmul precision for platform "
                         f"{platform!r}; set config.matmul_precision") \
            from None


def precision():
    return {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH}.get(
        precision_name(), jax.lax.Precision.DEFAULT)
