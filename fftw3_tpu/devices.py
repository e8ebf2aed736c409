"""The device table: the rates of every device the engine plans for.

One entry per ``jax.Device.device_kind``.  The planner's ESTIMATE cost
model (:class:`fftw3_tpu.planner.HardwareModel`), its C++ mirror and
``bench.py``'s bandwidth bound all read this table.  A device that is not
listed is an error, never a default: a cost model or a roofline built on
another device's numbers would be silently wrong.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class DeviceSpec:
    #: where the numbers come from
    source: str
    #: JAX platform name (``jax.Device.platform``); selects the default
    #: f32 matmul precision (``config.precision_name``)
    platform: str
    #: device-memory bandwidth, bytes/s
    hbm_bw: float
    #: device-memory capacity, bytes
    hbm_bytes: float
    #: f32 arithmetic outside the matrix units, flop/s
    f32_flops: float
    #: f32 matrix-product rate per ``jax.lax.Precision`` name, flop/s
    f32_matmul_flops: Dict[str, float]
    #: f64 arithmetic outside the matrix units, flop/s
    f64_flops: float
    #: f64 matrix-product rate, flop/s
    f64_matmul_flops: float
    #: contraction width below which a matrix product runs under its peak
    #: (the cost model's linear efficiency ramp; a modelling choice, not a
    #: data-sheet figure)
    matmul_k: int
    #: True when f64 is built from f32 operations by the compiler, which
    #: also slows XLA's own f64 FFT beyond its doubled bytes
    f64_emulated: bool
    #: True when the ``df32`` double-float solver's error-free transforms
    #: hold on this device (ops/df32.py), so the planner may offer it
    df32_exact: bool


DEVICES: Dict[str, DeviceSpec] = {
    # NVIDIA H200 Tensor Core GPU data sheet, SXM part, dense rates at the
    # 700 W power limit: 4.8 TB/s HBM3e, 141 GB, 67 TFLOP/s FP32,
    # 495 TFLOP/s TF32 tensor core, 34 TFLOP/s FP64, 67 TFLOP/s FP64
    # tensor core.  Precision.HIGH runs f32 products as TF32 on this card;
    # HIGHEST runs them in full f32.  df32 measured 2.4e-8 here, not the
    # 1e-10 double contract (PERF.md; the likely cause, not verified, is
    # FMA contraction of the Dekker split), so the planner does not offer
    # it.
    "NVIDIA H200": DeviceSpec(
        source="NVIDIA H200 Tensor Core GPU data sheet (SXM)",
        platform="gpu", hbm_bw=4.8e12, hbm_bytes=141e9, f32_flops=67e12,
        f32_matmul_flops={"high": 495e12, "highest": 67e12,
                          "default": 495e12},
        f64_flops=34e12, f64_matmul_flops=67e12, matmul_k=64,
        f64_emulated=False, df32_exact=False),
    # The test host.  A planning model, not a measurement: it keeps the
    # relative rates the engine's CPU-tested plans were pinned under (a
    # matrix unit 10x the elementwise rate and emulated f64), so the plans
    # the tests check do not depend on the host's real speed.
    "cpu": DeviceSpec(
        source="planning model for the CPU test host (not measured)",
        platform="cpu", hbm_bw=8.0e11, hbm_bytes=16e9, f32_flops=4.0e12,
        f32_matmul_flops={"high": 4.0e13, "highest": 4.0e13,
                          "default": 4.0e13},
        f64_flops=5.0e11, f64_matmul_flops=2.0e11, matmul_k=128,
        f64_emulated=True, df32_exact=True),
}


def lookup(device_kind: str) -> DeviceSpec:
    """The table entry for ``device_kind``; ValueError if it has none."""
    try:
        return DEVICES[device_kind]
    except KeyError:
        raise ValueError(
            f"device kind {device_kind!r} is not in the device table "
            f"(fftw3_tpu/devices.py; known: {sorted(DEVICES)})") from None


def current() -> DeviceSpec:
    """The table entry for the process's first JAX device."""
    import jax
    return lookup(jax.devices()[0].device_kind)
