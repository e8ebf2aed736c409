"""ctypes bindings for the native C++ runtime tier.

The reference's kernel tier is native C (SURVEY.md §2.1); here the
device-compute path is XLA, and the *host-side* runtime — problem
hashing, prime arithmetic, the wisdom store, and the deterministic
ESTIMATE-mode planner search — is C++ (``native/src/fftw3_tpu_native.cpp``),
loaded via ctypes.  Everything has a pure-Python fallback: ``available()``
reports whether the shared library could be found or built (g++ on PATH).

Python and C++ implement the identical planning policy, verified by
equality tests, so plans are deterministic across hosts regardless of which
tier serves them (the property FFTW-MPI enforces with wisdom votes,
``fftw/mpi/api.c:60-130``).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading
from typing import Dict, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "src", "fftw3_tpu_native.cpp")
_BUILD = os.path.join(_REPO, "native", "build")
_LIBNAME = "libfftw3_tpu_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_lib() -> Optional[str]:
    out = os.path.join(_BUILD, _LIBNAME)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    if os.environ.get("FFTW3_TPU_BUILD_NATIVE", "1") == "0":
        return out if os.path.exists(out) else None
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-fPIC", "-fvisibility=hidden",
             "-shared", "-o", out, _SRC],
            check=True, capture_output=True, timeout=120)
        return out
    except (OSError, subprocess.SubprocessError):
        return out if os.path.exists(out) else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.ftpu_md5_hex.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_char_p]
        lib.ftpu_is_prime.argtypes = [ctypes.c_uint64]
        lib.ftpu_is_prime.restype = ctypes.c_int
        lib.ftpu_largest_prime_factor.argtypes = [ctypes.c_uint64]
        lib.ftpu_largest_prime_factor.restype = ctypes.c_uint64
        lib.ftpu_power_mod.argtypes = [ctypes.c_uint64] * 3
        lib.ftpu_power_mod.restype = ctypes.c_uint64
        lib.ftpu_find_generator.argtypes = [ctypes.c_uint64]
        lib.ftpu_find_generator.restype = ctypes.c_uint64
        lib.ftpu_next_fast_size.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.ftpu_next_fast_size.restype = ctypes.c_uint64
        lib.ftpu_divisors.argtypes = [ctypes.c_uint64,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_int32]
        lib.ftpu_divisors.restype = ctypes.c_int32
        lib.ftpu_wisdom_new.restype = ctypes.c_void_p
        lib.ftpu_wisdom_free.argtypes = [ctypes.c_void_p]
        lib.ftpu_wisdom_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.c_double]
        lib.ftpu_wisdom_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double)]
        lib.ftpu_wisdom_get.restype = ctypes.c_int32
        lib.ftpu_wisdom_forget.argtypes = [ctypes.c_void_p]
        lib.ftpu_wisdom_size.argtypes = [ctypes.c_void_p]
        lib.ftpu_wisdom_size.restype = ctypes.c_int64
        lib.ftpu_wisdom_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int64]
        lib.ftpu_wisdom_export.restype = ctypes.c_int64
        hw_args = [ctypes.c_double] * 5
        lib.ftpu_plan_c2c.argtypes = [
            ctypes.c_int64, ctypes.c_int32, *hw_args, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
        lib.ftpu_plan_c2c.restype = ctypes.c_int64
        lib.ftpu_plan_kind.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, *hw_args,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64]
        lib.ftpu_plan_kind.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def md5_hex(data: bytes) -> str:
    lib = _load()
    if lib is None:
        import hashlib
        return hashlib.md5(data).hexdigest()
    out = ctypes.create_string_buffer(33)
    lib.ftpu_md5_hex(data, len(data), out)
    return out.value.decode()


def is_prime(n: int) -> bool:
    lib = _load()
    if lib is None:
        from .utils import primes
        return primes.is_prime(n)
    return bool(lib.ftpu_is_prime(n))


def largest_prime_factor(n: int) -> int:
    lib = _load()
    if lib is None:
        from .utils import primes
        return primes.largest_prime_factor(n)
    return int(lib.ftpu_largest_prime_factor(n))


def find_generator(p: int) -> int:
    lib = _load()
    if lib is None:
        from .utils import primes
        return primes.find_generator(p)
    return int(lib.ftpu_find_generator(p))


def next_fast_size(n: int, smooth: int = 5) -> int:
    lib = _load()
    if lib is None:
        from .utils import primes
        return primes.next_fast_size(n, smooth)
    return int(lib.ftpu_next_fast_size(n, smooth))


def divisors(n: int):
    lib = _load()
    if lib is None:
        from .utils import primes
        return primes.divisors(n)
    cap = 256
    while True:
        buf = (ctypes.c_uint64 * cap)()
        cnt = lib.ftpu_divisors(n, buf, cap)
        if cnt <= cap:
            return [int(buf[i]) for i in range(cnt)]
        cap = cnt


def _hw_args(hw):
    """The cost-model rates the C++ search reads (planner.HardwareModel)."""
    return (hw.hbm_bw, hw.matmul_flops, hw.elem_flops, float(hw.matmul_k),
            hw.gather_penalty)


def plan_c2c(n: int, patience: int, hw) -> Optional[Dict]:
    """Native ESTIMATE-mode c2c search; None if the library is unavailable.

    Mirrors Planner._candidates_c2c + _c2c_cost policy exactly (equality is
    unit-tested) — the deterministic cross-host planning path.
    """
    lib = _load()
    if lib is None:
        return None
    from . import planner as planner_mod
    cap = 1 << 14
    while True:
        buf = ctypes.create_string_buffer(cap)
        need = lib.ftpu_plan_c2c(
            n, patience, *_hw_args(hw), planner_mod.DIRECT_MAX,
            planner_mod.GENERIC_MAX, buf, cap)
        if need < 0:
            return None
        if need <= cap:
            return json.loads(buf.value.decode())
        cap = int(need)


def plan_kind(kind: str, n: int, patience: int, hw) -> Optional[Dict]:
    """Native ESTIMATE-mode search for ANY transform kind ("c2c", "r2c",
    "c2r", or an r2r kind name); None if the library is unavailable.
    Mirrors Planner._candidates + _cost exactly (equality unit-tested)."""
    lib = _load()
    if lib is None:
        return None
    from . import planner as planner_mod
    cap = 1 << 14
    while True:
        buf = ctypes.create_string_buffer(cap)
        need = lib.ftpu_plan_kind(
            kind.encode(), n, patience, *_hw_args(hw),
            planner_mod.DIRECT_MAX, planner_mod.GENERIC_MAX,
            planner_mod.R2R_GENERIC_MAX, buf, cap)
        if need < 0:
            return None
        if need <= cap:
            return json.loads(buf.value.decode())
        cap = int(need)


class NativeWisdomStore:
    """Thread-safe C++ wisdom hashtable (blessed-table analog) with the
    patience-subsumption insert rule.  dict-like view for the Planner."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.ftpu_wisdom_new()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.ftpu_wisdom_free(self._h)
            self._h = None

    def put(self, key: str, desc: Dict, patience: int, cost: float) -> None:
        self._lib.ftpu_wisdom_put(self._h, key.encode(),
                                  json.dumps(desc).encode(), patience, cost)

    def get(self, key: str, min_patience: int = 0) -> Optional[Dict]:
        cap = 1 << 12
        pat = ctypes.c_int32()
        cost = ctypes.c_double()
        while True:
            buf = ctypes.create_string_buffer(cap)
            r = self._lib.ftpu_wisdom_get(self._h, key.encode(), min_patience,
                                          buf, cap, ctypes.byref(pat),
                                          ctypes.byref(cost))
            if r == 0:
                return None
            if r == 1:
                return {"desc": json.loads(buf.value.decode()),
                        "patience": pat.value, "cost": cost.value}
            cap = -int(r)

    def __len__(self) -> int:
        return int(self._lib.ftpu_wisdom_size(self._h))

    def clear(self) -> None:
        self._lib.ftpu_wisdom_forget(self._h)

    def export_json(self) -> Dict:
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            need = self._lib.ftpu_wisdom_export(self._h, buf, cap)
            if need <= cap:
                return json.loads(buf.value.decode())
            cap = int(need)

    def import_entries(self, entries: Dict) -> None:
        for k, v in entries.items():
            self.put(k, v["desc"], int(v.get("patience", 0)),
                     float(v.get("cost", 0.0)))
