"""Native (C++) host-side plant integration, loaded through ctypes.

The reference integrates its plants with scipy's compiled LSODA
(simulation_class/model.py:61).  The counterpart here is a small C++
Dormand-Prince RK45 (``ode_rk45.cpp``, the same source as
``mcpilco_tpu/native``) with the pendulum, cart-pole and Furuta dynamics of
``envs/ode.py`` built in, compiled with ``g++`` at first use into
``mcpilco_tpu_torch/_build/`` (never beside the source) and bound with
ctypes: no pybind11, no build system beyond one compiler call.

:func:`load` raises when the build or the load fails; :func:`available`
only reports whether it succeeded.  This is host code: the plants the
trainers roll out stay the RK4 of ``envs/ode.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ode_rk45.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SYSTEM_IDS = {"pendulum": 0, "cartpole": 1, "furuta": 2}

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile ``SOURCE`` into the build directory unless that source is
    already built (the library is named by the source's hash); returns the
    library's path.  Raises ``RuntimeError`` with the compiler's output when
    ``g++`` fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libode_rk45_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: processes that build at once never
    # load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ on the path
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """Compile (if needed) and load the library.  Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        dbl, i32 = ctypes.c_double, ctypes.c_int
        lib.mcpilco_integrate.restype = i32
        lib.mcpilco_integrate.argtypes = [
            i32, ctypes.POINTER(dbl), i32, dbl, dbl, ctypes.POINTER(dbl), i32, dbl, dbl,
        ]
        _lib = lib
        return lib


def available() -> bool:
    """Whether :func:`load` succeeds."""
    try:
        load()
        return True
    except Exception:
        return False


def integrate(system: str, x0, t0: float, t1: float, u, rtol=1e-8, atol=1e-10) -> np.ndarray:
    """Integrate ``system`` over [t0, t1] with the zero-order-hold input
    ``u``; returns the final state as a new float64 array."""
    system_id = SYSTEM_IDS[system]
    lib = load()
    # the C function writes in place: own a fresh buffer, so that the
    # caller's array is never changed
    x = np.array(x0, np.float64, copy=True)
    uu = np.ascontiguousarray(np.asarray(u, np.float64).reshape(-1))
    ptr = ctypes.POINTER(ctypes.c_double)
    rc = lib.mcpilco_integrate(system_id, x.ctypes.data_as(ptr), x.size, float(t0), float(t1),
                               uu.ctypes.data_as(ptr), uu.size, float(rtol), float(atol))
    if rc != 0:
        raise RuntimeError(f"mcpilco_integrate failed with code {rc}")
    return x
