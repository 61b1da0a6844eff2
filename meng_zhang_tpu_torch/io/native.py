"""ctypes binding of the native LAMMPS data-file parser, `mzt_read_data` of
native/mzt_native.cpp (counterpart of meng_zhang_tpu/io/native.py).

The library is compiled from the repository's native/mzt_native.cpp with
g++ (the flags of native/Makefile) at first use, into
meng_zhang_tpu_torch/_build/native-<hash of source and flags>/libmzt.so,
never into native/. The compiler writes a temporary file that is then
renamed, so concurrent first uses never load a partial library. If the
library cannot be built or loaded, that is reported once on stderr and
`read_data_native` returns None, and io/lammps_data.read_data reads the
file in Python instead. Host parsing only: nothing here touches the device.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "mzt_native.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")


def build():
    """Path of libmzt.so built from SOURCE, compiling it unless this source
    and these flags have been built already. Raises OSError or
    subprocess.CalledProcessError on failure."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + src)
    out_dir = os.path.join(_PKG, "_build", f"native-{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, "libmzt.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    return lib


@functools.cache
def _load():
    """The bound library, or None (reported on stderr) if it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(build())
    except subprocess.CalledProcessError as e:
        print(f"meng_zhang_tpu_torch: native data reader not built "
              f"({' '.join(e.cmd[:1])} exit {e.returncode}): "
              f"{e.stderr.strip()[-2000:]}", file=sys.stderr)
        return None
    except OSError as e:
        print(f"meng_zhang_tpu_torch: native data reader unavailable: {e}",
              file=sys.stderr)
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.mzt_read_data.restype = ctypes.c_long
    lib.mzt_read_data.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(dp), ctypes.POINTER(ip),
        ctypes.POINTER(dp), ip, ctypes.POINTER(dp), ip, dp, dp, ip]
    lib.mzt_free.restype = None
    lib.mzt_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when the native reader is built and loaded (JAX :50)."""
    return _load() is not None


def read_data_native(path: str):
    """(x [N, 3], types [N] int32, v [N, 3] or None, masses [n_types] or
    None, box_lo [3], box_hi [3], n_types), the tuple of the JAX package's
    reader, or None if the library is unavailable or the parser failed."""
    lib = _load()
    if lib is None:
        return None
    xp = ctypes.POINTER(ctypes.c_double)()
    tp = ctypes.POINTER(ctypes.c_int)()
    vp = ctypes.POINTER(ctypes.c_double)()
    mp = ctypes.POINTER(ctypes.c_double)()
    has_v, has_m, ntypes = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lo, hi = (ctypes.c_double * 3)(), (ctypes.c_double * 3)()
    n = lib.mzt_read_data(os.fsencode(path), ctypes.byref(xp),
                          ctypes.byref(tp), ctypes.byref(vp),
                          ctypes.byref(has_v), ctypes.byref(mp),
                          ctypes.byref(has_m), lo, hi, ctypes.byref(ntypes))
    if n < 0:
        return None
    try:
        x = np.ctypeslib.as_array(xp, shape=(n, 3)).copy()
        types = np.ctypeslib.as_array(tp, shape=(n,)).astype(np.int32)
        v = (np.ctypeslib.as_array(vp, shape=(n, 3)).copy() if has_v.value
             else None)
        masses = (np.ctypeslib.as_array(mp, shape=(ntypes.value,)).copy()
                  if has_m.value and ntypes.value > 0 else None)
    finally:
        for p in (xp, tp, vp, mp):
            lib.mzt_free(p)
    return (x, types, v, masses, np.array(lo[:]), np.array(hi[:]),
            int(ntypes.value))
