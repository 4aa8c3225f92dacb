"""ctypes bindings of the port's native (C++) host components.

Port of deepflame_tpu/native.py: the FlaRe table parser
(`csrc/flare_table.cpp`) and the partition planners (`csrc/partition.cpp`),
the port's own copies of the sources. At first use
`build()` compiles it with g++ into a shared library under
`<repo>/build/native/`, named by a hash of the sources and flags (an edited
source is rebuilt), as
`ops.kernels` builds the CUDA kernels. Nothing here falls back to Python: a
failed build raises, and the callers that have a Python path
(`read_flare_table(use_native=False)`, the planners' numpy versions) take
the native one only when asked (`use_native=True`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "load_native", "native_available", "flare_table_native",
           "partition_balance", "partition_slabs", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flare_table.cpp", "partition.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LIB = None
_lock = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libdfnative-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the native library with g++ unless it is built; its path.
    Raises RuntimeError if there is no g++ or the compile fails."""
    so = _so_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is built "
                           "with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, *(str(CSRC / s) for s in SOURCES),
                        "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed building the native library:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def native_available() -> bool:
    """Whether the native library is built or can be built here (g++)."""
    try:
        load_native()
    except (RuntimeError, OSError):
        return False
    return True


def load_native():
    """The native library (built at first use) with its argument types."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.ft_open.restype = ctypes.c_void_p
        lib.ft_open.argtypes = [ctypes.c_char_p]
        lib.ft_dims.argtypes = [ctypes.c_void_p,
                                np.ctypeslib.ndpointer(np.int32)]
        lib.ft_n_tables.restype = ctypes.c_long
        lib.ft_n_tables.argtypes = [ctypes.c_void_p]
        lib.ft_axis.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                np.ctypeslib.ndpointer(np.float64)]
        lib.ft_misc.argtypes = [ctypes.c_void_p,
                                np.ctypeslib.ndpointer(np.float64)]
        lib.ft_laminar.argtypes = [ctypes.c_void_p,
                                   np.ctypeslib.ndpointer(np.float64)]
        lib.ft_names.restype = ctypes.c_long
        lib.ft_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_long]
        lib.ft_read_tables.argtypes = [ctypes.c_void_p,
                                       np.ctypeslib.ndpointer(np.float64)]
        lib.ft_close.argtypes = [ctypes.c_void_p]
        lib.part_balance.argtypes = [ctypes.c_int] * 4 + [
            np.ctypeslib.ndpointer(np.int32)]
        lib.part_slabs.argtypes = [ctypes.c_int, ctypes.c_int,
                                   np.ctypeslib.ndpointer(np.int32)]
        _LIB = lib
        return lib


def flare_table_native(path: str):
    """Parse a FlaRe .tbl with the C++ loader: (dims, (omega_species,
    species), axes, (Hfu, Hox), laminar (NH, NZL, 5), tables_flat)."""
    lib = load_native()
    h = lib.ft_open(str(path).encode())
    if not h:
        raise IOError(f"native FlaRe parse failed: {path}")
    try:
        dims = np.zeros(10, np.int32)
        lib.ft_dims(h, dims)
        NH, NZ, NC, NGZ, NGC, NZC, NS, NYomega, NY, NZL = (int(x) for x in dims)
        n = lib.ft_names(h, None, 0)
        buf = ctypes.create_string_buffer(n + 1)
        lib.ft_names(h, buf, n + 1)
        l1, _, l2 = buf.value.decode().partition("\n")
        axes = []
        for i, ln in enumerate((NH, NZ, NC, NGZ, NGC, NZC)):
            a = np.zeros(ln)
            lib.ft_axis(h, i, a)
            axes.append(a)
        misc = np.zeros(2)
        lib.ft_misc(h, misc)
        lam = np.zeros(NH * NZL * 5)
        lib.ft_laminar(h, lam)
        tables = np.zeros(lib.ft_n_tables(h) * NH * NZ * NC * NGZ * NGC * NZC)
        lib.ft_read_tables(h, tables)
        return (tuple(int(x) for x in dims),
                (tuple(l1.split()[:NYomega]), tuple(l2.split()[:NY])),
                tuple(axes), (misc[0], misc[1]), lam.reshape(NH, NZL, 5),
                tables)
    finally:
        lib.ft_close(h)



def partition_balance(nx: int, ny: int, nz: int, n_devices: int,
                      use_native: bool = False) -> tuple[int, int, int]:
    """Device grid (dx, dy, dz) of n_devices over an nx x ny x nz block that
    minimizes the halo surface per device (two faces per split axis), with
    a penalty of 1000 per remainder cell; the first best in (dx, dy) order.
    use_native: the C++ planner (built at first use) instead of numpy."""
    if use_native:
        out = np.zeros(3, np.int32)
        load_native().part_balance(nx, ny, nz, n_devices, out)
        return tuple(int(x) for x in out)
    best, best_cost = (n_devices, 1, 1), float("inf")
    for dx in range(1, n_devices + 1):
        if n_devices % dx:
            continue
        rem = n_devices // dx
        for dy in range(1, rem + 1):
            if rem % dy:
                continue
            dz = rem // dy
            if dx > nx or dy > ny or dz > nz:
                continue
            cost = ((2 * (ny // dy) * (nz // dz) if dx > 1 else 0)
                    + (2 * (nx // dx) * (nz // dz) if dy > 1 else 0)
                    + (2 * (nx // dx) * (ny // dy) if dz > 1 else 0)
                    + 1000 * (nx % dx + ny % dy + nz % dz))
            if cost < best_cost:
                best, best_cost = (dx, dy, dz), cost
    return best


def partition_slabs(n: int, n_devices: int,
                    use_native: bool = False) -> np.ndarray:
    """Split points (n_devices + 1,) of n cells into n_devices contiguous
    slabs whose sizes differ by at most one (the first n % n_devices one
    larger). use_native: the C++ planner instead of numpy."""
    if use_native:
        out = np.zeros(n_devices + 1, np.int32)
        load_native().part_slabs(n, n_devices, out)
        return out.astype(int)
    base, rem = divmod(n, n_devices)
    starts = [0]
    for d in range(n_devices):
        starts.append(starts[-1] + base + (1 if d < rem else 0))
    return np.asarray(starts)
