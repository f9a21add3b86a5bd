"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

``<hash>`` covers every source under ``csrc/`` and the flags, so an edited
source rebuilds and an unchanged one is reused.  The build happens at first
use (or all at once, one ``nvcc`` per source in parallel, through
:func:`build_all`), never at import: the CPU tests import every module on
a machine with no CUDA toolkit.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=None) -> dict[str, float]:
    """Compile the named sources (default: all of ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: seconds}`` for the sources compiled by this call."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    times = {}
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)        # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def _load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared, looked up and declared once per process."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(_load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
