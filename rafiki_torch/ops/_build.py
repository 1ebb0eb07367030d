"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, and loaded with
``ctypes``. The library's file name carries a hash of the sources and
flags, so a build is reused until a source changes. A failed build
raises; nothing falls back to another path.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together. Service processes on the same checkout load the
libraries their parent built; ``kernel_origins()`` says, for this
process, which it built and which it loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

# C entry points: name -> (symbol, argtypes). Pointers and the stream
# are c_void_p, so ctypes never cuts them to 32 bits.
_ENTRY = {
    "flash_fwd": ("flash_fwd",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p]),
    "flash_bwd_dq": ("flash_bwd_dq",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p]),
    "flash_bwd_dkv": ("flash_bwd_dkv",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, out)."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path,
            out: Path) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> float:
    """Build every kernel not built yet, one ``nvcc`` per source in
    parallel; returns the wall seconds spent."""
    names = list(_ENTRY) if names is None else names
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
    errors = []
    for n, started in procs.items():
        try:
            _finish(n, *started)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for the last build of ``name``
    (registers, shared memory, spills)."""
    path = BUILD_DIR / f"{name}.build.log"
    return path.read_text() if path.exists() else ""


#: How this process came by each library it loaded: "built" (its own
#: nvcc run) or "loaded" (a build already on disk).
_ORIGINS: Dict[str, str] = {}


def kernel_origins() -> Dict[str, str]:
    """``{name: "built" | "loaded"}`` of the libraries this process
    loaded."""
    return dict(_ORIGINS)


@functools.lru_cache(maxsize=None)
def load_kernel(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built if needed."""
    built = not _lib_path(name).exists()
    if built:
        build_all([name])
    _ORIGINS[name] = "built" if built else "loaded"
    lib = ctypes.CDLL(str(_lib_path(name)))
    symbol, argtypes = _ENTRY[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
