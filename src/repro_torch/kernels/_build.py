"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` with ``nvcc`` for ``sm_90a`` (Hopper).
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an unchanged kernel is not rebuilt within one checkout.  Nothing
here runs at import time: the CPU tests import every module, and this
machine need not have ``nvcc``.

The kernels that use TMA encode their tensor maps with the driver API's
``cuTensorMapEncodeTiled``.  ``csrc/hopper.cuh`` fetches it at run time
through the runtime's ``cudaGetDriverEntryPoint``, so no library links
against ``libcuda`` and the flags below name none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNELS", "NVCC_FLAGS", "BuildError", "find_nvcc", "load",
           "build_all"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
#: kernel -> (C entry point, argtypes); every entry returns a cudaError_t
KERNELS = {
    "dedup_embedding": ("dedup_embedding_striped",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "dedup_matmul": ("dedup_matmul",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P]),
    "flash_attention": ("flash_attention",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _F, _I, _I, _I, _I, _P]),
    "lsh_signature": ("lsh_signature",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME``, else under the
    toolkit's default install prefix."""
    hit = shutil.which("nvcc")
    if hit:
        return hit
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc process writing to a temp file; (proc, tmp, dst)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dst = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, dst


def _finish(name: str, proc, tmp: str, dst: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed on csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, dst)                       # atomic: never a torn .so


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    entry, argtypes = KERNELS[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all(names: Iterable[str] = tuple(KERNELS)) -> float:
    """Compile every missing kernel library, one nvcc per source, all
    started together; bind them.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    names = [n for n in names if n not in _LIBS]
    todo = [n for n in names if not _target(n).is_file()]
    if todo:
        nvcc = find_nvcc()
        if nvcc is None:
            raise BuildError("nvcc not found on PATH or under CUDA_HOME; "
                             "the CUDA kernels cannot be built")
        started = [(n, *_start(n, nvcc)) for n in todo]
        errors = []
        for n, proc, tmp, dst in started:
            try:
                _finish(n, proc, tmp, dst)
            except BuildError as e:       # collect all, report together
                errors.append(str(e))
        if errors:
            raise BuildError("\n".join(errors))
    for n in names:
        _bind(n)
    return time.perf_counter() - t0


def load(name: str):
    """The bound C entry point of kernel ``name``, building it first if
    needed.  Raises :class:`BuildError` when it cannot be built."""
    if name not in _LIBS:
        build_all([name])
    return getattr(_LIBS[name], KERNELS[name][0])
