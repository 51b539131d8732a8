"""Build and load the port's CUDA kernels: one shared library with a plain C interface.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc`` for each
source, all started together), linked into one shared library and loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds. The library goes
into ``baselines_tpu_torch/_build/`` under a name keyed by a hash of the sources and the
flags, and is built at first use: ``library()`` builds it when it is missing.
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_library = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbtt_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile and link the library unless it is already built.

    Returns {"path", "seconds", "ptxas"}: the compile and link time (0.0 when the
    library was already there) and the ``-Xptxas -v`` lines (registers, shared memory
    and spills of every kernel)."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "ptxas": []}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        staged = Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {path.name} failed:\n{link.stdout}")
        os.replace(staged, path)
    ptxas = [line.strip() for log in logs for line in log.splitlines()
             if "ptxas" in line or "spill" in line]
    return {"path": str(path), "seconds": time.perf_counter() - start, "ptxas": ptxas}


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(build()["path"])
        vp = ctypes.c_void_p
        lib.btt_fused_cnn_conv.argtypes = [vp] * 8 + [ctypes.c_int, vp]
        lib.btt_fused_cnn_dense.argtypes = [vp] * 4 + [ctypes.c_int, vp]
        for fn in (lib.btt_fused_cnn_conv, lib.btt_fused_cnn_dense):
            fn.restype = ctypes.c_int
        lib.btt_gather_rows.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.c_longlong, vp]
        lib.btt_gather_rows.restype = ctypes.c_int
        lib.btt_stratified_sample.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, vp, vp,
                                              vp]
        lib.btt_stratified_sample.restype = ctypes.c_int
        lib.btt_error_string.argtypes = [ctypes.c_int]
        lib.btt_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def current_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream of ``device``, for a C entry's stream
    argument. It reads the handle without building a ``torch.cuda.Stream`` object,
    which takes several microseconds of host time a call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().btt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
