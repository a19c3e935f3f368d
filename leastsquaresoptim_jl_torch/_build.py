"""Build and load the package's hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package for
Hopper (``sm_90a``), one process per source, all started together, and
links the objects into a shared library with a plain C interface, under
``build/torch_kernels/`` beside the package, named by a hash of the
sources and flags (an unchanged tree reuses its library). The
library is loaded with ``ctypes``; pointers and the stream are passed as
``c_void_p``. Nothing is fetched and nothing outside the package's
``csrc/`` is compiled. A failed build raises with nvcc's output.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions of the kernels are, so that a kernel and its plain
version can be compared bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# name -> argtypes of the C entry points in csrc/
_SIGNATURES = {
    "lso_kernel_varpro_f32": [_P, _P, _P, _I, _I, _I] + [ctypes.c_float] * 7 + [_I, _I, _P],
    "lso_kernel_varpro_f64": [_P, _P, _P, _I, _I, _I] + [ctypes.c_double] * 7 + [_I, _I, _P],
    "lso_gram_f32": [_P, _P, _L, _I, _L, _I, _P, _P, _P],
    "lso_gram_bf16": [_P, _P, _L, _I, _L, _I, _P, _P, _P],
}

_lib = None
build_seconds = None  # wall time of the build (or load) that produced _lib
build_log = ""  # nvcc's output of the build (ptxas register/spill report)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME): the kernels are built "
            "with nvcc at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load():
    """Return the loaded kernel library, building it first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"kernels_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        tag = f"{lib_path.stem}.{os.getpid()}"
        procs = []
        for src in sources:
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # Wait for every compile before reporting any failure.
        logs = [" ".join(cmd) + "\n" + proc.communicate()[0]
                for cmd, _, proc in procs]
        for (_, _, proc), log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed to build the kernels:\n" + log)
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to link the kernels:\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
        for _, obj, _ in procs:
            obj.unlink()
        log_path.write_text("\n".join(logs))
        os.replace(tmp, lib_path)
    build_log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return _lib
