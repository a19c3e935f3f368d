"""Build and load the package's hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package for
Hopper (``sm_90a``), one process per source, all started together, and
links the objects into a shared library with a plain C interface, under
``build/torch_kernels/`` beside the package, named by a hash of the
sources, the headers (``csrc/*.cuh``) and the flags (an unchanged tree
reuses its library). The
library is loaded with ``ctypes``; pointers and the stream are passed as
``c_void_p``. Nothing is fetched and nothing outside the package's
``csrc/`` is compiled. A failed build raises with nvcc's output.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions of the kernels are, so that a kernel and its plain
version can be compared bit for bit on the card.

``load_variants`` builds some sources again under extra flags (build-time
defines such as gram.cu's ``LSO_GRAM_PROBE``), each variant into a library
of its own, for measurements that the package itself never calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
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
    "lso_kernel_varpro_f32": [_P, _P, _P, _I, _I, _I] + [ctypes.c_float] * 7 + [_I, _I, _I, _P],
    "lso_kernel_varpro_f64": [_P, _P, _P, _I, _I, _I] + [ctypes.c_double] * 7 + [_I, _I, _I, _P],
    "lso_kernel_varpro_f16": [_P, _P, _P, _I, _I, _I] + [ctypes.c_float] * 7 + [_I, _I, _I, _P],
    "lso_gram_f32": [_P, _P, _L, _I, _L, _I, _P, _P, _P],
    "lso_gram_bf16": [_P, _P, _L, _I, _L, _I, _P, _P, _P],
    "lso_gram_config": [_I, _I, ctypes.POINTER(_I)],
    "lso_varpro_exp2_eval_f32": [_P, _P, _I, _I, ctypes.c_double, ctypes.c_double,
                                 _P, _P, _P, _I, _I, _P],
}

_lib = None
build_log = ""  # nvcc's output of the build (ptxas register/spill report)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME): the kernels are built "
            "with nvcc at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _build(jobs):
    """Build each (sources, extra flags) of ``jobs`` into a shared library
    unless it is cached; every ``nvcc -c`` of every job is started at once.
    Returns the libraries' paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending, paths = [], []
    for sources, extra in jobs:
        flags = [*NVCC_FLAGS, *extra]
        digest = hashlib.sha256(" ".join(flags).encode())
        for src in [*sources, *sorted(SOURCE_DIR.glob("*.cuh"))]:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        lib_path = BUILD_DIR / f"kernels_{digest.hexdigest()[:16]}.so"
        paths.append(lib_path)
        if lib_path.exists():
            continue
        tag = f"{lib_path.stem}.{os.getpid()}"
        procs = []
        for src in sources:
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [_nvcc(), *flags, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        pending.append((lib_path, tag, procs))
    # Wait for every compile before reporting any failure.
    done = [(lib_path, tag, procs,
             [" ".join(cmd) + "\n" + proc.communicate()[0] for cmd, _, proc in procs])
            for lib_path, tag, procs in pending]
    for _, _, procs, logs in done:
        for (_, _, proc), log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed to build the kernels:\n" + log)
    for lib_path, tag, procs, logs in done:
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
        lib_path.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, lib_path)
    return paths


def _open(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load():
    """Return the loaded kernel library, building it first if needed."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    (lib_path,) = _build([(sorted(SOURCE_DIR.glob("*.cu")), [])])
    log_path = lib_path.with_suffix(".log")
    build_log = log_path.read_text() if log_path.exists() else ""
    _lib = _open(lib_path)
    return _lib


def load_variants(sources, variants):
    """``{name: extra nvcc flags}`` -> ``{name: library}``: the ``csrc/``
    files named in ``sources`` alone, built once per variant (all compiles
    started together)."""
    names = list(variants)
    files = [SOURCE_DIR / src for src in sources]
    paths = _build([(files, list(variants[k])) for k in names])
    return {k: _open(p) for k, p in zip(names, paths)}
