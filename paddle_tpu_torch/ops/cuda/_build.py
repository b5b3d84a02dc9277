"""Build and load the CUDA kernels of ``paddle_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``paddle_tpu_torch/_build/<name>-<hash>.so``, loaded with ``ctypes``.
A variant (``VARIANTS``) is a source compiled again with extra flags into
a library of its own: the float16 kernels are the bfloat16 bodies
compiled with ``-DPTT_F16`` (``csrc/mma_bf16.cuh``), so the bf16 libraries
stay exactly as they were and each build takes the time of one.
No PyTorch header is included, so a build takes seconds.  The hash covers
the sources and the flags, so an edited kernel is rebuilt and a stale
library is never loaded.  :func:`build` starts one ``nvcc`` per source, all
at once; a kernel wrapper calls :func:`load`, which builds what is missing
at first use.  The build directory is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("decode_attention", "flash_attention_fwd", "flash_attention_bwd",
           "int8_matmul")
# library -> (source, extra nvcc flags); its C entries keep the source's
# names, and take dtype code 2 (float16) only
F16 = ("-DPTT_F16",)
VARIANTS = {"decode_attention_f16": ("decode_attention", F16),
            "flash_attention_fwd_f16": ("flash_attention_fwd", F16),
            "flash_attention_bwd_f16": ("flash_attention_bwd", F16),
            "int8_matmul_f16": ("int8_matmul", F16)}
LIBRARIES = SOURCES + tuple(VARIANTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas register/shared-memory/spill report) of the
# build made by this process
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_of(name: str):
    """(source, extra nvcc flags) of library ``name``."""
    return VARIANTS.get(name, (name, ()))


def _library(name: str) -> Path:
    source, extra = source_of(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # .cu and shared .cuh
        if src.suffix == ".cuh" or src.stem == source:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, Path]:
    """Compile every named library that is missing, one ``nvcc`` process
    each, all started together.  Raises with nvcc's output if any build
    fails.  Returns name -> library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _library(n) for n in names}
    procs = {}
    for n in names:
        if out[n].exists():
            continue
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        source, extra = source_of(n)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"--- nvcc {n} (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source of ``csrc/`` or a variant),
    built at first use.  Every library exports
    ``<source>_error_string(int)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            err_fn = getattr(lib, f"{source_of(name)[0]}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError``): a
    refused launch never runs, and a later synchronise would not say so."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
