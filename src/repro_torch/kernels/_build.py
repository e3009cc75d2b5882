"""Build and load the port's CUDA kernels on first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c <source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libsell.so *.o

The library lands in ``build/repro_torch_kernels/<sha256 of the sources>/``
at the root of the checkout, beside ``build.log`` (nvcc's output, including
ptxas' register and shared-memory lines), so an edited source rebuilds and
an unchanged one loads at once. A failed build raises with nvcc's output.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "libsell.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument lists of the C launch functions: csrc/sell_spmv.cu and
# sell_spmm.cu take values, x/X, tags, meta, y/Y, then the ints, then the
# stream; csrc/coalesced_gather.cu takes table, tags, meta, out, its work
# queue, the ints, the stream.
_SIGNATURES = {
    "sell_spmv_launch": [_P] * 5 + [_I] * 16 + [_P],
    "sell_spmm_launch": [_P] * 5 + [_I] * 18 + [_P],
    "coalesced_gather_launch": [_P] * 5 + [_I] * 20 + [_P],
    "sell_max_dynamic_smem": [_I, ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_smem: Dict[int, int] = {}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def library_dir() -> Path:
    return BUILD_ROOT / source_digest()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "the CUDA kernels need nvcc (set CUDA_HOME or put nvcc on PATH)"
    )


def build() -> Path:
    """Compile the kernels unless this source digest is already built;
    returns the library's path."""
    out_dir = library_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    try:
        t0 = time.perf_counter()
        cus = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (src.stem + ".o") for src in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC),
                 "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cus, objs)
        ]
        logs = []
        failed = []
        for src, proc in zip(cus, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        logs.append(f"== seconds {time.perf_counter() - t0:.3f}")
        (tmp / "build.log").write_text("\n".join(logs))
        for obj in objs:
            obj.unlink()
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib_path.exists():  # not a concurrent builder's finished dir
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """nvcc's output from the build of the current sources ('' if unbuilt)."""
    path = library_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sell_error_string.argtypes = [ctypes.c_int]
            lib.sell_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if rc != 0:
        msg = library().sell_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def count_launch(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel in ``wrapper.launches``. While
    the current stream is being captured into a CUDA graph nothing runs: the
    launch goes to ``wrapper.captured`` instead, and each replay of the graph
    adds the launches it captured to ``launches``
    (`kernels.ops.CapturedLaunches`)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def max_dynamic_smem(device: torch.device) -> int:
    """Shared memory a block may opt into on `device` (bytes)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _smem:
        out = ctypes.c_int(0)
        check(library().sell_max_dynamic_smem(index, ctypes.byref(out)),
              "sell_max_dynamic_smem")
        _smem[index] = int(out.value)
    return _smem[index]
