"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``.  Libraries land in ``build/repro_torch_kernels/``
at the root of the checkout, named by a digest of their source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: :func:`kernel` builds at
first use, and :func:`build` builds ahead of time, every source at
once.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Iterable

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: kernel name -> (source file, C entry, argument types); every entry
#: takes its tensors' data pointers, then its sizes and options (ints,
#: and a float for a norm's eps or an attention scale), then the CUDA
#: stream, and returns ``cudaGetLastError()``.
KERNELS = {
    "mesi_tick": ("mesi_tick.cu", "mesi_tick_launch",
                  [_P] * 9 + [_I] * 7 + [_P]),
    "chunk_tick": ("chunk_tick.cu", "chunk_tick_launch",
                   [_P] * 9 + [_I] * 8 + [_P]),
    "rmsnorm": ("rmsnorm.cu", "rmsnorm_launch",
                [_P] * 3 + [_I, _I, _F, _I, _I, _P]),
    "rmsnorm_bwd": ("rmsnorm_bwd.cu", "rmsnorm_bwd_launch",
                    [_P] * 6 + [_I, _I, _F] + [_I] * 5 + [_P]),
    "flash_attention": ("flash_attention.cu", "flash_attention_launch",
                        [_P] * 7 + [_I] * 8 + [_F, _I, _P]),
    "flash_attention_bwd": ("flash_attention_bwd.cu",
                            "flash_attention_bwd_launch",
                            [_P] * 10 + [_I] * 8 + [_F, _I, _I, _P]),
    "decode_attention": ("decode_attention.cu", "decode_attention_launch",
                         [_P] * 7 + [_I] * 6 + [_F, _I, _P]),
    "rwkv6_scan": ("rwkv6_scan.cu", "rwkv6_scan_launch",
                   [_P] * 9 + [_I] * 6 + [_P]),
    "rwkv6_scan_bwd": ("rwkv6_scan_bwd.cu", "rwkv6_scan_bwd_launch",
                       [_P] * 15 + [_I] * 5 + [_P]),
    "causal_conv1d": ("causal_conv1d.cu", "causal_conv1d_launch",
                      [_P] * 6 + [_I] * 6 + [_P]),
    "causal_conv1d_bwd": ("causal_conv1d_bwd.cu", "causal_conv1d_bwd_launch",
                          [_P] * 11 + [_I] * 6 + [_P]),
    "selective_scan": ("selective_scan.cu", "selective_scan_launch",
                       [_P] * 12 + [_I] * 9 + [_P]),
    "selective_scan_bwd": ("selective_scan_bwd.cu",
                           "selective_scan_bwd_launch",
                           [_P] * 17 + [_I] * 4 + [_P]),
}

_LIBS: dict = {}
_ENTRIES: dict = {}

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the kernel's library lives: named by a digest of its source,
    every shared header of ``csrc/`` (a source may include any of them)
    and the compiler flags."""
    digest = hashlib.sha256((_CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(KERNELS),
          ptxas_verbose: bool = False) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler
    output}`` for the kernels it compiled (with ``ptxas_verbose`` the
    output lists each kernel's registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS,
               *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(_CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{name}: nvcc timed out\n{log}")
            continue
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def entry(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A C entry of kernel ``name``'s library, built and loaded at first
    use, with its argument and result types set."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, symbol)   # the library outlives fn in _LIBS
        fn.argtypes = argtypes
        fn.restype = restype
        _ENTRIES[(name, symbol)] = fn
    return fn


def kernel(name: str):
    """The ctypes entry that launches kernel ``name`` (``KERNELS``)."""
    _, symbol, argtypes = KERNELS[name]
    return entry(name, symbol, argtypes)
