"""Build, load and call the CUDA kernels under ``csrc/``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use into ``_build/<digest>/`` beside this file (listed in
.gitignore), where the digest covers the sources and the flags, so a changed
source builds anew and an unchanged one loads at once. No PyTorch header is
compiled, which keeps a build to seconds.

``--fmad=false`` and the absence of fast math make each float operation of
a kernel round as IEEE float32, like the separate elementwise ops of the
plain PyTorch version beside each wrapper; the reference measured that FMA
contraction flips the winner of about 1e-5 of rays at tangent grazes.

Each C function launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("primary_hit.cu", "shadow_occlusion.cu", "phong_shade.cu",
           "phong_shade_bwd.cu", "compact_mask.cu", "dense_hit.cu",
           "winner_scatter.cu", "soft_composite.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
LIB_NAME = "liboglrt_kernels.so"

# Launch count of each kernel wrapper, by wrapper name: a wrapper adds one
# where it launches its kernel and nowhere else (never on its plain path),
# so a run can show that the main path went through the kernels.
LAUNCHES = collections.Counter()

# utils/debug.checked_render's NaN check while it runs in this thread, else
# None. A dispatch mode cannot see inside a kernel (it is called through
# ctypes), so each wrapper (decorated with ``wrapper``) runs as one op that
# the check does not look into, and hands it its outputs instead.
NAN_CHECK = contextvars.ContextVar("oglrt_nan_check", default=None)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a plain int would
# be passed as 32 bits and cut the pointer)
_SIGNATURES = {
    "oglrt_primary_hit": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    "oglrt_primary_hit_ray": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P, _P, _P, _P],
    "oglrt_compact_mask": [_P, _I, _I, _I, _P, _P, _P, _P],
    "oglrt_dense_hit": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _P, _P],
    "oglrt_shadow_occlusion": [_P, _P, _P, ctypes.c_uint, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P,
                               _P],
    "oglrt_shadow_hot": [_P, _P, _P, ctypes.c_uint, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _P, _I, _P, _I, _P, _P],
    "oglrt_phong_shade": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P,
                          _P],
    "oglrt_phong_shade_bwd": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                              _I, _P, _P, _P, _P, _P, _P],
    "oglrt_winner_scatter": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                             _I, _P, _P, _P, _I, _P, _P, _P],
    "oglrt_soft_composite": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                             _F, _F, _F, _P, _P, _P, _P, _P],
    "oglrt_soft_composite_bwd": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                                 _I, _F, _F, _F, _P, _P, _P, _P, _I, _P, _P,
                                 _P, _P, _P],
}


def find_nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else the toolkit's default
    install location."""
    path = shutil.which("nvcc")
    if path:
        return path
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels of openglraytracer_tpu_torch are compiled from "
        "csrc/ with the CUDA toolkit's nvcc on the machine with the GPU")


def build_dir(csrc: Path = CSRC, sources: tuple = SOURCES) -> Path:
    """_build/<digest of the sources and flags>."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in sources + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(csrc: Path = CSRC, sources: tuple = SOURCES) -> tuple[Path, str]:
    """Compile the kernels unless this digest is built already: one nvcc
    per source, run in parallel, then one link. Returns the library's path
    and nvcc's output (ptxas register, shared-memory and spill figures per
    kernel; empty when the library was already built).

    The arguments select another build for measurement: some of the
    sources, from another directory (an earlier version of a kernel, to
    time beside the current one)."""
    out = build_dir(csrc, sources) / LIB_NAME
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.with_name(f"{Path(s).stem}.{tag}.o") for s in sources]
    jobs = []
    for src, obj in zip(sources, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(csrc), "-o", str(obj),
               str(csrc / src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{text}")
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)    # atomic: a concurrent build loses nothing
    return out, "".join(logs) + proc.stdout + proc.stderr


def load(path: Path, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Load a kernel library built by ``build`` and declare the C
    signatures of its functions ``names`` (all of them by default; a build
    of some of the sources names what those hold). A missing function
    raises here, not at its first launch."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.oglrt_error_string.argtypes = [ctypes.c_int]
    lib.oglrt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return load(build()[0])


def launch(name: str, device: torch.device, *args) -> None:
    """Call C function ``name`` with ``args`` (tensors are passed as their
    data pointers) and the current CUDA stream of ``device``; raise if the
    launch failed."""
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*c_args, stream)
    if err:
        msg = lib.oglrt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check(name: str, x: torch.Tensor, device: torch.device, dtype,
          shape: tuple) -> None:
    """Raise unless x is a contiguous tensor of this dtype and shape on
    device — what the kernels take."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cpu(x: torch.Tensor) -> bool:
    """Dispatch rule of every wrapper: the plain version for a CPU tensor,
    the kernel for a CUDA tensor, an error for anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def wrapper(fn):
    """Decorator of a kernel wrapper: under utils/debug.checked_render the
    call (its kernel, or its plain version on the CPU) is one opaque op
    whose tensor outputs are checked for NaN."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        check = NAN_CHECK.get()
        if check is None:
            return fn(*args, **kwargs)
        with check.paused():
            out = fn(*args, **kwargs)
        check.record_outputs(f"kernel {fn.__name__}", out)
        return out
    return call


def unchecked():
    """Context in which checked_render's NaN check is off, for a
    construction that writes NaN on purpose."""
    check = NAN_CHECK.get()
    return contextlib.nullcontext() if check is None else check.paused()
