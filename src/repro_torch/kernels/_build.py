"""Build and bind the port's hand-written CUDA kernels.

Each kernel source ``kernels/<pkg>/csrc/<name>.cu`` exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library under
``build/repro_torch/`` at the repository root, then loaded with ``ctypes``.
A library's file name carries a hash of its source and of the compiler flags,
so an edited source is rebuilt at its next use and a stale library is never
loaded.  :func:`build` compiles every stale library in parallel (one ``nvcc``
per source, all started together); a kernel wrapper's first launch builds
its own library if nothing has yet.  Processes that share the build
directory (the ranks of a mesh reaching first use together) build once: the
build holds a file lock on the directory, and a process that waited for it
finds the libraries built.

Launch convention (every ``.cu`` file): the C function takes device pointers
and the CUDA stream as ``void*`` and ints as ``int``, enqueues on that stream
without synchronising, and returns ``cudaGetLastError()``; the wrapper raises
on any nonzero code (:func:`check`).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

SOURCES = {
    "lif_parallel": _KERNELS / "lif_parallel" / "csrc" / "lif_parallel.cu",
    "spike_matmul": _KERNELS / "spike_matmul" / "csrc" / "spike_matmul.cu",
    "ssa": _KERNELS / "spiking_attention" / "csrc" / "ssa.cu",
}

# Control builds: a library's source compiled with extra preprocessor
# definitions, built only on request.  chip_smoke.py runs a wrapper on one
# (:func:`substitute`) to show that a check would catch a weaker kernel.
CONTROLS = {
    "spike_matmul_hi": ("spike_matmul", ("SPIKE_MATMUL_PIECES=1",)),
    "spike_matmul_hi_mid": ("spike_matmul", ("SPIKE_MATMUL_PIECES=2",)),
}

# No --use_fast_math: the LIF kernel is bit-exact against its plain version
# only without flush-to-zero and approximate division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH or set CUDA_HOME)")
    return str(path)


def _recipe(name: str) -> tuple[Path, tuple[str, ...]]:
    """(source, nvcc flags) of a library or of a control build."""
    if name in CONTROLS:
        lib, defines = CONTROLS[name]
        return SOURCES[lib], NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    return SOURCES[name], NVCC_FLAGS


def library_path(name: str) -> Path:
    source, flags = _recipe(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compile every library in ``names`` (default: all, no control build)
    whose current build is missing, all ``nvcc`` processes at once.  Returns
    the compiler output (``-Xptxas -v``: registers, shared memory, spills) of
    each library built; raises with that output if any compile fails."""
    names = list(names or SOURCES)
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        return _build_missing([n for n in names if not library_path(n).exists()])


def _build_missing(todo) -> dict[str, str]:
    if not todo:
        return {}
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        source, flags = _recipe(name)
        proc = subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, out, proc))
    logs, failed = {}, []
    for name, tmp, out, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)     # atomic: a concurrent process never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel(lib: str, fn: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``fn`` of library ``lib``, built and loaded on first
    use, with its ``argtypes`` and ``restype`` (a launcher's cudaError_t by
    default) declared."""
    key = (lib, fn)
    if key not in _fns:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(_libs[lib], fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _fns[key] = f
    return _fns[key]


@contextlib.contextmanager
def substitute(lib: str, control: str):
    """Within the block, the wrappers of library ``lib`` launch the kernels of
    the control build ``control`` of its source (and count their launches as
    ever); the library's own build is back afterwards."""
    if CONTROLS[control][0] != lib:
        raise ValueError(f"{control} is a control build of {CONTROLS[control][0]}, not {lib}")
    build([control])
    saved_lib = _libs.get(lib)
    saved_fns = {key: _fns.pop(key) for key in [key for key in _fns if key[0] == lib]}
    _libs[lib] = ctypes.CDLL(str(library_path(control)))
    try:
        yield
    finally:
        for key in [key for key in _fns if key[0] == lib]:
            del _fns[key]
        _fns.update(saved_fns)
        if saved_lib is None:
            del _libs[lib]
        else:
            _libs[lib] = saved_lib


def check(err: int, lib: str, what: str) -> None:
    """Raise if a launcher returned a nonzero cudaError_t."""
    if err:
        describe = kernel(lib, "repro_cuda_error_string", (ctypes.c_int,),
                          restype=ctypes.c_char_p)
        raise RuntimeError(f"{what}: CUDA error {err} ({describe(err).decode()})")


def check_operands(what: str, *operands: tuple[torch.Tensor, torch.dtype]) -> None:
    """The kernels take contiguous tensors on one CUDA device, each of the
    dtype paired with it: ``check_operands(what, (x, torch.int32), (w,
    torch.float32))``.  Packed spike words are int32 (the uint32 bit
    pattern); everything else is float32, but for the LIF kernels' bf16
    drives."""
    dev = operands[0][0].device
    for x, dtype in operands:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {[str(t.device) for t, _ in operands]}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: the kernel takes {dtype} here, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def stream(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def report_launch(name: str, *operands) -> None:
    """Hand the entry point ``name`` and its operands (tensors; None is
    skipped) to an active graph recorder
    (:class:`repro_torch.engine.analysis.OpRecorder`, a
    ``TorchDispatchMode``): a kernel launched through ctypes never reaches
    PyTorch's dispatcher, so the recorder would not see it otherwise.  With
    no dispatch mode active it costs one C call."""
    if not torch._C._len_torch_dispatch_stack():
        return
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_launch", None)
        if record is not None:
            record(name, tuple(x for x in operands if x is not None))
