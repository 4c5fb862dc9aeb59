"""Build and bind the port's hand-written CUDA kernels.

Each kernel source ``kernels/<pkg>/csrc/<name>.cu`` exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library under
``build/repro_torch/`` at the repository root, then loaded with ``ctypes``.
A library's file name carries a hash of its source and of the compiler flags,
so an edited source is rebuilt at its next use and a stale library is never
loaded.  :func:`build` compiles every stale library in parallel (one ``nvcc``
per source, all started together; a source listed in :data:`PARTS` is
compiled once per part, all parts at once, and the objects linked into its
one library); a kernel wrapper's first launch builds its own library if
nothing has yet.  Processes that share the build
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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

# Libraries whose source is compiled in parts: (macro, parts).  Part i is the
# source compiled to an object with NVCC_FLAGS, ``-c`` for ``-shared`` and
# ``-D<macro>=i``; one link of NVCC_FLAGS joins the objects into the library.
# The SSA library's kernels take the longest to compile; its four parts
# (``ssa.cu``'s header) compile at once.
PARTS = {"ssa": ("SSA_PART", 4)}


class Built(NamedTuple):
    """A library's build: the compiler output of every ``nvcc`` call
    (``-Xptxas -v``: registers, shared memory, spills), the seconds from the
    start of the build to the library's end, and each part's seconds to its
    object (empty for a library of one unit)."""
    log: str
    seconds: float
    parts: tuple[float, ...] = ()

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


def _parts(name: str) -> tuple[str, int] | None:
    """(macro, parts) of a library or control build compiled in parts."""
    return PARTS.get(CONTROLS[name][0] if name in CONTROLS else name)


def _commands(nvcc: str, name: str, out: Path) -> tuple[list[list[str]], list[str] | None]:
    """The ``nvcc`` compile commands of library ``name`` into ``out`` and, for a
    library built in parts, the link of their objects (else None)."""
    source, flags = _recipe(name)
    parts = _parts(name)
    if parts is None:
        return [[nvcc, *flags, "-o", str(out), str(source)]], None
    macro, n = parts
    compile_flags = ["-c" if f == "-shared" else f for f in flags]
    objects = [str(out.with_name(f"{out.stem}.part{i}.o")) for i in range(n)]
    return ([[nvcc, *compile_flags, f"-D{macro}={i}", "-o", obj, str(source)]
             for i, obj in enumerate(objects)],
            [nvcc, *flags, "-o", str(out), *objects])


def library_path(name: str) -> Path:
    source, flags = _recipe(name)
    parts = _parts(name)
    recipe = " ".join(flags) + ("" if parts is None else " parts {}={}".format(*parts))
    digest = hashlib.sha256(source.read_bytes() + recipe.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, Built]:
    """Compile every library in ``names`` (default: all, no control build)
    whose current build is missing, all ``nvcc`` processes at once.  Returns
    each built library's :class:`Built` (compiler output and seconds);
    raises with the compiler output if any compile or link fails."""
    names = list(names or SOURCES)
    if all(library_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        return _build_missing([n for n in names if not library_path(n).exists()])


def _run(cmd: list[str], t0: float) -> tuple[int, str, float]:
    """Run one ``nvcc`` command: its exit code, output, and seconds since ``t0``."""
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return done.returncode, done.stdout, time.perf_counter() - t0


def _build_one(pool, nvcc: str, name: str, t0: float) -> tuple[bool, Built]:
    """Library ``name``: its compiles at once on ``pool``, then its link; the
    library replaces its path atomically (a concurrent process never sees
    half a file) only if every step succeeded."""
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    compiles, link = _commands(nvcc, name, tmp)
    runs = [f.result() for f in [pool.submit(_run, cmd, t0) for cmd in compiles]]
    ok = all(rc == 0 for rc, _, _ in runs)
    logs = [text for _, text, _ in runs]
    if ok and link:
        rc, text, _ = _run(link, t0)
        ok = rc == 0
        logs.append(text)
    if link:
        for obj in link[len(link) - len(compiles):]:
            Path(obj).unlink(missing_ok=True)
    if ok:
        os.replace(tmp, out)
    else:
        tmp.unlink(missing_ok=True)
    parts = tuple(s for _, _, s in runs) if link else ()
    return ok, Built("".join(logs), time.perf_counter() - t0, parts)


def _build_missing(todo) -> dict[str, Built]:
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    n_compiles = sum(len(_commands(nvcc, name, BUILD_DIR / name)[0]) for name in todo)
    with ThreadPoolExecutor(len(todo) + n_compiles) as pool:
        done = {name: f.result() for name, f in
                [(name, pool.submit(_build_one, pool, nvcc, name, t0)) for name in todo]}
    failed = [name for name, (ok, _) in done.items() if not ok]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(done[n][1].log for n in failed))
    return {name: built for name, (_, built) in done.items()}


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
