"""Build the port's CUDA sources into shared libraries at first use, and
hold what their wrappers share.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into ``build/torch_kernels/lib<name>.<hash>.so`` at the repository root,
keyed by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads at once. The library has a plain C interface and
is loaded with ``ctypes``; nothing here includes PyTorch's headers, which
keeps a build to seconds.

The wrappers (``bn.py``, ``pool.py``) share the dtype table of their
instances (:data:`SUFFIX`), the card's SM count (:func:`sm_count`), its
current stream (:func:`stream`) and the switch that runs their plain
versions on CUDA tensors too (:func:`plain_versions`, read as
:data:`force_plain`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}

# the dtypes each kernel has an instance for, and its entry points' suffix
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64"}
force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors as well (for tests and
    the chip smoke's comparisons; the main path never enters this)."""
    global force_plain
    previous, force_plain = force_plain, True
    try:
        yield
    finally:
        force_plain = previous


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(index: int) -> int:
    """The handle of card ``index``'s current stream, which every kernel
    launches on (0.1 us a call, against 1.7 for
    ``torch.cuda.current_stream(index).cuda_stream``, on an H100 host)."""
    return torch._C._cuda_getCurrentRawStream(index)


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] if os.environ.get("CUDA_HOME") else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.exists():
            return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at first use.")


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path and the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills of every kernel), kept beside the library in
    ``<library>.log`` so that a library built earlier reports it too."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({run.returncode}): {' '.join(cmd)}\n"
                           f"{run.stdout}{run.stderr}")
    log.write_text(run.stdout + run.stderr)
    tmp.replace(out)  # atomic: a concurrent loader never sees a partial file
    return out, run.stdout + run.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        path, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
