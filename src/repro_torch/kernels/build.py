"""Build and load the port's hand-written CUDA kernels.

Takes the place of ``repro.kernels.runtime.resolve_interpret``: where the
JAX package chose between a compiled and an interpreted Pallas kernel, the
port chooses by the tensor's device — a CPU tensor goes to the kernel's
plain PyTorch version (``ref.py``), a CUDA tensor to the CUDA kernel, and
anything else raises (:func:`route`).  There is no fallback from CUDA to
the plain version.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``kernels/_build/`` by a hash of the sources and
flags, and loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per
source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
KERNELS = ("trq_group_mvm", "trq_quant", "xbar_mvm",  # csrc/<name>.cu
           "decode_attn")

_LIBS: dict = {}
_LOCK = threading.Lock()


def route(t) -> str:
    """'cuda' for a CUDA tensor, whose wrapper launches the kernel;
    'cpu' for a CPU tensor and for a ``meta`` one (no data: the dry run's
    shapes), whose wrapper takes the plain version; raises for any other
    device."""
    kind = t.device.type
    if kind == "meta":
        return "cpu"
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {t.device}")
    return kind


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, force: bool = False):
    """Start nvcc for ``csrc/<name>.cu``; returns (Popen, tmp, out) or None
    when the library is already built (and ``force`` is off)."""
    out = _lib_path(name)
    if out.exists() and not force:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return log


def build(names=KERNELS, force: bool = False) -> dict:
    """Compile every named kernel library, all ``nvcc`` runs in parallel.
    Returns each build's compiler log (ptxas register and spill report);
    ``force`` rebuilds libraries that are already cached."""
    jobs = {n: _start(n, force) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items()}


def sass(name: str) -> str:
    """The SASS of the library for ``csrc/<name>.cu`` (``cuobjdump
    -sass``), building it first: the instructions of each kernel."""
    load(name)
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
