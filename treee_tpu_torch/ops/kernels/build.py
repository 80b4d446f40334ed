"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library with
a plain C interface, at first use, and loaded with ctypes.  The library lands
in ``build/treee_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a second process reuses it and an edited source
rebuilds it.  Nothing here runs when the module is imported.

Every kernel is compiled for ``sm_90a`` (H100) with ``-fmad=false``: the
wrappers promise outputs that equal their plain PyTorch versions bit for bit,
and torch's eager ops never contract ``a*b+c`` into an FMA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "treee_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "--threads=0",
    "-shared",
    "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``.  Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_command(out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtreee_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent).

    The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``<name>.log``."""
    path = _library_path()
    if path.exists():
        return path, 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(tmp, nvcc), capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)
    return path, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.treee_cc_sweep.argtypes = [p, p, p, i, i, i, p]
    lib.treee_cc_sweep.restype = i
    lib.treee_match_scan.argtypes = [p, p, i, i, i, i, f, p, p, p, p]
    lib.treee_match_scan.restype = i
    lib.treee_seg_cummax.argtypes = [p, p, p, ll, i, p, p]
    lib.treee_seg_cummax.restype = i
    lib.treee_seg_cummax_scratch_bytes.argtypes = [ll, i]
    lib.treee_seg_cummax_scratch_bytes.restype = ll
    lib.treee_dilate.argtypes = [p, p, p, p, p, i, i, i, f, f, f, f, p]
    lib.treee_dilate.restype = i
    lib.treee_dilate_passes_per_launch.argtypes = []
    lib.treee_dilate_passes_per_launch.restype = i
    lib.treee_eye_dome.argtypes = [p, p, p, i, i, f, f, f, f, f, f, f, p]
    lib.treee_eye_dome.restype = i
    lib.treee_seg_cumsum.argtypes = [p, p, p, ll, i, i, p, p]
    lib.treee_seg_cumsum.restype = i
    lib.treee_seg_cumsum_scratch_bytes.argtypes = [ll, i, i]
    lib.treee_seg_cumsum_scratch_bytes.restype = ll
    lib.treee_jump_flood.argtypes = [p, p, p, p, p, p, p, i, i, p]
    lib.treee_jump_flood.restype = i
    lib.treee_take_along.argtypes = [p, p, p, i, i, i, i, p]
    lib.treee_take_along.restype = i
    lib.treee_error_string.argtypes = [i]
    lib.treee_error_string.restype = ctypes.c_char_p
    return lib


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (a view into a
    larger tensor may not), as kernels that move 16 bytes an access need."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        msg = library().treee_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
