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
import struct
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
    for src in sources() + sorted(CSRC.glob("*.cuh")):
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


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# the entry points that launch kernels: their arguments, the stream last
LAUNCHERS = {
    "treee_cc_sweep": [_P, _P, _P, _I, _I, _I, _P],
    "treee_match_scan": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    "treee_seg_cummax": [_P, _P, _P, _LL, _I, _P, _P],
    "treee_dilate": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "treee_eye_dome": [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    "treee_seg_cumsum": [_P, _P, _P, _LL, _I, _I, _P, _P],
    "treee_jump_flood": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "treee_jump_flood_grid": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "treee_take_along": [_P, _P, _P, _I, _I, _I, _I, _P],
    "treee_nearest_slot": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "treee_knn_select": [_P, _P, _P, _P, _I, _I, _P],
}
_STRUCT_CODES = {_P: "P", _I: "i", _F: "f", _LL: "q"}
_one_device = False     # one CUDA device: a tensor there is on the current one


def packer(argtypes):
    """``pack(*args) -> bytes``: the arguments laid out as a C struct of
    these ctypes types, the layout ``csrc/packed.cuh`` reads."""
    return struct.Struct("@" + "".join(map(_STRUCT_CODES.get, argtypes))).pack


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call.

    Each launching entry point ``treee_x`` carries ``.packed``: its twin
    ``treee_x_packed`` (``csrc/packed.cuh``) and the ``struct`` packer of
    its arguments, which :func:`launch` calls instead.  The twins keep the
    GIL (``PyDLL``): a launch returns within microseconds, and giving the
    GIL up and taking it back would cost a tenth of that."""
    global _one_device
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    held = ctypes.PyDLL(str(path))
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
        fn.packed = (getattr(held, name + "_packed"), packer(argtypes))
    _one_device = torch.cuda.device_count() == 1
    lib.treee_seg_cummax_scratch_bytes.argtypes = [_LL, _I]
    lib.treee_seg_cummax_scratch_bytes.restype = _LL
    for name in ("treee_dilate_passes_per_launch", "treee_dilate_core_rows",
                 "treee_dilate_core_cols"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    lib.treee_seg_cumsum_scratch_bytes.argtypes = [_LL, _I, _I]
    lib.treee_seg_cumsum_scratch_bytes.restype = _LL
    lib.treee_jump_flood_clusters.argtypes = [_I, _I]
    lib.treee_jump_flood_clusters.restype = _I
    lib.treee_error_string.argtypes = [_I]
    lib.treee_error_string.restype = ctypes.c_char_p
    return lib


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.is_cuda:
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
    """Raw handle of PyTorch's current stream on ``t``'s device (no
    ``Stream`` object is made)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(fn, name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` of :data:`LAUNCHERS`
    on PyTorch's current stream of CUDA tensor ``t``'s device, made the
    current device for the call where it is not, and raise on the CUDA
    error it returns.  The arguments go packed in one buffer (``fn.packed``):
    one pointer crosses ctypes instead of a conversion per argument."""
    packed, pack = fn.packed
    index = t.get_device()
    if _one_device or index == torch._C._cuda_getDevice():
        err = packed(pack(*args, torch._C._cuda_getCurrentRawStream(index)))
    else:
        with torch.cuda.device(index):
            err = packed(pack(*args,
                              torch._C._cuda_getCurrentRawStream(index)))
    if err:
        check(err, name)


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        msg = library().treee_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
