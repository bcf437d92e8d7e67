"""Build, load and launch the port's CUDA kernels (``pvn3d_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers, so
a build takes seconds.  Libraries go to ``<checkout>/build/kernels/``
(listed in ``.gitignore``), named by a hash of the source and the flags, so
a changed source rebuilds and an unchanged one is reused.  The build
happens at first use; ``build_all`` starts one ``nvcc`` per source at once.
Variants of one kernel (K2's capacity, expanded and bf16 instances, K3's
expanded one) are separate ``CudaKernel`` objects, each with its own
launch count, over one source and so one library.

Every C entry point returns ``cudaGetLastError()`` after its launch; a
nonzero code raises here.  Nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Iterable, List, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One CUDA source, its C entry point, and a count of its launches.

    ``launches`` grows by one in ``launch`` and nowhere else, so a run can
    show that its path went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.symbol = symbol
        # Every entry point takes the stream last.
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        self._lib = None

    def lib_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR,
                            f"lib{stem}-{digest.hexdigest()[:16]}.so")

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists.
        Returns the running process (or None) and the target path."""
        target = self.lib_path()
        if os.path.exists(target):
            return None, target
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, target

    def load(self):
        if self._fn is None:
            build_all([self])
            self._lib = ctypes.CDLL(self.lib_path())
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def library_function(self, name: str):
        """Another C function of this kernel's library, built and loaded
        first; the caller sets its argtypes and restype."""
        self.load()
        return getattr(self._lib, name)

    def launch(self, device: torch.device, *args) -> None:
        """Launch on the current stream of ``device``; raise on any error
        the launch reports."""
        fn = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = fn(*args, stream)
        self.launches += 1
        if code != 0:
            msg = self._lib.kernel_error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel: CUDA error {code}: "
                               f"{msg}")


def build_all(kernels: Iterable[CudaKernel]) -> List[str]:
    """Build every kernel's library that is missing, all ``nvcc`` runs at
    once.  Returns each build's compiler output (ptxas register and
    shared-memory report); raises if any build fails."""
    # One build per library: the variants of a kernel share theirs.
    unique = {k.lib_path(): k for k in kernels}
    started = [(k,) + k.start_build() for k in unique.values()]
    logs = []
    failed = []
    for kernel, proc, target in started:
        if proc is None:
            continue
        out, _ = proc.communicate()
        tmp = f"{target}.tmp{os.getpid()}"
        if proc.returncode != 0:
            failed.append(f"{kernel.name}: nvcc exit {proc.returncode}\n"
                          f"{out}")
            continue
        os.replace(tmp, target)
        logs.append(f"{kernel.name}:\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The CUDA device all ``tensors`` lie on; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got "
                         f"{dev}")
    return dev


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last (xyz) axis, broadcasting, in the
    direct form ((dx*dx)+(dy*dy))+(dz*dz) that every kernel computes by
    default (the expanded form's cancellation moves radius and bandwidth
    boundaries)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def sqnorm(a: torch.Tensor) -> torch.Tensor:
    """((x*x)+(y*y))+(z*z) over the last axis."""
    return (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) \
        + a[..., 2] * a[..., 2]


def sqdist_expanded(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(B, r, 3), (B, c, 3) -> (B, r, c) squared distances in the expanded
    form of the JAX package's XLA arms and its Pallas ball query,
    ``(|a|^2 - 2 a.b) + |b|^2`` with ``a`` the row (centroid or unknown
    point) and ``b`` the column, each norm and the dot product
    ((x*x)+(y*y))+(z*z): elementwise float32 operations in the order the
    kernels' expanded instances repeat with round-to-nearest intrinsics,
    never a matmul.  It can be negative for coincident points."""
    a = rows[:, :, None, :]
    b = cols[:, None, :, :]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]
    return (sqnorm(rows)[:, :, None] - 2.0 * cross) + sqnorm(cols)[:, None, :]
