"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc into one shared library with a plain C
interface and loaded with ctypes. The build runs at first use, one nvcc per
source started together, into ``ws3d_tpu_torch/_build/<hash of the sources
and flags>/``, so a fresh checkout needs nothing but the CUDA toolkit.

Every wrapper in ``ws3d_tpu_torch.ops`` follows one contract: on a CPU tensor
it runs its plain PyTorch version; on a CUDA tensor it checks device, dtype,
shape and contiguity and calls ``launch``, which launches its kernel on the
current stream inside the span ``kernel.<name>``, raises if the launch was
refused, and adds one to its entry in ``LAUNCHES``. Nothing falls back from
the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ws3d_tpu_torch.utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libws3d_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel; the wrappers add one where they launch, nowhere else
# (the bf16 modes of kernels 2, 3, 9 and 4, and the rounded-layer bf16 mode
# of kernels 2 and 3, under names of their own)
LAUNCHES = {"fps": 0, "fused_sa_window": 0, "fused_sa_full": 0,
            "three_interpolate": 0, "crop_gather": 0, "ball_query": 0,
            "three_nn": 0, "fused_sa_idx": 0, "ball_query_wrap": 0,
            "three_interpolate_window": 0, "crop_gather_window": 0,
            "fused_sa_window_bf16": 0, "fused_sa_full_bf16": 0,
            "fused_sa_idx_bf16": 0, "three_interpolate_bf16": 0,
            "fused_sa_window_bf16r": 0, "fused_sa_full_bf16r": 0,
            "greedy_sweep": 0, "bn_relu": 0, "bn_relu_sums": 0,
            "bn_relu_dx": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "ws3d_fps": [_P, _I, _I, _I, _P, _P, _P],
    "ws3d_fused_sa": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P,
                      _P, _P, _P],
    "ws3d_fused_sa_idx": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _I, _P],
    "ws3d_fused_sa_resident": [_I, _I, _I, _I, _P],
    "ws3d_three_interpolate": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "ws3d_three_interpolate_window": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                      _P],
    "ws3d_crop_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P,
                         _P, _P],
    "ws3d_ball_query": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "ws3d_ball_query_wrap": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "ws3d_three_nn": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "ws3d_greedy_sweep": [_P, _P, _F, _I, _I, _P, _P, _P],
    "ws3d_bn_relu_forward": [_P, _P, _P, _P, _P, _L, _I, _P, _P],
    "ws3d_bn_relu_sums": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P],
    "ws3d_bn_relu_dx": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _P, _P],
}


# points a chunk of the pruned searches (csrc/common.cuh:kChunk)
CHUNK = 32


def chunk_bounds_workspace(pts: torch.Tensor) -> torch.Tensor:
    """The (R, ceil(n / CHUNK), 2) f32 workspace into which a kernel's
    pre-pass writes the z range of each CHUNK-point chunk of the (R, n, 3)
    cloud `pts`."""
    R, n, _ = pts.shape
    return torch.empty((R, (n + CHUNK - 1) // CHUNK, 2), dtype=torch.float32,
                       device=pts.device)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the .so."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    srcs, _ = _sources()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp / LIB_NAME)] + [str(tmp / (s.stem + ".o"))
                                           for s in srcs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():      # lost a race only if the winner built it
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ws3d_error_string.argtypes = [ctypes.c_int]
        lib.ws3d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (None in `shape` matches any size)."""
    if not t.is_cuda or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: expected a tensor on the current CUDA "
                         f"device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, entry: str, *args) -> None:
    """Call the library's `entry` with `args` inside the span
    kernel.<name>, raise if the launch was refused, and add one to
    LAUNCHES[name]."""
    fn = getattr(library(), entry)
    with span("kernel." + name):
        rc = fn(*args)
    raise_on_error(rc, name)
    LAUNCHES[name] += 1


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = library().ws3d_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({msg})")
