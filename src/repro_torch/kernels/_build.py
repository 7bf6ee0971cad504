"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` holds plain ``extern "C"`` launchers (no
PyTorch headers), so one ``nvcc`` per source takes seconds.  Sources
are compiled at first use, all at once (one ``nvcc`` process per
source, started together), into ``build/repro_torch_kernels/`` at the
root of the checkout.  A library's file name carries a hash of its
source, of every shared header (``csrc/*.cuh``, which a source may
include) and of the flags, and is written under a temporary name and
then ``os.replace``d into place, so concurrent processes never load a
half-written library and a changed source or header is rebuilt.

Nothing here catches a failed build: a missing ``nvcc`` or a compile
error raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("minskew", "hub_route", "flash_attention", "flash_attention_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90",
           "flash_attention_bwd_tf32x3", "flash_attention_tf32x3",
           "decode_attention", "rglru_scan", "rglru_scan_bwd", "mlstm_kernel",
           "mlstm_kernel_sm90", "mlstm_kernel_tf32x3", "mlstm_kernel_bwd",
           "mlstm_kernel_bwd_sm90",
           "mlstm_kernel_bwd_tf32x3", "launch_floor")


class KernelArgumentError(ValueError):
    """A kernel wrapper refused its tensors (device, shape, layout).  A
    ``ValueError``, as the wrappers raised before it, so callers that
    catch that behave as before; its own type lets a caller that falls
    back on a ``ValueError`` of the simulator's surface tell the two
    apart."""


def grad_wanted(*tensors) -> bool:
    """Grad mode on and an input (None allowed) that requires grad: where
    a wrapper goes through its ``torch.autograd.Function``."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where autograd would differentiate
    through a kernel that has no backward: grad mode on and an input that
    requires grad.  A kernel's output has no ``grad_fn``, so without this
    the gradient of everything upstream would be dropped silently.  For
    CUDA tensors only: the CPU's plain versions stay differentiable.
    Only ``decode_attention`` has no backward: nothing trains through
    decode (ROADMAP A8.2 gave the recurrences theirs)."""
    if grad_wanted(*tensors):
        raise NotImplementedError(
            f"{what}: no backward kernel on the card (nothing trains "
            f"through it; ROADMAP A8.2); run under torch.no_grad() or "
            f"inference_mode, or on the CPU")


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``torch.utils.cpp_extension.CUDA_HOME``/bin, then
    ``$CUDA_HOME``/bin, then ``PATH``."""
    from torch.utils import cpp_extension

    for home in (cpp_extension.CUDA_HOME, os.environ.get("CUDA_HOME")):
        if home:
            cand = pathlib.Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in torch's CUDA_HOME, $CUDA_HOME/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> List[pathlib.Path]:
    """Compile every source whose library is missing, in parallel;
    returns the library paths.  Raises on any compile error."""
    paths = [_lib_path(n) for n in SOURCES]
    todo = [(n, p) for n, p in zip(SOURCES, paths) if not p.is_file()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed "
                          f"(rc {proc.returncode}):\n{out.decode()}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def stream_ptr(torch, device) -> int:
    """The cudaStream_t of ``device``'s current stream, as an int: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, read with
    the accessor PyTorch's own generated kernels use, without building a
    ``Stream`` object on every call (the engine's kernels are launched
    once a round, and their host path is the round's cost)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
