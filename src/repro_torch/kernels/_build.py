"""Build and load the CUDA kernels: nvcc into one shared library, bound with ctypes.

The sources in ``kernels/csrc/*.cu`` (and the ``*.cuh`` they include)
have a plain C interface and include no PyTorch headers, so a build
takes seconds.  :func:`load_library` builds at first use into
``<checkout>/build/repro_torch_kernels/`` — one ``nvcc -c`` per source,
all started together, then one link — and reuses the library while the
hash of the sources, headers and flags is unchanged.
A failed ``nvcc`` raises with its stderr.  Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# (name, restype, argtypes) of every C entry point; pointers and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = (
    # The margins over q blocks: the host BlockRows, q, w, the int64 row ids
    # (or NULL), R, s, the partials, the gathered ids and values (or NULLs).
    ("repro_sparse_margin", _I, (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P)),
    # The snapshot scatter: the q values pointers and nnz_l (host arrays),
    # bounds, q, coeffs, perm, starts, heavy, heavy ids, the index's
    # heavy_min, z, dim, timing (or NULL); the stream.
    ("repro_block_scatter", _I, (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P)),
    (
        "repro_prox_update",
        _I,
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P),
    ),
    # The catch-up over q blocks: the host BlockRows, q, the int64 row ids
    # (or NULL), u, w, last, z (whole), eta, m, stop, lam, lam1, lam2.
    (
        "repro_lazy_catchup",
        _I,
        (_P, _I, _P, _I, _P, _P, _P, _F, _I, _I, _F, _F, _F, _P),
    ),
    # The touched pass over q blocks: the host BlockRows, q, the step's
    # gathered ids and values, coef, w, z (and the proba update's corr;
    # whole), u, eta, lam, lam1, lam2.
    (
        "repro_lazy_touch_update",
        _I,
        (_P, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _P),
    ),
    ("repro_lazy_flush", _I, (_P, _P, _P, _I, _F, _I, _I, _F, _F, _F, _P)),
    (
        "repro_lazy_proba_update",
        _I,
        (_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _P),
    ),
    # The dense-layout step; the int before the stream of fd_matvec and
    # logistic_grad is the FLOAT_CODES code of the inputs' dtype.  fd_matvec:
    # w, D, partial, out, tickets; d, N, the row stride (64-bit), slice rows,
    # log2 of the threads along the columns, the load width.
    ("repro_fd_matvec", _I, (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P)),
    ("repro_logistic_grad", _I, (_P, _P, _P, _P, _I, _I, _P)),
    # The main path's coefficients.  A step's: s_m, the int64 row ids,
    # labels, s0, the 0-dim u, coef; u.  A snapshot's: s0, labels, coef; N,
    # the divisor.
    ("repro_logistic_step_coef", _I, (_P, _P, _P, _P, _P, _P, _I, _P)),
    ("repro_logistic_snapshot_coef", _I, (_P, _P, _P, _I, _F, _P)),
    ("repro_svrg_update", _I, (_P, _P, _P, _P, _I, _F, _F, _P)),
    ("repro_fused_update", _I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P)),
    # Decode attention: q, k, v, the three split partials, out, the
    # partials mode's m and l (or NULLs); B, Hkv, G, Dh; the k/v batch
    # stride (64-bit); the window's start, length, rows per split, splits;
    # scale, softcap (0: none); the FLOAT_CODES code; the stream.
    (
        "repro_flash_decode",
        _I,
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _F, _F, _I,
         _P),
    ),
    # The merge across ranks: m, l, acc (rank-major), out; B * Hkv, G, Dh,
    # R; the stream.
    ("repro_flash_decode_merge", _I, (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
)
MAX_BLOCKS = 128  # touched.cuh's kMaxBlocks: the blocks a BlockRows holds


class BlockRows(ctypes.Structure):
    """touched.cuh's BlockRows: q blocks' rows, passed by value to the
    margins, catch-up and touched-pass launches.  It holds raw pointers: keep the
    tensors it was built from alive as long as it is used."""

    _fields_ = [
        ("idx", _P * MAX_BLOCKS),
        ("val", _P * MAX_BLOCKS),
        ("nnz", _I * MAX_BLOCKS),
        ("lo", _I * MAX_BLOCKS),
        ("off", _I * MAX_BLOCKS),
    ]


def block_rows(kernel: str, indices, values, block_dims, dev) -> BlockRows:
    """The BlockRows of q blocks' rows: int32 ids and float32 values, each
    block's ``[N, nnz_l]`` contiguous, all with the same N, on the CUDA
    device ``dev``; block l's features start at ``sum(block_dims[:l])``.
    Raises on anything the kernels do not take (``values`` may be ``None``
    for the catch-up, which reads ids only)."""
    q = len(indices)
    if not 1 <= q <= MAX_BLOCKS:
        raise ValueError(f"{kernel}: {q} blocks, one launch takes 1 to {MAX_BLOCKS}")
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel needs CUDA tensors")
    rows = BlockRows()
    lo = off = 0
    for l, (idx, dim) in enumerate(zip(indices, block_dims, strict=True)):
        require_tensor(kernel, f"indices[{l}]", idx, torch.int32, dev, (None, None))
        n, nnz = idx.shape
        if n != indices[0].shape[0] or nnz < 1:
            raise ValueError(f"{kernel}: rows {tuple(idx.shape)} of block {l} not taken")
        if values is not None:
            require_tensor(kernel, f"values[{l}]", values[l], torch.float32, dev, (n, nnz))
            rows.val[l] = values[l].data_ptr()
        rows.idx[l], rows.nnz[l], rows.lo[l], rows.off[l] = idx.data_ptr(), nnz, lo, off
        lo, off = lo + int(dim), off + nnz
    if lo >= 2**31:
        raise ValueError(f"{kernel}: {lo} features do not fit int32")
    return rows


# The input dtypes of the kernels templated on them, as the C code numbers them.
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    """The translation units: one ``nvcc -c`` each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    """The headers the sources include (``touched.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    """The nvcc to build with: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "repro_torch CUDA kernels are built from source at first use"
    )


def source_hash() -> str:
    """Hash of the flags, the sources and the headers: a change to any of
    them names a new library, so a stale one is never loaded."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_kernels_{source_hash()}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the stderr of any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build() -> pathlib.Path:
    """Compile every source (in parallel) and link one shared library."""
    target = library_path()
    if target.exists():
        return target
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        _run_all(
            [
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                for src, obj in zip(sources(), objs)
            ]
        )
        tmp_lib = os.path.join(tmp, target.name)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, target)  # atomic: concurrent builds agree
    return target


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def require_tensor(kernel: str, name: str, t, dtype, device, shape: tuple) -> None:
    """Raise unless ``t`` has ``dtype``, lies on ``device``, is contiguous
    and matches ``shape`` (``None`` matches any extent)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def float_code(kernel: str, name: str, t) -> int:
    """The C code of ``t``'s dtype; raise unless float32 or bfloat16."""
    if t.dtype not in FLOAT_CODES:
        raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, got {t.dtype}")
    return FLOAT_CODES[t.dtype]


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
