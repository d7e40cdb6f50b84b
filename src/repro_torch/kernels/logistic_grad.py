"""logistic_grad: the fused logistic loss and margin derivative.

    z = -y*s, zpos = max(z, 0), ez = exp(z - zpos), e0 = exp(-zpos)
    loss = zpos + log(e0 + ez),  dloss = -y * (ez / (e0 + ez))

The CUDA kernel (``csrc/logistic_grad.cu``, one thread per element)
replaces the Pallas TPU kernel
``repro/kernels/logistic_grad.py::logistic_grad`` and computes that
kernel's expression (not ``ref.logistic_grad_ref``'s ``logaddexp``),
sharing the exp between the two outputs.  ``s`` and ``y`` are float32 or
bfloat16, converted to float32 first; both outputs are float32.  The
kernel masks its own tail, so nothing is padded.  Beside it is
:func:`logistic_grad_plain`, the same expression in PyTorch ops (the CPU
path and the card-side yardstick).  Stated tolerance, kernel vs plain on
the card: within 4 ulp of ``max(|plain|, 1)`` for both outputs (``expf`` /
``logf`` against PyTorch's ``exp`` / ``log``; ``log(1 + tiny)`` turns one
ulp of the sum into an absolute error).  ``launches`` counts the kernel's
launches.

The FD-SVRG main path uses the derivative as a step's and a snapshot's
coefficients, each one launch of the same source's second kernel
(:func:`step_coef`, :func:`snapshot_coef`):

    step:     coef[i]   = (dl(s_m[i], y) - dl(s0[ids[i]], y)) / u,  y = labels[ids[i]]
    snapshot: coeffs[i] = dl(s0[i], labels[i]) / N

with ``dl(s, y) = -y * sigmoid(-y * s)``, the port's logistic derivative
(``core/losses.py``) op for op, not this kernel's ``ez / (e0 + ez)``.
Their plain versions (:func:`step_coef_plain`, :func:`snapshot_coef_plain`,
given the loss's ``dvalue``) are the chains of PyTorch ops the path ran
before, with the divisions true float32 divisions by a 0-dim tensor; the
kernels compute them op for op (PyTorch's CUDA sigmoid is ``1 / (1 +
expf(-x))``), so on the card they are held bit for bit.  They count in
``launches`` too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0


def logistic_grad_plain(
    s: torch.Tensor, y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, op for op the kernel's."""
    s, y = s.float(), y.float()
    z = -y * s
    zpos = torch.clamp_min(z, 0.0)
    ez = torch.exp(z - zpos)
    e0 = torch.exp(-zpos)
    return zpos + torch.log(e0 + ez), -y * (ez / (e0 + ez))


def logistic_grad(
    s: torch.Tensor,  # float32 or bfloat16 [N]
    y: torch.Tensor,  # same dtype [N]
) -> tuple[torch.Tensor, torch.Tensor]:  # float32 [N] loss, dloss
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.
    """
    global launches
    if not s.is_cuda:
        raise ValueError("logistic_grad: the CUDA kernel needs CUDA tensors")
    dev = s.device
    code = _build.float_code("logistic_grad", "s", s)
    _build.require_tensor("logistic_grad", "s", s, s.dtype, dev, (None,))
    (n,) = s.shape
    _build.require_tensor("logistic_grad", "y", y, s.dtype, dev, (n,))
    loss = torch.empty((n,), dtype=torch.float32, device=dev)
    dloss = torch.empty_like(loss)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_logistic_grad(
            s.data_ptr(), y.data_ptr(), loss.data_ptr(), dloss.data_ptr(), n, code, stream
        )
    _build.check(rc, "logistic_grad")
    launches += 1
    return loss, dloss


def step_coef_plain(
    s_m: torch.Tensor,  # [u] the step's margins
    ids: torch.Tensor,  # int64[u] the step's rows
    labels: torch.Tensor,  # [N]
    s0: torch.Tensor,  # [N] the snapshot's margins
    u_t: torch.Tensor,  # 0-dim, u
    dvalue: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # the loss's derivative
) -> torch.Tensor:  # [u]
    """The step's coefficients as PyTorch ops: two gathers, the two
    derivatives, a subtraction and a true division by ``u_t``; with the
    logistic loss's ``dvalue``, the kernel's function."""
    y = labels[ids]
    return (dvalue(s_m, y) - dvalue(s0[ids], y)) / u_t


def snapshot_coef_plain(
    s0: torch.Tensor,  # [N] the snapshot's margins
    labels: torch.Tensor,  # [N]
    n: int,
    dvalue: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # the loss's derivative
) -> torch.Tensor:  # [N]
    """The snapshot's coefficients as PyTorch ops: the derivative, then a
    true float32 division by ``n`` on every device (by a 0-dim tensor: a
    CUDA tensor divided by a Python scalar is multiplied by the reciprocal
    instead)."""
    return dvalue(s0, labels) / torch.full((), float(n), dtype=s0.dtype, device=s0.device)


def _launch_coef(entry: str, dev: torch.device, *args) -> None:
    global launches
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "logistic_grad")
    launches += 1


def step_coef(
    s_m: torch.Tensor,  # float32[u]
    ids: torch.Tensor,  # int64[u], each in [0, N) (not checked)
    labels: torch.Tensor,  # float32[N]
    s0: torch.Tensor,  # float32[N]
    u_t: torch.Tensor,  # float32 0-dim, u: the kernel reads it on the card
) -> torch.Tensor:  # float32[u]
    """One launch for a step's coefficients on
    ``torch.cuda.current_stream()``; raises on a CPU tensor, another dtype,
    a shape mismatch or a non-contiguous tensor."""
    if not s_m.is_cuda:
        raise ValueError("logistic_grad: the CUDA kernel needs CUDA tensors")
    dev = s_m.device
    _build.require_tensor("logistic_grad", "s_m", s_m, torch.float32, dev, (None,))
    (u,) = s_m.shape
    _build.require_tensor("logistic_grad", "ids", ids, torch.int64, dev, (u,))
    _build.require_tensor("logistic_grad", "labels", labels, torch.float32, dev, (None,))
    _build.require_tensor("logistic_grad", "s0", s0, torch.float32, dev, labels.shape)
    _build.require_tensor("logistic_grad", "u_t", u_t, torch.float32, dev, ())
    coef = torch.empty((u,), dtype=torch.float32, device=dev)
    _launch_coef("repro_logistic_step_coef", dev, s_m.data_ptr(), ids.data_ptr(),
                 labels.data_ptr(), s0.data_ptr(), u_t.data_ptr(), coef.data_ptr(), u)
    return coef


def snapshot_coef(
    s0: torch.Tensor,  # float32[N]
    labels: torch.Tensor,  # float32[N]
    n: int,  # the divisor N, rounded to float32 as the plain version's 0-dim tensor is
) -> torch.Tensor:  # float32[N]
    """One launch for a snapshot's coefficients; raises as
    :func:`step_coef`."""
    if not s0.is_cuda:
        raise ValueError("logistic_grad: the CUDA kernel needs CUDA tensors")
    dev = s0.device
    _build.require_tensor("logistic_grad", "s0", s0, torch.float32, dev, (None,))
    _build.require_tensor("logistic_grad", "labels", labels, torch.float32, dev, s0.shape)
    coef = torch.empty(s0.shape, dtype=torch.float32, device=dev)
    _launch_coef("repro_logistic_snapshot_coef", dev, s0.data_ptr(), labels.data_ptr(),
                 coef.data_ptr(), s0.shape[0], float(np.float32(n)))
    return coef
