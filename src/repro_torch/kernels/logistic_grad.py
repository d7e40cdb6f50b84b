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
"""

from __future__ import annotations

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
