"""svrg_update: the fused dense SVRG parameter update (L2 path).

    out = c * w - e * (g + z),   c = float32(1 - eta * lam),  e = float32(eta)

The CUDA kernel (``csrc/svrg_update.cu``, one thread per feature)
replaces the Pallas TPU kernel ``repro/kernels/svrg_update.py::svrg_update``,
which closes over ``eta`` and ``lam`` as Python floats: ``1 - eta * lam``
is reckoned in double and rounded to float32 once (JAX's weak typing),
and so it is here, on the host, never in float32 on the card.  Beside it
is :func:`svrg_update_plain`, the same expression tree in PyTorch ops (the
CPU path and the card-side yardstick); every op of the kernel rounds on
its own (``__f*_rn``), so the two agree bitwise on the card.  Float32
only, as in the reference.  ``launches`` counts the kernel's launches.

``ref.svrg_update_ref`` associates otherwise (``w - eta * (g + z + lam *
w)``); the reference's own test holds its kernel to it at rtol = atol =
1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0


def coefficients(eta: float, lam: float) -> tuple[float, float]:
    """``(float32(1 - eta * lam), float32(eta))``, the first reckoned in
    double and rounded once, as the reference's closed-over floats are."""
    return float(np.float32(1.0 - eta * lam)), float(np.float32(eta))


def svrg_update_plain(
    w: torch.Tensor, g: torch.Tensor, z: torch.Tensor, eta: float, lam: float
) -> torch.Tensor:
    """The plain PyTorch version, op for op the kernel's."""
    c, e = coefficients(eta, lam)
    return c * w - e * (g + z)


def svrg_update(
    w: torch.Tensor,  # float32[d]
    g: torch.Tensor,  # float32[d]
    z: torch.Tensor,  # float32[d]
    eta: float,
    lam: float,
) -> torch.Tensor:  # float32[d], a new tensor
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.  ``eta`` and ``lam`` are host floats, so the
    call never waits on the card.
    """
    global launches
    if not w.is_cuda:
        raise ValueError("svrg_update: the CUDA kernel needs CUDA tensors")
    dev = w.device
    _build.require_tensor("svrg_update", "w", w, torch.float32, dev, (None,))
    (d,) = w.shape
    _build.require_tensor("svrg_update", "g", g, torch.float32, dev, (d,))
    _build.require_tensor("svrg_update", "z", z, torch.float32, dev, (d,))
    c, e = coefficients(eta, lam)
    out = torch.empty_like(w)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_svrg_update(
            w.data_ptr(), g.data_ptr(), z.data_ptr(), out.data_ptr(), d, c, e, stream
        )
    _build.check(rc, "svrg_update")
    launches += 1
    return out
