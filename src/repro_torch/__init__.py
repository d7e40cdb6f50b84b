"""repro_torch — the PyTorch + CUDA port of the FD-SVRG reproduction.

Each module sits at the same relative path as its JAX reference in
``repro`` (``core/``, ``data/``, ``dist/``, ``optim/``, ``kernels/``,
``configs/``), so the two are paired mechanically in the tests.  The
package imports ``torch`` and ``numpy`` only; it never imports ``jax`` or
``repro``.

Entry points (:func:`repro_torch.core.fdsvrg.run_fdsvrg`,
:func:`repro_torch.core.fdsvrg.run_serial_svrg`) run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor the kernel wrappers
in :mod:`repro_torch.kernels.ops` launch the hand-written Hopper kernels
(``kernels/csrc/*.cu``) and never fall back to the plain PyTorch version.
"""
