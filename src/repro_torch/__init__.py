"""repro_torch — the PyTorch + CUDA port of the FD-SVRG reproduction.

Each module sits at the same relative path as its JAX reference in
``repro`` (``core/``, ``data/``, ``dist/``, ``optim/``, ``kernels/``,
``configs/``, and for LM serving ``models/``, ``train/``, ``launch/``,
``sharding/``), so the two are paired mechanically in the tests.  The
package imports ``torch`` and ``numpy`` only; it never imports ``jax`` or
``repro``.

Entry points (:func:`repro_torch.core.fdsvrg.run_fdsvrg`,
:func:`repro_torch.core.fdsvrg.run_serial_svrg`, the paper's baselines
:func:`repro_torch.core.baselines.run_dsvrg`, ``run_syn_svrg``,
``run_asy_svrg`` and ``run_pslite_sgd``, the rules of
:data:`repro_torch.optim.update_rules.RULES` under ``run_with_rule``, and
``python -m repro_torch.launch.serve``) run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"``, ``--device cpu``); on a CUDA tensor
the kernel wrappers in :mod:`repro_torch.kernels.ops` launch the
hand-written Hopper kernels (``kernels/csrc/*.cu``) and never fall back
to the plain PyTorch version.
"""
