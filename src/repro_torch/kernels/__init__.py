"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions; :mod:`repro_torch.kernels.ops` is the public surface.
Importing this package builds nothing: the kernels are compiled at their
first launch (:mod:`repro_torch.kernels._build`)."""
