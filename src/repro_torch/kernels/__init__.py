"""Hand-written CUDA kernels for ``sm_90a``, each beside its plain
PyTorch version (``csrc/`` holds the sources, :mod:`._build` compiles
them at first use).  Importing this package builds nothing."""
