"""Hand-written CUDA kernels of the port, one sub-package per kernel.

Each has a ``csrc/`` directory with the CUDA sources, a ``kernel.py``
binding, an ``ops.py`` wrapper with the public entry point and a
``ref.py`` plain-torch version.  Sources are compiled at first launch
(:mod:`repro_torch.kernels._build`), never at import.
"""
