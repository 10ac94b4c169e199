"""PyTorch/CUDA port of the QUOKA reproduction (``src/repro`` is the JAX
reference).

The port keeps the reference's module layout: each file here has one
counterpart of the same relative path under ``src/repro``.  It imports
``torch`` and numpy only.  Entry points (``models.model.build_model``,
``serving.engine.Engine``, ``launch.serve``) run on the CUDA card unless the
caller passes ``device="cpu"``; with no card and no explicit CPU request
they raise.  The hot-path kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``); on CPU tensors their wrappers run the plain PyTorch
versions in ``kernels/ref.py``.
"""
