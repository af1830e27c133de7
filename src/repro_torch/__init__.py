"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The layout mirrors ``repro`` module for module, so each counterpart sits
where a reader expects it.  The numpy control plane (``core``, ``sched``,
``obs`` and the serving engine under ``serve``) is a verbatim copy with
only the import prefix changed; the compute under it (``models``,
``kernels``, ``train``, the model backend in ``serve/paged.py`` and the
serving CLI in ``launch/serve.py``) is written for PyTorch.  Hand-written
CUDA kernels live under ``kernels/*/csrc`` and are built with ``nvcc`` at
first use (``kernels/build.py``).

This package imports neither ``jax`` nor anything of ``repro``.
"""
