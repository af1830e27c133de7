"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel ships, mirroring the JAX package's kernel layout:
  csrc/*.cu  — the CUDA source with a plain C entry point
  kernel.py  — ctypes launcher: checks, allocation, launch count
  ops.py     — model-layout wrapper: the kernel on a CUDA tensor, the
               plain version on a CPU tensor
  ref.py     — plain PyTorch version, held against the JAX oracle in the
               CPU tests and against the kernel on the card
``build.py`` compiles the sources with nvcc at first use.
"""
