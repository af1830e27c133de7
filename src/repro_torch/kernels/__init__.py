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
import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would record a call of ``kernel``.  A launcher
    fills its outputs through ``ctypes``, so they carry no ``grad_fn``
    and a backward through a bare launch would drop the gradient without
    a word.  Every launcher calls this first, before it looks at shapes
    or the device.  Where a kernel has a backward (the RMSNorm family),
    its op wraps the launchers in a ``torch.autograd.Function``, whose
    forward runs with grad off and so passes this check."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad while grad "
            f"is enabled (run it under torch.no_grad() or "
            f"torch.inference_mode(), or take the plain version)")
