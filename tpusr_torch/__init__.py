"""tpusr_torch: the PyTorch and CUDA port of tpusr for an NVIDIA H100.

The JAX package ``tpusr`` is the reference; this package imports nothing from
it and no JAX. Layouts at every public function are the JAX package's (NHWC
activations, HWIO conv kernels). Entry points run on CUDA unless the caller
passes ``device="cpu"``; the hand-written kernels (``core/conv3x3.py``) fall
to their plain PyTorch twins only for CPU tensors.
"""

from tpusr_torch.device import resolve_device

__all__ = ["resolve_device"]
