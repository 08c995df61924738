"""screenpressor_tpu_torch — the SPTC codec on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package `screenpressor_tpu` (the reference, which stays
beside it): the same bitstream, byte for byte. The session classes take an
explicit device; on a CUDA device the section coder, the I-frame run walk
and the I-frame reconstruction run as the kernels in `csrc/`, on a CPU
device as their plain PyTorch versions.
"""

from screenpressor_tpu_torch.codec import TorchDecoder, TorchEncoder

__all__ = ["TorchEncoder", "TorchDecoder"]
