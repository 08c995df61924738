"""screenpressor_tpu_torch — the SPTC codec on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package `screenpressor_tpu` (the reference, which stays
beside it): the same bitstream, byte for byte. `Encoder` / `Decoder` are the
host-facing sessions (pixel formats, the format prefix, the crash latch);
`TorchEncoder` / `TorchDecoder` the RGB24 sessions beneath them. Every
session runs on device "cuda" unless the caller asks for the CPU; on a CUDA
device the section coder, the I-frame run walk and the I-frame
reconstruction run as the kernels in `csrc/`, on a CPU device as their plain
PyTorch versions.
"""

from screenpressor_tpu_torch.api import Decoder, Encoder, FormatParams, PixelFormat
from screenpressor_tpu_torch.codec import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch.config import CodecConfig

__all__ = ["CodecConfig", "Encoder", "Decoder", "PixelFormat", "FormatParams",
           "TorchEncoder", "TorchDecoder"]
