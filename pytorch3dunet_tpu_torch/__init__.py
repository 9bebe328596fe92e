"""PyTorch/CUDA port of pytorch3dunet_tpu for NVIDIA Hopper GPUs.

Imports torch and never jax. Its NCDHW models carry the reference
pytorch-3dunet state-dict keys; the 3x3x3 convolution runs as a hand-written
CUDA kernel (csrc/conv3d_fwd.cu) on the GPU and as plain PyTorch on the CPU.
"""

from pytorch3dunet_tpu_torch.__version__ import __version__

__all__ = ["__version__"]
