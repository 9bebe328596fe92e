"""PyTorch/CUDA port of pytorch3dunet_tpu for NVIDIA Hopper GPUs.

Imports torch and never jax. Its NCDHW models carry the reference
pytorch-3dunet state-dict keys and both predict (`predict.py`) and train
(`train.py`). On the GPU the 3x3x3 convolution runs on hand-written CUDA
kernels, its forward on csrc/conv3d_fwd.cu and its input gradient on
csrc/conv3d_packw.cu; on the CPU it runs as plain PyTorch.
"""

from pytorch3dunet_tpu_torch.__version__ import __version__

__all__ = ["__version__"]
