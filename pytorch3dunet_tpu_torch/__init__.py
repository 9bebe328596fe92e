"""PyTorch/CUDA port of pytorch3dunet_tpu for NVIDIA Hopper GPUs.

Imports torch and never jax, and nothing of the JAX package: it keeps its own
copies of the host tier it needs (config, datasets, transforms, metrics,
weights interop). Its NCDHW models (UNet3D, ResidualUNet3D, ResidualUNetSE3D)
carry the reference pytorch-3dunet state-dict keys and both predict
(`predict.py`: on CUDA the sliding window runs on the device,
`inference_device.py`; in float32 or bfloat16) and train (`train.py`). On the
GPU the 3x3x3 convolution runs on hand-written CUDA kernels, its forward on
csrc/conv3d_fwd.cu (or csrc/conv3d_im2col.cu under P3DUNET_TAPFOLD=1) and its
input gradient on csrc/conv3d_packw.cu; on the CPU it runs as plain PyTorch.
"""

from pytorch3dunet_tpu_torch.__version__ import __version__

__all__ = ["__version__"]
