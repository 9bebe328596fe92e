"""3x3x3 stride-1 pad-1 convolution: the hand-written Hopper kernel and its plain version.

`conv3d_fwd` keeps the contract of the JAX package's Pallas kernel
(pytorch3dunet_tpu/ops/conv_pallas.py `conv3d_fwd`): x (N, D, H, W, C)
channels-last, w (3, 3, 3, C, F), b (F,) or None -> (N, D, H, W, F) in x's
dtype, f32 accumulation, bias fused. A CUDA tensor goes to the kernel in
`csrc/conv3d_fwd.cu` or raises; a CPU tensor goes to the plain version,
`conv3d_fwd_reference`. There is no backward yet: a CUDA call that would need
one raises.

`Conv3d` is the model's conv layer (NCDHW in and out, torch weight layout). It
runs every 3x3x3 pad-1 conv through `conv3d_fwd`, and the 1x1 `final_conv`
through plain `F.conv3d`, as the JAX package computes that conv outside any
Pallas kernel.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = {torch.float32: "conv3d_fwd_f32", torch.bfloat16: "conv3d_fwd_bf16"}

# set only inside `plain_conv()`
_force_plain = False


@contextlib.contextmanager
def plain_conv():
    """Runs every `Conv3d` through the plain version, whatever the device.

    For tests and for comparing a whole forward with and without the kernel;
    no CLI path enters it."""
    global _force_plain
    previous, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = previous


def _check(x, w, b):
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_fwd: x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 5:
        raise ValueError(f"conv3d_fwd: x must be (N, D, H, W, C), got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if w.ndim != 5 or tuple(w.shape[:4]) != (3, 3, 3, C):
        raise ValueError(f"conv3d_fwd: w must be (3, 3, 3, {C}, F), got shape {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"conv3d_fwd: b must be ({w.shape[-1]},), got shape {tuple(b.shape)}")
    for name, t in (("w", w), ("b", b)):
        if t is not None and not t.is_floating_point():
            raise TypeError(f"conv3d_fwd: {name} must be floating point, got {t.dtype}")
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3d_fwd: {name} is on {t.device}, x on {x.device}")


def conv3d_fwd_reference(x, w, b=None):
    """Plain version of `conv3d_fwd`, same contract: `w` and `b` are cast to
    x's dtype, then `F.conv3d` runs in float32 on permuted views and the result
    is cast back once (the kernel's f32 accumulation and single rounding)."""
    _check(x, w, b)
    w = w.to(x.dtype).float()
    bias = None if b is None else b.to(x.dtype).float()
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), bias, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_fwd(x, w, b=None):
    """Fused 3x3x3 conv forward on (N, D, H, W, C) -> (N, D, H, W, F).

    `b=None` means zeros; `w` and `b` are cast to x's dtype. On CUDA the
    hand-written kernel runs, on the current stream; on the CPU the plain
    version does."""
    if x.device.type == "cpu":
        return conv3d_fwd_reference(x, w, b)
    _check(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_fwd: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise NotImplementedError("conv3d_fwd has no backward yet: call it under torch.no_grad() "
                                  "or torch.inference_mode()")
    if not x.is_contiguous():
        raise ValueError("conv3d_fwd: x must be contiguous (N, D, H, W, C)")
    N, D, H, W, C = x.shape
    Fo = w.shape[-1]
    w = w.to(x.dtype).contiguous()
    b = torch.zeros(Fo, dtype=x.dtype, device=x.device) if b is None else b.to(x.dtype).contiguous()
    y = torch.empty((N, D, H, W, Fo), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.load("conv3d_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), N, D, H, W, C, Fo, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_fwd kernel launch failed for x {tuple(x.shape)} {x.dtype}, F={Fo}: "
                           f"{lib.conv3d_error_string(err).decode()} (cudaError {err})")
    conv3d_fwd.launches += 1
    return y


# launches of the CUDA kernel since the last reset (callers set it to 0)
conv3d_fwd.launches = 0


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` (torch weight layout and init) on NCDHW tensors whose
    3x3x3 pad-1 forward is `conv3d_fwd`.

    The kernel reads the NDHWC view of x: a copy when x is not channels-last
    in memory (`input_copies` counts those copies). Kernel 1 / padding 0 runs
    `F.conv3d`."""

    # layout copies made for the kernel's NDHWC input since the last reset
    input_copies = 0

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, padding: int = 1,
                 bias: bool = True):
        if (kernel_size, padding) not in ((3, 1), (1, 0)):
            raise NotImplementedError(f"Conv3d supports kernel 3 / padding 1 and kernel 1 / padding 0, "
                                      f"got kernel {kernel_size} / padding {padding}")
        super().__init__(in_channels, out_channels, kernel_size, padding=padding, bias=bias)

    def forward(self, x):
        if self.kernel_size == (1, 1, 1):
            return F.conv3d(x, self.weight, self.bias)
        x_cl = x.permute(0, 2, 3, 4, 1)
        if not x_cl.is_contiguous():
            x_cl = x_cl.contiguous()
            Conv3d.input_copies += 1
        fn = conv3d_fwd_reference if _force_plain else conv3d_fwd
        y = fn(x_cl, self.weight.permute(2, 3, 4, 1, 0), self.bias)
        return y.permute(0, 4, 1, 2, 3)
