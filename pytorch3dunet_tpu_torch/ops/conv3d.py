"""3x3x3 stride-1 pad-1 convolution: the hand-written Hopper kernels, their
plain versions, and the conv's autograd.

`conv3d_fwd` keeps the contract of the JAX package's Pallas kernel
(pytorch3dunet_tpu/ops/conv_pallas.py `conv3d_fwd`): x (N, D, H, W, C)
channels-last, w (3, 3, 3, C, F), b (F,) or None -> (N, D, H, W, F) in x's
dtype, f32 accumulation, bias fused. Its `variant` names the Pallas tiling; on
CUDA each tiling is its own kernel:
- "roll" (K2) -> `csrc/conv3d_fwd.cu`, the conv forward by default, handed
  the weights K-major (`kmajor_weight`);
- "im2col" (K1) -> `csrc/conv3d_im2col.cu`, the tap-folded forward: every conv
  with F >= 64 when P3DUNET_TAPFOLD=1 (`forward_variant`);
- "packw" (K3) -> `csrc/conv3d_packw.cu`, the conv's input gradient.
A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the plain
version, `conv3d_fwd_reference`, whatever the variant. Both are the
implementations of one `torch.library` custom op,
`pytorch3dunet_tpu_torch::conv3d_fwd` (`conv3d_op`), whose fake implementation
lets `torch.export` trace a model through the kernels (export.py): the
exported graph calls the op, and the op launches the kernel at run time.

`forward_variant` is the JAX package's switch (pytorch3dunet_tpu/ops/conv.py
`_use_tapfold`), read at call time as there: the JAX forward is then the
tap-folded one and its backward the plain one (`_conv3d_mixed`), which is what
the port does too. The switch changes how the conv is computed, never its values.

The input gradient of this conv is the same conv run on dy with the taps
flipped and C and F swapped (`conv3d_input_grad`). `Conv3dFunction` is the
autograd of the conv on NDHWC tensors: its forward is K2 or K1, its input
gradient K3, its weight gradient `torch.nn.grad.conv3d_weight` (the JAX package
leaves the weight gradient to XLA, outside any kernel). `conv3d` is the
differentiable entry on NDHWC tensors that the layers call. The fused decoder
and the phase-decomposed deconv (ops/upconv.py) call it with the forward
pinned to K2 ("roll"): the JAX package computes those convs with `_as2d`
directly, never through `Conv3D`, so `P3DUNET_TAPFOLD` does not reach them.

`Conv3d` is the model's 3D conv layer (NCDHW in and out, torch weight layout).
It runs every 3x3x3 pad-1 conv through the above, and any other kernel size or
padding (the 1x1 `final_conv` and ResNet projection, `conv_kernel_size: [1, 3,
3]`, ...) through cuDNN's `F.conv3d`. Under a space mesh (parallel/spatial.py)
x is a D-slab: a conv with a depth extent takes one plane of each neighbour
(`halo_exchange_d`) in place of its depth padding; on the kernels that is the
pad-1 conv of the D + 2 planes with planes [1:-1] kept (no kernel changes): the JAX package's `conv_pallas.supported`
refuses those shapes and computes them outside any Pallas kernel. `Conv2d`, the
2D families' conv, is `F.conv2d` throughout, as the JAX package runs every 2D
conv through `lax.conv_general_dilated`.
"""

import contextlib
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops import build
from pytorch3dunet_tpu_torch.parallel.spatial import active_spatial_axis, halo_exchange_d

_DTYPES = (torch.float32, torch.bfloat16)
# the plain version also runs float64, for reference steps on the card
_REFERENCE_DTYPES = (*_DTYPES, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Pallas variant -> the csrc/ source of its CUDA kernel
KERNELS = {"roll": "conv3d_fwd", "packw": "conv3d_packw", "im2col": "conv3d_im2col"}

# launches of each CUDA kernel (by source name) since the last reset, and the
# same split by dtype ("f32", "bf16"), counted by the op's CUDA implementation
# where it launches (so a trace counts none); callers set them to 0 (`reset_launches`)
launches = dict.fromkeys(KERNELS.values(), 0)
launches_by_dtype = {name: dict.fromkeys(_SUFFIX.values(), 0) for name in KERNELS.values()}


def reset_launches():
    """Sets every launch count to 0."""
    for name in launches:
        launches[name] = 0
        launches_by_dtype[name] = dict.fromkeys(_SUFFIX.values(), 0)


def cast_to(t, x):
    """Parameter `t` (or None) in x's dtype: the layers keep float32
    parameters and compute in their input's dtype (bfloat16 under
    `model.dtype: bfloat16`)."""
    return None if t is None else t.to(x.dtype)

# set only inside `plain_conv()`
_force_plain = False


@contextlib.contextmanager
def plain_conv():
    """Runs every `Conv3d` through the plain version, whatever the device:
    the forward is `conv3d_fwd_reference` and autograd differentiates it, so
    the input gradient is plain too.

    For tests and for comparing a whole forward or train step with and
    without the kernels; no CLI path enters it."""
    global _force_plain
    previous, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = previous


def forward_variant(features: int) -> str:
    """The forward kernel of a 3x3x3 conv with `features` outputs: K1
    ("im2col") when P3DUNET_TAPFOLD=1 and features >= 64, as the JAX package's
    `_use_tapfold` chooses its tap-folded forward; K2 ("roll") otherwise."""
    return "im2col" if os.environ.get("P3DUNET_TAPFOLD", "0") == "1" and features >= 64 else "roll"


def _check(x, w, b, dtypes=_DTYPES):
    if x.dtype not in dtypes:
        raise TypeError(f"conv3d_fwd: x must be one of {[str(d)[6:] for d in dtypes]}, got {x.dtype}")
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
    is cast back once (the kernel's f32 accumulation and single rounding). A
    float64 x runs in float64, for reference computations."""
    _check(x, w, b, _REFERENCE_DTYPES)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = w.to(x.dtype).to(acc)
    bias = None if b is None else b.to(x.dtype).to(acc)
    y = F.conv3d(x.to(acc).permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), bias, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_fwd(x, w, b=None, variant: str | None = None):
    """Fused 3x3x3 conv forward on (N, D, H, W, C) -> (N, D, H, W, F).

    `b=None` means no bias; `w` and `b` are cast to x's dtype. On CUDA the
    kernel of `variant` runs, on the current stream; on the CPU the plain
    version does. Both go through the custom op `conv3d_op`, so that
    `torch.export` records the op, not the ctypes call. `variant=None` is the
    conv forward's own choice, `forward_variant(F)`. No autograd: training
    goes through `Conv3dFunction`."""
    if variant is None:
        variant = forward_variant(w.shape[-1])
    if variant not in KERNELS:
        raise ValueError(f"conv3d_fwd: unknown variant {variant!r}; expected one of {sorted(KERNELS)}")
    _check(x, w, b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3d_fwd: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise NotImplementedError("conv3d_fwd has no autograd: call Conv3dFunction.apply, or run it under "
                                  "torch.no_grad() or torch.inference_mode()")
    return conv3d_op(x, w, b, variant)


# The conv forward as a custom op, `pytorch3dunet_tpu_torch::conv3d_fwd`:
# `conv3d_fwd`'s contract, with the checks left to it. Its CUDA implementation
# launches the hand kernel of `variant`, its CPU implementation is the plain
# version, and its fake implementation gives `torch.export` the output's shape,
# so an exported forward keeps the op (and at run time the kernel) in its graph.
OP_NAME = "pytorch3dunet_tpu_torch::conv3d_fwd"


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu")
def conv3d_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, variant: str) -> torch.Tensor:
    return conv3d_fwd_reference(x, w, b)


@conv3d_op.register_fake
def _conv3d_op_fake(x, w, b, variant):
    return x.new_empty((*x.shape[:4], w.shape[-1]))


@conv3d_op.register_kernel("cuda")
def _conv3d_op_cuda(x, w, b, variant):
    """The launch of the hand kernel of `variant`; counts it in `launches`
    and `launches_by_dtype`. The kernel reads x as dense NDHWC: a strided x
    is copied first. The eager callers hand it contiguous already, but an
    exported program keeps no trace-time `.contiguous()` for inputs whose
    strides differ at run time."""
    N, D, H, W, C = x.shape
    Fo = w.shape[-1]
    name = KERNELS[variant]
    x = x.contiguous()
    w = w.to(x.dtype)
    w = kmajor_weight(w) if variant == "roll" else w.contiguous()
    if b is not None:
        b = b.to(x.dtype).contiguous()
    y = torch.empty((N, D, H, W, Fo), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.load(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(), N, D, H, W, C, Fo,
            stream)
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err)
        raise RuntimeError(f"{name} kernel launch failed for x {tuple(x.shape)} {x.dtype}, F={Fo}: "
                           f"{message.decode()} (cudaError {err})")
    launches[name] += 1
    launches_by_dtype[name][_SUFFIX[x.dtype]] += 1
    return y


def kmajor_weight(w):
    """w (3, 3, 3, C, F) -> wk (3, 3, 3, F, C), contiguous: K2's weights
    K-major, as its tensor cores read them (the TF32 B operand of `wgmma`
    comes from shared memory K-major only)."""
    return w.transpose(3, 4).contiguous()


def flip_weight(w):
    """w (3, 3, 3, C, F) -> w~ (3, 3, 3, F, C), w~[a, b, e, f, c] = w[2-a, 2-b, 2-e, c, f]:
    the weights of the conv that maps dy to dx."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


def conv3d_input_grad(dy, w):
    """dx of the 3x3x3 pad-1 conv with weights `w`, from dy (N, D, H, W, F):
    K3 on CUDA, `conv3d_input_grad_reference` on the CPU."""
    return conv3d_fwd(dy, flip_weight(w), None, variant="packw")


def conv3d_input_grad_reference(dy, w):
    """Plain version of `conv3d_input_grad`: `conv3d_fwd_reference` on the same w~."""
    return conv3d_fwd_reference(dy, flip_weight(w))


class Conv3dFunction(torch.autograd.Function):
    """Autograd of the 3x3x3 pad-1 conv on NDHWC tensors: x (N, D, H, W, C),
    w (3, 3, 3, C, F), b (F,) or None, and the forward's `variant` (None:
    `forward_variant(F)`).

    forward: `conv3d_fwd` (on CUDA K2, or K1 by `forward_variant`). backward:
    dx by `conv3d_input_grad` (K3 on CUDA) when x needs a gradient, dw by
    `torch.nn.grad.conv3d_weight` on NCDHW views, db by summing dy; each in
    the dtype of x, w and b, which `Conv3d` gives alike (bf16 in a bf16
    step). In the UNet, dy arrives NDHWC-contiguous: the backward of the
    GroupNorm, ReLU or pooling that read the conv's channels-last output
    keeps that layout. `grad_copies` counts the copies
    made when it does not."""

    # dy layout copies made in backward since the last reset
    grad_copies = 0

    @staticmethod
    def forward(ctx, x, w, b, variant=None):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        y = conv3d_fwd(x, w, b, variant)
        # the plain version (CPU) may return a permuted view of its own result;
        # autograd forbids in-place ops (the ReLU after the conv) on a view
        # made inside a Function
        return y.clone() if y._is_view() else y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
            Conv3dFunction.grad_copies += 1
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_input_grad(dy, w)
        if ctx.needs_input_grad[1]:
            dw_torch = torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3), (w.shape[4], w.shape[3], 3, 3, 3),
                                                   dy.permute(0, 4, 1, 2, 3), padding=1)
            dw = dw_torch.permute(2, 3, 4, 1, 0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2, 3))
        return dx, dw, db, None


def conv3d(x, w, b=None, variant=None):
    """The 3x3x3 pad-1 conv of NDHWC x (N, D, H, W, C) with w (3, 3, 3, C, F)
    and b (F,) or None, in x's dtype, differentiable: `Conv3dFunction` when
    grad is on and a tensor needs one, else `conv3d_fwd`; the plain version
    inside `plain_conv()`. `variant` pins the forward kernel ("roll": K2);
    None leaves it to `forward_variant(F)`."""
    if _force_plain:
        return conv3d_fwd_reference(x, w, b)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return Conv3dFunction.apply(x, w, b, variant)
    return conv3d_fwd(x, w, b, variant)


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` (torch weight layout and init) on NCDHW tensors whose
    3x3x3 pad-1 conv runs on the kernels above.

    The shape decides the path, once, at construction (`on_kernels`): kernel
    3 / padding 1 takes the kernels, any other kernel size or padding, ints or
    per-axis tuples, takes `F.conv3d` (JAX `conv_pallas.supported`). The
    kernels read the NDHWC view of x: a copy when x is not channels-last in
    memory (`input_copies` counts those copies), then `conv3d`, in x's dtype
    with the weights and bias cast to it."""

    # layout copies made for the kernel's NDHWC input since the last reset
    input_copies = 0

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, padding=1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, padding=padding, bias=bias)
        self.on_kernels = self.kernel_size == (3, 3, 3) and self.padding == (1, 1, 1)

    def forward(self, x):
        mesh = active_spatial_axis() if self.kernel_size[0] > 1 else None
        if mesh is not None and self.padding[0] != (self.kernel_size[0] - 1) // 2:
            raise ValueError(f"spatial sharding needs 'same' depth padding, got kernel {self.kernel_size} and "
                             f"padding {self.padding}")
        if not self.on_kernels:
            padding = self.padding
            if mesh is not None:
                # a D-slab: the neighbours' planes in place of the depth padding
                x = halo_exchange_d(x, mesh, self.padding[0], dim=2)
                padding = (0, *self.padding[1:])
            return F.conv3d(x, cast_to(self.weight, x), cast_to(self.bias, x), padding=padding)
        x_cl = x.permute(0, 2, 3, 4, 1)
        if not x_cl.is_contiguous():
            x_cl = x_cl.contiguous()
            Conv3d.input_copies += 1
        if mesh is not None:
            # a D-slab of D planes: one plane of each neighbour on either side,
            # the kernels' pad-1 conv on the D + 2 planes, and planes [1:-1]
            # kept, the depth-valid conv (JAX ops/conv.py:152-158)
            x_cl = halo_exchange_d(x_cl, mesh, 1, dim=1)
        # the weights in x's dtype: in a bf16 step the conv's autograd sees
        # bf16 w and b, and the f32 parameters' gradients come back through
        # the cast's own autograd
        y = conv3d(x_cl, cast_to(self.weight, x).permute(2, 3, 4, 1, 0), cast_to(self.bias, x))
        if mesh is not None:
            y = y[:, 1:-1]
        return y.permute(0, 4, 1, 2, 3)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` (torch weight layout and init) on NCHW tensors: the 2D
    families' conv, `F.conv2d` in x's dtype with the weights and bias cast to
    it (JAX ops/conv.py `Conv2D`, `lax.conv_general_dilated`)."""

    def forward(self, x):
        return F.conv2d(x, cast_to(self.weight, x), cast_to(self.bias, x), padding=self.padding)
