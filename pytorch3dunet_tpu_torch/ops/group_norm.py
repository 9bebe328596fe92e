"""GroupNorm forward: the hand-written Hopper kernel, its plain version, and
the rule that sends a GroupNorm module's forward to it.

`group_norm_op` (`pytorch3dunet_tpu_torch::group_norm_fwd`) normalizes x
(N, C, *spatial) over each (sample, group) and applies the per-channel affine:
y = x * a[n, c] + b[n, c] with a = rstd[n, g] * weight[c] and
b = bias[c] - mean[n, g] * a, eps as given (the models' 1e-5). Its numerical
contract: the statistics accumulate in float32, chunks combine by Chan's
parallel formula (never E[x^2] - E[x]^2), a and b are float32, and each output
is computed in float32 and rounded once to x's dtype (float32 or bfloat16).
Its layout rule (`_output`, which every implementation calls): y has x's
strides. On CUDA the op launches `csrc/group_norm.cu` (a split-reduction
statistics kernel over every SM, then the apply), which reads x where it
lies, channels-last (K2's output and what follows it) or NC-contiguous
(cuDNN's outputs, a concat, the 2D families): no copy, no float32 staging of
a bfloat16 x. An x that the kernel does not read where it lies (other
strides, or more channels than a channels-last block holds) is read from its
contiguous copy and y copied back into x's strides. A CPU tensor runs the
plain version, `group_norm_reference`. The fake implementation lets
`torch.export` keep the op, so an exported CUDA forward launches the kernel at
run time.

`takes_kernel` is the dispatch rule of `models/blocks.py` `GroupNorm.forward`
(unsharded): the op when x lies on a device of `KERNEL_DEVICES`, in a dtype
the kernel reads, and no gradient is needed; torch's GroupNorm otherwise, so
training keeps autograd's GroupNorm.
"""

import math

import torch

from pytorch3dunet_tpu_torch.ops import build

KERNEL = "group_norm"
OP_NAME = "pytorch3dunet_tpu_torch::group_norm_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
# the plain version also runs float64, for reference computations
_REFERENCE_DTYPES = (*_DTYPES, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the devices whose GroupNorm forwards go to the op
KERNEL_DEVICES = ("cuda",)
# the layouts the kernel reads, and the widths of its loads
NC, CHANNELS_LAST = 0, 1
_VEC_BYTES = 16

# launch pairs (statistics, apply) of the kernel since the last reset, in all
# and by x's dtype, counted by the op's CUDA implementation where it launches
# (so a trace counts none); callers set them to 0 (`reset_launches`)
launches = 0
launches_by_dtype = dict.fromkeys(_SUFFIX.values(), 0)

# the statistics kernel's ticket of each (device, stream): one word, zeroed
# once; the last block of every launch turns it back to 0
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches():
    global launches
    launches = 0
    for dtype in launches_by_dtype:
        launches_by_dtype[dtype] = 0


def takes_kernel(x, *params) -> bool:
    """Whether a GroupNorm forward of x with `params` (weight, bias) goes to
    `group_norm_op`: x on a device of `KERNEL_DEVICES`, float32 or bfloat16,
    and no gradient needed (grad mode off, or neither x nor a parameter
    requires one)."""
    return (x.device.type in KERNEL_DEVICES and x.dtype in _DTYPES
            and not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *params))))


def _check(x, weight, bias, num_groups, dtypes=_DTYPES):
    if x.dtype not in dtypes:
        raise TypeError(f"group_norm: x must be one of {[str(d)[6:] for d in dtypes]}, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"group_norm: x must be (N, C, *spatial), got shape {tuple(x.shape)}")
    C = x.shape[1]
    if num_groups < 1 or C % num_groups:
        raise ValueError(f"group_norm: {C} channels do not split into {num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (C,):
            raise ValueError(f"group_norm: {name} must be ({C},), got shape {tuple(t.shape)}")
        if t is not None and t.device != x.device:
            raise ValueError(f"group_norm: {name} is on {t.device}, x on {x.device}")


def launch_layout(x) -> tuple[int, bool] | None:
    """(layout, vectorized) in which the kernel would read x as it lies: NC
    when x is contiguous, CHANNELS_LAST when x.movedim(1, -1) is; `vectorized`
    when its loads can be 16 bytes (x aligned to 16 bytes, and the spatial
    size (NC) or the channel count (channels-last) a multiple of
    16 / itemsize). None for any other strides. Whether the kernel takes that
    launch (its channels-last blocks hold a limited number of channels) is
    the kernel's own answer, `group_norm_workspace_floats`."""
    C, S = x.shape[1], math.prod(x.shape[2:])
    vec = _VEC_BYTES // x.element_size()
    aligned = x.data_ptr() % _VEC_BYTES == 0
    if x.is_contiguous():
        return NC, aligned and S % vec == 0
    if x.movedim(1, -1).is_contiguous():
        return CHANNELS_LAST, aligned and C % vec == 0
    return None


def _output(x):
    """The op's y for x, in every implementation: the layout rule, x's
    strides where x is dense (NC-contiguous where it is not)."""
    return torch.empty_like(x)


def group_norm_reference(x, weight, bias, num_groups: int, eps: float):
    """Plain version of `group_norm_op`, same contract: the mean and the
    biased variance of each (sample, group) by two passes in float32 (float64
    for a float64 x), the affine a, b in that precision, y = x * a + b rounded
    once to x's dtype, with x's strides."""
    _check(x, weight, bias, num_groups, _REFERENCE_DTYPES)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    N, C = x.shape[:2]
    xa = x.to(acc)
    groups = xa.reshape(N, num_groups, -1)
    mean = groups.mean(-1)
    var = (groups - mean[..., None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps).repeat_interleave(C // num_groups, 1)
    mean = mean.repeat_interleave(C // num_groups, 1)
    a = rstd if weight is None else rstd * weight.to(acc)
    b = -mean * a if bias is None else bias.to(acc) - mean * a
    shape = (N, C) + (1,) * (x.ndim - 2)
    return _output(x).copy_(xa * a.view(shape) + b.view(shape))


# The forward as a custom op, without autograd (`takes_kernel` says when it is
# taken). Its CUDA implementation launches the kernel, its CPU implementation
# is the plain version, its fake implementation gives `torch.export` the output.
@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu")
def group_norm_op(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, num_groups: int,
                  eps: float) -> torch.Tensor:
    return group_norm_reference(x, weight, bias, num_groups, eps)


@group_norm_op.register_fake
def _group_norm_op_fake(x, weight, bias, num_groups, eps):
    return _output(x)


def _launch_plan(lib, x, num_groups):
    """(layout, vectorized, workspace floats) of a launch that reads x where
    it lies, or None where the kernel takes no such launch."""
    plan = launch_layout(x)
    if plan is None:
        return None
    layout, vectorized = plan
    N, C, S = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    floats = lib.group_norm_workspace_floats(N, C, S, num_groups, layout, vectorized, x.dtype == torch.bfloat16)
    return None if floats < 0 else (layout, vectorized, floats)


def _ticket(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key], stream


@group_norm_op.register_kernel("cuda")
def _group_norm_op_cuda(x, weight, bias, num_groups, eps):
    """The launch pair of the kernel; counts it in `launches` and
    `launches_by_dtype`. An x that the kernel does not read where it lies is
    read from its contiguous copy (an exported program keeps no trace-time
    layout for a run-time input), and y copied into x's strides."""
    global launches
    _check(x, weight, bias, num_groups)
    y = _output(x)
    if y.numel() == 0:
        return y
    N, C, S = x.shape[0], x.shape[1], math.prod(x.shape[2:])
    params = [None if t is None else t.to(torch.float32).contiguous() for t in (weight, bias)]
    lib = build.load(KERNEL)
    with torch.cuda.device(x.device):
        src, dst, plan = x, y, _launch_plan(lib, x, num_groups)
        if plan is None:
            src = x.contiguous()
            dst = y if y.is_contiguous() else torch.empty_like(src)
            plan = _launch_plan(lib, src, num_groups)
        if plan is None:
            raise ValueError(f"group_norm: the kernel takes no x {tuple(x.shape)} {x.dtype} with {num_groups} groups")
        layout, vectorized, floats = plan
        workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
        ticket, stream = _ticket(x.device)
        err = getattr(lib, f"group_norm_fwd_{_SUFFIX[x.dtype]}")(
            src.data_ptr(), *(None if t is None else t.data_ptr() for t in params), dst.data_ptr(),
            workspace.data_ptr(), ticket.data_ptr(), N, C, S, num_groups, layout, vectorized, float(eps), stream)
        if err != 0:
            message = lib.group_norm_error_string(err)
            raise RuntimeError(f"group_norm kernel launch failed for x {tuple(x.shape)} {x.dtype}, {num_groups} "
                               f"groups: {message.decode()} (cudaError {err})")
        if dst is not y:
            y.copy_(dst)
    launches += 1
    launches_by_dtype[_SUFFIX[x.dtype]] += 1
    return y
