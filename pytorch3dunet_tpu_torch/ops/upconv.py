"""The JAX package's decoder formulations (pytorch3dunet_tpu/ops/upconv.py) on
channels-last tensors: the fused join of a decoder (nearest 2x upsample +
concat + norm + 3x3x3 conv, with no upsampled or concatenated tensor) and the
phase-decomposed transposed conv. Tensors are NDHWC (NHWC in 2D), weights
(3, 3, 3, C, F) ((3, 3, C, F) in 2D), as `ops/conv3d.py` takes them; every
function keeps its JAX name.

The identities, per axis, for the output phase a in {0, 1}:
- conv3x3(up2x(x), pad 1): out[2i+a] reads x[i-1], x[i] (a = 0, taps W0 and
  W1 + W2) or x[i], x[i+1] (a = 1, taps W0 + W1 and W2), so every phase is a
  2x2x2 conv of the half-res tensor (`collapse_phase_kernels`);
- conv(concat(skip, up)) = conv_skip(skip) + conv_up(up): the concat is a
  split of the kernel's input channels;
- the GroupNorm moments of the concat are per-branch sums, each voxel of the
  half-res branch counted `factor` times (8, 4 in 2D, 2 depth-only); the
  BatchNorm moments are per-channel means, which replication leaves as they are;
- ConvTranspose(kernel 3, stride 2, pad 1): y[2i] = W1 x[i] and
  y[2i+1] = W0 x[i] + W2 x[i+1] (`collapse_deconv_kernels`).

The phase kernels are zero-embedded into one 3x3x3 kernel with F = 8 Co (2 Co
depth-only), the phases' blocks in the order (a, b, c), c fastest
(`_phase_embed`), which `depth_to_space_blocks` interleaves. JAX runs that
wide conv as a VALID conv of the 1-padded half-res tensor: that is the pad-1
3x3x3 conv of the unpadded tensor, so here it is K2 (`conv3d` with variant
"roll", K3 for its input gradient), as is the skip branch's conv. The weight
algebra is plain tensor ops: the weight gradient reaches the one stored kernel
through it. Convs of other shapes (the 2x2x2 phases of P3DUNET_UPCONV=phase,
the stride-2 4x4x4 conv of P3DUNET_SKIPCONV=strided, every 2D conv) are
`F.conv3d` / `F.conv2d`, as `Conv3d` runs every conv that is not 3x3x3 pad 1.

The switches, read at call time as in JAX: P3DUNET_FUSED_DECODER,
P3DUNET_FUSED_DECODER_MIXED (models/blocks.py `Decoder.fused_mode`),
P3DUNET_DECONV (`TransposeConvUpsampling`), P3DUNET_UPCONV, P3DUNET_SKIPCONV and
P3DUNET_GN_APPLY (here). Their defaults are JAX's but P3DUNET_DECONV's, which
is "xla" here: on the H100 the phase deconv's wide K2 conv (F = 8 Co, 3.375x
the transposed conv's MACs) made the ResidualUNet3D forward 3% and its step 8%
slower than cuDNN's transposed conv (ROADMAP F12).
"""

import os

import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops.conv3d import conv3d
from pytorch3dunet_tpu_torch.utils.misc import span

# the phases (a, b, c) of a 2x upsample in the order of the channel blocks
_PHASES = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]


# the port's defaults of P3DUNET_FUSED_DECODER and P3DUNET_DECONV, chosen on
# the H100 (chip_smoke.py phase 31): the fused decoder, as JAX's "1"; the
# library's transposed conv, where JAX's default is "phase" (ROADMAP F12)
FUSED_DECODER_DEFAULT, DECONV_DEFAULT = "1", "xla"


def fused_decoder_on() -> bool:
    """P3DUNET_FUSED_DECODER (`FUSED_DECODER_DEFAULT`): the fused decoder join where it applies."""
    return os.environ.get("P3DUNET_FUSED_DECODER", FUSED_DECODER_DEFAULT) == "1"


def fused_decoder_mixed() -> bool:
    """P3DUNET_FUSED_DECODER_MIXED (default "0"): the depth-only fused join
    where H and W are not an exact 2x (rank 3 only)."""
    return os.environ.get("P3DUNET_FUSED_DECODER_MIXED", "0") == "1"


def deconv_mode() -> str:
    """P3DUNET_DECONV (`DECONV_DEFAULT`): "phase" (`phase_conv_transpose`) or
    "xla" (the library's transposed conv)."""
    return os.environ.get("P3DUNET_DECONV", DECONV_DEFAULT)


def upconv_mode() -> str:
    """P3DUNET_UPCONV: "wide" (default, one K2 conv with F = 8 Co) or "phase"
    (8 convs of 2x2x2)."""
    return os.environ.get("P3DUNET_UPCONV", "wide")


def skipconv_mode() -> str:
    """P3DUNET_SKIPCONV: "fullres" (default, the skip branch's pad-1 conv) or
    "strided" (one stride-2 4x4x4 conv into the phase blocks; with "wide")."""
    return os.environ.get("P3DUNET_SKIPCONV", "fullres")


def _f32(x):
    """x in float32, or float64 as it is (the plain reference steps)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _taps(w, axis):
    return (w.narrow(axis, t, 1) for t in range(3))


def _collapse3(kernel, collapse):
    out = []
    for wa in collapse(kernel, 0):
        for wab in collapse(wa, 1):
            out.extend(collapse(wab, 2))
    return out


def _collapse_up(w, axis):
    w0, w1, w2 = _taps(w, axis)
    return torch.cat([w0, w1 + w2], axis), torch.cat([w0 + w1, w2], axis)


def collapse_phase_kernels(kernel):
    """(3, 3, 3, Ci, Co) -> 8 phase kernels (2, 2, 2, Ci, Co), phases (a, b, c)
    with c fastest; phase (a, b, c) gives the output voxels (2i+a, 2j+b, 2k+c)
    of conv3x3(up2x(x), pad 1)."""
    return _collapse3(kernel, _collapse_up)


def _phase_embed(kernels):
    """One kernel per phase (a list of 8, or one kernel for all), zero-embedded
    at spatial offsets [a:, b:, c:] and concatenated along the output channels."""
    blocks = []
    for i, (a, b, c) in enumerate(_PHASES):
        k = kernels[i] if isinstance(kernels, list) else kernels
        blocks.append(F.pad(k, (0, 0, 0, 0, c, 1 - c, b, 1 - b, a, 1 - a)))
    return torch.cat(blocks, -1)


def embed_wide_kernel(kernel):
    """(3, 3, 3, Ci, Co) -> (3, 3, 3, Ci, 8 Co): phase (a, b, c)'s collapsed
    kernel in output block (a, b, c) at offsets [a:a+2, b:b+2, c:c+2]."""
    return _phase_embed(collapse_phase_kernels(kernel))


def depth_to_space_blocks(out, F):
    """(N, d, h, w, 8F) phase blocks (a, b, c | c fastest) -> (N, 2d, 2h, 2w, F)."""
    N, d, h, w, _ = out.shape
    out = out.reshape(N, d, h, w, 2, 2, 2, F)
    return out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(N, 2 * d, 2 * h, 2 * w, F)


def _add_blocks(out, blocks, F):
    """out + depth_to_space_blocks(blocks, F) without the interleaved copy: the
    blocks are added through a permuted view of out's 2x2x2 cells."""
    N, d, h, w, _ = blocks.shape
    cells = blocks.reshape(N, d, h, w, 2, 2, 2, F).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return (out.reshape(N, d, 2, h, 2, w, 2, F) + cells).reshape(N, 2 * d, 2 * h, 2 * w, F)


def _upconv_wide_blocks(xs, kernel):
    """All 8 phases of conv3x3(up2x(xs), pad 1) as one pad-1 conv (K2) of xs
    with `embed_wide_kernel`: (N, d, h, w, Ci) -> (N, d, h, w, 8F)."""
    return conv3d(xs, embed_wide_kernel(kernel), None, variant="roll")


def embed_wide_kernel_d(kernel):
    """Depth-only collapse: (3, 3, 3, Ci, Co) -> (3, 3, 3, Ci, 2 Co), the depth
    phases zero-embedded into the 3-tap envelope, the H and W taps as they are."""
    w0, w1, w2 = kernel[0:1], kernel[1:2], kernel[2:3]
    z = torch.zeros_like(w0)
    k0 = torch.cat([w0, w1 + w2, z], 0)
    k1 = torch.cat([z, w0 + w1, w2], 0)
    return torch.cat([k0, k1], -1)


def _upconv_wide_blocks_d(m, kernel):
    """conv3x3(up2x_D(m), pad 1) for both depth phases as one pad-1 conv (K2):
    (N, d, H, W, Ci) -> (N, d, H, W, 2F)."""
    return conv3d(m, embed_wide_kernel_d(kernel), None, variant="roll")


def depth_to_space_blocks_d(out, F):
    """(N, d, H, W, 2F) depth-phase blocks -> (N, 2d, H, W, F)."""
    N, d, H, W, _ = out.shape
    out = out.reshape(N, d, H, W, 2, F)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(N, 2 * d, H, W, F)


def strided_conv_blocks(x, kernel):
    """conv3x3(x, pad 1) at every output phase at once: one stride-2 conv with
    the 3x3x3 kernel zero-embedded per phase into a 4x4x4 envelope, padded
    (1, 2) on each axis. (N, 2d, 2h, 2w, C) -> (N, d, h, w, 8F)."""
    k4 = _phase_embed(kernel)  # (4, 4, 4, C, 8F)
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 2, 1, 2, 1, 2))
    return F.conv3d(xp, k4.permute(4, 3, 0, 1, 2).to(x.dtype), stride=2).permute(0, 2, 3, 4, 1)


def phase_conv_upsampled(xs, kernel):
    """conv3x3(up2x(xs), pad 1) without the upsampled tensor: xs (N, d, h, w,
    Ci), kernel (3, 3, 3, Ci, Co) -> (N, 2d, 2h, 2w, Co). "wide": one K2 conv;
    "phase": 8 2x2x2 convs of the padded xs (`F.conv3d`), interleaved."""
    Fo = kernel.shape[-1]
    if upconv_mode() == "wide":
        return depth_to_space_blocks(_upconv_wide_blocks(xs, kernel), Fo)
    N, d, h, w, _ = xs.shape
    xp = F.pad(xs.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 1, 1))
    phases = []
    for K, (a, b, c) in zip(collapse_phase_kernels(kernel), _PHASES):
        window = xp[:, :, a : a + d + 1, b : b + h + 1, c : c + w + 1]
        phases.append(F.conv3d(window, K.permute(4, 3, 0, 1, 2).to(xs.dtype)))  # (N, Co, d, h, w)
    out = torch.stack(phases, 0).reshape(2, 2, 2, N, Fo, d, h, w)
    return out.permute(3, 5, 0, 6, 1, 7, 2, 4).reshape(N, 2 * d, 2 * h, 2 * w, Fo)


def _collapse_deconv(w, axis):
    w0, w1, w2 = _taps(w, axis)
    z = torch.zeros_like(w0)
    return torch.cat([z, w1], axis), torch.cat([w0, w2], axis)


def collapse_deconv_kernels(kernel):
    """(3, 3, 3, Ci, Co) -> 8 phase kernels (2, 2, 2, Ci, Co) of the transposed
    conv with kernel 3, stride 2, padding (1, 1) (flax's kernel layout, no flip):
    per axis phase 0 taps (x[i-1], x[i]) with (0, W1), phase 1 taps (x[i],
    x[i+1]) with (W0, W2)."""
    return _collapse3(kernel, _collapse_deconv)


def phase_conv_transpose(x, kernel):
    """ConvTranspose(kernel 3, stride 2, padding (1, 1)) as one pad-1 conv
    (K2) with the 8 phase kernels embedded and one depth-to-space:
    (N, d, h, w, Ci) -> (N, 2d-1, 2h-1, 2w-1, Co), exactly `lax.conv_transpose`'s
    output with the flax kernel (3, 3, 3, Ci, Co). Torch's ConvTranspose3d
    weight (Ci, Co, 3, 3, 3) is that kernel flipped: `w.flip(2, 3, 4)
    .permute(2, 3, 4, 0, 1)`."""
    Fo = kernel.shape[-1]
    blocks = conv3d(x, _phase_embed(collapse_deconv_kernels(kernel)), None, variant="roll")
    # 2n - 1 a side: the trailing phase-1 element reads only the zero padding
    return depth_to_space_blocks(blocks, Fo)[:, :-1, :-1, :-1]


def concat_group_stats(skip, xs, num_groups, eps=1e-5, factor=8.0):
    """GroupNorm statistics of concat([skip, up(xs)], -1) per branch in fp32,
    one pass (E[x^2] - E[x]^2 clamped at 0), each xs voxel counted `factor`
    times: per-channel (mean, 1 / std) of its group, shapes (N, C)."""
    N, Cs, Cu = skip.shape[0], skip.shape[-1], xs.shape[-1]
    C = Cs + Cu
    assert C % num_groups == 0
    gs = C // num_groups
    V = skip[0, ..., 0].numel()
    red = tuple(range(1, skip.ndim - 1))
    s32, x32 = _f32(skip), _f32(xs)
    sums = torch.cat([s32.sum(red), factor * x32.sum(red)], -1).reshape(N, num_groups, gs).sum(-1)
    sumsqs = torch.cat([(s32 * s32).sum(red), factor * (x32 * x32).sum(red)], -1).reshape(N, num_groups, gs).sum(-1)
    mean_g = sums / (V * gs)
    # E[x^2] - E[x]^2 can cancel below 0 in fp32 for large-mean groups
    var_g = torch.clamp(sumsqs / (V * gs) - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(gs, -1), inv_g.repeat_interleave(gs, -1)


def concat_batch_stats(skip, xs):
    """BatchNorm statistics of concat([skip, up(xs)], -1) per branch: per-channel
    (mean, biased variance) over batch and space in fp32, one pass, shapes (C,).
    Exact for any nearest upsample factor: replication leaves the per-channel
    moments as they are."""
    s32, x32 = _f32(skip), _f32(xs)
    ax_s, ax_x = tuple(range(s32.ndim - 1)), tuple(range(x32.ndim - 1))
    mean = torch.cat([s32.mean(ax_s), x32.mean(ax_x)])
    mean2 = torch.cat([(s32 * s32).mean(ax_s), (x32 * x32).mean(ax_x)])
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _apply_norm_affine(skip, xs, affine, dtype):
    """y = x * a_c + b_c on both branches, before the channel-split conv; a_c,
    b_c of shape (C,) (BatchNorm) or (N, C) (GroupNorm), in fp32, or in the
    compute dtype of a bf16 model under P3DUNET_GN_APPLY=compute."""
    Cs = skip.shape[-1]
    a_c, b_c = (_f32(t) for t in affine)
    if a_c.ndim == 1:
        a_c, b_c = a_c[None], b_c[None]
    bshape = (a_c.shape[0],) + (1,) * (skip.ndim - 2) + (-1,)
    if dtype in (torch.bfloat16, torch.float16) and os.environ.get("P3DUNET_GN_APPLY", "f32") == "compute":
        a_c, b_c = a_c.to(dtype), b_c.to(dtype)
        skip, xs = skip.to(dtype), xs.to(dtype)
    else:
        skip, xs = _f32(skip), _f32(xs)
    skip = skip * a_c[:, :Cs].reshape(bshape) + b_c[:, :Cs].reshape(bshape)
    xs = xs * a_c[:, Cs:].reshape(bshape) + b_c[:, Cs:].reshape(bshape)
    return skip, xs


def _normalize(skip, xs, num_groups, gn_scale, gn_bias, affine, dtype, eps, factor):
    """The norm folded into a per-channel affine and applied; the conv inputs
    and dtype as JAX casts them."""
    with span("p3d.norm.fused"):
        if num_groups is not None:
            mean_c, inv_c = concat_group_stats(skip, xs, num_groups, eps, factor=factor)
            a_c = inv_c * gn_scale[None]
            affine = (a_c, gn_bias[None] - mean_c * a_c)
        if affine is not None:
            skip, xs = _apply_norm_affine(skip, xs, affine, dtype)
        dtype = dtype if dtype is not None else skip.dtype
        return skip.to(dtype), xs.to(dtype), dtype


# rank 2 (UNet2D): the same identities with the 4 phases (a, b), b fastest


def collapse_phase_kernels_2d(kernel):
    """(3, 3, Ci, Co) -> 4 phase kernels (2, 2, Ci, Co), phases (a, b) with b fastest."""
    out = []
    for wa in _collapse_up(kernel, 0):
        out.extend(_collapse_up(wa, 1))
    return out


def embed_wide_kernel_2d(kernel):
    """(3, 3, Ci, Co) -> (3, 3, Ci, 4 Co): phase (a, b)'s collapsed kernel at
    offsets [a:a+2, b:b+2]."""
    blocks = [F.pad(k, (0, 0, 0, 0, b, 1 - b, a, 1 - a))
              for k, (a, b) in zip(collapse_phase_kernels_2d(kernel), ((0, 0), (0, 1), (1, 0), (1, 1)))]
    return torch.cat(blocks, -1)


def space_interleave_2d(out, F):
    """(N, h, w, 4F) phase blocks (a, b | b fastest) -> (N, 2h, 2w, F)."""
    N, h, w, _ = out.shape
    out = out.reshape(N, h, w, 2, 2, F)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(N, 2 * h, 2 * w, F)


def _conv2d_same(x, kernel):
    """The pad-1 conv2d of NHWC x with a (3, 3, C, F) kernel (`F.conv2d`)."""
    return F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype), padding=1).permute(0, 2, 3, 1)


def phase_conv_upsampled_2d(xs, kernel):
    """conv3x3(up2x(xs), pad 1) without the upsampled tensor: (N, h, w, Ci) x
    (3, 3, Ci, Co) -> (N, 2h, 2w, Co), one conv of xs with `embed_wide_kernel_2d`."""
    return space_interleave_2d(_conv2d_same(xs, embed_wide_kernel_2d(kernel)), kernel.shape[-1])


def fused_up_concat_conv_2d(skip, xs, kernel, *, num_groups=None, gn_scale=None, gn_bias=None, affine=None,
                            conv_bias=None, dtype=None, eps=1e-5):
    """Rank-2 `fused_up_concat_conv`: skip (N, 2h, 2w, Cs), xs (N, h, w, Cu),
    kernel (3, 3, Cs + Cu, Co); GroupNorm statistics with factor 4."""
    Cs = skip.shape[-1]
    assert skip.shape[1:3] == tuple(2 * s for s in xs.shape[1:3])
    skip, xs, dtype = _normalize(skip, xs, num_groups, gn_scale, gn_bias, affine, dtype, eps, 4.0)
    kernel = kernel.to(dtype)
    out = _conv2d_same(skip, kernel[:, :, :Cs]) + phase_conv_upsampled_2d(xs, kernel[:, :, Cs:])
    if conv_bias is not None:
        out = out + conv_bias.to(out.dtype)
    return out


def fused_up_concat_conv(skip, xs, kernel, *, num_groups=None, gn_scale=None, gn_bias=None, affine=None,
                         conv_bias=None, dtype=None, eps=1e-5):
    """[norm] + conv3x3(pad 1) of concat([skip, up2x(xs)], -1), fused: no
    upsampled tensor, no concat, per-branch statistics.

    skip (N, 2d, 2h, 2w, Cs) with xs (N, d, h, w, Cu) (full), or skip
    (N, 2d, H, W, Cs) with xs (N, d, H, W, Cu) (depth-only: xs already resized
    in H and W); kernel (3, 3, 3, Cs + Cu, Co), the parameter of the concat's
    conv. GroupNorm by `num_groups` with its (C,) affine `gn_scale`, `gn_bias`;
    or a precomputed per-channel `affine` (a_c, b_c) (the BatchNorm fold, whose
    statistics the caller owns); or no norm. `dtype`: the compute dtype (None:
    skip's). Returns the conv output at skip's resolution."""
    Cs = skip.shape[-1]
    depth_only = skip.shape[2] == xs.shape[2]
    assert skip.shape[1] == 2 * xs.shape[1]
    factor = 2.0 if depth_only else 8.0
    skip, xs, dtype = _normalize(skip, xs, num_groups, gn_scale, gn_bias, affine, dtype, eps, factor)
    kernel = kernel.to(dtype)
    k_skip, k_up = kernel[..., :Cs, :], kernel[..., Cs:, :]
    Fo = kernel.shape[-1]
    if depth_only:
        out = conv3d(skip, k_skip, None, variant="roll")
        out = out + depth_to_space_blocks_d(_upconv_wide_blocks_d(xs, k_up), Fo)
    elif upconv_mode() == "wide" and skipconv_mode() == "strided":
        # both branches in the phase-block layout; one depth-to-space
        out = depth_to_space_blocks(strided_conv_blocks(skip, k_skip) + _upconv_wide_blocks(xs, k_up), Fo)
    elif upconv_mode() == "wide":
        out = _add_blocks(conv3d(skip, k_skip, None, variant="roll"), _upconv_wide_blocks(xs, k_up), Fo)
    else:
        out = conv3d(skip, k_skip, None, variant="roll") + phase_conv_upsampled(xs, k_up)
    if conv_bias is not None:
        out = out + conv_bias.to(out.dtype)
    return out
