"""The f32 arithmetic of the tensor-core conv kernels (K1 `csrc/conv3d_im2col.cu`,
K2 `csrc/conv3d_fwd.cu`, K3 `csrc/conv3d_packw.cu`), emulated in plain PyTorch
on the CPU.

The kernels run f32 convs on TF32 tensor cores as 3xTF32: each operand is
split into a TF32 high part (round to nearest on the f32 bit pattern, 10
mantissa bits kept) and the TF32-rounded remainder, and A.B is taken as
A_hi.B_hi + A_hi.B_lo + A_lo.B_hi, three products that are exact in f32, summed
in f32. These tests pin that arithmetic argument, not the kernels: the
emulation below is defined here and runs no code of the port but K2's weight
layout (`kmajor_weight`), so it cannot notice a kernel that drops a product or
falls back to one TF32 pass. At the same inputs one TF32 pass misses the 1e-4
bound, the three-pass sum meets it with orders to spare, at K2's own shapes
too (C = 1 and F = 16, F = 32). K2's operand arrangement (output pixels x
(tap, channel) patches against the (3, 3, 3, F, C) K-major weights, each depth
tap's 8-channel chunk summed apart) is emulated as well. The guard on the card
is `chip_smoke.py`'s `TOL[torch.float32]` (1e-4 of max|plain|), held at every
path and edge shape of K1, K2 and K3 (phases 3, 8 and 10): one TF32 pass would
fail it there.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.ops.conv3d import conv3d_fwd_reference, kmajor_weight

TOL = 1e-4  # chip_smoke.py TOL[torch.float32]: max |kernel - plain| <= TOL * max |plain|


def tf32_round(a):
    """Round-to-nearest (ties away from zero) of float32 `a` to TF32: 10
    mantissa bits, on the bit pattern, as `cvt.rna.tf32.f32` does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a):
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def patches(x):
    """(N, D, H, W, C) -> (N * D * H * W, 27 * C): every output voxel's 3x3x3
    pad-1 neighbourhood, taps (kd, kh, kw) major, channels minor."""
    n, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [xp[:, kd:kd + d, kh:kh + h, kw:kw + w] for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.cat(cols, -1).reshape(-1, 27 * c)


def conv_emulated(x, w, passes):
    """The conv as the kernels compute it in f32: `passes` = 1 is a single
    TF32 product, 3 is 3xTF32; products exact, sums in float32."""
    a_hi, a_lo = split_tf32(patches(x))
    b_hi, b_lo = split_tf32(w.reshape(-1, w.shape[-1]))
    y = a_hi @ b_hi
    if passes == 3:
        y = a_lo @ b_hi + a_hi @ b_lo + y
    return y.reshape(*x.shape[:4], w.shape[-1])


def conv_float64(x, w):
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def conv_inputs(shape, c_out, seed):
    """x ~ N(0, 1) and w ~ U(-1, 1) / sqrt(27 C), as chip_smoke.py draws them."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy(((rs.rand(3, 3, 3, shape[-1], c_out) * 2 - 1) / np.sqrt(27 * shape[-1])).astype(np.float32))
    return x, w


SHAPES = [((1, 6, 12, 12, 8), 16), ((1, 4, 10, 10, 32), 64), ((1, 4, 8, 8, 64), 64),
          # K2's level-0 shapes, narrowed: C = 1 -> F = 16, F = 32 from C = 16 and 96
          ((1, 6, 12, 12, 1), 16), ((1, 4, 10, 10, 16), 32), ((1, 4, 10, 10, 96), 32)]


def _rel_err(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("shape,c_out", SHAPES)
def test_tf32_round_keeps_ten_mantissa_bits(shape, c_out):
    x, _ = conv_inputs(shape, c_out, 0)
    hi, lo = split_tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    # round to nearest: the high part is within half a TF32 ulp (2^-11 relative)
    assert ((hi - x).abs() <= x.abs() * 2.0**-11).all()
    # the remainder carries the next 11 bits: hi + lo is within 2^-22 of x
    assert ((hi + lo - x).abs() <= x.abs() * 2.0**-21).all()


def test_tf32_round_ties_away_from_zero():
    one_ulp = 2.0**-10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0**-23, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,c_out", SHAPES)
def test_three_tf32_passes_meet_the_f32_bound(shape, c_out, seed):
    x, w = conv_inputs(shape, c_out, seed)
    want = conv_float64(x, w)
    err3 = _rel_err(conv_emulated(x, w, 3), want)
    assert err3 <= TOL / 20, err3
    # as close to float64 as a plain float32 conv, within a small factor
    err32 = _rel_err(F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=1).permute(0, 2, 3, 4, 1),
                     want)
    assert err3 <= 10 * err32 + 1e-7, (err3, err32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,c_out", SHAPES)
def test_one_tf32_pass_misses_the_f32_bound(shape, c_out, seed):
    x, w = conv_inputs(shape, c_out, seed)
    assert _rel_err(conv_emulated(x, w, 1), conv_float64(x, w)) > TOL


def conv_k2_emulated(x, w, chunk=8):
    """The conv in K2's operand arrangement, in f32: A = output pixels x (tap,
    channel) patches of one depth tap and one `chunk` of channels, B = the
    same taps and channels of the K-major weights (F rows), one 3xTF32 product
    per (kd, chunk) summed apart and added to the running f32 sum in the
    kernel's order (kd, then chunks)."""
    n, d, h, w_, c = x.shape
    wk = kmajor_weight(w)  # (3, 3, 3, F, C)
    f = wk.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(n * d * h * w_, f)
    for kd in range(3):
        for c0 in range(0, c, chunk):
            a = torch.cat([xp[:, kd:kd + d, kh:kh + h, kw:kw + w_, c0:c0 + chunk] for kh in range(3)
                           for kw in range(3)], -1).reshape(n * d * h * w_, -1)
            b = wk[kd, :, :, :, c0:c0 + chunk].reshape(9, f, -1).transpose(0, 1).reshape(f, -1)
            a_hi, a_lo = split_tf32(a)
            b_hi, b_lo = split_tf32(b.contiguous())
            acc = acc + (a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T)
    return acc.reshape(n, d, h, w_, f)


@pytest.mark.parametrize("shape,c_out", SHAPES)
def test_k2_operand_arrangement_matches_the_plain_conv(shape, c_out):
    x, w = conv_inputs(shape, c_out, 2)
    b = torch.from_numpy(np.random.RandomState(3).rand(c_out).astype(np.float32) - 0.5)
    assert kmajor_weight(w).shape == (3, 3, 3, c_out, shape[-1]) and kmajor_weight(w).is_contiguous()
    want = conv3d_fwd_reference(x, w, b)
    got = conv_k2_emulated(x, w) + b
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL
