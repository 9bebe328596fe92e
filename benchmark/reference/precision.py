"""The control's precision: the conv operands rounded one step below the
configuration's dtype, the step that would tempt a later change.

- float32 (the port computes it with TF32 off): TF32, each operand's mantissa
  rounded to 10 bits, as the tensor cores round it; the sums stay float32.
- bfloat16: float8 e4m3 with one scale per tensor (its largest magnitude
  mapped to e4m3's 448), the usual fp8 recipe; the sums stay float32.

Both are written out rather than switched on in a library, so that they give
the same numbers on the CPU, where the tests run them, as on the card, and
both pass the gradient straight through, so a train step can take them.
"""

import torch

_E4M3_MAX = 448.0


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return _straight_through(x, ((bits + 0x1000) & ~0x1FFF).view(torch.float32))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, back in float32."""
    d = x.detach().float()
    scale = _E4M3_MAX / d.abs().amax().clamp(min=1e-30)
    return _straight_through(x, (d * scale).to(torch.float8_e4m3fn).float() / scale)


def below(dtype: str | None):
    """The rounding one step below a configuration's `dtype` (None: float32)."""
    return fp8 if dtype in ("bfloat16", "bf16") else tf32
