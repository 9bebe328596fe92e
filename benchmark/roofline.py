"""The yardstick's arithmetic: the operations and bytes of a configuration's
convolutions, from its layer shapes, and the card's peaks.

The layer shapes of a model family live in `layers/<model name>.py`
(`conv_layers(model_cfg, spatial)`); a new family adds its own file there.
The count is of the model's mathematics, not of its implementation: a fused
decoder's split and wide convs count as the one conv over the concatenated,
upsampled tensor they stand for. A conv's operations are 2 * k^3 * cin * cout
per output voxel (per input voxel for a transposed conv); its bytes are its
input, weight and output, each once, in the compute dtype. A train step does
each conv three times over: the forward, the input gradient and the weight
gradient, each with the same operations and the same bytes.

The least time of a conv is the larger of its operations at the dtype's peak
and its bytes at the HBM rate. The peaks are NVIDIA's data sheet for the H100
SXM (dense) at its 700 W limit: bf16 989 TFLOP/s; float32 on the tensor cores
as three TF32 passes (the port's f32 kernels with TF32 off) at 495 / 3 = 165
TFLOP/s, where an FFMA-only path (67 TFLOP/s) would read at most 41%; HBM
3.35 TB/s.
"""

import importlib

import numpy as np

PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def dtype_name(dtype) -> str:
    """A configuration's `dtype` (None, 'float32', 'bfloat16', 'bf16') as a key of the tables."""
    return "bfloat16" if dtype in ("bfloat16", "bf16") else "float32"


def conv_layers(model_cfg: dict, spatial) -> list[tuple]:
    return importlib.import_module(f"benchmark.layers.{model_cfg['name']}").conv_layers(model_cfg, spatial)


def conv_work(model_cfg: dict, spatial, dtype=None, train: bool = False, count: int = 1) -> dict:
    """{'flops', 'bytes', 'least_s', 'peak_flops'} of `count` forwards (or
    train steps) of the model on an input of `spatial` shape at batch 1."""
    dtype = dtype_name(dtype)
    item, peak = ITEMSIZE[dtype], PEAK_FLOPS[dtype]
    flops = nbytes = least = 0.0
    for _, k, cin, cout, sin, sout, transposed in conv_layers(model_cfg, spatial):
        vin, vout = int(np.prod(sin)), int(np.prod(sout))
        f = 2.0 * k**3 * cin * cout * (vin if transposed else vout)
        b = float(item * (cin * vin + cout * vout + k**3 * cin * cout))
        flops, nbytes, least = flops + f, nbytes + b, least + max(f / peak, b / HBM_BYTES_PER_S)
    passes = (3 if train else 1) * count
    return {"flops": passes * flops, "bytes": passes * nbytes, "least_s": passes * least, "peak_flops": peak}
