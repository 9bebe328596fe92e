"""The port's 3x3x3 conv (pytorch3dunet_tpu_torch/ops/conv3d.py) against the
JAX package's Pallas kernel (interpret mode) and its Conv3D layer, forward and
VJP.

On the CPU `conv3d_fwd` runs its plain version whatever the variant; the CUDA
kernels themselves (K2 `roll`, K3 `packw`, K1 `im2col`) are held against that
plain version on the GPU by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu.ops import conv_pallas
from pytorch3dunet_tpu.ops.conv import Conv3D
from pytorch3dunet_tpu_torch.config import resolve_device
from pytorch3dunet_tpu_torch.ops import build, conv3d
from pytorch3dunet_tpu_torch.ops.conv3d import (Conv3d, Conv3dFunction, conv3d_fwd, conv3d_fwd_reference,
                                                conv3d_input_grad, conv3d_input_grad_reference, flip_weight,
                                                plain_conv)

# the shapes of tests/test_conv_pallas.py
SHAPES = [((1, 6, 20, 12, 5), 5, 4), ((1, 4, 8, 9, 3), 3, 7), ((2, 5, 10, 6, 2), 2, 3)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(conv_pallas, "_INTERPRET", True)


def _inputs(shape, cin, cout, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32) - 0.5
    w = (rs.rand(3, 3, 3, cin, cout) * 0.4 - 0.2).astype(np.float32)
    b = rs.rand(cout).astype(np.float32)
    return x, w, b


def _port(x, w, b=None, variant="roll"):
    tb = None if b is None else torch.from_numpy(b)
    return conv3d_fwd(torch.from_numpy(x), torch.from_numpy(w), tb, variant=variant).numpy()


@pytest.mark.parametrize("variant", ["roll", "packw", "im2col"])
@pytest.mark.parametrize("shape,cin,cout", SHAPES)
def test_matches_pallas_kernel(variant, shape, cin, cout):
    x, w, b = _inputs(shape, cin, cout, sum(shape))
    want = np.asarray(conv_pallas.conv3d_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), variant=variant))
    np.testing.assert_allclose(_port(x, w, b, variant), want, atol=1e-5)


@pytest.mark.parametrize("variant", ["roll", "packw", "im2col"])
def test_matches_pallas_kernel_without_bias(variant):
    x, w, _ = _inputs((1, 4, 10, 8, 6), 6, 8, 3)
    want = np.asarray(conv_pallas.conv3d_fwd(jnp.asarray(x), jnp.asarray(w), variant=variant))
    np.testing.assert_allclose(_port(x, w, variant=variant), want, atol=1e-5)


def _jax_conv_vjp(x, w, b, dy):
    """(dx, dw, db) of the JAX package's Conv3D layer at x, w, b for cotangent dy."""
    layer = Conv3D(w.shape[-1])

    def f(x_, w_, b_):
        return layer.apply({"params": {"kernel": w_, "bias": b_}}, x_)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("shape,cin,cout", SHAPES)
def test_input_grad_matches_pallas_packw_and_jax_vjp(shape, cin, cout):
    # dx is the packw kernel run on dy with the taps flipped and C / F swapped
    x, w, b = _inputs(shape, cin, cout, 11)
    dy = np.random.RandomState(12).rand(*shape[:4], cout).astype(np.float32) - 0.5
    w_flip = np.ascontiguousarray(w[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3))
    pallas = np.asarray(conv_pallas.conv3d_fwd(jnp.asarray(dy), jnp.asarray(w_flip), variant="packw"))
    got = conv3d_input_grad(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, _jax_conv_vjp(x, w, b, dy)[0], atol=1e-5)
    np.testing.assert_array_equal(flip_weight(torch.from_numpy(w)).numpy(), w_flip)
    plain = conv3d_input_grad_reference(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("shape,cin,cout", SHAPES)
def test_function_grads_match_jax_vjp(shape, cin, cout):
    x, w, b = _inputs(shape, cin, cout, 21)
    dy = np.random.RandomState(22).rand(*shape[:4], cout).astype(np.float32) - 0.5
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = Conv3dFunction.apply(xt, wt, bt)
    np.testing.assert_allclose(y.detach().numpy(), _port(x, w, b), atol=0)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    for name, g, want in zip(("dx", "dw", "db"), got, _jax_conv_vjp(x, w, b, dy)):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, err_msg=name)


def test_function_skips_the_input_grad_when_x_needs_none():
    x, w, b = _inputs((1, 3, 6, 7, 4), 4, 5, 31)
    wt = torch.from_numpy(w).requires_grad_()
    y = Conv3dFunction.apply(torch.from_numpy(x), wt, None)
    y.sum().backward()
    assert wt.grad is not None and wt.grad.shape == (3, 3, 3, 4, 5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_grads_match_torch_conv3d(with_bias):
    # the layer goes through Conv3dFunction when grad is on; plain_conv() makes
    # forward and input gradient plain (autograd through F.conv3d)
    rs = np.random.RandomState(41)
    layer = Conv3d(3, 4, bias=with_bias)
    x = torch.from_numpy(rs.rand(2, 3, 5, 6, 7).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rs.rand(2, 4, 5, 6, 7).astype(np.float32))
    params = [p for p in layer.parameters()]
    got = torch.autograd.grad(layer(x), [x, *params], dy)
    want = torch.autograd.grad(F.conv3d(x, layer.weight, layer.bias, padding=1), [x, *params], dy)
    with plain_conv():
        plain = torch.autograd.grad(layer(x), [x, *params], dy)
    # db sums 420 terms near 0.5: f32 rounding of a sum near 200
    for g, w_, p in zip(got, want, plain):
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(p, w_, rtol=1e-6, atol=1e-5)


def test_layer_output_takes_an_inplace_relu_in_training():
    # the plain version returns a view of its own result; the Function must
    # not hand that view to the in-place ReLU that follows the conv
    layer = Conv3d(2, 3)
    x = torch.rand(1, 2, 4, 5, 6).permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    y = torch.relu_(layer(x.requires_grad_()))
    y.sum().backward()
    assert x.grad is not None


@pytest.mark.parametrize("variant", ["im2col", "packw"])
def test_kernel_variants_reject_devices_other_than_cpu_and_cuda(variant):
    # meta tensors stand in for a device that is neither the CPU nor CUDA
    x = torch.zeros(1, 2, 3, 3, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_fwd(x, torch.zeros(3, 3, 3, 2, 2, device="meta"), variant=variant)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_im2col_has_entry_points_for_both_dtypes(dtype):
    entry = f"conv3d_im2col_{dtype}"
    assert build.SIGNATURES["conv3d_im2col"][entry] == build.SIGNATURES["conv3d_fwd"][f"conv3d_fwd_{dtype}"]
    source = build.source_path("conv3d_im2col").read_text()
    assert f'extern "C" int {entry}(' in source


@pytest.mark.parametrize("switch,features,want", [
    (None, 64, "roll"), ("0", 64, "roll"), ("1", 32, "roll"), ("1", 63, "roll"), ("1", 64, "im2col"),
    ("1", 512, "im2col"), ("true", 64, "roll"),
])
def test_forward_variant_is_the_jax_tapfold_rule(monkeypatch, switch, features, want):
    if switch is None:
        monkeypatch.delenv("P3DUNET_TAPFOLD", raising=False)
    else:
        monkeypatch.setenv("P3DUNET_TAPFOLD", switch)
    assert conv3d.forward_variant(features) == want
    assert conv3d.KERNELS[want] in build.SIGNATURES


def test_function_grads_match_jax_tapfold_vjp(monkeypatch):
    # with the switch the JAX layer runs its tap-folded forward and the plain
    # backward (`_conv3d_mixed`); the port's Function runs K1's plain version
    # forward and K3's backward
    monkeypatch.setenv("P3DUNET_TAPFOLD", "1")
    x, w, b = _inputs((1, 3, 5, 6, 3), 3, 64, 51)
    dy = np.random.RandomState(52).rand(1, 3, 5, 6, 64).astype(np.float32) - 0.5
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = Conv3dFunction.apply(xt, wt, bt)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    for name, g, want in zip(("dx", "dw", "db"), got, _jax_conv_vjp(x, w, b, dy)):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, err_msg=name)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        conv3d_fwd(torch.zeros(1, 2, 3, 3, 2), torch.zeros(3, 3, 3, 2, 2), variant="tapfold")


@pytest.mark.parametrize("shape,cin,cout", SHAPES[:2])
def test_matches_jax_conv3d_layer(shape, cin, cout):
    x, w, b = _inputs(shape, cin, cout, 7)
    layer = Conv3D(cout)
    want = layer.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    np.testing.assert_allclose(_port(x, w, b), np.asarray(want), atol=1e-5)


def test_bf16_accumulates_in_f32():
    # the case of tests/test_conv_pallas.py: a constant field where bf16
    # accumulation of 27 taps would visibly drift
    x = torch.full((1, 6, 10, 10, 16), 1.001, dtype=torch.bfloat16)
    w = torch.full((3, 3, 3, 16, 4), 0.01, dtype=torch.bfloat16)
    got = conv3d_fwd(x, w)
    assert got.dtype == torch.bfloat16
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.float().numpy()), jnp.asarray(w.float().numpy()), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    interior = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(got.float().numpy()[interior], np.asarray(ref)[interior], rtol=2e-2)


def test_weight_and_bias_cast_to_input_dtype():
    x, w, b = _inputs((1, 3, 6, 7, 4), 4, 5, 9)
    xb = torch.from_numpy(x).bfloat16()
    got = conv3d_fwd(xb, torch.from_numpy(w), torch.from_numpy(b))
    want = conv3d_fwd_reference(xb, torch.from_numpy(w).bfloat16(), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["x_rank", "w_shape", "w_channels", "b_shape", "x_dtype", "w_dtype"])
def test_rejects_bad_inputs(bad):
    x = torch.zeros(1, 4, 5, 6, 3)
    w = torch.zeros(3, 3, 3, 3, 2)
    b = torch.zeros(2)
    if bad == "x_rank":
        x = x[0]
    elif bad == "w_shape":
        w = torch.zeros(3, 3, 1, 3, 2)
    elif bad == "w_channels":
        w = torch.zeros(3, 3, 3, 4, 2)
    elif bad == "b_shape":
        b = torch.zeros(3)
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "w_dtype":
        w = w.int()
    with pytest.raises((ValueError, TypeError)):
        conv3d_fwd(x, w, b)


def test_plain_version_runs_float64_but_the_wrapper_does_not():
    x, w, b = _inputs((1, 3, 5, 6, 2), 2, 3, 61)
    x64, w64, b64 = (torch.from_numpy(a).double() for a in (x, w, b))
    got = conv3d_fwd_reference(x64, w64, b64)
    want = F.conv3d(x64.permute(0, 4, 1, 2, 3), w64.permute(4, 3, 0, 1, 2), b64, padding=1).permute(0, 2, 3, 4, 1)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    with pytest.raises(TypeError, match="float32"):
        conv3d_fwd(x64, w64, b64)
    layer = Conv3d(2, 3).double()
    with torch.no_grad(), plain_conv():
        assert layer(x64.permute(0, 4, 1, 2, 3)).dtype == torch.float64


def test_rejects_devices_other_than_cpu_and_cuda():
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_fwd(torch.zeros(1, 2, 3, 3, 2, device="meta"), torch.zeros(3, 3, 3, 2, 2, device="meta"))


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_cpu_calls_do_not_count_as_launches(monkeypatch):
    monkeypatch.setattr(conv3d, "launches", dict.fromkeys(conv3d.launches, 0))
    x, w, b = _inputs((1, 3, 6, 7, 4), 4, 5, 1)
    for variant in ("roll", "packw", "im2col"):
        _port(x, w, b, variant)
    layer = Conv3d(4, 5).eval()
    with torch.no_grad():
        layer(torch.from_numpy(np.moveaxis(x, -1, 1)))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1)).requires_grad_()
    layer.train()(xt).sum().backward()
    assert conv3d.launches == {"conv3d_fwd": 0, "conv3d_packw": 0, "conv3d_im2col": 0}


@pytest.mark.parametrize("kernel_size,padding", [(3, 1), (1, 0), (5, 2), ((1, 3, 3), (0, 1, 1)), (3, 0)])
def test_layer_matches_torch_conv3d(kernel_size, padding):
    # the shape picks the path at construction: 3x3x3 pad 1 the kernels
    # (their plain version here), anything else F.conv3d
    rs = np.random.RandomState(kernel_size if isinstance(kernel_size, int) else 7)
    layer = Conv3d(6, 4, kernel_size=kernel_size, padding=padding)
    assert layer.on_kernels == ((kernel_size, padding) == (3, 1))
    x = torch.from_numpy(rs.rand(2, 6, 5, 9, 7).astype(np.float32))
    with torch.no_grad():
        got = layer(x)
        with plain_conv():
            plain = layer(x)
    want = F.conv3d(x, layer.weight, layer.bias, padding=padding)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_plain_conv_restores_the_kernel_path():
    from pytorch3dunet_tpu_torch.ops import conv3d

    with pytest.raises(RuntimeError):
        with plain_conv():
            assert conv3d._force_plain
            raise RuntimeError
    assert not conv3d._force_plain


def test_library_named_by_source_hash(tmp_path, monkeypatch):
    _check_library_named_by_source_hash(tmp_path, monkeypatch, "conv3d_fwd")


def test_packw_library_named_by_source_hash(tmp_path, monkeypatch):
    _check_library_named_by_source_hash(tmp_path, monkeypatch, "conv3d_packw")


def test_im2col_library_named_by_source_hash(tmp_path, monkeypatch):
    _check_library_named_by_source_hash(tmp_path, monkeypatch, "conv3d_im2col")


def _check_library_named_by_source_hash(tmp_path, monkeypatch, name):
    path = build.library_path(name)
    assert path.parent == build.BUILD_DIR and path.name.startswith(f"{name}_")
    assert build.library_path(name) == path
    src = tmp_path / f"{name}.cu"
    src.write_bytes(build.source_path(name).read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path(name) != path


@pytest.mark.parametrize("name", ["conv3d_im2col", "conv3d_packw", "conv3d_fwd"])
def test_library_path_follows_included_headers(tmp_path, monkeypatch, name):
    for source in build.CSRC_DIR.iterdir():
        (tmp_path / source.name).write_bytes(source.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert [h.name for h in build.included_headers(build.source_path(name))] == ["conv3d_tc.cuh"]
    path = build.library_path(name)
    # files the source does not include leave the name alone
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    other = "conv3d_packw" if name == "conv3d_fwd" else "conv3d_fwd"
    (tmp_path / f"{other}.cu").write_bytes(build.source_path(other).read_bytes() + b"\n// edited\n")
    assert build.library_path(name) == path
    # an edit of the shared header renames the library, so it is rebuilt
    header = tmp_path / "conv3d_tc.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert build.library_path(name) != path


def test_library_path_follows_nested_includes_and_flags(tmp_path, monkeypatch):
    # a nested include resolves next to the header that names it
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include "inc/a.cuh"\n#include <cstdint>\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("// leaf\n")
    (tmp_path / "b.cuh").write_text("// same name, not included\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    inc = (tmp_path / "inc").resolve()
    assert build.included_headers(build.source_path("k")) == [inc / "a.cuh", inc / "b.cuh"]
    path = build.library_path("k")
    (tmp_path / "b.cuh").write_text("// edited, still not included\n")
    assert build.library_path("k") == path
    (tmp_path / "inc" / "b.cuh").write_text("// leaf, edited\n")
    edited = build.library_path("k")
    assert edited != path
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-I/usr/local/cutlass/include"])
    assert build.library_path("k") != edited


def test_every_kernel_has_a_source_and_entry_points():
    assert set(build.SIGNATURES) == set(conv3d.KERNELS.values()) == set(conv3d.launches)
    for name, entries in build.SIGNATURES.items():
        source = build.source_path(name).read_text()
        for entry in entries:
            assert f'extern "C" ' in source and f" {entry}(" in source, (name, entry)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
