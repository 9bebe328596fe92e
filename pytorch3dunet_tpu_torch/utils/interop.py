"""The JAX package's variables as a reference-layout torch state dict.

The port's own copy of the export half of pytorch3dunet_tpu/utils/torch_interop.py
(:213-293), which `utils/weights.py` `state_dict_from_jax` uses. Layout
conversions (flax, channels-last -> torch):
- Conv3d kernel (D, H, W, I, O) -> (O, I, D, H, W)
- ConvTranspose3d kernel (D, H, W, I, O) -> (I, O, D, H, W), with the spatial
  taps flipped (flax ConvTranspose with transpose_kernel=False applies a
  fractionally-strided conv, which equals the torch op on the mirrored kernel)
- GroupNorm/BatchNorm scale/bias -> weight/bias, running mean/var -> running_mean/running_var
- Dense (I, O) -> Linear (O, I)
The flax SE variant nests its ResNetBlock under 'block'; torch keeps it flat.
"""

import numpy as np


def _export_conv_weight(k: np.ndarray) -> np.ndarray:
    """flax kernel (*spatial, I, O) -> torch Conv (O, I, *spatial)."""
    rank = k.ndim
    return np.transpose(k, (rank - 1, rank - 2) + tuple(range(rank - 2)))


def _export_conv_transpose_weight(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose kernel (*spatial, I, O) -> torch (I, O, *spatial), taps mirrored."""
    rank = k.ndim
    k = np.flip(k, axis=tuple(range(rank - 2)))
    return np.transpose(k, (rank - 2, rank - 1) + tuple(range(rank - 2)))


def _export_subtree(prefix_t: str, tree: dict, out: dict):
    for name, sub in tree.items():
        path = f"{prefix_t}.{name}" if prefix_t else name
        if not isinstance(sub, dict):
            continue
        if "kernel" in sub:  # conv or dense
            k = np.asarray(sub["kernel"])
            if name == "upsampling":
                out[f"{path}.upsample.conv_transposed.weight"] = _export_conv_transpose_weight(k)
            elif k.ndim == 2:  # dense (SE fc layers)
                out[f"{path}.weight"] = k.T
            else:
                out[f"{path}.weight"] = _export_conv_weight(k)
            if "bias" in sub:
                out[f"{path}.bias"] = np.asarray(sub["bias"])
        elif "scale" in sub:  # norm layers
            out[f"{path}.weight"] = np.asarray(sub["scale"])
            out[f"{path}.bias"] = np.asarray(sub["bias"])
        else:
            # flax nests the ResNetBlock of the SE variant under 'block'; torch is flat
            next_prefix = prefix_t if name == "block" else path
            _export_subtree(next_prefix, sub, out)


def params_to_torch_state_dict(params: dict) -> dict:
    """Converts this framework's params tree to a reference-layout state dict.

    Module names map back: encoder{i} -> encoders.{i}.basic_module parent etc.
    The result (numpy arrays) can be torch.save'd for use with the reference.
    """
    out: dict[str, np.ndarray] = {}
    for name, tree in params.items():
        if name.startswith("encoder"):
            _export_subtree(f"encoders.{name[len('encoder'):]}", tree, out)
        elif name.startswith("decoder"):
            _export_subtree(f"decoders.{name[len('decoder'):]}", tree, out)
        else:
            _export_subtree("", {name: tree}, out)
    return out


def _export_batch_stats(prefix_t: str, tree: dict, out: dict):
    for name, sub in tree.items():
        path = f"{prefix_t}.{name}" if prefix_t else name
        if not isinstance(sub, dict):
            continue
        if "mean" in sub and "var" in sub:
            out[f"{path}.running_mean"] = np.asarray(sub["mean"])
            out[f"{path}.running_var"] = np.asarray(sub["var"])
            # torch BatchNorm state dicts carry this counter; 0 keeps
            # load_state_dict(strict=True) happy without affecting eval
            out[f"{path}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        else:
            next_prefix = prefix_t if name == "block" else path
            _export_batch_stats(next_prefix, sub, out)


def batch_stats_to_torch_entries(batch_stats: dict) -> dict:
    """flax 'batch_stats' tree -> torch running_mean/running_var entries."""
    out: dict[str, np.ndarray] = {}
    for name, tree in batch_stats.items():
        if name.startswith("encoder"):
            _export_batch_stats(f"encoders.{name[len('encoder'):]}", tree, out)
        elif name.startswith("decoder"):
            _export_batch_stats(f"decoders.{name[len('decoder'):]}", tree, out)
        else:
            _export_batch_stats("", {name: tree}, out)
    return out
