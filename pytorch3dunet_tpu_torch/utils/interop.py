"""The JAX package's variables as a reference-layout torch state dict, and back.

The port's own copy of pytorch3dunet_tpu/utils/torch_interop.py: the export
half (:213-293), which `utils/weights.py` `state_dict_from_jax` uses, and of the
import half the key mapping (`torch_state_dict_to_params` :129,
`_flax_scope_path` :156), from which `utils/weights.py` builds the flax tree of
a port model to read a JAX npz checkpoint. Layout conversions (flax,
channels-last -> torch):
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



# ---------------------------------------------------------------------------
# import: reference torch state dict -> flax trees (the key mapping)
# ---------------------------------------------------------------------------


def _convert_conv_weight(w: np.ndarray) -> np.ndarray:
    """torch Conv (O, I, *spatial) -> flax kernel (*spatial, I, O)."""
    rank = w.ndim
    return np.transpose(w, tuple(range(2, rank)) + (1, 0))


def _convert_conv_transpose_weight(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose (I, O, *spatial) -> flax kernel (*spatial, I, O), taps mirrored."""
    rank = w.ndim
    w = np.transpose(w, tuple(range(2, rank)) + (0, 1))
    return np.flip(w, axis=tuple(range(rank - 2)))


def _singleconv_entries(prefix_t: str, state: dict, out: dict):
    """Maps one torch SingleConv (conv/groupnorm/batchnorm children) to flax params."""
    if f"{prefix_t}.conv.weight" in state:
        conv = {"kernel": _convert_conv_weight(state[f"{prefix_t}.conv.weight"])}
        if f"{prefix_t}.conv.bias" in state:
            conv["bias"] = state[f"{prefix_t}.conv.bias"]
        out["conv"] = conv
    for norm in ("groupnorm", "batchnorm"):
        if f"{prefix_t}.{norm}.weight" in state:
            out[norm] = {"scale": state[f"{prefix_t}.{norm}.weight"], "bias": state[f"{prefix_t}.{norm}.bias"]}


def _channel_se_params(prefix_t: str, state: dict) -> dict:
    return {
        "fc1": {"kernel": state[f"{prefix_t}.fc1.weight"].T, "bias": state[f"{prefix_t}.fc1.bias"]},
        "fc2": {"kernel": state[f"{prefix_t}.fc2.weight"].T, "bias": state[f"{prefix_t}.fc2.bias"]},
    }


def _spatial_se_params(prefix_t: str, state: dict) -> dict:
    return {"conv": {"kernel": _convert_conv_weight(state[f"{prefix_t}.conv.weight"]),
                     "bias": state[f"{prefix_t}.conv.bias"]}}


def _basic_module_params(prefix_t: str, state: dict) -> dict:
    """Converts a DoubleConv / ResNetBlock / ResNetBlockSE subtree."""
    out = {}
    for sc in ["SingleConv1", "SingleConv2"]:
        if any(k.startswith(f"{prefix_t}.{sc}.") for k in state):
            sub = {}
            _singleconv_entries(f"{prefix_t}.{sc}", state, sub)
            out[sc] = sub
    if out:
        return out

    # ResNetBlock(SE): torch keeps conv1/conv2/conv3 (+ se_module) flat; flax
    # nests the ResNetBlock under 'block' for the SE variant
    block = {}
    if f"{prefix_t}.conv1.weight" in state:
        block["conv1"] = {"kernel": _convert_conv_weight(state[f"{prefix_t}.conv1.weight"]),
                          "bias": state[f"{prefix_t}.conv1.bias"]}
    for sc in ["conv2", "conv3"]:
        sub = {}
        _singleconv_entries(f"{prefix_t}.{sc}", state, sub)
        if sub:
            block[sc] = sub

    se = {}
    se_prefix = f"{prefix_t}.se_module"
    if any(k.startswith(f"{se_prefix}.cSE.") for k in state):
        se["cSE"] = _channel_se_params(f"{se_prefix}.cSE", state)
    if any(k.startswith(f"{se_prefix}.sSE.") for k in state):
        se["sSE"] = _spatial_se_params(f"{se_prefix}.sSE", state)
    if se:
        return {"block": block, "se_module": se}
    return block


def torch_state_dict_to_params(state: dict[str, np.ndarray]) -> dict:
    """A reference UNet state dict as the JAX package's params tree."""
    params = {}
    n_encoders = 1 + max((int(k.split(".")[1]) for k in state if k.startswith("encoders.")), default=-1)
    for i in range(n_encoders):
        params[f"encoder{i}"] = {"basic_module": _basic_module_params(f"encoders.{i}.basic_module", state)}
    n_decoders = 1 + max((int(k.split(".")[1]) for k in state if k.startswith("decoders.")), default=-1)
    for i in range(n_decoders):
        dec = {"basic_module": _basic_module_params(f"decoders.{i}.basic_module", state)}
        deconv_key = f"decoders.{i}.upsampling.upsample.conv_transposed.weight"
        if deconv_key in state:
            dec["upsampling"] = {"kernel": _convert_conv_transpose_weight(state[deconv_key])}
        params[f"decoder{i}"] = dec
    params["final_conv"] = {"kernel": _convert_conv_weight(state["final_conv.weight"]),
                            "bias": state["final_conv.bias"]}
    return params


def _flax_scope_path(torch_prefix: str, state: dict) -> list[str]:
    """Maps a torch module prefix to the flax scope path: encoders.{i} ->
    encoder{i}, decoders.{i} -> decoder{i}; the SE variant's flax ResNetBlock
    nests under 'block' while torch keeps conv children flat."""
    parts = torch_prefix.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] in ("encoders", "decoders"):
            out.append(("encoder" if parts[i] == "encoders" else "decoder") + parts[i + 1])
            i += 2
        else:
            if parts[i] == "basic_module":
                bm_prefix = ".".join(parts[: i + 1])
                if any(k.startswith(f"{bm_prefix}.se_module.") for k in state):
                    out.extend(["basic_module", "block"])
                    i += 1
                    continue
            out.append(parts[i])
            i += 1
    return out


def torch_state_dict_to_batch_stats(state: dict[str, np.ndarray]) -> dict:
    """The BatchNorm running statistics of a state dict as a flax 'batch_stats' tree."""
    stats: dict = {}
    for key in state:
        if not key.endswith(".batchnorm.running_mean"):
            continue
        prefix = key[: -len(".running_mean")]
        node = stats
        for name in _flax_scope_path(prefix, state)[:-1]:
            node = node.setdefault(name, {})
        node["batchnorm"] = {"mean": state[prefix + ".running_mean"], "var": state[prefix + ".running_var"]}
    return stats


def tree_leaves_with_paths(tree: dict, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    """The ('a/b/c', leaf) pairs of a nested dict in `jax.tree_util`'s leaf
    order: the keys of every dict sorted."""
    leaves = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            leaves.extend(tree_leaves_with_paths(tree[key], path))
        else:
            leaves.append((path, tree[key]))
    return leaves


def tree_from_paths(pairs) -> dict:
    """The nested dict of ('a/b/c', leaf) pairs (inverse of `tree_leaves_with_paths`)."""
    tree: dict = {}
    for path, leaf in pairs:
        *parents, name = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree
