"""Everything a run feeds the program, made from `--seed` on the run's device
in a few large calls: the same seed gives the same weights and inputs.

- Weights: one uniform draw for all parameters, cut into the reference's
  state dict (reference/models/ `param_specs`): conv weights and biases in
  +-1/sqrt(fan_in) (torch's default init), GroupNorm weights in [0.5, 1.5)
  and biases in [-0.2, 0.2), so the norms' affines are not the identity.
- Volumes: membranes of Voronoi cells, as a confocal or light-sheet stack of
  cell boundaries shows them: a bright sheet where the two nearest cell
  centres are equally near, blurred by distance, plus Gaussian noise.
- Train batches: the recipe's (raw, target) pair for BCEDiceLoss with
  `skip_last_target`: the standardized membrane raw and the target
  (boundary, label) that StandardLabelToBoundary(append_label) makes, the
  boundary where a voxel's 3x3x3 neighbourhood holds another cell.
"""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models

# odd constants that keep the streams of one seed apart
_WEIGHTS, _VOLUMES, _BATCHES = 0x5EED_0001, 0x5EED_0002, 0x5EED_0003


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + stream) % 2**63)


def weights(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seeded float32 parameters of the configuration's model, by name."""
    specs = models.param_specs(model_cfg)
    sizes = [int(np.prod(shape)) for _, shape in specs]
    flat = torch.rand(sum(sizes), generator=generator(seed, _WEIGHTS, device), device=device)
    # a conv's fan-in from its weight (torch's init: a transposed conv's
    # weight is (in, out, k, k, k) and its fan-in out * k^3, the same rule)
    fan_in = {name.rsplit(".", 1)[0]: int(np.prod(shape[1:])) for name, shape in specs if name.endswith(".weight")}
    params, offset = {}, 0
    for (name, shape), size in zip(specs, sizes):
        u = flat[offset:offset + size].view(shape)
        offset += size
        module, leaf = name.rsplit(".", 1)
        if module.endswith("groupnorm"):
            params[name] = u + 0.5 if leaf == "weight" else u * 0.4 - 0.2
        else:
            params[name] = (u * 2 - 1) * fan_in[module] ** -0.5
    return params


def membranes(shape, cells: int, seed: int, stream: int, device, noise: float = 0.5):
    """(raw, label): a float32 membrane image of `cells` Voronoi cells and the
    int64 cell index of every voxel, both on `device`."""
    gen = generator(seed, stream, device)
    centres = torch.rand(cells, 3, generator=gen, device=device) * torch.tensor(shape, device=device)
    zz, yy, xx = (torch.arange(s, device=device, dtype=torch.float32) for s in shape)
    raw = torch.empty(shape, device=device)
    label = torch.empty(shape, dtype=torch.int64, device=device)
    plane = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), -1).reshape(-1, 2)
    for z in range(shape[0]):
        points = torch.cat([zz[z].expand(plane.shape[0], 1), plane], 1)
        d = torch.cdist(points, centres)
        two = d.topk(2, dim=1, largest=False)
        raw[z] = torch.exp(-0.5 * ((two.values[:, 1] - two.values[:, 0]) / 1.5) ** 2).view(shape[1:])
        label[z] = two.indices[:, 0].view(shape[1:])
    raw += noise * torch.randn(shape, generator=gen, device=device)
    return raw, label


def volumes(shape, count: int, seed: int, device, cells: int = 200) -> list[np.ndarray]:
    """`count` distinct float32 (D, H, W) membrane volumes on the host."""
    return [membranes(shape, cells, seed, _VOLUMES + 7 * i, device)[0].cpu().numpy() for i in range(count)]


def batches(patch, count: int, seed: int, device, cells: int = 60) -> list[tuple[np.ndarray, np.ndarray]]:
    """`count` distinct (raw (1, 1, D, H, W), target (1, 2, D, H, W)) float32 host batches."""
    out = []
    for i in range(count):
        raw, label = membranes(patch, cells, seed, _BATCHES + 7 * i, device)
        lab = label.float()[None, None]
        boundary = F.max_pool3d(lab, 3, 1, 1) != -F.max_pool3d(-lab, 3, 1, 1)
        raw = (raw - raw.mean()) / raw.std()
        target = torch.stack([boundary[0, 0].float(), label.float()])
        out.append((raw[None, None].cpu().numpy(), target[None].cpu().numpy()))
    return out
