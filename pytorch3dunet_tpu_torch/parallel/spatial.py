"""Spatial (depth-axis) model parallelism: the patch's D axis split across
ranks, with halo-exchanged convolutions (pytorch3dunet_tpu/parallel/spatial.py).

A batch-1 patch cannot be split by data parallelism. Here each rank of a
space mesh holds a D-slab of the patch: every 3x3x3 convolution first takes
one boundary plane from each neighbour (`halo_exchange_d`, wired into
ops/conv3d.py `Conv3d` while a space mesh is active), GroupNorm all-reduces
its statistics (models/blocks.py), the SE squeeze its sums (models/se.py), a
deconv decoder takes a 2-plane halo and gathers its nearest fix-up
(`spatial_deconv_fixup_indices`), and the loss reads the logits and targets
gathered over the mesh. The sharded model computes the unsharded function.

`spatial_axis(mesh)` marks the mesh for the ops run inside; the JAX package
holds an axis name there, the port a `Mesh` (parallel/mesh.py): ranks and
their process group.

Loss convention. JAX gathers the logits with `all_gather` and then takes
`pmean` of the gradients, because the transpose of the gather sums the n
replicated cotangents (JAX spatial.py:209-214). The port's convention:
- the gather's backward hands each rank its own slice of the cotangent (the
  loss is one function that every rank computes alike, counted once);
- the backward of an all-reduce (GroupNorm's moments, the SE squeeze) is an
  all-reduce, and a halo's cotangent goes back to the rank that owns the plane;
- each rank's parameter gradients are then partial sums of the one gradient,
  and are all-reduced as a SUM over the space mesh;
- over a data mesh (`build_dp_sp_train_step`) the per-data-shard gradients
  are averaged, JAX's `pmean` over 'data'.
The tests hold a sharded step to the unsharded one.

Constraints (`spatial_shardable`): the D extent divides evenly across the
ranks through every pooling level, with at least `min_local` planes a rank,
and every conv with a depth extent above 1 pads D by (k - 1) // 2. A rank
cannot sit out a step the way an unused JAX device does, so a world size that
the patch cannot be sharded over raises and names the size to launch with
(ROADMAP F11). BatchNorm, and interpolating upsampling other than nearest,
are refused (`validate_spatial_model`).
"""

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.parallel import distributed
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh, all_reduce_, gather, group_of, replicate, step_fns, train_step

SPACE_AXIS = "space"

_ACTIVE = threading.local()


def active_spatial_axis() -> Mesh | None:
    """The space mesh of the ops being run, or None."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def spatial_axis(mesh: Mesh):
    """Marks `mesh` as the spatial (D) shard axis for the ops run inside;
    a backward that recomputes levels (`model.remat`) runs inside it too."""
    stack = _ACTIVE.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield
    finally:
        stack.pop()


def spatial_shardable(patch_d: int, num_levels: int, n_shards: int, pool: int = 2, min_local: int = 1) -> bool:
    """Whether a D extent stays exactly shardable through all pooling levels
    (JAX `spatial_shardable`): at every level the depth divides across the
    shards with at least `min_local` planes each (deconv models need 2), and
    above the last level it divides the pool stride (each shard would
    otherwise floor-pool its own trailing plane)."""
    if n_shards <= 1:
        return True
    d = patch_d
    for level in range(num_levels):
        if d % n_shards != 0 or (d // n_shards) < min_local:
            return False
        if level < num_levels - 1:
            if d % pool != 0:
                return False
            d //= pool
    return True


def space_mesh(n: int | None = None, ranks=None) -> Mesh:
    """A space mesh over `ranks`, or over the first `n` ranks of the world
    (every rank by default)."""
    if ranks is None:
        ranks = range(distributed.world_size() if n is None else n)
    ranks = tuple(ranks)
    return Mesh(ranks, SPACE_AXIS, group_of(ranks))


def choose_space_mesh(patch_d: int, num_levels: int, min_local: int = 1, pool: int = 2) -> Mesh:
    """The space mesh over every rank, when the patch depth shards that many
    ways (JAX `choose_space_mesh` takes the largest count that does). A
    smaller count raises and names it (ROADMAP F11)."""
    world = distributed.world_size()
    n = world
    while n > 1 and not spatial_shardable(patch_d, num_levels, n, pool=pool, min_local=min_local):
        n -= 1
    if n < world:
        raise ValueError(f"patch depth {patch_d} does not shard {world} ways through {num_levels} pooling levels "
                         f"(pool {pool}, at least {min_local} plane(s) a rank): launch {n} rank(s) for "
                         "trainer.spatial_sharding")
    return space_mesh()


def _decoders(model):
    return list(getattr(model, "decoders", []))


def spatial_min_local(model) -> int:
    """Minimum local planes a rank needs: 2 for deconv upsampling (its fix-up
    gathers a 2-plane halo), else 1."""
    return 2 if any(d.upsample_mode == "deconv" for d in _decoders(model)) else 1


def spatial_pool_d(model) -> int:
    """D component of the model's pooling stride."""
    pools = [e.pool_kernel_size for e in model.encoders if e.pool_kernel_size is not None]
    return int(pools[0][0]) if pools else 1


def validate_spatial_model(model) -> None:
    """Raises ValueError for a model the sharded step would compute wrongly:
    a 2D model, BatchNorm (its statistics are not all-reduced under spatial
    sharding), deconv upsampling other than kernel 3 / stride 2 on every axis,
    and linear or area upsampling (a resize across the slab boundaries; JAX
    does not refuse it)."""
    if not model.is3d:
        raise ValueError("spatial sharding is for 3D models")
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules()):
        raise ValueError("BatchNorm is not supported under spatial sharding")
    for decoder in _decoders(model):
        mode = decoder.upsample_mode
        if mode == "deconv":
            conv = decoder.upsampling.upsample.conv_transposed
            if tuple(conv.stride) != (2, 2, 2) or tuple(conv.kernel_size) != (3, 3, 3):
                raise ValueError(f"spatial sharding supports deconv upsampling only for isotropic 2x scale "
                                 f"factors with kernel 3, got stride {tuple(conv.stride)}, kernel "
                                 f"{tuple(conv.kernel_size)}")
        elif mode not in (None, "nearest"):
            raise ValueError(f"upsample {mode!r} interpolates across the D slabs: spatial sharding supports "
                             "nearest, deconv or no upsampling")


def spatial_deconv_fixup_indices(mesh: Mesh, d_local: int, device=None) -> torch.Tensor:
    """Local D-gather indices reproducing `nearest-resize(2D - 1 -> 2D)` of a
    stride-2 / kernel-3 transposed conv under D sharding (JAX
    `spatial_deconv_fixup_indices`). The decoder computes the transposed conv
    without depth cropping on a 2-plane-haloed slab: local full-output plane
    j is global torch-output plane q = j + 2 * g0 - 5, g0 the slab's first
    global plane; final plane p takes q(p) = floor(p * (2D - 1) / (2D))."""
    n, idx = mesh.size, mesh.index
    total = n * d_local
    p = idx * (2 * d_local) + torch.arange(2 * d_local, device=device)
    q = (p * (2 * total - 1)) // (2 * total)
    return q - 2 * (idx * d_local) + 5


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, pad, dim):
        ctx.mesh, ctx.pad, ctx.dim = mesh, pad, dim
        n, idx = mesh.size, mesh.index
        # slot (r, 0): rank r's first planes; slot (r, 1): its last
        buf = x.new_zeros((n, 2, *x.narrow(dim, 0, pad).shape))
        buf[idx, 0] = x.narrow(dim, 0, pad)
        buf[idx, 1] = x.narrow(dim, x.shape[dim] - pad, pad)
        all_reduce_(buf, mesh)
        zeros = torch.zeros_like(buf[0, 0])
        left = buf[idx - 1, 1] if idx > 0 else zeros
        right = buf[idx + 1, 0] if idx < n - 1 else zeros
        return torch.cat([left, x, right], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, pad, dim = ctx.mesh, ctx.pad, ctx.dim
        n, idx = mesh.size, mesh.index
        d = g.shape[dim] - 2 * pad
        # the halos' cotangents go back to the planes they came from: my left
        # halo is my left neighbour's last planes, my right its first
        buf = g.new_zeros((n, 2, *g.narrow(dim, 0, pad).shape))
        if idx > 0:
            buf[idx - 1, 1] = g.narrow(dim, 0, pad)
        if idx < n - 1:
            buf[idx + 1, 0] = g.narrow(dim, pad + d, pad)
        all_reduce_(buf, mesh)
        dx = g.narrow(dim, pad, d).contiguous()
        dx.narrow(dim, 0, pad).add_(buf[idx, 0])
        dx.narrow(dim, d - pad, pad).add_(buf[idx, 1])
        return dx, None, None, None


def halo_exchange_d(x: torch.Tensor, mesh: Mesh, pad: int = 1, dim: int = 2) -> torch.Tensor:
    """`x` with `pad` planes of each neighbour's slab concatenated on both
    sides of `dim` (the D axis: 2 for NCDHW, 1 for NDHWC). Non-periodic: the
    outermost ranks get zero halos, torch's zero padding. One all-reduce each
    way; the backward adds each halo's cotangent to its owner's planes."""
    if x.shape[dim] < pad:
        raise ValueError(f"local depth {x.shape[dim]} < halo {pad}: increase the patch depth or reduce the "
                         "shard count")
    return _HaloExchange.apply(x, mesh, pad, dim)


def _spatial_dim(x) -> int:
    """The D axis of an (N, [C,] D, H, W) batch."""
    return x.ndim - 3


def spatial_loss(model, loss_criterion, mesh: Mesh, inp, target):
    """(loss, probs) of one D-sharded forward: this rank's slab through the
    model under `spatial_axis`, the loss on the logits and targets gathered
    over the mesh. probs stay this rank's slab."""
    with spatial_axis(mesh):
        probs, logits = model(inp)
    loss = loss_criterion(gather(logits, mesh, 2), gather(target, mesh, _spatial_dim(target)))
    return loss, probs


def build_spatial_accum_fns(model, loss_criterion, optimizer, mesh: Mesh, k: int):
    """Gradient-accumulation twins of `build_spatial_train_step` (JAX
    `build_spatial_accum_fns`): `grads_step(inp, target) -> (loss, probs)`
    adds one microbatch's gradients into the parameters' `.grad`;
    `apply_step()` sums them over the mesh, divides by k and steps the
    optimizer; `zeros()` clears them (parallel/mesh.py `step_fns`)."""
    return step_fns(model.parameters(), optimizer,
                    lambda inp, target: spatial_loss(model, loss_criterion, mesh, inp, target),
                    lambda: spatial_axis(mesh), ((mesh, False),), k)


def build_spatial_train_step(model, loss_criterion, optimizer, mesh: Mesh):
    """A D-sharded train step (JAX `build_spatial_train_step`):
    `step(inp, target) -> (loss, probs)` on this rank's slabs
    (`shard_spatial_batch`), the gradients summed over the mesh before the
    optimizer's step, so every rank makes the same update."""
    return train_step(*build_spatial_accum_fns(model, loss_criterion, optimizer, mesh, 1))


class DpSpMesh:
    """A 2-D grid of ranks, rank = data index * n_space + space index (JAX
    `dp_sp_mesh` with axes ('data', 'space')): `data` is this rank's column
    (the ranks of its space index), `space` its row."""

    def __init__(self, n_data: int, n_space: int):
        world = distributed.world_size()
        if n_data * n_space != world:
            raise ValueError(f"a {n_data} x {n_space} mesh needs {n_data * n_space} ranks, the world has {world}")
        rows = [tuple(d * n_space + s for s in range(n_space)) for d in range(n_data)]
        cols = [tuple(d * n_space + s for d in range(n_data)) for s in range(n_space)]
        # every rank makes every group, in one order
        groups = {ranks: group_of(ranks) for ranks in rows + cols}
        me = distributed.rank()
        row = rows[me // n_space]
        col = cols[me % n_space]
        self.space = Mesh(row, SPACE_AXIS, groups[row])
        self.data = Mesh(col, "data", groups[col])


def dp_sp_mesh(n_data: int, n_space: int) -> DpSpMesh:
    """The ('data', 'space') rank grid composing data and spatial parallelism."""
    return DpSpMesh(n_data, n_space)


def build_dp_sp_train_step(model, loss_criterion, optimizer, mesh: DpSpMesh):
    """The composed DP x SP step (JAX `build_dp_sp_train_step`):
    `step(inp, target) -> (loss, probs)` on this rank's batch shard's D-slab
    (`shard_dp_sp_batch`). The loss is each data shard's, on the logits
    gathered over the space mesh; the gradients are summed over 'space' and
    averaged over 'data', and so is the returned loss. Params-only models
    (validate_spatial_model refuses BatchNorm)."""
    validate_spatial_model(model)
    step = train_step(*step_fns(model.parameters(), optimizer,
                                lambda inp, target: spatial_loss(model, loss_criterion, mesh.space, inp, target),
                                lambda: spatial_axis(mesh.space), ((mesh.space, False), (mesh.data, True))))

    def dp_sp_step(inp, target):
        loss, probs = step(inp, target)
        return all_reduce_(loss.clone().reshape(1), mesh.data)[0] / mesh.data.size, probs

    return dp_sp_step


def build_spatial_eval_step(model, loss_criterion, mesh: Mesh):
    """Forward and loss over the space mesh (JAX `build_spatial_eval_step`):
    `step(inp, target) -> (probs, loss)`, probs this rank's slab."""

    def step(inp, target):
        with torch.no_grad():
            loss, probs = spatial_loss(model, loss_criterion, mesh, inp, target)
        return probs, loss

    return step


def _slab(x, mesh: Mesh, dim: int):
    d = x.shape[dim]
    if d % mesh.size:
        raise ValueError(f"D extent {d} does not split over the {mesh.size} ranks of the space mesh")
    local = d // mesh.size
    return x.narrow(dim, mesh.index * local, local)


def shard_spatial_batch(mesh: Mesh, tree):
    """This rank's D-slab of each (N, [C,] D, H, W) array or tensor of
    `tree` (a tuple or list); anything of fewer than 3 axes whole."""
    return type(tree)(_slab(x, mesh, _spatial_dim(x)) if x.ndim >= 3 else x for x in tree)


def shard_dp_sp_batch(mesh: DpSpMesh, tree):
    """(N, [C,] D, H, W) arrays: N over 'data', D over 'space'."""
    return shard_spatial_batch(mesh.space, type(tree)(_slab(x, mesh.data, 0) for x in tree))


def replicate_spatial(mesh: Mesh, tensors):
    """The replicated parameters and state across the space mesh (`replicate`)."""
    return replicate(mesh, tensors)


def conv_transpose_sharded(x, weight, mesh: Mesh, size):
    """The stride-2 / kernel-3 transposed conv of a deconv decoder on a
    D-slab, with its nearest fix-up to the skip's `size` (JAX blocks.py:705-760):
    a 2-plane halo, the conv without depth cropping, a nearest resize of H and
    W, and the fix-up gather along D."""
    d_local = x.shape[2]
    xh = halo_exchange_d(x, mesh, 2, dim=2)
    y = F.conv_transpose3d(xh, weight, None, stride=2, padding=(0, 1, 1))
    y = F.interpolate(y, size=(y.shape[2], *size[1:]), mode="nearest")
    return y.index_select(2, spatial_deconv_fixup_indices(mesh, d_local, y.device))
