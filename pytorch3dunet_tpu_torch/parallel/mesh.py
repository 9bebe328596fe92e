"""Rank groups and the collectives of the port (pytorch3dunet_tpu/parallel/mesh.py).

A `Mesh` is one axis of the JAX package's device mesh: a tuple of ranks and
the process group that joins them. Every collective of the port is an
`all_reduce` or a `broadcast` over such a group, so one code path runs under
NCCL, gloo on the CPU and gloo on CUDA tensors (two ranks on one card, where
NCCL refuses them). A gather is the all-reduce of a zero-filled buffer in
which each rank wrote its own slice.

Data parallelism (JAX trainer.py with `choose_data_mesh`): every rank holds
the replicated parameters (`replicate`: a broadcast from the mesh's first
rank) and its own slice of the global batch; the loss is computed on the
logits and targets gathered over the data mesh (`gather`), so Dice
denominators and every batch-global term see the whole batch, as the JAX step
over one global array does. The differentiable collectives follow one
convention, stated in parallel/spatial.py: the gather's backward hands each
rank its own slice of the cotangent, the all-reduce's backward is an
all-reduce, and the parameter gradients are then summed over the mesh
(`reduce_gradients`). BatchNorm's batch moments are all-reduced over the
active data mesh (`data_axis`; models/blocks.py).

Without a process group (one process) a mesh has one rank and every
collective is the identity; with one, a mesh of one rank still calls the
backend, so world size 1 runs the real collectives.
"""

import contextlib
import threading

import torch
import torch.distributed as dist

from pytorch3dunet_tpu_torch.parallel import distributed

DATA_AXIS = "data"

# process groups by their ranks: `dist.new_group` is collective over the
# world, so each group is made once and every rank asks for the same ones
_GROUPS: dict = {}


class Mesh:
    """One mesh axis: `ranks` (ascending) and their process group (None for
    the whole world or without a runtime); `size` and this rank's `index`."""

    def __init__(self, ranks, name: str = DATA_AXIS, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.name = name
        self.group = group
        me = distributed.rank()
        self.index = self.ranks.index(me) if me in self.ranks else None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self):
        return f"Mesh({self.name}, ranks={self.ranks})"


def group_of(ranks):
    """The process group of `ranks`: None for every rank of the world, one
    made by `dist.new_group` otherwise (once per set; every rank of the world
    must ask for the same sets in the same order)."""
    ranks = tuple(ranks)
    if not distributed.is_initialized() or ranks == tuple(range(distributed.world_size())):
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def data_mesh(ranks=None) -> Mesh:
    """A data mesh over `ranks` (every rank by default)."""
    ranks = tuple(range(distributed.world_size())) if ranks is None else tuple(ranks)
    return Mesh(ranks, DATA_AXIS, group_of(ranks))


def host_mesh(name: str = DATA_AXIS) -> Mesh:
    """The ranks of this rank's host (a JAX host's local devices) and their group."""
    return Mesh(distributed.host_ranks(), name, distributed.host_group())


def choose_data_mesh(batch_size: int, world: int | None = None) -> Mesh:
    """The data mesh for a global batch of `batch_size`: the largest rank
    count that divides it (JAX `choose_data_mesh`). A rank cannot sit a step
    out the way an unused JAX device does, so a count below the world size
    raises and names the batch to use (ROADMAP F11)."""
    world = distributed.world_size() if world is None else world
    k = max(d for d in range(1, min(world, max(batch_size, 1)) + 1) if batch_size % d == 0)
    if k < world:
        raise ValueError(f"a global batch of {batch_size} does not split over {world} ranks: use a batch that "
                         f"{world} divides, or launch {k} rank(s)")
    return data_mesh()


def _collective(mesh: Mesh) -> bool:
    """Whether a collective over `mesh` calls the backend (a runtime exists)."""
    if distributed.is_initialized():
        return True
    if mesh.size > 1:
        raise RuntimeError(f"{mesh} spans {mesh.size} ranks but no process group is initialized")
    return False


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=None) -> torch.Tensor:
    """In-place all-reduce of `t` over the mesh (sum by default); returns `t`."""
    if _collective(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place broadcast of `t` from the mesh's first rank; returns `t`. A
    CPU tensor (an optimizer's step count) crosses NCCL through the card."""
    if _collective(mesh):
        if t.device.type == "cpu" and dist.get_backend(mesh.group) == "nccl":
            staged = t.to(torch.device("cuda", torch.cuda.current_device()))
            dist.broadcast(staged, src=mesh.ranks[0], group=mesh.group)
            t.copy_(staged)
        else:
            dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, g):
        # every rank used the sum: the cotangent of each addend is the sum of theirs
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of `x` over the mesh (JAX `psum`)."""
    return _AllReduceSum.apply(x, mesh)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.length = mesh, dim, x.shape[dim]
        return _gather_values(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        # each rank's own slice: the loss is one function of the gathered
        # tensor, which every rank computes alike, so it is counted once
        return g.narrow(ctx.dim, ctx.mesh.index * ctx.length, ctx.length).contiguous(), None, None


def gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' equal slices of `x` concatenated along `dim` in mesh order
    (JAX `all_gather(..., tiled=True)`), through an all-reduce of a
    zero-filled buffer; differentiable when `x` needs a gradient (backward:
    this rank's slice of the cotangent)."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _gather_values(x, mesh, dim)
    return _Gather.apply(x, mesh, dim)


def _gather_values(x, mesh, dim):
    shape = list(x.shape)
    shape[dim] *= mesh.size
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.index * x.shape[dim], x.shape[dim]).copy_(x)
    return all_reduce_(buf, mesh)


def replicate(mesh: Mesh, tensors) -> list:
    """Broadcasts each tensor in place from the mesh's first rank (the
    replicated parameters, buffers and optimizer state); a module gives its
    parameters and buffers. Returns the tensors."""
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    tensors = list(tensors)
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, mesh)
    return tensors


def optimizer_state_tensors(optimizer) -> list:
    """The tensors of an optimizer's state, in parameter order (what
    `replicate` broadcasts at start and resume)."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            for value in optimizer.state.get(p, {}).values():
                if torch.is_tensor(value):
                    out.append(value)
    return out


def reduce_gradients(params, mesh: Mesh, mean: bool = False):
    """Sums (`mean`: averages) every parameter's gradient over the mesh, in
    one all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not _collective(mesh):
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh)
    if mean:
        flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def shard_batch(mesh: Mesh, x, ragged_replicated_ok: bool = False):
    """This rank's slice of a global batch along its leading axis (JAX
    `shard_batch`). A batch the mesh does not divide is returned whole, as
    the replicated array, only when the caller vouches that every rank holds
    the same values (`ragged_replicated_ok`: validation batches); otherwise
    it raises, since different samples in a "replicated" batch would make
    the replicas diverge."""
    n = x.shape[0] if getattr(x, "ndim", 0) else None
    if n is not None and n % mesh.size == 0:
        per = n // mesh.size
        return x[mesh.index * per:(mesh.index + 1) * per]
    if not ragged_replicated_ok:
        raise ValueError(f"batch axis {n} does not divide the {mesh.size} ranks of the data mesh and the ranks' "
                         "batches may differ: pick a batch size the rank count divides")
    return x


_ACTIVE_DATA = threading.local()


def active_data_axis() -> Mesh | None:
    """The data mesh of the step being traced, or None (read by BatchNorm)."""
    stack = getattr(_ACTIVE_DATA, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def data_axis(mesh: Mesh):
    """Marks `mesh` as the data axis for the ops run inside (BatchNorm's
    batch moments all-reduce over it)."""
    stack = _ACTIVE_DATA.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield
    finally:
        stack.pop()


def step_fns(params, optimizer, loss_fn, scope, reductions=(), k: int = 1):
    """The three functions every train step of the port is made of (JAX
    `grads_step`, `apply_step`, `zeros`):
    - `grads_step(inp, target) -> (loss, probs)` runs `loss_fn(inp, target)`
      and its backward inside `scope()` (a backward that recomputes levels,
      `model.remat`, meets the same collectives) and adds the gradients into
      the parameters' `.grad`;
    - `apply_step()` reduces the gradients over each `(mesh, mean)` of
      `reductions`, divides them by k and steps the optimizer (the reductions
      are linear: one per update gives what one per microbatch would);
    - `zeros()` clears them."""
    params = list(params)

    def grads_step(inp, target):
        with scope():
            loss, probs = loss_fn(inp, target)
            loss.backward()
        return loss.detach(), probs.detach()

    def apply_step():
        for mesh, mean in reductions:
            reduce_gradients(params, mesh, mean=mean)
        if k > 1:
            torch._foreach_div_([p.grad for p in params if p.grad is not None], k)
        optimizer.step()

    def zeros():
        optimizer.zero_grad(set_to_none=True)

    return grads_step, apply_step, zeros


def train_step(grads_step, apply_step, zeros):
    """One update from one batch out of a `step_fns` triple (built with k = 1):
    `step(inp, target) -> (loss, probs)`."""

    def step(inp, target):
        zeros()
        loss, probs = grads_step(inp, target)
        apply_step()
        return loss, probs

    return step


def data_parallel_loss(model, loss_criterion, mesh: Mesh, inp, target):
    """(loss, probs) of one data-parallel forward: this rank's batch through
    the model under `data_axis`, the loss on the logits and targets gathered
    over the mesh (the global batch). `step_fns` runs the backward inside
    `data_axis(mesh)` too, for a model that recomputes levels (`model.remat`)."""
    with data_axis(mesh):
        probs, logits = model(inp)
    loss = loss_criterion(gather(logits, mesh, 0), gather(target, mesh, 0))
    return loss, probs
