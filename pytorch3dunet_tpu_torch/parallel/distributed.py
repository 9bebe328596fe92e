"""Multi-process entry: `torch.distributed` from the JAX package's environment
variables (pytorch3dunet_tpu/parallel/distributed.py).

Every process runs the same `train` or `predict` invocation:

    P3DUNET_COORDINATOR=host0:1234 P3DUNET_NUM_PROCESSES=4 P3DUNET_PROCESS_ID=k \\
        python -m pytorch3dunet_tpu_torch.train --config ...

`P3DUNET_COORDINATOR` is the `tcp://` rendezvous, `P3DUNET_NUM_PROCESSES` the
world size and `P3DUNET_PROCESS_ID` the rank. One process drives one GPU,
`cuda:{rank % torch.cuda.device_count()}`, over NCCL; with `device: cpu` the
processes talk over gloo. Without `P3DUNET_COORDINATOR` nothing is set up and
the port runs as one process.

A JAX *process* (host) is the set of ranks that share a hostname here, and its
*local devices* are those ranks (parallel/__init__.py): `process_index` and
`process_count` count hosts, `local_mesh` is the host's ranks.
"""

import os
import socket

import torch
import torch.distributed as dist

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("Distributed")

# the host layout, computed once by `initialize_from_env` (every rank gathers
# the hostnames and builds each host's group in the same order)
_HOSTS: dict = {}


def _hostname() -> str:
    return socket.gethostname()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def initialize_from_env(device="cuda") -> bool:
    """Initializes the default process group from the P3DUNET_* variables;
    returns True when a multi-process runtime was set up (or already was),
    False without `P3DUNET_COORDINATOR`.

    `device` is the config's resolved device: CUDA selects NCCL and this
    rank's card, the CPU gloo. A failed rendezvous raises: nothing falls back
    to one process."""
    coordinator = os.environ.get("P3DUNET_COORDINATOR")
    if not coordinator:
        return False
    if is_initialized():
        return True
    num_processes = int(os.environ["P3DUNET_NUM_PROCESSES"])
    process_id = int(os.environ["P3DUNET_PROCESS_ID"])
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    logger.info(f"init_process_group({backend}, tcp://{coordinator}, world_size={num_processes}, "
                f"rank={process_id})")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, **kwargs)
    build_host_groups()
    logger.info(f"rank {process_id}/{num_processes}: host {process_index()}/{process_count()}, "
                f"{len(_HOSTS['ranks'])} rank(s) on this host, device {device_for_rank(device)}")
    return True


def build_host_groups():
    """Gathers every rank's hostname once and makes one group per host, in
    the order of each host's first rank (every rank makes every group, as
    `dist.new_group` requires). `initialize_from_env` calls it; a caller that
    makes the default process group itself calls it next."""
    names = [None] * world_size()
    dist.all_gather_object(names, _hostname())
    hosts = list(dict.fromkeys(names))
    groups = {host: dist.new_group([r for r, n in enumerate(names) if n == host]) for host in hosts}
    mine = names[rank()]
    _HOSTS.update(index=hosts.index(mine), count=len(hosts), group=groups[mine],
                  ranks=tuple(r for r, n in enumerate(names) if n == mine))


def shutdown():
    """Destroys the process group (end of a multi-process run)."""
    if is_initialized():
        dist.destroy_process_group()
    _HOSTS.clear()


def device_for_rank(device) -> torch.device:
    """This rank's device: `cuda:{rank % device count}` for a CUDA device
    under a multi-process runtime, the device itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and is_initialized():
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return device


def process_index() -> int:
    """The index of this rank's host (JAX `process_index`)."""
    return _HOSTS.get("index", 0)


def process_count() -> int:
    """The number of hosts (JAX `process_count`)."""
    return _HOSTS.get("count", 1)


def host_ranks() -> tuple:
    """The ranks on this rank's host, ascending (JAX's local devices)."""
    return _HOSTS.get("ranks", (rank(),))


def host_group():
    """The process group of this rank's host (None without a runtime)."""
    return _HOSTS.get("group")


def local_rank() -> int:
    """This rank's position among its host's ranks."""
    return host_ranks().index(rank())


def _scalar_device():
    """Where a collective's tensor lives: NCCL takes CUDA tensors only."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_int(value: int, op=None, group=None) -> int:
    """`value` reduced over the group (sum by default; `dist.ReduceOp.MIN`,
    MAX); the value itself without a runtime."""
    if not is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_scalar_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return int(t.item())


def broadcast_object(obj, src: int = 0):
    """`obj` as rank `src` has it, on every rank (picklable; itself without a runtime)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_file_paths(file_paths: list, process_id: int | None = None, num_processes: int | None = None,
                     allow_empty: bool = False) -> list:
    """Round-robin split of input files across hosts (JAX
    `shard_file_paths`): each host feeds its ranks from disjoint volumes.

    Callers pass a deterministically ordered list (sorted after directory
    expansion) so every host computes the same assignment. `allow_empty`:
    prediction shards may be empty (a host with no files writes nothing);
    training shards wrap instead, so every host can sample."""
    if process_id is None:
        process_id = process_index()
    if num_processes is None:
        num_processes = process_count()
    if num_processes <= 1:
        return list(file_paths)
    mine = [p for i, p in enumerate(file_paths) if i % num_processes == process_id]
    if not mine and allow_empty:
        return []
    if not mine:
        # fewer files than hosts: the data-less host shares ONE volume rather
        # than the whole corpus, which would double-weight every sample
        mine = [file_paths[process_id % len(file_paths)]]
        logger.warning(f"Multi-host: {len(file_paths)} train files for {num_processes} processes -- process "
                       f"{process_id} shares {mine[0]} with another host. Provide at least one file per host for "
                       "disjoint sampling.")
    return mine
