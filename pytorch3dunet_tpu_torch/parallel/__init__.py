"""Parallelism of the port: multi-process init, data parallelism and spatial
(D-axis) sharding over `torch.distributed` (pytorch3dunet_tpu/parallel/).

The device mapping. One torch process (a rank) drives one GPU,
`cuda:{rank % torch.cuda.device_count()}`, or runs on the CPU under gloo. The
JAX package's notions map onto ranks:
- a JAX *process* (host) is the set of ranks that share a hostname
  (`distributed.process_index`, `process_count`): train files shard across
  hosts (`shard_file_paths`), and so do prediction files;
- a JAX host's *local devices* are those ranks (`distributed.host_ranks`,
  `host_group`): the sharded sweeps split a volume's patch grid, or each
  patch's depth, across them;
- a JAX mesh axis is a `Mesh` (parallel/mesh.py): ranks and their process
  group. The data mesh spans every rank (`choose_data_mesh`), the space mesh
  too (`spatial.choose_space_mesh`), `spatial.dp_sp_mesh` is a 2-D grid of
  both.

Every collective is an `all_reduce` or a `broadcast`, so the same code runs
under NCCL, under gloo on the CPU, and under gloo on CUDA tensors. A torch rank
cannot sit out a step the way an unused JAX device can: where the JAX package
would use fewer devices than there are, the port raises and names the world
size to launch with (ROADMAP F11).
"""

from pytorch3dunet_tpu_torch.parallel.distributed import initialize_from_env, shard_file_paths
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh, choose_data_mesh, data_mesh, replicate, shard_batch

__all__ = ["Mesh", "choose_data_mesh", "data_mesh", "initialize_from_env", "replicate", "shard_batch",
           "shard_file_paths"]
