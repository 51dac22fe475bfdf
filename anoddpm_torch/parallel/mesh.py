"""Data parallelism: one process per device under `torch.distributed`.

Counterpart of `anoddpm_tpu/parallel/mesh.py`.  JAX runs one program over
a 1-D ('data',) mesh: the batch is split along axis 0, the state is
replicated and XLA inserts the gradient all-reduce.  The port runs one
process per device instead (`torchrun --nproc_per_node=N`): each process
holds the whole state, keeps its contiguous rows of every global batch
(`Mesh.shard_batch`, as `P("data", ...)` splits axis 0), and
`DistributedDataParallel` averages the gradients (`data_parallel`).  NCCL
carries the collectives on the card, gloo on the CPU (or wherever the
caller asks for it).

Every rank draws the random numbers of the GLOBAL batch from one generator
seeded alike on all ranks and keeps its rows (`shard_sampler`), so a run on
W ranks computes what the run on one computes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike

# Long enough for rank 0's side work (a VLB sweep, a checkpoint) while the
# other ranks wait at a barrier; short enough that a lost rank fails the run.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the default
    process group)."""
    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of n."""
        if n % self.world_size:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.world_size} ranks")
        b = n // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)

    def shard_batch(self, x, axis: int = 0):
        """This rank's rows of x (a tensor or numpy array) along `axis`."""
        index = [slice(None)] * axis + [self.rows(x.shape[axis])]
        return x[tuple(index)]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of x over the ranks (a new tensor; no host sync)."""
        total = x.detach().to(self.device).clone()
        dist.all_reduce(total)
        return total / self.world_size

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (equal shapes) concatenated along axis 0, rank
        order, as a CPU tensor on every rank."""
        local = x.detach().to(self.device).contiguous()
        parts = [torch.empty_like(local) for _ in range(self.world_size)]
        dist.all_gather(parts, local)
        return torch.cat(parts).cpu()

    def broadcast_generator(self, generator: torch.Generator) -> None:
        """Give every rank rank 0's generator state (after work that only
        rank 0 did drew from it)."""
        state = generator.get_state().to(self.device)
        dist.broadcast(state, 0)
        generator.set_state(state.cpu())


def init_mesh(device: DeviceLike = None, backend: Optional[str] = None,
              init_method: str = "env://", rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join the process group and return this process's `Mesh`.

    rank and world_size default to torchrun's RANK and WORLD_SIZE, the
    address to its MASTER_ADDR/MASTER_PORT ("env://"); a test passes a
    "file://" rendezvous instead.  `device` None means card LOCAL_RANK;
    a card device without an index takes LOCAL_RANK too.  The backend is
    NCCL on a card and gloo on the CPU unless given."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return Mesh(rank, world_size, device, backend)


def mesh_from_env(device: DeviceLike = None) -> Optional[Mesh]:
    """A `Mesh` when torchrun started several processes (WORLD_SIZE > 1),
    else None."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    return init_mesh(device)


def close_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_sampler(sampler, mesh: Optional[Mesh]):
    """A noise sampler that draws the fields of the whole global batch
    (world_size x the rows asked for) and returns this rank's rows.

    The timesteps of the other ranks' rows are not known here; the local
    ones are tiled over the global batch.  Each field depends only on its
    own draws and its own t, so this rank's rows equal those of one process
    drawing the global batch at the global t.  Without a mesh (or with one
    rank) the sampler itself is returned."""
    if mesh is None or mesh.world_size == 1:
        return sampler
    w = mesh.world_size

    def sharded(shape, t, generator):
        b = shape[0]
        t = torch.broadcast_to(torch.as_tensor(t, device=generator.device),
                               (b,))
        full = sampler((b * w,) + tuple(shape[1:]), t.repeat(w), generator)
        return full[mesh.rank * b:(mesh.rank + 1) * b]

    return sharded


def data_parallel(module: torch.nn.Module,
                  mesh: Mesh) -> torch.nn.parallel.DistributedDataParallel:
    """`module` under DDP: gradients averaged over the ranks as they are
    produced.  The module keeps its own parameter names (checkpoints and
    the EMA read the module, never the wrapper).  Each parameter's
    gradient is a view of DDP's bucket, which saves copying every gradient
    back out of the bucket after the all-reduce (one copy launch per
    parameter on the host)."""
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=ids, gradient_as_bucket_view=True)
