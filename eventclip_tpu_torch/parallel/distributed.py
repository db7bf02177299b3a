"""Process groups, host-side collectives and the data-parallel reductions.

Port of eventclip_tpu/parallel/distributed.py on torch.distributed. Each
process (a rank) drives one device; `initialize_distributed()` joins the
ranks into one process group, the PrefetchLoader loads only this rank's
shard of every global batch (`host_shard_info`), and the train step
all-reduces the gradients, so every rank applies the same update.

`make_global_batch` has no counterpart: PyTorch runs eagerly, so there is
no global array to assemble. Each rank's step consumes its local shard,
and the gradient all-reduce (`all_reduce_mean_`) stands where GSPMD's
reduction stood.

Host collectives (`any_process_flag`, `allreduce_max_array`,
`gather_objects`, `barrier`) keep the JAX semantics: every rank calls them
at the same program point, and one process passes through. Under NCCL
they run on a gloo group made beside the NCCL one: NCCL cannot reduce CPU
tensors, and a host collective must not cost a device sync.

Under tensor parallelism the ranks form a ('data', 'model') layout, and
the functions that follow it take its `tp` (parallel/sharding.py's
TPContext, None without tensor parallelism): `host_shard_info(tp)` is
then (data_index, n_data), since the ranks of one model group load the
same rows and draw the same numbers; `all_reduce_mean_(..., tp)` averages
over the data group, and `model_all_reduce_sum_(..., tp)` sums over the
model group. The host collectives stay world-wide, and rank 0 of the
world (`process_index`) alone writes files.

Single-process runs are the common case and everything degrades to no-ops.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = None  # gloo group beside an NCCL default group


def launch_env() -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(coordinator, num_processes, process_id) from the launcher's
    environment: the JAX triple (`JAX_COORDINATOR_ADDRESS`,
    `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`, as scripts/submit_run.sh
    exports it), else torchrun's `MASTER_ADDR` / `MASTER_PORT` /
    `WORLD_SIZE` / `RANK`; (None, None, None) for a plain launch."""
    env = os.environ
    if env.get("JAX_COORDINATOR_ADDRESS"):
        return (env["JAX_COORDINATOR_ADDRESS"],
                int(env.get("JAX_NUM_PROCESSES", "1")),
                int(env.get("JAX_PROCESS_ID", "0")))
    if env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env["WORLD_SIZE"]), int(env.get("RANK", "0")))
    return None, None, None


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the process group; a no-op when single (no coordinator and at
    most one process) or when a group exists already.

    Without arguments the launcher's environment decides (`launch_env`).
    `coordinator` is 'host:port' (or a 'tcp://' URL). The backend is NCCL
    for a CUDA `device` and gloo for the CPU; `backend=` overrides it.
    NCCL refuses two ranks on one GPU, so ranks that share a card pass
    `backend="gloo"` (which stages CUDA tensors through the host)."""
    if dist.is_initialized():
        return
    if coordinator is None and num_processes is None:
        coordinator, num_processes, process_id = launch_env()
    if num_processes in (None, 1) and coordinator is None:
        return
    backend = backend or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes or 1),
                            rank=int(process_id or 0))
    global _HOST_GROUP
    _HOST_GROUP = dist.new_group(backend="gloo") if backend == "nccl" \
        else None


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def is_distributed() -> bool:
    """Whether a process group exists (even of one rank: then the
    reductions run and are copies)."""
    return dist.is_available() and dist.is_initialized()


def host_shard_info(tp=None) -> Tuple[int, int]:
    """(shard_index, num_shards) for the PrefetchLoader on this rank: the
    data index and n_data under tensor parallelism (`tp`), else the rank
    and the world size."""
    if not is_distributed():
        return 0, 1
    if tp is not None:
        return tp.data_index, tp.n_data
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    """This process's rank in the world (0 when single): rank 0 alone
    writes shared files."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes of the run (1 when single)."""
    return dist.get_world_size() if is_distributed() else 1


def any_process_flag(flag: bool) -> bool:
    """True on every process iff ANY process passed True.

    A deterministic collective: every process calls it at the same
    program point. The trainer uses it at epoch boundaries to agree on a
    graceful preemption exit (signal delivery skews across ranks).
    Single process: plain passthrough."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def allreduce_max_array(x) -> np.ndarray:
    """Elementwise max of an array across every process (host-side), as
    numpy. int8 calibration folds each rank's activation max-abs with it,
    so every rank quantizes the same teacher. Deterministic collective.
    Single process: passthrough (as numpy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if process_count() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return t.numpy()


def gather_objects(obj) -> List:
    """Every process's `obj` (small, picklable), as a list indexed by
    rank. Deterministic collective. Single process: `[obj]`."""
    world = process_count()
    if world == 1:
        return [obj]
    out: List = [None] * world
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def barrier() -> None:
    """Wait for every rank (host-side; no-op when single)."""
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def _staged(buf: torch.Tensor) -> bool:
    """A CUDA tensor under gloo goes through the host."""
    return buf.is_cuda and dist.get_backend() != "nccl"


def _all_reduce_sum_(buf: torch.Tensor, group=None) -> None:
    """In-place sum over the ranks of `group` (default: the world)."""
    if _staged(buf):
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank of `group`'s `t` (one shape on every rank), in the
    group's rank order; [t] without a process group."""
    if not is_distributed():
        return [t]
    n = dist.get_world_size(group)
    src = t.cpu() if _staged(t) else t
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src.contiguous(), group=group)
    return [o.to(t.device) for o in out]


def data_group(tp=None):
    """The group of ranks that share this rank's model index under `tp`
    (None: the world)."""
    return tp.data_group if tp is not None else None


def model_all_reduce_sum_(buf: torch.Tensor, tp) -> torch.Tensor:
    """In-place sum over this rank's model group of `tp` (the
    tensor-parallel partial sums); a no-op without tensor parallelism,
    and for a context made without a process group (no model group).
    Returns `buf`."""
    if tp is not None and tp.n_model > 1 and tp.model_group is not None:
        _all_reduce_sum_(buf, tp.model_group)
    return buf


def all_reduce_mean_(tensors: Sequence[torch.Tensor], tp=None) -> None:
    """Replace every tensor by its mean over the data group of `tp` (the
    world without tensor parallelism), in place, through one flat buffer,
    summed and divided by n_data (with one rank a copy, bit for bit).
    No-op without a process group, and for a tensor-parallel layout of
    one data group (its data groups are single ranks)."""
    if not is_distributed() or not tensors or (
            tp is not None and tp.n_data == 1):
        return
    n_data = host_shard_info(tp)[1]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce_sum_(flat, data_group(tp))
    if n_data > 1:
        flat.div_(n_data)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_sum(values: Dict[str, float]) -> Dict[str, float]:
    """{name: number} summed over ranks, host-side in float64 (one
    reduction); passthrough when single."""
    if process_count() == 1:
        return values
    keys = list(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, group=_HOST_GROUP)
    return dict(zip(keys, t.tolist()))


class RowShard:
    """A generator whose draws cover `total` rows of a global batch, of
    which this rank holds rows [lo, lo + n): every draw is made at the
    global leading size and sliced, so a data-parallel rank draws, for its
    rows, what one process on the global batch draws for them. One
    process holds RowShard(generator, 0, B)."""

    def __init__(self, generator: torch.Generator, lo: int, total: int):
        self.generator, self.lo, self.total = generator, int(lo), int(total)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's `n` rows of a global draw `t`."""
        return t[self.lo:self.lo + n]

    def rand(self, shape) -> torch.Tensor:
        """U[0, 1) of `shape`, whose dim 0 is this rank's rows."""
        full = torch.rand((self.total,) + tuple(shape[1:]),
                          generator=self.generator, device=self.device)
        return self.rows(full, shape[0])
