"""Process groups for data parallelism and row sharding.

Port of ``v2x_sim_tpu/parallel/mesh.py``. JAX drives N devices from one
process under ``shard_map``; here each device is one process (a rank) of
a ``torch.distributed`` world, and the mesh lays the ranks out as
(data, spatial): rank r sits at (r // spatial, r % spatial).

The data-parallel step keeps JAX's contract: an N-rank step is the
single-process step on the global batch. So

  * the loss terms are local sums over globally summed counts
    (``train/det_module.py``, ``train/seg_module.py``);
  * gradients are summed over ``data`` (psum), not averaged, before
    clipping and Adam;
  * train-mode BatchNorm averages its batch moments over ``data`` in the
    forward, and the gradient flows through that average
    (``models/backbone.py::_bn``).

``DistributedDataParallel`` averages gradients, syncs no BatchNorm and
broadcasts rank 0's buffers on every forward; ``torch.nn.SyncBatchNorm``
keeps an unbiased running variance. So the collectives are written out
here. Every one is a ``broadcast`` or an ``all_reduce``, the collectives
gloo also runs on CUDA tensors: the same code runs on NCCL (one card a
rank), on the CPU over gloo, and on gloo ranks that share one card.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

#: How long a collective, or the rendezvous, waits for the other ranks.
DEFAULT_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, spatial) layout of the world.

    ``data_group`` holds the ranks at this rank's spatial index (the batch
    is split over them), ``spatial_group`` the ranks at its data index
    (the rows are split over them, in rank order). A group spanning the
    whole world is the default group.
    """

    shape: Tuple[int, int]
    rank: int
    device: torch.device
    data_group: Any
    spatial_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def spatial_index(self) -> int:
        return self.rank % self.shape[1]


def make_mesh(
    num_devices: int,
    spatial: int = 1,
    *,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """Lay the world of ``num_devices`` ranks out as (num_devices // spatial,
    spatial), joining it first as ``rank`` through ``init_method`` unless
    the default process group is already up. Every rank calls this, with
    the same layout.

    By default rank r uses NCCL on ``cuda:r`` (one host), and raises when
    the host has fewer cards than ranks: a card is never shared silently.
    ``device="cpu"`` uses gloo. A ``backend`` and a ``device`` passed
    together are used as given (gloo on ``cuda:0`` for ranks that share
    one card).
    """
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError("joining the world needs rank and init_method")
        world = num_devices
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_devices != world:
            raise ValueError(f"the world has {world} ranks, not {num_devices}")
    if world % spatial:
        raise ValueError(f"{world} ranks do not split over a {SPATIAL_AXIS} axis of {spatial}")
    if device is None:
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"{world} ranks need {world} CUDA cards, this host has "
                f"{torch.cuda.device_count()}; pass device='cpu' to run on the CPU")
        device = f"cuda:{rank}"
    device = torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=timeout)
    n_data = world // spatial
    # new_group is collective: every rank creates every subgroup, in order.
    data_groups = ([dist.group.WORLD] if spatial == 1 else
                   [dist.new_group([d * spatial + s for d in range(n_data)]) for s in range(spatial)])
    spatial_groups = ([dist.group.WORLD] if n_data == 1 else
                      [dist.new_group([d * spatial + s for s in range(spatial)]) for d in range(n_data)])
    return Mesh((n_data, spatial), rank, device,
                data_groups[0 if spatial == 1 else rank % spatial],
                spatial_groups[0 if n_data == 1 else rank // spatial])


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows ``[i·B/N, (i+1)·B/N)`` of every entry of a global
    batch (numpy arrays or tensors), i being its data index of N: JAX's
    ``P(DATA_AXIS)``. Raises when B does not split evenly."""
    n, i = mesh.shape[0], mesh.data_index
    out = {}
    for key, value in batch.items():
        b = value.shape[0]
        if b % n:
            raise ValueError(f"{key}: a batch of {b} does not split over {n} {DATA_AXIS} ranks")
        out[key] = value[i * (b // n):(i + 1) * (b // n)]
    return out


class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over a group, whose transpose is the sum of the
    cotangents over the group (each rank's output feeds its own loss, and
    the loss of the step is the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_list(group) -> List[Any]:
    """The groups a collective here runs over, in order: none for None,
    the group itself, or each group of a sequence in turn (a sum over
    data ranks of sums over spatial ranks is the sum over the mesh)."""
    if group is None:
        return []
    if isinstance(group, (list, tuple)):
        return [g for g in group if g is not None]
    return [group]


def group_size(group) -> int:
    """The number of ranks a collective over ``group`` (as ``group_list``
    reads it) sums over: the product of the groups' sizes, 1 for none."""
    size = 1
    for g in group_list(group):
        size *= dist.get_world_size(g)
    return size


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a group, or a sequence of groups
    summed over in turn), differentiable (see _AllReduceSum)."""
    for g in group_list(group):
        x = _AllReduceSum.apply(x, g)
    return x


@torch.no_grad()
def _flat_(tensors: Sequence[torch.Tensor], collective: Callable[[torch.Tensor], None],
           device: Optional[torch.device] = None) -> None:
    """Run ``collective`` in place on one flat buffer a dtype holding every
    tensor (on ``device``, by default the tensors'), and copy back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(device or ts[0].device) for t in ts])
        collective(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def all_reduce_(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` (see ``group_list``) in place, one
    all_reduce a dtype and group; a no-op without a group."""
    tensors = list(tensors)
    for g in group_list(group):
        _flat_(tensors, lambda flat: dist.all_reduce(flat, group=g))


def average_(tensors: Iterable[torch.Tensor], group) -> None:
    """Average every tensor over ``group`` in place (JAX's pmean: the sum
    over the group's size); a no-op without a group. It is for tensors
    the ranks already hold alike (the running stats of synced BatchNorm),
    and checks that they do: it raises when the average moved an entry by
    more than the rounding of n equal terms summed and divided by n. A
    sequence of groups is averaged over in turn."""
    tensors = list(tensors)
    for g in group_list(group):
        n = dist.get_world_size(g)

        def mean(flat, g=g, n=n):
            before = flat.clone()
            dist.all_reduce(flat, group=g)
            flat.div_(n)
            tol = n * torch.finfo(flat.dtype).eps
            if bool(((flat - before).abs() > tol * before.abs()).any()):
                raise RuntimeError(f"the {n} ranks held different values before their average")

        _flat_(tensors, mean)


def sum_metrics(metrics: Mapping[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The scalar metrics summed over ``group`` (see ``group_list``) in
    one all_reduce a group (as they are without a group)."""
    groups = group_list(group)
    if not groups:
        return dict(metrics)
    keys = list(metrics)
    vals = [metrics[k].detach() for k in keys]
    dtype = vals[0].dtype
    for v in vals[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    flat = torch.stack([v.to(dtype) for v in vals])
    for g in groups:
        dist.all_reduce(flat, group=g)
    return dict(zip(keys, flat.unbind()))


def replicate(module, mesh: Mesh) -> None:
    """Broadcast a task module's (``DetModule``, ``SegModule``) state from
    rank 0 to every rank in place: the model's parameters and buffers, the
    KD teacher's, and the optimizer's state tensors by parameter (JAX's
    ``P()`` placement of the train state and the teacher). Tensors off the
    mesh's device (Adam's step counts) go through it."""
    state = [*module.model.parameters(), *module.model.buffers()]
    teacher = getattr(module, "teacher", None)
    if teacher is not None:
        state += [*teacher.parameters(), *teacher.buffers()]
    for group in module.optimizer.param_groups:
        for p in group["params"]:
            opt = module.optimizer.state.get(p, {})
            state += [opt[k] for k in sorted(opt) if torch.is_tensor(opt[k])]
    _flat_(state, lambda flat: dist.broadcast(flat, 0), mesh.device)


def _rank_entry(fn: Callable, rank: int, world: int, init_method: str, args: tuple,
                results) -> None:
    try:
        results.put((rank, True, fn(rank, world, init_method, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, store_dir: str,
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes and return their results in rank order (JAX's one process
    driving N devices). ``init_method`` is a file store in ``store_dir``,
    which must be empty of an earlier world's. A rank that raises, dies or
    outlives ``timeout`` seconds fails the call: the other ranks are
    stopped, and RuntimeError carries the rank's traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = "file://" + os.path.abspath(os.path.join(store_dir, "store"))
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, init_method, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks did not finish in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == world else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
