"""BEV row sharding and channel parallelism over a process group.

Port of ``v2x_sim_tpu/parallel/spatial.py``'s manual path, and of what the
JAX package leaves to XLA's SPMD partitioner: the whole models under
``spatial_mesh`` (the row pins of ``models/det/net.py`` and
``models/seg/unet.py``) and the channel-sharded conv of
``tests/test_spatial.py``. The BEV plane's rows (dim 2 of the port's NCHW
maps and of its (B, A, H, W, ...) tensors) are split over the spatial
group in rank order. Every op here, given each rank's rows, returns each
rank's rows of the unsharded op's result:

  * ``halo_exchange_rows``: a shard padded with one row of each
    neighbour (zeros at the global edges, the backbone's pad of 1);
  * ``conv3x3_halo`` (stride 1, optional bias) and ``conv3x3s2_halo``
    (stride 2): the halo rows, the columns padded locally, an unpadded
    conv;
  * ``upsample_bilinear_halo``: the 2x bilinear upsample
    (``interpolate(align_corners=False)``) of a shard;
  * ``max_pool2x2_rows``: the 2x2 pool, local when each shard's row count
    is even;
  * ``gather_rows`` / ``take_rows``: the whole map from the shards, and a
    rank's rows of a whole map, where an op needs every row (the fusion's
    warp, the predict's decode);
  * ``conv3x3_channel_parallel``: a 3x3 conv whose input channels are
    split over the group, the partial outputs summed in one all-reduce.

Each exchange is one ``all_reduce`` of a zeroed (n, ...) buffer in which
each rank fills its own slot; each rank then reads the slots it needs. It
moves n times the bytes it must, but it is differentiable by construction
(``mesh.psum``: the gradient returns through the reverse exchange) and
uses only a collective that gloo also runs on CUDA tensors. The backward
runs these all-reduces wherever autograd reaches them, and the ranks must
meet in the same order: every rank builds the same graph (the edge ranks
mask a neighbour's slot to zero instead of leaving it out), so autograd
walks it in the same order on each.

``models/backbone.py`` calls these ops when a model has a spatial group;
the manual path sits on the same code:

  * ``make_spatial_stem`` / ``make_spatial_encoder``: the stride-1 stem
    and the 5-stage STPN encoder in inference BatchNorm, from the port's
    own ``ConvBlock`` weights;
  * ``make_spatial_stem_train_step``: one SGD step of the stem, its
    BatchNorm's batch moments averaged over the group, loss = the squared
    error summed over the group / the element count summed over it,
    gradients summed over the group and divided by that count.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from v2x_sim_tpu_torch.parallel.mesh import Mesh, all_reduce_, psum

if TYPE_CHECKING:
    from v2x_sim_tpu_torch.models.backbone import ConvBlock, STPNEncoder


def _gather_slots(piece: torch.Tensor, group) -> torch.Tensor:
    """(n, *piece.shape): every rank's ``piece`` in rank order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    zero = torch.zeros_like(piece)
    return psum(torch.stack([piece if i == r else zero for i in range(n)]), group)


def halo_exchange_rows(x: torch.Tensor, group) -> torch.Tensor:
    """A row shard (B, C, H_loc, W) padded to (B, C, H_loc + 2, W) with
    the row of the shard above and the row of the shard below (zeros at
    the global edges)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    edges = _gather_slots(torch.stack([x[:, :, :1], x[:, :, -1:]]), group)
    above = _masked(edges[(r - 1) % n, 1], r > 0)
    below = _masked(edges[(r + 1) % n, 0], r < n - 1)
    return torch.cat([above, x, below], dim=2)


def _masked(t: torch.Tensor, keep: bool) -> torch.Tensor:
    """``t``, or zeros of its shape through the same graph node (see the
    module docstring: the ranks' graphs must not differ)."""
    return torch.where(torch.tensor(keep, device=t.device), t, torch.zeros((), dtype=t.dtype,
                                                                           device=t.device))


def conv3x3_halo(x: torch.Tensor, weight: torch.Tensor, group,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 3x3 conv (pad 1) of a row shard: the halo rows, the
    columns padded locally, an unpadded conv. Same shape out. The params
    are cast to the activation dtype; in bf16 the bias is added to the
    rounded conv output, as ``models/backbone.py::_conv`` adds it."""
    xh = F.pad(halo_exchange_rows(x, group), (1, 1))
    w = weight.to(x.dtype)
    if bias is None or x.dtype != torch.bfloat16:
        return F.conv2d(xh, w, None if bias is None else bias.to(x.dtype))
    return F.conv2d(xh, w) + bias.to(x.dtype)[:, None, None]


def conv3x3s2_halo(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """Stride-2 3x3 conv (pad 1, no bias) of a row shard with an even row
    count: output row k reads input rows 2k-1..2k+1, so the shard needs
    one row from the shard above (zeros on the first) and none from
    below, and emits H_loc / 2 rows."""
    if x.shape[2] % 2:
        raise ValueError(f"a stride-2 shard needs an even row count, got {tuple(x.shape)}")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    bottoms = _gather_slots(x[:, :, -1:], group)
    above = _masked(bottoms[(r - 1) % n], r > 0)
    xh = F.pad(torch.cat([above, x], dim=2), (1, 1))
    return F.conv2d(xh, weight.to(x.dtype), stride=2)


def upsample_bilinear_halo(x: torch.Tensor, group) -> torch.Tensor:
    """The 2x bilinear upsample (``models/backbone.py::upsample_bilinear``,
    ``align_corners=False``, bf16's rows-then-columns rounding included)
    of a row shard: (B, C, h, W) -> (B, C, 2h, 2W), this rank's rows of
    the upsampled map.

    Output row k reads input rows floor((k + 1/2) / 2 - 1/2) and the one
    after, so a shard needs one row from each neighbour. At scale exactly
    1/2, upsampling the shard with its neighbours' rows, (h + 1 or 2)
    rows to twice as many, gives the unsharded output rows, each from the
    same two input rows at the same weights, and 2 rows a neighbour are
    cropped. At the global top and bottom there is no neighbour row: there
    the unsharded upsample clamps to the edge row, and so does the
    shard's, whose own edge is that row."""
    from v2x_sim_tpu_torch.models.backbone import upsample_bilinear  # it imports this module

    n, r = dist.get_world_size(group), dist.get_rank(group)
    top, bottom = int(r > 0), int(r < n - 1)
    xh = halo_exchange_rows(x, group)
    xh = xh[:, :, 1 - top:xh.shape[2] - 1 + bottom]
    y = upsample_bilinear(xh, (2 * xh.shape[2], 2 * x.shape[3]))
    return y[:, :, 2 * top:y.shape[2] - 2 * bottom]


def max_pool2x2_rows(x: torch.Tensor) -> torch.Tensor:
    """The 2x2, stride-2 max pool of a row shard. Shards start at even
    global rows when every shard's row count is even, and then no window
    crosses a border; an odd count raises."""
    if x.shape[2] % 2:
        raise ValueError(f"a pooled shard needs an even row count, got {tuple(x.shape)}")
    return F.max_pool2d(x, 2, 2)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The whole map from every rank's row shard (dim 2), in rank order,
    on every rank. Differentiable: each rank's whole map feeds its own
    loss, and a shard's gradient is the sum over the ranks of the
    cotangent of its rows (``mesh.psum``'s transpose)."""
    return torch.cat(_gather_slots(x, group).unbind(0), dim=2)


def take_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows ``[r·H/n, (r+1)·H/n)`` of a whole map (dim 2), r
    being its rank in ``group`` of n."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    h = x.shape[2]
    if h % n:
        raise ValueError(f"{h} rows do not split over {n} ranks")
    return x[:, :, r * (h // n):(r + 1) * (h // n)]


def conv3x3_channel_parallel(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """A 3x3 conv (pad 1, no bias) with its input channels split over
    ``group``: ``x`` (B, C_in/n, H, W) is this rank's slice of the input's
    channels and ``weight`` (C_out, C_in/n, 3, 3) the kernel's matching
    slice. Each rank convolves its slice, and the partial outputs meet in
    one all-reduce: every rank gets the whole (B, C_out, H, W) output.

    The all-reduce's transpose is an all-reduce of the cotangents (each
    rank's output feeds its own loss, and the step's loss is the sum of
    the ranks'). So when every rank takes the same loss of the replicated
    output, the gradients are n times that loss's: divide the loss by n,
    or let one rank's loss alone drive the backward."""
    return psum(F.conv2d(x, weight.to(x.dtype), padding=1), group)


def _block_shard(x: torch.Tensor, block: ConvBlock, group, train: bool = False) -> torch.Tensor:
    """A ``ConvBlock`` on a row shard over ``group``; train-mode BatchNorm
    averages its moments over ``group`` and updates the block's running
    stats."""
    return block.run(x, train, group if train else None, group)


def make_spatial_stem(mesh: Mesh, block: ConvBlock) -> Callable[[torch.Tensor], torch.Tensor]:
    """The stride-1 stem ``block`` (an ``STPNEncoder``'s ``blocks[0]``) in
    inference BatchNorm over the mesh's spatial group: fn(x shard) -> y
    shard, rows as ``shard_rows`` gives them."""
    return lambda x: _block_shard(x, block, mesh.spatial_group)


def make_spatial_encoder(mesh: Mesh, encoder: STPNEncoder
                         ) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Every stage of ``encoder`` in inference BatchNorm over the mesh's
    spatial group: fn(x shard) -> every stage's map, each a row shard. The
    global H must keep each shard's rows even through every stride-2
    stage: H % (n · 2^(stages-1)) == 0."""

    def run(x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for block in encoder.blocks:
            x = _block_shard(x, block, mesh.spatial_group)
            feats.append(x)
        return feats

    return run


def make_spatial_stem_train_step(mesh: Mesh, block: ConvBlock, learning_rate: float = 0.1
                                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One SGD step of the stem ``block`` on row shards: fn(x, target)
    -> the global mean squared error (before the step). The block's
    parameters take the step and its running stats the synced moments,
    identically on every rank: the unsharded full-batch step."""
    group = mesh.spatial_group
    params = list(block.parameters())

    def step(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        block.zero_grad(set_to_none=True)
        y = _block_shard(x, block, group, train=True)
        lsum = ((y - target) ** 2).sum()
        lsum.backward()
        totals = torch.stack([lsum.detach(), lsum.new_tensor(float(y.numel()))])
        all_reduce_([totals], group)
        grads = [p.grad for p in params]
        all_reduce_(grads, group)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(learning_rate * (g / totals[1]))
        return totals[0] / totals[1]

    return step


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows ``[s·H/n, (s+1)·H/n)`` of an NCHW map, s being its
    spatial index of n."""
    n, s = mesh.shape[1], mesh.spatial_index
    h = x.shape[2]
    if h % n:
        raise ValueError(f"{h} rows do not split over {n} spatial ranks")
    return x[:, :, s * (h // n):(s + 1) * (h // n)]
