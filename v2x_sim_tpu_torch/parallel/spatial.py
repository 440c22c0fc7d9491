"""BEV row sharding: halo-exchange convs over the mesh's ``spatial`` group.

Port of ``v2x_sim_tpu/parallel/spatial.py``'s manual path. The BEV plane's
rows (dim 2 of the port's NCHW maps) are split over the spatial group in
rank order; a 3x3 conv fetches the one row it needs from each neighbour
(a halo) and then runs unpadded over its shard. Zeros stand in for the
missing neighbours at the global edges: the backbone's pad of 1, so the
sharded stages equal the unsharded ones.

The exchange is one ``all_reduce`` of a zeroed (n, ...) buffer in which
each rank fills its own slot with its edge rows; each rank then reads its
neighbours' slots. It moves n times the halo's bytes (a stage's halo is
two rows of its map), but it is differentiable by construction
(``mesh.psum``: the gradient returns through the reverse exchange) and
uses only a collective that gloo also runs on CUDA tensors.

  * ``make_spatial_stem`` / ``make_spatial_encoder``: the stride-1 stem
    and the 5-stage STPN encoder in inference BatchNorm, from the port's
    own ``ConvBlock`` weights;
  * ``make_spatial_stem_train_step``: one SGD step of the stem, its
    BatchNorm's batch moments averaged over the group, loss = the squared
    error summed over the group / the element count summed over it,
    gradients summed over the group and divided by that count.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from v2x_sim_tpu_torch.models.backbone import ConvBlock, STPNEncoder, _bn
from v2x_sim_tpu_torch.parallel.mesh import Mesh, all_reduce_, psum


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
    zero = torch.zeros_like(x[:, :, :1])
    above = edges[r - 1, 1] if r > 0 else zero
    below = edges[r + 1, 0] if r < n - 1 else zero
    return torch.cat([above, x, below], dim=2)


def conv3x3_halo(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """Stride-1 3x3 conv (pad 1, no bias) of a row shard: the halo rows,
    the columns padded locally, an unpadded conv. Same shape out."""
    xh = F.pad(halo_exchange_rows(x, group), (1, 1))
    return F.conv2d(xh, weight.to(x.dtype))


def conv3x3s2_halo(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """Stride-2 3x3 conv (pad 1, no bias) of a row shard with an even row
    count: output row k reads input rows 2k-1..2k+1, so the shard needs
    one row from the shard above (zeros on the first) and none from
    below, and emits H_loc / 2 rows."""
    if x.shape[2] % 2:
        raise ValueError(f"a stride-2 shard needs an even row count, got {tuple(x.shape)}")
    r = dist.get_rank(group)
    bottoms = _gather_slots(x[:, :, -1:], group)
    above = bottoms[r - 1] if r > 0 else torch.zeros_like(x[:, :, :1])
    xh = F.pad(torch.cat([above, x], dim=2), (1, 1))
    return F.conv2d(xh, weight.to(x.dtype), stride=2)


def _block_shard(x: torch.Tensor, block: ConvBlock, group, train: bool = False) -> torch.Tensor:
    """A ``ConvBlock`` ((conv3x3 - BN - ReLU) x2, the first conv of
    stride 1 or 2) on a row shard; train-mode BatchNorm averages its
    moments over ``group`` and updates the block's running stats."""
    conv0 = conv3x3_halo if block.conv1.stride[0] == 1 else conv3x3s2_halo
    bn_group = group if train else None
    x = torch.relu(_bn(conv0(x, block.conv1.weight, group), block.bn1, train, bn_group))
    return torch.relu(_bn(conv3x3_halo(x, block.conv2.weight, group), block.bn2, train, bn_group))


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
