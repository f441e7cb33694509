"""The (data, layer) grid of ranks (counterpart of the JAX package's
`parallel/mesh.py`).

Rank r sits at data index r // n_layer and layer index r % n_layer, as the
JAX mesh lays `devices` out row by row. The JAX sharding constraints
become explicit slicing: the X-step's global batch is cut along 'data'
(`Mesh.rows`) and replicated along 'layer'; its reductions (gradients,
BatchNorm statistics, metrics) run over `data_group`, the ranks of one
layer index. The Z/U step flattens both axes, as the JAX `shard_map`
does: every rank takes a block of each bucket's layers (`Mesh.block`)
and the blocks are gathered over the whole world.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an n_data x n_layer grid and its groups: the
    ranks of its layer index (`data_group`, the 'data' axis) and of its
    data index (`layer_group`, the 'layer' axis); the world is the default
    group (None)."""
    n_data: int
    n_layer: int
    rank: int
    data_group: Any = None
    layer_group: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_layer

    @property
    def data_index(self) -> int:
        return self.rank // self.n_layer

    @property
    def layer_index(self) -> int:
        return self.rank % self.n_layer

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """[lo, hi) of the global batch this rank's data index holds."""
        if global_batch % self.n_data:
            raise ValueError(f"the global batch {global_batch} does not "
                             f"divide over {self.n_data} data ranks")
        local = global_batch // self.n_data
        return self.data_index * local, (self.data_index + 1) * local

    def block(self, layers: int) -> Tuple[int, int, int]:
        """(lo, hi, b): this rank's layers [lo, hi) of a bucket of
        `layers`, in blocks of b = ceil(layers / size) over the world (the
        stack zero-padded to b x size); hi == lo where the rank's block is
        all padding."""
        b = -(-layers // self.size)
        lo = min(self.rank * b, layers)
        return lo, min(lo + b, layers), b


def make_mesh(n_layer: int = 1) -> Mesh:
    """The grid over the initialized process group's ranks (one rank, no
    group: a 1 x 1 mesh). `n_layer` ranks along 'layer' (`--layer-shards`),
    the rest along 'data'; raises where n_layer does not divide the world,
    as the JAX CLI does, rather than idle ranks."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    if n_layer < 1 or world % n_layer:
        raise ValueError(f"--layer-shards {n_layer} does not divide the "
                         f"{world} ranks; pick a divisor")
    n_data = world // n_layer
    if world == 1:
        return Mesh(1, 1, 0)
    data_group = layer_group = None
    # every rank creates every group, in the same order
    for l in range(n_layer):
        g = tdist.new_group([d * n_layer + l for d in range(n_data)])
        if rank % n_layer == l:
            data_group = g
    for d in range(n_data):
        g = tdist.new_group([d * n_layer + l for l in range(n_layer)])
        if rank // n_layer == d:
            layer_group = g
    return Mesh(n_data, n_layer, rank, data_group, layer_group)
