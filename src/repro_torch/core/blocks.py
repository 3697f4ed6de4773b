"""Tensor <-> block-grid partitioning.

The paper stores every parameter tensor as a set of equal-shape *tensor
blocks* (Sec. 3).  We canonicalize arbitrary-rank tensors to 2-D
``(dim0, prod(rest))`` — the same convention the paper uses for embedding
matrices and FFNN weights — then tile with a fixed ``block_shape``,
zero-padding the ragged edge.  Block metadata (grid position) is implicit
in the row-major block ordering, mirroring the paper's
``(tensorID, blockID)`` keys.

Host-side code is numpy; ``jnp`` arrays are accepted and converted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

DEFAULT_BLOCK_SHAPE: Tuple[int, int] = (256, 256)


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Metadata required to reassemble a tensor from its blocks."""

    tensor_shape: Tuple[int, ...]   # original (arbitrary-rank) shape
    shape2d: Tuple[int, int]        # canonicalized 2-D shape
    block_shape: Tuple[int, int]    # (bh, bw)
    grid: Tuple[int, int]           # blocks per dim, (gh, gw)

    @property
    def num_blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def padded2d(self) -> Tuple[int, int]:
        return (self.grid[0] * self.block_shape[0],
                self.grid[1] * self.block_shape[1])

    def block_position(self, block_id: int) -> Tuple[int, int]:
        """Row-major block id -> (row-block, col-block)."""
        return divmod(block_id, self.grid[1])


def _canonical2d(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, shape[0])
    return (shape[0], int(math.prod(shape[1:])))


def make_grid(tensor_shape: Tuple[int, ...],
              block_shape: Tuple[int, int] = DEFAULT_BLOCK_SHAPE) -> BlockGrid:
    s2 = _canonical2d(tuple(int(d) for d in tensor_shape))
    bh, bw = block_shape
    grid = (-(-s2[0] // bh), -(-s2[1] // bw))
    return BlockGrid(tuple(int(d) for d in tensor_shape), s2,
                     (int(bh), int(bw)), grid)


def block_tensor(x, block_shape: Tuple[int, int] = DEFAULT_BLOCK_SHAPE):
    """Partition ``x`` into blocks.

    Returns ``(blocks, grid)`` where ``blocks`` has shape
    ``[num_blocks, bh, bw]`` in row-major block order.
    """
    x = np.asarray(x)
    grid = make_grid(x.shape, block_shape)
    x2 = x.reshape(grid.shape2d)
    ph, pw = grid.padded2d
    if (ph, pw) != grid.shape2d:
        pad = np.zeros((ph, pw), dtype=x2.dtype)
        pad[: grid.shape2d[0], : grid.shape2d[1]] = x2
        x2 = pad
    bh, bw = grid.block_shape
    gh, gw = grid.grid
    blocks = (x2.reshape(gh, bh, gw, bw)
                .transpose(0, 2, 1, 3)
                .reshape(gh * gw, bh, bw))
    return blocks, grid


def unblock_tensor(blocks: np.ndarray, grid: BlockGrid) -> np.ndarray:
    """Inverse of :func:`block_tensor` (drops padding)."""
    blocks = np.asarray(blocks)
    bh, bw = grid.block_shape
    gh, gw = grid.grid
    x2 = (blocks.reshape(gh, gw, bh, bw)
                 .transpose(0, 2, 1, 3)
                 .reshape(gh * bh, gw * bw))
    x2 = x2[: grid.shape2d[0], : grid.shape2d[1]]
    return x2.reshape(grid.tensor_shape)


def gather_blocks(pool: np.ndarray, block_map: np.ndarray) -> np.ndarray:
    """Materialize logical blocks from a distinct-block ``pool``.

    ``block_map[i]`` is the distinct-block id backing logical block ``i``.
    """
    return pool[np.asarray(block_map)]


def materialize(pool: np.ndarray, block_map: np.ndarray,
                grid: BlockGrid) -> np.ndarray:
    """Reconstruct a full tensor from the pool + indirection map."""
    return unblock_tensor(gather_blocks(pool, block_map), grid)
