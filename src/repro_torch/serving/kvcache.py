"""Paged KV-cache allocator (block tables), mirroring the paper's page
abstraction on the *activation* side: sequence positions are grouped into
fixed-size blocks, requests own block lists, and freeing a request
returns its blocks to the pool — so a multi-request decode batch shares
one physical cache pool with no per-request max-length reservation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class BlockTable:
    """One request's KV block list + how many positions are filled."""
    request_id: str
    blocks: List[int]
    length: int = 0                 # filled token positions


class PagedKVCache:
    """Paged KV-cache allocator: fixed-size blocks handed out from a
    free list per request, vLLM-style, so cache memory fragments by
    block rather than by max-sequence reservation (ROADMAP: unify
    with the dedup page pool)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.block_size = block_size
        self.free: List[int] = list(range(num_blocks))[::-1]
        self.tables: Dict[str, BlockTable] = {}
        self.peak_used = 0

    @property
    def used_blocks(self) -> int:
        return sum(len(t.blocks) for t in self.tables.values())

    def can_allocate(self, tokens: int) -> bool:
        need = -(-tokens // self.block_size)
        return len(self.free) >= need

    def allocate(self, request_id: str, tokens: int) -> BlockTable:
        if request_id in self.tables:
            # overwriting would orphan the old table's blocks: they never
            # return to the free list, shrinking the pool permanently
            raise ValueError(f"request {request_id!r} already has a block "
                             "table; release() it first")
        need = -(-tokens // self.block_size)
        if len(self.free) < need:
            raise MemoryError(f"KV pool exhausted: need {need} blocks, "
                              f"{len(self.free)} free")
        table = BlockTable(request_id, [self.free.pop() for _ in range(need)],
                           tokens)
        self.tables[request_id] = table
        self.peak_used = max(self.peak_used, self.used_blocks)
        return table

    def extend(self, request_id: str, new_tokens: int = 1) -> BlockTable:
        t = self.tables[request_id]
        old_length = t.length
        old_blocks = len(t.blocks)
        t.length += new_tokens
        while t.length > len(t.blocks) * self.block_size:
            if not self.free:
                # roll back: a half-applied extend would leave length
                # claiming positions no block covers (position_to_slot
                # would IndexError later) and leak the appended blocks
                self.free.extend(t.blocks[old_blocks:])
                del t.blocks[old_blocks:]
                t.length = old_length
                raise MemoryError("KV pool exhausted on extend")
            t.blocks.append(self.free.pop())
        self.peak_used = max(self.peak_used, self.used_blocks)
        return t

    def release(self, request_id: str) -> None:
        t = self.tables.pop(request_id, None)
        if t:
            self.free.extend(t.blocks)

    def position_to_slot(self, request_id: str, pos: int) -> int:
        t = self.tables[request_id]
        return t.blocks[pos // self.block_size] * self.block_size \
            + pos % self.block_size
