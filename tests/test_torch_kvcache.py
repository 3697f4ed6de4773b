"""The port's PagedKVCache (a copy of the reference's): block-table
round-trips, free-list conservation, and regressions for the
duplicate-allocate and extend-rollback bugs; ports of
``tests/test_kvcache.py``."""
import pytest

from repro_torch.serving import PagedKVCache
from repro_torch.serving.kvcache import BlockTable


def test_allocate_round_trip():
    kv = PagedKVCache(num_blocks=8, block_size=4)
    t = kv.allocate("r0", tokens=10)             # ceil(10/4) = 3 blocks
    assert isinstance(t, BlockTable)
    assert len(t.blocks) == 3 and t.length == 10
    assert kv.used_blocks == 3 and len(kv.free) == 5
    kv.release("r0")
    assert kv.used_blocks == 0 and len(kv.free) == 8


def test_free_list_reuse_and_conservation():
    kv = PagedKVCache(num_blocks=4, block_size=2)
    a = kv.allocate("a", tokens=4)
    held = list(a.blocks)
    kv.release("a")
    b = kv.allocate("b", tokens=4)
    # LIFO free list: the released blocks are handed right back
    assert set(b.blocks) == set(held)
    kv.release("b")
    # conservation: every block accounted for, no duplicates minted
    assert sorted(kv.free) == list(range(4))


def test_block_table_positions_round_trip():
    kv = PagedKVCache(num_blocks=8, block_size=4)
    t = kv.allocate("r", tokens=9)
    slots = [kv.position_to_slot("r", p) for p in range(9)]
    assert len(set(slots)) == 9                  # distinct physical slots
    for p in range(9):
        blk = t.blocks[p // 4]
        assert slots[p] == blk * 4 + p % 4


def test_can_allocate_and_exhaustion():
    kv = PagedKVCache(num_blocks=2, block_size=4)
    assert kv.can_allocate(8) and not kv.can_allocate(9)
    kv.allocate("r", tokens=8)
    with pytest.raises(MemoryError):
        kv.allocate("s", tokens=1)
    assert "s" not in kv.tables                  # failed alloc left no table


def test_extend_grows_by_block():
    kv = PagedKVCache(num_blocks=4, block_size=2)
    t = kv.allocate("r", tokens=2)
    assert len(t.blocks) == 1
    kv.extend("r", 1)                            # 3 tokens -> 2 blocks
    assert len(t.blocks) == 2 and t.length == 3
    kv.extend("r", 1)                            # 4 tokens still 2 blocks
    assert len(t.blocks) == 2


def test_peak_used_tracks_high_water():
    kv = PagedKVCache(num_blocks=8, block_size=2)
    kv.allocate("a", tokens=6)                   # 3 blocks
    kv.allocate("b", tokens=4)                   # +2 = 5
    kv.release("a")
    kv.allocate("c", tokens=2)                   # 3 resident, peak stays 5
    assert kv.peak_used == 5


def test_duplicate_allocate_rejected():
    """Regression: re-allocating an id used to orphan the old table's
    blocks (they never returned to the free list)."""
    kv = PagedKVCache(num_blocks=4, block_size=2)
    kv.allocate("r", tokens=4)
    with pytest.raises(ValueError, match="already has a block table"):
        kv.allocate("r", tokens=2)
    kv.release("r")
    assert sorted(kv.free) == list(range(4))     # nothing leaked


def test_extend_rollback_on_exhaustion():
    """Regression: a failed extend used to leave ``length`` claiming
    positions no block covers and leak the partially-appended blocks."""
    kv = PagedKVCache(num_blocks=2, block_size=2)
    t = kv.allocate("r", tokens=4)               # pool fully used
    with pytest.raises(MemoryError):
        kv.extend("r", new_tokens=8)
    assert t.length == 4 and len(t.blocks) == 2  # state rolled back
    assert kv.used_blocks == 2 and kv.free == []
    # the table still works: every covered position resolves
    assert {kv.position_to_slot("r", p) for p in range(4)} == set(range(4))
    kv.release("r")
    assert sorted(kv.free) == list(range(2))     # no block leaked
