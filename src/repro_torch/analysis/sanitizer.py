"""PoolSanitizer — TSan for the page pool.

Opt-in runtime instrumentation that wraps the pool/transfer surfaces
(:class:`~repro.core.bufferpool.BufferPool`,
:class:`~repro.serving.device_pool.DevicePagePool`,
:class:`~repro.serving.shard_pool.ShardedPagePool` and each pool's
:class:`~repro.serving.transfer.TransferEngine`), records
``(generation, slot, page, reader|writer)`` events, and raises
:class:`PoolSanitizerError` on protocol violations the type system
cannot see:

* **stale-remap read** — a compute kernel consuming a ``remap`` built
  under an older (pack_generation, slab generation) pair, or against a
  different pool/shard than the one it was built from;
* **missed generation bump** — a load/evict/flush that mutated the
  residency map without advancing ``generation`` (remap caches keep
  validating against stale slots);
* **one-group-one-bump** — a grouped load that bumps more than once
  (PR 5's contract), or a ``stage()`` that bumps at all;
* **double-load** — re-admitting an already-resident page to a second
  slot;
* **slot aliasing** — two pages mapped to one slab slot, or a mapped
  slot simultaneously on the free list;
* **evict-while-pinned** — the buffer pool evicting a page pinned by an
  in-flight ``access_group``;
* **non-owner shard load** — a shard slab admitting a page the current
  placement does not assign to it (placement-totality, PR 4);
* **borrow-slab aliasing** — the borrow staging tail holding duplicate
  slots, out-of-range slots, or pages that should be served from the
  shard's own slab.

Wrapping is by *instance attribute*: the serving layer looks methods up
at call time (``self.pools[shard].load``), so instance wrappers
intercept every production path without touching the classes.  The
module-level :func:`enable` additionally patches the three classes'
``__init__`` so every pool constructed afterwards is born instrumented —
that is what ``REPRO_SANITIZE=1`` flips on under the whole test suite
(see ``tests/conftest.py`` and DESIGN.md §7).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import weakref
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PoolSanitizerError", "PoolEvent", "PoolSanitizer",
           "enable", "disable", "enabled"]


class PoolSanitizerError(AssertionError):
    """A page-pool protocol violation detected at runtime."""


@dataclasses.dataclass(frozen=True)
class PoolEvent:
    """One recorded pool transition (bounded history, newest last)."""
    op: str                  # load / load_group / evict / flush / gather / ...
    role: str                # "reader" | "writer"
    pool: int                # id() of the DevicePagePool / BufferPool
    shard: Optional[int]     # shard index when known
    page: Optional[int]
    slot: Optional[int]
    generation: int


class PoolSanitizer:
    """Records pool events and enforces the DESIGN.md §7 contracts.

    ``strict=True`` raises :class:`PoolSanitizerError` at the violating
    call site; ``strict=False`` accumulates violations in
    :attr:`violations` for post-hoc inspection (useful when probing how
    far a broken protocol drifts before crashing).
    """

    MAX_EVENTS = 4096
    MAX_TAGS = 2048

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.events: "collections.deque[PoolEvent]" = \
            collections.deque(maxlen=self.MAX_EVENTS)
        self.violations: List[str] = []
        # id(dev_map) -> (weakref|None, pool id, pack_gen, slab_gen)
        self._tags: Dict[int, Tuple[Any, int, int, int]] = {}

    # ------------------------------------------------------------- plumbing --
    def _violate(self, message: str) -> None:
        self.violations.append(message)
        if self.strict:
            raise PoolSanitizerError(message)

    def _emit(self, op: str, role: str, pool: Any, shard: Optional[int],
              page: Optional[int], slot: Optional[int],
              generation: int) -> None:
        self.events.append(PoolEvent(op, role, id(pool), shard,
                                     page, slot, generation))

    def report(self) -> str:
        """Human-readable summary of recorded history + violations."""
        lines = [f"PoolSanitizer: {len(self.events)} events recorded, "
                 f"{len(self.violations)} violations"]
        lines += [f"  VIOLATION: {v}" for v in self.violations]
        lines += [f"  {e.op:<12} {e.role:<6} shard={e.shard} page={e.page} "
                  f"slot={e.slot} gen={e.generation}"
                  for e in list(self.events)[-20:]]
        return "\n".join(lines)

    # ------------------------------------------------------- remap tagging --
    def _tag(self, dev_map, pool, shard: Optional[int] = None) -> None:
        if dev_map is None:
            return
        try:
            ref = weakref.ref(dev_map)
        except TypeError:
            ref = None
        if len(self._tags) >= self.MAX_TAGS:
            dead = [k for k, (r, *_rest) in self._tags.items()
                    if r is not None and r() is None]
            for k in dead:
                del self._tags[k]
            if len(self._tags) >= self.MAX_TAGS:
                self._tags.clear()               # last resort: stay bounded
        self._tags[id(dev_map)] = (ref, id(pool),
                                   pool.store.pack_generation,
                                   pool.generation)
        self._emit("remap", "writer", pool, shard, None, None,
                   pool.generation)

    def _check_map(self, pool, dev_map, op: str,
                   shard: Optional[int] = None) -> None:
        tag = self._tags.get(id(dev_map))
        if tag is None:
            return                               # map we never saw minted
        ref, pool_id, pack_gen, slab_gen = tag
        if ref is not None and ref() is not dev_map:
            del self._tags[id(dev_map)]          # id() reuse after gc
            return
        if pool_id != id(pool):
            self._violate(
                f"stale-remap read in {op}: dev_map was built for a "
                "different pool/shard than the one now reading it")
        elif pack_gen != pool.store.pack_generation \
                or slab_gen != pool.generation:
            self._violate(
                f"stale-remap read in {op}: dev_map built at "
                f"(pack {pack_gen}, slab gen {slab_gen}) but the pool is "
                f"now at (pack {pool.store.pack_generation}, slab gen "
                f"{pool.generation}) — rebuild the remap after any "
                "load/evict/flush")
        self._emit(op, "reader", pool, shard, None, None, pool.generation)

    # ----------------------------------------------------- slot invariants --
    def _check_slots(self, pool, op: str) -> None:
        slots = list(pool.slot_of.values())
        if len(set(slots)) != len(slots):
            owners: Dict[int, List[int]] = {}
            for pid, s in pool.slot_of.items():
                owners.setdefault(s, []).append(pid)
            aliased = {s: ps for s, ps in owners.items() if len(ps) > 1}
            self._violate(f"slot aliasing after {op}: pages sharing one "
                          f"slab slot: {aliased}")
        leaked = set(slots) & set(pool._free)
        if leaked:
            self._violate(f"slot bookkeeping after {op}: slots {sorted(leaked)} "
                          "are mapped to pages AND on the free list")

    # ------------------------------------------------------ DevicePagePool --
    def attach_device_pool(self, pool, shard: Optional[int] = None):
        """Wrap one DevicePagePool's mutation + compute surface (and its
        TransferEngine's stage path) with recording and checks."""
        if getattr(pool, "_repro_sanitizer", None) is self:
            return pool
        pool._repro_sanitizer = self
        san = self
        orig_load, orig_load_group = pool.load, pool.load_group
        orig_evict, orig_flush = pool.evict, pool.flush
        orig_remap = pool.remap
        orig_stage = pool.transfer.stage

        @functools.wraps(orig_load)
        def load(pid):
            pid = int(pid)
            resident = pid in pool.slot_of
            slot0 = pool.slot_of.get(pid)
            gen0 = pool.generation
            out = orig_load(pid)
            if resident:
                if pool.slot_of.get(pid) != slot0 or pool.generation != gen0:
                    san._violate(
                        f"double-load: page {pid} was already resident in "
                        f"slot {slot0} but load() re-admitted it "
                        f"(slot now {pool.slot_of.get(pid)})")
            else:
                if pid not in pool.slot_of:
                    san._violate(f"load({pid}) returned without admitting "
                                 "the page")
                elif pool.generation <= gen0:
                    san._violate(
                        f"missed generation bump: load({pid}) admitted the "
                        f"page into slot {pool.slot_of[pid]} but generation "
                        f"stayed at {gen0} — cached remaps now alias stale "
                        "slots")
            san._check_slots(pool, f"load({pid})")
            san._emit("load", "writer", pool, shard, pid,
                      pool.slot_of.get(pid), pool.generation)
            return out

        @functools.wraps(orig_load_group)
        def load_group(pids):
            pids = [int(p) for p in pids]
            missing = [p for p in dict.fromkeys(pids)
                       if p not in pool.slot_of]
            gen0 = pool.generation
            out = orig_load_group(pids)
            if missing:
                lost = [p for p in missing if p not in pool.slot_of]
                if lost:
                    san._violate(f"load_group did not admit pages {lost}")
                bumps = pool.generation - gen0
                if bumps == 0:
                    san._violate(
                        "missed generation bump: load_group admitted "
                        f"{len(missing)} pages with no generation bump")
                elif bumps > 1:
                    san._violate(
                        f"one-group-one-bump violated: ONE grouped load of "
                        f"{len(missing)} pages bumped generation {bumps} "
                        "times (remap caches invalidated per page, not per "
                        "group)")
            san._check_slots(pool, "load_group")
            san._emit("load_group", "writer", pool, shard, None, None,
                      pool.generation)
            return out

        @functools.wraps(orig_evict)
        def evict(pid):
            pid = int(pid)
            resident = pid in pool.slot_of
            slot0 = pool.slot_of.get(pid)
            gen0 = pool.generation
            out = orig_evict(pid)
            if resident:
                if pid in pool.slot_of:
                    san._violate(f"evict({pid}) left the page mapped to "
                                 f"slot {pool.slot_of[pid]}")
                elif pool.generation <= gen0:
                    san._violate(
                        f"missed generation bump: evict({pid}) freed slot "
                        f"{slot0} but generation stayed at {gen0} — cached "
                        "remaps still point at the freed slot")
            san._check_slots(pool, f"evict({pid})")
            san._emit("evict", "writer", pool, shard, pid, slot0,
                      pool.generation)
            return out

        @functools.wraps(orig_flush)
        def flush():
            gen0 = pool.generation
            had = len(pool.slot_of)
            out = orig_flush()
            if pool.slot_of:
                san._violate(f"flush() left {len(pool.slot_of)} pages "
                             "resident")
            if pool.generation <= gen0:
                san._violate(
                    f"missed generation bump: flush() dropped {had} pages "
                    f"but generation stayed at {gen0}")
            san._emit("flush", "writer", pool, shard, None, None,
                      pool.generation)
            return out

        @functools.wraps(orig_remap)
        def remap(vt, key=None, strict=True):
            out = orig_remap(vt, key=key, strict=strict)
            san._tag(out, pool, shard)
            return out

        def _reader(name):
            orig = getattr(pool, name)

            @functools.wraps(orig)
            def wrapped(dev_map, *a, **k):
                san._check_map(pool, dev_map, name, shard)
                return orig(dev_map, *a, **k)
            return wrapped

        @functools.wraps(orig_stage)
        def stage(pids):
            gen0 = pool.generation
            out = orig_stage(pids)
            if pool.generation != gen0:
                san._violate(
                    "stage() bumped the pool generation: staging must be "
                    "invisible until the group commits (one-group-one-bump)")
            san._emit("stage", "writer", pool, shard, None, None,
                      pool.generation)
            return out

        pool.load, pool.load_group = load, load_group
        pool.evict, pool.flush, pool.remap = evict, flush, remap
        pool.gather_rows = _reader("gather_rows")
        pool.virtual_matmul = _reader("virtual_matmul")
        pool.unblock = _reader("unblock")
        pool.transfer.stage = stage
        return pool

    # ---------------------------------------------------------- BufferPool --
    def attach_buffer_pool(self, bp, shard: Optional[int] = None):
        """Wrap one BufferPool's eviction path (evict-while-pinned)."""
        if getattr(bp, "_repro_sanitizer", None) is self:
            return bp
        bp._repro_sanitizer = self
        san = self
        orig_evict_one = bp._evict_one

        @functools.wraps(orig_evict_one)
        def _evict_one():
            before = set(bp.resident)
            pinned = set(bp._pinned)
            out = orig_evict_one()
            for victim in before - set(bp.resident):
                if victim in pinned:
                    san._violate(
                        f"evict-while-pinned: page {victim} was evicted "
                        "while pinned by an in-flight access_group "
                        f"(pinned set: {sorted(pinned)})")
                san._emit("bp_evict", "writer", bp, shard, victim, None,
                          bp.tick)
            return out

        bp._evict_one = _evict_one
        return bp

    # ----------------------------------------------------- ShardedPagePool --
    def attach_sharded_pool(self, sp):
        """Wrap a ShardedPagePool: per-shard ownership checks on the
        member pools plus borrow-staging aliasing checks."""
        if getattr(sp, "_repro_sanitizer", None) is self:
            return sp
        sp._repro_sanitizer = self
        san = self
        for s, pool in enumerate(sp.pools):
            self.attach_device_pool(pool, shard=s)
            orig_load = pool.load
            orig_load_group = pool.load_group

            def mk(shard, orig, group):
                @functools.wraps(orig)
                def checked(arg):
                    pl = sp.placement()
                    pids = [int(p) for p in arg] if group else [int(arg)]
                    bad = [p for p in pids
                           if shard not in pl.shards_of(p)]
                    if bad:
                        san._violate(
                            f"non-owner shard load: shard {shard} admitted "
                            f"pages {bad} that placement (pack gen "
                            f"{pl.pack_generation}) assigns elsewhere — "
                            "borrowed pages must go through stage_borrows")
                    return orig(arg)
                return checked

            pool.load = mk(s, orig_load, group=False)
            pool.load_group = mk(s, orig_load_group, group=True)
        orig_stage_borrows = sp.stage_borrows

        @functools.wraps(orig_stage_borrows)
        def stage_borrows(shard, pages, model):
            out = orig_stage_borrows(shard, pages, model)
            if out is None:                      # refused (over capacity)
                return out
            st = sp.staged(shard)
            slots = list(st.values())
            if len(set(slots)) != len(slots):
                san._violate(
                    f"borrow-slab aliasing on shard {shard}: two staged "
                    f"pages share a staging slot ({st})")
            oob = [i for i in slots
                   if not 0 <= i < sp.borrow_capacity]
            if oob:
                san._violate(
                    f"borrow-slab aliasing on shard {shard}: staging slots "
                    f"{oob} outside the borrow tail "
                    f"[0, {sp.borrow_capacity})")
            pl = sp.placement()
            for pid in st:
                if shard in pl.shards_of(pid):
                    san._violate(
                        f"borrow-slab aliasing on shard {shard}: page "
                        f"{pid} is owned by this shard — it must be served "
                        "from the shard slab, not the borrow tail")
                elif pid in sp.pools[shard].slot_of:
                    san._violate(
                        f"borrow-slab aliasing on shard {shard}: page "
                        f"{pid} staged in the borrow tail while also "
                        "resident in the shard slab (two sources of truth)")
            san._emit("stage_borrows", "writer", sp, shard, None, None,
                      pl.pack_generation)
            return out

        sp.stage_borrows = stage_borrows
        for s, bp in enumerate(sp.buffer_pools):
            self.attach_buffer_pool(bp, shard=s)
        return sp


# ------------------------------------------------------------ global switch --
_GLOBAL: Optional[PoolSanitizer] = None
_PATCHED: Dict[type, Any] = {}


def enabled() -> Optional[PoolSanitizer]:
    """The process-wide sanitizer, if :func:`enable` has run."""
    return _GLOBAL


def enable(strict: bool = True) -> PoolSanitizer:
    """Instrument every pool constructed from now on (idempotent).

    Patches ``BufferPool/DevicePagePool/ShardedPagePool.__init__`` to
    attach one shared :class:`PoolSanitizer` at construction.  This is
    what ``REPRO_SANITIZE=1`` triggers from ``tests/conftest.py``.
    """
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    san = PoolSanitizer(strict=strict)

    from ..core.bufferpool import BufferPool
    from ..serving.device_pool import DevicePagePool
    from ..serving.shard_pool import ShardedPagePool

    def patch(cls, attach):
        orig = cls.__init__

        @functools.wraps(orig)
        def __init__(self, *a, **k):
            orig(self, *a, **k)
            attach(self)

        cls.__init__ = __init__
        _PATCHED[cls] = orig

    # ShardedPagePool builds its member pools in __init__, so they are
    # device-pool-instrumented first and ownership-wrapped second.
    patch(BufferPool, san.attach_buffer_pool)
    patch(DevicePagePool, san.attach_device_pool)
    patch(ShardedPagePool, san.attach_sharded_pool)
    _GLOBAL = san
    return san


def disable() -> None:
    """Undo :func:`enable` for pools constructed afterwards (already
    attached instances keep their wrappers)."""
    global _GLOBAL
    for cls, orig in _PATCHED.items():
        cls.__init__ = orig
    _PATCHED.clear()
    _GLOBAL = None


if os.environ.get("REPRO_SANITIZE", "") == "1":   # pragma: no cover - env hook
    enable(strict=True)
