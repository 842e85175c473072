"""Dense group-row allocator: paxosID -> device row index.

Reference analog: ``utils/MultiArrayMap.java`` + ``gigapaxos/paxosutil/
IntegerMap.java`` — the memory-dense structures that let one node hold
millions of instances.  TPU-native redesign: instead of hashing into a
memory-dense heap map, every group gets a *row index* into the columnar
``[G, W]`` device arrays, allocated from a free list; create/delete churn
reuses rows (SURVEY.md §7.3.1).  The string name appears exactly once
(here); the wire and the device only ever see the u64 ``group_key`` and the
i32 row.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from gigapaxos_tpu_torch.native import KeyRowMap
from gigapaxos_tpu_torch.paxos.packets import group_key


@dataclass(slots=True)
class GroupMeta:
    # slots: at a million groups the per-instance __dict__ (~100B) was
    # a top line item of the resident bytes/group budget
    name: str
    gkey: int
    row: int
    members: Tuple[int, ...]
    version: int
    paused: bool = False


class GroupTable:
    """name/gkey -> (row, members, version).  O(1) create/delete/lookup."""

    def __init__(self, capacity: int, shards: int = 1):
        self.capacity = capacity
        # engine-lane sharding (PC.ENGINE_SHARDS): a group's device row
        # must land in the slab of its shard (= gkey % shards), so rows
        # are allocated from per-shard free lists holding exactly the
        # rows with row % shards == shard.  shards=1 is the single list
        # of old, byte-for-byte.
        self.shards = max(1, int(shards))
        self._by_key: Dict[int, GroupMeta] = {}
        # flat row->meta list (8B/slot) instead of a dict (~100B/entry)
        self._by_row: list = [None] * capacity
        # interned member tuples: churny workloads create millions of
        # groups over a handful of distinct member sets — share one
        # tuple object per distinct set instead of one per group
        self._msets: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        self._msets_rebuild_at = 4096
        # native u64->i32 row index (C++ open addressing when available):
        # rows_for_keys answers a whole packet batch in one call
        self._rows = KeyRowMap(min(capacity, 1 << 16))
        # serializes create/delete across engine lanes: the four
        # structures they touch (_by_key, _by_row, per-shard free
        # lists, _msets incl. its rebuild) must move together — churn
        # is the cold path, so one uncontended lock per call.  Batched
        # lookups don't take it (KeyRowMap locks its own native calls).
        self._mut = threading.Lock()
        # LIFO free lists (one per shard): recently freed rows are
        # reused first, keeping the hot row set dense/cache-friendly
        self._free = [
            [r for r in range(capacity - 1, -1, -1)
             if r % self.shards == k]
            for k in range(self.shards)]

    def __len__(self) -> int:
        return len(self._by_key)

    def shard_of(self, gkey: int) -> int:
        """Engine lane owning this group (= gkey % shards)."""
        return gkey % self.shards

    def create(self, name: str, members: Tuple[int, ...], version: int = 0
               ) -> GroupMeta:
        gkey = group_key(name)
        existing = self._by_key.get(gkey)
        if existing is not None:
            if existing.name != name:
                # 64-bit collision: refuse (SURVEY design: detect at create)
                raise ValueError(
                    f"group_key collision: {name!r} vs {existing.name!r}")
            raise KeyError(f"group exists: {name}")
        with self._mut:
            free = self._free[gkey % self.shards]
            if not free:
                raise MemoryError(
                    "group capacity exhausted"
                    + (f" (shard {gkey % self.shards})"
                       if self.shards > 1 else ""))
            row = free.pop()
            mt = tuple(members)
            if len(self._msets) > self._msets_rebuild_at:
                # bound the intern table: rotating memberships could
                # otherwise accumulate dead sets forever.  Rebuilding from
                # live groups is O(n), so the threshold doubles whenever a
                # rebuild fails to shrink below it — with >4K *live*
                # distinct sets a fixed bound would rebuild on every
                # create, an O(live-groups) dict build per create.
                self._msets = {m.members: m.members
                               for m in self._by_key.values()}
                self._msets_rebuild_at = max(4096, 2 * len(self._msets))
            mt = self._msets.setdefault(mt, mt)
            meta = GroupMeta(name, gkey, row, mt, version)
            self._by_key[gkey] = meta
            self._by_row[row] = meta
            self._rows.put(gkey, row)
        return meta

    def delete(self, gkey: int) -> Optional[GroupMeta]:
        with self._mut:
            meta = self._by_key.pop(gkey, None)
            if meta is None:
                return None
            self._by_row[meta.row] = None
            self._free[meta.row % self.shards].append(meta.row)
            self._rows.delete(gkey)
        return meta

    def rows_for_keys(self, gkeys: np.ndarray) -> np.ndarray:
        """Batched gkey -> row lookup; -1 where unknown.  One native call
        for a whole packet batch (the hot-path replacement for a Python
        dict hit per item).  No table lock here: KeyRowMap serializes
        its own native calls internally, which already guards the
        grow-vs-scan race — taking ``_mut`` too would convoy every
        lane's per-batch lookup on one process-wide lock."""
        return self._rows.get_batch(gkeys)

    def by_key(self, gkey: int) -> Optional[GroupMeta]:
        return self._by_key.get(gkey)

    def by_name(self, name: str) -> Optional[GroupMeta]:
        return self._by_key.get(group_key(name))

    def by_row(self, row: int) -> Optional[GroupMeta]:
        if 0 <= row < self.capacity:
            return self._by_row[row]
        return None

    def __iter__(self) -> Iterator[GroupMeta]:
        return iter(self._by_key.values())

    def snapshot_metas(self) -> list:
        """Stable list of live metas (under the mutation lock, so the
        introspection plane can iterate while lanes create/delete —
        bare dict iteration raises if a create lands mid-scan)."""
        with self._mut:
            return list(self._by_key.values())
