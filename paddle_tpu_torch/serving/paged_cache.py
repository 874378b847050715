"""Paged KV cache: refcounted page allocator, prefix index and page pool
(mirrors ``paddle_tpu/serving/paged_cache.py``).

Device state (``PagePool``): per-layer key/value pools stacked
``[L, num_pages, page_size, NH, D]`` as torch tensors on the engine's
device. One page id addresses the same page row in every layer.

Host state (numpy and Python): ``PageAllocator`` is a LIFO free list over
ids ``1..num_pages-1`` with a refcount per allocated page. **Page 0 is
the null page**: inactive slots' table entries point at it, writes of
inactive rows land in it, and gathers through unallocated table entries
read it (always masked). ``PrefixCache`` is a trie keyed on page-aligned
token chunks; admission aliases every matched page instead of
re-prefilling it, and a prompt that diverges from a cached chunk
mid-page reuses the agreeing positions by copy-on-write. Unreferenced
cached pages are evicted LRU leaf-first when the allocator runs dry.

int8 pools (``dtype=torch.int8``) carry per-page per-head f32 dequant
scales ``[L, num_pages, NH]`` beside the pools; quantize-on-write updates
them inside the tick (``ops.paged_attention.paged_kv_scatter``). Page 0
keeps scale 0 forever. Page content is never cleared on free, but a
recycled page's stale scale would poison the running max of its next
tenant, so pages are listed for a scale reset when they are allocated and
when their last reference drops, and the engine resets the listed rows at
the head of the next tick.

Speculative decoding's draft KV draws its pages from the same allocator
through ``AuxPageTable`` (registered with the pool, so the consistency
audit counts its holds), and a rejected speculative tail is rewound with
``shrink_slot``. Not in this slice: the chain hashes of the serving mesh.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..profiler.metrics import registry as _registry

NULL_PAGE = 0


class PageAllocator:
    """LIFO free-list over page ids 1..num_pages-1 (0 is the null page)
    with per-page refcounts for prefix sharing."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._ref: Dict[int, int] = {}       # allocated page -> refcount
        #: called with the pages whose LAST reference was just dropped
        #: (they are already back on the free list). The int8 pool hooks
        #: this to queue a scale reset at free time: a freed page's stale
        #: running-max scale is scheduling history, not content.
        self.on_zero: Optional[Callable[[List[int]], None]] = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def utilization(self) -> float:
        """Allocated fraction of the allocatable pool (null page excluded)."""
        return self.num_allocated / max(self.num_pages - 1, 1)

    def refcount(self, page: int) -> int:
        return self._ref.get(int(page), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n page ids at refcount 1, or None (no state change) if the pool
        can't cover the request."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for i in out:
            self._ref[i] = 1
        return out

    def share(self, ids) -> None:
        """Add one reference to each (already allocated) page."""
        shared = 0
        for i in ids:
            i = int(i)
            if i == NULL_PAGE:
                raise ValueError("page 0 (null page) is not shareable")
            if i not in self._ref:
                raise ValueError(f"share of unallocated page {i}")
            self._ref[i] += 1
            shared += 1
        if shared:
            _registry().counter("cache_share/shares").add(shared)

    def free(self, ids) -> None:
        """Drop one reference per page; a page returns to the free list
        only at refcount 0. Freeing an unallocated page raises."""
        released = 0
        zeroed: List[int] = []
        for i in ids:
            i = int(i)
            if i == NULL_PAGE:
                raise ValueError("page 0 (null page) is not allocatable")
            if i in self._free_set or i not in self._ref:
                raise ValueError(f"double free of page {i}")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                self._free.append(i)
                self._free_set.add(i)
                zeroed.append(i)
            else:
                released += 1
        if released:
            _registry().counter("cache_share/releases").add(released)
        if zeroed and self.on_zero is not None:
            self.on_zero(zeroed)


class _TrieNode:
    __slots__ = ("chunk", "page", "children", "first_ix", "parent",
                 "last_use")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_TrieNode"]):
        self.chunk = chunk
        self.page = page
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        # chunk[0] -> child nodes: the partial-match (COW) candidates
        self.first_ix: Dict[int, List["_TrieNode"]] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Trie prefix index over page-aligned token chunks. The index owns
    one refcount per cached page; ``evict_for`` drops unreferenced leaves
    (refcount 1) in LRU order."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = int(page_size)
        self.allocator = allocator
        self._root = _TrieNode((), NULL_PAGE, None)
        self._clock = 0

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    def lookup(self, tokens: np.ndarray):
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` (the
        last prompt position is always recomputed: its logits seed
        decoding). Returns ``(full_pages, partial)``: the page per fully
        matched chunk, and ``(page_id, lcp_len)`` for a chunk whose first
        ``lcp_len`` tokens agree with the remainder (COW), or None."""
        toks = np.asarray(tokens).reshape(-1)
        usable = toks.shape[0] - 1
        ps = self.page_size
        pages: List[int] = []
        node = self._root
        while (len(pages) + 1) * ps <= usable:
            key = tuple(int(t) for t in
                        toks[len(pages) * ps:(len(pages) + 1) * ps])
            nxt = node.children.get(key)
            if nxt is None:
                break
            node = nxt
            self._touch(node)
            pages.append(node.page)
        partial = None
        rem = usable - len(pages) * ps
        if rem > 0:
            rem_toks = toks[len(pages) * ps:len(pages) * ps + rem]
            best, best_child = 0, None
            for child in node.first_ix.get(int(rem_toks[0]), []):
                lcp = 0
                for a, b in zip(child.chunk, rem_toks):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best:
                    best, best_child = lcp, child
                    if lcp == rem:
                        break
            if best_child is not None:
                self._touch(best_child)
                partial = (best_child.page, best)
        return pages, partial

    def insert(self, tokens: np.ndarray, pages) -> int:
        """Register ``pages[i]`` as holding the KV of chunk ``i`` of
        ``tokens``. Chunks already cached keep their first page. Returns
        how many pages were newly indexed (each takes one refcount)."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        if len(pages) * ps > toks.shape[0]:
            raise ValueError("insert needs one full chunk per page")
        parent = self._root
        new = 0
        for i, page in enumerate(pages):
            key = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            node = parent.children.get(key)
            if node is None:
                node = _TrieNode(key, int(page), parent)
                parent.children[key] = node
                parent.first_ix.setdefault(key[0], []).append(node)
                self.allocator.share([int(page)])
                new += 1
            self._touch(node)
            parent = node
        return new

    def _evictable_leaves(self) -> List[_TrieNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.allocator.refcount(node.page) == 1:
                out.append(node)
        return out

    def _drop(self, node: _TrieNode) -> None:
        parent = node.parent
        del parent.children[node.chunk]
        bucket = parent.first_ix[node.chunk[0]]
        bucket.remove(node)
        if not bucket:
            del parent.first_ix[node.chunk[0]]
        self.allocator.free([node.page])

    def evict_for(self, n: int) -> int:
        """Free up to ``n`` pages by evicting unreferenced cached pages,
        LRU leaf-first. Returns how many pages were freed."""
        frontier = [(nd.last_use, id(nd), nd)
                    for nd in self._evictable_leaves()]
        heapq.heapify(frontier)
        freed = 0
        while freed < n and frontier:
            _, _, victim = heapq.heappop(frontier)
            parent = victim.parent
            self._drop(victim)
            freed += 1
            if parent is not self._root and not parent.children and \
                    self.allocator.refcount(parent.page) == 1:
                heapq.heappush(frontier,
                               (parent.last_use, id(parent), parent))
        if freed:
            _registry().counter("cache_share/prefix_evictions").add(freed)
        return freed

    def pages(self) -> List[int]:
        """Every page id the index holds a refcount on (one per node)."""
        out, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node.page)
            stack.extend(node.children.values())
        return out

    def clear(self) -> int:
        """Drop every index entry. Returns the number dropped."""
        order: List[_TrieNode] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        for node in reversed(order):     # children before parents
            self._drop(node)
        return len(order)


class _SlotTables:
    """Per-slot page tables over a shared allocator: ``tables`` [slots,
    pages_per_slot] int32 (the held pages, then the null page) and
    ``_held``, each slot's pages in position order."""

    allocator: PageAllocator
    prefix: Optional[PrefixCache]
    pages_per_slot: int
    tables: np.ndarray
    _held: List[List[int]]

    def slot_pages(self, slot: int) -> int:
        return len(self._held[slot])

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting unreferenced prefix-cache pages
        LRU-first when the free list alone can't cover it."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict_for(n - self.allocator.num_free)
            got = self.allocator.alloc(n)
        return got

    def grow_slot(self, slot: int, n_pages: int) -> bool:
        """Extend ``slot`` by ``n_pages`` fresh pages; False (untouched)
        when the pool can't cover it."""
        if n_pages <= 0:
            return True
        held = self._held[slot]
        if len(held) + n_pages > self.pages_per_slot:
            raise ValueError(
                f"slot {slot} would exceed pages_per_slot="
                f"{self.pages_per_slot}")
        got = self._alloc(n_pages)
        if got is None:
            return False
        self.tables[slot, len(held):len(held) + n_pages] = got
        held.extend(got)
        return True

    def shrink_slot(self, slot: int, keep_pages: int) -> int:
        """Release the slot's pages BEYOND the first ``keep_pages`` (the
        speculative rewind: the rejected tail truncates the slot's frontier
        and pages past the new length go back to the pool). Refcount-safe
        like ``release_slot``: only this slot's reference is dropped, so a
        page the prefix index or another slot still holds survives; the
        zeroed table tail can never be gathered. No-op when the slot holds
        ``<= keep_pages``. Returns how many references were dropped."""
        if keep_pages < 0:
            raise ValueError("keep_pages must be >= 0")
        held = self._held[slot]
        drop = held[keep_pages:]
        if not drop:
            return 0
        self.allocator.free(drop)
        del held[keep_pages:]
        self.tables[slot, keep_pages:] = NULL_PAGE
        return len(drop)

    def release_slot(self, slot: int) -> int:
        """Drop ``slot``'s reference on all of its pages and zero its table
        row. Idempotent. Returns how many references were dropped."""
        held = self._held[slot]
        n = len(held)
        if n:
            self.allocator.free(held)
        self._held[slot] = []
        self.tables[slot, :] = NULL_PAGE
        return n


class PagePool(_SlotTables):
    """Device page pools for all layers + host page tables for all slots."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, num_slots: int,
                 pages_per_slot: int, dtype: torch.dtype = torch.float32,
                 device=None, prefix_cache: bool = False):
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_slots = num_slots
        self.pages_per_slot = pages_per_slot
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.quantized = dtype == torch.int8
        self.allocator = PageAllocator(num_pages)
        if self.quantized:
            sshape = (num_layers, num_pages, num_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
            # pages whose scale rows await a reset (see take_fresh). The
            # allocator's hook queues the reset of pages that just lost
            # their last reference, so a page parked on the free list
            # carries none of its old tenant's scales. The hook holds this
            # list, not the pool (no reference cycle keeps a dropped
            # pool's device memory alive), so the list is only ever
            # mutated in place.
            self._fresh: List[int] = []
            self.allocator.on_zero = self._fresh.extend
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size, self.allocator) if prefix_cache
            else None)
        # host copy of the per-slot page tables; rows of released slots
        # are zeroed (null page) so stale ids can never be gathered
        self.tables = np.zeros((num_slots, pages_per_slot), np.int32)
        # pages held per slot, in position order (prefix of the table row)
        self._held: List[List[int]] = [[] for _ in range(num_slots)]
        # auxiliary page tables (the speculative draft KV) drawing from the
        # same allocator: registered so check_consistency counts their holds
        self._aux: List["AuxPageTable"] = []

    def register_aux(self, aux: "AuxPageTable") -> None:
        """Register an auxiliary table whose pages come from this pool's
        allocator: its holds join the consistency audit."""
        self._aux.append(aux)

    @property
    def slot_capacity(self) -> int:
        return self.pages_per_slot * self.page_size

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools, the scales of int8 pools included."""
        tensors = [self.k, self.v]
        if self.quantized:
            tensors += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in tensors)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``_SlotTables._alloc``, listing the pages of an int8 pool for a
        scale reset."""
        got = super()._alloc(n)
        if got is not None and self.quantized:
            self._fresh.extend(got)
        return got

    # -- int8 scale lifecycle (quantized pools only) -------------------
    def take_fresh(self, cap: int) -> np.ndarray:
        """Drain the pending-reset list into a fixed-size int32 vector
        (padded with the null page, whose scale is 0 anyway) for the next
        tick's scale reset. Entries beyond ``cap`` — which a correctly
        sized cap never produces — are reset here at once instead of
        silently dropped."""
        fresh = list(self._fresh)
        self._fresh.clear()
        if len(fresh) > cap:
            self.reset_scales(fresh[cap:])
            fresh = fresh[:cap]
        out = np.zeros(cap, np.int32)
        out[:len(fresh)] = fresh
        return out

    def tick_scales(self, fresh: torch.Tensor) -> dict:
        """The head of a tick: on int8 pools, zero the scale rows of the
        ``fresh`` pages (``take_fresh``'s vector on the device; its null
        page padding has scale 0 anyway), so recycled pages start their
        running-max scale at 0, and return the scale keywords of
        ``gpt_ragged_apply``. ``{}`` for float pools."""
        if not self.quantized:
            return {}
        self.k_scale.index_fill_(1, fresh.long(), 0.0)
        self.v_scale.index_fill_(1, fresh.long(), 0.0)
        return dict(kscale=self.k_scale, vscale=self.v_scale)

    def reset_scales(self, pages) -> None:
        """Zero the scale rows of ``pages`` in place, all layers."""
        idx = torch.as_tensor(np.asarray(list(pages), np.int64),
                              device=self.k_scale.device)
        if idx.numel() == 0:
            return
        self.k_scale.index_fill_(1, idx, 0.0)
        self.v_scale.index_fill_(1, idx, 0.0)

    def claim_fresh(self, page: int) -> None:
        """Remove ``page`` from the pending-reset list: its scale was just
        written by a device operation (the COW copy duplicates the donor
        page's scale; resetting it afterwards would dequantize the copied
        content at scale 0). EVERY occurrence goes: an alloc ->
        preempt-release -> realloc cycle inside one scheduler step lists
        the same id more than once."""
        if self.quantized:
            page = int(page)
            self._fresh[:] = [p for p in self._fresh if p != page]

    def share_into_slot(self, slot: int, pages) -> None:
        """Alias already-allocated ``pages`` (a cached prefix) into the
        next table positions of ``slot``, taking one refcount each."""
        if not len(pages):
            return
        held = self._held[slot]
        if len(held) + len(pages) > self.pages_per_slot:
            raise ValueError(
                f"slot {slot} would exceed pages_per_slot="
                f"{self.pages_per_slot}")
        self.allocator.share(pages)
        self.tables[slot, len(held):len(held) + len(pages)] = \
            np.asarray(pages, np.int32)
        held.extend(int(p) for p in pages)

    def drop_prefix_cache(self) -> int:
        """Flush the prefix index. Returns entries dropped."""
        return self.prefix.clear() if self.prefix is not None else 0

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` into ``dst`` across all
        layers, in place. The scales of an int8 page travel with its
        content (the copied values dequantize only with the same scales),
        and ``dst`` is un-listed from the pending scale reset, which would
        otherwise zero the copied scales at the next tick."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        if self.quantized:
            self.k_scale[:, dst] = self.k_scale[:, src]
            self.v_scale[:, dst] = self.v_scale[:, src]
            self.claim_fresh(dst)

    def check_consistency(self) -> List[str]:
        """Audit the host-side refcount invariants over the slot tables, the
        prefix index and every registered auxiliary table. Returns violation
        strings (empty = consistent)."""
        out = []
        holds: Dict[int, int] = {}

        def audit(what, held_rows, tables, width):
            for slot, held in enumerate(held_rows):
                row = tables[slot]
                for i, pg in enumerate(held):
                    holds[pg] = holds.get(pg, 0) + 1
                    if int(row[i]) != pg:
                        out.append(f"{what}slot {slot} table[{i}]="
                                   f"{int(row[i])} != held page {pg}")
                for i in range(len(held), width):
                    if int(row[i]) != NULL_PAGE:
                        out.append(f"{what}slot {slot} table[{i}]="
                                   f"{int(row[i])} past the held prefix")
                if NULL_PAGE in held:
                    out.append(f"{what}slot {slot} holds the null page")

        audit("", self._held, self.tables, self.pages_per_slot)
        if self.prefix is not None:
            for pg in self.prefix.pages():
                holds[pg] = holds.get(pg, 0) + 1
        for ax, aux in enumerate(self._aux):
            audit(f"aux {ax} ", aux._held, aux.tables, aux.pages_per_slot)
        alloc = self.allocator
        for pg, want in holds.items():
            have = alloc.refcount(pg)
            if have != want:
                out.append(f"page {pg} refcount {have} != {want}")
            if pg in alloc._free_set:
                out.append(f"page {pg} is held AND on the free list")
        for pg in alloc._ref:
            if pg not in holds:
                out.append(f"page {pg} allocated but held by nobody")
        if len(alloc._free) + len(alloc._ref) != alloc.num_pages - 1:
            out.append("free + allocated != allocatable")
        if set(alloc._free) != alloc._free_set:
            out.append("free list and free set disagree")
        return out


class AuxPageTable(_SlotTables):
    """Per-slot page tables of an auxiliary KV cache (the speculative
    DRAFT model's) drawing pages from the SAME allocator as the target
    pool: one id space and one refcount economy, so draft and target bytes
    compete and the engine can reclaim draft pages before it preempts.

    Growth evicts unreferenced prefix-cache pages like the primary
    tables'. Unlike them, allocations are not listed for an int8 scale
    reset (the draft cache is its own tensor, so the target's scale
    row of a draft-held page is never read; the allocator's hook lists the
    page when its last reference drops, which is when the target pool could
    next gather it), and there is no sharing, copy-on-write or prefix leg:
    draft pages are private to their slot (refcount 1).

    It holds the pool's allocator, prefix index and page size, not the
    pool, so the pool's registration of it makes no reference cycle.
    """

    def __init__(self, pool: PagePool, num_slots: int,
                 pages_per_slot: Optional[int] = None):
        self.allocator = pool.allocator
        self.prefix = pool.prefix
        self.page_size = pool.page_size
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot
                                  if pages_per_slot is not None
                                  else pool.pages_per_slot)
        self.tables = np.zeros((num_slots, self.pages_per_slot), np.int32)
        self._held: List[List[int]] = [[] for _ in range(num_slots)]
        pool.register_aux(self)

    def total_pages(self) -> int:
        """Pages held across all slots (the draft share of the pool)."""
        return sum(len(h) for h in self._held)

    def grow_to(self, slot: int, n_tokens: int) -> bool:
        """Hold enough pages for ``n_tokens`` positions (no-op when the
        slot already does). Best effort: False and untouched when the pool
        can't cover it (the engine speculates less rather than
        escalate)."""
        need = -(-int(n_tokens) // self.page_size) - len(self._held[slot])
        return self.grow_slot(slot, need)
