"""Paged KV cache: fixed-size pages, per-session page tables, byte accounting.

The storage layer of the serving stack, as in the reference. The models'
attention keeps a *dense* cache, contiguous (B, S, kvH, dh) rows, while
sessions arrive, pause and finish at their own pace; this module decouples
the two:

* KV lives in a **page pool** on the engine's device: two tensors (k and
  v) of shape ``(L, n_pages + 1, page, kvH, dh)``. The extra page at index
  ``n_pages`` is scratch and never allocated.
* A **page table** per session id maps the session's token positions
  ``[0, length)`` onto pages in order; tables live on the host.
* ``load`` gathers a session's pages into a dense slot row for the
  scheduler's working decode cache; ``store`` scatters a slot row back.
  Both index over a *fixed-length* page-id vector (the slot capacity ÷
  page size) padded with the scratch page id, so a gather or scatter has
  one shape per slot width. Writes aimed at the scratch page are
  discarded by construction; reads from it are masked by the position
  row.

Positions are not stored in pages: the scheduler writes a session's tokens
contiguously (slot i holds the key of absolute position i; pad slots past
the length are garbage by contract), so ``load`` rebuilds the position row
as ``iota < length ? iota : -1``, the mask ``models.attention`` expects.

Capacity is accounted in bytes: ``page_bytes`` is the k+v footprint of one
page across all layers, ``used_bytes`` counts allocated pages (scratch
excluded). ``defrag`` compacts live pages to the front of the pool (one
gather) and rewrites the tables. Host spills (``spill`` /
``restore_spill``) hold evicted sessions in CPU tensors: the design's host
memory, counted in ``spilled_bytes_*``. A mesh-sharded pool is not ported
(ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
import heapq

import torch


@dataclasses.dataclass
class Session:
    """One session's slice of the pool: ordered pages + token count."""

    pages: list[int]
    length: int = 0                   # real tokens stored (cache positions)
    reserved: int = 0                 # tokens the pages can hold


@dataclasses.dataclass
class HostSpill:
    """A session evicted to host memory, page-granular and exact.

    ``k``/``v`` are the scratch-padded page blocks a ``load`` of the
    session would gather, as CPU tensors of the slot width, so
    ``restore_spill`` replays the scatter ``store`` uses and the round
    trip is bitwise. ``length`` is the real token count; padding pages
    beyond ``pages_for(length)`` carry garbage and land on the scratch
    page on restore.
    """

    sid: object
    length: int
    k: torch.Tensor
    v: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes


def _rows_to_pages(x: torch.Tensor, page: int) -> torch.Tensor:
    """(L, C, kvH, dh) slot row -> (L, C / page, page, kvH, dh) view."""
    L, C = x.shape[:2]
    if C % page:
        raise ValueError(f"sequence dim {C} not divisible by page {page}")
    return x.reshape(L, C // page, page, *x.shape[2:])


class PagedKVCache:
    """Fixed-size-page KV store with per-session page tables.

    Args:
        cfg: arch config (layer and head geometry, cache dtype). Only
            plain decoder-only transformers: the paged layout mirrors
            their (L, S, kvH, dh) cache.
        n_pages: pool capacity in pages (one scratch page on top,
            excluded from the accounting).
        page_size: tokens per page. Slot capacities handed to ``load``
            must divide by it.
        device: where the pool lives (the engine's device).
        mesh: not ported; a mesh raises (ROADMAP A5).
    """

    def __init__(self, cfg, *, n_pages: int, page_size: int, device="cpu",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded page pool is not ported (ROADMAP A5)")
        if getattr(cfg, "cross_attn_every", 0) or not getattr(
                cfg, "n_kv_heads", 0):
            raise NotImplementedError(
                "paged KV cache supports plain decoder-only transformers")
        if n_pages < 1 or page_size < 1:
            raise ValueError("need n_pages >= 1 and page_size >= 1")
        self.cfg = cfg
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.device = torch.device(device)
        L, kvh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        dt = getattr(torch, cfg.dtype)
        shape = (L, n_pages + 1, page_size, kvh, dh)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.page_bytes = 2 * L * page_size * kvh * dh * dt.itemsize
        self._free: list[int] = list(range(n_pages))   # min-heap of page ids
        heapq.heapify(self._free)
        self._table: dict = {}
        # inter-pool transfer accounting (see ``ship_pages``): real page
        # bytes that left / entered this pool, scratch padding excluded
        self.shipped_bytes_out = 0
        self.shipped_bytes_in = 0
        # host-spill accounting (see ``spill``/``restore_spill``)
        self.spilled_bytes_out = 0
        self.spilled_bytes_in = 0
        # fault-injection seam: called as hook(pool, need_pages) before
        # any reservation that would actually take pages; an injected
        # MemoryError here is indistinguishable from real exhaustion to
        # callers, which is the point (serve.faultinject)
        self.fault_hook = None

    # -- accounting ---------------------------------------------------------

    @property
    def scratch_page(self) -> int:
        return self.n_pages

    @property
    def capacity_bytes(self) -> int:
        return self.n_pages * self.page_bytes

    @property
    def used_bytes(self) -> int:
        return (self.n_pages - len(self._free)) * self.page_bytes

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Would ``alloc(sid, n_tokens)`` succeed right now?"""
        return self.pages_for(n_tokens) <= len(self._free)

    def can_extend(self, sid, n_tokens: int) -> bool:
        """Would ``extend(sid, n_tokens)`` succeed right now?"""
        need = self.pages_for(n_tokens) - len(self._table[sid].pages)
        return need <= len(self._free)

    def sessions(self) -> list:
        return list(self._table)

    def length(self, sid) -> int:
        return self._table[sid].length

    def page_table(self, sid) -> tuple:
        return tuple(self._table[sid].pages)

    # -- alloc / free -------------------------------------------------------

    def alloc(self, sid, n_tokens: int) -> None:
        """Reserve pages for ``n_tokens`` under a new session id."""
        if sid in self._table:
            raise ValueError(f"session {sid!r} already allocated")
        sess = Session(pages=[])
        self._table[sid] = sess
        try:
            self._reserve(sess, n_tokens)
        except MemoryError:
            del self._table[sid]
            raise

    def extend(self, sid, n_tokens: int) -> None:
        """Grow a session's reservation to cover ``n_tokens`` total."""
        self._reserve(self._table[sid], n_tokens)

    def _reserve(self, sess: Session, n_tokens: int) -> None:
        need = self.pages_for(n_tokens) - len(sess.pages)
        if need > 0 and self.fault_hook is not None:
            self.fault_hook(self, need)
        if need > len(self._free):
            raise MemoryError(
                f"paged KV cache exhausted: need {need} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        for _ in range(max(need, 0)):
            sess.pages.append(heapq.heappop(self._free))
        sess.reserved = len(sess.pages) * self.page_size

    def free(self, sid) -> None:
        """Release a session's pages back to the pool."""
        sess = self._table.pop(sid)
        for p in sess.pages:
            heapq.heappush(self._free, p)

    # -- page <-> slot-row copies ------------------------------------------

    def _padded_pids(self, sess: Session, n_tokens: int,
                     capacity: int) -> list[int]:
        """Page ids covering ``n_tokens``, scratch-padded to the slot
        width. Only the prefix of the table that real tokens occupy is
        addressed: a session may hold more pages (reserved for its whole
        prompt + output budget) than one copy touches."""
        if capacity % self.page_size:
            raise ValueError(f"slot capacity {capacity} not divisible by "
                             f"page size {self.page_size}")
        n_used = self.pages_for(n_tokens)
        n_slot = capacity // self.page_size
        if n_used > n_slot:
            raise ValueError(f"{n_tokens} tokens need {n_used} pages, slot "
                             f"fits {n_slot}")
        return sess.pages[:n_used] + [self.scratch_page] * (n_slot - n_used)

    def _ids(self, pids: list[int]) -> torch.Tensor:
        return torch.tensor(pids, dtype=torch.int64).to(self.device)

    def _scatter(self, pids: list[int], k_pages: torch.Tensor,
                 v_pages: torch.Tensor) -> None:
        """Write (L, n_slot_pages, page, kvH, dh) blocks into pages
        ``pids``. Duplicate ids all target the scratch page, whose
        contents are never trusted."""
        ids = self._ids(pids)
        self.k[:, ids] = k_pages.to(self.device, self.k.dtype)
        self.v[:, ids] = v_pages.to(self.device, self.v.dtype)

    def _gather(self, pids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        ids = self._ids(pids)
        return self.k[:, ids], self.v[:, ids]

    def store(self, sid, k_row: torch.Tensor, v_row: torch.Tensor,
              length: int) -> None:
        """Scatter a dense slot row (L, C, kvH, dh) into ``sid``'s pages.

        ``length`` is the number of real tokens in the row (slots at or
        past it are garbage by the contiguity contract); the reservation
        grows to cover it if needed.
        """
        sess = self._table[sid]
        if length > sess.reserved:
            self._reserve(sess, length)
        pids = self._padded_pids(sess, length, k_row.shape[1])
        self._scatter(pids, _rows_to_pages(k_row, self.page_size),
                      _rows_to_pages(v_row, self.page_size))
        sess.length = int(length)

    def load(self, sid, capacity: int):
        """Gather ``sid``'s pages into dense rows of ``capacity`` tokens.

        Returns ``(k (L, C, kvH, dh), v, pos (C,) int32, length)``:
        ``pos`` is ``[0..length)`` then ``-1``, the empty-slot mask the
        attention cache expects.
        """
        sess = self._table[sid]
        kp, vp = self._gather(self._padded_pids(sess, sess.length,
                                                capacity))
        L = kp.shape[0]
        k = kp.reshape(L, capacity, *kp.shape[3:])
        v = vp.reshape(L, capacity, *vp.shape[3:])
        idx = torch.arange(capacity, dtype=torch.int32, device=self.device)
        pos = torch.where(idx < sess.length, idx, -1)
        return k, v, pos, sess.length

    # -- host spill (eviction under page pressure) --------------------------

    def spill(self, sid, *, capacity: int) -> HostSpill:
        """Evict ``sid`` to host memory and free its pages.

        The gather is the scratch-padded page indexing ``load`` uses,
        copied to CPU tensors, so spill -> restore -> load round-trips
        bitwise. The session leaves the pool until ``restore_spill``.
        """
        sess = self._table[sid]
        kp, vp = self._gather(self._padded_pids(sess, sess.length,
                                                capacity))
        out = HostSpill(sid=sid, length=sess.length, k=kp.cpu(), v=vp.cpu())
        self.spilled_bytes_out += self.pages_for(sess.length) * self.page_bytes
        self.free(sid)
        return out

    def restore_spill(self, spill: HostSpill, *, sid=None) -> None:
        """Re-admit a spilled session; raises MemoryError before any
        mutation. Allocates exactly ``pages_for(spill.length)`` pages
        (callers growing the session extend it afterwards) and scatters
        the host block back; padding pages land on the scratch page."""
        sid = spill.sid if sid is None else sid
        self.alloc(sid, spill.length)        # raises before any mutation
        sess = self._table[sid]
        pids = sess.pages + [self.scratch_page] * (spill.k.shape[1]
                                                   - len(sess.pages))
        self._scatter(pids, spill.k, spill.v)
        sess.length = int(spill.length)
        self.spilled_bytes_in += self.pages_for(spill.length) * self.page_bytes

    # -- defrag -------------------------------------------------------------

    def defrag(self) -> int:
        """Compact live pages to the front of the pool; returns #moved.

        Rebuilds every page table so sessions see their pages at dense
        low ids (in session order) and the free list becomes the
        contiguous tail: one whole-pool gather. A no-op (0 moved) when
        already compact.
        """
        live: list[int] = [p for s in self._table.values() for p in s.pages]
        if live == list(range(len(live))):
            return 0
        leftover = sorted(set(range(self.n_pages)) - set(live))
        perm = self._ids(live + leftover + [self.scratch_page])
        self.k = self.k[:, perm]
        self.v = self.v[:, perm]
        remap = {old: new for new, old in enumerate(live)}
        moved = sum(1 for old, new in remap.items() if old != new)
        for s in self._table.values():
            s.pages = [remap[p] for p in s.pages]
        self._free = list(range(len(live), self.n_pages))
        heapq.heapify(self._free)
        return moved


# ---------------------------------------------------------------------------
# inter-pool transport (disaggregated serving)
# ---------------------------------------------------------------------------

def ship_pages(src: PagedKVCache, dst: PagedKVCache, sid, *,
               capacity: int, dst_sid=None) -> int:
    """Move a session's KV pages from one pool to another; returns bytes.

    The transport unit of prefill/decode disaggregation (here two pools
    on one card). The transfer is page-granular with one shape per slot
    width: the source pages gather scratch-padded to ``capacity //
    page_size`` slots (the ``load`` discipline) and a scratch-padded
    scatter installs them.

    Only real pages count: ``src.shipped_bytes_out`` and
    ``dst.shipped_bytes_in`` both grow by ``pages · page_bytes``. The
    destination session (``dst_sid``, default the same id) is allocated
    first, for exactly the stored length; on an exhausted destination the
    MemoryError propagates before any state changes, so the source stays
    intact and shippable later. The source pages are freed once the
    scatter lands.
    """
    if src.page_size != dst.page_size:
        raise ValueError(f"page-size mismatch: src {src.page_size}, "
                         f"dst {dst.page_size}")
    sess = src._table[sid]
    dst_sid = sid if dst_sid is None else dst_sid
    n_tokens = sess.length
    dst.alloc(dst_sid, n_tokens)             # raises before any mutation
    n_used = src.pages_for(n_tokens)
    src_pids = src._padded_pids(sess, n_tokens, capacity)
    kp, vp = src._gather(src_pids)
    d = dst._table[dst_sid]
    dst._scatter(d.pages + [dst.scratch_page] * (len(src_pids)
                                                 - len(d.pages)), kp, vp)
    d.length = n_tokens
    src.free(sid)
    moved = n_used * src.page_bytes
    src.shipped_bytes_out += moved
    dst.shipped_bytes_in += moved
    return moved
