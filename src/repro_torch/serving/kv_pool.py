"""Deterministic on-device KV page pool: fixed pages, ref counts, prefix COW.

The pool manages *page identities only* — the tensors live in the engine's
paged cache leaves ``[L, P, ps, ...]``; the pool decides which physical page
each logical page of each request maps to.  Invariants:

* Page 0 is the reserved **null page**: never allocated, never freed; block
  tables of inactive slots (and positions past a request's length) point at
  it so decode kernels always have a valid gather target.
* Allocation order is deterministic: the free list is a min-heap, so the
  lowest-numbered free page is always handed out next.  Replaying the same
  request trace reproduces the same page map bit-for-bit (tested).
* ``ensure`` is all-or-nothing: if the pool cannot cover the requested
  length, nothing is allocated and :class:`PageExhausted` is raised — the
  engine turns that into admission pressure (requeue/shed), never a
  half-mapped request.
* Pages are ref-counted for prefix sharing.  ``adopt_shared`` maps a prompt
  prefix onto already-resident pages by content key; a writer into a page
  with refcount > 1 gets a private copy first (copy-on-write) via
  ``writable_page``.  Double-free is a hard ``RuntimeError``, not a counter.

Content keys chain a sha1 over the exact position stream (meta sentinels +
prompt tokens), so equal keys imply byte-identical page contents for a
deterministic model.  A shared *partial* page may physically contain stale
positions beyond the shorter prompt's length — safe because decode masks by
length and the first writer copies before extending.

A copy of the JAX package's ``serving/kv_pool.py`` (pure Python, no framework code).
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass
from typing import Optional


class PageExhausted(RuntimeError):
    """The pool cannot cover a request; nothing was allocated."""


@dataclass(frozen=True)
class KVPoolConfig:
    num_pages: int          # total physical pages, including null page 0
    page_size: int = 16     # positions per page

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")


def page_content_keys(model_name: str, page_size: int, prompt: list[int],
                      meta_tokens: int = 0) -> list[str]:
    """Chained content keys for the pages a prompt's KV occupies.

    Position ``p`` of the cache holds a meta sentinel (p < meta_tokens) or
    the KV of prompt token ``p - meta_tokens`` — prefill writes every
    prompt position; only the first *sampled* token's KV is pending.  Each
    key hashes its page's tokens chained onto the previous key, so key
    equality implies *full-prefix* equality — page i can only be adopted if
    pages 0..i-1 matched too (KV at position p depends on the whole prefix
    through attention mixing, not on token p alone).  The final partial
    page (if any) also gets a key, tagged with its fill level, so two
    prompts share it only when their written prefixes agree exactly.
    """
    stream = [("meta", i) for i in range(meta_tokens)]
    stream += [("tok", int(t)) for t in prompt]
    keys: list[str] = []
    hasher = hashlib.sha1(f"{model_name}:{page_size}".encode())
    for start in range(0, len(stream), page_size):
        chunk = stream[start:start + page_size]
        hasher = hasher.copy()
        hasher.update(repr(chunk).encode())
        if len(chunk) == page_size:
            keys.append(hasher.hexdigest())
        else:
            partial = hasher.copy()
            partial.update(f":partial:{len(chunk)}".encode())
            keys.append(partial.hexdigest())
    return keys


class KVPagePool:
    """Deterministic ref-counted page allocator with per-tenant accounting."""

    def __init__(self, config: KVPoolConfig):
        self.config = config
        self._free: list[int] = list(range(1, config.num_pages))
        heapq.heapify(self._free)
        self._refs: dict[int, int] = {}            # page -> refcount
        self._tables: dict[str, list[int]] = {}    # rid -> physical pages
        self._tenants: dict[str, str] = {}         # rid -> tenant
        self._tenant_pages: dict[str, int] = {}    # tenant -> held pages
        self._shared_index: dict[str, int] = {}    # content key -> page
        self._page_keys: dict[int, str] = {}       # page -> published key
        self.stats = {
            "allocs": 0, "frees": 0, "cow_copies": 0, "shared_hits": 0,
            "leaked_pages": 0, "exhaustions": 0,
        }

    # -- introspection ----------------------------------------------------
    @property
    def page_size(self) -> int:
        return self.config.page_size

    def holds(self, rid: str) -> bool:
        return rid in self._tables

    def holders(self) -> list[str]:
        return list(self._tables)

    def table(self, rid: str) -> list[int]:
        return list(self._tables[rid])

    def pages_for(self, n_pos: int) -> int:
        return -(-max(n_pos, 0) // self.config.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.config.num_pages - 1 - len(self._free)

    def tenant_pages(self, tenant: str) -> int:
        return self._tenant_pages.get(tenant, 0)

    def health(self) -> dict:
        return {
            "num_pages": self.config.num_pages,
            "page_size": self.config.page_size,
            "free_pages": self.free_pages,
            "used_pages": self.used_pages,
            "holders": len(self._tables),
            "shared_keys": len(self._shared_index),
            "tenant_pages": dict(self._tenant_pages),
            **self.stats,
        }

    # -- allocation -------------------------------------------------------
    def ensure(self, rid: str, n_pos: int, tenant: str = "default") -> list[int]:
        """Grow ``rid``'s table to cover ``n_pos`` positions; all-or-nothing."""
        table = self._tables.setdefault(rid, [])
        if rid not in self._tenants:
            self._tenants[rid] = tenant
        need = self.pages_for(n_pos) - len(table)
        if need > len(self._free):
            self.stats["exhaustions"] += 1
            if not table:
                del self._tables[rid]
                self._tenants.pop(rid, None)
            raise PageExhausted(
                f"request {rid} needs {need} pages, {len(self._free)} free")
        for _ in range(max(need, 0)):
            page = heapq.heappop(self._free)
            self._refs[page] = 1
            table.append(page)
            self.stats["allocs"] += 1
            t = self._tenants[rid]
            self._tenant_pages[t] = self._tenant_pages.get(t, 0) + 1
        return list(table)

    def adopt_shared(self, rid: str, keys: list[str],
                     tenant: str = "default") -> int:
        """Map a fresh request onto resident pages by content key.

        Adoption is prefix-greedy: it stops at the first key miss (chained
        keys make any later hit impossible anyway).  Returns the number of
        pages adopted.  Must be called before ``ensure`` for the same rid.
        """
        if self._tables.get(rid):
            raise RuntimeError(f"adopt_shared: {rid} already holds pages")
        table: list[int] = []
        for key in keys:
            page = self._shared_index.get(key)
            if page is None:
                break
            self._refs[page] += 1
            table.append(page)
        if table:
            self._tables[rid] = table
            self._tenants[rid] = tenant
            self._tenant_pages[tenant] = self._tenant_pages.get(tenant, 0) + len(table)
            self.stats["shared_hits"] += len(table)
        return len(table)

    def publish_keys(self, rid: str, keys: list[str]) -> None:
        """Register content keys for ``rid``'s leading pages (first writer
        wins; a stale entry for a since-mutated page is safe — see module
        docstring)."""
        table = self._tables.get(rid, [])
        for page, key in zip(table, keys):
            if key not in self._shared_index:
                self._shared_index[key] = page
                self._page_keys.setdefault(page, key)

    def writable_page(self, rid: str, position: int) -> tuple[int, Optional[int]]:
        """Physical page for writing at ``position``; COW when shared.

        Returns ``(page, copy_src)`` — ``copy_src`` is the page whose
        contents must be copied into ``page`` first (None when exclusive).
        """
        table = self._tables[rid]
        idx = position // self.config.page_size
        page = table[idx]
        if self._refs[page] <= 1:
            return page, None
        if not self._free:
            self.stats["exhaustions"] += 1
            raise PageExhausted(f"COW for {rid} position {position}: no free pages")
        fresh = heapq.heappop(self._free)
        self._refs[fresh] = 1
        self._refs[page] -= 1          # shared page keeps its other holders
        table[idx] = fresh
        self.stats["allocs"] += 1
        self.stats["cow_copies"] += 1
        return fresh, page

    # -- release ----------------------------------------------------------
    def _decref(self, page: int) -> bool:
        refs = self._refs.get(page, 0)
        if refs <= 0:
            raise RuntimeError(f"double free of page {page}")
        if refs == 1:
            del self._refs[page]
            key = self._page_keys.pop(page, None)
            if key is not None and self._shared_index.get(key) == page:
                del self._shared_index[key]
            heapq.heappush(self._free, page)
            self.stats["frees"] += 1
            return True
        self._refs[page] = refs - 1
        return False

    def release(self, rid: str) -> int:
        """Drop all of ``rid``'s pages; returns pages actually freed."""
        table = self._tables.pop(rid, None)
        if table is None:
            return 0
        tenant = self._tenants.pop(rid)
        self._tenant_pages[tenant] -= len(table)
        if not self._tenant_pages[tenant]:
            del self._tenant_pages[tenant]
        return sum(self._decref(page) for page in table)

    def leak(self, rid: str) -> int:
        """Drop ``rid``'s table WITHOUT freeing — models a failed release.

        The pages stay resident (held by no one) and are counted in
        ``leaked_pages``; chaos tests assert the counter and the capacity
        loss it implies.
        """
        table = self._tables.pop(rid, None)
        if table is None:
            return 0
        tenant = self._tenants.pop(rid)
        self._tenant_pages[tenant] -= len(table)
        if not self._tenant_pages[tenant]:
            del self._tenant_pages[tenant]
        self.stats["leaked_pages"] += len(table)
        return len(table)
