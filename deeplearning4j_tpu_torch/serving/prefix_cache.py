"""Cross-request prefix caching over the paged KV pool.

Counterpart of ``deeplearning4j_tpu/serving/prefix_cache.py``, whole: the
module is host-side bookkeeping and runs unchanged. Pages of
`PagedKVCache` are refcounted; a `PrefixCache` keys completed full pages
by a rolling token-prefix hash, and a request whose prompt prefix matches
cached pages ADOPTS them (refcount bump, no copy, no compute) and
prefills only the suffix.

Sharing discipline (the copy-on-write line):

- only FULL pages whose every position is covered by PROMPT tokens are
  ever published; a page holding generated tokens, or a partial page,
  stays private;
- adoption is capped at ``(len(prompt) - 1) // page`` full pages, so the
  adopter always feeds at least its final prompt token through the step,
  and every position it ever WRITES lands on a page it allocated itself:
  the divergence page is re-prefilled into a fresh page (copy-on-write
  realized as recompute-on-write). The port writes its pools in place, so
  this rule is what keeps a published page bit-stable;
- hash chains are verified against the stored token blocks, so a
  rolling-hash collision degrades to a miss, never to wrong KV.

Page lifecycle: a slot's reservation holds one reference per page;
publishing adds the cache's own. A page whose only reference is the cache
(refcount == 1) is RECLAIMABLE: `plan_admission` counts those pages when
the free pool alone cannot satisfy a request, so the head of the line
evicts idle cached pages instead of blocking the FIFO forever.

Threading: all mutation happens on the engine thread (admission, publish,
finish); `stats()` reads only ints for health.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.telemetry import flight


class PrefixCache:
    """Rolling-hash chain store mapping full-page token prefixes to
    resident KV pool pages."""

    def __init__(self, page, max_pages=None):
        self.page = int(page)
        # optional resident-page cap; the pool itself is the hard
        # bound (cached pages are reclaimable under admission
        # pressure, so an uncapped cache cannot wedge the pool)
        self.max_pages = max_pages if max_pages is None else int(max_pages)
        self._entries: dict = {}   # (depth, hash) -> entry dict
        self._clock = 0
        self.hits = 0              # admissions that adopted >= 1 page
        self.misses = 0

    def __len__(self):
        return len(self._entries)

    def _touch(self, key):
        self._clock += 1
        self._entries[key]["last"] = self._clock

    def _chain(self, tokens, max_depth):
        """[(key, block)] for the first ``max_depth`` full pages of
        ``tokens`` — key d chains the hash of every block before it."""
        out, h = [], 0
        for d in range(1, max_depth + 1):
            block = tuple(tokens[(d - 1) * self.page: d * self.page])
            h = hash((h, block))
            out.append(((d, h), block))
        return out

    # -- lookup / adoption ---------------------------------------------------
    def match(self, prompt, max_pages=None):
        """(pages, keys) of the longest cached chain covering full
        pages of ``prompt[:-1]`` (never the final prompt token — the
        adopter must keep one token to feed, see module docstring).
        ``max_pages`` additionally caps the depth (the speculative
        draft lane adopts at most what the target adopted)."""
        depth = (len(prompt) - 1) // self.page
        if max_pages is not None:
            depth = min(depth, int(max_pages))
        pages, keys = [], []
        for key, block in self._chain(prompt, depth):
            e = self._entries.get(key)
            if e is None or e["block"] != block:
                break
            pages.append(e["page"])
            keys.append(key)
        return pages, keys

    def touch(self, keys):
        for key in keys:
            if key in self._entries:
                self._touch(key)

    # -- publication ---------------------------------------------------------
    def publish(self, kv, prompt, pages):
        """Insert the full prompt pages of a just-prefilled slot
        (``pages`` in position order, ``len(prompt) // page`` of
        them). The cache takes its own reference on each newly-cached
        page; already-cached chains are only LRU-refreshed."""
        added = 0
        for i, (key, block) in enumerate(
                self._chain(prompt, len(prompt) // self.page)):
            if i >= len(pages):
                break
            if key in self._entries:
                self._touch(key)
                continue
            page = int(pages[i])
            if page == 0:
                continue   # scratch is never sharable
            kv.retain(page)
            self._clock += 1
            self._entries[key] = {"page": page, "block": block,
                                  "depth": key[0], "last": self._clock}
            added += 1
        if added and self.max_pages is not None and \
                len(self._entries) > self.max_pages:
            self.evict(kv, len(self._entries) - self.max_pages)
        return added

    # -- reclamation ---------------------------------------------------------
    def reclaimable(self, kv, protect=()):
        """Pages this cache could free right now: resident, not in
        ``protect``, and referenced by nobody but the cache."""
        protect = set(protect)
        return sum(1 for e in self._entries.values()
                   if e["page"] not in protect
                   and kv.refcount(e["page"]) == 1)

    def evict(self, kv, n, protect=()):
        """Free up to ``n`` pages by dropping idle entries, least-
        recently-used first (deeper chain links first on ties, so a
        chain sheds from its tail and shallow prefixes stay useful).
        Entries whose page is still slot-referenced are skipped. An
        evicted mid-chain link orphans its deeper links — they stay
        resident but unreachable, and this same LRU loop reclaims
        them on a later pass."""
        protect = set(protect)
        freed = 0
        order = sorted(self._entries.items(),
                       key=lambda kv_: (kv_[1]["last"], -kv_[1]["depth"]))
        for key, e in order:
            if freed >= n:
                break
            if e["page"] in protect or kv.refcount(e["page"]) != 1:
                continue
            del self._entries[key]
            kv.decref(e["page"])
            freed += 1
        if freed:
            flight.record("prefix_evict", pages=freed,
                          resident=len(self._entries))
        return freed

    def clear(self, kv):
        """Drop every entry (releasing the cache's references; pages
        still reserved by active slots stay allocated until their
        slot releases them)."""
        for e in self._entries.values():
            kv.decref(e["page"])
        n = len(self._entries)
        self._entries.clear()
        return n

    def stats(self):
        total = self.hits + self.misses
        return {"pages": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (round(self.hits / total, 4) if total
                             else None)}


# ---------------------------------------------------------------------------
# admission planning (shared by the engine's target lane and the
# speculative draft lane, so the two cannot drift)
# ---------------------------------------------------------------------------

def plan_admission(kv, cache, prompt, total_len, max_adopt=None):
    """How the head-of-line request gets its pages, or None when it
    truly cannot (need exceeds free + reclaimable — the only case
    left where strict FIFO waits). The plan is host-side and
    side-effect free; `apply_admission` executes it."""
    need = kv.pages_for(total_len)
    pages, keys = (cache.match(prompt, max_pages=max_adopt)
                   if cache is not None else ([], []))
    fresh = need - len(pages)
    free = kv.free_pages
    if fresh <= free:
        return {"adopt": pages, "keys": keys, "evict": 0}
    if cache is None:
        return None
    if fresh <= free + cache.reclaimable(kv, protect=pages):
        return {"adopt": pages, "keys": keys, "evict": fresh - free}
    return None


def apply_admission(kv, cache, plan, slot, total_len):
    """Execute a plan for ``slot``: evict what the plan reclaimed,
    adopt the matched chain (refcount bump via reserve), allocate the
    fresh suffix pages. Returns the number of adopted pages."""
    if plan["evict"]:
        cache.evict(kv, plan["evict"], protect=plan["adopt"])
    kv.reserve(slot, total_len, adopted=plan["adopt"])
    if cache is not None and plan["keys"]:
        cache.touch(plan["keys"])
    return len(plan["adopt"])
