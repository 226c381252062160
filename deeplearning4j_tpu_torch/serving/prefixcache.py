"""Cross-request prefix cache: a radix index over block-aligned token
runs mapped onto the refcounted paged KV pool.

Counterpart of ``deeplearning4j_tpu/serving/prefixcache.py`` (vLLM's
automatic prefix caching, SGLang's RadixAttention) on the port's pool
(``nn/kvpool.py``):

- **index**: a radix tree over BLOCK-ALIGNED token runs, one tree of
  full-block nodes per ``(model, version)`` lane (a lane's K/V comes
  from one version's parameters, so lanes never match each other).
  Each full node owns one pool block (the cache holds a reference); a
  node may also carry *partial* children: an inserting sequence's last,
  partially-filled block with its token content;
- **insert-on-retire**: a retiring (or preempted) sequence offers its
  written token run and block table; the cache walks or extends the
  chain, taking a pool reference on each block it newly pins (a chain
  already there is only touched, and the sequence's own blocks free
  normally);
- **longest-prefix match at admission**: a prompt walks the chain,
  shares every matched full block (one pool reference per block, on the
  sequence's behalf) and optionally one partial tail block, and then
  only the remaining tail is prefilled. A match is capped at
  ``len(prompt) - 1``: the last prompt token is always recomputed, for
  the logits of the first sampled token;
- **copy-on-write**: full blocks are immutable once written (decode
  writes only at the growing tail), so the only block a sharer can
  collide on is a matched *partial* tail block; the scheduler copies it
  to a fresh block before its first write lands
  (``dl4j_prefixcache_cow_copies_total``) and drops the shared
  reference;
- **deterministic eviction through the free list**: the cache registers
  as the pool's reclaimer. When ``alloc`` finds the free list short it
  evicts cached blocks that nobody else references, leaves first, in
  LRU order of a logical clock that ticks only on cache operations
  (ties on node id), so a replayed schedule evicts the same blocks; a
  block a live sequence references is never a candidate. An optional
  ``capacity_blocks`` bounds the cache on its own. With the pool's host
  tier on, the first reclaimer demotes such blocks to host memory
  (still matchable; a match swaps them back in) before the second drops
  any.

Everything here is host-side accounting; the device halves (the tail
prefill over pool blocks, the block copy) are ``nn/generate.py``
programs that the scheduler drives.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.monitor import (
    KVTIER_DEMOTIONS_COUNTER,
    PREFIXCACHE_CACHED_BLOCKS_GAUGE,
    PREFIXCACHE_COW_COPIES_COUNTER,
    PREFIXCACHE_DEMOTIONS_COUNTER,
    PREFIXCACHE_EVICTIONS_COUNTER,
    PREFIXCACHE_HITS_COUNTER,
    PREFIXCACHE_MISSES_COUNTER,
    PREFIXCACHE_SAVED_TOKENS_COUNTER,
    PREFIXCACHE_SHARED_BLOCKS_GAUGE,
    get_registry,
)
from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool


class _Node:
    """One cached block: a full block-run radix node (``fill ==
    block_size``) or a partial tail (``fill < block_size``, kept under
    its parent's ``partials``). The cache holds exactly ONE pool
    reference per node."""

    __slots__ = ("nid", "lane", "block", "tokens", "fill", "parent",
                 "pkey", "partial", "children", "partials", "last_used",
                 "host")

    def __init__(self, nid: int, lane, block: Optional[int],
                 tokens: Tuple[int, ...], fill: int,
                 parent: Optional["_Node"], partial: bool):
        self.nid = nid
        self.lane = lane
        self.block = block          # None for roots and host-resident nodes
        self.host = None            # host-tier handle when demoted
        self.tokens = tokens
        self.fill = fill
        self.parent = parent
        self.pkey = tokens          # key in the parent's child dict
        self.partial = partial
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.partials: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0

    def leaf(self) -> bool:
        return not self.children and not self.partials


class PrefixCache:
    """Token-prefix → KV-block index over one :class:`PagedKVCachePool`
    (one cache per pool; lanes sharing the pool get separate radix
    roots keyed by their ``(model, version)``)."""

    def __init__(self, pool: PagedKVCachePool,
                 capacity_blocks: Optional[int] = None,
                 register: bool = True):
        self.pool = pool
        self.block_size = pool.block_size
        self.capacity_blocks = (None if capacity_blocks is None
                                else max(0, int(capacity_blocks)))
        self._roots: Dict[Tuple, _Node] = {}
        self._nodes = 0             # live node count (cached blocks)
        self._nid = 0               # node id allotter (eviction ties)
        self._clock = 0             # logical LRU clock: cache ops only
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._demotions = 0
        self._host_nodes = 0        # nodes resident in the host tier
        self._cow_copies = 0
        self._saved_tokens = 0
        self._inserted_runs = 0
        self._lock = threading.RLock()
        if register:
            # the exhaustion ladder, pinned by registration order:
            # cache-DEMOTE to the host tier first (nothing is lost),
            # cache-DROP second, and only then does alloc fail. The
            # demote rung no-ops on pools without a host tier.
            pool.register_reclaimer(self.reclaim_demote)
            pool.register_reclaimer(self.reclaim)

    # ------------------------------------------------------------ probe

    def match(self, lane: Tuple, tokens) -> Tuple[int, List[int],
                                                  Optional[int]]:
        """Longest cached prefix of ``tokens`` for ``lane``: returns
        ``(matched_tokens, full_block_ids, partial_block_id)``. The
        cache takes one pool reference per returned block ON THE
        CALLER'S BEHALF — the sequence frees them like its own blocks
        (refcounted, so "free" just drops its hold). Matching walks
        whole blocks, then the best (longest, oldest-id tie-break)
        partial child; it is capped at ``len(tokens) - 1`` so the last
        prompt token is always recomputed for its logits."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        with self._lock:
            self._clock += 1
            root = self._roots.get(lane)
            usable = toks[:max(0, len(toks) - 1)]
            full_ids: List[int] = []
            partial_id: Optional[int] = None
            m = 0
            if root is not None:
                cur = root
                i = 0
                # blocks are shared AS THE WALK MATCHES THEM (not at
                # the end): a host-resident node's promotion below
                # allocates device blocks, which may run the reclaimer
                # chain — an already-matched block at refcount 1 could
                # be evicted out from under us; at refcount 2 it is
                # pinned by the caller's share and untouchable
                while i + bs <= len(usable):
                    child = cur.children.get(tuple(usable[i:i + bs]))
                    if child is None:
                        break
                    child.last_used = self._clock
                    if child.block is None \
                            and not self._promote_locked(child):
                        break  # host-resident, device full: match ends
                    self.pool.share_blocks([child.block])
                    full_ids.append(child.block)
                    cur = child
                    i += bs
                best: Optional[_Node] = None
                best_len = 0
                rest = usable[i:]
                for ptoks, pnode in cur.partials.items():
                    cl = 0
                    for a, b in zip(ptoks, rest):
                        if a != b:
                            break
                        cl += 1
                    if cl >= 1 and (cl > best_len or
                                    (cl == best_len and best is not None
                                     and pnode.nid < best.nid)):
                        best, best_len = pnode, cl
                if best is not None and (
                        best.block is not None
                        or self._promote_locked(best)):
                    best.last_used = self._clock
                    self.pool.share_blocks([best.block])
                    partial_id = best.block
                    m = i + best_len
                else:
                    m = i
        self._publish()
        return m, full_ids, partial_id

    def note_admitted(self, matched_tokens: int) -> None:
        """Record one COMMITTED admission probe (hit/miss + saved
        prefill tokens). Separate from :meth:`match` because the
        scheduler may probe and roll a candidate back (group-signature
        mismatch) — only admissions that actually clone the table
        count."""
        m = int(matched_tokens)
        reg = get_registry()
        with self._lock:
            if m > 0:
                self._hits += 1
                self._saved_tokens += m
            else:
                self._misses += 1
        if m > 0:
            reg.counter(PREFIXCACHE_HITS_COUNTER,
                        "Admissions that matched a cached prefix",
                        pool=self.pool.name).inc()
            reg.counter(PREFIXCACHE_SAVED_TOKENS_COUNTER,
                        "Prompt tokens whose prefill was skipped because "
                        "their KV blocks were already cached",
                        pool=self.pool.name).inc(m)
        else:
            reg.counter(PREFIXCACHE_MISSES_COUNTER,
                        "Admissions that matched nothing",
                        pool=self.pool.name).inc()

    # ----------------------------------------------------------- insert

    def insert(self, lane: Tuple, tokens, blocks: List[int]) -> int:
        """Insert-on-retire: pin the retiring sequence's written token
        run (``tokens`` = every position its blocks actually hold) into
        the lane's radix chain. Full blocks extend the chain; a
        trailing partial block becomes a partial child carrying its
        fill. Chains that already exist are touched, not re-pinned —
        the sequence's own duplicate blocks then free normally. Returns
        the number of blocks newly pinned."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        pinned = 0
        with self._lock:
            self._clock += 1
            self._inserted_runs += 1
            root = self._roots.get(lane)
            if root is None:
                self._nid += 1
                root = self._roots[lane] = _Node(
                    self._nid, lane, None, (), 0, None, False)
            cur = root
            full = len(toks) // bs
            for i in range(min(full, len(blocks))):
                bt = tuple(toks[i * bs:(i + 1) * bs])
                child = cur.children.get(bt)
                if child is None:
                    self.pool.share_blocks([blocks[i]])
                    self._nid += 1
                    child = _Node(self._nid, lane, int(blocks[i]), bt,
                                  bs, cur, False)
                    cur.children[bt] = child
                    self._nodes += 1
                    pinned += 1
                child.last_used = self._clock
                cur = child
            fill = len(toks) % bs
            if fill and full < len(blocks):
                pt = tuple(toks[full * bs:])
                pnode = cur.partials.get(pt)
                if pnode is None:
                    self.pool.share_blocks([blocks[full]])
                    self._nid += 1
                    pnode = _Node(self._nid, lane, int(blocks[full]), pt,
                                  fill, cur, True)
                    cur.partials[pt] = pnode
                    self._nodes += 1
                    pinned += 1
                pnode.last_used = self._clock
            if self.capacity_blocks is not None \
                    and self._nodes > self.capacity_blocks:
                self._evict_locked(self._nodes - self.capacity_blocks)
        self._publish()
        return pinned

    def note_cow(self, n: int = 1) -> None:
        """Account ``n`` copy-on-write block duplications (the
        scheduler performs the device copy; the cache owns the
        metric)."""
        with self._lock:
            self._cow_copies += int(n)
        get_registry().counter(
            PREFIXCACHE_COW_COPIES_COUNTER,
            "Copy-on-write KV block duplications (a writer's shared "
            "partial tail block copied before its scatter landed)",
            pool=self.pool.name).inc(int(n))
        self._publish()

    # --------------------------------------------------------- eviction

    def _promote_locked(self, node: _Node) -> bool:
        """Swap a host-resident node's block back onto the device so a
        match can share it. False (node untouched, handle still valid)
        when the device pool cannot cover it even after reclaim."""
        got = self.pool.swap_in([node.host])
        if got is None:
            return False
        node.block = int(got[0])
        node.host = None
        self._host_nodes -= 1
        self._nodes += 1
        return True

    def _pick_victim_locked(self) -> Optional[_Node]:
        """Deterministic LRU victim: the device-resident node with NO
        device-resident descendant (so the on-device radix chain never
        dangles — host-resident children ride along) whose only
        reference is the cache's; ties break on node id."""
        victim: Optional[_Node] = None

        def walk(node: _Node) -> bool:
            nonlocal victim
            has_dev = False
            for ch in list(node.children.values()) \
                    + list(node.partials.values()):
                has_dev |= walk(ch)
            if node.block is None:
                return has_dev
            if not has_dev and self.pool.ref_count(node.block) == 1 \
                    and (victim is None or (node.last_used, node.nid)
                         < (victim.last_used, victim.nid)):
                victim = node
            return True

        for root in self._roots.values():
            for ch in list(root.children.values()) \
                    + list(root.partials.values()):
                walk(ch)
        return victim

    def reclaim_demote(self, n: int) -> int:
        """First rung of the exhaustion ladder: demote up to ``n``
        cached-but-unreferenced blocks to the HOST tier (contents
        preserved; the node stays in the radix tree and is matchable —
        a later match swaps it back in). No-ops when the pool has no
        host tier or its budget is full, letting the drop rung run."""
        if not getattr(self.pool, "host_enabled", False):
            return 0
        with self._lock:
            demoted = self._demote_locked(int(n))
        self._publish()
        return demoted

    def _demote_locked(self, n: int) -> int:
        demoted = 0
        while demoted < n:
            victim = self._pick_victim_locked()
            if victim is None:
                break
            handles = self.pool.swap_out([victim.block])
            if handles is None:
                break  # host budget exhausted: the drop rung is next
            victim.block = None
            victim.host = handles[0]
            self._nodes -= 1
            self._host_nodes += 1
            self._demotions += 1
            demoted += 1
        if demoted:
            reg = get_registry()
            reg.counter(
                PREFIXCACHE_DEMOTIONS_COUNTER,
                "Cached-but-unreferenced KV blocks demoted to the host "
                "tier instead of dropped (contents preserved)",
                pool=self.pool.name).inc(demoted)
            reg.counter(
                KVTIER_DEMOTIONS_COUNTER,
                "KV blocks demoted device→host by exhaustion pressure "
                "(the reclaimer chain's first rung)",
                pool=self.pool.name).inc(demoted)
        return demoted

    def reclaim(self, n: int) -> int:
        """The pool's reclaimer seam: evict up to ``n`` cached blocks
        whose ONLY reference is the cache's (deterministic LRU —
        logical clock, node-id tie-break, leaves first so the radix
        chain never dangles). Returns how many blocks were freed."""
        with self._lock:
            freed = self._evict_locked(int(n))
        self._publish()
        return freed

    def _drop_hosts_locked(self, node: _Node) -> None:
        stack = list(node.children.values()) + list(node.partials.values())
        node.children.clear()
        node.partials.clear()
        while stack:
            ch = stack.pop()
            stack.extend(ch.children.values())
            stack.extend(ch.partials.values())
            if ch.host is not None:
                self.pool.free_host([ch.host])
                self._host_nodes -= 1

    def _evict_locked(self, n: int) -> int:
        freed = 0
        while freed < n:
            victim = self._pick_victim_locked()
            if victim is None:
                break  # everything left is referenced or interior
            parent = victim.parent
            if victim.partial:
                parent.partials.pop(victim.pkey, None)
            else:
                parent.children.pop(victim.pkey, None)
            # host-resident descendants leave the tree with the victim
            # — their handles free, or they would leak the host budget
            self._drop_hosts_locked(victim)
            self._nodes -= 1
            self._evictions += 1
            self.pool.free_blocks([victim.block])
            freed += 1
        if freed:
            get_registry().counter(
                PREFIXCACHE_EVICTIONS_COUNTER,
                "Cached-but-unreferenced KV blocks evicted back to the "
                "pool free list", pool=self.pool.name).inc(freed)
        return freed

    def clear(self) -> int:
        """Release every cache-held block reference (drain-time
        accounting audits call this: after ``clear()`` a quiesced
        pool's free count must equal its total). Returns the number of
        blocks released."""
        with self._lock:
            released = 0
            for root in self._roots.values():
                stack = list(root.children.values()) \
                    + list(root.partials.values())
                while stack:
                    node = stack.pop()
                    stack.extend(node.children.values())
                    stack.extend(node.partials.values())
                    if node.host is not None:
                        self.pool.free_host([node.host])
                    else:
                        self.pool.free_blocks([node.block])
                    released += 1
            self._roots.clear()
            self._nodes = 0
            self._host_nodes = 0
        self._publish()
        return released

    # ------------------------------------------------------------ state

    def cached_blocks(self) -> int:
        with self._lock:
            return self._nodes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            hits, misses = self._hits, self._misses
            out = {
                "cached_blocks": self._nodes,
                "cached_bytes": self._nodes * self.pool.block_bytes(),
                "hits": hits,
                "misses": misses,
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
                "evictions": self._evictions,
                "demotions": self._demotions,
                "host_blocks": self._host_nodes,
                "cow_copies": self._cow_copies,
                "saved_prefill_tokens": self._saved_tokens,
                "inserted_runs": self._inserted_runs,
                "capacity_blocks": self.capacity_blocks,
            }
        out["shared_blocks"] = self.pool.shared_count()
        return out

    def _publish(self) -> None:
        reg = get_registry()
        with self._lock:
            nodes = self._nodes
        reg.gauge(PREFIXCACHE_CACHED_BLOCKS_GAUGE,
                  "KV blocks currently pinned by the prefix cache",
                  pool=self.pool.name).set(nodes)
        reg.gauge(PREFIXCACHE_SHARED_BLOCKS_GAUGE,
                  "KV blocks currently referenced by more than one "
                  "holder (live prefix sharing)",
                  pool=self.pool.name).set(self.pool.shared_count())
