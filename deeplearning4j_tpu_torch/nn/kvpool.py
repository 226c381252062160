"""Paged KV-cache block pool: vLLM's PagedAttention memory discipline.

Counterpart of ``deeplearning4j_tpu/nn/kvpool.py``. KV state lives in a
shared pool of fixed-size token blocks (``[num_blocks, block_size,
heads, head_dim]`` per transformer layer); each sequence owns an ordered
block table of pool indices, and attention scatters into and gathers
from the pool through the table (the paged branch of
``TransformerBlockImpl.decode_step`` and ``prefill_paged``). Blocks are
allocated as a sequence grows and freed when it retires.

Invariants, as in the reference:

- **block 0 is the trash block**: never allocated, never freed. Tables
  are zero-padded past a sequence's allocation and masked writes land
  there;
- one logical block id indexes every layer's pool;
- allocation is **deterministic**: the free list hands out the lowest
  ids first, so a replayed schedule gives identical tables;
- accounting is host-side only: freed blocks are not cleared; the
  causal mask hides what a new owner has not yet written;
- blocks are **refcounted**: ``alloc`` gives refcount 1,
  :meth:`share_blocks` adds holders, :meth:`free_blocks` returns a block
  to the free list when its last reference drops, and dropping a
  reference on a free block (a double free) raises;
- a chain of **reclaimers** is consulted when ``alloc`` finds the free
  list short;
- each reference carries an owner tag, billed in byte-seconds
  (:meth:`attribution`), on the device tier and on the host tier
  separately.

The device tensors are made by ``torch.zeros``, never ``torch.empty``:
a gathered position past a sequence's end is masked by a softmax weight
of exactly 0, and ``0 * NaN`` from uninitialised memory would poison
the product with V. Programs write into them in place (the tensors stay
the pool's); :meth:`set_layers` installs replacements.

**Quantized pools** (``quant="int8"`` / ``"fp8"``): values at 1 byte an
element with float32 ``k_scale`` / ``v_scale`` tensors of shape
``[num_blocks, block_size, heads]`` beside them, under the same block
ids (:meth:`bytes_per_block` does the budget arithmetic).

**Host tier** (``host_blocks``): :meth:`swap_out` copies a block's
contents (scales included) to host memory and frees the device block;
:meth:`swap_in` allocates a fresh block and copies them back. Entries
are refcounted and owner-tagged like device blocks. :meth:`host_export`
gives each entry as numpy arrays: the stored values, in float32 where
numpy has no type for them (bfloat16, fp8), which :meth:`host_insert`
casts back exactly.

Metrics, the reference's (``monitor``): after every change the pool
publishes ``dl4j_kvpool_blocks_total`` / ``dl4j_kvpool_blocks_free``,
``dl4j_kvtier_host_blocks`` with a host tier and
``dl4j_quant_kv_blocks`` when quantized (each labelled ``pool=``); a
failed allocation ticks ``dl4j_kvpool_alloc_failures_total``, the host
tier's swaps ``dl4j_kvtier_swap_out_total`` / ``_swap_in_total`` and
the ``dl4j_kvtier_swap_latency_ms`` histogram, and :meth:`attribution`
sets the ``dl4j_attr_kv_*byte_seconds`` gauges per owner. All are host
counts. ``sharding=`` waits for the port's mesh (A9).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import (
    ATTR_KV_BYTE_SECONDS_GAUGE,
    ATTR_KV_HOST_BYTE_SECONDS_GAUGE,
    KVPOOL_ALLOC_FAILURES_COUNTER,
    KVPOOL_BLOCKS_FREE_GAUGE,
    KVPOOL_BLOCKS_TOTAL_GAUGE,
    KVTIER_HOST_BLOCKS_GAUGE,
    KVTIER_SWAP_IN_COUNTER,
    KVTIER_SWAP_LATENCY_HISTOGRAM,
    KVTIER_SWAP_OUT_COUNTER,
    QUANT_KV_BLOCKS_GAUGE,
    get_registry,
)
from deeplearning4j_tpu_torch.nn.quantize import kv_qparams
from deeplearning4j_tpu_torch.util.device import DeviceLike, resolve_device

#: Hashable KV layout a pool serves: (num_layers, heads, head_dim,
#: block_size, dtype name, quant mode or ""). A quantized pool never
#: shares a spec with a full-precision one.
PoolSpec = Tuple[int, int, int, int, str, str]

#: numpy can hold these storage dtypes as they are; the others export
#: as float32, which holds their values exactly
_NUMPY_EXACT = (torch.float32, torch.float16, torch.int8)


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``; a name passes through."""
    return str(dtype).replace("torch.", "")


def pool_spec(num_layers: int, num_heads: int, head_dim: int,
              block_size: int, dtype, quant: Optional[str] = None
              ) -> PoolSpec:
    return (int(num_layers), int(num_heads), int(head_dim),
            int(block_size), dtype_name(dtype),
            "" if quant is None else str(quant))


#: Attribution bucket for references taken without an owner tag.
UNTAGGED_OWNER = "_untagged"


class KVHostTierError(RuntimeError):
    """Host-tier accounting violation: a double free or an operation on
    an unknown host handle (a RuntimeError, typed)."""


class PagedKVCachePool:
    """Fixed-size token-block KV pool shared by every sequence of one
    layout, with deterministic host-side alloc/free accounting.

    ``layers`` holds one ``{"k", "v"}`` dict (plus ``"k_scale"``,
    ``"v_scale"`` when quantized) of device tensors per transformer
    layer. Accounting is mutex-guarded so ``stats()`` reads race-free;
    only the scheduler thread mutates it. ``device=None`` means cuda.
    """

    def __init__(self, num_blocks: int, block_size: int, num_layers: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 device: DeviceLike = None, name: str = "default",
                 sharding=None, quant: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 host_blocks: Optional[int] = None):
        if sharding is not None:
            raise NotImplementedError(
                "a sharded KV pool waits for the port's mesh (ROADMAP A9)")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.quant = quant
        self.storage_dtype = (kv_qparams(quant)[0] if quant is not None
                              else dtype)
        self.name = name
        self.spec: PoolSpec = pool_spec(num_layers, num_heads, head_dim,
                                        block_size, dtype, quant)
        self.device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, self.num_heads,
                 self.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        self.layers: List[Dict[str, torch.Tensor]] = []
        for _ in range(self.num_layers):
            entry = {"k": zeros(shape, self.storage_dtype),
                     "v": zeros(shape, self.storage_dtype)}
            if quant is not None:
                entry["k_scale"] = zeros(shape[:3], torch.float32)
                entry["v_scale"] = zeros(shape[:3], torch.float32)
            self.layers.append(entry)
        # block 0 = trash: never owned by a sequence
        self._free: List[int] = list(range(1, self.num_blocks))
        self._lock = threading.Lock()
        self._alloc_failures = 0
        # block id -> reference count; a block is in exactly one of
        # (_free, _refs)
        self._refs: Dict[int, int] = {}
        # consulted in registration order (outside the lock) when alloc
        # finds the free list short
        self._reclaimers: List[Callable[[int], object]] = []
        # ------------------------------------------------- host tier
        self._host_budget = (None if host_blocks is None
                             else max(0, int(host_blocks)))
        self._host: Dict[int, Dict[str, object]] = {}
        self._host_counter = 0
        self._owner_host_refs: Dict[str, int] = {}
        self._owner_host_bs: Dict[str, float] = {}
        self._host_bs = 0.0
        # per-block copy cost, EWMA over swap calls
        self._swap_in_ms: Optional[float] = None
        self._swap_out_ms: Optional[float] = None
        # --------------------- per-owner byte-second attribution
        # every reference bills its owner's tag; the conservation law:
        # sum over owners == the pool's own integral (exact under an
        # integer clock)
        self._clock = clock if clock is not None else time.monotonic
        self._block_bytes = self.block_bytes()
        self._ref_owners: Dict[int, List[str]] = {}  # block -> tags (1/ref)
        self._owner_refs: Dict[str, int] = {}        # owner -> live refs
        self._owner_bs: Dict[str, float] = {}        # owner -> byte-seconds
        self._pool_bs = 0.0
        self._attr_t = self._clock()
        self._publish()

    def _tick_attr_locked(self) -> None:
        """Bill the interval since the last tick (callers hold _lock)."""
        now = self._clock()
        dt = now - self._attr_t
        if dt > 0:
            bb = self._block_bytes
            total_refs = 0
            for owner, refs in self._owner_refs.items():
                if refs:
                    self._owner_bs[owner] = (
                        self._owner_bs.get(owner, 0.0) + dt * refs * bb)
                    total_refs += refs
            self._pool_bs += dt * total_refs * bb
            host_refs = 0
            for owner, refs in self._owner_host_refs.items():
                if refs:
                    self._owner_host_bs[owner] = (
                        self._owner_host_bs.get(owner, 0.0)
                        + dt * refs * bb)
                    host_refs += refs
            self._host_bs += dt * host_refs * bb
        self._attr_t = now

    # ------------------------------------------------------- accounting

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (the trash block is not one)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Logical blocks covering ``tokens`` cache positions."""
        return max(0, math.ceil(int(tokens) / self.block_size))

    def alloc(self, n: int, owner: Optional[str] = None
              ) -> Optional[List[int]]:
        """Claim ``n`` blocks at refcount 1 (lowest free ids first), or
        None when the pool cannot cover them (nothing claimed; the
        failure count ticks). A short free list first runs the
        reclaimer chain."""
        n = int(n)
        if n <= 0:
            return []
        got = self._try_alloc(n, owner)
        if got is None and self._reclaimers:
            for rec in list(self._reclaimers):
                with self._lock:
                    short = n - len(self._free)
                if short <= 0:
                    break
                try:
                    rec(short)
                except Exception:  # a broken evictor must not kill alloc
                    pass
            got = self._try_alloc(n, owner)
        if got is None:
            with self._lock:
                self._alloc_failures += 1
            get_registry().counter(
                KVPOOL_ALLOC_FAILURES_COUNTER,
                "KV block allocations that found the pool exhausted",
                pool=self.name).inc()
        self._publish()
        return got

    def _try_alloc(self, n: int, owner: Optional[str] = None
                   ) -> Optional[List[int]]:
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            if n > len(self._free):
                return None
            self._tick_attr_locked()
            got = self._free[:n]
            del self._free[:n]
            for b in got:
                self._refs[b] = 1
                self._ref_owners[b] = [tag]
            self._owner_refs[tag] = self._owner_refs.get(tag, 0) + n
        return got

    def share_blocks(self, ids: List[int],
                     owner: Optional[str] = None) -> List[int]:
        """Take one extra reference on each allocated block (the sharing
        half of copy-on-write). Sharing a free or trash block raises.
        Returns ``ids``."""
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            for b in ids:
                b = int(b)
                if b <= 0 or b >= self.num_blocks:
                    raise ValueError(f"block id {b} is not allocatable")
                if b not in self._refs:
                    raise ValueError(
                        f"block {b} is free — cannot share an unowned "
                        f"block (pool {self.name!r})")
            self._tick_attr_locked()
            for b in ids:
                self._refs[int(b)] += 1
                self._ref_owners[int(b)].append(tag)
            self._owner_refs[tag] = self._owner_refs.get(tag, 0) + len(ids)
        return list(ids)

    def ref_count(self, block: int) -> int:
        """Current reference count (0 = free)."""
        with self._lock:
            return self._refs.get(int(block), 0)

    def free_blocks(self, ids: List[int],
                    owner: Optional[str] = None) -> None:
        """Drop one reference per listed block; a block whose last
        reference drops returns to the (sorted) free list. Dropping a
        reference on a free block is a double free and raises
        ``RuntimeError``; a trash or out-of-range id raises
        ``ValueError``. ``owner`` names whose reference is released; a
        tag the block does not carry falls back to the untagged tag,
        then to the newest one."""
        if not ids:
            return
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            for b in ids:
                b = int(b)
                if b <= 0 or b >= self.num_blocks:
                    raise ValueError(f"block id {b} is not allocatable")
                if b not in self._refs:
                    raise RuntimeError(
                        f"pool {self.name!r}: double free of block {b} "
                        f"(refcount already 0)")
            self._tick_attr_locked()
            released = []
            for b in ids:
                b = int(b)
                r = self._refs[b] - 1
                billed = _release_tag(self._ref_owners.get(b, []), tag)
                _drop_ref(self._owner_refs, billed)
                if r == 0:
                    del self._refs[b]
                    self._ref_owners.pop(b, None)
                    released.append(b)
                else:
                    self._refs[b] = r
            self._free.extend(released)
            self._free.sort()
            if len(self._free) + len(self._refs) > self.total_blocks:
                raise RuntimeError(
                    f"pool {self.name!r} over-freed: {len(self._free)} free "
                    f"+ {len(self._refs)} referenced of {self.total_blocks} "
                    f"allocatable (double free)")
        self._publish()

    def register_reclaimer(self, fn) -> None:
        """Append ``fn(n_short)`` to the reclaimer chain ``alloc``
        consults when its free list is short."""
        self._reclaimers.append(fn)

    # ----------------------------------------------------- host tier

    @property
    def host_enabled(self) -> bool:
        """Whether the host tier is configured (``host_blocks`` > 0)."""
        return bool(self._host_budget)

    def set_host_budget(self, host_blocks: Optional[int]) -> None:
        """Resize the host-tier budget; existing entries stay valid."""
        self._host_budget = (None if host_blocks is None
                             else max(0, int(host_blocks)))
        self._publish()

    def host_blocks_used(self) -> int:
        with self._lock:
            return len(self._host)

    def host_budget(self) -> Optional[int]:
        return self._host_budget

    def _host_file(self, datas, tag: str) -> List[int]:
        """File new host entries (callers hold _lock, budget checked)."""
        self._tick_attr_locked()
        handles = []
        for data in datas:
            self._host_counter += 1
            self._host[self._host_counter] = {"data": data, "refs": 1,
                                              "owners": [tag]}
            handles.append(self._host_counter)
        self._owner_host_refs[tag] = (
            self._owner_host_refs.get(tag, 0) + len(handles))
        return handles

    def _host_room(self, n: int) -> bool:
        return bool(self._host_budget) and \
            len(self._host) + n <= self._host_budget

    def swap_out(self, ids: List[int],
                 owner: Optional[str] = None) -> Optional[List[int]]:
        """Copy each block's per-layer contents (scales included) to host
        memory, release the caller's device reference and return one
        host handle per block at host refcount 1; None, touching
        nothing, when the tier is off or over budget."""
        if not ids:
            return []
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            if not self._host_room(len(ids)):
                return None
        t0 = time.perf_counter()
        datas = [[{comp: arr[int(b)].to("cpu", copy=True)
                   for comp, arr in entry.items()}
                  for entry in self.layers] for b in ids]
        with self._lock:
            if not self._host_room(len(datas)):
                return None
            handles = self._host_file(datas, tag)
        self.free_blocks(ids, owner)
        per_blk = (time.perf_counter() - t0) * 1e3 / len(handles)
        self._swap_out_ms = _ewma(self._swap_out_ms, per_blk)
        self._count_swap("out", len(handles), per_blk)
        self._publish()
        return handles

    def swap_in(self, handles: List[int],
                owner: Optional[str] = None) -> Optional[List[int]]:
        """Allocate one fresh device block per handle, copy the stored
        contents in, and drop one host reference per handle. Returns the
        device ids, or None (nothing consumed) when the device pool
        cannot cover them."""
        if not handles:
            return []
        with self._lock:
            for h in handles:
                if int(h) not in self._host:
                    raise KVHostTierError(
                        f"pool {self.name!r}: swap_in of unknown host "
                        f"handle {h} (double free?)")
        t0 = time.perf_counter()
        got = self.alloc(len(handles), owner)
        if got is None:
            return None
        for h, b in zip(handles, got):
            with self._lock:
                data = self._host[int(h)]["data"]
            for layer, per in zip(self.layers, data):
                for comp, val in per.items():
                    layer[comp][b] = val.to(layer[comp].device)
        self.free_host(handles, owner)
        per_blk = (time.perf_counter() - t0) * 1e3 / len(handles)
        self._swap_in_ms = _ewma(self._swap_in_ms, per_blk)
        self._count_swap("in", len(handles), per_blk)
        self._publish()
        return got

    def _count_swap(self, direction: str, blocks: int, per_blk: float) -> None:
        reg = get_registry()
        if direction == "out":
            reg.counter(KVTIER_SWAP_OUT_COUNTER,
                        "KV blocks demoted device→host (contents copied, "
                        "device block freed)", pool=self.name).inc(blocks)
        else:
            reg.counter(KVTIER_SWAP_IN_COUNTER,
                        "KV blocks promoted host→device (contents scattered "
                        "into freshly allocated blocks)",
                        pool=self.name).inc(blocks)
        reg.histogram(KVTIER_SWAP_LATENCY_HISTOGRAM,
                      "Per-block KV tier swap latency (dir=out D2H, "
                      "dir=in H2D — the resume-crossover input)",
                      dir=direction).observe(per_blk)

    def free_host(self, handles: List[int],
                  owner: Optional[str] = None) -> None:
        """Drop one host reference per handle; an entry leaves the tier
        with its last reference. An unknown handle is a double free and
        raises :class:`KVHostTierError`."""
        if not handles:
            return
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            for h in handles:
                if int(h) not in self._host:
                    raise KVHostTierError(
                        f"pool {self.name!r}: double free of host "
                        f"handle {h}")
            self._tick_attr_locked()
            for h in handles:
                e = self._host[int(h)]
                billed = _release_tag(e["owners"], tag)
                _drop_ref(self._owner_host_refs, billed)
                e["refs"] -= 1
                if e["refs"] <= 0:
                    del self._host[int(h)]
        self._publish()

    def share_host(self, handles: List[int],
                   owner: Optional[str] = None) -> List[int]:
        """Take one extra host reference per handle."""
        tag = owner if owner is not None else UNTAGGED_OWNER
        with self._lock:
            for h in handles:
                if int(h) not in self._host:
                    raise ValueError(
                        f"pool {self.name!r}: cannot share unknown host "
                        f"handle {h}")
            self._tick_attr_locked()
            for h in handles:
                e = self._host[int(h)]
                e["refs"] += 1
                e["owners"].append(tag)
            self._owner_host_refs[tag] = (
                self._owner_host_refs.get(tag, 0) + len(handles))
        return list(handles)

    def host_export(self, handles: List[int]) -> List[Dict[str, np.ndarray]]:
        """One flat ``{"k0": [bs, h, hd], "v0": ..., "k_scale0": [bs, h],
        ...}`` dict of numpy arrays per handle (references are not
        consumed)."""
        out = []
        for h in handles:
            with self._lock:
                data = self._host[int(h)]["data"]
            flat = {}
            for li, per in enumerate(data):
                for comp, val in per.items():
                    if val.dtype not in _NUMPY_EXACT:
                        val = val.float()
                    flat[f"{comp}{li}"] = val.numpy()
            out.append(flat)
        return out

    def host_insert(self, blocks: List[Dict[str, np.ndarray]],
                    owner: Optional[str] = None) -> Optional[List[int]]:
        """File shipped contents (the :meth:`host_export` layout) in the
        host tier. Returns the new handles, or None when the tier is off
        or over budget."""
        if not blocks:
            return []
        tag = owner if owner is not None else UNTAGGED_OWNER
        dtypes = {comp: arr.dtype for comp, arr in self.layers[0].items()}
        datas = []
        for flat in blocks:
            per_layer: List[Dict[str, torch.Tensor]] = [
                {} for _ in range(self.num_layers)]
            for key, val in flat.items():
                comp = key.rstrip("0123456789")
                li = int(key[len(comp):])
                per_layer[li][comp] = torch.from_numpy(
                    np.array(val)).to(dtypes[comp])
            datas.append(per_layer)
        with self._lock:
            if not self._host_room(len(datas)):
                return None
            handles = self._host_file(datas, tag)
        self._publish()
        return handles

    def swap_in_cost_ms(self) -> Optional[float]:
        """Measured per-block restore cost (EWMA; None until the first
        swap_in)."""
        return self._swap_in_ms

    def shared_count(self) -> int:
        """Blocks held by more than one reference."""
        with self._lock:
            return sum(1 for r in self._refs.values() if r > 1)

    def occupancy(self) -> float:
        with self._lock:
            used = self.total_blocks - len(self._free)
        return used / self.total_blocks if self.total_blocks else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            free = len(self._free)
            failures = self._alloc_failures
            shared = sum(1 for r in self._refs.values() if r > 1)
            host_used = len(self._host)
        return {"blocks_total": self.total_blocks, "blocks_free": free,
                "block_size": self.block_size,
                "quant": self.quant,
                "block_bytes": self.block_bytes(),
                "occupancy": ((self.total_blocks - free) / self.total_blocks
                              if self.total_blocks else 0.0),
                "shared_blocks": shared,
                "alloc_failures": failures,
                "host_blocks_used": host_used,
                "host_budget": self._host_budget or 0,
                "host_occupancy": (host_used / self._host_budget
                                   if self._host_budget else 0.0)}

    def attribution(self) -> Dict[str, object]:
        """Per-owner capacity bill: byte-seconds of references held
        (billed up to now), live references, and the pool's own
        integral, per tier; ``sum(byte_seconds.values()) ==
        total_byte_seconds``."""
        with self._lock:
            self._tick_attr_locked()
            out = {"pool": self.name, "block_bytes": self._block_bytes,
                   "byte_seconds": dict(self._owner_bs),
                   "held_refs": dict(self._owner_refs),
                   "total_byte_seconds": self._pool_bs,
                   "host_byte_seconds": dict(self._owner_host_bs),
                   "held_host_refs": dict(self._owner_host_refs),
                   "host_total_byte_seconds": self._host_bs}
        reg = get_registry()
        for owner, bs in out["byte_seconds"].items():
            reg.gauge(ATTR_KV_BYTE_SECONDS_GAUGE,
                      "Cumulative KV-block byte-seconds held, per owner",
                      pool=self.name, owner=owner).set(bs)
        for owner, bs in out["host_byte_seconds"].items():
            reg.gauge(ATTR_KV_HOST_BYTE_SECONDS_GAUGE,
                      "Cumulative HOST-tier KV byte-seconds held, per "
                      "owner (host RAM billed separately from device "
                      "HBM — the conservation law holds per tier)",
                      pool=self.name, owner=owner).set(bs)
        return out

    def block_bytes(self) -> int:
        """Device bytes one logical block takes across every layer's K
        and V (scales included on a quantized pool)."""
        return self.bytes_per_block(self.num_layers, self.block_size,
                                    self.num_heads, self.head_dim,
                                    self.dtype, self.quant)

    @staticmethod
    def bytes_per_block(num_layers: int, block_size: int, num_heads: int,
                        head_dim: int, dtype=torch.float32,
                        quant: Optional[str] = None) -> int:
        """Per-block device bytes of a layout without building the pool:
        how a byte budget converts to ``num_blocks``. Quantized: 1-byte
        values plus a float32 scale per (position, head) for K and V."""
        storage = kv_qparams(quant)[0] if quant is not None else dtype
        per_val = torch.empty((), dtype=storage).element_size()
        val = 2 * num_layers * block_size * num_heads * head_dim * per_val
        if quant is None:
            return int(val)
        return int(val + 2 * num_layers * block_size * num_heads * 4)

    # ----------------------------------------------------- device tensors

    def set_layers(self, layers: List[Dict[str, torch.Tensor]]) -> None:
        """Install the pool tensors a program returned."""
        if len(layers) != self.num_layers:
            raise ValueError(
                f"expected {self.num_layers} layer pools, got {len(layers)}")
        self.layers = layers

    def _publish(self) -> None:
        """The pool's gauges, from host counts."""
        reg = get_registry()
        reg.gauge(KVPOOL_BLOCKS_TOTAL_GAUGE,
                  "Allocatable KV cache blocks in the paged pool",
                  pool=self.name).set(self.total_blocks)
        with self._lock:
            free = len(self._free)
            host_used = len(self._host)
        reg.gauge(KVPOOL_BLOCKS_FREE_GAUGE,
                  "KV cache blocks currently free in the paged pool",
                  pool=self.name).set(free)
        if self._host_budget:
            reg.gauge(KVTIER_HOST_BLOCKS_GAUGE,
                      "KV blocks resident in the host-RAM tier",
                      pool=self.name).set(host_used)
        if self.quant is not None:
            reg.gauge(QUANT_KV_BLOCKS_GAUGE,
                      "Allocatable blocks held in QUANTIZED (int8/fp8) "
                      "paged pools", pool=self.name).set(self.total_blocks)


def _release_tag(owners: List[str], tag: str) -> str:
    """Remove and return the tag one released reference bills: ``tag``
    if the holder list has it, else the untagged one, else the newest."""
    if tag in owners:
        owners.remove(tag)
        return tag
    if UNTAGGED_OWNER in owners:
        owners.remove(UNTAGGED_OWNER)
        return UNTAGGED_OWNER
    if owners:
        return owners.pop()
    return UNTAGGED_OWNER


def _drop_ref(counts: Dict[str, int], owner: str) -> None:
    held = counts.get(owner, 0)
    if held > 1:
        counts[owner] = held - 1
    else:
        counts.pop(owner, None)


def _ewma(cur: Optional[float], x: float) -> float:
    return x if cur is None else 0.8 * cur + 0.2 * x
