"""TenantRegistry — tenant lifecycle and the stacked hot tables.

The registry owns every :class:`~repro_torch.tenancy.tenant.TenantState`:

* **Lifecycle** — ``create``/``evict`` with stable integer *slots* (freed
  slots are reused lowest first, so the stacked tables stay dense and a
  tenant's index never changes while it lives) and a creation sequence
  ``gen`` that tells a re-created name from its evicted ancestor.
* **Store fan-out** — ``grow`` and ``remap`` forward the vector store's
  inserts and compactions to every tenant's counter (and hot id map), so
  all preference state stays consistent under insert/delete/compact.
* **Stacking** — :meth:`TenantRegistry.stacked` packs every tenant's hot
  tables into capacity-padded device tensors: ``(T_pad, H_pad+1, d)``
  rows, ``(T_pad, H_pad+1, R)`` local-id adjacency, ``(T_pad, H_pad+1)``
  local→global id maps and ``(T_pad, E)`` entry seeds.  ``T_pad`` and
  ``H_pad`` grow geometrically, so the shapes stay put as tenants come and
  go; the engines route each lane to its tenant's slice by
  ``tenant_idx`` and serve a mixed-tenant wave in one search.

Port of ``repro/tenancy/registry.py``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.ref import next_pow2

from .tenant import DEFAULT_TENANT, TenantState

__all__ = ["StackedHotTables", "TenantRegistry"]

# == repro_torch.core.types.PAD_VALUE (core imports this package)
_PAD_VALUE = 1e9


class StackedHotTables(NamedTuple):
    """All tenants' hot tables in one set of device tensors.

    Per-tenant hot graphs use local ids ``0..H_pad-1`` with sentinel
    ``H_pad``; ``ids`` maps local→global (padding slots map to the store
    *capacity*, the global sentinel).  Empty slots (no tenant / no hot
    index) are all-sentinel, so a stray query routed there retires with an
    empty pool instead of corrupting anything.
    """

    x: torch.Tensor        # (T_pad, H_pad+1, d) float32 hot vectors
    adj: torch.Tensor      # (T_pad, H_pad+1, R) int32 local adjacency
    ids: torch.Tensor      # (T_pad, H_pad+1) int32 local→global id map
    entries: torch.Tensor  # (T_pad, E) int32 local entry seeds
    mask: torch.Tensor     # (T_pad, H_pad+1) bool — True on real hot rows

    @property
    def h_pad(self) -> int:
        return self.x.shape[1] - 1

    @property
    def t_pad(self) -> int:
        return self.x.shape[0]


class TenantRegistry:
    """Create/evict tenants; stack their hot tables on ``device``."""

    def __init__(self, n_rows: int, trigger: int, *, device=None,
                 default: str = DEFAULT_TENANT, registry=None):
        self._n = int(n_rows)
        self._trigger = int(trigger)
        self.device = device
        self._tenants: dict[str, TenantState] = {}
        self._slots: list[Optional[str]] = []
        self._default_name = default
        self._stack: Optional[StackedHotTables] = None
        self._stack_key = None
        self._gen = 0
        # obs wiring (repro_torch.obs.MetricsRegistry): per-tenant
        # preference gauges published at scrape time; keyed, so a rebuilt
        # registry replaces the stale closure
        self.metrics = registry
        if registry is not None:
            registry.register_callback("tenants", self._collect_metrics)
        self.create(default)

    # -------------------------------------------------------------- lifecycle
    def create(self, name: str) -> TenantState:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        from repro_torch.core.hot_index import QueryCounter
        try:                      # reuse the lowest freed slot (stay dense)
            slot = self._slots.index(None)
        except ValueError:
            slot = len(self._slots)
            self._slots.append(None)
        self._gen += 1
        t = TenantState(name=name,
                        counter=QueryCounter(self._n, trigger=self._trigger),
                        slot=slot, gen=self._gen)
        self._slots[slot] = name
        self._tenants[name] = t
        return t

    def evict(self, name: str) -> None:
        """Drop a tenant's preference state (its slot becomes reusable).

        In-flight lanes of an evicted tenant retire harmlessly: the engines
        skip counter feedback for names no longer registered.
        """
        if name == self._default_name:
            raise ValueError("cannot evict the default tenant")
        t = self.get(name)
        del self._tenants[name]
        self._slots[t.slot] = None

    def get(self, name: str) -> TenantState:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r} "
                           f"(have {sorted(self._tenants)})") from None

    @property
    def default(self) -> TenantState:
        return self._tenants[self._default_name]

    def slot_of(self, name: str) -> int:
        return self.get(name).slot

    def names(self) -> list[str]:
        return list(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def __iter__(self) -> Iterator[TenantState]:
        return iter(self._tenants.values())

    # ---------------------------------------------------------- store fan-out
    def grow(self, n_new: int) -> None:
        """Extend every tenant's counter id space after inserts."""
        self._n = int(n_new)
        for t in self._tenants.values():
            t.counter.grow(n_new)

    def remap(self, remap: np.ndarray) -> list[str]:
        """Fan a compaction remap out to every counter and hot id map.

        Returns the tenants whose hot index lost a row: the caller must
        rebuild those (unreachable when deletes rebuild eagerly, but kept
        for explicit ``hot_ids`` overrides).
        """
        need_rebuild = []
        for t in self._tenants.values():
            t.counter.remap(remap)
            if not t.remap_hot(remap):
                need_rebuild.append(t.name)
        self._n = self.default.counter.n
        return need_rebuild

    def hot_tenants_containing(self, ids: np.ndarray) -> list[str]:
        """Tenants whose hot index references any of ``ids`` (deletions)."""
        ids = np.asarray(ids)
        return [t.name for t in self._tenants.values()
                if t.hot is not None and np.isin(t.hot.ids, ids).any()]

    def _collect_metrics(self) -> dict:
        """Registry scrape-time collector (keyed ``"tenants"``).

        ``tenant_head_mass`` is the fraction of a tenant's preference mass
        in its hot-sized head: low head mass means the hot index buys
        little for that tenant.
        """
        out = {"tenants_live": float(len(self._tenants))}
        for t in self._tenants.values():
            lbl = f"{{tenant={t.name}}}"
            counts = t.counter.counts
            total = float(counts.sum())
            out[f"tenant_pref_mass_total{lbl}"] = total
            out[f"tenant_since_rebuild{lbl}"] = float(
                t.counter.since_rebuild)
            hot_n = t.hot.size if t.hot is not None else 0
            out[f"tenant_hot_size{lbl}"] = float(hot_n)
            if total > 0.0 and hot_n > 0:
                head = counts if hot_n >= counts.size else \
                    np.partition(counts, -hot_n)[-hot_n:]
                out[f"tenant_head_mass{lbl}"] = float(head.sum()) / total
                ids = t.hot.ids[t.hot.ids < counts.size]
                out[f"tenant_hot_mass_ratio{lbl}"] = \
                    float(counts[ids].sum()) / total
            else:
                out[f"tenant_head_mass{lbl}"] = 0.0
                out[f"tenant_hot_mass_ratio{lbl}"] = 0.0
        return out

    # ------------------------------------------------------------- stacking
    def stacked(self, store) -> StackedHotTables:
        """Stacked device tables, maintained incrementally.

        The padded shapes (store capacity, ``T_pad``, ``H_pad``, adjacency
        width, entry count) change rarely.  While they hold, a tenant's hot
        rebuild re-uploads only *that tenant's slot* (in place, by index
        assignment) instead of restacking every tenant; a shape change
        rebuilds the stack.
        """
        live = [t for t in self._tenants.values() if t.hot is not None]
        shape_key = (store.capacity,
                     next_pow2(max(len(self._slots), 1)),
                     next_pow2(max([t.hot.size for t in live] or [1])),
                     max([t.hot.graph.adj.shape[1] for t in live] or [1]),
                     max([t.hot.graph.entries.shape[0] for t in live]
                         or [1]))
        slot_key = tuple(
            (self._tenants[name].gen, self._tenants[name].hot_token)
            if name is not None else None
            for name in self._slots) + (None,) * (shape_key[1]
                                                  - len(self._slots))
        if self._stack is None or self._stack_key is None \
                or shape_key != self._stack_key[0]:
            self._stack = self._build_stack(store, *shape_key)
        elif slot_key != self._stack_key[1]:
            old = self._stack_key[1]
            for slot, k in enumerate(slot_key):
                if k != old[slot]:
                    self._update_slot(store, slot, *shape_key)
        self._stack_key = (shape_key, slot_key)
        return self._stack

    def _slot_arrays(self, store, slot: int, cap, t_pad, h_pad, r, e):
        """One slot's host-side rows for every stacked table."""
        x = np.full((h_pad + 1, store.d), _PAD_VALUE, np.float32)
        adj = np.full((h_pad + 1, r), h_pad, np.int32)
        ids = np.full((h_pad + 1,), cap, np.int32)
        ent = np.full((e,), h_pad, np.int32)
        mask = np.zeros((h_pad + 1,), bool)
        name = self._slots[slot] if slot < len(self._slots) else None
        t = self._tenants.get(name) if name is not None else None
        if t is not None and t.hot is not None:
            h = t.hot.size
            x[:h] = store.x[t.hot.ids]
            a = np.asarray(t.hot.graph.adj)
            # hot graphs use the build-once convention (sentinel = H);
            # re-aim free slots at the stacked sentinel H_pad
            adj[:h, :a.shape[1]] = np.where((a < 0) | (a >= h), h_pad, a)
            ids[:h] = t.hot.ids
            ent[:t.hot.graph.entries.shape[0]] = t.hot.graph.entries
            mask[:h] = True
        return x, adj, ids, ent, mask

    def _build_stack(self, store, cap, t_pad, h_pad, r, e
                     ) -> StackedHotTables:
        xs = np.empty((t_pad, h_pad + 1, store.d), np.float32)
        adjs = np.empty((t_pad, h_pad + 1, r), np.int32)
        ids = np.empty((t_pad, h_pad + 1), np.int32)
        ents = np.empty((t_pad, e), np.int32)
        mask = np.empty((t_pad, h_pad + 1), bool)
        for slot in range(t_pad):
            (xs[slot], adjs[slot], ids[slot], ents[slot],
             mask[slot]) = self._slot_arrays(store, slot, cap, t_pad,
                                             h_pad, r, e)
        t = lambda a: torch.as_tensor(a, device=self.device)
        return StackedHotTables(x=t(xs), adj=t(adjs), ids=t(ids),
                                entries=t(ents), mask=t(mask))

    def _update_slot(self, store, slot, cap, t_pad, h_pad, r, e) -> None:
        arrays = self._slot_arrays(store, slot, cap, t_pad, h_pad, r, e)
        for table, a in zip(self._stack, arrays):
            table[slot] = torch.as_tensor(a, device=self.device)
