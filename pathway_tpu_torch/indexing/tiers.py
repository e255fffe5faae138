"""Three-tier storage hierarchy for the incremental IVF-PQ index.

`IvfPqIndex` (ann.py) keeps every routing list's PQ code block in host
RAM and mirrors the whole cube to the device. That caps corpus size by
memory. This module adds per-list tier placement on top of the SAME
generation structure (docs/retrieval.md §tier lifecycle):

* **hot** — the list's code block is in host RAM *and* a member of the
  device-resident hot sub-cube (sharded per the PR 13 list-sharding
  when a mesh is attached);
* **warm** — code block in host RAM only; probes scan it with the
  numpy mirror;
* **cold** — the code block is sealed to disk as a record in a
  crc-framed immutable run behind the persistence root, reusing the
  spill tier's run/manifest/fence/bloom machinery (`engine/spill.py`)
  verbatim: a cold probe takes the identical
  fence -> bloom -> one-windowed-read ladder (`SpillStore.peek`).

Only the PQ **code blocks** migrate (cap*m bytes per list — the bulk
of the routing structure). The per-list valid/slot maps and the slab's
f32 rescore rows stay host-resident and authoritative: a tombstone on
a cold list flips RAM state only, so runs stay immutable and the
retract path never touches disk.

**Invariants** (taught to the plan verifier as the
``index-tier-contract``, the ninth contract):

* *one tier per doc* — a list's code block is live in exactly one
  place: the RAM cube (hot/warm) or exactly one run's live set (cold),
  never both, never two runs; and a doc (slot) occupies exactly one
  cell of exactly one list.
* *no lost inserts* — appends that route to a cold list promote it
  first (take + unpack under the generation lock), so a row always
  lands in a RAM-resident list inside its own probe footprint; the
  demotion that re-colds it seals the block *with* the new row.

Placement is adaptive: every probe bumps per-list access counters
(decayed geometrically each rebalance), and `TierState.plan` ranks
lists by access to fit the hot/ram budgets. `IvfPqIndex` applies the
plan under the existing generation lock — from a lockgraph-registered
background daemon or synchronously via ``rebalance_tiers_now()``.

Kill switch: ``PATHWAY_ANN_TIERED=0`` vetoes tiering entirely — every
configured index stays all-resident and byte-identical to the untieered
IVF-PQ path (the ``ann-tiered-off`` CI leg); ``=1`` opts indexes in
with auto budgets.
"""

from __future__ import annotations

import os
import struct
from typing import TYPE_CHECKING, Iterable

import numpy as np

from pathway_tpu_torch.engine import spill as _spill

if TYPE_CHECKING:  # pragma: no cover
    from pathway_tpu_torch.indexing.ann import IvfPqIndex, _Generation

TIER_HOT = 0
TIER_WARM = 1
TIER_COLD = 2
TIER_NAMES = ("hot", "warm", "cold")

_PACK_MAGIC = b"PWTL"  # per-list payload header: magic, cap, m


def tiered_enabled(default: bool = False) -> bool:
    """The PATHWAY_ANN_TIERED kill switch, same discipline as
    ``ann_enabled``: `default` is what the call site wants when the env
    var is unset (an index constructed with tier budgets passes True —
    env can only veto; a budget-less index passes False — env can opt
    it in with auto budgets)."""
    v = os.environ.get("PATHWAY_ANN_TIERED")
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "")


def list_key(version: int, lst: int) -> bytes:
    """Run key for one list's code block: generation-scoped so a swap
    can never resurrect a stale block under a new generation."""
    return b"g%d/l%d" % (version, lst)


def pack_codes(block: np.ndarray) -> bytes:
    """[cap, m] uint8 code block -> run payload (shape header + raw)."""
    cap, m = block.shape
    return _PACK_MAGIC + struct.pack("<II", cap, m) + block.tobytes()


def unpack_codes(payload: bytes, cap: int, m: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`. The sealed cap may be SMALLER
    than the current one (the cube grew while the list was cold — its
    tail cells are guaranteed empty, appends promote first); a LARGER
    sealed cap or an m mismatch is damage and raises RuntimeError like
    any torn spill segment."""
    if payload[:4] != _PACK_MAGIC:
        raise RuntimeError("tier payload: bad magic")
    pcap, pm = struct.unpack("<II", payload[4:12])
    if pm != m or pcap > cap:
        raise RuntimeError(
            f"tier payload: sealed shape ({pcap}, {pm}) does not fit the "
            f"current generation cell shape ({cap}, {m})"
        )
    block = np.frombuffer(payload[12:], np.uint8).reshape(pcap, pm)
    if pcap == cap:
        return block.copy()
    out = np.zeros((cap, m), np.uint8)
    out[:pcap] = block
    return out


def auto_budgets(n_lists: int) -> tuple[int, int]:
    """Budgets when PATHWAY_ANN_TIERED=1 opts an index in without
    explicit configuration: a quarter of the lists device-hot, half
    RAM-resident overall."""
    hot = max(1, n_lists // 4)
    ram = max(hot, n_lists // 2)
    return hot, ram


class TierState:
    """Per-generation tier placement for one IvfPqIndex.

    Owned by the index; every mutation happens under the index's
    generation lock (the same lock that makes retrain swaps atomic), so
    tier moves can never interleave with a probe's cube read."""

    def __init__(
        self,
        n_lists: int,
        version: int,
        hot_budget: int | None,
        ram_budget: int | None,
        store: _spill.SpillStore,
    ):
        self.n_lists = n_lists
        self.version = version
        self.hot_budget = (
            n_lists if hot_budget is None else max(1, min(hot_budget, n_lists))
        )
        self.ram_budget = (
            n_lists
            if ram_budget is None
            else max(self.hot_budget, min(ram_budget, n_lists))
        )
        self.store = store
        # everything starts RAM-resident (a fresh generation is packed
        # from the slab in RAM); the first rebalance demotes the tail
        self.tier = np.full(n_lists, TIER_WARM, np.int8)
        self.tier[: self.hot_budget] = TIER_HOT
        self.accesses = np.zeros(n_lists, np.float64)
        self.promotions = 0
        self.demotions = 0

    # ------------------------------------------------------------ accounting

    def record_access(self, lists: Iterable[int]) -> None:
        for lst in lists:
            self.accesses[lst] += 1.0

    def cold_lists(self) -> np.ndarray:
        return np.flatnonzero(self.tier == TIER_COLD)

    def resident_list_keys(self) -> list[bytes]:
        """Keys of every RAM-resident list — the 'tail' of the two-tier
        proof (`spill.check_two_tier`): none of these may be live in a
        sealed run."""
        return [
            list_key(self.version, int(lst))
            for lst in np.flatnonzero(self.tier != TIER_COLD)
        ]

    # ---------------------------------------------------------------- policy

    def plan(self, fill: np.ndarray) -> tuple[list[int], list[int], list[int]]:
        """Rank lists by decayed access count (ties: bigger list first,
        then list id — deterministic) and fit the budgets. Returns
        (to_hot, to_warm, to_cold) as MOVES relative to the current
        placement; empty lists never demote to cold (nothing to seal).
        """
        order = np.lexsort(
            (np.arange(self.n_lists), -fill, -self.accesses)
        )
        want = np.full(self.n_lists, TIER_COLD, np.int8)
        want[order[: self.hot_budget]] = TIER_HOT
        want[order[self.hot_budget : self.ram_budget]] = TIER_WARM
        to_hot = [
            int(lst)
            for lst in np.flatnonzero((want == TIER_HOT) & (self.tier != TIER_HOT))
        ]
        to_warm = [
            int(lst)
            for lst in np.flatnonzero(
                (want == TIER_WARM) & (self.tier != TIER_WARM)
            )
        ]
        to_cold = [
            int(lst)
            for lst in np.flatnonzero(
                (want == TIER_COLD) & (self.tier != TIER_COLD) & (fill > 0)
            )
        ]
        return to_hot, to_warm, to_cold

    def decay(self, factor: float = 0.5) -> None:
        self.accesses *= factor


# ------------------------------------------------------------- verification


def verify_tier_state(index: "IvfPqIndex", owner: str = "") -> None:
    """The ``index-tier-contract``: prove a tiered index's invariants
    from its manifest and the bytes on disk, independent of the code
    that migrates lists. Raises :class:`PlanVerificationError` with a
    named finding on any violation:

    * manifest redundancy (a run dropped from the listing);
    * exclusive residency — a list's code block live in two runs, or in
      a run AND the RAM cube (a doc in two tiers);
    * every cold list's block recoverable from exactly one live run
      (a dropped run would silently lose its docs);
    * every live doc (slot) in exactly one cell of exactly one list.
    """
    from pathway_tpu_torch.internals.verifier import PlanVerificationError

    who = owner or index.name
    with index._gen_lock:
        gen = index._gen
        ts = index._tiers
        if gen is None or ts is None:
            return

        def bad(msg: str) -> None:
            raise PlanVerificationError([f"index-tier [{who}]: {msg}"])

        # ---- doc-level: each slot in exactly one (list, cell)
        live_slots = gen.slots[gen.valid]
        uniq, counts = np.unique(live_slots, return_counts=True)
        dup = uniq[counts > 1]
        if dup.size:
            bad(
                f"doc slot {int(dup[0])} occupies {int(counts[counts > 1][0])} "
                "cells — a doc must live in exactly one tier"
            )
        # ---- manifest redundancy (dropped run -> named refusal)
        _spill.verify_manifest(ts.store.manifest(), f"index-tier:{who}")
        # ---- exclusive residency proved from bytes on disk: runs
        # pairwise disjoint, and no RAM-resident list live in any run
        ts.store.tail_keys = ts.resident_list_keys
        _spill.check_two_tier(ts.store, f"index-tier:{who}")
        # ---- every cold list recoverable from a live run record
        live_keys: set[bytes] = set()
        for run in list(ts.store.runs):
            for _off, _hb, kb, _payload in ts.store._read_run(run):
                if kb not in run.dead:
                    live_keys.add(kb)
        for lst in ts.cold_lists():
            if gen.fill[lst] == 0:
                continue
            if list_key(ts.version, int(lst)) not in live_keys:
                bad(
                    f"cold list {int(lst)} has no live run record — its "
                    "docs are unreachable (dropped run?)"
                )
            if np.any(gen.cube[lst]):
                bad(
                    f"cold list {int(lst)} still has codes in the RAM "
                    "cube — a doc lives in two tiers"
                )


def check_index_tier(session, v, shared) -> None:
    """Verifier driver half of the contract (internals/verifier.py
    keeps the registration; logic lives here next to the machinery it
    audits). Walks the engine graph for external-index nodes exposing
    tiered host indexes."""
    from pathway_tpu_torch.internals.verifier import PlanVerificationError

    check = "index-tier-contract"
    v.start(check)
    n = 0
    for node in session.graph.nodes:
        getter = getattr(node, "index_tiers", None)
        if getter is None:
            continue
        for idx in getter():
            n += 1
            try:
                verify_tier_state(idx, f"{node.describe()}:{idx.name}")
            except PlanVerificationError as e:
                v.violation(check, str(e.findings[0] if e.findings else e))
    v.report["checks"][check]["indexes"] = n
