"""Out-of-core operator state: LSM-spilled arrangements.

Join/groupby arrangements are memory-resident; this module gives them a
spill tier so state can outgrow RAM without falling off a performance
cliff (ROADMAP item 2; the blueprint is differential-dataflow's
`arrange` + trace compaction — immutable sorted batches merged in the
background, i.e. an LSM).

Residency is EXCLUSIVE: a group (join key / group token) lives either
in the operator's in-memory tail or in exactly one on-disk run's live
set, never both. Past the resident budget the owner seals its coldest
groups — full consolidated group state, rows in insertion order — into
a sorted immutable run segment under the persistence root (crc-framed
codec records, atomic temp/fsync/rename). Any later touch promotes the
group back: a probe ladder (per-run min/max hash fence, then bloom
filter, then at most one windowed disk read per surviving run, newest
run first) finds the payload, the key is marked dead in its run, and
the owner re-inserts the rows into the tail in their original insertion
order — which is exactly the order the arrangement would have emitted
them, so spilling is byte-invisible to the dataflow.

A background compaction thread merges runs tiered-style with tombstone
GC, gated off the wave path: snapshot → merge outside the generation
lock → atomic generation swap under it, with mid-merge promotions
replayed into the merged run's dead set (the no-lost-inserts rule).
`faults.crash("state.compaction.mid_merge")` sits between merge output
and swap — the chaos drill's crash window.

Checkpoints shrink to (run manifest + tail): the manifest names every
run with redundant integrity fields (n_runs / total_records) so a run
missing from a tampered manifest is a detectable redundancy mismatch
(PlanVerificationError, by name, before data flows), while file-level
damage — a torn run tail, a listed-but-missing segment — raises
RuntimeError and rides the persistence layer's one-epoch fallback.

Gates: ``PATHWAY_SPILL`` (0 bypasses byte-identically),
``PATHWAY_SPILL_BUDGET`` (resident groups/rows per arrangement),
``PATHWAY_SPILL_COMPACT`` (run count that triggers compaction).
Metrics: ``pathway_spill_{runs,bytes,probe_tier,compactions,
merge_seconds}`` (docs/observability.md).
"""

from __future__ import annotations

import atexit
import bisect
import hashlib
import os
import shutil
import tempfile
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Iterable

import numpy as np

from pathway_tpu_torch.analysis import lockgraph as _lockgraph
from pathway_tpu_torch.engine import faults as _faults
from pathway_tpu_torch.engine.native import dataplane as _dp
from pathway_tpu_torch.persistence import codec as _codec

__all__ = [
    "enabled",
    "default_budget",
    "compact_trigger",
    "set_root",
    "root",
    "store_for",
    "attach_store",
    "stores",
    "collect_garbage",
    "publish_metrics",
    "key_hash",
    "verify_manifest",
    "validate_manifest_files",
    "check_two_tier",
    "is_manifest",
    "merge_manifests",
    "split_manifest",
    "relocate_manifest",
    "SpillStore",
    "MANIFEST_MARK",
]

MANIFEST_MARK = "__spill_manifest__"

_SPARSE_EVERY = 64        # sparse-index granularity (records per block)
_BLOOM_BITS_PER_KEY = 16  # with k=8 -> ~0.06% false-positive rate
_BLOOM_K = 8
_EVICT_LOW_WATER = 0.75   # hysteresis: evict down to this share of budget
_GC_SURVIVE = 2           # checkpoints an obsolete run outlives (epoch
                          # retention + metadata history fallback)


# ------------------------------------------------------------------ config


def enabled() -> bool:
    return os.environ.get("PATHWAY_SPILL", "1") != "0"


def default_budget() -> int:
    return int(os.environ.get("PATHWAY_SPILL_BUDGET", "1000000"))


def compact_trigger() -> int:
    return int(os.environ.get("PATHWAY_SPILL_COMPACT", "8"))


_ROOT: str | None = None
_PERSISTENT = False
_ROOT_LOCK = threading.Lock()
_TMP_ROOTS: list[str] = []


def set_root(path: str, persistent: bool = True) -> None:
    """Pin the spill root under a persistence root (attach_persistence
    calls this before restore so manifests resolve their run files)."""
    global _ROOT, _PERSISTENT
    with _ROOT_LOCK:
        _ROOT = os.path.join(path, "spill")
        _PERSISTENT = persistent
        os.makedirs(_ROOT, exist_ok=True)


def root() -> tuple[str, bool]:
    """(spill root dir, persistent?) — tempdir fallback for runs without
    persistence (runs are then scratch, removed at exit)."""
    global _ROOT
    with _ROOT_LOCK:
        if _ROOT is None:
            _ROOT = tempfile.mkdtemp(prefix="pathway-spill-")
            _TMP_ROOTS.append(_ROOT)
        return _ROOT, _PERSISTENT


@atexit.register
def _cleanup_tmp_roots() -> None:
    for d in _TMP_ROOTS:
        shutil.rmtree(d, ignore_errors=True)


def key_hash(kb: bytes) -> int:
    """Stable u64 routing hash of a group's canonical key bytes."""
    return int.from_bytes(hashlib.blake2b(kb, digest_size=8).digest(), "big")


def _metrics():
    from pathway_tpu_torch.internals import observability as _obs

    plane = _obs.PLANE
    return plane.metrics if plane is not None else None


def _fsync_write(path: str, data: bytes) -> None:
    # same atomic temp/fsync/rename discipline as persistence._fsync_write
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _parse_frames(buf: bytes, base: int):
    """Yield (abs_offset, payload) per crc frame; RuntimeError on damage."""
    hdr = _codec._HEADER
    pos, n = 0, len(buf)
    while pos + hdr.size <= n:
        length, crc = hdr.unpack_from(buf, pos)
        start = pos + hdr.size
        end = start + length
        if end > n or zlib.crc32(buf[start:end]) != crc:
            raise RuntimeError("torn spill run frame")
        yield base + pos, buf[start:end]
        pos = end
    if pos != n:
        raise RuntimeError("torn spill run tail")


class _Run:
    """One sealed immutable segment: sorted (hash, key, payload) records
    plus the resident probe summaries (fences, bloom, sparse index) and
    the dead set (keys promoted back to the tail since sealing)."""

    __slots__ = (
        "path", "file", "n", "nbytes", "hmin", "hmax", "bloom", "m_bits",
        "k", "dead", "seq", "dir", "shared", "_index",
    )


class SpillStore:
    """LSM spill tier for one arrangement (one node attribute)."""

    def __init__(
        self, label: str, directory: str, persistent: bool,
        budget: int | None = None,
    ) -> None:
        self.label = label
        self.dir = directory
        self.persistent = persistent
        self.budget = budget if budget is not None else default_budget()
        self.base_budget = self.budget
        self.runs: list[_Run] = []  # oldest .. newest
        self.seq = 0
        # owner-provided: iterable of the tail's canonical key bytes,
        # for the verifier's exclusive-residency proof
        self.tail_keys: Callable[[], Iterable[bytes]] | None = None
        self._gen_lock = _lockgraph.register_lock(
            "spill.generation", threading.Lock()
        )
        self._compact_lock = _lockgraph.register_lock(
            "spill.compaction", threading.Lock()
        )
        self._garbage: list[list] = []  # [path, collects survived]
        self._compact_event = threading.Event()
        self._compactor: threading.Thread | None = None
        self._closed = False
        self.promotions = 0
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------- state

    @property
    def has_runs(self) -> bool:
        return bool(self.runs)

    @property
    def run_count(self) -> int:
        return len(self.runs)

    @property
    def bytes_total(self) -> int:
        with self._gen_lock:
            return sum(r.nbytes for r in self.runs)

    # -------------------------------------------------------------- seal

    def seal(self, items: Iterable[tuple[bytes, bytes]]) -> int:
        """Seal (key_bytes, payload_bytes) pairs into one sorted run."""
        recs = sorted(
            ((key_hash(kb), kb, payload) for kb, payload in items),
            key=lambda r: (r[0], r[1]),
        )
        if not recs:
            return 0
        run = self._write_run(recs)
        with self._gen_lock:
            # the run's seq and its place in `runs` are taken in one
            # critical section: a compaction that cut its snapshot while
            # this file was being written swaps its merged run in BEFORE
            # this one, under a lower seq (see compact_once)
            self.seq += 1
            run.seq = self.seq
            self.runs.append(run)
        self._publish()
        self._maybe_compact_async()
        return len(recs)

    def _write_run(self, recs: list[tuple[int, bytes, bytes]]) -> _Run:
        """Write one sorted run file and its probe summaries. The file is
        named from a fresh draw of the counter, so no two files collide;
        the caller gives the run its seq when it enters `runs`."""
        with self._gen_lock:
            self.seq += 1
            name_no = self.seq
        out = bytearray(_codec.MAGIC)
        index_h: list[int] = []
        index_off: list[int] = []
        for i, (h, kb, payload) in enumerate(recs):
            if i % _SPARSE_EVERY == 0:
                index_h.append(h)
                index_off.append(len(out))
            out += _codec.frame(
                _codec.encode_value((h.to_bytes(8, "big"), kb, payload))
            )
        name = f"run-{name_no:08d}.seg"
        path = os.path.join(self.dir, name)
        _fsync_write(path, bytes(out))
        run = _Run()
        run.path, run.file = path, name
        run.n, run.nbytes = len(recs), len(out)
        run.hmin, run.hmax = recs[0][0], recs[-1][0]
        run.m_bits = 1 << max(
            10, (len(recs) * _BLOOM_BITS_PER_KEY - 1).bit_length()
        )
        run.k = _BLOOM_K
        run.bloom = _dp.bloom_build(
            np.asarray([r[0] for r in recs], np.uint64), run.m_bits, run.k
        )
        run.dead = set()
        run.seq = -1  # set where the run enters `runs`
        run.dir = None
        run.shared = False
        run._index = (index_h, index_off, len(out))
        return run

    # ------------------------------------------------------------- probe

    def take(self, kb: bytes) -> bytes | None:
        """Promote: probe the ladder newest-run-first; on a hit, mark the
        key dead in its run and return the payload (the caller re-inserts
        it into the tail — exclusive residency)."""
        return self._probe(kb, promote=True)

    def peek(self, kb: bytes) -> bytes | None:
        """Read without promoting: the same fence -> bloom -> one
        windowed read ladder as :meth:`take`, but the key stays live in
        its run and the promotion counter is untouched. For callers
        whose read buffer is NOT a tier (the tiered ANN index probes
        cold lists through here — the decoded block is transient, so
        marking the run record dead would orphan the only copy)."""
        return self._probe(kb, promote=False)

    def _probe(self, kb: bytes, promote: bool) -> bytes | None:
        """The ladder over a snapshot of the run list. A compaction may
        swap the list while a probe walks it: a run it retired can lose
        its file (scratch roots unlink at once), and a promotion marked
        dead in it would not reach the merged run that now holds the key.
        So a probe that finds its run retired starts again on the current
        list, and a promotion marks the key dead only while its run is
        still in the list, under the same lock as the swap."""
        if not self.runs:
            return None
        h = key_hash(kb)
        m = _metrics()
        while True:
            with self._gen_lock:
                runs = tuple(self.runs)
            retired = False
            for run in reversed(runs):
                if kb in run.dead:
                    continue
                if h < run.hmin or h > run.hmax:
                    if m:
                        m.counter(
                            "pathway_spill_probe_tier", {"tier": "fence"},
                            help="spill probe outcomes by ladder tier",
                        )
                    continue
                if not _dp.bloom_check(run.bloom, run.m_bits, run.k, h):
                    if m:
                        m.counter("pathway_spill_probe_tier", {"tier": "bloom"})
                    continue
                try:
                    payload = self._lookup(run, h, kb)
                except FileNotFoundError:
                    with self._gen_lock:
                        retired = not any(r is run for r in self.runs)
                    if not retired:
                        raise
                    break
                if payload is None:
                    if m:
                        m.counter("pathway_spill_probe_tier", {"tier": "run_false"})
                    continue
                if promote:
                    with self._gen_lock:
                        retired = not any(r is run for r in self.runs)
                        if not retired:
                            run.dead.add(kb)
                    if retired:
                        break
                    self.promotions += 1
                if m:
                    m.counter("pathway_spill_probe_tier", {"tier": "run_hit"})
                return payload
            if not retired:
                break
        if m:
            m.counter("pathway_spill_probe_tier", {"tier": "miss"})
        return None

    def _lookup(self, run: _Run, h: int, kb: bytes) -> bytes | None:
        """One windowed disk read: the sparse-index block(s) that can
        hold hash h, scanned in memory."""
        index_h, index_off, end = self._index_of(run)
        lo_i = max(bisect.bisect_left(index_h, h) - 1, 0)
        hi_i = bisect.bisect_right(index_h, h)
        lo = index_off[lo_i]
        hi = index_off[hi_i] if hi_i < len(index_off) else end
        if lo >= hi:
            return None
        with open(run.path, "rb") as f:
            f.seek(lo)
            buf = f.read(hi - lo)
        hb = h.to_bytes(8, "big")
        for _, rec in _parse_frames(buf, lo):
            rhb, rkb, payload = _codec.decode_value(rec)
            if rhb == hb and rkb == kb:
                return payload
            if rhb > hb:
                break
        return None

    def _index_of(self, run: _Run):
        if run._index is None:  # restored run: build from one full read
            recs = self._read_run(run)
            index_h = [int.from_bytes(r[1], "big") for r in recs[::_SPARSE_EVERY]]
            index_off = [r[0] for r in recs[::_SPARSE_EVERY]]
            run._index = (index_h, index_off, run.nbytes)
        return run._index

    def _read_run(self, run: _Run) -> list[tuple[int, bytes, bytes, bytes]]:
        """Full sequential read: [(offset, hash_bytes, key, payload)].
        RuntimeError on any damage (size, magic, crc, count)."""
        with open(run.path, "rb") as f:
            buf = f.read()
        if len(buf) != run.nbytes:
            raise RuntimeError(
                f"spill run {run.file}: torn segment "
                f"({len(buf)} bytes on disk, sealed as {run.nbytes})"
            )
        if not buf.startswith(_codec.MAGIC):
            raise RuntimeError(f"spill run {run.file}: bad magic")
        recs = []
        for off, rec in _parse_frames(buf[len(_codec.MAGIC):], len(_codec.MAGIC)):
            hb, kb, payload = _codec.decode_value(rec)
            recs.append((off, hb, kb, payload))
        if len(recs) != run.n:
            raise RuntimeError(
                f"spill run {run.file}: record count mismatch "
                f"({len(recs)} read, sealed as {run.n})"
            )
        return recs

    # -------------------------------------------------------- compaction

    def _maybe_compact_async(self) -> None:
        trig = compact_trigger()
        if trig <= 0 or len(self.runs) < trig:
            return
        if self._compactor is None:
            self._compactor = threading.Thread(
                target=self._compact_loop,
                name=f"spill-compact-{self.label}",
                daemon=True,
            )
            self._compactor.start()
        self._compact_event.set()

    def _compact_loop(self) -> None:
        while not self._closed:
            self._compact_event.wait(timeout=0.5)
            self._compact_event.clear()
            try:
                while (
                    not self._closed
                    and compact_trigger() > 0
                    and len(self.runs) >= compact_trigger()
                ):
                    if not self.compact_once():
                        break
            except Exception:  # noqa: BLE001
                # compaction is an optimization: a failed merge leaves
                # the pre-merge generation authoritative
                break

    def compact_once(self) -> bool:
        """Merge all current *private* runs into one, dropping dead keys,
        then swap the generation atomically. Mutations that landed
        mid-merge (promotions into the snapshot runs, newly sealed runs)
        are replayed into / kept after the merged run — no lost inserts.

        Runs inherited from a manifest split (``shared``) are excluded:
        they may hold live records for keys a *sibling* shard owns, so
        folding them into a private run would resurrect state a sibling
        has since promoted. Shared runs stay pinned until a future merge
        re-unifies ownership (merge_manifests marks runs private again
        when one store becomes the sole owner)."""
        with self._compact_lock:
            with self._gen_lock:
                snap = [r for r in self.runs if not r.shared]
                if len(snap) < 2:
                    return False
                snap_ids = {id(r) for r in snap}
                dead0 = [set(r.dead) for r in snap]
            t0 = time.monotonic()
            merged: dict[bytes, bytes] = {}
            seen: set[bytes] = set()
            for run, dead in zip(reversed(snap), reversed(dead0)):
                for _, _hb, kb, payload in self._read_run(run):
                    if kb in seen:
                        continue  # shadowed by a newer run
                    seen.add(kb)
                    if kb in dead:
                        continue  # tombstone GC: promoted to the tail
                    merged[kb] = payload
            new_run = None
            if merged:
                recs = sorted(
                    ((key_hash(kb), kb, p) for kb, p in merged.items()),
                    key=lambda r: (r[0], r[1]),
                )
                new_run = self._write_run(recs)
            # the chaos drill's crash window: merged output durable,
            # generation swap not yet taken — recovery must come back
            # byte-identical from the pre-merge manifest
            _faults.crash("state.compaction.mid_merge")
            with self._gen_lock:
                shared = [r for r in self.runs if r.shared]
                tail = [  # sealed while merging
                    r for r in self.runs
                    if not r.shared and id(r) not in snap_ids
                ]
                if new_run is not None:
                    # the merged run takes the newest snapshot run's seq:
                    # every run sealed after the snapshot was cut entered
                    # `runs` later, under a higher seq, and stays after it
                    new_run.seq = max(r.seq for r in snap)
                    for run, d0 in zip(snap, dead0):
                        # replayed mid-merge promotions: those keys left
                        # for the tail after the snapshot was cut
                        for kb in run.dead - d0:
                            new_run.dead.add(kb)
                    self.runs = shared + [new_run] + tail
                else:
                    self.runs = shared + tail
            self._retire(snap)
            m = _metrics()
            if m:
                m.counter(
                    "pathway_spill_compactions", {"store": self.label},
                    help="background run merges completed",
                )
                m.observe(
                    "pathway_spill_merge_seconds", time.monotonic() - t0,
                    help="wall seconds per spill compaction merge",
                )
            self._publish()
            return True

    def _retire(self, runs: list[_Run]) -> None:
        """Obsolete a merged-away generation. Persistent roots defer the
        unlink (the last durable checkpoints' manifests may still list
        these files); scratch roots unlink immediately."""
        with self._gen_lock:
            if self.persistent:
                for r in runs:
                    self._garbage.append([r.path, 0])
            else:
                for r in runs:
                    try:
                        os.unlink(r.path)
                    except FileNotFoundError:
                        pass

    def collect_garbage(self) -> int:
        """One checkpoint tick: unlink retired runs that have outlived
        every manifest that could still name them."""
        removed = 0
        with self._gen_lock:
            keep = []
            for ent in self._garbage:
                ent[1] += 1
                if ent[1] >= _GC_SURVIVE:
                    try:
                        os.unlink(ent[0])
                    except FileNotFoundError:
                        pass
                    removed += 1
                else:
                    keep.append(ent)
            self._garbage = keep
        return removed

    def gc_orphans(self) -> int:
        """Remove run files no generation references (half-merged output
        of a mid-compaction crash, runs sealed after the last durable
        checkpoint). Only safe AFTER the attached manifest verified, and
        only for a store whose runs are all private: with shared runs in
        play a file in this directory may be live in a *sibling* shard's
        manifest that this store cannot see."""
        with self._gen_lock:
            if any(r.shared for r in self.runs):
                return 0
            keep = {r.file for r in self.runs}
            keep |= {os.path.basename(p) for p, _ in self._garbage}
        removed = 0
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return 0
        for fn in names:
            if fn.startswith("run-") and fn not in keep:
                try:
                    os.unlink(os.path.join(self.dir, fn))
                    removed += 1
                except FileNotFoundError:
                    pass
        return removed

    # --------------------------------------------------------- manifests

    def manifest(self) -> dict:
        """Checkpoint view: (run list + integrity redundancy). The tail
        itself snapshots through the owner's normal persist path."""
        with self._gen_lock:
            runs = [
                {
                    "file": r.file,
                    "n": r.n,
                    "bytes": r.nbytes,
                    "hmin": r.hmin.to_bytes(8, "big"),
                    "hmax": r.hmax.to_bytes(8, "big"),
                    "m_bits": r.m_bits,
                    "k": r.k,
                    "bloom": r.bloom.tobytes(),
                    "seq": r.seq,
                    "dead": sorted(r.dead),
                    "dir": r.dir or "",
                    "shared": int(r.shared),
                }
                for r in self.runs
            ]
            seq = self.seq
        return {
            MANIFEST_MARK: 1,
            "label": self.label,
            "dir": os.path.basename(self.dir),
            "seq": seq,
            "n_runs": len(runs),
            "total_records": sum(r["n"] for r in runs),
            "runs": runs,
        }

    def _publish(self) -> None:
        m = _metrics()
        if m is None:
            return
        with self._gen_lock:
            n = len(self.runs)
            b = sum(r.nbytes for r in self.runs)
        m.gauge(
            "pathway_spill_runs", n, {"store": self.label},
            help="sealed spill runs resident on disk",
        )
        m.gauge(
            "pathway_spill_bytes", b, {"store": self.label},
            help="bytes across sealed spill runs",
        )

    def close(self) -> None:
        self._closed = True
        self._compact_event.set()


# ---------------------------------------------------------------- registry


_STORES: "weakref.WeakSet[SpillStore]" = weakref.WeakSet()


def store_for(label: str, budget: int | None = None) -> SpillStore:
    """Fresh (empty) store for one arrangement; wipes leftover run files
    of a previous incarnation under the same label — a fresh store's
    authoritative state is empty, anything on disk is orphaned."""
    base, persistent = root()
    d = os.path.join(base, label)
    if os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)
    store = SpillStore(label, d, persistent, budget=budget)
    _STORES.add(store)
    return store


def attach_store(manifest: dict, budget: int | None = None) -> SpillStore:
    """Rebuild a store from a checkpoint manifest (restore path): verify
    the manifest semantically (PlanVerificationError on tampering),
    re-register every run's resident summaries, validate the files, then
    GC orphans the manifest does not name."""
    verify_manifest(manifest)
    base, persistent = root()
    d = os.path.join(base, str(manifest["dir"]))
    store = SpillStore(
        str(manifest["label"]), d, persistent, budget=budget
    )
    store.seq = int(manifest["seq"])
    runs = []
    for rm in manifest["runs"]:
        run = _Run()
        run.file = str(rm["file"])
        # post-rescale manifests carry per-run directories: a split
        # shard's inherited runs stay in the directory that sealed them
        run.dir = str(rm.get("dir") or "") or None
        run.shared = bool(rm.get("shared", 0))
        run.path = os.path.join(base, run.dir, run.file) if run.dir \
            else os.path.join(d, run.file)
        run.n = int(rm["n"])
        run.nbytes = int(rm["bytes"])
        run.hmin = int.from_bytes(rm["hmin"], "big")
        run.hmax = int.from_bytes(rm["hmax"], "big")
        run.m_bits = int(rm["m_bits"])
        run.k = int(rm["k"])
        run.bloom = np.frombuffer(rm["bloom"], np.uint8).copy()
        run.dead = set(rm["dead"])
        run.seq = int(rm["seq"])
        run._index = None
        runs.append(run)
    store.runs = runs
    validate_manifest_files(manifest)
    store.gc_orphans()
    _STORES.add(store)
    return store


def stores() -> list[SpillStore]:
    return list(_STORES)


def collect_garbage() -> int:
    return sum(s.collect_garbage() for s in stores())


def publish_metrics() -> None:
    for s in stores():
        s._publish()


# ------------------------------------------------------------ verification


def is_manifest(v: Any) -> bool:
    return isinstance(v, dict) and v.get(MANIFEST_MARK) == 1


def verify_manifest(manifest: dict, owner: str = "") -> None:
    """Semantic (tamper) checks, independent of the store that wrote the
    manifest: marker, run-list redundancy (n_runs / total_records — a
    run dropped from the list is a detectable mismatch), seq ordering.
    Raises PlanVerificationError by name; file damage is NOT checked
    here (that is validate_manifest_files / one-epoch fallback)."""
    from pathway_tpu_torch.internals.verifier import PlanVerificationError

    who = owner or str(manifest.get("label", "?"))

    def bad(msg: str) -> None:
        raise PlanVerificationError([f"spill-manifest [{who}]: {msg}"])

    if manifest.get(MANIFEST_MARK) != 1:
        bad("missing manifest marker")
    runs = manifest.get("runs")
    if not isinstance(runs, list):
        bad("run list missing")
    if int(manifest.get("n_runs", -1)) != len(runs):
        bad(
            f"manifest claims {manifest.get('n_runs')} runs but lists "
            f"{len(runs)} — a run is missing from the manifest"
        )
    total = sum(int(r.get("n", 0)) for r in runs)
    if int(manifest.get("total_records", -1)) != total:
        bad(
            f"manifest claims {manifest.get('total_records')} records but "
            f"runs sum to {total} — a run is missing from the manifest"
        )
    seqs = [int(r.get("seq", -1)) for r in runs]
    if sorted(seqs) != seqs or len(set(seqs)) != len(seqs):
        bad("run sequence numbers out of order (newest-run-first broken)")
    for r in runs:
        dead = r.get("dead", [])
        if len(dead) > int(r.get("n", 0)):
            bad(f"run {r.get('file')}: more dead keys than records")


def validate_manifest_files(manifest: dict) -> None:
    """File-level validation (restore phase-1): every listed run exists,
    byte length matches the seal, every frame crc-parses, record count
    matches. RuntimeError on damage — the persistence ladder treats it
    like any unreadable snapshot (loud log + one-epoch fallback)."""
    base, _persistent = root()
    d = os.path.join(base, str(manifest.get("dir", "")))
    for rm in manifest.get("runs", []):
        rd = str(rm.get("dir") or "")
        path = os.path.join(base, rd, str(rm["file"])) if rd \
            else os.path.join(d, str(rm["file"]))
        if not os.path.exists(path):
            raise RuntimeError(
                f"spill run listed in the checkpoint manifest but missing "
                f"on disk: {rm['file']}"
            )
        size = os.path.getsize(path)
        if size != int(rm["bytes"]):
            raise RuntimeError(
                f"spill run {rm['file']}: torn segment "
                f"({size} bytes on disk, manifest says {rm['bytes']})"
            )
        with open(path, "rb") as f:
            buf = f.read()
        if _codec.valid_prefix_len(buf, with_magic=True) != len(buf):
            raise RuntimeError(f"spill run {rm['file']}: torn segment tail")
        if _codec.count_records(buf, with_magic=True) != int(rm["n"]):
            raise RuntimeError(
                f"spill run {rm['file']}: record count mismatch vs manifest"
            )


# ----------------------------------------------------------------- rescale
#
# Rescale of spilled state is a METADATA move, not a data move: run files
# are immutable and content-complete, so re-owning them only needs the
# manifests rewritten. Soundness rests on two facts: (a) exchange routing
# delivers a key only to its owning shard, so live records for unowned
# keys in a shared run are simply never probed; (b) only a key's owner
# ever promotes it (marks it dead), so merging sibling views of the same
# run file takes the union of their dead sets.


def merge_manifests(manifests: list[dict], label: str | None = None) -> dict:
    """Fold several shard manifests into one (n -> 1 of a rescale). Runs
    are deduplicated by (directory, file) — split siblings inherit the
    same physical files — with dead sets unioned, and come out private
    (``shared: 0``): the merged store is the sole owner again, so
    compaction and orphan GC reopen. Per-run directories keep pointing at
    the files' sealed locations; nothing is rewritten on disk."""
    runs: list[dict] = []
    seen: dict[tuple[str, str], dict] = {}
    max_orig_seq = 0
    for man in manifests:
        verify_manifest(man)
        # a merged run's file is named from a later draw of the counter
        # than its seq, so the floor takes the counter itself too
        max_orig_seq = max(max_orig_seq, int(man.get("seq", 0)))
        mdir = str(man.get("dir", ""))
        for rm in man["runs"]:
            max_orig_seq = max(max_orig_seq, int(rm.get("seq", 0)))
            rd = str(rm.get("dir") or "") or mdir
            key = (rd, str(rm["file"]))
            if key in seen:
                # the same file seen through two sibling shards: only a
                # key's owner promotes it, so the merged dead set is the
                # union of the siblings' views
                seen[key]["dead"] = sorted(
                    set(seen[key]["dead"]) | set(rm.get("dead", []))
                )
                continue
            rec = dict(rm)
            rec["dir"] = rd
            rec["shared"] = 0
            runs.append(rec)
            seen[key] = rec
    # renumber: manifest order preserves newest-wins within each source
    # shard, and cross-shard order is irrelevant (disjoint key ownership)
    for i, rec in enumerate(runs):
        rec["seq"] = i + 1
    lab = label or (str(manifests[0]["label"]) if manifests else "merged")
    dir0 = str(manifests[0]["dir"]) if manifests else lab
    return {
        MANIFEST_MARK: 1,
        "label": lab,
        "dir": dir0,
        # next-seal counter starts past every inherited seq: run FILES
        # keep their original names, so a renumber-only counter could
        # collide a fresh seal with an inherited file in the store dir
        "seq": max(len(runs), max_orig_seq),
        "n_runs": len(runs),
        "total_records": sum(int(r["n"]) for r in runs),
        "runs": runs,
    }


def split_manifest(
    manifest: dict, n: int, label: str | None = None
) -> list[dict]:
    """Split one manifest across ``n`` shards (1 -> n of a rescale) as
    pure metadata: every shard inherits the FULL run list as ``shared``
    runs — exchange routing guarantees a shard only ever probes the keys
    it owns, so unowned live records are dead weight, not wrong answers.
    Each shard gets a fresh private directory (deterministically derived
    from the manifest content) for the runs it seals afterwards."""
    verify_manifest(manifest)
    if n <= 1:
        return [merge_manifests([manifest], label=label)]
    lab = label or str(manifest["label"])
    mdir = str(manifest.get("dir", ""))
    ident = hashlib.blake2b(
        repr((
            int(manifest.get("seq", 0)),
            [
                (str(r.get("dir") or "") or mdir, str(r["file"]))
                for r in manifest["runs"]
            ],
        )).encode(),
        digest_size=5,
    ).hexdigest()
    out = []
    for i in range(n):
        runs = []
        for rm in manifest["runs"]:
            rec = dict(rm)
            rec["dir"] = str(rm.get("dir") or "") or mdir
            rec["shared"] = 1
            runs.append(rec)
        out.append({
            MANIFEST_MARK: 1,
            "label": lab,
            "dir": f"{lab}~{ident}.s{i}",
            "seq": int(manifest["seq"]),
            "n_runs": len(runs),
            "total_records": sum(int(r["n"]) for r in runs),
            "runs": runs,
        })
    return out


def relocate_manifest(
    manifest: dict, src_root: str, dst_root: str
) -> tuple[int, int]:
    """Materialize a manifest's run files under another spill root
    (cross-process rebalance): hardlink — copy when the link fails —
    every referenced run file from ``src_root`` into the same
    root-relative location under ``dst_root``. The manifest itself needs
    no rewrite (directories are root-relative). Returns
    (files placed, bytes referenced)."""
    mdir = str(manifest.get("dir", ""))
    moved = 0
    nbytes = 0
    for rm in manifest.get("runs", []):
        rd = str(rm.get("dir") or "") or mdir
        src = os.path.join(src_root, rd, str(rm["file"]))
        dst = os.path.join(dst_root, rd, str(rm["file"]))
        nbytes += int(rm.get("bytes", 0))
        if os.path.exists(dst):
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
        moved += 1
    return moved, nbytes


def check_two_tier(store: SpillStore, owner: str = "") -> None:
    """The exclusive-residency invariant, proved from bytes on disk: a
    key's authoritative state is tail-first then newest-run-first, so
    every run's live set must be pairwise disjoint and disjoint from the
    tail. Raises PlanVerificationError naming the offending tiers."""
    from pathway_tpu_torch.internals.verifier import PlanVerificationError

    who = owner or store.label
    with store._gen_lock:
        runs = list(store.runs)
    seen: dict[bytes, str] = {}
    for run in runs:
        for _, _hb, kb, _payload in store._read_run(run):
            if kb in run.dead:
                continue
            if kb in seen:
                raise PlanVerificationError([
                    f"spill-two-tier [{who}]: key live in runs "
                    f"{seen[kb]} and {run.file}"
                ])
            seen[kb] = run.file
    if store.tail_keys is not None:
        for kb in store.tail_keys():
            if kb in seen:
                raise PlanVerificationError([
                    f"spill-two-tier [{who}]: key resident in the tail "
                    f"and in run {seen[kb]}"
                ])
