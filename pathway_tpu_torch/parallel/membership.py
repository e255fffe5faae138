"""Elastic mesh membership: join/leave intents, quiesce-to-fence, and
metadata-level shard rebalancing.

The reference engine is static — "cluster membership is static; all
processes must be up" — so a size change there is a full stop-the-world
redeploy with whole-journal replay. Here membership changes ride the
checkpoint fence the mesh already cuts:

1. Workers (or an operator) drop join/leave INTENT files under the
   shared persistence root's ``control/`` directory
   (:func:`announce_join` / :func:`announce_leave`).
2. The supervisor (parallel/supervisor.py) folds pending intents into a
   PENDING membership record (``rebalanced: false``) and writes a
   quiesce request.
3. Process 0 of the running generation sees the request at its next
   pump, broadcasts a quiesce flag and raises one final checkpoint
   fence.  Every process stops admitting input, drains, and commits the
   SAME epoch — then acknowledges over an rb-ack flag barrier and exits
   with :data:`REBALANCE_EXIT`.
4. Before exiting, process 0 — which still holds the lowered graph —
   REBALANCES the persisted roots (:func:`rebalance_at_fence`): journal
   segments, operator snapshots, and spilled runs move to staged
   ``proc-N.stage`` roots as hardlinks + re-split metadata, never a
   byte-level rewrite of operator state.  A commit marker makes the
   final directory swap crash-redoable.
5. The supervisor observes the rebalance exit code, rolls the marker
   forward if needed, and respawns the mesh at the new size.  The new
   generation restores from the staged epoch directly: no journal
   replay beyond the normal tail, no cold start.

Only the *moved* state travels: resident arrangements are merged/split
through the same ``merge_shard_states`` / ``split_shard_state`` protocol
thread-rescale uses, and spilled runs (engine/spill.py) are reassigned
at the manifest level — run files are hardlinked into the destination
root, not rewritten.

``PATHWAY_ELASTIC=0`` disables the whole plane: intents are ignored,
no quiesce flags are raised, and the mesh behaves byte-identically to a
static one.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any

from pathway_tpu_torch.engine import faults

__all__ = [
    "REBALANCE_EXIT",
    "RebalanceRefused",
    "elastic_enabled",
    "announce_join",
    "announce_leave",
    "pending_intents",
    "clear_intents",
    "request_quiesce",
    "quiesce_requested",
    "clear_quiesce",
    "load_membership",
    "commit_membership",
    "plan_membership",
    "write_source_map",
    "read_source_map",
    "recover_rebalance",
    "rebalance_at_fence",
]

# distinct from crash codes: "this generation ended ON PURPOSE at a
# rebalance fence" — the supervisor respawns at the new size without
# spending restart budget
REBALANCE_EXIT = 75

_MEMBERSHIP = "membership.json"
_MARKER = "rebalance.commit"
_QUIESCE = "quiesce.request"
_SOURCES = "sources.json"

# elasticity is restricted to meshes of >= 2: n=1 lowers a different
# graph shape (no exchange boundaries), so 1 <-> n moves would cross a
# pipeline-signature change, not a shard map change
MIN_MEMBERS = 2


class RebalanceRefused(RuntimeError):
    """The shard move cannot be done safely; membership stays as-is and
    the mesh resumes at its old size from the same fence epoch."""


def elastic_enabled() -> bool:
    return os.environ.get("PATHWAY_ELASTIC", "1") != "0"


def control_dir(shared_root: str) -> str:
    d = os.path.join(shared_root, "control")
    os.makedirs(d, exist_ok=True)
    return d


def _fsync_json(path: str, record: dict) -> None:
    from pathway_tpu_torch.persistence import _fsync_write

    _fsync_write(path, json.dumps(record).encode())


def _load_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ------------------------------------------------------------- intents


def announce_join(shared_root: str, count: int = 1) -> str:
    """A worker (or operator) announces that ``count`` processes want to
    JOIN the mesh at the next fence. Returns the intent path."""
    faults.check("mesh.member.join")
    return _write_intent(shared_root, "join", count)


def announce_leave(shared_root: str, count: int = 1) -> str:
    """Announce that ``count`` processes will LEAVE at the next fence."""
    faults.check("mesh.member.leave")
    return _write_intent(shared_root, "leave", count)


def _write_intent(shared_root: str, kind: str, count: int) -> str:
    d = control_dir(shared_root)
    nonce = hashlib.blake2b(os.urandom(16), digest_size=6).hexdigest()
    path = os.path.join(d, f"{kind}-{nonce}.intent")
    _fsync_json(path, {"kind": kind, "count": int(count)})
    return path


def pending_intents(shared_root: str) -> tuple[int, int]:
    """(joins, leaves) currently announced and not yet consumed."""
    d = os.path.join(shared_root, "control")
    joins = leaves = 0
    if not os.path.isdir(d):
        return (0, 0)
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".intent"):
            continue
        rec = _load_json(os.path.join(d, fn)) or {}
        n = int(rec.get("count", 1))
        if rec.get("kind") == "join":
            joins += n
        elif rec.get("kind") == "leave":
            leaves += n
    return (joins, leaves)


def clear_intents(shared_root: str) -> None:
    d = os.path.join(shared_root, "control")
    if not os.path.isdir(d):
        return
    for fn in os.listdir(d):
        if fn.endswith(".intent"):
            try:
                os.unlink(os.path.join(d, fn))
            except OSError:
                pass


# ------------------------------------------------------- quiesce request


def request_quiesce(shared_root: str) -> None:
    _fsync_json(
        os.path.join(control_dir(shared_root), _QUIESCE), {"requested": 1}
    )


def quiesce_requested(shared_root: str) -> bool:
    return os.path.exists(os.path.join(shared_root, "control", _QUIESCE))


def clear_quiesce(shared_root: str) -> None:
    try:
        os.unlink(os.path.join(shared_root, "control", _QUIESCE))
    except OSError:
        pass


# ---------------------------------------------------- membership record


def load_membership(shared_root: str) -> dict | None:
    return _load_json(os.path.join(shared_root, "control", _MEMBERSHIP))


def commit_membership(shared_root: str, record: dict) -> None:
    _fsync_json(os.path.join(control_dir(shared_root), _MEMBERSHIP), record)


def plan_membership(shared_root: str, current_n: int) -> int:
    """Fold pending intents into a PENDING membership record and return
    the planned size (== ``current_n`` when nothing changes). Called by
    the supervisor BEFORE it requests a quiesce, so the running
    generation's process 0 finds an unambiguous target at the fence."""
    joins, leaves = pending_intents(shared_root)
    new_n = max(MIN_MEMBERS, current_n + joins - leaves)
    if new_n == current_n:
        clear_intents(shared_root)
        return current_n
    prev = load_membership(shared_root) or {}
    commit_membership(
        shared_root,
        {
            "generation": int(prev.get("generation", 0)) + 1,
            "n": new_n,
            "prev_n": current_n,
            "rebalanced": False,
        },
    )
    return new_n


# ------------------------------------------------------------ source map


def write_source_map(proc_root: str, connectors: list) -> None:
    """Persist {connector name -> global lowering ordinal} for the
    connectors THIS process owns. Source ownership is ``ordinal %
    mesh.n`` (internals/lowering.py), so the rebalancer needs the
    ordinal — not just the name — to route a journal to its new owner."""
    m = {
        c.name: int(getattr(c, "ordinal", i))
        for i, c in enumerate(connectors)
    }
    os.makedirs(proc_root, exist_ok=True)
    _fsync_json(os.path.join(proc_root, _SOURCES), m)


def read_source_map(proc_root: str) -> dict[str, int]:
    return {
        str(k): int(v)
        for k, v in (_load_json(os.path.join(proc_root, _SOURCES)) or {}).items()
    }


# -------------------------------------------------------- crash recovery


def recover_rebalance(shared_root: str) -> bool:
    """Roll an interrupted rebalance FORWARD. Once the commit marker is
    durable every staged root is complete, so the only safe direction is
    finishing the directory swap; without the marker any ``*.stage``
    leftovers are an abandoned attempt and are discarded. Idempotent —
    the supervisor calls this before every spawn decision."""
    marker_path = os.path.join(shared_root, "control", _MARKER)
    marker = _load_json(marker_path)
    if marker is None:
        # no commit in flight: drop abandoned staging
        for fn in _list_dirs(shared_root):
            if fn.endswith(".stage"):
                shutil.rmtree(os.path.join(shared_root, fn), ignore_errors=True)
        return False
    old_n, new_n = int(marker["old_n"]), int(marker["new_n"])
    _roll_forward(shared_root, old_n, new_n)
    rec = load_membership(shared_root) or {}
    rec.update({"n": new_n, "prev_n": old_n, "rebalanced": True})
    rec.setdefault("generation", 1)
    commit_membership(shared_root, rec)
    clear_intents(shared_root)
    clear_quiesce(shared_root)
    try:
        os.unlink(marker_path)
    except OSError:
        pass
    return True


def _list_dirs(shared_root: str) -> list[str]:
    try:
        return os.listdir(shared_root)
    except OSError:
        return []


def _roll_forward(shared_root: str, old_n: int, new_n: int) -> None:
    """The commit point's directory swap, written to be redoable from
    any crash position: retire an old root only while its replacement
    still waits in staging (or it has no replacement at all), then
    promote whatever staging remains."""
    for p in range(old_n):
        cur = os.path.join(shared_root, f"proc-{p}")
        stg = os.path.join(shared_root, f"proc-{p}.stage")
        ret = os.path.join(shared_root, f"proc-{p}.retired")
        if os.path.isdir(cur) and (p >= new_n or os.path.isdir(stg)):
            if os.path.isdir(ret):
                shutil.rmtree(ret, ignore_errors=True)
            os.rename(cur, ret)
    for q in range(new_n):
        stg = os.path.join(shared_root, f"proc-{q}.stage")
        cur = os.path.join(shared_root, f"proc-{q}")
        if os.path.isdir(stg) and not os.path.isdir(cur):
            os.rename(stg, cur)


# ---------------------------------------------------- fence-time rebalance


def rebalance_at_fence(rt: Any) -> bool:
    """Process 0's half of the rebalance exit: every root just committed
    the SAME fence epoch and every peer has acknowledged, so this
    process — the only one still holding the lowered graph — moves the
    shards. Returns True when membership changed; on refusal the
    membership record is reverted and the mesh resumes at its old size."""
    from pathway_tpu_torch.internals import observability as obs

    mgr = rt.checkpointer
    mesh = rt.mesh
    if mgr is None or mesh is None:
        return False
    proc_root = mgr.config.backend.path
    shared = os.path.dirname(os.path.abspath(proc_root))
    rec = load_membership(shared)
    old_n = mesh.n
    if rec is None or rec.get("rebalanced") or int(rec.get("n", old_n)) == old_n:
        clear_intents(shared)
        clear_quiesce(shared)
        return False
    new_n = int(rec["n"])
    epoch = mgr.epoch
    t0 = time.monotonic()
    try:
        stats = _rebalance_roots(
            rt.graph, shared, old_n, new_n, epoch
        )
    except Exception as e:  # noqa: BLE001 — refusal must never kill the mesh
        commit_membership(
            shared,
            {
                "generation": int(rec.get("generation", 1)),
                "n": old_n,
                "prev_n": old_n,
                "rebalanced": True,
                "aborted": f"{type(e).__name__}: {e}"[:400],
            },
        )
        clear_intents(shared)
        clear_quiesce(shared)
        obs.record(
            "rebalance.aborted", old_n=old_n, new_n=new_n, epoch=epoch,
            error=f"{type(e).__name__}: {e}"[:400],
        )
        return False
    rec2 = dict(rec)
    rec2.update({"rebalanced": True, "epoch": epoch})
    commit_membership(shared, rec2)
    clear_intents(shared)
    clear_quiesce(shared)
    try:
        os.unlink(os.path.join(shared, "control", _MARKER))
    except OSError:
        pass
    dt = time.monotonic() - t0
    obs.record(
        "rebalance.committed", old_n=old_n, new_n=new_n, epoch=epoch,
        seconds=round(dt, 4), **stats,
    )
    if obs.PLANE is not None:
        m = obs.PLANE.metrics
        m.gauge(
            "pathway_mesh_members", new_n,
            help="mesh size after the last committed rebalance",
        )
        m.counter(
            "pathway_rebalance_shards", inc=stats["shards"],
            help="operator state parts re-homed by elastic rebalance",
        )
        m.counter(
            "pathway_rebalance_bytes", inc=stats["bytes"],
            help="bytes re-homed (hardlinked, not rewritten) by rebalance",
        )
        m.observe(
            "pathway_rebalance_seconds", dt,
            help="wall seconds spent inside the fence-time rebalance",
        )
    return True


def _rebalance_roots(
    graph: Any, shared: str, old_n: int, new_n: int, epoch: int
) -> dict:
    from pathway_tpu_torch import persistence as _p
    from pathway_tpu_torch.engine import spill as _spill
    from pathway_tpu_torch.engine.workers import ProcessExchangeNode, _shard_of

    old_roots = [os.path.join(shared, f"proc-{p}") for p in range(old_n)]
    metas = []
    for p, r in enumerate(old_roots):
        m = _p.MetadataStore(r).load()
        if m is None or int(m.get("epoch", -1)) != epoch:
            raise RebalanceRefused(
                f"proc {p} is not committed at fence epoch {epoch}"
            )
        metas.append(m)
    # the signature the NEXT generation (lowered at new_n) will compute
    new_sig = _p._pipeline_signature(graph, exchange_n=new_n)
    name_ord: dict[str, int] = {}
    for r in old_roots:
        name_ord.update(read_source_map(r))

    stage = [os.path.join(shared, f"proc-{q}.stage") for q in range(new_n)]
    for d in stage:
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)

    files_moved = 0
    bytes_moved = 0

    # 1. journals + offsets + frontiers follow source ownership
    #    (ordinal % n, internals/lowering.py)
    offsets_new: list[dict] = [{} for _ in range(new_n)]
    frontiers_new: list[dict] = [{} for _ in range(new_n)]
    for p, m in enumerate(metas):
        for nm, off in (m.get("offsets") or {}).items():
            if nm not in name_ord:
                raise RebalanceRefused(
                    f"journaled source {nm!r} missing from proc {p}'s "
                    "source map; cannot route its journal"
                )
            q = name_ord[nm] % new_n
            offsets_new[q][nm] = off
            nf, nb = _link_journal(old_roots[p], stage[q], nm)
            files_moved += nf
            bytes_moved += nb
        for nm, fr in (m.get("frontiers") or {}).items():
            q = name_ord.get(nm, 0) % new_n
            frontiers_new[q][nm] = fr

    # 2. outbox WALs stay with their process slot: a continuing process
    #    keeps its sealed-unacked range; a retiring process's outbox was
    #    fully delivered by the fence checkpoint's deliver_all
    for q in range(min(old_n, new_n)):
        nf, nb = _link_tree(
            os.path.join(old_roots[q], "outbox"),
            os.path.join(stage[q], "outbox"),
        )
        files_moved += nf
        bytes_moved += nb

    # 3. operator snapshots: merge across the old shard map, split
    #    across the new one. Spill manifests ride as metadata; run files
    #    are hardlinked into per-(epoch, old-proc) namespaced dirs so
    #    same-label dirs from different old roots never collide.
    ops_old = [_p.OperatorSnapshotStore(r) for r in old_roots]
    ops_new = [_p.OperatorSnapshotStore(d) for d in stage]
    origin: dict[str, tuple[str, str]] = {}
    manifests_new: list[list[str]] = [[] for _ in range(new_n)]
    shards_moved = 0
    for node in graph.nodes:
        pid = _p._persistent_id(node)
        present: list[tuple[int, dict]] = []
        for p in range(old_n):
            st = ops_old[p].read(pid, epoch)  # corrupt snapshot -> refuse
            if st is not None:
                present.append((p, st))
        if not present:
            continue
        rend = [
            (p, _renamespace(_spill, st, p, epoch, origin, old_roots[p]))
            for p, st in present
        ]
        cat = _category(node, ProcessExchangeNode)
        if cat == "exchange":
            # per-process round counters: monotone, restart-consistent
            merged_round = max(int(st.get("round", 0)) for _, st in rend)
            parts: list[dict | None] = [
                {"round": merged_round} for _ in range(new_n)
            ]
        elif cat == "global":
            # route=None exchanges deliver every record to process 0:
            # peers hold the state's initial (empty) value by construction
            st0 = next((st for p, st in rend if p == 0), None)
            if st0 is None:
                raise RebalanceRefused(
                    f"global-routed node {pid} has no proc-0 snapshot"
                )
            parts = [None] * new_n
            parts[0] = st0
        elif cat == "token":
            merged = _merge_node_states(node, [st for _, st in rend])
            parts = _split_node_state(node, merged, new_n, _shard_of)
        else:
            raise RebalanceRefused(
                f"node {pid} holds process-local state with no exchange "
                "routing; its shards cannot be re-homed"
            )
        for q in range(new_n):
            st_q = parts[q]
            if st_q is None:
                continue
            nf, nb = _link_runs(_spill, st_q, os.path.join(stage[q], "spill"), origin)
            files_moved += nf
            bytes_moved += nb
            ops_new[q].write(pid, epoch, st_q)
            manifests_new[q].append(pid)
            shards_moved += 1

    # 4. per-root metadata at the SAME epoch, signed for the new size
    ftime = int(metas[0].get("finalized_time", 0))
    for q in range(new_n):
        outbox = metas[q].get("outbox") if q < old_n else None
        _p.MetadataStore(stage[q]).commit(
            epoch,
            offsets_new[q],
            new_sig,
            ftime,
            prev=None,
            frontiers=frontiers_new[q],
            op_snapshots=manifests_new[q],
            outbox=outbox,
        )
        write_sources = {
            nm: o for nm, o in name_ord.items() if o % new_n == q
        }
        _fsync_json(os.path.join(stage[q], _SOURCES), write_sources)

    # 5. commit marker, then the redoable directory swap
    _fsync_json(
        os.path.join(control_dir(shared), _MARKER),
        {"old_n": old_n, "new_n": new_n, "epoch": epoch},
    )
    _roll_forward(shared, old_n, new_n)
    return {
        "shards": shards_moved,
        "bytes": bytes_moved,
        "files": files_moved,
    }


# ------------------------------------------------------------- low level


def _link_file(src: str, dst: str) -> int:
    if os.path.exists(dst):
        return 0
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)
    try:
        return os.path.getsize(dst)
    except OSError:
        return 0


def _link_journal(old_root: str, new_root: str, name: str) -> tuple[int, int]:
    from pathway_tpu_torch.persistence import _safe

    pre = f"{_safe(name)}."
    nf = nb = 0
    try:
        entries = os.listdir(old_root)
    except OSError:
        return (0, 0)
    for fn in entries:
        if fn.startswith(pre) and fn.endswith(".seg"):
            nb += _link_file(
                os.path.join(old_root, fn), os.path.join(new_root, fn)
            )
            nf += 1
    return (nf, nb)


def _link_tree(src: str, dst: str) -> tuple[int, int]:
    nf = nb = 0
    if not os.path.isdir(src):
        return (0, 0)
    for base, _dirs, files in os.walk(src):
        rel = os.path.relpath(base, src)
        for fn in files:
            s = os.path.join(base, fn)
            d = os.path.join(dst, rel, fn) if rel != "." else os.path.join(dst, fn)
            nb += _link_file(s, d)
            nf += 1
    return (nf, nb)


def _category(node: Any, exchange_cls: type) -> str:
    if isinstance(node, exchange_cls):
        return "exchange"
    exch = [
        i for i in getattr(node, "inputs", []) if isinstance(i, exchange_cls)
    ]
    if exch and any(x.route is not None for x in exch):
        return "token"
    if exch:
        return "global"
    return "local"


def _map_manifests(spill_mod: Any, st: Any, fn: Any) -> Any:
    if spill_mod.is_manifest(st):
        return fn(st)
    if isinstance(st, dict):
        return {k: _map_manifests(spill_mod, v, fn) for k, v in st.items()}
    if isinstance(st, list):
        return [_map_manifests(spill_mod, v, fn) for v in st]
    if isinstance(st, tuple):
        return tuple(_map_manifests(spill_mod, v, fn) for v in st)
    return st


def _renamespace(
    spill_mod: Any,
    st: Any,
    proc: int,
    epoch: int,
    origin: dict[str, tuple[str, str]],
    old_root: str,
) -> Any:
    """Rewrite every spill manifest in ``st`` so its run directories are
    unique per (epoch, source proc): two old processes both sealed runs
    under e.g. ``n5-reduce/run-00000001.seg`` in their OWN spill roots,
    and after the merge those must coexist under one destination root.
    ``origin`` records where each namespaced dir's files actually live
    so :func:`_link_runs` can place the hardlinks."""
    spill_root = os.path.join(old_root, "spill")

    def map_dir(d0: str) -> str:
        nd = (
            f"rb{epoch}p{proc}-"
            + hashlib.blake2b(d0.encode(), digest_size=5).hexdigest()
        )
        origin.setdefault(nd, (spill_root, d0))
        return nd

    def remap(man: dict) -> dict:
        mdir = str(man.get("dir", ""))
        out = dict(man)
        out["dir"] = map_dir(mdir)
        runs = []
        for rm in man.get("runs", []):
            rm2 = dict(rm)
            rd = str(rm.get("dir") or "") or mdir
            rm2["dir"] = map_dir(rd)
            runs.append(rm2)
        out["runs"] = runs
        return out

    return _map_manifests(spill_mod, st, remap)


def _link_runs(
    spill_mod: Any,
    st: Any,
    dst_spill_root: str,
    origin: dict[str, tuple[str, str]],
) -> tuple[int, int]:
    """Hardlink every run file referenced by ``st``'s manifests into the
    destination spill root, preserving the namespaced layout the
    manifest records point at."""
    moved = [0, 0]

    def place(man: dict) -> dict:
        for rm in man.get("runs", []):
            rd = str(rm.get("dir") or "")
            if rd not in origin:
                raise RebalanceRefused(
                    f"spill run dir {rd!r} has no recorded origin"
                )
            src_root, src_dir = origin[rd]
            src = os.path.join(src_root, src_dir, str(rm["file"]))
            dst = os.path.join(dst_spill_root, rd, str(rm["file"]))
            nb = _link_file(src, dst)
            moved[0] += 1
            moved[1] += nb
        return man

    _map_manifests(spill_mod, st, place)
    return (moved[0], moved[1])


def _merge_node_states(node: Any, states: list[dict]) -> dict:
    replicas = getattr(node, "replicas", None)
    template = replicas[0] if replicas else node
    flat: list[dict] = []
    for st in states:
        if isinstance(st, dict) and "n_shards" in st and "shards" in st:
            flat.extend(s for s in st["shards"] if s is not None)
        else:
            flat.append(st)
    return template.merge_shard_states(flat)


def _split_node_state(
    node: Any, merged: dict, n: int, shard_of: Any
) -> list[dict]:
    replicas = getattr(node, "replicas", None)
    template = replicas[0] if replicas else node
    # parts are written UNSHARDED: the restoring process re-partitions
    # across its own thread count via adapt_shard_state, exactly like a
    # PATHWAY_THREADS change
    return template.split_shard_state(merged, n, lambda tok: shard_of(tok, n))
