"""Whole-plan blue/green swaps over the persistence root.

Generalizes the atomic generation swap of the index retrain (a rename commit)
to the WHOLE pipeline: a new ("green") plan is warmed against a
hardlink clone of the serving ("blue") plan's persisted state, replays
the fence epoch, and replaces blue in one atomic rename — or aborts
with blue never having stopped.

The protocol (:func:`swap_plan`):

1.  ``recover_swap`` finishes any swap that crashed mid-commit (the
    commit marker makes the rename pair redoable) and discards
    abandoned staging.
2.  The blue root is CLONED to ``<root>.green`` with hardlinks — run
    segments, journals and snapshots are immutable files, so the clone
    is a metadata cost, and the green run can mutate its copy (new
    epochs, compaction) without touching blue's.
3.  The caller's ``run_green(stage_root)`` lowers + runs the green plan
    against the clone: restoring from the last committed epoch IS the
    warm-up, and the bytes it delivers are the fence-epoch replay.
4.  Gate A — byte identity: the replayed output must equal the
    ``baseline`` bytes the blue plan produced for the same input.
    Gate B — the verifier's swap contract
    (:func:`pathway_tpu_torch.internals.verifier.check_swap_contract`):
    offsets and outbox watermarks carried forward, shard map unchanged,
    green actually warmed. Either gate failing ABORTS: staging is
    deleted, blue is untouched, and the failure is reported.
5.  Commit: a marker file is fsynced, blue is renamed aside, green is
    renamed into place, the marker is removed. A crash anywhere in that
    window is rolled FORWARD by the next ``recover_swap``.

Fault points: ``swap.mid_commit`` crashes inside the commit window
(recovery must complete the swap); ``swap.replay.divergent`` forces
gate A to fail (the swap must abort with blue intact).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable

from pathway_tpu_torch.engine import faults

__all__ = ["swap_plan", "recover_swap", "stage_root_for"]

_MARKER_SUFFIX = ".swap.commit"
_STAGE_SUFFIX = ".green"
_RETIRED_SUFFIX = ".blue-retired"


def stage_root_for(blue_root: str) -> str:
    return blue_root.rstrip("/") + _STAGE_SUFFIX


def _metrics():
    from pathway_tpu_torch.internals import observability as obs

    return obs.PLANE.metrics if obs.PLANE is not None else None


def _record(kind: str, **fields: Any) -> None:
    from pathway_tpu_torch.internals import observability as obs

    obs.record(kind, **fields)


def _fsync_json(path: str, record: dict) -> None:
    from pathway_tpu_torch.persistence import _fsync_write

    _fsync_write(path, json.dumps(record).encode())


def _clone_tree(src: str, dst: str) -> int:
    """Hardlink-clone ``src`` into ``dst`` (copy on link failure, e.g.
    cross-device). Returns files placed. Immutable-file discipline makes
    this safe: segments, snapshots and spill runs are never rewritten in
    place, only replaced via atomic rename — and a rename breaks the
    link instead of mutating the shared inode."""
    n = 0
    for base, _dirs, files in os.walk(src):
        rel = os.path.relpath(base, src)
        out = dst if rel == "." else os.path.join(dst, rel)
        os.makedirs(out, exist_ok=True)
        for fn in files:
            s, d = os.path.join(base, fn), os.path.join(out, fn)
            try:
                os.link(s, d)
            except OSError:
                shutil.copy2(s, d)
            n += 1
    return n


def recover_swap(blue_root: str) -> str | None:
    """Finish or discard an interrupted swap. Returns "completed" when a
    marked commit was rolled forward, "discarded" when abandoned staging
    was dropped, None when there was nothing to do. Idempotent."""
    blue_root = blue_root.rstrip("/")
    marker = blue_root + _MARKER_SUFFIX
    stage = stage_root_for(blue_root)
    retired = blue_root + _RETIRED_SUFFIX
    if os.path.exists(marker):
        # marker durable => green was fully verified: roll FORWARD
        if os.path.isdir(stage):
            if os.path.isdir(blue_root):
                if os.path.isdir(retired):
                    shutil.rmtree(retired, ignore_errors=True)
                os.rename(blue_root, retired)
            os.rename(stage, blue_root)
        try:
            os.unlink(marker)
        except OSError:
            pass
        _record("swap.recovered", root=blue_root)
        return "completed"
    if os.path.isdir(stage):
        shutil.rmtree(stage, ignore_errors=True)
        return "discarded"
    return None


def swap_plan(
    blue_root: str,
    run_green: Callable[[str], Any],
    *,
    baseline: Any = None,
    verify: bool = True,
) -> dict:
    """Attempt a blue/green plan swap on ``blue_root``. ``run_green``
    receives the STAGED root and must run the green plan against it
    (restore -> replay the fence epoch -> deliver), returning the bytes
    (or any comparable object) it delivered; ``baseline`` is what the
    blue plan delivered for the same input. Returns
    ``{"committed": bool, "reason": ..., "output": ...}`` — on any
    abort the blue root is byte-for-byte untouched."""
    from pathway_tpu_torch.internals import verifier

    blue_root = blue_root.rstrip("/")
    t0 = time.monotonic()
    m = _metrics()
    if m is not None:
        m.counter(
            "pathway_swap_attempts",
            help="blue/green swap attempts (commits + aborts)",
        )
    recover_swap(blue_root)
    stage = stage_root_for(blue_root)
    _clone_tree(blue_root, stage)

    def abort(reason: str) -> dict:
        shutil.rmtree(stage, ignore_errors=True)
        if m is not None:
            m.counter(
                "pathway_swap_aborts",
                help="blue/green swaps aborted with blue still serving",
            )
        _record("swap.aborted", root=blue_root, reason=reason[:400])
        return {"committed": False, "reason": reason, "output": None}

    try:
        green_out = run_green(stage)
    except Exception as e:  # noqa: BLE001 — a green crash must not kill blue
        return abort(f"green run failed: {type(e).__name__}: {e}")
    if faults.fire("swap.replay.divergent"):
        return abort(
            "fence-epoch replay diverged from the blue baseline "
            "(injected: swap.replay.divergent)"
        )
    if baseline is not None and green_out != baseline:
        return abort("fence-epoch replay diverged from the blue baseline")
    if verify and verifier.enabled():
        try:
            verifier.check_swap_contract(blue_root, stage)
        except verifier.PlanVerificationError as e:
            return abort(f"swap contract: {'; '.join(e.findings)}")

    # commit window: marker -> rename pair -> marker removed. The marker
    # is the point of no return; recover_swap rolls forward from any
    # crash position inside this window.
    marker = blue_root + _MARKER_SUFFIX
    retired = blue_root + _RETIRED_SUFFIX
    _fsync_json(marker, {"stage": stage, "blue": blue_root})
    faults.crash("swap.mid_commit")
    if os.path.isdir(retired):
        shutil.rmtree(retired, ignore_errors=True)
    os.rename(blue_root, retired)
    os.rename(stage, blue_root)
    try:
        os.unlink(marker)
    except OSError:
        pass
    if m is not None:
        m.counter(
            "pathway_swap_commits",
            help="blue/green swaps committed at the metadata rename",
        )
    _record(
        "swap.committed", root=blue_root,
        seconds=round(time.monotonic() - t0, 4),
    )
    return {"committed": True, "reason": None, "output": green_out}
