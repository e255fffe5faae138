"""Mesh supervisor: restart-the-mesh-from-checkpoint recovery.

A multi-process run (engine/runtime.py ``run_mesh``) detects a dead peer
on its wires and aborts with :class:`~pathway_tpu_torch.parallel.process_mesh.
WorkerLost` instead of hanging — but *something* has to restart the job.
That something is this supervisor: it owns the worker processes of one
mesh, watches for any worker dying (injected crash, OOM-kill, WorkerLost
abort), and restarts the WHOLE generation. On restart the workers
re-negotiate the minimum committed checkpoint epoch across the mesh
(persistence/__init__.py allgather) and resume from it, so the job's
final output is identical to a crash-free run whenever the pipeline's
sources are journaled or seekable.

The whole-generation restart is deliberate: surviving workers hold
operator state *ahead* of the last committed epoch, and exchange wires
carry waves a rejoining worker never saw — a partial restart would need
distributed wave replay. Restarting the mesh from the agreed epoch is
the reference engine's model too (every worker rebuilds from
metadata → snapshots → journal tail).

By default restarted generations run with ``PATHWAY_FAULTS=0``: a
schedule is hit-count deterministic, so re-running it verbatim would
re-fire the same crash every generation. Pass
``faults_after_restart=`` to keep chaos flowing across restarts.

The port's device plane keeps no quarantine (a failed dispatch raises),
so, unlike the JAX package's supervisor, nothing is reset between
generations: each generation's processes start with a fresh plane.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Sequence

__all__ = ["SupervisedMeshFailed", "run_supervised"]


class SupervisedMeshFailed(RuntimeError):
    """The mesh kept failing past ``max_restarts`` generations."""


def _spawn(
    argv: Sequence[str], n: int, first_port: int, env: dict[str, str]
) -> list[tuple[subprocess.Popen, Any]]:
    """Start the generation's workers. stdout/stderr go to unlinked spill
    files, NOT pipes: nobody drains a pipe while workers run, so a chatty
    worker (breaker warnings, chaos logging) would fill the ~64KB buffer,
    block on write, and stall the mesh until the overall timeout."""
    procs = []
    for pid in range(n):
        penv = {
            **env,
            "PATHWAY_PROCESSES": str(n),
            "PATHWAY_PROCESS_ID": str(pid),
            "PATHWAY_FIRST_PORT": str(first_port),
        }
        spill = tempfile.TemporaryFile(mode="w+", prefix=f"pw-sup-{pid}-")
        procs.append(
            (
                subprocess.Popen(
                    list(argv),
                    env=penv,
                    stdout=subprocess.DEVNULL,
                    stderr=spill,
                    text=True,
                ),
                spill,
            )
        )
    return procs


def _reap(procs: list[tuple[subprocess.Popen, Any]]) -> list[str]:
    """Kill survivors, wait everyone, return per-worker stderr."""
    for p, _spill in procs:
        if p.poll() is None:
            p.kill()
    errs = []
    for p, spill in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        try:
            spill.seek(0)
            errs.append(spill.read())
        except (OSError, ValueError):
            errs.append("")
        finally:
            spill.close()
    return errs


def run_supervised(
    argv: Sequence[str],
    n_processes: int,
    first_port: int,
    *,
    max_restarts: int = 3,
    env: dict[str, str] | None = None,
    faults_after_restart: str = "0",
    poll_s: float = 0.1,
    timeout_s: float = 600.0,
    state_dir: str | None = None,
) -> dict[str, Any]:
    """Run ``argv`` as an ``n_processes`` mesh until every worker exits 0,
    restarting the whole mesh (same ports, same persistence roots) after
    any worker death. Returns ``{"generations": g, "stderr": [...],
    "rebalances": r, "members": n}`` of the successful generation; raises
    :class:`SupervisedMeshFailed` after ``max_restarts`` failed
    generations and :class:`TimeoutError` on the overall deadline.

    ``state_dir`` (the SHARED persistence root the workers put their
    ``proc-N`` roots under) switches on elastic membership (parallel/
    membership.py, unless ``PATHWAY_ELASTIC=0``): join/leave intents
    announced under ``state_dir/control/`` are folded into a pending
    membership record, the running generation is asked to quiesce to a
    checkpoint fence, and when every worker exits with the planned
    rebalance code the mesh respawns at the new size — without spending
    restart budget, because nothing failed."""
    from pathway_tpu_torch.internals import observability as obs
    from pathway_tpu_torch.parallel import membership as _mb

    # supervisor-side black box: generation lifecycles land in the flight
    # recorder (workers dump their own rings when they crash; this is the
    # restart-decision record that stitches those dumps together)
    obs.maybe_enable_from_env()
    base_env = {**os.environ, **(env or {})}
    deadline = time.monotonic() + timeout_s
    failures: list[str] = []
    elastic = state_dir is not None and _mb.elastic_enabled()
    n = n_processes
    if elastic:
        # finish any rebalance that crashed mid-commit, then honour the
        # committed membership record over the caller's initial size
        _mb.recover_rebalance(state_dir)
        rec = _mb.load_membership(state_dir)
        if rec is not None:
            n = int(
                rec["n"] if rec.get("rebalanced") else rec.get("prev_n", n)
            )
    generation = 0
    rebalances = 0
    while len(failures) <= max_restarts:
        gen_env = dict(base_env)
        if generation > 0:
            gen_env["PATHWAY_FAULTS"] = faults_after_restart
        procs = _spawn(argv, n, first_port, gen_env)
        if obs.PLANE is not None:
            obs.PLANE.metrics.gauge(
                "pathway_mesh_members", n,
                help="mesh size after the last committed rebalance",
            )
        failed: str | None = None
        rebalanced = False
        while True:
            if time.monotonic() > deadline:
                _reap(procs)
                raise TimeoutError(
                    f"supervised mesh did not finish within {timeout_s:.0f}s "
                    f"(generation {generation})"
                )
            codes = [p.poll() for p, _spill in procs]
            benign = (None, 0, _mb.REBALANCE_EXIT)
            if any(c not in benign for c in codes):
                dead = [i for i, c in enumerate(codes) if c not in benign]
                # one worker died: the survivors observe WorkerLost on
                # their wires and exit on their own — kill + wait the
                # stragglers to reclaim the ports for the next generation
                errs = _reap(procs)
                obs.record(
                    "supervisor.restart", generation=generation,
                    dead_workers=dead,
                    exit_codes=[codes[i] for i in dead],
                )
                failed = (
                    f"generation {generation}: worker(s) {dead} exited "
                    f"{[codes[i] for i in dead]}"
                )
                for i, err in enumerate(errs):
                    if err.strip():
                        failed += f"\n-- worker {i} stderr --\n{err[-2000:]}"
                break
            if all(c is not None for c in codes):
                if any(c == _mb.REBALANCE_EXIT for c in codes):
                    # planned generation boundary, not a failure
                    rebalanced = True
                    _reap(procs)
                    break
                if generation > 0:
                    # restarts happened: leave the decision record beside
                    # the workers' own crash dumps
                    obs.record(
                        "supervisor.recovered", generations=generation + 1,
                    )
                    obs.dump_flight("supervisor")
                return {
                    "generations": generation + 1,
                    "stderr": _reap(procs),
                    "rebalances": rebalances,
                    "members": n,
                }
            if elastic and not _mb.quiesce_requested(state_dir):
                joins, leaves = _mb.pending_intents(state_dir)
                if joins or leaves:
                    planned = _mb.plan_membership(state_dir, n)
                    if planned != n:
                        _mb.request_quiesce(state_dir)
                        obs.record(
                            "supervisor.quiesce_requested",
                            members=n, planned=planned,
                        )
            time.sleep(poll_s)
        if rebalanced:
            # process 0 rebalanced the roots (or refused and reverted)
            # before exiting; roll forward if it crashed mid-commit and
            # respawn at whatever the membership record now says
            if elastic:
                _mb.recover_rebalance(state_dir)
                rec = _mb.load_membership(state_dir) or {}
                new_n = int(rec.get("n", n)) if rec.get("rebalanced") else n
                if new_n != n:
                    rebalances += 1
                    obs.record(
                        "supervisor.rebalanced", members=new_n, was=n,
                        generation=generation,
                    )
                n = new_n
            generation += 1
            continue
        failures.append(failed or "unknown failure")
        generation += 1
    obs.record("supervisor.gave_up", generations=len(failures))
    obs.dump_flight("supervisor")
    raise SupervisedMeshFailed(
        f"mesh failed {len(failures)} generations:\n" + "\n".join(failures)
    )


def main() -> int:
    """CLI shim: ``python -m pathway_tpu_torch.parallel.supervisor N PORT -- cmd...``"""
    args = sys.argv[1:]
    if "--" not in args or len(args) < 4:
        print(
            "usage: python -m pathway_tpu_torch.parallel.supervisor "
            "<n_processes> <first_port> [max_restarts] -- <cmd> [args...]",
            file=sys.stderr,
        )
        return 2
    split = args.index("--")
    head, argv = args[:split], args[split + 1:]
    n, port = int(head[0]), int(head[1])
    restarts = int(head[2]) if len(head) > 2 else 3
    out = run_supervised(
        argv, n, port, max_restarts=restarts,
        state_dir=os.environ.get("PATHWAY_STATE_DIR") or None,
    )
    print(f"supervised mesh ok after {out['generations']} generation(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
