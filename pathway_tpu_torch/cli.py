"""Command-line interface: `python -m pathway_tpu_torch spawn|replay ...`.

Reference parity: python/pathway/cli.py — `spawn` (:113-190) launches the
same script as N cooperating processes with `PATHWAY_*` env wiring;
`replay` (:252) re-runs a script against recorded input snapshots;
`spawn_from_env` (:283) reads the spawn arguments from PATHWAY_SPAWN_ARGS.

Process model: spawned processes COOPERATE — each builds the same graph,
sources are partitioned round-robin across processes, and stateful
operators hash-exchange records over the TCP mesh
(parallel/process_mesh.py), so every key's state lives on exactly one
process (and one thread shard within it, PATHWAY_THREADS). The env
contract (PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_FIRST_PORT /
PATHWAY_THREADS) matches the reference.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def _command_of(args: argparse.Namespace) -> list[str]:
    cmd = list(args.command)
    if cmd and cmd[0] == "--":  # argparse REMAINDER keeps the separator
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("no command given; usage: spawn [-n N] -- script.py")
    return cmd


def _spawn(args: argparse.Namespace) -> int:
    command = _command_of(args)
    env_base = dict(os.environ)
    env_base["PATHWAY_THREADS"] = str(args.threads)
    env_base["PATHWAY_PROCESSES"] = str(args.processes)
    env_base["PATHWAY_FIRST_PORT"] = str(args.first_port)
    procs: list[subprocess.Popen] = []
    for pid in range(args.processes):
        env = dict(env_base)
        env["PATHWAY_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen([sys.executable, *command], env=env))
    rc = 0
    try:
        for p in procs:
            rc = p.wait() or rc
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait()
        rc = 130
    return rc


def _replay(args: argparse.Namespace) -> int:
    env = dict(os.environ)
    env["PATHWAY_REPLAY_STORAGE"] = args.record_path
    env["PATHWAY_PERSISTENCE_MODE"] = args.mode
    env["PATHWAY_THREADS"] = str(args.threads)
    return subprocess.call([sys.executable, *_command_of(args)], env=env)


def _spawn_from_env(args: argparse.Namespace) -> int:
    raw = os.environ.get("PATHWAY_SPAWN_ARGS", "")
    forwarded = shlex.split(raw) + list(args.command)
    return main(["spawn", *forwarded])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pathway_tpu_torch", description="pathway_tpu_torch process launcher"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spawn", help="run a script as N worker processes")
    sp.add_argument("-t", "--threads", type=int, default=1)
    sp.add_argument("-n", "--processes", type=int, default=1)
    sp.add_argument("--first-port", type=int, default=10000)
    sp.add_argument("command", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=_spawn)

    rp = sub.add_parser("replay", help="re-run a script from recorded snapshots")
    rp.add_argument("--record-path", default="./record")
    rp.add_argument(
        "--mode",
        choices=["batch", "speedrun"],
        default="batch",
    )
    rp.add_argument("-t", "--threads", type=int, default=1)
    rp.add_argument("command", nargs=argparse.REMAINDER)
    rp.set_defaults(fn=_replay)

    se = sub.add_parser("spawn-from-env", help="spawn with args from PATHWAY_SPAWN_ARGS")
    se.add_argument("command", nargs=argparse.REMAINDER)
    se.set_defaults(fn=_spawn_from_env)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
