"""Inter-process data plane: a full TCP mesh for operator exchange.

Reference parity: the reference's multi-process execution rides timely's
TCP communication fabric (external/timely-dataflow/communication/src/
networking.rs — one socket pair per worker pair, length-prefixed binary
frames); processes agree on wave boundaries through the progress
protocol. Here the equivalents are:

  * ProcessMesh — process i listens on FIRST_PORT + i, dials every peer,
    and exchanges length-prefixed pickle frames;
  * data frames — (node_id, round, entries) buckets routed by each
    exchange operator's shard key (engine/workers.py ProcessExchangeNode);
  * control frames — per-round (has_data, done) flags, giving every
    process the same global view to decide lockstep waves and
    termination (the progress-protocol stand-in).

The host control plane carries arbitrary Python rows; bulk numeric
columns ride the ICI all_to_all in parallel/exchange.py instead.

Frame format: pickle PROTOCOL 5 with out-of-band buffers — a frame is
``[n_bufs][pkl_len][pkl][buf_len buf]*`` under one outer length prefix.
NativeBatch wire tuples keep their flat numpy columns as ndarrays, so
their buffers ship out-of-band: the array bytes go straight from the
array to the socket (and straight off the receive buffer into the
reconstructed arrays) without ever being copied through the pickle
stream. ``Mesh.stats`` counts frames/bytes and how much rode out-of-band.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import Any

from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_LEN = struct.Struct("<Q")


class WorkerLost(ConnectionError):
    """A mesh peer's socket closed mid-run. Every barrier and the frontier
    pump raise this instead of hanging; a supervisor
    (parallel/supervisor.py) treats it — and the worker's own death — as
    'restart the mesh, resume from the last committed checkpoint'."""


class ProcessMesh:
    """Full mesh between PATHWAY_PROCESSES processes (one host or a
    cluster — peers resolve via FIRST_PORT + process id)."""

    def __init__(
        self,
        process_id: int | None = None,
        n_processes: int | None = None,
        first_port: int | None = None,
        host: str = "127.0.0.1",
        connect_timeout: float = 60.0,
    ):
        self.process_id = (
            process_id
            if process_id is not None
            else int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        )
        self.n = (
            n_processes
            if n_processes is not None
            else int(os.environ.get("PATHWAY_PROCESSES", "1"))
        )
        self.first_port = (
            first_port
            if first_port is not None
            else int(os.environ.get("PATHWAY_FIRST_PORT", "10000"))
        )
        self.host = host
        self.peers = [p for p in range(self.n) if p != self.process_id]
        self._send_socks: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._cv = threading.Condition()
        self._data: dict[tuple[int, int, int], list] = {}  # (node, round, proc)
        self._ctl: dict[tuple[int, int], tuple[bool, bool, int]] = {}  # (round, proc)
        self._nego: dict[tuple[str, int], Any] = {}  # (tag, proc) -> value
        # frontier-mode state (engine/runtime.py run_mesh):
        #   _inbox  — arrival-ordered (wire, time, peer) keys of buckets
        #             awaiting the pump (payloads stay in _data);
        #   _wm     — (wire, peer) -> that peer's announced watermark for
        #             the wire: nothing at or below it will arrive again;
        #   _flags  — (tag, peer) -> small monotone control values
        #             (fence numbers, done markers).
        self.frontier_inbox = False
        self._inbox: list[tuple[int, int, int]] = []
        self._wm: dict[tuple[int, int], Any] = {}
        self._flags: dict[tuple[Any, int], Any] = {}
        self._dead: set[int] = set()
        # monotone count of data frames this process ever sent: the
        # quiesce protocol's "nothing new in flight" witness
        # (engine/runtime.py _mesh_quiesce)
        self.data_frames_sent = 0
        # wire accounting (docs/parallelism.md): pickle-stream vs
        # out-of-band bytes — oob is the zero-copy share protocol-5
        # buffer_callback moved out of the pickle stream
        self.stats = {
            "frames_sent": 0,
            "frames_recv": 0,
            "bytes_sent": 0,
            "bytes_recv": 0,
            "oob_buffers_sent": 0,
            "oob_bytes_sent": 0,
        }
        self._closed = False
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, self.first_port + self.process_id))
        self._listener.listen(self.n)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        self._connect_all(connect_timeout)

    # ------------------------------------------------------------ plumbing

    def _connect_all(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for p in self.peers:
            while True:
                try:
                    s = socket.create_connection(
                        (self.host, self.first_port + p), timeout=5.0
                    )
                    # the 5 s bound is the connect's: a send to a live peer
                    # that drains slowly (a large frame, a busy receiver)
                    # waits, as a barrier waits for a slow peer; a dead
                    # peer fails the send with a socket error
                    s.settimeout(None)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    s.sendall(_LEN.pack(8) + self.process_id.to_bytes(8, "little"))
                    self._send_socks[p] = s
                    self._send_locks[p] = _lockgraph.register_lock(
                        "mesh.send", threading.Lock()
                    )
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"process {self.process_id}: peer {p} did not "
                            f"come up on port {self.first_port + p}"
                        ) from None
                    time.sleep(0.1)

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._recv_loop, args=(conn,), daemon=True
            ).start()

    def _recv_exact(self, conn: socket.socket, n: int) -> bytearray | None:
        """`n` bytes into one buffer, in time linear in `n` (a frame of
        embeddings runs to tens of MB)."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = conn.recv_into(view[got:])
            if not k:
                return None
            got += k
        return buf

    def _recv_loop(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = self._recv_exact(conn, _LEN.size)
        if hello is None:
            return
        peer_bytes = self._recv_exact(conn, _LEN.unpack(hello)[0])
        if peer_bytes is None:
            return
        peer = int.from_bytes(peer_bytes, "little")
        try:
            while True:
                head = self._recv_exact(conn, _LEN.size)
                if head is None:
                    return
                body = self._recv_exact(conn, _LEN.unpack(head)[0])
                if body is None:
                    return
                kind, payload = self._decode_frame(body)
                if kind == "datat":
                    # trace-tagged data frame (sender had observability
                    # on): log the receive against the sender's context —
                    # joining both processes' dumps on (run, wire, time,
                    # seq) reconstructs the wave's cross-worker timeline
                    node_id_t, rnd_t, entries_t, ctx = payload
                    plane = _obs.PLANE
                    if plane is not None:
                        plane.record(
                            "mesh.recv", export=False, wire=node_id_t,
                            t=rnd_t, frm=peer, run=ctx[0], seq=ctx[2],
                        )
                    kind, payload = "data", (node_id_t, rnd_t, entries_t)
                with self._cv:
                    if kind == "data":
                        node_id, rnd, entries = payload
                        self._data[(node_id, rnd, peer)] = entries
                        if self.frontier_inbox:
                            self._inbox.append((node_id, rnd, peer))
                    elif kind == "nego":
                        tag, value = payload
                        self._nego[(tag, peer)] = value
                    elif kind == "wm":
                        wire, value = payload
                        key = (wire, peer)
                        if value > self._wm.get(key, -1):
                            self._wm[key] = value
                    elif kind == "flag":
                        tag, value = payload
                        key = (tag, peer)
                        old = self._flags.get(key)
                        if old is None or value > old:
                            self._flags[key] = value
                    else:  # ctl
                        rnd, has_data, done, t_hint = payload
                        self._ctl[(rnd, peer)] = (has_data, done, t_hint)
                    self._cv.notify_all()
        finally:
            if not self._closed:
                # worker failure detection: a vanished peer unblocks every
                # barrier with a clear error instead of hanging forever
                with self._cv:
                    self._dead.add(peer)
                    self._cv.notify_all()

    def _decode_frame(self, body: bytes | bytearray) -> tuple:
        """Inverse of ``_send``'s framing. Out-of-band buffers are handed
        to pickle as memoryviews of the receive block — reconstructed
        numpy arrays alias it (no per-array copy; the block stays alive
        through their refcounts)."""
        st = self.stats
        st["frames_recv"] += 1
        st["bytes_recv"] += len(body) + _LEN.size
        mv = memoryview(body)
        n_bufs = _LEN.unpack_from(mv, 0)[0]
        pkl_len = _LEN.unpack_from(mv, _LEN.size)[0]
        pos = 2 * _LEN.size
        pkl = mv[pos : pos + pkl_len]
        pos += pkl_len
        bufs = []
        for _ in range(n_bufs):
            blen = _LEN.unpack_from(mv, pos)[0]
            pos += _LEN.size
            bufs.append(mv[pos : pos + blen])
            pos += blen
        # noqa: S301 — trusted mesh
        return pickle.loads(pkl, buffers=bufs)

    def _send(self, peer: int, kind: str, payload: Any) -> None:
        # injected wire failure: surfaces to the caller exactly like a
        # peer socket error would (the supervisor path, not a hang)
        faults.check("mesh.send")
        bufs: list[pickle.PickleBuffer] = []
        pkl = pickle.dumps(
            (kind, payload), protocol=5, buffer_callback=bufs.append
        )
        raws = [b.raw() for b in bufs]
        oob = sum(r.nbytes for r in raws)
        total = 2 * _LEN.size + len(pkl) + sum(
            _LEN.size + r.nbytes for r in raws
        )
        head = _LEN.pack(total) + _LEN.pack(len(raws)) + _LEN.pack(len(pkl))
        st = self.stats
        st["frames_sent"] += 1
        st["bytes_sent"] += total + _LEN.size
        st["oob_buffers_sent"] += len(raws)
        st["oob_bytes_sent"] += oob
        with self._send_locks[peer]:
            sock = self._send_socks[peer]
            sock.sendall(head + pkl)
            for r in raws:  # zero-copy: each buffer goes straight out
                sock.sendall(_LEN.pack(r.nbytes))
                sock.sendall(r)

    # ------------------------------------------------------------ exchange

    def send_bucket(self, peer: int, node_id: int, rnd: int, entries: list) -> None:
        self.data_frames_sent += 1
        plane = _obs.PLANE
        if plane is None:
            self._send(peer, "data", (node_id, rnd, entries))
            return
        # tag the frame with trace context: (run_id, sender, seq). The
        # receiver logs the same tuple on arrival, so one dump per
        # process is enough to reconstruct a wave's cross-worker path
        ctx = (plane.run_id, self.process_id, plane.next_seq())
        plane.record(
            "mesh.send", export=False, wire=node_id, t=rnd, to=peer,
            seq=ctx[2],
        )
        self._send(peer, "datat", (node_id, rnd, entries, ctx))

    def recv_bucket(self, peer: int, node_id: int, rnd: int) -> list:
        """Blocks until the peer's bucket arrives. A slow peer is waited
        for indefinitely (with periodic warnings — a barrier must not
        kill a healthy-but-slow pipeline); a DEAD peer (socket closed)
        raises immediately."""
        key = (node_id, rnd, peer)
        waited = 0.0
        with self._cv:
            while key not in self._data:
                if peer in self._dead:
                    raise WorkerLost(
                        f"process {self.process_id}: peer {peer} died "
                        f"(waiting for node {node_id} round {rnd})"
                    )
                self._cv.wait(60.0)
                waited += 60.0
                if key not in self._data and peer not in self._dead and waited % 300.0 == 0.0:
                    import logging

                    logging.getLogger("pathway_tpu_torch.mesh").warning(
                        "process %d still waiting for peer %d (node %d, "
                        "round %d, %.0fs)",
                        self.process_id, peer, node_id, rnd, waited,
                    )
            return self._data.pop(key)

    # ------------------------------------------------------------- control

    def control_round(
        self, rnd: int, has_data: bool, done: bool, t_hint: int = 0
    ) -> tuple[bool, bool, int]:
        """Broadcast this process's round flags and gather every peer's.
        Returns (any_has_data, all_done, max_t_hint) — identical on every
        process. `t_hint` carries scripted static timestamps so wave
        times agree across processes even though only process 0 holds the
        scripted batches. Dead peers raise; slow peers are waited for."""
        for p in self.peers:
            self._send(p, "ctl", (rnd, has_data, done, t_hint))
        any_data, all_done, t_max = has_data, done, t_hint
        with self._cv:
            for p in self.peers:
                while (rnd, p) not in self._ctl:
                    if p in self._dead:
                        raise WorkerLost(
                            f"process {self.process_id}: peer {p} died "
                            f"(control round {rnd})"
                        )
                    self._cv.wait(60.0)
                p_data, p_done, p_hint = self._ctl.pop((rnd, p))
                any_data = any_data or p_data
                all_done = all_done and p_done
                t_max = max(t_max, p_hint)
        return any_data, all_done, t_max

    def allgather(self, tag: str, value: Any) -> dict[int, Any]:
        """One-shot all-gather of a small value under a unique tag (e.g.
        checkpoint-epoch negotiation at startup). Returns proc -> value
        for every process including this one."""
        for p in self.peers:
            self._send(p, "nego", (tag, value))
        out = {self.process_id: value}
        with self._cv:
            for p in self.peers:
                while (tag, p) not in self._nego:
                    if p in self._dead:
                        raise WorkerLost(
                            f"process {self.process_id}: peer {p} died "
                            f"(negotiating {tag!r})"
                        )
                    self._cv.wait(60.0)
                out[p] = self._nego.pop((tag, p))
        return out

    # ------------------------------------------------- frontier protocol

    def enable_frontier_inbox(self) -> None:
        """Start routing data frames to the inbox. Buckets that arrived
        BEFORE the flag flipped (a peer's pump can outrun this one's
        startup) are swept in, so nothing sent early is lost."""
        with self._cv:
            if not self.frontier_inbox:
                self.frontier_inbox = True
                pending = set(self._inbox)
                self._inbox.extend(
                    k for k in self._data if k not in pending
                )

    def take_frontier_updates(self):
        """Atomically snapshot peer watermarks and drain the data inbox.

        The watermark view is captured in the same critical section as
        the inbox drain: because each peer's frames arrive in send order
        and are stored under this lock, any watermark visible in the
        snapshot has every bucket it covers already drained here — the
        pump can trust the announcement."""
        with self._cv:
            wm = dict(self._wm)
            keys, self._inbox = self._inbox, []
            buckets = [
                (wire, t, peer, self._data.pop((wire, t, peer)))
                for (wire, t, peer) in keys
                if (wire, t, peer) in self._data
            ]
        return wm, buckets

    def restore_bucket(self, wire: int, rnd: Any, peer: int, payload: Any) -> None:
        """Put a drained bucket back for keyed retrieval (a peer that
        reached the end barrier first tags buckets with ('end', t);
        they belong to recv_bucket, not the frontier pump)."""
        with self._cv:
            self._data[(wire, rnd, peer)] = payload
            self._cv.notify_all()

    def send_wm(self, wire: int, value: Any) -> None:
        """Announce this process's watermark for an outgoing wire."""
        for p in self.peers:
            self._send(p, "wm", (wire, value))

    def send_flag(self, tag: Any, value: Any) -> None:
        """Broadcast a small monotone control value (fence/done)."""
        for p in self.peers:
            self._send(p, "flag", (tag, value))

    def set_flag(self, tag: Any, value: Any) -> None:
        """Record this process's own flag (so flag_value sees it too)."""
        with self._cv:
            key = (tag, self.process_id)
            old = self._flags.get(key)
            if old is None or value > old:
                self._flags[key] = value

    def flag_of(self, tag: Any, peer: int, default: Any = None) -> Any:
        with self._cv:
            return self._flags.get((tag, peer), default)

    def flag_value(self, tag: Any, default: Any = None) -> Any:
        """Max of the flag across every process that has set it."""
        with self._cv:
            vals = [
                v for (t, _p), v in self._flags.items() if t == tag
            ]
        return max(vals) if vals else default

    def wait_frames(self, timeout: float) -> None:
        """Sleep until a new frame arrives (or the timeout elapses) —
        the frontier pump's idle wait, so remote progress wakes it."""
        with self._cv:
            self._cv.wait(timeout)

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        for s in self._send_socks.values():
            try:
                s.close()
            except OSError:
                pass


_MESH: ProcessMesh | None = None
_MESH_LOCK = _lockgraph.register_lock("mesh.registry", threading.Lock())


def get_mesh() -> ProcessMesh | None:
    """Process-wide mesh singleton: one socket fabric per process shared
    by every session (exchange nodes namespace their wire ids). None when
    PATHWAY_PROCESSES <= 1."""
    global _MESH
    if int(os.environ.get("PATHWAY_PROCESSES", "1")) <= 1:
        return None
    with _MESH_LOCK:
        if _MESH is None:
            _MESH = ProcessMesh()
    return _MESH


__all__ = ["ProcessMesh", "WorkerLost", "get_mesh"]
