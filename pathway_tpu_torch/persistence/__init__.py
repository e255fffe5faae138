"""Persistence: operator snapshots + frontier metadata + input journals.

Reference parity: src/persistence/ —
  * operator snapshots with compaction (operator_snapshot.rs:1) →
    `OperatorSnapshotStore` (per-node typed-binary state with crc
    framing — codec.py, the bincode equivalent — one file per epoch,
    old epochs deleted after the metadata commit),
  * metadata / finalized-frontier store (state.rs:35 MetadataAccessor) →
    `MetadataStore` (per-connector committed offsets + epoch, written
    fsync-then-atomic-rename so a crash never yields a torn commit),
  * per-source offset frontiers (frontier.rs OffsetAntichain) →
    per-connector event offsets in segmented journals (`*.N.seg`,
    N = first event offset in the segment),
plus python/pathway/persistence/__init__.py (Backend :27, Config :88) for
the user-facing API.

Recovery order (reference: worker.rs bootstrap): metadata → operator
state → journal tail. The journal head covered by the snapshot epoch is
deleted at checkpoint time (compaction), so resume replays only the tail
— O(new events), not O(history).

Modes:
  * pipeline signature matches + snapshot epoch valid → restore operator
    states, replay journal events at offsets ≥ committed, seek live
    sources past everything journaled.
  * signature mismatch (pipeline changed / PATHWAY_THREADS changed /
    native kernel toggled) → fall back to FULL journal replay if the head
    still exists; otherwise fail with a clear error instead of silently
    recomputing wrong state.
"""

from __future__ import annotations

import hashlib
import json as _json
import os
import time as _time
from typing import Any

from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals.keys import Key
from pathway_tpu_torch.persistence import codec


class Backend:
    kind = "mock"

    def __init__(self, path: str | None = None):
        self.path = path

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        b = cls(os.fspath(path))
        b.kind = "filesystem"
        return b

    @classmethod
    def s3(
        cls,
        root_path: str,
        bucket_settings: Any = None,
        *,
        bucket: str | None = None,
        client: Any = None,
    ) -> "Backend":
        """Object-store persistence (reference: src/persistence/backends/
        s3.rs). The run stages through a local directory; every checkpoint
        syncs changed journal segments / operator snapshots up and commits
        `metadata.json` LAST (the S3 linearization point), and attach
        rebuilds the staging directory from the bucket, so a fresh host
        resumes from object storage alone.

        `bucket_settings`: pw.io.s3.AwsS3Settings (boto3-gated);
        `client`: injected boto3-compatible client (tests / custom auth);
        PATHWAY_S3_FAKE_DIR routes to the built-in directory-backed fake
        (dev machines without S3)."""
        b = cls(root_path.strip("/"))
        b.kind = "s3"
        fake_dir = os.environ.get("PATHWAY_S3_FAKE_DIR")
        if client is None and fake_dir:
            client = _DirS3Client(fake_dir)
            # bucket id doubles as the staging-dir key: make it unique
            # per fake directory so concurrent test runs never share one
            bucket = bucket or fake_dir
        if client is None:
            if bucket_settings is None:
                raise ValueError(
                    "Backend.s3 needs bucket_settings (pw.io.s3."
                    "AwsS3Settings) or an injected client"
                )
            client = bucket_settings.client()
            bucket = bucket or bucket_settings.bucket_name
        if not bucket:
            raise ValueError(
                "Backend.s3 with an injected client needs bucket=..."
            )
        b.s3_client = client
        b.s3_bucket = bucket
        return b

    @classmethod
    def azure(
        cls,
        root_path: str,
        account_settings: Any = None,
        *,
        container: str | None = None,
        connection_string: str | None = None,
        client: Any = None,
    ) -> "Backend":
        """Azure Blob persistence (reference: src/persistence/backends/
        — object-store family). Same staged-sync design as Backend.s3:
        checkpoints upload changed files with metadata.json LAST, attach
        pulls the container state. `client` may be an injected
        S3-shaped client (put/get/list/delete — tests, custom auth) or an
        azure.storage.blob ContainerClient (adapted); PATHWAY_AZURE_FAKE_DIR
        routes to the directory-backed fake on dev machines."""
        b = cls(root_path.strip("/"))
        b.kind = "s3"  # the staged-sync path is object-store-generic
        fake_dir = os.environ.get("PATHWAY_AZURE_FAKE_DIR")
        if client is None and fake_dir:
            client = _DirS3Client(fake_dir)
            container = container or fake_dir
        if client is None:
            if connection_string is None and account_settings is None:
                raise ValueError(
                    "Backend.azure needs a connection_string, "
                    "account_settings, or an injected client"
                )
            if not container:
                # guard BEFORE client construction: the SDK's own error
                # for a missing container name is opaque
                raise ValueError("Backend.azure needs container=...")
            try:
                from azure.storage.blob import ContainerClient
            except ImportError as e:
                raise ImportError(
                    "Backend.azure needs azure-storage-blob: "
                    "`pip install azure-storage-blob`"
                ) from e
            if connection_string is not None:
                cc = ContainerClient.from_connection_string(
                    connection_string, container_name=container
                )
            else:
                cc = account_settings.container_client(container)
            client = _AzureContainerAdapter(cc)
        elif not hasattr(client, "put_object") and hasattr(
            client, "upload_blob"
        ):
            client = _AzureContainerAdapter(client)
            container = container or "azure"
        if not container:
            raise ValueError(
                "Backend.azure with an injected client needs container=..."
            )
        b.s3_client = client
        b.s3_bucket = container
        return b

    @classmethod
    def mock(cls, events: Any = None) -> "Backend":
        return cls(None)


class Config:
    def __init__(
        self,
        backend: Backend | None = None,
        *,
        snapshot_interval_ms: int = 0,
        persistence_mode: str = "PERSISTING",
        snapshot_access: Any = None,
        continue_after_replay: bool = True,
        operator_snapshots: bool = True,
    ):
        self.backend = backend or Backend.mock()
        self.snapshot_interval_ms = snapshot_interval_ms
        self.persistence_mode = persistence_mode
        self.continue_after_replay = continue_after_replay
        # UDF-cache-only mode (serving processes) skips input journaling
        # and operator snapshots entirely
        self.operator_snapshots = operator_snapshots and persistence_mode not in (
            "UDF_CACHING",
            "udf_caching",
        )

    def with_backend(self, backend: Backend) -> "Config":
        """Same settings against another backend (mesh per-process roots,
        S3 staging redirection)."""
        return Config(
            backend,
            snapshot_interval_ms=self.snapshot_interval_ms,
            persistence_mode=self.persistence_mode,
            continue_after_replay=self.continue_after_replay,
            operator_snapshots=self.operator_snapshots,
        )

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs: Any) -> "Config":
        return cls(backend, **kwargs)

    @classmethod
    def udf_caching(cls, backend: Backend) -> "Config":
        """Cache-only persistence for serving processes: UDF results are
        cached under the backend, but no input journaling / replay /
        operator snapshots are attached (reference: udf caching mode)."""
        return cls(backend, persistence_mode="UDF_CACHING")


class _DirS3Client:
    """Directory-backed stand-in for the boto3 S3 surface the sync layer
    uses (put/get/list/delete) — the mocked-S3 test target and a dev
    shim; enable via PATHWAY_S3_FAKE_DIR."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "\x01"))

    def put_object(self, Bucket: str, Key: str, Body: bytes) -> None:  # noqa: N803
        _fsync_write(self._p(Key), Body)

    def get_object(self, Bucket: str, Key: str) -> dict:  # noqa: N803
        import io as _io

        p = self._p(Key)
        if not os.path.exists(p):
            raise KeyError(Key)
        with open(p, "rb") as f:
            return {"Body": _io.BytesIO(f.read())}

    def delete_object(self, Bucket: str, Key: str) -> None:  # noqa: N803
        try:
            os.unlink(self._p(Key))
        except OSError:
            pass

    def list_objects_v2(self, Bucket: str, Prefix: str = "", **kw: Any) -> dict:  # noqa: N803
        out = []
        for fn in sorted(os.listdir(self.root)):
            key = fn.replace("\x01", "/")
            if key.startswith(Prefix):
                out.append({"Key": key, "Size": os.path.getsize(os.path.join(self.root, fn))})
        return {"Contents": out} if out else {}


class _AzureContainerAdapter:
    """azure.storage.blob ContainerClient -> the S3-shaped client surface
    the staged sync uses (put/get/list/delete). The Bucket parameter is
    ignored: a ContainerClient is already bound to its container."""

    def __init__(self, container_client: Any):
        self._cc = container_client

    def put_object(self, Bucket: str, Key: str, Body: bytes) -> None:  # noqa: N803
        self._cc.upload_blob(Key, Body, overwrite=True)

    def get_object(self, Bucket: str, Key: str) -> dict:  # noqa: N803
        import io as _io

        data = self._cc.download_blob(Key).readall()
        return {"Body": _io.BytesIO(data)}

    def delete_object(self, Bucket: str, Key: str) -> None:  # noqa: N803
        try:
            self._cc.delete_blob(Key)
        except Exception as e:  # noqa: BLE001
            # only blob-not-found is ignorable (idempotent deletes);
            # auth/network failures must surface, else compaction
            # silently stops freeing the container. Name-matched so the
            # azure sdk stays an optional dependency.
            if type(e).__name__ not in ("ResourceNotFoundError", "KeyError"):
                raise

    def list_objects_v2(self, Bucket: str, Prefix: str = "", **kw: Any) -> dict:  # noqa: N803
        out = [
            {"Key": b.name, "Size": getattr(b, "size", 0)}
            for b in self._cc.list_blobs(name_starts_with=Prefix)
        ]
        return {"Contents": out} if out else {}


class _S3Sync:
    """Staging-directory <-> object-store synchronizer.

    Layout: every file under the local root maps to `{root_path}/{rel}`.
    `pull` resets the staging dir from the bucket (S3 is the source of
    truth on attach); `push` uploads new/changed files and deletes
    removed ones, with metadata.json strictly LAST so a crash mid-push
    leaves the previous epoch intact and readable.
    """

    def __init__(self, client: Any, bucket: str, root_path: str, local: str):
        self.client = client
        self.bucket = bucket
        self.prefix = root_path.strip("/") + "/"
        self.local = local
        self._pushed: dict[str, tuple[float, int]] = {}

    def _keys(self) -> list[str]:
        resp = self.client.list_objects_v2(Bucket=self.bucket, Prefix=self.prefix)
        return [c["Key"] for c in resp.get("Contents", [])]

    def pull(self) -> None:
        import shutil

        if os.path.exists(self.local):
            shutil.rmtree(self.local)
        os.makedirs(self.local, exist_ok=True)
        self._pushed.clear()
        for key in self._keys():
            rel = key[len(self.prefix):]
            dst = os.path.join(self.local, rel)
            os.makedirs(os.path.dirname(dst) or self.local, exist_ok=True)
            body = self.client.get_object(Bucket=self.bucket, Key=key)["Body"].read()
            with open(dst, "wb") as f:
                f.write(body)
            st = os.stat(dst)
            self._pushed[rel] = (st.st_mtime, st.st_size)

    def push(self) -> None:
        current: dict[str, tuple[float, int]] = {}
        meta_rel = None
        for dirpath, _dirs, files in os.walk(self.local):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, self.local)
                st = os.stat(p)
                current[rel] = (st.st_mtime, st.st_size)
        ordered = sorted(current)
        for rel in ordered:
            if rel == MetadataStore.FILE:
                meta_rel = rel
                continue
            if self._pushed.get(rel) != current[rel]:
                with open(os.path.join(self.local, rel), "rb") as f:
                    self.client.put_object(
                        Bucket=self.bucket, Key=self.prefix + rel, Body=f.read()
                    )
        # deletions (compacted segments / old snapshots)
        for rel in list(self._pushed):
            if rel not in current:
                self.client.delete_object(
                    Bucket=self.bucket, Key=self.prefix + rel
                )
        # the commit point: metadata.json goes up last, and ALWAYS — an
        # (mtime, size) quick-check could skip a same-size rewrite on
        # coarse-timestamp filesystems and strand the bucket one epoch
        # behind; the file is tiny
        if meta_rel is not None:
            with open(os.path.join(self.local, meta_rel), "rb") as f:
                self.client.put_object(
                    Bucket=self.bucket, Key=self.prefix + meta_rel, Body=f.read()
                )
        self._pushed = current


def _fsync_write(path: str, data: bytes) -> None:
    """Write atomically: tmp file, fsync, rename, fsync dir."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in name)


class SegmentedJournal:
    """Per-connector append-only event log in offset-addressed segments.

    Events are globally numbered per connector; segment `{name}.{N}.seg`
    holds events starting at offset N. At each checkpoint the current
    segment rolls over and fully-committed older segments are deleted
    (compaction) once the operator snapshot covering them is durable.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _segments(self, name: str) -> list[tuple[int, str]]:
        pre = _safe(name) + "."
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith(pre) and fn.endswith(".seg"):
                try:
                    start = int(fn[len(pre):-4])
                except ValueError:
                    continue
                out.append((start, os.path.join(self.root, fn)))
        return sorted(out)

    def load_from(self, name: str, offset: int) -> list[tuple[int, Any, tuple, int]]:
        """All journaled events with global offset >= `offset`, as
        (offset, key_value, row, diff). Records are typed-binary with
        per-record crc (codec.py); a torn tail stops the read."""
        out: list[tuple[int, Any, tuple, int]] = []
        for start, path in self._segments(name):
            pos = start
            with open(path, "rb") as f:
                buf = f.read()
            for (kv, row, diff) in codec.read_records(buf, with_magic=True):
                if pos >= offset:
                    out.append((pos, kv, row, diff))
                pos += 1
        return out

    def head_offset(self, name: str) -> int:
        """Offset of the first surviving journal event (>0 after compaction)."""
        segs = self._segments(name)
        return segs[0][0] if segs else 0

    def total_events(self, name: str) -> int:
        segs = self._segments(name)
        if not segs:
            return 0
        last_start, last_path = segs[-1]
        with open(last_path, "rb") as f:
            buf = f.read()
        return last_start + codec.count_records(buf, with_magic=True)

    def open_segment(self, name: str, start: int):
        return _SegmentWriter(
            os.path.join(self.root, f"{_safe(name)}.{start}.seg"), start
        )

    def truncate_to(self, name: str, offset: int) -> None:
        """Remove journaled events at or past `offset`: whole segments
        unlink, the covering segment rewrites in place (atomic) keeping
        its prefix byte-exactly. The outbox uses this to discard a
        staged-but-unsealed WAL tail on recovery (io/outbox.py)."""
        for start, path in self._segments(name):
            if start >= offset:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            with open(path, "rb") as f:
                buf = f.read()
            recs = list(codec.read_records(buf, with_magic=True))
            if start + len(recs) <= offset:
                continue
            keep = recs[: offset - start]
            blob = codec.MAGIC + b"".join(
                codec.encode_record(r) for r in keep
            )
            _fsync_write(path, blob)

    def size_bytes(self, name: str) -> int:
        """On-disk bytes held by this connector's surviving segments."""
        total = 0
        for _start, path in self._segments(name):
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total

    def compact(self, name: str, committed: int) -> int:
        """Delete segments whose every event is < committed (covered by a
        durable operator snapshot). Returns number of segments removed."""
        segs = self._segments(name)
        removed = 0
        for i, (start, path) in enumerate(segs):
            end = segs[i + 1][0] if i + 1 < len(segs) else None
            if end is not None and end <= committed:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        return removed


class _SegmentWriter:
    def __init__(self, path: str, start: int):
        self.path = path
        self.start = start
        self.count = 0
        self._f = open(path, "ab")
        pos = self._f.tell()
        if pos >= len(codec.MAGIC):
            with open(path, "rb") as rf:
                head = rf.read(len(codec.MAGIC))
            if head != codec.MAGIC:
                # foreign/legacy layout: refuse, exactly like the reader —
                # truncating would destroy data the read path protects
                self._f.close()
                raise ValueError(
                    f"journal segment {path} is not in the typed-binary "
                    "layout; refusing to append"
                )
        if pos > 0:
            # reopening after a crash: drop any torn tail (partial MAGIC
            # or a torn trailing frame) BEFORE appending — new events
            # written beyond the torn point would sit past where every
            # reader stops, silently unreadable
            with open(path, "rb") as rf:
                good = codec.valid_prefix_len(rf.read(), with_magic=True)
            if good < pos:
                self._f.close()
                with open(path, "r+b") as tf:
                    tf.truncate(good)
                self._f = open(path, "ab")
                pos = good
        if pos == 0:
            self._f.write(codec.MAGIC)  # format header on fresh segments

    @property
    def next_offset(self) -> int:
        return self.start + self.count

    def append(self, key_value: int, row: tuple, diff: int) -> None:
        self._f.write(codec.encode_record((key_value, row, diff)))
        self.count += 1
        if faults.fire("persistence.journal.torn"):
            # an OS-level crash that loses the tail of a flushed-but-not-
            # fsynced segment: leave a partial trailing frame and die.
            # Reopen drops the torn tail (valid_prefix_len) and seekable
            # sources re-journal the lost events from their own re-read.
            self._f.flush()
            pos = self._f.tell()
            self._f.close()
            with open(self.path, "r+b") as tf:
                tf.truncate(max(pos - 7, len(codec.MAGIC)))
            faults.hard_crash()

    def flush(self, sync: bool = False) -> None:
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


class MetadataStore:
    """The finalized-frontier record: which epoch of operator snapshots is
    durable and which journal offset each connector is committed to."""

    FILE = "metadata.json"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, self.FILE)

    def load(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                return _json.load(f)
        except OSError:
            return None
        except ValueError as e:
            # the commit path is fsync-then-atomic-rename, so a crash never
            # leaves this file torn; unparsable content means external
            # corruption — silently treating it as "no checkpoint" would
            # cold-start and drop committed state. Fail loudly instead.
            raise RuntimeError(
                f"persistence metadata {self.path} is corrupt ({e}); "
                "restore it from a copy or clear the persistence "
                "directory to cold-start"
            ) from e

    _UNSET = object()

    def commit(
        self,
        epoch: int,
        offsets: dict[str, int],
        signature: str,
        finalized_time: int,
        prev: "dict | None | object" = _UNSET,
        frontiers: dict | None = None,
        op_snapshots: list[str] | None = None,
        outbox: dict[str, int] | None = None,
    ) -> None:
        record = {
            "epoch": epoch,
            "offsets": offsets,
            "signature": signature,
            "finalized_time": finalized_time,
            # per-source offset frontiers (seekable sources: the source
            # seeks here on resume instead of journaling every event —
            # reference: src/persistence/frontier.rs OffsetAntichain)
            "frontiers": frontiers or {},
            "committed_at": _time.time(),
        }
        if outbox is not None:
            # per-sink SEALED outbox offsets: this commit is the
            # transactional-sink linearization point — staged output at
            # or below these offsets WILL be delivered exactly once
            # (io/outbox.py), anything past them is discarded on restart
            record["outbox"] = outbox
        if op_snapshots is not None:
            # manifest of operator snapshots this epoch WROTE: restore
            # distinguishes "stateless node" (absent here) from "snapshot
            # file lost" (listed but unreadable -> fall back an epoch)
            record["op_snapshots"] = op_snapshots
        # keep the PREVIOUS epoch's record: multi-process recovery may
        # need to roll back one epoch when peers crashed between each
        # other's commits (coordinated-recovery min-epoch negotiation).
        # Callers that already hold the previous record pass it in (one
        # consistent snapshot, one read); prev=None means "no history"
        # (rollback rewrite).
        if prev is MetadataStore._UNSET:
            prev = self.load()
        if prev is not None:
            record["history"] = [
                {k: prev[k] for k in
                 ("epoch", "offsets", "signature", "finalized_time",
                  "frontiers", "op_snapshots", "outbox")
                 if k in prev}
            ]
        blob = _json.dumps(record).encode()
        if faults.fire("persistence.metadata.torn"):
            # the crash the atomic rename protects against: half the
            # record reaches the tmp file and the process dies before the
            # rename — recovery must find the PREVIOUS record intact
            with open(self.path + ".tmp", "wb") as f:
                f.write(blob[: len(blob) // 2])
            faults.hard_crash()
        _fsync_write(self.path, blob)

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def record_for(self, epoch: int) -> dict | None:
        meta = self.load()
        if meta is None:
            return None
        if int(meta.get("epoch", -1)) == epoch:
            return meta
        for rec in meta.get("history", []):
            if int(rec.get("epoch", -1)) == epoch:
                return rec
        return None


class OperatorSnapshotStore:
    """Typed-binary per-operator state, one file per (node, epoch), with
    a crc frame so a corrupt snapshot is detected at read time (phase 1
    of restore falls back to journal replay)."""

    def __init__(self, root: str):
        self.root = os.path.join(root, "operator")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, pid: str, epoch: int) -> str:
        return os.path.join(self.root, f"{_safe(pid)}.{epoch}.state")

    def write(self, pid: str, epoch: int, state: dict) -> None:
        _fsync_write(
            self._path(pid, epoch), codec.encode_record(state, with_magic=True)
        )

    def read(self, pid: str, epoch: int) -> dict | None:
        p = self._path(pid, epoch)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            buf = f.read()
        for state in codec.read_records(buf, with_magic=True):
            return state
        raise ValueError(f"operator snapshot {p} is corrupt or torn")

    def compact(self, keep_epochs: set[int]) -> None:
        keep = set(keep_epochs)
        for fn in os.listdir(self.root):
            if not fn.endswith(".state"):
                continue
            try:
                epoch = int(fn.rsplit(".", 2)[-2])
            except (ValueError, IndexError):
                continue
            if epoch not in keep:
                try:
                    os.unlink(os.path.join(self.root, fn))
                except OSError:
                    pass


def _pipeline_signature(graph: Any, exchange_n: int | None = None) -> str:
    """Stable id of the lowered pipeline: node order + each operator's
    semantic signature (class, mode, reducer set, widths, …) + native
    kernel availability. A change means persisted operator state cannot
    be mapped back onto the graph. Deliberately NOT included: the worker
    count — snapshots re-partition across PATHWAY_THREADS changes (see
    engine/core.py shard-rescale protocol; the reference pins `-w`).

    ``exchange_n`` substitutes a different process count into the
    ProcessExchangeNode signatures: elastic rebalance (parallel/
    membership.py) stages metadata that the NEXT generation — lowered at
    the new mesh size — must accept, so it computes the signature that
    generation will compute rather than its own."""
    from pathway_tpu_torch.engine import native
    from pathway_tpu_torch.engine.workers import ProcessExchangeNode

    from pathway_tpu_torch.internals.fingerprint import fingerprint_spec

    parts = [f"native={native.available()}"]
    for node in graph.nodes:
        fp = getattr(node, "state_fingerprint", None)
        if fp is None:
            spec = getattr(node, "_fingerprint_spec", None)
            fp = fingerprint_spec(spec) if spec is not None else ""
            node.state_fingerprint = fp  # cache for repeat signatures
        sig = node.persist_signature()
        if exchange_n is not None and isinstance(node, ProcessExchangeNode):
            sig = f"ProcessExchange/{exchange_n}/{int(node.route is None)}"
        parts.append(f"{node.node_id}:{sig}:{fp}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _persistent_id(node: Any) -> str:
    # a ShardedNode is named after its inner operator so snapshots match
    # across worker counts (THREADS=1 builds the inner node directly)
    replicas = getattr(node, "replicas", None)
    inner = replicas[0] if replicas else node
    return f"n{node.node_id}-{type(inner).__name__}"


def _adapt_shard_state(node: Any, st: dict) -> dict:
    from pathway_tpu_torch.engine.workers import adapt_shard_state

    return adapt_shard_state(node, st)


def _validate_spill_manifests(st: Any, pid: str) -> None:
    """Phase-1 validation of every spill-run manifest embedded in a
    decoded snapshot. Semantic tamper (run missing from the listing,
    bad record totals) raises PlanVerificationError — restore REFUSES;
    file-level damage (missing/torn run segments) raises RuntimeError —
    restore falls back one epoch like any other unreadable snapshot."""
    from pathway_tpu_torch.engine import spill as _spill

    if _spill.is_manifest(st):
        _spill.verify_manifest(st, pid)
        _spill.validate_manifest_files(st)
        return
    if isinstance(st, dict):
        for v in st.values():
            _validate_spill_manifests(v, pid)
    elif isinstance(st, (list, tuple)):
        for v in st:
            _validate_spill_manifests(v, pid)


class CheckpointManager:
    """Orchestrates checkpoints: journal fsync → operator snapshots →
    metadata commit → compaction. Restores in the opposite order."""

    def __init__(self, session: Any, config: Config):
        self.session = session
        self.config = config
        root = config.backend.path
        assert root is not None
        self.journal = SegmentedJournal(root)
        self.metadata = MetadataStore(root)
        self.ops = OperatorSnapshotStore(root)
        # spilled arrangements (engine/spill.py) keep their runs under
        # the same persistence root so checkpoint manifests stay valid
        # across restarts; without persistence the runs live in a
        # per-process tempdir instead
        from pathway_tpu_torch.engine import spill as _spill

        _spill.set_root(root, persistent=True)
        self.signature = _pipeline_signature(session.graph)
        self.epoch = 0
        self._last_checkpoint = _time.monotonic()
        self._writers: dict[str, _SegmentWriter] = {}
        self._restored_offsets: dict[str, int] = {}
        # per-connector offset frontiers from the restored epoch (seekable
        # sources seek here instead of journal replay)
        self.restored_frontiers: dict[str, dict] = {}
        self.restored = False
        # transactional sinks (io/outbox.py): set by attach_persistence
        # when exactly-once mode is on; sealed offsets of the restored
        # epoch drive the replay negotiation
        self.outboxes: Any = None
        self.restored_outbox: dict[str, int] = {}

    # ------------------------------------------------------------ restore

    def latest_epoch(self) -> int:
        meta = self.metadata.load()
        return int(meta["epoch"]) if meta is not None else 0

    def restore(self, epoch: int | None = None) -> dict[str, int]:
        """Returns per-connector replay offsets ({} = cold start). Loads
        operator snapshots when the pipeline signature matches. `epoch`
        selects a specific committed epoch (multi-process recovery rolls
        back to the minimum epoch every process holds); default latest."""
        if epoch == 0:
            # agreed cold start (a peer has no checkpoint): ignore local
            # snapshots; the full journal replays — only sound if its head
            # survives. The stale metadata is wiped so the next commit
            # starts a fresh epoch chain consistent with the peers.
            meta0 = self.metadata.load()
            names = list(meta0["offsets"]) if meta0 else []
            for name in names:
                if self.journal.head_offset(name) > 0:
                    raise RuntimeError(
                        f"cold recovery needs the full journal for "
                        f"{name!r} but it was compacted; clear the "
                        "persistence directories to restart"
                    )
            self.metadata.clear()
            self.epoch = 0
            return {name: 0 for name in names}
        meta = (
            self.metadata.load()
            if epoch is None
            else self.metadata.record_for(epoch)
        )
        if meta is None:
            if epoch:
                raise RuntimeError(
                    f"checkpoint epoch {epoch} is not available locally; "
                    "clear the persistence directory to cold-start"
                )
            return {}
        offsets: dict[str, int] = {k: int(v) for k, v in meta["offsets"].items()}
        # the journal must still cover every offset this epoch needs —
        # silently-skipped missing head segments would drop events
        for name, off in offsets.items():
            head = self.journal.head_offset(name)
            if head > off:
                raise RuntimeError(
                    f"journal for {name!r} was compacted to offset {head}, "
                    f"past epoch {meta.get('epoch')}'s offset {off}; cannot "
                    "resume from this epoch. Clear the persistence "
                    "directories to restart."
                )
        # Candidate epochs, newest first. A negotiated epoch (multi-process
        # rollback) is exact — peers agreed on it, no deeper fallback; the
        # single-process default may fall back one epoch when the newest
        # snapshots turn out lost/corrupt (compaction keeps TWO epochs of
        # snapshots and journal back to the previous epoch's offsets for
        # exactly this degradation rung).
        candidates = [meta]
        if epoch is None:
            candidates += list(meta.get("history", []))
        if self.config.operator_snapshots:
            for i, rec in enumerate(candidates):
                if rec.get("signature") != self.signature:
                    continue
                offs = {k: int(v) for k, v in rec["offsets"].items()}
                if i > 0 and any(
                    self.journal.head_offset(n) > o for n, o in offs.items()
                ):
                    continue  # journal no longer covers this epoch
                restored = self._read_epoch_snapshots(rec)
                if restored is None:
                    continue
                if i > 0:
                    # logged only now that this epoch's snapshots READ —
                    # claiming a fallback that then fails its own phase-1
                    # validation would mislead recovery forensics
                    self.session.graph.log_error(
                        f"epoch {meta.get('epoch')} snapshots unusable; "
                        f"falling back to epoch {rec.get('epoch')}"
                    )
                # Phase 2 — apply. A failure here leaves earlier nodes
                # mutated; falling back to journal replay would double-
                # count their state, so fail loudly instead.
                applied = 0
                try:
                    for node, st in restored:
                        node.restore_state(st)
                        applied += 1
                except Exception as e:  # noqa: BLE001
                    raise RuntimeError(
                        f"operator state restore failed after {applied} of "
                        f"{len(restored)} operators ({e}); persisted state is "
                        "incompatible with this pipeline. Clear the "
                        "persistence directory or revert the change."
                    ) from e
                self.epoch = int(rec["epoch"])
                self.restored = True
                self._restored_offsets = offs
                self.restored_frontiers = dict(rec.get("frontiers", {}))
                self.restored_outbox = {
                    k: int(v) for k, v in rec.get("outbox", {}).items()
                }
                if epoch is not None or i > 0:
                    # rollback OR history fallback: rewrite the on-disk
                    # record to the epoch actually restored NOW, else the
                    # next commit would chain its history and journal-
                    # compaction floor off the stale newer record
                    # (unrecoverable on a second crash)
                    self.metadata.commit(
                        self.epoch,
                        offs,
                        str(rec.get("signature")),
                        int(rec.get("finalized_time", 0)),
                        prev=None,
                        frontiers=self.restored_frontiers,
                        op_snapshots=rec.get("op_snapshots"),
                        outbox=rec.get("outbox"),
                    )
                return offs
        # fall back to full journal replay — only sound if the head exists
        for name in offsets:
            head = self.journal.head_offset(name)
            if head > 0:
                raise RuntimeError(
                    f"persisted state for {name!r} was compacted up to offset "
                    f"{head} but the pipeline changed (signature mismatch); "
                    "cannot resume. Clear the persistence directory or revert "
                    "the pipeline/worker configuration."
                )
        if epoch is not None:
            # negotiated-epoch resume via full replay (snapshots disabled
            # or unusable): restart the epoch chain at 0 so every peer's
            # next commit agrees — leaving the stale record would desync
            # chains on the next crash
            self.metadata.clear()
            self.epoch = 0
        return {name: 0 for name in offsets}

    def _read_epoch_snapshots(
        self, rec: dict
    ) -> list[tuple[Any, dict]] | None:
        """Phase 1 of restore: read + validate every snapshot of `rec`'s
        epoch before touching any node, so failure falls back cleanly
        (nothing has been mutated). Returns None when the epoch is
        unusable: a snapshot is corrupt, un-adaptable, or listed in the
        epoch's manifest but missing on disk."""
        from pathway_tpu_torch.internals.verifier import PlanVerificationError

        epoch = int(rec["epoch"])
        manifest = rec.get("op_snapshots")
        restored: list[tuple[Any, dict]] = []
        try:
            for node in self.session.graph.nodes:
                pid = _persistent_id(node)
                st = self.ops.read(pid, epoch)
                if st is None:
                    if manifest is not None and pid in manifest:
                        raise RuntimeError(
                            f"operator snapshot {pid}.{epoch} is listed in "
                            "the epoch manifest but missing on disk"
                        )
                    continue  # stateless node: never snapshotted
                _validate_spill_manifests(st, pid)
                # worker-count changes re-partition here, BEFORE any node
                # mutates — RescaleUnsupported falls back cleanly
                restored.append((node, _adapt_shard_state(node, st)))
        except PlanVerificationError:
            # a TAMPERED spill manifest (keys in two tiers, runs missing
            # from the listing) is a contract violation, not a degraded
            # disk: refuse loudly before any data flows rather than
            # silently serving an older epoch
            raise
        except Exception as e:  # noqa: BLE001
            self.session.graph.log_error(
                f"operator snapshot unreadable (epoch {epoch}): {e}"
            )
            return None
        return restored

    # --------------------------------------------------------- journaling

    def open_writer(self, name: str, start: int) -> None:
        self._writers[name] = self.journal.open_segment(name, start)

    def append(self, name: str, key_value: int, row: tuple, diff: int) -> None:
        # always via the manager: checkpoints roll segments underneath
        self._writers[name].append(key_value, row, diff)

    def flush_journal(self, name: str) -> None:
        self._writers[name].flush()

    # --------------------------------------------------------- checkpoint

    def due(self) -> bool:
        interval = self.config.snapshot_interval_ms / 1000.0
        return (_time.monotonic() - self._last_checkpoint) >= interval

    def frontier_advanced(self) -> bool:
        """True when some offset-aware connector's frontier moved past
        what the last checkpoint committed (the pump checkpoints even on
        data-quiet streams then)."""
        committed = getattr(self, "_committed_frontiers", {})
        for c in getattr(self.session, "connectors", []):
            fr = getattr(c, "current_frontier", None)
            if fr is not None and fr != committed.get(c.name):
                return True
        return False

    def checkpoint(self, finalized_time: int) -> None:
        """Durable commit of everything consumed so far."""
        self._last_checkpoint = _time.monotonic()
        # 1. journal segments durable + offset frontiers of seekable
        # sources (their events are never journaled; the frontier IS the
        # durable input record)
        offsets: dict[str, int] = {}
        for name, w in self._writers.items():
            w.flush(sync=True)
            offsets[name] = w.next_offset
        frontiers: dict[str, dict] = {}
        for c in getattr(self.session, "connectors", []):
            fr = getattr(c, "current_frontier", None)
            if fr is not None:
                frontiers[c.name] = dict(fr)
        self._committed_frontiers = frontiers
        # 1b. transactional sinks: fsync the staged outbox WAL and take
        # the per-sink sealed offsets the metadata commit will pin
        outbox_offsets = None
        if self.outboxes is not None:
            outbox_offsets = self.outboxes.seal_all()
            # crash window: output staged + durable but NOT sealed — the
            # committed metadata still points at the previous offsets, so
            # recovery discards this tail and the replayed inputs
            # regenerate it (their offsets were not committed either)
            faults.crash("sink.outbox.pre_seal")
        # 2. operator snapshots for the next epoch
        epoch = self.epoch + 1
        wrote_ops = False
        op_manifest: list[str] = []
        if self.config.operator_snapshots:
            wrote_ops = True
            for node in self.session.graph.nodes:
                st = node.persist_state()
                if st is not None:
                    pid = _persistent_id(node)
                    op_manifest.append(pid)
                    if faults.fire("persistence.snapshot.skip"):
                        # injected lost-snapshot: the file never lands but
                        # the manifest still lists it — restore must
                        # detect the hole and fall back an epoch
                        continue
                    self.ops.write(pid, epoch, st)
        # crash window A: snapshots written, metadata not committed —
        # recovery must resume from the PREVIOUS epoch untouched
        faults.crash("persistence.checkpoint.pre_commit")
        # 3. metadata commit (the linearization point)
        prev_record = self.metadata.load()
        self.metadata.commit(
            epoch, offsets, self.signature, finalized_time, prev=prev_record,
            frontiers=frontiers, op_snapshots=sorted(op_manifest),
            outbox=outbox_offsets,
        )
        self.epoch = epoch
        # crash window B: committed but not compacted — recovery resumes
        # from THIS epoch; stale epoch-(N-1) artifacts are inert
        faults.crash("persistence.checkpoint.post_commit")
        # 3b. the epoch's sink output is now SEALED: flush it through the
        # writers, ack, and GC fully-acked outbox segments (io/outbox.py)
        if self.outboxes is not None:
            # crash window: sealed but nothing delivered — restart
            # replays the whole sealed-unacked range from the outbox
            faults.crash("sink.outbox.post_seal")
            self.outboxes.deliver_all(epoch)
        # 4. compaction — keep TWO epochs of snapshots and the journal
        # back to the previous epoch's offsets, so multi-process recovery
        # can roll back one epoch when peers crashed between commits
        if wrote_ops:
            self.ops.compact({epoch - 1, epoch})
            # spill runs retired by compaction stay on disk until they
            # have survived enough checkpoints that no restorable epoch's
            # manifest can still reference them
            from pathway_tpu_torch.engine import spill as _spill

            _spill.collect_garbage()
            prev_offsets = (
                prev_record.get("offsets", {}) if prev_record else {}
            )
            for name, committed in offsets.items():
                # no previous record -> floor 0: the pre-existing journal
                # may still serve an agreed-epoch-0 recovery (a genuine
                # first run has nothing to compact anyway)
                safe = min(int(prev_offsets.get(name, 0)), committed)
                self.journal.compact(name, safe)
                # roll the segment so future compactions can free it
                w = self._writers[name]
                if w.count:
                    w.close()
                    self._writers[name] = self.journal.open_segment(
                        name, w.next_offset
                    )

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        if self.outboxes is not None:
            # writers close only now, after the final checkpoint's
            # delivery + ack (OutputNode.on_end defers to the outbox)
            self.outboxes.close()


def attach_persistence(session: Any, config: Config) -> None:
    """Wire journaling + operator snapshots + replay into a session."""
    if config.persistence_mode in ("UDF_CACHING", "udf_caching"):
        return  # cache-only mode: UDF caches use the backend directly
    s3_sync = None
    if config.backend.kind == "s3":
        import tempfile

        root_path = config.backend.path or "pathway"
        if getattr(session, "mesh", None) is not None:
            root_path = f"{root_path}/proc-{session.mesh.process_id}"
        # per-run private staging dir: a fixed shared path would let a
        # second attach rmtree a live run's tree (pull() resets from the
        # bucket anyway, so nothing needs to survive locally)
        local = tempfile.mkdtemp(prefix="pathway-s3-stage-")
        s3_sync = _S3Sync(
            config.backend.s3_client, config.backend.s3_bucket, root_path, local
        )
        s3_sync.pull()  # the bucket is the source of truth on attach
        config = config.with_backend(Backend.filesystem(local))
    elif config.backend.kind != "filesystem" or not config.backend.path:
        return
    elif getattr(session, "mesh", None) is not None:
        # each cooperating process owns its shard of operator state and
        # its own sources: persistence roots are per-process
        config = config.with_backend(
            Backend.filesystem(
                os.path.join(
                    config.backend.path, f"proc-{session.mesh.process_id}"
                )
            )
        )
    manager = CheckpointManager(session, config)
    if s3_sync is not None:
        # every durable commit ships to the bucket; metadata.json last
        # (see _S3Sync.push) so a crash mid-upload keeps the prior epoch
        _orig_ckpt = manager.checkpoint
        _orig_close = manager.close

        def _ckpt_and_push(t: int) -> None:
            _orig_ckpt(t)
            s3_sync.push()

        def _close_and_push() -> None:
            import shutil

            _orig_close()
            s3_sync.push()
            shutil.rmtree(s3_sync.local, ignore_errors=True)

        manager.checkpoint = _ckpt_and_push  # type: ignore[method-assign]
        manager.close = _close_and_push  # type: ignore[method-assign]
    if getattr(session, "mesh", None) is not None:
        # coordinated recovery: a crash can land BETWEEN two processes'
        # commits of the same epoch, so resume from the MINIMUM epoch all
        # processes hold — each keeps two epochs for exactly this
        epochs = session.mesh.allgather("ckpt-epoch", manager.latest_epoch())
        agreed = min(epochs.values())
        replay_offsets = manager.restore(epoch=agreed)
    else:
        replay_offsets = manager.restore()

    from pathway_tpu_torch.engine.runtime import Connector, OffsetMark

    class PersistentConnector(Connector):
        """Durability wrapper, per the source's replay style:

        * 'offset' — the source emits OffsetMark frontiers (fs byte
          positions, kafka offsets). NOTHING is journaled: events are
          delivered only up to the last mark (the rest is held one poll),
          the checkpoint records the frontier, and on restart the source
          SEEKS past it (reference: frontier.rs OffsetAntichain +
          data_storage.rs:303-320 seek). Token-resident batches flow
          through untouched — full native ingest speed under persistence.
        * 'seekable' — deterministic re-readers without offsets: journal
          everything, count-skip the re-read on resume.
        * 'live' — message queues: journal everything; the journal
          supplies history, the source only ever delivers new events.
        """

        def __init__(self, inner: Connector, name: str):
            super().__init__(name, inner.session)
            self.inner = inner
            # global lowering ordinal rides the wrapper: elastic
            # rebalance routes this source's journal by ordinal % n
            if hasattr(inner, "ordinal"):
                self.ordinal = inner.ordinal
            self.style = (
                "offset" if inner.replay_style == "offset" else
                "seekable" if inner.replay_style == "seekable" else "live"
            )
            if self.style == "offset":
                self.frontier: dict = dict(
                    manager.restored_frontiers.get(name, {})
                )
                inner.session.resume_frontier = dict(self.frontier)
                self._held: list = []
                self.tail = []
                self.skip = 0
                return
            self.committed = replay_offsets.get(name, 0)
            self.tail = manager.journal.load_from(name, self.committed)
            total = manager.journal.total_events(name)
            # seekable sources re-read from the start: skip events the
            # journal already has. Live sources (message queues) only
            # deliver new events — skip nothing.
            self.skip = total if self.style == "seekable" else 0
            manager.open_writer(name, total)
            self._replay_done = False
            self._seen = 0

        def start(self) -> None:
            self.inner.start()

        @property
        def current_frontier(self) -> dict | None:
            """Checkpointed by the manager: covers exactly the events
            delivered so far (held events are re-read after resume)."""
            return self.frontier if self.style == "offset" else None

        def _poll_offset(self) -> list:
            staged = self.session.drain()
            out: list = []
            for seg in staged:
                if type(seg) is OffsetMark:
                    out.extend(self._held)
                    self._held.clear()
                    self.frontier.update(seg.frontier)
                else:
                    self._held.append(seg)
            if self.inner.finished.is_set() and not self.session._staged:
                out.extend(self._held)
                self._held.clear()
            return out

        def poll(self) -> list:
            if self.style == "offset":
                return self._poll_offset()
            out = []
            if not self._replay_done:
                self._replay_done = True
                for (_off, kv, row, diff) in self.tail:
                    out.append((Key(kv), row, diff))
                self.tail = []
            live = self.inner.poll()
            # token-resident segments journal via the object plane (the
            # per-event journal format); offset-style sources keep native
            # speed because they never journal
            if any(type(seg) is not tuple for seg in live):
                flat: list = []
                for seg in live:
                    if type(seg) is tuple:
                        flat.append(seg)
                    else:
                        flat.extend(
                            (k, row, d) for (k, row, d) in seg.materialize()
                        )
                live = flat
            wrote = False
            for (key, row, diff) in live:
                self._seen += 1
                if self._seen <= self.skip:
                    continue  # journaled in a previous run; replayed above
                manager.append(self.name, key.value, row, diff)
                wrote = True
                out.append((key, row, diff))
            if wrote:
                manager.flush_journal(self.name)
            return out

        @property
        def done(self) -> bool:
            if self.style == "offset":
                return self.inner.done and not self._held
            return self.inner.done

    fresh_start = manager.metadata.load() is None and all(
        manager.journal.total_events(c.name) == 0 for c in session.connectors
    )
    session.connectors = [
        PersistentConnector(c, c.name) for c in session.connectors
    ]
    session.checkpointer = manager
    # end-to-end exactly-once: thread every output sink through the
    # transactional outbox (io/outbox.py) — stage to a WAL, seal at the
    # metadata commit, deliver + ack after it, replay on restart.
    # PATHWAY_EXACTLY_ONCE=0 keeps the direct per-wave writes (today's
    # at-least-once) byte-identically; static pipelines (no streaming
    # connectors) never cut checkpoints, so they also write directly.
    from pathway_tpu_torch.io.outbox import exactly_once_enabled

    if session.connectors and exactly_once_enabled():
        from pathway_tpu_torch.engine.runtime import OutputNode
        from pathway_tpu_torch.io.outbox import OutboxManager

        out_nodes = [
            n for n in session.graph.nodes if isinstance(n, OutputNode)
        ]
        if out_nodes:
            obm = OutboxManager(manager.journal.root)
            for i, node in enumerate(out_nodes):
                obm.register(f"sink{i:02d}", node)
            manager.outboxes = obm
            # replay negotiation: discard the unsealed WAL tail, then
            # re-deliver anything sealed by the restored epoch but not
            # yet acked by a writer flush
            obm.recover(manager.restored_outbox, manager.epoch)
    if fresh_start:
        # bootstrap commit: a fresh run records epoch 1 (empty operator
        # state, zero offsets) BEFORE any event flows, so a crash at any
        # point leaves a committed metadata record to resume from — the
        # reference likewise initializes its metadata storage at startup
        # (state.rs MetadataAccessor::new). Only safe on a fresh start:
        # with a journal tail pending replay, the writers' offsets would
        # overstate what the (restored) operator state has consumed.
        manager.checkpoint(0)


# Backwards-compatible alias used by earlier tests/tools.
class SnapshotJournal(SegmentedJournal):
    def load(self, name: str) -> list:
        return [(kv, row, diff) for (_o, kv, row, diff) in self.load_from(name, 0)]


__all__ = [
    "Backend",
    "Config",
    "attach_persistence",
    "CheckpointManager",
    "MetadataStore",
    "OperatorSnapshotStore",
    "SegmentedJournal",
    "SnapshotJournal",
]
