"""pw.io.gdrive — stream files from a Google Drive folder.

Reference parity: python/pathway/io/gdrive/__init__.py (read). Implemented
against google-api-python-client + google-auth (service account): the
folder is polled for file additions/modifications/deletions; each object
is emitted as a binary row with `_metadata`, and changes flow as upserts/
deletions. Raises a clear ImportError when the client stack is missing.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.io._external import require_module
from pathway_tpu_torch.io._retry import CircuitOpen, RetryPolicy

_LOG = logging.getLogger("pathway_tpu_torch.io.gdrive")

_EXPORT_MIME = {
    "application/vnd.google-apps.document": "text/plain",
    "application/vnd.google-apps.spreadsheet": "text/csv",
    "application/vnd.google-apps.presentation": "application/pdf",
}


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    refresh_interval: int = 30,
    service_user_credentials_file: str,
    with_metadata: bool = False,
    file_name_pattern: str | list[str] | None = None,
    name: str | None = None,
    **kwargs: Any,
) -> Any:
    """Streams the binary contents of files under a Drive folder (or a
    single file); streaming mode polls every `refresh_interval` seconds
    and emits upserts for modified files and deletions for removed ones."""
    service_account = require_module("google.oauth2.service_account", "gdrive")
    discovery = require_module("googleapiclient.discovery", "gdrive")

    import fnmatch

    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    schema = sch.schema_from_types(data=bytes, _metadata=Json)
    patterns = (
        [file_name_pattern]
        if isinstance(file_name_pattern, str)
        else list(file_name_pattern or [])
    )
    connector_name = name or f"gdrive:{object_id}"
    # unified download policy: bounded in-poll retries, and a circuit
    # breaker so a dead API (auth revoked, quota) stops hammering every
    # poll — the open transition is surfaced as ONE loud warning
    retry = RetryPolicy(
        connector_name,
        max_attempts=3,
        initial_delay_ms=500,
        max_delay_ms=5_000,
        breaker_threshold=5,
        breaker_reset_ms=60_000,
        on_breaker_open=lambda p: _LOG.warning(
            "connector %r: circuit breaker OPEN after repeated download "
            "failures (last: %s); downloads fail fast for a cooldown, "
            "then a single probe re-tests the API",
            p.name, p.last_error,
        ),
    )

    class GDriveSubject(ConnectorSubject):
        # rows are keyed by the Drive file id so a modified file replaces
        # its previous contents and a removed file retracts its row
        def _key_for(self, values: dict) -> Any:
            from pathway_tpu_torch.internals.keys import key_for_values

            return key_for_values(values["_metadata"].value["id"])

        def run(self) -> None:
            creds = service_account.Credentials.from_service_account_file(
                service_user_credentials_file,
                scopes=["https://www.googleapis.com/auth/drive.readonly"],
            )
            drive = discovery.build("drive", "v3", credentials=creds)
            seen: dict[str, str] = {}  # file id -> modifiedTime
            emitted: dict[str, dict] = {}  # file id -> last emitted row
            while True:
                files = self._list(drive)
                current_ids = set()
                for f in files:
                    fid, mtime = f["id"], f.get("modifiedTime", "")
                    if patterns and not any(
                        fnmatch.fnmatch(f.get("name", ""), p) for p in patterns
                    ):
                        continue
                    if object_size_limit and int(f.get("size", 0)) > object_size_limit:
                        continue
                    current_ids.add(fid)
                    if seen.get(fid) == mtime:
                        continue
                    data = self._download(drive, f)
                    if data is None:
                        continue
                    seen[fid] = mtime
                    row = {
                        "data": data,
                        "_metadata": Json(
                            {
                                "id": fid,
                                "name": f.get("name"),
                                "path": f.get("name"),
                                "modified_at": mtime,
                                "seen_at": int(_time.time()),
                            }
                        ),
                    }
                    if fid in emitted:  # modified: retract old contents
                        self._remove(emitted[fid])
                    self.next(**row)
                    emitted[fid] = row
                for fid in list(seen):
                    if fid not in current_ids:  # deleted on Drive
                        del seen[fid]
                        old = emitted.pop(fid, None)
                        if old is not None:
                            self._remove(old)
                if mode != "streaming":
                    return
                _time.sleep(refresh_interval)

        def _list(self, drive: Any) -> list[dict]:
            query = f"'{object_id}' in parents and trashed = false"
            out, token = [], None
            while True:
                resp = drive.files().list(
                    q=query,
                    fields="nextPageToken, files(id, name, mimeType, modifiedTime, size)",
                    pageToken=token,
                ).execute()
                out.extend(resp.get("files", []))
                token = resp.get("nextPageToken")
                if not token:
                    break
            if not out:  # maybe object_id is a single file
                f = drive.files().get(
                    fileId=object_id,
                    fields="id, name, mimeType, modifiedTime, size",
                ).execute()
                out = [f]
            return out

        def _download_once(self, drive: Any, f: dict) -> bytes:
            mime = f.get("mimeType", "")
            if mime in _EXPORT_MIME:
                return drive.files().export(
                    fileId=f["id"], mimeType=_EXPORT_MIME[mime]
                ).execute()
            return drive.files().get_media(fileId=f["id"]).execute()

        def _download(self, drive: Any, f: dict) -> bytes | None:
            # a failed file is NOT marked seen, so the next poll retries
            # it — but never silently: every give-up is logged with the
            # connector name, and a run of failures opens the breaker
            try:
                return retry.call(self._download_once, drive, f)
            except CircuitOpen:
                return None  # breaker already warned; skip until re-probe
            except Exception as e:  # noqa: BLE001 — poll loop must survive
                _LOG.warning(
                    "connector %r: download of %r failed after "
                    "%d attempts: %s",
                    connector_name, f.get("name") or f.get("id"),
                    retry.max_attempts, e,
                )
                return None

    return python_read(
        GDriveSubject(),
        schema=schema,
        name=name or f"gdrive:{object_id}",
    )


__all__ = ["read"]
