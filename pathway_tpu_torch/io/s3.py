"""pw.io.s3 — read object-store data (Amazon S3 and S3-compatible).

Reference parity: python/pathway/io/s3/__init__.py (AwsS3Settings, read
:94, read_from_digital_ocean :304, read_from_wasabi :435) backed by the
native S3 scanner (src/connectors/data_storage.rs). Implemented against
boto3: objects under the path prefix are listed in modification-time
order, downloaded, and parsed with the same format machinery as the
filesystem connector (csv/json/plaintext/plaintext_by_object/binary);
streaming mode polls for new objects. Raises a clear ImportError when
boto3 is not installed.
"""

from __future__ import annotations

import io as _io
import time as _time
from typing import Any

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.io._external import require_module


class AwsS3Settings:
    """Connection settings for S3 / S3-compatible object stores."""

    def __init__(
        self,
        *,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        with_path_style: bool = False,
        region: str | None = None,
        endpoint: str | None = None,
        session_token: str | None = None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self.endpoint = endpoint
        self.session_token = session_token

    @classmethod
    def new_from_path(cls, s3_path: str) -> "AwsS3Settings":
        bucket = s3_path.removeprefix("s3://").split("/", 1)[0]
        return cls(bucket_name=bucket)

    def create_client(self) -> Any:
        boto3 = require_module("boto3", "s3")
        kwargs: dict[str, Any] = {}
        if self.access_key and self.secret_access_key:
            kwargs["aws_access_key_id"] = self.access_key
            kwargs["aws_secret_access_key"] = self.secret_access_key
        if self.session_token:
            kwargs["aws_session_token"] = self.session_token
        if self.region:
            kwargs["region_name"] = self.region
        if self.endpoint:
            kwargs["endpoint_url"] = self.endpoint
        if self.with_path_style:
            botocore_config = require_module("botocore.config", "s3")
            kwargs["config"] = botocore_config.Config(
                s3={"addressing_style": "path"}
            )
        return boto3.client("s3", **kwargs)


def _split_path(path: str, settings: AwsS3Settings | None) -> tuple[str, str]:
    p = path.removeprefix("s3://")
    if settings is not None and settings.bucket_name:
        if p.startswith(settings.bucket_name + "/"):
            p = p[len(settings.bucket_name) + 1 :]
        return settings.bucket_name, p
    bucket, _, prefix = p.partition("/")
    return bucket, prefix


def read(
    path: str,
    format: str = "csv",  # noqa: A002
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    csv_settings: Any = None,
    json_field_paths: dict[str, str] | None = None,
    downloader_threads_count: int | None = None,
    persistent_id: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    poll_interval_s: float = 5.0,
    debug_data: Any = None,
) -> Any:
    """Reads objects under an S3 path prefix in modification-time order;
    `mode='streaming'` keeps polling for newly added objects."""
    from pathway_tpu_torch.io.fs import _parse_file
    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    settings = aws_s3_settings or AwsS3Settings.new_from_path(path)
    bucket, prefix = _split_path(path, settings)
    eff_format = {"plaintext_by_object": "plaintext_by_file"}.get(format, format)
    if schema is None:
        if format in ("plaintext", "plaintext_by_object"):
            schema = sch.schema_from_types(data=str)
        elif format == "binary":
            schema = sch.schema_from_types(data=bytes)
        else:
            raise ValueError(f"pw.io.s3.read(format={format!r}) requires a schema")
    if with_metadata and "_metadata" not in schema.__columns__:
        from pathway_tpu_torch.internals import dtype as _dt

        cols = dict(schema.__columns__)
        cols["_metadata"] = sch.ColumnSchema(name="_metadata", dtype=_dt.JSON)
        schema = sch.schema_from_columns(cols)

    class S3Subject(ConnectorSubject):
        def run(self) -> None:
            import tempfile

            client = settings.create_client()
            seen: set[str] = set()
            while True:
                objects: list[tuple[Any, str]] = []
                paginator = client.get_paginator("list_objects_v2")
                for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
                    for obj in page.get("Contents", []):
                        if obj["Key"] not in seen:
                            objects.append((obj["LastModified"], obj["Key"]))
                for mtime, key in sorted(objects):
                    seen.add(key)
                    body = client.get_object(Bucket=bucket, Key=key)["Body"].read()
                    with tempfile.NamedTemporaryFile(suffix=key.rsplit("/", 1)[-1]) as f:
                        f.write(body)
                        f.flush()
                        for row in _parse_file(
                            f.name, eff_format, schema,
                            csv_settings=csv_settings,
                            with_metadata=with_metadata,
                        ):
                            if with_metadata:
                                # object metadata, not the temp file's stat
                                from pathway_tpu_torch.internals.json import Json

                                row["_metadata"] = Json({
                                    "path": f"s3://{bucket}/{key}",
                                    "size": len(body),
                                    "modified_at": int(mtime.timestamp()),
                                    "seen_at": int(_time.time()),
                                })
                            self.next(**row)
                if mode != "streaming":
                    return
                _time.sleep(poll_interval_s)

    return python_read(
        S3Subject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"s3://{bucket}/{prefix}",
        replay_style="seekable",
    )


def read_from_digital_ocean(
    path: str,
    do_s3_settings: AwsS3Settings,
    format: str,  # noqa: A002
    **kwargs: Any,
) -> Any:
    """DigitalOcean Spaces: the S3 API at a Spaces endpoint (reference :304)."""
    return read(path, format, aws_s3_settings=do_s3_settings, **kwargs)


def read_from_wasabi(
    path: str,
    wasabi_s3_settings: AwsS3Settings,
    format: str,  # noqa: A002
    **kwargs: Any,
) -> Any:
    """Wasabi: the S3 API at a Wasabi endpoint (reference :435)."""
    return read(path, format, aws_s3_settings=wasabi_s3_settings, **kwargs)


__all__ = ["AwsS3Settings", "read", "read_from_digital_ocean", "read_from_wasabi"]
