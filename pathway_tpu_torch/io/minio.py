"""pw.io.minio — MinIO object-store reader.

Reference parity: python/pathway/io/minio/__init__.py — MinIO speaks the
S3 API with path-style addressing at a custom endpoint; this module is
the same settings-specialization of pw.io.s3.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io.s3 import AwsS3Settings
from pathway_tpu_torch.io.s3 import read as s3_read


class MinIOSettings:
    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: str | None = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        endpoint = self.endpoint
        if "://" not in endpoint:
            endpoint = "https://" + endpoint
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region,
            endpoint=endpoint,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    format: str = "csv",  # noqa: A002
    **kwargs: Any,
) -> Any:
    return s3_read(
        path, format, aws_s3_settings=minio_settings.create_aws_settings(), **kwargs
    )


__all__ = ["MinIOSettings", "read"]
