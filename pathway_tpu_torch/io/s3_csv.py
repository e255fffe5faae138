"""pw.io.s3_csv — CSV-specialized S3 reader.

Reference parity: python/pathway/io/s3_csv/__init__.py, which fixes the
format of the general S3 reader to CSV; identical delegation here.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io.s3 import AwsS3Settings
from pathway_tpu_torch.io.s3 import read as s3_read


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any = None,
    **kwargs: Any,
) -> Any:
    return s3_read(
        path, "csv", aws_s3_settings=aws_s3_settings, schema=schema, **kwargs
    )


__all__ = ["AwsS3Settings", "read"]
