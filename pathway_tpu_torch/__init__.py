"""pathway_tpu_torch — the PyTorch/CUDA port of pathway_tpu, for NVIDIA Hopper.

The JAX package ``pathway_tpu`` is the reference this package is held
against; this package imports neither it nor JAX. It carries the host
dataflow engine (Tables + expressions DSL, the incremental engine,
connectors, temporal windows, indexes, the LLM/RAG xpack) as a renamed
copy of the JAX package's, and its own numeric plane in PyTorch: the hash
tokenizer, the flagship encoder with its fused attention kernel
``csrc/attention.cu``, the KNN slab index, the IVF-PQ tier with its
RAM/disk list tiers, the causal LM with continuous batching, and the UDFs
that feed them (``TorchEmbedder``, ``TorchLMChat``). Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.

Import convention, as in the reference: `import pathway_tpu_torch as pw`.
The stdlib is the reference's: ``pw.graphs``, ``pw.indexing``, ``pw.ml``,
``pw.ordered``, ``pw.stateful``, ``pw.statistical``, ``pw.temporal``,
``pw.utils`` and ``pw.viz``. ``python -m pathway_tpu_torch spawn -n N --
app.py`` runs a pipeline as N cooperating processes over the TCP mesh,
with elastic membership and blue/green swaps in ``parallel/``.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as _dtype
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals import universe as _universe_mod
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.common import (
    apply,
    apply_async,
    apply_with_type,
    assert_table_has_schema,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    iterate,
    make_tuple,
    require,
    table_transformer,
    unwrap,
)
from pathway_tpu_torch.internals.config import (
    PathwayConfig,
    get_config,
    set_license_key,
    set_monitoring_config,
)
from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc, Duration
from pathway_tpu_torch.internals.errors import global_error_log
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    left,
    right,
    this,
)
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Key as Pointer
from pathway_tpu_torch.internals.interactive import (
    LiveTable,
    enable_interactive_mode,
)
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.run import run, run_all
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_builder,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import JoinMode, Table
from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncRetryStrategy,
    CacheStrategy,
    DiskCache,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    InMemoryCache,
    NoRetryStrategy,
    async_executor,
    auto_executor,
    fully_async_executor,
    sync_executor,
    udf,
)
from pathway_tpu_torch.internals.parse_graph import G as parse_graph_G  # noqa: N811

# subpackages (import order matters: io/stdlib pull from internals)
from pathway_tpu_torch import debug  # noqa: E402
from pathway_tpu_torch import demo  # noqa: E402
from pathway_tpu_torch import io  # noqa: E402
from pathway_tpu_torch import persistence  # noqa: E402
from pathway_tpu_torch import serving  # noqa: E402
from pathway_tpu_torch.stdlib import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils, viz  # noqa: E402
from pathway_tpu_torch.internals.sql import sql  # noqa: E402
from pathway_tpu_torch.internals.yaml_loader import load_yaml  # noqa: E402
from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator  # noqa: E402

# dtype namespace parity (pw.Json handled above)
Pointer_dtype = _dtype.ANY_POINTER
universes = _universe_mod


class __module_shortcuts__:
    pass


# reference exposes reducers also at pw.reducers; xpacks lazily
from pathway_tpu_torch import xpacks  # noqa: E402

# ---- reference top-level surface parity ----
from pathway_tpu_torch.internals.table_slice import TableSlice  # noqa: E402
from pathway_tpu_torch.internals.wrappers import PyObjectWrapper, wrap_py_object  # noqa: E402
from pathway_tpu_torch.internals.monitoring import MonitoringLevel  # noqa: E402
from pathway_tpu_torch.internals.joins import JoinResult  # noqa: E402
from pathway_tpu_torch.internals.groupbys import GroupedTable  # noqa: E402
from pathway_tpu_torch.stdlib.temporal import (  # noqa: E402
    AsofJoinResult,
    IntervalJoinResult,
    WindowJoinResult,
)
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer  # noqa: E402


class PersistenceMode:
    """Persistence-mode names (reference: engine PersistenceMode enum);
    pass as `persistence_mode=` on pw.persistence.Config."""

    BATCH = "BATCH"
    PERSISTING = "PERSISTING"
    SELECTIVE_PERSISTING = "SELECTIVE_PERSISTING"
    UDF_CACHING = "UDF_CACHING"
    OPERATOR_PERSISTING = "OPERATOR_PERSISTING"


# legacy aliases the reference keeps exporting
Joinable = Table
TableLike = Table
UDFSync = UDF
UDFAsync = UDF


def join(left_table: Table, other: Table, *on, **kwargs):  # noqa: A002
    """Free-function form of Table.join (reference exports both)."""
    return left_table.join(other, *on, **kwargs)


def join_inner(left_table: Table, other: Table, *on, **kwargs):
    return left_table.join_inner(other, *on, **kwargs)


def join_left(left_table: Table, other: Table, *on, **kwargs):
    return left_table.join_left(other, *on, **kwargs)


def join_right(left_table: Table, other: Table, *on, **kwargs):
    return left_table.join_right(other, *on, **kwargs)


def join_outer(left_table: Table, other: Table, *on, **kwargs):
    return left_table.join_outer(other, *on, **kwargs)


def groupby(table: Table, *args, **kwargs):
    return table.groupby(*args, **kwargs)


# module aliases (reference: pw.csv is pw.io.csv, etc.)
csv = io.csv
jsonlines = io.jsonlines
http = io.http
kafka = io.kafka
debezium = io.debezium
elasticsearch = io.elasticsearch

# the port's numeric plane
from pathway_tpu_torch.engine.device_plane import get_device_plane, resolve_device  # noqa: E402
from pathway_tpu_torch.models.transformer import TransformerEncoder, TransformerLM  # noqa: E402
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex  # noqa: E402
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder  # noqa: E402
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Table", "Schema", "Json", "Pointer", "DateTimeNaive", "DateTimeUtc",
    "Duration", "JoinMode", "ColumnExpression", "ColumnReference",
    "this", "left", "right", "run", "run_all", "iterate",
    "apply", "apply_async", "apply_with_type", "cast", "declare_type",
    "coalesce", "require", "if_else", "make_tuple", "unwrap", "fill_error",
    "assert_table_has_schema", "table_transformer",
    "transformer", "ClassArg", "input_attribute", "output_attribute",
    "method", "input_method", "LiveTable", "enable_interactive_mode",
    "udf", "UDF", "udfs", "reducers",
    "column_definition", "ColumnDefinition", "schema_from_types",
    "schema_from_dict", "schema_from_pandas", "schema_builder",
    "io", "debug", "demo", "persistence", "serving", "temporal", "indexing",
    "ordered", "utils", "universes",
    "sql", "load_yaml", "BaseCustomAccumulator", "xpacks",
    "get_config", "PathwayConfig", "set_license_key", "set_monitoring_config",
    "global_error_log",
    # reference top-level surface parity
    "TableSlice", "PyObjectWrapper", "wrap_py_object", "MonitoringLevel",
    "PersistenceMode", "JoinResult", "GroupedTable", "AsofJoinResult",
    "IntervalJoinResult", "WindowJoinResult", "AsyncTransformer",
    "Joinable", "TableLike", "UDFSync", "UDFAsync",
    "join", "join_inner", "join_left", "join_right", "join_outer", "groupby",
    "csv", "jsonlines", "http", "kafka", "debezium", "elasticsearch",
    # the port's numeric plane
    "TorchEmbedder", "TorchLMChat", "TransformerEncoder", "TransformerLM",
    "VectorSlabIndex", "get_device_plane", "resolve_device",
]
