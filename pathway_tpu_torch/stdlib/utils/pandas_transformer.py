"""pandas_transformer (reference: stdlib/utils/pandas_transformer.py:178):
run a pandas function over entire (static) tables."""

from __future__ import annotations

import functools
from typing import Any, Callable

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Table


def pandas_transformer(output_schema: Any, output_universe: Any = None) -> Callable:
    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*tables: Table) -> Table:
            import pandas as pd

            from pathway_tpu_torch.debug import table_from_pandas, table_to_pandas

            dfs = [table_to_pandas(t) for t in tables]
            result = fn(*dfs)
            if not isinstance(result, pd.DataFrame):
                result = pd.DataFrame(result)
            return table_from_pandas(result, schema=output_schema)

        return wrapper

    return decorator
