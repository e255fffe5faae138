"""Shared helpers of the LLM xpack (reference: xpacks/llm/_utils.py)."""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable


def _coerce_sync(fn: Callable) -> Callable:
    """Run an async callable synchronously (used for one-off introspection
    like get_embedding_dimension — reference _utils._coerce_fully_sync)."""
    if not asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(fn(*args, **kwargs))
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            return pool.submit(asyncio.run, fn(*args, **kwargs)).result()

    return wrapper


def _check_model_accepts_arg(model_name: str, arg: str) -> bool:  # parity stub
    return True


def _extract_value(value: Any) -> Any:
    from pathway_tpu_torch.internals.json import Json

    if isinstance(value, Json):
        return value.value
    return value
