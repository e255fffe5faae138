"""Custom accumulator reducers (reference: internals/custom_reducers.py:174
BaseCustomAccumulator, stateful_many :35)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

from pathway_tpu_torch.internals.expression import ReducerExpression
from pathway_tpu_torch.internals.reducers import Reducer


class BaseCustomAccumulator(ABC):
    """Subclass with from_row / update / compute_result (and optionally
    retract / neutral) to define a custom reducer usable via
    `pw.reducers.udf_reducer(MyAcc)`."""

    @classmethod
    @abstractmethod
    def from_row(cls, row: list[Any]) -> "BaseCustomAccumulator": ...

    @abstractmethod
    def update(self, other: "BaseCustomAccumulator") -> None: ...

    def retract(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support retraction"
        )

    @abstractmethod
    def compute_result(self) -> Any: ...


class CustomAccumulatorReducer(Reducer):
    name = "custom"

    def __init__(self, acc_cls: type[BaseCustomAccumulator]):
        self.acc_cls = acc_cls

    def from_multiset(self, entries: list[tuple[tuple, int]]) -> Any:
        acc: BaseCustomAccumulator | None = None
        for values, count in entries:
            if count == 0:
                continue
            for _ in range(abs(count)):
                item = self.acc_cls.from_row(list(values))
                if acc is None:
                    if count > 0:
                        acc = item
                    else:
                        raise ValueError("custom reducer saw net-negative multiset")
                elif count > 0:
                    acc.update(item)
                else:
                    acc.retract(item)
        if acc is None:
            return None
        return acc.compute_result()


def make_udf_reducer(acc_cls: type[BaseCustomAccumulator]):
    def reducer_factory(*args: Any) -> ReducerExpression:
        return ReducerExpression(CustomAccumulatorReducer(acc_cls), *args)

    return reducer_factory
