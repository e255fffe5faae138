"""Temporal behaviors (reference: stdlib/temporal/temporal_behavior.py:29
common_behavior, :83 exactly_once_behavior)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class CommonBehavior:
    """delay: hold a window's output until event time passes start+delay;
    cutoff: stop updating (and optionally drop) windows older than
    end+cutoff; keep_results: whether cut-off windows keep their last
    output (freeze) or retract it (forget)."""

    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(
    delay: Any = None, cutoff: Any = None, keep_results: bool = True
) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior:
    shift: Any = None


def exactly_once_behavior(shift: Any = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)
