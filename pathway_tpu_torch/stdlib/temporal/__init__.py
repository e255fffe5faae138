"""pw.temporal (reference: stdlib/temporal/)."""

from pathway_tpu_torch.stdlib.temporal._joins import (
    AsofJoinResult,
    AsofNowJoinResult,
    Direction,
    Interval,
    IntervalJoinResult,
    WindowJoinResult,
    asof_join,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from pathway_tpu_torch.stdlib.temporal._window import (
    IntervalsOverWindow,
    SessionWindow,
    SlidingWindow,
    TumblingWindow,
    Window,
    WindowedTable,
    intervals_over,
    session,
    sliding,
    tumbling,
    windowby,
)
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
    exactly_once_behavior,
)
from pathway_tpu_torch.stdlib.temporal.time_utils import inactivity_detection

__all__ = [
    "interval", "interval_join", "interval_join_inner", "interval_join_left",
    "interval_join_right", "interval_join_outer", "window_join",
    "window_join_inner", "window_join_left", "window_join_right",
    "window_join_outer", "asof_join", "asof_join_left", "asof_join_right",
    "asof_join_outer", "asof_now_join", "asof_now_join_inner",
    "asof_now_join_left", "Direction", "tumbling", "sliding", "session",
    "intervals_over", "windowby", "Window", "TumblingWindow", "SlidingWindow",
    "SessionWindow", "IntervalsOverWindow", "WindowedTable",
    "common_behavior", "exactly_once_behavior", "CommonBehavior",
    "ExactlyOnceBehavior", "inactivity_detection",
]
