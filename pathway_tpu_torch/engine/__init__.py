"""The incremental dataflow engine (host).

Counterpart of ``pathway_tpu/engine/``, copied under the package rename:
z-set collections flowing through a DAG of operator nodes over one
total-ordered timestamp domain, frontier-based progress tracking
(``frontier.py``), morsel-driven waves (``morsel.py``), the out-of-core
spill tier (``spill.py``) and the host C++ kernels (``native/``, built
with g++ at first use). The device dispatches of the serving stages
(embed, generate, KNN, batched UDFs) go through the port's device plane
(``device_plane.py``) on the CUDA card.
"""

from pathway_tpu_torch.engine.core import (
    Entry,
    Node,
    Graph,
    CaptureNode,
)
from pathway_tpu_torch.engine.runtime import Runtime

__all__ = ["Entry", "Node", "Graph", "CaptureNode", "Runtime"]
