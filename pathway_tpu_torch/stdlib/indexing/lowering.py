"""Lowering of the `external_index` OpSpec to the engine node.

Reference parity: graph_runner handling of use_external_index_as_of_now
(python_api.rs external index wrappers -> dataflow.rs:2224).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine import core as eng


def build_external_index(session: Any, table: Any, spec: Any) -> eng.Node:
    index_t = spec.inputs[0]
    query_t = spec.inputs[1]
    data_t = spec.inputs[2] if len(spec.inputs) > 2 else None
    nodes = [session.node_of(index_t), session.node_of(query_t)]
    if data_t is not None:
        nodes.append(session.node_of(data_t))
    # one host/device index instance: runs whole on process 0
    nodes = session._process_exchange(nodes, None)
    mode = spec.params["mode"]

    def index_fn(key, row):
        return row[0], row[1]

    if mode == "reply":
        def query_fn(key, row):
            return row[0], row[1], row[2]
    else:
        def query_fn(key, row):
            return row[-3], row[-2], row[-1]

    return eng.ExternalIndexNode(
        session.graph,
        nodes,
        spec.params["host_index_factory"](),
        index_fn,
        query_fn,
        mode=mode,
        asof_now=spec.params["asof_now"],
        data_width=spec.params["data_width"],
    )
