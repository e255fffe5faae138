"""Hidden-Markov-Model decoding reducer.

Reference parity: stdlib/ml/hmm.py (create_hmm_reducer :11) — Viterbi
beam decoding expressed as a custom accumulator, with the same graph
contract: a networkx DiGraph whose nodes carry ``idx`` and
``calc_emission_log_ppb`` attributes, edges carry ``log_transition_ppb``,
and ``graph.graph['start_nodes']`` lists the initial states.

Observation order: each observation is tagged with its engine timestamp
(the accumulator receives (time, observation)), so the decoded sequence
follows event time regardless of how the reducer combines partial
accumulators — multiset combination is unordered, and an order-sensitive
decode must not depend on it. Identical observations in the same wave
replay by multiplicity.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.reducers import _EngineTimeMarker, udf_reducer


def create_hmm_reducer(
    graph: Any, beam_size: int | None = None, num_results_kept: int | None = None
):
    """Builds a reducer decoding the most likely hidden-state path for a
    stream of observations (use in reduce over an observation column).
    `beam_size` trims the live frontier per step; `num_results_kept`
    bounds the decoded suffix length."""
    n_states = graph.number_of_nodes()
    state_of = {graph.nodes[n]["idx"]: n for n in graph.nodes}
    frontier_cap = beam_size if beam_size is not None else n_states

    def decode(observations: list[Any]) -> tuple:
        """Viterbi beam decode over the ordered observation sequence."""
        if not observations:
            return ()
        logp = np.full(n_states, -np.inf)
        for start in graph.graph["start_nodes"]:
            i = graph.nodes[start]["idx"]
            logp[i] = graph.nodes[start]["calc_emission_log_ppb"](observations[0])
        frontier = [i for i in range(n_states) if np.isfinite(logp[i])]
        backs: list[np.ndarray] = []
        for obs in observations[1:]:
            nxt = np.full(n_states, -np.inf)
            back = np.full(n_states, -1, dtype=np.int64)
            for i in frontier:
                src = state_of[i]
                base = logp[i]
                for dst in graph.successors(src):
                    j = graph.nodes[dst]["idx"]
                    cand = base + graph[src][dst]["log_transition_ppb"]
                    if cand > nxt[j]:
                        nxt[j] = cand
                        back[j] = i
            live = np.flatnonzero(np.isfinite(nxt))
            for j in live:
                nxt[j] += graph.nodes[state_of[int(j)]]["calc_emission_log_ppb"](obs)
            if len(live) > frontier_cap:
                order = np.argsort(nxt[live])
                live = live[order[-frontier_cap:]]
            frontier = [int(j) for j in live]
            logp = nxt
            backs.append(back)
            if num_results_kept is not None and len(backs) >= num_results_kept:
                backs.pop(0)
        best = int(logp.argmax())
        idx_path = [best]
        for back in reversed(backs):
            prev = int(back[idx_path[-1]])
            if prev < 0:
                break
            idx_path.append(prev)
        return tuple(state_of[i] for i in reversed(idx_path))

    class HmmViterbiAccumulator(BaseCustomAccumulator):
        """Holds the time-tagged observation multiset; decodes on demand.
        Combination is a commutative merge, so the result is independent
        of reducer combination order (the engine's multiset contract)."""

        def __init__(self, time: int, observation: Any):
            self.obs: list[tuple[int, Any]] = [(time, observation)]

        @classmethod
        def from_row(cls, row: list[Any]) -> "HmmViterbiAccumulator":
            time, observation = row
            return cls(time, observation)

        def update(self, other: "HmmViterbiAccumulator") -> None:
            self.obs.extend(other.obs)

        def compute_result(self) -> Any:
            ordered = [o for (_t, o) in sorted(self.obs, key=lambda p: p[0])]
            return decode(ordered)

        def serialize(self) -> bytes:
            return pickle.dumps(self.obs)

        @classmethod
        def deserialize(cls, val: bytes) -> "HmmViterbiAccumulator":
            obj = cls.__new__(cls)
            obj.obs = pickle.loads(val)  # noqa: S301
            return obj

    base = udf_reducer(HmmViterbiAccumulator)

    def reducer(observation_column: Any):
        # prepend the engine timestamp so decode order is event order
        return base(_EngineTimeMarker(), observation_column)

    return reducer


__all__ = ["create_hmm_reducer"]
