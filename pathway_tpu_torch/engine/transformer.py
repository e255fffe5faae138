"""RowTransformerNode: the engine operator behind `@pw.transformer`.

Reference parity: the reference lowers row transformers through
complex_columns (internals/row_transformer.py) into pointer-chasing
dataflow; here one operator arranges every member table, evaluates output
attributes lazily per row (cross-table / cross-row references included),
and tracks ROW-LEVEL READ DEPENDENCIES: when input rows change, only the
transitive dependents re-evaluate — an O(affected) update, the same
incrementality contract as the rest of the engine.
"""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.engine.core import (
    Entry,
    Graph,
    InputNode,
    KeyedState,
    Node,
    delta_emit,
)
from pathway_tpu_torch.internals.errors import ERROR
from pathway_tpu_torch.internals.keys import Key


class _DeferEval(BaseException):
    """Internal control flow: evaluation too deep — compute `token`
    bottom-up first. BaseException so user-code `except Exception`
    blocks cannot swallow it."""

    def __init__(self, token: tuple):
        self.token = token


class _RowHandle:
    """`self` inside an output attribute: one row of one member table."""

    __slots__ = ("_node", "_tname", "_key")

    def __init__(self, node: "RowTransformerNode", tname: str, key: Key):
        self._node = node
        self._tname = tname
        self._key = key

    @property
    def id(self) -> Key:
        return self._key

    @property
    def transformer(self) -> "_TransformerHandle":
        return _TransformerHandle(self._node)

    def pointer_from(self, *args: Any) -> Key:
        from pathway_tpu_torch.internals.keys import key_for_values

        return key_for_values(*args)

    def __getattr__(self, attr: str) -> Any:
        return self._node.value_of(self._tname, self._key, attr)


class _TransformerHandle:
    __slots__ = ("_node",)

    def __init__(self, node: "RowTransformerNode"):
        self._node = node

    def __getattr__(self, tname: str) -> "_TableHandle":
        if tname not in self._node.metas:
            raise AttributeError(f"transformer has no table {tname!r}")
        return _TableHandle(self._node, tname)


class _TableHandle:
    __slots__ = ("_node", "_tname")

    def __init__(self, node: "RowTransformerNode", tname: str):
        self._node = node
        self._tname = tname

    def __getitem__(self, key: Key) -> _RowHandle:
        return _RowHandle(self._node, self._tname, key)


class RowTransformerNode(Node):
    """Inputs: one per member table (same order as `metas`)."""

    def __init__(self, graph: Graph, inputs: Sequence[Node], metas: dict[str, Any]):
        super().__init__(graph, inputs)
        self.metas = metas  # name -> _ClassMeta
        self.table_names = list(metas)
        self.states = {name: KeyedState() for name in metas}
        self.col_idx: dict[str, dict[str, int]] = {name: {} for name in metas}
        self.columns: dict[str, list[str]] = {}
        # evaluation cache: (tname, key.value, attr) -> value
        self.memo: dict[tuple, Any] = {}
        # row-level read dependencies: (tname, key.value) read by set of
        # (tname, key.value) whose outputs consumed it
        self.rev_deps: dict[tuple, set[tuple]] = {}
        self.fwd_deps: dict[tuple, set[tuple]] = {}
        self._eval_stack: list[tuple] = []
        self._current_reader: tuple | None = None
        self.emitted: dict[str, dict[Key, tuple]] = {name: {} for name in metas}
        self.out_nodes: dict[str, InputNode] = {}
        self._key_cache: dict[str, dict[int, Key]] = {name: {} for name in metas}

    def set_columns(self, name: str, columns: list[str]) -> None:
        self.columns[name] = columns
        self.col_idx[name] = {c: i for i, c in enumerate(columns)}

    def set_output_node(self, name: str, node: InputNode) -> None:
        self.out_nodes[name] = node

    def persist_signature(self) -> str:
        parts = [
            f"{n}:[{','.join(m.inputs)}]->[{','.join(m.outputs)}]"
            for n, m in self.metas.items()
        ]
        return "RowTransformerNode/" + ";".join(parts)

    def persist_state(self) -> dict:
        return {"states": self.states, "emitted": self.emitted}

    def restore_state(self, st: dict) -> None:
        self.states = st["states"]
        self.emitted = st["emitted"]
        self.memo.clear()
        self.rev_deps.clear()
        self.fwd_deps.clear()
        for name, state in self.states.items():
            self._key_cache[name] = {k.value: k for k in state.rows}
        # the dependency graph is not persisted; without it, incremental
        # invalidation would miss dependents of the first post-restore
        # change — re-evaluate everything once to rebuild it (delta_emit
        # suppresses unchanged outputs, so nothing re-emits spuriously)
        self._rebuild_all = True

    # ---------------------------------------------------------- evaluation

    def _record_read(self, target: tuple) -> None:
        reader = self._current_reader
        if reader is not None and reader[:2] != target:
            self.rev_deps.setdefault(target, set()).add(reader[:2])
            self.fwd_deps.setdefault(reader[:2], set()).add(target)

    # Native recursion costs ~3 Python frames per cross-row hop; chains
    # longer than this budget switch to the defer/worklist driver below
    # instead of blowing the interpreter stack.
    _DEPTH_BUDGET = 64

    def value_of(self, tname: str, key: Key, attr: str) -> Any:
        meta = self.metas[tname]
        self._record_read((tname, key.value))
        row = self.states[tname].get(key)
        if attr in meta.inputs:
            if row is None:
                raise KeyError(f"{tname}[{key}] does not exist")
            return row[self.col_idx[tname][attr]]
        if attr in meta.outputs:
            token = (tname, key.value, attr)
            if token in self.memo:
                return self.memo[token]
            if token in self._eval_stack:
                raise RecursionError(
                    f"row transformer cycle at {tname}.{attr} for {key}"
                )
            if row is None:
                raise KeyError(f"{tname}[{key}] does not exist")
            if len(self._eval_stack) >= self._DEPTH_BUDGET:
                # too deep to recurse natively: hand the token to the
                # worklist driver, which memoizes it bottom-up and
                # re-runs the shallow evaluations
                raise _DeferEval(token)
            prev_reader = self._current_reader
            self._current_reader = token
            self._eval_stack.append(token)
            try:
                value = meta.outputs[attr](_RowHandle(self, tname, key))
            finally:
                self._eval_stack.pop()
                self._current_reader = prev_reader
            self.memo[token] = value
            return value
        helper = meta.helpers.get(attr)
        if helper is not None:
            if callable(helper):
                import types

                return types.MethodType(helper, _RowHandle(self, tname, key))
            return helper
        raise AttributeError(f"{tname} has no attribute {attr!r}")

    def eval_output(self, tname: str, key: Key, attr: str) -> Any:
        """Worklist driver: evaluates `attr`, resolving arbitrarily deep
        cross-row dependency chains without native recursion overflow.
        Each deferred dependency is computed (memoized) first, then the
        deferring evaluation re-runs — O(chain) total fn executions."""
        pending: list[tuple] = [(tname, key.value, attr)]
        keys: dict[int, Key] = {key.value: key}
        while pending:
            t, kv, a = pending[-1]
            if (t, kv, a) in self.memo:
                pending.pop()
                continue
            k = keys.get(kv) or self._key_cache[t].get(kv)
            if k is None:
                raise KeyError(f"{t} has no row for key value {kv}")
            try:
                self.value_of(t, k, a)
                pending.pop()
            except _DeferEval as d:
                if d.token in pending:
                    raise RecursionError(
                        f"row transformer cycle at {d.token[0]}.{d.token[2]}"
                    ) from None
                pending.append(d.token)
                keys.setdefault(d.token[1], self._key_cache[d.token[0]].get(d.token[1]))
        return self.memo[(tname, key.value, attr)]

    def _invalidate(self, changed: set[tuple]) -> set[tuple]:
        """Transitive closure of rows whose outputs may change."""
        dirty: set[tuple] = set()
        frontier = list(changed)
        while frontier:
            item = frontier.pop()
            if item in dirty:
                continue
            dirty.add(item)
            frontier.extend(self.rev_deps.get(item, ()))
        for item in dirty:
            tname, kv = item
            for attr in self.metas[tname].outputs:
                self.memo.pop((tname, kv, attr), None)
            # drop this row's outgoing read edges; they re-register on
            # re-evaluation
            for target in self.fwd_deps.pop(item, ()):
                self.rev_deps.get(target, set()).discard(item)
        return dirty

    def finish_time(self, time: int) -> None:
        changed: set[tuple] = set()
        for i, name in enumerate(self.table_names):
            batch = self.take_input(i)
            if not batch:
                continue
            self.states[name].update(batch)
            for key, _row, _diff in batch:
                changed.add((name, key.value))
                self._key_cache[name][key.value] = key
        if getattr(self, "_rebuild_all", False):
            self._rebuild_all = False
            for name, state in self.states.items():
                changed.update((name, k.value) for k in state.rows)
        if not changed:
            return
        dirty = self._invalidate(changed)
        out_per_table: dict[str, list[Entry]] = {name: [] for name in self.metas}
        for tname, kv in dirty:
            key = self._key_cache[tname].get(kv)
            if key is None:
                continue
            meta = self.metas[tname]
            if not meta.outputs:
                continue
            row = self.states[tname].get(key)
            new: tuple | None
            if row is None:
                new = None  # row deleted: retract its outputs
            else:
                vals = []
                for attr in meta.outputs:
                    try:
                        vals.append(self.eval_output(tname, key, attr))
                    except Exception as e:  # noqa: BLE001
                        self.log_error(
                            f"transformer {tname}.{attr}: {type(e).__name__}: {e}"
                        )
                        vals.append(ERROR)
                new = tuple(vals)
            delta_emit(self.emitted[tname], out_per_table[tname], key, new)
        for name, entries in out_per_table.items():
            out_node = self.out_nodes.get(name)
            if out_node is not None and entries:
                out_node.push(entries)
                out_node.finish_time(time)
