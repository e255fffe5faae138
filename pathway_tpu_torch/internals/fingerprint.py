"""Structural fingerprints of op specs, INCLUDING function bodies.

Used by persistence to decide whether an operator snapshot is still
valid: the reference shares the caveat that a changed UDF body with an
unchanged pipeline shape silently reuses stale state (its signature
hashes only operator structure). Here every spec hashes its expression
trees and any embedded Python callables down to their bytecode, consts,
and closure contents — editing a lambda body invalidates the snapshot.

Determinism notes:
  * objects whose repr embeds a memory address (`... at 0x...`) hash by
    type name only, so fingerprints are stable across process restarts;
  * Table references inside expressions hash as an opaque marker — the
    referenced table's own node contributes its fingerprint to the
    pipeline signature separately (persistence/_pipeline_signature
    concatenates all nodes);
  * row Keys hash as a marker: sequential keys count from a process-wide
    counter, so their values are run-local, while the row VALUES beside
    them carry the data identity;
  * the object walk memoizes visited ids permanently (a revisit hashes
    as a marker), keeping it linear in the object graph — and only
    pathway-defined objects are traversed deeply: a connector or user
    object reaches sessions/threads/sockets, so it hashes by type.
"""

from __future__ import annotations

import functools
import hashlib
import re
import types
from typing import Any

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")

_MAX_DEPTH = 40


def _is_table(obj: Any) -> bool:
    return hasattr(obj, "_spec") and hasattr(obj, "_column_names")


def _feed_code(h: Any, fn: Any, seen: dict, depth: int) -> None:
    code = getattr(fn, "__code__", None)
    if code is None:
        if isinstance(fn, functools.partial):
            h.update(b"partial")
            _feed(h, fn.func, seen, depth + 1)
            _feed(h, fn.args, seen, depth + 1)
            _feed(h, tuple(sorted(fn.keywords.items())), seen, depth + 1)
            return
        h.update(f"builtin:{getattr(fn, '__qualname__', repr(fn))}".encode())
        return
    h.update(b"fn")
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            h.update(const.co_code)
            h.update(repr(const.co_names).encode())
        else:
            _feed(h, const, seen, depth + 1)
    _feed(h, getattr(fn, "__defaults__", None), seen, depth + 1)
    closure = getattr(fn, "__closure__", None) or ()
    for cell in closure:
        try:
            _feed(h, cell.cell_contents, seen, depth + 1)
        except ValueError:  # empty cell
            h.update(b"emptycell")


def _feed(h: Any, obj: Any, seen: dict, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        h.update(b"deep")
        return
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        h.update(f"{type(obj).__name__}:{obj!r}".encode())
        return
    oid = id(obj)
    if oid in seen:
        h.update(b"seen")
        return
    # the memo VALUE keeps the object alive for the walk's duration — a
    # plain id-set would let a freed temporary's id be reused by a
    # different object, which would then silently hash as b"seen"
    seen[oid] = obj
    if _is_table(obj):
        h.update(b"Table")
        return
    from pathway_tpu_torch.internals.keys import Key

    if isinstance(obj, Key):
        h.update(b"Key")
        return
    if isinstance(
        obj,
        (
            types.FunctionType,
            types.MethodType,
            types.BuiltinFunctionType,
            functools.partial,
        ),
    ):
        _feed_code(h, obj, seen, depth)
        return
    if isinstance(obj, type):
        h.update(f"type:{obj.__module__}.{obj.__qualname__}".encode())
        return
    if isinstance(obj, (list, tuple)):
        h.update(f"seq{len(obj)}".encode())
        for v in obj:
            _feed(h, v, seen, depth + 1)
        return
    if isinstance(obj, dict):
        h.update(f"map{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            _feed(h, k, seen, depth + 1)
            _feed(h, obj[k], seen, depth + 1)
        return
    if isinstance(obj, (set, frozenset)):
        h.update(f"set{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            _feed(h, k, seen, depth + 1)
        return
    # expression trees / reducers / dtypes / behaviors: traverse their
    # state. Anything else (connector objects, user classes) hashes
    # shallowly — their reachable graphs can be huge (sessions, threads)
    # and their identity is their type.
    d = getattr(obj, "__dict__", None)
    if d is not None and type(obj).__module__.startswith("pathway_tpu_torch"):
        h.update(f"obj:{type(obj).__qualname__}".encode())
        for k in sorted(d):
            if k.startswith("__"):
                continue
            h.update(k.encode())
            _feed(h, d[k], seen, depth + 1)
        return
    r = repr(obj)
    if " at 0x" in r:
        r = _ADDR_RE.sub("", r)
    h.update(f"{type(obj).__qualname__}:{r}".encode())


def fingerprint_spec(spec: Any) -> str:
    """8-byte hex fingerprint of one op spec (kind + params, with UDF
    bodies hashed). Never raises — an unhashable spec degrades to its
    kind alone (same caveat level as the reference)."""
    h = hashlib.blake2b(digest_size=8)
    try:
        h.update(str(getattr(spec, "kind", "?")).encode())
        params = getattr(spec, "params", None) or {}
        _feed(h, params, {})
    except Exception:  # noqa: BLE001 — degrade, never break lowering
        pass
    return h.hexdigest()
