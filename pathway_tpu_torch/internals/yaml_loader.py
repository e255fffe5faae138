"""pw.load_yaml: declarative app/template configs
(reference: internals/yaml_loader.py — `$var` refs + class-instantiation tags).

Syntax:
  variables start with `$` and can be referenced as values;
  a mapping with a `!full.path.to.Class` tag (or {"_type": "path"}) is
  instantiated with the mapping as kwargs.
"""

from __future__ import annotations

import importlib
from typing import Any, IO

try:
    import yaml  # type: ignore

    _HAS_YAML = True
except Exception:  # noqa: BLE001
    _HAS_YAML = False


def _resolve_class(path: str) -> Any:
    if ":" in path:
        mod, name = path.split(":", 1)
    else:
        mod, _, name = path.rpartition(".")
    m = importlib.import_module(mod)
    obj = m
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _instantiate(node: Any, variables: dict[str, Any]) -> Any:
    if isinstance(node, dict):
        out = {k: _instantiate(v, variables) for k, v in node.items()}
        if "_type" in out:
            cls = _resolve_class(out.pop("_type"))
            call = out.pop("_call", True)
            return cls(**out) if call else cls
        return out
    if isinstance(node, list):
        return [_instantiate(v, variables) for v in node]
    if isinstance(node, str) and node.startswith("$"):
        name = node[1:]
        if name in variables:
            return variables[name]
    return node


class _TaggedNode:
    def __init__(self, tag: str, value: Any):
        self.tag = tag
        self.value = value


def load_yaml(stream: str | IO) -> Any:
    """Parse a YAML template into instantiated objects."""
    if not _HAS_YAML:
        raise ImportError("pyyaml is not available in this environment")

    class Loader(yaml.SafeLoader):
        pass

    def unknown(loader: Any, suffix: str, node: Any) -> Any:
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
        return _TaggedNode(suffix, value)

    Loader.add_multi_constructor("!", unknown)
    data = yaml.load(stream, Loader)  # noqa: S506

    variables: dict[str, Any] = {}

    def resolve(node: Any) -> Any:
        if isinstance(node, _TaggedNode):
            cls = _resolve_class(node.tag)
            if isinstance(node.value, dict):
                kwargs = {k: resolve(v) for k, v in node.value.items()}
                return cls(**kwargs)
            if node.value in (None, ""):
                return cls()
            return cls(resolve(node.value))
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str) and node.startswith("$") and node[1:] in variables:
            return variables[node[1:]]
        return node

    if isinstance(data, dict):
        # two passes: collect $variables first
        for k, v in list(data.items()):
            if isinstance(k, str) and k.startswith("$"):
                variables[k[1:]] = resolve(v)
        out = {}
        for k, v in data.items():
            if isinstance(k, str) and k.startswith("$"):
                continue
            out[k] = resolve(v)
        return _instantiate(out, variables)
    return resolve(data)
