"""The port's host layers are a faithful copy of the JAX package's.

The modules below were copied from ``pathway_tpu/`` under one rule: every
``pathway_tpu`` that stands as a whole word (imports and module-path
strings alike) becomes ``pathway_tpu_torch``. Docstrings and comments may
be reworded; code may not differ. Each module is compared as an AST dump
with docstrings dropped, against the JAX module after the same rename.
The seam modules, where the port reaches its own device plane, differ on
purpose and are named as exceptions. The host C++ kernels are copied byte
for byte, bar their comments' citations of the reference's sources, which
name them relative to its checkout (``reference/src/...``) rather than by
an absolute path.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "pathway_tpu", REPO / "pathway_tpu_torch"
RENAME = re.compile(r"\bpathway_tpu\b")
ABSOLUTE_REFERENCE = re.compile(rb"/\w+/reference/")

# packages and modules copied verbatim (globs relative to the package)
VERBATIM = [
    "internals/*.py",
    "internals/expressions/*.py",
    "engine/core.py",
    "engine/runtime.py",
    "engine/morsel.py",
    "engine/faults.py",
    "engine/frontier.py",
    "engine/transformer.py",
    "engine/workers.py",
    "engine/cone.py",
    "io/**/*.py",
    "persistence/*.py",
    "analysis/*.py",
    "debug/*.py",
    "demo/*.py",
    "parallel/process_mesh.py",
    "indexing/tiers.py",
    "serving/__init__.py",
    "serving/admission.py",
    "serving/backpressure.py",
    "serving/gateway.py",
    "stdlib/indexing/colnames.py",
    "stdlib/indexing/retrievers.py",
    "stdlib/indexing/data_index.py",
    "stdlib/indexing/filters.py",
    "stdlib/indexing/sorting.py",
    "stdlib/indexing/bm25.py",
    "stdlib/indexing/hybrid_index.py",
    "stdlib/indexing/vector_document_index.py",
    "stdlib/indexing/full_text_document_index.py",
    "stdlib/indexing/lowering.py",
    "stdlib/temporal/*.py",
    "stdlib/ordered/*.py",
    "stdlib/utils/*.py",
    "xpacks/llm/splitters.py",
    "xpacks/llm/parsers.py",
    "xpacks/llm/prompts.py",
    "xpacks/llm/_utils.py",
    "xpacks/llm/mocks.py",
    "xpacks/llm/document_store.py",
    "xpacks/llm/question_answering.py",
    "xpacks/llm/servers.py",
    "xpacks/__init__.py",
]

# the seams: ported, not copied (and the JAX-only version shim, not carried).
# internals/udfs.py is a seam too, but under the rename its batched path
# already takes its coalescer from the port's own device plane, so it is
# held to the copy like the rest.
EXCEPTIONS = {
    "internals/jax_compat.py",  # the JAX version shim; the port has no JAX
    "internals/metrics.py",  # reads the port plane's shape ledger
    # repaired in the port: a run takes its seq where it enters the run
    # list, and a merged run the newest snapshot run's seq, so seqs stay in
    # list order when a seal races a compaction (the reference keeps the
    # race: ROADMAP C3, tests/test_torch_tiers.py pins the repair)
    "engine/spill.py",
}

NATIVE_SOURCES = ["engine/native/zset.cpp", "engine/native/dataplane.cpp"]


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(getattr(body[0], "value", None), ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _dump(source: str) -> str:
    return ast.dump(_strip_docstrings(ast.parse(source)), include_attributes=False)


def _verbatim_modules() -> list[str]:
    rels: set[str] = set()
    for pattern in VERBATIM:
        rels |= {str(p.relative_to(JAX)) for p in JAX.glob(pattern)}
    return sorted(rels - EXCEPTIONS)


def test_host_modules_are_the_jax_modules_under_the_rename():
    mods = _verbatim_modules()
    assert len(mods) >= 110, len(mods)
    missing = [rel for rel in mods if not (PORT / rel).is_file()]
    assert not missing, missing
    differ = [
        rel for rel in mods
        if _dump((PORT / rel).read_text()) != _dump(RENAME.sub("pathway_tpu_torch", (JAX / rel).read_text()))
    ]
    assert not differ, differ
    # the rename never doubles up
    assert not [rel for rel in mods if "pathway_tpu_torch_torch" in (PORT / rel).read_text()]


def test_seam_modules_differ_only_where_named():
    """Each exception is a real module of the port (bar the JAX shim,
    which the port does not carry), so the list cannot go stale."""
    assert not (PORT / "internals/jax_compat.py").exists()
    for rel in EXCEPTIONS - {"internals/jax_compat.py"}:
        assert (PORT / rel).is_file(), rel


def test_native_sources_are_byte_identical():
    for rel in NATIVE_SOURCES:
        want = ABSOLUTE_REFERENCE.sub(b"reference/", (JAX / rel).read_bytes())
        assert (PORT / rel).read_bytes() == want, rel


def test_the_port_passes_its_own_lint():
    """The repo lint, copied with the rest, holds over the port's whole
    package (its default root follows the rename)."""
    proc = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.analysis.lint"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pathway_tpu_torch.analysis.lint: 0 violations" in proc.stdout
