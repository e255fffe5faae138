"""Static soundness plane: analyses that re-derive, independently of the
optimizer and the engine, the invariants the codebase's transforms assume.

Three parts (docs/static-analysis.md):

* ``internals/verifier.py`` — the plan verifier: runs between lowering
  and engine construction and re-proves every optimizer-assumed
  invariant over the built plan (``PATHWAY_VERIFY``).
* ``analysis/lockgraph.py`` — the lock-order analyzer: a runtime
  recorder over the registered engine locks that fails the run on any
  acquisition-order cycle (``PATHWAY_LOCK_CHECK=1``).
* ``analysis/lint.py`` — the repo lint suite: AST checks encoding rules
  this codebase has paid for (hot-path env reads, swallowed I/O errors,
  jit-under-lock, outbox bypass); ``python -m pathway_tpu_torch.analysis.lint``.
"""

from pathway_tpu_torch.analysis import lockgraph

__all__ = ["lockgraph"]
