"""pw.xpacks — extension packs (llm)."""
from pathway_tpu_torch.xpacks import llm

__all__ = ["llm"]
