from pathway_tpu_torch.stdlib.utils import col
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = ["col", "AsyncTransformer", "pandas_transformer"]
