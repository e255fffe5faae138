"""pw.ml — machine-learning stdlib (reference: stdlib/ml/).

Subpackages: index (KNNIndex facade), classifiers (kNN-LSH),
smart_table_ops (fuzzy joins), hmm (Viterbi decoding reducer), utils.
"""

from pathway_tpu_torch.stdlib.ml import classifiers, hmm, index, smart_table_ops, utils

__all__ = ["classifiers", "hmm", "index", "smart_table_ops", "utils"]
