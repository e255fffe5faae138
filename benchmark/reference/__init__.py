"""The plain reference: PyTorch and NumPy in float32, independent of the
program. It imports neither JAX nor any module of the port, and takes
nothing the port built: the weights are made again from the seed
(``benchmark/weights.py``) and the token ids again from the text."""
