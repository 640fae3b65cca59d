"""fullbatchtraining_tpu_torch: the PyTorch/CUDA port of fullbatchtraining_tpu.

Full-batch training of vision classifiers on an NVIDIA Hopper card: PyTorch
for the model and the training loop, hand-written CUDA kernels for what the
JAX package wrote in Pallas (``ops/``). It reads the repository's shared
``config/`` tree and runs as ``python -m fullbatchtraining_tpu_torch``.
"""

__version__ = "0.1.0"
