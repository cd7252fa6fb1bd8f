"""denseretrievaltoolkits_torch: the PyTorch + CUDA port of denseretrievaltoolkits_tpu.

The JAX package beside it is the reference. This package holds the serving
path: the BERT dual encoder (``models/``), its fused encoder-block kernels and
the exact block top-k kernel (``ops/`` + ``csrc/``), the flat inner-product
index (``index/``), the offline retrieval CLI (``evaluator/``) and the encode
CLI (``run_encode``). It imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
