"""denseretrievaltoolkits_torch: the PyTorch + CUDA port of denseretrievaltoolkits_tpu.

The JAX package beside it is the reference. This package holds the serving
path: the BERT and T5 dual encoders and the cross-encoder reranker
(``models/``), the fused encoder-block kernels, the block top-k kernel family
and int8 quantization (``ops/`` + ``csrc/``), the flat inner-product index in
fp32, bf16 and int8 (``index/``), the offline retrieval CLI (``evaluator/``)
and the encode CLI (``run_encode``); the training path (``train/``, with
the reranker's ``RRTrainer``); and data parallelism with the sharded indexes
over ``torch.distributed`` ranks, one a card (``parallel/``). It imports ``torch``, never ``jax`` and nothing
of the JAX package (it keeps its own ``config``, ``data`` and
``index.modes``). Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
