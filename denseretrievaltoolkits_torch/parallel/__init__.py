"""Data and tensor parallelism and the sharded indexes over ``torch.distributed`` ranks.

The JAX package lays one program over a mesh of devices. Here a mesh device
is one process (a rank), each driving one card it names explicitly
(``cuda:LOCAL_RANK`` from ``torchrun``, or the caller's device): the world is
laid out as ``dp_size x tp_size``, a data group per model index and a model
group per data index. Tensor parallelism cuts the BERT layers over the model
axis as GSPMD's Megatron rules do; the sharded indexes live on the data axis.
A single process driving several cards is not ported.

Backends: ``nccl`` for one rank a card; two ranks that share one card use
``gloo``, which stages CUDA tensors through the host (NCCL refuses a card
twice). The caller names the backend when it starts the process group
(``utils/distributed.py:maybe_initialize_distributed``).

- ``mesh.py``: :class:`~.mesh.Mesh`, ``make_mesh``, the start-up broadcast,
  the autograd-aware gather, the data-parallel step, and the model axis's cuts
  (``shard_module``), collectives and ``gathered``;
- ``sharded_index.py``: ``ShardedFlatIndex`` (flat kernels on each rank);
- ``sharded_ivf.py``: ``ShardedIVFIndex``, the collective transforms, the mesh
  factory and ``load_sharded_index``;
- ``sharded_pq.py``: ``ShardedPQIndex``.
"""
