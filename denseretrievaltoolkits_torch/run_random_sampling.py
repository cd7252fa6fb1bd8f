"""Train a DPR dual encoder with random negative sampling.

Counterpart of the root ``run_random_sampling.py`` of the JAX package
(:33-114), with the same flags: the dataclass triple from CLI flags or one
JSON file; the tokenizer, ``DRModel.build``, the ExactMatch or Relevancy
dataset and loader picked by registry, the corpus loader, the ``Trainer``,
``--resume_from``, then ``train()``:

    python -m denseretrievaltoolkits_torch.run_random_sampling \\
        --model_name_or_path <dir saved by either package> --tokenizer_name <dir> \\
        --dataset nq --data_dir <train/dev/test jsonl> --corpus_path corpus.jsonl \\
        --dtype bfloat16 --attention fused --fused_loss --grad_cache

It runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU.
Under ``torchrun`` each process trains on ``cuda:LOCAL_RANK`` (or ``device``)
over a data-parallel mesh of all the processes (``parallel/mesh.py``; the
process group starts as nccl for CUDA and gloo for the CPU, unless the caller
started one before): each loads its shard of the train set and its window of
the corpus, as the root script's mesh does.
A BERT tokenizer directory and local JSON files are read by the port's own
tokenizer and reader, without ``transformers`` or ``datasets``; a T5 tokenizer
or a hub dataset needs them (``utils/tokenization.py``, ``data/datasets.py``). With
``--mine_per_train N`` a ``DenseMiner`` refreshes the train set's negatives
from the evaluation index every N epochs, as the root script attaches it.
``--dp_size`` / ``--tp_size`` lay the processes out as a data x model mesh
(root run_random_sampling.py:95-99): ``torchrun --nproc_per_node 4 -m
denseretrievaltoolkits_torch.run_random_sampling ... --tp_size 2`` cuts each BERT
layer over two ranks (``parallel/mesh.py``) and trains two data shards. The
mesh is made before anything loads; a ``--tp_size`` the world size does not
divide raises there.
"""

from __future__ import annotations

import logging

from .config import DataArguments, ModelArguments, TrainingArguments, parse_args


def data_parallel_mesh(training_args):
    """The ``dp_size x tp_size`` mesh over the started process group when it has
    several ranks or ``tp_size`` > 1, else None (root run_random_sampling.py:95-99).
    Made before the loaders: each loads its data rank's shard."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1 or training_args.tp_size > 1:
        return make_mesh(training_args.dp_size, training_args.tp_size)
    return None


def data_shard(mesh) -> tuple:
    """(shard_num, shard_idx) of the loaders: the mesh's data axis (the ranks of one
    model group load the same shard), (1, 0) without a mesh."""
    return (mesh.size, mesh.rank) if mesh is not None else (1, 0)


def main(argv=None, device=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    model_args, data_args, training_args = parse_args(
        (ModelArguments, DataArguments, TrainingArguments), args=argv)

    from .utils.runtime import setup_runtime

    device = setup_runtime(device)
    mesh = data_parallel_mesh(training_args)

    from .data.datasets import EXACTMATCH_DATASET, CorpusDataset, ExactMatchDataset, \
        RelevancyDataset
    from .data.loaders import CorpusDataloader, ExactMatchDataloader, RelevancyDataloader
    from .data.samplers import RandomSampleNegatives
    from .models.biencoder import DRModel
    from .train.trainer import Trainer
    from .utils.tokenization import load_tokenizer

    tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device, seed=training_args.seed)

    is_exactmatch = data_args.dataset in EXACTMATCH_DATASET
    dataset_cls = ExactMatchDataset if is_exactmatch else RelevancyDataset
    loader_cls = ExactMatchDataloader if is_exactmatch else RelevancyDataloader
    cache = data_args.data_cache_dir or model_args.cache_dir

    batch_size = [training_args.train_batch_size, training_args.eval_batch_size,
                  training_args.test_batch_size]
    shard_num, shard_idx = data_shard(mesh)
    dataset = dataset_cls(data_args, tokenizer, cache_dir=cache)
    rnd_sampler = RandomSampleNegatives(data_args, seed=training_args.seed)
    corpus = CorpusDataset(data_args, tokenizer, cache)
    dataloader = loader_cls(data_args, dataset, tokenizer, rnd_sampler, batch_size=batch_size,
                            seed=training_args.seed, shard_num=shard_num, shard_idx=shard_idx)
    train_dl, eval_dl, test_dl = dataloader.get_dataloader()
    corpus_dl = CorpusDataloader(data_args, corpus, tokenizer, training_args.corpus_batch_size,
                                 shard_hosts=(shard_num, shard_idx) if shard_num > 1 else False
                                 ).get_dataloader()

    trainer = Trainer(training_args, model, corpus_dataloader=corpus_dl, train_loader=train_dl,
                      eval_loader=eval_dl, test_loader=test_dl,
                      mesh=mesh, label_kind="answers" if is_exactmatch else "docids")
    if training_args.mine_per_train:
        from .mine.miner import DenseMiner

        trainer.miner = DenseMiner(trainer, tokenizer, data_args)
    if training_args.resume_from:
        trainer.load(training_args.resume_from)
    trainer.train()


if __name__ == "__main__":
    main()
