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
On a host with several cards it trains on the one ``device`` names: the
full-batch step there has the gradient of the reference's data-parallel mesh.
The tokenizer (``transformers``) and the datasets (``datasets``) are loaded
inside :func:`main`, so they are needed only where it runs. With
``--mine_per_train N`` a ``DenseMiner`` refreshes the train set's negatives
from the evaluation index every N epochs, as the root script attaches it.
Tensor parallelism (``--tp_size`` > 1) is a later slice: :func:`main` refuses
it before anything loads, naming its ROADMAP item.
"""

from __future__ import annotations

import logging

from .config import DataArguments, ModelArguments, TrainingArguments, parse_args


def refuse_tensor_parallel(training_args) -> None:
    """``--tp_size`` > 1 raises before anything loads: tensor parallelism is a later
    slice."""
    if training_args.tp_size > 1:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP queue 1, "
                                  "item '`parallel/` and `utils/distributed.py`')")


def main(argv=None, device=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    model_args, data_args, training_args = parse_args(
        (ModelArguments, DataArguments, TrainingArguments), args=argv)
    refuse_tensor_parallel(training_args)

    from .utils.runtime import setup_runtime

    device = setup_runtime(device)

    from .data.datasets import EXACTMATCH_DATASET, CorpusDataset, ExactMatchDataset, \
        RelevancyDataset
    from .data.loaders import CorpusDataloader, ExactMatchDataloader, RelevancyDataloader
    from .data.samplers import RandomSampleNegatives
    from .models.biencoder import DRModel
    from .train.trainer import Trainer
    from .utils.distributed import process_shard
    from .utils.tokenization import load_tokenizer

    tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device, seed=training_args.seed)

    is_exactmatch = data_args.dataset in EXACTMATCH_DATASET
    dataset_cls = ExactMatchDataset if is_exactmatch else RelevancyDataset
    loader_cls = ExactMatchDataloader if is_exactmatch else RelevancyDataloader
    cache = data_args.data_cache_dir or model_args.cache_dir

    batch_size = [training_args.train_batch_size, training_args.eval_batch_size,
                  training_args.test_batch_size]
    shard_num, shard_idx = process_shard()
    dataset = dataset_cls(data_args, tokenizer, cache_dir=cache)
    rnd_sampler = RandomSampleNegatives(data_args, seed=training_args.seed)
    corpus = CorpusDataset(data_args, tokenizer, cache)
    dataloader = loader_cls(data_args, dataset, tokenizer, rnd_sampler, batch_size=batch_size,
                            seed=training_args.seed, shard_num=shard_num, shard_idx=shard_idx)
    train_dl, eval_dl, test_dl = dataloader.get_dataloader()
    corpus_dl = CorpusDataloader(data_args, corpus, tokenizer, training_args.corpus_batch_size,
                                 shard_hosts=shard_num > 1).get_dataloader()

    trainer = Trainer(training_args, model, corpus_dataloader=corpus_dl, train_loader=train_dl,
                      eval_loader=eval_dl, test_loader=test_dl,
                      label_kind="answers" if is_exactmatch else "docids")
    if training_args.mine_per_train:
        from .mine.miner import DenseMiner

        trainer.miner = DenseMiner(trainer, tokenizer, data_args)
    if training_args.resume_from:
        trainer.load(training_args.resume_from)
    trainer.train()


if __name__ == "__main__":
    main()
