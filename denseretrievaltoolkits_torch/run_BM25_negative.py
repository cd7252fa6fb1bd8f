"""Train a DPR dual encoder on BM25-mined hard negatives.

Counterpart of the root ``run_BM25_negative.py`` of the JAX package (:26-112),
with the same flags: tokenize the train split, mine (or load from the cache)
BM25 negatives over the train passage pool with ``BM25Negatives`` (the native
engine, built at first use), then train on the mined rows through the
``Trainer``, evaluating on dev and test when a corpus is given:

    python -m denseretrievaltoolkits_torch.run_BM25_negative \\
        --model_name_or_path <dir> --tokenizer_name <dir> --dataset nq \\
        --data_dir <train/dev/test jsonl> --corpus_path corpus.jsonl \\
        --data_cache_dir <cache> --train_n_passages 8

It runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU. As
``run_random_sampling.py`` here, it trains on the one device, or under
``torchrun`` over a ``--dp_size x --tp_size`` mesh of the processes (made before
anything loads), and reads a BERT tokenizer directory and local JSON files
without ``transformers`` or ``datasets``.
"""

from __future__ import annotations

import logging

from .config import DataArguments, ModelArguments, TrainingArguments, parse_args
from .run_random_sampling import data_parallel_mesh, data_shard

logger = logging.getLogger(__name__)


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
    from .data.samplers import BM25Negatives
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
    dataset = dataset_cls(data_args, tokenizer, cache_dir=cache)

    # mine hard negatives over the tokenized train passage pool
    bm25_sampler = BM25Negatives(data_args, tokenizer.vocab_size, seed=training_args.seed)
    train_dataset, _, _ = dataset.load_train()
    bm25dataset = bm25_sampler.load_passages(train_dataset)
    logger.info("BM25 negatives ready: %d samples", len(bm25dataset))

    shard_num, shard_idx = data_shard(mesh)
    dataloader = loader_cls(data_args, dataset, tokenizer, bm25_sampler, batch_size=batch_size,
                            seed=training_args.seed, shard_num=shard_num, shard_idx=shard_idx)
    _, eval_dl, test_dl = dataloader.get_dataloader()
    train_dl = dataloader.get_bm25dataloader(bm25dataset)

    corpus_dl = None
    if data_args.corpus_path or data_args.corpus_name != "json":
        corpus = CorpusDataset(data_args, tokenizer, cache)
        corpus_dl = CorpusDataloader(data_args, corpus, tokenizer,
                                     training_args.corpus_batch_size,
                                     shard_hosts=(shard_num, shard_idx) if shard_num > 1 else False
                                     ).get_dataloader()

    trainer = Trainer(training_args, model, corpus_dataloader=corpus_dl, train_loader=train_dl,
                      eval_loader=eval_dl if corpus_dl is not None else None,
                      test_loader=test_dl if corpus_dl is not None else None,
                      mesh=mesh, label_kind="answers" if is_exactmatch else "docids")
    if training_args.resume_from:
        trainer.load(training_args.resume_from)
    trainer.train()


if __name__ == "__main__":
    main()
