"""Train and evaluate the cross-encoder reranker over a dense retriever's dumps.

Counterpart of the root ``run_reranker.py`` of the JAX package (:29-106), with
the same flags: the tokenizer, ``RRModel.build``, the ExactMatch train split's
pair loader (``get_rr_dataloader``), the retriever's dump under
``{cache_train_dir}/retrieve`` as the evaluation pairs (``RRDataset``), the
``RRTrainer``, ``--resume_from``, ``max_epochs`` epochs of training with the
save cadence (none with ``--eval_only``), then ``evaluate(eval_dl, 3)``:

    python -m denseretrievaltoolkits_torch.run_reranker \\
        --model_name_or_path <dir saved by either package> --tokenizer_name <dir> \\
        --dataset nq --data_dir <train jsonl> --cache_train_dir <the retriever's cache> \\
        --loss_fn mr [--eval_only]

It runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU.
Under ``torchrun`` each process trains on ``cuda:LOCAL_RANK`` (or ``device``)
over a data-parallel mesh of all the processes (its shard of the train pairs;
every rank scores the evaluation pairs, rank 0 writes them). A BERT tokenizer
directory and local JSON files need neither ``transformers`` nor ``datasets``
(``utils/tokenization.py``, ``data/datasets.py``). ``--dp_size`` / ``--tp_size``
lay the processes out as a data x model mesh, made before anything loads: a BERT
tower is cut over the model axis (``parallel/mesh.py``), a T5 one stays whole.
"""

from __future__ import annotations

import logging

from .config import DataArguments, ModelArguments, RRTrainingArguments, parse_args
from .run_random_sampling import data_parallel_mesh, data_shard

logger = logging.getLogger(__name__)


def main(argv=None, eval_only: bool = False, device=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    model_args, data_args, training_args = parse_args(
        (ModelArguments, DataArguments, RRTrainingArguments), args=argv)

    import torch

    from .utils.runtime import setup_runtime

    device = setup_runtime(device)
    mesh = data_parallel_mesh(training_args)

    from .data.datasets import ExactMatchDataset, RRDataset
    from .data.loaders import ExactMatchDataloader, RerankerDataloader
    from .data.samplers import RandomSampleNegatives
    from .models.reranker import RRModel
    from .train.trainer import RRTrainer
    from .utils.tokenization import load_tokenizer

    tokenizer = load_tokenizer(model_args)
    model = RRModel.build(model_args, data_args, training_args, tokenizer=tokenizer,
                          device=device, seed=training_args.seed)

    cache = data_args.data_cache_dir or model_args.cache_dir
    batch_size = [training_args.train_batch_size, training_args.eval_batch_size,
                  training_args.test_batch_size]
    shard_num, shard_idx = data_shard(mesh)
    dataset = ExactMatchDataset(data_args, tokenizer, cache_dir=cache)
    rnd_sampler = RandomSampleNegatives(data_args, seed=training_args.seed)
    dataloader = ExactMatchDataloader(data_args, dataset, tokenizer, rnd_sampler,
                                      batch_size=batch_size, seed=training_args.seed,
                                      shard_num=shard_num, shard_idx=shard_idx)
    train_dl = dataloader.get_rr_dataloader()

    eval_dataset = RRDataset(data_args, training_args, tokenizer, cache)
    eval_dl = RerankerDataloader(data_args, eval_dataset, tokenizer,
                                 batch_size=training_args.eval_batch_size).get_eval_dataloader()

    trainer = RRTrainer(training_args, model, train_loader=train_dl,
                        mesh=mesh)
    if training_args.resume_from:
        trainer.load(training_args.resume_from)
    if not eval_only and training_args.max_epochs > 0:
        for ep in range(trainer.start_epoch, training_args.max_epochs):
            trainer.train_loader.set_epoch(ep)
            losses = [trainer.train_step(b) for b in trainer.train_loader]
            mean = float(torch.stack(losses).mean()) if losses else 0.0  # one sync an epoch
            logger.info("epoch %d mean loss %.4f", ep + 1, mean)
            if (ep + 1) % training_args.save_per_train == 0:
                trainer.save(ep + 1)
    return trainer.evaluate(eval_dl, 3)


if __name__ == "__main__":
    import sys

    main([a for a in sys.argv[1:] if a != "--eval_only"], eval_only="--eval_only" in sys.argv)
