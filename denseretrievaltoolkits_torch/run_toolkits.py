#!/usr/bin/env python
"""Unified pipeline driver: train → encode → retrieve → rerank.

The reference's canonical recipe invokes a ``run_toolkits.py`` that is missing
from its repository (``run.sh:4``).  This provides that entry: one command
dispatching to the individual stages, sharing the config surface.

    python run_toolkits.py train_random  [flags | config.json]
    python run_toolkits.py train_bm25    [flags | config.json]
    python run_toolkits.py rerank        [flags | config.json]
    python run_toolkits.py encode        [flags | config.json]
    python run_toolkits.py retrieve      --query_reps ... --passage_reps ...
    python run_toolkits.py nq_eval       --retrieval ... --topk ...
"""

# The usage text above is the JAX package's root ``run_toolkits.py``'s, word for
# word; this twin runs the port's stages, as
# ``python -m denseretrievaltoolkits_torch.run_toolkits <stage> ...``, on the card,
# or on ``device`` where :func:`main` is called with one.

import sys


def main(argv=None, device=None):
    """Run ``argv[0]``'s stage on ``argv[1:]`` (``sys.argv[1:]`` by default) and
    return what the stage returns; an unknown or missing stage exits with the usage."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        raise SystemExit(__doc__)
    stage, argv = argv[0], argv[1:]

    if stage == "train_random":
        from . import run_random_sampling

        return run_random_sampling.main(argv, device=device)
    if stage == "train_bm25":
        from . import run_BM25_negative

        return run_BM25_negative.main(argv, device=device)
    if stage == "rerank":
        from . import run_reranker

        eval_only = "--eval_only" in argv
        argv = [a for a in argv if a != "--eval_only"]
        return run_reranker.main(argv, eval_only=eval_only, device=device)
    if stage == "encode":
        from . import run_encode

        return run_encode.main(argv, device=device)
    if stage == "retrieve":
        from .evaluator import retrieval

        return retrieval.main(argv, device=device)
    if stage == "nq_eval":
        from .evaluator import nq_eval

        return nq_eval.main(argv)
    raise SystemExit(f"unknown stage {stage!r}\n{__doc__}")


if __name__ == "__main__":
    main()
