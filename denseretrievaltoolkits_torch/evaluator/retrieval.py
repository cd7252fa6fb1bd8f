"""Offline retrieval CLI: pickled embedding shards -> top-k ranking file.

Counterpart of ``denseretrievaltoolkits_tpu/evaluator/retrieval.py``, with the
same flags and output: glob the passage shards (pickled ``(reps, lookup)``
pairs), load them into one :class:`FlatIPIndex` (or load a saved index of any
ported kind with ``--index_path``: flat, IVF, IVFR or a PCA/PCAR chain),
search the pickled query reps at depth, and save ``qid\\tdocid\\tscore`` text
or a pickle. The index runs on the CUDA card: ``--index_dtype`` float32 /
bfloat16 / int8 / int4 (both quantized on the card) and the ``--search_mode``
of ``index/modes.py`` for the index's kind (flat: exact, serve, partial, i8q,
approx; IVF: bulk, probe, i8q, approx, exact). :func:`run` takes
``device='cpu'`` for callers that want the CPU (flat modes then run the exact
scan, IVF modes the kernels' plain versions). The small helpers are
reimplemented here because the reference module imports its jax index.

    python -m denseretrievaltoolkits_torch.evaluator.retrieval \\
        --query_reps q.pkl --passage_reps 'p*.pkl' --depth 100 \\
        --save_ranking_to run.tsv --save_text
"""

from __future__ import annotations

import glob
import logging
import pickle
from argparse import ArgumentParser

import numpy as np

from ..index.flat import FlatIPIndex

logger = logging.getLogger(__name__)


def pickle_load(path):
    with open(path, "rb") as fh:
        reps, lookup = pickle.load(fh)
    return np.array(reps, dtype=np.float32), list(lookup)


def pickle_save(obj, path):
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def search_queries(retriever, q_reps, p_lookup, depth: int, batch_size: int = 0,
                   quiet: bool = False, mode: str = "exact"):
    """Search and translate row ids to docids. Rows with the -1 sentinel are
    dropped before translation (``p_lookup[-1]`` would name the last doc)."""
    if batch_size > 0:
        all_scores, all_indices = retriever.batch_search(q_reps, depth, batch_size, quiet,
                                                         mode=mode)
    else:
        all_scores, all_indices = retriever.search(q_reps, depth, mode=mode)
    all_indices = np.asarray(all_indices)
    if (all_indices < 0).any():
        scores, ids = [], []
        for q_s, q_dd in zip(np.asarray(all_scores), all_indices):
            keep = q_dd >= 0
            ids.append([str(p_lookup[x]) for x in q_dd[keep]])
            scores.append(list(q_s[keep]))
        return scores, ids
    psg_indices = np.array([[str(p_lookup[x]) for x in q_dd] for q_dd in all_indices])
    return all_scores, psg_indices


def write_ranking(corpus_indices, corpus_scores, q_lookup, ranking_save_file: str):
    with open(ranking_save_file, "w") as fh:
        for qid, q_doc_scores, q_doc_indices in zip(q_lookup, corpus_scores, corpus_indices):
            ranked = sorted(zip(q_doc_scores, q_doc_indices), key=lambda x: x[0], reverse=True)
            for s, idx in ranked:
                fh.write(f"{qid}\t{idx}\t{s}\n")


def run(query_reps: str, passage_reps: str = "", save_ranking_to: str = "",
        depth: int = 1000, batch_size: int = 128, save_text: bool = False,
        quiet: bool = False, index_dtype: str = "float32",
        search_mode: str = "exact", index_path: str = "", device=None):
    """Build or load the index on ``device`` (the card by default), search,
    and save the ranking. Returns (scores, docids)."""
    if index_path:
        from ..index.io import load_index

        retriever = load_index(index_path, device=device)
        look_up = list(retriever.docid)
        if not look_up:
            raise ValueError(f"index at {index_path} carries no docids")
    else:
        index_files = sorted(glob.glob(passage_reps))
        if not index_files:
            raise FileNotFoundError(f"no passage rep shards match {passage_reps}")
        logger.info("Pattern matched %d shard files; loading into index.", len(index_files))
        look_up = []
        retriever = None
        for path in index_files:
            p_reps, p_lookup = pickle_load(path)
            if retriever is None:
                retriever = FlatIPIndex(p_reps.shape[1], dtype=index_dtype, device=device)
            retriever.add(p_reps)
            look_up += p_lookup

    q_reps, q_lookup = pickle_load(query_reps)
    logger.info("Index search start (%d docs, %d queries, depth %d)",
                len(retriever), len(q_reps), depth)
    all_scores, psg_indices = search_queries(
        retriever, q_reps, look_up, depth, batch_size, quiet, mode=search_mode)
    logger.info("Index search finished")
    if save_text:
        write_ranking(psg_indices, all_scores, q_lookup, save_ranking_to)
    else:
        pickle_save((all_scores, psg_indices), save_ranking_to)
    return all_scores, psg_indices


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    parser = ArgumentParser()
    parser.add_argument("--query_reps", required=True)
    parser.add_argument("--passage_reps", default="",
                        help="glob of pickled (reps, lookup) shards to build a flat index "
                        "from (mutually exclusive with --index_path)")
    parser.add_argument("--index_path", default="",
                        help="serve a SAVED index instead: flat, IVF, IVFR or a PCA/PCAR chain "
                        "(index.io.load_index)")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--depth", type=int, default=1000)
    parser.add_argument("--save_ranking_to", required=True)
    parser.add_argument("--save_text", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--index_dtype", default="float32",
                        choices=["float32", "bfloat16", "int8", "int4"],
                        help="float32 / bfloat16 rows, or int8 / int4 rows with per-row "
                        "scales (quantized on the card by K7 / K9; int4 packs two dims to a "
                        "byte, half the memory of int8)")
    parser.add_argument("--search_mode", default="exact",
                        choices=["exact", "serve", "partial", "i8q", "approx", "bulk", "probe"],
                        help="flat indexes: exact, certified exact search (K5; K6 on int8, "
                        "K10 on int4); serve: K8 (K11 on int4) candidates without the "
                        "certificate; partial: K5 candidates without the certificate "
                        "(fp32/bf16); i8q: int8 queries on K12 (int8 / int4 rows); approx: the "
                        "per-dtype alias. IVF indexes (--index_path): bulk (alias serve), the "
                        "cell-major search on K13 / K14; probe, the per-query gathered "
                        "path; i8q, bulk with int8 queries (int8 cells); approx, i8q on int8 "
                        "cells, else bulk; exact, the flat scan. Contract: index/modes.py")
    args = parser.parse_args(argv)
    if bool(args.passage_reps) == bool(args.index_path):
        parser.error("give exactly one of --passage_reps / --index_path")
    run(args.query_reps, args.passage_reps, args.save_ranking_to, args.depth,
        args.batch_size, args.save_text, args.quiet, args.index_dtype,
        args.search_mode, index_path=args.index_path)


if __name__ == "__main__":
    main()
