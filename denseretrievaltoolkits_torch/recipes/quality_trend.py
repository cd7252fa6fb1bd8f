#!/usr/bin/env python
"""Quality-parity trend run: BASELINE.json config 1 at learning-curve scale, on the port.

The twin of the JAX package's ``recipes/quality_trend.py``: the same
deterministic synthetic NQ-style datasets (``make_dataset``,
``make_topical_dataset``, ``make_model_dir`` give byte-identical files for a
seed), the same args dict, driven through the port's
``run_random_sampling.main`` (or ``run_BM25_negative.main`` with ``--sampler
bm25``; ``--mine`` for dense mining), then with ``--rerank`` the port's
``run_reranker.main`` over the final retrieval dump. It prints the per-epoch
MRR@10 / NDCG@10 / Recall@10 / Recall@100 table and writes ``trend.json``.

The dataset is learnable by construction — each query shares its answer token
with its positive passage — so the metrics must climb epoch over epoch if the
contrastive training loop, the corpus->index flow, and the search path are
all correct. The model is a 4-layer/128-hidden tower; it runs on the CUDA card
(``--device cuda``, the default) or the CPU (``--device cpu``), with the port's
own tokenizer and JSON reader (no ``transformers`` or ``datasets``).

Usage: python -m denseretrievaltoolkits_torch.recipes.quality_trend [--out DIR]
       [--epochs 5] [--train 2000] [--eval 200] [--corpus 20000] [--device cuda]
"""

import argparse
import glob
import json
import os
import random
import tempfile

N_WORDS = 4000


def _words():
    return [f"tok{i:04d}" for i in range(N_WORDS)]


def make_dataset(out, rng, n_train, n_eval, n_corpus, n_neg=4):
    """Synthetic NQ-style jsonl splits + corpus in the Tevatron schema
    (the reference's canonical data shape, run.sh:13-14)."""
    words = _words()
    # disjoint noise/answer vocabularies: answer-containment labeling then
    # marks ONLY planted passages relevant, so the metric floor at random
    # init is ~0 and the curve measures actual learning
    noise_words = words[: N_WORDS - 512]
    answer_words = words[N_WORDS - 512:]
    data_dir = os.path.join(out, "data")
    os.makedirs(data_dir, exist_ok=True)

    def sent(n):
        return " ".join(rng.choice(noise_words) for _ in range(n))

    corpus_rows = [
        {"docid": f"d{i}", "title": sent(2), "text": sent(24)}
        for i in range(n_corpus)
    ]

    def make_split(n, start):
        rows = []
        for j in range(n):
            i = (start + j) % n_corpus
            answer = rng.choice(answer_words)
            # dilute the signal: the answer lands at a random position inside
            # a long passage, so the encoder must learn to surface it through
            # pooling rather than memorize a fixed slot
            toks = corpus_rows[i]["text"].split()
            toks.insert(rng.randrange(len(toks) + 1), answer)
            corpus_rows[i]["text"] = " ".join(toks)
            pos = {"docid": f"d{i}", "title": corpus_rows[i]["title"],
                   "text": corpus_rows[i]["text"]}
            negs = []
            for _ in range(n_neg):
                k = rng.randrange(n_corpus)
                negs.append({"docid": f"d{k}", "title": corpus_rows[k]["title"],
                             "text": corpus_rows[k]["text"]})
            rows.append({
                "query_id": f"q{start + j}",
                "query": sent(10) + " " + answer,
                "answers": [answer],
                "positive_passages": [pos],
                "negative_passages": negs,
            })
        return rows

    splits = {
        "train": make_split(n_train, 0),
        "dev": make_split(n_eval, n_train),
        "test": make_split(n_eval, n_train + n_eval),
    }
    for name, rows in splits.items():
        with open(os.path.join(data_dir, f"{name}.jsonl"), "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    corpus_path = os.path.join(out, "corpus.jsonl")
    with open(corpus_path, "w") as fh:
        for r in corpus_rows:
            fh.write(json.dumps(r) + "\n")
    return data_dir, corpus_path


def make_topical_dataset(out, rng, n_train, n_eval, n_corpus, n_neg=4,
                         n_topics=1024):
    """Clustered-topic corpus where HARD negatives are required (VERDICT r2
    next-round #5): every topic has a dedicated vocabulary, and a query's
    true competition is the ~n_corpus/n_topics same-topic passages that do
    NOT carry its entity token.

    Two design points make random negatives genuinely insufficient (the
    first cut of this workload missed both, and random WON — the failed
    curves are recorded in BASELINE.md):

    1. The entity (answer) token is UNIQUE per query.  When answer words
       were shared across ~4 queries, other queries' in-batch positives
       carried colliding answers, so plain in-batch training already put
       gradient on the entity feature.
    2. 1024 topics, not 256.  At 256 topics a 32-query batch has ~1.9
       same-topic collisions — random in-batch sampling accidentally
       supplies the hard negatives it is supposed to lack.  At 1024 the
       collision rate is ~0.5/batch.

    Cross-topic (random) negatives are separable by topic vocabulary alone,
    so the contrastive softmax saturates and the entity feature stops
    improving: Recall@100 goes to ~1 (the whole topic ranks high) while
    MRR@10 stalls at ~1/(corpus/topics).  BM25/dense-mined negatives are
    same-topic by construction (highest lexical / embedding overlap), so
    they force within-topic discrimination — the property hard-negative
    mining exists for (reference run_BM25_negative.py:53-55, ANCE-style
    refresh in mine/).
    """
    words = _words()
    n_topic_words = 8
    topic_vocab = [
        words[t * n_topic_words:(t + 1) * n_topic_words]
        for t in range(n_topics)
    ]  # dedicated, disjoint per topic
    n_entities = n_train + 2 * n_eval
    shared = words[n_topics * n_topic_words: N_WORDS - n_entities]
    answer_words = words[N_WORDS - n_entities:]
    data_dir = os.path.join(out, "data")
    os.makedirs(data_dir, exist_ok=True)

    def passage_text(topic):
        toks = [rng.choice(topic_vocab[topic]) for _ in range(10)] + \
               [rng.choice(shared) for _ in range(10)]
        rng.shuffle(toks)
        return " ".join(toks)

    corpus_rows = [
        {"docid": f"d{i}", "title": rng.choice(topic_vocab[i % n_topics]),
         "text": passage_text(i % n_topics)}
        for i in range(n_corpus)
    ]

    def make_split(n, start):
        rows = []
        for j in range(n):
            i = (start + j) % n_corpus
            topic = i % n_topics
            answer = answer_words[start + j]  # unique per query (point 1)
            toks = corpus_rows[i]["text"].split()
            toks.insert(rng.randrange(len(toks) + 1), answer)
            corpus_rows[i]["text"] = " ".join(toks)
            pos = {"docid": f"d{i}", "title": corpus_rows[i]["title"],
                   "text": corpus_rows[i]["text"]}
            negs = []
            for _ in range(n_neg):  # initial negatives: random cross-topic
                k = rng.randrange(n_corpus)
                negs.append({"docid": f"d{k}", "title": corpus_rows[k]["title"],
                             "text": corpus_rows[k]["text"]})
            query = " ".join(
                [rng.choice(topic_vocab[topic]) for _ in range(5)] + [answer])
            rows.append({
                "query_id": f"q{start + j}",
                "query": query,
                "answers": [answer],
                "positive_passages": [pos],
                "negative_passages": negs,
            })
        return rows

    splits = {
        "train": make_split(n_train, 0),
        "dev": make_split(n_eval, n_train),
        "test": make_split(n_eval, n_train + n_eval),
    }
    for name, rows in splits.items():
        with open(os.path.join(data_dir, f"{name}.jsonl"), "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    corpus_path = os.path.join(out, "corpus.jsonl")
    with open(corpus_path, "w") as fh:
        for r in corpus_rows:
            fh.write(json.dumps(r) + "\n")
    return data_dir, corpus_path


def make_model_dir(out):
    """Architecture-only model dir (bert_config.json, no weights.npz):
    DRModel.build random-inits from it — the offline-container path."""
    model_dir = os.path.join(out, "model")
    os.makedirs(model_dir, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + _words()
    with open(os.path.join(model_dir, "vocab.txt"), "w") as fh:
        fh.write("\n".join(vocab))
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "BertTokenizerFast",
                   "do_lower_case": True}, fh)
    with open(os.path.join(model_dir, "bert_config.json"), "w") as fh:
        json.dump({
            "vocab_size": len(vocab),
            "hidden_size": 128,
            "num_hidden_layers": 4,
            "num_attention_heads": 4,
            "intermediate_size": 256,
            "max_position_embeddings": 64,
        }, fh)
    return model_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "drt_quality_trend"))
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--eval", type=int, default=200)
    ap.add_argument("--corpus", type=int, default=20000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--mine", type=int, default=0,
                    help="mine_per_train cadence: refresh hard negatives from "
                         "the device index every N epochs (0 = random only)")
    ap.add_argument("--rerank", action="store_true",
                    help="after the dense run, train + evaluate the cross-"
                         "encoder reranker over the final retrieval dump "
                         "(the full two-stage reference pipeline)")
    ap.add_argument("--workload", default="planted",
                    choices=["planted", "topical"],
                    help="planted: the r2 curve workload (answer tokens in "
                         "otherwise-isotropic noise). topical: clustered "
                         "topic vocabularies where random negatives saturate "
                         "and hard (BM25/mined) negatives are required for "
                         "within-topic ranking")
    ap.add_argument("--sampler", default="random", choices=["random", "bm25"],
                    help="random: run_random_sampling (in-batch random "
                         "negatives; combine with --mine for dense mining). "
                         "bm25: run_BM25_negative (offline BM25-mined hard "
                         "negatives)")
    ap.add_argument("--search_mode", default=None,
                    help="trainer eval search mode (exact|serve|partial|i8q|approx)")
    ap.add_argument("--n_passages", type=int, default=2,
                    help="train_n_passages: 1 positive + n-1 negatives per "
                         "query (the canonical reference recipes use 2 for "
                         "random and 8 for BM25 negatives, run.sh:56-145)")
    ap.add_argument("--device", default="cuda",
                    help="where the port trains and searches: cuda (the card) or cpu")
    ap.add_argument("--topics", type=int, default=1024,
                    help="topical workload: number of disjoint topic "
                         "vocabularies (collision rate of same-topic pairs "
                         "inside a 32-query batch ~ 496/topics)")
    ap.add_argument("--seed", type=int, default=0,
                    help="whole-experiment replicate seed: drives BOTH the "
                         "dataset generator and the trainer init/shuffle "
                         "(VERDICT r3 weak 6: single-seed margins are not "
                         "evidence — see recipes/quality_multiseed.py)")
    opts = ap.parse_args(argv)

    rng = random.Random(opts.seed)
    os.makedirs(opts.out, exist_ok=True)
    if opts.workload == "topical":
        # room for `topics` DISJOINT 8-word topic vocabularies + one unique
        # entity word per query + >=1024 shared noise words; the planted
        # workload keeps the r2-curve vocabulary for continuity
        n_entities = opts.train + 2 * opts.eval
        globals()["N_WORDS"] = opts.topics * 8 + n_entities + 1024
        data_dir, corpus_path = make_topical_dataset(
            opts.out, rng, opts.train, opts.eval, opts.corpus,
            n_neg=max(4, opts.n_passages - 1), n_topics=opts.topics,
        )
    else:
        data_dir, corpus_path = make_dataset(
            opts.out, rng, opts.train, opts.eval, opts.corpus,
            n_neg=max(4, opts.n_passages - 1),
        )
    model_dir = make_model_dir(opts.out)
    cache = os.path.join(opts.out, "cache")

    args = {
        "model_name_or_path": model_dir,
        "dtype": "bfloat16",
        "dataset": "nq",
        "data_dir": data_dir,
        "corpus_path": corpus_path,
        "train_n_passages": opts.n_passages,
        "q_max_len": 16,
        "p_max_len": 32,
        "data_cache_dir": os.path.join(opts.out, "hfcache"),
        "output_dir": os.path.join(opts.out, "out"),
        "cache_train_dir": cache,
        "train_batch_size": 32,
        "eval_batch_size": 64,
        "test_batch_size": 64,
        "corpus_batch_size": 512,
        "max_epochs": opts.epochs,
        "eval_per_train": 1,
        "save_per_train": opts.epochs,
        "learning_rate": opts.lr,
        "optimizer": "adamw",
        "scheduler": "linear",
        "scheduler_kwargs": {"init_lr": 0.0, "n_warmup_steps": 20,
                             "max_steps": max(1, opts.train // 32) * opts.epochs},
        "topk": "5,10,100",
        "retrieve_num": 100,
        "seed": opts.seed,
        "mine_per_train": opts.mine,
    }
    if opts.search_mode:
        args["search_mode"] = opts.search_mode
    args_file = os.path.join(opts.out, "args.json")
    with open(args_file, "w") as fh:
        json.dump(args, fh, indent=2)

    if opts.sampler == "bm25":
        from ..run_BM25_negative import main as run_main
    else:
        from ..run_random_sampling import main as run_main

    run_main([args_file], device=opts.device)

    # collect the per-epoch metrics the trainer dumped ({ep}.0_metrics)
    rows = []
    for path in glob.glob(os.path.join(cache, "*_metrics")):
        ep = os.path.basename(path).split(".")[0]
        with open(path) as fh:
            m = json.load(fh)
        rows.append((ep, m))
    # numeric epoch order, with the final test eval (ep -1) last
    rows.sort(key=lambda r: (int(r[0]) if int(r[0]) >= 0 else 10**9))
    print("\n| epoch | MRR@10 | NDCG@10 | Recall@10 | Recall@100 |")
    print("|---|---|---|---|---|")
    for ep, m in rows:
        label = "test" if ep == "-1" else ep
        print(f"| {label} | {m.get('MRR@10', 0):.4f} | {m.get('NDCG@10', 0):.4f} "
              f"| {m.get('Recall@10', 0):.4f} | {m.get('Recall@100', 0):.4f} |")
    with open(os.path.join(opts.out, "trend.json"), "w") as fh:
        json.dump({ep: m for ep, m in rows}, fh, indent=2)
    result = {"trend": {ep: m for ep, m in rows}}

    if opts.rerank:
        # stage 2: cross-encoder reranker over the DENSE run's final dump
        # (run_reranker.py — the dense->rerank handoff, reference §3.4)
        import shutil

        rr_cache = os.path.join(opts.out, "rr_cache")
        os.makedirs(os.path.join(rr_cache, "retrieve"), exist_ok=True)
        final_dump = os.path.join(cache, "retrieve", "-1.0.json")
        shutil.copy(final_dump, os.path.join(rr_cache, "retrieve", "-1.0.json"))
        rr_args = dict(args)
        rr_args.update({
            "output_dir": os.path.join(opts.out, "rr_out"),
            "cache_train_dir": rr_cache,
            "max_epochs": 1,
            "loss_fn": "mr",
            "train_n_passages": 4,
        })
        rr_args.pop("mine_per_train", None)
        rr_file = os.path.join(opts.out, "rr_args.json")
        with open(rr_file, "w") as fh:
            json.dump(rr_args, fh, indent=2)
        from ..run_reranker import main as rr_main

        rr_main([rr_file], device=opts.device)
        with open(os.path.join(rr_cache, "3.0_RR_metrics")) as fh:
            rr_m = json.load(fh)
        dense_m = dict(rows)["-1"] if "-1" in dict(rows) else rows[-1][1]
        print("\n| stage | MRR@10 | NDCG@10 | Recall@10 |")
        print("|---|---|---|---|")
        print(f"| dense (test) | {dense_m.get('MRR@10', 0):.4f} | "
              f"{dense_m.get('NDCG@10', 0):.4f} | {dense_m.get('Recall@10', 0):.4f} |")
        print(f"| + reranker | {rr_m.get('MRR@10', 0):.4f} | "
              f"{rr_m.get('NDCG@10', 0):.4f} | {rr_m.get('Recall@10', 0):.4f} |")
        result["rerank"] = rr_m
    return result


if __name__ == "__main__":
    main()
