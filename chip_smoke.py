#!/usr/bin/env python3
"""Drive the torch port's paths (serving, training, evaluation, IVF, PQ, flash, LoRA, mining, T5, reranking, parallelism, CLIs, recipes) once on a card; check them.

    python3 chip_smoke.py [--seed 0] [--passages 8192] [--out results.json] [--flash_only]
                          [--blocks_only] [--eval_only] [--ivf_only] [--train_only]
                          [--rerank_only] [--dist_only] [--cli_only] [--recipes_only]

Phases, each of which fails the run on error:

1. Build the hand-written kernels of ``denseretrievaltoolkits_torch/csrc``
   with nvcc (``_build/``, at first use) and print the build time.
2. Kernel vs plain version at the main paths' shapes: K1 (attention + LN) and
   K2 (MLP + LN) at bert-base widths, bf16 at B=64, S=156 and B=64, S=32
   (serving passages and queries), B=256, S=128 and B=32, S=32 (training
   passages and queries), fp32 at B=8, S=156, 306 and 512 (K1's fp32 path
   streams K/V over S above 306), and bf16 at B=64, S=256 and 257 (the two
   sides of K1's Hopper body's limit), each with its bound; each K1 row with
   the body it took and its stage A / stage B ms (``torch.profiler``); K2 bf16
   beside the xla block's bf16 chain on cuBLAS (``chain_ms``);
   K5 (block top-J) on a 1,000,000 x 768 corpus, fp32 and bf16, 1024 queries,
   k=100, through the certified search against the exact scan; then block by
   block at J = 8 and 32 on its Hopper bodies (fp32 products as fp16 pairs,
   ``flat_certified.cu``; bf16 on TMA + wgmma in the certified order,
   ``flat_serve.cu``; ``block_topj.launches_generic`` 0), with
   ``block_topj.cu``'s body on the same rows 2 elements off 16-byte alignment
   beside them: each body's time and largest |score - fp64|.
3. The main path, through the entry points a user calls: a bert-base
   (12 layers, H=768, bf16, ``attention='fused'``) dual encoder with seeded
   random weights built by ``DRModelForInference.build``; ``encode_batches``
   over lognormal-length passages (S=156) and queries (S=32); a float32
   ``FlatIPIndex``; ``batch_search(k=100, mode='exact')``; docids, a ranking
   file and ``get_metrics``. Launch counters are zeroed just before and read
   just after; every kernel must have launched. K5 is then held to its plain
   version at this path's own shape. The same path runs again with the plain
   versions in place of the three kernels, and the two must agree.
4. K3 / K4 (fused contrastive loss and its gradient) vs their plain versions,
   fp32, H=768, stride 8: at grad-cache scale (Q=4096, P=32768), ragged
   (Q=1000, P=8000) and at the training path's shape (Q=32, P=256). Loss
   and grad errors, kernel vs plain ms (forward, and
   forward + backward), peak device memory of each path; plain variants with
   the target one column off, or without the 1/n_q, must fail the bounds. K3
   runs its tensor-core body (fp16 pairs, a 128-row query tile a CTA, the
   passage axis in parts) and K4 its own (a cluster of four CTAs a 64-row
   tile), ``launches_generic`` 0; their largest |lse, tgt - fp64| and
   |grad - fp64| are printed beside the FFMA bodies' on the same inputs (the C
   entries without scratch), with both bodies' times and the parts; K3's may
   not exceed 2x the FFMA body's.
5. The training main path, through the entry points a user calls: a bert-base
   (12 layers, H=768, bf16, ``attention='fused'``, ``fused_loss=True``, tied)
   built by ``DRModel.build`` from an architecture-only dir (seeded random
   init), trained by ``Trainer.train`` for 2 epochs of 6 steps (batch 32 x 8
   passages, q_max_len 32, p_max_len 128; adamw, linear schedule, warmup
   ratio 0.1) on synthetic batches through the shared ``DataLoader``.
   Launch counters of K1-K4 are zeroed just before and read just after; all
   must have launched, every loss be finite and the last epoch's mean loss
   below the first's. The same run with the plain versions must agree (step-1
   loss, step-1 gradient cosine and norm ratio, every step's loss). Then
   steps/s, tokens/s and peak memory
   (kernels vs plain), the deploy-format save reloaded by
   ``DRModelForInference.build`` (same reps), and a checkpoint resume (the
   next step's loss equals the uninterrupted run's).

6. K7 (int8 quantization) on the K5 phase's 1,000,000 x 768 fp32 corpus:
   values and scales bit-equal to the plain version; kernel / plain ms.
7. K6, K8 and K12 vs their plain versions on that corpus int8-quantized (and
   its fp32 and bf16 forms for K8), 1024 queries, k=100: K6 through the
   certified int8 ``exact`` search (ids vs the plain-version search, rescored
   against ``blockwise_topk`` on the int8 rows), K8 through ``serve_topk`` on
   all three dtypes and K12 through ``serve_topk(i8_native=True)``: top-k vs
   the plain versions, recall@100 vs the certified search of the same index;
   kernel, plain and search ms. K6 and K8 bf16 / int8 must run
   ``csrc/flat_serve.cu``'s wgmma body and K8 fp32 ``csrc/flat_certified.cu``'s
   fp16-pair body (``last_body`` and their CUDA kernels by ``torch.profiler``;
   ``block_topj.launches_int8_generic`` and ``block_topj_serve.launches_generic``
   0 on every path of the script), and meet their plain versions block by block
   (rescored in fp64; 1e-5 K6 / K8 fp32, 1e-4 K8 bf16 / int8): K6 at J = 8 and
   32, K8 at the serve J (7), at J = 11 and 32 on 4096-row blocks and at the
   IVF side scans' (block 512, J = 12, 9, 6; held on the first 131,072 rows),
   each timed; K8 fp32's largest |score - fp64| is held to twice that of
   ``block_topj.cu``'s FFMA body on the same rows 4 bytes off alignment (its
   time beside). K12 must run ``csrc/flat_serve.cu``'s wgmma body (its CUDA
   kernel by ``torch.profiler``, ``block_topj_i8q.launches_generic`` 0) and stay
   bit-equal to its plain version at the 8.8M IVFR256 i8q side scan's J = 9 on
   512-row blocks and at J = 11 and 32 on 4096-row blocks, each timed.
8. The int8 serving path through the entry points, on the main path's
   bert-base reps: ``FlatIPIndex(dtype="int8")`` filled by ``add_device``,
   ``search_queries`` in ``exact``, ``serve``, ``i8q`` and ``approx``
   (docids, ranking file, ``get_metrics``) with the launch counters of K6,
   K7, K8 and K12 zeroed before and read after. K6 (at the certified J and
   its escalated J), K8 and K12 (at the serve J) then meet their plain
   versions block by block on this path's own int8 slab, queries and blocks:
   ids equal up to ties, scores within 1e-5 (K6) / 1e-4 (K8), K12 bit-equal.
   Top-100 overlap and metric gap vs the fp32 ranking of phase 3; the same
   path with the plain versions must agree. Then ``save`` and
   ``evaluator.retrieval.main --index_path ... --search_mode serve`` on the
   card, the reloaded payload bit-equal.
9. K9 (int4 quantization) on a seeded 1,000,000 x 768 fp32 corpus: packed
   values and scales bit-equal to the plain version; kernel / plain ms.
10. K10, K11 and K12's sq4 body on that corpus packed by K9, 1024 queries,
   k=100: through ``certified_topk(int4=True)`` and ``serve_topk(int4=True)``
   against the same searches on the plain versions, and block by block at
   the searches' J (ids equal up to ties, rescored in fp64 under the kernel's
   formula; K12 sq4 bit-equal); recall@100 of serve and i8q vs the certified
   search; kernel, plain and search ms. K10 must run ``csrc/int4_certified.cu``'s
   s8 body (``block_topj.launches_int4_generic`` 0 on every path of the script,
   its CUDA kernel by ``torch.profiler``); ``block_topj.cu``'s FFMA body runs
   beside it on the same rows 4 bytes off alignment, for its time and its
   largest |score - fp64|, which the s8 body's may not exceed; K10's time at
   J = 32 too; its bound on the s8 body's three passes, the FFMA one beside.
   K11 and K12 sq4 must run ``csrc/flat_serve.cu``'s wgmma body (by
   ``torch.profiler``; ``launches_int4_generic`` 0), K12 sq4 bit-equal and K11
   within 1e-4 at J = 4 (1024-row blocks), 11 and 32, each timed; K11's largest
   |score - fp64| is held to twice that of ``block_topj.cu``'s body on the same
   rows 4 bytes off alignment (its time beside).
11. The evaluation path through the entry points: bert-base (12 layers,
   bf16, fused attention and loss) built by ``DRModel.build``, one short
   epoch of ``Trainer.train`` with an ``eval_loader`` that evaluates into an
   int4 index (8192 synthetic passages with planted answers, 512 queries,
   ``AnswerMatcher`` labels, metrics json, retrieval dump), then
   ``evaluate`` on the same index in ``serve`` and ``i8q``. Launch counters
   of K1, K2, K9, K10, K11 and K12 sq4 are zeroed before and read after. The
   plain versions of K9-K12 on the same reps must agree; the int4 rankings
   are compared with a float32 evaluation of the same model; the saved index
   reloads bit-equal through ``_load_index``; ``retrieval.main --index_dtype
   int4`` ranks as the trainer did.
12. Scale: 8,841,823 x 768 int8 rows (MS MARCO passage) built by
   ``add_device`` in 262,144-row slabs of seeded fp32 quantized by K7 (the
   trainer's evaluation path); queries/s of ``serve``, ``i8q`` and
   ``exact`` at k=100, recall@100 of serve / i8q vs exact, peak memory; one
   more exact and one serve search under ``torch.profiler``, their device
   time by group (K6 / K8, the merges, the rest).
13. Scale int4: 138,364,198 x 768 rows (MS MARCO v2 passage, which int8
   cannot hold on one card) in 528 slabs packed by K9; the same searches and
   numbers, plus the resident size; one more certified search under
   ``torch.profiler``, its device time by group (K10, the merges, the exact scan).
14. K13 and K14 (the IVF cell kernels) through the entry points: 1,000,000
   x 768 rows of the JAX package's IVF benchmark mixture (4096 centres,
   sigma 0.5), 2048 queries of it, ``IVF1024`` (fixed capacity, K13) and
   ``IVFR1024`` (ragged, 512-row blocks, K14) trained on 262,144 rows,
   nprobe 32, k=100; fp32, bf16 and int8 cells in ``bulk``, int8 in
   ``i8q``. Each body then meets its plain version block by block on the
   search's own slab, blocks, J and filled slots (ids equal up to ties,
   scores within 1e-5 fp32 / 1e-4 others, i8q bit-equal); every search and
   call must run ``csrc/ivf_cell.cu``'s bodies (``launches_generic`` 0, and
   one call's CUDA kernels by ``torch.profiler``); kernel, plain and bound ms
   (the bound on the data's own work: the stored rows of the probed cells
   against their real query slots; the launched, padded shape's beside it),
   a launch's device ms by CUDA kernel, queries/s, recall@100 against the
   certified flat search of the same rows and dtype; one search under
   ``torch.profiler`` by group (the cell kernel, the side scan on K8 / K12,
   the merges) with the (rows, block, J) its side scans ran. Then ``PCAR384,SQ4``
   through ``train`` and ``add_chunks``. (Runs before phase 3.)
15. The evaluation path into a trained index: phase 11's model evaluated
   with ``index_factory="IVF16,SQ8"`` (nprobe 4) in ``bulk`` and ``i8q``:
   spill, k-means, ``add_chunks`` (K7), K13, the side slab on K8 / K12.
   Counters zeroed before; the plain versions over the same reps, the
   float32 ranking, and ``retrieval.main --index_path`` on the saved index.
16. Scale IVF: 8,841,823 x 768 mixture rows in ``IVFR256,SQ8`` (nprobe 8,
   2048-row blocks), trained on 262,144 rows, ``add_chunks`` in 500,000-row
   chunks; ``bulk`` and ``i8q`` at steady state after the tuning call (the
   learned Qcap, hot set, drops, K14's time, its split by CUDA kernel and
   its block-by-block check against the plain version, as phase 14's),
   recall@100 against the certified search of a flat int8 index of the same
   rows, build seconds, resident and peak memory. ``--ivf_only`` runs phases
   14 and 16 alone.
17. K15 and K16 (the PQ serve kernels) through the entry points: 1,000,000 x
   768 rows of the JAX package's PQ benchmark data (the IVF mixture times
   the spectrum (d + 1)^-0.35), 2048 queries, k=100; ``PQ96`` trained on
   262,144 rows, searched by ``PQIndex.search(mode="serve")`` (K16, the int8
   codebook) and by ``pq_serve_topk`` with the bf16 table (K15, 8-bit codes);
   ``PQ192x4`` (K15, 4-bit codes). Each meets its plain version block by block
   on the search's own codes, blocks and J (ids equal up to ties, rescored in
   fp64 under the kernel's formula; scores within 1e-4); recall@100 of serve
   against exact ADC of the same codes, recall10@100 against the certified
   fp32 flat search; kernel, plain, search and bound ms, the decode passes' and
   the scoring launches' device ms apart (``torch.profiler``), one decode pass
   a scoring launch, and the scratch's bytes. (Runs before phase 3.)
18. The evaluation path into the PQ indexes: phase 11's model evaluated into
   ``PQ96`` (serve on K16, exact ADC) and ``IVF16,PQ96x4`` (nprobe 4, bulk on
   K17, hot cells on K7 / K8); counters zeroed before; the plain versions over
   the same reps; ``retrieval.main --index_path`` on each saved index. PQ96's
   metric gap to the float32 ranking is held to the same gap on the plain
   encoder: phase 11's model trained and encoded from the same seed with the
   plain versions of K1, K2 and K3 / K4.
19. Scale PQ: 8,841,823 spectrumed rows in ``OPQ96,PQ96`` (serve) and
   ``OPQ192x4,IVF256,PQ192x4`` (nprobe 8, 2048-row blocks, bulk_j 8, max_hot
   16; bulk), trained on 262,144 rows, ``add_chunks`` in 500,000-row chunks;
   queries/s, recall10@100 against the certified int8 flat search of the same
   rows, serve recall@100 against exact ADC (and K16's scratch bytes), K17
   against its plain version on the search's own slab and filled slots (its
   CUDA kernel ``ivf_cell.cu``'s ``ivf_cell_wgmma<3>``), one search's device time
   by group (K17, the side scan, the merges), build seconds, resident and peak
   memory.

20. The flash kernels (``csrc/flash_attn.cu``) vs their plain versions at
   bert-base widths (nh=12, hd=64), ragged segment masks with pad rows and
   all-pad sequences: the forward (F-fwd) in bf16 at B=64 and fp32 at B=8,
   S=512 (outputs and lse; real rows and all rows), the dK/dV (F-dkv) and dQ
   (F-dq) kernels in bf16 at B=64, S=512 under a cotangent zero on pad rows,
   against the closed-form plain versions and against autograd through the
   plain forward; the query tower's shapes, S=32 (every tile partial), the
   same way: F-fwd at B=64 (served) and all three at B=8 (trained); F-fwd
   bf16 at B=64, S=156 (a partial last tile) and at S=512 on a mask that is no
   prefix (segments in runs of 96);
   K18 (the forward in bias mode) against ``_reference_attention`` at B=64,
   S=156 and 512. Errors with their tolerances, kernel, plain and bound ms, and
   ``torch.nn.functional.scaled_dot_product_attention`` with the same mask
   (forward, the backward alone, and forward + backward), which the port never
   calls, beside the port's backward alone (D, F-dkv and F-dq), with the
   kernel / SDPA ratio; for each forward row the (query tile, key tile) pairs
   visited of all, the rest skipped as fully masked. (Runs before phase 3.)
21. Serving at S=512 through the entry points: bert-base bf16
   ``attention='flash'`` built by ``DRModelForInference.build``;
   ``encode_batches`` over 4096 passages of lognormal length (median 256,
   clipped to [16, 512], at least 10% at 512) and 512 queries (S=32); a float32
   ``FlatIPIndex``, exact search at k=100, docids, ranking file,
   ``get_metrics``. Counters (K18's too) zeroed before and read after: the
   forward launched, the backward kernels did not. The same path on the plain flash
   version must agree (reps cosine), and the kernels' ranking be no further from
   the same weights' fp32 ranking than the plain version's (top-100 overlap,
   metrics); then encode passages/s and peak memory of ``flash``, ``fused`` (K1
   / K2) and ``xla`` on the same weights and batches.
22. Training at S=512 through ``DRModel.build`` and ``Trainer.train``:
   bert-base bf16 ``attention='flash'``, ``fused_loss=True``, tied; 8 queries
   (q_max_len 32) x 8 passages (p_max_len 512), 2 epochs x 4 steps, adamw lr
   1e-5. All three flash kernels launched, every loss finite; the plain
   versions agree (step-1 loss, gradient cosine and norm ratio, and every
   step's loss on the kernels' weights of that step, over eight steps run
   again), and the kernels' step-1 gradient is no further from
   the same model's fp32 gradient than the plain path's; steps/s and peak
   memory against ``attention='xla'``.
23. Grad-cache training through ``DRModel.build`` and ``Trainer`` with
   ``grad_cache`` (``train/grad_cache.py``): bert-base bf16, fused attention and
   loss, tied, on ``make_train_rows`` batches (q_max_len 32, p_max_len 128). At
   64 queries x 8 passages (chunks of 16 and 128) the step-1 loss and gradient
   against the full-batch step on the same weights (phase 5's bounds, and a
   gradient cosine >= 0.9999 and norm ratio within 1e-3 of 1); at 4096 x 8
   (chunks of 256 and 1024; a bert-base GC_SCALE_LAYERS = 4 deep) one timed step after two
   at 512 x 8 with the same chunks: K3 and K4 launch once at Q=4096, P=32768 (K3's wgmma body, no
   FFMA-body launch) and K1 / K2 once a layer for each chunk in passes 1 and 3,
   counted from 0 just before the step; every loss finite, steps/s, real
   tokens/s, each pass's device ms (CUDA events), and the peak, held to 1.25x
   the same chunks' peak at 512 x 8.
24. ``remat`` at the training path's shape (32 x 8, S=128, bf16, REMAT_LAYERS = 4 deep):
   '', 'full' and
   'attn' on ``attention='fused'`` and ``'xla'``, through ``DRModel.build`` and
   ``Trainer``; the step-1 loss (within 1e-6 relative) and gradient (cosine
   >= 0.99999) against the same attention without remat, peak memory and
   steps/s: 'full' must lower the peak on both, 'attn' on 'xla', and 'attn' on
   'fused' stay within 1% of ''. Counters zeroed before each run and read
   after it: K1 / K2 once a layer on each side a step on 'fused' (twice with
   'full'), K3 / K4 once a step.
25. LoRA through ``DRModel.build(param_efficient_method='lora', lora_rank=8)`` and
   ``Trainer`` at the training path's shape (32 x 8, S=128, bf16, fused attention and
   loss): the step-1 loss and the adapters' gradient against the plain loss (phase 5's
   bounds); 2 warm-up and 4 timed steps, steps/s and peak memory beside a full
   fine-tune of the same model timed the same way; counters zeroed before: K1 / K2 0
   (a LoRA layer runs the xla block), K3 / K4 once a step; every frozen tensor
   bit-equal after, every adapter moved. Then B drawn N(0, 0.2), ``merge_lora`` and 512
   passages (S=156) encoded by the merged tower on K1 / K2 against the adapted tower
   (reps cosine >= 0.999); ``export_hf`` and ``DRModel.build`` from that directory on
   the card with neither ``transformers`` nor ``safetensors`` loaded (the same reps
   within fp32 rounding); one LoRA step at S=512 on 'flash' (8 x 8; the flash kernels
   launched) against the same step on 'xla' (phase 22's step-loss bound).
   ``--train_only`` runs phases 5 and 23-25 alone.
26. Mining: bert-base (bf16, fused) encodes 32,768 synthetic passages (S=156, phase
   11's generator) into the trainer's float32 index (``_encoding_corpus``); ``DenseMiner``
   mines 7 negatives for each of 4,096 train queries from k = 17 in ``serve`` (K8) and
   in ``exact`` (K5): queries/s, the share of samples whose lists are equal (>= 0.99),
   no sample's own positive mined, counters of K1 / K2 / K5 / K8 per mode; then a
   2-epoch ``Trainer.train`` with ``mine_per_train=1`` over 64 samples (epoch 2 trains on
   the mined rows, its losses finite); ``BM25Negatives`` over the 32,768-passage train
   pool on the native engine, built from ``native/bm25.cpp`` into ``_build/`` (wall
   seconds; rankings held to the Python retriever's on 256 queries by score).
   ``--eval_only`` runs it after phases 11, 15 and 18.
27. T5 and reranking: a t5-base dual encoder (``google-t5/t5-base``'s widths, seeded
   random weights; ``encoder_only``, mean pooling, bf16, fused loss) built by
   ``DRModel.build`` from an architecture-only dir: its step 1 against the plain loss
   (phase 5's bounds), then 2 warm-up and 4 timed ``Trainer`` steps at 32 x 8 (q 32 / p
   128): K3 / K4 once a step, K1 / K2 never; steps/s, real tokens/s, peak memory. Saved,
   rebuilt by ``DRModelForInference.build``, it encodes 8192 passages (S=156) and 512
   queries into a float32 ``FlatIPIndex`` (512-row blocks), searched at k=100 in
   ``exact`` (K5, held to its plain version over the same reps: top-100 overlap >= 0.99)
   and ``serve`` (K8, recall against exact >= 0.999): passages/s, queries/s; the card's
   bucket table equal to the host's; bf16 reps cosine >= 0.999 to the fp32 reps of the
   same weights. Then a BERT-base cross-encoder (mr) and a t5-base token scorer
   (``t5_full``, ce), each built by ``RRModel.build``, train through ``RRTrainer`` on 8
   queries x (1 + 7) pairs of 160 tokens (2 warm-up, 4 timed steps; losses finite) and
   evaluate (``RRTrainer.evaluate``) over the T5 index's top 100 for 64 queries: 6,400
   dump rows, the metrics file with ``query_num`` 64; steps/s, pairs/s, peak memory;
   the fp32 scores of 64 pairs on the card within 1e-3 of the largest |score| of the
   same weights' on the CPU. Counters zeroed before each part and read after.
   ``--rerank_only`` runs it alone.
28. Optimizers (``--train_only``): bert-base bf16 'fused' at 32 x 8, 1 warm-up and 3
   timed steps each of adagrad, rmsprop and adafactor; step 1's update of sampled
   tensors held to optax's formula in float64 on the host; K3 / K4 4 launches each.
29. Data parallelism, sharding and tensor parallelism (``--dist_only``): worker processes
   of this script, bert-base DIST_LAYERS = 4 deep. (a) NCCL, one rank: a mesh step
   bit-equal to the step without one. (b)-(d) gloo, two ranks sharing ``cuda:0``: the
   data-parallel step, ``negatives_x_device=False`` and grad-cache under the mesh against
   one process; the sharded flat index over 1,000,000 x 768 rows; ``Trainer.evaluate`` on
   the mesh into flat, IVF16,SQ8, PQ96, PQ192x4, IVF16,PQ96x4 and PCAR384,SQ8 against one
   process. (e) tp = 2 on two more gloo ranks (``make_mesh(1, 2)``), bert-base widths
   TP_LAYERS = 2 deep in fp32: one step on 'xla', 'fused' (K1 / K2 on the gathered
   weights) and 'flash' (S=512) each against one process (phase 5's bounds), one adafactor
   step's update against one process's, ``Trainer.save`` reloaded by ``DRModel.build``;
   the two ranks' gradients equal; exact launches. Launches by rank.
30. The CLIs, recipes and entry points (``--cli_only``), with neither ``transformers``
   nor ``datasets`` loaded (the port's own tokenizer and JSON reader). (a)
   ``run_toolkits.main`` at bert-base widths CLI_LAYERS = 4 deep (architecture-only dir, a
   ``vocab.txt`` of 30,522 entries) over the ``quality_trend`` twin's planted data (65,536 passages: 16 blocks of
   4096, so k=100 takes K5, not the scan): ``train_random`` (bf16, 'fused', fused loss, one
   epoch with evaluation), ``encode`` (passages, queries), ``retrieve`` (its ranking's
   top-100 overlap with the trainer's exact ranking >= 0.999), ``nq_eval`` (its top-k
   accuracies equal the trainer's Recall@k of the same ranking), ``train_bm25`` (native
   BM25) and ``rerank`` (BERT-base, mr) over the ``train_random`` dump; each stage's files
   and counts; counters zeroed before each stage and read after. (b) The ``quality_trend``
   twin (4 layers, 128 wide, planted, lr 1e-3, 2 epochs, serve search: K8, ``--rerank``):
   its final test MRR@10 at or above ``TREND_MRR10``. (c) ``graft_entry.entry()``'s step
   once (finite loss) and ``dryrun_multichip(2)`` (two gloo ranks on ``cuda:0`` at tp = 2).
   (d) The ``profile_encoder`` twin at B=256, S=156 (JSON under ``chiprun_out/``).
31. The twins of the six ``bench.py`` recipes (``--recipes_only``), through their ``main``
   at cut sizes (RECIPE_ENV): latency_probe (262,144 rows, IVF64), bench_pcar_sq4 (1M),
   bench_pcar_38m (2M in four 500,000-row slabs), pq_capacity (2M, IVF64), ivfpq_sweep
   (1M, IVF256, the OPQ rotation shared through the twins' cache) and varlen_probe
   (16,384 passages on 'fused', one trial). Counters zeroed before and read after: K1,
   K2, K7, K8, K9, K11, K12 sq4, K14, K15 and K17 launched; each held to its plain version
   at its first call; the slab-merged reference against one pass; recall bounds; the
   bodies each search ran, recorded, and no generic-body launch.

Prints the card's name and power limit, one JSON line of per-kernel results
(each with its bound: the larger of its bytes over 3.35 TB/s and its
operations over the peak rate of their type), and last ``{"ok": true,
"device": {...}}``. Exits non-zero, with no result, when no CUDA card is
present or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import datetime
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# The main path's FlatIPIndex block: 512 rows give the 8192-row index 16 blocks,
# so k=100 takes the K5 candidate path. The index's default 4096-row blocks would
# give it 2, whose 2 x J=8 candidates cannot hold k=100: the search would scan.
INDEX_BLOCK = 512
# Training path, kernels vs plain versions (bf16 towers, unnormalized CLS reps
# whose scores reach the hundreds, so bf16 roundings move the loss): bounds about
# 2x the readings on the H100 (step-1 loss rel 9.25e-3, step-1 gradient cosine
# 0.99857, largest step-loss gap 0.043 over 12 steps at lr 1e-5), which repeat
# from run to run.
TRAIN_STEP1_REL = 2e-2
TRAIN_GRAD_COS = 0.995
TRAIN_STEP_GAP = 0.1
# The cosine cannot see the gradient's scale (nor can AdamW's steps): the ratio
# of the step-1 gradient norms, kernels / plain, must lie within this of 1;
# about 2x the reading on the H100 (0.97995). A gradient off by n_q reads 32x.
TRAIN_GRAD_NORM = 4e-2
# The training path's run: bert-base at full depth, 32 queries x 8 passages per
# batch, 6 steps per epoch, 2 epochs, 6 timed steps. lr 1e-4 diverged from
# random init on the H100 (step-2 loss 15, then collapse to log 256); 1e-5 trains.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS_PER_EPOCH, TRAIN_LR, TRAIN_TIMED_STEPS = 12, 32, 6, 1e-5, 6
# The H100 SXM's peaks (NVIDIA's data sheet, dense): device memory bytes/s and
# operations/s by type. A kernel's bound is the larger of its bytes (each input
# read once, each output written once) over the first and its operations over
# the rate of their type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
# Scale phase: MS MARCO passage (8,841,823 passages) at bert-base width, added as
# the trainer's evaluation path adds them (index_slab_rows' default), searched by
# 1024 queries.
SCALE_ROWS, SLAB_ROWS, SCALE_QUERIES = 8_841_823, 262_144, 1024
# Recall@100 against the certified search of the same index, at 1M and at
# MS MARCO's 8.8M rows. serve misses a row only where a block overflows its
# Poisson J (~1e-6) or at an exact tie: it read 1.0 on every dtype at both
# sizes. i8q adds query quantization, whose near-tie swaps read 0.98671 (1M)
# and 0.98492 (8.8M); the bound keeps about 1.5 points of room.
SERVE_RECALL, I8Q_RECALL = 0.999, 0.97
# The int8 serving path on the main path's reps (bert-base, random weights):
# kernels vs plain versions read top-100 overlap 0.99994-1.0 and no metric gap
# (ties only); against the fp32 exact ranking, int8 rows read overlap 0.89514
# (exact, serve) and 0.89451 (i8q, approx) and metric gaps 0.0117 / 0.0176:
# random-weight CLS reps rank a flat tail that the row quantization reorders.
INT8_VS_PLAIN, INT8_PLAIN_METRIC_GAP = 0.999, 0.004
INT8_VS_FP32, INT8_METRIC_GAP = 0.87, 0.03
# The evaluation path (Trainer.train, then evaluate into an int4 index): its
# training epoch, and its bounds. Kernels vs plain versions over the same reps
# take the int8 path's bars. int4 vs the float32 ranking of the same model read
# top-100 overlap 0.13061 and a metric gap of 0.5156 (exact, on the H100): the
# near-random weights give CLS reps whose differences sit below int4's step
# (absmax / 7), so the rows' quantization reorders almost the whole top-100.
# The bounds keep a little room on that reading.
EVAL_TRAIN_STEPS = 4
INT4_VS_PLAIN, INT4_PLAIN_METRIC_GAP = 0.999, 0.004
INT4_VS_FP32, INT4_METRIC_GAP = 0.10, 0.56
# K11 takes bf16 queries, the certified int4 search fp32 ones (the reference's
# formulas), so near ties at the k-th place swap with the query's bf16
# rounding: provisional until the first reading on the card. Against the
# certified search over the same bf16 queries serve keeps SERVE_RECALL.
INT4_SERVE_FP32_RECALL = 0.99
# int4 at scale: MS MARCO v2 passage (138,364,198 passages), 53.1 GB of packed
# rows at 768-d, which int8 (106 GB) cannot hold on one card.
SCALE4_ROWS, SCALE4_QUERIES = 138_364_198, 1024
# The trained IVF index. Data: the JAX package's IVF benchmark mixture
# (bench.py:271-272), IVF_CENTRES N(0, 1) centres in 768-d, rows centre +
# IVF_SIGMA * N(0, 1), made in MIX_UNIT-row units so any chunking gives the same
# rows. K13 / K14 run on IVF1024 / IVFR1024 (512-row blocks), nprobe 32, trained
# on IVF_TRAIN_ROWS rows; searches are timed over IVF_TIMED_SEARCHES calls after
# the tuning call.
IVF_CENTRES, IVF_SIGMA, MIX_UNIT = 4096, 0.5, 65_536
IVF_NLIST, IVF_NPROBE, IVF_RAGGED_BLOCK, IVF_TRAIN_ROWS = 1024, 32, 512, 262_144
IVF_TIMED_SEARCHES = 3
# recall@100 of the bulk / i8q search against the certified flat search of the
# same rows and dtype, per layout: about 3 points under the readings on the H100
# (IVF1024 0.78526-0.78668, IVFR1024 0.93498-0.93840 over every body). Both lose
# rows where the reference's J assumptions break (hot cells' rows in the side
# slab, and for IVF J sized from a capacity the rows fill a quarter of); the JAX
# package measured 0.64-0.69 for 4-centre cells of this mixture (BASELINE.md:345).
IVF_RECALL = {"IVF": 0.76, "IVFR": 0.91}
# The evaluation path into a trained index: 16 cells of the 8192 passages,
# 4 probed. Kernels vs plain versions over the same reps take the int8 path's
# bars; against the float32 flat ranking of the same model it read top-100
# overlap 0.64334 / 0.64318 and metric gaps 0.3848 / 0.3828 (bulk / i8q, on the
# H100): 4 of 16 cells over near-parallel random-weight reps. The bounds keep a
# little room on that reading.
EVAL_IVF_FACTORY, EVAL_IVF_NPROBE = "IVF16,SQ8", 4
IVF_VS_PLAIN, IVF_PLAIN_METRIC_GAP = 0.999, 0.004
IVF_VS_FP32, IVF_METRIC_GAP = 0.60, 0.42
# Scale: MS MARCO passage's count from the mixture in IVFR256,SQ8, nprobe 8,
# 2048-row blocks, add_chunks in 500,000-row chunks (bench.py:475-642). The
# JAX package read recall@100 0.984 for this algorithm at the default J
# (BASELINE.md:344); the port read 0.97900 (bulk) and 0.97204 (i8q) on the H100.
SCALE_IVF_NLIST, SCALE_IVF_NPROBE, SCALE_IVF_BLOCK, SCALE_IVF_CHUNK = 256, 8, 2048, 500_000
SCALE_IVF_RECALL = 0.95
# The product-quantized indexes (K15-K17). Data: the IVF mixture times the
# spectrum lambda_d = (d + 1) ** -PQ_SPECTRUM of the JAX package's PQ benchmark
# (bench.py:790-800); codebooks trained on PQ_TRAIN_ROWS rows (its sample), 2048
# queries, serve times over PQ_TIMED_SEARCHES calls after a warm-up.
PQ_SPECTRUM, PQ_TRAIN_ROWS, PQ_QUERIES, PQ_TIMED_SEARCHES = 0.35, 262_144, 2048, 3
# recall@100 of the serve search against exact ADC over the same codes: serve
# scores bf16 queries against bf16 decoded rows (K16: int8 entries), exact ADC
# fp32 ones, so near ties at the 100th place swap. It read 0.99390 (K16),
# 0.99784 (K15 8-bit) and 0.99831 (K15 4-bit) at 1M rows and 0.99111 (OPQ96,
# K16) at 8.8M on the H100; the bound keeps about a point of room. recall10@100
# against the certified fp32 flat search at 1M read 0.79902 (PQ96; the JAX
# package read 0.799, BASELINE.md:108) and 0.75166 (PQ192x4): bounds 3 points
# under.
PQ_SERVE_RECALL = 0.98
PQ_RECALL10 = {"PQ96": 0.77, "PQ192x4": 0.72}
# Scale: the JAX package's PQ benchmark strings at MS MARCO passage's count
# (bench.py:1051-1059): nprobe 8 (nlist / 32), 2048-row blocks (SCALE_IVF_BLOCK),
# bulk_j 8, max_hot 16; recall10@100 against the certified int8 flat search read
# 0.75200 (OPQ96,PQ96; JAX 0.760, BASELINE.md:109) and 0.71997 (IVF-PQ; JAX
# 0.731, BASELINE.md:147) on the H100: bounds 3 points under.
SCALE_PQ_SPECS = (("OPQ96,PQ96", "serve"), ("OPQ192x4,IVF256,PQ192x4", "bulk"))
SCALE_PQ_NPROBE, SCALE_PQ_BULK_J, SCALE_PQ_MAX_HOT = 8, 8, 16
SCALE_PQ_RECALL10 = {"OPQ96,PQ96": 0.72, "OPQ192x4,IVF256,PQ192x4": 0.69}
# The evaluation path into the PQ indexes: (factory, nprobe, modes, epoch).
# Kernels vs plain versions over the same reps take the int8 path's bars.
# Against the float32 flat ranking of the same random-weight model it read
# top-100 overlap 0.28184 / 0.28498 (PQ96 serve / exact) and 0.15318
# (IVF16,PQ96x4), metric gaps 0.3088 / 0.3066 and 0.6016, on the H100; the
# bounds keep a little room on those readings. PQ96's metric gap follows the
# roundings of the 4 trained steps more than the PQ code: the plain encoder
# (phase 11's model trained and encoded from the same seed with the plain
# versions of K1, K2 and K3 / K4) read 0.3203 / 0.3086 at seed 0 and 0.359-0.410
# at seeds 1-7, the kernels 0.3457 / 0.3555 at seed 0 (``--eval_only --seed N``).
# So the plain encoder's gap is held to PQ_METRIC_GAP, and the kernels' to
# within PQ96_GAP_VS_PLAIN of the plain encoder's, either way: three times the
# RMS of the kernels' gap minus the plain encoder's (serve and exact, seeds 0-7,
# the mma.sync and the wgmma K1 bodies: 32 readings, RMS 0.0162, mean 0.0005),
# rounded up to 0.005. A K1 that ignores the mask reads 0.1191 / 0.1230 at seed
# 0 (overlap 0.092), one that ignores the softmax scale 0.2598 / 0.2617.
EVAL_PQ_CASES = (("PQ96", 32, ("serve", "exact"), 301), ("IVF16,PQ96x4", 4, ("bulk",), 302))
PQ_VS_PLAIN, PQ_PLAIN_METRIC_GAP = 0.999, 0.004
PQ_VS_FP32 = {"PQ96": 0.25, "IVF16,PQ96x4": 0.12}
PQ_METRIC_GAP = {"PQ96": 0.34, "IVF16,PQ96x4": 0.64}
PQ96_GAP_VS_PLAIN = 0.05

# Flash attention (F-fwd, F-dkv, F-dq) and K18 against their plain versions, which
# share their semantics on every row: fp32 within 1e-5 of the largest output, bf16
# within two bf16 ulps at it (2^-6 of it): the kernels round exp(s - m) where the
# plain forward rounds the normalized probabilities. The backward kernels against
# autograd through the plain forward within 3e-2 of the largest gradient, since
# autograd rounds dP to bf16 where the kernels round dS (provisional until the
# first reading on the card).
FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
FLASH_AUTOGRAD_REL = 3e-2
# D = rowsum(dO * O), which the dQ kernel computes in fp32, vs the plain formula on the
# same o and dO: the summation order alone
FLASH_D_REL = 1e-5
# (dtype, B, S, with the backward kernels, mask): the passage tower at S=512 (serving
# and training batch 64; fp32 at B=8) and the query tower at S=32, served at B=64 and
# trained at B=8, where every query and key tile is partial (S below the 64-row tile),
# on ragged prefix masks; the fused path's S=156 (a partial last tile) and S=512 on a
# mask that is no prefix (segments alternating in runs of 96 rows: tiles skipped in the
# middle of a sequence, by the forward and both backward kernels).
FLASH_KERNEL_CASES = ((torch.bfloat16, 64, 512, True, "ragged"),
                      (torch.float32, 8, 512, False, "ragged"),
                      (torch.bfloat16, 64, 32, False, "ragged"),
                      (torch.bfloat16, 8, 32, True, "ragged"),
                      (torch.bfloat16, 64, 156, False, "ragged"),
                      (torch.bfloat16, 64, 512, True, "runs96"))
# the kernels' tiles: 64 x 64 (rows x columns) per warpgroup's skip decision; a CTA of
# the wgmma bodies loads a streamed 64-row tile for its 128 rows (FLASH_CTA_ROWS)
FLASH_TILE, FLASH_CTA_ROWS = 64, 128
# Serving and training at S=512 (the reference's largest p_max_len): passages of
# lognormal length, median 256 tokens, sigma 0.6, clipped to [16, 512], so about
# 12% are 512 tokens long; 4096 passages and 512 queries (S=32) served, batch 8
# queries x 8 passages (64 passages: the serving kernel's shape) trained, 4 steps
# per epoch, 2 epochs.
FLASH_PASSAGES, FLASH_QUERIES, FLASH_MEDIAN_LEN, FLASH_LEN_SIGMA = 4096, 512, 256, 0.6
# Flash serving vs the plain flash version, end to end: reps cosine >= 0.999 (the
# main path's bound). The rankings are held to the same weights' fp32 ranking (the
# plain version in fp32), which both bf16 paths approximate: the kernels' top-100
# overlap with it may fall below the plain path's by at most FLASH_FP32_OVERLAP,
# their largest metric difference to it exceed the plain path's by at most
# FLASH_FP32_METRIC (the main path's metric bound). Kernels vs plain directly read
# overlap 0.89102 / 0.86549 / 0.84564 and metric gap 0.0078 / 0.0039 / 0.0098 at
# seeds 0 / 1 / 2 on the H100, reps cosine 0.9999 on all three: random-weight CLS
# reps over 512-token passages rank a flat tail (median top-100 spread 1.7-2.3
# against a median score shift of 0.12-0.14 from the encoders' bf16 roundings),
# whose order says more of the seed than of the kernels.
FLASH_FP32_OVERLAP, FLASH_FP32_METRIC = 0.03, 0.012
FLASH_TRAIN_BATCH, FLASH_TRAIN_STEPS = 8, 4
# Flash training vs the plain versions: the training path's bounds, but for the
# step-loss gap and the step-1 gradient cosine. The step-loss gap is taken on the
# same weights at every step and may reach FLASH_STEP_GAP: it read 0.0633 / 0.0735
# / 0.0709 / 0.1221 at seeds 0-3 on the H100, where the plain path's own step-1 loss
# stood 0.0116 / 0.0437 / 0.0474 / 0.1249 from the same model's fp32 loss: bf16 at
# S=512 moves this sharp random-init loss by about 0.1 in either path. The step-1
# gradient cosine read 0.984876 / 0.984874 / 0.984884 / 0.983075 (0.99857 for
# K1/K2 at S=128): the flash backward rounds differently from autograd through the
# plain forward (dS against dP to bf16, D from the bf16 output), not only the
# forward. So both bf16 gradients are also held to the step-1 gradient of the same
# model in fp32: the kernels' cosine to it must not fall below the plain path's by
# more than FLASH_GRAD_FP32_GAP (kernels / plain read 0.98536 / 0.98676, 0.98580 /
# 0.98447, 0.98573 / 0.98698 and 0.98365 / 0.98554).
FLASH_GRAD_COS, FLASH_GRAD_FP32_GAP, FLASH_STEP_GAP = 0.97, 0.01, 0.2


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=5, warmup=1):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def certificate_counts(topk):
    """(escalated, fallback) query counts of the certified search so far."""
    return topk.certified_topk.escalated_queries, topk.certified_topk.fallback_queries


FAILED = None  # --eval_only: the failed checks, listed instead of raised


def check(cond, what):
    if cond:
        return
    if FAILED is None:
        raise AssertionError(what)
    FAILED.append(what)
    log(f"FAILED: {what}")


def bf16_ulp(t):
    """The spacing of bfloat16 numbers at |t|: 2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def bound(n_bytes, ops, kind):
    """(bound_ms, bound_by): the least time the card could take for this work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def overlap(a, b):
    """Mean share of each row of ``a`` found in the same row of ``b``."""
    return float(np.mean([len(set(x) & set(y)) / max(1, len(x)) for x, y in zip(a, b)]))


def runs_mask(gen, B, S, run=96):
    """Segments alternating in runs of ``run`` rows, 0 or 1 first at random per
    sequence: a 0/1 mask that is no prefix."""
    first = torch.randint(0, 2, (B, 1), generator=gen, device="cuda")
    return ((torch.arange(S, device="cuda")[None, :] // run + first) % 2).to(torch.int32)


def tiles_visited(flash, mask, bias, rows=FLASH_TILE):
    """(visited, total) (row tile, column tile) pairs of the kernels, ``rows`` rows
    by FLASH_TILE columns: query rows by keys for the forward and dQ, key rows by
    queries for dK/dV."""
    vis = flash._visible_tiles(mask, rows, FLASH_TILE, bias)
    return int(vis.sum()), vis.numel()


def ragged_mask(gen, B, S, n_pad_rows):
    """Lognormal lengths in [1, S] with the last rows all padding."""
    lens = torch.exp(torch.randn(B, generator=gen, device="cuda") * 0.5 + math.log(S / 2.5))
    lens = lens.clamp(1, S).long()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    mask[B - n_pad_rows:] = 0
    return mask


def block_bounds(B, S, H, nh, hd, F, es, kind):
    """(bound_ms, bound_by) of K1 and K2 over B x S rows of element size ``es``:
    K1 reads qkv and x and writes out (5H a row), the mask, o_kernel / o_bias and
    the LN params, and does the scores, P.V and the output projection; K2 reads x
    and writes out (2H a row), wi / bi / wo / bo and the LN params, and does the
    two products (4 rows H F)."""
    rows = B * S
    return {"K1": bound(es * rows * 5 * H + 4 * rows + es * (H * H + H) + 8 * H,
                        4 * B * nh * S * S * hd + 2 * rows * H * H, kind),
            "K2": bound(es * rows * 2 * H + es * (2 * H * F + F + H) + 8 * H,
                        4 * rows * H * F, kind)}


# K1's bodies, by the pieces of their CUDA kernels' names: the Hopper body's two
# launches, the mma.sync body, the CUDA-core body
K1_BODIES = ("attn_ln_stage_a", "attn_ln_stage_b", "attn_ln_mma_kernel", "attn_ln_kernel")


def kernel_split(fn, pieces, iters=5, windows=3):
    """The mean device ms a call of ``fn`` spends in the CUDA kernels whose names
    hold each of ``pieces`` (those it ran), from one ``torch.profiler`` window over
    ``iters`` calls. A window that recorded none of them (the profiler now and then
    returns no device events for a short window) is taken again, up to ``windows``
    in all; then the empty result is returned for the caller's checks."""
    from torch.profiler import ProfilerActivity, profile
    ms = {}
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            piece = next((p for p in pieces if p in e.name), None)
            if piece is not None and str(e.device_type).endswith("CUDA"):
                ms[piece] = ms.get(piece, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if ms:
            break
    return ms


def k1_split(fn, iters=5):
    """Which of K1's bodies ``iters`` calls of ``fn`` ran, and the mean device ms
    a call of each of its kernels (``kernel_split``)."""
    ms = kernel_split(fn, K1_BODIES, iters)
    return {"body": "+".join(p for p in K1_BODIES if p in ms),
            "stage_a_ms": ms.get("attn_ln_stage_a"), "stage_b_ms": ms.get("attn_ln_stage_b")}


def phase_block_kernels(gen, attn):
    """K1 and K2 vs their plain versions at bert-base widths, at the serving
    path's shapes (passages B=64, S=156; queries B=64, S=32) and the training
    path's (passages B=256, S=128; queries B=32, S=32); fp32 also at S=306 (the
    longest its resident K/V body takes) and S=512 (the streamed body); bf16
    also at S=256 and 257, the last sequence K1's Hopper body takes and the
    first that the mma.sync body takes. Each row carries its bound; each K1 row
    the body it took and its stage A / stage B ms (``k1_split``) and, on the
    Hopper body, the bound of the ctx scratch's bytes (written by stage A and
    read by stage B: ``scratch_bound_ms``); K2's bf16 rows also the time of the
    xla block's bf16 chain
    on the same inputs (``chain_ms``: ``_dense``, gelu, ``_dense``, the residual in
    bf16 and LN, as ``models/bert.py:encoder_block``; several cuBLAS and PyTorch
    calls with other roundings, so no ``library_ms``)."""
    from denseretrievaltoolkits_torch.models import bert

    def xla_chain(x, wi, bi, wo, bo, ls, lb, eps):
        h = torch.nn.functional.gelu(bert._dense(x, wi, bi))
        return bert.layer_norm(x + bert._dense(h, wo, bo), ls, lb, eps)

    H, nh, hd, F = 768, 12, 64, 3072
    # bf16: post-LN outputs are O(1), 3e-2 is two bf16 ulps at |y| < 4; K2's outputs
    # are held to 3e-2 or one bf16 ulp of the plain version's, the larger, since at
    # thousands of rows some pass |y| = 4, where one ulp (2^-5) exceeds 3e-2 and two
    # fp32 sums that differ in their last bits may round to neighbouring bf16 numbers
    # (the same bound as 3e-2 alone below 4). The mean bound sits 14x above the
    # readings (K2 7.3e-6) and below a residual added in bf16 (the xla block's
    # semantics). fp32: summation order.
    cases = [(torch.bfloat16, 64, 156, 3e-2, 1e-4), (torch.float32, 8, 156, 1e-4, 1e-5),
             (torch.bfloat16, 256, 128, 3e-2, 1e-4), (torch.bfloat16, 32, 32, 3e-2, 1e-4),
             (torch.bfloat16, 64, 32, 3e-2, 1e-4),
             (torch.float32, 8, 306, 1e-4, 1e-5), (torch.float32, 8, 512, 1e-4, 1e-5),
             (torch.bfloat16, 64, 256, 3e-2, 1e-4), (torch.bfloat16, 64, 257, 3e-2, 1e-4)]
    results = {}
    for dtype, B, S, tol_max, tol_mean in cases:
        def r(*shape, scale=1.0, dt=dtype):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

        mask = ragged_mask(gen, B, S, n_pad_rows=2)
        ls, lb = 1 + r(H, scale=0.1, dt=torch.float32), r(H, scale=0.1, dt=torch.float32)
        k1 = (r(B, S, 3 * H), r(B, S, H), mask, r(H, H, scale=0.02), r(H, scale=0.02),
              ls, lb, 1 / math.sqrt(hd), nh, hd, 1e-12)
        k2 = (r(B, S, H), r(H, F, scale=0.02), r(F, scale=0.02), r(F, H, scale=0.02),
              r(H, scale=0.02), ls, lb, 1e-12)
        bounds = block_bounds(B, S, H, nh, hd, F, torch.finfo(dtype).bits // 8,
                              "bf16" if dtype == torch.bfloat16 else "fp32")
        for name, fn, ref, args in (("K1", attn.fused_attention_ln, attn._reference_attention_ln, k1),
                                    ("K2", attn.fused_mlp_ln, attn._reference_mlp_ln, k2)):
            out = fn(*args)
            torch.cuda.synchronize()
            want = ref(*args)
            err = (out.float() - want.float()).abs()
            err_bound = (bf16_ulp(want).clamp(min=tol_max)
                         if name == "K2" and dtype == torch.bfloat16 else tol_max)
            within = bool((err <= err_bound).all())
            finite = bool(torch.isfinite(out).all())
            ms, plain_ms = cuda_ms(lambda: fn(*args)), cuda_ms(lambda: ref(*args))
            b_ms, b_by = bounds[name]
            row = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
            chain = ""
            if name == "K1":
                row.update(k1_split(lambda: fn(*args)))
                plan = attn.attn_ln_plan(B, S, H, nh, hd, dtype)
                if plan is not None:
                    row["scratch_bound_ms"] = 2 * 2 * B * S * H / HBM_BYTES_S * 1e3
                chain = f" body {row['body']}"
                if plan is not None:
                    chain += (f" (stage A {row['stage_a_ms']:.4f} ms, stage B "
                              f"{row['stage_b_ms']:.4f} ms; scratch bound "
                              f"{row['scratch_bound_ms']:.4f} ms)")
            if name == "K2" and dtype == torch.bfloat16:
                row["chain_ms"] = cuda_ms(lambda: xla_chain(*args))
                row["chain_max_abs_err"] = (xla_chain(*args).float()
                                            - want.float()).abs().max().item()
                chain = (f" xla chain {row['chain_ms']:.4f} ms (max_abs vs plain "
                         f"{row['chain_max_abs_err']:.3e})")
            log(f"{name} {str(dtype)[6:]} B={B} S={S}: max_abs {row['max_abs_err']:.3e} "
                f"mean_abs {row['mean_abs_err']:.3e} (tol {tol_max:g}"
                + (" or 1 ulp" if name == "K2" and dtype == torch.bfloat16 else "")
                + f"/{tol_mean:g}; within {within}) "
                f"finite={finite} kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound "
                f"{b_ms:.4f} ms ({b_by})" + chain)
            check(finite, f"{name} {dtype}: non-finite output")
            check(within and row["mean_abs_err"] <= tol_mean,
                  f"{name} {dtype} B={B} S={S}: kernel disagrees with its plain version")
            results[f"{name} {str(dtype)[6:]} B={B} S={S}"] = row
    return results


def topk_errors(q, corpus, vals, ids, ref_vals):
    """Rank-wise score error of a top-k against its reference, and the error of
    its ids rescored in fp64 against the reference's scores: ids may differ from
    the reference's only inside near ties. Queries are cast to the corpus dtype,
    as the search does."""
    Q = q.shape[0]
    vals, ids, ref_vals = vals.reshape(Q, -1), ids.reshape(Q, -1), ref_vals.reshape(Q, -1)
    rescored = torch.einsum("qd,qkd->qk", q.to(corpus.dtype).double(),
                            corpus[ids.long()].double())
    return (vals - ref_vals).abs(), (rescored - ref_vals.double()).abs()


def fp64_err(q, corpus, vals, ids, chunk=64):
    """The largest |score - fp64 score of the same id| over per-block lists [Q, nb, J]
    (queries in the kernels' input type; empty entries left out)."""
    err = 0.0
    for a in range(0, q.shape[0], chunk):
        v = vals[a:a + chunk].reshape(vals[a:a + chunk].shape[0], -1)
        i = ids[a:a + chunk].reshape(v.shape)
        d = (rescore(q[a:a + chunk], corpus, i) - v.double()).abs()
        err = max(err, float(torch.where(i >= 0, d, torch.zeros_like(d)).max()))
    return err


def block_errors(q, corpus, vals, ids, ref_vals, chunk=16):
    """Per-block lists [Q, nb, J] against the plain version's on the same rows: the largest
    rank-wise score error and the largest |fp64 score of the list's id - the plain score at
    that rank| (ids may differ from the plain version's only inside near ties), each over
    max(1, |plain score|); and whether both leave the same entries empty."""
    rank = rescored = 0.0
    same_empty = True
    for a in range(0, q.shape[0], chunk):
        n = min(chunk, q.shape[0] - a)
        v, i, w = (t[a:a + n].reshape(n, -1) for t in (vals, ids, ref_vals))
        filled = i >= 0
        same_empty &= bool((filled == torch.isfinite(w)).all())
        w64 = torch.where(filled, w.double(), torch.zeros_like(w, dtype=torch.float64))
        scale = w64.abs().clamp(min=1.0)
        zero = torch.zeros_like(w64)
        rank = max(rank, float(torch.where(filled, (v.double() - w64).abs() / scale, zero).max()))
        d = (rescore(q[a:a + n], corpus, i) - w64).abs() / scale
        rescored = max(rescored, float(torch.where(filled, d, zero).max()))
    return rank, rescored, same_empty


def phase_topk(gen, topk, blockwise_topk, n_rows, n_queries=1024, k=100, dim=768):
    """K5 through the certified search vs the exact scan on a seeded corpus; then block by
    block at the search's J (8) and its escalation's (32) on its Hopper bodies (fp32 as fp16
    pairs, ``flat_certified.cu``; bf16 on TMA + wgmma, ``flat_serve.cu``), with block_topj.cu's
    body on the same rows,
    2 elements off 16-byte alignment, for its time and error against fp64 beside theirs."""
    results = {}
    for dtype, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
        corpus = torch.randn(n_rows, dim, generator=gen, device="cuda").to(dtype)
        q = torch.randn(n_queries, dim, generator=gen, device="cuda")
        block = 4096  # FlatIPIndex's rule (flat.py:334) at this size
        before = certificate_counts(topk)
        s, ids = topk.certified_topk(q, corpus, k, block)
        torch.cuda.synchronize()
        bs, bids = blockwise_topk(q, corpus, k, block)
        escalated, fallbacks = np.subtract(certificate_counts(topk), before).tolist()
        tol = rel_tol * bs.abs().clamp(min=1.0)
        rank_err, rescored_err = topk_errors(q, corpus, s, ids, bs)
        mismatched = int((ids != bids).sum())
        qc = q.to(dtype)
        kern = lambda rows, j=8: topk.block_topj(qc, rows, j, block, n_rows)  # noqa: E731
        # the search's J (8) and its escalation's (32), each against the plain version and fp64
        held, err64 = {}, {}
        want = "flat_certified" if dtype == torch.float32 else "flat_serve"
        for J in (8, 32):
            vals, vids = kern(corpus, J)
            body = topk.block_topj.last_body
            check(body == want and topk.block_topj.launches_generic == 0,
                  f"K5 {dtype} J={J}: ran {body!r} ({topk.block_topj.launches_generic} "
                  f"launches of block_topj.cu's body), not {want}.cu's")
            err64[J] = fp64_err(q, corpus, vals, vids, chunk=16)
            ref_vals, _ = topk._block_topj_reference(qc, corpus, J, block, n_rows)
            held[J] = block_errors(q, corpus, vals, vids, ref_vals)
            del vals, vids, ref_vals
            check(held[J][0] <= rel_tol and held[J][1] <= rel_tol and held[J][2],
                  f"K5 {dtype} J={J}: per-block lists disagree with the plain version's "
                  f"(rank {held[J][0]:.3e}, rescored {held[J][1]:.3e} of max(1, |score|), "
                  f"same empty entries {held[J][2]})")
        ms = cuda_ms(lambda: kern(corpus), iters=3)
        ms_j32 = cuda_ms(lambda: kern(corpus, 32), iters=3)
        plain_ms = cuda_ms(lambda: topk._block_topj_reference(qc, corpus, 8, block, n_rows), iters=3)
        search_ms = cuda_ms(lambda: topk.certified_topk(q, corpus, k, block), iters=3)
        scan_ms = cuda_ms(lambda: blockwise_topk(q, corpus, k, block), iters=3)
        # block_topj.cu's body on the same rows (a shape the Hopper bodies do not take): one
        # call, then cuda_ms's warm-up and 3 timed calls
        generic0 = topk.block_topj.launches_generic
        check(generic0 == 0, f"K5 {dtype}: block_topj.cu's body ran {generic0} times in the "
              f"timed calls")
        moved = torch.empty(corpus.numel() + 2, dtype=dtype, device="cuda")[2:].view(corpus.shape)
        moved.copy_(corpus)
        vals, vids = kern(moved)
        generic_err64 = fp64_err(q, corpus, vals, vids)
        del vals, vids
        generic_ms = cuda_ms(lambda: kern(moved), iters=3)
        ran = topk.block_topj.launches_generic - generic0
        check(ran == 5 and topk.block_topj.last_body == "block_topj",
              f"K5 {dtype}: the comparison on unaligned rows ran block_topj.cu's body {ran} "
              f"times of its 5 calls")
        topk.block_topj.launches_generic = generic0  # those launches were the comparison's
        del moved
        if dtype == torch.float32:  # the fp16 pairs' error at most 2x the FFMA body's
            check(err64[8] <= 2 * generic_err64,
                  f"K5 fp32: max |score - fp64| {err64[8]:.3e} over 2x the FFMA body's "
                  f"{generic_err64:.3e} on the same rows")
        log(f"K5 {str(dtype)[6:]} {n_rows}x{dim} Q={n_queries} k={k}: ids differing {mismatched} "
            f"of {ids.numel()}, max rank score err {rank_err.max().item():.3e}, max rescored err "
            f"{rescored_err.max().item():.3e} (rel tol {rel_tol:g}), certificate escalated "
            f"{escalated} fallbacks {fallbacks}; block_topj kernel ({body}) J=8 {ms:.3f} ms, "
            f"J=32 {ms_j32:.3f} ms, max |score - fp64| J=8 {err64[8]:.3e} J=32 {err64[32]:.3e}, "
            f"against the plain version (of max(1, |score|); rank / rescored) J=8 "
            f"{held[8][0]:.3e} / {held[8][1]:.3e}, J=32 {held[32][0]:.3e} / {held[32][1]:.3e} "
            f"(<= {rel_tol:g}); block_topj.cu's body on the "
            f"same rows {generic_ms:.3f} ms, max |score - fp64| {generic_err64:.3e}; plain "
            f"{plain_ms:.3f} ms; certified search {search_ms:.3f} ms exact scan {scan_ms:.3f} ms")
        check(bool((rank_err <= tol).all()), f"K5 {dtype}: scores disagree with the exact scan")
        check(bool((rescored_err <= tol.double()).all()), f"K5 {dtype}: ids are not the top-k")
        results[str(dtype)[6:]] = {"max_abs_err": rank_err.max().item(), "ms": ms,
                                   "ms_j32": ms_j32, "body": body,
                                   "max_abs_err_fp64": err64[8], "max_abs_err_fp64_j32": err64[32],
                                   "plain_rel_err": held[8][:2], "plain_rel_err_j32": held[32][:2],
                                   "generic_ms": generic_ms,
                                   "generic_max_abs_err_fp64": generic_err64,
                                   "plain_ms": plain_ms, "search_ms": search_ms,
                                   "scan_ms": scan_ms, "escalated": escalated,
                                   "fallbacks": fallbacks}
        del corpus
        torch.cuda.empty_cache()
    return results


def make_batches(rng, n, max_len, prefix, batch, pad_batch, docs=None, median=60, sigma=0.5,
                 min_len=8):
    """Lognormal-length token sequences with [CLS]/[SEP]; queries (docs given)
    are prefixes of their passage, which makes passage i relevant to query i."""
    seqs = []
    for i in range(n):
        if docs is None:
            L = int(np.clip(rng.lognormal(math.log(median), sigma), min_len, max_len))
            seqs.append([101] + rng.integers(1000, 30522, L - 2).tolist() + [102])
        else:
            L = int(np.clip(rng.lognormal(math.log(10), 0.4), 4, max_len))
            seqs.append(docs[i][:L - 1] + [102])
    batches = [([f"{prefix}{j}" for j in range(s, min(s + batch, n))],
                pad_batch(seqs[s:s + batch], max_len, 0)) for s in range(0, n, batch)]
    return seqs, batches


def phase_main_path(args, tmp):
    from denseretrievaltoolkits_torch.evaluator.metrics import get_metrics
    from denseretrievaltoolkits_torch.evaluator.retrieval import search_queries, write_ranking
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModelForInference
    from denseretrievaltoolkits_torch.ops import attn, topk
    from denseretrievaltoolkits_torch.config import ModelArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.run_encode import encode_batches

    config = BertConfig(num_hidden_layers=args.layers)
    arch = os.path.join(tmp, "bert-base")
    save_config(config, arch)  # architecture-only dir: DRModel.build random-inits it
    model = DRModelForInference.build(
        ModelArguments(model_name_or_path=arch, dtype="bfloat16", attention="fused",
                       pooling="first"), device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    docs, p_batches = make_batches(rng, args.passages, 156, "d", args.batch, pad_batch)
    _, q_batches = make_batches(rng, args.queries, 32, "q", args.batch, pad_batch, docs=docs)
    n_tokens = sum(int(b["attention_mask"].sum()) for _, b in p_batches)
    log(f"main path: bert-base L={config.num_hidden_layers} H={config.hidden_size} bf16 fused; "
        f"{args.passages} passages (S=156, {n_tokens / args.passages:.1f} real tokens each), "
        f"{args.queries} queries (S=32), batch {args.batch}")

    def run(label, reps=None):
        """Encode (unless ``reps`` are given), index, search, rank, score."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reps is None:
            p_reps, p_lookup = encode_batches(model, p_batches, "passage", args.batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q_reps, q_lookup = encode_batches(model, q_batches, "query", args.batch)
        else:
            (p_reps, p_lookup), (q_reps, q_lookup) = reps
            t1 = None
        index = FlatIPIndex(p_reps.shape[1], dtype="float32", block_size=INDEX_BLOCK,
                            device="cuda")
        index.add(p_reps)
        index.docid = list(p_lookup)
        index.search(q_reps[:1], args.k)  # uploads the corpus; not part of the search time
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores, docids = search_queries(index, q_reps, index.docid, args.k,
                                        batch_size=args.queries)
        t3 = time.perf_counter()
        ranking = os.path.join(tmp, f"ranking_{label}.tsv")
        write_ranking(docids, scores, q_lookup, ranking)
        hits = np.array([[d == f"d{q}" for d in row] for q, row in enumerate(docids)])
        metrics = {k: v / len(q_lookup) for k, v in get_metrics(hits, [1, 10, 100]).items()}
        with open(ranking) as fh:
            n_lines = sum(1 for _ in fh)
        out = dict(p_reps=(p_reps, p_lookup), q_reps=(q_reps, q_lookup), scores=np.asarray(scores),
                   docids=np.asarray(docids), metrics=metrics,
                   queries_per_s=len(q_lookup) / (t3 - t2), ranking_lines=n_lines)
        if t1 is not None:
            out["passages_per_s"] = len(p_lookup) / (t1 - t0)
        log(f"{label}: encode {out.get('passages_per_s', 0):.1f} passages/s, search "
            f"{out['queries_per_s']:.1f} queries/s (k={args.k}, {index.block_size}-row blocks), "
            f"ranking {n_lines} lines, metrics {json.dumps(metrics)}")
        check(p_reps.shape == (args.passages, config.hidden_size), f"{label}: passage reps shape")
        check(np.isfinite(p_reps).all() and np.isfinite(q_reps).all(), f"{label}: non-finite reps")
        check(n_lines == args.queries * args.k, f"{label}: ranking file length")
        return out

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, topk.block_topj)
    counts0 = certificate_counts(topk)
    for fn in counted:
        fn.launches = 0
    kern = run("kernels")
    launches = {fn.__name__: fn.launches for fn in counted}
    escalated, fallbacks = np.subtract(certificate_counts(topk), counts0).tolist()
    log(f"launches on the main path: {json.dumps(launches)}; certificate escalated queries "
        f"{escalated}, fallback queries {fallbacks}")
    check(all(n > 0 for n in launches.values()), "a kernel of the main path never launched")

    # where an encode's device time goes: a profiled encode of the first passage batches
    kern["encode_profile"] = encode_split(
        lambda: encode_batches(model, p_batches[:ENCODE_PROFILE_BATCHES], "passage", args.batch))
    split = kern["encode_profile"]
    log(f"encode time split ({ENCODE_PROFILE_BATCHES} batches of {args.batch} passages, S=156; "
        f"torch.profiler): wall {split['wall_ms']:.2f} ms, device {split['device_ms']:.2f} ms "
        f"(busy {split['busy']:.3f}); by kernel group (ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in split["groups_ms"].items()))
    check("K1 stage A (attention)" in split["groups_ms"]
          and "K1 stage B (projection + LN)" in split["groups_ms"]
          and "K1 (mma.sync / CUDA-core bodies)" not in split["groups_ms"],
          "the S=156 encode did not run K1's Hopper body (attn_ln_stage_a, attn_ln_stage_b)")

    # K5 at the main path's own shape: the kernels' reps, the index's blocks and J
    q = torch.from_numpy(kern["q_reps"][0]).cuda()
    corpus = torch.from_numpy(kern["p_reps"][0]).cuda()
    J = max(4, min(args.k, 8))
    vals, ids = topk.block_topj(q, corpus, J, INDEX_BLOCK, corpus.shape[0])
    ref_vals, _ = topk._block_topj_reference(q, corpus, J, INDEX_BLOCK, corpus.shape[0])
    rank_err, rescored_err = topk_errors(q, corpus, vals, ids, ref_vals)
    tol = 1e-5 * ref_vals.reshape(q.shape[0], -1).abs().clamp(min=1.0)
    log(f"K5 float32 at the main path's shape ({q.shape[0]} x {tuple(corpus.shape)}, block "
        f"{INDEX_BLOCK}, J={J}; body {topk.block_topj.last_body}): max rank score err "
        f"{rank_err.max().item():.3e}, max rescored err {rescored_err.max().item():.3e} (rel tol "
        f"1e-05); block_topj.cu's body launched {topk.block_topj.launches_generic} times")
    check(bool((rank_err <= tol).all()) and bool((rescored_err <= tol.double()).all()),
          "K5 disagrees with its plain version at the main path's shape")
    check(topk.block_topj.last_body == "flat_certified" and topk.block_topj.launches_generic == 0,
          "the main path's K5 did not run flat_certified.cu's body alone")

    with mock.patch.object(attn, "fused_attention_ln", attn._reference_attention_ln), \
            mock.patch.object(attn, "fused_mlp_ln", attn._reference_mlp_ln), \
            mock.patch.object(topk, "block_topj", topk._block_topj_reference):
        plain = run("plain")
        plain_search = run("plain search over the kernels' reps",
                           reps=(kern["p_reps"], kern["q_reps"]))

    def cos(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    cos_min = float(min(cos(kern["p_reps"][0], plain["p_reps"][0]).min(),
                        cos(kern["q_reps"][0], plain["q_reps"][0]).min()))
    search_overlap = overlap(kern["docids"], plain_search["docids"])
    e2e_overlap = overlap(kern["docids"], plain["docids"])
    # how flat the ranking is: the spread of the top-k scores vs the score change
    # the encoders' bf16 differences cause on the same (query, passage) pairs
    spread = float(np.median(plain["scores"][:, 0] - plain["scores"][:, -1]))
    qk, pk = kern["q_reps"][0], kern["p_reps"][0]
    qp, pp = plain["q_reps"][0], plain["p_reps"][0]
    pairs = np.array([[int(d[1:]) for d in row] for row in plain["docids"]])
    shift = float(np.median(np.abs(np.einsum("qd,qkd->qk", qk, pk[pairs])
                                   - np.einsum("qd,qkd->qk", qp, pp[pairs]))))
    log(f"kernels vs plain: reps cosine min {cos_min:.6f} (>= 0.999); search over the same reps: "
        f"top-{args.k} overlap {search_overlap:.5f} (>= 0.99); median top-{args.k} score spread "
        f"{spread:.4g}, median score shift from the encoders {shift:.4g}")
    # Random-weight CLS reps rank a flat tail, which the encoders' bf16 roundings
    # reorder: the end-to-end bounds come from the readings (overlap 0.929, metric
    # gap 0.0078, i.e. 4 of 512 queries changing their hit), with a little room.
    metric_gap = max(abs(kern["metrics"][m] - plain["metrics"][m]) for m in plain["metrics"])
    log(f"end to end: top-{args.k} overlap {e2e_overlap:.5f} (>= 0.90), largest metric "
        f"difference {metric_gap:.4f} (<= 0.012)")
    check(cos_min >= 0.999, "reps disagree with the plain path")
    check(search_overlap >= 0.99, "search results disagree with the plain path")
    check(e2e_overlap >= 0.90, "end-to-end rankings disagree with the plain path")
    check(metric_gap <= 0.012, "metrics disagree with the plain path")
    keep = ("passages_per_s", "queries_per_s", "metrics", "encode_profile")
    return {"launches": launches, "escalated_queries": escalated, "fallback_queries": fallbacks,
            "cos_min": cos_min, "search_overlap": search_overlap, "e2e_overlap": e2e_overlap,
            "metric_gap": metric_gap, "k5_max_abs_err": rank_err.max().item(),
            "score_spread": spread, "score_shift": shift,
            "kernels": {k: v for k, v in kern.items() if k in keep},
            "plain": {k: v for k, v in plain.items() if k in keep}}, kern


# the groups of the encode's kernels: a kernel joins the first group all of whose
# pieces its (demangled) name holds; "other" takes the rest
ENCODE_GROUPS = (("K2 stage A (gelu)", ("mlp_ln_stage_a",)),
                 ("K2 stage B (LN)", ("mlp_ln_stage_b",)),
                 ("K2 (CUDA-core body)", ("mlp_ln_kernel",)),
                 ("K1 stage A (attention)", ("attn_ln_stage_a",)),
                 ("K1 stage B (projection + LN)", ("attn_ln_stage_b",)),
                 ("K1 (mma.sync / CUDA-core bodies)", ("attn_ln",)),
                 ("products (cuBLAS)", ("nvjet",)), ("products (cuBLAS)", ("gemm",)),
                 ("elementwise (bias adds, embeddings)", ("elementwise_kernel",)))
ENCODE_PROFILE_BATCHES = 16
# the groups of a flash training step's kernels (S=512), as ENCODE_GROUPS
TRAIN_STEP_GROUPS = (("F-fwd", ("flash_fwd",)), ("F-dq", ("flash_dq",)),
                     ("F-dkv", ("flash_dkv",)), ("K3 / K4 (contrastive loss)", ("contrastive",)),
                     ("products (cuBLAS)", ("nvjet",)), ("products (cuBLAS)", ("gemm",)),
                     ("LayerNorm", ("layer_norm",)), ("optimizer", ("multi_tensor",)),
                     ("reductions", ("reduce_kernel",)),
                     ("elementwise (bias adds, gelu, casts)", ("elementwise_kernel",)))


def encode_split(fn, groups=ENCODE_GROUPS):
    """One call of ``fn`` under ``torch.profiler``: its wall ms (ended by a
    synchronize), the device ms of its CUDA kernels, their share of the wall
    time, and their ms by ``groups`` (the rest as "other") and by name. The run
    before it has built the kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    by_group = {}
    for name, ms in by_name.items():
        group = next((g for g, pieces in groups if all(p in name for p in pieces)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    device_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
            "groups_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": {k[:120]: v for k, v in top.items()}}


def peak_mib(fn):
    """Peak device memory allocated while ``fn`` runs, above what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def ffma_bwd(con, dp, q, p, lse, stride, gout):
    """K4's FFMA body (``contrastive_bwd_kernel``) on the same inputs: its C entry given no
    scratch, which the tensor-core body needs."""
    from denseretrievaltoolkits_torch.ops import _native

    out = torch.empty(p.shape[0] if dp else q.shape[0], q.shape[1], device=q.device)
    body = ctypes.c_int(-1)
    entry = "drt_contrastive_dp" if dp else "drt_contrastive_dq"
    _native.check(getattr(_native.library(), entry)(
        q.data_ptr(), p.data_ptr(), lse.data_ptr(), gout.data_ptr(), out.data_ptr(), q.shape[0],
        p.shape[0], q.shape[1], stride, 0, ctypes.byref(body), _native.stream_ptr(q)), entry)
    check(body.value == 0, f"{entry} without scratch did not run the FFMA body")
    return out


def ffma_fwd(q, p, stride):
    """K3's FFMA body (``contrastive_fwd_kernel``) on the same inputs: its C entry given no
    scratch, which the tensor-core body needs."""
    from denseretrievaltoolkits_torch.ops import _native

    lse = torch.empty(q.shape[0], device=q.device)
    tgt = torch.empty_like(lse)
    body = ctypes.c_int(-1)
    _native.check(_native.library().drt_contrastive_fwd(
        q.data_ptr(), p.data_ptr(), lse.data_ptr(), tgt.data_ptr(), q.shape[0], p.shape[0],
        q.shape[1], stride, 0, ctypes.byref(body), _native.stream_ptr(q)), "drt_contrastive_fwd")
    check(body.value == 0, "drt_contrastive_fwd without scratch did not run the FFMA body")
    return lse, tgt


def phase_contrastive(gen, con):
    """K3 and K4 vs their plain versions, fp32, H=768: at grad-cache scale,
    ragged, and at the training path's shape (Q=32, P=256). Both run their
    tensor-core bodies (fp16 pairs; ``launches_generic`` 0), whose errors against
    fp64 are printed beside the FFMA bodies' on the same inputs."""
    from denseretrievaltoolkits_torch.ops import _native

    H, stride = 768, 8
    # fp32 sums in another order. Readings on the H100: loss rel err 0, grads
    # 4.4e-6 of max|grad|; the bounds keep 5-10x of room and still fail the
    # planted variants (target one column off: loss 7.9e-4, grads ~1).
    loss_tol, grad_tol = 1e-6, 2e-5
    results = {}
    for Q, P in ((4096, 32768), (1000, 8000), (32, 256)):
        q = 0.3 * torch.randn(Q, H, generator=gen, device="cuda")
        p = 0.3 * torch.randn(P, H, generator=gen, device="cuda")
        one = torch.ones((), device="cuda")
        rows = torch.arange(Q, device="cuda")

        def kernels():
            lse, tgt = con.contrastive_fwd(q, p, stride)
            return (lse, tgt, con.contrastive_bwd_dq(q, p, lse, stride, one),
                    con.contrastive_bwd_dp(q, p, lse, stride, one))

        def plain_versions():
            lse, tgt = con._reference_contrastive_fwd(q, p, stride)
            return (lse, tgt) + con._reference_contrastive_bwd(q, p, lse, stride, one)

        def plain_g(lse, target_shift=0, scale_nq=True):
            """g on the materialized [Q, P] (the plain K4's closed form), with
            an optional planted fault."""
            g = torch.exp(torch.matmul(q, p.T) - lse[:, None])
            g[rows, rows * stride + target_shift] -= 1.0
            return g / Q if scale_nq else g

        def planted(target_shift=0, scale_nq=True):
            s = torch.matmul(q, p.T)
            lse = torch.logsumexp(s, 1)
            g = plain_g(lse, target_shift, scale_nq)
            return lse, s[rows, rows * stride + target_shift], g @ p, g.T @ q

        def errors(got, want):
            loss_g = float((got[0] - got[1]).sum() / Q)
            loss_w = float((want[0] - want[1]).sum() / Q)
            return (abs(loss_g - loss_w) / abs(loss_w),
                    float((got[2] - want[2]).abs().max() / want[2].abs().max()),
                    float((got[3] - want[3]).abs().max() / want[3].abs().max()))

        generic0 = (con.contrastive_fwd.launches_generic, con.contrastive_bwd_dq.launches_generic,
                    con.contrastive_bwd_dp.launches_generic)
        out = kernels()
        torch.cuda.synchronize()
        k3_body = con.contrastive_fwd.last_body
        bodies = (con.contrastive_bwd_dq.last_body, con.contrastive_bwd_dp.last_body)
        # the parts the tensor-core bodies split the walked axis into (minus a cudaError_t
        # where the card's SM count or cluster occupancy could not be read)
        k3_parts = _native.library().drt_contrastive_fwd_parts(Q, P, H)
        splits = [_native.library().drt_contrastive_splits(Q, P, H, dp) for dp in (0, 1)]
        check(k3_parts > 0, f"K3 Q={Q} P={P}: walked-axis parts {k3_parts}")
        check(min(splits) > 0, f"K4 Q={Q} P={P}: walked-axis parts dq / dp {splits}")
        n_generic = (con.contrastive_fwd.launches_generic, con.contrastive_bwd_dq.launches_generic,
                     con.contrastive_bwd_dp.launches_generic)
        check(k3_body == "wgmma" and n_generic[0] == generic0[0],
              f"K3 Q={Q} P={P}: ran {k3_body}, not the tensor-core body")
        check(bodies == ("wgmma", "wgmma") and n_generic[1:] == generic0[1:],
              f"K4 Q={Q} P={P}: ran {bodies}, not the tensor-core body")
        want = plain_versions()
        loss_err, dq_err, dp_err = errors(out, want)
        # against fp64, beside the FFMA bodies' on the same inputs
        qd, pd = q.double(), p.double()
        s64 = qd @ pd.T
        lse64 = torch.logsumexp(s64, 1)
        fwd64 = (lse64, s64[rows, rows * stride])
        g64 = torch.exp(s64 - lse64[:, None])
        del s64
        g64[rows, rows * stride] -= 1.0
        g64 /= Q
        want64 = (g64 @ pd, g64.T @ qd)
        del qd, pd, g64
        k3_fp64_err = [float((a.double() - b).abs().max()) for a, b in zip(out[:2], fwd64)]
        k3_ffma_fp64_err = [float((a.double() - b).abs().max())
                            for a, b in zip(ffma_fwd(q, p, stride), fwd64)]
        # at most 2x the FFMA body's, or one fp32 ulp of the largest value where both round
        # alike (the training path's small shape)
        k3_err_bound = [max(2 * e, 2.0 ** -23 * float(b.abs().max()))
                        for e, b in zip(k3_ffma_fp64_err, fwd64)]
        del fwd64
        lse_k = out[0]
        ffma = (ffma_bwd(con, False, q, p, lse_k, stride, one),
                ffma_bwd(con, True, q, p, lse_k, stride, one))
        fp64_err = [float((a.double() - b).abs().max() / b.abs().max())
                    for a, b in zip(out[2:], want64)]
        ffma_fp64_err = [float((a.double() - b).abs().max() / b.abs().max())
                         for a, b in zip(ffma, want64)]
        del ffma, want64
        abs_err = [float((a - b).abs().max()) for a, b in zip(out, want)]
        off = errors(planted(target_shift=1), want)
        no_nq = errors(planted(scale_nq=False), want)
        lse = want[0]
        del out, want
        t = {"fwd": cuda_ms(lambda: con.contrastive_fwd(q, p, stride)),
             "fwd_ffma": cuda_ms(lambda: ffma_fwd(q, p, stride)),
             "fwd_plain": cuda_ms(lambda: con._reference_contrastive_fwd(q, p, stride)),
             "dq": cuda_ms(lambda: con.contrastive_bwd_dq(q, p, lse, stride, one)),
             "dq_ffma": cuda_ms(lambda: ffma_bwd(con, False, q, p, lse, stride, one)),
             "dq_plain": cuda_ms(lambda: plain_g(lse) @ p),
             "dp": cuda_ms(lambda: con.contrastive_bwd_dp(q, p, lse, stride, one)),
             "dp_ffma": cuda_ms(lambda: ffma_bwd(con, True, q, p, lse, stride, one)),
             "dp_plain": cuda_ms(lambda: plain_g(lse).T @ q),
             "all": cuda_ms(kernels), "all_plain": cuda_ms(plain_versions)}
        kernel_mib, plain_mib = peak_mib(kernels), peak_mib(plain_versions)
        log(f"K3/K4 fp32 Q={Q} P={P} H={H} stride {stride}: loss rel err {loss_err:.3e} (<= "
            f"{loss_tol:g}), dq {dq_err:.3e} dp {dp_err:.3e} of max|grad| (<= {grad_tol:g}); "
            f"max_abs lse {abs_err[0]:.3e} tgt {abs_err[1]:.3e} dq {abs_err[2]:.3e} dp "
            f"{abs_err[3]:.3e}; planted: target+1 loss {off[0]:.3e} dq {off[1]:.3e} dp "
            f"{off[2]:.3e}, no 1/n_q dq {no_nq[1]:.3e} dp {no_nq[2]:.3e}")
        log(f"K3/K4 Q={Q} P={P} ms, kernel vs plain: forward {t['fwd']:.3f} vs "
            f"{t['fwd_plain']:.3f}; dq {t['dq']:.3f} vs {t['dq_plain']:.3f}; dp {t['dp']:.3f} vs "
            f"{t['dp_plain']:.3f}; forward+backward {t['all']:.3f} vs {t['all_plain']:.3f}; peak "
            f"memory forward+backward {kernel_mib:.1f} MiB vs {plain_mib:.1f} MiB")
        log(f"K3 Q={Q} P={P} body {k3_body}, walked-axis parts {k3_parts}: max |x - fp64| lse "
            f"{k3_fp64_err[0]:.3e} tgt {k3_fp64_err[1]:.3e} (the FFMA body on the same inputs: "
            f"{k3_ffma_fp64_err[0]:.3e} / {k3_ffma_fp64_err[1]:.3e}, {t['fwd_ffma']:.3f} ms)")
        log(f"K4 Q={Q} P={P} bodies dq / dp {bodies[0]} / {bodies[1]}, walked-axis parts "
            f"{splits[0]} / {splits[1]}: max |grad - fp64| of "
            f"max|grad| dq {fp64_err[0]:.3e} dp {fp64_err[1]:.3e} (the FFMA body on the same "
            f"inputs: {ffma_fp64_err[0]:.3e} / {ffma_fp64_err[1]:.3e}, {t['dq_ffma']:.3f} / "
            f"{t['dp_ffma']:.3f} ms)")
        check(loss_err <= loss_tol and dq_err <= grad_tol and dp_err <= grad_tol,
              f"K3/K4 Q={Q} P={P}: kernels disagree with their plain versions")
        check(all(e <= b for e, b in zip(k3_fp64_err, k3_err_bound)),
              f"K3 Q={Q} P={P}: lse / tgt error against fp64 {k3_fp64_err} past {k3_err_bound}")
        check(off[0] > loss_tol and min(off[1:]) > grad_tol,
              "a plain variant with the target one column off passes the bounds")
        check(min(no_nq[1:]) > grad_tol, "a plain variant without 1/n_q passes the bounds")
        check(kernel_mib < plain_mib, f"K3/K4 Q={Q} P={P}: kernel path's peak memory is not "
              f"below the plain path's")
        results[f"{Q}x{P}"] = {
            "loss_rel_err": loss_err, "dq_rel_err": dq_err, "dp_rel_err": dp_err,
            "max_abs_err": dict(zip(("lse", "tgt", "dq", "dp"), abs_err)), "ms": t,
            "peak_mib": kernel_mib, "plain_peak_mib": plain_mib, "target_off": off,
            "no_nq": no_nq, "bodies": bodies, "splits": splits, "fp64_rel_err": fp64_err,
            "ffma_fp64_rel_err": ffma_fp64_err, "k3_body": k3_body, "k3_parts": k3_parts,
            "k3_fp64_abs_err": k3_fp64_err, "k3_ffma_fp64_abs_err": k3_ffma_fp64_err}
        del q, p, lse
        torch.cuda.empty_cache()
    return results


def make_train_rows(rng, n_rows, n_passages, p_max_len, q_max_len, median=60, sigma=0.5,
                    min_len=8):
    """Synthetic training rows (query, [positive, negatives...]): passages with
    lognormal lengths, the query a prefix of its positive passage."""
    rows = []
    for _ in range(n_rows):
        ps = []
        for _ in range(n_passages):
            L = int(np.clip(rng.lognormal(math.log(median), sigma), min_len, p_max_len))
            ps.append([101] + rng.integers(1000, 30522, L - 2).tolist() + [102])
        L = int(np.clip(rng.lognormal(math.log(10), 0.4), 4, q_max_len))
        rows.append((ps[0][:L - 1] + [102], ps))
    return rows


@contextlib.contextmanager
def plain_encoder():
    """The plain PyTorch versions in place of K1, K2 and the fused K3/K4 loss."""
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con
    from denseretrievaltoolkits_torch.train.losses import contrastive_loss

    with mock.patch.object(attn, "fused_attention_ln", attn._reference_attention_ln), \
            mock.patch.object(attn, "fused_mlp_ln", attn._reference_mlp_ln), \
            mock.patch.object(con, "fused_contrastive_loss",
                              lambda q, p, stride: contrastive_loss(q, p)[0]):
        yield


def phase_train(args, tmp):
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModel, DRModelForInference
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con
    from denseretrievaltoolkits_torch.config import ModelArguments, TrainingArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.data.loaders import DataLoader
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    config = BertConfig(num_hidden_layers=TRAIN_LAYERS)
    arch = os.path.join(tmp, "bert-base-train")
    save_config(config, arch)
    margs = ModelArguments(model_name_or_path=arch, dtype="bfloat16", attention="fused",
                           fused_loss=True, pooling="first")
    B, n_p, q_len, p_len = TRAIN_BATCH, 8, 32, 128
    rng = np.random.default_rng(args.seed)
    rows = make_train_rows(rng, TRAIN_STEPS_PER_EPOCH * B, n_p, p_len, q_len)

    def collate(batch):
        return (pad_batch([q for q, _ in batch], q_len, 0),
                pad_batch([p for _, ps in batch for p in ps], p_len, 0))

    def loader():
        return DataLoader(rows, B, collate, shuffle=True, seed=args.seed)

    def build():
        return DRModel.build(margs, device="cuda", seed=args.seed)

    def trainer_for(label, model, epochs=2):
        targs = TrainingArguments(
            output_dir=os.path.join(tmp, label, "out"), cache_train_dir=os.path.join(
                tmp, label, "cache"), train_batch_size=B, max_epochs=epochs,
            learning_rate=TRAIN_LR, optimizer="adamw", scheduler="linear",
            warmup_ratio=0.1, log_every=1, save_per_train=epochs)
        return Trainer(targs, model, train_loader=loader())

    def logged(trainer):
        with open(os.path.join(trainer.training_args.output_dir, "train_log.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        return ([r["loss"] for r in recs if "loss" in r],
                [r["mean_loss"] for r in recs if "mean_loss" in r])

    batches = list(loader())
    q_tok = int(batches[0][0]["attention_mask"].sum())
    p_tok = int(batches[0][1]["attention_mask"].sum())
    log(f"training path: bert-base L={config.num_hidden_layers} H={config.hidden_size} bf16 "
        f"fused attention + fused loss, tied; batch {B} queries x {n_p} passages (P={B * n_p}), "
        f"q_max_len {q_len} p_max_len {p_len}, {len(batches)} steps/epoch x 2 epochs, adamw "
        f"lr {TRAIN_LR:g} linear warmup 0.1; first batch {q_tok} + {p_tok} real tokens")

    def step1_grads():
        model = build()
        loss = model(*batches[0])["loss"]
        loss.backward()
        flat = torch.cat([prm.grad.flatten() for prm in model.parameters()
                          if prm.grad is not None])
        return float(loss.detach()), flat

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, con.contrastive_fwd,
               con.contrastive_bwd_dq, con.contrastive_bwd_dp)
    kern_trainer = trainer_for("kernels", build())
    for fn in counted:
        fn.launches = 0
    kern_trainer.train()
    launches = {fn.__name__: fn.launches for fn in counted}
    kern_losses, kern_means = logged(kern_trainer)
    log(f"launches on the training path: {json.dumps(launches)}")
    log(f"kernels: step losses {json.dumps([round(x, 5) for x in kern_losses])}, epoch means "
        f"{json.dumps(kern_means)}")
    check(all(n > 0 for n in launches.values()), "a kernel of the training path never launched")
    check(con.contrastive_fwd.last_body == "wgmma",
          f"K3 ran its {con.contrastive_fwd.last_body} body on the training path, not wgmma")
    check(all(math.isfinite(x) for x in kern_losses), "a training loss is not finite")
    check(kern_means[-1] < kern_means[0], "the loss did not fall from the first epoch to the last")
    k_loss1, k_grad = step1_grads()

    with plain_encoder():
        plain_trainer = trainer_for("plain", build())
        plain_trainer.train()
        plain_losses, plain_means = logged(plain_trainer)
        p_loss1, p_grad = step1_grads()
    step1_rel = abs(k_loss1 - p_loss1) / abs(p_loss1)
    k_norm, p_norm = k_grad.double().norm(), p_grad.double().norm()
    cos = float(torch.dot(k_grad.double(), p_grad.double()) / (k_norm * p_norm))
    norm_ratio = float(k_norm / p_norm)
    step_gap = max(abs(a - b) for a, b in zip(kern_losses, plain_losses))
    del k_grad, p_grad
    log(f"plain: step losses {json.dumps([round(x, 5) for x in plain_losses])}, epoch means "
        f"{json.dumps(plain_means)}")
    log(f"kernels vs plain: step-1 loss {k_loss1:.6f} vs {p_loss1:.6f} (rel {step1_rel:.3e}, "
        f"<= {TRAIN_STEP1_REL:g}); step-1 gradient cosine {cos:.6f} (>= {TRAIN_GRAD_COS:g}), "
        f"norm ratio {norm_ratio:.6f} (within {TRAIN_GRAD_NORM:g} of 1); largest step-loss gap "
        f"{step_gap:.4e} (<= {TRAIN_STEP_GAP:g})")
    check(abs(k_loss1 - kern_losses[0]) <= 1e-6 * abs(k_loss1) + 1e-6,
          "the step-1 loss does not repeat from the same init")
    check(step1_rel <= TRAIN_STEP1_REL, "step-1 loss disagrees with the plain path")
    check(cos >= TRAIN_GRAD_COS, "step-1 gradients disagree with the plain path")
    check(abs(norm_ratio - 1) <= TRAIN_GRAD_NORM,
          "step-1 gradient norms disagree with the plain path")
    check(step_gap <= TRAIN_STEP_GAP, "step losses disagree with the plain path")

    def steps_per_s(trainer, n=TRAIN_TIMED_STEPS):
        """(steps/s, tokens/s, peak MiB allocated during the timed steps: both
        trainers' weights and optimizer states, and this trainer's step)"""
        for b in batches[:2]:  # warm-up
            trainer.train_step(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(n):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tokens = sum(int(batches[i % len(batches)][0]["attention_mask"].sum())
                     + int(batches[i % len(batches)][1]["attention_mask"].sum()) for i in range(n))
        return n / dt, tokens / dt, torch.cuda.max_memory_allocated() / 2 ** 20

    # deploy format and checkpoint, before timing moves the trained weights
    result = os.path.join(kern_trainer.training_args.cache_train_dir, "result2")
    served = DRModelForInference.build(
        ModelArguments(model_name_or_path=result, dtype="bfloat16", attention="fused"),
        device="cuda")
    reps_gap = max(float((served.encode_query(batches[1][0])
                          - kern_trainer.model.encode_query(batches[1][0])).abs().max()),
                   float((served.encode_passage(batches[1][1])
                          - kern_trainer.model.encode_passage(batches[1][1])).abs().max()))
    del served
    resumed = trainer_for("resumed", build())
    resumed.load(os.path.join(kern_trainer.training_args.output_dir, "checkpoint", "ep2"))
    next_batch = batches[0]
    resumed_loss = float(resumed.train_step(next_batch))
    del resumed
    straight_loss = float(kern_trainer.train_step(next_batch))
    log(f"deploy format reloaded by DRModelForInference.build: reps max-abs gap {reps_gap:.3e} "
        f"(== 0); checkpoint ep2 resumed: next-step loss {resumed_loss:.6f} vs uninterrupted "
        f"{straight_loss:.6f}")
    check(reps_gap == 0.0, "the reloaded deploy format encodes differently")
    check(resumed_loss == straight_loss, "a resumed run does not repeat the uninterrupted run")

    # in turns, kernels / plain / plain / kernels
    rates = {"kernels": [steps_per_s(kern_trainer)]}
    with plain_encoder():
        rates["plain"] = [steps_per_s(plain_trainer), steps_per_s(plain_trainer)]
    rates["kernels"].append(steps_per_s(kern_trainer))
    del kern_trainer, plain_trainer
    torch.cuda.empty_cache()
    kern_rate, plain_rate = (np.mean(rates[k], axis=0).tolist() for k in ("kernels", "plain"))
    log(f"train step ({TRAIN_TIMED_STEPS} steps after 2 warm-up, twice each, in turns): "
        f"kernels {kern_rate[0]:.3f} steps/s {kern_rate[1]:.0f} tokens/s peak "
        f"{kern_rate[2]:.0f} MiB; plain {plain_rate[0]:.3f} steps/s {plain_rate[1]:.0f} "
        f"tokens/s peak {plain_rate[2]:.0f} MiB; readings "
        f"{json.dumps({k: [round(r[0], 4) for r in v] for k, v in rates.items()})}")
    return {"launches": launches, "losses": kern_losses, "epoch_means": kern_means,
            "plain_losses": plain_losses, "plain_epoch_means": plain_means,
            "step1_rel": step1_rel, "grad_cos": cos, "grad_norm_ratio": norm_ratio,
            "step_gap": step_gap,
            "reps_gap": reps_gap, "resumed_loss": resumed_loss, "straight_loss": straight_loss,
            "steps_per_s": kern_rate[0], "tokens_per_s": kern_rate[1],
            "plain_steps_per_s": plain_rate[0], "plain_tokens_per_s": plain_rate[1],
            "peak_mib": kern_rate[2], "plain_peak_mib": plain_rate[2]}


# Grad-cache training (phase A): agreement with the full-batch step where that fits (64
# queries x 8 passages, chunks of 16 queries and 128 passages), then the scale the fused
# loss exists for (4096 x 8: Q=4096, P=32768, the K3 / K4 shape of phase 4) with chunks of
# 256 queries and 1024 passages, and the same chunks at 512 x 8 for the peak's reference:
# one chunk sets the peak, not the batch, so 4096's may exceed 512's by at most 1.25x. The
# 512 x 8 steps warm up the chunks' encode shapes, so 4096 x 8 runs one timed step.
GC_AGREE_QUERIES, GC_AGREE_CHUNKS = 64, (16, 128)
# the agreement is also held tighter than phase 5's bounds: only the order of the fp32 sums
# over chunks moves (read on an H100: cosine 0.99997, norm ratio 0.99995)
GC_AGREE_COS, GC_AGREE_NORM = 0.9999, 1e-3
GC_SCALE_QUERIES, GC_PEAK_QUERIES, GC_CHUNKS = 4096, 512, (256, 1024)
GC_PEAK_RATIO = 1.25
# the 4096 x 8 and 512 x 8 steps run a bert-base of this depth (widths unchanged): pass 3,
# 96% of the step, scales with the layers; K3 / K4 still run at Q=4096, P=32768
GC_SCALE_LAYERS = 4
# remat (phase B): the training path's shape; recomputation repeats the forward, so the
# step-1 loss and gradients equal those without remat (expected bit-equal)
REMAT_CASES = (("fused", ""), ("fused", "full"), ("fused", "attn"), ("xla", ""),
               ("xla", "full"), ("xla", "attn"))
REMAT_LOSS_REL, REMAT_GRAD_COS, REMAT_TIMED_STEPS = 1e-6, 0.99999, 4
REMAT_LAYERS = 4  # bert-base widths at this depth
REMAT_FUSED_ATTN_PEAK = 0.01  # 'attn' on 'fused' adds nothing: its peak within 1% of ''


def train_model_args(tmp, label, layers=None, **kw):
    """A bert-base architecture-only dir (seeded random init at ``layers``, TRAIN_LAYERS
    by default) and its ModelArguments: bf16, tied, CLS pooling, fused loss, ``kw`` on
    top."""
    from denseretrievaltoolkits_torch.config import ModelArguments
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config

    arch = os.path.join(tmp, f"bert-base-{label}")
    save_config(BertConfig(num_hidden_layers=layers or TRAIN_LAYERS), arch)
    return ModelArguments(model_name_or_path=arch, fused_loss=True, pooling="first",
                          **{"attention": "fused", "dtype": "bfloat16", **kw})


def train_batch(rng, n_queries, n_passages=8, q_len=32, p_len=128):
    """One (query, passage) batch of ``make_train_rows`` rows, padded as the training
    path's collator pads."""
    from denseretrievaltoolkits_torch.data.collators import pad_batch

    rows = make_train_rows(rng, n_queries, n_passages, p_len, q_len)
    return (pad_batch([q for q, _ in rows], q_len, 0),
            pad_batch([p for _, ps in rows for p in ps], p_len, 0))


def step_trainer(tmp, label, model, mesh=None, **kw):
    """A Trainer over ``model`` (on ``mesh``) for single steps (adamw at TRAIN_LR, no
    schedule, unless ``kw`` says otherwise)."""
    from denseretrievaltoolkits_torch.config import TrainingArguments
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    targs = dict(output_dir=os.path.join(tmp, label, "out"),
                 cache_train_dir=os.path.join(tmp, label, "c"), learning_rate=TRAIN_LR,
                 optimizer="adamw", log_every=0)
    targs.update(kw)
    return Trainer(TrainingArguments(**targs), model, mesh=mesh)


def step_grads(trainer, batch):
    """(loss, flat fp32 gradient) of one Trainer step: the step leaves each
    parameter's gradient in ``.grad``."""
    loss = float(trainer.train_step(batch))
    grad = torch.cat([p.grad.flatten().float() for p in trainer.model.parameters()
                      if p.grad is not None])
    return loss, grad


def grad_agreement(loss, grad, ref_loss, ref_grad):
    """(loss relative gap, gradient cosine, norm ratio), in fp64."""
    a, b = grad.double(), ref_grad.double()
    return (abs(loss - ref_loss) / abs(ref_loss), float(a @ b / (a.norm() * b.norm())),
            float(a.norm() / b.norm()))


@contextlib.contextmanager
def pass_events(gc):
    """CUDA events around each pass of ``train/grad_cache.py``'s step; yields the
    list of (pass, start, end) they fill."""
    marks = []

    def timed(name, fn):
        def run(model, *a):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(model, *a)
            end.record()
            label = name if name == "loss (K3 / K4)" else f"{name} {a[0]}"
            marks.append((label, start, end, [tuple(t.shape) for t in a if torch.is_tensor(t)]))
            return out
        return run

    with mock.patch.object(gc, "encode_chunks", timed("encode", gc.encode_chunks)), \
            mock.patch.object(gc, "rep_grads", timed("loss (K3 / K4)", gc.rep_grads)), \
            mock.patch.object(gc, "backward_chunks", timed("backward", gc.backward_chunks)):
        yield marks


def phase_grad_cache(args, tmp):
    """Phase A: bert-base bf16, fused attention and loss, tied, trained through
    ``Trainer`` with ``grad_cache``: agreement with the full-batch step at 64 x 8, then
    4096 x 8 (K3 / K4 at Q=4096, P=32768) with its passes' device time and its peak
    against the same chunks' at 512 x 8."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con
    from denseretrievaltoolkits_torch.train import grad_cache as gc

    margs = train_model_args(tmp, "gc")
    scale_margs = train_model_args(tmp, "gc-scale", layers=GC_SCALE_LAYERS)
    rng = np.random.default_rng(args.seed + 23)

    def trainer(label, chunks=None, model_args=margs):
        kw = {} if chunks is None else dict(grad_cache=True, gc_q_chunk_size=chunks[0],
                                           gc_p_chunk_size=chunks[1])
        return step_trainer(tmp, label, DRModel.build(model_args, device="cuda",
                                                      seed=args.seed), **kw)

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, con.contrastive_fwd,
               con.contrastive_bwd_dq, con.contrastive_bwd_dp)
    loss_kernels = counted[2:]
    # agreement with the full-batch step, same weights and batch
    small = train_batch(rng, GC_AGREE_QUERIES)
    full = trainer("gc-full")
    f_loss, f_grad = step_grads(full, small)
    del full
    chunked = trainer("gc-agree", GC_AGREE_CHUNKS)
    c_loss, c_grad = step_grads(chunked, small)
    del chunked
    rel, cos, ratio = grad_agreement(c_loss, c_grad, f_loss, f_grad)
    del c_grad, f_grad
    log(f"grad-cache vs full-batch step at {GC_AGREE_QUERIES} x 8 (chunks {GC_AGREE_CHUNKS}): "
        f"step-1 loss {c_loss:.6f} vs {f_loss:.6f} (rel {rel:.3e}, <= {TRAIN_STEP1_REL:g}); "
        f"gradient cosine {cos:.7f} (>= {TRAIN_GRAD_COS:g}), norm ratio {ratio:.7f} (within "
        f"{TRAIN_GRAD_NORM:g} of 1)")
    check(rel <= TRAIN_STEP1_REL, "grad-cache: step-1 loss disagrees with the full-batch step")
    check(cos >= TRAIN_GRAD_COS, "grad-cache: gradients disagree with the full-batch step")
    check(abs(ratio - 1) <= TRAIN_GRAD_NORM,
          "grad-cache: gradient norms disagree with the full-batch step")
    check(cos >= GC_AGREE_COS and abs(ratio - 1) <= GC_AGREE_NORM,
          f"grad-cache: gradient cosine {cos:.7f} or norm ratio {ratio:.7f} outside the "
          f"chunking's bounds ({GC_AGREE_COS:g}, within {GC_AGREE_NORM:g} of 1)")
    torch.cuda.empty_cache()

    gc_trainer = trainer("gc-scale", GC_CHUNKS, scale_margs)

    def peak_step(batch):
        """(loss, max_memory_allocated MiB) of one step from a reset peak"""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(gc_trainer.train_step(batch))
        torch.cuda.synchronize()
        return loss, torch.cuda.max_memory_allocated() / 2 ** 20

    ref_batch = train_batch(rng, GC_PEAK_QUERIES)
    peak_step(ref_batch)  # warm-up at the same chunks
    ref_loss, ref_peak = peak_step(ref_batch)
    del ref_batch
    big = train_batch(rng, GC_SCALE_QUERIES)
    Q, P = big[0]["input_ids"].shape[0], big[1]["input_ids"].shape[0]
    tokens = int(big[0]["attention_mask"].sum()) + int(big[1]["attention_mask"].sum())
    log(f"grad-cache training: bert-base L={GC_SCALE_LAYERS} bf16 fused attention + fused loss, "
        f"tied; {Q} queries x 8 passages (P={P}), chunks of {GC_CHUNKS[0]} queries and "
        f"{GC_CHUNKS[1]} passages; {tokens} real tokens a step")
    # K1 / K2 once a layer for each chunk in passes 1 and 3 (pass 3's backward recomputes in
    # plain PyTorch), K3 / K4 once in pass 2
    want = {fn.__name__: 2 * GC_SCALE_LAYERS * (Q // GC_CHUNKS[0] + P // GC_CHUNKS[1])
            for fn in counted[:2]}
    want.update({fn.__name__: 1 for fn in loss_kernels})
    generic0 = [fn.launches_generic for fn in loss_kernels]
    for fn in counted:
        fn.launches = 0
    with pass_events(gc) as marks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, peak = peak_step(big)
        dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    generic = [fn.launches_generic - g for fn, g in zip(loss_kernels, generic0)]
    k3_body = con.contrastive_fwd.last_body
    del gc_trainer, big
    torch.cuda.empty_cache()
    passes = {}
    loss_shapes = set()
    for name, start, end, shapes in marks:
        passes.setdefault(name, []).append(start.elapsed_time(end))
        if name.startswith("loss"):
            loss_shapes.add(tuple(shapes))
    passes_ms = {k: float(np.sum(v)) for k, v in passes.items()}
    log(f"grad-cache passes at {Q} x 8, device ms of the step (CUDA events): "
        f"{json.dumps({k: round(v, 3) for k, v in passes_ms.items()})}; the loss pass took reps "
        f"{sorted(loss_shapes)}")
    log(f"grad-cache at {Q} x 8: {1 / dt:.4f} steps/s, {tokens / dt:.0f} real tokens/s (1 step "
        f"after the {GC_PEAK_QUERIES} x 8 steps at the same chunks); loss {loss!r}; peak "
        f"{peak:.0f} MiB vs {ref_peak:.0f} MiB at {GC_PEAK_QUERIES} x 8 (ratio "
        f"{peak / ref_peak:.4f}, <= {GC_PEAK_RATIO}); launches {json.dumps(launches)} (want "
        f"{json.dumps(want)}), K3 body {k3_body}, FFMA-body launches (K3, dq, dp) {generic}")
    check(all(math.isfinite(x) for x in (loss, ref_loss)), "grad-cache: a loss is not finite")
    check(launches == want, f"grad-cache: launches at {Q} x {P} {launches}, not {want}")
    check(loss_shapes == {((Q, 768), (P, 768))},
          f"grad-cache: the loss pass took reps {loss_shapes}, not [{Q}, 768] x [{P}, 768]")
    check(k3_body == "wgmma", f"grad-cache: K3 ran its {k3_body} body, not wgmma")
    check(generic == [0, 0, 0], f"grad-cache: the FFMA bodies ran {generic} times")
    check(peak <= GC_PEAK_RATIO * ref_peak,
          f"grad-cache: peak {peak:.0f} MiB at {Q} x 8 exceeds {GC_PEAK_RATIO} x the "
          f"{ref_peak:.0f} MiB of the same chunks at {GC_PEAK_QUERIES} x 8")
    return {"launches": launches, "agree_step1_rel": rel, "agree_grad_cos": cos,
            "agree_grad_norm_ratio": ratio, "loss": loss, "ref_loss": ref_loss,
            "passes_ms": passes_ms, "steps_per_s": 1 / dt, "tokens_per_s": tokens / dt,
            "tokens_per_step": tokens,
            "peak_mib": peak, "ref_peak_mib": ref_peak, "peak_ratio": peak / ref_peak,
            "k3_body": k3_body, "generic_launches": generic}


def phase_remat(args, tmp):
    """Phase B: bert-base bf16 at the training path's shape (32 x 8, S=128) through
    ``DRModel.build`` and ``Trainer`` with remat '', 'full' and 'attn' on 'fused' and on
    'xla': step-1 loss and gradients against the same attention without remat, peak
    memory and steps/s of each. One model lives at a time, and the reference gradients
    wait on the host, so the peaks compare."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con

    batch = train_batch(np.random.default_rng(args.seed + 29), TRAIN_BATCH)
    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, con.contrastive_fwd,
               con.contrastive_bwd_dq, con.contrastive_bwd_dp)
    steps = 3 + REMAT_TIMED_STEPS
    results, ref = {}, {}
    for attention, remat in REMAT_CASES:
        label = f"{attention} remat={remat!r}"
        model = DRModel.build(train_model_args(tmp, "remat", layers=REMAT_LAYERS,
                                               attention=attention, remat=remat),
                              device="cuda", seed=args.seed)
        # a step: K1 / K2 once a layer on each side in the forward ('fused' only), again in
        # the recompute of 'full'; K3 / K4 once
        blocks = 0 if attention != "fused" else 2 * REMAT_LAYERS * (2 if remat == "full" else 1)
        want = {fn.__name__: steps * n for fn, n in zip(counted, (blocks,) * 2 + (1,) * 3)}
        for fn in counted:
            fn.launches = 0
        trainer = step_trainer(tmp, f"remat-{attention}-{remat}", model)
        loss, grad = step_grads(trainer, batch)
        grad = grad.cpu()
        for _ in range(2):  # warm-up
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_TIMED_STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        r = {"loss": loss, "steps_per_s": REMAT_TIMED_STEPS / (time.perf_counter() - t0),
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             "launches": {fn.__name__: fn.launches for fn in counted}}
        del trainer, model
        if not remat:
            ref[attention] = (loss, grad)
        r_loss, r_grad = ref[attention]
        r["loss_rel"], r["grad_cos"], r["grad_norm_ratio"] = grad_agreement(loss, grad, r_loss,
                                                                             r_grad)
        r["grad_max_abs_gap"] = float((grad - r_grad).abs().max())
        del grad
        torch.cuda.empty_cache()
        results[label] = r
        log(f"remat {label}: step-1 loss {loss:.7f} (rel gap {r['loss_rel']:.3e}), largest "
            f"gradient gap {r['grad_max_abs_gap']:.3e}, cosine {r['grad_cos']:.9f} vs no remat; "
            f"peak {r['peak_mib']:.0f} MiB, {r['steps_per_s']:.4f} steps/s; launches in "
            f"{steps} steps {json.dumps(r['launches'])}")
        check(r["loss_rel"] <= REMAT_LOSS_REL, f"remat {label}: step-1 loss differs")
        check(r["grad_cos"] >= REMAT_GRAD_COS, f"remat {label}: gradients differ")
        check(r["launches"] == want, f"remat {label}: launches {r['launches']}, not {want}")
    del ref
    # the kernels line's count: the runs with remat on ('full' and 'attn'), not the references
    launches = {fn.__name__: sum(r["launches"][fn.__name__] for (_, remat), r in
                                 zip(REMAT_CASES, results.values()) if remat)
                for fn in counted}
    log(f"launches on the remat runs ('full' and 'attn'): {json.dumps(launches)}")
    peak = {k: v["peak_mib"] for k, v in results.items()}
    fused, xla = peak["fused remat=''"], peak["xla remat=''"]
    check(peak["fused remat='full'"] < fused, "remat 'full' did not lower the peak on 'fused'")
    check(peak["xla remat='attn'"] < xla, "remat 'attn' did not lower the peak on 'xla'")
    check(abs(peak["fused remat='attn'"] - fused) <= REMAT_FUSED_ATTN_PEAK * fused,
          "remat 'attn' moved the peak on 'fused' by more than 1%")
    return {"launches": launches, "runs": results}


# LoRA (phase 25): bert-base bf16 with rank-8 adapters at the training path's shape (32 x 8,
# S=128, fused loss), 2 warm-up and LORA_TIMED_STEPS timed steps, beside a full fine-tune of
# the same model timed the same way. The step-1 loss and the adapters' gradient take phase 5's
# bounds against the plain loss. For the merge, B is drawn N(0, LORA_MERGE_B) (6 steps at lr
# 1e-5 leave it near 0, where a merge that adds nothing would pass): the merged tower's reps
# (K1 / K2) within LORA_MERGE_COS of the adapted tower's (the xla block), whose own distance
# from the base tower must be LORA_MERGE_MOVED times larger. LORA_PASSAGES passages at S=156
# are encoded; the flash step is phase 22's shape (8 x 8, S=512), held to 'xla' by
# FLASH_STEP_GAP.
LORA_RANK, LORA_TIMED_STEPS, LORA_PASSAGES = 8, 4, 512
LORA_MERGE_B, LORA_MERGE_COS, LORA_MERGE_MOVED = 0.2, 0.999, 10
# Mining (phase 26): bert-base, MINE_PASSAGES synthetic passages at S=156 (phase 11's
# generator), MINE_QUERIES train queries whose positive is the passage they are cut from,
# train_n_passages 8 (k = 7 + 10); serve (K8) against exact (K5): the share of samples whose
# mined lists are equal. serve's recall is >= 0.999 (PERF.md section 2), so a list of 7
# differs only where a near tie swaps at the 7th place: bound MINE_SERVE_AGREE (provisional
# until the first reading). The hook: MINE_HOOK_QUERIES samples, 2 epochs. BM25: its rankings
# held to the Python retriever's by score on BM25_QUERIES queries (atol 1e-4, as
# tests/test_bm25_native.py:33-52).
MINE_PASSAGES, MINE_QUERIES, MINE_N_PASSAGES, MINE_SERVE_AGREE = 32_768, 4096, 8, 0.99
MINE_HOOK_QUERIES, BM25_QUERIES = 64, 256


# T5 and the rerankers (phase 27): t5-base as published in google-t5/t5-base's config.json
# (d_model 768, d_kv 64, d_ff 3072, 12 layers, 12 heads, vocab 32,128, 32 buckets over 128
# positions, relu, tied), seeded random weights. (a) The T5 dual encoder (encoder_only, mean
# pooling, bf16, fused loss) trains at the training path's shape (32 x 8, q 32 / p 128), 2
# warm-up and T5_TIMED_STEPS timed steps; its step 1 takes phase 5's bounds against the plain
# loss. (b) It encodes args.passages passages (S=156, phase 11's generator) and args.queries
# queries into a float32 FlatIPIndex (INDEX_BLOCK rows a block): exact (K5) held to its plain
# version over the same reps by phase 3's top-100 overlap bound, serve (K8) to exact by
# T5_SERVE_RECALL; its bf16 reps to the fp32 reps of the same weights by T5_REPS_COS, on
# T5_COS_BATCHES batches. (c) The BERT-base cross-encoder (mr) and the T5-base token scorer
# (t5_full, ce; the stub tokenizer's RR_TOKENS are t5's ids of "true" / "false") train through
# RRTrainer on RR_QUERIES queries x (1 + RR_NEGATIVES) pairs of RR_LEN tokens, 2 warm-up and
# RR_TIMED_STEPS timed steps, and evaluate (b)'s exact top-k for RR_EVAL_QUERIES queries. The
# fp32 scores of RR_CPU_PAIRS pairs on the card against the same weights on the CPU: within
# RR_CPU_REL of the largest |score| (fp32 sums in another order, and no TF32: set in main).
T5_BASE = dict(vocab_size=32128, d_model=768, d_kv=64, d_ff=3072, num_layers=12, num_heads=12,
               relative_attention_num_buckets=32, relative_attention_max_distance=128,
               is_gated_act=False, tie_word_embeddings=True)
T5_TIMED_STEPS, T5_SERVE_RECALL, T5_REPS_COS, T5_COS_BATCHES = 4, 0.999, 0.999, 16
RR_QUERIES, RR_NEGATIVES, RR_LEN, RR_TIMED_STEPS = 8, 7, 160, 4
RR_EVAL_QUERIES, RR_EVAL_BATCH, RR_CPU_PAIRS, RR_CPU_REL = 64, 64, 64, 1e-3
RR_TOKENS = {"true": 1176, "false": 6136}


class StubTokenizer:
    """``prepare_for_model`` as a BERT tokenizer does it on token ids: [CLS] ids [SEP], and
    for a pair [CLS] a [SEP] b [SEP] with the first truncated (``only_first``), to
    max_length; ``encode`` of the reranker's two label words (the card's machine has no
    ``transformers``)."""

    pad_token_id = 0
    vocab_size = 30522

    def prepare_for_model(self, ids, pair_ids=None, truncation=None, max_length=None,
                          padding=False, return_attention_mask=False,
                          return_token_type_ids=False):
        if pair_ids is None:
            return {"input_ids": [101] + list(ids)[:max(0, max_length - 2)] + [102]}
        b = list(pair_ids)[:max_length - 3]
        return {"input_ids": [101] + list(ids)[:max(0, max_length - 3 - len(b))] + [102] + b
                + [102]}

    def encode(self, text, add_special_tokens=True):
        return [RR_TOKENS[text]]


def cosines(a, b):
    """Row cosines of two [n, D] tensors, in fp64."""
    a, b = a.double(), b.double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def phase_lora(args, tmp):
    """Phase 25: LoRA training, the merged tower served, HF export and reload, a flash step."""
    from denseretrievaltoolkits_torch.config import ModelArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.models import lora
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, flash

    rng = np.random.default_rng(args.seed + 25)
    batches = [train_batch(rng, TRAIN_BATCH) for _ in range(2 + LORA_TIMED_STEPS)]
    lora_args = dict(param_efficient_method="lora", lora_rank=LORA_RANK)
    log(f"LoRA: bert-base L={TRAIN_LAYERS} bf16 fused attention + fused loss, tied, rank "
        f"{LORA_RANK} on q and v; {TRAIN_BATCH} x 8 passages, S=128, adamw lr {TRAIN_LR:g}; "
        f"{len(batches)} steps (2 warm-up)")

    def build(label, **kw):
        return DRModel.build(train_model_args(tmp, label, **kw), device="cuda", seed=args.seed)

    def adapter_grads(model, batch):
        """(step-1 loss, the adapters' gradient, flat fp32) of one forward + backward."""
        loss = model(*batch)["loss"]
        loss.backward()
        grad = torch.cat([p.grad.flatten().float() for n, p in model.named_parameters()
                          if "lora_" in n])
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grad

    # step 1 against the plain loss, same weights and batch
    model = build("lora-step1", **lora_args)
    lora.lora_trainable(model)
    k_loss, k_grad = adapter_grads(model, batches[0])
    with plain_encoder():
        p_loss, p_grad = adapter_grads(model, batches[0])
    del model
    rel, cos, ratio = grad_agreement(k_loss, k_grad, p_loss, p_grad)
    del k_grad, p_grad
    log(f"LoRA step 1, fused loss vs plain: loss {k_loss:.6f} vs {p_loss:.6f} (rel {rel:.3e}, "
        f"<= {TRAIN_STEP1_REL:g}); adapters' gradient cosine {cos:.7f} (>= {TRAIN_GRAD_COS:g}), "
        f"norm ratio {ratio:.7f} (within {TRAIN_GRAD_NORM:g} of 1)")
    check(rel <= TRAIN_STEP1_REL, "LoRA: step-1 loss disagrees with the plain loss")
    check(cos >= TRAIN_GRAD_COS and abs(ratio - 1) <= TRAIN_GRAD_NORM,
          "LoRA: the adapters' step-1 gradient disagrees with the plain loss's")

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, con.contrastive_fwd,
               con.contrastive_bwd_dq, con.contrastive_bwd_dp)

    def run(label, **kw):
        """Train ``batches`` on a fresh model: (trainer, losses, steps/s, peak MiB of the
        timed steps, launches over all steps)."""
        trainer = step_trainer(tmp, label, build(label, **kw))
        for fn in counted:
            fn.launches = 0
        losses = [trainer.train_step(b) for b in batches[:2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += [trainer.train_step(b) for b in batches[2:]]
        torch.cuda.synchronize()
        rate = LORA_TIMED_STEPS / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        return (trainer, [float(x) for x in losses], rate, peak,
                {fn.__name__: fn.launches for fn in counted})

    full, _, full_rate, full_peak, _ = run("lora-full")
    del full
    torch.cuda.empty_cache()
    model = build("lora-train", **lora_args)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not lora.is_trainable(n)}
    adapters = {n: p.detach().clone() for n, p in model.named_parameters() if "lora_" in n}
    del model
    trainer, losses, rate, peak, launches = run("lora-train", **lora_args)
    model = trainer.model
    steps = len(batches)
    want = {"fused_attention_ln": 0, "fused_mlp_ln": 0, "contrastive_fwd": steps,
            "contrastive_bwd_dq": steps, "contrastive_bwd_dp": steps}
    params = dict(model.named_parameters())
    changed = [n for n, v in frozen.items() if not torch.equal(params[n], v)]
    still = [n for n, v in adapters.items() if torch.equal(params[n], v)]
    n_train = sum(p.numel() for n, p in params.items() if lora.is_trainable(n))
    del frozen, adapters
    log(f"LoRA training: losses {json.dumps([round(x, 5) for x in losses])}; {rate:.4f} steps/s "
        f"(full fine-tune {full_rate:.4f}), peak {peak:.0f} MiB (full fine-tune {full_peak:.0f}); "
        f"{n_train} trainable of {sum(p.numel() for p in params.values())} parameters; "
        f"launches in {steps} steps {json.dumps(launches)} (want {json.dumps(want)}); frozen "
        f"tensors changed: {len(changed)}, adapters unmoved: {len(still)}")
    check(all(math.isfinite(x) for x in losses), "LoRA: a training loss is not finite")
    check(launches == want, f"LoRA: launches {launches}, not {want}")
    check(not changed, f"LoRA: frozen tensors moved: {changed[:5]}")
    check(not still, f"LoRA: adapters that never moved: {still[:5]}")

    # the merged tower on K1 / K2 against the adapted one on the xla block
    p_rows = make_train_rows(np.random.default_rng(args.seed + 251), LORA_PASSAGES, 1, 156, 32)
    passages = [pad_batch([ps[0] for _, ps in p_rows[i:i + 64]], 156, 0)
                for i in range(0, LORA_PASSAGES, 64)]

    def encode():
        return torch.cat([model.encode_passage(b) for b in passages])

    b_rng = torch.Generator(device=model.device).manual_seed(args.seed + 252)
    b_params = [p for n, p in params.items() if n.endswith(("lora_q_B", "lora_v_B"))]
    with torch.no_grad():
        for p in b_params:
            p.zero_()
        base = encode()
        for p in b_params:
            p.copy_(torch.randn(p.shape, generator=b_rng, device=p.device) * LORA_MERGE_B)
    adapted = encode()
    lora.merge_lora(model.lm_q)
    for fn in counted[:2]:
        fn.launches = 0
    merged = encode()
    merged_launches = {fn.__name__: fn.launches for fn in counted[:2]}
    merge_cos = float(cosines(merged, adapted).min())
    moved_cos = float(cosines(adapted, base).min())
    log(f"LoRA merged (B ~ N(0, {LORA_MERGE_B})), {LORA_PASSAGES} passages at S=156: reps cosine "
        f"merged (K1 / K2) vs adapted (xla block) min {merge_cos:.7f} (>= {LORA_MERGE_COS}); "
        f"adapted vs base min {moved_cos:.7f}; K1 / K2 launches {json.dumps(merged_launches)}")
    check(merge_cos >= LORA_MERGE_COS, "LoRA: the merged tower encodes unlike the adapted one")
    check(1 - moved_cos >= LORA_MERGE_MOVED * (1 - merge_cos),
          "LoRA: the adapters barely move the reps; the merge check sees nothing")
    check(all(n > 0 for n in merged_launches.values()),
          "LoRA: the merged tower did not run K1 / K2")

    # export_hf, then DRModel.build from that directory, with no transformers / safetensors
    hf_dir = os.path.join(tmp, "lora-hf")
    model.export_hf(hf_dir)
    reloaded = DRModel.build(ModelArguments(model_name_or_path=hf_dir, dtype="bfloat16",
                                            attention="fused", fused_loss=True, pooling="first"),
                             device="cuda")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers", "safetensors"))
    hf_gap = float((torch.cat([reloaded.encode_passage(b) for b in passages]) - merged)
                   .abs().max())
    scale = float(merged.abs().max())
    del reloaded
    log(f"export_hf -> DRModel.build from it: reps max-abs gap {hf_gap:.3e} (max |rep| "
        f"{scale:.3f}); modules of transformers / safetensors loaded: {loaded}")
    check(not loaded, f"the HF path loaded {loaded}")
    check(hf_gap <= 2 ** -23 * scale, "the HF export reloads to other reps")
    del trainer, model, params, b_params, base, adapted, merged
    torch.cuda.empty_cache()

    # one LoRA step at S=512 on 'flash', against the same step on 'xla'
    rows = make_train_rows(np.random.default_rng(args.seed + 253), FLASH_TRAIN_BATCH, 8, 512,
                           32, median=FLASH_MEDIAN_LEN, sigma=FLASH_LEN_SIGMA, min_len=16)
    fbatch = (pad_batch([q for q, _ in rows], 32, 0),
              pad_batch([p for _, ps in rows for p in ps], 512, 0))
    fcounted = (flash.flash_fwd, flash.flash_bwd_dkv, flash.flash_bwd_dq)
    flash_losses, flash_launches = {}, {}
    for attention in ("flash", "xla"):
        for fn in fcounted:
            fn.launches = 0
        t = step_trainer(tmp, f"lora-{attention}",
                         build(f"lora-{attention}", attention=attention, **lora_args))
        flash_losses[attention] = float(t.train_step(fbatch))
        flash_launches[attention] = {fn.__name__: fn.launches for fn in fcounted}
        del t
        torch.cuda.empty_cache()
    gap = abs(flash_losses["flash"] - flash_losses["xla"])
    log(f"LoRA step at {FLASH_TRAIN_BATCH} x 8, S=512: loss flash {flash_losses['flash']:.6f} vs "
        f"xla {flash_losses['xla']:.6f} (gap {gap:.4e}, <= {FLASH_STEP_GAP}); flash launches "
        f"{json.dumps(flash_launches)}")
    check(all(n > 0 for n in flash_launches["flash"].values()),
          "LoRA: the flash step did not launch the flash kernels")
    check(not any(flash_launches["xla"].values()), "LoRA: the xla step launched flash kernels")
    check(gap <= FLASH_STEP_GAP, "LoRA: the flash step's loss disagrees with xla's")
    return {"step1_rel": rel, "grad_cos": cos, "grad_norm_ratio": ratio, "losses": losses,
            "steps_per_s": rate, "peak_mib": peak, "full_steps_per_s": full_rate,
            "full_peak_mib": full_peak, "trainable": n_train, "launches": launches,
            "merge_cos": merge_cos, "moved_cos": moved_cos, "merged_launches": merged_launches,
            "hf_gap": hf_gap, "flash_losses": flash_losses,
            "flash_launches": flash_launches["flash"]}


def phase_mining(args, tmp):
    """Phase 26: DenseMiner over a 32,768-passage index (serve on K8, exact on K5), the
    Trainer's mine_per_train hook, and BM25Negatives on the native engine."""
    from denseretrievaltoolkits_torch.config import DataArguments, TrainingArguments
    from denseretrievaltoolkits_torch.data.collators import QPCollator, pad_batch
    from denseretrievaltoolkits_torch.data.loaders import DataLoader
    from denseretrievaltoolkits_torch.data.samplers import BM25Negatives, RandomSampleNegatives
    from denseretrievaltoolkits_torch.evaluator import bm25, bm25_native
    from denseretrievaltoolkits_torch.mine.miner import DenseMiner
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import attn, topk
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    rng = np.random.default_rng(args.seed + 26)
    corpus, queries = synthetic_qa(rng, MINE_PASSAGES, MINE_QUERIES, 156, 32)
    for row in corpus:
        row["text"] = row["tokens"][1:-1]
    n_neg = MINE_N_PASSAGES - 1
    # query j is cut from passage j (its positive); its first negatives are random passages
    # past the queries' own, so a positive's text lies only in its own sample (BM25 excludes
    # a sample's own positives by their place in the pool, not by text)
    samples = [{"query": q["tokens"][1:-1], "positives": [corpus[j]["text"]],
                "negatives": [corpus[int(i)]["text"]
                              for i in rng.integers(MINE_QUERIES, MINE_PASSAGES, n_neg)]}
               for j, q in enumerate(queries)]
    tok = StubTokenizer()
    dargs = DataArguments(train_n_passages=MINE_N_PASSAGES, q_max_len=32, p_max_len=128,
                          data_cache_dir=os.path.join(tmp, "mine-cache"))
    model = DRModel.build(train_model_args(tmp, "mine"), device="cuda", seed=args.seed)
    corpus_loader = DataLoader(corpus, args.batch, lambda b: (
        [r["id"] for r in b], pad_batch([r["tokens"] for r in b], 156, 0)))
    train_loader = DataLoader(samples[:MINE_HOOK_QUERIES], TRAIN_BATCH, QPCollator(
        dargs, RandomSampleNegatives(dargs, seed=args.seed), tok), shuffle=True, seed=args.seed)
    targs = TrainingArguments(
        output_dir=os.path.join(tmp, "mine", "out"), cache_train_dir=os.path.join(
            tmp, "mine", "cache"), train_batch_size=TRAIN_BATCH, max_epochs=2,
        learning_rate=TRAIN_LR, optimizer="adamw", log_every=1, save_per_train=10,
        mine_per_train=1, save_corpus_artifacts=False)
    trainer = Trainer(targs, model, corpus_dataloader=corpus_loader, train_loader=train_loader)
    log(f"mining: bert-base L={TRAIN_LAYERS} bf16 fused, {MINE_PASSAGES} passages (S=156) into "
        f"a {targs.index_dtype} FlatIPIndex, {MINE_QUERIES} train queries (S=32), "
        f"train_n_passages {MINE_N_PASSAGES}")
    counted = {"fused_attention_ln": attn.fused_attention_ln,
               "fused_mlp_ln": attn.fused_mlp_ln, "block_topj (K5)": topk.block_topj,
               "block_topj_serve (K8)": topk.block_topj_serve}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._encoding_corpus(0)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    mined, seconds, launches = {}, {}, {}
    # serve, exact (counted), then exact, serve again (timed: the first call of a mode also
    # pays its first-use costs)
    for i, mode in enumerate(("serve", "exact", "exact", "serve")):
        for fn in counted.values():
            fn.launches = 0
        miner = DenseMiner(trainer, tok, dargs, search_mode=None if mode == "serve" else mode)
        t0 = time.perf_counter()
        rows = miner.mine(samples)
        seconds[mode] = time.perf_counter() - t0
        if i < 2:
            mined[mode] = rows
            launches[mode] = {k: fn.launches for k, fn in counted.items()}
        else:
            check(rows == mined[mode], f"mining: a second {mode} mine differs from the first")
    same = float(np.mean([a["negatives"] == b["negatives"]
                          for a, b in zip(mined["serve"], mined["exact"])]))
    refreshed = {m: sum(r["negatives"] is not s["negatives"] for r, s in zip(rows, samples))
                 for m, rows in mined.items()}
    own = sum(tuple(n) in {tuple(p) for p in s["positives"]}
              for rows in mined.values() for r, s in zip(rows, samples) for n in r["negatives"])
    qps = {m: MINE_QUERIES / s for m, s in seconds.items()}
    log(f"corpus encode {encode_s:.2f} s; DenseMiner over {MINE_QUERIES} queries (k = "
        f"{n_neg} + 10), each mode's second run: serve {seconds['serve']:.3f} s "
        f"({qps['serve']:.0f} queries/s), exact {seconds['exact']:.3f} s ({qps['exact']:.0f} queries/s); refreshed "
        f"{json.dumps(refreshed)}; mined lists equal serve vs exact: {same:.5f} (>= "
        f"{MINE_SERVE_AGREE}); own positives mined: {own}; launches {json.dumps(launches)}")
    check(same >= MINE_SERVE_AGREE, "mining: serve's mined lists disagree with exact's")
    check(own == 0, "mining: a sample's own positive was mined as its negative")
    check(all(n == MINE_QUERIES for n in refreshed.values()), "mining: samples not refreshed")
    check(launches["serve"]["block_topj_serve (K8)"] > 0
          and launches["serve"]["block_topj (K5)"] == 0, "mining: serve did not run on K8")
    check(launches["exact"]["block_topj (K5)"] > 0
          and launches["exact"]["block_topj_serve (K8)"] == 0, "mining: exact did not run on K5")
    check(all(launches[m][k] > 0 for m in launches for k in ("fused_attention_ln",
                                                               "fused_mlp_ln")),
          "mining: the query encode did not run K1 / K2")

    # the hook: two epochs, each ending in a mine from a fresh encode of the corpus
    miner = DenseMiner(trainer, tok, dargs)
    outputs, seen = [], {}
    mine = miner.mine
    miner.mine = lambda rows: outputs.append(mine(rows)) or outputs[-1]
    collate = train_loader.collate_fn

    def recording(rows):
        seen.setdefault(train_loader.epoch, []).extend(id(r) for r in rows)
        return collate(rows)

    train_loader.collate_fn = recording
    trainer.miner = miner
    trainer.train()
    with open(os.path.join(targs.output_dir, "train_log.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    epoch_losses = [[r["loss"] for r in recs if r.get("epoch") == e and "loss" in r]
                    for e in (1, 2)]
    mined_ids = {id(r) for r in outputs[0]} if outputs else set()
    on_mined = bool(seen.get(1)) and all(i in mined_ids for i in seen[1])
    log(f"mine_per_train=1 over 2 epochs of {MINE_HOOK_QUERIES} samples: mined {len(outputs)} "
        f"times, index of epoch {trainer._indexed_ep}; epoch 2 trained on the mined rows: "
        f"{on_mined}; losses {json.dumps(epoch_losses)}")
    check(len(outputs) == 2 and trainer.train_loader.dataset is outputs[-1],
          "mining: the hook did not replace the train set each epoch")
    check(on_mined, "mining: epoch 2 did not train on the mined rows")
    check(bool(epoch_losses[1]) and all(math.isfinite(x) for x in epoch_losses[1]),
          "mining: an epoch-2 loss is not finite")
    del trainer, model, miner
    torch.cuda.empty_cache()

    # BM25 negatives over the train pool on the native engine, built here
    t0 = time.perf_counter()
    lib = bm25_native.build()
    build_s = time.perf_counter() - t0
    sampler = BM25Negatives(dargs, tok.vocab_size, seed=args.seed)
    t0 = time.perf_counter()
    bm25_rows = sampler.load_passages(samples)
    bm25_s = time.perf_counter() - t0
    nat = sampler.retriever
    py = bm25.BM25Retriever(n_neg, tok.vocab_size, seed=args.seed)
    py.load_passages(samples)
    worst = 0.0
    for s in samples[:BM25_QUERIES]:
        q = s["query"]

        def score(ids):
            return sorted((sum(py._score_term(w, d) for w in q
                               if d in py.doc_contained_word.get(w, ())) for d in ids),
                          reverse=True)

        worst = max(worst, float(np.abs(np.subtract(score(nat.search(q, 10)),
                                                    score(py.search(q, 10)))).max()))
    own = sum(tuple(n) in {tuple(p) for p in s["positives"]}
              for r, s in zip(bm25_rows, samples) for n in r["negatives"])
    log(f"BM25Negatives (native, {os.path.relpath(lib, ROOT)} built in {build_s:.2f} s) over "
        f"{len(nat.passage)} passages of {MINE_QUERIES} samples: {bm25_s:.3f} s; rankings vs the "
        f"Python retriever on {BM25_QUERIES} queries: largest score gap {worst:.3e} (<= 1e-4); "
        f"own positives mined {own}")
    check(type(nat).__name__ == "NativeBM25Retriever", "BM25: not the native engine")
    check(os.path.dirname(lib) == bm25_native.BUILD_DIR and os.path.exists(lib),
          "BM25: the engine was not built into _build/")
    check(worst <= 1e-4, "BM25: native rankings disagree with the Python retriever's")
    check(own == 0 and all(len(r["negatives"]) == n_neg for r in bm25_rows),
          "BM25: a mined list is short or holds its own positive")
    return {"encode_s": encode_s, "mine_s": seconds, "queries_per_s": qps,
            "serve_exact_same": same, "launches": launches, "hook_epoch_losses": epoch_losses,
            "bm25_s": bm25_s, "bm25_build_s": build_s, "bm25_score_gap": worst}


def phase_rerank(args, tmp):
    """Phase 27: a T5-base dual encoder trained (K3 / K4) and served (K5 / K8), then the
    BERT-base and T5-base rerankers trained and evaluated by RRTrainer over its top-k."""
    from denseretrievaltoolkits_torch.config import (DataArguments, ModelArguments,
                                                     RRTrainingArguments)
    from denseretrievaltoolkits_torch.data.collators import create_pair_example, pad_batch
    from denseretrievaltoolkits_torch.data.loaders import RerankerDataloader
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
    from denseretrievaltoolkits_torch.models import t5
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModel, DRModelForInference
    from denseretrievaltoolkits_torch.models.reranker import RRModel
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, topk
    from denseretrievaltoolkits_torch.run_encode import encode_batches
    from denseretrievaltoolkits_torch.train.trainer import RRTrainer

    counted = {"fused_attention_ln": attn.fused_attention_ln, "fused_mlp_ln": attn.fused_mlp_ln,
               "contrastive_fwd": con.contrastive_fwd, "contrastive_bwd_dq": con.contrastive_bwd_dq,
               "contrastive_bwd_dp": con.contrastive_bwd_dp, "block_topj (K5)": topk.block_topj,
               "block_topj_serve (K8)": topk.block_topj_serve}

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counted.items()}

    cfg = t5.T5Config(**T5_BASE)
    arch = os.path.join(tmp, "t5-base")
    t5.save_config(cfg, arch)
    rng = np.random.default_rng(args.seed + 27)
    batches = [train_batch(rng, TRAIN_BATCH) for _ in range(2 + T5_TIMED_STEPS)]
    margs = ModelArguments(model_name_or_path=arch, encoder_only=True, pooling="mean",
                           dtype="bfloat16", fused_loss=True)
    log(f"T5: t5-base (d_model {cfg.d_model}, {cfg.num_layers} layers, {cfg.num_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.relative_attention_num_buckets} buckets / "
        f"{cfg.relative_attention_max_distance}, relu, tied) dual encoder, bf16, mean pooling, "
        f"fused loss; {TRAIN_BATCH} x 8 passages, q 32 / p 128, adamw lr {TRAIN_LR:g}; "
        f"{len(batches)} steps (2 warm-up)")

    # (a) step 1 against the plain loss on the same weights, then training through Trainer
    t_part = time.perf_counter()
    model = DRModel.build(margs, device="cuda", seed=args.seed)
    check(model.spec.backbone == "t5" and isinstance(model.lm_q, t5.T5Model),
          "T5: DRModel.build did not build a T5 encoder tower")

    def grads(batch):
        loss = model(*batch)["loss"]
        loss.backward()
        g = torch.cat([p.grad.flatten().float() for p in model.parameters() if p.grad is not None])
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    k_loss, k_grad = grads(batches[0])
    with plain_encoder():
        p_loss, p_grad = grads(batches[0])
    rel, cos, ratio = grad_agreement(k_loss, k_grad, p_loss, p_grad)
    del k_grad, p_grad
    log(f"T5 step 1, fused loss vs plain: loss {k_loss:.6f} vs {p_loss:.6f} (rel {rel:.3e}, <= "
        f"{TRAIN_STEP1_REL:g}); gradient cosine {cos:.7f} (>= {TRAIN_GRAD_COS:g}), norm ratio "
        f"{ratio:.7f} (within {TRAIN_GRAD_NORM:g} of 1)")
    check(rel <= TRAIN_STEP1_REL, "T5: step-1 loss disagrees with the plain loss")
    check(cos >= TRAIN_GRAD_COS and abs(ratio - 1) <= TRAIN_GRAD_NORM,
          "T5: the step-1 gradient disagrees with the plain loss's")
    trainer = step_trainer(tmp, "t5-train", model)
    zero()
    losses = [trainer.train_step(b) for b in batches[:2]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [trainer.train_step(b) for b in batches[2:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    train_launches = read()
    losses = [float(x) for x in losses]
    tokens = sum(int(q["attention_mask"].sum()) + int(p["attention_mask"].sum())
                 for q, p in batches[2:])
    t5_train = {"step1_rel": rel, "grad_cos": cos, "grad_norm_ratio": ratio, "losses": losses,
                "steps_per_s": T5_TIMED_STEPS / elapsed, "tokens_per_s": tokens / elapsed,
                "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "launches": train_launches}
    steps = len(batches)
    want = {k: 0 for k in counted}
    want.update(contrastive_fwd=steps, contrastive_bwd_dq=steps, contrastive_bwd_dp=steps)
    log(f"T5 training: losses {json.dumps([round(x, 5) for x in losses])}; "
        f"{t5_train['steps_per_s']:.4f} steps/s, {t5_train['tokens_per_s']:.0f} real tokens/s, "
        f"peak {t5_train['peak_mib']:.0f} MiB; launches in {steps} steps "
        f"{json.dumps(train_launches)} (want {json.dumps(want)})")
    check(all(math.isfinite(x) for x in losses), "T5: a training loss is not finite")
    check(train_launches == want, f"T5: launches {train_launches}, not {want}")
    served_dir = os.path.join(tmp, "t5-served")
    model.save(served_dir)
    del trainer, model
    torch.cuda.empty_cache()
    t5_train["seconds"] = time.perf_counter() - t_part
    log(f"T5 part (a): {t5_train['seconds']:.1f} s with the build, the step-1 check and the save")
    t_part = time.perf_counter()

    # (b) serve it: the deploy format rebuilt, encode, a float32 index, exact and serve
    corpus, queries = synthetic_qa(np.random.default_rng(args.seed + 271), args.passages,
                                   args.queries, 156, 32)

    def side(rows, width):
        return [([r.get("id", r.get("query_id")) for r in rows[s:s + args.batch]],
                 pad_batch([r["tokens"] for r in rows[s:s + args.batch]], width, 0))
                for s in range(0, len(rows), args.batch)]

    p_batches, q_batches = side(corpus, 156), side(queries, 32)
    served = DRModelForInference.build(ModelArguments(model_name_or_path=served_dir,
                                                      dtype="bfloat16"), device="cuda")
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_reps, p_lookup = encode_batches(served, p_batches, "passage", args.batch)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    q_reps, q_lookup = encode_batches(served, q_batches, "query", args.batch)
    encode_launches = read()
    del served
    check(p_reps.shape == (args.passages, cfg.d_model) and np.isfinite(p_reps).all()
          and np.isfinite(q_reps).all(), "T5: passage / query reps of the wrong shape or "
                                         "not finite")
    host = t5.bucket_table(156, 156, cfg)
    card = t5.bucket_table(156, 156, cfg, device="cuda")
    rel_pos = torch.arange(156)[None, :] - torch.arange(156)[:, None]
    on_card = t5.relative_position_bucket(rel_pos.cuda(), True, cfg.relative_attention_num_buckets,
                                          cfg.relative_attention_max_distance).cpu()
    formula_diff = int((on_card != host).sum())
    served32 = DRModelForInference.build(ModelArguments(model_name_or_path=served_dir,
                                                        dtype="float32"), device="cuda")
    p32, _ = encode_batches(served32, p_batches[:T5_COS_BATCHES], "passage", args.batch)
    del served32
    torch.cuda.empty_cache()
    reps_cos = float(cosines(torch.from_numpy(p_reps[:len(p32)]), torch.from_numpy(p32)).min())
    log(f"T5 serving: {args.passages} passages (S=156) at {args.passages / encode_s:.1f} "
        f"passages/s, {args.queries} queries (S=32); launches {json.dumps(encode_launches)}; "
        f"bf16 vs fp32 reps cosine min {reps_cos:.7f} over {len(p32)} passages (>= "
        f"{T5_REPS_COS}); bucket table on the card equal to the host's: "
        f"{torch.equal(card.cpu(), host)}; the fp32 formula run on the card differs from it at "
        f"{formula_diff} of {host.numel()} (query, key) pairs")
    check(torch.equal(card.cpu(), host), "T5: the card's bucket table differs from the host's")
    check(reps_cos >= T5_REPS_COS, "T5: bf16 reps disagree with the fp32 reps")
    check(not any(encode_launches.values()), "T5: the encode launched a BERT or loss kernel")
    index = FlatIPIndex(p_reps.shape[1], dtype="float32", block_size=INDEX_BLOCK, device="cuda")
    index.add(p_reps)
    index.search(q_reps[:1], args.k)  # uploads the corpus; not part of the search time
    ids, qps, search_launches = {}, {}, {}
    for mode in ("exact", "serve"):
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids[mode] = index.batch_search(q_reps, args.k, args.queries, mode=mode)
        qps[mode] = args.queries / (time.perf_counter() - t0)
        search_launches[mode] = read()
    with mock.patch.object(topk, "block_topj", topk._block_topj_reference):
        _, plain_ids = index.batch_search(q_reps, args.k, args.queries, mode="exact")
    plain_overlap = overlap(ids["exact"], plain_ids)
    serve_recall = overlap(ids["serve"], ids["exact"])
    hits = np.array([[p_lookup[i] == f"d{q}" for i in row] for q, row in enumerate(ids["exact"])])
    log(f"T5 search (k={args.k}, {INDEX_BLOCK}-row blocks): exact {qps['exact']:.1f} / serve "
        f"{qps['serve']:.1f} queries/s; exact vs its plain version over the same reps top-"
        f"{args.k} overlap {plain_overlap:.5f} (>= 0.99); serve recall vs exact "
        f"{serve_recall:.5f} (>= {T5_SERVE_RECALL}); own passage in the top {args.k} for "
        f"{hits.any(1).mean():.4f} of queries; launches {json.dumps(search_launches)}")
    check(plain_overlap >= 0.99, "T5: the exact search disagrees with its plain version")
    check(serve_recall >= T5_SERVE_RECALL, "T5: serve's recall against exact is too low")
    check(search_launches["exact"]["block_topj (K5)"] > 0
          and search_launches["exact"]["block_topj_serve (K8)"] == 0,
          "T5: the exact search did not run on K5")
    check(search_launches["serve"]["block_topj_serve (K8)"] > 0
          and search_launches["serve"]["block_topj (K5)"] == 0,
          "T5: the serve search did not run on K8")
    t5_serve = {"passages_per_s": args.passages / encode_s, "queries_per_s": qps,
                "reps_cos_fp32": reps_cos, "plain_overlap": plain_overlap,
                "serve_recall": serve_recall, "launches": search_launches,
                "encode_launches": encode_launches, "card_formula_bucket_diff": formula_diff,
                "seconds": time.perf_counter() - t_part}
    del index
    log(f"T5 part (b): {t5_serve['seconds']:.1f} s")

    # (c) the rerankers: trained by RRTrainer, then over (b)'s exact top-k
    tok = StubTokenizer()
    bert_arch = os.path.join(tmp, "rr-bert-base")
    save_config(BertConfig(num_hidden_layers=TRAIN_LAYERS), bert_arch)

    def pair(q_ids, p_ids):
        return create_pair_example(q_ids, p_ids, tok, RR_LEN)

    prng = np.random.default_rng(args.seed + 272)
    rr_batches = []
    for i in range(2 + RR_TIMED_STEPS):
        qs = range(i * RR_QUERIES, (i + 1) * RR_QUERIES)
        pos = [pair(queries[j]["tokens"][1:-1], corpus[j]["tokens"][1:-1]) for j in qs]
        neg = [pair(queries[j]["tokens"][1:-1], corpus[int(n)]["tokens"][1:-1]) for j in qs
               for n in prng.integers(args.queries, args.passages, RR_NEGATIVES)]
        rr_batches.append((pad_batch(pos, RR_LEN, 0), pad_batch(neg, RR_LEN, 0)))
    rows = [{"query_id": queries[j]["query_id"], "query": queries[j]["tokens"][1:-1],
             "doc_id": p_lookup[i], "document": corpus[i]["tokens"][1:-1],
             "original": corpus[i]["original"], "answers": queries[j]["answers"]}
            for j in range(RR_EVAL_QUERIES) for i in ids["exact"][j]]

    class Pairs:  # RRDataset's rows without ``datasets``: the handoff's preprocessed pairs
        def load_dataset(self):
            return rows

    dargs = DataArguments(q_max_len=32, p_max_len=RR_LEN - 32)
    # the card-vs-CPU pairs in batches of 32 by length, each padded to its longest: the
    # CPU's fp32 forward is the slow side
    cpu_pairs = sorted((pair(r["query"], r["document"]) for r in rows[:RR_CPU_PAIRS]), key=len)
    cpu_batches = [pad_batch(chunk, len(chunk[-1]), 0)
                   for chunk in (cpu_pairs[s:s + 32] for s in range(0, len(cpu_pairs), 32))]
    rerank = {}
    for label, path, extra, loss_fn in (
            ("bert", bert_arch, dict(pooling="first"), "mr"),
            ("t5_full", arch, dict(encoder_only=False, pos_token="true", neg_token="false"),
             "ce")):
        t_part = time.perf_counter()
        root = os.path.join(tmp, f"rr-{label}")
        rargs = RRTrainingArguments(
            output_dir=os.path.join(root, "out"), cache_train_dir=os.path.join(root, "cache"),
            learning_rate=TRAIN_LR, optimizer="adamw", loss_fn=loss_fn, topk="1,10,100",
            log_every=0, eval_batch_size=RR_EVAL_BATCH)
        model = RRModel.build(ModelArguments(model_name_or_path=path, dtype="bfloat16", **extra),
                              train_args=rargs, tokenizer=tok, device="cuda", seed=args.seed)
        check(model.spec.backbone == label, f"rerank: built {model.spec.backbone}, not {label}")
        trainer = RRTrainer(rargs, model)
        zero()
        losses = [trainer.train_step(b) for b in rr_batches[:2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += [trainer.train_step(b) for b in rr_batches[2:]]
        torch.cuda.synchronize()
        rate = RR_TIMED_STEPS / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = [float(x) for x in losses]
        loader = RerankerDataloader(dargs, Pairs(), tok, batch_size=RR_EVAL_BATCH
                                    ).get_eval_dataloader()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.evaluate(loader, 3)
        eval_s = time.perf_counter() - t0
        launches = read()
        host_s = None
        if label == "bert":  # the same evaluation with every score 0: its host side alone
            zeros = lambda b: torch.zeros(len(b["input_ids"]), 1)  # noqa: E731
            with mock.patch.object(trainer.model, "score", zeros):
                t0 = time.perf_counter()
                trainer.evaluate(loader, 4)
                host_s = time.perf_counter() - t0
        with open(os.path.join(rargs.rr_result_dir, "3.0.json")) as fh:
            dumped = [json.loads(line) for line in fh]
        metrics_path = os.path.join(rargs.cache_train_dir, "3.0_RR_metrics")
        with open(metrics_path) as fh:
            saved = json.load(fh)
        # fp32 scores of the same weights (the trained fp32 masters), card against CPU
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        spec32 = dataclasses.replace(model.spec, dtype="float32")
        del trainer, model
        torch.cuda.empty_cache()
        scores, t0 = {}, time.perf_counter()
        for device in ("cuda", "cpu"):
            m = RRModel(spec32, device=device)
            m.load_state_dict(state)
            scores[device] = torch.cat([m.score(b).float().cpu() for b in cpu_batches])
            del m
        cpu_check_s = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        gap = float((scores["cuda"] - scores["cpu"]).abs().max())
        scale = float(scores["cpu"].abs().max())
        n_pairs = RR_QUERIES * (1 + RR_NEGATIVES)
        rerank[label] = {"losses": losses, "steps_per_s": rate, "pairs_per_s": rate * n_pairs,
                         "peak_mib": peak, "eval_s": eval_s, "eval_pairs_per_s": len(rows) / eval_s,
                         "metrics": metrics, "dump_rows": len(dumped), "launches": launches,
                         "cpu_gap": gap, "cpu_scale": scale, "cpu_check_s": cpu_check_s,
                         "eval_host_s": host_s,
                         "seconds": time.perf_counter() - t_part}
        log(f"rerank {label} (bf16, {loss_fn}): losses {json.dumps([round(x, 5) for x in losses])}"
            f"; {rate:.4f} steps/s ({rate * n_pairs:.1f} pairs/s of {RR_LEN} tokens), peak "
            f"{peak:.0f} MiB; evaluate over the T5 index's top {args.k} of {RR_EVAL_QUERIES} "
            f"queries: {len(dumped)} rows in {eval_s:.2f} s ({len(rows) / eval_s:.0f} pairs/s"
            + (f"; {host_s:.2f} s of host work alone, every score 0" if host_s else "") + "), "
            f"metrics {json.dumps(metrics)}; launches {json.dumps(launches)}; fp32 scores of "
            f"{len(scores['cpu'])} pairs, card vs CPU: max gap {gap:.3e} (largest |score| "
            f"{scale:.3f}, bound {RR_CPU_REL:g} of it; {cpu_check_s:.1f} s); this part "
            f"{time.perf_counter() - t_part:.1f} s")
        check(all(math.isfinite(x) for x in losses), f"rerank {label}: a loss is not finite")
        check(len(dumped) == len(rows) == RR_EVAL_QUERIES * args.k,
              f"rerank {label}: the dump holds {len(dumped)} rows")
        check(saved == metrics and metrics["query_num"] == RR_EVAL_QUERIES,
              f"rerank {label}: the metrics file is not the evaluation's")
        check(all(math.isfinite(r["score"]) for r in dumped), f"rerank {label}: a score is not "
                                                               f"finite")
        check(not any(launches.values()), f"rerank {label}: a kernel launched: {launches}")
        check(len(scores["cpu"]) == RR_CPU_PAIRS and gap <= RR_CPU_REL * max(scale, 1.0),
              f"rerank {label}: fp32 scores on the card disagree with the CPU's")
    return {"t5_train": t5_train, "t5_serve": t5_serve, "rerank": rerank}


def plain_flash_qkv(flash, qkv, seg, nh, hd):
    """The plain version of ``flash.flash_attention_qkv`` (autograd through
    ``_reference_flash_attention`` on the projection's views)."""
    return flash._reference_flash_attention(*flash.split_qkv(qkv, nh, hd), seg, hd)


def flash_pairs(mask):
    """(query, key) pairs a segment mask makes visible: L^2 + (S - L)^2 per sequence."""
    S = mask.shape[1]
    L = mask.sum(1).double()
    return float((L * L + (S - L) * (S - L)).sum())


def rel_err(got, want, rows=None):
    """(max |got - want| over ``rows`` (all when None), that over max |want|, and
    the mean |got - want|)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    if rows is not None:
        d, w = d[rows], w[rows]
    err = d.max().item()
    return err, err / max(w.max().item(), 1e-30), d.mean().item()


def phase_flash_kernels(gen, flash, attn, cases=FLASH_KERNEL_CASES, k18_lens=(156, 512), nh=12,
                        hd=64):
    """The flash forward (F-fwd), dK/dV (F-dkv) and dQ (F-dq) kernels and K18 vs
    their plain versions at bert-base widths (nh=12, hd=64), at the passage
    tower's S=512 and the query tower's S=32, on ragged segment masks with pad
    rows and all-pad sequences (F-fwd also at S=156, all three on a mask that is
    no prefix), F-dq's D against the plain formula; SDPA with the same mask timed
    beside them as a yardstick (the port never calls it). Each row reports the
    (row tile, column tile) pairs the kernel visits of all
    (``flash._visible_tiles``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, scale = nh * hd, hd ** -0.5
    results = {}
    for dtype, B, S, with_bwd, kind in cases:
        suffix = "" if kind == "ragged" else f" {kind}"
        name = f"F-fwd {str(dtype)[6:]} B={B} S={S}{suffix}"
        qkv = torch.randn(B, S, 3 * H, generator=gen, device="cuda").to(dtype)
        q, k, v = flash.split_qkv(qkv, nh, hd)
        mask = ragged_mask(gen, B, S, n_pad_rows=2) if kind == "ragged" else runs_mask(gen, B, S)
        tiles = tiles_visited(flash, mask, bias=False)
        real = mask.bool()
        o, lse = flash.flash_fwd(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ro, rlse = flash._reference_flash_fwd(q, k, v, mask, scale)
        err_real, rel_real, mean_real = rel_err(o, ro, real)
        err_all, rel_all, mean_all = rel_err(o, ro)
        lse_err = (lse - rlse).abs().max().item()
        finite = bool(torch.isfinite(o).all())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        seg = mask[:, None, :, None] == mask[:, None, None, :]
        lib_out = sdpa(qt, kt, vt, attn_mask=seg, scale=scale).transpose(1, 2)
        lib_rel = rel_err(lib_out, ro, real)[1]
        ms = cuda_ms(lambda: flash.flash_fwd(q, k, v, mask, scale))
        plain_ms = cuda_ms(lambda: flash._reference_flash_fwd(q, k, v, mask, scale))
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=seg, scale=scale))
        es = qkv.element_size()
        pairs = flash_pairs(mask)
        b_ms, b_by = bound(4 * es * B * S * H + 4 * B * nh * S + 4 * B * S, 4 * nh * hd * pairs,
                           "bf16" if dtype == torch.bfloat16 else "fp32")
        dense_ms = bound(4 * es * B * S * H, 4 * nh * hd * B * S * S,
                         "bf16" if dtype == torch.bfloat16 else "fp32")[0]
        tol = FLASH_REL[dtype]
        log(f"{name}: real rows max_abs {err_real:.3e} ({rel_real:.3e} of max, tol {tol:g}) "
            f"mean_abs {mean_real:.3e}, all rows {err_all:.3e} ({rel_all:.3e}) mean_abs "
            f"{mean_all:.3e}, lse {lse_err:.3e} (tol 1e-4), finite={finite}; "
            f"SDPA vs plain {lib_rel:.3e} of max; kernel {ms:.4f} ms plain {plain_ms:.3f} ms "
            f"SDPA {lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.3f}) bound {b_ms:.4f} ms "
            f"({b_by}; dense S^2 {dense_ms:.4f}); tiles visited {tiles[0]} / {tiles[1]}")
        check(finite, f"{name}: non-finite output")
        check(rel_all <= tol and lse_err <= 1e-4, f"{name}: kernel disagrees with its plain version")
        results[name] = {"max_abs_err": err_all, "max_abs_err_real_rows": err_real,
                         "rel_err": rel_all, "mean_abs_err": mean_all, "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "dense_bound_ms": dense_ms, "sdpa_ratio": ms / lib_ms,
                         "tiles_visited": tiles[0], "tiles_total": tiles[1]}
        if not with_bwd:
            del qkv, q, k, v, o, lse, ro, rlse, lib_out, seg
            continue
        # both backward kernels, on the forward kernel's o and lse, cotangent zero on pad
        # rows: F-dq first, which computes D (held to the plain formula), then F-dkv on it
        do = (torch.randn(B, S, nh, hd, generator=gen, device="cuda")
              * mask[:, :, None, None]).to(dtype)
        grad = torch.empty(B, S, 3, nh, hd, dtype=dtype, device="cuda")
        kD = flash.flash_bwd_dq(q, k, v, mask, lse, do, o, scale, grad)
        flash.flash_bwd_dkv(q, k, v, mask, lse, do, kD, scale, grad)
        torch.cuda.synchronize()
        D = flash._reference_flash_d(o, do)
        d_err, d_rel, _ = rel_err(kD, D)
        dq, dk, dv = grad.unbind(2)
        rdk, rdv = flash._reference_flash_bwd_dkv(q, k, v, mask, lse, do, D, scale)
        rdq = flash._reference_flash_bwd_dq(q, k, v, mask, lse, do, D, scale)
        leaf = qkv.clone().requires_grad_(True)
        plain_flash_qkv(flash, leaf, mask, nh, hd).backward(do)
        auto = leaf.grad.view(B, S, 3, nh, hd)
        del leaf
        errs = {}
        for gname, got, closed, a in (("dq", dq, rdq, auto[:, :, 0]), ("dk", dk, rdk, auto[:, :, 1]),
                                      ("dv", dv, rdv, auto[:, :, 2])):
            errs[gname] = rel_err(got, closed) + rel_err(got, a)
            check(bool(torch.isfinite(got).all()), f"F-bwd {gname}: non-finite gradient")
        t = {"dkv": cuda_ms(lambda: flash.flash_bwd_dkv(q, k, v, mask, lse, do, kD, scale, grad)),
             "dkv_plain": cuda_ms(lambda: flash._reference_flash_bwd_dkv(q, k, v, mask, lse, do,
                                                                          D, scale)),
             "dq": cuda_ms(lambda: flash.flash_bwd_dq(q, k, v, mask, lse, do, o, scale, grad)),
             "dq_plain": cuda_ms(lambda: flash._reference_flash_bwd_dq(
                 q, k, v, mask, lse, do, flash._reference_flash_d(o, do), scale))}

        def kernels_fwd_bwd():
            leaf = qkv.detach().requires_grad_(True)
            flash.flash_attention_qkv(leaf, mask, nh, hd).backward(do)

        def sdpa_fwd_bwd():
            leaf = qkv.detach().requires_grad_(True)
            lq, lk, lv = (x.transpose(1, 2) for x in flash.split_qkv(leaf, nh, hd))
            sdpa(lq, lk, lv, attn_mask=seg, scale=scale).transpose(1, 2).backward(do)

        t["fwd_bwd"], t["library_fwd_bwd"] = cuda_ms(kernels_fwd_bwd), cuda_ms(sdpa_fwd_bwd)
        # the backward alone, after one forward with requires_grad: SDPA's (dq, dk and dv
        # of separate q, k, v in one call) and the port's (D, F-dkv and F-dq into the one
        # [B, S, 3H] gradient of the projection)
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        lib_o = sdpa(ql, kl, vl, attn_mask=seg, scale=scale)
        do_t = do.transpose(1, 2)
        t["library_bwd"] = cuda_ms(
            lambda: torch.autograd.grad(lib_o, (ql, kl, vl), do_t, retain_graph=True))
        leaf = qkv.detach().requires_grad_(True)
        port_o = flash.flash_attention_qkv(leaf, mask, nh, hd)
        t["bwd"] = cuda_ms(lambda: torch.autograd.grad(port_o, leaf, do, retain_graph=True))
        del ql, kl, vl, lib_o, do_t, leaf, port_o
        # F-dkv reads q, k, v, dO, lse, D and the mask and writes dk, dv; F-dq reads q, k,
        # v, dO, O, lse and the mask and writes dq and D
        in_bytes = 4 * es * B * S * H + 2 * 4 * B * nh * S + 4 * B * S
        bounds = {"dkv": bound(in_bytes + 2 * es * B * S * H, 8 * nh * hd * pairs, "bf16"),
                  "dq": bound(in_bytes + 2 * es * B * S * H,
                              6 * nh * hd * pairs + 2 * B * S * H, "bf16")}
        bwd_tiles = {"pairs": tiles_visited(flash, mask, False),
                     "loads": tiles_visited(flash, mask, False, rows=FLASH_CTA_ROWS)}
        tol = FLASH_REL[dtype]
        log(f"F-dkv / F-dq bf16 B={B} S={S}{suffix}, rel to max|grad| vs closed-form plain (tol "
            f"{tol:g}) / vs autograd through the plain forward (tol {FLASH_AUTOGRAD_REL:g}): "
            + ", ".join(f"{g} {e[1]:.3e} / {e[4]:.3e} (mean_abs {e[2]:.3e} / {e[5]:.3e})"
                        for g, e in errs.items())
            + f"; F-dq's D vs the plain formula {d_err:.3e} ({d_rel:.3e} of max, tol "
            f"{FLASH_D_REL:g}); each kernel visits {bwd_tiles['pairs'][0]} / "
            f"{bwd_tiles['pairs'][1]} (key tile, query tile) pairs of 64 x 64 and loads "
            f"{bwd_tiles['loads'][0]} / {bwd_tiles['loads'][1]} streamed tiles for its "
            f"{FLASH_CTA_ROWS}-row CTAs"
            + f"; dkv {t['dkv']:.3f} ms (plain {t['dkv_plain']:.3f}, bound "
            f"{bounds['dkv'][0]:.4f} {bounds['dkv'][1]}), dq {t['dq']:.3f} ms (plain "
            f"{t['dq_plain']:.3f}, bound {bounds['dq'][0]:.4f} {bounds['dq'][1]}); F-dkv + F-dq "
            f"{t['dkv'] + t['dq']:.3f} ms, the port's backward (with D) {t['bwd']:.3f} ms vs "
            f"SDPA's backward {t['library_bwd']:.3f} ms; forward + backward "
            f"{t['fwd_bwd']:.3f} ms vs SDPA {t['library_fwd_bwd']:.3f} ms")
        check(all(e[1] <= tol and e[4] <= FLASH_AUTOGRAD_REL for e in errs.values()),
              "F-dkv / F-dq disagree with their plain versions")
        check(d_rel <= FLASH_D_REL, "F-dq's D disagrees with the plain formula")
        for kname, gnames in (("F-dkv", ("dk", "dv")), ("F-dq", ("dq",))):
            key = kname[2:]
            results[f"{kname} bf16 B={B} S={S}{suffix}"] = {
                "max_abs_err": max(errs[g][0] for g in gnames),
                "rel_err": max(errs[g][1] for g in gnames),
                "mean_abs_err": max(errs[g][2] for g in gnames),
                "autograd_rel_err": max(errs[g][4] for g in gnames), "ms": t[key],
                "plain_ms": t[key + "_plain"], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None,
                "fwd_bwd_ms": t["fwd_bwd"], "library_fwd_bwd_ms": t["library_fwd_bwd"],
                "bwd_ms": t["bwd"], "library_bwd_ms": t["library_bwd"],
                "kernels_bwd_ms": t["dkv"] + t["dq"], "tiles_visited": bwd_tiles["pairs"][0],
                "tiles_total": bwd_tiles["pairs"][1], "tile_loads": bwd_tiles["loads"][0],
                "tile_loads_total": bwd_tiles["loads"][1]}
        results[f"F-dq bf16 B={B} S={S}{suffix}"].update(D_max_abs_err=d_err, D_rel_err=d_rel)
        del qkv, q, k, v, o, lse, ro, rlse, do, D, kD, grad, dk, dv, dq, rdk, rdv, rdq, auto, seg
        torch.cuda.empty_cache()

    # K18: the forward kernel in bias mode vs _reference_attention, at its design shape
    # (S=156) and at S=512; SDPA with the same additive bias beside it
    for S_k in k18_lens:
        B = 64
        name = f"K18 bf16 B={B} S={S_k}"
        qkv = torch.randn(B, S_k, 3 * H, generator=gen, device="cuda").to(torch.bfloat16)
        mask = ragged_mask(gen, B, S_k, n_pad_rows=2)
        tiles = tiles_visited(flash, mask, bias=True)
        out = attn.fused_qkv_attention(qkv, mask, scale, nh, hd)
        torch.cuda.synchronize()
        ref = attn._reference_attention(qkv, mask, scale, nh, hd)
        err, rel, mean = rel_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        qt, kt, vt = (t.transpose(1, 2) for t in flash.split_qkv(qkv, nh, hd))
        bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :].to(torch.bfloat16)
        ms = cuda_ms(lambda: attn.fused_qkv_attention(qkv, mask, scale, nh, hd))
        plain_ms = cuda_ms(lambda: attn._reference_attention(qkv, mask, scale, nh, hd))
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias, scale=scale))
        b_ms, b_by = bound(2 * 4 * B * S_k * H + 4 * B * S_k, 4 * nh * hd * B * S_k * S_k, "bf16")
        log(f"{name}: max_abs {err:.3e} ({rel:.3e} of max, tol {FLASH_REL[torch.bfloat16]:g}) "
            f"mean_abs {mean:.3e} finite={finite}; kernel {ms:.4f} ms plain {plain_ms:.3f} ms "
            f"SDPA {lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.3f}) bound {b_ms:.4f} ms "
            f"({b_by}); tiles visited {tiles[0]} / {tiles[1]}")
        check(finite and rel <= FLASH_REL[torch.bfloat16],
              f"{name}: kernel disagrees with its plain version")
        results[name] = {"max_abs_err": err, "rel_err": rel, "mean_abs_err": mean, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "sdpa_ratio": ms / lib_ms, "tiles_visited": tiles[0],
                         "tiles_total": tiles[1]}
        del qkv, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return results


def phase_flash_serving(args, tmp):
    """Serving at S=512 with attention='flash', through the entry points; the
    same path on the plain flash version; encode rates of flash, fused and xla."""
    from denseretrievaltoolkits_torch.config import ModelArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.evaluator.metrics import get_metrics
    from denseretrievaltoolkits_torch.evaluator.retrieval import search_queries, write_ranking
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModelForInference
    from denseretrievaltoolkits_torch.ops import attn, flash
    from denseretrievaltoolkits_torch.run_encode import encode_batches

    config = BertConfig(num_hidden_layers=args.layers)
    arch = os.path.join(tmp, "bert-base-512")
    save_config(config, arch)
    model = DRModelForInference.build(
        ModelArguments(model_name_or_path=arch, dtype="bfloat16", attention="flash",
                       pooling="first"), device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed + 512)
    docs, p_batches = make_batches(rng, FLASH_PASSAGES, 512, "d", args.batch, pad_batch,
                                   median=FLASH_MEDIAN_LEN, sigma=FLASH_LEN_SIGMA, min_len=16)
    _, q_batches = make_batches(rng, FLASH_QUERIES, 32, "q", args.batch, pad_batch, docs=docs)
    lens = np.array([len(d) for d in docs])
    full = float(np.mean(lens == 512))
    log(f"flash serving: bert-base L={config.num_hidden_layers} bf16 flash; {FLASH_PASSAGES} "
        f"passages (S=512, mean {lens.mean():.1f} real tokens, {full:.3f} at 512), "
        f"{FLASH_QUERIES} queries (S=32), batch {args.batch}")
    check(full >= 0.10, "fewer than 10% of the passages are 512 tokens long")

    def run(label, m=model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_reps, p_lookup = encode_batches(m, p_batches, "passage", args.batch)
        q_reps, q_lookup = encode_batches(m, q_batches, "query", args.batch)
        index = FlatIPIndex(p_reps.shape[1], dtype="float32", block_size=INDEX_BLOCK,
                            device="cuda")
        index.add(p_reps)
        index.docid = list(p_lookup)
        scores, docids = search_queries(index, q_reps, index.docid, args.k,
                                        batch_size=FLASH_QUERIES)
        ranking = os.path.join(tmp, f"ranking_flash_{label}.tsv")
        write_ranking(docids, scores, q_lookup, ranking)
        hits = np.array([[d == f"d{q}" for d in row] for q, row in enumerate(docids)])
        metrics = {k: v / len(q_lookup) for k, v in get_metrics(hits, [1, 10, 100]).items()}
        with open(ranking) as fh:
            n_lines = sum(1 for _ in fh)
        log(f"flash serving, {label}: {time.perf_counter() - t0:.2f} s end to end, ranking "
            f"{n_lines} lines, metrics {json.dumps(metrics)}")
        check(p_reps.shape == (FLASH_PASSAGES, config.hidden_size), f"{label}: reps shape")
        check(np.isfinite(p_reps).all() and np.isfinite(q_reps).all(), f"{label}: non-finite reps")
        check(n_lines == FLASH_QUERIES * args.k, f"{label}: ranking file length")
        return dict(p_reps=p_reps, q_reps=q_reps, docids=np.asarray(docids),
                    scores=np.asarray(scores), metrics=metrics)

    # K18 is counted too: nothing on the path calls it (K1 superseded it in the reference)
    counted = (flash.flash_fwd, flash.flash_bwd_dkv, flash.flash_bwd_dq, attn.fused_qkv_attention)
    for fn in counted:
        fn.launches = 0
    kern = run("kernels")
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"launches on the S=512 serving path: {json.dumps(launches)}")
    check(launches["flash_fwd"] > 0, "the flash forward never launched on the serving path")
    check(launches["flash_bwd_dkv"] == 0 and launches["flash_bwd_dq"] == 0,
          "a backward kernel launched while serving")
    # the same weights in fp32 on the plain version: what both bf16 paths approximate
    model32 = DRModelForInference.build(
        ModelArguments(model_name_or_path=arch, dtype="float32", attention="flash",
                       pooling="first"), device="cuda", seed=args.seed)
    with mock.patch.object(flash, "flash_attention_qkv",
                           functools.partial(plain_flash_qkv, flash)):
        plain = run("plain")
        exact = run("fp32", model32)
    del model32
    torch.cuda.empty_cache()

    def cos(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    def metric_gap(a, b):
        return max(abs(a["metrics"][m] - b["metrics"][m]) for m in b["metrics"])

    cos_min = float(min(cos(kern["p_reps"], plain["p_reps"]).min(),
                        cos(kern["q_reps"], plain["q_reps"]).min()))
    e2e_overlap, e2e_gap = overlap(kern["docids"], plain["docids"]), metric_gap(kern, plain)
    to_fp32 = {lab: (overlap(r["docids"], exact["docids"]), metric_gap(r, exact))
               for lab, r in (("kernels", kern), ("plain", plain))}
    # how flat the ranking is: the spread of the top-k scores vs the score change the
    # encoders' bf16 differences cause on the same (query, passage) pairs
    spread = float(np.median(plain["scores"][:, 0] - plain["scores"][:, -1]))
    pairs = np.array([[int(d[1:]) for d in row] for row in plain["docids"]])
    shift = float(np.median(np.abs(
        np.einsum("qd,qkd->qk", kern["q_reps"], kern["p_reps"][pairs])
        - np.einsum("qd,qkd->qk", plain["q_reps"], plain["p_reps"][pairs]))))
    (k_over, k_gap), (p_over, p_gap) = to_fp32["kernels"], to_fp32["plain"]
    log(f"flash kernels vs plain: reps cosine min {cos_min:.6f} (>= 0.999), top-{args.k} overlap "
        f"{e2e_overlap:.5f}, largest metric difference {e2e_gap:.4f}; against "
        f"the fp32 ranking: overlap kernels {k_over:.5f}, plain {p_over:.5f} (kernels >= plain "
        f"- {FLASH_FP32_OVERLAP:g}), largest metric difference kernels {k_gap:.4f}, plain "
        f"{p_gap:.4f} (kernels <= plain + {FLASH_FP32_METRIC:g}); median top-{args.k} score "
        f"spread {spread:.4g}, median score shift from the encoders {shift:.4g}")
    check(cos_min >= 0.999, "flash serving: reps disagree with the plain path")
    check(k_over >= p_over - FLASH_FP32_OVERLAP,
          "flash serving: the kernels' ranking is further from fp32 than the plain path's")
    check(k_gap <= p_gap + FLASH_FP32_METRIC,
          "flash serving: the kernels' metrics are further from fp32 than the plain path's")
    del plain, exact

    # encode rate and peak memory per attention, on the same weights and batches, in
    # turns (flash, fused, xla, then again in reverse)
    n_tokens = sum(int(b["attention_mask"].sum()) for _, b in p_batches)
    rates, peaks = {}, {}

    def timed(attention):
        model.lm_q.attention = attention
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_batches(model, p_batches, "passage", args.batch)
        torch.cuda.synchronize()
        rates.setdefault(attention, []).append(FLASH_PASSAGES / (time.perf_counter() - t0))

    for attention in ("flash", "fused", "xla", "xla", "fused", "flash"):
        timed(attention)
    for attention in ("flash", "fused", "xla"):
        model.lm_q.attention = attention
        peaks[attention] = peak_mib(lambda: encode_batches(model, p_batches[:1], "passage",
                                                           args.batch))
    model.lm_q.attention = "flash"
    rate = {a: float(np.mean(r)) for a, r in rates.items()}
    log(f"encode at S=512 (passages/s, twice each in turns; peak MiB of one batch of "
        f"{args.batch}): " + ", ".join(
            f"{a} {rate[a]:.1f} ({', '.join(f'{x:.1f}' for x in rates[a])}) peak {peaks[a]:.0f}"
            for a in rate) + f"; {n_tokens / FLASH_PASSAGES:.1f} real tokens per passage")
    return {"launches": launches, "cos_min": cos_min, "e2e_overlap": e2e_overlap,
            "metric_gap": e2e_gap, "fp32_overlap": to_fp32,
            "score_spread": spread, "score_shift": shift,
            "metrics": kern["metrics"], "passages_per_s": rate,
            "passages_per_s_readings": rates, "peak_mib": peaks, "share_at_512": full}


def phase_flash_train(args, tmp):
    """Training at S=512 with attention='flash' through DRModel.build and
    Trainer.train; the same run on the plain versions; steps/s and peak memory
    against attention='xla'."""
    from denseretrievaltoolkits_torch.config import ModelArguments, TrainingArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.data.loaders import DataLoader
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, flash
    from denseretrievaltoolkits_torch.train.losses import contrastive_loss
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    config = BertConfig(num_hidden_layers=TRAIN_LAYERS)
    arch = os.path.join(tmp, "bert-base-train-512")
    save_config(config, arch)
    B, n_p, q_len, p_len = FLASH_TRAIN_BATCH, 8, 32, 512
    rng = np.random.default_rng(args.seed + 513)
    rows = make_train_rows(rng, FLASH_TRAIN_STEPS * B, n_p, p_len, q_len,
                           median=FLASH_MEDIAN_LEN, sigma=FLASH_LEN_SIGMA, min_len=16)

    def collate(batch):
        return (pad_batch([q for q, _ in batch], q_len, 0),
                pad_batch([p for _, ps in batch for p in ps], p_len, 0))

    def loader():
        return DataLoader(rows, B, collate, shuffle=True, seed=args.seed)

    def build(attention="flash", dtype="bfloat16"):
        margs = ModelArguments(model_name_or_path=arch, dtype=dtype, attention=attention,
                               fused_loss=True, pooling="first")
        return DRModel.build(margs, device="cuda", seed=args.seed)

    def trainer_for(label, model):
        targs = TrainingArguments(
            output_dir=os.path.join(tmp, label, "out"),
            cache_train_dir=os.path.join(tmp, label, "cache"), train_batch_size=B, max_epochs=2,
            learning_rate=TRAIN_LR, optimizer="adamw", scheduler="linear", warmup_ratio=0.1,
            log_every=1, save_per_train=10)
        return Trainer(targs, model, train_loader=loader())

    @contextlib.contextmanager
    def plain_versions():
        with mock.patch.object(flash, "flash_attention_qkv",
                               functools.partial(plain_flash_qkv, flash)), \
                mock.patch.object(con, "fused_contrastive_loss",
                                  lambda q, p, stride: contrastive_loss(q, p)[0]):
            yield

    def losses_of(trainer):
        with open(os.path.join(trainer.training_args.output_dir, "train_log.jsonl")) as fh:
            return [r["loss"] for r in map(json.loads, fh) if "loss" in r]

    batches = list(loader())
    p_tok = int(batches[0][1]["attention_mask"].sum())
    log(f"flash training: bert-base L={config.num_hidden_layers} bf16 flash + fused loss, tied; "
        f"batch {B} queries x {n_p} passages, q_max_len {q_len} p_max_len {p_len}, "
        f"{len(batches)} steps/epoch x 2 epochs, adamw lr {TRAIN_LR:g}; first batch {p_tok} "
        f"real passage tokens of {B * n_p * p_len}")

    def step1_grads(dtype="bfloat16"):
        model = build(dtype=dtype)
        loss = model(*batches[0])["loss"]
        loss.backward()
        flat = torch.cat([prm.grad.flatten() for prm in model.parameters()
                          if prm.grad is not None])
        return float(loss.detach()), flat

    def cosine(a, b):
        a, b = a.double(), b.double()
        return float(torch.dot(a, b) / (a.norm() * b.norm()))

    counted = (flash.flash_fwd, flash.flash_bwd_dkv, flash.flash_bwd_dq, attn.fused_qkv_attention)
    kern_trainer = trainer_for("flash-kernels", build())
    for fn in counted:
        fn.launches = 0
    kern_trainer.train()
    launches = {fn.__name__: fn.launches for fn in counted}
    kern_losses = losses_of(kern_trainer)
    log(f"launches on the S=512 training path: {json.dumps(launches)}; step losses "
        f"{json.dumps([round(x, 5) for x in kern_losses])}")
    check(all(launches[fn.__name__] > 0 for fn in counted[:3]),
          "a flash kernel never launched in training")
    check(all(math.isfinite(x) for x in kern_losses), "a flash training loss is not finite")
    # Every step's loss against the plain versions' on the same weights and batch: eight
    # kernel steps again (the first epoch's batches twice), the plain forward before
    # each. (Two free-running
    # runs part by chance: adamw turns the bf16 noise of near-zero gradients into
    # full-size updates, and the step losses of this sharp random-init model follow;
    # their largest gap read 0.086 and 0.300 at seeds 0 and 1 on the H100.)
    paired = trainer_for("flash-paired", build())
    pair_losses = []
    for batch in batches * 2:
        with torch.no_grad(), plain_versions():
            plain_loss = float(paired.model(*batch)["loss"])
        pair_losses.append((float(paired.train_step(batch)), plain_loss))
    del paired
    torch.cuda.empty_cache()
    k_loss1, k_grad = step1_grads()
    with plain_versions():
        p_loss1, p_grad = step1_grads()
        f_loss1, f_grad = step1_grads("float32")  # what both bf16 paths approximate
    step1_rel = abs(k_loss1 - p_loss1) / abs(p_loss1)
    cos, cos_kf, cos_pf = cosine(k_grad, p_grad), cosine(k_grad, f_grad), cosine(p_grad, f_grad)
    norm_ratio = float(k_grad.double().norm() / p_grad.double().norm())
    step_gap = max(abs(k - p) for k, p in pair_losses)
    del k_grad, p_grad, f_grad
    torch.cuda.empty_cache()
    log(f"flash kernels vs plain: step-1 loss {k_loss1:.6f} vs {p_loss1:.6f} (rel "
        f"{step1_rel:.3e}, <= {TRAIN_STEP1_REL:g}; fp32 {f_loss1:.6f}); step-1 gradient cosine "
        f"{cos:.6f} (>= {FLASH_GRAD_COS:g}), to the fp32 gradient: kernels {cos_kf:.6f}, plain "
        f"{cos_pf:.6f} (kernels >= plain - {FLASH_GRAD_FP32_GAP:g}); norm ratio "
        f"{norm_ratio:.6f} (within {TRAIN_GRAD_NORM:g} of 1); largest step-loss gap on the "
        f"same weights {step_gap:.4e} (<= {FLASH_STEP_GAP:g}); (kernels, plain) losses "
        f"{json.dumps([(round(k, 5), round(p, 5)) for k, p in pair_losses])}")
    check(step1_rel <= TRAIN_STEP1_REL, "flash training: step-1 loss disagrees with plain")
    check(cos >= FLASH_GRAD_COS, "flash training: step-1 gradients disagree with plain")
    check(cos_kf >= cos_pf - FLASH_GRAD_FP32_GAP,
          "flash training: the kernels' gradient is further from fp32 than the plain path's")
    check(abs(norm_ratio - 1) <= TRAIN_GRAD_NORM, "flash training: gradient norms disagree")
    check(step_gap <= FLASH_STEP_GAP, "flash training: step losses disagree with plain")

    def steps_per_s(trainer, n=FLASH_TRAIN_STEPS):
        for b in batches[:1]:  # warm-up
            trainer.train_step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    xla_trainer = trainer_for("flash-xla", build("xla"))
    rates = {"flash": [steps_per_s(kern_trainer)], "xla": [steps_per_s(xla_trainer)]}
    rates["xla"].append(steps_per_s(xla_trainer))
    rates["flash"].append(steps_per_s(kern_trainer))
    peaks = {"flash": peak_mib(lambda: kern_trainer.train_step(batches[0])),
             "xla": peak_mib(lambda: xla_trainer.train_step(batches[0]))}
    # where one flash step's device time goes, by kernel group (torch.profiler)
    split = encode_split(lambda: kern_trainer.train_step(batches[0]), TRAIN_STEP_GROUPS)
    del kern_trainer, xla_trainer
    torch.cuda.empty_cache()
    rate = {a: float(np.mean(r)) for a, r in rates.items()}
    log(f"train step at S=512 ({FLASH_TRAIN_STEPS} steps after 1 warm-up, twice each in turns): "
        f"flash {rate['flash']:.3f} steps/s peak {peaks['flash']:.0f} MiB; xla "
        f"{rate['xla']:.3f} steps/s peak {peaks['xla']:.0f} MiB; readings "
        f"{json.dumps({a: [round(x, 4) for x in r] for a, r in rates.items()})}")
    log(f"one flash step under torch.profiler: {split['wall_ms']:.1f} ms wall, "
        f"{split['device_ms']:.1f} ms on the device (busy {split['busy']:.3f}); by group "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in split["groups_ms"].items())
        + "; top kernels " + ", ".join(f"{n[:60]} {ms:.2f}"
                                       for n, ms in split["top_kernels_ms"].items()))
    return {"launches": launches, "losses": kern_losses, "paired_losses": pair_losses,
            "step1_rel": step1_rel, "grad_cos": cos, "grad_cos_to_fp32": cos_kf,
            "plain_grad_cos_to_fp32": cos_pf, "grad_norm_ratio": norm_ratio,
            "step_gap": step_gap, "steps_per_s": rate, "steps_per_s_readings": rates,
            "peak_mib": peaks, "step_profile": split}


def phase_quant(gen, quant, n_rows, dim=768):
    """K7 vs its plain version on the K5 phase's corpus size: bit for bit."""
    x = torch.randn(n_rows, dim, generator=gen, device="cuda")
    x[0] = 0  # a zero row: scale 1
    v, s = quant.quantize_int8_device(x)
    torch.cuda.synchronize()
    rv, rs = quant._quantize_int8_reference(x)
    err = max(float((v.int() - rv.int()).abs().max()), float((s - rs).abs().max()))
    equal = bool(torch.equal(v, rv) and torch.equal(s, rs))
    ms = cuda_ms(lambda: quant.quantize_int8_device(x))
    plain_ms = cuda_ms(lambda: quant._quantize_int8_reference(x))
    bound_ms, by = bound(n_rows * dim * (4 + 1) + n_rows * 4, n_rows * dim, "fp32")
    log(f"K7 fp32 {n_rows}x{dim}: values and scales bit-equal to the plain version: {equal} "
        f"(max abs diff {err:g}); kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
        f"{bound_ms:.3f} ms ({by})")
    check(equal, "K7 disagrees with its plain version")
    del x, rv, rs
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by}, (v, s)


def rescore(q, corpus, ids, scales=None, query_dtype=None, int4=False, magnitude=False):
    """fp64 scores of rows ``ids`` [Q, m] under the kernels' formula: queries in
    the kernels' input type (bf16 for bf16 and int8 rows; given for int4 rows),
    int8 rows and unpacked int4 rows times their scales. ``magnitude``: also
    the sums of the terms' magnitudes, sum_d |q_d x_d|."""
    from denseretrievaltoolkits_torch.ops.quant import unpack_int4

    if query_dtype is None:
        query_dtype = torch.float32 if corpus.dtype == torch.float32 else torch.bfloat16
    qc = q.to(query_dtype).double()
    idx = ids.long().clamp(min=0)
    rows = corpus[idx]
    if int4:
        rows = unpack_int4(rows.reshape(-1, rows.shape[-1])).reshape(*idx.shape, -1)
    rows = rows.double()
    if scales is not None:
        rows = rows * scales[idx].double()[..., None]
    s = torch.einsum("qd,qkd->qk", qc, rows)
    return (s, torch.einsum("qd,qkd->qk", qc.abs(), rows.abs())) if magnitude else s


def against_plain(q, corpus, scales, got, want, rel_tol, int4_query=None):
    """(rank-wise score error, rescored error of the ids, differing ids) of a
    top-k against the plain versions' top-k: ids may differ only inside ties
    within the tolerance. ``int4_query``: the rows are packed int4, scored
    under queries of that dtype."""
    (vals, ids), (ref_vals, ref_ids) = got, want
    tol = rel_tol * ref_vals.abs().clamp(min=1.0)
    rank_err = (vals - ref_vals).abs()
    rescored_err = (rescore(q, corpus, ids, scales, int4_query, int4_query is not None)
                    - ref_vals.double()).abs()
    if corpus.dtype == torch.int8 and int4_query is None:
        # the certificate's fallback scan scores fp32 queries (the reference's
        # formula), so a query that fell back carries fp32-query scores
        rescored_err = torch.minimum(rescored_err, (rescore(
            q, corpus, ids, scales, torch.float32) - ref_vals.double()).abs())
    ok = bool((rank_err <= tol).all()) and bool((rescored_err <= tol.double()).all())
    return ok, rank_err.max().item(), rescored_err.max().item(), int((ids != ref_ids).sum())


def blocks_against_plain(q, corpus, scales, got, want, rel_tol, int4_query=None, chunk=64,
                         list_q=None, stored=None, list_off=None):
    """(ok, max rank err, max rescored err, ids differing) of per-block top-J
    lists [L, nb, J] against the plain version's: scores rank-wise within
    ``rel_tol``, each kernel id scoring its kernel score under the kernels'
    formula within ``rel_tol`` of the magnitude of its terms (sum_d |q_d x_d|,
    which bounds a sum's rounding where the terms cancel: a score near 0 is as
    rounded as the partial sums it passed through), so an id may differ from
    the plain one only where the two tie; empty slots alike, and no id twice
    in one list. Lists ``a`` score query row ``list_q[a]`` of q (default row
    a); ``stored`` [N] bool, where given, must hold for every id;
    ``list_off`` [L], where given, is added to every score of list a (K17's
    slot offsets). Rescored ``chunk`` lists at a time (fp64 rows of every
    candidate); ``int4_query`` as in ``against_plain``."""
    (vals, ids), (ref_vals, ref_ids) = got, want
    tol = rel_tol * ref_vals.abs().clamp(min=1.0)
    rank_err = torch.where(vals == ref_vals, 0.0, (vals - ref_vals).abs())
    own_err = torch.zeros_like(vals, dtype=torch.float64)
    own_ok = True
    live = (ids >= 0).reshape(ids.shape[0], -1).any(1).nonzero().squeeze(1)  # lists with a row
    for a in range(0, live.numel(), chunk):
        at = live[a:a + chunk]
        part = ids[at]
        rescored, mag = rescore(q[at if list_q is None else list_q[at]], corpus,
                                part.reshape(part.shape[0], -1), scales, int4_query,
                                int4_query is not None, magnitude=True)
        if list_off is not None:
            off = list_off[at].double()[:, None]
            rescored, mag = rescored + off, mag + off.abs()
        err = torch.where(part >= 0, (rescored.reshape(part.shape) - vals[at].double()).abs(),
                          0.0)
        own_ok = own_ok and bool((err <= rel_tol * mag.reshape(part.shape).clamp(min=1.0)).all())
        own_err[at] = err
    srt = ids.sort(dim=-1).values
    repeated = ((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).any()
    ok = (bool((rank_err <= tol).all()) and own_ok
          and bool(((ids < 0) == (ref_ids < 0)).all()) and not bool(repeated))
    if stored is not None:
        ok = ok and bool((stored[ids.clamp(min=0).long()] | (ids < 0)).all())
    return ok, rank_err.max().item(), own_err.max().item(), int((ids != ref_ids).sum())


@contextlib.contextmanager
def plain_versions_of(table):
    """{module: {name: plain function}} patched in for the duration."""
    with contextlib.ExitStack() as stack:
        for mod, fns in table.items():
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
        yield


# the serve kernels' CUDA kernels by the pieces of their names: flat_serve.cu's wgmma body (K6,
# K8 bf16 / int8, K11, K12), flat_certified.cu's fp32 body (K8 fp32), block_topj.cu's mma.sync
# and CUDA-core bodies
SERVE_BODIES = ("flat_serve_wgmma", "flat_split_wgmma", "block_topj_mma_kernel",
                "block_topj_kernel")
# K6 and K8: the body each runs at H = 768 (ops/topk.py:BODIES) and its CUDA kernel
FLAT8_BODIES = {"K6": ("flat_serve", "flat_serve_wgmma"),
                "K8 float32": ("flat_certified", "flat_split_wgmma"),
                "K8 bfloat16": ("flat_serve", "flat_serve_wgmma"),
                "K8 int8": ("flat_serve", "flat_serve_wgmma")}
# (J, block) of K8 beside a 1M-row search's own (J = 7, 4096-row blocks): the 262,144-row
# slabs' J, the most, and the IVF side scans' (512-row blocks: 1M IVF1024 fp32 J = 12, 8.8M
# IVFR256 int8 J = 9, 8.8M IVF-PQ int8 J = 6; the IVF phases log the shapes their searches
# run); the side scans' shapes are held to the plain version on the first K8_SIDE_CHECK_ROWS
# rows and timed over all of them
K8_SHAPES = ((11, 4096), (32, 4096), (12, 512), (9, 512), (6, 512))
K8_SIDE_CHECK_ROWS = 131_072
# (J, block) of the serve kernels beside a 1M-row search's own (J = 7, 4096-row blocks): the 8.8M
# IVFR256 i8q side scan's J and block, the 262,144-row slabs' J, and the most
SERVE_SHAPES = ((9, 512), (11, 4096), (32, 4096))


def bit_equal(got, want):
    return bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


def serve_shapes(name, kern_at, ref_at, same):
    """``kern_at(J, block)`` against ``ref_at(J, block)`` by ``same(got, want)`` (checked) at
    each of SERVE_SHAPES, and the kernel's ms there: {"ms_j{J}_b{block}": ms}."""
    out = {}
    for J, blk in SERVE_SHAPES:
        check(same(kern_at(J, blk), ref_at(J, blk)),
              f"{name} at J={J}, block {blk} disagrees with its plain version")
        out[f"ms_j{J}_b{blk}"] = cuda_ms(lambda: kern_at(J, blk), iters=3)
    return out


def serve_times(t):
    """The kernel's ms at SERVE_SHAPES, as a phrase."""
    return ", ".join(f"J={j} block {b} {t[f'ms_j{j}_b{b}']:.3f} ms" for j, b in SERVE_SHAPES)


def serve_body(name, wrapper, kern):
    """The CUDA kernels a call of ``kern`` ran (``torch.profiler``; empty where it recorded
    none), which must be flat_serve.cu's wgmma body, as the wrapper's ``last_body`` says."""
    body = ",".join(kernel_split(kern, SERVE_BODIES, iters=3))
    check(wrapper.last_body == "flat_serve" and body in ("flat_serve_wgmma", ""),
          f"{name} ran {wrapper.last_body} ({body!r}), not flat_serve.cu's body")
    return body


def phase_int8_topk(gen, topk, quant, blockwise_topk, x_int8, n_queries=1024, k=100, dim=768):
    """K6, K8 and K12 vs their plain versions on the 1M-row corpus (int8 from
    K7, and fp32 / bf16 forms from the same seed for K8)."""
    values, scales = x_int8
    n_rows = values.shape[0]
    block = 4096  # FlatIPIndex's rule at this size
    q = torch.randn(n_queries, dim, generator=gen, device="cuda")
    results = {}
    plain = {topk: {"block_topj": topk._block_topj_reference,
                    "block_topj_serve": topk._block_topj_serve_reference,
                    "block_topj_i8q": topk._block_topj_i8q_reference},
             quant: {"quantize_int8_device": quant._quantize_int8_reference}}

    # K6: the certified int8 search
    counts0 = certificate_counts(topk)
    s, ids = topk.certified_topk(q, values, k, block, scales=scales)
    torch.cuda.synchronize()
    escalated, fallbacks = np.subtract(certificate_counts(topk), counts0).tolist()
    with plain_versions_of(plain):
        ps, pids = topk.certified_topk(q, values, k, block, scales=scales)
    ok, rank_err, res_err, differ = against_plain(q, values, scales, (s, ids), (ps, pids), 1e-5)
    # against the exact scan on the int8 rows, which scores fp32 queries (the
    # reference's fallback formula): the k-th best of two score functions differ
    # by at most their largest gap over all rows, which is measured here
    bs, bids = blockwise_topk(q, values, k, block, scales=scales)
    gap = torch.zeros(n_queries, device="cuda")
    qd = q - q.bfloat16().float()
    for start in range(0, n_rows, 65536):
        blk = values[start:start + 65536].float() * scales[start:start + 65536, None]
        gap = torch.maximum(gap, (qd @ blk.T).abs().amax(1))
    scan_err = (s - bs).abs()
    scan_ok = bool((scan_err <= gap[:, None] + 1e-5 * bs.abs().clamp(min=1)).all())
    scan_recall = overlap(ids.tolist(), bids.tolist())
    qc = q.bfloat16()
    J = max(4, min(k, 8))
    # block by block at the search's J and its escalation's (4 J), on flat_serve.cu's body
    held = {}
    for j6 in (J, 4 * J):
        kv, ki = topk.block_topj(qc, values, j6, block, n_rows, scales)
        body = topk.block_topj.last_body
        check(body == FLAT8_BODIES["K6"][0] and topk.block_topj.launches_int8_generic == 0,
              f"K6 J={j6}: ran {body!r} ({topk.block_topj.launches_int8_generic} launches of "
              f"block_topj.cu's body), not flat_serve.cu's")
        pv, pi = topk._block_topj_reference(qc, values, j6, block, n_rows, scales)
        held[j6] = blocks_against_plain(q, values, scales, (kv, ki), (pv, pi), 1e-5)
        check(held[j6][0], f"K6 J={j6}: per-block lists disagree with the plain version's "
              f"(rank {held[j6][1]:.3e}, rescored {held[j6][2]:.3e})")
        if j6 == J:
            blk_err = (kv - pv).abs().max().item()
        del kv, ki, pv, pi
    t = {"ms": cuda_ms(lambda: topk.block_topj(qc, values, J, block, n_rows, scales), iters=3),
         "ms_j32": cuda_ms(lambda: topk.block_topj(qc, values, 4 * J, block, n_rows, scales),
                           iters=3),
         "plain_ms": cuda_ms(lambda: topk._block_topj_reference(qc, values, J, block, n_rows,
                                                                 scales), iters=3),
         "search_ms": cuda_ms(lambda: topk.certified_topk(q, values, k, block, scales=scales),
                              iters=3),
         "body": kernel_split(lambda: topk.block_topj(qc, values, J, block, n_rows, scales),
                              SERVE_BODIES, iters=1)}
    check(set(t["body"]) <= {FLAT8_BODIES["K6"][1]}, f"K6 ran CUDA kernels {sorted(t['body'])}")
    t["body"] = ",".join(t["body"]) or body
    ops = 2.0 * n_queries * n_rows * dim
    t["bound_ms"], t["bound_by"] = bound(values.numel() + 4 * n_rows + 2 * q.numel(), ops, "bf16")
    log(f"K6 int8 {n_rows}x{dim} Q={n_queries} k={k}: vs the plain-version certified search: "
        f"ids differing {differ}, max rank err {rank_err:.3e}, max rescored err {res_err:.3e} "
        f"(rel tol 1e-5); certificate escalated {escalated} fallbacks {fallbacks}; vs the exact "
        f"scan on fp32 queries: max rank gap {scan_err.max().item():.3e} within the measured "
        f"bf16-query gap (max {gap.max().item():.3e}): {scan_ok}, recall@{k} {scan_recall:.5f}; "
        f"per block (body {t['body']}) against the plain version, rank / rescored err J={J} "
        f"{held[J][1]:.3e} / {held[J][2]:.3e}, J={4 * J} {held[4 * J][1]:.3e} / "
        f"{held[4 * J][2]:.3e} (rel tol 1e-5); kernel J={J} {t['ms']:.3f} ms, J={4 * J} "
        f"{t['ms_j32']:.3f} ms, plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.3f} ms, "
        f"certified search {t['search_ms']:.3f} ms")
    check(ok, "K6: the certified int8 search disagrees with its plain version")
    check(scan_ok, "K6: the certified int8 search is not within the bf16-query gap of the scan")
    results["K6"] = dict(t, max_abs_err=blk_err, escalated=escalated, fallbacks=fallbacks,
                         ids_differing=differ, scan_recall=scan_recall)
    exact = {"int8": ids}
    del bs, bids

    # K8 on fp32, bf16 and int8 rows; K12 on int8 rows
    x = torch.randn(n_rows, dim, generator=gen, device="cuda")
    forms = {"float32": (x, None), "bfloat16": (x.bfloat16(), None), "int8": (values, scales)}
    for dtype in ("float32", "bfloat16"):
        exact[dtype] = topk.certified_topk(q, forms[dtype][0], k, block)[1]
    for name, dtype in (("K8", "float32"), ("K8", "bfloat16"), ("K8", "int8"), ("K12", "int8")):
        corpus, sc = forms[dtype]
        native = name == "K12"
        got = topk.serve_topk(q, corpus, k, block, scales=sc, i8_native=native)
        torch.cuda.synchronize()
        with plain_versions_of(plain):
            want = topk.serve_topk(q, corpus, k, block, scales=sc, i8_native=native)
        J = topk.serve_j(k, -(-n_rows // block), block)
        if native:
            qi, qs = quant.quantize_queries(q)
            kern = lambda: topk.block_topj_i8q(qi, qs, corpus, sc, J, block, n_rows)  # noqa: E731
            ref = lambda: topk._block_topj_i8q_reference(qi, qs, corpus, sc, J, block,  # noqa: E731
                                                         n_rows)
            ok = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            rank_err, res_err = (got[0] - want[0]).abs().max().item(), 0.0
            differ = int((got[1] != want[1]).sum())
            kind, q_bytes = "int8", q.numel() + 4 * n_queries
        else:
            qc = q.to(torch.bfloat16 if dtype != "float32" else torch.float32)
            tol = 1e-5 if dtype == "float32" else 1e-4

            def kern_at(j, b, n=n_rows, rows=corpus):
                return topk.block_topj_serve(qc, rows[:n], j, b, n,
                                             None if sc is None else sc[:n])

            kern = lambda: kern_at(J, block)  # noqa: E731
            ref = lambda: topk._block_topj_serve_reference(qc, corpus, J, block,  # noqa: E731
                                                           n_rows, sc)
            ok, rank_err, res_err, differ = against_plain(q, corpus, sc, got, want, tol)
            kind = "fp32" if dtype == "float32" else "bf16"
            q_bytes = qc.numel() * qc.element_size()
        kv, ki = kern()
        pv, pi = ref()
        blk_err = (kv - pv).abs().max().item()
        recall = overlap(got[1].tolist(), exact[dtype].tolist())
        t = {"ms": cuda_ms(kern, iters=3), "plain_ms": cuda_ms(ref, iters=3),
             "search_ms": cuda_ms(lambda: topk.serve_topk(q, corpus, k, block, scales=sc,
                                                          i8_native=native), iters=3)}
        n_bytes = corpus.numel() * corpus.element_size() + (0 if sc is None else 4 * n_rows)
        t["bound_ms"], t["bound_by"] = bound(n_bytes + q_bytes, ops, kind)
        label = f"{name} {dtype}"
        other = ""
        if native:  # K12: flat_serve.cu's body, bit-equal at every serve J
            t["body"] = serve_body(label, topk.block_topj_i8q, kern)
            t.update(serve_shapes(
                label, lambda j, b: topk.block_topj_i8q(qi, qs, corpus, sc, j, b, n_rows),
                lambda j, b: topk._block_topj_i8q_reference(qi, qs, corpus, sc, j, b, n_rows),
                bit_equal))
            other = f" (body {t['body']}; bit-equal at {serve_times(t)})"
            check(topk.block_topj_i8q.launches_generic == 0,
                  "K12 int8: block_topj.cu's body ran at H = 768")
        else:  # K8: its Hopper body, held to the plain version block by block at each shape
            want_body, want_kernel = FLAT8_BODIES[label]
            body = kernel_split(kern, SERVE_BODIES, iters=1)
            check(topk.block_topj_serve.last_body == want_body and set(body) <= {want_kernel},
                  f"{label} ran {topk.block_topj_serve.last_body} ({sorted(body)}), not "
                  f"{want_body}'s body")
            t["body"] = ",".join(body) or want_body
            held = {J: blocks_against_plain(q, corpus, sc, (kv, ki), (pv, pi), tol)}
            for j, b in K8_SHAPES:
                n = K8_SIDE_CHECK_ROWS if b < block else n_rows
                held[j, b] = blocks_against_plain(
                    q, corpus[:n], None if sc is None else sc[:n], kern_at(j, b, n),
                    topk._block_topj_serve_reference(qc, corpus[:n], j, b, n,
                                                     None if sc is None else sc[:n]), tol)
                t[f"ms_j{j}_b{b}"] = cuda_ms(lambda: kern_at(j, b), iters=3)
            for key, h in held.items():
                check(h[0], f"{label} at (J, block) {key}: per-block lists disagree with the "
                      f"plain version's (rank {h[1]:.3e}, rescored {h[2]:.3e}, rel tol {tol:g})")
            t["plain_rel_err"] = {str(key): h[1:3] for key, h in held.items()}
            check(topk.block_topj_serve.launches_generic == 0,
                  f"{label}: block_topj.cu's body ran {topk.block_topj_serve.launches_generic} "
                  f"times at H = 768")
            if dtype == "float32":
                # block_topj.cu's FFMA body on the same rows, 4 bytes off 16-byte alignment:
                # its time and its error against fp64 beside the fp16 pairs' (at most 2x)
                t["max_abs_err_fp64"] = fp64_err(q, corpus, kv, ki, chunk=16)
                generic0 = topk.block_topj_serve.launches_generic
                moved = torch.empty(corpus.numel() + 1, device="cuda")[1:].view(corpus.shape)
                moved.copy_(corpus)
                gv, gi = kern_at(J, block, rows=moved)
                t["ffma_max_abs_err_fp64"] = fp64_err(q, corpus, gv, gi, chunk=16)
                del gv, gi
                t["ffma_ms"] = cuda_ms(lambda: kern_at(J, block, rows=moved), iters=3)
                ran = topk.block_topj_serve.launches_generic - generic0
                check(ran == 5 and topk.block_topj_serve.last_body == "block_topj",
                      f"K8 fp32: the comparison on unaligned rows ran block_topj.cu's body {ran} "
                      f"times of its 5 calls")
                topk.block_topj_serve.launches_generic = generic0  # the comparison's launches
                del moved
                check(t["max_abs_err_fp64"] <= 2 * t["ffma_max_abs_err_fp64"],
                      f"K8 fp32: max |score - fp64| {t['max_abs_err_fp64']:.3e} over 2x the FFMA "
                      f"body's {t['ffma_max_abs_err_fp64']:.3e} on the same rows")
                t["ffma_bound_ms"] = bound(n_bytes + q_bytes, ops, "fp32")[0]
                # the fp16 pairs: three bf16-rate products
                t["bound_ms"], t["bound_by"] = bound(n_bytes + q_bytes, 3 * ops, "bf16")
                other = (f"; block_topj.cu's FFMA body on the same rows (unaligned) "
                         f"{t['ffma_ms']:.3f} ms, max |score - fp64| "
                         f"{t['ffma_max_abs_err_fp64']:.3e} against this body's "
                         f"{t['max_abs_err_fp64']:.3e} (<= 2x); FFMA bound "
                         f"{t['ffma_bound_ms']:.3f} ms")
            other = (f" (body {t['body']}; " + ", ".join(
                f"J={j} block {b} {t[f'ms_j{j}_b{b}']:.3f} ms" for j, b in K8_SHAPES)
                + "; per block against the plain version, rank / rescored err " + ", ".join(
                f"{key}: {h[1]:.3e} / {h[2]:.3e}" for key, h in held.items())
                + f" (rel tol {tol:g}))" + other)
        log(f"{label} {n_rows}x{dim} Q={n_queries} k={k} J={J}: vs the plain versions: ids "
            f"differing {differ}, max rank err {rank_err:.3e}, max rescored err {res_err:.3e}; "
            f"per-block max err {blk_err:.3e}; recall@{k} vs the certified search "
            f"{recall:.5f}; kernel {t['ms']:.3f} ms{other} plain {t['plain_ms']:.3f} ms bound "
            f"{t['bound_ms']:.3f} ms ({t['bound_by']}), search {t['search_ms']:.3f} ms")
        check(ok, f"{label}: the serve search disagrees with its plain version")
        check(recall >= (I8Q_RECALL if native else SERVE_RECALL),
              f"{label}: recall@{k} vs the certified search below its bound")
        results[label] = dict(t, max_abs_err=blk_err, ids_differing=differ, recall=recall, J=J)
        del kv, ki, pv, pi
    del x, forms
    torch.cuda.empty_cache()
    return results


def phase_int8_path(args, tmp, kern):
    """The int8 serving path through the entry points, on the main path's reps."""
    from denseretrievaltoolkits_torch.evaluator import retrieval
    from denseretrievaltoolkits_torch.evaluator.metrics import get_metrics
    from denseretrievaltoolkits_torch.index import flat
    from denseretrievaltoolkits_torch.index.io import load_index
    from denseretrievaltoolkits_torch.ops import quant, topk

    (p_reps, p_lookup), (q_reps, q_lookup) = kern["p_reps"], kern["q_reps"]
    modes = ("exact", "serve", "i8q", "approx")

    def run(label):
        index = flat.FlatIPIndex(p_reps.shape[1], dtype="int8", block_size=INDEX_BLOCK,
                                 device="cuda")
        index.add_device(torch.from_numpy(p_reps).cuda())
        index.docid = list(p_lookup)
        out = {}
        for mode in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores, docids = retrieval.search_queries(index, q_reps, index.docid, args.k,
                                                      batch_size=args.queries, mode=mode)
            dt = time.perf_counter() - t0
            ranking = os.path.join(tmp, f"ranking_int8_{label}_{mode}.tsv")
            retrieval.write_ranking(docids, scores, q_lookup, ranking)
            with open(ranking) as fh:
                n_lines = sum(1 for _ in fh)
            hits = np.array([[d == f"d{q}" for d in row] for q, row in enumerate(docids)])
            metrics = {m: v / len(q_lookup)
                       for m, v in get_metrics(hits, [1, 10, 100]).items()}
            check(n_lines == args.queries * args.k, f"int8 {mode}: ranking file length")
            check(np.isfinite(np.asarray(scores, np.float64)).all(), f"int8 {mode}: scores")
            out[mode] = {"docids": np.asarray(docids), "metrics": metrics,
                         "queries_per_s": len(q_lookup) / dt}
        return index, out

    counted = {"block_topj (K6)": (topk.block_topj, "launches_int8"),
               "quantize_int8_device": (quant.quantize_int8_device, "launches"),
               "block_topj_serve": (topk.block_topj_serve, "launches"),
               "block_topj_i8q": (topk.block_topj_i8q, "launches")}
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    index, got = run("kernels")
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}
    log(f"launches on the int8 path: {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()), "a kernel of the int8 path never launched")

    # the kernels against their plain versions on this path's own slab, queries,
    # blocks and J: K6 at the certified search's J and its escalation's, K8 and
    # K12 at the serve J
    values, scales, n = index._device_slabs[0]
    q = torch.from_numpy(q_reps).cuda()
    qc = q.bfloat16()
    qi, qs = quant.quantize_queries(q)
    block = index.search_block(values.shape[0])
    serve_block, serve_J = topk.serve_plan(args.k, values.shape[0], n, block)
    J6 = max(4, min(args.k, 8))
    blocks = {}
    for name, kern_fn, plain_fn, J, blk, tol in (
            ("K6", topk.block_topj, topk._block_topj_reference, J6, block, 1e-5),
            ("K6 escalated", topk.block_topj, topk._block_topj_reference, min(4 * J6, args.k),
             block, 1e-5),
            ("K8", topk.block_topj_serve, topk._block_topj_serve_reference, serve_J, serve_block,
             1e-4)):
        ok, err, res_err, differ = blocks_against_plain(
            q, values, scales, kern_fn(qc, values, J, blk, n, scales),
            plain_fn(qc, values, J, blk, n, scales), tol)
        log(f"int8 path {name} per block ({values.shape[0]} rows, Q={q.shape[0]}, block {blk}, "
            f"J={J}) vs the plain version: ids differing {differ} (ties only), max rank err "
            f"{err:.3e}, max rescored err {res_err:.3e} (rel tol {tol:g}): {ok}")
        check(ok, f"int8 path: {name} per block disagrees with its plain version")
        blocks[name] = {"J": J, "block": blk, "ids_differing": differ, "max_abs_err": err,
                        "max_rescored_err": res_err}
    kv, ki = topk.block_topj_i8q(qi, qs, values, scales, serve_J, serve_block, n)
    pv, pi = topk._block_topj_i8q_reference(qi, qs, values, scales, serve_J, serve_block, n)
    same = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
    log(f"int8 path K12 per block (block {serve_block}, J={serve_J}) vs the plain version: "
        f"bit-equal {same}")
    check(same, "int8 path: K12 per block differs from its plain version")
    blocks["K12"] = {"J": serve_J, "block": serve_block, "bit_equal": same}
    del q, qc, qi, qs, kv, ki, pv, pi
    with mock.patch.object(topk, "block_topj", topk._block_topj_reference), \
            mock.patch.object(topk, "block_topj_serve", topk._block_topj_serve_reference), \
            mock.patch.object(topk, "block_topj_i8q", topk._block_topj_i8q_reference), \
            mock.patch.object(quant, "quantize_int8_device", quant._quantize_int8_reference), \
            mock.patch.object(flat, "quantize_int8_device", quant._quantize_int8_reference):
        _, plain = run("plain")
    fp32_docids, fp32_metrics = kern["docids"], kern["metrics"]
    summary = {}
    for mode in modes:
        g, p = got[mode], plain[mode]
        vs_plain = overlap(g["docids"], p["docids"])
        vs_fp32 = overlap(g["docids"], fp32_docids)
        gap = max(abs(g["metrics"][m] - fp32_metrics[m]) for m in fp32_metrics)
        plain_gap = max(abs(g["metrics"][m] - p["metrics"][m]) for m in fp32_metrics)
        log(f"int8 {mode}: {g['queries_per_s']:.1f} queries/s (plain {p['queries_per_s']:.1f}); "
            f"top-{args.k} overlap vs plain {vs_plain:.5f} (>= {INT8_VS_PLAIN}), metric gap vs "
            f"plain {plain_gap:.4f} (<= {INT8_PLAIN_METRIC_GAP}); vs the fp32 exact ranking: "
            f"overlap {vs_fp32:.5f} (>= "
            f"{INT8_VS_FP32}), largest metric gap {gap:.4f} (<= {INT8_METRIC_GAP}); "
            f"metrics {json.dumps(g['metrics'])}")
        check(vs_plain >= INT8_VS_PLAIN and plain_gap <= INT8_PLAIN_METRIC_GAP,
              f"int8 {mode}: kernels disagree with the plain versions")
        check(vs_fp32 >= INT8_VS_FP32, f"int8 {mode}: ranking too far from fp32 exact")
        check(gap <= INT8_METRIC_GAP, f"int8 {mode}: metrics too far from fp32 exact")
        summary[mode] = {"queries_per_s": g["queries_per_s"], "metrics": g["metrics"],
                         "overlap_vs_plain": vs_plain, "overlap_vs_fp32": vs_fp32,
                         "metric_gap_vs_fp32": gap, "plain_queries_per_s": p["queries_per_s"]}

    # save, then the retrieval CLI serves the saved index on the card
    path = os.path.join(tmp, "int8_index")
    index.save(path)
    qpath = os.path.join(tmp, "q_int8.pkl")
    retrieval.pickle_save((q_reps, q_lookup), qpath)
    out = os.path.join(tmp, "ranking_int8_cli.tsv")
    retrieval.main(["--index_path", path, "--query_reps", qpath, "--search_mode", "serve",
                    "--depth", str(args.k), "--batch_size", str(args.queries),
                    "--save_ranking_to", out, "--save_text"])
    with open(out) as fh:
        n_lines = sum(1 for _ in fh)
    saved = np.load(path + ".npz")
    back = load_index(path)._native_int8_payload()
    same = bool(np.array_equal(back[0], saved["values"]) and
                np.array_equal(back[1], saved["scales"]))
    log(f"int8 index saved and served by retrieval.main --search_mode serve: {n_lines} ranking "
        f"lines ({args.queries} x {args.k}); reloaded payload bit-equal: {same}")
    check(n_lines == args.queries * args.k, "retrieval.main: ranking file length")
    check(same, "the reloaded int8 payload differs from the saved one")
    return {"launches": launches, "blocks": blocks, "modes": summary}


# the groups of one flat int8 search's kernels (ENCODE_GROUPS' form): K6 / K8 / K12 on their
# Hopper body or block_topj.cu's, the merges (the slabs' and the certificate's sorts and top-k),
# the certificate's exact scan (cuBLAS), the queries' casts and quantization and the rest
FLAT_SEARCH_GROUPS = (("K6 / K8 / K12 (flat_serve.cu)", ("flat_serve",)),
                      ("K6 / K8 / K12 (block_topj.cu)", ("block_topj",)),
                      ("merge: sorts", ("Sort",)), ("merge: sorts", ("sort",)),
                      ("merge: top-k", ("TopK",)), ("merge: top-k", ("topk",)),
                      ("exact scan: products (cuBLAS)", ("nvjet",)),
                      ("exact scan: products (cuBLAS)", ("gemm",)),
                      ("gathers and scatters", ("index",)),
                      ("elementwise", ("elementwise_kernel",)))


def phase_scale(gen, flat, topk, n_queries, k=100, dim=768):
    """MS MARCO passage's row count in int8, built as the trainer's evaluation
    path builds it: add_device of 262,144-row fp32 slabs, quantized by K7; one exact and
    one serve search under torch.profiler."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = flat.FlatIPIndex(dim, dtype="int8", device="cuda")
    for start in range(0, SCALE_ROWS, SLAB_ROWS):
        index.add_device(torch.randn(min(SLAB_ROWS, SCALE_ROWS - start), dim, generator=gen,
                                     device="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q = torch.randn(n_queries, dim, generator=gen, device="cuda").cpu().numpy()
    res, rates = {}, {}
    for mode in ("exact", "serve", "i8q"):
        index.search(q[:8], k, mode=mode)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[mode] = index.search(q, k, mode=mode)[1]
        rates[mode] = n_queries / (time.perf_counter() - t0)
    recall = {m: overlap(res[m].tolist(), res["exact"].tolist()) for m in ("serve", "i8q")}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_slabs = len(index._device_slabs)
    splits = {}
    for mode in ("exact", "serve"):  # K6 / K8 over the slabs, the merges, the rest
        splits[mode] = encode_split(lambda: index.search(q, k, mode=mode), FLAT_SEARCH_GROUPS)
        sp = splits[mode]
        log(f"scale int8 {mode} search under torch.profiler: wall {sp['wall_ms']:.1f} ms, device "
            f"{sp['device_ms']:.1f} ms (busy {sp['busy']:.3f}), by group "
            f"{json.dumps({g: round(ms, 2) for g, ms in sp['groups_ms'].items()})}; top kernels "
            f"{json.dumps({n: round(ms, 2) for n, ms in sp['top_kernels_ms'].items()})}")
        check("K6 / K8 / K12 (block_topj.cu)" not in sp["groups_ms"],
              f"scale int8 {mode}: block_topj.cu's body ran")
    log(f"scale: {SCALE_ROWS} x {dim} int8 rows in {n_slabs} slabs of {SLAB_ROWS} (built in "
        f"{build_s:.1f} s); {n_queries} queries k={k}: queries/s "
        f"{json.dumps({m: round(r, 1) for m, r in rates.items()})}; recall@{k} vs exact "
        f"{json.dumps({m: round(r, 5) for m, r in recall.items()})} (serve >= {SERVE_RECALL}, "
        f"i8q >= {I8Q_RECALL}); peak device memory {peak_gib:.2f} GiB")
    check(recall["serve"] >= SERVE_RECALL, f"scale: serve recall@{k} below its bound")
    check(recall["i8q"] >= I8Q_RECALL, f"scale: i8q recall@{k} below its bound")
    del index
    torch.cuda.empty_cache()
    return {"rows": SCALE_ROWS, "slabs": n_slabs, "build_s": build_s, "queries": n_queries,
            "queries_per_s": rates, "recall": recall, "peak_gib": peak_gib,
            "search_split": splits}


def phase_quant4(gen, quant, n_rows, dim=768):
    """K9 vs its plain version on a seeded fp32 corpus of the K5 phase's size:
    bit for bit. Returns the packed corpus for the int4 search phase."""
    x = torch.randn(n_rows, dim, generator=gen, device="cuda")
    x[0] = 0  # a zero row: scale 1
    v, s = quant.quantize_int4_device(x)
    torch.cuda.synchronize()
    rv, rs = quant._quantize_int4_reference(x)
    err = max(float((quant.unpack_int4(v).int() - quant.unpack_int4(rv).int()).abs().max()),
              float((s - rs).abs().max()))
    equal = bool(torch.equal(v, rv) and torch.equal(s, rs))
    ms = cuda_ms(lambda: quant.quantize_int4_device(x))
    plain_ms = cuda_ms(lambda: quant._quantize_int4_reference(x))
    bound_ms, by = bound(n_rows * dim * 4 + n_rows * dim // 2 + n_rows * 4, n_rows * dim, "fp32")
    log(f"K9 fp32 {n_rows}x{dim} -> {tuple(v.shape)} packed: values and scales bit-equal to the "
        f"plain version: {equal} (max abs diff {err:g}); kernel {ms:.3f} ms plain {plain_ms:.3f} "
        f"ms bound {bound_ms:.3f} ms ({by})")
    check(equal, "K9 disagrees with its plain version")
    del x, rv, rs
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by}, (v, s)


def phase_int4_topk(gen, topk, quant, blockwise_topk, x_int4, n_queries=1024, k=100, dim=768):
    """K10, K11 and K12's sq4 body vs their plain versions on the 1M-row int4
    corpus (packed by K9), through the searches that run them and block by
    block at the searches' J."""
    values, scales = x_int4
    n_rows = values.shape[0]
    block = 4096  # FlatIPIndex's rule at this size
    q = torch.randn(n_queries, dim, generator=gen, device="cuda")
    qb = q.bfloat16()
    qi, qs = quant.quantize_queries(q)
    plain = {topk: {"block_topj": topk._block_topj_reference,
                    "block_topj_serve": topk._block_topj_serve_reference,
                    "block_topj_i8q": topk._block_topj_i8q_reference}}
    ops = 2.0 * n_queries * n_rows * dim
    nb = -(-n_rows // block)
    results = {}

    # K10: the certified int4 search (fp32 queries in the kernel and the scan)
    counts0 = certificate_counts(topk)
    s, ids = topk.certified_topk(q, values, k, block, scales=scales, int4=True)
    torch.cuda.synchronize()
    escalated, fallbacks = np.subtract(certificate_counts(topk), counts0).tolist()
    with plain_versions_of(plain):
        want = topk.certified_topk(q, values, k, block, scales=scales, int4=True)
    ok, rank_err, res_err, differ = against_plain(q, values, scales, (s, ids), want, 1e-5,
                                                  int4_query=torch.float32)
    bs, bids = blockwise_topk(q, values, k, block, scales=scales, int4=True)
    scan_ok = against_plain(q, values, scales, (s, ids), (bs, bids), 1e-5,
                            int4_query=torch.float32)[0]
    J = max(4, min(k, 8))
    blk_ok, blk_err, blk_res, blk_differ = blocks_against_plain(
        q, values, scales, topk.block_topj(q, values, J, block, n_rows, scales, int4=True),
        topk._block_topj_reference(q, values, J, block, n_rows, scales, int4=True), 1e-5,
        int4_query=torch.float32)
    # the s8 wgmma body (int4_certified.cu) takes these shapes: block_topj.cu's FFMA body
    # must not have run on this path
    check(topk.block_topj.launches_int4_generic == 0,
          "K10: the certified int4 search ran block_topj.cu's FFMA body at H = 768")
    kern = lambda rows, j=J: topk.block_topj(q, rows, j, block, n_rows, scales, int4=True)  # noqa
    t = {"ms": cuda_ms(lambda: kern(values), iters=3),
         "ms_j32": cuda_ms(lambda: kern(values, 32), iters=3),
         "plain_ms": cuda_ms(lambda: topk._block_topj_reference(q, values, J, block, n_rows,
                                                                 scales, int4=True), iters=3),
         "search_ms": cuda_ms(lambda: topk.certified_topk(q, values, k, block, scales=scales,
                                                          int4=True), iters=3),
         "body": ",".join(kernel_split(lambda: kern(values), ("int4_certified_wgmma",
                                                              "block_topj_kernel"), iters=3))}
    # (an empty split: the profiler recorded no kernel; the counter above still holds)
    check(t["body"] in ("int4_certified_wgmma", ""), f"K10 ran CUDA kernels {t['body']!r}")
    # the FFMA body on the same rows, 4 bytes off 16-byte alignment (a shape the new body
    # does not take), for its time and its error against fp64 beside the new body's
    ffma_rows = torch.empty(values.numel() + 4, dtype=torch.int8, device="cuda")[4:].view(
        values.shape)
    ffma_rows.copy_(values)
    ffma_ok, _, ffma_res, _ = blocks_against_plain(
        q, values, scales, kern(ffma_rows),
        topk._block_topj_reference(q, values, J, block, n_rows, scales, int4=True), 1e-5,
        int4_query=torch.float32)
    t["ffma_ms"] = cuda_ms(lambda: kern(ffma_rows), iters=3)
    check(topk.block_topj.launches_int4_generic > 0, "K10: the FFMA body's comparison did not "
          "run the FFMA body")
    topk.block_topj.launches_int4_generic = 0  # those launches were the comparison's
    del ffma_rows
    out_bytes = 8 * n_queries * nb * J
    n_bytes = values.numel() + 4 * n_rows + 4 * q.numel() + out_bytes
    # the s8 body's work: three digit planes against the codes, each 2 Q N H operations
    t["bound_ms"], t["bound_by"] = bound(n_bytes, 3 * ops, "int8")
    t["fp32_bound_ms"] = bound(n_bytes, ops, "fp32")[0]
    log(f"K10 int4 {n_rows}x{dim} Q={n_queries} k={k}: vs the plain-version certified search: "
        f"ids differing {differ}, max rank err {rank_err:.3e}, max rescored err {res_err:.3e} "
        f"(rel tol 1e-5), vs the int4 exact scan: {scan_ok}; certificate escalated {escalated} "
        f"fallbacks {fallbacks}; per block (J={J}): {blk_ok}, ids differing {blk_differ} (ties "
        f"only), max err {blk_err:.3e}; max |score - fp64| {blk_res:.3e} (the FFMA body on the "
        f"same rows {ffma_res:.3e}, per block vs plain {ffma_ok}); kernel ({t['body']}) "
        f"{t['ms']:.3f} ms (J=32 {t['ms_j32']:.3f}, the FFMA body {t['ffma_ms']:.3f}) plain "
        f"{t['plain_ms']:.3f} ms bound {t['bound_ms']:.3f} ms ({t['bound_by']}, s8; fp32 FFMA "
        f"{t['fp32_bound_ms']:.3f}), certified search {t['search_ms']:.3f} ms")
    check(ok and scan_ok, "K10: the certified int4 search disagrees with its plain version")
    check(blk_ok, "K10 per block disagrees with its plain version")
    check(ffma_ok, "K10's FFMA body per block disagrees with its plain version")
    check(blk_res <= ffma_res, f"K10: the s8 body's error against fp64 ({blk_res:.3e}) exceeds "
          f"the FFMA body's ({ffma_res:.3e})")
    results["K10"] = dict(t, max_abs_err=blk_err, escalated=escalated, fallbacks=fallbacks,
                          ids_differing=differ, block_ids_differing=blk_differ,
                          max_abs_err_fp64=blk_res, ffma_max_abs_err_fp64=ffma_res)
    exact = ids
    # the certified search over bf16-rounded queries scores exactly as K11 does
    # (bf16 x int4 products are exact in fp32): serve's recall against it is
    # its selection's, as the int8 path measures it (K6 takes bf16 queries too)
    exact_bf16 = topk.certified_topk(qb.float(), values, k, block, scales=scales, int4=True)[1]
    del bs, bids

    # K11 (bf16 queries) and K12's sq4 body (int8 queries) through serve_topk
    for name, native in (("K11", False), ("K12 sq4", True)):
        got = topk.serve_topk(q, values, k, block, scales=scales, i8_native=native, int4=True)
        torch.cuda.synchronize()
        with plain_versions_of(plain):
            want = topk.serve_topk(q, values, k, block, scales=scales, i8_native=native,
                                   int4=True)
        sblock, sJ = topk.serve_plan(k, n_rows, n_rows, block)
        if native:
            kern = lambda: topk.block_topj_i8q(qi, qs, values, scales, sJ, sblock, n_rows,  # noqa
                                               int4=True)
            ref = lambda: topk._block_topj_i8q_reference(qi, qs, values, scales, sJ,  # noqa
                                                         sblock, n_rows, int4=True)
            kv, ki = kern()
            pv, pi = ref()
            ok = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            blk_ok = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
            rank_err, res_err = (got[0] - want[0]).abs().max().item(), 0.0
            blk_err, blk_differ = (kv - pv).abs().max().item(), int((ki != pi).sum())
            kind, q_bytes = "int8", qi.numel() + 4 * n_queries
        else:
            kern = lambda: topk.block_topj_serve(qb, values, sJ, sblock, n_rows, scales,  # noqa
                                                 int4=True)
            ref = lambda: topk._block_topj_serve_reference(qb, values, sJ, sblock,  # noqa
                                                           n_rows, scales, int4=True)
            ok, rank_err, res_err, _ = against_plain(q, values, scales, got, want, 1e-4,
                                                     int4_query=torch.bfloat16)
            blk_ok, blk_err, blk_res, blk_differ = blocks_against_plain(
                q, values, scales, kern(), ref(), 1e-4, int4_query=torch.bfloat16)
            kind, q_bytes = "bf16", 2 * q.numel()
        differ = int((got[1] != want[1]).sum())
        recall = overlap(got[1].tolist(), exact.tolist())
        # serve: its selection against the same formula; i8q: against fp32 queries
        selection = overlap(got[1].tolist(), exact_bf16.tolist()) if not native else recall
        t = {"ms": cuda_ms(kern, iters=3), "plain_ms": cuda_ms(ref, iters=3),
             "search_ms": cuda_ms(lambda: topk.serve_topk(q, values, k, block, scales=scales,
                                                          i8_native=native, int4=True),
                                  iters=3)}
        out_bytes = 8 * n_queries * -(-n_rows // sblock) * sJ
        t["bound_ms"], t["bound_by"] = bound(values.numel() + 4 * n_rows + q_bytes + out_bytes,
                                             ops, kind)
        # flat_serve.cu's body on this path, held to the plain version at every serve J
        wrapper = topk.block_topj_i8q if native else topk.block_topj_serve
        t["body"] = serve_body(name, wrapper, kern)
        if native:
            t.update(serve_shapes(
                name, lambda j, b: topk.block_topj_i8q(qi, qs, values, scales, j, b, n_rows,
                                                       int4=True),
                lambda j, b: topk._block_topj_i8q_reference(qi, qs, values, scales, j, b, n_rows,
                                                            int4=True), bit_equal))
        else:
            t.update(serve_shapes(
                name, lambda j, b: topk.block_topj_serve(qb, values, j, b, n_rows, scales,
                                                         int4=True),
                lambda j, b: topk._block_topj_serve_reference(qb, values, j, b, n_rows, scales,
                                                              int4=True),
                lambda got, want: blocks_against_plain(q, values, scales, got, want, 1e-4,
                                                       int4_query=torch.bfloat16)[0]))
        check(wrapper.launches_int4_generic == 0,
              f"{name}: block_topj.cu's body ran at H = 768")
        other = ""
        if not native:
            # block_topj.cu's body on the same rows, 4 bytes off 16-byte alignment (a shape
            # flat_serve.cu does not take), for its time and its error against fp64 beside the
            # new body's; then its launches, which were this comparison's, are taken back
            n_generic = wrapper.launches_int4_generic
            old_rows = torch.empty(values.numel() + 4, dtype=torch.int8, device="cuda")[4:].view(
                values.shape)
            old_rows.copy_(values)
            old = lambda: topk.block_topj_serve(qb, old_rows, sJ, sblock, n_rows,  # noqa: E731
                                                scales, int4=True)
            old_ok, _, old_res, _ = blocks_against_plain(q, values, scales, old(), ref(), 1e-4,
                                                         int4_query=torch.bfloat16)
            t["old_body"] = ",".join(kernel_split(old, SERVE_BODIES, iters=3))
            t["old_body_ms"] = cuda_ms(old, iters=3)
            check(wrapper.last_body == "block_topj" and wrapper.launches_int4_generic > n_generic,
                  f"{name}: the old body's comparison did not run block_topj.cu's body")
            wrapper.launches_int4_generic = n_generic
            del old_rows
            t.update(max_abs_err_fp64=blk_res, old_body_max_abs_err_fp64=old_res)
            other = (f"; max |score - fp64| {blk_res:.3e} (block_topj.cu's body "
                     f"{t['old_body']} on the same rows {old_res:.3e}, per block vs plain "
                     f"{old_ok}, {t['old_body_ms']:.3f} ms)")
            check(old_ok, f"{name}: block_topj.cu's body per block disagrees with its plain "
                  f"version")
            check(blk_res <= 2 * old_res, f"{name}: the wgmma body's error against fp64 "
                  f"({blk_res:.3e}) exceeds twice block_topj.cu's body's ({old_res:.3e})")
        log(f"{name} int4 {n_rows}x{dim} Q={n_queries} k={k} block {sblock} J={sJ}: vs the "
            f"plain versions: {'bit-equal ' if native else ''}{ok}, ids differing {differ}, max "
            f"rank err {rank_err:.3e}, max rescored err {res_err:.3e}; per block "
            f"{'bit-equal ' if native else ''}{blk_ok} (ids differing {blk_differ}, max err "
            f"{blk_err:.3e}){other}; recall@{k} vs the certified int4 search {recall:.5f}"
            f"{'' if native else f', over the same bf16 queries {selection:.5f}'}; kernel "
            f"({t['body']}) {t['ms']:.3f} ms ({'bit-equal' if native else 'within 1e-4'} at "
            f"{serve_times(t)}) plain {t['plain_ms']:.3f} ms bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), search {t['search_ms']:.3f} ms")
        check(ok and blk_ok, f"{name}: the int4 serve search disagrees with its plain version")
        check(recall >= (I8Q_RECALL if native else INT4_SERVE_FP32_RECALL),
              f"{name}: recall@{k} vs the certified int4 search below its bound")
        check(selection >= (I8Q_RECALL if native else SERVE_RECALL),
              f"{name}: recall@{k} of the selection below its bound")
        results[name] = dict(t, max_abs_err=blk_err, ids_differing=differ, recall=recall,
                             recall_same_queries=selection, J=sJ, block=sblock)
    del q, qb, qi, qs
    torch.cuda.empty_cache()
    return results


def synthetic_qa(rng, n_passages, n_queries, p_len, q_len):
    """Passages of seeded random words ("w<token id>", lognormal lengths up to
    p_len tokens with [CLS]/[SEP]) and queries that are a prefix of their
    passage. Query j's answer is a word of its own, planted in passage j and
    in 2 other random passages, so ``AnswerMatcher`` finds hits."""
    first_answer = 30522 - n_queries  # answer words are token ids no passage draws
    bodies = [rng.integers(1000, first_answer, int(np.clip(rng.lognormal(math.log(60), 0.5), 8,
                                                           p_len)) - 2).tolist()
              for _ in range(n_passages)]
    answers = list(range(first_answer, 30522))
    for j, a in enumerate(answers):
        for i in [j] + rng.integers(0, n_passages, 2).tolist():
            bodies[i][int(rng.integers(0, len(bodies[i])))] = a
    corpus = [{"id": f"d{i}", "original": " ".join(f"w{t}" for t in b),
               "tokens": [101] + b + [102]} for i, b in enumerate(bodies)]
    queries = []
    for j, a in enumerate(answers):
        L = int(np.clip(rng.lognormal(math.log(10), 0.4), 4, q_len - 1))
        body = bodies[j][:L - 2]
        queries.append({"query_id": f"q{j}", "answers": [f"w{a}"], "tokens": [101] + body + [102],
                        "original": " ".join(f"w{t}" for t in body)})
    return corpus, queries


def read_dump(args, ep):
    """{query_id: [doc_id, ...]} of the retrieval dump, in rank order, and its rows."""
    ranked, n = {}, 0
    with open(os.path.join(args.retrieve_dir, f"{ep}.0.json")) as fh:
        for line in fh:
            row = json.loads(line)
            ranked.setdefault(row["query_id"], []).append(row["doc_id"])
            n += 1
    return ranked, n


def eval_trainer(args, tmp, label):
    """Phase 11's model, data and Trainer, made from ``args.seed`` under ``tmp/label``:
    bert-base (bf16, fused attention and loss) built by ``DRModel.build``, one epoch of
    EVAL_TRAIN_STEPS steps that ends by evaluating into an int4 index. Returns
    (trainer, targs, query_loader, queries, model, config)."""
    from denseretrievaltoolkits_torch.config import ModelArguments, TrainingArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.data.loaders import DataLoader
    from denseretrievaltoolkits_torch.index import flat
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    class EvalTrainer(Trainer):
        """The Trainer with its evaluation index at INDEX_BLOCK-row blocks. At
        the index's default 4096 rows, 8192 passages make 2 blocks whose 2 x
        J=8 candidates cannot hold k=100: the certified search would scan, as
        the reference's does at this size (its safe_block caps int4 at 2048)."""

        def _make_index(self, dim):
            index = super()._make_index(dim)
            if isinstance(index, flat.FlatIPIndex):
                index.block_size = INDEX_BLOCK
            return index

    config = BertConfig(num_hidden_layers=TRAIN_LAYERS)
    arch = os.path.join(tmp, f"bert-base-{label}")
    save_config(config, arch)
    model = DRModel.build(ModelArguments(model_name_or_path=arch, dtype="bfloat16",
                                         attention="fused", fused_loss=True, pooling="first"),
                          device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    corpus, queries = synthetic_qa(rng, args.passages, args.queries, 156, 32)
    rows = make_train_rows(rng, EVAL_TRAIN_STEPS * TRAIN_BATCH, 8, 128, 32)
    train_loader = DataLoader(
        rows, TRAIN_BATCH, lambda b: (pad_batch([q for q, _ in b], 32, 0),
                                      pad_batch([p for _, ps in b for p in ps], 128, 0)),
        shuffle=True, seed=args.seed)
    corpus_loader = DataLoader(corpus, args.batch, lambda b: (
        [r["id"] for r in b], pad_batch([r["tokens"] for r in b], 156, 0)))
    query_loader = DataLoader(queries, args.batch, lambda b: (
        [r["query_id"] for r in b], pad_batch([r["tokens"] for r in b], 32, 0),
        [r["answers"] for r in b], [r["original"] for r in b]))
    targs = TrainingArguments(
        output_dir=os.path.join(tmp, label, "out"), cache_train_dir=os.path.join(
            tmp, label, "cache"), train_batch_size=TRAIN_BATCH, max_epochs=1,
        learning_rate=TRAIN_LR, optimizer="adamw", scheduler="linear", warmup_ratio=0.1,
        log_every=1, save_per_train=1, eval_per_train=1, index_dtype="int4",
        search_mode="exact", retrieve_num=args.k, topk="1,10,100")
    trainer = EvalTrainer(targs, model, corpus_dataloader=corpus_loader,
                          train_loader=train_loader, eval_loader=query_loader)
    return trainer, targs, query_loader, queries, model, config


def phase_eval_path(args, tmp):
    """The trainer's retrieval evaluation through the entry points: bert-base
    trained for one short epoch by ``Trainer.train`` with an ``eval_loader``,
    which evaluates into an int4 index (K9 quantizes, K10 searches); then
    ``evaluate`` on the same index in ``serve`` (K11) and ``i8q`` (K12 sq4)."""
    from denseretrievaltoolkits_torch.evaluator import retrieval
    from denseretrievaltoolkits_torch.index import flat
    from denseretrievaltoolkits_torch.ops import attn, quant, topk

    trainer, targs, query_loader, queries, model, config = eval_trainer(args, tmp, "eval")
    log(f"evaluation path: bert-base L={config.num_hidden_layers} bf16 fused + fused loss, "
        f"{EVAL_TRAIN_STEPS} train steps at {TRAIN_BATCH} x 8, then Trainer.evaluate: "
        f"{args.passages} passages (answers planted in {args.queries * 3} draws), "
        f"{args.queries} queries, int4 index ({INDEX_BLOCK}-row blocks), k={args.k}")

    counted = {"fused_attention_ln": (attn.fused_attention_ln, "launches"),
               "fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
               "quantize_int4_device": (quant.quantize_int4_device, "launches"),
               "block_topj (K10)": (topk.block_topj, "launches_int4"),
               "block_topj_serve (K11)": (topk.block_topj_serve, "launches_int4"),
               "block_topj_i8q (K12 sq4)": (topk.block_topj_i8q, "launches_int4")}
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    runs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()  # the epoch, then evaluate(eval_loader, 1) in exact
    torch.cuda.synchronize()
    train_eval_s = time.perf_counter() - t0
    runs["exact"] = (_metrics_of(targs, 1), *read_dump(targs, 1), train_eval_s)
    for mode in ("serve", "i8q"):
        targs.search_mode = mode
        t0 = time.perf_counter()
        m = trainer.evaluate(query_loader, 1)
        runs[mode] = (m, *read_dump(targs, 1), time.perf_counter() - t0)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}
    log(f"launches on the evaluation path: {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()), "a kernel of the evaluation path never launched")
    for mode, (m, ranked, n_rows, secs) in runs.items():
        log(f"int4 {mode}: {secs:.2f} s{' (with the training epoch)' if mode == 'exact' else ''}"
            f"; dump {n_rows} rows; metrics {json.dumps({k: round(v, 5) for k, v in m.items()})}")
        check(n_rows == args.queries * args.k and len(ranked) == args.queries,
              f"int4 {mode}: retrieval dump length")
        check(m["query_num"] == args.queries and all(math.isfinite(v) for v in m.values()),
              f"int4 {mode}: metrics")
    check(os.path.exists(os.path.join(targs.cache_train_dir, "1.0_metrics")),
          "the metrics json was not written")
    check(runs["exact"][0]["Recall@100"] > 0, "AnswerMatcher found no planted answer")

    # the saved index reloads bit for bit
    index = trainer.index
    saved = index._native_int8_payload()
    trainer._load_index(1)
    back = trainer.index._native_int8_payload()
    reloaded = bool(np.array_equal(saved[0], back[0]) and np.array_equal(saved[1], back[1]))
    log(f"_load_index(1) after _index_corpus: payload {saved[0].shape} bit-equal {reloaded}")
    check(reloaded and trainer.idx == index.docid, "the reloaded int4 index differs")

    # the plain versions of K9-K12 on the same reps (K1 / K2 encode alike): an
    # index rebuilt from the encoded corpus by the plain K9, searched by plain
    # K10 / K11 / K12 through the same evaluate
    reps = torch.from_numpy(np.load(os.path.join(targs.encode_corpus_dir, "1.0.npy"))).cuda()
    plain = {topk: {"block_topj": topk._block_topj_reference,
                    "block_topj_serve": topk._block_topj_serve_reference,
                    "block_topj_i8q": topk._block_topj_i8q_reference},
             quant: {"quantize_int4_device": quant._quantize_int4_reference},
             flat: {"quantize_int4_device": quant._quantize_int4_reference}}
    summary = {}
    with plain_versions_of(plain):
        plain_index = flat.FlatIPIndex(reps.shape[1], dtype="int4", block_size=INDEX_BLOCK,
                                       device="cuda")
        plain_index.add_device(reps)
        plain_index.docid = index.docid
        same_payload = bool(np.array_equal(plain_index._native_int8_payload()[0], saved[0]))
        trainer.index, trainer._indexed_ep = plain_index, 101
        for mode in ("exact", "serve", "i8q"):
            targs.search_mode = mode
            m = trainer.evaluate(query_loader, 101)
            ranked = read_dump(targs, 101)[0]
            km, kranked = runs[mode][0], runs[mode][1]
            vs_plain = overlap([kranked[q] for q in sorted(kranked)],
                               [ranked[q] for q in sorted(kranked)])
            gap = max(abs(km[x] - m[x]) for x in m if x != "query_num")
            log(f"int4 {mode}, kernels vs plain versions over the same reps: top-{args.k} "
                f"overlap {vs_plain:.5f} (>= {INT4_VS_PLAIN}), largest metric gap {gap:.4f} "
                f"(<= {INT4_PLAIN_METRIC_GAP})")
            check(vs_plain >= INT4_VS_PLAIN and gap <= INT4_PLAIN_METRIC_GAP,
                  f"int4 {mode}: the kernels disagree with their plain versions")
            summary[mode] = {"metrics": km, "seconds": runs[mode][3], "overlap_vs_plain": vs_plain,
                             "metric_gap_vs_plain": gap}
    check(same_payload, "the plain K9 packs the evaluation corpus differently from K9")
    del plain_index

    # against the float32 ranking of the same model, and why they part: how far
    # apart the top-k scores lie, against the score error int4 rows make
    targs.index_dtype, targs.search_mode = "float32", "exact"
    fm = trainer.evaluate(query_loader, 102)
    franked = read_dump(targs, 102)[0]
    q_reps = torch.cat([model.encode_query(b) for _, b, _, _ in query_loader])
    s32 = q_reps @ reps.T
    top = s32.topk(args.k, dim=1).values
    spread = float((top[:, 0] - top[:, -1]).median())
    deq = quant.dequantize_int4(*(torch.from_numpy(a).cuda() for a in saved))
    int4_err = float((q_reps @ deq.T - s32).abs().median())
    unit = torch.nn.functional.normalize(reps[:1024], dim=1)
    cos = float(((unit @ unit.T).sum() - 1024) / (1024 * 1023))
    log(f"float32 exact: metrics {json.dumps({k: round(v, 5) for k, v in fm.items()})}; median "
        f"top-{args.k} score spread {spread:.4g}, median int4 score error {int4_err:.4g}, mean "
        f"cosine between passage reps {cos:.5f}")
    del s32, deq, unit
    for mode in ("exact", "serve", "i8q"):
        kranked, km = runs[mode][1], runs[mode][0]
        vs_fp32 = overlap([kranked[q] for q in sorted(kranked)],
                          [franked[q] for q in sorted(kranked)])
        gap = max(abs(km[x] - fm[x]) for x in fm if x != "query_num")
        log(f"int4 {mode} vs the float32 exact ranking: top-{args.k} overlap {vs_fp32:.5f} (>= "
            f"{INT4_VS_FP32}), largest metric gap {gap:.4f} (<= {INT4_METRIC_GAP})")
        summary[mode].update(overlap_vs_fp32=vs_fp32, metric_gap_vs_fp32=gap)
    for mode in ("exact", "serve", "i8q"):
        check(summary[mode]["overlap_vs_fp32"] >= INT4_VS_FP32,
              f"int4 {mode}: ranking too far from float32 exact")
        check(summary[mode]["metric_gap_vs_fp32"] <= INT4_METRIC_GAP,
              f"int4 {mode}: metrics too far from float32 exact")

    # the retrieval CLI over the encoded corpus at --index_dtype int4
    q_reps = q_reps.cpu().numpy()
    p_path, q_path = os.path.join(tmp, "eval_p.pkl"), os.path.join(tmp, "eval_q.pkl")
    retrieval.pickle_save((reps.cpu().numpy(), index.docid), p_path)
    retrieval.pickle_save((q_reps, [q["query_id"] for q in queries]), q_path)
    out = os.path.join(tmp, "ranking_int4_cli.tsv")
    retrieval.main(["--passage_reps", p_path, "--query_reps", q_path, "--index_dtype", "int4",
                    "--depth", str(args.k), "--batch_size", str(args.queries),
                    "--save_ranking_to", out, "--save_text"])
    cli = {}
    with open(out) as fh:
        for line in fh:
            qid, did, _ = line.split("\t")
            cli.setdefault(qid, []).append(did)
    kranked = runs["exact"][1]
    vs_cli = overlap([kranked[q] for q in sorted(kranked)], [cli[q] for q in sorted(kranked)])
    log(f"retrieval.main --index_dtype int4: {sum(map(len, cli.values()))} ranking lines; top-"
        f"{args.k} overlap with the trainer's int4 exact ranking {vs_cli:.5f} (>= 0.999)")
    check(sum(map(len, cli.values())) == args.queries * args.k, "retrieval.main: ranking length")
    check(vs_cli >= 0.999, "retrieval.main --index_dtype int4 disagrees with the trainer")
    del reps, index
    trainer.index = None
    torch.cuda.empty_cache()
    # the trained model and its float32 ranking, for the IVF evaluation path
    ctx = {"trainer": trainer, "targs": targs, "query_loader": query_loader, "q_path": q_path,
           "float32_metrics": fm, "float32_ranked": franked}
    return {"launches": launches, "modes": summary, "float32_metrics": fm,
            "score_spread": spread, "int4_score_error": int4_err, "reps_cosine": cos,
            "reloaded_bit_equal": reloaded, "cli_overlap": vs_cli}, ctx


def _metrics_of(targs, ep):
    with open(os.path.join(targs.cache_train_dir, f"{ep}.0_metrics")) as fh:
        return json.load(fh)


# the groups of one certified int4 search's kernels (ENCODE_GROUPS' form): K10, the merges (the
# slabs' and the certificate's sorts and top-k), the certificate's exact scan (unpacked rows
# on cuBLAS) and the rest
CERTIFIED_SEARCH_GROUPS = (("K10 (int4_certified.cu)", ("int4_certified",)),
                           ("K10 (block_topj.cu's FFMA body)", ("block_topj_kernel",)),
                           ("merge: sorts", ("Sort",)), ("merge: sorts", ("sort",)),
                           ("merge: top-k", ("TopK",)), ("merge: top-k", ("topk",)),
                           ("exact scan: products (cuBLAS)", ("nvjet",)),
                           ("exact scan: products (cuBLAS)", ("gemm",)),
                           ("gathers and scatters", ("index",)),
                           ("elementwise", ("elementwise_kernel",)))


def phase_scale4(gen, flat, n_queries, k=100, dim=768):
    """MS MARCO v2 passage's row count in int4, which int8 cannot hold on one
    card: add_device of 262,144-row fp32 slabs, packed by K9 on arrival."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = flat.FlatIPIndex(dim, dtype="int4", device="cuda")
    for start in range(0, SCALE4_ROWS, SLAB_ROWS):
        index.add_device(torch.randn(min(SLAB_ROWS, SCALE4_ROWS - start), dim, generator=gen,
                                     device="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    # bf16-representable queries: exact (fp32) and serve (bf16) then score
    # them alike, so serve's recall is its selection's (phase_int4_topk)
    q = torch.randn(n_queries, dim, generator=gen, device="cuda").bfloat16().float().cpu().numpy()
    res, rates, secs = {}, {}, {}
    for mode in ("exact", "serve", "i8q"):
        index.search(q[:8], k, mode=mode)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[mode] = index.search(q, k, mode=mode)[1]
        secs[mode] = time.perf_counter() - t0
        rates[mode] = n_queries / secs[mode]
    recall = {m: overlap(res[m].tolist(), res["exact"].tolist()) for m in ("serve", "i8q")}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_slabs = len(index._device_slabs)
    # one more certified search under torch.profiler: K10, the merges, the exact scan
    split = encode_split(lambda: index.search(q, k, mode="exact"), CERTIFIED_SEARCH_GROUPS)
    log(f"scale int4 exact search under torch.profiler: wall {split['wall_ms']:.1f} ms, device "
        f"{split['device_ms']:.1f} ms (busy {split['busy']:.3f}), by group "
        f"{json.dumps({g: round(ms, 2) for g, ms in split['groups_ms'].items()})}; top kernels "
        f"{json.dumps({n: round(ms, 2) for n, ms in split['top_kernels_ms'].items()})}")
    log(f"scale int4: {SCALE4_ROWS} x {dim} rows packed to {dim // 2} bytes in {n_slabs} slabs of "
        f"{SLAB_ROWS} (built in {build_s:.1f} s, {resident_gib:.2f} GiB resident); {n_queries} "
        f"queries k={k}: seconds {json.dumps({m: round(x, 3) for m, x in secs.items()})}, "
        f"queries/s {json.dumps({m: round(r, 1) for m, r in rates.items()})}; recall@{k} vs exact "
        f"{json.dumps({m: round(r, 5) for m, r in recall.items()})} (serve >= {SERVE_RECALL}, "
        f"i8q >= {I8Q_RECALL}); peak device memory {peak_gib:.2f} GiB")
    check(recall["serve"] >= SERVE_RECALL, f"scale int4: serve recall@{k} below its bound")
    check(recall["i8q"] >= I8Q_RECALL, f"scale int4: i8q recall@{k} below its bound")
    del index
    torch.cuda.empty_cache()
    return {"rows": SCALE4_ROWS, "slabs": n_slabs, "build_s": build_s, "queries": n_queries,
            "seconds": secs, "queries_per_s": rates, "recall": recall,
            "resident_gib": resident_gib, "peak_gib": peak_gib, "exact_split": split}


# -- the trained IVF index: K13 and K14 ------------------------------------------------------------


def mixture(seed, dim=768):
    """The JAX package's IVF benchmark data (bench.py:271-272, 316-350) made on
    the card: IVF_CENTRES N(0, 1) centres and rows ``centre + IVF_SIGMA * N(0,
    1)``. Returns ``rows(start, n, stream=0)``: rows are made in MIX_UNIT-row
    units, each from its own generator, so a row's value does not depend on
    the chunking; stream 1 holds the queries."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn(IVF_CENTRES, dim, generator=g, device="cuda")

    def rows(start, n, stream=0):
        out = torch.empty(n, dim, device="cuda")
        for u in range(start // MIX_UNIT, -(-(start + n) // MIX_UNIT)):
            gu = torch.Generator(device="cuda").manual_seed(
                (seed * 1_000_003 + stream) * 1_000_003 + u)
            which = torch.randint(0, IVF_CENTRES, (MIX_UNIT,), generator=gu, device="cuda")
            unit = centres[which] + IVF_SIGMA * torch.randn(MIX_UNIT, dim, generator=gu,
                                                            device="cuda")
            lo, hi = max(start, u * MIX_UNIT), min(start + n, (u + 1) * MIX_UNIT)
            out[lo - start:hi - start] = unit[lo - u * MIX_UNIT:hi - u * MIX_UNIT]
        return out

    return rows


def ivf_cell_call(ivf_bulk, idx, q, k, mode):
    """The cell kernel call of ``idx``'s last bulk search of q (its learned
    Qcap, hot set and the index's own plan), the same call on the plain
    version, the query row of each of its lists and the work it does."""
    nlist, state = idx.nlist, idx._bulk_state
    qcap = state["qcap"]
    qd, B0 = idx._pad_queries(q)
    ps = ivf_bulk.probe_slab(qd, idx.centroids, idx._values.dtype, nlist,
                             min(idx.nprobe, nlist - int(state["hot"].size)), qcap,
                             state["hp"], B0, mode == "i8q")
    dim = idx.dim
    values = idx._values.reshape(-1, dim)
    row_ids = idx._row_ids.reshape(-1)
    scales = None if idx._scales is None else idx._scales.reshape(-1)
    block, sel, J = idx._cell_plan(qcap, k)
    filled = ivf_bulk.filled_slots(ps, qcap)  # as the searches pass them
    if idx._values.dim() == 3:  # the fixed-capacity layout, K13
        block_cell, cell_blocks = None, int(idx._values.shape[1]) // block

        def kernel():
            return ivf_bulk.cell_topj(ps.qslab, idx._values, idx._row_ids, idx._scales, J, block,
                                      sel, ps.qscales, filled)
        block_of = torch.arange(values.shape[0] // block, device="cuda") // cell_blocks
    else:  # the ragged layout, K14
        block_cell, cell_blocks = idx._block_cell, 1

        def kernel():
            return ivf_bulk.ragged_topj(idx._block_cell, ps.qslab, idx._values, idx._row_ids,
                                        idx._scales, J, block, sel, ps.qscales, filled)
        block_of = idx._block_cell.long()

    def plain():
        return ivf_bulk._ivf_topj_reference(ps.qslab, values, row_ids, scales, ps.qscales,
                                            block_cell, cell_blocks, J, block, sel, filled)
    per = -(-block // sel)
    # list (selection block sb, slot s) scores query row cell(sb) * Qcap + s of the slab
    list_q = ((block_of.repeat_interleave(per) * qcap)[:, None]
              + torch.arange(qcap, device="cuda")).reshape(-1)
    # the work this data needs: each probed cell's real query slots x its stored rows (a
    # cell's rows fill its first slots, so ceil(rows / sel) selection lists per slot),
    # inputs read once, outputs written once
    slots = torch.bincount(ps.sc[ps.in_cap], minlength=nlist).double()
    rows = torch.bincount(block_of.repeat_interleave(block)[row_ids >= 0], minlength=nlist)
    rows = rows.double() * (slots > 0)
    row_bytes = dim * values.element_size() + 4 + (0 if scales is None else 4)
    slot_bytes = dim * ps.qslab.element_size() + (0 if ps.qscales is None else 4)
    lists = float((slots * torch.ceil(rows / sel)).sum())
    n_bytes = (float(rows.sum()) * row_bytes + float(slots.sum()) * slot_bytes
               + (0 if block_cell is None else 4 * block_cell.numel()) + 8 * J * lists)
    # the launched shape: every slot of every cell against every row of the layout
    n_sel = values.shape[0] // block * per
    launched_bytes = (ps.qslab.numel() * ps.qslab.element_size() + values.shape[0] * row_bytes
                      + (0 if ps.qscales is None else 4 * ps.qscales.numel())
                      + (0 if block_cell is None else 4 * block_cell.numel())
                      + 8 * n_sel * qcap * J)
    kind = "int8" if mode == "i8q" else ("fp32" if idx.dtype == "float32" else "bf16")
    return {"kernel": kernel, "plain": plain, "ps": ps, "values": values, "row_ids": row_ids,
            "scales": scales, "list_q": list_q, "block": block, "sel": sel, "J": J,
            "slots": filled,
            "bound": bound(n_bytes, 2 * dim * float((slots * rows).sum()), kind),
            "launched_bound": bound(launched_bytes, 2 * dim * values.shape[0] * qcap, kind)}


# The CUDA kernels of the IVF cell kernels' bodies, by a piece of their names: ivf_cell.cu's
# (wgmma: bf16 / int8 rows / i8q; ffma: fp32) and the block top-J family's, which takes the
# shapes those do not (its launches also count on ``launches_generic``)
IVF_BODIES = tuple((p, (p,)) for p in ("ivf_cell_wgmma", "ivf_cell_ffma", "block_topj"))
# the groups of one bulk search's kernels, as ENCODE_GROUPS: the cell kernel, the side scan
# (K8 / K12), the merges' sorts and top-k, the probe's products, gathers and the rest
IVF_SEARCH_GROUPS = (("cell kernel (K13 / K14)", ("ivf_cell",)),
                     ("side scan (K8 / K12)", ("block_topj",)),
                     ("side scan (K8 / K12)", ("flat_serve",)),
                     ("side scan (K8 / K12)", ("flat_split",)),
                     ("sorts", ("Sort",)), ("top-k", ("TopK",)), ("top-k", ("topk",)),
                     ("products (cuBLAS)", ("nvjet",)), ("products (cuBLAS)", ("gemm",)),
                     ("gathers and scatters", ("index",)),
                     ("elementwise", ("elementwise_kernel",)))


@contextlib.contextmanager
def side_scans(ivf_bulk):
    """The (rows, block, J) of every side-scan call (K8 / K12) of ``ivf_bulk`` while open, as
    a set the context yields."""
    seen = set()
    serve, i8q = ivf_bulk.block_topj_serve, ivf_bulk.block_topj_i8q

    def on_serve(qc, values, J, block, n_valid, *a, **kw):
        seen.add((int(n_valid), int(block), int(J)))
        return serve(qc, values, J, block, n_valid, *a, **kw)

    def on_i8q(qi, qs, values, scales, J, block, n_valid, *a, **kw):
        seen.add((int(n_valid), int(block), int(J)))
        return i8q(qi, qs, values, scales, J, block, n_valid, *a, **kw)

    with mock.patch.object(ivf_bulk, "block_topj_serve", on_serve), \
            mock.patch.object(ivf_bulk, "block_topj_i8q", on_i8q):
        yield seen


def searched(ivf_bulk, fn, groups):
    """``encode_split(fn, groups)`` with the (rows, block, J) of its side scans in
    ``side_scans``."""
    with side_scans(ivf_bulk) as seen:
        split = encode_split(fn, groups)
    split["side_scans"] = sorted(seen)
    return split


def ivf_cell_checked(name, call, exact, rel_tol, dim):
    """The cell kernel's lists against its plain version's, list by list, both
    with the search's ``slots``: bit-equal where ``exact`` (i8q), else each list
    (selection block, slot) rank-wise and rescored against its slot of its
    cell's slab (``blocks_against_plain``); then one call's device ms by CUDA
    kernel (``encode_split``), in which the block top-J family's body may not
    appear. Returns (ok, errors, max abs error, split)."""
    got, want = call["kernel"](), call["plain"]()
    if exact:
        ok = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        err = (0.0, 0.0, int((got[1] != want[1]).sum()))
    else:
        n_lists, J = got[0].shape[0] * got[0].shape[1], got[0].shape[2]
        ok, *err = blocks_against_plain(
            call["ps"].qslab.reshape(-1, dim), call["values"], call["scales"],
            tuple(t.reshape(n_lists, 1, J) for t in got),
            tuple(t.reshape(n_lists, 1, J) for t in want), rel_tol, chunk=8192,
            list_q=call["list_q"], stored=call["row_ids"] >= 0)
    fin = want[1] >= 0
    max_abs = float((got[0] - want[0]).abs()[fin].max()) if fin.any() else 0.0
    del got, want
    split = encode_split(call["kernel"], IVF_BODIES)["groups_ms"]
    check("block_topj" not in split, f"{name}: a call ran the block top-J family's body")
    if not split:  # the counters (launches_generic 0) still show which body ran
        log(f"{name}: torch.profiler recorded none of the call's CUDA kernels")
    return ok, err, max_abs, split



def phase_ivf_kernels(seed, flat, ivf, ivf_bulk, n_rows, n_queries=2048, k=100, dim=768):
    """K13 and K14 through the entry points, and block by block against their
    plain versions: IVF1024 (fixed capacity) and IVFR1024 (ragged, 512-row
    blocks) over n_rows rows of the seeded mixture, trained on IVF_TRAIN_ROWS,
    nprobe 32, k=100; fp32, bf16 and int8 cells in bulk, int8 in i8q. Recall
    against the certified flat search of the same rows and dtype. Then
    ``PCAR384,SQ4`` (at 768-d) through train and add_chunks."""
    rows = mixture(seed, dim)
    x = rows(0, n_rows)
    q = rows(0, n_queries, stream=1).cpu().numpy()
    t0 = time.perf_counter()
    trained = ivf.IVFFlatIndex(dim, nlist=IVF_NLIST, nprobe=IVF_NPROBE, device="cuda")
    trained.train(x[:IVF_TRAIN_ROWS])  # the first rows: i.i.d. draws of the mixture
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    exact = {}
    for dtype in ("float32", "bfloat16", "int8"):
        ref = flat.FlatIPIndex(dim, dtype=dtype, device="cuda")
        ref.add_device(x)
        exact[dtype] = ref.search(q, k, mode="exact")[1]
        del ref
    fp32_exact = exact["float32"]
    log(f"IVF kernels: {n_rows} x {dim} rows of a {IVF_CENTRES}-centre mixture (sigma "
        f"{IVF_SIGMA}), {n_queries} queries, k={k}; k-means of {IVF_NLIST} cells on "
        f"{IVF_TRAIN_ROWS} rows in {train_s:.1f} s")
    out = {"train_s": train_s}
    counters = ("launches", "launches_int8", "launches_i8q", "launches_generic")
    for layout, cls, fn in (("IVF", ivf.IVFFlatIndex, ivf_bulk.cell_topj),
                            ("IVFR", ivf.IVFRaggedIndex, ivf_bulk.ragged_topj)):
        for dtype, mode in (("float32", "bulk"), ("bfloat16", "bulk"), ("int8", "bulk"),
                            ("int8", "i8q")):
            name = f"{layout}{IVF_NLIST} {dtype} {mode}"
            kw = {"block": IVF_RAGGED_BLOCK} if layout == "IVFR" else {}
            if mode == "bulk":
                idx = cls(dim, nlist=IVF_NLIST, nprobe=IVF_NPROBE, dtype=dtype, device="cuda",
                          **kw)
                idx.centroids = trained.centroids
                t0 = time.perf_counter()
                idx.add_device(x)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
            for c in counters:
                setattr(fn, c, 0)
            idx.search(q, k, mode=mode)  # the tuning call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(IVF_TIMED_SEARCHES):
                _, ids = idx.search(q, k, mode=mode)
            qps = IVF_TIMED_SEARCHES * n_queries / (time.perf_counter() - t0)
            launches = {c: getattr(fn, c) for c in counters}
            search = searched(ivf_bulk, lambda: idx.search(q, k, mode=mode), IVF_SEARCH_GROUPS)
            body = "launches_i8q" if mode == "i8q" else (
                "launches_int8" if dtype == "int8" else "launches")
            check(launches[body] > 0, f"{name}: the cell kernel never launched")
            check(launches["launches_generic"] == 0,
                  f"{name}: the search ran the block top-J family's body, not ivf_cell.cu's")
            recall = overlap(ids.tolist(), exact[dtype].tolist())
            call = ivf_cell_call(ivf_bulk, idx, q, k, mode)
            # i8q's s32 products: bit-equal
            ok, err, max_abs, split = ivf_cell_checked(
                name, call, mode == "i8q", 1e-5 if dtype == "float32" else 1e-4, dim)
            ms, plain_ms = cuda_ms(call["kernel"]), cuda_ms(call["plain"], iters=2)
            state = idx._bulk_state
            out[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs,
                         "bound_ms": call["bound"][0], "bound_by": call["bound"][1],
                         "launched_bound_ms": call["launched_bound"][0],
                         "queries_per_s": qps, "recall": recall,
                         "recall_vs_fp32": overlap(ids.tolist(), fp32_exact.tolist()),
                         "qcap": state["qcap"], "hot": int(state["hot"].size),
                         "side_rows": state["side"][3], "dropped": idx.last_dropped,
                         "block": call["block"], "sel": call["sel"], "J": call["J"],
                         "launches": launches[body], "build_s": build_s,
                         "body": "+".join(split), "kernel_split_ms": split,
                         "filled_slots": int(call["slots"].sum()), "search_split": search}
            log(f"{name}: kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms (bound "
                f"{call['bound'][0]:.3f} ms by {call['bound'][1]}; {call['launched_bound'][0]:.3f}"
                f" ms at the launched shape; a launch by CUDA kernel, ms: "
                f"{json.dumps(split)}; {int(call['slots'].sum())} of "
                f"{call['slots'].numel() * state['qcap']} slots filled), block {call['block']} in "
                f"selection blocks of "
                f"{call['sel']}, J={call['J']}; rank err {err[0]:.3g}, rescored err {err[1]:.3g}, "
                f"{err[2]} ids differing; {qps:.1f} queries/s; recall@{k} vs exact {dtype} "
                f"{recall:.5f} (vs fp32 {out[name]['recall_vs_fp32']:.5f}); Qcap {state['qcap']}, "
                f"{state['hot'].size} hot cells, side slab {state['side'][3]} rows, "
                f"{idx.last_dropped} pairs dropped; built in {build_s:.2f} s; one search under "
                f"torch.profiler: wall {search['wall_ms']:.2f} ms, device {search['device_ms']:.2f}"
                f" ms, by group {json.dumps(search['groups_ms'])}; side scans (rows, block, "
                f"J) {search['side_scans']}")
            check(ok, f"{name}: the cell kernel disagrees with its plain version")
            check(recall >= IVF_RECALL[layout],
                  f"{name}: recall@{k} below {IVF_RECALL[layout]}")
            if mode == "i8q" or dtype != "int8":
                del idx
                torch.cuda.empty_cache()
    del trained
    # PCAR{dim/2},SQ4: the transform and the int4 rows (K9 / K10) through add_chunks
    spec = f"PCAR{dim // 2},SQ4"
    t0 = time.perf_counter()
    pcar = flat.index_factory(dim, spec, device="cuda")
    pcar.train(x[:IVF_TRAIN_ROWS])
    pcar.add_chunks(lambda s, r: x[s:s + r], n_rows, chunk_rows=SLAB_ROWS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, ids = pcar.search(q, k)
    recall = overlap(ids.tolist(), fp32_exact.tolist())
    log(f"{spec}: built in {build_s:.2f} s through train + add_chunks; exact search "
        f"recall@{k} vs the fp32 flat exact {recall:.5f}")
    check(np.isfinite(s).all() and ids.shape == (n_queries, k) and (ids >= 0).all(),
          f"{spec}: search output")
    out[spec] = {"build_s": build_s, "recall_vs_fp32": recall}
    del pcar, x
    torch.cuda.empty_cache()
    return out


def phase_ivf_eval_path(args, tmp, ctx):
    """The evaluation path into a trained index: the evaluation phase's
    bert-base, ``Trainer.evaluate`` with ``index_factory`` EVAL_IVF_FACTORY
    (nprobe EVAL_IVF_NPROBE) in bulk, then i8q on the same index. It encodes
    (K1, K2), spills the reps to the memmap, trains k-means, builds through
    add_chunks (K7) and searches on K13, the side slab on K8 / K12. The plain
    versions over the same reps must agree; the ranking is compared with the
    float32 one of the same model; ``retrieval.main --index_path`` on the
    saved index must rank as the trainer did."""
    from denseretrievaltoolkits_torch.evaluator import retrieval
    from denseretrievaltoolkits_torch.index import ivf
    from denseretrievaltoolkits_torch.ops import attn, ivf_bulk, quant, topk

    trainer, targs, query_loader = ctx["trainer"], ctx["targs"], ctx["query_loader"]
    targs.index_factory, targs.nprobe = EVAL_IVF_FACTORY, EVAL_IVF_NPROBE
    ep = 201
    counted = {"fused_attention_ln": (attn.fused_attention_ln, "launches"),
               "fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
               "quantize_int8_device": (quant.quantize_int8_device, "launches"),
               "cell_topj (K13 int8)": (ivf_bulk.cell_topj, "launches_int8"),
               "cell_topj (K13 i8q)": (ivf_bulk.cell_topj, "launches_i8q"),
               "block_topj_serve": (topk.block_topj_serve, "launches"),
               "block_topj_i8q": (topk.block_topj_i8q, "launches")}
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    runs = {}
    for mode in ("bulk", "i8q"):
        targs.search_mode = mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.evaluate(query_loader, ep)  # bulk encodes, trains and builds first
        torch.cuda.synchronize()
        runs[mode] = (m, *read_dump(targs, ep), time.perf_counter() - t0)
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}
    index = trainer.index
    state = index._bulk_state
    side_rows = state["side"][3]
    n_ovf = 0 if index._ovf_ids is None else int(index._ovf_ids.numel())
    log(f"IVF evaluation path: {EVAL_IVF_FACTORY}, nprobe {EVAL_IVF_NPROBE}, {len(index)} "
        f"passages in cells of C={index._values.shape[1]}; Qcap {state['qcap']}, hot cells "
        f"{state['hot'].tolist()}, overflow {n_ovf} rows, side slab {side_rows} rows; launches "
        f"{json.dumps(launches)}")
    for name in ("fused_attention_ln", "fused_mlp_ln", "quantize_int8_device",
                 "cell_topj (K13 int8)", "cell_topj (K13 i8q)"):
        check(launches[name] > 0, f"IVF evaluation path: {name} never launched")
    if side_rows:
        check(launches["block_topj_serve"] > 0 and launches["block_topj_i8q"] > 0,
              "IVF evaluation path: the side slab was not scanned by K8 / K12")
    for mode, (m, ranked, n_rows, secs) in runs.items():
        built = " (encode, train and build included)" if mode == "bulk" else ""
        log(f"IVF {mode}: {secs:.2f} s{built}; dump {n_rows} rows; metrics "
            f"{json.dumps({k: round(v, 5) for k, v in m.items()})}")
        check(m["query_num"] == args.queries and all(math.isfinite(v) for v in m.values()),
              f"IVF {mode}: metrics")
        check(len(ranked) == args.queries and n_rows >= 0.99 * args.queries * args.k,
              f"IVF {mode}: retrieval dump length")

    # the plain versions of K7, K13, K8 and K12 over the same reps: the index
    # rebuilt from the spilled corpus on the same centroids, searched by the
    # same evaluate
    reps = torch.from_numpy(np.load(os.path.join(targs.encode_corpus_dir, f"{ep}.0.npy"))).cuda()
    plain = {ivf: {"quantize_int8_device": quant._quantize_int8_reference},
             quant: {"quantize_int8_device": quant._quantize_int8_reference},
             ivf_bulk: {"_launch": lambda wrapper, *a: ivf_bulk._ivf_topj_reference(*a),
                        "block_topj_serve": topk._block_topj_serve_reference,
                        "block_topj_i8q": topk._block_topj_i8q_reference}}
    summary = {}
    with plain_versions_of(plain):
        plain_index = ivf.IVFFlatIndex(reps.shape[1], nlist=index.nlist, nprobe=index.nprobe,
                                       dtype="int8", device="cuda")
        plain_index.centroids = index.centroids
        plain_index.add_chunks(lambda s, r: reps[s:s + r], reps.shape[0],
                               chunk_rows=max(1, min(reps.shape[0], targs.index_slab_rows)))
        same_layout = all(torch.equal(getattr(plain_index, a), getattr(index, a))
                          for a in ("_values", "_scales", "_row_ids"))
        plain_index.docid = index.docid
        trainer.index, trainer._indexed_ep = plain_index, ep + 100
        for mode in ("bulk", "i8q"):
            targs.search_mode = mode
            m = trainer.evaluate(query_loader, ep + 100)
            ranked = read_dump(targs, ep + 100)[0]
            km, kranked = runs[mode][0], runs[mode][1]
            vs_plain = overlap([kranked[q] for q in sorted(kranked)],
                               [ranked[q] for q in sorted(kranked)])
            gap = max(abs(km[x] - m[x]) for x in m if x != "query_num")
            log(f"IVF {mode}, kernels vs plain versions over the same reps: top-{args.k} overlap "
                f"{vs_plain:.5f} (>= {IVF_VS_PLAIN}), largest metric gap {gap:.4f} (<= "
                f"{IVF_PLAIN_METRIC_GAP})")
            check(vs_plain >= IVF_VS_PLAIN and gap <= IVF_PLAIN_METRIC_GAP,
                  f"IVF {mode}: the kernels disagree with their plain versions")
            summary[mode] = {"metrics": km, "seconds": runs[mode][3],
                             "overlap_vs_plain": vs_plain, "metric_gap_vs_plain": gap}
    log(f"plain K7 through add_chunks: the same cells, row ids and scales: {same_layout}")
    check(same_layout, "the plain K7 builds another IVF layout than K7")
    del plain_index, reps

    # against the float32 flat ranking of the same model (the evaluation phase's)
    fm, franked = ctx["float32_metrics"], ctx["float32_ranked"]
    for mode in ("bulk", "i8q"):
        kranked, km = runs[mode][1], runs[mode][0]
        vs_fp32 = overlap([kranked[q] for q in sorted(kranked)],
                          [franked[q] for q in sorted(kranked)])
        gap = max(abs(km[x] - fm[x]) for x in fm if x != "query_num")
        log(f"IVF {mode} vs the float32 flat exact ranking: top-{args.k} overlap {vs_fp32:.5f} "
            f"(>= {IVF_VS_FP32}), largest metric gap {gap:.4f} (<= {IVF_METRIC_GAP})")
        summary[mode].update(overlap_vs_fp32=vs_fp32, metric_gap_vs_fp32=gap)
    for mode in ("bulk", "i8q"):
        check(summary[mode]["overlap_vs_fp32"] >= IVF_VS_FP32,
              f"IVF {mode}: ranking too far from float32 exact")
        check(summary[mode]["metric_gap_vs_fp32"] <= IVF_METRIC_GAP,
              f"IVF {mode}: metrics too far from float32 exact")

    # the retrieval CLI on the saved index, in the trainer's query batches
    out = os.path.join(tmp, "ranking_ivf_cli.tsv")
    retrieval.main(["--index_path", targs.index_file + str(ep), "--query_reps", ctx["q_path"],
                    "--search_mode", "bulk", "--depth", str(args.k), "--batch_size",
                    str(args.batch), "--save_ranking_to", out, "--save_text"])
    cli = {}
    with open(out) as fh:
        for line in fh:
            qid, did, _ = line.split("\t")
            cli.setdefault(qid, []).append(did)
    kranked = runs["bulk"][1]
    vs_cli = overlap([kranked[q] for q in sorted(kranked)], [cli[q] for q in sorted(kranked)])
    log(f"retrieval.main --index_path <IVF index> --search_mode bulk: "
        f"{sum(map(len, cli.values()))} ranking lines; top-{args.k} overlap with the trainer's "
        f"bulk ranking {vs_cli:.5f} (>= 0.999)")
    check(vs_cli >= 0.999, "retrieval.main on the saved IVF index disagrees with the trainer")
    trainer.index = None
    torch.cuda.empty_cache()
    return {"launches": launches, "modes": summary, "qcap": state["qcap"],
            "hot": state["hot"].tolist(), "overflow_rows": n_ovf, "side_rows": side_rows,
            "cli_overlap": vs_cli}


def phase_ivf_scale(seed, flat, ivf_bulk, n_queries=2048, k=100, dim=768):
    """MS MARCO passage's row count from the mixture in ``IVFR256,SQ8`` (nprobe
    8, 2048-row blocks: the JAX package's IVF benchmark, bench.py:475-642),
    trained on IVF_TRAIN_ROWS rows and built by add_chunks in 500,000-row
    chunks; bulk and i8q at steady state after the tuning call, recall
    against the certified search of a flat int8 index over the same rows."""
    rows = mixture(seed, dim)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = flat.index_factory(dim, f"IVFR{SCALE_IVF_NLIST},SQ8", nprobe=SCALE_IVF_NPROBE,
                               device="cuda")
    index.block = SCALE_IVF_BLOCK
    index.train(rows(0, IVF_TRAIN_ROWS))  # the first rows: i.i.d. draws of the mixture
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.add_chunks(rows, SCALE_ROWS, chunk_rows=SCALE_IVF_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    t0 = time.perf_counter()
    ref = flat.FlatIPIndex(dim, dtype="int8", device="cuda")
    for start in range(0, SCALE_ROWS, SLAB_ROWS):
        ref.add_device(rows(start, min(SLAB_ROWS, SCALE_ROWS - start)))
    torch.cuda.synchronize()
    ref_build_s = time.perf_counter() - t0
    resident_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    q = rows(0, n_queries, stream=1).cpu().numpy()
    exact = ref.search(q, k, mode="exact")[1]
    counters = ("launches_int8", "launches_i8q", "launches_generic")
    res = {}
    for mode in ("bulk", "i8q"):
        for c in counters:
            setattr(ivf_bulk.ragged_topj, c, 0)
        _, ids = index.search(q, k, mode=mode)  # the tuning call
        state = index._bulk_state
        tuned = {"qcap": state["qcap"], "hot": state["hot"].tolist(),
                 "side_rows": state["side"][3], "dropped": index.last_dropped}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IVF_TIMED_SEARCHES):
            _, ids = index.search(q, k, mode=mode)
        secs = (time.perf_counter() - t0) / IVF_TIMED_SEARCHES
        launches = {c: getattr(ivf_bulk.ragged_topj, c) for c in counters}
        search = searched(ivf_bulk, lambda: index.search(q, k, mode=mode), IVF_SEARCH_GROUPS)
        recall = overlap(ids.tolist(), exact.tolist())
        call = ivf_cell_call(ivf_bulk, index, q, k, mode)
        ok, err, max_abs, split = ivf_cell_checked(f"scale IVF {mode}", call, mode == "i8q",
                                                   1e-4, dim)
        kernel_ms = cuda_ms(call["kernel"], iters=3)
        res[mode] = dict(tuned, seconds=secs, queries_per_s=n_queries / secs, recall=recall,
                         launches=launches["launches_i8q" if mode == "i8q" else "launches_int8"],
                         steady_dropped=index.last_dropped, kernel_ms=kernel_ms,
                         bound_ms=call["bound"][0], bound_by=call["bound"][1],
                         launched_bound_ms=call["launched_bound"][0], J=call["J"],
                         max_abs_err=max_abs, body="+".join(split), kernel_split_ms=split,
                         filled_slots=int(call["slots"].sum()), search_split=search)
        log(f"scale IVF {mode}: {n_queries} queries k={k} in {secs:.4f} s ({n_queries / secs:.1f} "
            f"queries/s), of which K14 {kernel_ms:.3f} ms (J={call['J']}, bound "
            f"{call['bound'][0]:.3f} ms by {call['bound'][1]}, "
            f"{call['launched_bound'][0]:.3f} ms at the launched shape; a launch by CUDA kernel, "
            f"ms: {json.dumps(split)}; {int(call['slots'].sum())} slots filled); vs its plain "
            f"version: rank err {err[0]:.3g}, rescored err {err[1]:.3g}, {err[2]} ids differing; "
            f"recall@{k} vs the "
            f"certified int8 flat search {recall:.5f} (>= "
            f"{SCALE_IVF_RECALL}); Qcap {tuned['qcap']}, hot cells {tuned['hot']}, side slab "
            f"{tuned['side_rows']} rows, pairs dropped {tuned['dropped']} (tuning) / "
            f"{index.last_dropped} (steady); K14 launches {json.dumps(launches)}; one search "
            f"under torch.profiler: wall {search['wall_ms']:.2f} ms, device "
            f"{search['device_ms']:.2f} ms, by group {json.dumps(search['groups_ms'])}; side "
            f"scans (rows, block, J) {search['side_scans']}")
        check(res[mode]["launches"] > 0, f"scale IVF {mode}: K14 never launched")
        check(launches["launches_generic"] == 0,
              f"scale IVF {mode}: the search ran the block top-J family's body, not ivf_cell.cu's")
        check(ok, f"scale IVF {mode}: the cell kernel disagrees with its plain version")
        check(recall >= SCALE_IVF_RECALL, f"scale IVF {mode}: recall@{k} below its bound")
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    pad = index._block_cell.numel() * index.block / SCALE_ROWS - 1
    log(f"scale IVF: {SCALE_ROWS} x {dim} rows in IVFR{SCALE_IVF_NLIST},SQ8 (block "
        f"{index.block}, {index._block_cell.numel()} blocks, padding {pad:.4f}, largest cell "
        f"{index._nb_max} blocks): k-means {train_s:.1f} s, add_chunks {build_s:.1f} s in "
        f"{SCALE_IVF_CHUNK}-row chunks, {ivf_gib:.2f} GiB; with the flat int8 reference (built in "
        f"{ref_build_s:.1f} s) {resident_gib:.2f} GiB resident, peak {peak_gib:.2f} GiB")
    del index, ref
    torch.cuda.empty_cache()
    return {"rows": SCALE_ROWS, "train_s": train_s, "build_s": build_s, "ivf_gib": ivf_gib,
            "resident_gib": resident_gib, "peak_gib": peak_gib, "padding": pad, "modes": res}



# -- the product-quantized indexes: K15, K16 and K17 ----------------------------------------------


def spectrumed(seed, dim=768):
    """The JAX package's PQ benchmark data (bench.py:790-800, 941-968): the
    IVF mixture of :func:`mixture` times the spectrum ``(d + 1) ** -0.35``
    over the dims d, so a few directions carry most of the variance, as in
    trained embeddings. ``rows(start, n, stream=0)``, stream 1 the queries."""
    rows = mixture(seed, dim)
    lam = (torch.arange(dim, device="cuda", dtype=torch.float32) + 1.0) ** -PQ_SPECTRUM

    def spec(start, n, stream=0):
        return rows(start, n, stream) * lam

    return spec


def recall10_at(ids, truth, k):
    """recall10@k: the share of the reference's top-10 found in the top-k."""
    return float(np.mean([len(set(a[:k]) & set(t[:10])) / 10 for a, t in zip(ids, truth)]))


def decoded_corpus(pq_ops, codes, table, scale, nbits, chunk=262_144):
    """The rows the PQ kernels score, [N, H] bf16: each code column decoded
    through the kernels' table (K16: bf16(entry x scale[dim]))."""
    tab = pq_ops._decoded_table(table, scale)
    M, _, d = tab.shape
    m_idx = torch.arange(M, device=codes.device)[:, None]
    out = torch.empty(codes.shape[1], M * d, dtype=torch.bfloat16, device=codes.device)
    for s in range(0, codes.shape[1], chunk):
        idx = pq_ops._code_ids(codes[:, s:s + chunk], 1 << nbits)
        out[s:s + chunk] = tab[m_idx, idx].permute(1, 0, 2).reshape(-1, M * d)
    return out


# the CUDA kernels of K15 / K16: the decode pass, then the scoring body
PQ_PASSES = ("pq_decode_kernel", "pq_score_wgmma")
# what the caching allocator may add to the scratch it was asked for (a large block is
# cut from its segment only where more than 1 MiB would be left over)
SCRATCH_SLACK = 2 ** 21


def pq_call_measured(pq_ops, name, q, codes, table, scale, nbits, J, block, n_valid):
    """One ``pq_topj_blocks`` call, measured: the device bytes it held at
    its peak beyond the outputs it returned (the scratch and whatever else it
    allocated, by the caching allocator's count), held to the plan's scratch
    [min(chunk, N), H] bf16 within SCRATCH_SLACK; and its decode and scoring
    launches as its C loop reported them, held to one of each a chunk of the
    plan. Returns (transient bytes, launches a call, chunk rows)."""
    f = pq_ops.pq_topj_blocks
    N, H = codes.shape[1], q.shape[1]
    scoring = ("launches", "launches_4bit", "launches_i8dec")
    dec0, score0 = f.launches_decode, sum(getattr(f, c) for c in scoring)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = f(q, codes, table, J, block, n_valid, scale, nbits)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out
    n_dec, n_score = f.launches_decode - dec0, sum(getattr(f, c) for c in scoring) - score0
    chunk = pq_ops.pq_chunk_rows(N, block)
    planned = min(chunk, N) * H * 2
    check(n_dec == n_score == -(-N // chunk),
          f"{name}: {n_dec} decode and {n_score} scoring launches in a call of "
          f"{-(-N // chunk)} chunks")
    check(transient <= planned + SCRATCH_SLACK,
          f"{name}: a call held {transient} bytes beyond its outputs, the scratch is {planned}")
    return transient, n_score, chunk


def pq_blocks_check(name, pq_ops, q, codes, table, scale, nbits, k, block_size, n_valid):
    """K15 / K16 against its plain version block by block, on the search's own
    codes, queries, block and J: scores rank-wise within 1e-4 relative, each
    kernel id rescored in fp64 under the kernel's formula (bf16 q x the
    decoded bf16 row), so ids differ only at ties. Also the device ms of a
    call's decode passes and scoring launches apart (``kernel_split``) and the
    scratch's measured bytes (``pq_call_measured``). Returns the result row:
    times per call, with the call's launches of each kernel (one a chunk)."""
    from denseretrievaltoolkits_torch.ops.topk import serve_plan

    N = codes.shape[1]
    block, J = serve_plan(k, N, n_valid, block_size)
    qb = q.to(torch.bfloat16)

    def kernel():
        return pq_ops.pq_topj_blocks(qb, codes, table, J, block, n_valid, scale, nbits)

    def plain():
        return pq_ops._pq_topj_reference(qb, codes, table, J, block, n_valid, scale, nbits)

    got, want = kernel(), plain()
    dec = decoded_corpus(pq_ops, codes, table, scale, nbits)
    ok, *err = blocks_against_plain(qb, dec, None, got, want, 1e-4, chunk=16)
    del dec
    fin = want[1] >= 0
    max_abs = float((got[0] - want[0]).abs()[fin].max())
    ms, plain_ms = cuda_ms(kernel, iters=3), cuda_ms(plain, iters=1, warmup=0)
    split = kernel_split(kernel, PQ_PASSES, iters=3)
    # the least time: 2 Q N H bf16 products, or the codes, queries and table
    # read once and the lists written once; the scratch's decoded rows, written
    # and read once, are bytes of this design, not of the function
    Q, H = q.shape
    b_ms, b_by = bound(codes.numel() + 2 * Q * H + table.numel() * table.element_size()
                       + 8 * Q * -(-N // block) * J, 2 * Q * N * H, "bf16")
    scratch_bytes, per_call, chunk = pq_call_measured(pq_ops, name, qb, codes, table, scale,
                                                      nbits, J, block, n_valid)
    decode_ms, score_ms = (split.get(p, 0.0) for p in PQ_PASSES)
    log(f"{name}: kernel {ms:.3f} ms (decode passes {decode_ms:.3f} ms, scoring {score_ms:.3f} "
        f"ms; {per_call} chunks of {chunk} rows, a launch of each a chunk; {scratch_bytes} "
        f"bytes held beyond the outputs) vs plain "
        f"{plain_ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}; the decoded rows written and read "
        f"once {bound(4 * N * H, 0, 'bf16')[0]:.3f} ms); block {block}, J={J}; rank err "
        f"{err[0]:.3g}, rescored err {err[1]:.3g}, {err[2]} ids differing")
    check(ok, f"{name}: the kernel disagrees with its plain version")
    check(decode_ms > 0 and score_ms > 0, f"{name}: the profile shows no decode pass or scoring")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs, "bound_ms": b_ms,
            "bound_by": b_by, "block": block, "J": J, "ids_differing": err[2],
            "decode_ms": decode_ms, "score_ms": score_ms, "chunk_rows": chunk,
            "launches_per_call": per_call, "scratch_peak_bytes": scratch_bytes}


def phase_pq_kernels(seed, flat, pq_ops, n_rows, n_queries=PQ_QUERIES, k=100, dim=768):
    """K15 (8- and 4-bit codes) and K16 through the entry points and block by
    block against their plain versions: ``PQ96`` (8-bit codes, K16 in
    ``PQIndex.search(mode="serve")``, and K15's 8-bit body through
    ``pq_serve_topk`` with the bf16 table) and ``PQ192x4`` (K15 4-bit) over
    n_rows spectrumed mixture rows, trained on PQ_TRAIN_ROWS, 2048 queries,
    k=100. Recall@100 of serve against exact ADC of the same codes, and
    recall10@100 against the certified fp32 flat search of the same rows."""
    rows = spectrumed(seed, dim)
    x = rows(0, n_rows)
    q = rows(0, n_queries, stream=1)
    qn = q.cpu().numpy()
    ref = flat.FlatIPIndex(dim, dtype="float32", device="cuda")
    ref.add_device(x)
    fp32_exact = ref.search(qn, k, mode="exact")[1]
    del ref
    torch.cuda.empty_cache()
    log(f"PQ kernels: {n_rows} x {dim} spectrumed mixture rows (lambda_d = (d + 1)^-"
        f"{PQ_SPECTRUM}), {n_queries} queries, k={k}; codebooks on {PQ_TRAIN_ROWS} rows")
    out = {}
    counters = ("launches", "launches_4bit", "launches_i8dec", "launches_decode")
    for spec, runs in (("PQ96", (("K16", "launches_i8dec"), ("K15 8-bit", "launches"))),
                       ("PQ192x4", (("K15 4-bit", "launches_4bit"),))):
        idx = flat.index_factory(dim, spec, device="cuda")
        t0 = time.perf_counter()
        idx.train(x[:PQ_TRAIN_ROWS])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.add_device(x)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        codes = idx._materialize()
        _, adc = pq_ops.pq_blockwise_topk(q, codes, idx._cb_dev, k, block_size=65536)
        adc = adc.cpu().numpy()
        for name, counter in runs:
            if name == "K15 8-bit":  # the bf16 table through the serve search
                table, scale = pq_ops.bdcb_table(pq_ops.build_bdcb(idx.codebooks))
                table = table.cuda()

                def search():
                    s, i = pq_ops.pq_serve_topk(q, codes, idx._cb_dev, table, k, idx.block_size,
                                                valid=len(idx))
                    return s.cpu().numpy(), i.cpu().numpy()
            else:
                table, scale = idx._table, idx._table_scale

                def search():
                    return idx.search(qn, k, mode="serve")
            for c in counters:
                setattr(pq_ops.pq_topj_blocks, c, 0)
            scans = pq_ops.pq_serve_topk.exact_scans
            search()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PQ_TIMED_SEARCHES):
                _, ids = search()
            search_s = (time.perf_counter() - t0) / PQ_TIMED_SEARCHES
            launches = getattr(pq_ops.pq_topj_blocks, counter)
            decode_launches = pq_ops.pq_topj_blocks.launches_decode
            check(launches > 0 and decode_launches == launches,
                  f"{spec} {name}: the scoring body launched {launches} times, the decode pass "
                  f"{decode_launches}")
            check(pq_ops.pq_serve_topk.exact_scans == scans,
                  f"{spec} {name}: the serve search took the exact scan")
            r = pq_blocks_check(f"{spec} {name}", pq_ops, q, codes, table, scale, idx.nbits, k,
                                idx.block_size, len(idx))
            r.update(launches=launches, decode_launches=decode_launches,
                     search_ms=search_s * 1e3,
                     queries_per_s=n_queries / search_s,
                     recall_vs_adc=overlap(ids.tolist(), adc.tolist()),
                     recall10_vs_fp32=recall10_at(ids, fp32_exact, k), train_s=train_s,
                     build_s=build_s)
            log(f"{spec} {name} serve: {search_s * 1e3:.2f} ms per search "
                f"({r['queries_per_s']:.1f} queries/s); recall@{k} vs exact ADC "
                f"{r['recall_vs_adc']:.5f} (>= {PQ_SERVE_RECALL}); recall10@{k} vs the certified "
                f"fp32 flat search {r['recall10_vs_fp32']:.5f} (>= {PQ_RECALL10[spec]}); trained "
                f"in {train_s:.1f} s, encoded in {build_s:.2f} s; {launches} launches")
            check(r["recall_vs_adc"] >= PQ_SERVE_RECALL, f"{spec} {name}: serve recall@{k} "
                                                         f"vs exact ADC below its bound")
            check(r["recall10_vs_fp32"] >= PQ_RECALL10[spec],
                  f"{spec} {name}: recall10@{k} vs the fp32 flat search below its bound")
            out[name] = r
        out[spec] = {"recall10_vs_fp32_exact_adc": recall10_at(adc, fp32_exact, k)}
        del idx, codes
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return out


# the groups of one bulk IVF-PQ search's kernels, as IVF_SEARCH_GROUPS with K17 the cell kernel
PQ_SEARCH_GROUPS = (("cell kernel (K17)", ("ivf_cell",)),) + IVF_SEARCH_GROUPS[1:]


def pq_cell_call(ivf_pq_ops, inner, q, k):
    """K17's call of ``inner``'s (an IVFPQIndex) last bulk search of q (its
    learned Qcap, hot set and plan), the plain version's, the offset and query
    row of each list, and the data's work."""
    nlist, state = inner.nlist, inner._bulk_state
    qcap = state["qcap"]
    qd, B0 = inner._pad_queries(q)
    ps, poff = ivf_pq_ops.pq_probe_slab(qd, inner.centroids, nlist,
                                        min(inner.nprobe, nlist - int(state["hot"].size)), qcap,
                                        state["hp"], B0)
    block, sel, J = inner._cell_plan(qcap, k)
    filled = ivf_pq_ops.filled_slots(ps, qcap)  # as ivf_pq_search passes them
    args = (inner._block_cell, ps.qslab, inner._values, inner._row_ids, poff, inner._table, J,
            block, sel, inner.nbits, filled)

    def kernel():
        return ivf_pq_ops.ragged_topj_pq(*args)

    def plain():
        return ivf_pq_ops._ivf_pq_topj_reference(ps.qslab, inner._values, inner._row_ids, poff,
                                                 inner._table, inner._block_cell, J, block, sel,
                                                 inner.nbits, filled)
    per = -(-block // sel)
    block_of = inner._block_cell.long()
    list_cell = block_of.repeat_interleave(per)[:, None]
    list_q = (list_cell * qcap + torch.arange(qcap, device="cuda")).reshape(-1)
    slots = torch.bincount(ps.sc[ps.in_cap], minlength=nlist).double()
    rows = torch.bincount(block_of.repeat_interleave(block)[inner._row_ids >= 0], minlength=nlist)
    rows = rows.double() * (slots > 0)
    dim = inner.dim
    lists = float((slots * torch.ceil(rows / sel)).sum())
    n_bytes = (float(rows.sum()) * (inner._values.shape[0] + 4) + float(slots.sum()) * (2 * dim + 4)
               + 4 * block_of.numel() + inner._table.numel() * 2 + 8 * J * lists)
    return {"kernel": kernel, "plain": plain, "ps": ps, "poff": poff.reshape(-1)[list_q],
            "poff_slab": poff,
            "list_q": list_q, "block": block, "sel": sel, "J": J, "slots": filled,
            "bound": bound(n_bytes, 2 * dim * float((slots * rows).sum()), "bf16")}


def phase_pq_scale(seed, flat, pq_ops, ivf_pq_ops, n_queries=PQ_QUERIES, k=100, dim=768):
    """MS MARCO passage's row count of the spectrumed mixture in the JAX
    package's PQ benchmark configurations (bench.py:1051-1059): ``OPQ96,PQ96``
    (serve, K16) and ``OPQ192x4,IVF256,PQ192x4`` (nprobe 8, 2048-row blocks,
    bulk_j 8, max_hot 16; bulk, K17), trained on PQ_TRAIN_ROWS rows and built
    by add_chunks in 500,000-row chunks; queries/s at steady state, recall10@100
    against the certified search of a flat int8 index of the same rows, serve
    recall@100 against exact ADC (flat PQ), K17 against its plain version on
    the search's own slab, build seconds, resident and peak memory."""
    from denseretrievaltoolkits_torch.ops.topk import serve_plan

    rows = spectrumed(seed, dim)
    q = rows(0, n_queries, stream=1)
    qn = q.cpu().numpy()
    t0 = time.perf_counter()
    ref = flat.FlatIPIndex(dim, dtype="int8", device="cuda")
    for start in range(0, SCALE_ROWS, SLAB_ROWS):
        ref.add_device(rows(start, min(SLAB_ROWS, SCALE_ROWS - start)))
    truth = ref.search(qn, k, mode="exact")[1]
    ref_s = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    log(f"scale PQ: {SCALE_ROWS} x {dim} spectrumed mixture rows; the certified int8 flat "
        f"reference built and searched in {ref_s:.1f} s")
    res = {}
    for spec, mode in SCALE_PQ_SPECS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        index = flat.index_factory(dim, spec, nprobe=SCALE_PQ_NPROBE, device="cuda")
        inner = index.inner
        ivfpq = mode == "bulk"
        if ivfpq:
            inner.block, inner.bulk_j = SCALE_IVF_BLOCK, SCALE_PQ_BULK_J
            inner.max_hot = SCALE_PQ_MAX_HOT
        t0 = time.perf_counter()
        index.train(rows(0, PQ_TRAIN_ROWS))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index.add_chunks(rows, SCALE_ROWS, chunk_rows=SCALE_IVF_CHUNK)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        resident_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
        fn, counter = ((ivf_pq_ops.ragged_topj_pq, "launches") if ivfpq else
                       (pq_ops.pq_topj_blocks, "launches_i8dec" if inner.nbits == 8
                        else "launches_4bit"))
        setattr(fn, counter, 0)
        pq_ops.pq_topj_blocks.launches_decode = 0
        scans = pq_ops.pq_serve_topk.exact_scans
        index.search(qn, k, mode=mode)  # the tuning call (IVF-PQ: Qcap, hot set)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IVF_TIMED_SEARCHES):
            _, ids = index.search(qn, k, mode=mode)
        secs = (time.perf_counter() - t0) / IVF_TIMED_SEARCHES
        launches = getattr(fn, counter)
        check(launches > 0, f"scale {spec}: its kernel never launched")
        if not ivfpq:  # K16: one decode pass a scoring launch
            check(pq_ops.pq_topj_blocks.launches_decode == launches,
                  f"scale {spec}: {pq_ops.pq_topj_blocks.launches_decode} decode passes for "
                  f"{launches} scoring launches")
        check(pq_ops.pq_serve_topk.exact_scans == scans, f"scale {spec}: took the exact scan")
        r = {"train_s": train_s, "build_s": build_s, "resident_gib": resident_gib,
             "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
             "seconds": secs, "queries_per_s": n_queries / secs, "launches": launches,
             "recall10_vs_int8_flat": recall10_at(ids, truth, k)}
        qt = index.transform.apply(q)
        if ivfpq:
            state = inner._bulk_state
            r.update(qcap=state["qcap"], hot=state["hot"].tolist(), side_rows=state["side"][3],
                     dropped=inner.last_dropped)
            call = pq_cell_call(ivf_pq_ops, inner, qt, k)
            got, want = call["kernel"](), call["plain"]()
            dec = decoded_corpus(pq_ops, inner._values, inner._table, None, inner.nbits)
            n_lists, J = got[0].shape[0] * got[0].shape[1], got[0].shape[2]
            ok, *err = blocks_against_plain(
                call["ps"].qslab.reshape(-1, dim), dec, None,
                tuple(t.reshape(n_lists, 1, J) for t in got),
                tuple(t.reshape(n_lists, 1, J) for t in want), 1e-4, chunk=8192,
                list_q=call["list_q"], stored=inner._row_ids >= 0, list_off=call["poff"])
            del dec
            fin = want[1] >= 0
            # the body that ran (ivf_cell.cu's, not block_topj.cu's), and one search under
            # torch.profiler: K17, the side scan, the merges
            body = kernel_split(call["kernel"], ("ivf_cell_wgmma", "block_topj"), iters=3)
            check("block_topj" not in body and (not body or "ivf_cell_wgmma" in body),
                  f"scale {spec}: K17 ran CUDA kernels {sorted(body)}")
            from denseretrievaltoolkits_torch.ops import ivf_bulk
            search = searched(ivf_bulk, lambda: index.search(qn, k, mode=mode), PQ_SEARCH_GROUPS)
            log(f"scale {spec} search under torch.profiler: wall {search['wall_ms']:.2f} ms, "
                f"device {search['device_ms']:.2f} ms (busy {search['busy']:.3f}), by group "
                f"{json.dumps({g: round(ms, 3) for g, ms in search['groups_ms'].items()})}; side "
                f"scans (rows, block, J) {search['side_scans']}")
            r.update(body=",".join(sorted(body)), search_split=search,
                     filled_slots=int(call["slots"].sum()))
            r.update(kernel_ms=cuda_ms(call["kernel"], iters=3),
                     plain_ms=cuda_ms(call["plain"], iters=1, warmup=0),
                     max_abs_err=float((got[0] - want[0]).abs()[fin].max()),
                     bound_ms=call["bound"][0], bound_by=call["bound"][1], J=call["J"],
                     sel=call["sel"], ids_differing=err[2])
            log(f"scale {spec} K17 ({r['body']}): kernel {r['kernel_ms']:.3f} ms vs plain "
                f"{r['plain_ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by {r['bound_by']}), "
                f"J={call['J']} over selection blocks of {call['sel']}, {r['filled_slots']} "
                f"filled slots; rank err {err[0]:.3g}, rescored err {err[1]:.3g}, "
                f"{err[2]} ids differing; Qcap {state['qcap']}, hot cells {state['hot'].tolist()}, "
                f"side slab {state['side'][3]} rows, {inner.last_dropped} pairs dropped")
            check(ok, f"scale {spec}: K17 disagrees with its plain version")
        else:
            n_rows, codes = len(inner), inner._materialize()
            block, J = serve_plan(k, n_rows, n_rows, inner.block_size)
            scratch_bytes, per_call, chunk = pq_call_measured(
                pq_ops, f"scale {spec}", qt.to(torch.bfloat16), codes, inner._table,
                inner._table_scale, inner.nbits, J, block, n_rows)
            r.update(chunk_rows=chunk, launches_per_call=per_call,
                     scratch_peak_bytes=scratch_bytes)
            _, adc = pq_ops.pq_blockwise_topk(qt, codes, inner._cb_dev, k, block_size=65536)
            r["recall_vs_adc"] = overlap(ids.tolist(), adc.cpu().numpy().tolist())
            check(r["recall_vs_adc"] >= PQ_SERVE_RECALL,
                  f"scale {spec}: serve recall@{k} vs exact ADC below its bound")
        log(f"scale {spec} {mode}: {n_queries} queries k={k} in {secs:.4f} s "
            f"({r['queries_per_s']:.1f} queries/s); recall10@{k} vs the certified int8 flat search "
            f"{r['recall10_vs_int8_flat']:.5f}"
            + (f", recall@{k} vs exact ADC {r['recall_vs_adc']:.5f}; a call held "
               f"{r['scratch_peak_bytes']} bytes beyond its outputs ({r['launches_per_call']} "
               f"chunks of {r['chunk_rows']} rows)" if not ivfpq else "")
            + f"; trained in {train_s:.1f} s, add_chunks {build_s:.1f} s; {resident_gib:.2f} GiB "
              f"resident, peak {r['peak_gib']:.2f} GiB (build and search); {launches} launches")
        check(r["recall10_vs_int8_flat"] >= SCALE_PQ_RECALL10[spec],
              f"scale {spec}: recall10@{k} below {SCALE_PQ_RECALL10[spec]}")
        res[spec] = r
        del index, inner
        torch.cuda.empty_cache()
    return res


def plain_encoder_pq96_gaps(args, tmp):
    """PQ96's largest metric gap to the float32 flat ranking, serve and exact, on
    the plain encoder: phase 11's model, data and seed, trained and encoded with
    the plain versions of K1, K2 and K3 / K4 (``plain_encoder``), then evaluated
    in float32 and in PQ96 as phases 11 and 18 evaluate. What phase 18 holds the
    kernels' gaps to."""
    factory, nprobe, modes, ep = EVAL_PQ_CASES[0]
    t0 = time.perf_counter()
    with plain_encoder():
        trainer, targs, query_loader, *_ = eval_trainer(args, tmp, "eval-plain")
        trainer.train()
        targs.index_dtype, targs.search_mode = "float32", "exact"
        fm = trainer.evaluate(query_loader, 102)
        targs.index_factory, targs.nprobe = factory, nprobe
        gaps = {}
        for mode in modes:
            targs.search_mode = mode
            m = trainer.evaluate(query_loader, ep)
            gaps[mode] = max(abs(m[x] - fm[x]) for x in fm if x != "query_num")
    log(f"plain encoder (K1, K2 and K3 / K4 plain, seed {args.seed}): {factory} vs its float32 "
        f"flat exact ranking, largest metric gap " + ", ".join(
            f"{mode} {g:.4f}" for mode, g in gaps.items()) + f" (<= {PQ_METRIC_GAP[factory]}); "
        f"{time.perf_counter() - t0:.1f} s")
    for mode, g in gaps.items():
        check(g <= PQ_METRIC_GAP[factory],
              f"{factory} {mode} on the plain encoder: metrics too far from float32")
    del trainer
    torch.cuda.empty_cache()
    return gaps


def phase_pq_eval_path(args, tmp, ctx, plain_gaps):
    """The evaluation path into the product-quantized indexes: the evaluation
    phase's bert-base, ``Trainer.evaluate`` with ``index_factory`` "PQ96" in
    serve (K16) and exact, then "IVF16,PQ96x4" (nprobe 4) in bulk (K17, and
    the side slab of hot cells on K7 / K8). Each encodes (K1, K2), spills,
    trains, builds through add_chunks and searches. The plain versions over
    the same reps must agree; ``retrieval.main --index_path`` on each saved
    index must rank as the trainer did. PQ96's metric gap to the float32
    ranking must lie within PQ96_GAP_VS_PLAIN of ``plain_gaps``
    (``plain_encoder_pq96_gaps``); IVF16,PQ96x4's is held to PQ_METRIC_GAP."""
    from denseretrievaltoolkits_torch.evaluator import retrieval
    from denseretrievaltoolkits_torch.index import ivf_pq as ivf_pq_index
    from denseretrievaltoolkits_torch.index import pq as pq_index
    from denseretrievaltoolkits_torch.ops import attn, ivf_bulk, ivf_pq, pq, quant, topk

    trainer, targs, query_loader = ctx["trainer"], ctx["targs"], ctx["query_loader"]
    counted = {"fused_attention_ln": (attn.fused_attention_ln, "launches"),
               "fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
               "pq_topj_blocks (K16)": (pq.pq_topj_blocks, "launches_i8dec"),
               "pq_topj_blocks (decode pass)": (pq.pq_topj_blocks, "launches_decode"),
               "ragged_topj_pq (K17)": (ivf_pq.ragged_topj_pq, "launches"),
               "quantize_int8_device": (quant.quantize_int8_device, "launches"),
               "block_topj_serve": (topk.block_topj_serve, "launches")}
    fm, franked = ctx["float32_metrics"], ctx["float32_ranked"]
    out = {}
    for factory, nprobe, modes, ep in EVAL_PQ_CASES:
        targs.index_factory, targs.nprobe = factory, nprobe
        for fn, attr in counted.values():
            setattr(fn, attr, 0)
        scans = pq.pq_serve_topk.exact_scans
        runs = {}
        for mode in modes:
            targs.search_mode = mode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.evaluate(query_loader, ep)  # the first encodes, trains and builds
            torch.cuda.synchronize()
            runs[mode] = (m, *read_dump(targs, ep), time.perf_counter() - t0)
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}
        index = trainer.index
        ivfpq = factory.startswith("IVF")
        side_rows = index._bulk_state["side"][3] if ivfpq else 0
        log(f"PQ evaluation path: {factory}{f', nprobe {nprobe}' if ivfpq else ''}, {len(index)} "
            f"passages; " + (f"Qcap {index._bulk_state['qcap']}, hot cells "
                             f"{index._bulk_state['hot'].tolist()}, side slab {side_rows} rows; "
                             if ivfpq else "") + f"launches {json.dumps(launches)}")
        need = ["fused_attention_ln", "fused_mlp_ln"] + (
            ["ragged_topj_pq (K17)"] + (["quantize_int8_device", "block_topj_serve"]
                                        if side_rows else []) if ivfpq
            else ["pq_topj_blocks (K16)", "pq_topj_blocks (decode pass)"])
        for name in need:
            check(launches[name] > 0, f"PQ evaluation path {factory}: {name} never launched")
        if not ivfpq:
            check(launches["pq_topj_blocks (decode pass)"] == launches["pq_topj_blocks (K16)"],
                  f"PQ evaluation path {factory}: the C loop made unequal decode and scoring "
                  f"launches")
        check(pq.pq_serve_topk.exact_scans == scans, f"{factory}: the serve search took the scan")
        for mode, (m, ranked, n_rows, secs) in runs.items():
            log(f"{factory} {mode}: {secs:.2f} s; dump {n_rows} rows; metrics "
                f"{json.dumps({x: round(v, 5) for x, v in m.items()})}")
            check(m["query_num"] == args.queries and all(math.isfinite(v) for v in m.values()),
                  f"{factory} {mode}: metrics")
            check(len(ranked) == args.queries and n_rows >= 0.99 * args.queries * args.k,
                  f"{factory} {mode}: retrieval dump length")

        # the plain versions over the same reps: the index rebuilt from the
        # spilled corpus on the same trained state, searched by the same evaluate
        reps = torch.from_numpy(np.load(os.path.join(targs.encode_corpus_dir,
                                                     f"{ep}.0.npy"))).cuda()
        if ivfpq:
            plain = {ivf_pq: {"ragged_topj_pq": lambda bc, qs, c, rid, po, tab, J, blk, sel, nb,
                              slots=None: ivf_pq._ivf_pq_topj_reference(
                                  qs, c, rid, po, tab, bc, J, blk, sel, nb, slots)},
                     ivf_pq_index: {"quantize_int8_device": quant._quantize_int8_reference},
                     ivf_bulk: {"block_topj_serve": topk._block_topj_serve_reference}}
            plain_index = ivf_pq_index.IVFPQIndex(reps.shape[1], nlist=index.nlist,
                                                  nprobe=index.nprobe, M=index.M,
                                                  nbits=index.nbits, block=index.block,
                                                  device="cuda")
            plain_index.centroids = index.centroids
        else:
            plain = {pq: {"pq_topj_blocks": pq._pq_topj_reference}}
            plain_index = pq_index.PQIndex(reps.shape[1], M=index.M, nbits=index.nbits,
                                           block_size=index.block_size, device="cuda")
        summary = {}
        with plain_versions_of(plain):
            plain_index.codebooks = index.codebooks
            plain_index._set_codebooks()
            plain_index.add_chunks(lambda s, r: reps[s:s + r], reps.shape[0],
                                   chunk_rows=max(1, min(reps.shape[0], targs.index_slab_rows)))
            stored = index._values if ivfpq else index._materialize()
            same = bool(torch.equal(plain_index._values if ivfpq
                                    else plain_index._materialize(), stored))
            plain_index.docid = index.docid
            trainer.index, trainer._indexed_ep = plain_index, ep + 100
            for mode in modes:
                targs.search_mode = mode
                m = trainer.evaluate(query_loader, ep + 100)
                ranked = read_dump(targs, ep + 100)[0]
                km, kranked = runs[mode][0], runs[mode][1]
                vs_plain = overlap([kranked[x] for x in sorted(kranked)],
                                   [ranked[x] for x in sorted(kranked)])
                gap = max(abs(km[x] - m[x]) for x in m if x != "query_num")
                vs_fp32 = overlap([kranked[x] for x in sorted(kranked)],
                                  [franked[x] for x in sorted(kranked)])
                gap32 = max(abs(km[x] - fm[x]) for x in fm if x != "query_num")
                if factory == "PQ96":
                    low, limit = (plain_gaps[mode] - PQ96_GAP_VS_PLAIN,
                                  plain_gaps[mode] + PQ96_GAP_VS_PLAIN)
                    limit_of = (f"within {PQ96_GAP_VS_PLAIN:g} of the plain encoder's "
                                f"{plain_gaps[mode]:.4f}")
                else:
                    low, limit = 0.0, PQ_METRIC_GAP[factory]
                    limit_of = f"<= {limit:g}"
                log(f"{factory} {mode}, kernels vs plain versions over the same reps: top-{args.k} "
                    f"overlap {vs_plain:.5f} (>= {PQ_VS_PLAIN}), largest metric gap {gap:.4f} (<= "
                    f"{PQ_PLAIN_METRIC_GAP}); vs the float32 flat exact ranking: overlap "
                    f"{vs_fp32:.5f} (>= {PQ_VS_FP32[factory]}), largest metric gap {gap32:.4f} "
                    f"({limit_of})")
                check(vs_plain >= PQ_VS_PLAIN and gap <= PQ_PLAIN_METRIC_GAP,
                      f"{factory} {mode}: the kernels disagree with their plain versions")
                check(vs_fp32 >= PQ_VS_FP32[factory] and low <= gap32 <= limit,
                      f"{factory} {mode}: ranking too far from float32")
                summary[mode] = {"metrics": km, "seconds": runs[mode][3],
                                 "overlap_vs_plain": vs_plain, "metric_gap_vs_plain": gap,
                                 "overlap_vs_fp32": vs_fp32, "metric_gap_vs_fp32": gap32,
                                 "metric_gap_limits": (low, limit)}
        log(f"{factory}: the codes the plain build stores equal the kernel path's: {same}")
        check(same, f"{factory}: the plain build stores other codes")
        del plain_index, reps

        # the retrieval CLI on the saved index
        cli_path = os.path.join(tmp, f"ranking_{ep}_cli.tsv")
        retrieval.main(["--index_path", targs.index_file + str(ep), "--query_reps",
                        ctx["q_path"], "--search_mode", modes[0], "--depth", str(args.k),
                        "--batch_size", str(args.batch), "--save_ranking_to", cli_path,
                        "--save_text"])
        cli = {}
        with open(cli_path) as fh:
            for line in fh:
                qid, did, _ = line.split("\t")
                cli.setdefault(qid, []).append(did)
        kranked = runs[modes[0]][1]
        vs_cli = overlap([kranked[x] for x in sorted(kranked)], [cli[x] for x in sorted(kranked)])
        log(f"retrieval.main --index_path <{factory}> --search_mode {modes[0]}: top-{args.k} "
            f"overlap with the trainer's ranking {vs_cli:.5f} (>= 0.999)")
        check(vs_cli >= 0.999, f"retrieval.main on the saved {factory} index disagrees")
        out[factory] = {"launches": launches, "modes": summary, "side_rows": side_rows,
                        "cli_overlap": vs_cli}
        trainer.index = None
        torch.cuda.empty_cache()
    return out

# The optimizers written to optax's formulas (phase 28): bert-base bf16 'fused', 32 x 8,
# S=128; a warm-up step and 3 timed steps each; step 1's update on a sample of tensors
# (the word embeddings and one layer's wi, both factored by adafactor, and one LN bias)
# held to the optimizer's formula evaluated in float64 on the host: within OPT_REL of
# the update, plus half an fp32 ulp of the parameter (the update's rounding into it).
OPT_NAMES, OPT_TIMED_STEPS, OPT_REL = ("adagrad", "rmsprop", "adafactor"), 3, 1e-5
OPT_LR = TRAIN_LR


def opt_reference(name, p, g, lr):
    """Step 1's new parameter by ``name``'s optax formula at its defaults, float64."""
    p, g = p.astype(np.float64), g.astype(np.float64)
    if name == "adagrad":
        acc = 0.1 + g * g
        return p - lr * g * np.where(acc > 0, 1 / np.sqrt(acc + 1e-7), 0.0)
    if name == "rmsprop":
        return p - lr * g / np.sqrt(0.1 * g * g + 1e-8)
    g2 = g * g + 1e-30  # adafactor, step 0: decay 1 - 1^-0.8 = 0
    if p.ndim >= 2 and sorted(p.shape)[-2] >= 128:
        order = np.argsort(p.shape)
        d1, d0 = int(order[-2]), int(order[-1])
        v_row, v_col = g2.mean(axis=d0), g2.mean(axis=d1)
        row = (v_row / v_row.mean(axis=d1 - 1 if d1 > d0 else d1, keepdims=True)) ** -0.5
        u = g * np.expand_dims(row, d0) * np.expand_dims(v_col ** -0.5, d1)
    else:
        u = g * g2 ** -0.5
    u = u / max(1.0, float(np.sqrt(np.mean(u * u))))
    return p - lr * u * max(float(np.sqrt(np.mean(p * p))), 1e-3)


def phase_optimizers(args, tmp):
    """Phase 28: adagrad, rmsprop and adafactor through ``Trainer`` on the card."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.ops import contrastive as con

    margs = train_model_args(tmp, "opt")
    batch = train_batch(np.random.default_rng(args.seed + 28), TRAIN_BATCH)
    counted = (con.contrastive_fwd, con.contrastive_bwd_dq, con.contrastive_bwd_dp)
    model = DRModel.build(margs, device="cuda", seed=args.seed)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    for name in OPT_NAMES:  # each from the same initial weights
        model.load_state_dict(init)
        for prm in model.parameters():
            prm.grad = None
        trainer = step_trainer(tmp, f"opt-{name}", model, optimizer=name, learning_rate=OPT_LR)
        lm = trainer.model.lm_q
        named = dict(lm.named_parameters())
        # the word embeddings [30522, 768] and layer 0's wi [768, 3072] (both factored by
        # adafactor), and the embeddings' LN bias
        sample = ["embeddings.word", "layers.0.wi_kernel", "embeddings.ln_bias"]
        before = {k: named[k].detach().float().cpu().numpy().copy() for k in sample}
        for fn in counted:
            fn.launches = 0
        loss1 = float(trainer.train_step(batch))
        errs = {}
        for k in sample:
            prm = named[k]
            got = prm.detach().float().cpu().numpy().astype(np.float64)
            want = opt_reference(name, before[k], prm.grad.float().cpu().numpy(), OPT_LR)
            delta = np.abs(want - before[k])
            ulp = np.spacing(np.abs(got).astype(np.float32)).astype(np.float64) / 2
            excess = np.abs(got - want) - ulp
            errs[k] = float(np.max(excess / np.maximum(delta, 1e-30)))
            check(np.all(excess <= OPT_REL * np.maximum(delta, np.max(delta) * 1e-3)),
                  f"phase 28: {name} step 1's update of {k} disagrees with optax's formula "
                  f"(worst {errs[k]:.3e} of the update)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(trainer.train_step(batch)) for _ in range(OPT_TIMED_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        out[name] = {"step1_loss": loss1, "losses": losses, "steps_per_s": OPT_TIMED_STEPS / dt,
                     "sampled": sample, "step1_worst_rel": errs, "launches": launches}
        log(f"phase 28 {name}: step-1 loss {loss1:.5f}, then {json.dumps(losses)}; "
            f"{OPT_TIMED_STEPS / dt:.2f} steps/s; step-1 update vs float64 formula, worst "
            f"share {json.dumps(errs)}; launches {json.dumps(launches)}")
        check(all(math.isfinite(x) for x in [loss1] + losses), f"phase 28: {name} loss not finite")
        check(all(n == 1 + OPT_TIMED_STEPS for n in launches.values()),
              f"phase 28: {name}: K3 / K4 launches {launches}, not one a step")
        del trainer
    del model, init
    torch.cuda.empty_cache()
    return out


# Data parallelism and sharding (phase 29): worker processes of this script
# (``--dist_worker``), each printing one JSON line of readings and launch counts; the
# parent checks them. (a) NCCL, one rank: a mesh step bit-equal to the step without a
# mesh. (b)-(d) gloo, two ranks sharing cuda:0 (NCCL refuses a card twice).
DIST_TIMEOUT_S = 420
DIST_LAYERS = 4  # the data-parallel worlds' bert-base depth (widths unchanged)
DIST_ROWS, DIST_QUERIES, DIST_K = 1_000_000, 1024, 100
DIST_SERVE_RECALL, DIST_I8Q_RECALL = 0.999, 0.97  # phase 7's bounds (PERF.md §2)
DIST_EVAL_KINDS = (("flat", dict(index_dtype="float32", search_mode="exact")),
                   ("IVF16,SQ8", dict(index_factory="IVF16,SQ8", nprobe=4, search_mode="bulk")),
                   ("PQ96", dict(index_factory="PQ96", nprobe=32, search_mode="serve")),
                   ("PQ192x4", dict(index_factory="PQ192x4", nprobe=32, search_mode="serve")),
                   ("IVF16,PQ96x4", dict(index_factory="IVF16,PQ96x4", nprobe=4,
                                         search_mode="bulk")),
                   ("PCAR384,SQ8", dict(index_factory="PCAR384,SQ8", search_mode="exact")))
# the trained kinds' mesh evaluation against the one-process one on the same reps: the
# int8 path's kernel-vs-plain bars (phases 15 / 18): top-100 overlap and metric gap. The
# sharded IVF index is ragged, as the JAX package's: the one-card factory's IVF16,SQ8 is
# the fixed-capacity index (K13), so the mesh's IVF16,SQ8 is held to IVFR16,SQ8 in one
# process by these bars, and to IVF16,SQ8 by phase 15's (against float32 flat)
DIST_EVAL_OVERLAP, DIST_EVAL_GAP = 0.999, 0.004
DIST_EVAL_REFERENCE = {"IVF16,SQ8": "IVFR16,SQ8"}


def _counters():
    """Every wrapper counter of the kernels phase 29 runs, by kernel."""
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, ivf_bulk, ivf_pq, pq, \
        quant, topk

    return {"K1 fused_attention_ln": (attn.fused_attention_ln, "launches"),
            "K2 fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
            "K3 contrastive_fwd": (con.contrastive_fwd, "launches"),
            "K4 contrastive_bwd_dq": (con.contrastive_bwd_dq, "launches"),
            "K4 contrastive_bwd_dp": (con.contrastive_bwd_dp, "launches"),
            "K5 block_topj": (topk.block_topj, "launches"),
            "K6 block_topj int8": (topk.block_topj, "launches_int8"),
            "K7 quantize_int8_device": (quant.quantize_int8_device, "launches"),
            "K8 block_topj_serve": (topk.block_topj_serve, "launches"),
            "K12 block_topj_i8q": (topk.block_topj_i8q, "launches"),
            "K13 cell_topj": (ivf_bulk.cell_topj, "launches_int8"),
            "K14 ragged_topj": (ivf_bulk.ragged_topj, "launches_int8"),
            "K15 pq_topj_blocks 4-bit": (pq.pq_topj_blocks, "launches_4bit"),
            "K16 pq_topj_blocks int8 codebook": (pq.pq_topj_blocks, "launches_i8dec"),
            "K17 ragged_topj_pq": (ivf_pq.ragged_topj_pq, "launches")}


def read_counts(reset=False):
    out = {}
    for name, (fn, attr) in _counters().items():
        out[name] = int(getattr(fn, attr, 0))
        if reset:
            setattr(fn, attr, 0)
    return out


def _digest(*tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)
                 .tobytes())
    return h.hexdigest()


def _params_digest(model):
    return _digest(*[p.detach() for p in model.parameters()])


def dist_nccl_step(args, tmp, mesh):
    """(a) One rank over NCCL: a ``Trainer(mesh=...)`` step against the same step
    without a mesh, on bert-base 32 x 8 from the same seed."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    margs = train_model_args(tmp, "nccl", layers=DIST_LAYERS)
    batch = train_batch(np.random.default_rng(args.seed + 29), TRAIN_BATCH)
    out = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        model = DRModel.build(margs, device="cuda", seed=args.seed)
        trainer = step_trainer(tmp, f"nccl-{label}", model, mesh=m)
        read_counts(reset=True)
        loss, grad = step_grads(trainer, batch)
        out[label] = {"loss": loss, "grad": _digest(grad), "params": _params_digest(model),
                      "launches": read_counts()}
        del trainer, model, grad
        torch.cuda.empty_cache()
    return out


def dist_gloo(args, tmp, mesh):
    """(b)-(d) on two gloo ranks sharing cuda:0. One model, reset to its initial weights
    before each part; the one-process references split over the ranks (rank 0 the 32 x 8
    step, rank 1 the 64 x 8 one), each compared on the rank that ran it (the mesh's
    gradients are the same on both)."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    r, w = mesh.rank, mesh.size
    out = {"rank": r}
    # the collectives gloo takes on CUDA tensors (every later part needs them)
    x = torch.full((4,), float(r + 1), device="cuda")
    probe = {"all_gather": torch.cat(mesh.all_gather(x)).tolist(),
             "all_reduce": mesh.all_sum_(x.clone()).tolist()}
    y = x.clone()
    torch.distributed.broadcast(y, 0)
    probe["broadcast"] = y.tolist()
    out["gloo_cuda"] = probe

    def rows(b, n):
        return {k: v[r * n:(r + 1) * n] for k, v in b.items()}

    model = DRModel.build(train_model_args(tmp, f"gloo{r}", layers=DIST_LAYERS), device="cuda",
                          seed=args.seed)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def fresh():
        model.load_state_dict(init)
        for prm in model.parameters():
            prm.grad = None
        return model

    # (b) the data-parallel step at a global 32 x 8 (16 x 8 a rank); grad-cache at 64 x 8
    batch = train_batch(np.random.default_rng(args.seed + 29), TRAIN_BATCH)
    local = (rows(batch[0], TRAIN_BATCH // w), rows(batch[1], TRAIN_BATCH * 8 // w))
    big = train_batch(np.random.default_rng(args.seed + 30), GC_AGREE_QUERIES)
    big_local = (rows(big[0], GC_AGREE_QUERIES // w), rows(big[1], GC_AGREE_QUERIES * 8 // w))
    ref_loss, ref_grad = step_grads(step_trainer(tmp, f"dist-ref-{r}", fresh()),
                                    batch if r == 0 else big)
    trainer = step_trainer(tmp, f"dist-{r}", fresh(), mesh=mesh)
    read_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grad = step_grads(trainer, local)
    losses = [loss] + [float(trainer.train_step(local)) for _ in range(2)]
    torch.cuda.synchronize()
    out["dp"] = {"losses": losses, "steps_per_s": 3 / (time.perf_counter() - t0),
                 "params": _params_digest(model), "launches": read_counts()}
    if r == 0:
        out["dp"]["vs_one_process"] = grad_agreement(loss, grad, ref_loss, ref_grad)
    del trainer, grad
    # negatives_x_device off: the mean of the two ranks' own 16 x 8 losses
    fresh()
    with torch.no_grad():
        own = float(model(*local)["loss"])
    trainer = step_trainer(tmp, f"dist-local-{r}", model, mesh=mesh, negatives_x_device=False)
    out["local"] = {"own_loss": own, "mesh_loss": float(trainer.train_step(local))}
    # grad-cache under the mesh, chunks 16 / 128
    trainer = step_trainer(tmp, f"dist-gc-{r}", fresh(), mesh=mesh, grad_cache=True,
                           gc_q_chunk_size=GC_AGREE_CHUNKS[0], gc_p_chunk_size=GC_AGREE_CHUNKS[1])
    read_counts(reset=True)
    loss, grad = step_grads(trainer, big_local)
    out["gc"] = {"loss": loss, "launches": read_counts()}
    if r == 1:
        out["gc"]["vs_one_process"] = grad_agreement(loss, grad, ref_loss, ref_grad)
    del trainer, grad, ref_grad
    torch.cuda.empty_cache()
    out["search"] = dist_search(args, mesh)
    torch.cuda.empty_cache()
    out["eval"] = dist_eval(args, tmp, mesh, fresh())  # phase 11's seed, DIST_LAYERS deep
    return out


TP_LAYERS = 2  # the tensor-parallel case's bert-base depth (widths unchanged)
# fp32: the model axis changes the order of the row-parallel products' sums, and in bf16 that
# alone moves a random-weight step's gradient to a cosine of 0.986 (a CPU rehearsal), the
# bf16-vs-fp32 level (phase 22's); in fp32 the sums' order is all that differs
TP_DTYPE = "float32"
# (attention, queries, passage length) of the tensor-parallel steps: 8 passages a query
TP_STEPS = (("xla", 16, 128), ("fused", 16, 128), ("flash", 8, 512))
# the fp32 steps and adafactor's step-1 update on the mesh against one process's: loss rel,
# gradient (update) cosine, norm ratio's distance from 1. Only the order of the model
# group's fp32 sums differs; the first chip run read loss rel <= 9.3e-6, cosines
# >= 0.9999999 and norm ratios within 4.3e-5 of 1
TP_LOSS_REL, TP_GRAD_COS, TP_GRAD_NORM = 1e-4, 0.99999, 1e-3


def full_grads(model):
    """The flat fp32 gradient of every parameter, each cut leaf's parts gathered over the
    model group: one process's layout."""
    from denseretrievaltoolkits_torch.parallel.mesh import param_shard

    parts = []
    for p in model.parameters():
        if p.grad is not None:
            spec = param_shard(p)
            g = p.grad if spec is None else spec.join(p.tp_mesh.model_gather(p.grad))
            parts.append(g.flatten().float())
    return torch.cat(parts)


def _tp_counters():
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, flash

    return {"K1 fused_attention_ln": attn.fused_attention_ln, "K2 fused_mlp_ln": attn.fused_mlp_ln,
            "K3 contrastive_fwd": con.contrastive_fwd,
            "K4 contrastive_bwd_dq": con.contrastive_bwd_dq,
            "K4 contrastive_bwd_dp": con.contrastive_bwd_dp, "F-fwd flash_fwd": flash.flash_fwd,
            "F-dkv flash_bwd_dkv": flash.flash_bwd_dkv, "F-dq flash_bwd_dq": flash.flash_bwd_dq}


def dist_tp(args, tmp, mesh):
    """(e) Tensor parallelism on two gloo ranks sharing cuda:0, tp = 2 (``make_mesh(1, 2)``):
    bert-base widths at TP_LAYERS in TP_DTYPE, each BERT layer cut over the model axis. One
    step each on 'xla', 'fused' (K1 / K2 on the gathered weights) and 'flash' (S=512)
    against the same step in one process (rank 0 runs it), then one adafactor step against
    one process's update, then ``Trainer.save`` (the parts gathered) reloaded by
    ``DRModel.build`` in this process."""
    from denseretrievaltoolkits_torch.config import ModelArguments
    from denseretrievaltoolkits_torch.models.biencoder import DRModel
    from denseretrievaltoolkits_torch.parallel.mesh import gathered

    r = mesh.tp_rank
    out = {"rank": r, "mesh": mesh.shape}
    rng = np.random.default_rng(args.seed + 31)
    counters = _tp_counters()
    for attention, nq, p_len in TP_STEPS:
        batch = train_batch(rng, nq, p_len=p_len)
        margs = train_model_args(tmp, f"tp-{attention}", layers=TP_LAYERS, attention=attention,
                                 dtype=TP_DTYPE)
        if r == 0:
            ref = step_grads(step_trainer(tmp, f"tp-ref-{attention}", DRModel.build(
                margs, device="cuda", seed=args.seed)), batch)
        model = DRModel.build(margs, device="cuda", seed=args.seed)
        trainer = step_trainer(tmp, f"tp-{attention}-{r}", model, mesh=mesh)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batch))
        torch.cuda.synchronize()
        item = {"loss": loss, "seconds": time.perf_counter() - t0,
                "launches": {k: fn.launches for k, fn in counters.items()},
                "queries": nq, "p_len": p_len}
        grad = full_grads(model)
        item["grad"] = _digest(grad)
        if r == 0:
            item["vs_one_process"] = grad_agreement(loss, grad, *ref)
            del ref
        out[attention] = item
        del trainer, model, grad
        torch.cuda.empty_cache()
    # one adafactor step (its factored moments, clip and parameter RMS summed over the
    # model group) against one process's update from the same weights
    batch = train_batch(rng, 16)
    margs = train_model_args(tmp, "tp-adafactor", layers=TP_LAYERS, attention="fused",
                             dtype=TP_DTYPE)

    def update(mesh_or_none, label):
        model = DRModel.build(margs, device="cuda", seed=args.seed)
        trainer = step_trainer(tmp, label, model, mesh=mesh_or_none, optimizer="adafactor")
        with gathered(model):
            before = torch.cat([p.detach().flatten().float().clone()
                                for p in model.parameters()])
        loss = float(trainer.train_step(batch))
        with gathered(model):
            after = torch.cat([p.detach().flatten().float() for p in model.parameters()])
        return trainer, loss, after - before

    if r == 0:
        _, ref_loss, ref_update = update(None, "tp-adafactor-ref")
    trainer, loss, upd = update(mesh, f"tp-adafactor-{r}")
    out["adafactor"] = {"loss": loss, "update": _digest(upd)}
    if r == 0:
        out["adafactor"]["vs_one_process"] = grad_agreement(loss, upd, ref_loss, ref_update)
    # the deploy format of a tensor-parallel run, read back in this process
    trainer.save(1)
    with gathered(trainer.model):  # a collective: every rank
        full = [v.detach().clone() for v in trainer.model.state_dict().values()]
    if r == 0:
        saved = os.path.join(trainer.training_args.cache_train_dir, "result1")
        back = DRModel.build(ModelArguments(model_name_or_path=saved), device="cuda")
        out["reloaded_equal"] = all(torch.equal(a, b) for a, b in
                                    zip(back.state_dict().values(), full))
    return out


def dist_search(args, mesh):
    """(c) The sharded flat index over phase 2's recipe of rows (1M x 768 from a CUDA
    generator seeded --seed, then the queries): fp32 exact (K5), int8 (K7 at add_device,
    then K6 exact, K8 serve, K12 i8q); rank 0 also searches a one-process
    ``FlatIPIndex`` over the same rows."""
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
    from denseretrievaltoolkits_torch.parallel.sharded_index import ShardedFlatIndex
    from denseretrievaltoolkits_torch.utils.distributed import host_corpus_bounds

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    corpus = torch.randn(DIST_ROWS, 768, generator=gen, device="cuda")
    q = torch.randn(DIST_QUERIES, 768, generator=gen, device="cuda")
    lo, hi = host_corpus_bounds(DIST_ROWS, mesh.size, mesh.rank)
    out = {"window": [lo, hi]}
    if mesh.rank == 0:
        one = FlatIPIndex(768, device="cuda")
        one.add_device(corpus)
        one_s, one_i = one.search(q, DIST_K)
        del one
    mine = corpus[lo:hi].contiguous()
    del corpus
    torch.cuda.empty_cache()
    read_counts(reset=True)
    res = {}
    for dtype, modes in (("float32", ("exact",)), ("int8", ("exact", "serve", "i8q"))):
        idx = ShardedFlatIndex(mesh, 768, dtype=dtype, device="cuda")
        idx.add_device(mine)
        idx.global_rows = DIST_ROWS
        for mode in modes:
            idx.search(q[:64], DIST_K, mode=mode)  # first use
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i = idx.search(q, DIST_K, mode=mode)
            res[f"{dtype} {mode}"] = (s, i, time.perf_counter() - t0)
        del idx
    out["launches"] = read_counts()
    out["digest"] = _digest(*[v for s, i, _ in res.values() for v in (s, i)])
    out["seconds"] = {k: t for k, (_, _, t) in res.items()}
    ex = res["int8 exact"][1]
    out["recall"] = {m: float(np.mean([len(set(a) & set(b)) / DIST_K
                                       for a, b in zip(res[f"int8 {m}"][1], ex)]))
                     for m in ("serve", "i8q")}
    if mesh.rank == 0:
        s, i, _ = res["float32 exact"]
        out["fp32_ids_equal"] = bool(np.array_equal(i, one_i))
        out["fp32_score_rel"] = float(np.max(np.abs(s - one_s) / np.maximum(np.abs(one_s),
                                                                              1e-30)))
    return out


def dist_eval(args, tmp, mesh, model):
    """(d) ``Trainer.evaluate`` on the mesh: phase 11's 8192 planted passages and 512
    queries (``model``: phase 11's seeded random weights, untrained), each rank encoding its
    ``host_corpus_bounds`` window, into every kind of DIST_EVAL_KINDS. The one-process
    evaluations of the same kinds (and DIST_EVAL_REFERENCE's) run first, split over the
    ranks, into ``args.shared``; rank 0 then reads them all."""
    from denseretrievaltoolkits_torch.config import TrainingArguments
    from denseretrievaltoolkits_torch.data.collators import pad_batch
    from denseretrievaltoolkits_torch.data.loaders import DataLoader
    from denseretrievaltoolkits_torch.train.trainer import Trainer
    from denseretrievaltoolkits_torch.utils.distributed import host_corpus_bounds

    corpus, queries = synthetic_qa(np.random.default_rng(args.seed + 1), args.passages,
                                   args.queries, 156, 32)
    kinds = DIST_EVAL_KINDS + tuple((ref, dict(kw, index_factory=ref))
                                    for kind, kw in DIST_EVAL_KINDS
                                    for ref in [DIST_EVAL_REFERENCE.get(kind)] if ref)
    eps = {kind: i + 1 for i, (kind, _) in enumerate(kinds)}

    def targs_at(root, kw):
        return TrainingArguments(output_dir=os.path.join(root, "out"),
                                 cache_train_dir=os.path.join(root, "cache"),
                                 retrieve_num=args.k, topk="1,10,100", **kw)

    def evaluate(root, mesh_or_none, bounds, todo):
        corpus_dl = DataLoader(corpus, args.batch, lambda b: (
            [r["id"] for r in b], pad_batch([r["tokens"] for r in b], 156, 0)),
            shard_bounds=bounds)
        query_dl = DataLoader(queries, args.batch, lambda b: (
            [r["query_id"] for r in b], pad_batch([r["tokens"] for r in b], 32, 0),
            [r["answers"] for r in b], [r["original"] for r in b]))
        out = {}
        for kind, kw in todo:
            targs = targs_at(root, kw)
            trainer = Trainer(targs, model, corpus_dataloader=corpus_dl, eval_loader=query_dl,
                              mesh=mesh_or_none)
            read_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.evaluate(query_dl, eps[kind])
            torch.cuda.synchronize()
            out[kind] = {"metrics": metrics, "seconds": time.perf_counter() - t0,
                         "launches": read_counts(), "dump_written": os.path.exists(
                             os.path.join(targs.retrieve_dir, f"{eps[kind]}.0.json")),
                         "dumps": len(os.listdir(targs.retrieve_dir))}
            del trainer
        return out

    one_root = os.path.join(args.shared, "dist-eval-one")
    res = {"one": evaluate(one_root, None, None, kinds[mesh.rank::mesh.size])}
    mesh.barrier()
    mesh_root = os.path.join(tmp, "dist-eval-mesh")
    res["mesh"] = evaluate(mesh_root, mesh, host_corpus_bounds(len(corpus), mesh.size,
                                                               mesh.rank), DIST_EVAL_KINDS)
    if mesh.rank == 0:  # every reference's metrics and dump, from the shared directory
        ref_metrics, overlap = {}, {}
        for kind, kw in DIST_EVAL_KINDS:
            mine, _ = read_dump(targs_at(mesh_root, kw), eps[kind])
            for against in {kind, DIST_EVAL_REFERENCE.get(kind, kind)}:
                ref_args = targs_at(one_root, dict(kw, index_factory=against)
                                    if "index_factory" in kw else kw)
                ref_metrics[against] = _metrics_of(ref_args, eps[against])
                theirs, _ = read_dump(ref_args, eps[against])
                overlap[f"{kind} vs {against}"] = float(np.mean(
                    [len(set(mine[q]) & set(d)) / len(d) for q, d in theirs.items()]))
        res["reference_metrics"], res["overlap"] = ref_metrics, overlap
    return res


def dist_worker(argv):
    """One rank of phase 29: ``--dist_worker <case> <rank> <world> <port> <dir> <seed>``;
    prints its readings as one JSON line, last."""
    from denseretrievaltoolkits_torch.parallel.mesh import make_mesh
    from denseretrievaltoolkits_torch.utils.distributed import maybe_initialize_distributed

    case, rank, world, port, work, seed = argv[0], int(argv[1]), int(argv[2]), argv[3], \
        argv[4], int(argv[5])
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    backend = "nccl" if case == "nccl" else "gloo"
    if world == 1:  # maybe_initialize_distributed leaves a lone process alone
        torch.cuda.set_device(0)
        torch.distributed.init_process_group(backend, init_method="env://", world_size=1,
                                             rank=0, timeout=datetime.timedelta(seconds=300))
    else:
        maybe_initialize_distributed(backend, device="cuda:0", timeout_s=300)
    args = argparse.Namespace(seed=seed, passages=8192, queries=512, batch=64, k=DIST_K,
                              shared=work)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        if case == "tp":  # one data rank of two model ranks
            out = dist_tp(args, tmp, make_mesh(1, 2))
        else:
            out = (dist_nccl_step if case == "nccl" else dist_gloo)(args, tmp, make_mesh())
    torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return 0


def spawn_world(case, world, seed, work):
    """Start ``world`` ranks of ``case``; returns their Popen handles and log paths."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    for r in range(world):
        log_path = os.path.join(work, f"{case}.rank{r}.log")
        with open(log_path, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist_worker", case, str(r),
                 str(world), port, work, str(seed)], stdout=fh, stderr=subprocess.STDOUT),
                log_path))
    return procs


def collect(procs, deadline):
    """Each rank's JSON line; a rank that fails or outlives the deadline fails the phase
    (every rank is killed first)."""
    outs, failed = [], None
    try:
        for p, _ in procs:
            try:
                if p.wait(timeout=max(1.0, deadline - time.time())) != 0 and failed is None:
                    failed = f"a rank exited {p.returncode}"
            except subprocess.TimeoutExpired:
                failed = f"a rank outlived the phase's {DIST_TIMEOUT_S} s"
                break
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for _, path in procs:
        with open(path) as fh:
            text = fh.read()
        if failed:
            log(f"--- {path}\n{text[-4000:]}")
        else:
            outs.append(json.loads(text.strip().splitlines()[-1]))
    check(failed is None, f"phase 29: {failed}")
    return outs


def phase_dist(args, tmp):
    """Phase 29: data parallelism and the sharded indexes over worker processes."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    work = os.path.join(tmp, "dist")
    os.makedirs(work, exist_ok=True)
    deadline = time.time() + DIST_TIMEOUT_S
    nccl = spawn_world("nccl", 1, args.seed, work)
    gloo = spawn_world("gloo", 2, args.seed, work)
    tp_world = spawn_world("tp", 2, args.seed, work)
    (a,) = collect(nccl, deadline)
    b = collect(gloo, deadline)
    tp = sorted(collect(tp_world, deadline), key=lambda o: o["rank"])
    seconds = time.perf_counter() - t_start
    # (a) NCCL, one rank
    log(f"phase 29 (a) NCCL world 1: mesh step loss {a['mesh']['loss']!r} vs {a['plain']['loss']!r}"
        f"; gradient / parameter digests equal: {a['mesh']['grad'] == a['plain']['grad']} / "
        f"{a['mesh']['params'] == a['plain']['params']}")
    check(a["mesh"]["loss"] == a["plain"]["loss"] and a["mesh"]["grad"] == a["plain"]["grad"]
          and a["mesh"]["params"] == a["plain"]["params"],
          "phase 29 (a): the NCCL world-1 mesh step is not bit-equal to the step without a mesh")
    r0, r1 = sorted(b, key=lambda o: o["rank"])
    log(f"phase 29 gloo collectives on CUDA tensors: {json.dumps(r0['gloo_cuda'])}")
    check(r0["gloo_cuda"]["all_gather"] == [1.0] * 4 + [2.0] * 4
          and r0["gloo_cuda"]["all_reduce"] == [3.0] * 4
          and r1["gloo_cuda"]["broadcast"] == [1.0] * 4, "phase 29: gloo collectives on CUDA")
    # (b) the data-parallel step
    rel, cos, ratio = r0["dp"]["vs_one_process"]
    log(f"phase 29 (b) gloo 2 ranks x 16 x 8: step-1 loss rel {rel:.3e} (<= {TRAIN_STEP1_REL:g}),"
        f" gradient cosine {cos:.6f} (>= {TRAIN_GRAD_COS:g}), norm ratio {ratio:.6f}; losses "
        f"{json.dumps(r0['dp']['losses'])}; {r0['dp']['steps_per_s']:.3f} steps/s (two ranks on "
        f"one card); parameters after 3 steps equal: {r0['dp']['params'] == r1['dp']['params']}")
    check(rel <= TRAIN_STEP1_REL and cos >= TRAIN_GRAD_COS and abs(ratio - 1) <= TRAIN_GRAD_NORM,
          "phase 29 (b): the DP step-1 loss / gradient disagrees with one process's")
    check(r0["dp"]["params"] == r1["dp"]["params"] and r0["dp"]["losses"] == r1["dp"]["losses"],
          "phase 29 (b): the two ranks' parameters differ after 3 steps")
    own = (r0["local"]["own_loss"] + r1["local"]["own_loss"]) / 2
    local_rel = abs(r0["local"]["mesh_loss"] - own) / abs(own)
    log(f"phase 29 (b) negatives_x_device off: mesh loss {r0['local']['mesh_loss']!r}, mean of "
        f"the ranks' own losses {own!r} (rel {local_rel:.3e})")
    check(local_rel <= 1e-6 and r0["local"]["mesh_loss"] == r1["local"]["mesh_loss"],
          "phase 29 (b): negatives_x_device=False is not the mean of the ranks' losses")
    rel, cos, ratio = r1["gc"]["vs_one_process"]
    log(f"phase 29 (b) grad-cache under the mesh at 64 x 8, chunks {GC_AGREE_CHUNKS}: loss rel "
        f"{rel:.3e}, gradient cosine {cos:.7f} (>= {GC_AGREE_COS:g}), norm ratio {ratio:.7f} "
        f"(within {GC_AGREE_NORM:g} of 1)")
    check(rel <= TRAIN_STEP1_REL and cos >= GC_AGREE_COS and abs(ratio - 1) <= GC_AGREE_NORM,
          "phase 29 (b): grad-cache under the mesh disagrees with the full batch")
    # (c) the sharded flat index
    s0, s1 = r0["search"], r1["search"]
    log(f"phase 29 (c) sharded flat, {DIST_ROWS} x 768 over 2 ranks ({s0['window']}, "
        f"{s1['window']}): fp32 exact ids equal one process's: {s0['fp32_ids_equal']}, scores rel "
        f"{s0['fp32_score_rel']:.3e}; int8 recall serve {s0['recall']['serve']:.5f} (>= "
        f"{DIST_SERVE_RECALL}), i8q {s0['recall']['i8q']:.5f} (>= {DIST_I8Q_RECALL}); seconds "
        f"{json.dumps(s0['seconds'])}; ranks identical: {s0['digest'] == s1['digest']}")
    check(s0["fp32_ids_equal"] and s0["fp32_score_rel"] <= 1e-6,
          "phase 29 (c): the sharded fp32 search differs from one process's")
    check(s0["recall"]["serve"] >= DIST_SERVE_RECALL and s0["recall"]["i8q"] >= DIST_I8Q_RECALL,
          "phase 29 (c): sharded serve / i8q recall below phase 7's bounds")
    check(s0["digest"] == s1["digest"], "phase 29 (c): the two ranks' search results differ")
    # (d) evaluation on the mesh
    e0, e1 = r0["eval"], r1["eval"]
    for kind, _ in DIST_EVAL_KINDS:
        m0, m1 = e0["mesh"][kind]["metrics"], e1["mesh"][kind]["metrics"]
        check(m0 == m1, f"phase 29 (d): {kind}: the ranks' metrics differ")
        check(e0["mesh"][kind]["dump_written"] and e1["mesh"][kind]["dumps"] == 0,
              f"phase 29 (d): {kind}: a dump not from rank 0 alone")
        ref = DIST_EVAL_REFERENCE.get(kind, kind)
        for against, (overlap_min, gap_max) in ((ref, (DIST_EVAL_OVERLAP, DIST_EVAL_GAP)),) + (
                ((kind, (IVF_VS_FP32, IVF_METRIC_GAP)),) if ref != kind else ()):
            one = e0["reference_metrics"][against]
            secs = {**e0["one"], **e1["one"]}[against]["seconds"]
            gap = max(abs(m0[k] - one[k]) for k in one if k != "query_num")
            overlap = e0["overlap"][f"{kind} vs {against}"]
            log(f"phase 29 (d) evaluate {kind} on the mesh vs {against} in one process: "
                f"{json.dumps(m0)} vs {json.dumps(one)}; top-{args.k} overlap {overlap:.5f} (>= "
                f"{overlap_min}), largest metric gap {gap:.5f} (<= {gap_max}); "
                f"{e0['mesh'][kind]['seconds']:.2f} s (one process {secs:.2f} s)")
            if kind == "flat":
                check(m0 == one, "phase 29 (d): flat: the mesh's metrics differ from one "
                                 "process's")
            check(overlap >= overlap_min and gap <= gap_max,
                  f"phase 29 (d): {kind}: the mesh evaluation strays from {against}'s in one "
                  f"process")
    # (e) tensor parallelism
    t0, t1 = tp
    check(t0["mesh"] == {"data": 1, "model": 2}, f"phase 29 (e): mesh {t0['mesh']}")
    for attention, nq, p_len in TP_STEPS:
        e0, e1 = t0[attention], t1[attention]
        rel, cos, ratio = e0["vs_one_process"]
        blocks = 2 * TP_LAYERS  # each layer of the query and passage passes, one step
        want = {k: 0 for k in e0["launches"]}
        want.update({k: 1 for k in want if k.startswith(("K3", "K4"))})
        if attention == "fused":
            want.update({"K1 fused_attention_ln": blocks, "K2 fused_mlp_ln": blocks})
        if attention == "flash":
            want.update({k: blocks for k in want if k.startswith("F-")})
        log(f"phase 29 (e) tp=2 '{attention}' at {nq} x 8, S={p_len}, L={TP_LAYERS}: step-1 "
            f"loss rel {rel:.3e} (<= {TP_LOSS_REL:g}), gradient cosine {cos:.7f} (>= "
            f"{TP_GRAD_COS:g}), norm ratio {ratio:.7f} (within {TP_GRAD_NORM:g} of 1) "
            f"against one process; {e0['seconds']:.3f} s a step (two ranks on one card); "
            f"launches a rank {json.dumps(e0['launches'])} (want {json.dumps(want)})")
        check(rel <= TP_LOSS_REL and cos >= TP_GRAD_COS and abs(ratio - 1) <= TP_GRAD_NORM,
              f"phase 29 (e): the tp '{attention}' step disagrees with one process's")
        check(e0["grad"] == e1["grad"] and e0["loss"] == e1["loss"],
              f"phase 29 (e): the model ranks' '{attention}' losses or gradients differ")
        check(e0["launches"] == want and e1["launches"] == want,
              f"phase 29 (e): '{attention}' launches {e0['launches']} / {e1['launches']}, not "
              f"{want}")
    rel, cos, ratio = t0["adafactor"]["vs_one_process"]
    log(f"phase 29 (e) tp=2 adafactor step: loss rel {rel:.3e} (<= {TP_LOSS_REL:g}), update "
        f"cosine {cos:.7f} (>= {TP_GRAD_COS:g}), norm ratio {ratio:.7f} (within "
        f"{TP_GRAD_NORM:g} of 1) against one process; deploy format reloaded in one process "
        f"equal: {t0['reloaded_equal']}")
    check(rel <= TP_LOSS_REL and cos >= TP_GRAD_COS and abs(ratio - 1) <= TP_GRAD_NORM,
          "phase 29 (e): the tp adafactor update disagrees with one process's")
    check(t0["adafactor"]["update"] == t1["adafactor"]["update"],
          "phase 29 (e): the model ranks' adafactor updates differ")
    check(t0["reloaded_equal"], "phase 29 (e): the saved tp model does not reload equal")
    # launches by rank, summed over the ranks
    per_rank = [{k: o["dp"]["launches"][k] + o["gc"]["launches"][k] + o["search"]["launches"][k]
                 + sum(e["launches"][k] for e in o["eval"]["mesh"].values())
                 for k in o["dp"]["launches"]} for o in (r0, r1)]
    reference = {k: sum(e["launches"][k] for o in (r0, r1) for e in o["eval"]["one"].values())
                 for k in per_rank[0]}
    launches = {k: sum(p[k] for p in per_rank) for k in per_rank[0]}
    log(f"phase 29 launches by rank {json.dumps(per_rank)}; rank 0's one-process references "
        f"{json.dumps(reference)}; NCCL world 1 {json.dumps(a['mesh']['launches'])}; "
        f"{seconds:.1f} s")
    check(all(n > 0 for k, n in launches.items() if not k.startswith("K13")),
          f"phase 29: a kernel of the mesh paths never launched: {launches}")
    tp_launches = {att: t0[att]["launches"] for att, _, _ in TP_STEPS}
    return {"nccl": a, "gloo": [r0, r1], "tp": [t0, t1], "launches_by_rank": per_rank,
            "launches": launches, "reference_launches": reference, "tp_launches": tp_launches,
            "seconds": seconds}

CLI_PASSAGES = 65_536  # 16 blocks of FlatIPIndex's 4096 rows: 16 x J=8 slots hold k=100
CLI_TRAIN, CLI_EVAL = 512, 128
CLI_LAYERS = 4  # run_toolkits' bert-base depth (widths and vocabulary unchanged)
CLI_VOCAB = 30_522  # bert-base-uncased's vocabulary size
TREND_MRR10 = 0.002  # the twin's final test MRR@10 (CPU rehearsal 0.0051; random 1e-4)
HF_PACKAGES = ("transformers", "datasets")


def _cli_counters():
    """The counters phase 30 zeroes before a stage and reads after it; the generic
    bodies' counters are read as differences (the final checks read them whole)."""
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con, flash, topk

    counted = {"K1 fused_attention_ln": (attn.fused_attention_ln, "launches"),
               "K2 fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
               "K3 contrastive_fwd": (con.contrastive_fwd, "launches"),
               "K4 contrastive_bwd_dq": (con.contrastive_bwd_dq, "launches"),
               "K4 contrastive_bwd_dp": (con.contrastive_bwd_dp, "launches"),
               "K5 block_topj": (topk.block_topj, "launches"),
               "K8 block_topj_serve": (topk.block_topj_serve, "launches"),
               "F-fwd flash_fwd": (flash.flash_fwd, "launches")}
    generic = {"K3 generic": (con.contrastive_fwd, "launches_generic"),
               "K4 dq generic": (con.contrastive_bwd_dq, "launches_generic"),
               "K4 dp generic": (con.contrastive_bwd_dp, "launches_generic"),
               "K5 generic": (topk.block_topj, "launches_generic"),
               "K8 generic": (topk.block_topj_serve, "launches_generic")}
    return counted, generic


def cli_stage(name, fn, *fn_args, **fn_kw):
    """Run one stage with the counters zeroed before it; (its result, its counts)."""
    counted, generic = _cli_counters()
    for f, attr in counted.values():
        setattr(f, attr, 0)
    before = {k: int(getattr(f, attr, 0)) for k, (f, attr) in generic.items()}
    t = time.perf_counter()
    out = fn(*fn_args, **fn_kw)
    torch.cuda.synchronize()
    counts = {k: int(getattr(f, attr, 0)) for k, (f, attr) in counted.items()}
    counts.update({k: int(getattr(f, attr, 0)) - before[k] for k, (f, attr) in generic.items()})
    counts["seconds"] = time.perf_counter() - t
    log(f"phase 30 {name}: {json.dumps(counts)}")
    check(not any(counts[k] for k in generic), f"{name}: a generic body ran: {counts}")
    check(not any(m.split(".")[0] in HF_PACKAGES for m in sys.modules),
          f"{name}: transformers or datasets got imported")
    return out, counts


def make_cli_model_dir(path):
    """An architecture-only bert-base dir at CLI_LAYERS (random init from the seed) whose
    vocab.txt holds
    the planted data's words, padded to 30,522 entries, with a BertTokenizerFast config."""
    from denseretrievaltoolkits_torch.models import bert
    from denseretrievaltoolkits_torch.recipes import quality_trend

    os.makedirs(path, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + quality_trend._words()
    vocab += [f"[unused{i}]" for i in range(CLI_VOCAB - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as fh:
        fh.write("\n".join(vocab))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "BertTokenizerFast", "do_lower_case": True}, fh)
    bert.save_config(bert.BertConfig(vocab_size=CLI_VOCAB, num_hidden_layers=CLI_LAYERS), path)
    return path


def phase_cli(args, tmp):
    """Phase 30: the CLIs through ``run_toolkits``, the ``quality_trend`` twin,
    ``graft_entry`` and the ``profile_encoder`` twin (module docstring)."""
    import random

    from denseretrievaltoolkits_torch import graft_entry, run_toolkits
    from denseretrievaltoolkits_torch.evaluator.convert import retrieval_jsonl_to_nq_json
    from denseretrievaltoolkits_torch.recipes import profile_encoder, quality_trend

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "cli")
    out = {}
    # (a) the pipeline's stages at bert-base
    t = time.perf_counter()
    data_dir, corpus_path = quality_trend.make_dataset(work, random.Random(args.seed), CLI_TRAIN,
                                                       CLI_EVAL, CLI_PASSAGES)
    model_dir = make_cli_model_dir(os.path.join(work, "bert-base"))
    out["data_seconds"] = time.perf_counter() - t
    cache, outdir = os.path.join(work, "cache"), os.path.join(work, "out")
    common = ["--tokenizer_name", model_dir, "--dtype", "bfloat16", "--attention", "fused",
              "--dataset", "nq", "--data_dir", data_dir,
              "--data_cache_dir", os.path.join(work, "data_cache"), "--q_max_len", "16",
              "--p_max_len", "32",
              "--corpus_batch_size", "512", "--seed", str(args.seed)]
    train_argv = common + [
        "--model_name_or_path", model_dir, "--fused_loss", "--corpus_path", corpus_path,
        "--train_n_passages", "2", "--train_batch_size", "32", "--eval_batch_size", "64",
        "--test_batch_size", "64", "--max_epochs", "1", "--eval_per_train", "1",
        "--save_per_train", "1", "--learning_rate", str(TRAIN_LR), "--optimizer", "adamw",
        "--topk", "5,10,100", "--retrieve_num", "100", "--log_every", "0",
        "--output_dir", outdir, "--cache_train_dir", cache]
    _, out["train_random"] = cli_stage("train_random", run_toolkits.main,
                                       ["train_random"] + train_argv)
    with open(os.path.join(cache, "-1.0_metrics")) as fh:
        trained_metrics = json.load(fh)
    check(trained_metrics["query_num"] == CLI_EVAL and os.path.exists(
        os.path.join(cache, "1.0_metrics")), "train_random: the dev / test metric files")
    ranked, n_rows = read_dump(argparse.Namespace(retrieve_dir=os.path.join(cache, "retrieve")),
                               -1)
    check(len(ranked) == CLI_EVAL and n_rows == CLI_EVAL * 100, "train_random: test dump rows")
    trained = os.path.join(cache, "result1")
    q_pkl, p_pkl = os.path.join(work, "q.pkl"), os.path.join(work, "p.pkl")
    enc = common + ["--model_name_or_path", trained]
    _, out["encode_passages"] = cli_stage(
        "encode passages", run_toolkits.main,
        ["encode"] + enc + ["--encode_in_path", corpus_path, "--encodedp_save_path", p_pkl])
    _, out["encode_queries"] = cli_stage(
        "encode queries", run_toolkits.main,
        ["encode"] + enc + ["--encode_in_path", os.path.join(data_dir, "test.jsonl"),
                            "--encode_is_qry", "--encodedq_save_path", q_pkl,
                            "--corpus_batch_size", "64"])  # the trainer's test batches
    from denseretrievaltoolkits_torch.evaluator.retrieval import pickle_load

    p_reps, p_ids = pickle_load(p_pkl)
    q_reps, q_ids = pickle_load(q_pkl)
    check(p_reps.shape == (CLI_PASSAGES, 768) and len(p_ids) == CLI_PASSAGES
          and q_reps.shape == (CLI_EVAL, 768) and np.isfinite(p_reps).all(),
          "encode: reps of the passages and queries")
    ranking = os.path.join(work, "ranking.tsv")
    _, out["retrieve"] = cli_stage(
        "retrieve", run_toolkits.main,
        ["retrieve", "--query_reps", q_pkl, "--passage_reps", p_pkl, "--depth", "100",
         "--batch_size", str(CLI_EVAL), "--save_ranking_to", ranking, "--save_text"])
    cli = {}
    with open(ranking) as fh:
        for line in fh:
            qid, did, _ = line.split("\t")
            cli.setdefault(qid, []).append(did)
    vs = overlap([ranked[q] for q in sorted(ranked)], [cli.get(q, []) for q in sorted(ranked)])
    out["retrieve_overlap"] = vs
    log(f"retrieve: {sum(map(len, cli.values()))} ranking lines, top-100 overlap with the "
        f"trainer's exact ranking {vs:.5f} (>= 0.999)")
    check(sum(map(len, cli.values())) == CLI_EVAL * 100 and vs >= 0.999,
          "retrieve disagrees with the trainer's exact ranking")
    nq_json = os.path.join(work, "nq.json")
    retrieval_jsonl_to_nq_json(os.path.join(cache, "retrieve", "-1.0.json"), nq_json)
    acc, out["nq_eval"] = cli_stage("nq_eval", run_toolkits.main,
                                    ["nq_eval", "--retrieval", nq_json, "--topk", "5", "10",
                                     "100"])
    out["nq_eval_accuracy"] = acc
    gaps = {k: abs(acc[k] - trained_metrics[f"Recall@{k}"]) for k in (5, 10, 100)}
    check(max(gaps.values()) == 0, f"nq_eval vs the trainer's Recall@k: {gaps}")
    bm25_out = os.path.join(work, "bm25")
    bm25_argv = common + [
        "--model_name_or_path", model_dir, "--fused_loss", "--train_n_passages", "4",
        "--train_batch_size", "32", "--max_epochs", "1", "--save_per_train", "1",
        "--learning_rate", str(TRAIN_LR), "--log_every", "1",
        "--output_dir", os.path.join(bm25_out, "out"),
        "--cache_train_dir", os.path.join(bm25_out, "cache")]
    _, out["train_bm25"] = cli_stage("train_bm25", run_toolkits.main, ["train_bm25"] + bm25_argv)
    with open(os.path.join(bm25_out, "out", "train_log.jsonl")) as fh:
        bm25_losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
    check(len(bm25_losses) == CLI_TRAIN // 32 and np.isfinite(bm25_losses).all(),
          "train_bm25: a finite loss a step")
    rr_cache = os.path.join(work, "rr_cache")
    os.makedirs(os.path.join(rr_cache, "retrieve"))
    shutil.copy(os.path.join(cache, "retrieve", "-1.0.json"),
                os.path.join(rr_cache, "retrieve", "-1.0.json"))
    rr_argv = common + [
        "--model_name_or_path", model_dir, "--train_n_passages", "4", "--train_batch_size", "32",
        "--eval_batch_size", "256", "--max_epochs", "1", "--save_per_train", "1",
        "--learning_rate", str(TRAIN_LR), "--loss_fn", "mr", "--log_every", "0",
        "--output_dir", os.path.join(work, "rr_out"), "--cache_train_dir", rr_cache]
    rr_metrics, out["rerank"] = cli_stage("rerank", run_toolkits.main, ["rerank"] + rr_argv)
    with open(os.path.join(rr_cache, "3.0_RR_metrics")) as fh:
        check(json.load(fh)["query_num"] == CLI_EVAL, "rerank: the metrics file's query_num")
    out["rerank_metrics"] = rr_metrics
    a = out
    check(all(a["train_random"][k] > 0 for k in ("K1 fused_attention_ln", "K2 fused_mlp_ln",
                                                  "K3 contrastive_fwd", "K4 contrastive_bwd_dq",
                                                  "K4 contrastive_bwd_dp", "K5 block_topj")),
          "train_random: K1-K5 launched")
    check(all(a[s]["K1 fused_attention_ln"] > 0 and a[s]["K2 fused_mlp_ln"] > 0
              for s in ("encode_passages", "encode_queries", "train_bm25")),
          "encode / train_bm25: K1 / K2 launched")
    check(a["retrieve"]["K5 block_topj"] > 0, "retrieve: K5 launched")
    check(a["train_bm25"]["K3 contrastive_fwd"] > 0, "train_bm25: K3 launched")
    out["a_seconds"] = time.perf_counter() - t_phase

    # (b) the quality_trend twin on its own 4-layer / 128-wide tower
    t = time.perf_counter()
    trend, out["quality_trend"] = cli_stage(
        "quality_trend", quality_trend.main,
        ["--out", os.path.join(work, "trend"), "--epochs", "2", "--lr", "1e-3",
         "--search_mode", "serve", "--rerank", "--device", "cuda", "--seed", str(args.seed)])
    out["trend"] = trend
    mrr = trend["trend"]["-1"]["MRR@10"]
    log(f"quality_trend: test MRR@10 {mrr:.4f} (>= {TREND_MRR10}), Recall@100 "
        f"{trend['trend']['-1']['Recall@100']:.4f}; + reranker MRR@10 "
        f"{trend['rerank']['MRR@10']:.4f}")
    check(mrr >= TREND_MRR10, "quality_trend: the test MRR@10 under its bound")
    check(out["quality_trend"]["K8 block_topj_serve"] > 0, "quality_trend: K8 launched")
    out["b_seconds"] = time.perf_counter() - t

    # (c) graft_entry: the flagship step once, then the dry run over two gloo ranks
    t = time.perf_counter()
    fn, (model, query, passage) = graft_entry.entry()
    (loss, scores), out["entry"] = cli_stage("graft_entry.entry", fn, model, query, passage)
    out["entry_loss"] = float(loss.detach())
    check(math.isfinite(out["entry_loss"]) and tuple(scores.shape) == (8, 16),
          "graft_entry.entry: a finite loss and 8 x 16 scores")
    check(out["entry"]["K1 fused_attention_ln"] > 0, "graft_entry.entry: K1 / K2 launched")
    del model, loss, scores
    torch.cuda.empty_cache()
    dry = graft_entry.dryrun_multichip(2, "tiny")
    out["dryrun_loss"] = dry["loss"]
    check(math.isfinite(dry["loss"]), "dryrun_multichip(2): a finite loss")
    out["c_seconds"] = time.perf_counter() - t

    # (d) the profile_encoder twin at its full shapes
    t = time.perf_counter()
    prof_out = os.path.join(ROOT, "chiprun_out", "profile_encoder.json")
    out["profile_encoder"], out["profile_counts"] = cli_stage(
        "profile_encoder", profile_encoder.main, ["--out", prof_out])
    check(out["profile_counts"]["F-fwd flash_fwd"] > 0 and
          out["profile_counts"]["K1 fused_attention_ln"] > 0,
          "profile_encoder: F-fwd and K1 / K2 launched")
    out["d_seconds"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 30: {out['seconds']:.1f} s ((a) {out['a_seconds']:.1f}, (b) "
        f"{out['b_seconds']:.1f}, (c) {out['c_seconds']:.1f}, (d) {out['d_seconds']:.1f})")
    return out


# -- phase 31: the twins of the recipes that import bench.py, at reduced sizes ----------------

# each twin's cut: its environment knobs (or bench_data's constants) and arguments. The sweep
# keeps its IVF256: at 2048-row blocks the reference's Qcap cap (QCAP_ELEMS / block = 64
# slots a cell) drops probes once 2048 queries x nprobe / nlist passes it, and at IVF64 its
# recall10@100 fell from 0.7248 at nprobe 8 to 0.5433 at 16-64 (a chip run)
RECIPE_ENV = {"LAT_DOCS": "262144", "LAT_NLIST": "64", "LAT_NPROBE": "8",
              "PCAR38M_DOCS": "2000000", "PCAR38M_SLAB": "500000", "PCAR38M_QUERIES": "1024",
              "PQCAP_DOCS": "2000000", "PQCAP_SLAB": "500000", "PQCAP_CHUNK": "500000",
              "PQCAP_NLIST": "64", "PQCAP_NPROBE": "8", "BENCH_IVFPQ_NLIST": "256"}
RECIPE_SWEEP_DOCS, RECIPE_SQ4_DOCS = 1_000_000, 1_000_000
# bounds, set before the first reading on the card: serve / i8q of PCAR384,SQ4 against the
# int8 reference (the twin reads 0.86-0.88 at 200,000 rows on a CPU), int8 serve at J = 4
# against J = 16, the OPQ192x4 arms' recall10@100, the latency IVF arms against the flat serve
# of the same queries (a query's top 100 spans many of the mixture's 4096 components, so many
# cells: 0.53 at IVF16, nprobe 4 over 100,000 rows on a CPU), the bucketed reps against the
# padded ones
RECIPE_PCAR_RECALL, RECIPE_INT8_RECALL = 0.75, 0.99
RECIPE_PQ_RECALL, RECIPE_IVFPQ_RECALL, RECIPE_LAT_IVF_RECALL = 0.6, 0.5, 0.4
RECIPE_VARLEN_COS = 0.999
RECIPE_SLAB_OVERLAP = 0.999  # slab-merged vs one pass: the same top-100 sets, ties aside
RECIPE_CHECK_Q = 64  # query rows of the one call each kernel is held to its plain version at
RECIPE_PLAIN_REL = 1e-4  # top-J scores: of the largest |score|; quantizers: bit-equal


def _recipe_counters():
    from denseretrievaltoolkits_torch.ops import attn, ivf_bulk, ivf_pq, pq, quant, topk

    return {"K1 fused_attention_ln": (attn.fused_attention_ln, "launches"),
            "K2 fused_mlp_ln": (attn.fused_mlp_ln, "launches"),
            "K7 quantize_int8_device": (quant.quantize_int8_device, "launches"),
            "K8 block_topj_serve": (topk.block_topj_serve, "launches"),
            "K9 quantize_int4_device": (quant.quantize_int4_device, "launches"),
            "K11 block_topj_serve int4": (topk.block_topj_serve, "launches_int4"),
            "K12 sq4 block_topj_i8q int4": (topk.block_topj_i8q, "launches_int4"),
            "K14 ragged_topj": (ivf_bulk.ragged_topj, "launches_int8"),
            "K15 pq_topj_blocks 4-bit": (pq.pq_topj_blocks, "launches_4bit"),
            "K17 ragged_topj_pq": (ivf_pq.ragged_topj_pq, "launches")}


def _generic_counters():
    from denseretrievaltoolkits_torch.ops import ivf_bulk, topk

    return {"block_topj_serve.launches_generic": (topk.block_topj_serve, "launches_generic"),
            "block_topj_serve.launches_int4_generic": (topk.block_topj_serve,
                                                       "launches_int4_generic"),
            "block_topj_i8q.launches_generic": (topk.block_topj_i8q, "launches_generic"),
            "block_topj_i8q.launches_int4_generic": (topk.block_topj_i8q,
                                                     "launches_int4_generic"),
            "ragged_topj.launches_generic": (ivf_bulk.ragged_topj, "launches_generic")}


def on_card(t):
    """Whether a wrapper given ``t`` launches its kernel (CPU tensors take the plain
    version)."""
    return t.is_cuda


def _topj_agreement(got, want):
    gv, gi = got
    wv, wi = want
    fin = torch.isfinite(wv)
    same_mask = bool(torch.equal(torch.isfinite(gv), fin))
    err = float((gv - wv).abs()[fin].max()) if fin.any() else 0.0
    top = float(wv.abs()[fin].max()) if fin.any() else 1.0
    ids = float((gi == wi)[fin].float().mean()) if fin.any() else 1.0
    ok = same_mask and err <= RECIPE_PLAIN_REL * top + 1e-6 and ids >= 0.99
    return {"max_abs_err": err, "max_abs_score": top, "ids_equal": ids, "ok": ok}


def _cut_rows(t, n):
    return t[:n].contiguous() if torch.is_tensor(t) else t


@contextlib.contextmanager
def held_to_plain(checks):
    """Each recipe kernel's first call on the card is also run, after it, by its plain
    version on the same inputs (the top-J kernels' on their first RECIPE_CHECK_Q query
    rows, the kernel again on those rows), into ``checks``; those extra launches are
    taken back off the counters. The wrappers keep their counters (shared attributes)."""
    from denseretrievaltoolkits_torch.ops import attn, ivf_bulk, ivf_pq, pq, quant, topk

    q = RECIPE_CHECK_Q

    def ragged_plain(block_cell, qslab, values, row_ids, scales, J, block, sel=None,
                     qscales=None, slots=None):
        return ivf_bulk._ivf_topj_reference(qslab, values, row_ids, scales, qscales, block_cell,
                                            1, J, block, block if sel is None else sel, slots)

    def ragged_pq_plain(block_cell, qslab, codes, row_ids, poff, table, J, block, sel=None,
                        nbits=8, slots=None):
        return ivf_pq._ivf_pq_topj_reference(qslab, codes, row_ids, poff, table, block_cell,
                                             J, block, block if sel is None else sel, nbits,
                                             slots)

    def ln_agreement(got, want):
        err = float((got.float() - want.float()).abs().max())
        tol = float(torch.clamp(bf16_ulp(want), min=3e-2).max()) \
            if got.dtype == torch.bfloat16 else 1e-5
        return {"max_abs_err": err, "tol": tol, "ok": err <= tol}

    def quant_agreement(got, want):
        ok = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        return {"values_equal": float((got[0] == want[0]).float().mean()),
                "max_abs_err": float((got[1] - want[1]).abs().max()), "ok": ok}

    # (module, name, plain version, the arguments of the checked call, agreement)
    cut_q0 = lambda a: (_cut_rows(a[0], q),) + tuple(a[1:])  # noqa: E731
    cut_q01 = lambda a: (_cut_rows(a[0], q), _cut_rows(a[1], q)) + tuple(a[2:])  # noqa: E731
    table = (
        (topk, "block_topj_serve", topk._block_topj_serve_reference, cut_q0, _topj_agreement),
        (topk, "block_topj_i8q", topk._block_topj_i8q_reference, cut_q01, _topj_agreement),
        (pq, "pq_topj_blocks", pq._pq_topj_reference, cut_q0, _topj_agreement),
        (ivf_bulk, "ragged_topj", ragged_plain, None, _topj_agreement),
        (ivf_pq, "ragged_topj_pq", ragged_pq_plain, None, _topj_agreement),
        (quant, "quantize_int8_device", quant._quantize_int8_reference, None, quant_agreement),
        (quant, "quantize_int4_device", quant._quantize_int4_reference, None, quant_agreement),
        (attn, "fused_attention_ln", attn._reference_attention_ln, None, ln_agreement),
        (attn, "fused_mlp_ln", attn._reference_mlp_ln, None, ln_agreement))
    patches = []
    for module, name, plain, cut, agree in table:
        real = getattr(module, name)

        def checked(*a, _real=real, _name=name, _plain=plain, _cut=cut, _agree=agree, **kw):
            out = _real(*a, **kw)
            int4 = kw.get("int4") or (_name.startswith("block_topj") and a[-1] is True)
            key = _name + (" int4" if int4 else "")
            if key not in checks and any(torch.is_tensor(t) and on_card(t) for t in a):
                saved = {k: v for k, v in vars(_real).items() if k.startswith("launches")}
                args = a if _cut is None else _cut(a)
                got = out if _cut is None else _real(*args, **kw)
                checks[key] = _agree(got, _plain(*args, **kw))
                checks[key]["shape"] = [list(t.shape) for t in args if torch.is_tensor(t)][:3]
                for k, v in saved.items():
                    setattr(_real, k, v)
            return out

        checked.__dict__ = real.__dict__  # the counters and last_body stay the wrapper's
        patches.append(mock.patch.object(module, name, checked))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield checks


def phase_recipes(args, tmp):
    """Phase 31: the twins of the JAX package's six ``bench.py`` recipes
    (``denseretrievaltoolkits_torch/recipes/``) at reduced sizes, through their ``main``:
    latency_probe (262,144 rows, IVF64, nprobe 8), bench_pcar_sq4 (1M), bench_pcar_38m (2M,
    four 500,000-row slabs), pq_capacity (2M, 500,000-row slabs, IVF64), ivfpq_sweep (1M,
    IVF256; the rotation from pq_capacity's through the twins' cache) and varlen_probe (its
    own 16,384 passages on 'fused', one trial). Counters zeroed before and read after; each
    kernel also held to its plain version at one call (``held_to_plain``). The slab-merged
    reference against one pass over the same rows; recall bounds; no generic-body launch at
    the recipes' shapes (the counters stay, and the kernels line's checks cover them)."""
    from denseretrievaltoolkits_torch.recipes import bench_data as bd
    from denseretrievaltoolkits_torch.recipes import (bench_pcar_38m, bench_pcar_sq4,
                                                      ivfpq_sweep, latency_probe, pq_capacity,
                                                      varlen_probe)

    t_phase = time.perf_counter()
    counted, generic = _recipe_counters(), _generic_counters()
    generic0 = {k: getattr(fn, attr) for k, (fn, attr) in generic.items()}
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    out, seconds, checks = {}, {}, {}
    cache = os.path.join(tmp, "recipe_cache")
    with mock.patch.dict(os.environ, RECIPE_ENV), mock.patch.object(bd, "CACHE_DIR", cache), \
            mock.patch.object(bd, "N_DOCS_INT8", RECIPE_SWEEP_DOCS), held_to_plain(checks):
        for name, run in (
                ("latency_probe", lambda: latency_probe.main([])),
                ("bench_pcar_sq4", lambda: bench_pcar_sq4.main(["--docs", str(RECIPE_SQ4_DOCS)])),
                ("bench_pcar_38m", lambda: bench_pcar_38m.main([])),
                ("pq_capacity", lambda: pq_capacity.main([])),
                ("ivfpq_sweep", lambda: ivfpq_sweep.main([])),
                ("varlen_probe", lambda: varlen_probe.main(["--attention", "fused",
                                                            "--trials", "1"]))):
            bd._SPEC_STATE.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = run()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            torch.cuda.empty_cache()
    launches = {k: int(getattr(fn, attr)) for k, (fn, attr) in counted.items()}
    generic_launches = {k: int(getattr(fn, attr)) - generic0[k]
                        for k, (fn, attr) in generic.items()}
    # the slab-merged reference against one pass over the same 2M rows
    n = int(RECIPE_ENV["PCAR38M_DOCS"])
    centers = bd.make_centers("cuda")
    q8 = bd.spectrumed_chunk(centers, 10**9, int(RECIPE_ENV["PCAR38M_QUERIES"])).to(
        torch.bfloat16)
    _, one_pass = bd.slab_reference(centers, q8, n, n, tag="one pass")
    slabbed = out["bench_pcar_38m"]["ref_ids"]
    slab_overlap = float(np.mean([len(set(a) & set(b)) / len(b)
                                  for a, b in zip(slabbed, one_pass)]))
    slab_equal = float(np.mean([set(a) == set(b) for a, b in zip(slabbed, one_pass)]))
    del centers, q8
    torch.cuda.empty_cache()
    lat, sq4, p38, cap, sweep, var = (out[k] for k in (
        "latency_probe", "bench_pcar_sq4", "bench_pcar_38m", "pq_capacity", "ivfpq_sweep",
        "varlen_probe"))
    flat_ids = lat["ids"]["flat"]
    lat_recall = {arm: float(np.mean([len(set(a) & set(b)) / len(b) for a, b in
                                      zip(lat["ids"][arm], flat_ids)]))
                  for arm in ("bulk", "probe")}
    readings = {
        "latency_p50_ms": lat["p50_ms"], "latency_ivf_vs_flat": lat_recall,
        "pcar_sq4": {k: sq4[k] for k in ("int8_qps", "int8_recall", "pca_kept_variance",
                                         "serve", "i8q")},
        "pcar_38m": {k: v for k, v in p38.items() if k not in ("ref_ids", "matrix")},
        "slab_vs_one_pass": {"overlap": slab_overlap, "equal_sets": slab_equal},
        "pq_capacity": cap, "ivfpq_sweep": sweep,
        "varlen": {k: var[k] for k in ("widths", "tokens_fixed", "tokens_bucketed", "trials",
                                       "min_cosine")}}
    log(f"phase 31 recipes: seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    log(f"phase 31 readings: {json.dumps(readings)}")
    log(f"phase 31 launches {json.dumps(launches)}; generic-body launches at the recipes' "
        f"shapes {json.dumps(generic_launches)} (want 0: the kernels line's checks count them)")
    log(f"phase 31 kernels against their plain versions at one call: {json.dumps(checks)}")
    for name in launches:
        check(launches[name] > 0, f"phase 31: {name} never launched")
    check(not any(generic_launches.values()),
          f"phase 31: block_topj.cu's body ran at the recipes' shapes: {generic_launches}")
    want_checks = {"block_topj_serve", "block_topj_serve int4", "block_topj_i8q int4",
                   "pq_topj_blocks", "ragged_topj", "ragged_topj_pq", "quantize_int8_device",
                   "quantize_int4_device", "fused_attention_ln", "fused_mlp_ln"}
    check(want_checks <= set(checks), f"phase 31: kernels not held to their plain versions: "
                                      f"{sorted(want_checks - set(checks))}")
    for name, c in checks.items():
        check(c["ok"], f"phase 31: {name} disagrees with its plain version: {c}")
    check(slab_overlap >= RECIPE_SLAB_OVERLAP,
          f"phase 31: the slab-merged reference's top-100 overlap {slab_overlap:.5f} with one "
          f"pass")
    for arm in ("serve", "i8q"):
        for recipe, r in (("bench_pcar_sq4", sq4[arm]), ("bench_pcar_38m", p38[arm])):
            check(r["recall100"] >= RECIPE_PCAR_RECALL,
                  f"phase 31: {recipe} {arm} recall@100 {r['recall100']:.4f}")
    check(sq4["int8_recall"] >= RECIPE_INT8_RECALL,
          f"phase 31: int8 serve recall {sq4['int8_recall']:.4f}")
    check(cap[0]["recall10in100"] >= RECIPE_PQ_RECALL,
          f"phase 31: pq_capacity flat recall10@100 {cap[0]['recall10in100']}")
    for line in cap[1:] + sweep:
        check(line["recall10in100"] >= RECIPE_IVFPQ_RECALL,
              f"phase 31: {line['metric']} recall10@100 {line['recall10in100']}")
    for arm, r in lat_recall.items():
        check(r >= RECIPE_LAT_IVF_RECALL, f"phase 31: latency {arm} vs flat recall {r:.4f}")
    check(var["min_cosine"] >= RECIPE_VARLEN_COS,
          f"phase 31: varlen bucketed vs fixed reps cosine {var['min_cosine']:.6f}")
    total = time.perf_counter() - t_phase
    log(f"phase 31: {total:.1f} s")
    return {"seconds": seconds, "total_seconds": total, "readings": readings,
            "launches": launches, "generic_launches": generic_launches, "plain_checks": checks}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist_worker"]:  # one rank of phase 29, started by phase_dist
        return dist_worker(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--passages", type=int, default=8192)
    parser.add_argument("--queries", type=int, default=512)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--k", type=int, default=100)
    parser.add_argument("--corpus_rows", type=int, default=1_000_000)
    parser.add_argument("--out", default="", help="also write the results as JSON here")
    parser.add_argument("--flash_only", action="store_true",
                        help="run only the flash phases (20-22), for their readings at "
                             "another --seed; prints no kernels line")
    parser.add_argument("--blocks_only", action="store_true",
                        help="run only K1 and K2 against their plain versions (phase 2), for "
                             "their readings at another --seed; prints no kernels line")
    parser.add_argument("--ivf_only", action="store_true",
                        help="run only the IVF cell kernels' phases (14 and 16: 1M and 8.8M "
                             "rows), for their readings; prints no kernels line")
    parser.add_argument("--train_only", action="store_true",
                        help="run only the training paths (phase 5, grad-cache, remat and "
                             "LoRA: phases 23-25), for iterating on them; prints no kernels "
                             "line")
    parser.add_argument("--eval_only", action="store_true",
                        help="run only the evaluation paths (phases 11, 15, 18 and 26, with "
                             "the plain encoder's PQ96 gaps), for their readings at another "
                             "--seed; "
                             "lists every failed check instead of stopping at the first, exits "
                             "1 if any failed; prints no kernels line")
    parser.add_argument("--rerank_only", action="store_true",
                        help="run only the T5 and reranker phase (27), for its readings; "
                             "prints no kernels line")
    parser.add_argument("--dist_only", action="store_true",
                        help="run only the data-parallel and sharded-index phase (29) over its "
                             "worker processes; prints no kernels line")
    parser.add_argument("--cli_only", action="store_true",
                        help="run only the CLI, recipe and entry-point phase (30); prints no "
                             "kernels line")
    parser.add_argument("--recipes_only", action="store_true",
                        help="run only the bench.py recipes' twins (phase 31); prints no "
                             "kernels line")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.index import flat, ivf
    from denseretrievaltoolkits_torch.index.flat import blockwise_topk
    from denseretrievaltoolkits_torch.ops import (_native, attn, contrastive, flash, ivf_bulk,
                                                  ivf_pq, pq, quant, topk)

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions score in true fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    t0 = time.perf_counter()
    _native.library()
    log(f"kernel build: {_native.build_seconds:.1f} s nvcc ({time.perf_counter() - t0:.1f} s "
        f"with load) -> {_native.BUILD_DIR}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.blocks_only:
        results = {"card": smi, "seed": args.seed, "blocks": phase_block_kernels(gen, attn)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.ivf_only:
        results = {"card": smi, "seed": args.seed,
                   "ivf_kernels": phase_ivf_kernels(args.seed + 7, flat, ivf, ivf_bulk,
                                                    args.corpus_rows),
                   "ivf_scale": phase_ivf_scale(args.seed + 11, flat, ivf_bulk)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.eval_only:
        global FAILED
        FAILED = []
        with tempfile.TemporaryDirectory() as tmp:
            eval_path, ctx = phase_eval_path(args, tmp)
            ivf_eval = phase_ivf_eval_path(args, tmp, ctx)
            plain_pq96 = plain_encoder_pq96_gaps(args, tmp)
            pq_eval = phase_pq_eval_path(args, tmp, ctx, plain_pq96)
            del ctx
            mining = phase_mining(args, tmp)
        results = {"card": smi, "seed": args.seed, "eval_path": eval_path, "ivf_eval": ivf_eval,
                   "pq96_plain_encoder_gaps": plain_pq96, "pq_eval": pq_eval,
                   "mining": mining, "failed_checks": FAILED}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(f"failed checks: {json.dumps(FAILED)}")
        log(smi)
        return 1 if FAILED else 0
    if args.train_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed, "train": phase_train(args, tmp),
                       "grad_cache": phase_grad_cache(args, tmp),
                       "remat": phase_remat(args, tmp), "lora": phase_lora(args, tmp),
                       "optimizers": phase_optimizers(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.dist_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed, "dist": phase_dist(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.cli_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed, "cli": phase_cli(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.recipes_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed, "recipes": phase_recipes(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1, default=str)
        log(smi)
        return 0
    if args.rerank_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed, "rerank": phase_rerank(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    if args.flash_only:
        with tempfile.TemporaryDirectory() as tmp:
            results = {"card": smi, "seed": args.seed,
                       "flash_kernels": phase_flash_kernels(gen, flash, attn),
                       "flash_serving": phase_flash_serving(args, tmp),
                       "flash_train": phase_flash_train(args, tmp)}
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        log(smi)
        return 0
    seconds = {}  # wall seconds of each phase, the card synchronized after it

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    blocks = timed("phase_block_kernels", phase_block_kernels, gen, attn)
    k5 = timed("phase_topk", phase_topk, gen, topk, blockwise_topk, args.corpus_rows)
    k34 = timed("phase_contrastive", phase_contrastive, gen, contrastive)
    k7, x_int8 = timed("phase_quant", phase_quant, gen, quant, args.corpus_rows)
    int8_topk = timed("phase_int8_topk", phase_int8_topk, gen, topk, quant, blockwise_topk,
                      x_int8)
    del x_int8
    torch.cuda.empty_cache()
    k9, x_int4 = timed("phase_quant4", phase_quant4, gen, quant, args.corpus_rows)
    int4_topk = timed("phase_int4_topk", phase_int4_topk, gen, topk, quant, blockwise_topk,
                      x_int4)
    del x_int4
    torch.cuda.empty_cache()
    flash_kernels = timed("phase_flash_kernels", phase_flash_kernels, gen, flash, attn)
    ivf_kernels = timed("phase_ivf_kernels", phase_ivf_kernels, args.seed + 7, flat, ivf,
                        ivf_bulk, args.corpus_rows)
    pq_kernels = timed("phase_pq_kernels", phase_pq_kernels, args.seed + 13, flat, pq,
                       args.corpus_rows)
    with tempfile.TemporaryDirectory() as tmp:
        main_path, kern = timed("phase_main_path", phase_main_path, args, tmp)
        int8_path = timed("phase_int8_path", phase_int8_path, args, tmp, kern)
        del kern
        train = timed("phase_train", phase_train, args, tmp)
        grad_cache = timed("phase_grad_cache", phase_grad_cache, args, tmp)
        remat = timed("phase_remat", phase_remat, args, tmp)
        lora = timed("phase_lora", phase_lora, args, tmp)
        optimizers = timed("phase_optimizers", phase_optimizers, args, tmp)
        flash_serving = timed("phase_flash_serving", phase_flash_serving, args, tmp)
        flash_train = timed("phase_flash_train", phase_flash_train, args, tmp)
        eval_path, ctx = timed("phase_eval_path", phase_eval_path, args, tmp)
        ivf_eval = timed("phase_ivf_eval_path", phase_ivf_eval_path, args, tmp, ctx)
        plain_pq96 = timed("plain_encoder_pq96_gaps", plain_encoder_pq96_gaps, args, tmp)
        pq_eval = timed("phase_pq_eval_path", phase_pq_eval_path, args, tmp, ctx, plain_pq96)
        del ctx
        mining = timed("phase_mining", phase_mining, args, tmp)
        rerank = timed("phase_rerank", phase_rerank, args, tmp)
        dist = timed("phase_dist", phase_dist, args, tmp)
        cli = timed("phase_cli", phase_cli, args, tmp)
        recipes = timed("phase_recipes", phase_recipes, args, tmp)
    scale = timed("phase_scale", phase_scale, gen, flat, topk, SCALE_QUERIES)
    scale4 = timed("phase_scale4", phase_scale4, gen, flat, SCALE4_QUERIES)
    ivf_scale = timed("phase_ivf_scale", phase_ivf_scale, args.seed + 11, flat, ivf_bulk)
    pq_scale = timed("phase_pq_scale", phase_pq_scale, args.seed + 17, flat, pq, ivf_pq)

    src = "denseretrievaltoolkits_torch/csrc/"
    rows = [
        ("fused_attention_ln",
         ", ".join(src + f for f in ("attn_ln.cu", "wgmma_ln.cuh", "hopper.cuh", "common.cuh")),
         "denseretrievaltoolkits_tpu/ops/attn.py:110", blocks["K1 bfloat16 B=64 S=156"]),
        ("fused_mlp_ln",
         ", ".join(src + f for f in ("mlp_ln.cu", "wgmma_ln.cuh", "hopper.cuh", "common.cuh")),
         "denseretrievaltoolkits_tpu/ops/attn.py:252",
         blocks["K2 bfloat16 B=64 S=156"]),
        ("block_topj",
         ", ".join(src + f for f in ("flat_certified.cu", "flat_serve.cu", "split.cuh",
                                     "hopper.cuh", "serve_select.cuh", "common.cuh")),
         "denseretrievaltoolkits_tpu/ops/topk.py:37", k5["float32"]),
    ]
    # bounds at the shapes timed: K1/K2 bf16 B=64 S=156 (phase 2's rows); K5 fp32 over
    # the corpus
    H = 768
    k5_bytes = 4 * (args.corpus_rows + 1024) * H + 8 * 1024 * -(-args.corpus_rows // 4096) * 8
    bounds = {"block_topj": bound(k5_bytes, 3 * 2 * 1024 * args.corpus_rows * H, "bf16")}
    for name, _, _, r in rows[:2]:
        bounds[name] = (r["bound_ms"], r["bound_by"])
    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_path["launches"][name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": None}
               for name, source, replaces, r in rows]
    for row in kernels[:2]:  # K1 / K2 on the training paths too
        row.update(train_launches=train["launches"][row["name"]],
                   grad_cache_launches=grad_cache["launches"][row["name"]],
                   remat_launches=remat["launches"][row["name"]],
                   # LoRA training (0: a LoRA layer runs the xla block), the merged tower's
                   # encode, and the miner's query encodes (serve and exact)
                   lora_train_launches=lora["launches"][row["name"]],
                   lora_merged_launches=lora["merged_launches"][row["name"]],
                   mining_launches=sum(m[row["name"]] for m in mining["launches"].values()),
                   # the T5 dual encoder's training and encode (0: T5 runs no BERT block)
                   t5_launches=(rerank["t5_train"]["launches"][row["name"]]
                                + rerank["t5_serve"]["encode_launches"][row["name"]]))
    kernels[2]["mining_launches"] = mining["launches"]["exact"]["block_topj (K5)"]
    # the T5 index's exact search
    kernels[2]["t5_launches"] = rerank["t5_serve"]["launches"]["exact"]["block_topj (K5)"]
    kernels[0].update({k: rows[0][3][k] for k in ("body", "stage_a_ms", "stage_b_ms",
                                                  "scratch_bound_ms")})  # K1's two launches
    kernels[1]["chain_ms"] = rows[1][3]["chain_ms"]  # K2: the xla block's bf16 chain
    # K5: its Hopper bodies (fp32 as fp16 pairs, flat_certified.cu; bf16 flat_serve.cu's),
    # block_topj.cu's on the same rows beside them; fp32's bound is the three fp16 products
    # that run (989 TFLOP/s), the fp32 FFMA bound beside it
    f32, b16 = k5["float32"], k5["bfloat16"]
    kernels[2].update({
        "body": f32["body"], "ms_j32": f32["ms_j32"], "max_abs_err_fp64": f32["max_abs_err_fp64"],
        "generic_ms": f32["generic_ms"], "generic_max_abs_err_fp64": f32["generic_max_abs_err_fp64"],
        "ffma_bound_ms": bound(k5_bytes, 2 * 1024 * args.corpus_rows * H, "fp32")[0],
        "bf16_ms": b16["ms"], "bf16_ms_j32": b16["ms_j32"],
        "bf16_max_abs_err_fp64": b16["max_abs_err_fp64"], "bf16_generic_ms": b16["generic_ms"],
        "bf16_bound_ms": bound(2 * (args.corpus_rows + 1024) * H, 2 * 1024 * args.corpus_rows * H,
                               "bf16")[0]})
    big = k34["4096x32768"]
    Q, P = 4096, 32768
    for name, line, err, ms, out_rows, ops in (
            ("contrastive_fwd", 39, max(big["max_abs_err"]["lse"], big["max_abs_err"]["tgt"]),
             "fwd", 0, 2 * Q * P * H),
            ("contrastive_bwd_dq", 121, big["max_abs_err"]["dq"], "dq", Q, 4 * Q * P * H),
            ("contrastive_bwd_dp", 150, big["max_abs_err"]["dp"], "dp", P, 4 * Q * P * H)):
        # the bound is the three fp16 products that run (989 TFLOP/s); the FFMA bound beside it
        k4 = ms != "fwd"
        b_ms, b_by = bound(4 * ((Q + P + out_rows) * H + 2 * Q), 3 * ops, "bf16")
        kernels.append({"name": name, "route": "cuda", "source": src + "contrastive.cu",
                        "replaces": f"denseretrievaltoolkits_tpu/ops/contrastive.py:{line}",
                        "launches": train["launches"][name], "max_abs_err": err,
                        "ms": big["ms"][ms], "plain_ms": big["ms"][ms + "_plain"],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "train_shape_ms": k34["32x256"]["ms"][ms],
                        # the grad-cache path's launches at this row's shape (Q=4096, P=32768)
                        "grad_cache_launches": grad_cache["launches"][name],
                        "remat_launches": remat["launches"][name],
                        "lora_launches": lora["launches"][name],
                        # the T5 dual encoder's training steps (Q=32, P=256)
                        "t5_launches": rerank["t5_train"]["launches"][name]})
        kernels[-1].update({  # the tensor-core bodies: fp16 pairs, the FFMA body beside them
            "source": ", ".join(src + f for f in ("contrastive.cu", "split.cuh", "hopper.cuh",
                                                  "common.cuh")),
            "ffma_ms": big["ms"][ms + "_ffma"],
            "train_shape_ffma_ms": k34["32x256"]["ms"][ms + "_ffma"],
            "ffma_bound_ms": bound(4 * ((Q + P + out_rows) * H + 2 * Q), ops, "fp32")[0],
            "generic_launches": getattr(contrastive, name).launches_generic})
        if not k4:  # K3: its walked-axis parts and its errors against fp64 beside the FFMA body's
            kernels[-1].update({
                "body": big["k3_body"], "parts": big["k3_parts"],
                "train_shape_parts": k34["32x256"]["k3_parts"],
                "fp64_abs_err": big["k3_fp64_abs_err"],
                "ffma_fp64_abs_err": big["k3_ffma_fp64_abs_err"]})
        else:
            i = 0 if ms == "dq" else 1
            kernels[-1].update({
                "body": big["bodies"][i],
                "fp64_rel_err": big["fp64_rel_err"][i],
                "ffma_fp64_rel_err": big["ffma_fp64_rel_err"][i],
                "splits": big["splits"][i], "train_shape_splits": k34["32x256"]["splits"][i]})
    # this slice's kernels: times on the 1M-row corpus, launches on the int8 path; K6 and K8 on
    # their Hopper bodies (flat_serve.cu; K8 fp32 flat_certified.cu's fp16-pair body)
    for name, source, replaces, r, counter in (
            ("block_topj (K6, int8 rows)",
             "flat_serve.cu, serve_select.cuh, hopper.cuh, common.cuh", "ops/topk.py:65",
             int8_topk["K6"], "block_topj (K6)"),
            ("quantize_int8_device", "quant.cu", "ops/quant.py:20", k7, "quantize_int8_device"),
            ("block_topj_serve", "flat_serve.cu, flat_certified.cu, split.cuh, serve_select.cuh, "
             "hopper.cuh, common.cuh", "ops/topk.py:94", int8_topk["K8 int8"], "block_topj_serve"),
            ("block_topj_i8q", "flat_serve.cu, serve_select.cuh, hopper.cuh, common.cuh",
             "ops/topk.py:190", int8_topk["K12 int8"], "block_topj_i8q")):
        kernels.append({"name": name, "route": "cuda",
                        "source": ", ".join(src + f for f in source.split(", ")),
                        "replaces": "denseretrievaltoolkits_tpu/" + replaces,
                        "launches": int8_path["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
        if counter == "block_topj_i8q":  # flat_serve.cu's body, its times at the other serve J
            kernels[-1].update({f: r[f] for f in r if f == "body" or f.startswith("ms_j")})
        elif counter == "block_topj (K6)":  # the escalation's J = 32
            kernels[-1].update(body=r["body"], ms_j32=r["ms_j32"],
                               generic_launches=topk.block_topj.launches_int8_generic)
        elif counter == "block_topj_serve":  # K8 int8's times at the other J, its fp32 and bf16
            f32, b16 = int8_topk["K8 float32"], int8_topk["K8 bfloat16"]
            kernels[-1]["mining_launches"] = mining["launches"]["serve"]["block_topj_serve (K8)"]
            kernels[-1]["t5_launches"] = \
                rerank["t5_serve"]["launches"]["serve"]["block_topj_serve (K8)"]
            kernels[-1].update({f: r[f] for f in r if f == "body" or f.startswith("ms_j")})
            kernels[-1].update(
                generic_launches=topk.block_topj_serve.launches_generic,
                fp32_body=f32["body"], fp32_ms=f32["ms"], fp32_plain_ms=f32["plain_ms"],
                fp32_bound_ms=f32["bound_ms"], fp32_ffma_bound_ms=f32["ffma_bound_ms"],
                fp32_ffma_ms=f32["ffma_ms"], fp32_max_abs_err_fp64=f32["max_abs_err_fp64"],
                fp32_ffma_max_abs_err_fp64=f32["ffma_max_abs_err_fp64"],
                bf16_body=b16["body"], bf16_ms=b16["ms"], bf16_plain_ms=b16["plain_ms"],
                bf16_bound_ms=b16["bound_ms"],
                **{f"fp32_{f}": f32[f] for f in f32 if f.startswith("ms_j")},
                **{f"bf16_{f}": b16[f] for f in b16 if f.startswith("ms_j")})
    # the int4 kernels: times on the 1M-row corpus, launches on the evaluation path; K10 runs
    # int4_certified.cu's s8 body (block_topj.cu's FFMA body launched 0 times on these paths:
    # checked), with the FFMA body's time and error against fp64 on the same rows beside it
    for name, source, replaces, r, counter in (
            ("quantize_int4_device", "quant.cu", "ops/quant.py:64", k9, "quantize_int4_device"),
            ("block_topj (K10, int4 rows)",
             "int4_certified.cu, hopper.cuh, serve_select.cuh, common.cuh",
             "ops/topk.py:237", int4_topk["K10"], "block_topj (K10)"),
            ("block_topj_serve (K11, int4 rows)",
             "flat_serve.cu, int4_tiles.cuh, serve_select.cuh, hopper.cuh, common.cuh",
             "ops/topk.py:166", int4_topk["K11"], "block_topj_serve (K11)"),
            ("block_topj_i8q (K12 sq4, int4 rows)",
             "flat_serve.cu, int4_tiles.cuh, serve_select.cuh, hopper.cuh, common.cuh",
             "ops/topk.py:213", int4_topk["K12 sq4"], "block_topj_i8q (K12 sq4)")):
        kernels.append({"name": name, "route": "cuda",
                        "source": ", ".join(src + f for f in source.split(", ")),
                        "replaces": "denseretrievaltoolkits_tpu/" + replaces,
                        "launches": eval_path["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
        if counter == "block_topj (K10)":
            kernels[-1].update({f: r[f] for f in ("body", "ms_j32", "fp32_bound_ms", "ffma_ms",
                                                  "max_abs_err_fp64", "ffma_max_abs_err_fp64")},
                               generic_launches=topk.block_topj.launches_int4_generic)
        elif counter != "quantize_int4_device":  # K11 / K12 sq4: flat_serve.cu's body
            kernels[-1].update({f: r[f] for f in r if f.startswith(("body", "ms_j", "old_body"))
                                or f == "max_abs_err_fp64"})
    ivf_src = ", ".join(src + f for f in ("ivf_cell.cu", "serve_select.cuh", "hopper.cuh",
                                          "common.cuh"))
    # the IVF cell kernels: times at the 1M-row phase, one row per body; launches on
    # the path that runs the body (the 1M-row searches for fp32 / bf16 cells, the
    # evaluation path for K13's int8 bodies, the 8.8M-row phase for K14's)
    for name, line, layout, body, launches in (
            ("cell_topj (K13, fp32 cells)", 44, "IVF", "float32 bulk", None),
            ("cell_topj (K13, bf16 cells)", 44, "IVF", "bfloat16 bulk", None),
            ("cell_topj (K13, int8 cells)", 61, "IVF", "int8 bulk",
             ivf_eval["launches"]["cell_topj (K13 int8)"]),
            ("cell_topj (K13, i8q)", 143, "IVF", "int8 i8q",
             ivf_eval["launches"]["cell_topj (K13 i8q)"]),
            ("ragged_topj (K14, fp32 cells)", 165, "IVFR", "float32 bulk", None),
            ("ragged_topj (K14, bf16 cells)", 165, "IVFR", "bfloat16 bulk", None),
            ("ragged_topj (K14, int8 cells)", 184, "IVFR", "int8 bulk",
             ivf_scale["modes"]["bulk"]["launches"]),
            ("ragged_topj (K14, i8q)", 202, "IVFR", "int8 i8q",
             ivf_scale["modes"]["i8q"]["launches"])):
        r = ivf_kernels[f"{layout}{IVF_NLIST} {body}"]
        kernels.append({"name": name, "route": "cuda", "source": ivf_src,
                        "replaces": f"denseretrievaltoolkits_tpu/ops/ivf_bulk.py:{line}",
                        "launches": r["launches"] if launches is None else launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "launched_bound_ms": r["launched_bound_ms"], "body": r["body"]})
    # the PQ kernels: K15 / K16 times at the 1M-row phase, per launch like their
    # launches (a launch is one chunk: its decode pass and its scoring launch; times
    # are a call's over its launches, the decode passes' and the scoring launches'
    # apart, and `ms_call` the call's), launches on the path that runs each (K16 the
    # PQ96 evaluation, K15 the 1M-row serve searches; the scoring body's, with the
    # decode pass's beside them); K17 times at the 8.8M-row IVF-PQ search's own slab,
    # launches on the IVF16,PQ96x4 evaluation
    k17 = pq_scale["OPQ192x4,IVF256,PQ192x4"]
    pq_src = ", ".join(src + f for f in ("pq_serve.cu", "serve_select.cuh", "hopper.cuh",
                                         "common.cuh"))
    pq96_launches = pq_eval["PQ96"]["launches"]
    for name, line, r, launches, decode_launches in (
            ("pq_topj_blocks (K15, 8-bit codes)", "pq.py:349", pq_kernels["K15 8-bit"],
             pq_kernels["K15 8-bit"]["launches"], pq_kernels["K15 8-bit"]["decode_launches"]),
            ("pq_topj_blocks (K15, 4-bit codes)", "pq.py:409", pq_kernels["K15 4-bit"],
             pq_kernels["K15 4-bit"]["launches"], pq_kernels["K15 4-bit"]["decode_launches"]),
            ("pq_topj_blocks (K16, int8 codebook)", "pq.py:293", pq_kernels["K16"],
             pq96_launches["pq_topj_blocks (K16)"],
             pq96_launches["pq_topj_blocks (decode pass)"]),
            ("ragged_topj_pq (K17)", "ivf_pq.py:58", dict(k17, ms=k17["kernel_ms"]),
             pq_eval["IVF16,PQ96x4"]["launches"]["ragged_topj_pq (K17)"], None)):
        row = {"name": name, "route": "cuda",
               "source": ivf_src if decode_launches is None else pq_src,
               "replaces": f"denseretrievaltoolkits_tpu/ops/{line}",
               "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None}
        if decode_launches is None:  # K17: the body that ran, the slab's filled slots
            row.update(body=r["body"], filled_slots=r["filled_slots"])
        else:
            per = r["launches_per_call"]
            row.update({k: r[k] / per for k in ("ms", "plain_ms", "bound_ms")},
                       decode_ms=r["decode_ms"] / per, score_ms=r["score_ms"] / per,
                       decode_launches=decode_launches, launches_per_call=per,
                       ms_call=r["ms"], scratch_peak_bytes=r["scratch_peak_bytes"])
        kernels.append(row)
    # flash attention and K18: times at B=64, S=512 bf16 (K18 also at S=156, its design
    # shape); launches on the S=512 serving path (F-fwd) and training path (F-dkv, F-dq);
    # K18's on both, counted there like the others (no path calls it, as in the
    # reference, where K1 superseded it).
    for name, key, replaces, launches in (
            ("flash_fwd (F-fwd)", "F-fwd bfloat16 B=64 S=512",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:331 (stock Pallas flash "
             "attention, reached from denseretrievaltoolkits_tpu/models/bert.py:159)",
             flash_serving["launches"]["flash_fwd"]),
            ("flash_bwd_dkv (F-dkv)", "F-dkv bf16 B=64 S=512",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
             flash_train["launches"]["flash_bwd_dkv"]),
            ("flash_bwd_dq (F-dq)", "F-dq bf16 B=64 S=512",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
             flash_train["launches"]["flash_bwd_dq"]),
            ("fused_qkv_attention (K18)", "K18 bf16 B=64 S=512",
             "denseretrievaltoolkits_tpu/ops/attn.py:47",
             flash_serving["launches"]["fused_qkv_attention"]
             + flash_train["launches"]["fused_qkv_attention"])):
        r = flash_kernels[key]
        row = {"name": name, "route": "cuda", "source": src + "flash_attn.cu",
               "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if key.startswith("F-"):  # the LoRA step at S=512
            row["lora_launches"] = lora["flash_launches"][name.split(" ")[0]]
        if "library_fwd_bwd_ms" in r:
            row.update(fwd_bwd_ms=r["fwd_bwd_ms"], library_fwd_bwd_ms=r["library_fwd_bwd_ms"],
                       bwd_ms=r["bwd_ms"], library_bwd_ms=r["library_bwd_ms"],
                       kernels_bwd_ms=r["kernels_bwd_ms"])
        kernels.append(row)
    # every path above searched int4 rows at H = 768 / 384: K10's s8 body took them all
    check(topk.block_topj.launches_int4_generic == 0,
          f"K10: block_topj.cu's FFMA body ran {topk.block_topj.launches_int4_generic} times on "
          f"the paths")
    # and int8 / int4 rows under int8 queries (K12) and int4 rows under bf16 ones (K11):
    # flat_serve.cu's body took them all
    serve_generic = {"K11": topk.block_topj_serve.launches_int4_generic,
                     "K12 int8": topk.block_topj_i8q.launches_generic,
                     "K12 sq4": topk.block_topj_i8q.launches_int4_generic}
    for row in kernels:
        if row["name"].startswith(("block_topj_i8q", "block_topj_serve (K11")):
            row["generic_launches"] = serve_generic[
                "K11" if "K11" in row["name"] else "K12 sq4" if "sq4" in row["name"]
                else "K12 int8"]
    check(not any(serve_generic.values()),
          f"K11 / K12: block_topj.cu's body ran on the paths: {serve_generic}")
    # and int8 rows under bf16 queries, certified (K6), and fp32, bf16 and int8 rows, serve (K8,
    # the IVF side scans too): flat_serve.cu's and flat_certified.cu's bodies
    flat8_generic = {"K6": topk.block_topj.launches_int8_generic,
                     "K8": topk.block_topj_serve.launches_generic}
    check(not any(flat8_generic.values()),
          f"K6 / K8: block_topj.cu's body ran on the paths: {flat8_generic}")
    # and fp32 / bf16 rows (K5) and the loss's backward (K4) at H = 768: their new bodies
    kernels[2]["generic_launches"] = topk.block_topj.launches_generic
    check(topk.block_topj.launches_generic == 0,
          f"K5: block_topj.cu's body ran {topk.block_topj.launches_generic} times on the paths")
    k34_generic = (contrastive.contrastive_fwd.launches_generic,
                   contrastive.contrastive_bwd_dq.launches_generic,
                   contrastive.contrastive_bwd_dp.launches_generic)
    check(k34_generic == (0, 0, 0),
          f"K3 / K4 (dq, dp): the FFMA body ran {k34_generic} times on the paths")
    # phase 29's launches, rank by rank (K13: IVF16,SQ8's one-process reference on rank 0
    # runs the fixed-capacity cells; the sharded IVF index is ragged, K14), and phase 28's
    dist_keys = {"fused_attention_ln": "K1 fused_attention_ln",
                 "fused_mlp_ln": "K2 fused_mlp_ln", "block_topj": "K5 block_topj",
                 "contrastive_fwd": "K3 contrastive_fwd",
                 "contrastive_bwd_dq": "K4 contrastive_bwd_dq",
                 "contrastive_bwd_dp": "K4 contrastive_bwd_dp",
                 "block_topj (K6, int8 rows)": "K6 block_topj int8",
                 "quantize_int8_device": "K7 quantize_int8_device",
                 "block_topj_serve": "K8 block_topj_serve", "block_topj_i8q": "K12 block_topj_i8q",
                 "cell_topj (K13, int8 cells)": "K13 cell_topj",
                 "ragged_topj (K14, int8 cells)": "K14 ragged_topj",
                 "pq_topj_blocks (K15, 4-bit codes)": "K15 pq_topj_blocks 4-bit",
                 "pq_topj_blocks (K16, int8 codebook)": "K16 pq_topj_blocks int8 codebook",
                 "ragged_topj_pq (K17)": "K17 ragged_topj_pq"}
    for row in kernels:
        key = dist_keys.get(row["name"])
        if key is not None:
            row["dist_launches_by_rank"] = [r[key] for r in dist["launches_by_rank"]]
            row["dist_reference_launches"] = dist["reference_launches"][key]
        if row["name"].startswith("contrastive_"):
            row["optimizer_launches"] = {n: o["launches"][row["name"]]
                                         for n, o in optimizers.items()}
    # phase 30's launches, stage by stage (the CLIs, the quality_trend twin, graft_entry's
    # step and the profile_encoder twin, whose 'flash' encodes run F-fwd)
    cli_keys = {"fused_attention_ln": "K1 fused_attention_ln", "fused_mlp_ln": "K2 fused_mlp_ln",
                "block_topj": "K5 block_topj", "contrastive_fwd": "K3 contrastive_fwd",
                "contrastive_bwd_dq": "K4 contrastive_bwd_dq",
                "contrastive_bwd_dp": "K4 contrastive_bwd_dp",
                "block_topj_serve": "K8 block_topj_serve", "flash_fwd (F-fwd)": "F-fwd flash_fwd"}
    cli_stages = ("train_random", "encode_passages", "encode_queries", "retrieve", "train_bm25",
                  "rerank", "quality_trend", "entry", "profile_counts")
    for row in kernels:
        key = cli_keys.get(row["name"])
        if key is not None:
            row["cli_launches"] = {st: cli[st][key] for st in cli_stages if cli[st][key]}
    # phase 29 (e)'s tensor-parallel steps (a rank's launches by attention) and phase 31's
    # recipe twins
    tp_keys = {"fused_attention_ln": "K1 fused_attention_ln", "fused_mlp_ln": "K2 fused_mlp_ln",
               "contrastive_fwd": "K3 contrastive_fwd",
               "contrastive_bwd_dq": "K4 contrastive_bwd_dq",
               "contrastive_bwd_dp": "K4 contrastive_bwd_dp",
               "flash_fwd (F-fwd)": "F-fwd flash_fwd", "flash_bwd_dkv (F-dkv)": "F-dkv flash_bwd_dkv",
               "flash_bwd_dq (F-dq)": "F-dq flash_bwd_dq"}
    recipe_keys = {"fused_attention_ln": "K1 fused_attention_ln",
                   "fused_mlp_ln": "K2 fused_mlp_ln",
                   "quantize_int8_device": "K7 quantize_int8_device",
                   "block_topj_serve": "K8 block_topj_serve",
                   "quantize_int4_device": "K9 quantize_int4_device",
                   "block_topj_serve (K11, int4 rows)": "K11 block_topj_serve int4",
                   "block_topj_i8q (K12 sq4, int4 rows)": "K12 sq4 block_topj_i8q int4",
                   "ragged_topj (K14, int8 cells)": "K14 ragged_topj",
                   "pq_topj_blocks (K15, 4-bit codes)": "K15 pq_topj_blocks 4-bit",
                   "ragged_topj_pq (K17)": "K17 ragged_topj_pq"}
    for row in kernels:
        key = tp_keys.get(row["name"])
        if key is not None:
            row["tp_launches"] = {att: n[key] for att, n in dist["tp_launches"].items()}
        key = recipe_keys.get(row["name"])
        if key is not None:
            row["recipe_launches"] = recipes["launches"][key]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "build_s": _native.build_seconds, "block_kernels": blocks,
                       "k5": k5, "k3_k4": k34, "main_path": main_path, "train": train,
                       "grad_cache": grad_cache, "remat": remat, "lora": lora,
                       "mining": mining, "rerank": rerank, "optimizers": optimizers,
                       "dist": dist, "cli": cli, "recipes": recipes, "phase_seconds": seconds,
                       "k7": k7, "int8_topk": int8_topk, "int8_path": int8_path,
                       "scale": scale, "k9": k9, "int4_topk": int4_topk,
                       "eval_path": eval_path, "scale4": scale4, "ivf_kernels": ivf_kernels,
                       "ivf_eval": ivf_eval, "ivf_scale": ivf_scale, "pq_kernels": pq_kernels,
                       "pq_eval": pq_eval, "pq96_plain_encoder_gaps": plain_pq96, "pq_scale": pq_scale, "flash_kernels": flash_kernels,
                       "flash_serving": flash_serving, "flash_train": flash_train,
                       "kernels": kernels}, fh,
                      indent=1, default=str)
    log(f"phase seconds: {json.dumps(seconds)}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
