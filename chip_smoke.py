#!/usr/bin/env python3
"""On-card smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--batches 4]

Phases, in order; any failure raises, so the script exits non-zero and
never prints the final line.  Every phase prints its seconds.

  1. card     the ``nvidia-smi`` name/power-limit line and torch's name;
  2. build    every CUDA kernel from this checkout's sources (one nvcc
              per source, in parallel) into ``build/kernels/``, while
              phase 3 synthesizes its planes on the host; joined before
              phase 4;
  3. index    the ``serve_msmarco`` shape (configs/hi2_synth.py:
              8,841,984 docs, h=768, L=10,000, V=30,528, capacities
              1,024, OPQ m=96 k=256) synthesized on the host from
              ``--seed``, with a (V, Ct) f32 BM25 impact plane, and
              moved to the card;
  4. parity   each kernel against its plain PyTorch version on the
              card at edge shapes (for ``topk_scores`` also h = 37 and a
              view one element off 16-byte alignment, which take its
              element-wise copies, scores rising with the id, all scores
              equal, k 128 of L 129 and the runtime's buckets 1 and 8),
              and the two kernels of the ``opq`` path at its full width;
  5. serving  ``Server(ServeConfig(kc=30, k2=32, top_r=100,
              max_batch=256))`` answers ``--batches`` batches of 256
              queries with every launch count reset just before; each
              kernel of the path must have launched, and each query must
              rank first the positive planted for it (recall@1 = 1);
  5b. unfused ``pq_adc`` over phase 4's candidates gathered into
              (B, C, m) codes, uint8 and int32: against its plain
              version, bitwise equal to ``pq_adc_fused`` on live lanes,
              and timed beside its bound;
  6. check    the first 8 queries against the same search on the CPU
              (the plain path) over the same planes;
  7. times    each kernel, its plain version and the library yardstick
              with CUDA events, beside the kernel's bound (and, for
              ``topk_scores``, its share of that bound);
  8. profile  device time by kernel over one served batch
              (torch.profiler) and the device's busy share;
  8b-d. fused the same server with ``fusion_weight=0.5`` (hybrid
              dense∥sparse, DESIGN.md §13) answers ``--batches`` batches;
              weight 1.0 ids bitwise equal to phase 5's, weight 0.0
              equal to a host BM25 oracle, weight 0.5 against the CPU
              plain path on 8 queries; one profiled fused batch;
  9. refine   the ``serve_msmarco_refine_sq8`` setting (codec
              ``refine:sq8:4``) over the same lists: an fp16 refine
              plane drawn on the card from ``--seed`` and its SQ8
              encoding (the codec's own train + encode, on the card),
              then phases 4–8 again for ``sq8_dot_fused`` at that width;
 10. build    the port's own index build on the card: the synthetic
              corpus at N = 1,048,576 (full widths; made on the host by
              a process of its own from the start, beside phases 3-9),
              built as
              ``refine:sq8:4``, then ``opq`` and ``flat`` over the same
              KMeans; each is served in 256-query batches and scored
              (R@100, MRR@10) beside the brute-force ``flat.search``;
              ``refine:sq8:4`` must stay within 0.01 R@100 of ``flat``.
              Each build is a counted run: KMeans and OPQ training must
              launch ``assign_argmax`` the expected number of times.
              The ``opq`` build carries the BM25 impact plane of its
              corpus (``sparse=True``) and is also served fused;
 11a. flash   ``flash_attention`` against its plain version at edge cases
              (f32 / bf16, d 16-128, causal, windows, GQA, ragged and
              fully-masked rows, strided inputs; out and lse), inputs one
              element off 16-byte alignment (the element-wise load
              instance), 828 items (more than one wave of resident
              blocks, ragged in Sq), one full encoder chunk in f32, and
              llama3-8b's attention shape;
 11b. assign  ``assign_argmax`` against its plain version at ragged N / L,
              h 8 / 40 / 768, h 37 and a misaligned view (the 4-byte
              copies), PQ's strided views at d_sub 4 / 8 / 12 (the narrow
              instances), the batched PQ axis, constructed ties, and the
              build's full width on 65,536 corpus points, printing the
              largest absolute and relative score errors;
 12. sup      the HI²_sup indexing path: the term-scorer encoder at the
              paper's BERT slot (768-d, 12 heads, 2 layers, V = 30,528;
              random weights from ``--seed`` carried across in the
              reference's leaf layout) and phase 10's cluster embeddings;
              position scores of 1,024 docs against the CPU plain path;
              ``build_sup_index(codec="refine:sq8:4")`` over all N as a
              counted run (one ``flash_attention`` launch per layer per
              4,096-doc chunk); 4 x 256 queries served and 8 checked
              against the CPU; R@100 / MRR@10 beside phase 10's;
 13. times    ``flash_attention`` (at the encoder chunk's and llama3-8b's
              shapes, with its share of the bound; at llama3-8b the
              tensor-core instance against the card's bf16 tensor-core
              peak) and ``assign_argmax`` at the build's KMeans and PQ
              shapes, beside their bounds, plain versions and library
              yardsticks;
 14. bench    the port's ``kernel_bench`` at its full shapes with
              ``--check`` semantics, as a counted run; its report is
              printed as a JSON line;
 15. mutable  the mutable index (DESIGN.md §8) over phase 10's corpus at
              full widths: a base over its first 983,040 documents and a
              65,536-slot delta (28-slot delta lists), the last 65,536
              streamed in at fills 0.25, 0.5 and 1.0.  15a ``opq`` with
              the impact plane: serves 4 x 256 queries dense and fused at
              fill 0 and after each ``add_docs`` (each a counted run:
              ``topk_scores`` once a batch, ``pq_adc_fused`` twice, base
              and delta; each ``add_docs`` one ``assign_argmax``); deletes
              the top 10 of the last dense batch and a quarter of the
              streamed ids, which no later result may hold; 8 queries
              against the CPU plain path over the same base, delta and
              tombstones; a profiled dense and fused batch; ``compact()``
              against ``hi.build`` over the survivors with the same seed,
              leaf for leaf and on the first batch bit for bit.  15b
              ``refine:sq8:4``: the same stream, deletes and CPU check
              (``sq8_dot_fused`` twice a batch, the two-family refine);
 16. runtime  the serving runtime (``launch/runtime.py``, one CUDA graph
              captured per bucket 1, 2, 4, …, 256), in three parts, each
              where its index is on the card: 16a after 8d on phase 3's
              ``opq`` index, dense and fused at 0.5 — warmup as a
              counted run (one capture a bucket, its seconds and the
              pool's bytes), every bucket bit for bit against
              ``Server.query``'s 256-row pad, a replayed 256-query batch
              against an eager one (and its profile), ``qps_serial``
              against ``qps_runtime`` over 1,024 one-query submissions,
              then Poisson arrivals at a quarter of the burst rate
              (p50/p95/p99); 16b after 9f, the same checks on the
              ``refine:sq8:4`` index; 16c after 15a on its compacted
              mutable index: ``add``/``delete`` between batches capture
              nothing and the rows equal ``MutableServer.query``'s, and
              ``compact()`` captures once a bucket;
 17. tuner    the width tuner (DESIGN.md §14) right after phase 10, on
              its indexes and 1,024 held-out queries, with
              ``benchmarks/autotune.py``'s framing (oracle the exact
              top-10 of phase 10's ``flat.search``, target 0.96 x the
              recall at the default widths): 17a ``tune_index`` on
              ``opq`` and 17b on ``refine:sq8:4`` with multipliers 2, 4,
              8, each a counted run printing every point (with the ms of
              a 256-query batch), the frontier, the record and the
              default's cost, failing unless ``select`` gives the record
              or if a plane moved; 17c ``apply_tuned``, ``save_index``
              into build/ and ``load_index``: a batch bitwise equal
              before and after, a default-config ``Server`` serving the
              tuned widths, the manifest's ``extra.tuned``; 17d the
              adaptive runtime over the tuned ``opq`` index (its
              calibrated ladder, else a two-rung one cut at the median
              margin): one capture per (bucket, rung), 1,024 one-query
              requests with none captured, every row bitwise at its
              rung, every rung dispatched, a replay pass from the cache;
              ``qps_runtime`` adaptive against single-rung,
              ``_rung_for``'s µs, the pool's bytes, and
              ``bucket_invariance``; 17e ``autotune.py --check`` on the
              card at its smoke shape (every contract) and its full
              shape (contracts (c)-(e); (a) and (b) printed);
 18. train    HI²_sup training (paper §4.3) at the paper's BERT slot
              (d 768, 12 heads, d_ff 3,072, 2 layers, f32) over phase
              10's corpus (V 30,528, L 10,000): 18a the differentiable
              ``flash_attention`` (kernel forward, the reference's
              recompute backward) against autograd through the plain
              version at the step's doc and query chunks, a ragged S and
              a window (dq, dk, dv within 1e-4); 18b one step of 4
              queries x 12 candidates (1 positive + 7 hard + 4 in-batch,
              refine weight 0.5) from phase 10's cluster embeddings: the
              loss, its aux terms and every gradient leaf against the
              CPU plain path; 18c ``train_hi2_sup`` for 50 steps of 32
              queries (25,600 tokens: 32 query tokens and 12 x 64 doc
              tokens a query), negatives mined from phase 10's
              ``opq`` index and united with the topic pool, as a counted
              run (4 ``flash_attention`` launches a step; KMeans'
              ``assign_argmax``; the mining's search): steps/s,
              tokens/s, the windowed loss means (which must fall) and
              one profiled step; 18d two 6-step ``fit`` runs equal bit
              for bit, and a run saved at step 3 and resumed equal to
              the straight run; 18e the port's ``sup_distill.py
              --check`` at its smoke and full shapes;
 19. paper    the paper's benchmarks and examples (``repro_torch.
              benchmarks``, ``repro_torch.examples``), after phase 18 on
              phase 10's corpus and indexes, as one counted run: 19a
              each at its reference size (N 20,000, h 64, L 256, OPQ m
              8 k 256; seed 0): ``table3_codec`` over the five codecs
              with ``--check`` semantics (the DESIGN.md §7 refine
              contract), its rows also over the indexes moved to the CPU
              (every field equal, recall and MRR within their near-tie
              queries / n_queries), ``table2_robustness``,
              ``fig4_ablation`` (held to the CPU the same way),
              ``fig3_tradeoff`` and ``table1_main`` (HI²_sup trained on
              the card for 200 steps), ``hybrid_fusion`` and
              ``filtered_search`` with ``--check``, and the three
              examples; 19b Table 3's rows over phase 10's corpus and
              KMeans at full width (K^C 30, K₂ᵀ 32, R 100; its ``opq``
              and ``flat`` indexes, ``pq``, ``refine`` and ``sq8`` built
              over the same lists), the §7 contract's status printed,
              not failed, and Figure 4's curves over its ``opq`` index;
 20. mesh     document-sharded and 2-D mesh serving (DESIGN.md §6, §12),
              every mesh position on the one card (the reference
              emulates devices on a CPU; here S positions share one
              H100, so S > 1 measures the split, not scaling), each a
              counted run bitwise equal (ids, scores, n_candidates) to
              ``Server`` and every position launching the path's kernels:
              20a after 16a, phase 3's index through ``ShardedServer`` at
              S = 2 and 4 (and ``Server`` timed the same way), its plane
              bytes a position, the 4 x 256 batches dense and, at S = 4,
              fused at 0.5; 20b after 16b, phase 9's ``refine:sq8:4`` at
              S = 4 (``sq8_dot_fused`` a shard, refine's psum); 20c after
              19, phase 10's ``opq`` index with a namespace plane (doc id
              mod 8): filtered at S = 4, a (2, 2) ``MeshServer`` dense and
              filtered, then the shard-loss drill (checkpoint under
              build/, eject shard 0: ``partial``, nothing from its range,
              ids and scores equal to a ``MutableServer`` with the range
              tombstoned; the last shard refused; rejoin bitwise equal);
              20d ``sharded_search.py --devices 4 --device cuda`` at its
              reference size, every ``doc_ids_identical`` true;
 21. mesh-rt  the serving runtime over a mesh and the sharded mutable
              index (DESIGN.md §8, §10, §12), every position on the one
              card, one CUDA graph per bucket per mesh captured across
              the positions' streams: 21a after 20a, on phase 3's index,
              the runtime over ``ShardedServer`` at S = 4 and a (2, 2)
              ``MeshServer`` (9 and 8 captures, the quantum-2 ladder
              2…256 on the mesh; capture seconds and pool bytes), every
              bucket bit for bit against phase 5's ``Server`` rows, a
              replayed 256-query batch against an eager one with its
              profile, ``qps_serial`` (64 requests) against
              ``qps_runtime`` (1,024) with every replica dispatched;
              21b after phase 15, 15a replayed on the mesh: a fresh
              mutable index over 15a's base served by
              ``ShardedMutableServer`` at S = 4 and on (2, 2), the same
              65,536 documents streamed in at fills 0.25, 0.5 and 1.0
              and the same ids deleted through a runtime over the (2, 2)
              server, every state dense and fused at 0.5 bit for bit
              equal to 15a's ``MutableServer`` rows, every added id in
              its owning shard's planes, nothing captured across
              add/delete, ``compact()`` captured once a bucket and equal
              to 15a's compacted index; 21c after 20d,
              ``mesh_serving.py --device cuda`` at its reference size
              (every result contract, every geometry captured; the
              emulated (2, 1) gate printed) and ``serving_load.py``'s
              four layouts with every contract;
 22. mesh-build  build and training over a mesh (A4b items 4-5), every
              position on the one card, after 21c: 22a
              ``kmeans_fit_sharded`` over phase 10's corpus (N 1,048,576,
              h 768, L 10,000, 15 steps) split in four row blocks (views)
              on a ``make_shard_mesh(4)`` of the card, as a counted run
              (one ``assign_argmax`` a position a step): positions bitwise
              equal, the cost below the random init's and within 1% of
              single-device ``kmeans_fit`` (both timed), one step from
              shared centroids against the single-device step (counts
              exact, sums within 1e-5, near-tie rows judged in float64)
              and, on 65,536 points, the card's sharded step against the
              CPU's; 22b four gradient trees of phase 18's configuration
              (four batches, one a position): ``flat_allreduce`` at S = 4
              and on a (pod 2, data 2) mesh with ``hierarchical_
              allreduce``, every position the same bits, within 1e-5 of
              the summands' magnitudes of the float64 sum and of each
              other (one leaf on the flat fallback), ``pmean_metrics`` of
              the losses, ms an all-reduce and one profiled; 50 steps of
              ``compress_with_ef`` bitwise equal to the CPU; 22c phase
              18's {params, opt} saved under build/ and
              ``restore_resharded`` onto the card and split over 2 and 4
              positions, every leaf reassembled bitwise equal;
 23. recsys   the recsys family at its published configs (configs/
              dlrm_rm2.py, sasrec.py, dien.py, mind.py; DLRM's 26 x 10⁶ x
              64 tables, 6.66 GB), weights drawn on the card from
              ``--seed``, after phase 22: 23a each arch's
              ``recsys/serve`` function (``dlrm_forward``,
              ``sasrec_user_embedding``, ``dien_forward``,
              ``mind_interests``) at ``serve_p99`` (B 512) and
              ``serve_bulk`` (B 262,144) as counted runs, ms a batch, the
              first 8 rows within 1e-4 of the CPU plain path on the same
              weights, SASRec two ``flash_attention`` launches a call
              (d 50), SASRec's bulk and DIEN's 512-row call profiled;
              23b ``retrieval_cand`` (1 query x 10⁶ candidates, top
              100), ids equal to the CPU's up to swaps within 1e-4 (DLRM
              and DIEN over 65,536 / 16,384 random candidates plus the
              card's top 100 on the CPU); 23c HI² over SASRec's 10⁶ x 50
              item table with the example's recipe (three item tokens,
              vocab 2,048, K₁ᵀ 3, capacities 512 / 128, 8 KMeans steps,
              ``flat``) at L 6,400, 512 users with K^C 6, K₂ᵀ 3, R 10:
              build s and launches (9 ``assign_argmax``), batch ms, mean
              candidates, the share whose exact top-1 item is in HI²'s
              top 10, 8 users against the CPU over the same planes; 23d
              ``flash_attention`` at d 50 against its plain version (f32
              and bf16, causal and not, S 1 / 50 / 130 at B 1 and
              262,144, misaligned views), timed at SASRec's shape at B
              512 and 262,144 beside SDPA and the bound; 23e the
              ``recsys_retrieval`` example on the card;
 24. training the recsys and graph families' training cells (the
              reference's ``launch/cells.py`` ``train_step``: value and
              grad, clip 1.0, AdamW at lr 1e-4, ``train.cell_step``),
              3 steps each from weights drawn from ``--seed``: 24a
              DLRM, SASRec, DIEN and MIND at their published configs
              and ``train_batch`` (B 65,536), loss and grad norm a
              step, median step ms, peak GB, SASRec's two
              ``flash_attention`` forwards a step as a counted run,
              DIEN's step (whole, as the cell runs it) profiled; one
              step at B 512 against the CPU: loss, grad norm and every
              updated leaf within 1e-4, each leaf of both Adam moments
              within 1% of the CPU's in norm, every leaf's update (new
              − old) within rtol 1e-4, atol 1e-6 of AdamW's formula over
              the card's own moments (DLRM's tables compared on the rows
              the batch read, the CPU stepping only those); 24b
              GatedGCN at ``make_config(shape)`` (16 layers, d 70,
              remat) on ``full_graph_sm``, ``molecule`` and
              ``minibatch_lg`` (1,024 seeds, fanout (15, 10), from a
              parent graph cut to 10 edges a node), step ms, loss, peak
              GB, launches a step, one step against the CPU as 24a's,
              ``minibatch_lg``'s step profiled; ``ogb_products``
              reported as not run (its sizes); 24c ``full_graph_sm``
              split by ``partition_by_dst`` over 4 positions of the
              card, ``loss_fn_partitioned``'s loss within 1e-5 of
              ``loss_fn``'s and its gradients within 1e-4, under a
              300 s timeout that ends the run (exit 1) on a hang;
 25. lm       the dense LM family (``models/transformer.py``) at
              ``make_config()`` (bf16 compute, fp32 weights from
              ``--seed``), after freeing the cuBLAS workspaces of earlier
              phases' streams: 25a internlm2-1.8b and stablelm-3b trained
              (the reference's ``_lm_train_cell`` step: value and grad
              with per-layer remat, clip 1.0, AdamW at lr 1e-4, in place
              as the cell donates) at train_4k's S 4,096, B cut to
              LM_TRAIN_B: 3 steps each as a counted run (2·L
              ``flash_attention`` launches a step), loss, grad norm, ms,
              tokens/s, the model-FLOP share, peak GB, the kernel held
              against its plain version at the arch's shape and timed
              there beside its bound, SDPA and the plain version,
              internlm2-1.8b's step profiled; first one step of
              each at full width, 2 layers, f32 (B 1, S 256) against the
              CPU as phase 24 holds a step;
              llama3-8b's training reported as not run (its state is
              128.5 GB); 25b llama3-8b ``prefill_step`` at prefill_32k's
              S 32,768, B 1; 25c llama3-8b ``prefill_step`` at B 8 x
              4,096 then 64 greedy ``serve_step`` calls, ms a token,
              one step profiled; 25d llama3-8b at full width, 2 layers, f32
              against the CPU (logits_fn, loss_fn, prefill_step's
              logits and caches, 8 serve steps, within 1e-4), a window-16
              rolling decode against logits_fn at every position (2e-4),
              and 25c's first decoded logits (full depth, bf16) against
              logits_fn over the same 4,097 tokens at window 4,096;
 26. moe      the MoE LM family (``models/moe.py`` in
              ``models/transformer.py``) at ``make_config()`` (bf16
              compute, fp32 weights from ``--seed``): 26e first, in f32
              against the CPU, every call's routes (expert, position,
              kept) before its outputs: olmoe-1b-7b at full width and 2
              layers (B 1, S 256: logits_fn, loss_fn, prefill_step's
              logits and caches, 8 serve steps, one cell step as phase 24
              holds a step), mixtral-8x22b at full width and 1 layer
              (logits_fn, prefill_step, 8 serve steps, and a window-16
              rolling decode at capacity factor E/k against logits_fn),
              ``forward_shard_map`` over (2, 2) and (2, 1) positions of
              the card at OLMoE's layer width against ``forward`` at
              capacity factor 8.0, gradients included (3e-4); 26c
              olmoe-1b-7b trained at train_4k's S 4,096, 8 of 16 layers,
              B MOE_TRAIN_B: 3 steps as a counted run, loss, moe_aux,
              grad norm, ms, tokens/s, the model-FLOP share over the
              active parameters, peak GB, the dropped share by layer, one
              step profiled; 26f ``flash_attention`` at 26c's shape and
              at Mixtral's windowed shape (S 8,192, 48/8 heads, window
              4,096) against its plain version, timed beside its bound,
              SDPA and the plain version; 26a olmoe-1b-7b at full depth:
              ``prefill_step`` at S 32,768, B 1; 26b its ``prefill_step``
              at B 8 x 4,096 then 64 greedy ``serve_step`` calls, ms a
              step, the share of a decode batch's assignments dropped at
              capacity 1, one step profiled; 26d mixtral-8x22b at full
              width and MOE_WIDE_LAYERS layers: the same prefill and
              decode (over its rolling 4,096-slot cache), and one layer
              trained at MOE_TRAIN_B; ``long_500k`` reported as not run
              (its sizes);
 27. dryrun   the dry run (``launch/cells.py``, ``dryrun.py``) after 26:
              the ``topk_scores`` and ``sq8_dot_fused`` libraries' tiles
              against the ones their fake paths shape scratch by; 27a
              four cells on fake CUDA tensors and really on the card
              with leaves drawn from ``--seed``, each cut alike for both
              runs (olmoe-1b-7b ``train_4k`` at 2 layers and B 2, SASRec
              ``serve_bulk``, hi2-synth ``serve_msmarco_bucket8`` at full
              N, ``serve_msmarco_refine_sq8`` as one position of a (2, 2)
              mesh of the card), counted FLOPs and argument bytes equal
              exactly, every output's shape and dtype equal, the fake
              peak within 10% of ``max_memory_allocated`` above the
              start; 27b ``python -m repro_torch.launch.dryrun`` on
              mixtral-8x22b's four shapes, GatedGCN ``ogb_products`` and
              the five hi2-synth cells, each record ``ok``, its peak GB,
              fits, FLOPs, dominant term and seconds printed;
 28. bench    the port's bench driver and regression gate, each call in
              a fresh process under a timeout that kills its session:
              28a ``python -m repro_torch.benchmarks.run --list`` names
              the reference's 14 benchmarks, and ``run --device cuda``,
              the whole suite with the driver's extras, prints each of
              the reference's 71 rows once, no flag that a ``--check``
              contract requires reading other than True; 28b:
              ``kernel_bench`` and
              ``table3_codec`` at ``--smoke --check`` and
              ``sharded_search`` at the driver's arguments, twice each
              into ``build/bench_gate/{a,b}``; ``check_regression
              --timing-ratio inf`` holds b to a (exit 0: every exact
              field bit-equal across processes), each wall-clock
              field's max/min ratio printed, and a copy of b with one
              ``R@100`` moved by one ulp must exit 1 naming that path.
              28a's processes start before phase 27 and run beside it;
              28b's six run after it, one after another with nothing
              else on the card.  Their launches are their own, in no
              count here;

The script then prints the ``kernels`` JSON line and, last, the ``ok`` line.  Each
kernel's ``launches`` is read from the counted runs of the paths that
run it: ``pq_adc_fused`` and ``topk_scores`` from phase 5,
``sq8_dot_fused`` from 9c, ``assign_argmax`` from phase 10's builds,
18c and 22a, ``flash_attention`` from phase 12 and 18c, ``pq_adc`` from phase
14, each plus its launches in phases 19, 20 and 21 (20a-20c's sharded
runs, not their single-device yardsticks, and 20d's whole benchmark run,
its index build and single-device baseline searches included; 21a's
warmups, 21b's eager checks, warmup, adds and compaction, and 21c's two
benchmark runs whole), in phase 23 (its serve, retrieval and HI²
calls and the example; not 23d's checks) and in phase 24 (24a's timed
steps: SASRec's flash forwards) and in phase 25 (25a's timed steps,
25b's prefill, 25c's prefill and decode steps) and phase 26 (26c's and
26d's timed steps, 26a's, 26b's and 26d's prefills and decode steps);
phase 15's counted runs are checked in the phase and printed.  ``flash_attention``'s entry also
carries 23d's times at SASRec's bulk shape under ``sasrec_shape`` and
the kernel's ms a launch in 25a's profiled steps under
``lm_train_shapes``, and 26f's two shapes under ``moe_shapes`` (each
with its launches in 26c, and in 26d at Mixtral's window).  It imports only the port, never jax or the
reference package, and exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import autotune  # noqa: E402
from repro_torch.benchmarks import bucket_invariance  # noqa: E402
from repro_torch.benchmarks import check_regression  # noqa: E402
from repro_torch.benchmarks import common as paper  # noqa: E402
from repro_torch.benchmarks import fig3_tradeoff  # noqa: E402
from repro_torch.benchmarks import fig4_ablation  # noqa: E402
from repro_torch.benchmarks import filtered_search  # noqa: E402
from repro_torch.benchmarks import hybrid_fusion  # noqa: E402
from repro_torch.benchmarks import kernel_bench  # noqa: E402
from repro_torch.benchmarks import mesh_serving  # noqa: E402
from repro_torch.benchmarks import serving_load  # noqa: E402
from repro_torch.benchmarks import sharded_search  # noqa: E402
from repro_torch.benchmarks import sup_distill  # noqa: E402
from repro_torch.benchmarks import table1_main  # noqa: E402
from repro_torch.benchmarks import table2_robustness  # noqa: E402
from repro_torch.benchmarks import table3_codec  # noqa: E402
from repro_torch.benchmarks.synth_msmarco import (  # noqa: E402
    BATCH, CLUSTER_CAP, HIDDEN, K1_TERMS, K2, KC, N_CLUSTERS, N_DOCS, PQ_K,
    PQ_M, QUERY_LEN, REFINE_CODEC, SMOKE_BATCHES, TERM_CAP, TOP_R, VOCAB,
    main_path_inputs, planted_docs, refine_index, synth_leaves,
    synth_queries)
from repro_torch.benchmarks.timing import Timer  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs import shapes as rec_shapes  # noqa: E402
from repro_torch.core import codecs  # noqa: E402
from repro_torch.core import distill  # noqa: E402
from repro_torch.core import exec as qexec  # noqa: E402
from repro_torch.core.exec import frontier  # noqa: E402
from repro_torch.core import hybrid_index as hi  # noqa: E402
from repro_torch.core import inverted_lists  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import segments  # noqa: E402
from repro_torch.core import sharded_index as shi  # noqa: E402
from repro_torch.core import term_selector as ts_mod  # noqa: E402
from repro_torch.core.codecs import flat as flat_codec  # noqa: E402
from repro_torch.core import kmeans  # noqa: E402
from repro_torch.data import graph as gdata  # noqa: E402
from repro_torch.data import recsys as rdata  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.fault import StragglerMonitor  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import recsys_retrieval as rec_example  # noqa: E402
from repro_torch.examples import serve_retrieval  # noqa: E402
from repro_torch.examples import train_hi2_distill  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign_topk import ops as at_ops  # noqa: E402
from repro_torch.kernels.assign_topk import ref as at_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.kernels.pq_adc import ref as adc_ref  # noqa: E402
from repro_torch.kernels.sq8_dot import ops as sq8_ops  # noqa: E402
from repro_torch.kernels.sq8_dot import ref as sq8_ref  # noqa: E402
from repro_torch.launch import cells as dry_cells  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import report as dry_report  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import runtime  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

# the on-card build (phase 10): N cut from 8.8 M, widths kept
BUILD_DOCS, BUILD_QUERIES, BUILD_ITERS = 1_048_576, 1_024, 15
REFINE_RECALL_GAP = 0.01             # R@100 of refine:sq8:4 vs flat
DESIGN_RECALL_GAP = 0.001            # the DESIGN.md §7 contract, reported
# assign_argmax launches of each phase-10 build: KMeans runs BUILD_ITERS
# Lloyd steps and a final assignment; OPQ (codecs/pq.py::train_opq
# defaults) fits PQ_FITS = 5 PQ codebooks of PQ_ITERS + 1 assignments,
# encodes 4 times for Procrustes, and the build encodes once more
PQ_FITS, PQ_ITERS, OPQ_OUTER = 5, 10, 4
BUILD_ASSIGN_LAUNCHES = {REFINE_CODEC: BUILD_ITERS + 1,
                         "opq": PQ_FITS * (PQ_ITERS + 1) + OPQ_OUTER + 1,
                         "flat": 0}
# the mutable index (phase 15): a base over the first MUT_BASE documents
# of phase 10's corpus, the last MUT_STREAM streamed in at MUT_FILLS of
# the delta; its lists then hold 4·⌈65,536/10,000⌉ = 28 cluster and
# 4·⌈65,536·3/30,528⌉ = 28 term slots (the reference's default formula)
MUT_STREAM = 65_536
MUT_BASE = BUILD_DOCS - MUT_STREAM
MUT_FILLS = (0.25, 0.5, 1.0)
MUT_DELTA_CAP = 28
# stage seconds of the cuBLAS + argmax assignment route that
# assign_argmax replaced, on an H100 80GB HBM3 at 700 W (PERF.md §5)
CUBLAS_ROUTE_STAGES = {"clusters": 6.65, "codec_train": 13.13}

# the HI²_sup term scorer: the encoder train_hi2_sup builds at the
# paper's BERT slot (768-d, 12 heads, d_ff 4·d, 2 layers = SupTrainConfig
# encoder_layers), f32 compute; chunks of ENCODE_BATCH documents
ENC_LAYERS, ENC_HEADS, ENCODE_BATCH = 2, 12, 4096
N_SUP_CHECK = 1_024                  # docs held against the CPU encoder
SUP_TOL = 1e-4                       # position scores, rtol = atol
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # out, rtol = atol
LSE_TOL = 1e-4
ASSIGN_TOL = 1e-5                    # rtol = atol: dot-product order
ASSIGN_BLOCK = 65_536                # points per block of a timed plane
ASSIGN_SIZES = (1, 7, 513, 10_000)   # ragged N and L of phase 11b
# llama3-8b's attention (configs/llama3_8b.py): B, S, Hq, Hkv, d (bf16)
LLAMA_ATTN = (1, 4096, 32, 8, 128)

# H100 SXM published peaks (NVIDIA H100 datasheet)
PEAK_FP32_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12             # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12                 # HBM3

ADC_TOL = 1e-4                       # rtol = atol: m-reduction order
TOPK_TOL = 1e-5                      # rtol = atol: dot-product order
SQ8_EDGE_RTOL, SQ8_EDGE_ATOL = 1e-4, 1e-2   # the JAX kernel test's own
SQ8_TOL = 1e-4                       # rtol = atol after the bias
N_CHECK = 8                          # queries held against the CPU path
FUSION_WEIGHT = 0.5                  # the fused serving phases' RRF weight
# phase 16: the runtime's checks hold a bucket's submissions together for
# up to RT_CHECK_LINGER_MS; its throughput run submits RT_REQUESTS single
# queries; 16c streams RT_MUT_ADD documents into the compacted index
RT_CHECK_LINGER_MS = 50.0
RT_REQUESTS = 1_024
RT_MUT_ADD = 16_384
# phase 17: 17b's refine multipliers; 17c's checkpoint (under build/,
# which git ignores; removed after the phase)
TUNE_MULTS = (2, 4, 8)
TUNE_CKPT = ROOT / "build" / "tuned_ckpt"
# phase 18: training at the BERT slot.  18c takes TRAIN_STEPS steps (cut
# from SupTrainConfig's 300 for the run's time) of TRAIN_BATCH queries;
# 18b holds one step of TRAIN_CHECK_B queries (cut from 32 so the CPU
# side fits the run) to the CPU; 18d repeats REPEAT_STEPS steps and
# resumes at RESUME_AT from a checkpoint under build/ (removed after)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_CHECK_B = 50, 32, 4
TRAIN_TOL = 1e-4                     # rtol = atol, f32 (DESIGN.md §11)
REPEAT_STEPS, RESUME_AT = 6, 3
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# 18a: (B, H, S, d, causal, window): the training step's doc and query
# chunks, a ragged S and a window
FLASH_GRAD_CASES = {"docs": (384, ENC_HEADS, 64, 64, False, 0),
                    "queries": (32, ENC_HEADS, 8, 64, False, 0),
                    "ragged": (3, 4, 37, 64, False, 0),
                    "window": (2, 4, 100, 32, True, 16)}

# phase 20: the sharded and mesh servers, every position on the one card:
# 20a serves phase 3's index at S in SHARDS (dense, and fused at S = 4),
# 20b phase 9's at S = 4, 20c phase 10's opq index with the namespace
# plane doc id mod MESH_NS at S = 4, filtered, then on a (data, model) =
# MESH_GEOMETRY mesh with the shard-loss drill, its checkpoint under
# build/ (removed after)
SHARDS = (2, 4)
MESH_GEOMETRY = (2, 2)
MESH_NS = 8
MESH_CKPT = ROOT / "build" / "mesh_ckpt"
# phase 21: the runtime over ShardedServer at S = MESH_RT_SHARDS and over
# the MESH_GEOMETRY MeshServer, every position on the card; its
# qps_serial over MESH_SERIAL of the RT_REQUESTS (a serial mesh query is
# a full padded batch)
MESH_RT_SHARDS = 4
MESH_SERIAL = 64
# phase 22: build and training over a mesh, every position on the one
# card.  22a fits KMeans over phase 10's corpus split in KM_SHARDS blocks
# of rows (views) and checks one step on a KM_CHECK_POINTS-point
# subsample against the CPU; 22b all-reduces GRAD_POSITIONS gradient
# trees of phase 18's configuration (timed over ALLREDUCE_REPS calls)
# and runs EF_STEPS steps of int8 compression; 22c restores phase 18's
# {params, opt} under build/ (removed after) onto the card and split
# over RESHARD_SPLITS positions
KM_SHARDS = 4
KM_CHECK_POINTS = 65_536
KM_COST_GAP = 0.01                   # sharded vs single-device cost
GRAD_POSITIONS = 4
ALLREDUCE_TOL = 1e-5                 # of Σ|summand|: the adds' order
ALLREDUCE_REPS = 5
EF_STEPS = 50
RESHARD_SPLITS = (2, 4)
RESHARD_CKPT = ROOT / "build" / "reshard_ckpt"
# phase 23: the recsys family at its published configs (configs/*.py),
# weights drawn on the card from --seed.  23a serves each arch's
# recsys/serve function at REC_SERVE's batches and holds the first
# N_CHECK rows to the CPU within REC_TOL; 23b scores 1 query against the
# retrieval_cand shape's 10⁶ candidates (top REC_TOP), DLRM and DIEN
# held to the CPU over REC_CPU_CANDS random candidates plus the card's
# top REC_TOP; 23c builds HI² over SASRec's item table at the example's
# recipe with L = 10⁶ / 156 (its items a cluster) and serves REC_USERS
# users; 23d holds flash_attention at d 50 to its plain version (the
# plain one in REC_FLASH_BLOCK-row batch blocks at B 262,144)
REC_ARCHS = ("dlrm-rm2", "sasrec", "dien", "mind")
REC_SERVE = ("serve_p99", "serve_bulk")
REC_TOL = 1e-4                       # rtol = atol, f32 sum orders
REC_TOP = 100
REC_CPU_CANDS = {"dlrm-rm2": 65_536, "dien": 16_384}
REC_CLUSTERS, REC_USERS = 6_400, 512
REC_FLASH_S = (1, 50, 130)
REC_FLASH_B = (1, 262_144)
REC_FLASH_BLOCK = 32_768
# the serve calls profiled (torch.profiler): SASRec's bulk batch, DIEN's
# 512-row one (200 GRU steps of small launches)
REC_PROFILE = (("sasrec", "serve_bulk"), ("dien", "serve_p99"))

# phase 24: training cells (the reference's launch/cells.py train_step at
# lr 1e-4, clip 1.0): each at its published config, TRAIN_CELL_STEPS steps,
# one step at REC_CHECK_B (recsys) or the cell's own batch (GNN) against
# the CPU: loss, grad norm, the updated leaves (and 24c's gradients)
# within CELL_TOL.  A first step at lr 1e-4 moves a leaf by about 1e-4,
# which CELL_TOL cannot see, so the step is held twice more: each leaf of
# both Adam moments within MOMENT_RTOL of the CPU's in norm (a zero or
# mis-scaled moment fails; elementwise, a 169,984-node sum's rounding
# reaches 3.4e-4 of a leaf's largest), and each leaf's update (new - old)
# within STEP_TOL of AdamW's formula over the card's own moments (a
# dropped or mis-scaled update fails).  The update is not held against the
# CPU's: a first step moves an element by lr * g / (|g| + eps), so where a
# gradient is near eps = 1e-8 its rounding becomes up to lr of difference.
# The partitioned GNN's loss within PARTITION_LOSS_TOL (the reference's
# bound) of loss_fn's
TRAIN_CELL_STEPS = 3
REC_CHECK_B = 512
CELL_TOL = 1e-4                      # rtol = atol, f32 sum orders
MOMENT_RTOL = 1e-2                   # ||card - CPU|| / ||CPU||, a leaf
STEP_TOL = (1e-4, 1e-6)              # (rtol, atol): f32 roundings
PARTITION_LOSS_TOL = 1e-5            # rtol
PARTITIONS = 4
PARTITION_TIMEOUT_S = 300            # a hang fails the phase, not the run
GNN_TRAIN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
# minibatch_lg's parent graph: Reddit's 232,965 nodes but 10 edges a node
# (the cell's 114,615,892 would take random_graph's per-edge loop tens of
# minutes); the sampled batch keeps the cell's shape
MINIBATCH_PARENT_EDGES = 2_329_650

# phase 25: the dense LM family at make_config() (bf16 compute, fp32
# params and AdamW state, remat).  25a trains at train_4k's S with its B
# 256 cut (in place, as the reference's cell donates it): B 10 / 12 are
# the largest that fit beside the fp32 state (PR 32), but with phase 26
# after it the smoke ran past 1,050 s, so 25a takes PR 32's earlier B 4
# / 2 (about 70 s less); llama3-8b's state (128.5 GB) does not fit.
# 25b prefills prefill_32k's length at B 1 (its B 32 cut), 25c decodes
# after a 4,096-token prefill at B 8 (decode_32k's 128 x 32,768 cache
# would be 550 GB).  25a and 25d hold LM_CHECK_LAYERS-layer copies at
# full width in f32 against the CPU: 25a one cell step as phase 24's,
# 25d logits, loss, prefill and decode within LM_TOL, the windowed
# rolling decode against logits_fn within the reference's own oracle
# bound (tests/test_perf_impls.py, 2e-4); 25d also holds 25c's first
# decoded logits, full depth in bf16, against logits_fn over the same
# 4,097 tokens at window 4,096 (a 4,096-slot cache at position 4,096 has
# evicted position 0) within LM_BF16_REL in norm: both at bf16, in other
# GEMM shapes, so bf16 roundings land elsewhere over 32 layers
LM_TRAIN_ARCHS = ("internlm2-1.8b", "stablelm-3b")
LM_TRAIN_B = {"internlm2-1.8b": 4, "stablelm-3b": 2}
LM_PROFILE_ARCH = "internlm2-1.8b"    # 25a profiles one step, of this arch
LM_SERVE_ARCH = "llama3-8b"
LM_CHECK_LAYERS = 2
LM_CHECK_TRAIN = (1, 256)            # 25a's step against the CPU: (B, S)
LM_PREFILL_B = 1                     # 25b, at prefill_32k's S
LM_DECODE = (8, 4_096, 64)           # 25c: (B, prefix, decode steps)
LM_PARITY = (2, 64, 8)               # 25d in f32: (B, S, serve steps)
LM_WINDOW = 16                       # 25d: window = cache capacity
LM_TOL = 1e-4                        # rtol = atol, f32 sum orders
LM_WINDOW_TOL = 2e-4
LM_BF16_REL = 0.05
LM_BF16_REL_FMA = 0.0175             # 25d's reading when bf16 flash ran
                                     # the fp32 FMA kernel (PERF.md)

# phase 26: the MoE LM family at make_config() (bf16 compute, fp32
# params and AdamW state, remat).  olmoe-1b-7b serves at full depth
# (27.7 GB of fp32 weights); its training state is 16 B a parameter,
# 6.71 GB a layer, so 26c trains 8 of its 16 layers (57.0 GB).  The
# sizes are the largest that leave 4 GB of the card's 85.0 beside the
# ~2.9 GB the smoke holds at phase 26 and the CUDA context's ~2 GB, from
# peaks read alone (repro_torch.benchmarks.lm_memory, PR 33 call 5):
# OLMoE's step at B 10 / 12 / 14 75.72 / 79.37 / 83.01 GB, so B 10;
# mixtral-8x22b (10.0 GB of fp32 weights a layer) serves at 4 / 5
# layers at 65.30 / 75.45 GB (6 run out), so 5, and trains 1 layer
# (46.5 GB of state) at B 6 / 8 at 70.03 / 79.79 GB (10 runs out), so
# B 7 (about 75).  Prefill at prefill_32k's S and B 1; decode at B
# 8 after a 4,096-token prefill, where a step routes B tokens at
# capacity max(int(B·k·1.25/E), 1) and drops.  26e holds f32 copies at
# full width against the CPU (every call's routes first: a route that
# differs fails unless its router logits at the cut are within
# MOE_ROUTE_GAP, a near tie, whose batch rows are then left out), and
# forward_shard_map on positions of the card against forward at
# capacity factor 8.0 within the reference's bound
# (tests/test_perf_impls.py, 3e-4)
MOE_SERVE = "olmoe-1b-7b"
MOE_WIDE = "mixtral-8x22b"
MOE_WIDE_LAYERS = 5
MOE_TRAIN_LAYERS = {MOE_SERVE: 8, MOE_WIDE: 1}
MOE_TRAIN_B = {MOE_SERVE: 10, MOE_WIDE: 7}
MOE_PREFILL_B = 1                    # 26a / 26d, at prefill_32k's S
MOE_DECODE = (8, 4_096, 64)          # (B, prefix, decode steps)
MOE_CHECK_LAYERS = {MOE_SERVE: 2, MOE_WIDE: 1}
MOE_CHECK_TRAIN = (1, 256)           # 26e OLMoE in f32: (B, S)
MOE_PARITY = (1, 64, 8)              # 26e Mixtral: (B, S, serve steps)
MOE_ROUTE_GAP = 1e-5                 # relative router-logit gap: near tie
MOE_SHARD = ((2, 2), (2, 1))         # (data, model) positions of the card
MOE_SHARD_TOKENS = (4, 256)          # (B, S) at OLMoE's layer width
MOE_SHARD_CF = 8.0
MOE_SHARD_TOL = 3e-4
# Mixtral's windowed attention at twice its window: B, S, Hq, Hkv, d, w
MOE_WINDOW_ATTN = (1, 8_192, 48, 8, 128, 4_096)

# phase 19: the paper benchmarks.  Rows held against the CPU: top-R
# ids up to swaps within PAPER_TOL, each recall or MRR within its
# near-tie queries / n_queries + PAPER_FLOAT (the f32 mean's last bits)
# phase 27: the dry run (launch/cells.py, dryrun.py) against real steps
DRY_TRAIN = ("olmoe-1b-7b", "train_4k", 2, 2)     # (arch, shape, layers, B)
DRY_SHARD_MESH = (2, 2)              # 27a's refine cell: one position of it
DRY_MEM_TOL = 0.10                   # |fake - real| / real peak bytes
DRY_CLI = (("mixtral-8x22b", None), ("gatedgcn", "ogb_products"),
           ("hi2-synth", None))      # 27b's dryrun calls: --arch, --shape
DRY_OUT = ROOT / "build" / "dryrun_smoke"
# phase 10's corpus, written by a process of its own while phases 3-9 run
CORPUS_DIR = ROOT / "build" / "smoke_corpus"

# phase 28: the bench driver and the regression gate, in fresh processes
BENCH_NAMES = ("autotune", "kernel_bench", "table1_main",
               "table2_robustness", "table3_codec", "fig3_tradeoff",
               "fig4_ablation", "sharded_search", "sup_distill",
               "streaming_updates", "filtered_search", "hybrid_fusion",
               "serving_load", "mesh_serving")
# the reference's rows of a whole run (the driver's extras first)
BENCH_ROWS = (
    "hi2_search_batch", "hi2_search_64q", "kernel/pq_adc_oracle",
    *(f"autotune/{n}" for n in ("default", "tuned", "adaptive", "runtime")),
    *(f"fig3/{n}" for n in ("IVF-OPQ", "HI2_unsup", "HI2_sup")),
    *(f"fig4/{n}" for n in ("w.o.Term(IVF)", "w.o.Clus(term-only)",
                            "HI2(full)")),
    *(f"filtered/{n}" for n in ("pass1.00", "pass0.50", "pass0.25",
                                "pass0.12", "pass0.06", "allow_all")),
    *(f"hybrid/{n}" for n in ("dense_only", "w0.00", "w0.25", "w0.50",
                              "w0.75", "w1.00", "best")),
    *(f"kernel_bench/{n}" for n in ("pq_adc", "sq8_dot", "assign_topk")),
    *(f"mesh/{n}" for n in ("1x1", "2x1", "4x1", "1x2", "2x2", "failover")),
    *(f"serving/{n}" for n in ("plain", "sharded", "mutable",
                               "sharded_mutable")),
    "sharded/baseline", "sharded/2shards",
    *(f"streaming/{n}" for n in ("fill0.00", "fill0.25", "fill0.50",
                                 "fill1.00", "compaction")),
    *(f"sup_distill/{n}" for n in ("train", "kc1k22", "kc2k24", "kc4k26",
                                   "kc6k28", "kc8k212", "kc12k216",
                                   "variants")),
    *(f"table1/{n}" for n in ("Flat(brute force)", "IVF-OPQ", "Distill-VQ",
                              "TermOnly(w.o.Clus)", "HI2_unsup", "HI2_sup")),
    *(f"table2/{m}/{n}" for m in ("encA", "encB(weaker)")
      for n in ("Flat", "IVF-OPQ", "HI2_unsup")),
    *(f"table3/{n}" for n in ("flat", "opq", "pq", "refine", "sq8")))
# derived keys whose value a --check contract of the reference requires
# True
BENCH_REQUIRED = ("identical", "isolated", "equals_unfiltered",
                  "equal_to_rebuild", "tombstones_absent", "partial",
                  "rejoin_identical", "fused_ge_dense", "fallback",
                  "roundtrip", "compact", "fused_matches_ref",
                  "unfused_matches_ref", "ids_bit_identical",
                  "scores_match")
BENCH_GATE = ROOT / "build" / "bench_gate"
BENCH_GATE_RUNS = (   # (module, the driver's arguments, report file)
    ("kernel_bench", ["--smoke", "--check"], "BENCH_kernels.json"),
    ("table3_codec", ["--smoke", "--check"], "BENCH_codec.json"),
    ("sharded_search", ["--devices", "2", "--docs", "4000", "--queries",
                        "64"], "sharded_search.json"))
BENCH_DRIVER_S = 420                 # the driver's whole run, timeout
BENCH_ONE_S = 240                    # one 28b benchmark process, timeout

PAPER_TOL = 1e-4
PAPER_FLOAT = 1e-6
PAPER_METRICS = ("R@10", "R@100", "MRR@10")
# the kernels phase 19a must launch (all but the unfused pq_adc)
PAPER_KERNELS = ("pq_adc_fused", "topk_scores", "sq8_dot_fused",
                 "assign_argmax", "flash_attention")

#: kernel → (its wrapper module, the name of its launch count there)
COUNTERS = {"pq_adc_fused": (adc_ops, "launches"),
            "pq_adc": (adc_ops, "unfused_launches"),
            "topk_scores": (at_ops, "launches"),
            "sq8_dot_fused": (sq8_ops, "launches"),
            "assign_argmax": (at_ops, "assign_launches"),
            "flash_attention": (fa_ops, "launches")}


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's seconds when it ends (after the card's queued
    work has finished)."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"[seconds] {name}: {time.perf_counter() - t0:.1f} s")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


# --------------------------------------------------------------------------
# phase 3: the synthetic serve_msmarco index (its leaves, queries and the
# phase-9 planes are synth_msmarco's, shared with kernel_variants.py)
# --------------------------------------------------------------------------

def plant_positives(leaves: dict, qe: np.ndarray) -> np.ndarray:
    """Give each query one document it must rank first: a member of
    its best cluster whose codes are the query's best codeword in every
    fragment (the highest ADC score any document can reach).  Rewrites
    those rows of the codes leaf; returns the (n,) positive doc ids."""
    best = (qe @ leaves[".cluster_sel.embeddings"].T).argmax(axis=1)
    frags = (qe @ leaves[".codec_params.rotation"]).reshape(
        len(qe), PQ_M, -1)
    codes = np.einsum("bmd,mkd->bmk", frags,
                      leaves[".codec_params.codebook.codewords"]).argmax(-1)
    qrels = planted_docs(leaves[".cluster_lists.entries"], best)
    leaves[".doc_planes['codes']"][qrels] = codes.astype(np.uint8)
    return qrels


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def check_masked(got, want, rtol: float, atol: float, kname: str,
                 what: str) -> float:
    """-inf lanes identical, finite scores within rtol/atol; returns the
    largest absolute error."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        fail(f"{kname} {what}: -inf lanes differ from the plain version")
    fin = torch.isfinite(want)
    if not torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol):
        fail(f"{kname} {what}: scores differ beyond rtol {rtol}, atol "
             f"{atol}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def check_adc(got, want, what: str) -> float:
    return check_masked(got, want, ADC_TOL, ADC_TOL, "pq_adc_fused", what)


def check_topk(got, want, full, what: str) -> float:
    """Scores within TOPK_TOL; ids identical except where the two
    orders swap documents whose exact (plain) scores lie within
    TOPK_TOL.  ``full`` is the plain (N, L) score plane."""
    gs, gi = got
    ws, wi = want
    if not torch.allclose(gs, ws, rtol=TOPK_TOL, atol=TOPK_TOL):
        fail(f"topk_scores {what}: scores differ beyond {TOPK_TOL}")
    diff = gi != wi
    if diff.any():
        own = torch.gather(full, 1, gi.long())      # plain score of got ids
        gap = (own - ws).abs()[diff]
        if (gap > TOPK_TOL + TOPK_TOL * ws.abs()[diff]).any():
            fail(f"topk_scores {what}: ids differ beyond score ties")
    if not all(len(set(row)) == len(row) for row in gi.tolist()):
        fail(f"topk_scores {what}: an id repeats within a row")
    return float((gs - ws).abs().max())


def topk_match(ref_ids, ref_s, got_ids, got_s, tol: float) -> bool:
    """Top-R ids equal up to swaps between scores within ``tol``; scores
    within rtol=atol=``tol`` (numpy arrays of one query)."""
    if not np.allclose(got_s, ref_s, rtol=tol, atol=tol):
        return False
    for p in np.flatnonzero(got_ids != ref_ids):
        where = np.flatnonzero(ref_ids == got_ids[p])
        ref = ref_s[where[0]] if where.size else ref_s[-1]
        if abs(ref - got_s[p]) > tol + tol * abs(ref):
            return False
    return True


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def profile_batch(server, qe, qt, top: int = 12) -> None:
    """Device time by kernel over one served batch (torch.profiler),
    and the device's busy share of the batch's wall time."""
    profile_call(lambda: server.query(qe, qt),
                 f"one batch ({server.index.codec})", top)


def profile_call(fn, what: str, top: int = 12, warm: bool = True) -> None:
    """:func:`profile_batch` of any call that serves one batch, after one
    unprofiled call unless ``warm`` is False."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    log(f"[profile] {what}: wall "
        f"{wall_us / 1e3:.3f} ms (profiled), device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}); top {top} by "
        f"device time:")
    for us, count, key in rows[:top]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {us / busy_us:6.1%}  "
            f"x{count:<4d} {key[:90]}")


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS
          ) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it, the operations at
    ``peak`` (the rate for their inputs' type)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def card() -> str:
    """Phase 1: print the nvidia-smi name/power-limit line; returns
    torch's name of card 0."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    log(lines[0] if lines else "nvidia-smi printed nothing")
    name = torch.cuda.get_device_name(0)
    log(f"[card] torch device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return name


def build_kernels() -> None:
    """Phase 2: one nvcc per kernel source, in parallel."""
    logs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ready (built now: "
        f"{sorted(logs)})")
    for kname, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kname}: {line.strip()}")


def _cases_to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def parity_edges(dev, prng: np.random.Generator) -> dict:
    """Phase 4a: each kernel against its plain version at edge shapes;
    returns the largest error per kernel."""
    errs = {k: 0.0 for k in COUNTERS}
    adc_cases = [  # (name, b, c, m, k, code dtype, dup ids, masked row)
        ("c_ragged", 2, 8192 + 300, 96, 256, np.uint8, False, None),
        ("c_below_tile", 3, 5, 8, 128, np.uint8, False, 1),
        ("dup_masked_i32", 2, 1000, 8, 512, np.int32, True, 0),
        ("dup_masked_u8", 4, 700, 16, 256, np.uint8, True, 3),
        ("scalar_rows_m1", 2, 333, 1, 64, np.uint8, False, None),
        ("all_masked", 2, 100, 4, 64, np.uint8, False, "all"),
    ]
    for cname, b, c, m, k, dtype, dup, mask in adc_cases:
        lut, plane = _cases_to(dev, prng.normal(size=(b, m, k)).astype(
            np.float32), prng.integers(0, k, (900, m)).astype(dtype))
        ids = prng.integers(-2, 902, (b, c)).astype(np.int32)  # clipped
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = prng.random((b, c)) < 0.8
        if mask == "all":
            live[:] = False
        elif mask is not None:
            live[mask] = False
        ids, live = _cases_to(dev, ids, live)
        errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
            adc_ops.pq_adc_fused(lut, plane, ids, live),
            adc_ref.pq_adc_fused(lut, plane, ids, live), cname))
    # rows not 16-byte aligned take the scalar path
    plane = _cases_to(dev, prng.integers(0, 256, 900 * 96 + 3).astype(
        np.uint8))[0][3:].view(900, 96)
    lut, ids = _cases_to(dev, prng.normal(size=(2, 96, 256)).astype(
        np.float32), prng.integers(0, 900, (2, 500)).astype(np.int32))
    live = torch.ones((2, 500), dtype=torch.bool, device=dev)
    errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
        adc_ops.pq_adc_fused(lut, plane, ids, live),
        adc_ref.pq_adc_fused(lut, plane, ids, live), "unaligned_rows"))

    topk_cases = [  # (name, n, l, h, k, centroid layout, elements off
        #                16-byte alignment); layouts: "ties" duplicates the
        #                first half of the rows, "ascending" makes every
        #                query's scores rise with the id (every candidate
        #                beats the running k-th: the buffers overflow),
        #                "equal" repeats one row (ids decide)
        ("ties", 33, 300, 32, 12, "ties", 0),
        ("small", 5, 37, 16, 4, "random", 0),
        ("k_equals_l", 3, 2, 16, 2, "ties", 0),
        ("ragged_tiles", 17, 129, 40, 8, "ties", 0),
        ("k_max", 2, 10_000, 768, at_ops.MAX_K, "random", 0),
        # the element-wise copies: h % 4 != 0, and x off alignment
        ("h37_elementwise", 40, 1000, 37, 30, "random", 0),
        ("misaligned_view", 64, 3000, 768, 30, "random", 1),
        # the selection's adversarial orders; the runtime's buckets 1
        # and 8 (one query tile, 40 slices)
        ("ascending", 64, 3000, 768, 30, "ascending", 0),
        ("all_equal", 40, 1000, 64, 30, "equal", 0),
        ("k128_l129", 5, 129, 40, 128, "random", 0),
        ("bucket1", 1, 10_000, 768, 30, "random", 0),
        ("bucket8", 8, 10_000, 768, 30, "random", 0),
    ]
    for cname, n, l, h, k, layout, offset in topk_cases:
        x = prng.normal(size=(n, h))
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        emb = prng.normal(size=(l, h))
        if layout == "ties":
            emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
        elif layout == "ascending":
            x = x * np.where(x @ emb[0] < 0, -1.0, 1.0)[:, None]
            emb = (np.arange(1, l + 1) / l)[:, None] * emb[0]
        elif layout == "equal":
            emb = np.repeat(emb[:1], l, axis=0)
        x, emb = x.astype(np.float32), emb.astype(np.float32)
        x, emb = _cases_to(dev, np.concatenate(
            [np.zeros(offset, np.float32), x.ravel()]), emb)
        x = x[offset:].view(n, h)
        errs["topk_scores"] = max(errs["topk_scores"], check_topk(
            at_ops.topk_scores(x, emb, k), at_ref.topk_scores(x, emb, k),
            x @ emb.T, cname))

    sq8_cases = [  # (name, b, c, h, dup ids, masked row); a tile is 512
        ("c_below_tile", 3, 5, 768, False, 1),
        ("c_ragged", 2, 3 * 512 + 77, 768, False, None),
        ("c_one_short", 2, 511, 768, True, None),
        ("dup_masked_h16", 4, 700, 16, True, 3),
        ("h40_scalar", 2, 333, 40, False, 0),
        ("all_masked", 2, 100, 768, False, "all"),
    ]
    n_rows = 900
    for cname, b, c, h, dup, mask in sq8_cases:
        q, plane = _cases_to(dev, prng.normal(size=(b, h)).astype(
            np.float32), prng.integers(0, 256, (n_rows, h)).astype(np.uint8))
        ids = prng.integers(-2, n_rows + 2, (b, c)).astype(np.int32)
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = prng.random((b, c)) < 0.8
        if mask == "all":
            live[:] = False
        elif mask is not None:
            live[mask] = False
        ids, live = _cases_to(dev, ids, live)
        errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
            sq8_ops.sq8_dot_fused(q, plane, ids, live),
            sq8_ref.sq8_dot_fused(q, plane, ids, live), SQ8_EDGE_RTOL,
            SQ8_EDGE_ATOL, "sq8_dot_fused", cname))
    # a plane view 3 bytes into its buffer: rows are not 16-byte aligned
    plane = _cases_to(dev, prng.integers(0, 256, n_rows * 768 + 3).astype(
        np.uint8))[0][3:].view(n_rows, 768)
    q, ids = _cases_to(dev, prng.normal(size=(2, 768)).astype(np.float32),
                       prng.integers(0, n_rows, (2, 700)).astype(np.int32))
    live = torch.ones((2, 700), dtype=torch.bool, device=dev)
    errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
        sq8_ops.sq8_dot_fused(q, plane, ids, live),
        sq8_ref.sq8_dot_fused(q, plane, ids, live), SQ8_EDGE_RTOL,
        SQ8_EDGE_ATOL, "sq8_dot_fused", "unaligned_view"))
    unfused_cases = [  # (name, b, c, m, k, code dtype, unaligned view)
        ("c_one", 2, 1, 96, 256, np.uint8, False),
        ("m_one", 3, 700, 1, 64, np.uint8, False),
        ("odd_k", 2, 999, 12, 77, np.int32, False),
        ("c_ragged_i32", 2, 8192 + 300, 96, 256, np.int32, False),
        ("unaligned_view", 2, 500, 96, 256, np.uint8, True),
    ]
    for cname, b, c, m, k, dtype, unaligned in unfused_cases:
        lut, flat = _cases_to(dev, prng.normal(size=(b, m, k)).astype(
            np.float32), prng.integers(0, k, b * c * m + 3).astype(dtype))
        codes = (flat[3:] if unaligned else flat[:-3]).view(b, c, m)
        got, want = adc_ops.pq_adc(lut, codes), adc_ref.pq_adc(lut, codes)
        errs["pq_adc"] = max(errs["pq_adc"], check_masked(
            got, want, ADC_TOL, ADC_TOL, "pq_adc", cname))
    log(f"[parity] edge shapes: pq_adc_fused {len(adc_cases) + 1} cases, "
        f"pq_adc {len(unfused_cases)} cases, topk_scores {len(topk_cases)} "
        f"cases, sq8_dot_fused {len(sq8_cases) + 1} cases")
    return errs


def check_no_extra_memory(fn, out_bytes: int, what: str) -> int:
    """Run ``fn`` once; fail if it allocates more than its output (plus
    1 MB); returns the peak it added."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    if extra > out_bytes + (1 << 20):
        fail(f"{what} allocated {extra} B beyond its output")
    return extra


def parity_full_width(inp: dict, errs: dict) -> None:
    """Phase 4b: both kernels of the opq path at its full width (the
    plain ADC on N_CHECK queries: it builds (B, C, m)), and no (B, C, m)
    allocation in the full-batch kernel call."""
    x, emb = inp["x"], inp["emb"]
    errs["topk_scores"] = max(errs["topk_scores"], check_topk(
        at_ops.topk_scores(x, emb, KC), at_ref.topk_scores(x, emb, KC),
        x @ emb.T, "full_width"))
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    q = slice(0, N_CHECK)
    errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
        adc_ops.pq_adc_fused(lut[q], plane, rows[q], live[q]),
        adc_ref.pq_adc_fused(lut[q], plane, rows[q], live[q]),
        "full_width"))
    extra = check_no_extra_memory(
        lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
        rows.numel() * 4, "pq_adc_fused")
    log(f"[parity] full width: pq_adc_fused at B={rows.shape[0]} peaks at "
        f"{extra / 1e6:.1f} MB for a {rows.numel() * 4 / 1e6:.1f} MB (B, C) "
        f"output (a (B, C, m) codes tensor would be "
        f"{rows.numel() * PQ_M / 1e9:.2f} GB); max abs err pq_adc_fused "
        f"{errs['pq_adc_fused']:.3g} (tol {ADC_TOL}), topk_scores "
        f"{errs['topk_scores']:.3g} (tol {TOPK_TOL})")


def parity_full_width_sq8(inp: dict, errs: dict) -> None:
    """Phase 9b: ``sq8_dot_fused`` at the refine path's full width on
    N_CHECK queries (the plain version builds (B, C, h) f32), held to
    rtol=atol=SQ8_TOL after the bias, and no (B, C, h) allocation in the
    full-batch kernel call."""
    q_scaled, plane, rows, live, bias = (
        inp[k] for k in ("q_scaled", "plane", "rows", "live", "bias"))
    q = slice(0, N_CHECK)
    errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
        sq8_ops.sq8_dot_fused(q_scaled[q], plane, rows[q], live[q])
        + bias[q, None],
        sq8_ref.sq8_dot_fused(q_scaled[q], plane, rows[q], live[q])
        + bias[q, None], SQ8_TOL, SQ8_TOL, "sq8_dot_fused", "full_width"))
    extra = check_no_extra_memory(
        lambda: sq8_ops.sq8_dot_fused(q_scaled, plane, rows, live),
        rows.numel() * 4, "sq8_dot_fused")
    log(f"[parity] full width: sq8_dot_fused at B={rows.shape[0]} peaks at "
        f"{extra / 1e6:.1f} MB for a {rows.numel() * 4 / 1e6:.1f} MB (B, C) "
        f"output (a (B, C, h) f32 rows tensor would be "
        f"{rows.numel() * HIDDEN * 4 / 1e9:.1f} GB); max abs err "
        f"{errs['sq8_dot_fused']:.3g} (edge tol rtol {SQ8_EDGE_RTOL} atol "
        f"{SQ8_EDGE_ATOL}; full width rtol=atol={SQ8_TOL})")


def serve_batches(index, dev, qe_all, qt_all, batches: int, kernels,
                  what: str, fusion_weight=None):
    """A counted main-path run: every launch count is set to 0 just
    before the batches and read just after; each kernel in ``kernels``
    must have launched.  ``fusion_weight`` serves hybrid search.
    Returns (server, results, launches)."""
    server = serve.Server(index, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
        fusion_weight=fusion_weight), device=dev)
    server.warmup(qe_all.shape[1], qt_all.shape[1])
    reset_counts()
    results, batch_s = [], []
    for i in range(batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t0 = time.perf_counter()
        results.append(server.query(qe_all[sl], qt_all[sl]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = read_counts()
    log(f"[serving] {what}: {server.n_served} queries in "
        f"{sum(batch_s):.3f} s ({server.n_served / sum(batch_s):.1f} q/s; "
        f"batch ms {[round(s * 1e3, 2) for s in batch_s]}); launches "
        f"{launches}")
    missing = [k for k in kernels if launches[k] < 1]
    if missing:
        fail(f"{what}: kernel(s) of the path never launched: {missing}")
    for res in results:
        if res.doc_ids.shape != (BATCH, TOP_R):
            fail(f"{what}: result shape {tuple(res.doc_ids.shape)}")
        if not torch.isfinite(res.scores).all():
            fail(f"{what}: non-finite result scores")
        if int(res.n_candidates.min()) < TOP_R:
            fail(f"{what}: a query evaluated fewer than R candidates")
    mean_cand = float(torch.cat([r.n_candidates for r in results])
                      .float().mean())
    log(f"[serving] {what}: mean unique live candidates {mean_cand:.0f} "
        f"({'dense + sparse matches; ' if fusion_weight is not None else ''}"
        f"{hi.candidate_budget(index, KC, K2)} dense slots)")
    return server, results, launches


def check_planted(results, qrels, what: str) -> None:
    ids = torch.cat([r.doc_ids for r in results]).cpu()
    r1 = metrics.recall_at_k(ids, qrels, 1)
    log(f"[serving] {what}: planted positives: recall@1 {r1}, MRR@10 "
        f"{metrics.mrr_at_k(ids, qrels, 10)}")
    if r1 != 1.0:
        fail(f"{what}: a query did not rank its planted positive first")


def check_cpu(cpu_index, qe8, qt8, inp: dict, first, tol: float) -> None:
    """Phase 6: the first N_CHECK queries against the CPU plain path
    over the same planes.  A query whose K^C-th and next cluster scores
    lie within TOPK_TOL may dispatch another set of clusters: it is
    listed, not checked.  One whose near-ties lie inside its top K^C
    dispatches the same set in a possibly other order: its cluster ids
    are compared as a set and its candidate plane (ordered by dispatch)
    is not, while n_candidates and the top-R are checked as for any
    other query."""
    t0 = time.perf_counter()
    ref = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                    device="cpu")
    cpu_s = time.perf_counter() - t0
    full = torch.from_numpy(qe8) @ cpu_index.cluster_sel.embeddings.T
    top = torch.sort(full, dim=-1, descending=True).values[:, : KC + 1]
    gaps = top[:, :-1] - top[:, 1:]
    boundary = gaps[:, KC - 1] <= TOPK_TOL
    inner = (gaps[:, : KC - 1] <= TOPK_TOL).any(dim=1)
    with torch.inference_mode():
        cpu_cl, cpu_tm = qexec.dispatch(
            cpu_index.cluster_sel, cpu_index.term_sel,
            torch.from_numpy(qe8), torch.from_numpy(qt8).long(), KC, K2)
        cpu_cands = qexec.gather([hi.base_source(cpu_index)], cpu_cl,
                                 cpu_tm).cands
    skipped, as_sets = [], []
    for b in range(N_CHECK):
        if bool(boundary[b]):
            skipped.append(b)
            continue
        got_cl = inp["cl_ids"][b].cpu()
        if bool(inner[b]):
            as_sets.append(b)
            if not torch.equal(torch.sort(got_cl).values,
                               torch.sort(cpu_cl[b]).values):
                fail(f"query {b}: dispatched clusters differ from the CPU "
                     f"path")
        else:
            if not torch.equal(got_cl, cpu_cl[b]):
                fail(f"query {b}: dispatch ids differ from the CPU path")
            if not torch.equal(inp["cands"][b].cpu(), cpu_cands[b]):
                fail(f"query {b}: candidate plane differs from the CPU path")
        if int(first.n_candidates[b]) != int(ref.n_candidates[b]):
            fail(f"query {b}: n_candidates differs from the CPU path")
        if not topk_match(ref.doc_ids[b].numpy(), ref.scores[b].numpy(),
                          first.doc_ids[b].cpu().numpy(),
                          first.scores[b].cpu().numpy(), tol):
            fail(f"query {b}: top-R differs from the CPU path")
    log(f"[check] {cpu_index.codec}: {N_CHECK - len(skipped)} of {N_CHECK} "
        f"queries match the CPU plain path (CPU search {cpu_s:.1f} s); "
        f"near-ties inside the top K^C (clusters compared as a set): "
        f"{as_sets}; near-ties at the K^C boundary, skipped: {skipped}")


def bm25_oracle(leaves: dict, term_ids: np.ndarray) -> np.ndarray:
    """Pure sparse top-R on the host: each query's stored impacts summed
    per document over its probed term lists in probed order (float32 adds
    in slot order, as the fixed-shape path adds them), ranked by (score
    desc, id asc), zero-score documents excluded."""
    entries, weights = leaves[".term_lists.entries"], leaves[".sparse_weights"]
    out = np.full((len(term_ids), TOP_R), inverted_lists.PAD_DOC, np.int64)
    for b, row in enumerate(term_ids):
        ids = entries[row[row >= 0]].reshape(-1)
        w = weights[row[row >= 0]].reshape(-1)
        acc = np.zeros(N_DOCS, np.float32)
        np.add.at(acc, ids[ids >= 0], w[ids >= 0])
        live = np.flatnonzero(acc > 0.0)
        order = live[np.lexsort((live, -acc[live]))][:TOP_R]
        out[b, :order.size] = order
    return out


def check_fused(server, cpu_index, leaves, qe_all, qt_all, dense) -> None:
    """Phase 8c: the fused server's three contracts.  Weight 1.0: every
    batch's ids bitwise equal to phase 5's dense-only results.  Weight
    0.0: the first N_CHECK queries' ids equal to the host BM25 oracle.
    Weight FUSION_WEIGHT against the CPU plain path on N_CHECK queries:
    the sparse top-R and its count bitwise equal to the CPU's, the fused
    top-R bitwise equal to the CPU's fusion of the card's dense and
    sparse lists (the dense half is held to the CPU by phase 6), and
    every query whose dense ids equal the CPU's dense ids has the CPU's
    fused result exactly (the others, dense near-ties, are listed)."""
    server.set_fusion(1.0)
    for i, want in enumerate(dense):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        if not torch.equal(server.query(qe_all[sl], qt_all[sl]).doc_ids,
                           want.doc_ids):
            fail(f"fused weight 1.0 batch {i}: ids differ from dense-only")
    qe8, qt8 = qe_all[:N_CHECK], qt_all[:N_CHECK]
    term_ids = ts_mod.query_terms(cpu_index.term_sel,
                                  torch.from_numpy(qt8).long(), K2)
    server.set_fusion(0.0)
    got0 = server.query(qe8, qt8).doc_ids.cpu().numpy()
    t0 = time.perf_counter()
    oracle = bm25_oracle(leaves, term_ids.numpy())
    oracle_s = time.perf_counter() - t0
    if not np.array_equal(got0, oracle):
        fail("fused weight 0.0 differs from the BM25 oracle on queries "
             f"{np.flatnonzero((got0 != oracle).any(axis=1)).tolist()}")
    server.set_fusion(FUSION_WEIGHT)
    fus = qexec.FusionSpec(weight=FUSION_WEIGHT)
    got = server.query(qe8, qt8)
    dev = server.device
    with torch.inference_mode():
        _, dev_terms = qexec.dispatch(
            server.index.cluster_sel, server.index.term_sel,
            torch.from_numpy(qe8).to(dev), torch.from_numpy(qt8).to(dev)
            .long(), KC, K2)
        card_sp = qexec.sparse_topk([hi.base_source(server.index)],
                                    dev_terms, TOP_R, None)
        cpu_sp = qexec.sparse_topk([hi.base_source(cpu_index)], term_ids,
                                   TOP_R, None)
    if not torch.equal(dev_terms.cpu(), term_ids):
        fail("fused: dispatched term ids differ from the CPU's")
    for g, w, what in zip(card_sp, cpu_sp, ("scores", "ids", "counts")):
        if not torch.equal(g.cpu(), w):
            fail(f"fused: sparse top-R {what} differ from the CPU's")
    d_ids = dense[0].doc_ids[:N_CHECK].cpu()
    d_s = torch.where(d_ids >= 0, dense[0].scores[:N_CHECK].cpu(),
                      -torch.inf)
    want_s, want_ids = qexec.fuse(d_s, d_ids, *cpu_sp[:2], fus, TOP_R)
    valid = torch.isfinite(want_s)
    if not (torch.equal(got.doc_ids.cpu(), torch.where(
            valid, want_ids, inverted_lists.PAD_DOC).int())
            and torch.equal(got.scores.cpu(),
                            torch.where(valid, want_s, 0.0))):
        fail("fused: top-R differs from the CPU fusion of the card's lists")
    if not torch.equal(got.n_candidates.cpu(),
                       dense[0].n_candidates[:N_CHECK].cpu() + cpu_sp[2]):
        fail("fused: n_candidates is not dense + sparse matches")
    t0 = time.perf_counter()
    cpu = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                    fusion=fus, device="cpu")
    cpu_dense = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                          device="cpu")
    cpu_s = time.perf_counter() - t0
    near = []
    for b in range(N_CHECK):
        if not torch.equal(d_ids[b], cpu_dense.doc_ids[b]):
            near.append(b)
            continue
        if not (torch.equal(got.doc_ids[b].cpu(), cpu.doc_ids[b])
                and torch.equal(got.scores[b].cpu(), cpu.scores[b])
                and int(got.n_candidates[b]) == int(cpu.n_candidates[b])):
            fail(f"fused query {b}: differs from the CPU plain path")
    log(f"[fused] weight 1.0: {len(dense)} batches bitwise equal to "
        f"dense-only; weight 0.0: {N_CHECK} queries equal to the BM25 "
        f"oracle (host oracle {oracle_s:.1f} s); weight {FUSION_WEIGHT}: "
        f"sparse top-R bitwise equal to the CPU's, fusion of the card's "
        f"lists bitwise equal to the CPU's, {N_CHECK - len(near)} of "
        f"{N_CHECK} queries equal to the CPU plain path (CPU searches "
        f"{cpu_s:.1f} s); dense near-tie queries checked through the "
        f"decomposition only: {near}; mean sparse matches "
        f"{float(cpu_sp[2].float().mean()):.0f} of {K2 * TERM_CAP} slots")


def time_kernels(inp: dict) -> dict:
    """Phase 7: kernel, plain and library times at the opq path's
    shapes, beside each kernel's bound for this run's data."""
    timer = Timer()
    x, emb = inp["x"], inp["emb"]
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    n, h = x.shape
    l = emb.shape[0]
    b, c = rows.shape
    live_rows = torch.unique(rows[live]).numel()
    n_live = int(live.sum())
    adc_bytes = b * c * (4 + 1 + 4) + lut.numel() * 4 + live_rows * PQ_M
    topk_flops = 2 * n * l * h
    topk_bytes = 4 * (n * h + l * h) + 8 * n * KC

    def plain_adc():          # in 32-query chunks: it builds (B, C, m)
        for s in range(0, b, 32):
            adc_ref.pq_adc_fused(lut[s:s + 32], plane, rows[s:s + 32],
                                 live[s:s + 32])

    adc_bound = bound(n_live * PQ_M, adc_bytes)
    topk_bound = bound(topk_flops, topk_bytes)
    log(f"[times] pq_adc_fused at B={b}, C={c}: {n_live} live slots over "
        f"{live_rows} distinct rows, {adc_bytes / 1e6:.1f} MB to move; "
        f"topk_scores at N={n}, L={l}, h={h}, k={KC}: "
        f"{topk_flops / 1e9:.3f} GFLOP; library_ms of topk_scores is "
        f"torch.topk(x @ emb.T, k), two calls")
    topk = dict(
        ms=timer.ms(lambda: at_ops.topk_scores(x, emb, KC), reps=20),
        plain_ms=timer.ms(lambda: at_ref.topk_scores(x, emb, KC), reps=20),
        library_ms=timer.ms(lambda: torch.topk(x @ emb.T, KC), reps=20),
        bound_ms=topk_bound[0], bound_by=topk_bound[1])
    topk["bound_share"] = topk_bound[0] / topk["ms"]
    log(f"[times] topk_scores: kernel {topk['ms']:.4f} ms, plain "
        f"{topk['plain_ms']:.4f} ms, library {topk['library_ms']:.4f} ms, "
        f"bound {topk_bound[0]:.4f} ms ({topk_bound[1]}), bound / kernel "
        f"{topk['bound_share']:.1%}")
    _, plan = adc_ops.choose(_build.library("pq_adc_fused"), lut, plane)
    grid = adc_ops.grid_size(b * c, plan)
    staged = adc_ops.lut_stagings(b, c, grid) * lut[0].numel() * 4
    adc = dict(
        ms=timer.ms(lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
                    reps=10),
        plain_ms=timer.ms(plain_adc, reps=3, warm=1), library_ms=None,
        bound_ms=adc_bound[0], bound_by=adc_bound[1])
    adc["bound_share"] = adc_bound[0] / adc["ms"]
    log(f"[times] pq_adc_fused: kernel {adc['ms']:.4f} ms, plain "
        f"{adc['plain_ms']:.4f} ms, bound {adc_bound[0]:.4f} ms "
        f"({adc_bound[1]}), bound / kernel {adc['bound_share']:.1%}; "
        f"{adc_ops.INSTANCES[plan.instance]} instance, {grid} blocks "
        f"staging {staged / 1e6:.1f} MB of LUTs (a copy per 8,192 slots "
        f"would stage {b * -(-c // 8192) * lut[0].numel() * 4 / 1e6:.1f} "
        f"MB)")
    return {"pq_adc_fused": adc, "topk_scores": topk}


def time_sq8(inp: dict) -> dict:
    """Phase 9e: ``sq8_dot_fused`` and its plain version at the refine
    path's shapes, beside its bound for this run's data (each distinct
    live row read once) and the traffic of reading each live lane's row,
    as the per-lane kernel before the grouped one did.  No one PyTorch
    call computes a gathered dot, so library_ms is null."""
    timer = Timer()
    q_scaled, plane, rows, live = (inp[k] for k in ("q_scaled", "plane",
                                                    "rows", "live"))
    b, c = rows.shape
    h = plane.shape[1]
    live_rows = torch.unique(rows[live]).numel()
    n_live = int(live.sum())
    fixed = b * c * (4 + 1 + 4) + q_scaled.numel() * 4
    nbytes = fixed + live_rows * h
    per_lane = fixed + n_live * h
    sq8_bound = bound(2 * n_live * h, nbytes)
    tl = sq8_ops.tiles(_build.library("sq8_dot_fused"))
    skey, _ = sq8_ops.schedule(rows, live, plane.shape[0], tl.tile_slots)
    groups = int(sq8_ops.lead_flags(skey, tl.group_max).sum())

    def plain():              # in 16-query chunks: it builds (B, C, h)
        for s in range(0, b, 16):
            sq8_ref.sq8_dot_fused(q_scaled[s:s + 16], plane,
                                  rows[s:s + 16], live[s:s + 16])

    log(f"[times] sq8_dot_fused at B={b}, C={c}, h={h}: {n_live} live "
        f"slots over {live_rows} distinct rows, {nbytes / 1e6:.1f} MB to "
        f"move, {2 * n_live * h / 1e9:.2f} GFLOP; each live lane reading "
        f"its row would move {per_lane / 1e6:.1f} MB "
        f"({1e3 * per_lane / PEAK_BYTES:.3f} ms at {PEAK_BYTES / 1e12} "
        f"TB/s); {skey.numel()} items of {tl.tile_slots} slots in {groups} "
        f"groups of at most {tl.group_max} (mean "
        f"{skey.numel() / groups:.2f}); library_ms null (no one PyTorch "
        f"call computes a gathered dot)")
    out = dict(
        ms=timer.ms(lambda: sq8_ops.sq8_dot_fused(q_scaled, plane, rows,
                                                  live), reps=10),
        plain_ms=timer.ms(plain, reps=3, warm=1), library_ms=None,
        bound_ms=sq8_bound[0], bound_by=sq8_bound[1])
    out["bound_share"] = sq8_bound[0] / out["ms"]
    log(f"[times] sq8_dot_fused: kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, bound {sq8_bound[0]:.4f} ms "
        f"({sq8_bound[1]}), bound / kernel {out['bound_share']:.1%}")
    return {"sq8_dot_fused": out}


def unfused_at_width(inp: dict, errs: dict) -> dict:
    """Phase 5b: ``pq_adc`` over the opq path's candidates gathered into a
    (B, C, m) codes tensor, as uint8 and as int32: within ADC_TOL of the
    plain version on N_CHECK queries, bitwise equal to ``pq_adc_fused``
    on every live lane of the full batch, and timed beside its bound
    (the bytes of the codes read once, the LUT, the scores written).
    No one PyTorch call computes a LUT gather-sum, so library_ms is
    null."""
    timer = Timer()
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    b, c = rows.shape
    fused = adc_ops.pq_adc_fused(lut, plane, rows, live)
    q = slice(0, N_CHECK)
    out, gb = {}, {}
    for name, dtype in (("u8", torch.uint8), ("i32", torch.int32)):
        codes = plane[rows.long()].to(dtype)
        got = adc_ops.pq_adc(lut, codes)
        if not torch.equal(got[live], fused[live]):
            n_diff = int((got[live] != fused[live]).sum())
            fail(f"pq_adc ({name} codes) differs from pq_adc_fused on "
                 f"{n_diff} live lanes")
        errs["pq_adc"] = max(errs["pq_adc"], check_masked(
            got[q], adc_ref.pq_adc(lut[q], codes[q]), ADC_TOL, ADC_TOL,
            "pq_adc", f"full width {name}"))
        nbytes = codes.numel() * codes.element_size() + lut.numel() * 4 \
            + b * c * 4
        gb[name] = nbytes / 1e9
        t_bound = bound(b * c * PQ_M, nbytes)

        def plain(codes=codes):       # in 32-query chunks: it gathers
            for s in range(0, b, 32):  # (B, C, m) int64 indices
                adc_ref.pq_adc(lut[s:s + 32], codes[s:s + 32])

        out[name] = dict(
            ms=timer.ms(lambda codes=codes: adc_ops.pq_adc(lut, codes),
                        reps=10),
            plain_ms=timer.ms(plain, reps=3, warm=1), library_ms=None,
            bound_ms=t_bound[0], bound_by=t_bound[1])
        out[name]["bound_share"] = t_bound[0] / out[name]["ms"]
        del codes, got
    fused_ms = timer.ms(lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
                        reps=10)
    log(f"[times] pq_adc at B={b}, C={c}, m={PQ_M}, k={PQ_K}: uint8 codes "
        f"{gb['u8']:.3f} GB to move: kernel {out['u8']['ms']:.3f} ms, plain "
        f"{out['u8']['plain_ms']:.3f} ms, bound {out['u8']['bound_ms']:.3f} "
        f"ms ({out['u8']['bound_by']}), bound / kernel "
        f"{out['u8']['bound_share']:.1%}; int32 codes {gb['i32']:.3f} GB: "
        f"kernel {out['i32']['ms']:.3f} ms, plain "
        f"{out['i32']['plain_ms']:.3f} ms, bound {out['i32']['bound_ms']:.3f}"
        f" ms, bound / kernel {out['i32']['bound_share']:.1%}; "
        f"pq_adc_fused on the same slots {fused_ms:.3f} ms; "
        f"bitwise equal to pq_adc_fused on all {int(live.sum())} live lanes "
        f"(uint8 and int32); max abs err vs plain {errs['pq_adc']:.3g} "
        f"(tol {ADC_TOL})")
    return {"pq_adc": out["u8"]}


def write_corpus(seed: int) -> float:
    """Phase 10's corpus made in a process of its own while phases 3-9
    run, one ``.npy`` a field under CORPUS_DIR; returns its seconds."""
    t0 = time.perf_counter()
    corpus = synthetic.generate(seed, n_docs=BUILD_DOCS,
                                n_queries=BUILD_QUERIES, hidden=HIDDEN,
                                vocab_size=VOCAB, query_len=QUERY_LEN,
                                make_model_b=False)
    CORPUS_DIR.mkdir(parents=True, exist_ok=True)
    for f in dataclasses.fields(corpus):
        value = getattr(corpus, f.name)
        if isinstance(value, np.ndarray):
            np.save(CORPUS_DIR / f"{f.name}.npy", value)
    return time.perf_counter() - t0


def read_corpus() -> synthetic.Corpus:
    """What :func:`write_corpus` wrote, read back (and removed)."""
    arrays = {p.stem: np.load(p) for p in CORPUS_DIR.glob("*.npy")}
    shutil.rmtree(CORPUS_DIR)
    return synthetic.Corpus(vocab_size=VOCAB, **arrays)


def build_on_card(dev, seed: int, corpus_job) -> dict:
    """Phase 10: the port's build on the card at N = BUILD_DOCS (full
    widths), three codecs over one KMeans, each served and scored.  The
    corpus is ``corpus_job``'s, a future of :func:`write_corpus` started
    with the run.  Each
    build is a counted run that must launch ``assign_argmax`` exactly
    BUILD_ASSIGN_LAUNCHES times.  The ``opq`` build carries the BM25
    impact plane (``sparse=True``) and is served fused too.  Returns what phase 12 reuses: the
    corpus, its planes on the card, the KMeans selector and φ(D), the
    ``refine:sq8:4`` quality and each build's ``assign_argmax``
    launches; what phase 17 tunes: the ``refine:sq8:4`` and ``opq``
    indexes and the brute-force top-100 ids; and phase 19b's ``flat``
    index."""
    with phase("build: synthetic corpus on the host"):
        log(f"[build] corpus made beside phases 3-9 in "
            f"{corpus_job.result():.1f} s")
        corpus = read_corpus()
        emb = torch.from_numpy(corpus.doc_emb).to(dev)
        tokens = torch.from_numpy(corpus.doc_tokens).to(dev).long()
        qe, qt = corpus.query_emb, corpus.query_tokens
    with phase("build: brute-force flat.search"):
        _, oracle = flat_codec.search(torch.from_numpy(qe).to(dev), emb,
                                      k=TOP_R)
        torch.cuda.synchronize()
        log(f"[build] brute force over {BUILD_DOCS} docs: R@100 "
            f"{metrics.recall_at_k(oracle.cpu(), corpus.qrels, 100):.4f}, "
            f"MRR@10 {metrics.mrr_at_k(oracle.cpu(), corpus.qrels, 10):.4f}")
    kernels = {REFINE_CODEC: ("sq8_dot_fused", "topk_scores"),
               "opq": ("pq_adc_fused", "topk_scores"),
               "flat": ("topk_scores",)}
    recall, mrr, base, assign_launches, indexes = {}, {}, None, {}, {}
    for spec in (REFINE_CODEC, "opq", "flat"):
        with phase(f"build: {spec} index"):
            timings = {}
            reuse = ({} if base is None else
                     dict(cluster_sel=base.cluster_sel,
                          doc_assign=base.doc_assign))
            reset_counts()
            index = hi.build(seed, emb, tokens, VOCAB, n_clusters=N_CLUSTERS,
                             k1_terms=K1_TERMS, codec=spec, pq_m=PQ_M,
                             pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
                             term_capacity=TERM_CAP,
                             kmeans_iters=BUILD_ITERS, device=dev,
                             timings=timings, sparse=spec == "opq",
                             **reuse)
            torch.cuda.synchronize()
            launches = read_counts()
            log(f"[build] {spec} stage seconds: "
                + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
                + f"; launches {launches}")
            before = {k: v for k, v in CUBLAS_ROUTE_STAGES.items()
                      if k in timings and timings[k] > 1.0}
            if before:
                log(f"[build] {spec} with assign_argmax beside the cuBLAS + "
                    f"argmax route: " + ", ".join(
                        f"{k} {timings[k]:.2f} s (cuBLAS + argmax: {v} s)"
                        for k, v in before.items()))
            if launches["assign_argmax"] != BUILD_ASSIGN_LAUNCHES[spec]:
                fail(f"{spec} build launched assign_argmax "
                     f"{launches['assign_argmax']} times, expected "
                     f"{BUILD_ASSIGN_LAUNCHES[spec]}")
            assign_launches[spec] = launches["assign_argmax"]
        with phase(f"build: serve {spec}"):
            _, results, launches = serve_batches(
                index, dev, qe, qt, BUILD_QUERIES // BATCH, kernels[spec],
                f"built {spec}")
            ids = torch.cat([r.doc_ids for r in results]).cpu()
            recall[spec] = metrics.recall_at_k(ids, corpus.qrels, 100)
            mrr[spec] = metrics.mrr_at_k(ids, corpus.qrels, 10)
            log(f"[build] {spec}: R@100 {recall[spec]:.4f}, MRR@10 "
                f"{mrr[spec]:.4f}, candidate "
                f"cost {hi.candidate_cost(index, KC, K2, TOP_R)}, launches "
                f"{launches}")
        if index.sparse_weights is not None:
            with phase(f"build: serve {spec} fused"):
                _, results, launches = serve_batches(
                    index, dev, qe, qt, BUILD_QUERIES // BATCH,
                    kernels[spec], f"built {spec} fused (weight "
                    f"{FUSION_WEIGHT})", fusion_weight=FUSION_WEIGHT)
                ids = torch.cat([r.doc_ids for r in results]).cpu()
                log(f"[build] {spec} on real BM25 impacts "
                    f"{tuple(index.sparse_weights.shape)}: dense-only R@100 "
                    f"{recall[spec]:.4f}, MRR@10 {mrr[spec]:.4f}; fused at "
                    f"weight {FUSION_WEIGHT} R@100 "
                    f"{metrics.recall_at_k(ids, corpus.qrels, 100):.4f}, "
                    f"MRR@10 {metrics.mrr_at_k(ids, corpus.qrels, 10):.4f}")
        base = index if base is None else base
        if spec != "flat":
            indexes[spec] = index      # phase 17 tunes them
        else:
            flat_index = index         # phase 19b's flat row (its plane
            # is ``emb`` itself: the codec keeps f32 rows as they are)
    gap = recall["flat"] - recall[REFINE_CODEC]
    log(f"[build] R@100 gap flat - {REFINE_CODEC}: {gap:.4f} (fails above "
        f"{REFINE_RECALL_GAP}; the DESIGN.md §7 contract is "
        f"{DESIGN_RECALL_GAP})")
    if gap > REFINE_RECALL_GAP:
        fail(f"{REFINE_CODEC} R@100 {recall[REFINE_CODEC]} is more than "
             f"{REFINE_RECALL_GAP} below flat's {recall['flat']}")
    return dict(corpus=corpus, emb=emb, tokens=tokens,
                cluster_sel=base.cluster_sel, doc_assign=base.doc_assign,
                recall=recall[REFINE_CODEC], mrr=mrr[REFINE_CODEC],
                assign_launches=assign_launches, indexes=indexes,
                flat_index=flat_index, oracle=oracle)


# --------------------------------------------------------------------------
# phases 11-13: flash_attention, assign_argmax and the HI²_sup path
# --------------------------------------------------------------------------

def _bshd(gen, dev, b, s, h, d, dtype, offset: int = 0):
    """A (B, H, S, d) view of (B, S, H, d) memory, as the attention
    layer's projections hand the kernel, starting ``offset`` elements
    into its storage (1: not 16-byte aligned)."""
    n = b * s * h * d
    flat = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
    return flat[offset:].view(b, s, h, d).transpose(1, 2)


def check_flash(q, k, v, causal, window, what: str,
                batch_block: int = 0, q_chunk=None) -> float:
    """Kernel against the plain version: out within FLASH_TOL of its
    dtype, lse within LSE_TOL of the plain scores' logsumexp, dead rows
    (no visible key) zeros with lse NEG_INF.  ``batch_block`` > 0 runs
    the plain version that many batch rows at a time, and ``q_chunk``
    that many query rows at a time (its score plane).  Returns the out
    error."""
    out_all, lse_all = fa_ops.flash_attention(q, k, v, causal, window)
    step = batch_block or q.shape[0]
    tol, err = FLASH_TOL[q.dtype], 0.0
    for i in range(0, q.shape[0], step):
        rows = slice(i, i + step)
        out, lse = out_all[rows], lse_all[rows]
        want, wlse = fa_ref.flash_attention(q[rows], k[rows], v[rows],
                                            causal, window, q_chunk=q_chunk)
        gap = float((out.float() - want.float()).abs().max())
        if not torch.allclose(out.float(), want.float(), rtol=tol,
                              atol=tol):
            fail(f"flash_attention {what}: out differs beyond {tol} (max "
                 f"{gap:.3g})")
        if not torch.allclose(lse, wlse, rtol=LSE_TOL, atol=LSE_TOL):
            fail(f"flash_attention {what}: lse differs beyond {LSE_TOL}")
        dead = wlse == fa_ref.NEG_INF
        if not torch.equal(lse == fa_ref.NEG_INF, dead) or bool(
                (out[dead] != 0).any()):
            fail(f"flash_attention {what}: fully-masked rows are not zeros "
                 f"with lse -1e30")
        err = max(err, gap)
    return err


def llama_qkv(gen, dev):
    b, s_len, hq, hkv, d = LLAMA_ATTN
    return (_bshd(gen, dev, b, s_len, hq, d, torch.bfloat16),
            *(_bshd(gen, dev, b, s_len, hkv, d, torch.bfloat16)
              for _ in range(2)))


def flash_parity(dev, seed: int) -> float:
    """Phase 11a: ``flash_attention`` at edge cases and at llama3-8b's
    attention shape; returns the largest out error."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads = [(4, 4), (4, 2), (8, 1), (32, 8)]
    lengths = [(1, 200), (63, 63), (200, 384), (384, 63), (384, 384)]
    masks = [(False, 0), (True, 0), (False, 32), (True, 32)]
    err, n_cases, n_dead = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 128):
            for causal, window in masks:
                hq, hkv = heads[n_cases % len(heads)]
                sq, sk = lengths[n_cases % len(lengths)]
                q = _bshd(gen, dev, 2, sq, hq, d, dtype)
                k, v = (_bshd(gen, dev, 2, sk, hkv, d, dtype)
                        for _ in range(2))
                what = (f"{dtype} d={d} causal={causal} window={window} "
                        f"heads=({hq},{hkv}) sq={sq} sk={sk}")
                err[dtype] = max(err[dtype], check_flash(q, k, v, causal,
                                                         window, what))
                n_cases += 1
    # non-causal windows with Sq != Sk: rows with no visible key
    for sq, sk in ((384, 63), (200, 1)):
        q = _bshd(gen, dev, 2, sq, 4, 64, torch.float32)
        k, v = (_bshd(gen, dev, 2, sk, 2, 64, torch.float32)
                for _ in range(2))
        err[torch.float32] = max(err[torch.float32], check_flash(
            q, k, v, False, 32, f"dead rows sq={sq} sk={sk}"))
        n_dead += int((fa_ref.flash_attention(q, k, v, False, 32)[1]
                       == fa_ref.NEG_INF).sum())
    if not n_dead:
        fail("flash_attention: the dead-row cases masked no row")
    # the element-wise load instance: every input one element off 16 bytes
    for dtype in (torch.float32, torch.bfloat16):
        q = _bshd(gen, dev, 2, 100, 4, 64, dtype, offset=1)
        k, v = (_bshd(gen, dev, 2, 90, 2, 64, dtype, offset=1)
                for _ in range(2))
        if fa_ops.vector_loads(q, k, v):
            fail("flash_attention: the misaligned case is 16-byte aligned")
        err[dtype] = max(err[dtype], check_flash(
            q, k, v, True, 0, f"{dtype} misaligned view"))
    # 23 x 12 x 3 = 828 items, more than the 132 x 4 blocks resident at
    # once, with a ragged last q tile
    q, k, v = (_bshd(gen, dev, 23, 130, ENC_HEADS, 64, torch.float32)
               for _ in range(3))
    err[torch.float32] = max(err[torch.float32], check_flash(
        q, k, v, False, 0, "828 items (more than one wave)"))
    # full size: one HI²_sup encoder chunk in f32
    d_head = HIDDEN // ENC_HEADS
    q, k, v = (_bshd(gen, dev, ENCODE_BATCH, 64, ENC_HEADS, d_head,
                     torch.float32) for _ in range(3))
    err[torch.float32] = max(err[torch.float32], check_flash(
        q, k, v, False, 0, f"encoder chunk ({ENCODE_BATCH}, {ENC_HEADS}, "
        f"64, {d_head}) f32"))
    del q, k, v
    # full size: llama3-8b's attention, one batch
    q, k, v = llama_qkv(gen, dev)
    err[torch.bfloat16] = max(err[torch.bfloat16], check_flash(
        q, k, v, True, 0, f"llama3-8b {LLAMA_ATTN} bf16 causal"))
    inst = {dtype: ", ".join(fa_ops.instance_name(d, dtype)
                             for d in (16, 64, 128)) for dtype in err}
    log(f"[flash] {n_cases} edge cases + 2 dead-row cases ({n_dead} dead "
        f"rows) + 2 misaligned views + 828 items + the encoder "
        f"chunk + llama3-8b full size: max abs out err f32 "
        f"{err[torch.float32]:.3g} (tol {FLASH_TOL[torch.float32]}; "
        f"{inst[torch.float32]}), bf16 {err[torch.bfloat16]:.3g} (tol "
        f"{FLASH_TOL[torch.bfloat16]}; {inst[torch.bfloat16]}); lse within "
        f"{LSE_TOL}")
    return max(err.values())


def check_assign(x, c, what: str, ties: bool = False
                 ) -> tuple[float, float, int]:
    """Kernel against the plain version: scores within ASSIGN_TOL; ids
    identical except where the plain scores of the two ids lie within
    ASSIGN_TOL (listed by count); on constructed ties (every centroid j
    of the upper half a copy of j - half) the lower twin always wins.
    Returns (max abs and max relative score error, near-tie rows)."""
    gs, gi = at_ops.assign_argmax(x, c)
    ws, wi = at_ref.assign_argmax(x, c)
    if not torch.allclose(gs, ws, rtol=ASSIGN_TOL, atol=ASSIGN_TOL):
        fail(f"assign_argmax {what}: scores differ beyond {ASSIGN_TOL}")
    diff = gi != wi
    near = 0
    if diff.any():
        cb = c if c.dim() == 3 else c[None]
        xb = x if x.dim() == 3 else x[None]
        gib = gi if gi.dim() == 2 else gi[None]
        own = (torch.einsum("mnh,mnh->mn", xb,
                            torch.gather(cb, 1, gib.long()[..., None].expand(
                                -1, -1, cb.shape[2])))
               - 0.5 * torch.gather((cb * cb).sum(-1), 1, gib.long()))
        gap = (own.reshape(ws.shape) - ws).abs()[diff]
        if (gap > ASSIGN_TOL + ASSIGN_TOL * ws.abs()[diff]).any():
            fail(f"assign_argmax {what}: ids differ beyond near-ties")
        near = int(diff.sum())
    if ties and bool((gi >= (c.shape[-2] + 1) // 2).any()):
        fail(f"assign_argmax {what}: a constructed tie went to the higher "
             f"index")
    err = (gs - ws).abs()
    return (float(err.max()), float((err / ws.abs().clamp_min(1e-30)).max()),
            near)


def assign_parity(dev, seed: int, emb, centroids) -> float:
    """Phase 11b: ``assign_argmax`` at ragged N and L, h 8 / 40 / 768,
    h 37 and a view one element off 16-byte alignment (the 4-byte
    copies), PQ's strided (m, n, d_sub) views at d_sub 4 / 8 / 12 (the
    narrow instances), the batched PQ axis, constructed ties, and the
    build's full width on 65,536 corpus points against phase 10's
    centroids."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err, rel, near, n_cases = 0.0, 0.0, {}, 0

    def held(key, x, c, ties=False):
        nonlocal err, rel
        e, r, near[key] = check_assign(x, c, key, ties)
        err, rel = max(err, e), max(rel, r)

    for n in ASSIGN_SIZES:
        for l in ASSIGN_SIZES:
            h = (8, 40, 768)[n_cases % 3]
            held(f"{n}x{l}x{h}", torch.randn((n, h), generator=gen,
                                            device=dev),
                 torch.randn((l, h), generator=gen, device=dev))
            n_cases += 1
    big = ASSIGN_SIZES[-1]
    held("h37", torch.randn((1000, 37), generator=gen, device=dev),
         torch.randn((300, 37), generator=gen, device=dev))
    flat = torch.randn(777 * HIDDEN + 1, generator=gen, device=dev)
    held("misaligned view", flat[1:].view(777, HIDDEN),
         torch.randn((500, HIDDEN), generator=gen, device=dev))
    for dsub in (4, 8, 12):
        m = HIDDEN // dsub
        held(f"pq view d_sub {dsub}",
             torch.randn((big, HIDDEN), generator=gen, device=dev).view(
                 big, m, dsub).transpose(0, 1),
             torch.randn((m, PQ_K, dsub), generator=gen, device=dev))
    for m, n, l, h in ((PQ_M, big, PQ_K, HIDDEN // PQ_M),
                       (1, big, big, HIDDEN)):
        x = torch.randn((n, m, h), generator=gen, device=dev).transpose(0, 1)
        half = torch.randn((m, (l + 1) // 2, h), generator=gen, device=dev)
        c = torch.cat([half, half], dim=1)[:, :l].contiguous()
        held(f"ties {m}x{n}x{l}x{h}", x, c, ties=True)
    held(f"build width {ASSIGN_BLOCK}x{centroids.shape[0]}",
         emb[:ASSIGN_BLOCK], centroids)
    log(f"[assign] {n_cases} ragged cases + h 37 + misaligned view + 3 PQ "
        f"views + 2 tie cases + build width: max abs score err {err:.3g}, "
        f"max relative {rel:.3g} (allclose with rtol = atol = "
        f"{ASSIGN_TOL}); ids differing at near-ties (plain scores within "
        f"{ASSIGN_TOL}): { {k: v for k, v in near.items() if v} }")
    return err


def sup_params(rng: np.random.Generator, centroids: np.ndarray) -> dict:
    """DistillParams leaves in the reference's layout: the term-scorer
    encoder and MLP drawn at the init scales of ``layers.dense_init``
    (N(0, 1/d_in)), ``embedding_init`` (N(0, 0.02²)) and
    ``term_selector.init_mlp``; the cluster embeddings given."""
    d, f, L = HIDDEN, 4 * HIDDEN, ENC_LAYERS

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    leaves = {
        ".cluster_embeddings": centroids,
        ".term_mlp.w1": normal((d, d), d ** -0.5),
        ".term_mlp.b1": np.zeros(d, np.float32),
        ".term_mlp.w2": normal((d, 1), d ** -0.5),
        ".term_mlp.b2": np.zeros(1, np.float32),
        ".encoder['embed']['table']": normal((VOCAB, d), 0.02),
        ".encoder['final_norm']['scale']": np.ones(d, np.float32),
        ".encoder['unembed']['w']": normal((d, VOCAB), d ** -0.5),
        ".encoder['layers']['attn_norm']['scale']": np.ones((L, d),
                                                            np.float32),
        ".encoder['layers']['mlp_norm']['scale']": np.ones((L, d),
                                                           np.float32),
        ".encoder['layers']['mlp']['w_gate']['w']": normal((L, d, f),
                                                           d ** -0.5),
        ".encoder['layers']['mlp']['w_up']['w']": normal((L, d, f),
                                                         d ** -0.5),
        ".encoder['layers']['mlp']['w_down']['w']": normal((L, f, d),
                                                           f ** -0.5),
    }
    for w in ("wq", "wk", "wv", "wo"):
        leaves[f".encoder['layers']['attn']['{w}']['w']"] = normal(
            (L, d, d), d ** -0.5)
    return leaves


def check_sup_scores(sel, params, enc_cfg, tokens) -> None:
    """The first N_SUP_CHECK documents' position scores against the CPU
    plain path, and their top-K₁ᵀ term lists, equal except documents
    whose CPU scores hold a near-tie within SUP_TOL (listed)."""
    first = sel.position_scores(tokens[:ENCODE_BATCH])[:N_SUP_CHECK].cpu()
    cpu_tokens = tokens[:N_SUP_CHECK].cpu()
    t0 = time.perf_counter()
    cpu = train.SupSelectors(params, enc_cfg, encode_batch=N_SUP_CHECK,
                             device="cpu").position_scores(cpu_tokens)
    cpu_s = time.perf_counter() - t0
    if not torch.allclose(first, cpu, rtol=SUP_TOL, atol=SUP_TOL):
        fail(f"HI²_sup position scores differ from the CPU beyond "
             f"{SUP_TOL} (max {float((first - cpu).abs().max()):.3g})")
    ids, _ = ts_mod.doc_terms(cpu_tokens, first, K1_TERMS)
    wids, wsc = ts_mod.doc_terms(cpu_tokens, cpu, K1_TERMS + 1)
    gaps = (wsc[:, :-1] - wsc[:, 1:]).abs()
    near = torch.nonzero((gaps <= SUP_TOL).any(dim=1)).flatten().tolist()
    same = (ids == wids[:, :K1_TERMS]).all(dim=1)
    bad = [d for d in torch.nonzero(~same).flatten().tolist()
           if d not in near]
    if bad:
        fail(f"HI²_sup term lists differ from the CPU on docs {bad[:10]}")
    log(f"[sup] {N_SUP_CHECK} docs: position scores match the CPU plain "
        f"path (max abs err {float((first - cpu).abs().max()):.3g}, tol "
        f"{SUP_TOL}; CPU encoder {cpu_s:.1f} s); term lists equal except "
        f"near-tie docs {near} (of which differing: "
        f"{[d for d in near if not bool(same[d])]})")


def sup_path(dev, seed: int, built: dict) -> tuple[dict, dict]:
    """Phase 12: the HI²_sup indexing path at the paper's BERT slot over
    phase 10's corpus and cluster embeddings.  Returns (the counted
    run's launches, what phase 13 times: one chunk's q, k, v)."""
    with phase("12a sup: parameters"):
        enc_cfg = tfm.TransformerConfig(
            n_layers=ENC_LAYERS, d_model=HIDDEN, n_heads=ENC_HEADS,
            n_kv_heads=ENC_HEADS, d_ff=4 * HIDDEN, vocab_size=VOCAB,
            causal=False, compute_dtype=torch.float32, remat=False)
        leaves = sup_params(np.random.default_rng(seed),
                            built["cluster_sel"].embeddings.cpu().numpy())
        n_params = sum(a.size for p, a in leaves.items()
                       if p.startswith(".encoder"))
        params = ckpt.distill_params_from_numpy(leaves, enc_cfg, device=dev)
        del leaves
        sel = train.SupSelectors(params, enc_cfg, encode_batch=ENCODE_BATCH,
                                 device=dev)
        log(f"[sup] encoder {ENC_LAYERS} layers x d {HIDDEN}, {ENC_HEADS} "
            f"heads, d_ff {4 * HIDDEN}, V {VOCAB}: {n_params / 1e6:.1f} M "
            f"parameters")
    with phase("12b sup: scores against the CPU"):
        check_sup_scores(sel, params, enc_cfg, built["tokens"])
    corpus = built["corpus"]
    with phase("12c sup: build_sup_index (counted)"):
        timings = {}
        reset_counts()
        index = train.build_sup_index(
            types.SimpleNamespace(doc_emb=built["emb"],
                                  doc_tokens=built["tokens"],
                                  vocab_size=VOCAB),
            params, enc_cfg, built["doc_assign"], k1_terms=K1_TERMS,
            codec=REFINE_CODEC, cluster_capacity=CLUSTER_CAP,
            term_capacity=TERM_CAP, encode_batch=ENCODE_BATCH, device=dev,
            timings=timings)
        torch.cuda.synchronize()
        launches = read_counts()
        chunks = -(-BUILD_DOCS // ENCODE_BATCH)
        n_tokens = BUILD_DOCS * corpus.doc_tokens.shape[1]
        log(f"[sup] build_sup_index stage seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
            + f"; launches {launches}; the encoder over {n_tokens} tokens: "
            f"{n_tokens / timings['position_scores'] / 1e6:.2f} M tokens/s")
        want = {"flash_attention": ENC_LAYERS * chunks, "assign_argmax": 0}
        for kname, n in want.items():
            if launches[kname] != n:
                fail(f"HI²_sup build launched {kname} {launches[kname]} "
                     f"times, expected {n}")
    with phase("12d sup: serving"):
        qe, qt = corpus.query_emb, corpus.query_tokens
        _, results, serve_launches = serve_batches(
            index, dev, qe, qt, BUILD_QUERIES // BATCH,
            ("sq8_dot_fused", "topk_scores"), f"HI²_sup {REFINE_CODEC}")
        ids = torch.cat([r.doc_ids for r in results]).cpu()
        r100 = metrics.recall_at_k(ids, corpus.qrels, 100)
        m10 = metrics.mrr_at_k(ids, corpus.qrels, 10)
        log(f"[sup] HI²_sup {REFINE_CODEC}: R@100 {r100:.4f}, MRR@10 "
            f"{m10:.4f} beside phase 10's HI²_unsup {REFINE_CODEC}: R@100 "
            f"{built['recall']:.4f}, MRR@10 {built['mrr']:.4f} (random "
            f"encoder: this checks the path, not quality)")
    with phase("12e sup: check against the CPU"):
        qe0 = torch.from_numpy(qe[:BATCH]).to(dev)
        qt0 = torch.from_numpy(qt[:BATCH]).to(dev).long()
        inp = main_path_inputs(index, qe0, qt0)
        check_cpu(index.to("cpu"), qe[:N_CHECK], qt[:N_CHECK], inp,
                  results[0], SQ8_TOL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_len = corpus.doc_tokens.shape[1]
    d_head = HIDDEN // ENC_HEADS
    shapes = dict(q=_bshd(gen, dev, ENCODE_BATCH, s_len, ENC_HEADS, d_head,
                          torch.float32))
    shapes["k"], shapes["v"] = (_bshd(gen, dev, ENCODE_BATCH, s_len,
                                      ENC_HEADS, d_head, torch.float32)
                                for _ in range(2))
    return launches, shapes


def flash_causal_times(timer, what: str, b: int, s_len: int, hq: int,
                       hkv: int, d: int, dev, plain: bool = False) -> dict:
    """``flash_attention`` at a causal bf16 LM shape (the tensor-core
    kernel): kernel and library (``scaled_dot_product_attention``) ms
    beside the bound at the card's bf16 tensor-core peak (and, under
    ``fp32_fma_bound_ms``, at the fp32 FMA rate, the floor of the FMA
    kernel that ran bf16 before the tensor-core one).  With ``plain`` the
    kernel is first held against its plain version there
    (:func:`check_flash`, one batch row at a time; its error under
    ``max_abs_err``) and the plain version is timed."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _bshd(gen, dev, b, s_len, hq, d, torch.bfloat16)
    k, v = (_bshd(gen, dev, b, s_len, hkv, d, torch.bfloat16)
            for _ in range(2))
    flops = 4.0 * b * hq * s_len * s_len * d / 2          # causal: half
    # q, k, v and out in bf16, lse in f32
    nbytes = 2.0 * b * s_len * d * (2 * hq + 2 * hkv) + 4.0 * b * hq * s_len
    bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    fp32_ms = bound(flops, nbytes)[0]
    out = {}
    if plain:
        out["max_abs_err"] = check_flash(q, k, v, True, 0, f"at {what}",
                                         batch_block=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out.update(
        ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, True, 0),
                    reps=10),
        library_ms=timer.ms(lambda: sdpa(q, k, v, is_causal=True,
                                         enable_gqa=True), reps=10),
        bound_ms=bms, bound_by=by, fp32_fma_bound_ms=fp32_ms)
    if plain:
        out["plain_ms"] = timer.ms(lambda: fa_ref.flash_attention(
            q, k, v, True, 0, q_chunk=fa_ops.Q_CHUNK), reps=3)
    log(f"[times] flash_attention at {what} {(b, s_len, hq, hkv, d)} (B, S, "
        f"Hq, Hkv, d; bf16, causal; "
        f"{fa_ops.instance_name(d, torch.bfloat16)}): kernel "
        f"{out['ms']:.3f} ms, library "
        f"{out['library_ms']:.3f} ms"
        + (f", plain {out['plain_ms']:.3f} ms (out within "
           f"{FLASH_TOL[torch.bfloat16]} of it: max abs err "
           f"{out['max_abs_err']:.3g})" if plain else "")
        + f", bound {bms:.3f} ms ({by}, at the bf16 tensor-core peak), "
        f"bound / kernel {bms / out['ms']:.1%} of the bf16 bound; at the "
        f"fp32 FMA rate, {fp32_ms:.3f} ms")
    return out


def time_new_kernels(flash_in: dict, emb, centroids) -> dict:
    """Phase 13: ``flash_attention`` at one encoder chunk's shape and
    ``assign_argmax`` at the build's KMeans and PQ shapes: kernel, plain
    and library times beside each bound (the PQ shape's under the
    ``assign_argmax`` entry's ``pq_shape``).  The plain versions and the
    library's assignment build an (n, L) plane, so they run in blocks of
    ASSIGN_BLOCK points (the whole plane at N = 1,048,576 is 42 GB)."""
    timer = Timer()
    q, k, v = flash_in["q"], flash_in["k"], flash_in["v"]
    b, hq, s_len, d = q.shape
    fa_flops = 4.0 * b * hq * s_len * s_len * d
    fa_bytes = 4.0 * (4 * b * hq * s_len * d + b * hq * s_len)
    fa_bound = bound(fa_flops, fa_bytes)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash = dict(
        ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, False, 0),
                    reps=10),
        plain_ms=timer.ms(lambda: fa_ref.flash_attention(q, k, v, False, 0),
                          reps=5),
        library_ms=timer.ms(lambda: sdpa(q, k, v), reps=10),
        bound_ms=fa_bound[0], bound_by=fa_bound[1])
    flash["bound_share"] = fa_bound[0] / flash["ms"]
    log(f"[times] flash_attention at B={b}, H={hq}, S={s_len}, d={d} f32 "
        f"(one encoder chunk): {fa_flops / 1e9:.1f} GFLOP, "
        f"{fa_bytes / 1e9:.2f} GB; kernel {flash['ms']:.3f} ms, plain "
        f"{flash['plain_ms']:.3f} ms, library (scaled_dot_product_attention)"
        f" {flash['library_ms']:.3f} ms, bound {fa_bound[0]:.3f} ms "
        f"({fa_bound[1]}), bound / kernel {flash['bound_share']:.1%}")
    flash_causal_times(timer, "llama3-8b's shape", *LLAMA_ATTN, q.device)

    def blocked(fn, x, c):
        def run():
            for i in range(0, x.shape[-2], ASSIGN_BLOCK):
                fn(x[..., i:i + ASSIGN_BLOCK, :], c)
        return run

    def library(xb, c):
        return torch.argmax(xb @ c.transpose(-1, -2)
                            - 0.5 * (c * c).sum(-1)[..., None, :], dim=-1)

    n, h = emb.shape
    l = centroids.shape[0]
    as_flops = 2.0 * n * l * h
    as_bytes = 4.0 * (n * h + l * h + 2 * n)
    as_bound = bound(as_flops, as_bytes)
    assign = dict(
        ms=timer.ms(lambda: at_ops.assign_argmax(emb, centroids), reps=3,
                    warm=1),
        plain_ms=timer.ms(blocked(at_ref.assign_argmax, emb, centroids),
                          reps=2, warm=1),
        library_ms=timer.ms(blocked(library, emb, centroids), reps=2,
                            warm=1),
        bound_ms=as_bound[0], bound_by=as_bound[1])
    log(f"[times] assign_argmax at the KMeans shape N={n}, L={l}, h={h}: "
        f"{as_flops / 1e12:.2f} TFLOP; kernel {assign['ms']:.1f} ms, plain "
        f"{assign['plain_ms']:.1f} ms, library (torch.argmax(x @ c.T - "
        f"½‖c‖²) in {ASSIGN_BLOCK}-point blocks) {assign['library_ms']:.1f} "
        f"ms, bound {as_bound[0]:.1f} ms ({as_bound[1]})")
    m, dsub = PQ_M, h // PQ_M
    frags = emb.reshape(n, m, dsub).transpose(0, 1)
    gen = torch.Generator(device=emb.device).manual_seed(2)
    cw = torch.randn((m, PQ_K, dsub), generator=gen, device=emb.device)
    pq_bound = bound(2.0 * m * n * PQ_K * dsub,
                     4.0 * (n * h + m * PQ_K * dsub + 2 * m * n))
    assign["pq_shape"] = pq = dict(
        ms=timer.ms(lambda: at_ops.assign_argmax(frags, cw), reps=5),
        plain_ms=timer.ms(blocked(at_ref.assign_argmax, frags, cw), reps=2,
                          warm=1),
        library_ms=timer.ms(blocked(library, frags, cw), reps=3, warm=1),
        bound_ms=pq_bound[0], bound_by=pq_bound[1])
    log(f"[times] assign_argmax at the PQ shape m={m}, N={n}, k={PQ_K}, "
        f"d_sub={dsub} (strided view): kernel {pq['ms']:.2f} ms, plain "
        f"{pq['plain_ms']:.2f} ms, library (blocked) {pq['library_ms']:.2f}"
        f" ms, bound {pq_bound[0]:.2f} ms ({pq_bound[1]})")
    return {"flash_attention": flash, "assign_argmax": assign}


# --------------------------------------------------------------------------
# phase 15: the mutable index (base + delta segment + tombstones)
# --------------------------------------------------------------------------

def serve_mutable(mut, dev, qe_all, qt_all, batches: int, score_kernel: str,
                  what: str, fusion_weight=None):
    """A counted run over a MutableServer: every count set to 0 just
    before the batches and read just after; ``topk_scores`` must launch
    once a batch and ``score_kernel`` twice (the base and the delta
    source).  Returns (server, results, launches, q/s)."""
    server = serve.make_mutable_server(mut, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH, mutable=True,
        fusion_weight=fusion_weight), device=dev)
    server.warmup(qe_all.shape[1], qt_all.shape[1])
    reset_counts()
    results, batch_s = [], []
    for i in range(batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t0 = time.perf_counter()
        results.append(server.query(qe_all[sl], qt_all[sl]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = read_counts()
    qps = server.n_served / sum(batch_s)
    log(f"[mutable] {what}: {server.n_served} queries in {sum(batch_s):.3f}"
        f" s ({qps:.1f} q/s; batch ms {[round(s * 1e3, 2) for s in batch_s]}"
        f"); launches {launches}")
    want = {"topk_scores": batches, score_kernel: 2 * batches}
    for kname, n in want.items():
        if launches[kname] != n:
            fail(f"{what}: {kname} launched {launches[kname]} times, "
                 f"expected {n}")
    for res in results:
        if res.doc_ids.shape != (BATCH, TOP_R):
            fail(f"{what}: result shape {tuple(res.doc_ids.shape)}")
        if not torch.isfinite(res.scores).all():
            fail(f"{what}: non-finite result scores")
    return server, results, launches, qps


def mutable_on_cpu(mut):
    """The same base, delta planes, eviction scores and tombstones as a
    mutable index on the CPU (the plain path)."""
    tree = dict(mut.state_tree(), base=mut.base.to("cpu"))
    return segments.MutableHybridIndex.from_state(tree, mut.state_extra(),
                                                  seed=mut.seed)


def check_mutable_cpu(mut, qe8, qt8, first, tol: float, what: str) -> None:
    """The first N_CHECK queries of a served batch against the CPU plain
    path over the same base, delta and tombstones: n_candidates exact,
    top-R within ``tol`` (phase 6's rule).  A query whose K^C-th and
    next cluster scores lie within TOPK_TOL may dispatch other clusters:
    it is listed, not checked."""
    t0 = time.perf_counter()
    cpu = mutable_on_cpu(mut)
    ref = cpu.search(qe8, qt8, kc=KC, k2=K2, top_r=TOP_R)
    cpu_s = time.perf_counter() - t0
    full = torch.from_numpy(qe8) @ cpu.base.cluster_sel.embeddings.T
    top = torch.sort(full, dim=-1, descending=True).values[:, : KC + 1]
    boundary = (top[:, KC - 1] - top[:, KC]) <= TOPK_TOL
    skipped = [b for b in range(N_CHECK) if bool(boundary[b])]
    for b in range(N_CHECK):
        if b in skipped:
            continue
        if int(first.n_candidates[b]) != int(ref.n_candidates[b]):
            fail(f"{what} query {b}: n_candidates differs from the CPU")
        if not topk_match(ref.doc_ids[b].numpy(), ref.scores[b].numpy(),
                          first.doc_ids[b].cpu().numpy(),
                          first.scores[b].cpu().numpy(), tol):
            fail(f"{what} query {b}: top-R differs from the CPU path")
    log(f"[mutable] {what}: {N_CHECK - len(skipped)} of {N_CHECK} queries "
        f"match the CPU plain path over the same base, delta and "
        f"tombstones (state copied and searched on the CPU in {cpu_s:.1f} "
        f"s); near-ties at the K^C boundary, skipped: {skipped}")


def mutable_stream(mut, dev, corpus, batches: int, score_kernel: str,
                   spec: str, fused: bool, record: dict = None) -> tuple:
    """Stream the corpus's last MUT_STREAM documents in MUT_FILLS steps,
    each ``add_docs`` a counted run (one ``assign_argmax`` launch: the
    codec encode, for ``opq``), serving dense (and fused) batches before
    the first step and after each; ``record`` keeps each state's results
    under (fill, fusion weight).  Returns (the streamed ids, the last
    dense batch's results)."""
    qe, qt = corpus.query_emb, corpus.query_tokens
    stream_emb = corpus.doc_emb[MUT_BASE:MUT_BASE + MUT_STREAM]
    stream_tok = corpus.doc_tokens[MUT_BASE:MUT_BASE + MUT_STREAM]
    added, done, last = [], 0, None
    want_assign = 1 if spec == "opq" else 0
    for frac in (0.0,) + MUT_FILLS:
        upto = int(frac * MUT_STREAM)
        if upto > done:
            timings = {}
            reset_counts()
            t0 = time.perf_counter()
            added.append(mut.add_docs(stream_emb[done:upto],
                                      stream_tok[done:upto],
                                      timings=timings))
            add_s = time.perf_counter() - t0
            launches = read_counts()
            log(f"[mutable] {spec} add_docs of {upto - done} docs: "
                f"{add_s:.2f} s (device part {timings['device']:.2f} s, "
                f"host list inserts {timings['inserts']:.2f} s); "
                f"launches {launches}; dropped postings so far "
                f"{mut.dropped_postings}")
            if launches["assign_argmax"] != want_assign:
                fail(f"{spec} add_docs launched assign_argmax "
                     f"{launches['assign_argmax']} times, expected "
                     f"{want_assign}")
            done = upto
        modes = ((None, "dense"), (FUSION_WEIGHT, "fused")) if fused else (
            (None, "dense"),)
        for weight, name in modes:
            _, results, _, qps = serve_mutable(
                mut, dev, qe, qt, batches, score_kernel,
                f"{spec} fill {frac} {name}", fusion_weight=weight)
            ids = torch.cat([r.doc_ids for r in results]).cpu()
            log(f"[mutable] {spec} fill {frac} ({mut.delta_count} delta "
                f"docs) {name}: R@100 "
                f"{metrics.recall_at_k(ids, corpus.qrels[:len(ids)], 100):.4f}"
                f", {qps:.1f} q/s")
            if weight is None:
                last = results
            if record is not None:
                record[(frac, weight)] = results
    return np.concatenate(added), last


def mutable_delete(mut, dev, corpus, batches: int, score_kernel: str,
                   spec: str, added, last, fused: bool, record: dict = None):
    """Delete every id in the top 10 of the last dense batch (base and
    delta alike) plus a quarter of the streamed ids, then serve again:
    no deleted id may appear in any result.  ``record`` keeps the
    deleted ids and the results under ("deleted", fusion weight).
    Returns the first dense batch after the deletes."""
    top10 = last[-1].doc_ids[:, :10].cpu().numpy().ravel()
    doomed = np.unique(np.concatenate([top10[top10 >= 0],
                                       added[: MUT_STREAM // 4]]))
    t0 = time.perf_counter()
    mut.delete_docs(doomed)
    log(f"[mutable] {spec} delete_docs of {doomed.size} ids "
        f"({int((doomed < mut.n_base).sum())} base, "
        f"{int((doomed >= mut.n_base).sum())} delta): "
        f"{time.perf_counter() - t0:.3f} s; tombstone ratio "
        f"{mut.tombstone_ratio:.4f}")
    qe, qt = corpus.query_emb, corpus.query_tokens
    first = None
    for weight in ((None, FUSION_WEIGHT) if fused else (None,)):
        _, results, _, _ = serve_mutable(
            mut, dev, qe, qt, batches, score_kernel,
            f"{spec} after deletes {'dense' if weight is None else 'fused'}",
            fusion_weight=weight)
        ids = torch.cat([r.doc_ids for r in results]).cpu().numpy()
        if np.isin(ids, doomed).any():
            fail(f"{spec}: a deleted id appeared in a result")
        first = results[0] if first is None else first
        if record is not None:
            record[("deleted", weight)] = results
            record["doomed"] = doomed
    log(f"[mutable] {spec}: no deleted id in any result")
    return first


def mutable_phase(dev, built: dict, seed: int, batches: int) -> dict:
    """Phase 15: the mutable index on the card at full widths over phase
    10's corpus: 15a ``opq`` with the impact plane (create, stream, serve
    dense and fused at each fill, delete, check against the CPU,
    compact against a rebuild), 15b ``refine:sq8:4`` (create, stream,
    delete, check against the CPU).  Returns what 21b replays of 15a:
    its base and build arguments, every state's results, the deleted
    ids and the compacted index's first dense batch."""
    record: dict = {}
    corpus = built["corpus"]
    kw = dict(n_clusters=N_CLUSTERS, k1_terms=K1_TERMS, pq_m=PQ_M,
              pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
              term_capacity=TERM_CAP, kmeans_iters=BUILD_ITERS)
    for spec, kernel, fused in (("opq", "pq_adc_fused", True),
                                (REFINE_CODEC, "sq8_dot_fused", False)):
        tag = "15a" if spec == "opq" else "15b"
        with phase(f"{tag} mutable {spec}: create"):
            mut = segments.MutableHybridIndex.create(
                seed, corpus.doc_emb[:MUT_BASE],
                corpus.doc_tokens[:MUT_BASE], VOCAB,
                delta_capacity=MUT_STREAM, codec=spec, sparse=fused,
                device=dev, **kw)
            caps = (mut.delta_cluster_capacity, mut.delta_term_capacity)
            log(f"[mutable] {spec}: base {mut.n_base} docs, delta "
                f"{MUT_STREAM} slots, delta list capacities {caps}; "
                f"candidate budget {mut.candidate_budget(KC, K2)} slots "
                f"({hi.candidate_budget(mut.base, KC, K2)} in the base)")
            if caps != (MUT_DELTA_CAP, MUT_DELTA_CAP):
                fail(f"{spec}: delta capacities {caps}, expected "
                     f"{MUT_DELTA_CAP}")
        rec = record if spec == "opq" else None
        with phase(f"{tag} mutable {spec}: stream and serve (counted)"):
            added, last = mutable_stream(mut, dev, corpus, batches, kernel,
                                         spec, fused, rec)
        with phase(f"{tag} mutable {spec}: delete and serve"):
            first = mutable_delete(mut, dev, corpus, batches, kernel, spec,
                                   added, last, fused, rec)
        if fused:
            with phase(f"{tag} mutable {spec}: profile"):
                for weight in (None, FUSION_WEIGHT):
                    server = serve.make_mutable_server(
                        mut, serve.ServeConfig(
                            kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
                            mutable=True, fusion_weight=weight), device=dev)
                    log(f"[mutable] profiled batch, fusion weight {weight}")
                    profile_batch(server, corpus.query_emb[:BATCH],
                                  corpus.query_tokens[:BATCH])
        with phase(f"{tag} mutable {spec}: check against the CPU"):
            check_mutable_cpu(mut, corpus.query_emb[:N_CHECK],
                              corpus.query_tokens[:N_CHECK], first,
                              ADC_TOL if spec == "opq" else SQ8_TOL, spec)
        if spec == "opq":
            compacted = compact_vs_rebuild(mut, dev, corpus, kw)
            record.update(
                base=mut.base, build_kwargs=dict(mut.build_kwargs),
                compacted=compacted.search(
                    corpus.query_emb[:BATCH], corpus.query_tokens[:BATCH],
                    kc=KC, k2=K2, top_r=TOP_R))
            with phase("16c runtime (mutable opq)"):
                runtime_mutable(compacted, dev, corpus)
            del compacted
        del mut
        torch.cuda.empty_cache()
    return record


def compact_vs_rebuild(mut, dev, corpus, kw: dict) -> None:
    """15a: ``compact()`` and a fresh ``hi.build`` over
    ``surviving_corpus()`` with the same seed agree bit for bit, leaf for
    leaf and in ids, scores and n_candidates on the first batch."""
    with phase("15a mutable opq: compact"):
        t0 = time.perf_counter()
        compacted = mut.compact()
        torch.cuda.synchronize()
        log(f"[mutable] compact to {compacted.n_base} docs: "
            f"{time.perf_counter() - t0:.2f} s")
    with phase("15a mutable opq: rebuild and compare"):
        emb, tok = mut.surviving_corpus()
        t0 = time.perf_counter()
        rebuilt = hi.build(mut.seed, emb, tok, VOCAB, codec="opq",
                           sparse=True, device=dev, **kw)
        torch.cuda.synchronize()
        log(f"[mutable] hi.build over the {emb.shape[0]} survivors: "
            f"{time.perf_counter() - t0:.2f} s")
        la, lb = hi.index_leaves(compacted.base), hi.index_leaves(rebuilt)
        if [p for p, _ in la] != [p for p, _ in lb]:
            fail("compact: leaf paths differ from the rebuild's")
        differ = [p for (p, x), (_, y) in zip(la, lb)
                  if x.dtype != y.dtype or not torch.equal(x, y)]
        if differ:
            fail(f"compact: leaves differ from the rebuild: {differ}")
        qe = corpus.query_emb[:BATCH]
        qt = corpus.query_tokens[:BATCH]
        a = compacted.search(qe, qt, kc=KC, k2=K2, top_r=TOP_R)
        b = hi.search(rebuilt, qe, qt, kc=KC, k2=K2, top_r=TOP_R,
                      device=dev)
        for name, x, y in (("ids", a.doc_ids, b.doc_ids),
                           ("scores", a.scores, b.scores),
                           ("n_candidates", a.n_candidates,
                            b.n_candidates)):
            if not torch.equal(x, y):
                fail(f"compact: {name} of the first batch differ from the "
                     f"rebuild's")
        old_to_new = np.full(mut.n_docs, -2, np.int64)
        old_to_new[mut.survivors()] = np.arange(compacted.n_base)
        all_qe, all_qt = corpus.query_emb, corpus.query_tokens
        ids = torch.cat([compacted.search(all_qe[i:i + BATCH],
                                          all_qt[i:i + BATCH], kc=KC, k2=K2,
                                          top_r=TOP_R).doc_ids.cpu()
                         for i in range(0, len(all_qe), BATCH)])
        log(f"[mutable] compact equals the rebuild: {len(la)} of {len(la)} "
            f"leaves bit for bit; first batch ids, scores and n_candidates "
            f"equal; compacted R@100 "
            f"{metrics.recall_at_k(ids, old_to_new[corpus.qrels], 100):.4f}")
    return compacted


# --------------------------------------------------------------------------
# phase 16: the serving runtime, one captured CUDA graph per bucket
# --------------------------------------------------------------------------

def runtime_for(server, linger_ms: float = RT_CHECK_LINGER_MS):
    return runtime.ServingRuntime(server, runtime.RuntimeConfig(
        linger_ms=linger_ms, queue_depth=4 * RT_REQUESTS))


def warm_runtime(server, what: str, kernels,
                 total: dict = None) -> "runtime.ServingRuntime":
    """A counted run of the runtime's warmup: every count set to 0 just
    before it and read just after (and added to ``total`` when given);
    exactly one capture per bucket, each kernel of ``kernels`` launched
    (its eager warm and its capture: the replays run the captured
    launches without the wrappers)."""
    rt = runtime_for(server)
    reset_counts()
    before = qexec.trace_count()
    t0 = time.perf_counter()
    rt.warmup(HIDDEN, QUERY_LEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = read_counts()
    captures = qexec.trace_count() - before
    log(f"[runtime] {what}: warmup {warm_s:.2f} s, {captures} captures "
        f"over buckets {list(rt.buckets)}; capture ms "
        f"{ {b: round(s * 1e3, 2) for b, s in rt.capture_seconds.items()} }"
        f"; graph pool {rt.pool_bytes / 1e9:.3f} GB; launches {launches}")
    if captures != len(rt.buckets) or set(rt.warm_traces.values()) != {1}:
        fail(f"runtime {what}: {captures} captures for {len(rt.buckets)} "
             f"buckets ({rt.warm_traces})")
    if not all(rt.captured.values()):
        fail(f"runtime {what}: programs not captured as CUDA graphs: "
             f"{rt.captured}")
    if total is not None:
        _add(total, launches)
    missing = [k for k in kernels if launches[k] < 2 * len(rt.buckets)]
    if missing:
        fail(f"runtime {what}: kernel(s) of the path not captured in every "
             f"bucket: {missing}")
    return rt


def _host_rows(res) -> tuple:
    return tuple(torch.as_tensor(x).cpu().numpy()
                 for x in (res.doc_ids, res.scores, res.n_candidates))


def check_buckets(rt, server, qe, qt, what: str) -> None:
    """Every bucket's rows bit for bit against ``Server.query``'s
    max_batch rows of the same queries; each bucket served once (the
    linger holds a bucket's b submissions together), none captured."""
    direct = _host_rows(server.query(qe[:BATCH], qt[:BATCH]))
    for b in rt.buckets:
        got = _host_rows(rt.query(qe[:b], qt[:b], timeout=120))
        for name, g, w in zip(("ids", "scores", "n_candidates"), got,
                              direct):
            if not np.array_equal(g, w[:b]):
                fail(f"runtime {what}: bucket {b} {name} differ from "
                     f"Server.query's rows")
    if rt.bucket_counts != {b: 1 for b in rt.buckets} or rt.serve_traces:
        fail(f"runtime {what}: batches {rt.bucket_counts}, "
             f"{rt.serve_traces} captures while serving")
    log(f"[runtime] {what}: every bucket {list(rt.buckets)} bit for bit "
        f"equal to Server.query's {BATCH}-row pad (ids, scores, "
        f"n_candidates); no capture while serving")


def replay_vs_eager(rt, server, qe, qt, what: str) -> None:
    """At bucket BATCH: the replayed program (rows in, one replay, one
    packed copy out) against an eager ``Server.query`` batch with its
    rows copied to the host, synchronized CUDA-event medians with host
    time; the device span of a replay alone; one profiled replay."""
    timer = Timer()
    prog = rt._programs[BATCH]
    rows = [qe[:BATCH], qt[:BATCH].astype(np.int64)]
    eager = timer.ms(lambda: _host_rows(server.query(qe[:BATCH],
                                                     qt[:BATCH])), reps=10)
    replay = timer.ms(lambda: prog(rows), reps=10)
    span = Timer(queued=True).ms(prog.graph.replay, reps=10)
    log(f"[runtime] {what}: a {BATCH}-query batch eager {eager:.3f} ms, "
        f"replayed {replay:.3f} ms ({eager / replay:.2f}x); the replay's "
        f"device span {span:.3f} ms")
    profile_call(lambda: prog(rows), f"one replayed batch ({what})")


def runtime_throughput(server, qe_all, qt_all, n_serial: int = RT_REQUESTS
                       ) -> "runtime.ServingRuntime":
    """``qps_serial`` (one ``Server.query`` per query, rows to the host,
    over the first ``n_serial`` requests) against ``qps_runtime``
    (RT_REQUESTS one-query submissions through a runtime at the
    reference's 2 ms linger), then open-loop Poisson arrivals at a
    quarter of the burst rate (serving_load.py's).  Returns the closed
    runtime."""
    req = [(qe_all[i % len(qe_all)], qt_all[i % len(qt_all)])
           for i in range(RT_REQUESTS)]
    t0 = time.perf_counter()
    for e, t in req[:n_serial]:
        _host_rows(server.query(e[None], t[None]))
    qps_serial = n_serial / (time.perf_counter() - t0)
    rt = runtime_for(server, runtime.RuntimeConfig.linger_ms)
    rt.warmup(HIDDEN, QUERY_LEN)
    with rt:
        t0 = time.perf_counter()
        for f in [rt.submit(e, t) for e, t in req]:
            f.result(timeout=120)
        qps_runtime = len(req) / (time.perf_counter() - t0)
        burst = dict(rt.bucket_counts)
        pois = serving_load.poisson(rt, req, qps_runtime / 4.0)
    log(f"[runtime] {len(req)} one-query requests: qps_serial "
        f"{qps_serial:.1f} (over {n_serial}), qps_runtime {qps_runtime:.1f} "
        f"({qps_runtime / qps_serial:.1f}x; batches by bucket {burst}); "
        f"Poisson {json.dumps(pois)}; batches by bucket after it "
        f"{rt.bucket_counts}; requests by replica {rt.replica_dispatch}")
    if qps_runtime < 2 * qps_serial:
        fail("runtime: micro-batched throughput under 2x the serial rate")
    return rt


def runtime_phase(index, dev, qe_all, qt_all, kernels,
                  throughput: bool) -> None:
    """16a / 16b: the runtime over ``index`` dense and fused at
    FUSION_WEIGHT: warmup as a counted run, every bucket bit for bit,
    replay against eager at BATCH; ``throughput`` adds the request
    rates and the Poisson latencies (dense)."""
    for weight in (None, FUSION_WEIGHT):
        what = (f"{index.codec} "
                f"{'dense' if weight is None else f'fused {weight}'}")
        server = serve.Server(index, serve.ServeConfig(
            kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
            fusion_weight=weight), device=dev)
        server.warmup(HIDDEN, QUERY_LEN)
        with warm_runtime(server, what, kernels) as rt:
            check_buckets(rt, server, qe_all, qt_all, what)
            replay_vs_eager(rt, server, qe_all, qt_all, what)
        if throughput and weight is None:
            runtime_throughput(server, qe_all, qt_all)
        del rt, server
        torch.cuda.empty_cache()


def runtime_mutable(mut, dev, corpus) -> None:
    """16c: the runtime over phase 15a's compacted mutable index (an
    empty RT_MUT_ADD-slot delta ahead): ``add``/``delete`` between
    batches capture nothing and the replayed rows equal
    ``MutableServer.query``'s; ``compact()`` captures once per bucket."""
    server = serve.make_mutable_server(mut, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH, mutable=True),
        device=dev)
    qe, qt = corpus.query_emb, corpus.query_tokens
    rt = warm_runtime(server, "mutable opq", ("pq_adc_fused", "topk_scores"))

    def check(n: int):
        got = rt.query(qe[:n], qt[:n], timeout=120)
        want = _host_rows(server.query(qe[:n], qt[:n]))
        if not all(np.array_equal(g, w) for g, w in
                   zip(_host_rows(got), want)):
            fail(f"runtime mutable: {n} rows differ from "
                 f"MutableServer.query's at epoch {server.epoch}")
        return got

    with rt:
        check(BATCH)
        before = qexec.trace_count()
        t0 = time.perf_counter()
        ids = rt.add(corpus.doc_emb[:RT_MUT_ADD],
                     corpus.doc_tokens[:RT_MUT_ADD])
        add_s = time.perf_counter() - t0
        check(7)
        top10 = check(BATCH).doc_ids[:, :10].ravel()
        doomed = np.unique(np.r_[top10[top10 >= 0], ids[::4]])
        rt.delete(doomed)
        last = check(BATCH)
        if np.isin(last.doc_ids, doomed).any():
            fail("runtime mutable: a deleted id was served")
        check(1)
        if qexec.trace_count() != before:
            fail("runtime mutable: add/delete captured a graph")
        t0 = time.perf_counter()
        rt.compact()
        compact_s = time.perf_counter() - t0
        captures = qexec.trace_count() - before
        if captures != len(rt.buckets):
            fail(f"runtime mutable: compact() made {captures} captures for "
                 f"{len(rt.buckets)} buckets")
        check(BATCH)
    log(f"[runtime] mutable opq: add of {RT_MUT_ADD} docs {add_s:.2f} s and "
        f"delete of {doomed.size} ids between batches with no capture, "
        f"rows equal to MutableServer.query's at 1, 7 and {BATCH} queries; "
        f"compact() {compact_s:.2f} s with {captures} captures (one a "
        f"bucket), then equal again; epoch {server.epoch}")
    del rt, server


# --------------------------------------------------------------------------
# phase 17: the width tuner on the card
# --------------------------------------------------------------------------

def _batch_on_card(qe, qt, dev) -> tuple:
    return (torch.from_numpy(qe[:BATCH]).to(dev),
            torch.from_numpy(qt[:BATCH]).to(dev).long())


def tune_on_card(index, dev, built: dict, what: str, kernels,
                 refine_mults=()) -> tuple:
    """17a / 17b: ``tune_index`` over WIDTH_GRID (x ``refine_mults``) on
    phase 10's ``index`` and 1,024 held-out queries, as a counted run,
    against the exact top-10 (phase 10's ``flat.search``) with the
    target autotune.py sets: TARGET_FRAC of the recall at the default
    widths.  Prints every point with the ms of a 256-query batch, the
    frontier, the record and the default's cost beside the tuned one;
    fails unless ``select`` over the printed points gives the record,
    or if a plane moved (a multiplier is a spec rewrite, never a
    re-encode).  Returns (tuned, points)."""
    qe, qt = built["corpus"].query_emb, built["corpus"].query_tokens
    oracle = built["oracle"][:, :autotune.ORACLE_WIDTH].cpu().numpy()
    d_res = hi.search(index, qe, qt, kc=serve.DEFAULT_KC,
                      k2=serve.DEFAULT_K2, top_r=TOP_R, device=dev)
    d_recall = float(tune.per_query_recall(d_res.doc_ids, oracle,
                                           TOP_R).mean())
    d_cost = hi.candidate_cost(index, serve.DEFAULT_KC, serve.DEFAULT_K2,
                               TOP_R)
    target = round(autotune.TARGET_FRAC * d_recall, 4)
    ptrs = [(p, t.data_ptr()) for p, t in hi.index_leaves(index)]
    reset_counts()
    t0 = time.perf_counter()
    tuned, points = tune.tune_index(index, qe, qt, oracle,
                                    recall_target=target, top_r=TOP_R,
                                    refine_mults=refine_mults, device=dev)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = read_counts()
    missing = [k for k in kernels if launches[k] < 1]
    if missing:
        fail(f"tune {what}: kernel(s) of the sweep never launched: "
             f"{missing}")
    moved = [p for (p, ptr), (_, t) in zip(
        ptrs, hi.index_leaves(tune.apply_tuned(index, tuned)))
        if t.data_ptr() != ptr]
    if moved or [p for p, _ in ptrs] != [p for p, _ in
                                         hi.index_leaves(index)]:
        fail(f"tune {what}: planes re-encoded or moved: {moved}")
    log(f"[tune] {what}: {len(points)} points over {len(qe)} queries in "
        f"{tune_s:.2f} s (launches {launches}); oracle exact top-"
        f"{autotune.ORACLE_WIDTH}, target {target} = "
        f"{autotune.TARGET_FRAC} x recall@{TOP_R} {d_recall:.4f} at the "
        f"default ({serve.DEFAULT_KC}, {serve.DEFAULT_K2})")
    timer = Timer()
    qe_b, qt_b = _batch_on_card(qe, qt, dev)
    for p in points:
        idx = (index if p.refine_mult is None else dataclasses.replace(
            index, codec=tune._spec_for(index.codec, p.refine_mult)))
        ms = timer.ms(lambda: hi.search(idx, qe_b, qt_b, kc=p.kc, k2=p.k2,
                                        top_r=TOP_R, device=dev), reps=5)
        log(f"[tune] {what}: kc {p.kc:2d} k2 {p.k2:2d} mult "
            f"{p.refine_mult}: recall@{TOP_R} {p.recall:.4f}, cost "
            f"{p.cost:.0f}, {ms:.3f} ms a {BATCH}-query batch")
    log(f"[tune] {what}: frontier " + "; ".join(
        f"({p.kc}, {p.k2}, {p.refine_mult}) {p.recall:.4f} @ {p.cost:.0f}"
        for p in frontier.pareto_frontier(points)))
    log(f"[tune] {what}: record {json.dumps(frontier.to_json(tuned))}")
    met = tuned.recall >= target and tuned.cost < d_cost
    log(f"[tune] {what}: default ({serve.DEFAULT_KC}, {serve.DEFAULT_K2}) "
        f"cost {d_cost} recall {d_recall:.4f}; tuned ({tuned.kc}, "
        f"{tuned.k2}, {tuned.refine_mult}) cost {tuned.cost} recall "
        f"{tuned.recall:.4f} ({tuned.cost / d_cost:.3f}x the default's "
        f"cost); autotune's check (a) {'met' if met else 'NOT met'} here")
    sel = frontier.select(points, target)
    if ((sel.kc, sel.k2, sel.refine_mult, int(sel.cost), sel.recall)
            != (tuned.kc, tuned.k2, tuned.refine_mult, tuned.cost,
                tuned.recall)):
        fail(f"tune {what}: select over the points gives {sel}, the "
             f"record says {tuned}")
    return tuned, points


def tuned_checkpoint(index, tuned, dev, built: dict) -> None:
    """17c: ``apply_tuned``, ``save_index`` into build/ and
    ``load_index`` onto the card: one batch bitwise equal before and
    after, the manifest's ``extra.tuned`` the record's JSON, and a
    default-config ``Server`` serving the tuned widths with the direct
    search's rows."""
    corpus = built["corpus"]
    qe, qt = _batch_on_card(corpus.query_emb, corpus.query_tokens, dev)
    tidx = tune.apply_tuned(index, tuned)
    want = _host_rows(hi.search(tidx, qe, qt, kc=tuned.kc, k2=tuned.k2,
                                top_r=TOP_R, device=dev))
    shutil.rmtree(TUNE_CKPT, ignore_errors=True)
    t0 = time.perf_counter()
    path = ckpt.save_index(str(TUNE_CKPT), 0, tidx)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ckpt.load_index(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
    got = _host_rows(hi.search(loaded, qe, qt, kc=tuned.kc, k2=tuned.k2,
                               top_r=TOP_R, device=dev))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        fail("tuned checkpoint: a batch of the loaded index differs from "
             "the saved index's")
    extra = ckpt.load_manifest(path)["extra"]
    if extra.get("tuned") != frontier.to_json(tuned) or loaded.tuned != \
            tuned:
        fail(f"tuned checkpoint: manifest records {extra.get('tuned')}")
    server = serve.Server(loaded, serve.ServeConfig(top_r=TOP_R,
                                                    max_batch=BATCH),
                          device=dev)
    if (server.width_source, server.kc, server.k2) != ("tuned", tuned.kc,
                                                       tuned.k2):
        fail(f"tuned checkpoint: a default-config server serves "
             f"({server.kc}, {server.k2}) from {server.width_source}")
    rows = _host_rows(server.query(qe, qt))
    if not all(np.array_equal(g, w) for g, w in zip(rows, want)):
        fail("tuned checkpoint: the tuned server's rows differ from "
             "hi.search at the tuned widths")
    log(f"[tune] checkpoint: save_index {save_s:.2f} s ({nbytes / 1e6:.0f} "
        f"MB), load_index {load_s:.2f} s; {BATCH} rows bitwise equal "
        f"before and after; a default-config Server serves ({server.kc}, "
        f"{server.k2}) from {server.width_source!r}, its rows bitwise "
        f"equal to hi.search; manifest extra.tuned == to_json(record)")
    shutil.rmtree(TUNE_CKPT, ignore_errors=True)


def _ladder(index, tuned, points, qe) -> tuple:
    """The record's ladder when its calibration kept two rungs, else the
    two-rung ladder tests/test_runtime.py builds: the frontier point
    just below the tuned one (above it when none is cheaper) and the
    tuned point, cut at the median margin."""
    if len(tuned.rungs) > 1:
        return tuned, "calibrated by tune_index"
    front = frontier.pareto_frontier(
        [p for p in points if p.refine_mult == tuned.refine_mult])
    at = [(p.kc, p.k2) for p in front].index((tuned.kc, tuned.k2))
    pair = (front[at - 1], front[at]) if at else (front[0], front[1])
    cut = float(np.median(frontier.margins(index.cluster_sel.embeddings,
                                           qe)))
    return (tuned._replace(rungs=tuple((p.kc, p.k2) for p in pair),
                           margin_cuts=(cut,)),
            "built here (the calibration kept one rung): median margin cut")


def adaptive_runtime(index, tuned, points, dev, built: dict) -> None:
    """17d: the adaptive runtime over the tuned ``opq`` index: buckets
    1..256 x rungs captured as a counted run (exactly one capture per
    (bucket, rung)), RT_REQUESTS one-query requests served with nothing
    captured, every row bitwise equal to ``hi.search`` at its resolved
    rung's widths, every rung dispatched, a replay pass served from the
    cache at the rung it was computed at; ``qps_runtime`` adaptive
    against single-rung on the same index, ``_rung_for``'s µs a request
    and the pool's bytes; then bucket_invariance at the served widths."""
    corpus = built["corpus"]
    qe, qt = corpus.query_emb, corpus.query_tokens
    req = [(qe[i % len(qe)], qt[i % len(qt)]) for i in range(RT_REQUESTS)]
    ladder, which = _ladder(index, tuned, points, qe)
    aidx = hi.with_tuned(tune.apply_tuned(index, tuned), ladder)
    server = serve.Server(aidx, serve.ServeConfig(
        top_r=TOP_R, max_batch=BATCH, adaptive=True), device=dev)
    log(f"[adaptive] ladder {server.rungs}, cuts {server.margin_cuts} "
        f"({which})")
    rt = runtime.ServingRuntime(server, runtime.RuntimeConfig(
        queue_depth=4 * RT_REQUESTS, cache_size=2 * RT_REQUESTS))
    reset_counts()
    before = qexec.trace_count()
    t0 = time.perf_counter()
    rt.warmup(HIDDEN, QUERY_LEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = read_counts()
    captures = qexec.trace_count() - before
    want = {(b, r) for b in rt.buckets for r in range(len(rt.rungs))}
    if (captures != len(want) or set(rt.warm_traces) != want
            or set(rt.warm_traces.values()) != {1}):
        fail(f"adaptive: {captures} captures, ledger {rt.warm_traces}")
    missing = [k for k in ("pq_adc_fused", "topk_scores")
               if launches[k] < 2 * len(want)]
    if missing:
        fail(f"adaptive: kernel(s) not captured in every program: "
             f"{missing}")
    t0 = time.perf_counter()
    rungs = np.array([rt._rung_for(e) for e, _ in req])
    rung_us = (time.perf_counter() - t0) / len(req) * 1e6
    # the reference's request path casts the float32 embeddings it holds
    # to float64 inside every margins call
    emb32 = aidx.cluster_sel.embeddings.cpu().numpy()
    t0 = time.perf_counter()
    for e, _ in req[:64]:
        frontier.margins(emb32, e[None])
    cast_us = (time.perf_counter() - t0) / 64 * 1e6
    emb64 = frontier.host64(aidx.cluster_sel.embeddings)
    ref_rungs = frontier.resolve_rung(frontier.margins(
        emb64, np.stack([e for e, _ in req])), rt.margin_cuts)
    if not np.array_equal(rungs, ref_rungs):
        fail("adaptive: _rung_for differs from resolve_rung(margins)")
    with rt:
        t0 = time.perf_counter()
        rows = [f.result(timeout=120) for f in
                [rt.submit(e, t) for e, t in req]]
        qps_adaptive = len(req) / (time.perf_counter() - t0)
        burst = dict(rt.bucket_counts)
        if rt.serve_traces:
            fail(f"adaptive: {rt.serve_traces} captures while serving")
        if not all(rt.rung_dispatch[r] for r in range(len(rt.rungs))):
            fail(f"adaptive: a rung was never dispatched: "
                 f"{rt.rung_dispatch}")
        hits = rt.cache.hits
        again = [f.result(timeout=120) for f in
                 [rt.submit(e, t) for e, t in req]]
        if rt.cache.hits - hits != len(req) or not all(
                np.array_equal(a.doc_ids, b.doc_ids)
                and np.array_equal(a.scores, b.scores)
                for a, b in zip(rows, again)):
            fail("adaptive: the replay pass was not served from the cache "
                 "bit for bit")
        q0, t0_ = req[0]
        if len({rt._key(q0, t0_.astype(np.int64), None, r)
                for r in range(len(rt.rungs))}) != len(rt.rungs):
            fail("adaptive: the cache key does not separate the rungs")
        dispatch, pool = dict(rt.rung_dispatch), rt.pool_bytes
        capture_ms = {k: round(v * 1e3, 1)
                      for k, v in rt.capture_seconds.items()}
    for r, (kc, k2) in enumerate(rt.rungs):
        ids, scores, n_cand = _host_rows(hi.search(
            aidx, qe, qt, kc=kc, k2=k2, top_r=TOP_R, device=dev))
        for i in np.nonzero(rungs == r)[0]:
            j = i % len(qe)
            if not (np.array_equal(rows[i].doc_ids, ids[j])
                    and np.array_equal(rows[i].scores, scores[j])
                    and int(rows[i].n_candidates) == int(n_cand[j])):
                fail(f"adaptive: request {i} (rung {r}) differs from "
                     f"hi.search at ({kc}, {k2})")
    del rt
    single = serve.Server(aidx, serve.ServeConfig(top_r=TOP_R,
                                                  max_batch=BATCH),
                          device=dev)
    srt = runtime.ServingRuntime(single, runtime.RuntimeConfig(
        queue_depth=4 * RT_REQUESTS))
    srt.warmup(HIDDEN, QUERY_LEN)
    with srt:
        t0 = time.perf_counter()
        for f in [srt.submit(e, t) for e, t in req]:
            f.result(timeout=120)
        qps_single = len(req) / (time.perf_counter() - t0)
    log(f"[adaptive] warmup {warm_s:.2f} s, {captures} captures (one per "
        f"(bucket, rung) over buckets {list(srt.buckets)} x "
        f"{len(server.rungs)} rungs), capture ms {capture_ms}; graph pool "
        f"{pool / 1e9:.3f} GB; launches {launches}")
    log(f"[adaptive] {len(req)} one-query requests: rung dispatch "
        f"{dispatch}; every row bitwise equal to hi.search at its rung; "
        f"replay {len(req)}/{len(req)} cache hits at the rung computed; "
        f"batches by bucket {burst}")
    log(f"[adaptive] qps_runtime adaptive {qps_adaptive:.1f}, single-rung "
        f"({single.kc}, {single.k2}) {qps_single:.1f} "
        f"({qps_adaptive / qps_single:.3f}x); _rung_for {rung_us:.1f} µs a "
        f"request (host float64 margin over the ({emb64.shape[0]}, "
        f"{emb64.shape[1]}) copy the runtime holds; {cast_us:.1f} µs with "
        f"the reference's per-request cast of the float32 embeddings)")
    inv = bucket_invariance.run(argparse.Namespace(
        device="cuda", seed=0, clusters=N_CLUSTERS, rows=2_000_000))
    log(f"[adaptive] bucket_invariance {json.dumps(inv)}")
    bad = [n for n, r in inv["products"].items() if r["fixed_rows"]]
    bad += [n for n, r in inv["kernels"].items() if r]
    if bad:
        fail(f"bucket_invariance: rows depend on the batch size: {bad}")


def autotune_on_card(argv: list, what: str, strict: bool) -> None:
    """17e: ``benchmarks/autotune.py --check`` on the card, as a counted
    run (its builds launch ``assign_argmax``, its sweep and runtime
    ``pq_adc_fused`` and ``topk_scores``).  Fails on any entry of the
    check list when ``strict``, else on the serving contracts (c)-(e)
    only, printing (a) and (b), which judge what the tune found on the
    data."""
    reset_counts()
    report = autotune.run(autotune.parse_args(argv + ["--check", "--device",
                                                      "cuda"]))
    torch.cuda.synchronize()
    launches = read_counts()
    log(json.dumps(report, sort_keys=True))
    tune_fails = autotune.check_tune(report)
    log(f"[autotune] {what}: launches {launches}; contracts (a)-(b) "
        f"{tune_fails or 'met'}, (c)-(e) "
        f"{autotune.check_serving(report) or 'met'}")
    failures = autotune.check_serving(report) + (tune_fails if strict
                                                 else [])
    if failures:
        fail(f"autotune {what} --check: {failures}")
    missing = [k for k in ("assign_argmax", "pq_adc_fused", "topk_scores")
               if launches[k] < 1]
    if missing:
        fail(f"autotune {what} never launched {missing}")


def tuner_phase(dev, built: dict) -> None:
    """Phase 17 over phase 10's indexes (popped from ``built``)."""
    indexes = built.pop("indexes")
    with phase("17a tune (opq)"):
        tuned, points = tune_on_card(indexes["opq"], dev, built, "opq",
                                     ("pq_adc_fused", "topk_scores"))
    with phase(f"17b tune ({REFINE_CODEC}, mults {TUNE_MULTS})"):
        tune_on_card(indexes[REFINE_CODEC], dev, built, REFINE_CODEC,
                     ("sq8_dot_fused", "topk_scores"),
                     refine_mults=TUNE_MULTS)
    del indexes[REFINE_CODEC]
    with phase("17c tuned checkpoint (opq)"):
        tuned_checkpoint(indexes["opq"], tuned, dev, built)
    with phase("17d adaptive runtime (opq)"):
        adaptive_runtime(indexes["opq"], tuned, points, dev, built)
    del indexes
    torch.cuda.empty_cache()
    with phase("17e autotune --check (smoke shape, then full shape)"):
        autotune_on_card(["--smoke"], "smoke shape", strict=True)
        # the reference's own tune calibrates one rung at this shape, so
        # (b) is reported here, not failed (PERF.md §6)
        autotune_on_card([], "full shape", strict=False)


# --------------------------------------------------------------------------
# phase 18: HI²_sup training on the card
# --------------------------------------------------------------------------

def sup_train_cfg(seed: int, batch_queries: int = 0
                  ) -> train.SupTrainConfig:
    """The paper's BERT slot with the §15 recipe (7 hard + 4 in-batch
    negatives, refine-stage KL at 0.5) over phase 10's L clusters, for
    TRAIN_STEPS steps of ``batch_queries`` (default TRAIN_BATCH)
    queries."""
    return train.SupTrainConfig(
        n_clusters=N_CLUSTERS, encoder_layers=ENC_LAYERS,
        encoder_dim=HIDDEN, encoder_heads=ENC_HEADS, n_steps=TRAIN_STEPS,
        batch_queries=batch_queries or TRAIN_BATCH, n_negatives=7,
        n_inbatch=4, refine_weight=0.5, seed=seed)


def flash_grad_parity(dev, seed: int) -> float:
    """18a: the differentiable ``flash_attention`` (kernel forward,
    recompute backward) against autograd through the plain version on
    the card, on (B, S, H, d) projections viewed (B, H, S, d) as the
    encoder gives them; the loss Σ w·out² makes the gradients depend on
    the forward.  One kernel launch per call; dq, dk, dv within
    TRAIN_TOL."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for name, (b, h, s_len, d, causal, window) in FLASH_GRAD_CASES.items():
        q, k, v, w = (_bshd(gen, dev, b, s_len, h, d, torch.float32)
                      for _ in range(4))
        grads = {}
        for route in ("kernel", "plain"):
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            before = fa_ops.launches
            if route == "kernel":
                out = fa_ops.flash_attention(*inputs, causal, window)[0]
                if fa_ops.launches != before + 1:
                    fail(f"flash_attention {name}: the forward launched "
                         f"{fa_ops.launches - before} kernels, not 1")
            else:
                out = fa_ref.attention(*inputs, causal=causal, window=window)
            (w * out * out).sum().backward()
            if fa_ops.launches != before + (route == "kernel"):
                fail(f"flash_attention {name}: the backward launched a "
                     "kernel")
            grads[route] = [t.grad for t in inputs]
        for n, g, p in zip("qkv", grads["kernel"], grads["plain"]):
            err = float((g - p).abs().max())
            worst = max(worst, err)
            if not torch.allclose(g, p, rtol=TRAIN_TOL, atol=TRAIN_TOL):
                fail(f"flash_attention {name}: d{n} differs from autograd "
                     f"through the plain version (max abs err {err:.3g}, "
                     f"tol {TRAIN_TOL})")
    log(f"[train] 18a flash_attention gradients at {len(FLASH_GRAD_CASES)} "
        f"shapes {list(FLASH_GRAD_CASES)}: dq, dk, dv max abs err "
        f"{worst:.3g} against autograd through the plain version (rtol = "
        f"atol = {TRAIN_TOL})")
    return worst


def _train_params(dev, seed: int, built: dict, enc_cfg):
    """Phase 10's cluster embeddings with a term scorer drawn from
    ``seed`` on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return distill.DistillParams(
        cluster_embeddings=built["cluster_sel"].embeddings.clone(),
        term_mlp=ts_mod.init_mlp(gen, HIDDEN),
        encoder=tfm.init(gen, enc_cfg))


def step_vs_cpu(dev, seed: int, built: dict, pool: np.ndarray) -> None:
    """18b: the loss, its aux terms and every gradient leaf of one
    TRAIN_CHECK_B-query batch on the card against the CPU plain path from
    the same parameters and batch."""
    cfg = sup_train_cfg(seed, batch_queries=TRAIN_CHECK_B)
    enc_cfg = train.encoder_config(cfg, VOCAB)
    params = _train_params(dev, seed, built, enc_cfg)
    batch = train.sup_batches(built["corpus"], cfg, pool,
                              built["doc_assign"])(0)
    loss = train.sup_loss(enc_cfg, VOCAB, cfg.refine_weight)
    before = fa_ops.launches
    t0 = time.perf_counter()
    (value, aux), grads = optim.value_and_grad(
        loss, params, tree_mod.to(batch, dev), has_aux=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if fa_ops.launches - before != 2 * ENC_LAYERS:
        fail(f"one step launched flash_attention "
             f"{fa_ops.launches - before} times, expected {2 * ENC_LAYERS}")
    t0 = time.perf_counter()
    (c_value, c_aux), c_grads = optim.value_and_grad(
        loss, params.to("cpu"), batch, has_aux=True)
    cpu_s = time.perf_counter() - t0
    worst, rel = {}, 0.0
    for k in aux:
        err = abs(float(aux[k]) - float(c_aux[k]))
        if err > TRAIN_TOL * (1 + abs(float(c_aux[k]))):
            fail(f"18b {k}: card {float(aux[k])!r} vs CPU "
                 f"{float(c_aux[k])!r}")
        worst[k] = err
    for (path, g), c in zip(hi.index_leaves(grads),
                            tree_mod.leaves(c_grads)):
        g = g.cpu()
        err = float((g - c).abs().max())
        rel = max(rel, err / max(float(c.abs().max()), 1e-30))
        if not torch.allclose(g, c, rtol=TRAIN_TOL, atol=TRAIN_TOL):
            fail(f"18b gradient {path}: card vs CPU max abs err {err:.3g} "
                 f"(tol {TRAIN_TOL})")
        worst[path] = err
    log(f"[train] 18b one step at B {TRAIN_CHECK_B} x D "
        f"{batch.doc_tokens.shape[1]} (d {HIDDEN}, V {VOCAB}, L "
        f"{N_CLUSTERS}): loss {float(value):.6f} (CPU "
        f"{float(c_value):.6f}), aux "
        f"{ {k: round(float(v), 6) for k, v in aux.items()} }; "
        f"{len(worst) - len(aux)} gradient leaves within rtol = atol = "
        f"{TRAIN_TOL} of the CPU (max abs err "
        f"{max(v for k, v in worst.items() if k not in aux):.3g}, max "
        f"relative to the leaf's largest {rel:.3g}); card {card_s:.2f} s "
        f"(first call), CPU {cpu_s:.2f} s")


def train_on_card(dev, seed: int, built: dict, mine_index) -> dict:
    """18c: ``train_hi2_sup`` at the paper's BERT slot on phase 10's
    corpus, negatives mined from phase 10's ``opq`` index united with the
    topic pool, as one counted run; steps/s, tokens/s, and one profiled
    step.  Returns what 18d reuses and the run's launches."""
    corpus = built["corpus"]
    cfg = sup_train_cfg(seed)
    reset_counts()
    t0 = time.perf_counter()
    topic = synthetic.hard_negatives(corpus, cfg.n_negatives, seed=seed)
    mined = distill.mine_hard_negatives(mine_index, corpus.query_emb,
                                        corpus.query_tokens, corpus.qrels,
                                        cfg.n_negatives)
    pool = np.concatenate([topic, mined], axis=1)
    mine_s = time.perf_counter() - t0
    monitor = StragglerMonitor(window=cfg.n_steps)
    t0 = time.perf_counter()
    params, enc_cfg, assign, losses = train.train_hi2_sup(
        corpus, cfg, log_every=10, negatives=pool, monitor=monitor,
        device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    steps = list(monitor.durations)
    tokens = cfg.batch_queries * (corpus.query_tokens.shape[1] + (
        1 + cfg.n_negatives + cfg.n_inbatch) * corpus.doc_tokens.shape[1])
    steady = float(np.mean(steps[1:]))
    log(f"[train] 18c train_hi2_sup: {cfg.n_steps} steps of {tokens} "
        f"tokens (B {cfg.batch_queries} x D "
        f"{1 + cfg.n_negatives + cfg.n_inbatch}); mining + topic pool "
        f"{mine_s:.2f} s; train_hi2_sup {total_s:.2f} s of which steps "
        f"{sum(steps):.2f} s (KMeans and init the rest); step 1 "
        f"{steps[0] * 1e3:.1f} ms, steps 2-{cfg.n_steps} mean "
        f"{steady * 1e3:.2f} ms, median "
        f"{float(np.median(steps[1:])) * 1e3:.2f} ms, max "
        f"{max(steps[1:]) * 1e3:.2f} ms: {1 / steady:.2f} steps/s, "
        f"{tokens / steady:.0f} tokens/s; launches {launches}")
    want = {"flash_attention": 2 * ENC_LAYERS * cfg.n_steps}
    if launches["flash_attention"] != want["flash_attention"]:
        fail(f"18c launched flash_attention {launches['flash_attention']} "
             f"times, expected {want['flash_attention']}")
    missing = [k for k in ("assign_argmax", "topk_scores", "pq_adc_fused")
               if launches[k] < 1]
    if missing:
        fail(f"18c never launched {missing}")
    traj = sup_distill.trajectory(losses)
    log(f"[train] 18c loss trajectory: {json.dumps(traj)}")
    if (traj["loss_last"] >= traj["loss_first"]
            or traj["frac_improving_windows"] < sup_distill.MONOTONE_FRAC):
        fail(f"18c loss did not fall (contract (b)): {traj}")
    loss_fn = train.sup_loss(enc_cfg, VOCAB, cfg.refine_weight)
    batches = train.sup_batches(corpus, cfg, pool, assign)
    state = optim.adam_init(params)
    batch = tree_mod.to(batches(cfg.n_steps), dev)
    adam = optim.AdamConfig(lr=cfg.lr)
    profile_call(lambda: train.train_step(loss_fn, params, state, batch,
                                          1.0, adam, 1.0),
                 f"one training step (train.train_step, B "
                 f"{cfg.batch_queries})", top=15)
    return dict(params=params, loss_fn=loss_fn, batches=batches, cfg=cfg,
                launches=launches)


def _equal_trees(a, b) -> list:
    return [p for (p, x), y in zip(hi.index_leaves(a), tree_mod.leaves(b))
            if not torch.equal(x, y)]


def train_repeatability(dev, trained: dict) -> None:
    """18d: two REPEAT_STEPS-step ``fit`` runs from 18c's parameters are
    equal bit for bit, and a run saved at step RESUME_AT and resumed
    equals the straight run bit for bit."""
    cfg = trained["cfg"]

    def run(n, **kw):
        return train.fit(trained["loss_fn"], trained["params"],
                         trained["batches"], n,
                         adam=optim.AdamConfig(lr=cfg.lr),
                         schedule=optim.warmup_cosine(cfg.warmup_steps,
                                                      REPEAT_STEPS),
                         log_every=0, device=dev, **kw)

    t0 = time.perf_counter()
    first, l_first = run(REPEAT_STEPS)
    second, l_second = run(REPEAT_STEPS)
    diff = _equal_trees(first, second)
    if diff or l_first != l_second:
        fail(f"18d two {REPEAT_STEPS}-step runs differ: leaves {diff[:5]}, "
             f"losses {l_first} vs {l_second}")
    del second
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        run(RESUME_AT, ckpt_dir=str(TRAIN_CKPT), save_every=RESUME_AT)
        resumed, l_resumed = run(REPEAT_STEPS, ckpt_dir=str(TRAIN_CKPT),
                                 save_every=RESUME_AT)
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    diff = _equal_trees(first, resumed)
    if diff or l_resumed != l_first[RESUME_AT:]:
        fail(f"18d resumed at {RESUME_AT} differs from the straight run: "
             f"leaves {diff[:5]}, losses {l_resumed} vs "
             f"{l_first[RESUME_AT:]}")
    log(f"[train] 18d two {REPEAT_STEPS}-step runs equal bit for bit "
        f"(losses {l_first}); saved at step {RESUME_AT} and resumed: equal "
        f"to the straight run, {len(tree_mod.leaves(first))} leaves "
        f"({time.perf_counter() - t0:.1f} s with the checkpoint's writes)")


def sup_distill_on_card(argv: list, what: str) -> None:
    """18e: the port's ``sup_distill.py --check`` on the card, as a
    counted run."""
    reset_counts()
    report = sup_distill.run(sup_distill.parse_args(
        argv + ["--check", "--device", "cuda"]))
    torch.cuda.synchronize()
    launches = read_counts()
    log(json.dumps(report, sort_keys=True))
    failures = sup_distill.check(report)
    log(f"[train] 18e sup_distill {what}: launches {launches}; sup wins "
        f"{report['sup_wins']}/{report['n_operating_points']}; trajectory "
        f"{report['trajectory']['window_means']}; contracts "
        f"{failures or 'met'}")
    if failures:
        fail(f"sup_distill {what} --check: {failures}")
    missing = [k for k in ("flash_attention", "assign_argmax", "topk_scores",
                           "pq_adc_fused") if launches[k] < 1]
    if missing:
        fail(f"sup_distill {what} never launched {missing}")


def training_phase(dev, seed: int, built: dict, mine_index) -> dict:
    """Phase 18; returns 18c's counted launches."""
    with phase("18a flash_attention gradients"):
        flash_grad_parity(dev, seed + 5)
    with phase("18b one step against the CPU"):
        topic = synthetic.hard_negatives(built["corpus"], 7, seed=seed)
        step_vs_cpu(dev, seed, built, topic)
    with phase("18c train_hi2_sup (counted)"):
        trained = train_on_card(dev, seed, built, mine_index)
    with phase("18d repeatability"):
        train_repeatability(dev, trained)
    launches = trained.pop("launches")
    del trained
    torch.cuda.empty_cache()
    with phase("18e sup_distill --check (smoke shape, then full shape)"):
        sup_distill_on_card(["--smoke"], "smoke shape")
        sup_distill_on_card([], "full shape")
    return launches


# --------------------------------------------------------------------------
# phase 19: the paper benchmarks
# --------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_searches():
    """Within the block, every ``hi.search`` result (``search_ivf`` and
    ``search_term_only`` go through it), in call order."""
    log, orig = [], hi.search

    def search(*a, **k):
        out = orig(*a, **k)
        log.append(out)
        return out

    hi.search = search
    try:
        yield log
    finally:
        hi.search = orig


def rows_vs_cpu(what: str, on_card, on_cpu) -> tuple:
    """Run the same rows over indexes on the card (``on_card()``) and
    their ``.to("cpu")`` copies (``on_cpu()``) and pair their searches:
    ``n_candidates`` equal, top-R ids equal up to swaps within PAPER_TOL.
    Returns (card rows, CPU rows, the near-tie queries of each search)."""
    with recorded_searches() as card_log:
        card_rows = on_card()
    torch.cuda.synchronize()
    with recorded_searches() as cpu_log:
        cpu_rows = on_cpu()
    if len(card_log) != len(cpu_log):
        fail(f"{what}: {len(card_log)} searches on the card, "
             f"{len(cpu_log)} on the CPU")
    ties = []
    for i, (a, b) in enumerate(zip(card_log, cpu_log)):
        if not torch.equal(a.n_candidates.cpu(), b.n_candidates):
            fail(f"{what}: search {i}: n_candidates differ from the CPU")
        ai, as_ = a.doc_ids.cpu().numpy(), a.scores.cpu().numpy()
        bi, bs = b.doc_ids.numpy(), b.scores.numpy()
        n = 0
        for q in np.flatnonzero((ai != bi).any(axis=1)):
            if not topk_match(bi[q], bs[q], ai[q], as_[q], PAPER_TOL):
                fail(f"{what}: search {i}, query {q}: top-R ids differ from "
                     f"the CPU beyond swaps within {PAPER_TOL}")
            n += 1
        ties.append(n)
    return card_rows, cpu_rows, ties


def check_metric(what: str, card: float, cpu: float, ties: int,
                 n_queries: int) -> None:
    if abs(card - cpu) > ties / n_queries + PAPER_FLOAT:
        fail(f"{what}: {card} on the card, {cpu} on the CPU ({ties} "
             f"near-tie queries of {n_queries})")


def table3_vs_cpu(what: str, corpus, indexes: dict, kc: int, k2: int,
                  top_r: int, dev) -> list:
    """Table 3's rows on the card and over the same indexes on the CPU
    (the plain path): every field equal but the metrics, each within its
    near-tie queries.  Returns the card's rows."""
    cpu_indexes = {spec: idx.to("cpu") for spec, idx in indexes.items()}
    card, cpu, ties = rows_vs_cpu(
        what,
        lambda: table3_codec.rows(corpus, indexes, kc=kc, k2=k2,
                                  top_r=top_r, device=dev),
        lambda: table3_codec.rows(corpus, cpu_indexes, kc=kc, k2=k2,
                                  top_r=top_r, device="cpu"))
    n_q = corpus.query_emb.shape[0]
    for a, b, n in zip(card, cpu, ties):
        for key, val in a.items():
            if key in PAPER_METRICS:
                check_metric(f"{what} {a['codec']} {key}", val, b[key], n,
                             n_q)
            elif val != b[key]:
                fail(f"{what} {a['codec']}: {key} {val} on the card, "
                     f"{b[key]} on the CPU")
    log(f"[paper] {what}: every row against the CPU plain path; near-tie "
        f"queries per codec {dict(zip(indexes, ties))}")
    return card


def fig4_vs_cpu(what: str, idx, dev, queries=None, qrels=None) -> dict:
    """Figure 4's curves on the card and over ``idx.to("cpu")``: the
    mean candidates equal, R@100 within its near-tie queries."""
    cpu_idx = idx.to("cpu")
    card, cpu, ties = rows_vs_cpu(
        what, lambda: fig4_ablation.rows(idx, dev, queries, qrels),
        lambda: fig4_ablation.rows(cpu_idx, "cpu", queries, qrels))
    n_q = (paper.N_QUERIES if queries is None else queries[0].shape[0])
    points = [(name, a, b) for name in card
              for a, b in zip(card[name], cpu[name])]
    for (name, a, b), n in zip(points, ties):
        if a[0] != b[0]:
            fail(f"{what} {name}: candidates {a[0]} on the card, {b[0]} on "
                 f"the CPU")
        check_metric(f"{what} {name} R@100", a[1], b[1], n, n_q)
    log(f"[paper] {what}: every point against the CPU plain path; near-tie "
        f"queries {ties}")
    return card


def log_curves(what: str, curves: dict) -> None:
    log(json.dumps({"paper": what, "curves": curves}))


def paper_scripts(dev) -> None:
    """19a: every ported paper script and example at its reference size
    on the card (the reference's seed-0 corpora), each ``--check``."""
    with phase("19a table3_codec (5 codecs)"):
        corpus, kw = table3_codec.setting(smoke=False)
        indexes = table3_codec.build(corpus, specs=codecs.registered(),
                                     device=dev, **kw)
        rows = table3_vs_cpu("19a table3_codec", corpus, indexes,
                             paper.KC, paper.K2, paper.TOP_R, dev)
        report = table3_codec.report(rows, smoke=False)
        log(json.dumps(report))
        contract = report["refine_contract"]
        if contract["status"] != "checked" or contract["failures"]:
            fail(f"table3_codec --check: {contract}")
        del indexes
    with phase("19a table2_robustness"):
        log(json.dumps({"paper": "table2", "rows":
                        table2_robustness.run(dev)}))
    with phase("19a fig4_ablation"):
        log_curves("fig4", fig4_vs_cpu("19a fig4_ablation",
                                       paper.unsup_index(dev), dev))
    with phase(f"19a fig3_tradeoff (HI²_sup: {paper.SUP_STEPS} steps)"):
        log_curves("fig3", fig3_tradeoff.run(dev))
    with phase("19a table1_main"):
        log(json.dumps({"paper": "table1", "rows": table1_main.run(dev)}))
    for name, mod in (("hybrid_fusion", hybrid_fusion),
                      ("filtered_search", filtered_search)):
        with phase(f"19a {name} --check"):
            report = mod.run(mod.parse_args(["--check", "--device",
                                             str(dev)]))
            log(json.dumps(report, sort_keys=True))
            if report["check_failures"]:
                fail(f"{name} --check: {report['check_failures']}")
    for mod in (quickstart, serve_retrieval, train_hi2_distill):
        name = mod.__name__.rsplit(".", 1)[-1]
        with phase(f"19a example {name}"):
            mod.main(["--device", str(dev)])
            sys.stdout.flush()


def paper_full_width(dev, seed: int, built: dict, opq_index) -> None:
    """19b: Table 3's rows over phase 10's corpus and KMeans at full
    width, every registered codec (phase 10's ``opq`` and ``flat``
    indexes, the others built over the same lists), and Figure 4's
    curves over the ``opq`` index; the §7 refine contract's status is
    printed, not failed."""
    corpus = built["corpus"]
    indexes = {}
    with phase("19b builds (pq, refine, sq8 over phase 10's KMeans)"):
        for spec in codecs.registered():
            if spec == "opq":
                indexes[spec] = opq_index
            elif spec == "flat":
                indexes[spec] = built["flat_index"]
            else:
                indexes[spec] = hi.build(
                    seed, built["emb"], built["tokens"], VOCAB,
                    n_clusters=N_CLUSTERS, k1_terms=K1_TERMS, codec=spec,
                    pq_m=PQ_M, pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
                    term_capacity=TERM_CAP, cluster_sel=built["cluster_sel"],
                    doc_assign=built["doc_assign"], device=dev)
    with phase("19b table3_codec rows at full width"):
        rows = table3_codec.rows(corpus, indexes, kc=KC, k2=K2, top_r=TOP_R,
                                 device=dev)
        report = table3_codec.report(rows, smoke=False)
        log(json.dumps(report))
        c = report["refine_contract"]
        by = {r["resolved"].split(":")[0] if r["resolved"].startswith(
            "refine") else r["resolved"]: r for r in rows}
        log(f"[paper] 19b the DESIGN.md §7 refine contract at N "
            f"{BUILD_DOCS}, h {HIDDEN}: {c['status']}, "
            f"{c['failures'] or 'met'}; R@100 flat {by['flat']['R@100']:.4f}"
            f", refine {by['refine']['R@100']:.4f} (slack "
            f"{table3_codec.RECALL_SLACK}); cost refine "
            f"{by['refine']['candidate_cost']} / pq "
            f"{by['pq']['candidate_cost']} (ratio "
            f"{table3_codec.COST_RATIO}); reported, not failed")
    del indexes
    torch.cuda.empty_cache()
    with phase("19b fig4_ablation over phase 10's opq index"):
        curves = fig4_ablation.rows(
            opq_index, dev, (corpus.query_emb, corpus.query_tokens),
            corpus.qrels)
        log_curves("fig4 full width", curves)


def paper_phase(dev, seed: int, built: dict, opq_index) -> dict:
    """Phase 19; returns its launches (19a and 19b, counted runs; the
    CPU comparisons launch nothing)."""
    reset_counts()
    paper_scripts(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[paper] 19a launches {launches}")
    missing = [k for k in PAPER_KERNELS if launches[k] < 1]
    if missing:
        fail(f"phase 19a never launched {missing}")
    reset_counts()
    paper_full_width(dev, seed, built, opq_index)
    torch.cuda.synchronize()
    full = read_counts()
    log(f"[paper] 19b launches {full}")
    return {k: launches[k] + full[k] for k in launches}


# --------------------------------------------------------------------------
# phase 20: document-sharded and 2-D mesh serving, positions on one card
# --------------------------------------------------------------------------

def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def serve_equal(server, qe_all, qt_all, want: list, what: str, kernels,
                namespaces=None) -> dict:
    """A counted run: ``server`` answers ``len(want)`` batches of BATCH
    queries, each bitwise equal (ids, scores, n_candidates) to ``want``'s
    result; every kernel in ``kernels`` must launch at least once per
    batch and mesh position.  Prints batch ms and q/s; returns the
    launches."""
    server.warmup(qe_all.shape[1], qt_all.shape[1])
    reset_counts()
    batch_s = []
    for i, ref in enumerate(want):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t0 = time.perf_counter()
        res = server.query(qe_all[sl], qt_all[sl], namespaces=namespaces)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        for name in ("doc_ids", "scores", "n_candidates"):
            if not torch.equal(getattr(res, name), getattr(ref, name)):
                fail(f"{what}: batch {i} {name} differ from Server's")
        if res.partial:
            fail(f"{what}: a full mesh answered partial")
    launches = read_counts()
    positions = getattr(getattr(server, "mesh", None), "size", 1)
    short = [k for k in kernels if launches[k] < positions * len(want)]
    log(f"[mesh] {what}: {len(want)} x {BATCH} queries bitwise equal to "
        f"Server; {len(want) * BATCH / sum(batch_s):.1f} q/s; batch ms "
        f"{[round(x * 1e3, 2) for x in batch_s]}; launches {launches}")
    if short:
        fail(f"{what}: {short} launched fewer than once a batch on each "
             f"of {positions} positions")
    return launches


def sharded_phase(index, dev, qe_all, qt_all, want: list, kernels,
                  what: str, shards=SHARDS, fused=None) -> dict:
    """20a/20b: ``Server`` (S = 1, timed the same way) and
    ``ShardedServer`` at each S in ``shards`` with every position on
    ``dev``, each bitwise equal to ``want`` (the single-device results);
    ``fused`` (the fused single-device results) also serves the largest
    S at FUSION_WEIGHT; one batch at the largest S is profiled.  Returns
    the launches of the sharded runs."""
    cfg = dict(kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH)
    launches: dict = {}
    serve_equal(serve.Server(index, serve.ServeConfig(**cfg), device=dev),
                qe_all, qt_all, want, f"{what} S=1", kernels)
    for n in shards:
        t0 = time.perf_counter()
        server = serve.ShardedServer(index, serve.ServeConfig(
            n_shards=n, **cfg), devices=[dev] * n)
        torch.cuda.synchronize()
        log(f"[mesh] {what} S={n}: partition on the host and placement "
            f"{time.perf_counter() - t0:.1f} s; plane bytes per position "
            f"{[shi.plane_bytes(server.index, s) for s in range(n)]} "
            f"(single device "
            f"{sum(x.nbytes for _, x in hi.index_leaves(index))} in all)")
        _add(launches, serve_equal(server, qe_all, qt_all, want,
                                   f"{what} S={n}", kernels))
        if n == max(shards):
            profile_call(lambda: server.query(qe_all[:BATCH],
                                              qt_all[:BATCH]),
                         f"{what} S={n} (device time summed over the "
                         "positions' streams, which overlap)")
        if fused is not None and n == max(shards):
            server.set_fusion(FUSION_WEIGHT)
            _add(launches, serve_equal(
                server, qe_all, qt_all, fused,
                f"{what} S={n} fused at {FUSION_WEIGHT}", kernels))
        server.mesh.close()
        del server
        torch.cuda.empty_cache()
    return launches


def mesh_drill(server, mut_of, qe, qt, full, what: str) -> None:
    """20c's shard-loss drill (DESIGN.md §12) without the runtime:
    checkpoint, eject shard 0 (results ``partial``, nothing from its
    range, ids and scores equal to a ``MutableServer`` over the same
    index with that range tombstoned: ``mut_of(lo, hi)``), refuse the
    last shard, rejoin bitwise equal to ``full``."""
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = server.checkpoint(str(MESH_CKPT))
        log(f"[mesh] {what}: checkpoint {time.perf_counter() - t0:.1f} s")
        server.eject_shard(0)
        [(lo, hi_)] = server.lost_doc_ranges()
        deg = server.query(qe, qt)
        ids = deg.doc_ids.cpu().numpy()
        if not (deg.partial and server.partial and server.epoch == 1):
            fail(f"{what}: ejected mesh not partial / epoch {server.epoch}")
        if ((ids >= lo) & (ids < hi_)).any():
            fail(f"{what}: a result came from the lost range [{lo}, {hi_})")
        oracle = mut_of(lo, hi_).query(qe, qt)
        if not (torch.equal(oracle.doc_ids, deg.doc_ids)
                and torch.equal(oracle.scores, deg.scores)):
            fail(f"{what}: degraded results differ from the tombstoned "
                 "MutableServer oracle")
        try:
            server.eject_shard(1)
        except ValueError:
            pass
        else:
            fail(f"{what}: ejecting the last healthy shard was accepted")
        t0 = time.perf_counter()
        server.rejoin(path)
        back = server.query(qe, qt)
        torch.cuda.synchronize()
        for name in ("doc_ids", "scores", "n_candidates"):
            if not torch.equal(getattr(back, name), getattr(full, name)):
                fail(f"{what}: after rejoin {name} differ from before")
        log(f"[mesh] {what}: ejected shard 0 = docs [{lo}, {hi_}): partial, "
            f"none from the range, equal to the tombstoned oracle (n_cand "
            f"equal: {torch.equal(oracle.n_candidates, deg.n_candidates)});"
            f" last shard refused; rejoin {time.perf_counter() - t0:.1f} s, "
            f"bitwise equal to before, epoch {server.epoch}")
    finally:
        shutil.rmtree(MESH_CKPT, ignore_errors=True)


def mesh_phase(dev, seed: int, built: dict, opq_index) -> dict:
    """20c and 20d; returns their launches."""
    corpus = built["corpus"]
    ns = (np.arange(BUILD_DOCS) % MESH_NS).astype(np.int32)
    index = dataclasses.replace(opq_index,
                                doc_ns=torch.from_numpy(ns).to(dev))
    qe, qt = corpus.query_emb, corpus.query_tokens
    allowed = [(i % MESH_NS, (i + 3) % MESH_NS) for i in range(BATCH)]
    cfg = dict(kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
               n_namespaces=MESH_NS)
    kernels = ("pq_adc_fused", "topk_scores")
    base = serve.Server(index, serve.ServeConfig(**cfg), device=dev)
    n_b = BUILD_QUERIES // BATCH
    sl = [slice(i * BATCH, (i + 1) * BATCH) for i in range(n_b)]
    dense = [base.query(qe[s], qt[s]) for s in sl]
    filtered = [base.query(qe[s], qt[s], namespaces=allowed) for s in sl]
    launches: dict = {}
    with phase("20c filtered, S = 4"):
        server = serve.ShardedServer(index, serve.ServeConfig(
            n_shards=4, **cfg), devices=[dev] * 4)
        _add(launches, serve_equal(server, qe, qt, filtered,
                                   "20c filtered S=4", kernels,
                                   namespaces=allowed))
        ids = torch.cat([r.doc_ids for r in filtered]).cpu().numpy()
        ok = all(set(ids[i][ids[i] >= 0] % MESH_NS) <= set(allowed[i % BATCH])
                 for i in range(len(ids)))
        if not ok:
            fail("20c: a filtered result left its namespaces")
        server.mesh.close()
        del server
    d, m = MESH_GEOMETRY
    with phase(f"20c MeshServer {MESH_GEOMETRY} and the drill"):
        server = serve.MeshServer(index, serve.ServeConfig(
            n_shards=m, data_parallel=d, **cfg), devices=[dev] * (d * m))
        _add(launches, serve_equal(server, qe, qt, dense,
                                   f"20c MeshServer {MESH_GEOMETRY}",
                                   kernels))
        _add(launches, serve_equal(server, qe, qt, filtered[:1],
                                   f"20c MeshServer {MESH_GEOMETRY} "
                                   "filtered", kernels, namespaces=allowed))

        def mut_of(lo, hi_):
            mut = segments.MutableHybridIndex(
                index, vocab_size=VOCAB, seed=seed,
                build_kwargs=dict(k1_terms=K1_TERMS),
                delta_capacity=BATCH, delta_cluster_capacity=4,
                delta_term_capacity=4, corpus_emb=corpus.doc_emb,
                corpus_tokens=corpus.doc_tokens, corpus_ns=ns)
            mut.delete_docs(np.arange(lo, hi_))
            return serve.MutableServer(mut, serve.ServeConfig(
                mutable=True, **cfg))

        mesh_drill(server, mut_of, qe[sl[0]], qt[sl[0]], dense[0],
                   f"20c MeshServer {MESH_GEOMETRY}")
        server.mesh.close()
        del server, base
        torch.cuda.empty_cache()
    with phase("20d sharded_search --devices 4 (counted)"):
        reset_counts()
        report = sharded_search.run(sharded_search.parse_args(
            ["--devices", "4", "--device", "cuda"]))
        torch.cuda.synchronize()
        bench = read_counts()
        log(json.dumps(report, sort_keys=True))
        log(f"[mesh] 20d launches {bench}")
        if not all(e["doc_ids_identical"] for e in report["sharded"]):
            fail("sharded_search: sharded ids differ from the baseline")
        _add(launches, bench)
    return launches


# --------------------------------------------------------------------------
# phase 21: the runtime over a mesh and sharded mutable serving, every
# position on the one card (one CUDA graph per bucket per mesh)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def counted(total: dict):
    """A counted run: every count set to 0 on entry, read and added to
    ``total`` on exit."""
    reset_counts()
    yield
    torch.cuda.synchronize()
    _add(total, read_counts())


def _rows_equal(got, want, what: str, n: int = None) -> None:
    """Host rows (ids, scores, n_candidates) of ``got`` equal the first
    ``n`` of ``want``'s, bit for bit."""
    for name, g, w in zip(("ids", "scores", "n_candidates"),
                          _host_rows(got), _host_rows(want)):
        if not np.array_equal(g, w[:n]):
            fail(f"{what}: {name} differ")


def mesh_runtime_phase(index, dev, qe_all, qt_all, want: list) -> dict:
    """21a: the runtime over ``ShardedServer`` at S = MESH_RT_SHARDS and a
    MESH_GEOMETRY ``MeshServer`` on phase 3's index, every position on
    ``dev``: warmup as a counted run (one graph per bucket per mesh,
    captured across the positions' streams), every bucket bit for bit
    against the single-device ``Server``'s first batch (``want``), a
    replayed BATCH-query batch against an eager one with its profile,
    then ``qps_serial`` (over MESH_SERIAL requests) against
    ``qps_runtime`` over RT_REQUESTS submissions, every replica
    dispatched.  Returns the warmups' launches."""
    d, m = MESH_GEOMETRY
    cfg = dict(kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH)
    kernels = ("pq_adc_fused", "topk_scores")
    launches: dict = {}
    layouts = (
        (f"ShardedServer S={MESH_RT_SHARDS}", lambda: serve.ShardedServer(
            index, serve.ServeConfig(n_shards=MESH_RT_SHARDS, **cfg),
            devices=[dev] * MESH_RT_SHARDS)),
        (f"MeshServer {MESH_GEOMETRY}", lambda: serve.MeshServer(
            index, serve.ServeConfig(n_shards=m, data_parallel=d, **cfg),
            devices=[dev] * (d * m))))
    for what, make in layouts:
        with phase(f"21a runtime over {what}"):
            server = make()
            server.warmup(HIDDEN, QUERY_LEN)
            with warm_runtime(server, f"21a {what}", kernels,
                              launches) as rt:
                if rt.buckets != runtime.bucket_sizes(
                        BATCH, quantum=server.n_replicas):
                    fail(f"21a {what}: buckets {rt.buckets}")
                for b in rt.buckets:
                    _rows_equal(rt.query(qe_all[:b], qt_all[:b],
                                         timeout=120), want[0],
                                f"21a {what} bucket {b} against Server", b)
                if (rt.bucket_counts != {b: 1 for b in rt.buckets}
                        or rt.serve_traces):
                    fail(f"21a {what}: batches {rt.bucket_counts}, "
                         f"{rt.serve_traces} captures while serving")
                log(f"[mesh-rt] 21a {what}: every bucket "
                    f"{list(rt.buckets)} bit for bit equal to Server's "
                    f"{BATCH}-row batch (ids, scores, n_candidates); no "
                    f"capture while serving")
                replay_vs_eager(rt, server, qe_all, qt_all, f"21a {what}")
            served = runtime_throughput(server, qe_all, qt_all,
                                        n_serial=MESH_SERIAL)
            if not all(served.replica_dispatch.values()):
                fail(f"21a {what}: a replica never dispatched: "
                     f"{served.replica_dispatch}")
            server.mesh.close()
            del rt, served, server
            torch.cuda.empty_cache()
    return launches


def check_owning(smut, ids) -> None:
    """Every added id sits in its owning shard's planes: the shard
    ``owning_shard`` names is (id − N_base) // D, and the codec rows at
    its local slot on each position of that shard equal the host delta
    rows."""
    mut = smut.mut
    local = ids - mut.n_base
    shard = smut.owning_shard(ids)
    if not np.array_equal(shard, local // smut.dper):
        fail("21b: owning_shard disagrees with the slot split")
    smut.sync_device()
    for (s, _), planes in smut._delta.items():
        mine = local[shard == s]
        for k, plane in planes["doc_planes"].items():
            got = plane[torch.from_numpy(mine - s * smut.dper)].cpu()
            if not torch.equal(got, torch.from_numpy(
                    mut._delta_planes[k][mine])):
                fail(f"21b: shard {s}'s {k} rows differ from the host's")
    split = smut.split_delta()
    for s in range(smut.n_shards):
        lo = mut.n_base + s * smut.dper
        for name in ("cluster_entries", "term_entries"):
            e = split[name][s]
            e = e[e != inverted_lists.PAD_DOC]
            if ((e < lo) | (e >= lo + smut.dper)).any():
                fail(f"21b: shard {s}'s {name} hold another shard's ids")


def sharded_mutable_phase(dev, seed: int, corpus, rec: dict) -> dict:
    """21b: phase 15a replayed on the mesh.  A fresh mutable index over
    15a's base and corpus, served by a ``ShardedMutableServer`` at S =
    MESH_RT_SHARDS and one on MESH_GEOMETRY (both over the same host
    index); the same MUT_STREAM documents streamed in at MUT_FILLS and
    the same ids deleted, through a runtime over the MESH_GEOMETRY
    server.  At every state both servers' dense and fused batches equal
    15a's ``MutableServer`` rows bit for bit, every added id lies in its
    owning shard's planes, the runtime's rows equal 15a's and nothing is
    captured; ``compact()`` captures once a bucket and equals 15a's
    compacted index.  Returns the counted runs' launches."""
    qe, qt = corpus.query_emb, corpus.query_tokens
    launches: dict = {}
    mut = segments.MutableHybridIndex(
        rec["base"], vocab_size=VOCAB, seed=seed,
        build_kwargs=rec["build_kwargs"], delta_capacity=MUT_STREAM,
        delta_cluster_capacity=MUT_DELTA_CAP,
        delta_term_capacity=MUT_DELTA_CAP,
        corpus_emb=corpus.doc_emb[:MUT_BASE],
        corpus_tokens=corpus.doc_tokens[:MUT_BASE])
    d, m = MESH_GEOMETRY
    cfg = dict(kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH, mutable=True)
    t0 = time.perf_counter()
    servers = {
        f"S={MESH_RT_SHARDS}": serve.ShardedMutableServer(
            mut, serve.ServeConfig(n_shards=MESH_RT_SHARDS, **cfg),
            devices=[dev] * MESH_RT_SHARDS),
        f"{MESH_GEOMETRY}": serve.ShardedMutableServer(
            mut, serve.ServeConfig(n_shards=m, data_parallel=d, **cfg),
            devices=[dev] * (d * m))}
    torch.cuda.synchronize()
    log(f"[mesh-rt] 21b: two sharded mutable servers over one fresh index "
        f"(base {mut.n_base} docs, {MUT_STREAM} delta slots, D = "
        f"{servers[f'S={MESH_RT_SHARDS}'].mut.dper} at S = "
        f"{MESH_RT_SHARDS}): {time.perf_counter() - t0:.1f} s")
    mesh_server = servers[f"{MESH_GEOMETRY}"]
    n_b = len(rec[(0.0, None)])

    def check_state(state) -> None:
        t0 = time.perf_counter()
        with counted(launches):
            for what, server in servers.items():
                for weight in (None, FUSION_WEIGHT):
                    fusion = (None if weight is None
                              else qexec.FusionSpec(weight))
                    for i, ref in enumerate(rec[(state, weight)]):
                        sl = slice(i * BATCH, (i + 1) * BATCH)
                        res = (server.query(qe[sl], qt[sl])
                               if weight is None else
                               server.mut.search(qe[sl], qt[sl], kc=KC,
                                                 k2=K2, top_r=TOP_R,
                                                 fusion=fusion))
                        _rows_equal(res, ref, f"21b {what} {state} weight "
                                    f"{weight} batch {i} against 15a")
        got = rt.query(qe[:BATCH], qt[:BATCH], timeout=120)
        _rows_equal(got, rec[(state, None)][0],
                    f"21b runtime {MESH_GEOMETRY} {state} against 15a")
        log(f"[mesh-rt] 21b state {state} (epoch {mut.epoch}, "
            f"{mut.delta_count} delta docs, {mut.n_deleted} deleted): "
            f"{len(servers)} servers x {n_b} batches dense and fused at "
            f"{FUSION_WEIGHT} and the runtime's batch bit for bit equal "
            f"to 15a's MutableServer rows ({time.perf_counter() - t0:.1f} "
            f"s)")

    rt = warm_runtime(mesh_server, f"21b sharded mutable {MESH_GEOMETRY}",
                      ("pq_adc_fused", "topk_scores"), launches)
    stream_emb = corpus.doc_emb[MUT_BASE:MUT_BASE + MUT_STREAM]
    stream_tok = corpus.doc_tokens[MUT_BASE:MUT_BASE + MUT_STREAM]
    with rt:
        check_state(0.0)
        before = qexec.trace_count()
        done = 0
        for frac in MUT_FILLS:
            upto = int(frac * MUT_STREAM)
            t0 = time.perf_counter()
            with counted(launches):
                ids = rt.add(stream_emb[done:upto], stream_tok[done:upto])
            log(f"[mesh-rt] 21b runtime add of {upto - done} docs "
                f"{time.perf_counter() - t0:.2f} s")
            for server in servers.values():
                check_owning(server.mut, ids)
            done = upto
            check_state(frac)
        rt.delete(rec["doomed"])
        check_state("deleted")
        if qexec.trace_count() != before:
            fail("21b: add/delete through the runtime captured a graph")
        t0 = time.perf_counter()
        with counted(launches):
            rt.compact()
        compact_s = time.perf_counter() - t0
        captures = qexec.trace_count() - before
        if captures != len(rt.buckets) or not all(rt.captured.values()):
            fail(f"21b: compact() made {captures} captures for "
                 f"{len(rt.buckets)} buckets ({rt.captured})")
        _rows_equal(rt.query(qe[:BATCH], qt[:BATCH], timeout=120),
                    rec["compacted"], "21b runtime after compact() against "
                    "15a's compacted index")
    log(f"[mesh-rt] 21b: add/delete through the runtime with no capture; "
        f"compact() {compact_s:.1f} s with {captures} captures (one a "
        f"bucket), then bit for bit equal to 15a's compacted index; "
        f"requests by replica {rt.replica_dispatch}; launches {launches}")
    for server in servers.values():
        server.mesh.close()
    del rt, servers, mesh_server, mut
    torch.cuda.empty_cache()
    return launches


def mesh_benches_phase() -> dict:
    """21c: ``mesh_serving.py`` at its reference size with ``--check``
    semantics (the emulated (2, 1) gate printed, not failed: it assumes
    one emulating processor) and every geometry captured, then
    ``serving_load.py``'s four layouts with every contract; one counted
    run.  Returns its launches."""
    launches: dict = {}
    with counted(launches):
        report = mesh_serving.run(mesh_serving.parse_args(
            ["--device", "cuda"]))
    log(json.dumps(report, sort_keys=True))
    fails = mesh_serving.check_serving(report)
    log(f"[mesh-rt] 21c mesh_serving: result contracts "
        f"{fails or 'met'}; speedup_emulated_2x1 "
        f"{report['speedup_emulated_2x1']} "
        f"({mesh_serving.check_scaling(report) or 'the 1.6x gate met'})")
    if fails:
        fail(f"mesh_serving --check: {fails}")
    uncaptured = [g for g, r in report["geometries"].items()
                  if not r["captured"]]
    if uncaptured:
        fail(f"mesh_serving: geometries {uncaptured} not captured")
    with counted(launches):
        report = serving_load.run(serving_load.parse_args(
            ["--device", "cuda"]))
    log(json.dumps(report, sort_keys=True))
    fails = [f for rep in report["layouts"].values()
             for f in serving_load.check_layout(rep)]
    rates = {n: (r["qps_serial"], r["qps_runtime"])
             for n, r in report["layouts"].items()}
    log(f"[mesh-rt] 21c serving_load: {rates} (qps_serial, qps_runtime); "
        f"contracts {fails or 'met'}")
    if fails:
        fail(f"serving_load --check: {fails}")
    log(f"[mesh-rt] 21c launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 22: build and training over a mesh
# --------------------------------------------------------------------------

def check_step(what: str, x, c, a_got, a_want, got: tuple, want: tuple
               ) -> tuple[int, float]:
    """One Lloyd step's (sums, counts) ``got`` against ``want``: the
    assignments ``a_got`` / ``a_want`` equal except near-ties (the two
    ids' scores ⟨x, c⟩ − ½‖c‖² in float64 within ASSIGN_TOL); ``want``
    moved by the rows that went to the other twin; then counts exactly
    equal and sums within rtol = atol = ASSIGN_TOL.  Returns (near-tie
    rows, max abs sums error)."""
    sums, counts = (t.double() for t in got)
    w_sums, w_counts = (t.double() for t in want)
    diff = (a_got != a_want).nonzero()[:, 0]
    if len(diff):
        xd, cd = x[diff].double(), c.double()
        ig, iw = a_got[diff].long(), a_want[diff].long()

        def score(ids):
            cj = cd[ids]
            return (xd * cj).sum(-1) - 0.5 * (cj * cj).sum(-1)

        sg, sw = score(ig), score(iw)
        if ((sg - sw).abs() > ASSIGN_TOL * (1 + sw.abs())).any():
            fail(f"{what}: assignments differ beyond near-ties")
        one = torch.ones(len(diff), dtype=torch.float64, device=x.device)
        w_counts = w_counts.index_add(0, ig, one).index_add(0, iw, -one)
        w_sums = w_sums.index_add(0, ig, xd).index_add(0, iw, -xd)
    if not torch.equal(counts, w_counts):
        fail(f"{what}: counts differ ({int((counts != w_counts).sum())} "
             f"clusters)")
    err = float((sums - w_sums).abs().max())
    if not torch.allclose(sums, w_sums, rtol=ASSIGN_TOL, atol=ASSIGN_TOL):
        fail(f"{what}: sums differ beyond rtol = atol = {ASSIGN_TOL} (max "
             f"abs err {err:.3g})")
    return len(diff), err


def sharded_step_on(mesh, parts: dict, c, axis: str) -> tuple:
    """One sharded Lloyd step from ``c`` on every position: (the
    positions' assignments in rank order, concatenated; the psummed
    (sums, counts), the same bits on every position)."""
    def body(coord):
        xl, cl = parts[coord], c.to(parts[coord].device)
        return (kmeans.assign_blocked(xl, cl),
                kmeans.sharded_step(xl, cl, N_CLUSTERS, axis,
                                    pos=mesh.position(coord)))

    outs = mesh.run(body)
    stats = [o[1] for o in outs.values()]
    if any(not (torch.equal(s[0], stats[0][0])
                and torch.equal(s[1], stats[0][1])) for s in stats):
        fail("a sharded step's statistics differ between positions")
    order = sorted(outs, key=lambda k: mesh.rank(axis, k))
    return torch.cat([outs[k][0] for k in order]), stats[0]


def sharded_kmeans(dev, seed: int, built: dict) -> int:
    """22a: ``kmeans_fit_sharded`` over phase 10's corpus split in
    KM_SHARDS row blocks (views) on positions of the one card, as a
    counted run (one ``assign_argmax`` a position a step): positions
    bitwise equal, the cost below the random init's and within
    KM_COST_GAP of single-device ``kmeans_fit`` (timed beside it); one
    step from shared centroids against the single-device step, and on a
    KM_CHECK_POINTS-point subsample against the CPU's sharded step.
    Returns the counted launches."""
    emb = built["emb"]
    mesh = shi.make_shard_mesh(KM_SHARDS, devices=[dev] * KM_SHARDS)
    axis = mesh.axis_names[0]
    parts = collectives.Split(mesh, axis).place(emb)
    if any(p.data_ptr() != emb[mesh.rank(axis, k) * p.shape[0]:].data_ptr()
           for k, p in parts.items()):
        fail("22a: the shards are not views of the corpus")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = mesh.run(lambda coord: kmeans.kmeans_fit_sharded(
        seed, parts[coord], N_CLUSTERS, BUILD_ITERS, axis,
        pos=mesh.position(coord)))
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    launches = read_counts()["assign_argmax"]
    if launches != KM_SHARDS * BUILD_ITERS:
        fail(f"22a launched assign_argmax {launches} times, expected "
             f"{KM_SHARDS * BUILD_ITERS} (one a position a step)")
    cs = outs[(0,)]
    if any(not torch.equal(o, cs) for o in outs.values()):
        fail("22a: the positions' centroids differ")
    t0 = time.perf_counter()
    c1, a1 = kmeans.kmeans_fit(torch.Generator(device=dev).manual_seed(seed),
                               emb, N_CLUSTERS, BUILD_ITERS)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    cost_s = float(kmeans.kmeans_cost(emb, cs,
                                      kmeans.assign_blocked(emb, cs)))
    cost_1 = float(kmeans.kmeans_cost(emb, c1, a1))
    c0 = emb[:N_CLUSTERS]
    cost_0 = float(kmeans.kmeans_cost(emb, c0, kmeans.assign_blocked(emb, c0)))
    log(f"[mesh-build] 22a kmeans_fit_sharded N {BUILD_DOCS} x h {HIDDEN}, "
        f"L {N_CLUSTERS}, {BUILD_ITERS} steps on {KM_SHARDS} positions of "
        f"the card ({BUILD_DOCS // KM_SHARDS} rows each): {sharded_s:.2f} s "
        f"against single-device kmeans_fit {single_s:.2f} s; cost "
        f"{cost_s:.6f} (single-device {cost_1:.6f}, random init "
        f"{cost_0:.6f}); {launches} assign_argmax launches; positions "
        f"bitwise equal")
    if not cost_s < cost_0:
        fail(f"22a: cost {cost_s} not below the random init's {cost_0}")
    if abs(cost_s - cost_1) > KM_COST_GAP * cost_1:
        fail(f"22a: cost {cost_s} not within {KM_COST_GAP} of "
             f"single-device {cost_1}")
    # one step from shared centroids: sharded against single-device
    a_sh, got = sharded_step_on(mesh, parts, c1, axis)
    a_one = kmeans.assign_blocked(emb, c1)
    near, err = check_step("22a step vs single device", emb, c1, a_sh,
                           a_one, got, kmeans._update(emb, a_one,
                                                      N_CLUSTERS))
    log(f"[mesh-build] 22a one step from shared centroids: counts equal to "
        f"the single-device step's, sums max abs err {err:.3g} (rtol = "
        f"atol = {ASSIGN_TOL}), {near} near-tie rows")
    # the card's sharded step against the CPU's on a subsample
    sub = emb[:KM_CHECK_POINTS]
    sub_parts = collectives.Split(mesh, axis).place(sub)
    a_card, got = sharded_step_on(mesh, sub_parts, c1, axis)
    cpu_mesh = collectives.Mesh(["cpu"] * KM_SHARDS, (axis,))
    t0 = time.perf_counter()
    try:
        a_cpu, want = sharded_step_on(
            cpu_mesh, collectives.Split(cpu_mesh, axis).place(sub.cpu()),
            c1.cpu(), axis)
    finally:
        cpu_mesh.close()
    cpu_s = time.perf_counter() - t0
    near, err = check_step("22a card vs CPU", sub.cpu(), c1.cpu(),
                           a_card.cpu(), a_cpu, tuple(t.cpu() for t in got),
                           want)
    log(f"[mesh-build] 22a the card's sharded step against the CPU's on "
        f"{KM_CHECK_POINTS} points: counts equal, sums max abs err "
        f"{err:.3g}, {near} near-tie rows (CPU {cpu_s:.1f} s)")
    mesh.close()
    return launches


def _tree_close_to_sum(got, parts: list, what: str) -> float:
    """Every leaf of ``got`` within ALLREDUCE_TOL · Σ|summand| of the
    float64 sum of the matching leaves of ``parts``; returns the largest
    error relative to that bound's scale."""
    worst = 0.0
    for (path, g), *xs in zip(hi.index_leaves(got),
                              *(tree_mod.leaves(p) for p in parts)):
        total = sum(x.double() for x in xs)
        scale = sum(x.double().abs() for x in xs)
        err = (g.double() - total).abs()
        if (err > ALLREDUCE_TOL * scale).any():
            fail(f"{what}: leaf {path} beyond {ALLREDUCE_TOL} x sum of "
                 f"magnitudes")
        worst = max(worst, float((err / scale.clamp_min(1e-30)).max()))
    return worst


def _same_bits(outs: dict, what: str) -> None:
    first = tree_mod.leaves(next(iter(outs.values())))
    for o in outs.values():
        if any(not torch.equal(a, b)
               for a, b in zip(first, tree_mod.leaves(o))):
            fail(f"{what}: positions hold different bits")


def _timed_ms(fn) -> float:
    times = []
    for _ in range(ALLREDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def grad_trees(dev, seed: int, built: dict) -> tuple:
    """GRAD_POSITIONS gradient trees and losses of phase 18's
    configuration (d 768, d_ff 3,072, B 32) from its batches 0, 1, …,
    and the parameters they were taken at."""
    cfg = sup_train_cfg(seed)
    enc_cfg = train.encoder_config(cfg, VOCAB)
    params = _train_params(dev, seed, built, enc_cfg)
    topic = synthetic.hard_negatives(built["corpus"], cfg.n_negatives,
                                     seed=seed)
    batches = train.sup_batches(built["corpus"], cfg, topic,
                                built["doc_assign"])
    loss = train.sup_loss(enc_cfg, VOCAB, cfg.refine_weight)
    grads, losses = [], []
    for i in range(GRAD_POSITIONS):
        (value, _), g = optim.value_and_grad(
            loss, params, tree_mod.to(batches(i), dev), has_aux=True)
        grads.append(g)
        losses.append(value.detach())
    return params, grads, losses


def allreduce_phase(dev, params, grads: list, losses: list):
    """22b: ``flat_allreduce`` of the GRAD_POSITIONS trees (one a
    position) along "data" at S = 4, and on a (pod 2, data 2) mesh flat
    and ``hierarchical_allreduce``: the same bits everywhere, flat within
    ALLREDUCE_TOL · Σ|g| of the float64 sum, hierarchical within that of
    flat (some leaf's dim 0 odd: the flat fallback); ``pmean_metrics``
    of the losses; ms an all-reduce on the card; EF_STEPS steps of
    ``compress_with_ef`` on the card against the CPU bit for bit.
    Returns the flat sum."""
    n_leaves = len(tree_mod.leaves(grads[0]))
    n_params = sum(t.numel() for t in tree_mod.leaves(grads[0]))
    odd = [p for p, t in hi.index_leaves(grads[0])
           if t.dim() == 0 or t.shape[0] % 2]
    if not odd:
        fail("22b: no leaf takes hierarchical_allreduce's flat fallback")
    line = collectives.Mesh([dev] * GRAD_POSITIONS, ("data",))
    pod = collectives.Mesh([[dev] * 2] * 2, ("pod", "data"))
    try:
        def flat_body(coord):
            return collectives.flat_allreduce(grads[coord[0]], "data",
                                              pos=line.position(coord))

        def pod_body(schedule):
            def body(coord):
                pos = pod.position(coord)
                g = grads[pod.rank(("pod", "data"), coord)]
                if schedule == "flat":
                    return collectives.flat_allreduce(g, ("pod", "data"),
                                                      pos=pos)
                return collectives.hierarchical_allreduce(g, pos=pos)
            return body

        flat = line.run(flat_body)
        _same_bits(flat, "22b flat_allreduce (S 4)")
        flat0 = flat[(0,)]
        worst = _tree_close_to_sum(flat0, grads, "22b flat vs float64")
        pod_flat = pod.run(pod_body("flat"))
        _same_bits(pod_flat, "22b flat_allreduce (2, 2)")
        hier = pod.run(pod_body("hier"))
        _same_bits(hier, "22b hierarchical_allreduce (2, 2)")
        hier0 = hier[(0, 0)]
        hw = 0.0
        for (path, h), f, *xs in zip(hi.index_leaves(hier0),
                                     tree_mod.leaves(flat0),
                                     *(tree_mod.leaves(g) for g in grads)):
            scale = sum(x.double().abs() for x in xs)
            err = (h.double() - f.double()).abs()
            if (err > ALLREDUCE_TOL * scale).any():
                fail(f"22b hierarchical vs flat: leaf {path} beyond "
                     f"{ALLREDUCE_TOL} x sum of magnitudes")
            hw = max(hw, float((err / scale.clamp_min(1e-30)).max()))
        metrics_out = pod.run(lambda coord: collectives.pmean_metrics(
            {"loss": losses[pod.rank(("pod", "data"), coord)]},
            ("pod", "data"), pos=pod.position(coord)))
        _same_bits(metrics_out, "22b pmean_metrics")
        mean_loss = float(metrics_out[(0, 0)]["loss"])
        ms = {"flat S 4": _timed_ms(lambda: line.run(flat_body)),
              "flat (2, 2)": _timed_ms(lambda: pod.run(pod_body("flat"))),
              "hierarchical (2, 2)": _timed_ms(
                  lambda: pod.run(pod_body("hier")))}
        profile_call(lambda: line.run(flat_body),
                     "one flat all-reduce (S 4 on one card)", top=8)
    finally:
        line.close()
        pod.close()
    log(f"[mesh-train] 22b {GRAD_POSITIONS} gradient trees of phase 18's "
        f"configuration ({n_leaves} leaves, {n_params} parameters, "
        f"{n_params * 4 / 1e6:.1f} MB each; losses "
        f"{[round(float(v), 6) for v in losses]}): every position the "
        f"same bits; flat within {ALLREDUCE_TOL} x sum of magnitudes of "
        f"the float64 sum (worst {worst:.3g}); hierarchical within it of "
        f"flat (worst {hw:.3g}; flat fallback on {odd}); pmean_metrics "
        f"loss {mean_loss:.6f} on every position; ms an all-reduce on the "
        f"one card (the emulated split's cost, median of "
        f"{ALLREDUCE_REPS}): { {k: round(v, 3) for k, v in ms.items()} }")
    # int8 compression with error feedback, card against CPU
    small = [{"term_mlp": g.term_mlp, "layers": g.encoder["layers"],
              "final_norm": g.encoder["final_norm"]} for g in grads]
    t0 = time.perf_counter()
    ef = compression.ef_init(small[0])
    cpu = [tree_mod.to(g, "cpu") for g in small]
    ef_cpu = compression.ef_init(cpu[0])
    n_small = sum(t.numel() for t in tree_mod.leaves(small[0]))
    for step in range(EF_STEPS):
        comp, ef = compression.compress_with_ef(small[step % len(small)], ef)
        comp_cpu, ef_cpu = compression.compress_with_ef(
            cpu[step % len(cpu)], ef_cpu)
        got = tree_mod.leaves(compression.decompress(comp))
        want = tree_mod.leaves(compression.decompress(comp_cpu))
        if any(not torch.equal(a.cpu(), b) for a, b in zip(got, want)) or any(
                not torch.equal(a.cpu(), b) for a, b in
                zip(tree_mod.leaves(ef), tree_mod.leaves(ef_cpu))):
            fail(f"22b compress_with_ef step {step}: card and CPU differ")
    log(f"[mesh-train] 22b {EF_STEPS} steps of compress_with_ef over "
        f"{n_small} parameters (the term MLP and the encoder's layers, "
        f"without the cluster, embedding and unembedding planes) on the "
        f"card bitwise equal to the CPU "
        f"({time.perf_counter() - t0:.1f} s)")
    return flat0


def _placed_leaves(node) -> list:
    """The leaves of a restored tree in ``tree_mod.leaves`` order, a
    split leaf ({coord: block}) as one."""
    if isinstance(node, dict) and node and all(isinstance(k, tuple)
                                                for k in node):
        return [node]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [x for k in node._fields
                for x in _placed_leaves(getattr(node, k))]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _placed_leaves(node[k])]
    return [node] if isinstance(node, torch.Tensor) else []


def elastic_restore(dev, params, grads) -> None:
    """22c: phase 18's {params, opt} (one AdamW step over ``grads``)
    saved under build/ and ``restore_resharded`` onto the card and split
    along dim 0 over 2 and then 4 positions of a mesh axis (a leaf whose
    dim 0 the axis does not divide is placed on the card whole): every
    leaf, reassembled, bitwise equal to the saved one."""
    params, opt = optim.adam_update(grads, optim.adam_init(params), params,
                                    optim.AdamConfig(lr=1e-3))
    tree = {"params": params, "opt": opt}
    saved = tree_mod.leaves(tree)
    shutil.rmtree(RESHARD_CKPT, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = ckpt.save(str(RESHARD_CKPT), 1, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore_resharded(path, tree, dev)
        torch.cuda.synchronize()
        if any(not torch.equal(a, b)
               for a, b in zip(saved, tree_mod.leaves(back))):
            fail("22c: restored onto the card, a leaf differs")
        done, whole = {"card": time.perf_counter() - t0}, {}
        del back
        for n in RESHARD_SPLITS:
            mesh = collectives.Mesh([dev] * n, ("data",))
            split = collectives.Split(mesh, "data")
            t0 = time.perf_counter()
            back = ckpt.restore_resharded(path, tree, tree_mod.map(
                lambda t: split if t.dim() and t.shape[0] % n == 0 else dev,
                tree))
            torch.cuda.synchronize()
            placed = _placed_leaves(back)
            whole[n] = 0
            if len(placed) != len(saved):
                fail(f"22c: split over {n}, {len(placed)} leaves restored "
                     f"of {len(saved)}")
            for a, b in zip(saved, placed):
                if isinstance(b, dict):
                    if not torch.equal(split.join(b), a.cpu()):
                        fail(f"22c: split over {n}, a leaf reassembles "
                             f"differently")
                elif torch.equal(b, a):
                    whole[n] += 1
                else:
                    fail(f"22c: split over {n}, a whole leaf differs")
            done[f"split {n}"] = time.perf_counter() - t0
            mesh.close()
            del back
    finally:
        shutil.rmtree(RESHARD_CKPT, ignore_errors=True)
    log(f"[mesh-train] 22c {{params, opt}} of {len(saved)} leaves saved "
        f"({save_s:.2f} s) and restored onto the card and split over "
        f"{RESHARD_SPLITS} positions (leaves placed whole, dim 0 not "
        f"divided: {whole}): every leaf "
        f"bitwise equal reassembled; seconds "
        f"{ {k: round(v, 2) for k, v in done.items()} }")


def mesh_build_phase(dev, seed: int, built: dict) -> dict:
    """Phase 22; returns 22a's counted launches."""
    with phase("22a sharded KMeans (counted)"):
        launches = sharded_kmeans(dev, seed, built)
    torch.cuda.empty_cache()
    with phase("22b gradient all-reduce and int8 compression"):
        params, grads, losses = grad_trees(dev, seed, built)
        reduced = allreduce_phase(dev, params, grads, losses)
    with phase("22c elastic restore"):
        elastic_restore(dev, params, reduced)
    del params, grads, reduced
    torch.cuda.empty_cache()
    return {"assign_argmax": launches}

# --------------------------------------------------------------------------
# phase 23: the recsys family and HI² over SASRec's item tower
# --------------------------------------------------------------------------

REC_INIT = {"dlrm-rm2": recsys.dlrm_init, "sasrec": recsys.sasrec_init,
            "dien": recsys.dien_init, "mind": recsys.mind_init}


def rec_batch(arch: str, cfg, seed: int, b: int, dev):
    """The arch's data-generator batch of ``b`` rows on ``dev``."""
    if arch == "dlrm-rm2":
        return rdata.dlrm_batch(seed, b, n_dense=cfg.n_dense,
                                n_sparse=cfg.n_sparse, n_rows=cfg.n_rows,
                                device=dev)
    gen = {"sasrec": rdata.sasrec_batch, "dien": rdata.dien_batch,
           "mind": rdata.mind_batch}[arch]
    return gen(seed, b, seq_len=cfg.seq_len, n_items=cfg.n_items,
               device=dev)


def rec_serve_fn(arch: str, cfg):
    """The arch's ``recsys/serve`` function (the reference's
    ``launch/cells.py::_rec_serve_cell``)."""
    return {"dlrm-rm2": lambda p, b: recsys.dlrm_forward(p, cfg, b),
            "sasrec": lambda p, b: recsys.sasrec_user_embedding(p, cfg,
                                                                b.items),
            "dien": lambda p, b: recsys.dien_forward(p, cfg, b),
            "mind": lambda p, b: recsys.mind_interests(p, cfg, b.history)
            }[arch]


def rec_serve(arch: str, cfg, params, cpu_params, dev, seed: int,
              launches: dict) -> dict:
    """23a: the serve function at each REC_SERVE batch as counted runs
    (SASRec: ``n_blocks`` flash launches a call), ms a batch, the first
    N_CHECK rows against the CPU plain path.  Returns {shape: ms}."""
    fn = rec_serve_fn(arch, cfg)
    timer, out = Timer(), {}
    for sname in REC_SERVE:
        b = rec_shapes.REC_SHAPES[sname].batch
        batch = rec_batch(arch, cfg, seed, b, dev)
        with torch.inference_mode():
            reset_counts()
            got = fn(params, batch)
            torch.cuda.synchronize()
            calls = read_counts()
            _add(launches, calls)
            if arch == "sasrec" and calls["flash_attention"] != cfg.n_blocks:
                fail(f"sasrec {sname}: {calls['flash_attention']} "
                     f"flash_attention launches a call, not {cfg.n_blocks}")
            with counted(launches):
                out[sname] = timer.ms(lambda: fn(params, batch),
                                      reps=3 if b > 4096 else 10, warm=1)
                if (arch, sname) in REC_PROFILE:
                    profile_call(lambda: fn(params, batch),
                                 f"23a {arch} {sname} (B {b})")
            small = type(batch)(*(t[:N_CHECK].cpu() for t in batch))
            want = fn(cpu_params, small)
        got = got[:N_CHECK].cpu()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{arch} {sname}: output {tuple(got.shape)} not finite or "
                 f"not the CPU's {tuple(want.shape)}")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=REC_TOL, atol=REC_TOL):
            fail(f"{arch} {sname}: rows differ from the CPU by {err:.3g}")
        log(f"[recsys] 23a {arch} {sname} (B {b}): {out[sname]:.3f} ms a "
            f"batch; first {N_CHECK} rows of {tuple(got.shape[1:])} within "
            f"{err:.3g} of the CPU")
        del batch, got
        torch.cuda.empty_cache()
    return out


def rec_retrieval(arch: str, cfg, params, cpu_params, dev, seed: int,
                  launches: dict) -> float:
    """23b: ``retrieval_cand``, 1 query against 10⁶ candidates, top
    REC_TOP, as a counted run and timed; ids against the CPU plain path
    up to swaps within REC_TOL (DLRM and DIEN, which score each
    candidate alone, over a random REC_CPU_CANDS subset plus the card's
    top).  Returns ms."""
    n = rec_shapes.REC_SHAPES["retrieval_cand"].n_candidates
    q = rec_batch(arch, cfg, seed + 1, 1, dev)
    cands = torch.arange(n, device=dev)
    fn = {"sasrec": lambda p, c: recsys.sasrec_retrieval(
              p, cfg, q.items.to(c.device), REC_TOP),
          "mind": lambda p, c: recsys.mind_retrieval(
              p, cfg, q.history.to(c.device), REC_TOP),
          "dlrm-rm2": lambda p, c: recsys.dlrm_retrieval(
              p, cfg, q.dense[:1].to(c.device), q.sparse[0, :-1].to(
                  c.device), c, REC_TOP),
          "dien": lambda p, c: recsys.dien_retrieval(
              p, cfg, q.history.to(c.device), c, REC_TOP)}[arch]
    with torch.inference_mode():
        with counted(launches):
            got_s, got_i = fn(params, cands)
            ms = Timer().ms(lambda: fn(params, cands),
                            reps=1 if arch == "dien" else 5, warm=1)
        got_s, got_i = got_s[0].cpu().numpy(), got_i[0].cpu().numpy()
        if arch in REC_CPU_CANDS:
            rng = np.random.default_rng(seed)
            subset = np.union1d(rng.choice(n, REC_CPU_CANDS[arch],
                                           replace=False), got_i)
            want_s, pos = fn(cpu_params, torch.from_numpy(subset))
            want_i, scope = subset[pos[0].numpy()], f"{subset.size:,}"
        else:
            want_s, want_i = fn(cpu_params, cands.cpu())
            want_i, scope = want_i[0].numpy(), f"all {n:,}"
    want_s = want_s[0].numpy()
    if not np.isfinite(got_s).all() or not topk_match(
            want_i, want_s, got_i, got_s, REC_TOL):
        fail(f"{arch} retrieval_cand: top {REC_TOP} differs from the CPU's "
             f"over {scope} candidates")
    log(f"[recsys] 23b {arch} retrieval_cand (1 x {n:,}, top {REC_TOP}): "
        f"{ms:.3f} ms; ids equal to the CPU's over {scope} candidates up to "
        f"swaps within {REC_TOL}, {int((got_i != want_i).sum())} swapped")
    return ms


def rec_hi2(dev, seed: int, params, cfg, launches: dict) -> dict:
    """23c: the example's recipe over SASRec's 10⁶-item table at d 50:
    HI² (flat, L = REC_CLUSTERS, the example's capacities, KMeans steps
    and three item tokens) and REC_USERS users; every kernel of the path
    counted, 8 users against the CPU plain path over the same planes."""
    ex = rec_example
    tokens, _, _ = ex.item_tokens(cfg.n_items, ex.VOCAB)
    table = params["item_embed"]["table"]
    build: dict = {}
    t0 = time.perf_counter()
    with counted(build):
        index = hi.build(1, table, tokens, ex.VOCAB, n_clusters=REC_CLUSTERS,
                         k1_terms=ex.K1_TERMS, codec="flat",
                         cluster_capacity=ex.CLUSTER_CAP,
                         term_capacity=ex.TERM_CAP,
                         kmeans_iters=ex.KMEANS_ITERS, device=dev)
    build_s = time.perf_counter() - t0
    if build["assign_argmax"] != ex.KMEANS_ITERS + 1:
        fail(f"23c build: {build['assign_argmax']} assign_argmax launches, "
             f"not {ex.KMEANS_ITERS + 1} (KMeans steps and the final "
             f"assignment)")
    serve_counts: dict = {}
    with counted(serve_counts):
        out = ex.run(params, cfg, dev, n_clusters=REC_CLUSTERS,
                     n_users=REC_USERS, index=index, seed=seed)
    if (serve_counts["topk_scores"] != 1
            or serve_counts["flash_attention"] != cfg.n_blocks):
        fail(f"23c users and search: launches {serve_counts}")
    users, qt, res = out["users"], out["q_tokens"], out["res"]
    with counted(serve_counts):
        ms = Timer().ms(lambda: hi.search(
            index, users, qt, kc=ex.KC, k2=ex.K2, top_r=ex.TOP_R,
            device=dev), reps=10)
    _add(launches, build)
    _add(launches, serve_counts)
    share = metrics.recall_at_k(res.doc_ids, out["exact"][:, 0], ex.TOP_R)
    mean_cands = float(res.n_candidates.float().mean())
    cpu_index = index.to("cpu")
    u8 = users[:N_CHECK].cpu()
    ref = hi.search(cpu_index, u8, qt[:N_CHECK], kc=ex.KC, k2=ex.K2,
                    top_r=ex.TOP_R, device="cpu")
    top = torch.sort(u8 @ cpu_index.cluster_sel.embeddings.T, dim=-1,
                     descending=True).values[:, ex.KC - 1: ex.KC + 1]
    skipped = []
    for b in range(N_CHECK):
        if float(top[b, 0] - top[b, 1]) <= TOPK_TOL:
            skipped.append(b)
            continue
        if int(res.n_candidates[b]) != int(ref.n_candidates[b]) or not (
                topk_match(ref.doc_ids[b].numpy(), ref.scores[b].numpy(),
                           res.doc_ids[b].cpu().numpy(),
                           res.scores[b].cpu().numpy(), REC_TOL)):
            fail(f"23c user {b}: n_candidates or top-{ex.TOP_R} differ "
                 f"from the CPU plain path")
    log(f"[recsys] 23c HI² over SASRec's item tower (N {cfg.n_items:,}, d "
        f"{cfg.embed_dim}, L {REC_CLUSTERS}, flat): build {build_s:.2f} s "
        f"({build['assign_argmax']} assign_argmax launches); {REC_USERS} "
        f"users: {ms:.3f} ms a batch, {mean_cands:.1f} candidates a user "
        f"of {cfg.n_items:,}, exact top-1 in HI²'s top {ex.TOP_R} for "
        f"{share:.1%}; {N_CHECK - len(skipped)} of {N_CHECK} users equal "
        f"to the CPU (near-ties at the K^C boundary skipped: {skipped}); "
        f"launches {serve_counts}")
    return dict(build_s=build_s, batch_ms=ms, mean_candidates=mean_cands,
                top1_in_top10=share)


def rec_flash(dev, seed: int, d: int) -> tuple[float, dict]:
    """23d: ``flash_attention`` at head dim ``d`` (SASRec's 50: ragged
    in the d = 64 instance) against its plain version: f32 and bf16,
    causal and not, S in REC_FLASH_S at B in REC_FLASH_B (Hq 1, as
    SASRec), and views one element off 16-byte alignment; then SASRec's
    shape timed at B 512 and 262,144 beside the plain version, SDPA and
    the bound.  Returns (the largest f32 out error, the times)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s_len in REC_FLASH_S:
                for b in REC_FLASH_B:
                    q, k, v = (_bshd(gen, dev, b, s_len, 1, d, dtype)
                               for _ in range(3))
                    err[dtype] = max(err[dtype], check_flash(
                        q, k, v, causal, 0, f"d {d} {dtype} B {b} S "
                        f"{s_len} causal={causal}",
                        batch_block=REC_FLASH_BLOCK))
                    n_cases += 1
                    del q, k, v
        q = _bshd(gen, dev, 3, 130, 2, d, dtype, offset=1)
        k, v = (_bshd(gen, dev, 3, 70, 1, d, dtype, offset=1)
                for _ in range(2))
        err[dtype] = max(err[dtype], check_flash(
            q, k, v, True, 0, f"d {d} {dtype} misaligned view"))
    torch.cuda.empty_cache()
    log(f"[flash] 23d d = {d} ({fa_ops.instance_name(d, torch.float32)}, "
        f"{fa_ops.instance_name(d, torch.bfloat16)}): "
        f"{n_cases} cases + 2 misaligned views: max abs out err f32 "
        f"{err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}")
    timer, sdpa = Timer(), torch.nn.functional.scaled_dot_product_attention
    times = {}
    for sname in REC_SERVE:
        b, s_len = rec_shapes.REC_SHAPES[sname].batch, 50
        q, k, v = (_bshd(gen, dev, b, s_len, 1, d, torch.float32)
                   for _ in range(3))
        if fa_ops.vector_loads(q, k, v):
            fail(f"flash d = {d}: {4 * d}-byte rows took the 16-byte copies")
        flops = 4.0 * b * d * s_len * (s_len + 1) / 2     # causal pairs
        nbytes = 4.0 * (4 * b * s_len * d + b * s_len)
        bms, by = bound(flops, nbytes)
        t = dict(
            ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, True, 0),
                        reps=10),
            plain_ms=timer.ms(lambda: fa_ref.flash_attention(q, k, v, True,
                                                             0), reps=3),
            library_ms=timer.ms(lambda: sdpa(q, k, v, is_causal=True),
                                reps=5),
            bound_ms=bms, bound_by=by, batch=b)
        times[sname] = t
        log(f"[times] 23d flash_attention at SASRec's shape B {b}, Hq 1, S "
            f"{s_len}, d {d} f32 causal: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library (scaled_dot_product_attention)"
            f" {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), bound /"
            f" kernel {bms / t['ms']:.1%}")
        del q, k, v
    return err[torch.float32], times


def recsys_phase(dev, seed: int) -> dict:
    """Phase 23: the recsys family at its published configs and HI² over
    SASRec's item tower.  Returns the counted launches, the flash
    error and times, and 23c's record."""
    launches: dict = {}
    rec = {"serve_ms": {}, "retrieval_ms": {}}
    sasrec = None
    for arch in REC_ARCHS:
        cfg = registry.get(arch).make_config()
        with phase(f"23a-b {arch} serve and retrieval"):
            params = REC_INIT[arch](
                torch.Generator(device=dev).manual_seed(seed), cfg)
            cpu_params = tree_mod.to(params, "cpu")
            rec["serve_ms"][arch] = rec_serve(arch, cfg, params, cpu_params,
                                              dev, seed, launches)
            rec["retrieval_ms"][arch] = rec_retrieval(
                arch, cfg, params, cpu_params, dev, seed, launches)
        if arch == "sasrec":
            sasrec = (params, cfg)
        del params, cpu_params
        torch.cuda.empty_cache()
    with phase("23c HI² over the SASRec item tower"):
        rec["hi2"] = rec_hi2(dev, seed, *sasrec, launches)
    d = sasrec[1].embed_dim // sasrec[1].n_heads
    del sasrec
    torch.cuda.empty_cache()
    with phase("23d flash_attention at d 50"):
        rec["flash_err"], rec["flash_times"] = rec_flash(dev, seed + 4, d)
    with phase("23e the recsys_retrieval example"):
        with counted(launches):
            rec_example.main([])
    rec["launches"] = launches
    log(f"[recsys] phase 23 launches {launches}")
    return rec


# --------------------------------------------------------------------------
# phase 24: training of the recsys and graph families
# --------------------------------------------------------------------------

def cell_steps(loss, cfg, params, batch, base: int) -> dict:
    """TRAIN_CELL_STEPS cell steps from ``params`` (a counted run): loss
    and grad norm a step, the median ms of steps 2.., peak GB above
    ``base`` (the bytes allocated before the cell made its parameters:
    parameters, batch and Adam state count, earlier phases' do not) and
    launches a step.  The steps update ``params`` in place."""
    state = optim.adam_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    reset_counts()
    for _ in range(TRAIN_CELL_STEPS):
        t0 = time.perf_counter()
        params, state, m = train.cell_step(loss, cfg, params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    if not np.isfinite(losses + norms).all():
        fail(f"a training step gave loss {losses}, grad norm {norms}")
    return dict(losses=losses, norms=norms, step_ms=float(np.median(ms[1:])),
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                launches={k: v / TRAIN_CELL_STEPS for k, v in counts.items()},
                counts=counts)


def _close(what: str, got, want, rtol: float = CELL_TOL,
           atol: float = CELL_TOL) -> float:
    """``got`` within (rtol, atol) of ``want`` elementwise, compared on
    ``got``'s device (IEEE arithmetic: the host's answer, without moving
    a full-width model's leaves to it)."""
    got, want = got.float(), want.float().to(got.device)
    if got.shape != want.shape:
        fail(f"{what}: shapes {tuple(got.shape)}, {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{what}: card and CPU differ by {err:.3g} (shapes "
             f"{tuple(got.shape)}, {tuple(want.shape)}; rtol {rtol:.3g}, "
             f"atol {atol:.3g})")
    return err


def _close_norm(what: str, got, want, rtol: float) -> float:
    """``got`` within ``rtol`` of ``want`` in norm: ||got - want|| /
    ||want||."""
    got, want = got.double(), want.double().to(got.device)
    if got.shape != want.shape:
        fail(f"{what}: shapes {tuple(got.shape)}, {tuple(want.shape)}")
    diff, size = float((got - want).norm()), float(want.norm())
    err = diff / size if size else diff
    if err > rtol:
        fail(f"{what}: card and CPU differ by {err:.3g} of the CPU's norm "
             f"(rtol {rtol:.3g})")
    return err


def adam_first_delta(mu, nu) -> torch.Tensor:
    """A first AdamW step's update at CELL_ADAM from its moments, by the
    reference's formula in float64 where the moments lie."""
    a = train.CELL_ADAM
    assert a.weight_decay == 0.0
    mu, nu = mu.double(), nu.double()
    return -a.lr * (mu / (1 - a.b1)) / ((nu / (1 - a.b2)).sqrt() + a.eps)


def step_vs_cpu_cell(what: str, loss, cfg, params, batch, cpu_cfg,
                     cpu_params, cpu_batch, compare) -> dict:
    """One cell step on the card and on the CPU from the same parameters
    and batch: loss and grad norm within CELL_TOL; over the (name, card,
    CPU) tensors ``compare`` pairs, the updated leaves within CELL_TOL,
    both moments within MOMENT_RTOL in norm and each leaf's update within
    STEP_TOL of :func:`adam_first_delta` of the card's moments.  Returns
    the largest error of each (the moments' relative to the norm).  Both
    steps run on clones (a cell step is in place)."""
    new, state, m = train.cell_step(loss, cfg,
                                    tree_mod.map(torch.clone, params),
                                    optim.adam_init(params), batch)
    cpu_new, cpu_state, cpu_m = train.cell_step(
        loss, cpu_cfg, tree_mod.map(torch.clone, cpu_params),
        optim.adam_init(cpu_params), cpu_batch)
    err = dict(metrics=max(_close(f"{what} {k}", m[k], cpu_m[k])
                           for k in ("loss", "grad_norm")))
    news = compare(new, cpu_new)
    err["params"] = max(_close(f"{what} {name}", a, b)
                        for name, a, b in news)
    mus = compare(state.mu, cpu_state.mu)
    nus = compare(state.nu, cpu_state.nu)
    err["moments"] = max(
        _close_norm(f"{what} {moment} {name}", a, b, MOMENT_RTOL)
        for moment, pairs in (("mu", mus), ("nu", nus))
        for name, a, b in pairs)
    err["update"] = max(
        _close(f"{what} update {name}", a - a0, adam_first_delta(mu, nu),
               *STEP_TOL)
        for (name, a, _), (_, a0, _), (_, mu, _), (_, nu, _) in zip(
            news, compare(params, cpu_params), mus, nus))
    return err


def _same_leaves(new, cpu_new):
    return [(p, a, b) for (p, a), (_, b) in zip(
        tree_mod.leaves_with_paths(new), tree_mod.leaves_with_paths(cpu_new))]


def dlrm_on_cpu(cfg, params, batch):
    """The CPU's copy of a DLRM step: each table cut to the rows the batch
    reads, in id order, and the ids renumbered, so the CPU steps 512 rows
    a table, not 10⁶.  A row the batch does not read gets no gradient and
    no update, and the kept rows' sums run in the same order.  Returns
    (cfg, params, batch, compare) for :func:`step_vs_cpu_cell`."""
    sparse = batch.sparse.clamp(min=0).long().cpu()
    used = [torch.unique(sparse[:, f]) for f in range(cfg.n_sparse)]
    width = max(len(u) for u in used)
    tables = torch.zeros((cfg.n_sparse, width, cfg.embed_dim))
    for f, u in enumerate(used):
        tables[f, :len(u)] = params["tables"][f, u.to(
            params["tables"].device)].cpu()
    ids = torch.stack([torch.searchsorted(used[f],
                                          sparse[:, f].contiguous())
                       for f in range(cfg.n_sparse)], dim=1).int()
    cpu_params = dict(tree_mod.to({k: v for k, v in params.items()
                                   if k != "tables"}, "cpu"), tables=tables)
    cpu_batch = recsys.DLRMBatch(batch.dense.cpu(), ids, batch.labels.cpu())

    def compare(new, cpu_new):
        out = [(p, a, b) for p, a, b in _same_leaves(
            {k: v for k, v in new.items() if k != "tables"},
            {k: v for k, v in cpu_new.items() if k != "tables"})]
        for f, u in enumerate(used):
            out.append((f"tables[{f}] (the {len(u)} rows read)",
                        new["tables"][f, u.to(new["tables"].device)],
                        cpu_new["tables"][f, :len(u)]))
        return out

    return (dataclasses.replace(cfg, n_rows=width), cpu_params, cpu_batch,
            compare)


def rec_train(arch: str, dev, seed: int, launches: dict) -> dict:
    """24a: one recsys arch's training cell at its published config and
    REC_SHAPES["train_batch"]."""
    cfg = registry.get(arch).make_config()
    b = rec_shapes.REC_SHAPES["train_batch"].batch
    loss = recsys.LOSSES[arch]
    base = torch.cuda.memory_allocated()
    params = REC_INIT[arch](torch.Generator(device=dev).manual_seed(seed),
                            cfg)
    check = rec_batch(arch, cfg, seed + 7, REC_CHECK_B, dev)
    if arch == "dlrm-rm2":
        cpu_cfg, cpu_params, cpu_batch, compare = dlrm_on_cpu(cfg, params,
                                                              check)
    else:
        cpu_cfg, cpu_params = cfg, tree_mod.to(params, "cpu")
        cpu_batch, compare = tree_mod.to(check, "cpu"), _same_leaves
    err = step_vs_cpu_cell(f"24a {arch} (B {REC_CHECK_B})", loss, cfg,
                           params, check, cpu_cfg, cpu_params, cpu_batch,
                           compare)
    del check, cpu_params, cpu_batch
    torch.cuda.empty_cache()
    batch = rec_batch(arch, cfg, seed, b, dev)
    rec = cell_steps(loss, cfg, params, batch, base)
    _add(launches, rec["counts"])
    flash = rec["launches"]["flash_attention"]
    if arch == "sasrec" and flash != cfg.n_blocks:
        fail(f"sasrec: {flash} flash_attention launches a step, not "
             f"{cfg.n_blocks}")
    log(f"[train] 24a {arch} (B {b}, 1 microbatch: the whole batch): loss "
        f"{[round(x, 6) for x in rec['losses']]}, grad norm "
        f"{[round(x, 6) for x in rec['norms']]}; {rec['step_ms']:.3f} ms a "
        f"step (median of steps 2-{TRAIN_CELL_STEPS}); peak "
        f"{rec['peak_gb']:.2f} GB; flash_attention {flash:g} a step; one "
        f"step at B {REC_CHECK_B} against the CPU: largest errors {err}")
    if arch == "dien":
        profile_call(lambda: train.cell_step(loss, cfg, params,
                                             optim.adam_init(params), batch),
                     f"24a dien one training step (B {b})")
    return dict(rec, err=err)


def gnn_batch(shape, cfg, seed: int, dev):
    """The cell's GraphBatch on ``dev`` and what of it was cut (None)."""
    if shape.kind == "molecule":
        return gdata.molecule_batch(seed, shape.batch_graphs, shape.n_nodes,
                                    shape.n_edges, shape.d_feat,
                                    cfg.n_classes, device=dev), None
    if shape.kind == "full":
        return gdata.random_graph(seed, shape.n_nodes, shape.n_edges,
                                  shape.d_feat, cfg.n_classes,
                                  device=dev), None
    parent = gdata.random_graph(seed, shape.n_nodes, MINIBATCH_PARENT_EDGES,
                                shape.d_feat, cfg.n_classes, device="cpu")
    seeds = np.random.default_rng(seed).choice(shape.n_nodes,
                                               shape.batch_nodes,
                                               replace=False)
    sub = gdata.NeighborSampler(shape.n_nodes, parent.edge_src,
                                parent.edge_dst).sample(
        seed, seeds, shape.fanout, parent.node_feat, parent.labels,
        device=dev)
    return sub, {"parent_edges": [shape.n_edges, MINIBATCH_PARENT_EDGES]}


def gnn_train(name: str, dev, seed: int, launches: dict) -> dict:
    """24b: GatedGCN's training cell at ``make_config(shape)``."""
    shape = rec_shapes.GNN_SHAPES[name]
    cfg = registry.get("gatedgcn").make_config(shape)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g, reduced = gnn_batch(shape, cfg, seed, dev)
    made_s = time.perf_counter() - t0
    params = gnn.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    err = step_vs_cpu_cell(f"24b {name}", gnn.loss_fn, cfg, params, g, cfg,
                           tree_mod.to(params, "cpu"),
                           tree_mod.to(g, "cpu"), _same_leaves)
    rec = cell_steps(gnn.loss_fn, cfg, params, g, base)
    _add(launches, rec["counts"])
    log(f"[train] 24b gatedgcn {name}: {g.node_feat.shape[0]} nodes, "
        f"{g.edge_src.shape[0]} edges, d_feat {shape.d_feat}, "
        f"{cfg.n_classes} classes, {cfg.n_layers} layers d "
        f"{cfg.d_hidden}, remat {cfg.remat}; batch made in {made_s:.1f} s"
        + (f"; reduced {reduced}" if reduced else "") + f"; loss "
        f"{[round(x, 6) for x in rec['losses']]}, grad norm "
        f"{[round(x, 6) for x in rec['norms']]}; {rec['step_ms']:.3f} ms a "
        f"step; peak {rec['peak_gb']:.2f} GB; launches a step "
        f"{rec['launches']}; one step against the CPU: largest errors {err}")
    if name == "minibatch_lg":
        profile_call(lambda: train.cell_step(gnn.loss_fn, cfg, params,
                                             optim.adam_init(params), g),
                     f"24b gatedgcn {name} one training step")
    return dict(rec, err=err, reduced=reduced, params=params, cfg=cfg, g=g)


def within(seconds: float, fn, what: str):
    """``fn()`` in a thread of its own; past ``seconds`` the run ends at
    once with exit code 1 (a hung autograd thread could not be joined)."""
    box: dict = {}

    def run():
        torch.cuda.set_device(0)
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:          # noqa: BLE001 — re-raised
            box["err"] = e

    t = threading.Thread(target=run, daemon=True, name=what)
    t.start()
    t.join(seconds)
    if t.is_alive():
        log(f"chip_smoke: {what} did not finish in {seconds} s (a hang)")
        sys.stdout.flush()
        os._exit(1)
    if "err" in box:
        raise box["err"]
    return box["out"]


def partitioned_check(dev, full: dict) -> dict:
    """24c: full_graph_sm split by partition_by_dst over PARTITIONS
    positions of the one card, on 24b's initial parameters: the loss
    within PARTITION_LOSS_TOL of loss_fn's, every gradient within
    CELL_TOL, under a timeout."""
    cfg, params, g = full["cfg"], full["params"], full["g"]
    (want, _), wgrads = optim.value_and_grad(gnn.loss_fn, params, cfg, g,
                                             has_aux=True)
    mesh = collectives.Mesh([dev] * PARTITIONS, ("data",))
    gp = gdata.partition_by_dst(g, PARTITIONS)

    def step():
        return optim.value_and_grad(
            lambda p, b: gnn.loss_fn_partitioned(p, cfg, b, mesh), params,
            gp, has_aux=True)

    (loss, _), grads = within(PARTITION_TIMEOUT_S, step, "24c first step")
    t0 = time.perf_counter()
    within(PARTITION_TIMEOUT_S, step, "24c timed step")
    ms = (time.perf_counter() - t0) * 1e3
    mesh.close()
    rel = abs(float(loss) - float(want)) / abs(float(want))
    if rel > PARTITION_LOSS_TOL:
        fail(f"24c: partitioned loss {float(loss)} vs loss_fn "
             f"{float(want)} (rel {rel:.3g})")
    err = max(_close(f"24c grad {p}", a, b)
              for p, a, b in _same_leaves(grads, wgrads))
    log(f"[train] 24c partitioned full_graph_sm on {PARTITIONS} positions "
        f"of the card ({gp.node_feat.shape[0] // PARTITIONS} nodes, "
        f"{gp.edge_src.shape[0] // PARTITIONS} edge slots a position): "
        f"loss {float(loss):.7f} vs loss_fn {float(want):.7f} (rel "
        f"{rel:.3g}), gradients within {err:.3g}; value and grad "
        f"{ms:.1f} ms (a thread and {cfg.n_layers + 2} mesh calls)")
    return dict(rel=rel, err=err, ms=ms)


def ogb_products_note() -> None:
    shape = rec_shapes.GNN_SHAPES["ogb_products"]
    cfg = registry.get("gatedgcn").make_config(shape)
    d = cfg.d_hidden
    plane = shape.n_edges * d * 4
    log(f"[train] 24b ogb_products not run: its edge plane is "
        f"{shape.n_edges:,} edges x {d} x 4 B = {plane / 1e9:.1f} GB, one "
        f"layer's forward holds at least four (h_src, h_dst, e_new, msg), "
        f"and under remat the {cfg.n_layers} layers' saved (h, e) inputs "
        f"alone take {cfg.n_layers * (plane + shape.n_nodes * d * 4) / 1e9:.0f}"
        f" GB; one 80 GB card cannot hold it")


def train_cells_phase(dev, seed: int) -> dict:
    """Phase 24: the recsys and graph families' training cells on the
    card.  Returns the counted launches (24a's steps) and each cell's
    record."""
    launches: dict = {}
    rec: dict = {"recsys": {}, "gnn": {}}
    log(f"[train] phase 24 starts with "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by earlier "
        f"phases; each cell's peak below is above that")
    for arch in REC_ARCHS:
        with phase(f"24a {arch} training"):
            rec["recsys"][arch] = rec_train(arch, dev, seed, launches)
        torch.cuda.empty_cache()
    for name in GNN_TRAIN_SHAPES:
        with phase(f"24b gatedgcn {name} training"):
            rec["gnn"][name] = gnn_train(name, dev, seed, launches)
        torch.cuda.empty_cache()
    ogb_products_note()
    with phase("24c partitioned gatedgcn (4 positions)"):
        rec["partitioned"] = partitioned_check(dev,
                                               rec["gnn"]["full_graph_sm"])
    for r in rec["gnn"].values():
        for k in ("params", "g"):
            r.pop(k)
    rec["launches"] = launches
    log(f"[train] phase 24 launches {launches}")
    return rec


# --------------------------------------------------------------------------
# phase 25: the dense LM family, trained and served
# --------------------------------------------------------------------------

def lm_tokens(cfg, seed: int, b: int, s: int, dev) -> torch.Tensor:
    """(b, s) token ids drawn on ``dev`` from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)


def lm_batch(cfg, seed: int, b: int, s: int, dev) -> dict:
    """A next-token batch: tokens and labels (b, s) of one (b, s + 1)
    draw."""
    ids = lm_tokens(cfg, seed, b, s + 1, dev)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def lm_check_cfg(arch: str):
    """``arch``'s make_config() at LM_CHECK_LAYERS layers in f32: full
    width, held against the CPU."""
    return dataclasses.replace(registry.get(arch).make_config(),
                               n_layers=LM_CHECK_LAYERS,
                               compute_dtype=torch.float32)


def lm_train(arch: str, dev, seed: int, launches: dict) -> dict:
    """25a: ``arch``'s training cell at make_config() and train_4k's S,
    B cut to LM_TRAIN_B: TRAIN_CELL_STEPS steps in place as a counted
    run, then one profiled; first one step of its LM_CHECK_LAYERS-layer
    f32 copy against the CPU, as phase 24 holds a step."""
    ccfg = lm_check_cfg(arch)
    cb, cs = LM_CHECK_TRAIN
    with phase(f"25a {arch} {LM_CHECK_LAYERS}-layer step against the CPU"):
        cparams = tfm.init(torch.Generator(device=dev).manual_seed(seed),
                           ccfg)
        check = lm_batch(ccfg, seed + 1, cb, cs, dev)
        err = step_vs_cpu_cell(
            f"25a {arch} ({LM_CHECK_LAYERS} layers, f32, B {cb}, S {cs})",
            tfm.cell_loss, ccfg, cparams, check, ccfg,
            tree_mod.to(cparams, "cpu"), tree_mod.to(check, "cpu"),
            _same_leaves)
        del cparams, check
    torch.cuda.empty_cache()
    cfg = registry.get(arch).make_config()
    shape = rec_shapes.LM_SHAPES["train_4k"]
    b, s = LM_TRAIN_B[arch], shape.seq_len
    base = torch.cuda.memory_allocated()
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    batch = lm_batch(cfg, seed, b, s, dev)
    rec = cell_steps(tfm.cell_loss, cfg, params, batch, base)
    _add(launches, rec["counts"])
    flash = rec["launches"]["flash_attention"]
    if flash != 2 * cfg.n_layers:
        fail(f"25a {arch}: {flash:g} flash_attention launches a step, not "
             f"{2 * cfg.n_layers} (forward and remat recompute)")
    step_s = rec["step_ms"] / 1e3
    tok_s = b * s / step_s
    mfu = 6 * cfg.n_params() * b * s / step_s / PEAK_BF16_FLOPS
    if arch == LM_PROFILE_ARCH:
        profile_call(lambda: train.cell_step(
            tfm.cell_loss, cfg, params, optim.adam_init(params), batch),
            f"25a {arch} one training step (B {b}, S {s})", warm=False)
    del params, batch
    torch.cuda.empty_cache()
    flash_ms = flash_causal_times(
        Timer(), f"{arch}'s train_4k shape", b, s, cfg.n_heads,
        cfg.n_kv_heads, cfg.head_dim, dev, plain=True)
    log(f"[lm] 25a {arch} (make_config: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, V {cfg.vocab_size}, "
        f"{cfg.n_params() / 1e9:.3f} B params, bf16 compute, fp32 params "
        f"and AdamW in place, remat) at train_4k's S {s}, B {b} (cut from "
        f"{shape.global_batch}): loss {[round(x, 6) for x in rec['losses']]}"
        f", grad norm {[round(x, 6) for x in rec['norms']]}; "
        f"{rec['step_ms']:.1f} ms a step (median of steps 2-"
        f"{TRAIN_CELL_STEPS}), {tok_s:,.0f} tokens/s, model-FLOP share "
        f"{mfu:.1%} (6 x params x tokens over {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16 dense); peak {rec['peak_gb']:.2f} GB above "
        f"{base / 1e9:.2f}; flash_attention {flash:g} a step, "
        f"{flash_ms['ms']:.3f} ms a launch; one {LM_CHECK_LAYERS}-layer "
        f"f32 step against the CPU: largest errors {err}")
    return dict(rec, err=err, b=b, s=s, tok_s=tok_s, mfu=mfu,
                flash=dict(flash_ms, b=b, s=s, hq=cfg.n_heads,
                           hkv=cfg.n_kv_heads, d=cfg.head_dim,
                           launches=rec["counts"]["flash_attention"]))


def lm_not_run_notes() -> None:
    cfg = registry.get(LM_SERVE_ARCH).make_config()
    n = cfg.n_params()
    log(f"[lm] 25a {LM_SERVE_ARCH} training not run: {n / 1e9:.3f} B "
        f"params, {4 * n / 1e9:.1f} GB in fp32 and {16 * n / 1e9:.1f} GB "
        f"with their gradients and AdamW's two moments; one 80 GB card "
        f"cannot hold them")
    shape = rec_shapes.LM_SHAPES["decode_32k"]
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    log(f"[lm] 25c decode_32k cut: its B {shape.global_batch} x "
        f"{shape.seq_len:,} bf16 cache is "
        f"{kv * shape.global_batch * shape.seq_len / 1e9:.0f} GB "
        f"({kv / 1e6:.3f} MB a token a sequence); 25c decodes B "
        f"{LM_DECODE[0]} after a {LM_DECODE[1]:,}-token prefill")


def lm_parity(dev, seed: int) -> dict:
    """25d in f32: LM_SERVE_ARCH at full width and LM_CHECK_LAYERS layers
    against the CPU (logits_fn, loss_fn, prefill_step's logits and
    caches, LM_PARITY's serve steps after it), and its windowed copy's
    rolling decode against logits_fn at every position."""
    cfg = lm_check_cfg(LM_SERVE_ARCH)
    b, s, steps = LM_PARITY
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    cpu = tree_mod.to(params, "cpu")
    ids = lm_tokens(cfg, seed + 2, b, s + steps + 1, dev)
    cids = ids.cpu()
    tok, lab = ids[:, :s], ids[:, 1:s + 1]
    err = {}
    with torch.no_grad():
        err["logits_fn"] = _close("25d logits_fn", tfm.logits_fn(
            params, cfg, tok)[0], tfm.logits_fn(cpu, cfg, cids[:, :s])[0],
            LM_TOL, LM_TOL)
        err["loss_fn"] = _close("25d loss_fn", tfm.loss_fn(
            params, cfg, tok, lab)[0], tfm.loss_fn(
            cpu, cfg, cids[:, :s], cids[:, 1:s + 1])[0], LM_TOL, LM_TOL)
    logits, caches = tfm.prefill_step(params, cfg, tok)
    want, cpu_caches = tfm.prefill_step(cpu, cfg, cids[:, :s])

    def caches_close(what: str) -> float:
        if not torch.equal(caches.cache_pos.cpu(), cpu_caches.cache_pos):
            fail(f"25d {what}: cache_pos differs from the CPU's")
        return max(_close(f"25d {what} k", caches.k, cpu_caches.k, LM_TOL,
                          LM_TOL),
                   _close(f"25d {what} v", caches.v, cpu_caches.v, LM_TOL,
                          LM_TOL))

    err["prefill_step"] = max(_close("25d prefill_step logits", logits,
                                     want, LM_TOL, LM_TOL),
                              caches_close("prefill_step caches"))
    err["serve_step"] = 0.0
    for i in range(s, s + steps):
        got, caches = tfm.serve_step(params, cfg, caches, ids[:, i:i + 1], i)
        want, cpu_caches = tfm.serve_step(cpu, cfg, cpu_caches,
                                          cids[:, i:i + 1], i)
        err["serve_step"] = max(err["serve_step"], _close(
            f"25d serve_step at {i}", got, want, LM_TOL, LM_TOL))
    err["serve_step"] = max(err["serve_step"],
                            caches_close("caches after serve_step"))
    del cpu, cpu_caches, caches
    wcfg = dataclasses.replace(cfg, window=LM_WINDOW)
    with torch.no_grad():
        full, _ = tfm.logits_fn(params, wcfg, tok)
    rolling = tfm.init_decode_caches(wcfg, b, s, device=dev)
    if rolling.k.shape[3] != LM_WINDOW:
        fail(f"25d: a window-{LM_WINDOW} cache of {rolling.k.shape[3]} "
             f"slots")
    err["windowed"] = 0.0
    for i in range(s):
        got, rolling = tfm.serve_step(params, wcfg, rolling, tok[:, i:i + 1],
                                      i)
        err["windowed"] = max(err["windowed"], _close(
            f"25d windowed decode at {i}", got[:, 0], full[:, i],
            LM_WINDOW_TOL, LM_WINDOW_TOL))
    log(f"[lm] 25d {LM_SERVE_ARCH} at full width, {LM_CHECK_LAYERS} layers, "
        f"f32, B {b}, S {s}, against the CPU (rtol = atol = {LM_TOL:g}): "
        f"logits_fn, loss_fn, prefill_step's logits and caches, {steps} "
        f"serve_steps and the caches after them; window {LM_WINDOW} "
        f"(capacity {LM_WINDOW}): rolling decode over {s} positions against "
        f"logits_fn at each (rtol = atol = {LM_WINDOW_TOL:g}); largest "
        f"errors {err}")
    return err


def lm_serve(dev, seed: int, launches: dict) -> dict:
    """25b-c, and 25d's full-depth bf16 check: LM_SERVE_ARCH at
    make_config() (fp32 weights from ``seed`` on the card)."""
    cfg = registry.get(LM_SERVE_ARCH).make_config()
    before = torch.cuda.memory_allocated()
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rec = dict(weights_gb=(base - before) / 1e9)
    shape = rec_shapes.LM_SHAPES["prefill_32k"]
    tokens = lm_tokens(cfg, seed + 3, LM_PREFILL_B, shape.seq_len, dev)
    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    with counted(counts):
        t0 = time.perf_counter()
        logits, caches = tfm.prefill_step(params, cfg, tokens)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    rec["prefill_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    if counts["flash_attention"] != cfg.n_layers or not bool(
            torch.isfinite(logits).all()):
        fail(f"25b: {counts['flash_attention']} flash launches (not "
             f"{cfg.n_layers}), logits finite: "
             f"{bool(torch.isfinite(logits).all())}")
    _add(launches, counts)
    n_tok = LM_PREFILL_B * shape.seq_len
    log(f"[lm] 25b {LM_SERVE_ARCH} prefill_step at prefill_32k's S "
        f"{shape.seq_len:,}, B {LM_PREFILL_B} (cut from "
        f"{shape.global_batch}; {rec['weights_gb']:.1f} GB of fp32 weights, "
        f"bf16 compute): {rec['prefill_ms']:.1f} ms, "
        f"{n_tok / rec['prefill_ms'] * 1e3:,.0f} tokens/s, peak "
        f"{rec['prefill_peak_gb']:.2f} GB above the weights, "
        f"{counts['flash_attention']} flash launches; caches "
        f"{tuple(caches.k.shape)} bf16")
    del logits, caches, tokens
    torch.cuda.empty_cache()

    b, s0, steps = LM_DECODE
    ids = lm_tokens(cfg, seed + 4, b, s0, dev)
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    with counted(counts):
        t0 = time.perf_counter()
        last, caches = tfm.prefill_step(params, cfg, ids)
        torch.cuda.synchronize()
        rec["decode_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        tok = first_tok = last.argmax(-1)
        pos = torch.tensor(s0, device=dev)
        t0 = time.perf_counter()
        for i in range(steps):
            step_logits, caches = tfm.serve_step(params, cfg, caches, tok,
                                                 pos)
            if i == 0:
                first = step_logits
            tok, pos = step_logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        rec["token_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    rec["decode_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    if counts["flash_attention"] != cfg.n_layers or not bool(
            torch.isfinite(first).all()):
        fail(f"25c: {counts['flash_attention']} flash launches (not "
             f"{cfg.n_layers} for the prefill, none a decode step)")
    _add(launches, counts)
    log(f"[lm] 25c {LM_SERVE_ARCH} decode: prefill_step B {b} x {s0:,} in "
        f"{rec['decode_prefill_ms']:.1f} ms, then {steps} greedy serve_steps "
        f"on its {s0:,}-slot caches: {rec['token_ms']:.3f} ms a token "
        f"(a step for all {b} sequences), {b / rec['token_ms'] * 1e3:,.1f} "
        f"tokens/s; peak {rec['decode_peak_gb']:.2f} GB above the weights")
    profile_call(lambda: tfm.serve_step(params, cfg, caches, tok, pos),
                 f"25c {LM_SERVE_ARCH} one decode step (B {b})", warm=False)
    del caches
    torch.cuda.empty_cache()
    # 25d: the first decoded logits (position s0, whose s0-slot cache has
    # evicted position 0) are logits_fn's over the same s0 + 1 tokens at
    # window s0
    seq = torch.cat([ids[:1], first_tok[:1]], dim=1)
    with torch.no_grad():
        full, _ = tfm.logits_fn(params, dataclasses.replace(cfg, window=s0),
                                seq)
    got, want = first[0, 0], full[0, s0]
    rec["bf16_rel"] = _close_norm("25d bf16 first decode", got, want,
                                  LM_BF16_REL)
    rec["bf16_max_abs"] = float((got - want).abs().max())
    log(f"[lm] 25d {LM_SERVE_ARCH} full depth, bf16: 25c's first decoded "
        f"logits (serve_step's decode_step attention) against logits_fn "
        f"(flash_attention) over the same {s0 + 1:,} tokens at window "
        f"{s0:,} (sequence 0): relative error {rec['bf16_rel']:.4g} "
        f"(tolerance {LM_BF16_REL:g} of the norm; {LM_BF16_REL_FMA:g} when "
        f"bf16 flash ran the fp32 FMA kernel), largest absolute "
        f"{rec['bf16_max_abs']:.4g}")
    return rec


def large_model_memory() -> None:
    """Free what earlier phases cached and make the allocator's new
    segments expandable, for the LM phases, whose steps fill the card
    to within a few GB: with fixed segments, call 2 of PR 33 saw a 14.1
    GiB request of 25a fail with 14.65 GiB reserved but unallocated.
    (No CUDA graph is captured from here on.)"""
    gc.collect()
    # cuBLAS keeps a workspace for every (handle, stream) it has run on;
    # the mesh positions' and the runtime's streams of earlier phases
    # leave many behind
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def lm_phase(dev, seed: int) -> dict:
    """Phase 25: the dense LM family, trained (25a) and served (25b-c),
    and its checks (25d).  Returns the counted launches (25a-c) and each
    part's record."""
    gc.collect()
    held = torch.cuda.memory_allocated()
    large_model_memory()
    live = sorted(((o.numel() * o.element_size() / 1e9, tuple(o.shape),
                    str(o.dtype)) for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.is_cuda),
                  reverse=True)
    log(f"[lm] phase 25 starts with {held / 1e9:.2f} GB allocated by "
        f"earlier phases, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"after freeing cuBLAS's workspaces; live CUDA tensors the "
        f"collector sees: {len(live)}, {sum(t[0] for t in live):.2f} GB, "
        f"the largest {live[:5]}")
    launches: dict = {}
    rec: dict = {"train": {}}
    for arch in LM_TRAIN_ARCHS:
        with phase(f"25a {arch} training"):
            rec["train"][arch] = lm_train(arch, dev, seed, launches)
        torch.cuda.empty_cache()
    lm_not_run_notes()
    with phase(f"25d {LM_SERVE_ARCH} against the CPU ({LM_CHECK_LAYERS} "
               f"layers, f32)"):
        rec["parity"] = lm_parity(dev, seed)
    torch.cuda.empty_cache()
    with phase(f"25b-d {LM_SERVE_ARCH} prefill, decode and the bf16 check"):
        rec["serve"] = lm_serve(dev, seed, launches)
    torch.cuda.empty_cache()
    rec["launches"] = launches
    log(f"[lm] phase 25 launches {launches}")
    return rec


# --------------------------------------------------------------------------
# phase 26: the MoE LM family, trained and served
# --------------------------------------------------------------------------

def moe_cfg(arch: str, **kw):
    return dataclasses.replace(registry.get(arch).make_config(), **kw)


def route_check(what: str, got: list, want: list, seq: int) -> set:
    """Every layer's routes on the card (``got``) against the CPU's
    (``want``), in call order: expert ids, positions and kept flags
    equal.  A token whose experts differ must be a near tie (its k-th
    and (k+1)-th router logits on the CPU within MOE_ROUTE_GAP of each
    other, relatively); a token whose experts agree may differ in place
    or kept only behind such a tie in its layer.  Near ties are printed
    with their gaps; returns the batch rows (token // ``seq``) they
    touched, which the caller leaves out of its output checks."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} MoE calls on the card, {len(want)} on the "
             f"CPU")
    touched: set = set()
    for layer, (g, w) in enumerate(zip(got, want)):
        ge, gp, gk = (t.cpu() for t in g[:3])
        same_e = (ge == w.expert).all(dim=1)
        same = same_e & (gp == w.position).all(dim=1) & (
            gk == w.kept).all(dim=1)
        if bool(same.all()):
            continue
        k = ge.shape[1]
        top = torch.sort(w.logits, dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).abs() / top[:, k - 1].abs().clamp(
            min=1e-30)
        ties = torch.nonzero(~same_e)[:, 0]
        moved = torch.nonzero(~same)[:, 0]
        if not len(ties) or bool((gap[ties] > MOE_ROUTE_GAP).any()) or int(
                moved.min()) < int(ties.min()):
            bad = moved[:4].tolist()
            fail(f"{what}: call {layer} routes tokens {bad} otherwise than "
                 f"the CPU (gaps {gap[moved[:4]].tolist()}, experts "
                 f"{ge[moved[:4]].tolist()} vs {w.expert[moved[:4]].tolist()})")
        log(f"[moe] {what}: call {layer}: near ties at tokens "
            f"{ties.tolist()} (router-logit gaps {gap[ties].tolist()}), "
            f"{len(moved)} tokens routed otherwise; their rows are left out")
        touched.update((moved // seq).tolist())
    return touched


def close_rows(what: str, got, want, skip: set, rtol: float = LM_TOL,
               atol: float = LM_TOL) -> float:
    """:func:`_close` on the batch rows (dim 0) not in ``skip``."""
    keep = [i for i in range(got.shape[0]) if i not in skip]
    if not keep:
        log(f"[moe] {what}: every row touched by a near tie; not compared")
        return 0.0
    idx = torch.tensor(keep)
    return _close(what, got[idx.to(got.device)], want[idx], rtol, atol)


def moe_traced(fn, *args, **kw):
    """``fn(*args, **kw)`` and the routes of its MoE calls."""
    with moe.record_routes() as routes:
        out = fn(*args, **kw)
    return out, routes


def moe_check_olmoe(dev, seed: int) -> dict:
    """26e OLMoE: full width, MOE_CHECK_LAYERS layers, f32, B 1 x S 256
    against the CPU: logits_fn, loss_fn (xent, moe_aux), prefill_step's
    logits and caches, 8 serve steps, then one cell step as phase 24
    holds a step; every call's routes first."""
    arch = MOE_SERVE
    cfg = moe_cfg(arch, n_layers=MOE_CHECK_LAYERS[arch],
                  compute_dtype=torch.float32)
    b, s = MOE_CHECK_TRAIN
    steps = MOE_PARITY[2]
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    cpu = tree_mod.to(params, "cpu")
    ids = lm_tokens(cfg, seed + 5, b, s + steps + 1, dev)
    cids = ids.cpu()
    tok, lab = ids[:, :s], ids[:, 1:s + 1]
    what = f"26e {arch}"
    err, touched = {}, set()
    with torch.no_grad():
        (got, gm), groutes = moe_traced(tfm.loss_fn, params, cfg, tok, lab)
        (want, wm), wroutes = moe_traced(tfm.loss_fn, cpu, cfg, cids[:, :s],
                                         cids[:, 1:s + 1])
        touched |= route_check(f"{what} loss_fn", groutes, wroutes, s)
        (lg, _), groutes = moe_traced(tfm.logits_fn, params, cfg, tok)
        (wl, _), wroutes = moe_traced(tfm.logits_fn, cpu, cfg, cids[:, :s])
        touched |= route_check(f"{what} logits_fn", groutes, wroutes, s)
    err["logits_fn"] = close_rows(f"{what} logits_fn", lg, wl, touched)
    if not touched:
        err["loss_fn"] = max(_close(f"{what} {key}", gm[key], wm[key])
                             for key in ("loss", "xent", "moe_aux"))
    (logits, caches), groutes = moe_traced(tfm.prefill_step, params, cfg, tok)
    (want, cpu_caches), wroutes = moe_traced(tfm.prefill_step, cpu, cfg,
                                             cids[:, :s])
    touched |= route_check(f"{what} prefill_step", groutes, wroutes, s)
    err["prefill_step"] = max(
        close_rows(f"{what} prefill_step logits", logits, want, touched),
        close_rows(f"{what} prefill_step k", caches.k.transpose(0, 1),
                   cpu_caches.k.transpose(0, 1), touched),
        close_rows(f"{what} prefill_step v", caches.v.transpose(0, 1),
                   cpu_caches.v.transpose(0, 1), touched))
    err["serve_step"] = 0.0
    for i in range(s, s + steps):
        (got, caches), groutes = moe_traced(
            tfm.serve_step, params, cfg, caches, ids[:, i:i + 1], i)
        (want, cpu_caches), wroutes = moe_traced(
            tfm.serve_step, cpu, cfg, cpu_caches, cids[:, i:i + 1], i)
        touched |= route_check(f"{what} serve_step at {i}", groutes,
                               wroutes, 1)
        err["serve_step"] = max(err["serve_step"], close_rows(
            f"{what} serve_step at {i}", got, want, touched))
    del cpu_caches, caches
    if touched:
        log(f"[moe] {what}: the cell step is not held against the CPU "
            f"(a near tie above)")
    else:
        batch = {"tokens": tok, "labels": lab}
        err["cell_step"] = step_vs_cpu_cell(
            f"{what} ({cfg.n_layers} layers, f32, B {b}, S {s})",
            tfm.cell_loss, cfg, params, batch, cfg, cpu,
            tree_mod.to(batch, "cpu"), _same_leaves)
    log(f"[moe] 26e {arch} at full width, {cfg.n_layers} layers, f32, B {b}, "
        f"S {s}, against the CPU (rtol = atol = {LM_TOL:g}; routes of every "
        f"call first): logits_fn, loss_fn (loss, xent, moe_aux "
        f"{float(gm['moe_aux']):.6f}), prefill_step's logits and caches, "
        f"{steps} serve_steps, one cell step; largest errors {err}")
    return err


def moe_check_mixtral(dev, seed: int) -> dict:
    """26e Mixtral: full width, MOE_CHECK_LAYERS layers, f32 against the
    CPU (logits_fn, prefill_step, serve steps after it), then a window
    LM_WINDOW copy at capacity factor E/k decoded through its rolling
    cache against logits_fn at every position, on the card."""
    arch = MOE_WIDE
    cfg = moe_cfg(arch, n_layers=MOE_CHECK_LAYERS[arch],
                  compute_dtype=torch.float32)
    b, s, steps = MOE_PARITY
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    cpu = tree_mod.to(params, "cpu")
    ids = lm_tokens(cfg, seed + 6, b, s + steps, dev)
    cids = ids.cpu()
    tok = ids[:, :s]
    what = f"26e {arch}"
    err, touched = {}, set()
    with torch.no_grad():
        (lg, _), groutes = moe_traced(tfm.logits_fn, params, cfg, tok)
        (wl, _), wroutes = moe_traced(tfm.logits_fn, cpu, cfg, cids[:, :s])
    touched |= route_check(f"{what} logits_fn", groutes, wroutes, s)
    err["logits_fn"] = close_rows(f"{what} logits_fn", lg, wl, touched)
    (logits, caches), groutes = moe_traced(tfm.prefill_step, params, cfg, tok)
    (want, cpu_caches), wroutes = moe_traced(tfm.prefill_step, cpu, cfg,
                                             cids[:, :s])
    touched |= route_check(f"{what} prefill_step", groutes, wroutes, s)
    err["prefill_step"] = max(
        close_rows(f"{what} prefill_step logits", logits, want, touched),
        close_rows(f"{what} prefill_step k", caches.k.transpose(0, 1),
                   cpu_caches.k.transpose(0, 1), touched))
    err["serve_step"] = 0.0
    for i in range(s, s + steps):
        (got, caches), groutes = moe_traced(
            tfm.serve_step, params, cfg, caches, ids[:, i:i + 1], i)
        (want, cpu_caches), wroutes = moe_traced(
            tfm.serve_step, cpu, cfg, cpu_caches, cids[:, i:i + 1], i)
        touched |= route_check(f"{what} serve_step at {i}", groutes,
                               wroutes, 1)
        err["serve_step"] = max(err["serve_step"], close_rows(
            f"{what} serve_step at {i}", got, want, touched))
    del cpu, cpu_caches, caches
    wcfg = dataclasses.replace(cfg, window=LM_WINDOW,
                               capacity_factor=cfg.n_experts / cfg.moe_top_k)
    with torch.no_grad():
        full, _ = tfm.logits_fn(params, wcfg, tok)
    rolling = tfm.init_decode_caches(wcfg, b, s, device=dev)
    err["windowed"] = 0.0
    for i in range(s):
        got, rolling = tfm.serve_step(params, wcfg, rolling, tok[:, i:i + 1],
                                      i)
        err["windowed"] = max(err["windowed"], _close(
            f"{what} windowed decode at {i}", got[:, 0], full[:, i],
            LM_WINDOW_TOL, LM_WINDOW_TOL))
    log(f"[moe] 26e {arch} at full width, {cfg.n_layers} layer, f32, B {b}, "
        f"S {s}, against the CPU (rtol = atol = {LM_TOL:g}; routes first): "
        f"logits_fn, prefill_step's logits and caches, {steps} serve_steps; "
        f"window {LM_WINDOW} at capacity factor {wcfg.capacity_factor:g} "
        f"(nothing drops): rolling decode over {s} positions against "
        f"logits_fn (rtol = atol = {LM_WINDOW_TOL:g}); largest errors {err}")
    return err


def moe_check_mesh(dev, seed: int) -> dict:
    """26e: ``forward_shard_map`` over MOE_SHARD geometries of positions
    on the card, at OLMoE's layer width in f32 and capacity factor
    MOE_SHARD_CF, against ``forward`` (its aux against the mean over the
    data positions of ``forward``'s aux on each one's rows), the
    gradients of Σ out·g + aux with respect to x and every parameter
    included, within MOE_SHARD_TOL; every token's experts first."""
    cfg = registry.get(MOE_SERVE).make_config()
    e, k = cfg.n_experts, cfg.moe_top_k
    b, s = MOE_SHARD_TOKENS
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    params = moe.init(gen, cfg.d_model, cfg.d_ff, e)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev)
    g = torch.randn(b, s, cfg.d_model, generator=gen, device=dev) / (b * s)
    kw = dict(n_experts=e, top_k=k, capacity_factor=MOE_SHARD_CF)

    def run(fn):
        p = tree_mod.map(lambda t: t.detach().clone().requires_grad_(True),
                         params)
        xx = x.clone().requires_grad_(True)
        with moe.record_routes() as routes:
            out, aux, dropped = fn(p, xx)
            (torch.sum(out * g) + aux).backward()
        return (out.detach(), aux.detach(), float(dropped), xx.grad,
                [t.grad for t in tree_mod.leaves(p)], routes)

    err = {}
    for geo in MOE_SHARD:
        n_data = geo[0]

        def oracle(p, xx):
            out, st = moe.forward(p, xx, **kw)
            auxes = [moe.forward(p, blk, **kw)[1].aux_loss
                     for blk in xx.chunk(n_data)]
            return out, sum(auxes) / n_data, st.dropped_frac

        mesh = collectives.Mesh([[dev] * geo[1]] * geo[0], ("data", "model"))

        def sharded(p, xx):
            out, st = moe.forward_shard_map(p, xx, mesh=mesh, **kw)
            return out, st.aux_loss, st.dropped_frac

        want, got = run(oracle), run(sharded)
        mesh.close()
        what = f"26e forward_shard_map {geo}"
        if want[2] != 0.0 or got[2] != 0.0:
            fail(f"{what}: assignments dropped at capacity factor "
                 f"{MOE_SHARD_CF}")
        # the forward's own call comes first; positions in data order
        ref_route = want[5][0]
        by_data = sorted((r for r in got[5] if r.where[1] == 0),
                         key=lambda r: r.where[0])
        if len(by_data) != n_data:
            fail(f"{what}: {len(by_data)} data positions routed")
        mine = torch.cat([r.expert for r in by_data])
        differ = torch.nonzero((mine != ref_route.expert).any(dim=1))[:, 0]
        if len(differ):
            top = torch.sort(ref_route.logits, -1, descending=True).values
            gap = ((top[:, k - 1] - top[:, k]).abs()
                   / top[:, k - 1].abs())[differ]
            if bool((gap > MOE_ROUTE_GAP).any()):
                fail(f"{what}: tokens {differ[:4].tolist()} routed otherwise "
                     f"than forward (gaps {gap[:4].tolist()})")
            log(f"[moe] {what}: near ties at {differ.tolist()} (gaps "
                f"{gap.tolist()}); outputs and gradients not compared")
            continue
        err[str(geo)] = max(
            _close(f"{what} {name}", a, bb, MOE_SHARD_TOL, MOE_SHARD_TOL)
            for name, a, bb in [("out", got[0], want[0]),
                                ("aux", got[1], want[1]),
                                ("d x", got[3], want[3])]
            + [(f"d {p}", a, bb) for (p, _), a, bb in zip(
                tree_mod.leaves_with_paths(params), got[4], want[4])])
    log(f"[moe] 26e forward_shard_map over {MOE_SHARD} positions of the card "
        f"at OLMoE's layer width (d {cfg.d_model}, d_ff {cfg.d_ff}, E {e}, "
        f"k {k}), f32, B {b} x S {s}, capacity factor {MOE_SHARD_CF:g}, "
        f"against forward (rtol = atol = {MOE_SHARD_TOL:g}): out, aux, the "
        f"gradients of x and every parameter; largest errors {err}")
    return err


def moe_prefill(arch: str, cfg, params, dev, seed: int, launches: dict,
                base: int) -> dict:
    """26a / 26d: ``prefill_step`` at prefill_32k's S, B MOE_PREFILL_B."""
    shape = rec_shapes.LM_SHAPES["prefill_32k"]
    tokens = lm_tokens(cfg, seed + 3, MOE_PREFILL_B, shape.seq_len, dev)
    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    with counted(counts), moe.record_routes() as routes:
        t0 = time.perf_counter()
        logits, caches = tfm.prefill_step(params, cfg, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if counts["flash_attention"] != cfg.n_layers or not bool(
            torch.isfinite(logits).all()):
        fail(f"{arch} prefill: {counts['flash_attention']} flash launches "
             f"(not {cfg.n_layers}), logits finite: "
             f"{bool(torch.isfinite(logits).all())}")
    _add(launches, counts)
    dropped = 1.0 - float(torch.stack([r.kept.float().mean()
                                       for r in routes]).mean())
    n_tok = MOE_PREFILL_B * shape.seq_len
    cap = moe.capacity_for(n_tok, cfg.moe_top_k, cfg.capacity_factor,
                           cfg.n_experts)
    log(f"[moe] {arch} prefill_step ({cfg.n_layers} layers) at prefill_32k's "
        f"S {shape.seq_len:,}, B {MOE_PREFILL_B} (cut from "
        f"{shape.global_batch}), capacity {cap:,} an expert: {ms:.1f} ms, "
        f"{n_tok / ms * 1e3:,.0f} tokens/s, peak {peak:.2f} GB above the "
        f"weights, {counts['flash_attention']} flash launches, dropped share "
        f"{dropped:.4f} over the layers; caches {tuple(caches.k.shape)} bf16")
    return dict(prefill_ms=ms, prefill_peak_gb=peak, prefill_dropped=dropped)


def moe_decode(arch: str, cfg, params, dev, seed: int, launches: dict,
               base: int, profile: bool) -> dict:
    """26b / 26d: ``prefill_step`` at B x prefix, then greedy
    ``serve_step`` calls; the dropped share of one decode batch read off
    layer 0's routes of the first step."""
    b, s0, steps = MOE_DECODE
    ids = lm_tokens(cfg, seed + 4, b, s0, dev)
    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    rec = {}
    with counted(counts):
        t0 = time.perf_counter()
        last, caches = tfm.prefill_step(params, cfg, ids)
        torch.cuda.synchronize()
        rec["decode_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        tok = last.argmax(-1)
        pos = torch.tensor(s0, device=dev)
        t0 = time.perf_counter()
        for i in range(steps):
            if i == 0:
                with moe.record_routes() as routes:
                    step_logits, caches = tfm.serve_step(params, cfg, caches,
                                                         tok, pos)
                first = step_logits
            else:
                step_logits, caches = tfm.serve_step(params, cfg, caches,
                                                     tok, pos)
            tok, pos = step_logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        rec["token_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    rec["decode_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    if counts["flash_attention"] != cfg.n_layers or not bool(
            torch.isfinite(first).all()):
        fail(f"{arch} decode: {counts['flash_attention']} flash launches "
             f"(not {cfg.n_layers} for the prefill, none a decode step)")
    _add(launches, counts)
    kept = routes[0].kept
    rec["decode_dropped"] = 1.0 - float(kept.float().mean())
    cap = moe.capacity_for(b, cfg.moe_top_k, cfg.capacity_factor,
                           cfg.n_experts)
    log(f"[moe] {arch} decode ({cfg.n_layers} layers): prefill_step B {b} x "
        f"{s0:,} in {rec['decode_prefill_ms']:.1f} ms, then {steps} greedy "
        f"serve_steps: {rec['token_ms']:.3f} ms a step for all {b} "
        f"sequences, {b / rec['token_ms'] * 1e3:,.1f} tokens/s; a decode "
        f"batch routes {b} x {cfg.moe_top_k} assignments at capacity {cap} "
        f"an expert: layer 0 of the first step drops "
        f"{rec['decode_dropped']:.4f} of them; peak "
        f"{rec['decode_peak_gb']:.2f} GB above the weights")
    if profile:
        profile_call(lambda: tfm.serve_step(params, cfg, caches, tok, pos),
                     f"26b {arch} one decode step (B {b})", warm=False)
    return rec


def moe_serve(arch: str, n_layers: int, dev, seed: int, launches: dict,
              profile: bool) -> dict:
    """26a-b / 26d: ``arch`` at make_config() and ``n_layers`` layers
    (fp32 weights from ``seed`` on the card): the 32k prefill, then
    decode."""
    cfg = moe_cfg(arch, n_layers=n_layers)
    before = torch.cuda.memory_allocated()
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    rec = dict(weights_gb=(base - before) / 1e9, n_layers=n_layers)
    log(f"[moe] {arch} serving: {n_layers} of {registry.get(arch).make_config().n_layers} layers, "
        f"{cfg.n_params() / 1e9:.3f} B params ({rec['weights_gb']:.1f} GB "
        f"fp32 on the card), bf16 compute")
    rec.update(moe_prefill(arch, cfg, params, dev, seed, launches, base))
    torch.cuda.empty_cache()
    rec.update(moe_decode(arch, cfg, params, dev, seed, launches, base,
                          profile))
    del params
    torch.cuda.empty_cache()
    return rec


def moe_train(arch: str, dev, seed: int, launches: dict,
              profile: bool) -> dict:
    """26c / 26d: ``arch``'s training cell at make_config() and train_4k's
    S, depth cut to MOE_TRAIN_LAYERS and B to MOE_TRAIN_B:
    TRAIN_CELL_STEPS steps in place as a counted run, then one no-grad
    loss_fn for the moe_aux and the dropped share, and one profiled
    step."""
    cfg = moe_cfg(arch, n_layers=MOE_TRAIN_LAYERS[arch])
    shape = rec_shapes.LM_SHAPES["train_4k"]
    b, s = MOE_TRAIN_B[arch], shape.seq_len
    base = torch.cuda.memory_allocated()
    params = tfm.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    batch = lm_batch(cfg, seed, b, s, dev)
    rec = cell_steps(tfm.cell_loss, cfg, params, batch, base)
    _add(launches, rec["counts"])
    flash = rec["launches"]["flash_attention"]
    if flash != 2 * cfg.n_layers:
        fail(f"26c {arch}: {flash:g} flash_attention launches a step, not "
             f"{2 * cfg.n_layers} (forward and remat recompute)")
    with torch.no_grad(), moe.record_routes() as routes:
        _, metrics = tfm.cell_loss(params, cfg, batch)
    dropped = [1.0 - float(r.kept.float().mean()) for r in routes]
    step_s = rec["step_ms"] / 1e3
    tok_s = b * s / step_s
    mfu = 6 * cfg.n_active_params() * b * s / step_s / PEAK_BF16_FLOPS
    if profile:
        profile_call(lambda: train.cell_step(
            tfm.cell_loss, cfg, params, optim.adam_init(params), batch),
            f"26c {arch} one training step (B {b}, S {s})", warm=False)
    log(f"[moe] 26c {arch} (make_config at {cfg.n_layers} of "
        f"{registry.get(arch).make_config().n_layers} layers: d "
        f"{cfg.d_model}, E {cfg.n_experts} top-{cfg.moe_top_k}, d_ff "
        f"{cfg.d_ff}, {cfg.n_params() / 1e9:.3f} B params, "
        f"{cfg.n_active_params() / 1e9:.3f} B active, bf16 compute, fp32 "
        f"params and AdamW in place, remat) at train_4k's S {s}, B {b} (cut "
        f"from {shape.global_batch}): loss "
        f"{[round(x, 6) for x in rec['losses']]}, grad norm "
        f"{[round(x, 6) for x in rec['norms']]}; after them xent "
        f"{float(metrics['xent']):.6f}, moe_aux "
        f"{float(metrics['moe_aux']):.6f}, dropped share by layer "
        f"{[round(x, 4) for x in dropped]}; {rec['step_ms']:.1f} ms a step "
        f"(median of steps 2-{TRAIN_CELL_STEPS}), {tok_s:,.0f} tokens/s, "
        f"model-FLOP share {mfu:.1%} (6 x active params x tokens over "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense); peak "
        f"{rec['peak_gb']:.2f} GB above {base / 1e9:.2f}; flash_attention "
        f"{flash:g} a step")
    del params, batch
    torch.cuda.empty_cache()
    return dict(rec, b=b, s=s, n_layers=cfg.n_layers, tok_s=tok_s, mfu=mfu,
                moe_aux=float(metrics["moe_aux"]), dropped=dropped)


def flash_window_times(timer, dev) -> dict:
    """26f: ``flash_attention`` at Mixtral's windowed shape
    (MOE_WINDOW_ATTN: B, S, Hq, Hkv, d, window; bf16, causal), held
    against its plain version (query rows in Q_CHUNK blocks) and timed
    beside its bound at the bf16 tensor-core peak, SDPA (the window as a
    boolean mask) and the plain version."""
    b, s_len, hq, hkv, d, w = MOE_WINDOW_ATTN
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _bshd(gen, dev, b, s_len, hq, d, torch.bfloat16)
    k, v = (_bshd(gen, dev, b, s_len, hkv, d, torch.bfloat16)
            for _ in range(2))
    pairs = sum(min(i + 1, w) for i in range(s_len))    # live (q, k) pairs
    flops = 4.0 * b * hq * pairs * d
    nbytes = 2.0 * b * s_len * d * (2 * hq + 2 * hkv) + 4.0 * b * hq * s_len
    bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    out = dict(max_abs_err=check_flash(q, k, v, True, w,
                                       f"at Mixtral's window {w}",
                                       q_chunk=fa_ops.Q_CHUNK))
    i = torch.arange(s_len, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out.update(
        ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, True, w),
                    reps=10),
        library_ms=timer.ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                         enable_gqa=True), reps=10),
        plain_ms=timer.ms(lambda: fa_ref.flash_attention(
            q, k, v, True, w, q_chunk=fa_ops.Q_CHUNK), reps=3),
        bound_ms=bms, bound_by=by, b=b, s=s_len, hq=hq, hkv=hkv, d=d,
        window=w)
    log(f"[times] flash_attention at Mixtral's windowed shape "
        f"{(b, s_len, hq, hkv, d)} (B, S, Hq, Hkv, d; bf16, causal, window "
        f"{w}; {fa_ops.instance_name(d, torch.bfloat16)}): kernel "
        f"{out['ms']:.3f} ms, library (SDPA, boolean mask) "
        f"{out['library_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms (out "
        f"within {FLASH_TOL[torch.bfloat16]} of it: max abs err "
        f"{out['max_abs_err']:.3g}), bound {bms:.3f} ms ({by}, {pairs:,} live "
        f"pairs a head at the bf16 tensor-core peak), bound / kernel "
        f"{bms / out['ms']:.1%} of the bf16 bound")
    return out


def moe_long_500k_note() -> None:
    cfg = registry.get(MOE_WIDE).make_config()
    shape = rec_shapes.LM_SHAPES["long_500k"]
    n = shape.seq_len * shape.global_batch
    cap = moe.capacity_for(n, cfg.moe_top_k, cfg.capacity_factor,
                           cfg.n_experts)
    plane = cfg.n_experts * cap * cfg.d_ff * 4
    log(f"[moe] {MOE_WIDE} long_500k not run: a {n:,}-token prefill routes "
        f"at capacity {cap:,} an expert, so each (E, C, d_ff) f32 gate and "
        f"up plane of one MoE layer is {plane / 1e9:.0f} GB; the reference "
        f"lowers only a decode step there (ROADMAP A6 item 6)")


def moe_phase(dev, seed: int) -> dict:
    """Phase 26: the MoE LM family, checked (26e), trained (26c, 26d) and
    served (26a-b, 26d), and flash_attention at its shapes (26f).
    Returns the counted launches and each part's record."""
    large_model_memory()
    launches: dict = {}
    rec: dict = {}
    with phase("26e the MoE layer and the MoE LMs against the CPU"):
        rec["check"] = dict(olmoe=moe_check_olmoe(dev, seed),
                            mixtral=moe_check_mixtral(dev, seed),
                            mesh=moe_check_mesh(dev, seed))
    torch.cuda.empty_cache()
    with phase(f"26c {MOE_SERVE} training"):
        rec["train"] = {MOE_SERVE: moe_train(MOE_SERVE, dev, seed, launches,
                                             profile=True)}
    with phase("26f flash_attention at the MoE shapes"):
        t = rec["train"][MOE_SERVE]
        cfg = registry.get(MOE_SERVE).make_config()
        timer = Timer()
        rec["flash"] = {
            "olmoe_train": dict(flash_causal_times(
                timer, f"{MOE_SERVE}'s train_4k shape", t["b"], t["s"],
                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dev, plain=True),
                b=t["b"], s=t["s"], hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                d=cfg.head_dim),
            "mixtral_window": flash_window_times(timer, dev)}
        del timer
    torch.cuda.empty_cache()
    with phase(f"26a-b {MOE_SERVE} prefill and decode (full depth)"):
        rec["serve"] = {MOE_SERVE: moe_serve(
            MOE_SERVE, registry.get(MOE_SERVE).make_config().n_layers, dev,
            seed, launches, profile=True)}
    wide: dict = {}
    with phase(f"26d {MOE_WIDE} prefill and decode ({MOE_WIDE_LAYERS} "
               f"layers)"):
        rec["serve"][MOE_WIDE] = moe_serve(MOE_WIDE, MOE_WIDE_LAYERS, dev,
                                           seed, wide, profile=False)
    with phase(f"26d {MOE_WIDE} training"):
        rec["train"][MOE_WIDE] = moe_train(MOE_WIDE, dev, seed, wide,
                                           profile=False)
    _add(launches, wide)
    rec["wide_flash_launches"] = wide.get("flash_attention", 0)
    moe_long_500k_note()
    rec["launches"] = launches
    log(f"[moe] phase 26 launches {launches}")
    return rec


def dry_cases(dev) -> list:
    """27a's cells: (arch, shape, mesh, config, shape override); the
    OLMoE step cut to DRY_TRAIN's layers and batch for both runs."""
    arch, shape_name, layers, b = DRY_TRAIN
    lm = registry.get(arch)
    lm_shape = dataclasses.replace(lm.shapes[shape_name], global_batch=b)
    lm_cfg = dataclasses.replace(lm.make_config(lm_shape), n_layers=layers)
    mesh = mesh_mod.make_host_mesh(*DRY_SHARD_MESH,
                                   devices=[dev] * int(np.prod(
                                       DRY_SHARD_MESH)))
    return [(arch, shape_name, None, lm_cfg, lm_shape),
            ("sasrec", "serve_bulk", None, None, None),
            ("hi2-synth", "serve_msmarco_bucket8", None, None, None),
            ("hi2-synth", "serve_msmarco_refine_sq8", mesh, None, None)]


def _leaf_specs(out) -> list:
    """(path, shape, dtype) of each output tensor, dicts by sorted key
    (a fake cell's parameter dicts are rebuilt in that order)."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        out = list(out)
    return [(path, tuple(t.shape), t.dtype)
            for path, t in tree_mod.leaves_with_paths(out)]


def fake_vs_real(dev, seed: int, arch: str, shape_name: str, mesh, cfg,
                 shape) -> dict:
    """One 27a cell on fake CUDA tensors and really on the card (leaves
    drawn from ``seed``), both counted: FLOPs and argument bytes equal
    exactly, the outputs' shapes and dtypes equal, the fake peak within
    DRY_MEM_TOL of ``max_memory_allocated`` above the start."""
    name = f"{arch}/{shape_name}"
    t0 = time.perf_counter()
    fake = dry_cells.execute(dry_cells.build_cell(
        arch, shape_name, mesh, device=dev, config=cfg, shape=shape))
    t_fake = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated(dev)
    cell = dry_cells.build_cell(arch, shape_name, mesh, device=dev,
                                fake=False, seed=seed, config=cfg,
                                shape=shape)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    real = dry_cells.execute(cell)
    peak = torch.cuda.max_memory_allocated(dev) - start
    err = abs(fake.memory["peak"] - peak) / peak
    rec = dict(flops=fake.count.flops, real_flops=real.count.flops,
               argument=fake.memory["argument"],
               real_argument=real.memory["argument"],
               fake_peak_gb=fake.memory["peak"] / 1e9,
               real_peak_gb=peak / 1e9, counted_real_peak_gb=real.memory[
                   "peak"] / 1e9, mem_err=err, fake_s=t_fake,
               real_s=real.seconds, kernels={
                   k: v["calls"] for k, v in fake.count.kernels.items()})
    log(f"[dryrun] 27a {name}: FLOPs fake {rec['flops']:,} real "
        f"{rec['real_flops']:,}; argument bytes fake {rec['argument']:,} "
        f"real {rec['real_argument']:,}; peak fake "
        f"{rec['fake_peak_gb']:.3f} GB, card {rec['real_peak_gb']:.3f} GB "
        f"(max_memory_allocated above the start; the counter saw "
        f"{rec['counted_real_peak_gb']:.3f} GB), error {100 * err:.2f}%; "
        f"fake step {t_fake:.2f} s, real {real.seconds:.2f} s; kernel "
        f"calls {rec['kernels']}")
    if rec["flops"] != rec["real_flops"]:
        fail(f"27a {name}: fake FLOPs {rec['flops']} != real "
             f"{rec['real_flops']}")
    if rec["argument"] != rec["real_argument"]:
        fail(f"27a {name}: argument bytes differ")
    if _leaf_specs(fake.out) != _leaf_specs(real.out):
        fail(f"27a {name}: outputs differ: {_leaf_specs(fake.out)} vs "
             f"{_leaf_specs(real.out)}")
    if err > DRY_MEM_TOL:
        fail(f"27a {name}: fake peak {rec['fake_peak_gb']:.3f} GB vs the "
             f"card's {rec['real_peak_gb']:.3f} GB")
    del fake, real, cell
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dryrun_cli(dev) -> dict:
    """27b: ``python -m repro_torch.launch.dryrun`` on the cells no phase
    runs whole; every record must be ``ok``."""
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in DRY_CLI:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--extra",
               "--device", str(dev), "--out", str(DRY_OUT), "--arch", arch]
        cmd += ["--shape", shape] if shape else []
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        log(proc.stdout.strip())
        if proc.returncode:
            fail(f"27b {' '.join(cmd[2:])} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
    recs = {}
    for rec in dry_report.load_records(str(DRY_OUT), "sp"):
        if rec["status"] != "ok":
            fail(f"27b {rec['cell']}: {rec['status']} "
                 f"{rec.get('error', rec.get('reason', ''))}")
        row = dry_report.roofline_row(rec)
        recs[rec["cell"]] = dict(
            per_device_gb=rec["memory"]["per_device_gb"], fits=rec["fits"],
            flops=rec["cost"]["flops"], dominant=row["dominant"],
            seconds=rec["seconds"])
        log(f"[dryrun] 27b {rec['cell']}: {json.dumps(recs[rec['cell']])}")
    if len(recs) != 10:
        fail(f"27b: {len(recs)} records, want 10: {sorted(recs)}")
    return recs


def dryrun_phase(dev, seed: int) -> dict:
    """Phase 27: the dry run held against real steps on the card (27a),
    then run through its CLI on the cells no phase runs whole (27b)."""
    gc.collect()
    torch.cuda.empty_cache()
    differ = []
    for kname, mirrored, got in (
            ("topk_scores", at_ops.HOPPER_TILES,
             at_ops.tiles(_build.library("topk_scores"))),
            ("sq8_dot_fused", sq8_ops.HOPPER_TILES,
             sq8_ops.tiles(_build.library("sq8_dot_fused")))):
        log(f"[dryrun] {kname} tiles {got}; the fake path's {mirrored}")
        if got != mirrored:
            differ.append(kname)
    if differ:
        fail(f"{differ}: the fake paths' tiles differ from the built "
             f"libraries'")
    rec: dict = {"fake_vs_real": {}}
    with phase("27a the dry run's fake steps against real steps"):
        for arch, shape_name, mesh, cfg, shape in dry_cases(dev):
            rec["fake_vs_real"][f"{arch}/{shape_name}"] = fake_vs_real(
                dev, seed, arch, shape_name, mesh, cfg, shape)
            if mesh is not None:
                mesh.close()
    with phase("27b python -m repro_torch.launch.dryrun"):
        rec["cli"] = dryrun_cli(dev)
    return rec


# --------------------------------------------------------------------------
# phase 28: the bench driver and the regression gate, in fresh processes
# --------------------------------------------------------------------------

def run_sub(what: str, args: list, timeout: int) -> tuple:
    """``python -m repro_torch.benchmarks.<args>`` in a session of its own
    (return code, stdout, stderr); past ``timeout`` the whole session,
    the driver's own subprocesses included, is killed and the phase
    fails with what it printed."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.benchmarks.{args[0]}",
         *args[1:]], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"28 {what}: no exit within {timeout} s; stdout "
             f"{out[-3000:]} stderr {err[-3000:]}")
    return proc.returncode, out, err


def timed_sub(what: str, args: list, timeout: int) -> tuple:
    """:func:`run_sub` and its seconds."""
    t0 = time.perf_counter()
    return (*run_sub(what, args, timeout), time.perf_counter() - t0)


def start_driver(pool) -> dict:
    """28a's processes, started before phase 27 and run beside it:
    ``run --list`` and the driver's whole suite; futures of
    :func:`timed_sub`.  Phase 27's checks hold no time and read only this
    process's memory, and 28a's hold no time either, so neither bends the
    other's checks; both print seconds of a shared card and host."""
    return {"list": pool.submit(timed_sub, "run --list", ["run", "--list"],
                                120),
            "driver": pool.submit(timed_sub, "run --device cuda",
                                  ["run", "--device", "cuda"],
                                  BENCH_DRIVER_S)}


def bench_driver(futs: dict) -> dict:
    """28a: ``run --list`` named the reference's 14 benchmarks; the whole
    suite on the card printed each of the reference's rows once, and no
    flag that a ``--check`` contract requires reads False."""
    code, out, err, _ = futs["list"].result()
    if code or out.split() != sorted(BENCH_NAMES):
        fail(f"28a run --list exited {code}: {out.split()} {err[-2000:]}")
    code, out, err, seconds = futs["driver"].result()
    log(out.strip())
    if code:
        fail(f"28a run --device cuda exited {code}: {err[-4000:]}")
    lines = out.strip().splitlines()
    if lines[0] != "name,us_per_call,derived":
        fail(f"28a header {lines[0]!r}")
    rows = [line.split(",", 2) for line in lines[1:]]
    names = [r[0] for r in rows]
    wrong = sorted({n for n in set(names) | set(BENCH_ROWS)
                    if names.count(n) != (n in BENCH_ROWS)})
    if wrong:
        fail(f"28a rows not printed exactly once, or not the "
             f"reference's: {wrong}")
    false = [f"{name}: {kv}" for name, _, derived in rows
             for kv in derived.split(";")
             if kv.partition("=")[0] in BENCH_REQUIRED
             and kv.partition("=")[2] != "True"]
    if false:
        fail(f"28a required flags not True: {false}")
    log(f"[bench] 28a {len(rows)} rows, {len(set(names))} names; the "
        f"driver's run {seconds:.1f} s")
    return {"rows": len(rows), "seconds": seconds}


def _timing_ratios(a, b, path: str = "$", key: str = "") -> dict:
    """max/min of every wall-clock leaf of two reports of one bench."""
    if isinstance(a, dict):
        return {k: v for k2 in a for k, v in _timing_ratios(
            a[k2], b[k2], f"{path}.{k2}", k2).items()}
    if isinstance(a, list):
        return {k: v for i, (x, y) in enumerate(zip(a, b))
                for k, v in _timing_ratios(x, y, f"{path}[{i}]", key)
                .items()}
    if (isinstance(a, (int, float)) and not isinstance(a, bool)
            and check_regression.timing_direction(key) and min(a, b) > 0):
        return {path: max(a, b) / min(a, b)}
    return {}


def bench_gate() -> dict:
    """28b: three benchmarks run twice, into ``build/bench_gate/{a,b}``,
    one process after another with nothing else on the card, so the
    wall-clock fields' max/min ratios are run-to-run repeatability.  The
    gate holds run b to run a (every exact field bit-equal, timing
    unbounded) and, at the same time, a copy of b with one exact field
    moved by one ulp, which it must refuse, naming the field."""
    shutil.rmtree(BENCH_GATE, ignore_errors=True)
    secs = {}
    for run in "ab":
        for mod, args, fname in BENCH_GATE_RUNS:
            what = f"{mod} ({run})"
            code, _, err, secs[what] = timed_sub(
                what, [mod, *args, "--device", "cuda", "--out",
                       str(BENCH_GATE / run / fname)], BENCH_ONE_S)
            if code:
                fail(f"28b {what} exited {code}: {err[-3000:]}")
    log(f"[bench] 28b benchmark processes, one after another, seconds: "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    shutil.copytree(BENCH_GATE / "b", BENCH_GATE / "c")
    codec = json.loads((BENCH_GATE / "c" / "BENCH_codec.json").read_text())
    codec["rows"][0]["R@100"] = math.nextafter(codec["rows"][0]["R@100"],
                                               math.inf)
    (BENCH_GATE / "c" / "BENCH_codec.json").write_text(json.dumps(codec))
    files = [fname for _, _, fname in BENCH_GATE_RUNS]
    gate = ["check_regression", "--baseline-dir", str(BENCH_GATE / "a"),
            "--files", *files, "--timing-ratio", "inf", "--fresh-dir"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        same, ulp = (pool.submit(run_sub, f"check_regression (a, {run})",
                                 gate + [str(BENCH_GATE / run)], 60)
                     for run in "bc")
        code, out, err = same.result()
        ulp_code, _, ulp_err = ulp.result()
    log(f"[bench] 28b gate a -> b: exit {code}; {out.strip()}{err.strip()}")
    if code:
        fail(f"28b an exact field differs between two processes: {err}")
    ratios = {}
    for fname in files:
        a, b = (json.loads((BENCH_GATE / run / fname).read_text())
                for run in "ab")
        for path, r in _timing_ratios(a, b).items():
            ratios[f"{fname} {path}"] = r
            log(f"[bench] 28b {fname} {path}: max/min of the two runs "
                f"{r:.3f}")
    worst = max(ratios, key=ratios.get)
    log(f"[bench] 28b largest wall-clock ratio {ratios[worst]:.3f} "
        f"({worst}; two processes, nothing else on the card)")
    log(f"[bench] 28b gate a -> c (one ulp): exit {ulp_code}; "
        f"{ulp_err.strip()}")
    want = "BENCH_codec.json $.rows[0].R@100:"
    if ulp_code != 1 or want not in ulp_err or ulp_err.count("\n  ") != 1:
        fail(f"28b the gate took a one-ulp drift: exit {ulp_code}, "
             f"{ulp_err!r}")
    shutil.rmtree(BENCH_GATE)
    return {"largest_ratio": ratios[worst], "at": worst}


def bench_phase(futs: dict) -> dict:
    """Phase 28: the port's bench driver over the whole suite (28a,
    started by :func:`start_driver` before phase 27) and its regression
    gate over two runs of three benchmarks (28b, after it), every one in
    fresh processes on the card.  Their kernels launch in those
    processes, so none of their launches is in the ``kernels`` line."""
    rec = {}
    with phase("28a python -m repro_torch.benchmarks.run"):
        rec["driver"] = bench_driver(futs)
    with phase("28b two runs held by check_regression"):
        rec["gate"] = bench_gate()
    return rec


def run_kernel_bench() -> dict:
    """Phase 14: the port's ``kernel_bench`` at its full shapes with
    ``--check`` semantics, as a counted run: the main path of ``pq_adc``
    (its unfused section), which must launch every kernel it compares.
    Returns the launches."""
    reset_counts()
    report = kernel_bench.run(kernel_bench.parse_args(["--check"]))
    torch.cuda.synchronize()
    launches = read_counts()
    log(json.dumps(report, sort_keys=True))
    log(f"[kernel_bench] launches {launches}")
    if report["backend"] != "cuda" or report["interpret_mode"]:
        fail("kernel_bench did not run the kernels on the card")
    if report["check_failures"]:
        fail(f"kernel_bench: {report['check_failures']}")
    missing = [k for k in ("pq_adc", "pq_adc_fused", "sq8_dot_fused",
                           "topk_scores") if launches[k] < 1]
    if missing:
        fail(f"kernel_bench never launched {missing}")
    return launches


SOURCES = {   # kernel → (CUDA source, the TPU kernel's pallas_call)
    "pq_adc_fused": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc_fused.cu",
                     "src/repro/kernels/pq_adc/kernel.py:163"),
    "pq_adc": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc/kernel.py:58"),
    "topk_scores": ("src/repro_torch/kernels/assign_topk/csrc/"
                    "topk_scores.cu",
                    "src/repro/kernels/assign_topk/kernel.py:124"),
    "sq8_dot_fused": ("src/repro_torch/kernels/sq8_dot/csrc/"
                      "sq8_dot_fused.cu",
                      "src/repro/kernels/sq8_dot/kernel.py:79"),
    "assign_argmax": ("src/repro_torch/kernels/assign_topk/csrc/"
                      "assign_argmax.cu",
                      "src/repro/kernels/assign_topk/kernel.py:156"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:117"),
}


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=SMOKE_BATCHES,
                    help="256-query batches served in each counted run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    # the ~170,000 objects the imports made never die; frozen, a full
    # collection scans only what the run makes later.  Unfrozen, one
    # takes tens of ms, and where the allocation count lands one inside
    # a runtime check's burst of submissions it splits the burst past
    # its linger (phase 16's one batch a bucket)
    gc.freeze()
    t_start = time.perf_counter()
    # phase 10's corpus is made on the host beside phases 3-9
    corpus_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    corpus_job = corpus_pool.submit(write_corpus, args.seed)
    with phase("1 card"):
        name = card()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    # phase 2's nvcc processes run while the host synthesizes phase 3's
    # planes (no kernel runs there); the build is joined before phase 4
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t_build = time.perf_counter()
        build = pool.submit(build_kernels)
        with phase("3 index (opq)"):
            rng = np.random.default_rng(args.seed)
            leaves = synth_leaves(rng)
            qe_all, qt_all = synth_queries(rng, BATCH * args.batches)
            qrels = plant_positives(leaves, qe_all)
            index = ckpt.index_from_numpy(leaves, "opq", device=dev)
            torch.cuda.synchronize()
            log(f"[index] "
                f"{sum(a.nbytes for a in leaves.values()) / 1e9:.3f} GB on "
                f"the card; budget {hi.candidate_budget(index, KC, K2)} "
                f"slots/query")
        build.result()
        log(f"[seconds] 2 build kernels (beside phase 3): "
            f"{time.perf_counter() - t_build:.1f} s")
    with phase("4 parity"):
        errs = parity_edges(dev, np.random.default_rng(args.seed + 1))
        qe0 = torch.from_numpy(qe_all[:BATCH]).to(dev)
        qt0 = torch.from_numpy(qt_all[:BATCH]).to(dev).long()
        inp = main_path_inputs(index, qe0, qt0)
        parity_full_width(inp, errs)
    with phase("5 serving (opq)"):
        server, results, opq_launches = serve_batches(
            index, dev, qe_all, qt_all, args.batches,
            ("pq_adc_fused", "topk_scores"), "serve_msmarco (opq)")
        check_planted(results, qrels, "opq")
    with phase("5b pq_adc (unfused) at full width"):
        times = unfused_at_width(inp, errs)
    with phase("6 check (opq)"):
        cpu_index = ckpt.index_from_numpy(leaves, "opq", device="cpu")
        check_cpu(cpu_index, qe_all[:N_CHECK], qt_all[:N_CHECK], inp,
                  results[0], ADC_TOL)
    with phase("7 times (opq)"):
        times.update(time_kernels(inp))
    with phase("8 profile (opq)"):
        profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])
    with phase(f"8b serving (opq, fused at {FUSION_WEIGHT})"):
        fserver, _, _ = serve_batches(
            index, dev, qe_all, qt_all, args.batches,
            ("pq_adc_fused", "topk_scores"),
            f"serve_msmarco fused (opq, weight {FUSION_WEIGHT})",
            fusion_weight=FUSION_WEIGHT)
    with phase("8c check (fused)"):
        check_fused(fserver, cpu_index, leaves, qe_all, qt_all, results)
    with phase("8d profile (fused)"):
        fserver.set_fusion(FUSION_WEIGHT)
        profile_batch(fserver, qe_all[:BATCH], qt_all[:BATCH])
    with phase("16a runtime (opq, dense and fused)"):
        runtime_phase(index, dev, qe_all, qt_all,
                      ("pq_adc_fused", "topk_scores"), throughput=True)
    with phase("20a sharded serving (opq, S = 2 and 4 on one card)"):
        fserver.set_fusion(FUSION_WEIGHT)
        fused = [fserver.query(qe_all[i * BATCH:(i + 1) * BATCH],
                               qt_all[i * BATCH:(i + 1) * BATCH])
                 for i in range(args.batches)]
        mesh_launches = sharded_phase(
            index, dev, qe_all, qt_all, results,
            ("pq_adc_fused", "topk_scores"), "20a serve_msmarco (opq)",
            fused=fused)
        del fused
    mesh_rt_launches = mesh_runtime_phase(index, dev, qe_all, qt_all,
                                          results)
    del server, fserver, results, leaves, inp, cpu_index

    with phase("9a refine index (refine:sq8:4)"):
        rindex, rqrels = refine_index(index, dev, args.seed, qe_all)
        del index
        torch.cuda.synchronize()
        log(f"[refine] codes {tuple(rindex.doc_planes['codes'].shape)} "
            f"uint8 + refine_emb fp16: "
            f"{sum(p.nbytes for p in rindex.doc_planes.values()) / 1e9:.2f}"
            f" GB on the card; candidate cost "
            f"{hi.candidate_cost(rindex, KC, K2, TOP_R)}")
    with phase("9b parity (sq8_dot_fused, full width)"):
        rinp = main_path_inputs(rindex, qe0, qt0)
        parity_full_width_sq8(rinp, errs)
    with phase("9c serving (refine:sq8:4)"):
        server, results, refine_launches = serve_batches(
            rindex, dev, qe_all, qt_all, args.batches,
            ("sq8_dot_fused", "topk_scores"),
            "serve_msmarco_refine_sq8 (refine:sq8:4)")
        check_planted(results, rqrels, REFINE_CODEC)
    with phase("9d check (refine:sq8:4)"):
        cpu_index = rindex.to("cpu")
        check_cpu(cpu_index, qe_all[:N_CHECK], qt_all[:N_CHECK], rinp,
                  results[0], SQ8_TOL)
        del cpu_index
    with phase("9e times (sq8_dot_fused)"):
        times.update(time_sq8(rinp))
    with phase("9f profile (refine:sq8:4)"):
        profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])
    with phase("16b runtime (refine:sq8:4, dense and fused)"):
        runtime_phase(rindex, dev, qe_all, qt_all,
                      ("sq8_dot_fused", "topk_scores"), throughput=False)
    del server, rinp
    torch.cuda.empty_cache()
    with phase("20b sharded serving (refine:sq8:4, S = 4 on one card)"):
        _add(mesh_launches, sharded_phase(
            rindex, dev, qe_all, qt_all, results,
            ("sq8_dot_fused", "topk_scores"),
            "20b serve_msmarco_refine_sq8 (refine:sq8:4)", shards=(4,)))
    del results, rindex
    torch.cuda.empty_cache()

    with phase("10 build on the card"):
        built = build_on_card(dev, args.seed, corpus_job)
    corpus_pool.shutdown()
    mine_index = built["indexes"]["opq"]      # 18c mines its negatives
    with phase("17 the width tuner"):
        tuner_phase(dev, built)
    with phase("11a parity (flash_attention)"):
        errs["flash_attention"] = flash_parity(dev, args.seed + 2)
    with phase("11b parity (assign_argmax)"):
        errs["assign_argmax"] = assign_parity(
            dev, args.seed + 3, built["emb"], built["cluster_sel"].embeddings)
    with phase("12 HI²_sup path"):
        sup_launches, flash_in = sup_path(dev, args.seed, built)
    with phase("13 times (flash_attention, assign_argmax)"):
        times.update(time_new_kernels(flash_in, built["emb"],
                                      built["cluster_sel"].embeddings))
    with phase("14 kernel_bench (counted)"):
        bench_launches = run_kernel_bench()
    with phase("15 mutable index"):
        mutable_rec = mutable_phase(dev, built, args.seed,
                                    BUILD_QUERIES // BATCH)
    with phase("21b sharded mutable serving (opq, S = 4 and (2, 2))"):
        _add(mesh_rt_launches, sharded_mutable_phase(
            dev, args.seed, built["corpus"], mutable_rec))
    del mutable_rec
    torch.cuda.empty_cache()
    with phase("18 HI²_sup training"):
        train_launches = training_phase(dev, args.seed, built, mine_index)
    with phase("19 paper benchmarks"):
        paper_launches = paper_phase(dev, args.seed, built, mine_index)
    with phase("20c-d mesh serving and sharded_search"):
        _add(mesh_launches, mesh_phase(dev, args.seed, built, mine_index))
    del mine_index
    torch.cuda.empty_cache()
    with phase("21c mesh_serving and serving_load (counted)"):
        _add(mesh_rt_launches, mesh_benches_phase())
    with phase("22 build and training over a mesh"):
        mesh_build_launches = mesh_build_phase(dev, args.seed, built)
    build_assign = built["assign_launches"]
    del built
    torch.cuda.empty_cache()
    with phase("23 recsys"):
        rec = recsys_phase(dev, args.seed)
    with phase("24 training cells (recsys, GatedGCN)"):
        cells = train_cells_phase(dev, args.seed)
    with phase("25 the dense LM family"):
        lm = lm_phase(dev, args.seed)
    with phase("26 the MoE LM family"):
        moe_rec = moe_phase(dev, args.seed)
    # 28a's processes start before phase 27 and run beside it
    with concurrent.futures.ThreadPoolExecutor(2) as bench_pool:
        benches = start_driver(bench_pool)
        with phase("27 the dry run"):
            dryrun_phase(dev, args.seed)
        with phase("28 the bench driver and the regression gate"):
            bench_phase(benches)

    # the paths' counted runs: the builds and 18c's KMeans for
    # assign_argmax, the sup build and 18c's steps for flash_attention
    launches = dict(opq_launches,
                    sq8_dot_fused=refine_launches["sq8_dot_fused"],
                    assign_argmax=sum(build_assign.values())
                    + train_launches["assign_argmax"]
                    + mesh_build_launches["assign_argmax"],
                    flash_attention=sup_launches["flash_attention"]
                    + train_launches["flash_attention"],
                    pq_adc=bench_launches["pq_adc"])
    log(f"[train] launches of 18c's counted run: {train_launches}")
    # the PQ shape's launches: the opq build's (OPQ training and encode)
    times["assign_argmax"]["pq_shape"]["launches"] = build_assign["opq"]
    # phase 19's, 20's and 21's launches join each kernel's counted runs
    log(f"[mesh-rt] phase 21 launches {mesh_rt_launches}")
    launches = {k: v + paper_launches[k] + mesh_launches.get(k, 0)
                + mesh_rt_launches.get(k, 0) + rec["launches"].get(k, 0)
                + cells["launches"].get(k, 0) + lm["launches"].get(k, 0)
                + moe_rec["launches"].get(k, 0)
                for k, v in launches.items()}
    # phase 23: SASRec's attention at d 50, and its launches
    errs["flash_attention"] = max(errs["flash_attention"], rec["flash_err"])
    times["flash_attention"]["sasrec_shape"] = dict(
        rec["flash_times"]["serve_bulk"],
        launches=rec["launches"].get("flash_attention", 0))
    # phase 25: the kernel at each trained LM's train_4k shape
    errs["flash_attention"] = max(
        errs["flash_attention"],
        *(r["flash"]["max_abs_err"] for r in lm["train"].values()))
    times["flash_attention"]["lm_train_shapes"] = {
        arch: r["flash"] for arch, r in lm["train"].items()}
    # phase 26: the kernel at OLMoE's training shape (26c's counted
    # launches) and Mixtral's windowed shape (26d's)
    flash_26 = moe_rec["flash"]
    errs["flash_attention"] = max(
        errs["flash_attention"],
        *(r["max_abs_err"] for r in flash_26.values()))
    flash_26["olmoe_train"]["launches"] = moe_rec["train"][MOE_SERVE][
        "counts"]["flash_attention"]
    flash_26["mixtral_window"]["launches"] = moe_rec["wide_flash_launches"]
    times["flash_attention"]["moe_shapes"] = flash_26
    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=errs[k], **times[k])
               for k in SOURCES]
    log(f"[seconds] total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
