"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. card: torch/CUDA versions, the card's name and power limit, TF32 off;
2. build: every CUDA source of ``src/repro_torch/kernels/csrc`` with nvcc,
   one process per source, all started together;
3. the fused wave-hop kernel (f32 mode) against its plain version on
   synthetic worlds (sentinel rows, scattered sentinel slots, dead rows,
   duplicate ids in a row; B in {1, 64, 1000}; tree and liveness on and
   off; a wave that runs dry), then the f32 dense cases of
   ``tests/test_torch_cuda.py::hop_cases`` (unsorted input pools, R in
   {37, 70, 600}, L + R not a power of two, L in (32, 64], d = 1536, rows
   over 64 KB at d = 65600, the per-lane table base): every HopState field
   must be bit-identical;
3b. the same in sq8 and pq mode, codes trained by the port's quantizers on
   each world's rows (d=18 with M in {2, 6}, d=128 with M=8; K in
   {64, 256}), then the sq8 and pq dense cases of ``hop_cases`` (pq M=128
   at d=1536; pq M=128, K=256 at d=128, its 128 KB LUT read from device
   memory; sq8 rows over 64 KB read in place at d=65600);
3c. the brute-force top-k kernel against its plain version (B in
   {1, 64, 1000}, N in {1, 31, 5000, 5003}, k in {1, 10, 32, 64}, d in
   {18, 128}, duplicated rows so ties occur; then the mxu shape (1024, 5000,
   k=32, d=128), N=100 with k=64 so a row range holds fewer than k rows,
   all rows equal so every key ties and the ids must come out 0..k-1, an
   odd d, k = 100 and 300, whose merges sort 256 and 512 entries, k = 448,
   the largest threshold merge, then the whole-range path past it: k =
   449, 1024, 4096, k = N = 5000, k > N and all rows equal at k = 449):
   dists and ids bit-identical;
3d. the paged mode of the fused hop against its plain version: f32, sq8
   and pq; tree and liveness on and off; page_cols in {64, 256}; B in
   {1, 8, 256, 1000}; page tables drawn shuffled from a pool larger than
   needed, random bytes in unreferenced pages and in the tails, padding
   lanes aliasing one scratch row with identical inert state, and a wave
   that runs dry, then the paged cases of ``hop_cases`` in every mode:
   every HopState field and the whole pool bit-identical;
3e. the scan and merge kernels (``pairwise_l2``, ``sq8_pairwise_l2``,
   ``pq_adc``, ``pool_merge``, ``gather_distances``) against their plain
   versions over the grid of ``tests/test_torch_cuda.py::scan_cases``
   (B in {1, 7, 130}, N in {1, 63, 129, 5000}, d in {18, 100, 128}; sq8
   codes reaching -127 and 127; pq M in {4, 6, 8, 16, 32, 64, 128}, K in
   {16, 64, 256}, B also 16 and 33, N also 5003, rows of codes all 0 and
   all K - 1; pool merges at (L, C) in {(8, 8), (64, 32), (10, 7),
   (33, 20)} (the rank merge), (64, 33), (200, 48) (the warp's network),
   (300, 200) (the block's) and (20000, 5) (its global scratch), with ties,
   +inf and ``INF_DIST`` slots, pools sorted, sorted with NaN and -0.0
   beside +0.0 keys, and shuffled; neighbour rows with sentinel and
   duplicate ids, R in {7, 10 or 32, 33}, d up to 1536):
   ``pairwise_l2`` and ``sq8_pairwise_l2`` (TF32 on the tensor cores)
   within 1e-5 (|q|^2 + |x|^2) of their plain versions (x the float32 or
   the decoded rows), the largest |diff| / (|q|^2 + |x|^2) printed, then
   again with rows and queries 100 u off the origin (int8-encoded for
   sq8); the control, one TF32 product emulated in torch on the same
   inputs, must leave that tolerance on the grid and in every offset case;
   the other three bit-identical, and ``pool_merge``'s plain version on
   the card bit-identical to itself on the CPU;
4. the graph main path at one million rows x 128: DQF build → warm →
   fit_tree → 4 searches of 1024 queries, fused kernel on, with build, warm
   and fit times, per-batch search time and QPS, recall@10, mean
   dist_count, early-termination share, peak memory, and the kernel's
   launches in the 4 searches (counted from 0 just before them; > 0);
5. the same 1024 queries through the composed path (fused=False, both
   phases expanded hop by hop on the host's loop): ids, dists and counters
   must be bit-identical to the fused run, whose hot phase and full phase
   are one fused_hop launch each;
6. one batch's phase split and kernel timing at the main path's shapes
   (one 8-hop launch, and the one-launch full phase of the search path)
   beside the plain versions, the bounds and, for the top-k, the library
   pair ``torch.topk`` of the ``torch.matmul`` expansion (each call timed
   alone, the host's launch work included, and beside that 50 calls back
   to back: device time);
7. the mxu main path on phase 4's index (``hot_mode="mxu"``): 4 searches,
   top-k launches counted around them, the plain top-k against the
   kernel's on batch 0 bit for bit, the phase split;
8. the quantized main path, sq8 then pq: quantizer trained on the host
   (pq: 5 k-means rounds, not the default 15, to keep the script inside
   its limit),
   phase 4's state carried over by ``DQF.to_arrays`` (what ``DQF.save``
   writes, under the reference checkpoint's keys) and ``dqf_from_arrays``,
   fit_tree on the codes, 4 searches, fused against composed on batch 0 bit
   for bit, the phase split and the hop's timing;
9. serving on phase 4's index, tree and hot index (the Alg-2 trigger out
   of reach): ``WaveEngine(wave_size=256)`` and
   ``PagedWaveEngine(capacity=256, page_cols=256)``, ``tick_hops=8``,
   fused, serve phase 4's 4096 queries submitted at once, then as 8
   open-loop bursts of 512 with ``step()`` calls between them, then a
   two-tenant mix (tenant "b" warmed on a Zipf stream of another seed,
   2048 queries of each tenant interleaved).  Per query the paged
   engine's ids, dists and hops equal the fixed engine's bit for bit
   (both refills run the stacked hot phase through fused_hop's per-lane
   table base),
   with equal tick counts; QPS, per-query p99 and queue-wait p99, ticks,
   mean hops, recall@10, launches, peak memory and page-pool occupancy
   per engine and run; then one ``fused_hop_paged`` launch at the
   engine's shapes timed beside the dense hop, the plain version and the
   bound;
10. the scan and merge entry points on the main path's state: phase 4's
   1M x 128 rows and batch 0, phase 8's sq8 and pq codes; ``ops.pairwise_l2``,
   ``ops.sq8_pairwise_l2`` and ``ops.pq_adc`` over all rows, then one
   composed beam step: ``ops.gather_distances`` of the adjacency rows of
   each lane's frontier in phase 4's seeded full-phase pool and
   ``ops.pool_merge`` of those scores into the pool (B=1024, L=64, C=32).
   Each kernel against its plain version (the scans in chunks of 128
   queries): ``pairwise_l2`` and ``sq8_pairwise_l2`` within 1e-5 (|q|^2 +
   |x|^2), their largest ratios printed, the others bit for bit; its time
   beside the plain version's, the library expression's and the bound (the
   two scans': their bytes, or their 2 B N d at the tensor cores' TF32
   rate, with the floor of their TF32 products (three for float32 rows,
   two for int8 codes) and the CUDA-core bound beside it; ``pq_adc``'s:
   its bytes, with the floor of its B N M shared-memory loads at 32 a
   wavefront, one a clock on every SM at the highest SM clock
   ``nvidia-smi`` reports); recall@10 of the exact top-10 of each scan
   (the float32 scan must reach 0.999); ``gather_distances`` and
   ``pool_merge`` (and the library expression of each) timed two ways,
   median of 20: a call alone (events around the Python call, the host's
   launch work inside) and the device alone (the card sleeps while the
   host enqueues the call), the gather's rows cold (L2 flushed before each
   call, the card idle again before the call is timed), beside an empty
   launch timed the same two ways; peak device memory;
11. the mutable main path on phase 4's index (the Alg-2 trigger out of
   reach): ``DQF.save`` to a temp dir and ``DQF.load`` onto the card (both
   timed, the file's bytes), the clone bit for bit with the original on
   batch 0; the fixed engine (``wave_size=256``) on the original and the
   paged engine (``capacity=256, page_cols=256``) on the clone, both
   ``tick_hops=8``, serve phase 4's 4 batches as 4 rounds, paged ≡ fixed
   per query in every round, with the same churn applied to both twins at
   the drain boundaries: after round 1, insert 512 rows (``x`` at seeded
   random rows + 0.02 N(0, 1); capacity 1,000,000 -> 1,048,576), after
   round 2 delete 2,000 live rows (the same external ids; the hot rows hit
   are rebuilt), after round 3 compact.  Checks: no tombstoned id in any
   result (``search`` over the 4 batches, ``search_dual_beam``,
   ``search_baseline``, both engines); the inserted rows, searched as
   queries, find their own id in their top-10 at least as often as the
   rows they were drawn from found theirs before the insert, less 0.1
   (``search``; ``search_baseline``'s rates printed beside it); after the
   insert and after the delete,
   fused ≡ composed on batch 0 and one 8-hop launch timed at the grown
   shapes (a call alone, the device alone, plain version, bound); after the
   compact every live row keeps its vector under its external id and every
   node is reachable from the entry set; recall@10 over the live rows
   (exact top-10 of the live rows, phase 4's 4 batches) at least phase
   4's − 0.02 after the insert and at least the pre-compaction recall −
   0.02 after the compact (the delete's hot rebuild reselects the hot set
   from the counter, Alg 2, which moves recall by itself: reported, and
   measured alone on phase 4's checkpoint reloaded, its hot index
   reselected); the compacted original saved, loaded and bit for bit on
   batch 0.  Prints the seconds of each step (insert and
   delete with ms a row, compact split into store, ``compact_adjacency``
   and repair), each round's QPS per engine, the two hops' launches and
   the peak device memory.

12. the disk tier (``repro_torch.tiering``) at the main path's size:
   phase 8's sq8 index (kept as arrays) loaded with ``TierConfig(mode=
   "host", block_rows=64, cache_frac=f)`` for f in {1.0, 0.25, 0.10},
   block files in a temp dir removed at the end: 2 warm batches,
   ``relayout_tier()``, 2 more, then phase 4's 4 batches, each
   bit-identical (ids, dists, counters) to a resident ``fused=False``
   twin, and no fused_hop launch in any tiered batch (the tier gates the
   hop off); per f the ms a batch split into hot phase, full phase with
   its host fetches and rerank, ``host_fetch`` ms and rows, ``maintain``
   ms and admissions, the window hit rate before and after the relayout,
   recall@10 and ``memory_report`` totals beside the resident twin's.
   Then f32 (phase 4's index, kept before phase 11) and pq at 25% against
   their resident ``fused=False`` twins, and mxu at 25% on the f32 twin
   (``fused_topk_l2`` launches counted); equality with the resident
   ``fused=True`` searches is reported.  Both engines (phase 9's shapes,
   2048 queries at once) on the sq8 twin at 25% with prefetch: paged ≡
   fixed and both ≡ the resident ``fused=False`` engines per query, QPS,
   p99, queue-wait p99, tick hit rate, prefetches, pinned blocks.  Chaos:
   every block's first read failing (``FaultPlan(tier_fail_first_fetch=
   True)``, ``fetch_backoff_s=0``) leaves 256 queries bit-identical with
   retries and no failure; ``tier_io_rate=1.0`` with one retry on the
   fixed engine raises nothing and marks the degraded queries; page-pool
   denials at 0.3 on the paged engine delay and lose nothing.  Last, the
   tiered twin and its resident twin through insert 512 (the files
   resize, the caches re-key), delete 1,000 and compact, equal searches
   and no stale block after each step, then a save with the
   ``<path>.npz.tier/`` sidecar and a reload that searches the same.
13. the sharded index's read path (``repro_torch.sharding.ShardedDQF``) on
   phase 4's rows, config (fused), warm targets, fit queries and 4
   batches.  S = 1: phase 4's index carried from its arrays (kept before
   phase 11), no build; check 1: its search equals phase 4's
   ``DQF.search`` bit for bit (ext ids, dists).  S = 2 and 4: build, warm
   with phase 4's warm targets as global ext ids, fit_tree on 1,024 of
   phase 4's fit queries, each timed.
   At every S, over the 4 batches (``record=False``): check 2, ``search``
   (the stacked pass: S·B lanes, one hot-phase and one full-phase
   fused_hop launch, one pool_merge) equals ``search_oracle`` (each
   shard's own search, a stable host merge) bit for bit; check 3, the
   stacked batches made 2 fused_hop and 1 pool_merge launches each
   (counted from 0 just before them); check 5, ``memory_report``'s
   per-shard device totals sum to the fleet's and ``scrape`` carries
   ``shard=s`` for every s; at S = 4, check 4: ``search_degraded`` with
   shard 2 lost has coverage 0.75, ids only of the live shards' rows, and
   equals ``merge_with_dropout`` over the shards' own searches.  Printed:
   ms a batch of the stacked and the oracle search (CUDA events), build,
   warm and fit seconds and those of the stacked tables' set-up (made
   once, before the timed searches), peak device memory, recall@10 of the
   merged result (guard: at least half of S = 1's) and of the shards'
   answers without the tree merged on the host, and for each shard its
   recall@10 against the exact top-10 of its own rows with and without
   the tree, the share of its lanes the tree ended and its mean
   dist_count.  At S = 2 and 4 the two
   kernels at the path's shapes against their plain versions, bit for
   bit, timed beside them and their bounds: ``pool_merge`` on batch 0's
   per-shard answers (the library's stable sort too), and one 8-hop
   ``fused_hop`` launch from the stacked seed (S·B lanes, the per-lane
   table base over the stacked tables and liveness).  The S = 2 and 4
   indexes stay for phase 14.
14. the sharded engine (``repro_torch.sharding.ShardedEngine``) on phase
   13's S = 2 and 4 indexes, not rebuilt (a tenant "b" warmed on phase
   9's second Zipf stream; every Alg-2 trigger out of reach), phase 9's
   shapes (256 lanes, ``tick_hops=8``, paged ``page_cols=256``) and
   traffic on phase 4's first 2 batches (2048 at once; 4 bursts of 512, 4
   steps apart; two tenants, 1024 each, interleaved by 64; 4096, 8 and
   2048 before, cut for the script's time limit).  Check 1: the fixed fused engine ≡ the
   fixed composed one per query (ids, dists, hops bit for bit), equal
   ticks; check 2: the paged fused engine ≡ the fixed fused one in all
   three runs, the page pool empty after each; check 3: every fixed
   tick launched exactly 1 fused_hop and 1 pool_merge, every paged tick
   1 fused_hop_paged and 1 pool_merge, every composed tick 1 pool_merge
   (counted a tick by a wrapper around the tick function; the refills'
   hot phases launch outside it); check 4: recall@10 at least the
   stacked search's (phase 13) − 0.08 and every shard's Alg-2 clock
   advanced by the query count; check 5: with shard 1 failing every
   tick every result of batch 0 answers over S − 1 shards, degraded,
   with no row of shard 1, after one quarantine, and a zero-rate plan
   gives the bits of no plan; check 6: the fixed engine on the index and
   the paged one on a clone (``ShardedDQF.from_arrays`` of its shards'
   arrays), auto-compaction at 0.4% tombstones, serve the 4 batches as 4
   rounds, insert 512 rows after round 1, delete 5,000 global ids after
   round 2 and pin 3x the largest shard mass of traffic on 64 of shard
   0's rows, so the compaction the engines run in round 3 rebalances
   them: paged ≡ fixed every round, no deleted id returned, every live
   id owned by the shard that stores it; check 7: the fixed tick's
   8-hop ``fused_hop`` (S·256 lanes from the engine's own seed), the
   paged tick's ``fused_hop_paged`` (S·256 lanes over the stacked pool,
   page-table rows offset by ``s·n_pages``) and ``pool_merge`` at L = 10,
   C = S·64 − 10 on pools made unsorted by masked ``INF_DIST`` slots,
   each bit for bit with its plain version, timed beside it, the bound
   and (the merge) the library's stable sort.  Printed: QPS, p99,
   queue-wait p99, ticks, recall, launches, peak memory and the tick's
   split by timeline span (hop, merge, retire, refill) per engine and
   run; ``_sync_stacked`` seconds after each write, insert, delete and
   compact seconds, rows rebalanced.
15. the kNN-LM serving path (``phase_knnlm``): a datastore of
   ``make_clustered(N, 128, 1024 clusters, spread 1.5)`` keys lifted to
   d = 1024 by a seeded orthonormal map (distances kept), payload tokens
   uniform below the vocab, phase 4's config (fused), warmed on 4096 Zipf
   queries, the tree fit on 2048; N = 262,144 (kNN-LM's 103M cut to the
   time limit; no timed probe build sizes it any more: the probe never
   halved it, and at half the keys phase 17's recall fell under its
   guard).  A: 4 x 1024 Zipf ``RetrievalService.lookup``s: ms a
   batch, recall@10 against the exact top-10, mean dist_count,
   early-terminated share, 2 fused_hop launches a lookup; a twin index
   over the unlifted d = 128 keys (the queries projected back) gives the
   recall this data allows, and the lookups' must reach it less 0.05.
   B: Qwen3-0.6B (``get_config("qwen3-0.6b")``: 28 layers, d_model
   1024, vocab 151,936, bf16) drawn from ``--seed``, and its float32
   copy with TF32 off: a
   64-token prompt decoded token by token against ``forward`` at every
   position (float32 within 1e-3; bf16's max |diff| and argmax agreement
   printed), then ``prefill`` of 256 tokens at B = 16 timed.  C:
   ``serve_knnlm``'s loop at B = 16, 64 steps, ``max_len`` 512, the
   query the embedding row of the step's argmax token, the head's
   temperature 100 (the default 10 underflows every weight at these
   distances): ms a step split into LM decode, lookup and head (CUDA
   events), tokens/s, 2 fused_hop launches a step; every probability row
   finite and summing to 1 within 1e-4, and equal within 1e-6 to the
   reference's head recomputed on the host from the same logits, tokens
   and distances.  D: one 8-hop ``fused_hop`` launch at the lookup's state
   (B = 16, and B = 1024) against its plain version bit for bit, timed
   beside it and its bound: a kernel-line entry of its own.  Peak device
   memory.
16. the frozen segment index (``repro_torch.serving.sharded``): phase 4's
   rows dealt into S = 4 segments of 250,000 (``build_sharded_index``,
   phase 4's SSG parameters, each segment's graph built on the card; the
   seconds a segment), the stacked tables uploaded once (seconds apart
   from the search's ms, device bytes), phase 4's 4 batches through
   ``sharded_search`` with ``DQFConfig(k=10, full_pool=64,
   max_hops=512)``: ms a batch (CUDA events, the copy to the host in), 1
   ``fused_hop`` and 1 ``pool_merge`` launch a batch (counted from 0 just
   before them); every batch bit for bit with the sequential oracle (one
   plain ``beam_search`` a segment on the card, ids mapped, then
   ``merge_topk_host``); recall@10 against phase 4's exact top-10 at least
   half of that of phase 4's plain beam search over the whole graph
   (``search_baseline``, the same Algorithm 3 at the same pool), as phase
   13 holds S > 1 shards, and each segment's recall against the exact
   top-10 of its own rows; a lane's mean hops and dist_count.  Then one 8-hop ``fused_hop``
   launch at the 4096 stacked lanes (the per-lane table base, no tree)
   and ``pool_merge`` at the merge's shapes, each against its plain
   version bit for bit, timed beside it, its bound and (the merge) the
   library's stable sort: two kernel-line entries.  Peak device memory.
17. a kNN-LM over DeepSeek-V2-Lite at full width
   (``get_config("deepseek-v2-lite-16b")``: 27 layers, d_model 2048, MLA
   rank 512, 64 routed experts top-6 + 2 shared, vocab 102,400, bf16;
   15.71 B parameters drawn from ``--seed``): phase 15's datastore recipe
   and check A at d = 2048 (N = 262,144 of kNN-LM's 103M keys).  B: float32 copies at full width cut to 4 layers
   (1 dense + 3 MoE: a float32 copy of all 27 layers, 63 GB, does not fit
   beside the bf16 model), their capacity factor raised to E / K so that
   no token is dropped (the reference's capacity grows with the token
   count, so a capacity-bound model's decode is not its forward), of
   DeepSeek-V2-Lite and of deepseek-moe-16b (MoE with MHA attention, a
   dense layer 10,944 wide): a 64-token prompt at B = 4 decoded token by
   token against ``forward``, within 1e-3; then the bf16 model's own
   replay (max |diff| and argmax agreement printed), the MoE's dropped
   fraction at B = 16 and at 16 x 256, the MLA cache bytes, the experts'
   bf16 product with a float32 result timed beside widening its operands
   (one layer's ``w_gate`` at the decode's and the prefill's capacity),
   a timed prefill of 16 x 256.  C: phase 15's decode loop (B = 16, 64 steps, a
   lookup a step through ``RetrievalService`` and the fused hop): ms a
   step split into LM decode, lookup and head, tokens/s, 2 fused_hop
   launches a step, the head within 1e-6 of its host recomputation and
   every row summing to 1 within 1e-4; the step beside its byte bound
   (the model's weight bytes over the card's memory rate).  D: one 8-hop
   ``fused_hop`` launch at the lookup's state (B = 16, d = 2048) against
   its plain version bit for bit: a kernel-line entry.  Peak device
   memory.  Its ``RetrievalService`` goes on to phase 18.
18. the last block kinds at full width, weights drawn from ``--seed``.
   A: a kNN-LM over xLSTM-1.3B (48 layers: 42 mLSTM + 6 sLSTM, d_model
   2048, 4 heads, vocab 50,304, bf16) on phase 17's datastore, its
   payload drawn anew below that vocabulary (no index is built): a
   float32 copy at full width cut to 8 layers (7 mLSTM + 1 sLSTM), a
   64-token prompt at B = 4 decoded from empty state against ``forward``
   within 1e-3; the bf16 model's own replay; a timed prefill of 16 x 256
   (its xLSTM layers return no cache, as the reference's); phase 15's
   decode loop (B = 16, 64 steps, 128 ``fused_hop`` launches, the head
   within 1e-6 of its host recomputation, rows summing to 1 within 1e-4)
   beside its byte bound (the weights, and the recurrent state read and
   written); one 8-hop ``fused_hop`` launch at the lookup's state against
   its plain version bit for bit: a kernel-line entry.  B: Hymba-1.5B
   (32 hybrid layers, attention + Mamba): a float32 copy at 4 layers
   replayed as in A; in bf16 at full depth a timed prefill of 16 x 256
   and decode steps at B = 16.  C: Llama-3.2-Vision-11B (40 layers, 8
   of them cross-attention to media of (B, 1601, 4096)), cross gates
   opened to 0.5 (at their init of 0 a cross layer adds nothing): a
   float32 copy at 5 layers (4 dense + 1 cross), ``forward`` with media
   against a decode replay whose cross K/V come from ``prefill``, within
   1e-3; in bf16 at full depth a timed prefill of 16 x 256 text tokens
   with media, the cross K/V bytes, and decode steps at B = 16 over
   them.  Peak device memory.
19. training at full width (no kernel of the port: the training path
   reaches no ``pl.pallas_call`` in the reference), weights drawn from
   ``--seed``.  A: Qwen3-0.6B at full width and depth (28 layers, bf16)
   trained 12 steps (30 planned; cut to the time limit) in the launcher's
   loop through ``make_train_step``
   (``TrainConfig(remat=True, microbatches=2)``, warmup-cosine at peak
   1e-3, 16 x 1024 synthetic tokens a step from ``data/pipeline.py``): ms
   a step (CUDA events, median of steps 2-11 but the save's) split into
   forward+backward and the optimizer, tokens/s, the model-FLOPs share
   (6 N tokens over the step time against ``BF16_FLOPS``), the optimizer
   beside its byte bound, peak device memory; loss and grad norm finite
   at every step, and the last 5 steps' mean loss at least
   ``TRAIN_LOSS_FALL`` nats below the first 3's.  C: the state after 8
   steps saved by the port's ``Checkpointer`` while the last 4 run (bytes,
   seconds the loop was blocked, seconds to publish), restored into a
   fresh ``TrainState`` (seconds): params, m, v and step bit for bit
   against a device copy taken at the save; 3 steps from the restore
   within 1e-3 of the unbroken run's losses.  B: the same step in float32
   at full width cut to 2 layers (B = 4, S = 64), the card against the
   port's CPU path on the same weights and batch: the loss within 1e-5
   relative, each gradient leaf within 1e-4 of its largest |g| (TF32
   off); remat against none on the card bit for bit (the embedding's
   gradient, accumulated by ``index_put_``, allowed 1e-6); microbatches 2
   against 1 within 1e-4.  D: one train step of each of the ten configs'
   ``reduced()`` forms on the card (with embeds or media where the config
   needs them; depth overrides keep gemma3's global layer, an sLSTM layer
   and a cross layer with its gate opened to 0.5) in float32 against its
   CPU twin at B's tolerances, and of both DeepSeek configs in bf16 (the
   experts' ``out_dtype`` product differentiated): finite.
20. the multi-rank code at world 1 over NCCL (``phase_distributed``).  A:
   ``repro_torch.distributed.mesh.init_distributed("cuda")`` starts a world of
   one over a ``FileStore`` in a temporary directory (the machine has no
   network): backend, world size, NCCL's version, the device count; the
   multi-rank checks (worlds of 2 and 4) run on the CPU only, in the
   ``tests/test_torch_dist_*.py`` files, since NCCL allows one rank a
   device and this machine has one card.  B: phase 19's Qwen3-0.6B (full
   width, bf16, B = 16) decodes 32 seeded tokens through
   ``flash_mesh=make_test_mesh(1, 1)`` and through the default path from
   the same empty caches: argmax agreement at least 0.99 and max |Δ
   logits| at most 2e-2 of max |logits| (the reference test's contract),
   ms a step both ways (CUDA events); a float32 4-layer replay within
   1e-5 of max |logits|.  C: three data-parallel train steps at world 1
   (one all-reduce of a flat float32 buffer a step) from phase 19's
   restored state, 4 x 256 tokens, beside the one-device step on a twin
   of that state: the loss at each step and every parameter after the
   third bit for bit; ms a step both ways.  D: ``sharded_search`` through
   the mesh path on a (1, 1) mesh over phase 16's segment 0 (an S = 1
   ``ShardedIndex``, no build) against ``mesh=None`` on the same index,
   4 batches of 1024: ids and dists bit for bit, 1 ``fused_hop`` and 1
   ``pool_merge`` launch a batch, ms a batch both ways.  E:
   ``ShardedEngine`` over phase 13's S = 1 index (phase 4's arrays, no
   build) placed on a one-rank shard mesh (``ShardConfig(use_mesh=
   Mesh((1,), ("shard",)))``), against the unplaced engine over a twin of
   it, on phase 9's first 2048 queries closed loop (wave 256, 8 hops a
   tick): fixed fused, paged fused, and fixed under a chaos plan (shard 0
   failing ticks 5-7: a quarantine and degraded results); every result's
   ids, dists, hops and status bit for bit, the ticks equal, at most one
   collective a tick, the three kernels launched, recall@10 of the
   float32 paths at least 0.5; ms a tick both ways (host wall over the
   run).  F: tensor parallelism at a model axis of one rank
   (``shard_lm`` over ``make_test_mesh(1, 1)``: every collective still
   runs, over a group of one) on a twin of phase 19's restored Qwen3-0.6B
   against the plain model: one train step (4 x 256 tokens) and 32 decode
   steps at B = 16 bit for bit, ms both ways (CUDA events); then a
   checkpoint of the twin's first 4 layers (with the embedding; cut in
   depth for the script's time, ~2 GB instead of ~6) written by the
   ``Checkpointer`` and restored onto the same mesh bit for bit.  G:
   tensor parallelism of the other kinds at a model axis of one rank, at
   full width, weights drawn from ``--seed`` (bf16): DeepSeek-V2-Lite cut
   to 3 layers (the dense layer 0 and two MoE layers: MLA of latent rank
   512, 64 routed experts top-6 and 2 shared, expert parallelism) and
   Llama-3.2-Vision-11B cut to 2 (``cross_attn_every=2``: one
   self-attention and one cross layer, gates opened to 0.5, seeded media
   of (B, 1601, 4096)), xLSTM-1.3B cut to 8 layers (7 mLSTM and 1 sLSTM,
   its own schedule) and Hymba-1.5B cut to 2 (25 heads, 5 kv heads, the
   Mamba branch as 25 heads of 128 channels), each with a twin cut by
   ``shard_lm``: two train
   steps (4 x 256 tokens each) with the losses and every parameter after
   them, a prefill of 16 x 64 and 16 decode steps at B = 16, each bit for
   bit against the plain model; ms the second step and a decode step both
   ways (warmed), the collectives of one split decode step, G's peak
   device memory and seconds.  The
   group is destroyed at the end of the phase.

Recall guards against breakage, not a target: 0.5 for the float32 paths,
half of phase 4's recall for the quantized ones, the d = 128 twin's less
0.05 for phase 15's lifted keys, half of phase 4's plain beam search for
phase 16's segments.  Phases 7 and 8 search
with ``record=False``, so every path searches the same hot index.

One ``{"kernels": [...]}`` line lists every kernel, each with its
contract: ``"bits"`` or ``"tol 1e-5*(|q|^2+|x|^2)"``.  The last line is
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside tensor cores
TF32_FLOPS = 495e12              # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 on the tensor cores
N = 1_000_000                    # rows of the main path's index


def log(*a):
    print(*a, flush=True)


def make_clustered(n, d, clusters, seed, spread=1.5):
    """The recipe of tests/conftest.py::make_clustered."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * spread
    asg = rng.integers(0, clusters, n)
    x = centers[asg] + rng.standard_normal((n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def clone_state(hs):
    return type(hs)(*(t.clone() for t in hs))


# ------------------------------------------------------------------ phase 3
def hop_grid(dev, modes, paged):
    """``tests/test_torch_cuda.py::hop_cases`` restricted to ``modes`` and
    to the paged (or dense) hop: each case one launch against the plain
    version, every HopState field (the whole pool when paged)
    bit-identical.  Returns (cases, max |dist diff| over finite dists)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from tests.test_torch_cuda import hop_cases

    plain, cuda_fn = ((ref.fused_hop_paged, fused_hop_paged_cuda) if paged
                      else (ref.fused_hop, fused_hop_cuda))
    saved = cuda_fn.launches
    n_cases, max_err = 0, 0.0
    for tag, mode, is_paged, args, kw in hop_cases(dev):
        if is_paged != paged or mode not in modes:
            continue
        fresh = lambda: (clone_state(args[0]),) + args[1:]
        want = plain(*fresh(), **kw)
        got = cuda_fn(*fresh(), **kw)
        torch.cuda.synchronize()
        bad = [f for f in ref.HopState._fields
               if not bits_equal(getattr(want, f), getattr(got, f))]
        if bad:
            raise SystemExit(f"hop world {tag}: fields differ: {bad}")
        fin = want.dists < 1e30
        if bool(fin.any()):
            max_err = max(max_err, float(
                (want.dists[fin] - got.dists[fin]).abs().max()))
        n_cases += 1
    cuda_fn.launches = saved
    log(f"  hop grid ({', '.join(modes)}, {'paged' if paged else 'dense'}):"
        f" {n_cases} cases bit-identical (unsorted pools, R in (37, 70, "
        f"600), L+R not a power of two, L=40, d=1536, d=65600, pq LUT of "
        f"128 KB, the per-lane base)")
    return n_cases, max_err


def synthetic_world(n, d, R, seed, dead_every, sentinel_rows, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_pad = np.concatenate([x, np.full((1, d), 1e9, np.float32)])
    adj = rng.integers(0, n, (n, R)).astype(np.int32)
    adj[::7, 1] = adj[::7, 0]                   # duplicate ids in one row
    for r in sentinel_rows:
        adj[r] = n                              # all-sentinel adjacency row
    adj[adj % 11 == 0] = n                      # scattered sentinel slots
    adj_pad = np.concatenate([adj, np.full((1, R), n, np.int32)])
    live = np.ones(n + 1, bool)
    if dead_every:
        live[::dead_every] = False
    live[n] = False
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(x_pad), t(adj_pad), t(live)


def synthetic_tree(seed, T, dev, scale):
    rng = np.random.default_rng(seed)
    arr = [rng.integers(-1, 6, T).astype(np.int32),
           (rng.standard_normal(T) * 0.5 * scale + scale).astype(np.float32),
           np.minimum(np.arange(T) * 2 + 1, T - 1).astype(np.int32),
           np.minimum(np.arange(T) * 2 + 2, T - 1).astype(np.int32),
           rng.uniform(0, 1, T).astype(np.float32)]
    return tuple(torch.as_tensor(a, device=dev) for a in arr)


def phase_synthetic(dev):
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    rng = np.random.default_rng(7)
    cases = []
    small = dict(n=220, d=18, R=10, L=16, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
                     tree_depth=4), scale=80.0)
    large = dict(n=50_000, d=128, R=32, L=64, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=24, max_hops=64, k=10, eval_gap=50, add_step=0,
                     tree_depth=6), scale=200.0)
    for world in (small, large):
        for B in (1, 64, 1000):
            for use_tree in (False, True):
                for use_live in (False, True):
                    cases.append((world, B, use_tree, use_live))
    dry = dict(n=40, d=18, R=4, L=8, dead_every=0, sentinel_rows=(1,),
               kw=dict(hops=64, max_hops=512), scale=80.0)
    cases.append((dry, 3, False, False))
    max_err = 0.0
    for i, (w, B, use_tree, use_live) in enumerate(cases):
        x_pad, adj_pad, live = synthetic_world(
            w["n"], w["d"], w["R"], i, w["dead_every"], w["sentinel_rows"],
            dev)
        q = torch.as_tensor(rng.standard_normal((B, w["d"]))
                            .astype(np.float32), device=dev)
        entries = torch.arange(0, w["n"], max(1, w["n"] // 6),
                               dtype=torch.int32, device=dev)[:6]
        live_pad = live if use_live else None
        hs = bs.to_hop_state(bs.init_state(x_pad, q, entries, w["L"],
                                           live_pad))
        tree = hf = hr = None
        if use_tree:
            tree = synthetic_tree(i, 31, dev, w["scale"])
            hf = torch.as_tensor(rng.uniform(1, 6, B).astype(np.float32),
                                 device=dev)
            hr = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32),
                                 device=dev)
        want = ref.fused_hop(clone_state(hs), adj_pad, q, live_pad, "f32",
                             x_pad, None, None, tree, hf, hr, **w["kw"])
        got = fused_hop_cuda(clone_state(hs), adj_pad, q, live_pad, "f32",
                             x_pad, None, None, tree, hf, hr, **w["kw"])
        torch.cuda.synchronize()
        bad = [f for f in ref.HopState._fields
               if not bits_equal(getattr(want, f), getattr(got, f))]
        max_err = max(max_err, float((want.dists - got.dists).abs().max()))
        tag = (f"n={w['n']} d={w['d']} R={w['R']} L={w['L']} B={B} "
               f"tree={use_tree} live={use_live}")
        if bad:
            raise SystemExit(f"synthetic world {tag}: fields differ: {bad}")
        log(f"  synthetic {tag}: bit-identical "
            f"(active left {int(got.active.sum())}, "
            f"terminated {int(got.terminated.sum())})")
        if w is dry and bool(got.active.any()):
            raise SystemExit("dry wave: lanes still active after 64 hops")
    grid, grid_err = hop_grid(dev, ("f32",), paged=False)
    return len(cases) + grid, max(max_err, grid_err)


# ----------------------------------------------------------------- phase 3b
def phase_quant_synthetic(dev):
    from repro_torch.core import QuantConfig
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.quant import build_quantizer

    rng = np.random.default_rng(8)
    small = dict(n=600, d=18, R=10, L=16, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
                     tree_depth=4), scale=80.0)
    large = dict(n=50_000, d=128, R=32, L=64, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=24, max_hops=64, k=10, eval_gap=50, add_step=0,
                     tree_depth=6), scale=200.0)
    pq = lambda m, bits: QuantConfig(mode="pq", pq_m=m, pq_bits=bits,
                                     pq_iters=4)
    tables = [(small, QuantConfig(mode="sq8")),
              (large, QuantConfig(mode="sq8")),
              (small, pq(2, 6)), (small, pq(6, 8)),
              (large, pq(8, 6)), (large, pq(8, 8))]
    saved = fused_hop_cuda.launches
    n_cases = 0
    for i, (w, qcfg) in enumerate(tables):
        x_pad, adj_pad, live = synthetic_world(
            w["n"], w["d"], w["R"], 100 + i, w["dead_every"],
            w["sentinel_rows"], dev)
        mode = qcfg.mode
        m, k = (qcfg.pq_m, 2 ** qcfg.pq_bits) if mode == "pq" else (0, 0)
        state = build_quantizer(x_pad[:-1].cpu().numpy(), qcfg)
        table = state.device_table(device=dev)
        for B in (1, 64, 1000):
            q = torch.as_tensor(rng.standard_normal((B, w["d"]))
                                .astype(np.float32), device=dev)
            spec = ops.table_spec(bs.as_view(table, q))
            entries = torch.arange(0, w["n"], max(1, w["n"] // 6),
                                   dtype=torch.int32, device=dev)[:6]
            for use_tree in (False, True):
                for use_live in (False, True):
                    live_pad = live if use_live else None
                    hs = bs.to_hop_state(bs.init_state(
                        x_pad, q, entries, w["L"], live_pad))
                    tree = hf = hr = None
                    if use_tree:
                        tree = synthetic_tree(i, 31, dev, w["scale"])
                        hf = torch.as_tensor(rng.uniform(1, 6, B)
                                             .astype(np.float32), device=dev)
                        hr = torch.as_tensor(rng.uniform(0.5, 1.5, B)
                                             .astype(np.float32), device=dev)
                    want = ref.fused_hop(clone_state(hs), adj_pad, q,
                                         live_pad, *spec, tree, hf, hr,
                                         **w["kw"])
                    got = fused_hop_cuda(clone_state(hs), adj_pad, q,
                                         live_pad, *spec, tree, hf, hr,
                                         **w["kw"])
                    torch.cuda.synchronize()
                    bad = [f for f in ref.HopState._fields
                           if not bits_equal(getattr(want, f),
                                             getattr(got, f))]
                    tag = (f"{mode} n={w['n']} d={w['d']} M={m or w['d']} "
                           f"K={k or '-'} B={B} tree={use_tree} "
                           f"live={use_live}")
                    if bad:
                        raise SystemExit(f"quantized world {tag}: fields "
                                         f"differ: {bad}")
                    n_cases += 1
        log(f"  {mode} n={w['n']} d={w['d']} M={m or w['d']} K={k or '-'}: "
            f"12 cases bit-identical")
    fused_hop_cuda.launches = saved
    return n_cases + hop_grid(dev, ("sq8", "pq"), paged=False)[0]


# ----------------------------------------------------------------- phase 3c
def phase_topk_synthetic(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda
    from tests.test_torch_cuda import topk_rows

    rng = np.random.default_rng(9)
    saved = fused_topk_l2_cuda.launches
    n_cases, max_err = 0, 0.0

    def check(q, x, k, what):
        nonlocal n_cases, max_err
        want_d, want_i = ref.fused_topk_l2(q, x, k=k)
        got_d, got_i = fused_topk_l2_cuda(q, x, k=k)
        torch.cuda.synchronize()
        if not (bits_equal(want_d, got_d) and bits_equal(want_i, got_i)):
            raise SystemExit(f"fused_topk_l2 {what} k={k} differs from "
                             f"plain version")
        fin = torch.isfinite(want_d)
        if bool(fin.any()):
            max_err = max(max_err, float(
                (want_d[fin] - got_d[fin]).abs().max()))
        n_cases += 1
        return got_i

    for d in (18, 128):
        for N in (1, 31, 5000, 5003):
            x = torch.as_tensor(topk_rows(N, d, N + d), device=dev)
            for B in (1, 64, 1000):
                q = torch.as_tensor(rng.standard_normal((B, d))
                                    .astype(np.float32), device=dev)
                q[0] = x[0]                    # a zero-distance tie
                for k in (1, 10, 32, 64):
                    check(q, x, k, f"B={B} N={N} d={d}")
        log(f"  d={d}: N in (1, 31, 5000, 5003) x B in (1, 64, 1000) x "
            f"k in (1, 10, 32, 64) bit-identical")
    for what, B, N, k, d, equal in (
            ("the mxu shape", 1024, 5000, 32, 128, False),
            ("ranges shorter than k", 1024, 100, 64, 128, False),
            ("all rows equal", 64, 5000, 32, 128, True),
            ("odd d", 33, 700, 16, 17, False),
            ("k > 64", 1024, 5000, 100, 24, False),
            ("k > 192", 1024, 5000, 300, 18, False),
            ("the largest threshold merge", 256, 5000, 448, 24, False),
            ("past it, whole ranges sorted", 1024, 5000, 449, 24, False),
            ("k = 1024", 256, 5000, 1024, 24, False),
            ("k = 4096", 64, 5000, 4096, 24, False),
            ("k = N", 64, 5000, 5000, 18, False),
            ("k > N", 64, 3000, 3500, 18, False),
            ("all rows equal, k = 449", 64, 5000, 449, 32, True)):
        x = torch.as_tensor(topk_rows(N, d, N, equal), device=dev)
        q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32),
                            device=dev)
        q[0] = x[0]
        got_i = check(q, x, k, f"{what} B={B} N={N} d={d}")
        if equal and not bool((got_i == torch.arange(
                k, dtype=torch.int32, device=dev)).all()):
            raise SystemExit("fused_topk_l2 with all rows equal: ids are "
                             "not 0..k-1")
        log(f"  {what} (B={B}, N={N}, k={k}, d={d}) bit-identical")
    fused_topk_l2_cuda.launches = saved
    return n_cases, max_err


# ----------------------------------------------------------------- phase 3d
def phase_paged_synthetic(dev):
    from repro_torch.core import QuantConfig
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop_paged_cuda
    from repro_torch.quant import build_quantizer
    from tests.test_torch_cuda import paged_case

    rng = np.random.default_rng(10)
    small = dict(n=600, d=18, R=10, L=16, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
                     tree_depth=4), scale=80.0,
                 qcfg={"sq8": QuantConfig(mode="sq8"),
                       "pq": QuantConfig(mode="pq", pq_m=6, pq_bits=6,
                                         pq_iters=4)},
                 Bs=(1, 8, 256, 1000), flags=(False, True))
    large = dict(n=50_000, d=128, R=32, L=64, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=24, max_hops=64, k=10, eval_gap=50, add_step=0,
                     tree_depth=6), scale=200.0,
                 qcfg={"sq8": QuantConfig(mode="sq8"),
                       "pq": QuantConfig(mode="pq", pq_m=8, pq_bits=8,
                                         pq_iters=4)},
                 Bs=(256, 1000), flags=(True,))
    dry = dict(n=40, d=18, R=4, L=8, dead_every=0, sentinel_rows=(1,),
               kw=dict(hops=64, max_hops=512), qcfg={}, Bs=(9,),
               flags=(False,))
    saved = fused_hop_paged_cuda.launches
    n_cases, max_err = 0, 0.0
    for wi, w in enumerate((small, large, dry)):
        x_pad, adj_pad, live = synthetic_world(
            w["n"], w["d"], w["R"], 200 + wi, w["dead_every"],
            w["sentinel_rows"], dev)
        tables = {"f32": x_pad}
        for mode, qcfg in w["qcfg"].items():
            tables[mode] = build_quantizer(x_pad[:-1].cpu().numpy(),
                                           qcfg).device_table(device=dev)
        entries = torch.arange(0, w["n"], max(1, w["n"] // 6),
                               dtype=torch.int32, device=dev)[:6]
        for mode, table in tables.items():
            for B in w["Bs"]:
                q = torch.as_tensor(rng.standard_normal((B, w["d"]))
                                    .astype(np.float32), device=dev)
                spec = ops.table_spec(bs.as_view(table, q))
                for pc in (64, 256):
                    for use_tree in w["flags"]:
                        for use_live in w["flags"]:
                            live_pad = live if use_live else None
                            hs, pt = paged_case(bs.to_hop_state(
                                bs.init_state(x_pad, q, entries, w["L"],
                                              live_pad)), pc,
                                0 if B == 1 else max(1, B // 8), rng)
                            tree = hf = hr = None
                            if use_tree:
                                tree = synthetic_tree(wi, 31, dev,
                                                      w["scale"])
                                hf = torch.as_tensor(rng.uniform(1, 6, B)
                                                     .astype(np.float32),
                                                     device=dev)
                                hr = torch.as_tensor(
                                    rng.uniform(0.5, 1.5, B)
                                    .astype(np.float32), device=dev)
                            args = (adj_pad, q, live_pad, *spec, tree, hf,
                                    hr)
                            kw = dict(page_cols=pc, **w["kw"])
                            want = ref.fused_hop_paged(clone_state(hs), pt,
                                                       *args, **kw)
                            got = fused_hop_paged_cuda(clone_state(hs), pt,
                                                       *args, **kw)
                            torch.cuda.synchronize()
                            bad = [f for f in ref.HopState._fields
                                   if not bits_equal(getattr(want, f),
                                                     getattr(got, f))]
                            tag = (f"{mode} n={w['n']} d={w['d']} B={B} "
                                   f"page_cols={pc} tree={use_tree} "
                                   f"live={use_live}")
                            if bad:
                                raise SystemExit(f"paged hop {tag}: "
                                                 f"fields differ: {bad}")
                            fin = want.dists < 1e30
                            if bool(fin.any()):
                                max_err = max(max_err, float(
                                    (want.dists[fin] - got.dists[fin])
                                    .abs().max()))
                            if w is dry and bool(got.active.any()):
                                raise SystemExit("dry paged wave: lanes "
                                                 "still active")
                            n_cases += 1
            log(f"  {mode} n={w['n']} d={w['d']}: B in {w['Bs']} x "
                f"page_cols in (64, 256) bit-identical, pools included")
    fused_hop_paged_cuda.launches = saved
    grid, grid_err = hop_grid(dev, ("f32", "sq8", "pq"), paged=True)
    return n_cases + grid, max(max_err, grid_err)


# ------------------------------------------------------------ phases 4 + 5
def run_searches(dqf, batches, gt, counters, *, record=True,
                 min_recall=0.5):
    """The 4 timed searches through ``DQF.search``: each counter in
    ``counters`` (a wrapper with ``launches``) is set to 0 just before
    them and read just after.  ``min_recall`` is a breakage guard, not a
    target.  Returns (results, per-batch ms, launches, summary)."""
    results, times = [], []
    for c in counters:
        c.launches = 0
    for i, q in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        res = dqf.search(q, record=record)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = start.elapsed_time(end)
        times.append(ms)
        results.append(res)
        log(f"  search batch {i}: {ms:.3f} ms (CUDA events), wall "
            f"{wall * 1e3:.3f} ms, {len(q) / (ms / 1e3):.1f} QPS")
    launches = [c.launches for c in counters]
    n = dqf.x.shape[0]
    ids = torch.cat([r.ids for r in results]).cpu().numpy()
    dists = torch.cat([r.dists for r in results])
    dc = torch.cat([r.stats.dist_count for r in results]).float()
    term = torch.cat([r.stats.terminated_early for r in results]).float()
    nq = sum(len(q) for q in batches)
    if ids.shape != (nq, dqf.cfg.k) or not bool(torch.isfinite(dists).all()):
        raise SystemExit("search output malformed (shape or non-finite)")
    if ids.min() < 0 or ids.max() >= n:
        raise SystemExit("search returned ids outside the index")
    from repro_torch.core.recall import recall_at_k
    recall = recall_at_k(ids, gt)
    qps = nq / (sum(times) / 1e3)
    summary = dict(recall=recall, qps=qps, dist_count=float(dc.mean()),
                   terminated=float(term.mean()), search_ms=times)
    log(f"  recall@10 {recall:.4f}  mean QPS {qps:.1f}  mean dist_count "
        f"{summary['dist_count']:.2f}  terminated early "
        f"{summary['terminated']:.4f}")
    if recall < min_recall:
        raise SystemExit(f"recall@10 {recall:.4f} is below {min_recall:.4f}")
    return results, times, launches, summary


def compare_results(a, b, what):
    pairs = [("ids", a.ids, b.ids), ("dists", a.dists, b.dists)]
    for f in ("dist_count", "hops", "terminated_early", "update_count"):
        pairs.append((f, getattr(a.stats, f), getattr(b.stats, f)))
    bad = [name for name, u, v in pairs if not bits_equal(u, v)]
    if bad:
        raise SystemExit(f"{what} differ in {bad}")
    log(f"  {what}: ids, dists, dist_count, hops, terminated_early, "
        f"update_count bit-identical")


def phase_main(dev, n, seed):
    from repro_torch.core import DQF, DQFConfig, ZipfWorkload
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    x = make_clustered(n, 128, clusters=1024, seed=seed)
    cfg = DQFConfig(knn_k=32, out_degree=32, index_ratio=0.005, k=10,
                    hot_pool=32, full_pool=64, eval_gap=50, max_hops=512,
                    fused=True, fused_hops=8, hot_mode="graph")
    wl = ZipfWorkload(x, seed=seed)
    warm_q, fit_q = wl.sample(4096), wl.sample(2048)
    batches = [wl.sample(1024) for _ in range(4)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dqf = DQF(cfg, device=dev).build(x)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    fused_hop_cuda.launches = 0
    t0 = time.perf_counter()
    # warm(warm_q) in its two steps, the targets kept for phase 13
    warm_targets = dqf.search_baseline(warm_q).ids.cpu().numpy()
    dqf.warm(warm_q, warm_targets)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_launches = fused_hop_cuda.launches
    t0 = time.perf_counter()
    dqf.fit_tree(fit_q)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    log(f"  build {t_build:.3f} s  warm {t_warm:.3f} s "
        f"({warm_launches} fused_hop launches in its baseline search)  "
        f"fit_tree {t_fit:.3f} s  (hot index {dqf.hot.size} rows, "
        f"tree {dqf.tree.arrays.value.numel()} nodes)")
    gt = ground_truth(x, np.concatenate(batches), 10, device=dev)
    results, _, (launches,), summary = run_searches(dqf, batches, gt,
                                                    [fused_hop_cuda])
    peak = torch.cuda.max_memory_allocated()
    log(f"  fused_hop launches in the 4 searches: {launches}  peak device "
        f"memory {peak / 2**30:.3f} GiB")
    if launches <= 0:
        raise SystemExit("the 4 searches never launched the fused_hop kernel")

    # --- phase 5: composed path on the same queries, bit for bit ---
    log("phase 5: fused vs composed search on batch 0, hot phase included")
    fused_res = dqf.search(batches[0], record=False)
    composed = copy.copy(dqf)
    composed.cfg = dataclasses.replace(cfg, fused=False)
    compare_results(fused_res, composed.search(batches[0], record=False),
                    "fused and composed searches")
    gt0 = gt[:1024]
    for name, res in (("dqf", fused_res),
                      ("dual index, no tree",
                       dqf.search_dual_beam(batches[0])),
                      ("beam search, full graph",
                       dqf.search_baseline(batches[0]))):
        log(f"  batch 0, {name}: recall@10 "
            f"{recall_at_k(res.ids.cpu().numpy(), gt0):.4f}, mean "
            f"dist_count {float(res.stats.dist_count.float().mean()):.2f}")
    # the plain Algorithm 3 over the whole graph, all 4 batches: what
    # phase 16's segment search (the same beam search a segment) is held to
    base = [dqf.search_baseline(q) for q in batches]
    baseline_recall = recall_at_k(
        np.concatenate([r.ids.cpu().numpy() for r in base]), gt)
    base_dc = torch.cat([r.stats.dist_count for r in base]).float().mean()
    log(f"  beam search over the full graph (search_baseline, pool "
        f"{cfg.full_pool}), 4 batches: recall@10 {baseline_recall:.4f}, "
        f"mean dist_count {float(base_dc):.2f}")
    # phase 4's answers as ext ids (the identity at build), for phase 13
    answers = [(dqf.to_external(r.ids.cpu().numpy()), r.dists.cpu().numpy())
               for r in results]
    return dict(dqf=dqf, x=x, cfg=cfg, batches=batches, fit_q=fit_q, gt=gt,
                launches=launches, summary=summary, warm_q=warm_q,
                warm_targets=warm_targets, answers=answers,
                baseline_recall=baseline_recall)


# ------------------------------------------------------------------ phase 6
def _event_ms(fn, reps, before=None, back_to_back=False, busy=False,
              median=False):
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events around each call
    (the host's launch work included); ``before`` runs untimed ahead of
    each, and the card finishes it before the call.  ``back_to_back``:
    events around all ``reps`` calls, after one untimed call, so the host's
    work overlaps the device's and the time is the device's.  ``busy``: the
    card sleeps (``torch.cuda._sleep``, about 2 ms) while the host enqueues
    each call, so the events time the device alone.  ``median``: the
    median of the calls in place of their mean."""
    if back_to_back:
        fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            out = fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps, out
    times = []
    for _ in range(reps):
        out = None                     # the last call's output freed first
        if before is not None:
            before()
            torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(4_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times) if median else np.mean(times)), out


def hop_state_bytes(B, L):
    """Bytes of a hop's pool (ids, dists, expanded) and per-lane counters,
    each read and written once."""
    return B * L * (4 + 4 + 1) * 2 + B * 7 * 4 * 2 + B * 8


def hop_bound(mode, B, L, R, d, row_bytes, extra, rows, hops):
    """(bound ms, by, bytes) of fused_hop work that scored ``rows`` rows in
    ``hops`` lane-hops: the rows, R adjacency ids a lane-hop with their
    seen, live and row-state bytes, the pool and counters read and written
    once, and ``extra`` bytes (queries, sq8's scale and zero, pq's LUTs);
    operations at the float32 rate."""
    moved = (rows * row_bytes + hops * R * (4 + 1 + 1 + 1)
             + hop_state_bytes(B, L) + extra)
    flops = rows * {"f32": 3 * d, "sq8": 5 * d, "pq": row_bytes}[mode]
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", moved)


def batch_split(dqf, q, label):
    """One search batch, phase by phase (CUDA events): hot phase, seed,
    fused full phase and, for a quantized index, the exact rerank.  The
    graph hot phase's bound is that of its one fused_hop launch over the
    hot table (rows scored, entries included, and lane-hops from its
    stats).  Returns what the hop timing needs: (queries, table view, seed
    fn, hot features, the hot phase's ms and bound ms).

    The hot table (2.6 MB at 5000 x 128) stays in L2, so the hot phase's
    bound counts its unique device-memory bytes: the hot rows, their
    adjacency lists, live and row-state bytes once, a seen byte for each
    neighbour a lane-hop visits, the pool state and the queries.  The rows
    it scores are L2 traffic, reported beside the bound in bytes (the data
    sheet gives no L2 rate)."""
    from repro_torch.core import beam_search as bs
    from repro_torch.core.dynamic_search import (_exact_rerank,
                                                 _seed_full_state, hot_phase)
    from repro_torch.core.features import hot_features
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda

    c = dqf.cfg
    hd = dqf.hot_tables()
    qt = dqf._queries(q)
    x_pad, adj_pad, live = (dqf._dev["x_pad"], dqf._dev["adj_pad"],
                            dqf._dev["live_pad"])
    saved = fused_hop_cuda.launches, fused_topk_l2_cuda.launches
    hot_ms, (hot_pool, hot_stats) = _event_ms(lambda: hot_phase(
        hd["x_hot_pad"], hd["adj_hot_pad"], hd["hot_entries"], qt,
        pool_size=c.hot_pool, max_hops=c.max_hops, mode=c.hot_mode,
        fused=c.fused), 1)
    hot_launches = fused_hop_cuda.launches - saved[0]
    hot_bound = None
    if c.hot_mode == "graph":
        B, d = qt.shape
        rows, lane_hops = (int(hot_stats.dist_count.sum()),
                           int(hot_stats.hops.sum()))
        n_hot, R = hd["adj_hot_pad"].shape
        moved = (n_hot * (d * 4 + R * 4 + 2) + lane_hops * R
                 + hop_state_bytes(B, c.hot_pool) + B * d * 4)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = rows * 3 * d / FP32_FLOPS * 1e3
        hot_bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"  {label}: hot phase bound {hot_bound:.5f} ms by {by} "
            f"({moved} unique bytes of device memory, {rows * 3 * d} "
            f"operations; {rows} rows scored over the hot table, "
            f"{rows * d * 4} bytes of L2 traffic; {lane_hops} lane-hops), "
            f"{hot_bound / hot_ms:.4f} of bound")
    hot = hot_features(hot_pool, c.k)
    seed = lambda: _seed_full_state(hot_pool, hd["hot_ids_pad"],
                                    x_pad.shape[0] - 1, c.full_pool, live)
    seed_ms, state = _event_ms(seed, 1)
    qtable = dqf._quant_table()
    view_ms, table = _event_ms(
        lambda: x_pad if qtable is None else qtable.with_queries(qt), 1)
    full_ms, state = _event_ms(lambda: bs.fused_beam_loop(
        table, adj_pad, qt, state, c.max_hops, live,
        fused_hops=c.fused_hops, tree=dqf.tree.arrays, hot=hot, k=c.k,
        eval_gap=c.eval_gap, add_step=c.add_step,
        tree_depth=c.tree_depth), 1)
    hops = fused_hop_cuda.launches - saved[0] - hot_launches
    rr_ms = 0.0
    if qtable is not None and dqf._rerank_k > 0:
        rr_ms, _ = _event_ms(lambda: _exact_rerank(
            x_pad, qt, state.pool, k=c.k, rerank_k=dqf._rerank_k,
            live_pad=live), 1)
    fused_hop_cuda.launches, fused_topk_l2_cuda.launches = saved
    log(f"  {label}, one batch of {qt.shape[0]}: hot phase ({c.hot_mode}, "
        f"{hot_launches} fused_hop launches) {hot_ms:.3f} ms, seed "
        f"{seed_ms:.3f} ms, table view {view_ms:.3f} ms, fused full phase "
        f"{full_ms:.3f} ms ({hops} launches), rerank {rr_ms:.3f} ms")
    return qt, table, seed, hot, (hot_ms, hot_bound)


def time_hop(dqf, q, launches, label):
    """``fused_hop`` at the main path's shapes beside its plain version
    and its bound; its first launch of the full phase of batch ``q``."""
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    c = dqf.cfg
    qt, table, seed, hot, (hot_ms, hot_bound) = batch_split(dqf, q, label)
    adj_pad, live = dqf._dev["adj_pad"], dqf._dev["live_pad"]
    tree = dqf.tree.arrays
    spec = ops.table_spec(table)
    mode = spec[0]
    saved = fused_hop_cuda.launches
    hs0 = bs.to_hop_state(seed())
    seen0 = hs0.seen.clone()
    hf, hr = hot.first.contiguous(), hot.first_div_kth.contiguous()
    kw = dict(hops=c.fused_hops, max_hops=c.max_hops, k=c.k,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth)
    reset = lambda: hs0.seen.copy_(seen0)
    launch = lambda: fused_hop_cuda(hs0, adj_pad, qt, live, *spec, tree, hf,
                                    hr, **kw)
    for _ in range(3):                                       # warm up
        reset()
        launch()
    ms, got = _event_ms(launch, 20, reset)
    device_ms, _ = _event_ms(launch, 20, reset, busy=True)
    fused_hop_cuda.launches = saved
    reset()
    launch()
    fused_hop_cuda.launches = saved
    seen_kernel = hs0.seen.clone()
    reset()
    ref.fused_hop(hs0, adj_pad, qt, live, *spec, tree, hf, hr, **kw)
    plain_ms, want = _event_ms(lambda: ref.fused_hop(
        hs0, adj_pad, qt, live, *spec, tree, hf, hr, **kw), 5, reset)
    bad = [f for f in ref.HopState._fields if f != "seen"
           and not bits_equal(getattr(want, f), getattr(got, f))]
    if not torch.equal(hs0.seen, seen_kernel):
        bad.append("seen")
    del seen_kernel
    if bad:
        raise SystemExit(f"timed {mode} launch differs from plain version: "
                         f"{bad}")
    err = float((want.dists - got.dists).abs().max())

    B, L = hs0.ids.shape
    R, d = adj_pad.shape[1], qt.shape[1]
    row_bytes = {"f32": d * 4, "sq8": d, "pq": spec[1].shape[1]}[mode]
    if mode == "pq":                  # the LUTs; pq mode reads no queries
        extra = spec[2].numel() * 4
    else:                             # the queries, and sq8's scale and zero
        extra = B * d * 4 + (2 * d * 4 if mode == "sq8" else 0)

    def bound(out):
        """(bound ms, by, bytes, rows) of a launch from ``hs0`` to ``out``."""
        rows = int((out.dist_count - hs0.dist_count).sum())
        hops = int((out.hops - hs0.hops).sum())
        return (*hop_bound(mode, B, L, R, d, row_bytes, extra, rows, hops),
                rows)

    bound_ms, bound_by, moved, rows = bound(got)
    log(f"  fused_hop {mode} at B={B} L={L} R={R} d={d} hops={c.fused_hops}: "
        f"{ms:.4f} ms/launch (device alone {device_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({moved} bytes, {rows} "
        f"rows scored), {bound_ms / device_ms:.4f} of bound on the device")
    # the one-launch full phase of the search path: hops = max_hops
    full = lambda: fused_hop_cuda(hs0, adj_pad, qt, live, *spec, tree, hf,
                                  hr, **dict(kw, hops=c.max_hops))
    reset()
    full()
    full_ms, out = _event_ms(full, 10, reset)
    full_dev, _ = _event_ms(full, 10, reset, busy=True)
    fused_hop_cuda.launches = saved
    if bool(out.active.any()):
        raise SystemExit("the one-launch full phase left lanes active")
    full_bound, _, full_moved, full_rows = bound(out)
    log(f"  the one-launch full phase ({mode}): {full_ms:.4f} ms (device "
        f"alone {full_dev:.4f}), {int(out.hops.max())} hops in its longest "
        f"lane, bound {full_bound:.5f} ms ({full_moved} bytes, {full_rows} "
        f"rows scored), {full_bound / full_dev:.4f} of bound on the device")
    return {"name": f"fused_hop ({mode})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_hop.cu",
            "replaces": "src/repro/kernels/fused_hop.py:313",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a graph hop",
            "bound_share": bound_ms / ms, "contract": "bits",
            "device_ms": device_ms, "full_phase_ms": full_ms,
            "full_phase_device_ms": full_dev,
            "full_phase_bound_ms": full_bound, "hot_phase_ms": hot_ms,
            "hot_phase_bound_ms": hot_bound}


def time_topk(dqf, q, launches):
    """``fused_topk_l2`` over the hot rows at the mxu path's shapes beside
    its plain version, its bound and ``torch.topk`` of the
    ``torch.matmul`` expansion (TF32 off).  ``ms`` and ``library_ms``
    time one call at a time, as every other row; ``device_ms_b2b`` and
    ``library_ms_b2b`` 50 calls back to back (device time alone)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda

    qt = dqf._queries(q)
    x = dqf.hot_tables()["x_hot_pad"][:-1]
    k = dqf.cfg.hot_pool
    saved = fused_topk_l2_cuda.launches
    launch = lambda: fused_topk_l2_cuda(qt, x, k=k)
    for _ in range(3):                                       # warm up
        launch()
    ms, (got_d, got_i) = _event_ms(launch, 20)
    b2b_ms, _ = _event_ms(launch, 50, back_to_back=True)
    fused_topk_l2_cuda.launches = saved
    ref.fused_topk_l2(qt, x, k=k)
    plain_ms, (want_d, want_i) = _event_ms(
        lambda: ref.fused_topk_l2(qt, x, k=k), 5)
    if not (bits_equal(got_d, want_d) and bits_equal(got_i, want_i)):
        raise SystemExit("timed fused_topk_l2 differs from plain version")
    fin = torch.isfinite(want_d)
    err = float((got_d[fin] - want_d[fin]).abs().max()) if bool(
        fin.any()) else 0.0

    def library():
        d2 = ((qt * qt).sum(1)[:, None] + (x * x).sum(1)[None, :]
              - 2.0 * torch.matmul(qt, x.T))
        return torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False,
                          sorted=True)

    library()
    library_ms, _ = _event_ms(library, 20)
    library_b2b_ms, _ = _event_ms(library, 50, back_to_back=True)
    B, d = qt.shape
    N = x.shape[0]
    flops = 2 * B * N * d + 3 * B * N + 2 * (B + N) * d
    moved = (B + N) * d * 4 + B * k * 8
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"  fused_topk_l2 at B={B} N={N} d={d} k={k}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.topk of the matmul expansion "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({flops} FLOP, "
        f"{moved} bytes), {bound_ms / ms:.4f} of bound; 50 calls back to "
        f"back {b2b_ms:.4f} ms a call, library {library_b2b_ms:.4f} ms")
    return {"name": "fused_topk_l2", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_topk_l2.cu",
            "replaces": "src/repro/kernels/fused_scorer.py:82",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library_note": "torch.topk(largest=False) of q²+x²−2·matmul, "
                            "TF32 off; ties unordered",
            "bound_share": bound_ms / ms, "contract": "bits",
            "device_ms_b2b": b2b_ms, "library_ms_b2b": library_b2b_ms}


# ------------------------------------------------------------------ phase 7
def phase_mxu(ctx):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda

    mxu = copy.copy(ctx["dqf"])
    mxu.cfg = dataclasses.replace(ctx["cfg"], hot_mode="mxu")
    results, _, (launches, hop_launches), summary = run_searches(
        mxu, ctx["batches"], ctx["gt"], [fused_topk_l2_cuda, fused_hop_cuda],
        record=False)
    log(f"  fused_topk_l2 launches in the 4 searches: {launches}  "
        f"(fused_hop: {hop_launches})")
    if launches <= 0:
        raise SystemExit("the 4 mxu searches never launched fused_topk_l2")
    kernel_topk = ops.fused_topk_l2
    ops.fused_topk_l2 = lambda q, x, *, k: ref.fused_topk_l2(q, x, k=k)
    try:
        plain_res = mxu.search(ctx["batches"][0], record=False)
    finally:
        ops.fused_topk_l2 = kernel_topk
    compare_results(results[0], plain_res,
                    "mxu search with the kernel and with the plain top-k")
    return mxu, launches, summary


# ------------------------------------------------------------------ phase 8
PQ_ITERS = 5     # k-means rounds of the PQ training on the host (the
                 # default 15 took 80-100 s of the script's limit)


def phase_quant(ctx, mode, dev):
    from repro_torch.convert import dqf_from_arrays
    from repro_torch.core import QuantConfig
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.quant import build_quantizer

    qcfg = QuantConfig(mode=mode, rerank_k=64, pq_iters=PQ_ITERS)
    t0 = time.perf_counter()
    state = build_quantizer(ctx["x"], qcfg)
    t_train = time.perf_counter() - t0
    ctx.setdefault("quant", {})[mode] = state         # phase 10 scans it
    log(f"  {mode}: quantizer trained on the host in {t_train:.3f} s "
        f"({state.nbytes()} bytes of codes and codebook, "
        f"{ctx['x'].nbytes / state.nbytes():.1f}x smaller than the rows)")
    arrays = ctx["dqf"].to_arrays()            # what DQF.save writes
    arrays.update(state.to_arrays())
    cfg = dataclasses.replace(ctx["cfg"], quant=qcfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dqf = dqf_from_arrays(arrays, cfg, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    dqf.fit_tree(ctx["fit_q"])
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    log(f"  {mode}: dqf_from_arrays {t_load:.3f} s, fit_tree on the codes "
        f"{t_fit:.3f} s (tree {dqf.tree.arrays.value.numel()} nodes)")
    results, _, (launches,), summary = run_searches(
        dqf, ctx["batches"], ctx["gt"], [fused_hop_cuda], record=False,
        min_recall=0.5 * ctx["summary"]["recall"])
    peak = torch.cuda.max_memory_allocated()
    log(f"  {mode}: fused_hop launches in the 4 searches: {launches}  peak "
        f"device memory {peak / 2**30:.3f} GiB")
    if launches <= 0:
        raise SystemExit(f"the 4 {mode} searches never launched fused_hop")
    composed = copy.copy(dqf)
    composed.cfg = dataclasses.replace(cfg, fused=False)
    compare_results(results[0], composed.search(ctx["batches"][0],
                                                record=False),
                    f"{mode} fused and composed searches")
    summary.update(train_s=t_train, fit_s=t_fit, peak_gib=peak / 2**30)
    return dqf, launches, summary


# ------------------------------------------------------------------ phase 9
def serve(eng, plan, counters, k, on_step=None,
          occupancy="engine_occupancy_ratio", statuses=("ok",)):
    """Drive ``eng`` through ``plan`` — a list of (tenant, queries,
    steps after submitting) — then drain it, one ``step()`` at a time,
    calling ``on_step(eng)`` after each.  Every counter in ``counters`` is
    set to 0 just before and read just after; ``occupancy`` is the
    engine's occupancy series.  Returns (rids, results, launches,
    summary)."""
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    occ = []
    rids = []
    t0 = time.perf_counter()
    def step():
        eng.step()
        occ.append(eng._collect_metrics()[occupancy])
        if on_step is not None:
            on_step(eng)

    for tenant, q, steps in plan:
        rids += eng.submit(q, tenant=tenant)
        for _ in range(steps):
            step()
    while eng.queue or eng._any_live():
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    split = {}
    for ev in eng.timeline.events():
        split[ev["name"]] = split.get(ev["name"], 0.0) + ev["dur"] / 1e3
    res = [eng._results[r] for r in rids]
    ids = np.stack([r["ids"] for r in res])
    if ids.shape != (len(rids), k) or any(r["status"] not in statuses
                                          for r in res):
        raise SystemExit("serving output malformed (shape or status)")
    st = eng.stats
    summary = dict(qps=st.completed / wall, p99_ms=st.p99_ms(),
                   queue_wait_p99_ms=st.queue_wait_p99_ms(),
                   ticks=st.ticks, mean_hops=st.total_hops / st.completed,
                   wall_s=wall, peak_gib=torch.cuda.max_memory_allocated()
                   / 2**30, occupancy=float(np.mean(occ)), split_ms=split)
    return rids, res, launches, summary


def compare_serving(ra, rb, what, ticks=None):
    """Per query ids, dists and hops bit for bit; ``ticks``, a pair, must
    be equal too."""
    bad = [i for i, (a, b) in enumerate(zip(ra, rb))
           if not (np.array_equal(a["ids"], b["ids"])
                   and np.array_equal(a["dists"].view(np.int32),
                                      b["dists"].view(np.int32))
                   and a["hops"] == b["hops"])]
    if bad:
        raise SystemExit(f"{what}: {len(bad)} queries differ, first "
                         f"{bad[:10]}")
    if ticks is not None and ticks[0] != ticks[1]:
        raise SystemExit(f"{what}: ticks differ {ticks}")
    log(f"  {what}: {len(ra)} queries, ids, dists and hops bit-identical"
        + (f", {ticks[0]} ticks each" if ticks is not None else ""))


def phase_serving(ctx, dev, seed):
    """Phase 9: both engines on phase 4's index, tree and hot index."""
    from repro_torch.convert import dqf_from_arrays
    from repro_torch.core import ZipfWorkload
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.engine import WaveEngine
    from repro_torch.serving.paged_engine import PagedWaveEngine

    cfg = dataclasses.replace(ctx["cfg"], n_query_trigger=10 ** 9)
    dqf = dqf_from_arrays(ctx["dqf"].to_arrays(), cfg, device=dev)
    dqf.tree = ctx["dqf"].tree
    t0 = time.perf_counter()
    qb = ZipfWorkload(ctx["x"], seed=seed + 1)
    dqf.warm(qb.sample(4096), tenant="b")
    torch.cuda.synchronize()
    log(f"  tenant b warmed in {time.perf_counter() - t0:.3f} s (hot index "
        f"{dqf.tenants.get('b').hot.size} rows; the trigger is out of "
        f"reach, so neither hot index changes while serving)")
    queries = np.concatenate(ctx["batches"])
    gt = ctx["gt"]
    b_q = qb.sample(2048)
    b_gt = ground_truth(ctx["x"], b_q, 10, device=dev)
    counters = [fused_hop_cuda, fused_hop_paged_cuda]
    # the timeline's spans give each run's split (a span ends after a
    # device sync, so "tick.launch" covers the kernel)
    obs = ObsConfig(timeline=True)
    engines = (("fixed", lambda: WaveEngine(dqf, wave_size=256,
                                            tick_hops=8, obs=obs)),
               ("paged", lambda: PagedWaveEngine(dqf, capacity=256,
                                                 tick_hops=8,
                                                 page_cols=256, obs=obs)))
    closed = [("default", queries, 0)]
    bursts = [("default", queries[i:i + 512], 4)
              for i in range(0, 4096, 512)]
    mixed = []
    for i in range(0, 2048, 64):
        mixed += [("default", queries[i:i + 64], 0),
                  ("b", b_q[i:i + 64], 0)]
    mixed_gt = np.concatenate([np.concatenate([gt[i:i + 64],
                                               b_gt[i:i + 64]])
                               for i in range(0, 2048, 64)])
    runs = (("closed loop, 4096 at once", closed, gt),
            ("open loop, 8 bursts of 512, 4 steps apart", bursts, gt),
            ("two tenants, 2048 each, interleaved by 64", mixed, mixed_gt))
    out = {}
    for title, plan, want_gt in runs:
        got = {}
        for name, make in engines:
            eng = make()
            rids, res, launches, summ = serve(eng, plan, counters,
                                              dqf.cfg.k)
            ids = np.stack([r["ids"] for r in res])
            summ["recall"] = recall_at_k(ids, want_gt)
            summ["launches"] = dict(zip(("fused_hop", "fused_hop_paged"),
                                        launches))
            if name == "paged":
                pool = eng.pagepool
                summ["pool"] = (pool.n_pages, pool.pages_per_lane,
                                pool.n_pages * pool.page_cols)
            log(f"  {title}, {name}: QPS {summ['qps']:.1f}, p99 "
                f"{summ['p99_ms']:.3f} ms, queue-wait p99 "
                f"{summ['queue_wait_p99_ms']:.3f} ms, ticks "
                f"{summ['ticks']}, mean hops {summ['mean_hops']:.3f}, "
                f"recall@10 {summ['recall']:.4f}, launches fused_hop "
                f"{launches[0]} fused_hop_paged {launches[1]}, peak "
                f"{summ['peak_gib']:.3f} GiB, mean occupancy "
                f"{summ['occupancy']:.4f}"
                + (f", pool {summ['pool'][0]} pages x "
                   f"{eng.page_cols} B ({summ['pool'][1]} a lane, "
                   f"{summ['pool'][2]} bytes)" if name == "paged" else ""))
            sp = summ["split_ms"]
            log(f"    split, ms summed over the run's "
                f"{summ['wall_s'] * 1e3:.1f}: ticks "
                f"{sp.get('tick', 0):.1f} = launch "
                f"{sp.get('tick.launch', 0):.1f} + retire "
                f"{sp.get('tick.retire', 0):.1f} (pool free "
                f"{sp.get('retire.free', 0):.1f}) + refill "
                f"{sp.get('tick.refill', 0):.1f} (hot phase and seed "
                f"{sp.get('refill.hot_phase', 0):.1f}, pool alloc "
                f"{sp.get('refill.alloc', 0):.1f}) + housekeeping "
                f"{sp.get('tick.housekeeping', 0):.1f}")
            if summ["recall"] < 0.5:
                raise SystemExit(f"{title}, {name}: recall@10 "
                                 f"{summ['recall']:.4f} is below 0.5")
            # both engines' refills run the hot phase through fused_hop;
            # only the paged engine's ticks launch fused_hop_paged
            if launches[0] <= 0 or (launches[1] > 0) != (name == "paged"):
                raise SystemExit(f"{title}, {name}: launches (fused_hop, "
                                 f"fused_hop_paged) = {launches}")
            got[name] = (res, summ)
            del eng
            torch.cuda.empty_cache()
        compare_serving(got["fixed"][0], got["paged"][0],
                        f"{title}: paged vs fixed",
                        (got["fixed"][1]["ticks"], got["paged"][1]["ticks"]))
        out[title] = got
    compare_serving(out[runs[0][0]]["paged"][0], out[runs[1][0]]["paged"][0],
                    "open loop vs closed loop, paged")
    return dqf, out


def time_paged_hop(dqf, q, paged_launches, syn_err):
    """One ``fused_hop_paged`` launch at the paged engine's shapes (a
    256-lane bucket, pages of 256 from the engine's allocator, 8 hops)
    beside the dense ``fused_hop`` at the same B, the plain paged version
    and the bound."""
    from repro_torch.core import beam_search as bs
    from repro_torch.core.dynamic_search import _seed_full_state, hot_phase
    from repro_torch.core.features import hot_features
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.serving.paged import PagePool

    c = dqf.cfg
    B, pc = 256, 256
    qt = dqf._queries(q[:B])
    hd = dqf.hot_tables()
    x_pad, adj_pad, live = (dqf._dev["x_pad"], dqf._dev["adj_pad"],
                            dqf._dev["live_pad"])
    hot_pool, _ = hot_phase(hd["x_hot_pad"], hd["adj_hot_pad"],
                            hd["hot_entries"], qt, pool_size=c.hot_pool,
                            max_hops=c.max_hops, mode=c.hot_mode)
    hot = hot_features(hot_pool, c.k)
    hs0 = bs.to_hop_state(_seed_full_state(hot_pool, hd["hot_ids_pad"],
                                           x_pad.shape[0] - 1, c.full_pool,
                                           live))
    n1 = adj_pad.shape[0]
    alloc = PagePool(B, n1 - 1, page_cols=pc)
    alloc.free(alloc.alloc(B // 2))         # recycled pages: shuffled order
    pt = torch.as_tensor(alloc.page_table[alloc.alloc(B)], device=qt.device)
    ppl = pt.shape[1]
    pool0 = torch.zeros((alloc.n_pages, pc), dtype=torch.bool,
                        device=qt.device)
    pool0[pt.long()] = torch.nn.functional.pad(
        hs0.seen, (0, ppl * pc - n1)).reshape(B, ppl, pc)
    hp = hs0._replace(seen=pool0.clone())
    seen0 = hs0.seen.clone()
    hf, hr = hot.first.contiguous(), hot.first_div_kth.contiguous()
    kw = dict(hops=c.fused_hops, max_hops=c.max_hops, k=c.k,
              eval_gap=c.eval_gap, add_step=0, tree_depth=c.tree_depth)
    args = (adj_pad, qt, live, "f32", x_pad, None, None, dqf.tree.arrays, hf,
            hr)
    saved = fused_hop_cuda.launches, fused_hop_paged_cuda.launches
    reset_p = lambda: hp.seen.copy_(pool0)
    reset_d = lambda: hs0.seen.copy_(seen0)
    paged = lambda: fused_hop_paged_cuda(hp, pt, *args, page_cols=pc, **kw)
    dense = lambda: fused_hop_cuda(hs0, *args, **kw)
    for _ in range(3):
        reset_p()
        paged()
        reset_d()
        dense()
    ms, got = _event_ms(paged, 20, reset_p)
    device_ms, _ = _event_ms(paged, 20, reset_p, busy=True)
    dense_ms, _ = _event_ms(dense, 20, reset_d)
    reset_p()
    got = paged()
    fused_hop_cuda.launches, fused_hop_paged_cuda.launches = saved
    pool_kernel = hp.seen.clone()
    reset_p()
    ref.fused_hop_paged(hp, pt, *args, page_cols=pc, **kw)
    plain_ms, want = _event_ms(lambda: ref.fused_hop_paged(
        hp, pt, *args, page_cols=pc, **kw), 5, reset_p)
    bad = [f for f in ref.HopState._fields if f != "seen"
           and not bits_equal(getattr(want, f), getattr(got, f))]
    if not torch.equal(hp.seen, pool_kernel):
        bad.append("pool")
    if bad:
        raise SystemExit(f"timed paged launch differs from plain version: "
                         f"{bad}")
    err = max(syn_err, float((want.dists - got.dists).abs().max()))
    L, R, d = hs0.ids.shape[1], adj_pad.shape[1], qt.shape[1]
    rows = int((got.dist_count - hs0.dist_count).sum())
    hops = int((got.hops - hs0.hops).sum())
    state = B * L * (4 + 4 + 1) * 2 + B * 7 * 4 * 2 + B * 8
    tail = ppl * pc - n1
    moved = (rows * d * 4 + hops * R * (4 + 1 + 1 + 1 + 4) + state
             + B * d * 4 + B * tail)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * 3 * d / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"  fused_hop_paged f32 at B={B} L={L} R={R} d={d} page_cols={pc} "
        f"hops={c.fused_hops}: {ms:.4f} ms/launch (device alone "
        f"{device_ms:.4f}), dense fused_hop {dense_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({moved} bytes, {rows} "
        f"rows scored, {hops} lane-hops), {bound_ms / device_ms:.4f} of "
        f"bound on the device")
    return {"name": "fused_hop_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_hop.cu",
            "replaces": "src/repro/kernels/fused_hop.py:431",
            "launches": paged_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a graph hop",
            "dense_ms": dense_ms, "bound_share": bound_ms / ms,
            "contract": "bits", "device_ms": device_ms}


# ------------------------------------------------------------------ phase 11
def _hop_counts():
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    return fused_hop_cuda.launches, fused_hop_paged_cuda.launches


def _no_dead(ids, dqf, what):
    """No tombstoned (or out-of-range) id in ``ids``."""
    ids = np.asarray(ids)
    if ids.min() < 0 or ids.max() >= dqf.store.n:
        raise SystemExit(f"{what}: ids outside the index")
    dead = int((~dqf.store.alive[ids]).sum())
    if dead:
        raise SystemExit(f"{what}: {dead} tombstoned ids returned")


def _self_hits(res, want) -> float:
    """Share of lanes whose top-k holds their own id ``want[lane]``."""
    return float((res.ids.cpu().numpy()
                  == np.asarray(want)[:, None]).any(axis=1).mean())


def _live_recall(dqf, batches, k, dev):
    """recall@10 of ``search`` and of ``search_dual_beam`` (no tree) over
    ``batches``, against the exact top-k of the live rows."""
    from repro_torch.core.recall import ground_truth, recall_at_k

    live = dqf.store.live_ids()
    gt = live[ground_truth(dqf.store.x[live], np.concatenate(batches), k,
                           device=dev)]
    run = lambda fn: np.concatenate([fn(q).ids.cpu().numpy()
                                     for q in batches])
    return (recall_at_k(run(lambda q: dqf.search(q, record=False)), gt),
            recall_at_k(run(dqf.search_dual_beam), gt))


MUTATION_DELETES = 2000   # rows phase 11 deletes (cut from 5,000 to keep
                          # the script inside its limit)


def phase_mutation(ctx, dev, seed, n_insert=512, n_delete=5000):
    """Phase 11: the mutable main path on phase 4's index.  Save and load
    a clone, then serve four rounds through the fixed engine (original)
    and the paged engine (clone) with the same churn applied to both at
    the drain boundaries: insert ``n_insert`` rows, delete ``n_delete``,
    compact.  The checkpoints live in a temp dir removed at the end."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return _mutation(ctx, dev, seed, n_insert, n_delete, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mutation(ctx, dev, seed, n_insert, n_delete, tmp):
    from repro_torch.core import DQF
    from repro_torch.core.ssg import _bfs
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.serving.engine import WaveEngine
    from repro_torch.serving.paged_engine import PagedWaveEngine

    orig = ctx["dqf"]
    cfg = dataclasses.replace(ctx["cfg"], n_query_trigger=10 ** 9)
    orig.cfg = cfg                      # phase 9's trigger out of reach
    batches, k = ctx["batches"], cfg.k
    out = {"timings": {}}
    tm = out["timings"]
    path = os.path.join(tmp, "phase4.npz")
    t0 = time.perf_counter()
    orig.save(path)
    tm["save_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clone = DQF.load(path, cfg)
    torch.cuda.synchronize()
    tm["load_s"] = time.perf_counter() - t0
    size = os.path.getsize(path)
    log(f"  save {tm['save_s']:.3f} s ({size} bytes), DQF.load onto the "
        f"card {tm['load_s']:.3f} s")
    if clone.device.type != dev.type:     # DQF.load's default: the card
        raise SystemExit(f"DQF.load put the clone on {clone.device}")
    compare_results(orig.search(batches[0], record=False),
                    clone.search(batches[0], record=False),
                    "batch 0, original and loaded clone")

    fixed = WaveEngine(orig, wave_size=256, tick_hops=8)
    paged = PagedWaveEngine(clone, capacity=256, tick_hops=8,
                            page_cols=256)
    rng = np.random.default_rng(seed)
    fused_hop_cuda.launches = fused_hop_paged_cuda.launches = 0
    hop_entries = {}
    peak = 0                   # serve() resets the peak: kept across calls

    def fused_vs_composed(label):
        composed = copy.copy(orig)
        composed.cfg = dataclasses.replace(cfg, fused=False)
        compare_results(orig.search(batches[0], record=False),
                        composed.search(batches[0], record=False),
                        f"{label}: fused and composed searches")
        saved = _hop_counts()
        hop_entries[label] = time_hop(orig, batches[0], None, label)
        fused_hop_cuda.launches, fused_hop_paged_cuda.launches = saved

    for rnd, q in enumerate(batches):
        got = {}
        for name, eng in (("fixed", fixed), ("paged", paged)):
            # the engines' stats run on across rounds: take differences
            before, ticks, hops = (_hop_counts(), eng.stats.ticks,
                                   eng.stats.total_hops)
            peak = max(peak, torch.cuda.max_memory_allocated())
            _, res, _, summ = serve(eng, [("default", q, 0)], [], k)
            launches = [a - b for a, b in zip(_hop_counts(), before)]
            summ["ticks"] -= ticks
            qps = len(q) / summ["wall_s"]
            _no_dead(np.stack([r["ids"] for r in res]), eng.dqf,
                     f"round {rnd + 1}, {name}")
            got[name] = (res, summ)
            log(f"  round {rnd + 1}, {name}: QPS {qps:.1f} ({len(q)} "
                f"queries in {summ['wall_s'] * 1e3:.1f} ms), ticks "
                f"{summ['ticks']}, mean hops "
                f"{(eng.stats.total_hops - hops) / len(q):.3f}, launches "
                f"fused_hop {launches[0]} fused_hop_paged {launches[1]}, "
                f"store n {eng.dqf.store.n} capacity "
                f"{eng.dqf.store.capacity}")
            out[f"round{rnd + 1}_{name}_qps"] = qps
        compare_serving(got["fixed"][0], got["paged"][0],
                        f"round {rnd + 1}: paged vs fixed",
                        (got["fixed"][1]["ticks"], got["paged"][1]["ticks"]))
        if rnd == 0:                                        # insert 512
            src = rng.choice(ctx["x"].shape[0], n_insert)
            rows = ctx["x"][src] + 0.02 * rng.standard_normal(
                (n_insert, ctx["x"].shape[1])).astype(np.float32)
            # the rows drawn from, searched as queries before the insert:
            # how often a built row finds itself (the index's own bar)
            built = {name: _self_hits(fn(np.ascontiguousarray(
                ctx["x"][src])), src) for name, fn in
                (("search", lambda q: orig.search(q, record=False)),
                 ("search_baseline", orig.search_baseline))}
            cap0, n0 = orig.store.capacity, orig.store.n
            ext = []
            for name, d in (("original", orig), ("clone", clone)):
                t0 = time.perf_counter()
                ext.append(d.insert(rows))
                dt = time.perf_counter() - t0
                tm[f"insert_{name}_s"] = dt
                log(f"  insert {n_insert} rows into the {name}: {dt:.3f} s "
                    f"({dt / n_insert * 1e3:.3f} ms a row), capacity {cap0} -> "
                    f"{d.store.capacity}")
            if not np.array_equal(ext[0], ext[1]) \
                    or orig.store.capacity == cap0:
                raise SystemExit("insert: external ids differ between the "
                                 "twins, or the capacity did not grow")
            new = np.arange(n0, n0 + n_insert)
            found = {"search": _self_hits(orig.search(rows, record=False),
                                          new),
                     "search_baseline": _self_hits(
                         orig.search_baseline(rows), new)}
            out["inserted_found"], out["built_found"] = found, built
            for name in found:
                log(f"  {name}: {found[name]:.4f} of the {n_insert} inserted "
                    f"rows find their own id in their top-10; the rows they "
                    f"were drawn from, before the insert: "
                    f"{built[name]:.4f}")
            # an inserted row must be found about as often as a built one
            # (at 1,200 rows both are near 1, the reference test's 0.8 bar);
            # 0.1 is over 3 standard deviations of the difference of two
            # rates near 0.3 over 512 rows, and an unlinked row reads 0
            if found["search"] < built["search"] - 0.1:
                raise SystemExit("the inserted rows are found less often "
                                 "than the built rows less 0.1")
            rec = out["recall_after_insert"] = _live_recall(orig, batches,
                                                            k, dev)
            base = ctx["summary"]["recall"]
            log(f"  recall@10 over the live rows after the insert "
                f"{rec[0]:.4f} (phase 4: {base:.4f}); without the tree "
                f"{rec[1]:.4f}")
            if rec[0] < base - 0.02:           # a breakage guard
                raise SystemExit("recall after the insert fell more than "
                                 "0.02 below phase 4's")
            fused_vs_composed("after insert, float32")
        elif rnd == 1:                                      # delete
            live = orig.store.live_ids()
            dead_int = rng.choice(live, n_delete, replace=False)
            dead_ext = orig.store.to_external(dead_int)
            hot_hit = int(np.isin(orig.hot.ids, dead_int).sum())
            version = orig.hot.version
            for name, d in (("original", orig), ("clone", clone)):
                t0 = time.perf_counter()
                n_dead = d.delete(dead_ext)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                tm[f"delete_{name}_s"] = dt
                log(f"  delete {n_delete} rows from the {name}: {dt:.3f} s "
                    f"({dt / n_delete * 1e3:.3f} ms a row; {hot_hit} hot rows "
                    f"hit, hot index {version} -> {d.hot.version})")
                if n_dead != n_delete:
                    raise SystemExit(f"delete removed {n_dead} rows")
            if not (np.array_equal(orig.hot.ids, clone.hot.ids)
                    and np.array_equal(orig.hot.graph.adj,
                                       clone.hot.graph.adj)
                    and np.array_equal(orig.full.adj, clone.full.adj)):
                raise SystemExit("delete: the twins' graphs differ")
            for b, qb in enumerate(batches):
                _no_dead(orig.search(qb, record=False).ids.cpu(), orig,
                         f"search, batch {b}, after the delete")
            _no_dead(orig.search_dual_beam(batches[0]).ids.cpu(), orig,
                     "search_dual_beam after the delete")
            _no_dead(orig.search_baseline(batches[0]).ids.cpu(), orig,
                     "search_baseline after the delete")
            log("  no tombstoned id in search (4 batches), "
                "search_dual_beam or search_baseline")
            # the delete rebuilt the hot index from the counter (Alg 2's
            # reselection, as the reference's delete does): reported here,
            # and the probe at the end measures that reselection alone
            rec = out["recall_after_delete"] = _live_recall(orig, batches,
                                                            k, dev)
            log(f"  recall@10 over the live rows after the delete "
                f"{rec[0]:.4f}; without the tree {rec[1]:.4f}")
            fused_vs_composed("after delete, float32")
        elif rnd == 2:                                      # compact
            live = orig.store.live_ids()
            keep_ext = orig.store.to_external(live)
            keep_vec = orig.store.x[live].copy()
            for name, d in (("original", orig), ("clone", clone)):
                t0 = time.perf_counter()
                res = d.compact()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                t = d.timings
                tm[f"compact_{name}_s"] = dt
                tm[f"compact_{name}_split_s"] = (
                    t.compact_store, t.compact_graph, t.compact_repair)
                log(f"  compact the {name}: {dt:.3f} s (store "
                    f"{t.compact_store:.3f}, compact_adjacency "
                    f"{t.compact_graph:.3f}, repair {t.compact_repair:.3f}); "
                    f"dropped {res['dropped']}, n {d.store.n}")
            if not np.array_equal(orig.full.adj, clone.full.adj):
                raise SystemExit("compact: the twins' graphs differ")
            back = orig.store.to_internal(keep_ext)
            if not np.array_equal(orig.store.x[back].view(np.int32),
                                  keep_vec.view(np.int32)):
                raise SystemExit("compact: a live row lost its vector")
            del keep_vec
            n = orig.store.n
            adj = torch.as_tensor(np.where(orig.full.adj < 0, n,
                                           orig.full.adj).astype(np.int64),
                                  device=dev)
            seen = torch.zeros(n, dtype=torch.bool, device=dev)
            _bfs(adj, seen, torch.as_tensor(orig.full.entries.astype(
                np.int64), device=dev))
            if not bool(seen.all()):
                raise SystemExit(f"compact: {int((~seen).sum())} live nodes "
                                 f"unreachable from the entry set")
            del adj, seen
            log(f"  every live row keeps its vector under its external id "
                f"({len(keep_ext)} rows, bit for bit); all {n} nodes "
                f"reachable from the {orig.full.entries.size} entries")
            rec = out["recall_after_compact"] = _live_recall(orig, batches,
                                                             k, dev)
            before = out["recall_after_delete"][0]
            log(f"  recall@10 over the live rows after the compact "
                f"{rec[0]:.4f} (before it: {before:.4f}); without the tree "
                f"{rec[1]:.4f}")
            if rec[0] < before - 0.02:         # a breakage guard
                raise SystemExit("recall after the compact fell more than "
                                 "0.02 below the recall before it")
    launches = _hop_counts()
    out["launches"] = launches
    log(f"  launches in phase 11: fused_hop {launches[0]}, fused_hop_paged "
        f"{launches[1]}")
    if min(launches) <= 0:
        raise SystemExit("phase 11 never launched fused_hop or "
                         "fused_hop_paged")

    churned = os.path.join(tmp, "churned.npz")
    t0 = time.perf_counter()
    orig.save(churned)
    tm["save_churned_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = DQF.load(churned, cfg)
    torch.cuda.synchronize()
    tm["load_churned_s"] = time.perf_counter() - t0
    log(f"  the churned original: save {tm['save_churned_s']:.3f} s, load "
        f"{tm['load_churned_s']:.3f} s")
    compare_results(orig.search(batches[0], record=False),
                    again.search(batches[0], record=False),
                    "batch 0, churned original and its reload")
    del again, clone, paged, fixed
    torch.cuda.empty_cache()
    # Alg 2's reselection without any churn: phase 4's checkpoint reloaded,
    # its hot index rebuilt from its own counter (what the delete did)
    probe = DQF.load(path, cfg)
    kept = _live_recall(probe, batches, k, dev)
    probe.rebuild_hot()
    out["recall_reselected"] = _live_recall(probe, batches, k, dev)
    log(f"  phase 4's checkpoint, no churn: recall@10 {kept[0]:.4f} (without "
        f"the tree {kept[1]:.4f}); its hot index reselected from its "
        f"counter (Alg 2): {out['recall_reselected'][0]:.4f} (without the "
        f"tree {out['recall_reselected'][1]:.4f})")
    del probe
    out["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    log(f"  peak device memory in phase 11: {out['peak_gib']:.3f} GiB")
    out["hops"] = hop_entries
    return out


# ------------------------------------------------------------------ phase 12
TIER_FRACS = (1.0, 0.25, 0.10)


def copy_arrays(dqf) -> dict:
    """``dqf.to_arrays()`` copied (its store views move under later
    mutations): what ``DQF.save`` writes, kept in host memory."""
    return {k: np.array(v, copy=True) for k, v in dqf.to_arrays().items()}


def same_result(a, b) -> bool:
    """``compare_results``'s fields bit for bit, as a verdict."""
    pairs = [(a.ids, b.ids), (a.dists, b.dists)] + [
        (getattr(a.stats, f), getattr(b.stats, f))
        for f in ("dist_count", "hops", "terminated_early", "update_count")]
    return all(bits_equal(u, v) for u, v in pairs)


class TierClock:
    """Host clocks (the card synchronised on both sides) around a tiered
    search's pieces while active: the hot phase, the full phase with its
    host fetches, the rerank (its rows fetched too), the caches'
    ``host_fetch`` (the numpy read) and ``maintain`` (admissions and
    their arena upload), summed in ms, and the blocks admitted."""

    PHASES = ("hot_phase", "_full_phase", "_exact_rerank")

    def __init__(self, dqf):
        self.caches = dqf.store.tier_caches()
        self.acc = dict.fromkeys(("hot_phase", "_full_phase",
                                  "_exact_rerank", "host_fetch", "maintain",
                                  "admitted"), 0.0)

    def _timed(self, name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.acc[name] += (time.perf_counter() - t0) * 1e3
            if name == "maintain":
                self.acc["admitted"] += out
            return out
        return run

    def __enter__(self):
        # the module (``repro_torch.core.dynamic_search`` the attribute is
        # the function of that name)
        ds = sys.modules["repro_torch.core.dynamic_search"]
        self._ds = ds
        self._saved = {name: getattr(ds, name) for name in self.PHASES}
        for name, fn in self._saved.items():
            setattr(ds, name, self._timed(name, fn))
        for c in self.caches:          # instance attributes shadow methods
            c.host_fetch = self._timed("host_fetch", c.host_fetch)
            c.maintain = self._timed("maintain", c.maintain)
        return self.acc

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._ds, name, fn)
        for c in self.caches:
            del c.host_fetch, c.maintain
        return False


def tier_cfg(cfg, tmp, name, frac, **over):
    from repro_torch.core import TierConfig
    path = os.path.join(tmp, name)
    return dataclasses.replace(cfg, tier=TierConfig(
        mode="host", dir=path, block_rows=64, cache_frac=frac, **over))


def tier_searches(dqf, batches):
    """``search`` over ``batches`` (record=False), a host clock around each
    (synchronised), the split summed over them, and each cache's counter
    deltas.  No fused_hop launch may happen: the tier gates it off."""
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)

    before = {c.name: dict(c.counters) for c in dqf.store.tier_caches()}
    hops0 = fused_hop_cuda.launches + fused_hop_paged_cuda.launches
    res, ms = [], []
    with TierClock(dqf) as acc:
        for q in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.append(dqf.search(q, record=False))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    if fused_hop_cuda.launches + fused_hop_paged_cuda.launches != hops0:
        raise SystemExit("a tiered search launched the fused hop")
    delta = {c.name: {k: c.counters[k] - before[c.name][k]
                      for k in c.counters} for c in dqf.store.tier_caches()}
    return res, ms, dict(acc), delta


def _mem_totals(dqf):
    m = dqf.memory_report()
    return {k: m[k]["total"] for k in ("device", "host", "disk")}


def check_fresh_blocks(dqf, what):
    """Every resident block of every cache holds the file's current bytes
    (through the layout): no block serves stale rows."""
    n_blocks = 0
    for c in dqf.store.tier_caches():
        slots = np.flatnonzero(c._slot_bid >= 0)
        got = c.arena_dev()[torch.as_tensor(slots, device=c.device)]
        got = got.cpu().numpy()
        want = np.stack([c._load_block(int(b)) for b in c._slot_bid[slots]])
        if not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
            raise SystemExit(f"{what}: a {c.name} block serves stale bytes")
        n_blocks += slots.size
    log(f"  {what}: all {n_blocks} resident blocks hold the files' bytes")


def tier_report(label, ms, acc, delta, snaps, recall, mem, mem_r):
    rows = sum(d["misses"] for d in delta.values())
    gathered = sum(d["hits"] + d["misses"] for d in delta.values())
    nb = len(ms)
    log(f"  {label}: ms a batch {', '.join(f'{t:.1f}' for t in ms)}; "
        f"split a batch: hot phase {acc['hot_phase'] / nb:.1f}, full phase "
        f"with its host fetches {acc['_full_phase'] / nb:.1f}, rerank "
        f"{acc['_exact_rerank'] / nb:.1f}; host_fetch "
        f"{acc['host_fetch'] / nb:.1f} ms and {rows / nb:.0f} rows read "
        f"of {gathered / nb:.0f} gathered a batch; maintain "
        f"{acc['maintain'] / nb:.1f} ms and {acc['admitted'] / nb:.0f} "
        f"admissions a batch")
    if snaps:
        log(f"    window hit rate (full-phase cache): warm batches 1-2 "
            f"{snaps[0]:.4f}, after relayout_tier batches 3-4 "
            f"{snaps[1]:.4f}, the 4 batches {snaps[2]:.4f}")
    log(f"    recall@10 {recall:.4f}; memory_report totals, tiered / "
        f"resident: device {mem['device']} / {mem_r['device']}, host "
        f"{mem['host']} / {mem_r['host']}, disk {mem['disk']} / "
        f"{mem_r['disk']} bytes")


def phase_tier(ctx, dev, seed, saved, n_insert=512, n_delete=1000,
               chaos_q=256):
    """Phase 12: the disk tier at the main path's size.  ``saved`` holds
    phase 4's and phase 8's indexes as arrays (``copy_arrays``).  The
    block files live in a temp dir removed at the end, also on a failed
    check."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tier-")
    try:
        return _tier(ctx, dev, seed, saved, n_insert, n_delete, chaos_q,
                     tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _free(*dqfs):
    for d in dqfs:
        if d.store.tiered:
            for c in d.store.tier_caches():
                c.close()
            shutil.rmtree(d.store.tier_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def _tier(ctx, dev, seed, saved, n_insert, n_delete, chaos_q, tmp):
    from repro_torch.chaos import FaultPlan, install_chaos, uninstall_chaos
    from repro_torch.convert import dqf_from_arrays
    from repro_torch.core import QuantConfig, ZipfWorkload
    from repro_torch.core.recall import recall_at_k
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.engine import WaveEngine
    from repro_torch.serving.paged_engine import PagedWaveEngine

    batches, gt = ctx["batches"], ctx["gt"]
    base = dataclasses.replace(ctx["cfg"], n_query_trigger=10 ** 9)
    cfgs = {"f32": base,
            "sq8": dataclasses.replace(base, quant=QuantConfig(
                mode="sq8", rerank_k=64)),
            "pq": dataclasses.replace(base, quant=QuantConfig(
                mode="pq", rerank_k=64))}
    wl = ZipfWorkload(ctx["x"], seed=seed + 2)
    warm = [wl.sample(1024) for _ in range(4)]
    out = {}
    torch.cuda.reset_peak_memory_stats()
    peak = 0

    def resident(mode):
        """(composed, fused) resident twins of one saved index: the
        composed one is the bar, the fused one is reported."""
        r = dqf_from_arrays(saved[mode], dataclasses.replace(
            cfgs[mode], fused=False), device=dev)
        f = copy.copy(r)
        f.cfg = dataclasses.replace(r.cfg, fused=True)
        return r, f

    def run(dqf, bs_):
        return [dqf.search(q, record=False) for q in bs_]

    def recall(res):
        return recall_at_k(torch.cat([r.ids for r in res]).cpu().numpy(),
                           gt)

    # --- sq8, the reference's tiered configuration, at three cache sizes
    r_sq8, f_sq8 = resident("sq8")
    want = run(r_sq8, batches)
    fused_sq8 = run(f_sq8, batches)
    mem_r = _mem_totals(r_sq8)
    t25 = None
    for frac in TIER_FRACS:
        t0 = time.perf_counter()
        t = dqf_from_arrays(saved["sq8"], tier_cfg(
            cfgs["sq8"], tmp, f"sq8_{frac}", frac), device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if t._fused:
            raise SystemExit("a tiered DQF left the fused path on")
        cache = t.store.full_phase_cache()
        for q in warm[:2]:
            t.search(q, record=False)
        snaps = [cache.stats_snapshot()["hit_rate"]]
        if not t.relayout_tier():
            raise SystemExit("relayout_tier saw no traffic")
        for q in warm[2:]:
            t.search(q, record=False)
        snaps.append(cache.stats_snapshot()["hit_rate"])
        res, ms, acc, delta = tier_searches(t, batches)
        snaps.append(cache.stats_snapshot()["hit_rate"])
        for b, (g, w) in enumerate(zip(res, want)):
            compare_results(g, w, f"sq8 at {frac:.0%} cache, batch {b}: "
                            "tiered and resident fused=False")
        fused_eq = all(same_result(g, w) for g, w in zip(res, fused_sq8))
        mem = _mem_totals(t)
        rec = recall(res)
        log(f"  sq8 at {frac:.0%} cache ({cache.slots} of "
            f"{cache.bf.n_blocks} code blocks, "
            f"{t.store._row_cache.slots} row blocks; load "
            f"{t_load:.3f} s): equal to the resident fused=True search: "
            f"{fused_eq}")
        tier_report(f"sq8 at {frac:.0%}", ms, acc, delta, snaps, rec, mem,
                    mem_r)
        out[f"sq8_{frac}"] = dict(ms=ms, split=acc, delta=delta,
                                  snaps=snaps, recall=rec, mem=mem,
                                  mem_resident=mem_r, fused_equal=fused_eq,
                                  load_s=t_load)
        peak = max(peak, torch.cuda.max_memory_allocated())
        if frac == 0.25:
            t25 = t
        else:
            _free(t)
            del t
    del f_sq8

    # --- float32 and pq at 25%, mxu on the float32 twin
    for mode in ("f32", "pq"):
        r, f = resident(mode)
        t = dqf_from_arrays(saved[mode], tier_cfg(cfgs[mode], tmp,
                                                  f"{mode}_0.25", 0.25),
                            device=dev)
        res, ms, acc, delta = tier_searches(t, batches)
        for b, (g, w) in enumerate(zip(res, run(r, batches))):
            compare_results(g, w, f"{mode} at 25% cache, batch {b}: "
                            "tiered and resident fused=False")
        fused_eq = all(same_result(g, w) for g, w in zip(res, run(f,
                                                                  batches)))
        log(f"  {mode} at 25% cache: equal to the resident fused=True "
            f"search: {fused_eq}")
        tier_report(f"{mode} at 25%", ms, acc, delta, None, recall(res),
                    _mem_totals(t), _mem_totals(r))
        out[f"{mode}_0.25"] = dict(ms=ms, split=acc, delta=delta,
                                   recall=recall(res),
                                   fused_equal=fused_eq)
        if mode == "f32":
            mt, mr, mf = copy.copy(t), copy.copy(r), copy.copy(f)
            for d in (mt, mr, mf):
                d.cfg = dataclasses.replace(d.cfg, hot_mode="mxu")
            fused_topk_l2_cuda.launches = 0
            res, ms, acc, delta = tier_searches(mt, batches)
            launches = fused_topk_l2_cuda.launches
            for b, (g, w) in enumerate(zip(res, run(mr, batches))):
                compare_results(g, w, f"mxu at 25% cache, batch {b}: "
                                "tiered and resident fused=False")
            fused_eq = all(same_result(g, w)
                           for g, w in zip(res, run(mf, batches)))
            log(f"  mxu at 25% cache: fused_topk_l2 launches in the 4 "
                f"tiered searches: {launches}; equal to the resident "
                f"fused=True search: {fused_eq}")
            if launches <= 0:
                raise SystemExit("the tiered mxu searches never launched "
                                 "fused_topk_l2")
            tier_report("mxu at 25%", ms, acc, delta, None, recall(res),
                        _mem_totals(mt), _mem_totals(mr))
            out["mxu_0.25"] = dict(ms=ms, split=acc, launches=launches,
                                   recall=recall(res), fused_equal=fused_eq)
            del mt, mr, mf
        peak = max(peak, torch.cuda.max_memory_allocated())
        _free(t, r)
        del t, r, f

    # --- engines on the sq8 twin at 25%, prefetch on; phase 4's first two
    # batches (all four until the script neared its time limit on a slow
    # host)
    queries = np.concatenate(batches[:2])
    cache = t25.store.full_phase_cache()
    obs = ObsConfig(timeline=True)
    fixed_r = copy.copy(r_sq8)
    fixed_f = copy.copy(r_sq8)
    fixed_f.cfg = dataclasses.replace(r_sq8.cfg, fused=True)
    got = {}
    for twin, d in (("tiered", t25), ("resident fused=False", fixed_r),
                    ("resident fused=True", fixed_f)):
        for name in ("fixed", "paged"):
            # the timeline's spans split the run (phase 9's way)
            eng = (WaveEngine(d, wave_size=256, tick_hops=8, obs=obs)
                   if name == "fixed" else
                   PagedWaveEngine(d, capacity=256, tick_hops=8,
                                   page_cols=256, obs=obs))
            ticks = {"hit": [], "pinned": []}

            def on_step(e):
                if d.store.tiered:
                    ticks["hit"].append(e._g_tick_hit.value())
                    ticks["pinned"].append(e._last_pinned)

            c0 = dict(cache.counters)
            _, res, _, summ = serve(eng, [("default", queries, 0)], [],
                                    d.cfg.k, on_step)
            peak = max(peak, torch.cuda.max_memory_allocated())
            line = (f"  engines, {twin}, {name}: QPS {summ['qps']:.1f}, "
                    f"p99 {summ['p99_ms']:.3f} ms, queue-wait p99 "
                    f"{summ['queue_wait_p99_ms']:.3f} ms, ticks "
                    f"{summ['ticks']}, mean hops {summ['mean_hops']:.3f}")
            if d.store.tiered:
                dc = {k: cache.counters[k] - c0[k] for k in c0}
                summ.update(tick_hit_mean=float(np.mean(ticks["hit"])),
                            prefetch=(dc["prefetch_issued"],
                                      dc["prefetch_applied"]),
                            pinned_max=max(ticks["pinned"]),
                            hit_rate=dc["hits"] / max(1, dc["hits"]
                                                      + dc["misses"]))
                line += (f", tick hit rate mean {summ['tick_hit_mean']:.4f}"
                         f" (run {summ['hit_rate']:.4f}), prefetches "
                         f"issued {dc['prefetch_issued']} applied "
                         f"{dc['prefetch_applied']}, pinned blocks max "
                         f"{summ['pinned_max']}")
            sp = summ["split_ms"]
            line += (f"; ms summed over the run: ticks "
                     f"{sp.get('tick', 0):.1f} = tier housekeeping and "
                     f"prefetch requests {sp.get('tick.tier', 0):.1f} + "
                     f"launch {sp.get('tick.launch', 0):.1f} + retire "
                     f"{sp.get('tick.retire', 0):.1f} + refill "
                     f"{sp.get('tick.refill', 0):.1f} + housekeeping "
                     f"{sp.get('tick.housekeeping', 0):.1f}")
            log(line)
            got[twin, name] = (res, summ)
            del eng
    compare_serving(got["tiered", "fixed"][0], got["tiered", "paged"][0],
                    "engines, tiered: paged vs fixed")
    for name in ("fixed", "paged"):
        compare_serving(got["tiered", name][0],
                        got["resident fused=False", name][0],
                        f"engines, {name}: tiered vs resident fused=False")
        f_eq = all(np.array_equal(a["ids"], b["ids"])
                   and np.array_equal(a["dists"].view(np.int32),
                                      b["dists"].view(np.int32))
                   and a["hops"] == b["hops"]
                   for a, b in zip(got["tiered", name][0],
                                   got["resident fused=True", name][0]))
        log(f"  engines, {name}: tiered equal to the resident fused=True "
            f"engine per query: {f_eq}")
    out["engines"] = {f"{t} {n}": s for (t, n), (_, s) in got.items()}
    del got, fixed_r, fixed_f

    # --- chaos: retried to success, degraded past the retries, pool denials
    q0 = batches[0]
    q = q0[:chaos_q]
    c1 = dqf_from_arrays(saved["sq8"], tier_cfg(
        cfgs["sq8"], tmp, "chaos", 0.25, fetch_retries=1,
        fetch_backoff_s=0.0), device=dev)
    plan = install_chaos(c1, FaultPlan(seed=seed,
                                       tier_fail_first_fetch=True))
    t0 = time.perf_counter()
    got1 = c1.search(q, record=False)
    chaos_s = time.perf_counter() - t0
    compare_results(got1, r_sq8.search(q, record=False),
                    f"{chaos_q} queries with every block's first read "
                    "failing, and the fault-free resident search")
    cs = [c.counters for c in c1.store.tier_caches()]
    retries = sum(c["fetch_retries"] for c in cs)
    failures = sum(c["fetch_failures"] for c in cs)
    log(f"  tier_fail_first_fetch: {plan.injected['tier_io']} injected "
        f"faults, {retries} retries, {failures} failures, {chaos_s:.3f} s")
    if retries <= 0 or failures != 0:
        raise SystemExit("tier_fail_first_fetch: retries or failures off")
    uninstall_chaos(c1)
    plan = FaultPlan(seed=seed, tier_io_rate=1.0)
    eng = WaveEngine(c1, wave_size=256, tick_hops=8)
    install_chaos(eng, plan)
    t0 = time.perf_counter()
    rids = eng.submit(q)
    res = eng.run_until_drained(max_ticks=10_000)["results"]
    io_s = time.perf_counter() - t0
    if not set(rids) <= set(res):
        raise SystemExit("tier_io_rate=1.0: a query never terminated")
    degraded = [r for r in rids if res[r]["degraded"]]
    if (not degraded or eng.stats.degraded != len(degraded)
            or any(res[r]["status"] != "degraded" for r in degraded)):
        raise SystemExit(f"tier_io_rate=1.0: {len(degraded)} degraded "
                         f"results, stats.degraded {eng.stats.degraded}")
    log(f"  tier_io_rate=1.0, fetch_retries=1, fixed engine: {len(rids)} "
        f"queries terminated, {len(degraded)} degraded (stats "
        f"{eng.stats.degraded}), {plan.injected['tier_io']} injected "
        f"faults, {io_s:.3f} s")
    uninstall_chaos(eng)
    del eng
    _free(c1)
    del c1
    plan = FaultPlan(seed=seed, pool_deny_rate=0.3)
    eng = PagedWaveEngine(r_sq8, capacity=256, tick_hops=8, page_cols=256)
    install_chaos(eng, plan)
    rids = []
    for i in range(0, len(q0), 64):         # an admission a step
        rids += eng.submit(q0[i:i + 64])
        eng.step()
    res = eng.run_until_drained(max_ticks=10_000)["results"]
    if (not set(rids) <= set(res) or eng.stats.completed != len(rids)
            or plan.injected["pool_deny"] <= 0):
        raise SystemExit(f"pool_deny_rate=0.3: {eng.stats.completed} of "
                         f"{len(rids)} completed, "
                         f"{plan.injected['pool_deny']} denials")
    log(f"  pool_deny_rate=0.3, paged engine: {eng.stats.completed} of "
        f"{len(rids)} queries completed, {plan.injected['pool_deny']} "
        f"denials, statuses "
        f"{sorted({res[r]['status'] for r in rids})}")
    out["chaos"] = dict(retries=retries, io_degraded=len(degraded),
                        pool_denials=plan.injected["pool_deny"])
    del eng

    # --- mutation on the tier: a fresh tiered twin and its resident twin
    # (the engines above fed the other twins' counters unequally, and a
    # delete that hits a hot row rebuilds the hot index from the counter)
    _free(t25, r_sq8)
    del t25, r_sq8
    t25 = dqf_from_arrays(saved["sq8"], tier_cfg(cfgs["sq8"], tmp,
                                                 "sq8_mut", 0.25),
                          device=dev)
    r_sq8 = dqf_from_arrays(saved["sq8"], dataclasses.replace(
        cfgs["sq8"], fused=False), device=dev)
    cache = t25.store.full_phase_cache()
    rng = np.random.default_rng(seed + 3)
    q1 = batches[1]
    tm = out["mutation_s"] = {}

    def both_search(what):
        for b, q in ((0, q0), (1, q1)):
            compare_results(t25.search(q, record=False),
                            r_sq8.search(q, record=False),
                            f"{what}, batch {b}: tiered and resident")
        check_fresh_blocks(t25, what)

    both_search("before the insert")        # blocks resident to go stale
    cap0, blocks0 = t25.store.capacity, cache.bf.n_blocks
    src = rng.choice(ctx["x"].shape[0], n_insert)
    rows = ctx["x"][src] + 0.02 * rng.standard_normal(
        (n_insert, ctx["x"].shape[1])).astype(np.float32)
    ext = []
    for name, d in (("tiered", t25), ("resident", r_sq8)):
        t0 = time.perf_counter()
        ext.append(d.insert(rows))
        tm[f"insert_{name}"] = time.perf_counter() - t0
    if not np.array_equal(ext[0], ext[1]) or t25.store.capacity == cap0:
        raise SystemExit("tier insert: external ids differ, or the capacity "
                         "did not grow")
    log(f"  insert {n_insert}: tiered {tm['insert_tiered']:.3f} s, "
        f"resident {tm['insert_resident']:.3f} s; capacity {cap0} -> "
        f"{t25.store.capacity}, files "
        f"{t25.store.tier_disk_nbytes()} bytes, caches re-keyed "
        f"({blocks0} -> "
        f"{t25.store.full_phase_cache().bf.n_blocks} code blocks)")
    both_search("after the insert")
    live = t25.store.live_ids()
    dead = t25.store.to_external(rng.choice(live, n_delete, replace=False))
    for name, d in (("tiered", t25), ("resident", r_sq8)):
        t0 = time.perf_counter()
        d.delete(dead)
        tm[f"delete_{name}"] = time.perf_counter() - t0
    log(f"  delete {n_delete}: tiered {tm['delete_tiered']:.3f} s, "
        f"resident {tm['delete_resident']:.3f} s")
    both_search("after the delete")
    remaps = []
    for name, d in (("tiered", t25), ("resident", r_sq8)):
        t0 = time.perf_counter()
        remaps.append(d.compact()["remap"])
        tm[f"compact_{name}"] = time.perf_counter() - t0
    if not np.array_equal(remaps[0], remaps[1]):
        raise SystemExit("tier compact: the remaps differ")
    log(f"  compact: tiered {tm['compact_tiered']:.3f} s, resident "
        f"{tm['compact_resident']:.3f} s")
    both_search("after the compact")
    path = os.path.join(tmp, "tiered.npz")
    t0 = time.perf_counter()
    t25.save(path)
    tm["save"] = time.perf_counter() - t0
    from repro_torch.core import DQF
    t0 = time.perf_counter()
    back = DQF.load(path, dataclasses.replace(t25.cfg, tier=dataclasses.
                                              replace(t25.cfg.tier,
                                                      dir=None)))
    torch.cuda.synchronize()
    tm["load"] = time.perf_counter() - t0
    if back.store.tier_dir != path + ".tier":
        raise SystemExit(f"the reload's tier is in {back.store.tier_dir}")
    compare_results(back.search(q0, record=False),
                    t25.search(q0, record=False),
                    "the saved tiered twin and its reload (sidecar)")
    log(f"  save with the sidecar {tm['save']:.3f} s "
        f"({os.path.getsize(path)} bytes and "
        f"{back.store.tier_disk_nbytes()} in {path}.tier), load "
        f"{tm['load']:.3f} s")
    peak = max(peak, torch.cuda.max_memory_allocated())
    _free(back, t25)
    del back, t25

    del r_sq8
    torch.cuda.empty_cache()
    out["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    log(f"  peak device memory in phase 12: {out['peak_gib']:.3f} GiB")
    return out


# ----------------------------------------------------------------- phase 13
SHARD_COUNTS = (1, 2, 4)
DEAD_SHARD = 2          # check 4 at S = 4: shard 2 lost
ENGINE_SHARDS = (2, 4)  # phase 14 serves phase 13's indexes at these S
ENGINE_TRAFFIC = 2048   # phase 14's closed loop (4096 before: cut to the
                        # script's time limit)
SHARD_FIT = 1024        # of phase 4's 2048 fit queries (cut from all of
                        # them to keep the script inside its limit)


def _bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8))


def timed_batches(fn, batches, counters=()):
    """``fn(q)`` over ``batches``, CUDA events around each call (the host's
    work and the copy of the result to the host included); each counter
    set to 0 just before and read just after.  Returns (outputs, ms a
    batch, launches)."""
    for c in counters:
        c.launches = 0
    outs, times = [], []
    for q in batches:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        outs.append(fn(q))
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return outs, times, [c.launches for c in counters]


def shard_pass(sd, x, batches, gt, dev):
    """Each shard's own search of the batches (the oracle's pieces), and
    its search without the tree (``search_dual_beam``), to locate a recall
    loss: each one's recall@10 against the exact top-10 of the shard's own
    rows, the share of lanes the tree ended, the mean dist_count; the
    recall@10 of the shards' no-tree answers merged on the host; batch 0's
    answers as ext ids and dists."""
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.sharding import merge_topk_host

    qs = np.concatenate(batches)
    stats, first, dual_ext = [], [], []
    for sh in sd.shards:
        res = [sh.dqf.search(q, record=False) for q in batches]
        dual = [sh.dqf.search_dual_beam(q) for q in batches]
        own_gt = gt if sd.num_shards == 1 else ground_truth(
            x[sh.dqf.store.ext_ids], qs, 10, device=dev)
        ids = lambda rs: np.concatenate([r.ids.cpu().numpy() for r in rs])
        mean = lambda rs, f: float(torch.cat([getattr(r.stats, f)
                                              for r in rs]).float().mean())
        stats.append({"recall": recall_at_k(ids(res), own_gt),
                      "terminated": mean(res, "terminated_early"),
                      "dist_count": mean(res, "dist_count"),
                      "recall_no_tree": recall_at_k(ids(dual), own_gt),
                      "dist_count_no_tree": mean(dual, "dist_count")})
        first.append((sh.dqf.to_external(res[0].ids.cpu().numpy()),
                      res[0].dists.cpu().numpy()))
        dual_ext.append((sh.dqf.to_external(ids(dual)), np.concatenate(
            [r.dists.cpu().numpy() for r in dual])))
    merged, _ = merge_topk_host([d[0] for d in dual_ext],
                                [d[1] for d in dual_ext], sd.cfg.k)
    return stats, first, recall_at_k(merged, gt)


def sharded_merge_check(per_shard, k, dev):
    """``pool_merge`` at the merge's shapes: batch 0's per-shard answers
    (S, B, k) concatenated shard-major, the first k slots the pool, the
    rest the candidates; the kernel against its plain version on the same
    card tensors (bits) and ``merge_topk`` against the host oracle; the
    kernel, the plain version and the library expression timed a call
    alone (median of 20, 5 for the plain version).  Returns the timings."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.sharding import merge_topk, merge_topk_host

    S = len(per_shard)
    d = torch.as_tensor(np.stack([p[1] for p in per_shard]), device=dev)
    g = torch.as_tensor(np.stack([p[0] for p in per_shard]).astype(np.int32),
                        device=dev)
    ids, dists = merge_topk(d, g, k)
    h_ids, h_dists = merge_topk_host([p[0] for p in per_shard],
                                     [p[1] for p in per_shard], k)
    if not (_bits(ids.cpu().numpy().astype(np.int64), h_ids)
            and _bits(dists.cpu().numpy(), h_dists)):
        raise SystemExit(f"S={S}: merge_topk differs from the host oracle")
    B = d.shape[1]
    cat_d = d.permute(1, 0, 2).reshape(B, S * k)
    cat_g = g.permute(1, 0, 2).reshape(B, S * k)
    args = (cat_d[:, :k].contiguous(), cat_g[:, :k].contiguous(),
            cat_d[:, k:].contiguous(), cat_g[:, k:].contiguous())
    saved = pool_merge_cuda.launches
    got = pool_merge_cuda(*args)
    want = ref.pool_merge(*args)
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"S={S}: pool_merge differs from its plain version "
                         "at the merge's shapes")

    def library():
        srt = torch.sort(cat_d, dim=1, stable=True)
        return srt.values[:, :k], cat_g.gather(1, srt.indices[:, :k])

    ms = _median_ms(lambda: pool_merge_cuda(*args), 20)
    device_ms = _median_ms(lambda: pool_merge_cuda(*args), 20, busy=True)
    pool_merge_cuda.launches = saved
    plain_ms = _median_ms(lambda: ref.pool_merge(*args), 5)
    library_ms = _median_ms(library, 20)
    merge_ms = _median_ms(lambda: merge_topk(d, g, k), 20)
    pool_merge_cuda.launches = saved
    moved = B * S * k * 8 + B * k * 8
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    err = float((got[0] - want[0]).abs().nan_to_num().max())
    log(f"  S={S}: pool_merge at B={B} L={k} C={(S - 1) * k}: {ms:.4f} ms "
        f"a call alone, device {device_ms:.4f}, plain {plain_ms:.4f}, "
        f"library {library_ms:.4f} (torch.sort(stable=True), then a "
        f"slice), bound {bound_ms:.6f} ms ({moved} bytes); merge_topk "
        f"(layout + kernel) {merge_ms:.4f} ms; bits = plain = host oracle")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "merge_topk_ms": merge_ms,
            "max_abs_err": err, "shape": [B, k, (S - 1) * k]}


def sharded_hop_check(sd, q, dev):
    """One ``fused_hop`` launch of ``fused_hops`` hops at the stacked full
    phase's shapes (S·B lanes, the per-lane table base over ``(S, cap+1,
    ·)`` tables and liveness), from batch ``q``'s stacked seed, against
    its plain version: every HopState field and ``seen`` bit for bit;
    timed a call alone and the device alone beside the plain version and
    the bound."""
    from repro_torch.core import beam_search as bs
    from repro_torch.core.dynamic_search import (_seed_full_state,
                                                 hot_phase_stacked)
    from repro_torch.core.features import hot_features
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    c = sd.cfg
    S, B = sd.num_shards, q.shape[0]
    stk = sd._sync_stacked()
    xh, adjh, idsh, enth, _ = sd._hot_stacked("default")
    lane = torch.arange(S, device=dev).repeat_interleave(B)
    qq = torch.as_tensor(q, device=dev).repeat(S, 1)
    saved = fused_hop_cuda.launches
    hot_pool, _ = hot_phase_stacked(xh, adjh, enth, None, lane, qq,
                                    pool_size=c.hot_pool,
                                    max_hops=c.max_hops, fused=True)
    hot = hot_features(hot_pool, c.k)
    x_pad, adj_pad, live = stk["x_pad"], stk["adj_pad"], stk["live_pad"]
    n1 = x_pad.shape[1]
    hs0 = bs.to_hop_state(_seed_full_state(
        hot_pool, idsh[lane], n1 - 1, c.full_pool, bs.LaneTable(live, lane)))
    args = (adj_pad, qq, live, "f32", x_pad, None, None, sd.tree.arrays,
            hot.first.contiguous(), hot.first_div_kth.contiguous())
    kw = dict(hops=c.fused_hops, max_hops=c.max_hops, k=c.k,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth,
              lane_base=(lane * n1).to(torch.int32))
    ms, device_ms, plain_ms, got = _kernel_vs_plain(
        lambda: fused_hop_cuda(hs0, *args, **kw),
        lambda: ref.fused_hop(hs0, *args, **kw), hs0.seen,
        f"S={S}: the stacked fused_hop launch")
    fused_hop_cuda.launches = saved
    L, R, d = hs0.ids.shape[1], adj_pad.shape[2], qq.shape[1]
    rows = int((got.dist_count - hs0.dist_count).sum())
    hops = int((got.hops - hs0.hops).sum())
    bound_ms, by, moved = hop_bound("f32", S * B, L, R, d, d * 4,
                                    S * B * d * 4, rows, hops)
    log(f"  S={S}: stacked fused_hop at B={S * B} L={L} R={R} d={d} "
        f"hops={c.fused_hops}, lane base over ({S}, {n1}, ·): {ms:.4f} ms "
        f"a launch (device alone {device_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {by} ({moved} bytes, {rows} rows "
        f"scored); bits = plain")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": 0.0}


def phase_sharding(ctx, dev, f32_arrays):
    """Phase 13: ``ShardedDQF`` at S = 1 (phase 4's index carried, no
    build), 2 and 4 (built) on phase 4's rows, config, warm targets,
    fit queries and 4 batches.  Checks 1-5 and the recall guard, as the
    module's docstring lists them; returns what the kernel line needs and
    the S = 2 and 4 indexes, which phase 14 serves."""
    from repro_torch.core.recall import recall_at_k
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.serving.sharded import merge_with_dropout
    from repro_torch.sharding import ShardedDQF

    cfg, x, batches, gt = ctx["cfg"], ctx["x"], ctx["batches"], ctx["gt"]
    counters = (fused_hop_cuda, pool_merge_cuda)
    runs, one_recall, kept = {}, None, {}
    for S in SHARD_COUNTS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if S == 1:
            sd = ShardedDQF.from_arrays([f32_arrays], cfg, 1, device=dev)
            torch.cuda.synchronize()
            secs = {"carry": time.perf_counter() - t0}
        else:
            sd = ShardedDQF(cfg, S, device=dev).build(x)
            torch.cuda.synchronize()
            secs = {"build": time.perf_counter() - t0}
            t0 = time.perf_counter()
            sd.warm(ctx["warm_q"], ctx["warm_targets"])
            torch.cuda.synchronize()
            secs["warm"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            sd.fit_tree(ctx["fit_q"][:SHARD_FIT])
            torch.cuda.synchronize()
            secs["fit_tree"] = time.perf_counter() - t0
        t0 = time.perf_counter()     # the stacked tables, built once
        sd._sync_stacked()
        sd._hot_stacked("default")
        torch.cuda.synchronize()
        secs["stack"] = time.perf_counter() - t0
        sizes = [sh.dqf.store.n for sh in sd.shards]
        hot = [sh.dqf.hot.size for sh in sd.shards]
        log(f"  S={S}: {', '.join(f'{k} {v:.3f} s' for k, v in secs.items())}"
            f"; rows a shard {sizes}, hot rows a shard {hot}, tree "
            f"{sd.tree.arrays.value.numel()} nodes")
        search = lambda q: sd.search(q, record=False)
        stacked, ms, (hops, merges) = timed_batches(search, batches,
                                                    counters)
        oracle, oracle_ms, (o_hops, o_merges) = timed_batches(
            sd.search_oracle, batches, counters)
        fused_hop_cuda.launches = pool_merge_cuda.launches = 0
        peak = torch.cuda.max_memory_allocated()
        log(f"  S={S}: stacked search ms a batch "
            f"{', '.join(f'{t:.3f}' for t in ms)} ({hops} fused_hop and "
            f"{merges} pool_merge launches in the 4); oracle "
            f"{', '.join(f'{t:.3f}' for t in oracle_ms)} ({o_hops} fused_hop"
            f", {o_merges} pool_merge); peak device memory "
            f"{peak / 2**30:.3f} GiB")
        # check 1 (S = 1) and check 2: bit for bit
        for i, (a, b) in enumerate(zip(stacked, oracle)):
            if not (_bits(a.ids, b.ids) and _bits(a.dists, b.dists)):
                raise SystemExit(f"check 2: S={S} search differs from "
                                 f"search_oracle in batch {i}")
            if S == 1:
                ids, dists = ctx["answers"][i]
                if not (_bits(a.ids, ids) and _bits(a.dists, dists)):
                    raise SystemExit(f"check 1: one shard differs from "
                                     f"phase 4's DQF.search in batch {i}")
        log(f"  S={S}: search = search_oracle bit for bit in all 4 batches"
            + (", and = phase 4's DQF.search (ext ids, dists)"
               if S == 1 else ""))
        # check 3: 2 fused_hop and 1 pool_merge launches a stacked batch
        if (hops, merges) != (2 * len(batches), len(batches)):
            raise SystemExit(f"check 3: S={S} stacked batches made {hops} "
                             f"fused_hop and {merges} pool_merge launches, "
                             f"not 2 and 1 a batch")
        ids = np.concatenate([r.ids for r in stacked])
        if ids.shape != (len(gt), cfg.k) or not np.isfinite(
                np.concatenate([r.dists for r in stacked])).all() \
                or ids.min() < 0 or ids.max() >= x.shape[0]:
            raise SystemExit(f"S={S}: merged output malformed")
        recall = recall_at_k(ids, gt)
        if S == 1:
            one_recall = recall
        shards, first, no_tree = shard_pass(sd, x, batches, gt, dev)
        log(f"  S={S}: recall@10 merged {recall:.4f} (one shard "
            f"{one_recall:.4f}; merged without the tree {no_tree:.4f}); "
            f"per shard against its own exact top-10: "
            + "; ".join(f"{s}: recall {p['recall']:.4f} (no tree "
                        f"{p['recall_no_tree']:.4f}), tree-ended "
                        f"{p['terminated']:.4f}, dist_count "
                        f"{p['dist_count']:.1f} (no tree "
                        f"{p['dist_count_no_tree']:.1f})"
                        for s, p in enumerate(shards)))
        if recall < 0.5 * one_recall:
            raise SystemExit(f"recall guard: S={S} merged recall@10 "
                             f"{recall:.4f} < half of one shard's "
                             f"{one_recall:.4f}")
        # check 5: memory splits and shard labels
        mr = sd.memory_report()
        per = [e["device"]["total"] for e in mr["per_shard"]]
        sc = sd.scrape()
        if sum(per) != mr["device"]["total"] or not all(
                any(k.endswith(f"shard={s}}}") for k in sc)
                for s in range(S)):
            raise SystemExit(f"check 5: S={S} memory_report or scrape labels")
        log(f"  S={S}: device bytes a shard {per} (fleet "
            f"{mr['device']['total']}); scrape labels shard=0..{S - 1}")
        run = {"secs": secs, "stacked_ms": ms, "oracle_ms": oracle_ms,
               "launches": {"fused_hop": hops, "pool_merge": merges},
               "oracle_launches": {"fused_hop": o_hops,
                                   "pool_merge": o_merges},
               "recall": recall, "recall_no_tree": no_tree,
               "shards": shards, "peak_bytes": peak,
               "device_bytes": per}
        if S > 1:
            run["merge"] = sharded_merge_check(first, cfg.k, dev)
            run["hop"] = sharded_hop_check(sd, batches[0], dev)
        if S == 4:      # check 4: a lost shard
            alive = [s != DEAD_SHARD for s in range(S)]
            got = sd.search_degraded(batches[0], alive)
            want = merge_with_dropout([p[0] for p in first],
                                      [p[1] for p in first], alive, cfg.k)
            owners = {sd._owner[int(e)] for e in got[0].ravel() if e >= 0}
            if not (got[2] == 0.75 and DEAD_SHARD not in owners
                    and _bits(got[0], want[0]) and _bits(got[1], want[1])):
                raise SystemExit("check 4: search_degraded with shard 2 "
                                 "lost")
            log(f"  S=4, shard {DEAD_SHARD} lost: coverage {got[2]}, ids "
                f"only from shards {sorted(owners)}, = merge_with_dropout "
                f"of the shards' own searches; recall@10 of batch 0 "
                f"{recall_at_k(got[0], gt[:len(batches[0])]):.4f}")
        runs[S] = run
        fused_hop_cuda.launches = pool_merge_cuda.launches = 0
        if S in ENGINE_SHARDS:
            kept[S] = sd
        del sd, stacked, oracle
    return runs, kept


# ------------------------------------------------------------------ phase 14
def _audit_ticks(eng, counters):
    """Wrap the engine's tick function (its refills run outside it) to
    record each tick's launches of ``counters``; returns the list it
    appends one tuple a tick to."""
    per_tick = []
    inner = eng._tick_fn

    def tick(*args):
        before = [c.launches for c in counters]
        out = inner(*args)
        per_tick.append(tuple(c.launches - b
                              for c, b in zip(counters, before)))
        return out

    eng._tick_fn = tick
    return per_tick


def _trigger_out_of_reach(sd):
    """Every tenant's Alg-2 trigger out of reach, so no hot index changes
    while the engines serve (as phase 9 sets ``n_query_trigger``)."""
    for sh in sd.shards:
        for t in sh.dqf.tenants:
            t.counter.trigger = 10 ** 9


def _kernel_vs_plain(kernel, plain, state, what):
    """A hop launch ``kernel()`` and its plain version ``plain()`` from the
    same ``state`` (the dense seen rows or the page pool, which both
    update in place): every HopState field and ``state`` bit for bit; the
    kernel timed a call alone and the device alone (means of 20), the
    plain version over 3 calls.  Returns (ms, device_ms, plain_ms, the
    kernel's output)."""
    from repro_torch.kernels.ref import HopState

    start = state.clone()
    reset = lambda: state.copy_(start)
    reset()
    kernel()
    ms, _ = _event_ms(kernel, 20, reset)
    device_ms, _ = _event_ms(kernel, 20, reset, busy=True)
    reset()
    got = kernel()
    after = state.clone()
    plain_ms, want = _event_ms(plain, 3, reset)
    bad = [f for f in HopState._fields if f != "seen"
           and not bits_equal(getattr(want, f), getattr(got, f))]
    if not torch.equal(state, after):
        bad.append("seen")
    reset()
    del start, after
    if bad:
        raise SystemExit(f"{what} differs from its plain version in {bad}")
    return ms, device_ms, plain_ms, got


def engine_kernel_checks(sd, eng, peng, q, dev):
    """Check 7: the fixed tick's ``fused_hop`` (S·W lanes seeded by the
    engine's own refill, the per-lane table base, the tree, add_step 0),
    the paged tick's ``fused_hop_paged`` (S·bucket lanes gathered from
    the stacked slot arrays, the shard-offset page table over the stacked
    pool) and the tick's ``pool_merge`` (L = k, C = S·full_pool − k, the
    fixed hop's pools with 5% of their slots masked to ``INF_DIST`` as
    deletes and dropped shards mask them) against their plain versions,
    bit for bit, timed beside them and their bounds.  The launches made
    here are not counted."""
    from repro_torch.core import beam_search as bs
    from repro_torch.core.types import INF_DIST
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.serving import paged as pg

    saved = (fused_hop_cuda.launches, fused_hop_paged_cuda.launches,
             pool_merge_cuda.launches)
    c, S, W = sd.cfg, sd.num_shards, min(eng.wave, q.shape[0])
    stk = eng._stk
    n1, R, d = stk["x_pad"].shape[1], stk["adj_pad"].shape[2], q.shape[1]
    slots = np.asarray([[sh.dqf.tenants.slot_of("default")] * W
                        for sh in sd.shards])
    seeded, hf, qq = eng._seed(q[:W], slots)
    lane = eng._lane_shard(W)
    hs0 = bs.to_hop_state(seeded, evals_done=torch.zeros(
        S * W, dtype=torch.int32, device=dev))
    kw = dict(hops=eng.tick_hops, max_hops=c.max_hops, k=c.k,
              eval_gap=c.eval_gap, add_step=0, tree_depth=c.tree_depth,
              lane_base=(lane * n1).to(torch.int32))
    args = (stk["adj_pad"], qq, stk["live_pad"], "f32", stk["x_pad"], None,
            None, eng._tree, hf.first.contiguous(),
            hf.first_div_kth.contiguous())
    out = {}
    ms, device_ms, plain_ms, got = _kernel_vs_plain(
        lambda: fused_hop_cuda(hs0, *args, **kw),
        lambda: ref.fused_hop(hs0, *args, **kw), hs0.seen,
        f"check 7: S={S}: the fixed tick's fused_hop")
    L = hs0.ids.shape[1]
    rows = int((got.dist_count - hs0.dist_count).sum())
    hops = int((got.hops - hs0.hops).sum())
    bound_ms, by, moved = hop_bound("f32", S * W, L, R, d, d * 4,
                                    S * W * d * 4, rows, hops)
    out["hop"] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": by,
                  "max_abs_err": 0.0, "shape": [S * W, L, R, d]}
    log(f"  S={S} check 7: fixed tick fused_hop at B={S * W} L={L} R={R} "
        f"d={d} hops={eng.tick_hops} over ({S}, {n1}, ·): {ms:.4f} ms a "
        f"launch (device alone {device_ms:.4f}), plain {plain_ms:.4f}, "
        f"bound {bound_ms:.5f} ms by {by} ({moved} bytes, {rows} rows "
        f"scored); bits = plain")

    # the tick's merge at its shapes, pools made unsorted by masked slots
    g = bs.LaneTable(stk["gid_pad"], lane).rows(got.ids)
    dists = torch.where(g < 0, INF_DIST, got.dists)
    rng = np.random.default_rng(S)
    mask = torch.as_tensor(rng.random(tuple(g.shape)) < 0.05, device=dev)
    dists = torch.where(mask, INF_DIST, dists)
    g = torch.where(mask, -1, g)
    cat_d = dists.reshape(S, W, L).permute(1, 0, 2).reshape(W, S * L)
    cat_g = g.reshape(S, W, L).permute(1, 0, 2).reshape(W, S * L)
    k = c.k
    margs = (cat_d[:, :k].contiguous(), cat_g[:, :k].contiguous(),
             cat_d[:, k:].contiguous(), cat_g[:, k:].contiguous())
    unsorted = int((margs[0][:, 1:] < margs[0][:, :-1]).any(1).sum())
    mgot = pool_merge_cuda(*margs)
    mwant = ref.pool_merge(*margs)
    if not all(bits_equal(a, b) for a, b in zip(mgot, mwant)) \
            or unsorted == 0:
        raise SystemExit(f"check 7: S={S} pool_merge at the tick's shapes "
                         f"(unsorted pools: {unsorted})")

    def library():
        srt = torch.sort(cat_d, dim=1, stable=True)
        return srt.values[:, :k], cat_g.gather(1, srt.indices[:, :k])

    mms = _median_ms(lambda: pool_merge_cuda(*margs), 20)
    mdev = _median_ms(lambda: pool_merge_cuda(*margs), 20, busy=True)
    mplain = _median_ms(lambda: ref.pool_merge(*margs), 5)
    mlib = _median_ms(library, 20)
    mmoved = W * S * L * 8 + W * k * 8
    mbound = mmoved / HBM_BYTES_PER_S * 1e3
    out["merge"] = {"ms": mms, "device_ms": mdev, "plain_ms": mplain,
                    "library_ms": mlib, "bound_ms": mbound,
                    "bound_by": "bytes", "max_abs_err": 0.0,
                    "shape": [W, k, S * L - k], "unsorted_pools": unsorted}
    log(f"  S={S} check 7: pool_merge at B={W} L={k} C={S * L - k} "
        f"({unsorted} of {W} pools unsorted by masked slots): {mms:.4f} ms "
        f"a call alone, device {mdev:.4f}, plain {mplain:.4f}, library "
        f"{mlib:.4f} (torch.sort(stable=True), then a slice), bound "
        f"{mbound:.6f} ms ({mmoved} bytes); bits = plain")
    del hs0, got, seeded

    # the paged tick's hop over the stacked pool
    peng.submit(q[:W])
    peng._init_wave()
    pool = peng.pagepool
    lanes_np, pt_np, _ = pool.live_bucket(peng.min_bucket)
    Bk = len(lanes_np)
    rows_p = torch.as_tensor((np.arange(S)[:, None] * (W + 1)
                              + lanes_np[None]).reshape(-1), device=dev)
    pt = torch.as_tensor((pt_np[None] + np.arange(S)[:, None, None]
                          * pool.n_pages).reshape(S * Bk, -1).astype(
                              np.int32), device=dev)
    wv = pg.gather_wave(peng._state, rows_p)
    hp = bs.to_hop_state(wv.beam, evals_done=wv.evals)
    lane_p = peng._lane_shard(Bk)
    pkw = dict(kw, lane_base=(lane_p * n1).to(torch.int32),
               page_cols=peng.page_cols)
    pargs = (stk["adj_pad"], wv.queries, stk["live_pad"], "f32",
             stk["x_pad"], None, None, peng._tree, wv.hot_first,
             wv.hot_ratio)
    ms, device_ms, plain_ms, got = _kernel_vs_plain(
        lambda: fused_hop_paged_cuda(hp, pt, *pargs, **pkw),
        lambda: ref.fused_hop_paged(hp, pt, *pargs, **pkw), hp.seen,
        f"check 7: S={S}: the paged tick's fused_hop_paged")
    rows = int((got.dist_count - hp.dist_count).sum())
    hops = int((got.hops - hp.hops).sum())
    bound_ms, by, moved = hop_bound("f32", S * Bk, L, R, d, d * 4,
                                    S * Bk * (d * 4 + pt.shape[1] * 4),
                                    rows, hops)
    out["paged_hop"] = {"ms": ms, "device_ms": device_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, "max_abs_err": 0.0,
                        "shape": [S * Bk, L, R, d, peng.page_cols]}
    log(f"  S={S} check 7: paged tick fused_hop_paged at B={S * Bk} "
        f"(bucket {Bk} on {S} shards) page_cols={peng.page_cols}, pool "
        f"({S * pool.n_pages}, {peng.page_cols}), page table rows offset "
        f"by s*{pool.n_pages}: {ms:.4f} ms a launch (device alone "
        f"{device_ms:.4f}), plain {plain_ms:.4f}, bound {bound_ms:.5f} ms "
        f"by {by} ({moved} bytes, {rows} rows scored); bits = plain, pool "
        f"included")
    (fused_hop_cuda.launches, fused_hop_paged_cuda.launches,
     pool_merge_cuda.launches) = saved
    return out


def _owned_where_stored(sd, what):
    """Every live row's ext id is owned by the shard that stores it, and
    the owner map holds nothing else."""
    live = 0
    for s, sh in enumerate(sd.shards):
        st = sh.dqf.store
        ext = st.ext_ids[:st.n][st.alive[:st.n]]
        live += ext.size
        if any(sd._owner.get(int(e)) != s for e in ext):
            raise SystemExit(f"check 6: {what}: a live row of shard {s} is "
                             f"owned elsewhere")
    if live != len(sd._owner):
        raise SystemExit(f"check 6: {what}: {len(sd._owner)} owned ids, "
                         f"{live} live rows")


def sharded_churn(ctx, dev, sd, make, counters, seed, n_insert=512,
                  n_delete=5000):
    """Check 6: the fixed engine on phase 13's index and the paged one on
    a clone (``ShardedDQF.from_arrays`` of its shards' ``to_arrays``),
    both with auto-compaction at a 0.4% tombstone ratio, serve phase 4's
    4 batches as 4 rounds; between the drains the same writes go to both:
    after round 1 insert 512 rows, after round 2 delete 5,000 global ids
    and pin traffic to 64 of shard 0's rows (3x the largest shard mass,
    the skew of ``tests/test_sharded.py:158-181``), so the compaction the
    engines run in round 3 rebalances.  Per round paged ≡ fixed; no
    deleted id returned; every live id owned where it is stored."""
    from repro_torch.sharding import ShardedDQF

    S, k = sd.num_shards, sd.cfg.k
    t0 = time.perf_counter()
    twin = ShardedDQF.from_arrays([sh.dqf.to_arrays() for sh in sd.shards],
                                  sd.cfg, S, owner=dict(sd._owner),
                                  device=dev)
    _trigger_out_of_reach(twin)
    torch.cuda.synchronize()
    out = {"clone_s": time.perf_counter() - t0,
           "compact": {"index": [], "clone": []}}
    for d, name in ((sd, "index"), (twin, "clone")):
        inner = d.compact

        def timed(inner=inner, log_=out["compact"][name]):
            t = time.perf_counter()
            rep = inner()
            torch.cuda.synchronize()
            log_.append((time.perf_counter() - t, rep["rebalanced_rows"]))
            return rep

        d.compact = timed
    fixed = make(sd, False, compact_ratio=0.004)
    paged = make(twin, True, compact_ratio=0.004)
    rng = np.random.default_rng(seed + 14)
    dead = set()
    qps = []

    def write(label, fn):
        """``fn`` on both twins (timed, the same result required), then
        the index's stacked tables re-uploaded (timed)."""
        secs, res = [], []
        for d in (sd, twin):
            t = time.perf_counter()
            res.append(fn(d))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        if not np.array_equal(res[0], res[1]):
            raise SystemExit(f"check 6: {label} differs between the twins")
        t = time.perf_counter()
        sd._sync_stacked()
        torch.cuda.synchronize()
        sync = time.perf_counter() - t
        out[label] = {"s": secs, "sync_stacked_s": sync}
        return res[0], secs, sync

    for rnd, q in enumerate(ctx["batches"]):
        if rnd == 1:
            src = rng.choice(ctx["x"].shape[0], n_insert)
            rows = ctx["x"][src] + 0.02 * rng.standard_normal(
                (n_insert, ctx["x"].shape[1])).astype(np.float32)
            _, secs, sync = write("insert", lambda d: d.insert(rows))
            log(f"  S={S} check 6: insert {n_insert} rows {secs[0]:.3f} s "
                f"({secs[0] / n_insert * 1e3:.3f} ms a row; clone "
                f"{secs[1]:.3f} s), then _sync_stacked {sync:.3f} s")
        if rnd == 2:
            ids = rng.choice(np.fromiter(sd._owner, np.int64,
                                         len(sd._owner)), n_delete,
                             replace=False)
            n, secs, sync = write("delete", lambda d: d.delete(ids))
            dead |= set(ids.tolist())
            # a shard's mass is the counts in each tenant's hot-sized head:
            # pin the traffic on at most that many rows
            d0 = sd.shards[0].dqf
            st = d0.store
            heads = min(t.hot.size for t in d0.tenants if t.hot is not None)
            donors = st.ext_ids[:st.n][st.alive[:st.n]][:min(64, heads)]
            donors = donors.astype(np.int64)
            masses = [sd._shard_mass(sh) for sh in sd.shards]
            reps = int(np.ceil(3 * max(masses) / donors.size))
            for d in (sd, twin):
                d.record(np.tile(donors, (reps, 1)))
            log(f"  S={S} check 6: delete {n} global ids {secs[0]:.3f} s "
                f"({secs[0] / n * 1e3:.3f} ms a row; clone {secs[1]:.3f} s)"
                f", then _sync_stacked {sync:.3f} s; shard masses "
                f"{[round(m) for m in masses]}, {reps} queries pinned to "
                f"{donors.size} rows of shard 0")
        got = []
        for name, eng in (("fixed", fixed), ("paged", paged)):
            ticks = eng.stats.ticks
            _, res, _, summ = serve(eng, [("default", q, 0)], counters, k,
                                    occupancy="sharded_engine_occupancy_"
                                              "ratio")
            ids = np.stack([r["ids"] for r in res])
            if dead & set(ids.ravel().tolist()):
                raise SystemExit(f"check 6: round {rnd} {name} returned a "
                                 f"deleted id")
            got.append((res, eng.stats.ticks - ticks))
            qps.append((rnd, name, summ["qps"]))
        compare_serving(got[0][0], got[1][0],
                        f"S={S} check 6 round {rnd}: paged vs fixed",
                        (got[0][1], got[1][1]))
    done = out["compact"]
    if not (fixed.stats.compactions == paged.stats.compactions
            == len(done["index"]) == len(done["clone"]) >= 1):
        raise SystemExit(f"check 6: compactions {fixed.stats.compactions}, "
                         f"{paged.stats.compactions}")
    for d, what in ((sd, "index"), (twin, "clone")):
        _owned_where_stored(d, what)
    if sd._owner != twin._owner:
        raise SystemExit("check 6: the twins' owner maps differ")
    moved = [r for _, r in done["index"]]
    if moved != [r for _, r in done["clone"]] or moved[0] <= 0 or \
            sum(moved) != sd.scrape()["shard_rebalanced_rows_total"]:
        raise SystemExit(f"check 6: rows rebalanced {done}")
    log(f"  S={S} check 6: {len(moved)} auto-compaction(s) from round 2, "
        + ", ".join(f"{a:.3f} s (clone {b:.3f} s)" for (a, _), (b, _)
                    in zip(done["index"], done["clone"]))
        + f", the rebalance moving {moved} rows; every live id owned by "
        f"the shard storing it; QPS a round "
        + ", ".join(f"{r}/{n} {v:.1f}" for r, n, v in qps))
    out.update(qps=qps, rebalanced=moved)
    del twin, fixed, paged
    return out


def phase_sharded_engine(ctx, dev, kept, runs, seed):
    """Phase 14: ``ShardedEngine`` on phase 13's S = 2 and 4 indexes
    (phase 4's config, tree and queries), phase 9's traffic and engine
    shapes; checks 1-7 as the module's docstring lists them.  Returns,
    a shard count, what the kernel line needs."""
    from repro_torch.chaos import FaultPlan, install_chaos
    from repro_torch.core import ZipfWorkload
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.obs import ObsConfig
    from repro_torch.sharding import ShardedEngine

    counters = [fused_hop_cuda, fused_hop_paged_cuda, pool_merge_cuda]
    names = ("fused_hop", "fused_hop_paged", "pool_merge")
    obs = ObsConfig(timeline=True)
    k = ctx["cfg"].k
    n_q = ENGINE_TRAFFIC
    queries = np.concatenate(ctx["batches"])[:n_q]
    gt = ctx["gt"][:n_q]
    qb = ZipfWorkload(ctx["x"], seed=seed + 1)
    b_warm, b_q = qb.sample(4096), qb.sample(n_q // 2)
    b_gt = ground_truth(ctx["x"], b_q, 10, device=dev)
    closed = [("default", queries, 0)]
    bursts = [("default", queries[i:i + 512], 4)
              for i in range(0, n_q, 512)]
    mixed = []
    for i in range(0, n_q // 2, 64):
        mixed += [("default", queries[i:i + 64], 0),
                  ("b", b_q[i:i + 64], 0)]
    mixed_gt = np.concatenate([np.concatenate([gt[i:i + 64],
                                               b_gt[i:i + 64]])
                               for i in range(0, n_q // 2, 64)])

    def make(sd, paged, **kw):
        return ShardedEngine(sd, wave_size=256, tick_hops=8, paged=paged,
                             page_cols=256, obs=obs, **kw)

    def run(eng, plan, want_gt, what):
        audit = _audit_ticks(eng, counters)
        _, res, launches, summ = serve(
            eng, plan, counters, k,
            occupancy="sharded_engine_occupancy_ratio")
        summ["recall"] = recall_at_k(np.stack([r["ids"] for r in res]),
                                     want_gt)
        summ["launches"] = dict(zip(names, launches))
        want = ((0, 0, 1) if not eng.cfg.fused
                else (0, 1, 1) if eng.paged else (1, 0, 1))
        bad = [t for t in audit if t != want]
        if bad or not audit:
            raise SystemExit(f"check 3: {what}: ticks launched (fused_hop, "
                             f"fused_hop_paged, pool_merge) {bad[:3]}, not "
                             f"{want} each")
        sp = summ["split_ms"]
        log(f"  {what}: QPS {summ['qps']:.1f}, p99 {summ['p99_ms']:.3f} ms,"
            f" queue-wait p99 {summ['queue_wait_p99_ms']:.3f} ms, ticks "
            f"{summ['ticks']}, mean hops {summ['mean_hops']:.3f}, "
            f"recall@10 {summ['recall']:.4f}, launches "
            + ", ".join(f"{n} {v}" for n, v in summ["launches"].items())
            + f" ({want} a tick), peak {summ['peak_gib']:.3f} GiB, mean "
            f"occupancy {summ['occupancy']:.4f}")
        log(f"    split, ms summed over the run's "
            f"{summ['wall_s'] * 1e3:.1f}: ticks {sp.get('tick', 0):.1f} = "
            f"hop {sp.get('tick.hop', 0):.1f} + merge "
            f"{sp.get('tick.merge', 0):.1f} + retire "
            f"{sp.get('tick.retire', 0):.1f} (pool free "
            f"{sp.get('retire.free', 0):.1f}) + refill "
            f"{sp.get('tick.refill', 0):.1f} + the rest; hot phase and "
            f"seed {sp.get('refill.hot_phase', 0):.1f}, the first refill's "
            f"included")
        if eng.paged and (eng.pagepool.live_count
                          or eng.scrape()["page_pool_pages_in_use"
                                          "{pool=sharded}"]):
            raise SystemExit(f"check 2: {what}: the page pool is not empty")
        return res, summ

    out = {}
    for S in ENGINE_SHARDS:
        sd = kept.pop(S)
        t0 = time.perf_counter()
        sd.warm(b_warm, tenant="b")
        _trigger_out_of_reach(sd)
        torch.cuda.synchronize()
        log(f"  S={S}: tenant b warmed in {time.perf_counter() - t0:.3f} s "
            f"(hot rows a shard "
            f"{[sh.dqf.tenants.get('b').hot.size for sh in sd.shards]})")
        o = {}
        # checks 1-4 on the closed loop
        since0 = [sh.dqf.tenants.default.counter.since_rebuild
                  for sh in sd.shards]
        fixed, fs = run(make(sd, False), closed, gt,
                        f"S={S} closed loop, {n_q} at once, fixed fused")
        since = [sh.dqf.tenants.default.counter.since_rebuild - b
                 for sh, b in zip(sd.shards, since0)]
        if since != [len(queries)] * S:
            raise SystemExit(f"check 4: S={S} Alg-2 clocks advanced {since}")
        floor = runs[S]["recall"] - 0.08
        if fs["recall"] < floor:
            raise SystemExit(f"check 4: S={S} engine recall@10 "
                             f"{fs['recall']:.4f} < stacked search's "
                             f"{runs[S]['recall']:.4f} - 0.08")
        log(f"  S={S} check 4: recall@10 {fs['recall']:.4f} >= stacked "
            f"search's {runs[S]['recall']:.4f} - 0.08; every shard's Alg-2 "
            f"clock advanced by {len(queries)}")
        composed = copy.copy(sd)
        composed.cfg = dataclasses.replace(sd.cfg, fused=False)
        comp, cs = run(make(composed, False), closed, gt,
                       f"S={S} closed loop, fixed composed")
        del composed
        compare_serving(fixed, comp, f"S={S} check 1: fused vs composed",
                        (fs["ticks"], cs["ticks"]))
        paged, ps = run(make(sd, True), closed, gt,
                        f"S={S} closed loop, paged fused")
        compare_serving(fixed, paged, f"S={S} check 2: paged vs fixed",
                        (fs["ticks"], ps["ticks"]))
        for title, plan, want_gt in (
                (f"open loop, {len(bursts)} bursts of 512, 4 steps apart",
                 bursts, gt),
                (f"two tenants, {n_q // 2} each, interleaved by 64", mixed,
                 mixed_gt)):
            a, sa = run(make(sd, False), plan, want_gt,
                        f"S={S} {title}, fixed fused")
            b, sb = run(make(sd, True), plan, want_gt,
                        f"S={S} {title}, paged fused")
            compare_serving(a, b, f"S={S} check 2, {title}: paged vs fixed",
                            (sa["ticks"], sb["ticks"]))
            if plan is bursts:
                compare_serving(fixed, a, f"S={S} open loop vs closed "
                                "loop, fixed")
        # check 5: chaos
        eng = make(sd, False)
        install_chaos(eng, FaultPlan(seed=0))
        _, zero, _, zs = serve(eng, closed, [], k, occupancy="sharded_"
                               "engine_occupancy_ratio")
        compare_serving(fixed, zero, f"S={S} check 5: a zero-rate plan vs "
                        "no plan", (fs["ticks"], zs["ticks"]))
        eng = make(sd, False)
        install_chaos(eng, FaultPlan(seed=2, shard_fail_ticks={
            1: frozenset(range(10 ** 6))}))
        rids = eng.submit(ctx["batches"][0])
        res = [eng.run_until_drained()["results"][r] for r in rids]
        st = sd.shards[1].dqf.store
        lost = set(st.ext_ids[:st.n].tolist())
        ids = np.stack([r["ids"] for r in res])
        if not (all(r["shards_responding"] == S - 1 and r["degraded"]
                    and r["status"] == "degraded" for r in res)
                and not lost & set(ids.ravel().tolist())
                and eng.health.quarantines == 1):
            raise SystemExit(f"check 5: S={S} shard 1 failing")
        log(f"  S={S} check 5: shard 1 failing every tick: {len(res)} "
            f"results over {S - 1} shards, degraded, none of shard 1's "
            f"rows, 1 quarantine; recall@10 "
            f"{recall_at_k(np.where(ids < 0, 0, ids), gt[:len(res)]):.4f}; "
            f"a zero-rate plan gives the bits of no plan")
        del eng
        # check 7: the kernels at this path's shapes
        o["kernels"] = engine_kernel_checks(sd, make(sd, False),
                                            make(sd, True),
                                            ctx["batches"][1], dev)
        # check 6: churn
        o["churn"] = sharded_churn(ctx, dev, sd, make, counters, seed)
        o["launches"] = {"fixed": fs["launches"], "paged": ps["launches"],
                         "composed": cs["launches"]}
        out[S] = o
        del sd, fixed, comp, paged
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 3e
def finite_err(want, got) -> float:
    """Largest |want - got| over the finite entries of ``want`` (the
    dists of a (dists, ids) pair)."""
    if isinstance(want, tuple):
        want, got = want[0], got[0]
    fin = torch.isfinite(want)
    return float((want[fin] - got[fin]).abs().max()) if bool(
        fin.any()) else 0.0


SCAN_TOL = 1e-5      # the two scans: |diff| <= SCAN_TOL * (|q|^2 + |x|^2)
CONTRACT_TOL = "tol 1e-5*(|q|^2+|x|^2)"
TOL_SCANS = ("pairwise_l2", "sq8_pairwise_l2")   # TF32, held to SCAN_TOL
SCAN_OFFSETS = ((130, 5000, 128), (7, 129, 18), (64, 1000, 100))


def check_scan_tol(want, got, q, x, what) -> float:
    """The TF32 scans' contract (``x`` the float32 or the decoded rows);
    returns the largest |diff| / (|q|^2 + |x|^2)."""
    from tests.test_torch_cuda import expansion_ratio

    if got.shape != want.shape:
        raise SystemExit(f"{what}: shape {tuple(got.shape)}, plain "
                         f"{tuple(want.shape)}")
    ratio = expansion_ratio(got, want, q, x)
    if not ratio <= SCAN_TOL:
        raise SystemExit(f"{what}: |diff| / (|q|^2 + |x|^2) = {ratio:.3e} "
                         f"> {SCAN_TOL}")
    return ratio


def scan_control(name, args):
    """The one-TF32-product emulation of a TF32 scan, on its inputs: over
    the float32 rows, or the decoded int8 rows."""
    from tests.test_torch_cuda import tf32_pairwise_l2, tol_rows

    return tf32_pairwise_l2(*tol_rows(name, args), split=False)


def offset_args(name, B, N, d, dev):
    """A scan's severe-cancellation case: rows and queries 100 u off the
    origin (int8-encoded for the int8 scan)."""
    from tests.test_torch_cuda import offset_case, sq8_offset_case

    case = offset_case if name == "pairwise_l2" else sq8_offset_case
    return tuple(torch.as_tensor(a, device=dev)
                 for a in case(B, N, d, B + N))


def phase_scan_synthetic(dev):
    from tests.test_torch_cuda import (SCAN_KERNELS, expansion_ratio,
                                       same_bits, scan_cases, scan_kernel,
                                       tol_rows)

    n_cases, errs = 0, {}
    for name in SCAN_KERNELS:
        cuda_fn, plain = scan_kernel(name)
        saved = cuda_fn.launches
        count, err, ratio, control = 0, 0.0, 0.0, 0.0
        for tag, args in scan_cases(name, dev):
            want = plain(*args)
            got = cuda_fn(*args)
            torch.cuda.synchronize()
            rows = tol_rows(name, args)
            if rows is not None:
                ratio = max(ratio, check_scan_tol(want, got, *rows,
                                                  f"{name} {tag}"))
                control = max(control, expansion_ratio(
                    scan_control(name, args), want, *rows))
            elif not same_bits(want, got):
                raise SystemExit(f"{name} {tag}: differs from plain version")
            if name == "pool_merge" and not same_bits(
                    tuple(w.cpu() for w in want),
                    plain(*(a.cpu() for a in args))):
                raise SystemExit(f"{name} {tag}: the plain version differs "
                                 f"on the card from itself on the CPU")
            err = max(err, finite_err(want, got))
            count += 1
        if name in TOL_SCANS:
            log(f"  {name}: {count} cases within tolerance, largest "
                f"|diff| / (|q|^2 + |x|^2) {ratio:.3e}; the control, one "
                f"TF32 product emulated in torch, reads {control:.3e}")
            off, off_control = 0.0, float("inf")
            for B, N, d in SCAN_OFFSETS:
                args = offset_args(name, B, N, d, dev)
                want, got = plain(*args), cuda_fn(*args)
                torch.cuda.synchronize()
                rows = tol_rows(name, args)
                off = max(off, check_scan_tol(want, got, *rows,
                                              f"{name} offset B={B} N={N}"))
                off_control = min(off_control, expansion_ratio(
                    scan_control(name, args), want, *rows))
                count += 1
            log(f"  {name}: 3 cases 100 u off the origin within tolerance, "
                f"largest ratio {off:.3e}; the control's smallest "
                f"{off_control:.3e}")
            if not min(control, off_control) > SCAN_TOL:
                raise SystemExit(f"{name}: the tolerance does not reject a "
                                 f"single TF32 product ({control:.3e} on "
                                 f"the grid, {off_control:.3e} offset)")
            errs[f"{name} control"] = min(control, off_control)
            errs[f"{name} ratio"] = max(ratio, off)
        else:
            log(f"  {name}: {count} cases bit-identical"
                + (", its plain version on the card bit-identical to itself "
                   "on the CPU" if name == "pool_merge" else ""))
        cuda_fn.launches = saved
        n_cases += count
        errs[name] = err
    return n_cases, errs


# ------------------------------------------------------------------ phase 10
def _median_ms(fn, reps, **kw):
    """Median ms of ``fn`` over ``reps`` calls after one untimed call,
    by :func:`_event_ms` (``kw``: its ``before`` and ``busy``)."""
    fn()
    return _event_ms(fn, reps, median=True, **kw)[0]


def _plain_in_chunks(plain, got, B, what, tol=None, chunk=128):
    """Run ``plain(start, stop)`` over query chunks, each held against the
    same rows of ``got`` bit for bit, or by ``tol(want, got_rows, start,
    stop)``, which raises above its tolerance and returns its ratio.
    Returns (plain ms summed over the chunks, max abs err, largest
    ratio)."""
    from tests.test_torch_cuda import same_bits

    total, err, ratio = 0.0, 0.0, 0.0
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(s, e)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        if tol is not None:
            ratio = max(ratio, tol(want, got[s:e], s, e))
        elif not same_bits(want, got[s:e]):
            raise SystemExit(f"{what}: kernel differs from plain version in "
                             f"queries {s}..{e}")
        err = max(err, finite_err(want, got[s:e]))
        del want
    return total, err, ratio


def scan_entry(name, source, replaces, launches, err, ms, plain_ms,
               library_ms, library_note, flops, moved, contract="bits",
               rate=FP32_FLOPS, **extra):
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  {name}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms ({library_note}), bound {bound_ms:.5f} ms by "
        f"{by} ({flops} operations at {rate:.3g}/s, {moved} bytes), "
        f"{bound_ms / ms:.4f} of bound, {ms / library_ms:.3f}x the "
        f"library's time{''.join(f', {k} {v}' for k, v in extra.items())}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms,
            "library_note": library_note, "bound_share": bound_ms / ms,
            "contract": contract, **extra}


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    text = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return float(text.splitlines()[0].split()[0])


def phase_scan(ctx, dev, syn_errs, reps=5):
    """Phase 10: the scan and merge entry points on the main path's state."""
    from repro_torch.core.dynamic_search import _seed_full_state, hot_phase
    from repro_torch.core.recall import recall_at_k
    from repro_torch.kernels import ops, ref
    from tests.test_torch_cuda import (SCAN_KERNELS, same_bits, scan_kernel,
                                       sq8_decode)

    dqf = ctx["dqf"]
    c = dqf.cfg
    n = dqf.x.shape[0]
    qt = dqf._queries(ctx["batches"][0])
    B, d = qt.shape
    gt0 = ctx["gt"][:B]
    x_pad, adj_pad, live = (dqf._dev["x_pad"], dqf._dev["adj_pad"],
                            dqf._dev["live_pad"])
    x = x_pad[:n]
    sq = ctx["quant"]["sq8"].device_table(device=dev)
    pq = ctx["quant"]["pq"].device_table(device=dev)
    codes8, codes_pq = sq.codes[:n], pq.codes[:n]
    luts = pq.with_queries(qt).luts
    M, K = luts.shape[1], luts.shape[2]
    # one composed beam step on real state: phase 4's hot-phase pool seeded
    # into the full phase, and the adjacency row of each lane's frontier
    hd = dqf.hot_tables()
    hot_pool, _ = hot_phase(hd["x_hot_pad"], hd["adj_hot_pad"],
                            hd["hot_entries"], qt, pool_size=c.hot_pool,
                            max_hops=c.max_hops, mode=c.hot_mode)
    sentinel = x_pad.shape[0] - 1
    pool = _seed_full_state(hot_pool, hd["hot_ids_pad"], sentinel,
                            c.full_pool, live).pool
    frontier = ref.first_true((~pool.expanded) & (pool.ids != sentinel))
    p = pool.ids.gather(1, frontier[:, None].long())[:, 0]
    nbrs = adj_pad[p.long()].contiguous()
    L, R = pool.ids.shape[1], nbrs.shape[1]
    log(f"  state: x {tuple(x.shape)}, queries {tuple(qt.shape)}, sq8 codes "
        f"{tuple(codes8.shape)}, pq codes {tuple(codes_pq.shape)} with LUTs "
        f"{tuple(luts.shape)}, pool (B={B}, L={L}), candidates (B={B}, "
        f"C={R}) from the frontiers' adjacency rows")

    wrappers = {name: scan_kernel(name)[0] for name in SCAN_KERNELS}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = {"pairwise_l2": ops.pairwise_l2(qt, x),
           "sq8_pairwise_l2": ops.sq8_pairwise_l2(qt, codes8, sq.scale,
                                                  sq.zero),
           "pq_adc": ops.pq_adc(luts, codes_pq)}
    cand = ops.gather_distances(qt, x_pad, nbrs)
    merged = ops.pool_merge(pool.dists, pool.ids, cand, nbrs)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"  launches in the drive: {launches}")
    missing = [name for name, k in launches.items() if k <= 0]
    if missing:
        raise SystemExit(f"phase 10 never launched {missing}")
    for name, o in out.items():
        if o.shape != (B, n):
            raise SystemExit(f"{name} output has shape {tuple(o.shape)}")
    if merged[0].shape != (B, L) or not bool(
            (merged[0][:, 1:] >= merged[0][:, :-1]).all()):
        raise SystemExit("pool_merge output is malformed or unsorted")
    entries = []

    def recall_of(name):
        ids = torch.topk(out[name], 10, dim=1, largest=False).indices
        return recall_at_k(ids.cpu().numpy(), gt0)

    # --- the three scans, one after the other, each output freed after ---
    def expansion(rows):                  # the library's float32 scan
        return ((qt * qt).sum(1)[:, None] + (rows * rows).sum(1)[None, :]
                - 2.0 * torch.matmul(qt, rows.T))

    def library_merge():
        dd = torch.cat([pool.dists, cand], 1)
        srt = torch.sort(dd, dim=1, stable=True)
        return (srt.values[:, :L],
                torch.cat([pool.ids, nbrs], 1).gather(1, srt.indices[:, :L]))

    # the two scans: TF32 on the tensor cores, held to a tolerance.  The
    # bound counts the 2 B N d the function needs at the TF32 rate; the
    # float32 scan issues three times that, the int8 scan twice (codes are
    # exact in TF32), each its own floor; the exact product on the CUDA
    # cores is the bound of the bit-exact kernels they replaced
    def tf32x(products, moved, cuda_core_flops):
        return {"contract": CONTRACT_TOL, "rate": TF32_FLOPS,
                f"bound_{products}xtf32_ms": max(
                    products * 2 * B * n * d / TF32_FLOPS,
                    moved / HBM_BYTES_PER_S) * 1e3,
                "bound_cuda_core_ms": max(cuda_core_flops / FP32_FLOPS,
                                          moved / HBM_BYTES_PER_S) * 1e3}

    pw_bytes = (B + n) * d * 4 + B * n * 4
    sq_bytes = B * d * 4 + n * d + 2 * d * 4 + B * n * 4
    pw_flops = 2 * B * n * d + 3 * B * n + 2 * (B + n) * d
    # pq_adc's own floor: B N M shared-memory loads, 32 a wavefront, one
    # wavefront a clock on each SM at the card's highest SM clock
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_mhz() * 1e6
    pq_floor = dict(bound_smem_ms=B * n * M / 32 / (sms * clock_hz) * 1e3,
                    smem_floor_sms=sms, smem_floor_clock_mhz=clock_hz / 1e6)
    scans = (
        ("pairwise_l2", "pairwise_l2.cu", "src/repro/kernels/distance.py:35",
         lambda: ops.pairwise_l2(qt, x),
         lambda s, e: ref.pairwise_l2(qt[s:e], x),
         lambda: expansion(x),
         "(q²+x²) − 2·torch.matmul, TF32 off",
         2 * B * n * d, pw_bytes, tf32x(3, pw_bytes, pw_flops)),
        ("sq8_pairwise_l2", "pairwise_l2.cu",
         "src/repro/kernels/sq_distance.py:38",
         lambda: ops.sq8_pairwise_l2(qt, codes8, sq.scale, sq.zero),
         lambda s, e: ref.sq8_pairwise_l2(qt[s:e], codes8, sq.scale, sq.zero),
         lambda: expansion(codes8.float() * sq.scale + sq.zero),
         "decode, then (q²+x²) − 2·torch.matmul, TF32 off",
         2 * B * n * d, sq_bytes, tf32x(2, sq_bytes, pw_flops + 2 * n * d)),
        ("pq_adc", "pq_adc.cu", "src/repro/kernels/pq_adc.py:38",
         lambda: ops.pq_adc(luts, codes_pq),
         lambda s, e: ref.pq_adc(luts[s:e], codes_pq),
         lambda: luts[:, torch.arange(M, device=dev), codes_pq.long()].sum(-1),
         "advanced-index gather of (B, N, M), then sum",
         B * n * (M - 1), B * M * K * 4 + n * M + B * n * 4, pq_floor))
    recalls = {}
    tol_x = {"pairwise_l2": x,                 # rows the tolerance counts
             "sq8_pairwise_l2": sq8_decode(codes8, sq.scale, sq.zero)}
    for (name, source, replaces, kernel, plain, library, note, flops,
         moved, extra) in scans:
        recalls[name] = recall_of(name)
        tol = None
        if name in TOL_SCANS:
            tol = lambda want, got, s, e: check_scan_tol(
                want, got, qt[s:e], tol_x[name],
                f"{name} over {n} rows, queries {s}..{e}")
        plain_ms, err, ratio = _plain_in_chunks(plain, out[name], B, name,
                                                tol)
        if name in TOL_SCANS:
            del tol_x[name]
            ratio = max(ratio, syn_errs[f"{name} ratio"])
            log(f"  {name}: within 1e-5 (|q|^2 + |x|^2) of its plain "
                f"version over all {n} rows (and phase 3e), largest |diff| "
                f"/ (|q|^2 + |x|^2) {ratio:.3e}")
            extra = dict(extra, max_tol_ratio=ratio,
                         tf32_control_ratio=syn_errs[f"{name} control"])
        del out[name]
        saved = wrappers[name].launches
        ms = _median_ms(kernel, reps)
        wrappers[name].launches = saved
        library_ms = _median_ms(library, 3)
        entries.append(scan_entry(
            name, source, replaces, launches[name],
            max(err, syn_errs[name]), ms, plain_ms, library_ms, note, flops,
            moved, **extra))
        torch.cuda.empty_cache()
    log(f"  recall@10 of the exact top-10 of each scan: float32 "
        f"{recalls['pairwise_l2']:.4f}, sq8 {recalls['sq8_pairwise_l2']:.4f}"
        f", pq {recalls['pq_adc']:.4f}")
    if recalls["pairwise_l2"] < 0.999:
        raise SystemExit(f"the float32 scan's exact top-10 has recall@10 "
                         f"{recalls['pairwise_l2']:.4f} < 0.999")

    # --- the composed beam step: gather, then merge ---
    want_c = ref.gather_distances(qt, x_pad, nbrs)
    want_m = ref.pool_merge(pool.dists, pool.ids, want_c, nbrs)
    if not (same_bits(want_c, cand) and same_bits(want_m, merged)):
        raise SystemExit("gather_distances or pool_merge differs from its "
                         "plain version on the main path's state")
    md = merged[0]
    ties = (md[:, 1:] == md[:, :-1]) & (md[:, 1:] < ref.INF_DIST)
    log(f"  composed step: {int((nbrs == sentinel).sum())} sentinel "
        f"neighbours, {int(ties.sum())} equal adjacent finite keys (a "
        f"candidate already in the pool) in the merged pools")
    step = (
        ("gather_distances", "gather_distances.cu",
         "src/repro/kernels/gather_distance.py:39",
         lambda: ops.gather_distances(qt, x_pad, nbrs),
         lambda: ref.gather_distances(qt, x_pad, nbrs),
         lambda: ((x_pad[nbrs.long()] - qt[:, None, :]) ** 2).sum(-1),
         "((x_pad[nbrs] − q)²).sum(-1)", want_c, cand, 3 * B * R * d,
         B * R * d * 4 + B * d * 4 + B * R * 4 * 2),
        ("pool_merge", "pool_merge.cu", "src/repro/kernels/topk_merge.py:40",
         lambda: ops.pool_merge(pool.dists, pool.ids, cand, nbrs),
         lambda: ref.pool_merge(pool.dists, pool.ids, cand, nbrs),
         library_merge,
         "torch.sort(stable=True) of the concatenation, then a slice",
         want_m, merged,
         B * (R * int(np.log2(R)) + L + R), B * (L + R) * 8 + B * L * 8))
    # each timed a call alone and the device alone, beside an empty launch.
    # The gather's rows are cold in a beam step (32768 random rows of the
    # 512 MB table), so its timings flush the 50 MB L2 first by writing
    # 128 MB, and the card finishes the flush before the timed call; the
    # merge's pool and scores are warm (just written)
    l2 = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    flush = {"gather_distances": l2.zero_, "pool_merge": None}
    empty = lambda: torch.cuda._sleep(0)
    empty_ms = _median_ms(empty, 20), _median_ms(empty, 20, busy=True)
    log(f"  an empty launch (torch.cuda._sleep(0)): {empty_ms[0]:.4f} ms a "
        f"call alone, {empty_ms[1]:.4f} ms the device alone")
    for (name, source, replaces, kernel, plain, library, note, want, got,
         flops, moved) in step:
        saved = wrappers[name].launches
        ms = _median_ms(kernel, 20, before=flush[name])
        device_ms = _median_ms(kernel, 20, busy=True, before=flush[name])
        wrappers[name].launches = saved
        plain_ms = _median_ms(plain, 5, before=flush[name])
        library_ms = _median_ms(library, 20, before=flush[name])
        library_device_ms = _median_ms(library, 20, busy=True,
                                       before=flush[name])
        err = max(finite_err(want, got), syn_errs[name])
        log(f"  {name}: {ms:.4f} ms a call alone, {device_ms:.4f} ms the "
            f"device alone (library {library_ms:.4f} and "
            f"{library_device_ms:.4f} ms)")
        entries.append(scan_entry(name, source, replaces, launches[name],
                                  err, ms, plain_ms, library_ms, note, flops,
                                  moved, device_ms=device_ms,
                                  library_device_ms=library_device_ms,
                                  empty_launch_ms=empty_ms[0],
                                  empty_launch_device_ms=empty_ms[1]))
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in phase 10: {peak / 2**30:.3f} GiB")
    return entries, recalls


# ----------------------------------------------------------------- phase 15
KNN_N = 262_144          # datastore keys: kNN-LM's 103M cut to the limit
# The lift keeps distances, so the lookups' recall@10 is held to that of
# a twin index over the unlifted d = 128 keys (same config, the queries
# projected back), less this slack.  An absolute 0.5, phase 4's guard,
# does not fit this data: 256 keys a cluster in 128 dimensions leave the
# 10th neighbour only ~12% farther than the 2nd, and the first card run
# read 0.2663.
KNN_RECALL_SLACK = 0.05
KNN_F32_TOL = 1e-3       # f32 decode replay vs forward (the reference 2e-2)
KNN_HEAD_TOL = 1e-6      # the head vs its plain host recomputation
KNN_SUM_TOL = 1e-4       # every probability row sums to 1
# The demo query (the embedding row of the argmax token, |e|^2 ~ 1) lies
# ~400 (squared L2) from every key, so the head's default temperature of
# 10 puts every weight under the reference's 1e-9 floor and the kNN mass
# vanishes; 100 keeps it.
KNN_TEMPERATURE = 100.0


def lift(n, d, seed):
    """``make_clustered(n, 128, 1024 clusters, spread 1.5)`` and a seeded
    orthonormal d x 128 map (numpy QR) that lifts it into ``d`` dimensions
    (the LM's width): distances are kept, so the keys ``x @ basis.T`` have
    the clustered data's neighbours and its low intrinsic dimension, and
    ``q @ basis`` projects a query back."""
    x = make_clustered(n, 128, clusters=1024, seed=seed)
    rng = np.random.default_rng(seed + 1)
    basis = np.linalg.qr(rng.standard_normal((d, 128)))[0]
    return x, basis.astype(np.float32)


def lifted(x, basis):
    return np.ascontiguousarray(x @ basis.T, np.float32)


def host_head(logits, tokens, dists, vocab, lam, temperature):
    """The kNN-LM head of the reference (``serving/retrieval.py``) in
    numpy on the host, from one step's logits, tokens and dists."""
    w = np.exp(-dists / np.float32(temperature))
    w = w / np.maximum(w.sum(axis=1, keepdims=True), np.float32(1e-9))
    p_knn = np.zeros((tokens.shape[0], vocab), np.float32)
    for b in range(tokens.shape[0]):
        np.add.at(p_knn[b], tokens[b], w[b])
    p_lm = np.exp(logits - logits.max(-1, keepdims=True))
    p_lm = p_lm / p_lm.sum(-1, keepdims=True)
    return np.float32(lam) * p_knn + np.float32(1.0 - lam) * p_lm


def _events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def knn_retrieval(dev, seed, n, d, vocab):
    """Phase 15's datastore of ``n`` ``d``-wide keys and payload tokens
    below ``vocab``, and its check A: 4 Zipf batches of 1024 through
    ``RetrievalService.lookup``."""
    from repro_torch.core import DQF, DQFConfig, ZipfWorkload
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.serving.retrieval import RetrievalService

    # phase 4's config (the paper's defaults), fused
    cfg = DQFConfig(knn_k=32, out_degree=32, index_ratio=0.005, k=10,
                    hot_pool=32, full_pool=64, eval_gap=50, max_hops=512,
                    fused=True, fused_hops=8, hot_mode="graph")

    x128, basis = lift(n, d, seed)
    keys = lifted(x128, basis)
    payload = np.random.default_rng(seed + 2).integers(
        0, vocab, n).astype(np.int32)
    wl = ZipfWorkload(keys, seed=seed)
    history, fit_q = wl.sample(4096), wl.sample(2048)
    batches = [wl.sample(1024) for _ in range(4)]
    t0 = time.perf_counter()
    svc = RetrievalService.build(keys, payload, cfg, history=history,
                                 device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.dqf.fit_tree(fit_q)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    log(f"  RetrievalService.build (graph build + warm on 4096 Zipf "
        f"queries) {t_build:.3f} s, fit_tree on 2048 {t_fit:.3f} s, hot "
        f"index {svc.dqf.hot.size} rows, {keys.nbytes} bytes of keys")

    gt = ground_truth(keys, np.concatenate(batches), 10, device=dev)
    out, ms = [], []
    fused_hop_cuda.launches = 0
    for q in batches:
        s, e = _events(2)
        torch.cuda.synchronize()
        s.record()
        got = svc.lookup(q)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
        out.append(got)
    launches = fused_hop_cuda.launches
    tokens = torch.cat([o[0] for o in out]).cpu().numpy()
    dists = torch.cat([o[1] for o in out])
    ids = torch.cat([o[2] for o in out]).cpu().numpy()
    if ids.shape != (4096, 10) or not bool(torch.isfinite(dists).all()):
        raise SystemExit("lookup output malformed (shape or non-finite)")
    if not np.array_equal(tokens, payload[np.minimum(ids, n - 1)]):
        raise SystemExit("lookup tokens are not the payload of its ids")
    stats = [svc.dqf.search(q, record=False).stats for q in batches]
    recall = recall_at_k(ids, gt)
    base = recall_at_k(np.concatenate([svc.dqf.search_baseline(
        q).ids.cpu().numpy() for q in batches]), gt)
    fused_hop_cuda.launches = launches        # the stats' searches not
    dc = float(torch.cat([st.dist_count for st in stats]).float().mean())
    term = float(torch.cat([st.terminated_early
                            for st in stats]).float().mean())
    log(f"  A. 4 lookups of 1024: {', '.join(f'{m:.3f}' for m in ms)} ms "
        f"(CUDA events), recall@10 {recall:.4f} (beam search without the "
        f"dual index and tree {base:.4f}), mean dist_count {dc:.2f}, "
        f"terminated early {term:.4f}, fused_hop launches {launches} "
        f"({launches / 4:g} a lookup)")
    if launches != 8:
        raise SystemExit(f"4 lookups made {launches} fused_hop launches, "
                         "not 2 each")

    # the twin over the unlifted keys: what this data allows at d = 128
    t0 = time.perf_counter()
    twin = DQF(cfg, device=dev).build(x128)
    twin.warm(history @ basis)
    twin.fit_tree(fit_q @ basis)
    q128 = [q @ basis for q in batches]
    gt128 = ground_truth(x128, np.concatenate(q128), 10, device=dev)
    twin_recall = recall_at_k(np.concatenate([twin.search(
        q, record=False).ids.cpu().numpy() for q in q128]), gt128)
    twin_base = recall_at_k(np.concatenate([twin.search_baseline(
        q).ids.cpu().numpy() for q in q128]), gt128)
    fused_hop_cuda.launches = launches
    log(f"     the d = 128 twin (built, warmed, fit and searched in "
        f"{time.perf_counter() - t0:.3f} s): recall@10 {twin_recall:.4f} "
        f"(beam search {twin_base:.4f}); the exact top-10 of the lifted "
        f"and the unlifted keys agree on "
        f"{float((gt == gt128).all(1).mean()):.4f} of the queries")
    del twin
    torch.cuda.empty_cache()
    if recall < twin_recall - KNN_RECALL_SLACK:
        raise SystemExit(f"lookup recall@10 {recall:.4f} is below the d = "
                         f"128 twin's {twin_recall:.4f} less "
                         f"{KNN_RECALL_SLACK}")
    summary = dict(n=n, build_s=t_build, fit_s=t_fit,
                   lookup_ms=ms, recall=recall, recall_beam=base,
                   twin_recall=twin_recall, twin_recall_beam=twin_base,
                   dist_count=dc, terminated=term, launches=launches)
    return svc, batches, summary


def decode_replay(model, prompt, media=None):
    """Decode ``prompt`` token by token from empty caches against
    ``forward`` over it: (max |logit diff| over every position, share of
    positions whose argmax agrees).  With ``media`` the forward attends to
    it, and the decode's cross layers read its K/V from ``prefill``."""
    want = model(prompt, media=media)
    B, S = prompt.shape
    caches = model.init_decode_caches(B, S)
    if media is not None:
        _, pre = model.prefill(prompt, media=media)
        caches = [p if blk.kind == "cross" else c
                  for blk, c, p in zip(model.blocks, caches, pre)]
        del pre
    err, agree = 0.0, 0
    for t in range(S):
        logits, caches = model.decode_step(prompt[:, t:t + 1], caches, t)
        err = max(err, float((logits[:, 0] - want[:, t]).abs().max()))
        agree += int((logits[:, 0].argmax(-1)
                      == want[:, t].argmax(-1)).sum())
    return err, agree / (B * S)


def prefill_ok(model, logits, caches, B, S, T=0) -> bool:
    """A prefill of ``B`` x ``S`` tokens (and ``T`` media tokens) shaped as
    the reference's: finite last logits, one cache a layer: none for an
    xLSTM layer, the media's K/V for a cross layer, else the K/V of every
    position (the last window's where the window divides ``S``), a hybrid
    layer's SSM state beside them."""
    cfg = model.cfg
    kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
    for blk, c in zip(model.blocks, caches):
        if blk.kind in ("mlstm", "slstm"):
            ok = c is None
        elif blk.kind == "cross":
            ok = all(t.shape == (B, T, *kv) for t in c)
        else:
            if blk.kind == "hybrid":
                c, sc = c
                if sc.state.shape[0] != B or sc.state.dtype != torch.float32:
                    return False
            W = blk.window
            W = W if W and S >= W and S % W == 0 else S
            ok = c.k.shape == (B, W, *kv)
        if not ok:
            return False
    return (logits.shape == (B, 1, cfg.vocab_size)
            and len(caches) == cfg.num_layers
            and bool(torch.isfinite(logits).all()))


def timed_prefill(model, prompt, media=None):
    """ms of one ``prefill`` (CUDA events, after a warm-up call) and its
    output."""
    model.prefill(prompt, media=media)                         # warm up
    s, e = _events(2)
    s.record()
    logits, caches = model.prefill(prompt, media=media)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e), logits, caches


def knn_decoder(dev, seed, cfg):
    """Check B: the decoder at ``cfg``'s width (bf16) and its float32 copy,
    TF32 off: decode replays of a 64-token prompt, then a timed prefill of
    256 tokens at B = 16."""
    from repro_torch.models import DecoderLM

    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed, device=dev)
    m32 = DecoderLM(dataclasses.replace(cfg, dtype="float32"), seed=None,
                    device=dev)
    m32.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads (kv {cfg.num_kv_heads}), head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size},"
        f" {cfg.dtype}; {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters())}"
        f" bytes), made with its float32 copy in "
        f"{time.perf_counter() - t0:.3f} s")
    gen = torch.Generator().manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    err32, agree32 = decode_replay(m32, prompt)
    log(f"  B. float32 copy: 64 decode steps vs forward, max |diff| "
        f"{err32:.3e} (tolerance {KNN_F32_TOL}), argmax agreement "
        f"{agree32:.4f}")
    if not err32 <= KNN_F32_TOL:
        raise SystemExit(f"float32 decode differs from forward by {err32}")
    del m32
    torch.cuda.empty_cache()
    err16, agree16 = decode_replay(model, prompt)
    log(f"     bf16: max |diff| {err16:.3e}, argmax agreement "
        f"{agree16:.4f}")
    if not np.isfinite(err16):
        raise SystemExit("bf16 decode replay is not finite")

    long_prompt = torch.randint(0, cfg.vocab_size, (16, 256),
                                generator=gen).to(dev)
    prefill_ms, logits, caches = timed_prefill(model, long_prompt)
    if not prefill_ok(model, logits, caches, 16, 256):
        raise SystemExit("prefill output malformed")
    log(f"     prefill of 256 tokens at B = 16: {prefill_ms:.3f} ms, "
        f"{16 * 256 / (prefill_ms / 1e3):.1f} tokens/s")
    return model, dict(params=n_params, f32_err=err32, f32_agree=agree32,
                       bf16_err=err16, bf16_agree=agree16,
                       prefill_ms=prefill_ms)


def knn_decode(model, svc, steps=64, B=16, max_len=512):
    """Check C: ``serve_knnlm``'s loop at full width; every step's lookup
    through ``RetrievalService`` and the fused hop.  Returns the last
    step's queries and the summary."""
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.serving.retrieval import KNNLMHead

    V = model.cfg.vocab_size
    head = KNNLMHead(service=svc, vocab_size=V, lam=0.25,
                     temperature=KNN_TEMPERATURE)
    caches = model.init_decode_caches(B, max_len)
    tok = torch.zeros((B, 1), dtype=torch.long, device=model.device)
    split = np.zeros(3)
    kept = []
    torch.cuda.synchronize()
    fused_hop_cuda.launches = 0
    t0 = time.perf_counter()
    for t in range(steps):
        ev = _events(4)
        ev[0].record()
        logits, caches = model.decode_step(tok, caches, t)
        lm_logits = logits[:, 0]
        q = model.embed[lm_logits.argmax(-1)]     # serve_knnlm's query
        ev[1].record()
        tokens, dists, _ = svc.lookup(q)
        ev[2].record()
        probs = head.mix(lm_logits, tokens, dists)
        ev[3].record()
        tok = probs.argmax(-1)[:, None]
        torch.cuda.synchronize()
        split += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        kept.append((lm_logits, tokens, dists, probs))
    wall = time.perf_counter() - t0
    launches = fused_hop_cuda.launches
    split /= steps
    log(f"  C. kNN-LM decode, B = {B}, {steps} steps, max_len {max_len}: "
        f"{split.sum():.3f} ms a step (LM decode {split[0]:.3f}, lookup "
        f"{split[1]:.3f}, head {split[2]:.3f}; CUDA events), "
        f"{B * steps / wall:.1f} tokens/s (host clock), fused_hop launches "
        f"{launches} ({launches / steps:g} a step)")
    if launches != 2 * steps:
        raise SystemExit(f"the decode's {steps} lookups made {launches} "
                         "fused_hop launches, not 2 each")
    head_err, sum_err, knn_mass = 0.0, 0.0, 1.0
    for lm_logits, tokens, dists, probs in kept:
        p = probs.cpu().numpy()
        if p.shape != (B, V) or not np.isfinite(p).all():
            raise SystemExit("kNN-LM probabilities malformed")
        sum_err = max(sum_err, float(np.abs(p.sum(-1) - 1.0).max()))
        d = dists.cpu().numpy()
        want = host_head(lm_logits.cpu().numpy(), tokens.cpu().numpy(), d,
                         V, head.lam, head.temperature)
        head_err = max(head_err, float(np.abs(p - want).max()))
        w = np.exp(-d / np.float32(head.temperature)).sum(-1)
        knn_mass = min(knn_mass, float(w.min()))
    log(f"     every row finite, |sum - 1| <= {sum_err:.3e} (tolerance "
        f"{KNN_SUM_TOL}); head vs its host recomputation {head_err:.3e} "
        f"(tolerance {KNN_HEAD_TOL}); least kNN weight sum {knn_mass:.3e}")
    if sum_err > KNN_SUM_TOL:
        raise SystemExit(f"a probability row sums {sum_err} off 1")
    if head_err > KNN_HEAD_TOL:
        raise SystemExit(f"the head differs from its host recomputation by "
                         f"{head_err}")
    return q, dict(step_ms=split.sum(), lm_ms=split[0], lookup_ms=split[1],
                   head_ms=split[2], tokens_per_s=B * steps / wall,
                   launches=launches, head_err=head_err, sum_err=sum_err)


def phase_knnlm(dev, seed, n=KNN_N, lm_cfg=None):
    """Phase 15: the kNN-LM serving path at full width (module docstring).
    Returns its ``fused_hop`` entry for the kernel line and a summary."""
    from repro_torch.configs import get_config

    cfg = lm_cfg or get_config("qwen3-0.6b")
    torch.cuda.reset_peak_memory_stats()
    svc, batches, retrieval = knn_retrieval(dev, seed, n,
                                            cfg.d_model, cfg.vocab_size)
    model, decoder = knn_decoder(dev, seed, cfg)
    q_last, decode = knn_decode(model, svc)
    del model
    torch.cuda.empty_cache()
    log(f"  D. fused_hop at the lookup's state (d = {cfg.d_model}):")
    hop16 = time_hop(svc.dqf, q_last, decode["launches"],
                     "kNN-LM decode lookup, B=16")
    hop1k = time_hop(svc.dqf, batches[0], retrieval["launches"],
                     "kNN-LM lookup batch, B=1024")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in phase 15: {peak / 2**30:.3f} GiB")
    entry = dict(hop16, name="fused_hop (f32, kNN-LM lookup)",
                 launches_note="phase 15's 64-step kNN-LM decode, 2 a "
                 "lookup; the top-level numbers are one 8-hop launch at its "
                 f"B = 16, d = {cfg.d_model}",
                 batch_1024={k: hop1k[k] for k in (
                     "launches", "max_abs_err", "ms", "device_ms",
                     "plain_ms", "bound_ms", "bound_by", "full_phase_ms",
                     "full_phase_device_ms", "full_phase_bound_ms")})
    entry["max_abs_err"] = max(hop16["max_abs_err"], hop1k["max_abs_err"])
    return entry, dict(retrieval=retrieval, decoder=decoder, decode=decode,
                       peak_bytes=peak)


# ----------------------------------------------------------------- phase 16
SEGMENTS = 4             # segments of the frozen index, as the reference's
                         # own test takes
# The segment search is the plain Algorithm 3 a segment (no hot index, no
# tree, pool 64).  As phase 13 holds S > 1 shards to half of one shard's
# recall, its recall@10 is held to this share of the same beam search
# over phase 4's whole graph (``search_baseline``); each segment's recall
# against its own exact top-10 locates a loss.  Phase 4's 0.5 belongs to
# the dual-index search: on an H100 80GB HBM3 (700 W) the segments read
# 0.2942, bit for bit with the oracle, against 0.4369 over the whole
# graph.
SEGMENT_RECALL_SHARE = 0.5


def segment_oracle(tables, q, cfg):
    """Phase 16's sequential oracle: one plain ``beam_search`` a segment
    (the composed loop, on the card) over the stacked tables' block s, ids
    mapped through the segment's global ids (pool sentinel or padding row
    -> -1, inf), merged by ``merge_topk_host``.  Returns (ids, dists, the
    per-segment answers, hops and dist_count of every lane)."""
    from repro_torch.core import beam_search as bs
    from repro_torch.sharding import merge_topk_host

    x_t, adj_t, ent_t, off_t = tables
    n_seg = off_t.shape[1]
    per, hops, dc = [], [], []
    for s in range(off_t.shape[0]):
        res = bs.beam_search(x_t[s], adj_t[s], ent_t[s], q,
                             pool_size=cfg.full_pool, k=cfg.k,
                             max_hops=cfg.max_hops)
        local = res.ids.cpu().numpy()
        rows = off_t[s].cpu().numpy()[np.minimum(local, n_seg - 1)]
        bad = (local >= n_seg) | (rows < 0)
        per.append((np.where(bad, -1, rows).astype(np.int64),
                    np.where(bad, np.inf, res.dists.cpu().numpy()).astype(
                        np.float32)))
        hops.append(res.stats.hops)
        dc.append(res.stats.dist_count)
    ids, dists = merge_topk_host([p[0] for p in per], [p[1] for p in per],
                                 cfg.k)
    return ids, dists, per, torch.cat(hops), torch.cat(dc)


def segment_hop_check(tables, q, cfg, dev):
    """One ``fused_hop`` launch of ``fused_hops`` hops at the segment
    search's shapes (S·B lanes seeded by ``init_state`` from each
    segment's entries, the per-lane table base over the stacked ``(S,
    n_seg+1, ·)`` tables, no liveness, no tree) against its plain version,
    bit for bit; timed a call alone and the device alone beside the plain
    version and the bound."""
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    x_t, adj_t, ent_t, off_t = tables
    S, B = off_t.shape[0], q.shape[0]
    n1 = x_t.shape[1]
    lane = torch.arange(S, device=dev).repeat_interleave(B)
    qq = q.repeat(S, 1)
    hs0 = bs.to_hop_state(bs.init_state(bs.LaneTable(x_t, lane), qq,
                                        ent_t[lane], cfg.full_pool))
    args = (adj_t, qq, None, "f32", x_t, None, None, None, None, None)
    kw = dict(hops=cfg.fused_hops, max_hops=cfg.max_hops, k=cfg.k,
              eval_gap=cfg.eval_gap, add_step=cfg.add_step,
              tree_depth=cfg.tree_depth,
              lane_base=(lane * n1).to(torch.int32))
    saved = fused_hop_cuda.launches
    ms, device_ms, plain_ms, got = _kernel_vs_plain(
        lambda: fused_hop_cuda(hs0, *args, **kw),
        lambda: ref.fused_hop(hs0, *args, **kw), hs0.seen,
        "the segment search's fused_hop launch")
    fused_hop_cuda.launches = saved
    L, R, d = hs0.ids.shape[1], adj_t.shape[2], qq.shape[1]
    rows = int((got.dist_count - hs0.dist_count).sum())
    hops = int((got.hops - hs0.hops).sum())
    bound_ms, by, moved = hop_bound("f32", S * B, L, R, d, d * 4,
                                    S * B * d * 4, rows, hops)
    log(f"  fused_hop at the segment lanes, B={S * B} L={L} R={R} d={d} "
        f"hops={cfg.fused_hops}, lane base over ({S}, {n1}, ·): {ms:.4f} ms "
        f"a launch (device alone {device_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {by} ({moved} bytes, {rows} rows "
        f"scored); bits = plain")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": 0.0}


def phase_segments(ctx, dev, seed, num_shards=SEGMENTS):
    """Phase 16: the frozen segment index (``repro_torch.serving.sharded``)
    over phase 4's rows, SSG parameters and batches (module docstring).
    Returns the kernel-line entries of its path and a summary."""
    from repro_torch.core import DQFConfig
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.core.ssg import SSGParams
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.serving.sharded import (ShardedIndex,
                                             build_sharded_index,
                                             sharded_search)

    x, batches, gt, pc = ctx["x"], ctx["batches"], ctx["gt"], ctx["cfg"]
    params = SSGParams(knn_k=pc.knn_k, out_degree=pc.out_degree,
                       alpha_deg=pc.alpha_deg)
    cfg = DQFConfig(k=10, full_pool=64, max_hops=512)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = build_sharded_index(x, num_shards, params, seed=seed, device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = index.upload(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev_bytes = sum(t.numel() * t.element_size() for t in tables)
    n_seg = index.offsets.shape[1]
    log(f"  build_sharded_index: {num_shards} segments of {n_seg} rows, "
        f"{build_s:.3f} s ({build_s / num_shards:.3f} s a segment), R = "
        f"{index.adj_pad.shape[2]}, {index.entries.shape[1]} entries a "
        f"segment; upload of the stacked tables {upload_s:.3f} s, "
        f"{dev_bytes} device bytes")

    search = lambda q: sharded_search(index, q, cfg=cfg, device=dev)
    outs, ms, (hop_l, merge_l) = timed_batches(
        search, batches, (fused_hop_cuda, pool_merge_cuda))
    fused_hop_cuda.launches = pool_merge_cuda.launches = 0
    log(f"  sharded_search, 4 batches of {len(batches[0])}: "
        f"{', '.join(f'{t:.3f}' for t in ms)} ms a batch (CUDA events, the "
        f"copy to the host in); {hop_l} fused_hop and {merge_l} pool_merge "
        f"launches in the 4")
    if (hop_l, merge_l) != (len(batches), len(batches)):
        raise SystemExit(f"the segment search made {hop_l} fused_hop and "
                         f"{merge_l} pool_merge launches in "
                         f"{len(batches)} batches, not 1 and 1 a batch")
    t0 = time.perf_counter()
    oracle = [segment_oracle(tables, torch.as_tensor(q, device=dev), cfg)
              for q in batches]
    oracle_s = time.perf_counter() - t0
    fused_hop_cuda.launches = pool_merge_cuda.launches = 0
    for i, ((ids, dists), o) in enumerate(zip(outs, oracle)):
        if not (np.array_equal(ids.astype(np.int64), o[0])
                and _bits(dists, o[1])):
            raise SystemExit(f"the stacked segment search differs from its "
                             f"sequential oracle in batch {i}")
    ids = np.concatenate([o[0] for o in outs])
    dists = np.concatenate([o[1] for o in outs])
    if ids.shape != (len(gt), cfg.k) or ids.min() < 0 or \
            ids.max() >= x.shape[0] or not np.isfinite(dists).all():
        raise SystemExit("segment search output malformed")
    recall = recall_at_k(ids, gt)
    hops = torch.cat([o[3] for o in oracle]).float()
    dc = torch.cat([o[4] for o in oracle]).float()
    guard = SEGMENT_RECALL_SHARE * ctx["baseline_recall"]
    qs = np.concatenate(batches)
    own = []                     # each segment against its own top-10
    for s in range(num_shards):
        rows = index.offsets[s][index.offsets[s] >= 0]
        seg_gt = rows[ground_truth(x[rows], qs, cfg.k, device=dev)]
        own.append(recall_at_k(np.concatenate([o[2][s][0] for o in oracle]),
                               seg_gt))
    log(f"  = the sequential oracle ({num_shards} plain beam_search calls a "
        f"batch on the card, merge_topk_host; {oracle_s:.3f} s for the 4) "
        f"bit for bit in all 4 batches; recall@10 {recall:.4f} (guard "
        f"{guard:.4f}: {SEGMENT_RECALL_SHARE} of phase 4's beam search over "
        f"the whole graph, {ctx['baseline_recall']:.4f}); each segment "
        f"against its own exact top-10 "
        f"{', '.join(f'{r:.4f}' for r in own)}; a segment lane's mean hops "
        f"{float(hops.mean()):.2f} (most {int(hops.max())}), mean "
        f"dist_count {float(dc.mean()):.2f}")
    if recall < guard:
        raise SystemExit(f"segment search recall@10 {recall:.4f} < "
                         f"{guard:.4f}")
    merge = sharded_merge_check(oracle[0][2], cfg.k, dev)
    hop = segment_hop_check(tables, torch.as_tensor(batches[0], device=dev),
                            cfg, dev)
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in phase 16: {peak / 2**30:.3f} GiB")
    note = (f"phase 16's {len(batches)} batches of {len(batches[0])} over "
            f"{num_shards} segments of {n_seg} rows, one launch a batch")
    entries = [
        {"name": "fused_hop (f32, segment index)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_hop.cu",
         "replaces": "src/repro/kernels/fused_hop.py:313",
         "launches": hop_l, "max_abs_err": hop["max_abs_err"],
         "ms": hop["ms"], "plain_ms": hop["plain_ms"],
         "bound_ms": hop["bound_ms"], "bound_by": hop["bound_by"],
         "library_ms": None,
         "library_note": "no single PyTorch call computes a graph hop",
         "device_ms": hop["device_ms"], "contract": "bits",
         "launches_note": note + f"; the numbers are one {cfg.fused_hops}-"
         f"hop launch at its {num_shards * len(batches[0])} stacked lanes"},
        {"name": "pool_merge (segment merge)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pool_merge.cu",
         "replaces": "src/repro/kernels/topk_merge.py:40",
         "launches": merge_l, "max_abs_err": merge["max_abs_err"],
         "ms": merge["ms"], "plain_ms": merge["plain_ms"],
         "bound_ms": merge["bound_ms"], "bound_by": merge["bound_by"],
         "library_ms": merge["library_ms"],
         "library_note": "torch.sort(stable=True), then a slice",
         "device_ms": merge["device_ms"], "contract": "bits",
         "launches_note": note + "; the numbers are one merge of batch "
         "0's per-segment answers"}]
    summary = dict(build_s=build_s, upload_s=upload_s, batch_ms=ms,
                   recall=recall, segment_recall=own,
                   baseline_recall=ctx["baseline_recall"],
                   mean_hops=float(hops.mean()),
                   dist_count=float(dc.mean()), device_bytes=dev_bytes,
                   peak_bytes=peak, cfg=cfg,
                   segment0=ShardedIndex(       # phase 20 D's index
                       *(a[:1].copy() for a in (index.x_pad, index.adj_pad,
                                                index.entries,
                                                index.offsets)),
                       n_total=int((index.offsets[0] >= 0).sum())))
    del index, tables, outs, oracle
    torch.cuda.empty_cache()
    return entries, summary


# ----------------------------------------------------------------- phase 17
DS_ARCH = "deepseek-v2-lite-16b"
DS_REPLAY_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
DS_REPLAY_LAYERS = 4     # 1 dense + 3 MoE layers in the float32 replays


def replay_config(cfg):
    """``cfg`` at ``DS_REPLAY_LAYERS`` layers in float32, its capacity
    factor raised to E / K so that no token is dropped: the reference's
    capacity grows with the token count, so a capacity-bound model's
    decode is not its forward."""
    m = cfg.moe
    return dataclasses.replace(
        cfg, num_layers=DS_REPLAY_LAYERS, dtype="float32",
        moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))


def float32_replay(cfg, dev, seed, prompt):
    """A float32 copy of ``cfg`` at full width and ``DS_REPLAY_LAYERS``
    layers, drawn from ``seed``: ``prompt`` decoded token by token against
    ``forward``, within ``KNN_F32_TOL``."""
    from repro_torch.models import DecoderLM

    rcfg = replay_config(cfg)
    t0 = time.perf_counter()
    model = DecoderLM(rcfg, seed=seed, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    err, agree = decode_replay(model, prompt)
    _, aux = model(prompt, want_aux=True)
    dropped = float(aux[2])
    secs = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    log(f"  B. {cfg.name}, float32 at full width, {rcfg.num_layers} layers "
        f"({', '.join(rcfg.layer_kinds)}), capacity factor "
        f"{rcfg.moe.capacity_factor:.4f}: {n_params} parameters; "
        f"{prompt.shape[1]} decode steps at B = {prompt.shape[0]} vs "
        f"forward, max |diff| {err:.3e} (tolerance {KNN_F32_TOL}), argmax "
        f"agreement {agree:.4f}, dropped fraction summed over layers "
        f"{dropped:.4f}; {secs:.3f} s")
    if not err <= KNN_F32_TOL:
        raise SystemExit(f"{cfg.name}: float32 decode differs from forward "
                         f"by {err}")
    return dict(params=n_params, err=err, agree=agree, dropped=dropped)


def expert_product_timing(model, cfg):
    """The route the MoE takes for its expert products under bf16
    (``models/moe.py::_expert_mm``) beside widening the operands first,
    on one layer's ``w_gate`` at the decode's (C = 2) and the 16 x 256
    prefill's capacity: median ms of 20 (CUDA events), max |diff|."""
    from repro_torch.models.moe import _expert_mm

    m = cfg.moe
    w = next(b for b in model.blocks if b.kind == "moe").moe["w_gate"]
    gen = torch.Generator(device=w.device).manual_seed(7)
    out = {}
    for T in (16, 16 * 256):
        C = math.ceil(T * m.experts_per_token / m.num_experts
                      * m.capacity_factor)
        buf = torch.randn((m.num_experts, C, cfg.d_model), generator=gen,
                          device=w.device).to(w.dtype)
        route = _median_ms(lambda: _expert_mm(buf, w), 20)
        widened = _median_ms(lambda: torch.bmm(buf.float(), w.float()), 20)
        err = float((_expert_mm(buf, w)
                     - torch.bmm(buf.float(), w.float())).abs().max())
        out[C] = dict(route_ms=route, widened_ms=widened, max_abs_err=err)
        log(f"     expert product (E, C, d) @ (E, d, f) at C = {C}, bf16: "
            f"bmm with a float32 result {route:.4f} ms, widened first "
            f"{widened:.4f} ms (median of 20), max |diff| {err:.3e}")
        del buf
    return out


def deepseek_decoder(dev, seed, cfg, replay_cfgs):
    """Check B of phase 17: the float32 replays of ``replay_cfgs``, then
    ``cfg`` at full width (its dtype, bf16) drawn from ``seed``: its bf16
    replay, the dropped fraction at B = 16, the MLA cache bytes, a timed
    prefill of 256 tokens at B = 16."""
    from repro_torch.models import DecoderLM
    from repro_torch.models.attention import MLACache

    gen = torch.Generator().manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    replays = {c.name: float32_replay(c, dev, seed, prompt)
               for c in replay_cfgs}
    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    m = cfg.moe
    n_moe = cfg.layer_kinds.count("moe")
    log(f"  {cfg.name}: {cfg.num_layers} layers ({n_moe} moe), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads, MLA rank "
        f"{cfg.mla.kv_lora_rank}, {m.num_experts} routed experts top-"
        f"{m.experts_per_token} + {m.num_shared} shared of {m.d_expert}, "
        f"dense layer {cfg.dense_layer_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_params} parameters ({w_bytes} bytes), drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    err16, agree16 = decode_replay(model, prompt)
    log(f"     bf16 at full depth: max |diff| {err16:.3e}, argmax agreement "
        f"{agree16:.4f} (capacity {m.capacity_factor}: the decode's and the "
        f"forward's token counts drop differently)")
    if not np.isfinite(err16):
        raise SystemExit("bf16 decode replay is not finite")

    long_prompt = torch.randint(0, cfg.vocab_size, (16, 256),
                                generator=gen).to(dev)
    _, aux1 = model(long_prompt[:, :1], want_aux=True)
    _, aux256 = model(long_prompt, want_aux=True, logits_mode="last")
    drop16, drop4096 = float(aux1[2]) / n_moe, float(aux256[2]) / n_moe
    per_tok = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
    gqa_tok = 2 * cfg.num_kv_heads * cfg.mla.v_head_dim * 2
    cap16 = math.ceil(16 * m.experts_per_token / m.num_experts
                      * m.capacity_factor)
    log(f"     MoE dropped fraction a layer: {drop16:.4f} at B = 16 (one "
        f"token each, T = 16, C = {cap16}), {drop4096:.4f} at 16 x 256; "
        f"MLA cache {per_tok} bytes a token a layer ({gqa_tok} as GQA with "
        f"the same heads), "
        f"{per_tok * cfg.num_layers * 16 * 512} bytes at B = 16, max_len "
        f"512")
    experts = expert_product_timing(model, cfg)
    model.prefill(long_prompt)                                 # warm up
    s, e = _events(2)
    s.record()
    logits, caches = model.prefill(long_prompt)
    e.record()
    torch.cuda.synchronize()
    prefill_ms = s.elapsed_time(e)
    if (logits.shape != (16, 1, cfg.vocab_size)
            or len(caches) != cfg.num_layers
            or not isinstance(caches[0], MLACache)
            or caches[0].c_kv.shape != (16, 256, cfg.mla.kv_lora_rank)
            or not bool(torch.isfinite(logits).all())):
        raise SystemExit("prefill output malformed")
    del caches, logits
    log(f"     prefill of 256 tokens at B = 16: {prefill_ms:.3f} ms, "
        f"{16 * 256 / (prefill_ms / 1e3):.1f} tokens/s")
    return model, dict(params=n_params, weight_bytes=w_bytes,
                       replays=replays, experts=experts,
                       bf16_err=err16, bf16_agree=agree16,
                       dropped_b16=drop16, dropped_prefill=drop4096,
                       mla_bytes_token_layer=per_tok, prefill_ms=prefill_ms)


def phase_deepseek(dev, seed, n=KNN_N, lm_cfg=None,
                   replay_cfgs=None):
    """Phase 17: a kNN-LM over DeepSeek-V2-Lite at full width (module
    docstring).  Returns its ``fused_hop`` entry, a summary and its
    ``RetrievalService``, which phase 18 serves again."""
    from repro_torch.configs import get_config

    cfg = lm_cfg or get_config(DS_ARCH)
    replay_cfgs = replay_cfgs or [get_config(a) for a in DS_REPLAY_ARCHS]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc, batches, retrieval = knn_retrieval(dev, seed, n,
                                            cfg.d_model, cfg.vocab_size)
    model, decoder = deepseek_decoder(dev, seed, cfg, replay_cfgs)
    q_last, decode = knn_decode(model, svc)
    bound_ms = decoder["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"     the step's byte bound: {decoder['weight_bytes']} weight bytes "
        f"a step can touch / {HBM_BYTES_PER_S:.3g} B/s = {bound_ms:.3f} ms "
        f"(the step {decode['step_ms']:.3f} ms, LM decode "
        f"{decode['lm_ms']:.3f})")
    del model
    torch.cuda.empty_cache()
    log(f"  D. fused_hop at the lookup's state (d = {cfg.d_model}):")
    hop16 = time_hop(svc.dqf, q_last, decode["launches"],
                     f"{cfg.name} kNN-LM decode lookup, B=16")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in phase 17: {peak / 2**30:.3f} GiB")
    entry = dict(hop16, name=f"fused_hop (f32, kNN-LM lookup, {cfg.name})",
                 launches_note=f"phase 17's 64-step kNN-LM decode, 2 a "
                 "lookup; the top-level numbers are one 8-hop launch at its "
                 f"B = 16, d = {cfg.d_model}")
    torch.cuda.empty_cache()
    return entry, dict(retrieval=retrieval, decoder=decoder, decode=decode,
                       step_bound_ms=bound_ms, peak_bytes=peak), svc


# ----------------------------------------------------------------- phase 18
XL_ARCH = "xlstm-1.3b"
HYMBA_ARCH = "hymba-1.5b"
VISION_ARCH = "llama-3.2-vision-11b"
# float32 replays at full width, cut in depth: 7 mLSTM + 1 sLSTM, 4
# hybrid, 4 dense + 1 cross layers
REPLAY_LAYERS = {XL_ARCH: 8, HYMBA_ARCH: 4, VISION_ARCH: 5}
CROSS_GATE = 0.5         # the gate starts at 0, where a cross layer adds
                         # nothing and any parity over it holds vacuously
DECODE_TIMED = 8         # decode steps timed (after one untimed)


def open_cross_gates(model):
    with torch.no_grad():
        for blk in model.blocks:
            if blk.kind == "cross":
                blk.attn["gate"].fill_(CROSS_GATE)


def replay32(cfg, dev, seed, prompt, media=None):
    """A float32 copy of ``cfg`` at full width and ``REPLAY_LAYERS``
    layers, drawn from ``seed`` (cross gates opened): ``prompt`` decoded
    token by token against ``forward`` (with float32 ``media``), within
    ``KNN_F32_TOL``."""
    from repro_torch.models import DecoderLM

    rcfg = dataclasses.replace(cfg, num_layers=REPLAY_LAYERS[cfg.name],
                               dtype="float32")
    t0 = time.perf_counter()
    model = DecoderLM(rcfg, seed=seed, device=dev)
    open_cross_gates(model)
    n_params = sum(p.numel() for p in model.parameters())
    err, agree = decode_replay(model, prompt, media)
    del model
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"  {cfg.name}, float32 at full width, {rcfg.num_layers} layers "
        f"({', '.join(rcfg.layer_kinds)}): {n_params} parameters; "
        f"{prompt.shape[1]} decode steps at B = {prompt.shape[0]} from "
        f"empty state"
        + (" (cross K/V from prefill)" if media is not None else "")
        + f" vs forward, max |diff| {err:.3e} (tolerance {KNN_F32_TOL}), "
        f"argmax agreement {agree:.4f}; {secs:.3f} s")
    if not err <= KNN_F32_TOL:
        raise SystemExit(f"{cfg.name}: float32 decode differs from forward "
                         f"by {err}")
    return dict(params=n_params, err=err, agree=agree)


def full_model(cfg, dev, seed):
    """``cfg`` at full size in its dtype, drawn from ``seed``: the model,
    its parameter count and weight bytes."""
    from repro_torch.models import DecoderLM

    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed, device=dev)
    open_cross_gates(model)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kinds = {k: cfg.layer_kinds.count(k) for k in dict.fromkeys(
        cfg.layer_kinds)}
    log(f"  {cfg.name}: {cfg.num_layers} layers ("
        f"{', '.join(f'{v} {k}' for k, v in kinds.items())}), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads (kv {cfg.num_kv_heads}), "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {n} parameters ({nbytes} "
        f"bytes; the config's approximate count {cfg.total_params()}), drawn"
        f" in {time.perf_counter() - t0:.3f} s")
    return model, n, nbytes


def timed_decode(model, caches, B):
    """Mean ms of ``DECODE_TIMED`` decode steps at B (CUDA events), after
    one untimed step; every step's logits finite."""
    tok = torch.zeros((B, 1), dtype=torch.long, device=model.device)
    ms = []
    for t in range(DECODE_TIMED + 1):
        s, e = _events(2)
        s.record()
        logits, caches = model.decode_step(tok, caches, t)
        e.record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"{model.cfg.name}: decode step not finite")
        ms.append(s.elapsed_time(e))
    return float(np.mean(ms[1:]))


def xlstm_knnlm(dev, seed, cfg, svc):
    """Check A of phase 18: a kNN-LM over ``cfg`` (xLSTM) on ``svc``'s
    datastore, its payload drawn anew below ``cfg``'s vocabulary."""
    from repro_torch.serving.retrieval import RetrievalService

    n = svc.payload.shape[0]
    payload = np.random.default_rng(seed + 18).integers(
        0, cfg.vocab_size, n).astype(np.int32)
    xsvc = RetrievalService(dqf=svc.dqf, payload=torch.as_tensor(
        payload, device=dev))
    gen = torch.Generator().manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    f32 = replay32(cfg, dev, seed, prompt)
    model, n_params, w_bytes = full_model(cfg, dev, seed)
    err16, agree16 = decode_replay(model, prompt)
    log(f"     bf16 at full depth: 64 decode steps vs forward, max |diff| "
        f"{err16:.3e}, argmax agreement {agree16:.4f}")
    if not np.isfinite(err16):
        raise SystemExit("bf16 decode replay is not finite")
    long_prompt = torch.randint(0, cfg.vocab_size, (16, 256),
                                generator=gen).to(dev)
    prefill_ms, logits, caches = timed_prefill(model, long_prompt)
    if not prefill_ok(model, logits, caches, 16, 256):
        raise SystemExit("prefill output malformed")
    del logits, caches
    log(f"     prefill of 256 tokens at B = 16: {prefill_ms:.3f} ms, "
        f"{16 * 256 / (prefill_ms / 1e3):.1f} tokens/s; no cache for its "
        f"mLSTM and sLSTM layers, as the reference's")
    # the xLSTM layers' decode state, read and written every step
    state = sum(t.numel() * t.element_size() for blk, c in zip(
        model.blocks, model.init_decode_caches(16, 1)) for t in c
        if blk.kind in ("mlstm", "slstm"))
    torch.cuda.empty_cache()
    q_last, decode = knn_decode(model, xsvc)
    step_bytes = w_bytes + 2 * state
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"     the step's byte bound: {w_bytes} weight bytes + 2 x {state} "
        f"bytes of recurrent state at B = 16 (read and written) = "
        f"{step_bytes} bytes / {HBM_BYTES_PER_S:.3g} B/s = {bound_ms:.3f} "
        f"ms (the step {decode['step_ms']:.3f} ms, LM decode "
        f"{decode['lm_ms']:.3f})")
    del model
    torch.cuda.empty_cache()
    return q_last, dict(params=n_params, weight_bytes=w_bytes,
                        state_bytes=state, f32=f32, bf16_err=err16,
                        bf16_agree=agree16, prefill_ms=prefill_ms,
                        decode=decode, step_bound_ms=bound_ms)


def hymba_check(dev, seed, cfg):
    """Check B of phase 18: Hymba's float32 replay, then the bf16 model at
    full depth: a timed prefill of 16 x 256 and decode steps at B = 16."""
    gen = torch.Generator().manual_seed(seed + 4)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    f32 = replay32(cfg, dev, seed, prompt)
    model, n_params, w_bytes = full_model(cfg, dev, seed)
    long_prompt = torch.randint(0, cfg.vocab_size, (16, 256),
                                generator=gen).to(dev)
    prefill_ms, logits, caches = timed_prefill(model, long_prompt)
    if not prefill_ok(model, logits, caches, 16, 256):
        raise SystemExit("hymba prefill output malformed")
    del logits, caches
    decode_ms = timed_decode(model, model.init_decode_caches(16, 512), 16)
    log(f"     bf16 at full depth: prefill of 256 tokens at B = 16 "
        f"{prefill_ms:.3f} ms ({16 * 256 / (prefill_ms / 1e3):.1f} "
        f"tokens/s); a decode step at B = 16 {decode_ms:.3f} ms (mean of "
        f"{DECODE_TIMED}), its weight-byte bound "
        f"{w_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    del model
    torch.cuda.empty_cache()
    return dict(params=n_params, weight_bytes=w_bytes, f32=f32,
                prefill_ms=prefill_ms, decode_ms=decode_ms)


def vision_check(dev, seed, cfg):
    """Check C of phase 18: Llama-3.2-Vision's float32 replay with media,
    then the bf16 model at full depth: a timed prefill of 16 x 256 text
    tokens with media, and decode steps at B = 16 over its cross K/V."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    T = cfg.vision_tokens
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                           device=dev)
    media = torch.randn((4, T, cfg.d_model), generator=gen, device=dev)
    f32 = replay32(cfg, dev, seed, prompt, media)
    model, n_params, w_bytes = full_model(cfg, dev, seed)
    dtype = model.head.dtype
    long_prompt = torch.randint(0, cfg.vocab_size, (16, 256), generator=gen,
                                device=dev)
    media = torch.randn((16, T, cfg.d_model), generator=gen,
                        device=dev).to(dtype)
    prefill_ms, logits, pre = timed_prefill(model, long_prompt, media)
    if not prefill_ok(model, logits, pre, 16, 256, T):
        raise SystemExit("vision prefill output malformed")
    cross = [c for blk, c in zip(model.blocks, pre) if blk.kind == "cross"]
    kv_bytes = sum(t.numel() * t.element_size() for c in cross for t in c)
    caches = model.init_decode_caches(16, 512)
    caches = [p if blk.kind == "cross" else c
              for blk, c, p in zip(model.blocks, caches, pre)]
    del logits, pre
    decode_ms = timed_decode(model, caches, 16)
    log(f"     bf16 at full depth, media (16, {T}, {cfg.d_model}): prefill "
        f"of 256 text tokens at B = 16 {prefill_ms:.3f} ms "
        f"({16 * 256 / (prefill_ms / 1e3):.1f} tokens/s); cross K/V "
        f"{kv_bytes} bytes over {len(cross)} cross layers; a decode step at "
        f"B = 16 over them {decode_ms:.3f} ms (mean of {DECODE_TIMED}), its "
        f"byte bound (weights + cross K/V) "
        f"{(w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    del model, caches, cross
    torch.cuda.empty_cache()
    return dict(params=n_params, weight_bytes=w_bytes, f32=f32,
                prefill_ms=prefill_ms, cross_kv_bytes=kv_bytes,
                decode_ms=decode_ms)


def phase_blocks(dev, seed, svc, xl_cfg=None, hymba_cfg=None,
                 vision_cfg=None):
    """Phase 18: the last block kinds at full width (module docstring),
    over phase 17's ``RetrievalService``.  Returns its ``fused_hop`` entry
    and a summary."""
    from repro_torch.configs import get_config

    xl_cfg = xl_cfg or get_config(XL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"  A. a kNN-LM over {xl_cfg.name} on phase 17's datastore "
        f"({svc.payload.shape[0]} keys x {svc.dqf.store.d}):")
    q_last, xl = xlstm_knnlm(dev, seed, xl_cfg, svc)
    log(f"     fused_hop at the lookup's state (d = {xl_cfg.d_model}):")
    hop16 = time_hop(svc.dqf, q_last, xl["decode"]["launches"],
                     f"{xl_cfg.name} kNN-LM decode lookup, B=16")
    log("  B. hymba:")
    hymba = hymba_check(dev, seed, hymba_cfg or get_config(HYMBA_ARCH))
    log("  C. vision:")
    vision = vision_check(dev, seed, vision_cfg or get_config(VISION_ARCH))
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory in phase 18: {peak / 2**30:.3f} GiB")
    entry = dict(hop16, name=f"fused_hop (f32, kNN-LM lookup, "
                 f"{xl_cfg.name})",
                 launches_note=f"phase 18's 64-step kNN-LM decode, 2 a "
                 "lookup; the top-level numbers are one 8-hop launch at its "
                 f"B = 16, d = {xl_cfg.d_model}")
    return entry, dict(xlstm=xl, hymba=hymba, vision=vision,
                       peak_bytes=peak)


# ------------------------------------------------------------------ phase 19
# the reduced() forms of phase 19 D, with the depth overrides that keep
# every block kind (tests/test_torch_models.py::LMS): gemma3's global
# layer, an sLSTM layer, a cross layer; windows of 16 under S = 32
TRAIN_DEPTHS = {"gemma3-4b": dict(num_layers=6, window_size=16),
                "hymba-1.5b": dict(window_size=16),
                "xlstm-1.3b": dict(num_layers=8),
                "llama-3.2-vision-11b": dict(num_layers=5)}
TRAIN_STEPS = 12                 # phase 19 A's steps at full width (30
                                 # planned: cut to the script's limit)
TRAIN_CKPT_AT = 8                # the step phase 19 C saves after
TRAIN_EXTRA = 3                  # steps phase 19 C runs from the restore
# the guard written with the prediction, before the first card run
# (PERF.md §6): the mean loss of the last 5 steps at least this far
# (nats) below the mean of the first 3 (steps in warmup, near the init's
# loss)
TRAIN_LOSS_FALL = 0.03


def _ms_between(a, b, dev) -> float:
    """ms between two marks: CUDA events on the card, else host seconds
    (a CPU rehearsal)."""
    if dev.type == "cuda":
        return a.elapsed_time(b)
    return (b - a) * 1e3


def _mark(dev):
    if dev.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _clone_model(model, dev):
    """A ``DecoderLM`` on ``dev`` with ``model``'s weights."""
    from repro_torch.models import DecoderLM

    twin = DecoderLM(model.cfg, seed=None, device=dev)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for k, p in twin.named_parameters():
            p.copy_(src[k])
    return twin


def _train_inputs(cfg, rng, B, S):
    """numpy inputs as tests/test_arch_smoke.py::_inputs: tokens or
    embeds, media for a cross model, labels."""
    b = {}
    if cfg.embed_inputs:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        b["embeds"] = 0.02 * rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_every:
        b["media"] = 0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def _loss_grads(model, batch, tcfg):
    """(loss, metrics, grads) of ``make_train_step(model, tcfg).grads``
    (the parameters made trainable; no optimizer state is made)."""
    from repro_torch.training import TrainState, make_train_step

    for p in model.parameters():
        p.requires_grad_(True)
    return make_train_step(model, tcfg).grads(TrainState(model, None, None),
                                              batch)


def _grad_errs(got: dict, want: dict) -> tuple[float, str]:
    """The largest |got - want| / max|want| over the leaves, and its leaf
    (``got`` moved to the CPU)."""
    worst, name = 0.0, ""
    for k, w in want.items():
        w = w.float()
        err = float((got[k].float().cpu() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        if err > worst:
            worst, name = err, k
    return worst, name


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality where the tensors live (no host copy): floats compared
    as integers of their width, so NaN payloads and -0.0 count."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[a.dtype])
    return bool(torch.equal(a, b))


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def phase_train_full(dev, seed, cfg, *, steps=TRAIN_STEPS, batch=16,
                     seq=1024, ckpt_at=TRAIN_CKPT_AT, extra=TRAIN_EXTRA):
    """19 A and C: ``cfg`` trained ``steps`` steps in the launcher's loop
    (synthetic batches of ``batch`` x ``seq`` from ``data/pipeline.py``,
    microbatches 2, remat, warmup-cosine); the state saved asynchronously
    after step ``ckpt_at`` while the loop runs on, restored into a fresh
    ``TrainState`` (bit for bit against a device copy taken at the save),
    then ``extra`` steps from the restore against the unbroken run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import DecoderLM
    from repro_torch.training import (TrainConfig, make_train_step,
                                      train_state_init)

    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    tcfg = TrainConfig(microbatches=2, peak_lr=1e-3, warmup_steps=3,
                       total_steps=steps, schedule="warmup_cosine",
                       remat=True)
    state = train_state_init(model, tcfg)
    step_fn = make_train_step(model, tcfg)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch, seed=seed))
    M = tcfg.microbatches

    def batch_at(s):
        return {k: torch.as_tensor(v, device=dev).reshape(M, -1, seq)
                for k, v in src.batch(s).items()}

    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {n_params:,} parameters; "
        f"init {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="phase19_ckpt_")
    ck = Checkpointer(tmp, keep=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks, metrics_all, snap = [], [], None
    t_loop = time.perf_counter()
    for s in range(steps):
        b = batch_at(s)
        m0 = _mark(dev)
        loss, metrics, grads = step_fn.grads(state, b)
        m1 = _mark(dev)
        state, metrics = step_fn.update(state, loss, metrics, grads)
        m2 = _mark(dev)
        del grads
        marks.append((m0, m1, m2))
        metrics_all.append(metrics)
        if s + 1 == ckpt_at:
            ck.save(ckpt_at, state, extra={"arch": cfg.name})
            blocked_s = ck.last_blocked_s
            # a device copy of the saved state, for the bit check
            snap = ({k: p.detach().clone()
                     for k, p in state.model.named_parameters()},
                    {k: t.clone() for k, t in state.opt.m.items()},
                    {k: t.clone() for k, t in state.opt.v.items()},
                    state.opt.step.clone())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    ck.wait()
    losses = torch.stack([m["loss"] for m in metrics_all]).float().cpu()
    gnorms = torch.stack([m["grad_norm"] for m in metrics_all]).float().cpu()
    if not (torch.isfinite(losses).all() and torch.isfinite(gnorms).all()):
        raise RuntimeError(f"phase 19 A: a non-finite loss or grad norm: "
                           f"{losses.tolist()} {gnorms.tolist()}")
    fall = float(losses[:3].mean() - losses[-5:].mean())
    fb = [_ms_between(a, b, dev) for a, b, _ in marks]
    opt = [_ms_between(b, c, dev) for _, b, c in marks]
    # steps 0-1 warm the allocator and the kernels; the save's step is out
    timed = [i for i in range(2, steps) if i + 1 != ckpt_at] or [0]
    step_ms = float(np.median([fb[i] + opt[i] for i in timed]))
    fb_ms = float(np.median([fb[i] for i in timed]))
    opt_ms = float(np.median([opt[i] for i in timed]))
    tokens = batch * seq
    tok_s = tokens / (step_ms / 1e3)
    mfu = 6.0 * n_params * tokens / (step_ms / 1e3) / BF16_FLOPS
    # AdamW's bytes: params read and written, float32 grads read, m and v
    # read and written
    p_bytes = sum(p.numel() * p.element_size()
                  for p in state.model.parameters())
    opt_bytes = 2 * p_bytes + n_params * 4 + 4 * n_params * 4
    opt_bound = opt_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  losses {[round(float(v), 4) for v in losses]}; the last 5 "
        f"steps' mean {fall:.4f} nats below the first 3's")
    log(f"  grad norms {[round(float(v), 4) for v in gnorms]}")
    log(f"  step {step_ms:.3f} ms (forward+backward {fb_ms:.3f}, optimizer "
        f"{opt_ms:.3f}; median of steps {timed[0]}-{timed[-1]}), "
        f"{tok_s:,.0f} tokens/s, model-FLOPs share {mfu:.4f} (6 N tokens "
        f"/ step time / {BF16_FLOPS / 1e12:.0f} TFLOP/s, N = {n_params:,})")
    log(f"  optimizer {opt_ms:.3f} ms vs its byte bound {opt_bound:.3f} ms "
        f"({opt_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{len(state.opt.m)} leaves); loop "
        f"{loop_s:.1f} s; peak device memory {peak:.2f} GiB")
    if not fall >= TRAIN_LOSS_FALL:
        raise RuntimeError(f"phase 19 A: the loss fell {fall:.4f} nats "
                           f"(the last 5 steps' mean below the first 3's), "
                           f"under the {TRAIN_LOSS_FALL} predicted")

    # ---- C: restore into a fresh state, bit for bit, then steps on -----
    ck_bytes = ck.last_bytes
    save_s = ck.last_save_s
    unbroken = losses[ckpt_at: ckpt_at + extra]
    del state, model, step_fn, metrics_all
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fresh = train_state_init(DecoderLM(cfg, seed=None, device=dev), tcfg)
    t_r = time.perf_counter()
    fresh, meta = ck.restore(fresh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t_r
    params, m_snap, v_snap, step_snap = snap
    same = (meta["step"] == ckpt_at
            and _same_bits(fresh.opt.step, step_snap)
            and all(_same_bits(p, params[k])
                    for k, p in fresh.model.named_parameters())
            and all(_same_bits(fresh.opt.m[k], m_snap[k]) for k in m_snap)
            and all(_same_bits(fresh.opt.v[k], v_snap[k]) for k in v_snap))
    del snap, params, m_snap, v_snap
    if not same:
        raise RuntimeError("phase 19 C: the restored state differs from the "
                           "saved one")
    step2 = make_train_step(fresh.model, tcfg)
    resumed = []
    for s in range(ckpt_at, ckpt_at + extra):
        fresh, mt = step2(fresh, batch_at(s))
        resumed.append(mt["loss"])
    resumed = torch.stack(resumed).float().cpu()
    rel = float(((resumed - unbroken).abs() / unbroken.abs()).max())
    log(f"  checkpoint at step {ckpt_at}: {ck_bytes:,} bytes; the loop "
        f"blocked {blocked_s:.3f} s (device->host), save {save_s:.3f} s to "
        f"publish, restore {restore_s:.3f} s; params, m, v and step bit for "
        f"bit; {extra} steps from the restore {resumed.tolist()} vs the "
        f"unbroken run {unbroken.tolist()}: max rel {rel:.3e}")
    if not rel <= 1e-3:
        raise RuntimeError(f"phase 19 C: resumed losses differ by {rel:.3e}")
    shutil.rmtree(tmp, ignore_errors=True)
    del step2
    return dict(step_ms=step_ms, fb_ms=fb_ms, opt_ms=opt_ms,
                opt_bound_ms=opt_bound, tok_s=tok_s, mfu=mfu, peak_gib=peak,
                loss_fall=fall, ckpt_bytes=ck_bytes, blocked_s=blocked_s,
                save_s=save_s, restore_s=restore_s, resume_rel=rel,
                state=fresh, tcfg=tcfg)


def phase_train_parity(dev, seed, cfg, *, B=4, S=64):
    """19 B: ``cfg`` (full width, cut in depth) in float32: the card's
    loss and gradients against the port's CPU path on the same weights and
    batch; remat against none on the card; microbatches 2 against 1."""
    from repro_torch.models import DecoderLM
    from repro_torch.training import TrainConfig

    cpu = torch.device("cpu")
    host = DecoderLM(cfg, seed=seed, device=cpu)
    card = _clone_model(host, dev)
    b = _train_inputs(cfg, np.random.default_rng(seed), B, S)
    t0 = time.perf_counter()
    tc = TrainConfig(microbatches=1, remat=False)
    l_cpu, _, g_cpu = _loss_grads(host, b, tc)
    cpu_s = time.perf_counter() - t0
    del host
    l_dev, _, g_dev = _loss_grads(card, b, tc)
    loss_rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    g_err, g_leaf = _grad_errs(g_dev, g_cpu)
    del g_cpu
    _, _, g_remat = _loss_grads(card, b, TrainConfig(microbatches=1,
                                                     remat=True))
    remat_bits = [k for k in g_dev if not _same_bits(g_dev[k], g_remat[k])]
    remat_err = _grad_errs(g_remat, {k: g_dev[k].cpu() for k in remat_bits}
                           )[0] if remat_bits else 0.0
    micro = {k: torch.as_tensor(v).reshape(2, B // 2, *v.shape[1:])
             for k, v in b.items()}
    l_mb, _, _ = _loss_grads(card, micro, TrainConfig(microbatches=2,
                                                      remat=True))
    mb_rel = abs(float(l_mb) - float(l_dev)) / abs(float(l_dev))
    log(f"  {cfg.name} at {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, float32, B={B} S={S}: loss card "
        f"{float(l_dev):.6f} cpu {float(l_cpu):.6f} (rel {loss_rel:.2e}); "
        f"worst gradient leaf {g_leaf} at {g_err:.2e} of its max |g|; the "
        f"CPU's step {cpu_s:.1f} s")
    log(f"  remat vs none on the card: {len(g_dev) - len(remat_bits)} of "
        f"{len(g_dev)} leaves bit for bit"
        + (f"; {remat_bits} within {remat_err:.2e} (the embedding gather's "
           f"backward, index_put_ with accumulate)" if remat_bits else "")
        + f"; microbatches 2 vs 1: loss rel {mb_rel:.2e}")
    ok = (loss_rel <= 1e-5 and g_err <= 1e-4 and mb_rel <= 1e-4
          and set(remat_bits) <= {"embed"} and remat_err <= 1e-6
          and _all_finite(g_dev.values()))
    if not ok:
        raise RuntimeError("phase 19 B: the card's float32 step is off its "
                           "CPU twin or its remat/microbatch twins")
    return dict(loss_rel=loss_rel, grad_err=g_err, remat_bits=remat_bits,
                mb_rel=mb_rel, cpu_s=cpu_s)


def phase_train_configs(dev, seed, *, B=2, S=32):
    """19 D: one train step of each config's reduced() form on the card,
    float32, against its CPU twin (loss 1e-5 relative, each gradient leaf
    1e-4 of its max |g|); the two DeepSeek configs also in bf16 (the
    experts' ``out_dtype`` product differentiated): finite."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import DecoderLM
    from repro_torch.training import (TrainConfig, make_train_step,
                                      train_state_init)

    cpu = torch.device("cpu")
    tc = TrainConfig(microbatches=1, remat=True, peak_lr=1e-3,
                     warmup_steps=0, total_steps=10)
    out = {}
    runs = [(a, "float32") for a in ARCH_IDS] + [
        ("deepseek-v2-lite-16b", "bfloat16"),
        ("deepseek-moe-16b", "bfloat16")]
    for arch, dtype in runs:
        cfg = get_config(arch).reduced(**TRAIN_DEPTHS.get(arch, {}),
                                       dtype=dtype)
        host = DecoderLM(cfg, seed=seed, device=cpu)
        if cfg.cross_attn_every:         # open the cross gates (init 0)
            with torch.no_grad():
                for blk in host.blocks:
                    if blk.kind == "cross":
                        blk.attn.gate.fill_(0.5)
        card = _clone_model(host, dev)
        b = _train_inputs(cfg, np.random.default_rng(seed + 1), B, S)
        l_dev, _, g_dev = _loss_grads(card, b, tc)
        finite = bool(torch.isfinite(l_dev)) and _all_finite(g_dev.values())
        if dtype == "float32":
            l_cpu, _, g_cpu = _loss_grads(host, b, tc)
            loss_rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
            g_err, g_leaf = _grad_errs(g_dev, g_cpu)
        else:
            loss_rel, g_err, g_leaf = 0.0, 0.0, ""
        state = train_state_init(card, tc)
        state, mt = make_train_step(card, tc).update(
            state, l_dev, {}, g_dev)
        finite = finite and _all_finite(card.parameters()) and bool(
            torch.isfinite(mt["grad_norm"]))
        kinds = sorted(set(cfg.layer_kinds))
        log(f"  {arch} ({dtype}, {cfg.num_layers} layers {kinds}): loss "
            f"{float(l_dev):.6f}, grad norm {float(mt['grad_norm']):.4f}"
            + (f"; vs CPU loss rel {loss_rel:.2e}, worst leaf {g_leaf} "
               f"{g_err:.2e}" if dtype == "float32" else "; finite"))
        if not (finite and loss_rel <= 1e-5 and g_err <= 1e-4):
            raise RuntimeError(f"phase 19 D: {arch} ({dtype}) failed its "
                               "train step on the card")
        out[f"{arch} {dtype}"] = dict(loss_rel=loss_rel, grad_err=g_err)
    return out


def phase_training(dev, seed, full_cfg=None, parity_cfg=None, **full_kw):
    """Phase 19: training at full width (A and C), the float32 parity at
    full width cut to 2 layers (B), the ten configs' train steps (D)."""
    from repro_torch.configs import get_config

    full_cfg = full_cfg or get_config("qwen3-0.6b")
    parity_cfg = parity_cfg or dataclasses.replace(full_cfg, num_layers=2,
                                                   dtype="float32")
    t = time.perf_counter()
    log("  A/C: Qwen3-0.6B at full width and depth, bf16")
    full = phase_train_full(dev, seed, full_cfg, **full_kw)
    log(f"  (A and C: {time.perf_counter() - t:.1f} s)")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    log("  B: float32 at full width, 2 layers, the card vs the CPU")
    parity = phase_train_parity(dev, seed, parity_cfg)
    log(f"  (B: {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    log("  D: one train step of each config's reduced() form")
    configs = phase_train_configs(dev, seed)
    log(f"  (D: {time.perf_counter() - t:.1f} s)")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(full=full, parity=parity, configs=configs)


# ----------------------------------------------------------------- phase 20
FLASH_STEPS = 32                 # phase 20 B's decode steps
DP_STEPS = 3                     # phase 20 C's train steps
FLASH_ARGMAX = 0.99              # the reference test's contract
FLASH_REL = 2e-2
FLASH_REPLAY_REL = 1e-5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _decode_both(model, mesh, tokens, max_len):
    """``tokens`` (T, B, 1) decoded from empty caches through the default
    path and through ``flash_mesh=mesh``: (logits (T, B, V) of each, ms a
    step of each; CUDA events around the whole loop)."""
    out, ms = [], []
    for flash in (None, mesh):
        with torch.no_grad():            # warm both paths before the clock
            warm = model.init_decode_caches(tokens.shape[1], max_len,
                                            flash_mesh=flash)
            for t in range(2):
                model.decode_step(tokens[t], warm, t, flash_mesh=flash)
        del warm
        caches = model.init_decode_caches(tokens.shape[1], max_len,
                                          flash_mesh=flash)
        logits = []
        with torch.no_grad():
            a = _mark(model.device)
            for t in range(tokens.shape[0]):
                lg, caches = model.decode_step(tokens[t], caches, t,
                                               flash_mesh=flash)
                logits.append(lg[:, 0])
            b = _mark(model.device)
        _sync(model.device)
        ms.append(_ms_between(a, b, model.device) / tokens.shape[0])
        out.append(torch.stack(logits).float())
        del caches
    return out, ms


def _flash_decode_check(dev, seed, model, mesh):
    """20 B: full width against the default decode, then a float32
    4-layer replay."""
    from repro_torch.models import DecoderLM

    cfg = model.cfg
    gen = np.random.default_rng(seed + 20)
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab_size, (
        FLASH_STEPS, 16, 1)).astype(np.int64), device=dev)
    (plain, flash), (plain_ms, flash_ms) = _decode_both(model, mesh, tokens,
                                                        2 * FLASH_STEPS)
    agree = float((plain.argmax(-1) == flash.argmax(-1)).float().mean())
    rel = float((plain - flash).abs().max() / plain.abs().max())
    log(f"  B: {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}), B = 16, "
        f"{FLASH_STEPS} steps from empty caches: argmax agreement "
        f"{agree:.4f} (guard {FLASH_ARGMAX}), max |Δ logits| {rel:.3e} of "
        f"max |logits| (guard {FLASH_REL}); ms a step: default "
        f"{plain_ms:.3f}, flash {flash_ms:.3f} (CUDA events)")
    if agree < FLASH_ARGMAX or not rel <= FLASH_REL:
        raise RuntimeError("phase 20 B: flash decoding differs from the "
                           "default decode beyond the reference's contract")
    del plain, flash
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    m32 = DecoderLM(cfg32, seed=seed, device=dev)
    (plain, flash), _ = _decode_both(m32, mesh, tokens, 2 * FLASH_STEPS)
    rel32 = float((plain - flash).abs().max() / plain.abs().max())
    log(f"  B: float32 replay at 4 layers: max |Δ logits| {rel32:.3e} of "
        f"max |logits| (guard {FLASH_REPLAY_REL})")
    if not rel32 <= FLASH_REPLAY_REL:
        raise RuntimeError(f"phase 20 B: the float32 replay differs by "
                           f"{rel32:.3e}")
    del m32, plain, flash
    return dict(argmax=agree, rel=rel, rel32=rel32, plain_ms=plain_ms,
                flash_ms=flash_ms)


def _dp_check(dev, seed, state, tcfg, mesh):
    """20 C: DP steps at world 1 against the one-device step on a twin of
    ``state``, bit for bit."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training import TrainState, make_train_step

    model = state.model
    twin = _clone_model(model, dev)
    for p in twin.parameters():
        p.requires_grad_(True)
    opt = state.opt
    tstate = TrainState(twin, AdamWState(
        opt.step.clone(), {k: t.clone() for k, t in opt.m.items()},
        {k: t.clone() for k, t in opt.v.items()}), None)
    tcfg = dataclasses.replace(tcfg, microbatches=1)
    dp = make_train_step(model, tcfg, mesh=mesh)
    one = make_train_step(twin, tcfg)
    src = make_source(DataConfig(vocab_size=model.cfg.vocab_size,
                                 seq_len=256, global_batch=4, seed=seed + 20))
    same_loss, ms = [], {"dp": [], "one": []}
    for s in range(DP_STEPS):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch(s).items()}
        losses = {}
        for name, fn, st in (("dp", dp, state), ("one", one, tstate)):
            _sync(dev)
            a = _mark(dev)
            st, m = fn(st, b)
            e = _mark(dev)
            _sync(dev)
            ms[name].append(_ms_between(a, e, dev))
            losses[name] = m["loss"]
            if name == "dp":
                state = st
            else:
                tstate = st
        same_loss.append(_same_bits(losses["dp"], losses["one"]))
    same = all(_same_bits(p, q) for p, q in zip(model.parameters(),
                                                twin.parameters()))
    log(f"  C: {DP_STEPS} data-parallel steps at world 1 (4 x 256 tokens, "
        f"{model.cfg.dtype}) vs the one-device step: losses bit for bit "
        f"{same_loss}, every parameter after step {DP_STEPS} bit for bit "
        f"{same}; ms a step: DP {[round(v, 3) for v in ms['dp']]}, one "
        f"device {[round(v, 3) for v in ms['one']]}")
    if not (all(same_loss) and same):
        raise RuntimeError("phase 20 C: the data-parallel step at world 1 "
                           "differs from the one-device step")
    del twin, tstate
    return dict(dp_ms=ms["dp"], one_ms=ms["one"])


def _segment_mesh_check(dev, segments, batches, mesh):
    """20 D: ``sharded_search`` through the mesh path on a (1, 1) mesh
    against ``mesh=None`` over one segment, bit for bit, 1 + 1 launches a
    batch."""
    from repro_torch.kernels.fused_hop import fused_hop_cuda
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.serving.sharded import sharded_search

    index, cfg = segments["segment0"], segments["cfg"]
    one = lambda q: sharded_search(index, q, cfg=cfg, device=dev)  # noqa
    on_mesh = lambda q: sharded_search(index, q, mesh, cfg=cfg,  # noqa
                                       device=dev)
    one(batches[0])
    on_mesh(batches[0])                   # both uploads before the clock
    want, one_ms, _ = timed_batches(one, batches)
    got, mesh_ms, (hop_l, merge_l) = timed_batches(
        on_mesh, batches, (fused_hop_cuda, pool_merge_cuda))
    fused_hop_cuda.launches = pool_merge_cuda.launches = 0
    same = all(np.array_equal(a[0], b[0]) and _bits(a[1], b[1])
               for a, b in zip(got, want))
    log(f"  D: sharded_search on a (1, 1) mesh over segment 0 "
        f"({index.offsets.shape[1]} rows), {len(batches)} batches of "
        f"{len(batches[0])}: ids and dists bit for bit with mesh=None "
        f"{same}; {hop_l} fused_hop and {merge_l} pool_merge launches; ms "
        f"a batch: mesh {[round(v, 3) for v in mesh_ms]}, one card "
        f"{[round(v, 3) for v in one_ms]} (CUDA events, the copy to the "
        f"host in)")
    if not same:
        raise RuntimeError("phase 20 D: the mesh path differs from the "
                           "one-card search")
    if (hop_l, merge_l) != (len(batches), len(batches)):
        raise RuntimeError(f"phase 20 D: {hop_l} fused_hop and {merge_l} "
                           f"pool_merge launches in {len(batches)} batches")
    return dict(hop_launches=hop_l, merge_launches=merge_l,
                mesh_ms=mesh_ms, one_ms=one_ms)


ENGINE_QUERIES = 2048            # phase 20 E's traffic (phase 9's first 2)
ENGINE_RECALL = 0.5              # phase 20 E's guard, the float32 paths'

TP_DECODE_STEPS = 32             # phase 20 F's decode steps at B = 16
TP_CKPT_LAYERS = 4               # phase 20 F's checkpoint, cut in depth
# phase 20 G: the other kinds at full width, cut in depth for the time
# limit: DeepSeek-V2-Lite's dense layer 0 and two MoE layers (MLA, 64
# routed experts top-6, 2 shared), Llama-3.2-Vision's one self-attention
# and one cross layer, xLSTM-1.3B's first 8 layers (its own schedule: 7
# mLSTM and 1 sLSTM), Hymba-1.5B's first 2 hybrid layers (25 heads, 5 kv
# heads)
TP_KINDS_DEPTHS = {"deepseek-v2-lite-16b": dict(num_layers=3),
                   "llama-3.2-vision-11b": dict(num_layers=2,
                                                cross_attn_every=2),
                   "xlstm-1.3b": dict(num_layers=8),
                   "hymba-1.5b": dict(num_layers=2)}
TP_KINDS_STEPS = 2               # phase 20 G's train steps (the 2nd timed)
TP_KINDS_DECODE = 16             # phase 20 G's decode steps at B = 16
TP_KINDS_PROMPT = 64             # phase 20 G's prefill, 16 x 64 tokens


def _placed_twins(dev, arrays, cfg, mesh):
    """Phase 13's S = 1 index carried twice from its arrays: placed on
    ``mesh`` (one shard a rank, a world of one) and on one device."""
    from repro_torch.sharding import ShardConfig, ShardedDQF

    out = {}
    for placed in (True, False):
        sd = ShardedDQF.from_arrays(
            [{k: np.array(v) for k, v in arrays.items()}], cfg,
            ShardConfig(num_shards=1, use_mesh=mesh if placed else False),
            device=dev)
        _trigger_out_of_reach(sd)
        out[placed] = sd
    return out


def _placed_engine_check(dev, engine, batches):
    """20 E: ``ShardedEngine`` over the placed index against the unplaced
    engine over its twin, phase 9's closed loop of 2048 queries, fixed
    fused, paged and fixed under a chaos plan: every result bit for bit
    with its status, the ticks equal, at most one collective a tick,
    recall@10 of the float32 path at least 0.5."""
    from repro_torch.chaos import FaultPlan, install_chaos
    from repro_torch.core.recall import recall_at_k
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)
    from repro_torch.kernels.topk_merge import pool_merge_cuda
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.status import EngineConfig
    from repro_torch.sharding import ShardedEngine

    counters = [fused_hop_cuda, fused_hop_paged_cuda, pool_merge_cuda]
    names = ("fused_hop", "fused_hop_paged", "pool_merge")
    mesh = Mesh((1,), ("shard",), device_type=dev.type)
    t0 = time.perf_counter()
    twins = _placed_twins(dev, engine["arrays"], engine["cfg"], mesh)
    _sync(dev)
    log(f"  E: phase 13's S = 1 index carried twice (placed on a "
        f"one-rank shard mesh, and unplaced) in "
        f"{time.perf_counter() - t0:.2f} s")
    q = np.concatenate(batches)[:ENGINE_QUERIES]
    gt = engine["gt"][:ENGINE_QUERIES]
    k = engine["cfg"].k
    plan = FaultPlan(seed=0, shard_fail_ticks={0: frozenset({5, 6, 7})})
    cases = (("fixed fused", dict(paged=False), None),
             ("paged fused", dict(paged=True), None),
             ("fixed fused, chaos", dict(paged=False), plan))
    out = {}
    for what, kw, chaos in cases:
        runs = {}
        for placed in (True, False):
            eng = ShardedEngine(
                twins[placed], wave_size=256, tick_hops=8, page_cols=256,
                obs=ObsConfig(timeline=True), engine_cfg=EngineConfig(
                    quarantine_after=2, recover_after=2), **kw)
            if chaos is not None:
                install_chaos(eng, dataclasses.replace(chaos))
            c0 = eng.collectives
            _, res, launches, summ = serve(
                eng, [("default", q, 0)], counters, k,
                occupancy="sharded_engine_occupancy_ratio",
                statuses=("ok",) if chaos is None else ("ok", "degraded"))
            runs[placed] = dict(
                res=res, launches=dict(zip(names, launches)),
                ticks=summ["ticks"],       # less the submit's broadcast
                collectives=eng.collectives - c0 - (1 if placed else 0),
                ms_tick=summ["wall_s"] * 1e3 / max(summ["ticks"], 1),
                recall=recall_at_k(np.stack([r["ids"] for r in res]), gt),
                statuses=collections.Counter(r["status"] for r in res),
                quarantines=eng.health.quarantines)
            del eng
        a, b = runs[True], runs[False]
        compare_serving(a["res"], b["res"], f"E: {what}: placed vs "
                        "unplaced", (a["ticks"], b["ticks"]))
        same_status = [x["status"] for x in a["res"]] == \
            [x["status"] for x in b["res"]]
        log(f"  E: {what}: statuses equal {same_status} "
            f"({dict(a['statuses'])}); {a['collectives']} collectives in "
            f"{a['ticks']} ticks (unplaced {b['collectives']}); launches "
            f"placed {a['launches']}, unplaced {b['launches']}; ms a tick "
            f"placed {a['ms_tick']:.3f}, unplaced {b['ms_tick']:.3f} (host "
            f"wall over the run); recall@10 {a['recall']:.4f}; "
            f"quarantines {a['quarantines']}")
        if not same_status:
            raise RuntimeError(f"phase 20 E: {what}: statuses differ")
        if a["launches"] != b["launches"] or (dev.type == "cuda" and not (
                a["launches"]["pool_merge"] > 0 and a["launches"][
                    "fused_hop_paged" if kw["paged"] else "fused_hop"] > 0)):
            raise RuntimeError(f"phase 20 E: {what}: launches placed "
                               f"{a['launches']}, unplaced {b['launches']}")
        if not 0 < a["collectives"] <= a["ticks"] + 1:
            raise RuntimeError(f"phase 20 E: {what}: {a['collectives']} "
                               f"collectives in {a['ticks']} ticks")
        if chaos is None and a["recall"] < ENGINE_RECALL:
            raise RuntimeError(f"phase 20 E: {what}: recall@10 "
                               f"{a['recall']:.4f} < {ENGINE_RECALL}")
        if chaos is not None and not (a["quarantines"] >= 1 and
                                      a["statuses"]["degraded"] > 0):
            raise RuntimeError("phase 20 E: the chaos plan did not bite")
        out[what] = {key: a[key] for key in ("launches", "ticks",
                                             "collectives", "ms_tick",
                                             "recall")}
        out[what]["unplaced_ms_tick"] = b["ms_tick"]
    del twins
    return out


def _tp_state(state, model, dev):
    """A ``TrainState`` over ``model`` with a copy of ``state``'s moments
    and step (no residual)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training import TrainState

    for p in model.parameters():
        p.requires_grad_(True)
    opt = state.opt
    return TrainState(model, AdamWState(
        opt.step.clone(), {k: t.clone() for k, t in opt.m.items()},
        {k: t.clone() for k, t in opt.v.items()}), None)


def _tp_checkpoint(dev, model, state, mesh):
    """20 F's checkpoint: ``model``'s first ``TP_CKPT_LAYERS`` layers (and
    its embedding and final norm, their moments and step) cut over the
    mesh, saved by the ``Checkpointer`` and restored into a fresh state
    cut over the same mesh: every leaf bit for bit."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.tensor_parallel import shard_lm
    from repro_torch.models import DecoderLM
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training import TrainConfig, TrainState
    from repro_torch.training.train_step import train_state_init

    cfg = dataclasses.replace(model.cfg, num_layers=TP_CKPT_LAYERS)
    cut = DecoderLM(cfg, seed=None, device=dev)
    src = dict(model.named_parameters())
    names = [n for n, _ in cut.named_parameters()]
    with torch.no_grad():
        for n, p in cut.named_parameters():
            p.copy_(src[n])
    shard_lm(cut, mesh)
    opt = state.opt
    saved = TrainState(cut, AdamWState(
        opt.step.clone(), {n: opt.m[n].clone() for n in names},
        {n: opt.v[n].clone() for n in names}), None)
    fresh = DecoderLM(cfg, seed=None, device=dev)
    shard_lm(fresh, mesh)
    fresh = train_state_init(fresh, TrainConfig(), mesh=mesh)
    with tempfile.TemporaryDirectory(prefix="phase20f_") as tmp:
        ck = Checkpointer(tmp)
        t0 = time.perf_counter()
        ck.save(1, saved, block=True)
        t1 = time.perf_counter()
        fresh, meta = Checkpointer(tmp).restore(fresh)
        _sync(dev)
        t2 = time.perf_counter()
    pairs = [(p, dict(fresh.model.named_parameters())[n])
             for n, p in cut.named_parameters()]
    pairs += [(saved.opt.m[n], fresh.opt.m[n]) for n in names]
    pairs += [(saved.opt.v[n], fresh.opt.v[n]) for n in names]
    pairs.append((saved.opt.step, fresh.opt.step))
    same = all(_same_bits(a, b) for a, b in pairs)
    log(f"  F: checkpoint of {TP_CKPT_LAYERS} layers ({ck.last_bytes} "
        f"bytes) written in {t1 - t0:.2f} s, restored onto the same mesh in "
        f"{t2 - t1:.2f} s: {len(pairs)} leaves bit for bit {same}")
    if not same or meta["step"] != 1:
        raise RuntimeError("phase 20 F: the restored checkpoint differs")
    return dict(ckpt_bytes=ck.last_bytes, save_s=t1 - t0, restore_s=t2 - t1)


def _tp_check(dev, seed, state, tcfg, mesh):
    """20 F: tensor parallelism at a model axis of one rank on phase 19's
    restored Qwen3-0.6B against the plain model on a twin: one train
    step (4 x 256 tokens) and 32 decode steps at B = 16 bit for bit, then
    a checkpoint restored onto the same mesh."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.distributed.tensor_parallel import shard_lm
    from repro_torch.training import make_train_step

    model = state.model
    twin = _clone_model(model, dev)
    tp = shard_lm(twin, mesh)
    tstate = _tp_state(state, twin, dev)
    tcfg = dataclasses.replace(tcfg, microbatches=1)
    one = make_train_step(model, tcfg)
    split = make_train_step(twin, tcfg, mesh=mesh)
    b = {k: torch.as_tensor(v, device=dev) for k, v in make_source(
        DataConfig(vocab_size=model.cfg.vocab_size, seq_len=256,
                   global_batch=4, seed=seed + 21)).batch(0).items()}
    ms = {}
    for name, fn, st in (("plain", one, state), ("tp", split, tstate)):
        _sync(dev)
        a = _mark(dev)
        st, m = fn(st, b)
        e = _mark(dev)
        _sync(dev)
        ms[name] = _ms_between(a, e, dev)
        if name == "plain":
            state, loss_plain = st, m["loss"]
        else:
            tstate, loss_tp = st, m["loss"]
    same_loss = _same_bits(loss_plain, loss_tp)
    same = all(_same_bits(p, q) for p, q in zip(model.parameters(),
                                                twin.parameters()))
    gen = np.random.default_rng(seed + 21)
    tokens = torch.as_tensor(gen.integers(0, model.cfg.vocab_size, (
        TP_DECODE_STEPS, 16, 1)).astype(np.int64), device=dev)
    logits, dec_ms = {}, {}
    for name, m_, kw in (("plain", model, {}), ("tp", twin,
                                                {"mesh": mesh})):
        with torch.no_grad():           # warm both paths before the clock
            warm = m_.init_decode_caches(16, 2 * TP_DECODE_STEPS, **kw)
            for t in range(2):
                m_.decode_step(tokens[t], warm, t, **kw)
            del warm
            caches = m_.init_decode_caches(16, 2 * TP_DECODE_STEPS, **kw)
            out = []
            a = _mark(dev)
            for t in range(TP_DECODE_STEPS):
                lg, caches = m_.decode_step(tokens[t], caches, t, **kw)
                out.append(lg)
            e = _mark(dev)
            _sync(dev)
        dec_ms[name] = _ms_between(a, e, dev) / TP_DECODE_STEPS
        logits[name] = torch.stack(out)
        del caches
    same_dec = _same_bits(logits["plain"], logits["tp"])
    log(f"  F: {model.cfg.name} cut over a (1, 1) mesh ({tp}): one train "
        f"step (4 x 256 tokens) loss bit for bit {same_loss}, every "
        f"parameter after it bit for bit {same}; ms the step plain "
        f"{ms['plain']:.3f}, tensor-parallel {ms['tp']:.3f} (its first "
        f"call); "
        f"{TP_DECODE_STEPS} decode steps at B = 16 bit for bit {same_dec}, "
        f"ms a step plain {dec_ms['plain']:.3f}, tensor-parallel "
        f"{dec_ms['tp']:.3f} (CUDA events)")
    if not (same_loss and same and same_dec):
        raise RuntimeError("phase 20 F: tensor parallelism at one rank "
                           "differs from the plain path")
    del logits
    ck = _tp_checkpoint(dev, twin, tstate, mesh)
    del twin, tstate
    return dict(step_ms=ms, decode_ms=dec_ms, **ck), state


class _CollectiveCount:
    """Counts the ``torch.distributed`` collectives called inside a
    ``with`` block (the module's functions are looked up at each call)."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "broadcast", "reduce_scatter_tensor")

    def __enter__(self):
        import torch.distributed as dist

        self.n, self._saved = 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(*a, _fn=fn, **k):
                self.n += 1
                return _fn(*a, **k)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _tp_kind_check(dev, seed, cfg, mesh):
    """One model of 20 G: ``cfg`` drawn from ``seed`` (cross gates opened)
    and a twin cut over ``mesh`` (``shard_lm``): ``TP_KINDS_STEPS`` train
    steps (4 x 256 tokens each, seeded media for a cross model), a
    prefill of 16 x ``TP_KINDS_PROMPT`` and ``TP_KINDS_DECODE`` decode
    steps at B = 16 from empty caches (a cross layer's from the prefill),
    each bit for bit against the plain model; ms the last train step and
    a decode step (both warmed) both ways, and the collectives of one
    split decode step."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.distributed.tensor_parallel import shard_lm
    from repro_torch.models import DecoderLM
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import train_state_init

    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed, device=dev)
    open_cross_gates(model)
    twin = _clone_model(model, dev)
    tp = shard_lm(twin, mesh)
    n_params = sum(p.numel() for p in model.parameters())
    _sync(dev)
    made_s = time.perf_counter() - t0
    dtype = model.embed.dtype
    gen = torch.Generator(device=dev).manual_seed(seed + 23)

    def media(B):
        if not cfg.cross_attn_every:
            return None
        return torch.randn((B, cfg.vision_tokens, cfg.d_model),
                           generator=gen, device=dev).to(dtype)

    tcfg = TrainConfig(microbatches=1, remat=False, peak_lr=1e-3,
                       warmup_steps=0)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                 global_batch=4, seed=seed + 23))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                src.batch(i).items()} for i in range(TP_KINDS_STEPS)]
    m = media(4)
    for b in batches:
        if m is not None:
            b["media"] = m
    before = model.final_norm.detach().clone()
    step_ms, loss = {}, {}
    for name, mdl, kw in (("plain", model, {}), ("tp", twin,
                                                 {"mesh": mesh})):
        state = train_state_init(mdl, tcfg, **kw)
        step = make_train_step(mdl, tcfg, **kw)
        loss[name] = []
        for b in batches:
            _sync(dev)
            a = _mark(dev)
            state, metrics = step(state, b)
            e = _mark(dev)
            _sync(dev)
            loss[name].append(metrics["loss"])
        step_ms[name] = _ms_between(a, e, dev)
        del state, step
        for p in mdl.parameters():
            p.requires_grad_(False)
    same_loss = all(_same_bits(a, b) for a, b in zip(loss["plain"],
                                                     loss["tp"]))
    same = all(_same_bits(p, q) for p, q in zip(model.parameters(),
                                                twin.parameters()))
    moved = not _same_bits(before, model.final_norm)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    prompt = torch.randint(0, cfg.vocab_size, (16, TP_KINDS_PROMPT),
                           generator=gen, device=dev)
    m = media(16)
    tokens = torch.randint(0, cfg.vocab_size, (TP_KINDS_DECODE, 16, 1),
                           generator=gen, device=dev)
    pre_logits, logits, dec_ms, calls = {}, {}, {}, 0
    for name, mdl, kw in (("plain", model, {}), ("tp", twin,
                                                 {"mesh": mesh})):
        with torch.no_grad():
            pre_logits[name], pre = mdl.prefill(prompt, media=m, **kw)

            def empty():
                caches = mdl.init_decode_caches(16, 2 * TP_KINDS_DECODE,
                                                **kw)
                return [p if blk.kind == "cross" else c
                        for blk, c, p in zip(mdl.blocks, caches, pre)]
            warm = empty()              # warm both paths before the clock
            mdl.decode_step(tokens[0], warm, 0, **kw)
            with _CollectiveCount() as count:
                mdl.decode_step(tokens[1], warm, 1, **kw)
            if name == "tp":
                calls = count.n
            del warm
            caches = empty()
            out = []
            a = _mark(dev)
            for t in range(TP_KINDS_DECODE):
                lg, caches = mdl.decode_step(tokens[t], caches, t, **kw)
                out.append(lg)
            e = _mark(dev)
            _sync(dev)
        dec_ms[name] = _ms_between(a, e, dev) / TP_KINDS_DECODE
        logits[name] = torch.stack(out)
        del caches, pre
    same_pre = _same_bits(pre_logits["plain"], pre_logits["tp"])
    same_dec = _same_bits(logits["plain"], logits["tp"])
    finite = _all_finite([pre_logits["tp"], logits["tp"]])
    kinds = ", ".join(cfg.layer_kinds)
    log(f"  G: {cfg.name}, d_model {cfg.d_model}, {cfg.num_layers} layers "
        f"({kinds}), {cfg.dtype}, {n_params} parameters, drawn with its "
        f"twin cut over a (1, 1) mesh ({tp}) in {made_s:.2f} s"
        + (f"; media (B, {cfg.vision_tokens}, {cfg.d_model}), cross gates "
           f"{CROSS_GATE}" if cfg.cross_attn_every else ""))
    log(f"     {TP_KINDS_STEPS} train steps (4 x 256 tokens each): losses "
        f"bit for bit {same_loss}, every parameter after them bit for bit "
        f"{same} (moved {moved}); ms the last step plain "
        f"{step_ms['plain']:.3f}, tensor-parallel {step_ms['tp']:.3f} (CUDA "
        f"events)")
    log(f"     prefill of 16 x {TP_KINDS_PROMPT} bit for bit {same_pre}; "
        f"{TP_KINDS_DECODE} decode steps at B = 16 bit for bit {same_dec}, "
        f"ms a step plain {dec_ms['plain']:.3f}, tensor-parallel "
        f"{dec_ms['tp']:.3f} (warmed, CUDA events); {calls} collectives "
        f"in a tensor-parallel decode step; finite {finite}")
    if not (same_loss and same and moved and same_pre and same_dec
            and finite):
        raise RuntimeError(f"phase 20 G: {cfg.name} at a model axis of one "
                           f"rank differs from the plain model")
    del model, twin, logits, pre_logits
    return dict(params=n_params, step_ms=step_ms, decode_ms=dec_ms,
                collectives=calls)


def _tp_kinds_check(dev, seed, mesh, cfgs=None):
    """20 G: ``_tp_kind_check`` on each config of ``TP_KINDS_DEPTHS`` at
    full width (or of ``cfgs``); G's peak device memory and seconds."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if cfgs is None:
        cfgs = [dataclasses.replace(get_config(arch), **over)
                for arch, over in TP_KINDS_DEPTHS.items()]
    out = {}
    for cfg in cfgs:
        out[cfg.name] = _tp_kind_check(dev, seed, cfg, mesh)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else float("nan"))
    secs = time.perf_counter() - t0
    log(f"  G: peak device memory {peak:.2f} GiB, {secs:.1f} s")
    return dict(models=out, peak_gib=peak, seconds=secs)


def phase_distributed(dev, seed, trained, segments, batches, engine):
    """Phase 20 (module docstring): the multi-rank code at world 1 over
    NCCL.  ``trained`` is phase 19's result (its restored state),
    ``segments`` phase 16's summary (its segment 0), ``engine`` phase
    13's S = 1 arrays with phase 4's config and ground truth."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import init_distributed, make_test_mesh

    t0 = time.perf_counter()
    rank_dev = init_distributed(dev.type)
    try:
        log(f"  A: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, rank {dist.get_rank()} on "
            f"{rank_dev}, NCCL "
            f"{torch.cuda.nccl.version() if dev.type == 'cuda' else None}, "
            f"{torch.cuda.device_count()} CUDA device(s); set up in "
            f"{time.perf_counter() - t0:.2f} s")
        log("  A: the multi-rank checks (worlds of 2 and 4: flash decoding, "
            "the pipeline, data-parallel steps, checkpoints across worlds, "
            "placed shards and segments) ran on the CPU only, in "
            "tests/test_torch_dist_*.py over gloo: NCCL allows one rank a "
            "device, and this machine has "
            f"{torch.cuda.device_count()} card(s)")
        mesh = make_test_mesh(1, 1)
        t = time.perf_counter()
        flash = _flash_decode_check(dev, seed, trained["state"].model, mesh)
        log(f"  (B: {time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        dp = _dp_check(dev, seed, trained["state"], trained["tcfg"],
                       make_test_mesh(1, 1))
        log(f"  (C: {time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        seg = _segment_mesh_check(dev, segments, batches, mesh)
        log(f"  (D: {time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        eng = _placed_engine_check(dev, engine, batches)
        log(f"  (E: {time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        tp, _ = _tp_check(dev, seed, trained["state"], trained["tcfg"],
                          make_test_mesh(1, 1))
        log(f"  (F: {time.perf_counter() - t:.1f} s)")
        kinds = _tp_kinds_check(dev, seed, make_test_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    return dict(flash=flash, dp=dp, segments=seg, engine=eng, tp=tp,
                tp_kinds=kinds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    t_phase = [t_all]

    def phase(title):
        now = time.perf_counter()
        log(f"  ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now
        log(title)

    dev = torch.device("cuda")
    log("phase 1: card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" ({smi})")
    log("  allow_tf32: matmul False, cudnn False")

    phase("phase 2: build")
    secs = _build.build_all()
    log(f"  nvcc build {secs:.2f} s ({', '.join(_build.SOURCES)})")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase("phase 3: fused_hop kernel (f32) vs plain version, synthetic "
          "worlds")
    n_cases, syn_err = phase_synthetic(dev)
    log(f"  {n_cases} worlds bit-identical")
    phase("phase 3b: fused_hop kernel (sq8, pq) vs plain version, synthetic "
          "worlds")
    log(f"  {phase_quant_synthetic(dev)} cases bit-identical")
    phase("phase 3c: fused_topk_l2 kernel vs plain version")
    n_topk, topk_err = phase_topk_synthetic(dev)
    log(f"  {n_topk} cases bit-identical")
    phase("phase 3d: fused_hop paged mode vs plain version")
    n_paged, paged_err = phase_paged_synthetic(dev)
    log(f"  {n_paged} cases bit-identical")
    phase("phase 3e: scan and merge kernels vs plain versions")
    n_scan, scan_errs = phase_scan_synthetic(dev)
    log(f"  {n_scan} cases within their contracts")

    phase(f"phase 4: graph main path n={N} d=128")
    ctx = phase_main(dev, N, args.seed)
    q0 = ctx["batches"][0]

    phase("phase 6: phase split and kernel timing at the main path's shapes")
    entries = [time_hop(ctx["dqf"], q0, ctx["launches"], "graph, float32")]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], syn_err)

    phase("phase 7: mxu main path (hot_mode='mxu') on phase 4's index")
    mxu, topk_launches, _ = phase_mxu(ctx)
    batch_split(mxu, q0, "mxu, float32")
    topk = time_topk(mxu, q0, topk_launches)
    topk["max_abs_err"] = max(topk["max_abs_err"], topk_err)
    del mxu

    saved = {}                   # the indexes phase 12 loads, as arrays
    for mode in ("sq8", "pq"):
        phase(f"phase 8: quantized main path, {mode}, on phase 4's index")
        qdqf, launches, _ = phase_quant(ctx, mode, dev)
        entries.append(time_hop(qdqf, q0, launches, f"graph, {mode}"))
        saved[mode] = copy_arrays(qdqf)
        del qdqf
        torch.cuda.empty_cache()
    entries.append(topk)

    phase("phase 9: serving, fixed and paged engines, on phase 4's index")
    sdqf, served = phase_serving(ctx, dev, args.seed)
    paged_launches = served["closed loop, 4096 at once"]["paged"][1][
        "launches"]["fused_hop_paged"]
    entries.append(time_paged_hop(sdqf, q0, paged_launches, paged_err))
    del sdqf
    torch.cuda.empty_cache()

    phase("phase 10: scan and merge entry points on the main path's state")
    scan_entries, _ = phase_scan(ctx, dev, scan_errs)
    entries += scan_entries

    phase("phase 11: the mutable main path on phase 4's index (save, load, "
          "insert, delete, compact; both engines across the churn)")
    saved["f32"] = copy_arrays(ctx["dqf"])    # phase 11 mutates it
    mut = phase_mutation(ctx, dev, args.seed, n_delete=MUTATION_DELETES)
    by_name = {e["name"]: e for e in entries}
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "full_phase_ms", "full_phase_device_ms",
            "full_phase_bound_ms")
    by_name["fused_hop (f32)"]["mutation"] = dict(
        launches=mut["launches"][0],
        **{label: {key: e[key] for key in keys}
           for label, e in mut["hops"].items()})
    by_name["fused_hop_paged"]["mutation"] = {"launches":
                                              mut["launches"][1]}
    hop = by_name["fused_hop (f32)"]
    hop["max_abs_err"] = max([hop["max_abs_err"]] + [
        e["max_abs_err"] for e in mut["hops"].values()])

    phase("phase 12: the disk tier at the main path's size (sq8 at three "
          "cache sizes, f32, pq and mxu at 25%, both engines, mutation, "
          "chaos)")
    t12 = time.perf_counter()
    f32_arrays = {k: v.copy() for k, v in saved["f32"].items()}
    engine_arrays = {k: v.copy() for k, v in f32_arrays.items()}  # 20 E
    tier = phase_tier(ctx, dev, args.seed, saved)
    del saved
    by_name["fused_topk_l2"]["tier"] = {"launches":
                                        tier["mxu_0.25"]["launches"]}
    for name in ("fused_hop (f32)", "fused_hop (sq8)", "fused_hop (pq)",
                 "fused_hop_paged"):
        by_name[name]["tier"] = {"launches": 0, "note": "gated off on a "
                                 "tiered store (checked around every "
                                 "tiered batch)"}
    log(f"  phase 12: {time.perf_counter() - t12:.1f} s")

    phase("phase 13: ShardedDQF's read path at S = 1, 2, 4 on phase 4's "
          "rows (stacked vs oracle, launches, a lost shard, memory, recall)")
    t13 = time.perf_counter()
    runs, kept = phase_sharding(ctx, dev, f32_arrays)
    del f32_arrays
    for name, key, counter in (("pool_merge", "merge", "pool_merge"),
                               ("fused_hop (f32)", "hop", "fused_hop")):
        e = by_name[name]
        e["sharded"] = {
            "launches": {S: r["launches"][counter] for S, r in runs.items()},
            "stacked_batch_ms": {S: r["stacked_ms"]
                                 for S, r in runs.items()},
            **{f"S={S} {key}": r[key] for S, r in runs.items() if key in r}}
        e["max_abs_err"] = max([e["max_abs_err"]] + [
            r[key]["max_abs_err"] for r in runs.values() if key in r])
    log(f"  phase 13: {time.perf_counter() - t13:.1f} s")

    phase("phase 14: ShardedEngine on phase 13's S = 2 and 4 indexes "
          "(fixed fused and composed, paged, two tenants, chaos, churn with "
          "the rebalance, the kernels at the tick's shapes)")
    t14 = time.perf_counter()
    served = phase_sharded_engine(ctx, dev, kept, runs, args.seed)
    for name, key, engine, counter in (
            ("fused_hop (f32)", "hop", "fixed", "fused_hop"),
            ("fused_hop_paged", "paged_hop", "paged", "fused_hop_paged"),
            ("pool_merge", "merge", "fixed", "pool_merge")):
        e = by_name[name]
        e["sharded_engine"] = {
            "launches": {S: o["launches"][engine][counter]
                         for S, o in served.items()},
            "launches_note": f"the {engine} engine's closed loop of "
                             f"{ENGINE_TRAFFIC} "
                             "queries (every tick one launch"
                             + (", and one a refill's hot phase)"
                                if counter == "fused_hop" else ")"),
            **{f"S={S} {key}": o["kernels"][key]
               for S, o in served.items()}}
    log(f"  phase 14: {time.perf_counter() - t14:.1f} s")
    del kept, served
    torch.cuda.empty_cache()

    phase("phase 15: the kNN-LM serving path (Qwen3-0.6B at full width, "
          "bf16, decoding with DQF retrieval through fused_hop)")
    t15 = time.perf_counter()
    knn_entry, _ = phase_knnlm(dev, args.seed)
    entries.append(knn_entry)
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")

    phase("phase 16: the frozen segment index at 1M x 128, S = 4 segments "
          "as stacked lanes (stacked vs sequential oracle, launches, "
          "recall)")
    t16 = time.perf_counter()
    seg_entries, seg_summary = phase_segments(ctx, dev, args.seed)
    entries += seg_entries
    log(f"  phase 16: {time.perf_counter() - t16:.1f} s")

    phase("phase 17: a kNN-LM over DeepSeek-V2-Lite at full width (bf16, "
          "MoE and MLA, decoding with DQF retrieval through fused_hop)")
    t17 = time.perf_counter()
    ds_entry, _, ds_svc = phase_deepseek(dev, args.seed)
    entries.append(ds_entry)
    log(f"  phase 17: {time.perf_counter() - t17:.1f} s")

    phase("phase 18: the last block kinds at full width (a kNN-LM over "
          "xLSTM-1.3B on phase 17's datastore; Hymba-1.5B; "
          "Llama-3.2-Vision-11B with media)")
    t18 = time.perf_counter()
    xl_entry, _ = phase_blocks(dev, args.seed, ds_svc)
    entries.append(xl_entry)
    del ds_svc
    torch.cuda.empty_cache()
    log(f"  phase 18: {time.perf_counter() - t18:.1f} s")

    phase("phase 19: training at full width (Qwen3-0.6B, bf16, remat, "
          "microbatches 2, AdamW, async checkpoint and restore; float32 "
          "card vs CPU at 2 layers; the ten configs' train steps)")
    t19 = time.perf_counter()
    trained = phase_training(dev, args.seed)["full"]
    log(f"  phase 19: {time.perf_counter() - t19:.1f} s")

    phase("phase 20: the multi-rank code at world 1 over NCCL (flash "
          "decoding at full width, data-parallel steps, the segment search "
          "on a mesh, the engine over a placed index, tensor parallelism: "
          "the dense kinds, then MoE with expert parallelism, MLA, "
          "cross-attention, the hybrid and xLSTM kinds)")
    t20 = time.perf_counter()
    dist_out = phase_distributed(
        dev, args.seed, trained, seg_summary, ctx["batches"],
        dict(arrays=engine_arrays, cfg=ctx["cfg"], gt=ctx["gt"]))
    del trained, seg_summary, engine_arrays
    seg = dist_out["segments"]
    by_name = {e["name"]: e for e in entries}
    for name, counter, case in (
            ("fused_hop (f32)", "fused_hop", "fixed fused"),
            ("fused_hop_paged", "fused_hop_paged", "paged fused"),
            ("pool_merge", "pool_merge", "fixed fused")):
        run = dist_out["engine"][case]
        by_name[name]["placed_engine"] = {
            "launches": run["launches"][counter],
            "launches_note": "phase 20 E: ShardedEngine over phase 13's "
                             "S = 1 index placed on a one-rank mesh, "
                             f"{ENGINE_QUERIES} queries closed loop, "
                             f"{case}",
            "ms_a_tick": run["ms_tick"],
            "unplaced_ms_a_tick": run["unplaced_ms_tick"],
            "collectives": run["collectives"], "ticks": run["ticks"]}
    for name, key in (("fused_hop (f32, segment index)", "hop_launches"),
                      ("pool_merge (segment merge)", "merge_launches")):
        by_name[name]["distributed"] = {
            "launches": seg[key],
            "launches_note": "phase 20 D: the mesh path of sharded_search "
                             f"at world 1, {len(ctx['batches'])} batches "
                             "over segment 0",
            "ms_a_batch": seg["mesh_ms"]}
    torch.cuda.empty_cache()
    log(f"  phase 20: {time.perf_counter() - t20:.1f} s")

    phase("done")
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
