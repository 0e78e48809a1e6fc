#!/usr/bin/env python3
"""Chip smoke test of seismic_tpu_torch, the PyTorch / CUDA port, on one
NVIDIA card.

    python3 chip_smoke.py [--n-docs N]

`--n-docs` below 100,000 is a rehearsal at a cut corpus; the run says so
on its output. Batches and repetitions are fixed. The full record goes to
`chiprun_out/chip_smoke.json`.

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written CUDA kernels from `seismic_tpu_torch/csrc`
   (one nvcc per source, all started together);
2. hold K1-K3 against their plain PyTorch versions at the API path's
   shapes (K1 qloc + quantize, its f32 output and its row-major entry
   point: bit-exact; K2 grouped i8 scorer: exact int dots, 1e-6 relative;
   K3 fused rescore: 1e-5 relative), and time each beside its bound, its
   plain version and one library call;
3. drive the API path through the user's entry points:
   `SeismicIndexRaw.build_from_csr` on a 100K-doc synthetic SPLADE-like
   collection at dim 30522 with V=1024 local vocabularies, then
   `batch_search` of 4096 distinct queries (k=10, query_cut=14,
   heap_factor=0), with the kernel launch counts set to 0 just before and
   read just after; check the results (shapes, finite scores, exact
   rescored scores, recall@10 >= 0.9 on 256 queries against a brute-force
   sparse x dense product on the card);
4. drive the JAX repo's bench headline path (bench.py:514-669): the same
   corpus built with f32 values, narrowed to V=512 and uploaded with
   csub 2; 16,384 distinct queries padded to 64 terms. The derived plan
   must equal the C++ host plan on every batch (and both searches agree);
   at B=4096/M=8 and B=16384/M=16, on the path's own inputs, K1 must equal
   its plain version bit for bit in all three entry points, K4 exactly in
   its int dots and to 1e-6 relative (timed beside `torch._int_mm`), and K3
   (on the pool's candidates) to 1e-5 relative, each timed beside its
   bound; then QPS at B=4096/M=8 (`plan_caps` +
   `search_grouped_derive` per batch, 5 x 4 batches, one synchronise) and
   at B=16384/M=16 (5 calls), with the launch counts set to 0 before and
   read after (K1, K4, K3 > 0, the other six 0); p50 of a synchronised B=4096
   call; one call under `torch.cuda.set_sync_debug_mode("error")`;
   recall@10 >= 0.95 over all 16,384 queries and every score exact; a
   torch.profiler breakdown of one B=16384 call;
5. drive the engine path on phase 3's index (it runs right after phase 3,
   before that index is freed): `SeismicIndexRaw.batch_search` of the
   same 4096 queries with `heap_factor=0.8` (block-pruned tiles mode, the
   API's default block budget), launch counts set to 0 before and read
   after (K7 once per batch; every other kernel never). K7, the tile
   scorer (pairs grouped by list), must equal its plain version to 1e-5
   relative on the rows inside each list at the path's own inputs, timed
   beside its bounds, with its groups and their subtile reads;
   on 256 queries the program on the kernel and on the plain scorer must
   agree (id sets on >= 98% of queries, scores to 1e-5 relative); one
   batch with `doc_mode="rescore"` through `search_batch` launches K3 and
   every score must be the exact dot (1e-5 relative, against a brute-force
   product of the index's own forward rows on the card), and K3 on one of
   its chunks is timed beside its bound there; recall@10 at the
   default budget and at `block_budget=512`; QPS over 5 warm batches, p50,
   and a breakdown with idle share, GC time, enqueue time and the host
   synchronisations of the device program (more than one fails).

6. drive the remaining grouped-search modes on phase 4's index (it runs
   inside phase 4, before that index is freed) with B=4096, M=8,
   query_cut=14 through `plan_caps` + `search_grouped_derive`, the launch
   counts set to 0 before each batch and read after: the on-device gate's
   configuration (f32 scorer, exact pool, whole-pool overflow correction)
   and a default-constructed `GroupedParams` (bf16, approx, ovf_pool 64),
   K6 once per batch and K2 = K4 = 0, the gate configuration also on K6's
   plain version (id sets >= 98%, scores 1e-4); `pool_mode="stride"` on
   the int8 scorers (K4 + K5, and K2 at csub 2 + K5) and
   `pool_mode="window"` on bf16 (K6 + K5) with rescore 64, every score the
   exact dot; `qloc_mode="rowmajor"` (K8 once, K1 never, results equal to
   the lane-major run's); a second upload with `vocab_residue=8` (K9 once,
   K1 never, recall@10 within 0.03 of the unpermuted run; K9's time beside
   K1's on the same pairs, its bound the bytes, its ptxas lines, the
   batch's device time by kernel). K6's route per mode is read from the
   SASS of its kernels (`cuobjdump -sass`: the run
   fails if the bf16 kernel holds no bf16 HMMA), with their ptxas lines,
   and its f32 mode's bound follows that route. K5 inside K2,
   K4 and K6, K6 (bf16 / f32, centred / fixup), K8 and K9 are held against
   their plain versions at these shapes and timed beside their bounds;
   recall@10 floors per mode; one breakdown (idle share, enqueue, syncs)
   of the default configuration.
7. drive the device probe (`python -m seismic_tpu_torch.harness.
   device_probe`'s entry point `run`) on the card: every probe at the JAX
   probe's own sizes, each of K10-K18 held against its plain version and
   the probe's numpy expectation (gathers bit-exact; compare scores 1e-5
   of sum_w |vals * qmatch| + 1e-6 a row; products 1e-6 of sum_k |a * b|
   of an f64 product), timed as the mean of 200 back-to-back calls beside
   its bound, its plain version and its library call, with its device
   time per call (calls queued behind a held stream, with L2 warm, flushed
   by a write and flushed by a read); the launch counts set to 0 before
   and read after (each of K10-K18 exactly once per check, timed and
   device-timed call, every other kernel never); the launch floor (an empty kernel, timed both
   ways); K17's route from the SASS of its kernel (the run fails if it
   holds no HMMA.16816.F32.BF16), with its ptxas lines and its error as a
   share of the tolerance; the ptxas lines of K10, of K12 / K16's one
   kernel (`compare_lookup_kernel`) and of K13's and K14's kernels (the
   run fails if either is missing or spills); the run fails if any device
   time of K10-K18 or of its library call reads under the empty kernel's
   device time; K11 / K15's one kernel (`row_gather_kernel`, a warp a
   row): its ptxas lines (a spill fails), then `harness/
   row_gather_probe.py` on the probe's operands, outside the counted
   window: both entry points bit-exact against the plain version on
   every row set (a mismatch fails), device times warm / write- /
   read-flushed over 9 window pairs in turns with `index_select` and the
   empty kernel, and the diagnostics (one 8 MB span, sorted rows, R 1024
   / 4096 / 16,384), logged with the card and its power limit; then the
   microbench once
   (`harness/microbench.py`).
8. drive the k-NN graph, kNN refinement, exact search and the user API:
   (a) on phase 3's index (after phase 5) `SeismicIndexRaw.build_knn(16)`
   in self-search batches of 4096 (K7 once a batch, every other kernel
   never), wall and device time; the graph int32 [n_docs, 16], no row
   holding its own id or a repeated one, -1 only at a row's end, 256
   sampled rows equal to a fresh self-search as id sets, the
   `save_knn` -> `load_knn` round trip equal, and its recall@16 against
   `exact_search` on the sample printed; (b) `batch_search(n_knn=16,
   heap_factor=0)` of phase 3's queries on the grouped route (K1, K2, K3
   launched, K3 more often than in phase 3's window, K7 never), every
   score the exact dot, recall@10 no more than 0.005 under phase 3's;
   (e) the corpus written as JSONL (ids d<i>, tokens t<c>, contents) to
   a temporary directory, read back into phase 3's CSR, indexed by
   `SeismicIndex.build` into phase 3's arrays, searched with the queries
   as token strings at heap_factor 0 and 0.7, every result equal to
   `SeismicIndexRaw`'s, `get_doc_text` returning the contents; then, on
   phase 4's index carrying (a)'s graph (inside phase 4, before phase 6),
   (d) `exact_search` of the 16,384 queries (its stream branch) held
   against phase 4's sparse product (scores to 1e-5, ids equal where the
   scores do not tie within 1e-6), timed; (c) the headline program with
   `n_knn=16` at B=16384 / M=16 (K1, K4, K3 launched, every other kernel
   never): recall@10 against (d) beside the same call without it, every
   score exact, one call under `set_sync_debug_mode("error")`, five timed
   calls of each and their device time by kernel.
9. drive `SeismicIndexDotVByte` (inside phase 8, while (e)'s JSONL
   exists): `SeismicIndexDotVByte.build` of that JSONL at the cells'
   layout (u8 forward values, no doc tiles), (a)'s graph read by
   `load_knn`, the block view (dense block summaries narrowed to V=512,
   members ordered by value) and the engine copy uploaded in the lean
   forward form (neither holds fused rows or int32 forward ids, or the
   run fails), and `batch_search` of phase 3's 4096 queries as token
   strings (k=10, query_cut=14): K3's u8 form held against its plain
   version on one batch's own expanded candidates in both contracts, ids
   clamped and out-of-range ids skipped as the block-pool tail asks (-inf
   at the same places, 1e-5 relative, exactly 0 where the plain score is
   0), each timed beside its bounds, with the readings inside it
   (`harness/k3u8_probe.py::inside`: every id on one document, the share
   of in-range slots repeating a document of their query's row), its
   ptxas lines (two load variants x two contracts; a spill fails), with
   its recall@10 figures held within 0.002 of the recorded ones on the
   full corpus; the block-pool route at heap_factor 0.7 (5
   timed batches: QPS, p50; K1, K2 and K3-u8 launched, K7 never), the
   same queries with `block_budget=512` (the engine's rescore mode: K3-u8
   launched; and at the default budget, 64) and the block route with `n_knn=16` (K3-u8 more often than a
   batch without); every score the exact dot of the document's decoded
   u8 row (1e-5), the block route's top-10 sharing >= 90% of its entries
   with the engine's at 512, refinement lowering no 10th score; recall@10 of each
   against phase 3's product, the device bytes beside phase 3's index,
   and a breakdown of one block-route batch (host stages, device busy
   time by kernel, idle share), and K3-u8's device time in profiler
   windows of that batch, of the engine at budget 512 and of the n_knn
   batch.
10. drive the rest of the grouped search: (a-d) inside phase 4 on its
   index and queries, after phase 6: (a) hashed tiles, V=1024
   (`hash_retile_torch` on the card, bit-equal to the NumPy `hash_retile`
   on the first and last 65536 posting rows, timed; the upload with
   `tile_hash`, no vocabulary): K1's hashed call bit-exact against its
   plain version in its three entry points on the B=4096 batch's own
   operands (one vocab row arange(V), the terms hashed mod V), the
   headline program at B=4096/M=8 and B=16384/M=16 on the derived plan
   (K1, K4, K3 launched, every other kernel never), every score exact,
   the kernel path against the plain-scorer path on 256 queries (id sets
   >= 98%), recall@10 beside phase 4's, a B=16384 call's device time by
   kernel, the device bytes; (b) the streaming budget on phase 4's index
   uploaded with `super_summaries=True` (its bounds equal the same
   function's on the CPU on 1024 super-tiles): stream_frac 0.75 and 0.5
   at B=4096 on the slot-major K2 (K1, K2, K3 launched), the work items
   the scorer is given counted (max(128, round(frac * W_cap))), no
   returned id outside a scored super-tile's postings, every score exact,
   recall@10 beside stream_frac 1, busy time; (c) the weighted cut:
   `plan_caps(weighted=True)` equal to the host planner's caps on the
   weighted values, whose G / W equal the derived plan's, one B=4096
   batch (K1, K4, K3), exact scores, recall beside unweighted; (d)
   `return_margin` at B=4096 (diag [B, 5], column 0 the 10th score) and
   `search_batch_twopass`: every query flagged equals the deep pass
   alone (pool 256, rescore 128, query_cut 20), none flagged equals pass
   1, and at the default eps_rel the flagged share, wall time, exact
   scores and recall; (e, f) inside phase 9, on its arrays and queries:
   (e) `SeismicIndexDotVByte` without dense summaries (the hashed block
   view, V=512) through `batch_search` at heap_factor 0.7 (K1, K2, K3-u8
   launched, K7 never), every score the exact dot of the decoded u8 row,
   recall@10 beside the dense route's, QPS, p50, busy time, device bytes;
   (f) phase 9's dense block view bin-packed (`pack_bins=True`): the
   block route's ids equal the unpacked view's on the 4096 queries
   (scores to 1e-5), the aligned rows' device bytes beside the unpacked
   ones, busy time of both.
11. drive the forward-row and vocabulary forms, the sketch ranking,
   `convert` and `FlatTermIndex`: (a) inside phase 4, after phase 10, its
   forward rows uploaded again half-width (`types.py::fused16_rows`, the
   rows of `to_device(fwd_f16=True)`; the rest shared), the headline at
   B=4096/M=8 and B=16384/M=16 (K1, K4, K3-f16 launched, the fused K3
   never), K3-f16 against its plain version on the path's own operands at
   both shapes (1e-5), every score the exact dot of the f16-rounded row,
   recall@10 beside phase 4's, busy and K3 device ms; (c) after phase 5 on
   its index, block sketches made from the index's CSR summaries as the
   NumPy build path makes them (the native build keeps none) on the device
   copy, and the engine at heap_factor 0.8 in gather doc mode with
   `block_mode="sketch"` and with `cand_budget` 256 and 1024: no hand
   kernel, no host sync (one fails), every score exact, recall@10 on 256
   queries recorded with no floor, the sketch products' device ms; (b, e)
   after phase 9 on phase 3's corpus: `convert("u8")`, `convert("u16")`
   and `convert("f16")` of a second instance over phase 3's arrays, each
   on the 4096 queries at heap_factor 0 (K3-u8, K3-u16, K3 fused), every
   score the exact dot of the decoded row, the lean forms against their
   plain versions on the path's operands, recall@10 beside phase 3's,
   device bytes; `FlatTermIndex` of the corpus (3.05 GB u8) on 256
   queries: top-10 agreement with `exact_search` >= 0.9 and scores within
   2% of the exact dots (u8 quantization), wall time; (d) last, every
   earlier index freed: `SeismicIndexRawLV.build_from_csr` on
   `synth_dataset(2_000, dim=250_002, seed=7)` (the corpus cut to 2% to
   fit the time limit; XLM-RoBERTa's vocabulary, BGE-M3's sparse
   head) at the API cell's pruning and layout with
   summary_vocab_cap 512, its bytes printed first; 4096 queries at
   heap_factor 0 (K1 on the int32 vocabulary, K2, K3), K1 and K8 on int32
   rows bit-exact against their plain versions on the route's operands,
   the row-major projection's batch (K8 on int32 rows) equal to the
   lane-major one, every score exact, the kernel path against the
   plain-scorer path on 256 queries (id sets >= 98%), recall@10 against a
   brute-force product; the same arrays uploaded with `vocab_residue=8`
   (the other uploads freed first) and the batch through K9 on the int32
   vocabulary (window `lv_residue`): K9-int32 bit-exact against its plain
   version on the batch's operands, timed beside its bound and K1-int32,
   its ptxas report, every score exact, recall@10 beside the plain
   upload's; `convert("u8")` and the same batch (K3 on int32
   ids beside u8 codes, against its plain version); one engine batch at
   heap_factor 0.8 (K7). Every rescore_lean_kernel instance's ptxas report
   (twenty: five forms x two load variants x two contracts) is read in
   phase 9; a spill fails. Phase 4 also caches its aligned tile layout
   (`ops/tiles_prep.py::load_or_build_aligned`, after phase 11a) beside
   the index saved in a temporary directory: the first call (build and
   write) and the second (memory-mapped) timed, the bytes written, an
   upload from the cache (`to_device(aligned=...)`) equal to the plain
   upload, and one B=4096 call on it equal to the plain upload's bit for
   bit; the directory is removed;
12. document-sharded search (`parallel/`), right after phase 3's index is
   freed, on phase 3's corpus and 4096 queries padded as the API pads
   them, meshes of `cuda:i % count` (one card holds every shard, four
   cards one each): (a) `ShardedIndex.build` into 4 shards at the API
   cell's layout (f16 values, V=1024, csub 1; each shard keeps a quarter
   of the cell's list budget, 50 postings a term, so the shards hold as
   many postings as phase 3's index), the grouped route at
   heap_factor 0 with the API's `GroupedParams` (K1, K2, K3; window
   `sharded`): recall@10 on 256 queries no more than 0.005 under phase
   3's, the merge equal to a host lexsort of the shards' results bit for
   bit, mesh 2x4 (the same shards, the batch split over "data") equal to
   mesh 1x4 bit for bit, `save` / `load` with identical ids and scores,
   each shard's bytes on the card; (b) the engine route at
   heap_factor 0.8 with phase 5's parameters (tiles mode, K7), recall@10
   beside phase 5's; (d) `init_distributed` as an NCCL group of one
   (a free local port) and (a)'s 1x4 batch through the cross-process
   merge, equal to the in-process merge; (c) a u8 build of the first
   5,000 documents into 4 shards (a cut that keeps the script in its
   time limit), the block view (`tile_block=512`, `block_expand=32`,
   K3-u8), recall@10 beside phase 9's; (e)
   `harness/dryrun.py::dryrun_multichip(4)`, its
   four `ok` lines (widths 128, as JAX's); the phase's wall time, and
   (a)'s batch time over phase 3's for the record only (shards on one
   card run in turn).
13. the CLI and the experiment harness, right after phase 12 (phase 3's
   corpus still in memory), in a temporary directory, every step through
   its module's `main(argv)` and timed: (a) `harness/export_synth.py`
   writes the corpus (read from its cache, where this run puts it) and
   2048 queries as `.bin` files (documents.bin read back equal to the
   corpus) with the exact top-10 ground truth; (b)
   `harness/run_experiments.py` on `experiments/best_configs_synth/
   recall_97.toml`, its [folder] moved into the directory: the build CLI
   (f32, 200 postings, V 1024), the perf CLI on the grouped route (query
   cut 11, B 2048; K1, K2 at csub 2, K3 launched, K7 never),
   accuracy@10 >= 0.962 (JAX's v5e record 0.9721 less 0.01) and every
   run-file score the f32 exact dot to 1e-3 relative; (c)
   `harness/bench_knn.py` builds the graph of that index (nknn 8, K7) and
   runs its ladder, then `recall_98.toml` with `knn-path` pointed at the
   graph: the index reused (build_secs 0), K3 launched more often than in
   (b), accuracy@10 >= 0.97 (0.9803 less 0.01), scores exact; (e)
   `harness/run_grid_search.py` on a grid of one indexing combination x
   query cuts 10 and 11 over the first 5,000 documents at
   summary-vocab-cap 128 (exported by `export_synth` from a cache of the
   cut; the grouped route at V 128), run twice: the second launches
   no kernel and rewrites no report; `harness/best_configs.py` over its
   root; (d) the perf CLI's engine route on the grid's index at
   heap_factor 0.7 with block budget 64 (K7; the perf CLI has no rescore
   doc mode, so K3 never launches there), accuracy@10 recorded; (f) the
   first 2,000 documents written as phase 8e's JSONL and phase 3's 4096
   queries as token strings: `cli/convert_json_to_inner_format.py`
   (documents.bin mapped back through its token map equal to the cut's
   CSR), `cli/build_enhanced_inverted_index.py` and `cli/
   perf_enhanced_inverted_index.py` at heap_factor 0.7 (K7), its run file
   equal line for line to `SeismicIndex.load(...).batch_search`; (g)
   `harness/profile_stages.py --both` on the grid's index (each form's
   final top-k equal to the engine program's; K3 and K7) and
   `harness/bench_mem.py --block` at the cut (K1, K4, K3-u8), its record
   in `chiprun_out/mem_bench.json`.
6b. (inside phase 4, after phase 11a) the headline index narrowed to V 384
   and then 128 (`narrow_vocab`), each uploaded with csub 2: one B=4096 /
   M=8 batch on the derived plan with the headline parameters (K1, K4,
   K3), with kernel_unroll 1 (K2) and with `GroupedParams(pool=128)` (K1,
   K6 bf16), each in a counted window with recall@10 on 256 queries and,
   for the int8 ones, every score the exact dot; K4, K2 and K6 against
   their plain versions on the batch's operands (int dots exact and 1e-6;
   K6 1e-5 of the larger of score and centring term), timed beside their
   bounds and a library product, with the ptxas lines of the instances
   that take V at run time (K4: kV = 0; K2 and K6 have only those). The
   `kernels` line carries these six as
   `<name>@V384` / `<name>@V128`, with the launches of their windows.
14. (inside phase 4, after its aligned-tile cache) the probe drivers of
   `seismic_tpu_torch/harness/`, each through its `main(argv)` on the
   card, on a cache in a temporary directory that phases 3 / 4 fill under
   the drivers' file names (the corpus, the f32 v1024 index, its `_nw512`
   dir with its aligned layout, the ground truth of the 16,384 protocol
   queries) with the knn16 graph that rebuild_r3_cache makes (the
   engine's self-search on a csub-1 upload, K7, in a counted window): (b)
   the queue script (`run_r5_queue.sh`) with stages `c100k`
   (rebuild_r3_cache making a cache of its own at a cut: 2,000 docs, the
   stream's first 2048 queries) and `r5b_grid2`, both logged OK, its
   record moved beside its logs; (c) `probe_r5b` at full size with every
   family in this process, m32 and csub4 in counted windows of their own:
   38 rungs recorded, each rung whose label JAX's record
   (`BENCH_STAGE_r5.json`) holds with a recall at least that recall less
   0.01 (`R5B_JAX_RECALL`), K4 launched at M 32 and at csub 4, K5 in the
   csub-4 stride rung, K2 in `b1_exact_ddpost_u1`, K8 in the rowmajor
   rung, and the base rung's ids equal to a direct
   `search_grouped_derive` call's on phase 4's index; (d) `scorer_forms`
   (phase 6b's checks) at M 32 on phase 4's index and at M 16 on the
   same arrays uploaded with csub 4: K4, K2 and K6 against their plain
   versions on the path's operands, timed beside their bounds and a
   library product, with their instances' ptxas lines; the `kernels` line
   carries them as `<name>@M32` / `<name>@csub4`; (e) `probe_r5c` at its
   cut (the 1M recipe at 2,000 documents through `rebuild_r3_cache 1m
   --n-docs`, width 512): the lever family, then lean16 with
   `R5C_FWD16=1` (K3's f16 form); (f) `probe_r3j` at its cut
   (`build_88m` at 5,000 documents): the streaming ground truth, the
   block view, eight rungs (K1, the int8 scorer, K3-u8); (g)
   `sweep_configs` on the v1024 index with the graph of (a): 12
   directories named as `experiments/grid_synth/`'s. Records land in
   `chiprun_out/` (`bench_stage_r5.json`, `scale_bench.json`,
   `scale88_bench.json`, `grid_synth/`, `r5queue/`); the JAX records at
   the repo root must be unchanged after the phase.

Every profiler window (phases 3-10) is taken after one warm-up call of
what it profiles and is read only where it holds that phase's hand
kernels (K1-K3 for the API, K1 / K4 / K3 for the headline, K7 for the
engine and the graph, K6 for the modes' defaults batch and K4 for its
residue batch, K3 for phase 8c, K1 / K2 / K3-u8 for phase 9; up to three
windows): where none holds them, the busy time and the idle share are
recorded as null.

Every one of these windows sets the twenty-five launch counts (the
nineteen wrappers, and the phase 11 forms' own counts in the wrappers of
K1, K3, K8 and K9) to 0 and reads them all, and fails on a kernel that launched where it
should not; the kernels' record takes `launches` (the kernel's own main
path) and `launches_api` / `_engine` / `_headline` / `_modes` / `_probe` /
`_knn_graph` / `_knn` / `_api_classes` / `_dotvbyte` / `_dotvbyte_engine`
/ `_dotvbyte_knn` / `_knn_headline` / `_hashed` / `_stream_75` /
`_stream_50` / `_weighted` / `_margin` / `_twopass` / `_dotvbyte_hashed` /
`_packed` / `_fwd16` / `_convert_*` / `_sketch_*` / `_flat` / `_lv*` /
`_sharded*` from those readings.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 and bf16
# tensor-core ops/s, f32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

K, QUERY_CUT, V_CAP, DIM = 10, 14, 1024, 30522
N_DOCS, BATCH, REPS = 100_000, 4096, 5
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


_GC = {"ms": 0.0, "start": None}


def _gc_callback(phase, info):
    if phase == "start":
        _GC["start"] = time.perf_counter()
    elif _GC["start"] is not None:
        _GC["ms"] += (time.perf_counter() - _GC["start"]) * 1e3
        _GC["start"] = None


def gc_ms() -> float:
    """Host ms spent in Python's garbage collector since main() began
    (each host-clock window below reports its share)."""
    return _GC["ms"]


def device_allocs() -> int:
    """Device allocations the caching allocator has made (cudaMalloc
    calls) since the run began."""
    import torch

    return int(torch.cuda.memory_stats().get("num_device_alloc", -1))


def bound(nbytes: float, nops: float, op_peak: float):
    """(bound_ms, bound_by): the larger of the bytes and the ops times."""
    tb, to = nbytes / PEAK_BYTES, nops / op_peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ptxas_of(lib: str, needle: str) -> dict:
    """{kernel instance: its `-Xptxas -v` lines (spills, registers, shared
    memory)} of the entry functions of kernel library `lib` whose mangled
    names hold `needle`, from phase 1's build."""
    from seismic_tpu_torch.ops import _cuda

    return _cuda.ptxas_lines(_cuda.ptxas_report.get(lib, ""), needle)


# one SASS instruction line of `cuobjdump -sass`: its opcode, after an
# optional predicate
SASS_OP = re.compile(
    r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_of(lib: str):
    """{kernel function: {opcode: static count}} of kernel library `lib`
    as phase 1 built it, from `cuobjdump -sass`; None where the toolkit
    has no cuobjdump."""
    from seismic_tpu_torch.ops import _cuda

    exe = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", _cuda.lib_path(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, ops = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            ops = out.setdefault(line.split("Function : ")[1].strip(), {})
            continue
        m = SASS_OP.match(line)
        if m and ops is not None:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return out


# the twenty-five kernel wrappers' counts, in the order of the `kernels`
# line: K1-K9 each with a module of its own, K10-K18 in
# `ops/probe_kernels.py`, then K3's u8 form (its own count in
# `ops/rescore.py`), then the forms of phase 11: K3 on half-width rows, on
# u16 codes and on int32 ids, K1, K8 and K9 on int32 vocabularies (each a
# count of its own in its module)
COUNTED = ("qloc", "score_grouped_i8", "rescore", "score_grouped_i8_item",
           "score_tiles", "pack_epilogue", "score_grouped_f", "qloc_rowmajor",
           "qloc_residue", "table_take", "row_gather", "compare_intersect",
           "u8_matvec", "take_along_axis", "flat_row_gather",
           "compare_term_loop", "i8_matmul", "tile_matvec", "rescore_u8",
           "rescore_f16", "rescore_u16", "rescore_i32", "qloc_i32",
           "qloc_rowmajor_i32", "qloc_residue_i32")
# K3-u8's instances of the lean kernel template, by their mangled names
# (rescore.cu: rescore_lean_kernel<Form<false, Val::kU8, 4>, ...>)
U8_FORM_MANGLED = "rescore_lean_kernelINS_4FormILb0ELNS_3ValE0E"
# the phase 11 forms, each with its count in the module of row 1, 3 or 8
FORM_COUNTS = {"rescore_f16": ("rescore", "launches_f16"),
               "rescore_u16": ("rescore", "launches_u16"),
               "rescore_i32": ("rescore", "launches_i32"),
               "qloc_i32": ("qloc", "launches_i32"),
               "qloc_rowmajor_i32": ("qloc_rowmajor", "launches_i32"),
               "qloc_residue_i32": ("qloc_residue", "launches_i32")}
PROBE_KERNELS = COUNTED[9:18]


def _counted_modules() -> dict:
    """{wrapper: (module, name of its count)} of K1-K9, K3's u8 form and
    the phase 11 forms."""
    import importlib

    from seismic_tpu_torch import ops

    files = dict(zip(COUNTED[:9], (
        "qloc", "grouped_scorer", "rescore", "grouped_scorer_item",
        "tiles_scorer", "pack_epilogue", "grouped_scorer_f", "qloc_rowmajor",
        "qloc_residue")))
    out = {n_: (importlib.import_module(f"{ops.__name__}.{f_}"), "launches")
           for n_, f_ in files.items()}
    out["rescore_u8"] = (out["rescore"][0], "launches_u8")
    for n_, (row, attr) in FORM_COUNTS.items():
        out[n_] = (out[row][0], attr)
    return out


def zero_launches():
    """Set every kernel wrapper's launch count to 0."""
    from seismic_tpu_torch.ops import probe_kernels

    for m, attr in _counted_modules().values():
        setattr(m, attr, 0)
    probe_kernels.launches.update(dict.fromkeys(PROBE_KERNELS, 0))


def read_launches() -> dict:
    """Every kernel wrapper's launch count since `zero_launches`, in the
    order of COUNTED."""
    from seismic_tpu_torch.ops import probe_kernels

    mods = _counted_modules()
    return {n_: (getattr(*mods[n_]) if n_ in mods
                 else probe_kernels.launches[n_]) for n_ in COUNTED}


def hold_launches(what: str, counts: dict, positive=(), exact=None) -> dict:
    """Fail unless the kernels named in `positive` launched, those in
    `exact` launched exactly that often, and every other one never."""
    exact = exact or {}
    for n_, c in counts.items():
        ok = (c > 0 if n_ in positive else c == exact.get(n_, 0))
        if not ok:
            fail(f"{what} launches {counts}: expected > 0 of "
                 f"{sorted(positive)}, exactly {exact}, 0 of every other")
    return counts


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_k1(a1, tag: str, reps: int = 20):
    """Hold K1's three entry points bit-exact against their plain versions
    on a1 = (vocab16, pair_list, top_c, top_v, QC): the quantize, the f32
    output, and the row-major form (K8's entry point) on the pairs' own
    rows, which must also give the quantize's codes; time the quantize and
    the f32 output beside the bounds. Returns (record, K1's int8
    projections)."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import qloc, qloc_rowmajor

    vocab16, pair_list, top_c, top_v, QC = a1
    k_i8, k_sc = qloc.project_qloc_quantize(*a1)
    p_i8, p_sc = qloc.project_qloc_quantize_plain(*a1)
    if not (torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)):
        fail(f"K1 ({tag}) disagrees: {(k_i8 != p_i8).sum().item()} i8 and "
             f"{(k_sc != p_sc).sum().item()} scale mismatches")
    del p_i8, p_sc
    if not torch.equal(qloc.project_qloc_f32(*a1),
                       qloc.project_qloc_plain(*a1)):
        fail(f"K1's f32 output ({tag}) disagrees with its plain version")
    a8 = (vocab16[pair_list.long()], top_c.repeat_interleave(QC, dim=0),
          top_v.repeat_interleave(QC, dim=0))
    r_i8, r_sc = qloc_rowmajor.project_qloc_rowmajor(*a8)
    rp_i8, rp_sc = qloc_rowmajor.project_qloc_rowmajor_plain(*a8)
    if not (torch.equal(r_i8, rp_i8) and torch.equal(r_sc, rp_sc)
            and torch.equal(r_i8, k_i8) and torch.equal(r_sc, k_sc)):
        fail(f"K1's row-major entry point ({tag}) disagrees with its plain "
             "version or with the quantize's codes")
    del a8, r_i8, r_sc, rp_i8, rp_sc
    P, V = pair_list.numel(), vocab16.shape[1]
    n_terms = (top_c != int(PAD_COMPONENT)).sum(1)  # [B] real terms
    # bytes: each distinct vocab row once, the pair list, the terms, the
    # int8 output and the scales; operations: one lookup a slot (the
    # former design's compare of every slot with every term beside it)
    nbytes = (torch.unique(pair_list).numel() * V * vocab16.element_size()
              + P * 4
              + top_c.numel() * 8 + P * V + P * 4)
    b, bb = bound(nbytes, float(P * V), PEAK_F32)
    compare_ops = 2.0 * V * QC * float(n_terms.sum().item())
    rec = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: qloc.project_qloc_quantize(*a1), reps),
        plain_ms=time_ms(lambda: qloc.project_qloc_quantize_plain(*a1), 3),
        bound_ms=b, bound_by=bb, library_ms=None,
        compare_bound_ms=compare_ops / PEAK_F32 * 1e3,
        f32_output_ms=time_ms(lambda: qloc.project_qloc_f32(*a1), reps),
        P=P, V=V, bytes=nbytes)
    return rec, k_i8


def k3_bounds(a3) -> dict:
    """K3's bounds on a3 = (fwd_fused, ids, qc, qv, n_docs). `bound_ms`:
    the bytes the function must move (each distinct row's real entries,
    4-byte id + 4-byte value, each run rounded up to 32-byte sectors; the
    ids, the query terms and the output) against one lookup and one
    multiply-add a real entry of every candidate row at the f32 rate;
    `compare_bound_ms`: the former design's compare of every real entry
    with every query term; `bound_as_scheduled_ms`: the bytes with every
    candidate row's real entries read once (no reuse across the L2)."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT

    fwd_fused, ids, qc = a3[:3]
    W2 = fwd_fused.shape[1]
    safe = ids.long().clamp(0, fwd_fused.shape[0] - 1)
    n_terms = (qc != int(PAD_COMPONENT)).sum(1)  # [B] real terms

    def sector_bytes(nnz):  # ids and values, each in 32-byte sectors
        return 2 * int(((nnz * 4 + 31) // 32 * 32).sum().item())

    uniq_nnz = (fwd_fused[torch.unique(safe), : W2 // 2]
                != int(PAD_COMPONENT)).sum(-1)
    row_nnz = (fwd_fused[safe, : W2 // 2]
               != int(PAD_COMPONENT)).sum(-1)  # [B, R]
    other = ids.numel() * 4 + qc.numel() * 8 + ids.numel() * 4
    nbytes = sector_bytes(uniq_nnz) + other
    sched = sector_bytes(row_nnz) + other
    b, bb = bound(nbytes, 2.0 * float(row_nnz.sum().item()), PEAK_F32)
    compare_ops = float((row_nnz * (2 * n_terms[:, None] + 2)).sum().item())
    return dict(bound_ms=b, bound_by=bb,
                compare_bound_ms=compare_ops / PEAK_F32 * 1e3,
                bound_as_scheduled_ms=sched / PEAK_BYTES * 1e3,
                bytes=nbytes, bytes_as_scheduled=sched)


def check_k3(a3, tag: str, reps: int = 20) -> dict:
    """Hold K3 (fused rescore) against its plain version at 1e-5 relative
    on a3 = (fwd_fused, ids, qc, qv, n_docs) and time both beside its
    bounds."""
    from seismic_tpu_torch.ops import rescore

    ids = a3[1]
    k3 = rescore.score_docs_rowmajor(*a3)
    p3 = rescore.score_docs_rowmajor_plain(*a3)
    rel = ((k3 - p3).abs() / p3.abs().clamp_min(1e-30)).max().item()
    if not rel <= 1e-5:
        fail(f"K3 ({tag}) disagrees: max relative error {rel}")
    return dict(
        max_abs_err=float((k3 - p3).abs().max().item()), max_rel_err=rel,
        ms=time_ms(lambda: rescore.score_docs_rowmajor(*a3), reps),
        plain_ms=time_ms(lambda: rescore.score_docs_rowmajor_plain(*a3), 3),
        library_ms=None, B=ids.shape[0], R=ids.shape[1], **k3_bounds(a3))


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def breakdown(index, qcomps, qvals, dev) -> dict:
    """Where one batch's time goes: the API's host stages on the host
    clock (each device stage ends in a synchronize), and the device
    program's kernels by name from a torch.profiler window. Informational:
    a profiler that records no device time leaves "not measured"."""
    import torch

    from seismic_tpu_torch.api import DEFAULT_QUERY_PAD, route_params
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl
    from seismic_tpu_torch.search.planner import plan_grouped

    dindex = index.device_index()
    params = route_params(K)
    g0 = gc_ms()
    t = [time.perf_counter()]
    q_comps, q_vals = pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    t.append(time.perf_counter())
    plan = plan_grouped(q_comps, q_vals, index._grouped_ctx(), QUERY_CUT)
    t.append(time.perf_counter())
    args = (dindex, DevicePlan.put(plan, dev),
            torch.from_numpy(q_comps).to(dev),
            torch.from_numpy(q_vals).to(dev), params)
    torch.cuda.synchronize()
    # the device program's own host-side costs: enqueue time, garbage
    # collections and fresh device allocations (cudaMalloc) inside it
    g_prog, n_alloc = gc_ms(), device_allocs()
    t.append(time.perf_counter())
    scores, ids = _grouped_impl(*args)
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    prog = dict(enqueue_ms=(t_enq - t[3]) * 1e3, gc_ms=gc_ms() - g_prog,
                cuda_mallocs=device_allocs() - n_alloc)
    scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
    t.append(time.perf_counter())
    out = {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(
        ("pad_queries_ms", "plan_ms", "upload_ms", "device_program_ms",
         "download_ms"))}
    out.update(gc_ms=gc_ms() - g0, device_program=prog)
    try:
        prof, _ = profile_held(lambda: _grouped_impl(*args), (
            "qloc_kernel", "score_grouped_i8_kernel", "rescore_fused_kernel"))
        out.update(prof, device_idle_share=idle_share(
            prof["device_busy_ms"], out["device_program_ms"]))
    except NoProfile as e:  # informational only
        out["profile"] = f"not measured: {e}"
    return out


def synth_queries_distinct(n: int):
    """`n` distinct queries: fresh seed per 1024 (seeds 11, 12, ...)."""
    from seismic_tpu_torch.harness.synth import synth_queries

    comps, vals = [], []
    seed = 11
    while len(comps) < n:
        c, v = synth_queries(min(1024, n - len(comps)), dim=DIM, seed=seed)
        comps += c
        vals += v
        seed += 1
    return comps, vals


# the bench headline path (bench.py:45-55, 73, 85, 514-536, 604-669) at
# BENCH_r05's rung qc14 / pool96 / r64
V0, CSUB, N_QUERIES, BIG_M = 512, 2, 16384, 16


def headline_params():
    from seismic_tpu_torch.search.grouped import GroupedParams

    return GroupedParams(k=K, score_cut=64, pool=96, rescore=64,
                         compute_dtype="i8", pool_mode="hier",
                         pool_per_pair=16, kernel_unroll=8,
                         pool_dtype="bf16", dedup_mode="post",
                         pool_recall=0.98)


def padded_queries(n: int):
    """`n` distinct queries padded to 64 terms per 1024 (bench.py:249-267:
    seeds 11, 12, ...)."""
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.harness.synth import synth_queries

    parts = []
    for i, c0 in enumerate(range(0, n, 1024)):
        c, v = synth_queries(min(1024, n - c0), dim=DIM, seed=11 + i)
        parts.append(pad_queries(c, v, 64))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


class NoProfile(RuntimeError):
    """The profiler did not start, or saw no device time. Only this is
    caught around a profiled call: an error of the call itself fails its
    phase."""


def profile_device(fn):
    """(device busy ms, {kernel: ms}) of one call of `fn` from a
    torch.profiler window taken after one warm-up call under the
    profiler's warm-up step, whose events are dropped (cold windows lost
    the program's first kernels), the kernels by time. Raises NoProfile
    when the profiler could not start or saw no device time."""
    import torch

    try:
        from torch.profiler import ProfilerActivity, profile, schedule
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
        prof.start()
    except Exception as e:  # noqa: BLE001 - the profiler alone
        raise NoProfile(f"the profiler did not start: {e}") from e
    try:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    kern = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        # the schedule's step annotation spans the step on the device
        # timeline; it is no kernel
        if e.key.startswith("ProfilerStep"):
            continue
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.key[:80]] = kern.get(e.key[:80], 0.0) + us / 1e3
    busy = sum(kern.values())
    if busy <= 0:
        raise NoProfile("the profiler recorded no device time")
    return busy, dict(sorted(kern.items(), key=lambda kv: -kv[1]))


def profile_held(fn, wanted, top: int = 12, tries: int = 3):
    """One call of `fn` profiled by `profile_device`, read only where its
    window holds every kernel whose name holds one of `wanted`: up to
    `tries` windows. Returns (record, every kernel's ms): the record's
    `device_busy_ms` is None where no window held them all (the last
    window's busy beside it). Raises NoProfile as `profile_device`
    does."""
    for n_win in range(1, tries + 1):
        busy, kern = profile_device(fn)
        missing = [n_ for n_ in wanted if not any(n_ in k_ for k_ in kern)]
        if not missing:
            break
    rec = dict(device_busy_ms=None if missing else busy,
               kernels_ms=dict(list(kern.items())[:top]),
               profile_windows=n_win, profile_missing=missing)
    if missing:
        rec["device_busy_ms_incomplete_window"] = busy
    return rec, kern


def idle_share(busy, program_ms):
    """The device's idle share of a program's wall time; None where the
    busy time was not read."""
    return None if busy is None else max(0.0, 1.0 - busy / program_ms)


def align_pair_order(host, derived):
    """The host plan with its pair tables moved to the derived plan's
    top-QC column order (the C++ planner's nth_element and the device's
    top-k order a query's lists differently; groups, slots and work items
    do not depend on it), so the two plans can be compared field by field
    and searched with bit-identical inputs."""
    import dataclasses

    B, QC = host.pair_list.shape
    big = np.iinfo(np.int32).max
    oh = np.argsort(np.where(host.pair_valid, host.pair_list, big), 1,
                    kind="stable")
    od = np.argsort(np.where(derived["pair_valid"], derived["pair_list"],
                             big), 1, kind="stable")
    rows = np.arange(B)[:, None]
    moved = {}
    for f in ("pair_slot", "pair_pstart", "pair_valid", "pair_list",
              "pair_len"):
        a = getattr(host, f)
        out = np.empty_like(a)
        out[rows, od] = a[rows, oh]
        moved[f] = out
    qmap = np.empty((B, QC), np.int64)
    qmap[rows, oh] = od
    sp = host.slot_pair.copy()
    real = host.slot_b.reshape(-1) < B
    b_of = sp[real] // QC
    sp[real] = b_of * QC + qmap[b_of, sp[real] % QC]
    moved["slot_pair"] = sp
    return dataclasses.replace(host, **moved)


def headline_path(ds, dev, record, kernels, graph) -> dict:
    """Phase 4: the bench headline path through `plan_caps` and
    `search_grouped_derive` on an index that carries `graph` (phase 8a's);
    returns K4's record and leaves the path's twenty-five launch counts
    in `record["launch_windows"]["headline"]`. Phases 6
    and 8 (c, d) run inside it, on its index."""
    import torch

    from seismic_tpu_torch import Configuration, GlobalThresholdPruning
    from seismic_tpu_torch import TpuLayout
    from seismic_tpu_torch.build.builder import build_index
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import grouped_scorer_item
    from seismic_tpu_torch.ops.tiles_prep import SUB, narrow_vocab
    from seismic_tpu_torch.search.grouped import (
        DevicePlan,
        _grouped_impl,
        _grouped_pool,
        _PLAN_FIELDS,
        _query_terms,
        derive_plan_device,
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped

    rec = record.setdefault("headline", {})
    params = headline_params()
    ROWS = CSUB * SUB

    # ---- set-up: f32 build, narrowed to V0, uploaded with csub 2 ----
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=TpuLayout(max_block_len=32, summary_vocab_cap=V_CAP,
                         max_doc_nnz=256, tile_overflow=64),
    )
    t0 = time.time()
    full = build_index(ds, cfg, value_dtype="f32")
    t1 = time.time()
    arrays = narrow_vocab(full, V0)
    arrays.knn = graph  # indexed by doc id, as this index's docs are
    t2 = time.time()
    dindex = arrays.to_device(dev, tile_csub=CSUB)
    ctx = PlannerContext.from_arrays(arrays, csub=CSUB)
    t3 = time.time()
    gc.collect()
    q_comps, q_vals = padded_queries(N_QUERIES)
    nb = N_QUERIES // BATCH
    qcn = [q_comps[b * BATCH:(b + 1) * BATCH] for b in range(nb)]
    qvn = [q_vals[b * BATCH:(b + 1) * BATCH] for b in range(nb)]
    qcd = [torch.from_numpy(a).to(dev) for a in qcn]
    qvd = [torch.from_numpy(a).to(dev) for a in qvn]
    qcB = torch.from_numpy(q_comps).to(dev)
    qvB = torch.from_numpy(q_vals).to(dev)
    rec.update(index_build_s=t1 - t0, narrow_s=t2 - t1, upload_s=t3 - t2,
               device_index_bytes=dindex.nbytes(), V0=V0, csub=CSUB,
               queries=N_QUERIES)
    log(f"phase 4 setup: f32 index build {t1 - t0:.1f} s, narrow_vocab("
        f"{V0}) {t2 - t1:.1f} s, upload csub {CSUB} {t3 - t2:.1f} s, device "
        f"index bytes {rec['device_index_bytes']}")

    # ---- the derived plan against the host plan, every batch ----
    batches = [(qcn[b], qvn[b], qcd[b], qvd[b], 8) for b in range(nb)]
    batches.append((q_comps, q_vals, qcB, qvB, BIG_M))
    plans = []
    for i, (qc_np, qv_np, qc_t, qv_t, M) in enumerate(batches):
        host = plan_grouped(qc_np, qv_np, ctx, QUERY_CUT, M=M)
        dp = derive_plan_device(dindex, qc_t, qv_t, QUERY_CUT, M,
                                host.G_cap, host.W_cap, ctx.zero_region)
        G, W = int(dp.G), int(dp.W)
        if (G, W) != (host.G, host.W):
            fail(f"batch {i}: derived plan G, W = {G}, {W} but the host "
                 f"plan has {host.G}, {host.W} (a top-QC tie broken "
                 "differently)")
        if not (G < host.G_cap and W <= host.W_cap):
            fail(f"batch {i}: G, W = {G}, {W} past the caps "
                 f"{host.G_cap}, {host.W_cap}")
        d = {f: getattr(dp, f).cpu().numpy() for f in _PLAN_FIELDS}
        hal = align_pair_order(host, d)
        for f in _PLAN_FIELDS:
            a, b = getattr(hal, f), d[f]
            if f == "pair_slot":  # the dump slot of invalid pairs differs
                a, b = a[hal.pair_valid], b[d["pair_valid"]]
            if not np.array_equal(a, b):
                fail(f"batch {i}: derived plan field {f} differs from the "
                     "host plan's")
        plans.append((host, hal, dp))
        log(f"phase 4 plan {i} (B={len(qc_np)}, M={M}): derived == host, "
            f"G {G} <= {host.G_cap}, W {W} <= {host.W_cap}")
    rec["plans"] = [{"B": len(b[0]), "M": b[4], "G": p[0].G, "W": p[0].W,
                     "G_cap": p[0].G_cap, "W_cap": p[0].W_cap}
                    for b, p in zip(batches, plans)]
    # the same search through both plans: identical inputs to every stage
    for i in (0, nb):
        host, hal, dp = plans[i]
        qc_t, qv_t, M = batches[i][2], batches[i][3], batches[i][4]
        s_h, i_h = _grouped_impl(dindex, DevicePlan.put(hal, dev), qc_t,
                                 qv_t, params)
        s_d, i_d = search_grouped_derive(dindex, qc_t, qv_t, params,
                                         QUERY_CUT, M, host.G_cap,
                                         host.W_cap, ctx.zero_region)
        same = (torch.sort(i_h, 1).values == torch.sort(i_d, 1).values).all()
        fin = torch.isfinite(s_h)
        rel = ((s_h - s_d).abs()[fin]
               / s_h.abs()[fin].clamp_min(1e-30)).max().item()
        if not (bool(same) and torch.equal(fin, torch.isfinite(s_d))
                and rel <= 1e-5):
            fail(f"plan {i}: host-plan and derived-plan searches disagree "
                 f"(equal id sets {bool(same)}, score rel err {rel})")
        log(f"phase 4 plan {i}: host-plan search == derived-plan search "
            f"(id sets equal, max rel err {rel:.3g})")

    # ---- K1, K4 and K3 against their plain versions on the path's own
    # inputs: the derived plan's pairs and work list, the group queries
    # from K1, and the pool's real candidates (rescore = 64) ----
    at_headline = ({}, {})  # K1's and K3's records at the headline shapes

    def k4_inputs(i, tag):
        """K4's operands for plan i, as _grouped_impl builds them, after
        holding K1 (which makes its group queries) against its plain
        version."""
        qc_t, qv_t = batches[i][2], batches[i][3]
        dp = plans[i][2]
        top_c, top_v, sc = _query_terms(qc_t, qv_t, params.score_cut)
        rec1, q_i8 = check_k1(
            (dindex.vocab16, dp.pair_list.reshape(-1).contiguous(),
             top_c[:, :sc].contiguous(), top_v[:, :sc].contiguous(),
             dp.pair_list.shape[1]), f"headline {tag}")
        at_headline[0][tag] = rec1
        G_cap, M = dp.slot_b.shape
        q8 = q_i8[dp.slot_pair.long()].reshape(G_cap, M, V0).contiguous()
        return (dindex.doc_tiles_aligned, dindex.tile_scale, q8,
                dp.work_region, dp.work_g, CSUB)

    def check_k3_headline(i, tag):
        qc_t, qv_t = batches[i][2], batches[i][3]
        top_c, top_v, sc, _, cand_ids = _grouped_pool(
            dindex, plans[i][2], qc_t, qv_t, params)[:5]
        rp = params.rescore
        rec3 = check_k3((dindex.fwd_fused,
                         cand_ids[:, :rp].to(torch.int32).contiguous(),
                         top_c[:, :sc].contiguous(),
                         top_v[:, :sc].contiguous(), dindex.n_docs),
                        f"headline {tag}")
        at_headline[1][tag] = rec3
        for name, r in (("K1 qloc_quantize", at_headline[0][tag]),
                        ("K3 rescore_fused", rec3)):
            sched = ("" if "bound_as_scheduled_ms" not in r else
                     f", {r['bound_as_scheduled_ms']:.4f} as scheduled")
            log(f"phase 4: {name} ({tag}): ok, max_abs_err "
                f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}{sched}, compare "
                f"count {r['compare_bound_ms']:.4f}; plain "
                f"{r['plain_ms']:.3f} ms)")

    k4 = {}
    for i, tag in ((0, "b4096_m8"), (nb, "b16384_m16")):
        a4 = k4_inputs(i, tag)
        W = plans[i][0].W
        k_out = grouped_scorer_item.score_grouped_i8_item(*a4)
        p_out = grouped_scorer_item.score_grouped_i8_item_plain(*a4)
        rel = ((k_out - p_out).abs() / p_out.abs().clamp_min(1e-30)).max()
        rel = rel.item()
        if not rel <= 1e-6:
            fail(f"K4 ({tag}) disagrees: max relative error {rel}")
        a4u = (a4[0], torch.ones_like(a4[1])) + a4[2:]
        kd = grouped_scorer_item.score_grouped_i8_item(*a4u)
        pd = grouped_scorer_item.grouped_dots_plain(
            a4[0], a4[2], a4[3], a4[4], rows_per_item=ROWS).to(torch.float32)
        if not torch.equal(kd, pd):
            fail(f"K4 ({tag}) int dots disagree with the plain version")
        M = a4[2].shape[1]
        n_regions = torch.unique(a4[3][:W]).numel()
        G = plans[i][0].G
        by4 = (n_regions * ROWS * (V0 + 4) + G * M * V0 + W * 8
               + W * M * ROWS * 4)
        ops4 = 2.0 * W * M * ROWS * V0
        b4, bb4 = bound(by4, ops4, PEAK_INT8)
        # library yardstick: one int8 tensor-core product with the same
        # operation count over the same gathered tile rows (one [V, M]
        # query block for all items: not the same function; never used)
        rows = (a4[3][:W].long()[:, None] * ROWS
                + torch.arange(ROWS, device=dev)).reshape(-1)
        A = a4[0][rows].view(torch.int8)
        Bq = a4[2][0].t()  # [V, M], column-major
        lib_ms = time_ms(lambda: torch._int_mm(A, Bq), 20)
        del A, rows
        k4[tag] = dict(
            max_abs_err=float((k_out - p_out).abs().max().item()),
            max_rel_err=rel,
            ms=time_ms(lambda: grouped_scorer_item.score_grouped_i8_item(
                *a4), 20),
            plain_ms=time_ms(
                lambda: grouped_scorer_item.score_grouped_i8_item_plain(*a4),
                3),
            bound_ms=b4, bound_by=bb4, library_ms=lib_ms, W=W, G=G,
            W_cap=int(a4[3].shape[0]), M=M, distinct_super_tiles=n_regions,
            bytes=by4, ops=ops4)
        log(f"phase 4: K4 score_grouped_i8_item ({tag}): ok, max rel err "
            f"{rel:.3g}, {k4[tag]['ms']:.4f} ms (bound {b4:.4f} ms by "
            f"{bb4}, plain {k4[tag]['plain_ms']:.3f} ms, library {lib_ms})")
        del k_out, p_out, kd, pd, a4, a4u
        check_k3_headline(i, tag)
        torch.cuda.empty_cache()
    for kr, recs in zip((kernels[0], kernels[2]), at_headline):
        kr["at_headline"] = recs

    # ---- timed window: QPS as bench.py times it ----
    def once(b):
        gc_, wc_ = plan_caps(qcn[b], qvn[b], ctx, QUERY_CUT, M=8)
        return search_grouped_derive(dindex, qcd[b], qvd[b], params,
                                     QUERY_CUT, 8, gc_, wc_,
                                     ctx.zero_region)

    gcB, wcB = plan_caps(q_comps, q_vals, ctx, QUERY_CUT, M=BIG_M)

    def once_big():
        return search_grouped_derive(dindex, qcB, qvB, params, QUERY_CUT,
                                     BIG_M, gcB, wcB, ctx.zero_region)

    for b in range(nb):  # warm-up (allocator, first launches)
        once(b)
    once_big()
    torch.cuda.synchronize()
    zero_launches()
    g0 = gc_ms()
    t0 = time.perf_counter()
    outs = [None] * nb
    for _ in range(REPS):
        for b in range(nb):
            outs[b] = once(b)
    torch.cuda.synchronize()
    el4 = time.perf_counter() - t0
    g1 = gc_ms()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out_big = once_big()
    torch.cuda.synchronize()
    el16 = time.perf_counter() - t0
    gc_qps = {"b4096_ms": g1 - g0, "b16384_ms": gc_ms() - g1}
    counts = read_launches()
    qps4 = REPS * nb * BATCH / el4
    qps16 = REPS * N_QUERIES / el16
    log(f"phase 4: QPS(B={BATCH}, M=8) {qps4:.1f} over {REPS} x {nb} "
        f"batches ({el4:.3f} s, plan_caps included); QPS(B={N_QUERIES}, "
        f"M={BIG_M}) {qps16:.1f} over {REPS} calls ({el16:.3f} s); launches "
        f"{counts}; gc {json.dumps(gc_qps)}")
    hold_launches("the headline path", counts,
                  positive=("qloc", "score_grouped_i8_item", "rescore"))
    record["launch_windows"]["headline"] = counts
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        once(0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    log(f"phase 4: p50 of a synchronised B={BATCH} call {p50 * 1e3:.2f} ms")

    # ---- no host syncs from the query tensors to the result tensors ----
    torch.cuda.set_sync_debug_mode("error")
    try:
        once_big()
    except RuntimeError as e:
        fail(f"search_grouped_derive synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 4: one B=16384 search_grouped_derive ran under "
        "set_sync_debug_mode('error')")

    # ---- results: shapes, finite, exact scores, recall@10 ----
    s4 = torch.cat([o[0] for o in outs])
    i4 = torch.cat([o[1] for o in outs])
    s16, i16 = out_big
    for s_, i_ in ((s4, i4), (s16, i16)):
        if s_.shape != (N_QUERIES, K) or not torch.isfinite(s_).all():
            fail("headline results are not finite [16384, 10]")
        if not (s_[:, 1:] <= s_[:, :-1]).all():
            fail("headline scores are not descending")
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), DIM)).to(dev)
    gt, gt_s = [], []
    worst = 0.0
    for c0 in range(0, N_QUERIES, 2048):
        qc_t, qv_t = qcB[c0:c0 + 2048], qvB[c0:c0 + 2048]
        n = qc_t.shape[0]
        ok = qc_t != int(PAD_COMPONENT)
        col = torch.arange(n, device=dev)[:, None].expand_as(qc_t)
        qd = torch.zeros((DIM, n), dtype=torch.float32, device=dev)
        qd[qc_t[ok].long(), col[ok]] = qv_t[ok]
        exact = torch.sparse.mm(docs, qd)  # [n_docs, n]
        top = torch.topk(exact, K, dim=0)
        gt.append(top.indices.t())
        gt_s.append(top.values.t())
        # every returned score is the exact dot of its doc
        ex = exact.t().gather(1, i4[c0:c0 + n])
        worst = max(worst, ((s4[c0:c0 + n] - ex).abs()
                            / ex.abs().clamp_min(1e-30)).max().item())
        del exact, qd
    if not worst <= 1e-4:
        fail(f"headline scores differ from exact dots by {worst} relative")
    gt = torch.cat(gt).cpu().numpy()
    gt_s = torch.cat(gt_s).cpu().numpy()

    def recall(ids):
        ids = ids.cpu().numpy()
        return sum(len(set(g.tolist()) & set(r.tolist()))
                   for g, r in zip(gt, ids)) / (K * len(gt))

    rec4, rec16 = recall(i4), recall(i16)
    log(f"phase 4: recall@10 {rec4:.4f} (B={BATCH} batches) and {rec16:.4f} "
        f"(B={N_QUERIES}) on {N_QUERIES} queries; protocol target 0.97; "
        f"scores exact to {worst:.3g}")
    if rec4 < 0.95 or rec16 < 0.95:
        fail(f"headline recall@10 {rec4:.4f} / {rec16:.4f} < 0.95")

    # ---- phase 8 (c, d): the knn rung and exact search, on this index ----
    knn_headline_path(
        dict(ds=ds, dindex=dindex, ctx=ctx, q_comps=q_comps, q_vals=q_vals,
             qcB=qcB, qvB=qvB, gcB=gcB, wcB=wcB, gt=gt, gt_scores=gt_s,
             docs=docs), dev, record)

    # ---- phase 6: the remaining modes, on this index and batch 0 ----
    new_kernels = modes_path(
        dict(arrays=arrays, dindex=dindex, ctx=ctx, qc_np=qcn[0],
             qv_np=qvn[0], qc_t=qcd[0], qv_t=qvd[0], plan=plans[0][2],
             G=plans[0][0].G, W=plans[0][0].W, gt=gt[:256], docs=docs,
             ids_headline=i4[:BATCH]), dev, record, kernels)

    # ---- phase 10 (a-d): hashed tiles, the streaming budget, the
    # weighted cut, the margin and the two-pass driver, on this index ----
    grouped_rest_path(
        dict(arrays=arrays, dindex=dindex, ctx=ctx, docs=docs,
             q_comps=q_comps, q_vals=q_vals, qcB=qcB, qvB=qvB,
             qc_np=qcn[0], qv_np=qvn[0], qc_t=qcd[0], qv_t=qvd[0], gt=gt,
             ids_headline=i4[:BATCH], rec16=rec16), dev, record, kernels)

    # ---- phase 11a: the half-width forward rows, on this index ----
    half_width_path(
        dict(arrays=arrays, dindex=dindex, ctx=ctx, gt=gt, qcn=qcn, qvn=qvn,
             qcd=qcd, qvd=qvd, qcB=qcB, qvB=qvB, gcB=gcB, wcB=wcB,
             rec16=rec16), dev, record)

    # ---- phase 6b: tile widths 128 and 384, on this index narrowed ----
    record["widths_kernels"] = widths_path(
        dict(arrays=arrays, docs=docs, qc_np=qcn[0], qv_np=qvn[0],
             qc_t=qcd[0], qv_t=qvd[0], gt=gt[:256]), dev, record)

    # ---- the aligned-tile cache, on this index, in phase 14's cache ----
    with tempfile.TemporaryDirectory(prefix="seismic_drivers") as cache:
        nw_dir = drivers_protocol(len(ds), cache).index_base + f"_nw{V0}.dir"
        aligned_cache_path(
            dict(arrays=arrays, dindex=dindex, ctx=ctx, qc_np=qcn[0],
                 qv_np=qvn[0], qc_t=qcd[0], qv_t=qvd[0], index_dir=nw_dir),
            dev, record)

        # ---- phase 14: the probe drivers, on this corpus and index ----
        record["widths_kernels"] += drivers_path(
            dict(ds=ds, full=full, arrays=arrays, dindex=dindex, ctx=ctx,
                 docs=docs, gt=gt, q_comps=q_comps, q_vals=q_vals, qcB=qcB,
                 qvB=qvB, qc_np=qcn[0], qv_np=qvn[0], qc_t=qcd[0],
                 qv_t=qvd[0], cache=cache), dev, record)
    del docs, arrays, full
    gc.collect()
    torch.cuda.empty_cache()

    # ---- where one B=16384 call's time goes ----
    t0 = time.perf_counter()
    plan_caps(q_comps, q_vals, ctx, QUERY_CUT, M=BIG_M)
    caps16_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plan_caps(qcn[0], qvn[0], ctx, QUERY_CUT, M=8)
    caps4_ms = (time.perf_counter() - t0) * 1e3
    # the host returns from the call long before the device finishes when
    # nothing in it waits for the device (the sync debug mode above is a
    # prototype that may miss some synchronising operations)
    g0, n_alloc = gc_ms(), device_allocs()
    t0 = time.perf_counter()
    once_big()
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    prog_ms = (time.perf_counter() - t0) * 1e3
    brk = {"plan_caps_b4096_ms": caps4_ms, "plan_caps_b16384_ms": caps16_ms,
           "device_program_b16384_ms": prog_ms,
           "host_enqueue_b16384_ms": (t_enq - t0) * 1e3,
           "gc_ms": gc_ms() - g0,
           "cuda_mallocs": device_allocs() - n_alloc}
    hand = ("qloc_kernel", "score_item_kernel", "rescore_fused_kernel")
    try:
        prof, _ = profile_held(once_big, hand)
        brk.update(prof, device_idle_share=idle_share(
            prof["device_busy_ms"], prog_ms))
        # the device's share of one B=4096 batch (its caps computed first)
        gc0, wc0 = plan_caps(qcn[0], qvn[0], ctx, QUERY_CUT, M=8)
        prof4, _ = profile_held(
            lambda: search_grouped_derive(dindex, qcd[0], qvd[0], params,
                                          QUERY_CUT, 8, gc0, wc0,
                                          ctx.zero_region), hand)
        brk.update(device_busy_b4096_ms=prof4["device_busy_ms"],
                   profile_b4096_missing=prof4["profile_missing"])
    except NoProfile as e:  # informational only
        brk["profile"] = f"not measured: {e}"
    log(f"phase 4 breakdown of one B={N_QUERIES} call: {json.dumps(brk)}")

    rec.update(qps_b4096_m8=qps4, qps_b16384_m16=qps16, p50_b4096_ms=p50 * 1e3,
               latencies_b4096_s=lat, recall_at_10_b4096=rec4,
               recall_at_10_b16384=rec16, max_rel_score_err=worst,
               launches=counts, k4=k4, breakdown=brk, gc_qps_windows=gc_qps,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    main4 = k4["b4096_m8"]
    return new_kernels, dict(
        name="score_grouped_i8_item", route="cuda",
        source="seismic_tpu_torch/csrc/grouped_scorer_item.cu",
        replaces="seismic_tpu/ops/pallas_grouped.py:326",
        packed=record["modes"]["k5"]["in_k4"],
        max_abs_err=main4["max_abs_err"], ms=main4["ms"],
        plain_ms=main4["plain_ms"], bound_ms=main4["bound_ms"],
        bound_by=main4["bound_by"], library_ms=main4["library_ms"],
        at_b16384_m16={k: k4["b16384_m16"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    )


# ---- phase 6: the remaining grouped-search modes ----
# recall@10 floors on 256 queries, each the first reading (NVIDIA H100 80GB
# HBM3, 700 W: 0.9422, 0.9348, 0.9543, 0.9543, 0.9035, 0.9805, 0.9805) less
# 0.02, as phase 5's: a broken mask or epilogue falls far below them; they
# are no tuned targets.
MODE_RECALL_FLOORS = {
    "gate": 0.922, "defaults": 0.914, "stride_item": 0.934,
    "stride_slot": 0.934, "window_bf16": 0.883, "rowmajor": 0.960,
    "residue": 0.960,
}
# share of 256 queries on which the f32 scorer and the int8 scorer, both
# with the exact pool and rescore 64, return the same top-10 id set: the
# first reading (1.0) less 0.02
F32_VS_I8_FLOOR = 0.98


def modes_path(env, dev, record, kernels) -> list:
    """Phase 6: the grouped-search modes of K5, K6, K8 and K9 on the
    headline cell's index, one B=4096 / M=8 batch; returns the four new
    kernels' records and leaves the phase's launch counts of all twenty-five
    kernels in `record["launch_windows"]["modes"]`."""
    import dataclasses

    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import (
        grouped_scorer,
        grouped_scorer_f,
        grouped_scorer_item,
        pack_epilogue,
        qloc,
        qloc_residue,
        qloc_rowmajor,
    )
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search import grouped
    from seismic_tpu_torch.search.grouped import (
        GroupedParams,
        _query_terms,
        _residue_buckets,
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.search.planner import PlannerContext

    rec = record.setdefault("modes", {})
    t_phase = time.time()
    arrays, dindex, ctx = env["arrays"], env["dindex"], env["ctx"]
    qc_np, qv_np, qc_t, qv_t = (env[k_] for k_ in ("qc_np", "qv_np", "qc_t",
                                                   "qv_t"))
    dp, G, W, gt = env["plan"], env["G"], env["W"], env["gt"]
    nq = len(gt)
    M, QC, ROWS = 8, QUERY_CUT, CSUB * SUB
    LLMAX = ll_pad_for(dindex.max_list_len, CSUB)
    G_cap = dp.slot_b.shape[0]
    P = BATCH * QC
    total = dict.fromkeys(COUNTED, 0)

    def rel_err(k, p, floor=1e-30):
        return ((k - p).abs() / p.abs().clamp_min(floor)).max().item()

    # ---- the path's own operands: K1's f32 output, qsum, the groups ----
    top_c, top_v, sc = _query_terms(qc_t, qv_t, 64)
    a1 = (dindex.vocab16, dp.pair_list.reshape(-1).contiguous(),
          top_c[:, :sc].contiguous(), top_v[:, :sc].contiguous(), QC)
    qf_pairs = qloc.project_qloc_f32(*a1)
    if not torch.equal(qf_pairs, qloc.project_qloc_plain(*a1)):
        fail("K1's f32 output disagrees with its plain version")
    rec["k1_f32_output"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: qloc.project_qloc_f32(*a1), 20),
        plain_ms=time_ms(lambda: qloc.project_qloc_plain(*a1), 3))
    kernels[0]["f32_output"] = rec["k1_f32_output"]
    q8_pairs, sc8 = qloc.project_qloc_quantize(*a1)
    slot_src = dp.slot_pair.long()
    qf = qf_pairs[slot_src].reshape(G_cap, M, V0).contiguous()
    q8 = q8_pairs[slot_src].reshape(G_cap, M, V0).contiguous()
    qsum = (128.0 * qf_pairs.sum(-1))[slot_src].reshape(G_cap, M).contiguous()
    tiles, tscale = dindex.doc_tiles_aligned, dindex.tile_scale
    wr, wg, ws = dp.work_region, dp.work_g, dp.work_s
    wgl, wsl = wg[:W].long(), ws[:W].long()
    n_regions = torch.unique(wr[:W]).numel()
    tile_bytes = n_regions * ROWS * (V0 + 4)
    log(f"phase 6 shapes: B {BATCH}, M {M}, P {P}, G {G}, W {W} items of "
        f"{ROWS} rows, {n_regions} distinct super-tiles, V {V0}, LLMAX "
        f"{LLMAX}")

    def covered(out, step):
        """The slot-major output blocks the W real items wrote."""
        return out.view(G_cap, M, LLMAX // ROWS, step)[wgl, :, wsl, :]

    # ---- K6's route per mode: the SASS of its kernels at these shapes ----
    sass6 = sass_of("grouped_scorer_f")
    routes6, mix6 = {}, None
    for dt, terms in (("bf16", 1), ("f32", 3)):
        if sass6 is None:
            routes6[dt] = dict(route="tensor cores", hmma_bf16=None,
                               sass="not read (no cuobjdump)")
            continue
        key = f"score_grouped_f_kernelILi{M}ELi{ROWS}ELi{terms}ELb0E"
        ops = [o for f_, o in sass6.items() if key in f_]
        if len(ops) != 1:
            fail(f"K6's SASS has {len(ops)} kernels named {key}")
        n_hmma = sum(c for o, c in ops[0].items()
                     if o.startswith("HMMA") and "BF16" in o)
        routes6[dt] = dict(
            route="tensor cores" if n_hmma else "cuda cores",
            hmma_bf16=n_hmma)
        if dt == "bf16":
            mix6 = dict(sorted(ops[0].items(), key=lambda kv: -kv[1])[:16])
    if routes6["bf16"]["route"] != "tensor cores":
        fail(f"K6's bf16 kernel has no bf16 HMMA in its SASS: {routes6}")
    ptx6 = ptxas_of("grouped_scorer_f", "score_grouped_f_kernel")
    for dt, terms in (("bf16", 1), ("f32", 3)):
        key = f"score_grouped_f_kernelILi{M}ELi{ROWS}ELi{terms}ELb0E"
        routes6[dt]["ptxas"] = [ln for f_, lns in ptx6.items() if key in f_
                                for ln in lns]
        log(f"phase 6: K6 {dt} (M {M}, {ROWS} rows, unpacked) runs on the "
            f"{routes6[dt]['route']} ({routes6[dt]['hmma_bf16']} bf16 HMMA "
            f"in its SASS); ptxas: {'; '.join(routes6[dt]['ptxas'])}")
    log(f"phase 6: K6 bf16 kernel's static instruction mix: {mix6}")

    # ---- K6 against its plain version: bf16 / f32, centred / fixup ----
    mag = (qsum[wgl][:, :, None]
           * tscale[wr[:W].long()[:, None] * ROWS
                    + torch.arange(ROWS, device=dev)][:, None, :])
    k6 = {}
    for dt in ("bf16", "f32"):
        # the bound follows the route: on the tensor cores f32 mode does
        # three bf16 products (its split), on the CUDA cores one f32 one
        on_tc = routes6[dt]["route"] == "tensor cores"
        n_prod = 3 if (dt == "f32" and on_tc) else 1
        peak6 = PEAK_BF16 if on_tc else PEAK_F32
        for qs in (qsum, None):
            a6 = (tiles, tscale, qf, qs, wr, wg, ws, LLMAX, CSUB, dt)
            k = covered(grouped_scorer_f.score_grouped_f(*a6), ROWS)
            p = covered(grouped_scorer_f.score_grouped_f_plain(*a6), ROWS)
            err = (k - p).abs()
            # 1e-5 of the larger of the score and the centring term it
            # cancels against (1e-5 relative in the fixup form)
            tol = 1e-5 * (torch.maximum(mag, p.abs()) if qs is not None
                          else p.abs())
            tag = f"{dt}_{'centred' if qs is not None else 'fixup'}"
            if not (err <= tol).all():
                fail(f"K6 ({tag}) disagrees: max abs err {err.max().item()}")
            by6 = (tile_bytes + G * M * V0 * 4 + (G * M * 4 if qs is not None
                                                  else 0)
                   + W * 12 + W * M * ROWS * 4)
            ops6 = 2.0 * W * M * ROWS * V0 * n_prod
            b6, bb6 = bound(by6, ops6, peak6)
            k6[tag] = dict(
                route=routes6[dt]["route"],
                max_abs_err=float(err.max().item()),
                max_err_over_tol=float((err / tol.clamp_min(1e-30)).max()
                                       .item()),
                ms=time_ms(lambda: grouped_scorer_f.score_grouped_f(*a6), 10),
                plain_ms=time_ms(
                    lambda: grouped_scorer_f.score_grouped_f_plain(*a6), 2),
                bound_ms=b6, bound_by=bb6, bytes=by6, ops=ops6)
            r6 = k6[tag]
            log(f"phase 6: K6 score_grouped_f ({tag}, {r6['route']}): ok, "
                f"max abs err {r6['max_abs_err']:.3g} "
                f"({r6['max_err_over_tol']:.3g} of its tolerance), "
                f"{r6['ms']:.4f} ms (bound {b6:.4f} ms by {bb6}, plain "
                f"{r6['plain_ms']:.3f} ms)")
            del k, p, err, tol
    # library yardstick: one bf16 tensor-core product with the same
    # operation count over the same gathered tile rows (one [V, M] query
    # block for all items: not the same function; timed, never used)
    rows = (wr[:W].long()[:, None] * ROWS
            + torch.arange(ROWS, device=dev)).reshape(-1)
    A = tiles[rows].to(torch.bfloat16)
    Bq = qf[0].t().to(torch.bfloat16).contiguous()
    lib6 = time_ms(lambda: torch.matmul(A, Bq), 10)
    del A, Bq, rows
    torch.cuda.empty_cache()

    # ---- K2 at csub 2, and K5 inside K2, K4 and K6 ----
    a2 = (tiles, tscale, q8, wr, wg, ws, LLMAX, CSUB)
    k2o = covered(grouped_scorer.score_grouped_i8(*a2), ROWS)
    p2o = covered(grouped_scorer.score_grouped_i8_plain(*a2), ROWS)
    if not torch.equal(k2o, p2o):
        fail("K2 at csub 2 disagrees with its plain version")
    by2 = tile_bytes + G * M * V0 + W * 12 + W * M * ROWS * 4
    ops_i8 = 2.0 * W * M * ROWS * V0
    b2, bb2 = bound(by2, ops_i8, PEAK_INT8)
    kernels[1]["at_csub2"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: grouped_scorer.score_grouped_i8(*a2), 10),
        plain_ms=time_ms(lambda: grouped_scorer.score_grouped_i8_plain(*a2),
                         2), bound_ms=b2, bound_by=bb2)
    log(f"phase 6: K2 at csub 2: bit-equal, "
        f"{kernels[1]['at_csub2']['ms']:.4f} ms (bound {b2:.4f} ms by {bb2})")
    del k2o, p2o
    k5 = {}
    a4 = (tiles, tscale, q8, wr, wg, CSUB, ws, LLMAX)
    a6 = (tiles, tscale, qf, qsum, wr, wg, ws, LLMAX, CSUB, "bf16")
    for tag, fn, plain, args, pw, slot_major in (
            ("in_k2", grouped_scorer.score_grouped_i8,
             grouped_scorer.score_grouped_i8_plain, a2, 2, True),
            ("in_k4", grouped_scorer_item.score_grouped_i8_item,
             grouped_scorer_item.score_grouped_i8_item_plain, a4, 2, False),
            ("in_k6_window", grouped_scorer_f.score_grouped_f,
             grouped_scorer_f.score_grouped_f_plain, a6, 1, True),
            ("in_k6_stride", grouped_scorer_f.score_grouped_f,
             grouped_scorer_f.score_grouped_f_plain, a6, 2, True)):
        step = ROWS // pw
        k = fn(*args, pw)
        p = plain(*args, pw)
        if slot_major:
            k, p = covered(k, step), covered(p, step)
        else:
            k, p = k[:W], p[:W]
        if tag.startswith("in_k6"):
            # the unpacked score to K6's tolerance plus the index bits the
            # pack clears; the row wherever both name the same score
            (kv, ko), (pv, po) = (pack_epilogue.unpack(x, LLMAX)
                                  for x in (k, p))
            tol = (1e-5 * mag.reshape(W, M, pw, step).amax(2)
                   + pv.abs() * (2.0 ** (pack_epilogue.idx_bits(LLMAX) - 23)
                                 + 1e-5))
            err = (kv - pv).abs()
            same_v = kv == pv
            off_ok = (ko[same_v] == po[same_v]).float().mean().item()
            if not ((err <= tol).all() and off_ok >= 0.999
                    and same_v.float().mean().item() > 0.5):
                fail(f"K5 ({tag}) disagrees: max abs err {err.max().item()}"
                     f", rows equal on {off_ok} of "
                     f"{same_v.float().mean().item()} equal scores")
            err_abs = float(err.max().item())
        else:
            if not torch.equal(k, p):
                fail(f"K5 ({tag}) is not bit-equal to its plain version: "
                     f"{(k != p).sum().item()} packed values differ")
            err_abs = 0.0
        out_bytes = W * M * step * 4
        in_bytes = (tile_bytes + W * 12
                    + (G * M * V0 if not tag.startswith("in_k6")
                       else G * M * (V0 + 1) * 4))
        b5, bb5 = bound(in_bytes + out_bytes, ops_i8,
                        PEAK_BF16 if tag.startswith("in_k6") else PEAK_INT8)
        k5[tag] = dict(
            pack_window=pw, max_abs_err=err_abs,
            ms=time_ms(lambda: fn(*args, pw), 10),
            unpacked_ms=time_ms(lambda: fn(*args), 10),
            plain_ms=time_ms(lambda: plain(*args, pw), 2),
            bound_ms=b5, bound_by=bb5)
        log(f"phase 6: K5 pack_epilogue ({tag}, pack_window {pw}): ok, "
            f"{k5[tag]['ms']:.4f} ms packed against "
            f"{k5[tag]['unpacked_ms']:.4f} ms unpacked (bound {b5:.4f} ms "
            f"by {bb5}, plain {k5[tag]['plain_ms']:.3f} ms)")
        del k, p
    rec["k5"], rec["k6"] = k5, k6
    torch.cuda.empty_cache()

    # ---- K8 against its plain version and against K1's codes ----
    a8 = (dindex.vocab16[a1[1].long()], a1[2].repeat_interleave(QC, dim=0),
          a1[3].repeat_interleave(QC, dim=0))
    r_i8, r_sc = qloc_rowmajor.project_qloc_rowmajor(*a8)
    p_i8, p_sc = qloc_rowmajor.project_qloc_rowmajor_plain(*a8)
    if not (torch.equal(r_i8, p_i8) and torch.equal(r_sc, p_sc)):
        fail("K8 disagrees with its plain version")
    if not (torch.equal(r_i8, q8_pairs) and torch.equal(r_sc, sc8)):
        fail("K8's codes or scales differ from K1's on the same pairs")
    n_terms = (a1[2] != int(PAD_COMPONENT)).sum(1)
    # a lookup a slot (the former compare count beside it)
    b8, bb8 = bound(P * V0 * 2 + P * sc * 8 + P * V0 + P * 4, float(P * V0),
                    PEAK_F32)
    compare8 = 2.0 * V0 * QC * float(n_terms.sum().item())
    rec8 = dict(
        name="qloc_rowmajor", route="cuda",
        source="seismic_tpu_torch/csrc/qloc.cu",
        replaces="seismic_tpu/ops/pallas_qloc.py:77", max_abs_err=0.0,
        ms=time_ms(lambda: qloc_rowmajor.project_qloc_rowmajor(*a8), 20),
        plain_ms=time_ms(
            lambda: qloc_rowmajor.project_qloc_rowmajor_plain(*a8), 3),
        bound_ms=b8, bound_by=bb8,
        compare_bound_ms=compare8 / PEAK_F32 * 1e3,
        # no one PyTorch call compares a slot with a list of terms and
        # quantizes the sum
        library_ms=None,
        k1_ms=time_ms(lambda: qloc.project_qloc_quantize(*a1), 20),
        gather_ms=time_ms(lambda: (
            dindex.vocab16[a1[1].long()], a1[2].repeat_interleave(QC, dim=0),
            a1[3].repeat_interleave(QC, dim=0)), 10))
    log(f"phase 6: K8 qloc_rowmajor: bit-equal to its plain version and to "
        f"K1's codes, {rec8['ms']:.4f} ms (K1 {rec8['k1_ms']:.4f} ms on the "
        f"same pairs; its operand gathers {rec8['gather_ms']:.4f} ms; bound "
        f"{b8:.4f} ms by {bb8}, plain {rec8['plain_ms']:.3f} ms)")
    del a8, r_i8, p_i8, q8_pairs, qf_pairs, qf, q8
    torch.cuda.empty_cache()

    # ---- the modes through plan_caps + search_grouped_derive ----
    caps = plan_caps(qc_np, qv_np, ctx, QC, M=M)

    def exact_of(ids):
        """The exact dots of the batch's queries with docs `ids` [B, k]."""
        out = torch.empty(ids.shape, dtype=torch.float32, device=dev)
        for c0 in range(0, BATCH, 2048):
            qc_, qv_ = qc_t[c0:c0 + 2048], qv_t[c0:c0 + 2048]
            n = qc_.shape[0]
            ok = qc_ != int(PAD_COMPONENT)
            col = torch.arange(n, device=dev)[:, None].expand_as(qc_)
            qd = torch.zeros((DIM, n), dtype=torch.float32, device=dev)
            qd[qc_[ok].long(), col[ok]] = qv_[ok]
            exact = torch.sparse.mm(env["docs"], qd)  # [n_docs, n]
            out[c0:c0 + n] = exact.t().gather(1, ids[c0:c0 + n].clamp_min(0))
            del exact, qd
        return out

    def recall(ids):
        ids = ids[:nq].cpu().numpy()
        return sum(len(set(g.tolist()) & set(r.tolist()))
                   for g, r in zip(gt, ids)) / (K * nq)

    def id_sets_equal(a, b):
        a, b = a[:nq].cpu().numpy(), b[:nq].cpu().numpy()
        return float(np.mean([set(x.tolist()) == set(y.tolist())
                              for x, y in zip(a, b)]))

    modes = rec.setdefault("runs", {})

    def run_mode(name, params, expect, index=dindex, exact_scores=False):
        """One warm batch of `params`, launch counts set to 0 before and
        read after; `expect` names the kernels that must launch exactly
        once (every other one never)."""
        def once():
            return search_grouped_derive(index, qc_t, qv_t, params, QC, M,
                                         caps[0], caps[1], ctx.zero_region)
        once()  # warm-up (allocator, first launches)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        s_, i_ = once()
        t_enq = time.perf_counter()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = hold_launches(f"mode {name}", read_launches(),
                               exact=dict.fromkeys(expect, 1))
        for n_, c in counts.items():
            total[n_] += c
        if s_.shape != (BATCH, K) or not (s_[:, 1:] <= s_[:, :-1]).all():
            fail(f"mode {name}: results are not descending [{BATCH}, {K}]")
        fin = torch.isfinite(s_) & (i_ >= 0)
        if fin.float().mean().item() < 0.99:
            fail(f"mode {name}: under 99% of the top-k slots filled")
        r = dict(recall_at_10=recall(i_), device_program_ms=wall,
                 enqueue_ms=(t_enq - t0) * 1e3, launches=counts,
                 host_syncs=count_syncs(once))
        if exact_scores:
            ex = exact_of(i_)
            r["max_rel_score_err"] = ((s_ - ex).abs()
                                      / ex.abs().clamp_min(1e-30))[fin] \
                .max().item()
            if not r["max_rel_score_err"] <= 1e-5:
                fail(f"mode {name}: scores differ from exact dots by "
                     f"{r['max_rel_score_err']} relative")
        floor = MODE_RECALL_FLOORS[name]
        log(f"phase 6 mode {name}: recall@10 {r['recall_at_10']:.4f} on {nq} "
            f"queries (floor {floor}), device program {wall:.2f} ms (enqueue "
            f"{r['enqueue_ms']:.2f} ms, {r['host_syncs']} host syncs), "
            f"launches { {n_: c for n_, c in counts.items() if c} }"
            + (f", every score the exact dot to {r['max_rel_score_err']:.3g}"
               if exact_scores else ""))
        if r["recall_at_10"] < floor:
            fail(f"mode {name}: recall@10 {r['recall_at_10']:.4f} under "
                 f"{floor}")
        modes[name] = r
        return s_, i_

    gate = GroupedParams(k=K, score_cut=64, pool=128, compute_dtype="f32",
                         ovf_pool=0, pool_mode="exact")
    s_g, i_g = run_mode("gate", gate, ("qloc", "score_grouped_f"))
    # the same program on K6's plain version: the on-device gate
    kernel_scorer = grouped.score_grouped_f
    grouped.score_grouped_f = grouped_scorer_f.score_grouped_f_plain
    try:
        s_p, i_p = search_grouped_derive(dindex, qc_t[:nq], qv_t[:nq], gate,
                                         QC, M, caps[0], caps[1],
                                         ctx.zero_region)
    finally:
        grouped.score_grouped_f = kernel_scorer
    s_k, i_k = search_grouped_derive(dindex, qc_t[:nq], qv_t[:nq], gate, QC,
                                     M, caps[0], caps[1], ctx.zero_region)
    same = id_sets_equal(i_k, i_p)
    rel = rel_err(torch.sort(s_k, 1).values, torch.sort(s_p, 1).values)
    log(f"phase 6 gate: kernel path vs plain-scorer path on {nq} queries: "
        f"id sets equal on {same:.4f}, max rel score err {rel:.3g}")
    if same < 0.98 or not rel <= 1e-4:
        fail(f"the gate configuration on K6 and on its plain version "
             f"disagree: id sets equal on {same}, score rel err {rel}")
    rec["gate_vs_plain"] = dict(id_sets_equal=same, max_rel_score_err=rel)
    run_mode("defaults", GroupedParams(k=K, pool=128),
             ("qloc", "score_grouped_f"))
    # the f32 scorer against the int8 one, both exact pool + rescore 64
    both_kw = dict(k=K, score_cut=64, pool=128, rescore=64,
                   pool_mode="exact")
    ids_fi = [search_grouped_derive(
        dindex, qc_t[:nq], qv_t[:nq], GroupedParams(compute_dtype=dt,
                                                    **both_kw),
        QC, M, caps[0], caps[1], ctx.zero_region)[1] for dt in ("f32", "i8")]
    f32_i8 = id_sets_equal(*ids_fi)
    log(f"phase 6: f32 scorer vs int8 scorer (exact pool, rescore 64): id "
        f"sets equal on {f32_i8:.4f} of {nq} queries (floor "
        f"{F32_VS_I8_FLOOR})")
    if f32_i8 < F32_VS_I8_FLOOR:
        fail(f"f32 and int8 scorers agree on {f32_i8:.4f} < "
             f"{F32_VS_I8_FLOOR} of the queries")
    rec["f32_vs_i8_id_sets_equal"] = f32_i8

    stride = GroupedParams(k=K, score_cut=64, pool=96, rescore=64,
                           compute_dtype="i8", pool_mode="stride",
                           pool_stride=8, kernel_unroll=8)
    run_mode("stride_item", stride,
             ("qloc", "score_grouped_i8_item", "pack_epilogue", "rescore"),
             exact_scores=True)
    run_mode("stride_slot", dataclasses.replace(stride, kernel_unroll=1),
             ("qloc", "score_grouped_i8", "pack_epilogue", "rescore"),
             exact_scores=True)
    run_mode("window_bf16",
             GroupedParams(k=K, score_cut=64, pool=96, rescore=64,
                           pool_mode="window"),
             ("qloc", "score_grouped_f", "pack_epilogue", "rescore"),
             exact_scores=True)
    head = headline_params()
    s_r, i_r = run_mode("rowmajor",
                        dataclasses.replace(head, qloc_mode="rowmajor"),
                        ("qloc_rowmajor", "score_grouped_i8_item", "rescore"),
                        exact_scores=True)
    s_l, i_l = search_grouped_derive(dindex, qc_t, qv_t, head, QC, M,
                                     caps[0], caps[1], ctx.zero_region)
    if not (torch.equal(i_r, i_l) and torch.equal(s_r, s_l)):
        fail("the rowmajor run's results differ from the lane-major run's")
    log("phase 6: rowmajor results equal the qloc_mode='pallas' run's, ids "
        "and scores")
    r_head = recall(i_l)

    # ---- one breakdown: the default configuration ----
    dflt = GroupedParams(k=K, pool=128)
    prog = lambda: search_grouped_derive(  # noqa: E731
        dindex, qc_t, qv_t, dflt, QC, M, caps[0], caps[1], ctx.zero_region)
    g0, n_alloc = gc_ms(), device_allocs()
    t0 = time.perf_counter()
    prog()
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    brk = dict(device_program_ms=(time.perf_counter() - t0) * 1e3,
               enqueue_ms=(t_enq - t0) * 1e3, gc_ms=gc_ms() - g0,
               cuda_mallocs=device_allocs() - n_alloc,
               host_syncs=modes["defaults"]["host_syncs"])
    try:
        prof, _ = profile_held(prog, ("score_grouped_f_kernel",))
        brk.update(prof, device_idle_share=idle_share(
            prof["device_busy_ms"], brk["device_program_ms"]))
    except NoProfile as e:  # informational only
        brk["profile"] = f"not measured: {e}"
    log(f"phase 6 breakdown of one default-configuration batch: "
        f"{json.dumps(brk)}")
    rec["breakdown"] = brk

    # ---- K9: a second upload with vocab_residue = 8 ----
    RES, SCB = 8, 16
    t0 = time.time()
    rindex = arrays.to_device(dev, tile_csub=CSUB, vocab_residue=RES)
    rec["residue_upload_s"] = time.time() - t0
    log(f"phase 6: residue upload (host permutation of the full corpus "
        f"included, no cut) {rec['residue_upload_s']:.1f} s")
    rctx = PlannerContext.from_arrays(arrays, csub=CSUB)
    if (rctx.zero_region, caps) != (ctx.zero_region,
                                    plan_caps(qc_np, qv_np, rctx, QC, M=M)):
        fail("the residue upload changed the plan's geometry")
    qcb, qvb = _residue_buckets(a1[2], a1[3], RES, SCB)
    a9 = (rindex.vocab16, a1[1], qcb, qvb, a1[2], a1[3], QC, RES, SCB)
    k9 = qloc_residue.project_qloc_residue(*a9, quantize=True)
    p9 = qloc_residue.project_qloc_residue_plain(*a9, quantize=True)
    if not (torch.equal(k9[0], p9[0]) and torch.equal(k9[1], p9[1])
            and torch.equal(qloc_residue.project_qloc_residue(*a9),
                            qloc_residue.project_qloc_residue_plain(*a9))):
        fail("K9 disagrees with its plain version")
    VRS = (V0 - V0 // 8) // RES // 8 * 8
    bucket_terms = (qcb >= 0).sum(1)
    # the former design's compare count: each group slot against its
    # bucket, each spill slot against every term
    ops9 = 2.0 * QC * float((VRS * RES * SCB * torch.ones_like(n_terms)
                             + (V0 - RES * VRS) * n_terms).sum().item())
    by9 = (torch.unique(a1[1]).numel() * V0 * 2 + P * 4 + a1[2].numel() * 8
           + qcb.numel() * 8 + P * V0 + P * 4)
    ptx9 = [ln for lns in ptxas_of("qloc", "qloc_residue_kernelIs")
            .values() for ln in lns]
    rec9 = dict(
        name="qloc_residue", route="cuda",
        source="seismic_tpu_torch/csrc/qloc.cu",
        replaces="seismic_tpu/ops/pallas_qloc.py:152", max_abs_err=0.0,
        ms=time_ms(lambda: qloc_residue.project_qloc_residue(
            *a9, quantize=True), 20),
        plain_ms=time_ms(lambda: qloc_residue.project_qloc_residue_plain(
            *a9, quantize=True), 3),
        # the bytes: each distinct vocab row once, the pair list, the
        # terms, the buckets, the int8 output and the scales
        bound_ms=by9 / PEAK_BYTES * 1e3, bound_by="bytes",
        compare_bound_ms=ops9 / PEAK_F32 * 1e3,
        library_ms=None,  # as K8: no one PyTorch call does this
        f32_output_ms=time_ms(
            lambda: qloc_residue.project_qloc_residue(*a9), 20),
        k1_ms=rec8["k1_ms"], ptxas=ptx9,
        terms_kept_by_buckets=float(bucket_terms.sum().item()
                                    / max(n_terms.sum().item(), 1)))
    rec9["k1_ratio"] = rec9["ms"] / rec9["k1_ms"]
    log(f"phase 6: K9 qloc_residue (R {RES}, scb {SCB}, VRS {VRS}): "
        f"bit-equal, {rec9['ms']:.4f} ms quantized, "
        f"{rec9['f32_output_ms']:.4f} ms f32 (K1 {rec8['k1_ms']:.4f} ms, "
        f"ratio {rec9['k1_ratio']:.3f}; bound {rec9['bound_ms']:.4f} ms by "
        f"bytes, the former compare count "
        f"{rec9['compare_bound_ms']:.4f} ms; plain "
        f"{rec9['plain_ms']:.3f} ms); the buckets keep "
        f"{rec9['terms_kept_by_buckets']:.4f} of the terms; ptxas: "
        f"{'; '.join(ptx9)}")
    del k9, p9
    res_params = dataclasses.replace(head, residue_scb=SCB)
    _, i_res = run_mode("residue", res_params,
                        ("qloc_residue", "score_grouped_i8_item", "rescore"),
                        index=rindex, exact_scores=True)
    try:  # the residue batch's device time, by kernel
        prof, _ = profile_held(lambda: search_grouped_derive(
            rindex, qc_t, qv_t, res_params, QC, M, caps[0], caps[1],
            ctx.zero_region), ("score_item_kernel",))
        modes["residue"].update(prof)
        log(f"phase 6: one residue batch keeps the card busy "
            f"{prof['device_busy_ms']} ms: {json.dumps(prof)}")
    except NoProfile as e:  # informational only
        modes["residue"]["profile"] = f"not measured: {e}"
    r_res = modes["residue"]["recall_at_10"]
    log(f"phase 6: residue recall@10 {r_res:.4f} against {r_head:.4f} "
        "unpermuted")
    if r_res < r_head - 0.03:
        fail(f"residue recall@10 {r_res:.4f} more than 0.03 under the "
             f"unpermuted run's {r_head:.4f}")
    rec["recall_at_10_headline_params"] = r_head
    del rindex
    torch.cuda.empty_cache()

    record["launch_windows"]["modes"] = total
    rec.update(launches_total=total, phase_s=time.time() - t_phase)
    log(f"phase 6: {rec['phase_s']:.1f} s, launches over its "
        f"{len(modes)} counted batches {total}")
    main5, main6 = k5["in_k4"], k6["bf16_centred"]
    rec5 = dict(
        name="pack_epilogue", route="cuda",
        source="seismic_tpu_torch/csrc/pack_epilogue.cuh",
        replaces="seismic_tpu/ops/pallas_grouped.py:204",
        max_abs_err=main5["max_abs_err"], ms=main5["ms"],
        plain_ms=main5["plain_ms"], bound_ms=main5["bound_ms"],
        bound_by=main5["bound_by"],
        # no one PyTorch call packs a row index into score bits and takes
        # a windowed integer max
        library_ms=None, measured_in="score_grouped_i8_item, pack_window 2",
        unpacked_ms=main5["unpacked_ms"], cases=k5)
    rec6 = dict(
        name="score_grouped_f", route="cuda",
        source="seismic_tpu_torch/csrc/grouped_scorer_f.cu",
        replaces="seismic_tpu/ops/pallas_grouped.py:32",
        max_abs_err=main6["max_abs_err"], ms=main6["ms"],
        plain_ms=main6["plain_ms"], bound_ms=main6["bound_ms"],
        bound_by=main6["bound_by"], library_ms=lib6, cases=k6,
        routes=routes6, sass_mix_bf16=mix6, bytes_converted=W * ROWS * V0)
    return [rec5, rec6, rec8, rec9]


# ---- phase 6b: tile widths 128 and 384 on the grouped scorers ----
# the widths, each the modes index narrowed again (512 -> 384 -> 128): every
# multiple of 128 is a width JAX's kernel takes (pallas_grouped.py:76)
WIDTHS = (384, 128)


def widths_path(env, dev, record) -> list:
    """Phase 6b, inside phase 4 after phase 11a: the modes index narrowed
    to V 384 and then 128 (`narrow_vocab`), each uploaded with csub 2 and
    searched with one B=4096 / M=8 batch on the derived plan in a counted
    window per scorer (`scorer_forms`). Returns the six kernel records
    (name@V<width>) for the `kernels` line."""
    import torch

    from seismic_tpu_torch.ops.tiles_prep import narrow_vocab
    from seismic_tpu_torch.search.planner import PlannerContext

    rec = record.setdefault("widths", {})
    t_phase = time.time()
    out, arrays = [], env["arrays"]
    for V in WIDTHS:
        t0 = time.time()
        arrays = narrow_vocab(arrays, V)
        t1 = time.time()
        dv = arrays.to_device(dev, tile_csub=CSUB)
        ctx = PlannerContext.from_arrays(arrays, csub=CSUB)
        torch.cuda.synchronize()
        t2 = time.time()
        krs, r = scorer_forms(dv, ctx, 8, CSUB, f"V{V}", f"v{V}", env, dev,
                              record, "phase 6b")
        out += krs
        rec[f"v{V}"] = dict(narrow_s=t1 - t0, upload_s=t2 - t1, **r)
        log(f"phase 6b V {V}: narrow_vocab {t1 - t0:.1f} s, upload "
            f"{t2 - t1:.1f} s")
        del dv
        gc.collect()
        torch.cuda.empty_cache()
    rec["phase_s"] = time.time() - t_phase
    log(f"phase 6b: {rec['phase_s']:.1f} s")
    return out


def scorer_forms(dv, ctx, M, csub, tag, window, env, dev, record,
                 what) -> tuple:
    """K4, K2 and K6 at the form (V, M, csub) of index `dv` (phase 6b's
    widths, phase 14's M 32 and csub 4): one B=4096 batch of env's
    queries on the derived plan in a counted window per scorer (K4: the
    headline parameters; K2: the same with kernel_unroll 1; K6:
    `GroupedParams(pool=128)`, bf16), every score of the int8 batches the
    exact dot; the three held against their plain versions on the batch's
    own operands (K2 / K4 int dots exact and 1e-6 relative, K6 1e-5 of
    the larger of score and centring term), timed beside their bounds and
    a library call, with the ptxas lines of their instances. Returns (the
    three kernel records, name@<tag>, each with its counted window
    `<window>_k4` / `_k2` / `_k6`; the form's record)."""
    import dataclasses

    import torch

    from seismic_tpu_torch.ops import (
        grouped_scorer,
        grouped_scorer_f,
        grouped_scorer_item,
        qloc,
    )
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search.grouped import (
        GroupedParams,
        _query_terms,
        derive_plan_device,
        plan_caps,
        search_grouped_derive,
    )

    qc_np, qv_np, qc_t, qv_t = (env[k_] for k_ in ("qc_np", "qv_np", "qc_t",
                                                   "qv_t"))
    docs, gt = env["docs"], env["gt"]
    nq = len(gt)
    QC, ROWS, V = QUERY_CUT, csub * SUB, dv.doc_tiles_aligned.shape[1]
    ptx = {lib: ptxas_of(lib, needle) for lib, needle in (
        ("grouped_scorer", "score_grouped_i8_kernel"),
        ("grouped_scorer_item", "score_item_kernel"),
        ("grouped_scorer_f", "score_grouped_f_kernel"))}
    # the run-time-V instances (K4's kV = 0 serves every width but M 16 at
    # V 512 and csub <= 2; K2 and K6 have no other)
    kv4 = 512 if (M == 16 and V == 512 and csub <= 2) else 0
    keys = {"grouped_scorer":
                f"score_grouped_i8_kernelILi{M}ELi{ROWS}ELb0E",
            "grouped_scorer_item":
                f"score_item_kernelILi{M}ELi{ROWS}ELi{kv4}ELb0E",
            "grouped_scorer_f":
                f"score_grouped_f_kernelILi{M}ELi{ROWS}ELi1ELb0E"}
    ptx_lines = {lib: [ln for f_, lns in ptx[lib].items() if keys[lib] in f_
                       for ln in lns] for lib in ptx}
    for lib, lns in ptx_lines.items():
        if not lns:
            fail(f"{what}: no ptxas report of {keys[lib]}")
        log(f"{what}: ptxas {keys[lib]}: {'; '.join(lns)}")
    caps = plan_caps(qc_np, qv_np, ctx, QC, M=M)
    k4p = headline_params()
    runs = {}
    for short, params, positive in (
            ("k4", k4p, ("qloc", "score_grouped_i8_item", "rescore")),
            ("k2", dataclasses.replace(k4p, kernel_unroll=1),
             ("qloc", "score_grouped_i8", "rescore")),
            ("k6", GroupedParams(k=K, pool=128),
             ("qloc", "score_grouped_f"))):
        def once(p_=params):
            return search_grouped_derive(dv, qc_t, qv_t, p_, QC, M,
                                         caps[0], caps[1], ctx.zero_region)
        once()  # warm-up
        (s_, i_), wall, counts = counted(
            f"{what} {tag} {short}", f"{window}_{short}", record, once,
            positive=positive)
        fin = torch.isfinite(s_) & (i_ >= 0)
        if fin.float().mean().item() < 0.99:
            fail(f"{what} {tag} {short}: under 99% of the top-k slots "
                 "filled")
        r = dict(recall_at_10=recall_at(gt, i_[:nq]), wall_ms=wall,
                 launches={n_: c for n_, c in counts.items() if c})
        if short != "k6":  # rescore 64: every score the exact dot
            r["max_rel_score_err"] = exact_scores_err(docs, qc_t, qv_t,
                                                      s_, i_)
            if not r["max_rel_score_err"] <= 1e-5:
                fail(f"{what} {tag} {short}: scores differ from the exact "
                     f"dots by {r['max_rel_score_err']}")
        runs[short] = r
        log(f"{what} {tag} {short}: recall@10 {r['recall_at_10']:.4f} on "
            f"{nq} queries, {wall:.2f} ms, launches {r['launches']}")

    # ---- the scorers against their plain versions on the batch's
    # operands: the derived plan, K1's projections, qsum ----
    dp = derive_plan_device(dv, qc_t, qv_t, QC, M, caps[0], caps[1],
                            ctx.zero_region)
    G, W = int(dp.G), int(dp.W)
    G_cap = dp.slot_b.shape[0]
    LLMAX = ll_pad_for(dv.max_list_len, csub)
    top_c, top_v, sc = _query_terms(qc_t, qv_t, 64)
    a1 = (dv.vocab16, dp.pair_list.reshape(-1).contiguous(),
          top_c[:, :sc].contiguous(), top_v[:, :sc].contiguous(), QC)
    q8p, _ = qloc.project_qloc_quantize(*a1)
    qfp = qloc.project_qloc_f32(*a1)
    slot = dp.slot_pair.long()
    q8 = q8p[slot].reshape(G_cap, M, V).contiguous()
    qf = qfp[slot].reshape(G_cap, M, V).contiguous()
    qsum = (128.0 * qfp.sum(-1))[slot].reshape(G_cap, M).contiguous()
    tiles, tscale = dv.doc_tiles_aligned, dv.tile_scale
    wr, wg, ws = dp.work_region, dp.work_g, dp.work_s
    wgl, wsl = wg[:W].long(), ws[:W].long()
    n_regions = torch.unique(wr[:W]).numel()
    tile_bytes = n_regions * ROWS * (V + 4)
    ops = 2.0 * W * M * ROWS * V

    def covered(o):
        return o.view(G_cap, M, LLMAX // ROWS, ROWS)[wgl, :, wsl, :]

    def rel_err(k, p):
        return float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())

    # K4 (item-major) and K2 (slot-major): int dots exact, 1e-6
    a4 = (tiles, tscale, q8, wr, wg, csub)
    a2 = (tiles, tscale, q8, wr, wg, ws, LLMAX, csub)
    ones = torch.ones_like(tscale)
    dots = grouped_scorer.grouped_dots_plain(
        tiles, q8, wr[:W], wg[:W], rows_per_item=ROWS).to(torch.float32)
    k4o = grouped_scorer_item.score_grouped_i8_item(*a4)[:W]
    p4o = grouped_scorer_item.score_grouped_i8_item_plain(*a4)[:W]
    d4 = grouped_scorer_item.score_grouped_i8_item(
        tiles, ones, *a4[2:])[:W]
    k2o = covered(grouped_scorer.score_grouped_i8(*a2))
    p2o = covered(grouped_scorer.score_grouped_i8_plain(*a2))
    d2 = covered(grouped_scorer.score_grouped_i8(tiles, ones, *a2[2:]))
    checks = {"score_grouped_i8_item": (rel_err(k4o, p4o),
                                        torch.equal(d4, dots),
                                        (k4o - p4o).abs().max()),
              "score_grouped_i8": (rel_err(k2o, p2o),
                                   torch.equal(d2, dots),
                                   (k2o - p2o).abs().max())}
    del k4o, p4o, d4, k2o, p2o, d2, dots
    for name, (rel, dots_ok, _) in checks.items():
        if not (dots_ok and rel <= 1e-6):
            fail(f"{what} {tag}: {name} disagrees with its plain version "
                 f"(int dots equal {dots_ok}, max rel err {rel})")
    # K6, bf16 centred (as the search calls it): 1e-5 of the larger of
    # the score and the centring term
    a6 = (tiles, tscale, qf, qsum, wr, wg, ws, LLMAX, csub, "bf16")
    k6o = covered(grouped_scorer_f.score_grouped_f(*a6))
    p6o = covered(grouped_scorer_f.score_grouped_f_plain(*a6))
    mag = (qsum[wgl][:, :, None]
           * tscale[wr[:W].long()[:, None] * ROWS
                    + torch.arange(ROWS, device=dev)][:, None, :])
    err6 = (k6o - p6o).abs()
    tol6 = 1e-5 * torch.maximum(mag.abs(), p6o.abs())
    if not (err6 <= tol6).all():
        fail(f"{what} {tag}: score_grouped_f disagrees, max abs err "
             f"{err6.max().item()}")
    checks["score_grouped_f"] = (
        float((err6 / tol6.clamp_min(1e-30)).max()), True, err6.max())
    del k6o, p6o, err6, tol6, mag

    # library yardstick of the int8 scorers: one int8 tensor-core product
    # of the same operation count over the same gathered rows
    rows = (wr[:W].long()[:, None] * ROWS
            + torch.arange(ROWS, device=dev)).reshape(-1)
    A = tiles[rows].view(torch.int8)
    lib_i8 = time_ms(lambda: torch._int_mm(A, q8[0].t()), 10)
    del A
    Ab = tiles[rows].to(torch.bfloat16)
    lib_bf16 = time_ms(lambda: torch.matmul(
        Ab, qf[0].t().to(torch.bfloat16).contiguous()), 10)
    del Ab, rows
    out = []
    for name, src, row, fn, plain, args, by, peak, lib, lib_name in (
            ("score_grouped_i8_item", "grouped_scorer_item.cu", 326,
             grouped_scorer_item.score_grouped_i8_item,
             grouped_scorer_item.score_grouped_i8_item_plain, a4,
             tile_bytes + G * M * V + W * 8 + W * M * ROWS * 4,
             PEAK_INT8, lib_i8, "torch._int_mm"),
            ("score_grouped_i8", "grouped_scorer.cu", 231,
             grouped_scorer.score_grouped_i8,
             grouped_scorer.score_grouped_i8_plain, a2,
             tile_bytes + G * M * V + W * 12 + W * M * ROWS * 4,
             PEAK_INT8, lib_i8, "torch._int_mm"),
            ("score_grouped_f", "grouped_scorer_f.cu", 32,
             grouped_scorer_f.score_grouped_f,
             grouped_scorer_f.score_grouped_f_plain, a6,
             tile_bytes + G * M * V * 4 + G * M * 4 + W * 12
             + W * M * ROWS * 4, PEAK_BF16, lib_bf16, "torch.matmul")):
        b_ms, b_by = bound(by, ops, peak)
        err, _, abs_err = checks[name]
        lib_key = {"score_grouped_i8_item": "grouped_scorer_item",
                   "score_grouped_i8": "grouped_scorer",
                   "score_grouped_f": "grouped_scorer_f"}[name]
        short = {"score_grouped_i8_item": "k4", "score_grouped_i8": "k2",
                 "score_grouped_f": "k6"}[name]
        kr = dict(
            name=f"{name}@{tag}", route="cuda",
            source=f"seismic_tpu_torch/csrc/{src}",
            replaces=f"seismic_tpu/ops/pallas_grouped.py:{row}",
            max_abs_err=float(abs_err), ms=time_ms(lambda: fn(*args), 10),
            plain_ms=time_ms(lambda: plain(*args), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            library=lib_name, V=V, csub=csub, M=M, W=W, G=G,
            distinct_super_tiles=n_regions, bytes=by, ops=ops,
            window=f"{window}_{short}", ptxas=ptx_lines[lib_key],
            **({"max_rel_err": err} if name != "score_grouped_f"
               else {"max_err_over_tol": err}))
        out.append(kr)
        log(f"{what} {tag}: {name}: ok (max abs err {kr['max_abs_err']:.3g}"
            f"), {kr['ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}, plain "
            f"{kr['plain_ms']:.3f} ms, {lib_name} {lib:.4f} ms)")
    r = dict(device_index_bytes=dv.nbytes(), G=G, W=W, runs=runs)
    del tiles, tscale, q8, qf, qsum, a2, a4, a6, dp
    return out, r


# ---- phase 14: the probe drivers ----
# recall@10 of each rung of JAX's probe_r5b record with a recall
# (BENCH_STAGE_r5.json: the same labels, data, shapes and parameters, run
# on its TPU): the port's rung must reach it less R5B_RECALL_TOL
R5B_JAX_RECALL = {
    "base_hier_qc13_p96r64": 0.9701, "stride8_exact_qc13_p96r64": 0.9448,
    "stride8_approx_qc13_p96r64": 0.9448,
    "rowmajor_qloc_qc13_p96r64": 0.9701, "sc48_qc13_p96r64": 0.9662,
    "ddpost_qc13_p96r64": 0.9693, "pdt_hier_qc13_p96r64": 0.97,
    "pdt_ddpost_qc13_p96r64": 0.9693, "pdt_ddpost_qc14_p96r64": 0.9709,
    "pdt_ddpost_pr90_qc14_p96r64": 0.9689, "m32_hier_qc13_p96r64": 0.9701,
    "m32_pdt_ddpost_qc13_p96r64": 0.9693,
    "seg32_pdt_ddpost_qc13_p96r64": 0.9726,
    "seg128_pdt_ddpost_qc13_p96r64": 0.9726,
    "seg32a_pdt_ddpost_qc13_p96r64": 0.9726,
    "seg32_pdt_ddpost_qc14_p96r64": 0.9741, "seg32_pdt_qc13_p96r64": 0.9737,
    "knn16top4_qc12_p96r64": 0.9708, "knn16top2_qc12_p96r64": 0.9696,
    "knn16top4_qc13_p96r64": 0.9731, "knn16top2_ddpost_qc12_p96r64": 0.9689,
    "knn16top4_ddpost_qc12_p96r64": 0.9701,
}
R5B_RECALL_TOL = 0.01
# the rungs of all nine families (probe_r5b.py; JAX's record lacks grid2,
# 2pass, csub4 and knn16top0)
R5B_RUNGS = 38
# the cut drivers' cuts (PERF.md §4): the queue's 100k cache, r5c's 1M
# recipe and r3j's 8.8M build at these many documents (the queue at the
# stream's first QUEUE_CUT_QUERIES queries); the sweep's repetitions
QUEUE_CUT_DOCS, QUEUE_CUT_QUERIES = 2000, 2048
R5C_CUT_DOCS, R3J_CUT_DOCS, SWEEP_REPS = 2000, 5000, 2
QUEUE = os.path.join(ROOT, "seismic_tpu_torch", "harness", "run_r5_queue.sh")
# the JAX package's records at the repo root, which no driver may touch
JAX_RECORDS = ("BENCH_STAGE_r5.json", "SCALE_BENCH.json",
               "SCALE88_BENCH.json", os.path.join("experiments", "grid_synth"))


def tree_digest(path: str) -> str:
    """sha1 over the names and bytes of a file or of every file under a
    directory ("" when missing)."""
    import hashlib

    if not os.path.exists(path):
        return ""
    h = hashlib.sha1()
    files = ([path] if os.path.isfile(path) else sorted(
        os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs))
    for f in files:
        h.update(os.path.relpath(f, path).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


class env_vars:
    """Environment variables set (None: removed) inside a `with`."""

    def __init__(self, **kv):
        self.kv, self.old = kv, {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.old[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def drivers_protocol(n_docs: int, cache: str):
    """The drivers' protocol (harness/protocol.py) at the corpus's count:
    the file names phase 14's cache takes."""
    from seismic_tpu_torch.harness import protocol

    return protocol.Protocol(n_docs=n_docs, cache=cache)


def drivers_path(env, dev, record) -> list:
    """Phase 14, inside phase 4 after the aligned-tile cache, which wrote
    the `_nw512` dir and its aligned layout into env's `cache`: the probe
    drivers through their `main(argv)` on the card (see the module
    docstring). Returns the kernel records of K4, K2 and K6 at M 32 and
    csub 4 (name@M32, name@csub4) for the `kernels` line."""
    import shutil

    import torch

    from seismic_tpu_torch.harness import (
        build_88m,
        probe_r3j,
        probe_r5b,
        probe_r5c,
        protocol,
        rebuild_r3_cache,
        sweep_configs,
    )
    from seismic_tpu_torch.search.grouped import (
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.search.planner import PlannerContext

    rec = record.setdefault("drivers", {})
    t_phase = time.time()
    before = {f: tree_digest(os.path.join(ROOT, f)) for f in JAX_RECORDS}
    for f in ("bench_stage_r5.json", "scale_bench.json",
              "scale88_bench.json", "grid_synth", "r5queue"):
        path = os.path.join(OUT_DIR, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    windows = record["launch_windows"]
    ds = env["ds"]
    n = len(ds)
    krs = []

    def window(key, fn):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        windows[key] = read_launches()
        rec[f"{key}_s"] = time.time() - t0
        return out

    def need(key, *names):
        for n_ in names:
            if not windows[key].get(n_, 0) > 0:
                fail(f"phase 14 {key}: {n_} never launched: {windows[key]}")

    cache = env["cache"]
    with env_vars(BENCH_N_DOCS=str(n), R3_CACHE_CPU_ONLY=None,
                  R5C_FWD16=None):
        p = protocol.from_env(cache=cache)
        if p != drivers_protocol(n, cache):
            fail(f"phase 14: the drivers' protocol {p} is not the cells'")
        # ---- (a) the cache, from phases 3 / 4: the corpus, the f32
        # index (its `_nw512` dir and aligned layout phase 4 wrote), the
        # ground truth of the 16,384 protocol queries (the first 2048 the
        # sweep's) ----
        t0 = time.time()
        np.savez(os.path.join(cache, f"docs_{n}_{DIM}.npz"),
                 offsets=ds.offsets, components=ds.components,
                 values=ds.values)
        env["full"].save_dir(p.index_base + ".dir")
        np.savez(p.gt_path(N_QUERIES), ids=env["gt"])
        np.savez(p.gt_path(2048), ids=env["gt"][:2048])
        # the knn16 graph as rebuild_r3_cache makes it: the engine's
        # self-search on a csub-1 upload of the v1024 index (K7)
        from seismic_tpu_torch.search import knn as knn_mod

        ix1 = env["full"].to_device(dev)
        graph16 = window("knn16", lambda: knn_mod.build_knn(
            env["full"], ix1, 16, batch_size=1024))
        knn_mod.save_knn(graph16, p.index_base + ".knn16")
        need("knn16", "score_tiles")
        del ix1, graph16
        gc.collect()
        torch.cuda.empty_cache()
        rec["cache_s"] = time.time() - t0

        # ---- (b) the queue at its cut (a cache of its own):
        # c100k (the corpus, index, ground truth, 1024 subset, _nw512,
        # _nw768, knn16: K7), then r5b_grid2 ----
        t0 = time.time()
        qdir = os.path.join(OUT_DIR, "r5queue")
        qcache = os.path.join(cache, "queue")
        r = subprocess.run(
            ["bash", QUEUE, "c100k", "r5b_grid2"],
            env=dict(os.environ, CACHE_DIR=qcache, LOGDIR=qdir,
                     PYTHON=sys.executable,
                     BENCH_N_DOCS=str(QUEUE_CUT_DOCS),
                     BENCH_N_QUERIES=str(QUEUE_CUT_QUERIES)),
            capture_output=True, text=True, timeout=900)
        rec["queue_s"] = time.time() - t0
        qlog = open(os.path.join(qdir, "queue.log")).read()
        c100k_log = open(os.path.join(qdir, "c100k.log")).read()
        if r.returncode != 0 or any(f"stage {st}: OK" not in qlog
                                    for st in ("c100k", "r5b_grid2")):
            fail(f"phase 14 queue: rc {r.returncode}\n{qlog}\n{r.stderr}"
                 f"\n{c100k_log[-2000:]}")
        built = re.findall(r"done, built \[(.*)\]", c100k_log)
        if not built or any(b_ not in built[-1] for b_ in (
                "docs", "index", "gt", "nw512", "nw768", "knn16")):
            fail(f"phase 14 c100k built {built}, not the whole cache")
        # the queue's record, beside its logs: the full-size run below
        # writes its own
        rpath = os.path.join(OUT_DIR, "bench_stage_r5.json")
        with open(rpath) as f:
            qrows = [r_["label"] for r_ in json.load(f)["rungs"]]
        os.replace(rpath, os.path.join(qdir, "bench_stage_r5.json"))
        if len(qrows) != 4:
            fail(f"phase 14 queue: r5b_grid2 wrote {qrows}")
        rec["queue"] = dict(built=built[-1], grid2=qrows)
        log(f"phase 14 queue ({QUEUE_CUT_DOCS} docs, {QUEUE_CUT_QUERIES} "
            f"queries): c100k and r5b_grid2 OK in {rec['queue_s']:.1f} s; "
            f"c100k built [{built[-1]}]")

        # ---- (c) probe_r5b at full size in this process: every family,
        # m32 and csub4 each in a counted window of its own ----
        r5b = {}
        for key, fams in (("r5b", [f for f in probe_r5b.FAMILIES
                                   if f not in ("m32", "csub4")]),
                          ("r5b_m32", ["m32"]), ("r5b_csub4", ["csub4"])):
            r5b[key] = window(key, lambda f_=fams: probe_r5b.main(
                f_ + ["--cache-dir", cache]))
        need("r5b", "qloc", "score_grouped_i8_item", "rescore",
             "qloc_rowmajor", "pack_epilogue", "score_grouped_i8")
        need("r5b_m32", "score_grouped_i8_item")
        need("r5b_csub4", "score_grouped_i8_item", "pack_epilogue")
        with open(os.path.join(OUT_DIR, "bench_stage_r5.json")) as f:
            rows = {r_["label"]: r_ for r_ in json.load(f)["rungs"]}
        if len(rows) != R5B_RUNGS:
            fail(f"phase 14 r5b: {len(rows)} rungs recorded, not "
                 f"{R5B_RUNGS}: {sorted(rows)}")
        low = {lb: (rows[lb]["recall_at_10"], ref) for lb, ref in
               R5B_JAX_RECALL.items()
               if not rows[lb]["recall_at_10"] >= ref - R5B_RECALL_TOL}
        if low:
            fail(f"phase 14 r5b: recall@10 under JAX's less "
                 f"{R5B_RECALL_TOL}: {low}")
        for lb, kern in (("m32_hier_qc13_p96r64", "score_grouped_i8_item"),
                         ("csub4_hier_qc13_p96r64", "score_grouped_i8_item"),
                         ("csub4_stride8_qc13_p96r64", "pack_epilogue"),
                         ("b1_exact_ddpost_u1", "score_grouped_i8"),
                         ("rowmajor_qloc_qc13_p96r64", "qloc_rowmajor"),
                         ("knn16top4_qc12_p96r64", "rescore")):
            if not rows[lb]["launches"].get(kern, 0) > 0:
                fail(f"phase 14 r5b: {lb} launched no {kern}: "
                     f"{rows[lb]['launches']}")
        # the driver adds nothing: its base rung is a direct call's
        gc16, wc16 = plan_caps(env["q_comps"], env["q_vals"], env["ctx"], 13,
                               M=16)
        _, i_d = search_grouped_derive(
            env["dindex"], env["qcB"], env["qvB"], probe_r5b.base_params(),
            13, 16, gc16, wc16, env["ctx"].zero_region)
        if not np.array_equal(i_d.cpu().numpy(),
                              r5b["r5b"]["ids"]["base_hier_qc13_p96r64"]):
            fail("phase 14 r5b: the base rung's ids differ from a direct "
                 "search_grouped_derive call's")
        rec["r5b"] = {lb: {k_: r_.get(k_) for k_ in (
            "recall_at_10", "ms_per_batch", "qps", "ms_per_call", "csub",
            "M", "launches", "stage_ms_cum", "flagged")}
            for lb, r_ in rows.items()}
        log("phase 14 r5b: " + json.dumps(
            {lb: (r_.get("recall_at_10"), r_.get("qps") or
                  r_.get("ms_per_call")) for lb, r_ in rows.items()}))

        # ---- (d) K4, K2 and K6 at M 32 (phase 4's csub-2 index) and at
        # csub 4 (the same arrays uploaded with tile_csub=4) ----
        fenv = dict(env, gt=env["gt"][:256])
        krs += scorer_forms(env["dindex"], env["ctx"], 32, CSUB, "M32",
                            "m32", fenv, dev, record, "phase 14")[0]
        dv4 = env["arrays"].to_device(dev, tile_csub=4)
        ctx4 = PlannerContext.from_arrays(env["arrays"], csub=4)
        krs += scorer_forms(dv4, ctx4, BIG_M, 4, "csub4", "csub4", fenv,
                            dev, record, "phase 14")[0]
        del dv4, ctx4
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (e) probe_r5c at its cut: the 1m cache, the lever family,
        # then lean16 on the half-width rows (K3's f16 form) ----
        c5 = os.path.join(cache, "r5c")
        t0 = time.time()
        built5 = rebuild_r3_cache.main(["1m", "--n-docs", str(R5C_CUT_DOCS),
                                        "--cache-dir", c5])["built"]
        rec["r5c_cache_s"] = time.time() - t0
        with env_vars(BENCH_N_DOCS=str(R5C_CUT_DOCS)):
            o5 = window("r5c", lambda: probe_r5c.main(
                [str(V0), "lever", "--cache-dir", c5]))
            with env_vars(R5C_FWD16="1"):
                o16 = window("r5c_lean16", lambda: probe_r5c.main(
                    [str(V0), "lean16", "--cache-dir", c5]))
        need("r5c", "qloc", "score_grouped_i8_item", "rescore")
        need("r5c_lean16", "qloc", "score_grouped_i8_item", "rescore_f16")
        rows5 = o5["rows"] + o16["rows"]
        if len(rows5) != 8 or not all(
                0.5 < r_["recall_at_10"] <= 1.0 for r_ in rows5):
            fail(f"phase 14 r5c: {rows5}")
        rec["r5c"] = dict(built=built5, device_bytes=o5["device_bytes"],
                          rows=rows5)
        log(f"phase 14 r5c ({R5C_CUT_DOCS} docs): " + json.dumps(
            {r_["label"]: (r_["recall_at_10"], r_["qps"]) for r_ in rows5}))

        # ---- (f) probe_r3j at its cut on build_88m's cache ----
        c88 = os.path.join(cache, "b88")
        t0 = time.time()
        build_88m.build(n_docs=R3J_CUT_DOCS, cache_dir=c88)
        rec["b88_s"] = time.time() - t0
        with env_vars(B88_N_DOCS=str(R3J_CUT_DOCS)):
            o3 = window("r3j", lambda: probe_r3j.main(
                [str(V0), "--cache-dir", c88]))
        need("r3j", "qloc", "rescore_u8")
        if not (windows["r3j"]["score_grouped_i8_item"]
                or windows["r3j"]["score_grouped_i8"]):
            fail(f"phase 14 r3j: no int8 scorer launched: {windows['r3j']}")
        if len(o3["rows"]) != 8 or not all(
                0.5 < r_["recall_at_10"] <= 1.0 for r_ in o3["rows"]):
            fail(f"phase 14 r3j: {o3['rows']}")
        rec["r3j"] = dict(device_bytes=o3["device_bytes"], rows=o3["rows"])
        log(f"phase 14 r3j ({R3J_CUT_DOCS} docs): " + json.dumps(
            [(r_["qc"], r_["pool"], r_["recall_at_10"], r_["qps"])
             for r_ in o3["rows"]]))

        # ---- (g) the sweep on the v1024 index with the graph of (a) ----
        srows = window("sweep", lambda: sweep_configs.main(
            ["--index", p.index_base + ".dir", "--gt", p.gt_path(2048),
             "--reps", str(SWEEP_REPS)]))
        need("sweep", "qloc", "score_grouped_i8", "rescore")
        names = sorted(os.listdir(os.path.join(OUT_DIR, "grid_synth")))
        committed = sorted(os.listdir(os.path.join(ROOT, "experiments",
                                                   "grid_synth")))
        if names != committed or not all(
                0.5 < r_["recall_at_10"] <= 1.0 for r_ in srows):
            fail(f"phase 14 sweep: directories {names} against {committed};"
                 f" {srows}")
        rec["sweep"] = srows
        log("phase 14 sweep: " + json.dumps(
            [(r_["query_cut"], r_["n_knn"], round(r_["recall_at_10"], 4),
              round(r_["us_per_query"], 2)) for r_ in srows]))

    after = {f: tree_digest(os.path.join(ROOT, f)) for f in JAX_RECORDS}
    if after != before:
        fail(f"phase 14: a JAX record at the repo root changed: {before} -> "
             f"{after}")
    rec["phase_s"] = time.time() - t_phase
    log(f"phase 14: {rec['phase_s']:.1f} s ({json.dumps({k_: round(v, 1) for k_, v in rec.items() if k_.endswith('_s')})})")
    return krs


# ---- phase 10: the rest of the grouped search ----
# the hashed tile width of the JAX repo's bench (bench.py:63: HASH_V = V_CAP)
HASH_V = V_CAP
# the two-pass driver's deep pass: a deeper pool and rescore over 20 lists
TWOPASS_QC2, TWOPASS_POOL2, TWOPASS_RESCORE2 = 20, 256, 128
STREAM_FRACS = (0.75, 0.5)
# the kernel path agrees with the plain-scorer path on this share of id
# sets, as phase 6's gate
GATE_SHARE = 0.98


def id_set_share(a, b) -> float:
    """Share of rows of ids a and b [B, k] (tensors) with equal id sets."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.mean([set(x[x >= 0].tolist()) == set(y[y >= 0].tolist())
                          for x, y in zip(a, b)]))


def exact_scores_err(docs, qc_t, qv_t, s_, i_) -> float:
    """Largest relative distance of the finite scores s_ [B, k] from the
    exact dots of their documents i_."""
    import torch

    fin = torch.isfinite(s_) & (i_ >= 0)
    ex = exact_of(docs, qc_t, qv_t, i_.clamp_min(0))
    return max_rel_err(s_[fin], ex[fin])


def counted(what: str, key: str, record, fn, positive, exact=None):
    """fn() between a zero and a read of all twenty-five launch counts, held
    to `positive` / `exact`; the counts go to record's window `key`.
    Returns (fn's output, wall ms with a synchronise, the counts)."""
    import torch

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = hold_launches(what, read_launches(), positive=positive,
                           exact=exact)
    record["launch_windows"][key] = counts
    return out, wall, counts


def busy_of(fn, wanted) -> dict:
    """Device busy ms by kernel of one call of fn (a profiler window read
    only where it holds `wanted`), or "not measured"."""
    try:
        prof, _ = profile_held(fn, wanted, top=8)
        return prof
    except NoProfile as e:
        return {"profile": f"not measured: {e}"}


def grouped_rest_path(env, dev, record, kernels) -> dict:
    """Phase 10 (a)-(d), inside phase 4 on its index and queries: hashed
    tiles, the streaming budget, the weighted list cut, the margin and the
    two-pass driver. Returns its record."""
    import dataclasses

    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT
    from seismic_tpu_torch.ops import grouped_scorer_item, tiles_prep
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search import grouped
    from seismic_tpu_torch.search.grouped import (
        _query_terms,
        derive_plan_device,
        hashed_qloc_operands,
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped
    from seismic_tpu_torch.search.twopass import (
        TwoPassParams,
        search_batch_twopass,
    )

    rec = record.setdefault("rest", {})
    t_phase = time.time()
    arrays, dindex, ctx, docs = (env[k_] for k_ in (
        "arrays", "dindex", "ctx", "docs"))
    q_comps, q_vals, qcB, qvB = (env[k_] for k_ in (
        "q_comps", "q_vals", "qcB", "qvB"))
    qc0, qv0, qct0, qvt0 = (env[k_] for k_ in ("qc_np", "qv_np", "qc_t",
                                               "qv_t"))
    gt = env["gt"]
    params = headline_params()
    QC, hand = QUERY_CUT, ("qloc_kernel", "rescore_fused_kernel")

    def recall(ids):  # against phase 4's product, the rows of `ids`
        return recall_at(gt[:len(ids)], ids.cpu().numpy())

    rec4_b0 = recall(env["ids_headline"])

    # ---- (a) hashed tiles: the retile on the card, the upload ----
    t0 = time.perf_counter()
    harr = tiles_prep.hash_retile_torch(arrays, HASH_V, device=dev)
    torch.cuda.synchronize()
    retile_s = time.perf_counter() - t0
    # bit for bit the NumPy version's, on the first and the last chunk of
    # posting rows
    H = tiles_prep.hash_docs(arrays, HASH_V)
    posts = np.asarray(arrays.postings)
    total = int((np.asarray(arrays.list_post_start, np.int64)
                 + np.asarray(arrays.list_len)).max())
    for s0 in sorted({0, max(0, total - 65536)}):
        s1 = min(total, s0 + 65536)
        codes, sc = tiles_prep.hash_quantize_rows(H[posts[s0:s1]])
        if not (np.array_equal(codes, harr.doc_tiles[s0:s1])
                and np.array_equal(sc.view(np.int32),
                                   harr.doc_tile_scale[s0:s1].view(
                                       np.int32))):
            fail(f"phase 10a: hash_retile_torch differs from the NumPy "
                 f"hash_retile on posting rows {s0}:{s1}")
    del H
    t0 = time.perf_counter()
    hindex = harr.to_device(dev, tile_csub=CSUB, tile_hash=HASH_V)
    hctx = PlannerContext.from_arrays(harr, csub=CSUB)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del harr
    if hindex.vocab16 is not None or hindex.tile_hash != HASH_V:
        fail("phase 10a: the hashed upload holds a vocabulary or no "
             "tile_hash")
    log(f"phase 10a: hash_retile_torch(V={HASH_V}) {retile_s:.2f} s on the "
        f"card (bit-equal to the NumPy version on two chunks of 65536 "
        f"posting rows), upload csub {CSUB} {upload_s:.2f} s, device bytes "
        f"{hindex.nbytes()} (phase 4's index {dindex.nbytes()})")

    # K1's hashed call on the batch's own operands, bit for bit
    top_c, top_v, sc = _query_terms(qct0, qvt0, params.score_cut)
    ops = hashed_qloc_operands(HASH_V, top_c[:, :sc], top_v[:, :sc])
    k1h, _ = check_k1(ops, "hashed b4096")
    qch = ops[2]
    srt = torch.sort(qch, dim=1).values
    rep = ((srt[:, 1:] == srt[:, :-1])
           & (srt[:, 1:] != int(PAD_COMPONENT))).any(1).float().mean().item()
    k1h["rows_with_a_repeated_id"] = rep
    kernels[0]["at_hashed"] = k1h
    log(f"phase 10a: K1 on the hashed batch's operands ([{qch.shape[0]}, "
        f"{qch.shape[1]}] terms over one vocab row of {HASH_V}): bit-exact "
        f"in its three entry points; {rep:.4f} of the rows repeat an id; "
        f"{k1h['ms']:.4f} ms (bound {k1h['bound_ms']:.4f} ms, plain "
        f"{k1h['plain_ms']:.3f} ms)")

    # the batch and the big call on the derived plan
    caps_h = plan_caps(qc0, qv0, hctx, QC, M=8)
    caps_hB = plan_caps(q_comps, q_vals, hctx, QC, M=BIG_M)

    def hashed_b4096():
        return search_grouped_derive(hindex, qct0, qvt0, params, QC, 8,
                                     *caps_h, hctx.zero_region)

    def hashed_big():
        return search_grouped_derive(hindex, qcB, qvB, params, QC, BIG_M,
                                     *caps_hB, hctx.zero_region)

    hashed_b4096(), hashed_big()  # warm-up
    ((s_h4, i_h4), (s_h16, i_h16)), wall_h, counts_h = counted(
        "phase 10a: the hashed headline", "hashed", record,
        lambda: (hashed_b4096(), hashed_big()),
        positive=("qloc", "score_grouped_i8_item", "rescore"))
    err_h = max(exact_scores_err(docs, qct0, qvt0, s_h4, i_h4),
                exact_scores_err(docs, qcB, qvB, s_h16, i_h16))
    if not err_h <= 1e-5:
        fail(f"phase 10a: hashed scores differ from exact dots by {err_h}")
    # the kernel path against the plain-scorer path on 256 queries
    n_g = 256
    caps_g = plan_caps(qc0[:n_g], qv0[:n_g], hctx, QC, M=8)
    args_g = (hindex, qct0[:n_g], qvt0[:n_g], params, QC, 8, *caps_g,
              hctx.zero_region)
    s_k, i_k = search_grouped_derive(*args_g)
    kernel_scorer = grouped.score_grouped_i8_item
    grouped.score_grouped_i8_item = \
        grouped_scorer_item.score_grouped_i8_item_plain
    try:
        s_p, i_p = search_grouped_derive(*args_g)
    finally:
        grouped.score_grouped_i8_item = kernel_scorer
    same_h = id_set_share(i_k, i_p)
    if same_h < GATE_SHARE:
        fail(f"phase 10a: the hashed kernel path and the plain-scorer path "
             f"share id sets on {same_h} of {n_g} queries")
    r_h4, r_h16 = recall(i_h4), recall(i_h16)
    busy_h = busy_of(hashed_big, hand + ("score_item_kernel",))
    rec["hashed"] = dict(
        V=HASH_V, retile_s=retile_s, upload_s=upload_s,
        device_index_bytes=hindex.nbytes(),
        headline_device_index_bytes=dindex.nbytes(),
        recall_at_10_b4096=r_h4, recall_at_10_b16384=r_h16,
        headline_recall_at_10_b4096=rec4_b0,
        headline_recall_at_10_b16384=env["rec16"], max_rel_score_err=err_h,
        kernel_vs_plain_id_sets=same_h, wall_ms_b4096_and_b16384=wall_h,
        launches=counts_h, busy_b16384=busy_h,
        plans={"b4096": caps_h, "b16384": caps_hB})
    log(f"phase 10a: hashed headline: recall@10 {r_h4:.4f} (B={BATCH} "
        f"batch 0; the truncated tiles' {rec4_b0:.4f}) and {r_h16:.4f} "
        f"(B={N_QUERIES}; theirs {env['rec16']:.4f}); scores exact to "
        f"{err_h:.3g}; kernel vs plain-scorer path id sets equal on "
        f"{same_h:.4f} of {n_g}; launches {counts_h}; one B={N_QUERIES} "
        f"call's device time by kernel {json.dumps(busy_h)}")
    del hindex
    torch.cuda.empty_cache()

    # ---- (b) the streaming budget on phase 4's index with super bounds
    t0 = time.perf_counter()
    sindex = arrays.to_device(dev, tile_csub=CSUB, super_summaries=True)
    torch.cuda.synchronize()
    sup_upload_s = time.perf_counter() - t0
    # the card's bounds equal the same function's on the CPU (which the
    # CPU tests hold to the JAX package's NumPy) on 1024 super-tiles
    n_r = min(1024, sindex.super_summary.shape[0]) * CSUB * SUB
    c_cpu, s_cpu = tiles_prep.super_tile_summaries(
        sindex.doc_tiles_aligned[:n_r].cpu(), sindex.tile_scale[:n_r].cpu(),
        CSUB)
    if not (torch.equal(c_cpu, sindex.super_summary[:len(c_cpu)].cpu())
            and torch.equal(s_cpu, sindex.super_scale[:len(s_cpu)].cpu())):
        fail("phase 10b: the super-tile bounds differ between the card and "
             "the CPU")
    caps0 = plan_caps(qc0, qv0, ctx, QC, M=8)
    seen = {}
    k2 = grouped.score_grouped_i8

    def keeping(*a, **kw):  # the work items the scorer is given
        seen["work_region"] = a[3]
        return k2(*a, **kw)

    def stream(frac):
        p_ = dataclasses.replace(params, kernel_unroll=1, stream_frac=frac)
        return search_grouped_derive(sindex, qct0, qvt0, p_, QC, 8, *caps0,
                                     ctx.zero_region)

    dp0 = derive_plan_device(sindex, qct0, qvt0, QC, 8, *caps0,
                             ctx.zero_region)
    W_cap, W0 = dp0.work_region.shape[0], int(dp0.W)
    LL = ll_pad_for(dindex.max_list_len, CSUB)
    j_ = torch.arange(LL, device=dev)
    n_super = sindex.super_summary.shape[0]
    rows = (sindex.list_region_start[dp0.pair_list.long()].long()[..., None]
            * SUB + j_)  # [B, QC, LL] aligned rows of each pair
    real = dp0.pair_valid[..., None] & (j_ < dp0.pair_len[..., None])
    pidx = (dp0.pair_pstart[..., None].long() + j_).clamp(
        max=sindex.postings.shape[0] - 1)
    pair_docs = torch.where(real, sindex.postings[pidx].long(), -1)
    s_full, i_full = stream(1.0)
    runs = {}
    grouped.score_grouped_i8 = keeping
    try:
        stream(STREAM_FRACS[0])  # warm-up
        for frac in STREAM_FRACS:
            (s_, i_), wall, counts = counted(
                f"phase 10b: stream_frac {frac}",
                f"stream_{round(frac * 100)}", record,
                lambda frac=frac: stream(frac),
                positive=("qloc", "score_grouped_i8", "rescore"))
            kept = seen["work_region"]
            Wb = min(W_cap, max(128, int(round(frac * W_cap))))
            if kept.shape[0] != Wb:
                fail(f"phase 10b: stream_frac {frac} scored {kept.shape[0]} "
                     f"work items, not max(128, round(frac * {W_cap}))")
            kept_sup = torch.zeros(n_super, dtype=torch.bool, device=dev)
            kept_sup[kept.long()] = True
            ok_docs = torch.where(
                real & kept_sup[(rows // (CSUB * SUB)).clamp(max=n_super - 1)],
                pair_docs, -1).reshape(BATCH, -1)
            srt = torch.sort(ok_docs, dim=1).values
            pos = torch.searchsorted(srt, i_.contiguous()).clamp(
                max=srt.shape[1] - 1)
            inside = (srt.gather(1, pos) == i_) | (i_ < 0)
            if not bool(inside.all()):
                fail(f"phase 10b: stream_frac {frac} returned "
                     f"{int((~inside).sum())} ids outside the scored "
                     "super-tiles")
            err = exact_scores_err(docs, qct0, qvt0, s_, i_)
            if not err <= 1e-5:
                fail(f"phase 10b: stream_frac {frac} scores differ from "
                     f"exact dots by {err}")
            runs[str(frac)] = dict(
                recall_at_10=recall(i_), work_items=int(Wb), W=W0,
                W_cap=W_cap, wall_ms=wall, max_rel_score_err=err,
                launches=counts,
                busy=busy_of(lambda frac=frac: stream(frac), hand + (
                    "score_grouped_i8_kernel",)))
    finally:
        grouped.score_grouped_i8 = k2
    r_full = recall(i_full)
    rec["stream"] = dict(super_upload_s=sup_upload_s,
                         super_summary_bytes=sindex.super_summary.numel(),
                         recall_at_10_stream_frac_1=r_full, runs=runs,
                         busy_stream_frac_1=busy_of(
                             lambda: stream(1.0),
                             hand + ("score_grouped_i8_kernel",)))
    log(f"phase 10b: streaming budget (slot-major K2, upload with super "
        f"bounds {sup_upload_s:.2f} s, bounds equal to the CPU's): "
        + "; ".join(f"stream_frac {f_} keeps {r_['work_items']} of W_cap "
                    f"{W_cap} (W {W0}), recall@10 {r_['recall_at_10']:.4f}, "
                    f"{r_['wall_ms']:.2f} ms, device {r_['busy'].get('device_busy_ms')} ms"
                    for f_, r_ in runs.items())
        + f"; stream_frac 1: recall@10 {r_full:.4f}, device "
        f"{rec['stream']['busy_stream_frac_1'].get('device_busy_ms')} ms; "
        "every id inside the scored super-tiles, every score exact")
    del sindex, rows, real, pidx, pair_docs
    torch.cuda.empty_cache()

    # ---- (c) the weighted list cut ----
    w = np.where((qc0 >= 0) & (qc0 < ctx.n_lists),
                 ctx.list_weight[np.clip(qc0, 0, ctx.n_lists - 1)], 0.0)
    host_w = plan_grouped(qc0, qv0 * w, ctx, QC, M=8)
    caps_w = plan_caps(qc0, qv0, ctx, QC, M=8, weighted=True)
    dpw = derive_plan_device(dindex, qct0, qvt0, QC, 8, *caps_w,
                             ctx.zero_region, weighted=True)
    if caps_w != (host_w.G_cap, host_w.W_cap) or (
            int(dpw.G), int(dpw.W)) != (host_w.G, host_w.W):
        fail(f"phase 10c: weighted caps {caps_w} / host G, W "
             f"{host_w.G, host_w.W} against the derived plan's "
             f"{int(dpw.G), int(dpw.W)}")

    def weighted():
        return search_grouped_derive(dindex, qct0, qvt0, params, QC, 8,
                                     *caps_w, ctx.zero_region, weighted=True)

    weighted()
    (s_w, i_w), wall_w, counts_w = counted(
        "phase 10c: the weighted cut", "weighted", record, weighted,
        positive=("qloc", "score_grouped_i8_item", "rescore"))
    err_w = exact_scores_err(docs, qct0, qvt0, s_w, i_w)
    if not err_w <= 1e-5:
        fail(f"phase 10c: weighted scores differ from exact dots by {err_w}")
    r_w = recall(i_w)
    rec["weighted"] = dict(G=host_w.G, W=host_w.W, caps=caps_w,
                           recall_at_10=r_w, unweighted_recall_at_10=rec4_b0,
                           wall_ms=wall_w, max_rel_score_err=err_w,
                           launches=counts_w)
    log(f"phase 10c: weighted cut: caps {caps_w} = the host planner's, its "
        f"G, W {host_w.G}, {host_w.W} = the derived plan's; recall@10 "
        f"{r_w:.4f} (unweighted {rec4_b0:.4f}), {wall_w:.2f} ms, scores "
        f"exact to {err_w:.3g}")

    # ---- (d) the margin and the two-pass driver ----
    pm = dataclasses.replace(params, return_margin=True)

    def margin():
        return search_grouped_derive(dindex, qct0, qvt0, pm, QC, 8, *caps0,
                                     ctx.zero_region)

    margin()
    (s_m, i_m, diag), wall_m, counts_m = counted(
        "phase 10d: return_margin", "margin", record, margin,
        positive=("qloc", "score_grouped_i8_item", "rescore"))
    if tuple(diag.shape) != (BATCH, 5) or not torch.equal(diag[:, 0],
                                                          s_m[:, K - 1]):
        fail(f"phase 10d: diag {tuple(diag.shape)} is not [{BATCH}, 5] or "
             "its column 0 is not the 10th score")
    p2 = dataclasses.replace(params, pool=TWOPASS_POOL2,
                             rescore=TWOPASS_RESCORE2, pool_per_pair=32)
    tp = TwoPassParams(pass1=params, pass2=p2, query_cut1=QC,
                       query_cut2=TWOPASS_QC2)
    tp_all = dataclasses.replace(tp, eps=np.inf, eps_rel=0.0, b2_frac=1.0)
    tp_none = dataclasses.replace(tp, eps=-np.inf, eps_rel=0.0)
    s_a, i_a, st_a = search_batch_twopass(dindex, ctx, qc0, qv0, tp_all)
    caps2 = plan_caps(qc0, qv0, ctx, TWOPASS_QC2, M=8)
    s_d, i_d = search_grouped_derive(dindex, qct0, qvt0, p2, TWOPASS_QC2, 8,
                                     *caps2, ctx.zero_region)
    # eps = inf flags every query whose pool was filled (an unfilled pool
    # truncated nothing: margin +inf): those rows are the deep pass's, the
    # rest pass 1's
    fl = np.zeros(BATCH, bool)
    fl[st_a["flagged_idx"]] = True
    s_d, i_d = s_d.cpu().numpy(), i_d.cpu().numpy()
    s_1, i_1 = s_m.cpu().numpy(), i_m.cpu().numpy()
    if not (np.array_equal(i_a[fl], i_d[fl])
            and np.array_equal(s_a[fl], s_d[fl])
            and np.array_equal(i_a[~fl], i_1[~fl])
            and np.array_equal(s_a[~fl], s_1[~fl])):
        fail(f"phase 10d: two-pass with eps = inf ({int(fl.sum())} of "
             f"{BATCH} flagged) differs from the deep pass alone on the "
             "flagged rows or from pass 1 on the rest")
    s_n, i_n, st_n = search_batch_twopass(dindex, ctx, qc0, qv0, tp_none)
    if not (st_n["flagged"] == 0 and np.array_equal(i_n, i_1)
            and np.array_equal(s_n, s_1)):
        fail("phase 10d: two-pass with no query flagged differs from "
             "pass 1")
    search_batch_twopass(dindex, ctx, qc0, qv0, tp)  # warm-up
    (s_t, i_t, st_t), wall_t, counts_t = counted(
        "phase 10d: the two-pass driver", "twopass", record,
        lambda: search_batch_twopass(dindex, ctx, qc0, qv0, tp),
        positive=("qloc", "score_grouped_i8_item", "rescore"))
    err_t = exact_scores_err(docs, qct0, qvt0, torch.from_numpy(s_t).to(dev),
                             torch.from_numpy(i_t).to(dev))
    if not err_t <= 1e-5:
        fail(f"phase 10d: two-pass scores differ from exact dots by {err_t}")
    r_t, r_deep = (recall(torch.from_numpy(i_t)),
                   recall(torch.from_numpy(i_d)))
    rec["margin_twopass"] = dict(
        margin_wall_ms=wall_m, pool_bottom_finite_share=float(
            torch.isfinite(diag[:, 1]).float().mean().item()),
        flagged=st_t["flagged"], flag_frac=st_t["flag_frac"], b2=st_t["b2"],
        flagged_at_eps_inf=int(fl.sum()),
        eps_rel=tp.eps_rel, twopass_wall_ms=wall_t,
        recall_at_10_twopass=r_t, recall_at_10_pass1=rec4_b0,
        recall_at_10_deep=r_deep, max_rel_score_err=err_t,
        launches=counts_t)
    log(f"phase 10d: return_margin: diag [{BATCH}, 5], column 0 = the 10th "
        f"score, {wall_m:.2f} ms; two-pass at eps = inf: {int(fl.sum())} "
        f"flagged, those rows == the deep pass alone, the rest == pass 1; "
        f"none flagged == pass 1; at eps_rel {tp.eps_rel}: "
        f"{st_t['flagged']} of {BATCH} flagged (pass-2 batch {st_t['b2']}), "
        f"{wall_t:.2f} ms, recall@10 {r_t:.4f} (pass 1 {rec4_b0:.4f}, deep "
        f"{r_deep:.4f}), scores exact to {err_t:.3g}")
    rec["phase_s"] = time.time() - t_phase
    log(f"phase 10 (a-d): {rec['phase_s']:.1f} s")
    return rec


HEAP_FACTOR, BIG_BUDGET = 0.8, 512
# recall@10 floor of the engine cell at heap_factor 0.8, at either block
# budget: the first run's reading at budget 64 (0.9320, NVIDIA H100 80GB
# HBM3, 700 W) less 0.02. A broken mask falls far below it; it is no
# tuned target.
ENGINE_RECALL_FLOOR = 0.912
# the same for the rescore-mode batch (block budget 64, no tile pool):
# its first reading, 0.8484 on that card, less 0.02. Candidates that K3
# under-scored would drop out of the top 10 and pull it down.
ENGINE_RESCORE_RECALL_FLOOR = 0.828


def count_syncs(fn) -> int:
    """Host synchronisations PyTorch reports while `fn` runs (its sync
    debug mode, a prototype that may miss some). The mode's own notice
    that it is a prototype, given the first time it is switched on,
    counts as none."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def engine_path(index, qcomps, qvals, gt, dev, record, kernels) -> dict:
    """Phase 5: the engine path behind `batch_search(heap_factor > 0)` on
    the API cell's index; returns K7's record and adds the path's launch
    counts to every kernel's record."""
    import torch

    from seismic_tpu_torch.api import DEFAULT_QUERY_PAD
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.ops import rescore, tiles_scorer
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search import engine
    from seismic_tpu_torch.search.engine import SearchParams, search_batch

    rec = record.setdefault("engine", {})
    arrays = index.arrays
    dindex = index.device_index()
    q_comps, q_vals = pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    qct = torch.from_numpy(q_comps).to(dev)
    qvt = torch.from_numpy(q_vals).to(dev)
    LL = ll_pad_for(arrays.max_list_len)
    params = index._search_params(K, QUERY_CUT, 0, True, None, None, None)
    if (params.doc_mode, params.block_mode, params.full_lists) != (
            "tiles", "dense", False):
        fail(f"the engine cell expects block-pruned tiles mode, got {params}")
    rec.update(block_budget=params.block_budget, heap_factor=HEAP_FACTOR,
               ll_pad=LL, max_blocks_per_list=arrays.max_blocks_per_list,
               device_index_bytes=dindex.nbytes())

    # ---- K7 against its plain version on the path's own inputs ----
    qv_masked, safe_lists, _ = engine._select_lists(dindex, qct, qvt,
                                                    QUERY_CUT)
    _, ql, rs, ln = engine._tiles_scorer_inputs(dindex, qct, qv_masked,
                                                safe_lists,
                                                params.score_cut)
    P, V = ql.shape[0] * ql.shape[1], ql.shape[2]
    pl = ln.reshape(P)
    a7 = (dindex.doc_tiles_aligned, dindex.tile_scale, rs.reshape(P),
          ql.reshape(P, V), pl, LL)
    # the same pairs with every one of their LL rows scored, as the TPU
    # kernel streams them
    a7_all = a7[:4] + (torch.full_like(pl, LL), LL)
    k7 = tiles_scorer.score_tiles(*a7)
    p7 = tiles_scorer.score_tiles_plain(*a7)
    torch.cuda.synchronize()
    inside = torch.arange(LL, device=dev) < pl[:, None]
    err = (k7 - p7).abs()
    rel7 = (err / p7.abs().clamp_min(1e-30))[inside].max().item()
    out_abs = err[~inside].max().item()
    if not (rel7 <= 1e-5 and out_abs <= 1e-5 * p7.max().item()):
        fail(f"K7 disagrees: max relative error {rel7} inside the lists, "
             f"max abs error {out_abs} outside")
    # The bound: one launch scores all P pairs, so the function needs each
    # distinct subtile (and its scales) once however many pairs share it,
    # plus every pair's qloc, region start, length and output row; the
    # operations are those of every (pair, subtile) really scored.
    n_subtiles = int(((pl + SUB - 1) // SUB).sum().item())
    sub_ids = (rs.reshape(P).long()[:, None]
               + torch.arange(LL // SUB, device=dev))
    live = torch.arange(LL // SUB, device=dev) * SUB < pl[:, None]
    n_distinct = torch.unique(sub_ids[live]).numel()
    per_pair = P * V * 4 + P * 8 + P * LL * 4
    by7 = n_distinct * SUB * (V + 4) + per_pair
    ops7 = 2.0 * n_subtiles * SUB * V
    b7, bb7 = bound(by7, ops7, PEAK_F32)
    # what the kernel's schedule moves: the wrapper's grouping (pairs of
    # one list, at most GROUP_PAIRS a group) reads each group's subtiles up
    # to its span once; the former schedule streamed every pair's own copy
    groups = tiles_scorer.group_pairs_by_region(
        a7[2], tiles_scorer.GROUP_PAIRS)
    n_groups = int(groups.count.item())
    g_sizes = groups.first[1:n_groups + 1] - groups.first[:n_groups]
    # a group reads its subtiles up to its largest pair_len
    g_span = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    g_span.scatter_reduce_(
        0, torch.repeat_interleave(torch.arange(n_groups, device=dev),
                                   g_sizes), pl[groups.order], "amax")
    g_reads = int(((g_span + SUB - 1) // SUB).clamp(max=LL // SUB)
                  .sum().item())
    del groups, g_span
    by7s = g_reads * SUB * (V + 4) + per_pair
    by7p = n_subtiles * SUB * (V + 4) + per_pair
    rec7 = dict(
        name="score_tiles", route="cuda",
        source="seismic_tpu_torch/csrc/tiles_scorer.cu",
        replaces="seismic_tpu/ops/pallas_tiles.py:30",
        max_abs_err=float(err[inside].max().item()), max_rel_err=rel7,
        ms=time_ms(lambda: tiles_scorer.score_tiles(*a7), 20),
        plain_ms=time_ms(lambda: tiles_scorer.score_tiles_plain(*a7), 3),
        bound_ms=b7, bound_by=bb7,
        # no one PyTorch call gathers each pair's rows and multiplies u8
        # by f32: the plain version's gather + bmm is the closest
        library_ms=None,
        all_rows_ms=time_ms(lambda: tiles_scorer.score_tiles(*a7_all), 20),
        # the wrapper's grouping alone (torch operations launched from the
        # host before the kernel)
        grouping_ms=time_ms(lambda: tiles_scorer.group_pairs_by_region(
            a7[2], tiles_scorer.GROUP_PAIRS), 20),
        bound_as_scheduled_ms=by7s / PEAK_BYTES * 1e3,
        bound_per_pair_schedule_ms=by7p / PEAK_BYTES * 1e3,
        groups=n_groups, group_pairs=tiles_scorer.GROUP_PAIRS,
        pairs_per_group_hist=torch.bincount(g_sizes).tolist(),
        subtile_reads=g_reads, all_rows_subtile_reads=n_groups * (LL // SUB),
        P=P, V=V, ll_pad=LL, subtiles=n_subtiles,
        distinct_subtiles=n_distinct, bytes=by7, bytes_as_scheduled=by7s,
        bytes_per_pair_schedule=by7p, ops=ops7)
    log(f"phase 5: K7 score_tiles: ok, max rel err {rel7:.3g} inside the "
        f"lists, {rec7['ms']:.4f} ms (its grouping alone "
        f"{rec7['grouping_ms']:.4f} ms; {rec7['all_rows_ms']:.4f} ms with all "
        f"{LL} rows of every pair scored; bound {b7:.4f} ms by {bb7} with "
        f"each distinct subtile read once, "
        f"{rec7['bound_as_scheduled_ms']:.4f} ms for the subtile reads of "
        f"its {n_groups} groups, "
        f"{rec7['bound_per_pair_schedule_ms']:.4f} ms for a per-pair "
        f"schedule; plain {rec7['plain_ms']:.3f} ms; no library call); P "
        f"{P}, subtiles {n_subtiles}, distinct {n_distinct}, read "
        f"{g_reads}; pairs a group {rec7['pairs_per_group_hist']}")
    del k7, p7, err, inside, sub_ids, live, ql, a7, a7_all
    torch.cuda.empty_cache()

    # ---- the main path: batch_search(heap_factor=0.8), 5 warm batches ----
    def run(**kw):
        t = time.time()
        res = index.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=HEAP_FACTOR, **kw)
        return res, time.time() - t

    run()  # warm-up (allocator, first launches)
    zero_launches()
    lat, res = [], None
    g0 = gc_ms()
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    gc5 = gc_ms() - g0
    counts = hold_launches("the engine path", read_launches(),
                           exact={"score_tiles": REPS})
    p50 = float(np.median(lat))
    qps = BATCH * REPS / sum(lat)
    log(f"phase 5: {REPS} warm batches of {BATCH} at heap_factor "
        f"{HEAP_FACTOR}: p50 {p50 * 1e3:.2f} ms, QPS {qps:.1f}, launches "
        f"{counts}, gc {gc5:.2f} ms")
    if len(res) != BATCH:
        fail(f"{len(res)} result rows for {BATCH} queries")
    for b, row in enumerate(res):
        sc = np.array([s for s, _ in row])
        if not (len(row) == K and np.isfinite(sc).all()
                and (np.diff(sc) <= 0).all()):
            fail(f"engine query {b}: not {K} finite descending scores")
        if len({d for _, d in row}) != K:
            fail(f"engine query {b}: duplicate ids")

    # ---- recall@10 at the default budget and at block_budget=512 ----
    nq = len(gt)

    def recall(rows):
        return sum(len(set(gt[b].tolist()) & {d for _, d in rows[b]})
                   for b in range(nq)) / (K * nq)

    res_big, _ = run(block_budget=BIG_BUDGET)
    r_def, r_big = recall(res), recall(res_big)
    log(f"phase 5: recall@10 {r_def:.4f} at block_budget "
        f"{params.block_budget}, {r_big:.4f} at block_budget {BIG_BUDGET} "
        f"({nq} queries, heap_factor {HEAP_FACTOR})")
    if min(r_def, r_big) < ENGINE_RECALL_FLOOR or r_big < r_def - 0.005:
        fail(f"engine recall@10 {r_def:.4f} / {r_big:.4f}: under "
             f"{ENGINE_RECALL_FLOOR} or the larger budget lost more than "
             "0.005")

    # ---- the same program on the kernel and on the plain scorer ----
    sub = (q_comps[:nq], q_vals[:nq], params)
    s_k, i_k = search_batch(dindex, *sub, heap_factor=HEAP_FACTOR)
    kernel_scorer = engine.score_tiles
    engine.score_tiles = tiles_scorer.score_tiles_plain
    try:
        s_p, i_p = search_batch(dindex, *sub, heap_factor=HEAP_FACTOR)
    finally:
        engine.score_tiles = kernel_scorer
    same = np.mean([set(a.tolist()) == set(b.tolist())
                    for a, b in zip(i_k, i_p)])
    rel = float(np.max(np.abs(np.sort(s_k, 1) - np.sort(s_p, 1))
                       / np.maximum(np.abs(np.sort(s_p, 1)), 1e-30)))
    log(f"phase 5: kernel path vs plain-scorer path on {nq} queries: id "
        f"sets equal on {same:.4f}, max rel score err {rel:.3g}")
    if same < 0.98 or not rel <= 1e-5:
        fail(f"engine path on K7 and on its plain version disagree: id "
             f"sets equal on {same}, score rel err {rel}")

    # ---- one rescore-mode batch through search_batch: K3, exact dots ----
    rparams = SearchParams(k=K, query_cut=QUERY_CUT, doc_mode="rescore",
                           block_mode="dense", block_budget=64)
    # keep what the path hands K3, to hold the kernel against its plain
    # version at those shapes afterwards
    k3_calls = []
    kernel_k3 = rescore.score_docs_rowmajor

    def keep_k3_args(*a):
        k3_calls.append(a)
        return kernel_k3(*a)

    zero_launches()
    rescore.score_docs_rowmajor = keep_k3_args
    try:
        t0 = time.perf_counter()
        s_r, i_r = search_batch(dindex, q_comps, q_vals, rparams,
                                heap_factor=HEAP_FACTOR)
        rescore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rescore.score_docs_rowmajor = kernel_k3
    rcounts = hold_launches("the rescore-mode batch", read_launches(),
                            positive=("rescore",))
    if len(k3_calls) != rcounts["rescore"]:
        fail(f"{len(k3_calls)} K3 calls kept, {rcounts['rescore']} launches")
    # K3 on the path's widest-filled candidate chunk (sentinel ids already
    # clamped to n_docs - 1 by the path), the plain version in row slices
    # that bound its [rows, R, W] temporaries
    a3e = max(k3_calls, key=lambda a: int((a[1] != a[4] - 1).sum().item()))
    k3e = kernel_k3(*a3e)
    p3e = torch.cat([
        rescore.score_docs_rowmajor_plain(
            a3e[0], a3e[1][r0:r0 + 512], a3e[2][r0:r0 + 512],
            a3e[3][r0:r0 + 512], a3e[4])
        for r0 in range(0, a3e[1].shape[0], 512)])
    torch.cuda.synchronize()
    err3 = (k3e - p3e).abs()
    rel3 = (err3 / p3e.abs().clamp_min(1e-30))[p3e != 0].max().item()
    zero3 = err3[p3e == 0].max().item() if (p3e == 0).any() else 0.0
    b3 = k3_bounds(a3e)
    at_engine = dict(
        shape=list(a3e[1].shape), terms=a3e[2].shape[1],
        chunks_per_batch=len(k3_calls),
        nonzero_scores=int((p3e != 0).sum().item()),
        max_abs_err=float(err3.max().item()), max_rel_err=rel3,
        ms=time_ms(lambda: kernel_k3(*a3e), 10),
        plain_ms=time_ms(lambda: [rescore.score_docs_rowmajor_plain(
            a3e[0], a3e[1][r0:r0 + 512], a3e[2][r0:r0 + 512],
            a3e[3][r0:r0 + 512], a3e[4])
            for r0 in range(0, a3e[1].shape[0], 512)], 2),
        library_ms=None, launches=rcounts["rescore"], **b3)
    log(f"phase 5: K3 on the rescore batch's own {at_engine['shape']} "
        f"candidate chunk ({len(k3_calls)} per batch): max rel err "
        f"{rel3:.3g} on {at_engine['nonzero_scores']} nonzero scores, "
        f"{at_engine['ms']:.4f} ms (bound {b3['bound_ms']:.4f} ms by "
        f"{b3['bound_by']}, {b3['bound_as_scheduled_ms']:.4f} as scheduled, "
        f"compare count {b3['compare_bound_ms']:.4f}; plain "
        f"{at_engine['plain_ms']:.3f} ms in 512-row slices)")
    if not (rel3 <= 1e-5 and zero3 <= 1e-30):
        fail(f"K3 disagrees with its plain version at the engine's shapes: "
             f"max relative error {rel3}, {zero3} where the plain score is 0")
    kernels[COUNTED.index("rescore")]["at_engine"] = at_engine
    del k3_calls, a3e, k3e, p3e, err3
    torch.cuda.empty_cache()
    # brute force over the index's own forward rows (f16 values) and the
    # queries' top score_cut terms, on the card
    docs16 = fwd_csr(arrays, dev)
    top_c, top_v, _ = engine._query_terms(qct, qvt, rparams.score_cut)
    s_rt = torch.from_numpy(s_r).to(dev)
    i_rt = torch.from_numpy(i_r).to(dev)
    fin_r = torch.isfinite(s_rt) & (i_rt >= 0)
    if fin_r.float().mean().item() < 0.99:
        fail("rescore-mode results: under 99% of the top-k slots filled")
    ex = exact_of(docs16, top_c, top_v, i_rt.clamp_min(0))
    worst = max_rel_err(s_rt[fin_r], ex[fin_r])
    r_res = sum(len(set(gt[b].tolist()) & set(i_r[b].tolist()))
                for b in range(nq)) / (K * nq)
    log(f"phase 5: one rescore-mode batch of {BATCH}: {rescore_ms:.2f} ms, "
        f"launches {rcounts}, every score the exact dot to {worst:.3g} "
        f"relative, recall@10 {r_res:.4f} on {nq} queries")
    if not worst <= 1e-5:
        fail(f"rescore-mode scores differ from exact dots by {worst} "
             "relative")
    if r_res < ENGINE_RESCORE_RECALL_FLOOR:
        fail(f"rescore-mode recall@10 {r_res:.4f} under "
             f"{ENGINE_RESCORE_RECALL_FLOOR}")
    del docs16
    torch.cuda.empty_cache()

    # ---- where one batch's time goes ----
    hf32 = float(np.float32(HEAP_FACTOR))
    g0 = gc_ms()
    t = [time.perf_counter()]
    pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    t.append(time.perf_counter())
    qct2 = torch.from_numpy(q_comps).to(dev)
    qvt2 = torch.from_numpy(q_vals).to(dev)
    torch.cuda.synchronize()
    g_prog, n_alloc = gc_ms(), device_allocs()
    t.append(time.perf_counter())
    out = engine._search_impl(dindex, qct2, qvt2, hf32, params)
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    prog = dict(enqueue_ms=(t_enq - t[2]) * 1e3, gc_ms=gc_ms() - g_prog,
                cuda_mallocs=device_allocs() - n_alloc)
    out[0].cpu(), out[1].cpu()
    t.append(time.perf_counter())
    brk = {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(
        ("pad_queries_ms", "upload_ms", "device_program_ms",
         "download_ms"))}
    brk.update(gc_ms=gc_ms() - g0, device_program=prog)
    prog_fn = lambda: engine._search_impl(dindex, qct2, qvt2, hf32, params)
    brk["host_syncs_in_device_program"] = count_syncs(prog_fn)
    if brk["host_syncs_in_device_program"] > 1:
        fail(f"the engine program made {brk['host_syncs_in_device_program']}"
             " host synchronisations, more than one")
    try:
        prof, _ = profile_held(prog_fn, ("score_tiles_kernel",))
        brk.update(prof, device_idle_share=idle_share(
            prof["device_busy_ms"], brk["device_program_ms"]))
    except NoProfile as e:  # informational only
        brk["profile"] = f"not measured: {e}"
    log(f"phase 5 breakdown of one batch: {json.dumps(brk)}")

    record["launch_windows"]["engine"] = {
        n_: counts[n_] + rcounts[n_] for n_ in COUNTED}
    rec.update(qps=qps, p50_ms=p50 * 1e3, latencies_s=lat, gc_ms=gc5,
               launches=counts, rescore_batch_launches=rcounts,
               rescore_batch_ms=rescore_ms, rescore_max_rel_err=worst,
               recall_at_10=r_def, recall_at_10_budget_512=r_big,
               recall_at_10_rescore=r_res, recall_queries=nq,
               plain_scorer_id_sets_equal=float(same),
               plain_scorer_max_rel_err=rel, breakdown=brk, k7=rec7,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict({k_: rec7[k_] for k_ in keys},
                max_rel_err=rel7, all_rows_ms=rec7["all_rows_ms"],
                bound_as_scheduled_ms=rec7["bound_as_scheduled_ms"],
                grouping_ms=rec7["grouping_ms"], groups=n_groups,
                subtile_reads=g_reads,
                pairs_per_group_hist=rec7["pairs_per_group_hist"])


def probe_path(dev, record) -> list:
    """Phase 7: the device probe's `run` on the card at the JAX probes'
    own sizes (each of K10-K18 held against its plain version inside its
    probe), the launch counts of all twenty-five wrappers set to 0 before and
    read after, K11 / K15's readings and diagnostics (`row_gather_probe.
    readings`) after that window, then the microbench once. Returns
    K10-K18's records."""
    import torch

    from seismic_tpu_torch.harness import (device_probe, microbench,
                                           row_gather_probe)

    t0 = time.time()
    floor_us, floor_device_us = device_probe.launch_floor_us(dev)
    zero_launches()
    records, failures = device_probe.run(dev)
    counts = read_launches()
    if failures:
        fail(f"phase 7: probes failed or missed their checks: {failures}")
    kernels = [r for r in records if "name" in r]
    if tuple(r["name"] for r in kernels) != PROBE_KERNELS:
        fail(f"phase 7: probe kernels {[r['name'] for r in kernels]}")
    # no device time, warm or flushed, under an empty kernel's
    for r in kernels:
        low = device_probe.below_floor(r, floor_device_us * 1e-3)
        if low:
            fail(f"phase 7: {r['name']} device times under the launch "
                 f"floor ({floor_device_us:.2f} us): {low}")
    # each of K10-K18: once per check, timed and device-timed call
    record["launch_windows"]["probe"] = hold_launches(
        "the device probe", counts,
        exact={r["name"]: sum(r["calls"].values()) for r in kernels})
    k10 = kernels[PROBE_KERNELS.index("table_take")]
    k10["ptxas"] = ptxas_of("device_probe", "table_take")
    log(f"phase 7: K10 table_take ptxas: {k10['ptxas']}")
    # K12 and K16 launch one kernel, a term lookup
    ptx12 = ptxas_of("device_probe", "compare_lookup_kernel")
    if not ptx12:
        fail("phase 7: no ptxas line of K12 / K16's compare_lookup_kernel")
    for n_ in ("compare_intersect", "compare_term_loop"):
        kernels[PROBE_KERNELS.index(n_)]["ptxas"] = ptx12
    log(f"phase 7: K12 / K16 compare_lookup_kernel ptxas: {ptx12}")
    # K13 and K14: one round of loads each, no shared memory, no spill
    for n_, fn_ in (("u8_matvec", "u8_matvec_kernel"),
                    ("take_along_axis", "take_along_axis_kernel")):
        ptx = ptxas_of("device_probe", fn_)
        if not ptx or not all(ptx.values()):
            fail(f"phase 7: no ptxas line of {n_}'s {fn_}")
        spills = [ln for lns in ptx.values() for ln in lns
                  if re.search(r"[1-9]\d* bytes spill", ln)]
        if spills:
            fail(f"phase 7: {fn_} spills: {spills}")
        kernels[PROBE_KERNELS.index(n_)]["ptxas"] = ptx
        log(f"phase 7: {n_} {fn_} ptxas: {ptx}")
    # K17's route, from the SASS of its kernel: the bf16 tensor cores
    k17 = kernels[PROBE_KERNELS.index("i8_matmul")]
    sass = sass_of("device_probe")
    if sass is None:
        fail("phase 7: no cuobjdump to read K17's route from its SASS")
    ops17 = [o for f_, o in sass.items() if "i8_matmul_kernel" in f_]
    if len(ops17) != 1:
        fail(f"phase 7: the SASS has {len(ops17)} K17 kernels")
    k17["hmma_bf16"] = ops17[0].get("HMMA.16816.F32.BF16", 0)
    if not k17["hmma_bf16"]:
        fail("phase 7: K17's kernel holds no HMMA.16816.F32.BF16: "
             f"{sorted(ops17[0])}")
    k17["ptxas"] = [ln for lns in ptxas_of(
        "device_probe", "i8_matmul_kernel").values() for ln in lns]
    log(f"phase 7: K17 i8_matmul on the bf16 tensor cores "
        f"({k17['hmma_bf16']} HMMA.16816.F32.BF16 in its SASS); ptxas: "
        f"{'; '.join(k17['ptxas'])}; error {k17['tolerance_share']:.4f} of "
        f"the tolerance; bound by its route (f32 operations on the CUDA "
        f"cores would take {k17['f32_ops_bound_ms'] * 1e3:.3f} us)")
    # K11 and K15: one kernel, a warp a row of 16-byte loads (a ring of bulk
    # copies and a few rows a warp were tried and did not beat it), no
    # spill; then, outside the counted window, its readings in turns with
    # index_select and the empty kernel and what its flushed time is made
    # of (harness/row_gather_probe.py)
    ptx11 = ptxas_of("device_probe", "row_gather_kernel")
    if len(ptx11) != 2 or not all(ptx11.values()):
        fail(f"phase 7: ptxas of K11 / K15's row_gather_kernel: {ptx11}")
    spills = [ln for lns in ptx11.values() for ln in lns
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        fail(f"phase 7: row_gather_kernel spills: {spills}")
    for n_ in ("row_gather", "flat_row_gather"):
        kernels[PROBE_KERNELS.index(n_)]["ptxas"] = ptx11
    log(f"phase 7: K11 / K15 row_gather_kernel ptxas: {ptx11}")
    probe_s = time.time() - t0  # K10-K18; the row gather times its own
    t1 = time.time()
    try:
        gather = row_gather_probe.readings(dev)
    except AssertionError as e:
        fail(f"phase 7: {e}")
    card = card_line()
    for ln in row_gather_probe.lines(gather):
        log(f"phase 7: row gather ({card}): {ln}")
    gather.update(card=card, seconds=time.time() - t1)
    for r in kernels:
        r.update(launch_floor_us=floor_us,
                 launch_floor_device_us=floor_device_us)
        log(f"phase 7: {r['name']} ({r['probe']}): ok, max_abs_err "
            f"{r['max_abs_err']:.3g}, {r['ms'] * 1e3:.2f} us a call, device "
            f"{r['device_ms'] * 1e3:.2f} us, with L2 flushed by a write "
            f"{r['device_cold_ms'] * 1e3:.2f} us, by a read "
            f"{r['device_cold_read_ms'] * 1e3:.2f} us (bound "
            f"{r['bound_ms'] * 1e3:.3f} "
            f"us by {r['bound_by']}, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {r['library_ms']} ms, on the card "
            f"{r['library_device_ms']} / {r['library_device_cold_ms']} / "
            f"{r['library_device_cold_read_ms']} ms)")
    log(f"phase 7: launch floor {floor_us:.2f} us a call, "
        f"{floor_device_us:.2f} us on the card; probes {probe_s:.1f} s, "
        f"launches {counts}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mb = microbench.run(dev)
    mb_s = time.time() - t0
    log(f"phase 7: microbench {mb_s:.1f} s, peak device bytes "
        f"{mb['peak_device_bytes']}")
    record["probe"] = dict(
        launch_floor_us=floor_us, launch_floor_device_us=floor_device_us,
        probe_s=probe_s, microbench=mb, microbench_s=mb_s,
        row_gather=gather,
        plain_probes=[r for r in records if "name" not in r])
    torch.cuda.empty_cache()
    return kernels


# ---- phase 8: the k-NN graph and refinement, exact search, the user API ----
NKNN = 16
# documents a self-search batch of the graph holds: the graph does not
# depend on it (tests/test_torch_knn.py::
# test_graph_does_not_depend_on_batch_size)
KNN_BATCH = 4096
KNN_SAMPLE = 256


def fwd_csr(arrays, dev):
    """The index's own forward rows as a sparse CSR [n_docs, DIM] f32
    tensor on the card (its value dtype decoded to f32; u8 codes as
    code * step + min of their document)."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT

    fc = np.asarray(arrays.fwd_comps)
    real = fc != PAD_COMPONENT
    crow = np.zeros(len(fc) + 1, np.int64)
    np.cumsum(real.sum(1), out=crow[1:])
    fv = np.asarray(arrays.fwd_vals).astype(np.float32)
    if arrays.fwd_val_min is not None:
        fv = (fv * np.asarray(arrays.fwd_val_step, np.float32)[:, None]
              + np.asarray(arrays.fwd_val_min, np.float32)[:, None])
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(fc[real].astype(np.int64)),
        torch.from_numpy(fv[real]), size=(len(fc), arrays.dim)).to(dev)


def exact_of(docs, qc_t, qv_t, ids):
    """Exact dots of each query (padded qc_t int32 / qv_t f32 [B, Q] on
    the card) with its result docs ids [B, k] (>= 0): the brute-force
    sparse x dense product, 2048 queries at a time, over docs' columns."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT

    out = []
    for c0 in range(0, qc_t.shape[0], 2048):
        qc, qv = qc_t[c0:c0 + 2048], qv_t[c0:c0 + 2048]
        n = qc.shape[0]
        ok = qc != int(PAD_COMPONENT)
        col = torch.arange(n, device=qc.device)[:, None].expand_as(qc)
        qd = torch.zeros((docs.shape[1], n), dtype=torch.float32,
                         device=qc.device)
        qd[qc[ok].long(), col[ok]] = qv[ok]
        out.append(torch.sparse.mm(docs, qd).t().gather(1, ids[c0:c0 + n]))
        del qd
    return torch.cat(out)


def max_rel_err(scores, exact) -> float:
    return float(((scores - exact).abs()
                  / exact.abs().clamp_min(1e-30)).max().item())


def recall_at(gt, ids) -> float:
    """Mean share of each row of `gt` found in the same row of `ids`."""
    return float(np.mean([len(set(g.tolist()) & set(r.tolist())) / len(g)
                          for g, r in zip(gt, ids)]))


def knn_api_path(index, ds, qcomps, qvals, gt, recall3, dev, record):
    """Phase 8 (a) and (b) on the API cell's index: the graph built by
    `build_knn` (its self-searches, 256 sampled rows redone, the file
    round trip, its recall against exact search), then the API's grouped
    route with `n_knn=16`. Returns the graph."""
    import tempfile

    import torch

    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search import engine
    from seismic_tpu_torch.search import knn as knn_mod
    from seismic_tpu_torch.search.exact import exact_search

    rec = record.setdefault("knn", {})
    arrays = index.arrays
    n = arrays.n_docs
    n_batches = -(-n // KNN_BATCH)

    # ---- (a) the graph ----
    index.device_index()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    index.build_knn(NKNN, batch_size=KNN_BATCH)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = hold_launches("phase 8a: build_knn", read_launches(),
                           exact={"score_tiles": n_batches})
    record["launch_windows"]["knn_graph"] = counts
    graph = arrays.knn
    dindex = index.device_index()  # the upload that carries the graph
    if not torch.equal(dindex.knn.cpu(), torch.from_numpy(graph)):
        fail("phase 8a: the device index does not carry the new graph")
    try:
        prof, _ = profile_held(lambda: knn_mod.build_knn(
            arrays, dindex, NKNN, batch_size=KNN_BATCH),
            ("score_tiles_kernel",))
        busy = prof.pop("device_busy_ms")
        prof["device_busy_s"] = None if busy is None else busy / 1e3
    except NoProfile as e:  # informational only
        prof = {"profile": f"not measured: {e}"}
    if graph.shape != (n, NKNN) or graph.dtype != np.int32:
        fail(f"phase 8a: graph {graph.shape} {graph.dtype}")
    valid = graph >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        fail("phase 8a: -1 before a neighbour in some row")
    if (graph == np.arange(n)[:, None]).any():
        fail("phase 8a: a document is its own neighbour")
    uniq = np.sort(np.where(valid, graph, -1 - np.arange(NKNN)), axis=1)
    if (uniq[:, 1:] == uniq[:, :-1]).any():
        fail("phase 8a: a row repeats a neighbour")
    sample = np.sort(np.random.default_rng(8).choice(n, KNN_SAMPLE,
                                                      replace=False))
    sq_c = np.asarray(arrays.fwd_comps)[sample]
    sq_v = np.asarray(arrays.fwd_vals)[sample].astype(np.float32)
    _, ids = engine.search_batch(
        dindex, sq_c, sq_v, knn_mod.self_search_params(arrays, NKNN),
        heap_factor=knn_mod.KNN_HEAP_FACTOR)
    fresh = knn_mod.drop_self(ids, sample, NKNN)
    for row, doc in zip(fresh, sample):
        if set(row.tolist()) != set(graph[doc].tolist()):
            fail(f"phase 8a: doc {doc}: graph row {graph[doc].tolist()} "
                 f"but a fresh self-search gives {row.tolist()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = index.save_knn(os.path.join(tmp, "graph"))
        if not np.array_equal(knn_mod.load_knn(path), graph):
            fail("phase 8a: save_knn -> load_knn changed the graph")
    _, ex_i = exact_search(ds, sq_c, sq_v, NKNN + 1, device=dev)
    rec16 = recall_at(knn_mod.drop_self(ex_i, sample, NKNN), graph[sample])
    rec.update(graph_wall_s=wall_s, graph_batches=n_batches,
               graph_batch=KNN_BATCH, graph_launches=counts,
               graph_profile=prof, graph_empty_slots=int((~valid).sum()),
               graph_recall_at_16=rec16)
    log(f"phase 8a: build_knn({NKNN}) of {n} docs in {n_batches} "
        f"self-search batches of {KNN_BATCH}: {wall_s:.2f} s wall, "
        f"{json.dumps(prof)}; launches {counts}; {KNN_SAMPLE} sampled rows "
        f"equal a fresh self-search as id sets; file round trip equal; "
        f"{rec['graph_empty_slots']} empty slots; recall@{NKNN} of the "
        f"graph against exact search on the sample {rec16:.4f}")

    # ---- (b) the API's grouped route with refinement ----
    def run():
        t = time.perf_counter()
        res = index.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=0.0, n_knn=NKNN)
        return res, time.perf_counter() - t

    run()  # warm-up
    zero_launches()
    lat, res = [], None
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    counts = hold_launches(
        "phase 8b: the API's grouped route with n_knn", read_launches(),
        positive=("qloc", "score_grouped_i8", "rescore"))
    record["launch_windows"]["knn"] = counts
    k3_api = record["launch_windows"]["api"]["rescore"]
    if not counts["rescore"] > k3_api:
        fail(f"phase 8b: K3 launched {counts['rescore']} times, not more "
             f"than phase 3's {k3_api}")
    if len(res) != BATCH or any(len(r) != K for r in res):
        fail("phase 8b: not 10 results for every query")
    s_b = np.array([[s for s, _ in r] for r in res], np.float32)
    i_b = np.array([[d for _, d in r] for r in res], np.int64)
    if not (np.isfinite(s_b).all() and (np.diff(s_b, axis=1) <= 0).all()):
        fail("phase 8b: scores not finite and descending")
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)
    top_c, top_v, _ = engine._query_terms(
        torch.from_numpy(q_comps).to(dev), torch.from_numpy(q_vals).to(dev),
        64)
    docs16 = fwd_csr(arrays, dev)
    worst = max_rel_err(torch.from_numpy(s_b).to(dev),
                        exact_of(docs16, top_c, top_v,
                                 torch.from_numpy(i_b).to(dev)))
    del docs16
    torch.cuda.empty_cache()
    if not worst <= 1e-5:
        fail(f"phase 8b: scores differ from exact dots by {worst} relative")
    nq = len(gt)
    rec_b = recall_at(gt, i_b[:nq])
    rec.update(api_recall_at_10=rec_b, api_recall_at_10_phase3=recall3,
               api_p50_ms=float(np.median(lat)) * 1e3, api_latencies_s=lat,
               api_launches=counts, api_max_rel_score_err=worst)
    log(f"phase 8b: batch_search(n_knn={NKNN}, heap_factor=0) of {BATCH}: "
        f"p50 {rec['api_p50_ms']:.2f} ms over {REPS} batches, launches "
        f"{counts}, scores exact to {worst:.3g}; recall@10 {rec_b:.4f} on "
        f"{nq} queries against phase 3's {recall3:.4f}")
    if rec_b < recall3 - 0.005:
        fail(f"phase 8b: recall@10 {rec_b:.4f} more than 0.005 under "
             f"phase 3's {recall3:.4f}")
    return graph


def cell_layout():
    """The search cells' TpuLayout (V_CAP-wide local vocabularies)."""
    from seismic_tpu_torch import TpuLayout

    return TpuLayout(max_block_len=32, summary_vocab_cap=V_CAP,
                     max_doc_nnz=256, tile_overflow=64)


def write_corpus_jsonl(ds, path: str, n_docs=None) -> None:
    """The corpus's first `n_docs` documents (all by default) as JSONL:
    ids d<i>, tokens t<c>, contents "document <i>" (phase 8e's file)."""
    names = [f"t{c}" for c in range(ds.dim)]
    with open(path, "w") as f:
        for i, (c, v) in enumerate(ds.iter_rows()):
            if n_docs is not None and i >= n_docs:
                break
            f.write(json.dumps({
                "id": f"d{i}", "content": f"document {i}",
                "vector": dict(zip([names[x] for x in c.tolist()],
                                   v.tolist()))}) + "\n")


def user_flow_path(index, ds, qcomps, qvals, dev, record, tmp):
    """Phase 8 (e): the corpus written as JSONL (ids d<i>, tokens t<c>,
    contents) into directory `tmp`, `SeismicIndex.build` of it with the
    identity token map and phase 3's configuration, and `batch_search` of
    phase 3's queries as token strings on the grouped route (heap_factor
    0) and the engine path (0.7), each result equal to `SeismicIndexRaw`'s
    on phase 3's index. Returns (the JSONL's path, the token map)."""
    import dataclasses

    import torch

    from seismic_tpu_torch import SeismicIndex
    from seismic_tpu_torch.data import io as data_io

    rec = record.setdefault("api_classes", {})
    tmap = {f"t{c}": c for c in range(DIM)}
    names = list(tmap)
    # the build's own parse, kept and timed: one pass over the file
    parsed, read = {}, data_io.read_jsonl_dataset

    def timed_read(*a, **kw):
        t = time.perf_counter()
        parsed["out"] = read(*a, **kw)
        parsed["s"] = time.perf_counter() - t
        return parsed["out"]

    path = os.path.join(tmp, "documents.jsonl")
    t0 = time.perf_counter()
    write_corpus_jsonl(ds, path)
    t1 = time.perf_counter()
    data_io.read_jsonl_dataset = timed_read
    try:
        sidx = SeismicIndex.build(
            path, n_postings=200, max_fraction=2.0, layout=cell_layout(),
            input_token_to_id_map=tmap)
    finally:
        data_io.read_jsonl_dataset = read
    t3 = time.perf_counter()
    jsonl_bytes = os.path.getsize(path)
    csr, doc_ids, _, contents = parsed.pop("out")
    for f_ in ("offsets", "components", "values"):
        if not np.array_equal(getattr(csr, f_), getattr(ds, f_)):
            fail(f"phase 8e: the JSONL's CSR {f_} differ from phase 3's")
    if csr.dim != ds.dim or doc_ids[7] != "d7" or contents[7] != \
            "document 7":
        fail("phase 8e: the JSONL's dim, ids or contents differ")
    del csr, contents
    ref = index.arrays
    for f_ in dataclasses.fields(ref):
        a, b = getattr(ref, f_.name), getattr(sidx.arrays, f_.name)
        if f_.name != "knn" and isinstance(a, np.ndarray) and not \
                np.array_equal(a, b):
            fail(f"phase 8e: SeismicIndex array {f_.name} differs from "
                 "phase 3's")
    tq = [np.array([names[x] for x in c], dtype="U30") for c in qcomps]
    qids = np.array([f"q{i}" for i in range(len(qcomps))], dtype="U30")
    sidx.device_index()
    torch.cuda.synchronize()
    zero_launches()
    t4 = time.perf_counter()
    got = {hf: sidx.batch_search(qids, tq, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=hf) for hf in (0.0, 0.7)}
    t5 = time.perf_counter()
    counts = hold_launches(
        "phase 8e: SeismicIndex.batch_search", read_launches(),
        positive=("qloc", "score_grouped_i8", "rescore", "score_tiles"))
    record["launch_windows"]["api_classes"] = counts
    worst = 0.0
    for hf, rows in got.items():
        raw = index.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=hf)
        for qid, row, rrow in zip(qids, rows, raw):
            if [(q, d) for q, _, d in row] != [(qid, f"d{d}")
                                               for _, d in rrow]:
                fail(f"phase 8e: heap_factor {hf}, {qid}: SeismicIndex "
                     f"{row} but SeismicIndexRaw {rrow}")
            for (_, s, _), (r, _) in zip(row, rrow):
                worst = max(worst, abs(s - r) / max(abs(r), 1e-30))
    if not worst <= 1e-6:
        fail(f"phase 8e: scores differ from SeismicIndexRaw's by {worst}")
    for i in (0, 7, len(ds) - 1):
        if sidx.get_doc_text(i) != f"document {i}":
            fail(f"phase 8e: get_doc_text({i}) = {sidx.get_doc_text(i)!r}")
    rec.update(jsonl_bytes=jsonl_bytes, write_jsonl_s=t1 - t0,
               read_jsonl_dataset_s=parsed["s"], seismic_index_build_s=t3 - t1,
               two_batches_s=t5 - t4, launches=counts,
               max_rel_score_diff=worst, corpus_docs=len(ds))
    log(f"phase 8e: {len(ds)} docs as JSONL ({jsonl_bytes} bytes) written "
        f"in {t1 - t0:.1f} s; SeismicIndex.build {t3 - t1:.1f} s, of which "
        f"read_jsonl_dataset {parsed['s']:.1f} s (its CSR is phase 3's; "
        f"the index's arrays are phase 3's); batch_search at heap_factor 0 and 0.7 "
        f"{t5 - t4:.2f} s, launches {counts}; every result equals "
        f"SeismicIndexRaw's (scores to {worst:.3g}); get_doc_text ok")
    del sidx, got
    gc.collect()
    torch.cuda.empty_cache()
    return path, tmap


# ---- phase 9: SeismicIndexDotVByte on the block-pool route ----
DOTV_HEAP_FACTOR = 0.7
# the engine batches' block budgets: 512 takes every block of the 14
# selected lists (about 20 a list at this layout), as the API's default
# budget does on the JAX package's toy set, where the block route is held
# to the engine route; 64 is the API's default, max(4k, 64), printed
DOTV_ENGINE_BUDGET, DOTV_DEFAULT_BUDGET = 512, 64
# top-10 entries the block route shares with the engine route: the JAX
# package's own bar (tests/test_api.py:170-173)
DOTV_AGREE_FLOOR = 0.9
# recall@10 of the block route, the engine at budgets 512 and 64 and the
# block route with n_knn=16 on the full corpus, as PERF.md records them
# (equal in every recorded run): a change of K3-u8's design changes no
# score, so each holds to within DOTV_RECALL_TOL
DOTV_RECALL_REF = dict(block=0.8531, engine_512=0.9309, engine_64=0.9273,
                        knn=0.9250)
DOTV_RECALL_TOL = 0.002


def dotvbyte_path(jsonl, tmap, graph_path, qcomps, qvals, gt, dev,
                  record) -> dict:
    """Phase 9: `SeismicIndexDotVByte.build` of phase 8e's JSONL at the
    cells' layout, phase 8a's graph read by `load_knn`, and `batch_search`
    of phase 3's queries as token strings (k=10, query_cut 14): the
    block-pool route at heap_factor 0.7, the same queries with a block
    budget (the engine's rescore mode) and the block route with n_knn=16.
    K3's u8 form is held against its plain version on one batch's
    expanded candidates and timed beside its bounds. Returns its record."""
    import dataclasses

    import torch

    from seismic_tpu_torch import SeismicIndexDotVByte
    from seismic_tpu_torch.api import DEFAULT_QUERY_PAD, block_pool_params
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.harness import k3u8_probe
    from seismic_tpu_torch.ops import rescore
    from seismic_tpu_torch.search import engine, grouped
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl
    from seismic_tpu_torch.search.planner import plan_grouped

    rec = record.setdefault("dotvbyte", {})
    t0 = time.perf_counter()
    vidx = SeismicIndexDotVByte.build(
        jsonl, n_postings=200, max_fraction=2.0, layout=cell_layout(),
        input_token_to_id_map=tmap)
    t1 = time.perf_counter()
    # read before the first upload, so both device copies carry it
    vidx.load_knn(graph_path)
    arrays = vidx.arrays
    if (arrays.fwd_val_min is None or arrays.fwd_vals.dtype != np.uint8
            or arrays.doc_tiles is not None):
        fail("phase 9: the DotVByte build holds no u8 forward values, or "
             "holds doc tiles")
    bindex, bctx, E = vidx.block_device_index()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eindex = vidx.device_index()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    W = arrays.fwd_comps.shape[1]
    for name_, di in (("block", bindex), ("engine", eindex)):
        if di.fwd_fused is not None or di.fwd_comps16 is None or \
                di.fwd_comps16.dtype != torch.int16:
            fail(f"phase 9: the {name_} device index is not in the lean "
                 "forward form")
        for f_ in dataclasses.fields(di):
            t_ = getattr(di, f_.name)
            if (torch.is_tensor(t_) and t_.dtype == torch.int32
                    and tuple(t_.shape) == (arrays.n_docs, W)):
                fail(f"phase 9: the {name_} device index holds int32 "
                     f"forward ids ({f_.name})")
    V = int(bindex.vocab16.shape[1])
    if V != 512 or E != 32:
        fail(f"phase 9: the block view is {V} wide with block_expand {E}")
    sizes = dict(block_index_bytes=bindex.nbytes(),
                 engine_index_bytes=eindex.nbytes(),
                 aligned_block_rows_bytes=bindex.doc_tiles_aligned.numel(),
                 aligned_block_rows=int(bindex.doc_tiles_aligned.shape[0]),
                 api_index_bytes=record["device_index_bytes"])
    rec.update(build_s=t1 - t0, block_view_upload_s=t2 - t1,
               engine_upload_s=t3 - t2, n_blocks=int(len(arrays.block_len)),
               n_lists=int(arrays.n_lists), **sizes)
    log(f"phase 9: SeismicIndexDotVByte.build {t1 - t0:.1f} s (u8 values, "
        f"no doc tiles); block view (narrowed to V={V}, members ordered, "
        f"lean upload) {t2 - t1:.1f} s, engine copy {t3 - t2:.1f} s; device "
        f"bytes: block index {sizes['block_index_bytes']} (aligned block "
        f"rows {sizes['aligned_block_rows_bytes']} over "
        f"{sizes['aligned_block_rows']} rows), engine copy "
        f"{sizes['engine_index_bytes']}; phase 3's API index "
        f"{sizes['api_index_bytes']}")

    tq = [np.array([f"t{c}" for c in q], dtype="U30") for q in qcomps]
    qids = np.array([f"q{i}" for i in range(len(qcomps))], dtype="U30")

    def run(**kw):
        t = time.perf_counter()
        res = vidx.batch_search(qids, tq, qvals, k=K, query_cut=QUERY_CUT,
                                heap_factor=DOTV_HEAP_FACTOR, **kw)
        return res, time.perf_counter() - t

    def as_arrays(res, what):
        if len(res) != BATCH or any(len(r) != K for r in res):
            fail(f"phase 9 ({what}): not {K} results for every query")
        s_ = np.array([[x[1] for x in r] for r in res], np.float32)
        i_ = np.array([[int(x[2][1:]) for x in r] for r in res], np.int64)
        if not (np.isfinite(s_).all() and (np.diff(s_, axis=1) <= 0).all()):
            fail(f"phase 9 ({what}): scores not finite and descending")
        return s_, i_

    # ---- K3's u8 form on one batch's own expanded candidates; K1's and
    # K2's operands of the same batch, timed alone below ----
    wrapped = ((rescore, "score_docs_rowmajor_lean"),
               (grouped, "project_qloc_quantize"),
               (grouped, "score_grouped_i8"))
    calls = {name_: [] for _, name_ in wrapped}
    originals = [getattr(m_, name_) for m_, name_ in wrapped]

    def keeper(name_, f_):
        def keep(*a, **kw):
            calls[name_].append((a, kw))
            return f_(*a, **kw)
        return keep

    for (m_, name_), f_ in zip(wrapped, originals):
        setattr(m_, name_, keeper(name_, f_))
    try:
        run()  # also the warm-up
    finally:
        for (m_, name_), f_ in zip(wrapped, originals):
            setattr(m_, name_, f_)
    if any(len(c_) != 1 for c_ in calls.values()):
        fail(f"phase 9: calls in one block-route batch "
             f"{ {n_: len(c_) for n_, c_ in calls.items()} }, not one each")
    a8, kw8 = calls.pop("score_docs_rowmajor_lean").pop()
    if kw8 != {"skip_out_of_range": True}:
        fail(f"phase 9: the block-route tail called K3-u8 with {kw8}, not "
             "with the skip of its padding slots")
    # K1 and K2 alone on the batch's operands: event times, which no
    # profiler window can lose
    k12_ms = {n_: time_ms(lambda f_=f_, a_=c_[0]: f_(*a_[0], **a_[1]), 10)
              for (_, n_), f_, c_ in zip(wrapped[1:], originals[1:],
                                         calls.values())}
    del calls
    B8, R8 = a8[4].shape
    # both contracts held against the plain version (-inf at the same
    # places, 1e-5 relative, exactly 0 where the plain score is 0), timed
    # beside their bounds, with the readings inside
    try:
        ins = k3u8_probe.inside(a8, 10)
    except AssertionError as e:
        fail(f"phase 9: {e}")
    b8, c8 = ins["skip"], ins["clamped"]
    k3u8 = dict(
        name="rescore_u8", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30",
        max_abs_err=b8["max_abs_err"], max_rel_err=b8["max_rel_err"],
        ms=ins["ms_skip"],
        plain_ms=time_ms(lambda: k3u8_probe.plain(a8, True), 2),
        library_ms=None, bound_ms=b8["bound_ms"], bound_by=b8["bound_by"],
        bound_as_scheduled_ms=b8["bound_as_scheduled_ms"],
        nonzero_scores=b8["nonzero_scores"], inside=ins)
    log(f"phase 9: K3-u8 on the block route's own [{B8}, {R8}] expanded "
        f"candidates ({ins['in_range_slots']} in range): with the skip "
        f"{ins['ms_skip']:.4f} ms, max rel err {b8['max_rel_err']:.3g} on "
        f"{b8['nonzero_scores']} nonzero scores (bound "
        f"{b8['bound_ms']:.4f} ms by {b8['bound_by']}: "
        f"{b8['real_entries']} real entries, {b8['hit_entries']} hits; "
        f"{b8['bound_as_scheduled_ms']:.4f} with every read row read); "
        f"clamped {ins['ms_clamped']:.4f} ms, max rel err "
        f"{c8['max_rel_err']:.3g} (bound {c8['bound_ms']:.4f}, "
        f"{c8['bound_as_scheduled_ms']:.4f} with every row read); every id "
        f"on one document of {ins['one_doc_nnz']} entries "
        f"{ins['ms_one_doc']:.4f} ms; in-range slots repeating a document "
        f"of their query's row {json.dumps(ins['repeat_share'])}; plain "
        f"{k3u8['plain_ms']:.3f} ms in 256-query slices")
    # its ptxas lines (registers, spills) from phase 1's build: both
    # variants, no spill
    # K3-u8 is the instances of rescore_lean_kernel<FormU8, ...>; the
    # other forms (phase 11) are the same template: twenty instances, five
    # forms x two load variants x two contracts, none may spill
    ptx8 = ptxas_of("rescore", U8_FORM_MANGLED)
    if len(ptx8) != 4 or not all(ptx8.values()):
        fail(f"phase 9: not four ptxas reports of K3-u8's rescore_lean_kernel "
             f"(two load variants x two contracts): {ptx8}")
    k3u8["ptxas"] = ptx8
    log(f"phase 9: K3-u8 rescore_lean_kernel<FormU8> ptxas: {ptx8}")
    ptx_all = ptxas_of("rescore", "rescore_lean_kernel")
    spills = [ln for lns in ptx_all.values() for ln in lns
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if len(ptx_all) != 20 or spills:
        fail(f"phase 9: {len(ptx_all)} ptxas reports of rescore_lean_kernel "
             f"(20 expected), spills: {spills}")
    record["phase11"]["ptxas_rescore_lean"] = ptx_all
    del a8
    torch.cuda.empty_cache()

    # ---- the block-pool route: REPS timed batches ----
    zero_launches()
    lat, res = [], None
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    counts = hold_launches(
        "phase 9: the block-pool route", read_launches(),
        positive=("qloc", "score_grouped_i8", "rescore_u8"))
    record["launch_windows"]["dotvbyte"] = counts
    s_b, i_b = as_arrays(res, "block route")
    p50 = float(np.median(lat))
    qps = BATCH * REPS / sum(lat)

    # every score the exact dot of the document's decoded u8 row with the
    # query's top score_cut terms
    q_comps, q_vals = pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    qct = torch.from_numpy(q_comps).to(dev)
    qvt = torch.from_numpy(q_vals).to(dev)
    top_c, top_v, _ = engine._query_terms(qct, qvt, 64)
    docs8 = fwd_csr(arrays, dev)

    def worst_err(s_, i_):
        return max_rel_err(torch.from_numpy(s_).to(dev), exact_of(
            docs8, top_c, top_v, torch.from_numpy(i_).to(dev)))

    worst_b = worst_err(s_b, i_b)
    nq = len(gt)
    r_b = recall_at(gt, i_b[:nq])
    log(f"phase 9: block-pool route, {REPS} batches of {BATCH} at "
        f"heap_factor {DOTV_HEAP_FACTOR}: QPS {qps:.1f}, p50 "
        f"{p50 * 1e3:.2f} ms, launches {counts}; scores exact to "
        f"{worst_b:.3g}; recall@10 {r_b:.4f} on {nq} queries")
    if not worst_b <= 1e-5:
        fail(f"phase 9: block-route scores differ from the exact dots of "
             f"the u8 rows by {worst_b} relative")

    # ---- the same queries with a block budget: the engine's rescore mode
    def shared(i_):
        return float(np.mean([len(set(a) & set(b)) / K
                              for a, b in zip(i_b.tolist(), i_.tolist())]))

    zero_launches()
    res_e, dt_e = run(block_budget=DOTV_ENGINE_BUDGET)
    ecounts = hold_launches("phase 9: the engine's rescore mode",
                            read_launches(), positive=("rescore_u8",))
    record["launch_windows"]["dotvbyte_engine"] = ecounts
    s_e, i_e = as_arrays(res_e, "engine")
    worst_e = worst_err(s_e, i_e)
    agree, r_e = shared(i_e), recall_at(gt, i_e[:nq])
    res_d, dt_d = run(block_budget=DOTV_DEFAULT_BUDGET)
    s_d, i_d = as_arrays(res_d, "engine, default budget")
    worst_e = max(worst_e, worst_err(s_d, i_d))
    agree_d, r_d = shared(i_d), recall_at(gt, i_d[:nq])
    log(f"phase 9: engine rescore mode, block_budget {DOTV_ENGINE_BUDGET}: "
        f"{dt_e * 1e3:.2f} ms, launches {ecounts}; scores exact to "
        f"{worst_e:.3g}; recall@10 {r_e:.4f}; the block route's top-10 "
        f"shares {agree:.4f} of its entries (at block_budget "
        f"{DOTV_DEFAULT_BUDGET}: {dt_d * 1e3:.2f} ms, recall@10 {r_d:.4f}, "
        f"shares {agree_d:.4f})")
    if not worst_e <= 1e-5:
        fail(f"phase 9: engine scores differ from the exact dots by "
             f"{worst_e} relative")
    if agree < DOTV_AGREE_FLOOR:
        fail(f"phase 9: block and engine top-10 share {agree:.4f} of "
             f"entries, under {DOTV_AGREE_FLOOR}")

    # ---- the block route with n_knn on the graph load_knn read ----
    zero_launches()
    res_k, dt_k = run(n_knn=NKNN)
    kcounts = hold_launches(
        "phase 9: the block-pool route with n_knn", read_launches(),
        positive=("qloc", "score_grouped_i8", "rescore_u8"))
    record["launch_windows"]["dotvbyte_knn"] = kcounts
    if not kcounts["rescore_u8"] > counts["rescore_u8"] // REPS:
        fail(f"phase 9: K3-u8 launched {kcounts['rescore_u8']} times with "
             "n_knn, no more than a batch without")
    s_k, i_k = as_arrays(res_k, "n_knn")
    worst_k = worst_err(s_k, i_k)
    r_k = recall_at(gt, i_k[:nq])
    log(f"phase 9: block route with n_knn={NKNN}: {dt_k * 1e3:.2f} ms, "
        f"launches {kcounts}; scores exact to {worst_k:.3g}; recall@10 "
        f"{r_k:.4f} ({r_b:.4f} without)")
    if not worst_k <= 1e-5:
        fail(f"phase 9: refined scores differ from the exact dots by "
             f"{worst_k} relative")
    if (s_k[:, -1] < s_b[:, -1]).any():
        fail("phase 9: refinement lowered some query's 10th score")
    if not record["rehearsal"]:
        got = dict(block=r_b, engine_512=r_e, engine_64=r_d, knn=r_k)
        off = {n_: (got[n_], r_) for n_, r_ in DOTV_RECALL_REF.items()
               if abs(got[n_] - r_) > DOTV_RECALL_TOL}
        if off:
            fail(f"phase 9: recall@10 (this run, recorded) moved more than "
                 f"{DOTV_RECALL_TOL}: {off}")
    del docs8
    torch.cuda.empty_cache()

    def u8_ms(kern):  # K3-u8's device ms in a profiler window
        ms = sum(v for k_, v in kern.items() if "rescore_lean_kernel" in k_)
        return ms if ms else "not measured"

    # ---- where one block-route batch's time goes ----
    params = block_pool_params(K, E)
    g0 = gc_ms()
    t = [time.perf_counter()]
    enc = [vidx._encode_query(c, v) for c, v in zip(tq, qvals)]
    t.append(time.perf_counter())
    qc2, qv2 = pad_queries([e[0] for e in enc], [e[1] for e in enc],
                           DEFAULT_QUERY_PAD)
    t.append(time.perf_counter())
    plan = plan_grouped(qc2, qv2, bctx, QUERY_CUT, native=True)
    t.append(time.perf_counter())
    args = (bindex, DevicePlan.put(plan, dev), torch.from_numpy(qc2).to(dev),
            torch.from_numpy(qv2).to(dev), params)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = _grouped_impl(*args)
    t_enq = time.perf_counter()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out[0].cpu(), out[1].cpu()
    t.append(time.perf_counter())
    brk = {name_: (t[i + 1] - t[i]) * 1e3 for i, name_ in enumerate(
        ("encode_tokens_ms", "pad_queries_ms", "plan_ms", "upload_ms",
         "device_program_ms", "download_ms"))}
    brk.update(enqueue_ms=(t_enq - t[4]) * 1e3, gc_ms=gc_ms() - g0,
               plan={"G": plan.G, "W": plan.W, "G_cap": plan.G_cap,
                     "W_cap": plan.W_cap})
    brk.update(device_events_ms=time_ms(lambda: _grouped_impl(*args), 5),
               kernel_event_ms=dict(k12_ms, rescore_u8=k3u8["ms"]))
    # a window is read only where it holds each kernel the batch launches
    # (cold windows lost K1 and K2)
    try:
        prof, kern = profile_held(lambda: _grouped_impl(*args), (
            "qloc_kernel", "score_grouped_i8_kernel", "rescore_lean_kernel"))
        brk.update(prof, device_idle_share=idle_share(
            prof["device_busy_ms"], brk["device_program_ms"]))
        k3u8["device_ms_in_batch"] = u8_ms(kern)
        # K3-u8 in the engine's budget-512 batch (32 launches, clamped) and
        # in the n_knn batch (the route's call and the refinement round's)
        for name_, kw_ in (("engine_512", dict(
                block_budget=DOTV_ENGINE_BUDGET)), ("knn", dict(n_knn=NKNN))):
            _, kern_ = profile_held(lambda kw_=kw_: run(**kw_),
                                    ("rescore_lean_kernel",))
            k3u8[f"device_ms_{name_}"] = u8_ms(kern_)
    except NoProfile as e:  # informational only
        brk["profile"] = f"not measured: {e}"
        k3u8["device_ms_in_batch"] = "not measured"
    log(f"phase 9 breakdown of one block-route batch: {json.dumps(brk)}")
    log(f"phase 9: K3-u8 device ms in profiler windows: one block-route "
        f"batch {k3u8['device_ms_in_batch']}, the engine at block_budget "
        f"{DOTV_ENGINE_BUDGET} {k3u8.get('device_ms_engine_512')}, the "
        f"block route with n_knn={NKNN} {k3u8.get('device_ms_knn')}")
    rec.update(qps=qps, p50_ms=p50 * 1e3, latencies_s=lat, launches=counts,
               recall_at_10=r_b, recall_at_10_engine=r_e,
               recall_at_10_knn=r_k, engine_block_budget=DOTV_ENGINE_BUDGET,
               engine_batch_ms=dt_e * 1e3, knn_batch_ms=dt_k * 1e3,
               block_engine_agreement=agree,
               default_budget=dict(block_budget=DOTV_DEFAULT_BUDGET,
                                   batch_ms=dt_d * 1e3, recall_at_10=r_d,
                                   block_engine_agreement=agree_d),
               max_rel_score_err=max(
                   worst_b, worst_e, worst_k), engine_launches=ecounts,
               knn_launches=kcounts, breakdown=brk, k3_u8=k3u8,
               recall_queries=nq)
    del eindex, args, out
    torch.cuda.empty_cache()

    # ---- phase 10 (e, f): the hashed block view, the bin-packed one ----
    dotvbyte_rest_path(
        dict(vidx=vidx, arrays=arrays, bindex=bindex, bctx=bctx, E=E, tq=tq,
             qids=qids, qvals=qvals, gt=gt, qc2=qc2, qv2=qv2, r_b=r_b,
             qps=qps, p50=p50), dev, record)
    del vidx, bindex
    gc.collect()
    torch.cuda.empty_cache()
    return k3u8


def dotvbyte_rest_path(env, dev, record) -> dict:
    """Phase 10 (e, f), inside phase 9 on its arrays and queries: the
    DotVByte class on an index without dense summaries (the hashed block
    view), and the bin-packed dense block view against phase 9's
    unpacked one. Returns its record."""
    import dataclasses

    import torch

    from seismic_tpu_torch import SeismicIndexDotVByte
    from seismic_tpu_torch.api import block_pool_params
    from seismic_tpu_torch.ops.tiles_prep import (
        block_pool_arrays,
        narrow_vocab,
    )
    from seismic_tpu_torch.search import engine
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl
    from seismic_tpu_torch.search.planner import PlannerContext, plan_grouped

    rec = record.setdefault("rest", {})
    t_phase = time.time()
    vidx, arrays, bindex, bctx, E = (env[k_] for k_ in (
        "vidx", "arrays", "bindex", "bctx", "E"))
    tq, qids, qvals, gt, qc2, qv2 = (env[k_] for k_ in (
        "tq", "qids", "qvals", "gt", "qc2", "qv2"))
    nq = len(gt)
    hand = ("qloc_kernel", "score_grouped_i8_kernel", "rescore_lean_kernel")
    qct, qvt = torch.from_numpy(qc2).to(dev), torch.from_numpy(qv2).to(dev)
    top_c, top_v, _ = engine._query_terms(qct, qvt, 64)
    docs8 = fwd_csr(arrays, dev)

    # ---- (e) the DotVByte class without dense summaries: hashed blocks
    hidx = SeismicIndexDotVByte(
        dataclasses.replace(arrays, dense_summary=None), vidx._doc_ids,
        vidx._token_to_id, vidx._contents, device=dev)
    t0 = time.perf_counter()
    hb, hctx, hE = hidx.block_device_index()
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    if hb.tile_hash != vidx._block_V or hb.vocab16 is not None or hE != E:
        fail(f"phase 10e: the block view is not hashed {vidx._block_V} "
             f"wide (tile_hash {hb.tile_hash}, block_expand {hE})")

    def hrun():
        return hidx.batch_search(qids, tq, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=DOTV_HEAP_FACTOR)

    hrun()  # warm-up
    lat = []

    def timed():
        for _ in range(REPS):
            t_ = time.perf_counter()
            res_ = hrun()
            lat.append(time.perf_counter() - t_)
        return res_

    res, _, counts_e = counted(
        "phase 10e: the hashed block route", "dotvbyte_hashed", record,
        timed, positive=("qloc", "score_grouped_i8", "rescore_u8"))
    s_h = np.array([[x[1] for x in r] for r in res], np.float32)
    i_h = np.array([[int(x[2][1:]) for x in r] for r in res], np.int64)
    if s_h.shape != (BATCH, K) or not np.isfinite(s_h).all():
        fail("phase 10e: the hashed block route's results are not finite "
             f"[{BATCH}, {K}]")
    err_e = max_rel_err(torch.from_numpy(s_h).to(dev), exact_of(
        docs8, top_c, top_v, torch.from_numpy(i_h).to(dev)))
    if not err_e <= 1e-5:
        fail(f"phase 10e: hashed block scores differ from the exact dots of "
             f"the u8 rows by {err_e}")
    r_e = recall_at(gt, i_h[:nq])
    plan_h = plan_grouped(qc2, qv2, hctx, QUERY_CUT, native=True)
    args_h = (hb, DevicePlan.put(plan_h, dev), qct, qvt,
              block_pool_params(K, E))
    busy_e = busy_of(lambda: _grouped_impl(*args_h), hand)
    p50_e = float(np.median(lat))
    rec["dotvbyte_hashed"] = dict(
        V=int(hb.tile_hash), view_upload_s=view_s,
        block_index_bytes=hb.nbytes(),
        dense_block_index_bytes=bindex.nbytes(), recall_at_10=r_e,
        dense_recall_at_10=env["r_b"], qps=BATCH * REPS / sum(lat),
        p50_ms=p50_e * 1e3, dense_qps=env["qps"],
        dense_p50_ms=env["p50"] * 1e3, max_rel_score_err=err_e,
        launches=counts_e, busy=busy_e, recall_queries=nq)
    log(f"phase 10e: SeismicIndexDotVByte without dense summaries: hashed "
        f"block view (V={hb.tile_hash}) {view_s:.2f} s, device bytes "
        f"{hb.nbytes()} (dense view {bindex.nbytes()}); batch_search of "
        f"{BATCH} at heap_factor {DOTV_HEAP_FACTOR}: QPS "
        f"{rec['dotvbyte_hashed']['qps']:.1f}, p50 {p50_e * 1e3:.2f} ms "
        f"(dense: {env['qps']:.1f}, {env['p50'] * 1e3:.2f} ms), recall@10 "
        f"{r_e:.4f} on {nq} queries (dense {env['r_b']:.4f}), scores exact "
        f"to {err_e:.3g}, launches {counts_e}; one batch's device time "
        f"{json.dumps(busy_e)}")
    del hidx, hb, args_h
    torch.cuda.empty_cache()

    # ---- (f) the bin-packed dense block view against phase 9's unpacked
    # one: the same view (the members in the order phase 9's upload holds
    # them), packed ----
    t0 = time.perf_counter()
    width = int(bindex.doc_tiles_aligned.shape[1])
    bv = block_pool_arrays(narrow_vocab(arrays, width), width)
    bvp = dataclasses.replace(bv, postings=bindex.postings.cpu().numpy(),
                              pack_bins=True)
    pidx = bvp.to_device(dev)
    pctx = PlannerContext.from_arrays(bvp)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    params = block_pool_params(K, E)
    args_p = (pidx, DevicePlan.put(plan_grouped(qc2, qv2, pctx, QUERY_CUT,
                                                native=True), dev),
              qct, qvt, params)
    args_u = (bindex, DevicePlan.put(plan_grouped(qc2, qv2, bctx, QUERY_CUT,
                                                  native=True), dev),
              qct, qvt, params)
    _grouped_impl(*args_p)  # warm-up
    (s_p, i_p), wall_p, counts_f = counted(
        "phase 10f: the bin-packed block view", "packed", record,
        lambda: _grouped_impl(*args_p),
        positive=("qloc", "score_grouped_i8", "rescore_u8"))
    s_u, i_u = _grouped_impl(*args_u)
    fin = torch.isfinite(s_u)
    rel_f = max_rel_err(s_p[fin], s_u[fin]) if bool(fin.any()) else 0.0
    if not (torch.equal(i_p, i_u) and torch.equal(fin, torch.isfinite(s_p))
            and rel_f <= 1e-5):
        fail(f"phase 10f: the packed view's results differ from the "
             f"unpacked view's (ids equal {torch.equal(i_p, i_u)}, score "
             f"rel err {rel_f})")
    by_p, by_u = pidx.doc_tiles_aligned.numel(), \
        bindex.doc_tiles_aligned.numel()
    busy_f = busy_of(lambda: _grouped_impl(*args_p), hand)
    busy_u = busy_of(lambda: _grouped_impl(*args_u), hand)
    rec["packed"] = dict(
        view_upload_s=pack_s, aligned_rows_bytes=by_p,
        unpacked_aligned_rows_bytes=by_u, block_index_bytes=pidx.nbytes(),
        unpacked_block_index_bytes=bindex.nbytes(), wall_ms=wall_p,
        max_rel_score_err=rel_f, launches=counts_f, busy=busy_f,
        unpacked_busy=busy_u)
    log(f"phase 10f: bin-packed block view ({pack_s:.2f} s): ids equal to "
        f"the unpacked view's on {BATCH} queries, scores to {rel_f:.3g}; "
        f"aligned block rows {by_p} bytes (unpacked {by_u}); {wall_p:.2f} "
        f"ms, launches {counts_f}; device time packed {json.dumps(busy_f)}, "
        f"unpacked {json.dumps(busy_u)}")
    rec["phase_ef_s"] = time.time() - t_phase
    log(f"phase 10 (e, f): {rec['phase_ef_s']:.1f} s")
    del pidx, args_p, args_u, docs8
    torch.cuda.empty_cache()
    return rec


# ---- phase 11: the forward-row and vocabulary forms, sketches, flat ----
# the large-vocabulary cell: XLM-RoBERTa's vocabulary, the one BGE-M3's
# sparse head emits over, at local vocabularies 512 wide
LV_DIM, LV_V = 250_002, 512
# phase 11d's documents: cut from the cells' 100,000 to keep the script,
# with phases 12-14, inside its time limit; its aligned tiles (a 16.4 GB
# floor) and the kernels' shapes do not depend on the count
LV_DOCS = 2_000
# K3's tolerance against its plain version (phases 2 and 9)
K3_RTOL = 1e-5
# the cand_budget values of phase 11c
CAND_BUDGETS = (256, 1024)


def p11(record, key: str) -> dict:
    return record.setdefault("phase11", {}).setdefault(key, {})


def kernel_ms_of(kern: dict, needle: str):
    """Device ms of the profiled kernels whose names hold `needle`, or
    None."""
    ms = [v for k_, v in kern.items() if needle in k_]
    return float(sum(ms)) if ms else None


def k3_form_bounds(real, ids, qc, entry_bytes, row_extra: int) -> dict:
    """K3's bounds for one form of the rows: `real` bool [n_docs, W] the
    real entries, `entry_bytes` the bytes an entry takes in each array
    the kernel reads (e.g. (4,) half-width words, (2, 1) int16 ids and u8
    codes), `row_extra` the bytes a row reads beside them ((min, step)).
    `bound_ms`: each distinct row's real entries once, each array's run
    rounded up to 32-byte sectors, its extra bytes, the doc ids, the terms
    and the output, against a lookup and a multiply-add an entry of every
    row at the f32 rate; `bound_as_scheduled_ms`: every row read once."""
    import torch

    safe = ids.long().clamp(0, real.shape[0] - 1)
    nnz = real.sum(-1)

    def row_bytes(n):
        return sum(int(((n * b + 31) // 32 * 32).sum().item())
                   for b in entry_bytes) + row_extra * n.numel()

    other = ids.numel() * 8 + qc.numel() * 8
    nbytes = row_bytes(nnz[torch.unique(safe)]) + other
    row_nnz = nnz[safe]
    sched = row_bytes(row_nnz) + other
    b, bb = bound(nbytes, 2.0 * float(row_nnz.sum().item()), PEAK_F32)
    return dict(bound_ms=b, bound_by=bb,
                bound_as_scheduled_ms=sched / PEAK_BYTES * 1e3,
                bytes=nbytes, bytes_as_scheduled=sched)


def keep_calls(module, name: str, n: int):
    """Wrap module.name so its first n calls' arguments are kept; returns
    (the kept list, a function restoring the original)."""
    orig = getattr(module, name)
    kept = []

    def keeping(*a, **kw):
        if len(kept) < n:
            kept.append((a, kw))
        return orig(*a, **kw)

    setattr(module, name, keeping)
    return kept, lambda: setattr(module, name, orig)


def check_k3_form(a, kw, tag: str, plain_fn, kernel_fn, real, entry_bytes,
                  row_extra, reps: int = 20) -> dict:
    """One of K3's forms against its plain version on the call's own
    operands `a` (kernel_fn(*a, **kw)): 1e-5 relative, exactly 0 where
    the plain score is 0, -inf at the same slots; both timed beside the
    form's bounds."""
    import torch

    k = kernel_fn(*a, **kw)
    p = plain_fn(*a, **kw)
    if not torch.equal(torch.isneginf(k), torch.isneginf(p)):
        fail(f"K3 {tag}: -inf at other slots than its plain version's")
    fin = torch.isfinite(p)
    rel = max_rel_err(k[fin], p[fin]) if fin.any() else 0.0
    if not rel <= K3_RTOL or not (k[p == 0] == 0).all():
        fail(f"K3 {tag} disagrees with its plain version: max relative "
             f"error {rel}")
    ids, qc = a[-4], a[-3]
    return dict(
        max_abs_err=float((k[fin] - p[fin]).abs().max().item()),
        max_rel_err=rel, B=ids.shape[0], R=ids.shape[1],
        ms=time_ms(lambda: kernel_fn(*a, **kw), reps),
        plain_ms=time_ms(lambda: plain_fn(*a, **kw), 3), library_ms=None,
        **k3_form_bounds(real, ids, qc, entry_bytes, row_extra))


def result_tensors(res, dev):
    """API results (lists of (score, doc)) as (scores f32, ids int64)
    [B, K] tensors on the card, -inf / -1 where a row is short."""
    import torch

    s = np.full((len(res), K), -np.inf, np.float32)
    i = np.full((len(res), K), -1, np.int64)
    for r, row in enumerate(res):
        for j, (sc, d) in enumerate(row):
            s[r, j], i[r, j] = sc, d
    return torch.from_numpy(s).to(dev), torch.from_numpy(i).to(dev)


def half_width_path(env, dev, record) -> None:
    """Phase 11a, inside phase 4 on its index: the forward rows uploaded
    again in the half-width form (`to_device(fwd_f16=True)`'s rows,
    `types.py::fused16_rows`), the rest of the upload shared; the
    headline at both batch shapes, K3-f16 against its plain version on
    the path's own operands, every score the exact dot of the f16-rounded
    row, recall@10 beside phase 4's, busy ms and K3's device ms."""
    import dataclasses

    import torch

    from seismic_tpu_torch.ops import rescore
    from seismic_tpu_torch.search.grouped import (
        plan_caps,
        search_grouped_derive,
    )
    from seismic_tpu_torch.types import fused16_rows

    rec = p11(record, "fwd16")
    t_phase = time.time()
    arrays, dindex, ctx, gt = (env[k_] for k_ in ("arrays", "dindex", "ctx",
                                                  "gt"))
    qcn, qvn, qcd, qvd = (env[k_] for k_ in ("qcn", "qvn", "qcd", "qvd"))
    qcB, qvB, gcB, wcB = (env[k_] for k_ in ("qcB", "qvB", "gcB", "wcB"))
    params, QC = headline_params(), QUERY_CUT
    t0 = time.perf_counter()
    d16 = dataclasses.replace(
        dindex, fwd_fused=None, fwd_fused16=torch.from_numpy(
            fused16_rows(arrays.fwd_comps, arrays.fwd_vals)).to(dev))
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rows_b, fused_b = (d16.fwd_fused16.numel() * 4,
                       dindex.fwd_fused.numel() * 4)

    def b4096():
        return [search_grouped_derive(
            d16, qcd[b], qvd[b], params, QC, 8,
            *plan_caps(qcn[b], qvn[b], ctx, QC, M=8), ctx.zero_region)
            for b in range(len(qcn))]

    def big():
        return search_grouped_derive(d16, qcB, qvB, params, QC, BIG_M, gcB,
                                     wcB, ctx.zero_region)

    kept, restore = keep_calls(rescore, "score_docs_rowmajor_fused16", 8)
    try:
        b4096()
        big()
    finally:
        restore()
    (outs, (s16, i16)), wall, counts = counted(
        "phase 11a: the headline on half-width rows", "fwd16", record,
        lambda: (b4096(), big()),
        positive=("qloc", "score_grouped_i8_item", "rescore_f16"))
    s4 = torch.cat([o[0] for o in outs])
    i4 = torch.cat([o[1] for o in outs])
    docs16 = fwd_csr(dataclasses.replace(
        arrays, fwd_vals=np.asarray(arrays.fwd_vals).astype(np.float16)),
        dev)
    err = max(exact_scores_err(docs16, qcB, qvB, s4, i4),
              exact_scores_err(docs16, qcB, qvB, s16, i16))
    del docs16
    if not err <= 1e-5:
        fail(f"phase 11a: scores differ from the exact dots of the "
             f"f16-rounded rows by {err}")
    r4, r16 = (recall_at(gt, x.cpu().numpy()) for x in (i4, i16))
    real = d16.fwd_fused16 >> 16 >= 0
    k3 = {}
    for (a, kw) in (kept[0], kept[-1]):
        tag = f"b{a[1].shape[0]}"
        k3[tag] = check_k3_form(
            a, kw, f"f16 ({tag})", rescore.score_docs_rowmajor_fused16_plain,
            rescore.score_docs_rowmajor_fused16, real, (4,), 0)
    try:
        busy, kern = profile_held(big, ("qloc_kernel", "score_item_kernel",
                                        "rescore_lean_kernel"), top=8)
    except NoProfile as e:
        busy, kern = {"profile": f"not measured: {e}"}, {}
    k3_dev = kernel_ms_of(kern, "rescore_lean_kernel")
    rec.update(upload_s=upload_s, rows_bytes=rows_b,
               fused_rows_bytes=fused_b, wall_ms=wall, launches=counts,
               max_rel_score_err=err, recall_at_10_b4096=r4,
               recall_at_10_b16384=r16,
               recall_at_10_phase4=env["rec16"], k3=k3, busy=busy,
               k3_device_ms_b16384=k3_dev, phase_s=time.time() - t_phase)
    main = k3[f"b{BATCH}"]
    record["phase11_kernels"]["rescore_f16"] = dict(
        name="rescore_fused16", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30",
        **{k_: main[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        at_b16384=k3[f"b{N_QUERIES}"])
    log(f"phase 11a: half-width rows ({rows_b} bytes against the fused "
        f"rows' {fused_b}, uploaded in {upload_s:.2f} s): launches "
        f"{ {n_: c for n_, c in counts.items() if c} }; every score the "
        f"exact dot of the f16 row to {err:.3g}; recall@10 {r4:.4f} / "
        f"{r16:.4f} (phase 4: {env['rec16']:.4f}); K3-f16 == plain "
        f"({main['max_rel_err']:.3g}), {main['ms']:.4f} ms at B={BATCH} "
        f"(bound {main['bound_ms']:.4f} by {main['bound_by']}), "
        f"{k3[f'b{N_QUERIES}']['ms']:.4f} ms at B={N_QUERIES} (bound "
        f"{k3[f'b{N_QUERIES}']['bound_ms']:.4f}); busy "
        f"{busy.get('device_busy_ms')} ms, K3 device {k3_dev} ms; "
        f"{rec['phase_s']:.1f} s")


def convert_path(index, qcomps, qvals, gt, dev, record) -> None:
    """Phase 11b, on phase 3's API index (a second instance over its
    arrays, so the index itself stays f16): `convert("u8")`,
    `convert("u16")` and `convert("f16")`, each searched on 4096 queries
    at heap_factor 0 (K3-u8, K3-u16, K3 fused), every score exact against
    the decoded rows, K3's form against its plain version on the path's
    operands, recall@10 on 256 queries beside phase 3's, device bytes."""
    import torch

    from seismic_tpu_torch import SeismicIndexRaw
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.ops import rescore

    rec = p11(record, "convert")
    t_phase = time.time()
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)
    qct, qvt = (torch.from_numpy(x).to(dev) for x in (q_comps, q_vals))
    for dt, count, form in (("u8", "rescore_u8", (2, 1)),
                            ("u16", "rescore_u16", (2, 2)),
                            ("f16", "rescore", None)):
        idx = SeismicIndexRaw(index.arrays, device=dev)
        if idx.convert(dt) is not idx:
            fail("phase 11b: convert did not return the index")
        t0 = time.perf_counter()
        dix = idx.device_index()
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0

        def run():
            return idx.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                    heap_factor=0.0)

        wrapped = (rescore, "score_docs_rowmajor_lean" if form
                   else "score_docs_rowmajor")
        kept, restore = keep_calls(*wrapped, 1)
        try:
            run()
        finally:
            restore()
        res, wall, counts = counted(f"phase 11b: convert({dt!r})",
                                    f"convert_{dt}", record, run,
                                    positive=("qloc", "score_grouped_i8",
                                              count))
        s_, i_ = result_tensors(res, dev)
        docs = fwd_csr(idx.arrays, dev)
        err = exact_scores_err(docs, qct, qvt, s_, i_)
        del docs
        if not err <= 1e-5:
            fail(f"phase 11b: convert({dt!r}) scores differ from the exact "
                 f"dots of the decoded rows by {err}")
        r = recall_at(gt, i_[:len(gt)].cpu().numpy())
        one = dict(upload_s=upload_s, device_index_bytes=dix.nbytes(),
                   wall_ms=wall, launches=counts, max_rel_score_err=err,
                   recall_at_10=r)
        if form:
            a, kw = kept[0]
            real = a[0] >= 0
            one["k3"] = check_k3_form(
                a, kw, f"{dt} (convert)",
                rescore.score_docs_rowmajor_lean_plain,
                rescore.score_docs_rowmajor_lean, real, form, 8)
        rec[dt] = one
        log(f"phase 11b: convert({dt!r}): device bytes "
            f"{one['device_index_bytes']}, launches "
            f"{ {n_: c for n_, c in counts.items() if c} }, every score "
            f"the exact dot of the decoded row to {err:.3g}, recall@10 "
            f"{r:.4f}" + (f", K3 form == plain, {one['k3']['ms']:.4f} ms "
                          f"(bound {one['k3']['bound_ms']:.4f})"
                          if form else ""))
        del idx, dix
        gc.collect()
        torch.cuda.empty_cache()
    rec.update(recall_at_10_phase3=record["recall_at_10"],
               phase_s=time.time() - t_phase)
    k = rec["u16"]["k3"]
    record["phase11_kernels"]["rescore_u16"] = dict(
        name="rescore_u16", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30",
        **{k_: k[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")})
    log(f"phase 11b: {rec['phase_s']:.1f} s")


def sketch_path(index, qcomps, qvals, gt, dev, record) -> None:
    """Phase 11c, on phase 5's engine index: block sketches made from the
    index's CSR summaries as the NumPy build path makes them (the native
    build keeps doc sketches but no block sketches), then the engine at
    heap_factor 0.8, gather doc mode, with `block_mode="sketch"` and with
    `cand_budget` 256 and 1024 on dense block ranking: no hand kernel, no
    host sync, every score exact, recall@10 on 256 queries (no floor),
    the sketch products' device ms."""
    import torch

    from seismic_tpu_torch.build.builder import summary_block_sketches
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search import engine
    from seismic_tpu_torch.search.engine import SearchParams

    rec = p11(record, "sketch")
    t_phase = time.time()
    arrays = index.arrays
    layout = arrays.config.layout
    sd, seed = layout.sketch_dim, layout.sketch_seed
    t0 = time.perf_counter()
    bsk, bsc = summary_block_sketches(arrays, sd, seed)
    sketch_s = time.perf_counter() - t0
    # on the device copy only: the host arrays stay the build's (phase 8e
    # holds them equal to a JSONL build's)
    dix = index.device_index()
    if dix.doc_sketch is None:
        fail("phase 11c: the upload holds no doc sketches")
    dix.block_sketch = torch.from_numpy(bsk).to(dev)
    dix.block_sketch_scale = torch.from_numpy(bsc).to(dev)
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)
    qct, qvt = (torch.from_numpy(x).to(dev) for x in (q_comps, q_vals))
    docs = fwd_csr(arrays, dev)
    base = dict(k=K, query_cut=QUERY_CUT, block_budget=max(4 * K, 64),
                doc_mode="gather")
    cases = [("sketch", SearchParams(block_mode="sketch", **base))] + [
        (f"cand_{c}", SearchParams(cand_budget=c, **base))
        for c in CAND_BUDGETS]
    hf = float(np.float32(0.8))
    for name, sp in cases:
        def run():
            return engine.search_batch(dix, q_comps, q_vals, sp,
                                       heap_factor=0.8, sketch_dim=sd,
                                       sketch_seed=seed)

        kept, restore = keep_calls(engine, "_sketch_scores", 2)
        try:
            run()
        finally:
            restore()
        (s_, i_), wall, counts = counted(f"phase 11c: {name}",
                                         f"sketch_{name}", record, run,
                                         positive=())
        syncs = count_syncs(lambda: engine._search_impl(
            dix, qct, qvt, hf, sp, sd, seed))
        if syncs:
            fail(f"phase 11c: the engine program with {name} synchronised "
                 f"with the host {syncs} times")
        st, it = (torch.from_numpy(x).to(dev) for x in (s_, i_))
        err = exact_scores_err(docs, qct, qvt, st, it)
        if not err <= 1e-5:
            fail(f"phase 11c: {name} scores differ from exact dots by {err}")
        r = recall_at(gt, i_[:len(gt)])
        prods = {("block" if a[0] is dix.block_sketch else "doc"): dict(
            shape=list(a[2].shape),
            ms=time_ms(lambda a=a: engine._sketch_scores(*a), 10))
            for a, _ in kept}
        rec[name] = dict(wall_ms=wall, host_syncs=syncs,
                         max_rel_score_err=err, recall_at_10=r,
                         sketch_products=prods)
        log(f"phase 11c: {name}: recall@10 {r:.4f}, wall {wall:.1f} ms, "
            f"{syncs} host syncs, scores exact to {err:.3g}, sketch "
            f"products {json.dumps(prods)}")
    del docs
    dix.block_sketch = dix.block_sketch_scale = None
    rec.update(block_sketch_s=sketch_s, block_sketch_bytes=bsk.nbytes,
               recall_at_10_engine_dense=record["engine"]["recall_at_10"],
               phase_s=time.time() - t_phase)
    log(f"phase 11c: {rec['phase_s']:.1f} s (block sketches from the "
        f"summaries {sketch_s:.2f} s)")


def flat_path(ds, qcomps, qvals, dev, record) -> None:
    """Phase 11e: `FlatTermIndex` of phase 3's corpus on the card, 256
    queries held against `exact_search` (top-10 agreement, exact up to u8
    quantization), wall time."""
    import torch

    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.search.exact import exact_search
    from seismic_tpu_torch.search.flat import FlatTermIndex

    rec = p11(record, "flat")
    t0 = time.perf_counter()
    flat = FlatTermIndex.build(ds)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat.device_arrays(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nq = 256
    q_comps, q_vals = pad_queries(qcomps[:nq], qvals[:nq], 128)
    (s_f, i_f), wall, _ = counted(
        "phase 11e: FlatTermIndex", "flat", record,
        lambda: flat.search_batch(q_comps, q_vals, K, device=dev),
        positive=())
    s_e, i_e = exact_search(ds, q_comps, q_vals, K, device=dev)
    agree = recall_at(i_e, i_f)
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), DIM)).to(dev)
    qct, qvt = (torch.from_numpy(x).to(dev) for x in (q_comps, q_vals))
    st, it = (torch.from_numpy(x).to(dev) for x in (s_f, i_f))
    err = exact_scores_err(docs, qct, qvt, st, it)
    del docs
    rec.update(build_s=build_s, upload_s=upload_s, wall_ms=wall,
               host_bytes=int(flat.columns.nbytes), top10_agreement=agree,
               max_rel_score_err=err, queries=nq)
    log(f"phase 11e: FlatTermIndex [{flat.columns.shape[0]} x "
        f"{flat.columns.shape[1]}] u8 ({flat.columns.nbytes} bytes), build "
        f"{build_s:.1f} s, upload {upload_s:.2f} s, {nq} queries in "
        f"{wall:.1f} ms; top-10 agreement with exact_search {agree:.4f}, "
        f"scores within {err:.3g} of the exact dots")
    if agree < 0.9 or not err <= 0.02:
        fail(f"phase 11e: FlatTermIndex agrees with exact_search on "
             f"{agree} of the top-10 and its scores within {err}: past u8 "
             "quantization")
    del flat
    gc.collect()
    torch.cuda.empty_cache()


def lv_path(n_docs: int, dev, record) -> None:
    """Phase 11d, last: `SeismicIndexRawLV.build_from_csr` on a
    250,002-term collection (the API cell's pruning and layout, local
    vocabularies 512 wide), `batch_search` of 4096 queries at heap_factor
    0 (K1 on the int32 vocabulary, K2, K3 fused) and one batch with the
    row-major projection (K8 on int32 rows), then `convert("u8")` and the
    same batch (K3 on int32 ids beside u8 codes), then one engine batch at
    heap_factor 0.8; every score exact, the kernel path against the
    plain-scorer path on 256 queries, recall@10 against a brute-force
    product, the K1 / K8 / K3 forms against their plain versions."""
    import dataclasses

    import torch

    from seismic_tpu_torch import (
        Configuration,
        GlobalThresholdPruning,
        SeismicIndexRawLV,
    )
    from seismic_tpu_torch.api import route_params
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
    from seismic_tpu_torch.harness.synth import synth_dataset, synth_queries
    from seismic_tpu_torch.ops import grouped_scorer, qloc_rowmajor
    from seismic_tpu_torch.ops import rescore
    from seismic_tpu_torch.search import grouped
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl
    from seismic_tpu_torch.search.planner import plan_grouped

    rec = p11(record, "lv")
    t_phase = time.time()
    # every list holds at least one 128-row subtile: the aligned tiles
    # alone take LV_DIM * 128 * LV_V bytes on the host and on the card
    floor_b = LV_DIM * 128 * LV_V
    log(f"phase 11d: dim {LV_DIM}, V {LV_V}: the aligned tiles take at "
        f"least {floor_b} bytes (128 rows a list), against "
        f"{30522 * 128 * 1024} at dim 30522, V 1024")
    t0 = time.perf_counter()
    ds = synth_dataset(n_docs, dim=LV_DIM, seed=7)
    qcomps, qvals = synth_queries(BATCH, dim=LV_DIM, seed=11)
    synth_s = time.perf_counter() - t0
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=dataclasses.replace(cell_layout(), summary_vocab_cap=LV_V))
    t0 = time.perf_counter()
    index = SeismicIndexRawLV.build_from_csr(ds, cfg, device=dev)
    build_s = time.perf_counter() - t0
    arrays = index.arrays
    host_b = int(arrays.doc_tiles.nbytes)
    t0 = time.perf_counter()
    dix = index.device_index()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not (dix.vocab16 is None and dix.list_vocab.dtype == torch.int32
            and dix.fwd_fused is not None):
        fail("phase 11d: the upload holds no int32 vocabulary or no fused "
             "rows")
    aligned_b = int(dix.doc_tiles_aligned.numel())
    log(f"phase 11d: synth {synth_s:.1f} s, build {build_s:.1f} s (doc "
        f"tiles {host_b} bytes on the host), upload {upload_s:.1f} s: "
        f"device index {dix.nbytes()} bytes, aligned tiles {aligned_b}")
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)
    qct, qvt = (torch.from_numpy(x).to(dev) for x in (q_comps, q_vals))

    def run(qc_=qcomps, qv_=qvals, hf=0.0):
        return index.batch_search(qc_, qv_, k=K, query_cut=QUERY_CUT,
                                  heap_factor=hf)

    # the route calls K1 through the name search/grouped.py imported
    kept1, restore1 = keep_calls(grouped, "project_qloc_quantize", 1)
    try:
        run()
    finally:
        restore1()
    res, wall, counts = counted(
        "phase 11d: the LV grouped route", "lv", record, run,
        positive=("qloc_i32", "score_grouped_i8", "rescore"))
    s_, i_ = result_tensors(res, dev)
    docs = fwd_csr(arrays, dev)
    err = exact_scores_err(docs, qct, qvt, s_, i_)
    if not err <= 1e-5:
        fail(f"phase 11d: LV scores differ from exact dots by {err}")
    # recall@10 on 256 queries against a brute-force product
    nq = 256
    full = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), LV_DIM)).to(dev)
    ok = qct[:nq] != int(PAD_COMPONENT)
    col = torch.arange(nq, device=dev)[:, None].expand(nq, qct.shape[1])
    qd = torch.zeros((LV_DIM, nq), dtype=torch.float32, device=dev)
    qd[qct[:nq][ok].long(), col[ok]] = qvt[:nq][ok]
    gt = torch.topk(torch.sparse.mm(full, qd), K, dim=0).indices.t()
    gt = gt.cpu().numpy()
    del full, qd
    r0 = recall_at(gt, i_[:nq].cpu().numpy())
    # the kernel path against the plain-scorer path on 256 queries
    sub = (qcomps[:nq], qvals[:nq])
    _, i_k = result_tensors(run(*sub), dev)
    kernel_scorer = grouped.score_grouped_i8
    grouped.score_grouped_i8 = grouped_scorer.score_grouped_i8_plain
    try:
        _, i_p = result_tensors(run(*sub), dev)
    finally:
        grouped.score_grouped_i8 = kernel_scorer
    same = id_set_share(i_k, i_p)
    if same < GATE_SHARE:
        fail(f"phase 11d: the kernel path and the plain-scorer path share "
             f"id sets on {same} of {nq} queries")
    # K1 on the int32 vocabulary (with K8 on the same rows) against its
    # plain versions on the route's own operands
    a1 = kept1[0][0]
    k1, _ = check_k1(a1, "LV int32")
    # K8 on int32 rows, on the main path: the route's program with the
    # row-major projection
    plan = plan_grouped(q_comps, q_vals, index._grouped_ctx(), QUERY_CUT,
                        native=True)
    rp = dataclasses.replace(route_params(K), qloc_mode="rowmajor")
    (s_r, i_r), wall_r, counts_r = counted(
        "phase 11d: the LV route with the row-major projection",
        "lv_rowmajor", record,
        lambda: _grouped_impl(dix, DevicePlan.put(plan, dev), qct, qvt, rp),
        positive=("qloc_rowmajor_i32", "score_grouped_i8", "rescore"))
    if not torch.equal(i_r.cpu(), i_.cpu()):
        fail("phase 11d: the row-major projection's results differ from "
             "the lane-major route's")
    vocab, pair_list, top_c, top_v, QC = a1
    a8 = (vocab[pair_list.long()], top_c.repeat_interleave(QC, dim=0),
          top_v.repeat_interleave(QC, dim=0))
    P, V = a8[0].shape
    n8 = a8[0].numel() * 4 + a8[1].numel() * 8 + P * V + P * 4
    b8, bb8 = bound(n8, float(P * V), PEAK_F32)
    k8 = dict(max_abs_err=0.0,
              ms=time_ms(lambda: qloc_rowmajor.project_qloc_rowmajor(*a8),
                         20),
              plain_ms=time_ms(
                  lambda: qloc_rowmajor.project_qloc_rowmajor_plain(*a8), 3),
              bound_ms=b8, bound_by=bb8, library_ms=None, P=P, V=V)
    del a8
    rec.update(n_docs=len(ds), nnz=int(ds.nnz), synth_s=synth_s,
               build_s=build_s, upload_s=upload_s,
               aligned_tiles_floor_bytes=floor_b, host_doc_tiles_bytes=host_b,
               device_index_bytes=dix.nbytes(), aligned_tiles_bytes=aligned_b,
               wall_ms=wall, launches=counts, max_rel_score_err=err,
               recall_at_10=r0, plain_scorer_id_sets_equal=same,
               rowmajor=dict(wall_ms=wall_r, launches=counts_r),
               k1=k1, k8=k8)
    log(f"phase 11d: grouped route: {wall:.1f} ms, launches "
        f"{ {n_: c for n_, c in counts.items() if c} }, scores exact to "
        f"{err:.3g}, recall@10 {r0:.4f} on {nq}, kernel vs plain-scorer "
        f"id sets {same:.4f}; K1 int32 == plain, {k1['ms']:.4f} ms (bound "
        f"{k1['bound_ms']:.4f}); row-major: ids equal, K8 int32 "
        f"{k8['ms']:.4f} ms (bound {k8['bound_ms']:.4f})")
    del dix
    # ---- K9 on the int32 vocabulary: the same arrays, vocab_residue=8 ----
    index._invalidate_device()
    gc.collect()
    torch.cuda.empty_cache()
    k9 = lv_residue_path(arrays, plan, qct, qvt, gt, docs, r0, k1, dev,
                         record)
    del docs
    # ---- convert("u8"): int32 ids beside u8 codes ----
    if index.convert("u8") is not index:
        fail("phase 11d: convert did not return the index")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dix = index.device_index()
    torch.cuda.synchronize()
    upload8_s = time.perf_counter() - t0
    if not (dix.fwd_comps is not None and dix.fwd_comps.dtype == torch.int32
            and dix.fwd_vals.dtype == torch.uint8):
        fail("phase 11d: the u8 upload holds no int32 ids beside u8 codes")
    kept3, restore3 = keep_calls(rescore, "score_docs_rowmajor_lean", 1)
    try:
        run()
    finally:
        restore3()
    res8, wall8, counts8 = counted(
        "phase 11d: the LV grouped route on u8 codes", "lv_u8", record, run,
        positive=("qloc_i32", "score_grouped_i8", "rescore_i32"))
    s8, i8 = result_tensors(res8, dev)
    docs8 = fwd_csr(index.arrays, dev)
    err8 = exact_scores_err(docs8, qct, qvt, s8, i8)
    del docs8
    if not err8 <= 1e-5:
        fail(f"phase 11d: u8 scores differ from the exact dots of the "
             f"decoded rows by {err8}")
    a3, kw3 = kept3[0]
    k3 = check_k3_form(a3, kw3, "int32 ids, u8 codes",
                       rescore.score_docs_rowmajor_lean_plain,
                       rescore.score_docs_rowmajor_lean,
                       a3[0] != int(PAD_COMPONENT), (4, 1), 8)
    r8 = recall_at(gt, i8[:nq].cpu().numpy())
    # ---- one engine batch at heap_factor 0.8 ----
    res_e, wall_e, counts_e = counted(
        "phase 11d: the LV engine batch", "lv_engine", record,
        lambda: run(hf=0.8), positive=("score_tiles",))
    s_e, i_e = result_tensors(res_e, dev)
    if not torch.isfinite(s_e).any():
        fail("phase 11d: the engine batch returned no result")
    r_e = recall_at(gt, i_e[:nq].cpu().numpy())
    rec.update(upload_u8_s=upload8_s, device_index_bytes_u8=dix.nbytes(),
               u8=dict(wall_ms=wall8, launches=counts8,
                       max_rel_score_err=err8, recall_at_10=r8, k3=k3),
               engine=dict(wall_ms=wall_e, launches=counts_e,
                           recall_at_10=r_e),
               phase_s=time.time() - t_phase)
    log(f"phase 11d: convert('u8') upload {upload8_s:.1f} s ("
        f"{rec['device_index_bytes_u8']} bytes): {wall8:.1f} ms, launches "
        f"{ {n_: c for n_, c in counts8.items() if c} }, scores exact to "
        f"{err8:.3g}, recall@10 {r8:.4f}; K3 int32/u8 == plain, "
        f"{k3['ms']:.4f} ms (bound {k3['bound_ms']:.4f}); engine at 0.8: "
        f"{wall_e:.1f} ms, recall@10 {r_e:.4f}; {rec['phase_s']:.1f} s")
    kp = record["phase11_kernels"]
    for key, name, rep, kr in (
            ("qloc_i32", "qloc_quantize_i32", "pallas_qloc.py:25", k1),
            ("qloc_rowmajor_i32", "qloc_rowmajor_i32", "pallas_qloc.py:77",
             k8),
            ("rescore_i32", "rescore_i32_u8", "pallas_rescore.py:30", k3),
            ("qloc_residue_i32", "qloc_residue_i32", "pallas_qloc.py:152",
             k9)):
        kp[key] = dict(
            name=name, route="cuda",
            source=("seismic_tpu_torch/csrc/rescore.cu" if "rescore" in key
                    else "seismic_tpu_torch/csrc/qloc.cu"),
            replaces=f"seismic_tpu/ops/{rep}",
            **{k_: kr[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")})
    del dix, index, arrays, ds
    gc.collect()
    torch.cuda.empty_cache()


def lv_residue_path(arrays, plan, qct, qvt, gt, docs, r_plain, k1, dev,
                    record) -> dict:
    """Phase 11d's residue upload: `to_device(vocab_residue=8)` of the
    dim-250,002 arrays and the 4096-query batch at heap_factor 0 through
    K9 on the int32 vocabulary (window `lv_residue`); K9-int32 against its
    plain version on the batch's own operands, timed beside its bound and
    K1-int32; every score exact; recall@10 beside the plain upload's.
    Returns K9-int32's record."""
    import torch

    from seismic_tpu_torch.api import route_params
    from seismic_tpu_torch.ops import qloc_residue
    from seismic_tpu_torch.search import grouped
    from seismic_tpu_torch.search.grouped import DevicePlan, _grouped_impl

    rec = p11(record, "lv")
    RES = 8
    t0 = time.perf_counter()
    dres = arrays.to_device(dev, vocab_residue=RES)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not (dres.vocab16 is None and dres.list_vocab.dtype == torch.int32
            and dres.vocab_residue == RES):
        fail("phase 11d: the residue upload holds no int32 vocabulary")
    rp = route_params(K)

    def run():
        return _grouped_impl(dres, DevicePlan.put(plan, dev), qct, qvt, rp)

    kept, restore = keep_calls(grouped, "project_qloc_residue", 1)
    try:
        run()
    finally:
        restore()
    (s_, i_), wall, counts = counted(
        "phase 11d: the LV route on the residue upload", "lv_residue",
        record, run, positive=("qloc_residue_i32", "score_grouped_i8",
                               "rescore"))
    err = exact_scores_err(docs, qct, qvt, s_, i_)
    if not err <= 1e-5:
        fail(f"phase 11d: residue scores differ from exact dots by {err}")
    r_ = recall_at(gt, i_[:len(gt)].cpu().numpy())
    a9, kw9 = kept[0]
    vocab, pair_list, qcb = a9[0], a9[1], a9[2]
    k_i8, k_sc = qloc_residue.project_qloc_residue(*a9, **kw9)
    p_i8, p_sc = qloc_residue.project_qloc_residue_plain(*a9, **kw9)
    f_k = qloc_residue.project_qloc_residue(*a9)
    f_p = qloc_residue.project_qloc_residue_plain(*a9)
    if not (torch.equal(k_i8, p_i8) and torch.equal(k_sc, p_sc)
            and torch.equal(f_k, f_p)):
        fail(f"phase 11d: K9-int32 disagrees with its plain version: "
             f"{(k_i8 != p_i8).sum().item()} codes, "
             f"{(f_k != f_p).sum().item()} f32 slots")
    del p_i8, p_sc, f_k, f_p
    P, V = pair_list.numel(), vocab.shape[1]
    # the bytes: each distinct int32 vocab row once, the pair list, the
    # terms, the buckets, the int8 output and the scales
    nbytes = (torch.unique(pair_list).numel() * V * 4 + P * 4
              + a9[4].numel() * 8 + qcb.numel() * 8 + P * V + P * 4)
    b9, bb9 = bound(nbytes, float(P * V), PEAK_F32)
    ptx = {fn: lns for fn, lns in ptxas_of(
        "qloc", "qloc_residue_kernelIi").items()}
    k9 = dict(max_abs_err=0.0,
              ms=time_ms(lambda: qloc_residue.project_qloc_residue(
                  *a9, **kw9), 20),
              plain_ms=time_ms(lambda: qloc_residue.project_qloc_residue_plain(
                  *a9, **kw9), 3),
              f32_output_ms=time_ms(
                  lambda: qloc_residue.project_qloc_residue(*a9), 20),
              bound_ms=b9, bound_by=bb9, library_ms=None, P=P, V=V,
              bytes=nbytes, k1_i32_ms=k1["ms"], ptxas=ptx)
    rec["residue"] = dict(upload_s=upload_s, device_index_bytes=dres.nbytes(),
                          wall_ms=wall, launches=counts,
                          max_rel_score_err=err, recall_at_10=r_,
                          recall_at_10_plain_upload=r_plain, k9=k9)
    log(f"phase 11d: vocab_residue={RES} upload {upload_s:.1f} s "
        f"({dres.nbytes()} bytes): {wall:.1f} ms, launches "
        f"{ {n_: c for n_, c in counts.items() if c} }, scores exact to "
        f"{err:.3g}, recall@10 {r_:.4f} (plain upload {r_plain:.4f}); "
        f"K9-int32 == plain, {k9['ms']:.4f} ms quantized, "
        f"{k9['f32_output_ms']:.4f} ms f32 (K1-int32 {k1['ms']:.4f} ms; "
        f"bound {b9:.4f} ms by {bb9}, plain {k9['plain_ms']:.3f} ms); ptxas "
        f"{json.dumps(ptx)}")
    if not ptx:
        fail("phase 11d: no ptxas report of K9-int32")
    del dres, kept, a9
    gc.collect()
    torch.cuda.empty_cache()
    return k9


def aligned_cache_path(env, dev, record) -> None:
    """Phase 4's aligned-tile cache: the index saved (its graph left out)
    as env's `index_dir`, phase 14's `_nw512` dir, `load_or_build_aligned`
    beside it twice (build and write, then memory-mapped), an upload from
    the cache equal to the plain upload, one B=4096 call on it equal to
    the plain upload's bit for bit. Phase 14's drivers read the dir and
    its cache; its temporary directory removes both."""
    import dataclasses

    import torch

    from seismic_tpu_torch.ops.tiles_prep import load_or_build_aligned
    from seismic_tpu_torch.search.grouped import (
        plan_caps,
        search_grouped_derive,
    )

    rec = record.setdefault("aligned_cache", {})
    arrays, dindex, ctx = env["arrays"], env["dindex"], env["ctx"]
    idx = env["index_dir"]
    t0 = time.perf_counter()
    dataclasses.replace(arrays, knn=None).save_dir(idx)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_or_build_aligned(arrays, idx, CSUB)
    first_s = time.perf_counter() - t0
    cdir = idx[:-len(".dir")] + f".aligned_c{CSUB}.dir"
    written = {f: os.path.getsize(os.path.join(cdir, f))
               for f in sorted(os.listdir(cdir))}
    t0 = time.perf_counter()
    cached = load_or_build_aligned(arrays, idx, CSUB)
    second_s = time.perf_counter() - t0
    if not isinstance(cached[0].base, np.memmap):
        fail("phase 4: the second cache call did not map the files")
    t0 = time.perf_counter()
    cindex = arrays.to_device(dev, tile_csub=CSUB, aligned=cached)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del cached
    if not (torch.equal(cindex.doc_tiles_aligned, dindex.doc_tiles_aligned)
            and torch.equal(cindex.tile_scale, dindex.tile_scale)
            and torch.equal(cindex.list_region_start,
                            dindex.list_region_start)):
        fail("phase 4: the upload from the cache differs from the plain "
             "upload")
    params = headline_params()
    caps = plan_caps(env["qc_np"], env["qv_np"], ctx, QUERY_CUT, M=8)
    out = [search_grouped_derive(ix, env["qc_t"], env["qv_t"], params,
                                 QUERY_CUT, 8, caps[0], caps[1],
                                 ctx.zero_region) for ix in (dindex, cindex)]
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])):
        fail("phase 4: the B=4096 call on the cached upload differs from "
             "the plain upload's")
    rec.update(index_save_s=save_s, first_call_s=first_s,
               second_call_s=second_s, upload_s=upload_s,
               bytes_written=written, bytes_total=sum(written.values()))
    log(f"phase 4: aligned cache: index saved in {save_s:.1f} s; "
        f"load_or_build_aligned {first_s:.1f} s (build and write "
        f"{sum(written.values())} bytes: {written}), then {second_s:.3f} s "
        f"(mapped); upload from the cache {upload_s:.1f} s, equal to the "
        "plain upload; a B=4096 call on it equal bit for bit")
    del cindex, out
    gc.collect()
    torch.cuda.empty_cache()


def brute_top10(ds, qct, qvt, nq: int, dim: int, dev):
    """The exact top-10 of the first `nq` padded queries over the corpus
    `ds`, by a sparse x dense product on the card."""
    import torch

    from seismic_tpu_torch.data.sparse import PAD_COMPONENT

    full = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), dim)).to(dev)
    ok = qct[:nq] != int(PAD_COMPONENT)
    col = torch.arange(nq, device=dev)[:, None].expand(nq, qct.shape[1])
    qd = torch.zeros((dim, nq), dtype=torch.float32, device=dev)
    qd[qct[:nq][ok].long(), col[ok]] = qvt[:nq][ok]
    gt = torch.topk(torch.sparse.mm(full, qd), K, dim=0).indices.t()
    return gt.cpu().numpy()


# phase 12: document shards, and the docs of (c)'s cut of the corpus (cut
# for the time limit)
SHARDS, BLOCK_CUT = 4, 5_000


def sharded_path(ds, dev, record) -> None:
    """Phase 12: document-sharded search on phase 3's corpus (see the
    module docstring)."""
    import dataclasses
    import shutil
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from seismic_tpu_torch import Configuration, GlobalThresholdPruning
    from seismic_tpu_torch.api import (
        DEFAULT_QUERY_PAD,
        block_pool_params,
        route_params,
    )
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.harness.dryrun import dryrun_multichip
    from seismic_tpu_torch.parallel import sharded as sharded_mod
    from seismic_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        make_mesh_global,
    )
    from seismic_tpu_torch.parallel.sharded import ShardedIndex
    from seismic_tpu_torch.search.engine import SearchParams

    rec = record.setdefault("sharded", {})
    t_phase = time.time()
    count = min(torch.cuda.device_count(), SHARDS) if dev.type == "cuda" \
        else 1

    def devices(n):  # n mesh entries over the cards, in turn
        if dev.type != "cuda":
            return [dev] * n
        return [torch.device("cuda", i % count) for i in range(n)]

    def mesh_of(n_data, n_docs):
        return make_mesh(n_docs, n_data, devices=devices(n_data * n_docs))

    # each shard keeps its share of the API cell's list budget (200
    # postings a term over the whole corpus): the shards hold as many
    # postings as phase 3's index
    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200 // SHARDS,
                                       max_fraction=2.0),
        layout=cell_layout())
    qcomps, qvals = synth_queries_distinct(BATCH)
    q_comps, q_vals = pad_queries(qcomps, qvals, DEFAULT_QUERY_PAD)
    qct, qvt = (torch.from_numpy(x).to(dev) for x in (q_comps, q_vals))
    nq = 256
    gt = brute_top10(ds, qct, qvt, nq, DIM, dev)
    gp = route_params(K)

    def grouped(ix):
        return ix.search_batch_grouped(q_comps, q_vals, gp,
                                       query_cut=QUERY_CUT)

    # ---- (a) 4 shards at the API cell's layout ----
    t0 = time.time()
    sh4 = ShardedIndex.build(ds, mesh_of(1, SHARDS), cfg, value_dtype="f16",
                             pallas_tiles=True)
    torch.cuda.synchronize()
    build4_s = time.time() - t0
    kept, restore = keep_calls(sharded_mod, "merge_topk_across_docs", 1)
    try:
        s_w, i_w = grouped(sh4)
    finally:
        restore()
    (ms_in, mi_in), _ = kept[0]
    S_, B_, k_ = ms_in.shape
    fs = ms_in.permute(1, 0, 2).reshape(B_, -1).cpu().numpy()
    fi = mi_in.permute(1, 0, 2).reshape(B_, -1).cpu().numpy()
    order = np.lexsort((np.where(fi >= 0, fi, 2 ** 62), -fs), axis=-1)
    order = order[:, :k_]
    if not (np.array_equal(np.take_along_axis(fs, order, 1), s_w)
            and np.array_equal(np.take_along_axis(fi, order, 1), i_w)):
        fail("phase 12a: the merge differs from a host lexsort of the "
             "shards' results")
    del kept, ms_in, mi_in
    (s4, i4), wall4, counts4 = counted(
        "phase 12a: the grouped route on 4 shards", "sharded", record,
        lambda: grouped(sh4),
        positive=("qloc", "score_grouped_i8", "rescore"))
    if not (np.array_equal(s4, s_w) and np.array_equal(i4, i_w)):
        fail("phase 12a: two calls of the same batch differ")
    r4 = recall_at(gt, i4[:nq])
    r3 = record["recall_at_10"]
    if r4 < r3 - 0.005:
        fail(f"phase 12a: sharded recall@10 {r4:.4f} more than 0.005 under "
             f"phase 3's {r3:.4f}")
    bytes4 = sh4.nbytes()
    postings4 = [int(x.list_len.sum()) for x in sh4.host_shards]
    log(f"phase 12a: 4 shards on {[str(d) for d in sh4.mesh.grid[0]]}: "
        f"build {build4_s:.1f} s, postings {postings4}, bytes on the "
        f"card {bytes4}; grouped batch {wall4:.1f} ms, launches "
        f"{ {n_: c for n_, c in counts4.items() if c} }, recall@10 "
        f"{r4:.4f} (phase 3: {r3:.4f}); merge == host lexsort")
    # mesh 2x4: the same 4 shards (the second row on the first row's
    # devices, so on their uploads), the batch split over "data": equal
    # to mesh 1x4 bit for bit
    mesh24 = mesh_of(2, SHARDS)
    if mesh24.grid[1] != sh4.mesh.grid[0]:
        fail("phase 12a: mesh 2x4's rows are not on the same devices")
    sh24 = dataclasses.replace(sh4, mesh=mesh24,
                               device_index=[sh4.device_index[0]] * 2)
    (s24, i24), wall24, _ = counted(
        "phase 12a: the grouped route on mesh 2x4", "sharded_2x4", record,
        lambda: grouped(sh24),
        positive=("qloc", "score_grouped_i8", "rescore"))
    if not (np.array_equal(s24, s4) and np.array_equal(i24, i4)):
        fail("phase 12a: mesh 2x4 differs from mesh 1x4")
    del sh24
    # save / load
    tmp = tempfile.mkdtemp(prefix="sharded")
    try:
        t0 = time.time()
        sh4.save(os.path.join(tmp, "ix"))
        save_s = time.time() - t0
        t0 = time.time()
        loaded = ShardedIndex.load(os.path.join(tmp, "ix"), sh4.mesh,
                                   pallas_tiles=True)
        load_s = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    s_l, i_l = grouped(loaded)
    if not (np.array_equal(s_l, s4) and np.array_equal(i_l, i4)):
        fail("phase 12a: save / load changed the results")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12a: mesh 2x4 (the batch split over \"data\", {wall24:.1f} "
        f"ms): equal to mesh 1x4 bit for bit; save {save_s:.1f} s / load "
        f"{load_s:.1f} s: identical")

    # ---- (b) the engine route, phase 5's parameters ----
    p5 = SearchParams(k=K, query_cut=QUERY_CUT, block_budget=max(4 * K, 64),
                      block_mode="dense", doc_mode="tiles", full_lists=False,
                      first_sorted=True)
    if p5.block_budget != record["engine"]["block_budget"]:
        fail("phase 12b: the engine parameters are not phase 5's")
    (s_e, i_e), wall_e, counts_e = counted(
        "phase 12b: the engine route on 4 shards", "sharded_engine", record,
        lambda: sh4.search_batch(q_comps, q_vals, p5,
                                 heap_factor=HEAP_FACTOR),
        positive=("score_tiles",))
    r_e = recall_at(gt, i_e[:nq])
    r5 = record["engine"]["recall_at_10"]
    log(f"phase 12b: engine at heap_factor {HEAP_FACTOR}: {wall_e:.1f} ms, "
        f"launches {counts_e['score_tiles']} K7, recall@10 {r_e:.4f} "
        f"(phase 5: {r5:.4f})")

    # ---- (d) an NCCL group of one: the cross-process merge ----
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    if init_distributed(f"localhost:{port}", 1, 0, device=dev):
        fail("phase 12d: a group of one reported more processes")
    try:
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            fail(f"phase 12d: backend {dist.get_backend()}, not {want}")
        gmesh = make_mesh_global(SHARDS, 1, devices=devices(SHARDS))
        shg = dataclasses.replace(sh4, mesh=gmesh)
        (s_g, i_g), wall_g, _ = counted(
            "phase 12d: the grouped route, merged across processes",
            "sharded_nccl", record, lambda: grouped(shg),
            positive=("qloc", "score_grouped_i8", "rescore"))
    finally:
        dist.destroy_process_group()
    if not (gmesh.spans_processes and np.array_equal(s_g, s4)
            and np.array_equal(i_g, i4)):
        fail("phase 12d: the cross-process merge differs from the "
             "in-process merge")
    log(f"phase 12d: {want} group of one on port {port}: the 1x4 batch "
        f"through all_gather and the merge, {wall_g:.1f} ms, equal to the "
        "in-process merge")
    del sh4, shg
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) u8 shards on the block view, on a cut of the corpus ----
    ds_c = ds.subset(np.arange(min(len(ds), BLOCK_CUT)))
    t0 = time.time()
    shb = ShardedIndex.build(ds_c, mesh_of(1, SHARDS), cfg, value_dtype="u8",
                             pallas_tiles=True, tile_block=512,
                             store_doc_tiles=False)
    build_b_s = time.time() - t0
    (s_b, i_b), wall_b, counts_b = counted(
        "phase 12c: the block route on 4 u8 shards", "sharded_block",
        record, lambda: shb.search_batch_grouped(
            q_comps, q_vals, block_pool_params(K, 32), query_cut=QUERY_CUT),
        positive=("qloc", "score_grouped_i8", "rescore_u8"))
    # recall against the cut corpus's own top 10
    r_b = recall_at(brute_top10(ds_c, qct, qvt, nq, DIM, dev), i_b[:nq])
    r9 = record["dotvbyte"]["recall_at_10"]
    bytes_b = shb.nbytes()
    log(f"phase 12c: {SHARDS} u8 shards of {len(ds_c)} docs, block view "
        f"(build {build_b_s:.1f} s, bytes on the card {bytes_b}): "
        f"{wall_b:.1f} ms, launches "
        f"{ {n_: c for n_, c in counts_b.items() if c} }, recall@10 "
        f"{r_b:.4f} (phase 9: {r9:.4f})")
    del shb
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the dry-run stages ----
    t0 = time.time()
    lines = dryrun_multichip(4, device=dev)
    dry_s = time.time() - t0
    if len(lines) != 4 or not all(" ok: " in ln for ln in lines):
        fail(f"phase 12e: dry run {lines}")
    phase3_ms = BATCH / record["qps"] * 1e3
    rec.update(build4_s=build4_s, bytes_per_shard=bytes4,
               postings_per_shard=postings4,
               grouped_ms=wall4, grouped_2x4_ms=wall24, launches=counts4,
               recall_at_10=r4, recall_at_10_phase3=r3,
               n_postings_per_shard=200 // SHARDS, block_docs=len(ds_c),
               save_s=save_s, load_s=load_s, engine_ms=wall_e,
               engine_recall_at_10=r_e, engine_recall_at_10_phase5=r5,
               nccl_ms=wall_g, block_build_s=build_b_s,
               block_bytes_per_shard=bytes_b, block_ms=wall_b,
               block_recall_at_10=r_b, block_recall_at_10_phase9=r9,
               dryrun=lines, dryrun_s=dry_s, phase3_batch_ms=phase3_ms,
               grouped_over_phase3=wall4 / phase3_ms,
               devices=[str(d) for d in devices(4)],
               phase_s=time.time() - t_phase)
    log(f"phase 12: {rec['phase_s']:.1f} s; (a)'s grouped batch "
        f"{wall4:.1f} ms over phase 3's {phase3_ms:.1f} ms = "
        f"{rec['grouped_over_phase3']:.2f} (for the record: the 4 shards "
        f"run one after another on {count} card(s))")


def knn_headline_path(env, dev, record):
    """Phase 8 (c) and (d) on phase 4's index, which carries phase 8a's
    graph: the headline program with `n_knn=16` at B=16384 / M=16 beside
    the same call without it, and the port's `exact_search` of the 16,384
    queries held against phase 4's sparse product."""
    import dataclasses

    import torch

    from seismic_tpu_torch.search.exact import exact_search
    from seismic_tpu_torch.search.grouped import search_grouped_derive

    rec = record.setdefault("knn_headline", {})
    dindex, ctx = env["dindex"], env["ctx"]
    qcB, qvB, gcB, wcB = env["qcB"], env["qvB"], env["gcB"], env["wcB"]
    gt, gt_s = env["gt"], env["gt_scores"]
    base = headline_params()
    pk = dataclasses.replace(base, n_knn=NKNN)

    # ---- (d) exact search against phase 4's sparse product ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex_s, ex_i = exact_search(env["ds"], env["q_comps"], env["q_vals"], K,
                              device=dev)
    exact_s = time.perf_counter() - t0
    B = ex_s.shape[0]
    stream = B * len(env["ds"]) * 4 > 4e9
    rel = np.abs(ex_s - gt_s) / np.maximum(np.abs(gt_s), 1e-30)
    if not rel.max() <= 1e-5:
        fail(f"phase 8d: exact_search scores differ from the sparse product "
             f"by {rel.max()} relative")
    differ = ex_i != gt
    if (differ & (rel > 1e-6)).any():
        fail("phase 8d: exact_search ids differ from the sparse product's "
             "where the scores do not tie within 1e-6")
    n_tied = int(differ.any(axis=1).sum())
    log(f"phase 8d: exact_search of {B} queries over {len(env['ds'])} docs "
        f"(stream branch: {stream}) {exact_s:.2f} s; scores to "
        f"{rel.max():.3g} relative of the sparse product; id lists equal "
        f"but on {n_tied} queries, where the scores tie within 1e-6")

    # ---- (c) the headline program with refinement ----
    def call(p):
        return search_grouped_derive(dindex, qcB, qvB, p, QUERY_CUT, BIG_M,
                                     gcB, wcB, ctx.zero_region)

    call(pk)
    torch.cuda.synchronize()
    timed = {}
    for name, p in (("n_knn_16", pk), ("n_knn_0", base)):
        zero_launches()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = call(p)
        torch.cuda.synchronize()
        timed[name] = ((time.perf_counter() - t0) / REPS * 1e3,
                       hold_launches(f"phase 8c: the headline call, {name}",
                                     read_launches(), positive=(
                                         "qloc", "score_grouped_i8_item",
                                         "rescore")), out)
    record["launch_windows"]["knn_headline"] = timed["n_knn_16"][1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        call(pk)
    except RuntimeError as e:
        fail(f"phase 8c: the refined call synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    s_k, i_k = timed["n_knn_16"][2]
    s_0, i_0 = timed["n_knn_0"][2]
    if s_k.shape != (B, K) or not torch.isfinite(s_k).all():
        fail("phase 8c: refined results are not finite [16384, 10]")
    if not (s_k[:, 1:] <= s_k[:, :-1]).all():
        fail("phase 8c: refined scores are not descending")
    worst = max_rel_err(s_k, exact_of(env["docs"], qcB, qvB, i_k))
    if not worst <= 1e-4:
        fail(f"phase 8c: refined scores differ from exact dots by {worst}")
    if (s_k[:, -1] < s_0[:, -1]).any():
        fail("phase 8c: refinement lowered some query's 10th score")
    r_k, r_0 = recall_at(ex_i, i_k.cpu().numpy()), recall_at(
        ex_i, i_0.cpu().numpy())
    prof = {}
    for name, p in (("n_knn_16", pk), ("n_knn_0", base)):
        try:
            prof[name], _ = profile_held(lambda: call(p),
                                         ("rescore_fused_kernel",))
        except NoProfile as e:  # informational only
            prof[name] = {"profile": f"not measured: {e}"}
    rec.update(exact_search_s=exact_s, exact_stream=stream,
               exact_tied_queries=n_tied, exact_max_rel=float(rel.max()),
               recall_at_10_knn=r_k, recall_at_10_no_knn=r_0,
               call_ms={n_: t[0] for n_, t in timed.items()},
               launches={n_: t[1] for n_, t in timed.items()},
               max_rel_score_err=worst, profile=prof)
    log(f"phase 8c: B={B}/M={BIG_M} with n_knn={NKNN}: recall@10 "
        f"{r_k:.4f} against exact_search ({r_0:.4f} without), scores exact "
        f"to {worst:.3g}, {timed['n_knn_16'][0]:.2f} ms a call over {REPS} "
        f"({timed['n_knn_0'][0]:.2f} without), launches "
        f"{timed['n_knn_16'][1]} (without {timed['n_knn_0'][1]}); one call "
        f"under set_sync_debug_mode('error'); {json.dumps(prof)}")


def api_path(ds, dev, record):
    """Phases 2 and 3 on the API's grouped route (K1-K3), then phase 5,
    the engine path, and phase 8 (a, b, e), on the same index, and phase
    9 (the DotVByte class, from phase 8e's JSONL); returns (the records of
    K1-K3, K7's record, phase 8a's graph, K3-u8's record). Everything it
    builds on the card is freed when it returns."""
    import tempfile

    import torch

    from seismic_tpu_torch import (
        Configuration,
        GlobalThresholdPruning,
        SeismicIndexRaw,
    )
    from seismic_tpu_torch.data.sparse import PAD_COMPONENT, pad_queries
    from seismic_tpu_torch.ops import grouped_scorer
    from seismic_tpu_torch.ops.tiles_prep import SUB, ll_pad_for
    from seismic_tpu_torch.search import knn as knn_mod
    from seismic_tpu_torch.search.grouped import DevicePlan, _top_k
    from seismic_tpu_torch.search.planner import plan_grouped

    cfg = Configuration(
        pruning=GlobalThresholdPruning(n_postings=200, max_fraction=2.0),
        layout=cell_layout(),
    )
    t0 = time.time()
    index = SeismicIndexRaw.build_from_csr(ds, cfg)
    build_index_s = time.time() - t0
    t0 = time.time()
    dindex = index.device_index()
    upload_s = time.time() - t0
    device_bytes = dindex.nbytes()
    log(f"setup: index build {build_index_s:.1f} s, upload {upload_s:.1f} "
        f"s, n_docs {ds.offsets.shape[0] - 1}, nnz {ds.nnz}, device index "
        f"bytes {device_bytes}")
    record.update(index_build_s=build_index_s, upload_s=upload_s,
                  device_index_bytes=device_bytes)
    qcomps, qvals = synth_queries_distinct(BATCH)
    q_comps, q_vals = pad_queries(qcomps, qvals, 128)

    # ---------------- phase 2: kernels against plain versions -------------
    arrays = index.arrays
    plan = plan_grouped(q_comps, q_vals, index._grouped_ctx(), QUERY_CUT)
    dplan = DevicePlan.put(plan, dev)
    B, QC = plan.pair_slot.shape
    P = B * QC
    qct = torch.from_numpy(q_comps).to(dev)
    qvt = torch.where(qct != int(PAD_COMPONENT),
                      torch.from_numpy(q_vals).to(dev), 0.0)
    top_v, top_p = _top_k(qvt, 64)
    top_c = torch.gather(qct, 1, top_p).contiguous()
    top_v = top_v.contiguous()
    kernels = []
    reps = 20

    # K1: qloc + quantize
    pair_list = dplan.pair_list.reshape(P).contiguous()
    k1, k_i8 = check_k1((dindex.vocab16, pair_list, top_c, top_v, QC), "API")
    V = k1["V"]
    kernels.append(dict(
        name="qloc_quantize", route="cuda",
        source="seismic_tpu_torch/csrc/qloc.cu",
        replaces="seismic_tpu/ops/pallas_qloc.py:25", **k1))

    # K2: grouped i8 scorer, fed the main path's own projections
    LLMAX = ll_pad_for(arrays.max_list_len, 1)
    G_cap, M = plan.slot_b.shape
    q8 = k_i8[dplan.slot_pair.long()].reshape(G_cap, M, V).contiguous()
    a2 = (dindex.doc_tiles_aligned, dindex.tile_scale, q8,
          dplan.work_region, dplan.work_g, dplan.work_s, LLMAX)
    k_out = grouped_scorer.score_grouped_i8(*a2)
    p_out = grouped_scorer.score_grouped_i8_plain(*a2)
    Wr = plan.W
    wg = dplan.work_g[:Wr].long()
    ws = dplan.work_s[:Wr].long()
    kb = k_out.view(G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    pb = p_out.view(G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    rel2 = ((kb - pb).abs() / pb.abs().clamp_min(1e-30)).max().item()
    if not rel2 <= 1e-6:
        fail(f"K2 disagrees: max relative error {rel2}")
    ones = torch.ones_like(dindex.tile_scale)
    a2u = (dindex.doc_tiles_aligned, ones) + a2[2:]
    kd = grouped_scorer.score_grouped_i8(*a2u).view(
        G_cap, M, LLMAX // SUB, SUB)[wg, :, ws, :]
    pd = grouped_scorer.grouped_dots_plain(
        dindex.doc_tiles_aligned, q8, dplan.work_region[:Wr],
        dplan.work_g[:Wr]).to(torch.float32)
    if not torch.equal(kd, pd):
        fail("K2 int dots disagree with the plain version")
    n_regions = torch.unique(dplan.work_region[:Wr]).numel()
    by2 = (n_regions * SUB * (V + 4) + plan.G * M * V + Wr * 12
           + Wr * M * SUB * 4)
    ops2 = 2.0 * Wr * M * SUB * V
    b2, bb2 = bound(by2, ops2, PEAK_INT8)
    # library yardstick: one int8 tensor-core product with the same
    # operation count over the same gathered tile rows (one [V, 8] query
    # block for all items: not the same function; timed, never used)
    rows = (dplan.work_region[:Wr].long()[:, None] * SUB
            + torch.arange(SUB, device=dev)).reshape(-1)
    A = dindex.doc_tiles_aligned[rows].view(torch.int8)
    Bq = q8[0].t()  # [V, 8], column-major
    lib_ms = time_ms(lambda: torch._int_mm(A, Bq), reps)
    del A, rows
    kernels.append(dict(
        name="score_grouped_i8", route="cuda",
        source="seismic_tpu_torch/csrc/grouped_scorer.cu",
        replaces="seismic_tpu/ops/pallas_grouped.py:231",
        max_abs_err=float((kb - pb).abs().max().item()),
        ms=time_ms(lambda: grouped_scorer.score_grouped_i8(*a2), reps),
        plain_ms=time_ms(lambda: grouped_scorer.score_grouped_i8_plain(*a2),
                         3),
        bound_ms=b2, bound_by=bb2, library_ms=lib_ms,
    ))
    del k_out, p_out, kd, pd

    # K3: fused rescore over random candidates of the real index
    R = 48
    g3 = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, arrays.n_docs, (B, R), generator=g3,
                        device=dev, dtype=torch.int32)
    k3 = check_k3((dindex.fwd_fused, ids, top_c, top_v, arrays.n_docs),
                  "API", reps)
    kernels.append(dict(
        name="rescore_fused", route="cuda",
        source="seismic_tpu_torch/csrc/rescore.cu",
        replaces="seismic_tpu/ops/pallas_rescore.py:30", **k3))
    for kr in kernels:
        log(f"phase 2: {kr['name']}: ok, max_abs_err {kr['max_abs_err']:.3g}"
            f", {kr['ms']:.4f} ms (bound {kr['bound_ms']:.4f} ms by "
            f"{kr['bound_by']}, plain {kr['plain_ms']:.3f} ms, library "
            f"{kr['library_ms']})")
    del k_i8, q8
    torch.cuda.empty_cache()

    # ---------------- phase 3: the main path ----------------
    def run():
        t = time.time()
        res = index.batch_search(qcomps, qvals, k=K, query_cut=QUERY_CUT,
                                 heap_factor=0.0)
        return res, time.time() - t

    run()  # warm-up (allocator, first launches)
    zero_launches()
    lat, res = [], None
    g0 = gc_ms()
    for _ in range(REPS):
        res, dt = run()
        lat.append(dt)
    gc3 = gc_ms() - g0
    counts = hold_launches(
        "the API's grouped route", read_launches(),
        positive=("qloc", "score_grouped_i8", "rescore"))
    record["launch_windows"] = {"api": counts}
    p50 = float(np.median(lat))
    qps = BATCH * REPS / sum(lat)  # all queries over the whole window
    log(f"phase 3: {REPS} warm batches of {BATCH}: p50 "
        f"{p50 * 1e3:.2f} ms, QPS {qps:.1f}, launches {counts}, "
        f"gc {gc3:.2f} ms")

    # results: shape, finite, sorted, exact rescored scores
    if len(res) != BATCH:
        fail(f"{len(res)} result rows for {BATCH} queries")
    fwd_c, fwd_v = arrays.fwd_comps, arrays.fwd_vals.astype(np.float32)
    for b, row in enumerate(res):
        if len(row) != K:
            fail(f"query {b}: {len(row)} results, expected {K}")
        sc = np.array([s for s, _ in row])
        if not (np.isfinite(sc).all() and (np.diff(sc) <= 0).all()):
            fail(f"query {b}: scores not finite and descending")
        if b < 8:
            qd = dict(zip(qcomps[b].tolist(), qvals[b].tolist()))
            for s, d in row:
                ref = sum(float(v) * qd.get(int(c), 0.0)
                          for c, v in zip(fwd_c[d], fwd_v[d])
                          if c != PAD_COMPONENT)
                if abs(s - ref) > 1e-4 * abs(ref):
                    fail(f"query {b} doc {d}: score {s} != exact {ref}")

    # recall@10 on the first 256 queries against a brute-force product
    nq = 256
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets), torch.from_numpy(
            ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(len(ds), DIM)).to(dev)
    qd = torch.zeros((DIM, nq), dtype=torch.float32)
    for b in range(nq):
        qd[torch.from_numpy(qcomps[b].astype(np.int64)), b] = \
            torch.from_numpy(qvals[b].astype(np.float32))
    exact = torch.sparse.mm(docs, qd.to(dev))  # [n_docs, nq]
    gt = torch.topk(exact, K, dim=0).indices.t().cpu().numpy()
    hits = sum(len(set(gt[b].tolist()) & {d for _, d in res[b]})
               for b in range(nq))
    recall = hits / (K * nq)
    log(f"phase 3: recall@10 {recall:.4f} on {nq} queries")
    if recall < 0.9:
        fail(f"recall@10 {recall:.4f} < 0.9")

    record["breakdown"] = breakdown(index, qcomps, qvals, dev)
    log(f"breakdown of one batch: {json.dumps(record['breakdown'])}")

    record.update(
        qps=qps, p50_ms=p50 * 1e3, batch=BATCH, reps=REPS, gc_ms=gc3,
        latencies_s=lat, recall_at_10=recall, recall_queries=nq,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        plan={"G": plan.G, "W": plan.W, "G_cap": plan.G_cap,
              "W_cap": plan.W_cap, "P": P, "LLMAX": LLMAX},
    )
    del docs, exact
    torch.cuda.empty_cache()

    # ---------------- phase 5: the engine path, same index ----------------
    torch.cuda.reset_peak_memory_stats()
    k7 = engine_path(index, qcomps, qvals, gt, dev, record, kernels)
    # ---- phase 11c: the sketch ranking, on the engine's index ----
    sketch_path(index, qcomps, qvals, gt, dev, record)

    # ------- phase 8 (a, b, e): the graph, refinement, the user API -------
    del dindex, a2, a2u  # the copy build_knn replaces with one that has it
    graph = knn_api_path(index, ds, qcomps, qvals, gt, recall, dev, record)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl, tmap = user_flow_path(index, ds, qcomps, qvals, dev, record,
                                     tmp)
        # ------- phase 9: SeismicIndexDotVByte on the block-pool route ----
        graph_path = knn_mod.save_knn(graph, os.path.join(tmp, "graph"))
        k3u8 = dotvbyte_path(jsonl, tmap, graph_path, qcomps, qvals, gt,
                             dev, record)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase 11 (b, e): convert, and FlatTermIndex, on this corpus ----
    convert_path(index, qcomps, qvals, gt, dev, record)
    flat_path(ds, qcomps, qvals, dev, record)
    return kernels, k7, graph, k3u8


# ---- phase 13: the CLI and the experiment harness ----
# accuracy@10 floors of the shipped TOMLs: JAX's records on the v5e
# (experiments/best_configs_synth/README.md: 0.9721, 0.9803) less 0.01;
# recall floors only, no speed target
CLI_RECALL_FLOORS = {"recall_97": 0.962, "recall_98": 0.97}
# documents of the cut corpora of 13, for the time limit: the grid's (d,
# e, g) and the JSONL's (f: the enhanced build's default layout makes it
# the slowest step per document)
CLI_CUT_DOCS, CLI_JSONL_DOCS = 5_000, 2_000


def _cli_toml(name: str, tmp: str, data: str, extra_query: str = "") -> str:
    """experiments/best_configs_synth/<name>.toml with its [folder] in
    `tmp` (data `data`, experiment `tmp/exp`) and `extra_query` appended
    to its [query.best]; returns the written path."""
    with open(os.path.join(ROOT, "experiments", "best_configs_synth",
                           f"{name}.toml")) as f:
        text = f.read()
    for old, new in (('data = "experiments/data_synth"', f'data = "{data}"'),
                     ('experiment = "experiments_out"',
                      f'experiment = "{os.path.join(tmp, "exp")}"')):
        if old not in text:
            fail(f"phase 13: {name}.toml has no line {old!r}")
        text = text.replace(old, new)
    path = os.path.join(tmp, f"{name}.toml")
    with open(path, "w") as f:
        f.write(text + extra_query)
    return path


def _report_row(report: str) -> dict:
    with open(report) as f:
        head, row = (ln.rstrip("\n").split("\t") for ln in f.readlines()[:2])
    return dict(zip(head, row))


def _run_arrays(path: str, nq: int, k: int = K):
    """(ids int64 [nq, k] -1 padded, scores f32 [nq, k]) of a run file."""
    ids = np.full((nq, k), -1, np.int64)
    scores = np.full((nq, k), -np.inf, np.float32)
    with open(path) as f:
        for line in f:
            q, d, r, sc = line.rstrip("\n").split("\t")
            ids[int(q), int(r)] = int(d)
            scores[int(q), int(r)] = float(sc)
    return ids, scores


def cli_path(ds, dev, record, tmp) -> None:
    """Phase 13, right after phase 12 (the API cell's corpus `ds` still in
    memory): the user workflow of experiments/best_configs_synth through
    each module's `main(argv)`, in directory `tmp` (see the module
    docstring)."""
    import tomllib

    import torch

    from seismic_tpu_torch import SeismicIndex
    from seismic_tpu_torch.cli import (
        build_enhanced_inverted_index,
        convert_json_to_inner_format,
        perf_enhanced_inverted_index,
        perf_inverted_index,
    )
    from seismic_tpu_torch.data.io import read_seismic_format
    from seismic_tpu_torch.data.io import load_token_map
    from seismic_tpu_torch.data.sparse import pad_queries
    from seismic_tpu_torch.harness import (
        bench_knn,
        bench_mem,
        best_configs,
        export_synth,
        profile_stages,
        run_experiments,
        run_grid_search,
    )

    rec = record.setdefault("cli", {})
    steps = rec.setdefault("step_s", {})
    t_phase = time.time()
    n = len(ds)

    def step(name, t0):
        steps[name] = time.time() - t0
        log(f"phase 13{name}: {steps[name]:.1f} s")

    # ---- (a) export: the collection and its ground truth ----
    t0 = time.time()
    cache, data = os.path.join(tmp, "cache"), os.path.join(tmp, "data")
    os.makedirs(cache)
    # the collection in export_synth's cache, so its main reads this ds
    np.savez(os.path.join(cache, f"docs_{n}_{DIM}.npz"), offsets=ds.offsets,
             components=ds.components, values=ds.values)
    if export_synth.main(["--out", data, "--n-docs", str(n), "--cache-dir",
                          cache]) != 0:
        fail("phase 13a: export_synth failed")
    exported = read_seismic_format(os.path.join(data, "documents.bin"), DIM)
    for f_ in ("offsets", "components", "values"):
        if not np.array_equal(getattr(exported, f_), getattr(ds, f_)):
            fail(f"phase 13a: documents.bin's {f_} differ from the corpus")
    del exported
    nq = export_synth.N_QUERIES
    qc_l, qv_l = export_synth.export_queries(nq, DIM)
    qc_np, qv_np = pad_queries(qc_l, qv_l, 64)
    qc_t, qv_t = (torch.from_numpy(x).to(dev) for x in (qc_np, qv_np))
    docs = torch.sparse_csr_tensor(
        torch.from_numpy(ds.offsets),
        torch.from_numpy(ds.components.astype(np.int64)),
        torch.from_numpy(ds.values.astype(np.float32)),
        size=(n, DIM)).to(dev)
    step("a_export", t0)

    def exact_run(path, tag):
        """Every score of a run file the f32 exact dot to 1e-3 relative."""
        ids, sc = _run_arrays(path, nq)
        ok = ids >= 0
        if ok.mean() < 0.99:
            fail(f"phase 13 {tag}: under 99% of the run file's slots filled")
        ex = exact_of(docs, qc_t, qv_t,
                      torch.from_numpy(np.maximum(ids, 0)).to(dev))
        err = max_rel_err(torch.from_numpy(sc[ok]).to(dev), ex[
            torch.from_numpy(ok).to(dev)])
        if not err <= 1e-3:
            fail(f"phase 13 {tag}: run-file scores differ from the exact "
                 f"dots by {err} relative")
        return err

    # ---- (b) recall_97.toml: build CLI, perf CLI (grouped route) ----
    t0 = time.time()
    toml97 = _cli_toml("recall_97", tmp, data)
    reports = {}
    _, wall, c97 = counted(
        "phase 13b: run_experiments recall_97.toml", "cli_97", record,
        lambda: reports.setdefault("recall_97", run_experiments.run_experiment(
            toml97)), positive=("qloc", "score_grouped_i8", "rescore"))
    r97 = _report_row(reports["recall_97"])
    run97 = os.path.join(os.path.dirname(reports["recall_97"]),
                         "run_best.tsv")
    err97 = exact_run(run97, "b")
    acc97 = float(r97["accuracy"])
    rec["recall_97"] = dict(report=r97, launches=c97, max_rel_score_err=err97,
                            floor=CLI_RECALL_FLOORS["recall_97"], wall_ms=wall)
    log(f"phase 13b: recall_97.toml accuracy@10 {acc97:.4f} (floor "
        f"{CLI_RECALL_FLOORS['recall_97']}; JAX's v5e record 0.9721), "
        f"{r97['us_per_query']} us/query, build {float(r97['build_secs']):.1f}"
        f" s, {r97['total_bytes']} bytes, scores exact to {err97:.3g}, "
        f"launches { {k_: v for k_, v in c97.items() if v} }")
    if acc97 < CLI_RECALL_FLOORS["recall_97"]:
        fail(f"phase 13b: accuracy@10 {acc97:.4f} under the floor")
    step("b_recall_97", t0)
    with open(toml97, "rb") as f:
        ip = tomllib.load(f)["indexing_parameters"]
    index = os.path.join(tmp, "exp", "indexes",
                         run_experiments.index_filename(ip)
                         + ".index.seismic_tpu")
    if not os.path.exists(index):
        fail(f"phase 13b: no index at {index}")

    # ---- (c) bench_knn (the graph), then recall_98.toml reusing (b) ----
    t0 = time.time()
    knn_path = os.path.join(tmp, "graph8")
    res_knn, _, c_knn = counted(
        "phase 13c: bench_knn", "cli_knn", record,
        lambda: bench_knn.main([
            "--index", index, "--nknn", "8", "--knn-path", knn_path,
            "--query-file", os.path.join(data, "queries.bin"),
            "--groundtruth", os.path.join(data, "groundtruth.tsv"),
            "--batch", "2048", "--knn-batch", "4096", "--reps", "1"]),
        positive=("score_tiles", "qloc", "score_grouped_i8", "rescore"))
    rec["bench_knn"] = dict(res_knn, launches=c_knn)
    log(f"phase 13c: bench_knn graph {res_knn['graph_shape']} in "
        f"{res_knn['build_s']:.2f} s; rungs {json.dumps(res_knn['rungs'])}")
    step("c_bench_knn", t0)
    t0 = time.time()
    toml98 = _cli_toml("recall_98", tmp, data,
                       f'knn-path = "{knn_path}"\n')
    _, wall, c98 = counted(
        "phase 13c: run_experiments recall_98.toml", "cli_98", record,
        lambda: reports.setdefault("recall_98", run_experiments.run_experiment(
            toml98)), positive=("qloc", "score_grouped_i8", "rescore"))
    r98 = _report_row(reports["recall_98"])
    err98 = exact_run(os.path.join(os.path.dirname(reports["recall_98"]),
                                   "run_best.tsv"), "c")
    acc98 = float(r98["accuracy"])
    rec["recall_98"] = dict(report=r98, launches=c98, max_rel_score_err=err98,
                            floor=CLI_RECALL_FLOORS["recall_98"], wall_ms=wall)
    log(f"phase 13c: recall_98.toml accuracy@10 {acc98:.4f} (floor "
        f"{CLI_RECALL_FLOORS['recall_98']}; JAX's v5e record 0.9803), "
        f"{r98['us_per_query']} us/query, build_secs {r98['build_secs']}, "
        f"scores exact to {err98:.3g}, launches "
        f"{ {k_: v for k_, v in c98.items() if v} }")
    if acc98 < CLI_RECALL_FLOORS["recall_98"]:
        fail(f"phase 13c: accuracy@10 {acc98:.4f} under the floor")
    if float(r98["build_secs"]) != 0.0:
        fail("phase 13c: recall_98 built its index again")
    if not c98["rescore"] > c97["rescore"]:
        fail(f"phase 13c: the refinement round did not launch K3 ("
             f"{c98['rescore']} against {c97['rescore']})")
    step("c_recall_98", t0)
    del docs
    torch.cuda.empty_cache()

    # ---- (e) the grid search on a cut corpus, resumed; best configs ----
    t0 = time.time()
    cut = ds.subset(np.arange(min(CLI_CUT_DOCS, n)))
    cache_cut, data_cut = (os.path.join(tmp, d_) for d_ in ("cache_cut", "data_cut"))
    os.makedirs(cache_cut)
    np.savez(os.path.join(cache_cut, f"docs_{len(cut)}_{DIM}.npz"),
             offsets=cut.offsets, components=cut.components,
             values=cut.values)
    if export_synth.main(["--out", data_cut, "--n-docs", str(len(cut)),
                          "--cache-dir", cache_cut]) != 0:
        fail("phase 13e: export_synth of the cut failed")
    grid_toml = os.path.join(tmp, "grid.toml")
    with open(grid_toml, "w") as f:
        f.write(f"""[settings]
k = 10
exp-name = "cut"

[folder]
data = "{data_cut}"
experiment = "{os.path.join(tmp, 'grid')}"

[filename]
dataset = "documents.bin"
queries = "queries.bin"
groundtruth = "groundtruth.tsv"

[indexing_parameters]
n-postings = [200]
max-fraction = 2.0
max-block-len = 32
summary-vocab-cap = 128
max-doc-nnz = 256
value-type = "f32"

[querying_parameters]
query-cut = [10, 11]
heap-factor = 0.0
batch-size = 2048
full-lists = true
""")
    _, wall_g1, c_g1 = counted(
        "phase 13e: run_grid_search", "cli_grid", record,
        lambda: run_grid_search.main(["--exp", grid_toml]),
        positive=("qloc", "score_grouped_i8", "rescore"))
    root = os.path.join(tmp, "grid", "grid_cut")
    done = run_grid_search.completed_combos(root)
    stamp = {d_: os.path.getmtime(os.path.join(root, d_, "report.tsv"))
             for d_ in done}
    t1 = time.time()
    _, wall_g2, _ = counted(
        "phase 13e: run_grid_search, resumed", "cli_grid_resumed", record,
        lambda: run_grid_search.main(["--exp", grid_toml]), positive=())
    again = {d_: os.path.getmtime(os.path.join(root, d_, "report.tsv"))
             for d_ in run_grid_search.completed_combos(root)}
    if len(done) != 2 or again != stamp:
        fail(f"phase 13e: the resumed grid ran again ({len(done)} combos "
             "complete before it)")
    best_dir = os.path.join(tmp, "best")
    if best_configs.main(["--grid-root", root, "--base-toml", grid_toml,
                          "--recalls", "0.5,0.9", "--output-dir",
                          best_dir]) != 0:
        fail("phase 13e: best_configs failed")
    grid = best_configs.collect_grid_results(root)
    rec["grid"] = dict(results=grid, first_ms=wall_g1, resumed_ms=wall_g2,
                       best=sorted(os.listdir(best_dir)), launches=c_g1)
    accs = [(r["query"]["query-cut"], r["accuracy"]) for r in grid]
    log(f"phase 13e: grid of {len(grid)} combos over {len(cut)} docs "
        f"({wall_g1 / 1e3:.1f} s; resumed {wall_g2:.0f} ms, nothing "
        f"launched): {accs}; best configs {rec['grid']['best']}")
    step("e_grid", t0)
    (grid_index,) = [os.path.join(root, "indexes", f_) for f_ in
                     os.listdir(os.path.join(root, "indexes"))]

    # ---- (d) the perf CLI's engine route on the grid's index ----
    t0 = time.time()
    run_e = os.path.join(tmp, "run_engine.tsv")
    _, wall_e, c_e = counted(
        "phase 13d: the perf CLI's engine route", "cli_engine", record,
        lambda: perf_inverted_index.main([
            "--index-file", grid_index, "--query-file",
            os.path.join(data_cut, "queries.bin"), "--output-path", run_e,
            "-k", str(K), "--query-cut", "10", "--heap-factor", "0.7",
            "--block-budget", "64", "--batch-size", "2048"]),
        positive=("score_tiles",))
    from seismic_tpu_torch.harness.evaluate import accuracy_at_k, read_run_tsv

    acc_e = accuracy_at_k(read_run_tsv(run_e), read_run_tsv(
        os.path.join(data_cut, "groundtruth.tsv")), K)
    rec["engine"] = dict(accuracy=acc_e, launches=c_e, wall_ms=wall_e)
    log(f"phase 13d: engine route (heap-factor 0.7, block budget 64) on the "
        f"{len(cut)}-doc grid index: accuracy@10 {acc_e:.4f}, launches "
        f"{ {k_: v for k_, v in c_e.items() if v} }")
    step("d_engine", t0)

    # ---- (f) convert and the enhanced CLIs on a JSONL cut ----
    t0 = time.time()
    jsonl = os.path.join(tmp, "docs_cut.jsonl")
    jcut = ds.subset(np.arange(min(CLI_JSONL_DOCS, n)))
    write_corpus_jsonl(ds, jsonl, len(jcut))
    qjsonl = os.path.join(tmp, "queries.jsonl")
    qc3, qv3 = synth_queries_distinct(BATCH)  # phase 3's queries
    with open(qjsonl, "w") as f:
        for i, (c, v) in enumerate(zip(qc3, qv3)):
            f.write(json.dumps({"id": f"q{i}", "vector": {
                f"t{x}": y for x, y in zip(c.tolist(), v.tolist())}}) + "\n")
    conv = os.path.join(tmp, "converted")
    if convert_json_to_inner_format.main([
            "--document-path", jsonl, "--query-path", qjsonl,
            "--output-dir", conv]) != 0:
        fail("phase 13f: convert failed")
    tmap = load_token_map(os.path.join(conv, "token_to_id_mapping.json"))
    back = np.zeros(len(tmap), np.int64)
    for tok, i in tmap.items():
        back[i] = int(tok[1:])
    cb = read_seismic_format(os.path.join(conv, "documents.bin"), len(tmap))

    def sorted_csr(offsets, comps, vals):
        rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
        o = np.lexsort((comps, rows))
        return comps[o], vals[o]

    got = sorted_csr(cb.offsets, back[cb.components], cb.values)
    want = sorted_csr(jcut.offsets, jcut.components.astype(np.int64),
                      jcut.values)
    if not (np.array_equal(cb.offsets, jcut.offsets)
            and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        fail("phase 13f: documents.bin, mapped back through the token map, "
             "differs from the cut's CSR")
    enh = os.path.join(tmp, "enhanced")
    if build_enhanced_inverted_index.main([
            "--input-file", jsonl, "--output-file", enh, "--n-postings",
            "200", "--max-fraction", "2.0"]) != 0:
        fail("phase 13f: build_enhanced_inverted_index failed")
    run_f = os.path.join(tmp, "run_enhanced.tsv")
    _, wall_f, c_f = counted(
        "phase 13f: perf_enhanced_inverted_index", "cli_enhanced", record,
        lambda: perf_enhanced_inverted_index.main([
            "--index-file", enh, "--query-file", qjsonl, "--output-path",
            run_f, "-k", str(K), "--query-cut", str(QUERY_CUT),
            "--heap-factor", "0.7"]), positive=("score_tiles",))
    sidx = SeismicIndex.load(enh)
    qids = np.array([f"q{i}" for i in range(len(qc3))], dtype="U30")
    tq = [np.array([f"t{x}" for x in c.tolist()], dtype="U30") for c in qc3]
    rows = sidx.batch_search(qids, tq, qv3, k=K, query_cut=QUERY_CUT,
                             heap_factor=0.7, sorted=False)
    want_lines = [f"{q}\t{d}\t{r}\t{sc:.6f}\n" for rr in rows
                  for r, (q, sc, d) in enumerate(rr)]
    with open(run_f) as f:
        got_lines = f.readlines()
    if got_lines != want_lines:
        fail(f"phase 13f: the enhanced perf CLI's run file differs from "
             f"SeismicIndex.load(...).batch_search ({len(got_lines)} against "
             f"{len(want_lines)} lines)")
    rec["enhanced"] = dict(jsonl_docs=len(jcut), run_lines=len(got_lines),
                           launches=c_f, wall_ms=wall_f,
                           vocabulary=len(tmap))
    log(f"phase 13f: convert == the cut's CSR ({len(tmap)} tokens); the "
        f"enhanced perf CLI's {len(got_lines)} run lines == "
        f"SeismicIndex.load(...).batch_search; launches "
        f"{ {k_: v for k_, v in c_f.items() if v} }")
    del sidx, rows
    step("f_enhanced", t0)

    # ---- (g) profile_stages (both forms), bench_mem at the cut ----
    t0 = time.time()
    prof, _, c_p = counted(
        "phase 13g: profile_stages", "cli_profile", record,
        lambda: profile_stages.main([
            "--index", grid_index, "--batch", "256", "--reps", "3",
            "--query-cut", "10", "--block-budget", "64", "--both"]),
        positive=("rescore", "score_tiles"))
    for form in ("blocks", "tiles"):
        if prof[form]["matches_search_batch"] is not True:
            fail(f"phase 13g: profile_stages' {form} form's final top-k "
                 "differs from the engine program's")
    rec["profile_stages"] = dict(prof, launches=c_p)
    forms = {f_: prof[f_] for f_ in ("blocks", "tiles")}
    log(f"phase 13g: profile_stages (final top-k == the engine program's in "
        f"both forms): {json.dumps(forms)}")
    mem, _, c_m = counted(
        "phase 13g: bench_mem --block", "cli_mem", record,
        lambda: bench_mem.main([
            "--block", "--n-docs", str(len(cut)), "--cache-dir", cache_cut,
            "--max-rungs", "3", "--reps", "3",
            "--out", os.path.join(OUT_DIR, "mem_bench.json")]),
        positive=("qloc", "score_grouped_i8_item", "rescore_u8"))
    rec["bench_mem"] = dict(mem, launches=c_m)
    log(f"phase 13g: bench_mem --block at {len(cut)} docs: device bytes "
        f"{mem['device_bytes']}, rungs {json.dumps(mem['rungs'])}")
    step("g_profile_mem", t0)
    rec["phase_s"] = time.time() - t_phase
    log(f"phase 13: {rec['phase_s']:.1f} s by step {json.dumps(steps)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=N_DOCS,
                    help="cut the corpus for a rehearsal (default 100000)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    try:
        import seismic_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"seismic_tpu_torch is not importable beside this script: {e}")
    from seismic_tpu_torch.harness.synth import synth_dataset
    from seismic_tpu_torch.ops import _cuda

    t_start = time.time()
    gc.callbacks.append(_gc_callback)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "phase11": {}, "phase11_kernels": {}}
    log(f"card: {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    if args.n_docs < N_DOCS:
        log(f"REHEARSAL: n_docs {args.n_docs} < {N_DOCS}, the cell's corpus "
            "is cut")

    # ---------------- phase 1: build the kernels ----------------
    try:
        build_s = _cuda.build(force=True)
    except Exception as e:  # noqa: BLE001 - reported, then fail
        fail(f"kernel build: {e}")
    record["kernel_build_s"] = build_s
    record["ptxas"] = {name: ptxas_of(name, "") for name in _cuda.KERNELS}
    log(f"phase 1: built {len(_cuda.KERNELS)} kernel libraries "
        f"({len(COUNTED)} kernels) in {build_s:.2f} s")
    # each kernel's registers, static shared memory and spills, under the
    # (mangled) name of its template instance
    for name, rep in _cuda.ptxas_report.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1][:100]}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}:   {line.strip()}")

    # ---------------- set-up of the main paths (host build) ----------------
    t0 = time.time()
    ds = synth_dataset(args.n_docs, dim=DIM, seed=7)
    synth_s = time.time() - t0
    log(f"setup: synth {synth_s:.1f} s")
    record.update(n_docs=len(ds), synth_s=synth_s,
                  rehearsal=args.n_docs < N_DOCS)

    # ------- phases 2, 3, 5, 8 (a, b, e) and 9 on the API cell's corpus ----
    kernels, k7, graph, k3u8 = api_path(ds, dev, record)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------- phase 12: document-sharded search ----------------
    sharded_path(ds, dev, record)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------ phase 13: the CLI and the experiment harness ------------
    with tempfile.TemporaryDirectory() as tmp13:
        cli_path(ds, dev, record, tmp13)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------- phase 4: the bench headline path ----------------
    torch.cuda.reset_peak_memory_stats()
    new_kernels, k4 = headline_path(ds, dev, record, kernels, graph)
    kernels += [k4, k7] + new_kernels
    del ds
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------- phase 7: the device probe and microbench ------------
    kernels += probe_path(dev, record) + [k3u8]
    gc.collect()
    torch.cuda.empty_cache()

    # ------- phase 11d, last: the large vocabulary (every index freed) -----
    lv_path(min(args.n_docs, LV_DOCS), dev, record)
    kernels += [record["phase11_kernels"][n_] for n_ in FORM_COUNTS]
    # every count below was read from a wrapper's counter after a window that
    # set all twenty-five to 0 first; `launches` is the count on the kernel's
    # own main path
    windows = record["launch_windows"]
    main_window = dict.fromkeys(COUNTED, "modes")
    main_window.update(qloc="api", score_grouped_i8="api", rescore="api",
                       score_grouped_i8_item="headline", score_tiles="engine")
    main_window.update(dict.fromkeys(PROBE_KERNELS, "probe"),
                       rescore_u8="dotvbyte", rescore_f16="fwd16",
                       rescore_u16="convert_u16", rescore_i32="lv_u8",
                       qloc_i32="lv", qloc_rowmajor_i32="lv_rowmajor",
                       qloc_residue_i32="lv_residue")
    for kr, n_ in zip(kernels, COUNTED, strict=True):
        kr["launches"] = windows[main_window[n_]][n_]
        kr.update({f"launches_{w_}": windows[w_][n_] for w_ in windows})
        if kr["launches"] <= 0:
            fail(f"{kr['name']} never launched on its main path: {windows}")
    # K2, K4 and K6 at V 128 and 384 (phase 6b): each count from its own
    # window at that width
    for kr in record.pop("widths_kernels"):
        kr["launches"] = windows[kr["window"]][kr["name"].split("@")[0]]
        if kr["launches"] <= 0:
            fail(f"{kr['name']} never launched in window {kr['window']}")
        kernels.append(kr)

    total_s = time.time() - t_start
    record.update(kernels=kernels, total_s=total_s)
    try:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    except OSError as e:
        log(f"(record not written: {e})")
    log(f"total {total_s:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
