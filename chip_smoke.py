#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # one NVIDIA card; exits 0 only if all pass
    python3 chip_smoke.py --phases attn_kernel,reduced_serve   # the build
                                   # and these phases alone (see ALONE)

Phases:
  0. build   -- compile the two kernel libraries: the arena scan
                (``csrc/arena_scan.cuh`` and its four entry-point sources)
                and the attention kernels (``csrc/flash_attention.cu``,
                ``csrc/decode_attention.cu``), one nvcc per source, all six
                at once, and print ptxas's register and spill report of
                every scan instantiation; fail when an instantiation of
                tile_scan_kernel or paged_scan_kernel (any mode, PROBE
                included) up to 32 query rows a block spills, and
                hold the host mirror of the scan's launch geometry
                (`kernel.scan_geometry`) to the library's
                (`kernel.scan_info`) over block rows, modes, lanes, groups
                and both regimes.
  1. kernel  -- the arena-scan kernel against its plain PyTorch version on
                the card over a grid of N, D, B, G and k (k > N included),
                plus category 31 / high ACL bits, a BLOCK_ALL group,
                duplicate embeddings and an all-dead arena. Scores agree
                within rtol = atol = 1e-5 (unit-norm data; the two reduce
                in different orders), slots agree except inside a run of
                tied scores at the k-th place, ties go to the lower slot,
                and no returned slot fails its group's predicate (checked
                against a numpy mask computed on the host). After that
                grid, the micro-tile's edges: B 5 / 17 / 33 / 63, D 1 / 3
                / 4 / 100, N 255 / 257, k 1 / 10 / 33, each also paged
                (128-row pages) and bit-identical to the resident lists.
  2. hybrid_kernel -- the hybrid scan (the arena-scan kernel's lexical
                modes, through `hybrid_score_cuda`) against its plain
                version over N, D, B, G, T lanes, QT query terms and k (k > N
                included), wsum (w_dense 0.8, w_lex 1.7) and rrf: padding
                query terms, empty lanes, category 31, high ACL bits, a
                BLOCK_ALL group and adversarial donors (rows of another
                tenant carrying exactly the query's terms). Fused and dense
                scores within rtol = atol = 1e-5, the bm25 list exact, slots
                as in phase 1, no leak; the public `hybrid_score` (rrf fused
                and lists=True, k > N) against the plain oracle too. Then
                the lexical stage's edges (`lex_edge_draws`): tiles where
                every pair is kept, none is, one pair a warp is; T 32 with
                QT 16; T 6 (one lane at a time) -- each also paged at
                100-row pages (a page ends inside a tile) and bit-identical
                to the resident lists.
  3. ivf_kernel -- the IVF probe (the arena-scan kernel's slot-indirect
                PROBE mode, through `ivf_probe_cuda`) against its plain
                version over candidate counts P, D (50 takes the scalar
                loads), B and k (k > P included), on candidate vectors with
                member padding, repeats and slots past or below the arena;
                each vector also compacted on the card (the compaction
                kernel, `compact_candidates_cuda`, equal to its plain
                version) and scanned from the live count it leaves there,
                resident and paged, bit-identical to the uncompacted
                vector's lists; the compaction's edges (every slot dead, 3
                live under k, live counts 1 / 255 / 257 / 511 / 1000 of
                4097, poisoned slots only); through the public `ivf_probe`:
                a padded cluster list, an overflow tail, a poisoned member
                table, all-dead and empty sets, and duplicate embeddings
                listed high slot first. Scores within rtol = atol = 1e-5,
                slots as in phase 1 except that a slot listed m times may
                come out m times and exact ties go to the lower CANDIDATE
                POSITION; no returned slot fails the host mask over the
                arena's metadata.
  4. bench   -- the paper's benchmark deployment (StoreConfig 65,536 x 128,
                50,000 docs, 20 tenants, 5 categories; repro's
                configs/rag_unified.py BENCH / BENCH_CORPUS) through the
                front door: one batch of 32 requests in 4 predicate groups,
                every row held to `unified_query_ref` on the card; then an
                update and a delete, and the cache must miss.
  5. hybrid_bench -- the same deployment with a lexical arena: 32 match()
                requests (`make_keyword_queries`) in 4 groups, wsum and then
                rrf, one launch a batch, every row held to
                `hybrid_score_ref` on the card; hybrid recall@10 above
                dense-only; a lexical write, and the cache must miss.
  6. ivf_bench -- the same deployment with `RagDB.build_index()`: a batch
                of 32 admin requests plans "ivf" and runs as one probe
                launch scanning the probe's candidate rows, every row held
                to the plain version; recall@10 against the exact kernel
                engine over 64 queries; a tenant session stays exact ("ivf
                skipped") and a forced probe leaks nothing; a recency bound
                only ~20 rows clear fires the exact rescan and equals the
                exact engine; a write at a query's embedding patches the
                mirror and is visible; a rebuild bumps the epoch and the
                cache misses.
  7. prod    -- production width on one card: StoreConfig(2^23 x 768) (the
                paper's 2^26-row production hot tier cut to what one 80 GB
                card holds twice during an out-of-place commit) with 16
                postings lanes a row, data drawn on the card and ingested
                through RagDB in 2^20-row chunks, batches of 32 requests in
                4 groups through run(): median batch latency, the kernel's
                own time (CUDA events, and profiled device time) beside its
                bound, the SM clock and power draw while it runs, blocks an
                SM (>= 2 required), ptxas's report of the DENSE kernels,
                the plain version, and a matmul + where + topk yardstick.
  8. hybrid_prod -- the same arena: 6 wsum and 6 rrf batches of 32 match()
                requests in 4 groups (3 terms from a live row's lanes, q
                near its embedding), with the same measurements plus a
                matmul + BM25 + where + topk yardstick and a profile split;
                each group's kept share of (row, query) pairs, the bound
                over all lanes and over the kept rows' lanes only (the one
                the kernel's data needs), `scan_info` of FUSED and BOTH at
                B 32 (>= 2 blocks an SM required); then the keep-all draw
                (every group any tenant, no recency cut, every category
                and ACL bit) held to the plain version (BM25 bit-exact)
                and timed. Then the split-stack baseline
                (`two_scan_hybrid`, wsum) over the same 4 tenant groups,
                with the predicate pushed into both sidecars and without
                it (over-fetch, app-side filter, retries): 0 leaked slots,
                and wherever the fused top-k lies within the union of the
                sidecars' lists, the two-scan set equals it (ties at the
                k-th place aside); batch medians beside the fused batch.
  9. ivf_prod -- the prod arena with the auto-sized index (8192 clusters):
                build time (k-means and assignment on the card, layout on
                the host), 6 batches of 32 admin requests with a recency
                bound, q near a live row: batch latency and idle share, one
                compaction and one probe launch a batch and no rescan; one
                executor launch under torch.cuda.set_sync_debug_mode
                ("error") (no sync between the quantizer and the scan) whose
                rows equal the batch's; the device quantizer's time beside
                the host probe's and the rows whose top-nprobe clusters
                differ (only at a tie within TIE_MARGIN); P, P_live, the
                compaction's and the kernel's times (on the compacted and
                on the padded vector) beside their bounds (over the live
                rows and over all P), the plain versions, a gather + matmul
                + where + topk yardstick, the exact kernel on the same
                rows, recall@10 against it, a profile split, and no (P, D)
                copy allocated by the kernel.
 10. paged_kernel (runs after ivf_kernel) -- the paged kernel
                (`page_rows=`, one running list per page, rows staged
                through a cp.async ring) in its four modes (dense, wsum, rrf,
                probe) over page sizes 128, 256, 1000, 4096 and P >= N, B,
                k (k > 256, k > P, k > N), D (130 takes the 4-byte copies),
                ragged N, G up to 8, T = 16 lanes with QT 1 or 4, duplicate
                rows and a dead stretch of whole pages, and phase 2's
                lexical edges in wsum and rrf at pages of 100 and 300 rows:
                its lists equal the resident kernel's bit for bit and its
                plain version's (the streaming scan at blk_n = P) under
                phase 1's contract, no leak, and `PAGED_LAUNCHES` counts
                every case.
 11. paged_prod -- the prod arena under PlannerConfig(paged_min_rows=2^20):
                the dense, wsum and rrf batches recompiled (a `paging:`
                explain line), 6 of each through `RagDB.execute` as one
                paged launch each, rows bit-identical to the resident
                batch's, `paged_scans` one per fused scan, batch latency and
                a profile; then the kernel alone at pages of 2^13..2^16
                rows beside the resident kernel: CUDA-event and profiled
                device time, bound, profile split, candidate-buffer bytes,
                the launch geometry (blocks per SM, >= 2 required for dense
                at 2^15; shared memory a block; ring stages), the plain
                version's time.
 11b. serve_prod (right after paged_prod, on the same RagDB with its IVF
                index) -- the serving layer under open-loop load on the
                wall clock: `serving.load.run_scenario` and `Scheduler`,
                20 Zipfian tenants (s = 1.1, 32 unit queries each), k = 10,
                batches of up to 32, a quarter of the queries with a
                match() clause from 64 term tuples of the corpus's lanes.
                Mix A pins the exact kernel engine, mix B the IVF probe.
                The reference bench's rules: a capacity probe (256 events
                due at t = 0, admission and cache off; once to warm up,
                once measured) and a 0.8 s saturation run give the
                sustained rate; slo = clip(50 x ms a request, 25, 500);
                max_queue = max(8, rate x slo / 2); degrade pressure 0.3.
                3 s traces: steady (A, 0.5x, cache on), burst (B, 0.45x
                with a 4.5x flash crowd over [0.45, 0.55] of the trace,
                cache off; the FIFO baseline and the scheduler on one
                trace), writes (A, 1.2x, RagDB.update of 8 docs 4 times a
                second, stale serves within 0.2 s). Gates: accounting
                (offered = admitted + shed, one result each, no failure);
                every steady result and up to 64 degraded burst results
                equal bit for bit db.execute of the plan that ran (a probe
                with the plans of its group in its batch); 32 steady
                results against a plain top-k over host_mask's rows; no
                leaked slot; no mixed state, stale ages within 0.2 s, no
                IVF rebuild, written docs returned from their new
                embedding; the kernels' launch counters advance and no
                plain version runs on CUDA tensors; the first hot-only
                launches run under set_sync_debug_mode("error"). Prints
                capacity, throughput, goodput, p50 / p99 e2e, queue wait
                and plan time, shed and deadline-met rates, rungs, stale
                serves, launches, the idle share of 10 profiled steps, the
                burst comparison, peak memory.

 12. attn_kernel (runs after paged_kernel) -- the flash-attention kernel
                (causal and full) and the flash-decode kernel against their
                plain versions on the card over bf16 and f32, G 1 / 2 / 4 /
                8, hd 16 / 32 / 64 / 128 (16 and 32
                take 32- and 64-byte swizzled rows in the bf16 flash kernel)
                and S 1 / 17 / 512 / 2064 / 4096, then in both dtypes at
                the edges of the tiles: G 3 (a flash tile of 126 rows in
                use) at every S of the edge grid, G 1 / 2 / 4 / 8 at S 127
                / 129 / 2047, every hd; decode batches lengths 0 (the mean of V, as the
                reference), 1, random and S + 3. Then every multiple of 8
                from 8 to 256 and hd 6 / 100 (the padded copy) at G 2,
                S 129; public models' (hd, G) -- (80, 1), (96, 1), (256,
                1), (256, 8), (64, 71), (128, 48) -- at S 17 and 2064, with
                each shape's rows in use a tile; a decode whose heads split
                into blocks (hd 256, G 200). Past 256 (column pieces,
                `_attention.row_pieces`): every multiple of 8 from 264 to
                512, 576, 640, 768, 1000, 1024 and 2048 at G 2, S 129, and
                hd 264 / 320 / 384 / 512 / 1000 / 1024 at G 71 and G 8,
                S 2064, each with the decode kernel's blocks an SM. The C
                launchers' head-dim rule (width and piece) is held to
                `_attention.launch_width` / `row_pieces` at every hd in
                [0, 2100], and ptxas's registers and spills of every
                attention instantiation printed. Flash within
                rtol 1e-2, atol 8e-3 of its plain version (the chunked
                online softmax; P and V rounded to bf16 for P.V) and of the
                f32 oracle; decode's output, m and l within rtol = atol =
                2e-5 (all f32 math on both sides).
 13. tiered_prod (runs after the prod arena is freed) -- the three-tier
                deployment at production width: rag_unified.PRODUCTION cut
                to 2^23 x 768 rows with 16 lanes, drawn on the card and
                placed by the router (hot window = a quarter of the 180-day
                span: ~2.10 M rows in a 2^22-row hot arena, ~6.29 M in a
                6,400,000-row warm split-stack tier whose lanes share the
                hot arena's LexicalStats); the ingest's host time split (hot
                commit, warm commits, warm lanes, warm bookkeeping). Batches
                of 32 requests in 4 tenant groups through RagDB.execute: hot
                (a recency bound inside the window: route "hot", no warm
                probe, one dense scan), tail (no recency bound: "hot+warm",
                one dense scan + 4 warm pushdown probes), tail wsum and rrf
                (FUSED / BOTH-in-lists-mode + 4 warm hybrid probes); gates:
                routes, warm_queries / device_calls / terms_scanned per
                batch, both tiers in every tail batch, one arena_scan or
                hybrid_score launch a batch; every batch kind held to a
                plain global top-k over the union of both tiers' rows that
                pass each request's predicate (BM25 from idf / avgdl
                recounted over both tiers' lanes; rrf per signal, then
                fused), 0 rows failing their predicate; a warm delete
                invalidates cached hot+warm results, leaves hot ones cached
                and never comes back; a warm doc updated at now moves hot
                and tops the next hot batch from tier 0. Batch medians and
                idle shares, the hot kernels' CUDA-event times, the warm
                probe's wall and device time beside its bound, the host
                merge, peak memory.
 13b. sharded_prod (after tiered_prod, its arenas freed) -- the sharded
                engine at production width: a RagDB over
                rag_unified.PRODUCTION cut to 2^23 x 768 rows (16 lanes,
                8,323,072 docs: room in each region for tenant placement's
                uneven fill) with mesh=make_mesh((4,), ("data",),
                devices=[card] * 4), four logical shards of 2^21 rows, built
                with placement "hash" and then (the first dropped)
                "tenant". Batches of 32 requests in 4 tenant groups, k = 10,
                planned "sharded" by shard_min_rows: the kernel's launches
                a batch (one a scanned shard), ExecStats' shard rows and
                collective bytes, the explain() lines; (a) the lists equal
                the unsharded fused kernel's on the same rows bit for bit,
                0 ties straddling the k-th place, 0 leaked slots; one
                shard's kernel against its plain version; (g) RagDB.launch
                of a sharded batch under set_sync_debug_mode("error"); (e)
                filtered_topk_sharded equal to filtered_topk_cuda on the
                whole arena; (c) poisoned foreign-tenant rows (another
                shard's tenant and the same shard's) out-scoring the corpus
                never returned, a tenant-scoped plan one launch over one
                shard; (b) 64 rows sharing one embedding, lists
                bit-identical under a shuffled row order, the tie widening
                fired; a batch of 5 rows a group (3 zero rows padding each)
                widens no shard and equals the full batch's rows; a long
                tie run (4,096 of 2^16 rows share one embedding, all in
                region 0, then shuffled): the same lists, the widened
                kernel (k 5,632 on region 0) against its plain version
                and timed; (f) decode_attention_sharded at lm_serve's shape (B
                8, cache 2064, 4 shards of 516, one sequence live in the
                first shard only) within 2e-5 of the unsharded kernel, 4
                launches. Batch medians (hash, tenant, the unsharded fused
                batch), one shard's kernel time (events, device) beside
                its bound, the tie widenings, collective bytes, the
                sharded decode's time beside the kernel's, the decode
                wrapper's host cost a call, peak memory.
 13c. regions (after sharded_prod) -- arena regions on their own cards, on
                every card present (torch.cuda.device_count()). With n >= 2
                a RagDB over make_mesh((4,), ("data",), devices=[cuda:(s *
                n // 4)]) (one allocation a card, the controller cuda:0)
                holds 2^23 x 768 rows a card (rag_unified.PRODUCTION cut),
                built "hash" then (the first dropped) "tenant"; sharded_prod's
                plans (32 requests in 4 tenant groups, k = 10): each card's
                allocation on that card, the launches a batch (one a
                scanned region), ExecStats' shard rows, every list equal bit
                for bit to its regions' kernels run alone on their cards
                and merged on the host, the exact engine (one fused launch
                a card, merged by position) equal to them, 0 leaked slots,
                RagDB.launch under set_sync_debug_mode("error"); a write
                batch's commit ms, under "tenant" a one-tenant batch that
                leaves the other cards' allocations untouched. The db
                carries 16 lanes a row: (a) hybrid_prod's traffic (32
                match() requests in 4 tenant groups, wsum and rrf, then one
                paged wsum batch at 2^15-row pages): one FUSED or BOTH
                launch a card a batch, every list bit for bit equal to the
                kernel alone on each card merged on the host, within 1e-5
                of a plain top-k whose BM25 is recounted from every card's
                lanes, no leak, RagDB.launch under set_sync_debug_mode
                ("error"); (b) under "hash", build_index() over the
                allocations (k-means on each card, one mirror a card) and
                ivf_prod's plans: one compaction and one PROBE a card a
                batch, the lists equal to the per-card kernels merged on
                the host and within 1e-5 of a plain top-k over the probed
                clusters' rows, recall@1 and @10 against the exact engine
                printed, rows_scanned the padded candidate count, a write
                batch patching every mirror, and the cross-card k-means
                held step by step to plain Lloyd steps on one card over
                the first 2^18 rows of every card (the same seeds bit for
                bit, the same centroids handed to every card, each step
                within 3e-4 relative). (d) filtered_topk_sharded and
                decode_attention_sharded at sharded_prod's (e) / (f) shapes
                with each shard's piece on its card, bit for bit equal to
                the same shards on cuda:0; (c) tiered_prod's deployment and
                gates with its 2^22-row hot arena in the 4 regions
                (`regions_tiered`), the planner's default engines: the
                dense plans sharded (a hot unit a group, one launch a
                scanned region, ExecStats' rows a region), the match()
                plans hybrid (one launch a card); every ctypes entry
                point launched with its tensors on each other card equal
                bit for bit to the same launch on cuda:0. Batch medians,
                the IVF build's seconds, each card's peak GB. With n = 1
                it says the run needs two cards and computes nothing
                (`--phases regions` runs the phase alone).
 14. lm_serve (after the prod arena is freed) -- the LM serving
                path at qwen3-4b FULL width (36 layers, bf16, weights from a
                seeded generator on the card) behind the bench RagDB: 8
                requests in 4 tenants, k = 4 docs of 504 seeded tokens and a
                32-token question (prompt 2048, so "auto" prefill takes the
                flash kernel), 16 greedy tokens, cache of 2064. A warm-up
                serve, then 3 serves: retrieval, prefill and decode times,
                tokens/s, 36 flash launches a prefill and 576 decode launches
                a serve, 0 plain-version calls on CUDA tensors, equal greedy
                tokens, no slot of another tenant; one more serve with
                retrieval through a Scheduler: none shed, the same slots
                and greedy tokens; each kernel against its
                plain version on layer 0's and layer 35's inputs of the real
                prefill and first decode step; chunked-vs-naive prefill
                logits; a profile of one prefill and one decode step
                (device time by kernel, idle share); kernel times (CUDA
                events and profiled device time, one kernel a call) beside
                the bound, the plain version and SDPA's events and device
                time (a yardstick the port never calls); the decode
                workspace's bytes and 1 allocation a call (its outputs);
                peak memory.

 15. moe_serve (after lm_serve) -- the same serving path at granite-moe-
                1b-a400m FULL (24 layers, d_model 1024, 16 heads over 8 KV,
                hd 64, G 2, 32 experts of d_ff 512, top-8, bf16, seeded
                random weights) with the same shape, serves, scheduled
                serve, captures and gates as lm_serve; besides: the router
                choices (token, layer, k) that differ between the kernel
                path's prefill and the naive one -- the chunked-vs-naive
                logits gate applies only when none does, else the error is
                reported beside the count -- and one MoE layer's CUDA-event
                time at the prefill's groups and at a decode step's. Then
                `launch.serve.main([--arch granite-moe-1b-a400m
                --no-reduced --engine cuda --requests 8])` must serve 8.
 15b. reduced_serve (after moe_serve) -- every REDUCED config of the
                registry on the card (hd 16: qwen1.5-0.5b, yi-6b, granite,
                grok with G 3; hd 32: qwen3-4b; all f32): (a)
                `launch.serve.main([--arch A --engine cuda])` at its
                defaults (--reduced, 16 requests in batches of 4, 8
                tokens): 16 served, the decode kernel n_layers x 8 a batch,
                one scan launch a batch or more; (b) each config's prefill
                of 8 x 2048 tokens through the flash kernel (n_layers
                launches) and 8 greedy decode steps through the decode
                kernel, held to the same calls with the plain attention
                versions on the card: prefill logits within rtol 1e-2,
                atol 8e-3, each step's logits (the kernel path's tokens
                fed to both, from the kernel path's prefilled cache) within
                2e-5, the plain path routed to the kernel path's experts
                (so both gates hold for the MoE configs too); routing
                choices the plain path would have made otherwise and
                greedy-token flips reported; (c) both kernels at hd 16
                and 32, f32 and bf16, against their plain versions and
                timed beside them, SDPA and the bound (an f32 flash's P.V
                at the bf16 rate: it multiplies bf16 P and V): flash at 8
                x 2048, KV 2, G 2; decode at gen-25m's shape (B 8, KV 4, G
                2, a 62-row cache, 60 live); then both kernels at each
                REDUCED config's own KV, G and hd (grok: G 3) at its
                prefill and decode shapes against their plain versions;
                (d) the three examples:
                torch_quickstart (unified top-5, 0 leaked, window 0 ms),
                torch_rag_serve (gen-25m, hd 32, G 2: 8 requests x 12
                tokens, 48 decode launches) and torch_train_lm (200 steps,
                loss finite and falling, then a resume at 200). No plain
                version gets a CUDA tensor in a counted run.
 15c. wide_serve (after reduced_serve) -- `lm_serve`'s path at three public
                attention widths, 4 layers each, bf16, random weights:
                Phi-3-mini (d 3072, 32 heads, 32 KV, hd 96, d_ff 8192,
                vocab 32064), Gemma-2B (d 2048, 8 heads, 1 KV, hd 256,
                d_ff 16384, vocab 256000) and Falcon-7B (d 4544, 71 heads,
                1 KV, hd 64, d_ff 18176, vocab 65024): RAGEngine over the
                bench RagDB, a 2048-token prompt, prefill through the
                flash kernel, 16 decode steps through the decode kernel,
                with lm_serve's gates, times and bounds; then each config
                in f32 (the same widths) through `reduced_model_check`:
                prefill and decode logits within the flash and decode
                tolerances of the plain attention path's.
 15d. deep_serve (after wide_serve) -- the same path at hd 512, past both
                kernels' built widths: Gemma-2B's widths (d 2048, 1 KV,
                d_ff 16384, vocab 256000) with its 8 query heads x 256
                regrouped as 4 x 512 (G 4; a shape, not a public model),
                4 layers, bf16: the flash kernel 4 launches a prefill (four
                column pieces of 128 a row) and the decode kernel 4 a step,
                their times beside SDPA's (and the backend SDPA takes past
                256) and the bounds, the recomputed share of Q . K^T; then
                f32 through `reduced_model_check`; then
                `decode_attention_sharded` at hd 512 over 4 sequence shards
                of the card against the unsharded kernel and the plain
                version.
 16. train -- no kernel: the training path is plain PyTorch. (a)
                granite at full width cut to 2 layers, f32, TF32 off: one
                AdamW step on the card and on the CPU from the same numpy
                weights, loss within rtol 1e-5, grad norm within 1e-4,
                router choices equal; (b) granite FULL through `Trainer`,
                40 steps of 8 x 1024 synthetic tokens, AdamW at the
                launcher's peak 3e-4 on a cosine schedule of warmup 5 over
                the 40 steps, one async checkpoint at the end (a FULL
                train state is 13.4 GB: the script keeps its disk writes
                to one): every loss finite, the last logged below the
                first; step time, tokens/s, 6 N_active tokens as a share
                of the bf16 peak, the one-hot contractions' share, peak
                memory; (c) the straight run goes on 2 steps, and
                resume_or_init's state (step 40) replays them bit for bit
                ((b) and (c) under use_deterministic_algorithms); (d)
                `launch.train.main` at FULL width for 4 steps without
                --ckpt, then twice with --reduced --ckpt: the second
                resumes at step 4 and trains none. The flash and decode
                launch counts stay 0.
 17. train_mesh (after train) -- no kernel. Training on a logical
                (data 2, model 4) mesh of the card: (a) the vocab-parallel
                loss against the plain one, granite at full width cut to 2
                layers in f32 (loss within rel 1e-5, grads within rtol 1e-4
                / atol 1e-5) and granite FULL in bf16 (loss within rel
                1e-3, every leaf's worst gap within 5e-2 of its largest
                magnitude); (b) `launch.train.main --mesh 2x4 --vp-loss`
                against the plain run, 8 steps of 8 x 1024 each (losses
                within rel 5e-3, step ms, peak memory); (c) the mesh-local
                MoE dispatch at 32 groups of 512 equal to the chunks'
                scatter (y, aux = their mean), one layer's ms; (d)
                ef_compress over the 1.33 B FULL gradients, 50 rounds within
                1% of 50 g, one pass's ms beside its byte bound; psum_int8
                / psum_bf16 over the 2 dp shards' gradients within 4e-2 /
                2e-2 of the exact sum; (e) a REDUCED state resharded onto
                the mesh (bit for bit, pieces of shard_shape, a step after
                it bit for bit); (f) per-device bytes of grok-1-314b FULL on
                (16, 16) and (2, 16, 16), reckoned on the meta device.
 18. recsys -- no kernel. dlrm-rm2, fm, mind and bert4rec at FULL width
                on synthetic inputs: AdamW steps at train_batch 65,536
                (halved while it does not fit; each cut printed: MIND
                32,768, BERT4Rec 2,048) under
                deterministic algorithms and in the default mode, ms a step
                and examples/s; serve_p99 (512) and serve_bulk (262,144)
                ms a batch; retrieval_cand (1 x 1,000,000) ms; a REDUCED
                step on the card within 1e-5 / 1e-4 of the CPU's.
 19. gnn -- no kernel. gcn-cora FULL on synthetic graphs of
                full_graph_sm, ogb_products (2.45 M nodes, 61.9 M edges),
                molecule and minibatch_lg (NeighborSampler (15, 10) over a
                Reddit-sized 232,965-node, 114.6 M-edge graph: the host
                sampler's seconds beside the step): ms a train step in both
                modes; a REDUCED step of each form on the card within 1e-5
                / 1e-4 of the CPU's.
 20. launch (last) -- the launch tools (`repro_torch.launch.{steps,
                dryrun, roofline, hillclimb}`). (a) `python -m
                repro_torch.launch.dryrun --mesh both` over all 42 cells on
                the two production meshes of meta devices, run as a child
                process from the start of the script (CPU only, beside the
                card's phases): 84 of 84 entries ok, its failures (none),
                host seconds, the three cells with the most args + temp a
                device. (b) `roofline.analyze` of each entry in the
                reference's one-line format, the cells each term dominates
                and the fits_hbm counts. (c) every cell reckoned at one
                device (a second child: `launch._cost` on meta at the
                (1, 1) mesh) whose args + temp fit `HBM_PER_CHIP` runs on
                the card at full width, its arguments drawn from the seed:
                warm-up, timed steps (CUDA events; train cells step their
                state), one step counted under `launch._cost` (FLOPs equal
                to the meta count, bytes within 1%, differing ops printed),
                peak memory beside the reckoning, the three roofline terms
                at one chip and the roofline fraction (ideal over measured,
                <= 1.05); each excluded cell with its reckoned GB; on the
                long_500k cells the decode kernel launches n_layers times a
                step and one layer's kernel output matches its plain
                version at S = 524,288 within 2e-5 (the split plan
                printed). (d) `hillclimb.main` on qwen1.5-0.5b|long_500k
                into a temporary file, the entry's keys checked.

Prints the card's name and power limit, one JSON line per phase, a
``{"kernels": [...]}`` line (each row with ``paths``: the phases whose
counted runs launched it, with their launches), and last ``{"ok": true,
"device": {...}}``.
Exits non-zero without a result when no card is present or the package is
missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

TOL = 1e-5                    # rtol = atol on unit-norm data
HBM_BPS = 3.35e12             # H100 SXM device memory rate
FP32_FLOPS = 67e12            # H100 SXM fp32 peak outside the tensor cores
SEED = 0
DEV = None                    # the card, set in setup()
CARD = None                   # nvidia-smi's "name, power limit", set in main()
# phase 1 grid: odd and pow2-adjacent N, serving widths D, B up to a full
# serving batch (and past one kernel block), G with a BLOCK_ALL lane at 7
GRID_N = (1, 513, 1000, 65_553)
GRID_D = (64, 96, 128, 768)
GRID_B = (1, 3, 8, 32, 64)
GRID_G = (1, 2, 7, 16)
# the micro-tile's edges, drawn after the grid above: B across the query
# groups and block sizes, D below a float4, odd and past a chunk, N one
# short of and one past a tile
EDGE_B = (5, 17, 33, 63)
EDGE_D = (1, 3, 4, 100)
EDGE_N = (255, 257)
EDGE_K = (1, 10, 33)
EDGE_PAGE = 128               # each edge also paged, bit-identical
# phase 3 grid (lanes T and query terms QT cycle with the other axes)
HYB_N = (1, 513, 1000, 65_553)
HYB_D = (64, 768)
HYB_T = (4, 16)
HYB_B = (1, 8, 32, 64)
HYB_QT = (1, 4, 16)
HYB_K = (1, 10, 32, 33, 300)
W_DENSE, W_LEX = 0.8, 1.7     # the wsum mix of phase 3
LEX_V = 64                    # vocabulary of phase 3's lanes
EDGE_LEX_PAGE = 100           # lexical edges paged: a page ends mid-tile
RRF_C = 60.0
# phase ivf_kernel grid: candidate counts P odd and next to a power of two,
# D with a scalar-load width (50), k past the warp selection and past P
IVF_P = (1, 255, 1025, 4097, 65_537)
IVF_D = (48, 50, 128, 768)
IVF_B = (1, 8, 11, 32, 64)
IVF_K = (1, 10, 32, 33, 100)
# phase paged_kernel grid: page sizes below, at and past the 256-row
# sub-tile, one not a multiple of it, and None for P >= N; ragged N; D = 130
# takes the 4-byte copies
PAGED_MODES = ("dense", "wsum", "rrf", "probe")
PAGED_P = (128, 256, 1000, 4096, None)
PAGED_B = (1, 8, 33, 64)
PAGED_D = (64, 96, 130)
PAGED_N = (1000, 4099, 9001)
# phase paged_prod: page sizes timed at the prod shape (2^15 the planner's)
PAGED_PROD_P = (1 << 13, 1 << 14, 1 << 15, 1 << 16)
# phase attn_kernel grid: G of the three dense configs' groupings, the
# served head dims, S from one token through ragged (17, 2064 = the serve
# cache) to past the prefill shape, both dtypes; then, for both kernels'
# tiles in both dtypes, their edges: G 3 (128 % 3 != 0: 126 of a flash tile's 128 rows in
# use) and S 127 / 129 / 2047 (64- and 128-key tiles)
#: the decode kernel's two bodies by name: SIMT, tensor-core
DECODE_KERNELS = ("decode_attention_kernel", "decode_tc_kernel")
ATTN_G = (1, 2, 4, 8)
ATTN_HD = (16, 32, 64, 128)   # the head dims lm_serve / moe_serve / REDUCED run
#: every multiple of 8 up to 256 and two that take the padded copy, at G 2
#: and S 129 (`attn_kernel`'s width sweep)
ATTN_SWEEP_HD = tuple(range(8, 257, 8)) + (6, 100)
ATTN_SWEEP = dict(G=2, S=129)
#: public models' (hd, G): Phi-2 (80, 1), Phi-3-mini (96, 1), GPT-J (256,
#: 1), Gemma-2B (256, 8), Falcon-7B (64, 71), StarCoder (128, 48)
ATTN_PUBLIC = ((80, 1), (96, 1), (256, 1), (256, 8), (64, 71), (128, 48))
ATTN_PUBLIC_S = (17, 2064)
#: (hd, G) whose decode blocks split their heads: hd 256, G 200 (f32: q and
#: scores of G heads at that width outgrow a block's shared memory; bf16:
#: the tensor-core body takes at most 128 heads a block)
ATTN_HEAD_BLOCKS = ((256, 200),)
#: the decode kernel's tensor-core body over G (it takes bf16 rows up to
#: 256 at every G): G 1 .. 8 at lm_serve's and moe_serve's widths, G 8 and
#: 71 at Gemma-2B's and Falcon-7B's, G 1 at Phi-3-mini's, S 2064
#: (`phase_attn_kernel`)
ATTN_TC_SWEEP = tuple((hd, G) for hd in (64, 128) for G in range(1, 9)) + (
    (256, 8), (64, 71), (96, 1))
#: past 256 (column pieces): every multiple of 8 to 512 and wider rows, at
#: G 2, S 129; hd 2048 once; then some of them at G 71 and G 8, S 2064
#: (`attn_kernel`'s deep sweep; the S 2064 subset bounds its time)
ATTN_DEEP_HD = tuple(range(264, 513, 8)) + (576, 640, 768, 1000, 1024, 2048)
ATTN_DEEP_WIDE_HD = (264, 320, 384, 512, 1000, 1024)
ATTN_DEEP_WIDE_G = (71, 8)
ATTN_DEEP_WIDE_S = 2064
ATTN_S = (1, 17, 512, 2064, 4096)
ATTN_EDGE_G = (1, 2, 3, 4, 8)
ATTN_EDGE_S = (1, 17, 127, 129, 512, 2047, 2064, 4096)
# tolerances: flash rounds P and V to bf16 for P.V (test_kernels.py:96-97);
# decode is all f32 math (test_kernels.py:60)
FLASH_RTOL, FLASH_ATOL = 1e-2, 8e-3
DEC_TOL = 2e-5
# the device quantizer's union may differ from the host probe's only in a
# row whose nprobe-th and (nprobe+1)-th sims lie this close (f32 products
# in two reduction orders)
TIE_MARGIN = 1e-5
# kernel-name tags a profiled scan call must show (`profile_batch`)
SCAN_TAGS = ("tile_scan_kernel",)
PAGED_TAGS = ("paged_scan_kernel",)
# serve_prod: the scheduler's batch bound (every run of the phase)
SERVE_MAX_BATCH = 32
# lm_serve: prefill logits through the flash kernel against the naive path
# may differ by bf16 rounding carried through 36 layers, not by more than
# this share of the largest logit
LOGIT_REL = 0.05
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def sync():
    torch.cuda.synchronize()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def ptxas_kernels(log):
    """ptxas's report (``-Xptxas -v``) by kernel entry: {mangled name:
    {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}."""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props in out:
            out[props].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
            entry = None
    return out


SCAN_MODES = ("dense", "fused", "both", "probe")   # the header's MODE ids


def scan_ptxas(log):
    """Every instantiation of tile_scan_kernel and paged_scan_kernel (BB =
    8, 16, 32, 64; the four modes) as ptxas reported it; fails when one at
    BB <= 32 spills."""
    rows = []
    for name, rep in ptxas_kernels(log).items():
        m = re.search(r"(tile_scan_kernel|paged_scan_kernel)ILi(\d+)ELi(\d)E",
                      name)
        if m:
            rows.append({"kernel": m.group(1), "BB": int(m.group(2)),
                         "mode": SCAN_MODES[int(m.group(3))], **rep})
    rows.sort(key=lambda r: (SCAN_MODES.index(r["mode"]), r["kernel"],
                             r["BB"]))
    check(len(rows) == 32, f"ptxas reported {len(rows)} scan kernels, "
          "expected 32")
    for r in rows:
        check(r["BB"] > 32
              or (r.get("spill_stores") == 0 and r.get("spill_loads") == 0),
              f"ptxas: {r['kernel']}<{r['BB']}, {r['mode']}> spills: {r}")
    return rows


def check_geometry():
    """The host mirror of the scan's launch geometry
    (`kernel.scan_geometry`) against the C launcher's (`kernel.scan_info`)
    over block rows, modes, lanes, predicate groups and both regimes.
    Returns the number of shapes compared."""
    from repro_torch.kernels.arena_scan.stages import ScanSpec
    specs = (ScanSpec(), ScanSpec(score="fused"), ScanSpec(score="both"),
             ScanSpec(slot_lane=True))
    n = 0
    for spec in specs:
        for B in (8, 16, 32, 64):
            for QT in ((1, 4, 16) if spec.has_lex else (0,)):
                for G in ((1,) if spec.slot_lane else (1, 16)):
                    for P in (None, 1 << 15):
                        geo = kernel_mod.scan_geometry(spec, B, G, 10, P,
                                                       QT=QT)
                        info = kernel_mod.scan_info(spec, B, 1 << 20, G, 10,
                                                    P, QT=QT)
                        check(all(info[key] == v for key, v in geo.items()),
                              f"geometry mirror {geo} != launcher {info}")
                        n += 1
    return n


def host_mask(meta, preds):
    """(G, N) bool -- the WHERE clause in numpy, on the host, independent
    of the port: live, tenant, recency, category bitmask, ACL bitmask."""
    tenant, ts, cat, acl = (meta[:, j].astype(np.int64) for j in range(4))
    out = []
    for pt, pts, pc, pa in preds.astype(np.int64):
        ok = tenant >= 0
        if pt != -2:
            ok &= tenant == pt
        ok &= ts >= pts
        catbit = np.where((cat >= 0) & (cat < 32),
                          np.left_shift(1, np.clip(cat, 0, 31)), 0)
        ok &= (catbit & (pc & 0xFFFFFFFF)) != 0
        ok &= ((acl & 0xFFFFFFFF) & (pa & 0xFFFFFFFF)) != 0
        out.append(ok)
    return np.stack(out)


def compare(name, s_k, i_k, s_p, i_p, mask_rows, scores_full=None,
            dup_pairs=(), lower_slot_ties=True, cand_pos=None):
    """Hold a kernel result (s_k, i_k) to the plain one (s_p, i_p): both
    (B, k) numpy. ``mask_rows`` (B, N) bool is each row's host mask;
    ``scores_full`` (B, N) the plain scores (to check every returned
    slot's score). ``lower_slot_ties`` checks that exact ties go to the
    lower slot (rrf-fused lists break ties by list position instead).
    ``cand_pos`` (slot -> its positions in an IVF candidate vector) sets
    the probe's rules: a slot listed m times may come out up to m times,
    fills and k-th place ties compare as multisets, and exact ties go to
    the lower candidate position (checked among slots listed once).
    Returns the max abs score error."""
    neg = np.float32(np.finfo(np.float32).min)
    check(s_k.shape == s_p.shape and i_k.shape == i_p.shape,
          f"{name}: shape {s_k.shape} vs {s_p.shape}")
    check(np.isfinite(s_k).all(), f"{name}: non-finite kernel scores")
    check(np.allclose(s_k, s_p, rtol=TOL, atol=TOL),
          f"{name}: scores differ beyond {TOL}")
    check(((s_k == neg) == (i_k == -1)).all(), f"{name}: slot -1 iff NEG_INF")
    err = float(np.max(np.abs(s_k - s_p))) if s_k.size else 0.0
    for b in range(s_k.shape[0]):
        real = i_k[b][i_k[b] >= 0]
        if cand_pos is None:
            check(len(set(real.tolist())) == len(real),
                  f"{name}: dup slot row {b}")
        else:
            got_n = Counter(real.tolist())
            check(all(n <= len(cand_pos.get(x, ())) for x, n in got_n.items()),
                  f"{name}: row {b} returned a slot more often than listed")
        check(mask_rows[b][real].all(), f"{name}: row {b} leaked "
              f"{real[~mask_rows[b][real]]}")
        ref_real = i_p[b][i_p[b] >= 0]
        check(len(real) == len(ref_real), f"{name}: fill differs row {b}")
        if len(real) == 0:
            continue
        kth = s_p[b][len(ref_real) - 1]
        got_c, ref_c = Counter(real.tolist()), Counter(ref_real.tolist())
        for slot in (got_c - ref_c) + (ref_c - got_c):
            sc = scores_full[b][slot] if scores_full is not None else kth
            check(abs(sc - kth) <= TOL * (1 + abs(kth)),
                  f"{name}: row {b} slot {slot} differs away from a k-th "
                  f"place tie")
        if scores_full is not None:
            check(np.allclose(s_k[b][:len(real)], scores_full[b][real],
                              rtol=TOL, atol=TOL),
                  f"{name}: row {b} slot/score pairing off")
        # ties go to the lower slot (the probe: to the lower candidate
        # position): among exactly equal scores the keys rise
        sk = s_k[b][:len(real)]
        eq = sk[1:] == sk[:-1]
        if cand_pos is None:
            check(not lower_slot_ties or (real[1:][eq] > real[:-1][eq]).all(),
                  f"{name}: row {b} tie not broken toward the lower slot")
        else:
            once = lambda x: len(cand_pos[x]) == 1
            for lo_s, hi_s in zip(real[:-1][eq].tolist(),
                                  real[1:][eq].tolist()):
                check(not (once(lo_s) and once(hi_s))
                      or cand_pos[lo_s][0] < cand_pos[hi_s][0],
                      f"{name}: row {b} tie not broken toward the lower "
                      f"candidate position")
        got = set(real.tolist())
        for lo, hi in dup_pairs:
            check(hi not in got or lo in got,
                  f"{name}: row {b} returned duplicate {hi} without {lo}")
    return err


def make_arena(rng, N, D, *, dead=False, dups=0):
    """Unit-norm emb (N, D), meta (N, 4) int32 with category 31 and high
    ACL bits, and ``dups`` pairs of identical rows (lo, hi)."""
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    meta = np.stack([
        rng.integers(-1, 5, N), rng.integers(0, 1000, N),
        rng.integers(0, 32, N),
        rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64),
    ], axis=1).astype(np.int64)
    meta[:, 2][rng.random(N) < 0.2] = 31          # category 31 -> sign bit
    if dead:
        meta[:, 0] = -1
    pairs = []
    for j in range(min(dups, N // 2)):
        lo, hi = j, N - 1 - j
        emb[hi] = emb[lo]
        meta[hi] = meta[lo]
        pairs.append((lo, hi))
    return emb, meta.astype(np.int32), pairs


def make_batch(rng, emb, B, G, pairs=(), *, block_all=False):
    """Unit-norm queries (B, D) (the first aimed at duplicate rows), G
    predicates (group 0 pass-all, the last BLOCK_ALL when asked) with
    random tenant / min_ts / category and ACL masks, and group ids."""
    q = rng.standard_normal((B, emb.shape[1])).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    for j, (lo, _) in enumerate(pairs[:B]):
        q[j] = emb[lo]
    preds = np.stack([
        rng.choice([-2, 0, 1, 2, 3, 4], G), rng.integers(0, 500, G),
        rng.integers(-(1 << 31), 1 << 31, G, dtype=np.int64),
        rng.integers(-(1 << 31), 1 << 31, G, dtype=np.int64),
    ], axis=1)
    preds[0] = [-2, 0, -1, -1]                    # pass-all (masks all ones)
    if block_all and G > 1:
        preds[-1] = [-3, 0, -1, -1]               # BLOCK_ALL
    gids = rng.integers(0, G, B).astype(np.int32)
    return q, preds.astype(np.int32), gids


def run_case(name, arena, batch, k, errs, page_rows=None):
    """The resident kernel against its plain version (`compare`); with
    ``page_rows`` also the paged kernel, whose lists must equal the
    resident ones bit for bit."""
    (emb_d, meta_d, meta, pairs), (q, preds, gids) = arena, batch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    args = (t(q), emb_d, meta_d, t(gids), t(preds))
    s_k, i_k = kernel_mod.arena_scan_cuda(*args, k)
    s_p, i_p = kernel_mod.arena_scan_plain(*args, k)
    if page_rows is not None:
        pg = kernel_mod.arena_scan_cuda(*args, k, page_rows=page_rows)
        sync()
        check(bits_equal(pg, (s_k, i_k)),
              f"{name}: paged lists != resident lists")
    sync()
    full = (args[0] @ emb_d.T).cpu().numpy()
    mask = host_mask(meta, preds)[gids]
    errs.append(compare(name, s_k.cpu().numpy(), i_k.cpu().numpy(),
                        s_p.cpu().numpy(), i_p.cpu().numpy(), mask, full,
                        pairs))


def upload(emb, meta, pairs):
    return (torch.from_numpy(emb).to(DEV), torch.from_numpy(meta).to(DEV),
            meta, pairs)


def phase_kernel():
    rng = np.random.default_rng(SEED)
    errs = []
    n_cases = 0
    t0 = time.perf_counter()
    for N in GRID_N:
        for D in GRID_D:
            arena = upload(*make_arena(rng, N, D))
            for B in GRID_B:
                for G in GRID_G:
                    batch = make_batch(rng, arena[0].cpu().numpy(), B, G,
                                       block_all=(G == 7))
                    for k in sorted({1, 10, 100, 1000, N + 7}):
                        run_case(f"N{N}-D{D}-B{B}-G{G}-k{k}", arena, batch,
                                 k, errs)
                        n_cases += 1
    extra = {
        "dups": (dict(N=700, D=64, dups=40), 8, 2, False),
        "all-dead": (dict(N=600, D=96, dead=True), 5, 3, False),
        "block-all": (dict(N=2000, D=128), 33, 16, True),
        "B100-two-blocks": (dict(N=3000, D=64), 100, 4, False),
    }
    for name, (akw, B, G, blk) in extra.items():
        emb, meta, pairs = make_arena(rng, **akw)
        arena = upload(emb, meta, pairs)
        batch = make_batch(rng, emb, B, G, pairs, block_all=blk)
        for k in (1, 10, 300, 3100):
            run_case(f"{name}-k{k}", arena, batch, k, errs)
            n_cases += 1
    n_edges = 0
    for B in EDGE_B:
        for D in EDGE_D:
            for N in EDGE_N:
                emb, meta, pairs = make_arena(rng, N, D, dups=3)
                arena = upload(emb, meta, pairs)
                batch = make_batch(rng, emb, B, 3, pairs, block_all=True)
                for k in EDGE_K:
                    run_case(f"edge-N{N}-D{D}-B{B}-k{k}", arena, batch, k,
                             errs, page_rows=EDGE_PAGE)
                    n_edges += 1
    # more predicate groups than one launch stages (kernel.MAX_GROUPS): the
    # wrapper's split, one launch a range of groups, lists scattered back
    emb, meta, pairs = make_arena(rng, 1000, 64)
    arena = upload(emb, meta, pairs)
    G = kernel_mod.MAX_GROUPS + 808
    batch = make_batch(rng, emb, 600, G, block_all=True)
    launches0 = kernel_mod.LAUNCHES
    for k in (10, 300):
        run_case(f"groups{G}-k{k}", arena, batch, k, errs)
        n_cases += 1
    check(kernel_mod.LAUNCHES - launches0 == 4,
          f"{G} groups took {kernel_mod.LAUNCHES - launches0} launches for "
          "2 calls, not 2 each")
    emit("kernel", cases=n_cases + n_edges, edge_cases=n_edges,
         max_abs_err=max(errs), seconds=time.perf_counter() - t0, tol=TOL,
         leaked_slots=0, edges_paged="bit-identical",
         groups_past_one_launch=G)
    return max(errs)


def tnp(*ts):
    return [x.cpu().numpy() for x in ts]


def make_lex(rng, meta, T, hot):
    """Lanes for an arena: terms (N, T) int32 with empty lanes (-1),
    lexnorm (N, T) f32, and a quarter of the rows turned into adversarial
    donors -- tenant 6, which only a pass-all tenant clause admits,
    carrying exactly the ``hot`` query terms at lexnorm 10."""
    N = meta.shape[0]
    terms = rng.integers(-1, LEX_V, (N, T)).astype(np.int32)
    lexnorm = np.where(terms >= 0, rng.random((N, T)) * 2,
                       0).astype(np.float32)
    donors = rng.random(N) < 0.25
    h = min(len(hot), T)
    terms[np.ix_(donors, np.arange(h))] = hot[:h]
    lexnorm[np.ix_(donors, np.arange(h))] = 10.0
    meta = meta.copy()
    meta[donors, 0] = 6
    return terms, lexnorm, meta


def make_qterms(rng, B, QT, hot):
    """(B, QT) query terms: the hot terms first, random ids, and -1
    padding in the last quarter of the columns."""
    qt = rng.integers(0, LEX_V, (B, QT)).astype(np.int32)
    h = min(len(hot), QT)
    qt[:, :h] = hot[:h]
    if QT >= 4:
        qt[:, QT - QT // 4:] = -1
    return qt


def hybrid_case(name, arena, lexd, batch, qterms, k, errs, page_rows=None):
    """The hybrid kernel against its plain version, wsum and rrf, on one
    input set; every list checked as in phase 1 against the full signals,
    the bm25 list exactly, the rrf fusion of both sides' lists. With
    ``page_rows`` the paged kernel's lists must equal the resident ones
    bit for bit."""
    from repro_torch.kernels.arena_scan.stages import bm25_scores
    from repro_torch.kernels.hybrid_score.ref import _fold, qidf_of, rrf_fuse
    (emb_d, meta_d, meta, _), (q, preds, gids) = arena, batch
    terms_d, lexnorm_d, idf_d = lexd
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    qt_d = t(qterms)
    qidf = qidf_of(idf_d, qt_d).contiguous()
    args = (t(q), emb_d, meta_d, terms_d, lexnorm_d, t(gids), t(preds), qt_d,
            qidf, k)
    mask = host_mask(meta, preds)[gids]
    for mode in ("wsum", "rrf"):
        kw = dict(mode=mode, w_dense=W_DENSE, w_lex=W_LEX)
        out_k = hyb_mod.hybrid_score_cuda(*args, **kw)
        out_p = hyb_mod.hybrid_score_plain(*args, **kw)
        if page_rows is not None:
            pg = hyb_mod.hybrid_score_cuda(*args, **kw, page_rows=page_rows)
            sync()
            check(bits_equal(pg, out_k),
                  f"{name}-{mode}: paged lists != resident lists")
        sync()
        qf, qidf_f = _fold(args[0], qidf, mode, W_DENSE, W_LEX)
        dense = qf @ emb_d.T
        bm = bm25_scores(terms_d, lexnorm_d, qt_d, qidf_f)
        if mode == "wsum":
            errs.append(compare(f"{name}-wsum", *tnp(*out_k), *tnp(*out_p),
                                mask, (dense + bm).cpu().numpy()))
            continue
        d_k, di_k, l_k, li_k = tnp(*out_k)
        d_p, di_p, l_p, li_p = tnp(*out_p)
        errs.append(compare(f"{name}-rrf-dense", d_k, di_k, d_p, di_p, mask,
                            dense.cpu().numpy()))
        check((l_k == l_p).all() and (li_k == li_p).all(),
              f"{name}: bm25 list differs from the plain version's")
        compare(f"{name}-rrf-bm25", l_k, li_k, l_p, li_p, mask,
                bm.cpu().numpy())
        f_s, f_i = tnp(*rrf_fuse(*out_k, k, RRF_C))
        p_s, p_i = tnp(*rrf_fuse(*out_p, k, RRF_C))
        if (di_k == di_p).all():
            check((f_s == p_s).all() and (f_i == p_i).all(),
                  f"{name}: rrf fusion differs on equal lists")
        for b in range(f_i.shape[0]):
            real = f_i[b][f_i[b] >= 0]
            check(mask[b][real].all(), f"{name}: rrf row {b} leaked")


def ops_case(name, arena, lexd, batch, qterms, k, errs):
    """The public `hybrid_score` on the card (rrf fused, rrf lists=True,
    wsum) against the plain oracle `hybrid_score_ref` / its lists."""
    from repro_torch.kernels.hybrid_score.ops import hybrid_score
    from repro_torch.kernels.hybrid_score.ref import (hybrid_score_ref,
                                                      qidf_of)
    (emb_d, meta_d, meta, _), (q, preds, gids) = arena, batch
    terms_d, lexnorm_d, idf_d = lexd
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    cols = [meta_d[:, j].contiguous() for j in range(4)]
    mask = host_mask(meta, preds)[gids]
    qidf = qidf_of(idf_d, t(qterms))
    for mode, lists in (("wsum", False), ("rrf", False), ("rrf", True)):
        kw = dict(mode=mode, w_dense=W_DENSE, w_lex=W_LEX, rrf_c=RRF_C)
        out = hybrid_score(t(q), emb_d, cols[0], cols[1], cols[2], cols[3],
                           terms_d, lexnorm_d, idf_d, t(gids), t(preds),
                           t(qterms), k, lists=lists, **kw)
        if lists:
            ref = hyb_mod.hybrid_score_plain(
                t(q), emb_d, meta_d, terms_d, lexnorm_d, t(gids), t(preds),
                t(qterms), qidf, k, mode=mode, w_dense=W_DENSE, w_lex=W_LEX)
        else:
            ref = hybrid_score_ref(t(q), emb_d, meta_d, terms_d, lexnorm_d,
                                   t(gids), t(preds), t(qterms), qidf, k,
                                   **kw)
        sync()
        for j in range(0, len(out), 2):
            errs.append(compare(f"{name}-ops-{mode}{'-lists' * lists}-{j}",
                                *tnp(out[j], out[j + 1]),
                                *tnp(ref[j], ref[j + 1]), mask,
                                lower_slot_ties=mode == "wsum" or lists))


def lex_edge_draws(rng):
    """The lexical stage's edges, each (name, arena, lexd, (q, preds, gids),
    qterms), B = 32 in 4 groups: tiles where every (row, query) pair is
    kept, where none is, and where one pair of each warp's 32 rows is; 32
    lanes against 16 query terms; 6 lanes (the one-lane-at-a-time path, T
    % 4 != 0); 128 lanes against 128 query terms (past the old cap of 64). Lanes carry the hot query terms in 30% of rows and no
    donors, so the masks stay as built."""
    out = []
    for name, N, D, T, QT, keep in (
            ("all-kept", 1000, 64, 16, 4, "all"),
            ("none-kept", 1000, 64, 16, 4, "none"),
            ("one-a-warp", 1000, 64, 16, 4, "one"),
            ("T32-QT16", 777, 96, 32, 16, None),
            ("T6-QT3", 600, 64, 6, 3, None),
            ("T128-QT128", 700, 64, 128, 128, None)):
        hot = rng.integers(0, LEX_V, 3).astype(np.int32)
        emb, meta, _ = make_arena(rng, N, D)
        terms = rng.integers(-1, LEX_V, (N, T)).astype(np.int32)
        h = min(3, T)
        terms[np.ix_(rng.random(N) < 0.3, np.arange(h))] = hot[:h]
        lexnorm = np.where(terms >= 0, rng.random((N, T)) * 2,
                           0).astype(np.float32)
        q, preds, gids = make_batch(rng, emb, 32, 4, block_all=True)
        if keep is not None:
            meta[:, 0], meta[:, 3] = 0, -1     # live, every ACL bit
            preds[:] = [-3 if keep == "none" else -2, 0, -1, -1]
            if keep == "one":
                r = np.arange(N)
                meta[:, 0] = np.where(r % 32 == (r // 32) % 32, 0, -1)
        lexd = tuple(torch.from_numpy(a).to(DEV) for a in (
            terms, lexnorm, (rng.random(LEX_V) * 5).astype(np.float32)))
        out.append((name, upload(emb, meta, ()), lexd, (q, preds, gids),
                    make_qterms(rng, 32, QT, hot)))
    return out


def phase_hybrid_kernel():
    rng = np.random.default_rng(SEED + 10)
    errs = []
    n_cases = 0
    t0 = time.perf_counter()
    for N in HYB_N:
        for D in HYB_D:
            for T in HYB_T:
                hot = rng.integers(0, LEX_V, 3).astype(np.int32)
                emb, meta, _ = make_arena(rng, N, D)
                terms, lexnorm, meta = make_lex(rng, meta, T, hot)
                arena = upload(emb, meta, ())
                lexd = (torch.from_numpy(terms).to(DEV),
                        torch.from_numpy(lexnorm).to(DEV),
                        torch.from_numpy((rng.random(LEX_V) * 5)
                                         .astype(np.float32)).to(DEV))
                ks = HYB_K + ((N + 7,) if N < 2048 else ())
                for bi, B in enumerate(HYB_B):
                    G = (1, 4)[(bi + N + T) % 2]
                    batch = make_batch(rng, emb, B, G, block_all=(G == 4))
                    for ki, k in enumerate(ks):
                        QT = HYB_QT[(bi + ki) % 3]
                        qterms = make_qterms(rng, B, QT, hot)
                        hybrid_case(f"N{N}-D{D}-T{T}-B{B}-G{G}-QT{QT}-k{k}",
                                    arena, lexd, batch, qterms, k, errs)
                        n_cases += 1
                qterms = make_qterms(rng, 8, 4, hot)
                batch = make_batch(rng, emb, 8, 4, block_all=True)
                for k in ks[1:2] + ks[5:]:      # 10, and N + 7 for small N
                    ops_case(f"N{N}-D{D}-T{T}-k{k}", arena, lexd, batch,
                             qterms, k, errs)
                    n_cases += 1
    edges = lex_edge_draws(rng)
    for name, arena, lexd, batch, qterms in edges:
        for k in (10, 33):
            hybrid_case(f"edge-{name}-k{k}", arena, lexd, batch, qterms, k,
                        errs, page_rows=EDGE_LEX_PAGE)
            n_cases += 1
    emit("hybrid_kernel", cases=n_cases, modes=["wsum", "rrf", "rrf-lists"],
         lexical_edges=[e[0] for e in edges], edges_paged_rows=EDGE_LEX_PAGE,
         max_abs_err=max(errs), seconds=time.perf_counter() - t0, tol=TOL,
         bm25_list="exact", leaked_slots=0, edges_paged="bit-identical")
    return max(errs)


def make_cand(rng, P, N):
    """(P,) int32 candidate slots over an N-row arena, as a poisoned member
    table gives them: arena slots drawn with repeats, ~4% member padding
    (-1), ~2% past the arena (N..N+99) and ~2% negative (-5..-2)."""
    cand = rng.integers(0, N, P)
    u = rng.random(P)
    cand[u < 0.04] = -1
    far = (u >= 0.04) & (u < 0.06)
    cand[far] = rng.integers(N, N + 100, int(far.sum()))
    neg = (u >= 0.06) & (u < 0.08)
    cand[neg] = rng.integers(-5, -1, int(neg.sum()))
    return cand.astype(np.int32)


def cand_positions(cand, N):
    """slot -> its positions in the candidate vector (live slots only)."""
    pos = {}
    for p, x in enumerate(cand.tolist()):
        if 0 <= x < N:
            pos.setdefault(x, []).append(p)
    return pos


def compact_vector(cand, n):
    """A candidate vector compacted on the card (the compaction kernel,
    the vector given as one cluster of a member table) and by its plain
    version, which must agree exactly: (cand (P,), n_live (1,)) on the
    card."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    args = (t(cand)[None], t(np.zeros(0, np.int32)),
            t(np.zeros(1, np.int32)), n)
    c_k, n_k = ivf_mod.compact_candidates_cuda(*args)
    c_p, n_p = ivf_mod.compact_candidates_plain(*args)
    sync()
    check(torch.equal(c_k, c_p) and torch.equal(n_k, n_p),
          "compaction kernel != its plain version")
    return c_k, n_k


def probe_case(name, arena, cand, pred, q, k, errs, pairs=()):
    """`ivf_probe_cuda` against `ivf_probe_plain` on one candidate vector
    over the arena, checked by `compare` under the probe's rules against
    the arena-wide scores and the host mask over ARENA metadata; then the
    same vector compacted on the card (`compact_vector`) through the
    resident and the paged kernel (pages of EDGE_PAGE candidates), whose
    lists must equal the uncompacted vector's bit for bit."""
    emb_d, meta_d, meta, _ = arena
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    N = meta.shape[0]
    args = (t(q), emb_d, meta_d, t(cand), t(pred), k)
    s_k, i_k = ivf_mod.ivf_probe_cuda(*args)
    c_d, n_live = compact_vector(cand, N)
    live = ivf_mod.ivf_probe_cuda(*args[:3], c_d, *args[4:], n_live=n_live)
    paged = ivf_mod.ivf_probe_cuda(*args[:3], c_d, *args[4:], n_live=n_live,
                                   page_rows=EDGE_PAGE)
    s_p, i_p = ivf_mod.ivf_probe_plain(*args)
    sync()
    check(bits_equal(live, (s_k, i_k)),
          f"{name}: compacted lists != the padded vector's")
    check(bits_equal(paged, live), f"{name}: paged lists != resident lists")
    full = (args[0] @ emb_d.T).cpu().numpy()
    mask = np.broadcast_to(host_mask(meta, pred[None])[0], (q.shape[0], N))
    errs.append(compare(name, *tnp(s_k, i_k, s_p, i_p), mask, full, pairs,
                        cand_pos=cand_positions(cand, N)))
    return int(n_live.item())


def probe_ops_case(name, arena, members, overflow, clusters, pred, q, k,
                   errs, pairs=()):
    """The public `ivf_probe` (kernel on the card) against its plain path
    (``use_kernel=False``) from a member table, an overflow tail and a
    padded cluster list: `_assemble`'s rules (cluster padding, dead slots)
    and the empty set run here."""
    from repro_torch.kernels.ivf_probe.ops import ivf_probe
    from repro_torch.kernels.ivf_probe.ref import candidate_slots
    emb_d, meta_d, meta, _ = arena
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    cols = [meta_d[:, j].contiguous() for j in range(4)]
    args = (t(q), emb_d, *cols, t(members), t(overflow), clusters, t(pred), k)
    s_k, i_k = ivf_probe(*args)
    s_p, i_p = ivf_probe(*args, use_kernel=False)
    sync()
    N = meta.shape[0]
    cand = candidate_slots(t(members), t(overflow), clusters).cpu().numpy()
    full = (args[0] @ emb_d.T).cpu().numpy()
    mask = np.broadcast_to(host_mask(meta, pred[None])[0], (q.shape[0], N))
    errs.append(compare(name, *tnp(s_k, i_k, s_p, i_p), mask, full, pairs,
                        cand_pos=cand_positions(cand, N)))
    return tnp(s_k, i_k)


def member_table(rng, N, C, cap):
    """(C, cap) int32 member table: each cluster filled to a random depth
    with arena slots, -1 after."""
    members = np.full((C, cap), -1, np.int32)
    for c in range(C):
        fill = int(rng.integers(0, cap + 1))
        members[c, :fill] = rng.integers(0, N, fill)
    return members


def phase_ivf_kernel():
    rng = np.random.default_rng(SEED + 20)
    errs = []
    n_cases = 0
    t0 = time.perf_counter()
    for P in IVF_P:
        for D in IVF_D:
            N = P + P // 2 + 3
            emb, meta, pairs = make_arena(rng, N, D, dups=8)
            arena = upload(emb, meta, pairs)
            cand = make_cand(rng, P, N)
            for bi, B in enumerate(IVF_B):
                q, preds, _ = make_batch(rng, emb, B, 2, pairs)
                pred = preds[(bi + P) % 2]          # pass-all or random
                for k in IVF_K + (P + 5,):
                    probe_case(f"P{P}-D{D}-B{B}-k{k}", arena, cand, pred, q,
                               k, errs)
                    n_cases += 1
    # through the public ivf_probe: member padding, a padded cluster list,
    # an overflow tail, a poisoned table, dead and empty sets, ties
    N, D, C, cap = 5000, 128, 20, 300
    emb, meta, _ = make_arena(rng, N, D)
    arena = upload(emb, meta, ())
    members = member_table(rng, N, C, cap)
    overflow = rng.integers(0, N, 37).astype(np.int32)
    clusters = np.array([3, 0, 7, 11, 19, 5, 2, 14] + [-1] * 8, np.int32)
    poisoned = members.copy()
    junk = rng.integers(-5, N + 500, members.shape)
    bad = rng.random(members.shape) < 0.25
    poisoned[bad] = junk[bad]
    poisoned[1, :40] = poisoned[0, :40]             # duplicate slots
    bad_over = rng.integers(-5, N + 500, 16).astype(np.int32)
    q, preds, _ = make_batch(rng, emb, 11, 3)
    for name, mem, over in (("padded", members, overflow),
                            ("poisoned", poisoned, bad_over)):
        P = cap * len(clusters) + len(over)
        for g in range(3):
            for k in (10, 100, P + 3):
                probe_ops_case(f"{name}-g{g}-k{k}", arena, mem, over,
                               clusters, preds[g], q, k, errs)
                n_cases += 1
    # the compaction's edges: every slot dead (P_live 0), fewer live slots
    # than k, live counts off a tile multiple, poisoned slots only
    N, D = 3000, 96
    emb, meta, pairs = make_arena(rng, N, D, dups=8)
    arena = upload(emb, meta, pairs)
    q, preds, _ = make_batch(rng, emb, 17, 2, pairs)
    edges = {"all-dead": np.where(rng.random(4097) < 0.5, -1,
                                  N + rng.integers(0, 50, 4097)),
             "live-under-k": np.full(1000, -1),
             "poisoned": rng.integers(-5, N + 500, 4097)}
    edges["live-under-k"][[3, 400, 999]] = rng.integers(0, N, 3)
    for n_live in (1, 255, 257, 511, 1000):
        v = np.empty(4097, np.int64)
        keep = np.sort(rng.choice(4097, n_live, replace=False))
        dead = np.setdiff1d(np.arange(4097), keep)
        v[keep] = rng.integers(0, N, n_live)
        v[dead] = np.where(rng.random(dead.size) < 0.5, -1, N + 7)
        edges[f"live-{n_live}"] = v
    live_counts = {}
    for name, v in edges.items():
        for g, k in ((0, 10), (1, 33)):
            live_counts[name] = probe_case(f"edge-{name}-g{g}-k{k}", arena,
                                           v.astype(np.int32), preds[g], q,
                                           k, errs)
            n_cases += 1
    check(live_counts["all-dead"] == 0 and live_counts["live-under-k"] == 3
          and all(live_counts[f"live-{n}"] == n
                  for n in (1, 255, 257, 511, 1000)),
          f"compaction counts {live_counts}")
    dead = upload(*make_arena(rng, 600, 64, dead=True))
    q, preds, _ = make_batch(rng, dead[0].cpu().numpy(), 8, 1)
    s_k, i_k = probe_ops_case("all-dead", dead, member_table(rng, 600, 4, 128),
                              overflow[:5] % 600, np.arange(4, dtype=np.int32),
                              preds[0], q, 10, errs)
    check((i_k == -1).all(), "all-dead: a dead row was returned")
    q, preds, _ = make_batch(rng, arena[0].cpu().numpy(), 3, 1)
    s_k, i_k = probe_ops_case("empty", arena, members, overflow[:0],
                              np.zeros(0, np.int32), preds[0], q, 10, errs)
    check((i_k == -1).all(), "empty set: a row was returned")
    n_cases += 2
    # ties: duplicate embeddings listed high slot first, so candidate
    # position and slot order disagree; the kernel must follow position
    emb, meta, pairs = make_arena(rng, 700, 64, dups=40)
    meta[:, 0] = np.maximum(meta[:, 0], 0)          # every pair row live
    arena = upload(emb, meta, pairs)
    tied = np.full((4, 128), -1, np.int32)
    tied.reshape(-1)[:2 * len(pairs)] = ([hi for _, hi in pairs]
                                         + [lo for lo, _ in pairs])
    q, _, _ = make_batch(rng, emb, 8, 1, pairs)
    for k in (1, 10, 33, 100):
        probe_ops_case(f"ties-k{k}", arena, tied, overflow[:0] % 700,
                       np.arange(4, dtype=np.int32),
                       np.array([-2, 0, -1, -1], np.int32), q, k, errs,
                       [(hi, lo) for lo, hi in pairs])
        n_cases += 1
    emit("ivf_kernel", cases=n_cases, max_abs_err=max(errs),
         seconds=time.perf_counter() - t0, tol=TOL, leaked_slots=0,
         ties="lower candidate position", compaction="equal to its plain "
         "version", compacted="bit-identical to the padded vector's lists, "
         f"resident and paged at {EDGE_PAGE}-row pages",
         edge_live_counts=live_counts)
    return max(errs)


def same_bits(a, b):
    """Two float32 numpy arrays equal bit for bit."""
    return a.shape == b.shape and (a.view(np.int32) == b.view(np.int32)).all()


def bits_equal(a, b):
    """Two result tuples equal bit for bit (scores compared as int32)."""
    return all(x.shape == y.shape and (
        x.view(np.int32) == y.view(np.int32)).all()
        for x, y in zip(tnp(*a), tnp(*b)))


def paged_case(mode, name, arena, lexd, cand, batch, k, P, errs):
    """One paged-kernel case: the paged lists against the resident
    kernel's (bit for bit) and against the paged kernel's plain version,
    the streaming scan at blk_n = P (`compare`'s contract, 0 leaks). One
    paged launch."""
    from repro_torch.kernels.arena_scan.stages import bm25_scores
    from repro_torch.kernels.hybrid_score.ref import _fold, qidf_of
    (emb_d, meta_d, meta, pairs), (q, preds, gids, qterms) = arena, batch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    if mode == "probe":
        args = (t(q), emb_d, meta_d, t(cand), t(preds[0]), k)
        res = ivf_mod.ivf_probe_cuda(*args)
        pg = ivf_mod.ivf_probe_cuda(*args, page_rows=P)
        pl = ivf_mod.ivf_probe_plain(*args, page_rows=P)
        sync()
        check(bits_equal(pg, res), f"{name}: paged lists != resident lists")
        N = meta.shape[0]
        mask = np.broadcast_to(host_mask(meta, preds[:1])[0],
                               (q.shape[0], N))
        errs.append(compare(name, *tnp(*pg, *pl), mask,
                            (args[0] @ emb_d.T).cpu().numpy(),
                            cand_pos=cand_positions(cand, N)))
        return
    mask = host_mask(meta, preds)[gids]
    if mode == "dense":
        args = (t(q), emb_d, meta_d, t(gids), t(preds))
        res = kernel_mod.arena_scan_cuda(*args, k)
        pg = kernel_mod.arena_scan_cuda(*args, k, page_rows=P)
        pl = kernel_mod.arena_scan_scan_ref(*args, k, P)
        sync()
        check(bits_equal(pg, res), f"{name}: paged lists != resident lists")
        errs.append(compare(name, *tnp(*pg, *pl), mask,
                            (args[0] @ emb_d.T).cpu().numpy(), pairs))
        return
    terms_d, lexnorm_d, idf_d = lexd
    qt_d = t(qterms)
    qidf = qidf_of(idf_d, qt_d).contiguous()
    args = (t(q), emb_d, meta_d, terms_d, lexnorm_d, t(gids), t(preds), qt_d,
            qidf, k)
    kw = dict(mode=mode, w_dense=W_DENSE, w_lex=W_LEX)
    res = hyb_mod.hybrid_score_cuda(*args, **kw)
    pg = hyb_mod.hybrid_score_cuda(*args, **kw, page_rows=P)
    pl = hyb_mod.hybrid_score_plain(*args, **kw, page_rows=P)
    sync()
    check(bits_equal(pg, res), f"{name}: paged lists != resident lists")
    qf, qidf_f = _fold(args[0], qidf, mode, W_DENSE, W_LEX)
    dense = qf @ emb_d.T
    bm = bm25_scores(terms_d, lexnorm_d, qt_d, qidf_f)
    # (make_lex redraws each row's lanes and tenant: no duplicate pairs)
    if mode == "wsum":
        errs.append(compare(name, *tnp(*pg, *pl), mask,
                            (dense + bm).cpu().numpy()))
        return
    d_k, di_k, l_k, li_k = tnp(*pg)
    d_p, di_p, l_p, li_p = tnp(*pl)
    errs.append(compare(f"{name}-dense", d_k, di_k, d_p, di_p, mask,
                        dense.cpu().numpy()))
    check((l_k == l_p).all() and (li_k == li_p).all(),
          f"{name}: bm25 list differs from the plain version's")
    compare(f"{name}-bm25", l_k, li_k, l_p, li_p, mask, bm.cpu().numpy())


def phase_paged_kernel():
    """The paged kernel in its four modes over page sizes P (128, 256,
    1000, 4096 and P >= N), B, k (k > 256, k > P, k > N), D (130 takes the
    4-byte copies), ragged N, G up to 8 with a BLOCK_ALL lane, T = 16 lanes
    with QT in {1, 4}, duplicate rows across pages and a dead stretch of
    1100 rows (whole pages with no live row)."""
    rng = np.random.default_rng(SEED + 30)
    errs = []
    n_cases = 0
    t0 = time.perf_counter()
    kernel_mod.PAGED_LAUNCHES = 0
    for mode in PAGED_MODES:
        for di, D in enumerate(PAGED_D):
            for ni, N in enumerate(PAGED_N):
                hot = rng.integers(0, LEX_V, 3).astype(np.int32)
                n_arena = N + N // 2 + 3 if mode == "probe" else N
                emb, meta, pairs = make_arena(rng, n_arena, D, dups=8)
                lexd = cand = None
                if mode in ("wsum", "rrf"):
                    terms, lexnorm, meta = make_lex(rng, meta, 16, hot)
                    lexd = (torch.from_numpy(terms).to(DEV),
                            torch.from_numpy(lexnorm).to(DEV),
                            torch.from_numpy((rng.random(LEX_V) * 5)
                                             .astype(np.float32)).to(DEV))
                dead = slice(N // 3, N // 3 + 1100)
                if mode == "probe":
                    cand = make_cand(rng, N, n_arena)
                    cand[dead] = -1
                else:
                    meta[dead, 0] = -1
                arena = upload(emb, meta, pairs)
                for pi, P in enumerate(PAGED_P):
                    P = P or N + 13
                    B = PAGED_B[(pi + di + ni) % len(PAGED_B)]
                    G = 2 if mode == "probe" else (1, 3, 8)[(pi + ni) % 3]
                    q, preds, gids = make_batch(rng, emb, B, G, pairs,
                                                block_all=G == 8)
                    if mode == "probe":     # one predicate: pass-all or not
                        preds = preds[pi % 2:][:1]
                    QT = (1, 4)[(pi + di) % 2]
                    qterms = make_qterms(rng, B, QT, hot)
                    choices = (1, 10, 33, 300, P + 5, N + 7)
                    for k in sorted({choices[(pi + di) % 6],
                                     choices[(pi + di + ni + 3) % 6]}):
                        paged_case(
                            mode, f"{mode}-N{N}-D{D}-P{P}-B{B}-G{G}-k{k}",
                            arena, lexd, cand, (q, preds, gids, qterms), k, P,
                            errs)
                        n_cases += 1
    for name, arena, lexd, (q, preds, gids), qterms in lex_edge_draws(rng):
        for mode in ("wsum", "rrf"):
            for P, k in ((EDGE_LEX_PAGE, 10), (300, 33)):
                paged_case(mode, f"edge-{name}-{mode}-P{P}-k{k}", arena, lexd,
                           None, (q, preds, gids, qterms), k, P, errs)
                n_cases += 1
    launches = kernel_mod.PAGED_LAUNCHES
    check(launches == n_cases,
          f"PAGED_LAUNCHES {launches} != {n_cases} paged calls")
    emit("paged_kernel", cases=n_cases, paged_launches=launches,
         modes=list(PAGED_MODES), page_rows=[p or "N+13" for p in PAGED_P],
         max_abs_err=max(errs), seconds=time.perf_counter() - t0, tol=TOL,
         resident="bit-identical", leaked_slots=0)
    return max(errs)

def phase_bench(dev):
    from repro_torch.api import RagDB
    from repro_torch.configs import rag_unified
    from repro_torch.core.query import unified_query_ref
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, make_corpus

    t_phase = time.perf_counter()

    ccfg = rag_unified.BENCH_CORPUS
    db = RagDB(rag_unified.BENCH,
               device=dev)
    db.ingest(make_corpus(ccfg, device=dev))
    rng = np.random.default_rng(SEED + 1)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((1, 60, [0, 1]), (4, 120, [2]),
                              (9, 30, [0, 3, 4]), (17, 150, [1, 2, 3]))]
    qs = rng.standard_normal((32, 128)).astype(np.float32)

    def plans():
        out = []
        for r in range(32):
            p, ts, cats = groups[r % 4]
            out.append(db.session(p).search(qs[r]).newer_than(ts)
                       .in_categories(cats).limit(10).plan())
        return out

    batch = plans()
    check(all(p.engine == "cuda" for p in batch), "plans must pick 'cuda'")
    before = dataclasses.replace(db.stats)
    kernel_mod.LAUNCHES = 0
    s, sl, _ = db.execute(batch)
    launches = kernel_mod.LAUNCHES
    st = db.stats
    check(st.fused_scans - before.fused_scans == 1, "batch did not fuse")
    check(st.device_calls - before.device_calls == 1,
          "device_calls != dispatch units (1)")
    check(st.rows_scanned - before.rows_scanned
          == rag_unified.BENCH.capacity,
          "rows_scanned != arena capacity")
    check(launches >= 1, "kernel LAUNCHES did not grow")
    snap = db.log.snapshot()
    meta = torch.stack([snap[c] for c in ("tenant", "updated_at",
                                          "category", "acl")], 1).cpu().numpy()
    errs = []
    for r, plan in enumerate(batch):
        pa = plan.pred.as_array(dev)
        rs, ri = unified_query_ref(snap, torch.from_numpy(plan.logical.q)
                                   .to(dev), pa, 10)
        mask = host_mask(meta, pa.cpu().numpy()[None, :])
        errs.append(compare(f"bench-row{r}", s[r:r + 1], sl[r:r + 1],
                            rs.cpu().numpy(), ri.cpu().numpy(), mask))
    check(max(int((sl[r] >= 0).sum()) for r in range(32)) == 10,
          "no row filled its k-list")

    def run_row1():
        p1, ts1, cats1 = groups[1]
        return (db.session(p1).search(qs[1]).newer_than(ts1)
                .in_categories(cats1).limit(10).run())

    check(run_row1().cached, "a repeat before any write must hit the cache")
    # writes: delete row 0's best doc; move a group-1 doc onto row 1's query
    doc_of = {v: d for d, v in db.log._slot_of_doc.items()}
    gone_slot = int(sl[0, 0])
    p1, ts1, cats1 = groups[1]
    cand = np.nonzero((meta[:, 0] == p1.tenant_id) & (meta[:, 1] >= ts1)
                      & np.isin(meta[:, 2], cats1)
                      & ((meta[:, 3] & 0xFF) != 0))[0]
    moved = doc_of[int(cand[-1])]
    q1 = qs[1] / np.linalg.norm(qs[1])
    db.delete([doc_of[gone_slot]])
    db.update([moved], q1[None, :], [ccfg.now_ts])
    res = run_row1()
    check(not res.cached, "the cache must miss after a write")
    check(int(res.slots[0, 0]) == db.log.slot_of(moved)
          and abs(float(res.scores[0, 0]) - 1.0) < 1e-4,
          "the updated doc is not its query's new top-1")
    s2, sl2, _ = db.execute(plans())
    check(gone_slot not in sl2[0::4].ravel().tolist(),
          "the deleted doc is still served")
    emit("bench", seconds=time.perf_counter() - t_phase, rows=32, groups=4,
         engine="cuda", launches=launches,
         fused_scans=1, device_calls=1,
         rows_scanned=rag_unified.BENCH.capacity,
         max_abs_err=max(errs),
         writes="deleted doc gone, updated doc top-1, cache missed")
    return launches, max(errs)


def phase_hybrid_bench(dev):
    from repro_torch.api import RagDB
    from repro_torch.configs import rag_unified
    from repro_torch.core.store import DocBatch
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import make_corpus, make_keyword_queries
    from repro_torch.index.lexical import LexicalConfig
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.hybrid_score.ref import hybrid_score_ref, qidf_of

    t_phase = time.perf_counter()

    ccfg = rag_unified.BENCH_CORPUS
    db = RagDB(rag_unified.BENCH,
               lexical_cfg=LexicalConfig(), device=dev)
    corpus = make_corpus(ccfg, device=dev)
    db.ingest(corpus)
    q, terms_list, relevant = make_keyword_queries(ccfg, corpus, 32,
                                                   seed=SEED + 3)
    acls = (0xFF, 0x0F, 0xF0, 0x33)           # 4 predicate groups
    doc_acl = corpus.acl.cpu().numpy().view(np.uint32)   # doc_id == row

    def plans(mode=None):
        out = []
        for r in range(32):
            b = db.session(Principal(-2, acls[r % 4])).search(q[r]).limit(10)
            if mode is not None:
                b = b.match(terms_list[r]).fuse(mode)
            out.append(b.plan())
        return out

    snap = db.log.snapshot()
    doc_ids = snap["doc_id"].cpu().numpy()
    meta = _packed_meta(snap["tenant"], snap["updated_at"], snap["category"],
                        snap["acl"])
    meta_np = meta.cpu().numpy()

    def recall(slots):
        tot, n = 0.0, 0
        for r in range(32):
            rel = {int(d) for d in relevant[r] if doc_acl[d] & acls[r % 4]}
            if rel:
                got = {int(doc_ids[x]) for x in slots[r] if x >= 0}
                tot += len(got & rel) / min(10, len(rel))
                n += 1
        return tot / n

    dense_s, dense_sl, _ = db.execute(plans(), use_cache=False)
    out = {"recall_dense": recall(dense_sl)}
    errs = []
    lx = db.lex.snapshot()
    for mode in ("wsum", "rrf"):
        batch = plans(mode)
        check(all(p.engine == "hybrid" for p in batch),
              "match() plans must pick 'hybrid'")
        before = dataclasses.replace(db.stats)
        hyb_mod.LAUNCHES = 0
        s, sl, _ = db.execute(batch, use_cache=False)
        launches = hyb_mod.LAUNCHES
        st = db.stats
        check(launches == 1, f"{launches} hybrid launches for one batch")
        check(st.fused_scans - before.fused_scans == 1, "batch did not fuse")
        check(st.device_calls - before.device_calls == 1, "device_calls != 1")
        check(st.terms_scanned - before.terms_scanned
              == rag_unified.BENCH.capacity * 16,
              "terms_scanned != arena rows x lanes")
        for r, plan in enumerate(batch):
            qt = np.full((1, plan.lex[1]), -1, np.int32)
            qt[0, :len(plan.logical.match_terms)] = plan.logical.match_terms
            qt_d = torch.from_numpy(qt).to(dev)
            pa = plan.pred.as_array(dev)
            rs, ri = hybrid_score_ref(
                torch.from_numpy(plan.logical.q).to(dev), snap["emb"], meta,
                lx["terms"], lx["lexnorm"],
                torch.zeros(1, dtype=torch.int32, device=dev), pa[None, :],
                qt_d, qidf_of(lx["idf"], qt_d), 10, mode=mode,
                rrf_c=float(db.lex.cfg.rrf_c))
            errs.append(compare(f"hybrid-bench-{mode}-row{r}", s[r:r + 1],
                                sl[r:r + 1], *tnp(rs, ri),
                                host_mask(meta_np, pa.cpu().numpy()[None]),
                                lower_slot_ties=mode == "wsum"))
        out[f"launches_{mode}"] = launches
        out[f"recall_{mode}"] = recall(sl)
    check(out["recall_wsum"] > out["recall_dense"],
          f"hybrid recall {out['recall_wsum']} <= dense {out['recall_dense']}")
    # a lexical write: one doc carrying the rarest term at the highest tf
    # and the shortest length, so it outranks every other carrier
    rare = int(np.argmin(db.lex.stats.df))
    admin = db.admin_session()
    run = lambda: admin.search(q[0]).match([rare]).limit(5).run()
    check(not run().cached and run().cached, "repeat must hit the cache")
    one = np.random.default_rng(SEED + 4).standard_normal((1, 128))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    db.ingest(DocBatch(emb=torch.from_numpy(one.astype(np.float32)).to(dev),
                       tenant=i32([0]), category=i32([0]),
                       updated_at=i32([ccfg.now_ts]), acl=i32([-1]),
                       doc_id=i32([990_000]), terms=i32([[rare]]),
                       tfs=i32([[3]])))
    res = run()
    check(not res.cached, "the cache must miss after a lexical write")
    check(int(res.slots[0, 0]) == db.log.slot_of(990_000),
          "the written doc is not the top-1 of its only term")
    emit("hybrid_bench", seconds=time.perf_counter() - t_phase, rows=32,
         groups=4, engine="hybrid",
         max_abs_err=max(errs), writes="lexical write visible, cache missed",
         **out)
    return max(errs)


def phase_ivf_bench(dev):
    from repro_torch.api import RagDB
    from repro_torch.configs import rag_unified
    from repro_torch.core.store import DocBatch
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import make_corpus, make_queries
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.ivf_probe.ref import candidate_slots

    t_phase = time.perf_counter()

    ccfg = rag_unified.BENCH_CORPUS
    db = RagDB(rag_unified.BENCH,
               device=dev)
    db.ingest(make_corpus(ccfg, device=dev))
    t0 = time.perf_counter()
    ix = db.build_index()
    sync()
    build_s = time.perf_counter() - t0
    admin = db.admin_session()
    qs = make_queries(ccfg, 64, seed=SEED + 6, device="cpu").numpy()[:, 0]
    batch = [admin.search(qs[r]).limit(10).plan() for r in range(32)]
    check(all(p.engine == "ivf" for p in batch), "admin plans must pick 'ivf'")
    before = dataclasses.replace(db.stats)
    ivf_mod.LAUNCHES = ivf_mod.COMPACT_LAUNCHES = kernel_mod.LAUNCHES = 0
    s, sl, _ = db.execute(batch, use_cache=False)
    launches = ivf_mod.LAUNCHES
    check(launches == 1 and ivf_mod.COMPACT_LAUNCHES == 1,
          f"{launches} ivf launches, {ivf_mod.COMPACT_LAUNCHES} compactions "
          "for one batch")
    check(kernel_mod.LAUNCHES == 0, "an admin batch ran a rescan")
    check(db.stats.device_calls - before.device_calls == 1, "device_calls != 1")
    q = np.stack([p.logical.q[0] for p in batch])
    clusters, n_probed, P = ix.probe(q, ix.cfg.nprobe)
    check(db.stats.rows_scanned - before.rows_scanned == P,
          "rows_scanned != the probe's candidate rows")
    # every row of the batch against the plain version on the same inputs
    snap = db.log.snapshot()
    meta = _packed_meta(snap["tenant"], snap["updated_at"], snap["category"],
                        snap["acl"])
    d = ix.device_arrays()
    cand = candidate_slots(d["members"], d["overflow"], clusters)
    pred = batch[0].pred.as_array(dev)
    q_d = torch.from_numpy(q).to(dev)
    s_p, i_p = ivf_mod.ivf_probe_plain(q_d, snap["emb"], meta, cand, pred, 10)
    cand_np = cand.cpu().numpy()
    mask = np.broadcast_to(host_mask(meta.cpu().numpy(),
                                     pred.cpu().numpy()[None])[0],
                           (32, meta.shape[0]))
    err = compare("ivf-bench", s, sl, *tnp(s_p, i_p), mask,
                  (q_d @ snap["emb"].T).cpu().numpy(),
                  cand_pos=cand_positions(cand_np, meta.shape[0]))
    # recall@10 against the exact kernel engine over 64 query rows
    iv = db.execute([admin.search(qs[r]).limit(10).plan()
                     for r in range(64)], use_cache=False)[1]
    ex = db.execute([admin.search(qs[r]).limit(10).using("cuda").plan()
                     for r in range(64)], use_cache=False)[1]
    recall = float(np.mean([len(set(iv[r].tolist()) & set(ex[r].tolist()))
                            / 10 for r in range(64)]))
    # a tenant session: the selectivity guard keeps it exact; a forced
    # probe leaks nothing
    tenant_of = snap["tenant"].cpu().numpy()
    acl_of = snap["acl"].cpu().numpy().view(np.uint32)
    sess = db.session(Principal(3, 0xFF))
    plan = sess.search(qs[0]).limit(10).plan()
    exact = "cuda" if dev.type == "cuda" else "ref"
    check(plan.engine == exact and "ivf skipped" in plan.engine_reason,
          f"tenant plan: {plan.engine} ({plan.engine_reason})")
    forced = sess.search(qs[0]).limit(10).using("ivf").run()
    got = forced.slots[forced.slots >= 0]
    check(len(got) == 10 and (tenant_of[got] == 3).all()
          and ((acl_of[got] & 0xFF) != 0).all(), "forced ivf leaked")
    # a recency bound only ~20 rows clear: the rescan completes the k-list
    ts = snap["updated_at"].cpu().numpy()
    min_ts = int(np.sort(ts[tenant_of >= 0])[-20])
    tight = admin.search(qs[1]).newer_than(min_ts).limit(10)
    check(tight.plan().engine == "ivf", "a recency-only plan must pick 'ivf'")
    kernel_mod.LAUNCHES = 0
    rows0 = db.stats.rows_scanned
    res = tight.run()
    _, _, P1 = ix.probe(res.plan.logical.q, ix.cfg.nprobe)
    check(kernel_mod.LAUNCHES == int(exact == "cuda"),
          "the completeness rescan did not run on the kernel")
    check(db.stats.rows_scanned - rows0 == P1 + rag_unified.BENCH.capacity,
          "rows_scanned != probe + one arena rescan")
    ref = admin.search(qs[1]).newer_than(min_ts).limit(10).using("cuda").run()
    check((res.slots == ref.slots).all() and (res.scores == ref.scores).all(),
          "the rescanned rows differ from the exact engine's")
    # a write at the query's embedding: the mirror patches in place, the
    # cache misses and the new slot comes first
    q0 = batch[0].logical.q[0]
    check(not admin.search(q0).limit(10).run().cached
          and admin.search(q0).limit(10).run().cached, "repeat must hit")
    uploads, patches = ix.mirror_uploads, ix.mirror_patches
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    db.ingest(DocBatch(emb=torch.from_numpy(q0[None]).to(dev),
                       tenant=i32([0]), category=i32([0]),
                       updated_at=i32([ccfg.now_ts]), acl=i32([-1]),
                       doc_id=i32([990_001])))
    res = admin.search(q0).limit(10).run()
    check(not res.cached and res.plan.engine == "ivf",
          "the cache must miss after a write")
    check(int(res.slots[0, 0]) == db.log.slot_of(990_001),
          "the written doc is not its query's top-1")
    in_table = ix._slot_pos[db.log.slot_of(990_001)][0] >= 0
    check(ix.mirror_uploads == uploads
          and ix.mirror_patches == patches + int(in_table),
          "a write must patch the mirror, not re-upload it")
    # a rebuild bumps the epoch, and ivf cache entries miss
    check(admin.search(q0).limit(10).run().cached, "repeat must hit")
    epoch = ix.epoch
    db.build_index(ix.cfg)
    check(db.index.epoch == epoch + 1, "a rebuild must bump the epoch")
    check(not admin.search(q0).limit(10).run().cached,
          "the cache must miss after a rebuild")
    emit("ivf_bench", seconds=time.perf_counter() - t_phase, rows=32,
         engine="ivf", launches=launches, build_s=build_s,
         clusters=ix.n_clusters, cap=ix.cluster_cap,
         overflow=len(ix.overflow), probed_clusters=n_probed,
         rows_scanned=P, recall_at_10=recall, max_abs_err=err,
         writes="rescan exact, write visible, mirror patched, epoch miss")
    return err


def peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def profile_batch(fn, tags=()):
    """Device time by kernel over one call of ``fn`` (torch.profiler, after
    an untimed warm-up call), its split into the scan's tile_scan (or
    paged_scan) / merge / finish kernels, copies and other PyTorch kernels
    (input staging, rrf_fuse), and the device's idle share of the call's
    wall time. ``tags`` names kernels the call must launch (substrings of
    their names): the trace can lose a call's kernels on the card, so a
    trace that holds none of them is taken again, up to 3 times in all,
    and a trace still without them reports ``trace_lost`` and no idle
    share (None) instead of one for the trace rather than the card."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, 4):
        # one traced warm-up call first: without it the trace can miss the
        # first kernels of the call (seen on the card for a lone long
        # kernel)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            sync()
            prof.step()
            t0 = time.perf_counter()
            fn()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
            # no step here: ending the cycle would clear its events
        rows = []
        for ev in prof.key_averages():
            if ev.key.startswith("ProfilerStep"):   # the step's own span
                continue
            dev_us = getattr(ev, "device_time_total", 0) or 0
            if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                    and "CUDA" in str(ev.device_type):
                rows.append((ev.key, ev.count, dev_us / 1e3))
        lost = bool(tags) and not any(tag in name for name, _, _ in rows
                                      for tag in tags)
        if not lost:
            break
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    split = dict.fromkeys(("tile_scan", "page_scan", "merge", "finish",
                           "memcpy", "other"), 0.0)
    for name, _, ms in rows:
        part = next((c for c, tag in (("tile_scan", "tile_scan_kernel"),
                                      ("page_scan", "paged_scan_kernel"),
                                      ("merge", "merge_kernel"),
                                      ("finish", "finish_kernel"),
                                      ("memcpy", "Memcpy")) if tag in name),
                    "other")
        split[part] += ms
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_ms,
            "idle_share": (None if lost
                           else max(0.0, 1 - busy_ms / (wall_us / 1e3))),
            "trace_lost": lost, "traces": attempt,
            "split_ms": split,
            "kernels": [{"name": n[:60], "calls": c, "ms": ms}
                        for n, c, ms in rows[:8]]}


def device_ms(fn, iters, tries=3):
    """Device time a call of ``fn`` under torch.profiler over ``iters``
    calls (after a traced warm-up cycle, as in `profile_batch`), and the
    kernels the calls launched, by name, with their launches captured. The
    trace may drop some or all launches of a long kernel, so a call's time
    is the sum over kernels of the mean time a launch times the launches a
    call (one when fewer than ``iters`` were captured). A trace that
    captured no kernel (two of a whole run's on an H100) is taken again,
    up to ``tries`` times; None when none did (the CUDA-event time stands
    then)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    ms, kernels = 0.0, {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            sync()
            prof.step()
            for _ in range(iters):
                fn()
            sync()
        for ev in prof.key_averages():
            if ev.key.startswith("ProfilerStep"):
                continue
            dev_us = getattr(ev, "device_time_total", 0) or 0
            if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                    and "CUDA" in str(ev.device_type):
                kernels[ev.key[:60]] = ev.count
                ms += (dev_us / ev.count * max(1, round(ev.count / iters))
                       / 1e3)
        if kernels:
            break
    return (ms if kernels else None), kernels


def sampled(fn):
    """fn() with the card's SM clock (MHz) and power draw (W) sampled
    every 100 ms by nvidia-smi: (fn's result, [[MHz, W], ...])."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    return out, [[float(x) for x in ln.split(",")]
                 for ln in text.splitlines() if ln.count(",") == 1]


def events_ms(fn, iters):
    fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / iters


def prod_cut():
    """(rows, dim) of the prod cells: rag_unified.PRODUCTION (2^26 x 768)
    cut to 2^23 rows, what one 80 GB card holds twice during an
    out-of-place commit."""
    from repro_torch.configs import rag_unified
    return rag_unified.PRODUCTION.capacity >> 3, rag_unified.PRODUCTION.dim


def phase_prod(dev, n_rows=None, dim=None, chunk=1 << 20, ptxas=()):
    from repro_torch.api import RagDB
    from repro_torch.core.store import StoreConfig
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, device_corpus
    from repro_torch.index.lexical import LexicalConfig
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.arena_scan.stages import ScanSpec

    t_phase = time.perf_counter()

    n_rows, dim = n_rows or prod_cut()[0], dim or prod_cut()[1]
    ccfg = CorpusConfig(n_docs=n_rows, dim=dim, n_tenants=20, n_categories=5)
    db = RagDB(StoreConfig(capacity=n_rows, dim=dim),
               lexical_cfg=LexicalConfig(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    host_s = []
    t_ingest0 = time.perf_counter()
    for start in range(0, n_rows, chunk):
        batch = device_corpus(ccfg, start, chunk, gen)
        sync()
        t0 = time.perf_counter()
        db.ingest(batch)
        host_s.append(time.perf_counter() - t0)
        del batch
    sync()
    ingest_s = time.perf_counter() - t_ingest0
    check(int(db.log.snapshot()["n_live"]) == n_rows, "n_live after ingest")
    check(db.lex.stats.n_docs == n_rows, "lexical docs after ingest")

    rng = np.random.default_rng(SEED + 2)
    qs = rng.standard_normal((32, dim)).astype(np.float32)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((2, 90, [0, 1]), (5, 150, [2, 3]),
                              (11, 45, [4]), (19, 170, [0, 2, 4]))]
    plans = []
    for r in range(32):
        p, ts, cats = groups[r % 4]
        plans.append(db.session(p).search(qs[r]).newer_than(ts)
                     .in_categories(cats).limit(10).plan())
    check(all(p.engine == "cuda" for p in plans), "plans must pick 'cuda'")

    kernel_mod.LAUNCHES = 0
    lat = []
    n_batches = 6
    for _ in range(n_batches):
        t0 = time.perf_counter()
        s, sl, _ = db.execute(plans, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_mod.LAUNCHES
    check(launches == n_batches, f"{launches} launches for {n_batches} "
          "fused batches")
    profile = profile_batch(lambda: db.execute(plans, use_cache=False),
                            SCAN_TAGS)

    # the kernel's inputs exactly as the executor builds them
    snap = db.log.snapshot()
    meta = _packed_meta(snap["tenant"], snap["updated_at"],
                        snap["category"], snap["acl"])
    order = [r for g in range(4) for r in range(g, 32, 4)]
    q = torch.from_numpy(np.concatenate([plans[r].logical.q
                                         for r in order])).to(dev)
    gids = torch.tensor([g for g in range(4) for _ in range(8)],
                        dtype=torch.int32, device=dev)
    preds = torch.stack([plans[g].pred.as_array(dev) for g in range(4)])
    args = (q, snap["emb"], meta, gids, preds, 10)
    s_k, i_k = kernel_mod.arena_scan_cuda(*args)
    s_p, i_p = kernel_mod.arena_scan_plain(*args)
    sync()
    mask_host = host_mask(meta.cpu().numpy(), preds.cpu().numpy())
    err = compare("prod", s_k.cpu().numpy(), i_k.cpu().numpy(),
                  s_p.cpu().numpy(), i_p.cpu().numpy(),
                  mask_host[gids.cpu().numpy()])
    # the front door's rows equal the direct kernel call's rows
    inv = np.argsort(order)
    check((sl == i_k.cpu().numpy()[inv]).all(), "run() rows != kernel rows")

    ms = events_ms(lambda: kernel_mod.arena_scan_cuda(*args), 10)
    _, clocks = sampled(
        lambda: events_ms(lambda: kernel_mod.arena_scan_cuda(*args), 60))
    dev_ms, _ = device_ms(lambda: kernel_mod.arena_scan_cuda(*args), 5)
    info = kernel_mod.scan_info(ScanSpec(), 32, n_rows, 4, 10)
    check(info["blocks_per_sm"] >= 2, f"resident dense kernel: "
          f"{info['blocks_per_sm']} block(s) an SM, expected >= 2")
    plain_ms = events_ms(lambda: kernel_mod.arena_scan_plain(*args), 3)
    keep = torch.ones((32, n_rows), dtype=torch.bool, device=dev)

    def yardstick():
        sc = torch.matmul(q, snap["emb"].T)
        return torch.topk(torch.where(keep, sc, -3.4e38), 10, dim=1)

    yard_ms = events_ms(yardstick, 3)
    B, D, N, G, k = 32, dim, n_rows, 4, 10
    nbytes = N * (4 * D + 16) + B * D * 4 + B * 4 + G * 16 + B * k * 8
    flops = 2 * B * N * D
    bound_ms = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
    emit("prod", seconds=time.perf_counter() - t_phase, rows=N, dim=D,
         lanes=db.lex.cfg.doc_terms, batch=B,
         groups=G, k=k,
         batch_ms_median=statistics.median(lat), batch_ms=lat,
         launches=launches, kernel_ms=ms, kernel_device_ms=dev_ms,
         kernel_clock_mhz_power_w=clocks,
         scan_info=info, dense_scan_ptxas=list(ptxas), bound_ms=bound_ms,
         bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS
         else "operations", plain_ms=plain_ms, yardstick_ms=yard_ms,
         ingest_s=ingest_s, ingest_host_s=sum(host_s),
         ingest_host_s_per_chunk=host_s,
         peak_mem_gb=peak_gb(), profile=profile,
         max_abs_err=err)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, max_abs_err=err,
                bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS
                else "operations", db=db, groups=groups, now_ts=ccfg.now_ts,
                ingest_host_s=sum(host_s), plans=plans, args=args)


def phase_hybrid_prod(dev, prod):
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.arena_scan.stages import (ScanSpec, bm25_scores,
                                                       predicate_keep)
    from repro_torch.kernels.hybrid_score.ref import _fold, qidf_of, rrf_fuse

    t_phase = time.perf_counter()

    db, groups = prod["db"], prod["groups"]
    snap, lx = db.log.snapshot(), db.lex.snapshot()
    N, D = snap["emb"].shape
    T = lx["terms"].shape[1]
    meta = _packed_meta(snap["tenant"], snap["updated_at"],
                        snap["category"], snap["acl"])
    rng = np.random.default_rng(SEED + 5)
    # each request: a live row its group can see, 3 of that row's term ids,
    # q near that row's embedding
    probe = [db.session(p).search(np.ones(D, np.float32)).newer_than(ts)
             .in_categories(c).plan().pred for p, ts, c in groups]
    keep = predicate_keep(meta, torch.stack([pr.as_array(dev)
                                             for pr in probe]))
    # each group's share of (row, query) pairs kept, and the rows some
    # group keeps (the only rows whose lanes the kernel reads)
    kept_share = keep.float().mean(dim=1).tolist()
    rows_kept = int(keep.any(dim=0).sum())
    anchors = []
    for r in range(32):
        rows = torch.nonzero(keep[r % 4]).squeeze(1)
        anchors.append(int(rows[int(rng.integers(0, rows.numel()))]))
    a_terms = lx["terms"][anchors].cpu().numpy()
    a_emb = snap["emb"][anchors].cpu().numpy()
    qs, mts = [], []
    for r in range(32):
        live = a_terms[r][a_terms[r] >= 0]
        mts.append(tuple(int(x) for x in rng.choice(live, 3, replace=False)))
        v = a_emb[r] + 0.02 * rng.standard_normal(D).astype(np.float32)
        qs.append(v / np.linalg.norm(v))

    def plans(mode):
        out = []
        for r in range(32):
            p, ts, cats = groups[r % 4]
            out.append(db.session(p).search(qs[r]).newer_than(ts)
                       .in_categories(cats).match(mts[r]).fuse(mode)
                       .limit(10).plan())
        return out

    by_mode = {m: plans(m) for m in ("wsum", "rrf")}
    check(all(p.engine == "hybrid" for ps in by_mode.values() for p in ps),
          "match() plans must pick 'hybrid'")
    n_batches = 6
    hyb_mod.LAUNCHES = 0
    lat, res = {}, {}
    for mode, ps in by_mode.items():
        lat[mode] = []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            res[mode] = db.execute(ps, use_cache=False)
            lat[mode].append((time.perf_counter() - t0) * 1e3)
    launches = hyb_mod.LAUNCHES
    check(launches == 2 * n_batches, f"{launches} hybrid launches for "
          f"{2 * n_batches} fused batches")
    profiles = {m: profile_batch(lambda ps=ps: db.execute(ps, use_cache=False),
                                 SCAN_TAGS)
                for m, ps in by_mode.items()}

    # the kernel's inputs exactly as the executor builds them
    order = [r for g in range(4) for r in range(g, 32, 4)]
    inv = np.argsort(order)
    q = torch.from_numpy(np.concatenate([by_mode["wsum"][r].logical.q
                                         for r in order])).to(dev)
    gids = torch.tensor([g for g in range(4) for _ in range(8)],
                        dtype=torch.int32, device=dev)
    preds = torch.stack([by_mode["wsum"][g].pred.as_array(dev)
                         for g in range(4)])
    qt = np.full((32, 4), -1, np.int32)
    for j, r in enumerate(order):
        qt[j, :3] = mts[r]
    qterms = torch.from_numpy(qt).to(dev)
    qidf = qidf_of(lx["idf"], qterms).contiguous()
    args = (q, snap["emb"], meta, lx["terms"], lx["lexnorm"], gids, preds,
            qterms, qidf, 10)
    mask = host_mask(meta.cpu().numpy(), preds.cpu().numpy())[gids.cpu()
                                                              .numpy()]
    errs, out = [], {}
    for mode in ("wsum", "rrf"):
        out_k = hyb_mod.hybrid_score_cuda(*args, mode=mode)
        out_p = hyb_mod.hybrid_score_plain(*args, mode=mode)
        sync()
        for j in range(0, len(out_k), 2):
            errs.append(compare(f"hybrid-prod-{mode}-{j}",
                                *tnp(out_k[j], out_k[j + 1]),
                                *tnp(out_p[j], out_p[j + 1]), mask))
        fused = out_k if mode == "wsum" else rrf_fuse(*out_k, 10, RRF_C)
        s, sl, _ = res[mode]
        check((sl == fused[1].cpu().numpy()[inv]).all()
              and (s == fused[0].cpu().numpy()[inv]).all(),
              f"run() rows != kernel rows ({mode})")
        out[mode] = dict(
            batch_ms_median=statistics.median(lat[mode]),
            batch_ms=lat[mode],
            ms=events_ms(lambda m=mode: hyb_mod.hybrid_score_cuda(
                *args, mode=m), 10),
            plain_ms=events_ms(lambda m=mode: hyb_mod.hybrid_score_plain(
                *args, mode=m), 3),
            anchor_in_top10=float(np.mean([anchors[r] in sl[r].tolist()
                                           for r in range(32)])),
            profile=profiles[mode])
        if mode == "rrf":
            out[mode]["rrf_fuse_ms"] = events_ms(
                lambda: rrf_fuse(*out_k, 10, RRF_C), 10)
    mask_d = torch.from_numpy(mask).to(dev)
    qf, qidf_f = _fold(q, qidf, "wsum", 1.0, 1.0)

    def yardstick():
        sc = torch.matmul(qf, snap["emb"].T) + bm25_scores(
            lx["terms"], lx["lexnorm"], qterms, qidf_f)
        return torch.topk(torch.where(mask_d, sc, -3.4e38), 10, dim=1)

    yard_ms = events_ms(yardstick, 3)

    # the keep-all draw: every group of any tenant, no recency cut, every
    # category and ACL bit, so the lexical stage runs for every live pair
    preds_all = torch.tensor([[-2, 0, -1, -1]] * 4, dtype=torch.int32,
                             device=dev)
    args_all = args[:6] + (preds_all,) + args[7:]
    mask_all = host_mask(meta.cpu().numpy(),
                         preds_all.cpu().numpy())[gids.cpu().numpy()]
    keep_all = {"kept_share": float(mask_all.mean())}
    for mode in ("wsum", "rrf"):
        out_k = hyb_mod.hybrid_score_cuda(*args_all, mode=mode)
        out_p = hyb_mod.hybrid_score_plain(*args_all, mode=mode)
        sync()
        for j in range(0, len(out_k), 2):
            errs.append(compare(f"hybrid-keepall-{mode}-{j}",
                                *tnp(out_k[j], out_k[j + 1]),
                                *tnp(out_p[j], out_p[j + 1]), mask_all))
        if mode == "rrf":
            check(bits_equal(out_k[2:], out_p[2:]),
                  "keep-all: bm25 list differs from the plain version's")
        keep_all[f"{mode}_ms"] = events_ms(
            lambda m=mode: hyb_mod.hybrid_score_cuda(*args_all, mode=m), 10)
    two_scan = two_scan_prod(db, by_mode["wsum"], qs, mts, res["wsum"][:2],
                             meta.cpu().numpy())
    two_scan["fused_batch_ms_median"] = out["wsum"]["batch_ms_median"]
    infos = {m: kernel_mod.scan_info(ScanSpec(score=s), 32, N, 4, 10, QT=4)
             for m, s in (("wsum", "fused"), ("rrf", "both"))}
    for m, info in infos.items():
        check(info["blocks_per_sm"] >= 2, f"resident {m} kernel: "
              f"{info['blocks_per_sm']} block(s) an SM, expected >= 2")

    B, G, QT, k = 32, 4, 4, 10
    small = B * D * 4 + B * 4 + G * 16 + B * QT * 8 + B * k * 8
    # all lanes (the plain version's reads), and the lanes of the rows some
    # group keeps (what this run's data needs: the kernel reads no other)
    bytes_all = N * (4 * D + 16 + 8 * T) + small
    nbytes = N * (4 * D + 16) + rows_kept * 8 * T + small
    flops = 2 * B * N * D
    bound_all_ms = max(bytes_all / HBM_BPS, flops / FP32_FLOPS) * 1e3
    bound_ms = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS \
        else "operations"
    emit("hybrid_prod", seconds=time.perf_counter() - t_phase, rows=N,
         dim=D, lanes=T, batch=B, groups=G,
         query_terms=3, qt_bucket=QT, k=k, launches=launches,
         kept_share=kept_share, rows_kept=rows_kept,
         bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
         bound_all_lanes_ms=bound_all_ms, bound_all_lanes_bytes=bytes_all,
         scan_info=infos, keep_all=keep_all,
         yardstick_ms=yard_ms, ingest_host_s=prod["ingest_host_s"],
         two_scan=two_scan, peak_mem_gb=peak_gb(), max_abs_err=max(errs),
         **out)
    return dict(launches=launches, ms=out["wsum"]["ms"],
                plain_ms=out["wsum"]["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max(errs), plans=by_mode,
                args=args)


def two_scan_prod(db, plans, qs, mts, fused, meta, reps=3, fetch=40):
    """The split-stack baseline (`two_scan_hybrid`, wsum) over the fused
    wsum batch's 4 tenant-scoped groups: a dense sidecar (the arena-scan
    kernel), a lexical sidecar (plain PyTorch, 2^20 rows a chunk) and the
    host merge, with the predicate pushed into both sidecars and without
    it (over-fetch, app-side filter, retries). Gates: no returned slot
    fails its group's predicate; in every row whose fused top-k set lies
    within the union of the two sidecars' lists (top-``fetch`` with the
    predicate, or open at the fetch where the retry ladder stopped: the
    union rescore sees every winner), the two-scan set equals the fused
    kernel's but for ties at the k-th place. Batch times: medians of
    ``reps`` batches of the 4 groups."""
    from repro_torch.core.query import Predicate, unified_query
    from repro_torch.index.lexical.twoscan import (_passes_pred,
                                                   lexical_topk,
                                                   two_scan_hybrid)
    snap, lx = db.log.snapshot(), db.lex.snapshot()
    f_s, f_i = fused
    out = {}
    for pushdown in (True, False):
        lat, got = [], {}
        for _ in range(reps):
            t0 = time.perf_counter()
            for g in range(4):
                rows = list(range(g, 32, 4))
                got[g] = two_scan_hybrid(
                    snap, lx, np.stack([qs[r] for r in rows]),
                    np.asarray([mts[r] for r in rows], np.int32),
                    plans[g].pred, 10, pushdown=pushdown)
            lat.append((time.perf_counter() - t0) * 1e3)
        leaks = checked = 0
        for g in range(4):
            rows = list(range(g, 32, 4))
            pred = plans[g].pred
            s2, i2 = got[g]
            for j, r in enumerate(rows):
                real = i2[j][i2[j] >= 0]
                leaks += int((~host_mask(meta[real], pred.as_array()
                                         .numpy()[None])[0]).sum())
            # the sidecars' lists the merge saw: with the predicate, or
            # open at the fetch where the over-fetch ladder stopped
            q = torch.from_numpy(np.stack([qs[r] for r in rows])).to(DEV)
            qt = np.asarray([mts[r] for r in rows], np.int32)
            side, c, retries = (pred, fetch, 0) if pushdown else (
                Predicate(), fetch, 4)
            while True:
                d_i = unified_query(snap, q, side, c, engine="cuda")[1]
                l_i = lexical_topk(snap, lx["terms"], lx["lexnorm"],
                                   lx["idf"], qt, side.as_array(DEV), c)[1]
                d_i, l_i = d_i.cpu().numpy(), l_i.cpu().numpy()
                if pushdown:
                    break
                filled = ((_passes_pred(snap, np.maximum(d_i, 0), pred)
                           & (d_i >= 0)).sum(axis=1) >= 10) | (
                    (_passes_pred(snap, np.maximum(l_i, 0), pred)
                     & (l_i >= 0)).sum(axis=1) >= 10)
                if filled.all() or c >= len(meta) or retries == 0:
                    break
                c, retries = min(c * 4, len(meta)), retries - 1
            for j, r in enumerate(rows):
                want = set(f_i[r][f_i[r] >= 0].tolist())
                if not want <= set(d_i[j].tolist()) | set(l_i[j].tolist()):
                    continue
                checked += 1
                have = set(i2[j][i2[j] >= 0].tolist())
                kth = f_s[r][len(want) - 1]
                for slot in want ^ have:
                    sc = (f_s[r][f_i[r] == slot] if slot in want
                          else s2[j][i2[j] == slot])[0]
                    check(abs(sc - kth) <= TOL * (1 + abs(kth)),
                          f"two-scan (pushdown={pushdown}) row {r}: slot "
                          f"{slot} differs from the fused set away from a "
                          "k-th place tie")
        check(leaks == 0, f"two-scan (pushdown={pushdown}): {leaks} leaked "
              "slots")
        out["pushdown" if pushdown else "faithful"] = {
            "batch_ms_median": statistics.median(lat), "batch_ms": lat,
            "leaked_slots": leaks, "rows_held_to_fused": checked}
    return out


def phase_ivf_prod(dev, prod):
    from repro_torch.core import ivf as ivf_core
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.arena_scan.stages import predicate_keep
    from repro_torch.kernels.ivf_probe.ref import candidate_slots

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    db, groups = prod["db"], prod["groups"]
    snap = db.log.snapshot()
    N, D = snap["emb"].shape
    meta = _packed_meta(snap["tenant"], snap["updated_at"],
                        snap["category"], snap["acl"])
    # the auto-sized build, split into k-means and the assignment on the
    # card and the member-table layout and slot map on the host
    spent = {"kmeans": 0.0, "assign": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    kmeans, assign = ivf_core._kmeans_allocations, ivf_core._assign
    ivf_core._kmeans_allocations = timed("kmeans", kmeans)
    ivf_core._assign = timed("assign", assign)
    try:
        t0 = time.perf_counter()
        ix = db.build_index()
        build_s = time.perf_counter() - t0
    finally:
        ivf_core._kmeans_allocations, ivf_core._assign = kmeans, assign
    t0 = time.perf_counter()
    ivf_core.IVFIndex(ix.cfg, ix.centroids, ix.members, ix.fill, ix.overflow,
                      ix.n_at_build, device=dev)
    slot_map_s = time.perf_counter() - t0

    # 32 admin requests with a recency bound only (the guard admits it),
    # each q near a live row that clears the bound
    min_ts = groups[3][1]
    rng = np.random.default_rng(SEED + 7)
    admin = db.admin_session()
    pred = admin.search(np.ones(D, np.float32)).newer_than(min_ts).plan().pred
    keep = predicate_keep(meta, pred.as_array(dev)[None])[0]
    rows = torch.nonzero(keep).squeeze(1)
    anchors = [int(rows[int(rng.integers(0, rows.numel()))])
               for _ in range(32)]
    a_emb = snap["emb"][anchors].cpu().numpy()
    qs = a_emb + 0.02 * rng.standard_normal(a_emb.shape).astype(np.float32)
    plans = [admin.search(qs[r]).newer_than(min_ts).limit(10).plan()
             for r in range(32)]
    check(all(p.engine == "ivf" for p in plans), "plans must pick 'ivf'")
    n_batches = 6
    ivf_mod.LAUNCHES = ivf_mod.COMPACT_LAUNCHES = kernel_mod.LAUNCHES = 0
    lat = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        s, sl, _ = db.execute(plans, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = ivf_mod.LAUNCHES
    check(launches == n_batches, f"{launches} ivf launches for {n_batches} "
          "batches")
    check(kernel_mod.LAUNCHES == 0, "a prod batch ran a completeness rescan")
    compact_launches = ivf_mod.COMPACT_LAUNCHES
    check(compact_launches == n_batches,
          f"{compact_launches} compactions for {n_batches} batches")
    profile = profile_batch(lambda: db.execute(plans, use_cache=False),
                            SCAN_TAGS + ("compact_",))

    # the executor's launch, with every synchronising CUDA call an error:
    # the quantizer, the compaction and the scan are queued without a wait
    from repro_torch.api.executor import _finish_hot, _launch_hot
    q = np.stack([p.logical.q[0] for p in plans])
    nprobe = ix.cfg.nprobe
    store = db.log.snapshot()
    _finish_hot(_launch_hot(store, q, pred, 10, "ivf", ivf=ix,
                            nprobe=nprobe, n_valid=32))
    sync()
    ivf_mod.LAUNCHES = ivf_mod.COMPACT_LAUNCHES = kernel_mod.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        hot = _launch_hot(store, q, pred, 10, "ivf", ivf=ix,
                          nprobe=nprobe, n_valid=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h_s, h_i = _finish_hot(hot)
    check((h_i == sl).all() and (h_s == s).all(),
          "the sync-checked launch's rows != the batch's")
    check(ivf_mod.LAUNCHES == 1 and ivf_mod.COMPACT_LAUNCHES == 1
          and kernel_mod.LAUNCHES == 0,
          "one ivf launch: one compaction, one probe, no rescan")

    # the host union (the reference's contract) beside the device one: per
    # row, the top-nprobe sets; a row may differ only where its nprobe-th
    # and (nprobe+1)-th sims lie within TIE_MARGIN
    probe_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        clusters, n_probed, P = ix.probe(q, nprobe)
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    q_d = torch.from_numpy(q).to(dev)
    cl_d = ix.probe_device(q_d, nprobe)
    # a few small launches each: CUDA events time the host's launch pace,
    # the profiler the device's work
    quant_ms = events_ms(lambda: ix.probe_device(q_d, nprobe), 20)
    quant_dev_ms, _ = device_ms(lambda: ix.probe_device(q_d, nprobe), 20)
    sims = q @ ix.centroids.T
    host_top = np.argpartition(-sims, nprobe - 1, axis=1)[:, :nprobe]
    dev_top = torch.topk(q_d @ ix.device_arrays()["centroids"].T,
                         nprobe, dim=1).indices.cpu().numpy()
    srt = -np.sort(-sims, axis=1)
    near_tie = np.abs(srt[:, nprobe - 1] - srt[:, nprobe]) <= TIE_MARGIN
    differ = np.array([set(a.tolist()) != set(b.tolist())
                       for a, b in zip(host_top, dev_top)])
    check(not (differ & ~near_tie).any(),
          f"device union rows {np.nonzero(differ & ~near_tie)[0]} differ "
          "from the host probe's away from a tie")
    union_equal = bool((cl_d.cpu().numpy() == clusters).all())
    check(union_equal or differ.any(), "unions differ with every row equal")

    # the kernel's inputs exactly as the executor builds them
    d = ix.device_arrays()
    compact = lambda: ivf_mod.compact_candidates_cuda(
        d["members"], d["overflow"], cl_d, N)
    cand, n_live = compact()
    padded = candidate_slots(d["members"], d["overflow"], cl_d)
    check(padded.numel() == P, "candidate vector != the probe's rows")
    c_p, n_p = ivf_mod.compact_candidates_plain(d["members"], d["overflow"],
                                                cl_d, N)
    check(torch.equal(cand, c_p) and torch.equal(n_live, n_p),
          "compaction kernel != its plain version")
    p_valid = int(n_live.item())
    pa = pred.as_array(dev)
    args = (q_d, snap["emb"], meta, cand, pa, 10)
    peak_phase = peak_gb()
    # the slot-indirect kernel writes no (P, D) gathered copy
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s_k, i_k = ivf_mod.ivf_probe_cuda(*args, n_live=n_live)
    sync()
    kernel_extra = torch.cuda.max_memory_allocated() - base
    check(kernel_extra < P * D * 4 // 8,
          f"the probe kernel allocated {kernel_extra} bytes")
    padded_args = (q_d, snap["emb"], meta, padded, pa, 10)
    s_p, i_p = ivf_mod.ivf_probe_plain(*padded_args)
    sync()
    mask = np.broadcast_to(host_mask(meta.cpu().numpy(),
                                     pa.cpu().numpy()[None])[0], (32, N))
    err = compare("ivf-prod", *tnp(s_k, i_k, s_p, i_p), mask,
                  cand_pos=cand_positions(padded.cpu().numpy(), N))
    check(bits_equal((s_k, i_k), ivf_mod.ivf_probe_cuda(*padded_args)),
          "the compacted vector's lists != the padded vector's")
    # the front door's rows equal the direct kernel call's rows
    check((sl == i_k.cpu().numpy()).all() and (s == s_k.cpu().numpy()).all(),
          "run() rows != kernel rows")

    ms = events_ms(lambda: ivf_mod.ivf_probe_cuda(*args, n_live=n_live), 10)
    padded_ms = events_ms(lambda: ivf_mod.ivf_probe_cuda(*padded_args), 10)
    plain_ms = events_ms(lambda: ivf_mod.ivf_probe_plain(*padded_args), 3)
    compact_ms = events_ms(compact, 20)
    compact_dev_ms, _ = device_ms(compact, 20)
    compact_plain_ms = events_ms(lambda: ivf_mod.compact_candidates_plain(
        d["members"], d["overflow"], cl_d, N), 3)
    safe = padded.clamp(min=0).long()
    live_c = (padded >= 0) & keep[safe]

    def yardstick():
        sc = torch.matmul(q_d, snap["emb"][safe].T)
        return torch.topk(torch.where(live_c, sc, -3.4e38), 10, dim=1)

    yard_ms = events_ms(yardstick, 3)
    gids = torch.zeros(32, dtype=torch.int32, device=dev)
    exact = lambda: kernel_mod.arena_scan_cuda(q_d, snap["emb"], meta, gids,
                                               pa[None], 10)
    exact_ms = events_ms(exact, 3)
    ex_i = exact()[1].cpu().numpy()
    recall = float(np.mean([len(set(sl[r].tolist()) & set(ex_i[r].tolist()))
                            / 10 for r in range(32)]))
    B, k = 32, 10
    nbytes = p_valid * (4 * D + 16) + P * 4 + B * D * 4 + 16 + B * k * 8
    flops = 2 * B * p_valid * D
    bound_ms = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / FP32_FLOPS \
        else "operations"
    # the same bound had every one of the P rows, padding included, been
    # read and scored (what the parent design's schedule computed)
    bound_ms_all_rows = max((P * (4 * D + 16 + 4) + B * D * 4 + B * k * 8)
                            / HBM_BPS, 2 * B * P * D / FP32_FLOPS) * 1e3
    # the compaction: the probed clusters' member rows, the overflow tail
    # and the cluster list read once, the vector and its count written
    c_bytes = 4 * (P + cl_d.numel()) + 4 * P + 4
    compact_bound_ms = c_bytes / HBM_BPS * 1e3
    emit("ivf_prod", seconds=time.perf_counter() - t_phase, rows=N, dim=D,
         batch=B, k=k, clusters=ix.n_clusters, nprobe=nprobe,
         cap=ix.cluster_cap, overflow=len(ix.overflow),
         probed_clusters=n_probed, P=P, P_live=p_valid,
         live_tiles=-(-p_valid // kernel_mod.TILE_ROWS),
         tiles=-(-P // kernel_mod.TILE_ROWS), P_over_N=P / N,
         build_s=build_s, kmeans_s=spent["kmeans"], assign_s=spent["assign"],
         build_host_s=build_s - spent["kmeans"] - spent["assign"],
         slot_map_s=slot_map_s, batch_ms_median=statistics.median(lat),
         batch_ms=lat, idle_share=profile["idle_share"],
         trace_lost=profile["trace_lost"],
         probe_host_ms_median=statistics.median(probe_ms),
         quantizer_events_ms=quant_ms, quantizer_device_ms=quant_dev_ms,
         union_equal=union_equal,
         union_rows_differing=int(differ.sum()),
         union_rows_near_tie=int(near_tie.sum()), tie_margin=TIE_MARGIN,
         sync_debug="no sync in the ivf launch", launches=launches,
         kernel_ms=ms, padded_vector_kernel_ms=padded_ms, plain_ms=plain_ms,
         compact_events_ms=compact_ms, compact_device_ms=compact_dev_ms,
         compact_plain_ms=compact_plain_ms,
         compact_bound_ms=compact_bound_ms, yardstick_ms=yard_ms,
         exact_kernel_ms=exact_ms, bound_ms=bound_ms, bound_by=bound_by,
         bound_bytes=nbytes, bound_ms_all_rows=bound_ms_all_rows,
         recall_at_10=recall,
         anchor_in_top10=float(np.mean([anchors[r] in sl[r].tolist()
                                        for r in range(32)])),
         profile=profile, peak_mem_gb=peak_phase,
         kernel_extra_mem_gb=kernel_extra / 1e9, max_abs_err=err)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                compact=dict(launches=compact_launches,
                             ms=compact_ms if compact_dev_ms is None
                             else compact_dev_ms,
                             plain_ms=compact_plain_ms,
                             bound_ms=compact_bound_ms, bound_by="bytes",
                             max_abs_err=0.0))


def alloc_bytes(fn):
    """Device memory a call allocates beyond what is live before it (its
    outputs and scratch: for the scans, the candidate buffers)."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    sync()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return extra


def phase_paged_prod(dev, prod, hprod, ptxas=()):
    """The prod arena through the front door under PlannerConfig(
    paged_min_rows=2^20): the dense, wsum and rrf batches of phases prod
    and hybrid_prod recompiled, each run 6 times as one paged launch equal
    bit for bit to the resident rows of this run; then the paged kernel
    alone at several page sizes beside the resident kernel."""
    from repro_torch.api.planner import PlannerConfig
    from repro_torch.kernels.arena_scan.stages import ScanSpec

    t_phase = time.perf_counter()
    db = prod["db"]
    N = db.log.snapshot()["emb"].shape[0]
    T = db.lex.cfg.doc_terms
    batches = {"dense": prod["plans"], "wsum": hprod["plans"]["wsum"],
               "rrf": hprod["plans"]["rrf"]}
    resident = {m: db.execute(ps, use_cache=False)
                for m, ps in batches.items()}
    resident_cfg = db.planner_cfg
    db.planner_cfg = cfg = PlannerConfig(paged_min_rows=1 << 20)
    P = cfg.page_rows
    try:
        paged = {m: [db.compile(p.logical) for p in ps]
                 for m, ps in batches.items()}
        for m, ps in paged.items():
            check(all(p.page_rows == P and p.engine == q.engine
                      for p, q in zip(ps, batches[m])),
                  f"{m}: plans not stamped paged")
            check("paging:" in ps[0].explain(), f"{m}: no paging: line")
        paging_line = next(ln.strip() for ln in
                           paged["dense"][0].explain().splitlines()
                           if "paging:" in ln)
        n_batches = 6
        before = dataclasses.replace(db.stats)
        kernel_mod.PAGED_LAUNCHES = kernel_mod.LAUNCHES = 0
        hyb_mod.LAUNCHES = 0
        lat = {}
        for m, ps in paged.items():
            lat[m] = []
            for _ in range(n_batches):
                t0 = time.perf_counter()
                s, sl, _ = db.execute(ps, use_cache=False)
                lat[m].append((time.perf_counter() - t0) * 1e3)
                rs, rsl, _ = resident[m]
                check((s.view(np.int32) == rs.view(np.int32)).all()
                      and (sl == rsl).all(),
                      f"{m}: paged rows != resident rows")
        launches = kernel_mod.PAGED_LAUNCHES
        st = db.stats
        check(launches == 3 * n_batches,
              f"{launches} paged launches for {3 * n_batches} batches")
        check(kernel_mod.LAUNCHES == 0, "a paged batch ran the resident "
              "dense kernel")
        check(st.paged_scans - before.paged_scans == 3 * n_batches
              and st.fused_scans - before.fused_scans == 3 * n_batches,
              "paged_scans != one per fused scan")
        profiles = {m: profile_batch(lambda ps=ps: db.execute(
            ps, use_cache=False), PAGED_TAGS) for m, ps in paged.items()}
    finally:
        db.planner_cfg = resident_cfg

    # the kernel alone at several page sizes, on the executor's inputs
    dargs, hargs = prod["args"], hprod["args"]
    q, emb, meta, gids, preds, k = dargs
    B, G = q.shape[0], preds.shape[0]
    QT = hargs[7].shape[1]
    calls = {
        "dense": lambda p: kernel_mod.arena_scan_cuda(*dargs, page_rows=p),
        "wsum": lambda p: hyb_mod.hybrid_score_cuda(*hargs, mode="wsum",
                                                    page_rows=p),
        "rrf": lambda p: hyb_mod.hybrid_score_cuda(*hargs, mode="rrf",
                                                   page_rows=p),
    }
    plains = {
        "dense": lambda p: kernel_mod.arena_scan_scan_ref(*dargs, p),
        "wsum": lambda p: hyb_mod.hybrid_score_plain(*hargs, mode="wsum",
                                                     page_rows=p),
        "rrf": lambda p: hyb_mod.hybrid_score_plain(*hargs, mode="rrf",
                                                    page_rows=p),
    }
    specs = {"dense": ScanSpec(), "wsum": ScanSpec(score="fused"),
             "rrf": ScanSpec(score="both")}
    bounds = {"dense": prod["bound_ms"], "wsum": hprod["bound_ms"],
              "rrf": hprod["bound_ms"]}
    sweep = {}
    for m, call in calls.items():
        row = {"resident_ms": events_ms(lambda: call(None), 10),
               "resident_device_ms": device_ms(lambda: call(None), 5)[0],
               "resident_info": kernel_mod.scan_info(specs[m], B, N, G, k,
                                                     None, QT=QT),
               "resident_alloc_bytes": alloc_bytes(lambda: call(None)),
               "resident_profile_ms": profile_batch(
                   lambda: call(None), SCAN_TAGS)["split_ms"],
               "bound_ms": bounds[m], "pages": {}}
        for p in PAGED_PROD_P:
            info = kernel_mod.scan_info(specs[m], B, N, G, k, p, QT=QT)
            cell = {"ms": events_ms(lambda: call(p), 10),
                    "device_ms": device_ms(lambda: call(p), 5)[0],
                    "alloc_bytes": alloc_bytes(lambda: call(p)),
                    "profile_ms": profile_batch(lambda: call(p),
                                                PAGED_TAGS)["split_ms"],
                    **info}
            if m == "dense" or p == P:
                cell["plain_ms"] = events_ms(lambda: plains[m](p),
                                             2 if m == "dense" else 1)
            row["pages"][p] = cell
        row["resident_ms_after"] = events_ms(lambda: call(None), 10)
        sweep[m] = row
    blocks = sweep["dense"]["pages"][P]["blocks_per_sm"]
    check(blocks >= 2, f"paged dense kernel: {blocks} block(s) an SM, "
          "expected >= 2")
    # the paged kernel against its plain version at the planner's page
    s_k, i_k = calls["dense"](P)
    s_p, i_p = plains["dense"](P)
    sync()
    mask = host_mask(meta.cpu().numpy(), preds.cpu().numpy())[gids.cpu()
                                                              .numpy()]
    err = compare("paged-prod", *tnp(s_k, i_k, s_p, i_p), mask)
    emit("paged_prod", seconds=time.perf_counter() - t_phase, rows=N,
         batch=B, groups=G, k=k, lanes=T, qt_bucket=QT, page_rows=P,
         paging_line=paging_line, launches=launches,
         paged_scans=3 * n_batches,
         batch_ms_median={m: statistics.median(v) for m, v in lat.items()},
         batch_ms=lat, profile=profiles, kernel_sweep=sweep,
         dense_scan_ptxas=list(ptxas), max_abs_err=err,
         front_door_rows="bit-identical to resident")
    best = sweep["dense"]["pages"][P]
    return dict(launches=launches, ms=best["ms"], plain_ms=best["plain_ms"],
                bound_ms=prod["bound_ms"], bound_by=prod["bound_by"],
                max_abs_err=err)

class LaunchLog:
    """Stands in for ``db.launch`` while a scheduler drives ``db``: records
    the plans of every launched batch (the plans that ran, degraded ones
    included), and runs the first ``no_sync`` launches whose plans are all
    hot-only under ``torch.cuda.set_sync_debug_mode("error")``, so a host
    sync inside a launch fails the run. `close` puts the method back."""

    def __init__(self, db, no_sync=0):
        self.db, self.launch, self.no_sync = db, db.launch, no_sync
        self.batches, self.checked = [], 0
        db.launch = self

    def __call__(self, plans, **kw):
        self.batches.append(list(plans))
        if self.checked < self.no_sync and all(p.route == "hot"
                                               for p in plans):
            self.checked += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return self.launch(plans, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return self.launch(plans, **kw)

    def close(self):
        del self.db.launch

    def batch_of(self, plan):
        """The launched plans of ``plan``'s group in the batch that ran it,
        in batch order (its own rows and those it was probed with)."""
        for batch in self.batches:
            if any(p is plan for p in batch):
                return [p for p in batch if p.group_key == plan.group_key]
        raise AssertionError("a served plan was never launched")


def serve_leaks(results, meta):
    """Returned slots that fail their request's tenant / recency /
    category / ACL clause, on the host metadata ``meta`` (N, 4)."""
    leaks = 0
    for res in results:
        real = res.slots[res.slots >= 0]
        if real.size:
            pred = res.request.plan.pred.as_array().numpy()[None]
            leaks += int((~host_mask(meta[real], pred)[0]).sum())
    return leaks


def serve_report(out, wl, kernels, plain_cuda_calls):
    """One scenario run's printed numbers (the reference bench's report,
    trimmed to what the phase prints), with the gates' inputs."""
    rep = out.report()
    hist, ctr = rep["histograms"], rep["counters"]
    pick = lambda name: {p: hist.get(name, {}).get(p)
                         for p in ("count", "p50", "p99", "max")}
    return {
        "offered": out.offered, "admitted": out.admitted, "shed": out.shed,
        "completed": rep["completed"], "wall_s": rep["wall_s"],
        "offered_rps": rep["offered_rps"], "rate_rps": wl.rate_rps,
        "throughput_rps": rep["throughput_rps"],
        "goodput_rps": rep["goodput_rps"], "shed_rate": rep["shed_rate"],
        "deadline_met_rate": rep["deadline_met_rate"],
        "e2e_ms": pick("e2e_ms"), "queue_wait_ms": pick("queue_wait_ms"),
        "service_ms": pick("service_ms"), "plan_ms": pick("plan_ms"),
        "write_ms": pick("write_ms"),
        "served": dict(Counter(r.served for r in out.results)),
        "degradations": {k.split("=")[1].rstrip("}"): v
                         for k, v in ctr.items()
                         if k.startswith("degradations{")},
        "degraded_results": rep["degraded"], "failed": rep["failed"],
        "stale_serves": rep["stale_serves"],
        "max_stale_age_s": rep["max_stale_age_s"], "writes": rep["writes"],
        "mixed_state_observed": rep["mixed_state_observed"],
        "launches": kernels, "plain_calls_on_cuda": plain_cuda_calls}


def serve_accounting(name, out):
    """offered = admitted + shed; each admitted request served exactly
    once, fresh, from the cache or stale; none failed."""
    ids = [r.request.req_id for r in out.results]
    check(out.offered == out.admitted + out.shed,
          f"{name}: offered {out.offered} != admitted {out.admitted} + "
          f"shed {out.shed}")
    check(len(ids) == out.admitted and len(set(ids)) == len(ids),
          f"{name}: {len(ids)} results ({len(set(ids))} requests) for "
          f"{out.admitted} admitted")
    served = Counter(r.served for r in out.results)
    check(set(served) <= {"fresh", "cache", "stale"} and not
          served.get("failed"), f"{name}: served classes {dict(served)}")


def serve_identity(name, db, results, log=None):
    """Each result equals, bit for bit, ``db.execute`` of the plan that
    ran (``use_cache=False``): run alone, or (``log`` given) with the
    plans of its group in the batch that ran it -- an ivf probe scans the
    union of its group's probed clusters. Distinct plans run once.
    Returns (results checked, plans run, plans run with others)."""
    runs, shared = {}, 0
    for res in results:
        plan = res.request.plan
        group = log.batch_of(plan) if log is not None else [plan]
        key = tuple(id(p) for p in group) if len(group) > 1 else (
            plan.group_key, plan.logical.q.tobytes(),
            plan.logical.match_terms, plan.degraded)
        if key not in runs:
            shared += len(group) > 1
            s, sl, _ = db.execute(group, use_cache=False)
            runs[key] = {id(p): (s[i:i + 1], sl[i:i + 1])
                         for i, p in enumerate(group)}
        s, sl = runs[key][id(plan)] if len(group) > 1 else next(
            iter(runs[key].values()))
        what = (f"{name}: request {res.request.req_id} ({plan.engine}, "
                f"{plan.degraded})")
        check((res.slots == sl).all(),
              f"{what}: slots != direct execution of its plan")
        check((res.scores.view(np.int32) == s.view(np.int32)).all(),
              f"{what}: scores != direct execution of its plan, bit for "
              "bit")
    return len(results), len(runs), shared


def serve_plain(name, db, results, meta, lex):
    """Hold results to a plain top-k written here: q . e on the card
    (TF32 off), plus BM25 over the lanes for a match() plan, NEG_INF off
    the rows ``host_mask`` keeps, one stable descending sort. Returns the
    max abs score error."""
    from repro_torch.kernels.hybrid_score.ref import qidf_of
    emb = db.log.snapshot()["emb"]
    errs, masks = [], {}
    for res in results:
        plan = res.request.plan
        k = plan.logical.k
        q = torch.from_numpy(np.atleast_2d(plan.logical.q)).to(DEV)
        sc = q @ emb.T
        if plan.engine == "hybrid":
            qt = torch.tensor([plan.logical.match_terms], dtype=torch.int32,
                              device=DEV)
            sc = sc + plain_bm25(lex["terms"], lex["lexnorm"], qt,
                                 qidf_of(lex["idf"], qt))
        pa = plan.pred.as_array().numpy()[None]
        keep = masks.get(pa.tobytes())
        if keep is None:
            keep = masks[pa.tobytes()] = host_mask(meta, pa)
        masked = torch.where(torch.from_numpy(keep).to(DEV), sc, NEG)
        top_s, top_i = torch.sort(masked, dim=1, descending=True,
                                  stable=True)
        s_p, i_p = top_s[:, :k].cpu().numpy(), top_i[:, :k].int()
        i_p = torch.where(top_s[:, :k] > NEG, i_p, -1).cpu().numpy()
        errs.append(compare(f"{name}-{res.request.req_id}", res.scores,
                            res.slots, s_p, i_p, keep,
                            scores_full=masked.cpu().numpy()))
    return max(errs)


def serve_capacity(db, wl, pool, n):
    """The reference bench's capacity probe, on the card: ``n`` query
    events all due at t = 0 through `run_scenario` with admission and the
    cache off, once to warm up and once measured; then a saturation run
    at that rate for 0.8 s, whose throughput is the sustained rate."""
    from repro_torch.serving.load import make_trace, run_scenario
    from repro_torch.serving.scheduler import SchedulerConfig
    events = [e for e in make_trace(dataclasses.replace(
        wl, duration_s=4 * n / max(wl.rate_rps, 1), write_rate_rps=0.0),
        term_pool=pool) if e.kind == "query"][:n]
    for ev in events:
        ev.t = 0.0
    cfg = SchedulerConfig(admission=False, max_batch=SERVE_MAX_BATCH,
                          use_cache=False)
    run_scenario(db, wl, cfg, events=list(events))
    probe = run_scenario(db, wl, cfg, events=list(events))
    probe_rps = len(probe.results) / probe.wall_s
    sat = run_scenario(db, dataclasses.replace(wl, rate_rps=probe_rps,
                                               duration_s=0.8),
                       cfg, term_pool=pool)
    service_ms = probe.wall_s / max(len(probe.results), 1) * 1e3
    slo_ms = float(np.clip(50.0 * service_ms, 25.0, 500.0))
    cap_rps = sat.report()["throughput_rps"]
    return {"probe_rps": probe_rps, "service_ms_per_req": service_ms,
            "cap_rps": cap_rps, "slo_ms": slo_ms,
            "max_queue": max(8, int(cap_rps * slo_ms / 1e3 * 0.5))}


def phase_serve_prod(dev, db, now_ts, duration_s=3.0, probe_n=256,
                     sync_steps=8, burst_identity=64, plain_samples=32):
    """The serving layer on the prod arena (after paged_prod, with the
    IVF index of ivf_prod): open-loop Poisson traffic through the port's
    `load.run_scenario` and `Scheduler` on the wall clock, 20 Zipfian
    tenants, k = 10, batches of up to 32, a quarter of the queries with a
    match() clause. Mix A pins the exact kernel engine ("cuda"), mix B the
    IVF probe ("ivf"). Three scenarios: steady (A, half its capacity,
    cache on), burst (B, a 4.5x flash crowd, cache off, through the FIFO
    baseline and through the scheduler on one trace) and writes (A, 1.2x
    capacity, RagDB.update of 8 docs 4 times a second, stale serves within
    0.2 s)."""
    from repro_torch.api.ragdb import ResultCache
    from repro_torch.core.tenancy import Principal
    from repro_torch.kernels.arena_scan import stages
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.serving.load import (WorkloadConfig, make_trace,
                                          run_scenario)
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               ServeRequest)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    snap = db.log.snapshot()
    N, D = snap["emb"].shape
    epoch0, index0 = db.index.epoch, db.index
    meta = _packed_meta(snap["tenant"], snap["updated_at"], snap["category"],
                        snap["acl"]).cpu().numpy()
    del snap
    # the term pool: 64 tuples of 2-4 terms from live rows' lanes
    rng = np.random.default_rng(SEED + 21)
    lanes = db.lex.snapshot()["terms"][torch.from_numpy(
        rng.integers(0, N, 1024)).to(dev)].cpu().numpy()
    pool = []
    for lane in lanes:
        live = np.unique(lane[lane >= 0])
        if len(live) >= 2 and len(pool) < 64:
            pool.append(tuple(int(t) for t in rng.choice(
                live, min(len(live), int(rng.integers(2, 5))),
                replace=False)))
    check(len(pool) == 64, f"term pool of {len(pool)} tuples")
    base = dict(duration_s=duration_s, n_tenants=20, zipf_s=1.1,
                query_pool=32, k=10, dim=D, match_fraction=0.25)
    mixes = {"A": WorkloadConfig(engine="cuda", seed=SEED + 31, **base),
             "B": WorkloadConfig(engine="ivf", seed=SEED + 32, **base)}
    caps = {m: serve_capacity(db, wl, pool, probe_n)
            for m, wl in mixes.items()}

    plain_on_card = PlainOnCard(stages.dense_scores)
    stages.dense_scores = plain_on_card
    runs, outs = {}, {}

    def scenario(name, wl, cfg, events, no_sync=0, **kw):
        db.result_cache = ResultCache(256)      # every run starts cold
        plain_on_card.cuda_calls = 0
        kernel_mod.LAUNCHES = hyb_mod.LAUNCHES = 0
        ivf_mod.LAUNCHES = ivf_mod.COMPACT_LAUNCHES = 0
        log = LaunchLog(db, no_sync)
        try:
            out = run_scenario(db, wl, cfg, events=list(events), **kw)
        finally:
            log.close()
        serve_accounting(name, out)
        launches = {"arena_scan": kernel_mod.LAUNCHES,
                    "hybrid_score": hyb_mod.LAUNCHES,
                    "ivf_probe": ivf_mod.LAUNCHES,
                    "ivf_compact": ivf_mod.COMPACT_LAUNCHES}
        runs[name] = serve_report(out, wl, launches,
                                  plain_on_card.cuda_calls)
        check(plain_on_card.cuda_calls == 0,
              f"{name}: a plain version ran on CUDA tensors")
        runs[name]["no_sync_launches"] = log.checked
        outs[name] = out
        return out, log

    try:
        # steady: mix A at half its capacity, cache on
        cap = caps["A"]
        sched_a = SchedulerConfig(slo_ms=cap["slo_ms"],
                                  max_queue=cap["max_queue"],
                                  max_batch=SERVE_MAX_BATCH,
                                  degrade_pressure=0.3, stale_within_s=0.2)
        wl = dataclasses.replace(mixes["A"], rate_rps=0.5 * cap["cap_rps"])
        steady_events = make_trace(wl, term_pool=pool)
        out, log = scenario("steady", wl, sched_a, steady_events,
                            no_sync=sync_steps)
        check(log.checked == sync_steps, f"steady: {log.checked} launches "
              f"under the sync check, not {sync_steps}")
        ks = runs["steady"]["launches"]
        check(ks["arena_scan"] > 0 and ks["hybrid_score"] > 0,
              f"steady: kernel launches {ks}")
        ident = serve_identity("steady", db, out.results)
        sample = np.random.default_rng(SEED + 22).choice(
            len(out.results), min(plain_samples, len(out.results)),
            replace=False)
        plain_err = serve_plain("steady-plain", db,
                                [out.results[i] for i in sample], meta,
                                db.lex.snapshot())
        runs["steady"].update(identity={"results": ident[0],
                                        "plans_run": ident[1]},
                              plain_samples=len(sample),
                              plain_max_abs_err=plain_err)
        # 10 consecutive scheduler steps of the steady mix at full batches
        # (cache off, so every step launches), profiled
        sess, reqs = {}, []
        for ev in [e for e in steady_events if e.kind == "query"][
                :10 * SERVE_MAX_BATCH]:
            s_ = sess.setdefault(ev.tenant, db.session(
                Principal(tenant_id=ev.tenant, group_bits=0xFFFFFFFF)))
            b = s_.search(ev.q, normalize=False).limit(wl.k)
            b = (b.match(list(ev.terms)) if ev.terms is not None
                 else b.using(wl.engine))
            reqs.append(b.plan())
        steps_sched = Scheduler(db, dataclasses.replace(
            sched_a, admission=False, use_cache=False))

        def ten_steps():
            for i, p in enumerate(reqs):
                steps_sched.offer(ServeRequest(plan=p, arrival_t=0.0,
                                               req_id=i))
            done = []
            for _ in range(10):
                done += steps_sched.step()
            done += steps_sched.flush()
            check(len(done) == len(reqs), "ten steps left requests")

        steady_profile = profile_batch(ten_steps, SCAN_TAGS)

        # burst: mix B, a flash crowd, cache off, the FIFO baseline and the
        # scheduler on one trace
        cap = caps["B"]
        wl = dataclasses.replace(mixes["B"], rate_rps=0.45 * cap["cap_rps"],
                                 burst_x=4.5, burst_start=0.45,
                                 burst_len=0.1)
        burst_events = make_trace(wl, term_pool=pool)
        fifo = SchedulerConfig(slo_ms=cap["slo_ms"], admission=False,
                               max_batch=SERVE_MAX_BATCH, use_cache=False)
        sched_b = SchedulerConfig(slo_ms=cap["slo_ms"],
                                  max_queue=cap["max_queue"],
                                  max_batch=SERVE_MAX_BATCH,
                                  degrade_pressure=0.3, stale_within_s=0.2,
                                  use_cache=False)
        scenario("burst_fifo", wl, fifo, burst_events)
        out, log = scenario("burst_sched", wl, sched_b, burst_events,
                            no_sync=sync_steps)
        for name in ("burst_fifo", "burst_sched"):
            ks = runs[name]["launches"]
            check(ks["ivf_probe"] > 0 and ks["ivf_compact"] > 0
                  and ks["hybrid_score"] > 0, f"{name}: kernel launches {ks}")
        degraded = [r for r in out.results if r.degraded][:burst_identity]
        ident = serve_identity("burst", db, degraded, log)
        runs["burst_sched"]["identity"] = {
            "results": ident[0], "plans_run": ident[1],
            "run_with_their_group": ident[2]}
        base_e2e = runs["burst_fifo"]["e2e_ms"]
        burst_vs = {
            "slo_ms": cap["slo_ms"],
            "fifo_p99_over_p50": base_e2e["p99"] / base_e2e["p50"],
            "fifo_p99_ms": base_e2e["p99"],
            "sched_p99_ms": runs["burst_sched"]["e2e_ms"]["p99"],
            "sched_goodput_over_fifo_throughput":
                runs["burst_sched"]["goodput_rps"]
                / runs["burst_fifo"]["throughput_rps"]}

        # writes: mix A at 1.2x capacity, 4 writes a second of 8 docs
        cap = caps["A"]
        wl = dataclasses.replace(mixes["A"], rate_rps=1.2 * cap["cap_rps"],
                                 write_rate_rps=4.0, write_batch=8)
        write_events = make_trace(wl, term_pool=pool)
        doc_ids = np.arange(N)
        out, _ = scenario("writes", wl, sched_a, write_events,
                          write_doc_ids=doc_ids, now_ts=now_ts)
        n_writes = sum(e.kind == "write" for e in write_events)
        check(out.writes == n_writes > 0, f"writes: {out.writes} of "
              f"{n_writes} write events ran")
        check(out.mixed_state_observed == 0, "writes: a freshness probe saw "
              "a mixed state")
        ages = [r.stale_age_s for r in out.results if r.served == "stale"]
        check(all(a <= 0.2 for a in ages),
              f"writes: stale age {max(ages, default=0.0)} past the 0.2 s "
              "bound")
        check(db.index is index0 and db.index.epoch == epoch0,
              "writes: the IVF index was rebuilt inside the scenario")
        ks = runs["writes"]["launches"]
        check(ks["arena_scan"] > 0, f"writes: kernel launches {ks}")
        # the last embedding each written doc got (the harness draws them
        # from seed + 1 in event order), then the next fresh query aimed
        # at a written doc returns it from that embedding
        wrng = np.random.default_rng(wl.seed + 1)
        final = {}
        for ev in write_events:
            if ev.kind == "write":
                ids = np.unique(doc_ids[ev.doc_idx % len(doc_ids)])
                emb = wrng.standard_normal((len(ids), D)).astype(np.float32)
                final.update(zip(ids.tolist(), emb))
        fresh = []
        probe_sched = Scheduler(db, SchedulerConfig(slo_ms=1e9))
        for doc in sorted(final)[:4]:
            slot = db.log.slot_of(doc)
            v = final[doc] / np.linalg.norm(final[doc])
            plan = (db.session(Principal(tenant_id=int(meta[slot, 0]),
                                         group_bits=0xFFFFFFFF))
                    .search(v, normalize=False).limit(10).using("cuda")
                    .plan())
            probe_sched.offer(ServeRequest(plan=plan, arrival_t=0.0))
            (res,) = probe_sched.run_until_idle()
            check(res.served == "fresh" and int(res.slots[0, 0]) == slot
                  and abs(float(res.scores[0, 0]) - 1.0) <= 1e-5,
                  f"writes: doc {doc} (slot {slot}) not returned from its "
                  f"new embedding: {res.served}, {res.slots[0, :3]}, "
                  f"{res.scores[0, :3]}")
            fresh.append(doc)
        runs["writes"]["fresh_after_write_docs"] = fresh
    finally:
        stages.dense_scores = plain_on_card.fn
        db.result_cache = ResultCache(256)

    # isolation, every run: the tenant and ACL columns never change under
    # a write, and the written rows' new timestamps only rise
    leaks = {name: serve_leaks(o.results, meta) for name, o in outs.items()}
    check(not any(leaks.values()), f"leaked slots {leaks}")
    emit("serve_prod", card=CARD, seconds=time.perf_counter() - t_phase,
         rows=N, dim=D, lanes=db.lex.cfg.doc_terms,
         ivf_clusters=db.index.n_clusters, k=10, max_batch=SERVE_MAX_BATCH,
         tenants=20, zipf_s=1.1, query_pool=32, term_pool=len(pool),
         match_fraction=0.25, duration_s=duration_s, capacity=caps,
         runs=runs, burst=burst_vs, leaked_slots=leaks,
         steady_ten_steps_profile=steady_profile,
         sync_debug="no sync in a hot-only launch",
         peak_mem_gb=peak_gb())


NEG = -3.4028234663852886e38    # float32's lowest: NEG_INF of the port


def plain_bm25(terms, lexnorm, qterms, qidf):
    """(B, N) BM25 over one tier's lanes, written here: lanes outer, query
    terms inner, each lane's product added only where its weight is not
    zero (the order every engine of the port uses)."""
    out = torch.zeros((qterms.shape[0], terms.shape[0]), dtype=torch.float32,
                      device=terms.device)
    for t in range(terms.shape[1]):
        lane = terms[:, t][None, :]
        w = torch.zeros_like(out)
        for j in range(qterms.shape[1]):
            w = w + torch.where(lane == qterms[:, j][:, None],
                                qidf[:, j][:, None], 0.0)
        out = out + torch.where(w != 0.0, w * lexnorm[:, t][None, :], 0.0)
    return out


def union_topk(sig_hot, sig_warm, k):
    """The plain global top-k over the union of two tiers' masked (B, N)
    signals: one stable descending sort of [hot | warm], so ties go to the
    hot tier, then to the lower slot. Numpy (scores, slots, tiers)."""
    s, pos = torch.sort(torch.cat([sig_hot, sig_warm], 1), dim=1,
                        descending=True, stable=True)
    s, pos = s[:, :k], pos[:, :k]
    nh = sig_hot.shape[1]
    tier = (pos >= nh).int()
    slot = torch.where(pos >= nh, pos - nh, pos).int()
    live = s > NEG
    return (s.cpu().numpy(), torch.where(live, slot, -1).cpu().numpy(),
            torch.where(live, tier, 0).cpu().numpy())


def tiered_compare(name, got, want, sigs, keeps):
    """Hold a tiered result (scores, slots, tiers) (B, k) numpy to the
    plain union answer: scores within rtol = atol = 1e-5, slot -1 iff
    NEG_INF, no (slot, tier) twice, every returned row passes its group's
    predicate in its tier (``keeps``: [hot, warm] (N,) bool), its score is
    the plain signal's there (``sigs``), and the (slot, tier) sets differ
    only inside a run of scores tied at the k-th place. Returns the max abs
    score error."""
    s_g, i_g, t_g = got
    s_w, i_w, t_w = want
    check(np.isfinite(s_g).all(), f"{name}: non-finite scores")
    check(np.allclose(s_g, s_w, rtol=TOL, atol=TOL),
          f"{name}: scores differ beyond {TOL}")
    check(((s_g == NEG) == (i_g == -1)).all(), f"{name}: slot -1 iff NEG_INF")
    real = i_g >= 0
    for t in (0, 1):
        sel = real & (t_g == t)
        b, sl = (torch.from_numpy(a.astype(np.int64)).to(DEV)
                 for a in (np.nonzero(sel)[0], i_g[sel]))
        check(bool(keeps[t][sl].all()), f"{name}: a row of tier {t} "
              "fails its group's predicate")
        check(np.allclose(s_g[sel], sigs[t][b, sl].cpu().numpy(), rtol=TOL,
                          atol=TOL), f"{name}: tier {t} slot/score pairing")
    for r in range(s_g.shape[0]):
        kg = [(int(t), int(s)) for s, t in zip(i_g[r], t_g[r]) if s >= 0]
        kw = [(int(t), int(s)) for s, t in zip(i_w[r], t_w[r]) if s >= 0]
        check(len(set(kg)) == len(kg), f"{name}: row {r} repeats a row")
        check(len(kg) == len(kw), f"{name}: row {r} fill differs")
        if not kw:
            continue
        kth = s_w[r][len(kw) - 1]
        for t, sl in set(kg) ^ set(kw):
            sc = float(sigs[t][r, sl])
            check(abs(sc - kth) <= TOL * (1 + abs(kth)),
                  f"{name}: row {r} ({sl}, tier {t}) differs away from a "
                  "k-th place tie")
    return float(np.max(np.abs(s_g - s_w))) if s_g.size else 0.0


def plain_rrf(d_keys, l_keys, k, c):
    """Reciprocal-rank fusion of two per-signal key lists, written here:
    score = sum of 1 / (c + rank) over the lists holding the key; ties go
    to the dense list, then to the better rank. [(score, key)] of k."""
    score, pos = {}, {}
    for r, key in enumerate(d_keys):
        score[key] = score.get(key, 0.0) + 1.0 / (c + r + 1)
        pos.setdefault(key, r)
    for r, key in enumerate(l_keys):
        score[key] = score.get(key, 0.0) + 1.0 / (c + r + 1)
        pos.setdefault(key, len(d_keys) + r)
    return sorted(((s, key) for key, s in score.items()),
                  key=lambda e: (-e[0], pos[e[1]]))[:k]


def tiered_hot_kernel_ms(db, hot, by_kind, qs, mts, order, dev):
    """The tiered cell's hot kernels alone (CUDA events) on the tail
    batch's inputs, the hot arena one allocation: dense, wsum, rrf."""
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    meta = _packed_meta(hot["tenant"], hot["updated_at"], hot["category"],
                        hot["acl"])
    qo = torch.from_numpy(np.stack([qs[r] for r in order])).to(dev)
    gids = torch.tensor([g for g in range(4) for _ in range(8)],
                        dtype=torch.int32, device=dev)
    preds = torch.stack([by_kind["tail"][g].pred.as_array(dev)
                         for g in range(4)])
    lx = db.lex.snapshot()
    qt_o = torch.full((32, 4), -1, dtype=torch.int32, device=dev)
    qt_o[:, :3] = torch.tensor([mts[r] for r in order], dtype=torch.int32,
                               device=dev)
    hargs = (qo, hot["emb"], meta, lx["terms"], lx["lexnorm"], gids, preds,
             qt_o, torch.where(qt_o >= 0, lx["idf"][qt_o.clamp(min=0).long()],
                               0.0), 10)
    return {
        "dense": events_ms(lambda: kernel_mod.arena_scan_cuda(
            qo, hot["emb"], meta, gids, preds, 10), 10),
        "wsum": events_ms(lambda: hyb_mod.hybrid_score_cuda(
            *hargs, mode="wsum"), 10),
        "rrf": events_ms(lambda: hyb_mod.hybrid_score_cuda(
            *hargs, mode="rrf"), 10)}


def phase_tiered_prod(dev, n_rows=None, dim=None, chunk=1 << 20,
                      hot_cap=1 << 22, warm_cap=6_400_000, n_batches=6,
                      n_lex_batches=3, mesh=None, phase="tiered_prod"):
    """The three-tier deployment (phase 13). ``mesh`` (a mesh over several
    cards, `regions`) holds the hot arena in its regions, one allocation a
    card, the warm tier on ``dev``, the controller; the phase's gates are
    the same, each hot unit launching once a card, and it returns what it
    emits (as ``phase``)."""
    from repro_torch.api import RagDB
    from repro_torch.api.executor import merge_tiers
    from repro_torch.api.planner import PlannerConfig
    from repro_torch.core.store import (ALLOCS, StoreConfig, allocations,
                                        n_rows as rows_of)
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, device_corpus
    from repro_torch.index.lexical import LexicalConfig
    from repro_torch.index.lexical.arena import allocations as lex_views

    t_phase = time.perf_counter()
    n_rows, dim = n_rows or prod_cut()[0], dim or prod_cut()[1]
    ccfg = CorpusConfig(n_docs=n_rows, dim=dim, n_tenants=20, n_categories=5)
    window = ccfg.days_span * DAY_S // 4
    lcfg = LexicalConfig()
    db = RagDB(StoreConfig(capacity=hot_cap, dim=dim),
               warm_cfg=StoreConfig(capacity=warm_cap, dim=dim),
               hot_window_s=window, now_ts=ccfg.now_ts, lexical_cfg=lcfg,
               mesh=mesh, device=dev)
    # the planner's own engine for the dense plans: over a mesh, with a
    # hot arena of shard_min_rows, the sharded one (each group's scan one
    # launch a region, on the region's card), else the exact one (one
    # fused launch a card)
    sharded = (mesh is not None
               and hot_cap >= PlannerConfig().shard_min_rows)
    dense_eng = "sharded" if sharded else "cuda"
    warm = db.router.warm
    cards = [p["emb"].device for p in allocations(db.log.snapshot())]
    # after the db's first allocation on each card (a card the caching
    # allocator has not used refuses the reset)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)

    # ingest through the router, the host time split by tier: the hot
    # commit (enqueued, not waited for), the warm tier's two synced commits,
    # its lanes, and its host bookkeeping (the _slot_of_doc dict and the
    # cache invalidation: the rest of its ingest)
    split = dict.fromkeys(("hot", "warm", "warm_lanes"), 0.0)

    def timed(obj, name, key):
        real = getattr(obj, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            split[key] += time.perf_counter() - t0
            return out
        setattr(obj, name, wrapper)

    for obj, name, key in ((db.router.hot, "ingest", "hot"),
                           (warm, "ingest", "warm"),
                           (warm.lex, "write_rows", "warm_lanes")):
        timed(obj, name, key)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    host_s = []
    t_ingest0 = time.perf_counter()
    for start in range(0, n_rows, chunk):
        batch = device_corpus(ccfg, start, min(chunk, n_rows - start), gen)
        sync()
        t0 = time.perf_counter()
        db.ingest(batch)
        host_s.append(time.perf_counter() - t0)
        del batch
    sync()
    ingest_s = time.perf_counter() - t_ingest0
    for obj, name in ((db.router.hot, "ingest"), (warm, "ingest"),
                      (warm.lex, "write_rows")):
        del obj.__dict__[name]
    warm_commits_s = sum(warm.stats.write_latencies_s)
    n_hot = int(db.log.snapshot()["n_live"])
    check(n_hot + warm.n_docs == n_rows, "hot + warm rows != corpus rows")
    check(0 < n_hot <= hot_cap and warm.n_docs <= warm_cap,
          f"placement: {n_hot} hot, {warm.n_docs} warm")
    check(db.lex.stats.n_docs == n_rows and warm.lex.stats is db.lex.stats,
          "the two tiers' lanes must share one LexicalStats")

    # the plain answer's inputs: each tier's columns, and BM25's global
    # statistics recounted from both tiers' lanes; a hot arena held on
    # several cards is read column by column on ``dev`` (its dense signal
    # computed where each allocation lies)
    hot = db.log.snapshot()
    parts = allocations(hot)
    N_h, N_w = rows_of(hot), warm.emb.shape[0]

    def on_dev(ts, dim=0):
        return (ts[0] if len(ts) == 1
                else torch.cat([t.to(dev) for t in ts], dim))

    def hot_col(c):
        return on_dev([p[c] for p in parts])

    def hot_dense(q):
        return on_dev([torch.matmul(q.to(p["emb"].device), p["emb"].T)
                       for p in parts], 1)

    def hot_row(a):
        for p in parts:
            if a < p["emb"].shape[0]:
                return p["emb"][a]
            a -= p["emb"].shape[0]

    metas = [torch.stack(c, dim=1).cpu().numpy() for c in (
        [hot_col(c) for c in ("tenant", "updated_at", "category", "acl")],
        (warm.meta["tenant"], warm.meta["updated_at"],
         warm.meta["category"], warm.meta["acl"]))]
    live_w = warm.valid.cpu().numpy()

    def tier_masks(preds):
        """Each predicate's [hot, warm] row masks (`host_mask`, on the
        host), on the card."""
        pa = np.stack([p.as_array().numpy() for p in preds])
        hm = host_mask(metas[0], pa)
        wm = host_mask(metas[1], pa) & live_w
        return {p: [torch.from_numpy(hm[g]).to(dev),
                    torch.from_numpy(wm[g]).to(dev)]
                for g, p in enumerate(preds)}

    views = lex_views(db.lex.snapshot())
    lanes = [(on_dev([v["terms"] for v in views]),
              on_dev([v["tfs"] for v in views])),
             (warm.lex.snapshot()["terms"], warm.lex.snapshot()["tfs"])]
    V = lcfg.vocab_size
    df = sum(torch.bincount(torch.where(t >= 0, t, V).reshape(-1).long(),
                            minlength=V + 1)[:V] for t, _ in lanes)
    total_len = sum(int(torch.where(t >= 0, f, 0).sum()) for t, f in lanes)
    n_docs = sum(int((t >= 0).any(dim=1).sum()) for t, _ in lanes)
    df = df.cpu().numpy().astype(np.float64)
    idf_tab = torch.from_numpy(np.maximum(np.log1p(
        (n_docs - df + 0.5) / (df + 0.5)), 0.0).astype(np.float32)).to(dev)
    avg = torch.clamp(torch.tensor(total_len / max(n_docs, 1),
                                   dtype=torch.float32, device=dev), min=1.0)

    def lexnorm(tfs):
        tf = tfs.to(torch.float32)
        dl = tfs.sum(dim=1, keepdim=True).to(torch.float32)
        return tf * (lcfg.k1 + 1.0) / (tf + lcfg.k1 * (
            1.0 - lcfg.b + lcfg.b * dl / avg))

    lexn = [lexnorm(f) for _, f in lanes]

    # requests: 4 tenant groups of 8; even rows near a live HOT row the
    # group's tail predicate keeps, odd rows near a live WARM one, each
    # with 3 of that row's term ids
    rng = np.random.default_rng(SEED + 11)
    tenants = ((2, [0, 1]), (5, [2, 3]), (11, [4]), (19, [0, 2, 4]))
    days = (10, 20, 30, 40)                     # inside the 45-day window
    groups = [(Principal(t, 0xFF), cats) for t, cats in tenants]
    tail_pred = [db.session(p).search(np.ones(dim, np.float32))
                 .in_categories(c).plan().pred for p, c in groups]
    masks = tier_masks(tail_pred)
    keep_tail = [masks[p] for p in tail_pred]
    dense = [hot_dense, lambda q: torch.matmul(q, warm.emb.T)]
    anchors, qs, mts = [], [], []
    for r in range(32):
        t = r % 2
        rows = torch.nonzero(keep_tail[r % 4][t]).squeeze(1)
        a = int(rows[int(rng.integers(0, rows.numel()))])
        anchors.append((t, a))
        v = (hot_row(a) if t == 0 else warm.emb[a]).cpu().numpy() \
            + 0.02 * rng.standard_normal(dim).astype(np.float32)
        qs.append(v / np.linalg.norm(v))
        live = lanes[t][0][a].cpu().numpy()
        live = live[live >= 0]
        mts.append(tuple(int(x) for x in rng.choice(live, 3, replace=False)))

    def plans(kind):
        out = []
        for r in range(32):
            p, cats = groups[r % 4]
            b = db.session(p).search(qs[r]).in_categories(cats).limit(10)
            if kind == "hot":
                b = b.newer_than(ccfg.now_ts - days[r % 4] * DAY_S)
            elif kind in ("wsum", "rrf"):
                b = b.match(mts[r]).fuse(kind)
            out.append(b.plan())
        return out

    by_kind = {k: plans(k) for k in ("hot", "tail", "wsum", "rrf")}
    masks.update(tier_masks([p.pred for p in by_kind["hot"][:4]]))
    for kind, ps in by_kind.items():
        want_route = "hot" if kind == "hot" else "hot+warm"
        want_eng = "hybrid" if kind in ("wsum", "rrf") else dense_eng
        check(all(p.route == want_route and p.engine == want_eng
                  for p in ps), f"{kind} plans: route / engine")
    # a dense batch's hot units and launches: the sharded engine runs each
    # of the 4 groups apart, one launch a region it scans; the exact
    # engine one fused unit, one launch a card
    if sharded:
        fn = db._sharded_fn(10)
        scanned = {kind: [fn.active(p.pred.tenant)
                          for p in by_kind[kind][:4]]
                   for kind in ("hot", "tail")}
    hot_units = 4 if sharded else 1

    # the main path: every batch kind through RagDB.execute, the kernels'
    # counts set to 0 just before and read just after each run
    st = db.stats
    runs, res, lat, region_rows = {}, {}, {}, {}
    for kind, ps in by_kind.items():
        nb = n_lex_batches if kind in ("wsum", "rrf") else n_batches
        kernel_mod.LAUNCHES = hyb_mod.LAUNCHES = 0
        lat[kind], res[kind] = [], []
        dense_units = hot_units if kind in ("hot", "tail") else 1
        rows0 = list(st.shard_rows_scanned)
        for _ in range(nb):
            w0, c0, t0_ = st.warm_queries, st.device_calls, st.terms_scanned
            t0 = time.perf_counter()
            out = db.execute(ps, use_cache=False)
            lat[kind].append((time.perf_counter() - t0) * 1e3)
            res[kind].append(out)
            dw, dc = st.warm_queries - w0, st.device_calls - c0
            if kind == "hot":
                check(dw == 0, "a hot batch probed the warm tier")
                check(dc == dense_units, f"hot batch: {dc} device calls, "
                      f"expected {dense_units}")
                check((out[2] == 0).all(), "hot batch returned warm rows")
            else:
                check(dw == 32, f"{kind}: warm_queries +{dw}, expected 32")
                check(dc == dense_units + 4, f"{kind}: {dc} device calls, "
                      f"expected {dense_units + 4}")
                check({0, 1} <= set(out[2][out[1] >= 0].tolist()),
                      f"{kind}: tiers must hold both 0 and 1")
            if kind in ("wsum", "rrf"):
                dt = st.terms_scanned - t0_
                check(dt == (N_h + 4 * warm_cap) * lcfg.doc_terms,
                      f"{kind}: terms_scanned +{dt}")
        runs[kind] = dict(arena_scan=kernel_mod.LAUNCHES,
                          hybrid_score=hyb_mod.LAUNCHES)
        if sharded and kind in ("hot", "tail"):
            want = (nb * sum(map(len, scanned[kind])), 0)
            rows0 += [0] * (len(st.shard_rows_scanned) - len(rows0))
            rows = [a - b for a, b in zip(st.shard_rows_scanned, rows0)]
            want_rows = [nb * fn.n_local * sum(sh in a for a in scanned[kind])
                         for sh in range(fn.n_shards)]
            check(rows == want_rows, f"{kind}: rows a region {rows}, "
                  f"expected {want_rows}")
            region_rows[kind] = rows
        elif kind in ("hot", "tail"):
            want = (nb * len(parts), 0)
        else:
            want = (0, nb * len(parts))
        check((kernel_mod.LAUNCHES, hyb_mod.LAUNCHES) == want,
              f"{kind}: launches {runs[kind]}, expected {want} "
              f"(one a region scanned, or a hot unit and card)")
        # the batches of one kind return the same rows
        check(all((o[1] == res[kind][0][1]).all() for o in res[kind]),
              f"{kind}: batches disagree")

    # correctness: each tail batch against the plain global top-k over the
    # union of both tiers' rows that pass each request's predicate (f32,
    # TF32 off); rrf per signal, then fused
    errs, rrf_rows_skipped = [], 0
    order = [r for g in range(4) for r in range(g, 32, 4)]

    def group_inputs(rows, pred):
        keeps = masks[pred]
        q = torch.from_numpy(np.stack([qs[r] for r in rows])).to(dev)
        qt = torch.full((len(rows), 4), -1, dtype=torch.int32, device=dev)
        qt[:, :3] = torch.tensor([mts[r] for r in rows], dtype=torch.int32,
                                 device=dev)
        qidf = torch.where(qt >= 0, idf_tab[qt.clamp(min=0).long()], 0.0)
        return keeps, q, qt, qidf

    for kind in ("hot", "tail", "wsum"):
        s_g, i_g, t_g = res[kind][0]
        for g in range(4):
            rows = list(range(g, 32, 4))
            keeps, q, qt, qidf = group_inputs(rows, by_kind[kind][g].pred)
            sig = [f(q) for f in dense]
            if kind == "wsum":
                sig = [d + plain_bm25(lanes[t][0], lexn[t], qt, qidf)
                       for t, d in enumerate(sig)]
            sig = [torch.where(k_, x, NEG) for k_, x in zip(keeps, sig)]
            # the union over both tiers for every kind: a hot plan's
            # recency bound lies inside the window, so no warm row passes
            errs.append(tiered_compare(
                f"tiered-{kind}-g{g}", (s_g[rows], i_g[rows], t_g[rows]),
                union_topk(*sig, 10), sig, keeps))
            del sig
    # rrf: rebuild the executor's per-signal tier-merged lists from one
    # launched batch and hold each to the plain per-signal union lists; a
    # row whose two lists equal the plain ones must fuse to plain_rrf
    pend = db.launch(by_kind["rrf"], use_cache=False)
    s_f, i_f, t_f = db.finish(pend)
    check((i_f == res["rrf"][0][1]).all(), "rrf: batches disagree")
    (unit, member_idxs, hot_u), probes = (pend.inflight.inflight[0],
                                          pend.inflight.warm_results[0])
    hs, hi = hot_u.s.cpu().numpy(), hot_u.sl.cpu().numpy()
    h_ls, h_li = hot_u.extra_np
    off = 0
    for gi, m in enumerate(member_idxs):
        span = slice(off, off + len(m))
        off += len(m)
        w_ds, w_di, w_ls, w_li = probes[gi]
        merged = {"dense": merge_tiers(hs[span], hi[span], w_ds, w_di, 10),
                  "bm25": merge_tiers(h_ls[span], h_li[span], w_ls, w_li,
                                      10)}
        keeps, q, qt, qidf = group_inputs(m, unit.plans[gi].pred)
        sig = {"dense": [torch.where(keeps[t], dense[t](q), NEG)
                         for t in (0, 1)],
               "bm25": [torch.where(keeps[t], plain_bm25(
                   lanes[t][0], lexn[t], qt, qidf), NEG) for t in (0, 1)]}
        plain = {}
        for name in ("dense", "bm25"):
            plain[name] = union_topk(*sig[name], 10)
            errs.append(tiered_compare(f"tiered-rrf-{name}-g{gi}",
                                       merged[name], plain[name], sig[name],
                                       keeps))
        keys = lambda lst, j: [(int(t), int(s)) for s, t in
                               zip(lst[1][j], lst[2][j]) if s >= 0]
        for j, r in enumerate(m):
            same = all(keys(merged[n], j) == keys(plain[n], j)
                       for n in ("dense", "bm25"))
            if not same:
                rrf_rows_skipped += 1
                continue
            want = plain_rrf(keys(plain["dense"], j), keys(plain["bm25"], j),
                             10, RRF_C)
            got_keys = [(int(t), int(s)) for s, t in zip(i_f[r], t_f[r])
                        if s >= 0]
            check(got_keys == [k_ for _, k_ in want],
                  f"rrf fused: row {r} differs from the plain fusion")
            check(np.allclose(s_f[r][:len(want)], [s for s, _ in want],
                              rtol=TOL, atol=TOL), f"rrf fused: row {r} "
                  "scores")
        del sig
    check(rrf_rows_skipped <= 4, f"rrf: {rrf_rows_skipped} rows' per-signal "
          "lists tie-differ from the plain ones (expected few)")

    # timings: each batch's idle share; the hot kernels alone (CUDA events)
    # on the tail batch's inputs; the warm probe's wall and device time per
    # probe; the host merge
    profiles = {k: profile_batch(lambda ps=ps: db.execute(ps, use_cache=False),
                                 SCAN_TAGS)
                for k, ps in by_kind.items()}
    hot_kernel_ms = None if ALLOCS in hot else tiered_hot_kernel_ms(
        db, hot, by_kind, qs, mts, order, dev)
    probe_ms = {}
    for kind in ("tail", "wsum", "rrf"):
        p0 = by_kind[kind][0]
        q8 = np.stack([qs[r] for r in range(0, 32, 4)])
        qt8 = np.full((8, 4), -1, np.int32)
        qt8[:, :3] = [mts[r] for r in range(0, 32, 4)]
        if kind == "tail":
            fn = lambda: warm.query(q8, p0.pred, 10, pushdown=True)
        else:
            fn = lambda m=kind: warm.query_hybrid(
                q8, qt8, p0.pred, 10, mode=m, lists=(m == "rrf"))
        fn()
        wall = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            wall.append((time.perf_counter() - t0) * 1e3)
        dev_probe, _ = device_ms(fn, 2)
        probe_ms[kind] = dict(wall_ms=statistics.median(wall),
                              device_ms=dev_probe, profile=profile_batch(fn))
    # the host merge of one tail batch (4 groups) and of one rrf batch
    tail_probes = [warm.query(np.stack([qs[r] for r in range(g, 32, 4)]),
                              by_kind["tail"][g].pred, 10, pushdown=True)
                   for g in range(4)]
    hot_lists = db.execute(by_kind["hot"], use_cache=False)
    t0 = time.perf_counter()
    for g in range(4):
        rows = list(range(g, 32, 4))
        merge_tiers(hot_lists[0][rows], hot_lists[1][rows], *tail_probes[g],
                    10)
    merge_ms = (time.perf_counter() - t0) * 1e3

    # freshness, isolation of writes and the cache
    rc = db.result_cache
    for kind in ("hot", "tail"):
        db.execute(by_kind[kind])                    # fill the cache
    h0 = rc.hits
    db.execute(by_kind["hot"])
    tail_before = db.execute(by_kind["tail"])
    check(rc.hits - h0 == 64, "repeats must hit the result cache")
    r_v = int(np.nonzero((tail_before[2] == 1).any(axis=1))[0][0])
    j_v = int(np.nonzero(tail_before[2][r_v] == 1)[0][0])
    victim_slot = int(tail_before[1][r_v, j_v])
    victim = int(warm.meta["doc_id"][victim_slot])
    db.delete([victim])                              # a warm write
    h0 = rc.hits
    tail_after = db.execute(by_kind["tail"])
    check(rc.hits == h0, "a warm write must invalidate hot+warm results")
    db.execute(by_kind["hot"])
    check(rc.hits == h0 + 32, "a warm write must leave hot results cached")
    for out in (tail_after, db.execute(by_kind["tail"], use_cache=False)):
        check(not ((out[1] == victim_slot) & (out[2] == 1)).any(),
              "a deleted warm doc came back")
    # promotion: a warm doc the group-0 tail predicate keeps, updated at now
    # with request 0's query as its embedding, moves hot and answers the
    # next hot batch from tier 0
    w_rows = torch.nonzero(keep_tail[0][1] & warm.valid).squeeze(1)
    promo = int(warm.meta["doc_id"][int(w_rows[0])])
    db.update([promo], qs[0][None, :], [ccfg.now_ts])
    check(db.log.has_doc(promo) and not warm.has_doc(promo),
          "a fresh warm doc must move to the hot tier")
    s_h, i_h, t_h = db.execute(by_kind["hot"], use_cache=False)
    check(i_h[0, 0] == db.log.slot_of(promo) and t_h[0, 0] == 0,
          "the promoted doc must top request 0's hot batch from tier 0")

    B, G, k, T = 32, 4, 10, lcfg.doc_terms
    bq = 8 * dim * 4 + 8 * k * 8
    probe_bytes = N_w * (4 * dim + 4 * 4 + 1) + bq
    probe_flops = 2 * 8 * N_w * dim
    bound = lambda nb, fl: max(nb / HBM_BPS, fl / FP32_FLOPS) * 1e3
    warm_bound = {"tail": bound(probe_bytes, probe_flops),
                  "hybrid": bound(probe_bytes + N_w * 8 * T, probe_flops)}
    out = dict(seconds=time.perf_counter() - t_phase, rows=n_rows,
         dim=dim, lanes=T, hot_window_s=window, hot_capacity=N_h,
         warm_capacity=N_w, hot_rows=n_hot, warm_rows=warm.n_docs, batch=B,
         groups=G, k=k,
         batches={k_: len(v) for k_, v in lat.items()},
         batch_ms_median={k_: statistics.median(v) for k_, v in lat.items()},
         batch_ms=lat,
         idle_share={k_: p["idle_share"] for k_, p in profiles.items()},
         launches=runs, dense_engine=dense_eng,
         shard_rows_scanned=region_rows, hot_kernel_ms=hot_kernel_ms,
         warm_probe=probe_ms,
         warm_probe_batch_device_ms={
             k_: (4 * v["device_ms"] if v["device_ms"] is not None
                  else None) for k_, v in probe_ms.items()},
         warm_probe_bound_ms=warm_bound, warm_probe_bound_by="bytes"
         if probe_bytes / HBM_BPS >= probe_flops / FP32_FLOPS
         else "operations", warm_probe_bytes=probe_bytes,
         merge_host_ms_tail_batch=merge_ms,
         ingest_s=ingest_s, ingest_host_s=sum(host_s),
         ingest_split_s=dict(
             hot=split["hot"], warm=split["warm"],
             warm_commits=warm_commits_s, warm_lanes=split["warm_lanes"],
             warm_bookkeeping=split["warm"] - warm_commits_s
             - split["warm_lanes"]),
         warm_inconsistency_window_ms_median=1e3 * statistics.median(
             warm.stats.inconsistency_windows_s),
         rrf_rows_skipped=rrf_rows_skipped, max_abs_err=max(errs),
         profile=profiles,
         peak_mem_gb=[torch.cuda.max_memory_allocated(c) / 1e9
                      for c in cards] if len(cards) > 1 else peak_gb())
    emit(phase, **out)
    return out


def phase_sharded_prod(dev, n_rows=None, dim=None, chunk=1 << 20,
                       n_shards=4, n_batches=6, tie_rows=1 << 12,
                       long_tie=(1 << 16, 4096),
                       dec_shape=(8, 2064, 8, 4, 128)):
    """The sharded engine at production width on one card: a RagDB over
    rag_unified.PRODUCTION cut to 2^23 x 768 rows (16 lanes) with
    ``mesh=make_mesh((4,), ("data",), devices=[card] * 4)``, built with
    hash placement and then, the first dropped, with tenant placement;
    then constructed ties, filtered_topk_sharded and decode_attention_
    sharded. ``long_tie`` (rows, tied rows) sizes the arena of the long
    tie run, whose first region holds every tied row at first. Returns
    the launches of the main path's runs and the errors for the kernels
    line."""
    from repro_torch.api import RagDB
    from repro_torch.configs import rag_unified
    from repro_torch.core.query import Predicate
    from repro_torch.core.store import DocBatch
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, device_corpus
    from repro_torch.index.lexical import LexicalConfig
    from repro_torch.kernels.arena_scan import sharded as sh_mod
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.filtered_topk.filtered_topk import \
        filtered_topk_cuda
    from repro_torch.kernels.filtered_topk.ops import filtered_topk_sharded
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    prod_cfg = rag_unified.PRODUCTION
    n_rows, dim = n_rows or prod_cut()[0], dim or prod_cut()[1]
    S, k = n_shards, 10
    n_local = n_rows // S
    # tenant placement fills the regions unevenly: leave each region room
    # for its tenants' share to run over the mean (65,536 rows at 2^23, 13
    # standard deviations of a region's count)
    n_docs = n_rows - max(n_rows // 128, 16 * int(np.sqrt(n_rows)))
    mesh = make_mesh((S,), ("data",), devices=[dev] * S)
    ccfg = CorpusConfig(n_docs=n_docs, dim=dim, n_tenants=20, n_categories=5)
    rng = np.random.default_rng(SEED + 9)
    qs = rng.standard_normal((32, dim)).astype(np.float32)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((2, 90, [0, 1]), (5, 150, [2, 3]),
                              (11, 45, [4]), (19, 170, [0, 2, 4]))]
    cbytes_launch = sh_mod.sharded_collective_bytes(S, 1, k, n_local)
    neg = np.float32(np.finfo(np.float32).min)

    def plans_of(db, engine=None, n=32):
        out = []
        for r in range(n):
            p, ts, cats = groups[r % 4]
            b = (db.session(p).search(qs[r]).newer_than(ts)
                 .in_categories(cats).limit(k))
            out.append((b.using(engine) if engine else b).plan())
        return out

    def leaks(db, plans, sl):
        """Returned slots failing their request's predicate (host mask)."""
        meta = _packed_meta(*(db.log.snapshot()[c] for c in (
            "tenant", "updated_at", "category", "acl")))
        got = meta[torch.from_numpy(np.maximum(sl, 0)).to(dev).long()]
        got = got.cpu().numpy()
        n = 0
        for r, p in enumerate(plans):
            ok = host_mask(got[r], p.pred.as_array().numpy()[None])[0]
            n += int((~ok & (sl[r] >= 0)).sum())
        return n

    def run(placement):
        db = RagDB(dataclasses.replace(prod_cfg, capacity=n_rows, dim=dim),
                   mesh=mesh, placement=placement,
                   lexical_cfg=LexicalConfig(), device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        for start in range(0, n_docs, chunk):
            batch = device_corpus(ccfg, start, min(chunk, n_docs - start),
                                  gen)
            db.ingest(batch)
            del batch
        sync()
        ingest_s = time.perf_counter() - t0
        check(int(db.log.snapshot()["n_live"]) == n_docs, "n_live")
        plans, cuda_plans = plans_of(db), plans_of(db, "cuda")
        check(all(p.engine == "sharded" and p.shards == S
                  and p.placement == placement for p in plans),
              f"plans must pick 'sharded' ({plans[0].engine_reason})")
        check("sharding:" in plans[0].explain(), "explain: no sharding line")
        db.execute(plans, use_cache=False)            # warm-up
        db.execute(cuda_plans, use_cache=False)
        sync()

        # the main path's run: the counts set to 0 just before, read after
        fn = db._sharded_fn(k)
        per_batch = [fn.active(p.pred.tenant) for p in plans[:4]]
        rows0 = list(db.stats.shard_rows_scanned)
        cb0 = db.stats.collective_bytes
        widen0 = sh_mod.TIE_WIDENS
        kernel_mod.LAUNCHES = 0
        lat = []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            s, sl, _ = db.execute(plans, use_cache=False)
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = kernel_mod.LAUNCHES
        rows = [a - b for a, b in zip(db.stats.shard_rows_scanned, rows0)]
        want_rows = [n_batches * n_local * sum(sh in act for act in per_batch)
                     for sh in range(S)]
        check(launches == n_batches * sum(map(len, per_batch)),
              f"{placement}: {launches} kernel launches for {n_batches} "
              f"batches of {sum(map(len, per_batch))} shard scans")
        check(rows == want_rows, f"{placement}: shard rows {rows} != "
              f"{want_rows}")
        cbytes = db.stats.collective_bytes - cb0
        check(cbytes == n_batches * 4 * cbytes_launch and
              db.stats.shards_used == S, f"{placement}: collective bytes "
              f"{cbytes}, shards_used {db.stats.shards_used}")
        widens = sh_mod.TIE_WIDENS - widen0
        explain = [ln for ln in db.explain().splitlines() if "sharded:" in ln]
        check(len(explain) == 1, "RagDB.explain(): no sharded line")

        # a batch of 5 rows a group: each group padded with 3 zero rows,
        # which tie at every place; the tie checks read only the real rows
        pad0, widen0 = db.stats.padded_rows, sh_mod.TIE_WIDENS
        t0 = time.perf_counter()
        s5, sl5, _ = db.execute(plans_of(db, n=20), use_cache=False)
        padded_ms = (time.perf_counter() - t0) * 1e3
        padded_widens = sh_mod.TIE_WIDENS - widen0
        check(db.stats.padded_rows - pad0 == 12, f"{placement}: "
              f"{db.stats.padded_rows - pad0} padding rows, not 12")
        check(padded_widens == 0, f"{placement}: {padded_widens} shard "
              "scans widened for a padded group")
        check(same_bits(s5, s[:20]) and (sl5 == sl[:20]).all(),
              f"{placement}: a padded group's lists != the full batch's")

        # the unsharded fused batch on the same rows, and (a) identity
        kernel_mod.LAUNCHES = 0
        lat_u = []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            s_u, sl_u, _ = db.execute(cuda_plans, use_cache=False)
            lat_u.append((time.perf_counter() - t0) * 1e3)
        check(kernel_mod.LAUNCHES == n_batches, "unsharded: one fused "
              "launch a batch")
        check(same_bits(s, s_u) and (sl == sl_u).all(),
              f"{placement}: sharded lists != the unsharded kernel's")
        snap = db.log.snapshot()
        meta = _packed_meta(snap["tenant"], snap["updated_at"],
                            snap["category"], snap["acl"])
        order = [r for g in range(4) for r in range(g, 32, 4)]
        q = torch.from_numpy(np.concatenate([plans[r].logical.q
                                             for r in order])).to(dev)
        gids = torch.tensor([g for g in range(4) for _ in range(8)],
                            dtype=torch.int32, device=dev)
        preds = torch.stack([plans[g].pred.as_array(dev) for g in range(4)])
        s_k1, _ = kernel_mod.arena_scan_cuda(q, snap["emb"], meta, gids,
                                             preds, k + 1)
        s_k1 = s_k1.cpu().numpy()
        straddles = int(((s_k1[:, k - 1] == s_k1[:, k])
                         & (s_k1[:, k - 1] > neg)).sum())
        check(straddles == 0, f"{placement}: {straddles} rows with a tie "
              "at the k-th place")
        n_leaks = leaks(db, plans, sl)
        check(n_leaks == 0, f"{placement}: {n_leaks} leaked slots")

        # (g) no host sync in RagDB.launch of a sharded batch
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = db.launch(plans, use_cache=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        s_g, sl_g, _ = db.finish(pending)
        del pending
        check(same_bits(s_g, s) and (sl_g == sl).all(),
              "launch / finish rows != execute rows")

        # one shard's kernel alone (group 0's rows on region 0, k + 1 as
        # the engine launches it) against its plain version
        q8, g8 = q[:8].contiguous(), gids[:8]
        region = (snap["emb"][:n_local], meta[:n_local])
        args = (q8, *region, g8, preds[:1].contiguous(), k + 1)
        s_1, i_1 = kernel_mod.arena_scan_cuda(*args)
        s_p, i_p = kernel_mod.arena_scan_plain(*args)
        sync()
        err = compare(f"sharded_{placement}_shard0", s_1.cpu().numpy(),
                      i_1.cpu().numpy(), s_p.cpu().numpy(),
                      i_p.cpu().numpy(),
                      host_mask(region[1].cpu().numpy(),
                                preds[:1].cpu().numpy())[[0] * 8])
        shard_ms = events_ms(lambda: kernel_mod.arena_scan_cuda(*args), 10)
        shard_dev_ms, _ = device_ms(lambda: kernel_mod.arena_scan_cuda(*args),
                                    5)
        nbytes = n_local * (4 * dim + 16) + 8 * dim * 4 + 8 * (k + 1) * 8
        flops = 2 * 8 * n_local * dim
        shard_bound = max(nbytes / HBM_BPS, flops / FP32_FLOPS) * 1e3
        shard_plain_ms = events_ms(
            lambda: kernel_mod.arena_scan_plain(*args), 3)
        profile = profile_batch(lambda: db.execute(plans, use_cache=False),
                                SCAN_TAGS)
        out = dict(ingest_s=ingest_s, batch_ms_median=statistics.median(lat),
                   batch_ms=lat,
                   unsharded_batch_ms_median=statistics.median(lat_u),
                   unsharded_batch_ms=lat_u, launches=launches,
                   launches_per_batch=launches // n_batches,
                   shard_rows_scanned=rows, collective_bytes=cbytes,
                   collective_bytes_per_launch=cbytes_launch,
                   tie_widens=widens, padded_batch_ms=padded_ms,
                   padded_widens=padded_widens, straddles=straddles,
                   leaks=n_leaks,
                   shard_kernel_ms=shard_ms,
                   shard_kernel_device_ms=shard_dev_ms,
                   shard_bound_ms=shard_bound, shard_plain_ms=shard_plain_ms,
                   max_abs_err=err, explain=explain,
                   plan_sharding=[ln.strip() for ln in
                                  plans[0].explain().splitlines()
                                  if "sharding:" in ln],
                   idle_share=profile["idle_share"], profile=profile)
        del snap, meta, region, args, s_k1
        return db, out

    db, hash_run = run("hash")
    # (e) filtered_topk_sharded against the kernel on the whole arena
    snap = db.log.snapshot()
    meta = _packed_meta(snap["tenant"], snap["updated_at"],
                        snap["category"], snap["acl"])
    q8 = torch.from_numpy(np.stack([qs[r] / np.linalg.norm(qs[r])
                                    for r in range(0, 32, 4)])).to(dev)
    pred0 = groups_pred = plans_of(db)[0].pred.as_array(dev)
    kernel_mod.LAUNCHES = 0
    s_f, i_f = filtered_topk_sharded(mesh, "data", q8, snap["emb"], meta,
                                     pred0, k)
    check(kernel_mod.LAUNCHES == S, "filtered_topk_sharded: one launch a "
          "shard")
    s_w, i_w = filtered_topk_cuda(q8, snap["emb"], meta, pred0, k)
    check(same_bits(s_f.cpu().numpy(), s_w.cpu().numpy())
          and torch.equal(i_f, i_w),
          "filtered_topk_sharded != filtered_topk_cuda on the whole arena")
    ft_ms = events_ms(lambda: filtered_topk_sharded(
        mesh, "data", q8, snap["emb"], meta, pred0, k), 6)
    ft_whole_ms = events_ms(lambda: filtered_topk_cuda(
        q8, snap["emb"], meta, pred0, k), 6)
    del snap, meta, s_f, i_f, s_w, i_w, groups_pred
    del db
    gc.collect()
    torch.cuda.empty_cache()

    db, tenant_run = run("tenant")
    # (c) the tenant-affine skip with poisoned rows: for each group, its
    # first query's direction under two foreign tenants (one owned by
    # another shard, one by the same shard), passing every other clause
    poison = []
    for p, ts, cats in groups:
        t = p.tenant_id
        for foreign in ((t + 1) % 20, (t + S) % 20):
            poison.append((foreign, cats[0]))
    q_first = np.stack([qs[g] / np.linalg.norm(qs[g]) for g in range(4)])
    emb_p = torch.from_numpy(np.repeat(q_first, 2, axis=0)).to(dev)
    m = len(poison)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    poison_ids = list(range(n_docs, n_docs + m))
    db.ingest(DocBatch(emb=emb_p, tenant=i32([t for t, _ in poison]),
                       category=i32([c for _, c in poison]),
                       updated_at=i32([ccfg.now_ts] * m),
                       acl=i32([-1] * m), doc_id=i32(poison_ids)))
    poison_slots = {db.log.slot_of(d) for d in poison_ids}
    admin = (db.admin_session().search(qs[0]).limit(k).using("sharded")
             .run())
    check(int(admin.slots[0, 0]) in poison_slots, "a poisoned row must "
          "top an unscoped query (it is built to out-score the corpus)")
    p0, ts0, cats0 = groups[0]
    rows0 = list(db.stats.shard_rows_scanned)
    kernel_mod.LAUNCHES = 0
    one = (db.session(p0).search(qs[0]).newer_than(ts0).in_categories(cats0)
           .limit(k).run())
    one_rows = [a - b for a, b in zip(db.stats.shard_rows_scanned, rows0)]
    owner = p0.tenant_id % S
    check(kernel_mod.LAUNCHES == 1 and one.plan.engine == "sharded",
          f"a tenant-scoped plan launched {kernel_mod.LAUNCHES} kernels")
    check(one_rows == [n_local if s == owner else 0 for s in range(S)],
          f"a tenant-scoped plan scanned {one_rows}")
    plans = plans_of(db)
    s_t, sl_t, _ = db.execute(plans, use_cache=False)
    poisoned = int(np.isin(np.concatenate([sl_t, one.slots]),
                           list(poison_slots)).sum())
    check(poisoned == 0, f"{poisoned} poisoned foreign-tenant rows returned")
    poison_leaks = leaks(db, plans, sl_t)
    check(poison_leaks == 0, f"{poison_leaks} leaked slots with poison")
    del db, admin, one, s_t, sl_t
    gc.collect()
    torch.cuda.empty_cache()

    # (b) constructed ties: 64 rows share one embedding; the lists are
    # placement-invariant under a shuffled row order, and the widening
    # fires
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    emb_t = torch.randn((tie_rows, dim), generator=g, device=dev)
    emb_t = emb_t / torch.linalg.vector_norm(emb_t, dim=1, keepdim=True)
    emb_t[:64] = emb_t[0]
    qt = emb_t[:1] + 1e-3 * torch.randn((8, dim), generator=g, device=dev)
    qt = (qt / torch.linalg.vector_norm(qt, dim=1, keepdim=True)).contiguous()
    doc_t = torch.arange(tie_rows, dtype=torch.int32, device=dev)
    cols = dict(tenant=torch.randint(0, 4, (tie_rows,), generator=g,
                                     device=dev).to(torch.int32),
                category=torch.zeros(tie_rows, dtype=torch.int32, device=dev),
                updated_at=torch.full((tie_rows,), 5, dtype=torch.int32,
                                      device=dev),
                acl=torch.ones(tie_rows, dtype=torch.int32, device=dev))
    tie_fn = sh_mod.make_sharded_arena_scan(mesh, "data", tie_rows, k)
    tie_out = []
    widen0 = sh_mod.TIE_WIDENS
    for order in (torch.arange(tie_rows, device=dev),
                  torch.randperm(tie_rows, generator=g, device=dev)):
        store = {c: v[order].contiguous() for c, v in cols.items()}
        store.update(emb=emb_t[order].contiguous(), doc_id=doc_t[order],
                     version=torch.zeros_like(doc_t),
                     commit_ts=i32(1), n_live=i32(tie_rows))
        s_t, sl_t, _ = tie_fn(store, qt, Predicate())
        ids = torch.where(sl_t >= 0, store["doc_id"][sl_t.clamp(min=0)], -1)
        tie_out.append((s_t.cpu().numpy(), ids.cpu().numpy()))
        del store
    tie_widens = sh_mod.TIE_WIDENS - widen0
    check(tie_widens > 0, "the tie widening must fire on 64 tied rows")
    check(same_bits(tie_out[0][0], tie_out[1][0])
          and (tie_out[0][1] == tie_out[1][1]).all(),
          "constructed ties: lists move with the row placement")
    check((tie_out[0][1] == np.arange(k)).all(),
          "constructed ties: the run must resolve to the smallest doc ids")
    del emb_t, qt, doc_t, cols

    # a long tie run: the first long_tie[1] rows share one embedding, all in
    # region 0 at first, then shuffled over the regions; the widened kernel
    # (its last width on region 0) against its plain version, and timed
    n_long, n_tied = long_tie
    lt_local = n_long // S
    emb_l = torch.randn((n_long, dim), generator=g, device=dev)
    emb_l = emb_l / torch.linalg.vector_norm(emb_l, dim=1, keepdim=True)
    emb_l[:n_tied] = emb_l[0]
    ql = emb_l[:1] + 1e-3 * torch.randn((8, dim), generator=g, device=dev)
    ql = (ql / torch.linalg.vector_norm(ql, dim=1, keepdim=True)).contiguous()
    doc_l = torch.arange(n_long, dtype=torch.int32, device=dev)
    cols_l = dict(tenant=torch.zeros(n_long, dtype=torch.int32, device=dev),
                  category=torch.zeros(n_long, dtype=torch.int32, device=dev),
                  updated_at=torch.full((n_long,), 5, dtype=torch.int32,
                                        device=dev),
                  acl=torch.ones(n_long, dtype=torch.int32, device=dev))
    long_fn = sh_mod.make_sharded_arena_scan(mesh, "data", n_long, k)
    long_out, long_widens, long_ms, long_kk = [], [], [], []
    for order in (torch.arange(n_long, device=dev),
                  torch.randperm(n_long, generator=g, device=dev)):
        store = {c: v[order].contiguous() for c, v in cols_l.items()}
        store.update(emb=emb_l[order].contiguous(), doc_id=doc_l[order],
                     version=torch.zeros_like(doc_l),
                     commit_ts=i32(1), n_live=i32(n_long))
        sync()
        widen0 = sh_mod.TIE_WIDENS
        t0 = time.perf_counter()
        launched = long_fn.launch(store, ql, Predicate())
        s_l, sl_l = launched.finish()
        ids = torch.where(sl_l >= 0, store["doc_id"][sl_l.clamp(min=0)], -1)
        long_out.append((s_l.cpu().numpy(), ids.cpu().numpy()))
        long_ms.append((time.perf_counter() - t0) * 1e3)
        long_widens.append(sh_mod.TIE_WIDENS - widen0)
        long_kk.append([int(sc.shape[1]) for _, sc, _ in launched.parts])
        if len(long_out) == 1:
            store0 = store
        del launched, store
    check(same_bits(long_out[0][0], long_out[1][0])
          and (long_out[0][1] == long_out[1][1]).all()
          and (long_out[0][1] == np.arange(k)).all(),
          "long tie run: lists move with the placement, or miss the "
          "smallest doc ids")
    check(long_kk[0][0] > n_tied and min(long_widens) > 0,
          f"long tie run: widths {long_kk}, widenings {long_widens}")
    meta_l = _packed_meta(store0["tenant"], store0["updated_at"],
                          store0["category"], store0["acl"])
    wide_args = (ql, store0["emb"][:lt_local], meta_l[:lt_local],
                 torch.zeros(8, dtype=torch.int32, device=dev),
                 Predicate().as_array(dev)[None].contiguous(), long_kk[0][0])
    s_w1, i_w1 = kernel_mod.arena_scan_cuda(*wide_args)
    s_wp, i_wp = kernel_mod.arena_scan_plain(*wide_args)
    sync()
    long_err = compare("sharded_long_tie_wide", s_w1.cpu().numpy(),
                       i_w1.cpu().numpy(), s_wp.cpu().numpy(),
                       i_wp.cpu().numpy(),
                       host_mask(meta_l[:lt_local].cpu().numpy(),
                                 wide_args[4].cpu().numpy())[[0] * 8])
    wide_ms = events_ms(lambda: kernel_mod.arena_scan_cuda(*wide_args), 5)
    wide_plain_ms = events_ms(lambda: kernel_mod.arena_scan_plain(*wide_args),
                              3)
    del emb_l, ql, doc_l, cols_l, store0, meta_l, wide_args, s_w1, i_w1
    del s_wp, i_wp

    # (f) decode_attention_sharded at lm_serve's shape: 4 sequence shards,
    # one sequence live in the first shard only
    B, Sc, KV, G, hd = dec_shape
    gd = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf = dict(generator=gd, device=dev, dtype=torch.bfloat16)
    qd = torch.randn((B, KV * G, hd), **bf)
    kc = torch.randn((B, Sc, KV, hd), **bf)
    vc = torch.randn((B, Sc, KV, hd), **bf)
    live = min(2049, Sc)
    lengths = torch.tensor([live] * (B - 1) + [max(1, Sc // S // 2)],
                           dtype=torch.int32, device=dev)
    qg = qd.reshape(B, KV, G, hd)
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    out = dec_ops.decode_attention_sharded(mesh, "data", qd, kc, vc, lengths,
                                           n_kv=KV)
    dec_launches, dec_tc_launches = dec_mod.LAUNCHES, dec_mod.TC_LAUNCHES
    check(dec_launches == S and dec_tc_launches
          == S * dec_mod.uses_tc(kc.dtype, hd),
          f"decode_attention_sharded: {dec_launches} launches for {S} "
          f"shards, {dec_tc_launches} of the tensor-core body")
    acc, l_s = dec_ops.merge_sharded(mesh, "data", qg, kc, vc, lengths)
    a1, _, l1 = dec_mod.decode_attention_cuda(qg, kc, vc, lengths)
    a_p, _, l_p = dec_mod.decode_attention_plain(qg, kc, vc, lengths)
    sync()
    dec_err, ratio = attn_ok(acc / l_s, a1 / l1, DEC_TOL, DEC_TOL)
    _, ratio_p = attn_ok(acc / l_s, a_p / l_p, DEC_TOL, DEC_TOL)
    check(ratio <= 1 and ratio_p <= 1 and torch.isfinite(acc / l_s).all(),
          f"sharded decode off the unsharded kernel: {dec_err} (x{ratio}), "
          f"the plain version x{ratio_p}")
    check(torch.equal(out, (acc / l_s).reshape(B, KV * G, hd).to(qd.dtype)),
          "decode_attention_sharded != its merged partials")
    dec_ms = events_ms(lambda: dec_ops.decode_attention_sharded(
        mesh, "data", qd, kc, vc, lengths, n_kv=KV), 20)
    dec_whole_ms = events_ms(lambda: dec_mod.decode_attention_cuda(
        qg, kc, vc, lengths), 20)
    dec_dev_ms, _ = device_ms(lambda: dec_ops.decode_attention_sharded(
        mesh, "data", qd, kc, vc, lengths, n_kv=KV), 10)
    dec_whole_dev_ms, _ = device_ms(lambda: dec_mod.decode_attention_cuda(
        qg, kc, vc, lengths), 10)
    # the wrapper's host cost a call (200 launches queued, no sync inside):
    # the whole contiguous cache, and one sequence shard's strided view
    dec_host_us = {}
    for name, args in (("contiguous", (qg, kc, vc, lengths)),
                       ("slice", (qg, kc[:, :Sc // S], vc[:, :Sc // S],
                                  lengths.clamp(max=Sc // S)))):
        sync()
        t0 = time.perf_counter()
        for _ in range(200):
            dec_mod.decode_attention_cuda(*args)
        dec_host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        sync()
    del qd, kc, vc, qg, acc, l_s, a1, l1, a_p, l_p, out

    emit("sharded_prod", seconds=time.perf_counter() - t_phase, rows=n_rows,
         docs=n_docs, dim=dim, shards=S, rows_per_shard=n_local, batch=32,
         groups=4, k=k, hash=hash_run, tenant=tenant_run,
         filtered_topk_sharded_ms=ft_ms, filtered_topk_whole_ms=ft_whole_ms,
         poisoned_returned=poisoned, tenant_scoped_plan_rows=one_rows,
         tie_widens=tie_widens, tie_rows=tie_rows,
         long_tie=dict(rows=n_long, tied=n_tied, widens=long_widens,
                       widths=long_kk, ms=long_ms, wide_k=long_kk[0][0],
                       wide_kernel_ms=wide_ms, wide_plain_ms=wide_plain_ms,
                       wide_max_abs_err=long_err),
         decode_shape=dict(B=B, S=Sc, KV=KV, G=G, hd=hd, dtype="bfloat16",
                           lengths=lengths.tolist(), shard_len=Sc // S),
         decode_launches=dec_launches,
         decode_tc_launches=dec_tc_launches, decode_max_abs_err=dec_err,
         decode_sharded_ms=dec_ms, decode_whole_ms=dec_whole_ms,
         decode_sharded_device_ms=dec_dev_ms,
         decode_whole_device_ms=dec_whole_dev_ms,
         decode_wrapper_host_us=dec_host_us,
         peak_mem_gb=peak_gb())
    return dict(launches=hash_run["launches"] + tenant_run["launches"],
                max_abs_err=max(hash_run["max_abs_err"],
                                tenant_run["max_abs_err"], long_err),
                decode_launches=dec_launches,
                decode_tc_launches=dec_tc_launches, decode_err=dec_err)


def other_card_launches(cards):
    """Every ctypes entry point launched with its tensors on a card that
    is not the current one (the dense, paged, fused and slot-lane scans,
    the compaction, flash and decode attention), held bit for bit to the
    same launches on ``cards[0]``, the current card. Returns the cards
    checked."""
    from repro_torch.kernels.arena_scan.stages import ScanSpec
    rng = np.random.default_rng(SEED + 13)
    N, D, B, G, k, T, QT = 4096, 128, 8, 3, 10, 16, 4
    emb, meta, _ = make_arena(rng, N, D)
    q, preds, gids = make_batch(rng, emb, B, G)
    lex = (rng.integers(-1, 512, (N, T)).astype(np.int32),
           rng.random((N, T)).astype(np.float32),
           rng.integers(0, 512, (B, QT)).astype(np.int32),
           rng.random((B, QT)).astype(np.float32))
    members = make_cand(rng, 2048, N).reshape(16, 128)
    clusters = np.arange(0, 16, 2, dtype=np.int32)
    Ba, Sa, KV, Ga, hd = 2, 640, 2, 4, 128
    qa, ka, va = (rng.standard_normal(s).astype(np.float32) for s in (
        (Ba, Sa, KV, Ga, hd), (Ba, Sa, KV, hd), (Ba, Sa, KV, hd)))
    qd = rng.standard_normal((Ba, KV, Ga, hd)).astype(np.float32)
    lengths = np.array([300, Sa], np.int32)

    def launches(c):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(c)
        args = (t(q), t(emb), t(meta), t(gids), t(preds))
        out = [kernel_mod.arena_scan_cuda(*args, k),
               kernel_mod.arena_scan_cuda(*args, k, page_rows=512),
               kernel_mod.arena_scan_cuda(*args, k, spec=ScanSpec("fused"),
                                          lex=tuple(map(t, lex)))]
        cand, n_live = kernel_mod.arena_scan_compact_cuda(
            t(members), t(np.zeros(0, np.int32)), t(clusters), N)
        out += [(cand, n_live), kernel_mod.arena_scan_probe_cuda(
            *args[:3], cand, t(preds[0]), k, n_live=n_live)]
        bf = lambda a: t(a).to(torch.bfloat16)
        out.append((fa_mod.flash_attention_cuda(bf(qa), bf(ka), bf(va),
                                                causal=True),))
        out.append(dec_mod.decode_attention_cuda(bf(qd), bf(ka), bf(va),
                                                 t(lengths)))
        return [tuple(x.cpu() for x in o) for o in out]

    check(torch.cuda.current_device() == cards[0].index,
          f"the current card is not {cards[0]}")
    want = launches(cards[0])
    for c in cards[1:]:
        got = launches(c)
        check(torch.cuda.current_device() == cards[0].index,
              "a launch moved the current card")
        for j, (a, b) in enumerate(zip(got, want)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"launch {j} on {c} != the same launch on {cards[0]}")
    return [str(c) for c in cards[1:]]


def region_keeps(snap, preds):
    """Each predicate's (N,) keep mask over a store held in allocations,
    computed on each allocation's card and laid end to end on the first
    allocation's card (the controller)."""
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.arena_scan.stages import predicate_keep
    ctrl = snap["n_live"].device
    out = []
    for part in snap["allocs"]:
        c = part["emb"].device
        meta = _packed_meta(part["tenant"], part["updated_at"],
                            part["category"], part["acl"])
        out.append(predicate_keep(meta, torch.stack(
            [p.as_array(c) for p in preds])).to(ctrl))
    return torch.cat(out, 1)


def region_row(parts, name, a):
    """Global row ``a`` of column ``name`` over allocations ``parts`` (a
    store's, or a lexical snapshot's views), on its card."""
    for part in parts:
        if a < part[name].shape[0]:
            return part[name][a]
        a -= part[name].shape[0]
    raise IndexError(a)


def lists_equal(got, want):
    """Two (scores, slots) pairs, numpy or tensors, equal bit for bit."""
    g, w = ([x.cpu().numpy() if isinstance(x, torch.Tensor) else x
             for x in pair[:2]] for pair in (got, want))
    return same_bits(g[0], w[0]) and np.array_equal(g[1], w[1])


def one_tier(name, got, want, sig, keep):
    """`tiered_compare` of one tier's list: (scores, slots) (B, k) numpy
    against the plain top-k ``want`` of the masked signal ``sig`` (B, N)."""
    zeros = lambda x: np.zeros_like(x)
    return tiered_compare(name, (*got, zeros(got[1])), want,
                          [sig, sig[:, :0]], [keep, keep[:0]])


def plain_sorted(sig, k):
    """The plain top-k of (B, N) masked scores (ties to the lower slot):
    numpy (scores, slots, tiers 0)."""
    return union_topk(sig, sig[:, :0], k)


def regions_hybrid(db, groups, dim, n_batches, k, page_rows, sync_cards):
    """(a) of `phase_regions`: the hybrid engine over the regions' cards.
    32 match() requests in 4 tenant groups, k = 10, 3 terms of a live
    row's lanes each, q near that row: ``n_batches`` wsum and rrf batches
    (one FUSED or BOTH launch a card a batch), one paged wsum batch at
    ``page_rows``; every list bit for bit equal to the kernel run alone on
    each card and merged on the host, and within 1e-5 of a plain top-k
    whose BM25 is recounted from the global idf and avgdl; no leak; one
    launch under set_sync_debug_mode("error")."""
    from repro_torch.api.planner import PlannerConfig
    from repro_torch.core.store import row_starts
    from repro_torch.index.lexical.arena import allocations as lex_views
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.filtered_topk.ops import merge_positional
    from repro_torch.kernels.hybrid_score.ref import qidf_of, rrf_fuse

    snap, views = db.log.snapshot(), lex_views(db.lex.snapshot())
    parts = snap["allocs"]
    n_cards = len(parts)
    ctrl = snap["n_live"].device
    rng = np.random.default_rng(SEED + 14)
    probe = [db.session(p).search(np.ones(dim, np.float32)).newer_than(ts)
             .in_categories(c).plan().pred for p, ts, c in groups]
    keeps = region_keeps(snap, probe)
    qs, mts = [], []
    for r in range(32):
        rows = torch.nonzero(keeps[r % 4]).squeeze(1)
        a = int(rows[int(rng.integers(0, rows.numel()))])
        live = region_row(views, "terms", a).cpu().numpy()
        live = live[live >= 0]
        mts.append(tuple(int(x) for x in rng.choice(live, 3, replace=False)))
        v = region_row(parts, "emb", a).cpu().numpy() \
            + 0.02 * rng.standard_normal(dim).astype(np.float32)
        qs.append(v / np.linalg.norm(v))

    def plans(mode):
        out = []
        for r in range(32):
            p, ts, cats = groups[r % 4]
            out.append(db.session(p).search(qs[r]).newer_than(ts)
                       .in_categories(cats).match(mts[r]).fuse(mode)
                       .limit(k).plan())
        return out

    by_mode = {m: plans(m) for m in ("wsum", "rrf")}
    check(all(p.engine == "hybrid" for ps in by_mode.values() for p in ps),
          "regions: match() plans must pick 'hybrid'")
    for ps in by_mode.values():
        db.execute(ps, use_cache=False)              # warm-up
    sync_cards()
    # the main path's runs: the counts set to 0 just before, read after
    hyb_mod.LAUNCHES = 0
    st = db.stats
    lat, res = {}, {}
    for mode, ps in by_mode.items():
        lat[mode] = []
        for _ in range(n_batches):
            c0, t0_ = st.device_calls, st.terms_scanned
            t0 = time.perf_counter()
            res[mode] = db.execute(ps, use_cache=False)
            lat[mode].append((time.perf_counter() - t0) * 1e3)
            check(st.device_calls - c0 == 1,
                  f"regions {mode}: {st.device_calls - c0} device calls")
            check(st.terms_scanned - t0_ == sum(
                v["terms"].numel() for v in views),
                f"regions {mode}: terms_scanned +{st.terms_scanned - t0_}")
    launches = hyb_mod.LAUNCHES
    check(launches == 2 * n_batches * n_cards,
          f"regions: {launches} hybrid launches for {2 * n_batches} "
          f"batches on {n_cards} cards")

    # the paged regime: one wsum batch, one paged launch a card
    db.planner_cfg = PlannerConfig(paged_min_rows=1, page_rows=page_rows)
    paged = plans("wsum")
    check(all(p.page_rows == page_rows for p in paged),
          "regions: the paged plans carry no page size")
    db.execute(paged, use_cache=False)
    sync_cards()
    kernel_mod.PAGED_LAUNCHES = 0
    t0 = time.perf_counter()
    res_paged = db.execute(paged, use_cache=False)
    paged_ms = (time.perf_counter() - t0) * 1e3
    paged_launches = kernel_mod.PAGED_LAUNCHES
    db.planner_cfg = PlannerConfig()
    check(paged_launches == n_cards,
          f"regions: {paged_launches} paged launches on {n_cards} cards")
    check(lists_equal(res_paged, res["wsum"]),
          "regions: the paged wsum batch != the resident one")

    # the kernel alone on each card (the executor's inputs: rows stacked
    # by group, 4 groups, QT 4), the lists merged on the host by position
    order = [r for g in range(4) for r in range(g, 32, 4)]
    inv = np.argsort(order)

    def alone(mode, page=None):
        ps = by_mode[mode]
        outs = []
        for lo, part, view in zip(row_starts(snap), parts, views):
            c = part["emb"].device
            q = torch.from_numpy(np.concatenate(
                [ps[r].logical.q for r in order])).to(c)
            gids = torch.tensor([g for g in range(4) for _ in range(8)],
                                dtype=torch.int32, device=c)
            preds = torch.stack([ps[g].pred.as_array(c) for g in range(4)])
            qt = torch.full((32, 4), -1, dtype=torch.int32, device=c)
            qt[:, :3] = torch.tensor([ps[r].logical.match_terms
                                      for r in order], dtype=torch.int32,
                                     device=c)
            meta = _packed_meta(part["tenant"], part["updated_at"],
                                part["category"], part["acl"])
            out = hyb_mod.hybrid_score_cuda(
                q, part["emb"], meta, view["terms"], view["lexnorm"], gids,
                preds, qt, qidf_of(view["idf"], qt).contiguous(), k,
                mode=mode, page_rows=page)
            outs.append((lo, out))
        outs = [(lo, [x.cpu() for x in out]) for lo, out in outs]
        merged = []
        for j in range(0, len(outs[0][1]), 2):
            merged += merge_positional(
                [o[j] for _, o in outs],
                [torch.where(o[j + 1] >= 0, o[j + 1] + lo, -1)
                 for lo, o in outs], k)
        signals = [tuple(x.numpy()[inv] for x in merged[j:j + 2])
                   for j in range(0, len(merged), 2)]
        if mode == "rrf":
            merged = rrf_fuse(*merged, k, RRF_C)
        return tuple(x.numpy()[inv] for x in merged[:2]), signals

    want, signals = {}, {}
    for mode in ("wsum", "rrf"):
        want[mode], signals[mode] = alone(mode)
        check(lists_equal(res[mode], want[mode]),
              f"regions {mode}: lists != the kernel alone on each card "
              "merged on the host")
    check(lists_equal(alone("wsum", page_rows)[0], want["wsum"]),
          "regions: the paged kernel alone != the resident one")

    # plain: dense + BM25 recounted from every card's lanes (global df,
    # document count and length), masked, one top-k over all regions
    lcfg = db.lex.cfg
    V = lcfg.vocab_size
    df = sum(torch.bincount(torch.where(v["terms"] >= 0, v["terms"], V)
                            .reshape(-1).long(), minlength=V + 1)[:V].cpu()
             for v in views).numpy().astype(np.float64)
    total_len = sum(int(torch.where(v["terms"] >= 0, v["tfs"], 0).sum())
                    for v in views)
    n_docs = sum(int((v["terms"] >= 0).any(dim=1).sum()) for v in views)
    idf_np = np.maximum(np.log1p((n_docs - df + 0.5) / (df + 0.5)),
                        0.0).astype(np.float32)
    avgdl = total_len / max(n_docs, 1)

    def lexnorm(tfs):
        tf = tfs.to(torch.float32)
        dl = tfs.sum(dim=1, keepdim=True).to(torch.float32)
        avg = torch.clamp(torch.tensor(avgdl, dtype=torch.float32,
                                       device=tfs.device), min=1.0)
        return tf * (lcfg.k1 + 1.0) / (tf + lcfg.k1 * (
            1.0 - lcfg.b + lcfg.b * dl / avg))

    errs, skipped = [], 0
    for g in range(4):
        rows = list(range(g, 32, 4))
        keep = keeps[g]
        sig = {"dense": [], "bm25": []}
        for part, view in zip(parts, views):
            c = part["emb"].device
            q = torch.from_numpy(np.stack([qs[r] for r in rows])).to(c)
            qt = torch.tensor([mts[r] + (-1,) for r in rows],
                              dtype=torch.int32, device=c)
            idf = torch.from_numpy(idf_np).to(c)
            qidf = torch.where(qt >= 0, idf[qt.clamp(min=0).long()], 0.0)
            sig["dense"].append(torch.matmul(q, part["emb"].T).to(ctrl))
            sig["bm25"].append(plain_bm25(view["terms"],
                                          lexnorm(view["tfs"]), qt,
                                          qidf).to(ctrl))
        sig = {n: torch.cat(x, 1) for n, x in sig.items()}
        masked = {n: torch.where(keep, x, NEG) for n, x in sig.items()}
        wsum = torch.where(keep, sig["dense"] + sig["bm25"], NEG)
        s_g, i_g = (x[rows] for x in res["wsum"][:2])
        errs.append(one_tier(f"regions-wsum-g{g}", (s_g, i_g),
                             plain_sorted(wsum, k), wsum, keep))
        plain = {}
        for j, n in enumerate(("dense", "bm25")):
            s_n, i_n = (x[rows] for x in signals["rrf"][j])
            plain[n] = plain_sorted(masked[n], k)
            errs.append(one_tier(f"regions-rrf-{n}-g{g}", (s_n, i_n),
                                 plain[n], masked[n], keep))
        s_f, i_f = (x[rows] for x in res["rrf"][:2])
        for j, r in enumerate(rows):
            keys = lambda lst: [int(x) for x in lst[1][j] if x >= 0]
            got_n = {n: [int(x) for x in signals["rrf"][i][1][r] if x >= 0]
                     for i, n in enumerate(("dense", "bm25"))}
            if any(got_n[n] != keys(plain[n]) for n in plain):
                skipped += 1
                continue
            fused = plain_rrf(keys(plain["dense"]), keys(plain["bm25"]), k,
                              RRF_C)
            check([x for x in i_f[j] if x >= 0] == [x for _, x in fused],
                  f"regions rrf: row {r} differs from the plain fusion")
            check(np.allclose(s_f[j][:len(fused)], [x for x, _ in fused],
                              rtol=TOL, atol=TOL),
                  f"regions rrf: row {r} scores")
        del sig, masked, wsum
    check(skipped <= 4, f"regions rrf: {skipped} rows' per-signal lists "
          "tie-differ from the plain ones (expected few)")

    # no host sync in RagDB.launch of a hybrid batch across the cards
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = db.launch(by_mode["rrf"], use_cache=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s_l, i_l, _ = db.finish(pending)
    check(lists_equal((s_l, i_l), res["rrf"]),
          "regions: launch / finish rows != execute rows (rrf)")
    return dict(batch_ms_median={m: statistics.median(v)
                                 for m, v in lat.items()},
                batch_ms=lat, paged_batch_ms=paged_ms,
                launches=launches, paged_launches=paged_launches,
                launches_per_batch=launches // (2 * n_batches),
                rrf_rows_skipped=skipped, max_abs_err=max(errs),
                plans={m: ps for m, ps in by_mode.items()},
                rows=res)


def regions_ivf(db, groups, n_batches, k, sync_cards, ccfg, gen, n_rows):
    """(b) of `phase_regions`: `build_index()` over the allocations (each
    card assigns its rows, the controller reduces) and ivf_prod's plans:
    one compaction and one PROBE launch a card a batch, the lists bit for
    bit equal to the per-card kernels merged on the host and within 1e-5
    of a plain top-k over the probed clusters' rows, recall@1 and @10
    against the exact engine printed, rows_scanned the reference's padded
    count, a write batch patching every card's mirror."""
    from repro_torch.core import ivf as ivf_core
    from repro_torch.core.store import row_starts
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.filtered_topk.ops import merge_positional

    spent = {"kmeans": 0.0}
    kmeans = ivf_core._kmeans_allocations

    def timed(*a, **kw):
        sync_cards()
        t0 = time.perf_counter()
        out = kmeans(*a, **kw)
        sync_cards()
        spent["kmeans"] += time.perf_counter() - t0
        return out

    ivf_core._kmeans_allocations = timed
    try:
        t0 = time.perf_counter()
        ix = db.build_index()
        build_s = time.perf_counter() - t0
    finally:
        ivf_core._kmeans_allocations = kmeans
    snap = db.log.snapshot()
    parts = snap["allocs"]
    n_cards = len(parts)
    check(ix.regions is not None and len(ix.device_arrays()["regions"])
          == n_cards, "regions: one IVF mirror a card")
    listed = int(ix.fill.sum()) + len(ix.overflow)
    check(listed == int(snap["n_live"]),
          f"regions: {listed} slots listed of {int(snap['n_live'])} live")
    kmeans_check = regions_kmeans_check(parts, snap["n_live"].device)

    # 32 admin requests with a recency bound only, each q near a live row
    # that clears it
    min_ts = groups[3][1]
    admin = db.admin_session()
    rng = np.random.default_rng(SEED + 15)
    pred = admin.search(np.ones(ix.centroids.shape[1], np.float32)) \
        .newer_than(min_ts).plan().pred
    keep = region_keeps(snap, [pred])[0]
    rows = torch.nonzero(keep).squeeze(1)
    anchors = [int(rows[int(rng.integers(0, rows.numel()))])
               for _ in range(32)]
    a_emb = np.stack([region_row(parts, "emb", a).cpu().numpy()
                      for a in anchors])
    qs = a_emb + 0.02 * rng.standard_normal(a_emb.shape).astype(np.float32)
    plans = [admin.search(qs[r]).newer_than(min_ts).limit(k).plan()
             for r in range(32)]
    check(all(p.engine == "ivf" for p in plans),
          "regions: plans must pick 'ivf'")
    exact = [admin.search(qs[r]).newer_than(min_ts).limit(k).using("cuda")
             .plan() for r in range(32)]
    db.execute(plans, use_cache=False)               # warm-up (patches)
    sync_cards()
    st = db.stats
    ivf_mod.LAUNCHES = ivf_mod.COMPACT_LAUNCHES = kernel_mod.LAUNCHES = 0
    lat = []
    nprobe = ix.cfg.nprobe
    for _ in range(n_batches):
        r0 = st.rows_scanned
        t0 = time.perf_counter()
        s, sl, _ = db.execute(plans, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(st.rows_scanned - r0 == ix.candidate_rows(nprobe, 32),
              f"regions ivf: rows_scanned +{st.rows_scanned - r0}")
    launches = (ivf_mod.LAUNCHES, ivf_mod.COMPACT_LAUNCHES)
    check(launches == (n_batches * n_cards,) * 2,
          f"regions ivf: {launches} probe / compaction launches for "
          f"{n_batches} batches on {n_cards} cards")
    check(kernel_mod.LAUNCHES == 0, "regions ivf: a batch ran a rescan")

    # the per-card kernels alone over each card's mirror, merged on the host
    ctrl = snap["n_live"].device
    q_d = torch.from_numpy(np.stack([p.logical.q[0] for p in plans])).to(
        ctrl)
    clusters = ix.probe_device(q_d, nprobe)
    mirrors = ix.device_arrays()["regions"]
    outs = []
    for lo, part, m in zip(row_starts(snap), parts, mirrors):
        c = part["emb"].device
        meta = _packed_meta(part["tenant"], part["updated_at"],
                            part["category"], part["acl"])
        cand, n_live = ivf_mod.compact_candidates_cuda(
            m["members"], m["overflow"], clusters.to(c).contiguous(),
            part["emb"].shape[0])
        outs.append((lo, ivf_mod.ivf_probe_cuda(
            q_d.to(c).contiguous(), part["emb"], meta, cand,
            pred.as_array(c), k, n_live=n_live)))
    outs = [(lo, [x.cpu() for x in o]) for lo, o in outs]
    h_s, h_i = merge_positional(
        [o[0] for _, o in outs],
        [torch.where(o[1] >= 0, o[1] + lo, -1) for lo, o in outs], k)
    check(lists_equal((s, sl), (h_s, h_i)),
          "regions ivf: lists != the per-card kernels merged on the host")
    # the plain probe: each request's exact top-k over the live rows of
    # the probed clusters and the overflow tail that pass the predicate
    cl = clusters.cpu().numpy()
    cand = np.concatenate([ix.members[cl[cl >= 0]].reshape(-1),
                           np.asarray(ix.overflow, np.int64)])
    in_cand = torch.zeros(sum(p["emb"].shape[0] for p in parts),
                          dtype=torch.bool, device=ctrl)
    in_cand[torch.from_numpy(cand[cand >= 0]).to(ctrl)] = True
    keep_c = keep & in_cand
    errs = []
    for lo_r in range(0, 32, 8):
        sig = torch.cat([torch.matmul(q_d[lo_r:lo_r + 8].to(
            p["emb"].device), p["emb"].T).to(ctrl) for p in parts], 1)
        sig = torch.where(keep_c, sig, NEG)
        errs.append(one_tier(f"regions-ivf-rows{lo_r}",
                             (s[lo_r:lo_r + 8], sl[lo_r:lo_r + 8]),
                             plain_sorted(sig, k), sig, keep_c))
        del sig
    del in_cand, keep_c
    # recall against the exact engine, printed as ivf_prod prints it: on
    # this corpus a query's neighbours past its first are scattered over
    # its topic, so it is low at any small nprobe (ivf_prod's one-card
    # index reads the same)
    s_x, i_x, _ = db.execute(exact, use_cache=False)
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(sl, i_x))
    recall = hits / float((i_x >= 0).sum())
    recall_1 = float(np.mean(sl[:, 0] == i_x[:, 0]))
    n_leaks = regions_leaks(db, plans, sl)
    check(n_leaks == 0, f"regions ivf: {n_leaks} leaked slots")

    # no host sync at launch
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = db.launch(plans, use_cache=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s_l, i_l, _ = db.finish(pending)
    check(lists_equal((s_l, i_l), (s, sl)),
          "regions ivf: launch / finish rows != execute rows")

    # a write batch: a doc at request 0's query, fresh; every card's mirror
    # is patched for the dirty clusters only, and the doc is found
    wb = device_corpus_batch(ccfg, n_rows, 64, gen, qs[0])
    patches = ix.mirror_patches
    db.ingest(wb)
    s_w, i_w, _ = db.execute(plans, use_cache=False)
    check(ix.mirror_patches == patches + 1,
          "regions ivf: the write patched no mirror")
    check(int(i_w[0, 0]) == db.log.slot_of(int(wb.doc_id[0])),
          "regions ivf: the written doc does not top request 0")
    return dict(build_s=build_s, kmeans_s=spent["kmeans"],
                layout_s=build_s - spent["kmeans"], clusters=ix.n_clusters,
                cluster_cap=ix.cluster_cap, overflow=len(ix.overflow),
                batch_ms_median=statistics.median(lat), batch_ms=lat,
                launches=launches[0], compact_launches=launches[1],
                candidate_rows=ix.candidate_rows(nprobe, 32),
                recall_at_10=recall, recall_at_1=recall_1, leaks=n_leaks,
                max_abs_err=max(errs), kmeans_check=kmeans_check,
                mirror_bytes=ix.mirror_bytes_uploaded)


def regions_kmeans_check(parts, ctrl, rows=1 << 18, n_clusters=256,
                         iters=3, seed=0, rel_tol=3e-4):
    """The build's cross-card k-means held, step by step, to plain Lloyd
    steps on one card: the first ``rows`` rows of every allocation
    clustered where they lie (`core.ivf._kmeans_allocations`, each card
    summing its rows, the controller adding), the centroids each card is
    handed recorded at every step. The seeds must equal bit for bit those
    drawn over the same rows concatenated on the controller ``ctrl``
    (they depend on the live rows alone), every card must be handed the
    same bits at every step, and each step's result must be within
    ``rel_tol`` (Frobenius, relative) of one plain step on the
    concatenated rows from the same centroids: only the order of the f32
    sums differs there. Whole runs are not compared with each other: a
    row whose two nearest centroids tie within rounding changes cluster,
    and over several steps that moves the centroids by far more than the
    rounding. A card's sums left out of the reduction move every
    centroid by the noise of a quarter of its rows, and a seed or a
    centroid read from the wrong card moves it further."""
    from repro_torch.core import ivf as ivf_core
    n = min(rows, *(p["emb"].shape[0] for p in parts))
    embs = [p["emb"][:n] for p in parts]
    lives = [p["tenant"][:n] >= 0 for p in parts]
    one_e = torch.cat([e.to(ctrl) for e in embs])
    one_l = torch.cat([x.to(ctrl) for x in lives])
    handed = []
    real = ivf_core._sums

    def record(emb, live, cent):
        handed.append(cent.to(ctrl))
        return real(emb, live, cent)
    ivf_core._sums = record
    try:
        last = ivf_core._kmeans_allocations(embs, lives, n_clusters, iters,
                                            seed, ctrl)
    finally:
        ivf_core._sums = real
    seeds_one = ivf_core._kmeans_allocations([one_e], [one_l], n_clusters,
                                             0, seed, ctrl)
    steps = [handed[i:i + len(parts)]
             for i in range(0, len(handed), len(parts))]
    check(len(steps) == iters and all(
        torch.equal(c, cs[0]) for cs in steps for c in cs),
        "regions ivf: the cards were handed different centroids")
    check(torch.equal(steps[0][0], seeds_one),
          "regions ivf: the cross-card seeds != one card's")
    e_live = one_e[one_l]
    errs = []
    for t in range(iters):
        prev = steps[t][0]
        got = steps[t + 1][0] if t + 1 < iters else last
        a = ivf_core._assign(e_live, prev)
        sums = torch.zeros_like(prev).index_add_(0, a, e_live)
        counts = torch.bincount(a, minlength=n_clusters).float()
        want = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1)[:, None], prev)
        want = want / torch.linalg.vector_norm(
            want, dim=1, keepdim=True).clamp(min=1e-12)
        errs.append(float(torch.linalg.vector_norm(got - want)
                          / torch.linalg.vector_norm(want)))
    check(max(errs) <= rel_tol,
          f"regions ivf: a cross-card Lloyd step differs from one card's "
          f"by {max(errs):.3g} (relative) > {rel_tol}")
    del one_e, one_l, e_live
    return dict(rows=n * len(parts), clusters=n_clusters, iters=iters,
                step_rel_err=errs)


def device_corpus_batch(ccfg, first, n, gen, q):
    """``n`` fresh docs from ``first``: the first one at ``q`` and now."""
    from repro_torch.data.corpus import device_corpus
    wb = device_corpus(ccfg, first, n, gen)
    emb = wb.emb.clone()
    emb[0] = torch.from_numpy(q / np.linalg.norm(q)).to(emb.device)
    ts = wb.updated_at.clone()
    ts[0] = ccfg.now_ts
    return dataclasses.replace(wb, emb=emb, updated_at=ts)


def regions_leaks(db, plans, sl):
    """Returned slots failing their plan's predicate (host mask over the
    gathered metadata)."""
    from repro_torch.core.store import gather
    snap = db.log.snapshot()
    flat = np.maximum(sl, 0).reshape(-1)
    meta = np.stack([np.asarray(gather(snap, c, flat)).reshape(sl.shape)
                     for c in ("tenant", "updated_at", "category", "acl")],
                    -1)
    bad = 0
    for r, p in enumerate(plans):
        ok = host_mask(meta[r], p.pred.as_array().numpy()[None])[0]
        bad += int((~ok & (sl[r] >= 0)).sum())
    return bad


def regions_pieces(dev, devices, dim, k, dec_shape=(8, 2064, 8, 4, 128),
                   n_rows=None):
    """(d) of `phase_regions`: `filtered_topk_sharded` and
    `decode_attention_sharded` at sharded_prod's (e) and (f) shapes with
    each shard's piece on its own card, bit for bit equal to the same
    shards on one card (``dev``), one launch a shard."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.filtered_topk.ops import filtered_topk_sharded
    from repro_torch.launch.mesh import device_groups, make_mesh, same_device

    S = len(devices)
    n_rows = n_rows or prod_cut()[0]
    mesh = make_mesh((S,), ("data",), devices=devices)
    one = make_mesh((S,), ("data",), devices=[dev] * S)
    groups = device_groups(mesh, "data")
    gd = torch.Generator(device=dev).manual_seed(SEED + 16)
    emb = torch.randn((n_rows, dim), generator=gd, device=dev)
    emb.div_(torch.linalg.vector_norm(emb, dim=1, keepdim=True))
    ri = lambda hi: torch.randint(0, hi, (n_rows,), generator=gd, device=dev,
                                  dtype=torch.int32)
    meta = torch.stack([ri(20), ri(1 << 20), ri(5), ri(4) + 1], 1)
    q8 = emb[:8] + 0.05 * torch.randn((8, dim), generator=gd, device=dev)
    pred = torch.tensor([3, 1 << 18, 0b10111, 3], dtype=torch.int32,
                        device=dev)
    per = n_rows // S

    def pieces(x, axis=0):
        out = []
        for c, shards in groups:
            lo, hi = shards[0] * x.shape[axis] // S, \
                (shards[-1] + 1) * x.shape[axis] // S
            piece = x.narrow(axis, lo, hi - lo)
            out.append(piece if same_device(c, dev) else piece.to(c))
        return out

    e_p, m_p = pieces(emb), pieces(meta)
    kernel_mod.LAUNCHES = 0
    s_p, i_p = filtered_topk_sharded(mesh, "data", q8, e_p, m_p, pred, k)
    ft_launches = kernel_mod.LAUNCHES
    check(ft_launches == S, f"regions: filtered_topk_sharded {ft_launches} "
          f"launches for {S} shards")
    s_w, i_w = filtered_topk_sharded(one, "data", q8, emb, meta, pred, k)
    check(lists_equal((s_p, i_p), (s_w, i_w)),
          "regions: filtered_topk_sharded over the cards != on one card")
    check(bool((i_p >= 0).any()) and i_p.device == q8.device,
          "regions: filtered_topk_sharded found nothing")
    ft_ms = events_ms(lambda: filtered_topk_sharded(
        mesh, "data", q8, e_p, m_p, pred, k), 6)
    del emb, meta, e_p, m_p

    B, Sc, KV, G, hd = dec_shape
    bf = dict(generator=gd, device=dev, dtype=torch.bfloat16)
    qd = torch.randn((B, KV * G, hd), **bf)
    kc = torch.randn((B, Sc, KV, hd), **bf)
    vc = torch.randn((B, Sc, KV, hd), **bf)
    lengths = torch.tensor([min(2049, Sc)] * (B - 1)
                           + [max(1, Sc // S // 2)], dtype=torch.int32,
                           device=dev)
    k_p, v_p = pieces(kc, 1), pieces(vc, 1)
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    out = dec_ops.decode_attention_sharded(mesh, "data", qd, k_p, v_p,
                                           lengths, n_kv=KV)
    dec_launches, dec_tc_launches = dec_mod.LAUNCHES, dec_mod.TC_LAUNCHES
    check(dec_launches == S and dec_tc_launches
          == S * dec_mod.uses_tc(kc.dtype, hd),
          f"regions: decode_attention_sharded {dec_launches} launches for "
          f"{S} shards, {dec_tc_launches} of the tensor-core body")
    whole = dec_ops.decode_attention_sharded(one, "data", qd, kc, vc,
                                             lengths, n_kv=KV)
    check(torch.equal(out, whole) and bool(torch.isfinite(out).all()),
          "regions: decode_attention_sharded over the cards != on one card")
    dec_ms = events_ms(lambda: dec_ops.decode_attention_sharded(
        mesh, "data", qd, k_p, v_p, lengths, n_kv=KV), 20)
    return dict(filtered_topk_launches=ft_launches, filtered_topk_ms=ft_ms,
                decode_launches=dec_launches,
                decode_tc_launches=dec_tc_launches, decode_ms=dec_ms,
                rows=n_rows,
                rows_per_shard=per, dec_shape=list(dec_shape))


def phase_regions(dev, cards=None, rows_per_card=None, dim=None,
                  chunk=1 << 20, n_batches=6, write_rows=1 << 12,
                  page_rows=1 << 15, tier_kw=None):
    """Arena regions on their own cards: a RagDB with lanes over a mesh of
    4 shards on ``cards`` (every card present by default; ``cards[s * n //
    4]`` holds shard s), ``rows_per_card`` rows on the fullest card, hash
    then tenant placement: sharded_prod's plans, (a) the hybrid engine
    (`regions_hybrid`), a write batch's commit, and under hash (b) the
    IVF index (`regions_ivf`); then (d) the sharded entry points over
    pieces on the cards (`regions_pieces`) and (c) tiered_prod's
    deployment with its hot arena in the 4 regions (``tier_kw``
    overrides its sizes). With
    fewer than two cards it emits that and computes nothing. Returns the
    launches of the main path's runs, a kernel each, and the largest
    errors for the kernels line."""
    from repro_torch.api import RagDB
    from repro_torch.configs import rag_unified
    from repro_torch.core.store import ALLOCS, gather
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import DAY_S, CorpusConfig, device_corpus
    from repro_torch.index.lexical import LexicalConfig
    from repro_torch.kernels.arena_scan.ops import _packed_meta
    from repro_torch.kernels.arena_scan.sharded import INT32_MAX
    from repro_torch.launch.mesh import make_mesh

    if cards is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    n = len(cards)
    if n < 2:
        emit("regions", cards=n, result=None,
             note="arena regions on their own cards need at least two "
                  "cards; nothing was run")
        return {}
    t_phase = time.perf_counter()
    S, k = 4, 10
    devices = [cards[s * n // S] for s in range(S)]
    used = list(dict.fromkeys(devices))
    n_local = (rows_per_card or prod_cut()[0]) // max(
        devices.count(c) for c in used)
    n_rows, dim = S * n_local, dim or prod_cut()[1]
    n_docs = n_rows - max(n_rows // 128, 16 * int(np.sqrt(n_rows)))
    mesh = make_mesh((S,), ("data",), devices=devices)
    ccfg = CorpusConfig(n_docs=n_docs, dim=dim, n_tenants=20, n_categories=5)
    rng = np.random.default_rng(SEED + 9)
    qs = rng.standard_normal((32, dim)).astype(np.float32)
    groups = [(Principal(t, 0xFF), ccfg.now_ts - d * DAY_S, c)
              for t, d, c in ((2, 90, [0, 1]), (5, 150, [2, 3]),
                              (11, 45, [4]), (19, 170, [0, 2, 4]))]
    on_card = [c.type == "cuda" for c in used]

    def sync_cards():
        for c, cuda in zip(used, on_card):
            if cuda:
                torch.cuda.synchronize(c)

    def peaks():
        return [torch.cuda.max_memory_allocated(c) / 1e9 if cuda else None
                for c, cuda in zip(used, on_card)]

    def plans_of(db, engine="sharded"):
        return [db.session(p).search(qs[r]).newer_than(ts).in_categories(cats)
                .limit(k).using(engine).plan()
                for r in range(32) for p, ts, cats in [groups[r % 4]]]

    def host_lists(db, plans, fn):
        """Each group's regions scanned alone on their cards by the kernel
        (k + 1, as the engine launches it), the lists merged on the host
        by (score desc, doc_id asc): (scores (32, k), slots (32, k))."""
        snap = db.log.snapshot()
        out_s = np.full((32, k), np.finfo(np.float32).min, np.float32)
        out_i = np.full((32, k), -1, np.int32)
        for g in range(4):
            rows = list(range(g, 32, 4))
            pred = plans[g].pred
            cand = []
            for part, (_, shards) in zip(snap[ALLOCS], fn.groups):
                c = part["emb"].device
                meta = _packed_meta(part["tenant"], part["updated_at"],
                                    part["category"], part["acl"])
                q = torch.from_numpy(np.concatenate(
                    [plans[r].logical.q for r in rows])).to(c)
                gids = torch.zeros(len(rows), dtype=torch.int32, device=c)
                for sh in shards:
                    if sh not in fn.active(pred.tenant):
                        continue
                    lo = (sh - shards[0]) * n_local
                    s_r, i_r = kernel_mod.arena_scan_cuda(
                        q, part["emb"][lo:lo + n_local],
                        meta[lo:lo + n_local], gids,
                        pred.as_array(c)[None].contiguous(), k + 1)
                    s_r, i_r = s_r.cpu().numpy(), i_r.cpu().numpy()
                    glob = np.where(i_r >= 0, i_r + sh * n_local, -1)
                    cand.append((s_r, glob))
            s_all = np.concatenate([a for a, _ in cand], 1)
            g_all = np.concatenate([b for _, b in cand], 1)
            live = g_all >= 0
            d_all = np.full(g_all.shape, INT32_MAX, np.int64)
            d_all[live] = gather(snap, "doc_id", g_all[live])
            for j, r in enumerate(rows):
                order = np.lexsort((d_all[j], -s_all[j].astype(np.float64)))
                top = order[:k]
                out_s[r] = s_all[j][top]
                out_i[r] = np.where(s_all[j][top] > np.finfo(
                    np.float32).min, g_all[j][top], -1)
        return out_s, out_i

    def leaks(db, plans, sl):
        snap = db.log.snapshot()
        flat = np.maximum(sl, 0).reshape(-1)
        meta = np.stack([np.asarray(gather(snap, c, flat)).reshape(sl.shape)
                         for c in ("tenant", "updated_at", "category",
                                   "acl")], -1)
        bad = 0
        for r, p in enumerate(plans):
            ok = host_mask(meta[r], p.pred.as_array().numpy()[None])[0]
            bad += int((~ok & (sl[r] >= 0)).sum())
        return bad

    def run(placement):
        db = RagDB(dataclasses.replace(rag_unified.PRODUCTION,
                                       capacity=n_rows, dim=dim),
                   mesh=mesh, placement=placement, device=dev,
                   lexical_cfg=LexicalConfig())
        # after the db's first allocation on each card: a card the caching
        # allocator has not used yet refuses the reset
        for c, cuda in zip(used, on_card):
            if cuda:
                torch.cuda.reset_peak_memory_stats(c)
        snap = db.log.snapshot()
        check([(p["emb"].device, p["emb"].shape[0]) for p in snap[ALLOCS]]
              == [(torch.device("cpu") if c.type == "cpu" else c,
                   devices.count(c) * n_local) for c in used],
              f"{placement}: allocations {[p['emb'].device for p in snap[ALLOCS]]}")
        del snap
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        for start in range(0, n_docs, chunk):
            db.ingest(device_corpus(ccfg, start, min(chunk, n_docs - start),
                                    gen))
        sync_cards()
        ingest_s = time.perf_counter() - t0
        check(int(db.log.snapshot()["n_live"]) == n_docs, "n_live")
        plans, cuda_plans = plans_of(db), plans_of(db, "cuda")
        db.execute(plans, use_cache=False)            # warm-up
        db.execute(cuda_plans, use_cache=False)
        sync_cards()

        # the main path's run: the counts set to 0 just before, read after
        fn = db._sharded_fn(k)
        per_batch = [fn.active(p.pred.tenant) for p in plans[:4]]
        rows0 = list(db.stats.shard_rows_scanned)
        kernel_mod.LAUNCHES = 0
        lat = []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            s, sl, _ = db.execute(plans, use_cache=False)
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = kernel_mod.LAUNCHES
        rows = [a - b for a, b in zip(db.stats.shard_rows_scanned, rows0)]
        check(launches == n_batches * sum(map(len, per_batch)),
              f"{placement}: {launches} launches for {n_batches} batches "
              f"of {sum(map(len, per_batch))} region scans")
        check(rows == [n_batches * n_local * sum(sh in a for a in per_batch)
                       for sh in range(S)], f"{placement}: rows {rows}")

        # each list against its regions' kernels alone, merged on the host
        s_h, sl_h = host_lists(db, plans, fn)
        check(same_bits(s, s_h) and (sl == sl_h).all(),
              f"{placement}: lists != the regions' kernels merged on the "
              "host")
        n_leaks = leaks(db, plans, sl)
        check(n_leaks == 0, f"{placement}: {n_leaks} leaked slots")

        # the exact engine: one fused launch a card, merged by position
        kernel_mod.LAUNCHES = 0
        lat_x = []
        for _ in range(n_batches):
            t0 = time.perf_counter()
            s_x, sl_x, _ = db.execute(cuda_plans, use_cache=False)
            lat_x.append((time.perf_counter() - t0) * 1e3)
        check(kernel_mod.LAUNCHES == n_batches * len(used),
              f"{placement}: exact engine {kernel_mod.LAUNCHES} launches")
        check(same_bits(s, s_x) and (sl == sl_x).all(),
              f"{placement}: the exact engine's lists != the sharded ones")

        # no host sync in RagDB.launch across the cards
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = db.launch(plans, use_cache=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        s_g, sl_g, _ = db.finish(pending)
        del pending
        check(same_bits(s_g, s) and (sl_g == sl).all(),
              "launch / finish rows != execute rows")

        # (a) the hybrid engine, one launch a card a batch
        hybrid = regions_hybrid(db, groups, dim, n_batches, k, page_rows,
                                sync_cards)
        hybrid.pop("plans")
        hybrid.pop("rows")

        # one write batch's commit: every card it writes copies its
        # allocation; under "tenant" a one-tenant batch leaves the others
        commits = {}
        batches = [("mixed", None)] + ([("one_tenant", 7)]
                                       if placement == "tenant" else [])
        for name, tenant in batches:
            wb = device_corpus(ccfg, n_docs, write_rows, gen)
            if tenant is not None:
                wb = dataclasses.replace(wb, tenant=torch.full_like(
                    wb.tenant, tenant))
            wb = dataclasses.replace(wb, doc_id=wb.doc_id + (
                len(commits) + 1) * n_rows)
            before = db.log.snapshot()[ALLOCS]
            sync_cards()
            t0 = time.perf_counter()
            db.ingest(wb)
            sync_cards()
            commits[name] = (time.perf_counter() - t0) * 1e3
            after = db.log.snapshot()[ALLOCS]
            kept = [a["emb"] is b["emb"] for a, b in zip(after, before)]
            if tenant is not None:
                owner = devices[tenant % S]
                check(kept == [c != owner for c in used],
                      f"one-tenant commit rebuilt {kept}")
            del before, after, wb
        # (b) the IVF index over the allocations, after the commits (whose
        # ms then count no index upkeep)
        ivf = (regions_ivf(db, groups, n_batches, k, sync_cards, ccfg, gen,
                           n_rows) if placement == "hash" else None)
        out = dict(ingest_s=ingest_s, batch_ms_median=statistics.median(lat),
                   batch_ms=lat, exact_batch_ms_median=statistics.median(
                       lat_x), exact_batch_ms=lat_x, launches=launches,
                   launches_per_batch=launches // n_batches,
                   shard_rows_scanned=rows, leaks=n_leaks,
                   commit_ms=commits, hybrid=hybrid, ivf=ivf,
                   peak_gb=peaks())
        del db, s_x, sl_x, s_g, sl_g
        gc.collect()
        for c, cuda in zip(used, on_card):
            if cuda:
                with torch.cuda.device(c):
                    torch.cuda.empty_cache()
        return out

    # each part's line as it ends, the phase's line after the last
    hash_run = run("hash")
    emit("regions_hash", **hash_run)
    tenant_run = run("tenant")
    emit("regions_tenant", **tenant_run)
    # (d) the sharded entry points, each shard's piece on its own card
    pieces = regions_pieces(dev, devices, dim, k)
    emit("regions_pieces", **pieces)
    gc.collect()
    for c in used:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
    # (c) the tiered deployment with its hot arena in the 4 regions
    tiered = phase_tiered_prod(dev, mesh=mesh, phase="regions_tiered",
                               **(tier_kw or {}))
    tiered = dict(launches=tiered["launches"],
                  dense_engine=tiered["dense_engine"],
                  shard_rows_scanned=tiered["shard_rows_scanned"],
                  batch_ms_median=tiered["batch_ms_median"],
                  max_abs_err=tiered["max_abs_err"],
                  peak_gb=tiered["peak_mem_gb"])
    gc.collect()
    other = (other_card_launches([c for c, cuda in zip(used, on_card)
                                  if cuda]) if all(on_card) else [])
    emit("regions", seconds=time.perf_counter() - t_phase, cards=n,
         devices=[str(c) for c in devices], controller=str(dev),
         rows=n_rows, rows_per_region=n_local, docs=n_docs, dim=dim,
         batch=32, groups=4, k=k, hash=hash_run, tenant=tenant_run,
         pieces=pieces, tiered=tiered,
         launches_off_the_current_card=other)
    runs = (hash_run, tenant_run)
    t_launch = lambda name: sum(v[name] for v in tiered["launches"].values())
    return dict(
        launches=sum(r["launches"] for r in runs) + t_launch("arena_scan")
        + pieces["filtered_topk_launches"],
        hybrid=sum(r["hybrid"]["launches"] for r in runs)
        + t_launch("hybrid_score"),
        hybrid_err=max(r["hybrid"]["max_abs_err"] for r in runs),
        paged=sum(r["hybrid"]["paged_launches"] for r in runs),
        ivf=hash_run["ivf"]["launches"],
        ivf_err=hash_run["ivf"]["max_abs_err"],
        compact=hash_run["ivf"]["compact_launches"],
        decode_simt=pieces["decode_launches"] - pieces["decode_tc_launches"],
        decode_tc=pieces["decode_tc_launches"],
        max_abs_err=tiered["max_abs_err"])


def attn_ok(got, want, rtol, atol):
    """(max abs error, max of |err| / (atol + rtol |want|)): the second is
    <= 1 exactly when allclose(got, want, rtol, atol) holds."""
    err = (got.float() - want.float()).abs()
    ratio = err / (atol + rtol * want.float().abs())
    return float(err.max()), float(ratio.max())


def flash_check(q, k, v, causal, what="", oracle_seen=None):
    """The flash kernel against its plain version (the chunked online
    softmax, 512-key blocks) and the f32 oracle on the same tensors;
    ``what`` names the case in a failure. With ``oracle_seen`` (a list:
    the rows past 256 of `phase_attn_kernel`) the oracle comparison is
    recorded there for the kernel and for the plain version instead of
    gating: both round P and V to bf16 as the reference does, and at f32,
    S 2064, G 8 / 71 the plain version itself lands 0.76-1.05x the
    tolerance off the oracle, the kernel as far (PERF.md); the
    gate against the plain version holds as everywhere."""
    o_k = fa_mod.flash_attention_cuda(q, k, v, causal=causal)
    o_p = fa_mod.flash_attention_plain(q, k, v, causal=causal, blk_q=512,
                                       blk_k=512)
    o_r = fa_ref(q, k, v, causal=causal)
    sync()
    err, ratio = attn_ok(o_k, o_p, FLASH_RTOL, FLASH_ATOL)
    err_r, ratio_r = attn_ok(o_k, o_r, FLASH_RTOL, FLASH_ATOL)
    oracle_ok = ratio_r <= 1
    if oracle_seen is not None:
        oracle_seen.append({"case": what.strip(" ()"), "kernel_x_tol": ratio_r,
                            "plain_x_tol": attn_ok(o_p, o_r, FLASH_RTOL,
                                                   FLASH_ATOL)[1]})
        oracle_ok = True
    check(ratio <= 1 and oracle_ok and torch.isfinite(o_k).all(),
          f"flash kernel off its plain version{what}: err {err} (x{ratio} "
          f"of the tolerance), oracle err {err_r} (x{ratio_r})")
    return err, err_r


def decode_ops_s(dt, hd, flops):
    """The least time of a decode call's ``flops`` -- the function's own,
    4 hd a query head and live key (Q . K^T and P . V) -- at the rate of
    the units of the body that runs it: the f32 rate for the SIMT body's
    FMAs, the tensor cores' bf16 rate for the tensor-core body (what its
    own schedule adds is `tc_products`, reported beside the bound)."""
    return flops / (BF16_FLOPS if dec_mod.uses_tc(dt, hd) else FP32_FLOPS)


def tc_products(hd, G, flops):
    """The tensor-core body's own products beside the function's ``flops``
    at G query heads a KV head: P . V taken three times (P's three bf16
    terms) makes 8 hd a head and key, twice the function's 4 hd, on wgmma
    rows that are a head block's heads padded to whole warpgroups of 64,
    at the launch width. The kernel's overhead, with its least time at the
    tensor cores' rate; not in the bound."""
    hdp = attn_lib.launch_width(torch.bfloat16, hd)[0]
    wg = dec_mod.TC_WG_HEADS
    n_hc = -(-G // (wg * dec_mod.TC_MAX_WGS))
    rows = n_hc * -(-(-(-G // n_hc)) // wg) * wg
    padded = rows * hdp / (G * hd)
    kernel_flops = 2 * flops * padded
    return {"function_gflop": flops / 1e9, "split_factor": 2,
            "padding_factor": padded, "kernel_gflop": kernel_flops / 1e9,
            "kernel_ops_ms": kernel_flops / BF16_FLOPS * 1e3}


def decode_check(q, kc, vc, lengths, what=""):
    """The decode kernel against its plain version: the normalised output,
    m and l, all f32 math on both sides; ``what`` names the case in a
    failure."""
    a_k, m_k, l_k = dec_mod.decode_attention_cuda(q, kc, vc, lengths)
    a_p, m_p, l_p = dec_mod.decode_attention_plain(q, kc, vc, lengths)
    sync()
    err, ratio = attn_ok(a_k / l_k, a_p / l_p, DEC_TOL, DEC_TOL)
    _, ratio_m = attn_ok(m_k, m_p, DEC_TOL, DEC_TOL)
    _, ratio_l = attn_ok(l_k, l_p, DEC_TOL, DEC_TOL)
    body = "tensor-core" if dec_mod.uses_tc(q.dtype, q.shape[-1]) else "SIMT"
    check(max(ratio, ratio_m, ratio_l) <= 1 and torch.isfinite(a_k).all(),
          f"decode kernel ({body} body) off its plain version{what}: out "
          f"err {err} (x{ratio}), m x{ratio_m}, l x{ratio_l} of the "
          "tolerance")
    return err


def attn_ptxas(log):
    """ptxas's registers and spills of every attention kernel
    instantiation: flash (f32 body by element type, width, EXACT and DEEP;
    bf16 wgmma body by width, key tile and EXACT; the bf16 body of rows
    past 256 by width and key tile) and decode (the SIMT body by element
    type, width, heads a P . V group, EXACT, DEEP; the tensor-core body by
    width and warpgroups)."""
    rows = []
    for name, rep in ptxas_kernels(log).items():
        m = re.search(r"(flash_fwd_wgmma_kernel|flash_fwd_deep_kernel|"
                      r"flash_fwd_kernel|decode_attention_kernel|"
                      r"decode_tc_kernel)"
                      r"I(f|13__nv_bfloat16)?"
                      r"((?:L[ib]\d+E)+)", name)
        if m:
            ints = [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3))]
            dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16",
                     None: "bfloat16"}[m.group(2)]
            rows.append({"kernel": m.group(1), "dtype": dtype,
                         "width": ints[0], "template": ints[1:], **rep})
    rows.sort(key=lambda r: (r["kernel"], r["dtype"], r["width"],
                             r["template"]))
    return rows


def attn_rule_check():
    """The C launchers' head-dim rule (``attention_launch_width``,
    ``attention_piece_cols``) equals `_attention.launch_width` /
    `row_pieces` at every hd in [0, 2100], both dtypes: the width a piece
    of a row runs at and the piece's columns, on the padded copy's row
    where the rule asks for one; hd 0 refused."""
    lib = attn_lib.load()
    n = 0
    for dt, code in attn_lib.DTYPES.items():
        for hd in range(0, 2101):
            try:
                width, copy = attn_lib.launch_width(dt, hd)
            except ValueError:
                width, copy = -1, False
            row = attn_lib.padded_head_dim(hd) if copy else hd
            got = lib.attention_launch_width(code, row)
            check(got == width, f"C rule gives width {got} for hd {hd} "
                                f"(row {row}, {dt}); Python {width}")
            check(not copy or lib.attention_launch_width(code, hd) == -1,
                  f"the C rule takes hd {hd} in place")
            if width > 0:
                pw = lib.attention_piece_cols(code, row)
                check(pw == attn_lib.row_pieces(dt, hd)[0],
                      f"C piece {pw} for hd {hd}, {dt}; Python "
                      f"{attn_lib.row_pieces(dt, hd)}")
            n += 1
    return n


def tc_info_check():
    """The wrapper's mirror of the tensor-core body's shared memory, key
    tile and ring stages (`tc_smem_bytes`, `tc_key_tile`, `tc_stages`)
    against the library's (``decode_attention_tc_info``) at every width,
    one and two warpgroups; the resident blocks an SM of each."""
    import ctypes
    lib = attn_lib.load()
    out = (ctypes.c_int * 4)()
    rows = {}
    for hdp in attn_lib.WIDTHS:
        for heads in (dec_mod.TC_WG_HEADS, 2 * dec_mod.TC_WG_HEADS):
            rc = lib.decode_attention_tc_info(hdp, heads, out)
            mirror = (dec_mod.tc_smem_bytes(hdp, heads),
                      dec_mod.tc_key_tile(hdp), dec_mod.tc_stages(hdp))
            check(rc == 0 and (out[0], out[2], out[3]) == mirror
                  and out[1] >= 1,
                  f"tensor-core body at width {hdp}, {heads} heads: C "
                  f"{tuple(out)} (rc {rc}), mirror {mirror}")
            rows[f"w{hdp}_h{heads}"] = {"smem": out[0],
                                        "blocks_per_sm": out[1],
                                        "key_tile": out[2], "stages": out[3]}
    return rows


def tile_rows_in_use(G):
    """(rows in use of the bf16 kernel's 128-row tile, of the f32 kernel's
    64-row tile, head chunk, chunks) at G query heads a KV head."""
    gc_, n_gc = fa_mod.head_chunks(G)
    return {"bf16_rows": fa_mod.TILE_ROWS // gc_ * gc_,
            "f32_rows": 64 // gc_ * gc_, "chunk_heads": gc_,
            "chunks": n_gc}


def phase_attn_kernel():
    """Both attention kernels against their plain versions over dtypes, G,
    hd, S (ragged and past the prefill shape) and, for decode, lengths 0,
    1, random and past S in one batch; then both dtypes at the edges of
    the tiles (G 3, S 127 / 129 / 2047); every width from 8 to 256 (and
    hd 6 and 100, the padded copy) at G 2, S 129; public models' (hd, G)
    at S 17 and 2064; a decode whose heads split into blocks; rows past
    256 (ATTN_DEEP_HD at G 2, S 129; ATTN_DEEP_WIDE_HD at G 71 and 8, S
    2064), with the decode kernel's resident blocks an SM at each. The C
    rule is held to the Python one, and ptxas's report of every
    instantiation printed."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    fa_mod.LAUNCHES = dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    errs = {"flash": {}, "flash_oracle": {}, "decode": {}, "decode_tc": {}}
    counts = {"cases": 0, "decode": 0, "tc": 0}

    #: rows past 256: the kernel's and the plain version's distance from
    #: the f32 oracle (recorded, not gated: `flash_check`)
    deep_oracle = []

    def decode_case(q, k, v, lengths, what):
        """The body the shape takes against the plain version."""
        name = str(q.dtype).split(".")[-1]
        tc = dec_mod.uses_tc(q.dtype, q.shape[-1])
        e = decode_check(q, k, v, lengths, what)
        row = errs["decode_tc" if tc else "decode"]
        row[name] = max(row.get(name, 0), e)
        counts["decode"] += 1
        counts["tc"] += tc

    def case(dt, G, hd, S, deep=False):
        name = str(dt).split(".")[-1]
        B, KV = 4, 2

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=DEV).to(dt)

        k, v = rnd(B, S, KV, hd), rnd(B, S, KV, hd)
        rand_len = int(torch.randint(1, S + 1, (1,), generator=gen,
                                     device=DEV))
        lengths = torch.tensor([0, 1, rand_len, S + 3], dtype=torch.int32,
                               device=DEV)
        what = f" ({name}, G {G}, hd {hd}, S {S})"
        decode_case(rnd(B, KV, G, hd), k, v, lengths, what)
        for causal in (True, False):
            e, e_r = flash_check(rnd(2, S, KV, G, hd), k[:2], v[:2], causal,
                                 f"{what[:-1]}, causal {causal})",
                                 deep_oracle if deep else None)
            errs["flash"][name] = max(errs["flash"].get(name, 0), e)
            errs["flash_oracle"][name] = max(
                errs["flash_oracle"].get(name, 0), e_r)
        counts["cases"] += 1

    for dt in (torch.bfloat16, torch.float32):
        for G in ATTN_G:
            for hd in ATTN_HD:
                for S in ATTN_S:
                    case(dt, G, hd, S)
    for dt in (torch.bfloat16, torch.float32):
        for G in ATTN_EDGE_G:
            for hd in ATTN_HD:
                for S in ATTN_EDGE_S:
                    if G not in ATTN_G or S not in ATTN_S:
                        case(dt, G, hd, S)
    t_sweep = time.perf_counter()
    for dt in (torch.bfloat16, torch.float32):
        for hd in ATTN_SWEEP_HD:
            case(dt, ATTN_SWEEP["G"], hd, ATTN_SWEEP["S"])
    public = {}
    for hd, G in ATTN_PUBLIC + ATTN_HEAD_BLOCKS:
        for S in ATTN_PUBLIC_S if (hd, G) in ATTN_PUBLIC else (129,):
            for dt in (torch.bfloat16, torch.float32):
                case(dt, G, hd, S)
        n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
        split, heads = dec_mod.block_heads(4, 2, G, ATTN_PUBLIC_S[-1], n_sm,
                                           hd, 4)
        tc_split, tc_heads = dec_mod.tc_plan(4, 2, G, ATTN_PUBLIC_S[-1],
                                             n_sm, hd)
        public[f"hd{hd}_G{G}"] = {
            "width": attn_lib.launch_width(torch.bfloat16, hd)[0],
            **tile_rows_in_use(G), "decode_split_f32_S2064": split,
            "decode_heads_a_block_f32": heads,
            "decode_tc_split_bf16_S2064": tc_split,
            "decode_tc_heads_a_block_bf16": tc_heads}
    check(public["hd256_G200"]["decode_heads_a_block_f32"] < 200
          and public["hd256_G200"]["decode_tc_heads_a_block_bf16"] < 200,
          "the head-block decode case does not split its heads")
    sweep_s = time.perf_counter() - t_sweep
    t_deep = time.perf_counter()
    deep = {}
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    lib = attn_lib.load()
    for hd, G, S in ([(hd, ATTN_SWEEP["G"], ATTN_SWEEP["S"])
                      for hd in ATTN_DEEP_HD]
                     + [(hd, G, ATTN_DEEP_WIDE_S) for G in ATTN_DEEP_WIDE_G
                        for hd in ATTN_DEEP_WIDE_HD]):
        for dt in (torch.bfloat16, torch.float32):
            case(dt, G, hd, S, deep=True)
            split, heads = dec_mod.block_heads(4, 2, G, S, n_sm, hd,
                                               dt.itemsize)
            blocks = lib.decode_attention_blocks_per_sm(
                attn_lib.DTYPES[dt], attn_lib.padded_head_dim(hd), heads,
                split)
            check(blocks >= 1, f"decode blocks an SM at hd {hd}, G {G}, "
                               f"{dt}: {blocks}")
            deep[f"hd{hd}_G{G}_S{S}_{str(dt)[6:]}"] = {
                "width": attn_lib.launch_width(dt, hd)[0],
                "pieces": attn_lib.row_pieces(dt, hd),
                "decode_split": split, "decode_heads_a_block": heads,
                "decode_blocks_per_sm": blocks}
        gc.collect()
    deep_s = time.perf_counter() - t_deep
    # the tensor-core body's G sweep (bf16, decode only): lm_serve's and
    # moe_serve's widths, Gemma-2B's, Falcon-7B's and Phi-3-mini's
    t_tc = time.perf_counter()
    B, KV, S = 4, 2, ATTN_PUBLIC_S[-1]
    lengths = torch.tensor([0, 1, 1000, S + 3], dtype=torch.int32,
                           device=DEV)

    def rnd_bf(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(
            torch.bfloat16)

    for hd, G in ATTN_TC_SWEEP:
        q = rnd_bf(B, KV, G, hd)
        decode_case(q, rnd_bf(B, S, KV, hd), rnd_bf(B, S, KV, hd), lengths,
                    f" (bfloat16, G {G}, hd {hd}, S {S})")
    tc_sweep_s = time.perf_counter() - t_tc
    cases = counts["cases"]
    check(fa_mod.LAUNCHES == 2 * cases
          and dec_mod.LAUNCHES == counts["decode"]
          and dec_mod.TC_LAUNCHES == counts["tc"] > 0,
          "launch counts of the grid")
    rule_cases = attn_rule_check()
    emit("attn_kernel", seconds=time.perf_counter() - t_phase, cases=cases,
         grid={"dtype": ["bfloat16", "float32"], "G": ATTN_G, "hd": ATTN_HD,
               "S": ATTN_S, "lengths": "0, 1, random, S + 3",
               "causal": [True, False],
               "tile_edges": {"dtype": ["bfloat16", "float32"],
                              "G": ATTN_EDGE_G, "S": ATTN_EDGE_S},
               "width_sweep": {"hd": ATTN_SWEEP_HD, **ATTN_SWEEP},
               "public": {"hd_G": ATTN_PUBLIC, "S": ATTN_PUBLIC_S},
               "head_blocks": {"hd_G": ATTN_HEAD_BLOCKS, "S": 129},
               "deep": {"hd": ATTN_DEEP_HD, **ATTN_SWEEP,
                        "wide": {"hd": ATTN_DEEP_WIDE_HD,
                                 "G": ATTN_DEEP_WIDE_G,
                                 "S": ATTN_DEEP_WIDE_S}}},
         sweep_and_public_seconds=sweep_s, public_shapes=public,
         deep_seconds=deep_s, deep_shapes=deep,
         deep_oracle={"cases": len(deep_oracle),
                      "kernel_x_tol_max": max(
                          (o["kernel_x_tol"] for o in deep_oracle), default=0),
                      "plain_x_tol_max": max(
                          (o["plain_x_tol"] for o in deep_oracle), default=0),
                      "past_tol": [o for o in deep_oracle
                                   if max(o["kernel_x_tol"],
                                          o["plain_x_tol"]) > 1]},
         rule_checked=rule_cases, ptxas=attn_ptxas(attn_lib.BUILD_LOG),
         flash_launches=fa_mod.LAUNCHES, decode_launches=dec_mod.LAUNCHES,
         decode_tc_launches=dec_mod.TC_LAUNCHES,
         tc_sweep={"hd_G": ATTN_TC_SWEEP, "seconds": tc_sweep_s},
         tc_info=tc_info_check(),
         max_abs_err=errs,
         tolerance={"flash": f"rtol {FLASH_RTOL}, atol {FLASH_ATOL} (bf16 "
                             "P.V, as test_kernels.py:96-97)",
                    "decode": f"rtol = atol = {DEC_TOL} (all f32 math, as "
                              "test_kernels.py:60)",
                    "flash_oracle_past_256": "recorded for the kernel and "
                                             "the plain version, not gated "
                                             "(deep_oracle)"})
    return (max(errs["flash"].values()), max(errs["decode"].values()),
            max(errs["decode_tc"].values()))


class Capture:
    """Wraps an ops entry point: counts its calls and keeps clones of the
    arguments of the calls whose index is in ``keep`` (layer 0 and the last
    layer of the first prefill or decode step)."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.args = fn, keep, 0, {}

    def __call__(self, *args, **kw):
        if self.calls in self.keep:
            self.args[self.calls] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
        self.calls += 1
        return self.fn(*args, **kw)


class PlainOnCard:
    """Wraps a plain version: counts the calls that got a CUDA tensor."""

    def __init__(self, fn):
        self.fn, self.cuda_calls = fn, 0

    def __call__(self, *args, **kw):
        if args[0].device.type == "cuda":
            self.cuda_calls += 1
        return self.fn(*args, **kw)


def sdpa_backends(*args, **kw):
    """Which of SDPA's backends take these inputs (each forced alone, in
    PyTorch's order of preference) and the kernels its default call
    launches: past head_dim 256 its flash backend refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    takes = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                sdpa(*args, **kw)
            sync()
            takes[name.lower()] = True
        except (RuntimeError, ValueError):
            takes[name.lower()] = False
    _, kernels = device_ms(lambda: sdpa(*args, **kw), 2)
    return {"takes": takes, "default_call_kernels": sorted(kernels)[:6]}


def qk_recompute(hd, width, n_pc):
    """The products of a flash launch in column pieces against one block
    a row: each of n_pc pieces computes Q . K^T over all hd columns and
    P . V over its width, so (n_pc hd + n_pc width) / (2 hd) of the
    products, of which (n_pc - 1) hd / (n_pc hd + n_pc width) are
    recomputed scores (2.5x and three fifths at hd 512 in bf16, four
    pieces of 128)."""
    done = n_pc * hd + n_pc * width
    return {"products_x_one_block": done / (2 * hd),
            "recomputed_qk_share": (n_pc - 1) * hd / done}


def doc_tokens_of(vocab, n):
    def doc_tokens(slot):
        return np.random.default_rng([SEED, slot]).integers(
            0, vocab, n, dtype=np.int32)
    return doc_tokens


def phase_lm_serve(dev, cfg=None, *, n_docs=50_000, capacity=65_536,
                   dim=128, doc_len=504, q_len=32, new_tokens=16, serves=3,
                   name="lm_serve"):
    """The LM serving path at full width (qwen3-4b unless ``cfg`` names
    another): RAGEngine over the bench RagDB -> prompt of 4 x 504 doc
    tokens + 32 question tokens (2048) -> prefill (the flash kernel, one
    launch a layer) -> 16 decode steps (the decode kernel, one launch a
    layer each). An MoE config also counts the router choices that differ
    between the kernel path's prefill and the naive path's (the logits gate
    applies only when none does: a flipped expert moves a token by a whole
    expert's share, which the kernel does not own) and times one MoE layer
    at the prefill's and a decode step's shapes."""
    from repro_torch.api import RagDB
    from repro_torch.configs import qwen3_4b
    from repro_torch.core.store import StoreConfig
    from repro_torch.core.tenancy import Principal
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import RAGEngine, Request

    t_phase = time.perf_counter()
    cfg = cfg or qwen3_4b.FULL
    L, k_docs, B = cfg.n_layers, 4, 8
    max_prompt = k_docs * doc_len + q_len
    max_len = max_prompt + new_tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init(cfg, generator=torch.Generator(device=dev)
                     .manual_seed(SEED), device=dev)
    sync()
    init_s = time.perf_counter() - t0
    ccfg = CorpusConfig(n_docs=n_docs, dim=dim, n_tenants=20, n_categories=5)
    db = RagDB(StoreConfig(capacity=capacity, dim=dim, metric="cosine"),
               result_cache_size=0, device=dev)
    db.ingest(make_corpus(ccfg, device=dev))
    engine = RAGEngine(db, cfg, model, k=k_docs, max_prompt=max_prompt,
                       max_len=max_len,
                       doc_token_fn=doc_tokens_of(cfg.vocab_size, doc_len),
                       engine="cuda", device=dev)
    rng = np.random.default_rng(SEED + 12)
    tenants = (3, 7, 12, 18)
    requests = [Request(principal=Principal(tenants[i % 4], 0xFF),
                        query_emb=rng.standard_normal(dim).astype(np.float32),
                        prompt_tokens=rng.integers(0, cfg.vocab_size, q_len,
                                                   dtype=np.int32),
                        max_new_tokens=new_tokens)
                for i in range(B)]

    # warm-up serve, capturing layer 0's and the last layer's attention
    # inputs of the prefill and of the first decode step
    flash_entry, dec_entry = fa_ops.flash_attention, dec_ops.decode_attention
    cap_f = Capture(flash_entry, {0, L - 1})
    cap_d = Capture(dec_entry, {0, L - 1})
    fa_ops.flash_attention, dec_ops.decode_attention = cap_f, cap_d
    try:
        warm = engine.serve(requests)
    finally:
        fa_ops.flash_attention, dec_ops.decode_attention = flash_entry, dec_entry
    check(cap_f.calls == L and cap_d.calls == L * new_tokens,
          f"warm-up serve: {cap_f.calls} flash / {cap_d.calls} decode calls")

    # the main path: counts to 0, serves, counts read
    plain_f = PlainOnCard(fa_mod.flash_attention_plain)
    plain_d = PlainOnCard(dec_mod.decode_attention_plain)
    fa_mod.flash_attention_plain = plain_f
    dec_mod.decode_attention_plain = plain_d
    fa_mod.LAUNCHES = kernel_mod.LAUNCHES = 0
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    resps, wall = [], []
    try:
        for _ in range(serves):
            t0 = time.perf_counter()
            resps.append(engine.serve(requests))
            wall.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa_mod.flash_attention_plain = plain_f.fn
        dec_mod.decode_attention_plain = plain_d.fn
    flash_launches, dec_launches = fa_mod.LAUNCHES, dec_mod.LAUNCHES
    dec_tc_launches = dec_mod.TC_LAUNCHES
    scan_launches = kernel_mod.LAUNCHES
    dec_tc = dec_mod.uses_tc(tfm.compute_dtype(cfg), cfg.hd)
    check(flash_launches == L * serves,
          f"{flash_launches} flash launches for {serves} prefills")
    check(dec_launches == L * new_tokens * serves
          and dec_tc_launches == (dec_launches if dec_tc else 0),
          f"{dec_launches} decode launches for {serves} serves, "
          f"{dec_tc_launches} of them the tensor-core body's")
    check(scan_launches >= serves, "retrieval did not run the arena scan")
    check(plain_f.cuda_calls == 0 and plain_d.cuda_calls == 0,
          "a plain version ran on CUDA tensors")

    # outputs: greedy tokens equal across serves, in range; no leaked slot
    snap = db.log.snapshot()
    tenant_of = snap["tenant"].cpu().numpy()
    acl_of = snap["acl"].cpu().numpy()
    leaks = 0
    for run in [warm, *resps]:
        for r, resp in zip(requests, run):
            check(resp.tokens.shape == (new_tokens,)
                  and (resp.tokens >= 0).all()
                  and (resp.tokens < cfg.vocab_size).all(), "bad tokens")
            got = resp.doc_slots[resp.doc_slots >= 0]
            check(len(got) == k_docs, "a request retrieved fewer than k docs")
            leaks += int(((tenant_of[got] != r.principal.tenant_id)
                          | ((acl_of[got] & 0xFF) == 0)).sum())
    check(leaks == 0, f"{leaks} retrieved slots of another tenant / ACL")
    for run in resps:
        check(all((a.tokens == b.tokens).all() and
                  (a.doc_slots == b.doc_slots).all()
                  for a, b in zip(warm, run)), "two greedy serves differ")

    # the same requests once more, retrieval through a Scheduler: nothing
    # shed, the same slots and the same greedy tokens
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    sched_engine = RAGEngine(
        db, cfg, model, k=k_docs, max_prompt=max_prompt, max_len=max_len,
        doc_token_fn=doc_tokens_of(cfg.vocab_size, doc_len), engine="cuda",
        device=dev, scheduler=Scheduler(db, SchedulerConfig(
            use_cache=False, slo_ms=1e9)))
    t0 = time.perf_counter()
    sched_resps = sched_engine.serve(requests)
    sched_ms = (time.perf_counter() - t0) * 1e3
    check(sched_engine.last_shed_requests == 0, "the scheduled serve shed "
          f"{sched_engine.last_shed_requests} requests")
    check(all((a.tokens == b.tokens).all() and
              (a.doc_slots == b.doc_slots).all()
              for a, b in zip(warm, sched_resps)),
          "the scheduled serve differs from the unscheduled one")

    # each kernel against its plain version on the path's own tensors
    errs_f, errs_d = [], []
    for i in (0, L - 1):
        q, k, v, n_kv = cap_f.args[i][:4]
        Bq, S, H, hd = q.shape
        errs_f.append(flash_check(q.reshape(Bq, S, n_kv, H // n_kv, hd), k,
                                  v, True)[0])
        qd, kc, vc, lengths, n_kv = cap_d.args[i][:5]
        errs_d.append(decode_check(qd.reshape(B, n_kv, H // n_kv, hd), kc,
                                   vc, lengths))

    # prefill logits through the flash kernel against the naive path; an
    # MoE model's router choices of both prefills recorded on the way
    slots = np.stack([resp.doc_slots for resp in warm])
    prompts = engine._build_prompts(requests, slots, np.zeros_like(slots))
    toks = torch.from_numpy(prompts).to(dev)
    (lg_chunked, _), r_c = routed(lambda: tfm.prefill(
        model, dataclasses.replace(cfg, attn_impl="chunked"), toks, max_len))
    (lg_naive, _), r_n = routed(lambda: tfm.prefill(
        model, dataclasses.replace(cfg, attn_impl="naive"), toks, max_len))
    sync()
    flips = None
    if cfg.is_moe:
        # per (token, layer), the experts of the kernel path's top-k that
        # the naive path did not choose; and the positional differences
        check(len(r_c) == len(r_n) == L, "one routing a layer and prefill")
        flips = {"set": route_flips(r_c, r_n),
                 "positional": sum(int((a != b).sum())
                                   for a, b in zip(r_c, r_n)),
                 "tokens_routed": sum(a.shape[0] * a.shape[1] for a in r_c)}
    del r_c, r_n
    lg_c, lg_n = lg_chunked.float(), lg_naive.float()
    logit_diff = float((lg_c - lg_n).abs().max())
    logit_scale = float(lg_n.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(lg_c, lg_n, dim=1).min())
    argmax_agree = float((lg_c.argmax(1) == lg_n.argmax(1)).float().mean())
    check(torch.isfinite(lg_c).all(), "chunked prefill logits not finite")
    logits_gated = flips is None or flips["set"] == 0
    if logits_gated:
        check(logit_diff <= LOGIT_REL * logit_scale,
              f"chunked vs naive logits differ by {logit_diff} "
              f"(max |logit| {logit_scale})")
    del lg_chunked, lg_naive, lg_c, lg_n

    # device time by kernel and the device's idle share: one prefill, one
    # decode step (at position max_prompt of a prefilled cache)
    lg, cache = tfm.prefill(model, cfg, toks, max_len)
    cur = lg.argmax(-1).to(torch.int32)
    profiles = {}
    for what, tags, fn in (
            ("prefill", ("flash_fwd",),
             lambda: tfm.prefill(model, cfg, toks, max_len)),
            ("decode_step", DECODE_KERNELS,
             lambda: tfm.decode_step(model, cfg, cur, cache, max_prompt))):
        prof = profile_batch(fn, tags)
        prof.pop("split_ms")
        profiles[what] = prof
    del lg, cache

    # one MoE layer (router, dispatch, experts, combine) by CUDA events at
    # the prefill's groups and at a decode step's (groups of one token)
    moe_ms = None
    if cfg.is_moe:
        gen_h = torch.Generator(device=dev).manual_seed(SEED + 13)
        spec, D = cfg.moe_spec(), cfg.d_model
        t_grp = min(cfg.moe_group, max_prompt)
        h_pre = torch.randn((B * max_prompt // t_grp, t_grp, D),
                            generator=gen_h, device=dev).to(torch.bfloat16)
        h_dec = torch.randn((B, 1, D), generator=gen_h,
                            device=dev).to(torch.bfloat16)
        layer0 = model.layers[0].moe
        with torch.no_grad():
            moe_ms = {
                "prefill_ms": events_ms(lambda: moe_mod.moe_apply(
                    layer0, spec, h_pre), 5),
                "decode_step_ms": events_ms(lambda: moe_mod.moe_apply(
                    layer0, spec, h_dec), 20),
                "groups_prefill": list(h_pre.shape[:2]),
                "capacity_prefill": moe_mod.capacity(t_grp, spec),
                "capacity_decode": moe_mod.capacity(1, spec)}
        del h_pre, h_dec

    # kernel times at the path's shapes, beside plain and SDPA
    q, k, v, n_kv = cap_f.args[0][:4]
    Bq, S, H, hd = q.shape
    q5 = q.reshape(Bq, S, n_kv, H // n_kv, hd)
    f_ms = events_ms(lambda: fa_mod.flash_attention_cuda(q5, k, v), 5)
    f_plain = events_ms(lambda: fa_mod.flash_attention_plain(
        q5, k, v, causal=True, blk_q=512, blk_k=512), 2)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_lib = events_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                   enable_gqa=True), 5)
    f_dev, f_kernels = device_ms(lambda: fa_mod.flash_attention_cuda(q5, k, v),
                                 10)
    f_lib_dev, _ = device_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                          enable_gqa=True), 10)
    check(all("flash_fwd_wgmma_kernel" in name
              or "flash_fwd_deep_kernel" in name for name in f_kernels),
          f"flash calls launched other kernels: {f_kernels}")
    sdpa_backend = sdpa_backends(qs, ks, vs, is_causal=True, enable_gqa=True)
    esz = q.element_size()
    f_width = attn_lib.launch_width(q.dtype, hd)[0]
    n_pc = attn_lib.row_pieces(q.dtype, hd)[1]
    f_flops = 4 * hd * (S * (S + 1) // 2) * Bq * H
    f_bytes = esz * (2 * q.numel() + k.numel() + v.numel())
    f_bound = max(f_flops / BF16_FLOPS, f_bytes / HBM_BPS) * 1e3
    del qs, ks, vs

    qd, kc, vc, lengths, n_kv = cap_d.args[0][:5]
    qg = qd.reshape(B, n_kv, H // n_kv, hd)
    d_ms = events_ms(lambda: dec_mod.decode_attention_cuda(qg, kc, vc,
                                                           lengths), 50)
    d_plain = events_ms(lambda: dec_mod.decode_attention_plain(
        qg, kc, vc, lengths), 10)
    live = int(lengths[0])
    check(bool((lengths == live).all()), "decode lengths differ in a batch")
    ql = qd[:, :, None, :]                                    # (B, H, 1, hd)
    kl = kc[:, :live].transpose(1, 2).contiguous()
    vl = vc[:, :live].transpose(1, 2).contiguous()
    d_lib = events_ms(lambda: sdpa(ql, kl, vl, enable_gqa=True), 50)
    d_dev, d_kernels = device_ms(lambda: dec_mod.decode_attention_cuda(
        qg, kc, vc, lengths), 50)
    d_lib_dev, _ = device_ms(lambda: sdpa(ql, kl, vl, enable_gqa=True), 50)
    d_sdpa_backend = sdpa_backends(ql, kl, vl, enable_gqa=True)
    check(all(DECODE_KERNELS[dec_tc] in name for name in d_kernels)
          and sum(d_kernels.values()) <= 50,
          f"decode calls launched {d_kernels} (one kernel a call, merge "
          "included, the " + ("tensor-core" if dec_tc else "SIMT")
          + " body's)")
    # a call allocates one buffer (its three outputs) and nothing else: the
    # partials and counters live in the workspace, allocated once
    sync()
    n_alloc0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    outs = [dec_mod.decode_attention_cuda(qg, kc, vc, lengths)
            for _ in range(10)]
    d_allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                - n_alloc0) / 10
    del outs
    check(d_allocs == 1, f"decode allocates {d_allocs} tensors a call, not 1")
    # the card must hold at least one block an SM of the body that serves
    # the decode: the tensor-core body for bf16 rows up to 256 (lm_serve's
    # and moe_serve's), the SIMT body past 256 (deep_serve's)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if dec_tc:
        d_split, d_heads = dec_mod.tc_plan(B, n_kv, H // n_kv, kc.shape[1],
                                           n_sm, hd)
        d_blocks = tc_info_check()[
            f"w{attn_lib.launch_width(kc.dtype, hd)[0]}_h"
            f"{-(-d_heads // dec_mod.TC_WG_HEADS) * dec_mod.TC_WG_HEADS}"][
            "blocks_per_sm"]
    else:
        check(name not in ("lm_serve", "moe_serve"),
              f"{name}'s decode ({kc.dtype}, hd {hd}) does not take the "
              "tensor-core body")
        d_split, d_heads = dec_mod.block_heads(
            B, n_kv, H // n_kv, kc.shape[1], n_sm, hd, kc.element_size())
        d_blocks = attn_lib.load().decode_attention_blocks_per_sm(
            attn_lib.DTYPES[kc.dtype], attn_lib.padded_head_dim(hd), d_heads,
            d_split)
    check(d_blocks >= 1, f"{d_blocks} decode blocks an SM "
                         f"({'tensor-core' if dec_tc else 'SIMT'} body)")
    live_total = int(lengths.clamp(max=kc.shape[1]).sum())
    d_bytes = (2 * live_total * n_kv * hd * kc.element_size()
               + qd.numel() * qd.element_size() + B * H * (hd + 2) * 4)
    d_flops = 4 * hd * H * live_total
    d_ops_s = decode_ops_s(kc.dtype, hd, d_flops)
    d_bound = max(d_bytes / HBM_BPS, d_ops_s) * 1e3
    del kl, vl

    med = statistics.median
    retrieval = [run[0].retrieval_ms * B for run in resps]
    prefill = [run[0].prefill_ms for run in resps]
    decode = [run[0].decode_ms for run in resps]
    emit(name, seconds=time.perf_counter() - t_phase, model=cfg.name,
         params=cfg.param_count(), active_params=cfg.active_param_count(),
         layers=L, head_dim=cfg.hd, group=cfg.n_heads // cfg.n_kv_heads,
         batch=B, k=k_docs,
         prompt=max_prompt, new_tokens=new_tokens, max_len=max_len,
         init_s=init_s, serves=serves,
         retrieval_ms_median=med(retrieval), prefill_ms_median=med(prefill),
         decode_ms_per_token_median=med(decode) / new_tokens,
         tokens_per_s_median=B * new_tokens / (med(decode) / 1e3),
         serve_ms=wall, retrieval_ms=retrieval, prefill_ms=prefill,
         decode_ms=decode, flash_launches=flash_launches,
         decode_launches=dec_launches,
         decode_launches_by_body={"simt": dec_launches - dec_tc_launches,
                                  "tc": dec_tc_launches},
         scan_launches=scan_launches,
         plain_calls_on_cuda=plain_f.cuda_calls + plain_d.cuda_calls,
         leaked_slots=leaks, tokens_equal=True,
         scheduled_serve={"ms": sched_ms, "shed": 0,
                          "slots_and_tokens_equal": True},
         flash_err_layers=errs_f, decode_err_layers=errs_d,
         logits_chunked_vs_naive={"max_abs_diff": logit_diff,
                                  "max_abs_logit": logit_scale,
                                  "min_cosine": cos,
                                  "argmax_agree": argmax_agree,
                                  "gated": logits_gated},
         routing_flips_chunked_vs_naive=flips, moe_layer=moe_ms,
         flash={"ms": f_ms, "device_ms": f_dev, "plain_ms": f_plain,
                "sdpa_ms": f_lib, "sdpa_device_ms": f_lib_dev,
                "sdpa_backend": sdpa_backend,
                "bound_ms": f_bound, "gflop": f_flops / 1e9,
                "width": f_width, "pieces": n_pc,
                "padded_arithmetic_share": 1 - hd / (n_pc * f_width),
                **qk_recompute(hd, f_width, n_pc),
                "rows_in_use_a_tile": tile_rows_in_use(H // n_kv),
                "mbytes": f_bytes / 1e6, "key_tile": fa_mod.key_tile(f_width),
                "kernels_traced_in_10_calls": f_kernels},
         decode={"ms": d_ms, "device_ms": d_dev, "plain_ms": d_plain,
                 "sdpa_ms": d_lib, "sdpa_device_ms": d_lib_dev,
                 "sdpa_backend": d_sdpa_backend,
                 "bound_ms": d_bound, "live_len": live,
                 "mbytes": d_bytes / 1e6,
                 "kernels_traced_in_50_calls": d_kernels,
                 "allocations_a_call": d_allocs,
                 "workspace_bytes": dec_mod.workspace_bytes(),
                 "body": "tc" if dec_tc else "simt",
                 "split": d_split, "heads_a_block": d_heads,
                 "blocks_per_sm": d_blocks,
                 **({"tc_products": tc_products(hd, H // n_kv, d_flops)}
                    if dec_tc else {})},
         profile=profiles, peak_mem_gb=peak_gb())
    return {
        "flash": dict(launches=flash_launches, ms=f_ms, plain_ms=f_plain,
                      bound_ms=f_bound, library_ms=f_lib,
                      bound_by="operations" if f_flops / BF16_FLOPS
                      >= f_bytes / HBM_BPS else "bytes",
                      max_abs_err=max(errs_f)),
        "decode": dict(launches=dec_launches, tc_launches=dec_tc_launches,
                       body="tc" if dec_tc else "simt", ms=d_ms,
                       plain_ms=d_plain, bound_ms=d_bound, library_ms=d_lib,
                       device_ms=d_dev,
                       bound_by="bytes" if d_bytes / HBM_BPS
                       >= d_ops_s else "operations",
                       max_abs_err=max(errs_d))}


def phase_moe_serve(dev):
    """granite-moe-1b-a400m FULL through `phase_lm_serve` (hd 64, G 2 on
    both attention kernels), then the serving launcher once on the card."""
    from repro_torch.configs import granite_moe_1b
    from repro_torch.launch import serve as serve_launch
    out = phase_lm_serve(dev, granite_moe_1b.FULL, name="moe_serve")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = serve_launch.main(["--arch", "granite-moe-1b-a400m",
                                "--no-reduced", "--engine", "cuda",
                                "--requests", "8"])
    check(served == 8, f"the serving launcher served {served} of 8")
    emit("moe_serve_launcher", seconds=time.perf_counter() - t0,
         argv="--arch granite-moe-1b-a400m --no-reduced --engine cuda "
              "--requests 8", served=served)
    return out


#: the registry's LMs, each served at its REDUCED config (hd 16 or 32)
REDUCED_ARCHS = ("qwen1.5-0.5b", "qwen3-4b", "yi-6b", "granite-moe-1b-a400m",
                 "grok-1-314b")
#: (B, S) of each REDUCED config's prefill: "auto" takes the flash kernel
#: at S >= 2048
REDUCED_PREFILL = (8, 2048)
REDUCED_DECODE_STEPS = 8
#: gen-25m's decode shape in examples/torch_rag_serve.py: B 8, KV 4, G 2,
#: a cache of max_prompt 48 + 12 tokens + 2 rows, the last step's live rows
GEN25M_DECODE = dict(B=8, KV=4, G=2, S=62, live=60)


class plain_attention:
    """``with plain_attention():`` sends the attention ops' card calls to
    the plain versions (on the same CUDA tensors) instead of the kernels:
    the reference side of a kernel-vs-plain comparison; LAUNCHES does not
    move. ``oracle`` sends flash calls to the f32 oracle
    (`flash_attention_ref`: f32 softmax and P . V, nothing rounded to
    bf16) instead of the plain version, whose P . V rounds each key
    block's product to bf16 as the reference's ``gqa_chunked`` does."""

    def __init__(self, oracle=False):
        self.oracle = oracle

    def __enter__(self):
        self.fa, self.dec = (fa_mod.flash_attention_cuda,
                             dec_mod.decode_attention_cuda)
        # the plain versions themselves, not a `PlainOnCard` counting them
        fa_plain = getattr(fa_mod.flash_attention_plain, "fn",
                           fa_mod.flash_attention_plain)
        fa_mod.flash_attention_cuda = (
            (lambda q, k, v, causal=True: fa_ref(q, k, v, causal=causal))
            if self.oracle else
            (lambda q, k, v, causal=True: fa_plain(q, k, v, causal=causal,
                                                   blk_q=512, blk_k=512)))
        dec_mod.decode_attention_cuda = getattr(
            dec_mod.decode_attention_plain, "fn",
            dec_mod.decode_attention_plain)
        return self

    def __exit__(self, *exc):
        fa_mod.flash_attention_cuda = self.fa
        dec_mod.decode_attention_cuda = self.dec


def load_example(name):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def routed(fn, replay=None):
    """fn() with every MoE routing's chosen experts recorded: (fn(),
    [topk_e of each `moe._route` call]). With ``replay`` (another run's
    list), call i routes to replay[i]'s experts instead (`forced_route`);
    the list still records the call's own choice."""
    from repro_torch.models import moe as moe_mod
    route, seen = moe_mod._route, []

    def spy(p, spec, x):
        out = route(p, spec, x)
        seen.append(out[1])
        if replay is not None:
            out = forced_route(spec, out[4], replay[len(seen) - 1])
        return out
    moe_mod._route = spy
    try:
        return fn(), seen
    finally:
        moe_mod._route = route


def forced_route(spec, probs, topk_e):
    """`moe._route`'s outputs for the chosen experts ``topk_e`` (G, T, K):
    their gates from this call's router ``probs`` (G, T, E), renormalised,
    and positions first come, first served, as `_route` gives them."""
    from repro_torch.models import moe as moe_mod
    G, T, E = probs.shape
    K = topk_e.shape[-1]
    topk_p = probs.gather(-1, topk_e)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    flat = torch.nn.functional.one_hot(topk_e.reshape(G, T * K), E)
    before = torch.cumsum(flat, dim=1) - flat
    pos = before.gather(-1, topk_e.reshape(G, T * K, 1)).reshape(G, T, K)
    return topk_p, topk_e, pos, pos < moe_mod.capacity(T, spec), probs


def route_flips(a_list, b_list) -> int:
    """(token, layer, k) choices of one run that the other did not make."""
    return sum(int((~(a[..., :, None] == b[..., None, :]).any(-1)).sum())
               for a, b in zip(a_list, b_list))


def reduced_model_check(dev, arch_id, cfg, oracle=False):
    """One REDUCED config: a prefill of REDUCED_PREFILL through the flash
    kernel (n_layers launches) and REDUCED_DECODE_STEPS greedy decode steps
    through the decode kernel (n_layers launches a step), each held to the
    same call with the plain attention versions on the card: prefill
    logits within FLASH_RTOL / FLASH_ATOL, each decode step's logits (fed
    the kernel path's tokens, from the kernel path's prefilled cache)
    within DEC_TOL. The plain path routes every MoE layer to the kernel
    path's experts (`routed(replay=)`), so both gates hold for every
    config: a flipped expert would move a token by a whole expert's share,
    which no attention kernel owns. The choices the plain path would have
    made otherwise (routing flips) and greedy-token flips are reported.
    With ``oracle`` (the wide configs, f32) the prefill runs a third time
    with its flash calls on the f32 oracle (`plain_attention(True)`), and
    the prefill gate holds when the kernel path's logits are within the
    tolerance of the plain path's OR no farther (in multiples of the
    tolerance) from the oracle path's than the plain path's are: the
    plain version and the kernel both round V (and P) to bf16 for P . V,
    as the reference does, and four 2048- to 4544-wide layers carry that
    rounding past the elementwise tolerance (Phi-3-mini: 1.5x kernel
    against plain, 1.9x kernel against the oracle); the gate then asks
    the kernel to be as accurate as its plain version."""
    from repro_torch.models import transformer as tfm
    B, S = REDUCED_PREFILL
    n = REDUCED_DECODE_STEPS
    L = cfg.n_layers
    model = tfm.init(cfg, generator=torch.Generator(device=dev)
                     .manual_seed(SEED), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)
    fa_mod.LAUNCHES = dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    (lg_k, cache_k), r_k = routed(lambda: tfm.prefill(model, cfg, toks,
                                                      S + n))
    sync()
    flash_launches = fa_mod.LAUNCHES
    check(flash_launches == L, f"{arch_id}: {flash_launches} flash launches "
                               f"for a prefill of {L} layers")
    cache_p = {key: t.clone() for key, t in cache_k.items()}
    with plain_attention():
        (lg_p, _), r_p = routed(lambda: tfm.prefill(model, cfg, toks, S + n),
                                replay=r_k)
    sync()
    prefill_flips = route_flips(r_k, r_p)
    err_pre, ratio_pre = attn_ok(lg_k, lg_p, FLASH_RTOL, FLASH_ATOL)
    check(bool(torch.isfinite(lg_k).all()), f"{arch_id}: prefill logits "
                                            "not finite")
    vs_oracle = None
    if oracle:
        with plain_attention(oracle=True):
            (lg_o, _), _ = routed(lambda: tfm.prefill(model, cfg, toks,
                                                      S + n), replay=r_k)
        sync()
        vs_oracle = {"kernel_x_tol": attn_ok(lg_k, lg_o, FLASH_RTOL,
                                             FLASH_ATOL)[1],
                     "plain_x_tol": attn_ok(lg_p, lg_o, FLASH_RTOL,
                                            FLASH_ATOL)[1]}
        del lg_o
    check(ratio_pre <= 1 or (vs_oracle is not None and vs_oracle[
              "kernel_x_tol"] <= vs_oracle["plain_x_tol"]),
          f"{arch_id}: prefill logits off the plain path's by {err_pre} "
          f"(x{ratio_pre}); against the f32 oracle {vs_oracle}")
    dec_err, dec_ratio, token_flips, dec_flips = 0.0, 0.0, 0, 0
    tok = lg_k.argmax(-1).to(torch.int32)
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    for i in range(n):
        (lk, _), rk = routed(lambda: tfm.decode_step(model, cfg, tok,
                                                     cache_k, S + i))
        with plain_attention():
            (lp, _), rp = routed(lambda: tfm.decode_step(model, cfg, tok,
                                                         cache_p, S + i),
                                 replay=rk)
        sync()
        dec_flips += route_flips(rk, rp)
        e, r = attn_ok(lk, lp, DEC_TOL, DEC_TOL)
        check(bool(torch.isfinite(lk).all()), f"{arch_id}: decode logits "
                                              "not finite")
        dec_err, dec_ratio = max(dec_err, e), max(dec_ratio, r)
        token_flips += int((lk.argmax(-1) != lp.argmax(-1)).sum())
        tok = lk.argmax(-1).to(torch.int32)
    dec_launches = dec_mod.LAUNCHES
    check(dec_launches == L * n, f"{arch_id}: {dec_launches} decode "
                                 f"launches for {n} steps of {L} layers")
    check(dec_ratio <= 1, f"{arch_id}: decode logits off the plain path's "
                          f"by {dec_err} (x{dec_ratio})")
    return {"prefill": [B, S], "flash_launches": flash_launches,
            "decode_launches": dec_launches,
            "prefill_logits_err": err_pre, "prefill_logits_x_tol": ratio_pre,
            "prefill_logits_vs_f32_oracle": vs_oracle,
            "decode_logits_err": dec_err, "decode_logits_x_tol": dec_ratio,
            "greedy_token_flips": token_flips,
            "routing_flips_replayed": {"prefill": prefill_flips,
                                       "decode": dec_flips}}


def reduced_kernel_checks(dev):
    """Both kernels at each REDUCED config's own attention shape and dtype
    on seeded random inputs, held to their plain versions: flash at its
    prefill (REDUCED_PREFILL, its KV, G and hd; `flash_check`, causal),
    decode at its decode steps (a cache of S + REDUCED_DECODE_STEPS rows,
    S to S + 7 live; `decode_check`). Run outside the counted runs."""
    from repro_torch.configs import get
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    B, S = REDUCED_PREFILL
    n = REDUCED_DECODE_STEPS
    out = {}
    for arch_id in REDUCED_ARCHS:
        cfg = get(arch_id).reduced
        KV, hd, dt = cfg.n_kv_heads, cfg.hd, getattr(torch, cfg.dtype)
        G = cfg.n_heads // KV

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)
        f_err, f_err_r = flash_check(rnd(B, S, KV, G, hd), rnd(B, S, KV, hd),
                                     rnd(B, S, KV, hd), True)
        lengths = S + torch.arange(B, dtype=torch.int32, device=dev) % n
        d_err = decode_check(rnd(B, KV, G, hd), rnd(B, S + n, KV, hd),
                             rnd(B, S + n, KV, hd), lengths)
        out[arch_id] = {"shape": [B, S, KV, G, hd], "dtype": cfg.dtype,
                        "flash_err": f_err, "flash_oracle_err": f_err_r,
                        "decode_err": d_err}
    return out


def narrow_kernel_times(dev):
    """Both kernels at hd 16 and 32, f32 (the REDUCED configs' and gen-25m's
    type) and bf16, against their plain versions (`flash_check`,
    `decode_check`) and timed beside them, SDPA (a yardstick the port
    never calls) and the bound (flash: Q.K^T at its dtype's peak, P.V at
    the bf16 one): the flash kernel at a REDUCED prefill
    (REDUCED_PREFILL, KV 2, G 2: qwen3-4b's and yi-6b's REDUCED heads), the
    decode kernel at gen-25m's decode shape (GEN25M_DECODE)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEV).manual_seed(SEED + 30)
    B, S = REDUCED_PREFILL
    d = GEN25M_DECODE
    rows, errs = {}, {"flash": 0.0, "decode": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        for hd in (16, 32):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen,
                                   device=DEV).to(dt)
            name = f"{str(dt).split('.')[-1]}_hd{hd}"
            esz = torch.empty((), dtype=dt).element_size()
            KV, G = 2, 2
            q, k, v = rnd(B, S, KV, G, hd), rnd(B, S, KV, hd), rnd(B, S, KV,
                                                                  hd)
            errs["flash"] = max(errs["flash"], flash_check(q, k, v, True)[0])
            qs = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
            ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
            # Q.K^T and P.V, 2 hd operations a (query, key) pair each; P.V
            # multiplies bf16 P and V in both dtypes, so the card's least
            # time for it is at the bf16 tensor-core rate, and for an f32
            # Q.K^T at the f32 rate
            f_flops = 4 * hd * (S * (S + 1) // 2) * B * KV * G
            f_ops_s = (f_flops / 2 / (FP32_FLOPS if dt == torch.float32
                                      else BF16_FLOPS)
                       + f_flops / 2 / BF16_FLOPS)
            f_bytes = esz * (2 * q.numel() + k.numel() + v.numel())
            f_dev, _ = device_ms(lambda: fa_mod.flash_attention_cuda(q, k, v),
                                 10)
            flash = {
                "shape": [B, S, KV, G, hd],
                "ms": events_ms(lambda: fa_mod.flash_attention_cuda(q, k, v),
                                20),
                "device_ms": f_dev,
                "plain_ms": events_ms(lambda: fa_mod.flash_attention_plain(
                    q, k, v, causal=True, blk_q=512, blk_k=512), 3),
                "sdpa_ms": events_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                                  enable_gqa=True), 20),
                "bound_ms": max(f_ops_s, f_bytes / HBM_BPS) * 1e3,
                "bound_by": "operations" if f_ops_s >= f_bytes / HBM_BPS
                else "bytes"}
            del q, k, v, qs, ks, vs
            qd = rnd(d["B"], d["KV"], d["G"], hd)
            kc, vc = (rnd(d["B"], d["S"], d["KV"], hd) for _ in range(2))
            lengths = torch.full((d["B"],), d["live"], dtype=torch.int32,
                                 device=DEV)
            errs["decode"] = max(errs["decode"],
                                 decode_check(qd, kc, vc, lengths))
            ql = qd.reshape(d["B"], d["KV"] * d["G"], 1, hd)
            kl = kc[:, :d["live"]].transpose(1, 2).contiguous()
            vl = vc[:, :d["live"]].transpose(1, 2).contiguous()
            rows_live = d["B"] * d["live"]
            d_bytes = (2 * rows_live * d["KV"] * hd * esz + qd.numel() * esz
                       + d["B"] * d["KV"] * d["G"] * (hd + 2) * 4)
            d_flops = 4 * hd * d["KV"] * d["G"] * rows_live
            d_ops_s = decode_ops_s(dt, hd, d_flops)
            tc = dec_mod.uses_tc(dt, hd)
            n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
            d_dev, _ = device_ms(lambda: dec_mod.decode_attention_cuda(
                qd, kc, vc, lengths), 50)
            decode = {
                "shape": [d["B"], d["S"], d["KV"], d["G"], hd],
                "live": d["live"],
                "ms": events_ms(lambda: dec_mod.decode_attention_cuda(
                    qd, kc, vc, lengths), 100),
                "device_ms": d_dev,
                "plain_ms": events_ms(lambda: dec_mod.decode_attention_plain(
                    qd, kc, vc, lengths), 50),
                "sdpa_ms": events_ms(lambda: sdpa(ql, kl, vl,
                                                  enable_gqa=True), 100),
                "bound_ms": max(d_bytes / HBM_BPS, d_ops_s) * 1e3,
                "bound_by": "bytes" if d_bytes / HBM_BPS >= d_ops_s
                else "operations",
                "body": "tc" if tc else "simt",
                "split": (dec_mod.tc_plan(d["B"], d["KV"], d["G"], d["S"],
                                          n_sm, hd)[0] if tc else
                          dec_mod.split_for(d["B"], d["KV"], d["G"], d["S"],
                                            n_sm, hd, esz))}
            if tc:
                decode["tc_products"] = tc_products(hd, d["G"], d_flops)
            rows[name] = {"flash": flash, "decode": decode}
    return rows, errs


def phase_reduced_serve(dev):
    """Every REDUCED config and the three examples on the card: (a)
    `launch.serve.main(["--arch", A, "--engine", "cuda"])` at its defaults
    (--reduced) for each of the five LMs, its decode steps through the
    decode kernel (the short prompts' prefill is naive, as in the
    reference); (b) each config's S-2048 prefill through the flash kernel
    and 8 decode steps, held to the plain attention versions
    (`reduced_model_check`); (c) both kernels at hd 16 / 32 timed
    (`narrow_kernel_times`) and held to their plain versions at each
    config's own shapes (`reduced_kernel_checks`); (d) examples/torch_quickstart.py,
    torch_rag_serve.py (gen-25m, hd 32, G 2: 8 requests x 12 tokens
    through the scan and decode kernels) and torch_train_lm.py (200 steps
    with the straggler detector, then a resume). In every counted run no
    plain version gets a CUDA tensor."""
    import tempfile

    from repro_torch.configs import get
    from repro_torch.launch import serve as serve_launch
    t_phase = time.perf_counter()
    plain_f = PlainOnCard(fa_mod.flash_attention_plain)
    plain_d = PlainOnCard(dec_mod.decode_attention_plain)
    launcher, models = {}, {}
    main_path = {"flash": 0, "decode": 0, "arena_scan": 0}
    fa_mod.flash_attention_plain = plain_f
    dec_mod.decode_attention_plain = plain_d
    try:
        for arch_id in REDUCED_ARCHS:
            cfg = get(arch_id).reduced
            check(attn_lib.launch_width(getattr(torch, cfg.dtype),
                                        cfg.hd) == (cfg.hd, False)
                  and cfg.hd < 64, f"{arch_id}: REDUCED head_dim {cfg.hd}")
            fa_mod.LAUNCHES = kernel_mod.LAUNCHES = 0
            dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
            t0 = time.perf_counter()
            served = serve_launch.main(["--arch", arch_id, "--engine",
                                        "cuda"])
            sync()
            secs = time.perf_counter() - t0
            counts = (fa_mod.LAUNCHES, dec_mod.LAUNCHES, kernel_mod.LAUNCHES)
            # the launcher's defaults: 16 requests in batches of 4, 8 tokens
            check(served == 16, f"{arch_id}: the launcher served {served}")
            check(counts[1] == cfg.n_layers * 8 * 4,
                  f"{arch_id}: {counts[1]} decode launches")
            check(counts[2] >= 4, f"{arch_id}: {counts[2]} scan launches "
                                  "for 4 batches")
            main_path["decode"] += counts[1]
            main_path["arena_scan"] += counts[2]
            launcher[arch_id] = {
                "config": cfg.name, "hd": cfg.hd,
                "G": cfg.n_heads // cfg.n_kv_heads, "served": served,
                "seconds": secs, "flash_launches": counts[0],
                "decode_launches": counts[1], "scan_launches": counts[2]}
        for arch_id in REDUCED_ARCHS:
            cfg = get(arch_id).reduced
            models[arch_id] = reduced_model_check(dev, arch_id, cfg)
            main_path["flash"] += models[arch_id]["flash_launches"]
            main_path["decode"] += models[arch_id]["decode_launches"]
        check(plain_f.cuda_calls == 0 and plain_d.cuda_calls == 0,
              "a plain version ran on CUDA tensors")
    finally:
        fa_mod.flash_attention_plain = plain_f.fn
        dec_mod.decode_attention_plain = plain_d.fn
    times, errs = narrow_kernel_times(dev)
    shapes = reduced_kernel_checks(dev)
    for key in ("flash", "decode"):
        errs[key] = max([errs[key]] + [c[f"{key}_err"]
                                       for c in shapes.values()])

    examples = {}
    plain_f = PlainOnCard(fa_mod.flash_attention_plain)
    plain_d = PlainOnCard(dec_mod.decode_attention_plain)
    fa_mod.flash_attention_plain = plain_f
    dec_mod.decode_attention_plain = plain_d
    try:
        fa_mod.LAUNCHES = kernel_mod.LAUNCHES = 0
        dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
        t0 = time.perf_counter()
        qs = load_example("torch_quickstart").main([])
        sync()
        check(qs["unified"]["leaked"] == 0
              and qs["unified"]["window_ms"] == 0.0
              and len(qs["unified"]["slots"]) == 5,
              f"quickstart: {qs['unified']}")
        check(kernel_mod.LAUNCHES >= 1, "quickstart ran no scan kernel")
        examples["quickstart"] = {
            "seconds": time.perf_counter() - t0, "unified": qs["unified"],
            "split": qs["split"], "scan_launches": kernel_mod.LAUNCHES}
        main_path["arena_scan"] += kernel_mod.LAUNCHES

        fa_mod.LAUNCHES = kernel_mod.LAUNCHES = 0
        dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
        t0 = time.perf_counter()
        rag_serve = load_example("torch_rag_serve")
        rs = rag_serve.main([])
        sync()
        gen_cfg = rag_serve.GEN_25M
        check(rs["served"] == 8 and all(len(r["tokens"]) == 12
                                        for r in rs["responses"]),
              f"rag_serve served {rs['served']}")
        check(dec_mod.LAUNCHES == gen_cfg.n_layers * 12,
              f"rag_serve: {dec_mod.LAUNCHES} decode launches")
        check(kernel_mod.LAUNCHES >= 1, "rag_serve ran no scan kernel")
        examples["rag_serve"] = {
            "seconds": time.perf_counter() - t0, "hd": gen_cfg.hd,
            "G": gen_cfg.n_heads // gen_cfg.n_kv_heads,
            "served": rs["served"], "tok_s": rs["tok_s"],
            "device_calls": rs["device_calls"],
            "decode_launches": dec_mod.LAUNCHES,
            "flash_launches": fa_mod.LAUNCHES,
            "scan_launches": kernel_mod.LAUNCHES}
        main_path["decode"] += dec_mod.LAUNCHES
        main_path["arena_scan"] += kernel_mod.LAUNCHES

        fa_mod.LAUNCHES = dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_dir = os.path.join(tmp, "ckpt")
            train_lm = load_example("torch_train_lm")
            tl = train_lm.main(["--ckpt", ckpt_dir])
            again = train_lm.main(["--ckpt", ckpt_dir, "--steps", "220"])
        losses = [loss for _, loss in tl["losses"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train_lm losses {losses}")
        check(again["start"] == 200 and all(
            np.isfinite(loss) for _, loss in again["losses"]),
              f"train_lm resumed at {again['start']}")
        check(fa_mod.LAUNCHES == dec_mod.LAUNCHES == 0,
              "training launched an attention kernel")
        examples["train_lm"] = {
            "seconds": time.perf_counter() - t0, "losses": tl["losses"],
            "mean_step_ms": tl["mean_step_ms"],
            "straggler_events": tl["straggler_events"],
            "resumed_at": again["start"], "resumed_losses": again["losses"]}
        check(plain_f.cuda_calls == 0 and plain_d.cuda_calls == 0,
              "a plain version ran on CUDA tensors")
    finally:
        fa_mod.flash_attention_plain = plain_f.fn
        dec_mod.decode_attention_plain = plain_d.fn
    emit("reduced_serve", seconds=time.perf_counter() - t_phase,
         launcher=launcher, models=models, kernel_times=times,
         kernel_at_config_shapes=shapes, kernel_err=errs, examples=examples, main_path_launches=main_path,
         tolerance={"prefill_logits": f"rtol {FLASH_RTOL}, atol "
                                      f"{FLASH_ATOL} (the flash kernel and "
                                      "its plain version round P and V to "
                                      "bf16 for P.V)",
                    "decode_logits": f"rtol = atol = {DEC_TOL} (all f32 "
                                     "math on both sides)"})
    return {"flash": main_path["flash"], "decode": main_path["decode"],
            "arena_scan": main_path["arena_scan"],
            "flash_err": errs["flash"], "decode_err": errs["decode"]}


#: wide_serve's configs: the attention widths (d_model, heads, KV heads,
#: head_dim, d_ff, vocab) of three public models' config.json --
#: microsoft/Phi-3-mini-4k-instruct (hd 96, G 1), google/gemma-2b (hd 256,
#: G 8: the flash kernel's two-stage ring) and tiiuae/falcon-7b (hd 64,
#: G 71: past both kernels' old head-group caps) -- on the repo's decoder
#: block, bf16, WIDE_LAYERS layers
WIDE_CONFIGS = (
    ("phi-3-mini", dict(d_model=3072, n_heads=32, n_kv_heads=32,
                        head_dim=96, d_ff=8192, vocab_size=32064)),
    ("gemma-2b", dict(d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
                      d_ff=16384, vocab_size=256000)),
    ("falcon-7b", dict(d_model=4544, n_heads=71, n_kv_heads=1, head_dim=64,
                       d_ff=18176, vocab_size=65024)),
)
#: layers of each wide config: the depth cut that bounds the phase's time
WIDE_LAYERS = 4


def phase_wide_serve(dev):
    """The serving path at the three WIDE_CONFIGS: each through
    `phase_lm_serve` (RAGEngine over the bench RagDB, a 2048-token prompt,
    prefill through the flash kernel, 16 decode steps through the decode
    kernel, its gates, times, SDPA and bounds; 2 counted serves), then the
    same widths in f32 through `reduced_model_check` (a prefill of
    REDUCED_PREFILL through the flash kernel and REDUCED_DECODE_STEPS
    decode steps, logits within the flash and decode tolerances of the
    plain attention path's on the same weights -- or, for the prefill, no
    farther from the f32 oracle path's than the plain path's are
    (`reduced_model_check(oracle=True)`); the bf16 logits of the two paths
    part by bf16 roundings of the attention outputs, which no kernel
    tolerance covers). No plain version gets a CUDA tensor in a counted
    run."""
    from repro_torch.models.transformer import TransformerConfig
    t_phase = time.perf_counter()
    served, models = {}, {}
    totals = {"flash": 0, "decode": 0, "decode_tc": 0, "flash_err": 0.0,
              "decode_err": 0.0}
    bodies = {}
    for tag, widths in WIDE_CONFIGS:
        cfg = TransformerConfig(name=f"{tag}-widths-{WIDE_LAYERS}l",
                                n_layers=WIDE_LAYERS, dtype="bfloat16",
                                **widths)
        row = phase_lm_serve(dev, cfg, serves=2, name=f"wide_serve_{tag}")
        gc.collect()
        torch.cuda.empty_cache()
        plain_f = PlainOnCard(fa_mod.flash_attention_plain)
        plain_d = PlainOnCard(dec_mod.decode_attention_plain)
        fa_mod.flash_attention_plain = plain_f
        dec_mod.decode_attention_plain = plain_d
        try:
            chk = reduced_model_check(
                dev, tag, dataclasses.replace(cfg, dtype="float32"),
                oracle=True)
            check(plain_f.cuda_calls == 0 and plain_d.cuda_calls == 0,
                  f"{tag}: a plain version ran on CUDA tensors")
        finally:
            fa_mod.flash_attention_plain = plain_f.fn
            dec_mod.decode_attention_plain = plain_d.fn
        gc.collect()
        torch.cuda.empty_cache()
        served[tag] = {key: row[key] for key in ("flash", "decode")}
        models[tag] = chk
        totals["flash"] += row["flash"]["launches"] + chk["flash_launches"]
        totals["decode"] += row["decode"]["launches"] + chk["decode_launches"]
        totals["decode_tc"] += row["decode"]["tc_launches"]
        # the served bf16 steps' launches by body (the f32 check's are the
        # SIMT body's: its Q . K^T takes no bf16 operands)
        bodies[tag] = {"tc": row["decode"]["tc_launches"],
                       "simt": row["decode"]["launches"]
                       - row["decode"]["tc_launches"],
                       "f32_check_simt": chk["decode_launches"]}
        totals["flash_err"] = max(totals["flash_err"],
                                  row["flash"]["max_abs_err"])
        totals["decode_err"] = max(totals["decode_err"],
                                   row["decode"]["max_abs_err"])
    emit("wide_serve", seconds=time.perf_counter() - t_phase,
         layers=WIDE_LAYERS, configs=dict(WIDE_CONFIGS), served=served,
         f32_model_checks=models, main_path_launches=totals,
         decode_launches_by_body=bodies,
         tolerance={"prefill_logits": f"rtol {FLASH_RTOL}, atol "
                                      f"{FLASH_ATOL} (f32 model), or the "
                                      "kernel path no farther from the f32 "
                                      "oracle path than the plain path",
                    "decode_logits": f"rtol = atol = {DEC_TOL} (f32 model)"})
    return totals


#: deep_serve's config: google/gemma-2b's widths (WIDE_CONFIGS) with its 8
#: query heads x 256 regrouped as 4 x 512 -- the query width stays 2048, G
#: is 4 -- a shape past both kernels' built widths, not a public model (no
#: public decoder's config.json has a standard-attention head_dim past
#: 256); WIDE_LAYERS layers, bf16
DEEP_CONFIG = ("deep-512", dict(d_model=2048, n_heads=4, n_kv_heads=1,
                                head_dim=512, d_ff=16384,
                                vocab_size=256000))


def phase_deep_serve(dev, widths=None, *, serve_kw=None,
                     shard_rows=(8, 2064)):
    """lm_serve's path at hd 512 (DEEP_CONFIG): `phase_lm_serve`
    (RAGEngine over the bench RagDB, 8 requests of a 2048-token prompt,
    prefill through the flash kernel -- four column pieces of 128 a row in
    bf16, two of 256 in f32, one launch a layer -- and 16 decode steps
    through the decode kernel, its gates, times beside SDPA's, bounds and
    the recomputed share of Q . K^T; 2 counted serves), then the same widths in f32 through
    `reduced_model_check` with `phase_wide_serve`'s gates, then
    `decode_attention_sharded` at hd 512 over 4 sequence shards of the
    card (sliced caches read in place) against the unsharded kernel and
    the plain version. No plain version gets a CUDA tensor in a counted
    run. ``widths`` (DEEP_CONFIG's when None; head_dim 512 with one KV
    head and 4 query heads), ``serve_kw`` (`phase_lm_serve`'s sizes) and
    ``shard_rows`` (B, cache rows of the sharded decode) cut it for a
    rehearsal on the CPU."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import TransformerConfig
    t_phase = time.perf_counter()
    tag = DEEP_CONFIG[0]
    widths = widths or DEEP_CONFIG[1]
    cfg = TransformerConfig(name=f"{tag}-{WIDE_LAYERS}l",
                            n_layers=WIDE_LAYERS, dtype="bfloat16", **widths)
    check(cfg.hd == 512
          and attn_lib.row_pieces(torch.bfloat16, cfg.hd)[1] == 4,
          f"{tag}: hd {cfg.hd} is not four column pieces in bf16")
    row = phase_lm_serve(dev, cfg, serves=2, name=f"deep_serve_{tag}",
                         **(serve_kw or {}))
    gc.collect()
    torch.cuda.empty_cache()
    plain_f = PlainOnCard(fa_mod.flash_attention_plain)
    plain_d = PlainOnCard(dec_mod.decode_attention_plain)
    fa_mod.flash_attention_plain = plain_f
    dec_mod.decode_attention_plain = plain_d
    try:
        chk = reduced_model_check(dev, tag,
                                  dataclasses.replace(cfg, dtype="float32"),
                                  oracle=True)
        check(plain_f.cuda_calls == 0 and plain_d.cuda_calls == 0,
              f"{tag}: a plain version ran on CUDA tensors")
    finally:
        fa_mod.flash_attention_plain = plain_f.fn
        dec_mod.decode_attention_plain = plain_d.fn
    gc.collect()
    torch.cuda.empty_cache()

    # decode_attention_sharded at hd 512: 4 sequence shards of the card,
    # one sequence live in the first shard only
    (B, Sc), n_sh, KV, hd = shard_rows, 4, cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KV
    mesh = make_mesh((n_sh,), ("data",), devices=[dev] * n_sh)
    gd = torch.Generator(device=dev).manual_seed(SEED + 31)
    bf = dict(generator=gd, device=dev, dtype=torch.bfloat16)
    qd = torch.randn((B, KV * G, hd), **bf)
    kc, vc = (torch.randn((B, Sc, KV, hd), **bf) for _ in range(2))
    lengths = torch.tensor([Sc - 15] * (B - 1) + [Sc // n_sh // 2],
                           dtype=torch.int32, device=dev)
    qg = qd.reshape(B, KV, G, hd)
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    out = dec_ops.decode_attention_sharded(mesh, "data", qd, kc, vc, lengths,
                                           n_kv=KV)
    sharded_launches = dec_mod.LAUNCHES
    check(sharded_launches == n_sh, f"decode_attention_sharded at hd 512: "
          f"{sharded_launches} launches for {n_sh} shards")
    acc, l_s = dec_ops.merge_sharded(mesh, "data", qg, kc, vc, lengths)
    a1, _, l1 = dec_mod.decode_attention_cuda(qg, kc, vc, lengths)
    a_p, _, l_p = dec_mod.decode_attention_plain(qg, kc, vc, lengths)
    sync()
    sh_err, ratio = attn_ok(acc / l_s, a1 / l1, DEC_TOL, DEC_TOL)
    _, ratio_p = attn_ok(acc / l_s, a_p / l_p, DEC_TOL, DEC_TOL)
    check(ratio <= 1 and ratio_p <= 1 and torch.isfinite(acc / l_s).all(),
          f"sharded decode at hd 512 off the unsharded kernel: {sh_err} "
          f"(x{ratio}), the plain version x{ratio_p}")
    check(torch.equal(out, (acc / l_s).reshape(B, KV * G, hd).to(qd.dtype)),
          "decode_attention_sharded at hd 512 != its merged partials")
    sharded_ms = events_ms(lambda: dec_ops.decode_attention_sharded(
        mesh, "data", qd, kc, vc, lengths, n_kv=KV), 20)
    del qd, kc, vc, a1, a_p, out, acc

    # past 256 every decode launch is the SIMT body's (column pieces)
    check(row["decode"]["tc_launches"] == 0,
          "deep_serve launched the tensor-core decode body")
    totals = {"flash": row["flash"]["launches"] + chk["flash_launches"],
              "decode": (row["decode"]["launches"] + chk["decode_launches"]
                         + sharded_launches),
              "flash_err": row["flash"]["max_abs_err"],
              "decode_err": max(row["decode"]["max_abs_err"], sh_err),
              "decode_row": row["decode"]}
    emit("deep_serve", seconds=time.perf_counter() - t_phase,
         layers=WIDE_LAYERS, config={tag: widths},
         shape_note="gemma-2b's widths with 8 x 256 query heads regrouped "
                    "as 4 x 512: a shape, not a public model",
         served={key: row[key] for key in ("flash", "decode")},
         f32_model_check=chk,
         sharded_decode={"shards": n_sh, "shape": [B, Sc, KV, G, hd],
                         "launches": sharded_launches, "max_abs_err": sh_err,
                         "ms": sharded_ms},
         main_path_launches=totals,
         tolerance={"prefill_logits": f"rtol {FLASH_RTOL}, atol "
                                      f"{FLASH_ATOL} (f32 model), or the "
                                      "kernel path no farther from the f32 "
                                      "oracle path than the plain path",
                    "decode_logits": f"rtol = atol = {DEC_TOL} (f32 model)",
                    "sharded_decode": f"rtol = atol = {DEC_TOL} on the "
                                      "merged f32 partials; the output is "
                                      "them rounded, bit for bit"})
    return totals


def onehot_ms(dev, cfg, tokens):
    """CUDA-event ms of the one-hot dispatch and combine contractions of one
    MoE layer at a training step's groups (tokens / moe_group groups):
    forward alone, and forward + backward (d x through the dispatch; d
    combine and d expert outputs through the combine) -- a remat step runs
    the forward twice and the backward once."""
    from repro_torch.models.moe import capacity
    t = cfg.moe_group
    G, E, C, D = tokens // t, cfg.n_experts, capacity(t, cfg.moe_spec()), \
        cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def rnd(*shape, grad=False):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(grad)

    disp, x = rnd(G, t, E, C), rnd(G, t, D, grad=True)
    comb, yout = rnd(G, t, E, C, grad=True), rnd(G, E, C, D, grad=True)
    gx, gy = rnd(G, E, C, D), rnd(G, t, D)

    def fwd():
        with torch.no_grad():
            torch.einsum("gtec,gtd->gecd", disp, x)
            torch.einsum("gtec,gecd->gtd", comb, yout)

    def fwd_bwd():
        a = torch.einsum("gtec,gtd->gecd", disp, x)
        b = torch.einsum("gtec,gecd->gtd", comb, yout)
        torch.autograd.backward([a, b], [gx, gy])

    return events_ms(fwd, 5), events_ms(fwd_bwd, 5)


def phase_train(dev, cfg=None, *, steps=40, batch=8, seq=1024, peak_lr=3e-4,
                warmup=5, cpu_layers=2, cpu_batch=2, cpu_seq=256,
                launcher_steps=4, launcher_arch="granite-moe-1b-a400m",
                launcher_device=None):
    """The training path at granite-moe-1b-a400m FULL (``cfg`` takes
    another config). It launches no kernel: the reference trains through
    plain attention, and so does the port. Each part prints its line.
    (a) train_card_vs_cpu: FULL width cut to ``cpu_layers`` layers, f32,
        TF32 off, one AdamW step on the card and on the CPU from the same
        numpy weights: loss within rtol 1e-5, global grad norm within 1e-4,
        the router choices (every layer, forward and remat recompute)
        equal.
    (b) train: FULL (bf16, 24 layers) through `Trainer`, ``steps`` steps
        of ``batch`` x ``seq`` synthetic tokens, AdamW (weight decay 0.1)
        at the launcher's peak ``peak_lr`` on a phase-local cosine schedule
        (warmup ``warmup`` over ``steps``; the launcher's warmup of 100
        steps would barely move the run), one async checkpoint, at the
        end: every loss finite, the last logged loss below the first. 40
        steps, not 20: over the first 20 the loss moves less than its
        batch-to-batch spread at every peak tried (3e-5 to 3e-3; above
        3e-4 the routers' load-balancing term grows faster than the
        cross-entropy falls; `tools/train_schedules.py`). One checkpoint:
        a FULL train state is 13.4 GB, and the script keeps its disk
        writes to one such state.
    (c) train_restart: the straight run goes on 2 steps in memory;
        resume_or_init picks the checkpoint (step ``steps``, parameters
        equal to the run's) and the same 2 steps replayed from it equal the
        straight run's parameters bit for bit -- (b) and (c) under
        torch.use_deterministic_algorithms (the embedding's and the
        gather's backward would add by atomics).
    (d) train_launcher: `launch.train.main` at FULL width for
        ``launcher_steps`` steps without --ckpt (with it the launcher saves
        every steps / 4 steps: 5 FULL states, 67 GB), then twice on the
        card with --reduced and --ckpt: the second resumes at the last
        step and trains none."""
    import contextlib
    import io
    import tempfile
    import warnings
    from repro_torch.configs import granite_moe_1b
    from repro_torch.data.lm_pipeline import Prefetcher, synthetic_lm_batches
    from repro_torch.launch import train as train_launch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import tree as T
    from repro_torch.training.fault_tolerance import (StragglerDetector,
                                                      resume_or_init)
    from repro_torch.training.optimizer import adamw, cosine_schedule
    from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                                 init_state, make_train_step)

    t_phase = time.perf_counter()
    cfg = cfg or granite_moe_1b.FULL
    fa_mod.LAUNCHES = dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0

    # (a) one step on the card against the CPU
    small = dataclasses.replace(cfg, n_layers=cpu_layers, dtype="float32")
    cpu_model = tfm.init(small, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    card_model = tfm.from_numpy(tfm.to_numpy(cpu_model), small, device=dev)
    batch_a = next(synthetic_lm_batches(small.vocab_size, cpu_batch, cpu_seq,
                                        seed=SEED))

    def one_step(model):
        chosen, route = [], moe_mod._route

        def spy(p, spec, x):
            out = route(p, spec, x)
            chosen.append(out[1].cpu())
            return out
        moe_mod._route = spy
        try:
            opt = adamw(1e-4)
            step = make_train_step(lambda p, b: tfm.loss_fn(p, small, b), opt)
            t0 = time.perf_counter()
            _, m = step(init_state(model, opt), batch_a)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        finally:
            moe_mod._route = route
        return loss, gnorm, chosen, time.perf_counter() - t0

    l_cpu, g_cpu, r_cpu, cpu_s = one_step(cpu_model)
    l_card, g_card, r_card, card_s = one_step(card_model)
    routes_equal = len(r_cpu) == len(r_card) and all(
        torch.equal(a, b) for a, b in zip(r_cpu, r_card))
    emit("train_card_vs_cpu", layers=cpu_layers, batch=cpu_batch,
         seq=cpu_seq, dtype="float32", tf32=False, loss=[l_card, l_cpu],
         grad_norm=[g_card, g_cpu], routes=len(r_card),
         routes_equal=routes_equal, step_s={"card": card_s, "cpu": cpu_s})
    check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
          f"card loss {l_card} vs CPU {l_cpu}")
    check(abs(g_card - g_cpu) <= 1e-4 * g_cpu,
          f"card grad norm {g_card} vs CPU {g_cpu}")
    check(routes_equal, "router choices differ between the card and the CPU")
    del cpu_model, card_model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) FULL through Trainer, deterministic; (c) restart and replay
    torch.cuda.reset_peak_memory_stats()
    opt = adamw(cosine_schedule(peak_lr, warmup, steps), weight_decay=0.1)
    step_fn = make_train_step(lambda p, b: tfm.loss_fn(p, cfg, b), opt,
                              donate=False)
    losses, logs = [], []

    def recorded(state, b):
        state, m = step_fn(state, b)
        losses.append(m["loss"])
        return state, m

    def fresh():
        return init_state(tfm.init(cfg, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev), opt)

    detector = StragglerDetector()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as nondet, \
            tempfile.TemporaryDirectory() as d:
        warnings.simplefilter("always")
        dts = []
        record = detector.record
        detector.record = lambda step, dt_s: dts.append(dt_s) or record(
            step, dt_s)
        t0 = time.perf_counter()
        trainer = Trainer(
            TrainerConfig(total_steps=steps, ckpt_dir=d, ckpt_every=steps + 1,
                          log_every=10),
            recorded, fresh(), Prefetcher(synthetic_lm_batches(
                cfg.vocab_size, batch, seq, seed=SEED)),
            straggler_detector=detector, log_fn=logs.append)
        final = trainer.run()
        run_s = time.perf_counter() - t0
        history = trainer.history
        train_peak = peak_gb()
        loss_vals = [float(x) for x in losses]
        step_ms = statistics.median(dts[1:]) * 1e3
        tokens = batch * seq
        flop = 6 * cfg.active_param_count() * tokens
        del trainer
        gc.collect()
        oh_f, oh_fb = onehot_ms(dev, cfg, tokens)
        onehot_step_ms = cfg.n_layers * (oh_f + oh_fb)
        emit("train", seconds=time.perf_counter() - t_phase, model=cfg.name,
             params=cfg.param_count(), active_params=cfg.active_param_count(),
             steps=steps, batch=batch, seq=seq,
             optimizer=f"adamw(cosine_schedule({peak_lr}, {warmup}, "
                       f"{steps}), weight_decay=0.1)",
             kernels_launched={"flash_attention": fa_mod.LAUNCHES,
                               "decode_attention": dec_mod.LAUNCHES,
                               "note": "the training path launches no "
                                       "kernel: attention trains through "
                                       "plain PyTorch, as the reference "
                                       "through plain jnp"},
             run_s=run_s, step_ms=[x * 1e3 for x in dts],
             step_ms_median=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
             model_flop_share_of_bf16_peak=flop / (step_ms / 1e3) / BF16_FLOPS,
             flop_a_step=flop,
             onehot_ms_a_layer={"forward": oh_f, "forward_backward": oh_fb},
             onehot_share_of_step=onehot_step_ms / step_ms,
             losses=loss_vals, logged=history, checkpoints=ckpt.all_steps(d),
             peak_mem_gb=train_peak)
        check(len(loss_vals) == steps and all(np.isfinite(loss_vals)),
              f"non-finite losses: {loss_vals}")
        check(history[-1]["loss"] < history[0]["loss"],
              f"loss did not fall: {history[0]['loss']} -> "
              f"{history[-1]['loss']}")
        check(ckpt.all_steps(d) == [steps], f"checkpoints {ckpt.all_steps(d)}")

        # the straight run goes on two steps; the restart replays them
        t0 = time.perf_counter()
        replay_batches = synthetic_lm_batches(cfg.vocab_size, batch, seq,
                                              seed=SEED, start_step=steps)
        pair = [next(replay_batches) for _ in range(2)]
        ran = [p.detach().clone() for p in T.leaves(final["params"])]
        for b in pair:
            final, _ = step_fn(final, b)
        straight = [p.detach().clone() for p in T.leaves(final["params"])]
        del final
        gc.collect()
        resumed, start = resume_or_init(d, fresh)
        resume_s = time.perf_counter() - t0
        check(start == steps and resumed["step"] == steps,
              f"resume_or_init picked step {start}")
        check(all(torch.equal(a, b) for a, b in zip(
            ran, T.leaves(resumed["params"]))),
            "the resumed parameters differ from the run's")
        del ran
        for b in pair:
            resumed, _ = step_fn(resumed, b)
        replay = [(a.float() - b.float()).abs().max().item()
                  for a, b in zip(T.leaves(resumed["params"]), straight)]
        replay_equal = all(torch.equal(a, b) for a, b in zip(
            T.leaves(resumed["params"]), straight))
        del resumed, straight
    torch.use_deterministic_algorithms(False)
    nondet_ops = sorted({str(w.message)[:80] for w in nondet
                         if "deterministic" in str(w.message)})
    emit("train_restart", resume_step=start, seconds=resume_s,
         replay_steps=[steps, steps + 1], bit_equal=replay_equal,
         max_abs_diff=max(replay),
         gate="bit for bit under torch.use_deterministic_algorithms(True)",
         nondeterministic_ops_warned=nondet_ops)
    check(replay_equal, f"replay of steps {steps}-{steps + 1} differs from "
          f"the straight run: max |diff| {max(replay)}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the launcher: FULL without checkpoints, then REDUCED twice with
    # --ckpt (the second resumes at the last step)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", launcher_arch, "--steps", str(launcher_steps),
                  "--batch", str(batch), "--seq", str(seq)]
        if launcher_device is not None:         # a rehearsal off the card
            common += ["--device", launcher_device]
        for run, argv in (("full", common),
                          ("reduced", common + ["--reduced", "--ckpt", d]),
                          ("reduced_resumed", common + ["--reduced",
                                                        "--ckpt", d])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                state = train_launch.main(argv)
            runs[run] = {"argv": " ".join(argv), "seconds":
                         time.perf_counter() - t0, "step": state["step"],
                         "steps_logged": out.getvalue().count("step "),
                         "checkpoints": ckpt.all_steps(d)}
            del state
            gc.collect()
            torch.cuda.empty_cache()
    emit("train_launcher", runs=runs, seconds=time.perf_counter() - t_phase,
         kernels_launched={"flash_attention": fa_mod.LAUNCHES,
                           "decode_attention": dec_mod.LAUNCHES},
         peak_mem_gb=peak_gb())
    for run in ("full", "reduced"):
        check(runs[run]["step"] == launcher_steps
              and runs[run]["steps_logged"] >= 1,
              f"the launcher's {run} run: {runs[run]}")
    check(runs["reduced_resumed"]["step"] == launcher_steps
          and runs["reduced_resumed"]["steps_logged"] == 0,
          f"the launcher did not resume: {runs['reduced_resumed']}")
    check(fa_mod.LAUNCHES == 0 and dec_mod.LAUNCHES == 0,
          f"training launched {fa_mod.LAUNCHES} flash / {dec_mod.LAUNCHES} "
          "decode kernels")


# ---------------------------------------------------------------------------
# training scale-out, recsys and GNN (no kernel: plain PyTorch, as the
# reference computes all of it outside Pallas)
# ---------------------------------------------------------------------------

def grad_tree(model, loss):
    """The gradient of ``loss`` over ``model`` as the reference's tree (a
    model's layers stacked)."""
    from repro_torch.training import tree as T
    gs = torch.autograd.grad(loss, T.leaves(model))
    it = iter(gs)
    items = T.ref_items(T.tree_map(lambda _: next(it), model))
    return T.unflatten([p for p, _ in items],
                       [T.stacked(g) for _, g in items])


def flat(tree) -> dict:
    from repro_torch.training import tree as T
    return {"/".join(map(str, p)): v for p, v in T.ref_items(tree)}


def leaf_gaps(got, want) -> dict:
    """{leaf: max |got - want| / max |want|} over two gradient trees."""
    out = {}
    for key, w in flat(want).items():
        w = w.float()
        d = (flat(got)[key].float() - w).abs().max().item()
        out[key] = d / max(w.abs().max().item(), 1e-30)
    return out


def kernel_launches() -> dict:
    """Every hand-written kernel's launch counter."""
    return {"arena_scan": kernel_mod.LAUNCHES,
            "arena_scan_paged": kernel_mod.PAGED_LAUNCHES,
            "hybrid_score": hyb_mod.LAUNCHES, "ivf_probe": ivf_mod.LAUNCHES,
            "ivf_compact": ivf_mod.COMPACT_LAUNCHES,
            "flash_attention": fa_mod.LAUNCHES,
            "decode_attention": dec_mod.LAUNCHES}


def reckon_bytes(cfg, opt, shape, axes):
    """Bytes one device holds of a state's params and optimizer state on a
    (shape, axes) mesh by the reference's lm_rules specs, reckoned from
    shard shapes on the meta device (nothing allocated); and the unsharded
    totals."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import tree as T
    mesh = make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))
    model = tfm.Transformer(cfg, device="meta")
    state = {"params": model, "opt": opt.init(model), "step": 0}
    sh = flat(shd.state_shardings(mesh, state, shd.lm_rules(mesh)))
    out = {"params": 0, "opt": 0, "params_unsharded": 0, "opt_unsharded": 0}
    for path, leaf in T.ref_items(state):
        if path[0] == "step":
            continue
        full, size = T.shape(leaf), T.first(leaf).element_size()
        out[path[0]] += int(np.prod(sh["/".join(map(str, path))]
                                    .shard_shape(full))) * size
        out[path[0] + "_unsharded"] += int(np.prod(full)) * size
    return out


def phase_train_mesh(dev, cfg=None, *, batch=8, seq=1024, mesh_shape=(2, 4),
                     small_layers=2, launcher_steps=8, moe_groups=32,
                     ef_rounds=50, launcher_arch="granite-moe-1b-a400m",
                     launcher_extra=()):
    """Training on a logical (data, model) mesh of the card (the port's
    mesh is single-controller: every shard a view on one device). No
    kernel: plain PyTorch, as the reference trains outside Pallas.
    (a) the vocab-parallel loss against the plain loss: granite at full
        width cut to ``small_layers`` layers, f32, TF32 off (loss within
        rel 1e-5, every grad leaf within rtol 1e-4 / atol 1e-5, the
        reference's tolerances); granite FULL in bf16 from the launcher's
        init and first batch (loss within rel 1e-3, every leaf's worst
        |diff| within 5e-2 of its largest magnitude: bf16 sums over the
        tp slices round in another order);
    (b) `launch.train.main` with ``--mesh 2x4 --vp-loss`` against the
        plain run, ``launcher_steps`` steps each from the same init and
        batches: per-step losses within rel 5e-3, step ms, peak memory;
    (c) `moe_apply_scatter_shmap` under set_moe_mesh(mesh, ("data",)) at
        granite's MoE layer (``moe_groups`` groups of moe_group tokens):
        y and aux equal the per-chunk scatter's concatenation and mean;
        one layer's ms beside the scatter over all groups and the einsum;
    (d) `ef_compress` over (a)'s FULL gradients, ``ef_rounds`` rounds:
        the sum of the dequantised grads within 1% of rounds x g (every
        leaf); one pass's ms beside its byte bound; `psum_int8` /
        `psum_bf16` over the dp shards' gradients against their exact
        sum (every leaf within 4e-2 / 2e-2 of its largest magnitude);
    (e) a REDUCED state saved on the card and `reshard_state` onto the
        mesh's shardings: leaves equal bit for bit, every piece of every
        leaf of shard_shape, one vp-loss step after the round trip equal
        bit for bit to one without it (deterministic algorithms);
    (f) reckoned on the meta device, never allocated: bytes a device holds
        of grok-1-314b FULL (Adafactor) on (16, 16) and (2, 16, 16) and of
        granite FULL (AdamW) on ``mesh_shape``."""
    import contextlib
    import io
    import tempfile
    import warnings
    from repro_torch.configs import get, granite_moe_1b
    from repro_torch.data.lm_pipeline import synthetic_lm_batches
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop
    from repro_torch.training import tree as T
    from repro_torch.training.fault_tolerance import reshard_state
    from repro_torch.training.optimizer import adafactor, adamw

    t_phase = time.perf_counter()
    cfg = cfg or granite_moe_1b.FULL
    before = kernel_launches()
    mesh = make_host_mesh(*mesh_shape, device=dev)
    n_dp = mesh_shape[0]
    mesh_arg = "x".join(map(str, mesh_shape))

    # (a) the vp loss against the plain loss: f32 cut, then FULL bf16
    small = dataclasses.replace(cfg, n_layers=small_layers, dtype="float32")
    model = tfm.init(small, generator=torch.Generator(device=dev).manual_seed(
        SEED), device=dev).requires_grad_(True)
    b = next(synthetic_lm_batches(small.vocab_size, batch, seq, seed=SEED,
                                  device=dev))
    plain = tfm.loss_fn(model, small, b)
    g_plain = grad_tree(model, plain)
    vp = tfm.make_vp_loss_fn(small, mesh)(model, b)
    g_vp = grad_tree(model, vp)
    f32_rel = abs(vp.item() - plain.item()) / abs(plain.item())
    f32_close = {k: bool(torch.allclose(flat(g_vp)[k], v, rtol=1e-4,
                                        atol=1e-5))
                 for k, v in flat(g_plain).items()}
    f32_gaps = leaf_gaps(g_vp, g_plain)
    del model, g_plain, g_vp, plain, vp
    gc.collect()
    torch.cuda.empty_cache()

    full = tfm.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).requires_grad_(True)     # the launcher's init
    b0 = next(synthetic_lm_batches(cfg.vocab_size, batch, seq, device=dev))
    t0 = time.perf_counter()
    plain = tfm.loss_fn(full, cfg, b0)
    g_full = grad_tree(full, plain)
    sync()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vp = tfm.make_vp_loss_fn(cfg, mesh)(full, b0)
    g_vp = grad_tree(full, vp)
    sync()
    vp_s = time.perf_counter() - t0
    bf16_rel = abs(vp.item() - plain.item()) / abs(plain.item())
    bf16_gaps = leaf_gaps(g_vp, g_full)
    del g_vp
    emit("train_mesh_loss", card=CARD, mesh=list(mesh_shape),
         f32={"layers": small_layers, "loss_rel_gap": f32_rel,
              "leaves_within_rtol1e-4_atol1e-5": sum(f32_close.values()),
              "leaves": len(f32_close),
              "worst_leaf_gap": max(f32_gaps.values()),
              "worst_leaf": max(f32_gaps, key=f32_gaps.get)},
         bf16_full={"loss": [vp.item(), plain.item()],
                    "loss_rel_gap": bf16_rel,
                    "leaf_gaps": {k: round(v, 6) for k, v in
                                  bf16_gaps.items()},
                    "gate": "loss rel <= 1e-3, every leaf <= 5e-2 of its "
                            "largest magnitude",
                    "step_s": {"plain": plain_s, "vp": vp_s}})
    check(f32_rel <= 1e-5, f"f32 vp loss gap {f32_rel}")
    check(all(f32_close.values()), "f32 vp grads outside rtol 1e-4 / atol "
          f"1e-5: {[k for k, ok in f32_close.items() if not ok]}")
    check(bf16_rel <= 1e-3, f"bf16 vp loss gap {bf16_rel}")
    check(max(bf16_gaps.values()) <= 5e-2, f"bf16 vp grad gaps {bf16_gaps}")

    # (d) compression over (a)'s FULL gradients and the dp shards' ones
    ef = comp.ef_init(full)
    total = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
             for k, v in flat(g_full).items()}
    for _ in range(ef_rounds):
        q, ef = comp.ef_compress(g_full, ef)
        for k, v in flat(q).items():
            total[k] += v.float()
        del q
    ef_err = {k: ((total[k] - ef_rounds * g.float()).abs().max().item()
                  / max(ef_rounds * g.float().abs().max().item(), 1e-30))
              for k, g in flat(g_full).items()}
    del total
    ef_ms = events_ms(lambda: comp.ef_compress(g_full, ef), 3)
    n_param = sum(v.numel() for v in flat(g_full).values())
    ef_bytes = sum(v.numel() * (2 * v.element_size() + 8)
                   for v in flat(g_full).values())
    del ef, g_full
    gc.collect()
    torch.cuda.empty_cache()
    h = batch // n_dp
    shard_g = [flat(grad_tree(full, tfm.loss_fn(
        full, cfg, {k: v[i * h:(i + 1) * h] for k, v in b0.items()})))
        for i in range(n_dp)]
    psum = {"int8": {}, "bf16": {}}
    for key in shard_g[0]:
        parts = [g[key] for g in shard_g]
        exact = sum(p.float() for p in parts)
        scale = max(exact.abs().max().item(), 1e-30)
        for name, fn in (("int8", comp.psum_int8), ("bf16", comp.psum_bf16)):
            psum[name][key] = (fn(parts).float() - exact).abs().max().item() \
                / scale
    del shard_g, full, b0
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_mesh_compression", card=CARD, params=n_param,
         ef_rounds=ef_rounds, ef_worst_leaf_err=max(ef_err.values()),
         ef_worst_leaf=max(ef_err, key=ef_err.get),
         ef_pass_ms=ef_ms, ef_pass_bytes=ef_bytes,
         ef_pass_bound_ms=ef_bytes / HBM_BPS * 1e3,
         psum_dp_shards=n_dp,
         psum_int8_worst_rel=max(psum["int8"].values()),
         psum_bf16_worst_rel=max(psum["bf16"].values()),
         psum_int8_worst_leaf=max(psum["int8"], key=psum["int8"].get),
         psum_bf16_worst_leaf=max(psum["bf16"], key=psum["bf16"].get))
    check(max(ef_err.values()) < 0.01, f"EF residual not carried: {ef_err}")
    check(max(psum["int8"].values()) < 4e-2, f"psum_int8 {psum['int8']}")
    check(max(psum["bf16"].values()) < 2e-2, f"psum_bf16 {psum['bf16']}")

    # (b) the launcher on the mesh with the vp loss against the plain run
    def launcher(argv):
        losses, dts, real = [], [], train_loop.make_train_step

        def spy(loss_fn, opt, **kw):
            step = real(loss_fn, opt, **kw)

            def timed(state, bb):
                t0 = time.perf_counter()
                state, m = step(state, bb)
                losses.append(float(m["loss"]))
                dts.append((time.perf_counter() - t0) * 1e3)
                return state, m
            return timed
        train_loop.make_train_step = spy
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                state = train_launch.main(argv)
        finally:
            train_loop.make_train_step = real
        out = {"argv": " ".join(argv), "seconds": time.perf_counter() - t0,
               "step": state["step"], "losses": losses, "step_ms": dts,
               "step_ms_median": statistics.median(dts[1:] or dts),
               "peak_mem_gb": peak_gb()}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return out

    common = ["--arch", launcher_arch, "--steps", str(launcher_steps),
              "--batch", str(batch), "--seq", str(seq), "--device", str(dev),
              *launcher_extra]
    runs = {"plain": launcher(common),
            "mesh_vp": launcher(common + ["--mesh", mesh_arg, "--vp-loss"])}
    gaps = [abs(a - b) / abs(b) for a, b in zip(runs["mesh_vp"]["losses"],
                                                runs["plain"]["losses"])]
    emit("train_mesh_launcher", card=CARD, runs=runs, loss_rel_gaps=gaps,
         gate="every step's loss within rel 5e-3 of the plain run's")
    for run in runs.values():
        check(run["step"] == launcher_steps
              and len(run["losses"]) == launcher_steps
              and all(np.isfinite(run["losses"])), f"launcher run {run}")
    check(max(gaps) <= 5e-3, f"mesh vp losses vs plain: {gaps}")

    # (c) the mesh-local MoE dispatch at granite's MoE layer
    spec = cfg.moe_spec()
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    dtype = tfm.compute_dtype(cfg)
    p = moe_mod.moe_init(gen, spec, dtype, device=dev)
    x = torch.randn((moe_groups, cfg.moe_group, cfg.d_model), generator=gen,
                    device=dev).to(dtype)
    with torch.no_grad():
        moe_mod.set_moe_mesh(mesh, ("data",))
        try:
            y, aux = moe_mod.moe_apply_scatter_shmap(p, spec, x)
            shmap_ms = events_ms(
                lambda: moe_mod.moe_apply_scatter_shmap(p, spec, x), 5)
        finally:
            moe_mod.set_moe_mesh(None, ())
        parts = [moe_mod.moe_apply_scatter(p, spec, c) for c in x.chunk(n_dp)]
        y_whole, aux_whole = moe_mod.moe_apply_scatter(p, spec, x)
        scatter_ms = events_ms(lambda: moe_mod.moe_apply_scatter(p, spec, x), 5)
        einsum_ms = events_ms(lambda: moe_mod.moe_apply(p, spec, x), 5)
    y_equal = torch.equal(y, torch.cat([a for a, _ in parts]))
    aux_chunks = torch.stack([a for _, a in parts]).mean()
    emit("train_mesh_moe", card=CARD, groups=moe_groups,
         tokens_a_group=cfg.moe_group, dp_shards=n_dp, y_equal=y_equal,
         aux=[aux.item(), aux_chunks.item()], aux_all_groups=aux_whole.item(),
         y_equal_all_groups_scatter=torch.equal(y, y_whole),
         ms={"shmap": shmap_ms, "scatter": scatter_ms, "einsum": einsum_ms})
    check(y_equal, "the mesh dispatch's y differs from the chunks' scatter")
    check(aux.item() == aux_chunks.item(), f"aux {aux.item()} vs the chunks' "
          f"mean {aux_chunks.item()}")
    del p, x, y, parts, y_whole
    gc.collect()
    torch.cuda.empty_cache()

    # (e) reshard a REDUCED state onto the mesh's shardings
    red = get(launcher_arch).reduced
    opt = adamw(1e-3)
    rb = next(synthetic_lm_batches(red.vocab_size, batch, 64, seed=SEED,
                                   device=dev))
    step = train_loop.make_train_step(tfm.make_vp_loss_fn(red, mesh), opt)

    def fresh(seed):
        return train_loop.init_state(tfm.init(red, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev), opt)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            state = fresh(SEED)
            state, _ = step(state, rb)             # moments not all zero
            ckpt.save(d, 1, state)
            like = fresh(SEED + 1)
            sh = shd.state_shardings(mesh, like, shd.lm_rules(mesh))
            got = reshard_state(d, 1, like, sh)
        saved_equal = all(
            torch.equal(a, c) if torch.is_tensor(a) else a == c
            for a, c in zip(T.leaves(state), T.leaves(got)))
        shards, pieces_ok = flat(sh), True
        n_pieces = 0
        for path, leaf in T.ref_items(got):
            s = shards["/".join(map(str, path))]
            if not torch.is_tensor(T.first(leaf)):
                continue
            for coord in s.coords():
                pieces_ok &= T.shape(s.piece(leaf, coord)) == \
                    s.shard_shape(T.shape(leaf))
                n_pieces += 1
        a, _ = step(state, rb)
        c, _ = step(got, rb)
        step_equal = all(torch.equal(x1, x2) for x1, x2 in
                         zip(T.leaves(a["params"]), T.leaves(c["params"])))
    finally:
        torch.use_deterministic_algorithms(False)
    emit("train_mesh_reshard", card=CARD, model=red.name, mesh=list(mesh_shape),
         leaves_bit_equal=saved_equal, pieces=n_pieces,
         pieces_of_shard_shape=pieces_ok, step_after_bit_equal=step_equal)
    check(saved_equal, "resharded leaves differ from the saved state")
    check(pieces_ok, "a piece's shape differs from shard_shape")
    check(step_equal, "a step after the reshard differs from one without it")
    del state, like, got, a, c
    gc.collect()
    torch.cuda.empty_cache()

    # (f) reckoned per-device bytes, nothing allocated
    reckoned = {}
    grok = get("grok-1-314b").full
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        reckoned[f"grok-1-314b adafactor {shape}"] = reckon_bytes(
            grok, adafactor(1e-3), shape, axes)
    reckoned[f"{cfg.name} adamw {mesh_shape}"] = reckon_bytes(
        cfg, adamw(1e-3), mesh_shape, ("data", "model"))
    after = kernel_launches()
    emit("train_mesh", card=CARD, seconds=time.perf_counter() - t_phase,
         reckoned_bytes_a_device=reckoned,
         kernels_launched={k: after[k] - before[k] for k in after},
         note="the mesh training path launches no kernel (plain PyTorch, "
              "as the reference's plain jnp)")
    check(after == before, f"train_mesh launched kernels: {before} -> {after}")


def cards_sync(cards):
    for c in dict.fromkeys(cards):
        torch.cuda.synchronize(c)


def cards_reset_peaks(cards):
    """Reset each card's peak memory (a card's allocator must have
    allocated once before its stats can be reset)."""
    for c in dict.fromkeys(cards):
        torch.zeros(1, device=c)
        torch.cuda.reset_peak_memory_stats(c)


def cards_idle(fn, cards):
    """Each card's idle share of one call of ``fn`` (torch.profiler, after
    an untimed call): 1 - the union of its kernels' and copies' intervals
    over the call's wall time; None for a card whose trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    cards_sync(cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        cards_sync(cards)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans: dict = {}
    for ev in prof.events():
        if "CUDA" in str(getattr(ev, "device_type", "")) and \
                ev.time_range.elapsed_us() > 0:
            spans.setdefault(ev.device_index, []).append(
                (ev.time_range.start, ev.time_range.end))
    out = {}
    for c in dict.fromkeys(cards):
        busy, end = 0.0, -1.0
        for a, b in sorted(spans.get(c.index, [])):
            if b > end:
                busy += b - max(a, end)
                end = b
        out[str(c)] = (max(0.0, 1 - busy / wall_us)
                       if spans.get(c.index) else None)
    return {"wall_ms": wall_us / 1e3, "idle_share": out}


def placed_bytes(state, cards) -> dict:
    """Bytes of a placed state's params and optimizer pieces a card."""
    from repro_torch.distributed.sharding import Placed
    from repro_torch.launch.mesh import normalize_device
    from repro_torch.training import tree as T
    out = {str(c): 0 for c in dict.fromkeys(cards)}
    for part in ("params", "opt"):
        for _, leaf in T.ref_items(state[part]):
            if isinstance(leaf, Placed):
                for d, n in leaf.nbytes_by_device().items():
                    out[str(normalize_device(d))] += n
    return out


def reckoned_state_bytes(cfg, opt, shape) -> int:
    """The launch tools' per-device bytes of a state's params and
    optimizer on a (data, model) mesh of ``shape`` (`dryrun.tree_bytes`
    over the reference's specs, on meta)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["meta"] * int(np.prod(shape)))
    model = tfm.Transformer(cfg, device="meta")
    state = {"params": model, "opt": opt.init(model)}
    sh = shd.state_shardings(mesh, dict(state, step=0), shd.lm_rules(mesh))
    return dryrun.tree_bytes((state,), (sh,))


def step_roofline(arch_id, cfg, batch, seq, shape) -> dict:
    """The launch tools' H100 roofline of one train step of ``cfg`` at
    batch x seq on a (data, model) mesh of ``shape``, reckoned on meta: the
    cell built and measured as the dry run does, from a registry entry
    that holds this config and shape for the call."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["meta"] * int(np.prod(shape)))
    saved = configs.ARCHS[arch_id]
    configs.ARCHS[arch_id] = dataclasses.replace(
        saved, full=cfg, shapes={"train_cards": {"kind": "train",
                                                 "batch": batch,
                                                 "seq": seq}})
    try:
        cell = steps.build_cell(arch_id, "train_cards", mesh)
        m = dryrun.measure(cell, mesh)
    finally:
        configs.ARCHS[arch_id] = saved
    n = m["n_dev"]
    entry = {"flops": m["cost"].flops / n, "bytes": m["cost"].bytes / n,
             "coll": float(sum(m["coll"].values())),
             "temp_bytes": -(-m["cost"].peak_bytes // n),
             "args_bytes": m["args_bytes"], "model_flops": cell.model_flops,
             "model_bytes": cell.model_bytes}
    a = roofline.analyze(entry, n)
    return {"terms_ms": {k: v * 1e3 for k, v in a["terms_s"].items()},
            "bound_ms": max(a["terms_s"].values()) * 1e3,
            "dominant": a["dominant"],
            "roofline_fraction": a["roofline_fraction"],
            "collective_bytes": m["coll"]}


def cards_launcher(argv, cards):
    """`launch.train.main` over ``argv`` with its step spied: per-step
    losses and ms (every card synchronised), each card's peak GB, and the
    final state with its step function and last batch."""
    import contextlib
    import io
    from repro_torch.launch import train as train_launch
    from repro_torch.training import train_loop
    losses, dts, last, real = [], [], {}, train_loop.make_train_step

    def spy(loss_fn, opt, **kw):
        step = real(loss_fn, opt, **kw)

        def timed(state, bb):
            t0 = time.perf_counter()
            state, m = step(state, bb)
            losses.append(float(m["loss"]))
            cards_sync(cards)
            dts.append((time.perf_counter() - t0) * 1e3)
            last.update(step=step, batch=bb)
            return state, m
        return timed
    cards_reset_peaks(cards)
    train_loop.make_train_step = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state = train_launch.main(argv)
    finally:
        train_loop.make_train_step = real
    return {"argv": " ".join(argv), "seconds": time.perf_counter() - t0,
            "losses": losses, "step_ms": dts,
            "step_ms_median": statistics.median(dts[1:] or dts),
            "peak_gb": {str(c): torch.cuda.max_memory_allocated(c) / 1e9
                        for c in dict.fromkeys(cards)}}, state, last


def cards_free(cards):
    gc.collect()
    for c in dict.fromkeys(cards):
        with torch.cuda.device(c):
            torch.cuda.empty_cache()


def cards_parity(mesh, cfg, opt_fn, *, steps, batch, seq):
    """``cfg`` trained ``steps`` steps by the plain one-card trainer on the
    mesh's first card and, from the same init and batches, by the step
    over the state laid on ``mesh`` (the vocab-parallel loss): both runs'
    losses and step ms."""
    from repro_torch.data.lm_pipeline import synthetic_lm_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop
    cards = list(mesh.devices)
    first = cards[0]
    data = synthetic_lm_batches(cfg.vocab_size, batch, seq, seed=SEED)
    batches = [next(data) for _ in range(steps)]
    skeleton = tfm.Transformer(cfg, device="meta")
    opt = opt_fn(steps)
    sh = shd.state_shardings(mesh, {"params": skeleton,
                                    "opt": opt.init(skeleton), "step": 0},
                             shd.lm_rules(mesh))
    out = {}
    for name in ("plain", "cards"):
        model = tfm.init(cfg, generator=torch.Generator(device=first)
                         .manual_seed(SEED), device=first)
        if name == "plain":
            state = train_loop.init_state(model, opt)
            step = train_loop.make_train_step(
                lambda p, b: tfm.loss_fn(p, cfg, b), opt)
        else:
            state = train_loop.init_state(model, opt, sh, split=True)
            step = train_loop.make_train_step(tfm.make_vp_loss_fn(cfg, mesh),
                                              opt)
        del model
        losses, dts = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            cards_sync(cards)
            dts.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"losses": losses, "step_ms": dts,
                     "step_ms_median": statistics.median(dts[1:] or dts)}
        del state, step
        cards_free(cards)
    out["loss_rel_gaps"] = [abs(a - b) / abs(b) for a, b in zip(
        out["cards"]["losses"], out["plain"]["losses"])]
    return out


def cards_grads(mesh, cfg, *, batch, seq):
    """One f32 batch's loss and gradients: the plain one-card loss on the
    mesh's first card and the vp loss over the state laid on ``mesh``,
    from the same init. Returns the gaps, the placed gradients and the
    plain model."""
    from repro_torch.data.lm_pipeline import synthetic_lm_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop
    from repro_torch.training import tree as T
    first = mesh.devices[0]
    b = next(synthetic_lm_batches(cfg.vocab_size, batch, seq, seed=SEED + 1))

    def fresh():
        return tfm.init(cfg, generator=torch.Generator(device=first)
                        .manual_seed(SEED), device=first)
    plain = fresh().requires_grad_(True)
    l_plain, g_plain = train_loop._grads(
        lambda p, bb: tfm.loss_fn(p, cfg, bb), plain, b)
    g_plain = {k: T.stacked(v) for k, v in flat(g_plain).items()}
    model = fresh()
    placed = shd.place(model, shd.named(mesh, shd.param_pspecs(
        model, shd.lm_rules(mesh), mesh)), split=True)
    del model
    l_cards, g_cards = train_loop._grads(tfm.make_vp_loss_fn(cfg, mesh),
                                         placed, b)
    close, gaps = {}, {}
    for key, g in flat(g_cards).items():
        got = g.assemble(first)
        close[key] = bool(torch.allclose(got, g_plain[key], rtol=1e-4,
                                         atol=1e-5))
        gaps[key] = ((got - g_plain[key]).abs().max().item()
                     / max(g_plain[key].abs().max().item(), 1e-30))
    rel = abs(l_cards.item() - l_plain.item()) / abs(l_plain.item())
    return {"loss": [l_cards.item(), l_plain.item()], "loss_rel_gap": rel,
            "leaves_within_rtol1e-4_atol1e-5": sum(close.values()),
            "leaves": len(close), "worst_leaf_gap": max(gaps.values()),
            "worst_leaf": max(gaps, key=gaps.get),
            "outside": [k for k, ok in close.items() if not ok]}, \
        g_cards, plain, b


def phase_train_cards(dev, cards=None, *, batch=8, seq=1024, full_steps=10,
                      cut_layers=4, parity_steps=8, f32_layers=2,
                      moe_groups=32, ef_rounds=50, arch_id="yi-6b"):
    """A train state laid on its own cards: every parameter and optimizer
    leaf in pieces by the reference's specs, one allocation a card, the
    step's gathers, reduce-scatters, the vocab-parallel loss and the MoE
    aux as cross-card collectives. No kernel (plain PyTorch, as the
    reference trains outside Pallas); every launch counter is checked.
    With four or more cards, on a (data 2, model 2) mesh of cuda:0..3 (two
    or three: (1, 2) at (b)'s cut):
    (a) `launch.train.main --arch yi-6b --mesh 2x2 --vp-loss` at FULL
        width, bf16: step ms, tokens/s, each card's peak GB and state
        bytes against the launch tools' reckoning (exact), the launch
        tools' H100 roofline of the step, the idle share of one step a
        card (torch.profiler), finite losses;
    (b) yi-6b at full width cut to ``cut_layers`` layers on the cards
        against the plain one-card trainer from the same init and batches:
        per-step losses within rel 5e-3 over ``parity_steps`` bf16 steps;
        cut to ``f32_layers`` layers in f32 (TF32 off), one batch: loss
        within rel 1e-5, every grad leaf within rtol 1e-4 / atol 1e-5;
    (c) granite FULL on the cards: one vp-loss step's loss within rel 1e-3
        of the one-card plain step's; the mesh MoE dispatch
        (`moe_apply_scatter_shmap` under the cards' mesh) at granite's
        layer: aux bit for bit the one-card chunks' mean, y within 2e-2 of
        its largest magnitude (the expert slices' bf16 partial sums);
    (d) `psum_int8` / `psum_bf16` over per-card gradients within 4e-2 /
        2e-2 of the exact sum; `ef_compress` over (b)'s placed f32
        gradients, ``ef_rounds`` rounds within 1% of rounds x g;
    (e) (b)'s bf16 cut after one step: save, `restore(shardings=)` onto
        the cards bit for bit and a step after it bit for bit;
        `reshard_state` onto two of the cards (`make_elastic_mesh`) bit
        for bit and a step after it equal to one on the same state placed
        there directly (deterministic algorithms).
    With one card: (b) on a (2, 2) mesh of cuda:0, each coordinate its own
    pieces (``split``), through the same step."""
    import tempfile
    from repro_torch.configs import get, granite_moe_1b
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop
    from repro_torch.training import tree as T
    from repro_torch.training.fault_tolerance import (make_elastic_mesh,
                                                      reshard_state)
    from repro_torch.training.optimizer import adamw, cosine_schedule

    t_phase = time.perf_counter()
    before = kernel_launches()
    cards = cards or [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
    n = len(cards)
    if n >= 4:
        shape, devices = (2, 2), cards[:4]
    elif n >= 2:
        shape, devices = (1, 2), cards[:2]
    else:
        shape, devices = (2, 2), [cards[0]] * 4
    used = list(dict.fromkeys(devices))
    mesh = make_mesh(shape, ("data", "model"), devices=devices)
    split = len(used) == 1      # one card: a piece a coordinate all the same
    full = get(arch_id).full
    cut = dataclasses.replace(full, n_layers=cut_layers)
    mesh_arg = "x".join(map(str, shape))
    out = {"cards": n, "mesh": list(shape),
           "devices": [str(d) for d in devices]}

    def launcher_opt(steps):
        return adamw(cosine_schedule(3e-4, 100, steps), weight_decay=0.1)

    # (a) the launcher over the cards
    if n >= 2:
        if n >= 4:
            cfg_a = full
            run, state, last = cards_launcher(
                ["--arch", arch_id, "--mesh", mesh_arg, "--vp-loss",
                 "--batch", str(batch), "--seq", str(seq), "--steps",
                 str(full_steps)], used)
        else:                  # two or three cards: (b)'s cut, same path
            cfg_a = cut
            run, state, last = cards_launch_cut(cut, mesh, batch, seq,
                                                full_steps, used)
        have = placed_bytes(state, used)
        reckoned = reckoned_state_bytes(cfg_a, launcher_opt(full_steps),
                                        shape)
        prof = cards_idle(lambda: last["step"](state, last["batch"]), used)
        del state, last
        cards_free(used)
        roof = step_roofline(arch_id, cfg_a, batch, seq, shape)
        step_ms = run["step_ms_median"]
        emit("train_cards_run", card=CARD, cards=n, mesh=list(shape),
             model=cfg_a.name, layers=cfg_a.n_layers,
             params=cfg_a.param_count(), batch=batch, seq=seq,
             steps=full_steps, losses=run["losses"], step_ms=run["step_ms"],
             step_ms_median=step_ms, tokens_per_s=batch * seq / step_ms * 1e3,
             peak_gb=run["peak_gb"], state_bytes=have,
             reckoned_state_bytes_a_device=reckoned,
             roofline=roof, ms_over_bound=step_ms / roof["bound_ms"],
             idle=prof, seconds=run["seconds"],
             blocks="gathered before use, freed after each layer's forward "
                    "and gathered again in its recomputation (remat)")
        out["step_ms"], out["peak_gb"] = step_ms, run["peak_gb"]
        check(len(run["losses"]) == full_steps
              and all(np.isfinite(run["losses"])), f"losses {run['losses']}")
        check(all(v == reckoned for v in have.values()),
              f"state bytes a card {have} vs reckoned {reckoned}")
        check(all(v < 80 for v in run["peak_gb"].values()),
              f"peaks {run['peak_gb']}")

    # (b) parity with the plain one-card trainer
    par = cards_parity(mesh, cut, launcher_opt, steps=parity_steps,
                       batch=batch, seq=seq)
    f32 = dataclasses.replace(full, n_layers=f32_layers, dtype="float32")
    grads, g_cards, plain, gb = cards_grads(mesh, f32, batch=batch, seq=seq)
    emit("train_cards_parity", card=CARD, cards=n, mesh=list(shape),
         split_on_one_card=split,
         bf16={"layers": cut_layers, "steps": parity_steps,
               "losses": {k: par[k]["losses"] for k in ("plain", "cards")},
               "loss_rel_gaps": par["loss_rel_gaps"],
               "step_ms_median": {k: par[k]["step_ms_median"]
                                  for k in ("plain", "cards")},
               "gate": "every step's loss within rel 5e-3"},
         f32=dict(grads, layers=f32_layers,
                  gate="loss rel <= 1e-5, every leaf within rtol 1e-4 / "
                       "atol 1e-5"))
    out["parity"] = {"bf16_worst": max(par["loss_rel_gaps"]),
                     "f32_loss": grads["loss_rel_gap"]}
    check(max(par["loss_rel_gaps"]) <= 5e-3,
          f"cards vs plain losses {par['loss_rel_gaps']}")
    check(grads["loss_rel_gap"] <= 1e-5, f"f32 loss gap {grads}")
    check(not grads["outside"], f"f32 grads outside: {grads['outside']}")
    if n < 2:
        del g_cards, plain, gb
        cards_free(used)
        after = kernel_launches()
        emit("train_cards", card=CARD, cards=n,
             seconds=time.perf_counter() - t_phase,
             kernels_launched={k: after[k] - before[k] for k in after},
             note="one card: (b) on a (2, 2) mesh of cuda:0, every "
                  "coordinate its own pieces; (a), (c)-(e) need two cards")
        check(after == before, f"train_cards launched kernels: {before} -> "
              f"{after}")
        return out

    # (d) compression over the cards' gradients
    per_card = []
    h = batch // n
    for i, c in enumerate(used):
        part = {k: v[i * h:(i + 1) * h] for k, v in gb.items()}
        g = train_loop._grads(lambda p, bb: tfm.loss_fn(p, f32, bb), plain,
                              part)[1]
        per_card.append({k: T.stacked(v).to(c) for k, v in flat(g).items()
                         if k in ("lm_head", "layers/ffn/w_up",
                                  "layers/attn/wq", "final_norm")})
        del g
    psum = {"int8": {}, "bf16": {}}
    for key in per_card[0]:
        xs = [g[key] for g in per_card]
        exact = sum(x.to(used[0]).double() for x in xs)
        scale = max(exact.abs().max().item(), 1e-30)
        for name, fn in (("int8", comp.psum_int8), ("bf16", comp.psum_bf16)):
            res = fn(xs, devices=used)
            check(len(res) == len(used) and all(
                torch.equal(r.to(used[0]), res[0].to(used[0])) for r in res),
                f"psum_{name} differs between cards")
            psum[name][key] = (res[0].double() - exact).abs().max().item() \
                / scale
    del per_card, plain
    cards_free(used)
    ef = comp.ef_init(g_cards)
    total = None
    for _ in range(ef_rounds):
        q, ef = comp.ef_compress(g_cards, ef)
        total = q if total is None else T.tree_map(
            lambda a, b: a.map(torch.add, b), total, q)
    ef_err = {}
    for key, leaf in flat(total).items():
        want = flat(g_cards)[key].assemble(used[0]).double() * ef_rounds
        ef_err[key] = ((leaf.assemble(used[0]).double() - want).abs().max()
                       .item() / max(want.abs().max().item(), 1e-30))
    del total, ef, q, g_cards, gb
    cards_free(used)
    emit("train_cards_compression", card=CARD, cards=n,
         psum_int8_worst_rel=max(psum["int8"].values()),
         psum_bf16_worst_rel=max(psum["bf16"].values()), psum=psum,
         ef_rounds=ef_rounds, ef_worst_leaf_err=max(ef_err.values()),
         ef_worst_leaf=max(ef_err, key=ef_err.get))
    check(max(psum["int8"].values()) < 4e-2, f"psum_int8 {psum['int8']}")
    check(max(psum["bf16"].values()) < 2e-2, f"psum_bf16 {psum['bf16']}")
    check(max(ef_err.values()) < 0.01, f"EF residual not carried: {ef_err}")

    # (c) granite FULL: a vp-loss step over the cards, the mesh dispatch
    gcfg = granite_moe_1b.FULL
    gpar = cards_parity(mesh, gcfg, launcher_opt, steps=1, batch=batch,
                        seq=seq)
    spec = gcfg.moe_spec()
    gen = torch.Generator(device=used[0]).manual_seed(SEED + 24)
    dtype = tfm.compute_dtype(gcfg)
    p = moe_mod.moe_init(gen, spec, dtype, device=used[0])
    x = torch.randn((moe_groups, gcfg.moe_group, gcfg.d_model), generator=gen,
                    device=used[0]).to(dtype)
    n_dp = shape[0]
    with torch.no_grad():
        moe_mod.set_moe_mesh(mesh, ("data",))
        try:
            y, aux = moe_mod.moe_apply_scatter_shmap(p, spec, x)
            cards_sync(used)
            t0 = time.perf_counter()
            for _ in range(5):
                moe_mod.moe_apply_scatter_shmap(p, spec, x)
            cards_sync(used)
            shmap_ms = (time.perf_counter() - t0) / 5 * 1e3
        finally:
            moe_mod.set_moe_mesh(None, ())
        parts = [moe_mod.moe_apply_scatter(p, spec, c) for c in x.chunk(n_dp)]
    y_one = torch.cat([a for a, _ in parts])
    aux_one = torch.stack([a for _, a in parts]).mean()
    y_gap = ((y.float() - y_one.float()).abs().max().item()
             / max(y_one.float().abs().max().item(), 1e-30))
    emit("train_cards_moe", card=CARD, cards=n, model=gcfg.name,
         step_loss={"cards": gpar["cards"]["losses"][0],
                    "plain": gpar["plain"]["losses"][0]},
         step_loss_rel_gap=gpar["loss_rel_gaps"][0],
         step_ms={"cards": gpar["cards"]["step_ms"][0],
                  "plain": gpar["plain"]["step_ms"][0]},
         dispatch={"groups": moe_groups, "dp_shards": n_dp,
                   "aux": [aux.item(), aux_one.item()], "y_rel_gap": y_gap,
                   "ms": shmap_ms})
    check(gpar["loss_rel_gaps"][0] <= 1e-3, f"granite step {gpar}")
    check(aux.item() == aux_one.item(), f"aux {aux.item()} vs the chunks' "
          f"{aux_one.item()}")
    check(y_gap <= 2e-2, f"mesh dispatch y gap {y_gap}")
    del p, x, y, parts, y_one
    cards_free(used)

    # (e) checkpoint, restore onto the cards, reshard onto two of them
    opt = launcher_opt(parity_steps)
    model = tfm.init(cut, generator=torch.Generator(device=used[0])
                     .manual_seed(SEED), device=used[0])
    skeleton = tfm.Transformer(cut, device="meta")
    sh = shd.state_shardings(mesh, {"params": skeleton,
                                    "opt": opt.init(skeleton), "step": 0},
                             shd.lm_rules(mesh))
    state = train_loop.init_state(model, opt, sh)
    del model
    step = train_loop.make_train_step(tfm.make_vp_loss_fn(cut, mesh), opt)
    data = synthetic_batches(cut, batch, seq)
    state, _ = step(state, next(data))
    b1 = next(data)
    two = make_elastic_mesh(2, model_parallel=2, devices=used[:2])
    sh2 = shd.state_shardings(two, {"params": skeleton,
                                    "opt": opt.init(skeleton), "step": 0},
                              shd.lm_rules(two))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ckpt.save(d, 1, state)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = ckpt.restore(d, 1, state, shardings=sh)
            restore_s = time.perf_counter() - t0
            small = reshard_state(d, 1, state, sh2)
        back_equal = states_equal(back, state)
        small_equal = states_equal(small, state)
        direct = shd.place(state, sh2)
        step2 = train_loop.make_train_step(tfm.make_vp_loss_fn(cut, two), opt)
        c1, _ = step2(small, b1)
        c2, _ = step2(direct, b1)
        two_equal = states_equal(c1, c2)
        del c1, c2, small, direct
        cards_free(used)
        a1, _ = step(state, b1)
        a2, _ = step(back, b1)
        four_equal = states_equal(a1, a2)
    finally:
        torch.use_deterministic_algorithms(False)
    emit("train_cards_checkpoint", card=CARD, cards=n, model=cut.name,
         layers=cut_layers, state_gb=sum(placed_bytes(state, used).values())
         / 1e9, save_s=save_s, restore_s=restore_s,
         restored_bit_equal=back_equal,
         step_after_restore_bit_equal=four_equal,
         reshard_mesh=dict(two.shape), resharded_bit_equal=small_equal,
         step_after_reshard_equal=two_equal)
    check(back_equal and four_equal, "restore onto the cards differs")
    check(small_equal and two_equal, "reshard onto two cards differs")
    del state, back, a1, a2
    cards_free(used)
    after = kernel_launches()
    emit("train_cards", card=CARD, cards=n,
         seconds=time.perf_counter() - t_phase,
         kernels_launched={k: after[k] - before[k] for k in after},
         note="training over cards launches no kernel (plain PyTorch, as "
              "the reference's plain jnp)")
    check(after == before, f"train_cards launched kernels: {before} -> "
          f"{after}")
    return out


def synthetic_batches(cfg, batch, seq):
    from repro_torch.data.lm_pipeline import synthetic_lm_batches
    return synthetic_lm_batches(cfg.vocab_size, batch, seq, seed=SEED + 2)


def states_equal(a, b) -> bool:
    """Two states (placed or not) bit for bit, leaf for leaf."""
    from repro_torch.distributed.sharding import Placed
    fa, fb = flat(a), flat(b)
    if set(fa) != set(fb):
        return False
    for key, x in fa.items():
        y = fb[key]
        if isinstance(x, Placed) or isinstance(y, Placed):
            dev = (x if isinstance(x, Placed) else y).devices[0]
            x = x.assemble(dev) if isinstance(x, Placed) else x
            y = y.assemble(dev) if isinstance(y, Placed) else y
            if not torch.equal(x.to(y.device), y):
                return False
        elif x != y:
            return False
    return True


def cards_launch_cut(cfg, mesh, batch, seq, steps, cards):
    """(a) on two or three cards: the launcher's step over ``cfg`` (the
    cut) laid on ``mesh``, as `cards_launcher` reports it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import adamw, cosine_schedule
    opt = adamw(cosine_schedule(3e-4, 100, steps), weight_decay=0.1)
    skeleton = tfm.Transformer(cfg, device="meta")
    sh = shd.state_shardings(mesh, {"params": skeleton,
                                    "opt": opt.init(skeleton), "step": 0},
                             shd.lm_rules(mesh))
    cards_reset_peaks(cards)
    t0 = time.perf_counter()
    state = train_loop.init_state(tfm.init(cfg, generator=torch.Generator(
        device=cards[0]).manual_seed(0), device=cards[0]), opt, sh)
    step = train_loop.make_train_step(tfm.make_vp_loss_fn(cfg, mesh), opt)
    data = synthetic_batches(cfg, batch, seq)
    losses, dts = [], []
    for _ in range(steps):
        b = next(data)
        t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        cards_sync(cards)
        dts.append((time.perf_counter() - t1) * 1e3)
    return {"seconds": time.perf_counter() - t0, "losses": losses,
            "step_ms": dts, "step_ms_median": statistics.median(dts[1:]),
            "peak_gb": {str(c): torch.cuda.max_memory_allocated(c) / 1e9
                        for c in cards}}, state, {"step": step, "batch": b}


def oom_halving(fn, size, floor):
    """fn(size) at the largest power-of-two fraction of ``size`` (down to
    ``floor``) that fits the card: (result, size used, [{size, the
    allocator's message}] of the sizes that ran out of memory)."""
    cut = []
    while True:
        try:
            return fn(size), size, cut
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).split(". ")[0][:160]
        cut.append({"size": size, "error": msg})
        gc.collect()
        torch.cuda.empty_cache()
        if size // 2 < floor:
            raise AssertionError(f"out of memory down to {size}")
        size //= 2


def timed_steps(step, box, batch, n):
    """``n`` steps after one untimed on ``box["state"]`` (the box holds the
    only reference, so an old state's moments go as each step returns):
    (ms each, losses)."""
    box["state"], m = step(box["state"], batch)
    sync()
    ms, losses = [], [float(m["loss"])]
    for _ in range(n):
        t0 = time.perf_counter()
        box["state"], m = step(box["state"], batch)
        losses.append(float(m["loss"]))       # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, losses


def train_both_modes(step, box, batch, n):
    """``n`` timed steps under torch.use_deterministic_algorithms (as
    `phase_train`), then ``n`` in the default mode: ({mode: ms}, all
    losses, the deterministic mode's warnings)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det_ms, det_l = timed_steps(step, box, batch, n)
    finally:
        torch.use_deterministic_algorithms(False)
    def_ms, def_l = timed_steps(step, box, batch, n)
    nondet = sorted({str(w.message)[:80] for w in caught
                     if "deterministic" in str(w.message)})
    return {"deterministic": det_ms, "default": def_ms}, det_l + def_l, \
        nondet


def card_vs_cpu(dev, make, loss_fn, cfg, batch_np, lr):
    """One AdamW step on the CPU and on the card from the same numpy
    weights and batch: ((loss, grad norm) on the card, the same on the
    CPU)."""
    from repro_torch.training import tree as T
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import init_state, make_train_step
    out = []
    cpu_model = make(torch.Generator().manual_seed(SEED), "cpu")
    tree = T.tree_map(lambda t: t.detach().numpy().copy(), cpu_model)
    for model, d in ((cpu_model, "cpu"),
                     (type(cpu_model)(cfg, device=dev), dev)):
        if d != "cpu":
            from repro_torch.models.layers import fill_from_numpy
            fill_from_numpy(model, tree)
        opt = adamw(lr, weight_decay=0.0)
        step = make_train_step(lambda p, b: loss_fn(p, cfg, b), opt)
        _, m = step(init_state(model, opt),
                    {k: torch.from_numpy(v).to(d) for k, v in
                     batch_np.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def parity_ok(card, cpu):
    return abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0]) and \
        abs(card[1] - cpu[1]) <= 1e-4 * abs(cpu[1])


def recsys_batch(arch_id, cfg, B, gen, dev):
    """A synthetic batch of ``B`` rows drawn on ``dev`` (launch/steps.py's
    shapes: DLRM multi_hot ids, BERT4Rec M = seq_len // 10 masked
    positions)."""
    def ids(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    if arch_id == "dlrm-rm2":
        return {"dense": torch.randn((B, cfg.n_dense), generator=gen,
                                     device=dev),
                "sparse_ids": ids(cfg.vocab, B, cfg.n_sparse, cfg.multi_hot),
                "label": ids(2, B)}
    if arch_id == "fm":
        return {"sparse_ids": ids(cfg.vocab, B, cfg.n_sparse),
                "label": ids(2, B)}
    if arch_id == "mind":
        return {"hist_ids": ids(cfg.vocab, B, cfg.hist_len),
                "hist_mask": torch.ones((B, cfg.hist_len), dtype=torch.bool,
                                        device=dev),
                "label_id": ids(cfg.vocab, B)}
    S, M = cfg.seq_len, max(1, cfg.seq_len // 10)
    tokens = ids(cfg.vocab, B, S)
    pos = ids(S, B, M).long()
    targets = tokens.gather(1, pos)
    tokens.scatter_(1, pos, cfg.mask_id)
    return {"ids": tokens, "pad_mask": torch.ones((B, S), dtype=torch.bool,
                                                  device=dev),
            "mask_positions": pos.int(), "mask_targets": targets}


def phase_recsys(dev, *, train_batch=None, serve_batches=None,
                 n_candidates=None, steps=3, full=True):
    """The recsys family at each FULL config's published widths (dlrm-rm2
    26 x 1M x 64, bot 13-512-256-64, dot interaction; fm 39 x 1M x 10;
    mind 1M x 64, 4 interests, 3 routing iterations, history 50; bert4rec
    50k x 64, 2 blocks, seq 200), synthetic inputs from a seed (no
    dataset), the registry's RECSYS_SHAPES: ``steps`` AdamW steps
    (launch/steps.py's lr 1e-3, no weight decay) at train_batch 65,536 --
    under torch.use_deterministic_algorithms, then as many in the default
    mode -- ms a step and examples/s; serve_p99 (512) and serve_bulk
    (262,144) through launch/steps.py's serve functions under no_grad; and
    retrieval_cand (1 user x 1,000,000 candidates: DLRM / FM score the
    candidates as a batch, MIND / BERT4Rec encode the user once). A batch
    that does not fit the card halves to the largest power of two that
    does, and a bulk serve runs in chunks the same way; every cut is
    printed with the allocator's message (on one H100: MIND's (B, B)
    in-batch scores train at 32,768; BERT4Rec's (B, 20, 50,001) f32
    logits, 8.2 GB at 2,048 rows, and their gradients train at 2,048; its
    bulk serve runs in chunks of 32,768). Gates:
    at REDUCED, one AdamW step on the card within 1e-5 (loss) and 1e-4
    (grad norm) of the CPU's, f32, TF32 off; every loss and output
    finite. No kernel: plain PyTorch, as the reference's plain jnp."""
    from repro_torch.configs import get
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import init_state, make_train_step

    t_phase = time.perf_counter()
    before = kernel_launches()
    archs = ("dlrm-rm2", "fm", "mind", "bert4rec")
    fns = {"dlrm-rm2": ("dlrm", rec.dlrm_loss,
                        lambda p, c, b: rec.dlrm_forward(
                            p, c, b["dense"], b["sparse_ids"])),
           "fm": ("fm", rec.fm_loss,
                  lambda p, c, b: rec.fm_forward(p, c, b["sparse_ids"])),
           "mind": ("mind", rec.mind_loss,
                    lambda p, c, b: rec.mind_score(
                        p, c, b["hist_ids"], b["hist_mask"],
                        b["label_id"][:, None])[:, 0]),
           "bert4rec": ("bert4rec", rec.bert4rec_loss,
                        lambda p, c, b: rec.bert4rec_score(
                            p, c, b["ids"], b["pad_mask"],
                            b["mask_targets"][:, :1])[:, 0])}
    results = {}
    for arch_id in archs:
        arch = get(arch_id)
        shapes = arch.shapes
        cfg = arch.full if full else arch.reduced
        name, loss_fn, serve_fn = fns[arch_id]
        init = getattr(rec, f"{name}_init")
        out = {"config": dataclasses.asdict(cfg),
               "params": cfg.param_count()}

        # the card against the CPU at REDUCED
        red = arch.reduced
        np_batch = {k: v.cpu().numpy() for k, v in recsys_batch(
            arch_id, red, 64, torch.Generator().manual_seed(SEED),
            "cpu").items()}
        card, cpu = card_vs_cpu(dev, lambda g, d: init(g, red, device=d),
                                loss_fn, red, np_batch, 1e-3)
        out["reduced_card_vs_cpu"] = {"loss": [card[0], cpu[0]],
                                      "grad_norm": [card[1], cpu[1]]}
        check(parity_ok(card, cpu), f"{arch_id} REDUCED card {card} vs CPU "
              f"{cpu}")

        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        model = init(gen, cfg, device=dev)
        sync()
        out["init_s"] = time.perf_counter() - t0
        opt = adamw(1e-3, weight_decay=0.0)
        step = make_train_step(lambda p, b: loss_fn(p, cfg, b), opt)
        box = {"state": init_state(model, opt)}

        def train(B):
            torch.cuda.reset_peak_memory_stats()   # this batch size's peak
            return train_both_modes(step, box, recsys_batch(
                arch_id, cfg, B, gen, dev), steps)

        (ms, losses, nondet), B, cut = oom_halving(
            train, train_batch or shapes["train_batch"]["batch"], 64)
        med = {mode: statistics.median(v) for mode, v in ms.items()}
        out["train"] = {"batch": B, "cut_from": cut, "step_ms": ms,
                        "step_ms_median": med,
                        "examples_per_s": {m: B / (v / 1e3)
                                           for m, v in med.items()},
                        "losses": losses, "peak_mem_gb": peak_gb(),
                        "nondeterministic_ops_warned": nondet}
        check(all(np.isfinite(losses)), f"{arch_id} losses {losses}")
        del box
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        with torch.no_grad():
            for shape in ("serve_p99", "serve_bulk"):
                B = (serve_batches or {}).get(shape, shapes[shape]["batch"])
                batch = recsys_batch(arch_id, cfg, B, gen, dev)

                def serve(chunk):
                    def run():
                        return [serve_fn(model, cfg, {k: v[i:i + chunk]
                                                      for k, v in batch.items()})
                                for i in range(0, B, chunk)]
                    got = torch.cat(run())
                    return got, events_ms(run, 3 if B > 4096 else 20)
                (got, t_ms), chunk, cut = oom_halving(serve, B, 512)
                out[shape] = {"batch": B, "chunk": chunk, "cut_from": cut,
                              "ms": t_ms, "examples_per_s": B / (t_ms / 1e3),
                              "finite": bool(torch.isfinite(got).all())}
                check(got.shape == (B,) and out[shape]["finite"],
                      f"{arch_id} {shape} output")
                del batch, got
            C = n_candidates or shapes["retrieval_cand"]["n_candidates"]
            if arch_id in ("mind", "bert4rec"):
                user = recsys_batch(arch_id, cfg, 1, gen, dev)
                cand = torch.randint(0, cfg.vocab, (1, C), generator=gen,
                                     device=dev, dtype=torch.int32)
                if arch_id == "mind":
                    def retrieve():
                        return rec.mind_score(model, cfg, user["hist_ids"],
                                              user["hist_mask"], cand)
                else:
                    def retrieve():
                        return rec.bert4rec_score(model, cfg, user["ids"],
                                                  user["pad_mask"], cand)
                how = "user encoded once, dot against the candidates"
            else:
                cands = recsys_batch(arch_id, cfg, C, gen, dev)

                def retrieve():
                    return serve_fn(model, cfg, cands)
                how = "candidate-major pair scoring as one batch"
            got = retrieve()
            out["retrieval_cand"] = {
                "candidates": C, "how": how, "ms": events_ms(retrieve, 3),
                "finite": bool(torch.isfinite(got).all())}
            check(got.numel() == C and out["retrieval_cand"]["finite"],
                  f"{arch_id} retrieval output")
        out["serve_peak_mem_gb"] = peak_gb()   # a bulk cut's attempts included
        results[arch_id] = out
        emit("recsys_" + arch_id.split("-")[0], card=CARD, arch=arch_id,
             **out)
        del model, step, got
        gc.collect()
        torch.cuda.empty_cache()
    after = kernel_launches()
    emit("recsys", card=CARD, seconds=time.perf_counter() - t_phase,
         archs=list(archs),
         kernels_launched={k: after[k] - before[k] for k in after})
    check(after == before, f"recsys launched kernels: {before} -> {after}")
    return results


def gnn_graph(cfg, N, E, gen, dev):
    """A synthetic full graph on ``dev``: uniform random edges, N(0, 1)
    features, uniform labels, every node labelled."""
    def ids(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return {"feats": torch.randn((N, cfg.d_feat), generator=gen, device=dev),
            "src": ids(N, E), "dst": ids(N, E),
            "edge_mask": torch.ones(E, dtype=torch.bool, device=dev),
            "labels": ids(cfg.n_classes, N),
            "label_mask": torch.ones(N, device=dev)}


def gnn_molecules(cfg, B, Nn, Ne, gen, dev):
    def ids(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return {"feats": torch.randn((B, Nn, cfg.d_feat), generator=gen,
                                 device=dev),
            "src": ids(Nn, B, Ne), "dst": ids(Nn, B, Ne),
            "edge_mask": torch.ones((B, Ne), dtype=torch.bool, device=dev),
            "node_mask": torch.ones((B, Nn), dtype=torch.bool, device=dev),
            "labels": ids(cfg.n_classes, B)}


def gnn_sampled(cfg, n_nodes, n_edges, batch_nodes, fanouts, seed, gen, dev):
    """Reddit-scale sampled training's batch: a uniform random graph of
    (n_nodes, n_edges) drawn on the host, `NeighborSampler` (host numpy)
    over it, the sampled padded subgraph's features gathered on ``dev``
    from an N(0, 1) table, the loss on the seeds. Returns (batch, host
    seconds of the graph, the sampler's CSR build and its sample)."""
    from repro_torch.models.gnn import NeighborSampler
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    t1 = time.perf_counter()
    sampler = NeighborSampler(n_nodes, src, dst, seed=seed)
    del src, dst
    t2 = time.perf_counter()
    sub = sampler.sample(rng.integers(0, n_nodes, batch_nodes), fanouts)
    t3 = time.perf_counter()
    del sampler
    table = torch.randn((n_nodes, cfg.d_feat), generator=gen, device=dev)
    nodes = torch.from_numpy(sub["nodes"]).to(dev)
    feats = torch.where((nodes >= 0)[:, None],
                        table[torch.clamp_min(nodes, 0)], 0.0)
    del table
    n_sub = sub["n_sub"]
    label_mask = torch.zeros(n_sub, device=dev)
    label_mask[:batch_nodes] = 1.0
    batch = {"feats": feats, "src": torch.from_numpy(sub["src"]).to(dev),
             "dst": torch.from_numpy(sub["dst"]).to(dev),
             "edge_mask": torch.from_numpy(sub["edge_mask"]).to(dev),
             "labels": torch.randint(0, cfg.n_classes, (n_sub,),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "label_mask": label_mask}
    return batch, {"graph_s": t1 - t0, "sampler_csr_s": t2 - t1,
                   "sample_s": t3 - t2, "subgraph_nodes": n_sub,
                   "subgraph_edges": int(sub["src"].shape[0]),
                   "real_edges": int(sub["edge_mask"].sum())}


def phase_gnn(dev, shapes=None, *, steps=5):
    """gcn-cora FULL (2 layers, d_hidden 16, sym norm) with each shape's
    d_feat / n_classes (the registry's GNN_SHAPES, from SHAPE_DIMS) on
    synthetic graphs drawn from a seed: full_graph_sm (2,708 nodes /
    10,556 edges), ogb_products (2,449,029 / 61,859,140, d_feat 100),
    molecule (128 graphs x 30 nodes / 64 edges) and minibatch_lg (a
    Reddit-sized uniform graph of 232,965 nodes / 114,615,892 edges on
    the host, `NeighborSampler` fanouts (15, 10) over 1,024 seeds, the
    host sampler's seconds beside the device step). Each: ``steps`` AdamW
    steps (launch/steps.py's lr 1e-2, no weight decay) under
    torch.use_deterministic_algorithms and as many in the default mode, ms
    a step, peak memory. Gates: at REDUCED, one step of the full, sampled
    and batched forms on the card within 1e-5 (loss) / 1e-4 (grad norm)
    of the CPU's; every loss finite. No kernel: plain PyTorch (the
    scatter is index_add_)."""
    from repro_torch.configs import get
    from repro_torch.models import gnn
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import init_state, make_train_step

    t_phase = time.perf_counter()
    before = kernel_launches()
    arch = get("gcn-cora")
    shapes = shapes or arch.shapes

    # the card against the CPU at REDUCED
    red = arch.reduced
    rng = np.random.default_rng(SEED)
    cpu_gen = torch.Generator().manual_seed(SEED)
    graph = {k: v.numpy() for k, v in gnn_graph(red, 200, 800, cpu_gen,
                                                 "cpu").items()}
    red_m = dataclasses.replace(red, d_feat=8, n_classes=2)
    mols = {k: v.numpy() for k, v in gnn_molecules(red_m, 16, 10, 24, cpu_gen,
                                                   "cpu").items()}
    samp, _ = gnn_sampled(red, 300, 3000, 16, (4, 3), SEED, cpu_gen, "cpu")
    samp = {k: v.numpy() for k, v in samp.items()}
    parity = {}
    for form, c, loss_fn, b in (("full", red, gnn.gcn_loss, graph),
                                ("sampled", red, gnn.gcn_loss, samp),
                                ("batched", red_m, gnn.gcn_loss_batched, mols)):
        card, cpu = card_vs_cpu(dev, lambda g, d, c=c: gnn.gcn_init(
            g, c, device=d), loss_fn, c, b, 1e-2)
        parity[form] = {"loss": [card[0], cpu[0]],
                        "grad_norm": [card[1], cpu[1]]}
        check(parity_ok(card, cpu), f"gcn {form} REDUCED card {card} vs CPU "
              f"{cpu}")
    emit("gnn_card_vs_cpu", card=CARD, reduced=parity)
    del rng

    results = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name in ("full_graph_sm", "ogb_products", "molecule", "minibatch_lg"):
        if name not in shapes:
            continue
        shape = shapes[name]
        cfg = dataclasses.replace(arch.full, d_feat=shape["d_feat"],
                                  n_classes=shape["n_classes"])
        out = {"shape": {k: v for k, v in shape.items()}}
        torch.cuda.reset_peak_memory_stats()
        if shape["kind"] == "gnn_batched":
            batch = gnn_molecules(cfg, shape["batch"], shape["n_nodes"],
                                  shape["n_edges"], gen, dev)
            loss_fn = gnn.gcn_loss_batched
        elif shape["kind"] == "gnn_sampled":
            batch, host = gnn_sampled(cfg, shape["n_nodes"], shape["n_edges"],
                                      shape["batch_nodes"],
                                      tuple(shape["fanouts"]), SEED, gen, dev)
            out["host"] = host
            loss_fn = gnn.gcn_loss
        else:
            batch = gnn_graph(cfg, shape["n_nodes"], shape["n_edges"], gen,
                              dev)
            loss_fn = gnn.gcn_loss
        model = gnn.gcn_init(gen, cfg, device=dev)
        opt = adamw(1e-2, weight_decay=0.0)
        step = make_train_step(lambda p, b, f=loss_fn, c=cfg: f(p, c, b), opt)
        ms, losses, nondet = train_both_modes(
            step, {"state": init_state(model, opt)}, batch, steps)
        out.update(step_ms=ms,
                   step_ms_median={m: statistics.median(v)
                                   for m, v in ms.items()},
                   losses=losses, peak_mem_gb=peak_gb(),
                   nondeterministic_ops_warned=nondet,
                   params=cfg.param_count())
        check(all(np.isfinite(losses)), f"gcn {name} losses {losses}")
        results[name] = out
        emit("gnn_" + name, card=CARD, **out)
        del batch, model, step
        gc.collect()
        torch.cuda.empty_cache()
    after = kernel_launches()
    emit("gnn", card=CARD, seconds=time.perf_counter() - t_phase,
         shapes=list(results),
         kernels_launched={k: after[k] - before[k] for k in after})
    check(after == before, f"gnn launched kernels: {before} -> {after}")
    return results


# ---------------------------------------------------------------------------
# phase 20: the launch tools
# ---------------------------------------------------------------------------

#: timed steps a card cell (after one warm-up step)
LAUNCH_STEPS = 5
#: bytes the card count may differ from the meta count by (relative)
LAUNCH_BYTES_REL = 0.01
#: the highest roofline fraction a measured step may reach: above it the
#: count (or the ideal) is wrong
LAUNCH_FRAC_MAX = 1.05


def reckon_one_card(out_path):
    """Every cell reckoned on the (1, 1) mesh of meta devices: its global
    count (`launch._cost`), args bytes and collectives, written to
    ``out_path`` as JSON (run in a child process by `start_launch`)."""
    sys.path.insert(0, SRC)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    traces, out = {}, {}
    for arch_id, shape in dryrun.all_cells():
        t0 = time.perf_counter()
        cell = build_cell(arch_id, shape, mesh)
        m = dryrun.measure(cell, mesh, traces)
        c = m["cost"]
        out[f"{arch_id}|{shape}"] = {
            "flops": c.flops, "bytes": c.bytes,
            "transcendentals": c.transcendentals, "temp_bytes": c.peak_bytes,
            "args_bytes": m["args_bytes"], "coll": sum(m["coll"].values()),
            "model_flops": cell.model_flops, "model_bytes": cell.model_bytes,
            "launches": c.launches, "by_op": c.by_op,
            "seconds": time.perf_counter() - t0}
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_launch():
    """Start the launch phase's two CPU children (meta device only): the
    dry run's entry point over both production meshes, and the one-card
    reckoning. Returns {name: (process, output path, log, start time)}."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    cmds = {"dryrun": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--mesh", "both", "--force", "--out",
                       os.path.join(tmp, "dryrun.json")],
            "one_card": [sys.executable, "-c",
                         "import chip_smoke; chip_smoke.reckon_one_card("
                         f"{os.path.join(tmp, 'one_card.json')!r})"]}
    kids = {"tmp": tmp}
    for name, cmd in cmds.items():
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        kids[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT),
                      os.path.join(tmp, f"{name}.json"), log, time.time())
    return kids


def stop_launch(kids):
    """Kill whatever child is still running and drop its files."""
    import shutil
    for name, kid in kids.items():
        if name == "tmp":
            continue
        proc, _, log, _ = kid
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
    shutil.rmtree(kids["tmp"], ignore_errors=True)


def launch_wait(kids, name, timeout=900):
    """A child's JSON result and its wall seconds (start to its result's
    last write); fails the phase when it failed."""
    proc, path, log, t0 = kids[name]
    rc = proc.wait(timeout=timeout)
    log.flush()
    with open(log.name) as f:
        text = f.read()
    check(rc == 0, f"launch child {name} exited {rc}: {text[-2000:]}")
    with open(path) as f:
        return json.load(f), os.path.getmtime(path) - t0, text


def roofline_entry(e):
    """A dry-run entry in `roofline.analyze`'s terms."""
    return {"flops": e["hlo_flops"], "bytes": e["hlo_bytes"],
            "coll": float(sum(e["collective_bytes"].values())),
            "model_flops": e["model_flops"],
            "model_bytes": e.get("model_bytes", 0.0),
            "temp_bytes": e["mem_temp_bytes"],
            "args_bytes": e["mem_args_bytes"]}


def launch_decode_checks(dev, cell, key):
    """On a long_500k cell: one decode step launches the kernel n_layers
    times; one layer's kernel output against its plain version at the
    cell's S (q drawn, every row live); the split plan at that S."""
    model, cache = cell.args[0], cell.args[1]
    cfg = model.cfg
    S, KV, hd = cache["k"].shape[2], cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KV
    sync()
    before, tc_before = dec_mod.LAUNCHES, dec_mod.TC_LAUNCHES
    cell.fn(*cell.args)
    sync()
    per_step = dec_mod.LAUNCHES - before
    tc_step = dec_mod.TC_LAUNCHES - tc_before
    tc_want = dec_mod.uses_tc(cache["k"].dtype, hd)
    check(per_step == cfg.n_layers and tc_step == per_step * tc_want,
          f"{key}: {per_step} decode launches a step ({tc_step} of the "
          f"tensor-core body), {cfg.n_layers} layers")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((1, KV, G, hd), generator=gen, device=dev).to(
        cache["k"].dtype)
    lengths = torch.full((1,), S, dtype=torch.int32, device=dev)
    kc, vc = cache["k"][0], cache["v"][0]
    n0, tc0 = dec_mod.LAUNCHES, dec_mod.TC_LAUNCHES
    err = decode_check(q, kc, vc, lengths)
    # one layer's kernel at this S beside its bound, its plain version and
    # SDPA over the same rows (comparison launches: not the path's)
    k_ms = events_ms(lambda: dec_mod.decode_attention_cuda(q, kc, vc,
                                                           lengths), 10)
    dec_mod.LAUNCHES, dec_mod.TC_LAUNCHES = n0, tc0
    plain_ms = events_ms(lambda: dec_mod.decode_attention_plain(
        q, kc, vc, lengths), 2)
    ql = q.reshape(1, KV * G, 1, hd)
    kl, vl = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = events_ms(lambda: sdpa(ql, kl, vl, enable_gqa=True), 10)
    del kl, vl
    nbytes = 2 * S * KV * hd * kc.element_size() \
        + q.numel() * q.element_size() + KV * G * (hd + 2) * 4
    flops = 4 * hd * KV * G * S
    ops_s = decode_ops_s(kc.dtype, hd, flops)
    bound_ms = max(nbytes / HBM_BPS, ops_s) * 1e3
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tc = dec_mod.uses_tc(kc.dtype, hd)
    split = (dec_mod.tc_plan(1, KV, G, S, n_sm, hd)[0] if tc else
             dec_mod.split_for(1, KV, G, S, n_sm, hd, kc.element_size()))
    chunks = -(-S // split)
    check(chunks * split >= S and S * KV * hd < 2**31,
          f"{key}: split {split} x {chunks} chunks or offsets past int32")
    return {"launches_a_step": per_step, "layer0_err": err, "split": split,
            "chunks": chunks, "layer_elems": S * KV * hd,
            "kernel_ms": k_ms, "plain_ms": plain_ms, "sdpa_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"
            if nbytes / HBM_BPS >= ops_s else "operations",
            "body": "tc" if tc else "simt", "tc_launches_a_step": tc_step,
            "mbytes": nbytes / 1e6,
            **({"tc_products": tc_products(hd, G, flops)} if tc else {})}


def launch_card_cell(dev, mesh, key, rk):
    """One fitting cell at full width on the card (see phase 20 (c))."""
    from repro_torch.launch import _cost, roofline
    from repro_torch.launch.steps import build_cell
    arch_id, shape = key.split("|")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cell = build_cell(arch_id, shape, mesh, device=dev, generator=gen)
    sync()
    build_s = time.perf_counter() - t0
    out = {"cell": key, "build_s": build_s}
    if shape == "long_500k":
        out["decode"] = launch_decode_checks(dev, cell, key)
    fn, args = cell.fn, list(cell.args)
    train = isinstance(args[0], dict) and "params" in args[0]
    del cell

    def step():
        res = fn(*args)
        if train:
            args[0] = res[0]       # the only reference to the state
        return res

    out["ms"] = events_ms(step, LAUNCH_STEPS)
    if shape == "long_500k":
        # where a step's time goes: the device's busy time and idle share
        prof = profile_batch(step, tags=DECODE_KERNELS)
        out["profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "idle_share", "trace_lost")} | {
            "kernels": prof["kernels"][:4]}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cost, res = _cost.count(fn, *args)
    if train:
        args[0] = res[0]
    del res
    sync()
    peak = torch.cuda.max_memory_allocated()
    out.update(flops=cost.flops, meta_flops=rk["flops"], bytes=cost.bytes,
               meta_bytes=rk["bytes"], launches=cost.launches,
               peak_gb=peak / 1e9, allocated_before_gb=base / 1e9,
               reckoned_gb=(rk["args_bytes"] + rk["temp_bytes"]) / 1e9)
    diff = {op: [list(cost.by_op.get(op, (0, 0))),
                 list(rk["by_op"].get(op, (0, 0)))]
            for op in set(cost.by_op) | set(rk["by_op"])
            if tuple(cost.by_op.get(op, (0, 0)))
            != tuple(rk["by_op"].get(op, (0, 0)))}
    out["ops_differing"] = diff
    rel = abs(cost.bytes - rk["bytes"]) / max(rk["bytes"], 1)
    check(cost.flops == rk["flops"] and rel <= LAUNCH_BYTES_REL,
          f"{key}: card count {cost.flops} flops / {cost.bytes} bytes, meta "
          f"{rk['flops']} / {rk['bytes']} (ops differing: {diff})")
    entry = {"flops": rk["flops"], "bytes": rk["bytes"], "coll": rk["coll"],
             "model_flops": rk["model_flops"],
             "model_bytes": rk["model_bytes"], "temp_bytes": rk["temp_bytes"],
             "args_bytes": rk["args_bytes"]}
    a = roofline.analyze(entry, 1)
    ideal_s = max(rk["model_flops"] / roofline.PEAK_FLOPS,
                  rk["model_bytes"] / roofline.HBM_BW)
    frac = ideal_s * 1e3 / out["ms"]
    out.update(terms_ms={k: v * 1e3 for k, v in a["terms_s"].items()},
               bound_ms=max(a["terms_s"].values()) * 1e3,
               dominant=a["dominant"], ideal_ms=ideal_s * 1e3,
               roofline_fraction=frac, bytes_rel_gap=rel)
    check(frac <= LAUNCH_FRAC_MAX,
          f"{key}: roofline fraction {frac} > {LAUNCH_FRAC_MAX}")
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_launch(dev, kids):
    from repro_torch.launch import hillclimb, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    # (a) the dry run, both production meshes of meta devices
    dry, dry_wall, dry_log = launch_wait(kids, "dryrun")
    bad = {k: e.get("error") for k, e in dry.items() if not e.get("ok")}
    check(len(dry) == 84 and not bad,
          f"dry run: {len(dry) - len(bad)} of {len(dry)} ok, failed {bad}")
    most = sorted(dry, key=lambda k: -(dry[k]["mem_args_bytes"]
                                       + dry[k]["mem_temp_bytes"]))[:3]
    # (b) the H100 roofline of every entry
    lines, dominant, fits = [], Counter(), Counter()
    for key in sorted(dry):
        n_chips = 512 if key.endswith("pod512_2x16x16") else 256
        a = roofline.analyze(roofline_entry(dry[key]), n_chips)
        lines.append(roofline.line(key, a))
        dominant[(key.rsplit("|", 1)[1], a["dominant"])] += 1
        fits[(key.rsplit("|", 1)[1], a["fits_hbm"])] += 1
    for ln in lines:
        print(ln, flush=True)
    # (c) every cell that fits one card, at full width
    one, one_wall, _ = launch_wait(kids, "one_card")
    mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
    saved_moe = dict(moe._MOE_MESH)
    runs, excluded = [], {}
    dec_mod.LAUNCHES = dec_mod.TC_LAUNCHES = 0
    fa_mod.LAUNCHES = 0
    try:
        for key in sorted(one):
            rk = one[key]
            need = rk["args_bytes"] + rk["temp_bytes"]
            if need > roofline.HBM_PER_CHIP:
                excluded[key] = need / 1e9
                continue
            runs.append(launch_card_cell(dev, mesh, key, rk))
            print(json.dumps({"launch_cell": runs[-1]}), flush=True)
    finally:
        moe._MOE_MESH.clear()
        moe._MOE_MESH.update(saved_moe)
    dec_launches, fa_launches = dec_mod.LAUNCHES, fa_mod.LAUNCHES
    dec_tc_launches = dec_mod.TC_LAUNCHES
    long_runs = [r for r in runs if r["cell"].endswith("long_500k")]
    check({r["cell"] for r in long_runs} == {
        "qwen1.5-0.5b|long_500k", "yi-6b|long_500k",
        "granite-moe-1b-a400m|long_500k"}
        and "qwen3-4b|long_500k" in excluded,
        f"long_500k cells run {[r['cell'] for r in long_runs]}, excluded "
        f"{sorted(excluded)}")
    check(dec_launches > 0, "no decode launch in the launch phase")
    # (d) one hill-climb entry into a temporary file
    hc_path = os.path.join(kids["tmp"], "perf_iterations.json")
    try:
        hillclimb.main(["--cell", "qwen1.5-0.5b|long_500k", "--tag",
                        "chip_smoke", "--out", hc_path])
    finally:
        moe._MOE_MESH.clear()
        moe._MOE_MESH.update(saved_moe)
    with open(hc_path) as f:
        hc = json.load(f)
    want = {"analysis", "args_bytes", "bytes", "cell", "coll",
            "coll_by_kind", "corrected", "env", "flops", "mesh",
            "model_bytes", "model_flops", "note", "raw_flops", "tag",
            "temp_bytes"}
    check(len(hc) == 1 and set(hc[0]) == want and hc[0]["corrected"],
          f"hillclimb entry keys {sorted(hc[0]) if hc else None}")
    emit("launch", card=CARD, seconds=time.perf_counter() - t_phase,
         dryrun={"entries": len(dry), "ok": len(dry) - len(bad),
                 "failures": bad, "child_wall_s": dry_wall,
                 "trace_s": sum(e.get("lower_s", 0.0) for e in dry.values()),
                 "most_args_plus_temp_gb": {
                     k: (dry[k]["mem_args_bytes"] + dry[k]["mem_temp_bytes"])
                     / 1e9 for k in most},
                 "log_tail": dry_log[-300:]},
         roofline={"dominant": {f"{m}:{d}": n for (m, d), n in
                                sorted(dominant.items())},
                   "fits_hbm": {f"{m}:{f}": n for (m, f), n in
                                sorted(fits.items())}},
         one_card={"child_wall_s": one_wall, "runs": len(runs),
                   "excluded_gb": excluded},
         card_runs={r["cell"]: {k: r[k] for k in (
             "ms", "bound_ms", "ideal_ms", "roofline_fraction", "peak_gb",
             "reckoned_gb")} for r in runs},
         decode_launches=dec_launches,
         decode_launches_by_body={"simt": dec_launches - dec_tc_launches,
                                  "tc": dec_tc_launches},
         long_500k_decode={r["cell"]: r["decode"] for r in long_runs},
         flash_launches=fa_launches,
         hillclimb={k: hc[0][k] for k in ("cell", "tag", "mesh", "flops",
                                          "bytes", "coll")}
         | {"analysis": {k: hc[0]["analysis"][k] for k in
                         ("terms_s", "dominant", "roofline_fraction")}},
         peak_mem_gb=peak_gb())
    return {"decode_launches": dec_launches, "flash_launches": fa_launches,
            "decode_tc_launches": dec_tc_launches,
            "decode_err": max((r["decode"]["layer0_err"] for r in long_runs
                               if r["decode"]["body"] == "simt"),
                              default=0.0),
            "decode_tc_err": max((r["decode"]["layer0_err"]
                                  for r in long_runs
                                  if r["decode"]["body"] == "tc"),
                                 default=0.0)}


def setup():
    """Import the port and set this module's globals; None (after saying
    why on stderr) when there is no card or no package."""
    global np, torch, kernel_mod, hyb_mod, ivf_mod, attn_lib, fa_mod, \
        dec_mod, fa_ref, DEV
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return None
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return None
    sys.path.insert(0, SRC)
    from repro_torch.kernels.arena_scan import kernel as kernel_mod
    from repro_torch.kernels.hybrid_score import hybrid_score as hyb_mod
    from repro_torch.kernels.ivf_probe import ivf_probe as ivf_mod
    from repro_torch.kernels import _attention as attn_lib
    from repro_torch.kernels.decode_attention import \
        decode_attention as dec_mod
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_ref as fa_ref
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    DEV = torch.device("cuda")
    return DEV


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="On-card smoke test of the PyTorch / CUDA port: every "
                    "phase, then the kernels line and the result line.")
    p.add_argument("--phases", default=None,
                   help="comma-separated phases to run alone after the "
                        f"build, in order, of: {', '.join(ALONE)}")
    args = p.parse_args(argv)
    names = args.phases.split(",") if args.phases else None
    if names and not set(names) <= set(ALONE):
        p.error(f"--phases takes {', '.join(ALONE)}")
    # phase_train runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's workspace fixed before the first cuBLAS call (this is
    # PyTorch's default size on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the prod phases swap 24 GiB arenas out of place: with fixed segments a
    # 24 GiB request failed beside 24 GiB of reserved-but-unallocated
    # blocks (sharded_prod's ingest after tiered_prod); growable segments
    # unmap freed pages instead
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = setup()
    if dev is None:
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    global CARD
    CARD = smi[0]
    if names:
        return run_alone(dev, names)
    # the launch phase's dry runs need only the host: they start now and
    # run beside the card's phases
    kids = start_launch()
    try:
        return run_phases(dev, kids)
    finally:
        stop_launch(kids)


def build_all():
    """Phase 0: both libraries at once (one nvcc per source, all six
    started together), ptxas's report, the scan's geometry; returns the
    dense scan's ptxas rows."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(kernel_mod.build), pool.submit(attn_lib.build)]:
            fut.result()
    ptxas = [ln.strip() for ln in (kernel_mod.BUILD_LOG
                                   + attn_lib.BUILD_LOG).splitlines()
             if "registers" in ln or "Compiling" in ln or "spill" in ln]
    build_s = time.perf_counter() - t0
    all_scan_ptxas = scan_ptxas(kernel_mod.BUILD_LOG)
    emit("build", seconds=build_s, ptxas=ptxas, scan_ptxas=all_scan_ptxas,
         geometry_shapes=check_geometry(),
         geometry="host mirror == C launcher")
    return [r for r in all_scan_ptxas if r["mode"] == "dense"]


#: the phases that run alone (``--phases``): each needs only the build and
#: the card(s), not another phase's state
ALONE = {
    "kernel": lambda dev: phase_kernel(),
    "hybrid_kernel": lambda dev: phase_hybrid_kernel(),
    "ivf_kernel": lambda dev: phase_ivf_kernel(),
    "paged_kernel": lambda dev: phase_paged_kernel(),
    "attn_kernel": lambda dev: phase_attn_kernel(),
    "bench": phase_bench, "hybrid_bench": phase_hybrid_bench,
    "ivf_bench": phase_ivf_bench, "tiered_prod": phase_tiered_prod,
    "sharded_prod": phase_sharded_prod, "regions": phase_regions,
    "lm_serve": phase_lm_serve, "moe_serve": phase_moe_serve,
    "reduced_serve": phase_reduced_serve, "wide_serve": phase_wide_serve,
    "deep_serve": phase_deep_serve, "train": phase_train,
    "train_mesh": phase_train_mesh, "train_cards": phase_train_cards,
    "recsys": phase_recsys, "gnn": phase_gnn,
}


def run_alone(dev, names) -> int:
    """The build, then the named phases in order, each with its gates; no
    ``kernels`` line and no last line (those need every phase)."""
    build_all()
    for name in names:
        ALONE[name](dev)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def run_phases(dev, kids) -> int:
    dense_ptxas = build_all()

    err1 = phase_kernel()
    herr1 = phase_hybrid_kernel()
    ierr1 = phase_ivf_kernel()
    perr1 = phase_paged_kernel()
    ferr1, derr1, tcerr1 = phase_attn_kernel()
    _, err2 = phase_bench(dev)
    herr2 = phase_hybrid_bench(dev)
    ierr2 = phase_ivf_bench(dev)
    prod = phase_prod(dev, ptxas=dense_ptxas)
    hprod = phase_hybrid_prod(dev, prod)
    iprod = phase_ivf_prod(dev, prod)
    pprod = phase_paged_prod(dev, prod, hprod, ptxas=dense_ptxas)
    # keep the kernel rows and the db, and drop every other tensor the
    # phases hold (the serving writes commit out of place: an old arena
    # kept alive here would hold a third copy on the card)
    db, now_ts = prod["db"], prod["now_ts"]
    row_keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "compact")
    prod, hprod, iprod, pprod = ({key: d[key] for key in row_keys if key in d}
                                 for d in (prod, hprod, iprod, pprod))
    gc.collect()
    phase_serve_prod(dev, db, now_ts)
    # free the 2^23-row arena before the next phases take the card
    del db
    gc.collect()
    torch.cuda.empty_cache()
    phase_tiered_prod(dev)
    gc.collect()
    torch.cuda.empty_cache()
    sprod = phase_sharded_prod(dev)
    gc.collect()
    torch.cuda.empty_cache()
    regions = phase_regions(dev)
    lm = phase_lm_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    red = phase_reduced_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    wide = phase_wide_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    deep = phase_deep_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_mesh(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cards(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_recsys(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_gnn(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launch = phase_launch(dev, kids)

    def nonzero(paths):
        """The paths that launched a kernel (the decode kernel's two
        bodies split each phase's launches)."""
        return {key: n for key, n in paths.items() if n}

    def on_regions(key):
        """The regions path of a kernel's row, where the phase ran."""
        return {"regions": regions[key]} if regions.get(key) else {}

    rows = [{
        "name": "arena_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan.cuh",
        "replaces": "src/repro/kernels/arena_scan/kernel.py:171",
        "launches": prod["launches"],
        "paths": {"prod": prod["launches"],
                  "sharded_prod": sprod["launches"],
                  "reduced_serve": red["arena_scan"],
                  **on_regions("launches")},
        "max_abs_err": max(err1, err2, prod["max_abs_err"],
                           sprod["max_abs_err"],
                           regions.get("max_abs_err", 0.0)),
        "ms": prod["ms"], "plain_ms": prod["plain_ms"],
        "bound_ms": prod["bound_ms"], "bound_by": prod["bound_by"],
        "library_ms": None}, {
        "name": "hybrid_score", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan.cuh",
        "replaces": "src/repro/kernels/hybrid_score/hybrid_score.py:55",
        "launches": hprod["launches"],
        "paths": {"hybrid_prod": hprod["launches"], **on_regions("hybrid")},
        "max_abs_err": max(herr1, herr2, hprod["max_abs_err"],
                           regions.get("hybrid_err", 0.0)),
        "ms": hprod["ms"], "plain_ms": hprod["plain_ms"],
        "bound_ms": hprod["bound_ms"], "bound_by": hprod["bound_by"],
        "library_ms": None}, {
        "name": "ivf_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan.cuh",
        "replaces": "src/repro/kernels/ivf_probe/ivf_probe.py:32",
        "launches": iprod["launches"],
        "paths": {"ivf_prod": iprod["launches"], **on_regions("ivf")},
        "max_abs_err": max(ierr1, ierr2, iprod["max_abs_err"],
                           regions.get("ivf_err", 0.0)),
        "ms": iprod["ms"], "plain_ms": iprod["plain_ms"],
        "bound_ms": iprod["bound_ms"], "bound_by": iprod["bound_by"],
        "library_ms": None}, {
        "name": "ivf_compact", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan_probe.cu",
        "replaces": "src/repro/kernels/ivf_probe/ops.py:34",
        "launches": iprod["compact"]["launches"],
        "paths": {"ivf_prod": iprod["compact"]["launches"],
                  **on_regions("compact")},
        "max_abs_err": 0.0,
        "ms": iprod["compact"]["ms"],
        "plain_ms": iprod["compact"]["plain_ms"],
        "bound_ms": iprod["compact"]["bound_ms"],
        "bound_by": iprod["compact"]["bound_by"],
        "library_ms": None}, {
        "name": "arena_scan_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/arena_scan.cuh",
        "replaces": "src/repro/kernels/arena_scan/kernel.py:121",
        "launches": pprod["launches"],
        "paths": {"paged_prod": pprod["launches"], **on_regions("paged")},
        "max_abs_err": max(perr1, pprod["max_abs_err"]),
        "ms": pprod["ms"], "plain_ms": pprod["plain_ms"],
        "bound_ms": pprod["bound_ms"], "bound_by": pprod["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:79",
        "launches": lm["flash"]["launches"],
        "paths": {"lm_serve": lm["flash"]["launches"],
                  "moe_serve": moe["flash"]["launches"],
                  "reduced_serve": red["flash"],
                  "wide_serve": wide["flash"],
                  "deep_serve": deep["flash"]},
        "max_abs_err": max(ferr1, lm["flash"]["max_abs_err"],
                           moe["flash"]["max_abs_err"], red["flash_err"],
                           wide["flash_err"], deep["flash_err"]),
        "ms": lm["flash"]["ms"], "plain_ms": lm["flash"]["plain_ms"],
        "bound_ms": lm["flash"]["bound_ms"],
        "bound_by": lm["flash"]["bound_by"],
        "library_ms": lm["flash"]["library_ms"]}, {
        # the SIMT body: f32 (the REDUCED configs, the f32 model checks)
        # and rows past 256 (deep_serve, whose decode it times)
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:77",
        "launches": deep["decode"],
        "paths": nonzero({"lm_serve": lm["decode"]["launches"]
                          - lm["decode"]["tc_launches"],
                          "moe_serve": moe["decode"]["launches"]
                          - moe["decode"]["tc_launches"],
                          "reduced_serve": red["decode"],
                          "wide_serve": wide["decode"] - wide["decode_tc"],
                          "deep_serve": deep["decode"],
                          "sharded_prod": sprod["decode_launches"]
                          - sprod["decode_tc_launches"],
                          "launch": launch["decode_launches"]
                          - launch["decode_tc_launches"],
                          **on_regions("decode_simt")}),
        "max_abs_err": max(derr1, red["decode_err"], deep["decode_err"],
                           launch["decode_err"]),
        "ms": deep["decode_row"]["ms"],
        "plain_ms": deep["decode_row"]["plain_ms"],
        "bound_ms": deep["decode_row"]["bound_ms"],
        "bound_by": deep["decode_row"]["bound_by"],
        "library_ms": deep["decode_row"]["library_ms"]}, {
        # the tensor-core body: bf16 rows up to 256 (lm_serve's decode,
        # which it times)
        "name": "decode_attention_tc", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:77",
        "launches": lm["decode"]["tc_launches"],
        "paths": nonzero({"lm_serve": lm["decode"]["tc_launches"],
                          "moe_serve": moe["decode"]["tc_launches"],
                          "wide_serve": wide["decode_tc"],
                          "sharded_prod": sprod["decode_tc_launches"],
                          "launch": launch["decode_tc_launches"],
                          # bf16 sequence shards at lm_serve's widths
                          **on_regions("decode_tc")}),
        "max_abs_err": max(tcerr1, lm["decode"]["max_abs_err"],
                           moe["decode"]["max_abs_err"], wide["decode_err"],
                           sprod["decode_err"], launch["decode_tc_err"]),
        "ms": lm["decode"]["ms"], "plain_ms": lm["decode"]["plain_ms"],
        "bound_ms": lm["decode"]["bound_ms"],
        "bound_by": lm["decode"]["bound_by"],
        "library_ms": lm["decode"]["library_ms"]}]
    idle = [r["name"] for r in rows if r["launches"] < 1]
    check(not idle, f"kernels launched no time on their main path: {idle}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
