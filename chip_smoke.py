"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0] [--phases env,build,kernel,...]

Phases, in order, each printing one JSON line (any failure raises, so the
exit code is not 0):

1. env              — torch/CUDA versions, the card's name and power limit,
                      where nvcc resolves, whether triton imports, whether
                      zlib.h is there and a program using it links with
                      -lz (native/avrodecode.cpp is built so).
2. build            — build every kernel library from ops/csrc with nvcc
                      (one process per source, all started together), and
                      the host C++ libraries of the data plane with g++
                      (the Avro decoder and the off-heap index store).
3. kernel           — each kernel against its plain PyTorch version and a
                      float64 computation, on the card: csr_matvec_f32 over
                      random CSR matrices (n in {1, 31, 4097, 2^20}, rows of
                      0/1/16/33/4096 nonzeros, and a row holding every
                      column, dim in {2^17, 2^24}; bitwise repeats);
                      csc_rmatvec_f32 with all four value transforms over
                      random CSC matrices (n in {1, 4097, 2^20}, dim in
                      {2^17, 2^24}; empty columns, duplicate rows, a column
                      holding every row, long columns);
                      fused_value_grad_batched_f32 with the four losses over
                      batches (E, s, d) of VALUE_GRAD_SHAPES (s d odd,
                      entities larger than a ring slot, rows wider than
                      2048, the two buckets of train_full_width, the
                      latent widths d in {1, 2, 8} of a factored
                      coordinate), weight-0
                      rows whose loss overflows, and an entity's outputs
                      bitwise the same alone, at another position and in
                      batches of 7 and E; lane_shuffle_f32 (m in {1, 31, 32,
                      4097, 2^17} rows) and sublane_shuffle_f32 (R in {2, 4,
                      8}, {1, 31, 32, 4097} groups and 2^17 rows) with
                      identity, reversed and random indices, bitwise against
                      their plain versions, with kernel/plain/torch.gather/
                      bound times at 2^15 and 2^17 rows and the host us of a
                      K4 launch through its wrapper and as a bare ctypes
                      call; lane_relayout_f32 (Enter and Leave at 1, 6 and
                      15 tiles and at a 2^22-slot plan's outer level) and
                      inner_shuffle_f32 (c in {1, 2, 4, 8} in 1, 3 and 128
                      blocks and on 31 groups), each stage present or not,
                      bitwise against their plain versions; whole plans of
                      routing's structure at 2^22 and 2^24 slots: three
                      launches, bitwise the stage-by-stage plain plan, each
                      group and the plan timed against one torch.gather by
                      the composed index, the host us a plan;
                      csr_matvec_bf16 (every 7th
                      entry exact, stored as ~col) and csc_rmatvec_bf16 (four
                      transforms) at the full-width shape (2^20 rows, 2^24
                      dims) and a ragged small one, against their plain
                      versions and a float64 sum of the rounded terms;
                      fused_value_grad_f32 with the four losses at [2^20,
                      256], [700, 37], [1000, 130], [65,537, 129], [4097,
                      1], [3001, 300], [1001, 2500] and [1000, 128] with X
                      a view that is not 16-byte aligned (weight-0 rows
                      whose loss overflows; bitwise repeats), with
                      kernel/plain/library/bound times at [2^20, 256];
                      the objective's value_and_grad on one dense [s, d]
                      problem (s d from 2^10 to 2M) as routed, through the
                      single-block kernel and through the plain maps.
4. score_full_width — GameModel.score of a GLMix logistic model at full width
                      (FE: 2^20 rows x 2^24 dims x 16 nonzeros a row; per-user
                      RE 65,536 x 16; per-item RE 16,384 x 16; ~3% unseen
                      entities), checked against the same scoring through the
                      plain versions and for bitwise repeats, with
                      kernel/plain/library/bound times.
5. score_game_cli   — photon_ml_tpu_torch.cli.score_game on an Avro fixture
                      written by the port's own writers (65,536 rows x 16 FE
                      nonzeros), read through the native columnar decoder,
                      on cuda and on cpu: same AUC to 1e-6; on cuda with
                      --telemetry-out and --trace-out: valid ledger and
                      trace, scores bitwise the plain run's; on cuda with
                      --offheap-indexmap-dir over stores that the port's
                      build_index built from the fixture (scores within
                      rtol 2e-4, atol 1e-5 of the plain run's, AUC 1e-6);
                      on cuda with --model-id, --log-data-and-model-stats,
                      --log-file and --event-listeners (scores bitwise the
                      plain run's, the id on every record, the stats in the
                      log, the scoring events); csr_matvec_f32 launched;
                      the fixture read natively and through the Python
                      codec, called directly, in turns (read_native_s,
                      read_python_s).
6. serve_full_width
                    — online serving of score_full_width's model (make_glmix:
                      FE 2^24 x 16 nonzeros, per-user 65,536 and per-item
                      16,384 entities at RE width 4,096, ~3% unseen), its
                      16,384 rows (one entry a (row, column)) replayed as
                      requests. The artifact is packed, saved, loaded back
                      and compared bitwise in a spawned process at nice 19
                      from the end of phase 2 on. Modes: (a) sharded, 4
                      shards, buckets 1-32 (a batch of each first, as a
                      server warms up), continuous batching with a 2 ms
                      deadline; (b) sealed; (c) cached, 4,096 rows a
                      coordinate; (d) 16,384 device rows a coordinate with
                      the admission thread running, over the longest
                      prefix whose tail fits the headroom, then drain() and
                      a second replay. Gates: every score against
                      GameModel.score of the same rows on the card
                      (csr_matvec_f32 launched; rtol 2e-4, atol 1e-5 x
                      max(1, sum |terms|)), each result's cold coordinates
                      left out (unknown entities, and in (d) rows not yet
                      admitted); (b), (c) and two sealed replays bitwise a
                      full-table scorer's; (d) after drain equal to (a);
                      compile_count at most the number of buckets; no port
                      kernel launched by the replays. Then (a) again on a
                      serving mesh of 4 positions on cuda:0 (each table's 4
                      shards split into 4 blocks, a SplitTable), its
                      continuous replay's p50/p99 beside (a)'s, every score
                      checked as above and a sealed replay of the first
                      4,096 rows bitwise (b)'s; a mesh naming a card the
                      machine lacks refused. Prints p50/p99,
                      requests/s and batch fill of (a)-(d), the upload A/B
                      (pinned against pageable copies, the first 8,192
                      rows), score_batch at buckets 1 and 32 (ms,
                      device_ms), featurize host us, launches per batch
                      (torch.profiler), the device idle share of a replay
                      of 2,048 rows, the admission step us, table bytes
                      and peak memory.
7. nearline_full_width
                    — the nearline loop on serve_full_width's model and
                      artifact (its background process also hashes the
                      artifact's fingerprint, the chain's root): 65,536
                      fresh events (FE 16 nonzeros over 2^24 dims plus an
                      intercept column: over 2^20 nonzeros, the fused
                      engine; per_user and per_item 16 nonzeros; entities
                      Zipf(1.3) as bench.py _build_serving_workload draws
                      them, ~1 % new ids; labels from the model). (a)
                      incremental_update (one FE refresh, the random
                      effects capped at 256 samples an entity in 4
                      buckets) on cuda: launches of csr_matvec_f32,
                      csc_rmatvec_f32 and fused_value_grad_batched_f32
                      each > 0, against the same update through the plain
                      versions (rows and FE atol 2e-3, objective rtol
                      1e-4, the same touched and new entities) and itself
                      bitwise. (e) a VariantRegistry over a sharded scorer
                      of 4 shards with headroom 1.0, on the first 4,096
                      requests: v1 diverged by the update's delta scores
                      as GameModel.score of the merged model, base and the
                      undiverged v2 bitwise the plain path, rolling back
                      v1 leaves a diverged v2 bitwise; score_batch at bucket 32 plain and per
                      variant. (b) the delta swapped by HotSwapManager
                      into a second scorer built the same way (a base
                      swap appends its new entities where a registry's
                      overlay rows lie, so it never follows one on a
                      scorer; the reference's CLI refuses --variants
                      with --watch-deltas) in the middle of a continuous
                      replay of 16,384 requests, a feeder thread keeping
                      batches in flight until the swap returns: scores
                      before it as the old model's, after it as the
                      merged model's, those in flight a mix of old and
                      new coordinates, no new signature; blackout_s (the
                      reference's accounting: the artifact and FE
                      installs whole, the row updates' flip windows),
                      swap seconds, regrowths, and each batch's
                      score_batch seconds (count, p50, p99, max) before
                      the swap, overlapping its hooks, in the rest of its
                      wall and after it: the stall the request path saw.
                      (c)
                      the delta's rows negated and scaled by 8: the AUC
                      gate on 4,096 labelled rows rolls it back, the
                      tables bitwise. (f) the tenant_isolation,
                      ramped_rollout and nearline_loop scenarios over the
                      second scorer (per-tenant p50/p99, sheds, SLO verdicts).
                      (d) compact of a chain of two deltas, in a spawned
                      process during (b)-(f): bitwise the chain applied.
8. serve_game_cli   — photon_ml_tpu_torch.cli.serve_game on cuda and on cpu
                      over an Avro fixture and model (write_cli_fixture,
                      4,096 rows): pack with --export-artifact-dir, then
                      serve from --artifact-dir with --slo-latency-ms,
                      --overload-control, --request-sample-rate 1,
                      --tenants a,b and --introspect-port 0 (/healthz,
                      /varz, /metrics, /requests read during an
                      --introspect-hold, ended by /quitquitquit); cuda and
                      cpu agree in request and compile counts, their
                      replayed scores within rtol 2e-4, atol 1e-5. On
                      cuda: --auto-tune persists a tuned config that the
                      next boot applies; --cache-capacity 64, --sealed,
                      --scorers 2. Then update_game on cuda and on cpu
                      (two chained deltas over the cuda export, the second
                      with a FE refresh and --compact-into: equal counts),
                      serve_game --watch-deltas on the cuda chain (the
                      same swaps, scores within rtol 2e-4) and serve_game
                      --variants a,b --variant-ramp 10 --tenants t1,t2
                      --tenant-rate --tenant-burst --slo-latency-ms (the
                      same router decisions, quota verdicts and results,
                      the scores by request id within rtol 2e-4, atol
                      1e-5).
9. read_score_full_width
                    — the data of score_full_width at a quarter of its
                      depth (make_glmix at 2^18 rows x 2^24 dims x 16
                      nonzeros, per-user and per-item REs) written as 8
                      Avro part files of 32,768 rows by worker processes,
                      and indexed, in the background (nice 19) from the
                      end of phase 2 on;
                      off-heap stores of the FE (8 partitions), per-user
                      and per-item shards built by
                      the build_index CLI; read_game_data through those
                      stores on the native path, twice; the model's
                      coefficients carried into the stores' column space
                      by name; scored on cuda: the natively read GameData
                      equal to make_glmix's as sorted (row, name, value)
                      triples, the scores equal to the model's on
                      make_glmix's rows (bitwise, else rtol 2e-4, atol
                      1e-5), with the
                      write, build, read and score seconds, the read's
                      rows/s, peak RSS and csr_matvec_f32 launches.
10. train_full_width — GameEstimator.fit of a GLMix logistic model at the same
                      full width (FE 2^20 rows x 2^24 dims x 16 nonzeros +
                      an intercept; per-user RE 65,536 x 16, per-item
                      16,384 x 16), one outer iteration fixed -> per_user ->
                      per_item, L-BFGS 10 iterations, lambda 1, validation AUC
                      on 2^18 held-out rows; checked against the same training
                      through the plain versions on the card (objective rtol
                      1e-4, AUC 1e-4), with seconds per coordinate, launches,
                      kernel/plain/library/bound times (the batched
                      value+gradient at both buckets; csr_matvec_f32 also
                      with a sequential col_idx, the gather's share), one
                      L2-flushed time of each redesigned kernel, each kernel
                      against its plain version at those shapes, and the
                      device idle share of one random-effect solve.
11. train_streaming_full_width
                    — fit_streaming at the width of train_full_width: its
                      training rows written as 16 Avro part files of
                      65,536 rows by worker processes, off-heap stores built
                      by build_index (both in the background, nice 19,
                      from the end of phase 4 on),
                      StreamingSource.open(block_rows=65,536)
                      with a block cache in a temporary directory;
                      train_full_width's in-memory fit of the same rows
                      (moved into the stores' column space) as the
                      reference. Gates: the streamed full-batch (f, g) at
                      w = 0 and at the in-memory FE w equal to the
                      in-memory objective (f rtol 1e-4, g within 1e-4
                      max|g|); fit_streaming cold and warm bitwise
                      equal, a warm fit with no decode; against the
                      in-memory fit, the final objective within rtol 1e-4,
                      the FE coefficients within 2e-3 and held-out AUC
                      within 1e-3 (the stochastic fit read the same way as
                      a control); K6 and csr_matvec_f32
                      launched on that main path; the FE solve alone (under
                      torch.profiler: passes, device idle share) bitwise the
                      fit's FE update; a warm fit with 8 resident blocks
                      bitwise the warm fit, its h2d bytes down by the saved
                      bytes; two gap-scheduled stochastic fits of 1 epoch
                      bitwise equal. With open, fit and decode, stall,
                      transfer, hidden-upload seconds, hide ratio, h2d
                      bytes, peak device memory and peak RSS.
12. train_cluster_full_width
                    — the cluster path, train_game --streaming --hosts
                      2 at that width: ClusterPlane.launch of two worker
                      processes on the card (each its own CUDA context,
                      stream, pinned ring and block-cache subdirectory)
                      over phase 11's part files and stores, launched with
                      the drill's plane in the background (nice 19) during
                      phase 11's resident and stochastic fits; a cold and a
                      warm fit_streaming(cluster=...) (the warm one under
                      torch.profiler: the coordinator's device idle share)
                      held against phase 11's single-host streamed fit
                      (final objective rtol 1e-4, FE coefficients atol
                      2e-3, AUC 1e-3; whether the two are bitwise equal
                      is recorded: the warm fit's partitions follow the
                      gap ledger the cold one left); then the
                      chaos drill, host 1 killed after 4 blocks: the same
                      gates, one host_lost event and failure record, its
                      blocks reassigned, its exit code 17. With passes,
                      bytes a reply and a pass message, busy, allreduce
                      wait and fold seconds from the pass profiles, each
                      worker's allocator peak, the card's memory in use.
13. train_grid_full_width
                    — the grid path: train_full_width's fit on a 2 x 2 grid of
                      fused tiles with devices [cuda:0] * 4 (the per-user
                      and per-item entity blocks split over the 4
                      positions), held against train_full_width's fit (FE
                      coefficients atol 5e-3, scores 1e-2, objective rtol
                      1e-4, AUC 1e-4), itself (bitwise) and the same fit on
                      the host score plane; csr_matvec_f32 and
                      csc_rmatvec_f32 at a tile's shape and K6 at a device
                      slice's against their plain versions and float64,
                      timed, with the fit's launches; a 2 x 1 Benes grid at
                      that width over 16 (2^16 rows, 2^20 columns) against
                      the fused fit of its rows, lane_shuffle_f32 and
                      sublane_shuffle_f32 at a tile network's stages, its
                      plan's groups and the whole plan (bitwise, timed;
                      the plan's kernels launched by the fit); and a 2 x 2
                      grid of distinct cards refused
                      on a one-card machine ("need 4 devices, have 1") by
                      the estimator and train_game. The layout check
                      (grid_layout_check), on the repeat fit and on a TRON
                      solve of the grid's fixed effect (5 iterations,
                      against the same solve on one device, objective rtol
                      1e-4): every state an FE solver step returns holds
                      its vectors (w, gradient, s/y rings) as feat blocks
                      of d_loc, block j on feat column j's device, and no
                      tensor with a d_pad dimension is made while the
                      solve runs (a torch dispatch mode sees every one);
                      the per-user and per-item slices placed once, each
                      a PlacedBucket slice on its position's device.
14. train_glm_full_width
                    — estimators.model_training.train_glm on that fit's FE
                      shard (2^20 rows x (2^24 + 1) dims, 16 nonzeros a row
                      + an intercept; fused engine), labels of each task from
                      one seeded coefficient vector, the three reference
                      configurations of examples/BASELINE_CONFIGS.md: (a)
                      logistic, L-BFGS 10 iterations, L2 lambda in {100, 10,
                      1, 0.1} warm-started, held-out AUC per lambda and the
                      best lambda; (b) linear, TRON (15 iterations, <= 20 CG
                      steps), L2 lambda 1, STANDARDIZATION, variances (the
                      "sq" transform); (c) Poisson, OWL-QN 30 iterations,
                      elastic net alpha 0.5 lambda 1, box [-2, 2]. Each
                      through the kernels, through the plain versions
                      (objective rtol 1e-4 per lambda, same best lambda, AUC
                      1e-4, variances rtol 1e-2, |w| <= 2, nonzero counts
                      within 0.1 %) and again (bitwise), with each solve's
                      seconds, iterations, reason, value+gradient and Hv
                      evaluations, launches, and device busy ms and idle
                      share (the run without tracking: tracked coefficients
                      would take 16-101 copies of w).
15. train_glm_diagnostics_full_width
                    — cli.train_glm's diagnose stage (_diagnose), each part
                      through the kernels, through the plain versions and
                      through the kernels again (bitwise the first: the
                      report's arguments and model-diagnostic.html):
                      (i) --diagnostic-mode ALL after (a) of phase 14 on
                      its data (2^20 rows x (2^24 + 1) dims, fused engine,
                      the best lambda by held-out AUC): the learning curves
                      {} by the reference's rows <= dims rule, 6 bootstrap
                      fits at the best lambda, Hosmer-Lemeshow, Kendall tau
                      on 2,000 items, both importances over 2^24 + 1
                      coefficients (a positional index map: no dict of 2^24
                      names); (ii) --diagnostic-mode TRAIN at 2^20 rows x
                      (2^16 + 1) dims, 16 nonzeros + an intercept, lambda 1:
                      9 learning-curve portions (each over 2^20 nonzeros,
                      the fused engine) and the bootstrap. Gates, kernels
                      against plain: metrics rtol 1e-4 (AUC 1e-4), bootstrap
                      metric summaries rtol 1e-3 (std within 1e-3 of the
                      mean), zero crossings within 0.1 %, HL the same bins
                      and chi^2 rtol 1e-3, tau-alpha 1e-3, the same top-25
                      importance indices (values rtol 1e-3), curve values
                      rtol 1e-3; csr_matvec_f32 and csc_rmatvec_f32
                      launched by the stage. Prints the stage's seconds
                      (sub-data, sub-fits, scoring, statistics and report),
                      launches, device idle share (the repeat run, under
                      torch.profiler) and peak memory.
16. train_tron_full_width
                    — one outer iteration of the train_full_width GLMix fit
                      with the fixed effect and per_user on TRON (L2 lambda
                      1) and per_item on OWL-QN (elastic net alpha 0.5,
                      lambda 1): through the kernels and the plain versions
                      (objective rtol 1e-4, AUC 1e-4), with the batched
                      value+gradient's launches, each coordinate's seconds
                      and idle share, the solver trackers and stats.
17. fe_bf16_full_width
                    — the fixed-effect shard of train_full_width (2^20 rows
                      x (2^24 + 1) dims, 16 nonzeros a row + an intercept)
                      on the fused engine built twice, float32 and bfloat16
                      payload, each solved alone (logistic, L-BFGS 50
                      iterations, lambda 1, L2; the reference's fused_bf16
                      solve): the f32 objective at the bf16 solution within
                      1e-4 of the f32 optimum (the reference's quality
                      gate), the bf16 solve through the kernels against the
                      same solve through the plain versions (objective
                      1e-4) and against itself (bitwise), with the layout,
                      build and solve seconds, one map of each engine (the
                      bf16 matvec one csr_matvec_bf16 pass over both entry
                      sets), kernel/plain/library/bound times at the path's
                      shapes, csr_matvec_bf16 also with a sequential col_idx
                      and L2-flushed, and the device idle share of one bf16
                      solve.
18. train_benes_full_width
                    — training data of that width at a quarter of its
                      depth (2^18 rows, 2^16 held out: cold routing of
                      2^20 rows took 75-160 s) with the fixed effect on the
                      stage-by-stage Benes engine (sparse_engine "benes")
                      under STANDARDIZATION (intercept column 2^24): the
                      plans routed cold into a fresh plan cache by a
                      spawned process at nice 19 from the end of phase 2 on
                      (its routing seconds), the engine built on the card
                      from that cache (the layout the planner chose,
                      device bytes),
                      the Benes and fused summaries of the FE shard against
                      each other, the fit through the plan kernels (every
                      kernel its compiled plans launch, launched) against
                      the same fit through their plain versions (bitwise)
                      and against itself (bitwise), the fused-engine fit
                      under the same normalization (objective rtol 1e-4,
                      AUC 1e-4), the standalone shuffles at the plan's
                      stage shapes and its groups at theirs (bitwise, with
                      kernel/plain/torch.gather/bound times), the whole
                      plan against the stage-by-stage plain plan (bitwise)
                      and one gather, Benes vs fused matvec and rmatvec
                      times, and the device idle share of one FE solve.
19. train_full_game_full_width
                    — the train_full_width GLMix fit at half its depth
                      (ASYNC_DEPTH: 2^19 rows, 2^17 held out) plus the user-item-mf
                      factored coordinate of examples/game.json.example (the
                      per_item shard's 4,096 columns over userId, k = 8, 2
                      MF iterations, L-BFGS 10 iterations, lambda 1, one
                      outer iteration): through the kernels, through the
                      plain versions (objective rtol 1e-4, AUC 1e-4, B atol
                      the larger of 2e-3 and twice B's f32 floor: its spread
                      on the kernel path under a 1e-7 relative nudge of the
                      MF residual) and again (bitwise); K6 launched at the latent
                      [E, S, 8] buckets and checked there against its plain
                      version and float64 (bitwise repeats), with
                      kernel/plain/library/bound times; seconds per
                      coordinate and per MF step (a) and (b); KronFeatures
                      matvec and rmatvec times, its one sort a solve, and
                      an accumulating index_put_ of the same terms; bucket
                      shapes and device bytes;
                      the device idle share of one MF update.
20. train_async_full_width
                    — the train_full_width fit at half its depth
                      (ASYNC_DEPTH: 2^19 rows, 2^17 held out; the widths
                      the same) with per_user in 4 buckets
                      and per_item in 2, 1 outer iteration, on the sync
                      schedule and on schedule="async" (a CUDA stream a
                      worker; bucket overlap two at a time): staleness 0
                      bitwise the sync fit, two staleness-1 fits bitwise
                      equal, staleness 1 through the plain versions
                      (objective rtol 1e-4, AUC 1e-4), its held-out AUC
                      within 0.02 of sync; each random effect's update with
                      its buckets overlapped bitwise the sequential one per
                      bucket; for sync and async the fit's wall and host CPU
                      seconds, each update's seconds, launches, peak memory,
                      and the card's busy ms (the union of its events on
                      every stream) and idle share under torch.profiler.
21. train_sweep_tuning_full_width
                    — on the same coordinates (built once): fit_multiple
                      over per_user lambda in {10, 1, 0.1} (1 outer
                      iteration, warm-started), select_best_fit against the
                      metrics and each swept fit bitwise the same fit by
                      hand; RANDOM tuning of 2 trials, whose log10 lambda
                      vectors equal the Sobol draws tests/test_torch_tuning.py
                      pins; resolve_coordinate("per_user") on the held-out
                      rows bitwise the same update by hand; seconds of each.
22. train_telemetry_full_width
                    — on the same coordinates, the sync fit of phase 20
                      (2 outer iterations): (a) tracing off; (b) traced
                      (run ledger and Chrome trace), with a
                      ConvergenceTracker and the memory gauges; in turns a,
                      b, b, a: bitwise (a), the files valid, the count of
                      spans by name, of stream syncs and of launches, the
                      analyze_run report, the wall ratio (b)/(a), the peak
                      memory, mem.device0_peak_bytes against
                      torch.cuda.max_memory_allocated(); (c) async at
                      staleness 1 traced and untraced: bitwise, every
                      cd/overlap and re/solve_bucket span of a worker thread
                      chained under the dispatcher's; (d) the objective of
                      the second update poisoned to inf: DivergenceError,
                      one AnomalyEvent non_finite_objective, the progress
                      ledger's last record unhealthy; (e) the fault site
                      train.checkpoint.publish armed once:1 on the fit
                      resumed from a 1-iteration checkpoint: InjectedFault,
                      that generation intact, then a resume bitwise the
                      uninterrupted fit.
23. train_game_cli  — photon_ml_tpu_torch.cli.train_game on the committed
                      ratings fixture (LINEAR_REGRESSION, FE + per_user +
                      per_movie, 2 outer iterations, RMSE), on cuda and on
                      cpu: RMSE < 0.45 on both and equal to 1e-4, two cuda
                      runs bitwise equal; then score_game on the saved
                      model reproduces the RMSE. Then the same under
                      --normalization-type STANDARDIZATION with a Benes FE,
                      on cuda and cpu: RMSE < 0.45, equal to 1e-4, and
                      score_game on the saved model (which scores through the
                      Benes engine again) reproduces it. Then the
                      reference's golden FE-only fit (TRON, L2 lambda 10) on
                      cuda and cpu: RMSE < 0.95, equal to 1e-4. Then the
                      full-GAME config (a factored coordinate over userId,
                      k = 2) on cuda (twice: bitwise) and cpu: RMSE < 0.45,
                      equal to 1e-4, score_game reproduces it; and that
                      config stopped after 1 of 2 outer iterations with
                      --checkpoint-dir and resumed: bitwise equal to the
                      uninterrupted run. Then --streaming (blocks of 512
                      rows, one block cache) on cuda and cpu: RMSE < 0.45,
                      equal to 1e-4, within 1e-3 of the in-memory cuda
                      fit (the JAX package's streaming gate on this
                      fixture), K6 launched on cuda. Then, on cuda,
                      --streaming --hosts 2 (worker processes on the card)
                      and the same with --cluster-kill-host 1:4 (their cpu
                      runs are left to tests/test_torch_cluster.py, to
                      keep the script's time), and on cuda and cpu
                      --parallel-data 1 --parallel-feat 1: RMSE within 1e-4
                      of the single-host streamed and in-memory runs on the
                      same device. Then,
                      on cuda and cpu: a
                      regularization_weights sweep on per_user with
                      --model-output-mode ALL (the same best lambda,
                      metrics to 1e-4 and saved layout), RANDOM tuning (the
                      same trial lambdas), BAYESIAN tuning (6 trials,
                      1e-3..1e3: best RMSE no more than 0.005 above the sync
                      fit's and within 1e-4 of the JAX CLI's), --schedule
                      async --staleness 1 (within 1e-4 of the JAX CLI's
                      RMSE at 2 outer iterations; within 0.005 of the sync
                      fit at 3), --updating-sequence reversed with
                      --no-warm-start, two RE part files and --check-data,
                      and the date-range flags over a daily copy of the
                      fixture (bitwise the plain run; score_game
                      --date-range reproduces it). Then, on cuda and cpu,
                      --telemetry-out, --trace-out, --progress-out and
                      --introspect-port 0: bitwise the plain run, valid
                      ledgers, analyze_run and analyze_run --progress exit
                      0 on them; and --auto-tune --auto-tune-trials 1 on a
                      config whose per_user has an adaptive block:
                      auto-tune.json with the JAX CLI's keys, RMSE within
                      0.005 of the golden 0.388473.
24. train_glm_cli   — photon_ml_tpu_torch.cli.train_glm with the three
                      invocations of examples/BASELINE_CONFIGS.md on small
                      fixtures the phase writes (Avro by write_cli_fixture,
                      LibSVM from the seed), on cuda and on cpu: the same
                      selection, metrics and model-file coefficients to
                      1e-4; configuration (a) on cuda with --telemetry-out
                      and --trace-out (valid files, the phases as spans,
                      every output bitwise the plain run's); (a) with
                      --diagnostic-mode ALL and --telemetry-out on cuda and
                      on cpu (the same chapters in order, metrics to 1e-4,
                      model-diagnostic.html written, a diagnose span); and
                      (a) once more through ``python -m`` in a process of
                      its own.

Every kernel, plain version and library call that a phase times gets two
figures (cuda_ms): "ms", one call between two CUDA events, and
"device_ms", a run of back-to-back calls between two events over their
count, which keeps the wrapper's host work out of the kernel's time; the
redesigned kernels also "flushed_ms" (flushed_ms: one call after a 256 MB
write that evicts L2). compare_kernels.py times kernels against another
commit's in turns.

Then a line with the seconds of each phase, a line with the card's name and
power limit (nvidia-smi), a JSON line with one entry per kernel, and last
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, when torch.cuda.is_available() is False.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

ALL_PHASES = ("env", "build", "kernel", "score_full_width", "score_game_cli",
              "serve_full_width", "nearline_full_width", "serve_game_cli", "read_score_full_width",
              "train_full_width", "train_streaming_full_width",
              "train_cluster_full_width", "train_grid_full_width",
              "train_glm_full_width", "train_glm_diagnostics_full_width",
              "train_tron_full_width",
              "fe_bf16_full_width", "train_benes_full_width", "train_full_game_full_width",
              "train_async_full_width", "train_sweep_tuning_full_width",
              "train_telemetry_full_width", "train_game_cli", "train_glm_cli")
KERNELS = ("csr_matvec_f32", "csc_rmatvec_f32", "fused_value_grad_batched_f32")
# every kernel of ops/csrc/permute.cu: the standalone stages and the two
# kernels a compiled plan launches
SHUFFLES = ("lane_shuffle_f32", "sublane_shuffle_f32", "lane_relayout_f32", "inner_shuffle_f32")
BF16_KERNELS = ("csr_matvec_bf16", "csc_rmatvec_bf16")
BLOCKED = "fused_value_grad_f32"
KERNEL_REPLACES = {
    "csr_matvec_f32": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), "
                      ":466 (_base_call), :421 (_ascend_call); matvec configuration",
    "csc_rmatvec_f32": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), "
                       ":466 (_base_call), :421 (_ascend_call); rmatvec configuration",
    "fused_value_grad_batched_f32": "photon_ml_tpu/ops/pallas_kernels.py:186 "
                                    "(fused_value_grad_single, _single_kernel :140)",
    "lane_shuffle_f32": "photon_ml_tpu/ops/permute_net.py:96 (_lane_shuffle_pallas)",
    "sublane_shuffle_f32": "photon_ml_tpu/ops/permute_net.py:129 (_sublane_shuffle_pallas)",
    "lane_relayout_f32": "photon_ml_tpu/ops/permute_net.py:96 (_lane_shuffle_pallas) twice and "
                         "the Enter/Leave relayout between them (apply_plan :192-197)",
    "inner_shuffle_f32": "photon_ml_tpu/ops/permute_net.py:96 (_lane_shuffle_pallas), :129 "
                         "(_sublane_shuffle_pallas), :96 again, inside Enter/Leave (apply_plan "
                         ":192-197)",
    "csr_matvec_bf16": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), :466 "
                       "(_base_call), :421 (_ascend_call); matvec, bfloat16 payload",
    "csc_rmatvec_bf16": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), :466 "
                        "(_base_call), :421 (_ascend_call); rmatvec, bfloat16 payload",
    "fused_value_grad_f32": "photon_ml_tpu/ops/pallas_kernels.py:115 "
                            "(fused_value_grad, _kernel :45)",
}
KERNEL_SOURCE = {
    "csr_matvec_f32": "photon_ml_tpu_torch/ops/csrc/spmv.cu",
    "csc_rmatvec_f32": "photon_ml_tpu_torch/ops/csrc/spmv_t.cu",
    "fused_value_grad_batched_f32": "photon_ml_tpu_torch/ops/csrc/value_grad.cu",
    "lane_shuffle_f32": "photon_ml_tpu_torch/ops/csrc/permute.cu",
    "sublane_shuffle_f32": "photon_ml_tpu_torch/ops/csrc/permute.cu",
    "lane_relayout_f32": "photon_ml_tpu_torch/ops/csrc/permute.cu",
    "inner_shuffle_f32": "photon_ml_tpu_torch/ops/csrc/permute.cu",
    "csr_matvec_bf16": "photon_ml_tpu_torch/ops/csrc/spmv.cu",
    "csc_rmatvec_bf16": "photon_ml_tpu_torch/ops/csrc/spmv_t.cu",
    "fused_value_grad_f32": "photon_ml_tpu_torch/ops/csrc/value_grad.cu",
}
RATINGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "ratings")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns: dict, reps: int = 20, warmup: int = 3, batch: int = 32,
            rounds: int = 6) -> dict:
    """Two times of each function on the card, in milliseconds:

    - ``name``: the median over ``reps`` calls of one call between two CUDA
      events (the per-call figure: the caller's host work inside the window,
      while the card waits for the launch, is counted);
    - ``name + "_device"``: the median over ``rounds`` runs of ``batch``
      back-to-back calls between one pair of events, over ``batch`` (the
      device time: the host enqueues ahead of the card, so a call's host
      work hides behind the calls before it, unless it takes longer).

    The functions take turns, in order and then in reverse (a b c c b a),
    so that a drift of the card's clock falls on all of them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    device = {name: [] for name in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        for name in order:
            for _ in range(reps // 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
            for _ in range(rounds // 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(batch):
                    fns[name]()
                end.record()
                end.synchronize()
                device[name].append(start.elapsed_time(end) / batch)
    out = {name: statistics.median(t) for name, t in times.items()}
    out.update({f"{name}_device": statistics.median(t) for name, t in device.items()})
    return out


def kernel_times(ms: dict) -> dict:
    """A kernel entry's time fields from a ``cuda_ms`` result over the
    functions "kernel", "plain" and "library"."""
    return {f"{prefix}{kind}": ms[name + suffix]
            for name, prefix in (("kernel", ""), ("plain", "plain_"), ("library", "library_"))
            for kind, suffix in (("ms", ""), ("device_ms", "_device"))}


# a buffer written before each call of flushed_ms: larger than the 50 MB L2
L2_FLUSH_BYTES = 256 << 20


# cycles of a spin on the card (about 0.2 ms) queued between the L2 flush
# and a flushed call's start event, longer than the call's host work
FLUSH_SPIN_CYCLES = 400_000


def flushed_ms(fn, reps: int = 10) -> float:
    """Median ms of one call of ``fn`` between two CUDA events, a buffer of
    L2_FLUSH_BYTES written on the card just before each call, so that the
    call starts with none of its operands in L2. A spin that touches no
    memory is queued between the writes and the start event: the card is
    still spinning while the host does the call's own work, so the events
    hold the call's device time alone."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        buf.fill_(1.0)
        torch.cuda._sleep(FLUSH_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, flops: float) -> tuple:
    """The larger of bytes over the HBM rate and flops over the f32 rate,
    in ms, and which of the two it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def csr_bound_ms(n: int, nnz: int, dim: int) -> tuple:
    """Least time for z = X w on the card: each input read once (row_ptr
    8(n+1), col_idx 4 nnz, vals 4 nnz, w 4 dim), z written once (4n); 2 flops
    a nonzero."""
    return _bound(8 * (n + 1) + 8 * nnz + 4 * dim + 4 * n, 2 * nnz)


def csc_bound_ms(n: int, nnz: int, dim: int) -> tuple:
    """Least time for g = X^T c: col_ptr 8(dim+1), row_idx 4 nnz, vals 4 nnz
    and c 4n read once, g written once (4 dim); 2 flops a nonzero."""
    return _bound(8 * (dim + 1) + 8 * nnz + 4 * n + 4 * dim, 2 * nnz)


def shuffle_bound_ms(m: int, stages: int = 1) -> tuple:
    """Least time for one pass over [m, 128] f32 that applies ``stages``
    shuffle stages (a lane or sublane shuffle 1, lane_relayout_f32 up to 2,
    inner_shuffle_f32 up to 3): v read once (4 B), each stage's int8 index
    read once (1 B), out written once (4 B) an element; no arithmetic."""
    return _bound((8 + stages) * 128 * m, 0)


def value_grad_bound_ms(E: int, s: int, d: int) -> tuple:
    """Least time for the fused value+gradient pass: X, y, off, wt, w read
    once and value, grad, csum written once, 4E(s d + 3s + 2d + 2) bytes;
    4 s d flops an entity (z and the gradient, 2 each)."""
    return _bound(4 * E * (s * d + 3 * s + 2 * d + 2), 4 * E * s * d)


# ---------------------------------------------------------------- phases


def phase_env() -> dict:
    from photon_ml_tpu_torch.utils import cudalib

    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvidia_smi": nvidia_smi(),
        "nvcc": cudalib.find_nvcc(),
        "triton": triton_version,
        "device_count": torch.cuda.device_count(),
        **zlib_probe(),
    }
    emit("env", **info)
    return info


def zlib_probe() -> dict:
    """Whether zlib.h is there and a program calling zlib links with -lz:
    native/avrodecode.cpp includes the header and is linked so
    (io/native_reader.LDFLAGS), a choice made at build time."""
    from photon_ml_tpu_torch.io import native_reader

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zlib_") as d:
        src = os.path.join(d, "probe.cpp")
        with open(src, "w") as f:
            f.write("#include <zlib.h>\nint main() { return zlibVersion()[0] == 0; }\n")
        link = subprocess.run(["g++", src, "-o", os.path.join(d, "probe"), "-lz"],
                              capture_output=True, text=True, timeout=120)
    return {"zlib_h": os.path.exists("/usr/include/zlib.h"),
            "zlib_links": link.returncode == 0,
            "avrodecode_ldflags": list(native_reader.LDFLAGS)}


def phase_build() -> dict:
    from photon_ml_tpu_torch.utils import cudalib

    from photon_ml_tpu_torch.indexmap import offheap
    from photon_ml_tpu_torch.io import native_reader

    sources = sorted(p.stem for p in cudalib.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    logs = cudalib.build_libraries(sources)
    seconds = time.perf_counter() - t0
    ptxas = {name: [l for l in log.splitlines() if "registers" in l or "spill" in l]
             for name, log in logs.items()}
    # the host C++ of the data plane (g++; a failed build raises)
    t0 = time.perf_counter()
    native_reader.native_available()
    offheap.native_available()
    host_seconds = time.perf_counter() - t0
    emit("build", seconds=seconds, sources=sources, ptxas=ptxas,
         host_libraries=["avrodecode", "indexstore"], host_seconds=host_seconds)
    return {"seconds": seconds}


def _random_csr(n: int, dim: int, gen: torch.Generator, dev) -> tuple:
    """Rows of 0/1/16/33 nonzeros in turn, and 4096 nonzeros in every
    4099th row (row 0 included)."""
    pattern = torch.tensor([0, 1, 16, 33], dtype=torch.int64, device=dev)
    r = torch.arange(n, device=dev)
    lengths = pattern[r % 4]
    lengths[r % 4099 == 0] = 4096
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(row_ptr[-1])
    col_idx = torch.randint(0, dim, (nnz,), generator=gen, device=dev, dtype=torch.int64)
    vals = torch.randn(nnz, generator=gen, device=dev)
    return row_ptr, col_idx.to(torch.int32), vals


def _row_of_every_column(dim: int, gen, dev) -> tuple:
    """Four rows: empty, every column once (in order), 3 nonzeros, empty."""
    lengths = torch.tensor([0, dim, 3, 0], dtype=torch.int64, device=dev)
    row_ptr = torch.zeros(5, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(lengths, 0)
    col_idx = torch.cat([torch.arange(dim, device=dev),
                         torch.randint(0, dim, (3,), generator=gen, device=dev)])
    return row_ptr, col_idx.to(torch.int32), torch.randn(dim + 3, generator=gen, device=dev)


def _check_csr_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.ops import fused_perm

    cases, worst = [], 0.0
    for dim in (1 << 17, 1 << 24):
        w = torch.randn(dim, generator=gen, device=dev)
        for n in (1, 31, 4097, 1 << 20, "every_column"):
            row_ptr, col_idx, vals = (_random_csr(n, dim, gen, dev) if n != "every_column"
                                      else _row_of_every_column(dim, gen, dev))
            n = row_ptr.numel() - 1
            z = fused_perm.csr_matvec_f32(row_ptr, col_idx, vals, w, dim)
            torch.cuda.synchronize()
            z_plain = fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w)
            rows = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr.diff())
            prod = vals.double() * w.double()[col_idx.long()]
            z64 = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, prod)
            row_abs = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
                0, rows, prod.abs()
            )
            case = _compare(z, z_plain, z64, row_abs, row_ptr.diff(), (n,),
                            n=n, dim=dim, nnz=int(row_ptr[-1]))
            case["bitwise_repeatable"] = bool(torch.equal(
                z, fused_perm.csr_matvec_f32(row_ptr, col_idx, vals, w, dim)))
            case["ok"] = case["ok"] and case["bitwise_repeatable"]
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", csr_matvec_f32=cases)
                raise AssertionError(f"csr_matvec_f32 disagrees with its plain version: {case}")
    return cases, worst


def row_major_csr(feats) -> tuple:
    """(row_ptr [n+1], col_idx, vals) of a fused engine's CSR copy in plain
    row-major order, its column blocks merged (a stable sort by row keeps
    each row's blocks, and so its columns, in order)."""
    from photon_ml_tpu_torch.ops import fused_perm

    n = feats.num_rows
    rows = fused_perm.csr_rows_of_nonzeros(feats.row_ptr, feats.row_blocks)
    order = torch.argsort(rows, stable=True)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return row_ptr, feats.col_idx[order], feats.vals[order]


def _compare(out, plain, ref64, abs_sum, terms, shape, **info) -> dict:
    """out against a float64 computation within atol = 1e-5 * max(1, sum of
    |terms|), elementwise, and against its plain version within that plus
    the plain version's own rounding bound, terms * 2^-24 * max(1, sum of
    |terms|) (it adds one term at a time in f32, with atomics on the card;
    ``terms`` is the number of terms of each output)."""
    scale = torch.clamp(abs_sum, min=1.0)
    tol = 1e-5 * scale
    tol_plain = tol + terms * 2.0 ** -24 * scale
    d_plain = (out.double() - plain.double()).abs()
    d_64 = (out.double() - ref64).abs()
    ok = (
        tuple(out.shape) == tuple(shape)
        and bool(torch.isfinite(out).all())
        and bool((d_plain <= tol_plain).all())
        and bool((d_64 <= tol).all())
    )
    return {**info, "max_abs_err_plain": float(d_plain.max()) if out.numel() else 0.0,
            "max_abs_err_f64": float(d_64.max()) if out.numel() else 0.0, "ok": ok}


def _random_csc(n: int, dim: int, gen: torch.Generator, dev) -> tuple:
    """Columns of 0/1/1/2/1/0/3/1 nonzeros in turn (empty columns), 40 in
    every 1021st column and 9000 in every 65,537th (long columns; one of
    9000 is cut by five shares of the merge path), every row in column 0;
    row indices drawn with replacement, so a column may name a row twice."""
    pattern = torch.tensor([0, 1, 1, 2, 1, 0, 3, 1], dtype=torch.int64, device=dev)
    j = torch.arange(dim, device=dev)
    lengths = pattern[j % 8]
    lengths[j % 1021 == 5] = 40
    lengths[j % 65537 == 7] = 9000
    lengths[0] = n
    col_ptr = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(col_ptr[-1])
    row_idx = torch.randint(0, n, (nnz,), generator=gen, device=dev)
    row_idx[: n] = torch.arange(n, device=dev)  # column 0: every row once
    vals = torch.randn(nnz, generator=gen, device=dev)
    vals[torch.rand(nnz, generator=gen, device=dev) < 0.01] = 0.0  # for "nnz"
    return col_ptr, row_idx.to(torch.int32), vals


def _check_csc_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.ops import fused_perm

    transforms = {
        "id": lambda v: v, "sq": lambda v: v * v, "abs": lambda v: v.abs(),
        "nnz": lambda v: (v != 0).to(v.dtype),
    }
    cases, worst = [], 0.0
    for dim in (1 << 17, 1 << 24):
        for n in (1, 4097, 1 << 20):
            col_ptr, row_idx, vals = _random_csc(n, dim, gen, dev)
            c = torch.randn(n, generator=gen, device=dev)
            split = fused_perm.merge_path_split(col_ptr, row_idx.numel())
            cols = torch.repeat_interleave(torch.arange(dim, device=dev), col_ptr.diff())
            for name, t in transforms.items():
                g = fused_perm.csc_rmatvec_f32(col_ptr, row_idx, vals, c, n, name, split)
                torch.cuda.synchronize()
                g_plain = fused_perm.csc_rmatvec_plain(col_ptr, row_idx, vals, c, name)
                prod = t(vals.double()) * c.double()[row_idx.long()]
                g64 = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(0, cols, prod)
                col_abs = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(
                    0, cols, prod.abs()
                )
                case = _compare(g, g_plain, g64, col_abs, col_ptr.diff(), (dim,), n=n, dim=dim,
                                nnz=int(col_ptr[-1]), transform=name,
                                ctas=split.shape[1] - 1)
                repeat = fused_perm.csc_rmatvec_f32(col_ptr, row_idx, vals, c, n, name, split)
                case["bitwise_repeatable"] = bool(torch.equal(g, repeat))
                case["ok"] = case["ok"] and case["bitwise_repeatable"]
                cases.append(case)
                worst = max(worst, case["max_abs_err_plain"])
                if not case["ok"]:
                    emit("kernel", csc_rmatvec_f32=cases)
                    raise AssertionError(f"csc_rmatvec_f32 disagrees with its plain version: {case}")
    return cases, worst


# tiles of whole entities (s d odd: (7, 33, 5), (65,536, 33, 1)), entities
# larger than a slot ((1, 512, 100); (3, 1000, 33) with s d odd), rows
# wider than 2048 columns (the warp kernel), the two buckets of
# train_full_width; the latent widths of a factored coordinate, d in
# {1, 2, 8} (many entities a tile), and a latent bucket of
# train_full_game_full_width's size (k = 8)
VALUE_GRAD_SHAPES = ((1, 1, 1), (1, 512, 100), (7, 33, 16), (7, 16, 100), (7, 33, 5),
                     (3, 1000, 33), (2, 5, 2100), (65_536, 16, 16), (65_536, 33, 1),
                     (65_536, 38, 16), (16_384, 96, 16), (7, 33, 2), (4097, 17, 2),
                     (7, 33, 8), (65_536, 40, 8))
# batches in which one entity's outputs must not depend on its company
VALUE_GRAD_INVARIANCE_SHAPES = ((65_536, 38, 16), (701, 33, 5), (9, 600, 17), (701, 33, 2),
                                (4097, 40, 8))


def _value_grad_f64(X, y, off, wt, w, kind):
    """The pass in float64, and the sums of |terms| that bound its f32
    rounding."""
    X, y, off, wt, w = (t.double() for t in (X, y, off, wt, w))
    z = (X * w.unsqueeze(-2)).sum(-1) + off
    pos = wt > 0
    lw = torch.where(pos, wt * kind.value(z, y), torch.zeros_like(z))
    dz = torch.where(pos, wt * kind.d1(z, y), torch.zeros_like(z))
    return (
        (lw.sum(-1), (dz.unsqueeze(-1) * X).sum(-2), dz.sum(-1)),
        (lw.abs().sum(-1), (dz.unsqueeze(-1) * X).abs().sum(-2), dz.abs().sum(-1)),
    )


def _value_grad_inputs(E, s, d, gen, dev) -> tuple:
    X = torch.randn(E, s, d, generator=gen, device=dev) / max(d, 1) ** 0.5
    y = (torch.rand(E, s, generator=gen, device=dev) < 0.5).float()
    off = torch.randn(E, s, generator=gen, device=dev) * 0.5
    wt = torch.rand(E, s, generator=gen, device=dev) + 0.5
    # weight-0 rows, a quarter of them with an offset that makes the squared
    # and Poisson losses overflow to inf
    zero = torch.rand(E, s, generator=gen, device=dev) < 0.2
    wt[zero] = 0.0
    off[zero & (torch.rand(E, s, generator=gen, device=dev) < 0.25)] = 1e20
    w = torch.randn(E, d, generator=gen, device=dev)
    return X, y, off, wt, w


def _check_value_grad_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.losses.pointwise import (
        LogisticLoss, PoissonLoss, SmoothedHingeLoss, SquaredLoss,
    )
    from photon_ml_tpu_torch.ops import pallas_kernels

    cases, worst = [], 0.0
    for E, s, d in VALUE_GRAD_SHAPES:
        inputs = _value_grad_inputs(E, s, d, gen, dev)
        for kind in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
            out = pallas_kernels.fused_value_grad_batched_f32(*inputs, kind)
            torch.cuda.synchronize()
            plain = pallas_kernels.fused_value_grad_plain(*inputs, kind)
            ref, scale = _value_grad_f64(*inputs, kind)
            parts = [
                _compare(o, p, r, a, terms, o.shape, part=name)
                for name, o, p, r, a, terms in zip(
                    ("value", "grad", "csum"), out, plain, ref, scale, (s, s, s))
            ]
            case = {"E": E, "s": s, "d": d, "loss": kind.__name__,
                    "max_abs_err_plain": max(p["max_abs_err_plain"] for p in parts),
                    "max_abs_err_f64": max(p["max_abs_err_f64"] for p in parts),
                    "ok": all(p["ok"] for p in parts)}
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", fused_value_grad_batched_f32=cases)
                raise AssertionError(
                    f"fused_value_grad_batched_f32 disagrees with its plain version: {case} {parts}"
                )
    return cases, worst


def _check_value_grad_invariance(gen, dev) -> list:
    """fused_value_grad_batched_f32 gives an entity the same bits alone (a
    batch of 1, X a view that may start off a 16-byte boundary), at another
    position (the batch rolled by 5), in a batch of 7 and in the whole
    batch of E."""
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import pallas_kernels

    def run(inputs):
        return pallas_kernels.fused_value_grad_batched_f32(*inputs, LogisticLoss)

    cases = []
    for E, s, d in VALUE_GRAD_INVARIANCE_SHAPES:
        inputs = _value_grad_inputs(E, s, d, gen, dev)
        full = run(inputs)
        rolled = run(tuple(t.roll(5, 0).contiguous() for t in inputs))
        ok = all(torch.equal(a.roll(5, 0), b) for a, b in zip(full, rolled))
        for e in sorted({0, E // 2 + 1, E - 1}):
            alone = run(tuple(t[e:e + 1] for t in inputs))
            idx = torch.tensor([(e + i) % E for i in range(-3, 4)], device=dev)
            seven = run(tuple(t[idx].contiguous() for t in inputs))
            ok = (ok and all(torch.equal(a[e:e + 1], b) for a, b in zip(full, alone))
                  and all(torch.equal(a[e], b[3]) for a, b in zip(full, seven)))
        plan = pallas_kernels.entity_tiling(E, s, d)
        cases.append({"E": E, "s": s, "d": d, "mode": plan.mode, "bitwise_invariant": ok})
        if not ok:
            raise AssertionError(f"an entity's outputs depend on its batch: {cases}")
    return cases


def _shuffle_indices(kind: str, m: int, hi: int, gen, dev) -> torch.Tensor:
    """[m, 128] int8 indices in [0, hi): the identity, reversed, or random
    (hi = R for a sublane shuffle: positions within each group of R rows)."""
    if kind == "random":
        idx = torch.randint(0, hi, (m, 128), generator=gen, device=dev)
    else:
        pos = torch.arange(128, device=dev).expand(m, 128) if hi == 128 else (
            torch.arange(m, device=dev).remainder(hi).unsqueeze(1).expand(m, 128))
        idx = pos if kind == "identity" else hi - 1 - pos
    return idx.to(torch.int8).contiguous()


def shuffle_times(v: torch.Tensor, idx: torch.Tensor, rows: int) -> dict:
    """Kernel, plain version and library (one torch.gather on int64 indices
    made beforehand) ms of one lane (rows 0) or sublane shuffle, and its
    bound; the kernel's output checked bitwise against the plain version's
    on these inputs."""
    from photon_ml_tpu_torch.ops import permute_net

    m = v.shape[0]
    idx64 = idx.long()
    if rows == 0:
        kernel = lambda: permute_net.lane_shuffle_f32(v, idx)  # noqa: E731
        plain = lambda: permute_net.lane_shuffle_plain(v, idx)  # noqa: E731
        library = lambda: torch.gather(v, 1, idx64)  # noqa: E731
    else:
        v3, i3 = v.view(m // rows, rows, 128), idx64.view(m // rows, rows, 128)
        kernel = lambda: permute_net.sublane_shuffle_f32(v, idx, rows)  # noqa: E731
        plain = lambda: permute_net.sublane_shuffle_plain(v, idx, rows)  # noqa: E731
        library = lambda: torch.gather(v3, 1, i3)  # noqa: E731
    equal = torch.equal(kernel(), plain())
    ms = cuda_ms({"kernel": kernel, "plain": plain, "library": library})
    bound_ms, bound_by = shuffle_bound_ms(m)
    return {"m": m, "rows": rows, "bitwise_equal": equal, **kernel_times(ms),
            "bound_ms": bound_ms, "bound_by": bound_by}


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn``: n calls enqueued back to back on
    the host clock, the card running behind them, over n."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def launch_host_us(v: torch.Tensor, idx: torch.Tensor) -> dict:
    """Host us a launch of lane_shuffle_f32 on v, idx: through its wrapper,
    and as a bare ctypes call with its pointers and stream prepared once."""
    from photon_ml_tpu_torch.ops import permute_net

    lib = permute_net._library()
    out = torch.empty_like(v)
    args = (v.data_ptr(), idx.data_ptr(), out.data_ptr(), v.shape[0],
            torch.cuda.current_stream().cuda_stream)
    return {"m": v.shape[0], "wrapper_us": host_us(lambda: permute_net.lane_shuffle_f32(v, idx)),
            "bare_ctypes_us": host_us(lambda: lib.lane_shuffle_f32(*args))}


def _check_shuffle_kernel(rows_set, gen, dev) -> tuple:
    """One shuffle kernel (lane: rows_set (0,); sublane: (2, 4, 8)) against
    its plain version, bitwise, with identity, reversed and random indices;
    then its times at 2^15 and 2^17 rows."""
    from photon_ml_tpu_torch.ops import permute_net

    cases = []
    for rows in rows_set:
        sizes = (1, 31, 32, 4097, 1 << 17) if rows == 0 else (
            rows, 31 * rows, 32 * rows, 4097 * rows, 1 << 17)
        hi = 128 if rows == 0 else rows
        for m in sizes:
            v = torch.randn(m, 128, generator=gen, device=dev)
            for kind in ("identity", "reversed", "random"):
                idx = _shuffle_indices(kind, m, hi, gen, dev)
                if rows == 0:
                    out = permute_net.lane_shuffle_f32(v, idx)
                    plain = permute_net.lane_shuffle_plain(v, idx)
                else:
                    out = permute_net.sublane_shuffle_f32(v, idx, rows)
                    plain = permute_net.sublane_shuffle_plain(v, idx, rows)
                torch.cuda.synchronize()
                case = {"m": m, "rows": rows, "indices": kind,
                        "ok": torch.equal(out, plain)}
                cases.append(case)
                if not case["ok"]:
                    raise AssertionError(f"shuffle kernel differs from its plain version: {case}")
    result = {"cases": cases}
    for log_m in (15, 17):
        m = 1 << log_m
        v = torch.randn(m, 128, generator=gen, device=dev)
        times = [shuffle_times(v, _shuffle_indices("random", m, 128 if r == 0 else r, gen, dev),
                               r) for r in rows_set]
        if not all(t["bitwise_equal"] for t in times):
            raise AssertionError(f"shuffle kernel differs from its plain version: {times}")
        result[f"times_at_2^{log_m}_rows"] = times
        if rows_set == (0,):
            result[f"host_us_at_2^{log_m}_rows"] = launch_host_us(
                v, _shuffle_indices("random", m, 128, gen, dev))
    return result, 0.0


def _random_stage(m: int, hi: int, gen, dev, present: bool = True):
    return torch.randint(0, hi, (m, 128), generator=gen, device=dev).to(torch.int8) \
        if present else None


def _check_relayout_kernel(gen, dev) -> tuple:
    """lane_relayout_f32 against its plain version, bitwise: Enter and
    Leave at odd tile counts (1, 6, 15 tiles) and at the outer level of a
    2^22-slot plan, with both lane stages, the first alone, the second
    alone."""
    from photon_ml_tpu_torch.ops import permute_net

    cases = []
    for relayout in (("enter", 1, 128), ("leave", 3, 256), ("enter", 5, 384),
                     ("leave", 1, 1 << 15), ("enter", 1, 1 << 15)):
        m = relayout[1] * relayout[2]
        v = torch.randn(m, 128, generator=gen, device=dev)
        for first, second in ((True, True), (True, False), (False, True)):
            a = _random_stage(m, 128, gen, dev, first)
            b = _random_stage(m, 128, gen, dev, second)
            out = permute_net.lane_relayout_f32(v, a, b, relayout)
            torch.cuda.synchronize()
            case = {"relayout": list(relayout), "first": first, "second": second,
                    "ok": torch.equal(out, permute_net.lane_relayout_plain(v, a, b, relayout))}
            cases.append(case)
            if not case["ok"]:
                raise AssertionError(f"lane_relayout_f32 differs from its plain version: {case}")
    return {"cases": cases}, 0.0


def _check_inner_kernel(gen, dev) -> tuple:
    """inner_shuffle_f32 against its plain version, bitwise: c in {1, 2, 4,
    8} inside Enter/Leave of 1, 3 and 128 blocks and on 31 groups of whole
    rows; all three stages, the sublane stage alone, the lane stages
    alone."""
    from photon_ml_tpu_torch.ops import permute_net

    cases = []
    for rows in (1, 2, 4, 8):
        for blocks in (0, 1, 3, 128):
            m = blocks * rows * 128 if blocks else 31 * rows
            v = torch.randn(m, 128, generator=gen, device=dev)
            for which in ("all", "sublane", "lanes"):
                if rows == 1 and which == "sublane":
                    continue
                a = _random_stage(m, 128, gen, dev, which != "sublane")
                sub = _random_stage(m, rows, gen, dev, rows > 1 and which != "lanes")
                b = _random_stage(m, 128, gen, dev, which != "sublane")
                out = permute_net.inner_shuffle_f32(v, a, sub, b, rows, blocks)
                torch.cuda.synchronize()
                case = {"rows": rows, "blocks": blocks, "stages": which,
                        "ok": torch.equal(out, permute_net.inner_shuffle_plain(
                            v, a, sub, b, rows, blocks))}
                cases.append(case)
                if not case["ok"]:
                    raise AssertionError(f"inner_shuffle_f32 differs from its plain version: "
                                         f"{case}")
    return {"cases": cases}, 0.0


def structured_plan(size: int, seed: int):
    """A plan with routing's stage structure for ``size`` slots (c 128^(m+1))
    and seeded random stage indices: the shapes and access pattern the
    kernels see in a routed plan, without the host routing of a real
    permutation (tens of seconds at 2^24 slots)."""
    from photon_ml_tpu_torch.ops import routing

    rng = np.random.default_rng(seed)
    stages = []

    def level(blocks: int, rows: int) -> None:
        m = blocks * rows
        stages.append(routing.LaneShuffle(rng.integers(0, 128, (m, 128), dtype=np.int32)))
        if rows <= routing.MAX_SUBLANES:
            stages.append(routing.SublaneShuffle(
                rng.integers(0, rows, (m, 128), dtype=np.int32), rows))
        else:
            stages.append(routing.Enter(blocks, rows))
            level(blocks * 128, rows // 128)
            stages.append(routing.Leave(blocks, rows))
        stages.append(routing.LaneShuffle(rng.integers(0, 128, (m, 128), dtype=np.int32)))

    level(1, size // 128)
    return routing.PermPlan(size=size, stages=stages)


def composed_index(fn, m: int) -> torch.Tensor:
    """int64 [m 128]: the source slot of each output slot of the movement
    ``fn`` (f32 [m, 128] -> [m, 128]); slot numbers up to 2^24 are exact
    in f32."""
    if m * 128 > 1 << 24:
        raise ValueError(f"{m * 128} slots: f32 slot numbers are exact to 2^24")
    pos = torch.arange(m * 128, device="cuda", dtype=torch.float32).reshape(m, 128)
    return fn(pos).reshape(-1).long()


def group_stages(g) -> int:
    return sum(t is not None for t in (g.a, g.s, g.b))


def group_times(g, v: torch.Tensor) -> dict:
    """Kernel, plain version and library (one torch.gather of the slots by
    the group's composed int64 index, made beforehand) ms of one compiled
    group of a plan on v, and its bound; the kernel's output checked
    bitwise against the plain version's."""
    from photon_ml_tpu_torch.ops import permute_net

    m = v.shape[0]
    if g.kernel == "lane_relayout_f32":
        kernel = lambda: permute_net.lane_relayout_f32(v, g.a, g.b, g.relayout)  # noqa: E731
        plain = lambda: permute_net.lane_relayout_plain(v, g.a, g.b, g.relayout)  # noqa: E731
    elif g.kernel == "inner_shuffle_f32":
        blocks = g.relayout[1] if g.relayout else 0
        kernel = lambda: permute_net.inner_shuffle_f32(  # noqa: E731
            v, g.a, g.s, g.b, g.rows, blocks)
        plain = lambda: permute_net.inner_shuffle_plain(  # noqa: E731
            v, g.a, g.s, g.b, g.rows, blocks)
    else:
        kernel = lambda: permute_net.lane_shuffle_f32(v, g.a)  # noqa: E731
        plain = lambda: permute_net.lane_shuffle_plain(v, g.a)  # noqa: E731
    index = composed_index(lambda p: permute_net._group_plain(g, p), m)
    flat = v.reshape(-1)
    library = lambda: torch.gather(flat, 0, index)  # noqa: E731
    equal = torch.equal(kernel(), plain()) and torch.equal(kernel().reshape(-1), library())
    ms = cuda_ms({"kernel": kernel, "plain": plain, "library": library})
    bound_ms, bound_by = shuffle_bound_ms(m, group_stages(g))
    return {"m": m, "relayout": g.relayout, "rows": g.rows, "stages": group_stages(g),
            "bitwise_equal": equal, **kernel_times(ms), "bound_ms": bound_ms,
            "bound_by": bound_by}


def plan_times(dplan, gen) -> dict:
    """One whole plan on the card: its launches, apply_plan bitwise against
    the stage-by-stage plain plan, and the ms of apply_plan (kernel), the
    grouped plain plan (plain) and one torch.gather of the slots by the
    plan's composed int64 index (library), its bound (each group's pass),
    and the host us a call of apply_plan."""
    from photon_ml_tpu_torch.ops import launches, permute_net

    m = dplan.size // 128
    x = torch.randn(dplan.size, generator=gen, device="cuda")
    launches.reset()
    out = permute_net.apply_plan(dplan, x)
    torch.cuda.synchronize()
    counts = {k: n for k, n in launches.counts().items() if n}
    index = composed_index(lambda p: permute_net.plan_plain(dplan, p), m)
    library = lambda: torch.gather(x, 0, index)  # noqa: E731
    equal = (torch.equal(out, permute_net.plan_stages_plain(dplan, x.reshape(m, 128)).reshape(-1))
             and torch.equal(out, library()))
    ms = cuda_ms({"kernel": lambda: permute_net.apply_plan(dplan, x),
                  "plain": lambda: permute_net.plan_plain(dplan, x.reshape(m, 128)),
                  "library": library})
    bound_ms, bound_by = _bound(sum((8 + group_stages(g)) * 128 * m for g in dplan.groups), 0)
    # the stage-by-stage plan: 9 B a slot a shuffle (a sublane stage of
    # single rows moves nothing), 8 B a relayout copy
    stage_bytes = 128 * m * sum(8 if k[0] in ("enter", "leave") else
                                9 if k[0] == "lane" or k[1] > 1 else 0 for k in dplan.kinds)
    return {"size": dplan.size, "groups": [[g.kernel, g.relayout, g.rows] for g in dplan.groups],
            "launches": counts, "bitwise_equal_to_stage_by_stage": equal, **kernel_times(ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "stage_by_stage_bound_ms": _bound(stage_bytes, 0)[0],
            "host_us": host_us(lambda: permute_net.apply_plan(dplan, x), n=100)}


def _check_plans(gen, dev, seed: int) -> dict:
    """Plans of routing's structure at 2^22 slots (the Benes grid's tiles)
    and 2^24 (train_benes_full_width's networks), seeded random indices:
    three launches each, bitwise the stage-by-stage plain plan, each group
    timed at its shape, the whole plan against one gather."""
    from photon_ml_tpu_torch.ops import permute_net

    out = {}
    for log_size in (22, 24):
        dplan = permute_net.device_plan(structured_plan(1 << log_size, seed + log_size), dev)
        v = torch.randn(dplan.size // 128, 128, generator=gen, device=dev)
        entry = {"plan": plan_times(dplan, gen),
                 "groups": [group_times(g, v) for g in dplan.groups]}
        bad = [g for g in entry["groups"] if not g["bitwise_equal"]]
        if (bad or not entry["plan"]["bitwise_equal_to_stage_by_stage"]
                or sum(entry["plan"]["launches"].values()) != 3):
            raise AssertionError(f"the plan of 2^{log_size} slots: {entry}")
        out[f"2^{log_size}"] = entry
        del dplan, v
        torch.cuda.empty_cache()
    return out


def _check_csr_bf16_kernel(gen, dev) -> tuple:
    """csr_matvec_bf16 at the full-width shape (2^20 rows, 2^24 dims) and a
    ragged small one, every 7th entry exact (its column stored as ~col, as
    the bf16 engine stores its exact set), against the plain version and the
    float64 sum of vals * bf16(w) (vals * w for the exact entries), and for
    bitwise repeats; the kernel, the plain version and torch.mv timed at the
    full-width shape."""
    from photon_ml_tpu_torch.ops import fused_perm

    cases, worst, times = [], 0.0, None
    for n, dim in ((1 << 20, 1 << 24), (31, 1000)):
        w = torch.randn(dim, generator=gen, device=dev)
        row_ptr, col_real, vals = _random_csr(n, dim, gen, dev)
        exact = torch.arange(col_real.numel(), device=dev) % 7 == 3
        col_idx = torch.where(exact, ~col_real, col_real)
        z = fused_perm.csr_matvec_bf16(row_ptr, col_idx, vals, w, dim)
        torch.cuda.synchronize()
        z_plain = fused_perm.csr_matvec_bf16_plain(row_ptr, col_idx, vals, w)
        rows = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr.diff())
        w_terms = torch.where(exact, w[col_real.long()],
                              w.to(torch.bfloat16).float()[col_real.long()])
        prod = vals.double() * w_terms.double()
        z64 = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, prod)
        row_abs = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, prod.abs())
        case = _compare(z, z_plain, z64, row_abs, row_ptr.diff(), (n,), n=n, dim=dim,
                        nnz=int(row_ptr[-1]), exact_entries=int(exact.sum()))
        repeat = fused_perm.csr_matvec_bf16(row_ptr, col_idx, vals, w, dim)
        case["bitwise_repeatable"] = bool(torch.equal(z, repeat))
        case["ok"] = case["ok"] and case["bitwise_repeatable"]
        cases.append(case)
        worst = max(worst, case["max_abs_err_plain"])
        if not case["ok"]:
            emit("kernel", csr_matvec_bf16=cases)
            raise AssertionError(f"csr_matvec_bf16 disagrees with its plain version: {case}")
        if times is None:
            csr = torch.sparse_csr_tensor(row_ptr, col_real.long(), vals, size=(n, dim))
            fns = {"kernel": lambda: fused_perm.csr_matvec_bf16(row_ptr, col_idx, vals, w, dim)}
            fns["plain"] = lambda: fused_perm.csr_matvec_bf16_plain(row_ptr, col_idx, vals, w)
            fns["library"] = lambda: torch.mv(csr, w)
            bound_ms, bound_by = csr_bound_ms(n, int(row_ptr[-1]), dim)
            times = {"n": n, "dim": dim, **kernel_times(cuda_ms(fns)), "bound_ms": bound_ms,
                     "bound_by": bound_by}
    return {"cases": cases, "times_at_full_width": times}, worst


def _check_csc_bf16_kernel(gen, dev) -> tuple:
    """csc_rmatvec_bf16 with the four transforms at the full-width shape and
    a ragged small one, against the plain version and the float64 sum of
    bf16(t(vals) * c) (the f32 product rounded), and for bitwise repeats."""
    from photon_ml_tpu_torch.ops import fused_perm

    transforms = {
        "id": lambda v: v, "sq": lambda v: v * v, "abs": lambda v: v.abs(),
        "nnz": lambda v: (v != 0).to(v.dtype),
    }
    cases, worst = [], 0.0
    for n, dim in ((1 << 20, 1 << 24), (31, 1000)):
        col_ptr, row_idx, vals = _random_csc(n, dim, gen, dev)
        c = torch.randn(n, generator=gen, device=dev)
        split = fused_perm.merge_path_split(col_ptr, row_idx.numel())
        cols = torch.repeat_interleave(torch.arange(dim, device=dev), col_ptr.diff())
        for name, t in transforms.items():
            g = fused_perm.csc_rmatvec_bf16(col_ptr, row_idx, vals, c, n, name, split)
            torch.cuda.synchronize()
            g_plain = fused_perm.csc_rmatvec_bf16_plain(col_ptr, row_idx, vals, c, name)
            terms = (t(vals) * c[row_idx.long()]).to(torch.bfloat16).double()
            g64 = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(0, cols, terms)
            col_abs = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(
                0, cols, terms.abs())
            case = _compare(g, g_plain, g64, col_abs, col_ptr.diff(), (dim,), n=n, dim=dim,
                            nnz=int(col_ptr[-1]), transform=name)
            repeat = fused_perm.csc_rmatvec_bf16(col_ptr, row_idx, vals, c, n, name, split)
            case["bitwise_repeatable"] = bool(torch.equal(g, repeat))
            case["ok"] = case["ok"] and case["bitwise_repeatable"]
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", csc_rmatvec_bf16=cases)
                raise AssertionError(f"csc_rmatvec_bf16 disagrees with its plain version: {case}")
    return cases, worst


# [2^20, 256] (timed), ragged last tiles with d % 4 != 0, d = 1, rows of
# more than 256 columns and of more than 2048 (the column-split kernel)
BLOCKED_SHAPES = ((1 << 20, 256), (700, 37), (1000, 130), (65_537, 129), (4097, 1),
                  (3001, 300), (1001, 2500))
# a shape run again with X a view 4 bytes past a 16-byte boundary
BLOCKED_UNALIGNED = (1000, 128)


def _check_blocked_value_grad_kernel(gen, dev) -> tuple:
    """fused_value_grad_f32 with the four losses at BLOCKED_SHAPES against
    its plain version and float64, and for bitwise repeats; kernel, plain,
    library (torch.mv, the elementwise loss, torch.mv on X^T) and bound
    times at [2^20, 256]."""
    from photon_ml_tpu_torch.losses.pointwise import (
        LogisticLoss, PoissonLoss, SmoothedHingeLoss, SquaredLoss,
    )
    from photon_ml_tpu_torch.ops import pallas_kernels

    cases, worst, times = [], 0.0, None
    for (n, d), unaligned in [(shape, False) for shape in BLOCKED_SHAPES] + [
            (BLOCKED_UNALIGNED, True)]:
        inputs = tuple(t[0] for t in _value_grad_inputs(1, n, d, gen, dev))
        if unaligned:
            X = torch.empty(n * d + 1, device=dev)[1:].view(n, d)
            X.copy_(inputs[0])
            inputs = (X,) + inputs[1:]
        for kind in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
            out = pallas_kernels.fused_value_grad_f32(*inputs, kind)
            torch.cuda.synchronize()
            plain = pallas_kernels.fused_value_grad_plain(*inputs, kind)
            ref, scale = _value_grad_f64(*inputs, kind)
            parts = [
                _compare(o, p, r, a, n, o.shape, part=name)
                for name, o, p, r, a in zip(("value", "grad", "csum"), out, plain, ref, scale)
            ]
            again = pallas_kernels.fused_value_grad_f32(*inputs, kind)
            case = {"n": n, "d": d, "loss": kind.__name__, "x_16_byte_aligned": not unaligned,
                    "max_abs_err_plain": max(p["max_abs_err_plain"] for p in parts),
                    "max_abs_err_f64": max(p["max_abs_err_f64"] for p in parts),
                    "bitwise_repeatable": all(torch.equal(a, b) for a, b in zip(out, again)),
                    "ok": all(p["ok"] for p in parts)}
            case["ok"] = case["ok"] and case["bitwise_repeatable"]
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", fused_value_grad_f32=cases)
                raise AssertionError(
                    f"fused_value_grad_f32 disagrees with its plain version: {case} {parts}")
        if times is None:
            X, y, off, wt, w = inputs

            def library():
                z = torch.mv(X, w) + off
                pos = wt > 0
                lw = torch.where(pos, wt * LogisticLoss.value(z, y), 0.0)
                dz = torch.where(pos, wt * LogisticLoss.d1(z, y), 0.0)
                return lw.sum(), torch.mv(X.T, dz), dz.sum()

            ms = cuda_ms({
                "kernel": lambda: pallas_kernels.fused_value_grad_f32(*inputs, LogisticLoss),
                "plain": lambda: pallas_kernels.fused_value_grad_plain(*inputs, LogisticLoss),
                "library": library,
            })
            bound_ms, bound_by = value_grad_bound_ms(1, n, d)
            times = {"shape": [n, d], **kernel_times(ms), "bound_ms": bound_ms,
                     "bound_by": bound_by}
        del inputs
        torch.cuda.empty_cache()
    return {"cases": cases, "times": times}, worst


LONE_DENSE_SHAPES = ((64, 16), (256, 64), (1024, 64), (1024, 128), (2048, 128), (4096, 244),
                     (8192, 244))


def _time_lone_dense_route(gen, dev) -> list:
    """The objective's value_and_grad on one dense [s, d] problem (labels,
    offsets, weights as the kernel checks make them) three ways: as
    fused_value_grad_auto routes it ("objective": the single-block kernel
    up to LONE_PROBLEM_MAX_ELEMENTS, else the maps), through the
    single-block kernel as a batch of one at every size ("single_block"),
    and through the plain maps ("plain_maps": torch.mv, the elementwise
    loss, torch.mv on X^T); and fused_value_grad_f32 on the same inputs.
    Values and gradients agree to rtol 2e-4."""
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import launches, pallas_kernels
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.ops.features import DenseFeatures

    objective = make_glm_objective(LogisticLoss)
    auto = pallas_kernels.fused_value_grad_auto

    def single_block(X, y, off, wt, w, kind):
        v, g, c = pallas_kernels.fused_value_grad_batched_f32(
            X[None], y[None], off[None], wt[None], w[None], kind)
        return v[0], g[0], c[0]

    out = []
    for s, d in LONE_DENSE_SHAPES:
        X, y, off, wt, w = (t[0] for t in _value_grad_inputs(1, s, d, gen, dev))
        off = torch.where(wt > 0, off, torch.zeros_like(off))  # finite margins
        data = LabeledData.create(DenseFeatures(X), y, offsets=off, weights=wt)
        before = launches.counts()
        routed = objective.value_and_grad(w, data, 1.0)
        took = {k: v - before[k] for k, v in launches.counts().items() if v > before[k]}
        want = {KERNELS[2]: 1} if s * d <= pallas_kernels.LONE_PROBLEM_MAX_ELEMENTS else {}
        results = {"objective": routed}
        ms = cuda_ms({"objective": lambda: objective.value_and_grad(w, data, 1.0)}, reps=10)
        for name, route in (("single_block", single_block), ("plain_maps", lambda *a: None)):
            pallas_kernels.fused_value_grad_auto = route
            try:
                results[name] = objective.value_and_grad(w, data, 1.0)
                ms.update(cuda_ms({name: lambda: objective.value_and_grad(w, data, 1.0)},
                                  reps=10))
            finally:
                pallas_kernels.fused_value_grad_auto = auto
        ms.update(cuda_ms({"blocked_f32": lambda: pallas_kernels.fused_value_grad_f32(
            X, y, off, wt, w, LogisticLoss)}, reps=10))
        maps = results["plain_maps"]
        agree = all(
            bool(torch.allclose(a, b, rtol=2e-4, atol=2e-5 * float(b.abs().max())))
            for r in results.values() for a, b in zip(r, maps))
        case = {"s": s, "d": d, "elements": s * d, "objective_launches": took, **ms,
                "agree": agree}
        out.append(case)
        if not agree or took != want:
            raise AssertionError(f"the lone dense problem's route is wrong: {case}")
    return out


def phase_kernel(seed: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results, worst = {}, {}
    for name, check in (
        ("csr_matvec_f32", _check_csr_kernel),
        ("csc_rmatvec_f32", _check_csc_kernel),
        ("fused_value_grad_batched_f32", _check_value_grad_kernel),
        ("lane_shuffle_f32", lambda g, d: _check_shuffle_kernel((0,), g, d)),
        ("sublane_shuffle_f32", lambda g, d: _check_shuffle_kernel((2, 4, 8), g, d)),
        ("lane_relayout_f32", _check_relayout_kernel),
        ("inner_shuffle_f32", _check_inner_kernel),
        ("csr_matvec_bf16", _check_csr_bf16_kernel),
        ("csc_rmatvec_bf16", _check_csc_bf16_kernel),
        (BLOCKED, _check_blocked_value_grad_kernel),
    ):
        results[name], worst[name] = check(gen, dev)
        torch.cuda.empty_cache()
    results["fused_value_grad_batched_f32_invariance"] = _check_value_grad_invariance(gen, dev)
    results["lone_dense_route"] = _time_lone_dense_route(gen, dev)
    results["plans"] = _check_plans(gen, dev, seed)
    emit("kernel", tolerance="vs float64: atol = 1e-5 * max(1, sum of |terms|); vs plain: "
         "that + terms * 2^-24 * max(1, sum of |terms|), elementwise; shuffles: bitwise; "
         "bf16 kernels: the float64 sum of the same rounded terms",
         **results)
    return {"max_abs_err": worst, "blocked_times": results[BLOCKED]["times"]}


def _distinct_cols(rng, rows: int, k: int, dim: int) -> np.ndarray:
    """[rows, k] columns in [0, dim), distinct within each row: a random
    start and a random stride below dim / k."""
    start = rng.integers(0, dim, rows)
    stride = rng.integers(1, dim // k, rows)
    return (start[:, None] + stride[:, None] * np.arange(k)) % dim


def make_glmix(seed: int, n: int, fe_dim: int, fe_k: int, n_users: int, n_items: int,
               re_dim: int = 4096, re_local: int = 16, re_k: int = 8,
               unseen: float = 0.03):
    """A GLMix dataset (host numpy COO) and the coordinates of a random model
    for it (``convert.game_model_from_numpy`` input), made from ``seed``."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    rng = np.random.default_rng(seed)
    fe_rows = np.repeat(np.arange(n, dtype=np.int64), fe_k)
    fe_cols = np.sort(rng.integers(0, fe_dim, (n, fe_k)), axis=1).reshape(-1)
    fe_vals = rng.standard_normal(n * fe_k, dtype=np.float32)
    shards = {"global": FeatureShard(fe_rows, fe_cols, fe_vals, fe_dim)}
    id_tags = {}
    coords = {
        "fixed": {
            "feature_shard": "global",
            "means": (rng.standard_normal(fe_dim, dtype=np.float32) * 0.1),
        }
    }
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        # each entity's projected space: re_local distinct sorted features
        pidx = np.sort(_distinct_cols(rng, count, re_local, re_dim), axis=1)
        valid = np.ones((count, re_local), dtype=bool)
        valid[rng.random(count) < 0.25, re_local - 2:] = False  # shorter spaces
        pidx = np.where(valid, pidx, re_dim)
        ent = rng.integers(0, count, n)
        is_unseen = rng.random(n) < unseen
        ids = np.where(
            is_unseen,
            np.char.add(f"unseen_{prefix}", ent.astype(str)),
            np.char.add(prefix, ent.astype(str)),
        )
        # re_k nonzeros a row: most inside the entity's space, some outside
        picks = pidx[ent[:, None], rng.integers(0, re_local - 2, (n, re_k))]
        outside = rng.random((n, re_k)) < 0.25
        cols = np.where(outside, rng.integers(0, re_dim, (n, re_k)), picks)
        shards[shard] = FeatureShard(
            np.repeat(np.arange(n, dtype=np.int64), re_k),
            cols.reshape(-1).astype(np.int64),
            rng.standard_normal(n * re_k, dtype=np.float32),
            re_dim,
        )
        id_tags[re_type] = ids
        entity_ids = [f"{prefix}{e}" for e in range(count)]
        coords[f"per_{re_type}"] = {
            "feature_shard": shard,
            "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, re_local), dtype=np.float32) * 0.3],
            "proj_indices": [pidx],
            "proj_valid": [valid],
            "entity_ids": [entity_ids],
            "entity_to_loc": {eid: (0, e) for e, eid in enumerate(entity_ids)},
            "global_dim": re_dim,
        }
    labels = (rng.random(n) < 0.5).astype(np.float32)
    return GameData(labels=labels, feature_shards=shards, id_tags=id_tags), coords


def phase_score_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.ops import fused_perm, launches
    from photon_ml_tpu_torch.types import TaskType

    n, fe_dim, fe_k = 1 << 20, 1 << 24, 16
    t0 = time.perf_counter()
    data, coords = make_glmix(seed, n, fe_dim, fe_k, n_users=65_536, n_items=16_384)
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cuda")
    setup_s = time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    t0 = time.perf_counter()
    z = model.score(data)
    torch.cuda.synchronize()
    first_score_s = time.perf_counter() - t0
    counts = launches.counts()
    if counts["csr_matvec_f32"] < 1:
        raise AssertionError(f"score did not launch csr_matvec_f32: {counts}")
    feats = data.sparse_features("global", engine="auto", device="cuda")
    if not isinstance(feats, fused_perm.FusedSparseFeatures):
        raise AssertionError(f"auto engine picked {type(feats).__name__}, not fused")

    # the same scoring through the plain versions, on the card
    means = model.models["fixed"].coefficients.means
    row_ptr, col_idx, vals = row_major_csr(feats)
    z_plain = fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, means)
    for cid in model.models:
        if cid != "fixed":
            z_plain = z_plain + model.score_coordinate(cid, data)
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), row_ptr.diff())
    row_abs = torch.zeros(n, device="cuda").index_add_(
        0, rows, (vals * means[col_idx.long()]).abs()
    )
    tol = 1e-5 * torch.clamp(row_abs, min=1.0)
    diff = (z - z_plain).abs()
    if z.shape != (n,) or not bool(torch.isfinite(z).all()) or not bool((diff <= tol).all()):
        raise AssertionError(f"full-width score disagrees: max |d| {float(diff.max())}")

    # times at the main path's shapes
    kernel = lambda: fused_perm.csr_matvec_f32(  # noqa: E731
        feats.row_ptr, feats.col_idx, feats.vals, means, fe_dim, feats.row_split,
        feats.row_blocks)
    plain = lambda: fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, means)  # noqa: E731
    csr = torch.sparse_csr_tensor(row_ptr, col_idx.long(), vals, size=(n, fe_dim),
                                  check_invariants=True)
    library = lambda: torch.mv(csr, means)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": plain, "library": library})
    lib_diff = float((library() - kernel()).abs().max())
    score_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        z_again = model.score(data)
        torch.cuda.synchronize()
        score_times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(z, z_again):
        raise AssertionError("two full-width score calls differ")
    t0 = time.perf_counter()
    for cid, sub in model.models.items():
        if cid != "fixed":
            sub.entity_positions(data.id_tags[model.meta[cid].random_effect_type])
    re_lookup_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = csr_bound_ms(n, feats.nnz, fe_dim)
    result = {
        "n": n, "fe_dim": fe_dim, "fe_nnz": feats.nnz,
        "setup_s": setup_s, "first_score_s": first_score_s,
        "launches": counts["csr_matvec_f32"],
        "max_abs_err_vs_plain_path": float(diff.max()),
        **kernel_times(ms), "library_max_abs_diff": lib_diff,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "score_ms_median_of_5": statistics.median(score_times),
        "re_entity_lookup_ms": re_lookup_ms,
        "score_profile": profile_device_idle(lambda: model.score(data)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("score_full_width", **result)
    return result


def write_cli_fixture(root: str, seed: int, n: int = 65_536, fe_dim: int = 1 << 16,
                      fe_k: int = 16, n_users: int = 4096, n_items: int = 1024,
                      re_dim: int = 256, re_k: int = 4, model_seed=None) -> None:
    """An Avro dataset and an Avro GAME model, written by the port's own
    writers, under ``root``/data and ``root``/model; ``model_seed`` draws the
    fixed effect's coefficients from a generator of its own (two datasets,
    one model)."""
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, DefaultIndexMap, feature_key
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.model_io import save_game_model
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(seed)
    fe_cols = _distinct_cols(rng, n, fe_k, fe_dim)
    fe_vals = rng.standard_normal((n, fe_k))
    w_rng = rng if model_seed is None else np.random.default_rng(model_seed)
    w_fe = w_rng.standard_normal(fe_dim + 1).astype(np.float32) * 0.2  # + intercept
    margin = (fe_vals * w_fe[fe_cols]).sum(axis=1) + w_fe[fe_dim]
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    unseen_u = rng.random(n) < 0.03
    unseen_i = rng.random(n) < 0.03
    u_cols = rng.integers(0, re_dim, (n, re_k))
    i_cols = rng.integers(0, re_dim, (n, re_k))
    records = (
        {
            "uid": f"r{r}",
            "label": float(labels[r]),
            "features": [("f", str(c), float(v)) for c, v in zip(fe_cols[r], fe_vals[r])],
            "userFeatures": [("u", str(c), 1.0) for c in u_cols[r]],
            "itemFeatures": [("i", str(c), 1.0) for c in i_cols[r]],
            "metadataMap": {
                "userId": f"{'new' if unseen_u[r] else 'u'}{users[r]}",
                "itemId": f"{'new' if unseen_i[r] else 'i'}{items[r]}",
            },
        }
        for r in range(n)
    )
    os.makedirs(os.path.join(root, "data"))
    write_training_examples(os.path.join(root, "data", "part-00000.avro"), records)

    fe_names = {feature_key("f", str(c)): c for c in range(fe_dim)}
    fe_names[INTERCEPT_KEY] = fe_dim
    index_maps = {"global": DefaultIndexMap(fe_names)}
    coords = {"fixed": {"feature_shard": "global", "means": w_fe}}
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        index_maps[shard] = DefaultIndexMap(
            {feature_key(prefix, str(c)): c for c in range(re_dim)}
        )
        pidx = np.sort(_distinct_cols(rng, count, 16, re_dim), axis=1)
        ids = [f"{prefix}{e}" for e in range(count)]
        coords[f"per_{re_type}"] = {
            "feature_shard": shard,
            "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, 16)).astype(np.float32) * 0.3],
            "proj_indices": [pidx],
            "proj_valid": [np.ones((count, 16), dtype=bool)],
            "entity_ids": [ids],
            "entity_to_loc": {eid: (0, e) for e, eid in enumerate(ids)},
            "global_dim": re_dim,
        }
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cpu")
    save_game_model(
        model, os.path.join(root, "model"), index_maps=index_maps,
        configurations={"feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_item": {"feature_bags": ["itemFeatures"], "add_intercept": False},
        }},
    )


class ScoringEvents:
    """An event listener for score_game --event-listeners (registered by its
    dotted path, ``chip_smoke.ScoringEvents``): the names of the events it
    received, and whether it was closed."""

    seen: list = []
    closed = False

    def __init__(self):
        ScoringEvents.seen = []
        ScoringEvents.closed = False

    def on_event(self, event):
        ScoringEvents.seen.append(type(event).__name__)

    def close(self):
        ScoringEvents.closed = True


def _python_codec_read(fn, *args, **kwargs):
    """``fn`` (a data_reader function) with the native columnar path off:
    the record-at-a-time Python codec."""
    from photon_ml_tpu_torch.io import data_reader

    saved = data_reader._read_game_data_native, data_reader._build_index_maps_native
    data_reader._read_game_data_native = lambda *a: None
    data_reader._build_index_maps_native = lambda *a: None
    try:
        return fn(*args, **kwargs)
    finally:
        data_reader._read_game_data_native, data_reader._build_index_maps_native = saved


SCORE_CLI_ROWS = 65_536


def _cli_fixture_job(job) -> dict:
    """score_game_cli's fixture (write_cli_fixture), in a process of its own."""
    seed, out = job
    t0 = time.perf_counter()
    write_cli_fixture(out, seed, n=SCORE_CLI_ROWS)
    return {"fixture_s": time.perf_counter() - t0}


def phase_score_game_cli(seed: int) -> dict:
    import importlib

    from photon_ml_tpu_torch.cli import build_index, score_game
    from photon_ml_tpu_torch.io import data_reader
    from photon_ml_tpu_torch.io.avro import read_avro_dir
    from photon_ml_tpu_torch.io.model_io import load_game_model
    from photon_ml_tpu_torch.io.scores_io import load_scores
    from photon_ml_tpu_torch.ops import launches

    n = SCORE_CLI_ROWS
    # the dataset and model, written in the background from the end of build
    prep = _cli_fixture_prep(seed)
    info = prep.wait()
    fixture = prep.dir
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        result = {"rows": n, "fixture_s": info["fixture_s"],
                  "fixture_waited_s": info["prep_waited_s"]}
        t0 = time.perf_counter()
        build_index.main([
            "--data-dirs", os.path.join(fixture, "data"),
            "--output-dir", os.path.join(root, "idx"),
            "--feature-shard", "global=features", "--feature-shard", "per_user=userFeatures",
            "--feature-shard", "per_item=itemFeatures"])
        result["build_index_s"] = time.perf_counter() - t0
        log_file = os.path.join(root, "score.log")
        scores = {}
        for run, device, extra in (
                ("cuda", "cuda", ()), ("cpu", "cpu", ()),
                # the telemetry flags: scores bitwise the plain cuda run's
                ("cuda_telemetry", "cuda", (
                    "--telemetry-out", os.path.join(root, "score.jsonl"),
                    "--trace-out", os.path.join(root, "score_trace.json"))),
                ("cuda_offheap", "cuda", ("--offheap-indexmap-dir", os.path.join(root, "idx"))),
                ("cuda_flags", "cuda", (
                    "--model-id", "chip-smoke-model", "--log-data-and-model-stats",
                    "--log-file", log_file, "--event-listeners", "chip_smoke.ScoringEvents"))):
            out = os.path.join(root, f"scores_{run}")
            argv = [
                "--data-dirs", os.path.join(fixture, "data"),
                "--model-dir", os.path.join(fixture, "model"),
                "--output-dir", out, "--evaluator", "AUC", "--device", device, *extra,
            ]
            launches.reset()
            t0 = time.perf_counter()
            auc = score_game.run(score_game.parse_args(argv))
            result[f"{run}_s"] = time.perf_counter() - t0
            result[f"{run}_launches"] = launches.counts()["csr_matvec_f32"]
            result[f"{run}_auc"] = auc
            scores[run] = list(load_scores(out))
            result[f"{run}_records"] = len(scores[run])
        from photon_ml_tpu_torch.telemetry import validate_chrome_trace, validate_ledger

        ledger = validate_ledger(os.path.join(root, "score.jsonl"))
        validate_chrome_trace(os.path.join(root, "score_trace.json"))
        result["telemetry_ledger_records"] = len(ledger)
        result["telemetry_bitwise_plain"] = (scores["cuda_telemetry"] == scores["cuda"]
                                             and result["cuda_telemetry_auc"] == result["cuda_auc"])
        result["flags_bitwise_plain"] = (scores["cuda_flags"] == scores["cuda"]
                                         and result["cuda_flags_auc"] == result["cuda_auc"])
        model_ids = {r["modelId"] for r in read_avro_dir(os.path.join(root, "scores_cuda_flags"))}
        with open(log_file) as f:
            log_text = f.read()
        listener = importlib.import_module("chip_smoke").ScoringEvents
        result["flags_model_ids"] = sorted(model_ids)
        result["flags_stats_logged"] = (f"dataset stats: numSamples: {n}" in log_text
                                        and "model stats [fixed]" in log_text)
        result["flags_events"] = list(listener.seen) + (["closed"] if listener.closed else [])
        uids = [item.uid for item in scores["cuda"]]
        offheap = np.array([item.prediction_score for item in scores["cuda_offheap"]])
        plain = np.array([item.prediction_score for item in scores["cuda"]])
        result["offheap_uids_equal"] = [item.uid for item in scores["cuda_offheap"]] == uids
        result["offheap_bitwise"] = bool(np.array_equal(offheap, plain))
        result["offheap_max_abs_diff"] = float(np.abs(offheap - plain).max())

        # the fixture's read, natively and through the Python codec, in turns
        _, maps = load_game_model(os.path.join(fixture, "model"), device="cpu")
        configs = {sid: data_reader.FeatureShardConfiguration([bag], add_intercept=icpt)
                   for sid, bag, icpt in (("global", "features", True),
                                          ("per_user", "userFeatures", False),
                                          ("per_item", "itemFeatures", False))}
        read = functools.partial(data_reader.read_game_data, [os.path.join(fixture, "data")],
                                 configs, maps, id_tags=["userId", "itemId"])
        native_s, python_s = [], []
        for turn in ("native", "python", "native"):
            t0 = time.perf_counter()
            got = read() if turn == "native" else _python_codec_read(read)
            (native_s if turn == "native" else python_s).append(time.perf_counter() - t0)
            if got[0].num_rows != n:
                raise AssertionError(f"{turn} read {got[0].num_rows} rows, not {n}")
        result["read_native_s"] = native_s
        result["read_python_s"] = python_s
    for run in ("cuda", "cuda_offheap", "cuda_flags"):
        if result[f"{run}_launches"] < 1:
            raise AssertionError(f"score_game {run} did not launch csr_matvec_f32: {result}")
    for run in scores:
        if result[f"{run}_records"] != n:
            raise AssertionError(f"{run} scores file has {result[f'{run}_records']} records")
    if not np.isfinite(result["cuda_auc"]) or abs(result["cuda_auc"] - result["cpu_auc"]) > 1e-6:
        raise AssertionError(f"AUC on cuda and cpu differ: {result}")
    if not result["telemetry_bitwise_plain"]:
        raise AssertionError(f"score_game with telemetry differs from the plain run: {result}")
    if not (result["offheap_uids_equal"]
            and np.allclose(offheap, plain, rtol=2e-4, atol=1e-5)
            and abs(result["cuda_offheap_auc"] - result["cuda_auc"]) <= 1e-6):
        raise AssertionError(f"score_game through off-heap maps disagrees: {result}")
    if not (result["flags_bitwise_plain"] and result["flags_model_ids"] == ["chip-smoke-model"]
            and result["flags_stats_logged"]
            and result["flags_events"] == ["ScoringStartEvent", "ScoringFinishEvent", "closed"]):
        raise AssertionError(f"score_game --model-id/--log-*/--event-listeners: {result}")
    emit("score_game_cli", **result)
    return result


def _peak_rss_gb() -> dict:
    """Peak resident set of this process and of its waited-for children."""
    return {
        "self": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "children": resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6,
    }


GLMIX_BAGS = (("global", "features", "f"), ("per_user", "userFeatures", "u"),
              ("per_item", "itemFeatures", "i"))


def _glmix_part_job(data, path: str, lo: int, hi: int) -> tuple:
    """The arguments of one writer process: rows [lo, hi) of a make_glmix
    GameData (k entries a row, in row order, in each shard)."""
    bags = {}
    for shard, bag, prefix in GLMIX_BAGS:
        sh = data.feature_shards[shard]
        k = len(sh.rows) // data.num_rows
        bags[bag] = (prefix, sh.cols[lo * k:hi * k].reshape(-1, k),
                     sh.vals[lo * k:hi * k].reshape(-1, k))
    return (path, lo, bags, data.id_tags["userId"][lo:hi], data.id_tags["itemId"][lo:hi],
            data.labels[lo:hi])


def _write_glmix_part(job) -> float:
    """One Avro part file (a writer process' body) from ``_glmix_part_job``:
    FE features ("f", column), the RE bags ("u" / "i", column), the id tags
    in metadataMap. Its seconds."""
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    path, lo, bags, users, items, labels = job
    t0 = time.perf_counter()
    rows = {bag: [[(prefix, str(c), v) for c, v in zip(cr, vr)]
                  for cr, vr in zip(cols.tolist(), vals.astype(np.float64).tolist())]
            for bag, (prefix, cols, vals) in bags.items()}
    users, items, labels = users.tolist(), items.tolist(), labels.astype(np.float64).tolist()
    records = ({
        "uid": f"r{lo + r}", "label": labels[r],
        **{bag: feats[r] for bag, feats in rows.items()},
        "metadataMap": {"userId": users[r], "itemId": items[r]},
    } for r in range(len(labels)))
    write_training_examples(path, records)
    return time.perf_counter() - t0


class AvroPrep:
    """Avro part files of a make_glmix-style GameData's rows and the
    build_index stores of their shards, made in the background while other
    phases run: writer processes write the files, then each build_index
    invocation runs in a process of its own. The thread that starts them
    runs at the lowest CPU priority (nice 19), which its processes inherit,
    so the phase running meanwhile keeps its core. ``wait`` joins it and
    returns the seconds of each step; ``close`` removes the files."""

    def __init__(self, prefix: str, data, files: int, index_args: tuple):
        self.tmp = tempfile.TemporaryDirectory(prefix=prefix)
        self.data_dir = os.path.join(self.tmp.name, "data")
        self.idx = os.path.join(self.tmp.name, "idx")
        os.makedirs(self.data_dir)
        rows = data.num_rows // files
        self.paths = [os.path.join(self.data_dir, f"part-{i:05d}.avro") for i in range(files)]
        jobs = [_glmix_part_job(data, path, i * rows, (i + 1) * rows)
                for i, path in enumerate(self.paths)]
        self.info, self.error = {}, None
        self.thread = threading.Thread(target=self._run, args=(jobs, index_args),
                                       name=f"{prefix}prep")
        self.thread.start()

    def _run(self, jobs: list, index_args: tuple) -> None:
        import multiprocessing

        try:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except OSError:
                pass
            t0 = time.perf_counter()
            # spawned writers (this process runs threads): each gets its rows
            with multiprocessing.get_context("spawn").Pool(
                    min(len(jobs), os.cpu_count() or 1)) as pool:
                self.info["write_file_s"] = pool.map(_write_glmix_part, jobs)
            self.info["write_s"] = time.perf_counter() - t0
            self.info["index_s"] = []
            for args in index_args:
                t0 = time.perf_counter()
                run = subprocess.run(
                    [sys.executable, "-m", "photon_ml_tpu_torch.cli.build_index",
                     "--data-dirs", self.data_dir, "--output-dir", self.idx, *args],
                    capture_output=True, text=True, timeout=900,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
                if run.returncode != 0:
                    raise RuntimeError(f"build_index {args} exited {run.returncode}: "
                                       f"{run.stderr[-2000:]}")
                self.info["index_s"].append(time.perf_counter() - t0)
        except BaseException as e:  # re-raised by wait() on the phase's thread
            self.error = e

    def wait(self) -> dict:
        t0 = time.perf_counter()
        self.thread.join()
        self.info["waited_s"] = time.perf_counter() - t0
        if self.error is not None:
            raise RuntimeError(f"preparing {self.data_dir} failed") from self.error
        return self.info

    def close(self) -> None:
        self.thread.join()
        self.tmp.cleanup()


FE_INDEX_ARGS = ("--no-intercept", "--feature-shard", "global=features",
                 "--num-partitions", "8")
RE_INDEX_ARGS = ("--no-intercept", "--feature-shard", "per_user=userFeatures",
                 "--feature-shard", "per_item=itemFeatures")
# the phases whose Avro files are made in the background (set by main)
BACKGROUND_PREP: set = set()


def _packed_names(prefix: str, n: int) -> tuple:
    """The feature keys prefix\\x01<c> of columns 0..n-1, packed for an
    off-heap lookup: (blob, offsets, lengths)."""
    keys = np.char.add(prefix.encode() + b"\x01", np.arange(n).astype("S10"))
    width = keys.dtype.itemsize
    return (keys.tobytes(), np.arange(n, dtype=np.uint64) * np.uint64(width),
            np.char.str_len(keys).astype(np.uint32))


def _carry_by_name(coords: dict, maps: dict, dims: dict) -> tuple:
    """The model's coordinates with every coefficient moved into the
    off-heap stores' column space by feature name, and per shard the
    store index -> original column map (-1: no column)."""
    luts, inverse = {}, {}
    for shard, _, prefix in GLMIX_BAGS:
        lut = maps[shard].get_indices_packed(*_packed_names(prefix, dims[shard]))
        inv = np.full(len(maps[shard]), -1, dtype=np.int64)
        inv[lut[lut >= 0]] = np.nonzero(lut >= 0)[0]
        if (inv < 0).any():
            raise AssertionError(f"store {shard} holds a key of no column")
        luts[shard], inverse[shard] = lut, inv
    out = {}
    for cid, c in coords.items():
        c = dict(c)
        shard = c["feature_shard"]
        new_dim = len(maps[shard])
        lut = luts[shard]
        if "means" in c:
            means = np.zeros(new_dim, dtype=np.float32)
            means[lut[lut >= 0]] = c["means"][lut >= 0]
            c["means"] = means
        else:
            lut_ext = np.append(lut, -1)  # the padding column global_dim
            pidx, valid, coef = [], [], []
            for p, v, w in zip(c["proj_indices"], c["proj_valid"], c["coefficients"]):
                q = lut_ext[p]
                v = v & (q >= 0)
                key = np.where(v, q, new_dim)
                order = np.argsort(key, axis=1, kind="stable")
                pidx.append(np.take_along_axis(key, order, axis=1))
                valid.append(np.take_along_axis(v, order, axis=1))
                coef.append(np.take_along_axis(w, order, axis=1))
            c.update(proj_indices=pidx, proj_valid=valid, coefficients=coef, global_dim=new_dim)
        out[cid] = c
    return out, inverse


def _same_triples(a, b, inverse=None) -> bool:
    """Two COO shards hold the same (row, column, value) triples; ``a``'s
    columns are mapped through ``inverse`` first."""
    cols = a.cols if inverse is None else inverse[a.cols]
    ka = np.lexsort((a.vals, cols, a.rows))
    kb = np.lexsort((b.vals, b.cols, b.rows))
    return (len(a.rows) == len(b.rows) and np.array_equal(a.rows[ka], b.rows[kb])
            and np.array_equal(cols[ka], b.cols[kb]) and np.array_equal(a.vals[ka], b.vals[kb]))


# rows, FE dims, users, items, part files: score_full_width's widths at a
# quarter of its depth
READ_SCORE = (1 << 18, 1 << 24, 65_536, 16_384, 8)


@functools.lru_cache(maxsize=1)
def _read_score_prep(seed: int) -> tuple:
    """read_score_full_width's rows and model (make_glmix), and its Avro
    files and stores, made in the background (AvroPrep) from the call on."""
    n, fe_dim, n_users, n_items, files = READ_SCORE
    t0 = time.perf_counter()
    data, coords = make_glmix(seed, n, fe_dim, 16, n_users=n_users, n_items=n_items)
    setup_s = time.perf_counter() - t0
    return data, coords, setup_s, AvroPrep("chip_smoke_read_", data, files,
                                           (FE_INDEX_ARGS, RE_INDEX_ARGS))


def phase_read_score_full_width(seed: int, device: str = "cuda") -> dict:
    from photon_ml_tpu_torch.cli.common import load_index_maps
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.io import data_reader
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.types import TaskType

    n, fe_dim, _, _, files = READ_SCORE
    data, coords, setup_s, prep = _read_score_prep(seed)
    _read_score_prep.cache_clear()
    dims = {shard: data.feature_shards[shard].dim for shard, _, _ in GLMIX_BAGS}
    result = {"n": n, "fe_dim": fe_dim, "files": files, "setup_s": setup_s}
    try:
        # written and indexed in the background (nice 19) since main started
        # it: the seconds of each step, and this phase's wait
        info = prep.wait()
        data_dir = prep.data_dir
        result["write_s"] = info["write_s"]
        result["write_file_s_max"] = max(info["write_file_s"])
        result["avro_bytes"] = sum(os.path.getsize(p) for p in prep.paths)
        result["build_fe_s"], result["build_re_s"] = info["index_s"]
        result["prep_waited_s"] = info["waited_s"]
        maps = load_index_maps(prep.idx, dims)
        result["store_keys"] = {shard: len(m) for shard, m in maps.items()}

        configs = {shard: data_reader.FeatureShardConfiguration([bag], add_intercept=False)
                   for shard, bag, _ in GLMIX_BAGS}
        read_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            native, _, uids = data_reader.read_game_data(
                [data_dir], configs, maps, id_tags=["userId", "itemId"])
            read_s.append(time.perf_counter() - t0)
        result["read_s"] = read_s
        result["read_rows_per_s"] = [n / s for s in read_s]
        t0 = time.perf_counter()
        carried, inverse = _carry_by_name(coords, maps, dims)
        result["carry_s"] = time.perf_counter() - t0
        for m in maps.values():
            m.close()
    finally:
        prep.close()

    same = {shard: _same_triples(native.feature_shards[shard], data.feature_shards[shard],
                                 inverse[shard]) for shard, _, _ in GLMIX_BAGS}
    same["labels"] = bool(np.array_equal(native.labels, data.labels))
    same["id_tags"] = all(np.array_equal(native.id_tags[t], data.id_tags[t])
                          for t in ("userId", "itemId"))
    same["uids"] = uids == [f"r{r}" for r in range(n)]
    result["data_equal"] = same

    def timed_score(model, game_data) -> tuple:
        t0 = time.perf_counter()
        z = model.score(game_data)
        if device == "cuda":
            torch.cuda.synchronize()
        return z, time.perf_counter() - t0

    reference = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device=device)
    z_ref, result["reference_score_s"] = timed_score(reference, data)
    model = game_model_from_numpy(carried, TaskType.LOGISTIC_REGRESSION, device=device)
    # the main path: counts set to 0 just before, read just after
    launches.reset()
    z, result["score_s"] = timed_score(model, native)
    result["launches"] = launches.counts()["csr_matvec_f32"]
    result["rescore_s"] = timed_score(model, native)[1]
    result["scores_bitwise"] = bool(torch.equal(z, z_ref))
    result["scores_max_abs_diff"] = float((z - z_ref).abs().max())
    result["peak_rss_gb"] = _peak_rss_gb()
    if not all(same.values()):
        raise AssertionError(f"natively read data differs from make_glmix's: {same}")
    if result["launches"] < 1:
        raise AssertionError(f"scoring did not launch csr_matvec_f32: {result}")
    if z.shape != (n,) or not bool(torch.isfinite(z).all()) or not (
            result["scores_bitwise"] or torch.allclose(z, z_ref, rtol=2e-4, atol=1e-5)):
        raise AssertionError(f"scores through the off-heap read disagree: {result}")
    emit("read_score_full_width", **result)
    return result


@functools.lru_cache(maxsize=2)  # FULL_WIDTH's rows and a smaller set between their uses
def make_glmix_training(seed: int, n: int, n_val: int, fe_dim: int, fe_k: int,
                        n_users: int, n_items: int, re_dim: int = 4096,
                        re_local: int = 16, re_k: int = 8, unseen: float = 0.03):
    """Training and validation GameData drawn from one random GLMix logistic
    model, made from ``seed``: FE rows of ``fe_k`` distinct features out of
    ``fe_dim`` plus an intercept (column ``fe_dim``); each user and item an
    entity with ``re_local`` features of its own out of ``re_dim``, each row
    ``re_k`` of them. Validation rows name an unseen entity with
    probability ``unseen``. Kept for the next phase that asks for the same
    data (the GameData caches its device layouts too)."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    rng = np.random.default_rng(seed)
    total = n + n_val
    fe_cols = np.sort(_distinct_cols(rng, total, fe_k, fe_dim), axis=1)
    fe_cols = np.concatenate([fe_cols, np.full((total, 1), fe_dim)], axis=1)
    fe_vals = np.concatenate(
        [rng.standard_normal((total, fe_k), dtype=np.float32) / np.sqrt(fe_k),
         np.ones((total, 1), np.float32)], axis=1)
    w_fe = rng.standard_normal(fe_dim + 1, dtype=np.float32)
    margin = (fe_vals * w_fe[fe_cols]).sum(axis=1)
    cols = {"global": fe_cols}
    vals = {"global": fe_vals}
    id_tags = {}
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        space = np.sort(_distinct_cols(rng, count, re_local, re_dim), axis=1)
        w_re = rng.standard_normal((count, re_local), dtype=np.float32) * 0.5
        ent = rng.integers(0, count, total)
        slot = np.sort(_distinct_cols(rng, total, re_k, re_local), axis=1)
        v = rng.standard_normal((total, re_k), dtype=np.float32) / np.sqrt(re_k)
        margin += (v * w_re[ent[:, None], slot]).sum(axis=1)
        cols[shard] = space[ent[:, None], slot]
        vals[shard] = v
        new = np.zeros(total, dtype=bool)
        new[n:] = rng.random(n_val) < unseen
        id_tags[re_type] = np.where(
            new, np.char.add(f"new_{prefix}", ent.astype(str)),
            np.char.add(prefix, ent.astype(str)),
        )
    labels = (rng.random(total) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    dims = {"global": fe_dim + 1, "per_user": re_dim, "per_item": re_dim}

    def part(lo, hi):
        shards = {}
        for shard, c in cols.items():
            k = c.shape[1]
            shards[shard] = FeatureShard(
                np.repeat(np.arange(hi - lo, dtype=np.int64), k),
                c[lo:hi].reshape(-1).astype(np.int64),
                vals[shard][lo:hi].reshape(-1), dims[shard],
            )
        return GameData(labels=labels[lo:hi], feature_shards=shards,
                        id_tags={t: v[lo:hi] for t, v in id_tags.items()})

    return part(0, n), part(n, total)


def _glmix_estimator(device: str, fe_engine: str = "auto", **kwargs):
    """FE (on ``fe_engine``) + per_user + per_item, L-BFGS 10 iterations, L2
    lambda 1, one outer iteration; ``kwargs`` go to GameEstimator
    (normalization, intercept_indices)."""
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration as FE,
        GameEstimator,
        RandomEffectCoordinateConfiguration as RE,
    )
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    opt = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(max_iterations=10),
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1.0,
    )
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {
            "fixed": FE("global", opt, sparse_engine=fe_engine),
            "per_user": RE("per_user", RandomEffectDataConfiguration("userId"), opt),
            "per_item": RE("per_item", RandomEffectDataConfiguration("itemId"), opt),
        },
        update_order=["fixed", "per_user", "per_item"],
        num_outer_iterations=1,
        device=device,
        **kwargs,
    )


class plain_versions:
    """Within the block, the named kernel wrappers (default: every kernel of
    the port) compute their plain PyTorch versions on the card instead of
    launching their kernels (a comparison run; the package has no such
    switch). A compiled plan launches lane_shuffle_f32, lane_relayout_f32
    and inner_shuffle_f32 from one C call (permute_net.plan_f32): naming any
    of them also runs every plan through its groups' plain versions
    (permute_net.plan_plain)."""

    def __init__(self, kernels=KERNELS + SHUFFLES + BF16_KERNELS + (BLOCKED,)):
        self.kernels = kernels

    def __enter__(self):
        from photon_ml_tpu_torch.ops import fused_perm, pallas_kernels, permute_net

        plan = (permute_net, "plan_f32", permute_net.plan_plain)
        plain = {
            "csr_matvec_f32": [(fused_perm, "csr_matvec_f32",
                                lambda row_ptr, col_idx, vals, w, dim, split=None, blocks=1:
                                fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w, blocks))],
            "csc_rmatvec_f32": [(fused_perm, "csc_rmatvec_f32",
                                 lambda col_ptr, row_idx, vals, c, n, transform="id", split=None:
                                 fused_perm.csc_rmatvec_plain(col_ptr, row_idx, vals, c,
                                                              transform))],
            "fused_value_grad_batched_f32": [(pallas_kernels, "fused_value_grad_batched_f32",
                                              pallas_kernels.fused_value_grad_plain)],
            "lane_shuffle_f32": [(permute_net, "lane_shuffle_f32",
                                  permute_net.lane_shuffle_plain), plan],
            "sublane_shuffle_f32": [(permute_net, "sublane_shuffle_f32",
                                     permute_net.sublane_shuffle_plain)],
            "lane_relayout_f32": [(permute_net, "lane_relayout_f32",
                                   permute_net.lane_relayout_plain), plan],
            "inner_shuffle_f32": [(permute_net, "inner_shuffle_f32",
                                   permute_net.inner_shuffle_plain), plan],
            "csr_matvec_bf16": [(fused_perm, "csr_matvec_bf16",
                                 lambda row_ptr, col_idx, vals, w, dim, split=None, blocks=1:
                                 fused_perm.csr_matvec_bf16_plain(row_ptr, col_idx, vals, w,
                                                                  blocks))],
            "csc_rmatvec_bf16": [(fused_perm, "csc_rmatvec_bf16",
                                  lambda col_ptr, row_idx, vals, c, n, transform="id",
                                  split=None: fused_perm.csc_rmatvec_bf16_plain(
                                      col_ptr, row_idx, vals, c, transform))],
            "fused_value_grad_f32": [(pallas_kernels, "fused_value_grad_f32",
                                      pallas_kernels.fused_value_grad_plain)],
        }
        self._saved = {}
        for name in self.kernels:
            for module, attr, fn in plain[name]:
                if (module, attr) not in self._saved:
                    self._saved[module, attr] = getattr(module, attr)
                    setattr(module, attr, fn)
        return self

    def __exit__(self, *exc):
        for (module, attr), fn in self._saved.items():
            setattr(module, attr, fn)


def plan_kernels(feats) -> list:
    """The kernels the compiled plans of a Benes engine launch (every
    block's plan and inverse plan; a grid's every tile)."""
    from photon_ml_tpu_torch.ops import sparse_perm

    found, todo = set(), [feats]
    while todo:
        f = todo.pop()
        if isinstance(f, sparse_perm.BenesSparseFeatures):
            found |= {g.kernel for p in (f.plan, f.plan_inv) for g in p.groups}
        todo.extend(getattr(f, "blocks", ()))
        todo.extend(t for row in getattr(f, "shards", ()) for t in row if t is not None)
    return sorted(found)


def _device_events(prof) -> list:
    """(name, start ns, end ns) of every device-side event (kernels and
    copies on every stream) of a finished torch.profiler run, read from its
    raw results: building the profiler's own event objects costs about 70
    us an event, minutes for a fit's million host and device events."""
    from torch.autograd import DeviceType

    try:
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:  # a torch without the raw results' accessors
        return [(e.name, e.time_range.start * 1000, e.time_range.end * 1000)
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_device_idle(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy time, the
    union of its device events' intervals (the device-side events alone: a
    host operator also reports the device time of what it launched; work
    overlapped on several streams counts once), their plain sum, the idle
    share of the call's wall time, and the top device consumers. The
    profiler records the device alone: host operators would add their own
    recording to the wall (seconds in a long host-bound call) and are not
    read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    if not events:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured",
                "device_idle_share": "not measured"}
    union_ns, sum_ns, by_name = 0, 0, {}
    spans = sorted((a, b) for _, a, b in events)
    lo, hi = spans[0]
    for a, b in spans:
        sum_ns += b - a
        if a > hi:
            union_ns += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    union_ns += hi - lo
    for name, a, b in events:
        by_name[name[:60]] = by_name.get(name[:60], 0) + b - a
    busy_ms = union_ns / 1e6
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_event_ms_sum": sum_ns / 1e6,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_events": len(events),
        "top_device_ms": {k: v / 1e6 for k, v in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:6]},
    }


def sequential_cols(kernel, feats, w) -> dict:
    """A CSR kernel on the matrix's own rows with col_idx replaced by the
    sequential pattern p mod dim (the same nonzeros a row, w read in order),
    as a cuda_ms entry "sequential": its gap to the random pattern is the
    cost of the w gather."""
    from photon_ml_tpu_torch.ops import fused_perm

    nnz = feats.col_idx.numel()
    col_seq = (torch.arange(nnz, device="cuda") % feats.dim).to(torch.int32)
    row_split = fused_perm.merge_path_split(feats.row_ptr, nnz)
    return {"sequential": lambda: kernel(feats.row_ptr, col_seq, feats.vals, w, feats.dim,
                                         row_split, feats.row_blocks)}


def value_grad_times(bucket, gen) -> dict:
    """fused_value_grad_batched_f32 at a random-effect bucket's shape (its
    X, labels, offsets and weights, random coefficients): kernel, plain,
    library (torch.bmm, the elementwise loss, torch.bmm) and L2-flushed
    times, and the bound; "inputs" the operands."""
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import pallas_kernels

    E, s, d = bucket.X.shape
    w_re = torch.randn(E, d, generator=gen, device="cuda") * 0.1
    vg_in = (bucket.X, bucket.labels, bucket.offsets, bucket.weights, w_re)

    def library():
        z = torch.bmm(bucket.X, w_re.unsqueeze(-1)).squeeze(-1) + bucket.offsets
        pos = bucket.weights > 0
        lw = torch.where(pos, bucket.weights * LogisticLoss.value(z, bucket.labels), 0.0)
        dz = torch.where(pos, bucket.weights * LogisticLoss.d1(z, bucket.labels), 0.0)
        return lw.sum(-1), torch.bmm(dz.unsqueeze(1), bucket.X).squeeze(1), dz.sum(-1)

    kernel = lambda: pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss)  # noqa: E731
    ms = cuda_ms({
        "kernel": kernel,
        "plain": lambda: pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss),
        "library": library,
    })
    bound_ms, bound_by = value_grad_bound_ms(E, s, d)
    return {"shape": [E, s, d], "plan": dataclasses.asdict(pallas_kernels.entity_tiling(E, s, d)),
            **kernel_times(ms), "flushed_ms": flushed_ms(kernel), "bound_ms": bound_ms,
            "bound_by": bound_by, "inputs": vg_in}


@functools.lru_cache(maxsize=1)
def _in_memory_glmix_fit(seed: int) -> dict:
    """train_full_width's main path, kept for train_streaming_full_width,
    which holds its streamed fits against it: the GLMix estimator, its
    coordinates over make_glmix_training's rows at FULL_WIDTH and its fit,
    with the seconds of each step and the fit's launches (counts set to 0
    just before the fit, read just after)."""
    from photon_ml_tpu_torch.ops import launches

    n, n_val, fe_dim, fe_k, users, items = FULL_WIDTH
    t0 = time.perf_counter()
    train, val = make_glmix_training(seed, n, n_val, fe_dim, fe_k, users, items)
    data_s = time.perf_counter() - t0
    if "stream" in BACKGROUND_PREP:
        _stream_prep(seed)  # the streaming phases' files (main starts them earlier)
    estimator = _glmix_estimator("cuda")
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches.reset()
    t0 = time.perf_counter()
    fit = estimator.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    return {"train": train, "val": val, "estimator": estimator, "coords": coords,
            "fit": fit, "data_s": data_s, "build_s": build_s,
            "fit_s": time.perf_counter() - t0, "counts": launches.counts()}


def phase_train_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import fused_perm, launches, pallas_kernels

    main = _in_memory_glmix_fit(seed)
    train, val, estimator, coords, fit, counts = (
        main[k] for k in ("train", "val", "estimator", "coords", "fit", "counts"))
    n, n_val = FULL_WIDTH[:2]
    data_s, build_s, fit_s = main["data_s"], main["build_s"], main["fit_s"]
    feats = coords["fixed"].data.features
    if not isinstance(feats, fused_perm.FusedSparseFeatures):
        raise AssertionError(f"auto engine picked {type(feats).__name__}, not fused")
    buckets = {cid: [tuple(b.X.shape) for b in coords[cid].dataset.buckets]
               for cid in ("per_user", "per_item")}
    missing = [k for k in KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"training did not launch {missing}: {counts}")

    labels = torch.from_numpy(train.labels).cuda()
    before = float(LogisticLoss.value(torch.zeros_like(labels), labels).sum())
    after = fit.objective_history[-1][1]
    if not after < before:
        raise AssertionError(f"training objective did not fall: {before} -> {after}")

    # the same training through the plain versions, on the card
    launches.reset()
    with plain_versions():
        t0 = time.perf_counter()
        plain_fit = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        plain_fit_s = time.perf_counter() - t0
    if any(launches.counts()[k] for k in KERNELS):
        raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
    obj_rel = abs(after - plain_fit.objective_history[-1][1]) / abs(after)
    auc_diff = abs(fit.validation_metric - plain_fit.validation_metric)
    if not (np.isfinite(fit.validation_metric) and obj_rel <= 1e-4 and auc_diff <= 1e-4):
        raise AssertionError(
            f"kernel and plain training differ: objective rel {obj_rel}, AUC {auc_diff}"
        )

    # kernel times at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = fit.model.models["fixed"].coefficients.means
    c = torch.randn(n, generator=gen, device="cuda")
    split = fused_perm.merge_path_split(feats.col_ptr, feats.row_idx.numel())
    row_split = fused_perm.merge_path_split(feats.row_ptr, feats.col_idx.numel())
    row_ptr, col_idx, vals = row_major_csr(feats)
    csr = torch.sparse_csr_tensor(row_ptr, col_idx.long(), vals, size=(n, feats.dim))
    csr_t = torch.sparse_csr_tensor(feats.col_ptr, feats.row_idx.long(), feats.vals_csc,
                                    size=(feats.dim, n))
    csr_kernel = lambda: fused_perm.csr_matvec_f32(  # noqa: E731
        feats.row_ptr, feats.col_idx, feats.vals, w, feats.dim, row_split, feats.row_blocks)
    times = {
        "csr_matvec_f32": cuda_ms({
            "kernel": csr_kernel,
            "plain": lambda: fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w),
            "library": lambda: torch.mv(csr, w),
            **sequential_cols(fused_perm.csr_matvec_f32, feats, w),
        }),
        "csc_rmatvec_f32": cuda_ms({
            "kernel": lambda: fused_perm.csc_rmatvec_f32(
                feats.col_ptr, feats.row_idx, feats.vals_csc, c, n, "id", split),
            "plain": lambda: fused_perm.csc_rmatvec_plain(
                feats.col_ptr, feats.row_idx, feats.vals_csc, c),
            "library": lambda: torch.mv(csr_t, c),
        }),
    }
    vg_times = {cid: value_grad_times(coords[cid].dataset.buckets[0], gen)
                for cid in ("per_user", "per_item")}
    vg_in = vg_times["per_user"].pop("inputs")
    vg_times["per_item"].pop("inputs")
    E, s, d = vg_in[0].shape
    flushed = {"csr_matvec_f32": flushed_ms(csr_kernel),
               "fused_value_grad_batched_f32": vg_times["per_user"]["flushed_ms"]}

    # each kernel against its plain version and float64, on the inputs timed
    # above (the main path's shapes)
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), row_ptr.diff())
    prod = vals.double() * w.double()[col_idx.long()]
    z64 = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod)
    row_abs = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod.abs())
    g_plain = fused_perm.csc_rmatvec_plain(feats.col_ptr, feats.row_idx, feats.vals_csc, c)
    col_abs = fused_perm.csc_rmatvec_plain(
        feats.col_ptr, feats.row_idx, feats.vals_csc.abs(), c.abs()).double()
    vg_ref, vg_scale = _value_grad_f64(*vg_in, LogisticLoss)
    checks = {
        "csr_matvec_f32": [_compare(
            csr_kernel(),
            fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w),
            z64, row_abs, row_ptr.diff(), (n,))],
        "csc_rmatvec_f32": [_compare(
            fused_perm.csc_rmatvec_f32(feats.col_ptr, feats.row_idx, feats.vals_csc, c, n,
                                       "id", split),
            g_plain, g_plain.double(), col_abs, feats.col_ptr.diff(), (feats.dim,))],
        "fused_value_grad_batched_f32": [
            _compare(o, p, r, a, s, o.shape, part=part)
            for part, o, p, r, a in zip(
                ("value", "grad", "csum"),
                pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss),
                pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss), vg_ref, vg_scale)
        ],
    }
    if not all(case["ok"] for cases in checks.values() for case in cases):
        raise AssertionError(f"kernels disagree with their plain versions at the main "
                             f"path's shapes: {checks}")
    if not torch.equal(csr_kernel(), csr_kernel()) or not all(
            torch.equal(a, b) for a, b in zip(
                pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss),
                pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss))):
        raise AssertionError("a redesigned kernel does not repeat bitwise at the path's shapes")
    bounds = {
        "csr_matvec_f32": csr_bound_ms(n, feats.nnz, feats.dim),
        "csc_rmatvec_f32": csc_bound_ms(n, feats.nnz, feats.dim),
    }
    kernels = {
        k: {"launches": counts[k], **kernel_times(times[k]), "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1]}
        for k in KERNELS[:2]
    }
    kernels["csr_matvec_f32"].update(
        sequential_cols_device_ms=times["csr_matvec_f32"]["sequential_device"],
        flushed_ms=flushed["csr_matvec_f32"])
    kernels["fused_value_grad_batched_f32"] = {
        "launches": counts["fused_value_grad_batched_f32"], **vg_times["per_user"],
        "per_item": vg_times["per_item"]}

    # device idle share of one random-effect solve (per_user, warm start)
    re_coord = coords["per_user"]
    residual = torch.zeros(n, device="cuda")
    idle = profile_device_idle(
        lambda: re_coord.update_model_device(fit.model.models["per_user"], residual)
    )
    result = {
        "rows": n, "validation_rows": n_val, "fe_dim": feats.dim, "fe_nnz": feats.nnz,
        "buckets": buckets, "data_s": data_s, "build_coordinates_s": build_s,
        "fit_s": fit_s, "plain_fit_s": plain_fit_s,
        "seconds_per_coordinate": fit.update_seconds,
        "plain_seconds_per_coordinate": plain_fit.update_seconds,
        "objective_before": before, "objective_history": fit.objective_history,
        "plain_objective_history": plain_fit.objective_history,
        "objective_rel_diff_vs_plain": obj_rel,
        "validation_auc": fit.validation_metric,
        "plain_validation_auc": plain_fit.validation_metric,
        "auc_diff_vs_plain": auc_diff,
        "launches": counts, "kernels": kernels, "main_path_kernel_checks": checks,
        "re_solve_profile": idle,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("train_full_width", **result)
    return result


STREAM_FILES = 16
STREAM_RESIDENT_BLOCKS = 8
STREAM_STOCHASTIC_EPOCHS = 1  # each stochastic fit: one epoch over the 16 blocks


def _store_luts(maps, dims: dict) -> dict:
    """Per shard of GLMIX_BAGS, the original column -> off-heap store index
    map (-1: a column the store has no key for)."""
    return {shard: maps[shard].get_indices_packed(*_packed_names(prefix, dims[shard]))
            for shard, _, prefix in GLMIX_BAGS}


def _in_store_space(data, luts: dict, store_dims: dict):
    """``data`` with every shard's columns moved into the stores' column
    space (entries of columns the stores lack dropped, as a read through
    the stores drops them)."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    shards = {}
    for shard, fs in data.feature_shards.items():
        cols = luts[shard][fs.cols]
        keep = cols >= 0
        shards[shard] = FeatureShard(fs.rows[keep], cols[keep].astype(np.int64),
                                     fs.vals[keep], store_dims[shard])
    return GameData(labels=data.labels, feature_shards=shards, id_tags=data.id_tags,
                    offsets=data.offsets, weights=data.weights)


def _stream_counters() -> dict:
    from photon_ml_tpu_torch.telemetry import get_registry

    return {k: v for k, v in get_registry().snapshot()["counters"].items()
            if k.startswith("stream.")}


@functools.lru_cache(maxsize=1)
def _stream_prep(seed: int) -> AvroPrep:
    """train_full_width's training rows as 16 Avro part files of 65,536 rows
    and their stores, made in the background (AvroPrep) from the call on:
    main starts it after score_full_width."""
    n, n_val, fe_dim, fe_k, users, items = FULL_WIDTH
    train, _ = make_glmix_training(seed, n, n_val, fe_dim, fe_k, users, items)
    return AvroPrep("chip_smoke_stream_", train, STREAM_FILES, (FE_INDEX_ARGS, RE_INDEX_ARGS))


@functools.lru_cache(maxsize=1)
def _stream_fixture(seed: int) -> dict:
    """train_full_width's rows as 16 Avro part files of 65,536 rows, written
    by worker processes, with off-heap stores of their shards built by the
    build_index CLI (both in the background: _stream_prep); the validation
    rows and the in-memory fit's FE columns moved into the stores' column
    space. Shared by the streaming and cluster phases (the writes are paid
    once); ``close`` removes it."""
    from photon_ml_tpu_torch.cli.common import load_index_maps

    n = FULL_WIDTH[0]
    rows_a_file = n // STREAM_FILES
    mem = _in_memory_glmix_fit(seed)
    train, val = mem["train"], mem["val"]
    fx = {"rows_a_file": rows_a_file}
    dims = {shard: train.feature_shards[shard].dim for shard, _, _ in GLMIX_BAGS}
    prep = _stream_prep(seed)
    _stream_prep.cache_clear()
    try:
        info = prep.wait()
    except BaseException:
        prep.close()
        raise
    fx.update(root=prep.tmp.name, data_dir=prep.data_dir, idx=prep.idx,
              write_s=info["write_s"], build_index_s=sum(info["index_s"]),
              prep_waited_s=info["waited_s"],
              avro_bytes=sum(os.path.getsize(p) for p in prep.paths))
    maps = fx["maps"] = load_index_maps(prep.idx, dims)
    store_dims = fx["store_dims"] = {shard: len(m) for shard, m in maps.items()}
    t0 = time.perf_counter()
    luts = _store_luts(maps, dims)
    fx["val_mem"] = _in_store_space(val, luts, store_dims)
    # store index -> original FE column (the stores hold the training
    # rows' columns only; the in-memory fit leaves every other column 0)
    fe_lut = luts["global"]
    fe_cols = torch.full((store_dims["global"],), -1, dtype=torch.long)
    fe_cols[torch.from_numpy(fe_lut[fe_lut >= 0])] = torch.from_numpy(
        np.nonzero(fe_lut >= 0)[0])
    if bool((fe_cols < 0).any()):
        raise AssertionError("the FE store holds a key of no column")
    fx["fe_cols"] = fe_cols.cuda()
    fx["store_space_s"] = time.perf_counter() - t0

    def close():
        for m in maps.values():
            m.close()
        prep.close()

    fx["close"] = close
    return fx


_STREAM_FIXTURES: list = []  # the fixtures made, closed when the cache clears


def _stream_fixture_clear() -> None:
    """Close and forget the streaming phases' shared fixture."""
    while _STREAM_FIXTURES:
        _STREAM_FIXTURES.pop()["close"]()
    _stream_fixture.cache_clear()


def phase_train_streaming_full_width(seed: int) -> dict:
    """fit_streaming at the width of train_full_width over 16 Avro part
    files read through off-heap stores, held against train_full_width's
    in-memory fit of the same rows (moved into the stores' column space)."""
    from photon_ml_tpu_torch import streaming
    from photon_ml_tpu_torch.io import data_reader
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.streaming import solver as stream_solver
    from photon_ml_tpu_torch.types import TaskType

    n, n_val = FULL_WIDTH[:2]
    mem = _in_memory_glmix_fit(seed)
    fx = _stream_fixture(seed)
    if fx not in _STREAM_FIXTURES:
        _STREAM_FIXTURES.append(fx)
    rows_a_file = fx["rows_a_file"]
    fit_mem = mem["fit"]
    result = {"rows": n, "validation_rows": n_val, "files": STREAM_FILES,
              "block_rows": rows_a_file}
    result.update({k: fx[k] for k in ("write_s", "avro_bytes", "build_index_s",
                                      "prep_waited_s", "store_dims", "store_space_s")})
    failures = []
    root, data_dir, maps = fx["root"], fx["data_dir"], fx["maps"]
    store_dims, val_mem, fe_cols = fx["store_dims"], fx["val_mem"], fx["fe_cols"]
    w_mem = fit_mem.model.models["fixed"].coefficients.means
    result["in_memory_auc"] = fit_mem.validation_metric
    result["in_memory_objective"] = fit_mem.objective_history[-1][1]
    result["in_memory_fe_coef_max_abs"] = float(w_mem.abs().max())

    def against_in_memory(fit) -> dict:
        """A streamed fit against the in-memory one: final objective
        (relative), FE coefficients (largest absolute difference),
        held-out AUC."""
        obj = fit.objective_history[-1][1]
        w = fit.model.models["fixed"].coefficients.means
        return {
            "objective_rel": abs(obj - result["in_memory_objective"])
            / abs(result["in_memory_objective"]),
            "fe_coef_max_abs_diff": float((w - w_mem[fe_cols]).abs().max()),
            "auc_diff": abs(fit.validation_metric - fit_mem.validation_metric),
        }

    configs = {shard: data_reader.FeatureShardConfiguration([bag], add_intercept=False)
               for shard, bag, _ in GLMIX_BAGS}
    t0 = time.perf_counter()
    source = streaming.StreamingSource.open(
        data_dir, configs, index_maps=maps, block_rows=rows_a_file,
        id_tags=("userId", "itemId"), cache_dir=os.path.join(root, "block_cache"))
    result["open_s"] = time.perf_counter() - t0
    result["num_blocks"] = source.plan.num_blocks
    result["block_upload_bytes"] = source.block_upload_bytes(("global",))
    if source.plan.num_blocks != STREAM_FILES or source.plan.shard_dims != store_dims:
        raise AssertionError(f"unexpected plan {source.plan}")

    def stream_fit(**kw) -> tuple:
        c0 = _stream_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = _glmix_estimator("cuda").fit_streaming(source, validation_data=val_mem, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c1 = _stream_counters()
        stats = {k[len("stream."):]: c1[k] - c0.get(k, 0) for k in c1}
        if stats.get("decode_s", 0) > 0:
            stats["hide_ratio"] = max(0.0, (stats["decode_s"] - stats["stall_s"])
                                      / stats["decode_s"])
        stats["fit_s"] = seconds
        stats["auc"] = fit.validation_metric
        stats["objective"] = fit.objective_history[-1][1]
        stats["seconds_per_coordinate"] = fit.update_seconds
        return fit, stats

    # the main path, cold (the first pass decodes and fills the block
    # cache): counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    cold, result["cold"] = stream_fit()
    counts = launches.counts()
    result["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result["launches"] = {k: counts[k] for k in ("fused_value_grad_batched_f32",
                                                 "csr_matvec_f32")}
    if min(result["launches"].values()) < 1:
        failures.append(f"the streamed fit did not launch {result['launches']}")
    warm, result["warm"] = stream_fit()
    result["cold_warm_bitwise"] = _same_fit(cold, warm)
    if not result["cold_warm_bitwise"]:
        failures.append("the cold and warm fits differ")
    if result["warm"]["cache_hit_blocks"] < result["warm"]["blocks"]:
        failures.append(f"a warm fit decoded: {result['warm']}")
    # the streamed fit lands where the in-memory fit lands: final
    # objective (the CPU tests' rtol), FE coefficients (the JAX
    # streaming gate's atol) and held-out AUC
    result["vs_in_memory"] = against_in_memory(cold)
    if not (result["vs_in_memory"]["objective_rel"] <= 1e-4
            and result["vs_in_memory"]["fe_coef_max_abs_diff"] <= 2e-3
            and result["vs_in_memory"]["auc_diff"] <= 1e-3):
        failures.append(f"the streamed fit is not the in-memory fit: "
                        f"{result['vs_in_memory']}")

    # exactness: the streamed full-batch (f, g) against the in-memory
    # objective over the same rows, at w = 0 and at the in-memory w
    objective = streaming.coordinate._objective_for_task(TaskType.LOGISTIC_REGRESSION)
    programs = stream_solver.StreamPrograms.for_objective(objective)
    fe_opt = mem["estimator"].coordinate_configs["fixed"].optimizer
    fe_data = mem["coords"]["fixed"].data
    l2 = float(fe_opt.l2_weight)
    exact = {}
    for label, w_m in (("w0", torch.zeros_like(w_mem)), ("w_in_memory", w_mem)):
        f_s, g_s, _ = stream_solver._full_pass(
            programs, w_m[fe_cols],
            lambda: (b.data["global"] for b in streaming.BlockPrefetcher(
                source, shards=("global",), device="cuda")), store_dims["global"],
            torch.tensor(l2, device="cuda"), streaming.StreamSolveInfo())
        f_m, g_m = objective.value_and_grad(w_m, fe_data, l2)
        g_m = g_m[fe_cols]
        exact[label] = {
            "f_streamed": float(f_s), "f_in_memory": float(f_m),
            "f_rel": abs(float(f_s) - float(f_m)) / abs(float(f_m)),
            "g_err_over_max": float((g_s - g_m).abs().max() / g_m.abs().max()),
        }
        if not (exact[label]["f_rel"] <= 1e-4 and exact[label]["g_err_over_max"] <= 1e-4):
            failures.append(f"streamed (f, g) at {label} differ: {exact[label]}")
    result["exactness"] = exact

    # the FE streamed solve alone (the fit's first update: zero residual,
    # no warm start), under torch.profiler: passes and device idle share
    coord = streaming.StreamingFixedEffectCoordinate(
        source=source, shard_id="global", task=TaskType.LOGISTIC_REGRESSION,
        configuration=fe_opt, device="cuda")
    holder = {}
    result["fe_update_profile"] = profile_device_idle(
        lambda: holder.setdefault("m", coord.update_model_device(
            None, torch.zeros(n, device="cuda"))))
    info = coord.last_solve_info
    result["fe_solve"] = {"passes": info.passes, "blocks": info.blocks,
                          "iterations": info.iterations,
                          "line_search_trials": info.line_search_trials}
    if not _bits_equal(holder["m"].coefficients.means,
                       cold.model.models["fixed"].coefficients.means):
        failures.append("the FE solve alone differs from the fit's FE update")

    if "cluster" in BACKGROUND_PREP:
        # the cluster phase's workers start up while the fits below run (the
        # warm fits and the profiled FE solve above ran alone)
        _cluster_launches(seed)
    # residency: 8 of 16 blocks kept on the card, the same fit bitwise
    resident, result["resident"] = stream_fit(resident_blocks=STREAM_RESIDENT_BLOCKS)
    saved = result["resident"].get("residency.h2d_saved_bytes", 0)
    result["resident_bitwise"] = _same_fit(resident, warm)
    if not result["resident_bitwise"]:
        failures.append("the resident fit differs from the warm fit")
    if not (saved > 0 and result["warm"]["h2d_bytes"] - result["resident"]["h2d_bytes"]
            == saved and saved >= STREAM_RESIDENT_BLOCKS * result["block_upload_bytes"]
            * (info.passes - 2)):
        failures.append(f"residency saved {saved} bytes: {result['resident']}")

    # stochastic, gap-scheduled: bitwise repeatable
    kw = dict(mode="stochastic", gap_schedule=True, stochastic_epochs=STREAM_STOCHASTIC_EPOCHS)
    sto, result["stochastic"] = stream_fit(**kw)
    sto2, result["stochastic_again"] = stream_fit(**kw)
    result["stochastic_bitwise"] = _same_fit(sto, sto2)
    if not result["stochastic_bitwise"]:
        failures.append("two stochastic fits differ")
    # the control: a fit that lands elsewhere (one stochastic epoch),
    # read by the same comparison as the full fit above
    result["stochastic_vs_in_memory"] = against_in_memory(sto)
    for fit in (cold, sto):
        z = fit.model.score(val_mem)
        if not bool(torch.isfinite(z).all()) or z.shape != (n_val,):
            failures.append("a streamed model scores non-finite or misshapen values")
    result["peak_rss_gb"] = _peak_rss_gb()
    fx["single_host_fit"] = cold
    fx["single_host_fit_s"] = result["cold"]["fit_s"]
    fx["source"] = source
    emit("train_streaming_full_width", **result)
    if failures:
        raise AssertionError(f"train_streaming_full_width gates failed: {failures}")
    return result


CLUSTER_HOSTS = 2
CLUSTER_KILL = (1, 4)  # host 1 dies after streaming 4 blocks


def _glmix_config_json(root: str) -> str:
    """_glmix_estimator's shards and coordinates as train_game's JSON (the
    cluster workers read their shard configurations and id tags from it)."""
    optimizer = {"optimizer": "LBFGS", "regularization": "L2", "regularization_weight": 1.0,
                 "max_iterations": 10}
    cfg = {
        "feature_shards": {shard: {"feature_bags": [bag], "add_intercept": False}
                           for shard, bag, _ in GLMIX_BAGS},
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global", "optimizer": optimizer},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId", "optimizer": optimizer},
            "per_item": {"type": "random", "feature_shard": "per_item",
                         "random_effect_type": "itemId", "optimizer": optimizer},
        },
        "update_order": ["fixed", "per_user", "per_item"],
    }
    path = os.path.join(root, "glmix_cluster.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _worker_peaks(plane) -> dict:
    """Each worker's peak device memory of its allocator, as its log reports
    it when the worker ends (its CUDA context comes on top)."""
    out = {}
    for host, text in plane.worker_logs().items():
        found = re.findall(r"peak device memory (\d+) bytes", text)
        out[str(host)] = int(found[-1]) if found else None
    return out


def _card_memory_used_mib():
    """The card's memory in use, MiB, every process's (nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return int(out[0]) if out and out[0].isdigit() else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _pass_summary(passes: list) -> dict:
    """Sums over a cluster fit's pass profiles: passes, wall, the overlapped
    compute (busy), the wait for the last reply (allreduce wait) and the
    coordinator's own fold (bubble)."""
    return {
        "passes": len(passes),
        "wall_s": sum(p["wall_s"] for p in passes),
        "busy_s": sum(p["busy_s"] for p in passes),
        "allreduce_wait_s": sum(p["allreduce_wait_s"] for p in passes),
        "coordinator_fold_s": sum(p["bubble_s"] for p in passes),
        "requeued_blocks": sum(p["requeued_blocks"] for p in passes),
        "blocks": sum(p["blocks"] for p in passes),
        "worker_h2d_bytes": sum(h.get("h2d_bytes", 0) for p in passes
                                for h in p["hosts"].values()),
    }


class PlaneLaunch:
    """ClusterPlane.launch of CLUSTER_HOSTS workers on the card over the
    streaming fixture's files and stores, on a thread of its own at the
    lowest CPU priority (nice 19; the workers and the coordinator's threads
    inherit it), started before the phase that uses the plane so that the
    workers' start-up overlaps the phase before it. ``wait`` returns the
    plane and the seconds the launch took."""

    def __init__(self, fx: dict, config: str, kill, tag: str):
        self.plane, self.seconds, self.error = None, None, None
        self.thread = threading.Thread(target=self._run, args=(fx, config, kill, tag),
                                       name=f"cluster-launch-{tag}")
        self.thread.start()

    def _run(self, fx: dict, config: str, kill, tag: str) -> None:
        from photon_ml_tpu_torch.parallel.cluster import ClusterPlane

        try:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except OSError:
                pass
            t0 = time.perf_counter()
            self.plane = ClusterPlane.launch(
                num_hosts=CLUSTER_HOSTS, num_blocks=STREAM_FILES,
                train_dirs=[fx["data_dir"]], coordinate_config=config,
                task="LOGISTIC_REGRESSION", feature_shard="global",
                block_rows=fx["rows_a_file"],
                block_cache_dir=os.path.join(fx["root"], "cluster_cache"),
                offheap_indexmap_dir=fx["idx"], kill_host=kill, device="cuda",
                log_dir=os.path.join(fx["root"], f"cluster_logs_{tag}"),
            )
            self.plane.coordinator.enable_telemetry()
            self.seconds = time.perf_counter() - t0
        except BaseException as e:  # re-raised by wait() on the phase's thread
            self.error = e

    def wait(self) -> tuple:
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"launching {self.thread.name} failed") from self.error
        return self.plane, self.seconds

    def close(self) -> None:
        """Every worker process ends, whatever failed."""
        self.thread.join()
        if self.plane is not None:
            self.plane.close()


_PLANE_LAUNCHES: list = []  # closed by main at exit, whatever failed


@functools.lru_cache(maxsize=1)
def _cluster_launches(seed: int) -> dict:
    """The cluster phase's two planes, launched side by side in the
    background: the main path's and the chaos drill's (host 1 killed after
    4 blocks). train_streaming_full_width starts them before its resident
    and stochastic fits."""
    fx = _stream_fixture(seed)
    config = _glmix_config_json(fx["root"])
    out = {"plane": PlaneLaunch(fx, config, None, "plane"),
           "chaos": PlaneLaunch(fx, config, CLUSTER_KILL, "chaos")}
    _PLANE_LAUNCHES.extend(out.values())
    return out


def phase_train_cluster_full_width(seed: int) -> dict:
    """The cluster path: train_game --streaming --hosts 2 at full width, via
    ClusterPlane.launch with two worker processes on the card over
    train_streaming_full_width's 16 part files and stores, held against the
    single-host streamed fit of the same rows; then the chaos drill (host 1
    killed after 4 blocks)."""
    import pickle

    from photon_ml_tpu_torch import streaming
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.resilience import clear_failures, recent_failures
    from photon_ml_tpu_torch.telemetry import ConvergenceTracker

    fx = _stream_fixture(seed)
    if fx not in _STREAM_FIXTURES:
        _STREAM_FIXTURES.append(fx)
    root, rows_a_file = fx["root"], fx["rows_a_file"]
    val_mem = fx["val_mem"]
    source = fx.get("source")  # the streaming phase's, its cache warm
    if source is None:
        configs = {shard: data_reader_configuration(bag) for shard, bag, _ in GLMIX_BAGS}
        source = streaming.StreamingSource.open(
            fx["data_dir"], configs, index_maps=fx["maps"], block_rows=rows_a_file,
            id_tags=("userId", "itemId"), cache_dir=os.path.join(root, "block_cache"))
    result = {"hosts": CLUSTER_HOSTS, "num_blocks": source.plan.num_blocks,
              "block_rows": rows_a_file, "fe_dim": source.plan.shard_dims["global"]}
    single = fx.get("single_host_fit")
    if single is None:
        t0 = time.perf_counter()
        single = _glmix_estimator("cuda").fit_streaming(source, validation_data=val_mem)
        result["single_host_fit_s"] = time.perf_counter() - t0
    else:
        result["single_host_fit_s"] = fx["single_host_fit_s"]
    failures = []

    def cluster_fit(plane) -> tuple:
        tracker = ConvergenceTracker(abort_on_divergence=False)
        torch.cuda.synchronize()
        launches.reset()
        t0 = time.perf_counter()
        fit = _glmix_estimator("cuda").fit_streaming(
            source, validation_data=val_mem, cluster=plane, progress=tracker)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches.counts()
        tracker.finish()
        return fit, {"fit_s": seconds, "launches": dict(counts),
                     **_pass_summary(tracker.cluster_passes)}, tracker

    def against_single(fit) -> dict:
        obj, obj_s = fit.objective_history[-1][1], single.objective_history[-1][1]
        w = fit.model.models["fixed"].coefficients.means
        w_s = single.model.models["fixed"].coefficients.means
        return {"objective_rel": abs(obj - obj_s) / abs(obj_s),
                "fe_coef_max_abs_diff": float((w - w_s).abs().max()),
                "auc_diff": abs(fit.validation_metric - single.validation_metric)}

    def gate(name, fit) -> dict:
        vs = against_single(fit)
        if not (vs["objective_rel"] <= 1e-4 and vs["fe_coef_max_abs_diff"] <= 2e-3
                and vs["auc_diff"] <= 1e-3):
            failures.append(f"the {name} cluster fit is not the single-host fit: {vs}")
        z = fit.model.score(val_mem)
        if not bool(torch.isfinite(z).all()) or z.shape != (val_mem.num_rows,):
            failures.append(f"the {name} cluster model scores non-finite or misshapen values")
        return vs

    # both planes were launched side by side in the background (their
    # workers idle, heartbeating, until used); this phase's wait for them
    planes = _cluster_launches(seed)
    _cluster_launches.cache_clear()
    try:
        t0 = time.perf_counter()
        plane, result["launch_s"] = planes["plane"].wait()
        result["launch_waited_s"] = time.perf_counter() - t0
        try:
            # the main path, cold (each worker's first pass decodes its blocks
            # into its own cache): counts set to 0 just before, read just after
            cold, result["cold"], _ = cluster_fit(plane)
            result["cold"]["vs_single_host"] = gate("cold", cold)
            result["launches_by_kernel"] = result["cold"]["launches"]
            missing = [k for k in ("fused_value_grad_batched_f32", "csr_matvec_f32")
                       if result["cold"]["launches"][k] < 1]
            if missing:
                failures.append(f"the cluster fit did not launch {missing}")
            # the warm fit (the workers' caches filled) under torch.profiler: the
            # coordinator's device idle share; its wall includes the profiler's
            held = []
            result["warm_profile"] = profile_device_idle(lambda: held.append(cluster_fit(plane)))
            warm, result["warm"], _ = held[0]
            result["warm"]["vs_single_host"] = gate("warm", warm)
            # not a gate: the warm fit's partitions follow the gap ledger the
            # cold fit left in the plane's assigner, and each host's f32
            # partial depends on its blocks (a fit on a fresh 2-host plane
            # repeats bitwise: tests/test_torch_cluster.py)
            result["cold_warm_bitwise"] = _same_fit(cold, warm)
            # the card's memory in use with the coordinator and both workers up
            result["card_memory_used_mib"] = _card_memory_used_mib()
            dim = result["fe_dim"]
            result["reply_bytes"] = len(pickle.dumps({
                "f": 0.0, "g": np.zeros(dim, np.float64),
                "block_stats": [{"block": b, "partial_loss": 0.0, "partial_grad_norm": 0.0,
                                 "gap": 0.0} for b in range(source.plan.num_blocks
                                                             // CLUSTER_HOSTS)],
                "type": "partial", "pass_id": 1, "frag": 0, "host": 0,
            }, protocol=pickle.HIGHEST_PROTOCOL))
            result["pass_message_bytes"] = len(pickle.dumps({
                "type": "pass", "pass_id": 1, "frag": 0, "w": np.zeros(dim, np.float32),
                "blocks": list(range(source.plan.num_blocks // CLUSTER_HOSTS)),
                "telemetry": True}, protocol=pickle.HIGHEST_PROTOCOL))
        finally:
            plane.close()
        result["worker_peak_device_bytes"] = _worker_peaks(plane)

        # the chaos drill: host 1 dies after streaming 4 blocks, mid-pass; its
        # blocks go to host 0 and the fit completes (warm caches)
        plane, result["chaos_launch_s"] = planes["chaos"].wait()
        clear_failures()
        try:
            chaos, result["chaos"], tracker = cluster_fit(plane)
        finally:
            plane.close()
    finally:
        # every worker process ends with the phase, whatever failed
        for launch in planes.values():
            launch.close()
    result["chaos"]["vs_single_host"] = gate("chaos", chaos)
    events = [r for r in tracker.records if r.get("kind") == "cluster"]
    lost = [e for e in events if e.get("event") == "host_lost"]
    moved = [e for e in events if e.get("event") == "blocks_reassigned"]
    ring = [f for f in recent_failures() if f.get("kind") == "cluster_host_lost"]
    result["chaos"].update(
        host_lost_events=len(lost), reassigned_blocks=sorted(
            b for e in moved for b in e.get("blocks", [])),
        failure_ring_host_lost=len(ring),
        worker_exit_codes=[p.returncode for p in plane.procs],
        worker_peak_device_bytes=_worker_peaks(plane))
    if not (len(lost) == 1 and lost[0].get("host") == CLUSTER_KILL[0] and moved
            and len(ring) == 1):
        failures.append(f"the chaos drill's events: {events}, failure ring {ring}")
    if plane.procs[CLUSTER_KILL[0]].returncode != 17:
        failures.append(f"host {CLUSTER_KILL[0]} exited {plane.procs[CLUSTER_KILL[0]].returncode}")
    result["peak_rss_gb"] = _peak_rss_gb()
    emit("train_cluster_full_width", **result)
    if failures:
        raise AssertionError(f"train_cluster_full_width gates failed: {failures}")
    return result


def data_reader_configuration(bag: str):
    """A feature shard of one bag without an intercept (the stores' shards)."""
    from photon_ml_tpu_torch.io import data_reader

    return data_reader.FeatureShardConfiguration([bag], add_intercept=False)


GRID = (2, 2)                       # data x feat
GRID_DEVICES = ("cuda:0",) * 4      # every tile on the one card
BENES_GRID = (2, 1)
BENES_GRID_SCALE = 16  # rows, columns and entities of FULL_WIDTH over 16


def _fused_tile_checks(feats, w: torch.Tensor, c: torch.Tensor) -> tuple:
    """csr_matvec_f32 and csc_rmatvec_f32 on one fused engine's own arrays
    (a grid tile) against their plain versions and float64, and their
    kernel / plain / library times and bounds at its shape."""
    from photon_ml_tpu_torch.ops import fused_perm

    n = feats.num_rows
    split = fused_perm.merge_path_split(feats.col_ptr, feats.row_idx.numel())
    row_split = fused_perm.merge_path_split(feats.row_ptr, feats.col_idx.numel())
    row_ptr, col_idx, vals = row_major_csr(feats)
    csr_kernel = lambda: fused_perm.csr_matvec_f32(  # noqa: E731
        feats.row_ptr, feats.col_idx, feats.vals, w, feats.dim, row_split, feats.row_blocks)
    csc_kernel = lambda: fused_perm.csc_rmatvec_f32(  # noqa: E731
        feats.col_ptr, feats.row_idx, feats.vals_csc, c, n, "id", split)
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), row_ptr.diff())
    prod = vals.double() * w.double()[col_idx.long()]
    z64 = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod)
    row_abs = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod.abs())
    g_plain = fused_perm.csc_rmatvec_plain(feats.col_ptr, feats.row_idx, feats.vals_csc, c)
    col_abs = fused_perm.csc_rmatvec_plain(
        feats.col_ptr, feats.row_idx, feats.vals_csc.abs(), c.abs()).double()
    checks = {
        "csr_matvec_f32": _compare(csr_kernel(),
                                   fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w),
                                   z64, row_abs, row_ptr.diff(), (n,)),
        "csc_rmatvec_f32": _compare(csc_kernel(), g_plain, g_plain.double(), col_abs,
                                    feats.col_ptr.diff(), (feats.dim,)),
    }
    csr = torch.sparse_csr_tensor(row_ptr, col_idx.long(), vals, size=(n, feats.dim))
    csr_t = torch.sparse_csr_tensor(feats.col_ptr, feats.row_idx.long(), feats.vals_csc,
                                    size=(feats.dim, n))
    times = {
        "csr_matvec_f32": cuda_ms({
            "kernel": csr_kernel,
            "plain": lambda: fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w),
            "library": lambda: torch.mv(csr, w)}, reps=10),
        "csc_rmatvec_f32": cuda_ms({
            "kernel": csc_kernel,
            "plain": lambda: fused_perm.csc_rmatvec_plain(
                feats.col_ptr, feats.row_idx, feats.vals_csc, c),
            "library": lambda: torch.mv(csr_t, c)}, reps=10),
    }
    bounds = {"csr_matvec_f32": csr_bound_ms(n, feats.nnz, feats.dim),
              "csc_rmatvec_f32": csc_bound_ms(n, feats.nnz, feats.dim)}
    out = {k: {"shape": [n, feats.dim], "nnz": feats.nnz, **kernel_times(times[k]),
               "bound_ms": bounds[k][0], "bound_by": bounds[k][1]} for k in times}
    return checks, out


def _slice_value_grad_checks(bucket, gen) -> tuple:
    """K6 at one device slice's shape of a bucket: against its plain
    version and float64, with its times."""
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import pallas_kernels

    times = value_grad_times(bucket, gen)
    vg_in = times.pop("inputs")
    ref, scale = _value_grad_f64(*vg_in, LogisticLoss)
    checks = [_compare(o, p, r, a, bucket.X.shape[1], o.shape, part=part)
              for part, o, p, r, a in zip(
                  ("value", "grad", "csum"),
                  pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss),
                  pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss), ref, scale)]
    return checks, times


class grid_layout_check:
    """Inside, on a grid: every state an FE solver step returns while
    estimators.model_training's solve runs over grid features is checked,
    field by field (each vector a BlockVector of feat blocks of d_loc, block
    j on feat column j's device; no plain tensor with a d_pad dimension),
    and a torch dispatch mode sees every tensor that solve makes (none with
    a d_pad dimension). The solver state is hooked, not the logs."""

    STEPS = (("lbfgs", "_lbfgs_step"), ("tron", "_tron_step"), ("owlqn", "_owlqn_step"))

    def __init__(self, gf):
        from photon_ml_tpu_torch.parallel.grid_features import FEAT_AXIS
        from photon_ml_tpu_torch.parallel.mesh import block_devices

        self.gf = gf
        self.want = {k: str(d) for k, d in block_devices(gf.mesh, FEAT_AXIS).items()}
        self.solves, self.steps, self.fields = 0, 0, set()
        self.bad, self.whole = [], []
        self._saved = []

    def _check(self, state) -> None:
        from photon_ml_tpu_torch.parallel.mesh import BlockVector

        self.steps += 1
        d_pad, d_loc = self.gf.dim, self.gf.d_loc
        for name, value in vars(state).items():
            if isinstance(value, torch.Tensor):
                if d_pad in value.shape:
                    self.bad.append((name, "whole", list(value.shape)))
            elif isinstance(value, BlockVector):
                self.fields.add(name)
                got = {k: str(b.device) for k, b in value.blocks.items()}
                if (value.axis != "feat" or got != self.want
                        or any(b.shape[-1] != d_loc for b in value.blocks.values())):
                    self.bad.append((name, value.axis, {k: [list(b.shape), str(b.device)]
                                                        for k, b in value.blocks.items()}))

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        from photon_ml_tpu_torch.estimators import model_training
        from photon_ml_tpu_torch.opt import lbfgs, owlqn, tron
        from photon_ml_tpu_torch.parallel.grid_features import GridShardedFeatures

        check, d_pad = self, self.gf.dim

        class whole(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor) and d_pad in t.shape:
                        check.whole.append((str(func), list(t.shape)))
                return out

        modules = {"lbfgs": lbfgs, "tron": tron, "owlqn": owlqn}
        for mod, name in self.STEPS:
            step = getattr(modules[mod], name)

            def checked(*args, _step=step, **kwargs):
                state = _step(*args, **kwargs)
                if check.solving:
                    check._check(state)
                return state

            self._saved.append((modules[mod], name, step))
            setattr(modules[mod], name, checked)
        real_solve = model_training.solve
        self.solving = False

        def solve(objective, w0, data, *args, **kwargs):
            if not isinstance(data.features, GridShardedFeatures):
                return real_solve(objective, w0, data, *args, **kwargs)
            check.solves += 1
            check.solving = True
            try:
                with whole():
                    return real_solve(objective, w0, data, *args, **kwargs)
            finally:
                check.solving = False

        self._saved.append((model_training, "solve", real_solve))
        model_training.solve = solve
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)

    @property
    def ok(self) -> bool:
        return (self.solves > 0 and self.steps > 0 and not self.bad and not self.whole
                and {"w", "g"} <= self.fields)

    def summary(self) -> dict:
        return {"solves": self.solves, "steps": self.steps, "d_pad": self.gf.dim,
                "d_loc": self.gf.d_loc, "block_devices": self.want,
                "block_fields": sorted(self.fields), "bad_fields": self.bad[:8],
                "whole_tensors": len(self.whole), "whole_examples": self.whole[:8],
                "ok": self.ok}


def _grid_tron_layout(grid_fe, single_fe, gf) -> dict:
    """A TRON solve (5 iterations, L2 lambda 1) of the grid's fixed effect
    under the layout check, against the same solve of the single-device
    fixed effect: objective rtol 1e-4."""
    from photon_ml_tpu_torch.estimators.model_training import train_glm
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, OptimizerType, RegularizationContext)
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    cfg = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(optimizer=OptimizerType.TRON, max_iterations=5),
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    task = TaskType.LOGISTIC_REGRESSION
    with grid_layout_check(gf) as layout:
        t0 = time.perf_counter()
        grid = train_glm(grid_fe.data, task, cfg)[0]
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = train_glm(single_fe.data, task, cfg)[0]
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    value, ref = float(grid.result.value[0]), float(one.result.value[0])
    rel = abs(value - ref) / abs(ref)
    return {**layout.summary(), "objective": value, "single_device_objective": ref,
            "objective_rel": rel, "iterations": int(grid.result.iterations[0]),
            "solve_s": grid_s, "single_device_solve_s": one_s,
            "ok": layout.ok and rel <= 1e-4}


def phase_train_grid_full_width(seed: int) -> dict:
    """The grid path: train_full_width's GLMix fit on a 2 x 2 grid of fused tiles
    (every tile on the one card) with the per-user and per-item entity
    blocks split over the grid's 4 devices, held against train_full_width's
    single-device fit; twice (bitwise), and on the host score plane; the
    kernels at the tile and slice shapes; a 2 x 1 Benes grid at 2^16 rows;
    the one-card refusal of a 2 x 2 grid of distinct cards."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.estimators.game import ParallelConfiguration
    from photon_ml_tpu_torch.ops import launches

    mem = _in_memory_glmix_fit(seed)
    train, val, single = mem["train"], mem["val"], mem["fit"]
    n_dev = GRID[0] * GRID[1]
    result = {"grid": list(GRID), "devices": list(GRID_DEVICES), "engine": "fused"}
    failures = []
    parallel = ParallelConfiguration(*GRID, engine="fused", devices=GRID_DEVICES)
    estimator = _glmix_estimator("cuda", parallel=parallel)
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    result["build_coordinates_s"] = time.perf_counter() - t0
    gf = coords["fixed"].data.features
    result["padded_shape"] = [gf.num_rows, gf.dim]
    result["tile_shape"] = [gf.n_loc, gf.d_loc]

    # the main path: counts set to 0 just before, read just after
    result["allocated_before_fit_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    fit = estimator.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    result["fit_s"] = time.perf_counter() - t0
    counts = launches.counts()
    result["launches"] = {k: counts[k] for k in KERNELS}
    result["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if min(result["launches"].values()) < 1:
        failures.append(f"the grid fit did not launch {result['launches']}")
    # the repeat, under the layout check (its dispatch mode costs the FE
    # solve some host time: fit_again_s is not the fit's time)
    with grid_layout_check(gf) as layout:
        t0 = time.perf_counter()
        again = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        result["fit_again_s"] = time.perf_counter() - t0
    result["bitwise_repeat"] = _same_fit(fit, again)
    if not result["bitwise_repeat"]:
        failures.append("two grid fits differ")
    result["layout_fit"] = layout.summary()
    if not (layout.ok and {"s_hist", "y_hist"} <= layout.fields):
        failures.append(f"the grid fit's FE state is not in feat blocks: {layout.summary()}")
    placed = {}
    for cid in ("per_user", "per_item"):
        for b, bucket in enumerate(coords[cid].dataset.buckets):
            placed[f"{cid}/{b}"] = [[list(sl.X.shape), str(sl.X.device)]
                                    for _, sl in bucket.local()]
            if len(bucket.local()) != n_dev or bucket.per_slice * n_dev != bucket.num_entities:
                failures.append(f"{cid} bucket {b} is not in {n_dev} placed slices")
    result["re_slices"] = placed
    result["tron_layout"] = _grid_tron_layout(coords["fixed"], mem["coords"]["fixed"], gf)
    if not result["tron_layout"]["ok"]:
        failures.append(f"the grid TRON solve: {result['tron_layout']}")

    def against(a, b, data=val) -> dict:
        obj_a, obj_b = a.objective_history[-1][1], b.objective_history[-1][1]
        wa = a.model.models["fixed"].coefficients.means
        wb = b.model.models["fixed"].coefficients.means
        return {"objective_rel": abs(obj_a - obj_b) / abs(obj_b),
                "fe_coef_max_abs_diff": float((wa - wb).abs().max()) if wa.shape == wb.shape
                else float("inf"),
                "score_max_abs_diff": float((a.model.score(data) - b.model.score(data))
                                            .abs().max()),
                "auc_diff": abs(a.validation_metric - b.validation_metric)}

    result["vs_single_device"] = vs = against(fit, single)
    if not (vs["objective_rel"] <= 1e-4 and vs["fe_coef_max_abs_diff"] <= 5e-3
            and vs["score_max_abs_diff"] <= 1e-2 and vs["auc_diff"] <= 1e-4):
        failures.append(f"the grid fit is not the single-device fit: {vs}")

    # the host score plane (what multi-process runs use) against the device plane
    host_est = _glmix_estimator("cuda", parallel=parallel, score_plane="host")
    t0 = time.perf_counter()
    host = host_est.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    result["host_plane_fit_s"] = time.perf_counter() - t0
    result["host_plane_vs_device_plane"] = vh = against(host, fit)
    result["host_plane_bitwise"] = _same_fit(host, fit)
    result["host_plane_transfers"] = host_est.last_transfer_stats.snapshot()
    if not (vh["objective_rel"] <= 1e-4 and vh["fe_coef_max_abs_diff"] <= 5e-3
            and vh["score_max_abs_diff"] <= 1e-2 and vh["auc_diff"] <= 1e-4):
        failures.append(f"the host-plane grid fit is off the device plane: {vh}")

    # the kernels at the tile and slice shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tile = gf.shards[0][0]
    w_pad = torch.nn.functional.pad(fit.model.models["fixed"].coefficients.means,
                                    (0, gf.dim - train.feature_shards["global"].dim))
    checks, kernels = _fused_tile_checks(
        tile, w_pad[: gf.d_loc].contiguous(),
        torch.randn(gf.n_loc, generator=gen, device="cuda"))
    slice0 = coords["per_user"].dataset.buckets[0].slices[0]
    result["slice_shape"] = list(slice0.X.shape)
    vg_checks, vg_times = _slice_value_grad_checks(slice0, gen)
    checks["fused_value_grad_batched_f32"] = vg_checks
    kernels["fused_value_grad_batched_f32"] = vg_times
    for k in KERNELS:
        kernels[k]["launches"] = counts[k]
    result["tile_kernel_checks"] = checks
    result["kernels"] = kernels
    if not all(c["ok"] for c in (checks["csr_matvec_f32"], checks["csc_rmatvec_f32"],
                                 *checks["fused_value_grad_batched_f32"])):
        failures.append("a kernel disagrees with its plain version at a tile or slice shape")

    # a 2 x 1 grid of Benes tiles at FULL_WIDTH over 16 (2^16 rows, 2^20
    # columns: the same rows to columns and nonzeros a row; cold routing at
    # full width costs minutes): its fit against the same rows'
    # single-device fit on the fused engine (the same maps), and the
    # shuffle kernels at a tile network's stage shapes
    n_b, nv_b, fe_dim_b, fe_k, users, items = FULL_WIDTH
    k = BENES_GRID_SCALE
    n_b, nv_b, fe_dim_b, users, items = n_b // k, nv_b // k, fe_dim_b // k, users // k, items // k
    btrain, bval = make_glmix_training(seed + 1, n_b, nv_b, fe_dim_b, fe_k, users, items)
    bpar = ParallelConfiguration(*BENES_GRID, engine="benes", devices=GRID_DEVICES[:2])
    t0 = time.perf_counter()
    bcoords = _glmix_estimator("cuda", parallel=bpar).build_coordinates(btrain)
    torch.cuda.synchronize()
    result["benes_build_coordinates_s"] = time.perf_counter() - t0
    launches.reset()
    t0 = time.perf_counter()
    bfit = _glmix_estimator("cuda", parallel=bpar).fit(btrain, bval, coordinates=bcoords)
    torch.cuda.synchronize()
    result["benes_fit_s"] = time.perf_counter() - t0
    bcounts = launches.counts()
    bsingle = _glmix_estimator("cuda", fe_engine="fused").fit(btrain, bval)
    result["benes_vs_single_device"] = vb = against(bfit, bsingle, bval)
    if not (vb["objective_rel"] <= 1e-4 and vb["fe_coef_max_abs_diff"] <= 5e-3
            and vb["score_max_abs_diff"] <= 1e-2 and vb["auc_diff"] <= 1e-4):
        failures.append(f"the Benes grid fit is not the single-device fit: {vb}")
    btile = bcoords["fixed"].data.features.shards[0][0]
    block = next(b for b in getattr(btile, "blocks", (btile,)) if hasattr(b, "plan"))
    plan = block.plan
    v = torch.randn(plan.size // 128, 128, generator=gen, device="cuda")
    stages = list(zip([k for k in plan.kinds if k[0] in ("lane", "sublane")], plan.idx))
    lane_idx = next(i for k, i in stages if k[0] == "lane")
    sub_kind, sub_idx = next((k, i) for k, i in stages if k[0] == "sublane" and k[1] > 1)
    shuffles = {"lane_shuffle_f32": shuffle_times(v, lane_idx, 0),
                "sublane_shuffle_f32": shuffle_times(v, sub_idx, sub_kind[1])}
    for g in plan.groups:
        if g.kernel not in shuffles:
            shuffles[g.kernel] = group_times(g, v)
    bpath = plan_kernels(bcoords["fixed"].data.features)
    for name, k in shuffles.items():
        k["launches"] = bcounts[name]
        if not k["bitwise_equal"] or (name in bpath and bcounts[name] < 1):
            failures.append(f"{name} at the Benes tile: launches {bcounts[name]}, "
                            f"bitwise {k['bitwise_equal']}")
    bplan = plan_times(plan, gen)
    if not bplan["bitwise_equal_to_stage_by_stage"]:
        failures.append(f"the Benes tile's plan differs from its stage-by-stage plan: {bplan}")
    # the path's launches: the fused grid's fit, the Benes grid's shuffles
    result["launches_by_kernel"] = {**counts, **{k: bcounts[k] for k in SHUFFLES}}
    bgf = bcoords["fixed"].data.features
    result["benes"] = {"rows": n_b, "fe_dim": fe_dim_b + 1,
                       "padded_shape": [bgf.num_rows, bgf.dim],
                       "launches": {k: bcounts[k] for k in SHUFFLES + KERNELS},
                       "path_kernels": bpath, "kernels": shuffles, "plan": bplan}

    # a grid of 4 distinct cards on a one-card machine is refused, by the
    # estimator and the CLI, as the JAX package refuses it
    refusals = {}
    if torch.cuda.device_count() < n_dev:
        for name, call in (
            ("estimator", lambda: ParallelConfiguration(*GRID, engine="fused").build_mesh()),
            ("train_game", lambda: train_game.run(train_game.parse_args([
                "--train-data-dirs", os.path.join(RATINGS, "train"),
                "--coordinate-config", ratings_config(tempfile.gettempdir()),
                "--task", "LINEAR_REGRESSION", "--output-dir",
                os.path.join(tempfile.gettempdir(), "chip_smoke_grid_refusal"),
                "--parallel-data", str(GRID[0]), "--parallel-feat", str(GRID[1])]))),
        ):
            try:
                call()
                refusals[name] = "not refused"
            except ValueError as e:
                refusals[name] = str(e)
        want = f"need {n_dev} devices, have {torch.cuda.device_count()}"
        if any(r != want for r in refusals.values()):
            failures.append(f"the one-card refusals: {refusals}")
    result["refusals"] = refusals
    emit("train_grid_full_width", **result)
    if failures:
        raise AssertionError(f"train_grid_full_width gates failed: {failures}")
    return result


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two f32 tensors, NaN padding included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_fe_bf16_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import fused_perm, launches
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.opt.solve import solve
    from photon_ml_tpu_torch.types import RegularizationType

    n, n_val, fe_dim, fe_k = 1 << 20, 1 << 18, 1 << 24, 16
    t0 = time.perf_counter()
    train, _ = make_glmix_training(seed, n, n_val, fe_dim, fe_k, 65_536, 16_384)
    data_s = time.perf_counter() - t0
    shard = train.feature_shards["global"]
    labels = torch.from_numpy(train.labels).cuda()
    engines, build_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        engines[dtype] = fused_perm.from_coo(shard.rows, shard.cols, shard.vals,
                                             (n, shard.dim), payload_dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        build_s[dtype] = time.perf_counter() - t0
    bf = engines["bfloat16"]
    emit("fe_bf16_full_width", build_s=build_s, layout=bf.layout)  # before the checks
    data = {dtype: LabeledData.create(f, labels) for dtype, f in engines.items()}
    objective = make_glm_objective(LogisticLoss)
    cfg = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(max_iterations=50),
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1.0,
    )
    w0 = torch.zeros(1, shard.dim, device="cuda")
    # each engine's first maps load its kernels (an nvcc build when the
    # build phase did not run) and make its CSC split: not solve time
    for f in engines.values():
        f.matvec(w0[0])
        f.rmatvec(labels)
    torch.cuda.synchronize()

    def timed_solve(dtype):
        t0 = time.perf_counter()
        res = solve(objective, w0, data[dtype], cfg)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    r32, solve32_s = timed_solve("float32")
    # the main path: counts set to 0 just before, read just after
    launches.reset()
    r16, solve16_s = timed_solve("bfloat16")
    counts = launches.counts()
    # the matvec takes both entry sets in one csr_matvec_bf16 pass; the
    # rmatvec the rounded set by csc_rmatvec_bf16, the exact by csc_rmatvec_f32
    path = BF16_KERNELS + ("csc_rmatvec_f32",)
    missing = [k for k in path if counts[k] < 1]
    if missing:
        raise AssertionError(f"the bf16 solve did not launch {missing}: {counts}")

    # the reference's quality gate: the exact objective at the bf16 solution
    f32_final = float(r32.value[0])
    f32_at_bf16 = float(objective.value(r16.w[0], data["float32"], 1.0))
    gate_rel = abs(f32_at_bf16 - f32_final) / abs(f32_final)
    launches.reset()
    with plain_versions(path):
        r16_plain, plain_solve_s = timed_solve("bfloat16")
    if any(launches.counts()[k] for k in path):
        raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
    plain_rel = abs(float(r16.value[0]) - float(r16_plain.value[0])) / abs(float(r16.value[0]))
    r16_again, _ = timed_solve("bfloat16")
    bitwise = (_bits_equal(r16.value_history, r16_again.value_history)
               and _bits_equal(r16.w, r16_again.w))
    checks = {"f32_objective": f32_final, "f32_objective_at_bf16_solution": f32_at_bf16,
              "quality_gate_rel": gate_rel, "bf16_objective": float(r16.value[0]),
              "plain_bf16_objective": float(r16_plain.value[0]), "kernel_vs_plain_rel": plain_rel,
              "two_bf16_solves_bitwise_equal": bitwise}
    if not (np.isfinite(f32_at_bf16) and gate_rel <= 1e-4 and plain_rel <= 1e-4 and bitwise):
        raise AssertionError(f"the bf16 solve fails its checks: {checks}")

    # one map of each engine, and the kernels at the rounded set's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = r16.w[0].contiguous()
    c = torch.randn(n, generator=gen, device="cuda")
    f32 = engines["float32"]
    engine_ms = cuda_ms({
        "bf16_matvec": lambda: bf.matvec(w), "f32_matvec": lambda: f32.matvec(w),
        "bf16_exact_set_matvec": lambda: bf.exact.matvec(w),
        "bf16_rmatvec": lambda: bf.rmatvec(c), "f32_rmatvec": lambda: f32.rmatvec(c),
    }, reps=10)
    dim, nnz = bf.dim, bf.vals.numel()  # the CSR copy: both entry sets
    split = fused_perm.merge_path_split(bf.col_ptr, bf.row_idx.numel())
    row_split = fused_perm.merge_path_split(bf.row_ptr, nnz)
    csr_kernel = lambda: fused_perm.csr_matvec_bf16(  # noqa: E731
        bf.row_ptr, bf.col_idx, bf.vals, w, dim, row_split, bf.row_blocks)
    row_ptr, col_idx, vals = row_major_csr(bf)
    exact = col_idx < 0  # the exact set's entries, stored as ~col
    col_real = torch.where(exact, ~col_idx, col_idx).long()
    csr = torch.sparse_csr_tensor(row_ptr, col_real, vals, size=(n, dim))
    csr_t = torch.sparse_csr_tensor(bf.col_ptr, bf.row_idx.long(), bf.vals_csc, size=(dim, n))
    times = {
        "csr_matvec_bf16": cuda_ms({
            "kernel": csr_kernel,
            "plain": lambda: fused_perm.csr_matvec_bf16_plain(row_ptr, col_idx, vals, w),
            "library": lambda: torch.mv(csr, w),
            **sequential_cols(fused_perm.csr_matvec_bf16, bf, w),
        }),
        "csc_rmatvec_bf16": cuda_ms({
            "kernel": lambda: fused_perm.csc_rmatvec_bf16(
                bf.col_ptr, bf.row_idx, bf.vals_csc, c, n, "id", split),
            "plain": lambda: fused_perm.csc_rmatvec_bf16_plain(
                bf.col_ptr, bf.row_idx, bf.vals_csc, c),
            "library": lambda: torch.mv(csr_t, c),
        }),
    }
    # each kernel against its plain version and float64 on the inputs timed
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), row_ptr.diff())
    w_terms = torch.where(exact, w[col_real], w.to(torch.bfloat16).float()[col_real])
    prod = vals.double() * w_terms.double()
    z64 = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod)
    row_abs = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod.abs())
    cols = torch.repeat_interleave(torch.arange(dim, device="cuda"), bf.col_ptr.diff())
    terms = (bf.vals_csc * c[bf.row_idx.long()]).to(torch.bfloat16).double()
    g64 = torch.zeros(dim, dtype=torch.float64, device="cuda").index_add_(0, cols, terms)
    col_abs = torch.zeros(dim, dtype=torch.float64, device="cuda").index_add_(0, cols, terms.abs())
    main_checks = {
        "csr_matvec_bf16": _compare(
            csr_kernel(),
            fused_perm.csr_matvec_bf16_plain(row_ptr, col_idx, vals, w),
            z64, row_abs, row_ptr.diff(), (n,)),
        "csc_rmatvec_bf16": _compare(
            fused_perm.csc_rmatvec_bf16(bf.col_ptr, bf.row_idx, bf.vals_csc, c, n, "id", split),
            fused_perm.csc_rmatvec_bf16_plain(bf.col_ptr, bf.row_idx, bf.vals_csc, c),
            g64, col_abs, bf.col_ptr.diff(), (dim,)),
    }
    if not all(case["ok"] for case in main_checks.values()):
        raise AssertionError(f"bf16 kernels disagree at the main path's shapes: {main_checks}")
    bounds = {"csr_matvec_bf16": csr_bound_ms(n, nnz, dim),
              "csc_rmatvec_bf16": csc_bound_ms(n, bf.row_idx.numel(), dim)}
    kernels = {
        k: {"launches": counts[k], **kernel_times(times[k]), "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1]}
        for k in BF16_KERNELS
    }
    kernels["csr_matvec_bf16"].update(
        sequential_cols_device_ms=times["csr_matvec_bf16"]["sequential_device"],
        flushed_ms=flushed_ms(csr_kernel))
    result = {
        "rows": n, "fe_dim": dim, "rounded_nnz": bf.vals_csc.numel(), "exact_nnz": bf.exact.nnz,
        "layout": bf.layout, "data_s": data_s, "build_s": build_s,
        "solve_s": {"float32": solve32_s, "bfloat16": solve16_s,
                    "bfloat16_plain_versions": plain_solve_s},
        "iterations": {"float32": int(r32.iterations[0]), "bfloat16": int(r16.iterations[0])},
        **checks, "launches": counts, "engine_ms": engine_ms, "kernels": kernels,
        "main_path_kernel_checks": main_checks,
        "bf16_solve_profile": profile_device_idle(lambda: solve(objective, w0, data["bfloat16"],
                                                                cfg)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("fe_bf16_full_width", **result)
    return result


class routing_seconds:
    """Within the block, host seconds spent building routing plans
    (``sparse_perm._build_plan_cached``: the colorer, the stage arrays and
    the plan-cache write): ``seconds`` the wall they cover (the union of
    their intervals: a column split routes its networks on a thread each),
    ``thread_seconds`` their sum."""

    def __enter__(self):
        from photon_ml_tpu_torch.ops import sparse_perm

        self.plans, self._spans = 0, []
        self._lock = threading.Lock()
        self._saved = sparse_perm._build_plan_cached

        def timed(perm, cache_dir):
            t0 = time.perf_counter()
            try:
                return self._saved(perm, cache_dir)
            finally:
                with self._lock:
                    self._spans.append((t0, time.perf_counter()))
                    self.plans += 1

        sparse_perm._build_plan_cached = timed
        return self

    @property
    def thread_seconds(self) -> float:
        return sum(b - a for a, b in self._spans)

    @property
    def seconds(self) -> float:
        wall, end = 0.0, float("-inf")
        for a, b in sorted(self._spans):
            wall += max(0.0, b - max(a, end))
            end = max(end, b)
        return wall

    def __exit__(self, *exc):
        from photon_ml_tpu_torch.ops import sparse_perm

        sparse_perm._build_plan_cached = self._saved


def benes_layout(feats) -> dict:
    """What the layout planner chose for a Benes engine, and its bytes on
    the device."""
    from photon_ml_tpu_torch.ops import sparse_perm

    split = isinstance(feats, sparse_perm.ColumnSplitFeatures)
    blocks = feats.blocks if split else (feats,)
    engines = [b for b in blocks if isinstance(b, sparse_perm.BenesSparseFeatures)]
    tensors = [feats.hot_matrix, feats.hot_cols] if split else []
    for b in engines:
        tensors += [b.ell_values, b.csc_values, b.hot_matrix, b.hot_cols, b.spill_rows,
                    b.spill_cols, b.spill_vals, *b.plan.idx, *b.plan_inv.idx]
    spill = [0 if b.spill_rows is None else b.spill_rows.numel() for b in engines]
    return {
        "engine": type(feats).__name__,
        "column_blocks": len(blocks),
        "empty_blocks": len(blocks) - len(engines),
        "kp_cap": [b.csc_k if s else None for b, s in zip(engines, spill)],
        "ell_k": [b.ell_k for b in engines],
        "spill_entries": spill,
        "hot_columns": 0 if feats.hot_cols is None else int(feats.hot_cols.numel()),
        "network_slots": [b.plan.size for b in engines],
        "stages_per_plan": [len(b.plan.kinds) for b in engines],
        "lane_stages_per_plan": [sum(k[0] == "lane" for k in b.plan.kinds) for b in engines],
        "sublane_stages_per_plan": [[k[1] for k in b.plan.kinds if k[0] == "sublane"]
                                    for b in engines],
        "device_bytes": sum(t.numel() * t.element_size() for t in tensors if t is not None),
    }


def _summaries_agree(a, b) -> dict:
    """Two summaries of one shard: mean within 1e-5 of the column's mean
    |x| (f32 sums of a few terms of either sign, in another order),
    variance rtol 1e-4, min / max / nonzero counts / count exactly."""
    mean_err = float(((a.mean - b.mean).abs() / torch.clamp(b.mean_abs, min=1e-30)).max())
    var_err = float(((a.variance - b.variance).abs()
                     / torch.clamp(b.variance.abs(), min=1e-30)).max())
    exact = {k: bool(torch.equal(getattr(a, k), getattr(b, k)))
             for k in ("num_nonzeros", "min_val", "max_val", "count")}
    return {"mean_err_rel_mean_abs": mean_err, "variance_rel_err": var_err, "exact": exact,
            "ok": mean_err <= 1e-5 and var_err <= 1e-4 and all(exact.values())}


BENES_DEPTH = (1 << 18, 1 << 16)  # rows, held-out: full width, a quarter of the depth


def _benes_data(seed: int):
    n, n_val = BENES_DEPTH
    return make_glmix_training(seed, n, n_val, 1 << 24, 16, 65_536, 16_384)


def _benes_route_job(job) -> dict:
    """In a spawned process (nice 19): the phase's training and held-out FE
    shards routed cold into the empty plan cache ``dir`` (the engines built
    on the host; plans do not depend on the device), with the seconds of
    each build and of its routing."""
    seed, plan_dir = job
    os.environ["PHOTON_ML_TPU_TORCH_PLAN_CACHE"] = plan_dir
    train, val = _benes_data(seed)
    build = {}
    for name, data in (("train", train), ("validation", val)):
        with routing_seconds() as rs:
            t0 = time.perf_counter()
            data.sparse_features("global", engine="benes", device="cpu")
            total = time.perf_counter() - t0
        build[name] = {"rows": data.num_rows, "build_s": total, "routing_s": rs.seconds,
                       "routing_thread_s": rs.thread_seconds, "plans": rs.plans}
    return {"cold": build}


def _benes_prep(seed: int) -> SpawnPrep:
    """train_benes_full_width's routing plans, routed cold in the background
    (_benes_route_job) from the end of the build phase on."""
    if ("benes", seed) not in _SPAWN_PREPS:
        _SPAWN_PREPS["benes", seed] = SpawnPrep(
            "chip_smoke_benes_", _benes_route_job, seed, "plans")
    return _SPAWN_PREPS["benes", seed]


def phase_train_benes_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.normalization import build_normalization_context
    from photon_ml_tpu_torch.ops import launches, sparse_perm
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.stat.summary import summarize
    from photon_ml_tpu_torch.types import NormalizationType

    n, n_val, fe_dim, fe_k = BENES_DEPTH[0], BENES_DEPTH[1], 1 << 24, 16
    t0 = time.perf_counter()
    train, val = _benes_data(seed)
    data_s = time.perf_counter() - t0

    # the engines: routed cold into an empty plan cache by a background
    # process (its seconds under "cold"), then built here on the card from
    # that cache
    prep = _benes_prep(seed)
    cold = prep.wait()
    plan_dir = prep.dir
    saved_env = os.environ.get("PHOTON_ML_TPU_TORCH_PLAN_CACHE")
    os.environ["PHOTON_ML_TPU_TORCH_PLAN_CACHE"] = plan_dir
    try:
        build = {"cold": cold["cold"], "prep_s": cold["prep_s"],
                 "prep_waited_s": cold["prep_waited_s"]}
        for name, data in (("train", train), ("validation", val)):
            with routing_seconds() as rs:
                t0 = time.perf_counter()
                feats_of = data.sparse_features("global", engine="benes", device="cuda")
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
            # every plan comes from the cache: its lookups' wall and count
            build[name] = {"rows": data.num_rows, "build_s": total,
                           "plan_cache_s": rs.seconds, "plans": rs.plans,
                           "rest_of_build_s": total - rs.seconds,
                           "layout": benes_layout(feats_of),
                           "host_peak_rss_gb_so_far": resource.getrusage(
                               resource.RUSAGE_SELF).ru_maxrss / 2**20}
    finally:
        if saved_env is None:
            os.environ.pop("PHOTON_ML_TPU_TORCH_PLAN_CACHE", None)
        else:
            os.environ["PHOTON_ML_TPU_TORCH_PLAN_CACHE"] = saved_env
        prep.close()
    emit("train_benes_full_width", engine_build=build)  # before the checks that may fail
    feats = train.sparse_features("global", engine="benes", device="cuda")
    t0 = time.perf_counter()
    fused = train.sparse_features("global", engine="fused", device="cuda")
    torch.cuda.synchronize()
    fused_build_s = time.perf_counter() - t0

    # the FE shard's statistics through both engines, and the context
    labels = torch.from_numpy(train.labels).cuda()
    weights = torch.from_numpy(train.weights).cuda()
    t0 = time.perf_counter()
    summary = summarize(LabeledData.create(feats, labels, weights=weights))
    torch.cuda.synchronize()
    summary_s = time.perf_counter() - t0
    fused_summary = summarize(LabeledData.create(fused, labels, weights=weights))
    summaries = _summaries_agree(summary, fused_summary)
    if not summaries["ok"]:
        raise AssertionError(f"Benes and fused summaries of the FE shard differ: {summaries}")
    ctx = build_normalization_context(NormalizationType.STANDARDIZATION, summary.mean,
                                      summary.variance, summary.max_abs, fe_dim)
    norm_kw = {"normalization": {"global": ctx}, "intercept_indices": {"global": fe_dim}}

    estimator = _glmix_estimator("cuda", fe_engine="benes", **norm_kw)
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    build_coordinates_s = time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    t0 = time.perf_counter()
    fit = estimator.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launches.counts()
    path = plan_kernels(feats) + ["fused_value_grad_batched_f32"]
    missing = [k for k in path if counts[k] < 1]
    if missing:
        raise AssertionError(f"the Benes fit did not launch {missing}: {counts}")

    def history(f):
        return [v for _, v in f.objective_history]

    again = estimator.fit(train, val, coordinates=coords)
    launches.reset()
    with plain_versions(SHUFFLES):
        t0 = time.perf_counter()
        plain_fit = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        plain_fit_s = time.perf_counter() - t0
    if any(launches.counts()[k] for k in SHUFFLES):
        raise AssertionError(f"the plain run launched shuffle kernels: {launches.counts()}")
    for name, other in (("plain", plain_fit), ("again", again)):
        if history(other) != history(fit) or other.validation_metric != fit.validation_metric:
            raise AssertionError(
                f"the Benes fit and its {name} run differ: {history(fit)} {fit.validation_metric}"
                f" vs {history(other)} {other.validation_metric}")

    # the fused engine under the same normalization (same RE datasets)
    fused_estimator = _glmix_estimator("cuda", fe_engine="fused", **norm_kw)
    fused_coords = dict(coords)
    fe = coords["fixed"]
    fused_coords["fixed"] = dataclasses.replace(
        fe, data=dataclasses.replace(fe.data, features=fused))
    fused_fit = fused_estimator.fit(train, val, coordinates=fused_coords)
    obj_rel = max(abs(a - b) / abs(b) for a, b in zip(history(fit), history(fused_fit)))
    auc_diff = abs(fit.validation_metric - fused_fit.validation_metric)
    if not (np.isfinite(fit.validation_metric) and obj_rel <= 1e-4 and auc_diff <= 1e-4):
        raise AssertionError(f"Benes and fused fits differ: objective rel {obj_rel}, "
                             f"AUC {auc_diff}")

    # each shuffle kernel at the first network's own stage shapes and indices
    block = next(b for b in getattr(feats, "blocks", (feats,))
                 if isinstance(b, sparse_perm.BenesSparseFeatures))
    plan = block.plan
    m = plan.size // 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(m, 128, generator=gen, device="cuda")
    stages = list(zip([k for k in plan.kinds if k[0] in ("lane", "sublane")], plan.idx))
    lane_idx = next(i for k, i in stages if k[0] == "lane")
    sub_kind, sub_idx = next((k, i) for k, i in stages if k[0] == "sublane" and k[1] > 1)
    kernels = {
        "lane_shuffle_f32": shuffle_times(v, lane_idx, 0),
        "sublane_shuffle_f32": shuffle_times(v, sub_idx, sub_kind[1]),
    }
    # the plan's own launches: each group at its shape, the whole plan
    for g in plan.groups:
        if g.kernel not in kernels:
            kernels[g.kernel] = group_times(g, v)
    for name, k in kernels.items():
        if not k["bitwise_equal"]:
            raise AssertionError(f"{name} differs from its plain version at the plan's shapes")
        k["launches"] = counts[name]
    whole_plan = plan_times(plan, gen)
    if not whole_plan["bitwise_equal_to_stage_by_stage"]:
        raise AssertionError(f"the plan differs from its stage-by-stage plain plan: {whole_plan}")

    # one map of each engine at the same data
    w = fit.model.models["fixed"].coefficients.means
    c = torch.randn(n, generator=gen, device="cuda")
    engines = cuda_ms({
        "benes_matvec": lambda: feats.matvec(w), "fused_matvec": lambda: fused.matvec(w),
        "benes_rmatvec": lambda: feats.rmatvec(c), "fused_rmatvec": lambda: fused.rmatvec(c),
    }, reps=10)
    launches.reset()
    feats.matvec(w)
    per_matvec = launches.counts()

    # device idle share of one FE solve (warm start)
    fe_solve = profile_device_idle(
        lambda: coords["fixed"].update_model_device(fit.model.models["fixed"],
                                                    torch.zeros(n, device="cuda")))
    result = {
        "rows": n, "validation_rows": n_val, "fe_dim": feats.dim, "data_s": data_s,
        "engine_build": build, "fused_build_s": fused_build_s, "summary_s": summary_s,
        "summaries_benes_vs_fused": summaries,
        "build_coordinates_s": build_coordinates_s, "fit_s": fit_s, "plain_fit_s": plain_fit_s,
        "seconds_per_coordinate": fit.update_seconds,
        "objective_history": fit.objective_history,
        "fused_objective_history": fused_fit.objective_history,
        "objective_rel_diff_vs_fused": obj_rel,
        "validation_auc": fit.validation_metric,
        "fused_validation_auc": fused_fit.validation_metric, "auc_diff_vs_fused": auc_diff,
        "bitwise_equal_to_plain_and_to_itself": True,
        "launches": counts, "launches_per_benes_matvec": per_matvec,
        "kernels": kernels, "plan": whole_plan, "path_kernels": path,
        "engine_ms": engines, "fe_solve_profile": fe_solve,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("train_benes_full_width", **result)
    return result


def ratings_config(root: str, fe_engine: str = "auto", fe_only_tron: bool = False,
                   full_game: bool = False) -> str:
    """The ratings fixture's GLMix config (FE with L-BFGS on ``fe_engine`` +
    per_user + per_movie), written under ``root``; ``fe_only_tron``: the
    reference's golden FE-only config instead (the FE alone, on TRON,
    tests/test_golden_fixture.py); ``full_game``: also a factored
    coordinate over userId on the per_user shard (k = 2, one MF iteration,
    L2 lambda 5; the JAX package's tests/test_cli.py TestFullGameCli)."""
    optimizer = {"optimizer": "LBFGS", "regularization": "L2"}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_movie": {"feature_bags": ["movieFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global", "sparse_engine": fe_engine,
                      "optimizer": {**optimizer, "regularization_weight": 10.0}},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "optimizer": {**optimizer, "regularization_weight": 1.0}},
            "per_movie": {"type": "random", "feature_shard": "per_movie",
                          "random_effect_type": "movieId",
                          "optimizer": {**optimizer, "regularization_weight": 1.0}},
        },
        "update_order": ["fixed", "per_user", "per_movie"],
    }
    if fe_only_tron:
        cfg["coordinates"] = {"fixed": cfg["coordinates"]["fixed"]}
        cfg["coordinates"]["fixed"]["optimizer"]["optimizer"] = "TRON"
        cfg["update_order"] = ["fixed"]
    if full_game:
        cfg["coordinates"]["factored"] = {
            "type": "factored_random", "feature_shard": "per_user",
            "random_effect_type": "userId", "mf": {"num_latent_factors": 2, "num_iterations": 1},
            "optimizer": {**optimizer, "regularization_weight": 5.0}}
        cfg["update_order"].append("factored")
    name = f"game_{fe_engine}{'_fe_tron' if fe_only_tron else ''}{'_full' if full_game else ''}"
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_train_game_cli(seed: int) -> dict:
    from photon_ml_tpu_torch.cli import score_game, train_game
    from photon_ml_tpu_torch.ops import launches

    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        std = ("--normalization-type", "STANDARDIZATION")
        ckpt = ("--checkpoint-dir", os.path.join(root, "checkpoint"))
        stream = ("--streaming", "--block-rows", "512",
                  "--block-cache-dir", os.path.join(root, "block_cache"))
        hosts = stream + ("--hosts", "2")
        kill = ("--cluster-kill-host", "1:4")
        grid = ("--parallel-data", "1", "--parallel-feat", "1")
        runs = (("cuda", "cuda", "auto", ()), ("cuda_again", "cuda", "auto", ()),
                ("cpu", "cpu", "auto", ()), ("cuda_std_benes", "cuda", "benes", std),
                ("cpu_std_benes", "cpu", "benes", std), ("cuda_fe_tron", "cuda", "tron", ()),
                ("cpu_fe_tron", "cpu", "tron", ()), ("cuda_full_game", "cuda", "full", ()),
                ("cuda_full_game_again", "cuda", "full", ()), ("cpu_full_game", "cpu", "full", ()),
                # stopped after the first outer iteration, then resumed
                ("cuda_resume_first", "cuda", "full", ("--num-outer-iterations", "1", *ckpt)),
                ("cuda_resume", "cuda", "full", ckpt),
                # out of core: blocks of 512 rows, one block cache for both
                ("cuda_streaming", "cuda", "auto", stream),
                ("cpu_streaming", "cpu", "auto", stream),
                # the cluster plane: two worker processes on the card, and
                # the chaos drill (on cuda only: their cpu runs, each about
                # 10 s of worker start-up, are tests/test_torch_cluster.py's);
                # a 1 x 1 device grid
                ("cuda_hosts2", "cuda", "auto", hosts),
                ("cuda_hosts2_kill", "cuda", "auto", hosts + kill),
                ("cuda_grid_1x1", "cuda", "auto", grid), ("cpu_grid_1x1", "cpu", "auto", grid))
        for run, device, engine, extra in runs:
            config = (ratings_config(root, fe_only_tron=True) if engine == "tron"
                      else ratings_config(root, full_game=True) if engine == "full"
                      else ratings_config(root, engine))
            argv = [
                "--train-data-dirs", os.path.join(RATINGS, "train"),
                "--validation-data-dirs", os.path.join(RATINGS, "test"),
                "--coordinate-config", config,
                "--task", "LINEAR_REGRESSION",
                "--output-dir", os.path.join(root, run), "--evaluator", "RMSE",
                "--num-outer-iterations", "2", "--device", device, *extra,
            ]
            launches.reset()
            t0 = time.perf_counter()
            fit = train_game.run(train_game.parse_args(argv))
            result[f"{run}_s"] = time.perf_counter() - t0
            result[f"{run}_launches"] = launches.counts()
            result[f"{run}_rmse"] = fit.validation_metric
            result[f"{run}_objectives"] = [v for _, v in fit.objective_history]
        for run in ("cuda", "cuda_std_benes", "cuda_full_game"):
            launches.reset()
            result[f"score_game_rmse_{run}"] = score_game.run(score_game.parse_args([
                "--data-dirs", os.path.join(RATINGS, "test"),
                "--model-dir", os.path.join(root, run, "best"),
                "--output-dir", os.path.join(root, f"scores_{run}"), "--evaluator", "RMSE",
            ]))
            result[f"score_game_launches_{run}"] = launches.counts()
        rest = _train_game_cli_rest(root)
        rest["failures"] += _train_game_cli_telemetry(root, result)
    result.update(rest)
    if rest["failures"]:
        emit("train_game_cli", **result)
        raise AssertionError(f"train_game CLI gates failed: {rest['failures']}")
    # the dated run reads exactly the plain dirs' rows: bitwise the plain run
    if (result["dated_cuda_objectives"] != result["cuda_objectives"]
            or result["dated_cuda_rmse"] != result["cuda_rmse"]):
        raise AssertionError(f"the date-range run differs from the plain run: {result}")
    rescored = result["score_game_rmse_cuda"]
    for run in ("cuda", "cuda_streaming"):
        if result[f"{run}_launches"]["fused_value_grad_batched_f32"] < 1:
            raise AssertionError(f"train_game {run} did not launch the RE kernel: {result}")
    # every compiled plan launches inner_shuffle_f32 once (its other groups
    # follow the plan's size)
    missing = [k for k in ("inner_shuffle_f32",) if result["cuda_std_benes_launches"][k] < 1
               or result["score_game_launches_cuda_std_benes"][k] < 1]
    if missing:
        raise AssertionError(f"the standardized Benes run did not launch {missing}: {result}")
    for run in ("cuda", "cpu", "cuda_std_benes", "cpu_std_benes", "cuda_full_game",
                "cpu_full_game", "cuda_streaming", "cpu_streaming"):
        if not result[f"{run}_rmse"] < 0.45:
            raise AssertionError(f"{run} RMSE {result[f'{run}_rmse']} not under 0.45")
    for run in ("cuda_fe_tron", "cpu_fe_tron"):
        # the reference's golden FE-only gate (captured 0.8274)
        if not result[f"{run}_rmse"] < 0.95:
            raise AssertionError(f"{run} RMSE {result[f'{run}_rmse']} not under 0.95")
    for a, b in (("cuda", "cpu"), ("cuda_std_benes", "cpu_std_benes"),
                 ("cuda_fe_tron", "cpu_fe_tron"), ("cuda_full_game", "cpu_full_game"),
                 ("cuda_streaming", "cpu_streaming")):
        if abs(result[f"{a}_rmse"] - result[f"{b}_rmse"]) > 1e-4:
            raise AssertionError(f"RMSE of {a} and {b} differ: {result}")
    # the cluster and grid runs against the single-host CLI's on their device
    for run, base, devices in (("hosts2", "streaming", ("cuda",)),
                               ("hosts2_kill", "streaming", ("cuda",)),
                               ("grid_1x1", "", ("cuda", "cpu"))):
        for dev in devices:
            other = f"{dev}_{base}" if base else dev
            if abs(result[f"{dev}_{run}_rmse"] - result[f"{other}_rmse"]) > 1e-4:
                raise AssertionError(f"RMSE of {dev}_{run} is off {other}: {result}")
    # the streamed fit against the in-memory one (the JAX package's streaming
    # parity gate on this fixture, tests/test_streaming.py: 1e-3)
    if abs(result["cuda_streaming_rmse"] - result["cuda_rmse"]) > 1e-3:
        raise AssertionError(f"the streamed fit's RMSE is off the in-memory one: {result}")
    if abs(result["score_game_rmse_cuda_std_benes"] - result["cuda_std_benes_rmse"]) > 1e-5:
        raise AssertionError(f"score_game does not reproduce the standardized RMSE: {result}")
    # the sync schedule, and scoring, repeat bitwise on one device
    if (result["cuda_objectives"] != result["cuda_again_objectives"]
            or result["cuda_rmse"] != result["cuda_again_rmse"]):
        raise AssertionError(f"two cuda trainings differ: {result}")
    if abs(rescored - result["cuda_rmse"]) > 1e-5:
        raise AssertionError(f"score_game does not reproduce the RMSE: {result}")
    for a, b in (("cuda_full_game", "cuda_full_game_again"), ("cuda_full_game", "cuda_resume")):
        if (result[f"{a}_objectives"] != result[f"{b}_objectives"]
                or result[f"{a}_rmse"] != result[f"{b}_rmse"]):
            raise AssertionError(f"{a} and {b} differ: {result}")
    if abs(result["score_game_rmse_cuda_full_game"] - result["cuda_full_game_rmse"]) > 1e-5:
        raise AssertionError(f"score_game does not reproduce the full-GAME RMSE: {result}")
    emit("train_game_cli", **result)
    return result


GLMIX_RMSE = 0.388473  # the ratings GLMix fit with L-BFGS, 2 outer iterations
# the JAX package's train_game CLI on the same fixture and config (JAX on the
# CPU; tests/test_torch_train_game.py holds the port to it there): with
# --schedule async --staleness 1 and 2 outer iterations, and the best of
# --hyperparameter-tuning BAYESIAN --hyperparameter-tuning-iter 6
# --regularization-weight-range 1e-3,1e3
JAX_ASYNC_RMSE = 0.4166509
JAX_BAYESIAN_RMSE = 0.3596293


def _ratings_daily(root: str) -> tuple:
    """The ratings fixture as daily yyyy/MM/dd dirs: training on
    2026-03-01, validation on 2026-03-02, and a decoy day outside each
    range that holds the other set. Returns (train base, validation base)."""
    days = (("train", "2026/03/01", "train"), ("train", "2026/02/20", "test"),
            ("val", "2026/03/02", "test"), ("val", "2026/01/01", "train"))
    for base, day, src in days:
        dest = os.path.join(root, "daily", base, day)
        os.makedirs(dest)
        shutil.copy(os.path.join(RATINGS, src, "part-00000.avro"), dest)
    return os.path.join(root, "daily", "train"), os.path.join(root, "daily", "val")


def _saved_weights(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "model-metadata.json")) as f:
        coords = json.load(f)["configurations"]["coordinates"]
    return {cid: c["optimizer"]["regularization_weight"] for cid, c in coords.items()}


def _layout(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _train_game_cli_rest(root: str) -> dict:
    """The train_game flags of slice 9 on the ratings fixture, on cuda and
    cpu: a regularization_weights sweep with --model-output-mode ALL,
    RANDOM and BAYESIAN tuning, the async schedule, --updating-sequence
    reversed with --no-warm-start, two RE part files and --check-data, and
    the date-range flags (score_game's too) over a daily layout."""
    from photon_ml_tpu_torch.cli import score_game, train_game
    from photon_ml_tpu_torch.ops import launches

    result = {}
    base_cfg = ratings_config(root)
    with open(base_cfg) as f:
        cfg = json.load(f)
    opt = cfg["coordinates"]["per_user"]["optimizer"]
    del opt["regularization_weight"]
    opt["regularization_weights"] = [0.1, 1.0, 10.0]
    sweep_cfg = os.path.join(root, "game_sweep.json")
    with open(sweep_cfg, "w") as f:
        json.dump(cfg, f)
    train_dir, val_dir = _ratings_daily(root)
    trials = {}
    real_tuning = train_game.run_hyperparameter_tuning

    def recording_tuning(*a, **kw):
        out = real_tuning(*a, **kw)
        trials[current[0]] = [t.hyperparameters.tolist() for t in out]
        result[f"{current[0]}_trial_rmse"] = [t.value for t in out]
        return out

    current = [None]
    runs = [
        ("sweep", sweep_cfg, ("--model-output-mode", "ALL")),
        ("random", base_cfg, ("--hyperparameter-tuning", "RANDOM",
                              "--hyperparameter-tuning-iter", "2")),
        ("bayesian", base_cfg, ("--hyperparameter-tuning", "BAYESIAN",
                                "--hyperparameter-tuning-iter", "6",
                                "--regularization-weight-range", "1e-3,1e3")),
        ("async", base_cfg, ("--schedule", "async", "--staleness", "1")),
        # one outer iteration more: staleness 1 lags the plane by an update
        ("async3", base_cfg, ("--schedule", "async", "--staleness", "1",
                              "--num-outer-iterations", "3")),
        ("flags", base_cfg, ("--updating-sequence", "per_movie", "per_user", "fixed",
                             "--no-warm-start", "--num-output-files-for-random-effect-model",
                             "2", "--check-data")),
        ("dated", base_cfg, ("--train-date-range", "20260225-20260301",
                             "--validation-date-range", "20260302-20260310")),
    ]
    train_game.run_hyperparameter_tuning = recording_tuning
    try:
        for name, config, extra in runs:
            dirs = ((train_dir, val_dir) if name == "dated" else
                    (os.path.join(RATINGS, "train"), os.path.join(RATINGS, "test")))
            for device in ("cuda", "cpu"):
                run = f"{name}_{device}"
                current[0] = run
                out = os.path.join(root, run)
                argv = ["--train-data-dirs", dirs[0], "--validation-data-dirs", dirs[1],
                        "--coordinate-config", config, "--task", "LINEAR_REGRESSION",
                        "--output-dir", out, "--evaluator", "RMSE",
                        "--num-outer-iterations", "2", "--device", device, *extra]
                launches.reset()
                t0 = time.perf_counter()
                fit = train_game.run(train_game.parse_args(argv))
                result[f"{run}_s"] = time.perf_counter() - t0
                result[f"{run}_launches"] = launches.counts()
                result[f"{run}_rmse"] = fit.validation_metric
                result[f"{run}_objectives"] = [v for _, v in fit.objective_history]
                result[f"{run}_saved_weights"] = _saved_weights(os.path.join(out, "best"))
    finally:
        train_game.run_hyperparameter_tuning = real_tuning
    result["trial_log10_lambdas"] = trials
    result["sweep_layout_cuda"] = _layout(os.path.join(root, "sweep_cuda"))
    launches.reset()
    result["score_game_dated_rmse"] = score_game.run(score_game.parse_args([
        "--data-dirs", val_dir, "--date-range", "20260302-20260302",
        "--model-dir", os.path.join(root, "dated_cuda", "best"),
        "--output-dir", os.path.join(root, "scores_dated"), "--evaluator", "RMSE",
    ]))
    result["score_game_dated_launches"] = launches.counts()

    fails = []
    for name, _, _ in runs:
        a, b = result[f"{name}_cuda_rmse"], result[f"{name}_cpu_rmse"]
        if not abs(a - b) <= 1e-4:
            fails.append(f"{name}: cuda {a} and cpu {b} differ")
        if name == "flags" and not (a < 0.45 and b < 0.45):
            fails.append(f"{name}: RMSE {a}, {b} not under 0.45")
        if name in ("async3", "dated") and not (
                abs(a - GLMIX_RMSE) <= 5e-3 and abs(b - GLMIX_RMSE) <= 5e-3):
            fails.append(f"{name}: RMSE {a}, {b} not within 0.005 of {GLMIX_RMSE}")
        # tuning starts from the GLMix fit and keeps the best: no worse
        if name == "bayesian" and not (a <= GLMIX_RMSE + 5e-3 and b <= GLMIX_RMSE + 5e-3):
            fails.append(f"{name}: best RMSE {a}, {b} above {GLMIX_RMSE} + 0.005")
        reference = {"async": JAX_ASYNC_RMSE, "bayesian": JAX_BAYESIAN_RMSE}.get(name)
        if reference is not None and not (abs(a - reference) <= 1e-4
                                          and abs(b - reference) <= 1e-4):
            fails.append(f"{name}: RMSE {a}, {b} not within 1e-4 of the JAX CLI's {reference}")
        if result[f"{name}_cuda_saved_weights"] != result[f"{name}_cpu_saved_weights"]:
            fails.append(f"{name}: the saved configurations differ")
        if result[f"{name}_cuda_launches"]["fused_value_grad_batched_f32"] < 1:
            fails.append(f"{name}: cuda did not launch the RE kernel")
    if trials["random_cuda"] != trials["random_cpu"]:
        fails.append("random: trial lambdas differ between cuda and cpu")
    result["bayesian_trials_equal_on_cuda_and_cpu"] = (
        trials["bayesian_cuda"] == trials["bayesian_cpu"])
    if _layout(os.path.join(root, "sweep_cuda")) != _layout(os.path.join(root, "sweep_cpu")) \
            or not any(p.startswith(os.path.join("all", "2")) for p in
                       result["sweep_layout_cuda"]):
        fails.append("the sweep's saved layouts differ or lack all/<i>")
    if not any("part-00001" in p for p in _layout(os.path.join(root, "flags_cuda", "best"))):
        fails.append("--num-output-files-for-random-effect-model 2 wrote one part file")
    if abs(result["score_game_dated_rmse"] - result["dated_cuda_rmse"]) > 1e-5:
        fails.append("score_game --date-range does not reproduce the dated RMSE")
    result["failures"] = fails
    return result


def _train_game_cli_telemetry(root: str, result: dict) -> list:
    """The telemetry, progress, introspection and auto-tune flags of
    train_game on the ratings GLMix config, on cuda and cpu: the fit
    bitwise the plain run's (``result``), the ledgers valid, analyze_run
    (and its --progress report) exiting 0 on them; --auto-tune on a config
    whose per_user coordinate has an adaptive block writes auto-tune.json
    with the JAX CLI's keys. Returns the failed gates."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.telemetry import validate_chrome_trace, validate_ledger

    base_cfg = ratings_config(root)
    with open(base_cfg) as f:
        cfg = json.load(f)
    cfg["coordinates"]["per_user"]["optimizer"]["adaptive"] = {
        "enabled": True, "chunk_iters": 8, "min_lanes": 8}
    adaptive_cfg = os.path.join(root, "game_adaptive.json")
    with open(adaptive_cfg, "w") as f:
        json.dump(cfg, f)
    fails, analyses = [], {}
    for device in ("cuda", "cpu"):
        out = os.path.join(root, f"telemetry_{device}")
        files = {k: os.path.join(root, f"{device}_{k}") for k in (
            "ledger.jsonl", "trace.json", "progress.jsonl", "port")}
        for name, config, extra in (
                ("telemetry", base_cfg, (
                    "--telemetry-out", files["ledger.jsonl"], "--trace-out", files["trace.json"],
                    "--progress-out", files["progress.jsonl"], "--introspect-port", "0",
                    "--introspect-port-file", files["port"])),
                ("autotune", adaptive_cfg, ("--auto-tune", "--auto-tune-trials", "1"))):
            run = f"{name}_{device}"
            argv = ["--train-data-dirs", os.path.join(RATINGS, "train"),
                    "--validation-data-dirs", os.path.join(RATINGS, "test"),
                    "--coordinate-config", config, "--task", "LINEAR_REGRESSION",
                    "--output-dir", os.path.join(root, run), "--evaluator", "RMSE",
                    "--num-outer-iterations", "2", "--device", device, *extra]
            launches.reset()
            t0 = time.perf_counter()
            fit = train_game.run(train_game.parse_args(argv))
            result[f"{run}_s"] = time.perf_counter() - t0
            result[f"{run}_launches"] = launches.counts()
            result[f"{run}_rmse"] = fit.validation_metric
            result[f"{run}_objectives"] = [v for _, v in fit.objective_history]
            same = (result[f"{run}_rmse"] == result[f"{device}_rmse"]
                    and result[f"{run}_objectives"] == result[f"{device}_objectives"])
            result[f"{run}_bitwise_plain"] = same
            if name == "telemetry" and not same:
                fails.append(f"{run}: not bitwise the plain {device} run")
            if not abs(fit.validation_metric - GLMIX_RMSE) <= 5e-3:
                fails.append(f"{run}: RMSE {fit.validation_metric} not within 0.005 of "
                             f"{GLMIX_RMSE}")
        ledger = validate_ledger(files["ledger.jsonl"])
        progress = validate_ledger(files["progress.jsonl"])
        validate_chrome_trace(files["trace.json"])
        result[f"telemetry_{device}_records"] = {"ledger": len(ledger), "progress": len(progress)}
        result[f"telemetry_{device}_introspect_port"] = int(open(files["port"]).read())
        for flags in ((files["ledger.jsonl"],), ("--progress", files["progress.jsonl"])):
            analyses[f"analyze_run_{device}_{'progress' if len(flags) > 1 else 'ledger'}"] = flags
        with open(os.path.join(root, f"autotune_{device}", "auto-tune.json")) as f:
            tuned = json.load(f)
        result[f"autotune_{device}_json"] = tuned
        keys = {"judge_metric", "minimize", "winner_index", "winner_config", "trials"}
        trial_keys = {"index", "config", "score", "wall_s", "error"}
        if set(tuned) != keys or len(tuned["trials"]) != 2 or any(
                set(t) != trial_keys for t in tuned["trials"]):
            fails.append(f"auto-tune.json of {device} lacks the JAX CLI's keys: {tuned}")
    # analyze_run on the four ledgers, each in a process of its own, together
    procs = {key: subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.analyze_run", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))) for key, flags in analyses.items()}
    for key, proc in procs.items():
        flags = analyses[key]
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        result[key] = (proc.returncode, stdout[-2000:])
        if proc.returncode != 0:
            fails.append(f"analyze_run {' '.join(flags)} exited {proc.returncode}: "
                         f"{stderr[-1000:]}")
    return fails


class solve_log:
    """Within the block, every solve of ``estimators.model_training`` (the
    single-GLM and fixed-effect solves) records its wall seconds,
    iterations, convergence reason, kernel launches and the objective's
    value+gradient and Hessian-vector evaluations (``self.solves``); the
    lane objectives of every solve, random-effect buckets included, count
    their evaluations (``self.evaluations``) and csc_rmatvec_f32 counts its
    calls by value transform (``self.transforms``; each a launch on the
    card). ``profile`` runs each solve under ``profile_device_idle``."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.solves = []
        self.evaluations = {"value_and_grad": 0, "hessian_vec": 0}
        self.transforms = {}

    def __enter__(self):
        from photon_ml_tpu_torch.estimators import model_training
        from photon_ml_tpu_torch.ops import fused_perm, launches
        from photon_ml_tpu_torch.opt import solve as solve_module
        from photon_ml_tpu_torch.types import ConvergenceReason

        real_lanes, real_solve = solve_module.lane_objective, model_training.solve
        real_csc = fused_perm.csc_rmatvec_f32
        ev = self.evaluations

        def lane_objective(objective, data, l2):
            lanes = real_lanes(objective, data, l2)

            def value_and_grad(w):
                ev["value_and_grad"] += 1
                return lanes.value_and_grad(w)

            def hessian_vec(w, v):
                ev["hessian_vec"] += 1
                return lanes.hessian_vec(w, v)

            return lanes._replace(value_and_grad=value_and_grad, hessian_vec=hessian_vec)

        def csc_rmatvec_f32(col_ptr, row_idx, vals, c, n, transform="id", split=None):
            self.transforms[transform] = self.transforms.get(transform, 0) + 1
            return real_csc(col_ptr, row_idx, vals, c, n, transform, split)

        def solve(*args, **kwargs):
            ev0, l0 = dict(ev), launches.counts()
            t0 = time.perf_counter()
            out = []
            prof = None
            if self.profile:
                prof = profile_device_idle(lambda: out.append(real_solve(*args, **kwargs)))
            else:
                out.append(real_solve(*args, **kwargs))
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            res = out[0]
            l1 = launches.counts()
            self.solves.append({
                "l2": kwargs.get("l2_weight"), "l1": kwargs.get("l1_weight"),
                "seconds": seconds,
                "iterations": int(res.iterations[0]),
                "reason": ConvergenceReason(int(res.reason[0])).name,
                "objective": float(res.value[0]),
                "value_and_grad_evaluations": ev["value_and_grad"] - ev0["value_and_grad"],
                "hessian_vec_evaluations": ev["hessian_vec"] - ev0["hessian_vec"],
                "launches": {k: l1[k] - l0.get(k, 0) for k in l1 if l1[k] != l0.get(k, 0)},
                **({"profile": prof} if prof is not None else {}),
            })
            return res

        self._saved = [(solve_module, "lane_objective", real_lanes),
                       (model_training, "solve", real_solve),
                       (fused_perm, "csc_rmatvec_f32", real_csc)]
        solve_module.lane_objective = lane_objective
        model_training.solve = solve
        fused_perm.csc_rmatvec_f32 = csc_rmatvec_f32
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


FULL_WIDTH = (1 << 20, 1 << 18, 1 << 24, 16, 65_536, 16_384)  # rows, held-out, dims, nnz, E
# rows and held-out rows of the full-GAME, async, sweep and telemetry
# phases: the full width at half the depth (the script's time limit; the
# buckets keep their counts)
ASYNC_DEPTH = (FULL_WIDTH[0] // 2, FULL_WIDTH[1] // 2)


def glm_task_labels(data, w_true: np.ndarray, rng) -> dict:
    """Labels of the three reference configurations' tasks for the rows of
    ``data``'s FE shard, from one coefficient vector: logistic
    Bernoulli(sigmoid(z)), linear z + N(0, 0.5²), Poisson(exp(z / 2)) (the
    margin halved so exp stays small: z ~ N(0, 2) here)."""
    shard = data.feature_shards["global"]
    z = np.bincount(shard.rows, weights=shard.vals * w_true[shard.cols], minlength=data.num_rows)
    return {
        "LOGISTIC_REGRESSION": (rng.random(z.size) < 1 / (1 + np.exp(-z))).astype(np.float32),
        "LINEAR_REGRESSION": (z + 0.5 * rng.standard_normal(z.size)).astype(np.float32),
        "POISSON_REGRESSION": rng.poisson(np.exp(0.5 * z)).astype(np.float32),
    }


def glm_configurations():
    """The three reference configurations of examples/BASELINE_CONFIGS.md at
    the solver settings of the train_glm_full_width phase."""
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.types import NormalizationType, RegularizationType

    def cfg(opt, reg, alpha=None):
        return GlmOptimizationConfiguration(
            optimizer_config=opt, regularization=RegularizationContext(reg, alpha=alpha),
            regularization_weight=1.0)

    return {
        "a_logistic_lbfgs_sweep": {
            "task": "LOGISTIC_REGRESSION", "weights": [100.0, 10.0, 1.0, 0.1],
            "configuration": cfg(OptimizerConfig.lbfgs(max_iterations=10), RegularizationType.L2),
            "norm": NormalizationType.NONE, "compute_variances": False},
        "b_linear_tron_standardized": {
            "task": "LINEAR_REGRESSION", "weights": [1.0],
            "configuration": cfg(OptimizerConfig.tron(max_iterations=15, max_cg_iterations=20),
                                 RegularizationType.L2),
            "norm": NormalizationType.STANDARDIZATION, "compute_variances": True},
        "c_poisson_owlqn_box": {
            "task": "POISSON_REGRESSION", "weights": [1.0],
            "configuration": cfg(OptimizerConfig.lbfgs(max_iterations=30, constraint_lower=-2.0,
                                                       constraint_upper=2.0),
                                 RegularizationType.ELASTIC_NET, 0.5),
            "norm": NormalizationType.NONE, "compute_variances": False},
    }


def phase_train_glm_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.estimators.model_training import train_glm
    from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.losses.pointwise import loss_for_task
    from photon_ml_tpu_torch.normalization import build_normalization_context
    from photon_ml_tpu_torch.ops import fused_perm, launches
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.stat.summary import summarize
    from photon_ml_tpu_torch.types import NormalizationType, TaskType

    n, n_val, fe_dim, fe_k, users, items = FULL_WIDTH
    t0 = time.perf_counter()
    train, val = make_glmix_training(seed, n, n_val, fe_dim, fe_k, users, items)
    feats = train.sparse_features("global", engine="auto", device="cuda")
    vfeats = val.sparse_features("global", engine="auto", device="cuda")
    if not isinstance(feats, fused_perm.FusedSparseFeatures):
        raise AssertionError(f"auto engine picked {type(feats).__name__}, not fused")
    rng = np.random.default_rng(seed + 1)
    w_true = rng.standard_normal(fe_dim + 1)
    labels = {"train": glm_task_labels(train, w_true, rng),
              "val": glm_task_labels(val, w_true, rng)}
    intercept = fe_dim
    # the engine's first maps make its merge-path splits: not solve time
    feats.matvec(torch.zeros(feats.dim, device="cuda"))
    feats.rmatvec(torch.zeros(n, device="cuda"))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    result = {"rows": n, "validation_rows": n_val, "fe_dim": feats.dim, "fe_nnz": feats.nnz,
              "data_s": data_s, "configurations": {}}
    for name, c in glm_configurations().items():
        task = TaskType[c["task"]]
        y = torch.from_numpy(labels["train"][c["task"]]).cuda()
        data = LabeledData.create(feats, y)
        if c["norm"] is not NormalizationType.NONE:
            stats = summarize(data)
            data = LabeledData.create(feats, y, norm=build_normalization_context(
                c["norm"], stats.mean, stats.variance, stats.max_abs, intercept))

        def run():
            return train_glm(data, task, c["configuration"], regularization_weights=c["weights"],
                             compute_variances=c["compute_variances"], intercept_index=intercept)

        # the main path: counts set to 0 just before, read just after
        launches.reset()
        with solve_log() as log:
            t0 = time.perf_counter()
            fits = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        counts = launches.counts()
        path = ["csr_matvec_f32", "csc_rmatvec_f32"]
        missing = [k for k in path if counts[k] < 1]
        if c["compute_variances"] and log.transforms.get("sq", 0) < 1:
            missing.append("csc_rmatvec_f32 (sq)")
        if missing:
            raise AssertionError(f"{name} did not launch {missing}: {counts}")
        launches.reset()
        with plain_versions(), solve_log() as plain_log:
            t0 = time.perf_counter()
            plain = run()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        if any(launches.counts()[k] for k in path):
            raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
        with solve_log(profile=True) as again_log:
            again = run()

        objective = [float(f.result.value[0]) for f in fits]
        plain_objective = [float(f.result.value[0]) for f in plain]
        rel = [abs(a - b) / abs(a) for a, b in zip(objective, plain_objective)]
        checks = {"objective_rel_vs_plain": rel,
                  "repeat_bitwise": all(_bits_equal(a.result.value_history,
                                                    b.result.value_history)
                                        and _bits_equal(a.result.w, b.result.w)
                                        for a, b in zip(fits, again))}
        ok = max(rel) <= 1e-4 and checks["repeat_bitwise"] and all(np.isfinite(objective))
        if task is TaskType.LOGISTIC_REGRESSION:
            evaluator = default_evaluator(task)
            vy = labels["val"][c["task"]]

            def aucs(fs):
                return {f.regularization_weight: evaluator.evaluate(
                    f.model.compute_score(vfeats), vy) for f in fs}

            auc, plain_auc = aucs(fits), aucs(plain)
            best = max(auc, key=lambda k: (auc[k], -k))
            plain_best = max(plain_auc, key=lambda k: (plain_auc[k], -k))
            checks.update(auc=auc, plain_auc=plain_auc, best_lambda=best,
                          plain_best_lambda=plain_best,
                          auc_diff=max(abs(auc[k] - plain_auc[k]) for k in auc))
            ok = ok and best == plain_best and checks["auc_diff"] <= 1e-4
        if c["compute_variances"]:
            v, pv = fits[0].model.coefficients.variances, plain[0].model.coefficients.variances
            checks["variance_max_rel_vs_plain"] = float(((v - pv).abs() / pv.abs()).max())
            checks["variances_finite"] = bool(torch.isfinite(v).all())
            ok = ok and checks["variance_max_rel_vs_plain"] <= 1e-2 and checks["variances_finite"]
        if name == "c_poisson_owlqn_box":
            w, pw = fits[0].model.coefficients.means, plain[0].model.coefficients.means
            nz, pnz = int((w != 0).sum()), int((pw != 0).sum())
            checks.update(max_abs_w=float(w.abs().max()), nonzeros=nz, plain_nonzeros=pnz,
                          at_bound=int((w.abs() == 2.0).sum()))
            ok = ok and checks["max_abs_w"] <= 2.0 and abs(nz - pnz) <= 1e-3 * max(nz, pnz)
        if task is TaskType.LINEAR_REGRESSION:
            # what an Hv costs, and the share of it that recomputes the
            # margins at w (a csr_matvec_f32 the CG loop could hoist)
            obj = make_glm_objective(loss_for_task(task))
            w = fits[0].result.w[0]
            v = torch.randn_like(w)
            checks["hessian_vec_ms"] = cuda_ms({
                "hessian_vec": lambda: obj.hessian_vec(w, v, data, 1.0),
                "margins": lambda: feats.matvec(data.norm.effective_coefficients(w)),
            }, reps=10)
        histories = [(f.result.value_history[0], p.result.value_history[0])
                     for f, p in zip(fits, plain)]
        checks["first_iteration_off_plain"] = [
            int(torch.nonzero(~torch.isclose(a, b, rtol=1e-6, equal_nan=True))[0])
            if not torch.allclose(a, b, rtol=1e-6, equal_nan=True) else None
            for a, b in histories]
        entry = {"task": c["task"], "lambdas": c["weights"], "wall_s": wall_s,
                 "plain_wall_s": plain_s, "objective": objective,
                 "plain_objective": plain_objective, "solves": log.solves,
                 "plain_solves": plain_log.solves, "profiled_solves": again_log.solves,
                 "evaluations": log.evaluations, "csc_transforms": log.transforms,
                 "launches": counts, **checks}
        result["configurations"][name] = entry
        emit("train_glm_full_width", configuration=name, **entry)  # before the verdict
        if not ok:
            raise AssertionError(f"{name} fails its checks: {entry}")
        del fits, plain, again
        torch.cuda.empty_cache()
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # each configuration's line is above
    emit("train_glm_full_width", **{k: v for k, v in result.items() if k != "configurations"})
    return result


def positional_index_map(dim: int):
    """An index map with feature ``f<i>`` at column i and the intercept in
    the last column: the length and the names ``_diagnose`` asks of one,
    without a dict of 2^24 + 1 names."""
    from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, IndexMap

    class Positional(IndexMap):
        def get_index(self, name: str) -> int:
            if name == INTERCEPT_KEY:
                return dim - 1
            i = int(name[1:]) if name[:1] == "f" and name[1:].isdigit() else -1
            return i if 0 <= i < dim - 1 else -1

        def get_feature_name(self, index: int):
            index = int(index)
            if not 0 <= index < dim:
                return None
            return INTERCEPT_KEY if index == dim - 1 else f"f{index}"

        def __len__(self) -> int:
            return dim

    return Positional()


def make_glm_rows(seed: int, n: int, dim: int, k: int):
    """A logistic GameData of ``n`` rows, ``k`` distinct features out of
    ``dim`` a row plus an intercept (column ``dim``), labels from a seeded
    coefficient vector; the shard is named "features", as train_glm's."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    rng = np.random.default_rng(seed)
    cols = np.sort(_distinct_cols(rng, n, k, dim), axis=1)
    cols = np.concatenate([cols, np.full((n, 1), dim)], axis=1)
    vals = np.concatenate([rng.standard_normal((n, k), dtype=np.float32) / np.sqrt(k),
                           np.ones((n, 1), np.float32)], axis=1)
    w = rng.standard_normal(dim + 1, dtype=np.float32)
    z = (vals * w[cols]).sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    shard = FeatureShard(np.repeat(np.arange(n, dtype=np.int64), k + 1),
                         cols.reshape(-1).astype(np.int64), vals.reshape(-1), dim + 1)
    return GameData(labels=y, feature_shards={"features": shard}, id_tags={})


def _report_bits(x):
    """A diagnosis (build_diagnostic_document's arguments) as nested
    builtins for a bitwise comparison: floats by their bits, arrays and the
    bootstrap's column-wise summaries by their bytes."""
    from photon_ml_tpu_torch.diagnostics.bootstrap import CoefficientSummaries

    if isinstance(x, CoefficientSummaries):
        return tuple(getattr(x, f).tobytes() for f in
                     ("min", "max", "mean", "std", "q1", "median", "q3"))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple((f.name, _report_bits(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return np.float64(x).tobytes()
    if isinstance(x, dict):
        return tuple((_report_bits(k), _report_bits(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_report_bits(v) for v in x)
    return x


def _rel(a, b) -> float:
    """max |a - b| / |b| over matching values (0 where both are 0; NaN
    equal to NaN)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.where(both_nan, 0.0, np.abs(a - b)) / np.maximum(np.abs(b), 1e-300)
    d = np.where((a == b) | both_nan, 0.0, d)
    return float(d.max()) if d.size else 0.0


def diagnosis_gates(k: dict, p: dict) -> dict:
    """A diagnosis through the kernels (``k``) against the same through the
    plain versions (``p``), both build_diagnostic_document's arguments: each
    quantity's difference and whether it holds its bound."""
    out, ok = {}, True
    if p["metrics"]:
        auc = "Area under ROC"
        out["metrics_max_rel"] = max([_rel(k["metrics"][m], v) for m, v in p["metrics"].items()
                                      if m != auc] or [0.0])
        out["auc_abs"] = abs(k["metrics"].get(auc, 0.0) - p["metrics"].get(auc, 0.0))
        ok &= list(k["metrics"]) == list(p["metrics"]) and out["metrics_max_rel"] <= 1e-4
        ok &= out["auc_abs"] <= 1e-4
    if p["bootstrap"] is not None:
        kb, pb = k["bootstrap"], p["bootstrap"]
        rel = 0.0
        for m, ps in pb.metric_summaries.items():
            ks = kb.metric_summaries[m]
            for f in ("min", "max", "mean", "q1", "median", "q3"):
                rel = max(rel, _rel(getattr(ks, f), getattr(ps, f)))
            # the spread, a difference of the values, to their error
            rel = max(rel, abs(ks.std - ps.std) / max(abs(ps.mean), 1e-300))
        zk, zp = len(kb.zero_crossing_indices), len(pb.zero_crossing_indices)
        out.update(bootstrap_summaries_max_rel=rel, zero_crossings=zk,
                   plain_zero_crossings=zp, coefficients=len(kb.coefficient_summaries))
        ok &= rel <= 1e-3 and abs(zk - zp) <= 1e-3 * max(zp, 1)
    if p["hosmer_lemeshow"] is not None:
        kh, ph = k["hosmer_lemeshow"], p["hosmer_lemeshow"]
        out.update(hl_bins=len(kh.bins), plain_hl_bins=len(ph.bins),
                   hl_chi_squared=kh.chi_squared,
                   hl_chi_squared_rel=_rel(kh.chi_squared, ph.chi_squared))
        ok &= len(kh.bins) == len(ph.bins) and out["hl_chi_squared_rel"] <= 1e-3
    if p["independence"] is not None:
        out["tau_alpha"] = k["independence"].tau_alpha
        out["tau_alpha_abs"] = abs(k["independence"].tau_alpha - p["independence"].tau_alpha)
        ok &= out["tau_alpha_abs"] <= 1e-3
    for key in ("importance", "importance_variance"):
        if p[key] is not None:
            ki = [r[2] for r in k[key].ranked_features]
            pi = [r[2] for r in p[key].ranked_features]
            rel = _rel([r[3] for r in k[key].ranked_features], [r[3] for r in p[key].ranked_features])
            out[f"{key}_top25_same"] = ki == pi
            out[f"{key}_top25_max_rel"] = rel
            ok &= ki == pi and rel <= 1e-3
    portions, rel = 0, 0.0
    ok &= list(k["fitting"] or {}) == list(p["fitting"] or {})
    for lam, rep in (p["fitting"] or {}).items():
        for name, (por, tr, te) in rep.metrics.items():
            kpor, ktr, kte = k["fitting"][lam].metrics[name]
            ok &= kpor == por
            portions = max(portions, len(por))
            rel = max(rel, _rel(ktr, tr), _rel(kte, te))
    out.update(curve_portions=portions, curves_max_rel=rel)
    ok &= rel <= 1e-3
    out["within_bounds"] = bool(ok)
    return out


class diagnose_split:
    """Within the block, the seconds of cli.train_glm._diagnose's parts, each
    call ended by a device sync: "sub_data" (GameData.take_rows and the
    sub-data's LabeledData with its device layout), "sub_fits" (train_glm)
    and "scoring" (GeneralizedLinearModel.compute_score outside a fit)."""

    def __enter__(self):
        from photon_ml_tpu_torch.cli import train_glm as cli
        from photon_ml_tpu_torch.data.game_data import GameData
        from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel

        self.seconds = {"sub_data": 0.0, "sub_fits": 0.0, "scoring": 0.0}
        self._saved = [(cli, "train_glm", cli.train_glm), (cli, "_labeled", cli._labeled),
                       (GameData, "take_rows", GameData.take_rows),
                       (GeneralizedLinearModel, "compute_score",
                        GeneralizedLinearModel.compute_score)]
        fitting = []

        def timed(key, fn, inside_fit=False):
            def wrapper(*args, **kwargs):
                if fitting and not inside_fit:
                    return fn(*args, **kwargs)
                if inside_fit:
                    fitting.append(True)
                t0 = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    return out
                finally:
                    if inside_fit:
                        fitting.pop()
                    self.seconds[key] += time.perf_counter() - t0
            return wrapper

        for (owner, name, fn), key in zip(self._saved, ("sub_fits", "sub_data", "sub_data",
                                                          "scoring")):
            setattr(owner, name, timed(key, fn, inside_fit=key == "sub_fits"))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _diagnose_run(args, task, data, labeled, fits, best_lambda, imap, intercept, cfg,
                  val_data=None, plain=False, profile=False) -> dict:
    """One call of cli.train_glm._diagnose on cuda (through the plain
    versions with ``plain``; under torch.profiler with ``profile``): its
    seconds and their split, the launches, the report's arguments and
    model-diagnostic.html's bytes."""
    import contextlib
    import logging

    from photon_ml_tpu_torch.cli import train_glm as cli
    from photon_ml_tpu_torch.diagnostics import report
    from photon_ml_tpu_torch.ops import launches

    captured, out = {}, {}
    build = report.build_diagnostic_document

    def capture(*a, **kw):
        captured.update(kw, title=a[0])
        return build(*a, **kw)

    def call():
        t0 = time.perf_counter()
        out["path"] = cli._diagnose(
            args, task, data, labeled, fits, best_lambda, imap, intercept, cfg,
            logging.getLogger("chip_smoke"), torch.device("cuda"), val_data=val_data,
            metric_name="AUC")
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0

    report.build_diagnostic_document = capture
    try:
        # the diagnose stage's own counts: set to 0 just before, read just after
        launches.reset()
        with plain_versions() if plain else contextlib.nullcontext(), diagnose_split() as split:
            idle = profile_device_idle(call) if profile else None
            if not profile:
                call()
        counts = launches.counts()
    finally:
        report.build_diagnostic_document = build
    with open(out["path"], "rb") as f:
        html = f.read()
    parts = dict(split.seconds)
    parts["statistics_and_report"] = out["seconds"] - sum(parts.values())
    return {"seconds": out["seconds"], "split_s": parts, "launches": counts,
            "report": captured, "html": html, "idle": idle}


def _diagnose_part(name: str, mode: str, root: str, task, data, labeled, fits, best_lambda,
                   imap, intercept, cfg, val_data=None) -> dict:
    """A diagnosis through the kernels, through the plain versions and
    through the kernels again (under torch.profiler: the idle share), with
    the gates between the first two and the third bitwise the first."""
    runs = {}
    for tag, plain, profile in (("kernels", False, False), ("plain", True, False),
                                ("again", False, True)):
        args = argparse.Namespace(diagnostic_mode=mode, output_dir=os.path.join(root, name, tag))
        runs[tag] = _diagnose_run(args, task, data, labeled, fits, best_lambda, imap, intercept,
                                  cfg, val_data=val_data, plain=plain, profile=profile)
    k, p, a = runs["kernels"], runs["plain"], runs["again"]
    gates = diagnosis_gates(k["report"], p["report"])
    path = ("csr_matvec_f32", "csc_rmatvec_f32")
    entry = {
        "mode": mode, "rows": data.num_rows, "dims": len(imap), "best_lambda": best_lambda,
        "seconds": k["seconds"], "split_s": k["split_s"], "plain_seconds": p["seconds"],
        "plain_split_s": p["split_s"], "again_seconds_profiled": a["seconds"],
        "launches": {n: k["launches"][n] for n in path},
        "plain_launches": {n: p["launches"][n] for n in path},
        "device_idle": a["idle"], "html_bytes": len(k["html"]),
        "chapters": re.findall(rb"<h2>(.*?)</h2>", k["html"]),
        "repeat_bitwise": (_report_bits(k["report"]) == _report_bits(a["report"])
                           and k["html"] == a["html"]),
        "plain_html_equal": k["html"] == p["html"],
        "metrics": k["report"]["metrics"], **gates,
    }
    entry["chapters"] = [c.decode() for c in entry["chapters"]]
    entry["launched"] = all(entry["launches"][n] > 0 for n in path) and not any(
        entry["plain_launches"].values())
    entry["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return entry


def phase_train_glm_diagnostics_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.cli import train_glm as cli
    from photon_ml_tpu_torch.data.game_data import GameData
    from photon_ml_tpu_torch.estimators.model_training import train_glm
    from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
    from photon_ml_tpu_torch.ops import fused_perm
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    dev = torch.device("cuda")
    cfg = glm_configurations()["a_logistic_lbfgs_sweep"]
    result = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diag_") as root:
        # (i) phase 14's rows and labels (its draws, in its order), ALL
        t0 = time.perf_counter()
        n, n_val, fe_dim, fe_k, users, items = FULL_WIDTH
        train, val = make_glmix_training(seed, n, n_val, fe_dim, fe_k, users, items)
        rng = np.random.default_rng(seed + 1)
        w_true = rng.standard_normal(fe_dim + 1)
        labels = {"train": glm_task_labels(train, w_true, rng)[task.name],
                  "val": glm_task_labels(val, w_true, rng)[task.name]}
        data, vdata = (GameData(labels=labels[part], id_tags={},
                                feature_shards={"features": d.feature_shards["global"]})
                       for part, d in (("train", train), ("val", val)))
        labeled = cli._labeled(data, dev)
        if not isinstance(labeled.features, fused_perm.FusedSparseFeatures):
            raise AssertionError(f"auto engine picked {type(labeled.features).__name__}")
        fits = train_glm(labeled, task, cfg["configuration"],
                         regularization_weights=cfg["weights"], intercept_index=fe_dim)
        evaluator = default_evaluator(task)
        vfeats = vdata.sparse_features("features", engine="auto", device=dev)
        voff = torch.from_numpy(vdata.offsets).to(dev)
        auc = {f.regularization_weight: evaluator.evaluate(
            f.model.compute_score(vfeats) + voff, vdata.labels, vdata.weights) for f in fits}
        best = None
        for lam, m in auc.items():
            if best is None or evaluator.better_than(m, auc[best]):
                best = lam
        setup_s = time.perf_counter() - t0
        part = _diagnose_part("full_width_all", "ALL", root, task, data, labeled, fits, best,
                              positional_index_map(fe_dim + 1), fe_dim, cfg["configuration"],
                              val_data=vdata)
        part.update(setup_s=setup_s, validation_auc=auc)
        part["curves_empty"] = part["curve_portions"] == 0 and not any(
            "Fitting" in c for c in part["chapters"])
        emit("train_glm_diagnostics_full_width", part="i_full_width_all", **part)
        result["i_full_width_all"] = part
        del data, vdata, labeled, fits, vfeats
        torch.cuda.empty_cache()

        # (ii) more rows than columns: the learning curves, TRAIN
        t0 = time.perf_counter()
        dim = 1 << 16
        data = make_glm_rows(seed + 2, n, dim, fe_k)
        labeled = cli._labeled(data, dev)
        fits = train_glm(labeled, task, cfg["configuration"], regularization_weights=[1.0],
                         intercept_index=dim)
        setup_s = time.perf_counter() - t0
        part = _diagnose_part("learning_curves_train", "TRAIN", root, task, data, labeled,
                              fits, 1.0, positional_index_map(dim + 1), dim, cfg["configuration"])
        part["setup_s"] = setup_s
        emit("train_glm_diagnostics_full_width", part="ii_learning_curves_train", **part)
        result["ii_learning_curves_train"] = part
        del data, labeled, fits
        torch.cuda.empty_cache()

    i, ii = result["i_full_width_all"], result["ii_learning_curves_train"]
    result["launches_by_kernel"] = {
        name: i["launches"][name] + ii["launches"][name]
        for name in ("csr_matvec_f32", "csc_rmatvec_f32")}
    failed = [key for key, part in result.items() if key != "launches_by_kernel" and not (
        part["within_bounds"] and part["repeat_bitwise"] and part["launched"])]
    if not i["curves_empty"]:
        failed.append("i: learning curves at 2^24 + 1 dims (the reference's rule gives none)")
    if ii["curve_portions"] != 9:
        failed.append(f"ii: {ii['curve_portions']} learning-curve portions, not 9")
    emit("train_glm_diagnostics_full_width", launches_by_kernel=result["launches_by_kernel"],
         seconds=i["seconds"] + ii["seconds"], peak_mem_gb=ii["peak_mem_gb"])
    if failed:
        raise AssertionError(f"train_glm_diagnostics_full_width fails {failed} (lines above)")
    return result


def phase_train_tron_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration as FE,
        GameEstimator,
        RandomEffectCoordinateConfiguration as RE,
    )
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    n, n_val, fe_dim, fe_k, users, items = FULL_WIDTH
    train, val = make_glmix_training(seed, n, n_val, fe_dim, fe_k, users, items)
    tron = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig.tron(),
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    owlqn = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig.lbfgs(max_iterations=10),
        regularization=RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5),
        regularization_weight=1.0)
    estimator = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FE("global", tron),
         "per_user": RE("per_user", RandomEffectDataConfiguration("userId"), tron),
         "per_item": RE("per_item", RandomEffectDataConfiguration("itemId"), owlqn)},
        update_order=["fixed", "per_user", "per_item"], num_outer_iterations=1, device="cuda")
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    buckets = {cid: [tuple(b.X.shape) for b in coords[cid].dataset.buckets]
               for cid in ("per_user", "per_item")}

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    with solve_log() as log:
        t0 = time.perf_counter()
        fit = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    counts = launches.counts()
    missing = [k for k in KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"the TRON / OWL-QN fit did not launch {missing}: {counts}")
    trackers = {cid: coords[cid].last_tracker.to_summary_string() for cid in coords}
    solver_stats = {cid: [s.to_summary_string() for s in coords[cid].last_solver_stats]
                    for cid in ("per_user", "per_item")}
    launches.reset()
    with plain_versions():
        t0 = time.perf_counter()
        plain = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if any(launches.counts()[k] for k in KERNELS):
        raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
    after, plain_after = fit.objective_history[-1][1], plain.objective_history[-1][1]
    obj_rel = abs(after - plain_after) / abs(after)
    auc_diff = abs(fit.validation_metric - plain.validation_metric)
    residual = torch.zeros(n, device="cuda")
    profiles = {
        cid: profile_device_idle(
            lambda cid=cid: coords[cid].update_model_device(fit.model.models[cid], residual))
        for cid in ("fixed", "per_user", "per_item")
    }
    # one batched Hv of the per_user bucket, and its margins at w
    bucket = coords["per_user"].dataset.buckets[0]
    bdata = LabeledData(DenseFeatures(bucket.X), bucket.labels, bucket.offsets, bucket.weights)
    w_re = fit.model.models["per_user"].coefficients[0]
    v_re = torch.randn_like(w_re)
    obj = make_glm_objective(LogisticLoss)
    hv_ms = cuda_ms({"hessian_vec": lambda: obj.hessian_vec(w_re, v_re, bdata, 1.0),
                     "margins": lambda: bdata.features.matvec(w_re)}, reps=10)
    result = {
        "optimizers": {"fixed": "TRON", "per_user": "TRON", "per_item": "OWL-QN"},
        "buckets": buckets, "build_coordinates_s": build_s, "fit_s": fit_s,
        "plain_fit_s": plain_s, "seconds_per_coordinate": fit.update_seconds,
        "plain_seconds_per_coordinate": plain.update_seconds,
        "objective_history": fit.objective_history,
        "plain_objective_history": plain.objective_history,
        "objective_rel_diff_vs_plain": obj_rel, "validation_auc": fit.validation_metric,
        "plain_validation_auc": plain.validation_metric, "auc_diff_vs_plain": auc_diff,
        "launches": counts, "fused_value_grad_batched_f32_launches":
            counts["fused_value_grad_batched_f32"],
        "fe_solve": log.solves, "evaluations": log.evaluations, "trackers": trackers,
        "solver_stats": solver_stats, "coordinate_profiles": profiles,
        "per_user_hessian_vec_ms": hv_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if not (np.isfinite(fit.validation_metric) and obj_rel <= 1e-4 and auc_diff <= 1e-4):
        raise AssertionError(f"kernel and plain TRON / OWL-QN fits differ: {result}")
    emit("train_tron_full_width", **result)
    return result


class value_grad_shapes:
    """Within the block, every call of fused_value_grad_batched_f32 is
    counted by the width d of its X [E, s, d] (``self.widths``) and its
    shapes kept (``self.shapes``); the wrapper's own launch count is
    untouched."""

    def __enter__(self):
        from photon_ml_tpu_torch.ops import pallas_kernels

        real = self._real = pallas_kernels.fused_value_grad_batched_f32
        self.widths, self.shapes = {}, set()

        def counted(X, *args):
            d = int(X.shape[-1])
            self.widths[d] = self.widths.get(d, 0) + 1
            self.shapes.add(tuple(X.shape))
            return real(X, *args)

        pallas_kernels.fused_value_grad_batched_f32 = counted
        return self

    def __exit__(self, *exc):
        from photon_ml_tpu_torch.ops import pallas_kernels

        pallas_kernels.fused_value_grad_batched_f32 = self._real


MF_ID = "user-item-mf"
MF_LATENT = 8


def _full_game_estimator(device: str):
    """The GLMix fit of train_full_width (FE + per_user + per_item, L-BFGS 10
    iterations, L2 lambda 1, one outer iteration) and the user-item-mf
    coordinate of examples/game.json.example: the per_item shard's features
    over userId, k = 8 latent factors, 2 MF iterations, the same solver."""
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        MFOptimizationConfiguration,
    )
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FactoredRandomEffectCoordinateConfiguration,
        GameEstimator,
    )

    glmix = _glmix_estimator(device)
    mf = FactoredRandomEffectCoordinateConfiguration(
        "per_item", RandomEffectDataConfiguration("userId"),
        MFOptimizationConfiguration(MF_LATENT, 2), glmix.coordinate_configs["fixed"].optimizer)
    return GameEstimator(glmix.task, {**glmix.coordinate_configs, MF_ID: mf},
                         update_order=glmix.update_order + [MF_ID], num_outer_iterations=1,
                         device=device)


def kron_times(coord, latent_model, gen) -> dict:
    """KronFeatures' matvec and rmatvec at the MF coordinate's full shape
    (one lane of the projection-matrix solve; the rmatvec sums its terms
    over segments sorted once a solve), that sort alone ("segments") and
    its share of one solve's rmatvecs, and the accumulating index_put_
    (ops.features.scatter_add) of the same terms, which sorts them on
    every call ("index_put", a few calls: it takes seconds)."""
    from photon_ml_tpu_torch.ops.features import scatter_add

    kron = coord.kron_data(coord.dataset, latent_model).features
    w = torch.randn(kron.dim, generator=gen, device="cuda") * 0.1
    c = torch.randn(kron.num_rows, generator=gen, device="cuda")
    idx = torch.cat([p.reshape(-1) for p in kron.pidxs])
    contrib = torch.randn(idx.numel(), kron.k, generator=gen, device="cuda")
    out = torch.zeros(kron.d_global, kron.k, device="cuda")
    fresh = lambda: coord.kron_data(coord.dataset, latent_model).features  # noqa: E731
    ms = cuda_ms({
        "matvec": lambda: kron.matvec(w),
        "rmatvec": lambda: kron.rmatvec(c),
        "segments": lambda: fresh().segments(),
    }, reps=10)
    ms.update(cuda_ms({"index_put": lambda: scatter_add(out.clone(), idx, contrib)},
                      reps=2, warmup=1, batch=1, rounds=2))
    return {"rows": kron.num_rows, "dim": kron.dim, "scatter_rows": idx.numel(), **ms,
            "segments_over_rmatvec": ms["segments_device"] / ms["rmatvec_device"]}


def phase_train_full_game_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.algorithm.factored_random_effect import _latent_dataset
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import launches, pallas_kernels

    _, _, fe_dim, fe_k, users, items = FULL_WIDTH
    train, val = make_glmix_training(seed, *ASYNC_DEPTH, fe_dim, fe_k, users, items)
    estimator = _full_game_estimator("cuda")
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mf = coords[MF_ID]
    mf_bytes = sum(t.numel() * t.element_size() for b in mf.dataset.buckets
                   for t in (b.X, b.labels, b.offsets, b.weights, b.sample_pos,
                             b.proj_indices, b.proj_valid))
    buckets = {cid: [tuple(b.X.shape) for b in coords[cid].dataset.buckets]
               for cid in ("per_user", "per_item", MF_ID)}

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    with value_grad_shapes() as vg:
        t0 = time.perf_counter()
        fit = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    counts = launches.counts()
    mf_steps = list(mf.last_step_seconds)
    missing = [k for k in KERNELS if counts[k] < 1]
    if missing or vg.widths.get(MF_LATENT, 0) < 1:
        raise AssertionError(f"the full-GAME fit did not launch {missing} or K6 at width "
                             f"{MF_LATENT}: {counts} {vg.widths}")
    model = fit.model.models[MF_ID]
    latent_buckets = sorted(s for s in vg.shapes if s[-1] == MF_LATENT)

    # the same fit again (bitwise), and through the plain versions
    again = estimator.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    bitwise = (again.objective_history == fit.objective_history
               and again.validation_metric == fit.validation_metric
               and _bits_equal(again.model.models[MF_ID].projection_matrix,
                               model.projection_matrix))
    launches.reset()
    with plain_versions():
        t0 = time.perf_counter()
        plain = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if any(launches.counts()[k] for k in KERNELS):
        raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
    after, plain_after = fit.objective_history[-1][1], plain.objective_history[-1][1]
    obj_rel = abs(after - plain_after) / abs(after)
    auc_diff = abs(fit.validation_metric - plain.validation_metric)
    b_diff = float((model.projection_matrix
                    - plain.model.models[MF_ID].projection_matrix).abs().max())
    # B's f32 floor: the spread of B on the kernel path when the MF
    # coordinate's residual (the other coordinates' scores, summed as the
    # fit summed them) moves by 1e-7 relative. Each latent lane stops when
    # its objective changes by about an ulp, so B is set only to about
    # that spread; the plain fit is held to B atol max(2e-3, twice it)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    residual = sum(coords[c].score_device(fit.model.models[c])
                   for c in ("fixed", "per_user", "per_item"))
    nudged = residual * (1 + 1e-7 * torch.randn(residual.shape, generator=gen, device="cuda"))
    b_floor = float((mf.update_model_device(None, nudged).projection_matrix
                     - model.projection_matrix).abs().max())
    b_tol = max(2e-3, 2 * b_floor)

    # K6 at the latent bucket: times, and against its plain version and
    # float64 on these inputs, and bitwise repeats
    latent = _latent_dataset(mf.dataset, model.projection_matrix).buckets[0]
    vg_times = value_grad_times(latent, gen)
    vg_in = vg_times.pop("inputs")
    s = vg_in[0].shape[1]
    vg_ref, vg_scale = _value_grad_f64(*vg_in, LogisticLoss)
    out = pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss)
    check = [_compare(o, p, r, a, s, o.shape, part=part) for part, o, p, r, a in zip(
        ("value", "grad", "csum"), out,
        pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss), vg_ref, vg_scale)]
    repeat = all(torch.equal(a, b) for a, b in zip(
        out, pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss)))
    kron = kron_times(mf, model.latent, gen)
    idle = profile_device_idle(lambda: mf.update_model_device(model, residual))
    result = {
        "mf": {"coordinate": MF_ID, "feature_shard": "per_item", "random_effect_type": "userId",
               "num_latent_factors": MF_LATENT, "num_iterations": 2},
        "buckets": buckets, "latent_buckets_launched": latent_buckets,
        "mf_dataset_device_bytes": mf_bytes,
        "device_bytes_after_build": torch.cuda.memory_allocated() - mem0,
        "build_coordinates_s": build_s, "fit_s": fit_s, "plain_fit_s": plain_s,
        "seconds_per_coordinate": fit.update_seconds,
        "plain_seconds_per_coordinate": plain.update_seconds,
        "mf_step_seconds_a_b": mf_steps,
        "objective_history": fit.objective_history,
        "plain_objective_history": plain.objective_history,
        "objective_rel_diff_vs_plain": obj_rel, "validation_auc": fit.validation_metric,
        "plain_validation_auc": plain.validation_metric, "auc_diff_vs_plain": auc_diff,
        "projection_matrix_max_abs_diff_vs_plain": b_diff,
        "projection_matrix_f32_floor": b_floor, "projection_matrix_tolerance": b_tol,
        "bitwise_repeat": bitwise,
        "launches": counts, "value_grad_calls_by_width": vg.widths,
        "fused_value_grad_batched_f32_latent": {**vg_times, "check": check,
                                                "bitwise_repeat": repeat},
        "kron_features": kron, "mf_update_profile": idle,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if not (np.isfinite(fit.validation_metric) and obj_rel <= 1e-4 and auc_diff <= 1e-4
            and b_diff <= b_tol and bitwise and repeat and all(c["ok"] for c in check)):
        emit("train_full_game_full_width", **result)
        raise AssertionError("the full-GAME fit through the kernels differs from the plain "
                             "fit or from itself, or K6 disagrees at the latent shapes")
    emit("train_full_game_full_width", **result)
    return result


# the log10 λ vectors of the first two RANDOM trials over three coordinates
# in (-4, 4), seed 0 (scrambled Sobol draws): tests/test_torch_tuning.py
# pins the same values on the CPU
RANDOM_TRIALS_LOG10 = [[-0.720403291285038, 3.7129617482423782, 2.8612390011548996],
                       [1.6987586095929146, 0.6855398789048195, 1.1011880710721016]]
ASYNC_BUCKETS = {"per_user": 4, "per_item": 2}
# outer iterations of the async fits of the async and telemetry phases (1,
# not the 2 of the telemetry phase's sync fits: it keeps the script inside
# its time limit)
ASYNC_OUTER = 1


def _async_estimator(schedule: str = "sync", staleness: int = 1, outer: int = 2):
    """The train_full_width GLMix fit with per_user in 4 buckets and
    per_item in 2 (so that bucket overlap fires), ``outer`` outer
    iterations, on ``schedule``."""
    from photon_ml_tpu_torch.estimators.game import GameEstimator

    glmix = _glmix_estimator("cuda")
    configs = dict(glmix.coordinate_configs)
    for cid, k in ASYNC_BUCKETS.items():
        configs[cid] = dataclasses.replace(
            configs[cid], data=dataclasses.replace(configs[cid].data, num_buckets=k))
    return GameEstimator(glmix.task, configs, update_order=glmix.update_order,
                         num_outer_iterations=outer, device="cuda", schedule=schedule,
                         staleness=staleness)


@functools.lru_cache(maxsize=1)
def _async_setup(seed: int):
    """The full-width data at ASYNC_DEPTH and its coordinates, built once
    for the async, sweep and telemetry phases: (train, validation,
    coordinates, build seconds)."""
    _, _, fe_dim, fe_k, users, items = FULL_WIDTH
    train, val = make_glmix_training(seed, *ASYNC_DEPTH, fe_dim, fe_k, users, items)
    t0 = time.perf_counter()
    coords = _async_estimator().build_coordinates(train)
    torch.cuda.synchronize()
    return train, val, coords, time.perf_counter() - t0


def _timed_fit(estimator, train, val, coords, **fit_kwargs):
    """One fit: (fit, {wall seconds, host CPU seconds of every thread},
    launches, peak bytes allocated)."""
    from photon_ml_tpu_torch.ops import launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0, c0 = time.perf_counter(), time.process_time()
    fit = estimator.fit(train, val, coordinates=coords, **fit_kwargs)
    torch.cuda.synchronize()
    seconds = {"wall_s": time.perf_counter() - t0, "host_cpu_s": time.process_time() - c0}
    return fit, seconds, launches.counts(), torch.cuda.max_memory_allocated()


def _model_tensors(model) -> list:
    """A sub-model's coefficient tensors (fixed, random or factored)."""
    if hasattr(model, "projection_matrix"):
        return list(model.latent.coefficients) + [model.projection_matrix]
    if hasattr(model, "entity_ids"):
        return list(model.coefficients)
    return [model.coefficients.means]


def _same_fit(a, b) -> bool:
    """Bitwise the same objective and validation histories and models."""
    return (a.objective_history == b.objective_history
            and a.validation_history == b.validation_history
            and a.model.models.keys() == b.model.models.keys()
            and all(_bits_equal(x, y) for cid in a.model.models for x, y in zip(
                _model_tensors(a.model.models[cid]), _model_tensors(b.model.models[cid]))))


def phase_train_async_full_width(seed: int) -> dict:
    """The async schedule at full width against the sync loop, over
    ASYNC_OUTER outer iterations."""
    train, val, coords, build_s = _async_setup(seed)
    buckets = {cid: [tuple(b.X.shape) for b in coords[cid].dataset.buckets]
               for cid in ASYNC_BUCKETS}
    if any(len(buckets[c]) != k for c, k in ASYNC_BUCKETS.items()):
        raise AssertionError(f"bucket counts {buckets} are not {ASYNC_BUCKETS}")
    sync, sync_s, sync_counts, sync_mem = _timed_fit(_async_estimator(outer=ASYNC_OUTER),
                                                     train, val, coords)
    a0, a0_s, _, _ = _timed_fit(_async_estimator("async", 0, ASYNC_OUTER), train, val, coords)
    # the main path of this phase: counts set to 0 just before, read after
    a1, a1_s, a1_counts, a1_mem = _timed_fit(_async_estimator("async", 1, ASYNC_OUTER),
                                             train, val, coords)
    missing = [k for k in KERNELS if a1_counts[k] < 1]
    if missing:
        raise AssertionError(f"the async fit did not launch {missing}: {a1_counts}")
    # the repeat runs under the profiler (its wall is the profiled one)
    repeat = []
    async_profile = profile_device_idle(lambda: repeat.append(
        _async_estimator("async", 1, ASYNC_OUTER).fit(train, val, coordinates=coords)))
    a1b = repeat[0]
    with plain_versions():
        plain, plain_s, plain_counts, _ = _timed_fit(
            _async_estimator("async", 1, ASYNC_OUTER), train, val, coords)
    if any(plain_counts[k] for k in KERNELS):
        raise AssertionError(f"the plain run launched kernels: {plain_counts}")
    after = a1.objective_history[-1][1]
    obj_rel = abs(after - plain.objective_history[-1][1]) / abs(after)
    auc_vs_plain = abs(a1.validation_metric - plain.validation_metric)
    auc_gap = a1.validation_metric - sync.validation_metric
    profiles = {
        "sync": profile_device_idle(lambda: _async_estimator(outer=ASYNC_OUTER).fit(
            train, val, coordinates=coords)),
        "async_staleness_1": async_profile,
    }

    # each random effect's update with its buckets in turn and overlapped:
    # bitwise the same per bucket
    models = sync.model.models
    re_updates = {}
    for cid in ASYNC_BUCKETS:
        coord = coords[cid]
        residual = sum(coords[c].score_device(m) for c, m in models.items() if c != cid)
        runs = {}
        for mode, overlap in (("sequential", 0), ("overlapped", 2)):
            coord.overlap_buckets = overlap
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0, c0 = time.perf_counter(), time.process_time()
            m = coord.update_model_device(models[cid], residual)
            torch.cuda.synchronize()
            runs[mode] = {"model": m, "wall_s": time.perf_counter() - t0,
                          "host_cpu_s": time.process_time() - c0,
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "profile": profile_device_idle(
                              lambda: coord.update_model_device(models[cid], residual))}
        coord.overlap_buckets = 0
        seq, ovl = runs["sequential"].pop("model"), runs["overlapped"].pop("model")
        runs["bitwise_per_bucket"] = [_bits_equal(a, b) for a, b in
                                      zip(seq.coefficients, ovl.coefficients)]
        re_updates[cid] = runs
    result = {
        "buckets": buckets, "build_coordinates_s": build_s, "outer_iterations": ASYNC_OUTER,
        "sync_fit": sync_s, "async_staleness_0_fit": a0_s,
        "async_staleness_1_fit": a1_s, "async_plain_fit": plain_s,
        "sync_update_seconds": sync.update_seconds,
        "async_staleness_1_update_seconds": a1.update_seconds,
        "sync_launches": sync_counts, "launches": a1_counts,
        "sync_peak_mem_gb": sync_mem / 1e9, "async_peak_mem_gb": a1_mem / 1e9,
        "sync_objective_history": sync.objective_history,
        "async_objective_history": a1.objective_history,
        "plain_objective_history": plain.objective_history,
        "sync_auc": sync.validation_metric, "async_auc": a1.validation_metric,
        "async_auc_gap_vs_sync": auc_gap,
        "objective_rel_diff_vs_plain": obj_rel, "auc_diff_vs_plain": auc_vs_plain,
        "staleness_0_bitwise_sync": _same_fit(sync, a0),
        "staleness_1_bitwise_repeat": _same_fit(a1, a1b),
        "fit_profiles": profiles, "re_updates": re_updates,
    }
    emit("train_async_full_width", **result)
    if not (result["staleness_0_bitwise_sync"] and result["staleness_1_bitwise_repeat"]
            and all(all(r["bitwise_per_bucket"]) for r in re_updates.values())
            and obj_rel <= 1e-4 and auc_vs_plain <= 1e-4 and abs(auc_gap) <= 0.02
            and np.isfinite(a1.validation_metric)):
        raise AssertionError("an async gate failed (see the train_async_full_width line)")
    return result


def phase_train_sweep_tuning_full_width(seed: int) -> dict:
    """fit_multiple over per_user λ, RANDOM tuning and resolve_coordinate at
    full width, each against the same work done by hand."""
    from photon_ml_tpu_torch.estimators.random_effect import align_warm_start
    from photon_ml_tpu_torch.estimators.tuning import run_hyperparameter_tuning
    from photon_ml_tpu_torch.models.game import GameModel
    from photon_ml_tpu_torch.ops import launches

    train, val, coords, build_s = _async_setup(seed)
    est = _async_estimator(outer=1)
    base = est.coordinate_configs["per_user"].optimizer
    lambdas = (10.0, 1.0, 0.1)
    configs = [{"per_user": dataclasses.replace(base, regularization_weight=lam)}
               for lam in lambdas]
    seconds = {}
    launches.reset()
    t0 = time.perf_counter()
    fits = est.fit_multiple(train, val, configs=configs, coordinates=coords)
    torch.cuda.synchronize()
    seconds["fit_multiple"] = time.perf_counter() - t0
    counts = launches.counts()
    missing = [k for k in KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"the sweep did not launch {missing}: {counts}")
    metrics = [f.validation_metric for f in fits]
    best = est.select_best_fit(fits)
    by_hand, prev = [], None
    t0 = time.perf_counter()
    for cfg in configs:
        f = est.fit(train, val, initial_models=prev, coordinates={
            **coords, "per_user": est._replace_optimizer(coords["per_user"], cfg["per_user"])})
        by_hand.append(f)
        prev = f.model.models
    torch.cuda.synchronize()
    seconds["by_hand_fits"] = time.perf_counter() - t0
    sweep_bitwise = [_same_fit(a, b) for a, b in zip(fits, by_hand)]

    t0 = time.perf_counter()
    trials = run_hyperparameter_tuning(est, train, val, mode="RANDOM", num_iterations=2,
                                       prior_fits=[fits[best]], coordinates=coords)
    torch.cuda.synchronize()
    seconds["random_tuning_2_trials"] = time.perf_counter() - t0
    trial_vectors = [t.hyperparameters.tolist() for t in trials]

    # resolve_coordinate on the held-out rows (~3 % unseen users) against
    # the best fit's models, and the same update by hand
    models = fits[best].model.models
    t0 = time.perf_counter()
    resolved = est.resolve_coordinate("per_user", val, models)
    torch.cuda.synchronize()
    seconds["resolve_coordinate"] = time.perf_counter() - t0
    meta = est._meta()
    coord = est._build_coordinate("per_user", est.coordinate_configs["per_user"], val)
    others = {c: m for c, m in models.items() if c != "per_user"}
    residual = GameModel(models=others, meta={c: meta[c] for c in others},
                         task=est.task).score(val)
    hand = coord.update_model_device(align_warm_start(models["per_user"], coord.dataset),
                                     residual)
    resolve_bitwise = (resolved.entity_ids == hand.entity_ids and all(
        _bits_equal(a, b) for a, b in zip(resolved.coefficients, hand.coefficients)))
    result = {
        "build_coordinates_s": build_s, "lambdas": lambdas, "validation_aucs": metrics,
        "select_best_fit": best, "best_by_metrics": int(np.argmax(metrics)),
        "sweep_objective_histories": [f.objective_history for f in fits],
        "sweep_bitwise_by_hand": sweep_bitwise, "launches": counts,
        "trial_log10_lambdas": trial_vectors, "trial_aucs": [t.value for t in trials],
        "resolve_entities": resolved.num_entities, "resolve_bitwise_by_hand": resolve_bitwise,
        "seconds": seconds,
    }
    emit("train_sweep_tuning_full_width", **result)
    if not (best == int(np.argmax(metrics)) and all(sweep_bitwise) and resolve_bitwise
            and trial_vectors == RANDOM_TRIALS_LOG10):
        raise AssertionError("a sweep, tuning or resolve gate failed (see its line)")
    return result


# the spans of the training path (the JAX package's names), in the order of
# their sites in algorithm/ and estimators/
TRAINING_SPANS = ("game/fit", "cd/run", "cd/outer_iter", "cd/coordinate", "cd/reconcile",
                  "cd/overlap", "cd/objective", "cd/validate", "fe/solve", "re/train",
                  "re/solve_bucket", "re/adaptive_round")


class counting_barriers:
    """Within the block, counts the stream syncs of device-sync spans
    (``telemetry.span._device_barrier``), still running each."""

    def __enter__(self):
        import importlib

        # the module (the package re-exports a function of the same name)
        span_mod = importlib.import_module("photon_ml_tpu_torch.telemetry.span")
        self._mod, self._real, self.count = span_mod, span_mod._device_barrier, 0

        def counting():
            self.count += 1
            self._real()

        span_mod._device_barrier = counting
        return self

    def __exit__(self, *exc):
        self._mod._device_barrier = self._real
        return False


def _span_records(ledger: str) -> list:
    from photon_ml_tpu_torch.telemetry import validate_ledger

    return [r for r in validate_ledger(ledger) if r["type"] == "span"]


def _worker_spans_chain(spans: list) -> dict:
    """Every cd/overlap and re/solve_bucket span recorded on a thread other
    than the dispatcher's (the thread of cd/run) has its parent, and its
    chain of parents reaches a span of the dispatcher's thread."""
    by_id = {s["span_id"]: s for s in spans}
    dispatcher = next(s["thread"] for s in spans if s["name"] == "cd/run")
    workers = [s for s in spans if s["name"] in ("cd/overlap", "re/solve_bucket")
               and s["thread"] != dispatcher]
    chained = 0
    for s in workers:
        node = s
        while node is not None and node["thread"] != dispatcher:
            node = by_id.get(node["parent_id"])
        chained += node is not None and s["path"].startswith("game/fit/cd/run/")
    return {"dispatcher_thread": dispatcher, "worker_spans": len(workers),
            "chained": chained,
            "worker_threads": sorted({s["thread"] for s in workers})}


def phase_train_telemetry_full_width(seed: int) -> dict:
    """Tracing, the convergence plane, the divergence watchdog and the
    checkpoint fault at full width, on the async phase's coordinates."""
    from photon_ml_tpu_torch import checkpoint as ckpt
    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.event import AnomalyEvent, EventEmitter, EventListener
    from photon_ml_tpu_torch.resilience import InjectedFault, configure_faults, reset_faults
    from photon_ml_tpu_torch.telemetry import (
        ConvergenceTracker,
        DivergenceError,
        analyze_ledger,
        disable_tracing,
        format_report,
        record_memory_watermarks,
        start_run,
        validate_chrome_trace,
        validate_ledger,
    )

    train, val, coords, _ = _async_setup(seed)
    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as root:
        paths = {k: os.path.join(root, k) for k in (
            "ledger.jsonl", "trace.json", "progress.jsonl", "ledger_2.jsonl", "trace_2.json",
            "progress_2.jsonl", "async.jsonl", "diverge.jsonl", "checkpoint")}
        # (a) tracing off and (b) the same fit traced, tracked and with the
        # memory gauges, in turns a, b, b, a; the first b is the main path:
        # counts set to 0 just before, read just after
        def fit_from(estimator, **kwargs):
            """_timed_fit, and the bytes allocated when it starts: the fits
            this phase keeps for its comparisons stay resident."""
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            return (*_timed_fit(estimator, train, val, coords, **kwargs), start)

        def traced_fit(tag: str):
            run = start_run("chip_smoke_telemetry", ledger_path=paths[f"ledger{tag}.jsonl"],
                            trace_path=paths[f"trace{tag}.json"])
            tracker = ConvergenceTracker(ledger_path=paths[f"progress{tag}.jsonl"],
                                         label="chip_smoke")
            try:
                with counting_barriers() as barriers:
                    out = fit_from(_async_estimator(), progress=tracker)
                gauges = record_memory_watermarks()
            finally:
                tracker.finish()
                run.finish()
                disable_tracing()
            return out, barriers.count, gauges

        plain, plain_s, _, plain_mem, plain_start = fit_from(_async_estimator())
        (traced, traced_s, counts, traced_mem, traced_start), syncs, gauges = traced_fit("")
        (traced2, traced2_s, _, traced2_mem, traced2_start), _, _ = traced_fit("_2")
        plain2, plain2_s, _, plain2_mem, plain2_start = fit_from(_async_estimator())
        missing = [k for k in KERNELS if counts[k] < 1]
        if missing:
            raise AssertionError(f"the traced fit did not launch {missing}: {counts}")
        spans = _span_records(paths["ledger.jsonl"])
        trace = validate_chrome_trace(paths["trace.json"])
        validate_chrome_trace(paths["trace_2.json"])
        progress = validate_ledger(paths["progress.jsonl"])
        span_counts = {name: sum(s["name"] == name for s in spans) for name in TRAINING_SPANS}
        walls = {"plain": [plain_s["wall_s"], plain2_s["wall_s"]],
                 "traced": [traced_s["wall_s"], traced2_s["wall_s"]]}
        result.update({
            "fits_in_turn_a_b_b_a": [plain_s, traced_s, traced2_s, plain2_s],
            "wall_ratio_traced_over_plain": sum(walls["traced"]) / sum(walls["plain"]),
            "traced_bitwise_plain": all(_same_fit(plain, f) for f in (traced, traced2, plain2)),
            "launches": counts, "span_counts": span_counts, "spans": len(spans),
            "stream_syncs": syncs,
            "trace_events": len(trace.get("traceEvents", [])),
            "ledger_bytes": os.path.getsize(paths["ledger.jsonl"]),
            "progress_records": len(progress),
            "progress_kinds": sorted({r.get("kind") for r in progress if r["type"] == "progress"}),
            "peak_mem_in_turn_a_b_b_a": [plain_mem, traced_mem, traced2_mem, plain2_mem],
            "peak_over_start_in_turn_a_b_b_a": [
                plain_mem - plain_start, traced_mem - traced_start,
                traced2_mem - traced2_start, plain2_mem - plain2_start],
            "mem_device0_peak_gauge": gauges.get("mem.device0_peak_bytes"),
            "analyze_report": format_report(analyze_ledger(paths["ledger.jsonl"])),
        })

        # (c) the async schedule at staleness 1, untraced and traced (no
        # tracker: the peaks compare tracing alone)
        a_plain, a_plain_s, _, a_plain_mem, a_plain_start = fit_from(
            _async_estimator("async", 1, ASYNC_OUTER))
        run = start_run("chip_smoke_async", ledger_path=paths["async.jsonl"])
        try:
            a_traced, a_traced_s, _, a_traced_mem, a_traced_start = fit_from(
                _async_estimator("async", 1, ASYNC_OUTER))
        finally:
            run.finish()
            disable_tracing()
        async_spans = _span_records(paths["async.jsonl"])
        result.update({
            "async_plain_fit": a_plain_s, "async_traced_fit": a_traced_s,
            "async_peak_over_start_plain_traced": [a_plain_mem - a_plain_start,
                                                    a_traced_mem - a_traced_start],
            "async_traced_bitwise_plain": _same_fit(a_plain, a_traced),
            "async_span_counts": {n: sum(s["name"] == n for s in async_spans)
                                  for n in TRAINING_SPANS},
            "async_chain": _worker_spans_chain(async_spans),
        })

        # (d) the divergence watchdog: the objective of the second update
        # poisoned to inf
        class Collect(EventListener):
            def __init__(self):
                self.events = []

            def on_event(self, event):
                self.events.append(event)

        emitter, collect = EventEmitter(), Collect()
        emitter.register_listener(collect)
        poisoned = ConvergenceTracker(ledger_path=paths["diverge.jsonl"], emitter=emitter,
                                      label="chip_smoke_divergence")
        real_record = CoordinateDescent._record_progress
        calls = [0]

        def poison(self, outer, cid, coord, prev_model, model, objective, loss, reg):
            calls[0] += 1
            if calls[0] >= 2:
                objective = float("inf")
            real_record(self, outer, cid, coord, prev_model, model, objective, loss, reg)

        CoordinateDescent._record_progress = poison
        diverged = None
        try:
            _async_estimator().fit(train, val, coordinates=coords, progress=poisoned)
        except DivergenceError as e:
            diverged = str(e)
        finally:
            CoordinateDescent._record_progress = real_record
            poisoned.finish()
        records = validate_ledger(paths["diverge.jsonl"])
        anomalies = [e for e in collect.events if isinstance(e, AnomalyEvent)]
        result["divergence"] = {
            "raised": diverged, "updates_recorded": calls[0],
            "anomaly_events": [e.kind for e in anomalies],
            "last_record_healthy": records[-1].get("healthy"),
        }

        # (e) train.checkpoint.publish armed once:1: a checkpoint of 1 outer
        # iteration, then the 2-iteration fit resumed from it fails at its
        # next publish; the first generation stays; a resume completes
        ckdir = paths["checkpoint"]
        one = _async_estimator(outer=1)
        one.fit(train, val, coordinates=coords, checkpoint_dir=ckdir)
        configure_faults("train.checkpoint.publish=once:1")
        faulted = None
        try:
            _async_estimator().fit(train, val, coordinates=coords, checkpoint_dir=ckdir)
        except InjectedFault as e:
            faulted = str(e)
        finally:
            reset_faults()
        leftovers = [n for n in os.listdir(root) if n.startswith(".ckpt-")]
        _, state, _ = ckpt.load_training_checkpoint(ckdir, device="cuda")
        resumed = _async_estimator().fit(train, val, coordinates=coords, checkpoint_dir=ckdir)
        result["checkpoint_fault"] = {
            "raised": faulted, "tmp_dirs_left": leftovers,
            "generation_after_fault": state["completed_iterations"],
            "resumed_bitwise_uninterrupted": _same_fit(plain, resumed),
        }
    emit("train_telemetry_full_width", **result)
    div, ck, chain = result["divergence"], result["checkpoint_fault"], result["async_chain"]
    if not (result["traced_bitwise_plain"] and result["async_traced_bitwise_plain"]
            and result["mem_device0_peak_gauge"] == traced_mem
            and all(span_counts[n] > 0 for n in TRAINING_SPANS
                    if n not in ("cd/reconcile", "cd/overlap"))
            and chain["worker_spans"] > 0 and chain["chained"] == chain["worker_spans"]
            and div["raised"] and div["updates_recorded"] == 2
            and div["anomaly_events"] == ["non_finite_objective"]
            and div["last_record_healthy"] is False
            and ck["raised"] and not ck["tmp_dirs_left"] and ck["generation_after_fault"] == 1
            and ck["resumed_bitwise_uninterrupted"]):
        raise AssertionError("a telemetry gate failed (see the train_telemetry_full_width line)")
    return result


def write_libsvm_fixture(path: str, seed: int, n: int, dim: int, task: str, k: int = 16) -> None:
    """LibSVM text rows of ``k`` distinct 1-based features out of ``dim``,
    labels of ``task`` from one coefficient vector drawn from ``seed``
    (features and noise from ``seed`` + the file's own offset)."""
    w = np.random.default_rng(seed).standard_normal(dim) * 0.5
    rng = np.random.default_rng([seed, n])
    cols = _distinct_cols(rng, n, k, dim)
    vals = rng.standard_normal((n, k)) / np.sqrt(k)
    z = (vals * w[cols]).sum(axis=1)
    if task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(z)).astype(str)
    else:
        y = np.char.mod("%.6f", z + 0.3 * rng.standard_normal(n))
    with open(path, "w") as f:
        for r in range(n):
            order = np.argsort(cols[r])
            f.write(y[r] + " " + " ".join(
                f"{cols[r, j] + 1}:{vals[r, j]:.6f}" for j in order) + "\n")


def _model_text(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            name, term, value = line.rstrip("\n").split("\t")[:3]
            out[(name, term)] = float(value)
    return out


def _output_file(path: str):
    """A file's contents for a bitwise comparison of two runs' outputs: an
    Avro file's records (its sync marker is random), else its bytes."""
    from photon_ml_tpu_torch.io.avro import read_avro_file

    if path.endswith(".avro"):
        return list(read_avro_file(path))
    with open(path, "rb") as f:
        return f.read()


# the chapters of --diagnostic-mode ALL with a validation set and more rows
# than features (the JAX package's build_diagnostic_document order)
DIAGNOSIS_CHAPTERS = ["1. Model metrics", "2. Fitting analysis (learning curves)",
                      "3. Bootstrap analysis", "4. Hosmer-Lemeshow calibration",
                      "5. Prediction-error independence", "6. Feature importance"]


def phase_train_glm_cli(seed: int) -> dict:
    from photon_ml_tpu_torch.cli import train_glm
    from photon_ml_tpu_torch.ops import launches

    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_glm_") as root:
        write_cli_fixture(os.path.join(root, "avro_train"), seed, n=8192, fe_dim=256,
                          model_seed=seed)
        write_cli_fixture(os.path.join(root, "avro_val"), seed + 1, n=4096, fe_dim=256,
                          model_seed=seed)
        for task, stem in (("LINEAR_REGRESSION", "linear"), ("POISSON_REGRESSION", "poisson")):
            for part, rows in (("train", 8192), ("val", 4096)):
                write_libsvm_fixture(os.path.join(root, f"{stem}_{part}.txt"), seed, rows,
                                     256, task)
        # the invocations of examples/BASELINE_CONFIGS.md
        invocations = {
            "a_logistic_lbfgs_sweep": [
                "--training-data-dirs", os.path.join(root, "avro_train", "data"),
                "--validation-data-dirs", os.path.join(root, "avro_val", "data"),
                "--task", "LOGISTIC_REGRESSION", "--regularization-weights", "0.1", "1", "10",
                "100", "--optimizer", "LBFGS", "--regularization", "L2"],
            "b_linear_tron_standardized": [
                "--training-data-dirs", os.path.join(root, "linear_train.txt"),
                "--validation-data-dirs", os.path.join(root, "linear_val.txt"),
                "--input-format", "LIBSVM", "--task", "LINEAR_REGRESSION",
                "--optimizer", "TRON", "--regularization", "L2", "--regularization-weights",
                "1", "--normalization-type", "STANDARDIZATION", "--compute-variances"],
            "c_poisson_owlqn_box": [
                "--training-data-dirs", os.path.join(root, "poisson_train.txt"),
                "--input-format", "LIBSVM", "--task", "POISSON_REGRESSION",
                "--regularization", "ELASTIC_NET", "--elastic-net-alpha", "0.5",
                "--regularization-weights", "1",
                "--coefficient-box-constraints", '{"lower": -2.0, "upper": 2.0}'],
        }
        module_out = os.path.join(root, "a_logistic_lbfgs_sweep_module")
        module_t0 = time.perf_counter()
        module_run = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.train_glm",
             *invocations["a_logistic_lbfgs_sweep"], "--output-dir", module_out],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        for name, argv in invocations.items():
            runs = {}
            for device in ("cuda", "cpu"):
                out = os.path.join(root, f"{name}_{device}")
                launches.reset()
                t0 = time.perf_counter()
                res = train_glm.run(train_glm.parse_args(
                    argv + ["--output-dir", out, "--device", device]))
                runs[device] = {
                    "seconds": time.perf_counter() - t0, "launches": launches.counts(),
                    "best_lambda": res["best_lambda"], "metrics": res["metrics"],
                    "selection": json.load(open(os.path.join(out, "selection.json"))),
                    "models": {f.regularization_weight: _model_text(os.path.join(
                        out, f"model-lambda-{f.regularization_weight:g}.txt"))
                        for f in res["fits"]},
                }
            cu, cpu = runs["cuda"], runs["cpu"]
            coef_diff = max(
                abs(cu["models"][lam].get(key, 0.0) - cpu["models"][lam].get(key, 0.0))
                for lam in cu["models"] for key in set(cu["models"][lam]) | set(cpu["models"][lam]))
            metric_diff = max([abs(cu["metrics"][lam] - cpu["metrics"][lam])
                               for lam in cu["metrics"]] or [0.0])
            entry = {
                "cuda_s": cu["seconds"], "cpu_s": cpu["seconds"], "best_lambda": cu["best_lambda"],
                "cpu_best_lambda": cpu["best_lambda"], "metrics": cu["metrics"],
                "cpu_metrics": cpu["metrics"], "max_coefficient_diff": coef_diff,
                "max_metric_diff": metric_diff, "cuda_launches": cu["launches"],
                "coefficients": {str(k): len(v) for k, v in cu["models"].items()},
            }
            result[name] = entry
            if not (cu["selection"]["best_lambda"] == cpu["selection"]["best_lambda"]
                    and metric_diff <= 1e-4 and coef_diff <= 1e-4
                    and all(np.isfinite(v) for m in cu["models"].values() for v in m.values())):
                raise AssertionError(f"train_glm on cuda and cpu differ for {name}: {entry}")
            if name == "c_poisson_owlqn_box" and max(
                    abs(v) for v in cu["models"][1.0].values()) > 2.0:
                raise AssertionError(f"a coefficient left the box [-2, 2]: {entry}")
        # the telemetry flags: every output file bitwise the plain cuda run's
        from photon_ml_tpu_torch.telemetry import validate_chrome_trace, validate_ledger

        out = os.path.join(root, "a_logistic_lbfgs_sweep_telemetry")
        plain_out = os.path.join(root, "a_logistic_lbfgs_sweep_cuda")
        train_glm.run(train_glm.parse_args(invocations["a_logistic_lbfgs_sweep"] + [
            "--output-dir", out, "--device", "cuda",
            "--telemetry-out", os.path.join(root, "glm.jsonl"),
            "--trace-out", os.path.join(root, "glm_trace.json")]))
        ledger = validate_ledger(os.path.join(root, "glm.jsonl"))
        validate_chrome_trace(os.path.join(root, "glm_trace.json"))
        phases = sorted({r["name"] for r in ledger if r["type"] == "span"})
        differ = [name for name in sorted(os.listdir(plain_out))
                  if _output_file(os.path.join(plain_out, name))
                  != _output_file(os.path.join(out, name))]
        result["telemetry"] = {"ledger_records": len(ledger), "span_names": phases,
                               "files_differing_from_plain": differ}
        if differ or not {"preprocess", "train", "validate", "output"} <= set(phases):
            raise AssertionError(f"train_glm with telemetry: {result['telemetry']}")
        # (a) with --diagnostic-mode ALL on cuda and cpu: the same chapters
        # in order, metrics to 1e-4, the report written, a diagnose span
        from photon_ml_tpu_torch.diagnostics import report

        diagnoses = {}
        build = report.build_diagnostic_document
        for device in ("cuda", "cpu"):
            out = os.path.join(root, f"a_diagnose_{device}")
            ledger_path = os.path.join(root, f"diagnose_{device}.jsonl")
            captured = {}

            def capture(*a, **kw):
                captured.update(kw)
                return build(*a, **kw)

            report.build_diagnostic_document = capture
            try:
                t0 = time.perf_counter()
                train_glm.run(train_glm.parse_args(invocations["a_logistic_lbfgs_sweep"] + [
                    "--output-dir", out, "--device", device, "--diagnostic-mode", "ALL",
                    "--telemetry-out", ledger_path]))
                seconds = time.perf_counter() - t0
            finally:
                report.build_diagnostic_document = build
            html = os.path.join(out, "model-diagnostic.html")
            diagnoses[device] = {
                "seconds": seconds, "metrics": captured["metrics"],
                "chapters": re.findall(r"<h2>(.*?)</h2>", open(html).read()),
                "spans": sorted({r["name"] for r in validate_ledger(ledger_path)
                                 if r["type"] == "span"}),
            }
        cu, cpu = diagnoses["cuda"], diagnoses["cpu"]
        metric_diff = max(abs(cu["metrics"][k] - cpu["metrics"][k]) for k in cpu["metrics"])
        result["diagnostic_mode_all"] = {
            "cuda_s": cu["seconds"], "cpu_s": cpu["seconds"], "chapters": cu["chapters"],
            "cpu_chapters": cpu["chapters"], "max_metric_diff": metric_diff,
            "spans": cu["spans"], "cpu_spans": cpu["spans"]}
        if not (cu["chapters"] == cpu["chapters"] == DIAGNOSIS_CHAPTERS
                and metric_diff <= 1e-4 and "diagnose" in cu["spans"]
                and "diagnose" in cpu["spans"]):
            raise AssertionError(f"train_glm --diagnostic-mode ALL: "
                                 f"{result['diagnostic_mode_all']}")
        # the module's own entry point, in a process of its own (started
        # with the in-process runs, above)
        try:
            _, stderr = module_run.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            module_run.kill()
            _, stderr = module_run.communicate()
        if module_run.returncode != 0:
            raise AssertionError(f"python -m train_glm exited {module_run.returncode}: "
                                 f"{stderr[-2000:]}")
        module_sel = json.load(open(os.path.join(module_out, "selection.json")))
        in_process = json.load(open(os.path.join(root, "a_logistic_lbfgs_sweep_cuda",
                                                 "selection.json")))
        result["python_m_s"] = time.perf_counter() - module_t0  # start to reaped
        result["python_m_selection"] = module_sel
        if not (module_sel["best_lambda"] == in_process["best_lambda"] and all(
                abs(module_sel["metrics"][k] - v) <= 1e-4
                for k, v in in_process["metrics"].items())):
            raise AssertionError(f"python -m train_glm differs: {module_sel} vs {in_process}")
    emit("train_glm_cli", **result)
    return result


# serve_full_width: the rows replayed as requests and the model's widths
# (those of score_full_width's model: FE 2^24, per-user 65,536 x 4,096,
# per-item 16,384 x 4,096)
SERVE = {"n": 16_384, "fe_dim": 1 << 24, "fe_k": 16, "n_users": 65_536, "n_items": 16_384}
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_BUDGET_ROWS = 16_384


def _serve_pack_job(job) -> dict:
    """serve_full_width's artifact, in a process of its own: make_glmix's
    model packed with pack_game_model, saved with save_artifact, loaded
    back with load_artifact, and every table and entity index compared
    with the packed one (bitwise)."""
    seed, out = job
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.serving import load_artifact, pack_game_model, save_artifact
    from photon_ml_tpu_torch.types import TaskType

    info = {}
    t0 = time.perf_counter()
    _, coords = make_glmix(seed, **SERVE)
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cpu")
    del coords
    t1 = time.perf_counter()
    packed = pack_game_model(model)
    del model
    t2 = time.perf_counter()
    save_artifact(packed, out)
    t3 = time.perf_counter()
    loaded = load_artifact(out)
    info.update(model_s=t1 - t0, pack_s=t2 - t1, save_s=t3 - t2)
    same = {}
    for cid, table in packed.tables.items():
        back = loaded.tables[cid]
        ok = np.array_equal(np.asarray(table.weights).view(np.uint32),
                            np.asarray(back.weights).view(np.uint32))
        if table.is_random_effect:
            ids = [name for name, _ in sorted(table.entity_index.items(), key=lambda kv: kv[1])]
            ok = ok and np.array_equal(back.entity_index.get_indices(ids), np.arange(len(ids)))
        same[cid] = bool(ok)
    info["round_trip_bitwise"] = same
    # the root of nearline_full_width's delta chain, hashed here, off its path
    from photon_ml_tpu_torch.incremental import fingerprint_dir

    t4 = time.perf_counter()
    info["fingerprint"] = fingerprint_dir(out)
    info["fingerprint_s"] = time.perf_counter() - t4
    info["artifact_bytes"] = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    info["peak_rss_gb"] = _peak_rss_gb()["self"]
    return info


class SpawnPrep:
    """Files a phase reads, made in the background while earlier phases run:
    one spawned process runs ``job((seed, dir))``, started from a thread at
    the lowest CPU priority (nice 19), which the process inherits. ``wait``
    joins it and returns the job's report; ``close`` removes the files."""

    def __init__(self, prefix: str, job, seed: int, subdir: str):
        self.tmp = tempfile.TemporaryDirectory(prefix=prefix)
        self.dir = os.path.join(self.tmp.name, subdir)
        self.info, self.error = {}, None
        self.thread = threading.Thread(target=self._run, args=(job, seed),
                                       name=f"{prefix}prep")
        self.thread.start()

    def _run(self, job, seed: int) -> None:
        import multiprocessing

        try:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except OSError:
                pass
            t0 = time.perf_counter()
            with multiprocessing.get_context("spawn").Pool(1) as pool:
                self.info = pool.apply(job, ((seed, self.dir),))
            self.info["prep_s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised by wait() on the phase's thread
            self.error = e

    def wait(self) -> dict:
        t0 = time.perf_counter()
        self.thread.join()
        self.info["prep_waited_s"] = time.perf_counter() - t0
        if self.error is not None:
            raise RuntimeError(f"preparing {self.dir} failed") from self.error
        return self.info

    def close(self) -> None:
        self.thread.join()
        self.tmp.cleanup()


_SPAWN_PREPS: dict = {}


def _serve_prep(seed: int) -> SpawnPrep:
    """serve_full_width's artifact (_serve_pack_job)."""
    if ("serve", seed) not in _SPAWN_PREPS:
        _SPAWN_PREPS["serve", seed] = SpawnPrep(
            "chip_smoke_serve_", _serve_pack_job, seed, "artifact")
    return _SPAWN_PREPS["serve", seed]


def _cli_fixture_prep(seed: int) -> SpawnPrep:
    """score_game_cli's Avro dataset and model (_cli_fixture_job)."""
    if ("score_cli", seed) not in _SPAWN_PREPS:
        _SPAWN_PREPS["score_cli", seed] = SpawnPrep(
            "chip_smoke_cli_", _cli_fixture_job, seed, "fixture")
    return _SPAWN_PREPS["score_cli", seed]


def _unique_entries(data) -> None:
    """Keep one entry per (row, column) of each shard, the last, as a
    ScoreRequest's features dict keeps it: then GameModel.score of the
    rows and the served requests sum the same terms."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard

    for name, sh in list(data.feature_shards.items()):
        key = sh.rows.astype(np.int64) * sh.dim + sh.cols
        _, last = np.unique(key[::-1], return_index=True)
        keep = np.sort(len(key) - 1 - last)
        data.feature_shards[name] = FeatureShard(sh.rows[keep], sh.cols[keep], sh.vals[keep],
                                                 sh.dim)


def _serve_terms(data, artifact) -> tuple:
    """Per row: sum of |term| over every coordinate's nonzeros (the
    tolerance's scale), from the packed tables on the host."""
    abs_sum = np.zeros(data.num_rows)
    for cid, table in artifact.tables.items():
        sh = data.feature_shards[table.feature_shard]
        w = np.asarray(table.weights)
        if table.is_random_effect:
            ids = np.asarray(data.id_tags[table.random_effect_type]).astype(str)
            erow = table.entity_index.get_indices(list(ids))[sh.rows]
            known = erow >= 0
            term = np.zeros(len(sh.rows))
            term[known] = sh.vals[known] * w[erow[known], sh.cols[known]]
        else:
            term = sh.vals * w[sh.cols]
        np.add.at(abs_sum, sh.rows, np.abs(term))
    return abs_sum


def _check_served(results, expected: np.ndarray, abs_sum: np.ndarray, what: str) -> float:
    """Each result's score against its expected margin: rtol 2e-4 and atol
    1e-5 x max(1, sum |terms|). Returns the largest |difference|."""
    got = np.array([r.score for r in results])
    diff = np.abs(got - expected)
    ok = np.isfinite(got) & (diff <= 2e-4 * np.abs(expected) + 1e-5 * np.maximum(1.0, abs_sum))
    if got.shape != expected.shape or not ok.all():
        bad = int(np.argmin(ok))
        raise AssertionError(f"{what}: {int((~ok).sum())} scores off, e.g. row {bad}: "
                             f"{got[bad]} vs {expected[bad]}")
    return float(diff.max())


def _pageable_upload(device, arrays):
    """``serving.scorer.upload`` with a pageable host buffer and a blocking
    copy: the other arm of ``_upload_ab``."""
    from photon_ml_tpu_torch.serving.scorer import _TORCH_DTYPE

    arrays = [np.ascontiguousarray(a) for a in arrays]
    starts, at = [], 0
    for a in arrays:
        starts.append(at)
        at += -(-a.nbytes // 8) * 8
    buf = np.empty(at, dtype=np.uint8)
    for a, s in zip(arrays, starts):
        buf[s:s + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[s:s + a.nbytes].view(_TORCH_DTYPE[a.dtype.str]).view(a.shape)
            for a, s in zip(arrays, starts)]


def _upload_ab(sharded, requests, want) -> dict:
    """Sealed replays of ``requests`` with the scorer's uploads (pinned,
    queued) and with ``_pageable_upload``, in turns (pageable, pageable,
    pinned; the (b) replay before them was pinned): latency p50/p99, rate
    and the stages' p50 of each. Every replay scores bitwise ``want``."""
    from photon_ml_tpu_torch.serving import RequestPlane, replay_requests
    from photon_ml_tpu_torch.serving import sharded as sharded_module

    pinned = sharded_module.upload
    out = []
    try:
        for arm in ("pageable", "pageable", "pinned"):
            sharded_module.upload = _pageable_upload if arm == "pageable" else pinned
            plane = RequestPlane(sample_rate=1, seed=0)
            res, snap = replay_requests(sharded, requests, bucket_sizes=SERVE_BUCKETS,
                                        plane=plane)
            if [r.score for r in res] != [r.score for r in want]:
                raise AssertionError(f"the {arm} upload's sealed replay differs from (b)")
            stages = snap.get("request_plane", {}).get("stages") or {}
            out.append({"arm": arm, "latency_p50_s": snap["latency_p50_s"],
                        "latency_p99_s": snap["latency_p99_s"],
                        "requests_per_s": snap["requests_per_s"],
                        "stage_p50_s": {k: v["p50_s"] for k, v in stages.items()}})
    finally:
        sharded_module.upload = pinned
    return {"turns": out}


def _replay_summary(snap: dict) -> dict:
    keys = ("num_requests", "num_batches", "latency_p50_s", "latency_p99_s",
            "queue_wait_p99_s", "requests_per_s", "replay_requests_per_s",
            "batch_fill_ratio", "xla_compiles")
    return {k: snap.get(k) for k in keys}


def _launch_count(fn, calls: int = 8) -> dict:
    """Device activity of one call of ``fn`` under torch.profiler: kernels
    and copies (memcpy / memset) it put on the card, over ``calls`` calls
    after two warm-up steps (a profile of a single call lost some of its
    events to the tracer's start), divided by ``calls``; the kernels'
    names with their count a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    names = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=calls, repeat=1),
                 on_trace_ready=lambda p: names.extend(
                     # the steps' own marks sit on the device track too
                     n for n, _, _ in _device_events(p) if not n.startswith("ProfilerStep"))
                 ) as prof:
        for _ in range(2 + calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    copies = [n for n in names if "memcpy" in n.lower() or "memset" in n.lower()]
    kernels = [n[:60] for n in names if "memcpy" not in n.lower() and "memset" not in n.lower()]
    return {"kernels": len(kernels) / calls, "copies": len(copies) / calls,
            "kernel_names": {k: kernels.count(k) / calls for k in sorted(set(kernels))},
            "copy_names": {c: copies.count(c) / calls for c in sorted(set(copies))}}


def _tail_prefix(requests, artifact, routing, cids) -> int:
    """The longest prefix of ``requests`` whose entities beyond each
    coordinate's resident base fit its admission headroom: after a drain,
    every known entity of the prefix is resident."""
    seen = {cid: set() for cid in cids}
    for i, req in enumerate(requests):
        for cid in cids:
            table = artifact.tables[cid]
            eid = req.entity_ids.get(table.random_effect_type)
            if eid is None:
                continue
            row = table.entity_index.get_index(eid)
            coord = routing[cid]
            if row >= coord.base_rows:
                seen[cid].add(row)
                if len(seen[cid]) > coord.device_rows - coord.base_rows:
                    return i
    return len(requests)


def _split_table_replays(artifact, nnz, requests, reference, abs_sum, cold_a, res_b) -> tuple:
    """Mode (a) on a serving mesh of 4 positions on cuda:0: every RE table's
    4 shards split into 4 blocks (a SplitTable each half). Its continuous
    replay (scores against GameModel.score, the cold coordinates (a)'s), a
    sealed replay bitwise (b)'s, and a mesh naming a card this machine
    lacks refused. Returns (the mode's summary, its compile count).
    Ends with a garbage collection: a scorer and its admission controller
    hold each other, and the tables would outlive the phase until one."""
    from photon_ml_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh
    from photon_ml_tpu_torch.serving import (
        AdmissionController, ShardedGameScorer, replay_requests)

    mesh = data_parallel_mesh(devices=["cuda:0"] * 4)
    split = ShardedGameScorer(artifact, max_nnz=nnz, num_shards=4, device="cuda", mesh=mesh)
    blocks = {cid: [[list(b.shape), str(b.device)] for b in p.table.blocks]
              for cid, p in split._providers.items() if p.split}
    if len(blocks) != len(split._providers):
        raise AssertionError(f"(a) split: not every table split over the mesh: {blocks}")
    adm = AdmissionController([split], admit_batch=64)
    split.attach_admission(adm)
    adm.warmup()
    for b in SERVE_BUCKETS:
        split.score_batch(requests[:b], b)
    res, snap = replay_requests([split], requests, bucket_sizes=SERVE_BUCKETS,
                                continuous=True, max_wait_s=0.002, admission=adm)
    summary = {**_replay_summary(snap), "blocks": blocks, "table_bytes": split.table_bytes(),
               "max_abs_err": _check_served(res, reference, abs_sum, "(a) split")}
    if [r.cold_coordinates for r in res] != cold_a:
        raise AssertionError("(a) split: cold coordinates differ from (a)'s")
    head = SERVE["n"] // 4  # every block's rows, in a quarter of the replay's time
    sealed, _ = replay_requests(split, requests[:head], bucket_sizes=SERVE_BUCKETS)
    summary["sealed_bitwise_one_table"] = ([r.score for r in sealed]
                                           == [r.score for r in res_b[:head]])
    if not summary["sealed_bitwise_one_table"]:
        raise AssertionError("(a) split: sealed scores differ from the one table's (atol 0)")
    missing = f"cuda:{torch.cuda.device_count()}"
    try:
        ShardedGameScorer(artifact, max_nnz=nnz, num_shards=4,
                          mesh=Mesh(["cuda:0", missing], ("data",)))
        summary["refusal"] = "not refused"
    except ValueError as e:
        summary["refusal"] = str(e)
    if f"names {missing}" not in summary["refusal"]:
        raise AssertionError(f"a mesh naming {missing}: {summary['refusal']}")
    count = split.compile_count
    del split, adm
    gc.collect()
    return summary, count


def phase_serve_full_width(seed: int) -> dict:
    """Online serving of score_full_width's model (see the module doc)."""
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.serving import (
        AdmissionController, GameScorer, RequestPlane, ShardedGameScorer, load_artifact,
        max_nnz_of, replay_requests, requests_from_game_data)
    from photon_ml_tpu_torch.serving.scorer import featurize_requests
    from photon_ml_tpu_torch.types import TaskType

    torch.cuda.reset_peak_memory_stats()
    prep = _serve_prep(seed)
    result = {"rows": SERVE["n"], "buckets": list(SERVE_BUCKETS), "prep": prep.wait()}
    if not all(result["prep"]["round_trip_bitwise"].values()):
        raise AssertionError(f"artifact round trip not bitwise: {result['prep']}")
    t0 = time.perf_counter()
    data, coords = make_glmix(seed, **SERVE)
    _unique_entries(data)
    # the offline path of score_full_width: the fused engine's CSR kernel
    # (at 16,384 rows "auto" would pick the plain ELL layout)
    coords["fixed"]["sparse_engine"] = "fused"
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cuda")
    del coords
    artifact = load_artifact(prep.dir)
    requests = requests_from_game_data(data, artifact)
    nnz = max_nnz_of(requests)
    abs_sum = _serve_terms(data, artifact)
    result["setup_s"] = time.perf_counter() - t0
    result["max_nnz"] = nnz

    # the reference: GameModel.score of the same rows on the card, the
    # fixed effect through csr_matvec_f32
    launches.reset()
    terms = {cid: model.score_coordinate(cid, data).double().cpu().numpy()
             for cid in model.models}
    torch.cuda.synchronize()
    result["reference_launches"] = {k: v for k, v in launches.counts().items() if v}
    if result["reference_launches"].get("csr_matvec_f32", 0) < 1:
        raise AssertionError(f"GameModel.score launched no csr_matvec_f32: "
                             f"{result['reference_launches']}")
    reference = sum(terms.values()) + data.offsets
    del model

    def expected(results) -> np.ndarray:
        """The reference with each result's cold coordinates left out."""
        out = reference.copy()
        for i, r in enumerate(results):
            for cid in r.cold_coordinates:
                out[i] -= terms[cid][i]
        return out

    modes, launches_seen = {}, {}
    launches.reset()
    # (a) the default: sharded, 4 shards, continuous batching, 2 ms deadline
    sharded = ShardedGameScorer(artifact, max_nnz=nnz, num_shards=4, device="cuda")
    adm_a = AdmissionController([sharded], admit_batch=64)
    sharded.attach_admission(adm_a)
    adm_a.warmup()
    # a batch of every bucket before traffic, as a server warms up: the
    # card's first launches of the score's kernels are in these, not in
    # the replay's tail
    warm_ms = {}
    for b in SERVE_BUCKETS:
        t0 = time.perf_counter()
        sharded.score_batch(requests[:b], b)
        warm_ms[b] = (time.perf_counter() - t0) * 1e3
    result["warmup_batch_ms"] = warm_ms
    res_a, snap = replay_requests([sharded], requests, bucket_sizes=SERVE_BUCKETS,
                                  continuous=True, max_wait_s=0.002, admission=adm_a)
    modes["a_sharded_continuous"] = {**_replay_summary(snap),
                                     "max_abs_err": _check_served(res_a, reference, abs_sum, "(a)")}
    cold_a = [r.cold_coordinates for r in res_a]
    unknown = {cid: np.asarray(artifact.tables[cid].entity_index.get_indices(
        list(np.asarray(data.id_tags[artifact.tables[cid].random_effect_type]).astype(str))))
        < 0 for cid in terms if cid != "fixed"}
    want_cold = [tuple(c for c in sorted(unknown) if unknown[c][i]) for i in range(len(res_a))]
    if cold_a != want_cold:
        raise AssertionError("(a): cold coordinates are not exactly the unknown entities")
    result["table_bytes"] = sharded.table_bytes()

    # (b) sealed, the same scorer, with every request's stages sampled
    plane = RequestPlane(sample_rate=1, seed=0)
    res_b, snap = replay_requests(sharded, requests, bucket_sizes=SERVE_BUCKETS, plane=plane)
    res_b2, _ = replay_requests(sharded, requests, bucket_sizes=SERVE_BUCKETS)
    full_table = GameScorer(artifact, max_nnz=nnz, device="cuda")
    res_full, _ = replay_requests(full_table, requests, bucket_sizes=SERVE_BUCKETS)
    modes["b_sharded_sealed"] = {**_replay_summary(snap),
                                 "max_abs_err": _check_served(res_b, reference, abs_sum, "(b)"),
                                 "stages": snap.get("request_plane", {}).get("stages")}
    if [r.score for r in res_b] != [r.score for r in res_b2]:
        raise AssertionError("two sealed replays differ")
    if [r.score for r in res_b] != [r.score for r in res_full]:
        raise AssertionError("sealed sharded scores differ from the full table's (atol 0)")
    del full_table
    # the sealed replay with the batch's copies from pinned memory, queued
    # (the scorer's), against pageable blocking copies, in turns after (b)
    # on the first half of the rows: the split table's replays below took
    # the other half's time
    t0 = time.perf_counter()
    result["upload_ab"] = _upload_ab(sharded, requests[:SERVE["n"] // 2],
                                     res_b[:SERVE["n"] // 2])
    result["upload_ab_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    modes["a_split_mesh4_continuous"], split_counts = _split_table_replays(
        artifact, nnz, requests, reference, abs_sum, cold_a, res_b)
    result["split_table_s"] = time.perf_counter() - t0

    # (c) cached: an LRU of 4,096 rows a coordinate in front of the host tables
    cached = GameScorer(artifact, max_nnz=nnz, cache_capacity=4096, device="cuda")
    res_c, snap = replay_requests(cached, requests, bucket_sizes=SERVE_BUCKETS)
    modes["c_cached_sealed"] = {**_replay_summary(snap),
                                "cache_hit_rate": snap.get("cache_hit_rate"),
                                "max_abs_err": _check_served(res_c, reference, abs_sum, "(c)")}
    if [r.score for r in res_c] != [r.score for r in res_full]:
        raise AssertionError("cached scores differ from the full table's (atol 0)")
    compile_counts = {"a_b": sharded.compile_count, "c": cached.compile_count,
                      "a_split": split_counts}
    del cached

    # (d) 16,384 device rows a coordinate: the cold tail admitted by the
    # background thread while serving, over the longest prefix whose tail
    # fits the headroom; a second replay after drain() equals (a)
    budget = ShardedGameScorer(artifact, max_nnz=nnz, num_shards=4, device="cuda",
                               device_budget_rows=SERVE_BUDGET_ROWS)
    adm_d = AdmissionController([budget], admit_batch=64)
    budget.attach_admission(adm_d)
    adm_d.warmup()
    re_cids = [cid for cid in terms if cid != "fixed"]
    prefix = _tail_prefix(requests, artifact, budget.routing, re_cids)
    res_d, snap = replay_requests([budget], requests[:prefix], bucket_sizes=SERVE_BUCKETS,
                                  continuous=True, max_wait_s=0.002, admission=adm_d)
    exp_d = expected(res_d)
    deferred = sum(1 for r, w in zip(res_d, want_cold) if r.cold_coordinates != w)
    adm_d.drain()
    res_d2, snap2 = replay_requests([budget], requests[:prefix], bucket_sizes=SERVE_BUCKETS,
                                    continuous=True, max_wait_s=0.002, admission=adm_d)
    if [r.cold_coordinates for r in res_d2] != cold_a[:prefix]:
        raise AssertionError("(d) after drain: a known entity is still not resident")
    modes["d_budget_continuous"] = {
        **_replay_summary(snap), "prefix_rows": prefix,
        "served_before_admission": deferred,
        "max_abs_err": _check_served(res_d, exp_d[:prefix], abs_sum[:prefix], "(d)"),
        "after_drain": {**_replay_summary(snap2), "max_abs_err_vs_a": _check_served(
            res_d2, np.array([r.score for r in res_a[:prefix]]), abs_sum[:prefix],
            "(d) after drain vs (a)")},
        "admission": snap2.get("admission"),
    }
    if deferred == 0:
        raise AssertionError("(d): no request was served before its rows were admitted")
    compile_counts["d"] = budget.compile_count
    launches_seen = {k: v for k, v in launches.counts().items() if v}
    if launches_seen:
        raise AssertionError(f"the serving replays launched port kernels: {launches_seen}")
    if max(compile_counts.values()) > len(SERVE_BUCKETS):
        raise AssertionError(f"compile counts {compile_counts} over {len(SERVE_BUCKETS)}")
    result.update(modes=modes, compile_counts=compile_counts)

    # one admission step: 64 tail rows, evicting as many (host us, card synced)
    tail = np.arange(SERVE["n_users"] - 64 * 11, SERVE["n_users"])
    step_us = []
    for i in range(11):
        adm_d.note_deferred("per_userId", tail[64 * i:64 * (i + 1)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adm_d.step()
        torch.cuda.synchronize()
        step_us.append((time.perf_counter() - t0) * 1e6)
    result["admission_step_us_median"] = statistics.median(step_us[1:])
    result["admission_steps"] = adm_d.steps
    del budget

    # one batch at buckets 1 and 32: per call (events around it, the host
    # work inside) and 32 back to back; featurize alone on the host
    ms = cuda_ms({f"bucket_{b}": (lambda b=b: sharded.score_batch(requests[:b], b))
                  for b in (1, 32)}, reps=20, rounds=4, batch=32)
    result["score_batch"] = {f"bucket_{b}": {"ms": ms[f"bucket_{b}"],
                                             "device_ms": ms[f"bucket_{b}_device"]}
                             for b in (1, 32)}
    result["featurize_host_us"] = {
        f"bucket_{b}": host_us(lambda b=b: featurize_requests(
            requests[:b], b, b, sharded._shard_nnz, sharded._shard_dim), n=200)
        for b in (1, 32)}
    result["launches_per_batch"] = {
        f"bucket_{b}": _launch_count(lambda b=b: sharded.score_batch(requests[:b], b))
        for b in (1, 32)}
    result["replay_profile"] = profile_device_idle(lambda: replay_requests(
        sharded, requests[:2048], bucket_sizes=SERVE_BUCKETS))
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result["card"] = nvidia_smi()
    emit("serve_full_width", **result)
    return result


class captured_replays:
    """Inside: every replay_requests call (the one the serve_game CLI makes
    included) keeps its results in ``runs``, every TenancyPlane.replay
    (serve_game --variants) its results in ``tenancy_runs``."""

    def __enter__(self):
        import photon_ml_tpu_torch.serving as serving
        from photon_ml_tpu_torch.serving.tenancy import TenancyPlane

        self.runs, self.tenancy_runs = [], []
        self._serving, self._real = serving, serving.replay_requests
        self._plane, self._real_tenancy = TenancyPlane, TenancyPlane.replay

        def replay(*args, **kwargs):
            results, snap = self._real(*args, **kwargs)
            self.runs.append(results)
            return results, snap

        def tenancy_replay(plane, *args, **kwargs):
            results = self._real_tenancy(plane, *args, **kwargs)
            self.tenancy_runs.append(results)
            return results

        serving.replay_requests = replay
        TenancyPlane.replay = tenancy_replay
        return self

    def __exit__(self, *exc):
        self._serving.replay_requests = self._real
        self._plane.replay = self._real_tenancy


def _http_get(port: int, path: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def _serve_with_introspection(serve_game, argv: list, root: str) -> dict:
    """One serve_game run held open after its replay: /healthz, /varz,
    /metrics and /requests read from the port it wrote, then
    /quitquitquit."""
    port_file = os.path.join(root, "port")
    if os.path.exists(port_file):
        os.remove(port_file)
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("snapshot", serve_game.run(
        serve_game.parse_args(argv + ["--introspect-port", "0", "--introspect-port-file",
                                      port_file, "--introspect-hold", "120"]))))
    run.start()
    try:
        deadline = time.monotonic() + 300
        while not (os.path.exists(port_file) and open(port_file).read()):
            if time.monotonic() > deadline or not run.is_alive():
                raise AssertionError("serve_game wrote no introspection port")
            time.sleep(0.01)
        port = int(open(port_file).read())
        while True:
            status, body = _http_get(port, "/healthz")
            if json.loads(body)["phase"] == "drained" or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        out["healthz"] = json.loads(body)
        out["varz"] = json.loads(_http_get(port, "/varz")[1])
        out["metrics_lines"] = len(_http_get(port, "/metrics")[1].splitlines())
        out["requests_route"] = _http_get(port, "/requests")[0]
        _http_get(port, "/quitquitquit")
    finally:
        run.join(timeout=300)
    if run.is_alive() or "snapshot" not in out:
        raise AssertionError("serve_game did not finish after /quitquitquit")
    if not out["healthz"]["healthy"] or out["healthz"]["phase"] != "drained":
        raise AssertionError(f"/healthz: {out['healthz']}")
    return out


def phase_serve_game_cli(seed: int, n: int = 4096) -> dict:
    """The serve_game CLI on cuda and on cpu (see the module doc)."""
    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.serving import load_tuned_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_cli_") as root:
        t0 = time.perf_counter()
        write_cli_fixture(root, seed, n=n, n_users=1024, n_items=256)
        result = {"rows": n, "fixture_s": time.perf_counter() - t0}
        data = os.path.join(root, "data")
        runs = {}
        for device in ("cuda", "cpu"):
            art = os.path.join(root, f"artifact_{device}")
            t0 = time.perf_counter()
            with captured_replays() as cap:
                export = serve_game.run(serve_game.parse_args([
                    "--model-dir", os.path.join(root, "model"), "--data-dirs", data,
                    "--export-artifact-dir", art, "--max-requests", "2048",
                    "--device", device]))
                live = _serve_with_introspection(serve_game, [
                    "--artifact-dir", art, "--data-dirs", data, "--max-requests", "2048",
                    "--slo-latency-ms", "1000", "--overload-control",
                    "--request-sample-rate", "1", "--tenants", "a,b", "--device", device],
                    root)
            runs[device] = {"export": export, "live": live, "scores": cap.runs,
                            "seconds": time.perf_counter() - t0}
        cu, cpu = runs["cuda"], runs["cpu"]
        for field in ("num_requests", "xla_compiles"):
            for a, b in ((cu["export"], cpu["export"]),
                         (cu["live"]["snapshot"], cpu["live"]["snapshot"])):
                if a[field] != b[field]:
                    raise AssertionError(f"serve_game {field}: cuda {a[field]} cpu {b[field]}")
        # each device replayed twice (the export run and the live run): a
        # capture that caught fewer compares nothing
        if not len(cu["scores"]) == len(cpu["scores"]) >= 2:
            raise AssertionError(f"serve_game replays captured: cuda {len(cu['scores'])}, "
                                 f"cpu {len(cpu['scores'])}, want 2 each")
        max_diff = 0.0
        for a, b in zip(cu["scores"], cpu["scores"]):
            sa, sb = np.array([r.score for r in a]), np.array([r.score for r in b])
            if sa.shape != sb.shape or [r.request_id for r in a] != [r.request_id for r in b]:
                raise AssertionError("serve_game cuda and cpu replayed different requests")
            if not np.allclose(sa, sb, rtol=2e-4, atol=1e-5):
                raise AssertionError(f"serve_game cuda and cpu scores differ by "
                                     f"{float(np.abs(sa - sb).max())}")
            max_diff = max(max_diff, float(np.abs(sa - sb).max()))
        result.update({
            "cuda_s": cu["seconds"], "cpu_s": cpu["seconds"], "max_score_diff": max_diff,
            "replays_compared": len(cu["scores"]),
            "requests": cu["export"]["num_requests"],
            "compile_count": cu["export"]["xla_compiles"],
            "live_tenants": cu["live"]["varz"].get("tenants"),
            "live_slo": cu["live"]["snapshot"].get("slo", {}).get("burn_rate"),
            "metrics_lines": cu["live"]["metrics_lines"],
            "artifact_entries": sorted(os.listdir(os.path.join(root, "artifact_cuda"))),
        })
        art = os.path.join(root, "artifact_cuda")
        # --auto-tune persists a tuned config that the next boot applies
        tuned_run = serve_game.run(serve_game.parse_args([
            "--artifact-dir", art, "--data-dirs", data, "--max-requests", "512",
            "--auto-tune", "--auto-tune-warmup", "128", "--device", "cuda"]))
        tuned = load_tuned_config(art)
        boot = serve_game.run(serve_game.parse_args([
            "--artifact-dir", art, "--data-dirs", data, "--max-requests", "256",
            "--device", "cuda"]))
        want_buckets = tuned.get("serving.bucket_sizes") if tuned else None
        if tuned is None or "auto_tune" not in tuned_run or (
                want_buckets and boot["bucket_sizes"] != [int(b) for b in want_buckets]):
            raise AssertionError(f"auto-tune: tuned {tuned}, boot buckets {boot['bucket_sizes']}")
        result["auto_tune"] = {"tuned_config": tuned, "boot_bucket_sizes": boot["bucket_sizes"]}
        modes = {}
        for name, flags in (("cached", ["--cache-capacity", "64"]), ("sealed", ["--sealed"]),
                            ("scorers_2", ["--scorers", "2"])):
            snap = serve_game.run(serve_game.parse_args([
                "--artifact-dir", art, "--data-dirs", data, "--max-requests", "1024",
                "--bucket-sizes", "1,2,4,8,16,32", "--device", "cuda", *flags]))
            modes[name] = {"serving_mode": snap["serving_mode"],
                           "num_scorers": snap["num_scorers"],
                           "num_requests": snap["num_requests"],
                           "latency_p99_s": snap["latency_p99_s"]}
            if snap["num_requests"] != 1024 or snap["xla_compiles"] > 6:
                raise AssertionError(f"serve_game {name}: {snap}")
        result["modes"] = modes
        result["nearline"] = _nearline_cli(root, art, data)
    emit("serve_game_cli", **result)
    return result


def _cli_fixture_config(root: str) -> str:
    """write_cli_fixture's coordinates as an update_game config: FE +
    per_userId + per_itemId, L-BFGS 10 iterations, L2 lambda 1."""
    opt = {"optimizer": "LBFGS", "max_iterations": 10, "regularization": "L2",
           "regularization_weight": 1.0}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_item": {"feature_bags": ["itemFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global", "optimizer": opt},
            "per_userId": {"type": "random", "feature_shard": "per_user",
                           "random_effect_type": "userId", "optimizer": opt},
            "per_itemId": {"type": "random", "feature_shard": "per_item",
                           "random_effect_type": "itemId", "optimizer": opt},
        },
        "update_order": ["fixed", "per_userId", "per_itemId"],
    }
    path = os.path.join(root, "update_game.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _compare_replays(cuda_runs: list, cpu_runs: list, what: str) -> float:
    """The same number (>= 1) of replays on each device, of the same
    requests, scores within rtol 2e-4, atol 1e-5; the largest difference."""
    if not len(cuda_runs) == len(cpu_runs) >= 1:
        raise AssertionError(f"{what}: replays captured: cuda {len(cuda_runs)}, "
                             f"cpu {len(cpu_runs)}")
    worst = 0.0
    for a, b in zip(cuda_runs, cpu_runs):
        sa, sb = np.array([r.score for r in a]), np.array([r.score for r in b])
        if sa.shape != sb.shape or [r.request_id for r in a] != [r.request_id for r in b]:
            raise AssertionError(f"{what}: cuda and cpu replayed different requests")
        if not np.allclose(sa, sb, rtol=2e-4, atol=1e-5):
            raise AssertionError(f"{what}: cuda and cpu scores differ by "
                                 f"{float(np.abs(sa - sb).max())}")
        worst = max(worst, float(np.abs(sa - sb).max()))
    return worst


def _nearline_cli(root: str, art: str, data: str) -> dict:
    """update_game on cuda and cpu (two chained deltas over the exported
    artifact ``art``, then --compact-into), serve_game --watch-deltas
    picking up the cuda chain, and serve_game --variants with tenants and
    quotas, each on cuda and cpu: equal counts, scores within rtol 2e-4."""
    from photon_ml_tpu_torch.cli import serve_game, update_game
    from photon_ml_tpu_torch.incremental import fingerprint_dir

    cfg = _cli_fixture_config(root)
    base_fp = fingerprint_dir(art)
    out, updates = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        deltas = os.path.join(root, f"deltas_{device}")
        argv = ["--base-artifact-dir", art, "--model-dir", os.path.join(root, "model"),
                "--coordinate-config", cfg, "--events-data-dirs", data,
                "--output-dir", deltas, "--device", device]
        compacted = os.path.join(root, f"compacted_{device}")
        runs = [update_game.run(update_game.parse_args(argv)),
                update_game.run(update_game.parse_args(
                    argv + ["--refresh-fixed-iterations", "1", "--compact-into", compacted]))]
        if ([r["generation"] for r in runs] != [1, 2] or runs[0]["base_fingerprint"] != base_fp
                or runs[1]["base_fingerprint"] != runs[0]["fingerprint"]
                or runs[1]["compacted_fingerprint"] != fingerprint_dir(compacted)
                or runs[1]["fixed_effects_refreshed"] != ["fixed"]):
            raise AssertionError(f"update_game on {device}: {runs}")
        updates[device] = runs
        out[f"update_{device}_s"] = time.perf_counter() - t0
    keys = ("rows_updated", "num_events", "touched_entities", "new_entities")
    for a, b in zip(updates["cuda"], updates["cpu"]):
        if {k: a[k] for k in keys} != {k: b[k] for k in keys}:
            raise AssertionError(f"update_game cuda {a} cpu {b}")
    out["update_game"] = {k: updates["cuda"][0][k] for k in keys}
    watched, variant = {}, {}
    for device in ("cuda", "cpu"):
        with captured_replays() as cap:
            snap = serve_game.run(serve_game.parse_args([
                "--artifact-dir", art, "--data-dirs", data, "--max-requests", "2048",
                "--watch-deltas", os.path.join(root, "deltas_cuda"), "--watch-chunk", "512",
                "--device", device]))
        watched[device] = (snap, cap.runs)
        with captured_replays() as cap:
            snap = serve_game.run(serve_game.parse_args([
                "--artifact-dir", art, "--data-dirs", data, "--max-requests", "2048",
                "--variants", "a,b", "--variant-ramp", "10", "--tenants", "t1,t2",
                "--tenant-rate", "0.001", "--tenant-burst", "600", "--slo-latency-ms", "1000",
                "--device", device]))
        variant[device] = (snap, cap.tenancy_runs)
    (wcu, runs_cu), (wcpu, runs_cpu) = watched["cuda"], watched["cpu"]
    swaps = [[(r["generation"], r["rolled_back"], r["rows_updated"]) for r in w["swap_reports"]]
             for w in (wcu, wcpu)]
    if swaps[0] != swaps[1] or [g for g, _, _ in swaps[0]] != [1, 2] or any(
            rb for _, rb, _ in swaps[0]):
        raise AssertionError(f"serve_game --watch-deltas swaps: cuda {swaps[0]} cpu {swaps[1]}")
    for field in ("num_requests", "xla_compiles"):
        if wcu[field] != wcpu[field]:
            raise AssertionError(f"serve_game --watch-deltas {field}: cuda {wcu[field]} "
                                 f"cpu {wcpu[field]}")
    out["watch_deltas"] = {"swaps": swaps[0], "num_requests": wcu["num_requests"],
                           "blackout_s": [r["blackout_s"] for r in wcu["swap_reports"]],
                           "max_score_diff": _compare_replays(runs_cu, runs_cpu,
                                                              "--watch-deltas")}
    (vcu, served_cu), (vcpu, served_cpu) = variant["cuda"], variant["cpu"]
    for field in ("num_results", "serving_mode"):
        if vcu[field] != vcpu[field]:
            raise AssertionError(f"serve_game --variants {field}: cuda {vcu[field]} "
                                 f"cpu {vcpu[field]}")
    tc, tp = vcu["tenancy"], vcpu["tenancy"]
    if (tc["router"] != tp["router"] or tc["variants"] != tp["variants"]
            or tc["quota"] != tp["quota"] or vcu["serving_mode"] != "sharded-tenancy"):
        raise AssertionError(f"serve_game --variants: cuda {tc} cpu {tp}")
    # the tenancy plane's results come in completion order: compared by id
    by_id = [[sorted(r, key=lambda x: x.request_id) for r in runs]
             for runs in (served_cu, served_cpu)]
    if not (len(by_id[0]) == 1 and len(by_id[0][0]) == vcu["num_results"] > 0):
        raise AssertionError(f"serve_game --variants: captured {[len(r) for r in by_id[0]]} "
                             f"replays, want one of {vcu['num_results']} results")
    out["variants"] = {"num_results": vcu["num_results"], "router": tc["router"],
                       "max_score_diff": _compare_replays(*by_id, "--variants"),
                       "quota": tc["quota"], "latency_p99_s": vcu.get("latency_p99_s"),
                       "tenants": {t: d["slo"]["verdict"] for t, d in tc.get("tenants", {}).items()}}
    return out


# nearline_full_width: the events batch (bench.py _build_serving_workload
# :803 draws entities Zipf(1.3)), the RE data configuration's active cap and
# buckets (the reference's activeCap bounds a Zipf head entity's samples),
# and the sizes of the replay, the gate and the scenarios
NEARLINE = {"events": 65_536, "fe_k": 16, "re_k": 16, "new": 0.01, "zipf": 1.3,
            "active_cap": 256, "re_buckets": 4, "requests": 16_384, "gate_rows": 4_096,
            "headroom": 1.0, "scenario_phases": 8}


def make_nearline_events(seed: int, coords: dict, model, n: int, fe_dim: int, device: str):
    """A fresh events batch for ``coords``' model: FE ``fe_k`` distinct
    columns in [1, fe_dim) plus column 0 at 1.0 (an intercept) a row, each
    random effect ``re_k`` nonzeros (12 inside the entity's projected
    space, 4 anywhere), entities Zipf(1.3) over the model's ids with about 1 %
    new ids, labels drawn from the model's own probabilities (scored on
    ``device``)."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    cfg = NEARLINE
    rng = np.random.default_rng(seed + 16)
    fe_k, re_k = cfg["fe_k"], cfg["re_k"]
    fe_cols = np.sort(1 + _distinct_cols(rng, n, fe_k, fe_dim - 1), axis=1)
    fe_cols = np.concatenate([np.zeros((n, 1), np.int64), fe_cols], axis=1)
    fe_vals = np.concatenate([np.ones((n, 1), np.float32),
                              rng.standard_normal((n, fe_k), dtype=np.float32)], axis=1)
    shards = {"global": FeatureShard(np.repeat(np.arange(n, dtype=np.int64), fe_k + 1),
                                     fe_cols.reshape(-1), fe_vals.reshape(-1), fe_dim)}
    id_tags = {}
    for re_type, shard, prefix in (("userId", "per_user", "u"), ("itemId", "per_item", "i")):
        c = coords[f"per_{re_type}"]
        pidx, count, re_dim = c["proj_indices"][0], len(c["entity_ids"][0]), c["global_dim"]
        ent = (rng.zipf(cfg["zipf"], n) - 1) % count
        new = rng.random(n) < cfg["new"]
        id_tags[re_type] = np.where(new, np.char.add(f"new_{prefix}", ent.astype(str)),
                                    np.char.add(prefix, ent.astype(str)))
        inside = re_k - 4
        # the first re_local - 2 slots of every entity's space are valid
        slots = np.argsort(rng.random((n, pidx.shape[1] - 2)), axis=1)[:, :inside]
        cols = np.concatenate([pidx[ent[:, None], slots],
                               rng.integers(0, re_dim, (n, 4))], axis=1)
        shards[shard] = FeatureShard(np.repeat(np.arange(n, dtype=np.int64), re_k),
                                     cols.reshape(-1).astype(np.int64),
                                     rng.standard_normal(n * re_k, dtype=np.float32), re_dim)
    data = GameData(labels=np.zeros(n, np.float32), feature_shards=shards, id_tags=id_tags)
    _unique_entries(data)
    margin = model.score(data).double().cpu().numpy()
    data.labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return data


def _nearline_estimator(device: str):
    """FE + per_userId + per_itemId (the serving model's coordinate ids),
    L-BFGS 10 iterations, L2 lambda 1; each random effect capped at
    NEARLINE["active_cap"] active samples an entity, in 4 size buckets."""
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration as FE,
        GameEstimator,
        RandomEffectCoordinateConfiguration as RE,
    )
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    opt = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(max_iterations=10),
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1.0,
    )

    def re(t):
        return RandomEffectDataConfiguration(t, active_data_upper_bound=NEARLINE["active_cap"],
                                             num_buckets=NEARLINE["re_buckets"])

    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FE("global", opt), "per_userId": RE("per_user", re("userId"), opt),
         "per_itemId": RE("per_item", re("itemId"), opt)},
        update_order=["fixed", "per_userId", "per_itemId"], num_outer_iterations=1,
        device=device)


class timed_resolves:
    """Inside: every ``resolve_coordinate`` of ``estimator`` is timed (the
    card synced at its end) into ``seconds``, (coordinate, s) in order."""

    def __init__(self, estimator, sync):
        self.estimator, self.sync, self.seconds = estimator, sync, []

    def __enter__(self):
        real = self.estimator.resolve_coordinate

        def timed(cid, *args, **kwargs):
            t0 = time.perf_counter()
            out = real(cid, *args, **kwargs)
            self.sync()
            self.seconds.append((cid, time.perf_counter() - t0))
            return out

        self.estimator.resolve_coordinate = timed
        return self

    def __exit__(self, *exc):
        del self.estimator.resolve_coordinate


def _update_rows(update) -> dict:
    """cid -> (sorted entity ids, their coefficient dicts' sorted keys and
    values as arrays)."""
    out = {}
    for cid, rows in update.re_updates.items():
        ids = sorted(rows)
        keys = [np.array(sorted(rows[e]), dtype=np.int64) for e in ids]
        vals = [np.array([rows[e][k] for k in sorted(rows[e])], dtype=np.float64) for e in ids]
        out[cid] = (ids, keys, vals)
    return out


def _logistic_objective(model, data) -> float:
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss

    z = model.score(data).double()
    y = torch.from_numpy(data.labels).to(z.device).double()
    return float(LogisticLoss.value(z, y).sum())


def _same_update(a, b, atol: float) -> dict:
    """Touched and new sets equal; FE vectors and re-solved rows within
    ``atol`` (atol 0: bitwise). Returns the largest differences."""
    if a.touched_entities != b.touched_entities or a.new_entities != b.new_entities:
        raise AssertionError("updates touched different entities")
    if sorted(a.fe_updates) != sorted(b.fe_updates):
        raise AssertionError("updates refreshed different fixed effects")
    out = {}
    for cid in a.fe_updates:
        d = np.abs(a.fe_updates[cid].astype(np.float64) - b.fe_updates[cid])
        out[cid] = float(d.max())
    ra, rb = _update_rows(a), _update_rows(b)
    for cid in ra:
        ids, keys, vals = ra[cid]
        ids_b, keys_b, vals_b = rb[cid]
        if ids != ids_b or not all(np.array_equal(x, y) for x, y in zip(keys, keys_b)):
            raise AssertionError(f"{cid}: re-solved rows differ in their entities or features")
        out[cid] = float(max((np.abs(x - y).max() for x, y in zip(vals, vals_b) if x.size),
                             default=0.0))
    bad = {k: v for k, v in out.items() if not v <= atol}
    if bad:
        raise AssertionError(f"updates differ beyond atol {atol}: {bad}")
    return out


def _score_all(scorer, requests, bucket: int = 32) -> list:
    out = []
    for i in range(0, len(requests), bucket):
        out.extend(scorer.score_batch(requests[i:i + bucket], bucket_size=bucket))
    return out


def _scores_of(results) -> list:
    return [r.score for r in results]


def _table_snapshot(scorer) -> dict:
    """Every device table of a sharded scorer (FE vectors, both halves of
    each RE table), copied on the device."""
    out = {cid: w.clone() for cid, w in scorer._fe_params.items()}
    for cid, p in scorer._providers.items():
        for i, t in enumerate(p._tables):
            out[f"{cid}/{i}"] = t.clone()
    return out


def _same_tables(scorer, snap: dict) -> bool:
    now = _table_snapshot(scorer)
    return sorted(now) == sorted(snap) and all(
        now[k].shape == snap[k].shape and torch.equal(now[k].view(torch.int32),
                                                      snap[k].view(torch.int32))
        for k in snap)


def _compact_job(job) -> dict:
    """Step (d), in a process of its own: ``compact`` of the chain over the
    base artifact, against the base with the chain applied in memory, table
    for table and bitwise, entity indexes equal."""
    (base_dir, delta_dirs, out_dir), _ = job
    from photon_ml_tpu_torch.incremental import apply_delta, compact, fingerprint_dir, load_delta
    from photon_ml_tpu_torch.serving import load_artifact

    t0 = time.perf_counter()
    fp = compact(base_dir, delta_dirs, out_dir)
    compact_s = time.perf_counter() - t0
    folded = load_artifact(base_dir, mmap=False)
    for d in delta_dirs:
        folded = apply_delta(folded, load_delta(d))
    back = load_artifact(out_dir)
    same = {}
    for cid, table in folded.tables.items():
        got = back.tables[cid]
        ok = np.array_equal(np.asarray(got.weights).view(np.uint32),
                            np.asarray(table.weights).view(np.uint32))
        if table.is_random_effect:
            names = [table.entity_index.get_feature_name(i) for i in range(len(table.entity_index))]
            ok = ok and np.array_equal(got.entity_index.get_indices(names),
                                       table.entity_index.get_indices(names))
        same[cid] = bool(ok)
    return {"compact_s": compact_s, "fingerprint": fp,
            "fingerprint_matches": fp == fingerprint_dir(out_dir), "bitwise": same,
            "check_s": time.perf_counter() - t0 - compact_s}


class _LatencyLog:
    """A tenant's SLO tracker that also keeps every latency it observes,
    for the tenant's p50 / p99."""

    def __init__(self, slo):
        self.slo, self.latencies = slo, []

    def observe_many(self, latencies, **kwargs) -> None:
        self.latencies.extend(latencies)
        self.slo.observe_many(latencies, **kwargs)

    def __getattr__(self, name):
        return getattr(self.slo, name)

    def percentiles(self) -> dict:
        if not self.latencies:
            return {"latency_p50_s": None, "latency_p99_s": None}
        p50, p99 = np.percentile(self.latencies, [50, 99])
        return {"latency_p50_s": float(p50), "latency_p99_s": float(p99)}


def _timed_call(fn, log: list):
    """``fn``, appending the (start, end) of each call to ``log`` on the
    host's clock."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append((t0, time.perf_counter()))
    return call


def _batch_seconds(spans: list) -> dict:
    """Count, p50, p99 and max of the seconds of (start, end) spans."""
    if not spans:
        return {"batches": 0, "p50_s": None, "p99_s": None, "max_s": None}
    s = np.array([b - a for a, b in spans])
    p50, p99 = np.percentile(s, [50, 99])
    return {"batches": len(s), "p50_s": float(p50), "p99_s": float(p99), "max_s": float(s.max())}


def _combination_close(got: np.ndarray, old: dict, new: dict, offsets: np.ndarray,
                       abs_sum: np.ndarray) -> np.ndarray:
    """Per row, whether ``got`` is within the serving tolerance of a sum of
    each coordinate's term from the old or the new model (a batch routed
    while a swap's hooks run one after another reads each coordinate whole,
    old or new)."""
    import itertools

    cids = sorted(old)
    ok = np.zeros(got.shape, dtype=bool)
    for pick in itertools.product((0, 1), repeat=len(cids)):
        cand = offsets + sum((new if p else old)[c] for c, p in zip(cids, pick))
        ok |= np.abs(got - cand) <= 2e-4 * np.abs(cand) + 1e-5 * np.maximum(1.0, abs_sum)
    return ok


def phase_nearline_full_width(seed: int) -> dict:
    """The nearline loop on serve_full_width's model (see the module doc)."""
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.incremental import (
        DeltaArtifact, apply_delta, build_delta, delta_dir_name, fingerprint_dir,
        incremental_update, rebase_delta, save_delta)
    from photon_ml_tpu_torch.ops import launches
    from photon_ml_tpu_torch.serving import (
        DEFAULT_TENANTS, ContinuousBatcher, HotSwapManager, RequestPlane, ServingMetrics,
        ShardedGameScorer, TenancyPlane, TenantBudget, TenantQuota, ValidationGate,
        VariantRegistry, VariantRouter, build_scenario, build_tenant_slos, load_artifact,
        make_nearline_fn, max_nnz_of, requests_from_game_data, run_scenario)
    from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry
    from photon_ml_tpu_torch.types import TaskType

    device, sync = "cuda", torch.cuda.synchronize
    prep, serve, cfg = _serve_prep(seed), SERVE, NEARLINE
    t_phase = time.perf_counter()
    info = prep.wait()
    result = {"prep": {k: info.get(k) for k in ("prep_s", "prep_waited_s", "fingerprint")}}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_nearline_")
    compact_prep = None
    try:
        t0 = time.perf_counter()
        _, coords = make_glmix(seed, **serve)
        model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device=device)
        events = make_nearline_events(seed, coords, model, cfg["events"], serve["fe_dim"], device)
        del coords
        artifact = load_artifact(prep.dir)
        fp0 = info.get("fingerprint") or fingerprint_dir(prep.dir)
        result["setup_s"] = time.perf_counter() - t0
        result["events"] = {"rows": events.num_rows,
                            "nnz": {k: int(v.rows.size) for k, v in events.feature_shards.items()}}

        # (a) the update on the card, its launches and seconds a coordinate
        estimator = _nearline_estimator(device)
        launches.reset()
        with timed_resolves(estimator, sync) as timer:
            t0 = time.perf_counter()
            update = incremental_update(estimator, model, events, refresh_fixed_iterations=1)
            sync()
            update_s = time.perf_counter() - t0
        counts = {k: v for k, v in launches.counts().items() if v}
        result["launches_by_kernel"] = counts
        if any(counts.get(k, 0) < 1 for k in KERNELS):
            raise AssertionError(f"the update did not launch every kernel of its path: {counts}")
        merged = update.game_model(estimator)
        objective = _logistic_objective(merged, events)
        launches.reset()
        with plain_versions():
            plain = incremental_update(estimator, model, events, refresh_fixed_iterations=1)
            sync()
        if any(launches.counts()[k] for k in KERNELS):
            raise AssertionError(f"the plain update launched kernels: {launches.counts()}")
        plain_objective = _logistic_objective(plain.game_model(estimator), events)
        obj_rel = abs(objective - plain_objective) / abs(objective)
        if not obj_rel <= 1e-4:
            raise AssertionError(f"update objective {objective} vs plain {plain_objective}")
        diffs = _same_update(update, plain, 2e-3)
        again = incremental_update(estimator, model, events, refresh_fixed_iterations=1)
        sync()
        _same_update(update, again, 0.0)
        del plain, again
        result["update"] = {
            "seconds": update_s, "seconds_per_resolve": timer.seconds,
            "touched": {c: len(v) for c, v in update.touched_entities.items()},
            "new": {c: len(v) for c, v in update.new_entities.items()},
            "objective": objective, "plain_objective": plain_objective,
            "objective_rel_diff_vs_plain": obj_rel, "max_abs_diff_vs_plain": diffs,
            "solver_stats": {c: [dataclasses.asdict(s) for s in v]
                             for c, v in update.solver_stats.items()},
        }
        pool = {c: list(update.touched_entities[c]) for c in update.touched_entities}

        # the deltas: d1 the update, d2 half of d1's rows scaled by 0.5 (a
        # second good link of the chain), chained to the served artifact
        d1 = build_delta(update.re_updates, artifact, fe_updates=update.fe_updates,
                         base_fingerprint=fp0, generation=1, created_at_unix=time.time())
        t0 = time.perf_counter()
        d1 = save_delta(d1, os.path.join(tmp.name, "deltas", delta_dir_name(1)))
        result["publish_s"] = time.perf_counter() - t0
        d2 = DeltaArtifact(
            base_fingerprint=d1.fingerprint, generation=2,
            re_rows={c: (ids[::2], rows[::2] * np.float32(0.5))
                     for c, (ids, rows) in d1.re_rows.items()})
        d2 = save_delta(d2, os.path.join(tmp.name, "deltas", delta_dir_name(2)))
        delta_dirs = [os.path.join(tmp.name, "deltas", delta_dir_name(g)) for g in (1, 2)]
        # (d) runs in the background from here: compact the chain and check it
        compact_prep = SpawnPrep("chip_smoke_compact_", _compact_job,
                                 (prep.dir, delta_dirs, os.path.join(tmp.name, "compacted")),
                                 "unused")

        # the references: GameModel.score of the old and the merged model, per
        # coordinate, on the card
        n_req = cfg["requests"]
        requests = requests_from_game_data(events, artifact, max_requests=n_req)
        old_terms = {c: model.score_coordinate(c, events).double().cpu().numpy()[:n_req]
                     for c in model.models}
        new_terms = {c: merged.score_coordinate(c, events).double().cpu().numpy()[:n_req]
                     for c in merged.models}
        offsets = np.asarray(events.offsets, dtype=np.float64)[:n_req]
        old_ref = sum(old_terms.values()) + offsets
        new_ref = sum(new_terms.values()) + offsets
        folded = apply_delta(artifact, d1)
        abs_old = _serve_terms(events, artifact)[:n_req]
        abs_new = _serve_terms(events, folded)[:n_req]
        del model

        # the live scorer: 4 shards, headroom for new and overlay rows, every
        # bucket warmed
        nnz = max_nnz_of(requests)

        def live_scorer():
            s = ShardedGameScorer(artifact, max_nnz=nnz, num_shards=4, device=device,
                                  headroom_fraction=cfg["headroom"])
            for b in SERVE_BUCKETS:
                s.score_batch(requests[:b], b)
            return s

        t0 = time.perf_counter()
        scorer = live_scorer()
        result["scorer_build_s"] = time.perf_counter() - t0
        compiles = scorer.compile_count
        # (e) scores the first gate_rows requests (each check a full pass)
        e_req = requests[:cfg["gate_rows"]]
        e_n = len(e_req)
        plain_scores = _score_all(scorer, e_req)
        result["plain_max_abs_err"] = _check_served(plain_scores, old_ref[:e_n], abs_old[:e_n],
                                                    "plain")

        # (e) variants over the same scorer: base, v1 diverged by d1, v2 at 10 %
        reg = VariantRegistry(scorer, base_fingerprint=fp0)
        router = VariantRouter(seed=seed)
        for v in ("v1", "v2"):
            reg.add_variant(v)
            router.set_ramp(v, 10.0)
        router.route_many("default", [r.request_id for r in requests])
        rep_v1 = reg.apply_delta("v1", d1)
        v1 = _score_all(reg.scorer("v1"), e_req)
        variants = {
            "shares": router.shares(), "v1_blackout_s": rep_v1.blackout_s,
            "v1_overlay_rows": rep_v1.new_overlay_rows,
            "v1_max_abs_err": _check_served(v1, new_ref[:e_n], abs_new[:e_n], "(e) v1"),
        }
        if any(r.cold_coordinates for r in v1):
            raise AssertionError("(e): v1 served a touched entity cold")
        if _scores_of(_score_all(reg.scorer("base"), e_req)) != _scores_of(plain_scores):
            raise AssertionError("(e): the base variant is not bitwise the plain path")
        if _scores_of(_score_all(reg.scorer("v2"), e_req)) != _scores_of(plain_scores):
            raise AssertionError("(e): the undiverged variant is not bitwise the base")
        reg.apply_delta("v2", rebase_delta(d2, reg.state("v2").fingerprint))
        v2 = _scores_of(_score_all(reg.scorer("v2"), e_req))
        if v2 == _scores_of(plain_scores):
            raise AssertionError("(e): v2's delta changed no score")
        reg.rollback("v1")
        if _scores_of(_score_all(reg.scorer("v2"), e_req)) != v2:
            raise AssertionError("(e): rolling back v1 moved v2")
        if _scores_of(_score_all(reg.scorer("v1"), e_req)) != _scores_of(plain_scores):
            raise AssertionError("(e): v1 rolled back is not bitwise the base")
        if _scores_of(_score_all(scorer, e_req)) != _scores_of(plain_scores):
            raise AssertionError("(e): the variants moved the plain path")
        reg.rollback("v2")
        reg.apply_delta("v1", d1)  # diverged again, for the score times
        b32 = requests[:32]
        ms = cuda_ms({"plain": lambda: scorer.score_batch(b32, 32),
                      "v1": lambda: reg.scorer("v1").score_batch(b32, 32),
                      "v2": lambda: reg.scorer("v2").score_batch(b32, 32)},
                     reps=20, rounds=4, batch=32)
        variants["score_batch_32"] = {k: {"ms": ms[k], "device_ms": ms[f"{k}_device"]}
                                      for k in ("plain", "v1", "v2")}
        reg.rollback("v1")
        variants["compile_count"] = scorer.compile_count
        if scorer.compile_count != compiles:
            raise AssertionError(f"(e): compile count {compiles} -> {scorer.compile_count}")
        result["variants"] = variants

        # (b), (c) and (f) on a second live scorer of the same artifact: a
        # registry's overlay rows lie past the base row range, where a base
        # swap appends its new entities (the reference's layout; its CLI
        # refuses --variants with --watch-deltas), so a base swap never
        # follows a registry on one scorer
        del reg, router, scorer
        torch.cuda.empty_cache()
        scorer = live_scorer()
        compiles = scorer.compile_count

        # (b) d1 swapped into the live scorer in the middle of a continuous
        # replay: a feeder thread keeps batches in flight (requests
        # [half, flight) over and over) until the swap returns; every batch
        # and every swap hook is timed on the host's clock
        manager = HotSwapManager(scorer, fingerprint=fp0, metrics=ServingMetrics())
        half = n_req // 2
        flight = half + min(4096, n_req // 4)
        batches, hooks = [], []
        timed = ("score_batch", "set_artifact", "update_fixed_effect",
                 "update_random_effect_rows", "rebind_random_effect")
        for name in timed:
            setattr(scorer, name, _timed_call(getattr(scorer, name),
                                              batches if name == "score_batch" else hooks))
        batcher = ContinuousBatcher([scorer], bucket_sizes=SERVE_BUCKETS,
                                    max_wait_s=0.002).start()
        try:
            h1 = []
            for i in range(0, half, 32):
                h1.extend(batcher.submit_many(requests[i:i + 32]))
            batcher.flush()
            before = [h.result(timeout=120) for h in h1]
            n_before = len(batches)
            fed, swapped = [], threading.Event()

            def feed():
                while not swapped.is_set():
                    for i in range(half, flight, 32):
                        fed.append((i, batcher.submit_many(requests[i:i + 32])))
                        if swapped.is_set():
                            break

            feeder = threading.Thread(target=feed, name="chip-smoke-feeder")
            feeder.start()
            try:
                time.sleep(0.05)  # batches flowing before the swap begins
                t0 = time.perf_counter()
                report = manager.apply_delta(delta_dirs[0])
                t1 = time.perf_counter()
            finally:
                swapped.set()
                feeder.join()
            batcher.flush()
            during_idx = np.concatenate([np.arange(i, i + len(hs)) for i, hs in fed])
            during = [h.result(timeout=120) for _, hs in fed for h in hs]
            n_during = len(batches)
            h3 = []
            for i in range(flight, n_req, 32):
                h3.extend(batcher.submit_many(requests[i:i + 32]))
            batcher.flush()
            after = [h.result(timeout=120) for h in h3]
        finally:
            batcher.stop()
            for name in timed:
                delattr(scorer, name)
        swap_s = t1 - t0
        in_flight_ok = _combination_close(
            np.array(_scores_of(during)), {c: v[during_idx] for c, v in old_terms.items()},
            {c: v[during_idx] for c, v in new_terms.items()}, offsets[during_idx],
            np.maximum(abs_old, abs_new)[during_idx])
        if not in_flight_ok.all():
            bad = during_idx[~in_flight_ok]
            new_ids = sum(any(str(e).startswith("new_") for e in requests[i].entity_ids.values())
                          for i in bad)
            raise AssertionError(f"(b): {bad.size} scores in flight during the swap ({new_ids} "
                                 "of them with a new entity) match no mix of old and new "
                                 "coordinates")
        # what the request path saw: each batch's score_batch seconds, for the
        # batches before the swap, those that overlapped its hooks (the
        # critical section, cs0 to cs1), the rest of its wall and after it
        cs0, cs1 = min(a for a, _ in hooks), max(b for _, b in hooks)
        windows = {"before": batches[:n_before], "critical_section": [], "rest_of_swap": [],
                   "after": batches[n_during:]}
        for a, b in batches[n_before:n_during]:
            if a < cs1 and b > cs0:
                windows["critical_section"].append((a, b))
            elif a < t1 and b > t0:
                windows["rest_of_swap"].append((a, b))
        stall = {k: _batch_seconds(v) for k, v in windows.items()}
        swap = {
            "before_max_abs_err": _check_served(before, old_ref[:half], abs_old[:half],
                                                "(b) before"),
            "after_max_abs_err": _check_served(after, new_ref[flight:], abs_new[flight:],
                                               "(b) after"),
            "in_flight": len(during), "blackout_s": report.blackout_s, "swap_s": swap_s,
            "critical_section_s": cs1 - cs0, "batch_seconds": stall,
            "rows_updated": report.rows_updated, "regrew": list(report.regrew),
            "compiles_added": report.compiles_added, "generation": report.generation,
        }
        if report.rolled_back or report.compiles_added or scorer.compile_count != compiles:
            raise AssertionError(f"(b): {report}, compile count {scorer.compile_count}")
        result["swap"] = swap

        # (c) a bad delta: the touched rows negated and scaled by 8; the AUC
        # gate on gate_rows labelled rows rejects it, the rollback is bitwise
        gate_n = cfg["gate_rows"]
        manager.gate = ValidationGate(requests[:gate_n], events.labels[:gate_n],
                                      max_auc_regression=0.01, bucket_size=32)
        bad = DeltaArtifact(base_fingerprint=manager.fingerprint, generation=2,
                            re_rows={c: (ids, rows * np.float32(-8.0))
                                     for c, (ids, rows) in d1.re_rows.items()})
        snap = _table_snapshot(scorer)
        t0 = time.perf_counter()
        bad_report = manager.apply_delta(bad)
        gated_s = time.perf_counter() - t0
        if not bad_report.rolled_back or not _same_tables(scorer, snap):
            raise AssertionError(f"(c): the bad delta was not rolled back bitwise: {bad_report}")
        del snap
        result["gate"] = {"baseline_auc": bad_report.baseline_metric,
                          "candidate_auc": bad_report.validation_metric,
                          "rolled_back": True, "seconds": gated_s,
                          "generation": manager.generation}

        # (f) the tenancy scenarios over the same scorer
        scenarios = {}
        for name in ("tenant_isolation", "ramped_rollout", "nearline_loop"):
            registry = VariantRegistry(scorer, base_fingerprint=manager.fingerprint)
            registry.add_variant("candidate")
            if name == "ramped_rollout":
                registry.apply_delta("candidate",
                                     rebase_delta(d2, registry.state("candidate").fingerprint))
            mreg = MetricsRegistry()
            slos = {t: _LatencyLog(slo) for t, slo in build_tenant_slos(
                DEFAULT_TENANTS, registry=mreg, latency_threshold_s=0.05).items()}
            plane = RequestPlane(sample_rate=16, seed=seed, tenant_slos=slos)
            metrics = ServingMetrics()
            quota = None
            if name == "tenant_isolation":
                share = n_req // len(DEFAULT_TENANTS)
                quota = TenantQuota({t: TenantBudget(rate=1.0, burst=share + 512)
                                     for t in DEFAULT_TENANTS})
            tenancy = TenancyPlane(registry, router=VariantRouter(seed=seed), plane=plane,
                                   quota=quota, metrics=metrics, metrics_registry=mreg,
                                   bucket_sizes=SERVE_BUCKETS)
            nearline = None
            if name == "nearline_loop":
                tenancy.router.set_ramp("candidate", 50.0)
                watch = os.path.join(tmp.name, "variant_deltas")
                nearline = make_nearline_fn(registry, ["candidate"], pool, rows_per_delta=8,
                                            seed=seed, watch_dir=watch)
            scenario = build_scenario(name, requests, seed=seed,
                                      num_phases=cfg["scenario_phases"], pause_s=0.0)
            t0 = time.perf_counter()
            doc = run_scenario(scenario, [scorer], SERVE_BUCKETS, metrics, plane=plane,
                               tenancy=tenancy, nearline_fn=nearline)
            wall = time.perf_counter() - t0
            shed = sum((doc.get("tenant_shed") or {}).values())
            if doc["num_requests"] != scenario.num_requests - shed:
                raise AssertionError(f"({name}): served {doc['num_requests']} of "
                                     f"{scenario.num_requests}, {shed} shed")
            if name == "tenant_isolation" and not (doc.get("flood_shed_ok")
                                                   and doc["tenant_shed"].get("alpha", 0) > 0):
                raise AssertionError(f"(tenant_isolation): the flood was not shed on its "
                                     f"tenant alone: {doc.get('tenant_shed')}")
            if name == "nearline_loop" and not doc.get("nearline", {}).get("deltas_applied"):
                raise AssertionError(f"(nearline_loop): no delta applied: {doc.get('nearline')}")
            scenarios[name] = {
                "seconds": wall, "num_requests": doc["num_requests"],
                "requests_per_s": doc["requests_per_s"],
                "latency_p50_s": doc.get("latency_p50_s"), "latency_p99_s": doc.get("latency_p99_s"),
                "tenants": {t: {"requests": d["requests"], "errors": d["errors"],
                                "slo_verdict": d["slo_verdict"], **slos[t].percentiles()}
                            for t, d in doc["tenants"].items()},
                "tenant_shed": doc.get("tenant_shed"), "isolation_ok": doc.get("isolation_ok"),
                "variant_shares": doc.get("variant_shares"), "nearline": doc.get("nearline"),
            }
        result["scenarios"] = scenarios
        if scorer.compile_count != compiles:
            raise AssertionError(f"compile count {compiles} -> {scorer.compile_count}")

        # (d) the compacted chain, checked in the background
        compacted = compact_prep.wait()
        if not (all(compacted["bitwise"].values()) and compacted["fingerprint_matches"]):
            raise AssertionError(f"(d): compact differs from the chain applied: {compacted}")
        result["compact"] = compacted
        result["regrowths"] = swap["regrew"]
        result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result["card"] = nvidia_smi()
        result["seconds"] = time.perf_counter() - t_phase
    finally:
        if compact_prep is not None:
            compact_prep.close()
        tmp.cleanup()
    emit("nearline_full_width", **result)
    return result


PHASES = {
    "env": lambda seed: phase_env(),
    "build": lambda seed: phase_build(),
    "kernel": phase_kernel,
    "score_full_width": phase_score_full_width,
    "score_game_cli": phase_score_game_cli,
    "serve_full_width": phase_serve_full_width,
    "nearline_full_width": phase_nearline_full_width,
    "serve_game_cli": phase_serve_game_cli,
    "read_score_full_width": phase_read_score_full_width,
    "train_full_width": phase_train_full_width,
    "train_streaming_full_width": phase_train_streaming_full_width,
    "train_cluster_full_width": phase_train_cluster_full_width,
    "train_grid_full_width": phase_train_grid_full_width,
    "train_glm_full_width": phase_train_glm_full_width,
    "train_glm_diagnostics_full_width": phase_train_glm_diagnostics_full_width,
    "train_tron_full_width": phase_train_tron_full_width,
    "fe_bf16_full_width": phase_fe_bf16_full_width,
    "train_benes_full_width": phase_train_benes_full_width,
    "train_full_game_full_width": phase_train_full_game_full_width,
    "train_async_full_width": phase_train_async_full_width,
    "train_sweep_tuning_full_width": phase_train_sweep_tuning_full_width,
    "train_telemetry_full_width": phase_train_telemetry_full_width,
    "train_game_cli": phase_train_game_cli,
    "train_glm_cli": phase_train_glm_cli,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default=",".join(ALL_PHASES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check",
              file=sys.stderr)
        return 1
    import photon_ml_tpu_torch  # noqa: F401  (fails outside a checkout)

    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if {"train_streaming_full_width", "train_cluster_full_width"} & set(phases):
        BACKGROUND_PREP.add("stream")  # started by train_full_width's rows
    if "train_cluster_full_width" in phases:
        BACKGROUND_PREP.add("cluster")  # started by train_streaming_full_width
    results, phase_seconds = {}, {}
    try:
        for name in ALL_PHASES:
            if name in phases:
                t0 = time.perf_counter()
                results[name] = PHASES[name](args.seed)
                phase_seconds[name] = time.perf_counter() - t0
            if name == "build" and "score_game_cli" in phases:
                _cli_fixture_prep(args.seed)  # its files, made in the background
            if name == "build" and {"serve_full_width", "nearline_full_width"} & set(phases):
                _serve_prep(args.seed)  # its artifact, made in the background
            if name == "build" and "train_benes_full_width" in phases:
                _benes_prep(args.seed)  # its routing, cold, in the background
            if name == "build" and "read_score_full_width" in phases:
                # its Avro files and stores, made while the phases before it run
                _read_score_prep(args.seed)
            if name == "score_full_width" and "stream" in BACKGROUND_PREP:
                _stream_prep(args.seed)  # the same for the streaming phases
            if name == "train_grid_full_width":
                # the in-memory fit and the part files the four phases share
                _stream_fixture_clear()
                _in_memory_glmix_fit.cache_clear()
            if name == "train_telemetry_full_width":
                _async_setup.cache_clear()  # the coordinates the three phases share
            torch.cuda.empty_cache()
    finally:
        # the cluster workers started in the background end, whatever failed
        for launch in _PLANE_LAUNCHES:
            launch.close()
        for prep in _SPAWN_PREPS.values():
            prep.close()
    print(json.dumps({"phase_seconds": phase_seconds}), flush=True)

    # launches and times from the phase that runs each kernel: the training
    # path runs the first three, the Benes training path the shuffles, the
    # bf16 fixed-effect solve the bf16 kernels; the blocked value+gradient
    # kernel is on no path (its launches there: 0), timed by the kernel phase
    train = {**results.get("train_full_width", {}).get("kernels", {}),
             **results.get("train_benes_full_width", {}).get("kernels", {}),
             **results.get("fe_bf16_full_width", {}).get("kernels", {})}
    blocked = results.get("kernel", {}).get("blocked_times")
    if blocked is not None:
        fit_launches = results.get("train_full_width", {}).get("launches", {})
        train[BLOCKED] = {**blocked, "launches": fit_launches.get(BLOCKED)}
    errors = results.get("kernel", {}).get("max_abs_err", {})
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE[name],
        "replaces": KERNEL_REPLACES[name],
        "launches": train.get(name, {}).get("launches"),
        "max_abs_err": errors.get(name),
        "ms": train.get(name, {}).get("ms"),
        "device_ms": train.get(name, {}).get("device_ms"),
        "plain_ms": train.get(name, {}).get("plain_ms"),
        "plain_device_ms": train.get(name, {}).get("plain_device_ms"),
        "bound_ms": train.get(name, {}).get("bound_ms"),
        "bound_by": train.get(name, {}).get("bound_by"),
        "library_ms": train.get(name, {}).get("library_ms"),
        "library_device_ms": train.get(name, {}).get("library_device_ms"),
        "flushed_ms": train.get(name, {}).get("flushed_ms"),
        # each later path's own count, set to 0 just before it ran; the
        # serving phase only where its reference scoring launched the kernel
        # (its serving replays launch none of the table's kernels)
        "launches_by_path": {
            **{path: results[path]["launches_by_kernel"].get(name)
               for path in ("train_cluster_full_width", "train_grid_full_width")
               if path in results},
            # train_glm's diagnose stage (both parts of its phase)
            **{"train_glm_diagnostics_full_width": n for n in [results.get(
                "train_glm_diagnostics_full_width", {}).get("launches_by_kernel", {}).get(
                    name, 0)] if n},
            **{"serve_full_width": n for n in [results.get("serve_full_width", {}).get(
                "reference_launches", {}).get(name, 0)] if n},
            # the nearline update's own count (incremental_update alone)
            **{"nearline_full_width": n for n in [results.get("nearline_full_width", {}).get(
                "launches_by_kernel", {}).get(name, 0)] if n}},
    } for name in KERNELS + SHUFFLES + BF16_KERNELS + (BLOCKED,)]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
