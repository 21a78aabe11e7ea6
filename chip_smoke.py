#!/usr/bin/env python3
"""Drive the PyTorch port of GSL-LPA on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases main,wide_fit,skew_fit,timing
        # only those phases, and no result line (a phase needs the phases
        # whose graphs it reuses: dense needs wide_fit, microbatch batch,
        # stream main).  The script imports the
        # package beside it, so a copy of it in the root of another
        # checkout (a parent commit unpacked with git archive) measures
        # that checkout with the same phases, for a comparison.

Phases, one JSON line each:

  device   nvidia-smi name and power limit; torch, CUDA and Python versions.
  build    nvcc build of the CUDA kernels (seconds, registers, spills).
  kernels  each kernel against its plain PyTorch version on random inputs:
           widths D in {1, ..., 9, 16, 32, 33, 64, 128, 512, 1024} (every
           narrow instance, the first wide width, an unaligned wide row),
           hash seeds {0, 1, 12345, -1}, edgeless rows and rows whose own
           label is absent.  Integer weights must agree exactly; real
           weights must satisfy the brute-force argmax property at rtol
           1e-5; fused and unfused kernels must agree bit for bit,
           all-inactive and all-klass-false rows included; fused_split
           with prune on and off, chg random and all ones.
  parity   tile backend (kernels) against segment backend on small graphs,
           every split mode, shortcut, fusion on and off.
  c1       a real-weight segment fit on the card (planted_partition, 20,000
           vertices, uniform(0.1, 5.0) weights) equals the CPU fit and
           repeats exactly; segment_sum's run sums equal the CPU's bits.
  main     Engine.fit of grid2d(3500) (12.25M vertices, 49M directed edges):
           tile fused, tile unfused and segment give identical labels and
           no internally-disconnected community; each fit's wall time (call
           to result) beside its stage timings.  Launch counts are reset
           just before these fits and read just after.
  wide_fit the same three fits of erdos_renyi(1<<21, 16.0) (2.1M vertices,
           D=64 tiles): identical labels, no disconnected community.
  dense    core.dense on the ER graph's tiles (B1 / B2 called directly):
           lpa_run_dense and split_lp_dense equal the segment lpa_run /
           split_lp, labels and iterations; gsl_lpa / gve_lpa on karate
           club on the card equal their CPU runs.
  skew_fit two segment fits of rmat(19, 16) (hubs of degree ~10^4, long
           per-(vertex, label) runs): equal labels, their timings.
  batch    Engine.fit_many.  Traffic A: 32 members grid2d(side), side =
           400, 410, ..., 710 (10,129,600 vertices, 40,447,360 directed
           edges; bucket 16,777,216 x D=4), tile fused and unfused, launch
           counts reset just before and read just after each; every member
           equals its solo fused tile fit (labels, both iteration counts,
           communities) with no disconnected community; wall times beside
           the 32 solo fits'; then B1-B4 timed on the packed tiles.
           Traffic B: 15 planted_partition(32, 512, 0.04, 0.0005, seed=s)
           plus an edgeless 100-vertex and a one-vertex member (D=64), auto
           (must pick tile), tile unfused and segment, split lp and lpp with
           shortcut, all equal to each member's solo fit.
  obs      repro_torch.obs (needs main, batch).  grid2d(3500) fitted
           with profile="full", tile fused and unfused (launch counts reset
           just before, read just after): labels and both iteration counts
           equal main's, the propagation curves equal each other, the
           split's changed columns too, 2 x lpa_iterations propagation
           rows; the walls of the profiled and the unprofiled fused fit,
           plans warm, median of 3 in turns, and the overhead share.
           Traffic B's first member on the card (tile fused, unfused,
           segment) and on the CPU (segment): equal propagation curves.
           Traffic A through fit_many, profiled: members 0, 15 and 31 have
           their solo fits' curves.  quality="full" and "basic" fits of
           grid2d(3500): labels equal main's, disconnected fraction 0.0,
           modularity equal to the compute_metrics fit's, the
           engine.quality span of each.  A fit's engine.fit span beside
           its host wall; the Chrome trace (build/obs_trace.json) loads;
           the Prometheus text parses; the engine scope's fits counters
           equal the fits made.
  microbatch  a MicroBatcher(max_batch=8) on the card takes 24 of traffic
           B's members from 4 threads; each result equals its solo fit.
  stream   warm starts and streaming.  (a) The main graph, kept on the
           host, under 3 rounds of road edits (1,000 random existing edges
           deleted and 1,000 diagonals (i, j)-(i+1, j+1) inserted per
           round, seed 0) through StreamSession.update on the tile fused
           backend, warm with the delta's frontier: each round equals the
           solo warm Engine.fit on the card (labels, both iteration counts,
           communities) with no disconnected community, and is printed with
           its splice, upload, propagation, split, compact and wall seconds,
           its B3 / B4 launches (reset just before, read just after) and
           the frontier's share, beside a cold fit of the same graph; in
           round 1 the patched graph equals apply_delta's rebuild (every
           array byte for byte, the fingerprint), and B3 is timed on the
           warm fit's first sub-sweep (the frontier active) and B4 on its
           split's first sweep.  (b) 8 planted_partition(32, 512, 0.04,
           0.0005, seed=s) streams, 3 rounds of evolving_sequence(...,
           delta_edges=256, seed=100 + s) through one
           StreamSession(max_batch=8).update_many, warm and as a cold
           replay: each member equals its solo fit.  (c) warm_start="auto":
           a second fit is warm and equals the fit from the first's labels;
           the cache stays at its bound over warm_cache_size + 1 graphs.
  ingest   grid2d(1400) written as MatrixMarket (3,914,400 edges);
           python -m repro_torch.launch.ingest <file> --stats --detect in a
           subprocess (exit 0, detection on the card); load_graph twice
           (parse, then a store hit that shares the entry's pages), both
           equal to grid2d(1400) with its fingerprint; Engine().fit(path)
           equals Engine().fit(grid2d(1400)), and a second fit(path) under
           warm_start="auto" is warm through the stored fingerprint.
  ooc      out-of-core fits (needs main, ingest).  grid2d(3500) under a
           budget of 3/4 of its in-core edge bytes (13 B per slot):
           Engine.fit(g, memory_budget=B), tile fused and unfused (launch
           counts reset just before, read just after each), 4 to 16
           partitions, labels and both iteration counts equal to main's,
           no disconnected community, the ledger's peak within B, B3 / B4
           (fused) or B1 / B2 (unfused) launched once per partition visit;
           the fused fit again with prefetch off and profile="full": the
           prefetched fit's labels and an in-core profiled fit's
           propagation curve; a real-weight segment fit
           (weighted_planted_partition(40, 500, 0.05, 0.001, seed=3))
           out of core against in core; the ingest phase's file through
           python -m repro_torch.launch.ingest --ooc (subprocess) and
           Engine().fit(path, memory_budget=...) reading windows only, both
           equal to the in-core fit(path).  Each fit's line: partitions,
           budget, peak, loads, prefetch and halo-cache hits, bytes saved,
           exchange bytes, plan / propagation / split / compact seconds,
           the wait on window loads, wall beside the in-core
           wall (main's cold fits; the road fits also beside a warm one).
  serve    the multi-tenant serving tier (repro_torch.serve): 16 tenants,
           tenant i evolving_sequence(100000, 5.0, ..., delta_edges=100,
           seed=7 + 17 * i) (1.6M vertices, ~8M directed edges; traces
           made once, in worker processes), each a register and 3 rounds
           (every third a cold refresh, but for the 4 parity tenants) from
           8 client threads through TenantService(queue_capacity=16,
           max_batch=8) on Engine(backend="tile", quality="full"), B3 / B4
           on every batch.  (a) Warm budget 16,000,000 B: 64 requests, none
           stranded or failed, no spill, the parity tenants equal
           replay_parity, every tenant's last health sample has
           disconnected fraction 0.0, B3 and B4 launched (counts reset just
           before, read just after); then the four LPA kernels on one
           served batch's packed tiles (8 tenants after (a), their labels),
           exact against their plain versions, timed, with their bounds.
           (b) 4,800,000 B: spills, the peak within the budget, the same
           gates.  (a) again under torch.profiler (device activity only):
           the device's busy and idle share of the load.  (c) (a)'s
           snapshot through CheckpointManager restored into a new service
           on a fresh engine (16 restored, labels equal), round 4 on the
           parity tenants equal to a solo replay of all 4.  The checkpoint
           directory is removed whatever fails.  (d) serve_communities and
           serve_streaming at their defaults, then python -m
           repro_torch.launch.serve --mode tenants --metrics-jsonl (a
           subprocess).  Wall, p50 / p99, edges/s, warm peak, spills, the
           batch histogram and the launches of each run.
  sharded  multi-device detection (needs main): the sharded backend over
           torch.distributed, its ranks in spawned processes (the parent
           never joins a group) that read main's graph from .npy files.
           (a) One NCCL rank, a one-rank CUDA DeviceMesh: Engine.fit of
           grid2d(3500) with exchange_every=1 equals main's fits (labels,
           both iteration counts), B1 launched 2 x lpa_iterations times
           and B2 split_iterations times (counts reset just before, read
           just after), no fused launch; again warm, and once under
           torch.profiler (device busy, top ops); exchange_every=2 has no
           disconnected community; one exchange (the all-gather of the
           16.8M-label replica) timed; B1 and B2 on the rank's tiles exact
           against their plain versions, timed beside their bounds.
           (b) Two gloo ranks, both on cuda:0 (no mesh: the default
           group): grid2d(3500) at exchange_every=1 equals main's labels
           on both ranks, with the same launch rule; the exchange timed;
           B1 and B2 on rank 1's rotated half tiles (8.4M rows) checked
           and timed; then planted_partition(32, 512, 0.04, 0.0005,
           seed=1) (D=64) at exchange_every=2 equals the same run on two
           CPU gloo ranks.  (c) The walls, propagation and split seconds
           of (a) and (b) beside main's unfused tile fit.
  timing   the four LPA kernels (CUDA events) beside their plain versions
           and bounds, at the main fit's D=4 tiles, the ER graph's D=64
           tiles and planted_partition(128, 1024, 0.3, 0.001)'s D=512
           tiles, with its planted labels and with labels = vertex ids (a
           fit's first sweep).  Each must equal its plain version exactly
           on the graphs' unit weights; label_argmax and fused_move, on
           real weights from a seed, the bits of the slot-order sum
           (ref.label_argmax_slot_order).  min_label and fused_split run
           as a split's first sweep (labels = row ids, comm = the case's
           labels), fused_split with prune off and on.  No kernel may beat
           its bytes bound.
  trace    torch.profiler over one fused fit: top device ops, idle share.
  flash    ops.flash_attention against its plain version (the chunked
           oracle) on the reference's test shapes, ragged, cross and
           Sq > Skv cases, the TMA ring's edges (B=2 with ragged Skv,
           several partial KV tiles, hd=64, one query), bf16 and float32;
           then the main path of this kernel: one causal call at Yi-9B's
           attention width (B=1, S=4096, 32 query heads, 4 KV heads,
           hd=128, bf16) with launch counts reset just before and read
           just after, checked against the plain version and timed beside
           it and beside scaled_dot_product_attention (yardstick only);
           and two more timed calls at that width, S=4096 non-causal and
           S=16384 causal, beside SDPA.
  decode   B5's decode body (csrc/flash_attention_decode.cu: every bf16
           call with one query row) at each decode call the models make
           (DECODE_CALLS: Yi-9B, qwen2-moe, jamba, seamless and its cross
           decode, internvl2, arctic, starcoder2-15b's window, the int8
           cache of serve_sharded (a), the sequence-parallel ranks of (c)
           with lse, (hd)'s call), on random bf16 inputs from a seed with
           junk past kv_len: against ref.flash_decode_ref (the same
           split, float32) and ref.flash_attention_ref within 8e-3, lse
           within 1e-3, two launches bit-equal, ops.count_kv_rows equal to
           B x K x the visible rows rounded to the body's 64-key tiles;
           timed (CUDA events over back-to-back calls; the same over
           calls replayed from a CUDA graph, the device's time a call
           when the host does not limit it; the host's time to
           return from a call through ops and from the C entry point
           alone, and from the prefill body's entry) beside its bound, the plain version, SDPA over the
           visible keys copied out and the prefill body
           (flash_attention.cu's entry point called directly, as before
           this body) on the same inputs, each timed both ways.
  lm       LM serving of Yi-9B (src/repro_torch/configs/yi_9b.py: 48 layers,
           d_model 4096, 32 heads, 4 KV heads, hd 128, vocab 64000), random
           weights from seed 0.  (b) The model cut to 2 layers, one weight
           set made on the CPU: the card's prefill (2 x 64 tokens) and 8
           decode steps against the CPU's plain path, logits within 0.02
           relative.  Then the full model on the card: (a) layer 0's q / k
           / v of a prompt through B5, the prefill call (B=4, S=512,
           causal) and decode calls over a 1024-row cache with junk past
           the visible keys (kv_len 513 at B=4, 300 at B=2, float32 too),
           each against its plain version (8e-3; 1e-5 in float32) and the
           copied-out keys alone, the prefill and decode calls timed beside
           their bounds and SDPA; (c) serve("yi-9b", reduced=False,
           batch=4, prompt_len=512, max_new=32, s_max=1024) with launch
           counts reset just before and read just after (48 x 32 B5
           launches): prefill and decode seconds, tok/s, peak device
           memory; 4 decode steps under torch.profiler (device busy and
           idle share, top ops); then the served tokens fed back:
           forward_train over prompt + generated against the prefill's and
           each decode step's logits, every logit finite, B5 launched 48
           times per forward, prefill and decode step, in float32 (the
           weights upcast; within 1e-3) and in bf16 (within 0.02, or 1.5x
           the bf16 forward's own distance from the float32 forward if
           larger: bf16 rounding noise grows with depth).
  lm_families  LM serving of the other families, one arch each at full
           width with random bf16 weights from seed 0, freed before the
           next, each cut to 2 decoder layers: qwen2-moe-a2.7b (of 24,
           MoE 60 of 64 experts top-4 + shared expert), jamba-v0.1-52b
           (8: one group of its 32 layers: Mamba, attention at offset 4,
           MoE on odd offsets), rwkv6-7b (of 32), seamless-m4t-large-v2 (of 24,
           + 24 encoder layers, hd 64, 32 frames), internvl2-26b (of 48, a
           1,024-row vision prefix, 48 / 8 heads) and arctic-480b cut to
           one of its 35 layers (128 experts top-2 + dense residual).
           Per arch: (b) card against the CPU's plain path, logits within 0.02
           (full width at 2 layers, the VLM's prefix cut to 64 rows; jamba and
           arctic at reduced_config); (a) serve(arch, reduced=False,
           batch=4, prompt_len=512, max_new=32, s_max=1024 + prefix) with
           launch counts reset just before and read just after (B5
           launched once per attention, encoder and cross-attention layer
           and call): prefill and decode seconds, tok/s, peak memory, the
           weight-read bound; a synchronised prefill and 2 decode steps
           with the Mamba mixer and scan, the RWKV time mix and the MoE
           layer (expert products apart) timed; (c) the served tokens fed
           back through forward_train, prefill and each decode step, MoE
           at capacity factor E / k (no drop), in bf16 and in float32
           (models.common.float32_replay: the same weights, float32
           activations, full depth), with launches per call checked; B5
           on the prefill's and first decode step's recorded calls
           (self, encoder, cross, decode) against its plain version
           (8e-3), timed beside its bound, the plain version and SDPA.
  train    LM training.  (a) At the trainer's own call (q (4, 4096, 32,
           128) over k / v (4, 4096, 4, 128), bf16, causal): B5-bwd
           against its plain version (2e-2), two launches bit-equal, B5
           with lse bit-equal to B5 without it, its lse within 1e-5 of
           the plain logsumexp and its output within 8e-3, both timed
           beside their bounds, plain versions and SDPA (the kernels
           line's B5-bwd row); B5-bwd's ms per launch (delta, main
           pass, dQ cast), each launched alone, CUDA events.  Then B5-bwd
           (ops.flash_attention_bwd)
           against its plain version (autograd through the chunked
           oracle) for dq, dk and dv, in float32 (TF32 off, 1e-4) and
           bf16 (2e-2), max abs difference over max abs: Yi-9B's
           attention (1, 4096, 32 / 4,
           128) and (4, 512, 32 / 4, 128) causal, hd 64 at 16 / 16 heads
           (S=512 causal, 32 encoder rows, 512 over a 32-row memory),
           G = 6 (4, 1536, 48 / 8, 128) causal, ragged (300 causal; 300
           over 200), the bf16 tiles' edges (129 and 191 causal at 16 / 2
           heads, 200 queries over 130 keys causal, one key at hd 64);
           two launches bit-equal in each; two shapes back to back, the
           first's bits again after the second; B5 with lse gives B5's bits
           and an lse within 1e-5 of the plain logsumexp; timed at Yi's
           and the (4, 512) shape beside its bound and SDPA's backward.
           (b) One make_train_step step of Yi-9B at full width and 2
           layers, B=2 x S=256, on the card and the CPU from one state
           (the seed's weights after a shared warm step over the same
           batch reversed, made on the card, copied bit for bit): float32
           loss within 1e-5, every gradient leaf within 1e-4, and the
           card step's parameters within 1e-4 of the CPU's AdamW fed the
           card step's gradients from the same state; bf16 within 0.02;
           the parameters end to end against the CPU step's reported.  (c)
           launch.train.run on
           the card: Yi-9B at full width, 8 of 48 layers, remat full, B=4
           x S=4096, 6 steps of synthetic data (launch counts reset just
           before, read just after: B5 16 and B5-bwd 8 a step): losses
           and grad norms finite, the first within 1.0 of ln 64000; the
           per-step losses, grad norms, lrs and seconds; the median step of
           steps 2-6, tokens/s, model TFLOP/s (6 N T + 12 L H hd pairs
           B, N the product parameters) and its share of 989, peak
           bytes; one more step under torch.profiler (device busy and
           idle share, device ms of the products, B5, B5-bwd and the
           elementwise rest, and B5-bwd's per launch: delta, main pass,
           dQ cast).  (d) tests/test_train_loop.py's runs at
           reduced_config("yi-9b") on the card: the loss falls by 0.5 in
           30 steps; 8 steps straight and 4 + save + resume + 4 end on
           bit-equal parameters.  Under a sliding window: (a) also holds
           B5-bwd with a window to its plain version in bf16 and float32,
           two launches bit-equal, at starcoder2-15b's call (q (1, 8192,
           48, 128) over k / v (1, 8192, 4, 128), window 4096; bf16 timed
           beside the band's bound, the plain version and SDPA's backward
           with the band as a boolean mask: the kernels line's B5-bwd
           (window) row) and at (2, 300, 8 / 2, 128), window 100; (e) (b)
           for starcoder2-15b at full width and 2 layers, its window cut
           to 64 over 2 x 128-token rows, in float32; (f) launch.train.run of
           starcoder2-15b at full width, 6 of 40 layers, its own window
           4096, 1 x 8192 tokens, 4 steps: B5 12 and B5-bwd 6 a step, the
           losses and grad norms finite and the loss falling, step
           seconds, tokens/s and peak bytes.
  train_sharded
           the sharded train step (train.steps on a DeviceMesh: DTensor
           parameters on the rules' shardings, ZeRO-1 reduce-scatter,
           AdamW on each rank's shard, the all-gather back; B5 / B5-bwd
           on each rank's own heads).  (a) One NCCL rank, mesh (1, 1),
           the train phase's cell (Yi-9B full width, remat full, 4 x
           4096) cut to 4 layers (8 until PR 33), 3 steps from the
           trainer's starting state, against the one-device step from the same
           state: losses and parameters within 0.02 (bit-equal leaves counted),
           step
           seconds beside the one-device step's (the DTensor dispatch
           cost), B5 / B5-bwd launches counted.  (b) Four gloo ranks all
           on cuda:0, mesh (2, 2) (data, model), the same width at 2
           layers, global batch 4 x 4096, 2 steps, against a one-rank run
           in this process: every rank's losses identical, losses and the
           gathered parameters within 0.02, each rank's peak device bytes
           under the share reckoned before its run, B5 / B5-bwd launched
           on (2, 4096, 16 / 2, 128) per rank.  (c) B5 and B5-bwd at (b)'s
           local shapes against their plain versions, timed beside their
           bounds and SDPA.
  serve_sharded
           serving on a mesh (train.steps.make_prefill_step /
           make_decode_step on a DeviceMesh: DTensor parameters and caches
           on the rules' shardings, B5 on each rank's heads and cache
           shard) and B5's window and int8 cases.  Gloo ranks all on
           cuda:0, each case against a one-device run of the same model
           in this process first (freed before the ranks start): its bf16
           greedy tokens, then its float32 replay (the bf16 weights read
           in float32, float32_replay) teacher forced on them, which the
           ranks repeat on their shards, after a bf16 run of some steps
           where the case says: (a) qwen1.5-32b at full width, 2 of 64
           layers, its int8 cache, decode_32k's rules on (2, 2) (KV heads
           over model, batch over data), 4 prompts of 2,048 tokens, a
           4,096-row cache, 8 bf16 steps and 32 float32 steps; (c)
           jamba-v0.1-52b at 8 of 32 layers under long_500k's rules on
           (2, 2) (batch 1, the 4,096 rows over data; 16,384 until PR
           33, the time limit), a 2,032-token
           prompt and 32 float32 steps that cross into data rank 1's
           rows; (hd) yi-9b at full width, 2 of 48 layers, on (1, 8)
           (eight ranks; its 4 KV heads do not divide 8, so the cache
           splits head_dim), 4 prompts of 4,088 tokens, a 4,096-row cache,
           4 steps in bf16 and in float32 (8 until PR 33: the time
           limit).  Gates: every step's float32 logits within 2e-3 of the
           largest; every bf16 step within twice the one-device bf16 run's own
           distance from float32 over
           the same steps (or 0.02 where larger); every rank's logits
           identical; each rank's peak device bytes under the share
           reckoned before its run; B5 launched on every rank each step
           ((c): data rank 1 only from the step whose token is its first
           row); the bytes each (hd) rank receives through the head_dim
           all-to-all each step (counted in parallel.compat.EXCHANGED)
           equal to the visible rows of the KV head it reads, and none in
           the other cases or in a prefill.  (b) starcoder2-15b at full
           width, 10 of 40 layers, on one device: 2 prompts of 6,144
           tokens (past its 4,096 window), an 8,192-row cache, 32 steps:
           B5 launches (10 a step), the key rows each launch's blocks
           load, counted by the kernel (ops.count_kv_rows) and each decode
           launch's held to the decode body's spans of the window's tiles
           (each visible 64-key tile once per batch and KV head), prefill
           and step times, finite
           logits; its reduced config with the window cut to 64 on the
           card against the CPU within 0.02.  B5's cases at the phase's
           calls against the plain version, timed beside their bounds and
           SDPA with the boolean band mask where one call computes the
           same function: window prefill and decode, int8 decode, the
           sequence-parallel ranks' calls with lse, and the head_dim
           case's call after its all-to-all.
  audit    static analysis and the plan audit (repro_torch.analysis;
           needs main).  python -m repro_torch.launch.lint --strict in a
           subprocess (exit 0 with the committed baseline); the audit
           workload (25 fits of erdos_renyi(200 | 230 | 400, ...): segment
           and tile cold, same-bucket, warm and fit_many twice, fused tile,
           one sharded rank, out of core on segment and tile, unfused
           segment and fused tile out of core) on the card under one
           TraceAudit: zero excess plan builds, B1-B4 each launched (counts
           reset just before, read just after), the kernel library built
           and loaded at most once in the process, and every fit's labels
           equal to the same legs run on the CPU with the plain versions;
           then a cold and a same-bucket fused tile fit of main's
           grid2d(3500) under one TraceAudit: zero excess, the second a
           plan-cache hit, both equal to main's labels.  Plan builds per
           bin, the excess count and the walls in one line.
  dryrun   the dry run (repro_torch.launch.dryrun) under this machine's
           torch, three subprocesses at once: yi-9b train_4k on the pod
           and graph-lpa on the multipod from the CLI (fake worlds of 256
           and 512 ranks, meta tensors; each record's FLOPs, argument
           bytes and collective wire bytes non-zero), and the train
           phase's trainer cell (Yi-9B at full width, 8 layers, 4 x 4096)
           traced on a one-rank world, while the card runs one real step
           of that cell: the trace's argument bytes equal to the card's
           state (parameters, AdamW state, batch) exactly, its reckoned
           peak (arguments + temp) within 25 % of max_memory_allocated
           over the real step; each subprocess under 300 s.

The build fails the run if ptxas reports a spill in the flash kernel
(flash_wgmma<64|128, false|true>: bf16 K / V or the int8 cache), in
B5-bwd's bf16 main pass (bwd_wgmma<64|128>) or
in any instance of min_label or fused_split, or serialised wgmma in
either of the first two.

Then the kernels summary line, the nvidia-smi line, and the result line.
Any failure raises: the exit code is then non-zero and no result prints.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
LPA_KERNELS = ("label_argmax", "min_label", "fused_move", "fused_split")
# Yi-9B's attention (src/repro/configs/yi_9b.py) on one 4096-token prompt.
FLASH_MAIN = {"b": 1, "s": 4096, "h": 32, "k": 4, "hd": 128}
# More timed calls at that width: (S, causal).
FLASH_TIMED = ((4096, False), (16384, True))
FLASH_KERNELS = ("flash_wgmma<64, false>", "flash_wgmma<128, false>",
                 "flash_wgmma<64, true>", "flash_wgmma<128, true>")
# B5-bwd's bf16 main pass, held to the same gate as FLASH_KERNELS.
BWD_KERNELS = ("bwd_wgmma<64>", "bwd_wgmma<128>")
# B5's decode body, held to the same gate (no spill).
DECODE_KERNELS = ("flash_decode<64, false>", "flash_decode<128, false>",
                  "flash_decode<64, true>", "flash_decode<128, true>",
                  "decode_combine<64>", "decode_combine<128>")
# The decode phase's calls, one per decode row of PERF.md's kernel table:
# (name, b, h, k, hd, rows, kv_len, q_offset, window, causal, int8, lse).
DECODE_CALLS = (
    ("yi-9b", 4, 32, 4, 128, 1024, 513, 512, None, False, False, False),
    ("qwen2-moe", 4, 16, 16, 128, 1024, 513, 512, None, False, False,
     False),
    ("jamba", 4, 32, 8, 128, 1024, 513, 512, None, False, False, False),
    ("seamless", 4, 16, 16, 64, 1024, 513, 512, None, False, False, False),
    ("seamless cross", 4, 16, 16, 64, 32, 32, 0, None, False, False, False),
    ("internvl2", 4, 48, 8, 128, 2048, 1537, 1536, None, False, False,
     False),
    ("arctic", 4, 64, 8, 128, 1024, 513, 512, None, False, False, False),
    ("starcoder2-15b window", 2, 48, 4, 128, 8192, 6176, 6175, 4096, False,
     False, False),
    ("qwen1.5-32b int8 (a)", 2, 24, 24, 128, 4096, 2080, 2079, None, True,
     True, False),
    ("jamba SP (c) rank 0", 1, 16, 4, 128, 8192, 8192, 8207, None, True,
     False, True),
    ("jamba SP (c) rank 1", 1, 16, 4, 128, 8192, 16, 15, None, True, False,
     True),
    ("yi-9b head_dim (hd)", 4, 4, 1, 128, 4096, 4089, 4088, None, True,
     False, False))
DECODE_MAIN = "yi-9b"    # the kernels line's row
# The lm phase: Yi-9B served at full width and depth from random weights
# (seed LM_SEED); (b) runs LM_CPU's cut on the card and on the CPU.
LM_ARCH = "yi-9b"
LM_SEED = 0
LM_SERVE = {"batch": 4, "prompt_len": 512, "max_new": 32, "s_max": 1024}
LM_CPU = {"layers": 2, "batch": 2, "prompt_len": 64, "steps": 8,
          "s_max": 128}
LM_TOL = 0.02          # logits, relative max-abs: tests/test_serving.py TOL
# Teacher forcing at 48 layers: float32 (the weights upcast) to 1e-3; bf16
# to LM_NOISE_FACTOR x the bf16 forward's own distance from the float32
# forward, as LM_TOL is the reference's bound at 2 layers and the bf16
# model's rounding noise grows with depth (PERF.md, PR 27).
LM_F32_TOL = 1e-3
LM_NOISE_FACTOR = 1.5
LM_KERNEL_TOL = 8e-3   # B5 against its plain version in bf16 (flash's)
LM_RAGGED_KEYS = 300   # the B=2 decode call's keys: not a multiple of 128
# The lm_families phase: one arch of each other family at full width,
# random bf16 weights from LM_SEED, cut in depth (layers kept): Jamba to
# one 8-layer group (103 GB at 32), Arctic to one of its 35 layers (954
# GB), the rest to 2 decoder layers for the script's time limit (full
# depth until the dry run and the window trainer joined, 4 layers until
# the decode phase did).
# (b) runs full width at LM_CPU's 2 layers, but reduced_config for those two
# (one group or layer is 13-14 B parameters), and cuts the VLM's prefix to
# LM_FAMILY_PREFIX rows on the CPU.
LM_FAMILIES = (("qwen2-moe-a2.7b", 2), ("jamba-v0.1-52b", 8),
               ("rwkv6-7b", 2), ("seamless-m4t-large-v2", 2),
               ("internvl2-26b", 2), ("arctic-480b", 1))
LM_FAMILY_REDUCED_CPU = ("jamba-v0.1-52b", "arctic-480b")
LM_FAMILY_PREFIX = 64
LM_FRAMES = 32         # the encoder frames serve() makes
# Graphs of the timing phase beyond the main fit: (name, generator call).
ER_GRAPH = "erdos_renyi(1 << 21, 16.0, seed=0)"
PLANTED_GRAPH = "planted_partition(128, 1024, 0.3, 0.001, seed=0)"
SKEW_GRAPH = "rmat(19, 16, seed=0)"      # rmat(20, ...) until PR 33
PHASES = ("kernels", "parity", "c1", "main", "wide_fit", "dense",
          "skew_fit", "batch", "obs", "microbatch", "stream", "ingest",
          "ooc", "serve", "sharded", "timing", "trace", "flash", "decode",
          "lm",
          "lm_families", "train", "train_sharded", "serve_sharded",
          "audit", "dryrun")
# phase -> the phases whose graphs and fits it reuses
NEEDS = {"timing": ("main", "wide_fit"), "trace": ("main",),
         "dense": ("wide_fit",), "microbatch": ("batch",),
         "stream": ("main",), "obs": ("main", "batch"),
         "ooc": ("main", "ingest"), "sharded": ("main",),
         "audit": ("main",)}
# The obs phase's traffic-A members held against their solo fits.
OBS_MEMBERS = (0, 15, 31)
# The stream phase's road edits of the main graph, grid2d(ROAD_SIDE).
ROAD_SIDE = 3500
ROAD_ROUNDS = 3
ROAD_DELTA_EDGES = 1000
# The serve phase's tenants: evolving_sequence(SERVE_SIZE, 5.0, ...,
# SERVE_DELTA_EDGES, seed=7 + 17 * i), SERVE_ROUNDS deltas through the
# service, one more for the restored parity tenants; the warm-label
# budgets of runs (a) and (b) (16 x 400,000 B of labels; (b) holds 12).
# 32 tenants (budgets 16 / 9.6 MB) until PR 33 cut them for the script's
# time limit.
SERVE_TENANTS = 16
SERVE_SIZE = 100_000
SERVE_ROUNDS = 3
SERVE_DELTA_EDGES = 100
SERVE_PARITY = 4
SERVE_BUDGETS = (16_000_000, 4_800_000)
# Spans summed per serve run: the batcher's fits (engine.*; serial on its
# worker), the dispatcher's launches (a delta's splice) and settlements.
SERVE_SPANS = ("engine.fit_many", "engine.prepare", "engine.dispatch",
               "engine.compact", "engine.quality", "serve.launch",
               "serve.settle")
# The sharded phase's second graph (traffic B's member shape, D=64), its
# stale cadence, and each spawned run's deadline.
SHARDED_PLANTED = "planted_partition(32, 512, 0.04, 0.0005, seed=1)"
SHARDED_STALE_K = 2
SHARDED_TIMEOUT_S = 300
# The ingest phase's file: grid2d(INGEST_SIDE) as MatrixMarket.
INGEST_SIDE = 1400        # 2000 until PR 33 (the script's time limit)
GRAPH_FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
# Traffic A of the batch phase: 32 road meshes grid2d(side) in one batch.
TRAFFIC_A_SIDES = tuple(range(400, 711, 10))
ARGMAX_KERNELS = ("label_argmax", "fused_move")
SPLIT_KERNELS = ("min_label", "fused_split")
PLAIN_CUBE_FLOATS = 1 << 28   # the plain argmax's D x D cube per chunk
KERNELS = {
    "label_argmax": ("src/repro_torch/kernels/csrc/label_argmax.cu",
                     "src/repro/kernels/label_argmax.py:81"),
    "min_label": ("src/repro_torch/kernels/csrc/min_label.cu",
                  "src/repro/kernels/min_label.py:28"),
    "fused_move": ("src/repro_torch/kernels/csrc/fused_move.cu",
                   "src/repro/kernels/fused_sweep.py:65"),
    "fused_split": ("src/repro_torch/kernels/csrc/fused_split.cu",
                    "src/repro/kernels/fused_sweep.py:128"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_attention_decode.cu",
                     "src/repro/kernels/flash_attention.py:73"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "gradient of src/repro/kernels/flash_attention.py:73 (no Pallas "
        "backward; the reference differentiates "
        "src/repro/models/attention.py:100)"),
}


_START: list = []        # the script's start on the host clock (main)


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started."""
    if "phase" in obj and _START:
        obj = {**obj, "script_elapsed_s": time.perf_counter() - _START[0]}
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------- kernels

def _random_case(torch, rows, d, seed, integer, dev):
    rng = np.random.default_rng(seed + 7919 * d)
    n_labels = max(d // 2, 2)
    nbr = rng.integers(0, rows, size=(rows, d)).astype(np.int32)
    labels = rng.integers(0, n_labels, size=rows).astype(np.int32)
    absent = labels[1::7]
    labels[1::7] = n_labels + 1 + np.arange(len(absent))  # own label absent
    mask = rng.random((rows, d)) < 0.8
    mask[0] = False                      # edgeless rows
    mask[3] = False
    nbr[3] = 3                           # ... one self-pointing, as padded
    if integer:
        w = rng.integers(1, 5, size=(rows, d)).astype(np.float32)
    else:
        w = rng.uniform(0.1, 5.0, size=(rows, d)).astype(np.float32)
    comm = rng.integers(0, 4, size=rows).astype(np.int32)
    chg = rng.random(rows) < 0.3
    state = [rng.random(rows) < p for p in (0.6, 0.4, 0.7)]
    real = np.ones(rows, bool)
    real[-max(rows // 8, 1):] = False
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        nbr=nbr, nw=w, nmask=mask, labels=labels, comm=comm, chg=chg,
        active=state[0], cand_prev=state[1], klass=state[2],
        real=real).items()}
    return t


def _argmax_property(torch, t, out, seed, rtol=1e-5):
    """Brute force in float64: best weight and chosen label reach the true
    per-label maximum; current weight is the own label's sum."""
    best_lab, best_w, cur_w = (x.cpu().numpy() for x in out)
    nbr, w = t["nbr"].cpu().numpy(), t["nw"].cpu().numpy()
    mask, labels = t["nmask"].cpu().numpy(), t["labels"].cpu().numpy()
    lab = labels[nbr]
    for i in range(nbr.shape[0]):
        acc: dict = {}
        for j in np.flatnonzero(mask[i]):
            acc[lab[i, j]] = acc.get(lab[i, j], 0.0) + float(w[i, j])
        if not acc:
            check(best_w[i] == 0.0 and best_lab[i] == 2147483647,
                  f"edgeless row {i}: {best_lab[i]} {best_w[i]}")
            continue
        best = max(acc.values())
        check(abs(best_w[i] - best) <= rtol * best, f"row {i} best_w")
        check(best_lab[i] in acc
              and abs(acc[best_lab[i]] - best) <= rtol * best,
              f"row {i} best_lab")
        own = acc.get(labels[i], 0.0)
        check(abs(cur_w[i] - own) <= rtol * max(own, 1e-30),
              f"row {i} cur_w")


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch, ops, ref, dev):
    widths = (*range(1, 10), 16, 32, 33, 64, 128, 512, 1024)
    seeds = (0, 1, 12345, -1)
    rows_for = {**{d: 4096 for d in range(1, 10)}, 16: 4096, 32: 2048,
                33: 2048, 64: 1024, 128: 512, 512: 128, 1024: 40}
    err = {k: 0.0 for k in LPA_KERNELS}
    cases = 0
    for d in widths:
        rows = rows_for[d]
        ti = _random_case(torch, rows, d, 11, True, dev)
        tr = _random_case(torch, rows, d, 12, False, dev)
        # fused_move's early exits: no row active (act only from the
        # wake), no row in the sub-sweep's class (no argmax at all)
        none = torch.zeros_like(tr["active"])
        states = (ti, tr, {**tr, "active": none}, {**tr, "klass": none})
        for seed in seeds:
            # label_argmax: exact on integer weights, property on real ones
            k = ops.label_argmax(ti["nbr"], ti["nw"], ti["nmask"],
                                 ti["labels"], seed)
            p = ref.label_argmax_ref(ti["nbr"], ti["nw"], ti["nmask"],
                                     ti["labels"], seed)
            err["label_argmax"] = max(err["label_argmax"],
                                      *(_err(a, b) for a, b in zip(k, p)))
            kr = ops.label_argmax(tr["nbr"], tr["nw"], tr["nmask"],
                                  tr["labels"], seed)
            _argmax_property(torch, tr, kr, seed)

            # fused_move: exact vs plain, bit-identical to the unfused kernel
            args = (ti["nbr"], ti["nw"], ti["nmask"], ti["labels"],
                    ti["chg"], ti["active"], ti["cand_prev"], ti["klass"],
                    ti["real"], seed)
            kf = ops.fused_move(*args)
            pf = ref.fused_move_ref(*args)
            err["fused_move"] = max(err["fused_move"],
                                    *(_err(a, b) for a, b in zip(kf, pf)))
            for t in states:
                new, act = ops.fused_move(
                    t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                    t["active"], t["cand_prev"], t["klass"], t["real"], seed)
                bl, bw, cw = ops.label_argmax(t["nbr"], t["nw"], t["nmask"],
                                              t["labels"], seed)
                wake = (t["chg"][t["nbr"]] & t["nmask"]).any(dim=1)
                act_sep = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
                adopt = act_sep & t["klass"] & (bw > cw.clamp_min(0.0))
                new_sep = torch.where(adopt, bl, t["labels"])
                check(torch.equal(new, new_sep) and torch.equal(act, act_sep),
                      f"fused_move != label_argmax + glue (d={d} s={seed})")
            cases += 1
        # min_label / fused_split are seed-free integer ops
        for t in (ti, tr):
            margs = (t["nbr"], t["nmask"], t["labels"], t["comm"])
            km = ops.min_label(*margs)
            err["min_label"] = max(err["min_label"],
                                   _err(km, ref.min_label_ref(*margs)))
            for prune in (True, False):
                for chg in (t["chg"], torch.ones_like(t["chg"])):
                    ks = ops.fused_split(*margs, chg, prune)
                    ps = ref.fused_split_ref(*margs, chg, prune)
                    err["fused_split"] = max(err["fused_split"],
                                             _err(ks, ps))
                    if not prune or bool(chg.all()):
                        check(torch.equal(ks, km),
                              f"fused_split != min_label (d={d})")
    torch.cuda.synchronize()
    for name, e in err.items():
        check(e == 0.0, f"{name} disagrees with its plain version: {e}")
    return {"widths": list(widths), "seeds": list(seeds), "cases": cases,
            "rtol_real_weights": 1e-5, "max_abs_err": err}


# ---------------------------------------------------------------- parity

def phase_parity(torch, rt, dev):
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import (
        erdos_renyi,
        figure1_graph,
        karate_club,
        planted_partition,
    )
    graphs = {"karate": karate_club()[0], "er": erdos_renyi(180, 5.0, seed=11),
              "planted": planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              "figure1": figure1_graph()[0]}
    rt.ops.reset_launches()
    out = []
    for split, shortcut in (("none", False), ("lp", False), ("lpp", False),
                            ("lp", True), ("lpp", True)):
        for gname, g in graphs.items():
            seg = Engine(EngineConfig(split=split, shortcut=shortcut,
                                      backend="segment"),
                         cache=PlanCache()).fit(g)
            for fuse in ("on", "off"):
                eng = Engine(EngineConfig(split=split, shortcut=shortcut,
                                          fuse_sweeps=fuse),
                             cache=PlanCache())
                res = eng.fit(g)
                check(res.backend == "tile", "auto did not pick tile on CUDA")
                same = (np.array_equal(res.labels, seg.labels)
                        and res.lpa_iterations == seg.lpa_iterations
                        and res.split_iterations == seg.split_iterations
                        and res.num_communities == seg.num_communities)
                check(same, f"tile != segment: {gname} {split} "
                            f"shortcut={shortcut} fuse={fuse}")
                if split != "none":
                    check(res.check_connected(g) == 0.0,
                          f"disconnected community: {gname} {split}")
            out.append({"graph": gname, "split": split, "shortcut": shortcut,
                        "lpa_iterations": seg.lpa_iterations,
                        "split_iterations": seg.split_iterations,
                        "communities": seg.num_communities})
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched in the parity fits")
    return {"cases": out, "launches": launches}


# -------------------------------------------------------------------- c1

def phase_c1(torch, dev):
    """Real weights on the segment path: the card's fit equals the CPU
    port's (held to the JAX package on the CPU by the tests) and repeats;
    segment_sum folds each run in index order on both devices."""
    from repro_torch.core.lpa import segment_sum
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import weighted_planted_partition
    g = weighted_planted_partition(40, 500, 0.05, 0.001, seed=3)
    cfg = dict(split="lp", backend="segment")
    want = Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache()).fit(g)
    fits = [Engine(EngineConfig(**cfg), cache=PlanCache()).fit(g)
            for _ in range(2)]
    for i, res in enumerate(fits):
        check(res.device.startswith("cuda"), "c1: the fit did not run on "
              "the card")
        check(np.array_equal(res.labels, want.labels)
              and res.lpa_iterations == want.lpa_iterations
              and res.split_iterations == want.split_iterations,
              f"c1: CUDA segment fit {i} != CPU fit on real weights")
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 500, size=1 << 20))
    val = rng.uniform(0.1, 5.0, size=seg.size).astype(np.float32)
    sums = [segment_sum(torch.from_numpy(val).to(d),
                        torch.from_numpy(seg).to(d), 500).cpu().view(
                            torch.int32) for d in ("cpu", dev, dev)]
    check(all(torch.equal(sums[0], x) for x in sums[1:]),
          "c1: segment_sum on the card != the CPU's bits")
    return {"graph": "planted_partition(40, 500, 0.05, 0.001, seed=3), "
                     "uniform(0.1, 5.0) weights", "n": g.n,
            "directed_edges": g.num_edges, "split": "lp",
            "lpa_iterations": want.lpa_iterations,
            "split_iterations": want.split_iterations,
            "communities": want.num_communities,
            "cuda_total_s": [r.total_seconds for r in fits],
            "cpu_total_s": want.total_seconds,
            "segment_sum_runs": 500, "segment_sum_values": int(seg.size)}


# ------------------------------------------------------------------ main

def _wall(torch, fn):
    """(result, seconds from the call to its result, the device idle)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _three_fits(torch, rt, g):
    """Tile fused, tile unfused and segment fits (split lp) of ``g``, with
    the launch counts (reset just before the tile fits, read just after),
    the peak device memory of the tile fits and each fit's wall time, from
    the call to the result, beside the sum of its stage timings."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    walls = {}

    def fit(**kw):
        res, wall = _wall(torch, lambda: Engine(
            EngineConfig(split="lp", **kw), cache=PlanCache()).fit(g))
        walls[id(res)] = wall
        return res

    torch.cuda.reset_peak_memory_stats()
    rt.ops.reset_launches()
    fused = fit(backend="tile")
    launches_fused = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    unfused = fit(backend="tile", fuse_sweeps="off")
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    segment = fit(backend="segment")
    for name, res in (("unfused tile", unfused), ("segment", segment)):
        check(np.array_equal(res.labels, fused.labels)
              and res.lpa_iterations == fused.lpa_iterations
              and res.split_iterations == fused.split_iterations,
              f"{name} labels differ from the fused tile fit")
    frac = fused.check_connected(g)
    check(frac == 0.0, f"disconnected fraction {frac}")

    def summary(res):
        wall = walls[id(res)]
        return {"timings_s": res.timings, "total_s": res.total_seconds,
                "compact_s": res.timings["compact"], "wall_s": wall,
                "outside_stages_s": wall - res.total_seconds,
                "edges_per_s": g.num_edges / res.total_seconds,
                "edges_per_wall_s": g.num_edges / wall}

    return fused, {
        "n": g.n, "directed_edges": g.num_edges,
        "bucket": list(fused.bucket),
        "lpa_iterations": fused.lpa_iterations,
        "split_iterations": fused.split_iterations,
        "communities": fused.num_communities,
        "disconnected_fraction": frac,
        "fused": summary(fused), "unfused": summary(unfused),
        "segment": summary(segment),
        "launches": launches, "launches_fused_fit": launches_fused,
        "launches_unfused_fit": {k: launches[k] - launches_fused[k]
                                 for k in launches},
        "peak_bytes_tile_fits": peak}


def phase_main(torch, rt, dev):
    from repro_torch.graphgen import grid2d
    t0 = time.perf_counter()
    g = grid2d(3500).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fused, res = _three_fits(torch, rt, g)
    for name, n in res["launches"].items():
        check(n > 0, f"{name} was not launched by the main fits")
    return g, fused, {"graph": "grid2d(3500)", "graph_build_s": build_s,
                      **res}


def phase_wide_fit(torch, rt, dev):
    """The main fit's check at D=64 tiles: tile fused, tile unfused and
    segment fits of the ER graph give identical labels and iteration
    counts and no internally-disconnected community."""
    from repro_torch.graphgen import erdos_renyi
    t0 = time.perf_counter()
    g = erdos_renyi(1 << 21, 16.0, seed=0).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fused, res = _three_fits(torch, rt, g)
    return g, fused, {"graph": ER_GRAPH, "graph_build_s": build_s, **res}


def phase_skew_fit(torch, dev):
    """Two segment fits (split lp) of a skewed graph: R-MAT with Graph500's
    parameters, whose hubs give long (vertex, label) runs, each summed by
    one thread in segment_sum.  The fits must agree; the labels' digest
    lets runs of other checkouts be compared with them."""
    import hashlib

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import rmat
    t0 = time.perf_counter()
    g = rmat(19, 16, seed=0).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fits = [Engine(EngineConfig(backend="segment", split="lp"),
                   cache=PlanCache()).fit(g) for _ in range(2)]
    a, b = fits
    check(np.array_equal(a.labels, b.labels)
          and (a.lpa_iterations, a.split_iterations)
          == (b.lpa_iterations, b.split_iterations),
          "skew_fit: two segment fits of one graph differ")
    frac = a.check_connected(g)
    check(frac == 0.0, f"skew_fit: disconnected fraction {frac}")
    # the longest (vertex, community) run of the result: what one thread
    # folds in the last sweeps
    src = g.src[:g.num_edges].long()
    lab = torch.from_numpy(np.asarray(a.labels)).to(dev).long()
    key = src * g.n + lab[g.dst[:g.num_edges].long()]
    return {"graph": SKEW_GRAPH, "graph_build_s": build_s, "n": g.n,
            "directed_edges": g.num_edges,
            "max_degree": int(torch.bincount(src).max()),
            "longest_run": int(torch.unique(key, return_counts=True)[1]
                               .max()),
            "lpa_iterations": a.lpa_iterations,
            "split_iterations": a.split_iterations,
            "communities": a.num_communities, "disconnected_fraction": frac,
            "labels_sha256": hashlib.sha256(
                np.asarray(a.labels).tobytes()).hexdigest()[:16],
            "fits": [{"timings_s": r.timings, "total_s": r.total_seconds,
                      "edges_per_s": g.num_edges / r.total_seconds}
                     for r in fits]}


# ----------------------------------------------------------------- dense

def phase_dense(torch, rt, g, dev):
    """``core.dense`` on the card (B1 and B2 called directly on the ER
    graph's tiles) against the segment path on the same graph; then the
    ``gsl_lpa`` / ``gve_lpa`` facades on the card against the CPU."""
    from repro_torch.core import dense, gsl_lpa, gve_lpa
    from repro_torch.core.lpa import lpa_run
    from repro_torch.core.split import split_lp
    from repro_torch.graphgen import karate_club
    pg = dense.pad_graph(g)
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    (labels, iters), lpa_s = _wall(torch, lambda: dense.lpa_run_dense(pg))
    (split, split_iters), split_s = _wall(
        torch, lambda: dense.split_lp_dense(pg, labels))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    check(launches["label_argmax"] == 2 * iters
          and launches["min_label"] == split_iters,
          f"dense: launches {launches} for {iters} / {split_iters} sweeps")
    seg, seg_lpa_s = _wall(torch, lambda: lpa_run(g))
    seg_split, seg_split_s = _wall(torch, lambda: split_lp(g, seg.labels))
    check(torch.equal(labels, seg.labels) and iters == seg.iteration,
          "dense: lpa_run_dense != the segment lpa_run")
    check(torch.equal(split, seg_split.labels)
          and split_iters == seg_split.iterations,
          "dense: split_lp_dense != the segment split_lp")
    karate = karate_club()[0]
    facades = {}
    for fn in (gsl_lpa, gve_lpa):
        card, cpu = fn(karate), fn(karate, device="cpu")
        check(card.detail.device.startswith("cuda")
              and np.array_equal(card.labels, cpu.labels)
              and (card.lpa_iterations, card.split_iterations)
              == (cpu.lpa_iterations, cpu.split_iterations),
              f"dense: {fn.__name__} on the card != on the CPU")
        facades[fn.__name__] = {"communities": int(card.labels.max()) + 1,
                                "lpa_iterations": card.lpa_iterations,
                                "split_iterations": card.split_iterations}
    return {"graph": ER_GRAPH, "rows": pg.n_pad, "d": pg.d_max,
            "lpa_iterations": iters, "split_iterations": split_iters,
            "launches": launches, "dense_lpa_s": lpa_s,
            "dense_split_s": split_s, "segment_lpa_s": seg_lpa_s,
            "segment_split_s": seg_split_s,
            "karate_club_facades": facades}


# ----------------------------------------------------------------- batch

def _traffic_a():
    from repro_torch.graphgen import grid2d
    return [grid2d(side) for side in TRAFFIC_A_SIDES]


def _traffic_b():
    from repro_torch.core.graph import build_graph
    from repro_torch.graphgen import planted_partition
    edgeless = np.zeros((0, 2), np.int64)
    return ([planted_partition(32, 512, 0.04, 0.0005, seed=s)[0]
             for s in range(15)]
            + [build_graph(edgeless, n=100), build_graph(edgeless, n=1)])


def _same_fit(a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and (a.lpa_iterations, a.split_iterations, a.num_communities)
            == (b.lpa_iterations, b.split_iterations, b.num_communities))


def _no_disconnected(torch, graphs, results, dev) -> float:
    """Disconnected-community fraction over all members at once: the
    members' labels, shifted apart, on their packed disjoint union (a
    community of the union is disconnected iff it is in its member)."""
    from repro_torch.core.batch import GraphBatch
    from repro_torch.core.detect import disconnected_fraction
    batch = GraphBatch.pack(graphs, device=dev)
    shift = np.cumsum([0] + [r.num_communities for r in results[:-1]])
    comm = np.concatenate([r.labels + s for r, s in zip(results, shift)])
    return float(disconnected_fraction(batch.graph,
                                       torch.from_numpy(comm).to(dev)))


def _fit_many_timed(torch, rt, graphs, **cfg):
    """One fit_many with its wall time and the LPA kernels' launches
    (reset just before, read just after)."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    res, wall = _wall(torch, lambda: eng.fit_many(graphs))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    stages = {k: sum(r.timings[k] for r in res) for k in res[0].timings}
    return res, {"wall_s": wall, "stage_s": stages,
                 "bucket": list(res[0].bucket), "backend": res[0].backend,
                 "launches": launches}


def _solo_fits(torch, graphs, **cfg):
    """Each member's solo fit, with the sum of their wall times."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    out, total = [], 0.0
    for g in graphs:
        res, wall = _wall(torch, lambda g=g: eng.fit(g))
        out.append(res)
        total += wall
    return out, total


def phase_batch(torch, rt, dev):
    """Engine.fit_many on traffic A (32 road meshes, tile fused and
    unfused) and B (17 mixed members, auto = tile fused, tile unfused and
    segment, split lp and lpp + shortcut); every member equals its solo
    fused tile fit and has no disconnected community.  Members start on
    the host, as users send them, for the batched and the solo fits
    alike.  Then the four LPA kernels on traffic A's packed tiles."""
    from repro_torch.core.batch import GraphBatch
    from repro_torch.engine import EngineConfig
    from repro_torch.engine.bucketing import batch_bucket_for
    from repro_torch.engine.registry import choose_backend_batch
    out = {}

    # traffic A: batches of road-mesh graphs from many users
    t0 = time.perf_counter()
    graphs = _traffic_a()
    build_s = time.perf_counter() - t0
    graphs_a = graphs
    solo, solo_s = _solo_fits(torch, graphs, backend="tile", split="lp")
    runs = {}
    for tag, fuse in (("fused", "on"), ("unfused", "off")):
        res, row = _fit_many_timed(torch, rt, graphs, backend="tile",
                                   split="lp", fuse_sweeps=fuse)
        for i, (r, s) in enumerate(zip(res, solo)):
            check(_same_fit(r, s) and r.batch_index == i
                  and r.batch_size == len(graphs),
                  f"batch A {tag}: member {i} != its solo fused tile fit")
        runs[tag] = row
    batch_launches = {k: runs["fused"]["launches"][k]
                      + runs["unfused"]["launches"][k] for k in LPA_KERNELS}
    for k, v in batch_launches.items():
        check(v > 0, f"batch A: {k} was not launched by the fit_many runs")
    frac = _no_disconnected(torch, graphs, res, dev)
    check(frac == 0.0, f"batch A: disconnected fraction {frac}")
    check(choose_backend_batch(graphs, EngineConfig(), dev) == "segment",
          "batch A: auto should pick segment at this size")
    # the four kernels on the packed shape, with the fit's labels
    batch = GraphBatch.pack(graphs, device=dev)
    bucket = batch_bucket_for(batch)
    shift = np.repeat(batch.offsets[:-1], batch.sizes).astype(np.int32)
    labels = np.concatenate([s.labels for s in solo]) + shift
    t = _timing_tiles(torch, batch.graph, bucket.n, bucket.d, labels, dev)
    kern = _time_argmax(torch, rt, t, plain_reps=5)
    kern.update(_time_split(torch, rt, t, plain_reps=5))
    del t, batch
    out["traffic_a"] = {
        "members": f"grid2d(side), side = {TRAFFIC_A_SIDES[0]}, "
                   f"{TRAFFIC_A_SIDES[1]}, ..., {TRAFFIC_A_SIDES[-1]}",
        "k": len(graphs), "vertices": sum(g.n for g in graphs),
        "directed_edges": sum(g.num_edges for g in graphs),
        "graph_build_s": build_s, "split": "lp",
        "lpa_iterations_min_max": [min(r.lpa_iterations for r in solo),
                                   max(r.lpa_iterations for r in solo)],
        "split_iterations_min_max": [min(r.split_iterations for r in solo),
                                     max(r.split_iterations for r in solo)],
        "disconnected_fraction": frac, **runs,
        "solo_fused_tile_wall_sum_s": solo_s,
        "batch_launches": batch_launches, "kernels_packed_shape": kern}

    # traffic B: many medium graphs of mixed shape in one dispatch
    t0 = time.perf_counter()
    graphs = _traffic_b()
    build_s = time.perf_counter() - t0
    check(choose_backend_batch(graphs, EngineConfig(), dev) == "tile",
          "batch B: auto did not pick tile on CUDA")
    cases = []
    for split, shortcut in (("lp", False), ("lpp", True)):
        cfg = dict(split=split, shortcut=shortcut)
        solo_b, solo_b_s = _solo_fits(torch, graphs, **cfg)
        if split == "lp":
            solo_lp = solo_b
        row = {"split": split, "shortcut": shortcut,
               "solo_auto_wall_sum_s": solo_b_s}
        for tag, kw in (("auto", {}), ("tile_unfused",
                                       dict(backend="tile", fuse_sweeps="off")),
                        ("segment", dict(backend="segment"))):
            res, run = _fit_many_timed(torch, rt, graphs, **cfg, **kw)
            for i, (r, s) in enumerate(zip(res, solo_b)):
                check(_same_fit(r, s), f"batch B {split} {tag}: member {i} "
                      f"!= its solo fit")
            row[tag] = run
        check(row["auto"]["backend"] == "tile"
              and row["auto"]["bucket"][3] == 64,
              f"batch B: auto ran {row['auto']['backend']} at "
              f"{row['auto']['bucket']}")
        frac = _no_disconnected(torch, graphs, res, dev)
        check(frac == 0.0, f"batch B {split}: disconnected fraction {frac}")
        row["disconnected_fraction"] = frac
        cases.append(row)
    out["traffic_b"] = {
        "members": "planted_partition(32, 512, 0.04, 0.0005, seed=s), "
                   "s = 0..14; edgeless 100-vertex; one vertex",
        "k": len(graphs), "vertices": sum(g.n for g in graphs),
        "directed_edges": sum(g.num_edges for g in graphs),
        "max_degree": max(int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
                          for g in graphs if g.num_edges),
        "graph_build_s": build_s, "cases": cases}
    return graphs_a, graphs, solo_lp, batch_launches, out


def phase_microbatch(torch, graphs, solo):
    """A MicroBatcher(max_batch=8) over the card takes 24 submissions,
    drawn from traffic B's members, from 4 threads; every result equals
    the member's solo fit.  Every wait is bounded."""
    import threading

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.launch.microbatch import MicroBatcher
    picks = [(7 * i) % len(graphs) for i in range(24)]
    subs = [None] * len(picks)
    mb = MicroBatcher(Engine(EngineConfig(split="lp"), cache=PlanCache()),
                      max_batch=8, batch_timeout_ms=20.0)

    def client(c):
        for j in range(c, len(picks), 4):
            subs[j] = mb.submit(graphs[picks[j]])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        check(not th.is_alive(), "microbatch: a client thread hung")
    results = [s.result(timeout=300) for s in subs]
    wall = time.perf_counter() - t0
    mb.close(timeout=120)
    check(not mb._thread.is_alive(), "microbatch: the worker did not stop")
    for j, (i, r) in enumerate(zip(picks, results)):
        check(_same_fit(r, solo[i]) and r.device.startswith("cuda"),
              f"microbatch: submission {j} (member {i}) != its solo fit")
    check(sum(mb.batch_sizes) == len(picks)
          and max(mb.batch_sizes) <= 8, f"microbatch: batches "
          f"{mb.batch_sizes}")
    return {"submissions": len(picks), "threads": 4, "max_batch": 8,
            "batch_sizes": mb.batch_sizes, "wall_s": wall, **mb.stats()}


# ------------------------------------------------------------------- obs

def _same_phase(a, b, cols=("sweep", "active", "changed")) -> bool:
    return (a is None) == (b is None) and (a is None or all(
        np.array_equal(getattr(a, c), getattr(b, c)) for c in cols))


def _same_profile(a, b) -> bool:
    return a.n == b.n and _same_phase(a.propagation, b.propagation) \
        and _same_phase(a.split, b.split)


def phase_obs(torch, rt, dev, g, fused, graphs_a, graphs_b):
    """repro_torch.obs on the card: convergence profiles carried through
    the four LPA kernels (profiled fits equal main's unprofiled fits; the
    curves agree across fusion, backends, the CPU and fit_many), quality
    reports, spans against the host wall, the Chrome trace and the
    Prometheus text.  Launch counts are reset just before the two
    profiled main-graph fits and read just after."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.obs import (REGISTRY, TRACER, parse_prometheus_text,
                                 prometheus_text)
    out = {}

    def engine(**kw):
        return Engine(EngineConfig(split="lp", **kw), cache=PlanCache())

    # the main graph, profile="full", fused and unfused
    prof_f = engine(backend="tile", profile="full")
    prof_u = engine(backend="tile", fuse_sweeps="off", profile="full")
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    rf, wall_f = _wall(torch, lambda: prof_f.fit(g))
    launches_f = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    ru, wall_u = _wall(torch, lambda: prof_u.fit(g))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"obs: {name} was not launched by the profiled fits")
    for tag, r in (("fused", rf), ("unfused", ru)):
        check(_same_fit(r, fused), f"obs: the profiled {tag} fit differs "
              f"from main's unprofiled fits")
        check(r.profile.propagation.num_sub_sweeps
              == 2 * r.lpa_iterations, f"obs: {tag} propagation rows "
              f"{r.profile.propagation.num_sub_sweeps} != 2 x "
              f"{r.lpa_iterations}")
        check(r.profile.split is not None and not r.profile.split.truncated
              and r.profile.split.num_sub_sweeps == r.split_iterations,
              f"obs: {tag} split curve")
    check(_same_phase(rf.profile.propagation, ru.profile.propagation),
          "obs: fused and unfused propagation curves differ")
    check(_same_phase(rf.profile.split, ru.profile.split,
                      ("sweep", "changed")),
          "obs: fused and unfused split changed columns differ")
    # walls, plans warm: profiled and unprofiled fused fits, in turns
    plain = engine(backend="tile")
    plain.fit(g)
    walls = {"profiled": [], "unprofiled": []}
    prop = {"profiled": [], "unprofiled": []}
    for _ in range(3):
        for tag, eng in (("profiled", prof_f), ("unprofiled", plain)):
            r, wall = _wall(torch, lambda eng=eng: eng.fit(g))
            walls[tag].append(wall)
            prop[tag].append(r.timings["propagation"] + r.timings["split"])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    med_dev = {k: float(np.median(v)) for k, v in prop.items()}
    snap = REGISTRY.snapshot()
    fits = {tag: snap[f"{eng._obs.label}.fits"]
            for tag, eng in (("profiled", prof_f), ("unprofiled", plain))}
    check(fits == {"profiled": 4, "unprofiled": 4},
          f"obs: engine fits counters {fits}, want 4 each")
    # a profile row's count against Tensor.sum() (the unprofiled loop's
    # changed count), on a mask of the bucket's rows
    from repro_torch.obs.convergence import count_true
    mask = torch.rand(fused.bucket[0], device=dev) < 0.5
    want = int(mask.sum())
    check(int(count_true(mask)) == want, "obs: count_true")
    count_ms = {"rows": mask.numel(),
                "sum_ms": _time_ms(torch, mask.sum),
                "count_true_ms": _time_ms(torch, lambda: count_true(mask))}
    del mask
    out["main"] = {
        "graph": "grid2d(3500)", "profile": "full", "split": "lp",
        "first_fit_wall_s": {"fused": wall_f, "unfused": wall_u},
        "launches_fused_fit": launches_f,
        "launches_unfused_fit": {k: launches[k] - launches_f[k]
                                 for k in launches},
        "propagation": rf.profile.propagation.to_dict(),
        "split_fused": rf.profile.split.to_dict(),
        "split_unfused_active": ru.profile.split.active.tolist(),
        "wall_s_median_of_3": med, "walls_s": walls,
        "propagation_plus_split_s_median_of_3": med_dev,
        "profile_overhead_share": med["profiled"] / med["unprofiled"] - 1,
        "profile_overhead_share_of_device_stages":
            med_dev["profiled"] / med_dev["unprofiled"] - 1,
        "engine_fits_counters": fits, "bool_count": count_ms}

    # one traffic-B member: three backends on the card, segment on the CPU
    pp = graphs_b[0]
    fits_b = {}
    for tag, kw in (("tile_fused", dict(backend="tile")),
                    ("tile_unfused", dict(backend="tile",
                                          fuse_sweeps="off")),
                    ("segment", dict(backend="segment")),
                    ("segment_cpu", dict(backend="segment", device="cpu"))):
        fits_b[tag] = engine(profile="full", **kw).fit(pp)
    for tag, r in fits_b.items():
        check(_same_fit(r, fits_b["segment_cpu"])
              and _same_phase(r.profile.propagation,
                              fits_b["segment_cpu"].profile.propagation),
              f"obs: {tag} propagation curve != the CPU segment fit's")
    out["backends"] = {
        "graph": "planted_partition(32, 512, 0.04, 0.0005, seed=0)",
        "devices": {k: r.device for k, r in fits_b.items()},
        "propagation_active": fits_b["segment_cpu"].profile.propagation
        .active.tolist(),
        "split_changed": {k: r.profile.split.changed.tolist()
                          for k, r in fits_b.items()}}

    # traffic A: fit_many profiled, members against their solo fits
    eng_a = engine(backend="tile", profile="full")
    res_a, wall_a = _wall(torch, lambda: eng_a.fit_many(graphs_a))
    for i in OBS_MEMBERS:
        solo = eng_a.fit(graphs_a[i])
        check(_same_fit(res_a[i], solo)
              and _same_profile(res_a[i].profile, solo.profile),
              f"obs: traffic A member {i}'s curves != its solo fit's")
    out["traffic_a"] = {"fit_many_wall_s": wall_a,
                        "members_checked": list(OBS_MEMBERS),
                        "lpa_iterations": [res_a[i].lpa_iterations
                                           for i in OBS_MEMBERS]}

    # quality reports on the main graph
    metric = engine(backend="tile", compute_metrics=True).fit(g)
    quality = {}
    for mode in ("full", "basic"):
        eng = engine(backend="tile", quality=mode)
        TRACER.reset()
        r, wall = _wall(torch, lambda eng=eng: eng.fit(g))
        check(_same_fit(r, fused), f"obs: quality={mode} labels differ")
        q = r.quality
        (qs,) = TRACER.spans("engine.quality")
        quality[mode] = {"engine_quality_s": qs.dur, "wall_s": wall,
                         "report": q.to_dict()}
        if mode == "full":
            check(q.disconnected_fraction == 0.0,
                  f"obs: disconnected fraction {q.disconnected_fraction}")
            check(q.modularity == metric.modularity,
                  f"obs: quality modularity {q.modularity} != "
                  f"compute_metrics' {metric.modularity}")
        else:
            check(q.modularity is None and q.disconnected_fraction is None,
                  "obs: basic quality made a device pass")
    quality["compute_metrics_modularity"] = metric.modularity
    out["quality"] = quality

    # spans against the host wall, the Chrome trace, the Prometheus text
    eng = engine(backend="tile")
    eng.fit(g)
    TRACER.reset()
    r, wall = _wall(torch, lambda: eng.fit(g))
    names = {s.name for s in TRACER.spans("engine.")}
    need = {"engine.fit", "engine.prepare", "engine.dispatch",
            "engine.compact"}
    check(need <= names, f"obs: spans {sorted(names)}")
    spans = {s.name: s.dur for s in TRACER.spans("engine.")}
    trace_path = Path(__file__).resolve().parent / "build" / "obs_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    n_events = TRACER.export_chrome(trace_path)
    events = json.loads(trace_path.read_text())
    check(len(events) == n_events >= 4, "obs: the Chrome trace")
    parsed = parse_prometheus_text(prometheus_text())
    label = eng._obs.label
    snap = REGISTRY.snapshot()
    check(snap[f"{label}.fits"] == 2, f"obs: {label}.fits = "
          f"{snap[f'{label}.fits']}, want 2")
    out["spans"] = {
        "engine_fit_span_s": spans["engine.fit"], "host_wall_s": wall,
        "span_over_wall": spans["engine.fit"] / wall,
        "stage_spans_s": spans, "timings_s": r.timings,
        "chrome_trace": str(trace_path.relative_to(
            Path(__file__).resolve().parent)), "trace_events": n_events,
        "prometheus_metrics": len(parsed),
        "engine_names": sorted({k.split(".", 1)[1] for k in snap
                                if k.startswith("engine")})}
    return launches, out


# ---------------------------------------------------------------- stream

def _road_delta(rng, graph, used_cells, side, k):
    """One road edit: ``k`` random existing undirected edges deleted and
    ``k`` diagonals (i, j)-(i+1, j+1) inserted, a shape the 4-neighbour
    lattice never has; a diagonal is inserted once per run."""
    from repro_torch.core.delta import GraphDelta
    m = graph.num_edges
    src, dst = graph.src.numpy()[:m], graph.dst.numpy()[:m]
    idx = rng.integers(0, m, size=4 * k)
    idx = idx[src[idx] < dst[idx]]
    dels = np.unique(np.stack([src[idx], dst[idx]], axis=1), axis=0)
    dels = dels[rng.permutation(len(dels))[:k]]
    cells = np.setdiff1d(rng.integers(0, (side - 1) ** 2, size=3 * k),
                         used_cells)
    cells = cells[rng.permutation(len(cells))[:k]]
    check(len(dels) == k and len(cells) == k, "stream: short road delta")
    i, j = cells // (side - 1), cells % (side - 1)
    ins = np.stack([i * side + j, (i + 1) * side + j + 1], axis=1)
    return GraphDelta.make(insert=ins, delete=dels), \
        np.union1d(used_cells, cells)


def _fit_line(res, wall, launches, **extra):
    """The printed line of one road fit (a session update's member or a
    solo fit)."""
    return {"propagation_s": res.lpa_seconds, "split_s": res.split_seconds,
            "compact_s": res.timings["compact"], "timings_s": res.timings,
            "wall_s": wall, "lpa_iterations": res.lpa_iterations,
            "split_iterations": res.split_iterations,
            "communities": res.num_communities,
            "launches": {k: launches[k] for k in ("fused_move",
                                                  "fused_split")},
            **extra}


def _launched(torch, rt, fn):
    """``fn()`` with its wall time and the LPA kernels' launches (reset
    just before, read just after)."""
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    out, wall = _wall(torch, fn)
    return out, wall, {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}


def _same_graph(a, b) -> bool:
    from repro_torch.core.graph import graph_fingerprint
    return ((a.n, a.m_pad, a.num_edges) == (b.n, b.m_pad, b.num_edges)
            and all(_tensors_equal(getattr(a, f), getattr(b, f))
                    for f in GRAPH_FIELDS)
            and graph_fingerprint(a) == graph_fingerprint(b))


def _tensors_equal(x, y) -> bool:
    return x.dtype == y.dtype and x.shape == y.shape \
        and bool((x.cpu() == y.cpu()).all())


def _frontier_sweep(torch, rt, post, rows, d, prev, front, dev):
    """B3 on the first sub-sweep of a warm fit of ``post`` (labels ``prev``,
    the frontier active, nothing changed yet, the first sweep's class) and
    B4 on its split's first sweep: exact against the plain versions,
    timed, with their bounds."""
    from repro_torch.kernels.ref import label_hash
    t = _timing_tiles(torch, post, rows, d, prev, dev)
    active = torch.zeros(rows, dtype=torch.bool, device=dev)
    active[: post.n] = torch.from_numpy(front).to(dev)
    t.update(active=active, chg=torch.zeros_like(active),
             klass=~(label_hash(t["ids"], -1) & 1).bool())
    b3 = _kernel_row(torch, "fused_move", t,
                     lambda: rt.ops.fused_move(*_move_args(t), 0),
                     lambda: _plain_rows(torch, rt.ref, "fused_move", t, 0),
                     2, _argmax_work(torch, t, "fused_move"))[1]
    b3["frontier_rows"] = int(front.sum())
    return {"fused_move": b3, **_time_split(torch, rt, t, plain_reps=2)}


def _road_stream(torch, rt, dev, g, fused):
    """grid2d(3500) under three rounds of road edits through
    StreamSession.update (tile fused, warm with the frontier), each equal
    to the solo warm fit on the card, with a cold fit beside it."""
    from repro_torch.core.delta import affected_frontier, apply_delta
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.launch.stream import StreamSession
    side = ROAD_SIDE
    cfg = dict(backend="tile", split="lp")
    t0 = time.perf_counter()
    base = g.to("cpu")
    download_s = time.perf_counter() - t0
    solo_eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    rng = np.random.default_rng(0)
    used = np.zeros(0, np.int64)
    rounds, total = [], dict.fromkeys(LPA_KERNELS, 0)
    with StreamSession(Engine(EngineConfig(**cfg), cache=PlanCache()),
                       max_batch=1, batch_timeout_ms=0.0) as sess:
        first, add_wall = _wall(torch, lambda: sess.add("road", base))
        check(_same_fit(first, fused), "stream: the session's first fit != "
              "the main phase's fused tile fit")
        for r in range(ROAD_ROUNDS):
            before, prev = sess.graph("road"), sess.labels("road")
            t0 = time.perf_counter()
            delta, used = _road_delta(rng, before, used, side,
                                      ROAD_DELTA_EDGES)
            delta_s = time.perf_counter() - t0
            front = affected_frontier(delta, before.n)
            res, wall, launches = _launched(
                torch, rt, lambda: sess.update("road", delta))
            for k in LPA_KERNELS:
                total[k] += launches[k]
            post = sess.graph("road")
            splice_s = sess.streams["road"].splice_seconds
            post_dev, upload_s = _wall(torch, lambda: post.to(dev))
            solo, solo_wall, solo_launches = _launched(
                torch, rt, lambda: solo_eng.fit(post, init_labels=prev,
                                                init_active=front))
            check(res.warm_started and _same_fit(res, solo),
                  f"stream road round {r}: the update != the solo warm fit")
            frac = res.check_connected(post_dev)
            check(frac == 0.0, f"stream road round {r}: disconnected "
                  f"fraction {frac}")
            cold, cold_wall, cold_launches = _launched(
                torch, rt, lambda: solo_eng.fit(post))
            row = {"round": r, "delta_build_s": delta_s,
                   "insertions": delta.num_insertions,
                   "deletions": delta.num_deletions,
                   "frontier_share": float(front.sum()) / post.n,
                   "splice_s": splice_s, "upload_s": upload_s,
                   "update": _fit_line(res, wall, launches,
                                       fit_s=wall - splice_s),
                   "solo_warm": _fit_line(solo, solo_wall, solo_launches),
                   "cold": _fit_line(cold, cold_wall, cold_launches),
                   "disconnected_fraction": frac}
            if r == 0:
                rebuilt, rebuild_s = _wall(torch,
                                           lambda: apply_delta(before, delta))
                check(_same_graph(rebuilt, post), "stream: the patched graph "
                      "!= apply_delta's rebuild")
                row.update(rebuild_s=rebuild_s, patch_equals_rebuild=True)
                del rebuilt
                row["kernels_first_sweep"] = _frontier_sweep(
                    torch, rt, post_dev, solo.bucket[0], solo.bucket[2],
                    prev, front, dev)
            rounds.append(row)
            del post_dev
        stats = sess.stats()
    check(stats["updates"] == stats["warm_updates"] == ROAD_ROUNDS,
          f"stream road: {stats}")
    for k in ("fused_move", "fused_split"):
        check(total[k] > 0, f"stream road: {k} was not launched")
    return total, {
        "graph": "grid2d(3500)", "n": base.n,
        "directed_edges": base.num_edges,
        "delta": f"{ROAD_DELTA_EDGES} random existing edges deleted, "
                 f"{ROAD_DELTA_EDGES} diagonals inserted, seed 0",
        "backend": "tile fused", "split": "lp",
        "download_base_s": download_s, "session_first_fit_wall_s": add_wall,
        "rounds": rounds, "launches": total}


def _batched_streams(torch, rt):
    """8 planted_partition streams, 3 rounds of evolving_sequence deltas,
    through one StreamSession(max_batch=8).update_many, warm and cold;
    each member equals its solo fit."""
    from repro_torch.core.delta import affected_frontier, apply_delta
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import evolving_sequence, planted_partition
    from repro_torch.launch.stream import StreamSession
    t0 = time.perf_counter()
    traces = [evolving_sequence(0, 0.0, rounds=3, delta_edges=256,
                                seed=100 + s,
                                base=planted_partition(32, 512, 0.04, 0.0005,
                                                       seed=s)[0])
              for s in range(8)]
    build_s = time.perf_counter() - t0
    solo = Engine(EngineConfig(split="lp"), cache=PlanCache())
    out = {"members": "planted_partition(32, 512, 0.04, 0.0005, seed=s), "
                      "s = 0..7; evolving_sequence(rounds=3, "
                      "delta_edges=256, seed=100 + s)",
           "trace_build_s": build_s}
    for warm in (True, False):
        eng = Engine(EngineConfig(split="lp"), cache=PlanCache())
        walls, splices, stages, backends = [], [], [], set()
        with StreamSession(eng, warm=warm, max_batch=8,
                           batch_timeout_ms=20.0) as sess:
            res0 = sess.add_many({s: b for s, (b, _) in enumerate(traces)})
            graphs = {s: b for s, (b, _) in enumerate(traces)}
            prev = {s: r.labels for s, r in res0.items()}
            for r in range(3):
                deltas = {s: ds[r] for s, (_, ds) in enumerate(traces)}
                res, wall = _wall(torch, lambda: sess.update_many(deltas))
                walls.append(wall)
                splices.append(sum(sess.streams[s].splice_seconds
                                   for s in deltas))
                stages.append({k: sum(x.timings[k] for x in res.values())
                               for k in res[0].timings})
                for s, d in deltas.items():
                    graphs[s] = apply_delta(graphs[s], d)
                    kw = dict(init_labels=prev[s], init_active=
                              affected_frontier(d, graphs[s].n)) \
                        if warm else {}
                    want = solo.fit(graphs[s], **kw)
                    check(_same_fit(res[s], want) and res[s].warm_started
                          == warm, f"stream batched warm={warm} round {r}: "
                          f"member {s} != its solo fit")
                    backends.add(res[s].backend)
                    prev[s] = res[s].labels
            stats = sess.stats()
        check(stats["updates"] == 24 and stats["warm_updates"]
              == (24 if warm else 0), f"stream batched: {stats}")
        out["warm" if warm else "cold_replay"] = {
            "update_many_wall_s": walls, "wall_sum_s": sum(walls),
            "splice_sum_s": splices, "fit_many_stage_s": stages,
            "backends": sorted(backends),
            "mean_frontier_share": stats["mean_frontier_frac"],
            "batch_size_hist": stats["batch_size_hist"],
            "updates": stats["updates"],
            "warm_updates": stats["warm_updates"]}
    return out


def _warm_auto(torch):
    """warm_start='auto': a second fit of a graph is warm and equals the
    fit from the first's labels; the cache holds one entry per structure
    and stays at its bound over warm_cache_size + 1 graphs."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import erdos_renyi, planted_partition
    g = planted_partition(32, 512, 0.04, 0.0005, seed=0)[0]
    eng = Engine(EngineConfig(split="lp", warm_start="auto"),
                 cache=PlanCache())
    first, second = eng.fit(g), eng.fit(g)
    want = Engine(EngineConfig(split="lp"), cache=PlanCache()).fit(
        g, init_labels=first.labels)
    check(not first.warm_started and second.warm_started
          and _same_fit(second, want), "stream: auto warm start != the fit "
          "from the first fit's labels")
    check(eng.stats()["warm_entries"] == 1, f"stream: {eng.stats()}")
    cap = eng.config.warm_cache_size
    for i in range(cap + 1):
        eng.fit(erdos_renyi(300 + i, 4.0, seed=i))
        check(eng.stats()["warm_entries"] <= cap, "stream: the warm cache "
              "grew past its bound")
    st = eng.stats()
    check(st["warm_entries"] == cap and st["warm_evictions"] == 2
          and not eng.fit(g).warm_started, f"stream: warm cache {st}")
    return {"graph": "planted_partition(32, 512, 0.04, 0.0005, seed=0)",
            "second_fit_warm": True, "lpa_iterations_cold_warm":
                [first.lpa_iterations, second.lpa_iterations],
            "distinct_graphs": cap + 2, "warm_cache": st}


def phase_stream(torch, rt, dev, g, fused):
    launches, road = _road_stream(torch, rt, dev, g, fused)
    return launches, {"road": road, "batched": _batched_streams(torch, rt),
                      "warm_auto": _warm_auto(torch)}


# ---------------------------------------------------------------- ingest

def _mapped_ranges(path: Path) -> list[tuple[int, int]]:
    out = []
    with open("/proc/self/maps") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 6 and parts[5] == str(path):
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                out.append((lo, hi))
    return out


def phase_ingest(torch, dev, tmp: Path):
    """grid2d(INGEST_SIDE) written as MatrixMarket into ``tmp``, ingested
    by the CLI in a subprocess (--stats --detect, on the card), then loaded in
    process twice (parse, store hit) and fitted from its path, cold and
    warm.  Returns the file, the in-core fit(path), its wall and the
    phase's line (the ooc phase reuses the file, the fit and the store in
    ``tmp``)."""
    import os

    from repro_torch.core.delta import undirected_edges
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import grid2d
    from repro_torch.io import load_graph, write_mtx
    old_store = os.environ.get("REPRO_GRAPH_CACHE")
    try:
        g = grid2d(INGEST_SIDE)
        path = tmp / f"grid2d_{INGEST_SIDE}.mtx"
        t0 = time.perf_counter()
        write_mtx(path, undirected_edges(g)[0], n=g.n, symmetric=True)
        write_s = time.perf_counter() - t0
        env = {**os.environ, "REPRO_GRAPH_CACHE": str(tmp / "cli_store"),
               "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.ingest", str(path),
             "--stats", "--detect"], capture_output=True, text=True,
            env=env, timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"ingest CLI exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        check("detect[" in cli.stdout and "cuda" in cli.stdout,
              f"ingest CLI did not detect on the card: {cli.stdout[-2000:]}")

        os.environ["REPRO_GRAPH_CACHE"] = str(tmp / "store")
        g1, rep1 = load_graph(path, return_report=True)
        g2, rep2 = load_graph(path, return_report=True)
        check(not rep1.cache_hit and rep2.cache_hit
              and rep2.parse_seconds == 0.0, "ingest: the second load was "
              "not a store hit")
        for name, h in (("parsed", g1), ("stored", g2)):
            check(_same_graph(g, h), f"ingest: the {name} graph != grid2d")
        ranges = _mapped_ranges((tmp / "store" / rep2.key
                                 / "arrays.bin").resolve())
        copied = not all(any(lo <= getattr(g2, f).data_ptr() < hi
                             for lo, hi in ranges) for f in GRAPH_FIELDS)
        check(not copied, "ingest: the store hit copied its arrays")
        g_dev, upload_s = _wall(torch, lambda: g2.to(dev))
        del g_dev

        want, want_wall = _wall(torch, lambda: Engine(
            cache=PlanCache()).fit(g))
        got, got_wall = _wall(torch, lambda: Engine(
            cache=PlanCache()).fit(str(path)))
        check(got.device.startswith("cuda"), "ingest: fit(path) did not "
              "run on the card")
        check(_same_fit(got, want), "ingest: Engine().fit(path) != "
              "Engine().fit(grid2d)")
        eng = Engine(EngineConfig(warm_start="auto"), cache=PlanCache())
        a, b = eng.fit(str(path)), eng.fit(str(path))
        warm_want = Engine(cache=PlanCache()).fit(g, init_labels=a.labels)
        check(not a.warm_started and b.warm_started
              and _same_fit(b, warm_want), "ingest: the second fit(path) "
              "was not warm through the stored fingerprint")
        return path, got, got_wall, {
            "graph": f"grid2d({INGEST_SIDE})", "n": g.n,
            "undirected_edges": g.num_edges // 2,
            "file_bytes": path.stat().st_size, "write_s": write_s,
            "cli_s": cli_s, "cli_stdout": cli.stdout.splitlines()[-6:],
            "parse_s": rep1.parse_seconds,
            "preprocess_s": rep1.preprocess_seconds,
            "build_s": rep1.build_seconds, "store_write_s": rep1.save_seconds,
            "hash_s": rep1.hash_seconds,
            "repeat_load_s": rep2.load_seconds,
            "repeat_hash_s": rep2.hash_seconds, "repeat_load_copied": copied,
            "upload_from_store_s": upload_s,
            "fit_from_path": {"backend": got.backend, "wall_s": got_wall,
                              "timings_s": got.timings,
                              "lpa_iterations": got.lpa_iterations,
                              "split_iterations": got.split_iterations,
                              "communities": got.num_communities},
            "fit_generated_wall_s": want_wall,
            "warm_second_fit": {"lpa_iterations": b.lpa_iterations,
                                "timings_s": b.timings}}
    finally:
        _restore_env("REPRO_GRAPH_CACHE", old_store)


def _restore_env(name: str, value: str | None) -> None:
    import os
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


# ---------------------------------------------------------------- ooc

def _ooc_line(res, wall, launches, incore_wall):
    """The printed line of one out-of-core fit."""
    o = res.ooc
    return {"partitions": res.partitions, "budget": o["budget"],
            "peak_resident_bytes": o["peak_resident_bytes"],
            "partition_loads": o["partition_loads"],
            "prefetches": o["prefetches"],
            "prefetch_hits": o["prefetch_hits"],
            "halo_cache_hits": o["halo_cache_hits"],
            "halo_cache_bytes_saved": o["halo_cache_bytes_saved"],
            "exchange_bytes": o["exchange_bytes"],
            "halo_vertices": o["halo_vertices"],
            "plan_s": res.timings["prepare"],
            "propagation_s": res.timings["propagation"],
            "split_s": res.timings["split"],
            "compact_s": res.timings["compact"],
            "load_wait_s": o["load_wait_seconds"], "wall_s": wall,
            "in_core_wall_s": incore_wall,
            "wall_over_in_core": wall / incore_wall,
            "lpa_iterations": res.lpa_iterations,
            "split_iterations": res.split_iterations,
            "communities": res.num_communities,
            "launches": launches}


def _ooc_launch_check(launches, res, fused: bool) -> None:
    """One launch of the move and of the split kernel per partition visit,
    none of the other pair."""
    move, split = (("fused_move", "fused_split") if fused
                   else ("label_argmax", "min_label"))
    other = set(LPA_KERNELS) - {move, split}
    p = res.partitions
    check(launches[move] == p * 2 * res.lpa_iterations
          and launches[split] == p * res.split_iterations
          and not any(launches[k] for k in other),
          f"ooc: launches {launches} are not one {move} per partition "
          f"visit ({p} x {2 * res.lpa_iterations}) and one {split} per "
          f"split visit ({p} x {res.split_iterations})")


def phase_ooc(torch, rt, dev, g, main_fused, main_res, path, path_fit,
              path_wall, tmp: Path):
    """Out-of-core fits on the card (A9).

    (a) grid2d(3500) under a budget of 3/4 of its in-core edge bytes
    (13 B per slot), tile fused and unfused, launch counts reset just
    before and read just after each: equal to main's in-core fits (labels,
    both iteration counts), no disconnected community, peak within the
    budget, B3 / B4 (fused) or B1 / B2 (unfused) once per partition visit.
    (b) The fused fit again with the prefetch worker off and
    profile="full": the labels of (a)'s fused fit (prefetch on), and the
    propagation curve of an in-core profiled fused fit.  (c) A real-weight
    segment fit out of core against the in-core segment fit.  (d) The
    ingest phase's file: the CLI with --ooc in a subprocess, and
    Engine().fit(path, memory_budget=...) in process with
    EntryHandle.to_graph disabled (windows only), both equal to the
    in-core fit(path).
    """
    import os

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import weighted_planted_partition
    from repro_torch.io.store import EntryHandle
    from repro_torch.partition.ooc import (
        IN_CORE_EDGE_BYTES,
        fit_out_of_core,
        open_source,
    )
    g_host = g.to("cpu")
    in_core = g.m_pad * IN_CORE_EDGE_BYTES
    budget = in_core * 3 // 4
    # in-core walls with plans built, beside main's cold ones
    warm = {}
    for name, fuse in (("fused", "auto"), ("unfused", "off")):
        eng = Engine(EngineConfig(backend="tile", split="lp",
                                  fuse_sweeps=fuse), cache=PlanCache())
        eng.fit(g)
        warm[name] = _wall(torch, lambda: eng.fit(g))[1]
    lines = {"in_core_warm_wall_s": warm}

    def road_fit(fuse):
        eng = Engine(EngineConfig(backend="tile", split="lp",
                                  fuse_sweeps=fuse), cache=PlanCache())
        return _launched(torch, rt, lambda: eng.fit(
            g_host, memory_budget=budget))

    for fuse in ("auto", "off"):
        res, wall, launches = road_fit(fuse)
        name = "fused" if fuse == "auto" else "unfused"
        # main's fused and unfused in-core fits are equal (phase main)
        check(_same_fit(res, main_fused), f"ooc: the {name} road fit != "
              f"main's in-core fit")
        check(4 <= res.partitions <= 16, f"ooc: {res.partitions} "
              f"partitions, not 4 to 16")
        check(res.ooc["peak_resident_bytes"] <= budget,
              f"ooc: peak {res.ooc['peak_resident_bytes']} > {budget}")
        check(res.device.startswith("cuda"), "ooc: not on the card")
        _ooc_launch_check(launches, res, fused=fuse == "auto")
        lines[name] = {**_ooc_line(res, wall, launches,
                                   main_res[name]["wall_s"]),
                       "wall_over_in_core_warm": wall / warm[name]}
        if fuse == "auto":
            fused = res
    frac = fused.check_connected(g)
    check(frac == 0.0, f"ooc: disconnected fraction {frac}")

    # prefetch off + profiled: fused's labels, the in-core curve
    cfg = EngineConfig(backend="tile", split="lp", profile="full")
    run, wall, launches = _launched(torch, rt, lambda: fit_out_of_core(
        open_source(g_host), cfg, memory_budget=budget, prefetch=False))
    labels = np.unique(run.labels, return_inverse=True)[1]
    check(np.array_equal(labels, fused.labels)
          and (run.lpa_iterations, run.split_iterations)
          == (fused.lpa_iterations, fused.split_iterations)
          and run.prefetches == 0, "ooc: prefetch off != prefetch on")
    check(run.peak_resident_bytes <= budget, "ooc: peak over the budget")
    incore_prof = Engine(cfg, cache=PlanCache()).fit(g)
    check(_same_phase(run.profile.propagation,
                      incore_prof.profile.propagation),
          "ooc: the profiled propagation curve != the in-core curve")
    lines["fused_prefetch_off_profiled"] = {
        "partitions": run.num_partitions, "wall_s": wall,
        "plan_s": run.plan_seconds, "propagation_s": run.lpa_seconds,
        "split_s": run.split_seconds, "prefetches": run.prefetches,
        "load_wait_s": run.load_wait_seconds,
        "peak_resident_bytes": run.peak_resident_bytes,
        "partition_loads": run.partition_loads,
        "halo_cache_hits": run.halo_cache_hits, "launches": launches,
        "propagation_rows": run.profile.propagation.num_sub_sweeps}
    del g_host, run, labels

    # the segment path, real weights
    gw = weighted_planted_partition(40, 500, 0.05, 0.001, seed=3)
    seg = Engine(EngineConfig(backend="segment", split="lp"),
                 cache=PlanCache())
    want, want_wall = _wall(torch, lambda: seg.fit(gw))
    seg_budget = gw.m_pad * IN_CORE_EDGE_BYTES // 3
    res, wall = _wall(torch, lambda: seg.fit(gw, memory_budget=seg_budget))
    check(res.partitions > 1 and _same_fit(res, want)
          and res.backend == "segment", "ooc: the segment fit != in core")
    lines["segment"] = {"graph": "weighted_planted_partition(40, 500, "
                        "0.05, 0.001, seed=3)", "n": gw.n,
                        **_ooc_line(res, wall, {}, want_wall)}

    # from the store: the CLI and fit(path), windows only
    old_store = os.environ.get("REPRO_GRAPH_CACHE")
    os.environ["REPRO_GRAPH_CACHE"] = str(tmp / "store")
    try:
        src = open_source(str(path))
        path_fit_budget = src.m_pad * IN_CORE_EDGE_BYTES * 3 // 4
        handle_budget = str(path_fit_budget)
        report = tmp / "ooc_report.json"
        env = {**os.environ,
               "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.ingest", str(path),
             "--ooc", "--memory-budget", handle_budget, "--json",
             str(report)], capture_output=True, text=True, env=env,
            timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"ingest --ooc exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        rep = json.loads(report.read_text())[0]["ooc"]
        check(rep["partitions"] > 1
              and rep["peak_resident_bytes"] <= path_fit_budget
              and rep["communities"] == path_fit.num_communities
              and (rep["lpa_iterations"], rep["split_iterations"])
              == (path_fit.lpa_iterations, path_fit.split_iterations),
              f"ingest --ooc != the in-core fit(path): {rep}")
        to_graph = EntryHandle.to_graph

        def windows_only(self):
            raise AssertionError("the out-of-core path built the graph")

        EntryHandle.to_graph = windows_only
        try:
            res, wall = _wall(torch, lambda: Engine(cache=PlanCache()).fit(
                str(path), memory_budget=path_fit_budget))
        finally:
            EntryHandle.to_graph = to_graph
        check(res.partitions > 1 and _same_fit(res, path_fit),
              "ooc: fit(path) out of core != the in-core fit(path)")
    finally:
        _restore_env("REPRO_GRAPH_CACHE", old_store)
    lines["store"] = {
        "graph": f"grid2d({INGEST_SIDE}) from its .mtx store entry",
        "cli_s": cli_s, "cli_stdout": cli.stdout.splitlines()[-2:],
        "cli_report": {k: rep[k] for k in (
            "backend", "partitions", "budget", "peak_resident_bytes",
            "partition_loads", "prefetch_hits", "plan_seconds",
            "lpa_seconds", "split_seconds")},
        **_ooc_line(res, wall, {}, path_wall)}
    return {"graph": "grid2d(3500)", "in_core_edge_bytes": in_core,
            "budget": budget, **lines}


# ----------------------------------------------------------------- serve

def _serve_trace(load: dict, i: int):
    """Tenant i's evolving trace under ``LoadConfig(**load)`` as host
    arrays and deltas (a worker process's job; the parent rebuilds the
    Graph)."""
    src = str(Path(__file__).resolve().parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.serve.loadgen import LoadConfig, tenant_trace
    name, (base, deltas) = tenant_trace(LoadConfig(**load), i)
    return (name, base.n, base.num_edges,
            [getattr(base, f).numpy() for f in GRAPH_FIELDS], deltas)


def _serve_traces(load):
    """``build_traces(load)``, generated in parallel worker processes."""
    import dataclasses
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core.graph import graph_from_arrays
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = list(ex.map(_serve_trace,
                            [dataclasses.asdict(load)] * load.tenants,
                            range(load.tenants)))
    return {name: (graph_from_arrays(n, m, *arrays), deltas)
            for name, n, m, arrays, deltas in parts}, workers


def _serve_run(rt, eng, traces, budget, load):
    """One run of the load through a TenantService on ``eng``; launch
    counts and spans reset just before ``run_load`` and read just after.
    Returns the service (open) and the run's line: the summary, the
    launches and the host seconds inside each span (SERVE_SPANS) summed
    over the run."""
    from repro_torch.obs import TRACER
    from repro_torch.serve import ServiceConfig, TenantService
    from repro_torch.serve.loadgen import run_load
    svc = TenantService(eng, ServiceConfig(
        queue_capacity=16, max_batch=8, warm_budget=budget))
    try:
        TRACER.reset()
        rt.ops.reset_launches()
        _, summary = run_load(svc, traces, load)
        launches = dict(rt.ops.LAUNCHES)
        span_s = {name: sum(x.dur for x in TRACER.spans(name)
                            if x.name == name) for name in SERVE_SPANS}
        stats = svc.stats()
        lasts = [tl["last"] for tl in stats["health"]["tenants"].values()]
        check(summary["requests"] == SERVE_TENANTS * (1 + SERVE_ROUNDS)
              and summary["stranded"] == 0 and summary["failed"] == 0
              and summary["errors"] == 0 and summary["give_ups"] == 0
              and summary["outstanding"] == 0,
              f"serve: requests lost or failed under budget {budget}: "
              f"{summary}")
        check(len(lasts) == SERVE_TENANTS and all(
            s is not None and s["disconnected_fraction"] == 0.0
            for s in lasts), f"serve: a tenant's last fit has a "
            f"disconnected community (or no quality) under budget {budget}")
        check(summary["warm_bytes_peak"] <= budget, f"serve: warm bytes "
              f"peak {summary['warm_bytes_peak']} > {budget}")
    except BaseException:
        svc.close()
        raise
    line = {"warm_budget": budget, "launches": launches, "span_s": span_s,
            "fit_many_share_of_wall": span_s["engine.fit_many"]
            / summary["wall_s"],
            "batch_size_hist": stats["batcher"]["batch_size_hist"],
            "health_alerts": stats["health"]["alert_counts"],
            **{k: summary[k] for k in (
                "requests", "completed", "failed", "stranded", "rejections",
                "retries", "queue_depth_peak", "warm_bytes_peak", "spills",
                "wall_s", "edges_per_s", "p50_ms", "p99_ms", "mean_batch")}}
    return svc, line


def _serve_kernels(torch, rt, dev, cfg, graphs, labels):
    """The four LPA kernels on one served batch's packed tiles (as
    ``Engine.fit_many`` packs and buckets them under ``cfg``), with the
    members' labels: exact against their plain versions, timed, with
    their bounds."""
    from repro_torch.core.batch import GraphBatch
    from repro_torch.engine.bucketing import batch_bucket_for
    batch = GraphBatch.pack(graphs, device=dev)
    bucket = batch_bucket_for(batch, bucketing=cfg.bucketing,
                              min_vertex_bucket=cfg.min_vertex_bucket,
                              min_edge_bucket=cfg.min_edge_bucket)
    shift = np.repeat(batch.offsets[:-1], batch.sizes).astype(np.int32)
    t = _timing_tiles(torch, batch.graph, bucket.n, bucket.d,
                      np.concatenate(labels) + shift, dev)
    kern = _time_argmax(torch, rt, t, plain_reps=5)
    kern.update(_time_split(torch, rt, t, plain_reps=5))
    return {"members": len(graphs), "rows": bucket.n, "d": bucket.d,
            "real_cells": int(t["nmask"].sum()), **kern}


def phase_serve(torch, rt, dev):
    """The multi-tenant serving tier on the card (see the module doc)."""
    import dataclasses
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.launch.serve import serve_communities, serve_streaming
    from repro_torch.serve import ServiceConfig, TenantService
    from repro_torch.serve.loadgen import LoadConfig, replay_parity

    load = LoadConfig(tenants=SERVE_TENANTS, rounds=SERVE_ROUNDS,
                      size=SERVE_SIZE, delta_edges=SERVE_DELTA_EDGES,
                      refresh_every=3, parity_tenants=SERVE_PARITY,
                      client_threads=8, seed=7)
    t0 = time.perf_counter()
    # one round more than the load, for the restored parity tenants
    full, workers = _serve_traces(
        dataclasses.replace(load, rounds=SERVE_ROUNDS + 1))
    gen_s = time.perf_counter() - t0
    traces = {t: (b, d[:SERVE_ROUNDS]) for t, (b, d) in full.items()}
    parity = list(traces)[:SERVE_PARITY]
    eng_cfg = EngineConfig(backend="tile", quality="full")
    eng = Engine(eng_cfg, cache=PlanCache())
    out = {"tenants": SERVE_TENANTS, "size": SERVE_SIZE,
           "directed_edges": sum(b.num_edges for b, _ in traces.values()),
           "rounds": SERVE_ROUNDS, "trace_gen_s": gen_s,
           "trace_gen_workers": workers}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        # (a) every tenant's labels fit the budget
        svc, out["a"] = _serve_run(rt, eng, traces, SERVE_BUDGETS[0], load)
        try:
            check(out["a"]["spills"] == 0, f"serve (a): spills {out['a']}")
            final = {t: svc.labels(t) for t in traces}
            graphs = {t: svc.graph(t) for t in traces}
            t0 = time.perf_counter()
            saved = svc.snapshot(CheckpointManager(tmp))
            out["snapshot_s"] = time.perf_counter() - t0
        finally:
            svc.close()
        check(all(e["warm"] for e in saved["tenants"].values())
              and len(saved["tenants"]) == SERVE_TENANTS,
              "serve (a): the snapshot is not warm for every tenant")
        t0 = time.perf_counter()
        solo = replay_parity(traces, parity, eng_cfg)
        out["a"]["replay_parity_s"] = time.perf_counter() - t0
        for t in parity:
            check(final[t] is not None and np.array_equal(final[t], solo[t]),
                  f"serve (a): parity tenant {t} != its solo replay")
        launches = out["a"]["launches"]
        check(launches["fused_move"] > 0 and launches["fused_split"] > 0,
              f"serve (a): B3 / B4 not launched on the serving path: "
              f"{launches}")
        # the kernels at a served batch's shapes: max_batch tenants after
        # (a), packed as the batcher packs them, with their labels
        members = list(traces)[:8]
        out["a"]["kernels_served_shape"] = _serve_kernels(
            torch, rt, dev, eng_cfg, [graphs[t] for t in members],
            [final[t] for t in members])

        # (b) the same traces under a budget that holds 12 of 16 tenants
        svc, out["b"] = _serve_run(rt, eng, traces, SERVE_BUDGETS[1], load)
        svc.close()
        check(out["b"]["spills"] > 0, f"serve (b): no spill: {out['b']}")

        # (a) once more under torch.profiler (device activity only): the
        # device's busy share of the load's wall
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            svc, traced = _serve_run(rt, eng, traces, SERVE_BUDGETS[0],
                                     load)
            svc.close()
        events, busy_s = _device_busy(torch, prof)
        out["a_traced"] = {
            "device_events": events, "device_busy_s": busy_s,
            "device_idle_share": (1.0 - busy_s / traced["wall_s"])
            if events else None,
            **{k: traced[k] for k in ("wall_s", "p50_ms", "p99_ms",
                                      "launches", "span_s")}}

        # (c) restore (a)'s snapshot into a new service on a fresh engine,
        # then round SERVE_ROUNDS on the parity tenants
        eng_c = Engine(eng_cfg, cache=PlanCache())
        svc = TenantService(eng_c, ServiceConfig(
            queue_capacity=16, max_batch=8, warm_budget=SERVE_BUDGETS[0]))
        try:
            t0 = time.perf_counter()
            report = svc.restore(CheckpointManager(tmp), graphs)
            restore_s = time.perf_counter() - t0
            check(len(report["restored"]) == SERVE_TENANTS
                  and not report["mismatched"] and not report["cold"],
                  f"serve (c): restore report {report}")
            for t in traces:
                check(np.array_equal(svc.labels(t), final[t]),
                      f"serve (c): restored labels of {t} != (a)'s")
            t0 = time.perf_counter()
            tickets = {t: svc.update(t, full[t][1][SERVE_ROUNDS])
                       for t in parity}
            res = {t: k.result(timeout=600) for t, k in tickets.items()}
            update_s = time.perf_counter() - t0
            after = {t: svc.labels(t) for t in parity}
        finally:
            svc.close()
    solo4 = replay_parity(full, parity, eng_cfg)
    for t in parity:
        check(res[t].warm_started and np.array_equal(after[t], solo4[t]),
              f"serve (c): {t} after round {SERVE_ROUNDS} != its solo "
              "replay of every round")
    out["c"] = {"restored": len(report["restored"]),
                "mismatched": len(report["mismatched"]),
                "restore_s": restore_s, "parity_update_wall_s": update_s,
                "lpa_iterations": [res[t].lpa_iterations for t in parity]}

    # (d) the launch drivers at their defaults, then the CLI
    _, comm = serve_communities()
    _, strm = serve_streaming()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        jsonl = Path(d) / "metrics.jsonl"
        env = {**os.environ,
               "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "tenants", "--metrics-jsonl", str(jsonl)],
            capture_output=True, text=True, env=env, timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"serve CLI exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        tags = [json.loads(x)["tag"] for x in jsonl.read_text().splitlines()]
    check("(0 stranded" in cli.stdout and tags[-1:] == ["shutdown"],
          f"serve CLI: {cli.stdout[-2000:]}")
    out["d"] = {"communities": {k: comm[k] for k in (
                    "requests", "batches", "batch_size_hist", "wall_s",
                    "edges_per_s", "p50_ms", "p95_ms")},
                "streaming": {k: strm[k] for k in (
                    "cold_s", "warm_s", "speedup", "p50_ms")},
                "cli_wall_s": cli_s,
                "cli_summary": [x for x in cli.stdout.splitlines()
                                if x.startswith("[serve-tenants]")][-1:]}
    return out


# ---------------------------------------------------------------- timing

def _save_graph(g, d: Path) -> None:
    """``g``'s arrays as .npy files in ``d``, for spawned ranks."""
    for f in GRAPH_FIELDS:
        np.save(d / f"{f}.npy", getattr(g, f).cpu().numpy())
    (d / "graph.json").write_text(json.dumps(
        {"n": g.n, "num_edges": g.num_edges}))


def _load_graph(d: Path, dev):
    from repro_torch.core.graph import graph_from_arrays
    meta = json.loads((d / "graph.json").read_text())
    return graph_from_arrays(meta["n"], meta["num_edges"],
                             *(np.load(d / f"{f}.npy") for f in GRAPH_FIELDS),
                             device=dev)


def _host_ms(torch, fn, reps=5) -> float:
    """Host-clock milliseconds per call, the device idle at both ends (a
    gloo collective stages CUDA tensors through the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _sharded_fit(torch, ops, eng, g):
    """One sharded fit, timed, with the LPA kernels' launches (reset just
    before, read just after) and the rank's peak device memory in it
    (``g`` lies on the host: the fit moves only the rank's rows)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res, wall = _wall(torch, lambda: eng.fit(g))
    launches = {k: ops.LAUNCHES[k] for k in LPA_KERNELS}
    return res, {"device_peak_bytes": torch.cuda.max_memory_allocated()
                 - base, "propagation_s": res.lpa_seconds,
                 "split_s": res.split_seconds, "timings_s": res.timings,
                 "wall_s": wall, "lpa_iterations": res.lpa_iterations,
                 "split_iterations": res.split_iterations,
                 "communities": res.num_communities, "launches": launches}


def _sharded_kernels(torch, rt, g, bucket, mesh, labels_np, dev):
    """B1 and B2 on this rank's tiles as the sharded backend prepares them
    for the timed fit (the rotated replica of ``labels_np``; B2 as a
    split's first sweep), exact against their plain versions, timed
    beside their bounds."""
    from repro_torch.core.distributed import rotate
    from repro_torch.engine import EngineConfig, get_backend
    from repro_torch.engine.bucketing import BucketKey, pad_labels
    sg = get_backend("sharded").prepare(
        g, BucketKey(*bucket),
        EngineConfig(backend="sharded", mesh=mesh, device=str(dev)))
    labels = rotate(torch.from_numpy(pad_labels(
        labels_np, g.n, sg.n_pad)).to(dev), sg.row0)
    ids = rotate(torch.arange(sg.n_pad, dtype=torch.int32, device=dev),
                 sg.row0)
    t = {"nbr": sg.nbr, "nw": sg.nw, "nmask": sg.nmask, "labels": labels}
    ops, ref = rt.ops, rt.ref
    rows = {"label_argmax": _kernel_row(
        torch, "label_argmax", t,
        lambda: ops.label_argmax(sg.nbr, sg.nw, sg.nmask, labels, 3),
        lambda: _plain_rows(torch, ref, "label_argmax", t, 3), 3,
        _argmax_work(torch, t, "label_argmax"))[1]}
    rows["min_label"] = _kernel_row(
        torch, "min_label", t,
        lambda: ops.min_label(sg.nbr, sg.nmask, ids, labels),
        lambda: ref.min_label_ref(sg.nbr, sg.nmask, ids, labels), 3,
        _split_work(t, False))[1]
    for r in rows.values():
        r.update(row0=sg.row0, n_pad=sg.n_pad)
    return rows


def _sharded_nccl_rank(rank, world, tmp):
    """Phase sharded (a): one NCCL rank on a one-rank CUDA mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import exchange, resolve_shards
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.mesh import make_flat_mesh
    torch.backends.cuda.matmul.allow_tf32 = False   # plain argmax sums
    build.load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    tmp = Path(tmp)
    g = _load_graph(tmp, "cpu")
    want = np.load(tmp / "main_labels.npy")
    mesh = make_flat_mesh()
    out = {"mesh": repr(mesh), "backend": dist.get_backend()}
    fits = {}
    for k in (1, SHARDED_STALE_K):
        eng = Engine(EngineConfig(backend="sharded", mesh=mesh,
                                  exchange_every=k), cache=PlanCache())
        # cold: the plans and NCCL's communicator are built in this fit
        res, line = _sharded_fit(torch, ops, eng, g)
        line["labels_equal_main"] = bool(np.array_equal(res.labels, want))
        line["bucket"] = list(res.bucket)
        out[f"k{k}"], fits[k] = line, res
        if k == 1:
            res, line = _sharded_fit(torch, ops, eng, g)
            line["labels_equal_main"] = bool(np.array_equal(res.labels,
                                                            want))
            out["k1_warm"] = line
            res, line = _traced_fit(torch, eng, g)
            line["labels_equal_main"] = bool(np.array_equal(res.labels,
                                                            want))
            out["k1_traced"] = line
    gd = g.to(dev)   # the whole graph, for the connectivity checks only
    for k, res in fits.items():
        out[f"k{k}"]["disconnected_fraction"] = res.check_connected(gd)
    del gd
    shards = resolve_shards(mesh)
    x = torch.arange(out["k1"]["bucket"][0], dtype=torch.int32, device=dev)
    out["exchange_ms"] = _time_ms(torch, lambda: exchange(shards, x))
    out["exchange_host_ms"] = _host_ms(torch, lambda: exchange(shards, x))
    out["exchange_bytes"] = 4 * x.numel()
    out["kernels"] = _sharded_kernels(
        torch, SimpleNamespace(ops=ops, ref=ref), g, out["k1"]["bucket"],
        mesh, want, dev)
    return out


def _sharded_gloo_rank(rank, world, tmp, device):
    """Phase sharded (b): one of two gloo ranks (no mesh: the default
    group).  On the card, grid2d(3500) at exchange_every=1 first; then
    the planted graph at SHARDED_STALE_K, on ``device``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import exchange, resolve_shards
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import planted_partition
    from repro_torch.kernels import build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {"rank": rank, "world": world, "device": device}
    if dev.type == "cuda":
        build.load_library()
        tmp = Path(tmp)
        g = _load_graph(tmp, "cpu")
        want = np.load(tmp / "main_labels.npy")
        eng = Engine(EngineConfig(backend="sharded"), cache=PlanCache())
        res, line = _sharded_fit(torch, ops, eng, g)
        line["labels_equal_main"] = bool(np.array_equal(res.labels, want))
        line["bucket"] = list(res.bucket)
        out["grid"] = line
        shards = resolve_shards(None)
        n_loc = res.bucket[0] // shards.count
        x = torch.arange(n_loc, dtype=torch.int32, device=dev)
        out["exchange_host_ms"] = _host_ms(torch,
                                           lambda: exchange(shards, x))
        out["exchange_bytes"] = 4 * n_loc * shards.count
        dist.barrier()
        if rank == 1:   # rank 0 waits: the card is rank 1's alone
            out["kernels"] = _sharded_kernels(
                torch, SimpleNamespace(ops=ops, ref=ref), g, res.bucket,
                None, want, dev)
        dist.barrier()
        del g
    else:   # the host's cores shared between the ranks
        import os
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    gp = planted_partition(32, 512, 0.04, 0.0005, seed=1)[0].to(dev)
    t0 = time.perf_counter()
    res = Engine(EngineConfig(backend="sharded", device=device,
                              exchange_every=SHARDED_STALE_K),
                 cache=PlanCache()).fit(gp)
    out["planted"] = {"labels": res.labels, "wall_s": time.perf_counter() - t0,
                      "lpa_iterations": res.lpa_iterations,
                      "split_iterations": res.split_iterations,
                      "bucket": list(res.bucket),
                      "disconnected_fraction": res.check_connected(gp)}
    return out


def _launch_rule(line, ctx) -> None:
    n = line["launches"]
    check(n["label_argmax"] == 2 * line["lpa_iterations"]
          and n["min_label"] == line["split_iterations"]
          and n["fused_move"] == n["fused_split"] == 0,
          f"{ctx}: launches {n} for {line['lpa_iterations']} LPA steps "
          f"and {line['split_iterations']} split sweeps")


def phase_sharded(torch, dev, g, fused, main_res):
    """Multi-device detection over torch.distributed; returns (a)'s
    launches and the phase's line."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        t0 = time.perf_counter()
        _save_graph(g, tmp)
        np.save(tmp / "main_labels.npy", fused.labels)
        save_s = time.perf_counter() - t0
        runs = {}
        for name, fn, world, backend, args in (
                ("a", _sharded_nccl_rank, 1, "nccl", (str(tmp),)),
                ("b", _sharded_gloo_rank, 2, "gloo", (str(tmp), "cuda")),
                ("b_cpu", _sharded_gloo_rank, 2, "gloo", (str(tmp), "cpu"))):
            t0 = time.perf_counter()
            out = spawn_ranks(fn, world, args, backend=backend,
                              timeout=SHARDED_TIMEOUT_S)
            runs[name] = (out, time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_it = (fused.lpa_iterations, fused.split_iterations)
    (a,), a_s = runs["a"]
    k1, kst = a["k1"], a[f"k{SHARDED_STALE_K}"]
    check(k1["labels_equal_main"] and (k1["lpa_iterations"],
                                       k1["split_iterations"]) == main_it,
          f"(a) one NCCL rank differs from main's fits: {main_it} vs "
          f"{(k1['lpa_iterations'], k1['split_iterations'])}")
    _launch_rule(k1, "(a) exchange_every=1")
    for name in ("k1_warm", "k1_traced"):
        check(a[name]["labels_equal_main"], f"(a) {name} differs from main")
    _launch_rule(a["k1_warm"], "(a) exchange_every=1, warm")
    _launch_rule({**kst, "lpa_iterations": SHARDED_STALE_K
                  * kst["lpa_iterations"]}, "(a) stale")
    check(kst["disconnected_fraction"] == 0.0,
          f"(a) exchange_every={SHARDED_STALE_K}: disconnected fraction "
          f"{kst['disconnected_fraction']}")
    b, b_s = runs["b"]
    b_cpu, b_cpu_s = runs["b_cpu"]
    for r in b:
        line = r["grid"]
        check(line["labels_equal_main"] and (
            line["lpa_iterations"], line["split_iterations"]) == main_it,
            f"(b) gloo rank {r['rank']} differs from main's fits")
        _launch_rule(line, f"(b) rank {r['rank']}")
        # a rank holds only its rows: its peak is below the one rank's
        check(line["device_peak_bytes"] < k1["device_peak_bytes"],
              f"(b) gloo rank {r['rank']} peaks at "
              f"{line['device_peak_bytes']} B, one rank at "
              f"{k1['device_peak_bytes']} B")
    planted = [r["planted"] for r in b + b_cpu]
    for p in planted:
        check(np.array_equal(p["labels"], planted[0]["labels"])
              and (p["lpa_iterations"], p["split_iterations"])
              == (planted[0]["lpa_iterations"],
                  planted[0]["split_iterations"])
              and p["disconnected_fraction"] == 0.0,
              f"(b) {SHARDED_PLANTED} at exchange_every={SHARDED_STALE_K}: "
              "the card's two ranks differ from the CPU's")
    unfused = main_res["unfused"]

    def brief(p):
        return {k: v for k, v in p.items() if k != "labels"}
    return k1["launches"], {
        "graph": "grid2d(3500)", "graph_save_s": save_s,
        "a": {"world": 1, "backend": a["backend"], "mesh": a["mesh"],
              "command_s": a_s, "exchange_every_1": k1,
              "exchange_every_1_warm": a["k1_warm"],
              "exchange_every_1_traced": a["k1_traced"],
              f"exchange_every_{SHARDED_STALE_K}": kst,
              "exchange_ms": a["exchange_ms"],
              "exchange_host_ms": a["exchange_host_ms"],
              "exchange_bytes": a["exchange_bytes"],
              "kernels": a["kernels"]},
        "b": {"world": 2, "backend": "gloo", "device": "cuda:0 (both ranks)",
              "command_s": b_s, "grid": [r["grid"] for r in b],
              "exchange_host_ms": [r["exchange_host_ms"] for r in b],
              "exchange_bytes": b[0]["exchange_bytes"],
              "kernels_rank1": b[1]["kernels"],
              "planted_graph": SHARDED_PLANTED,
              "planted": [brief(r["planted"]) for r in b],
              "planted_cpu": [brief(r["planted"]) for r in b_cpu],
              "cpu_command_s": b_cpu_s},
        "main_unfused": {"wall_s": unfused["wall_s"],
                         "propagation_s": unfused["timings_s"]["propagation"],
                         "split_s": unfused["timings_s"]["split"]}}


def _time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timing_tiles(torch, g, rows, d, labels_np, dev):
    """Tiles and per-row state of one timing call: the graph's padded
    tiles at (rows, d), ``labels_np`` on its vertices (ids beyond), the
    hashed parity class as klass, every row active, 10 % changed."""
    from repro_torch.core.graph import to_padded_neighbors
    from repro_torch.kernels.ref import label_hash
    nbr, nw, nmask = to_padded_neighbors(g, d_max=d, rows=rows)
    ids = torch.arange(rows, dtype=torch.int32, device=dev)
    labels = ids.clone()
    labels[: g.n] = torch.from_numpy(np.asarray(labels_np)).to(dev)
    rng = np.random.default_rng(0)
    return {"nbr": nbr, "nw": nw, "nmask": nmask, "labels": labels,
            "ids": ids,
            "chg": torch.from_numpy(rng.random(rows) < 0.1).to(dev),
            "active": torch.ones(rows, dtype=torch.bool, device=dev),
            "cand_prev": torch.zeros(rows, dtype=torch.bool, device=dev),
            "klass": (label_hash(ids, -1) & 1).bool(), "real": ids < g.n}


def _move_args(t, nw=None):
    return (t["nbr"], t["nw"] if nw is None else nw, t["nmask"], t["labels"],
            t["chg"], t["active"], t["cand_prev"], t["klass"], t["real"])


def _plain_rows(torch, ref, name, t, seed):
    """The plain version of B1 / B3 over row chunks whose D x D equality
    cube stays within 1 GiB of float32.  The plain version reads
    ``labels[:rows]`` as the rows' own labels, so each chunk's labels (and
    changed flags) go first and its nbr is shifted past them."""
    fn = {"label_argmax": ref.label_argmax_ref,
          "fused_move": ref.fused_move_ref}[name]
    rows, d = t["nbr"].shape
    step = max(1, PLAIN_CUBE_FLOATS // (d * d))
    if step >= rows:
        args = (_move_args(t) if name == "fused_move"
                else (t["nbr"], t["nw"], t["nmask"], t["labels"]))
        return fn(*args, seed)
    outs = []
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        nbr = t["nbr"][lo:hi] + (hi - lo)
        lab = torch.cat([t["labels"][lo:hi], t["labels"]])
        tile = (nbr, t["nw"][lo:hi], t["nmask"][lo:hi], lab)
        if name == "fused_move":
            chg = torch.cat([t["chg"][lo:hi], t["chg"]])
            tile += (chg, *(t[k][lo:hi] for k in ("active", "cand_prev",
                                                  "klass", "real")))
        outs.append(fn(*tile, seed))
    return tuple(torch.cat(x) for x in zip(*outs))


def _bits_check(torch, rt, t, dev, seed=3):
    """B1 and B3 on real weights (uniform(0.1, 5.0) on the real cells, from
    a seed) against the slot-order sum (``ref.label_argmax_slot_order``),
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    nw = torch.empty(t["nw"].shape, device=dev).uniform_(0.1, 5.0,
                                                          generator=gen)
    nw = torch.where(t["nmask"], nw, 0.0)
    got = rt.ops.label_argmax(t["nbr"], nw, t["nmask"], t["labels"], seed)
    want = rt.ref.label_argmax_slot_order(t["nbr"], nw, t["nmask"],
                                          t["labels"], seed)
    for a, b, what in zip(got, want, ("best_lab", "best_w", "cur_w")):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"label_argmax {what} != the slot-order sum's bits "
              f"(d={t['nbr'].shape[1]})")
    new, act = rt.ops.fused_move(*_move_args(t, nw), seed)
    bl, bw, cw = want
    wake = (t["chg"][t["nbr"]] & t["nmask"]).any(dim=1)
    act_want = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
    adopt = act_want & t["klass"] & (bw > cw.clamp_min(0.0))
    check(torch.equal(act, act_want)
          and torch.equal(new, torch.where(adopt, bl, t["labels"])),
          f"fused_move != the slot-order sum + glue "
          f"(d={t['nbr'].shape[1]})")
    return {"weights": "uniform(0.1, 5.0)", "bits_equal": True,
            "rows_adopting": int(adopt.sum())}


def _argmax_work(torch, t, name):
    """(bytes, bytes_all_rows, operations) of one B1 / B3 call on ``t``.

    Bytes: what a correct kernel must move, each input read once and each
    output written once.  B1 reads every row: the mask tile, nbr and
    weight of each real cell, the label vector, and writes 12 B per row.
    B3 reads each row's 4 state bytes and its label and writes 5 B; only
    rows whose act needs the wake (not active && !cand_prev, and real)
    add their mask row, their real cells' nbr and the changed vector, and
    only rows that can adopt (act && klass) add mask, nbr and weights.
    ``bytes_all_rows`` is the earlier model that counts every row's tile.
    Operations: at least r * ceil(log2 r) compares per row that needs an
    argmax (a sort of its r real labels), counted at the fp32 rate.
    """
    nbr, nmask = t["nbr"], t["nmask"]
    rows, d = nmask.shape
    n_vec = t["labels"].numel()
    r = nmask.sum(dim=1)
    cells = int(r.sum())

    def compares(sel):
        rr = r[sel].double()
        return float((rr * torch.ceil(torch.log2(rr.clamp_min(1)))).sum())

    if name == "label_argmax":
        b = rows * d + 8 * cells + 4 * n_vec + 12 * rows
        return b, b, compares(torch.ones_like(nmask[:, 0]))
    known = t["active"] & ~t["cand_prev"]
    wake_rows = ~known & t["real"]
    wake = (t["chg"][nbr] & nmask).any(dim=1)
    arg_rows = (known | (wake & t["real"])) & t["klass"]
    touched = wake_rows | arg_rows
    b = (9 * rows + 4 * n_vec + int(touched.sum()) * d
         + 4 * int(r[touched].sum()) + 4 * int(r[arg_rows].sum())
         + (n_vec if bool(wake_rows.any()) else 0))
    all_rows = rows * d + cells * 8 + 5 * n_vec + 4 * rows + 5 * rows
    return b, all_rows, compares(arg_rows)


def _kernel_row(torch, name, t, kern, plain, plain_reps, work):
    """Check a kernel against its plain version exactly, time both, and
    hold the kernel to its bound (``work`` = bytes, bytes_all_rows,
    operations)."""
    ka, pa = kern(), plain()
    ka = ka if isinstance(ka, tuple) else (ka,)
    pa = pa if isinstance(pa, tuple) else (pa,)
    err = max(_err(a, b) for a, b in zip(ka, pa))
    rows, d = t["nbr"].shape
    check(err == 0.0, f"{name} disagrees with its plain version at "
          f"({rows}, {d}): {err}")
    ms = _time_ms(torch, kern)
    plain_ms = _time_ms(torch, plain, reps=plain_reps, warmup=1)
    bytes_, bytes_all, ops_n = work
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / FP32_OPS_PER_S * 1e3
    share = bytes_ms / ms
    check(share <= 1.0, f"{name} at ({rows}, {d}) took {ms} ms, under its "
          f"bytes bound {bytes_ms} ms: the bound's model is wrong")
    return ka, {
        "rows": rows, "d": d, "real_cells": int(t["nmask"].sum()),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_, "bytes_all_rows": bytes_all, "operations": ops_n,
        "achieved_GBps": bytes_ / (ms * 1e-3) / 1e9,
        "bytes_bound_share": share, "library_ms": None}


def _time_argmax(torch, rt, t, plain_reps, seed=3):
    """B1 and B3 on ``t``: exact against the plain version, timed, with
    their bounds."""
    out = {}
    for name in ARGMAX_KERNELS:
        if name == "label_argmax":
            def kern():
                return rt.ops.label_argmax(t["nbr"], t["nw"], t["nmask"],
                                           t["labels"], seed)
        else:
            def kern():
                return rt.ops.fused_move(*_move_args(t), seed)
        out[name] = _kernel_row(
            torch, name, t, kern,
            lambda n=name: _plain_rows(torch, rt.ref, n, t, seed),
            plain_reps, _argmax_work(torch, t, name))[1]
    return out


def _split_work(t, prune):
    """(bytes, bytes_all_rows, operations) of one B2 / B4 call on ``t``:
    the mask tile, the nbr of each real cell, the label and community
    vectors, 4 B out per row, and with prune the changed vector; one
    compare per real cell."""
    rows, d = t["nmask"].shape
    cells = int(t["nmask"].sum())
    b = rows * d + 4 * cells + 8 * rows + 4 * rows
    if prune:
        b += t["chg"].numel()
    return b, b, cells


def _time_split(torch, rt, t, plain_reps):
    """B2 and B4 on ``t`` as a split's first sweep (labels = row ids, comm
    = the case's labels): exact against the plain version, timed, with
    their bounds; B4 without prune (split lp) and with it (lpp)."""
    ops, ref = rt.ops, rt.ref
    nbr, nmask, ids, comm, chg = (t[k] for k in ("nbr", "nmask", "ids",
                                                 "labels", "chg"))
    mins = ops.min_label(nbr, nmask, ids, comm)
    check(torch.equal(ops.fused_split(nbr, nmask, ids, comm, chg, False),
                      mins), "fused_split without prune != min_label")
    runs = {"min_label": (lambda: ops.min_label(nbr, nmask, ids, comm),
                          lambda: ref.min_label_ref(nbr, nmask, ids, comm),
                          False)}
    for name, p in (("fused_split", False), ("fused_split_prune", True)):
        runs[name] = (
            lambda p=p: ops.fused_split(nbr, nmask, ids, comm, chg, p),
            lambda p=p: ref.fused_split_ref(nbr, nmask, ids, comm, chg, p),
            p)
    return {name: _kernel_row(torch, name, t, kern, plain, plain_reps,
                              _split_work(t, prune))[1]
            for name, (kern, plain, prune) in runs.items()}


def phase_timing(torch, rt, dev, cases):
    """``cases``: (graph name, graph, rows, d, labels) per width, the main
    fit's first."""
    ops = rt.ops
    widths = []
    for gname, g, rows, d, labels in cases:
        t = _timing_tiles(torch, g, rows, d, labels, dev)
        torch.cuda.synchronize()
        row = {"graph": gname, "rows": rows, "d": d,
               "real_cells": int(t["nmask"].sum()),
               "real_weight_check": _bits_check(torch, rt, t, dev)}
        reps = 5 if d <= 8 else 2
        row.update(_time_argmax(torch, rt, t, plain_reps=reps))
        row.update(_time_split(torch, rt, t, plain_reps=reps))
        if not widths:
            main_t = t
        else:
            del t
        widths.append(row)
    t = main_t
    ids, rows = t["ids"], t["nbr"].shape[0]
    # B3 at the main shapes with klass on every row, and on the first half
    # of the rows (as many rows as the parity class, but contiguous): how
    # far the parity class's interleaved rows keep the tile's bytes read
    layouts = {}
    for tag, kl in (("parity", t["klass"]), ("all_rows", ids >= 0),
                    ("first_half", ids < rows // 2)):
        tk = {**t, "klass": kl}
        layouts[tag] = {
            "rows_in_klass": int(kl.sum()),
            "ms": _time_ms(torch, lambda tk=tk: ops.fused_move(
                *_move_args(tk), 3)),
            "bytes": _argmax_work(torch, tk, "fused_move")[0]}
    # the main fit's split is lp: fused_split without prune
    main = {k: widths[0][k] for k in LPA_KERNELS}
    return {"kernels": main, "widths": widths,
            "fused_move_klass_layouts": layouts}


# ----------------------------------------------------------------- trace

def _device_busy(torch, prof) -> tuple[int, float]:
    """(device events, seconds in their union) of a profiler run."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return len(spans), busy * 1e-6


def _traced_fit(torch, eng, g):
    """One ``eng.fit(g)`` under torch.profiler: (result, its wall, stage
    timings, device busy seconds and idle share, top device ops)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.fit(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_events, busy_s = _device_busy(torch, prof)
    top = sorted(((a.key, a.self_device_time_total * 1e-6, a.count)
                  for a in prof.key_averages()
                  if a.self_device_time_total > 0),
                 key=lambda x: -x[1])[:8]
    return res, {"wall_s": wall, "timings_s": res.timings,
                 "device_events": n_events, "device_busy_s": busy_s,
                 "device_idle_share": ((1.0 - busy_s / wall) if n_events
                                       else None),
                 "top_device": [{"name": k[:80], "s": s, "count": c}
                                for k, s, c in top]}


def phase_trace(torch, g):
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(backend="tile", split="lp"), cache=PlanCache())
    eng.fit(g)   # plan and allocator warm
    return {"fit": "fused tile fit of grid2d(3500), plan warm",
            **_traced_fit(torch, eng, g)[1]}


# ----------------------------------------------------------------- flash

def _qkv(torch, gen, b, sq, h, k, hd, skv, dtype):
    def rnd(*shape):
        return torch.randn(shape, device=gen.device, generator=gen).to(dtype)
    return rnd(b, sq, h, hd), rnd(b, skv, k, hd), rnd(b, skv, k, hd)


def _rel(got, want) -> tuple[float, float]:
    """(max abs difference, that over max abs of the plain version); the
    difference itself where the plain version is all zeros (B5-bwd's dq
    and dk over one key, where softmax has no gradient)."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return diff, (diff / scale if scale > 0 else diff)


def phase_flash(torch, rt, dev):
    ops, ref = rt.ops, rt.ref
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 8e-3, f32: 1e-5}      # one bf16 ulp; f32 sums reordered
    gen = torch.Generator(device=dev).manual_seed(0)
    # (b, sq, h, k, hd, skv, causal, dtype): the reference's test shapes
    # (tests/test_flash_attention.py), causal and not, then ragged, cross,
    # Sq > Skv under causal, and float32.
    cases = [(b, s, h, k, hd, s, c, bf16)
             for b, s, h, k, hd in ((1, 256, 4, 4, 64), (2, 512, 8, 2, 64),
                                    (1, 512, 4, 1, 128))
             for c in (True, False)]
    cases += [(1, 300, 4, 4, 64, 300, True, bf16),
              (1, 256, 4, 4, 64, 512, False, bf16),
              (1, 300, 2, 2, 64, 200, True, bf16),
              (1, 1024, 2, 2, 64, 1024, True, bf16),
              (1, 256, 2, 2, 64, 256, True, f32),
              (1, 300, 2, 2, 64, 200, True, f32),
              (1, 512, 4, 1, 128, 512, False, f32),
              (2, 300, 8, 2, 128, 333, True, f32)]
    # The TMA ring's edges: a ragged Skv at B=2 (no tile may read into the
    # next batch), several partial KV tiles, a 128-byte row (hd=64), one
    # query.
    cases += [(2, 300, 8, 2, 128, 333, True, bf16),
              (1, 1000, 4, 1, 128, 1000, True, bf16),
              (1, 512, 4, 1, 64, 512, False, bf16),
              (2, 1, 4, 2, 128, 77, False, bf16)]
    checked = []
    for b, sq, h, k, hd, skv, causal, dtype in cases:
        q, kk, v = _qkv(torch, gen, b, sq, h, k, hd, skv, dtype)
        got = ops.flash_attention(q, kk, v, causal=causal)
        want = ref.flash_attention_ref(q, kk, v, causal)
        abs_err, rel = _rel(got, want)
        name = str(dtype).replace("torch.", "")
        check(got.dtype == dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all()),
              f"flash output malformed at {(b, sq, h, k, hd, skv)}")
        check(rel < tol[dtype], f"flash disagrees with its plain version: "
              f"{(b, sq, h, k, hd, skv, causal, name)} rel {rel}")
        checked.append({"shape": [b, sq, h, k, hd, skv], "causal": causal,
                        "dtype": name, "max_abs_err": abs_err,
                        "rel_err": rel})

    # The main path: one causal prefill call at Yi-9B's attention width.
    b, s, h, k, hd = (FLASH_MAIN[x] for x in ("b", "s", "h", "k", "hd"))
    q, kk, v = _qkv(torch, gen, b, s, h, k, hd, s, bf16)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = ops.flash_attention(q, kk, v, causal=True)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_attention"]
    check(launches == 1, f"the main call made {launches} flash launches")
    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
          "flash main call: malformed output")
    want = ref.flash_attention_ref(q, kk, v, True)
    abs_err, rel = _rel(out, want)
    check(rel < tol[bf16], f"flash main call disagrees: rel {rel}")

    plain_ms = _time_ms(torch, lambda: ref.flash_attention_ref(q, kk, v,
                                                               True),
                        reps=3, warmup=1)
    main = _flash_timed(torch, ops, q, kk, v, True, want)
    main.update({"shape": FLASH_MAIN, "dtype": "bfloat16", "causal": True,
                 "launches": launches, "max_abs_err": abs_err,
                 "rel_err": rel, "plain_ms": plain_ms})
    del q, kk, v, out, want
    timed = []
    for seq, causal in FLASH_TIMED:
        # Checked against the plain version too: the non-causal loop and
        # the 16384-token grid are reached at this width only.
        q, kk, v = _qkv(torch, gen, b, seq, h, k, hd, seq, bf16)
        got = ops.flash_attention(q, kk, v, causal=causal)
        abs_err, rel = _rel(got, ref.flash_attention_ref(q, kk, v, causal))
        check(bool(torch.isfinite(got).all()) and rel < tol[bf16],
              f"flash disagrees at S={seq} causal={causal}: rel {rel}")
        row = _flash_timed(torch, ops, q, kk, v, causal)
        timed.append({"shape": {**FLASH_MAIN, "s": seq}, "causal": causal,
                      "max_abs_err": abs_err, "rel_err": rel, **row})
        del q, kk, v, got
    return {"cases": checked,
            "tolerance_rel": {"bfloat16": 8e-3, "float32": 1e-5},
            "main": main, "timed": timed}


def _flash_timed(torch, ops, q, kk, v, causal, want=None, kv_len=None):
    """Time one flash call beside SDPA (yardstick only, on the (B, H, S,
    hd) layout, over the visible keys), with its work and bound; SDPA's
    error if `want` given.  `kv_len`: the call's visible keys of a longer
    K / V buffer (a decode step's cache)."""
    b, sq, h, hd = q.shape
    skv = kk.shape[1] if kv_len is None else kv_len
    ms = _time_ms(torch, lambda: ops.flash_attention(q, kk, v, causal=causal,
                                                     kv_len=kv_len))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x[:, :skv].transpose(1, 2).contiguous() for x in (kk, v))
    row = {"ms": ms}
    if want is not None:
        lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        row["library_max_abs_err"], row["library_rel_err"] = _rel(
            lib_out.transpose(1, 2), want)
        del lib_out
    row["library_ms"] = _time_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    # Work the call needs: QK^T and PV over the visible (query, key)
    # pairs; q, k, v read once and the output written once.
    rows = np.arange(1, sq + 1)
    pairs = int(np.minimum(rows, skv).sum()) if causal else sq * skv
    operations = 4 * b * h * hd * pairs
    bytes_ = (2 * q.numel() + 2 * b * skv * kk.shape[2] * hd) * 2
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row.update({"operations": operations, "bytes": bytes_,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "achieved_TFLOPs": operations / (ms * 1e-3) / 1e12})
    return row


# ---------------------------------------------------------------- decode

def _graph_ms(torch, fn, reps=20, replays=5):
    """Device ms a call takes when the host does not limit it: `reps`
    calls captured in one CUDA graph, replayed `replays` times between
    CUDA events (the gaps between its kernels counted, the host's launch
    path not), a call's share; None when the calls cannot be captured
    or replayed (a measurement, not a gate).  The decode phase's
    `device_ms` and the times beside it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"chip_smoke: no CUDA graph timing: {e}", file=sys.stderr)
        torch.cuda.synchronize()
        return None
    return start.elapsed_time(end) / (replays * reps)


def _host_us(torch, fn, n=500) -> float:
    """Host microseconds a call of `fn` takes to return, over `n` calls
    back to back (the device keeps up when it is faster)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / n * 1e6


def _decode_entry(torch, lib, q, kk, v, out, work, kw, rows, split):
    """One call of the decode body's C entry point with the arguments ops
    passes, for its host cost alone."""
    b, _sq, h, hd = q.shape
    ks, vs = kw["k_scale"], kw["v_scale"]
    rc = lib.attn_flash_decode(
        q.data_ptr(), kk.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), None, work.data_ptr(), b, h,
        kk.shape[2], kw["kv_len"], rows, hd, int(kw["causal"]),
        kw["window"] or 0, kw["q_offset"], split.splits, split.per_split,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the decode body's entry failed with {rc}")


def _prefill_body(torch, lib, q, kk, v, out, lse, kw, rows, kv_len):
    """One launch of flash_attention.cu's entry point (the body every B5
    call ran before the decode body) on a decode call, for comparison:
    measurement only, the port never calls it so."""
    b, _sq, h, hd = q.shape
    ks, vs = kw["k_scale"], kw["v_scale"]
    rc = lib.attn_flash_attention(
        q.data_ptr(), kk.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), None, b, h, kk.shape[2], 1,
        kv_len, rows, hd, int(kw["causal"]), kw["window"] or 0,
        kw["q_offset"], 1, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the prefill body failed with {rc}")


def _decode_row(torch, rt, lib, gen, call) -> dict:
    """One decode call through ops (the decode body): gates, rows loaded,
    times beside its bound, the plain version, SDPA and the prefill
    body."""
    from repro_torch.models.attention import quantize_kv
    ops, ref = rt.ops, rt.ref
    name, b, h, k, hd, rows, kv_len, q_off, window, causal, q8, with_lse = \
        call
    bf16 = torch.bfloat16
    q, kc, vc = _qkv(torch, gen, b, 1, h, k, hd, rows, bf16)
    kc[:, kv_len:] = 1e4
    vc[:, kv_len:] = -1e4
    ks = vs = None
    if q8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    kw = dict(causal=causal, kv_len=kv_len, window=window, q_offset=q_off,
              k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    out, lse = ops.flash_attention_fwd(q, kc, vc, **kw)
    again = ops.flash_attention(q, kc, vc, **kw)
    torch.cuda.synchronize()
    got = {x: ops.LAUNCHES[x] - before[x]
           for x in ("flash_attention", "flash_decode")}
    check(got == {"flash_attention": 2, "flash_decode": 2},
          f"decode {name}: two calls made launches {got}")
    check(torch.equal(out, again), f"decode {name}: two launches differ")
    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
          f"decode {name}: malformed output")
    plain, plain_lse = ref.flash_decode_ref(q, kc, vc, **kw)
    abs_err, rel = _rel(out, plain)
    _, rel_oracle = _rel(out, ref.flash_attention_ref(q, kc, vc, **kw))
    lse_err = float((lse - plain_lse).abs().max())
    check(rel < LM_KERNEL_TOL and rel_oracle < LM_KERNEL_TOL,
          f"decode {name}: rel {rel} (plain), {rel_oracle} (oracle)")
    check(lse_err < 1e-3, f"decode {name}: lse off by {lse_err}")
    # the key rows the blocks load: each visible tile once per (batch, KV
    # head, row chunk)
    split = ref.decode_split(b, h, k, kv_len, causal, window, q_off)
    chunks = -(-(h // k) // ref.DECODE_ROWS)
    per_span = [min(e, kv_len) - a for a, e in split.spans()]
    with ops.count_kv_rows() as counted:
        ops.flash_attention(q, kc, vc, **kw)
    want = {"rows": b * k * chunks * sum(per_span),
            "blocks": b * k * chunks * split.splits,
            "max_rows": max(per_span)}
    c = counted[0]
    check(len(counted) == 1 and {x: c[x] for x in want} == want,
          f"decode {name}: rows loaded {counted}, want {want}")

    def call_():
        if with_lse:
            return ops.flash_attention_fwd(q, kc, vc, **kw)
        return ops.flash_attention(q, kc, vc, **kw)
    ms = _time_ms(torch, call_)
    device_ms = _graph_ms(torch, call_)
    host_us = _host_us(torch, call_)
    work = torch.empty(b * h * split.splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    scratch = torch.empty_like(q)
    entry_host_us = _host_us(torch, lambda: _decode_entry(
        torch, lib, q, kc, vc, scratch, work, kw, rows, split))
    plain_ms = _time_ms(torch, lambda: ref.flash_decode_ref(q, kc, vc, **kw),
                        reps=5, warmup=1)
    # the prefill body on the same call, checked and timed
    old = torch.empty_like(q)
    old_lse = torch.empty_like(lse) if with_lse else None
    _prefill_body(torch, lib, q, kc, vc, old, old_lse, kw, rows, kv_len)
    torch.cuda.synchronize()
    _, rel_old = _rel(old, plain)
    check(rel_old < LM_KERNEL_TOL, f"decode {name}: the prefill body's rel "
          f"{rel_old}")
    prefill_ms = _time_ms(torch, lambda: _prefill_body(
        torch, lib, q, kc, vc, old, old_lse, kw, rows, kv_len))
    prefill_device_ms = _graph_ms(torch, lambda: _prefill_body(
        torch, lib, q, kc, vc, old, old_lse, kw, rows, kv_len))
    prefill_entry_host_us = _host_us(torch, lambda: _prefill_body(
        torch, lib, q, kc, vc, old, old_lse, kw, rows, kv_len))
    library_ms = library_device_ms = None
    if not (q8 or with_lse):
        # SDPA over the visible keys copied out (one query: no mask)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, split.lo:split.hi + 1].transpose(1, 2).contiguous()
                  for x in (kc, vc))
        library_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt,
                                                  enable_gqa=True))
        library_device_ms = _graph_ms(torch, lambda: sdpa(
            qt, kt, vt, enable_gqa=True))
    # Work the call needs: QK^T and PV over the visible keys; q and the
    # visible K / V rows (and their scales) read once, the output (and
    # lse) written once.
    n_vis = split.hi + 1 - split.lo
    elem = 1 if q8 else 2
    bytes_ = (2 * 2 * q.numel() + 2 * b * n_vis * k * hd * elem
              + (2 * 2 * b * n_vis * k if q8 else 0)
              + (4 * b * h if with_lse else 0))
    operations = 4 * b * h * hd * n_vis
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    return {"call": name, "q": list(q.shape), "kv": [b, rows, k, hd],
            "kv_len": kv_len, "q_offset": q_off, "window": window,
            "causal": causal, "int8": q8, "lse": with_lse,
            "group": h // k, "splits": split.splits,
            "tiles_per_split": split.per_split, "visible_keys": n_vis,
            "rows_loaded": c["rows"], "blocks": c["blocks"],
            "max_rows_a_block": c["max_rows"],
            "max_abs_err": abs_err, "rel_err": rel,
            "rel_err_oracle": rel_oracle, "lse_max_abs_err": lse_err,
            "ms": ms, "device_ms": device_ms, "host_us": host_us,
            "entry_host_us": entry_host_us, "plain_ms": plain_ms,
            "prefill_body_ms": prefill_ms,
            "prefill_body_device_ms": prefill_device_ms,
            "prefill_entry_host_us": prefill_entry_host_us,
            "prefill_body_rel_err": rel_old,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "operations": operations,
            "bytes": bytes_, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_decode(torch, rt, dev):
    """B5's decode body at every DECODE_CALLS shape (see the docstring)."""
    from repro_torch.kernels import build
    lib = build.load_library()
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = [_decode_row(torch, rt, lib, gen, call) for call in DECODE_CALLS]
    return {"tolerance_rel": LM_KERNEL_TOL, "lse_tolerance_abs": 1e-3,
            "calls": rows,
            "main": next(r for r in rows if r["call"] == DECODE_MAIN)}


# -------------------------------------------------------------------- lm

def _lm_rel(want, got, vocab) -> float:
    """Max abs difference over max abs of `want`, over the real vocab."""
    a, b = want[..., :vocab].float(), got[..., :vocab].float()
    return float((a - b).abs().max() / a.abs().max())


def _lm_model(torch, T, cfg, seed, dev):
    from repro_torch.models.common import init_from_specs
    t0 = time.perf_counter()
    params = init_from_specs(T.model_specs(cfg), seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _lm_calls(torch, rt, cfg, params, dev):
    """(a) B5 on layer 0's q / k / v of a prompt at full width: the
    prefill call and decode calls over a cache, against the plain
    version, timed beside their bounds and SDPA."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    ops, ref = rt.ops, rt.ref
    b, s, s_max = (LM_SERVE[k] for k in ("batch", "prompt_len", "s_max"))
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                         device=dev)
    p0 = {k: v[0] for k, v in params["groups"]["0"]["attn"].items()}
    scale0 = params["groups"]["0"]["norm1"]["scale"][0]
    with torch.inference_mode():
        h = L.rms_norm({"scale": scale0}, L.embed(params["embed"], toks))
        pos = torch.arange(s + 1, dtype=torch.int32, device=dev)
        q, k, v = (x.contiguous() for x in A._project_qkv(
            p0, h, pos, cfg.rope_theta))
    calls = []

    def one(name, q_, k_, v_, causal, kv_len):
        got = ops.flash_attention(q_, k_, v_, causal=causal, kv_len=kv_len)
        want = ref.flash_attention_ref(q_, k_, v_, causal, kv_len)
        abs_err, rel = _rel(got, want)
        check(got.shape == q_.shape and bool(torch.isfinite(got).all()),
              f"lm {name}: malformed output")
        check(rel < LM_KERNEL_TOL, f"lm {name}: B5 disagrees with its plain "
              f"version, rel {rel}")
        row = {"call": name, "q": list(q_.shape), "kv": list(k_.shape),
               "kv_len": kv_len, "causal": causal, "max_abs_err": abs_err,
               "rel_err": rel}
        if name in ("prefill", "decode"):
            row["plain_ms"] = _time_ms(torch, lambda: ref.flash_attention_ref(
                q_, k_, v_, causal, kv_len), reps=3, warmup=1)
            row.update(_flash_timed(torch, ops, q_, k_, v_, causal, want,
                                    kv_len=kv_len))
        calls.append(row)
        return got

    # the prefill call: the prompt's first s positions, causal
    pre = [x[:, :s].contiguous() for x in (q, k, v)]
    one("prefill", *pre, True, None)
    # decode: the query at position s over a cache of s_max rows holding
    # s + 1 keys; the rows past them hold large junk that must not be read
    r = LM_RAGGED_KEYS
    for name, nb, n_keys in (("decode", b, s + 1), ("decode_b2", 2, r)):
        kc, vc = (torch.randn((nb, s_max) + k.shape[2:], generator=gen,
                              device=dev).mul_(1e4).to(k.dtype)
                  for _ in range(2))
        kc[:, :n_keys], vc[:, :n_keys] = k[:nb, :n_keys], v[:nb, :n_keys]
        q1 = q[:nb, n_keys - 1:n_keys].contiguous()
        got = one(name, q1, kc, vc, False, n_keys)
        # the same function as the keys alone, copied out
        alone = ref.flash_attention_ref(q1, kc[:, :n_keys].contiguous(),
                                        vc[:, :n_keys].contiguous(), False)
        check(_rel(got, alone)[1] < LM_KERNEL_TOL,
              f"lm {name}: kv_len differs from the keys alone")
    # the float32 path's buffer stride
    qf = q[:2, r - 1:r].float().contiguous()
    kf, vf = (torch.zeros((2, s_max) + k.shape[2:], device=dev)
              for _ in range(2))
    kf[:, :r], vf[:, :r] = k[:2, :r].float(), v[:2, :r].float()
    kf[:, r:], vf[:, r:] = 1e4, 1e4
    got = ops.flash_attention(qf, kf, vf, causal=False, kv_len=r)
    rel = _rel(got, ref.flash_attention_ref(qf, kf, vf, False, r))[1]
    check(rel < 1e-5, f"lm decode float32: rel {rel}")
    calls.append({"call": "decode_f32", "q": list(qf.shape),
                  "kv": list(kf.shape), "kv_len": r, "causal": False,
                  "rel_err": rel})
    return calls


def _lm_card_vs_cpu(torch, T, cfg, dev, small=None, extras=None,
                    s_max=None, init_on_card=False):
    """(b) The whole path at full width and LM_CPU layers (or the config
    `small`): the card's prefill and decode logits against the CPU's
    plain path, one weight set made on the CPU (or on the card, and
    copied).  `extras`: numpy inputs beside the tokens (a VLM's vision
    prefix, an encoder's frames), cast to bf16 on each device; `s_max`
    defaults to LM_CPU's."""
    import dataclasses
    c = LM_CPU
    if small is None:
        small = dataclasses.replace(cfg, n_layers=c["layers"])
    extras = extras or {}
    cpu = torch.device("cpu")
    if init_on_card:
        params_dev, init_s = _lm_model(torch, T, small, LM_SEED, dev)
        params_cpu = _tree_map(params_dev, lambda x: x.cpu())
    else:
        params_cpu, init_s = _lm_model(torch, T, small, LM_SEED, cpu)
        params_dev = _tree_map(params_cpu, lambda x: x.to(dev))
    rng = np.random.default_rng(LM_SEED)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (c["batch"], c["prompt_len"] + c["steps"])
    ).astype(np.int32))
    errs, t0 = [], time.perf_counter()
    with torch.inference_mode():
        runs = []
        for params, where in ((params_cpu, cpu), (params_dev, dev)):
            t = toks.to(where)
            more = {k: torch.from_numpy(a).to(where, torch.bfloat16)
                    for k, a in extras.items()}
            lg, caches = T.prefill(small, params, {
                "tokens": t[:, :c["prompt_len"]], **more},
                s_max or c["s_max"])
            out = [lg]
            for i in range(c["steps"]):
                p = c["prompt_len"] + i
                lg, caches = T.decode_step(small, params, caches,
                                           {"tokens": t[:, p:p + 1]})
                out.append(lg[:, 0])
            runs.append([x.cpu() for x in out])
    for want, got in zip(*runs):
        check(bool(torch.isfinite(got).all()), "lm card logits not finite")
        errs.append(_lm_rel(want, got, cfg.vocab))
    check(max(errs) <= LM_TOL, f"lm card vs CPU: rel {max(errs)} (prefill, "
          f"then each step: {errs})")
    del params_dev
    return {"layers": small.n_layers, "batch": c["batch"],
            "prompt_len": c["prompt_len"], "decode_steps": c["steps"],
            ("card" if init_on_card else "cpu") + "_init_s": init_s,
            "wall_s": time.perf_counter() - t0,
            "rel_err_prefill": errs[0], "rel_err_decode_max": max(errs[1:]),
            "tolerance_rel": LM_TOL}


def _lm_replay(torch, rt, T, cfg, params, toks, s, extras=None,
               s_max=None, record=None):
    """forward_train over toks, then prefill of its first s tokens and a
    decode step per later token: (forward logits, [prefill and each
    step's logits], [B5 launches of the forward, prefill, each step]).
    `extras` go with the forward and the prefill; `record` (a dict)
    takes the B5 calls of the prefill and the first decode step."""
    ops = rt.ops
    extras = extras or {}
    launches = []
    with torch.inference_mode():
        ops.reset_launches()
        full = T.forward_train(cfg, params, {"tokens": toks, **extras})
        launches.append(ops.LAUNCHES["flash_attention"])
        ops.reset_launches()
        with _b5_recorder(ops, record, "prefill"):
            lg, caches = T.prefill(cfg, params, {"tokens": toks[:, :s],
                                                 **extras},
                                   s_max or LM_SERVE["s_max"])
        launches.append(ops.LAUNCHES["flash_attention"])
        steps = [lg]
        for t in range(s, toks.shape[1]):
            ops.reset_launches()
            with _b5_recorder(ops, record if t == s else None, "decode"):
                lg, caches = T.decode_step(cfg, params, caches,
                                           {"tokens": toks[:, t:t + 1]})
            launches.append(ops.LAUNCHES["flash_attention"])
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
    return full, steps, launches


def _lm_teacher_forced(torch, rt, T, cfg, params, prompts, generated, dev):
    """(c) The served tokens fed back: forward_train over prompt +
    generated against prefill and each decode step's logits, in bf16 and
    in float32 (the same weights, upcast); B5 launched n_layers times per
    call.  The float32 replay is held to LM_F32_TOL; the bf16 replay to
    LM_TOL or, at this depth, LM_NOISE_FACTOR times the bf16 forward's own
    distance from the float32 forward, whichever is larger."""
    s, new = prompts.shape[1], generated.shape[1]
    toks = torch.from_numpy(np.concatenate(
        [prompts, generated[:, :new - 1]], axis=1)).to(dev)
    n, v = cfg.n_layers, cfg.vocab
    full, steps, launches = _lm_replay(torch, rt, T, cfg, params, toks, s)
    errs, same = [], 0
    for t, lg in enumerate(steps):
        check(bool(torch.isfinite(lg).all()),
              f"lm logits not finite at step {t}")
        errs.append(_lm_rel(full[:, s - 1 + t], lg, v))
        same += int((lg[:, :v].argmax(-1).cpu().numpy()
                     == generated[:, t]).sum())
    params32 = _tree_map(params, lambda x: x.float())
    full32, steps32, launches32 = _lm_replay(torch, rt, T, cfg, params32,
                                             toks, s)
    del params32
    errs32 = [_lm_rel(full32[:, s - 1 + t], lg, v)
              for t, lg in enumerate(steps32)]
    # the bf16 model's own rounding noise at this depth: its forward
    # against the float32 forward, at the compared positions
    noise = _lm_rel(full32[:, s - 1:], full[:, s - 1:], v)
    # and the bf16 serving path's own distance from the float32 forward
    serve_vs32 = max(_lm_rel(full32[:, s - 1 + t], lg, v)
                     for t, lg in enumerate(steps))
    del full, full32, steps, steps32
    for name, got in (("bfloat16", launches), ("float32", launches32)):
        check(all(x == n for x in got), f"B5 launches per call ({name}): "
              f"forward, prefill, decode steps {got}, want {n} each")
    check(max(errs32) <= LM_F32_TOL,
          f"lm teacher forcing in float32: rel {max(errs32)}")
    bound = max(LM_TOL, LM_NOISE_FACTOR * noise)
    check(max(errs) <= bound, f"lm teacher forcing in bf16: rel "
          f"{max(errs)} over {bound} (noise {noise})")
    return {"forward_launches": launches[0], "prefill_launches": launches[1],
            "decode_launches_per_step": sorted(set(launches[2:])),
            "float32_launches_per_call": sorted(set(launches32)),
            "rel_err_prefill": errs[0], "rel_err_decode_max": max(errs[1:]),
            "rel_err_decode": errs[1:],
            "bf16_forward_vs_float32_forward": noise,
            "bf16_prefill_decode_vs_float32_forward_max": serve_vs32,
            "tolerance_rel_bf16": bound,
            "float32_rel_err_prefill": errs32[0],
            "float32_rel_err_decode_max": max(errs32[1:]),
            "tolerance_rel_float32": LM_F32_TOL,
            "replayed_greedy_tokens_equal": same,
            "generated_tokens": int(generated.size)}


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _lm_traced_steps(torch, T, cfg, params, prompts, dev, steps=4):
    """Decode steps after a prefill of the served prompts, 2 warm, then
    `steps` under torch.profiler (device activity): the wall, the device's
    busy time (union of its events), their count and the top ops."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(prompts).to(dev)
    with torch.inference_mode():
        lg, caches = T.prefill(cfg, params, {"tokens": toks},
                               LM_SERVE["s_max"])
        tok = lg.argmax(-1)[:, None].int()
        for _ in range(2):
            lg, caches = T.decode_step(cfg, params, caches, {"tokens": tok})
            tok = lg[:, -1].argmax(-1)[:, None].int()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                lg, caches = T.decode_step(cfg, params, caches,
                                           {"tokens": tok})
                tok = lg[:, -1].argmax(-1)[:, None].int()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events, busy = _device_busy(torch, prof)
    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    return {"steps": steps, "wall_s": wall, "device_events": events,
            "device_events_per_step": events / steps,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "top_device_ops_ms": [[e.key[:60], e.self_device_time_total
                                   / 1e3, e.count] for e in top]}


def phase_lm(torch, rt, dev):
    """LM serving of Yi-9B: (b) card against CPU at 2 layers, then the
    full model: (a) B5 per call, (c) serve() and teacher forcing."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    ops = rt.ops
    cfg = get_config(LM_ARCH)
    out = {"arch": LM_ARCH, "card_vs_cpu": _lm_card_vs_cpu(torch, T, cfg,
                                                           dev)}
    gc.collect()
    params, init_s = _lm_model(torch, T, cfg, LM_SEED, dev)
    n_params = sum(x.numel() for x in _leaves(params))
    out["model"] = {"layers": cfg.n_layers, "d_model": cfg.d_model,
                    "params": n_params, "param_count": cfg.param_count(),
                    "weight_bytes": 2 * n_params, "init_s": init_s}
    out["calls"] = _lm_calls(torch, rt, cfg, params, dev)

    sv = LM_SERVE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve(LM_ARCH, reduced=False, batch=sv["batch"],
                prompt_len=sv["prompt_len"], max_new=sv["max_new"],
                s_max=sv["s_max"], seed=LM_SEED, params=params, device=dev)
    launches = ops.LAUNCHES["flash_attention"]
    decode_launches = ops.LAUNCHES["flash_decode"]
    peak = torch.cuda.max_memory_allocated()
    gen = res["generated"]
    check(gen.shape == (sv["batch"], sv["max_new"])
          and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"lm generated tokens malformed: {gen.shape}")
    check(launches == cfg.n_layers * sv["max_new"],
          f"lm serve made {launches} B5 launches, want "
          f"{cfg.n_layers * sv['max_new']}")
    steps = sv["max_new"] - 1
    # every decode step's calls run the decode body, the prefill's not
    check(decode_launches == cfg.n_layers * steps,
          f"lm serve ran the decode body {decode_launches} times, want "
          f"{cfg.n_layers * steps}")
    out["serve"] = {
        **sv, "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
        "decode_steps": steps, "decode_step_ms": res["decode_s"] / steps * 1e3,
        "tok_per_s": sv["batch"] * sv["max_new"] / res["decode_s"],
        "prefill_tok_per_s": sv["batch"] * sv["prompt_len"]
        / res["prefill_s"],
        "weight_read_bound_step_ms": 2 * n_params / HBM_BYTES_PER_S * 1e3,
        "peak_device_bytes": peak, "launches": launches,
        "decode_launches": decode_launches}
    prompts = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, size=(sv["batch"], sv["prompt_len"])).astype(np.int32)
    out["traced_decode"] = _lm_traced_steps(torch, T, cfg, params, prompts,
                                            dev)
    out["teacher_forcing"] = _lm_teacher_forced(torch, rt, T, cfg, params,
                                                prompts, gen, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- lm_families

class _b5_recorder:
    """While active, keeps a copy of the inputs of the first B5 call of
    each shape in `record` (name -> (q, k, v, causal, kv_len, the other
    keywords)), named by its role in `stage` ("prefill" or "decode");
    launches still count."""

    def __init__(self, ops, record, stage):
        self.ops, self.record, self.stage = ops, record, stage

    def __enter__(self):
        if self.record is None:
            return self
        self.orig = self.ops.flash_attention

        def wrapped(q, k, v, causal=True, kv_len=None, **kw):
            if self.stage == "decode":
                name = "decode" if kv_len is not None else "cross_decode"
            elif causal:
                name = "prefill"
            else:      # the encoder attends over its own frames
                name = "encoder" if q.shape[1] == k.shape[1] else "cross"
            key = (name, tuple(q.shape), tuple(k.shape))
            if name not in self.record and key not in self.record:
                self.record[name] = tuple(x.clone() for x in (q, k, v)) \
                    + (causal, kv_len, kw)
                self.record[key] = True
            return self.orig(q, k, v, causal=causal, kv_len=kv_len, **kw)
        self.ops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.ops.flash_attention = self.orig
        return False


def _b5_per_call(cfg, prefill: bool) -> int:
    """B5 launches of one forward / prefill (True) or one decode step:
    every self-attention layer, plus the encoder's layers (forward and
    prefill) and every decoder layer's cross attention (encoder-decoder)."""
    n = sum(1 for mix, _ in cfg.layer_kinds() if mix == "attn")
    if cfg.kind != "encdec":
        return n
    return 2 * n + (cfg.enc_layers if prefill else 0)


def _family_inputs(torch, cfg, batch, dev):
    """serve()'s prompts and extra inputs, drawn as it draws them: the
    prompts (numpy) and the extras on `dev` (a VLM's zero prefix, an
    encoder's frames from the same generator after the prompts)."""
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab, size=(batch, LM_SERVE[
        "prompt_len"])).astype(np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.kind == "encdec":
        extras["frames"] = torch.from_numpy(rng.normal(
            size=(batch, LM_FRAMES, cfg.d_model))).to(dev, torch.bfloat16)
    return prompts, extras


class _route_recorder:
    """While active, keeps each MoE layer call's expert choice (the
    sorted top-k ids per token, on the host) with its device type, in
    call order."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = self.moe.moe_route

        def wrapped(params, xt, **kw):
            gates, idx = self.orig(params, xt, **kw)
            self.calls.append((xt.device.type, idx.sort(-1).values.cpu()))
            return gates, idx
        self.moe.moe_route = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.moe_route = self.orig
        return False

    def card_vs_cpu(self) -> list:
        """Tokens whose top-k set differs between the CPU's and the
        card's calls, call by call."""
        cpu = [i for d, i in self.calls if d == "cpu"]
        card = [i for d, i in self.calls if d == "cuda"]
        return [int((a != b).any(-1).sum()) for a, b in zip(cpu, card)]

    def decode_vs_forward(self, n_moe: int, batch: int, s_fwd: int,
                          first: int) -> int:
        """Over a `_lm_replay` (forward, prefill, decode steps; n_moe MoE
        layers each): the decode steps' tokens whose top-k set differs
        from the forward's at the same position (step j at forward
        position first + j, of s_fwd per sequence)."""
        fwd = [i for _, i in self.calls[:n_moe]]
        steps = [i for _, i in self.calls[2 * n_moe:]]
        rows = np.arange(batch) * s_fwd
        return sum(int((steps[k][:batch] != fwd[k % n_moe][
            rows + first + k // n_moe]).any(-1).sum())
            for k in range(len(steps)))


def _family_card_vs_cpu(torch, T, arch, cfg, dev):
    """(b) for one family: full width at LM_CPU's 2 layers (2 + 2 for the
    encoder-decoder; the VLM's prefix cut to LM_FAMILY_PREFIX rows), or
    reduced_config where one group or layer is 13-14 B parameters.  The
    weights are made on the card and copied to the CPU.  MoE configs run
    at capacity factor E / k: the two sides route independently, and a
    token routed otherwise near a tie (bf16 noise in the router's input)
    would at 1.25 also move the capacity cut of every later token of its
    experts; the tokens routed otherwise are counted per MoE call."""
    import dataclasses
    from repro_torch.configs import reduced_config
    if arch in LM_FAMILY_REDUCED_CPU:
        small, cut = reduced_config(arch), "reduced_config"
    else:
        kw = {"n_layers": LM_CPU["layers"]}
        if cfg.kind == "encdec":
            kw["enc_layers"] = LM_CPU["layers"]
        if cfg.family == "vlm":
            kw["frontend_len"] = LM_FAMILY_PREFIX
        small = dataclasses.replace(cfg, **kw)
        cut = (f"full width, {small.n_layers} layers"
               + (f" + {small.enc_layers} encoder layers"
                  if cfg.kind == "encdec" else "")
               + (f", prefix {small.frontend_len}"
                  if cfg.family == "vlm" else ""))
    rng = np.random.default_rng(LM_SEED + 2)
    extras = {}
    if small.family == "vlm":
        extras["vision_embeds"] = rng.normal(
            size=(LM_CPU["batch"], small.frontend_len, small.d_model))
    if small.kind == "encdec":
        extras["frames"] = rng.normal(
            size=(LM_CPU["batch"], LM_FRAMES, small.d_model))
    if small.moe_experts:
        small = dataclasses.replace(
            small, capacity_factor=small.moe_experts_padded / small.moe_top_k)
        cut += f", capacity factor {small.capacity_factor}"
    print(f"[lm_families] {arch} card vs CPU: {cut}", flush=True)
    with _route_recorder() as routes:
        out = _lm_card_vs_cpu(torch, T, small, dev, small=small,
                              extras=extras, init_on_card=True,
                              s_max=LM_CPU["s_max"] + small.frontend_len)
    out["cut"] = cut
    if small.moe_experts:
        out["moe_tokens_routed_otherwise_per_call"] = routes.card_vs_cpu()
    return out


def _family_breakdown(torch, T, cfg, params, prompts, extras, dev):
    """One prefill of the served prompts and 2 decode steps, each module
    call below timed on the host between two synchronisations: the Mamba
    mixer (its chunk scan apart), the RWKV time mix (its token loop), and
    the MoE layer (the three expert products apart; the rest is routing,
    the sort-based dispatch and the combine).  Seconds and shares of the
    synchronised prefill and of a decode step."""
    from repro_torch.models import mamba as mb
    from repro_torch.models import moe as mo
    from repro_torch.models import rwkv as rk
    acc, inside = {}, []

    def timed(mod, name, label, only_inside=None):
        orig = getattr(mod, name)

        def fn(*a, **k):
            if only_inside is not None and only_inside not in inside:
                return orig(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inside.append(label)
            try:
                return orig(*a, **k)
            finally:
                inside.pop()
                torch.cuda.synchronize()
                acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
        setattr(mod, name, fn)
        return mod, name, orig

    patches = [timed(mb, "mamba_train", "mamba"),
               timed(mb, "mamba_decode", "mamba"),
               timed(mb, "_scan_chunk", "mamba_scan"),
               timed(rk, "rwkv_time_mix", "rwkv_time_mix"),
               timed(mo, "moe_apply", "moe"),
               timed(mo, "beinsum", "moe_expert_products",
                     only_inside="moe")]
    out = {}
    try:
        toks = torch.from_numpy(prompts).to(dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = T.prefill(cfg, params, {"tokens": toks, **extras},
                                   LM_SERVE["s_max"] + cfg.frontend_len)
            torch.cuda.synchronize()
            out["prefill"] = {"wall_s": time.perf_counter() - t0, **acc}
            acc.clear()
            tok = lg.argmax(-1)[:, None].int()
            t0 = time.perf_counter()
            for _ in range(2):
                lg, caches = T.decode_step(cfg, params, caches,
                                           {"tokens": tok})
                tok = lg[:, -1].argmax(-1)[:, None].int()
            torch.cuda.synchronize()
            out["decode_step"] = {k: v / 2 for k, v in
                                  {"wall_s": time.perf_counter() - t0,
                                   **acc}.items()}
    finally:
        for mod, name, orig in patches:
            setattr(mod, name, orig)
    for part in out.values():
        for k in [k for k in part if k != "wall_s"]:
            part[k + "_share"] = part[k] / part["wall_s"]
        if "moe" in part:
            part["moe_dispatch_s"] = part["moe"] - part.get(
                "moe_expert_products", 0.0)
            part["moe_dispatch_share"] = (part["moe_dispatch_s"]
                                          / part["wall_s"])
    return out


def _family_teacher_forced(torch, rt, T, cfg, params, prompts, generated,
                           extras, record):
    """(c) for one family: the served tokens fed back through
    forward_train, prefill and each decode step, in bf16 (recording B5's
    prefill and first-step calls) and in float32 (`float32_replay`: the
    same weights, every activation float32).  MoE configs run with the
    capacity factor E / k, so that cap >= T and no entry drops in the
    forward (B*S tokens) or a step (B).  Bounds: float32 LM_F32_TOL (the
    hybrid: its own bf16 noise if larger, since decode reads the conv
    tail in bf16); bf16 LM_TOL, or LM_NOISE_FACTOR x the bf16 forward's
    distance from the float32 forward if larger."""
    import dataclasses
    from repro_torch.models.common import float32_replay
    tf_cfg = cfg
    if cfg.moe_experts:
        tf_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.moe_experts_padded / cfg.moe_top_k)
    s, new = prompts.shape[1], generated.shape[1]
    off = cfg.frontend_len if cfg.family == "vlm" else 0
    s_max = LM_SERVE["s_max"] + cfg.frontend_len
    dev = params["embed"]["table"].device
    toks = torch.from_numpy(np.concatenate(
        [prompts, generated[:, :new - 1]], axis=1)).to(dev)
    v = cfg.vocab
    n_moe = sum(1 for _, mlp in cfg.layer_kinds() if mlp == "moe")
    s_fwd = off + toks.shape[1]
    with _route_recorder() as routes:
        full, steps, launches = _lm_replay(torch, rt, T, tf_cfg, params,
                                           toks, s, extras, s_max, record)
    errs, same = [], 0
    for t, lg in enumerate(steps):
        check(bool(torch.isfinite(lg).all()),
              f"{cfg.name} logits not finite at step {t}")
        errs.append(_lm_rel(full[:, off + s - 1 + t], lg, v))
        same += int((lg[:, :v].argmax(-1).cpu().numpy()
                     == generated[:, t]).sum())
    torch.cuda.empty_cache()   # the bf16 replay's blocks, for float32's
    with _route_recorder() as routes32:
        full32, steps32, launches32 = _lm_replay(
            torch, rt, T, tf_cfg, float32_replay(params), toks, s, extras,
            s_max)
    errs32 = [_lm_rel(full32[:, off + s - 1 + t], lg, v)
              for t, lg in enumerate(steps32)]
    noise = _lm_rel(full32[:, off + s - 1:], full[:, off + s - 1:], v)
    del full, full32, steps, steps32
    want = [_b5_per_call(cfg, True)] * 2 \
        + [_b5_per_call(cfg, False)] * (len(launches) - 2)
    for name, got in (("bfloat16", launches), ("float32", launches32)):
        check(got == want, f"{cfg.name} B5 launches per call ({name}): "
              f"forward, prefill, decode steps {got}, want {want}")
    bound32 = LM_F32_TOL
    if cfg.attn_period:                  # the hybrid: a bf16 conv tail
        bound32 = max(LM_F32_TOL, noise)
    check(max(errs32) <= bound32, f"{cfg.name} teacher forcing in float32: "
          f"rel {max(errs32)} over {bound32}")
    bound = max(LM_TOL, LM_NOISE_FACTOR * noise)
    check(max(errs) <= bound, f"{cfg.name} teacher forcing in bf16: rel "
          f"{max(errs)} over {bound} (noise {noise})")
    moe = {}
    if n_moe:
        moe = {"moe_decode_tokens_routed_otherwise": {
            name: r.decode_vs_forward(n_moe, toks.shape[0], s_fwd,
                                      off + s)
            for name, r in (("bfloat16", routes), ("float32", routes32))},
            "moe_decode_tokens_routed": n_moe * toks.shape[0]
            * (len(launches) - 2)}
    return {"capacity_factor": tf_cfg.capacity_factor,
            "float32_replay_layers": cfg.n_layers, **moe,
            "forward_launches": launches[0], "prefill_launches": launches[1],
            "decode_launches_per_step": sorted(set(launches[2:])),
            "rel_err_prefill": errs[0], "rel_err_decode_max": max(errs[1:]),
            "bf16_forward_vs_float32_forward": noise,
            "tolerance_rel_bf16": bound,
            "float32_rel_err_prefill": errs32[0],
            "float32_rel_err_decode_max": max(errs32[1:]),
            "tolerance_rel_float32": bound32,
            "replayed_greedy_tokens_equal": same,
            "generated_tokens": int(generated.size)}


def _family_b5_rows(torch, rt, record):
    """B5 on each recorded call of the served shapes: against its plain
    version (LM_KERNEL_TOL), timed beside its bound, the plain version
    and SDPA."""
    ops, ref = rt.ops, rt.ref
    rows = []
    for name in ("prefill", "decode", "encoder", "cross", "cross_decode"):
        if name not in record:
            continue
        q, k, v, causal, kv_len, kw = record[name]
        # the families' calls have no window and no int8 cache: a decode
        # call's q_offset changes nothing there, and SDPA below is the
        # same function
        check(kw.get("window") is None and kw.get("k_scale") is None,
              f"lm_families {name}: a window or int8 call recorded")
        got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                  **kw)
        want = ref.flash_attention_ref(q, k, v, causal, kv_len, **kw)
        abs_err, rel = _rel(got, want)
        check(got.shape == q.shape and bool(torch.isfinite(got).all()),
              f"lm_families {name}: malformed B5 output")
        check(rel < LM_KERNEL_TOL, f"lm_families {name}: B5 disagrees with "
              f"its plain version, rel {rel}")
        row = {"call": name, "q": list(q.shape), "kv": list(k.shape),
               "kv_len": kv_len, "causal": causal, "max_abs_err": abs_err,
               "rel_err": rel,
               "plain_ms": _time_ms(torch, lambda: ref.flash_attention_ref(
                   q, k, v, causal, kv_len), reps=3, warmup=1)}
        row.update(_flash_timed(torch, ops, q, k, v, causal, want,
                                kv_len=kv_len))
        rows.append(row)
    return rows


def _one_family(torch, rt, T, arch, layers, dev):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    ops = rt.ops
    cfg = get_config(arch)
    out = {"arch": arch,
           "card_vs_cpu": _family_card_vs_cpu(torch, T, arch, cfg, dev)}
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    print(f"[lm_families] {arch}: {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers"
             if cfg.kind == "encdec" else ""), flush=True)
    params, init_s = _lm_model(torch, T, cfg, LM_SEED, dev)
    n_params = sum(x.numel() for x in _leaves(params))
    out["model"] = {"layers": cfg.n_layers,
                    "full_depth_layers": get_config(arch).n_layers,
                    "d_model": cfg.d_model, "params": n_params,
                    "weight_bytes": 2 * n_params, "init_s": init_s}

    sv = LM_SERVE
    s_max = sv["s_max"] + cfg.frontend_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve(arch, reduced=False, batch=sv["batch"],
                prompt_len=sv["prompt_len"], max_new=sv["max_new"],
                s_max=s_max, seed=LM_SEED, params=params, device=dev,
                layers=layers)
    launches = ops.LAUNCHES["flash_attention"]
    decode_launches = ops.LAUNCHES["flash_decode"]
    peak = torch.cuda.max_memory_allocated()
    gen = res["generated"]
    check(gen.shape == (sv["batch"], sv["max_new"])
          and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"{arch} generated tokens malformed: {gen.shape}")
    want = (_b5_per_call(cfg, True)
            + (sv["max_new"] - 1) * _b5_per_call(cfg, False))
    check(launches == want, f"{arch} serve made {launches} B5 launches, "
          f"want {want}")
    steps = sv["max_new"] - 1
    out["serve"] = {
        **sv, "s_max": s_max, "prefill_s": res["prefill_s"],
        "decode_s": res["decode_s"], "decode_steps": steps,
        "decode_step_ms": res["decode_s"] / steps * 1e3,
        "tok_per_s": sv["batch"] * sv["max_new"] / res["decode_s"],
        "prefill_tok_per_s": sv["batch"] * sv["prompt_len"]
        / res["prefill_s"],
        "weight_read_bound_step_ms": 2 * n_params / HBM_BYTES_PER_S * 1e3,
        "peak_device_bytes": peak, "launches": launches,
        "launches_want": want, "decode_launches": decode_launches}
    prompts, extras = _family_inputs(torch, cfg, sv["batch"], dev)
    out["breakdown"] = _family_breakdown(torch, T, cfg, params, prompts,
                                         extras, dev)
    record = {}
    out["teacher_forcing"] = _family_teacher_forced(
        torch, rt, T, cfg, params, prompts, gen, extras, record)
    out["b5_calls"] = _family_b5_rows(torch, rt, record)
    del params, record
    return out


def phase_lm_families(torch, rt, dev):
    """LM serving of the MoE, hybrid, RWKV, encoder-decoder and VLM
    families: one arch each (LM_FAMILIES), (b), (a) and (c) per arch, the
    model freed before the next."""
    import gc
    from repro_torch.models import transformer as T
    out = []
    for arch, layers in LM_FAMILIES:
        t0 = time.perf_counter()
        row = _one_family(torch, rt, T, arch, layers, dev)
        row["wall_s"] = time.perf_counter() - t0
        emit({"phase": "lm_families", "arch": arch, **row})
        out.append({"arch": arch, "launches": row["serve"]["launches"],
                    "wall_s": row["wall_s"]})
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------- train

# B5-bwd against its plain version: (b, sq, h, k, hd, skv, causal).  Yi's
# attention at S=4096 and at train_4k's per-sequence cut (4 x 512),
# seamless' hd 64 (16 / 16 heads: decoder, encoder over 32 frames, cross
# attention over them), internvl2's G = 6 over its 1,024-row prefix + 512,
# and ragged lengths; then the bf16 kernel's tile edges (64 query rows,
# 128 keys): a partial last query and KV tile at G = 8 (129, 191), causal
# with more queries than keys, one key.
TRAIN_BWD_CASES = ((1, 4096, 32, 4, 128, 4096, True),
                   (4, 512, 32, 4, 128, 512, True),
                   (4, 512, 16, 16, 64, 512, True),
                   (4, 32, 16, 16, 64, 32, False),
                   (4, 512, 16, 16, 64, 32, False),
                   (4, 1536, 48, 8, 128, 1536, True),
                   (2, 300, 8, 2, 128, 300, True),
                   (2, 300, 4, 4, 64, 200, False),
                   (2, 129, 16, 2, 128, 129, True),
                   (2, 191, 16, 2, 128, 191, True),
                   (2, 200, 8, 2, 128, 130, True),
                   (2, 100, 8, 2, 64, 1, False))
TRAIN_BWD_TIMED = (0, 1)       # the cases timed, indices of the above
# The trainer's (c) own call, the one each of its steps gives B5 and B5-bwd
# once per layer: q (4, 4096, 32, 128) over k / v (4, 4096, 4, 128), in
# the path's bf16; checked, timed and reported in the kernels line.
TRAIN_BWD_MAIN = (4, 4096, 32, 4, 128, 4096, True)
TRAIN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_LSE_TOL = 1e-5
TRAIN_FWD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}    # the flash phase's
# B5-bwd under a sliding window, (case, window): starcoder2-15b's call (its
# trainer's, one sequence of 8,192 tokens: the band binds for the rows
# past 4,096) and a small odd shape (ragged tiles, a band narrower than a
# KV tile); each in bf16 (timed) and float32.
TRAIN_BWD_WINDOW = (((1, 8192, 48, 4, 128, 8192, True), 4096),
                    ((2, 300, 8, 2, 128, 300, True), 100))


def _visible_pairs(sq, skv, causal, window=None) -> int:
    """Query-key pairs the mask leaves (query i at position i): causal
    keys j <= i, and i - j < window under a window."""
    rows = np.arange(sq)
    hi = np.minimum(rows, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _bwd_work(b, sq, h, k, hd, skv, causal, elem, window=None):
    """(operations, bytes) of one B5-bwd call: S and dP recomputed, dV,
    dK and dQ over the visible pairs (2 FLOPs a multiply-add, 5 products
    of hd each; under a window the band's, S·W − W(W−1)/2 a head for a
    causal square call with S >= W); q, k, v, out, dout and lse read
    once, dq, dk, dv written once."""
    pairs = _visible_pairs(sq, skv, causal, window)
    operations = 10 * b * h * hd * pairs
    bytes_ = elem * (4 * b * sq * h * hd + 4 * b * skv * k * hd) \
        + 4 * b * h * sq
    return operations, bytes_


def _train_bwd_case(torch, rt, gen, case, dtype, timed=False, window=None):
    """One B5-bwd case (under ``window``, if given): against its plain
    version, two launches bit-equal, (timed) beside its bound, the plain
    version and SDPA's backward (with the band's boolean mask under a
    window)."""
    ops, ref = rt.ops, rt.ref
    b, sq, h, k, hd, skv, causal = case
    q, kk, v = _qkv(torch, gen, b, sq, h, k, hd, skv, dtype)
    do = torch.randn(q.shape, device=gen.device, generator=gen).to(dtype)
    w = {"window": window}
    out, lse = ops.flash_attention_fwd(q, kk, v, causal, **w)
    got = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal, **w)
    want = ref.flash_attention_bwd_ref(q, kk, v, do, causal, **w)
    name = str(dtype).replace("torch.", "")
    row = {"shape": [b, sq, h, k, hd, skv], "causal": causal, "dtype": name,
           "window": window}
    for label, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        check(g_.dtype == dtype and g_.shape == w_.shape
              and bool(torch.isfinite(g_).all()),
              f"B5-bwd {label} malformed at {row}")
        abs_err, rel = _rel(g_, w_)
        check(rel <= TRAIN_BWD_TOL[name], f"B5-bwd {label} disagrees with "
              f"its plain version at {row}: rel {rel}")
        row[f"{label}_max_abs_err"], row[f"{label}_rel_err"] = abs_err, rel
    del want
    again = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal, **w)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"two B5-bwd launches differ at {row}")
    row["repeat_bit_equal"] = True
    del got, again
    if not timed:
        return row
    row["ms"] = _time_ms(torch, lambda: ops.flash_attention_bwd(
        q, kk, v, out, do, lse, causal, **w), reps=10, warmup=2)
    row["plain_ms"] = _time_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, kk, v, do, causal, **w), reps=2, warmup=1)
    # SDPA's backward (yardstick only): fwd + bwd minus fwd; under a
    # window with the band as a boolean mask (is_causal cannot say it)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, kk, v))
    dot = do.transpose(1, 2).contiguous()
    mask = {"is_causal": causal}
    if window is not None:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        band = i - j < window
        mask = {"attn_mask": band & (j <= i) if causal else band}

    def fwd_bwd():
        o = sdpa(qt, kt, vt, enable_gqa=True, **mask)
        torch.autograd.grad(o, (qt, kt, vt), dot)
    with torch.no_grad():
        fwd_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                              **mask))
    row["library_ms"] = _time_ms(torch, fwd_bwd) - fwd_ms
    row["library_fwd_ms"] = fwd_ms
    operations, bytes_ = _bwd_work(b, sq, h, k, hd, skv, causal,
                                   q.element_size(), window)
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row.update({"operations": operations, "bytes": bytes_,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "achieved_TFLOPs": operations / (row["ms"] * 1e-3) / 1e12})
    return row


def _bwd_back_to_back(torch, rt, gen):
    """Two bf16 shapes back to back, then the first again: its bits are
    the first call's, so the tickets and the workspace carry nothing from
    one call to the next."""
    ops = rt.ops
    shapes = (TRAIN_BWD_CASES[9], TRAIN_BWD_CASES[1])
    inputs = []
    for b, sq, h, k, hd, skv, causal in shapes:
        q, kk, v = _qkv(torch, gen, b, sq, h, k, hd, skv, torch.bfloat16)
        do = torch.randn(q.shape, device=gen.device,
                         generator=gen).bfloat16()
        out, lse = ops.flash_attention_fwd(q, kk, v, causal)
        inputs.append((q, kk, v, out, do, lse, causal))
    first = ops.flash_attention_bwd(*inputs[0])
    ops.flash_attention_bwd(*inputs[1])
    again = ops.flash_attention_bwd(*inputs[0])
    check(all(torch.equal(x, y) for x, y in zip(first, again)),
          "B5-bwd: a call after another shape changes the bits")
    return {"shapes": [list(c[:6]) for c in shapes], "bit_equal": True}


def _train_lse(torch, rt, gen, case, dtype, timed=False):
    """B5 with lse gives the bits of B5 without it; lse within
    TRAIN_LSE_TOL of the plain logsumexp; (timed) B5 with lse, the
    training forward, beside its bound, the plain version and SDPA."""
    ops, ref = rt.ops, rt.ref
    b, sq, h, k, hd, skv, causal = case
    q, kk, v = _qkv(torch, gen, b, sq, h, k, hd, skv, dtype)
    with torch.no_grad():
        plain = ops.flash_attention(q, kk, v, causal=causal)
    out, lse = ops.flash_attention_fwd(q, kk, v, causal)
    check(torch.equal(out, plain), f"B5's output changes when it writes lse "
          f"at {case} {dtype}")
    err = float((lse - ref.attention_lse_ref(q, kk, causal)).abs().max())
    check(err <= TRAIN_LSE_TOL, f"B5's lse off the plain logsumexp by {err} "
          f"at {case} {dtype}")
    row = {"shape": list(case[:6]), "causal": causal,
           "dtype": str(dtype).replace("torch.", ""), "bits_equal": True,
           "lse_max_abs_err": err}
    if not timed:
        return row
    del plain, out, lse
    want = ref.flash_attention_ref(q, kk, v, causal)
    got, _ = ops.flash_attention_fwd(q, kk, v, causal)
    row["max_abs_err"], row["rel_err"] = _rel(got, want)
    check(row["rel_err"] < TRAIN_FWD_TOL[row["dtype"]], f"B5 with lse "
          f"disagrees with its plain version at {case}: {row['rel_err']}")
    del got, want
    row["ms"] = _time_ms(torch, lambda: ops.flash_attention_fwd(
        q, kk, v, causal))
    row["plain_ms"] = _time_ms(torch, lambda: ref.flash_attention_ref(
        q, kk, v, causal), reps=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, v))
    row["library_ms"] = _time_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    # QK^T and PV over the visible pairs; q, k, v read once, the output
    # and lse written once
    rows = np.arange(1, sq + 1)
    pairs = int(np.minimum(rows, skv).sum()) if causal else sq * skv
    operations = 4 * b * h * hd * pairs
    bytes_ = q.element_size() * (2 * q.numel() + 2 * kk.numel()) \
        + 4 * b * h * sq
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row.update({"operations": operations, "bytes": bytes_,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "achieved_TFLOPs": operations / (row["ms"] * 1e-3) / 1e12})
    return row


def _train_kernels(torch, rt, dev):
    """(a) At the trainer's call (TRAIN_BWD_MAIN, bf16): B5-bwd against
    its plain version, two launches bit-equal, timed, with its device time
    per launch; B5 with lse against B5 without it and the plain
    logsumexp, timed.  Then B5-bwd on every case in float32 (TF32 off) and
    bf16, two launches bit-equal in each, timed at TRAIN_BWD_TIMED in
    bf16; the window cases (TRAIN_BWD_WINDOW) likewise, each timed in
    bf16; two shapes back to back; B5's lse."""
    gen = torch.Generator(device=dev).manual_seed(29)
    main = {"bwd": _train_bwd_case(torch, rt, gen, TRAIN_BWD_MAIN,
                                   torch.bfloat16, timed=True)}
    torch.cuda.empty_cache()
    main["fwd"] = _train_lse(torch, rt, gen, TRAIN_BWD_MAIN, torch.bfloat16,
                             timed=True)
    torch.cuda.empty_cache()
    cases = []
    for i, case in enumerate(TRAIN_BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_train_bwd_case(
                torch, rt, gen, case, dtype,
                timed=(i in TRAIN_BWD_TIMED and dtype == torch.bfloat16)))
            torch.cuda.empty_cache()
    window = []
    for case, w in TRAIN_BWD_WINDOW:
        for dtype in (torch.bfloat16, torch.float32):
            window.append(_train_bwd_case(torch, rt, gen, case, dtype,
                                          timed=dtype == torch.bfloat16,
                                          window=w))
            torch.cuda.empty_cache()
    lse = [_train_lse(torch, rt, gen, TRAIN_BWD_CASES[0], torch.bfloat16),
           _train_lse(torch, rt, gen, TRAIN_BWD_CASES[6], torch.float32),
           _train_lse(torch, rt, gen, TRAIN_BWD_CASES[7], torch.bfloat16)]
    return {"main": main, "cases": cases, "window": window, "lse": lse,
            "back_to_back": _bwd_back_to_back(torch, rt, gen),
            "tolerance_rel": TRAIN_BWD_TOL,
            "lse_tolerance_abs": TRAIN_LSE_TOL,
            "timed": [c for c in cases if "ms" in c]}


# The train phase's trainer (c): Yi-9B at full width cut to TRAIN_LAYERS of
# its 48 layers (remat="full", the config's), B x S = TRAIN_BATCH x
# TRAIN_SEQ (train_4k's sequence; its global batch of 256 cut to 4),
# TRAIN_STEPS steps of synthetic data from LM_SEED; (b) runs LM_CPU's 2
# layers at TRAIN_CPU_BATCH x TRAIN_CPU_SEQ on both sides; (d) the
# reference's tests/test_train_loop.py runs at reduced_config("yi-9b").
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 6
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 256
TRAIN_STEP_IDX = 5          # the compared step: warmup's end, lr = peak;
                            # the shared warm step is the one before it
TRAIN_CPU_TOL = {"float32": {"loss": 1e-5, "grads": 1e-4, "params": 1e-4},
                 "bfloat16": {"loss": LM_TOL, "grads": LM_TOL,
                              "params": LM_TOL}}


def _tree_leaves_named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves_named(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _train_card_vs_cpu(torch, dev, arch=LM_ARCH, overrides=None,
                       seq=TRAIN_CPU_SEQ, dtypes=("float32", "bfloat16"),
                       init_on_card=False):
    """(b) One make_train_step step of ``arch`` (Yi-9B; (e): starcoder2-15b
    with ``overrides``' window) at full width and 2 layers on
    the card and on the CPU, in float32 (TF32 off) and bf16, from one
    state: the seed's weights after a shared warm step, made once on the
    card and copied to the CPU bit for bit.  The warm step runs the
    compared batch reversed (rows and positions: the same tokens, so
    every embedding row the compared step reads has non-zero moments).
    Gated (max abs diff / max abs): the loss, every gradient leaf, and
    the card step's own parameters against the CPU's AdamW fed the card
    step's gradients (the same state and lr: the lr, clip and update the
    card step composes).  The parameters end to end against the CPU
    step's are reported: Adam divides by the gradient's scale, so an
    element whose gradient is near 0 in both steps moves by a share of lr
    that the two sides' rounding of that gradient decides."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    from repro_torch.optim import adamw_update
    from repro_torch.train import steps as S
    cfg = dataclasses.replace(get_config(arch), n_layers=LM_CPU["layers"],
                              **(overrides or {}))
    cpu = torch.device("cpu")
    # the seed's weights, drawn on the CPU ((b): its gates' readings
    # depend on the warm state's bits) or on the card ((e): the draw of
    # starcoder2-15b's width is much of (e)'s time on the CPU)
    base = init_from_specs(T.model_specs(cfg), LM_SEED,
                           device=dev if init_on_card else cpu)
    host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq,
                              global_batch=TRAIN_CPU_BATCH,
                              seed=LM_SEED).next_batch()
    warm = {k: np.ascontiguousarray(v[::-1, ::-1]) for k, v in host.items()}
    step, *_ = S.make_train_step(cfg, None, "train_4k", peak_lr=1e-3,
                                 warmup=TRAIN_STEP_IDX, donate=False,
                                 keep_grads=True)
    out = {"arch": arch, "layers": cfg.n_layers, "window": cfg.window,
           "batch": TRAIN_CPU_BATCH, "seq": seq,
           "step_idx": TRAIN_STEP_IDX}
    for name in dtypes:
        dtype = getattr(torch, name)
        tol = TRAIN_CPU_TOL[name]
        p0 = _tree_map(base, lambda x: x.to(dev, dtype))
        p1, o1, _ = step(p0, S.init_opt_state(cfg, p0),
                         {k: torch.from_numpy(v).to(dev)
                          for k, v in warm.items()}, TRAIN_STEP_IDX - 1)
        del p0
        runs = []
        for where in (cpu, dev):
            params = _tree_map(p1, lambda x: x.to(where, copy=True))
            opt = type(o1)(*(_tree_map(x, lambda y: y.to(where, copy=True))
                             for x in o1))
            batch = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
            t0 = time.perf_counter()
            new, _opt, metrics = step(params, opt, batch, TRAIN_STEP_IDX)
            loss = float(metrics["loss"])
            runs.append((loss, metrics.pop("grads"), new, metrics,
                         time.perf_counter() - t0, params, opt))
            del _opt
        (l_cpu, g_cpu, new_cpu, m_cpu, s_cpu, p_cpu, o_cpu), \
            (l_dev, g_dev, new_dev, m_dev, s_dev, _, _) = runs
        # the CPU's AdamW fed the card step's gradients, from the shared
        # state at the CPU step's lr: what the card step's update must be
        chained, _, _ = adamw_update(_tree_map(g_dev, lambda x: x.cpu()),
                                     o_cpu, p_cpu, float(m_cpu["lr"]))
        del p_cpu, o_cpu
        check(np.isfinite(l_dev), f"train card loss not finite ({name})")
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        # every comparison runs on the card, the CPU's trees copied over
        grad_rel = {}
        for (path, a), (_, b) in zip(_tree_leaves_named(g_cpu),
                                     _tree_leaves_named(g_dev)):
            check(bool(torch.isfinite(b).all()), f"grad {path} not finite")
            a = a.to(dev)
            grad_rel[path] = _rel(b, a)[1] if a.abs().max() > 0 \
                else float(b.abs().max())
        param_rel, e2e_rel, upd_rel, flipped, over = {}, {}, 0.0, 0, 0
        for (path, c), (_, b), (_, a), (_, p) in zip(
                _tree_leaves_named(new_cpu), _tree_leaves_named(new_dev),
                _tree_leaves_named(chained), _tree_leaves_named(p1)):
            c, b, p = c.to(dev).float(), b.float(), p.float()
            check(bool(torch.isfinite(b).all()), f"param {path} not finite")
            param_rel[path] = _rel(b, a.to(dev))[1]
            e2e_rel[path] = _rel(b, c)[1]
            upd_rel = max(upd_rel, float((b - c).abs().max()
                                         / max(float((c - p).abs().max()),
                                               1e-30)))
            flipped += int(((b - p) * (c - p) < 0).sum())
            over += int(((b - c).abs() > tol["params"] * c.abs().max()).sum())
        g_worst = max(grad_rel, key=grad_rel.get)
        p_worst = max(param_rel, key=param_rel.get)
        e_worst = max(e2e_rel, key=e2e_rel.get)
        out[name] = {"loss_cpu": l_cpu, "loss_card": l_dev,
                     "loss_rel": loss_rel,
                     "grad_norm_cpu": float(m_cpu["grad_norm"]),
                     "grad_norm_card": float(m_dev["grad_norm"]),
                     "lr": float(m_cpu["lr"]),
                     "grads_rel_max": grad_rel[g_worst],
                     "grads_rel_worst_leaf": g_worst,
                     "params_rel_max": param_rel[p_worst],
                     "params_rel_worst_leaf": p_worst,
                     "params_end_to_end_rel_max": e2e_rel[e_worst],
                     "params_end_to_end_worst_leaf": e_worst,
                     "params_end_to_end_over_tolerance": over,
                     "update_rel_max": upd_rel,
                     "update_sign_differs": flipped,
                     "cpu_step_s": s_cpu, "card_step_s": s_dev,
                     "tolerance": tol}
        check(loss_rel <= tol["loss"], f"train card vs CPU loss ({name}): "
              f"{l_dev} against {l_cpu}, rel {loss_rel}")
        check(grad_rel[g_worst] <= tol["grads"], f"train card vs CPU grads "
              f"({name}): {g_worst} rel {grad_rel[g_worst]}")
        check(param_rel[p_worst] <= tol["params"], f"train card step's "
              f"parameters vs the CPU's AdamW on its gradients ({name}): "
              f"{p_worst} rel {param_rel[p_worst]}")
        del runs, new_cpu, new_dev, g_cpu, g_dev, p1, o1, chained
    return out


def _product_params(params) -> int:
    """Parameters of the matrix products: every group's attention and MLP
    matrices and the LM head; the embedding is a gather."""
    n = params["lm_head"]["table"].numel()
    for layer in params["groups"].values():
        for sub in ("attn", "mlp"):
            n += sum(x.numel() for x in _leaves(layer.get(sub, {})))
    return n


# B5-bwd's bf16 launches -> the fragment of their kernels' names.
BWD_LAUNCH_BINS = (("delta", "delta_kernel"), ("main", "bwd_wgmma"),
                   ("dq_cast", "dq_cast"))
# Kernel-name fragments -> the training layer a traced step's device time
# is binned under; the rest is elementwise work: norms, RoPE, SwiGLU, the
# loss over the logits, AdamW, casts and copies.
TRAIN_KERNEL_BINS = (("B5-bwd", tuple(f for _, f in BWD_LAUNCH_BINS)),
                     ("B5", ("flash_wgmma",)),
                     ("products (cuBLAS)", ("gemm", "nvjet", "xmma",
                                            "cutlass")))


def _train_traced_step(torch, cfg, params, opt_state, dev):
    """One more train step (donated, the run's state) under torch.profiler
    (device activity): its wall, the device's busy time (union of its
    events) and idle share, device milliseconds per TRAIN_KERNEL_BINS
    layer, B5-bwd's per launch (BWD_LAUNCH_BINS: delta, the main pass,
    dQ's cast; the mean over the step's calls, each the trainer's own)
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.train import steps as S
    step, *_ = S.make_train_step(cfg, None, "train_4k", peak_lr=1e-3,
                                 warmup=5, donate=True)
    host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH,
                              seed=LM_SEED + 1).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step(params, opt_state, batch, TRAIN_STEPS)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(np.isfinite(loss), "train: the traced step's loss is not finite")
    events, busy = _device_busy(torch, prof)
    bins: dict = {}
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    for e in timed:
        name = next((b for b, frags in TRAIN_KERNEL_BINS
                     if any(f in e.key for f in frags)), "elementwise")
        bins[name] = bins.get(name, 0.0) + e.self_device_time_total / 1e3
    by_launch = {}
    for n, frag in BWD_LAUNCH_BINS:
        hits = [e for e in timed if frag in e.key]
        calls = sum(e.count for e in hits)
        check(calls == TRAIN_LAYERS, f"train: the traced step shows "
              f"{calls} B5-bwd {n} launches, want {TRAIN_LAYERS}")
        by_launch[n] = sum(e.self_device_time_total for e in hits) \
            / 1e3 / calls
    top = sorted(timed, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall, "device_events": events,
            "device_ms_by_layer": bins, "b5_bwd_ms_by_launch": by_launch,
            "top_device_ops_ms": [[e.key[:60], e.self_device_time_total
                                   / 1e3, e.count] for e in top]}


def _train_run(torch, rt, dev):
    """(c) The trainer through launch.train.run on the card: Yi-9B at full
    width, TRAIN_LAYERS layers, remat full, TRAIN_BATCH x TRAIN_SEQ,
    TRAIN_STEPS steps; launch counts reset just before, read just
    after; then one more step traced."""
    import dataclasses
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    ops = rt.ops
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(LM_ARCH, reduced=False, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
              global_batch=TRAIN_BATCH, seed=LM_SEED, log_every=1,
              device=dev, layers=TRAIN_LAYERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b5, b5_bwd = (ops.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_attention_bwd"))
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = res["losses"], res["grad_norms"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite,
                                                 losses + gnorms)),
          f"train: a loss or grad norm not finite: {losses} {gnorms}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 1.0,
          f"train: first loss {losses[0]}, ln(vocab) {math.log(cfg.vocab)}")
    check(b5 == 2 * TRAIN_LAYERS * TRAIN_STEPS
          and b5_bwd == TRAIN_LAYERS * TRAIN_STEPS,
          f"train: B5 {b5} and B5-bwd {b5_bwd} launches in {TRAIN_STEPS} "
          f"steps, want {2 * TRAIN_LAYERS} and {TRAIN_LAYERS} a step")
    n_prod = _product_params(res["params"])
    n_all = sum(x.numel() for x in _leaves(res["params"]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    flops = 6 * n_prod * tokens + 12 * TRAIN_LAYERS * cfg.n_heads \
        * cfg.head_dim * pairs * TRAIN_BATCH
    step_s, lrs = res["step_s"], res["lrs"]
    med = float(np.median(step_s[1:]))
    traced = _train_traced_step(torch, dataclasses.replace(
        cfg, n_layers=TRAIN_LAYERS), res["params"], res["opt_state"], dev)
    del res
    return {"layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "remat": cfg.remat, "steps": TRAIN_STEPS, "losses": losses,
            "grad_norms": gnorms, "lrs": lrs, "step_s": step_s,
            "params": n_all, "product_params": n_prod,
            "first_step_s": step_s[0], "median_step_s": med,
            "tokens_per_s": tokens / med, "model_flops_per_step": flops,
            "model_TFLOPs": flops / med / 1e12,
            "model_flops_share_of_989": flops / med / BF16_OPS_PER_S,
            "peak_device_bytes": peak, "run_wall_s": wall,
            "b5_launches_per_step": b5 / TRAIN_STEPS,
            "b5_bwd_launches_per_step": b5_bwd / TRAIN_STEPS,
            "b5_launches": b5, "b5_bwd_launches": b5_bwd,
            "traced_step": traced}


def _train_reference_checks(torch, dev):
    """(d) The reference's tests/test_train_loop.py runs on the card at
    reduced_config("yi-9b") (hd 64: B5 and B5-bwd): the loss falls, and
    an interrupted and resumed run ends on the uninterrupted run's
    parameters, bit for bit."""
    import shutil
    import tempfile
    from repro_torch.launch.train import run
    t0 = time.perf_counter()
    out = run("yi-9b", steps=30, seq_len=64, global_batch=8, log_every=100,
              peak_lr=3e-3, device=dev)
    losses = out["losses"]
    check(min(losses) < losses[0] - 0.5,
          f"train (d): the loss did not fall: {losses[0]} -> {min(losses)}")
    learn_s = time.perf_counter() - t0
    common = dict(arch="yi-9b", seq_len=32, global_batch=4, log_every=100,
                  device=dev)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        t0 = time.perf_counter()
        ref = run(steps=8, **common)
        run(steps=4, ckpt_dir=str(tmp / "ck"), save_every=4, **common)
        resumed = run(steps=8, ckpt_dir=str(tmp / "ck"), save_every=4,
                      resume=True, **common)
        restart_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(resumed["final_step"] == 8, "train (d): resumed run ended at "
          f"step {resumed['final_step']}")
    differ = [p for (p, a), (_, b) in zip(
        _tree_leaves_named(ref["params"]),
        _tree_leaves_named(resumed["params"])) if not torch.equal(a, b)]
    check(not differ, f"train (d): resumed parameters differ from the "
          f"uninterrupted run's in {differ}")
    return {"learn": {"first_loss": losses[0], "min_loss": min(losses),
                      "last_loss": losses[-1], "steps": len(losses),
                      "wall_s": learn_s},
            "restart": {"bit_equal_leaves": sum(1 for _ in _tree_leaves_named(
                ref["params"])), "wall_s": restart_s}}


# The train phase's window trainer (f): starcoder2-15b at full width with
# its own sliding window (4,096), one sequence of TRAIN_SC_SEQ tokens (the
# band binds past row 4,096), cut to TRAIN_SC_LAYERS of its 40 layers:
# the one-device dry run of this step (launch/dryrun.py's tracer) reckons
# 23.7 GB at 2 layers and 8.2 GB more a layer, and the card held Yi-9B's
# trainer 1.13x over its reckoning (42.6 GB, PR 29, against 37.6), so 6
# layers (56.5 GB reckoned) leave room that 8 (73 GB) would not.  (e)
# holds it to the CPU as (b) does, at 2 layers with the window cut to
# TRAIN_SC_WINDOW over TRAIN_SC_CPU_SEQ-token rows, which bind it, in
# float32 only: the CPU's steps at starcoder2-15b's width (27 s float32,
# 37 s bf16 at these rows, PR 33 call 4) are most of (e), and the
# script's time limit leaves room for one; B5-bwd's bf16 window path is
# held to its plain version in (a) and trains in (f).
TRAIN_SC_ARCH = "starcoder2-15b"
TRAIN_SC_LAYERS, TRAIN_SC_SEQ, TRAIN_SC_STEPS = 6, 8192, 4
TRAIN_SC_WINDOW, TRAIN_SC_CPU_SEQ = 64, 128


def _train_window_run(torch, rt, dev):
    """(f) starcoder2-15b's trainer through launch.train.run: full width,
    its own window, TRAIN_SC_LAYERS layers, 1 x TRAIN_SC_SEQ tokens,
    TRAIN_SC_STEPS steps; every attention call through B5 and B5-bwd with
    the window (launches counted, reset just before, read just after)."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    ops = rt.ops
    cfg = get_config(TRAIN_SC_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(TRAIN_SC_ARCH, reduced=False, steps=TRAIN_SC_STEPS,
              seq_len=TRAIN_SC_SEQ, global_batch=1, seed=LM_SEED,
              log_every=1, device=dev, layers=TRAIN_SC_LAYERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b5, b5_bwd = (ops.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_attention_bwd"))
    losses, gnorms = res["losses"], res["grad_norms"]
    check(len(losses) == TRAIN_SC_STEPS and all(map(math.isfinite,
                                                    losses + gnorms)),
          f"train (f): a loss or grad norm not finite: {losses} {gnorms}")
    # starcoder2-15b's random init starts above ln(vocab) (12.0 against
    # 10.8 on the card, where Yi-9B's starts at it); the steps must lower
    # it
    check(min(losses[1:]) < losses[0], f"train (f): the loss did not fall "
          f"from {losses[0]}: {losses}")
    check(b5 == 2 * TRAIN_SC_LAYERS * TRAIN_SC_STEPS
          and b5_bwd == TRAIN_SC_LAYERS * TRAIN_SC_STEPS,
          f"train (f): B5 {b5} and B5-bwd {b5_bwd} launches in "
          f"{TRAIN_SC_STEPS} steps, want {2 * TRAIN_SC_LAYERS} and "
          f"{TRAIN_SC_LAYERS} a step")
    step_s = res["step_s"]
    med = float(np.median(step_s[1:]))
    del res
    return {"arch": TRAIN_SC_ARCH, "layers": TRAIN_SC_LAYERS,
            "window": cfg.window, "batch": 1, "seq": TRAIN_SC_SEQ,
            "steps": TRAIN_SC_STEPS, "losses": losses, "grad_norms": gnorms,
            "step_s": step_s, "median_step_s": med,
            "tokens_per_s": TRAIN_SC_SEQ / med,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "run_wall_s": wall, "b5_launches": b5,
            "b5_bwd_launches": b5_bwd}


def phase_train(torch, rt, dev):
    """LM training: (a) B5-bwd, (b) card against CPU, (c) the trainer at
    full width, (d) the reference's training-loop checks; under a sliding
    window, (e) starcoder2-15b card against CPU and (f) its trainer."""
    import gc
    out = {"kernels": _train_kernels(torch, rt, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["card_vs_cpu"] = _train_card_vs_cpu(torch, dev)
    out["card_vs_cpu"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["trainer"] = _train_run(torch, rt, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["reference_checks"] = _train_reference_checks(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["window_card_vs_cpu"] = _train_card_vs_cpu(
        torch, dev, TRAIN_SC_ARCH, {"window": TRAIN_SC_WINDOW},
        seq=TRAIN_SC_CPU_SEQ, dtypes=("float32",), init_on_card=True)
    out["window_card_vs_cpu"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["window_trainer"] = _train_window_run(torch, rt, dev)
    return out


# --------------------------------------------------------- train_sharded

# The sharded trainer (train.steps on a DeviceMesh).  (a) One NCCL rank,
# mesh (1, 1): the train phase's cell (Yi-9B at full width, remat full,
# TRAIN_BATCH x TRAIN_SEQ) cut to SHARDED_A_LAYERS layers, for
# SHARDED_A_STEPS steps
# from the trainer's starting state (init_from_specs(LM_SEED)), against
# the one-device step from the same state.  (b) SHARDED_B_MESH of gloo
# ranks sharing cuda:0 (NCCL refuses two ranks on one card): the same
# width cut to SHARDED_B_LAYERS layers, global batch TRAIN_BATCH x
# TRAIN_SEQ, SHARDED_B_STEPS steps, against a one-rank run of the same
# config in this process.  SHARDED_LOCAL is (b)'s per-rank attention
# call: (B / dp, S, H / tp, K / tp, hd, S, causal).  Both runs take step
# indices from SHARDED_WARMUP on, past the warmup, so every step's lr is
# the cosine's (~SHARDED_PEAK_LR) and each gated loss, norm and parameter
# depends on the updates before it (at index 0 the warmup's lr is 0).
# The peak is make_train_step's default.  Adam moves an element whose
# gradient is rounding-sized by +-lr on either run, and bf16 rounds each
# move to whole ulps (4.9e-4 for the 0.02-scale leaves' elements of 0.06
# to 0.12), so the parameter gate (max abs diff over a leaf's max abs,
# LM_TOL) reads a few such ulps over ~0.12: 0.0176 at this peak on an
# H100 80GB HBM3 (700 W); a larger peak moves it past LM_TOL.
SHARDED_A_STEPS = 3
SHARDED_A_LAYERS = 4      # TRAIN_LAYERS (8) until PR 33: the time limit
SHARDED_B_MESH = (2, 2)
SHARDED_B_LAYERS, SHARDED_B_STEPS = 2, 2
SHARDED_LOCAL = (2, 4096, 16, 2, 128, 4096, True)
SHARDED_TRAIN_TIMEOUT_S = 420
SHARDED_PEAK_LR, SHARDED_WARMUP = 3e-4, 5
# (b)'s update gate: per leaf, ||sharded - one rank|| / ||one rank - start||
# of the final parameters, the error of the sharded run's update relative
# to the one-rank run's.  A missing update reads 1, one applied to
# another rank's slice about sqrt(2); bf16 rounding and the gradients'
# sign flips where a gradient is rounding-sized read far less.
SHARDED_UPDATE_TOL = 0.25


def _sharded_train_batches(cfg, steps):
    """The trainer's synthetic batches (host numpy), the same on every
    rank."""
    from repro_torch.data import SyntheticLMDataset
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=LM_SEED)
    return [data.next_batch() for _ in range(steps)]


def _sharded_train_steps(torch, step, params, opt, batches, dev):
    """Run ``step`` over ``batches`` (step indices SHARDED_WARMUP, +1,
    ...), each step ending in its loss read: (params, opt, losses, grad
    norms, step s)."""
    losses, norms, step_s = [], [], []
    for i, host in enumerate(batches, start=SHARDED_WARMUP):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        params, opt, m = step(params, opt, batch, i)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    return params, opt, losses, norms, step_s


def _sharded_train_compare(torch, full, want, start) -> dict:
    """``full`` (a gathered tree on the card) against ``want`` (host
    tensors), both run from ``start`` (host tensors), leaf by leaf on the
    card: max abs diff over the leaf's max abs, how many leaves are
    bit-equal, and the update's error ||full - want|| / ||want - start||
    (see SHARDED_UPDATE_TOL) of each leaf that ``want``'s run moved.  A
    leaf it left as it was (a norm's ones, where an update of ~lr is under
    half a bf16 ulp) is listed in ``unmoved``."""
    errs, upd, unmoved, equal = {}, {}, [], 0
    for (name, a), (_, b), (_, s0) in zip(_tree_leaves_named(full),
                                          _tree_leaves_named(want),
                                          _tree_leaves_named(start)):
        a = a.detach().float()
        b = b.to(a.device).float()
        equal += bool(torch.equal(a, b))
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30))
        moved = float(torch.linalg.vector_norm(b - s0.to(a.device).float()))
        if moved > 0:
            upd[name] = float(torch.linalg.vector_norm(a - b)) / moved
        else:
            unmoved.append(name)
    return {"leaves": len(errs), "bit_equal_leaves": equal,
            "max_rel_err": max(errs.values()),
            "worst_leaf": max(errs, key=errs.get),
            "update_rel_err": upd, "max_update_rel_err": max(upd.values()),
            "unmoved": unmoved}


def _sharded_train_rank_a(rank, world, tmp):
    """(a) One NCCL rank: the one-device step and the sharded step on a
    (1, 1) mesh, each from the trainer's starting state."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    from repro_torch.parallel import make_mesh
    from repro_torch.train import steps as S
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=SHARDED_A_LAYERS)
    batches = _sharded_train_batches(cfg, SHARDED_A_STEPS)
    kw = dict(peak_lr=SHARDED_PEAK_LR, warmup=SHARDED_WARMUP, donate=True)
    params = init_from_specs(T.model_specs(cfg), LM_SEED, device=dev)
    start = _tree_map(params, lambda x: x.cpu())
    step, *_ = S.make_train_step(cfg, None, "train_4k", **kw)
    params, opt, losses, norms, one_s = _sharded_train_steps(
        torch, step, params, S.init_opt_state(cfg, params), batches, dev)
    one = {"losses": losses, "grad_norms": norms, "step_s": one_s}
    want = _tree_map(params, lambda x: x.cpu())
    del params, opt, step
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    step, rules, psh, osh = S.make_train_step(cfg, mesh, "train_4k", **kw)
    params = S.shard_tree(_tree_map(start, lambda x: x.to(dev)), psh)
    opt = S.init_opt_state(cfg, params, osh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, opt, losses, norms, sh_s = _sharded_train_steps(
        torch, step, params, opt, batches, dev)
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention",
                                             "flash_attention_bwd")}
    peak = torch.cuda.max_memory_allocated()
    cmp = _sharded_train_compare(torch, S.gather_tree(params), want, start)
    return {"mesh": [1, 1], "backend": "nccl", "one_device": one,
            "sharded": {"losses": losses, "grad_norms": norms,
                        "step_s": sh_s, "launches": launches,
                        "peak_device_bytes": peak},
            "params": cmp,
            "losses_bit_equal": losses == one["losses"],
            "grad_norms_bit_equal": norms == one["grad_norms"],
            "median_step_s": float(np.median(sh_s[1:])),
            "one_device_median_step_s": float(np.median(one_s[1:])),
            "dispatch_cost_s": float(np.median(sh_s[1:])
                                     - np.median(one_s[1:]))}


def _sharded_train_share(cfg, psh, osh, dp, tp) -> dict:
    """A rank's device bytes, reckoned before the run: its parameter,
    moment and gradient shards (a gradient lives on the parameter's
    layout, then on the moments'), the largest parameter gathered whole
    (the all-gather's output), AdamW's float32 temporaries of the largest
    moment shard (``optim.adamw._update_leaf`` holds six at once),
    remat="full"'s saved group inputs, one layer's recompute and its
    gradients, and the float32 logits of its batch rows and vocab slice
    with their exponentials and gradients."""
    def local(sh, shape):
        dims = list(shape)
        for size, p in zip((dp, tp), sh[1]):
            if p.is_shard():
                dims[p.dim] = -(-dims[p.dim] // size)
        return int(np.prod(dims))
    from repro_torch.models import transformer as T
    from repro_torch.models.common import abstract_from_specs
    shapes = abstract_from_specs(T.model_specs(cfg))
    named = list(_tree_leaves_named(shapes))
    psh_n = dict(_tree_leaves_named(psh))
    osh_n = dict(_tree_leaves_named(osh.m))
    p_loc = sum(local(psh_n[n], x.shape) for n, x in named)
    z_loc = sum(local(osh_n[n], x.shape) for n, x in named)
    largest = max(x.numel() for _, x in named)
    largest_z = max(local(osh_n[n], x.shape) for n, x in named)
    b, s = TRAIN_BATCH // dp, TRAIN_SEQ
    width = max(cfg.d_ff // tp, cfg.n_heads * cfg.head_dim // tp,
                cfg.d_model)
    parts = {"params": 2 * p_loc, "moments": 2 * 4 * z_loc,
             "grads": 2 * p_loc + 2 * z_loc, "gathered_leaf": 2 * largest,
             "adamw_temporaries": 6 * 4 * largest_z,
             "saved_inputs": cfg.n_layers * b * s * cfg.d_model * 2,
             "layer": 8 * b * s * width * 4,
             "logits": 5 * b * s * (cfg.vocab_padded // tp) * 4}
    return {"bytes": sum(parts.values()), "parts": parts}


def _sharded_train_rank_b(rank, world, tmp):
    """(b) One of the gloo ranks sharing cuda:0, mesh SHARDED_B_MESH."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    from repro_torch.parallel import make_mesh
    from repro_torch.train import steps as S
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", 0)
    dp, tp = SHARDED_B_MESH
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=SHARDED_B_LAYERS)
    batches = _sharded_train_batches(cfg, SHARDED_B_STEPS)
    mesh = make_mesh(SHARDED_B_MESH, ("data", "model"), device_type="cuda")
    step, _rules, psh, osh = S.make_train_step(
        cfg, mesh, "train_4k", peak_lr=SHARDED_PEAK_LR,
        warmup=SHARDED_WARMUP, donate=True)
    share = _sharded_train_share(cfg, psh, osh, dp, tp)
    full = init_from_specs(T.model_specs(cfg), LM_SEED, device=dev)
    start = _tree_map(full, lambda x: x.cpu()) if rank == 0 else None
    params = S.shard_tree(full, psh)
    del full
    opt = S.init_opt_state(cfg, params, osh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params, opt, losses, norms, step_s = _sharded_train_steps(
        torch, step, params, opt, batches, dev)
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention",
                                             "flash_attention_bwd")}
    peak = torch.cuda.max_memory_allocated()
    out = {"rank": rank, "losses": losses, "grad_norms": norms,
           "step_s": step_s, "launches": launches,
           "peak_device_bytes": peak, "reckoned_share": share,
           "local_attention": [list(x.to_local().shape) for x in (
               params["groups"]["0"]["attn"]["wq"],
               params["groups"]["0"]["attn"]["wk"])],
           "placements": {n: str(x.placements) for n, x in
                          _tree_leaves_named(params)}}
    full = S.gather_tree(params)
    if rank == 0:
        out["params"] = _sharded_train_compare(
            torch, full, torch.load(Path(tmp) / "one_rank.pt"), start)
    return out


def _sharded_kernel_fields(res, which, name) -> dict:
    """The kernels line's fields of B5 (``fwd``) or B5-bwd (``bwd``) from
    the train_sharded phase: launches in (a) and per rank in (b), and the
    kernel at (b)'s local shapes beside its bound, plain version and
    SDPA."""
    row = res["kernels"][which]
    err = row["max_abs_err"] if which == "fwd" else max(
        row[f"{x}_max_abs_err"] for x in ("dq", "dk", "dv"))
    return {
        "train_sharded_launches": {
            "a": res["a"]["sharded"]["launches"][name],
            "b_per_rank": [r["launches"][name] for r in res["b"]["ranks"]]},
        "train_sharded_local": {
            "shape": row["shape"], "causal": row["causal"],
            "dtype": row["dtype"], "max_abs_err": err,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}}


def _check_moved(which, cmp) -> None:
    """Every matrix leaf moved in the compared run (only a norm's ones may
    stay under half a bf16 ulp)."""
    check(all("norm" in n for n in cmp["unmoved"]),
          f"train_sharded {which}: leaves the run did not move: "
          f"{cmp['unmoved']}")


def phase_train_sharded(torch, rt, dev):
    """Sharded training on the card: (a) one NCCL rank against the
    one-device step, (b) four gloo ranks sharing the card against a
    one-rank run, (c) B5 and B5-bwd at (b)'s local shapes."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    from repro_torch.train import steps as S
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_sharded_"))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (a,) = spawn_ranks(_sharded_train_rank_a, 1, (str(tmp),),
                           backend="nccl", timeout=SHARDED_TRAIN_TIMEOUT_S)
        a["wall_s"] = time.perf_counter() - t0
        # a (1, 1) mesh's collectives are the identity: bit for bit
        check(a["losses_bit_equal"] and a["grad_norms_bit_equal"],
              f"train_sharded (a): losses {a['sharded']['losses']} / grad "
              f"norms {a['sharded']['grad_norms']} against the one-device "
              f"step's {a['one_device']['losses']} / "
              f"{a['one_device']['grad_norms']}")
        check(a["params"]["bit_equal_leaves"] == a["params"]["leaves"],
              f"train_sharded (a): parameters off the one-device step's: "
              f"{a['params']}")
        _check_moved("(a)", a["params"])
        want = {"flash_attention": 2 * SHARDED_A_LAYERS * SHARDED_A_STEPS,
                "flash_attention_bwd": SHARDED_A_LAYERS * SHARDED_A_STEPS}
        check(a["sharded"]["launches"] == want, f"train_sharded (a): "
              f"launches {a['sharded']['launches']}, want {want}")
        out["a"] = a

        # (b): the one-rank run here, then the gloo ranks
        cfg = dataclasses.replace(get_config(LM_ARCH),
                                  n_layers=SHARDED_B_LAYERS)
        batches = _sharded_train_batches(cfg, SHARDED_B_STEPS)
        params = init_from_specs(T.model_specs(cfg), LM_SEED, device=dev)
        step, *_ = S.make_train_step(cfg, None, "train_4k",
                                     peak_lr=SHARDED_PEAK_LR,
                                     warmup=SHARDED_WARMUP, donate=True)
        torch.cuda.reset_peak_memory_stats()
        params, opt, losses, norms, step_s = _sharded_train_steps(
            torch, step, params, S.init_opt_state(cfg, params), batches, dev)
        one = {"losses": losses, "grad_norms": norms, "step_s": step_s,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        torch.save(_tree_map(params, lambda x: x.cpu()), tmp / "one_rank.pt")
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(_sharded_train_rank_b, SHARDED_B_MESH[0]
                            * SHARDED_B_MESH[1], (str(tmp),), backend="gloo",
                            timeout=SHARDED_TRAIN_TIMEOUT_S)
        b_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in ranks:
        check(r["losses"] == ranks[0]["losses"], f"train_sharded (b): rank "
              f"{r['rank']}'s losses {r['losses']} differ from rank 0's")
        check(r["peak_device_bytes"] <= r["reckoned_share"]["bytes"],
              f"train_sharded (b): rank {r['rank']} peaked at "
              f"{r['peak_device_bytes']} B, over its reckoned share "
              f"{r['reckoned_share']}")
        want = {"flash_attention": 2 * SHARDED_B_LAYERS * SHARDED_B_STEPS,
                "flash_attention_bwd": SHARDED_B_LAYERS * SHARDED_B_STEPS}
        check(r["launches"] == want, f"train_sharded (b): rank {r['rank']} "
              f"launched {r['launches']}, want {want}")
        check(r["grad_norms"] == ranks[0]["grad_norms"], f"train_sharded "
              f"(b): rank {r['rank']}'s grad norms {r['grad_norms']} differ "
              f"from rank 0's")
    for what in ("losses", "grad_norms"):
        for x, y in zip(ranks[0][what], one[what]):
            check(abs(x - y) <= LM_TOL * abs(y), f"train_sharded (b): "
                  f"{what} {x} against the one-rank run's {y}")
    got = ranks[0]["params"]
    check(got["max_rel_err"] <= LM_TOL, f"train_sharded (b): gathered "
          f"parameters off the one-rank run's: {got}")
    check(got["max_update_rel_err"] <= SHARDED_UPDATE_TOL, f"train_sharded "
          f"(b): the update off the one-rank run's: {got['update_rel_err']}")
    _check_moved("(b)", got)
    out["b"] = {"mesh": list(SHARDED_B_MESH), "backend": "gloo",
                "device": "cuda:0 (every rank)", "layers": SHARDED_B_LAYERS,
                "one_rank": one, "ranks": ranks, "wall_s": b_wall,
                "median_step_s": float(np.median(
                    [x for r in ranks for x in r["step_s"][1:]])),
                "one_rank_median_step_s": float(np.median(one["step_s"][1:])),
                "params": ranks[0]["params"]}
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(31)
    out["kernels"] = {
        "fwd": _train_lse(torch, rt, gen, SHARDED_LOCAL, torch.bfloat16,
                          timed=True),
        "bwd": _train_bwd_case(torch, rt, gen, SHARDED_LOCAL,
                               torch.bfloat16, timed=True)}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- serve_sharded

# Three mesh cases, each held to a one-device run of the port in this
# process: (a) qwen1.5-32b (int8 cache) at full width and 2 of 64
# layers (16 until the dry run and the window trainer joined the script,
# 4 until the decode phase did: the script's 1,200 s limit), layout (a)
# under decode_32k's rules; (c) jamba-v0.1-52b at 8 of 32 layers (as in
# lm_families), layout (c) under long_500k's: the prompt ends 16 rows before
# the data ranks' boundary, so the decode
# crosses into rank 1's rows, which start with none visible; (hd) yi-9b
# at full width and 2 of 48 layers on (1, 8), layout (b): its 4 KV heads
# do not divide 8, so the cache splits head_dim, and each rank's 4 query
# heads read one KV head, whose visible rows an all-to-all makes whole.
# Each case runs `bf16_steps` in bf16 (the serving dtype's B5 bodies on
# the mesh, timed), then `steps` in float32 over the bf16 weights
# (float32_replay), the run its gate reads.
# The ranks make their shards in turn where `init_in_turns` (the whole
# leaves' float32 draws of four ranks at once outgrew the card at
# qwen1.5-32b's 16 layers: 8.4 GB for its largest), else all at once.
SS_A = {"arch": "qwen1.5-32b", "layers": 2, "mesh": (2, 2), "batch": 4,
        "prompt": 2048, "s_max": 4096, "steps": 32, "bf16_steps": 8,
        "shape": "decode_32k", "init_in_turns": False}
SS_C = {"arch": "jamba-v0.1-52b", "layers": 8, "mesh": (2, 2), "batch": 1,
        "prompt": 2032, "s_max": 4096, "steps": 32, "bf16_steps": 0,
        "shape": "long_500k", "init_in_turns": True}
SS_HD = {"arch": "yi-9b", "layers": 2, "mesh": (1, 8), "batch": 4,
         "prompt": 4088, "s_max": 4096, "steps": 4, "bf16_steps": 4,
         "shape": "decode_32k", "init_in_turns": False}
SS_CASES = {"a": SS_A, "c": SS_C, "hd": SS_HD}
# the float32 mesh runs against the one-device float32 run: a few times
# what an H100 reads at (a) and (c) (7.4e-4 and 5.1e-5)
SS_F32_TOL = 2e-3
# a bf16 mesh run against the one-device float32 run: no further than
# this many times the one-device bf16 run's own distance from it over the
# same steps, or LM_TOL where that is larger
SS_BF16_NOISE_FACTOR = 2.0
# (b) starcoder2-15b at full width on one device, cut to 10 of its 40
# layers (for the script's time limit), past its window; its reduced
# config with the window cut to 64 against the CPU.
SS_B = {"arch": "starcoder2-15b", "layers": 10, "batch": 2, "prompt": 6144,
        "s_max": 8192, "steps": 32}
SS_B_SMALL = {"window": 64, "batch": 2, "prompt": 96, "s_max": 128,
              "steps": 8}
SS_TIMEOUT_S = 600


def _ss_cfg(spec):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    return (dataclasses.replace(cfg, n_layers=spec["layers"])
            if spec.get("layers") else cfg)


def _ss_prompts(cfg, spec, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (spec["batch"], spec["prompt"])
                        ).astype(np.int32)


def _ss_one_device(torch, T, cfg, spec, prompts, dev):
    """The one-device run of a mesh case in this process: prefill and
    SS greedy steps in bf16, its tokens; then the same tokens through the
    same weights in float32 (``float32_replay``), teacher forced, the
    logits the mesh run is held to (host, real vocab), and the bf16
    run's distance from them at each step."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.models.common import float32_replay
    from repro_torch.train import steps as S
    params, init_s = _lm_model(torch, T, cfg, LM_SEED, dev)
    pre, *_ = S.make_prefill_step(cfg, None, spec["shape"],
                                  s_max=spec["s_max"])
    dec, *_ = S.make_decode_step(cfg, None, spec["shape"])
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = pre(params, {"tokens": torch.from_numpy(prompts).to(dev)})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits, toks, step_s = [lg[:, :cfg.vocab].float().cpu()], [], []
    for _ in range(spec["steps"]):
        tok = logits[-1].argmax(-1).to(torch.int32)
        toks.append(tok)
        t0 = time.perf_counter()
        lg, caches = dec(params, caches, {"tokens": tok[:, None].to(dev)})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(lg[:, 0, :cfg.vocab].float().cpu())
    out = {"init_s": init_s, "prefill_s": prefill_s,
           "median_step_s": float(np.median(step_s[1:])),
           "launches": ops.LAUNCHES["flash_attention"],
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    del caches, lg
    toks = torch.stack(toks, 1)
    f32 = float32_replay(params)
    lg, caches = pre(f32, {"tokens": torch.from_numpy(prompts).to(dev)})
    f32_logits = [lg[:, :cfg.vocab].float().cpu()]
    for i in range(spec["steps"]):
        lg, caches = dec(f32, caches, {"tokens": toks[:, i:i + 1].to(dev)})
        f32_logits.append(lg[:, 0, :cfg.vocab].float().cpu())
    out["bf16_vs_float32_by_step"] = [
        _lm_rel(a, b, None) for a, b in zip(f32_logits, logits)]
    out["bf16_vs_float32"] = max(out["bf16_vs_float32_by_step"])
    del params, f32, caches, lg
    gc.collect()
    torch.cuda.empty_cache()
    return toks, torch.stack(f32_logits), out


def _ss_share(cfg, spec, psh, csh) -> dict:
    """A rank's device bytes, reckoned before its run: its parameter and
    cache shards, the largest parameter whole three times over (the
    sharded init makes one leaf at a time: its float32 draw, its bf16
    cast and the rank's shard), and the prefill's activations of its
    batch rows: the residual stream, the MLP's hidden of its ff slice in
    float32 and its heads' q / k / v."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import abstract_from_specs
    dp, tp = spec["mesh"]

    def local(tensor, sh):
        dims = list(tensor.shape)
        for size, p in zip((dp, tp), sh[1]):
            if p.is_shard():
                dims[p.dim] = -(-dims[p.dim] // size)
        return int(np.prod(dims)) * tensor.element_size()

    from repro_torch.models.common import PRODUCT_SUBTREES
    shapes = dict(_tree_leaves_named(abstract_from_specs(T.model_specs(cfg))))
    psh_n = dict(_tree_leaves_named(psh))
    # float32_replay's upcast copies: every leaf outside the groups'
    # product sub-trees
    upcast = [n for n in shapes if not (n.startswith("/groups/") and
                                        n.split("/")[3] in PRODUCT_SUBTREES)]
    caches = T.init_decode_caches(cfg, spec["batch"], spec["s_max"],
                                  abstract=True)
    cache_n = {n: x for n, x in _tree_named_any(caches)
               if hasattr(x, "shape")}
    csh_n = dict(_tree_named_any(csh))
    b = -(-spec["batch"] // dp) if spec["batch"] % dp == 0 else spec["batch"]
    tokens = b * spec["prompt"]
    width = max(cfg.d_ff // tp, cfg.n_heads_padded * cfg.head_dim // tp,
                2 * cfg.d_inner // tp if cfg.d_inner else 0, cfg.d_model)
    parts = {
        "params": sum(local(x, psh_n[n]) for n, x in shapes.items()),
        "float32_replay": sum(2 * local(shapes[n], psh_n[n])
                              for n in upcast),
        "caches": sum(local(x, csh_n[n]) for n, x in cache_n.items()),
        "init_leaf": 3 * max(x.numel() * x.element_size()
                             for x in shapes.values()),
        "prefill_activations": 8 * tokens * width * 4}
    return {"bytes": sum(parts.values()), "parts": parts}


def _tree_named_any(tree, prefix=""):
    """(name, leaf) of a tree of dicts and named tuples (a cache tree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_named_any(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for f in tree._fields:
            yield from _tree_named_any(getattr(tree, f), f"{prefix}{f}/")
    else:
        yield prefix.rstrip("/"), tree


def _ss_mesh_run(torch, cfg, pre, dec, params, want, steps, dev) -> dict:
    """On this rank: the prefill of the one-device run's prompts and
    `steps` of its tokens fed back (teacher forced); each step's logits
    against the one-device float32 replay's, its time, its B5 launches
    and the bytes this rank received through the head_dim all-to-all
    (``parallel.compat.EXCHANGED``)."""
    import hashlib

    from repro_torch.kernels import ops
    from repro_torch.parallel.compat import EXCHANGED, reset_exchanged
    prompts = want["prompts"].to(dev)
    ops.reset_launches()
    reset_exchanged()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = pre(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = [ops.LAUNCHES["flash_attention"]]
    moved = [EXCHANGED["bytes_received"]]
    logits, step_s = [lg[:, :cfg.vocab].float().cpu()], []
    for i in range(steps):
        tok = want["tokens"][:, i:i + 1].to(dev)
        t0 = time.perf_counter()
        lg, caches = dec(params, caches, {"tokens": tok})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(lg[:, 0, :cfg.vocab].float().cpu())
        launches.append(ops.LAUNCHES["flash_attention"])
        moved.append(EXCHANGED["bytes_received"])
    got = torch.stack(logits)
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want["logits"])]
    kv = [c for n, c in _tree_named_any(caches) if n.endswith("/k")]
    return {"prefill_s": prefill_s, "step_s": step_s,
            "median_step_s": float(np.median(step_s[1:])),
            "launches_total": launches[-1], "launches_prefill": launches[0],
            "launches_per_step": [b - a for a, b in zip(launches,
                                                        launches[1:])],
            "exchanged_bytes_prefill": moved[0],
            "exchanged_bytes_per_step": [b - a for a, b in
                                         zip(moved, moved[1:])],
            "max_rel_err": max(errs), "rel_err_by_step": errs,
            "logits_sha256": hashlib.sha256(got.numpy().tobytes())
            .hexdigest(),
            "kv_dtype": str(kv[0].dtype).replace("torch.", "") if kv
            else None,
            "kv_placements": str(tuple(kv[0].placements)) if kv else None,
            "kv_local_shape": list(kv[0].to_local().shape) if kv else None}


def _ss_rank_case(torch, cfg, spec, mesh, tmp, tag, dev):
    """One mesh case on this rank: the sharded init (the ranks in turn
    where the case says),
    `bf16_steps` in bf16, then `steps` in float32 over the bf16 shards
    (``float32_replay``)."""
    import gc

    import torch.distributed as dist

    from repro_torch.models import transformer as T
    from repro_torch.models.common import float32_replay, init_from_specs
    from repro_torch.train import steps as S
    pre, rules, psh, csh = S.make_prefill_step(cfg, mesh, spec["shape"],
                                               s_max=spec["s_max"])
    dec, *_ = S.make_decode_step(cfg, mesh, spec["shape"])
    share = _ss_share(cfg, spec, psh, csh)
    want = torch.load(Path(tmp) / f"{tag}.pt")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    turns = spec["init_in_turns"]
    t0 = time.perf_counter()
    for turn in range(mesh.size() if turns else 1):
        if turn == mesh.get_rank() or not turns:
            params = init_from_specs(T.model_specs(cfg), LM_SEED,
                                     device=dev, shardings=psh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    init_s = time.perf_counter() - t0
    out = {"rank": mesh.get_rank(), "init_s": init_s}
    if spec["bf16_steps"]:
        out["bf16"] = _ss_mesh_run(torch, cfg, pre, dec, params, want,
                                   spec["bf16_steps"], dev)
        gc.collect()
        torch.cuda.empty_cache()
    params = float32_replay(params)
    out["float32"] = _ss_mesh_run(torch, cfg, pre, dec, params, want,
                                  spec["steps"], dev)
    out.update(peak_device_bytes=torch.cuda.max_memory_allocated(),
               reckoned_share=share)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ss_rank(rank, world, tmp, tags):
    """One of the gloo ranks sharing cuda:0: the cases `tags`, which
    share one mesh shape."""
    import os

    # the processes' caching allocators share one card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from repro_torch.kernels import build
    from repro_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", 0)
    mesh = make_mesh(SS_CASES[tags[0]]["mesh"], ("data", "model"),
                     device_type="cuda")
    return {tag: _ss_rank_case(torch, _ss_cfg(SS_CASES[tag]),
                               SS_CASES[tag], mesh, tmp, tag, dev)
            for tag in tags}


def _ss_decode_rows(ref, c, window) -> dict:
    """What a bf16 decode launch of B5 (the decode body) loads with its
    query at kv_len - 1: each (batch, KV head, span of
    ``ref.decode_split``) block the span's whole 64-key tiles below
    kv_len, so each visible tile once per (batch, KV head)."""
    kv_len = c["kv_len"]
    split = ref.decode_split(c["B"], c["H"], c["K"], kv_len, False, window,
                             kv_len - 1)
    chunks = -(-(c["H"] // c["K"]) // ref.DECODE_ROWS)
    spans = [min(e, kv_len) - a for a, e in split.spans()]
    return {"rows": c["B"] * c["K"] * chunks * sum(spans),
            "blocks": c["B"] * c["K"] * chunks * split.splits,
            "max_rows": max(spans)}


def _ss_starcoder(torch, T, dev):
    """(b) starcoder2-15b at full width on one device (SS_B's layers); every
    B5 launch counts the key rows its blocks load (``ops.count_kv_rows``,
    a zeroed 3-int64 buffer a launch), each decode launch's held to the
    window's tiles."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as ops_ref
    from repro_torch.train import steps as S
    cfg = _ss_cfg(SS_B)
    params, init_s = _lm_model(torch, T, cfg, LM_SEED, dev)
    prompts = torch.from_numpy(_ss_prompts(cfg, SS_B, 21)).to(dev)
    pre, *_ = S.make_prefill_step(cfg, None, "decode_32k",
                                  s_max=SS_B["s_max"])
    dec, *_ = S.make_decode_step(cfg, None, "decode_32k")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    with ops.count_kv_rows() as counted:
        t0 = time.perf_counter()
        lg, caches = pre(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = ops.LAUNCHES["flash_attention"]
        finite = bool(torch.isfinite(lg[:, :cfg.vocab]).all())
        step_s, per_step = [], []
        for _ in range(SS_B["steps"]):
            tok = lg[..., :cfg.vocab].reshape(lg.shape[0], -1).argmax(-1)
            before = ops.LAUNCHES["flash_attention"]
            t0 = time.perf_counter()
            lg, caches = dec(params, caches,
                             {"tokens": tok.to(torch.int32)[:, None]})
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(ops.LAUNCHES["flash_attention"] - before)
            finite &= bool(torch.isfinite(lg[..., :cfg.vocab]).all())
    check(finite, "serve_sharded (b): non-finite logits")
    check(per_step == [cfg.n_layers] * SS_B["steps"], f"serve_sharded (b): "
          f"B5 launches per decode step {per_step}, want {cfg.n_layers}")
    check(prefill_launches == cfg.n_layers, f"serve_sharded (b): prefill "
          f"launched {prefill_launches}, want {cfg.n_layers}")
    check(len(counted) == cfg.n_layers * (1 + SS_B["steps"]),
          f"serve_sharded (b): {len(counted)} launches counted their rows")
    prefill_c, decode_c = counted[:cfg.n_layers], counted[cfg.n_layers:]
    for c in decode_c:
        want = _ss_decode_rows(ops_ref, c, cfg.window)
        check({x: c[x] for x in want} == want,
              f"serve_sharded (b): a decode launch at kv_len {c['kv_len']} "
              f"loaded {c}, want {want}")
    first, last = decode_c[0], decode_c[-1]
    out = {"layers": cfg.n_layers, "window": cfg.window,
           "batch": SS_B["batch"], "prompt": SS_B["prompt"],
           "s_max": SS_B["s_max"], "init_s": init_s,
           "prefill_s": prefill_s, "step_s": step_s,
           "median_step_s": float(np.median(step_s[1:])),
           "launches_prefill": prefill_launches,
           "launches_per_step": per_step,
           "rows_loaded_per_decode_launch": {
               "first_step": {x: first[x] for x in ("kv_len", "rows",
                                                    "blocks", "max_rows")},
               "last_step": {x: last[x] for x in ("kv_len", "rows",
                                                  "blocks", "max_rows")}},
           "rows_loaded_per_prefill_launch": {
               "rows": prefill_c[0]["rows"],
               "blocks": prefill_c[0]["blocks"],
               "max_rows": prefill_c[0]["max_rows"]},
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    del params, caches, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out
def _ss_starcoder_small(torch, T, dev):
    """(b)'s gate: reduced starcoder2-15b, its window cut to 64, prefill
    and decode on the card (B5 with the window) against the CPU's plain
    path on the same weights."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops
    sp = SS_B_SMALL
    cfg = dataclasses.replace(reduced_config(SS_B["arch"]),
                              window=sp["window"])
    cpu, _ = _lm_model(torch, T, cfg, LM_SEED, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, (sp["batch"], sp["prompt"] + sp["steps"]))
        .astype(np.int32))
    runs = []
    ops.reset_launches()
    for d in (torch.device("cpu"), dev):
        params = _tree_map(cpu, lambda x: x.to(d))
        with torch.inference_mode():
            lg, caches = T.prefill(cfg, params, {
                "tokens": toks[:, :sp["prompt"]].to(d)}, sp["s_max"])
            seq = [lg]
            for i in range(sp["prompt"], sp["prompt"] + sp["steps"]):
                lg, caches = T.decode_step(cfg, params, caches, {
                    "tokens": toks[:, i:i + 1].to(d)})
                seq.append(lg[:, 0])
        runs.append([x.float().cpu() for x in seq])
    err = max(_lm_rel(w, g, cfg.vocab) for w, g in zip(*runs))
    check(err <= LM_TOL, f"serve_sharded (b): reduced starcoder2-15b with "
          f"window {sp['window']} on the card off the CPU's by {err}")
    want = cfg.n_layers * (1 + sp["steps"])
    check(ops.LAUNCHES["flash_attention"] == want, f"serve_sharded (b): "
          f"the reduced run launched {ops.LAUNCHES['flash_attention']} "
          f"B5, want {want}")
    return {"window": sp["window"], "prompt": sp["prompt"],
            "steps": sp["steps"], "max_rel_err": err, "tol": LM_TOL,
            "launches": want}


def _ss_kernel_row(torch, rt, case, q, k, v, kw, *, lse=False,
                   library=None, library_null=None):
    """B5 at one of the phase's calls against its plain version (on the
    same card tensors), both timed, with its bound: the bytes (q, the
    visible K / V rows it reads and their scales, the output and lse,
    each once) and the operations (QK^T and PV over its visible (query,
    key) pairs), the larger time; SDPA's time where one call computes
    the same function."""
    ops, ref = rt.ops, rt.ref
    b, sq, h, hd = q.shape
    kk = k.shape[2]
    call = ((lambda: ops.flash_attention_fwd(q, k, v, **kw)) if lse
            else (lambda: ops.flash_attention(q, k, v, **kw)))
    got = call()
    got = got[0] if lse else got
    plain = lambda: ref.flash_attention_ref(  # noqa: E731
        q, k, v, kw["causal"], kw.get("kv_len"), window=kw.get("window"),
        q_offset=kw.get("q_offset", 0), k_scale=kw.get("k_scale"),
        v_scale=kw.get("v_scale"))
    want = plain()
    diff, rel = _rel(got, want)
    tol = LM_KERNEL_TOL if q.dtype == torch.bfloat16 else 1e-5
    check(rel <= tol, f"serve_sharded kernels {case}: B5 off its plain "
          f"version by {rel} (max abs {diff})")
    kv_len = kw.get("kv_len") or k.shape[1]
    q_off, window = kw.get("q_offset", 0), kw.get("window")
    pos = np.arange(sq)[:, None] + q_off
    key = np.arange(kv_len)[None, :]
    vis = key <= pos if kw["causal"] else np.ones((sq, kv_len), bool)
    if window is not None:
        vis &= pos - key < window
    pairs = int(vis.sum())
    read_rows = int(vis.any(0).sum())
    elem = 1 if k.dtype == torch.int8 else q.element_size()
    scales = 2 * 2 if k.dtype == torch.int8 else 0
    bytes_ = (2 * q.numel() * q.element_size()
              + b * read_rows * kk * (2 * hd * elem + scales)
              + (b * h * sq * 4 if lse else 0))
    operations = 4 * b * h * hd * pairs
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row = {"case": case, "q": list(q.shape), "kv": list(k.shape),
           "kv_dtype": str(k.dtype).replace("torch.", ""),
           "kw": {n: x for n, x in kw.items() if not torch.is_tensor(x)},
           "max_abs_err": diff, "rel_err": rel, "tol": tol,
           "visible_rows": read_rows, "operations": operations,
           "bytes": bytes_, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "ms": _time_ms(torch, call, reps=10, warmup=2),
           "plain_ms": _time_ms(torch, plain, reps=2, warmup=1)}
    row["library_ms"] = (None if library is None
                         else _time_ms(torch, library, reps=10, warmup=2))
    if library_null is not None:
        row["library_null_reason"] = library_null
    return row


def _ss_sdpa_band(torch, q, k, v, kv_len, q_off, window, causal=True):
    """SDPA over the visible prefix with the boolean band mask (query i at
    q_off + i sees keys p <= it, fewer than ``window`` back)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq = q.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x[:, :kv_len].transpose(1, 2).contiguous() for x in (k, v))
    pos = torch.arange(sq, device=q.device)[:, None] + q_off
    key = torch.arange(kv_len, device=q.device)[None, :]
    mask = key <= pos if causal else torch.ones_like(pos - key, dtype=bool)
    if window is not None:
        mask = mask & (pos - key < window)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _ss_kernels(torch, rt, dev):
    """B5's cases at the phase's calls: the window prefill and decode of
    (b), the int8 decode of (a)'s ranks, the sequence-parallel ranks'
    local calls of (c) with lse, and the local call of the head_dim case
    after its all-to-all."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(32)
    bf16 = torch.bfloat16
    rows = []
    sc = get_config(SS_B["arch"])
    h, kk, hd, w = sc.n_heads_padded, sc.n_kv_padded, sc.head_dim, sc.window
    b, s = SS_B["batch"], SS_B["prompt"]
    q, k, v = _qkv(torch, gen, b, s, h, kk, hd, s, bf16)
    rows.append(_ss_kernel_row(
        torch, rt, "window_prefill", q, k, v, dict(causal=True, window=w),
        library=_ss_sdpa_band(torch, q, k, v, s, 0, w)))
    del q, k, v
    L = SS_B["prompt"] + SS_B["steps"]
    q, k, v = _qkv(torch, gen, b, 1, h, kk, hd, SS_B["s_max"], bf16)
    rows.append(_ss_kernel_row(
        torch, rt, "window_decode", q, k, v,
        dict(causal=True, kv_len=L, window=w, q_offset=L - 1),
        library=_ss_sdpa_band(torch, q, k, v, L, L - 1, w)))
    qc = _ss_cfg(SS_A)
    dp, tp = SS_A["mesh"]
    ha, ka = qc.n_heads_padded // tp, qc.n_kv_padded // tp
    ba, L = SS_A["batch"] // dp, SS_A["prompt"] + SS_A["steps"]
    q, k, v = _qkv(torch, gen, ba, 1, ha, ka, qc.head_dim, SS_A["s_max"],
                   bf16)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    rows.append(_ss_kernel_row(
        torch, rt, "int8_decode", q, k8, v8,
        dict(causal=True, kv_len=L, q_offset=L - 1, k_scale=ks, v_scale=vs),
        library_null="no PyTorch call reads int8 K / V with per-token "
                     "scales"))
    jc = _ss_cfg(SS_C)
    dp, tp = SS_C["mesh"]
    hc, kc = jc.n_heads_padded // tp, jc.n_kv_padded // tp
    half = SS_C["s_max"] // dp
    L = SS_C["prompt"] + SS_C["steps"]
    q, k, v = _qkv(torch, gen, 1, 1, hc, kc, jc.head_dim, half, bf16)
    for r in range(dp):
        kv_len = min(L, (r + 1) * half) - r * half
        rows.append(_ss_kernel_row(
            torch, rt, f"sp_rank{r}_decode_lse", q, k, v,
            dict(causal=True, kv_len=kv_len, q_offset=L - 1 - r * half),
            lse=True, library_null="no PyTorch call returns the "
            "log-sum-exp beside the output"))
    yc = _ss_cfg(SS_HD)
    hb = yc.n_heads // SS_HD["mesh"][1]
    L = SS_HD["prompt"] + SS_HD["steps"]
    q, k, v = _qkv(torch, gen, SS_HD["batch"], 1, hb,
                   _ss_kv_asked(yc, SS_HD), yc.head_dim, SS_HD["s_max"],
                   bf16)
    rows.append(_ss_kernel_row(
        torch, rt, "head_dim_exchange_decode", q, k, v,
        dict(causal=True, kv_len=L, q_offset=L - 1),
        library=_ss_sdpa_band(torch, q, k, v, L, L - 1, None)))
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def _ss_kv_asked(cfg, spec) -> int:
    """The KV heads a rank's query heads read in the head_dim case (the
    model's ``attention._kv_index``): one when they lie in one group."""
    hl = cfg.n_heads_padded // spec["mesh"][1]
    g = cfg.n_heads_padded // cfg.n_kv_padded
    return 1 if g % hl == 0 else hl // g if hl % g == 0 else hl


def _ss_exchange_bytes(cfg, spec, kv_len, elem) -> int:
    """What a rank receives through the head_dim all-to-all at a decode
    step over kv_len rows: per attention layer, K and V, the other ranks'
    head dims of the visible rows of the KV heads it reads."""
    tp = spec["mesh"][1]
    attn = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    return (attn * 2 * (tp - 1) * spec["batch"] * kv_len
            * _ss_kv_asked(cfg, spec) * (cfg.head_dim // tp) * elem)


def _ss_kernel_fields(res) -> dict:
    """The kernels line's fields of B5 from the serve_sharded phase:
    launches on each run's path, the rows its decode blocks loaded, the
    head_dim all-to-all's bytes and the cases at its calls."""
    keys = ("case", "q", "kv", "kv_dtype", "kw", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    hd = res["hd"]["ranks"][0]["bf16"]
    return {
        "serve_sharded_launches": {
            **{f"{tag}_{run}_per_rank": [r[run]["launches_total"]
                                         for r in res[tag]["ranks"]]
               for tag in ("a", "c", "hd") for run in ("bf16", "float32")
               if run in res[tag]["ranks"][0]},
            "b": res["b"]["launches_prefill"]
            + sum(res["b"]["launches_per_step"])},
        "serve_sharded_rows_loaded": res["b"][
            "rows_loaded_per_decode_launch"],
        "serve_sharded_exchange": {
            "bytes_per_rank_step": hd["exchanged_bytes_per_step"],
            "layers": res["hd"]["layers"], "kv_dtype": hd["kv_dtype"]},
        "serve_sharded_cases": [
            {**{k: row.get(k) for k in keys},
             **{k: row[k] for k in row if k.endswith("_reason")}}
            for row in res["kernels"]]}


def _ss_gate(tag, spec, one, rs) -> dict:
    """The gates of mesh case `tag` on its ranks' results `rs`, and its
    summary."""
    cfg = _ss_cfg(spec)
    attn = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    dp = spec["mesh"][0]
    for r in rs:
        check(r["peak_device_bytes"] <= r["reckoned_share"]["bytes"],
              f"serve_sharded ({tag}): rank {r['rank']} peaked at "
              f"{r['peak_device_bytes']} B, over its reckoned share "
              f"{r['reckoned_share']}")
        for run in ("bf16", "float32"):
            if run not in r:
                continue
            got = r[run]
            steps = len(got["launches_per_step"])
            if run == "float32":
                bound = SS_F32_TOL
            else:
                noise = one["bf16_vs_float32_by_step"][:steps + 1]
                bound = max(LM_TOL, SS_BF16_NOISE_FACTOR * max(noise))
            got["bound"] = bound
            check(got["max_rel_err"] <= bound, f"serve_sharded ({tag}) "
                  f"{run}: rank {r['rank']}'s logits off the one-device "
                  f"float32 run's by {got['max_rel_err']} (bound {bound})")
            check(got["logits_sha256"] == rs[0][run]["logits_sha256"],
                  f"serve_sharded ({tag}) {run}: rank {r['rank']}'s logits "
                  f"differ from rank 0's")
            check(got["launches_total"] > 0, f"serve_sharded ({tag}) "
                  f"{run}: rank {r['rank']} launched no B5")
            # (c): data rank 1 starts with no visible row and launches
            # only once the decode crosses into its rows
            cross = spec["s_max"] // dp - spec["prompt"]
            want = ([0] * cross + [attn] * (steps - cross)
                    if tag == "c" and r["rank"] // spec["mesh"][1] else
                    [attn] * steps)
            check(got["launches_per_step"] == want, f"serve_sharded ({tag}) "
                  f"{run}: rank {r['rank']} per-step launches "
                  f"{got['launches_per_step']}, want {want}")
            elem = {"bfloat16": 2, "float32": 4, "int8": 1}[got["kv_dtype"]]
            moved = [_ss_exchange_bytes(cfg, spec, spec["prompt"] + i + 1,
                                        elem) if tag == "hd" else 0
                     for i in range(steps)]
            check(got["exchanged_bytes_prefill"] == 0
                  and got["exchanged_bytes_per_step"] == moved,
                  f"serve_sharded ({tag}) {run}: rank {r['rank']} received "
                  f"{got['exchanged_bytes_per_step']} B a step through the "
                  f"head_dim all-to-all, want {moved}")
    return {**spec, "layers": cfg.n_layers, "one_device": one, "ranks": rs,
            **{f"{run}_max_rel_err": max(r[run]["max_rel_err"] for r in rs)
               for run in ("bf16", "float32") if run in rs[0]},
            **{f"{run}_median_step_s": float(np.median(
                [x for r in rs for x in r[run]["step_s"][1:]]))
               for run in ("bf16", "float32") if run in rs[0]}}


def phase_serve_sharded(torch, rt, dev):
    """Serving on a mesh and B5's window / int8 cases at full width."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as T
    out = {"backend": "gloo", "device": "cuda:0 (every rank)"}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_sharded_"))
    one, ranks, wall = {}, {}, {}
    try:
        for seed, (tag, spec) in enumerate(SS_CASES.items(), 11):
            cfg = _ss_cfg(spec)
            prompts = _ss_prompts(cfg, spec, seed)
            torch.cuda.reset_peak_memory_stats()
            toks, logits, one[tag] = _ss_one_device(
                torch, T, cfg, spec, prompts, dev)
            torch.save({"prompts": torch.from_numpy(prompts),
                        "tokens": toks, "logits": logits},
                       tmp / f"{tag}.pt")
        gc.collect()
        torch.cuda.empty_cache()
        for tags in (("a", "c"), ("hd",)):
            dp, tp = SS_CASES[tags[0]]["mesh"]
            t0 = time.perf_counter()
            res = spawn_ranks(_ss_rank, dp * tp, (str(tmp), tags),
                              backend="gloo", timeout=SS_TIMEOUT_S)
            wall["+".join(tags)] = time.perf_counter() - t0
            for tag in tags:
                ranks[tag] = [r[tag] for r in res]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "serve_sharded_ranks", "one_device": one,
          "ranks": {tag: [{"rank": r["rank"], "peak_device_bytes":
                           r["peak_device_bytes"],
                           **{run: {k: r[run][k] for k in (
                               "max_rel_err", "rel_err_by_step",
                               "launches_per_step", "median_step_s",
                               "exchanged_bytes_per_step", "kv_placements")}
                              for run in ("bf16", "float32") if run in r}}
                          for r in rs] for tag, rs in ranks.items()}})
    for tag, spec in SS_CASES.items():
        out[tag] = _ss_gate(tag, spec, one[tag], ranks[tag])
    out["ranks_wall_s"] = wall
    out["b"] = _ss_starcoder(torch, T, dev)
    out["b"]["reduced_vs_cpu"] = _ss_starcoder_small(torch, T, dev)
    out["kernels"] = _ss_kernels(torch, rt, dev)
    return out


# ----------------------------------------------------------------- audit

def _audit_rows(report) -> list:
    return [[r["stage"], r["backend"], r["bucket"], r["cache"], r["traces"]]
            for r in report["contexts"]]


def phase_audit(torch, rt, dev, g, fused):
    """The static-analysis gate and the plan audit on the card."""
    import os
    from repro_torch.analysis import TraceAudit, audit_workload, run_workload
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.kernels import build
    root = Path(__file__).resolve().parent

    t0 = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--strict"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    lint_s = time.perf_counter() - t0
    check(lint.returncode == 0, f"lint --strict exited {lint.returncode}:"
          f"\n{lint.stdout[-3000:]}{lint.stderr[-3000:]}")

    card, host = {}, {}
    rt.ops.reset_launches()
    audit, wall = _wall(torch, lambda: audit_workload(device=dev.type,
                                                      labels=card))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    audit.assert_no_excess()
    report = audit.report()
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the audit workload")
    lib = dict(build.LIBRARY_EVENTS)
    check(lib["loads"] == 1 and lib["builds"] <= 1,
          f"the kernel library was built / loaded more than once: {lib}")
    t0 = time.perf_counter()
    cpu_coverage = run_workload(device="cpu", labels=host)
    cpu_wall = time.perf_counter() - t0
    check(cpu_coverage == audit.coverage, f"coverage {audit.coverage} on "
          f"the card, {cpu_coverage} on the CPU")
    check(list(card) == list(host), "the card and the CPU ran other legs")
    for leg in card:
        check(np.array_equal(card[leg], host[leg]),
              f"{leg}: the card's labels differ from the CPU's")

    eng = Engine(EngineConfig(split="lp"), cache=PlanCache())
    with TraceAudit() as road:
        cold, cold_wall = _wall(torch, lambda: eng.fit(g, backend="tile"))
        again, again_wall = _wall(torch, lambda: eng.fit(g, backend="tile"))
    road.assert_no_excess()
    road_report = road.report()
    check(not cold.cache_hit and again.cache_hit,
          "the same-bucket road fit was not a plan-cache hit")
    for res in (cold, again):
        check(np.array_equal(res.labels, fused.labels),
              "an audited road fit differs from main's labels")
    check(any(r["stage"] == "tile:propagate_fused"
              for r in road_report["contexts"]),
          "the road fits did not build the fused tile plan")

    return launches, {
        "lint_s": lint_s, "lint_tail": lint.stdout.strip().splitlines()[-1],
        "workload": {"coverage": audit.coverage, "fits": len(card),
                     "wall_s": wall, "cpu_wall_s": cpu_wall,
                     "plan_builds": _audit_rows(report),
                     "total_plan_builds": report["total_traces"],
                     "excess": report["excess_contexts"],
                     "library": report["library"], "launches": launches},
        "road": {"graph": "grid2d(3500)", "cold_wall_s": cold_wall,
                 "same_bucket_wall_s": again_wall,
                 "cache_hit": again.cache_hit,
                 "plan_builds": _audit_rows(road_report),
                 "excess": road_report["excess_contexts"]}}


# ------------------------------------------------------------------ main

# ---------------------------------------------------------------- dryrun

# The dry run (launch/dryrun.py) under this machine's torch: two cells of
# the sweep from the CLI, each in a subprocess under DRYRUN_TIMEOUT_S, and
# the train phase's trainer cell (Yi-9B at full width, TRAIN_LAYERS
# layers, TRAIN_BATCH x TRAIN_SEQ) traced on a one-rank world, held to one
# real step of that cell on the card: the argument bytes equal to the real
# state's storage bytes (parameters, AdamW state, batch) exactly, the
# reckoned peak (arguments + the trace's temp bytes) within DRYRUN_PEAK_TOL
# of max_memory_allocated over the real step.
DRYRUN_CELLS = (("yi-9b", "train_4k", "pod"), ("graph-lpa", None,
                                                 "multipod"))
DRYRUN_TIMEOUT_S = 300
DRYRUN_PEAK_TOL = 0.25
DRYRUN_ONE_RANK = r"""
import dataclasses, json, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_host_mesh
arch, layers, b, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
cfg = dataclasses.replace(get_config(arch), n_layers=layers)
batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
         for k in ("tokens", "targets")}
t0 = time.perf_counter()
with fake_world(1):
    mesh = make_host_mesh((1, 1), ("data", "model"))
    run, args, meta = D._lower_cell(arch, "train_4k", mesh, cfg=cfg,
                                    batch=batch)
    trace, mem = D.trace_cell(run, args)
print("RESULT" + json.dumps({"memory_analysis": mem, "cost": trace.cost(),
                             "trace_s": time.perf_counter() - t0}))
"""


def _dryrun_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                           / "src"))


def _dryrun_start(tmp: Path, arch, shape, mesh):
    """One cell through ``python -m repro_torch.launch.dryrun``, started."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--mesh", mesh, "--out-dir", str(tmp)]
    if shape:
        cmd += ["--shape", shape]
    return subprocess.Popen(cmd, env=_dryrun_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dryrun_wait(proc, what: str, t0: float) -> tuple[str, float]:
    """A started subprocess's stdout and wall, under DRYRUN_TIMEOUT_S from
    ``t0``; one that fails or outlasts it fails the run."""
    try:
        out, err = proc.communicate(
            timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"dryrun {what} outlasted {DRYRUN_TIMEOUT_S} s")
    check(proc.returncode == 0, f"dryrun {what} exited {proc.returncode}: "
          f"{err[-1500:]}")
    return out, time.perf_counter() - t0


def _dryrun_cell(tmp: Path, arch, shape, mesh, wall) -> dict:
    rec = json.loads((tmp / f"{arch}_{shape or 'graph'}_{mesh}.json")
                     .read_text())
    check(rec["cost_analysis"]["flops"] > 0
          and rec["memory_analysis"]["argument_size_in_bytes"] > 0
          and rec["collectives"]["wire_bytes"]["total"] > 0,
          f"dryrun {arch} {mesh}: an empty record {rec}")
    return {"arch": arch, "shape": shape, "mesh": mesh, "wall_s": wall,
            "lower_seconds": rec["lower_seconds"],
            "flops": rec["cost_analysis"]["flops"],
            "wire_bytes": rec["collectives"]["wire_bytes"]["total"],
            "collective_counts": rec["collectives"]["counts"],
            "memory_analysis": rec["memory_analysis"]}


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree of tensors (dicts,
    tuples, named tuples)."""
    from torch.utils._pytree import tree_leaves
    seen, n = set(), 0
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


def _dryrun_real_step(torch, dev) -> dict:
    """One real step of the trainer cell on the card, from the state it
    is given: the state's storage bytes, the peak over the step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    from repro_torch.train import steps as S
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    params = init_from_specs(T.model_specs(cfg), LM_SEED, device=dev)
    opt = S.init_opt_state(cfg, params)
    host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH,
                              seed=LM_SEED).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    state = _storage_bytes((params, opt, batch))
    step, *_ = S.make_train_step(cfg, None, "train_4k", donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, metrics = step(params, opt, batch, TRAIN_STEP_IDX)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batch, metrics
    check(np.isfinite(loss), "dryrun: the real step's loss is not finite")
    return {"state_bytes_card": state, "peak_bytes_card": peak,
            "loss": loss}


def phase_dryrun(torch, dev):
    """The dry run on this machine's torch: DRYRUN_CELLS from the CLI and
    the one-rank trace of the trainer cell, all three subprocesses at
    once, while the card runs the real step the trace is held to."""
    import gc
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [_dryrun_start(tmp, *c) for c in DRYRUN_CELLS]
        one = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_ONE_RANK, LM_ARCH,
             str(TRAIN_LAYERS), str(TRAIN_BATCH), str(TRAIN_SEQ)],
            env=_dryrun_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(one)
        real = _dryrun_real_step(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        cells = []
        for (arch, shape, mesh), p in zip(DRYRUN_CELLS, procs):
            _, wall = _dryrun_wait(p, f"{arch} {mesh}", t0)
            cells.append(_dryrun_cell(tmp, arch, shape, mesh, wall))
        out, _ = _dryrun_wait(one, "one rank", t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    pred = json.loads([x for x in out.splitlines()
                       if x.startswith("RESULT")][0][len("RESULT"):])
    mem = pred["memory_analysis"]
    reckoned = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    one_rank = {"layers": TRAIN_LAYERS, "batch": TRAIN_BATCH,
                "seq": TRAIN_SEQ,
                "argument_bytes_reckoned": mem["argument_size_in_bytes"],
                "temp_bytes_reckoned": mem["temp_size_in_bytes"],
                "peak_bytes_reckoned": reckoned, **real,
                "peak_ratio": reckoned / real["peak_bytes_card"],
                "flops_reckoned": pred["cost"]["flops"],
                "trace_s": pred["trace_s"]}
    check(mem["argument_size_in_bytes"] == real["state_bytes_card"],
          f"dryrun: argument bytes {mem['argument_size_in_bytes']} against "
          f"the card's state {real['state_bytes_card']}")
    check(abs(one_rank["peak_ratio"] - 1) <= DRYRUN_PEAK_TOL, f"dryrun: "
          f"reckoned peak {reckoned} against the card's "
          f"{real['peak_bytes_card']}")
    return {"cells": cells, "one_rank": one_rank,
            "peak_tolerance": DRYRUN_PEAK_TOL,
            "wall_s": time.perf_counter() - t0}


def _parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all); the "
                    "kernels summary and the result line print only when "
                    "all ran")
    args = ap.parse_args(argv)
    args.phases = [x for x in args.phases.split(",") if x]
    for name in args.phases:
        if name not in PHASES:
            ap.error(f"unknown phase {name!r}; phases: {', '.join(PHASES)}")
        for need in NEEDS.get(name, ()):
            if need not in args.phases:
                ap.error(f"phase {name} needs phase {need}")
    return args


def main(argv=None) -> int:
    _START[:] = [time.perf_counter()]
    args = _parse_args(argv)
    run = set(args.phases)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops, ref
    rt = SimpleNamespace(ops=ops, ref=ref)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain argmax sums
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": platform.python_version()})

    t0 = time.perf_counter()
    build.load_library()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          **build.BUILD_INFO})
    resources = build.BUILD_INFO["resources"]
    # every instance of the split kernels (min_label_narrow<4>, ...)
    no_spill = [n for n in resources
                if n in FLASH_KERNELS + BWD_KERNELS + DECODE_KERNELS
                or n.startswith(SPLIT_KERNELS)]
    for prefix in (*FLASH_KERNELS, *BWD_KERNELS, *DECODE_KERNELS,
                   *SPLIT_KERNELS):
        check(any(n.startswith(prefix) for n in no_spill),
              f"ptxas reports no entry for {prefix}")
    for name in no_spill:
        res = resources[name]
        check(res.get("registers") and res.get("spill_store_bytes") == 0
              and res.get("spill_load_bytes") == 0,
              f"{name}: ptxas reports a spill or no registers: {res}")
        check("wgmma_serialized" not in res, f"{name}: ptxas serialised "
              f"its wgmma {res.get('wgmma_serialized')}")

    if "kernels" in run:
        res = phase_kernels(torch, ops, ref, dev)
        kernel_err = res["max_abs_err"]
        emit({"phase": "kernels", **res})
    if "parity" in run:
        emit({"phase": "parity", **phase_parity(torch, rt, dev)})
    if "c1" in run:
        emit({"phase": "c1", **phase_c1(torch, dev)})
    if "main" in run:
        g, fused, main_res = phase_main(torch, rt, dev)
        launches = main_res["launches"]
        emit({"phase": "main", **main_res})
    if "wide_fit" in run:
        g_er, fused_er, res = phase_wide_fit(torch, rt, dev)
        emit({"phase": "wide_fit", **res})
    if "dense" in run:
        emit({"phase": "dense", **phase_dense(torch, rt, g_er, dev)})
    if "skew_fit" in run:
        emit({"phase": "skew_fit", **phase_skew_fit(torch, dev)})
    if "batch" in run:
        graphs_a, graphs_b, solo_b, batch_launches, res = phase_batch(
            torch, rt, dev)
        emit({"phase": "batch", **res})
    if "obs" in run:
        obs_launches, res = phase_obs(torch, rt, dev, g, fused, graphs_a,
                                      graphs_b)
        del graphs_a
        emit({"phase": "obs", **res})
    if "microbatch" in run:
        emit({"phase": "microbatch",
              **phase_microbatch(torch, graphs_b, solo_b)})
    if "stream" in run:
        stream_launches, res = phase_stream(torch, rt, dev, g, fused)
        emit({"phase": "stream", **res})
    if "ingest" in run:
        import shutil
        import tempfile
        ingest_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ingest_"))
        try:
            mtx, path_fit, path_wall, res = phase_ingest(torch, dev,
                                                         ingest_tmp)
            emit({"phase": "ingest", **res})
            if "ooc" in run:
                rt.ops.reset_launches()
                res = phase_ooc(torch, rt, dev, g, fused, main_res, mtx,
                                path_fit, path_wall, ingest_tmp)
                ooc_launches = {k: res["fused"]["launches"][k]
                                + res["unfused"]["launches"][k]
                                for k in LPA_KERNELS}
                emit({"phase": "ooc", **res})
        finally:
            shutil.rmtree(ingest_tmp, ignore_errors=True)
    if "serve" in run:
        res = phase_serve(torch, rt, dev)
        serve_launches = res["a"]["launches"]
        emit({"phase": "serve", **res})
    if "sharded" in run:
        sharded_launches, res = phase_sharded(torch, dev, g, fused, main_res)
        emit({"phase": "sharded", **res})
    if "timing" in run:
        from repro_torch.engine.bucketing import bucket_for
        from repro_torch.graphgen import planted_partition
        t0 = time.perf_counter()
        g_pp, truth = planted_partition(128, 1024, 0.3, 0.001, seed=0)
        g_pp = g_pp.to(dev)
        pp_build_s = time.perf_counter() - t0
        b_pp = bucket_for(g_pp)
        cases = [("grid2d(3500)", g, fused.bucket[0], fused.bucket[2],
                  fused.labels),
                 (ER_GRAPH, g_er, fused_er.bucket[0], fused_er.bucket[2],
                  fused_er.labels),
                 (PLANTED_GRAPH + ", ground-truth labels", g_pp, b_pp.n,
                  b_pp.d, truth),
                 # a fit's first sweep: every label distinct, all tied
                 (PLANTED_GRAPH + ", labels = vertex ids", g_pp, b_pp.n,
                  b_pp.d, np.arange(g_pp.n, dtype=np.int32))]
        timing = phase_timing(torch, rt, dev, cases)
        del g_er, fused_er, g_pp, cases
        emit({"phase": "timing", "planted_graph_build_s": pp_build_s,
              **timing})
        timing = timing["kernels"]
    if "trace" in run:
        emit({"phase": "trace", **phase_trace(torch, g)})
    if "flash" in run:
        flash = phase_flash(torch, rt, dev)
        emit({"phase": "flash", **flash})
    if "decode" in run:
        decode = phase_decode(torch, rt, dev)
        emit({"phase": "decode", "nvidia_smi": smi, **decode})
    if "lm" in run:
        lm = phase_lm(torch, rt, dev)
        emit({"phase": "lm", "nvidia_smi": smi, **lm})
    if "lm_families" in run:
        families = phase_lm_families(torch, rt, dev)
        emit({"phase": "lm_families", "nvidia_smi": smi,
              "archs": families})
    if "train" in run:
        train = phase_train(torch, rt, dev)
        emit({"phase": "train", "nvidia_smi": smi, **train})
    if "train_sharded" in run:
        sharded_train = phase_train_sharded(torch, rt, dev)
        emit({"phase": "train_sharded", "nvidia_smi": smi, **sharded_train})
    if "serve_sharded" in run:
        serve_sharded = phase_serve_sharded(torch, rt, dev)
        emit({"phase": "serve_sharded", "nvidia_smi": smi, **serve_sharded})
    if "audit" in run:
        audit_launches, res = phase_audit(torch, rt, dev, g, fused)
        emit({"phase": "audit", "nvidia_smi": smi, **res})
    if "dryrun" in run:
        emit({"phase": "dryrun", "nvidia_smi": smi,
              **phase_dryrun(torch, dev)})
    if run != set(PHASES):
        print("chip_smoke: a subset of the phases ran; no kernels summary "
              "and no result line", file=sys.stderr)
        return 0

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "batch_launches": batch_launches[name],
         "stream_launches": stream_launches[name],
         "obs_launches": obs_launches[name],
         "ooc_launches": ooc_launches[name],
         "serve_launches": serve_launches[name],
         "sharded_launches": sharded_launches[name],
         "audit_launches": audit_launches[name],
         "launched_by": "launches: tile fits of grid2d(3500), fused and "
                        "unfused; batch_launches: fit_many of traffic A "
                        "(32 grid2d members), tile fused and unfused; "
                        "stream_launches: the 3 warm road updates of "
                        "grid2d(3500) through StreamSession (tile fused); "
                        "obs_launches: profile=\"full\" tile fits of "
                        "grid2d(3500), fused and unfused; ooc_launches: "
                        "out-of-core tile fits of grid2d(3500), fused "
                        "and unfused, one launch per partition visit; "
                        "serve_launches: the serve phase's run (a), 32 "
                        "tenants x 4 requests through TenantService "
                        "(tile, fused); sharded_launches: the sharded "
                        "phase's one-NCCL-rank fit of grid2d(3500), "
                        "exchange_every=1 (B1 and B2, unfused); "
                        "audit_launches: the audit phase's workload "
                        "(repro_torch.analysis), B3 / B4 on its tile "
                        "legs, B1 / B2 on its sharded leg",
         "max_abs_err": kernel_err[name],
         **{k: timing[name][k] for k in keys}}
        for name in LPA_KERNELS]
    fm = flash["main"]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": KERNELS["flash_attention"][0],
        "replaces": KERNELS["flash_attention"][1],
        "launches": fm["launches"],
        "serve_launches": serve_launches["flash_attention"],
        "lm_launches": lm["serve"]["launches"],
        "lm_families_launches": {f["arch"]: f["launches"]
                                 for f in families},
        "launched_by": "launches: flash phase, ops.flash_attention at Yi-9B "
                       "width (B=1, S=4096, H=32, K=4, hd=128, bf16, "
                       "causal); lm_launches: the lm phase's serve() of "
                       "Yi-9B, 48 layers, a prefill of 4 x 512 tokens and "
                       "31 decode steps, one launch per layer and call; "
                       "lm_families_launches: the lm_families phase's "
                       "serve() of each arch, the same prompts, one "
                       "launch per attention, encoder and cross-attention "
                       "layer and call; train_launches: the train phase's "
                       "trainer, 6 steps of Yi-9B at 8 layers, two per "
                       "layer and step (the forward, remat's recompute); "
                       "train_sharded_launches: the train_sharded phase's "
                       "(a) 3 sharded steps at 4 layers on one NCCL rank "
                       "and (b) 2 steps at 2 layers on each of 4 gloo "
                       "ranks, on the rank's heads; train_sharded_local: "
                       "B5 with lse at (b)'s local shapes (q (2, 4096, 16, "
                       "128), k/v (2, 4096, 2, 128), causal); "
                       "serve_sharded_launches: the serve_sharded phase's "
                       "mesh runs per rank, bf16 (flash_wgmma; its "
                       "decode steps flash_decode) and float32 "
                       "(flash_fma): (a) qwen1.5-32b on (2, 2), "
                       "2 layers, int8 cache, a prefill and 8 / 32 "
                       "steps; (c) jamba on (2, 2), sequence-parallel, "
                       "data rank 1 from its first row, float32; (hd) "
                       "yi-9b on (1, 8), 2 layers, head_dim split, a "
                       "prefill and 8 steps each; and (b) starcoder2-15b "
                       "on one device (10 layers, window 4096, a prefill "
                       "and 32 steps); serve_sharded_rows_loaded: the key "
                       "rows (b)'s first and last decode launches loaded "
                       "(summed, blocks, the most one block loads), "
                       "counted by the kernel (ops.count_kv_rows); "
                       "serve_sharded_exchange: the bytes each (hd) rank "
                       "received a decode step through the head_dim "
                       "all-to-all (parallel.compat.EXCHANGED), bf16; "
                       "serve_sharded_cases: B5 at that phase's calls "
                       "(window prefill and decode, int8 decode, the SP "
                       "ranks' calls with lse, the head_dim case's call "
                       "after its all-to-all)",
        "train_launches": train["trainer"]["b5_launches"],
        **_sharded_kernel_fields(sharded_train, "fwd", "flash_attention"),
        **_ss_kernel_fields(serve_sharded),
        "max_abs_err": fm["max_abs_err"], **{k: fm[k] for k in keys}})
    dm = decode["main"]
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": KERNELS["flash_decode"][0],
        "replaces": KERNELS["flash_decode"][1],
        "launches": lm["serve"]["decode_launches"],
        "launched_by": "launches: the lm phase's serve() of Yi-9B, 48 "
                       "layers, 31 decode steps, one call per layer and "
                       "step (each also one flash_attention launch; the "
                       "body is two kernels, the split pass and the "
                       "combine); checked and timed at Yi-9B's decode call "
                       "(q (4, 1, 32, 128) over a (4, 1024, 4, 128) cache, "
                       "kv_len 513) and at every other decode call of the "
                       "decode phase; library_ms: SDPA over the visible "
                       "keys copied out; *device_ms: a call's time "
                       "replayed from a CUDA graph (no host in the way)",
        "device_ms": dm["device_ms"],
        "library_device_ms": dm["library_device_ms"],
        "prefill_body_ms": dm["prefill_body_ms"],
        "prefill_body_device_ms": dm["prefill_body_device_ms"],
        "max_abs_err": dm["max_abs_err"], **{k: dm[k] for k in keys}})
    tk = train["kernels"]["main"]["bwd"]  # the trainer's call, bf16
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": KERNELS["flash_attention_bwd"][0],
        "replaces": KERNELS["flash_attention_bwd"][1],
        "launches": train["trainer"]["b5_bwd_launches"],
        "launched_by": "launches: the train phase's trainer, "
                       "launch.train.run of Yi-9B at full width, 8 layers, "
                       "4 x 4096 tokens, 6 steps, one launch per layer and "
                       "step (B5 twice: the forward and remat's "
                       "recompute); checked and timed at the trainer's "
                       "call: B=4, S=4096, H=32, K=4, hd=128, bf16, "
                       "causal; library_ms: SDPA's backward; "
                       "train_sharded_launches: one per layer and step "
                       "of the train_sharded phase's (a) and, per rank, "
                       "(b); train_sharded_local: at (b)'s local shapes",
        "max_abs_err": max(tk[f"{x}_max_abs_err"] for x in ("dq", "dk",
                                                            "dv")),
        "ms_by_launch": train["trainer"]["traced_step"][
            "b5_bwd_ms_by_launch"],
        **_sharded_kernel_fields(sharded_train, "bwd", "flash_attention_bwd"),
        **{k: tk[k] for k in keys}})
    # B5-bwd under a sliding window, at the window trainer's call
    wk = next(c for c in train["kernels"]["window"]
              if "ms" in c and c["shape"][1] == TRAIN_SC_SEQ)
    rows.append({
        "name": "flash_attention_bwd (window)", "route": "cuda",
        "source": KERNELS["flash_attention_bwd"][0],
        "replaces": KERNELS["flash_attention_bwd"][1],
        "launches": train["window_trainer"]["b5_bwd_launches"],
        "launched_by": "launches: the train phase's window trainer (f), "
                       "launch.train.run of starcoder2-15b at full width, "
                       f"{TRAIN_SC_LAYERS} layers, 1 x {TRAIN_SC_SEQ} tokens, "
                       f"{TRAIN_SC_STEPS} steps, window 4096, one launch per "
                       "layer and step; checked and timed at its call: B=1, "
                       f"S={TRAIN_SC_SEQ}, H=48, K=4, hd=128, bf16, causal, "
                       "window 4096; bound_ms over the band's pairs; "
                       "library_ms: SDPA's backward with the band as a "
                       "boolean mask",
        "max_abs_err": max(wk[f"{x}_max_abs_err"] for x in ("dq", "dk",
                                                            "dv")),
        **{k: wk[k] for k in keys}})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
