"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

* ``build``: compiles every CUDA source of ``src/repro_torch/kernels/csrc``
  with nvcc (one process per source, in parallel) and reports the compiler's
  register / shared-memory report and the card (nvidia-smi).
* ``kernels``: every ported kernel against its plain PyTorch version on the
  card, at the shapes the main path gives it, with its median time, the
  plain version's time, one PyTorch library call's time as a yardstick, and
  the least time the card could take (its bound). The gram-apply and
  slab-apply rows also give the host's time to issue one call (and the
  library call's), and must repeat their bits on a second launch; the
  phase prints the ptxas report (registers, spills) of both kernels. The
  card's launch floor (``torch.cuda._sleep(1)``, timed as the rows are)
  stands beside rows 2 and 4. The CholeskyQR Gram kernel also runs at
  F-DOT's and B-DOT's shapes and at benchmarks/kernel_bench.py's (16384,
  128) in f32 and bf16 (the tensor-core route), each timed and checked for
  the same bits on a second launch and exact symmetry. The ELL rows (f32,
  and bf16 messages rounded inside the kernel: one kernel a round, which a
  profile checks) carry the graph's shared-memory window (band, halo,
  in-window share) and ``l2_bytes``, the gathers that miss it; ``ell_checks`` times
  the same round on erdos_renyi(4096, 0.0015, seed 1), a graph without
  locality. The batched ELL rows (f32 and bf16) take bdot_sparse's row
  stage: four watts_strogatz(4096, 6, 0.1) graphs (seeds 1-4, widened to
  one L) stacked, K = 980 each, one launch; each member must equal a
  single launch of it bit for bit, and the library's yardstick is one CSR
  product over the block-diagonal matrix of the four. Flash
  attention has two rows: bf16 at qwen2-7b's prefill (the tensor-core
  kernel, checked for the same bits on a second launch, with its ptxas
  report and its count of HGMMA instructions from cuobjdump) and f32 at
  (1, 28 / 4 heads, 1024, 128) (the CUDA-core kernel, off the main path);
  more bf16 cases (a 512-key window, ragged 2000, 128 x 2048 cross, and
  h2o-danube-1.8b's 32 / 8 heads at head dim 80 with a 512-key window)
  and f32 are held to their limits.
* ``sdot_dense``: S-DOT (t_c = 50) and SA-DOT (2t+1, capped at 50) at the
  paper's CIFAR-10 width: d = 1024, r = 7, N = 20 nodes of erdos_renyi(20,
  0.25, seed=1), T_o = 100, the full 50,000-sample training-set size (2,500
  samples a node), data from gaussian_eigengap_data(gap 0.7, seed 0).
  Both run through ``runtime.run_monolithic``. Checks: final mean subspace
  error <= 1e-4 against a float64 eigh, one gram-apply launch per outer
  iteration, two Gram launches per outer iteration (CholeskyQR2) and two
  more for the explained-variance check's QR, the closed-form ledger, and
  the explained variance of the estimate on the whole data (single-node
  gram-apply) against the top-r eigenvalues.
* ``profile``: device time by kernel over a short S-DOT run (torch.profiler),
  and the device's busy share of that run's wall time.
* ``fdot_dense``: F-DOT (Alg. 2) on the same X, spread by features over the
  same 20-node graph (19 slabs of 51 features and one of 55, all 50,000
  samples each), r = 7, T_o = 100, t_c = t_c_qr = 50, under the constant
  schedule and 2t+1 capped at 50. Checks: final mean subspace error <= 1e-4,
  q_full orthonormal to 1e-5, one launch of each slab kernel per outer
  iteration, the closed-form ledger, and F-DOT's subspace within 1e-4 of
  S-DOT's consensus estimate, and two Gram launches per outer iteration
  (one per distributed CholeskyQR pass).
* ``bdot_dense``: B-DOT on the same X over a 4 x 5 grid (256 features x
  10,000 samples a node), column engines erdos_renyi(4, 0.7, seed=j), row
  engines erdos_renyi(5, 0.7, seed=10 + i), the same two schedules and
  checks, with one launch of each grid kernel per outer iteration.
* ``profile_fdot``, ``profile_bdot``: the profile of a T_o = 20 run of each.
* ``sdot_async``: S-DOT at sdot_dense's configuration with node 0 a
  straggler awake 1 round in 11 (benchmarks/async_straggler.py's 1 ms
  rounds and 10 ms delay), on the engine's own masks and on the JAX
  reference's (tools/data/sdot_async_reference.npz, written by
  tools/reference_fault_errors.py). Checks: the own-mask run within 10x
  the reference's worst error over steps 51-100, the run on the
  reference's masks within 1e-4 and within REF_TRACE_TOL of the
  reference's trace, the ledger equal to the realized sends, an
  all-awake run within 1e-5 of sync S-DOT's trace. It reports
  ``mean_awake`` and ``straggler_wall_clock`` at the card's own time a
  gossip round. ``profile_sdot_async``: device launches a step.
* ``sdot_faulty``: S-DOT under examples/net_faults.json's plan with its
  corruption in "nan" mode (node 0 down in steps 3-5), seed 7, realized
  and nominal debias, each within its limit (REF_FINAL_ERR); node 0's
  iterate at step 6 equal to its iterate at step 3 (one chunked run
  stopped at 3 and resumed to 6); fused equal to eager bit for bit at
  T_o = 20; a fault-free model within 1e-5 of sync S-DOT's trace.
  ``fdot_faulty``: F-DOT (const, t_c = t_c_qr = 50) under the same plan:
  its limit, q_full orthonormal to 1e-5, exact slab and Gram launches.
  Each has a profile.
* ``resume``: S-DOT, F-DOT and B-DOT at the configurations above (t_c = 50)
  five ways each (and faulty S-DOT and async F-DOT, each run with fresh
  engines, their burst state and key compared too): (i)
  ``runtime.run_monolithic``; (ii) ``*_chunked`` with
  chunk_size 10 and a ``CheckpointManager`` under ``build/``; (iii) the
  same, killed after 4 chunks and resumed by a second call on the same
  directory; (iv) chunk_size 7; and chunk_size 10 with no checkpoints
  ((i), (ii) and the last timed once each). The iterate, error
  trace and ledger of every run must equal (i)'s bit for bit, and the
  launch counts show that (iii) restored step 40. It reports the wall
  times, the cost of chunking and of a checkpoint per chunk, the
  RunState's bytes, and the cost of the error trace's SVDs in one batched
  call against one call a step. It fails if a matrix's batched singular
  values on this card depend on the batch it is in: the runtime's one SVD
  call a chunk relies on that.
* ``baselines``: the paper's comparison methods at sdot_dense's
  configuration (covs M_i = X_i X_i^T / n_i, (20, 1024, 1024) f32) and
  benchmarks/fig45_baselines.py's budgets: SeqPM on sum M_i; SeqDistPM
  (iters_per_vec 100 // 7, t_c 50); DSA and DPGD (T_o 500, lr 0.05);
  DeEPCA (T_o 100, t_mix 3); d-PM on fdot_dense's slabs (iters_per_vec
  14, t_c 50). Each starts from the JAX reference's own init and is held
  to the reference's trace (tools/data/baselines_reference.npz, written by
  tools/reference_baseline_errors.py) within BASELINE_REF_TRACE_TOL, its
  final error to 1e-4 where the reference ends under it, else to 10x the
  reference's; each distributed method fused against eager on the card
  (trace within BASELINE_EAGER_TOL, ledgers equal); exactly two Gram
  launches a step for DPGD and DeEPCA; DeEPCA through
  ``baseline_chunked``, chunked by 10, killed after 4 chunks and resumed,
  bit for bit equal to ``run_monolithic``, its (q, s, mq_prev) carry
  included. It reports each method's wall and final error.
* ``sweeps``: the Monte-Carlo engine at the same width. First each lane
  dispatch against its plain version (gram-apply over 12 lanes at
  sdot_dense's shape, one launch a lane; slab tq over 4 lanes at
  fdot_dense's, folded into one launch; slab apply over 4, one a lane),
  with both times. Then
  ``sdot_sweep`` on the raw data, 3 cases (erdos_renyi const t_c = 50,
  the same graph 2t+1 capped at 50, ring(20) const) x 4 seeds, T_o = 100;
  ``fdot_sweep`` on the slabs, 4 seeds; a ragged ``baseline_sweep
  ("deepca")`` (erdos_renyi(10, 0.5, seed=1) over X split 10 ways beside
  the 20-node case, 2 seeds); ``netfault_sweep`` under sdot_faulty's plan
  at p_drop 0.1 and 0.2 x 2 seeds, T_o = 20. Checks: every lane within
  SWEEP_LANE_TOL of the port's own single run from the same init, the
  S-DOT and fault sweeps' lanes bit for bit, the ER lanes' final errors
  <= 1e-4 (the ring
  lane reported), exact kernel launches a step (1,200 gram-apply; 100
  slab tq and 400 slab apply), the
  ledger equal to the per-seed ledgers' sum, the shard of seeds [2, 3]
  against those lanes of the grid, a chunked sweep killed after 4 chunks
  and resumed bit for bit, a netfault shard of seed 1 bit for bit. It
  reports each sweep's wall beside the per-seed loop's, and
  ``profile_sweep`` profiles 10 steps of the S-DOT sweep.
* ``streams_ingest``: the serving configuration's drifting stream
  (tools/data/serving_reference.json: d = 1024, r = 7, N = 20, 2,000
  samples a batch) on the card: a batch drawn twice at one (seed, step)
  bit for bit; after 26 batches the exact sketch within SKETCH_TOL of a
  float64 sum of the same batches; Frequent Directions at ell = 128 within
  its bound ``||X X^T - B^T B||_2 <= shrink_loss`` on every node. It
  reports ms a micro-batch (exact update with its bound, FD update, the
  stream's draw), ms a Ritz step, and the ingest walls.
* ``serving``: ``PSAService`` on that configuration, 26 ticks, fault-free:
  swaps >= 2, no gate reject, max staleness <= its bound (20), every query
  answered, the final served subspace's post-shift error within
  SERVING_ERR_FACTOR of the JAX reference's after as many swaps
  (tools/reference_service_trajectory.py on the CPU; the reference's last
  drift trigger sits on its threshold, so on the port's stream the last
  re-solve may still run at the end), and exactly two Gram-kernel launches
  a re-solve step and two a candidate. It reports ticks/s, ms a tick of each
  span (ingest, re-solve increment of 20 S-DOT steps, drift read, query
  drain, checkpoint), the snapshot's bytes, query p50/p99 and swap ticks.
* ``serving_chaos``: the same configuration under ``run_supervised`` with
  ``smoke_plan`` (kill at tick 7, kill at re-solve step 30, hang at tick
  12): exactly 3 relaunches, the ``serving`` phase's served bits and swap
  ticks, every restore's ``pinned_match`` not false and one true; then
  ``gate_plan`` in-process: 1 reject, 1 cold re-solve, swaps >= 2, nothing
  non-finite served, post-shift error < 0.2, some queries expired.
* ``warm_start``: tools/data/serving_reference.json's recipe on the port's
  stream: iterations to 1e-3 against the post-shift covs' top 7 of a cold
  start and of a warm start from an incumbent solved on the pre-shift
  covs, beside the reference's counts. No order is asserted.
* ``profile_serving``: a profile of 4 ticks with the initial re-solve
  active: busy share, device launches a tick, device time of row 4, the
  GEMMs, the sketch update (its ``record_function`` label), the
  snapshots' device-to-host copies and the rest.
* ``sdot_sparse``: watts_strogatz(4096, k=6, p=0.1, seed=1) at MNIST width
  (d = 784, r = 5, 60,000 samples, 14 a node), T_o = 5, t_c = 20. The
  default engine must pick ELL gossip; the per-node estimates must agree
  with the dense matmul engine; an SA-DOT lin2 run with bf16 messages must
  be finite, priced at 2 bytes per element and within BF16_PAYLOAD_TOL
  (per node) of the same SA-DOT run with f32 messages.
* ``sparse_faulty``: that overlay under drops and bursts (p_drop 0.2,
  p_bad 0.05, p_good 0.5, seed 7), f32 and bf16 messages: the ELL kernel
  first against its plain version on a faulty round's operands (masked
  slot weights, a zero diagonal, zeroed messages), then one ELL launch a
  live round, the estimates within 1e-4 of a dense engine fed the same
  draws, bf16 finite, priced at 2 bytes an element and within
  BF16_PAYLOAD_TOL of the f32 run.
* ``bdot_sparse``: B-DOT on sdot_sparse's data over a 4 x 4096 grid
  (slabs of 196 features by 4,096 sample columns of 14; on the card the
  columns pad to 16), T_o = 5, t_c = 20: row engines watts_strogatz(4096, 6,
  0.1, seeds 1-4), one stacked SparseW, so each row-stage round is one
  batched ELL launch; column engine complete(4) repeated over the 4,096
  columns. Before the run, the rows ``grid_block_tq_packed`` and
  ``grid_block_apply_packed``: both grid kernels at this grid (16,384
  blocks of 196 x 16) on their packed route, against the plain versions
  (SLAB_TOL) and the library's ``torch.matmul`` over the grid, two
  launches bit for bit, with the planner's packed plans. Checks: ELL
  launches = the rounds (batched) + the four debias tables' rows (single),
  one launch of each grid kernel a step, all on the packed route
  (``slab_ops.TQ_ROUTE_LAUNCHES``, ``slab_ops.ROUTE_LAUNCHES``), q_full
  within 1e-4 by subspace error of the run with dense row engines and
  within 1e-5 of the eager sparse run, the closed-form ledger. It prints
  the three walls, each row engine's smallest debias weight, the grid
  kernels' routes and the packed plans.
* ``fleet`` (between ``sweeps`` and the serving phases): the sweeps'
  S-DOT grid (3 cases x 4 seeds, T_o = 100, raw data) through
  ``launch_sweep`` with 2 worker processes on this card: pinned over 2
  shards; under ``chaos.smoke_plan`` (kill, corrupt-newest, slow, drop)
  over 4 shards with sweep_chunk 20 (attempts 2, 2, 1, 2; shard 1 falls
  back to step 20); elastic, a worker stealing shard 0's lease, left
  expired by a departed worker, and resuming its step-20 checkpoint. Each
  merge must equal the single-process sweep of each shard's seeds bit for
  bit; it prints the walls, attempts and resumed steps. Workdirs under
  ``build/chip_smoke_fleet/`` (removed after).
* ``lm_setup``: frees the PSA phases' tensors and puts qwen2-7b (28 layers,
  d_model 3584, 28 / 4 heads, d_ff 18944, vocabulary 152,064; random
  weights from torch.Generator seed 0 at the reference's init scales) on the
  card in bf16.
* ``lm_prefill``: ``forward`` over make_lm_batch(seed 0) of 4 x 2048 tokens
  through the flash-attention kernel: wall time, prefill tokens/s, peak
  memory, and exactly 28 kernel launches, all on the tensor-core route.
  Then the same forward with plain ``blockwise_attention``: the logits'
  RMS difference relative to their RMS
  must stay within LOGITS_TOL (max abs difference and top-1 agreement
  reported beside it). Two control forwards with a faulty attention in
  place of the kernel (q k^T rounded to bf16 before the softmax; the kernel
  with its last 64 keys masked) must land outside LOGITS_TOL. Per layer:
  the kernel against the plain version on the q, k, v of each of the 28
  layers must stay within the kernel's bf16 limits, and each faulty
  control must leave them at some layer.
* ``profile_lm``: device time by kernel over one prefill, grouped into the
  flash kernel, the GEMMs and the rest, and the device's busy share.
* ``lm_decode``: teacher-forced ``decode_step`` over the first 64 tokens of
  each sequence against ``forward`` of those 64 tokens (the kernel below one
  tile), within DECODE_TOL; then 32 greedy tokens: decode tokens/s and the
  KV cache's bytes. Then the int8 KV cache (``kv_quant``): KV_QUANT_STEPS
  teacher-forced steps from a fresh state on the same prompt, the cache's
  bytes equal to ``launch/roofline.kv_cache_bytes`` (``--kv-quant``'s
  count) and the logits within KV_QUANT_TOL of the bf16 cache's.
* ``profile_decode``: the same profile over 4 decode steps.

Then the MoE, recurrent and frontend families (``lm_family_phases``), one
model on the card at a time, each freed before the next; random bf16
weights from torch.Generator seed 0 at the reference's init scales:

* ``kernels_hd256``: row 9 at head dim 256 against its plain version
  within the bf16 limits: recurrentgemma-2b's prefill (q 2 x 10 x 4096 x
  256, k/v 2 x 1 heads, window 2048; its library yardstick is SDPA with
  GQA and the band as an explicit mask, SDPA having no window argument)
  and paligemma-3b's (q 4 x 8 x 2048 x 256, k/v 4 x 1 heads, causal; SDPA
  causal, GQA); at head dim 64, musicgen-medium's (q, k, v 4 x 24 x 2048
  x 64, causal; row ``flash_attention_hd64_musicgen``, which takes
  lm_frontends' 48 musicgen launches); and the f32 kernel at (1, 10 / 1,
  1024, 256), off the main path; with ptxas's registers and spills and the
  HGMMA count of the hd-256 instantiations.
* ``lm_hybrid``: recurrentgemma-2b (arXiv:2402.19427) at full width and
  depth (26 layers, d_model 2560, 10 / 1 heads of 256, window 2048, d_ff
  7680, vocabulary 256,000), a prefill of 2 x 4096 tokens (the window
  masks).
* ``lm_moe``: phi3.5-moe (hf:microsoft/Phi-3.5-MoE-instruct) at full width
  (16 experts top-2, d_expert 6400) cut from 32 layers to 4, 4 x 2048
  tokens; then kimi-k2-1t-a32b at full width (d_model 7168, 384 experts
  top-8 + 1 shared, vocabulary 163,840) cut from 61 layers to 1, 1 x 2048:
  each prints the share of (token, choice) pairs dropped at capacity
  factor 1.25.
* ``lm_xlstm``: xlstm-1.3b (arXiv:2405.04517) at full width, 8 of its 48
  layers (d_model 2048, mLSTM chunk 256), 2 x 1024 tokens, and the device
  kernels one sLSTM layer launches a token.
* ``lm_frontends``: paligemma-3b (arXiv:2407.07726) at full width and depth
  (18 layers, 8 / 1 heads of 256, 256 patch positions spliced from
  ``patch_embeds``), 4 x 2048; then musicgen-medium (arXiv:2306.05284) at
  full width and depth (48 layers, 24 heads of 64, 4 codebooks, logits
  (b, s, 4, 2048)), 4 x 2048.

  Each of these prefills prints its wall, tokens/s, peak memory and share
  of the bf16 peak (``launch/analytic_cost``'s FLOPs over the wall and 989
  TFLOP/s), and must launch the flash kernel exactly once an attention
  layer, all on the tensor-core route, each launch within the bf16 limits
  of the plain version on that layer's own q, k, v. Then teacher-forced
  ``decode_step`` over the first 64 tokens (a pure token stream; MoE at
  capacity factor 64, so that nothing drops, and each step on the experts
  prefill chose, the flipped near-ties counted; xlstm-1.3b, whose random
  weights carry a perturbation ~94x, on the same weights in f32, its bf16
  reading printed) within DECODE_TOL of ``forward`` over them, and 8
  greedy steps: ms a step, finite logits, tokens in range.
* ``serve_decode``: ``repro_torch.serve_decode.main(["--device", "cuda"])``
  (reduced qwen2-7b and recurrentgemma-2b, streamed prompt, greedy), which
  must end in ``OK``.

Then gossip across processes and the PSA-compressed trainer, after the LM
phases have freed their tensors (``spmd_train_phases``). Every rank is a
process started by ``launch/mesh.spawn_ranks``; the ranks share the one
card and talk over gloo, each collective's payload staged through pinned
host memory (``host_staged_bytes``, printed). A rank that fails fails its
phase.

* ``spmd_gossip``: 20 ranks, one node each, on sdot_dense's
  erdos_renyi(20, 0.25, seed=1) and on ring(20): a (1024, 7) payload
  debiased-summed at t_c = 1, 5, 20, 50 (``build_debiased_sum``), each node
  within SPMD_GOSSIP_TOL of ``DenseConsensus.run_debiased`` on the card,
  relative to its own max; then ``two_level_reduce`` on ranks 0-7 of the
  same spawn laid out as 4 pods x 2 (``make_mesh(..., ranks=)``; a spawn of
  its own until PR 27), ring(4), t_c = 60: the exact sum within
  TWO_LEVEL_TOL.
* ``sdot_spmd``: sdot_dense's cell with a node a process (d = 1024, r = 7,
  2,500 samples a rank, each rank holding only its own covariance block),
  T_o cut from 100 to SPMD_T_OUTER = 4 (a gossip round across 20
  processes costs milliseconds of the host), S-DOT at t_c = 50 and SA-DOT
  at 2t+1 capped at 50, on both
  graphs, against the fused ``sdot`` over ``DenseConsensus`` on the same
  covs and q_init: the trace within rtol 1e-4 / atol 1e-6, ``q_nodes``
  within 1e-5, the ledgers equal, 2 T_o Gram launches a rank. It prints
  each run's wall, the bytes staged a rank and the final error.
* ``train_psa``: qwen2-7b at full width (d_model 3584, 28 / 4 heads, d_ff
  18944, vocabulary 152,064, bf16, AdamW with bf16 moments) cut from 28
  layers to 2 so that two ranks fit on the card; 2 pods, paper_psa (rank
  64, 2 OI iterations, 4 gossip rounds) refreshed at steps 0 and 3, a
  batch of 2 x 512 tokens a pod, TRAIN_PSA_STEPS = 4 steps, without
  remat (TRAIN_PSA_REMAT: its time is the embedding's all-reduce).
  Checks: finite losses, the first pod-mean loss within TRAIN_LOSS_TOL of
  one rank's
  ``make_train_step`` on the whole batch from the same weights; the first
  PLAIN_STEPS steps against the same steps computed plainly in one
  process from pod 0's first projectors (``train_psa_plain``: each pod's
  gradients, P (P^T mean (G + e)) for a compressed leaf, the f32 mean for
  any other, each pod's error, AdamW): the losses of those steps and the
  next within TRAIN_LOSS_TOL, the grad norms within PLAIN_GNORM_TOL, the
  PROBES' reduced gradients within PLAIN_GRAD_TOL and each pod's errors
  within PLAIN_EF_TOL at step 0, both within PLAIN_AFTER_TOL at step 1
  (its weights moved apart by AdamW's sign-like first step); every refreshed projector orthonormal within
  ORTHO_TOL, three Gram launches a compressed leaf an OI iteration
  (shifted CholeskyQR3), and the bytes staged a step twice those
  all-reduced. It prints ms a step, tokens/s, the launches a refresh by
  shape, the bytes all-reduced a step beside the dense
  gradient's and ``compression_ratio``, and each rank's peak memory. The
  kernel rows ``gram_qr_psa_refresh_*`` time row 4 at the refresh's shapes
  on the route its plan takes (``kernel_route``: ``cluster`` at all three)
  and ``gram_qr_sdot_spmd`` at sdot_spmd's (1, 1024, 7); each refresh's
  Gram launches by route equal the plan's routes of the shapes it counted
  (``check_refresh_routes``), and sdot_spmd's ranks launch none on the
  cluster route.
* ``train_example``: the example twin (``train_lm_psa_compress
  --full-100m``: d_model 768, 12 layers, vocabulary 32,000, f32) for 12
  steps (cut from 300, TRAIN_EXAMPLE_STEPS) on 2 pod ranks,
  checkpoints under ``build/chip_smoke_train/``
  (removed after): the last loss below the first, ms a step, tokens/s.

Then training every family, shard-local MoE routing, the sharded step and
the roofline (``train_family_phases``), each line with the card's name and
power limit and the memory it plans beside the peak it read:

* ``train_families``: recurrentgemma-2b whole at 2 x 1024, phi3.5-moe cut
  from 32 layers to 2 at 2 x 1024, xlstm-1.3b at 4 of 48 layers (8
  until tp_heads: its phase read 10.7 s on an H100), 2 x 256, without
  remat (sLSTM loops over time on the host), paligemma-3b
  and musicgen-medium whole at 2 x 1024,
  one after another, each freed before the next: FAMILY_STEPS AdamW steps
  (bf16 weights, f32 moments) on one fixed batch, finite losses that fall,
  ms a step, tokens/s, peak memory; then the f32 directional check at the
  initial weights (``directional_check``, DIR_* constants): the central
  difference of the loss along a seeded direction against the gradient's
  change, within DIR_TOL, MoE routes pinned to those the weights chose.
* ``train_psa_moe``: phi3.5-moe at full width, 1 layer, on 2 pod ranks
  (``train_psa_rank``), PSA refreshed at steps 0 and 3, 4 steps of 2 x 512
  tokens a pod: finite losses equal on both pods, the first within
  TRAIN_LOSS_TOL of one rank's loss on the whole batch (its MoE routed per
  pod shard), projectors orthonormal within ORTHO_TOL, three Gram launches
  a compressed leaf an OI iteration, staged bytes twice those reduced. The
  rows ``gram_qr_psa_moe_*`` time row 4 at the expert stacks' (1, 4096,
  64) and (1, 6400, 64) and the head's (4096, 64), with the refreshes'
  launches at each, on the cluster route (checked as for train_psa).
* ``moe_shards``: phi3.5-moe at 4 layers, a 4 x 2048 prefill with
  ``act_specs["moe"]["n_dp"] = 4`` through row 9 (4 launches, all on the
  tensor cores): each MoE layer against the same tokens as 4 quarters
  each routed alone (routes and gates bit for bit, outputs within
  MOE_SHARD_RMS_TOL), the share of pairs dropped by shard and by one
  global routing, the logits against the global routing's.
* ``sharded_step``: h2o-danube-1.8b at full width cut to 4 layers on a
  (2, 2) ("data", "model") gloo mesh of 4 ranks sharing the card
  (``make_sharded_train_step``, expandable segments): each rank's stored
  bytes (``torch.cuda.memory_allocated``) equal to ``launch/dryrun``'s
  plan exactly; its first loss, grad norm and gradient probes against the
  same data shards' backward passes and f32 mean in one process (and the
  loss against the whole batch's); its wire bytes a step equal to
  ``launch/roofline.step_wire_bytes``. It is the unsplit route
  (``split_model=False``), the one tp_step is held against; its ranks
  then run tp_step's steps (one spawn for both).
* ``tp_step``: sharded_step's model, mesh and batch with the compute split
  over "model" (``make_sharded_train_step(split_model=True)``, remat on):
  stored bytes equal to the plan, wire bytes a step equal to
  ``step_wire_bytes(split_model=True)``, the first loss and grad norm
  within TP_LOSS_TOL / TP_GNORM_TOL of sharded_step's; ms and bytes staged
  through host memory a step, beside sharded_step's.
* ``remat``: recurrentgemma-2b at 2 x 1024, REMAT_STEPS steps at each of
  ``remat=False`` / ``"names"`` / ``True`` from the same weights: the first
  loss bit for bit, the grad norm within REMAT_GNORM_TOL, peak memory
  below remat off; ms a step. (train_families runs xlstm-1.3b and
  train_psa runs with ``remat=False`` for their time budgets, each line
  saying so; every other train step at the default ``True``.)
* ``tp_serve``: qwen2-7b at full width cut to 4 layers on a model axis of
  2 (``make_sharded_serve_step``, 2 gloo ranks sharing the card): a 2 x
  2048 prefill through row 9 on 14 query / 2 kv heads a rank, then 16
  teacher-forced decode steps, the logits against one process within
  LOGITS_TOL, 4 flash launches a rank on the tensor cores, the prefill's
  wire bytes equal to the plan; then TP_INT8_STEPS decode steps with the
  int8 KV cache (``kv_quant``) under the same split, within KV_QUANT_TOL
  of the bf16 split's, the state's bytes (``k_scale`` / ``v_scale``
  included) equal to the plan. The row ``flash_attention_tp_shard`` times
  row 9 at that shape against plain and SDPA and takes the ranks'
  launches.
* ``tp_recurrent``: the split over "model" for xlstm-1.3b, run by
  sharded_step's 4 ranks after tp_step (``tp_recurrent_steps``) at 4 of
  48 layers (2 mLSTM + sLSTM pairs) at 4 x 256, TP_REC_STEPS steps
  (recurrentgemma-2b's split train step runs in tp_heads): stored bytes equal to the plan, wire bytes
  equal to ``step_wire_bytes(split_model=True)`` (the gathers and their
  reduce-scatters), the first loss and grad norm within TP_LOSS_TOL /
  TP_GNORM_TOL of one process's (``one_process``); ms, staged bytes and
  peak memory.
* ``tp_frontends``: the same for the VLM and audio frontends, run by
  sharded_step's ranks after tp_recurrent: paligemma-3b at 4 of 18 layers
  (its 256 patch positions from make_lm_batch's seed 0, spliced over the
  activations gathered over "model"; its one kv head gathered) and
  musicgen-medium at 4 of 48 layers (4 codebook tables summed on a rank's
  pieces and gathered once; a head of 4 x 2048 columns, 2 codebooks a
  rank; the loss reduced a codebook at a time over "model"), 4 x 1024
  each, one step: stored bytes and wire bytes equal to the plan, the first
  loss and grad norm within TP_LOSS_TOL / TP_GNORM_TOL of one process's;
  ms, staged bytes and peak memory.
* ``tp_long_decode``: a batch of 1, which does not divide over "data",
  decoded teacher-forced from a fresh state by sharded_step's ranks after
  tp_frontends (``tp_long_rank``), each data rank the whole batch:
  h2o-danube-1.8b at 4 layers (its 8 kv heads over "model", its 8-slot
  ring cut by length over "data", 4 slots a rank, 6 steps),
  recurrentgemma-2b at 3 layers (RG-LRU, RG-LRU, windowed: the first 3 of
  its 13-entry pattern; cut from one 13-layer group for tp_tied's time)
  with a 4-slot window cut over
  ("data", "model"), a slot a rank, 5 steps past the wrap (held at
  DECODE_TOL, TP_LONG's comment), xlstm-1.3b in f32 at 4 layers, 2 steps
  (its states whole over "data"):
  each rank's logits against one process's, the decode state's bytes equal
  to the dry run's plan (the reference's long_500k specs), the wire bytes
  of each step (the partials' gather over the length group, "data" or
  "data+model") equal to the plan; ms and staged bytes a step.
* ``tp_heads``: query heads that do not divide over "model", run by
  sharded_step's ranks after tp_long_decode, laid out as (1, 4):
  recurrentgemma-2b at 3 layers (RG-LRU, RG-LRU, windowed; cut from one
  13-layer group for the script's time), its 10 query heads shared 3, 3,
  2, 2 (``wq``'s stored block 640 columns, 2.5 heads; its one kv head
  gathered). A split train step at 2 x 1024 (remat True): stored and wire
  bytes equal to the plan, the first loss and grad norm within
  TP_LOSS_TOL / TP_GNORM_TOL of one process's; ms, staged bytes and peak
  memory. Then a 2 x 2048 prefill through row 9 on each rank's own 3 or 2
  heads (window 2048; 1 launch a rank on the tensor cores) and 5
  teacher-forced decode steps on a 4-slot ring cut by length over
  "model", wrapped: each rank's logits within DECODE_TOL of one
  process's, the decode state's and the wire bytes equal to the plan. The
  row ``flash_attention_head_offset`` times row 9 at qwen2-7b's rank 1 of
  a model axis of 8 (its heads 4-7 reading kv heads 0 and 1) against
  plain and SDPA before, and takes the ranks' launches.
* ``tp_tied``: a tied head under the split over "model", run by
  sharded_step's ranks after tp_heads on the same (1, 4):
  tp_heads' model with ``tie_embeddings`` (d 2,560, V 256,000, no
  ``lm_head``: the logits are x @ embed^T), in tp_heads' cells and
  checks: a split train step at 2 x 1024 (remat True; each
  rank's vocabulary rows of the embedding by one all-to-all, the
  gradient back by another), a 2 x 2048 prefill through row 9 on each
  rank's 3 or 2 heads (its launches credited to the row
  ``flash_attention_head_offset``), 5 teacher-forced decode steps (the
  logits an f32 reduce-scatter of each rank's part), against one tied
  process; stored, wire and decode-state bytes equal to the plan.
* ``tp_recurrent_serve``: the same cuts on tp_serve's model axis of 2, run
  by its ranks after qwen2-7b: recurrentgemma-2b (3 layers)
  2 x 4096 prefill
  through row 9 on 5 of 10 query heads a rank against the gathered kv head
  (row ``flash_attention_tp_window``, 1 launch a rank on the tensor
  cores), 20 decode steps on a 16-slot ring cut by length (8 slots a
  rank, wrapped); the same in f32 at 2 x 512 and xlstm-1.3b in f32 at 2 x
  1024 with 16 steps; logits against one process (TP_REC_SERVE's
  limits), the decode state's bytes equal to the plan, the wire bytes of
  the prefill and each decode step equal to the plan.
* ``tp_frontends_serve``: tp_frontends' cuts on tp_serve's model axis of
  2, run by its ranks after tp_recurrent_serve: a 2 x 2048 prefill
  (paligemma with its patch embeddings) through row 9 on 4 of paligemma's
  8 query heads against its one gathered kv head at hd 256 (row
  ``flash_attention_tp_vlm``) and on 12 of musicgen's 24 heads at hd 64
  (row ``flash_attention_tp_audio``), every launch on the tensor cores,
  then 16 teacher-forced decode steps (paligemma's 16-slot ring cut by
  length over "model", musicgen's kv heads over "model"): the logits
  against one process within LOGITS_TOL in bf16, the decode state's and
  the wire bytes equal to the plan. The two rows time row 9 at those
  shards against plain and SDPA before the spawn and take the ranks'
  launches.
* ``roofline``: ``launch/roofline.run_cell``'s terms on one card beside
  the measured lm_prefill, lm_decode and every new train step.

Each phase's line carries ``at_s``, the script's seconds when it ended.
Launch counts are set to 0 just before each phase of the main path and read
just after it; launches made to compare or time a kernel do not count.
Every gram-apply and slab-apply launch of the main path must have taken the
TMA route (``gram_update.ROUTE_LAUNCHES``, ``slab_ops.ROUTE_LAUNCHES``) and
every slab tq launch the tiled kernel (``slab_ops.TQ_ROUTE_LAUNCHES``), but
bdot_sparse's grid launches and sdot_sparse's / sparse_faulty's gram-apply
launches, which must take the packed route: the rows count them as
``tma_launches`` and ``packed_launches``. Row 1 at sdot_sparse's own shape
(4,096 nodes of 784 x 16, r = 5) has a row of its own,
``batched_gram_apply_sdot_sparse``, timed on the packed route, which takes
the launches of sdot_sparse and sparse_faulty (SPARSE_GRAM_LAUNCHES).
Before the last line it prints ``{"kernels": [...]}`` and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Any failed
build, launch or check exits nonzero. With no CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bf16 on the tensor cores, dense
GRAM_TOL = 1e-5               # f32 sums in another order, relative to |V|
# runs of T_o gram-apply launches at sdot_sparse's stack, all on the packed
# route: sdot_sparse's S-DOT, SA-DOT bf16 and f32, sparse_faulty's f32, bf16
SPARSE_GRAM_LAUNCHES = 5
SLAB_TOL = 1e-5               # the same, relative to max |Z| or |V|
ELL_TOL = 1e-6                # same (quantised) source both sides, rel. |out|
GRAM_QR_TOL = 1e-5            # f32 sums in another order, relative to |G|
SPIN_CYCLES = 10_000_000      # ~5 ms of the card's clock ahead of a timed batch
SUBSPACE_TOL = 1e-4
# one run with bf16 gossip messages against the same run in f32 (the same
# algorithm, engine, graph and data): the payload's rounding may move a
# node's subspace by no more than the port's agreement limit
BF16_PAYLOAD_TOL = SUBSPACE_TOL
# the JAX reference's final errors on the CPU at the configurations of
# sdot_async, sdot_faulty, fdot_faulty and resume's async F-DOT
# (tools/reference_fault_errors.py); each phase's limit is SUBSPACE_TOL
# where the reference ends under it, else 10x the reference's final error
REF_FINAL_ERR = {"sdot_async": 2.9146583528927295e-06,
                 "sdot_faulty_realized": 1.0813985085178501e-07,
                 "sdot_faulty_nominal": 8.174351506795574e-08,
                 "fdot_faulty": 0.07244633138179779,
                 "fdot_async": 0.025843480601906776}
# With node 0 awake 1 round in 11, a step's error depends on how often it
# woke in that step's 50 rounds: the reference's own async S-DOT reads from
# 4e-7 to REF_ASYNC_SECOND_HALF_MAX over steps 51-100, so its final error
# is one draw of that spread. The port's own masks are another draw: that
# run is held to 10x the reference's worst second-half reading, and the
# run on the reference's own masks (tools/data/sdot_async_reference.npz)
# to the final-error limit and to the reference's trace.
REF_ASYNC_SECOND_HALF_MAX = 1.4254654524847865e-03
# the card's trace on the reference's masks against the reference's (CPU,
# JAX): f32 on both sides, gossip and QR summed in other orders
REF_TRACE_TOL = 1e-5
# the fault-free engines against sync S-DOT's trace
FAULT_FREE_TOL = 1e-5
# the baselines: fused against eager on the card, on traces in [0, 1]. The
# fused run debiases by the device table's f32 chain, the eager one by the
# host's float64 matrix power, both in f32 (as REF_TRACE_TOL); the card
# read at most 3.0e-6 (DPGD) on an NVIDIA H100 80GB HBM3 at 700 W
BASELINE_EAGER_TOL = 1e-5
# the card's baseline traces against the reference's on the CPU
# (tools/data/baselines_reference.npz), from the reference's own init: f32
# on both sides, the covs and every product summed in other orders (as
# REF_TRACE_TOL); the card read at most 1.9e-6 (DPGD), the same H100
BASELINE_REF_TRACE_TOL = 1e-5
# a sweep's lane against the port's own single run from the same init,
# where a sum may run in another order: F-DOT's lanes gossip their (n, r)
# partial products in one batched matmul and take their cross products in
# one einsum, and a ragged lane's node mean is masked (f32, as
# REF_TRACE_TOL; the card read at most 2.2e-6). S-DOT's lanes are held to
# the single run's bits
SWEEP_LANE_TOL = 1e-5
# the straggler of benchmarks/async_straggler.py (paper Table V): node 0
# awake a duty of T_ROUND / (T_ROUND + DELAY)
STRAGGLER_T_ROUND_S, STRAGGLER_DELAY_S = 0.001, 0.01
# flash attention against its plain version. bf16: both sides round an f32
# result to bf16 once, so a pair on either side of a rounding boundary lands
# one ulp apart: at most 2^-7 of that element, hence of the largest |out| in
# its own row (a row that averages n keys has |out| ~ n^-1/2, so a limit
# scaled by the whole tensor's max would pass a fault in the long rows).
# Only pairs whose f32 values straddle a boundary differ at all, so the
# RMS of the difference stays far below half an ulp (2^-8) of the RMS of
# the output; a fault that moves whole rows does not. f32: sums in another
# order, relative to max |out|, as for the others.
ATTN_BF16_TOL = 2.0 ** -7
ATTN_BF16_RMS_TOL = 2.0 ** -8
ATTN_F32_TOL = 1e-5
# qwen2-7b's logits, kernel against plain blockwise attention, RMS of the
# difference over RMS of the logits. A one-ulp difference in one layer's
# attention sets off bf16 rounding flips in every later GEMM and norm, so
# no closed form bounds this. The limit sits between readings on the card
# (NVIDIA H100 80GB HBM3, 700.00 W; the runs repeat to the last digit): the
# sound kernel's 0.01655 and the nearer faulty control's 0.01984 (q k^T
# rounded to bf16), at their geometric mean, 1.096x from each. lm_prefill
# runs both controls every time and fails if either passes. The sharper
# check is per layer: the kernel against the plain version on the same
# q, k, v of each of the 28 layers, held to the ATTN_BF16 limits.
LOGITS_TOL = (0.01655 * 0.01984) ** 0.5
# teacher-forced decode against prefill: every GEMM and the attention sum in
# another order, so each op's bf16 rounding may differ; the reference's own
# decode-vs-prefill test allows 5e-2.
DECODE_TOL = 5e-2


# the serving phases (tools/data/serving_reference.json's configuration)
SERVING_REF = Path(__file__).resolve().parent / "tools" / "data" / \
    "serving_reference.json"
SKETCH_TOL = 1e-5             # f32 running sums against float64, rel. max
SERVING_ERR_FACTOR = 2.0      # post-shift error <= 2x the reference's
# serving_chaos's stall timeout: the wedged tick is killed after it. 8 s
# (run_supervised's default) until PR 27, 3 s since: the card beats every
# tick (2.3-3.0 ticks/s) and re-solve chunk, and a finished child is not
# judged by it (run_supervised)
CHAOS_STALL_S = 3.0
GATE_POST_ERR = 0.2           # run_smoke's recovery limit after a reject


def ref_limit(name: str) -> float:
    ref = REF_FINAL_ERR[name]
    return SUBSPACE_TOL if ref <= SUBSPACE_TOL else 10 * ref


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_rel_judge(tol: float):
    """max |got - want| within ``tol`` of max |want| (f32 tensors)."""
    def judge(name, got, want):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}")
        return {"max_abs_err": err, "rel_err": err / scale}
    return judge


def attn_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Flash attention's bf16 output against its plain version, (..., rows,
    hd): the max abs error, the largest error over its own row's max |want|
    (``row_rel_err``) and the relative RMS error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row_err = diff.amax(-1)
    return {"max_abs_err": float(row_err.max()),
            "row_rel_err": float(torch.where(
                row_err == 0, 0.0, row_err / want.abs().amax(-1)).max()),
            "rel_rms": float(diff.square().sum().sqrt()
                             / want.square().sum().sqrt())}


def attn_within(stats: dict) -> bool:
    return (stats["row_rel_err"] <= ATTN_BF16_TOL
            and stats["rel_rms"] <= ATTN_BF16_RMS_TOL)


def attn_judge(dtype: torch.dtype):
    """Flash attention against its plain version: bf16 by row
    (ATTN_BF16_TOL) and by RMS (ATTN_BF16_RMS_TOL), f32 by max |out|
    (ATTN_F32_TOL)."""
    if dtype != torch.bfloat16:
        return max_rel_judge(ATTN_F32_TOL)

    def judge(name, got, want):
        stats = attn_stats(got, want)
        check(attn_within(stats), f"{name}: {stats} outside {ATTN_BF16_TOL} "
              f"of a row's max |out| or {ATTN_BF16_RMS_TOL} relative RMS")
        return {**stats, "rms_tolerance": ATTN_BF16_RMS_TOL}
    return judge


def attn_plain(q, k, v, **kw):
    """ops.flash_attention's CPU path, on the card."""
    from repro_torch.kernels import ref
    skv = k.shape[2]
    return ref.flash_attention_plain(q, k, v, q_offset=skv - q.shape[2],
                                     kv_valid=skv, **kw)


def kernel_uncounted(drop=0):
    """The kernel through its launcher, not counted, with its last ``drop``
    keys masked: drop = 64 (one kv tile) is a faulty control, a fault
    confined to the last 64 rows of each sequence."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def attn(q, k, v, *, causal, window, group=None, q_head0=0):
        skv = k.shape[2]
        return flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=q.shape[-1] ** -0.5,
            q_offset=skv - q.shape[2], kv_valid=skv - drop, group=group,
            q_head0=q_head0)
    return attn


def layer_check(attn, stats):
    """An attention for ``with_patched`` that runs ``attn`` and the plain
    version on the same q, k, v of every layer, appends attn_stats to
    ``stats`` and passes the plain output on, so every layer sees the
    activations of a forward through the plain version."""
    def run(q, k, v, **kw):
        want = attn_plain(q, k, v, **kw)
        stats.append(attn_stats(attn(q, k, v, **kw), want))
        return want
    return run


def with_patched(module, name: str, value, fn):
    """``fn()`` with ``module.name`` set to ``value``: for functions its
    callers look up on every call (ops.flash_attention in
    models/attention.py, route in models/moe.py)."""
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    finally:
        setattr(module, name, kept)


def compare(got, want):
    """(relative RMS difference, max abs difference, top-1 agreement) of
    two logits tensors, in f32, one sequence at a time."""
    sq_diff = sq_want = max_abs = 0.0
    agree = picks = 0
    for i in range(got.shape[0]):
        a, b = got[i].float(), want[i].float()
        sq_diff += float((a - b).square().sum())
        sq_want += float(b.square().sum())
        max_abs = max(max_abs, float((a - b).abs().max()))
        same = a.argmax(-1) == b.argmax(-1)
        agree += int(same.sum())
        picks += same.numel()
    return (sq_diff / sq_want) ** 0.5, max_abs, agree / picks


def time_ms(fn, reps: int = 20, batches: int = 5, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around a batch of ``reps``
    back-to-back calls, divided by ``reps``, median of ``batches`` batches.

    Each batch is queued behind a spin of the card (``torch.cuda._sleep``,
    ~5 ms), so the host has enqueued the whole batch before the card reaches
    it and the events time the card's work alone: a small kernel's wrapper
    takes longer on the host than the kernel on the card, and without the
    spin the batch would time the host's launch rate.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host time to enqueue one call, in us: ``calls`` calls queued behind a
    ~20 ms spin of the card, so none waits for the card, median of 3."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda._sleep(4 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(text: str):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]


def ptxas_entries(text: str, fragment: str) -> dict:
    """The ptxas report of each kernel whose (mangled) name holds
    ``fragment``: registers, spill stores and loads, static shared memory."""
    entries, cur = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            cur = name if fragment in name else None
            if cur:
                entries[cur] = {"line": []}
        elif cur and ("registers" in ln or "spill" in ln):
            entries[cur]["line"].append(ln.strip())
            words = ln.replace(",", " ").split()
            for i, w in enumerate(words[1:], 1):
                if w == "registers":
                    entries[cur]["registers"] = int(words[i - 1])
                elif w == "stores":
                    entries[cur]["spill_store_bytes"] = int(words[i - 3])
                elif w == "loads":
                    entries[cur]["spill_load_bytes"] = int(words[i - 3])
                elif w.startswith("smem"):
                    entries[cur]["static_smem_bytes"] = int(words[i - 2])
    return entries


def sass_counts(tool: Path, lib: Path, fragment: str, opcode: str) -> dict:
    """How many ``opcode`` instructions the SASS of each kernel whose name
    holds ``fragment`` has (``tool`` = cuobjdump, on the built library), or
    "not measured" where the toolkit has no cuobjdump."""
    if not tool.exists():
        return {"not measured": "no cuobjdump"}
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if fragment in name:
            counts[name] = sum(ln.count(opcode) for ln in part.splitlines())
    return counts


def profile_phase(run, phase: str = "profile",
                  what: str = "sdot_dense S-DOT, T_o = 20, t_c = 50",
                  groups=None, warm: bool = True, labels=()) -> dict:
    """Device time by kernel over one short run, from torch.profiler.

    ``groups`` maps a label to name fragments: each kernel's time goes to
    the first label one of whose fragments its name holds, else to "rest".
    ``warm=False`` profiles the first call (a stateful run, already warm);
    ``labels`` names ``record_function`` ranges whose device time (ms) is
    reported under "labels" (None where the profile gives none).
    """
    from torch.profiler import ProfilerActivity, profile
    if warm:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}   # device kernels only: an aten op's device time repeats them
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key in labels:          # a label's range, not a kernel
            continue
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_name[evt.key] = (dev_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    label_ms = {}
    for evt in prof.key_averages():
        if evt.key in labels:
            dev_us = getattr(evt, "device_time_total", 0.0)
            label_ms[evt.key] = dev_us / 1e3 if dev_us > 0 else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    grouped = {}
    if groups:
        grouped = {label: {"ms": 0.0, "calls": 0} for label in [*groups,
                                                                 "rest"]}
        for name, (ms, calls) in by_name.items():
            label = next((lb for lb, frags in groups.items()
                          if any(f in name.lower() for f in frags)), "rest")
            grouped[label]["ms"] += ms
            grouped[label]["calls"] += calls
        for g in grouped.values():
            g["share_of_busy"] = g["ms"] / busy_ms if busy_ms else None
    out = {"phase": phase, "what": what, "groups": grouped or None,
           "wall_ms": wall_ms,
           "device_kernel_launches": (sum(c for _, c in by_name.values())
                                      if by_name else "not measured"),
           "device_busy_ms": busy_ms if by_name else "not measured",
           "device_busy_share": busy_ms / wall_ms if by_name else
           "not measured",
           "top_kernels": [{"name": k[:80], "ms": v[0], "calls": v[1]}
                           for k, v in top]}
    if labels:
        out["labels"] = {name: label_ms.get(name) for name in labels}
    return out




def make_record(rows: dict):
    """``record(...)``: time and check one kernel row into ``rows``."""
    def record(name, source, replaces, kernel, plain, library, nbytes, flops,
               tol, note, flop_rate=F32_FLOP_PER_S, judge=None, host=False):
        """One kernel row; ``host`` adds the host's time to issue a call
        (the kernel's and the library call's) and a check that a second
        launch repeats the bits."""
        got = kernel().float()
        again = kernel().float() if host else got
        torch.cuda.synchronize()
        want = plain().float()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.equal(got, again), f"{name}: two launches differ")
        errs = (judge or max_rel_judge(tol))(name, got, want)
        del got, again, want
        b_ms, b_by = bound(nbytes, flops, flop_rate)
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs.pop("max_abs_err"),
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library),
            **errs, "tolerance": tol, "tolerance_reason": note,
        }
        if host:
            rows[name].update(
                same_bits_twice=True, tma_launches=0,
                host_us=host_us(kernel),
                library_host_us=None if library is None else host_us(library))
    return record


def wall_ms(fn, calls: int = 5) -> float:
    """Host wall time of one call, the card synchronised at both ends (for
    calls that wait for the card themselves: SVD, eigh)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def span_ms(registry, name: str) -> dict:
    """Mean and count of a journal span's durations (host wall, ms)."""
    h = registry.histogram(f"span_{name}_seconds")
    return {"mean_ms": None if not h.count else h.sum / h.count * 1e3,
            "count": h.count}


def serving_phases(dev, rows: dict, work: Path) -> None:
    """streams_ingest, serving, serving_chaos, warm_start, profile_serving:
    the streaming and serving path at the CIFAR-10 width of
    tools/data/serving_reference.json's configuration (module docstring)."""
    from repro_torch.core.linalg import orthonormal_init
    from repro_torch.core.metrics import subspace_error
    from repro_torch.core.runtime import run_monolithic
    from repro_torch.core.sdot import sdot_program
    from repro_torch.data.pipeline import (drifting_eigengap_stream,
                                           partition_samples)
    from repro_torch.kernels import gram_qr, ops
    from repro_torch.serving import service as svc_mod
    from repro_torch.serving.service import (PSAService, ServiceConfig,
                                             service_summary)
    from repro_torch.streaming.chaos import ENV_PLAN
    from repro_torch.streaming.ingest import StreamingIngestor, ritz_step
    from repro_torch.streaming.launcher import build_engine

    ref = json.loads(SERVING_REF.read_text())
    cfg = ServiceConfig(**ref["config"])
    d, r, n_nodes, m = cfg.d, cfg.r, cfg.n_nodes, cfg.batch_size
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # -- streams_ingest -------------------------------------------------------
    def stream():
        return drifting_eigengap_stream(d, r, cfg.gap, cfg.shift_at,
                                        seed=cfg.stream_seed, lead=cfg.lead,
                                        shift_lead=cfg.shift_lead,
                                        device=dev)[0]
    fn, fn2 = stream(), stream()
    same_bits = (torch.equal(fn(5, m), fn2(5, m))
                 and torch.equal(fn(cfg.shift_at + 3, m), fn(
                     cfg.shift_at + 3, m))
                 and not torch.equal(fn(5, m), fn(6, m)))
    n_batches, ell = cfg.total_ticks, 128
    ing = StreamingIngestor(n_nodes=n_nodes, d=d, batch_fn=fn, batch_size=m,
                            track_top=r, device=dev)
    fd = StreamingIngestor(n_nodes=n_nodes, d=d, batch_fn=fn, batch_size=m,
                           sketch="fd", ell=ell, device=dev)
    sm64 = torch.zeros((n_nodes, d, d), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for t in range(n_batches):
        ing.ingest(1)
        blocks = torch.stack(partition_samples(fn(t, m), n_nodes)).double()
        sm64 += blocks @ blocks.mT
    torch.cuda.synchronize()
    ing_wall = (time.perf_counter() - t0) / n_batches * 1e3
    t0 = time.perf_counter()
    fd.ingest(n_batches)
    torch.cuda.synchronize()
    fd_wall = (time.perf_counter() - t0) / n_batches * 1e3
    sketch_err = float((ing.sketch.second_moment.double() - sm64).abs().max()
                       / sm64.abs().max())
    b = fd.sketch.sketch.double()
    fd_gap = torch.linalg.eigvalsh(sm64 - b.mT @ b).abs().amax(-1)
    fd_loss = fd.sketch.shrink_loss.double()
    fd_ok = bool((fd_gap <= fd_loss * (1 + 1e-4) + 1e-4).all())
    blocks = torch.stack(partition_samples(fn(0, m), n_nodes))
    sk, basis = ing.sketch, ing._ritz_basis
    upd_bytes = (2 * sk.second_moment.numel() + blocks.numel()) * 4
    upd_flops = 2 * n_nodes * d * d * (m // n_nodes)
    upd_bound, upd_by = bound(upd_bytes, upd_flops)
    streams_ingest = {
        "phase": "streams_ingest", "d": d, "nodes": n_nodes,
        "batch": m, "batches": n_batches, "ell": ell,
        "stream_same_bits": same_bits,
        "sketch_max_rel_err_vs_f64": sketch_err, "sketch_tol": SKETCH_TOL,
        "fd_bound_holds": fd_ok,
        "fd_max_gap_over_loss": float((fd_gap / fd_loss).max()),
        "ms_exact_update": time_ms(lambda: sk.update(blocks)),
        "ms_exact_update_bound": upd_bound, "exact_update_bound_by": upd_by,
        "ms_fd_update": wall_ms(lambda: fd.sketch.update(blocks), 3),
        "ms_ritz_step": wall_ms(lambda: ritz_step(sk, basis), 10),
        "ms_ingest_exact_with_ritz_wall": ing_wall,
        "ms_ingest_fd_wall": fd_wall,
        "stream_draw_ms": time_ms(lambda: fn(3, m)),
    }
    emit(streams_ingest)
    check(same_bits, "streams_ingest: a stream batch is not a pure function "
          "of (seed, step) on the card")
    check(sketch_err <= SKETCH_TOL, f"streams_ingest: exact sketch "
          f"{sketch_err} from the float64 sum")
    check(fd_ok, f"streams_ingest: FD bound broken: {fd_gap} > {fd_loss}")
    del ing, fd, sm64, b, sk, basis, blocks

    # -- serving: the configuration fault-free --------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    svc = PSAService(cfg, str(work / "serving"), device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    svc.finalize()
    launches = ops.LAUNCHES["gram_qr"]
    rows["gram_qr"]["launches"] += launches
    check(gram_qr.ROUTE_LAUNCHES["cluster"] == 0, "serving: re-solve Gram "
          f"launches on the cluster route {dict(gram_qr.ROUTE_LAUNCHES)}")
    served = service_summary(str(work / "serving"))
    post_err = float(subspace_error(svc.q_post, svc.served.device))
    # the reference's subspace after as many swaps: the last drift trigger
    # sits at the threshold (tools/data/serving_reference.json's drift
    # reads), so on another stream the last re-solve may still be running
    # at the final tick
    after = ref["post_shift_err_after_swap"]
    err_limit = SERVING_ERR_FACTOR * after[min(svc.swaps, len(after)) - 1]
    completed = svc.swaps + svc.gate_rejects
    steps_run = cfg.t_outer * completed + (svc.resolve_done
                                           if svc.resolve_active else 0)
    reg = svc.registry
    serving = {
        "phase": "serving", "config": ref["config"],
        "setup_s": setup_s, "run_s": run_s,
        "ticks_per_s": cfg.total_ticks / run_s,
        "ms_a_tick": {k: span_ms(reg, k) for k in (
            "tick", "ingest", "resolve_increment", "drift_read",
            "query_drain", "tick_checkpoint", "gate")},
        "resolve_steps_a_tick": cfg.resolve_chunk * cfg.chunks_per_tick,
        "snapshot_bytes": svc.snapshot_bytes(),
        "queries": served["queries"],
        "swaps": served["swaps"], "swap_ticks": served["swap_ticks"],
        "gate_rejects": served["gate_rejects"],
        "max_staleness": served["max_staleness"],
        "staleness_bound": cfg.staleness_bound,
        "served_sha256": served["served_sha256"],
        "post_shift_err": post_err, "post_shift_err_limit": err_limit,
        "resolve_active_at_end": svc.resolve_active,
        "resolve_steps_run": steps_run,
        "gram_qr_launches": launches,
        "gram_qr_expected": 2 * steps_run + 2 * completed,
        "reference_cpu": {k: ref[k] for k in (
            "swap_ticks", "max_staleness", "post_shift_err",
            "post_shift_err_after_swap")},
    }
    emit(serving)
    q = served["queries"]
    check(served["swaps"] >= 2 and served["gate_rejects"] == 0,
          f"serving: swaps {served['swaps']}, rejects "
          f"{served['gate_rejects']}")
    check(served["max_staleness"] <= cfg.staleness_bound,
          f"serving: staleness {served['max_staleness']}")
    check(q["answered"] == q["submitted"] and q["submitted"] ==
          cfg.total_ticks * cfg.queries_per_tick,
          f"serving: queries {q}")
    check(post_err <= err_limit, f"serving: post-shift error {post_err} > "
          f"{err_limit} ({SERVING_ERR_FACTOR}x the reference's after "
          f"{svc.swaps} swaps)")
    check(launches == serving["gram_qr_expected"],
          f"serving: {launches} Gram launches, expected "
          f"{serving['gram_qr_expected']}")
    del svc

    # -- serving_chaos: kill / kill / hang under supervision, then the gate ---
    # the reference's plan kills the re-solve at step 6, a chunk boundary at
    # its resolve_chunk of 3; at resolve_chunk 10 the boundary is step 30,
    # the first chunk of a tick's two
    chaos_dir = work / "chaos"
    chaos_dir.mkdir()
    plan_path = svc_mod.smoke_plan(resolve_boundary=3 * cfg.resolve_chunk
                                   ).dump(str(chaos_dir / "plan.json"))
    env = {**os.environ, ENV_PLAN: plan_path}
    t0 = time.perf_counter()
    chaos = svc_mod.run_supervised(cfg, str(chaos_dir), env=env,
                                   stall_timeout=CHAOS_STALL_S)
    chaos_s = time.perf_counter() - t0
    matches = [e["pinned_match"] for e in chaos["restores"]]
    t0 = time.perf_counter()
    gsvc = PSAService(cfg, str(work / "gate"), plan=svc_mod.gate_plan(),
                      device=dev).run()
    gate = gsvc.finalize()
    gate_s = time.perf_counter() - t0
    gate_err = float(subspace_error(gsvc.q_post, gsvc.served.device))
    gate_events = service_summary(str(work / "gate"))
    serving_chaos = {
        "phase": "serving_chaos", "plan": json.loads(Path(
            plan_path).read_text()),
        "relaunches": chaos["relaunches"], "attempts": chaos["attempts"],
        "wall_s": chaos_s,
        "served_sha256_equal": chaos["served_sha256"] ==
        serving["served_sha256"],
        "swap_ticks": chaos["swap_ticks"],
        "restores": chaos["restores"],
        "gate": {"gate_rejects": gate["gate_rejects"],
                 "cold_resolves": gate["cold_resolves"],
                 "swaps": gate["swaps"],
                 "reject_ticks": gate_events["reject_ticks"],
                 "swap_ticks": gate_events["swap_ticks"],
                 "served_finite": bool(np.all(np.isfinite(gsvc.served_q))),
                 "post_shift_err": gate_err, "queries": gate["queries"],
                 "wall_s": gate_s}}
    emit(serving_chaos)
    check(chaos["relaunches"] == 3, f"serving_chaos: {chaos['relaunches']} "
          "relaunches, expected 3")
    check(serving_chaos["served_sha256_equal"]
          and chaos["swap_ticks"] == serving["swap_ticks"],
          "serving_chaos: the supervised run's trajectory differs")
    check(all(mt is not False for mt in matches) and any(
        mt is True for mt in matches), f"serving_chaos: restores {matches}")
    g = serving_chaos["gate"]
    check(g["gate_rejects"] == 1 and g["cold_resolves"] == 1
          and g["swaps"] >= 2 and g["served_finite"]
          and gate_err < GATE_POST_ERR and g["queries"]["expired"] > 0,
          f"serving_chaos: gate run {g}")
    del gsvc

    # -- warm_start: iterations to 1e-3 after the shift, warm against cold ----
    wref = ref["warm_start"]
    wfn = stream()
    wing = StreamingIngestor(n_nodes=n_nodes, d=d, batch_fn=wfn,
                             batch_size=m, device=dev)
    wing.ingest(wref["pre_batches"])
    covs_pre = wing.cov_stack()
    wing.ingest(wref["post_batches"])
    covs_post = wing.cov_stack()
    engine = build_engine(cfg.topology, device=dev)
    evecs = torch.linalg.eigh(covs_post.double().sum(0))[1]
    q_true = evecs[:, -r:].flip(-1).float()

    def solve(covs, seed_or_q, t_outer, q_true=None):
        q_init = (orthonormal_init(torch.Generator().manual_seed(seed_or_q),
                                   d, r, device=dev)
                  if isinstance(seed_or_q, int) else seed_or_q)
        return run_monolithic(sdot_program(
            covs=covs, engine=engine, r=r, t_outer=t_outer, t_c=cfg.t_c,
            q_init=q_init, q_true=q_true, device=dev))

    def to_target(trace):
        below = np.flatnonzero(np.asarray(trace) < wref["target"])
        return int(below[0]) + 1 if below.size else None

    incumbent = solve(covs_pre, 3, wref["incumbent_t_outer"]).q_nodes.mean(0)
    cold = solve(covs_post, 4, wref["t_outer"], q_true).error_trace
    warm = solve(covs_post, incumbent, wref["t_outer"], q_true).error_trace
    warm_start = {
        "phase": "warm_start", "target": wref["target"],
        "t_outer": wref["t_outer"],
        "incumbent_err": float(subspace_error(q_true, incumbent)),
        "iterations_cold": to_target(cold),
        "iterations_warm": to_target(warm),
        "final_err_cold": float(cold[-1]), "final_err_warm": float(warm[-1]),
        "reference_cpu": {k: wref[k] for k in (
            "incumbent_err", "iterations_cold", "iterations_warm",
            "final_err_cold", "final_err_warm")}}
    emit(warm_start)
    check(np.isfinite(cold).all() and np.isfinite(warm).all(),
          "warm_start: non-finite traces")
    del wing, covs_pre, covs_post, engine

    # -- profile_serving: 4 ticks with the initial re-solve active ------------
    psvc = PSAService(cfg, str(work / "profile"), device=dev)
    psvc.run(until=cfg.warmup_ticks)
    first = cfg.warmup_ticks
    prof = profile_phase(
        lambda: psvc.run(until=first + 4), "profile_serving",
        f"serving, ticks {first}-{first + 3} with the initial re-solve "
        "active", groups={"gram_qr": ("gram_qr_",),
                          "gemm": ("gemm", "nvjet", "xmma", "cutlass",
                                   "splitk", "gemv"),
                          "snapshot_copy": ("memcpy dtoh",)},
        warm=False, labels=("ingest_sketch_update",))
    sketch_ms = prof.pop("labels").get("ingest_sketch_update")
    if prof["groups"] and sketch_ms is not None:
        prof["groups"]["sketch_update"] = {"ms": sketch_ms,
                                           "of": "gemm (its own label)"}
        prof["groups"]["gemm"]["ms_without_sketch_update"] = \
            prof["groups"]["gemm"]["ms"] - sketch_ms
    prof["device_kernel_launches_a_tick"] = (
        prof["device_kernel_launches"] / 4
        if isinstance(prof["device_kernel_launches"], (int, float))
        else "not measured")
    emit(prof)
    del psvc
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# the rest of the LM side: MoE, recurrent and frontend families
# ---------------------------------------------------------------------------
LM_TF_TOKENS = 64             # teacher-forced decode against prefill
LM_GEN_STEPS = 8              # greedy steps timed after it
# test_models_smoke.py's MoE capacity for decode-vs-prefill: nothing drops
# in the 64-token forward, so routing cannot depend on the co-batched tokens
TF_CAPACITY_FACTOR = 64.0
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:86"
ATTN_BF16_NOTE = ("bf16: each side rounds an f32 result once; one bf16 ulp "
                  "(2^-7) of the largest |out| in the element's own row, and "
                  "relative RMS within half an ulp (2^-8)")


def hd256_rows(dev, rows: dict, record) -> None:
    """kernels_hd256: row 9 at head dim 256, bf16 at recurrentgemma-2b's
    and paligemma-3b's prefills, f32 off the main path, with ptxas's report
    and the HGMMA count of the hd-256 instantiations; and at head dim 64,
    musicgen-medium's prefill."""
    from repro_torch.kernels import _build, ops
    gen = torch.Generator(device=dev).manual_seed(24)

    def inputs(dtype, b, hq, hkv, s):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, hq, s, 256), (b, hkv, s, 256),
                              (b, hkv, s, 256))]

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    # recurrentgemma-2b: 10 / 1 heads, 2 x 4096 tokens, window 2048. SDPA
    # has no window argument: its yardstick takes the band as a mask
    q, k, v = inputs(torch.bfloat16, 2, 10, 1, 4096)
    pos = torch.arange(4096, device=dev)
    band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 2048)
    pairs = int(band.sum())
    record("flash_attention_hd256_recurrentgemma", FLASH_SOURCE,
           FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True, window=2048),
           lambda: attn_plain(q, k, v, causal=True, window=2048),
           lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * 2 * 10 * 256 * pairs, ATTN_BF16_TOL, ATTN_BF16_NOTE,
           flop_rate=BF16_TC_FLOP_PER_S, judge=attn_judge(torch.bfloat16))
    rows["flash_attention_hd256_recurrentgemma"].update(
        kernel="flash_attention_wgmma_kernel<256>", visible_pairs=pairs,
        library="scaled_dot_product_attention, GQA, explicit band mask")
    shapes["recurrentgemma"] = [list(q.shape), list(k.shape), 2048]
    del q, k, v, band
    # paligemma-3b: 8 / 1 heads, 4 x 2048 tokens, causal
    q, k, v = inputs(torch.bfloat16, 4, 8, 1, 2048)
    record("flash_attention_hd256_paligemma", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True),
           lambda: attn_plain(q, k, v, causal=True),
           lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * 4 * 8 * 256 * 2048 * 2049 / 2, ATTN_BF16_TOL,
           ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
           judge=attn_judge(torch.bfloat16))
    rows["flash_attention_hd256_paligemma"].update(
        kernel="flash_attention_wgmma_kernel<256>",
        library="scaled_dot_product_attention, causal, GQA")
    shapes["paligemma"] = [list(q.shape), list(k.shape), None]
    del q, k, v
    # musicgen-medium at hd 64: 24 / 24 heads, 4 x 2048 tokens, causal
    # (lm_frontends' 48 launches)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in [(4, 24, 2048, 64)] * 3)
    record("flash_attention_hd64_musicgen", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True),
           lambda: attn_plain(q, k, v, causal=True),
           lambda: sdpa(q, k, v, is_causal=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * 4 * 24 * 64 * 2048 * 2049 / 2, ATTN_BF16_TOL,
           ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
           judge=attn_judge(torch.bfloat16))
    rows["flash_attention_hd64_musicgen"].update(
        kernel="flash_attention_wgmma_kernel",
        library="scaled_dot_product_attention, causal")
    shapes["musicgen"] = [list(q.shape), list(k.shape), None]
    del q, k, v
    # the CUDA-core kernel at hd 256 (f32: off the bf16 main path)
    q, k, v = inputs(torch.float32, 1, 10, 1, 1024)
    record("flash_attention_hd256_f32", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True),
           lambda: attn_plain(q, k, v, causal=True),
           lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
           4 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * 10 * 256 * 1024 * 1025 / 2, ATTN_F32_TOL,
           "f32 sums in another order; relative to max |out|",
           judge=attn_judge(torch.float32))
    rows["flash_attention_hd256_f32"].update(
        kernel="flash_attention_simt_kernel<256>", main_path=False,
        library="scaled_dot_product_attention, f32, causal, GQA",
        note="the f32 route: not on the bf16 main path, so 0 launches there")
    shapes["f32"] = [list(q.shape), list(k.shape), None]
    del q, k, v
    lib = _build.build_all()["flash_attention"]
    report = lib.with_suffix(".ptxas.txt").read_text()
    ptxas = {**ptxas_entries(report, "flash_attention_wgmma_kernelILi256E"),
             **ptxas_entries(report, "flash_attention_simt_kernelILi256E")}
    hgmma = sass_counts(Path(_build.nvcc_path()).with_name("cuobjdump"), lib,
                        "flash_attention_wgmma_kernelILi256E", "HGMMA")
    emit({"phase": "kernels_hd256", "shapes": shapes, "ptxas": ptxas,
          "hgmma": hgmma,
          "serialized": [ln.split(":", 1)[-1].strip()
                         for ln in report.splitlines()
                         if "C75" in ln and "ILi256E" in ln],
          "kernels": [rows[name] for name in (
              "flash_attention_hd256_recurrentgemma",
              "flash_attention_hd256_paligemma",
              "flash_attention_hd64_musicgen",
              "flash_attention_hd256_f32")]})
    check(len(ptxas) == 2, f"kernels_hd256: ptxas report {list(ptxas)}")
    for name, n in hgmma.items():
        check(name == "not measured" or n > 0,
              f"kernels_hd256: no HGMMA in {name}")


def slstm_launches_a_token(params, cfg, dev) -> object:
    """Device kernels one sLSTM layer launches a token: a profile of the
    layer over 32 tokens less one over 16, over 16 (the input and FFN
    GEMMs, launched once a call, cancel)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.recurrent import apply_slstm
    from repro_torch.models.transformer import tree_map
    p = tree_map(lambda leaf: leaf[0], params["groups"]["blk1_slstm"]["mixer"])
    counts = {}
    for s in (16, 32):
        x = torch.randn((1, s, cfg.d_model), device=dev).to(cfg.torch_dtype)
        apply_slstm(p, x, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            apply_slstm(p, x, cfg)
            torch.cuda.synchronize()
        counts[s] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0)
    if not counts[16]:
        return "not measured"
    return (counts[32] - counts[16]) / 16


def recording_route(recorded: list):
    """moe.route that appends each call's expert choices (t, k) to
    ``recorded``: one entry an MoE layer, in the order the layers run."""
    from repro_torch.models import moe

    def route(xf, router, m, cap):
        gates, eidx = torch.topk(moe.router_probs(xf, router), m.top_k, -1)
        recorded.append(eidx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return (gates, *moe.assign_slots(eidx, m.n_experts, cap))
    return route


def pinned_route(recorded: list, token_rows, flips: list):
    """moe.route for one decode step that takes, at the i-th MoE layer of
    the step, the experts ``recorded[i][token_rows]`` chose in prefill,
    with gates from this step's own router softmax at them; appends to
    ``flips`` how many of the step's tokens' own top-k sets differ from
    them, and the widest own-minus-pinned probability gap among those."""
    from repro_torch.models import moe
    calls = iter(range(len(recorded)))

    def route(xf, router, m, cap):
        probs = moe.router_probs(xf, router)
        eidx = recorded[next(calls)][token_rows]
        own, own_idx = torch.topk(probs, m.top_k, -1)
        differ = (own_idx.sort(-1).values != eidx.sort(-1).values).any(-1)
        gap = own.sum(-1) - probs.gather(-1, eidx).sum(-1)
        flips.append((differ.sum(), torch.where(differ, gap, 0.0).max()))
        gates = probs.gather(-1, eidx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return (gates, *moe.assign_slots(eidx, m.n_experts, cap))
    return route


def teacher_forced(params, cfg, prompt, dev) -> dict:
    """decode_step over ``prompt`` (b, LM_TF_TOKENS), one token a step,
    against forward over it: ``vs_prefill`` (relative RMS, max abs, top-1
    agreement), the wall, the state's bytes, and the state and greedy next
    token to go on from. MoE steps take prefill's experts
    (``pinned_route``); the routes that flipped are counted."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state,
                                                tree_leaves)
    lm_b = prompt.shape[0]
    recorded, flips = [], []
    prefilled = with_patched(moe, "route", recording_route(recorded),
                             lambda: forward(params, {"tokens": prompt}, cfg))
    state = init_decode_state(cfg, lm_b, LM_TF_TOKENS + LM_GEN_STEPS,
                              device=dev)
    out = {"state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(state["caches"])),
           "teacher_forced": LM_TF_TOKENS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for t in range(LM_TF_TOKENS):
        # prefill's token rows of this step: (b, s) flattened b-major
        step_route = pinned_route(recorded, torch.arange(
            lm_b, device=dev) * LM_TF_TOKENS + t, flips)
        lg, state = with_patched(moe, "route", step_route, lambda: decode_step(
            params, state, prompt[:, t:t + 1], cfg))
        outs.append(lg)
    decoded = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    out["teacher_forced_wall_s"] = time.perf_counter() - t0
    rel_rms, max_abs, top1 = compare(decoded, prefilled)
    out["vs_prefill"] = {"rel_rms": rel_rms, "max_abs": max_abs,
                         "top1_agreement": top1, "tolerance": DECODE_TOL,
                         "dtype": cfg.dtype}
    if flips:
        out["moe_teacher_forced_routes"] = {
            "pinned_to_prefill": len(flips) * lm_b,
            "flipped": int(sum(n for n, _ in flips)),
            "widest_flip_gap": max(float(g) for _, g in flips)}
    out["state"] = state
    out["next"] = decoded[:, -1:].argmax(-1).to(torch.int32)
    return out


def chaos_gain(params, cfg, prompt) -> float:
    """How far this model carries a perturbation: the logits' relative RMS
    change over ``prompt`` when every embedding entry moves by 1e-3 of
    itself (a fixed normal draw), over 1e-3."""
    from repro_torch.models.transformer import embed_inputs, forward
    x = embed_inputs(params, {"tokens": prompt}, cfg)
    gen = torch.Generator(device=x.device).manual_seed(3)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    a = forward(params, {"inputs_embeds": x}, cfg)
    b = forward(params, {"inputs_embeds": x * (1 + 1e-3 * noise)}, cfg)
    return compare(b, a)[0] / 1e-3


def lm_serve_phase(phase: str, cfg, dev, rows: dict, lm_b: int, lm_s: int,
                   flash_row: str = "flash_attention", extra=None,
                   tf_f32: bool = False) -> dict:
    """One architecture on the card in bf16 from random weights
    (torch.Generator seed 0): a timed prefill of make_lm_batch(seed 0),
    lm_b x lm_s tokens (wall, tokens/s, peak memory, the share of the bf16
    peak from analytic_cost's FLOPs); one flash launch an attention layer,
    all on the tensor-core route, each layer's kernel output within the
    bf16 limits of the plain version on its own q, k, v; MoE: the share
    of (token, choice) pairs dropped at the config's capacity.
    Teacher-forced decode_step over the first LM_TF_TOKENS tokens (a pure
    token stream) within DECODE_TOL of forward over them, then
    LM_GEN_STEPS greedy steps: ms a step, finite logits, tokens in range.
    MoE: the reference's decode-vs-prefill test removes, not tolerates,
    a legitimate divergence of routing, capacity drops (here
    TF_CAPACITY_FACTOR, as there). bf16 brings another: top-k near-ties,
    where a token's expert set flips between prefill and decode on one
    rounding of its hidden state. So each decode step takes the experts
    prefill chose for its tokens (``pinned_route``; gates from the step's
    own router), and the line counts the routes that flipped and their
    widest probability gap. ``tf_f32``: a model whose random weights
    amplify a perturbation by ~100 (xlstm-1.3b: ``chaos_gain``) turns
    bf16's roundings, which differ between the two paths, into
    differences past DECODE_TOL; its check runs on the same weights in
    f32 (the bf16 reading is printed beside it as ``vs_prefill_bf16``).
    ``extra(params)`` adds readings to the line. Frees the model before
    it returns the line (already emitted)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.analytic_cost import analytic_cost
    from repro_torch.models import moe
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_params, tree_leaves,
                                                tree_map)
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(leaf.numel() for leaf in leaves)
    param_bytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    del leaves
    check(n_params == cfg.param_count(), f"{phase}: {n_params} params, "
          f"param_count() says {cfg.param_count()}")
    batch = make_lm_batch(cfg, 0, 0, lm_b, lm_s, device=dev)
    batch.pop("labels")
    kinds = cfg.pattern_for_layers()
    n_attn = cfg.n_groups * sum(kind in ("attn", "swa") for kind in kinds)
    vocab_shape = ([cfg.n_codebooks, cfg.vocab_size]
                   if cfg.frontend == "audio_codec" else [cfg.vocab_size])
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.hd, "pattern": list(kinds),
            "attention_layers": n_attn, "params": n_params,
            "param_bytes": param_bytes, "setup_s": setup_s,
            "allocated_before_bytes": held_before, "batch": lm_b,
            "seq": lm_s}
    with torch.inference_mode():
        dropped = []
        route = moe.route

        def counted_route(xf, router, m, cap):
            gates, keep, slot = route(xf, router, m, cap)
            dropped.append((~keep).sum())
            return gates, keep, slot

        # the warm-up forward, counting its routing's drops
        with_patched(moe, "route", counted_route,
                     lambda: forward(params, batch, cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = forward(params, batch, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flash = ops.LAUNCHES["flash_attention"]
        routes = dict(ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        del logits
        if flash_row in rows and flash:
            rows[flash_row]["launches"] += flash
            rows[flash_row].setdefault("launches_by_phase", {})[
                f"{phase}:{cfg.name}"] = flash
        stats = []
        if n_attn:
            with_patched(ops, "flash_attention",
                         layer_check(kernel_uncounted(), stats),
                         lambda: forward(params, batch, cfg))
        flops = analytic_cost(cfg, ShapeConfig(phase, lm_s, lm_b,
                                               "prefill"))["flops"]
        line.update(
            wall_s=wall, prefill_tokens_per_s=lm_b * lm_s / wall,
            peak_bytes=peak, logits_shape=shape,
            flash_attention_launches=flash,
            flash_attention_route_launches=routes,
            analytic_flops=flops,
            bf16_peak_share=flops / wall / BF16_TC_FLOP_PER_S,
            attention_per_layer_vs_plain={
                "layers": len(stats),
                "max_row_rel_err": max((st["row_rel_err"] for st in stats),
                                       default=None),
                "max_rel_rms": max((st["rel_rms"] for st in stats),
                                   default=None),
                "outside": [i for i, st in enumerate(stats)
                            if not attn_within(st)]})
        if cfg.moe is not None:
            pairs = len(dropped) * lm_b * lm_s * cfg.moe.top_k
            line["moe_dropped_share"] = float(sum(dropped)) / pairs
            line["moe_capacity_factor"] = cfg.moe.capacity_factor

        # teacher-forced decode, then greedy
        tf_cfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=TF_CAPACITY_FACTOR))
        prompt = batch["tokens"][:, :LM_TF_TOKENS]
        tf = teacher_forced(params, tf_cfg, prompt, dev)
        state, nxt = tf.pop("state"), tf.pop("next")
        if tf_f32:
            # the same weights in f32: decode against prefill without
            # bf16's roundings, which this model amplifies (chaos_gain)
            line["vs_prefill_bf16"] = tf.pop("vs_prefill")
            f32 = tree_map(lambda leaf: leaf.float(), params)
            cfg32 = dataclasses.replace(tf_cfg, dtype="float32")
            tf32 = teacher_forced(f32, cfg32, prompt, dev)
            tf["vs_prefill"] = tf32["vs_prefill"]
            line["chaos_gain"] = chaos_gain(f32, cfg32, prompt)
            del f32, tf32
        line.update(tf)
        dec_rms = tf["vs_prefill"]["rel_rms"]
        generated = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_GEN_STEPS):
            lg, state = decode_step(params, state, nxt, tf_cfg)
            nxt = lg[:, -1:].argmax(-1).to(torch.int32)
            generated.append(nxt)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        generated = torch.cat(generated, dim=1)
        gen_ok = (bool(torch.isfinite(lg).all())
                  and int(generated.min()) >= 0
                  and int(generated.max()) < cfg.vocab_size)
        line.update(
            generated=LM_GEN_STEPS,
            ms_per_step=gen_wall / LM_GEN_STEPS * 1e3,
            decode_tokens_per_s=lm_b * LM_GEN_STEPS / gen_wall,
            first_generated=generated[0].reshape(-1)[:8].tolist())
        if extra is not None:
            line.update(extra(params))
    del params, batch, prompt, state, lg, nxt, generated
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    check(finite, f"{phase} {cfg.name}: non-finite logits")
    check(shape == [lm_b, lm_s] + vocab_shape,
          f"{phase} {cfg.name}: logits {shape}")
    check(flash == n_attn, f"{phase} {cfg.name}: {flash} flash-attention "
          f"launches, expected {n_attn}")
    check(routes == {"tc_bf16": n_attn, "simt_f32": 0},
          f"{phase} {cfg.name}: flash-attention routes {routes}, expected "
          f"all {n_attn} on the tensor-core kernel")
    check(len(stats) == n_attn and not line[
        "attention_per_layer_vs_plain"]["outside"],
          f"{phase} {cfg.name}: the kernel against plain attention on the "
          f"model's own activations: {line['attention_per_layer_vs_plain']}")
    check(dec_rms <= DECODE_TOL, f"{phase} {cfg.name}: teacher-forced "
          f"logits {dec_rms} (relative RMS) from prefill > {DECODE_TOL}")
    check(gen_ok, f"{phase} {cfg.name}: non-finite logits or a token out "
          "of range")
    return line


def lm_family_phases(dev, rows: dict, record) -> None:
    """kernels_hd256, lm_hybrid, lm_moe, lm_xlstm, lm_frontends and
    serve_decode: the MoE, recurrent and frontend families at full width,
    one model on the card at a time."""
    import contextlib
    import io
    from repro_torch import serve_decode
    from repro_torch.configs import get_arch
    hd256_rows(dev, rows, record)
    lm_serve_phase("lm_hybrid", get_arch("recurrentgemma-2b"), dev, rows,
                   2, 4096, flash_row="flash_attention_hd256_recurrentgemma")
    lm_serve_phase("lm_moe", dataclasses.replace(
        get_arch("phi3.5-moe-42b-a6.6b"), n_layers=4), dev, rows, 4, 2048)
    lm_serve_phase("lm_moe", dataclasses.replace(
        get_arch("kimi-k2-1t-a32b"), n_layers=1), dev, rows, 1, 2048)
    # xlstm-1.3b at 24 of its 48 layers (PR 26), 8 since PR 27, for the
    # script's time: sLSTM loops over time on the host (15.6 s at 24, PR 26
    # call 8; 7.2 s at 12, PR 27 call 4)
    xlstm = dataclasses.replace(get_arch("xlstm-1.3b"), n_layers=8)
    lm_serve_phase("lm_xlstm", xlstm, dev, rows, 2, 1024, tf_f32=True,
                   extra=lambda params: {
                       "slstm_launches_a_token": slstm_launches_a_token(
                           params, xlstm, dev)})
    lm_serve_phase("lm_frontends", get_arch("paligemma-3b"), dev, rows, 4,
                   2048, flash_row="flash_attention_hd256_paligemma")
    lm_serve_phase("lm_frontends", get_arch("musicgen-medium"), dev, rows, 4,
                   2048, flash_row="flash_attention_hd64_musicgen")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gens = serve_decode.main(["--device", "cuda"])
    text = out.getvalue()
    emit({"phase": "serve_decode", "seconds": time.perf_counter() - t0,
          "output": text.splitlines(),
          "generated_shapes": {aid: list(g.shape) for aid, g in gens.items()}})
    check(text.rstrip().endswith("OK"), "serve_decode: does not end in OK")


# -- gossip across processes (spawned ranks run these by name) -------------
SPMD_NODES = 20               # sdot_dense's network, one process a node
SPMD_SAMPLES = 50_000         # sdot_dense's data, 2,500 samples a rank
# sdot_dense's T_o is 100; cut to 30, then to 12 (PR 26), then to 6 and
# 4 (PR 27): 20 gloo processes on the host's 8 cores take 6-13 ms a
# gossip round; the four runs took 175 s at T_o = 100, 58 s at 30 on a
# slow host, where the whole script read 1,276 s of its 1200 at 30, 16.6 s
# at 12 (PR 26 call 8) and 10.3 s at 6 (PR 27 call 3; NVIDIA H100 80GB
# HBM3, 700.00 W)
SPMD_T_OUTER = 4
SPMD_BUDGETS = (1, 5, 20, 50)
SPMD_GOSSIP_TOL = 1e-5        # f32 rounds summed in another order, per node
TWO_LEVEL_TOL = 1e-4          # tests/test_spmd.py's limit, relative
TRAIN_LOSS_TOL = 1e-4         # pod-mean losses against one rank's, relative
# train_psa's first PLAIN_STEPS steps against the same steps computed
# plainly in one process; the probes' limits are relative to the plain
# probe's max |x|. Step 0 starts from the same weights: its reduced
# gradient is bf16, so an element may round one bf16 step (up to 2^-7 of
# the max) the other way (read 4.0e-3), and its errors are the same f32
# ops (read 0). Step 1 starts from weights that AdamW's first, sign-like
# step moved by 2 lr wherever the two bf16 gradients rounded apart: its
# probes read 1.4e-2 at worst, its grad norm 2.3e-5 (NVIDIA H100 80GB
# HBM3, 700.00 W). With error feedback left out, step 1's errors were off
# by ~0.6 (a CPU run of these phases at reduced width)
PLAIN_STEPS = 2
PLAIN_GNORM_TOL = 3e-4
PLAIN_GRAD_TOL = 1e-2
PLAIN_EF_TOL = 1e-6
PLAIN_AFTER_TOL = 5e-2       # step 1's reduced gradients and errors
PROBES = ("embed", "final_norm", "groups/blk0_attn/mixer/bq",
          "groups/blk0_attn/mixer/wq", "groups/blk0_attn/ffn/w_down",
          "lm_head")
# the example twin's steps, cut from its 300 (~0.43 s a step) to 75 (the
# script read 991 s of its 1200 with 300 once the LM family phases were
# in), then to 25 with remat on by default (0.52 s a step) and PR 26's
# phases: the whole script read 1,192 and 1,276 s on two slow hosts and
# ~950 on another; then to 15 (33.4 s with 25), then to 12 for tp_heads'
# time (15 read 15.3 s of loop on an NVIDIA H100 80GB HBM3, 700 W); the
# run ends in its one checkpoint, past the example's 10 warm-up steps
TRAIN_EXAMPLE_STEPS = 12
# train_psa's steps run without remat: recomputing the forward added ~9 s
# to the phase (39 -> 48 s, PR 26 call 3) for 6 steps whose time is the
# embedding's all-reduce through host memory
TRAIN_PSA_REMAT = False
# train_psa's steps: cut from 6 to 4 (PR 27), which still refreshes at
# steps 0 and 3; its spawn and run read 56.3 s with 6 (PR 26 call 8)
TRAIN_PSA_STEPS = 4
ORTHO_TOL = 1e-4              # refreshed projectors: |P^T P - I|_max


def spmd_cases():
    """(graphs, schedules) of spmd_gossip and sdot_spmd."""
    from repro_torch.core import topology
    from repro_torch.core.consensus import consensus_schedule
    graphs = {"erdos_renyi": topology.erdos_renyi(SPMD_NODES, 0.25, seed=1),
              "ring": topology.ring(SPMD_NODES)}
    scheds = {"sdot": consensus_schedule("const", SPMD_T_OUTER, t_max=50),
              "sadot": consensus_schedule("lin2", SPMD_T_OUTER, cap=50)}
    return graphs, scheds


def spmd_rank(rank, world, dev, work):
    """One node of spmd_gossip and sdot_spmd. It reads its own payload row
    and its own (d, d) covariance block, gossips at every budget on both
    graphs, then runs S-DOT and SA-DOT; row 4's launches are counted from
    0 over each run."""
    from repro_torch.core.consensus import SpmdConsensus
    from repro_torch.core.sdot import sdot_spmd
    from repro_torch.kernels import gram_qr
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    work = Path(work)
    common = torch.load(work / "common.pt")
    mesh = make_test_mesh(device=dev)
    graphs, scheds = spmd_cases()
    z = common["z"][rank].to(dev)
    out = {"gossip": {}, "sdot": {}, "backend": mesh.backend}
    for name, graph in graphs.items():
        eng = SpmdConsensus(mesh, "nodes", graph=graph)
        for t_c in SPMD_BUDGETS:
            staged = eng.host_staged_bytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = eng.build_debiased_sum(t_c)(z)
            torch.cuda.synchronize()
            out["gossip"][f"{name}/{t_c}"] = {
                "z": got.cpu(), "wall_s": time.perf_counter() - t0,
                "staged": eng.host_staged_bytes - staged}
    cov = torch.load(work / f"cov{rank}.pt").to(dev)
    for name, graph in graphs.items():
        for kind, sched in scheds.items():
            eng = SpmdConsensus(mesh, "nodes", graph=graph)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = sdot_spmd(covs=cov, engine=eng,
                            r=common["q_init"].shape[1], t_outer=len(sched),
                            schedule=sched, q_init=common["q_init"],
                            q_true=common["q_true"])
            torch.cuda.synchronize()
            led = res.ledger
            out["sdot"][f"{name}/{kind}"] = {
                "wall_s": time.perf_counter() - t0,
                "launches": dict(ops.LAUNCHES),
                "gram_qr_routes": dict(gram_qr.ROUTE_LAUNCHES),
                "q": res.q_nodes.cpu() if rank == 0 else None,
                "trace": res.error_trace,
                "ledger": [led.p2p, led.matrices, led.scalars,
                           led.payload_bytes],
                "staged": eng.host_staged_bytes}
    out["two_level"] = two_level_part(rank, dev, work)
    return out


def two_level_part(rank, dev, work):
    """spmd_rank's ``two_level_reduce``: global ranks 0-7 laid out as 4
    pods x 2, an exact sum in the pod, 60 rounds on ring(4); every rank
    takes part in making the mesh's groups, the others get ``None``."""
    from repro_torch.core import topology
    from repro_torch.core.consensus import SpmdConsensus, two_level_reduce
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((("pod", 4), ("data", 2)), device=dev, ranks=range(8))
    if mesh is None:
        return None
    inter = SpmdConsensus(mesh, "pod", graph=topology.ring(4))
    z = torch.load(Path(work) / "common.pt")["z"][rank].to(dev)
    got = two_level_reduce(z, intra_axis="data", inter=inter, t_c=60)
    return {"z": got.cpu(), "staged": mesh.host_staged_bytes}


def train_psa_setup(layers: int, arch: str = "qwen2-7b"):
    """``arch`` (qwen2-7b) at full width cut to ``layers`` layers, AdamW
    with bf16 moments, paper_psa refreshed every 3 steps."""
    from repro_torch.configs import get_arch, get_psa_config
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, moment_dtype="bfloat16")
    return cfg, opt, dataclasses.replace(get_psa_config(), refresh_every=3)


def train_psa_probes(tree, tokens) -> dict:
    """f32 host copies of PROBES' slices of a tree of gradients (or errors):
    the first 512 columns of a matrix, a vector whole, and the embedding's
    rows of the first 256 distinct tokens of the global batch."""
    flat = {k.lstrip("/"): v for k, v in _flat(tree)}
    out = {}
    for name in PROBES:
        if name not in flat:
            continue
        leaf = flat[name]
        if name == "embed":
            leaf = leaf[torch.unique(tokens)[:256].to(leaf.device)]
        elif leaf.dim() >= 2:
            leaf = leaf[..., :512]
        out[name] = leaf.to("cpu", torch.float32, copy=True)
    return out


def train_psa_rank(rank, world, dev, layers, steps, batch, seq,
                   arch="qwen2-7b", remat=True):
    """One pod of train_psa: its shard of each global batch, a refresh
    every 3 steps (row 4's launches counted by shape), the step's walls,
    the bytes it stages and all-reduces, and its peak memory. For the
    first PLAIN_STEPS steps it keeps the probes of the reduced gradients
    and of the new errors (``compress_grads``' results), and pod 0 returns
    the projectors of the first refresh."""
    from collections import Counter

    import repro_torch.train.step as step_mod
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import gram_qr, ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.psa_compress import compression_ratio, psa_init
    from repro_torch.train.step import make_psa_train_step, shard_batch

    cfg, opt, psa = train_psa_setup(layers, arch)
    pod = make_test_mesh(multi_pod=True, device=dev).axis("pod")
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    psa_state = psa_init(params, psa)
    opt_state = adamw_init(params, opt)
    step, refresh = make_psa_train_step(cfg, opt, psa, group=pod,
                                        remat=remat)
    # the bytes a step all-reduces: U = P^T G for a compressed leaf, the
    # f32 gradient for any other, and the loss; dense: every gradient
    flat = dict(_flat(params))
    projs = dict(_flat(psa_state["proj"]))
    reduced = 4 + sum(4 * (v.numel() // v.shape[-2] * psa.rank
                           if k in projs else v.numel())
                      for k, v in flat.items())
    dense = 4 + sum(4 * v.numel() for v in flat.values())
    tally = Counter()
    kernel = ops.gram_qr

    def counted(v):
        tally[tuple(v.shape)] += 1
        return kernel(v)

    ops.gram_qr = counted
    probes = {"red": [], "ef": [], "tokens": None}
    inner = step_mod.compress_grads

    def probed(*a, **kw):
        red, ef = inner(*a, **kw)
        if len(probes["red"]) < PLAIN_STEPS:
            probes["red"].append(train_psa_probes(red, probes["tokens"]))
            probes["ef"].append(train_psa_probes(ef, probes["tokens"]))
        return red, ef

    step_mod.compress_grads = probed
    out = {"losses": [], "grad_norms": [], "step_ms": [], "refreshes": [],
           "staged_per_step": [], "reduced_bytes": reduced,
           "dense_bytes": dense, "ratio": compression_ratio(params, psa),
           "backend": pod.backend, "compressed_leaves": len(projs),
           "probes": probes}
    for t in range(steps):
        whole = make_lm_batch(cfg, 0, t, batch, seq, device=dev)
        probes["tokens"] = whole["tokens"]
        local = shard_batch(whole, pod.index, pod.size)
        if t % psa.refresh_every == 0:
            ops.reset_launches()
            tally.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            psa_state = refresh(params, psa_state, local)
            torch.cuda.synchronize()
            ortho = max(float((p.mT @ p - torch.eye(p.shape[-1], device=dev))
                              .abs().max())
                        for _, p in _flat(psa_state["proj"]))
            out["refreshes"].append({
                "step": t, "ms": (time.perf_counter() - t0) * 1e3,
                "gram_qr": ops.LAUNCHES["gram_qr"],
                "routes": dict(gram_qr.ROUTE_LAUNCHES),
                "by_shape": {str(list(k)): n for k, n in tally.items()},
                "ortho_err": ortho})
            if t == 0 and pod.index == 0:
                out["proj0"] = {k.lstrip("/"): v.cpu()
                                for k, v in _flat(psa_state["proj"])}
        staged = pod.host_staged_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, psa_state, met = step(params, opt_state,
                                                 psa_state, local)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["staged_per_step"].append(pod.host_staged_bytes - staged)
    ops.gram_qr = kernel
    step_mod.compress_grads = inner
    probes["tokens"] = None
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    # where a step's time goes: a seventh step, unchecked, its parts timed
    # apart (each ends in a synchronise), and the embedding gradient's f32
    # all-reduce alone
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.psa_compress import compress_grads
    from repro_torch.train.step import _value_and_grad

    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return res

    loss, grads = timed("forward_backward",
                        lambda: _value_and_grad(params, local, cfg,
                                                remat=remat))
    timed("embedding_allreduce_alone",
          lambda: pod.all_reduce_(grads["embed"].float()))
    red, _ = timed("compress_and_allreduce", lambda: compress_grads(
        grads, psa_state, psa, pod_axis=pod, donate=True))
    timed("loss_allreduce", lambda: pod.all_reduce_(loss.reshape(1)))
    timed("adamw", lambda: adamw_update(red, opt_state, params, opt,
                                        donate=True))
    out["step_parts_ms"] = parts
    return out


def train_psa_plain(dev, layers, batch, seq, proj) -> dict:
    """train_psa's first PLAIN_STEPS steps for both pods in one process,
    with the projectors of pod 0's first refresh: each pod's gradients by
    one backward pass on its shard, a compressed leaf reduced as
    P (P^T mean_p (G_p + e_p)) and an uncompressed one as mean_p G_p (f32),
    each pod's error e_p <- G_p + e_p - P P^T (G_p + e_p), AdamW; then the
    pod-mean loss of the step after. The pods' losses, grad norms and
    probes are held against these."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm
    from repro_torch.train.step import _value_and_grad, loss_fn, shard_batch

    cfg, opt, _ = train_psa_setup(layers)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt_state = adamw_init(params, opt)
    names, _, structure = _tree.flatten_with_names(params)
    proj = {k: v.to(dev) for k, v in proj.items()}
    errs = [dict.fromkeys(proj) for _ in range(2)]
    out = {"losses": [], "grad_norms": [], "red": [], "ef": []}

    def projected(p, x):             # P P^T x, one P a group of a stack
        if p.dim() == 3 and x.dim() > 3:
            p = p.reshape(p.shape[:1] + (1,) * (x.dim() - 3) + p.shape[1:])
        return p @ (p.mT @ x)

    for t in range(PLAIN_STEPS + 1):
        whole = make_lm_batch(cfg, 0, t, batch, seq, device=dev)
        shards = [shard_batch(whole, i, 2) for i in range(2)]
        if t == PLAIN_STEPS:
            with torch.no_grad():
                out["losses"].append(sum(float(loss_fn(params, b, cfg))
                                         for b in shards) / 2)
            break
        pods = [_value_and_grad(params, b, cfg) for b in shards]
        out["losses"].append(sum(float(lo) for lo, _ in pods) / 2)
        grads = [_tree.flatten_with_names(g)[1] for _, g in pods]
        del pods
        red = []
        for k, name in enumerate(names):
            g = [gr[k].float() for gr in grads]
            if name not in proj:
                red.append(((g[0] + g[1]) / 2).to(grads[0][k].dtype))
                continue
            g = [gi if e[name] is None else gi + e[name]
                 for gi, e in zip(g, errs)]
            red.append(projected(proj[name], (g[0] + g[1]) / 2)
                       .to(grads[0][k].dtype))
            for gi, e in zip(g, errs):
                e[name] = gi - projected(proj[name], gi)
            del g
        del grads
        red = _tree.unflatten(structure, red)
        out["red"].append(train_psa_probes(red, whole["tokens"]))
        out["ef"].append([train_psa_probes(
            _tree.unflatten(structure, [e.get(n) for n in names]),
            whole["tokens"]) for e in errs])
        out["grad_norms"].append(float(global_norm(red)))
        params, opt_state, _ = adamw_update(red, opt_state, params, opt,
                                            donate=True)
        del red
    return out


def train_psa_vs_plain(pods, plain) -> dict:
    """train_psa's pods against ``train_psa_plain``: the readings."""
    vs_plain = {
        "losses_rel_err": [abs(a - b) / abs(b) for a, b in
                           zip(pods[0]["losses"], plain["losses"])],
        "grad_norms_rel_err": [abs(a - b) / b for a, b in
                               zip(pods[0]["grad_norms"],
                                   plain["grad_norms"])],
        "reduced_grad_max_rel_err": [
            {k: _max_rel(v, want[k]) for k, v in got.items()}
            for got, want in zip(pods[0]["probes"]["red"], plain["red"])],
        "error_feedback_max_rel_err": [
            [{k: _max_rel(v, want[i][k]) for k, v in
              o["probes"]["ef"][t].items()} for i, o in enumerate(pods)]
            for t, want in enumerate(plain["ef"])],
        "tolerance": {"loss": TRAIN_LOSS_TOL, "grad_norm": PLAIN_GNORM_TOL,
                      "reduced_grad": PLAIN_GRAD_TOL,
                      "error_feedback": PLAIN_EF_TOL,
                      "step_1_probes": PLAIN_AFTER_TOL}}
    return vs_plain


def gram_qr_route(shape, is_bf16: bool = False) -> str:
    """The route row 4's plan takes for a V of ``shape`` ((..., d, r)) on
    card 0."""
    from repro_torch.kernels import _launch, gram_qr
    *lead, d, r = shape
    return gram_qr.plan(int(np.prod(lead)) if lead else 1, d, r, is_bf16,
                        _launch.card(0)[0]).route


def check_refresh_routes(phase: str, pods) -> None:
    """Each refresh's Gram launches by route (``gram_qr.ROUTE_LAUNCHES``
    counted by the rank) against the plan's route of each shape it counted;
    the one-matrix shapes (the heads, the expert stacks) on the cluster
    route."""
    for o in pods:
        for rf in o["refreshes"]:
            want = {"tc_bf16": 0, "simt": 0, "cluster": 0}
            for key, n in rf["by_shape"].items():
                shape = json.loads(key)
                how = gram_qr_route(shape)
                want[how] += n
                check(how == "cluster" or (len(shape) == 3 and shape[0] > 1),
                      f"{phase}: the Gram plan takes {how} at {shape}")
            check(rf["routes"] == want, f"{phase}: Gram launches by route "
                  f"{rf['routes']} at step {rf['step']}, expected {want}")


def check_vs_plain(pods, plain, vs_plain) -> None:
    """Each of ``train_psa_vs_plain``'s readings within its limit."""
    check(len(plain["losses"]) == PLAIN_STEPS + 1
          and max(vs_plain["losses_rel_err"]) <= TRAIN_LOSS_TOL,
          f"train_psa: losses {pods[0]['losses']} against the plain steps' "
          f"{plain['losses']}")
    check(max(vs_plain["grad_norms_rel_err"]) <= PLAIN_GNORM_TOL,
          f"train_psa: grad norms {pods[0]['grad_norms']} against the plain "
          f"steps' {plain['grad_norms']}")
    for t, errs in enumerate(vs_plain["reduced_grad_max_rel_err"]):
        check(len(errs) == len(PROBES) and max(errs.values())
              <= (PLAIN_AFTER_TOL if t else PLAIN_GRAD_TOL), f"train_psa: "
              f"step {t}'s reduced gradients off the plain step's: {errs}")
    for t, by_pod in enumerate(vs_plain["error_feedback_max_rel_err"]):
        for errs in by_pod:
            check(len(errs) == len(plain["ef"][t][0]) >= 3
                  and max(errs.values())
                  <= (PLAIN_AFTER_TOL if t else PLAIN_EF_TOL),
                  f"train_psa: step {t}'s errors off the plain step's: "
                  f"{errs}")


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _flat(tree, prefix=""):
    """(path, tensor) of every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


def spmd_train_phases(dev, rows: dict, record, gram_qr_work, q_init,
                      q_true) -> None:
    """spmd_gossip, sdot_spmd, train_psa and train_example: gossip across
    processes and the PSA-compressed trainer (module docstring). ``record``
    and ``gram_qr_work`` are the kernels phase's row helpers; ``q_init`` and
    ``q_true`` are sdot_dense's."""
    from repro_torch import train_lm_psa_compress
    from repro_torch.core.consensus import DenseConsensus
    from repro_torch.core.sdot import sdot
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           make_lm_batch, partition_samples)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.transformer import init_params as lm_init
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.psa_compress import CQR_PASSES
    from repro_torch.train.step import make_train_step

    d, r = q_init.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    # -- gossip across processes: 20 ranks, 8 of them also as 4 x 2 --------
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_spmd"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    x, _, _ = gaussian_eigengap_data(d, SPMD_SAMPLES, r, 0.7, seed=0,
                                     device=dev)
    covs = torch.stack([b @ b.T / b.shape[1]
                        for b in partition_samples(x, SPMD_NODES)])
    del x
    z_spmd = torch.randn((SPMD_NODES, d, r), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    torch.save({"z": z_spmd.cpu(), "q_init": q_init.cpu(),
                "q_true": q_true.cpu()}, work / "common.pt")
    for i in range(SPMD_NODES):
        torch.save(covs[i].cpu().clone(), work / f"cov{i}.pt")
    t0 = time.perf_counter()
    spmd = spawn_ranks(spmd_rank, SPMD_NODES, backend="gloo", device="cuda",
                       args=(str(work),))
    spmd_wall = time.perf_counter() - t0
    graphs, scheds = spmd_cases()
    gossip_out = {}
    for name, graph in graphs.items():
        dense = DenseConsensus(graph, device=dev)
        for t_c in SPMD_BUDGETS:
            want = dense.run_debiased(z_spmd, t_c).cpu()
            got = torch.stack([o["gossip"][f"{name}/{t_c}"]["z"]
                               for o in spmd])
            per_node = ((got - want).abs().amax((1, 2))
                        / want.abs().amax((1, 2)))
            gossip_out[f"{name}/{t_c}"] = {
                "max_rel_err_per_node": float(per_node.max()),
                "wall_s": max(o["gossip"][f"{name}/{t_c}"]["wall_s"]
                              for o in spmd),
                "host_staged_bytes_a_rank": spmd[0]["gossip"][
                    f"{name}/{t_c}"]["staged"]}
    z8 = z_spmd[:8].double().sum(0).cpu()
    two = [o["two_level"] for o in spmd[:8]]   # the same spawn's ranks 0-7
    two_err = max(float((o["z"].double() - z8).abs().max()) for o in two) \
        / float(z8.abs().max())
    emit({"phase": "spmd_gossip", "ranks": SPMD_NODES, "backend":
          spmd[0]["backend"], "payload": [d, r], "budgets": SPMD_BUDGETS,
          "spawn_and_run_s": spmd_wall, "vs_dense_consensus": gossip_out,
          "tolerance": SPMD_GOSSIP_TOL,
          "two_level_reduce": {"mesh": [4, 2], "graph": "ring(4)",
                               "t_c": 60, "max_rel_err_vs_exact": two_err,
                               "tolerance": TWO_LEVEL_TOL,
                               "host_staged_bytes_a_rank": two[0]["staged"]}})
    for key, g in gossip_out.items():
        check(g["max_rel_err_per_node"] <= SPMD_GOSSIP_TOL, f"spmd_gossip "
              f"{key}: {g['max_rel_err_per_node']} from DenseConsensus")
    check(two_err <= TWO_LEVEL_TOL, f"two_level_reduce: {two_err} from the "
          "exact sum")

    sdot_out = {}
    rows_spmd = 0
    for name, graph in graphs.items():
        for kind, sched in scheds.items():
            key = f"{name}/{kind}"
            want = sdot(covs=covs, engine=DenseConsensus(graph, device=dev),
                        r=r, t_outer=len(sched), schedule=sched,
                        q_init=q_init, q_true=q_true, device=dev)
            led = want.ledger
            runs = [o["sdot"][key] for o in spmd]
            trace_err = max(float(np.abs(o["trace"] - want.error_trace).max())
                            for o in runs)
            q_err = float((runs[0]["q"] - want.q_nodes.cpu()).abs().max())
            qr = [o["launches"]["gram_qr"] for o in runs]
            rows_spmd += sum(qr)
            sdot_out[key] = {
                "t_outer": len(sched), "rounds": int(sched.sum()),
                "wall_s": max(o["wall_s"] for o in runs),
                "gram_qr_launches_a_rank": sorted(set(qr)),
                "host_staged_bytes_a_rank": runs[0]["staged"],
                "final_err": float(runs[0]["trace"][-1]),
                "dense_final_err": float(want.error_trace[-1]),
                "max_trace_err": trace_err, "q_nodes_max_abs_err": q_err,
                "ledger": runs[0]["ledger"],
                "ledger_dense": [led.p2p, led.matrices, led.scalars,
                                 led.payload_bytes]}
            for o in runs:
                check(np.allclose(o["trace"], want.error_trace, rtol=1e-4,
                                  atol=1e-6), f"sdot_spmd {key}: trace off "
                      f"the fused dense run by {trace_err}")
                check(o["ledger"] == sdot_out[key]["ledger_dense"],
                      f"sdot_spmd {key}: ledger {o['ledger']}")
            check(q_err <= 1e-5, f"sdot_spmd {key}: q_nodes {q_err} from "
                  "the fused dense run")
            check(qr == [2 * len(sched)] * SPMD_NODES, f"sdot_spmd {key}: "
                  f"Gram launches a rank {qr}, expected {2 * len(sched)}")
            check(all(o["gram_qr_routes"]["cluster"] == 0 for o in runs),
                  f"sdot_spmd {key}: Gram launches on the cluster route")
    emit({"phase": "sdot_spmd", "ranks": SPMD_NODES, "backend": "gloo",
          "d": d, "r": r, "samples_a_rank": SPMD_SAMPLES // SPMD_NODES,
          "runs": sdot_out})
    del covs, z_spmd, spmd, two
    shutil.rmtree(work, ignore_errors=True)

    # -- train_psa: qwen2-7b at full width, 2 pod ranks on the card --------
    v_spmd = torch.randn((1, d, r), generator=gen, device=dev)
    spmd_bytes, spmd_flops, _ = gram_qr_work(v_spmd)
    record("gram_qr_sdot_spmd", "src/repro_torch/kernels/csrc/gram_qr.cu",
           "src/repro/kernels/gram_qr.py:40",
           lambda: ops.gram_qr(v_spmd), lambda: ref.gram_qr_ref(v_spmd),
           lambda: torch.bmm(v_spmd.mT, v_spmd), spmd_bytes, spmd_flops,
           GRAM_QR_TOL, "f32 sums in another order than cuBLAS; relative "
           "to max |G|")
    rows["gram_qr_sdot_spmd"]["launches"] = rows_spmd
    del v_spmd
    tp_layers, tp_steps, tp_batch, tp_seq = 2, TRAIN_PSA_STEPS, 4, 512
    t0 = time.perf_counter()
    pods = spawn_ranks(train_psa_rank, 2, backend="gloo", device="cuda",
                       args=(tp_layers, tp_steps, tp_batch, tp_seq,
                             "qwen2-7b", TRAIN_PSA_REMAT))
    tp_wall = time.perf_counter() - t0
    cfg_tp, opt_tp, psa_tp = train_psa_setup(tp_layers)
    one = lm_init(torch.Generator(device=dev).manual_seed(0), cfg_tp,
                  device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, one_met = make_train_step(cfg_tp, opt_tp)(
        one, adamw_init(one, opt_tp),
        make_lm_batch(cfg_tp, 0, 0, tp_batch, tp_seq, device=dev))
    one_loss = float(one_met["loss"])
    one_ms = (time.perf_counter() - t0) * 1e3
    del one, one_met
    gc.collect()
    torch.cuda.empty_cache()
    plain = train_psa_plain(dev, tp_layers, tp_batch, tp_seq,
                            pods[0].pop("proj0"))
    gc.collect()
    torch.cuda.empty_cache()
    vs_plain = train_psa_vs_plain(pods, plain)
    by_shape = {}
    for o in pods:
        for rf in o["refreshes"]:
            for k, n in rf["by_shape"].items():
                by_shape[k] = by_shape.get(k, 0) + n
    steady = [ms for o in pods for ms in o["step_ms"][1:]]
    step_ms = statistics.median(steady)
    tp_out = {
        "arch": cfg_tp.name, "layers": tp_layers, "d_model": cfg_tp.d_model,
        "heads": [cfg_tp.n_heads, cfg_tp.n_kv_heads], "d_ff": cfg_tp.d_ff,
        "vocab": cfg_tp.vocab_size, "dtype": cfg_tp.dtype,
        "moment_dtype": opt_tp.moment_dtype, "pods": 2,
        "remat": TRAIN_PSA_REMAT,
        "backend": pods[0]["backend"], "psa": dataclasses.asdict(psa_tp),
        "tokens_a_pod_a_step": tp_batch // 2 * tp_seq,
        "losses": pods[0]["losses"], "grad_norms": pods[0]["grad_norms"],
        "one_rank_first_loss": one_loss, "one_rank_step_ms": one_ms,
        "plain_steps": PLAIN_STEPS, "plain_losses": plain["losses"],
        "plain_grad_norms": plain["grad_norms"], "vs_plain": vs_plain,
        "step_ms_by_rank": [o["step_ms"] for o in pods],
        "step_ms_median_after_first": step_ms,
        "tokens_per_s": tp_batch * tp_seq / (step_ms / 1e3),
        "refreshes": pods[0]["refreshes"],
        "refresh_ms_by_rank": [[rf["ms"] for rf in o["refreshes"]]
                               for o in pods],
        "gram_qr_launches_by_shape": by_shape,
        "allreduced_bytes_a_step": pods[0]["reduced_bytes"],
        "dense_gradient_bytes_a_step": pods[0]["dense_bytes"],
        "compression_ratio_analytic": pods[0]["ratio"],
        "host_staged_bytes_a_step": pods[0]["staged_per_step"],
        "max_memory_allocated_by_rank": [o["max_memory_allocated"]
                                         for o in pods],
        "step_parts_ms_by_rank": [o["step_parts_ms"] for o in pods],
        "spawn_and_run_s": tp_wall}
    emit({"phase": "train_psa", **tp_out})
    for o in pods:
        check(all(np.isfinite(o["losses"])), f"train_psa: losses "
              f"{o['losses']}")
        check(o["losses"] == pods[0]["losses"], "train_psa: the pods' "
              "pod-mean losses differ")
        for rf in o["refreshes"]:
            check(rf["ortho_err"] <= ORTHO_TOL, f"train_psa: projector "
                  f"|P^T P - I| {rf['ortho_err']} at step {rf['step']}")
            check(rf["gram_qr"] == CQR_PASSES * psa_tp.oi_iters
                  * o["compressed_leaves"], f"train_psa: {rf['gram_qr']} "
                  "Gram launches a refresh")
        check(all(b == 2 * o["reduced_bytes"]
                  for b in o["staged_per_step"]), "train_psa: staged bytes "
              f"{o['staged_per_step']} != 2 x {o['reduced_bytes']}")
    check(abs(pods[0]["losses"][0] - one_loss) <= TRAIN_LOSS_TOL
          * abs(one_loss), f"train_psa: first pod-mean loss "
          f"{pods[0]['losses'][0]} against one rank's {one_loss}")
    check_vs_plain(pods, plain, vs_plain)
    # row 4 at the refresh's shapes (f32): the shapes counted by the ranks
    for label, shape in (("a3584", (2, cfg_tp.d_model, psa_tp.rank)),
                         ("a18944", (2, cfg_tp.d_ff, psa_tp.rank)),
                         ("head", (cfg_tp.d_model, psa_tp.rank))):
        vq = torch.randn(shape, generator=gen, device=dev)
        q_bytes, q_flops, _ = gram_qr_work(vq.reshape(-1, *shape[-2:]))
        name = f"gram_qr_psa_refresh_{label}"
        record(name, "src/repro_torch/kernels/csrc/gram_qr.cu",
               "src/repro/kernels/gram_qr.py:40",
               lambda: ops.gram_qr(vq), lambda: ref.gram_qr_ref(vq),
               lambda: torch.matmul(vq.mT, vq), q_bytes, q_flops,
               GRAM_QR_TOL, "f32 sums in another order than cuBLAS; "
               "relative to max |G|")
        rows[name]["launches"] = by_shape.get(str(list(shape)), 0)
        rows[name]["shape"] = list(shape)
        rows[name]["kernel_route"] = gram_qr_route(shape)
        del vq
    check(sum(rows[f"gram_qr_psa_refresh_{k}"]["launches"]
              for k in ("a3584", "a18944", "head"))
          == sum(rf["gram_qr"] for o in pods for rf in o["refreshes"]),
          f"train_psa: Gram launches by shape {by_shape}")
    check_refresh_routes("train_psa", pods)

    # -- train_example: the example twin, --full-100m ------------------------
    ex_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(ex_dir, ignore_errors=True)
    t0 = time.perf_counter()
    steps = str(TRAIN_EXAMPLE_STEPS)
    ex = train_lm_psa_compress.main(["--full-100m", "--steps", steps,
                                     "--ckpt-dir", str(ex_dir),
                                     "--ckpt-every", steps,
                                     "--device", "cuda"])
    ex_total = time.perf_counter() - t0
    shutil.rmtree(ex_dir, ignore_errors=True)
    emit({"phase": "train_example", "steps": ex["steps_run"],
          "first_loss": ex["first_loss"], "last_loss": ex["last_loss"],
          "loop_s": ex["wall_s"],
          "ms_per_step": ex["wall_s"] / TRAIN_EXAMPLE_STEPS * 1e3,
          "tokens_per_s": TRAIN_EXAMPLE_STEPS * 8 * 512 / ex["wall_s"],
          "spawn_and_run_s": ex_total})
    check(ex["steps_run"] == TRAIN_EXAMPLE_STEPS
          and ex["last_loss"] < ex["first_loss"],
          f"train_example: {ex}")



# ---------------------------------------------------------------------------
# training every family, shard-local MoE, the sharded step, the roofline
# ---------------------------------------------------------------------------
# (arch, layers or None for the whole depth, batch, seq, remat): each
# trains alone on the card, freed before the next. phi3.5-moe is cut from
# 32 layers to 2 (~34 GB at 12 bytes a parameter: bf16 weights and
# gradients, f32 moments). xlstm-1.3b at 2 x 256 and 24 of its 48 layers
# since PR 26, 8 since PR 27 (31.7 s at 24, PR 26 call 8), without remat:
# its step is sLSTM's Python loop over time on the host (11.9 s whole),
# which remat=True would run again in the backward. The others take the
# reference's default, remat=True
TRAIN_FAMILIES = (("recurrentgemma-2b", None, 2, 1024, True),
                  ("phi3.5-moe-42b-a6.6b", 2, 2, 1024, True),
                  ("xlstm-1.3b", 4, 2, 256, False),
                  ("paligemma-3b", None, 2, 1024, True),
                  ("musicgen-medium", None, 2, 1024, True))
FAMILY_STEPS = 3              # AdamW steps on one fixed batch
FAMILY_LR = 1e-4
# The directional check, in f32 at the initial weights th (the training's
# seed): (L(th + eps v) - L(th - eps v)) / 2 eps against the gradient g's
# change over the two points, <g, th+ - th->, th+ and th- as f32 holds
# them (an element whose eps v is under half its ulp does not move; <g, v>
# is printed beside). v: a seeded normal draw a leaf, its magnitudes
# scaled by the leaf's RMS (at least 1e-2) and its signs those of g (the
# draw's where g is 0). A direction with the draw's own signs projects
# onto g by ~1/sqrt(N) of its norm, and its first-order change drowns
# under the third-order term: on the CPU at reduced width recurrentgemma
# read 8.7% at eps 1.7e-3 and 2.5% (f32's rounding) at 1.7e-4; with g's
# signs both terms read ~1e-4 at a loss change of 1e-2. eps moves the loss
# by DIR_CHANGE (eps within DIR_EPS). The limit: DIR_TOL, relative, set
# before the first card run. Checked at the trained weights instead, on
# the H100 recurrentgemma-2b had learnt its batch (loss 0.0011), where a
# loss change of 1e-2 is far from linear (read 64x), and xlstm-1.3b's
# chaotic weights read 1.13% at eps 1e-6 (a change of 0.057, then the
# floor); hence the initial weights, a change of 4e-3 and no floor
DIR_TOL = 1e-2
DIR_CHANGE = 4e-3
DIR_EPS = (1e-9, 1e-2)
DIR_SEED = 1000
MOE_SHARDS = 4                # moe_shards: the prefill's data shards
# moe_shards: the shard-local MoE against the same tokens as four
# quarters routed alone: the routes equal bit for bit; the outputs run
# the experts' bf16 GEMMs at another M (n_dp cap rows an expert against
# cap), so they may round one bf16 step apart: relative RMS within half a
# bf16 ulp (2^-8)
MOE_SHARD_RMS_TOL = 2.0 ** -8
SHARDED_ARCH, SHARDED_LAYERS = "h2o-danube-1.8b", 4
SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS = 4, 1024, 2
SHARDED_MESH = (("data", 2), ("model", 2))
PSA_MOE_LAYERS, PSA_MOE_STEPS, PSA_MOE_BATCH, PSA_MOE_SEQ = 1, 4, 4, 512
# remat: REMAT_ARCH at train_family's 2 x 1024, REMAT_STEPS steps at each
# remat from the same weights. The first loss runs the same forward under
# each: equal bit for bit. The backward runs on recomputed values that are
# the same bits, but the embedding's and the MoE scatter's backward sum
# with atomics on the card: the norm within REMAT_GNORM_TOL, relative
# (one step at each remat: two read 7.0 s in all on the same card)
REMAT_ARCH, REMAT_BATCH, REMAT_SEQ, REMAT_STEPS = \
    "recurrentgemma-2b", 2, 1024, 1
REMAT_GNORM_TOL = 1e-5
# tp_step: sharded_step's model, mesh and batch with the compute split over
# "model", against sharded_step's first step (the same weights and batch).
# Both are bf16 (2^-8 relative a rounding): the split rounds each rank's
# partial mixer and FFN output to bf16 before the sum, the unsplit route
# the whole once, and sums the partial products in another order. On the
# CPU, h2o-danube at width 512, 4 layers, 4 x 256 tokens on (2, 2) read
# 1.5e-5 (loss) and 1.3e-4 (norm) apart (a probe of
# make_sharded_value_and_grad, both routes). Limits, set before the first
# card run: a quarter of a bf16 rounding on the loss (a mean over 4,096
# tokens) and two on the norm (its gradients go through as many roundings
# again in the backward)
TP_LOSS_TOL = 2.0 ** -10
TP_GNORM_TOL = 2.0 ** -7
# tp_serve: qwen2-7b at full width cut to 4 layers on a model axis of 2
# (14 query / 2 kv heads a rank): a 2 x 2048 prefill through row 9, then
# TP_DECODE_STEPS teacher-forced decode steps, against one process
TP_SERVE_ARCH, TP_SERVE_LAYERS = "qwen2-7b", 4
TP_SERVE_BATCH, TP_SERVE_SEQ, TP_DECODE_STEPS = 2, 2048, 16
TP_SERVE_MESH = (("data", 1), ("model", 2))
# then TP_INT8_STEPS decode steps with the int8 KV cache under the same
# split, within KV_QUANT_TOL of the bf16 split's, the state's bytes the plan
TP_INT8_STEPS = 4
# tp_recurrent: the split over "model" for the recurrent families at full
# width, cut in depth: xlstm-1.3b at 4 of 48 layers (2 mLSTM + sLSTM pairs)
# at 4 x 256: TP_REC_STEPS steps in sharded_step's ranks on (2, 2), held to
# one process at TP_LOSS_TOL / TP_GNORM_TOL. recurrentgemma-2b's split
# train step at one 13-layer group ran here at 4 x 1024 on (2, 2) until
# tp_heads took it over on (1, 4) at 2 x 1024 (its 10 heads over 4): its
# step read 8.2-23.6 s on H100 hosts
TP_REC_TRAIN = (("xlstm-1.3b", 4, 4, 256),)
TP_REC_STEPS = 1
# tp_recurrent_serve: the same cuts on tp_serve's model axis of 2 (name,
# arch, layers, batch, prefill length, decode steps, decode max_len, dtype):
# a prefill, then teacher-forced decode steps from a fresh state, against
# one process. recurrentgemma's windowed ring is max_len = 16 slots, 8 a
# rank: 20 steps fill both ranks' ranges and wrap it (32 slots and 40
# steps took 18.1 s of decode on an NVIDIA H100 80GB HBM3 at 700 W, where
# the bf16 step read 305 ms and the f32 one 147 ms). The f32 runs are
# held at LOGITS_TOL, the bf16 run at DECODE_TOL (module docstring,
# tp_recurrent_serve): the split sums its row-parallel parts in f32 and
# rounds once, as one process does (which took recurrentgemma's bf16 split
# from 0.030 to 0.0205 relative RMS, PR 27 calls 1-2); what is left are
# one-ulp flips of products cut another way (a column block of x @ w, a
# vocabulary block of the head), which random weights carry far: 2.1% at
# 13 layers here, as they carry decode against prefill to 3.0% (lm_hybrid).
# So recurrentgemma's check at LOGITS_TOL runs in f32 on the same weights
# (the bf16 run's, in f32), as xlstm's does (lm_xlstm: its weights carry a
# perturbation ~100-fold; xlstm is drawn in f32 here). recurrentgemma cut
# from one 13-layer group to its pattern's first 3 layers (RG-LRU, RG-LRU,
# windowed) for the script's time on slow hosts (one read 1,202 s
# of its 1,200 there): its 2 x 4096 prefill read 4.8 s at 13 layers
TP_REC_SERVE = (
    ("recurrentgemma-2b", "recurrentgemma-2b", 3, 2, 4096, 20, 16,
     "bfloat16"),
    ("recurrentgemma-2b:f32", "recurrentgemma-2b", 3, 2, 512, 20, 16,
     "float32"),
    ("xlstm-1.3b", "xlstm-1.3b", 4, 2, 1024, 16, 16, "float32"))
# tp_frontends: the split over "model" for the VLM and audio frontends at
# full width, cut in depth: paligemma-3b at 4 of 18 layers (its 256 patch
# positions drawn by make_lm_batch from seed 0, spliced over the gathered
# activations), musicgen-medium at 4 of 48 layers (4 codebooks, a head of 4
# x 2048 columns, 2 codebooks a rank): TP_REC_STEPS steps each in
# sharded_step's ranks on (2, 2) at 4 x 1024, held to one process at
# TP_LOSS_TOL / TP_GNORM_TOL. Cut from 6 and 8 layers for tp_heads' time
# (8.4 and 3.1 s a step on an NVIDIA H100 80GB HBM3, 700 W)
TP_FRONT_TRAIN = (("paligemma-3b", 4, 4, 1024),
                  ("musicgen-medium", 4, 4, 1024))
# tp_frontends_serve: the same cuts on tp_serve's model axis of 2, in
# TP_REC_SERVE's layout and its row 9 row last: a 2 x 2048 prefill (row 9
# on 4 of paligemma's 8 query heads against its one gathered kv head, on
# 12 of musicgen's 24 heads, hd 64), 16 teacher-forced decode steps on a
# 16-slot ring (paligemma's cut by length over "model", musicgen's heads
# over "model"), against one process at LOGITS_TOL in bf16; cut from 6 and
# 8 layers to tp_frontends' 4 for the script's time on slow hosts
TP_FRONT_SERVE = (
    ("paligemma-3b", "paligemma-3b", 4, 2, 2048, 16, 16, "bfloat16",
     "flash_attention_tp_vlm"),
    ("musicgen-medium", "musicgen-medium", 4, 2, 2048, 16, 16, "bfloat16",
     "flash_attention_tp_audio"))
# tp_long_decode: a batch of 1 on sharded_step's (2, 2) (name, arch,
# layers, window, decode max_len, steps, dtype, limit), decoded
# teacher-forced from a fresh state through make_sharded_serve_step, each
# data rank the whole batch: h2o-danube-1.8b at sharded_step's 4 layers
# (its 8 kv heads over "model": an 8-slot ring cut by length over "data",
# 4 slots a data rank, both ranks' filled in 6 steps), recurrentgemma-2b at
# 3 layers (its one kv head: a 4-slot window cut over ("data",
# "model"), a slot a rank, 5 steps wrap it), xlstm-1.3b in f32 at 4 layers,
# 2 steps (its states whole over "data"). Every step gathers a rank's
# blocks over "data" (the plan's ZeRO-3 decode) through host memory:
# recurrentgemma's step read 3.21-4.00 s and h2o's 0.53-0.68 s (NVIDIA H100
# 80GB HBM3, 700 W), so a 32-slot window and 40 steps (h2o a 64-slot ring)
# took 164 s and an 8-slot window and 10 steps 51 s, cut to these;
# recurrentgemma then cut from one 13-layer group to its pattern's first 3
# layers (RG-LRU, RG-LRU, windowed) for tp_tied's time: its 5 steps read
# 3.62 s each at 13 layers (NVIDIA H100 80GB HBM3, 700 W).
# recurrentgemma in bf16 is held at DECODE_TOL, as in
# tp_recurrent_serve (its random weights carry one-ulp flips of products
# cut another way past LOGITS_TOL: 0.0216 at 40 steps; the split is exact
# in f32 on the CPU and xlstm's here reads 8.9e-7)
TP_LONG = (
    ("h2o-danube-1.8b", "h2o-danube-1.8b", 4, None, 8, 6, "bfloat16",
     LOGITS_TOL),
    ("recurrentgemma-2b", "recurrentgemma-2b", 3, 4, 8, 5, "bfloat16",
     DECODE_TOL),
    ("xlstm-1.3b", "xlstm-1.3b", 4, None, 8, 2, "float32", LOGITS_TOL))
# tp_heads: query heads that do not divide over "model", on sharded_step's 4
# ranks laid out as TP_HEADS_MESH: TP_HEADS_ARCH at full width cut to its
# pattern's first TP_HEADS_LAYERS (RG-LRU, RG-LRU, windowed; one 13-layer
# group before, whose step read 5.4-7.8 s on an NVIDIA H100 80GB HBM3 at
# 700 W; cut for the script's time on slow hosts) (10 query heads over 4:
# 3, 3, 2, 2; wq's block 2.5 heads),
# a split train step at TP_HEADS_TRAIN (batch, seq), remat True, held to
# one process at TP_LOSS_TOL / TP_GNORM_TOL; a prefill at TP_HEADS_SERVE,
# then TP_HEADS_DECODE teacher-forced steps on a ring of TP_HEADS_RING
# slots (one a rank, wrapped), held at DECODE_TOL in bf16 as recurrentgemma's
# split is (TP_REC_SERVE's comment). Row 9's head-offset row runs at
# TP_HEADS_ROW: qwen2-7b's rank 1 of a model axis of 8 (shares 4, 4, 4, 4,
# 3, 3, 3, 3): query heads 4-7 reading kv heads 0 and 1 (a group of 7)
TP_HEADS_MESH = (("data", 1), ("model", 4))
TP_HEADS_ARCH, TP_HEADS_LAYERS = "recurrentgemma-2b", 3
TP_HEADS_TRAIN, TP_HEADS_SERVE = (2, 1024), (2, 2048)
TP_HEADS_DECODE, TP_HEADS_RING = 5, 4
TP_HEADS_ROW = {"arch": "qwen2-7b", "tp": 8, "rank": 1, "batch": 2,
                "seq": 2048}
# tp_tied: a tied head under the split over "model" on tp_heads' ranks and
# cells (module docstring): tp_heads' model with tie_embeddings (its 3
# layers the fewest that hold RG-LRU and a windowed layer)
# lm_decode's int8 KV cache: KV_QUANT_STEPS teacher-forced steps against the
# bf16 cache's. KV_QUANT_TOL is twice the reference's own gap (relative RMS
# of the logits, int8 against bf16 cache) at qwen2-7b's 28 layers cut to
# d_model 512 (4 heads of 128 over 2 kv heads), 4 x 5 steps, bf16: 0.02756
# (the port there: 0.02578; at d_model 1024, 0.02792 and 0.02784), read on
# the CPU by tools/kv_quant_gap.py. Random weights carry a rounding that
# far at this depth: the two packages' bf16 caches read 0.0213 apart there
KV_QUANT_STEPS = 5
KV_QUANT_TOL = 2 * 0.02756


def directional_check(cfg, batch, dev, remat=True) -> dict:
    """The f32 directional check of ``loss_fn``'s gradient g at the
    initial weights of ``cfg`` (an f32 config; torch.Generator seed 0):
    the central difference against <g, th+ - th-> / 2 eps (module
    constants DIR_*). MoE routes at both points are the ones th chose
    (``pinned_route``), so the loss is smooth along v; the flips a free
    routing would make there are counted."""
    from repro_torch._tree import flatten_with_names, unflatten
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import _value_and_grad, loss_fn
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    _, leaves, structure = flatten_with_names(params)    # the grads' order
    scales = [max(float(leaf.square().mean().sqrt()), 1e-2)
              for leaf in leaves]
    recorded = []
    loss0, grads = with_patched(moe, "route", recording_route(recorded),
                                lambda: _value_and_grad(params, batch, cfg,
                                                        remat=remat))
    grads = flatten_with_names(grads)[1]
    signs = [torch.where(g == 0, 0, torch.sign(g)).to(torch.int8)
             for g in grads]

    def draws():
        """v leaf by leaf, drawn anew each time (no copy of v is held)."""
        for i, (scale, sign) in enumerate(zip(scales, signs)):
            gen = torch.Generator(device=dev).manual_seed(DIR_SEED + i)
            z = torch.randn(sign.shape, generator=gen, device=dev)
            yield torch.where(sign == 0, z, z.abs() * sign).mul_(scale)

    dot = sum(float(torch.sum(g * v, dtype=torch.float64))
              for g, v in zip(grads, draws()))
    eps = min(max(DIR_CHANGE / max(abs(dot), 1e-30), DIR_EPS[0]), DIR_EPS[1])
    tokens = batch["labels"].shape[0] * batch["labels"].shape[1]
    moved = [torch.empty_like(leaf) for leaf in leaves]

    def at(alpha, flips):
        """(loss, <g, th + alpha v - th>) with th + alpha v in ``moved``."""
        change = 0.0
        for buf, leaf, g, v in zip(moved, leaves, grads, draws()):
            torch.add(leaf, v, alpha=alpha, out=buf)
            change += float(torch.sum(g * (buf - leaf), dtype=torch.float64))
        route = (pinned_route(recorded, torch.arange(tokens, device=dev),
                              flips) if recorded else moe.route)
        with torch.inference_mode():
            loss = float(with_patched(moe, "route", route, lambda: loss_fn(
                unflatten(structure, moved), batch, cfg)))
        return loss, change

    flips_p, flips_m = [], []
    loss_p, change_p = at(eps, flips_p)
    loss_m, change_m = at(-eps, flips_m)
    del params, leaves, grads, signs, moved
    fd = (loss_p - loss_m) / (2 * eps)
    want = (change_p - change_m) / (2 * eps)
    return {"loss": float(loss0), "eps": eps, "dot": dot,
            "grad_change": want, "central": fd,
            "rel_err": abs(fd - want) / max(abs(want), 1e-30),
            "loss_plus": loss_p, "loss_minus": loss_m,
            "tolerance": DIR_TOL,
            "moe_routes_pinned": len(recorded),
            "moe_free_flips": [int(sum(int(n) for n, _ in fl))
                               for fl in (flips_p, flips_m)]}


def train_family(cfg, lm_b: int, lm_s: int, dev, card: str,
                 remat=True) -> dict:
    """FAMILY_STEPS AdamW steps of ``cfg`` in bf16 on one fixed batch
    (random weights, torch.Generator seed 0; f32 moments), then the f32
    directional check at the initial weights, both at ``remat``. Emits
    and returns the line."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.param_count()
    line = {"phase": "train_families", "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model, "params": n,
            "batch": lm_b, "seq": lm_s, "dtype": cfg.dtype, "remat": remat,
            "moment_dtype": "float32", "card": card,
            # bf16 weights and gradients, f32 moments; then the check's f32
            # weights, gradients and moved weights, and the gradient's signs
            "planned_state_bytes": 12 * n, "planned_check_bytes": 13 * n}
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt = AdamWConfig(lr=FAMILY_LR, warmup_steps=1)
    opt_state = adamw_init(params, opt)
    batch = make_lm_batch(cfg, 0, 0, lm_b, lm_s, device=dev)
    step = make_train_step(cfg, opt, remat=remat)
    torch.cuda.synchronize()
    line["setup_s"] = time.perf_counter() - t0
    losses, norms, ms = [], [], []
    for _ in range(FAMILY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms[1:])
    line.update(losses=losses, grad_norms=norms, step_ms=ms,
                ms_per_step=step_ms,
                tokens_per_s=lm_b * lm_s / (step_ms / 1e3),
                peak_bytes=torch.cuda.max_memory_allocated())
    del opt_state, step, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    line["directional_f32"] = directional_check(cfg32, batch, dev, remat)
    line["directional_s"] = time.perf_counter() - t0
    line["check_peak_bytes"] = torch.cuda.max_memory_allocated()
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(line)
    check(all(np.isfinite(losses)), f"train_families {cfg.name}: losses "
          f"{losses}")
    check(losses[-1] < losses[0], f"train_families {cfg.name}: the loss "
          f"did not fall: {losses}")
    dcheck = line["directional_f32"]
    check(dcheck["rel_err"] <= DIR_TOL, f"train_families {cfg.name}: "
          f"central difference {dcheck['central']} against the gradient's "
          f"{dcheck['grad_change']} (relative {dcheck['rel_err']} > "
          f"{DIR_TOL})")
    return line


def moe_shards_phase(dev, rows: dict, card: str) -> None:
    """moe_shards: phi3.5-moe at full width, 4 layers, a 4 x 2048 prefill
    whose MoE routes MOE_SHARDS data shards on their own
    (``act_specs["moe"]``), through row 9 (one flash launch a layer, on
    the tensor cores). Each MoE layer's output against the same tokens as
    MOE_SHARDS quarters each routed alone: the same routes bit for bit,
    the outputs within MOE_SHARD_RMS_TOL; the share of (token, choice)
    pairs dropped by shard and by one global routing."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import moe, transformer
    from repro_torch.models.transformer import forward, init_params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"), n_layers=4)
    lm_b, lm_s = 4, 2048
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    batch = make_lm_batch(cfg, 0, 0, lm_b, lm_s, device=dev)
    batch.pop("labels")
    spec = {"moe": {"dp": None, "e": None, "n_dp": MOE_SHARDS}}
    m = cfg.moe
    with torch.inference_mode():
        forward(params, batch, cfg, act_specs=spec)          # warm
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = forward(params, batch, cfg, act_specs=spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flash = ops.LAUNCHES["flash_attention"]
        routes = dict(ROUTE_LAUNCHES)
        glob = forward(params, batch, cfg)
        vs_global = compare(logits, glob)
        del logits, glob
        layers = []
        real, route = transformer.apply_moe, moe.route

        def checked(p, x, cfg_, act_specs=None, model=None):
            plans = []

            def recorded(xf, router, m_, cap):
                out = route(xf, router, m_, cap)
                plans.append(out)
                return out

            y = with_patched(moe, "route", recorded,
                             lambda: real(p, x, cfg_, act_specs=act_specs,
                                          model=model))
            b, s, d = x.shape
            xs = x.reshape(MOE_SHARDS, b * s // MOE_SHARDS, d)
            quarters = torch.cat([with_patched(
                moe, "route", recorded, lambda: real(p, xs[i][None], cfg_))
                for i in range(MOE_SHARDS)], dim=1).reshape(b, s, d)
            shard, alone = plans[:MOE_SHARDS], plans[MOE_SHARDS:]
            keep_all = route(x.reshape(b * s, d), p["router"], m,
                             moe.moe_capacity(m, b * s))[1]
            rms, max_abs, _ = compare(y.reshape(1, b * s, d),
                                      quarters.reshape(1, b * s, d))
            layers.append({
                "routes_equal": all(
                    torch.equal(u, w) for one, other in zip(shard, alone)
                    for u, w in zip(one[1:], other[1:])),
                "gates_equal": all(torch.equal(one[0], other[0])
                                   for one, other in zip(shard, alone)),
                "rel_rms": rms, "max_abs": max_abs,
                "dropped_share_by_shard": [
                    float((~pl[1]).sum()) / pl[1].numel() for pl in shard],
                "dropped_share_global": float((~keep_all).sum())
                / keep_all.numel()})
            return y

        with_patched(transformer, "apply_moe", checked,
                     lambda: forward(params, batch, cfg, act_specs=spec))
    rows["flash_attention"]["launches"] += flash
    rows["flash_attention"].setdefault("launches_by_phase", {})[
        f"moe_shards:{cfg.name}"] = flash
    cap = moe.moe_capacity(m, lm_b * lm_s // MOE_SHARDS)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe_shards", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": lm_b, "seq": lm_s, "n_dp": MOE_SHARDS,
          "capacity_a_shard": cap,
          "capacity_global": moe.moe_capacity(m, lm_b * lm_s),
          "wall_s": wall, "prefill_tokens_per_s": lm_b * lm_s / wall,
          "flash_attention_launches": flash,
          "flash_attention_route_launches": routes,
          "logits_vs_global_routing": {"rel_rms": vs_global[0],
                                       "max_abs": vs_global[1],
                                       "top1_agreement": vs_global[2]},
          "layers_vs_quarters": layers, "tolerance": MOE_SHARD_RMS_TOL,
          "card": card})
    check(flash == cfg.n_layers and routes == {"tc_bf16": cfg.n_layers,
                                               "simt_f32": 0},
          f"moe_shards: flash launches {flash}, routes {routes}")
    check(len(layers) == cfg.n_layers, f"moe_shards: {len(layers)} MoE "
          "layers checked")
    for i, lay in enumerate(layers):
        check(lay["routes_equal"] and lay["gates_equal"], f"moe_shards: "
              f"layer {i}'s shard routes differ from the quarters' own")
        check(lay["rel_rms"] <= MOE_SHARD_RMS_TOL, f"moe_shards: layer {i} "
              f"{lay['rel_rms']} (relative RMS) from the quarters")


def sharded_cfg():
    """sharded_step's model and optimiser: SHARDED_ARCH at full width cut
    to SHARDED_LAYERS layers, AdamW with f32 moments."""
    from repro_torch.configs import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    return (dataclasses.replace(get_arch(SHARDED_ARCH),
                                n_layers=SHARDED_LAYERS),
            AdamWConfig(lr=FAMILY_LR, warmup_steps=1))


def sharded_rank(rank, world, dev):
    """One rank of sharded_step: its blocks of the parameters and AdamW
    moments (their bytes by ``torch.cuda.memory_allocated``),
    SHARDED_STEPS steps on its batch shard, the probes of the first
    step's whole averaged gradient, the wire bytes a step by axis and
    kind, the bytes staged through host memory."""
    import repro_torch.train.step as step_mod
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    cfg, opt = sharded_cfg()
    mesh = make_mesh(SHARDED_MESH, device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    pspecs = shd.param_specs(full, cfg, shape)
    params = shd.shard_tree(full, pspecs, shape, mesh.coords)
    del full
    gc.collect()
    opt_state = adamw_init(params, opt)
    torch.cuda.synchronize(dev)
    stored = torch.cuda.memory_allocated(dev) - base
    step = step_mod.make_sharded_train_step(cfg, opt, mesh,
                                            global_batch=SHARDED_BATCH)
    bspecs = shd.batch_specs(cfg, shape, SHARDED_BATCH)
    probes = []
    inner = step_mod.global_norm
    whole = make_lm_batch(cfg, 0, 0, SHARDED_BATCH, SHARDED_SEQ, device=dev)

    def probed(tree):
        if not probes:
            probes.append(train_psa_probes(tree, whole["tokens"]))
        return inner(tree)

    step_mod.global_norm = probed
    local = shd.shard_tree(whole, bspecs, shape, mesh.coords)
    out = {"coords": mesh.coords, "stored_bytes": stored,
           **timed_steps(step, params, opt_state, local, mesh, dev,
                         SHARDED_STEPS)}
    step_mod.global_norm = inner
    out["probes"] = probes[0]
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    out["split"] = tp_steps(mesh, dev)
    out["recurrent"] = tp_recurrent_steps(mesh, dev)
    out["frontends"] = tp_recurrent_steps(mesh, dev, TP_FRONT_TRAIN)
    out["long"] = tp_long_rank(mesh, dev)
    out["heads"] = tp_heads_rank(dev)
    out["tied"] = tp_heads_rank(dev, tp_tied_cfg())
    return out


def timed_steps(step, params, opt_state, local, mesh, dev, n: int) -> dict:
    """``n`` train steps of ``step`` on a rank's batch shard ``local``
    (AdamW writes into ``params`` and ``opt_state``): the loss, grad norm,
    ms, wire bytes by axis and kind and bytes staged through host memory
    of each, and the peak of device memory over them."""
    out = {"losses": [], "grad_norms": [], "step_ms": [], "wire_a_step": [],
           "staged_a_step": []}
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(n):
        wire0 = mesh.wire_bytes()
        staged = mesh.host_staged_bytes
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, local)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        torch.cuda.synchronize(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        wire1 = mesh.wire_bytes()
        out["wire_a_step"].append({a: {k: wire1[a][k] - wire0[a][k]
                                       for k in wire1[a]} for a in wire1})
        out["staged_a_step"].append(mesh.host_staged_bytes - staged)
    out["peak_bytes_in_steps"] = torch.cuda.max_memory_allocated(dev)
    return out


class expandable_segments:
    """Spawned ranks allocate each tensor its own 512-byte-rounded block
    (no whole cached segment handed out), as the dry run's plan counts."""

    def __enter__(self):
        self.kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    def __exit__(self, *exc):
        if self.kept is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = self.kept


def one_process(cfg, batch: int, seq: int, n_dp: int, dev,
                probes: bool = False) -> dict:
    """One process, from the weights of seed 0: the loss on the whole
    batch, and a sharded step's own math plainly, each of ``n_dp`` data
    shards' gradients by its own backward pass and their f32 mean (its
    loss, its norm and, with ``probes``, ``train_psa_probes`` of it)."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import _value_and_grad, loss_fn, shard_batch
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    whole = make_lm_batch(cfg, 0, 0, batch, seq, device=dev)
    with torch.no_grad():
        whole_loss = float(loss_fn(params, whole, cfg))
    halves = [_value_and_grad(params, shard_batch(whole, i, n_dp), cfg)
              for i in range(n_dp)]
    _, first, structure = _tree.flatten_with_names(halves[0][1])
    rest = [_tree.tree_leaves(g) for _, g in halves[1:]]
    grads = _tree.unflatten(structure, [
        (sum([g.float()] + [o[i].float() for o in rest]) / n_dp).to(g.dtype)
        for i, g in enumerate(first)])
    out = {"loss": sum(float(lo) for lo, _ in halves) / n_dp,
           "whole_batch_loss": whole_loss,
           "grad_norm": float(global_norm(grads))}
    if probes:
        out["probes"] = train_psa_probes(grads, whole["tokens"])
    del params, grads, halves, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_step_phase(dev, card: str) -> dict:
    """sharded_step: SHARDED_ARCH at full width on a (2, 2) gloo mesh of
    4 ranks sharing the card (module docstring). Returns the line."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import sharding as shd
    gc.collect()
    torch.cuda.empty_cache()
    cfg, opt = sharded_cfg()
    mesh = shd.MeshShape.of(*SHARDED_MESH)
    shape = ShapeConfig("sharded_step", SHARDED_SEQ, SHARDED_BATCH, "train")
    plan = dryrun.memory_plan(cfg, shape, mesh, opt)
    want_stored = plan["params"]["alloc"] + plan["opt"]["alloc"]
    want_wire = roofline.step_wire_bytes(cfg, shape, mesh)
    t0 = time.perf_counter()
    with expandable_segments():
        ranks = spawn_ranks(sharded_rank, mesh.size, backend="gloo",
                            device="cuda")
    spawn_s = time.perf_counter() - t0
    one = one_process(cfg, SHARDED_BATCH, SHARDED_SEQ, mesh.shape["data"],
                      dev, probes=True)
    vs_one = [{"loss_rel_err": abs(r["losses"][0] - one["loss"])
               / abs(one["loss"]),
               "grad_norm_rel_err": abs(r["grad_norms"][0] - one["grad_norm"])
               / one["grad_norm"],
               "grad_max_rel_err": {k: _max_rel(v, one["probes"][k])
                                    for k, v in r["probes"].items()}}
              for r in ranks]
    line = {"phase": "sharded_step", "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(), "mesh": mesh.shape,
            "backend": "gloo", "batch": SHARDED_BATCH, "seq": SHARDED_SEQ,
            "stored_bytes_by_rank": [r["stored_bytes"] for r in ranks],
            "planned_stored_bytes": want_stored,
            "plan": {k: plan[k] for k in ("params", "opt", "inputs",
                                          "total")},
            "losses_by_rank": [r["losses"] for r in ranks],
            "one_process": {k: one[k] for k in ("loss", "whole_batch_loss",
                                                "grad_norm")},
            "whole_batch_loss_rel_err": [
                abs(r["losses"][0] - one["whole_batch_loss"])
                / abs(one["whole_batch_loss"]) for r in ranks],
            "vs_one_process": vs_one,
            "tolerance": {"loss": TRAIN_LOSS_TOL,
                          "grad_norm": PLAIN_GNORM_TOL,
                          "grad": PLAIN_GRAD_TOL},
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "wire_a_step_rank0": ranks[0]["wire_a_step"][0],
            "planned_wire_a_step": want_wire,
            "host_staged_bytes_a_step": [r["staged_a_step"] for r in ranks],
            "peak_bytes_in_steps_by_rank": [r["peak_bytes_in_steps"]
                                            for r in ranks],
            "spawn_and_run_s": spawn_s, "card": card}
    emit(line)
    for r, vs in zip(ranks, vs_one):
        check(r["stored_bytes"] == want_stored, f"sharded_step: rank "
              f"{r['coords']} stores {r['stored_bytes']} bytes, the plan "
              f"{want_stored}")
        check(all(np.isfinite(r["losses"])), f"sharded_step: {r['losses']}")
        check(vs["loss_rel_err"] <= TRAIN_LOSS_TOL, f"sharded_step: rank "
              f"{r['coords']} loss {r['losses'][0]}, one process "
              f"{one['loss']}")
        check(abs(r["losses"][0] - one["whole_batch_loss"]) <= TRAIN_LOSS_TOL
              * abs(one["whole_batch_loss"]), f"sharded_step: rank "
              f"{r['coords']} loss {r['losses'][0]}, the whole batch's in one "
              f"process {one['whole_batch_loss']}")
        check(vs["grad_norm_rel_err"] <= PLAIN_GNORM_TOL, f"sharded_step: "
              f"grad norm {r['grad_norms'][0]}, one process "
              f"{one['grad_norm']}")
        check(len(vs["grad_max_rel_err"]) >= 3 and max(
            vs["grad_max_rel_err"].values()) <= PLAIN_GRAD_TOL,
            f"sharded_step: gradients {vs['grad_max_rel_err']}")
        for w in r["wire_a_step"]:
            check(all(w[a][k] == want_wire[a][k] for a in want_wire
                      for k in want_wire[a]), f"sharded_step: wire bytes "
                  f"{w}, planned {want_wire}")
    line["_step_s"] = statistics.median(
        ms for r in ranks for ms in r["step_ms"][1:]) / 1e3
    line["_grad_norms"] = [r["grad_norms"] for r in ranks]
    line["coords_by_rank"] = [r["coords"] for r in ranks]
    line["_split_ranks"] = [r["split"] for r in ranks]
    line["_recurrent_ranks"] = [r["recurrent"] for r in ranks]
    line["_frontends_ranks"] = [r["frontends"] for r in ranks]
    line["_long_ranks"] = [r["long"] for r in ranks]
    line["_heads_ranks"] = [r["heads"] for r in ranks]
    line["_tied_ranks"] = [r["tied"] for r in ranks]
    return line


def remat_phase(dev, card: str) -> None:
    """remat: REMAT_STEPS AdamW steps of REMAT_ARCH at each remat, from the
    same weights (torch.Generator seed 0) and batch: the first loss bit for
    bit, the grad norm within REMAT_GNORM_TOL, peak memory (module
    constants); ms a step."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get_arch(REMAT_ARCH)
    opt = AdamWConfig(lr=FAMILY_LR, warmup_steps=1)
    batch = make_lm_batch(cfg, 0, 0, REMAT_BATCH, REMAT_SEQ, device=dev)
    runs = {}
    for remat in (False, "names", True):
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
        opt_state = adamw_init(params, opt)
        step = make_train_step(cfg, opt, remat=remat)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = {"losses": [], "grad_norms": [], "step_ms": []}
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = step(params, opt_state, batch)
            run["losses"].append(float(met["loss"]))
            run["grad_norms"].append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        run.update(state_bytes=held,
                   peak_bytes=torch.cuda.max_memory_allocated())
        runs[str(remat)] = run
        del params, opt_state, step, met
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    base = runs["False"]
    line = {"phase": "remat", "arch": cfg.name, "layers": cfg.n_layers,
            "batch": REMAT_BATCH, "seq": REMAT_SEQ, "dtype": cfg.dtype,
            "runs": runs,
            "first_loss_equal": {k: r["losses"][0] == base["losses"][0]
                                 for k, r in runs.items()},
            "grad_norm_rel_err": {
                k: abs(r["grad_norms"][0] - base["grad_norms"][0])
                / base["grad_norms"][0] for k, r in runs.items()},
            "tolerance": {"grad_norm": REMAT_GNORM_TOL}, "card": card}
    emit(line)
    for k, r in runs.items():
        check(all(np.isfinite(r["losses"])), f"remat {k}: {r['losses']}")
        check(line["first_loss_equal"][k], f"remat {k}: first loss "
              f"{r['losses'][0]}, without remat {base['losses'][0]}")
        check(line["grad_norm_rel_err"][k] <= REMAT_GNORM_TOL, f"remat {k}: "
              f"grad norm {r['grad_norms'][0]}, without remat "
              f"{base['grad_norms'][0]}")
    for k in ("names", "True"):
        check(runs[k]["peak_bytes"] < base["peak_bytes"], f"remat {k}: "
              f"peak {runs[k]['peak_bytes']} bytes, without remat "
              f"{base['peak_bytes']}")


def tp_steps(mesh, dev) -> dict:
    """tp_step's part of a sharded_step rank (the same processes, once the
    unsplit route's state is freed): fresh blocks from the same seed, the
    same batch shard, SHARDED_STEPS steps with ``split_model=True``."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_sharded_train_step
    cfg, opt = sharded_cfg()
    shape = shd.MeshShape.from_mesh(mesh)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    params = shd.shard_tree(full, shd.param_specs(full, cfg, shape), shape,
                            mesh.coords)
    del full
    gc.collect()
    opt_state = adamw_init(params, opt)
    torch.cuda.synchronize(dev)
    stored = torch.cuda.memory_allocated(dev) - base
    step = make_sharded_train_step(cfg, opt, mesh,
                                   global_batch=SHARDED_BATCH,
                                   split_model=True)
    whole = make_lm_batch(cfg, 0, 0, SHARDED_BATCH, SHARDED_SEQ, device=dev)
    local = shd.shard_tree(whole, shd.batch_specs(cfg, shape, SHARDED_BATCH),
                           shape, mesh.coords)
    out = {"coords": mesh.coords, "stored_bytes": stored,
           **timed_steps(step, params, opt_state, local, mesh, dev,
                         SHARDED_STEPS)}
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rec_cfg(arch: str, layers: int, dtype=None):
    """``arch`` at full width cut to ``layers`` layers (in ``dtype``): the
    first ``layers`` entries of its pattern where they do not fill a
    whole one."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    if layers % len(cfg.block_pattern):
        cfg = dataclasses.replace(cfg,
                                  block_pattern=cfg.block_pattern[:layers])
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def tp_tied_cfg():
    """tp_tied's model: tp_heads', tied."""
    return dataclasses.replace(tp_rec_cfg(TP_HEADS_ARCH, TP_HEADS_LAYERS),
                               tie_embeddings=True)


def tp_recurrent_steps(mesh, dev, cells=TP_REC_TRAIN) -> dict:
    """tp_recurrent's part of a sharded_step rank (after tp_steps), and
    tp_frontends' (``cells`` TP_FRONT_TRAIN): for each of ``cells``, its
    blocks from seed 0 (their bytes), its batch shard, TP_REC_STEPS steps
    with ``split_model=True``."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_sharded_train_step
    _, opt = sharded_cfg()
    shape = shd.MeshShape.from_mesh(mesh)
    out = {}
    for arch, layers, batch, seq in cells:
        cfg = tp_rec_cfg(arch, layers)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
        params = shd.shard_tree(full, shd.param_specs(full, cfg, shape),
                                shape, mesh.coords)
        del full
        gc.collect()
        opt_state = adamw_init(params, opt)
        torch.cuda.synchronize(dev)
        stored = torch.cuda.memory_allocated(dev) - base
        step = make_sharded_train_step(cfg, opt, mesh, global_batch=batch,
                                       split_model=True)
        whole = make_lm_batch(cfg, 0, 0, batch, seq, device=dev)
        local = shd.shard_tree(whole, shd.batch_specs(cfg, shape, batch),
                               shape, mesh.coords)
        out[arch] = {"stored_bytes": stored,
                     **timed_steps(step, params, opt_state, local, mesh, dev,
                                   TP_REC_STEPS)}
        del params, opt_state, step, whole, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_long_cfg(arch: str, layers: int, window, dtype):
    """A TP_LONG run's model: ``arch`` at full width cut to ``layers``
    layers in ``dtype``, its window ``window`` where given."""
    cfg = tp_rec_cfg(arch, layers, dtype)
    return cfg if window is None else dataclasses.replace(cfg, window=window)


def tp_long_rank(mesh, dev) -> dict:
    """tp_long_decode's part of a sharded_step rank (after tp_frontends):
    for each TP_LONG run, its blocks from seed 0, the decode state of a
    batch of 1 (``sharded_decode_state``, its bytes by
    ``torch.cuda.memory_allocated``), then the teacher-forced steps of
    ``make_sharded_serve_step``'s decode: their logits on the host, the
    wire bytes of each, ms a step and the bytes staged a step."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import (make_sharded_serve_step,
                                        sharded_decode_state)
    shape = shd.MeshShape.from_mesh(mesh)
    res = {}
    for name, arch, layers, window, max_len, steps, dtype, _ in TP_LONG:
        cfg = tp_long_cfg(arch, layers, window, dtype)
        full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
        params = shd.shard_tree(full, shd.param_specs(full, cfg, shape),
                                shape, mesh.coords)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        toks = make_lm_batch(cfg, 0, 0, 1, steps, device=dev)["tokens"]
        _, decode = make_sharded_serve_step(cfg, mesh, 1)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        state = sharded_decode_state(cfg, mesh, 1, max_len)
        torch.cuda.synchronize(dev)
        out = {"state_bytes": torch.cuda.memory_allocated(dev) - base}
        decoded, wires = [], []
        staged = mesh.host_staged_bytes
        t0 = time.perf_counter()
        for t in range(steps):
            wire0 = mesh.wire_bytes()
            lg, state = decode(params, state, toks[:, t:t + 1])
            wire1 = mesh.wire_bytes()
            wires.append({a: {k: v - wire0[a][k] for k, v in w.items()}
                          for a, w in wire1.items()})
            decoded.append(lg)
        torch.cuda.synchronize(dev)
        out.update(decode_ms_a_step=(time.perf_counter() - t0) * 1e3 / steps,
                   decode_staged_bytes_a_step=(mesh.host_staged_bytes
                                               - staged) / steps,
                   decode_wires=wires,
                   decode=torch.cat(decoded, dim=1).cpu())
        res[name] = out
        del params, state, decoded, lg
        gc.collect()
        torch.cuda.empty_cache()
    return res


def tp_heads_rank(dev, cfg=None) -> dict:
    """tp_heads' part of a sharded_step rank (after tp_long_decode), and
    tp_tied's (after it, ``cfg`` its model): the
    4 ranks laid out as TP_HEADS_MESH; ``cfg`` (TP_HEADS_ARCH at
    TP_HEADS_LAYERS layers) from seed 0: its blocks and AdamW moments
    (their bytes), one
    split train step (remat True) on the whole TP_HEADS_TRAIN batch (a
    data axis of 1), then on a copy of the blocks from before the step
    the TP_HEADS_SERVE prefill, timed from its first call (its logits on
    the host, the flash launches and routes, wire and staged bytes), the
    decode state's bytes and TP_HEADS_DECODE teacher-forced steps."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params, tree_map
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step,
                                        sharded_decode_state)
    _, opt = sharded_cfg()
    mesh = make_mesh(TP_HEADS_MESH, device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    cfg = cfg or tp_rec_cfg(TP_HEADS_ARCH, TP_HEADS_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    params = shd.shard_tree(full, shd.param_specs(full, cfg, shape), shape,
                            mesh.coords)
    del full
    gc.collect()
    opt_state = adamw_init(params, opt)
    torch.cuda.synchronize(dev)
    stored = torch.cuda.memory_allocated(dev) - base
    blocks = tree_map(lambda leaf: leaf.clone(), params)
    b, s = TP_HEADS_TRAIN
    step = make_sharded_train_step(cfg, opt, mesh, global_batch=b,
                                   split_model=True)
    whole = make_lm_batch(cfg, 0, 0, b, s, device=dev)
    local = shd.shard_tree(whole, shd.batch_specs(cfg, shape, b), shape,
                           mesh.coords)
    out = {"coords": mesh.coords, "stored_bytes": stored,
           **timed_steps(step, params, opt_state, local, mesh, dev, 1)}
    del params, opt_state, step, whole, local
    gc.collect()
    torch.cuda.empty_cache()
    b, s = TP_HEADS_SERVE
    inputs = serve_inputs(cfg, b, s, dev)
    specs = shd.batch_specs(cfg, shape, b)
    local = shd.shard_tree(inputs, {k: specs[k] for k in inputs}, shape,
                           mesh.coords)
    prefill, decode = make_sharded_serve_step(cfg, mesh, b)
    torch.cuda.synchronize(dev)
    wire0, staged = mesh.wire_bytes(), mesh.host_staged_bytes
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(blocks, local)
    torch.cuda.synchronize(dev)
    out.update(prefill_ms=(time.perf_counter() - t0) * 1e3,
               flash_launches=ops.LAUNCHES["flash_attention"],
               flash_routes=dict(ROUTE_LAUNCHES),
               prefill_staged_bytes=mesh.host_staged_bytes - staged,
               prefill_wire={a: {k: v - wire0[a][k] for k, v in w.items()}
                             for a, w in mesh.wire_bytes().items()},
               prefill=logits.cpu())
    del logits
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    state = sharded_decode_state(cfg, mesh, b, TP_HEADS_RING)
    torch.cuda.synchronize(dev)
    out["state_bytes"] = torch.cuda.memory_allocated(dev) - base
    decoded, wires = [], []
    staged = mesh.host_staged_bytes
    t0 = time.perf_counter()
    for t in range(TP_HEADS_DECODE):
        wire0 = mesh.wire_bytes()
        lg, state = decode(blocks, state, local["tokens"][:, t:t + 1])
        wire1 = mesh.wire_bytes()
        wires.append({a: {k: v - wire0[a][k] for k, v in w.items()}
                      for a, w in wire1.items()})
        decoded.append(lg)
    torch.cuda.synchronize(dev)
    out.update(decode_ms_a_step=(time.perf_counter() - t0) * 1e3
               / TP_HEADS_DECODE,
               decode_staged_bytes_a_step=(mesh.host_staged_bytes - staged)
               / TP_HEADS_DECODE,
               decode_wires=wires, decode=torch.cat(decoded, dim=1).cpu())
    del blocks, state, decoded, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_step_phase(dev, card: str, sharded: dict) -> dict:
    """tp_step: sharded_step with the compute split over "model"
    (``make_sharded_train_step(split_model=True)``, remat=True), run by
    sharded_step's 4 ranks after their unsplit steps (``tp_steps``) and
    held to ``sharded``, sharded_step's line (the unsplit route on the same
    weights and batch). Returns the line."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import sharding as shd
    cfg, opt = sharded_cfg()
    mesh = shd.MeshShape.of(*SHARDED_MESH)
    shape = ShapeConfig("tp_step", SHARDED_SEQ, SHARDED_BATCH, "train")
    plan = dryrun.memory_plan(cfg, shape, mesh, opt)
    want_stored = plan["params"]["alloc"] + plan["opt"]["alloc"]
    want_wire = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    ranks = sharded["_split_ranks"]
    by_coords = {tuple(c.values()): i for i, c in
                 enumerate(sharded["coords_by_rank"])}
    vs = []
    for r in ranks:
        i = by_coords[tuple(r["coords"].values())]
        loss, norm = sharded["losses_by_rank"][i][0], \
            sharded["_grad_norms"][i][0]
        vs.append({"loss_rel_err": abs(r["losses"][0] - loss) / abs(loss),
                   "grad_norm_rel_err": abs(r["grad_norms"][0] - norm)
                   / norm})
    line = {"phase": "tp_step", "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "mesh": mesh.shape, "backend": "gloo",
            "batch": SHARDED_BATCH, "seq": SHARDED_SEQ, "remat": True,
            "stored_bytes_by_rank": [r["stored_bytes"] for r in ranks],
            "planned_stored_bytes": want_stored,
            "losses_by_rank": [r["losses"] for r in ranks],
            "grad_norms_by_rank": [r["grad_norms"] for r in ranks],
            "vs_sharded_step": vs,
            "tolerance": {"loss": TP_LOSS_TOL, "grad_norm": TP_GNORM_TOL},
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "sharded_step_ms_by_rank": sharded["step_ms_by_rank"],
            "wire_a_step_rank0": ranks[0]["wire_a_step"][0],
            "planned_wire_a_step": want_wire,
            "host_staged_bytes_a_step": [r["staged_a_step"] for r in ranks],
            "sharded_step_host_staged_bytes_a_step":
                sharded["host_staged_bytes_a_step"],
            "peak_bytes_in_steps_by_rank": [r["peak_bytes_in_steps"]
                                            for r in ranks],
            "card": card}
    emit(line)
    for r, v in zip(ranks, vs):
        check(r["stored_bytes"] == want_stored, f"tp_step: rank "
              f"{r['coords']} stores {r['stored_bytes']} bytes, the plan "
              f"{want_stored}")
        check(all(np.isfinite(r["losses"])), f"tp_step: {r['losses']}")
        check(v["loss_rel_err"] <= TP_LOSS_TOL, f"tp_step: rank "
              f"{r['coords']} loss {r['losses'][0]}: {v['loss_rel_err']} "
              f"from sharded_step's")
        check(v["grad_norm_rel_err"] <= TP_GNORM_TOL, f"tp_step: rank "
              f"{r['coords']} grad norm {r['grad_norms'][0]}: "
              f"{v['grad_norm_rel_err']} from sharded_step's")
        for w in r["wire_a_step"]:
            check(all(w[a][k] == want_wire[a][k] for a in want_wire
                      for k in want_wire[a]), f"tp_step: wire bytes "
                  f"{w}, planned {want_wire}")
    line["_step_s"] = statistics.median(
        ms for r in ranks for ms in r["step_ms"][1:]) / 1e3
    return line


def tp_recurrent_phase(dev, card: str, sharded: dict,
                       phase: str = "tp_recurrent", cells=TP_REC_TRAIN,
                       key: str = "_recurrent_ranks") -> dict:
    """tp_recurrent: each TP_REC_TRAIN family split over "model" on
    sharded_step's (2, 2) mesh, run by its 4 ranks after tp_step
    (``tp_recurrent_steps``): stored bytes equal to the dry run's plan,
    wire bytes a step equal to ``step_wire_bytes(split_model=True)``, the
    first loss and grad norm within TP_LOSS_TOL / TP_GNORM_TOL of one
    process's (``one_process``); ms, staged bytes and peak memory a
    step. A line a family. tp_frontends is the same for ``cells``
    TP_FRONT_TRAIN, the ranks' results under ``sharded[key]``. Returns
    ``roofline_phase``'s entries: (cfg, shape, the median step's seconds,
    remat, mesh, split)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import sharding as shd
    _, opt = sharded_cfg()
    mesh = shd.MeshShape.of(*SHARDED_MESH)
    measured = {}
    for arch, layers, batch, seq in cells:
        cfg = tp_rec_cfg(arch, layers)
        shape = ShapeConfig(phase, seq, batch, "train")
        plan = dryrun.memory_plan(cfg, shape, mesh, opt)
        want_stored = plan["params"]["alloc"] + plan["opt"]["alloc"]
        want_wire = roofline.step_wire_bytes(cfg, shape, mesh,
                                             split_model=True)
        one = one_process(cfg, batch, seq, mesh.shape["data"], dev)
        ranks = [r[arch] for r in sharded[key]]
        vs = [{"loss_rel_err": abs(r["losses"][0] - one["loss"])
               / abs(one["loss"]),
               "grad_norm_rel_err": abs(r["grad_norms"][0]
                                        - one["grad_norm"])
               / one["grad_norm"]} for r in ranks]
        line = {"phase": phase, "arch": cfg.name,
                "layers": cfg.n_layers, "pattern": list(
                    cfg.pattern_for_layers()), "d_model": cfg.d_model,
                "params": cfg.param_count(), "mesh": mesh.shape,
                "backend": "gloo", "batch": batch, "seq": seq, "remat": True,
                "coords_by_rank": sharded["coords_by_rank"],
                "stored_bytes_by_rank": [r["stored_bytes"] for r in ranks],
                "planned_stored_bytes": want_stored,
                "losses_by_rank": [r["losses"] for r in ranks],
                "grad_norms_by_rank": [r["grad_norms"] for r in ranks],
                "one_process": one, "vs_one_process": vs,
                "tolerance": {"loss": TP_LOSS_TOL,
                              "grad_norm": TP_GNORM_TOL},
                "step_ms_by_rank": [r["step_ms"] for r in ranks],
                "wire_a_step_rank0": ranks[0]["wire_a_step"][0],
                "planned_wire_a_step": want_wire,
                "host_staged_bytes_a_step": [r["staged_a_step"]
                                             for r in ranks],
                "peak_bytes_in_steps_by_rank": [r["peak_bytes_in_steps"]
                                                for r in ranks],
                "card": card}
        emit(line)
        for r, v, c in zip(ranks, vs, sharded["coords_by_rank"]):
            check(r["stored_bytes"] == want_stored, f"{phase} {arch}: "
                  f"rank {c} stores {r['stored_bytes']} bytes, the plan "
                  f"{want_stored}")
            check(all(np.isfinite(r["losses"])),
                  f"{phase} {arch}: {r['losses']}")
            check(v["loss_rel_err"] <= TP_LOSS_TOL, f"{phase} {arch}: "
                  f"rank {c} loss {r['losses'][0]}: {v['loss_rel_err']} "
                  f"from one process's")
            check(v["grad_norm_rel_err"] <= TP_GNORM_TOL,
                  f"{phase} {arch}: rank {c} grad norm "
                  f"{r['grad_norms'][0]}: {v['grad_norm_rel_err']} from one "
                  f"process's")
            for w in r["wire_a_step"]:
                check(all(w[a][k] == want_wire[a][k] for a in want_wire
                          for k in want_wire[a]),
                      f"{phase} {arch}: wire bytes {w}, planned "
                      f"{want_wire}")
        measured[f"{phase}:{arch}"] = (
            cfg, shape, statistics.median(
                ms for r in ranks for ms in r["step_ms"]) / 1e3, True, mesh,
            True)
    return measured


def tp_long_decode_phase(dev, card: str, sharded: dict) -> None:
    """tp_long_decode: each TP_LONG run, a batch of 1 on sharded_step's
    (2, 2), decoded by its 4 ranks after tp_frontends (``tp_long_rank``):
    each rank's logits (its vocabulary rows, the whole batch) against one
    process's teacher-forced decode at the run's limit, the decode state's
    bytes equal to the dry run's plan (``decode_state_specs``' batch-1
    specs, the reference's long_500k case) and the wire bytes of each step
    equal to ``step_wire_bytes(split_model=True)``; ms and staged bytes a
    step. A line a run."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import (decode_step,
                                                init_decode_state,
                                                init_params)
    from repro_torch.optim.adamw import AdamWConfig
    mesh = shd.MeshShape.of(*SHARDED_MESH)
    coords = sharded["coords_by_rank"]
    for name, arch, layers, window, max_len, steps, dtype, tol in TP_LONG:
        cfg = tp_long_cfg(arch, layers, window, dtype)
        got = [r[name] for r in sharded["_long_ranks"]]
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
        toks = make_lm_batch(cfg, 0, 0, 1, steps, device=dev)["tokens"]
        with torch.inference_mode():
            state = init_decode_state(cfg, 1, max_len, device=dev)
            outs = []
            for t in range(steps):
                lg, state = decode_step(params, state, toks[:, t:t + 1], cfg)
                outs.append(lg)
            want = torch.cat(outs, dim=1)
            by_data = {}
            for r, c in zip(got, coords):
                by_data.setdefault(c["data"], {})[c["model"]] = r["decode"]
            vs = [compare(torch.cat([row[m].to(dev) for m in sorted(row)],
                                    dim=-1), want)
                  for _, row in sorted(by_data.items())]
        del params, state, outs, want
        gc.collect()
        torch.cuda.empty_cache()
        shape = ShapeConfig("tp_long_decode", max_len, 1, "decode")
        plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig())[
            "decode_state"]
        wire = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
        axes = shd.length_axes(cfg, mesh, 1)
        line = {"phase": "tp_long_decode", "run": name, "arch": cfg.name,
                "layers": cfg.n_layers, "dtype": cfg.dtype,
                "window": cfg.window, "mesh": mesh.shape, "backend": "gloo",
                "batch": 1, "max_len": max_len, "decode_steps": steps,
                "length_axes": list(axes),
                "decode_vs_one_process_by_data_rank": [dict(zip(
                    ("rel_rms", "max_abs", "top1_agreement"), v))
                    for v in vs],
                "tolerance": tol,
                "decode_ms_a_step_by_rank": [r["decode_ms_a_step"]
                                             for r in got],
                "decode_staged_bytes_a_step_by_rank": [
                    r["decode_staged_bytes_a_step"] for r in got],
                "state_bytes_by_rank": [r["state_bytes"] for r in got],
                "planned_state_bytes": plan["alloc"],
                "decode_wire_a_step_rank0": got[0]["decode_wires"][0],
                "planned_wire": wire, "card": card}
        emit(line)
        for v in vs:
            check(v[0] <= tol, f"tp_long_decode {name}: decode logits "
                  f"{v[0]} (relative RMS) from one process > {tol}")
        for r, c in zip(got, coords):
            check(r["state_bytes"] == plan["alloc"], f"tp_long_decode "
                  f"{name}: rank {c} decode state {r['state_bytes']} bytes, "
                  f"the plan {plan['alloc']}")
            for w in r["decode_wires"]:
                check(all(w[a][k] == wire[a][k] for a in wire
                          for k in wire[a]),
                      f"tp_long_decode {name}: wire bytes {w}, planned "
                      f"{wire}")


def tp_heads_row(dev, rows: dict, record) -> None:
    """The row ``flash_attention_head_offset``: row 9 at TP_HEADS_ROW (a
    model rank's heads straddling GQA groups) against plain and SDPA on
    the kv heads expanded to the rank's heads."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import expand_kv
    from repro_torch.models import sharding as shd
    qc = get_arch(TP_HEADS_ROW["arch"])
    rep_ = qc.n_heads // qc.n_kv_heads
    h0, h1 = shd.share(qc.n_heads, TP_HEADS_ROW["tp"], TP_HEADS_ROW["rank"])
    kv0, kv1 = shd.kv_read(qc.n_heads, qc.n_kv_heads, (h0, h1))
    b, s, hd = TP_HEADS_ROW["batch"], TP_HEADS_ROW["seq"], qc.hd
    gen = torch.Generator(device=dev).manual_seed(29)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((b, h1 - h0, s, hd),
                                      (b, kv1 - kv0, s, hd),
                                      (b, kv1 - kv0, s, hd)))
    ke, ve = (expand_kv(t, h1 - h0, rep_, h0) for t in (k, v))
    record("flash_attention_head_offset", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True, group=rep_,
                                       q_head0=h0),
           lambda: attn_plain(q, k, v, causal=True, group=rep_, q_head0=h0),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, ke, ve, is_causal=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * b * q.shape[1] * hd * s * (s + 1) / 2, ATTN_BF16_TOL,
           ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
           judge=attn_judge(torch.bfloat16))
    rows["flash_attention_head_offset"].update(
        kernel="flash_attention_wgmma_kernel", group=rep_, q_head0=h0,
        query_heads=[h0, h1], kv_heads=[kv0, kv1],
        library="scaled_dot_product_attention, causal, on kv expanded to "
                "the rank's heads",
        shape=[list(q.shape), list(k.shape)])
    del q, k, v, ke, ve


def tp_heads_phase(dev, rows: dict, record, card: str,
                   sharded: dict, name: str = "tp_heads") -> dict:
    """tp_heads, or tp_tied (``name``; module docstring): for tp_heads
    first the row ``flash_attention_head_offset``, row 9 at TP_HEADS_ROW
    against plain and SDPA on the kv heads expanded to the rank's heads;
    then sharded_step ranks' ``tp_heads_rank`` results held to the plans
    and to one process, the ranks' prefill launches credited to the row
    (where it was timed). A line for the train step and one for the serve
    run. Returns ``roofline_phase``'s entry for the train step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state,
                                                init_params)
    from repro_torch.optim.adamw import AdamWConfig
    gc.collect()
    torch.cuda.empty_cache()
    if name == "tp_heads":
        tp_heads_row(dev, rows, record)
    cfg = (tp_rec_cfg(TP_HEADS_ARCH, TP_HEADS_LAYERS) if name == "tp_heads"
           else tp_tied_cfg())
    mesh = shd.MeshShape.of(*TP_HEADS_MESH)
    tp = mesh.shape["model"]
    ranks = sorted(sharded["_heads_ranks" if name == "tp_heads" else
                           "_tied_ranks"], key=lambda r: r["coords"]["model"])
    views = [shd.model_view(cfg, mesh, r["coords"]["model"]) for r in ranks]
    n_attn = sum(kind in ("attn", "swa") for kind in
                 cfg.pattern_for_layers()) * cfg.n_groups
    launches = sum(r["flash_launches"] for r in ranks)
    row = rows.get("flash_attention_head_offset")
    if row is not None:
        row["launches"] += launches
        row.setdefault("launches_by_phase", {})[f"{name}:{cfg.name}"] = \
            launches
    # (a) the train step against one process
    _, opt = sharded_cfg()
    tb, ts = TP_HEADS_TRAIN
    train_shape = ShapeConfig(name, ts, tb, "train")
    plan = dryrun.memory_plan(cfg, train_shape, mesh, opt)
    want_stored = plan["params"]["alloc"] + plan["opt"]["alloc"]
    want_wire = roofline.step_wire_bytes(cfg, train_shape, mesh,
                                         split_model=True)
    one = one_process(cfg, tb, ts, mesh.shape["data"], dev)
    vs = [{"loss_rel_err": abs(r["losses"][0] - one["loss"])
           / abs(one["loss"]),
           "grad_norm_rel_err": abs(r["grad_norms"][0] - one["grad_norm"])
           / one["grad_norm"]} for r in ranks]
    line = {"phase": name, "run": "train", "arch": cfg.name,
            "tie_embeddings": cfg.tie_embeddings, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "mesh": mesh.shape, "backend": "gloo", "batch": tb, "seq": ts,
            "remat": True, "heads_by_rank": [v.heads for v in views],
            "q_cols_by_rank": [v.q_cols for v in views],
            "kv_heads_by_rank": [v.kv_heads for v in views],
            "stored_bytes_by_rank": [r["stored_bytes"] for r in ranks],
            "planned_stored_bytes": want_stored,
            "losses_by_rank": [r["losses"] for r in ranks],
            "grad_norms_by_rank": [r["grad_norms"] for r in ranks],
            "one_process": one, "vs_one_process": vs,
            "tolerance": {"loss": TP_LOSS_TOL, "grad_norm": TP_GNORM_TOL},
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "wire_a_step_rank0": ranks[0]["wire_a_step"][0],
            "planned_wire_a_step": want_wire,
            "host_staged_bytes_a_step": [r["staged_a_step"] for r in ranks],
            "peak_bytes_in_steps_by_rank": [r["peak_bytes_in_steps"]
                                            for r in ranks],
            "card": card}
    emit(line)
    for r, v in zip(ranks, vs):
        c = r["coords"]
        check(r["stored_bytes"] == want_stored, f"{name}: rank {c} stores "
              f"{r['stored_bytes']} bytes, the plan {want_stored}")
        check(all(np.isfinite(r["losses"])), f"{name}: {r['losses']}")
        check(v["loss_rel_err"] <= TP_LOSS_TOL, f"{name}: rank {c} loss "
              f"{r['losses'][0]}: {v['loss_rel_err']} from one process's")
        check(v["grad_norm_rel_err"] <= TP_GNORM_TOL, f"{name}: rank {c} "
              f"grad norm {r['grad_norms'][0]}: {v['grad_norm_rel_err']} "
              f"from one process's")
        for w in r["wire_a_step"]:
            check(all(w[a][k] == want_wire[a][k] for a in want_wire
                      for k in want_wire[a]), f"{name}: train wire bytes "
                  f"{w}, planned {want_wire}")
    # (b) the prefill and decode against one process
    sb, ss = TP_HEADS_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    inputs = serve_inputs(cfg, sb, ss, dev)
    toks = inputs["tokens"]
    with torch.inference_mode():
        want = forward(params, inputs, cfg)
        pre = [compare(r["prefill"].to(dev), want[..., slice(*v.vocab)])
               for r, v in zip(ranks, views)]
        del want, inputs
        state = init_decode_state(cfg, sb, TP_HEADS_RING, device=dev)
        outs = []
        for t in range(TP_HEADS_DECODE):
            lg, state = decode_step(params, state, toks[:, t:t + 1], cfg)
            outs.append(lg)
        want = torch.cat(outs, dim=1)
        dec = [compare(r["decode"].to(dev), want[..., slice(*v.vocab)])
               for r, v in zip(ranks, views)]
    del params, state, outs, toks, want
    gc.collect()
    torch.cuda.empty_cache()
    state_plan = dryrun.memory_plan(
        cfg, ShapeConfig(name, TP_HEADS_RING, sb, "decode"), mesh,
        AdamWConfig())["decode_state"]
    wire = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, ss if kind == "prefill" else TP_HEADS_RING,
                         sb, kind), mesh, split_model=True)
        for kind in ("prefill", "decode")}
    names = ("rel_rms", "max_abs", "top1_agreement")
    serve = {"phase": name, "run": "serve", "arch": cfg.name,
             "tie_embeddings": cfg.tie_embeddings, "layers": cfg.n_layers, "dtype": cfg.dtype, "mesh": mesh.shape,
             "backend": "gloo", "batch": sb, "seq": ss,
             "window": cfg.window, "decode_steps": TP_HEADS_DECODE,
             "max_len": TP_HEADS_RING,
             "length_axes": list(shd.length_axes(cfg, mesh, sb)),
             "prefill_vs_one_process_by_rank": [dict(zip(names, x))
                                                for x in pre],
             "decode_vs_one_process_by_rank": [dict(zip(names, x))
                                               for x in dec],
             "tolerance": DECODE_TOL,
             "flash_launches_by_rank": [r["flash_launches"] for r in ranks],
             "flash_routes_by_rank": [r["flash_routes"] for r in ranks],
             "prefill_ms_by_rank": [r["prefill_ms"] for r in ranks],
             "prefill_timed": "its first call",
             "prefill_tokens_per_s": sb * ss / (max(
                 r["prefill_ms"] for r in ranks) / 1e3),
             "decode_ms_a_step_by_rank": [r["decode_ms_a_step"]
                                          for r in ranks],
             "prefill_staged_bytes_by_rank": [r["prefill_staged_bytes"]
                                              for r in ranks],
             "decode_staged_bytes_a_step_by_rank": [
                 r["decode_staged_bytes_a_step"] for r in ranks],
             "state_bytes_by_rank": [r["state_bytes"] for r in ranks],
             "planned_state_bytes": state_plan["alloc"],
             "prefill_wire_rank0": ranks[0]["prefill_wire"],
             "decode_wire_a_step_rank0": ranks[0]["decode_wires"][0],
             "planned_wire": wire, "card": card}
    emit(serve)
    for r, p_, d_ in zip(ranks, pre, dec):
        c = r["coords"]
        check(p_[0] <= DECODE_TOL, f"{name}: rank {c} prefill logits "
              f"{p_[0]} (relative RMS) from one process > {DECODE_TOL}")
        check(d_[0] <= DECODE_TOL, f"{name}: rank {c} decode logits "
              f"{d_[0]} (relative RMS) from one process > {DECODE_TOL}")
        check(r["state_bytes"] == state_plan["alloc"], f"{name}: rank {c} "
              f"decode state {r['state_bytes']} bytes, the plan "
              f"{state_plan['alloc']}")
        check(r["flash_launches"] == n_attn
              and r["flash_routes"].get("tc_bf16") == n_attn,
              f"{name}: rank {c} flash launches {r['flash_launches']}, "
              f"routes {r['flash_routes']}, expected {n_attn} on tc_bf16")
        for kind, ws in (("prefill", [r["prefill_wire"]]),
                         ("decode", r["decode_wires"])):
            for w in ws:
                check(all(w[a][k] == wire[kind][a][k] for a in wire[kind]
                          for k in wire[kind][a]), f"{name}: {kind} wire "
                      f"bytes {w}, planned {wire[kind]}")
    check(tp == 4 and [v.heads for v in views] == [(0, 3), (3, 6), (6, 8),
                                                   (8, 10)],
          f"{name}: heads by rank {[v.heads for v in views]}")
    return {f"{name}:train": (cfg, train_shape, statistics.median(
        ms for r in ranks for ms in r["step_ms"]) / 1e3, True, mesh, True)}


def tp_serve_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(TP_SERVE_ARCH),
                               n_layers=TP_SERVE_LAYERS)


def tp_serve_rank(rank, world, dev):
    """One rank of tp_serve: its blocks, the prefill of its batch shard
    (this rank's vocabulary rows of the logits, on the host) with the flash
    launches it made, then TP_DECODE_STEPS decode steps."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_decode_state, init_params
    from repro_torch.train.step import (make_sharded_serve_step,
                                        sharded_decode_state)
    cfg = tp_serve_cfg()
    mesh = make_mesh(TP_SERVE_MESH, device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    full = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    params = shd.shard_tree(full, shd.param_specs(full, cfg, shape), shape,
                            mesh.coords)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    toks = make_lm_batch(cfg, 0, 0, TP_SERVE_BATCH, TP_SERVE_SEQ,
                         device=dev)["tokens"]
    local = shd.shard_tree({"tokens": toks}, {"tokens": shd.batch_specs(
        cfg, shape, TP_SERVE_BATCH)["tokens"]}, shape, mesh.coords)
    prefill, decode = make_sharded_serve_step(cfg, mesh, TP_SERVE_BATCH)
    prefill(params, local)                         # warm: cuBLAS plans
    torch.cuda.synchronize(dev)
    wire0, staged = mesh.wire_bytes(), mesh.host_staged_bytes
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, local)
    torch.cuda.synchronize(dev)
    out = {"coords": mesh.coords, "prefill_ms": (time.perf_counter() - t0)
           * 1e3, "flash_launches": ops.LAUNCHES["flash_attention"],
           "flash_routes": dict(ROUTE_LAUNCHES),
           "prefill_staged_bytes": mesh.host_staged_bytes - staged,
           "prefill_wire": {a: {k: v - wire0[a][k] for k, v in w.items()}
                            for a, w in mesh.wire_bytes().items()},
           "prefill": logits.cpu()}
    del logits
    b_loc = local["tokens"].shape[0]
    state = init_decode_state(cfg, b_loc, TP_SERVE_SEQ, device=dev,
                              model=mesh.axis("model"))
    steps = []
    staged = mesh.host_staged_bytes
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(TP_DECODE_STEPS):
        lg, state = decode(params, state, local["tokens"][:, t:t + 1])
        steps.append(lg)
    torch.cuda.synchronize(dev)
    out.update(decode_ms_a_step=(time.perf_counter() - t0) * 1e3
               / TP_DECODE_STEPS,
               decode_staged_bytes_a_step=(mesh.host_staged_bytes - staged)
               / TP_DECODE_STEPS,
               decode=torch.cat(steps, dim=1).cpu())
    # the int8 KV cache under the same split: TP_INT8_STEPS steps from a
    # fresh state, against the bf16 split's first steps
    del state, steps
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    _, decode_q = make_sharded_serve_step(cfg_q, mesh, TP_SERVE_BATCH)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    state = sharded_decode_state(cfg_q, mesh, TP_SERVE_BATCH, TP_SERVE_SEQ)
    torch.cuda.synchronize(dev)
    out["int8_state_bytes"] = torch.cuda.memory_allocated(dev) - base
    steps = []
    t0 = time.perf_counter()
    for t in range(TP_INT8_STEPS):
        lg, state = decode_q(params, state, local["tokens"][:, t:t + 1])
        steps.append(lg)
    torch.cuda.synchronize(dev)
    out.update(int8_decode_ms_a_step=(time.perf_counter() - t0) * 1e3
               / TP_INT8_STEPS, decode_int8=torch.cat(steps, dim=1).cpu())
    del params, state, steps, lg
    gc.collect()
    torch.cuda.empty_cache()
    out["recurrent"] = tp_recurrent_serve_rank(mesh, dev)
    out["frontends"] = tp_recurrent_serve_rank(mesh, dev, TP_FRONT_SERVE)
    return out


def serve_inputs(cfg, b: int, s: int, dev) -> dict:
    """make_lm_batch's model inputs from seed 0: the tokens, and the VLM's
    patch embeddings."""
    from repro_torch.data.pipeline import make_lm_batch
    batch = make_lm_batch(cfg, 0, 0, b, s, device=dev)
    return {k: v for k, v in batch.items() if k != "labels"}


def tp_recurrent_serve_rank(mesh, dev, runs=TP_REC_SERVE) -> dict:
    """tp_recurrent_serve's part of a tp_serve rank, and
    tp_frontends_serve's (``runs`` TP_FRONT_SERVE): for each run, its
    blocks from seed 0 (an f32 run after a bf16 one of the same model:
    those blocks in f32), a prefill of its shard of the inputs, timed from
    its first call (the logits on the host, the flash launches and routes,
    the wire and staged bytes), the decode state's bytes
    (``sharded_decode_state``), then the teacher-forced decode steps
    (their logits and wire bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params, tree_map
    from repro_torch.train.step import (make_sharded_serve_step,
                                        sharded_decode_state)
    shape = shd.MeshShape.from_mesh(mesh)
    res, bf16 = {}, {}
    for name, arch, layers, b, s, steps, max_len, dtype, *_ in runs:
        cfg = tp_rec_cfg(arch, layers, dtype)
        if arch in bf16:            # the bf16 run's weights, in f32
            params = tree_map(lambda leaf: leaf.float(), bf16.pop(arch))
        else:
            full = init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
            params = shd.shard_tree(full, shd.param_specs(full, cfg, shape),
                                    shape, mesh.coords)
            del full
            if dtype == "bfloat16":
                bf16[arch] = params
        gc.collect()
        torch.cuda.empty_cache()
        inputs = serve_inputs(cfg, b, s, dev)
        specs = shd.batch_specs(cfg, shape, b)
        local = shd.shard_tree(inputs, {k: specs[k] for k in inputs}, shape,
                               mesh.coords)
        prefill, decode = make_sharded_serve_step(cfg, mesh, b)
        torch.cuda.synchronize(dev)     # no warm call: the first is timed
        wire0, staged = mesh.wire_bytes(), mesh.host_staged_bytes
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, local)
        torch.cuda.synchronize(dev)
        out = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "flash_launches": ops.LAUNCHES["flash_attention"],
               "flash_routes": dict(ROUTE_LAUNCHES),
               "prefill_staged_bytes": mesh.host_staged_bytes - staged,
               "prefill_wire": {a: {k: v - wire0[a][k] for k, v in w.items()}
                                for a, w in mesh.wire_bytes().items()},
               "prefill": logits.cpu()}
        del logits
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        state = sharded_decode_state(cfg, mesh, b, max_len)
        torch.cuda.synchronize(dev)
        out["state_bytes"] = torch.cuda.memory_allocated(dev) - base
        decoded, wires = [], []
        staged = mesh.host_staged_bytes
        t0 = time.perf_counter()
        for t in range(steps):
            wire0 = mesh.wire_bytes()
            lg, state = decode(params, state, local["tokens"][:, t:t + 1])
            wire1 = mesh.wire_bytes()
            wires.append({a: {k: v - wire0[a][k] for k, v in w.items()}
                          for a, w in wire1.items()})
            decoded.append(lg)
        torch.cuda.synchronize(dev)
        out.update(decode_ms_a_step=(time.perf_counter() - t0) * 1e3 / steps,
                   decode_staged_bytes_a_step=(mesh.host_staged_bytes
                                               - staged) / steps,
                   decode_wires=wires,
                   decode=torch.cat(decoded, dim=1).cpu())
        res[name] = out
        del params, state, decoded, lg
        gc.collect()
        torch.cuda.empty_cache()
    return res


def tp_serve_phase(dev, rows: dict, record, card: str) -> None:
    """tp_serve: TP_SERVE_ARCH at full width cut to TP_SERVE_LAYERS
    layers, ``make_sharded_serve_step`` on 2 gloo ranks sharing the card
    (a model axis of 2): the prefill through row 9 on each rank's 14 query
    / 2 kv heads, then teacher-forced decode, against one process at
    LOGITS_TOL. Row 9 is timed and held to its plain version at the
    shard's shape first (row ``flash_attention_tp_shard``), and takes the
    ranks' prefill launches. Then TP_INT8_STEPS decode steps with the int8
    KV cache under the same split, within KV_QUANT_TOL of the bf16 split's
    first steps, its decode state's bytes the dry run's plan."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state,
                                                init_params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = tp_serve_cfg()
    tp = dict(TP_SERVE_MESH)["model"]
    hq, hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    b, s, hd = TP_SERVE_BATCH, TP_SERVE_SEQ, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(26)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((b, hq, s, hd), (b, hkv, s, hd),
                                      (b, hkv, s, hd)))
    record("flash_attention_tp_shard", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True),
           lambda: attn_plain(q, k, v, causal=True),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * b * hq * hd * s * (s + 1) / 2, ATTN_BF16_TOL,
           ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
           judge=attn_judge(torch.bfloat16))
    rows["flash_attention_tp_shard"].update(
        kernel="flash_attention_wgmma_kernel",
        library="scaled_dot_product_attention, causal, GQA",
        shape=[list(q.shape), list(k.shape)])
    del q, k, v
    # row 9 at recurrentgemma-2b's shard: 5 of 10 query heads against the
    # one kv head each rank gathers, window 2048; SDPA takes the band as a
    # mask (no window argument)
    rg = tp_rec_cfg(*TP_REC_SERVE[0][1:3])
    rb, rs = TP_REC_SERVE[0][3:5]
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((rb, rg.n_heads // tp, rs, rg.hd),
                                      (rb, 1, rs, rg.hd), (rb, 1, rs, rg.hd)))
    pos = torch.arange(rs, device=dev)
    band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None]
                                          - rg.window)
    pairs = int(band.sum())
    record("flash_attention_tp_window", FLASH_SOURCE, FLASH_REPLACES,
           lambda: ops.flash_attention(q, k, v, causal=True,
                                       window=rg.window),
           lambda: attn_plain(q, k, v, causal=True, window=rg.window),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, attn_mask=band, enable_gqa=True),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           4.0 * rb * q.shape[1] * rg.hd * pairs, ATTN_BF16_TOL,
           ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
           judge=attn_judge(torch.bfloat16))
    rows["flash_attention_tp_window"].update(
        kernel="flash_attention_wgmma_kernel<256>", visible_pairs=pairs,
        library="scaled_dot_product_attention, GQA, explicit band mask",
        shape=[list(q.shape), list(k.shape), rg.window])
    del q, k, v, band
    # row 9 at the frontends' shards (tp_frontends_serve): paligemma-3b's 4
    # of 8 query heads against its one gathered kv head at hd 256, and
    # musicgen-medium's 12 of 24 heads at hd 64, both causal
    for run in TP_FRONT_SERVE:
        fc = tp_rec_cfg(*run[1:3])
        fb, fs, row = run[3], run[4], run[8]
        hkv_f = fc.n_kv_heads // tp if fc.n_kv_heads % tp == 0 else 1
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((fb, fc.n_heads // tp, fs, fc.hd),
                                          (fb, hkv_f, fs, fc.hd),
                                          (fb, hkv_f, fs, fc.hd)))
        record(row, FLASH_SOURCE, FLASH_REPLACES,
               lambda: ops.flash_attention(q, k, v, causal=True),
               lambda: attn_plain(q, k, v, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True),
               2 * (2 * q.numel() + k.numel() + v.numel()),
               4.0 * fb * q.shape[1] * fc.hd * fs * (fs + 1) / 2,
               ATTN_BF16_TOL, ATTN_BF16_NOTE, flop_rate=BF16_TC_FLOP_PER_S,
               judge=attn_judge(torch.bfloat16))
        rows[row].update(
            kernel=("flash_attention_wgmma_kernel<256>" if fc.hd == 256
                    else "flash_attention_wgmma_kernel"),
            library="scaled_dot_product_attention, causal, GQA",
            shape=[list(q.shape), list(k.shape)])
        del q, k, v
    t0 = time.perf_counter()
    with expandable_segments():     # the decode states' bytes, as planned
        ranks = spawn_ranks(tp_serve_rank, tp, backend="gloo",
                            device="cuda")
    spawn_s = time.perf_counter() - t0
    ranks.sort(key=lambda r: r["coords"]["model"])
    launches = sum(r["flash_launches"] for r in ranks)
    rows["flash_attention_tp_shard"]["launches"] += launches
    rows["flash_attention_tp_shard"].setdefault("launches_by_phase", {})[
        f"tp_serve:{cfg.name}"] = launches
    # one process on the same weights and tokens
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    toks = make_lm_batch(cfg, 0, 0, b, s, device=dev)["tokens"]
    with torch.inference_mode():
        want = forward(params, {"tokens": toks}, cfg)
        got = torch.cat([r["prefill"].to(dev) for r in ranks], dim=-1)
        pre = compare(got, want)
        del got, want
        state = init_decode_state(cfg, b, s, device=dev)
        steps = []
        for t in range(TP_DECODE_STEPS):
            lg, state = decode_step(params, state, toks[:, t:t + 1], cfg)
            steps.append(lg)
        want = torch.cat(steps, dim=1)
        got = torch.cat([r["decode"].to(dev) for r in ranks], dim=-1)
        dec = compare(got, want)
    del params, state, steps, want, got
    gc.collect()
    torch.cuda.empty_cache()
    mesh = shd.MeshShape.of(*TP_SERVE_MESH)
    want_wire = roofline.step_wire_bytes(
        cfg, ShapeConfig("tp_serve", s, b, "prefill"), mesh,
        split_model=True)
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    int8_plan = dryrun.memory_plan(
        cfg_q, ShapeConfig("tp_serve", s, b, "decode"), mesh,
        AdamWConfig())["decode_state"]
    int8 = compare(
        torch.cat([r["decode_int8"] for r in ranks], dim=-1),
        torch.cat([r["decode"][:, :TP_INT8_STEPS] for r in ranks], dim=-1))
    line = {"phase": "tp_serve", "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": mesh.shape, "backend": "gloo", "batch": b, "seq": s,
            "heads_a_rank": [hq, hkv], "decode_steps": TP_DECODE_STEPS,
            "prefill_vs_one_process": dict(zip(
                ("rel_rms", "max_abs", "top1_agreement"), pre)),
            "decode_vs_one_process": dict(zip(
                ("rel_rms", "max_abs", "top1_agreement"), dec)),
            "tolerance": LOGITS_TOL,
            "flash_launches_by_rank": [r["flash_launches"] for r in ranks],
            "flash_routes_by_rank": [r["flash_routes"] for r in ranks],
            "prefill_ms_by_rank": [r["prefill_ms"] for r in ranks],
            "prefill_tokens_per_s": b * s / (max(
                r["prefill_ms"] for r in ranks) / 1e3),
            "decode_ms_a_step_by_rank": [r["decode_ms_a_step"]
                                         for r in ranks],
            "prefill_staged_bytes_by_rank": [r["prefill_staged_bytes"]
                                             for r in ranks],
            "decode_staged_bytes_a_step_by_rank": [
                r["decode_staged_bytes_a_step"] for r in ranks],
            "prefill_wire_rank0": ranks[0]["prefill_wire"],
            "planned_prefill_wire": want_wire,
            "int8_kv_cache": {
                "steps": TP_INT8_STEPS,
                "vs_bf16_split": dict(zip(
                    ("rel_rms", "max_abs", "top1_agreement"), int8)),
                "tolerance": KV_QUANT_TOL,
                "ms_a_step_by_rank": [r["int8_decode_ms_a_step"]
                                      for r in ranks],
                "state_bytes_by_rank": [r["int8_state_bytes"]
                                        for r in ranks],
                "planned_state_bytes": int8_plan["alloc"]},
            "spawn_and_run_s": spawn_s, "card": card}
    emit(line)
    check(int8[0] <= KV_QUANT_TOL, f"tp_serve: the int8 KV cache's logits "
          f"{int8[0]} (relative RMS) from the bf16 split's > {KV_QUANT_TOL}")
    for r in ranks:
        check(r["int8_state_bytes"] == int8_plan["alloc"], f"tp_serve: "
              f"rank {r['coords']} int8 decode state {r['int8_state_bytes']} "
              f"bytes, the plan {int8_plan['alloc']}")
    check(pre[0] <= LOGITS_TOL, f"tp_serve: prefill logits {pre[0]} "
          f"(relative RMS) from one process > {LOGITS_TOL}")
    check(dec[0] <= LOGITS_TOL, f"tp_serve: decode logits {dec[0]} "
          f"(relative RMS) from one process > {LOGITS_TOL}")
    for r in ranks:
        check(r["flash_launches"] == cfg.n_layers
              and r["flash_routes"].get("tc_bf16") == cfg.n_layers,
              f"tp_serve: rank {r['coords']} flash launches "
              f"{r['flash_launches']}, routes {r['flash_routes']}, expected "
              f"{cfg.n_layers} on tc_bf16")
        check(all(r["prefill_wire"][a][k] == want_wire[a][k]
                  for a in want_wire for k in want_wire[a]),
              f"tp_serve: prefill wire bytes {r['prefill_wire']}, planned "
              f"{want_wire}")
    tp_recurrent_serve_phase(dev, rows, card, ranks)
    tp_recurrent_serve_phase(dev, rows, card, ranks, "tp_frontends_serve",
                             TP_FRONT_SERVE, "frontends")


def tp_recurrent_serve_phase(dev, rows: dict, card: str, ranks,
                             phase: str = "tp_recurrent_serve",
                             runs=TP_REC_SERVE, key: str = "recurrent"
                             ) -> None:
    """tp_recurrent_serve: each TP_REC_SERVE run through
    ``make_sharded_serve_step`` on tp_serve's model axis of 2, by its
    ranks after qwen2-7b (``tp_recurrent_serve_rank``): the prefill and
    the teacher-forced decode against one process, f32 at LOGITS_TOL and
    bf16 at DECODE_TOL (TP_REC_SERVE's comment), the decode state's bytes
    equal to the dry run's plan, the wire bytes of the prefill and of each
    decode step equal to the plan; recurrentgemma's 4 windowed layers
    through row 9 on the tensor cores in bf16 (4 launches a rank, taken by
    the row ``flash_attention_tp_window``), on the CUDA cores in f32. The
    f32 recurrentgemma line carries ``chaos_gain``. A line a run.
    tp_frontends_serve is the same for ``runs`` TP_FRONT_SERVE (the ranks'
    results under ``key``), bf16 held at LOGITS_TOL, each run's row 9
    launches taken by its own row (TP_FRONT_SERVE's last entry)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state,
                                                init_params, tree_map)
    from repro_torch.optim.adamw import AdamWConfig
    mesh = shd.MeshShape.of(*TP_SERVE_MESH)
    bf16 = {}
    for name, arch, layers, b, s, steps, max_len, dtype, *row in runs:
        cfg = tp_rec_cfg(arch, layers, dtype)
        got = [r[key][name] for r in ranks]
        route = "tc_bf16" if dtype == "bfloat16" else "simt_f32"
        tol = DECODE_TOL if dtype == "bfloat16" and not row else LOGITS_TOL
        row = row[0] if row else "flash_attention_tp_window"
        n_attn = sum(k in ("attn", "swa") for k in cfg.pattern_for_layers()
                     ) * cfg.n_groups
        if n_attn and route == "tc_bf16":
            launches = sum(r["flash_launches"] for r in got)
            rows[row]["launches"] += launches
            rows[row].setdefault("launches_by_phase", {})[
                f"{phase}:{name}"] = launches
        gc.collect()
        torch.cuda.empty_cache()
        if arch in bf16:            # the bf16 run's weights, in f32
            params = tree_map(lambda leaf: leaf.float(), bf16.pop(arch))
        else:
            params = init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
            if dtype == "bfloat16":
                bf16[arch] = params
        inputs = serve_inputs(cfg, b, s, dev)
        toks = inputs["tokens"]
        with torch.inference_mode():
            want = forward(params, inputs, cfg)
            pre = compare(torch.cat([r["prefill"].to(dev).flatten(2)
                                     for r in got], dim=-1).reshape(
                                         want.shape), want)
            del want, inputs
            state = init_decode_state(cfg, b, max_len, device=dev)
            outs = []
            for t in range(steps):
                lg, state = decode_step(params, state, toks[:, t:t + 1], cfg)
                outs.append(lg)
            want = torch.cat(outs, dim=1)
            dec = compare(torch.cat([r["decode"].to(dev).flatten(2)
                                     for r in got], dim=-1).reshape(
                                         want.shape), want)
            del want
            gain = (chaos_gain(params, cfg, toks[:, :LM_TF_TOKENS])
                    if arch == "recurrentgemma-2b" and n_attn
                    and route == "simt_f32" else None)
        del params, state, outs, toks
        gc.collect()
        torch.cuda.empty_cache()
        plan = dryrun.memory_plan(
            cfg, ShapeConfig(phase, max_len, b, "decode"),
            mesh, AdamWConfig())["decode_state"]
        wire = {kind: roofline.step_wire_bytes(
            cfg, ShapeConfig(kind, s, b, kind), mesh, split_model=True)
            for kind in ("prefill", "decode")}
        line = {"phase": phase, "run": name,
                "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
                "mesh": mesh.shape, "backend": "gloo", "batch": b, "seq": s,
                "decode_steps": steps, "max_len": max_len,
                "prefill_vs_one_process": dict(zip(
                    ("rel_rms", "max_abs", "top1_agreement"), pre)),
                "decode_vs_one_process": dict(zip(
                    ("rel_rms", "max_abs", "top1_agreement"), dec)),
                "tolerance": tol, "chaos_gain": gain,
                "flash_launches_by_rank": [r["flash_launches"] for r in got],
                "flash_routes_by_rank": [r["flash_routes"] for r in got],
                "prefill_ms_by_rank": [r["prefill_ms"] for r in got],
                "prefill_timed": "its first call",
                "prefill_tokens_per_s": b * s / (max(
                    r["prefill_ms"] for r in got) / 1e3),
                "decode_ms_a_step_by_rank": [r["decode_ms_a_step"]
                                             for r in got],
                "prefill_staged_bytes_by_rank": [r["prefill_staged_bytes"]
                                                 for r in got],
                "decode_staged_bytes_a_step_by_rank": [
                    r["decode_staged_bytes_a_step"] for r in got],
                "state_bytes_by_rank": [r["state_bytes"] for r in got],
                "planned_state_bytes": plan["alloc"],
                "prefill_wire_rank0": got[0]["prefill_wire"],
                "decode_wire_a_step_rank0": got[0]["decode_wires"][0],
                "planned_wire": wire, "card": card}
        emit(line)
        check(pre[0] <= tol, f"{phase} {name}: prefill logits "
              f"{pre[0]} (relative RMS) from one process > {tol}")
        check(dec[0] <= tol, f"{phase} {name}: decode logits "
              f"{dec[0]} (relative RMS) from one process > {tol}")
        for r in got:
            check(r["state_bytes"] == plan["alloc"], f"{phase} "
                  f"{name}: decode state {r['state_bytes']} bytes, the plan "
                  f"{plan['alloc']}")
            check(r["flash_launches"] == n_attn
                  and r["flash_routes"].get(route, 0) == n_attn,
                  f"{phase} {name}: flash launches "
                  f"{r['flash_launches']}, routes {r['flash_routes']}, "
                  f"expected {n_attn} on {route}")
            for kind, ws in (("prefill", [r["prefill_wire"]]),
                             ("decode", r["decode_wires"])):
                for w in ws:
                    check(all(w[a][k] == wire[kind][a][k]
                              for a in wire[kind] for k in wire[kind][a]),
                          f"{phase} {name}: {kind} wire bytes "
                          f"{w}, planned {wire[kind]}")


def train_psa_moe_phase(dev, rows: dict, record, gram_qr_work,
                        card: str) -> dict:
    """train_psa_moe: phi3.5-moe at full width, PSA_MOE_LAYERS layer, on 2
    pod ranks sharing the card (``train_psa_rank``): PSA steps with a
    refresh at steps 0 and 3, its Grams on row 4 at the expert stacks'
    (1, 4096, 64) and (1, 6400, 64) and the head's (4096, 64). Checks what
    train_psa checks but the plain two steps: finite losses, equal on both
    pods, the first within TRAIN_LOSS_TOL of one rank's whole-batch step,
    projectors orthonormal within ORTHO_TOL, three Gram launches a
    compressed leaf an OI iteration, staged bytes twice those reduced.
    The one rank routes its MoE per pod shard, as the pods do."""
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.psa_compress import CQR_PASSES
    from repro_torch.train.step import loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    arch = "phi3.5-moe-42b-a6.6b"
    cfg, opt, psa = train_psa_setup(PSA_MOE_LAYERS, arch)
    t0 = time.perf_counter()
    pods = spawn_ranks(train_psa_rank, 2, backend="gloo", device="cuda",
                       args=(PSA_MOE_LAYERS, PSA_MOE_STEPS, PSA_MOE_BATCH,
                             PSA_MOE_SEQ, arch))
    wall = time.perf_counter() - t0
    # one rank's loss on the whole batch, its MoE routing each pod's shard
    # on its own as the reference's does over a mesh of 2 pods
    one = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    with torch.no_grad():
        one_loss = float(loss_fn(
            one, make_lm_batch(cfg, 0, 0, PSA_MOE_BATCH, PSA_MOE_SEQ,
                               device=dev), cfg,
            act_specs={"moe": {"dp": None, "e": None, "n_dp": 2}}))
    del one
    gc.collect()
    torch.cuda.empty_cache()
    by_shape = {}
    for o in pods:
        for rf in o["refreshes"]:
            for k, n in rf["by_shape"].items():
                by_shape[k] = by_shape.get(k, 0) + n
    step_ms = statistics.median(ms for o in pods for ms in o["step_ms"][1:])
    line = {"phase": "train_psa_moe", "arch": cfg.name,
            "layers": cfg.n_layers, "experts": cfg.moe.n_experts,
            "d_model": cfg.d_model, "d_expert": cfg.moe.d_expert,
            "dtype": cfg.dtype, "moment_dtype": opt.moment_dtype, "pods": 2,
            "psa": dataclasses.asdict(psa),
            "tokens_a_pod_a_step": PSA_MOE_BATCH // 2 * PSA_MOE_SEQ,
            "losses": pods[0]["losses"], "grad_norms": pods[0]["grad_norms"],
            "one_rank_first_loss": one_loss,
            "step_ms_by_rank": [o["step_ms"] for o in pods],
            "step_ms_median_after_first": step_ms,
            "tokens_per_s": PSA_MOE_BATCH * PSA_MOE_SEQ / (step_ms / 1e3),
            "refreshes": pods[0]["refreshes"],
            "gram_qr_launches_by_shape": by_shape,
            "compressed_leaves": pods[0]["compressed_leaves"],
            "allreduced_bytes_a_step": pods[0]["reduced_bytes"],
            "dense_gradient_bytes_a_step": pods[0]["dense_bytes"],
            "compression_ratio_analytic": pods[0]["ratio"],
            "host_staged_bytes_a_step": pods[0]["staged_per_step"],
            "max_memory_allocated_by_rank": [o["max_memory_allocated"]
                                             for o in pods],
            "step_parts_ms_by_rank": [o["step_parts_ms"] for o in pods],
            "spawn_and_run_s": wall, "card": card}
    emit(line)
    for o in pods:
        check(all(np.isfinite(o["losses"])) and o["losses"]
              == pods[0]["losses"], f"train_psa_moe: losses {o['losses']}")
        for rf in o["refreshes"]:
            check(rf["ortho_err"] <= ORTHO_TOL, f"train_psa_moe: projector "
                  f"|P^T P - I| {rf['ortho_err']} at step {rf['step']}")
            check(rf["gram_qr"] == CQR_PASSES * psa.oi_iters
                  * o["compressed_leaves"], f"train_psa_moe: "
                  f"{rf['gram_qr']} Gram launches a refresh")
        check(all(b == 2 * o["reduced_bytes"]
                  for b in o["staged_per_step"]), "train_psa_moe: staged "
              f"bytes {o['staged_per_step']} != 2 x {o['reduced_bytes']}")
    check(abs(pods[0]["losses"][0] - one_loss) <= TRAIN_LOSS_TOL
          * abs(one_loss), f"train_psa_moe: first pod-mean loss "
          f"{pods[0]['losses'][0]} against one rank's {one_loss}")
    # row 4 at the refresh's shapes, f32: the expert stacks' and the head's
    gen = torch.Generator(device=dev).manual_seed(25)
    shapes = (("a4096", (1, cfg.d_model, psa.rank)),
              ("a6400", (1, cfg.moe.d_expert, psa.rank)),
              ("head", (cfg.d_model, psa.rank)))
    for label, shape in shapes:
        vq = torch.randn(shape, generator=gen, device=dev)
        q_bytes, q_flops, _ = gram_qr_work(vq.reshape(-1, *shape[-2:]))
        name = f"gram_qr_psa_moe_{label}"
        record(name, "src/repro_torch/kernels/csrc/gram_qr.cu",
               "src/repro/kernels/gram_qr.py:40",
               lambda: ops.gram_qr(vq), lambda: ref.gram_qr_ref(vq),
               lambda: torch.matmul(vq.mT, vq), q_bytes, q_flops,
               GRAM_QR_TOL, "f32 sums in another order than cuBLAS; "
               "relative to max |G|")
        rows[name]["launches"] = by_shape.get(str(list(shape)), 0)
        rows[name]["shape"] = list(shape)
        rows[name]["kernel_route"] = gram_qr_route(shape)
        del vq
    check(sum(rows[f"gram_qr_psa_moe_{k}"]["launches"] for k, _ in shapes)
          == sum(rf["gram_qr"] for o in pods for rf in o["refreshes"]),
          f"train_psa_moe: Gram launches by shape {by_shape}")
    check_refresh_routes("train_psa_moe", pods)
    line["_step_s"] = step_ms / 1e3
    return line


def roofline_phase(measured: dict, card: str) -> None:
    """roofline: ``launch/roofline.run_cell``'s terms on one card (a 1 x 1
    mesh) beside the measured step of each cell measured above, a train
    step's at the remat it ran, a split step's per rank of its mesh
    (``measured``: (cfg, shape, seconds[, remat[, mesh, split]]))."""
    from repro_torch.launch import roofline
    from repro_torch.models.sharding import MeshShape
    one = MeshShape.of(("data", 1), ("model", 1))
    cells = []
    for name, (cfg, shape, seconds, *rest) in measured.items():
        remat = rest[0] if rest else True
        mesh, split = rest[1:] if len(rest) > 1 else (one, False)
        res = roofline.run_cell(cfg.name, shape, mesh=mesh, cfg=cfg,
                                measured_s=seconds, remat=remat,
                                split_model=split)
        cells.append({"cell": name, "layers": cfg.n_layers, "remat": remat,
                      "mesh": mesh.shape, "split_model": split,
                      "batch": shape.global_batch, "seq": shape.seq_len,
                      "kind": shape.kind, "measured_s": seconds,
                      "flops": res["flops_per_dev"],
                      "hbm_bytes": res["bytes_per_dev"],
                      **res["roofline"],
                      "bound_share_of_measured":
                          res["bound_share_of_measured"],
                      "mfu_at_bound": res["mfu_at_bound"]})
    emit({"phase": "roofline", "hw": {
        "name": roofline.HW.NAME, "peak_flops_bf16": roofline.HW.PEAK_FLOPS_BF16,
        "hbm_bw": roofline.HW.HBM_BW, "hbm_bytes": roofline.HW.HBM_BYTES,
        "link_bw": roofline.HW.LINK_BW,
        "device_total_memory": torch.cuda.get_device_properties(
            0).total_memory}, "cells": cells, "card": card})
    check(len(cells) == len(measured) and all(
        c["bound_s"] > 0 for c in cells), "roofline: cells")


def train_family_phases(dev, rows: dict, record, gram_qr_work,
                        measured: dict) -> None:
    """train_families, train_psa_moe, moe_shards, sharded_step, tp_step,
    tp_recurrent, tp_frontends, tp_long_decode, tp_heads, tp_tied, remat,
    tp_serve
    (with tp_recurrent_serve and tp_frontends_serve) and roofline (module
    docstring), each with the card's
    name and power limit; ``measured`` holds the earlier phases' (cfg,
    shape, seconds) and gains each new train step's."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    card = nvidia_smi()
    for arch, layers, lm_b, lm_s, remat in TRAIN_FAMILIES:
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        line = train_family(cfg, lm_b, lm_s, dev, card, remat)
        measured[f"train_families:{arch}"] = (
            cfg, ShapeConfig(f"train_{arch}", lm_s, lm_b, "train"),
            line["ms_per_step"] / 1e3, remat)
    psa_line = train_psa_moe_phase(dev, rows, record, gram_qr_work, card)
    cfg_psa = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"),
                                  n_layers=PSA_MOE_LAYERS)
    measured["train_psa_moe:pod"] = (
        cfg_psa, ShapeConfig("train_psa_moe_pod", PSA_MOE_SEQ,
                             PSA_MOE_BATCH // 2, "train"),
        psa_line["_step_s"])
    moe_shards_phase(dev, rows, card)
    sh = sharded_step_phase(dev, card)
    cfg_sh, _ = sharded_cfg()
    measured["sharded_step:rank"] = (
        cfg_sh, ShapeConfig("sharded_step_rank", SHARDED_SEQ,
                            SHARDED_BATCH // 2, "train"), sh["_step_s"])
    tp_step_phase(dev, card, sh)
    measured.update(tp_recurrent_phase(dev, card, sh))
    measured.update(tp_recurrent_phase(dev, card, sh, "tp_frontends",
                                       TP_FRONT_TRAIN, "_frontends_ranks"))
    tp_long_decode_phase(dev, card, sh)
    measured.update(tp_heads_phase(dev, rows, record, card, sh))
    measured.update(tp_heads_phase(dev, rows, record, card, sh, "tp_tied"))
    remat_phase(dev, card)
    tp_serve_phase(dev, rows, record, card)
    roofline_phase(measured, card)



def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import baselines, runtime, sweep, topology
    from repro_torch.core.async_gossip import (AsyncConsensus,
                                               masked_async_rounds,
                                               straggler_wall_clock)
    from repro_torch.core.bdot import bdot, bdot_program, pad_grid_blocks
    from repro_torch.core.consensus import (DenseConsensus, SparseConsensus,
                                            consensus_schedule)
    from repro_torch.core.fdot import (QR_PASSES, fdot, fdot_program,
                                       pad_feature_slabs)
    from repro_torch.core.linalg import cholesky_qr2, orthonormal_init
    from repro_torch.core.metrics import CommLedger, subspace_error
    from repro_torch.core.netfaults import (FaultyConsensus, NetFaultModel,
                                            slots_to_dense)
    from repro_torch.core.sdot import _stack_data, sadot, sdot, sdot_program
    from repro_torch.core.sparse import SparseW
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.kernels import (_build, _launch, gram_qr, gram_update,
                                     ops, ref, slab_ops)
    from repro_torch.kernels import ell_spmm as ell_module
    from repro_torch.kernels.flash_attention import (ROUTE_LAUNCHES,
                                                     tc_smem_bytes)
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_decode_state,
                                                init_params, tree_leaves)
    from repro_torch.streaming.chaos import smoke_plan
    from repro_torch.streaming.fleet import LeaseStore
    from repro_torch.streaming.launcher import (build_engine, build_schedule,
                                                launch_sweep)
    from repro_torch.streaming.resume import (baseline_chunked, bdot_chunked,
                                              fdot_chunked, sdot_chunked)

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = nvidia_smi()

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS, "card": card,
          "ptxas": {name: ptxas_summary(p.with_suffix(".ptxas.txt").read_text())
                    for name, p in libs.items()}})

    # -- the main path's data ------------------------------------------------
    t0 = time.perf_counter()
    d, r, n_nodes, n_total, t_outer = 1024, 7, 20, 50_000, 100
    x, _, _ = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0, device=dev)
    blocks = partition_samples(x, n_nodes)
    x64 = x.double()
    m = sum(b.double() @ b.double().T / b.shape[1] for b in blocks)
    evecs = torch.linalg.eigh(m)[1]
    q_true = evecs[:, -r:].flip(-1).float()
    top_var = float(torch.linalg.eigvalsh(x64 @ x64.T / n_total)[-r:].sum())
    del x64, m
    graph = topology.erdos_renyi(n_nodes, 0.25, seed=1)
    fslabs = partition_features(x, n_nodes)          # 19 x 51 rows + 1 x 55
    g_rows, g_cols = 4, 5
    grid = [partition_samples(sl, g_cols)
            for sl in partition_features(x, g_rows)]  # (256, 10000) a node

    ds, rs, n_sp, n_sp_total, t_sp = 784, 5, 4096, 60_000, 5
    xs, _, _ = gaussian_eigengap_data(ds, n_sp_total, rs, 0.7, seed=0,
                                      device=dev)
    sp_blocks = partition_samples(xs, n_sp)
    sp_graph = topology.watts_strogatz(n_sp, k=6, p=0.1, seed=1)
    sp_eng = DenseConsensus(sp_graph, device=dev)
    check(sp_eng.is_sparse, "DenseConsensus(sparse=None) did not pick the "
          "ELL path for watts_strogatz(4096)")
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "sparse_ell_width": sp_eng._w.ell_width,
          "sparse_nnz": sp_eng._w.nnz})

    # -- kernels vs plain versions, at the main path's shapes ----------------
    gen = torch.Generator(device=dev).manual_seed(0)
    x_stack, n_true = _stack_data(blocks, dev)
    q_stack = torch.linalg.qr(torch.randn((n_nodes, d, r), generator=gen,
                                          device=dev))[0].contiguous()
    rows = {}
    record = make_record(rows)

    def tma_only(where, launches, packed=False, gram_packed=False):
        """Every gram-apply and slab-apply launch since the last reset took
        the TMA route and every slab tq launch the tiled kernel, but where
        ``packed`` the grid kernels' launches, and where ``gram_packed``
        the batched gram-apply launches (at sdot_sparse's stack), which
        took the packed route (bulk copies): count them on the rows. No
        Gram launch took the cluster route (r <= 8 here)."""
        n = {k: launches.get(k, 0) for k in (
            "batched_gram_apply", "gram_apply", "batched_slab_apply",
            "grid_block_apply", "batched_slab_tq", "grid_block_tq")}
        pk_tq = n["grid_block_tq"] if packed else 0
        pk_ap = n["grid_block_apply"] if packed else 0
        pk_gram = n["batched_gram_apply"] if gram_packed else 0
        for label, counts, want in (
                ("gram-apply", gram_update.ROUTE_LAUNCHES,
                 {"tma": n["batched_gram_apply"] + n["gram_apply"] - pk_gram,
                  "cp_async": 0, "packed": pk_gram}),
                ("slab-apply", slab_ops.ROUTE_LAUNCHES,
                 {"tma": n["batched_slab_apply"] + n["grid_block_apply"]
                  - pk_ap, "cp_async": 0, "packed": pk_ap,
                  "packed_cp_async": 0}),
                ("slab-tq", slab_ops.TQ_ROUTE_LAUNCHES,
                 {"tiled": n["batched_slab_tq"] + n["grid_block_tq"] - pk_tq,
                  "packed": pk_tq, "packed_cp_async": 0})):
            check(dict(counts) == want, f"{where}: {label} launches by "
                  f"route {dict(counts)}, expected {want}")
        check(gram_qr.ROUTE_LAUNCHES["cluster"] == 0, f"{where}: Gram "
              f"launches on the cluster route {dict(gram_qr.ROUTE_LAUNCHES)}")
        for k in ("batched_gram_apply", "gram_apply", "batched_slab_apply"):
            rows[k]["tma_launches"] += n[k]
        rows["batched_gram_apply"]["tma_launches"] -= pk_gram
        rows["batched_gram_apply_sdot_sparse"]["packed_launches"] += pk_gram
        rows["grid_block_apply"]["tma_launches"] += n["grid_block_apply"] \
            - pk_ap
        if packed:
            rows["grid_block_tq_packed"]["packed_launches"] += pk_tq
            rows["grid_block_apply_packed"]["packed_launches"] += pk_ap

    f32 = 4
    # the card's launch floor: the smallest kernel, timed as the rows are
    launch_floor_ms = time_ms(lambda: torch.cuda._sleep(1))
    record("batched_gram_apply", "src/repro_torch/kernels/csrc/gram_update.cu",
           "src/repro/kernels/gram_update.py:102",
           lambda: ops.batched_gram_apply(x_stack, q_stack, n_true),
           lambda: ref.batched_gram_apply_ref(x_stack, q_stack, n_true),
           lambda: torch.bmm(x_stack, torch.bmm(x_stack.mT, q_stack)),
           f32 * (x_stack.numel() + 2 * q_stack.numel() + n_nodes),
           4.0 * x_stack.numel() * r, GRAM_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|",
           host=True)
    x_one, q_one = blocks[0].contiguous(), q_stack[0]
    record("gram_apply", "src/repro_torch/kernels/csrc/gram_update.cu",
           "src/repro/kernels/gram_update.py:51",
           lambda: ops.gram_apply(x_one, q_one),
           lambda: ref.gram_apply_ref(x_one, q_one),
           lambda: x_one @ (x_one.T @ q_one),
           f32 * (x_one.numel() + 2 * q_one.numel()), 4.0 * x_one.numel() * r,
           GRAM_TOL, "f32 sums in another order than cuBLAS; relative to "
           "max |V|", host=True)
    # row 1 at sdot_sparse's own shape: 4,096 nodes of 784 x 14-15 samples
    # (16 on the card), many small nodes: the packed route (a node whole in
    # a ring stage, X_i and Q_i bulk-copied)
    x_sp_stack, n_sp_true = _stack_data(sp_blocks, dev)
    check(gram_update.packed_plan(n_sp, ds, x_sp_stack.shape[2], rs,
                                  *_launch.card(0)).route == "packed",
          "row 1 at sdot_sparse's stack: the planner did not pick the "
          "packed route")
    q_sp_stack = torch.linalg.qr(torch.randn((n_sp, ds, rs), generator=gen,
                                             device=dev))[0].contiguous()
    record("batched_gram_apply_sdot_sparse",
           "src/repro_torch/kernels/csrc/gram_update.cu",
           "src/repro/kernels/gram_update.py:102",
           lambda: ops.batched_gram_apply(x_sp_stack, q_sp_stack, n_sp_true),
           lambda: ref.batched_gram_apply_ref(x_sp_stack, q_sp_stack,
                                              n_sp_true),
           lambda: torch.bmm(x_sp_stack, torch.bmm(x_sp_stack.mT,
                                                   q_sp_stack)),
           f32 * (x_sp_stack.numel() + 2 * q_sp_stack.numel() + n_sp),
           4.0 * x_sp_stack.numel() * rs, GRAM_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|",
           host=True)
    rows["batched_gram_apply_sdot_sparse"].update(
        shape=list(x_sp_stack.shape) + [rs], packed_launches=0,
        kernel="gram_apply_packed_kernel")
    rows["batched_gram_apply_sdot_sparse"].pop("tma_launches")
    del x_sp_stack, q_sp_stack, n_sp_true
    sw = sp_eng._w
    k_payload = ds * rs
    z = torch.randn((n_sp, k_payload), generator=gen, device=dev)
    w_csr = sw.to_dense().to_sparse_csr()
    edges = float(sw.row_nnz.sum())
    ell_meta = f32 * (2 * sw.ell_idx.numel() + n_sp)
    ell_flops = 2.0 * (edges + n_sp) * k_payload
    # the function's bytes: z (f32) read once, out written once, the slots;
    # a bf16 payload is rounded inside the kernel, so the same bytes
    ell_bytes = ell_meta + f32 * 2 * z.numel()

    def ell_l2_bytes(window):
        """L2 traffic of the gathers that miss the shared-memory window: 4
        bytes a value of each out-of-window slot's row."""
        return window.gathers * k_payload * f32

    def ell_window(window):
        return {"band_rows": window.band_rows, "halo": window.halo,
                "in_window_share": window.in_window_share,
                "gathers": window.gathers}

    for name, payload in (("ell_spmm", None), ("ell_spmm_bf16", "bfloat16")):
        src = z if payload is None else z.to(torch.bfloat16)
        record(name, "src/repro_torch/kernels/csrc/ell_spmm.cu",
               "src/repro/kernels/ell_spmm.py:57",
               lambda payload=payload: ops.ell_spmm(
                   sw.ell_idx, sw.ell_val, sw.diag, z,
                   payload_dtype=payload, window=sw.window),
               lambda src=src: ref.ell_spmm_ref(sw.ell_idx, sw.ell_val,
                                                sw.diag, z, src),
               (lambda: torch.sparse.mm(w_csr, z)) if payload is None
               else None, ell_bytes, ell_flops, ELL_TOL,
               "f32 FMA chain against the plain gather; relative to max "
               "|out|" if payload is None else "the same bf16-quantised "
               "messages on both sides, so f32-tight; relative to max |out|")
        rows[name].update(window=ell_window(sw.window),
                          l2_bytes=ell_l2_bytes(sw.window))
    # a bf16 round is one kernel on the card: the messages are rounded
    # inside it, no cast of the payload runs beside it. A profiler session
    # sometimes records no device event at all (the process's first, and
    # on one card run the second too): such a session saw nothing, so the
    # round is profiled again, up to five sessions, and the first session
    # that recorded device events is the one held to one ELL kernel
    from torch.profiler import ProfilerActivity, profile

    def bf16_round_kernels():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                         payload_dtype="bfloat16", window=sw.window)
            torch.cuda.synchronize()
        return [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    bf16_kernels, sessions = [], 0
    while not bf16_kernels and sessions < 5:
        bf16_kernels, sessions = bf16_round_kernels(), sessions + 1
    check(len(bf16_kernels) == 1 and bf16_kernels[0][1] == 1
          and "ell_spmm" in bf16_kernels[0][0],
          f"ell_spmm_bf16: a round ran {bf16_kernels} (profiler session "
          f"{sessions}), not one ELL kernel")
    rows["ell_spmm_bf16"].update(device_kernels_a_round=1,
                                 profiler_sessions=sessions)
    # the same round on a graph without locality: erdos_renyi(4096, 0.0015)
    # (its nodes average 6.1 neighbours, like the overlay's 6; at this p a
    # graph is almost never connected, so it is not resampled until it is)
    er_w = SparseW.from_graph(topology.erdos_renyi(
        n_sp, 0.0015, seed=1, ensure_connected=False), device=dev)
    er_csr = er_w.to_dense().to_sparse_csr()
    ell_checks = {}
    for payload in (None, "bfloat16"):
        src = z if payload is None else z.to(torch.bfloat16)

        def kernel(payload=payload):
            return ops.ell_spmm(er_w.ell_idx, er_w.ell_val, er_w.diag, z,
                                payload_dtype=payload, window=er_w.window)
        got, again = kernel(), kernel()
        want = ref.ell_spmm_ref(er_w.ell_idx, er_w.ell_val, er_w.diag, z, src)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= ELL_TOL * float(want.abs().max()),
              f"ell_spmm erdos_renyi {payload}: max abs err {err}")
        check(torch.equal(got, again), "ell_spmm erdos_renyi: two launches "
              "differ")
        b_ms, b_by = bound(f32 * (2 * er_w.ell_idx.numel() + n_sp)
                           + f32 * 2 * z.numel(),
                           2.0 * (float(er_w.row_nnz.sum()) + n_sp)
                           * k_payload)
        ell_checks["erdos_renyi" + ("_bf16" if payload else "")] = {
            "shape": [n_sp, er_w.ell_width, k_payload], "max_abs_err": err,
            "rel_err": err / float(want.abs().max()),
            "window": ell_window(er_w.window),
            "l2_bytes": ell_l2_bytes(er_w.window),
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda src=src: ref.ell_spmm_ref(
                er_w.ell_idx, er_w.ell_val, er_w.diag, z, src)),
            "library_ms": (time_ms(lambda: torch.sparse.mm(er_csr, z))
                           if payload is None else None),
            "bound_ms": b_ms, "bound_by": b_by}
        del got, again, want
    del z, w_csr, er_w, er_csr
    # the batched form at bdot_sparse's row stage: four watts_strogatz(4096,
    # 6, 0.1) graphs (seeds 1-4, ragged widths, widened to one L) stacked,
    # B = 4 members over K = 196 x 5 = 980 columns each (B K = row 3's K)
    bs_members = [SparseW.from_graph(topology.watts_strogatz(
        n_sp, k=6, p=0.1, seed=s), device=dev) for s in (1, 2, 3, 4)]
    bs = SparseW.stack(bs_members)
    b_mem, k_b = len(bs_members), 196 * rs
    zb = torch.randn((b_mem, n_sp, k_b), generator=gen, device=dev)
    # the library's yardstick: one CSR product over the block-diagonal
    # (B N, B N) matrix of the four graphs (diagonals included)
    b_rows = (torch.arange(b_mem * n_sp, device=dev)[:, None]
              .expand(-1, bs.ell_width).reshape(-1))
    b_cols = (bs.ell_idx.long() + n_sp * torch.arange(
        b_mem, device=dev)[:, None, None]).reshape(-1)
    diag_ix = torch.arange(b_mem * n_sp, device=dev)
    b_csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat([b_rows, diag_ix]),
                     torch.cat([b_cols, diag_ix])]),
        torch.cat([bs.ell_val.reshape(-1), bs.diag.reshape(-1)]),
        (b_mem * n_sp, b_mem * n_sp)).coalesce().to_sparse_csr()
    zb_flat = zb.reshape(b_mem * n_sp, k_b)
    b_edges = float(bs.row_nnz.sum())
    b_bytes = (f32 * (2 * bs.ell_idx.numel() + bs.diag.numel())
               + f32 * 2 * zb.numel())
    for name, payload in (("ell_spmm_batched", None),
                          ("ell_spmm_batched_bf16", "bfloat16")):
        src = zb if payload is None else zb.to(torch.bfloat16)
        record(name, "src/repro_torch/kernels/csrc/ell_spmm.cu",
               "src/repro/kernels/ell_spmm.py:57",
               lambda payload=payload: ops.ell_spmm(
                   bs.ell_idx, bs.ell_val, bs.diag, zb,
                   payload_dtype=payload, window=bs.window),
               lambda src=src: ref.ell_spmm_ref(bs.ell_idx, bs.ell_val,
                                                bs.diag, zb, src),
               (lambda: torch.sparse.mm(b_csr, zb_flat)) if payload is None
               else None, b_bytes, 2.0 * (b_edges + b_mem * n_sp) * k_b,
               ELL_TOL, "f32 FMA chain against the plain gather; relative "
               "to max |out|" if payload is None else "the same "
               "bf16-quantised messages on both sides; relative to max "
               "|out|", host=True)
        got = ops.ell_spmm(bs.ell_idx, bs.ell_val, bs.diag, zb,
                           payload_dtype=payload, window=bs.window)
        members_equal = [bool(torch.equal(got[m], ops.ell_spmm(
            bs.ell_idx[m], bs.ell_val[m], bs.diag[m], zb[m],
            payload_dtype=payload, window=bs.member_windows[m])))
            for m in range(b_mem)]
        check(all(members_equal), f"{name}: a member differs from a single "
              f"launch of it: {members_equal}")
        rows[name].pop("tma_launches")           # no TMA route in this one
        rows[name].update(
            shape=[b_mem, n_sp, bs.ell_width, k_b],
            member_widths=[m.ell_width for m in bs_members],
            members_equal_single_launches=members_equal,
            window=ell_window(bs.window),
            member_windows=[ell_window(w) for w in bs.member_windows],
            l2_bytes=bs.window.gathers * k_b * f32)
        del got
    rows["ell_spmm_batched_bf16"].update(
        main_path=False, note="bf16 messages over a stack: no phase of the "
        "main path runs it, so 0 launches there")
    del zb, zb_flat, b_csr, b_rows, b_cols, diag_ix

    # the slab kernels at F-DOT's shapes, the grid kernels at B-DOT's
    x_pad = pad_feature_slabs(fslabs)                      # (20, 55, 50000)
    q_pad = torch.randn((n_nodes, x_pad.shape[1], r), generator=gen,
                        device=dev)
    s_slab = torch.randn((n_nodes, n_total, r), generator=gen, device=dev)
    record("batched_slab_tq", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:60",
           lambda: ops.batched_slab_tq(x_pad, q_pad),
           lambda: ref.batched_slab_tq_ref(x_pad, q_pad),
           lambda: torch.bmm(x_pad.mT, q_pad),
           f32 * (x_pad.numel() + q_pad.numel() + n_nodes * n_total * r),
           2.0 * x_pad.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |Z|")
    record("batched_slab_apply", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:109",
           lambda: ops.batched_slab_apply(x_pad, s_slab),
           lambda: ref.batched_slab_apply_ref(x_pad, s_slab),
           lambda: torch.bmm(x_pad, s_slab),
           f32 * (x_pad.numel() + s_slab.numel() + q_pad.numel()),
           2.0 * x_pad.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|",
           host=True)
    x_grid = pad_grid_blocks(grid)                         # (4, 5, 256, 10000)
    n_blk = x_grid.shape[3]
    q_grid = torch.randn((g_rows, x_grid.shape[2], r), generator=gen,
                         device=dev)
    s_grid = torch.randn((g_cols, n_blk, r), generator=gen, device=dev)
    record("grid_block_tq", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:148",
           lambda: ops.grid_block_tq(x_grid, q_grid),
           lambda: ref.grid_block_tq_ref(x_grid, q_grid),
           lambda: torch.matmul(x_grid.mT, q_grid[:, None]),
           f32 * (x_grid.numel() + q_grid.numel()
                  + g_rows * g_cols * n_blk * r),
           2.0 * x_grid.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |Z|")
    record("grid_block_apply", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:198",
           lambda: ops.grid_block_apply(x_grid, s_grid),
           lambda: ref.grid_block_apply_ref(x_grid, s_grid),
           lambda: torch.matmul(x_grid, s_grid[None]),
           f32 * (x_grid.numel() + s_grid.numel()
                  + g_rows * g_cols * x_grid.shape[2] * r),
           2.0 * x_grid.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|",
           host=True)
    # the CholeskyQR Gram: on the main path S-DOT's (N, d, r) node batch,
    # F-DOT's (N, d_max, r) slabs and B-DOT's (I, d_max, r) row slabs, and
    # benchmarks/kernel_bench.py's tall (16384, 128) matrix
    def gram_qr_work(v):
        """(bytes, flops, flop rate) of G = V^T V: V read once, G written
        once, and the d r (r + 1) flops of the symmetric product a matrix,
        at the peak rate of V's type."""
        b, rows_, cols = v.shape
        rate = (BF16_TC_FLOP_PER_S if v.dtype == torch.bfloat16
                else F32_FLOP_PER_S)
        return (v.numel() * v.element_size() + f32 * b * cols * cols,
                float(b * rows_ * cols * (cols + 1)), rate)

    v_qr = torch.randn((n_nodes, d, r), generator=gen, device=dev)
    qr_bytes, qr_flops, _ = gram_qr_work(v_qr)
    record("gram_qr", "src/repro_torch/kernels/csrc/gram_qr.cu",
           "src/repro/kernels/gram_qr.py:40",
           lambda: ops.gram_qr(v_qr), lambda: ref.gram_qr_ref(v_qr),
           lambda: torch.bmm(v_qr.mT, v_qr), qr_bytes, qr_flops, GRAM_QR_TOL,
           "f32 sums in another order than cuBLAS; relative to max |G|")
    for name in ("gram_apply", "gram_qr"):
        rows[name]["launch_floor_ms"] = launch_floor_ms
    gram_qr_checks = {}
    for label, shape, dtype in (
            ("sdot", (n_nodes, d, r), torch.float32),
            ("fdot", (n_nodes, 55, r), torch.float32),
            ("bdot", (g_rows, 256, r), torch.float32),
            ("bench_f32", (1, 16384, 128), torch.float32),
            ("bench_bf16", (1, 16384, 128), torch.bfloat16)):
        vq = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got, again = ops.gram_qr(vq), ops.gram_qr(vq)
        want = ref.gram_qr_ref(vq)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        nbytes, flops, rate = gram_qr_work(vq)
        b_ms, b_by = bound(nbytes, flops, rate)
        gram_qr_checks[label] = {
            "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err, "rel_err": err / float(want.abs().max()),
            "tolerance": GRAM_QR_TOL,
            "same_bits_twice": bool(torch.equal(got, again)),
            "symmetric": bool(torch.equal(got, got.mT)),
            "ms": time_ms(lambda: ops.gram_qr(vq)),
            "plain_ms": time_ms(lambda: ref.gram_qr_ref(vq)),
            "library_ms": time_ms(lambda: torch.bmm(vq.mT, vq)),
            "bound_ms": b_ms, "bound_by": b_by,
            "launch_floor_ms": launch_floor_ms,
            "route": gram_qr_route(shape, dtype == torch.bfloat16),
            "host_us": host_us(lambda: ops.gram_qr(vq)),
            "library_host_us": host_us(lambda: torch.bmm(vq.mT, vq))}
        del vq, got, again, want
    # flash attention at qwen2-7b's prefill: q (4, 28, 2048, 128), k/v
    # (4, 4, 2048, 128), bf16, causal
    fb, fhq, fhkv, fs, fhd = 4, 28, 4, 2048, 128

    def attn_inputs(dtype, b, hq, hkv, sq, skv, hd):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, hq, sq, hd), (b, hkv, skv, hd),
                              (b, hkv, skv, hd))]

    fq, fk, fv = attn_inputs(torch.bfloat16, fb, fhq, fhkv, fs, fs, fhd)
    bf16 = 2
    # bf16 runs on the tensor-core kernel, f32 on the CUDA-core kernel
    record("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:86",
           lambda: ops.flash_attention(fq, fk, fv, causal=True),
           lambda: attn_plain(fq, fk, fv, causal=True),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               fq, fk, fv, is_causal=True, enable_gqa=True),
           bf16 * (2 * fq.numel() + fk.numel() + fv.numel()),
           4.0 * fb * fhq * fhd * fs * (fs + 1) / 2, ATTN_BF16_TOL,
           "bf16: each side rounds an f32 result once; one bf16 ulp (2^-7) "
           "of the largest |out| in the element's own row, and relative RMS "
           "within half an ulp (2^-8)",
           flop_rate=BF16_TC_FLOP_PER_S, judge=attn_judge(torch.bfloat16))
    rows["flash_attention"]["kernel"] = "flash_attention_wgmma_kernel"
    flash_once = ops.flash_attention(fq, fk, fv, causal=True)
    flash_twice = ops.flash_attention(fq, fk, fv, causal=True)
    flash_same_bits = bool(torch.equal(flash_once, flash_twice))
    del flash_once, flash_twice
    f32q, f32k, f32v = attn_inputs(torch.float32, 1, fhq, fhkv, 1024, 1024,
                                   fhd)
    record("flash_attention_f32",
           "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:86",
           lambda: ops.flash_attention(f32q, f32k, f32v, causal=True),
           lambda: attn_plain(f32q, f32k, f32v, causal=True),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               f32q, f32k, f32v, is_causal=True, enable_gqa=True),
           f32 * (2 * f32q.numel() + f32k.numel() + f32v.numel()),
           4.0 * fhq * fhd * 1024 * 1025 / 2, ATTN_F32_TOL,
           "f32 sums in another order; relative to max |out|",
           judge=attn_judge(torch.float32))
    rows["flash_attention_f32"].update(
        kernel="flash_attention_simt_kernel", main_path=False,
        note="the f32 route: not on the bf16 main path, so 0 launches there")
    del f32q, f32k, f32v
    flash_checks = {}
    for label, dtype, shape, kw in (
            ("window512", torch.bfloat16, (fb, fhq, fhkv, fs, fs, fhd),
             dict(window=512)),
            ("ragged2000", torch.bfloat16, (fb, fhq, fhkv, 2000, 2000, fhd),
             {}),
            ("cross128x2048", torch.bfloat16, (fb, fhq, fhkv, 128, fs, fhd),
             {}),
            # h2o-danube-1.8b's heads (32 / 8) and head dim 80
            ("hd80_window512", torch.bfloat16, (fb, 32, 8, fs, fs, 80),
             dict(window=512)),
            ("f32_hd128", torch.float32, (1, fhq, fhkv, 1024, 1024, fhd),
             {})):
        q_, k_, v_ = attn_inputs(dtype, *shape)
        got = ops.flash_attention(q_, k_, v_, causal=True, **kw).float()
        want = attn_plain(q_, k_, v_, causal=True, **kw).float()
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        flash_checks[label] = {
            "shape": list(shape),
            **attn_judge(dtype)(f"flash {label}", got, want),
            "tolerance": (ATTN_BF16_TOL if dtype == torch.bfloat16
                          else ATTN_F32_TOL)}
        del q_, k_, v_, got, want
    flash_lib = libs["flash_attention"]
    flash_report = flash_lib.with_suffix(".ptxas.txt").read_text()
    flash_ptxas = ptxas_entries(flash_report, "flash_attention_wgmma_kernel")
    for name, entry in flash_ptxas.items():
        entry["dynamic_smem_bytes"] = tc_smem_bytes(
            int(name.split("ILi", 1)[1].split("E", 1)[0]))
    flash_hgmma = sass_counts(Path(_build.nvcc_path()).with_name("cuobjdump"),
                              flash_lib, "flash_attention_wgmma_kernel",
                              "HGMMA")
    stream_ptxas = {
        name: ptxas_entries(libs[lib].with_suffix(".ptxas.txt").read_text(),
                            fragment)
        for name, lib, fragment in (
            ("gram_apply", "gram_update", "gram_apply_kernelILi8ELi4E"),
            ("gram_apply_packed", "gram_update",
             "gram_apply_packed_kernelILi5ELb1ELi4ELi16E"),
            ("slab_apply", "slab_ops", "slab_apply_kernelILi7ELb1E"))}
    emit({"phase": "kernels",
          "gram_slab_apply_ptxas": stream_ptxas,
          "flash_attention_checks": flash_checks,
          "flash_attention_same_bits_twice": flash_same_bits,
          "flash_attention_wgmma_ptxas": flash_ptxas,
          "flash_attention_wgmma_hgmma": flash_hgmma,
          # ptxas's C75xx notes: wgmmas it had to serialize
          "flash_attention_wgmma_serialized": [
              ln.split(":", 1)[-1].strip() for ln in flash_report.splitlines()
              if "C75" in ln and "flash_attention_wgmma_kernel" in ln],
          "gram_qr_checks": gram_qr_checks,
          "ell_checks": ell_checks,
          "launch_floor_ms": launch_floor_ms,
          "shapes": {"batched_gram_apply": list(x_stack.shape) + [r],
                     "gram_apply": list(x_one.shape) + [r],
                     "ell_spmm": [n_sp, sw.ell_width, k_payload],
                     "ell_spmm_batched": [b_mem, n_sp, bs.ell_width, k_b],
                     "batched_slab_tq": list(x_pad.shape) + [r],
                     "batched_slab_apply": list(x_pad.shape) + [r],
                     "grid_block_tq": list(x_grid.shape) + [r],
                     "grid_block_apply": list(x_grid.shape) + [r],
                     "gram_qr": list(v_qr.shape),
                     "flash_attention": [list(fq.shape), list(fk.shape)],
                     "flash_attention_f32": [[1, fhq, 1024, fhd],
                                             [1, fhkv, 1024, fhd]]},
          "kernels": list(rows.values())})
    for label, c in gram_qr_checks.items():
        check(c["rel_err"] <= GRAM_QR_TOL, f"gram_qr {label}: relative error "
              f"{c['rel_err']} > {GRAM_QR_TOL}")
        check(c["same_bits_twice"], f"gram_qr {label}: two launches differ")
        check(c["symmetric"], f"gram_qr {label}: G != G^T")
    check(flash_same_bits, "flash_attention: two launches differ")
    check(bool(flash_ptxas), "flash_attention: no ptxas report of the "
          "wgmma kernel")
    for name, n in flash_hgmma.items():
        check(name == "not measured" or n > 0,
              f"flash_attention: no HGMMA in {name}")
    del x_pad, q_pad, s_slab, x_grid, q_grid, s_grid, fq, fk, fv, v_qr

    # -- sdot_dense: the main path at CIFAR-10 width -------------------------
    q_init = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                              device=dev)
    eng = DenseConsensus(graph, device=dev)
    check(not eng.is_sparse, "ER(20) must stay dense")
    runs = {}
    for label, kw in (("sdot_tc50", dict(t_c=50)),
                      ("sadot_lin2_cap50", dict(schedule=consensus_schedule(
                          "lin2", t_outer, cap=50)))):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sdot(data=blocks, engine=eng, r=r, t_outer=t_outer,
                   q_init=q_init, q_true=q_true, device=dev, **kw)
        q_mean = cholesky_qr2(res.q_mean)[0]
        v = ops.gram_apply(x, q_mean)              # explained variance, all data
        explained = float(torch.trace(q_mean.T @ v))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        tma_only(label, launches)
        sched = res.consensus_trace
        sends = float(graph.adjacency.sum()) * float(sched.sum())
        check(res.error_trace.shape == (t_outer,)
              and np.isfinite(res.error_trace).all(), f"{label}: bad trace")
        check(float(res.error_trace[-1]) <= SUBSPACE_TOL,
              f"{label}: final error {res.error_trace[-1]} > {SUBSPACE_TOL}")
        check(launches["batched_gram_apply"] == t_outer,
              f"{label}: {launches['batched_gram_apply']} gram-apply "
              f"launches, expected {t_outer}")
        check(launches["gram_apply"] == 1, f"{label}: gram_apply not launched")
        # CholeskyQR2 a step, and once more for q_mean above
        want_qr = 2 * t_outer + 2
        check(launches["gram_qr"] == want_qr, f"{label}: {launches['gram_qr']}"
              f" Gram launches, expected {want_qr}")
        check(res.ledger.p2p == sends and res.ledger.matrices == sends
              and res.ledger.scalars == sends * d * r
              and res.ledger.payload_bytes == sends * d * r * 4,
              f"{label}: ledger differs from the closed form")
        check(explained >= (1 - SUBSPACE_TOL) * top_var,
              f"{label}: explained variance {explained} < top-r {top_var}")
        if label == "sdot_tc50":
            q_sdot, sdot_trace = q_mean, res.error_trace
        runs[label] = {"wall_s": wall, "final_err": float(res.error_trace[-1]),
                       "err_at": {str(t): float(res.error_trace[t - 1])
                                  for t in (1, 10, 25, 50, 100)},
                       "rounds": int(sched.sum()), "launches": launches,
                       "explained_over_top_r": explained / top_var}
        for name in ("batched_gram_apply", "gram_apply", "gram_qr"):
            rows[name]["launches"] += launches[name]
    emit({"phase": "sdot_dense", "d": d, "r": r, "nodes": n_nodes,
          "samples": n_total, "t_outer": t_outer, "runs": runs})
    psa_groups = {"gram_qr": ("gram_qr_",),
                  "gram_apply": ("gram_apply_kernel", "gram_apply_packed"),
                  "slab_grid": ("slab_tq", "slab_apply"),
                  "gemm": ("gemm", "nvjet", "xmma", "cutlass", "splitk",
                           "gemv")}
    emit(profile_phase(lambda: sdot(data=blocks, engine=eng, r=r, t_outer=20,
                                    q_init=q_init, q_true=q_true, device=dev,
                                    t_c=50), groups=psa_groups))
    del x_stack, q_stack

    # -- fdot_dense / bdot_dense: the same X by features and by blocks -------
    schedules = (("tc50", None),
                 ("lin2_cap50", consensus_schedule("lin2", t_outer, cap=50)))
    t_qr = 50

    def summarise(res, wall, kernels, ledger_want):
        """``kernels`` maps each kernel of the run to its expected launch
        count."""
        q_full = res.q_full
        return {"wall_s": wall, "final_err": float(res.error_trace[-1]),
                "err_at": {str(t): float(res.error_trace[t - 1])
                           for t in (1, 10, 25, 50, 100)},
                "finite": bool(np.isfinite(res.error_trace).all()
                               and res.error_trace.shape == (t_outer,)),
                "orthonormality_err": float((
                    q_full.T @ q_full - torch.eye(r, device=dev)).abs().max()),
                "subspace_err_vs_sdot": float(subspace_error(q_sdot, q_full)),
                "ledger": [res.ledger.p2p, res.ledger.matrices,
                           res.ledger.scalars, res.ledger.payload_bytes],
                "ledger_closed_form": list(ledger_want),
                "launches": {k: ops.LAUNCHES[k] for k in kernels},
                "launches_expected": dict(kernels)}

    def verify(phase, runs):
        """Checks of a phase's runs, made after its line is printed."""
        for label, run in runs.items():
            where = f"{phase} {label}"
            check(run["finite"], f"{where}: bad trace")
            check(run["final_err"] <= SUBSPACE_TOL,
                  f"{where}: final error {run['final_err']} > {SUBSPACE_TOL}")
            check(run["orthonormality_err"] <= 1e-5, f"{where}: q_full off "
                  f"orthonormal by {run['orthonormality_err']}")
            for name, count in run["launches"].items():
                want = run["launches_expected"][name]
                check(count == want, f"{where}: {count} {name} launches, "
                      f"expected {want}")
                rows[name]["launches"] += count
            check(run["ledger"] == run["ledger_closed_form"],
                  f"{where}: ledger differs from the closed form")
            check(run["subspace_err_vs_sdot"] <= SUBSPACE_TOL,
                  f"{where}: subspace error {run['subspace_err_vs_sdot']} "
                  "against S-DOT's estimate")

    def closed_form(terms):
        """(p2p, matrices, scalars, payload_bytes) of gossip terms
        (adjacency, rounds, payload elements), f32 payloads."""
        p2p = scalars = 0.0
        for adj, rounds, payload in terms:
            sends = float(adj.sum()) * float(rounds)
            p2p += sends
            scalars += sends * payload
        return [p2p, p2p, scalars, scalars * 4]

    fdot_runs = {}
    for label, sched in schedules:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fdot(data_blocks=fslabs, engine=eng, r=r, t_outer=t_outer,
                   t_c=50, t_c_qr=t_qr, schedule=sched, q_init=q_init,
                   q_true=q_true, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tma_only(f"fdot_dense {label}", dict(ops.LAUNCHES))
        rounds = sched.sum() if sched is not None else 50 * t_outer
        want = closed_form([(graph.adjacency, rounds, n_total * r),
                            (graph.adjacency, 2 * t_qr * t_outer, r * r)])
        fdot_runs[label] = summarise(
            res, wall, {"batched_slab_tq": t_outer,
                        "batched_slab_apply": t_outer,
                        "gram_qr": QR_PASSES * t_outer}, want)
    emit({"phase": "fdot_dense", "d": d, "r": r, "nodes": n_nodes,
          "slab_rows": sorted({int(b.shape[0]) for b in fslabs}),
          "samples": n_total, "t_outer": t_outer, "runs": fdot_runs})
    verify("fdot_dense", fdot_runs)
    emit(profile_phase(
        lambda: fdot(data_blocks=fslabs, engine=eng, r=r, t_outer=20,
                     t_c=50, q_init=q_init, q_true=q_true, device=dev),
        "profile_fdot", "fdot_dense F-DOT, T_o = 20, t_c = t_c_qr = 50",
        groups=psa_groups))

    col_engs = [DenseConsensus(topology.erdos_renyi(g_rows, 0.7, seed=j),
                               device=dev) for j in range(g_cols)]
    row_engs = [DenseConsensus(topology.erdos_renyi(g_cols, 0.7, seed=10 + i),
                               device=dev) for i in range(g_rows)]
    d_i, n_j = grid[0][0].shape
    bdot_runs = {}
    for label, sched in schedules:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bdot(blocks=grid, col_engines=col_engs, row_engines=row_engs,
                   r=r, t_outer=t_outer, t_c=50, t_c_qr=t_qr, schedule=sched,
                   q_init=q_init, q_true=q_true, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tma_only(f"bdot_dense {label}", dict(ops.LAUNCHES))
        rounds = sched.sum() if sched is not None else 50 * t_outer
        want = closed_form(
            [(e.graph.adjacency, rounds, n_j * r) for e in col_engs]
            + [(e.graph.adjacency, rounds, d_i * r) for e in row_engs]
            + [(col_engs[0].graph.adjacency, 2 * t_qr * t_outer, r * r)])
        bdot_runs[label] = summarise(
            res, wall, {"grid_block_tq": t_outer, "grid_block_apply": t_outer,
                        "gram_qr": QR_PASSES * t_outer}, want)
    emit({"phase": "bdot_dense", "d": d, "r": r, "grid": [g_rows, g_cols],
          "block": [int(d_i), int(n_j)], "t_outer": t_outer,
          "runs": bdot_runs})
    verify("bdot_dense", bdot_runs)
    emit(profile_phase(
        lambda: bdot(blocks=grid, col_engines=col_engs, row_engines=row_engs,
                     r=r, t_outer=20, t_c=50, q_init=q_init, q_true=q_true,
                     device=dev),
        "profile_bdot", "bdot_dense B-DOT 4 x 5, T_o = 20, t_c = t_c_qr = 50",
        groups=psa_groups))

    # -- sdot_async: the paper's straggler study (Table V) on the card ------
    def timed_run(fn):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(ops.LAUNCHES)

    def count_path(where, launches, want, packed=False, gram_packed=False):
        """Every kernel of ``want`` launched exactly so often; add the
        launches to the rows."""
        tma_only(where, launches, packed, gram_packed)
        for name, count in want.items():
            check(launches[name] == count, f"{where}: {launches[name]} "
                  f"{name} launches, expected {count}")
            rows[name]["launches"] += count

    def to_small_n_gram(count):
        """``count`` gram-apply launches of the last run were at
        sdot_sparse's shape (on the packed route, which ``tma_only`` counted
        on that row): move them to that row."""
        rows["batched_gram_apply"]["launches"] -= count
        rows["batched_gram_apply_sdot_sparse"]["launches"] += count

    def with_state(program):
        """Run ``program`` whole; (its result, its final RunState)."""
        seen, fin = {}, program.finalize
        program.finalize = lambda st, done: (seen.setdefault("s", st),
                                             fin(st, done))[1]
        return runtime.run_monolithic(program), seen["s"]

    duty = STRAGGLER_T_ROUND_S / (STRAGGLER_T_ROUND_S + STRAGGLER_DELAY_S)
    p_awake = np.ones(n_nodes)
    p_awake[0] = duty
    sdot_kw = dict(data=blocks, r=r, t_outer=t_outer, t_c=50, q_init=q_init,
                   q_true=q_true, device=dev)
    (res_a, state_a), wall_a, launches = timed_run(lambda: with_state(
        sdot_program(engine=AsyncConsensus(graph, p_awake, seed=0,
                                           device=dev), **sdot_kw)))
    count_path("sdot_async", launches, {"batched_gram_apply": t_outer,
                                        "gram_qr": QR_PASSES * t_outer})
    realized_sends = float(state_a.sends.double().sum())
    # the reference's own awake masks, one (50, N) block a step
    ref_npz = np.load(Path(__file__).resolve().parent / "tools" / "data"
                      / "sdot_async_reference.npz")
    ref_shape = tuple(int(v) for v in ref_npz["shape"])
    ref_awake = np.unpackbits(ref_npz["awake"])[:int(np.prod(ref_shape))]
    ref_awake = ref_awake.reshape(ref_shape).astype(bool)
    res_ref, wall_ref, launches_ref = timed_run(lambda: sdot(
        engine=AsyncConsensus(graph, p_awake, seed=0, device=dev),
        draws=list(ref_awake), **sdot_kw))
    tma_only("sdot_async reference masks", launches_ref)
    for name in ("batched_gram_apply", "gram_qr"):
        rows[name]["launches"] += launches_ref[name]
    res_awake, wall_awake, _ = timed_run(lambda: sdot(
        engine=AsyncConsensus(graph, 1.0, seed=0, device=dev), **sdot_kw))
    # the card's own time a gossip round: the sync round (one matmul at
    # S-DOT's payload) and the async one (a live round of
    # masked_async_rounds, its round matrices built with it)
    z_round = torch.randn((n_nodes, d, r), generator=gen, device=dev)
    awake_block = AsyncConsensus(graph, p_awake, seed=1, device=dev)._draw(
        0, 50)
    adj_dev = torch.as_tensor(graph.adjacency, dtype=torch.float32,
                              device=dev)
    sync_round_ms = time_ms(lambda: eng._w @ z_round.reshape(n_nodes, -1))
    async_round_ms = time_ms(lambda: masked_async_rounds(
        eng._w, adj_dev, awake_block, 50, z_round)) / 50
    rounds_total = int(res_a.consensus_trace.sum())
    half = res_a.error_trace[t_outer // 2:]
    sdot_async = {
        "p_awake_node0": duty, "wall_s": wall_a,
        "final_err": float(res_a.error_trace[-1]),
        "second_half_max": float(half.max()),
        "second_half_median": float(np.median(half)),
        "limit": 10 * REF_ASYNC_SECOND_HALF_MAX,
        "limit_reason": "10x the reference's largest error over steps "
                        "51-100 (its own masks)",
        "err_at": {str(t): float(res_a.error_trace[t - 1])
                   for t in (1, 10, 25, 50, 100)},
        "mean_awake": res_a.ledger.mean_awake(),
        "ledger_p2p": res_a.ledger.p2p, "realized_sends": realized_sends,
        "launches": {k: launches[k] for k in ("batched_gram_apply",
                                               "gram_qr")},
        "reference_masks": {
            "wall_s": wall_ref, "final_err": float(res_ref.error_trace[-1]),
            "limit": ref_limit("sdot_async"),
            "reference_cpu_final_err": REF_FINAL_ERR["sdot_async"],
            "max_trace_diff_vs_reference": float(np.abs(
                res_ref.error_trace - ref_npz["error_trace"]).max()),
            "trace_tolerance": REF_TRACE_TOL,
            "mean_awake": res_ref.ledger.mean_awake()},
        "all_awake": {"wall_s": wall_awake,
                      "max_trace_diff_vs_sync": float(np.abs(
                          res_awake.error_trace - sdot_trace).max())},
        "gossip_round_ms": {"sync": sync_round_ms, "async": async_round_ms},
        "straggler_wall_clock": straggler_wall_clock(
            n_nodes=n_nodes, t_round=sync_round_ms / 1e3,
            delay=STRAGGLER_DELAY_S, rounds_sync=rounds_total,
            rounds_async=rounds_total)}
    emit({"phase": "sdot_async", **sdot_async})
    check(np.isfinite(res_a.error_trace).all()
          and res_a.error_trace.shape == (t_outer,), "sdot_async: bad trace")
    check(sdot_async["final_err"] <= sdot_async["limit"],
          f"sdot_async: final error {sdot_async['final_err']} > "
          f"{sdot_async['limit']}")
    on_ref = sdot_async["reference_masks"]
    check(on_ref["final_err"] <= on_ref["limit"], "sdot_async on the "
          f"reference's masks: final error {on_ref['final_err']} > "
          f"{on_ref['limit']}")
    check(on_ref["max_trace_diff_vs_reference"] <= REF_TRACE_TOL,
          "sdot_async on the reference's masks: trace off the reference's "
          f"by {on_ref['max_trace_diff_vs_reference']}")
    check(res_a.ledger.p2p == realized_sends
          and res_a.ledger.scalars == realized_sends * d * r,
          "sdot_async: the ledger is not the sum of the realized sends")
    check(len(res_a.ledger.awake_counts) == rounds_total
          and sum(res_a.ledger.awake_counts) == float(state_a.counts.sum()),
          "sdot_async: awake counts differ from the RunState's")
    check(sdot_async["all_awake"]["max_trace_diff_vs_sync"] <= FAULT_FREE_TOL,
          "sdot_async: an all-awake run strays from sync S-DOT's trace")
    emit(profile_phase(lambda: sdot(
        engine=AsyncConsensus(graph, p_awake, seed=0, device=dev),
        **dict(sdot_kw, t_outer=5)), "profile_sdot_async",
        "sdot_async S-DOT, T_o = 5, t_c = 50", groups=psa_groups))

    # -- sdot_faulty: the fault layer under S-DOT ----------------------------
    model = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5, p_corrupt=0.02,
                          corrupt_mode="nan", crash_windows=((0, 3, 3),))

    def faulty(debias="realized", faults=model):
        return FaultyConsensus(graph, faults, seed=7, debias=debias,
                               device=dev)

    sdot_faulty = {}
    for debias in ("realized", "nominal"):
        res_f, wall_f, launches = timed_run(lambda: sdot(
            engine=faulty(debias), **sdot_kw))
        count_path(f"sdot_faulty {debias}", launches,
                   {"batched_gram_apply": t_outer,
                    "gram_qr": QR_PASSES * t_outer})
        check(np.isfinite(res_f.error_trace).all(),
              f"sdot_faulty {debias}: bad trace")
        check(res_f.ledger.payload_bytes == 4 * res_f.ledger.scalars
              and res_f.ledger.scalars == res_f.ledger.p2p * d * r,
              f"sdot_faulty {debias}: ledger not priced at 4 bytes")
        sdot_faulty[debias] = {
            "wall_s": wall_f, "final_err": float(res_f.error_trace[-1]),
            "limit": ref_limit(f"sdot_faulty_{debias}"),
            "reference_cpu_final_err": REF_FINAL_ERR[f"sdot_faulty_{debias}"],
            "err_at": {str(t): float(res_f.error_trace[t - 1])
                       for t in (1, 10, 25, 50, 100)},
            "realized_sends": res_f.ledger.p2p,
            "nominal_sends": float(graph.adjacency.sum()) * rounds_total,
            "mean_up_nodes": res_f.ledger.mean_awake(),
            "launches": {k: launches[k] for k in ("batched_gram_apply",
                                                   "gram_qr")}}
    # node 0 is down in steps 3-5: one chunked run stopped at step 3, then
    # resumed to 6 on the same manager
    ckpt_freeze = (Path(__file__).resolve().parent / "build"
                   / "chip_smoke_freeze")
    shutil.rmtree(ckpt_freeze, ignore_errors=True)
    mgr_freeze = CheckpointManager(str(ckpt_freeze))
    at3 = runtime.run_chunked(sdot_program(engine=faulty(), **sdot_kw),
                              mgr_freeze, chunk_size=10, target_step=3)
    at6 = runtime.run_chunked(sdot_program(engine=faulty(), **sdot_kw),
                              mgr_freeze, chunk_size=10, target_step=6)
    shutil.rmtree(ckpt_freeze, ignore_errors=True)
    short = dict(sdot_kw, t_outer=20)
    e_fused, e_eager = faulty(), faulty()
    fused20 = sdot(engine=e_fused, **short)
    eager20 = sdot(engine=e_eager, fused=False, **short)
    clean = sdot(engine=faulty(faults=NetFaultModel()), **sdot_kw)
    sdot_faulty.update(
        model={"p_drop": 0.2, "p_bad": 0.05, "p_good": 0.5,
               "p_corrupt": 0.02, "corrupt_mode": "nan",
               "crash_windows": [[0, 3, 3]], "seed": 7},
        nominal_worse_than_realized=(sdot_faulty["nominal"]["final_err"]
                                     > sdot_faulty["realized"]["final_err"]),
        node0_frozen_steps_3_to_6=bool(torch.equal(at3.q_nodes[0],
                                                   at6.q_nodes[0])),
        node1_moved_steps_3_to_6=not torch.equal(at3.q_nodes[1],
                                                 at6.q_nodes[1]),
        fused_equals_eager_t20=bool(
            torch.equal(fused20.q_nodes, eager20.q_nodes)
            and np.array_equal(fused20.error_trace, eager20.error_trace)
            and fused20.ledger == eager20.ledger
            and torch.equal(e_fused._ge, e_eager._ge)
            and e_fused._key.tolist() == e_eager._key.tolist()),
        fault_free_max_trace_diff_vs_sync=float(np.abs(
            clean.error_trace - sdot_trace).max()))
    emit({"phase": "sdot_faulty", **sdot_faulty})
    for debias in ("realized", "nominal"):
        run_ = sdot_faulty[debias]
        check(run_["final_err"] <= run_["limit"], f"sdot_faulty {debias}: "
              f"final error {run_['final_err']} > {run_['limit']}")
    for key in ("node0_frozen_steps_3_to_6", "node1_moved_steps_3_to_6",
                "fused_equals_eager_t20"):
        check(sdot_faulty[key], f"sdot_faulty: {key} is false")
    check(sdot_faulty["fault_free_max_trace_diff_vs_sync"] <= FAULT_FREE_TOL,
          "sdot_faulty: a fault-free run strays from sync S-DOT's trace")
    # T_o cut from 5 to 4 (PR 26, the script's time): the plan's crash
    # window starts at step 3
    emit(profile_phase(lambda: sdot(engine=faulty(),
                                    **dict(sdot_kw, t_outer=4)),
                       "profile_sdot_faulty",
                       "sdot_faulty S-DOT, T_o = 4, t_c = 50",
                       groups=psa_groups))

    # -- fdot_faulty: the fault layer under F-DOT ----------------------------
    fdot_kw = dict(data_blocks=fslabs, r=r, t_outer=t_outer, t_c=50,
                   t_c_qr=t_qr, q_init=q_init, q_true=q_true, device=dev)
    res_ff, wall_ff, launches = timed_run(lambda: fdot(engine=faulty(),
                                                       **fdot_kw))
    count_path("fdot_faulty", launches,
               {"batched_slab_tq": t_outer, "batched_slab_apply": t_outer,
                "gram_qr": QR_PASSES * t_outer})
    q_full = res_ff.q_full
    fdot_faulty = {
        "wall_s": wall_ff, "final_err": float(res_ff.error_trace[-1]),
        "limit": ref_limit("fdot_faulty"),
        "limit_reason": "10x the reference's final error on the CPU",
        "reference_cpu_final_err": REF_FINAL_ERR["fdot_faulty"],
        "err_at": {str(t): float(res_ff.error_trace[t - 1])
                   for t in (1, 10, 25, 50, 100)},
        "orthonormality_err": float(
            (q_full.T @ q_full - torch.eye(r, device=dev)).abs().max()),
        "mean_up_nodes": res_ff.ledger.mean_awake(),
        "launches": {k: launches[k] for k in ("batched_slab_tq",
                                               "batched_slab_apply",
                                               "gram_qr")}}
    emit({"phase": "fdot_faulty", **fdot_faulty})
    check(np.isfinite(res_ff.error_trace).all()
          and res_ff.error_trace.shape == (t_outer,), "fdot_faulty: bad trace")
    check(fdot_faulty["final_err"] <= fdot_faulty["limit"],
          f"fdot_faulty: final error {fdot_faulty['final_err']} > "
          f"{fdot_faulty['limit']}")
    check(fdot_faulty["orthonormality_err"] <= 1e-5, "fdot_faulty: q_full "
          f"off orthonormal by {fdot_faulty['orthonormality_err']}")
    emit(profile_phase(lambda: fdot(engine=faulty(),
                                    **dict(fdot_kw, t_outer=4)),
                       "profile_fdot_faulty",
                       "fdot_faulty F-DOT, T_o = 4, t_c = t_c_qr = 50",
                       groups=psa_groups))
    del (res_a, state_a, res_ref, res_awake, at3, at6, fused20, eager20,
         clean, res_ff)

    # -- resume: kill and resume each family, the same bits -----------------
    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    # each entry: (program, chunked, q attribute, kernels, engines): the
    # engines are made anew for every run, as an async or faulty engine
    # leaves its stream (and burst state) where its run ended
    families = {
        "sdot": (sdot_program, sdot_chunked, "q_nodes", ("batched_gram_apply",),
                 lambda: dict(data=blocks, engine=eng)),
        "fdot": (fdot_program, fdot_chunked, "q_full",
                 ("batched_slab_tq", "batched_slab_apply"),
                 lambda: dict(data_blocks=fslabs, engine=eng, t_c_qr=t_qr)),
        "bdot": (bdot_program, bdot_chunked, "q_full",
                 ("grid_block_tq", "grid_block_apply"),
                 lambda: dict(blocks=grid, col_engines=col_engs,
                              row_engines=row_engs, t_c_qr=t_qr)),
        "sdot_faulty": (sdot_program, sdot_chunked, "q_nodes",
                        ("batched_gram_apply",),
                        lambda: dict(data=blocks, engine=faulty())),
        "fdot_async": (fdot_program, fdot_chunked, "q_full",
                       ("batched_slab_tq", "batched_slab_apply"),
                       lambda: dict(data_blocks=fslabs, t_c_qr=t_qr,
                                    engine=AsyncConsensus(
                                        graph, p_awake, seed=0, device=dev)))}
    # (i), (ii) and a run chunked by 10 with no checkpoints, each timed
    # once in the order i, bare, ii (twice, in turns, until PR 26 cut the
    # script's time); then (iii) and (iv): 5 whole runs
    chunk, kill_after, steps_run = 10, 4, 5 * t_outer

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same_bits(a, b, q_attr, iterate=True):
        """(run, engine) pairs: the trace, and the iterate, the ledger
        (with its awake counts) and the engine's burst state and stream."""
        (a, ea), (b, eb) = a, b
        ga, gb = getattr(ea, "_ge", None), getattr(eb, "_ge", None)
        return (torch.equal(torch.from_numpy(a.error_trace),
                            torch.from_numpy(b.error_trace))
                and (not iterate or (torch.equal(getattr(a, q_attr),
                                                 getattr(b, q_attr))
                                     and a.ledger == b.ledger
                                     and (ga is None or torch.equal(ga, gb))
                                     and (not hasattr(ea, "_key") or
                                          ea._key.tolist()
                                          == eb._key.tolist()))))

    resume = {}
    # async F-DOT has no error limit here (its trace is checked finite and
    # bitwise): the reference's own run reads 0.0258 at step 100 and up to
    # 0.877 over steps 51-100 (tools/reference_fault_errors.py)
    resume_limits = {"sdot_faulty": ref_limit("sdot_faulty_realized"),
                     "fdot_async": 1.0}
    for fam, (program, chunked, q_attr, kernels, extra) in families.items():
        def kw():
            return dict(r=r, t_outer=t_outer, t_c=50, q_init=q_init,
                        q_true=q_true, device=dev, **extra())

        def with_engine(run, args):
            return run(**args), args.get("engine")

        ops.reset_launches()
        runs_, walls = {}, {"monolithic": [], "chunked_10": [],
                            "chunked_10_checkpointed": []}
        order = ("monolithic", "chunked_10", "chunked_10_checkpointed")
        for i, how in enumerate(order):
            if how == "monolithic":
                fn = lambda: with_engine(  # noqa: E731
                    lambda **a: runtime.run_monolithic(program(**a)), kw())
            elif how == "chunked_10":
                fn = lambda: with_engine(  # noqa: E731
                    lambda **a: chunked(chunk_size=chunk, **a), kw())
            else:
                mgr = CheckpointManager(str(ckpt_root / fam / f"ii{i}"))
                fn = lambda: with_engine(  # noqa: E731
                    lambda **a: chunked(chunk_size=chunk, manager=mgr, **a),
                    kw())
            runs_[how], wall = timed(fn)
            walls[how].append(wall)
        mono, bare, whole = (runs_["monolithic"], runs_["chunked_10"],
                             runs_["chunked_10_checkpointed"])
        wall = {how: statistics.mean(w) for how, w in walls.items()}
        with open(ckpt_root / fam / "ii2" / f"step_{t_outer:08d}"
                  / "manifest.json") as f:
            manifest = json.load(f)
        state_bytes = sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                          for shape, dt in zip(manifest["shapes"],
                                               manifest["dtypes"]))
        mgr_kill = CheckpointManager(str(ckpt_root / fam / "iii"))
        killed = chunked(chunk_size=chunk, manager=mgr_kill,
                         max_chunks=kill_after, **kw())
        killed_at = mgr_kill.latest_step()
        resumed = with_engine(lambda **a: chunked(
            chunk_size=chunk, manager=mgr_kill, **a), kw())
        seven = with_engine(lambda **a: chunked(chunk_size=7, **a), kw())
        torch.cuda.synchronize()
        tma_only(f"resume {fam}", dict(ops.LAUNCHES))
        launches = {k: ops.LAUNCHES[k] for k in (*kernels, "gram_qr")}
        # two CholeskyQR passes a step in every family
        want = {**{k: steps_run for k in kernels}, "gram_qr": 2 * steps_run}
        n_chunks = t_outer / chunk
        resume[fam] = {
            "wall_s": walls, "wall_s_mean": wall,
            "chunking_ms_per_chunk": (wall["chunked_10"] - wall["monolithic"])
            / n_chunks * 1e3,
            "checkpoint_ms_per_chunk": (wall["chunked_10_checkpointed"]
                                        - wall["chunked_10"]) / n_chunks * 1e3,
            "runstate_bytes": state_bytes, "killed_at_step": killed_at,
            "killed_trace_len": len(killed.error_trace),
            "final_err": float(mono[0].error_trace[-1]),
            "chunked_equals_i": same_bits(bare, mono, q_attr),
            "ii_equals_i": same_bits(whole, mono, q_attr),
            "iii_equals_i": same_bits(resumed, mono, q_attr),
            "iv_trace_equals_i": same_bits(seven, mono, q_attr, False),
            "iv_iterate_equals_i": same_bits(seven, mono, q_attr),
            "launches": launches, "launches_expected": want}
        for k, count in launches.items():
            rows[k]["launches"] += count
    shutil.rmtree(ckpt_root, ignore_errors=True)
    # the error trace's SVDs: the runtime takes one batched call a chunk,
    # which keeps resume bitwise only while cuSOLVER's result for a matrix
    # does not depend on the batch it is in; one call a step would not need
    # that, at the cost timed here. S-DOT hands it (L, N, r, r) crosses,
    # F-DOT and B-DOT (L, r, r): L = 1 (a one-step chunk or remainder) is a
    # batch of one, which may take another cuSOLVER routine
    crosses = {"sdot": torch.randn((t_outer, n_nodes, r, r), generator=gen,
                                   device=dev),
               "fdot_bdot": torch.randn((t_outer, r, r), generator=gen,
                                        device=dev)}

    def svd_per_step():
        for c in crosses["sdot"]:
            torch.linalg.svdvals(c)

    def chunked_equals_whole(c, n):
        return bool(torch.equal(torch.cat([
            torch.linalg.svdvals(c[i:i + n]) for i in range(0, t_outer, n)]),
            torch.linalg.svdvals(c)))

    trace_svd = {
        "per_step_ms_a_run": timed(svd_per_step)[1] * 1e3,
        "one_batched_call_ms_a_run": timed(
            lambda: torch.linalg.svdvals(crosses["sdot"]))[1] * 1e3,
        "batched_by_chunks_of_equals_whole": {
            f"{fam}_{n}": chunked_equals_whole(crosses[fam], n)
            for fam, sizes in (("sdot", (1, 7, 10)),
                               ("fdot_bdot", (1, 2, 7, 10)))
            for n in sizes}}
    emit({"phase": "resume", "t_outer": t_outer, "t_c": 50,
          "chunk_size": chunk, "killed_after_chunks": kill_after,
          "families": resume, "trace_svd": trace_svd})
    for fam, res in resume.items():
        for key in ("chunked_equals_i", "ii_equals_i", "iii_equals_i",
                    "iv_trace_equals_i", "iv_iterate_equals_i"):
            check(res[key], f"resume {fam}: {key} is false")
        check(res["killed_at_step"] == kill_after * chunk
              and res["killed_trace_len"] == kill_after * chunk,
              f"resume {fam}: the killed run stopped at "
              f"{res['killed_at_step']}")
        # a resume that did not restore would run kill_after * chunk more
        check(res["launches"] == res["launches_expected"],
              f"resume {fam}: launches {res['launches']}, expected "
              f"{res['launches_expected']}")
        limit = resume_limits.get(fam, SUBSPACE_TOL)
        check(res["final_err"] <= limit,
              f"resume {fam}: final error {res['final_err']} > {limit}")
    check(all(trace_svd["batched_by_chunks_of_equals_whole"].values()),
          "resume: a matrix's batched singular values depend on its batch")

    # -- baselines: the paper's comparison methods (Figs. 4-6) --------------
    ref_b = np.load(Path(__file__).resolve().parent / "tools" / "data"
                    / "baselines_reference.npz")
    b_init = torch.as_tensor(ref_b["q_init"], device=dev)
    covs = torch.stack([b @ b.T / b.shape[1] for b in blocks])  # (20, d, d)
    ipv = 100 // r
    b_kw = {"seq_dist_pm": dict(iters_per_vec=ipv, t_c=50),
            "dsa": dict(t_outer=500, lr=0.05),
            "dpgd": dict(t_outer=500, lr=0.05),
            "deepca": dict(t_outer=100, t_mix=3),
            "d_pm": dict(iters_per_vec=ipv, t_c=50)}
    # Gram launches a step: CholeskyQR2 (two passes) in DPGD and DeEPCA
    b_qr = {"dpgd": 2, "deepca": 2}

    def baseline_call(name, fused, ledger):
        data_arg = fslabs if name == "d_pm" else covs
        return getattr(baselines, name)(
            data_arg, eng, r, q_true=q_true, q_init=b_init, ledger=ledger,
            fused=fused, device=dev, **b_kw[name])

    def vs_reference(name, trace, wall, launches):
        want = ref_b[f"trace_{name}"]
        limit = (SUBSPACE_TOL if want[-1] <= SUBSPACE_TOL
                 else 10 * float(want[-1]))
        return {"wall_s": wall, "final_err": float(trace[-1]),
                "ref_final_err": float(want[-1]), "final_err_limit": limit,
                "steps": len(trace),
                "max_abs_err_vs_ref_trace": float(np.abs(
                    np.asarray(trace, np.float64) - want).max()),
                "launches": launches}

    base = {}
    (q_pm, e_pm), wall, launches = timed_run(lambda: baselines.seq_pm(
        covs.sum(0), r, ipv, q_true=q_true, q_init=b_init, device=dev))
    base["seq_pm"] = vs_reference("seq_pm", e_pm, wall, launches["gram_qr"])
    for name in b_kw:
        led_f, led_e = CommLedger(), CommLedger()
        (q_f, e_f), wall, launches = timed_run(
            lambda: baseline_call(name, True, led_f))
        (q_e, e_e), wall_e, _ = timed_run(
            lambda: baseline_call(name, False, led_e))
        steps = len(e_f)
        out = vs_reference(name, e_f, wall, launches["gram_qr"])
        out.update(
            eager_wall_s=wall_e,
            max_abs_err_vs_eager=float(np.abs(e_f - e_e).max()),
            ledger_equals_eager=led_f == led_e,
            gram_qr_expected=b_qr.get(name, 0) * steps)
        base[name] = out
        if name in b_qr:
            rows["gram_qr"]["launches"] += launches["gram_qr"]
    # DeEPCA through baseline_chunked: chunked by 10, killed after 4 chunks
    # and resumed; the whole run for its final (q, s, mq_prev) carry
    dp_kw = dict(covs=covs, engine=eng, r=r, q_true=q_true, q_init=b_init,
                 device=dev, **b_kw["deepca"])
    whole, whole_state = with_state(baselines.baseline_program(
        "deepca", **dp_kw))
    mgr_dp = CheckpointManager(str(ckpt_root / "deepca"))
    baseline_chunked("deepca", chunk_size=10, manager=mgr_dp, max_chunks=4,
                     **dp_kw)
    killed_at = mgr_dp.latest_step()
    resumed = baseline_chunked("deepca", chunk_size=10, manager=mgr_dp,
                               **dp_kw)
    final_state, _ = mgr_dp.restore(whole_state)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    base["deepca_resume"] = {
        "killed_at_step": killed_at,
        "trace_equal": bool(np.array_equal(resumed.error_trace,
                                           whole.error_trace)),
        "q_equal": bool(torch.equal(resumed.q, whole.q)),
        "ledger_equal": resumed.ledger == whole.ledger,
        "carry_equal": all(torch.equal(a.to(dev), b) for a, b in zip(
            final_state.q, whole_state.q))}
    emit({"phase": "baselines", "d": d, "r": r, "nodes": n_nodes,
          "samples": n_total, "iters_per_vec": ipv,
          "fused_vs_eager_tol": BASELINE_EAGER_TOL,
          "ref_trace_tol": BASELINE_REF_TRACE_TOL, "methods": base})
    for name, out in base.items():
        if name == "deepca_resume":
            check(out["killed_at_step"] == 40 and all(
                out[k] for k in ("trace_equal", "q_equal", "ledger_equal",
                                 "carry_equal")),
                  f"baselines: DeEPCA's chunked resume differs: {out}")
            continue
        check(out["final_err"] <= out["final_err_limit"],
              f"baselines {name}: final error {out['final_err']} > "
              f"{out['final_err_limit']}")
        check(out["max_abs_err_vs_ref_trace"] <= BASELINE_REF_TRACE_TOL,
              f"baselines {name}: trace {out['max_abs_err_vs_ref_trace']} "
              f"from the reference's")
        if name == "seq_pm":
            continue
        check(out["max_abs_err_vs_eager"] <= BASELINE_EAGER_TOL,
              f"baselines {name}: fused trace {out['max_abs_err_vs_eager']}"
              " from the eager one")
        check(out["ledger_equals_eager"], f"baselines {name}: ledgers differ")
        check(out["launches"] == out["gram_qr_expected"],
              f"baselines {name}: {out['launches']} Gram launches, expected "
              f"{out['gram_qr_expected']}")

    # -- sweeps: the Monte-Carlo engine at the CIFAR-10 width ----------------
    # each lane dispatch against its plain version at the sweeps' shapes:
    # gram-apply over 12 lanes at sdot_dense's, slab tq and apply over 4
    # at fdot_dense's (the slab tq kernel takes every lane in one launch)
    x_stack, n_true = _stack_data(blocks, dev)
    x_pad = pad_feature_slabs(fslabs)
    q_lanes = torch.linalg.qr(torch.randn((12, n_nodes, d, r), generator=gen,
                                          device=dev))[0].contiguous()
    fq_lanes = torch.randn((4, n_nodes, x_pad.shape[1], r), generator=gen,
                           device=dev)
    s_lanes = torch.randn((4, n_nodes, n_total, r), generator=gen,
                          device=dev)
    lane_kernels = {
        "gram_apply": (lambda: ops.lane_gram_apply(x_stack, q_lanes, n_true),
                       lambda: torch.stack([ref.batched_gram_apply_ref(
                           x_stack, q, n_true) for q in q_lanes]), 1),
        "slab_tq": (lambda: ops.lane_slab_tq(x_pad, fq_lanes),
                    lambda: torch.stack([ref.batched_slab_tq_ref(x_pad, q)
                                         for q in fq_lanes]),
                    ops.lane_fold_width(4, r)),
        "slab_apply": (lambda: ops.lane_slab_apply(x_pad, s_lanes),
                       lambda: torch.stack([ref.batched_slab_apply_ref(
                           x_pad, s) for s in s_lanes]), 1)}
    lane_dispatch = {}
    for kind, (kernel, plain, per_launch) in lane_kernels.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        lane_dispatch[kind] = {
            "lanes": int(got.shape[0]), "lanes_a_launch": per_launch,
            "ms": time_ms(kernel, reps=5), "plain_ms": time_ms(plain, reps=5),
            "rel_err": float((got - want).abs().max() / want.abs().max())}
        check(lane_dispatch[kind]["rel_err"] <= GRAM_TOL,
              f"lane dispatch {kind}: {lane_dispatch[kind]}")
    del x_stack, x_pad, q_lanes, fq_lanes, s_lanes, got, want

    ring_eng = DenseConsensus(topology.ring(n_nodes), device=dev)
    lin2 = consensus_schedule("lin2", t_outer, cap=50)
    const = consensus_schedule("const", t_outer, t_max=50)
    cases = [("er_const", eng, const), ("er_lin2_cap50", eng, lin2),
             ("ring_const", ring_eng, const)]
    sw_seeds = [0, 1, 2, 3]
    sw_kw = dict(data=blocks, engines=[c[1] for c in cases],
                 schedules=[c[2] for c in cases], r=r, t_outer=t_outer,
                 q_true=q_true)

    def per_seed(run, cases_, seeds):
        """Each lane's own single run: (results by (case, seed), wall,
        merged ledger)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, ledger = {}, CommLedger()
        for ci, case in enumerate(cases_):
            for si, s in enumerate(seeds):
                out[ci, si] = run(case, s)
                ledger = ledger.merged(out[ci, si].ledger)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ledger

    def lane_diffs(sw, singles, q_attr, node_counts=None):
        """The largest trace and iterate differences of the lanes from
        their single runs, and whether every lane is bitwise equal."""
        tr = qd = 0.0
        bitwise = True
        for (ci, si), res in singles.items():
            lane_tr = (sw.error_traces[ci, si] if sw.error_traces.ndim == 3
                       else sw.error_traces[si])
            lane_q = sw.q[ci, si] if sw.error_traces.ndim == 3 else sw.q[si]
            q1 = getattr(res, q_attr)
            if node_counts is not None:
                lane_q = lane_q[:node_counts[ci]]
            if q_attr == "q_blocks":
                q1 = pad_feature_slabs(q1)
            tr = max(tr, float(np.abs(lane_tr - res.error_trace).max()))
            qd = max(qd, float((lane_q - q1).abs().max()))
            bitwise &= (np.array_equal(lane_tr, res.error_trace)
                        and bool(torch.equal(lane_q, q1)))
        return {"max_trace_diff": tr, "max_iterate_diff": qd,
                "bitwise": bitwise}

    sweeps = {}
    sw_sdot, wall, launches = timed_run(
        lambda: sweep.sdot_sweep(seeds=sw_seeds, **sw_kw))
    # one gram-apply launch a lane a step: 12 x 100 = 1,200
    count_path("sweeps sdot", launches, {
        "batched_gram_apply": t_outer * len(cases) * len(sw_seeds),
        "gram_qr": QR_PASSES * t_outer})
    singles, wall_1, led_1 = per_seed(lambda case, s: sdot(
        data=blocks, engine=case[1], schedule=case[2], r=r, t_outer=t_outer,
        generator=torch.Generator().manual_seed(s), q_true=q_true,
        device=dev), cases, sw_seeds)
    shard, _, _ = timed_run(lambda: sweep.sdot_sweep(seeds=[2, 3], **sw_kw))
    mgr_sw = CheckpointManager(str(ckpt_root / "sweep"))
    sweep.sdot_sweep(seeds=sw_seeds, manager=mgr_sw, chunk_size=10,
                     max_chunks=4, **sw_kw)
    sw_resumed = sweep.sdot_sweep(seeds=sw_seeds, manager=mgr_sw,
                                  chunk_size=10, **sw_kw)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    sweeps["sdot"] = {
        "cases": [c[0] for c in cases], "seeds": sw_seeds,
        "lanes": len(cases) * len(sw_seeds), "wall_s": wall,
        "per_seed_loop_wall_s": wall_1,
        "launches": {k: launches[k] for k in ("batched_gram_apply",
                                              "gram_qr")},
        "final_err": {c[0]: sw_sdot.error_traces[ci, :, -1].tolist()
                      for ci, c in enumerate(cases)},
        "vs_per_seed": lane_diffs(sw_sdot, singles, "q_nodes"),
        "ledger_equals_per_seed_sum": sw_sdot.ledger == led_1,
        "shard_2_3": {
            "bitwise": bool(np.array_equal(shard.error_traces,
                                           sw_sdot.error_traces[:, 2:])
                            and torch.equal(shard.q, sw_sdot.q[:, 2:])),
            "max_trace_diff": float(np.abs(
                shard.error_traces - sw_sdot.error_traces[:, 2:]).max())},
        "resume": {
            "resumed_step": sw_resumed.resumed_step,
            "bitwise": bool(np.array_equal(sw_resumed.error_traces,
                                           sw_sdot.error_traces)
                            and torch.equal(sw_resumed.q, sw_sdot.q)
                            and sw_resumed.ledger == sw_sdot.ledger)}}

    sw_fdot, wall, launches = timed_run(lambda: sweep.fdot_sweep(
        data_blocks=fslabs, engines=eng, r=r, t_outer=t_outer, t_c=50,
        seeds=sw_seeds, q_true=q_true))
    # 4 lanes x 7 columns fold into one slab tq launch a step (100); slab
    # apply launches once a lane a step (400)
    count_path("sweeps fdot", launches, {
        "batched_slab_tq": t_outer,
        "batched_slab_apply": t_outer * len(sw_seeds),
        "gram_qr": QR_PASSES * t_outer})
    singles, wall_1, led_1 = per_seed(lambda case, s: fdot(
        data_blocks=fslabs, engine=eng, r=r, t_outer=t_outer, t_c=50,
        generator=torch.Generator().manual_seed(s), q_true=q_true,
        device=dev), [None], sw_seeds)
    sweeps["fdot"] = {
        "seeds": sw_seeds, "lanes": len(sw_seeds), "wall_s": wall,
        "per_seed_loop_wall_s": wall_1,
        "launches": {k: launches[k] for k in ("batched_slab_tq",
                                              "batched_slab_apply",
                                              "gram_qr")},
        "final_err": sw_fdot.error_traces[:, -1].tolist(),
        "vs_per_seed": lane_diffs(sw_fdot, singles, "q_blocks"),
        "ledger_equals_per_seed_sum": sw_fdot.ledger == led_1}

    eng10 = DenseConsensus(topology.erdos_renyi(10, 0.5, seed=1), device=dev)
    covs10 = torch.stack([b @ b.T / b.shape[1]
                          for b in partition_samples(x, 10)])
    rg_cases = [("er10", eng10, covs10), ("er20", eng, covs)]
    rg_seeds = [0, 1]
    sw_rg, wall, launches = timed_run(lambda: sweep.baseline_sweep(
        "deepca", covs=[c[2] for c in rg_cases],
        engines=[c[1] for c in rg_cases], r=r, t_outer=t_outer, t_mix=3,
        seeds=rg_seeds, q_true=q_true))
    count_path("sweeps deepca", launches, {"gram_qr": QR_PASSES * t_outer})
    def deepca_single(case, s):
        led = CommLedger()
        q1, e1 = baselines.deepca(case[2], case[1], r, t_outer, t_mix=3,
                                  q_true=q_true, seed=s, ledger=led,
                                  device=dev)
        return SimpleNamespace(q=q1, error_trace=e1, ledger=led)

    singles, wall_1, led_1 = per_seed(deepca_single, rg_cases, rg_seeds)
    sweeps["deepca_ragged"] = {
        "cases": [c[0] for c in rg_cases], "node_counts":
        sw_rg.node_counts.tolist(), "seeds": rg_seeds, "wall_s": wall,
        "per_seed_loop_wall_s": wall_1,
        "launches": {"gram_qr": launches["gram_qr"]},
        "final_err": sw_rg.error_traces[:, :, -1].tolist(),
        "vs_per_seed": lane_diffs(sw_rg, singles, "q", sw_rg.node_counts),
        "ledger_equals_per_seed_sum": sw_rg.ledger == led_1}
    del covs10

    nf_cases = [(f"p_drop_{p}", FaultyConsensus(
        graph, dataclasses.replace(model, p_drop=p), seed=7, device=dev))
        for p in (0.1, 0.2)]
    nf_seeds, t_nf = [0, 1], 20
    nf_kw = dict(covs=covs, engines=[c[1] for c in nf_cases], r=r,
                 t_outer=t_nf, t_c=50, q_true=q_true)
    sw_nf, wall, launches = timed_run(lambda: sweep.netfault_sweep(
        seeds=nf_seeds, **nf_kw))
    count_path("sweeps netfault", launches, {"gram_qr": QR_PASSES * t_nf})
    singles, wall_1, led_1 = per_seed(lambda case, s: sdot(
        covs=covs, r=r, t_outer=t_nf, t_c=50, q_true=q_true, device=dev,
        generator=torch.Generator().manual_seed(s),
        engine=FaultyConsensus(graph, case[1].faults, device=dev,
                               seed=sweep.netfault_lane_seed(7, s))),
        nf_cases, nf_seeds)
    nf_shard, _, _ = timed_run(lambda: sweep.netfault_sweep(seeds=[1],
                                                            **nf_kw))
    sweeps["netfault"] = {
        "cases": [c[0] for c in nf_cases], "seeds": nf_seeds,
        "t_outer": t_nf, "wall_s": wall, "per_seed_loop_wall_s": wall_1,
        "launches": {"gram_qr": launches["gram_qr"]},
        "final_err": sw_nf.error_traces[:, :, -1].tolist(),
        "vs_per_seed": lane_diffs(sw_nf, singles, "q_nodes"),
        "ledger_equals_per_seed_sum": sw_nf.ledger == led_1,
        "shard_1_bitwise": bool(
            np.array_equal(nf_shard.error_traces, sw_nf.error_traces[:, 1:])
            and torch.equal(nf_shard.q, sw_nf.q[:, 1:]))}
    emit({"phase": "sweeps", "lane_tol": SWEEP_LANE_TOL,
          "lane_dispatch": lane_dispatch, "sweeps": sweeps,
          "gram_qr_routes": dict(gram_qr.ROUTE_LAUNCHES)})
    emit(profile_phase(
        lambda: sweep.sdot_sweep(seeds=sw_seeds, **{**sw_kw, "t_outer": 10}),
        "profile_sweep", "sweeps sdot_sweep, 3 cases x 4 seeds, T_o = 10",
        groups=psa_groups))
    for name, out in sweeps.items():
        vs = out["vs_per_seed"]
        check(vs["max_trace_diff"] <= SWEEP_LANE_TOL,
              f"sweeps {name}: a lane's trace {vs['max_trace_diff']} from "
              "its single run")
        # S-DOT's lanes keep every product's order (one gram-apply launch
        # and one cov product and cross product a lane, the Grams and
        # gossip rounds batched per matrix): the single run's bits
        check(vs["bitwise"] or name not in ("sdot", "netfault"),
              f"sweeps {name}: a lane differs from its single run")
        check(out["ledger_equals_per_seed_sum"],
              f"sweeps {name}: ledger differs from the per-seed sum")
    for ci, (label, _, _) in enumerate(cases):
        if label.startswith("er"):
            check(max(sweeps["sdot"]["final_err"][label]) <= SUBSPACE_TOL,
                  f"sweeps sdot {label}: final errors "
                  f"{sweeps['sdot']['final_err'][label]}")
    check(max(sweeps["fdot"]["final_err"]) <= SUBSPACE_TOL,
          f"sweeps fdot: final errors {sweeps['fdot']['final_err']}")
    check(sweeps["sdot"]["shard_2_3"]["max_trace_diff"] <= SWEEP_LANE_TOL,
          "sweeps sdot: the shard of seeds [2, 3] differs from the grid")
    check(sweeps["sdot"]["resume"]["resumed_step"] == 40
          and sweeps["sdot"]["resume"]["bitwise"],
          f"sweeps sdot: chunked resume {sweeps['sdot']['resume']}")
    check(sweeps["netfault"]["shard_1_bitwise"],
          "sweeps netfault: the shard of seed 1 differs from the grid")
    del covs

    # -- fleet: the sweeps' S-DOT grid over worker processes on this card ----
    # launch_sweep of 3 cases x 4 seeds (T_o = 100) on the raw data, each
    # run's merge against the single-process sweep of each shard's seeds in
    # this process: pinned (2 workers, 2 shards); under run_smoke's plan
    # kinds (4 shards, sweep_chunk 20); elastic, a worker stealing a lease
    # left expired by a departed one, whose checkpoint it resumes
    fleet_root = Path(__file__).resolve().parent / "build" / \
        "chip_smoke_fleet"
    shutil.rmtree(fleet_root, ignore_errors=True)
    fl_cases = [{"topology": {"kind": "er", "n": n_nodes, "p": 0.25,
                              "seed": 1}},
                {"topology": {"kind": "er", "n": n_nodes, "p": 0.25,
                              "seed": 1},
                 "schedule": {"kind": "lin2", "cap": 50}},
                {"topology": {"kind": "ring", "n": n_nodes}}]
    fl_engines = [build_engine(c["topology"], device=dev) for c in fl_cases]
    fl_scheds = [build_schedule(c.get("schedule"), t_outer, 50)
                 for c in fl_cases]
    check([np.array_equal(a, b[2]) for a, b in zip(fl_scheds, cases)]
          == [True] * 3, "fleet: the specs' schedules differ from sweeps'")
    fl_kw = dict(data=blocks, cases=fl_cases, r=r, t_outer=t_outer, t_c=50,
                 seeds=sw_seeds, q_true=q_true, n_workers=2, device=dev)

    def shard_sweeps(n_shards):
        """The single-process sweep of each shard's seeds: (traces, q)."""
        parts = [sweep.sdot_sweep(data=blocks, engines=fl_engines,
                                  schedules=fl_scheds, r=r, t_outer=t_outer,
                                  t_c=50, seeds=s, q_true=q_true, device=dev)
                 for s in sweep.slice_seed_shards(sw_seeds, n_shards)]
        return (np.concatenate([p.error_traces for p in parts], axis=1),
                torch.cat([p.q.cpu() for p in parts], dim=1))

    def fleet_run(label, want, **kw):
        t0 = time.perf_counter()
        res = launch_sweep(workdir=str(fleet_root / label), **fl_kw, **kw)
        wall = time.perf_counter() - t0
        rep = res.resume_report
        out = {"wall_s": wall, "attempts": rep["attempts"],
               "worker_resumed_steps": rep["worker_resumed_steps"],
               "bitwise": bool(np.array_equal(res.error_traces, want[0])
                               and torch.equal(res.q, want[1])),
               "final_err": res.error_traces[:, :, -1].tolist()}
        for key in ("stolen_shards", "lease_owners"):
            if key in rep:
                out[key] = rep[key]
        return out

    fleet = {}
    want2, want4 = shard_sweeps(2), shard_sweeps(4)
    fleet["pinned"] = fleet_run("pinned", want2, n_shards=2)
    fleet["chaos"] = fleet_run("chaos", want4, n_shards=4, sweep_chunk=20,
                               retries=2, chaos_plan=smoke_plan(0))
    fleet["chaos"]["faults"] = [f["kind"] for f in smoke_plan(0).faults]
    # a worker that left shard 0 after its first chunk: its checkpoint at
    # step 20 and its lease, stamped 100 s ago on both clocks
    el_dir = fleet_root / "elastic"
    shard0 = sweep.slice_seed_shards(sw_seeds, 2)[0]
    sweep.sdot_sweep(data=blocks, engines=fl_engines, schedules=fl_scheds,
                     r=r, t_outer=t_outer, t_c=50, seeds=shard0,
                     q_true=q_true, device=dev, chunk_size=20, max_chunks=1,
                     manager=CheckpointManager(str(el_dir / "worker_0"
                                                   / "ckpt")))
    store = LeaseStore(str(el_dir), ttl=5.0)
    departed = store.try_acquire(0, "departed")
    departed.update(renewed_at=time.time() - 100.0,
                    renewed_mono=time.monotonic() - 100.0)
    store._write(0, dict(departed))
    fleet["elastic"] = fleet_run("elastic", want2, n_shards=2,
                                 sweep_chunk=20, elastic=True, lease_ttl=5.0)
    shutil.rmtree(fleet_root, ignore_errors=True)
    emit({"phase": "fleet", "cases": [c[0] for c in cases],
          "seeds": sw_seeds, "t_outer": t_outer, "workers": 2, **fleet})
    for label, out in fleet.items():
        check(out["bitwise"], f"fleet {label}: the merge differs from the "
              "single-process sweep of each shard")
    check(fleet["chaos"]["attempts"] == {0: 2, 1: 2, 2: 1, 3: 2},
          f"fleet chaos: attempts {fleet['chaos']['attempts']}")
    # shard 1's newest checkpoint (step 40) was torn at boundary 3
    check(fleet["chaos"]["worker_resumed_steps"][1] == 20,
          "fleet chaos: shard 1 did not fall back past its torn checkpoint")
    check(0 in fleet["elastic"]["stolen_shards"]
          and fleet["elastic"]["worker_resumed_steps"][0] == 20,
          f"fleet elastic: no steal of shard 0 from its step-20 state "
          f"{fleet['elastic']}")

    # -- streams_ingest, serving, serving_chaos, warm_start, profile_serving --
    serving_phases(dev, rows, Path(__file__).resolve().parent / "build"
                   / "chip_smoke_serving")

    # -- sdot_sparse: the large-network path ----------------------------------
    q_init_sp = orthonormal_init(torch.Generator().manual_seed(1), ds, rs,
                                 device=dev)
    common = dict(data=sp_blocks, r=rs, t_outer=t_sp, t_c=20,
                  q_init=q_init_sp, device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparse_res = sdot(engine=sp_eng, **common)
    torch.cuda.synchronize()
    wall_sparse = time.perf_counter() - t0
    launches_sparse = dict(ops.LAUNCHES)
    tma_only("sdot_sparse", launches_sparse, gram_packed=True)
    rounds = int(sparse_res.consensus_trace.sum())
    check(launches_sparse["ell_spmm"] == rounds + 20,
          f"sparse: {launches_sparse['ell_spmm']} ELL launches, expected "
          f"{rounds} rounds + 20 debias-table rows")
    check(launches_sparse["batched_gram_apply"] == t_sp,
          "sparse: gram-apply launches != T_o")
    check(launches_sparse["gram_qr"] == 2 * t_sp,
          "sparse: Gram launches != 2 T_o")
    for name in ("ell_spmm", "batched_gram_apply", "gram_qr"):
        rows[name]["launches"] += launches_sparse[name]
    to_small_n_gram(launches_sparse["batched_gram_apply"])

    dense_eng = DenseConsensus(sp_graph, sparse=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_res = sdot(engine=dense_eng, **common)
    torch.cuda.synchronize()
    wall_dense = time.perf_counter() - t0
    per_node = subspace_error(dense_res.q_nodes, sparse_res.q_nodes)
    check(bool(torch.isfinite(sparse_res.q_nodes).all()), "sparse: non-finite")
    check(float(per_node.max()) <= SUBSPACE_TOL,
          f"sparse vs dense engine: max per-node subspace error "
          f"{float(per_node.max())}")

    bf_eng = SparseConsensus(sp_graph, payload_dtype="bfloat16", device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    bf_res = sadot(engine=bf_eng, schedule_kind="lin2", cap=20,
                   **{k: v for k, v in common.items() if k != "t_c"})
    torch.cuda.synchronize()
    wall_bf = time.perf_counter() - t0
    launches_bf = dict(ops.LAUNCHES)
    tma_only("sdot_sparse bf16", launches_bf, gram_packed=True)
    rows["ell_spmm_bf16"]["launches"] += launches_bf["ell_spmm"]
    rows["batched_gram_apply"]["launches"] += launches_bf["batched_gram_apply"]
    rows["gram_qr"]["launches"] += launches_bf["gram_qr"]
    to_small_n_gram(launches_bf["batched_gram_apply"])
    check(bool(torch.isfinite(bf_res.q_nodes).all()), "bf16: non-finite")
    check(bf_res.ledger.payload_bytes == 2 * bf_res.ledger.scalars,
          "bf16: ledger does not price 2 bytes per element")
    check(launches_bf["ell_spmm"] > 0, "bf16: ELL kernel not launched")
    # the same SA-DOT lin2 run with f32 messages on the f32 engine: what
    # the bf16 payload alone moves
    ops.reset_launches()
    t0 = time.perf_counter()
    sa_res = sadot(engine=sp_eng, schedule_kind="lin2", cap=20,
                   **{k: v for k, v in common.items() if k != "t_c"})
    torch.cuda.synchronize()
    wall_sa = time.perf_counter() - t0
    launches_sa = dict(ops.LAUNCHES)
    tma_only("sdot_sparse sadot f32", launches_sa, gram_packed=True)
    for name in ("ell_spmm", "batched_gram_apply", "gram_qr"):
        rows[name]["launches"] += launches_sa[name]
    to_small_n_gram(launches_sa["batched_gram_apply"])
    bf_err = float(subspace_error(sa_res.q_nodes, bf_res.q_nodes).max())
    emit({"phase": "sdot_sparse", "nodes": n_sp, "d": ds, "r": rs,
          "samples_per_node": sp_blocks[0].shape[1], "t_outer": t_sp,
          "ell_width": sw.ell_width, "rounds": rounds,
          "wall_s": {"sparse_ell": wall_sparse, "dense_matmul": wall_dense,
                     "sadot_bf16": wall_bf, "sadot_f32": wall_sa},
          "launches": {"f32": launches_sparse, "bf16": launches_bf,
                       "sadot_f32": launches_sa},
          "max_node_subspace_err_vs_dense": float(per_node.max()),
          "bf16_vs_f32_runs": "SA-DOT lin2 cap 20, bf16 against f32 "
                              "messages, the same ELL graph and data",
          "bf16_vs_f32_max_node_err": bf_err,
          "bf16_vs_f32_tolerance": BF16_PAYLOAD_TOL})
    check(bool(torch.isfinite(sa_res.q_nodes).all()), "sadot f32: non-finite")
    check(bf_err <= BF16_PAYLOAD_TOL, f"sdot_sparse: SA-DOT with bf16 "
          f"messages {bf_err} from the f32 run (max per node) > "
          f"{BF16_PAYLOAD_TOL}")
    del sa_res

    # -- sparse_faulty: drops and bursts on the 4096-node overlay, ELL -------
    sp_model = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5)
    t_c_sp = 20
    sp_kw = dict(data=sp_blocks, r=rs, t_outer=t_sp, t_c=t_c_sp,
                 q_init=q_init_sp, device=dev)
    f_eng = FaultyConsensus(sp_graph, sp_model, seed=7, device=dev)
    check(f_eng.is_sparse, "FaultyConsensus(sparse=None) did not pick the "
          "ELL path for watts_strogatz(4096)")
    # the ELL kernel under a faulty round's operands: slot weights masked
    # at random (rows with every slot masked among them), a zero diagonal,
    # and rejected senders' messages zeroed
    z_msg = torch.randn((n_sp, k_payload), generator=gen, device=dev)
    z_msg[torch.rand(n_sp, generator=gen, device=dev) < 0.02] = 0.0
    keep = torch.rand(sw.ell_val.shape, generator=gen, device=dev) < 0.7
    keep[:64] = False
    val_masked = torch.where(keep, sw.ell_val, 0.0)
    zero_diag = torch.zeros_like(sw.diag)
    faulty_round_err = {}
    for name, payload in (("ell_spmm", None), ("ell_spmm_bf16", "bfloat16")):
        src = z_msg if payload is None else z_msg.to(torch.bfloat16)
        got = ops.ell_spmm(sw.ell_idx, val_masked, zero_diag, z_msg,
                           payload_dtype=payload, window=sw.window)
        want = ref.ell_spmm_ref(sw.ell_idx, val_masked, zero_diag, z_msg,
                                src)
        err = float((got - want).abs().max())
        faulty_round_err[name] = err
        check(err <= ELL_TOL * float(want.abs().max())
              and bool((got[:64] == 0).all()),
              f"{name}: a faulty round's operands, max abs err {err}")
    del z_msg, keep, val_masked
    # every outer step's draws, shared by the ELL engine and the dense one
    # (scattered to (t, N, N) blocks as each step asks for them)
    sp_draws = [f_eng._draw(k, t_c_sp) for k in range(t_sp)]

    class DenseDraws:
        def __len__(self):
            return len(sp_draws)

        def __getitem__(self, k):
            u_drop, u_burst, u_cor = sp_draws[k]
            return (slots_to_dense(sw.ell_idx, u_drop),
                    slots_to_dense(sw.ell_idx, u_burst), u_cor)

    res_sf, wall_sf, launches = timed_run(lambda: sdot(
        engine=f_eng, draws=sp_draws, **sp_kw))
    live_rounds = int(res_sf.consensus_trace.sum())
    count_path("sparse_faulty", launches,
               {"ell_spmm": live_rounds, "batched_gram_apply": t_sp,
                "gram_qr": QR_PASSES * t_sp}, gram_packed=True)
    to_small_n_gram(t_sp)
    res_sd, wall_sd, _ = timed_run(lambda: sdot(
        engine=FaultyConsensus(sp_graph, sp_model, seed=7, sparse=False,
                               device=dev), draws=DenseDraws(), **sp_kw))
    per_node_f = subspace_error(res_sd.q_nodes, res_sf.q_nodes)
    bf_f_eng = FaultyConsensus(sp_graph, sp_model, seed=7,
                               payload_dtype="bfloat16", device=dev)
    res_sb, wall_sb, launches_b = timed_run(lambda: sdot(
        engine=bf_f_eng, draws=sp_draws, **sp_kw))
    tma_only("sparse_faulty bf16", launches_b, gram_packed=True)
    check(launches_b["ell_spmm"] == live_rounds, "sparse_faulty bf16: "
          f"{launches_b['ell_spmm']} ELL launches, expected {live_rounds}")
    rows["ell_spmm_bf16"]["launches"] += launches_b["ell_spmm"]
    for name in ("batched_gram_apply", "gram_qr"):
        rows[name]["launches"] += launches_b[name]
    to_small_n_gram(launches_b["batched_gram_apply"])
    emit({"phase": "sparse_faulty", "nodes": n_sp, "d": ds, "r": rs,
          "t_outer": t_sp, "t_c": t_c_sp, "ell_width": sw.ell_width,
          "model": {"p_drop": 0.2, "p_bad": 0.05, "p_good": 0.5, "seed": 7},
          "live_rounds": live_rounds,
          "wall_s": {"ell_f32": wall_sf, "dense_matmul": wall_sd,
                     "ell_bf16": wall_sb},
          "launches": {"f32": launches, "bf16": launches_b},
          "ell_faulty_round_max_abs_err": faulty_round_err,
          "realized_sends": res_sf.ledger.p2p,
          "mean_up_nodes": res_sf.ledger.mean_awake(),
          "max_node_subspace_err_vs_dense": float(per_node_f.max()),
          "bf16_vs_f32_max_node_err": float(
              subspace_error(res_sf.q_nodes, res_sb.q_nodes).max()),
          "bf16_payload_bytes_per_scalar": (res_sb.ledger.payload_bytes
                                            / res_sb.ledger.scalars)})
    check(bool(torch.isfinite(res_sf.q_nodes).all()),
          "sparse_faulty: non-finite")
    check(float(per_node_f.max()) <= SUBSPACE_TOL,
          f"sparse_faulty: ELL vs dense engine, max per-node subspace error "
          f"{float(per_node_f.max())}")
    check(bool(torch.isfinite(res_sb.q_nodes).all()),
          "sparse_faulty bf16: non-finite")
    check(res_sb.ledger.payload_bytes == 2 * res_sb.ledger.scalars,
          "sparse_faulty bf16: ledger does not price 2 bytes per element")
    bf_err = float(subspace_error(res_sf.q_nodes, res_sb.q_nodes).max())
    check(bf_err <= BF16_PAYLOAD_TOL, f"sparse_faulty: bf16 messages "
          f"{bf_err} from the f32 run (max per node) > {BF16_PAYLOAD_TOL}")
    del f_eng, bf_f_eng, sp_draws, res_sf, res_sd, res_sb
    sp_row = rows["batched_gram_apply_sdot_sparse"]
    check(sp_row["launches"] == sp_row["packed_launches"]
          == SPARSE_GRAM_LAUNCHES * t_sp,
          f"row 1 at sdot_sparse's stack: {sp_row['launches']} launches, "
          f"{sp_row['packed_launches']} packed, expected "
          f"{SPARSE_GRAM_LAUNCHES * t_sp} on the packed route")

    # -- bdot_sparse: B-DOT over a 4 x 4096 grid, stacked sparse row engines --
    # sdot_sparse's MNIST-width data: 4 feature slabs of 196 by 4,096 sample
    # columns of 14 (57,344 of the 60,000 samples, as partition_samples cuts
    # them). Each row engine gossips over watts_strogatz(4096, 6, 0.1) of
    # its own seed, so the stage is one stacked SparseW; the column engine
    # is complete(4), repeated over the 4,096 columns
    bs_i, bs_j, t_c_bs = 4, n_sp, 20
    sp_grid = [partition_samples(sl, bs_j)
               for sl in partition_features(xs, bs_i)]
    x_used = torch.cat(sp_blocks, dim=1).double()
    qs_true = torch.linalg.eigh(x_used @ x_used.T)[1][:, -rs:].flip(-1) \
        .float().contiguous()
    del x_used

    def bs_rows(sparse=None):
        return [DenseConsensus(topology.watts_strogatz(n_sp, k=6, p=0.1,
                                                       seed=s),
                               sparse=sparse, device=dev)
                for s in (1, 2, 3, 4)]

    def max_angle_f64(a, b):
        qa, qb = (torch.linalg.qr(q.double())[0] for q in (a, b))
        s = torch.linalg.svdvals(qa.T @ qb).clamp(-1.0, 1.0)
        return float(torch.arccos(s).max())

    col_bs = [DenseConsensus(topology.complete(bs_i), device=dev)] * bs_j
    row_sp = bs_rows()
    check(all(e.is_sparse for e in row_sp), "bdot_sparse: a row engine of "
          "watts_strogatz(4096) did not pick the ELL path")
    bs_kw = dict(blocks=sp_grid, col_engines=col_bs, r=rs, t_outer=t_sp,
                 t_c=t_c_bs, q_init=q_init_sp, q_true=qs_true, device=dev)
    # the grid kernels at this launch (J = 4,096 blocks of 14 columns,
    # padded to 16 on the card) take the packed route: their rows, against
    # the plain versions and the library's batched matmul
    x_bs = pad_grid_blocks(sp_grid, 4)
    q_bs = torch.randn((bs_i, x_bs.shape[2], rs), generator=gen, device=dev)
    s_bs = torch.randn((bs_j, x_bs.shape[3], rs), generator=gen, device=dev)
    packed_plans = {k: slab_ops.packed_plan(k, bs_i * bs_j, bs_j,
                                            x_bs.shape[2], x_bs.shape[3], rs,
                                            *_launch.card(0))
                    for k in ("tq", "apply")}
    check(all(p.route == "packed" for p in packed_plans.values()),
          f"bdot_sparse: the planner did not pick the packed route "
          f"{packed_plans}")
    record("grid_block_tq_packed", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:148",
           lambda: ops.grid_block_tq(x_bs, q_bs),
           lambda: ref.grid_block_tq_ref(x_bs, q_bs),
           lambda: torch.matmul(x_bs.mT, q_bs[:, None]),
           f32 * (x_bs.numel() + q_bs.numel()
                  + bs_i * bs_j * x_bs.shape[3] * rs),
           2.0 * x_bs.numel() * rs, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |Z|",
           host=True)
    record("grid_block_apply_packed",
           "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:198",
           lambda: ops.grid_block_apply(x_bs, s_bs),
           lambda: ref.grid_block_apply_ref(x_bs, s_bs),
           lambda: torch.matmul(x_bs, s_bs[None]),
           f32 * (x_bs.numel() + s_bs.numel()
                  + bs_i * bs_j * x_bs.shape[2] * rs),
           2.0 * x_bs.numel() * rs, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|",
           host=True)
    for name, k in (("grid_block_tq_packed", "tq"),
                    ("grid_block_apply_packed", "apply")):
        pl = packed_plans[k]
        rows[name].update(
            shape=list(x_bs.shape) + [rs], packed_launches=0,
            plan={f: getattr(pl, f) for f in (
                "vec", "upl", "unit_lanes", "blocks_per_stage", "row_slices",
                "stages", "grid", "smem", "q_stagings")})
    del x_bs, q_bs, s_bs
    res_bs, wall_bs, launches_bs = timed_run(lambda: bdot(
        row_engines=row_sp, **bs_kw))
    routes_bs = dict(ell_module.ROUTE_LAUNCHES)
    grid_routes_bs = {"tq": dict(slab_ops.TQ_ROUTE_LAUNCHES),
                      "apply": dict(slab_ops.ROUTE_LAUNCHES)}
    rounds_bs = t_sp * t_c_bs
    # one batched launch a round of the row stage; the four debias tables
    # take t_c single launches each; each grid kernel one packed launch a
    # step
    count_path("bdot_sparse", launches_bs, {
        "ell_spmm": rounds_bs + len(row_sp) * t_c_bs,
        "gram_qr": QR_PASSES * t_sp}, packed=True)
    for name in ("grid_block_tq", "grid_block_apply"):
        check(launches_bs[name] == t_sp, f"bdot_sparse: {launches_bs[name]}"
              f" {name} launches, expected {t_sp}")
        rows[f"{name}_packed"]["launches"] += t_sp
    check(routes_bs == {"single": len(row_sp) * t_c_bs,
                        "batched": rounds_bs},
          f"bdot_sparse: ELL launches by form {routes_bs}, expected "
          f"{len(row_sp) * t_c_bs} single and {rounds_bs} batched")
    rows["ell_spmm"]["launches"] -= rounds_bs
    rows["ell_spmm_batched"]["launches"] += rounds_bs
    res_bd, wall_bd, _ = timed_run(lambda: bdot(
        row_engines=bs_rows(sparse=False), **bs_kw))
    res_be, wall_be, _ = timed_run(lambda: bdot(
        row_engines=row_sp, fused=False, **bs_kw))
    d_bs, n_bs = sp_grid[0][0].shape
    ledger_bs = [res_bs.ledger.p2p, res_bs.ledger.matrices,
                 res_bs.ledger.scalars, res_bs.ledger.payload_bytes]
    want_bs = closed_form(
        [(e.graph.adjacency, rounds_bs, n_bs * rs) for e in col_bs]
        + [(e.graph.adjacency, rounds_bs, d_bs * rs) for e in row_sp]
        + [(col_bs[0].graph.adjacency, QR_PASSES * t_c_bs * t_sp,
            rs * rs)])
    bs_out = {
        "grid": [bs_i, bs_j], "block": [int(d_bs), int(n_bs)],
        "padded_cols": int(-(-n_bs // 4) * 4), "r": rs, "t_outer": t_sp,
        "t_c": t_c_bs, "row_ell_widths": [e._w.ell_width for e in row_sp],
        "stack_width": SparseW.stack([e._w for e in row_sp]).ell_width,
        "debias_table_min": [float(e.debias_table(t_c_bs)[t_c_bs].min())
                             for e in row_sp],
        "wall_s": {"fused_sparse": wall_bs, "fused_dense_rows": wall_bd,
                   "eager_sparse": wall_be},
        "launches": launches_bs, "ell_routes": routes_bs,
        "final_err": {"fused_sparse": float(res_bs.error_trace[-1]),
                      "fused_dense_rows": float(res_bd.error_trace[-1]),
                      "eager_sparse": float(res_be.error_trace[-1])},
        "subspace_err_vs_dense_rows": float(subspace_error(res_bd.q_full,
                                                           res_bs.q_full)),
        "subspace_err_vs_eager": float(subspace_error(res_be.q_full,
                                                      res_bs.q_full)),
        # eq. (11) in f32 reads 0 once every singular value rounds to 1:
        # the largest principal angle after a float64 QR says how far
        "max_angle_f64_vs_dense_rows": max_angle_f64(res_bd.q_full,
                                                     res_bs.q_full),
        "max_angle_f64_vs_eager": max_angle_f64(res_be.q_full,
                                                res_bs.q_full),
        "ledger": ledger_bs, "ledger_closed_form": want_bs,
        "grid_kernel_routes": grid_routes_bs,
        "packed_plans": {k: rows[f"grid_block_{k}_packed"]["plan"]
                         for k in ("tq", "apply")}}
    emit({"phase": "bdot_sparse", **bs_out})
    check(bool(torch.isfinite(res_bs.q_full).all()), "bdot_sparse: "
          "non-finite")
    check(bs_out["subspace_err_vs_dense_rows"] <= SUBSPACE_TOL,
          f"bdot_sparse: subspace error {bs_out['subspace_err_vs_dense_rows']}"
          " against the dense row engines")
    check(bs_out["subspace_err_vs_eager"] <= 1e-5,
          f"bdot_sparse: subspace error {bs_out['subspace_err_vs_eager']} "
          "against the eager sparse run")
    check(ledger_bs == want_bs, f"bdot_sparse: ledger {ledger_bs}, closed "
          f"form {want_bs}")
    del sp_grid, row_sp, col_bs, res_bs, res_bd, res_be

    # -- lm_setup: qwen2-7b on the card, after the PSA phases' tensors ------
    del (x, blocks, fslabs, grid, xs, sp_blocks, sp_eng, sw, dense_eng,
         bf_eng, eng, col_engs, row_engs, sparse_res, dense_res, bf_res)
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = get_arch("qwen2-7b")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(leaf.numel() for leaf in leaves)
    emit({"phase": "lm_setup", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "seconds": time.perf_counter() - t0,
          "params": n_params,
          "param_bytes": sum(leaf.numel() * leaf.element_size()
                             for leaf in leaves),
          "allocated_before_bytes": held_before})
    check(n_params == cfg.param_count(), f"qwen2-7b: {n_params} params, "
          f"param_count() says {cfg.param_count()}")
    del leaves

    # -- lm_prefill: 4 x 2048 tokens through the kernel, then plain ---------
    lm_b, lm_s = 4, 2048
    toks = make_lm_batch(cfg, 0, 0, lm_b, lm_s, device=dev)["tokens"]

    def attn_bf16_logits(q, k, v, *, causal, window, group=None, q_head0=0):
        """Faulty control: the plain version with q k^T rounded to bf16
        before the f32 softmax, as a kernel that kept its logits in the
        input dtype would compute (one process: plain GQA groups)."""
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        sq, skv = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + skv - sq
        kpos = torch.arange(skv, device=q.device)[None]
        mask = kpos <= qpos if causal else torch.ones_like(kpos, dtype=bool)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = (q @ k.mT).float() * q.shape[-1] ** -0.5
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        return (probs @ v.float()).to(q.dtype)

    def forward_with(attn):
        return with_patched(ops, "flash_attention", attn, lambda: forward(
            params, {"tokens": toks}, cfg, use_kernel=True))

    with torch.inference_mode():
        forward(params, {"tokens": toks}, cfg)     # warm: cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = forward(params, {"tokens": toks}, cfg, use_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        measured = {"lm_prefill": (cfg, ShapeConfig("lm_prefill", lm_s, lm_b,
                                                    "prefill"), wall)}
        flash_launches = ops.LAUNCHES["flash_attention"]
        flash_routes = dict(ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        rows["flash_attention"]["launches"] += flash_launches
        rows["flash_attention"]["launches_by_phase"] = {
            f"lm_prefill:{cfg.name}": flash_launches}
        finite = bool(torch.isfinite(logits).all())
        t0 = time.perf_counter()
        plain_logits = forward(params, {"tokens": toks}, cfg,
                               use_kernel=False)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        rel_rms, max_abs, top1 = compare(logits, plain_logits)
        logits_rms = float(plain_logits.float().square().mean().sqrt())
        shape = list(logits.shape)
        del logits
        faulty = {"bf16_attention_logits": attn_bf16_logits,
                  "kernel_without_last_64_keys": kernel_uncounted(64)}
        controls = {}
        for label, attn in faulty.items():
            ctrl = forward_with(attn)
            c_rms, c_max, c_top1 = compare(ctrl, plain_logits)
            controls[label] = {"rel_rms": c_rms, "max_abs": c_max,
                               "top1_agreement": c_top1}
            del ctrl
        del plain_logits
        per_layer = {}
        for label, attn in {"kernel": kernel_uncounted(), **faulty}.items():
            stats = []
            forward_with(layer_check(attn, stats))     # logits unused
            outside = [i for i, st in enumerate(stats) if not attn_within(st)]
            per_layer[label] = {
                "layers": len(stats),
                "max_row_rel_err": max(st["row_rel_err"] for st in stats),
                "max_rel_rms": max(st["rel_rms"] for st in stats),
                "rel_rms_by_layer": [st["rel_rms"] for st in stats],
                "first_layer_outside": outside[0] if outside else None}
    emit({"phase": "lm_prefill", "batch": lm_b, "seq": lm_s,
          "wall_s": wall, "prefill_tokens_per_s": lm_b * lm_s / wall,
          "peak_bytes": peak, "flash_attention_launches": flash_launches,
          "flash_attention_route_launches": flash_routes,
          "plain_attention_wall_s": plain_wall, "logits_shape": shape,
          "logits_rms": logits_rms,
          "vs_plain": {"rel_rms": rel_rms, "max_abs": max_abs,
                       "top1_agreement": top1, "tolerance": LOGITS_TOL},
          "faulty_controls_vs_plain": controls,
          "attention_per_layer_vs_plain": per_layer})
    check(finite, "lm_prefill: non-finite logits")
    check(shape == [lm_b, lm_s, cfg.vocab_size], f"lm_prefill: logits {shape}")
    check(flash_launches == cfg.n_layers, f"lm_prefill: {flash_launches} "
          f"flash-attention launches, expected {cfg.n_layers}")
    check(flash_routes == {"tc_bf16": cfg.n_layers, "simt_f32": 0},
          f"lm_prefill: flash-attention routes {flash_routes}, expected "
          f"all {cfg.n_layers} on the tensor-core kernel")
    check(rel_rms <= LOGITS_TOL, f"lm_prefill: logits {rel_rms} (relative "
          f"RMS) from the plain-attention forward > {LOGITS_TOL}")
    for label, c in controls.items():
        check(c["rel_rms"] > LOGITS_TOL, f"lm_prefill: faulty control "
              f"{label} passes LOGITS_TOL ({c['rel_rms']})")
    check(per_layer["kernel"]["layers"] == cfg.n_layers
          and per_layer["kernel"]["first_layer_outside"] is None,
          f"lm_prefill: the kernel against plain attention on the model's "
          f"own activations: {per_layer['kernel']}")
    for label in controls:
        check(per_layer[label]["first_layer_outside"] is not None,
              f"lm_prefill: faulty control {label} within the attention "
              f"tolerances at every layer")

    def prefill():
        with torch.inference_mode():
            forward(params, {"tokens": toks}, cfg)

    emit(profile_phase(
        prefill, "profile_lm", "lm_prefill qwen2-7b, 4 x 2048 tokens, bf16",
        groups={"flash_attention": ("flash_attention_wgmma_kernel",
                                    "flash_attention_simt_kernel"),
                "gemm": ("gemm", "nvjet", "xmma", "cutlass", "splitk")}))

    # -- lm_decode: teacher-forced against prefill, then greedy --------------
    n_tf, n_gen = 64, 32
    prompt = toks[:, :n_tf]
    with torch.inference_mode():
        state = init_decode_state(cfg, lm_b, n_tf + n_gen, device=dev)
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state["caches"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for t in range(n_tf):
            lg, state = decode_step(params, state, prompt[:, t:t + 1], cfg)
            outs.append(lg)
        decoded = torch.cat(outs, dim=1)
        torch.cuda.synchronize()
        tf_wall = time.perf_counter() - t0
        prefilled = forward(params, {"tokens": prompt}, cfg)
        dec_rms, dec_max, dec_top1 = compare(decoded, prefilled)
        # the int8 KV cache on the same prompt, against the bf16 cache's
        from repro_torch.launch import roofline
        cfg_q = dataclasses.replace(cfg, kv_quant=True)
        qstate = init_decode_state(cfg_q, lm_b, KV_QUANT_STEPS, device=dev)
        q_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(qstate["caches"]))
        q_plan = roofline.kv_cache_bytes(cfg_q, ShapeConfig(
            "lm_decode_int8", KV_QUANT_STEPS, lm_b, "decode"))
        qouts = []
        for t in range(KV_QUANT_STEPS):
            lg, qstate = decode_step(params, qstate, prompt[:, t:t + 1],
                                     cfg_q)
            qouts.append(lg)
        q_rms, q_max, q_top1 = compare(torch.cat(qouts, dim=1),
                                       decoded[:, :KV_QUANT_STEPS])
        del qstate, qouts
        nxt = decoded[:, -1:].argmax(-1).to(torch.int32)
        generated = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_gen):
            lg, state = decode_step(params, state, nxt, cfg)
            nxt = lg[:, -1:].argmax(-1).to(torch.int32)
            generated.append(nxt)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        generated = torch.cat(generated, dim=1)
        gen_ok = (bool(torch.isfinite(lg).all())
                  and int(generated.min()) >= 0
                  and int(generated.max()) < cfg.vocab_size)
        del outs, decoded, prefilled
    measured["lm_decode"] = (cfg, ShapeConfig("lm_decode", n_tf + n_gen,
                                              lm_b, "decode"),
                             gen_wall / n_gen)
    emit({"phase": "lm_decode", "batch": lm_b, "teacher_forced": n_tf,
          "generated": n_gen, "kv_cache_bytes": kv_bytes,
          "teacher_forced_wall_s": tf_wall, "generate_wall_s": gen_wall,
          "decode_tokens_per_s": lm_b * n_gen / gen_wall,
          "ms_per_step": gen_wall / n_gen * 1e3,
          "vs_prefill": {"rel_rms": dec_rms, "max_abs": dec_max,
                         "top1_agreement": dec_top1, "tolerance": DECODE_TOL},
          "first_generated": generated[0, :8].tolist(),
          "int8_cache": {"steps": KV_QUANT_STEPS, "cache_bytes": q_bytes,
                         "planned_cache_bytes": q_plan,
                         "bf16_cache_bytes_same_length":
                             roofline.kv_cache_bytes(cfg, ShapeConfig(
                                 "lm_decode", KV_QUANT_STEPS, lm_b,
                                 "decode")),
                         "vs_bf16_cache": {"rel_rms": q_rms,
                                           "max_abs": q_max,
                                           "top1_agreement": q_top1,
                                           "tolerance": KV_QUANT_TOL}},
          "card": nvidia_smi()})
    prof = {"state": init_decode_state(cfg, lm_b, 16, device=dev)}

    def decode_steps():
        with torch.inference_mode():
            for t in range(4):
                _, prof["state"] = decode_step(params, prof["state"],
                                               prompt[:, t:t + 1], cfg)

    emit(profile_phase(
        decode_steps, "profile_decode",
        "lm_decode qwen2-7b, 4 steps at batch 4, bf16",
        groups={"gemm": ("gemm", "nvjet", "xmma", "cutlass", "splitk",
                         "gemv")}))
    check(state["index"] == n_tf + n_gen, "lm_decode: step count")
    check(gen_ok, "lm_decode: non-finite logits or a token out of range")
    check(dec_rms <= DECODE_TOL, f"lm_decode: teacher-forced logits "
          f"{dec_rms} (relative RMS) from prefill > {DECODE_TOL}")
    check(q_bytes == q_plan, f"lm_decode: the int8 cache holds {q_bytes} "
          f"bytes, roofline --kv-quant counts {q_plan}")
    check(q_rms <= KV_QUANT_TOL, f"lm_decode: the int8 cache's logits "
          f"{q_rms} (relative RMS) from the bf16 cache's > {KV_QUANT_TOL}")

    # -- the MoE, recurrent and frontend families ----------------------------
    del params, state, prof, toks, prompt, generated, lg, nxt
    lm_family_phases(dev, rows, record)

    # -- gossip across processes and the PSA trainer ------------------------
    gc.collect()
    torch.cuda.empty_cache()
    spmd_train_phases(dev, rows, record, gram_qr_work, q_init, q_true)

    # -- training every family, shard-local MoE, the sharded step ---------
    gc.collect()
    torch.cuda.empty_cache()
    train_family_phases(dev, rows, record, gram_qr_work, measured)

    for name, row in rows.items():
        check(row["launches"] > 0 or not row.get("main_path", True),
              f"{name} was not launched on the main path")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
