"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, sm_90a) and runs from a checkout of the
repo; it fails, printing no result, without either.  Phases, each of
which raises on failure:

1. device: the card's name and power limit; TF32 off;
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` compiled
   with nvcc from the checkout, all sources at once;
3. every kernel against its plain PyTorch version on the card, at the
   main paths' shapes with the tuner's tiles and tiles around them, with
   the tolerance stated per dtype: the partial attention kernel also
   at N=4096 with the wrapper's kv split, one split and an uneven one
   (the plain version takes the same split), with windows and dead
   rows; the normalised one also with a window, without a mask, with
   M < N and M > N; the MLP kernel at the tuner's tiles for M = 4, 144
   and 4096 with its n split, one split and an uneven one (the plain
   version takes the same split), at M = 1, ragged M, N and H, each
   activation, f32 A with bf16 weights, and two decode launches that
   must be bitwise equal; the GEMM-chain kernel (the MLP machine with
   the identity activation) at the tuner's tiles of Table II chains in
   both classes with its n split, G12 and G1 also with one split and an
   uneven one (the plain version takes the same split) and two launches
   that must be bitwise equal; the three-GEMM kernel at the tuner's
   tiles in f32 and bf16; the partial kernel also at granite-20b's
   decode shape (Hq=48, Hkv=1: a GQA group of 48) at the tuner's tiles
   and tiles around them; and at the MoE family's shapes: the partial
   kernel at olmoe-1b-7b's decode (Hq=Hkv=16: a GQA group of 1) at the
   tuner's tiles and around them, and at mixtral-8x7b's windowed decode
   (Hq=32, Hkv=8, N=4128, window 4096) over page tables whose first
   entries are RECLAIMED as the engine's reclamation leaves them; the
   normalised kernel at olmoe's forward (B=2, Hq=Hkv=16, S=2048); and
   at 4i's shapes: the normalised kernel at recurrentgemma-2b's head
   dim 256 and GQA group of 10 with its window of 2048 (S=2560) at the
   tuner's tiles and around them, bf16 and f32, and at pixtral-12b's
   forward;
4. the main paths, each at full width — qwen3-8b (36 layers, bf16,
   random weights from a seed, no depth cut), then granite-20b (52
   layers, 56.3 GB, after qwen3-8b's weights are freed):
   a. served by the continuous-batching engine, 8 ragged requests, max
      batch 4, hand-wired, ``Runtime(kernel_ops=True)``, the decode
      step captured in a CUDA graph and replayed, then the same
      workload with the step eager (``eager_decode=True``): equal
      greedy tokens, and in each run the paged attention kernel's
      launch counter must equal decode steps x layers (the capture's
      warm-up is counted apart);
   b. the same, planned, ``Runtime(kernel_ops=True, planner=True)``:
      every block runs from the planner's H100 plan, each fused MLP
      chain as the MLP kernel — (decode steps + prefills) x layers
      launches — and the paged attention kernel decode steps x layers;
   c. the cache-free ``LM.loss`` and ``LM.forward`` at B=2, S=2048 with
      ``Runtime(kernel_ops=True)``: the normalised attention kernel
      launched once per layer and call (36);
   d. fixed-batch ``launch.serve.generate`` over a contiguous cache,
      batch 4, prompt 128, 32 tokens, captured and then eager: equal
      tokens, no kernel launched (none is on this path, as in the JAX
      package), and the last step's logits against the cache-free
      forward over the same tokens;
   e. granite-20b served as in a., hand-wired: the partial kernel at a
      group of 48, decode steps x 52 launches; before it, codeqwen1.5-7b
      (32 layers, 16.4 GB, MHA: the partial kernel at a group of 1) as
      in a. (decode steps x 32 launches) and d. (``generate`` against
      its forward);
   every serve run, the forward, ``generate`` and the quickstart also
   assert that nothing degraded: tier ``configured`` and no denylist
   record in the cache directory;
   and the front door, ``python -m repro_torch.launch.quickstart``: one
   launch each of the GEMM-chain and the normalised attention kernel,
   each within the f32 tolerance of its oracle;
   each path's counters are set to 0 just before it and read after;
   the three-GEMM kernel is on no path, as in the JAX package, and its
   counter must read 0 after them all;
   f. the reliability layer on qwen3-8b at FULL width cut to
      RELIABILITY_LAYERS of its 36 layers (the first layers of the
      weights above; ``reliability_phase``, before granite-20b): the
      workload of a. in fresh engines, R3 a
      ``kernel_dispatch`` fault at the paged kernel's seam
      (``eager_decode=True``), R4 one at the engine's prefill seam
      (captured), R1 shadows at rate 1.0 on both paths (the engine
      seam captured; the kernel seams with ``eager_decode=True``, each
      kernel output held elementwise to its dtype's tolerance), R2 a
      planted wrong answer on the planned path; each fault must fire
      and be
      absorbed as the reliability layer says, and the records are
      lifted after; a ``{"reliability": ...}`` line;
   h. the MoE family (``moe_phase``), after granite-20b's weights are
      freed: olmoe-1b-7b (16 layers, 13.84 GB, no depth cut) with its
      golden probe routing alike on both tiers, served as in a.
      (partial kernel decode steps x 16, MLP kernel 0) and
      planner-requested (MoE cannot be planned: the hand-wired run's
      tokens, MLP kernel 0), one decode step against the plain path
      with the (token, layer) routing flips counted and the plain step
      also run with the kernel step's routing pinned, a profile of one
      captured and one eager decode step beside the byte floor of the
      expert weights every step reads, the cache-free loss and forward
      (16 attention launches each) against the plain twin path pinned
      and unpinned, fixed-batch ``generate`` captured and eager; then
      mixtral-8x7b at full width cut to 16 of 32 layers (46.96 GB)
      served as in a., and one request of a 4096-token prompt and 48
      tokens that crosses the window of 4096, captured, eager and with
      reclamation off: reclaimed pages above 0 and equal tokens; a
      ``{"moe": ...}`` line;
   i. the hybrid and vision-prefix decoders (``archs_phase``), after
      the MoE family's weights are freed, each model freed before the
      next: recurrentgemma-2b at every FULL width and depth (26 layers
      = 8 x (rglru, rglru, attn) + (rglru, rglru), head dim 256, 10
      q-heads on one kv head, local window 2048, tied embeddings), its
      cache-free loss and forward at B=1 x S=4096 (8 attention
      launches each, the window crossed) against the plain twin path,
      fixed-batch ``generate`` (batch 4, prompt 2040, 32 tokens: the
      decode wraps the 2048-slot ring; the RG-LRU state written in
      place by every replay) captured and eager against the forward,
      and 16 teacher-forced decode steps after a prefill against the
      forward's rows; then pixtral-12b at every FULL width and depth
      (40 layers, 24.5 GB) the same way over 1024 prefix embeddings
      (B=2 x (1024 + 1024), 40 launches; ``generate`` batch 4, prompt
      128); then training, no kernel: T1 of 4g at recurrentgemma's full
      depth within its own limits (RG_T1_LIMITS), one step of it
      (46.3 GB of weights and AdamW state) and one of pixtral cut to 6
      of 40 layers (47.7 GB) over 1024 prefix embeddings and 2048
      tokens; walls, busy shares and peak memory printed; an
      ``{"archs": ...}`` line;
   j. the state-space and encoder-decoder families
      (``ssm_encdec_phase``), after 4i, each model freed before the
      next, no kernel on any of their paths (every counter 0 after each
      path, as in the JAX package; nothing degraded): mamba2-1.3b at
      every FULL width and depth (48 Mamba-2 layers, chunk 256, 2.69
      GB) — the chunked SSD on one layer's real inputs of a B=2 x S=4096
      forward against the one-token recurrence stepped over all 4096
      positions (SSD_REL_TOL), the cache-free loss and forward at B=2 x
      S=4096 (wall, busy share, peak memory), 16 teacher-forced decode
      steps after a prefill of 4080 against the forward's rows, in bf16
      (MAMBA_DECODE_REL_TOL) and with the weights upcast to f32,
      ``generate`` (batch 4, prompt 128, 32 tokens) captured and eager
      (its last logits' distance to the forward printed),
      T1 at 48 layers within MAMBA_T1_LIMITS and one ``launch.train``
      step —; then whisper-small (12 + 12 layers, 0.58 GB) — the
      encoder's streaming twin at 1500 frames (kv block 500) against
      ``naive_attention``, the loss and forward at B=4 over 1500 frames
      and 448 tokens, 16 teacher-forced decode steps after 432 tokens,
      ``generate`` (batch 4, prompt 64, 32 tokens, decoded from position
      64 + 1500 as the JAX package's) captured and eager, one training
      step at B=4 x 448 —; an ``{"ssm_encdec": ...}`` line;
   k. the distributed serving regimes (``dist_phase``), after
      granite-20b's weights are freed (in the full run every world of
      4p's mesh and of 4k, 4l, 4n and 4o runs on one pool of four rank
      processes, ``_world_pool``, each world from a reset process; run
      alone, each world's ranks are spawned for it): a world of 4 ranks
      (gloo, every rank on the one card; ``repro_torch.launch.mesh``)
      over a 1 x 4 ("data", "model") mesh, held to single-card results
      the parent computed and freed before (``dist_refs``), every step
      with the counters set to 0 just before it and read after, in
      every rank: (a) ``ops.gemm_chain`` at tests/test_dist_exec.py's
      shape in f32 and bf16 and at G12 bf16, ``ops.attention`` at
      qwen3-8b's forward and at one row over 4096 keys, each regime
      forced (spatial, ring, ring-pipelined), each within TOL of the
      single-card kernel, the tuner's pick printed; (b) qwen3-8b at FULL
      widths cut to 4 of 36 layers, ``loss`` and ``forward`` at B=2 x
      S=2048 with ``Runtime(kernel_ops=True)`` within LOSS_REL_TOL /
      FORWARD_REL_TOL of the single-card kernel path, 4 attention
      launches a rank a call; (c) ``generate`` on the sharded runtime of
      ``launch.serve --shard-model 4`` (batch 4, prompt 128, 32 tokens)
      for qwen3-8b (heads-sharded cache) and granite-20b at 4 of its 52
      layers
      (sequence-sharded cache, ``distributed_decode_attention``): the
      greedy tokens' agreement printed, and the last step's logits, its
      inputs forced to the
      single-card run's tokens, within E2E_REL_TOL; (d) the continuous
      engine under the mesh on qwen3-8b, 8 ragged requests of up to 96
      + 32 positions (8 pages of 16), the tuner's paged regime printed,
      then paged-ring and paged-ring-pipelined each served, forced:
      partial launches = decode steps x 12 a rank, one decode step's
      logits on the same pages within E2E_REL_TOL of the single-card
      engine's, token agreement printed; no rank may degrade, and every
      rank must launch alike; the parent prints the backend, the tensors
      moved through host memory, the launches summed over the ranks and
      the walls (through gloo on one card, not kernel times); a
      ``{"dist": ...}`` line;
   l. training under the mesh (``dist_train_phase``, after 4k), worlds
      of spawned ranks as in 4k: (a) qwen3-8b at FULL widths cut to 4
      of 36 layers on a 2 x 2 ("data", "model") world, one sequence of
      2048 a data rank, first one single-card step of
      ``launch.steps.make_train_step`` on the same weights and batch in
      a process of its own (its results on the host), then one sharded
      step on the ranks: the loss within DIST_TRAIN_LOSS_REL_TOL, the
      global grad norm within DIST_TRAIN_GNORM_REL_TOL, each rank's
      block of each leaf's reduced gradient within
      DIST_TRAIN_GRAD_REL_TOL, after the update no element past 2 lr
      and one spacing and each rank's block of each leaf (the
      zero-initialised norm scales printed) at most
      DIST_TRAIN_FLIP_SHARE apart by more than lr;
      the state saved whole (rank 0 writes), two more steps whose loss
      must fall; the step walls through gloo, the tensors through host
      memory and each rank's peak printed; (b) rank 3 dropped:
      ``elastic_remesh`` over ranks 0-2 at model axis 2 must give 1 x 2,
      ``replace_state`` re-shards the saved state onto a 2-rank world,
      and (a)'s loss after its first step within ELASTIC_LOSS_REL_TOL;
      (c) whisper-small at FULL width and depth replicated on a 4 x 1
      world, B=4 x 448 over 1500 frames, one example a rank: three
      ``--compress-grads`` steps (int8 error feedback) against three
      steps of one card's plain ``make_train_step`` on the whole batches
      from the same weights (made first, in a process of its own): step
      0's losses within COMPRESSED_STEP0_REL_TOL, every step's loss and
      step 0's grad norm within COMPRESSED_REL_TOL, the residuals
      non-zero; (d) olmoe-1b-7b at FULL widths cut to 8 of 16 layers
      on a 1 x 4 world (``ep``: 16 experts a rank): every layer on the
      single-card kernel path's input with its routing pinned, the
      attention output and layer output within FORWARD_REL_TOL per
      token, the sharded loss with the kernels within
      MOE_FLIP_LOSS_REL_TOL of one card's, 8 ``fused_attention``
      launches a rank a call (loss and forward), the engine under the
      mesh in the tuner's paged regime on 8 ragged requests with
      partial launches a rank = decode steps x 8, nothing degraded,
      its greedy tokens' agreement with one card's printed; then the
      engine's model in f32 (its Runtime, the weights drawn in f32) on
      two prompts with one card's f32 routing pinned: both prefills'
      logits and the first decode step's within MOE_MESH_F32_REL_TOL of
      one card's; then 4m (c) in the same world (below); a
      ``{"dist_train": ...}`` line;
   n. the hybrid, state-space and encoder-decoder families under the
      mesh (``dist_families_phase``, after 4l): a world of four ranks
      on the card, 2 x 2 ("data", "model"), FULL widths —
      recurrentgemma-2b at 3 of 26 layers, mamba2-1.3b at 4 of 48,
      whisper-small whole — each held to one card's run of the same
      code on the same weights (made first, in a process of its own):
      (a) one ``make_train_step`` under Megatron-SP (``tp+sp``), one
      sequence a data rank (B=2 x 4096, 2 x 4096, 4 x 448 over 1500
      frames), the loss, norm and each rank's gradient blocks within
      4l (a)'s limits; (b) under the serving rules (``tp``) a prefill
      (2040, 4080 and 432 tokens) then 16 teacher-forced decode steps,
      each step's logits within E2E_REL_TOL — recurrentgemma's across
      its 2048-slot ring, sequence-sharded; (c) recurrentgemma-2b's
      loss and forward with ``Runtime(kernel_ops=True)``: one
      ``fused_attention`` launch an attention layer a call on every
      rank at 5 of its 10 q heads, the loss within LOSS_REL_TOL and
      the logits within FORWARD_REL_TOL of one card's kernel path,
      nothing degraded; each rank's peak and the walls (through gloo)
      printed, a ``{"dist_families": ...}`` line;
   o. the remaining distributed regimes (``dist_regimes_phase``, after
      4n): qwen3-8b at FULL widths cut to 4 of 36 layers on a 1 x 4
      world, held to one card's planned run of the same weights (made
      first, in a process of its own): (a) the planned engine
      (``Runtime(kernel_ops=True, planner=True)``, the serving rules) on
      8 ragged requests of up to 96 + 32 positions, in the tuner's
      paged regime and forced to each of paged-spatial and paged-ring
      the tuner did not pick, every dispatch teacher-forced to one
      card's engine (its logits or greedy tokens handed to the engine)
      and its logits within E2E_REL_TOL; on every rank the MLP kernel
      launched (decode steps + prefills) x 4 and the partial kernel
      decode steps x 4, nothing degraded; (b)
      a 128-token prompt's planned paged prefill under
      ``Rules(seq="model")`` (32 rows a rank), then 3 decode steps under
      plain tensor parallelism, each logits within E2E_REL_TOL; (c), run
      in 4l after 4m (c) on 4l (a)'s reference: 4l (a)'s step under the
      zero3 multi-pod rules (no tensor parallelism, the sequence over
      the model dim) on a (pod, data, model) = 2 x 1 x 2 world within
      4l (a)'s limits, each rank's flops and bytes within
      DRYRUN_COUNT_REL_TOL of its dry trace's, its collectives equal to
      the trace's, its peak within DRYRUN_PEAK_REL_TOL; and (b') the
      same prompt's paged prefill under those rules within E2E_REL_TOL;
      then phase 3 at 4o's shapes with the kernel times: the MLP kernel
      at a rank's block (d_ff over 4: qwen3-8b N = 3072, granite-20b N =
      6144, K = H = d_model, M = 4 and 144) at the tuner's tiles (tuned
      in a worker process during the earlier phases) and around them
      against its plain version, and timed beside the unfused
      ``mlp_block``; a ``{"dist_regimes": ...}`` line;
   p. the planned cache-free forward (``planned_phase``, after d. on
      qwen3-8b's weights): ``LM.loss`` and ``LM.forward`` with
      ``Runtime(kernel_ops=True, planner=True)`` at B=2 x S=2048 (the
      H100 plan fuses the attention only: 36 ``fused_attention``
      launches a call, ``fused_mlp_chain`` 0) and at B=2 x S=256 (the
      plan fuses the MLP too: 36 launches of each a call), each plan
      printed, each call held within FORWARD_REL_TOL (logits) of the
      hand-wired kernel path and of the planned plain path, its loss
      within LOSS_REL_TOL scaled by the square root of 4094 over its
      labelled tokens (``_loss_tol``) of the first and LOSS_REL_TOL of
      the second, each of the two beside the hand-wired plain path (a
      witness, printed), the two forwards' device spans and a profile
      of the planned one; then (``planned_mesh_phase``, qwen3-8b's
      weights freed) one card's planned kernel path at 4 of 36 layers,
      B=2 x 256, and a world of 4 ranks over a 1 x 4 mesh under the
      serving rules: on every rank the MLP kernel on the rank's d_ff
      block once a layer and call, the attention kernel once a layer
      (the tuner's spatial regime printed), the loss within LOSS_REL_TOL
      and the logits within FORWARD_REL_TOL of one card's; then
      (``examples_phase``) the three
      example drivers once each on the card with their defaults —
      ``python -m repro_torch.launch.fuse_custom_chain`` (no launch),
      ``serve_batched`` fixed (``--gen 8``) and ``--arch qwen3-8b
      --continuous``, ``train_lm`` (200 steps, the loss must fall) —
      nothing degraded; and phase 3 and 7 at 4p's new shapes: the MLP
      kernel at M = 512 (N = d_ff, and a rank's N = d_ff / 4) and the
      normalised attention at 2 x 256 (every head, and a rank's 8 q
      and 2 kv heads at the tiles of its regime search) against their
      plain versions within bf16 TOL, timed beside the unfused MLP and
      SDPA; a ``{"planned": ...}`` line before the kernels line;
   g. training (``training_phase``), after every serving phase with
      their weights freed: qwen3-8b at every FULL width with the depth
      cut to 8 of 36 layers (AdamW's 16 B a parameter: 131 GB for 36
      layers, 44.6 GB for 8), one TokenPipeline batch of B=1 x S=2048
      (the streaming twin under autograd) — T1 one step's bf16 loss,
      global grad norm and every leaf's gradient against the same step
      with the weights upcast to f32, each within its stated limit; T2
      20 steps of ``launch.train.train`` with the CLI's defaults, every
      loss and grad norm finite, the mean of the last 5 losses below
      the first 5's, every kernel counter 0 (no kernel is on the
      training path, as in the JAX package), the step wall, tokens/s,
      peak memory, the model-FLOPs share of 989 TFLOP/s with its formula,
      and where one step's device time goes (five pieces by events and
      by kernel class, the attention twin of one layer); T3 restart at
      qwen3 SMOKE on the card: a StepFailure planted at step 6 of 10
      under a StepRunner checkpointing every 4 steps (latest step 10,
      the replayed batches bitwise equal, each loss within its limit of
      an uninterrupted run's), a second runner resuming from step 8 for
      two steps, a bf16 state restored bit for bit; a ``{"train": ...}``
      line before the kernels line;
   m. the dry run (``dryrun_phase``, after 4g): (a) the dry-run records
      (``launch.dryrun.run_cell``: one rank's step traced on the meta
      device on the 16 x 16 mesh, priced under ``H100``) of qwen3-8b's
      four shapes and olmoe-1b-7b's ``train_4k`` — the three roofline
      terms, the dominant one, the peak a rank and ``useful_ratio`` —
      traced in worker processes while (b) runs; (b) 4g's step (qwen3-8b
      at 8 of 36 layers, B=1 x 2048) with recomputation off, full and
      ``dots``, each traced on meta first and then run on the card under
      the same counter (``launch.op_cost.OpCost``): the loss within
      REMAT_LOSS_REL_TOL and each leaf's gradient within
      TRAIN_GRAD_REL_TOL of remat off's, the card's matmul-class flops
      equal to the trace's and its flops and bytes within
      DRYRUN_COUNT_REL_TOL, ``max_memory_allocated`` over the step within
      DRYRUN_PEAK_REL_TOL of the trace's peak, the roofline floor at or
      below the measured wall (the ratio printed); (c) 4l (a)'s step
      under ``Rules(seq="model")`` (sequence parallelism) on its 2 x 2
      world, run in 4l after (a) on (a)'s reference: loss, norm and each
      rank's gradient blocks within 4l (a)'s limits, each rank's
      recorded collectives equal to the dry trace of its step on a
      ``DryMesh`` by kind, count and bytes in order, its peak within
      DRYRUN_PEAK_REL_TOL of the trace's, printed beside 4l (a)'s peak
      without SP; a ``{"dryrun": ...}`` line before the kernels line;
   q. the kernels' stitching hooks and the tuner's measured trials
      (``hooks_phase``, after the kernel times; no main path passes a
      hook or a ``measure_fn``): (a) each hooked kernel against its
      plain version with the same hooks within TOL, at the shapes the
      kernel table times — the MLP kernel at qwen3-8b's decode (M=4,
      the tuner's 128 splits), prefill (M=144) and the planned
      forward's M=512 with a tanh prologue and the epilogue tanh(0.5
      x), which must follow the sum of the splits; the GEMM chain at
      G12 bf16 and G1 f32 and the three-GEMM chain in bf16 with a tanh
      prologue and the epilogue 0.5 x; the attention at qwen3-8b's
      forward and at Table III S2 f32 with q * 2, tanh(k) and o + 1 —
      each hooked launch counted once under its hooks' keys
      (``wrapper.hooked``) and timed beside the unhooked one; then the
      planted fault, the epilogue of each of M=4's splits summed, must
      go past TOL; (b) ``api.fuse_mlp_chain`` / ``api.fuse_attention``
      under ``H100`` with a wall clock of the candidate's kernel as
      ``measure_fn`` (Algorithm 1's measured trials) at MEASURED: the
      analytic and the measured pick each timed in turns,
      ``n_measured``, ``n_iterations`` and the tuning seconds printed; a
      second call must load the measured record from disk, and every
      record written before the phase stays byte for byte; a
      ``{"hooks": ...}`` line before the kernels line, whose entries
      carry the hooked readings (``hooked``) and the measured picks;
5. one full-width decode step through each serving path against the
   same step through the plain hand-wired path, and the cache-free
   loss and logits against the plain twin path
   (``Runtime(kernel_ops=False)``);
6. a profile of one full decode step (batch 4) of each served engine,
   captured (a replay) and eager on the same inputs — host wall, device
   busy, busy share, the step's device span — and of one cache-free
   forward: host wall time and device time by kernel;
7. times of each kernel beside its bound, its plain version and the
   PyTorch call(s) it replaces (the partial attention also at
   granite-20b's group of 48; the normalised attention also at other
   tiles of the forward's shape and in f32 at Table III S2; the MLP
   kernel at M = 4, 144 and 4096, each at the tuner's tiles and split
   and at tiles around them; the GEMM-chain kernel at G12 in bf16 with
   its split, the device time of its split kernel and its merge, and at
   tiles around the pick, and at the quickstart's G1 in f32; the
   three-GEMM kernel at CHAIN3 in bf16; the normalised attention at
   recurrentgemma-2b's forward, D=256 with its window, and at
   pixtral-12b's, beside SDPA with the same mask; and phase 4k's
   kernels at one rank's block, timed in the parent alone on the card:
   the GEMM chain on G12's H / 4 columns, the normalised attention on
   qwen3-8b's forward at a quarter of its heads, the partial kernel on
   a quarter of its keys, each at the tuner's tiles for that block; and
   phase 4n's: the normalised attention on recurrentgemma-2b's forward
   at one rank's block, B=1, 5 of 10 q heads over the gathered kv head,
   beside SDPA with the same boolean window mask).

Prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.

    python3 chip_smoke.py --plant-faults

runs only the build and the cache-free forward's check against planted
attention faults (no causal mask, one key ahead, half the context, the
scale 1/D), printing each fault's distance from the plain twin path
beside the limits, then T1 of 4g unfaulted and with one layer's
attention output detached (its attention weights get no gradient), and
T1 of 4i (recurrentgemma-2b at full depth, RG_T1_LIMITS) unfaulted,
with one RG-LRU block's output detached, and with the RG-LRU scan off
by one position, then mamba2-1.3b's SSD check with the inter-chunk
term dropped and whisper-small's decode check with every layer's
cross-attention fed the layer below's k/v, then 4l's (a) unfaulted and
with each of two planted faults — the data-dim gradient reduction
skipped on rank 1, the identity-forward / all-reduce-backward op an
identity both ways — each of which must go past (a)'s gradient limit,
then 4n's (a) for recurrentgemma-2b and mamba2-1.3b with a fault each
— the RG-LRU's gathered main branch taking its gradient as this rank's
block instead of the sum, the Mamba-2 gated norm's sum of squares left
unsummed over the model dim on rank 1 — each past (a)'s gradient
limit, then 4o with its two faults — (a)'s paged-spatial engine with
the residual added before the planned MLP's reduction (each rank's
residual summed with the partial outputs), and (c)'s paged prefill
under the zero3 rules with a reduce-scatter where a block keeps its
rank's rows (sequence parallelism without tensor parallelism) — each
past E2E_REL_TOL; it fails unless every fault goes past its limit.

    python3 chip_smoke.py --reliability

runs only the build, qwen3-8b's weights and the reliability phase (4f,
at RELIABILITY_LAYERS of the 36 layers).

    python3 chip_smoke.py --moe

runs only the device, build and MoE phases: phase 3 at the MoE shapes,
4h, and the kernel times at the MoE shapes; prints a ``{"moe": ...}``
line.

    python3 chip_smoke.py --archs

runs only the device, build, 4i and 4j phases: phase 3 at 4i's
shapes, 4i, 4j, and the kernel times at 4i's shapes; prints an
``{"archs": ...}`` and an ``{"ssm_encdec": ...}`` line.

    python3 chip_smoke.py --dist

runs only the device and build phases, qwen3-8b's and granite-20b's
single-card results and phase 4k, then its kernel times; prints a
``{"dist": ...}`` line.

    python3 chip_smoke.py --dist-train

runs only the device and build phases and phase 4l; prints a
``{"dist_train": ...}`` line.

    python3 chip_smoke.py --dist-families

runs only the device and build phases, phase 4n and its kernel time;
prints a ``{"dist_families": ...}`` line.

    python3 chip_smoke.py --dist-regimes

runs only the device and build phases, phase 4o ((c) with a 4l (a)
reference of its own) and 4o's kernel checks and times; prints a
``{"dist_regimes": ...}`` line.

    python3 chip_smoke.py --train

runs only the device phase and the training phase (4g), and prints its
``{"train": ...}`` line.

    python3 chip_smoke.py --dryrun

runs only the device phase and phase 4m, (c) with a one-card reference
step of its own, and prints a ``{"dryrun": ...}`` line.

    python3 chip_smoke.py --planned

runs only the device and build phases, 4p's kernel checks, phase 4p
and its kernel times; prints a ``{"planned": ...}`` line.

    python3 chip_smoke.py --hooks

runs only the device and build phases and phase 4q; prints a
``{"hooks": ...}`` line.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def _clock(label: str) -> None:
    """The seconds since the script started, printed after ``label``:
    where the full run's time goes, against its 1200 s limit."""
    print(f"[clock] {label}: {time.perf_counter() - T0:.1f}s", flush=True)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM datasheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=3e-4, atol=1e-3),   # f32 sum order
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}  # P rounded to bf16
# The kernel rounds the unnormalised P to bf16, the plain attention the
# normalised P; 36 bf16 layers carry that difference to the logits
# (0.018 relative on an H100), far below what a wrong kernel gives
# (order 1)
E2E_REL_TOL = 5e-2
# The planned step rounds bf16 at other points than the hand-wired one:
# the MLP kernel keeps both up-projections in f32 and rounds only the
# hidden block and E (cuBLAS rounds every GEMM's output), stitched glue
# (qk-norm, rope, residuals) computes in f32, and the attention kernel
# differs as above; 36 layers carry that to the logits (0.018 relative
# on an H100).  A wrong MLP or plan gives order 1.
PLANNED_REL_TOL = 5e-2
# The MLP kernel's decode shape (M = max batch), one prefill shape, and
# the cache-free forward's B x S = 2 x 2048 tokens (timed and held here;
# no path launches it: the planned forward's H100 plan keeps the MLP
# three GEMMs at that shape, phase 4p)
MLP_SHAPES = {"decode": 4, "prefill": 144, "m4096": 4096}
# The cache-free forward: batch x tokens of qwen3-8b FULL
FORWARD = dict(batch=2, seq=2048, seed=2)
# The normalised attention kernel rounds the unnormalised P to bf16 per
# kv tile; the plain twin path (streaming attention) keeps P in f32.
# 36 bf16 layers carry that to the logits as in the decode step (0.0205
# relative on an H100).  The loss averages 4094 per-token terms of ~12,
# so its relative difference is far smaller (8.8e-6 on an H100).  What
# planted faults give against these limits: ``--plant-faults`` below.
FORWARD_REL_TOL = 5e-2
LOSS_REL_TOL = 1e-4
# Table II chains (batch, M, N, K, H) checked on the card: the
# quickstart's G1 and G4/G12, plus the chains where the H100 tuner
# picks the flat class (G2 and G11 in bf16, G5 in f32)
CHAINS = {"G1": (1, 512, 256, 64, 64), "G2": (1, 512, 256, 64, 128),
          "G4": (1, 512, 512, 256, 256), "G5": (1, 512, 512, 512, 256),
          "G11": (4, 1024, 1024, 128, 128),
          "G12": (8, 1024, 1024, 128, 128)}
# Tiles (bm, bn, bk, bh) and class at which G12 and G1 also run one
# split and an uneven one (3 splits of 16 and of 8 n blocks: runs of
# 6, 6, 4 and 3, 3, 2); one split holds the hidden of all of N, which
# the tuner's G12 tile (bm = 128) does not fit in bf16
CHAIN_SPLIT_TILES = {"G12": (dict(bm=32, bn=64, bk=128, bh=128), "flat"),
                     "G1": (dict(bm=16, bn=32, bk=64, bh=64), "deep")}
# examples/fuse_custom_chain.py: (batch, M, N, K, H, G), bf16
CHAIN3 = (1, 1024, 512, 64, 64, 64)
# Table III attention (heads, M, N, K, H) checked on the card
ATTN_TABLE_III = {"S2": (12, 512, 512, 64, 64), "S6": (16, 256, 256, 80, 80)}

SERVE = dict(batch=4, n_requests=8, prompt_len=128, gen=32, page_size=16,
             seed=1)
# Fixed-batch generate at full width: batch x prompt, gen tokens; its
# last step's logits are held to the cache-free forward within
# E2E_REL_TOL, the decode-step checks' limit
GENERATE = dict(batch=4, prompt_len=128, gen=32, seed=3)
# Phase 4f's depth: its fourteen fresh engines, many of them eager, took
# about 115 s of the full run at all 36 layers on an H100
RELIABILITY_LAYERS = 4
# The MQA config served at full width after qwen3-8b: its paged decode
# runs the partial kernel at a GQA group of 48
GRANITE = "granite-20b"
# The MHA config served at full width after qwen3-8b: its paged decode
# runs the partial kernel at a GQA group of 1 (16.4 GB of bf16)
CODEQWEN = "codeqwen1.5-7b"
# Phase 4h, the MoE family served: olmoe-1b-7b at every FULL width and
# depth (6.92 B parameters, 13.84 GB in bf16), then mixtral-8x7b at
# every FULL width with its depth cut to 16 of 32 layers (46.70 B
# parameters, 93.4 GB, do not fit one 80 GB card; 16 layers are 23.48 B,
# 46.96 GB).  Phase 3 checks the partial kernel at mixtral's windowed
# decode over N = MIXTRAL_N slots (the window and one page past it).
OLMOE = "olmoe-1b-7b"
MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 16
MIXTRAL_N = 4096 + 32
# mixtral's long request: a prompt of 4096 tokens and 48 generated
# tokens, whose decode positions (4096..4142) cross the window of 4096,
# so that the engine gives the pages wholly below it back
LONG = dict(prompt_len=4096, gen=48, seed=5)
# A routing flip is a (token, layer) served by other experts on the
# kernel path than on the plain path: another top-k set (the two
# attentions round bf16 differently, which can move a token's 8th and
# 9th router logits past each other), or an assignment dropped over
# capacity on one side only.  It moves the token by a whole expert's
# share, which no rounding limit covers, and this random model amplifies
# any rounding difference through its layers (PERF.md §6, PR 20).  So
# the held comparisons run each layer on the same input with the kernel
# path's routing pinned on the plain path, within the dense limits; the
# flips and the unpinned and end-to-end distances are printed beside a
# control.  The unpinned forward loss, a mean over 4094 tokens of ~11
# of which each flip moves one by O(0.3), is held to 1e-2.
MOE_FLIP_LOSS_REL_TOL = 1e-2
# Phase 4g, training: qwen3-8b at every FULL width, the depth cut to 8
# of 36 layers.  AdamW keeps 16 B a parameter (bf16 weight and
# gradient, f32 master, m and v): the 8.19 B parameters of 36 layers
# need 131 GB, more than one 80 GB card; 8 layers (2.79 B parameters)
# need 44.6 GB.  One TokenPipeline(seed 0) batch of B=1 x S=2048 (more
# than 2 bkv: the streaming twin runs under autograd), the train CLI's
# defaults (lr 3e-4, warmup min(10, steps // 4 + 1), clip 1.0, decay 0.1)
TRAIN = dict(n_layers=8, batch=1, seq=2048, steps=20, seed=0, lr=3e-4)
# T1 holds one bf16 step's loss and gradients to the same step with the
# weights upcast to f32 (TF32 off).  bf16 rounds every product's output
# (2^-9 relative) through 8 layers forward and back.  The loss averages
# 2048 terms, so its roundings mostly cancel (3.8e-6 relative on an
# H100); the global norm is dominated by the large leaves (1.1e-4); a
# leaf's gradient carries the roundings of its layer and those above it
# (median 0.021, worst 0.027 at a qk-norm scale, lowest cosine 0.9996).
# Each limit sits well above its reading; a gradient that is missing or
# wrong is at relative error ~1 (the planted fault below: exactly 1).
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GNORM_REL_TOL = 2e-3
TRAIN_GRAD_REL_TOL = 0.1     # each leaf, relative error in the 2-norm
# ``--plant-faults``' training faults (TRAIN_FAULTS) detach the output
# of this layer's block of one kind (the fourth attention or RG-LRU
# block), so that its weights get no gradient
TRAIN_FAULT_LAYER = 3
# T3, restart on the card: qwen3 SMOKE (f32), a StepRunner
# checkpointing every 4 steps, a StepFailure planted at step 6 of 10,
# and a second runner resuming from step 8.  Restored state is bitwise
# the saved one and the steps run under torch.use_deterministic_algorithms,
# so each loss must equal the uninterrupted run's up to one f32
# rounding of a reduction.
RESTART = dict(steps=10, ckpt_every=4, fail_at=6, resume_at=8, batch=4,
               seq=64, lr=1e-2)
RESTART_LOSS_REL_TOL = 1e-6
# Phase 4i, the hybrid and vision-prefix decoders at every FULL width,
# random weights from seed 0: recurrentgemma-2b (26 layers = 8 x (rglru,
# rglru, attn) + (rglru, rglru), 10 q-heads on 1 kv head of 256, local
# window 2048, tied embeddings; no depth cut) and pixtral-12b (40 dense
# layers after 1024 prefix embeddings; no depth cut but in training).
RG = "recurrentgemma-2b"
PIXTRAL = "pixtral-12b"
# The cache-free forward of each: recurrentgemma at B=1 x S=4096, so
# that the window of 2048 bites (8 attention launches a call); pixtral
# at B=2 x (1024 prefix + 1024 tokens), qwen3-8b's kernel shape (40)
RG_FORWARD = dict(b=1, s=4096)
PIXTRAL_FORWARD = dict(b=2, s=2048)
# generate: recurrentgemma's decode positions 2040..2071 wrap the
# attention layers' ring of 2048 slots; pixtral's follow 1024 prefix
# embeddings and a prompt of 128
RG_GENERATE = dict(batch=4, prompt_len=2040, gen=32, seed=3)
PIXTRAL_GENERATE = GENERATE
# A prefill and then teacher-forced decode steps (B=1), each step's
# logits against the cache-free forward's row over the same positions,
# within E2E_REL_TOL (tests/test_archs_smoke.py:89-106 at full width):
# recurrentgemma's steps cross the ring of 2048
DECODE_CHECK = {RG: dict(prompt_len=2040, steps=16, seed=6),
                PIXTRAL: dict(prompt_len=128, steps=16, seed=6)}
# One training step of each (``launch.train.train``, B=1 x S=2048
# tokens, after 1024 prefix embeddings for pixtral), no kernel: AdamW
# keeps 16 B a parameter, so recurrentgemma at full depth (2.894 B) is
# 46.3 GB; pixtral's 40 layers (12.25 B) need 196 GB, and 6 of them
# (1.342 B of embedding and head, 1.636 B of blocks) 47.7 GB
ARCH_TRAIN = dict(batch=1, seq=2048)
PIXTRAL_TRAIN_LAYERS = 6
# T1 at recurrentgemma-2b's full depth: one bf16 step against the f32
# step, as 4g does at 8 of qwen3-8b's layers, where the readings were
# loss 3.8e-6, grad norm 1.1e-4, a leaf's worst 0.027.  26 layers carry
# 3.25x the layers' roundings forward and back; the recurrence itself is
# f32 (its gates' products are bf16).  Scaled linearly: norm ~3.6e-4,
# worst leaf ~0.09; the limits keep 4g's margin for the norm (2e-3) and
# 2.8x for a leaf (0.25), 4x below a gradient that is missing or wrong
# (relative error ~1).  The loss is another matter (PERF.md §6):
# the model scales its tied embedding by x50 and reads logits over a
# 256000 vocab at a loss of 14.5, so one bf16 step's loss sits ~1e-4
# from the f32 step's at any depth (a CPU probe at these widths and 3 to
# 12 layers: 6e-5 to 1.5e-4); the limit 1e-3 is 7x that, and below what
# the sqrt(d_model) constant left unrounded in the f32 step alone gives
# (1.5e-3 on the card).
RG_T1_LIMITS = (1e-3, 2e-3, 0.25)
# Phase 4j, the state-space and encoder-decoder families at every FULL
# width and depth, bf16, random weights from seed 0, no kernel on any of
# their paths (as in the JAX package): mamba2-1.3b (48 Mamba-2 layers,
# d_model 2048, 64 SSD heads of 64, state 128, chunk 256, no MLP, tied
# vocab 50280; 1.34 B parameters, 2.69 GB) and whisper-small (12 encoder
# and 12 decoder layers, d_model 768, 12 heads of 64, 1500 frames,
# 65536 learned decoder positions, tied vocab 51865; 0.29 B, 0.58 GB)
MAMBA = "mamba2-1.3b"
WHISPER = "whisper-small"
# mamba's cache-free forward and loss: B=2 x S=4096, 16 chunks of 256.
# The SSD's decay is (2, 16, 64, 256, 256) f32, 537 MB a layer, and its
# product with C B another; both transient under inference mode
MAMBA_FORWARD = dict(b=2, s=4096)
# The SSD check takes this layer's inputs from that forward and runs the
# chunked form against the one-token recurrence stepped over all 4096
# positions, both in f32 (TF32 off).  The chunked form exponentiates
# differences of cumulative sums that reach ~-200 over a chunk (dA ~
# -0.8 a step), each good to ~1e-5 relative; the recurrence multiplies
# exps of one step.  So y and the final state agree to ~1e-5 in the
# 2-norm; the limit is 10x that.  Dropping the inter-chunk term (the
# planted fault) loses what each chunk's first rows read from the
# chunks before: a few percent of y.
SSD_LAYER = 24
SSD_REL_TOL = 1e-4
# whisper's cache-free loss and forward: B=4 over 1500 frames and 448
# tokens (its published decoder context)
WHISPER_FORWARD = dict(b=4, s=448)
# generate: mamba batch 4, prompt 128, 32 tokens; whisper batch 4,
# prompt 64, 32 tokens, decoded from position 64 + 1500 as the JAX
# package's generate does
MAMBA_GENERATE = GENERATE
WHISPER_GENERATE = dict(batch=4, prompt_len=64, gen=32, seed=3)
# teacher-forced decode after a prefill (B=4): mamba 16 steps after
# 4080 tokens (the prefill zero-padded to 4096), whisper 16 steps after
# 432 tokens (to its 448)
DECODE_CHECK[MAMBA] = dict(prompt_len=4080, steps=16, seed=6)
DECODE_CHECK[WHISPER] = dict(prompt_len=432, steps=16, seed=6)
# mamba2's decode steps and generate's last logits against the forward.
# The decode path is exact: in f32 the check reads ~3e-6 (a CPU probe at
# full width, 2 layers), and on the card it runs in f32 too, held to
# MAMBA_F32_REL_TOL (3.95e-5 on an H100).  In bf16 each GEMM rounds a decode step's rows
# otherwise than the forward's (another M), and this random model carries
# those roundings through its layers, growing with depth and varying with
# the tokens: 0.003 at 2 layers and 0.011 to 0.06 at 8 (the same probe),
# on an H100 at 48 layers 0.0764 over 16 random tokens after 4080 (this
# check's first run, then held to E2E_REL_TOL) and 0.407 at generate's
# last step over a greedy run of one repeated token, where even the f32
# weights read 1.8e-3 (f32 roundings carried as far).  The decode check
# is held to 2x its bf16 reading (a state lost or misplaced reads order
# 1) and in f32; generate's distance is printed, not held.
MAMBA_DECODE_REL_TOL = 0.15
MAMBA_F32_REL_TOL = 1e-3
# One training step of each: mamba at B=1 x S=2048 (AdamW's 16 B a
# parameter: 21.5 GB, and the SSD's saved f32 tensors, ~0.3 GB a layer),
# whisper at B=4 x 448 tokens over 1500 frames (4.6 GB)
WHISPER_TRAIN = dict(batch=4, seq=448)
# T1 at mamba2's 48 layers (4g's B=1 x S=2048).  A CPU probe at these
# widths (B=1, S=256 to 512, weights from seed 0) read loss 2.7e-4, grad
# norm 1.2e-2 and a worst leaf of 0.36 (median 0.22) at 48 layers,
# worst leaf 0.16 / 0.24 at 12 / 24: this random model's bf16 noise grows
# with depth.  The limits sit 7x, 4x and 2x above; a gradient that is
# missing or wrong reads 1 per leaf.
MAMBA_T1_LIMITS = (2e-3, 5e-2, 0.75)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi


def build_phase() -> None:
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_build.build, n) for n in names}
        for n, fut in futures.items():
            path, log = fut.result()
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"build {n}: {path.name} {regs}")
    print(f"build seconds: {time.perf_counter() - t0:.2f}")


def _attn_inputs(dtype, b, hq, hkv, m, n, d, seed, per_request=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, hq, m, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, hkv, n, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, hkv, n, d, generator=g, device="cuda").to(dtype)
    if per_request:
        kv_pos = torch.arange(n, dtype=torch.int32, device="cuda").repeat(
            b, 1)
        q_pos = (n - m + torch.arange(m, dtype=torch.int32, device="cuda")
                 ).repeat(b, 1)
    else:
        kv_pos = torch.arange(n, dtype=torch.int32, device="cuda")
        q_pos = n - m + torch.arange(m, dtype=torch.int32, device="cuda")
    return q, k, v, kv_pos, q_pos


def kernel_check_phase(tuned: dict, tuned_mqa: dict) -> float:
    """The partial kernel against its plain version (the same kv split
    and merge) on the card; returns the largest absolute error over all
    cases.  ``tuned``: (N, dtype) -> the tuner's decode tiles at qwen3's
    GQA group of 4 (Hq=32, Hkv=8); ``tuned_mqa``: dtype -> the tuner's
    tiles at granite-20b's decode shape, a group of 48 (Hq=48, Hkv=1),
    N = the serve phases' context."""
    n_ctx, long = sorted({n for n, _ in tuned})
    bf, f32 = torch.bfloat16, torch.float32
    g_bq, g_bkv = tuned_mqa[bf]
    mqa = [  # granite-20b: the tuner's tiles and tiles around them
        ("MQA decode bf16", bf, 1, n_ctx, g_bq, g_bkv, 0, None, None),
        ("MQA decode f32", f32, 1, n_ctx, *tuned_mqa[f32], 0, None, None),
        ("MQA, kv tile x2", bf, 1, n_ctx, g_bq, 2 * g_bkv, 0, "ragged",
         None),
        ("MQA, 80-key tiles", bf, 1, n_ctx, 1, 80, 0, "ragged", None),
        ("MQA, one split", bf, 1, n_ctx, g_bq, g_bkv, 0, "ragged", 1),
        ("MQA window", bf, 1, n_ctx, g_bq, g_bkv, 40, "ragged", None),
    ]
    cases = [  # (name, dtype, m, n, bq, bkv, window, edit, splits)
        ("decode bf16", bf, 1, n_ctx, *tuned[n_ctx, bf], 0, None, None),
        ("decode f32", f32, 1, n_ctx, *tuned[n_ctx, f32], 0, None, None),
        ("ragged+dead", bf, 1, n_ctx, 1, 32, 0, "ragged", None),
        ("window", bf, 1, n_ctx, 1, 32, 40, "ragged", None),
        ("m>1 bq>1", f32, 8, 96, 4, 32, 0, None, None),
        ("n=200", bf, 1, 200, 1, 128, 0, None, None),
        ("long decode bf16", bf, 1, long, *tuned[long, bf], 0, "ragged",
         None),
        ("long decode f32", f32, 1, long, *tuned[long, f32], 0, "ragged",
         None),
        ("long, 128-key tiles", bf, 1, long, 1, 128, 0, "ragged", None),
        ("long window", bf, 1, long, 1, 128, 1000, "ragged", None),
        ("long, one split", bf, 1, long, 1, 128, 0, "ragged", 1),
        ("long, uneven split", bf, 1, long, 1, 128, 0, "ragged", 5),
    ]
    cases = [(*c, 32, 8) for c in cases] + [(*c, 48, 1) for c in mqa]
    return _partial_cases(cases)


def _partial_cases(cases, seed0: int = 0) -> float:
    """Each case (name, dtype, m, n, bq, bkv, window, edit, splits, Hq,
    Hkv) through the partial kernel and its plain version with the same
    kv split (``splits`` None: the wrapper's own) at B=4, D=128;
    ``edit`` "ragged" leaves unallocated slots, a shorter request and a
    dead row, "reclaimed" gathers the inputs through page tables with
    RECLAIMED entries (``_reclaimed_inputs``).  Returns the largest
    absolute error."""
    from repro_torch.kernels import attention as A
    worst = 0.0
    for i, (name, dt, m, n, bq_, bkv_, window, edit, splits, hq,
            hkv) in enumerate(cases):
        if edit == "reclaimed":
            q, k, v, kv_pos, q_pos = _reclaimed_inputs(
                dt, hq, hkv, n, window, seed0 + i)
        else:
            q, k, v, kv_pos, q_pos = _attn_inputs(dt, 4, hq, hkv, m, n, 128,
                                                  seed0 + i)
        if edit == "ragged":
            kv_pos[1, 17:40] = A.INVALID_POS     # unallocated slots
            q_pos[0, 0] = 90                     # a shorter request
            q_pos[2, 0] = -1                     # inactive slot: dead row
        bq_, bkv_, smem = A._check(q, k, v, kv_pos, q_pos, bq_, bkv_)
        if splits is None:                   # the wrapper's own split
            splits = A.partial_splits(4, hkv, m // bq_, n, bkv_, smem)[0]
            got = A.fused_attention_partial(q, k, v, kv_pos, q_pos, bq=bq_,
                                            bkv=bkv_, causal=True,
                                            window=window)
        else:                                # a split the wrapper would not
            got = A._launch(q, k, v, kv_pos, q_pos, bq_, bkv_, True, window,
                            128 ** -0.5, smem, splits)
        torch.cuda.synchronize()
        want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos, bkv_,
                                               True, window, 128 ** -0.5,
                                               splits)
        err = 0.0
        for x, w in zip(got, want):
            torch.testing.assert_close(x, w, **TOL[dt])
            err = max(err, float((x - w).abs().max()))
        if edit == "ragged" and float(got[2][2, :, 0].abs().max()) != 0.0:
            raise RuntimeError("a dead row did not emit l = 0")
        worst = max(worst, err)
        print(f"kernel vs plain [{name}] Hq={hq} Hkv={hkv} m={m} n={n} "
              f"tiles=({bq_},{bkv_}) splits={splits} {str(dt)[6:]}: "
              f"max|err|={err:.3g} tol={TOL[dt]} ok")
    return worst


def init_phase(cfg, depth: str = "no depth cut") -> dict:
    from repro_torch import tree as T
    from repro_torch.launch.steps import build_model
    t0 = time.perf_counter()
    params = build_model(cfg, device="cuda").init_params(0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in T.leaves(params))
    print(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.dh} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype} weights={n_bytes / 1e9:.2f} GB "
          f"(init {time.perf_counter() - t0:.1f}s, {depth})")
    return params


def _zero(*names) -> None:
    from repro_torch.kernels import capture
    for name in names:
        capture.counters()[name].launches = 0


def _read(*names) -> dict:
    from repro_torch.kernels import capture
    return {name: capture.counters()[name].launches for name in names}


def _path_counters() -> list:
    """Every kernel counter a path sets to 0 and reads: all but the
    three-GEMM kernel's, which the main paths leave running to be read
    once after them all."""
    from repro_torch.kernels import capture
    return [n for n in capture.counters() if n != "fused_gemm_chain3"]


SERVED = ("fused_attention_partial", "fused_mlp_chain")


def _serve_once(cfg, params, planned: bool, eager: bool):
    """One run of the workload on one path, the served kernels' counters
    set to 0 just before and read just after; returns (results, stats,
    engine, launches, set-up seconds, (shapes the tuner searched inside
    the run, their seconds))."""
    from repro_torch.core import api
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models.lm import LM, Runtime
    model = LM(cfg, Runtime(kernel_ops=True, planner=planned),
               device="cuda")
    tuned_before = set(api._CACHE)
    _zero(*SERVED)
    t0 = time.perf_counter()
    results, stats, engine = run_continuous(cfg, model, params, **SERVE,
                                            verbose=not eager,
                                            eager_decode=eager)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - stats["wall_s"]
    fresh = [tk for key, tk in api._CACHE.items() if key not in tuned_before]
    tuning = (len(fresh), sum(tk.tuning_seconds for tk in fresh))
    return results, stats, engine, _read(*SERVED), setup_s, tuning


#: The engine's reliability counters, printed for every serve run
REL_STATS = ("tier_demotions", "shadow_checks", "shadow_mismatches",
             "golden_probes", "golden_mismatches", "health_evictions")


def _deny_records() -> list:
    from repro_torch.core import schedule_cache
    return schedule_cache.list_quarantined()


def _no_degradation(label: str, stats=None) -> None:
    """With the reliability layer disarmed, nothing may have degraded:
    the engine served on tier 0 (``configured``) and the cache
    directory holds no ``deny-*.json`` record (every failure a guard
    records with the breaker writes one)."""
    if stats is not None:
        print(f"[{label}] reliability: exec_tier {stats['exec_tier']}, "
              + ", ".join(f"{k} {stats[k]}" for k in REL_STATS)
              + f", watchdog breaches {stats['watchdog_breaches']}")
        if stats["exec_tier"] != "configured" or stats["tier_demotions"]:
            raise RuntimeError(f"[{label}] the engine degraded: "
                               f"{stats['exec_tier']}")
    deny = _deny_records()
    print(f"[{label}] denylist records: {len(deny)}")
    if deny:
        raise RuntimeError(f"[{label}] a guard degraded: {deny}")


def serve_phase(cfg, params, planned: bool):
    """Serve the workload on one path, with the engine's decode step
    captured in a CUDA graph and then eagerly (``eager_decode``): the
    greedy tokens must be equal, and each run's counters must read the
    served steps' launches exactly (the capture's warm-up is counted
    apart).  ``planned`` on a config the planner cannot plan (MoE) is
    the planner-requested path: hand-wired blocks, no MLP launch.
    Returns (captured engine, its stats, its launches, the eager engine,
    its stats)."""
    from repro_torch.core import planner
    plan_runs = planned and planner.plannable(cfg)
    label = ("planned" if plan_runs else
             "planner-requested" if planned else "hand-wired")
    runs = {}
    for eager in (False, True):
        mode = "eager" if eager else "captured"
        results, stats, engine, launches, setup_s, tuning = _serve_once(
            cfg, params, planned, eager)
        runs[eager] = (results, stats, engine, launches)
        if not eager:
            bq, bkv = engine.model.rt.paged_block
            print(f"[{label}] tuner paged tiles: bq={bq} bkv={bkv} "
                  f"(schedule from {engine.regime_source})")
            print(f"[{label}, captured] capture warm-up launches (apart "
                  f"from the served count): "
                  f"{engine.captured.warmup_launches}; "
                  f"launches a replay adds: {engine.captured.launches}")
        print(f"[{label}, {mode}] served: {len(results)} requests "
              f"finished, {stats['generated']} tokens, "
              f"{stats['decode_steps']} decode steps, {stats['prefills']} "
              f"prefills, {stats['preemptions']} preemptions, "
              f"{stats['tok_per_s']:.2f} tok/s ({stats['wall_s']:.2f}s; "
              f"engine set-up {setup_s:.2f}s; the tuner searched "
              f"{tuning[0]} new shapes in the run, {tuning[1]:.2f}s)")
        steps, layers = stats["decode_steps"], cfg.n_layers
        want = {"fused_attention_partial": steps * layers,
                "fused_mlp_chain": ((steps + stats["prefills"]) * layers
                                    if plan_runs else 0)}
        for name, n in launches.items():
            print(f"[{label}, {mode}] {name} launches: {n} "
                  f"(want {want[name]})")
            if n != want[name]:
                raise RuntimeError(f"the {label} {mode} path launched "
                                   f"{name} {n} times, not {want[name]}")
        _no_degradation(f"{label}, {mode}", stats)
        budgets = [g for _, g in _workload(cfg)]
        if [len(r.tokens) for r in results] != budgets or any(
                r.outcome != "complete" for r in results):
            raise RuntimeError("a request did not complete its budget")
        if any(not 0 <= t < cfg.vocab for r in results for t in r.tokens):
            raise RuntimeError("a token outside the vocabulary")
    (got, stats, engine, launches), (want, eager_stats, eager_engine, _) = (
        runs[False], runs[True])
    same = [r.tokens for r in got] == [r.tokens for r in want]
    print(f"[{label}] captured vs eager greedy tokens equal: {same}; "
          f"tok/s captured {stats['tok_per_s']:.2f}, eager "
          f"{eager_stats['tok_per_s']:.2f}")
    if not same:
        raise RuntimeError(f"the {label} captured step's tokens differ "
                           f"from the eager step's")
    if plan_runs:
        plan = engine.decode_plan
        for c in plan.layer.chains:
            print(f"[planned] decode plan chain: {c.kind} "
                  f"{'+'.join(c.ops)} fused={c.fused} ai={c.ai:.4g} "
                  f"prologue={list(c.prologue)} "
                  f"epilogue={list(c.epilogue)}")
        print(f"[planned] decode plan standalone glue: "
              f"{list(plan.layer.glue)}, dropped stitches: "
              f"{list(plan.layer.dropped)}")
        for (m, dt, act), tiles in sorted(_mlp_tiles(cfg).items()):
            print(f"[planned] MLP tiles at M={m} {dt} {act}: {tiles}")
    return engine, stats, launches, eager_engine, eager_stats


def _mlp_tiles(cfg) -> dict:
    """The MLP tiles the tuner picked for each (M, A's type, act) this
    process tuned."""
    from repro_torch.core import api
    return {(k[1], k[7], k[6] if k[5] else f"ungated {k[6]}"):
            tk.params.as_kwargs()
            for k, tk in api._CACHE.items()
            if k[0] == "mlp" and k[2:4] == (cfg.d_ff, cfg.d_model)}


def _workload(cfg, spec=SERVE):
    from repro_torch.launch.serve import ragged_workload
    return ragged_workload(cfg.vocab, spec["n_requests"],
                           spec["prompt_len"], spec["gen"], spec["seed"])


def end_to_end_check(cfg, params, engine, planned_engine):
    """One full-width decode step of two requests through the attention
    kernel (with the engine's tuned tiles) and through the planned path
    (MLP kernel too), each against the same step through the plain
    hand-wired path: finite logits of the expected shape that agree
    within E2E_REL_TOL / PLANNED_REL_TOL."""
    from repro_torch.models.lm import LM, Runtime
    model = engine.model
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    cache, args = _two_request_step(cfg, params, engine)
    # each step rewrites the same kv slots with its own k/v first, so
    # every path sees the same prompt cache
    want, cache = plain.decode_step_paged(params, cache, *args)
    for label, m, tol in (("kernel attention", model, E2E_REL_TOL),
                          ("planned (MLP + attention kernels)",
                           planned_engine.model, PLANNED_REL_TOL)):
        got, cache = m.decode_step_paged(params, cache, *args)
        torch.cuda.synchronize()
        if got.shape != (2, cfg.vocab) or not torch.isfinite(got).all():
            raise RuntimeError(f"bad logits {tuple(got.shape)}")
        rel = float((got.float() - want.float()).norm()
                    / want.float().norm())
        agree = (got.argmax(-1) == want.argmax(-1)).tolist()
        print(f"end-to-end decode step, {label} vs the plain hand-wired "
              f"path at full width: rel err {rel:.3g} (tol {tol}), "
              f"argmax agree {agree}")
        if rel > tol:
            raise RuntimeError(f"the {label} path diverges from the "
                               f"plain path")


def _two_request_step(cfg, params, engine, spec=SERVE,
                      prefill_logits=None) -> tuple:
    """A fresh paged cache holding the first two requests' prompts (of
    the workload ``spec``), prefilled through ``engine``'s model, and
    the arguments of their first decode step: (cache, (tokens,
    positions, page table)).  Each prefill's last logits are appended
    to ``prefill_logits`` when it is given."""
    from repro_torch.serving import kv_pages as KP
    model = engine.model
    ps, mp = engine.page_size, engine.max_pages
    pool = KP.PagePool(engine.pool.n_pages, ps)
    cache = model.init_paged_cache(engine.pool.n_pages, ps)
    reqs = _workload(cfg, spec)[:2]
    allocs, last, lengths = [], [], []
    for prompt, _ in reqs:
        a = KP.RequestPages()
        if not a.ensure(len(prompt) + 1, pool):
            raise RuntimeError("the check's page pool is too small")
        toks = torch.zeros((1, math.ceil(len(prompt) / ps) * ps),
                           dtype=torch.long, device=engine.device)
        toks[0, :len(prompt)] = torch.from_numpy(prompt).long()
        logits, cache = model.prefill_paged(
            params, toks, cache,
            torch.from_numpy(KP.table_array([a], mp)).to(engine.device),
            len(prompt))
        allocs.append(a)
        if prefill_logits is not None:
            prefill_logits.append(logits)
        last.append(int(torch.argmax(logits[0])))
        lengths.append(len(prompt))
    dev = engine.device
    args = (torch.tensor(last, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.from_numpy(KP.table_array(allocs, mp)).to(dev))
    return cache, args


def profile_phase(run, label: str, what: str, timed: int = 5,
                  traced: int = 3) -> dict:
    """Where one call's time goes: host wall per call (synchronised, no
    profiler, mean of ``timed`` calls after one warm-up), then device
    time by kernel over ``traced`` calls from torch.profiler.  ``run``
    repeats the same work on the same state (a decode step rewrites the
    same kv slots)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        run()
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    wall_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            step()
    # kernel rows only: an operator's row repeats its kernels' time; the
    # profiler may keep fewer launches than were traced, so a kernel's
    # time a launch is its total over the launches it kept
    rows = [(e.self_device_time_total / (traced * 1e3), e.count // traced,
             e.key, e.self_device_time_total / (e.count * 1e3))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile [{label}]: {what} wall {wall_ms:.3f} ms without "
          f"profiler; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of the wall)")
    for ms, count, name, _ in rows[:8]:
        print(f"profile [{label}]:   {ms:8.3f} ms  {count:5d}x  "
              f"{name[:80]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[dict(ms=ms, count=c, name=n[:80], ms_per_launch=one)
                     for ms, c, n, one in rows[:3]])


def _span_ms(run, reps: int = 5) -> float:
    """Device milliseconds from the start to the end of one ``run()``
    (CUDA events around it, idle gaps inside included), mean of
    ``reps`` after one warm-up."""
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_profile_phase(engine, label: str) -> dict:
    """One full decode step of ``engine`` (every slot live, at contexts
    of 135 to 156 slots, pages from the engine's idle pool), captured (a
    replay of the engine's graph) and eager (the same step op by op on
    the same static inputs): host wall, device busy and busy share
    from ``profile_phase``, and the step's device span between two
    events.  The two steps' greedy tokens must be equal."""
    from repro_torch.serving import kv_pages as KP
    b = engine.max_batch
    lengths = [SERVE["prompt_len"] + SERVE["gen"] - 5 - 7 * i
               for i in range(b)]
    allocs = []
    for n in lengths:
        a = KP.RequestPages()
        if not a.ensure(n + 1, engine.pool):
            raise RuntimeError("the engine's pool cannot hold the step")
        allocs.append(a)
    engine._tokens.copy_(torch.arange(1, b + 1))
    engine._positions.copy_(torch.tensor(lengths, dtype=torch.int32))
    engine._table.copy_(torch.from_numpy(KP.table_array(allocs,
                                                        engine.max_pages)))
    what = f"decode step (batch {b}, {engine.model.cfg.n_layers} layers)"
    out = {}
    for mode, run in (("captured", engine.captured.replay),
                      ("eager", engine._decode)):
        prof = profile_phase(run, f"{label}, {mode}", what)
        prof["span_ms"] = _span_ms(run)
        print(f"profile [{label}, {mode}]: device span of one step "
              f"{prof['span_ms']:.3f} ms (events)")
        out[mode] = prof
    got = engine.captured.replay()[0].clone()
    want = engine._decode()[0]
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"the {label} replay's tokens differ from the "
                           f"eager step's")
    for a in allocs:
        a.release(engine.pool)
    return out


def _fresh_process() -> None:
    """What a relaunch starts from: no breaker memory, plan memo or
    tuned-kernel memo; the disk cache (and its records) stays."""
    from repro_torch.core import api, planner
    from repro_torch.reliability import breaker
    breaker.reset()
    planner.clear_memo()
    api.clear_cache()


def _clear_records() -> None:
    """Disarm every fault and lift every denylist record (the operator's
    ``clear_quarantine``)."""
    from repro_torch.core import schedule_cache
    from repro_torch.core.perf_model import H100
    from repro_torch.reliability import faults
    faults.clear()
    for rec in _deny_records():
        schedule_cache.clear_quarantine(tuple(rec["key"]), H100)
    _fresh_process()


def _rel_serve(cfg, params, label: str, planned: bool = False,
               eager: bool = False, kernel_ops: bool = True) -> dict:
    """One run of the workload (SERVE) in a fresh engine, the served
    kernels' counters set to 0 just before and read just after; every
    request must complete its budget.  Prints the engine's reliability
    counters."""
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models.lm import LM, Runtime
    model = LM(cfg, Runtime(kernel_ops=kernel_ops, planner=planned),
               device="cuda")
    _zero(*SERVED)
    results, stats, engine = run_continuous(cfg, model, params, **SERVE,
                                            eager_decode=eager)
    torch.cuda.synchronize()
    launches = _read(*SERVED)
    walls = sorted(stats["decode_step_wall_s"])
    print(f"[{label}] exec_tier {stats['exec_tier']}, "
          + ", ".join(f"{k} {stats[k]}" for k in REL_STATS)
          + f"; {stats['decode_steps']} decode steps, {stats['prefills']} "
          f"prefills; launches {launches}; median decode step "
          f"{1e3 * walls[len(walls) // 2]:.3f} ms; denylist records "
          f"{len(_deny_records())}")
    budgets = [g for _, g in _workload(cfg)]
    if [len(r.tokens) for r in results] != budgets or any(
            r.outcome != "complete" for r in results):
        raise RuntimeError(f"[{label}] a request did not complete")
    return dict(tokens=[r.tokens for r in results], stats=stats,
                engine=engine, launches=launches,
                median_step_ms=1e3 * walls[len(walls) // 2])


def _fired(spec, label: str) -> int:
    print(f"[{label}] fault fired {spec.n_fired} times "
          f"({spec.n_seen} checks)")
    if spec.n_fired < 1:
        raise RuntimeError(f"[{label}] the armed fault never fired")
    return spec.n_fired


def _r3_paged_seam(cfg, params) -> dict:
    """R3: ``kernel_dispatch`` at the paged seam (a trigger on its
    ``op``, limit 1), hand-wired, ``eager_decode=True`` (a replay runs
    no Python, so a layer seam is tested op by op): 0 partial kernel
    launches, its denylist record, the tokens of a ``kernel_ops=False``
    eager run (the same program), the quarantine read back by a
    relaunch (0 launches again), and after ``clear_quarantine`` decode
    steps x layers launches."""
    from repro_torch.reliability import faults
    with faults.injected("kernel_dispatch", nth=0,
                         trigger=lambda c: c.get("op") == "attn-paged"
                         ) as spec:
        r3 = _rel_serve(cfg, params, "R3 paged fault, eager", eager=True)
        fired = _fired(spec, "R3")
    deny = _deny_records()
    if (r3["launches"]["fused_attention_partial"] != 0 or len(deny) != 1
            or deny[0]["key"][0] != "attn-paged"):
        raise RuntimeError(f"[R3] the paged seam did not degrade: "
                           f"{r3['launches']}, {deny}")
    print(f"[R3] denylist record: key {deny[0]['key']}, reason "
          f"{deny[0]['reason']!r}")
    plain = _rel_serve(cfg, params, "R3 kernel_ops=False, eager",
                       eager=True, kernel_ops=False)
    if r3["tokens"] != plain["tokens"]:
        raise RuntimeError("[R3] the degraded tokens differ from the "
                           "kernel_ops=False run's")
    _fresh_process()
    relaunch = _rel_serve(cfg, params, "R3 relaunch, eager", eager=True)
    if relaunch["launches"]["fused_attention_partial"] != 0:
        raise RuntimeError("[R3] the relaunch ignored the quarantine")
    _clear_records()
    cleared = _rel_serve(cfg, params, "R3 cleared, eager", eager=True)
    want = cleared["stats"]["decode_steps"] * cfg.n_layers
    if cleared["launches"]["fused_attention_partial"] != want:
        raise RuntimeError(f"[R3] after clear_quarantine: "
                           f"{cleared['launches']}, want {want}")
    return dict(fired=fired, launches_faulted=r3["launches"],
                launches_relaunch=relaunch["launches"],
                launches_cleared=cleared["launches"],
                tokens_equal_plain=True)


def _r4_engine_seam(cfg, params) -> dict:
    """R4: ``kernel_dispatch`` at the engine's ``engine-prefill`` seam,
    hand-wired, captured: tier 0 -> 1 on the first prefill (retried on
    the same inputs), every request complete, the twin tier's graph
    replayed (0 partial kernel launches), no denylist record; the
    captured twin and the eager twin steps profiled; a relaunch starts
    at tier 0 and launches decode steps x layers."""
    from repro_torch.reliability import faults
    with faults.injected("kernel_dispatch", nth=0,
                         trigger=lambda c: c.get("op") == "engine-prefill"
                         ) as spec:
        r4 = _rel_serve(cfg, params, "R4 engine-prefill fault, captured")
        fired = _fired(spec, "R4")
    st, eng = r4.pop("stats"), r4.pop("engine")
    if (st["exec_tier"] != "torch-twin" or st["tier_demotions"] != 1
            or r4["launches"]["fused_attention_partial"] != 0
            or eng.captured is None or _deny_records()):
        raise RuntimeError(f"[R4] {st['exec_tier']} after "
                           f"{st['tier_demotions']} demotions, launches "
                           f"{r4['launches']}, records {_deny_records()}")
    twin = step_profile_phase(eng, "torch-twin (R4)")
    del eng
    _fresh_process()
    relaunch = _rel_serve(cfg, params, "R4 relaunch, captured")
    want = relaunch["stats"]["decode_steps"] * cfg.n_layers
    if (relaunch["stats"]["exec_tier"] != "configured"
            or relaunch["launches"]["fused_attention_partial"] != want):
        raise RuntimeError(f"[R4] relaunch {relaunch['launches']}")
    return dict(fired=fired, tier_demotions=st["tier_demotions"],
                launches_faulted=r4["launches"],
                launches_relaunch=relaunch["launches"],
                torch_twin_step_ms=twin["captured"]["wall_ms"],
                eager_twin_step_ms=twin["eager"]["wall_ms"])


def _r1_shadows(cfg, params, planned: bool) -> dict:
    """R1, one serve path, captured: a disarmed run, a run armed at
    ``DEFAULT_RATE`` (its decode step against the disarmed one's), then
    ``shadowing(1.0, probe=True)``: one golden probe (it reaches the
    kernels: one step's launches more than the disarmed run), a shadow
    of every dispatch, no mismatch, tier 0, the disarmed run's tokens
    and its pool, bitwise (the rows a shadow's twin wrote restored); the
    largest per-request logit gap of a comparison beside the limit (and
    the largest elementwise |diff| / (atol + rtol |twin|) at the dtype's
    TOLERANCES, read by a spy on the comparison's inputs), the cost of a
    shadow and of the probe.  Returns the summary and the disarmed
    run's tokens."""
    from repro_torch.reliability import sentinels
    from repro_torch.serving.engine import ServingEngine
    label = "planned" if planned else "hand-wired"
    _fresh_process()
    base = _rel_serve(cfg, params, f"R1 {label} disarmed", planned=planned)
    _fresh_process()
    with sentinels.shadowing(sentinels.DEFAULT_RATE, probe=False):
        sampled = _rel_serve(cfg, params, f"R1 {label} armed at 1/64",
                             planned=planned)
    _fresh_process()
    agree, tol_ratio = ServingEngine._agree, [0.0]

    def spy(self, got, want):
        tol_ratio[0] = max(tol_ratio[0], _tol_ratio(got, want))
        return agree(self, got, want)

    ServingEngine._agree = spy
    try:
        with sentinels.shadowing(1.0, probe=True) as spec:
            r1 = _rel_serve(cfg, params, f"R1 {label} shadow 1.0",
                            planned=planned)
    finally:
        ServingEngine._agree = agree
    st, eng = r1["stats"], r1["engine"]
    gap = {"rel_per_request": eng.shadow_gap, "tol_ratio": tol_ratio[0]}
    # a shadow's wall runs from the configured dispatch's return to the
    # verdict, so at decode it includes waiting for the configured step
    # on the card: what a shadow adds to a step is the served medians'
    # difference.  Medians; the first decode shadow also captures the
    # save, restore and twin graphs (printed apart).
    shadow_ms = {ph: 1e3 * sorted(w)[len(w) // 2]
                 for ph, w in eng.shadow_wall_s.items()}
    shadow_ms["first_decode"] = 1e3 * eng.shadow_wall_s["decode"][0]
    shadow_ms["added_to_decode_step"] = (r1["median_step_ms"]
                                         - base["median_step_ms"])
    accepts = ("bitwise equality" if eng._bitwise
               else f"rel <= {eng._rel_tol} per request")
    print(f"[R1 {label}] largest logit gap of a comparison: per "
          f"request, rel (2-norm) {gap['rel_per_request']:.4g}; "
          f"max |diff| / (atol + rtol |twin|) {gap['tol_ratio']:.4g} at "
          f"{cfg.dtype} TOLERANCES {sentinels.TOLERANCES[cfg.dtype]} "
          f"(past 1: the elementwise test fails); the engine accepts "
          f"{accepts}; a "
          f"decode shadow adds {shadow_ms['added_to_decode_step']:.3f} "
          f"ms to the served median step ({r1['median_step_ms']:.3f} "
          f"against {base['median_step_ms']:.3f} ms: twin step, save, "
          f"restore, compare); a shadow's wall from the dispatch's "
          f"return to its verdict {shadow_ms['decode']:.3f} ms at decode "
          f"(the configured step's device time included), "
          f"{shadow_ms['prefill']:.3f} ms at prefill (medians), the "
          f"first decode shadow {shadow_ms['first_decode']:.3f} ms (its "
          f"graphs captured); golden probe "
          f"{1e3 * eng.golden_probe_s:.1f} ms; kernel-level checks "
          f"{spec.n_checked - st['shadow_checks']}, mismatches in all "
          f"{spec.n_mismatched}; decode step disarmed "
          f"{base['median_step_ms']:.3f} ms, armed at 1/64 "
          f"{sampled['median_step_ms']:.3f} ms (medians; "
          f"{sampled['stats']['shadow_checks']} sampled checks)")
    probe = {"fused_attention_partial": cfg.n_layers,
             "fused_mlp_chain": cfg.n_layers if planned else 0}
    extra = {k: r1["launches"][k] - base["launches"][k] for k in SERVED}
    ok = (st["golden_probes"] == 1 and st["golden_mismatches"] == 0
          and st["shadow_checks"] == st["decode_steps"] + st["prefills"]
          and st["shadow_mismatches"] == 0 == spec.n_mismatched
          and st["exec_tier"] == "configured"
          and r1["tokens"] == base["tokens"] and extra == probe
          and _pool_equal(eng, base["engine"]) and not _deny_records())
    if not ok:
        raise RuntimeError(f"[R1 {label}] failed: "
                           f"{ {k: st[k] for k in REL_STATS} }, tier "
                           f"{st['exec_tier']}, tokens equal "
                           f"{r1['tokens'] == base['tokens']}, pool equal "
                           f"{_pool_equal(eng, base['engine'])}, launches "
                           f"beyond the disarmed run {extra} (want "
                           f"{probe}), records {_deny_records()}")
    return dict(shadow_checks=st["shadow_checks"], gap=gap,
                shadow_ms=shadow_ms,
                golden_probe_ms=1e3 * eng.golden_probe_s,
                step_ms_disarmed=base["median_step_ms"],
                step_ms_armed_default_rate=sampled["median_step_ms"],
                sampled_checks=sampled["stats"]["shadow_checks"]
                ), base["tokens"]


def _tol_ratio(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) at the dtype's
    TOLERANCES: past 1 where the elementwise test fails."""
    from repro_torch.reliability import sentinels
    rtol, atol = sentinels.TOLERANCES[str(want.dtype).split(".")[-1]]
    w = want.double()
    return float(((got.double() - w).abs()
                  / (atol + rtol * w.abs())).max())


def _r1_kernel_shadows(cfg, params, planned: bool, want_tokens) -> dict:
    """R1, one serve path, ``eager_decode=True`` under ``shadowing(1.0,
    probe=False)``: the kernel-level seams (skipped in a capture) shadow
    every guarded dispatch at the workload's real context lengths, each
    kernel output held elementwise to its dtype's TOLERANCES: as many
    kernel-level checks as kernel launches, no mismatch at any seam,
    tier 0, no record, and the tokens of R1's disarmed run.  Prints the
    largest elementwise ratio of each seam over the rows it compares
    (the live slots' at the paged seam), read by a spy on the twin's
    thunk."""
    from repro_torch.reliability import sentinels
    label = "planned" if planned else "hand-wired"
    shadow, ratio = sentinels.shadow_kernel, {}

    def spy(fp, out, ref_fn, rows=None):
        def ref():
            want = ref_fn()
            read = rows() if rows is not None else slice(None)
            ratio[fp[0]] = max(ratio.get(fp[0], 0.0),
                               _tol_ratio(out[read], want[read]))
            return want
        return shadow(fp, out, ref, rows)

    _fresh_process()
    sentinels.shadow_kernel = spy
    try:
        with sentinels.shadowing(1.0, probe=False) as spec:
            r = _rel_serve(cfg, params, f"R1 {label} kernel shadows, "
                           f"eager", planned=planned, eager=True)
    finally:
        sentinels.shadow_kernel = shadow
    st = r["stats"]
    checks = spec.n_checked - st["shadow_checks"]
    launches = sum(r["launches"].values())
    print(f"[R1 {label} kernel seams] {checks} kernel-level checks for "
          f"{launches} launches, {spec.n_mismatched} mismatches in all; "
          f"largest max |diff| / (atol + rtol |twin|) at "
          f"{cfg.dtype} TOLERANCES {sentinels.TOLERANCES[cfg.dtype]}: "
          + ", ".join(f"{k} {v:.4g}" for k, v in ratio.items()))
    if (checks != launches or set(ratio) != {
            "attn-paged", *(["mlp"] if planned else [])}
            or spec.n_mismatched or st["shadow_mismatches"]
            or st["exec_tier"] != "configured" or _deny_records()
            or r["tokens"] != want_tokens):
        raise RuntimeError(f"[R1 {label} kernel seams] failed: {checks} "
                           f"checks, {launches} launches, "
                           f"{spec.n_mismatched} mismatches, tier "
                           f"{st['exec_tier']}, records {_deny_records()}"
                           f", tokens equal "
                           f"{r['tokens'] == want_tokens}")
    return dict(kernel_checks=checks, tol_ratio=ratio)


def _pool_equal(a, b) -> bool:
    """Two engines' KV pools equal bitwise past the scratch page."""
    return all(torch.equal(x[k][1:], y[k][1:])
               for x, y in zip(a.cache, b.cache)
               for k in ("k_pages", "v_pages"))


def _r2_wrong_answer(cfg, params) -> dict:
    """R2: ``wrong_answer`` at the 6th ``engine-decode`` seam, sentinels
    at 1.0, planned, captured: one shadow mismatch, one demotion, the
    twin tier captured anew, the decode plan's denylist record with the
    shadow's reason, every request complete; a relaunch with fresh
    breaker memory reads the record and skips the decode preplan (the
    decode steps run hand-wired: no MLP kernel at decode)."""
    import itertools

    from repro_torch.core import planner, schedule_cache
    from repro_torch.core.perf_model import H100
    from repro_torch.reliability import faults, sentinels
    seen = itertools.count()
    with sentinels.shadowing(1.0, probe=True) as sspec:
        with faults.injected(
                "wrong_answer", limit=1,
                trigger=lambda c: (c.get("op") == "engine-decode"
                                   and next(seen) == 5)) as spec:
            r2 = _rel_serve(cfg, params, "R2 wrong answer, planned",
                            planned=True)
            fired = _fired(spec, "R2")
    st, eng = r2.pop("stats"), r2.pop("engine")
    rec = schedule_cache.is_quarantined(eng._decode_plan_key(), H100)
    if (st["shadow_mismatches"] != 1 or st["tier_demotions"] != 1
            or st["exec_tier"] != "torch-twin" or eng.captured is None
            or rec is None or "shadow mismatch" not in rec["reason"]
            or sspec.n_mismatched != 1):
        raise RuntimeError(f"[R2] {st['shadow_mismatches']} mismatches, "
                           f"{st['tier_demotions']} demotions, tier "
                           f"{st['exec_tier']}, record {rec}")
    print(f"[R2] decode plan quarantined: {rec['reason']!r}")
    del eng
    _fresh_process()
    relaunch = _rel_serve(cfg, params, "R2 relaunch, planned",
                          planned=True)
    rst = relaunch["stats"]
    want = {"fused_attention_partial": rst["decode_steps"] * cfg.n_layers,
            "fused_mlp_chain": rst["prefills"] * cfg.n_layers}
    if (relaunch["engine"].decode_plan is not None
            or relaunch["launches"] != want
            or any(k[8] == "decode" for k in planner._PLAN_MEMO)):
        raise RuntimeError(f"[R2] the relaunch did not skip the decode "
                           f"preplan: launches {relaunch['launches']} "
                           f"(want {want})")
    return dict(fired=fired, shadow_mismatches=st["shadow_mismatches"],
                tier_demotions=st["tier_demotions"], reason=rec["reason"],
                launches_relaunch=relaunch["launches"])


def _depth_cut(cfg, params, n: int) -> tuple:
    """``cfg`` at its first ``n`` layers and ``params`` holding those
    layers' weights (the same tensors: nothing is copied)."""
    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, layers=params["layers"][:n]))


def reliability_phase(cfg, params) -> dict:
    """The reliability layer on qwen3-8b at FULL width, cut to
    RELIABILITY_LAYERS, with the serve phases'
    workload (SERVE), each run in a fresh engine: R3 and R4 (faults at
    a layer seam and at the engine seam), R1 on both paths (shadows at
    rate 1.0 without a fault) and R2 (a planted wrong answer).  Every
    phase that arms a fault asserts that it fired, then disarms it and
    lifts the records (R5).  Prints a ``{"reliability": ...}`` line."""
    cfg, params = _depth_cut(cfg, params, RELIABILITY_LAYERS)
    print(f"[reliability] {cfg.name} at {cfg.n_layers} layers (depth cut)")
    out = {}
    _clear_records()
    out["R3"] = _r3_paged_seam(cfg, params)
    _clear_records()
    out["R4"] = _r4_engine_seam(cfg, params)
    _clear_records()
    out["R1"] = {}
    for planned in (False, True):
        label = "planned" if planned else "hand-wired"
        out["R1"][label], tokens = _r1_shadows(cfg, params, planned)
        out["R1"][label]["kernel_seams"] = _r1_kernel_shadows(
            cfg, params, planned, tokens)
    _clear_records()
    out["R2"] = _r2_wrong_answer(cfg, params)
    _clear_records()
    _no_degradation("reliability phase, records lifted")
    print(json.dumps({"reliability": out}))
    return out


def generate_phase(cfg, params, spec=GENERATE, tol=E2E_REL_TOL) -> dict:
    """Fixed-batch ``generate`` at full width (``spec``; GENERATE: batch
    4, prompt 128, 32 tokens) over a contiguous cache, after a vision
    config's prefix embeddings (``launch.serve.demo_side_inputs``), the
    decode step captured in a CUDA graph and then eagerly: equal greedy
    tokens, no kernel launched (the contiguous cache reaches none, as in
    the JAX package; every counter set to 0 just before and read after),
    and the last step's logits within ``tol`` (None: printed, not held)
    of the cache-free
    forward (the plain twin path) over the same prefix and tokens.  An
    MoE config's forward routes all 636 tokens together, so its expert
    capacity, and with it what drops, differs from the decode step's by
    design (the JAX package's own MoE decode-vs-forward test allows
    0.5): there the distance is printed and the tokens are what is
    held.  An encoder-decoder's ``generate`` decodes from position
    prompt + n_frames, as the JAX package's does (ROADMAP Queue 3), where
    its forward puts the same tokens at prompt..: there no forward
    matches, and ``decode_check`` holds its decode steps instead."""
    from repro_torch.launch.serve import demo_side_inputs, generate
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    b, plen, gen = (spec[k] for k in ("batch", "prompt_len", "gen"))
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g,
                            device="cuda")
    side = demo_side_inputs(cfg, b, "cuda", spec["seed"])
    model = build_model(cfg, Runtime(kernel_ops=True), device="cuda")
    names = _path_counters()
    runs = {}
    for eager in (False, True):
        mode = "eager" if eager else "captured"
        # half the tokens (the prefill, the capture and half the steps)
        # timed apart give one decode step's wall: (t(gen) - t(half)) /
        # (gen - half).  Not 2 tokens: the cache of prompt + 2 slots may
        # have a length whose only small divisor sends the prefill's
        # streaming twin through blocks of 2 keys (2042 = 2 x 1021);
        # recurrentgemma's 2056 and 2072 both hold the ring of 2048.  A
        # first untimed run takes the shapes' first calls.
        half = gen // 2
        generate(model, params, prompts, half, eager=eager, **side)
        t0 = time.perf_counter()
        generate(model, params, prompts, half, eager=eager, **side)
        torch.cuda.synchronize()
        t_half = time.perf_counter() - t0
        _zero(*names)
        t0 = time.perf_counter()
        tokens, logits = generate(model, params, prompts, gen, eager=eager,
                                  **side)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _read(*names)
        step_ms = (dt - t_half) / (gen - half) * 1e3
        print(f"[generate {cfg.name}, {mode}] B={b} side inputs "
              f"{ {k: tuple(t.shape) for k, t in side.items()} } "
              f"prompt={plen} gen={gen}: "
              f"{b * gen / dt:.2f} tok/s ({dt:.2f}s, prefill and capture "
              f"included); a decode step {step_ms:.3f} ms ({gen} tokens "
              f"{dt:.3f}s - {half} tokens {t_half:.3f}s over "
              f"{gen - half}); launches {launches} (want 0: no kernel on "
              f"this path)")
        if any(launches.values()):
            raise RuntimeError(f"generate launched {launches}")
        if tokens.shape != (b, gen) or not (
                (tokens >= 0) & (tokens < cfg.vocab)).all():
            raise RuntimeError(f"bad tokens {tokens.shape}")
        runs[mode] = (tokens, logits, b * gen / dt, step_ms)
    (tokens, logits, tps, step_ms), (want_tokens, want_logits, eager_tps,
                                      eager_step_ms) = (
        runs["captured"], runs["eager"])
    if not (tokens == want_tokens).all():
        raise RuntimeError("the captured generate's tokens differ from "
                           "the eager one's")
    out = dict(tok_per_s=tps, eager_tok_per_s=eager_tps, step_ms=step_ms,
               eager_step_ms=eager_step_ms)
    if cfg.family == "encdec":
        print(f"[generate {cfg.name}] captured tokens equal the eager "
              f"run's; decoded from position {plen} + "
              f"{cfg.encoder.n_frames} frames, so no forward matches its "
              f"logits (decode_check holds the decode steps)")
        return out
    full = torch.cat([prompts, torch.from_numpy(tokens[:, :-1]).cuda()], 1)
    plain = build_model(cfg, Runtime(kernel_ops=False), device="cuda")
    with torch.inference_mode():
        ref = plain.forward(params, full, **side)[:, -1]
    torch.cuda.synchronize()
    if logits.shape != ref.shape or not torch.isfinite(logits).all():
        raise RuntimeError(f"bad logits {tuple(logits.shape)}")
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    same = float((logits.float() - want_logits.float()).abs().max())
    held = tol is not None and not cfg.moe
    why = "MoE capacity" if cfg.moe else "rounding carried by the model"
    print(f"[generate {cfg.name}] captured tokens equal the eager run's; "
          f"last step's logits vs the cache-free forward over the same "
          f"{cfg.n_prefix_embeds} + {full.shape[1]} positions: rel err "
          f"{rel:.3g} (tol {tol if held else 'not held: ' + why}; "
          f"{cfg.dtype}); captured vs eager logits max|diff| {same:.3g}")
    if held and rel > tol:
        raise RuntimeError("generate's logits diverge from the forward")
    return dict(out, rel=rel)


def _time_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device milliseconds of one ``fn()``: ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times between two events, so the
    host's launch overhead (larger than a decode-size kernel) is not
    what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _adaptive_ms(fn, budget_ms: float = 200.0, reps: int = 2) -> float:
    """``_time_ms`` with as many calls per graph as fit ``budget_ms``."""
    one = _time_ms(fn, iters=1, reps=1)
    iters = max(1, min(20, int(budget_ms / max(one, 1e-3))))
    return _time_ms(fn, iters=iters, reps=reps)


def time_phase(n: int, tiles: tuple, label: str, hq: int = 32,
               hkv: int = 8, other_tiles=(), window: int = 0) -> dict:
    """kernel_ms, bound_ms, plain_ms and library_ms of the partial
    attention at B=4, M=1, D=128, bf16 over N slots (Hq=32, Hkv=8 as
    qwen3-8b and mixtral-8x7b, Hq=48, Hkv=1 as granite-20b, or
    Hq=Hkv=16 as olmoe-1b-7b), with the wrapper's kv split and an
    optional sliding ``window`` (then only the window's keys count in
    the bound: the ones the function needs); and the kernel's time at
    ``other_tiles`` ((bq, bkv, splits), splits None for the wrapper's
    own)."""
    from repro_torch.kernels import attention as A
    b, m, d, dt = 4, 1, 128, torch.bfloat16
    q, k, v, kv_pos, q_pos = _attn_inputs(dt, b, hq, hkv, m, n, d, 99)
    bq, bkv, smem = A._check(q, k, v, kv_pos, q_pos, *tiles)
    splits = A.partial_splits(b, hkv, m // bq, n, bkv, smem)[0]
    scale = d ** -0.5
    kernel_ms = _time_ms(lambda: A.fused_attention_partial(
        q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv, causal=True, window=window,
        scale=scale))
    plain_ms = _time_ms(lambda: A.fused_attention_partial_plain(
        q, k, v, kv_pos, q_pos, bkv, True, window, scale, splits))
    mask = (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    if window:
        mask &= kv_pos[:, None, None, :] > q_pos[:, None, :, None] - window
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
    other = {}
    for obq, obkv, osplits in other_tiles:
        obq, obkv, osmem = A._check(q, k, v, kv_pos, q_pos, obq, obkv)
        osplits = osplits or A.partial_splits(b, hkv, m // obq, n, obkv,
                                              osmem)[0]
        other[f"{obq}/{obkv} x{osplits}"] = _time_ms(
            lambda: A._launch(q, k, v, kv_pos, q_pos, obq, obkv, True,
                              window, scale, osmem, osplits))
    live = min(n, window) if window else n    # keys of the q row's window
    in_bytes = (_nbytes(q, kv_pos, q_pos)
                + _nbytes(k, v) * live // n)
    out_bytes = (b * hq * m * d + 2 * b * hq * m) * 4
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * hq * m * live * d / PEAK_OPS[dt] * 1e3
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tiles=[bq, bkv], splits=splits, other_tiles_ms=other)
    print(f"times [{label}] B={b} Hq={hq} Hkv={hkv} M={m} N={n} D={d} bf16 "
          f"window={window} tiles=({bq},{bkv}): " + json.dumps(out))
    return out


def _mlp_weights(cfg, gated: bool, seed: int):
    """Full-width MLP weights on the card, scaled like the model's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, ff, dt = cfg.d_model, cfg.d_ff, getattr(torch, cfg.dtype)

    def w(rows, cols):
        return (torch.randn(1, rows, cols, generator=g, device="cuda")
                / rows ** 0.5).to(dt)

    return w(d, ff), w(ff, d), (w(d, ff) if gated else None)


def _mlp_case(cfg, m, a_dtype, gated, act, seed):
    """(inputs, tuned kwargs) of one MLP kernel case: the tiles are the
    tuner's for the chain ``ops.mlp_chain`` would tune (A's type)."""
    from repro_torch.core import api
    wu, wd, wg = _mlp_weights(cfg, gated, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    a = torch.randn(1, m, cfg.d_model, generator=g, device="cuda").to(
        a_dtype)
    tk = api.fuse_mlp_chain(m, cfg.d_ff, cfg.d_model,
                            dtype=str(a_dtype).replace("torch.", ""),
                            gated=gated, act=act)
    return (a, wu, wd, wg), tk.params.as_kwargs()


def _mlp_run(x, act, kw, splits):
    """One MLP kernel launch and its plain version with the same split:
    the wrapper's own split (``splits=None``) or a forced count through
    ``_launch``.  Returns (kernel's E, plain E, clamped tiles, splits)."""
    from repro_torch.kernels import gemm_chain as G
    a, wu, wd, wg = x
    tiles, (own, _) = G._check(a, wu, wd, wg, act, **kw)
    if splits is None:
        splits = own
        got = G.fused_mlp_chain(a, wu, wd, wg=wg, act=act, **kw)
    else:
        got = G._launch(a, wu, wd, wg, act, *tiles, splits)
    torch.cuda.synchronize()
    want = G.fused_mlp_chain_plain(a, wu, wd, wg, act, tiles[1], splits)
    return got, want, tiles, splits


def mlp_check_phase(cfg) -> float:
    """The MLP kernel against its plain version on the card with the same
    n split: at full width with the tuner's tiles (decode, prefill and
    M=4096), with one split and an uneven split, at M=1, at ragged M, N
    and H, each activation, and f32 A with bf16 weights; then two
    launches of the decode case, which must be bitwise equal.  Returns
    the largest absolute error."""
    from repro_torch.kernels import gemm_chain as G
    worst = 0.0
    d, ff, bf, f32 = cfg.d_model, cfg.d_ff, torch.bfloat16, torch.float32
    ragged = dict(bm=16, bn=96, bk=32, bh=64)
    cases = [  # (name, M, A's type, gated, act, splits, dims, tiles)
        ("decode", MLP_SHAPES["decode"], bf, True, "silu", None, None, None),
        # one split holds the hidden of all of N on chip: N cut to 768
        ("decode, one split", MLP_SHAPES["decode"], bf, True, "silu", 1,
         (768, d), None),
        ("decode, uneven split", MLP_SHAPES["decode"], bf, True, "silu", 7,
         None, None),
        ("decode, f32 A / bf16 weights", MLP_SHAPES["decode"], f32, True,
         "silu", None, None, None),
        ("prefill", MLP_SHAPES["prefill"], bf, True, "silu", None, None,
         None),
        ("M=4096", MLP_SHAPES["m4096"], bf, True, "silu", None, None, None),
        ("M=1", 1, bf, True, "silu", None, None, None),
        ("ungated gelu", 16, bf, False, "gelu", None, None, None),
        ("ungated relu", 16, bf, False, "relu", None, None, None),
        ("ragged M, N, H, deep", 37, bf, True, "silu", None, (1000, 200),
         dict(ragged, style="deep")),
        ("ragged M, N, H, flat, uneven split", 37, bf, False, "gelu", 5,
         (1000, 200), dict(ragged, style="flat")),
    ]
    for i, (name, m, at, gated, act, splits, dims, tiles) in enumerate(cases):
        (a, wu, wd, wg), kw = _mlp_case(cfg, m, at, gated, act, 10 + i)
        if dims is not None:                 # N and H cut short
            n, h = dims
            wu, wd = wu[:, :, :n].contiguous(), wd[:, :n, :h].contiguous()
            wg = None if wg is None else wg[:, :, :n].contiguous()
            kw = tiles or kw
        got, want, tl, sp = _mlp_run((a, wu, wd, wg), act, kw, splits)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"bad MLP output {tuple(got.shape)}")
        torch.testing.assert_close(got, want, **TOL[at])
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        print(f"MLP kernel vs plain [{name}] M={m} N={wu.shape[2]} K={d} "
              f"H={wd.shape[2]} {_dtname(at)} {kw['style']} tiles={tl} "
              f"splits={sp}: max|err|={err:.3g} tol={TOL[at]} ok")
        del a, wu, wd, wg, got, want
    (a, wu, wd, wg), kw = _mlp_case(cfg, MLP_SHAPES["decode"], bf, True,
                                    "silu", 30)
    first = G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)
    second = G.fused_mlp_chain(a, wu, wd, wg=wg, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise RuntimeError("two launches of the decode MLP differ")
    print(f"MLP kernel determinism [decode] M={MLP_SHAPES['decode']} "
          f"N={ff}: two launches bitwise equal")
    return worst


def _mlp_sweep_tiles(m: int, kw: dict, n: int, k: int, h: int) -> list:
    """The tuner's MLP tiles and a few around them (bn halved and
    doubled, the other bk of 32 / 64, one m tile of all M rows with 64
    columns), each one the bf16 kernel takes and whose layout fits a
    block at the wrapper's split."""
    from repro_torch.core.perf_model import (H100, mlp_smem_bytes,
                                             mlp_splits, mlp_tiles_ok)
    from repro_torch.kernels.gemm_chain import clamp_tiles
    out = [kw]
    bn, bk = kw["bn"], kw["bk"]
    for alt in ({"bn": bn // 2}, {"bn": bn * 2},
                {"bk": 64 if bk != 64 else 32}, {"bm": m, "bn": 64}):
        t = {**kw, **alt}
        if t in out:
            continue
        tiles = clamp_tiles(m, n, k, h, t["bm"], t["bn"], t["bk"], t["bh"],
                            t["style"])
        if t["bn"] % 16 or not mlp_tiles_ok(tiles[0], tiles[1], n, 2, 2):
            continue
        per = mlp_splits(1, m, n, k, h, *tiles, 2, 2, True)[1]
        if mlp_smem_bytes(*tiles, 2, 2, True, per) <= H100.smem_per_block:
            out.append(t)
    return out


def mlp_time_phase(cfg, label: str, m: int, profile: bool = True) -> dict:
    """kernel_ms, plain_ms, unfused_ms and bound_ms of the gated bf16
    MLP at M rows with the tuner's tiles and split, the device time of
    its two kernels (the split's and the merge) from a profile, and the
    kernel's time at tiles around the pick (the profile left out where
    not ``profile``).  unfused_ms is the hand-wired
    ``mlp_block`` (three torch.matmul and silu * mul): the time the
    fused path replaces, as no single PyTorch call computes a gated
    MLP."""
    from repro_torch.kernels import gemm_chain as G
    from repro_torch.models import layers as L
    (a, wu, wd, wg), kw = _mlp_case(cfg, m, getattr(torch, cfg.dtype),
                                    True, "silu", 99)
    k, n, h = cfg.d_model, cfg.d_ff, cfg.d_model
    tiles, (splits, _) = G._check(a, wu, wd, wg, "silu", **kw)
    kernel_ms = _adaptive_ms(lambda: G.fused_mlp_chain(a, wu, wd, wg=wg,
                                                       **kw), reps=3)
    plain_ms = _time_ms(lambda: G.fused_mlp_chain_plain(a, wu, wd, wg,
                                                        "silu", tiles[1],
                                                        splits),
                        iters=2 if m > 1024 else 5, reps=2)
    p = {"w_gate": wg[0], "w_up": wu[0], "w_down": wd[0]}
    unfused_ms = _adaptive_ms(lambda: L.mlp_block(p, a[0], cfg))
    prof = profile_phase(lambda: G.fused_mlp_chain(a, wu, wd, wg=wg, **kw),
                         f"MLP {label}", f"fused_mlp_chain M={m}", timed=3,
                         traced=3) if profile else {"top": []}
    sweep = {}
    for t in _mlp_sweep_tiles(m, kw, n, k, h):
        sp = G._check(a, wu, wd, wg, "silu", **t)[1][0]
        sweep[f"{t['style']} {t['bm']}/{t['bn']}/{t['bk']}/{t['bh']} "
              f"x{sp}"] = _adaptive_ms(
            lambda t=t: G.fused_mlp_chain(a, wu, wd, wg=wg, **t), reps=2)
    nbytes = _nbytes(a, wu, wd, wg) + m * h * a.element_size()
    ops = 2 * m * k * n * 2 + 2 * m * n * h
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
               **_bound(nbytes, ops, torch.bfloat16), tiles=kw,
               splits=splits, tile_sweep_ms=sweep,
               device_ms_by_kernel={
                   r["name"].replace("void (anonymous namespace)::",
                                     "")[:40]: r["ms_per_launch"]
                   for r in prof["top"]})
    print(f"MLP times [{label}] M={m} N={n} K=H={k} bf16 gated silu: "
          + json.dumps(out))
    return out


def _dtname(dt) -> str:
    return str(dt).replace("torch.", "")


def _randn(shapes, dt, seed, scaled=False):
    """Seeded normal tensors on the card; ``scaled`` divides each by the
    square root of its second dim (a weight's fan-in) from the second
    tensor on, so chained products stay of magnitude ~1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for i, shape in enumerate(shapes):
        t = torch.randn(*shape, generator=g, device="cuda")
        if scaled and i:
            t = t / shape[1] ** 0.5
        out.append(t.to(dt))
    return out


def _attention_ops(b, hq, m, n, d, dv, causal, window=0) -> float:
    """Operations of attention on this run's data: 2 (d + dv) per live
    (row, key) pair — q k^T and p v — with the rows at the tail of the
    kv sequence; a row with no key works on every key (mean of v)."""
    rows = torch.arange(m, dtype=torch.float64) + n - m
    if causal or window > 0:
        hi = torch.clamp(rows, max=n - 1)
        lo = (torch.clamp(rows - window + 1, min=0) if window > 0
              else torch.zeros_like(rows))
        live = torch.where(rows >= 0, hi - lo + 1, torch.full_like(rows, n))
    else:
        live = torch.full_like(rows, n)
    return 2.0 * (d + dv) * float(live.sum()) * b * hq


def _bound(nbytes: float, ops: float, dt) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dt] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _chain3_tiles(dt) -> dict:
    """The H100 tuner's (bm, bn, bk) for CHAIN3 (no api entry point
    tunes the three-GEMM chain; examples/fuse_custom_chain.py searches
    it directly)."""
    from repro_torch.core.chain import gemm_chain3
    from repro_torch.core.perf_model import H100
    from repro_torch.core.search import heuristic_search
    b, m, n, k, h, g = CHAIN3
    ts = heuristic_search(gemm_chain3(m, n, k, h, g, batch=b,
                                      dtype=_dtname(dt)),
                          hw=H100, seed=0).best.tile_sizes
    return dict(bm=ts["m"], bn=ts["n"], bk=ts["k"])


def _chain_run(x, kw, splits):
    """One GEMM-chain kernel launch and its plain version with the same
    split: the wrapper's own (``splits=None``) or a forced count through
    ``_launch_chain``.  Returns (kernel's E, plain E, clamped tiles,
    splits)."""
    from repro_torch.kernels import gemm_chain as G
    a, b, d = x
    tiles, (own, _), _ = G.check_gemm_chain(
        a, b, d, kw["bm"], kw["bn"], kw["bk"], kw["bh"], kw["style"])
    if splits is None:
        splits = own
        got = G.fused_gemm_chain(a, b, d, **kw)
    else:
        got = G._launch_chain(a, b, d, *tiles, splits)
    torch.cuda.synchronize()
    want = G.fused_gemm_chain_plain(a, b, d, tiles[1], splits)
    return got, want, tiles, splits


def _attention_cases(cases, seed0: int) -> float:
    """Each case (name, B, Hq, Hkv, M, N, D, dtype, causal, window,
    tiles or None for the tuner's) through the normalised attention
    kernel and its plain version; returns the largest absolute
    error."""
    from repro_torch.core import api
    from repro_torch.kernels import attention as A
    worst = 0.0
    for i, (name, bb, h, g, m, n, d, dt, causal, window,
            tiles) in enumerate(cases):
        if tiles is None:
            tk = api.fuse_attention(m, n, d, d, heads=h, batch=bb,
                                    dtype=_dtname(dt), causal=causal,
                                    window=window)
            fn, tiles = tk, (tk.params.bq, tk.params.bkv)
        else:
            fn = (lambda q, k, v, t=tiles, c=causal, w=window:
                  A.fused_attention(q, k, v, bq=t[0], bkv=t[1], causal=c,
                                    window=w))
        q, k, v = _randn([(bb, h, m, d), (bb, g, n, d), (bb, g, n, d)],
                         dt, seed0 + i)
        with torch.inference_mode():
            got = fn(q, k, v)
            torch.cuda.synchronize()
            want = A.fused_attention_plain(q, k, v, tiles[1],
                                           causal or window > 0, window,
                                           1.0 / d ** 0.5)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"bad attention output {tuple(got.shape)}")
        torch.testing.assert_close(got, want, **TOL[dt])
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        print(f"attention kernel vs plain [{name}] B={bb} Hq={h} "
              f"Hkv={g} M={m} N={n} D={d} {_dtname(dt)} causal={causal} "
              f"window={window} tiles={tiles}: max|err|={err:.3g} "
              f"tol={TOL[dt]} ok")
    return worst


def slice3_check_phase(cfg) -> dict:
    """fused_attention, fused_gemm_chain (flat and deep) and
    fused_gemm_chain3 against their plain versions on the card with the
    tuner's H100 tiles; returns the largest absolute error of each."""
    from repro_torch.core import api
    from repro_torch.kernels import gemm_chain as G
    from repro_torch.kernels import gemm_chain3 as G3
    worst = dict(fused_attention=0.0, fused_gemm_chain=0.0,
                 fused_gemm_chain3=0.0)
    b, s = FORWARD["batch"], FORWARD["seq"]
    hq, hkv, dh, bf = cfg.n_heads, cfg.n_kv_heads, cfg.dh, torch.bfloat16
    # (name, B, Hq, Hkv, M, N, D, dtype, causal, window, tiles or None
    # for the tuner's)
    attn = [("forward", b, hq, hkv, s, s, dh, bf, True, 0, None)]
    for tiles in ((64, 64), (128, 64), (128, 128), (16, 16)):
        attn.append((f"forward, tiles {tiles}", b, hq, hkv, s, s, dh, bf,
                     True, 0, tiles))
    attn.append(("forward, window 1024", b, hq, hkv, s, s, dh, bf, True,
                 s // 2, None))
    attn.append(("forward shape, no mask", b, hq, hkv, s, s, dh, bf, False,
                 0, None))
    for name, (h, m, n, k, _) in ATTN_TABLE_III.items():
        for dt in (torch.float32, bf):
            attn.append((name, 1, h, h, m, n, k, dt, False, 0, None))
    attn.append(("M>N causal: mean-of-v rows", 1, 8, 2, 512, 256, 64, bf,
                 True, 0, None))
    attn.append(("M<N causal: tail rows", 1, 8, 2, 256, 512, 64, bf, True,
                 0, None))
    # kv tiles that are no multiple of 16, padded inside the bf16 kernel:
    # the tuner's whole-N tile at S=100, and 24-key tiles two a stage
    attn.append(("S=100: one padded kv tile", b, hq, hkv, 100, 100, dh, bf,
                 True, 0, None))
    attn.append(("24-key padded tiles, window", 1, 8, 2, 240, 240, dh, bf,
                 True, 60, (48, 24)))
    worst["fused_attention"] = _attention_cases(attn, seed0=20)
    ran, split_picks = set(), 0
    for i, (name, (bb, m, n, k, h)) in enumerate(CHAINS.items()):
        for dt in (torch.float32, torch.bfloat16):
            tk = api.fuse_gemm_chain(m, n, k, h, batch=bb, dtype=_dtname(dt))
            kw = tk.params.as_kwargs()
            a, bm_, d = _randn([(bb, m, k), (bb, k, n), (bb, n, h)], dt,
                               40 + i, scaled=True)
            styles = [kw["style"]]
            other = "flat" if kw["style"] == "deep" else "deep"
            try:      # the same tiles in the other class, where they fit
                G.check_gemm_chain(a, bm_, d, kw["bm"], kw["bn"], kw["bk"],
                                   kw["bh"], other)
                styles.append(other)
            except ValueError:
                pass
            cases = [(style, kw, None) for style in styles]
            if name in CHAIN_SPLIT_TILES:     # one split and an uneven one
                tiles, style = CHAIN_SPLIT_TILES[name]
                cases += [(style, tiles, 1), (style, tiles, 3)]
            for style, tiles, splits in cases:
                got, want, tl, sp = _chain_run(
                    (a, bm_, d), {**tiles, "style": style}, splits)
                if got.shape != (bb, m, h) or not torch.isfinite(got).all():
                    raise RuntimeError(f"bad chain output {tuple(got.shape)}")
                torch.testing.assert_close(got, want, **TOL[dt])
                err = float((got.float() - want.float()).abs().max())
                worst["fused_gemm_chain"] = max(worst["fused_gemm_chain"],
                                                err)
                ran.add((style, dt))
                split_picks += splits is None and sp > 1
                print(f"gemm chain kernel vs plain [{name}] "
                      f"{(bb, m, n, k, h)} {_dtname(dt)} {style} tiles={tl} "
                      f"splits={sp}{'' if splits is None else ' (forced)'} "
                      f"(tuner: {kw}): max|err|={err:.3g} tol={TOL[dt]} ok")
            first = G.fused_gemm_chain(a, bm_, d, **kw)
            second = G.fused_gemm_chain(a, bm_, d, **kw)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise RuntimeError(f"two launches of {name} "
                                   f"{_dtname(dt)} differ")
    print("gemm chain kernel determinism: two launches of every pick "
          "bitwise equal")
    if len(ran) != 4 or not split_picks:
        raise RuntimeError(f"flat and deep did not both run in f32 and "
                           f"bf16 ({sorted(map(str, ran))}), or no pick "
                           f"ran its own n split")
    bb, m, n, k, h, g = CHAIN3
    for dt in (torch.bfloat16, torch.float32):
        tiles = _chain3_tiles(dt)
        xs = _randn([(bb, m, k), (bb, k, n), (bb, n, h), (bb, h, g)], dt, 60,
                    scaled=True)
        got = G3.fused_gemm_chain3(*xs, **tiles)
        torch.cuda.synchronize()
        want = G3.fused_gemm_chain3_plain(*xs, tiles["bn"])
        if got.shape != (bb, m, g) or not torch.isfinite(got).all():
            raise RuntimeError(f"bad chain3 output {tuple(got.shape)}")
        torch.testing.assert_close(got, want, **TOL[dt])
        err = float((got.float() - want.float()).abs().max())
        worst["fused_gemm_chain3"] = max(worst["fused_gemm_chain3"], err)
        print(f"gemm chain3 kernel vs plain {CHAIN3} {_dtname(dt)} "
              f"tiles={tiles}: max|err|={err:.3g} tol={TOL[dt]} ok")
    return worst


def _forward_batch(cfg, b: int = FORWARD["batch"],
                   s: int = FORWARD["seq"]) -> dict:
    """B x S seeded positions of the cache-free path, on the card (B=2 x
    S=2048 unless given): S tokens, or for a vision config its prefix
    embeddings (``launch.serve.demo_side_inputs``) and S - prefix
    tokens."""
    from repro_torch.launch.serve import demo_side_inputs
    g = torch.Generator(device="cuda").manual_seed(FORWARD["seed"])
    tokens = torch.randint(0, cfg.vocab, (b, s - cfg.n_prefix_embeds),
                           generator=g, device="cuda")
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels,
            **demo_side_inputs(cfg, b, "cuda", FORWARD["seed"])}


def _divergence(loss, logits, want_loss, want,
                loss_tol: float = LOSS_REL_TOL) -> dict:
    """Loss and logits of a kernel-path run against the plain twin
    path's: the relative loss difference, the logits' relative error
    (Frobenius norm) and the share of positions whose argmax agrees;
    ``within`` the loss's limit ``loss_tol`` and FORWARD_REL_TOL."""
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    rel = float((logits.float() - want.float()).norm() / want.float().norm())
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    return dict(loss=float(loss), plain_loss=float(want_loss),
                loss_rel=loss_rel, logits_rel=rel, argmax_agree=agree,
                within=loss_rel <= loss_tol and rel <= FORWARD_REL_TOL)


def forward_phase(cfg, params, batch=None) -> dict:
    """The cache-free path at full width: ``LM.loss`` and ``LM.forward``
    of ``batch`` (B=2 x S=2048 seeded tokens unless given; a vision
    config's prefix embeddings ahead of them) with
    ``Runtime(kernel_ops=True)``, each with the attention kernel's
    counter set to 0 just before and read just after (one launch per
    attention layer: 36 for qwen3-8b), each against the same call on the
    plain twin path; then a profile of one forward."""
    from repro_torch.kernels import attention as A
    from repro_torch.models.lm import LM, Runtime
    batch = _forward_batch(cfg) if batch is None else batch
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    kern = LM(cfg, Runtime(kernel_ops=True), device="cuda")
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    b, s = tokens.shape[0], tokens.shape[1] + cfg.n_prefix_embeds
    n_attn = kern.kinds.count("attn")
    launches = {}
    with torch.inference_mode():
        A.fused_attention.launches = 0
        t0 = time.perf_counter()
        loss = kern.loss(params, batch)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
        launches["loss"] = A.fused_attention.launches
        A.fused_attention.launches = 0
        t0 = time.perf_counter()
        logits = kern.forward(params, tokens, prefix)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches["forward"] = A.fused_attention.launches
        print(f"[forward {cfg.name}] B={b} S={s} (prefix "
              f"{cfg.n_prefix_embeds}): loss {float(loss):.5f} in "
              f"{loss_s:.2f}s, forward {tuple(logits.shape)} in "
              f"{fwd_s:.2f}s (first calls); fused_attention launches "
              f"{launches} (want {n_attn} each)")
        if any(n != n_attn for n in launches.values()):
            raise RuntimeError(f"the forward launched fused_attention "
                               f"{launches} times, not {n_attn}")
        if logits.shape != (b, s, cfg.vocab) or not (
                torch.isfinite(logits).all() and torch.isfinite(loss)):
            raise RuntimeError("non-finite or misshapen forward output")
        want_loss = plain.loss(params, batch)
        want = plain.forward(params, tokens, prefix)
        torch.cuda.synchronize()
        div = _divergence(loss, logits, want_loss, want)
        del want
        print(f"[forward {cfg.name}] kernel path vs the plain twin path "
              f"at full width: loss {div['loss']:.5f} vs "
              f"{div['plain_loss']:.5f} (rel {div['loss_rel']:.3g}, tol "
              f"{LOSS_REL_TOL}); logits "
              f"rel err {div['logits_rel']:.3g} (tol {FORWARD_REL_TOL}), "
              f"argmax agree {div['argmax_agree']:.4f}")
        if not div["within"]:
            raise RuntimeError("the kernel forward diverges from the plain "
                               "twin path")
        del logits
        prof = profile_phase(lambda: kern.forward(params, tokens, prefix),
                             f"forward {cfg.name}", f"cache-free forward "
                             f"(B={b}, S={s}, {cfg.n_layers} layers)",
                             timed=2, traced=1)
    return dict(launches=launches, profile=prof, **div)


# Faults planted in the cache-free forward's attention by
# ``--plant-faults``: each still launches the kernel, with a wrong mask,
# wrong keys or a wrong scale.  q, k, v: (B, H, S, D).
def _no_causal(attn, q, k, v, causal, window, scale):
    return attn(q, k, v, causal=False, window=window, scale=scale)


def _next_key(attn, q, k, v, causal, window, scale):
    # every row sees one key ahead of its own position
    return attn(q, k.roll(-1, dims=2), v.roll(-1, dims=2), causal=causal,
                window=window, scale=scale)


def _half_window(attn, q, k, v, causal, window, scale):
    return attn(q, k, v, causal=causal, window=q.shape[2] // 2,
                scale=scale)


def _scale_1_over_d(attn, q, k, v, causal, window, scale):
    return attn(q, k, v, causal=causal, window=window,
                scale=1.0 / q.shape[-1])


FAULTS = {"none": None, "no_causal": _no_causal, "next_key": _next_key,
          "half_window": _half_window, "scale_1_over_d": _scale_1_over_d}


def fault_phase(cfg, params) -> dict:
    """The cache-free forward's check against planted faults: the plain
    twin path's loss and logits once, then ``LM.loss`` and
    ``LM.forward`` on the kernel path with each fault of ``FAULTS`` put
    in front of ``kernels.ops.attention`` (the attention kernel still
    launched 36 times per call).  Raises unless the unfaulted run is
    within both limits and every fault goes past at least one."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM, Runtime
    batch = _forward_batch(cfg)
    kern = LM(cfg, Runtime(kernel_ops=True), device="cuda")
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    attn = ops.attention
    results = {}
    with torch.inference_mode():
        want_loss = plain.loss(params, batch)
        want = plain.forward(params, batch["tokens"])
        for name, fault in FAULTS.items():
            if fault is not None:
                ops.attention = (lambda q, k, v, causal=False, window=0,
                                 scale=None, f=fault:
                                 f(attn, q, k, v, causal, window, scale))
            try:
                A.fused_attention.launches = 0
                loss = kern.loss(params, batch)
                logits = kern.forward(params, batch["tokens"])
                torch.cuda.synchronize()
                n = A.fused_attention.launches
            finally:
                ops.attention = attn
            if n != 2 * cfg.n_layers:
                raise RuntimeError(f"[fault {name}] {n} attention launches, "
                                   f"not {2 * cfg.n_layers}")
            results[name] = _divergence(loss, logits, want_loss, want)
            del logits
            r = results[name]
            print(f"[fault {name}] loss rel {r['loss_rel']:.3g} (tol "
                  f"{LOSS_REL_TOL}), logits rel {r['logits_rel']:.3g} (tol "
                  f"{FORWARD_REL_TOL}), argmax agree "
                  f"{r['argmax_agree']:.4f}: "
                  f"{'within' if r['within'] else 'caught'}")
    print(json.dumps({"faults": results}))
    if not results["none"]["within"]:
        raise RuntimeError("the unfaulted kernel forward diverges")
    missed = [n for n, r in results.items() if n != "none" and r["within"]]
    if missed:
        raise RuntimeError(f"planted faults within the limits: {missed}")
    return results


def attention_time_phase(cfg, table_iii: bool = True,
                         b: int = FORWARD["batch"], m: int = FORWARD["seq"],
                         window: int = 0,
                         other=((64, 64), (128, 64), (128, 128))) -> dict:
    """kernel_ms, plain_ms, library_ms (SDPA with the same causal and
    window mask, GQA) and bound_ms of the normalised attention at the
    forward's shape of ``cfg`` (B x S, B=2 x S=2048 unless given) with
    the tuner's tiles, the kernel's time at ``other`` tiles of the same
    shape, and (``table_iii``) the f32 (CUDA-core) entry at Table III
    S2 beside its bound, plain version and SDPA."""
    from repro_torch.core import api
    from repro_torch.kernels import attention as A
    d, dt = cfg.dh, torch.bfloat16
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    tk = api.fuse_attention(m, m, d, d, heads=hq, batch=b,
                            dtype=_dtname(dt), causal=True, window=window)
    q, k, v = _randn([(b, hq, m, d), (b, hkv, m, d), (b, hkv, m, d)], dt, 98)
    scale = 1.0 / d ** 0.5
    if window:
        rows = torch.arange(m, device="cuda")[:, None]
        cols = torch.arange(m, device="cuda")[None, :]
        mask = dict(attn_mask=(cols <= rows) & (cols > rows - window))
    else:
        mask = dict(is_causal=True)
    with torch.inference_mode():
        kernel_ms = _adaptive_ms(lambda: tk(q, k, v))
        plain_ms = _adaptive_ms(lambda: A.fused_attention_plain(
            q, k, v, tk.params.bkv, True, window, scale), reps=1)
        library_ms = _adaptive_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale, enable_gqa=True, **mask))
        other_tiles = {f"{bq}/{bkv}": _adaptive_ms(
            lambda bq=bq, bkv=bkv: A.fused_attention(
                q, k, v, bq=bq, bkv=bkv, causal=True, window=window,
                scale=scale))
            for bq, bkv in other}
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               **_bound(_nbytes(q, k, v, q),
                        _attention_ops(b, hq, m, m, d, d, True, window), dt),
               tiles=tk.params.as_kwargs(), other_tiles_ms=other_tiles)
    print(f"attention times [{cfg.name} forward] B={b} Hq={hq} Hkv={hkv} "
          f"M=N={m} D={d} bf16 causal window={window}: " + json.dumps(out))
    if not table_iii:
        return out
    h, m2, n2, k2, _ = ATTN_TABLE_III["S2"]
    f32 = torch.float32
    tk2 = api.fuse_attention(m2, n2, k2, k2, heads=h, dtype="float32")
    q, k, v = _randn([(1, h, m2, k2), (1, h, n2, k2), (1, h, n2, k2)], f32,
                     95)
    scale = 1.0 / k2 ** 0.5
    with torch.inference_mode():
        s2 = dict(kernel_ms=_adaptive_ms(lambda: tk2(q, k, v)),
                  plain_ms=_adaptive_ms(lambda: A.fused_attention_plain(
                      q, k, v, tk2.params.bkv, False, 0, scale)),
                  library_ms=_adaptive_ms(
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, scale=scale)),
                  **_bound(_nbytes(q, k, v, q),
                           _attention_ops(1, h, m2, n2, k2, k2, False), f32),
                  tiles=tk2.params.as_kwargs())
    print(f"attention times [Table III S2] B=1 H={h} M={m2} N={n2} D={k2} "
          f"f32: " + json.dumps(s2))
    out["s2_f32"] = s2
    return out


def _chain_sweep_tiles(kw: dict, dims: tuple, dt) -> list:
    """The tuner's GEMM-chain tiles and a few around them (bn x2 and x4,
    the other class, and four tiles of whole 16-column groups for every
    warp: bm 64 / 128 by bn 64 / 128), each one the wrapper takes."""
    from repro_torch.kernels import gemm_chain as G
    b, m, n, k, h = dims
    meta = [torch.empty(s, dtype=dt, device="meta")
            for s in ((b, m, k), (b, k, n), (b, n, h))]
    other = "flat" if kw["style"] == "deep" else "deep"
    cands = [kw, {**kw, "bn": kw["bn"] * 2}, {**kw, "bn": kw["bn"] * 4},
             {**kw, "style": other}]
    cands += [dict(style="flat", bm=bm, bn=bn, bk=k, bh=h)
              for bm in (64, 128) for bn in (64, 128)]
    out = []
    for t in cands:
        try:
            G.check_gemm_chain(*meta, t["bm"], t["bn"], t["bk"], t["bh"],
                               t["style"])
        except ValueError:
            continue
        if t not in out:
            out.append(t)
    return out


def chain_time_phase(name: str, dt, sweep=False) -> dict:
    """kernel_ms, plain_ms, unfused_ms (two cuBLAS bmm, C rounded to the
    input type between them as the kernel rounds it) and bound_ms of a
    Table II chain with the tuner's tiles and the wrapper's n split, the
    device time of its kernels (the split's and the merge) from a
    profile, and with ``sweep`` the kernel's time, with the wrapper's
    split, at tiles around the pick (``True``) or at each of a list of
    tile dicts (bm, bn, bk, bh, style) the wrapper takes
    (``tools/chain_times.py --sweep`` passes a grid)."""
    from repro_torch.core import api
    from repro_torch.kernels import gemm_chain as G
    b, m, n, k, h = CHAINS[name]
    tk = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype=_dtname(dt))
    a, bb, d = _randn([(b, m, k), (b, k, n), (b, n, h)], dt, 97,
                      scaled=True)
    kw = tk.params.as_kwargs()
    tiles, (splits, _), _ = G.check_gemm_chain(
        a, bb, d, kw["bm"], kw["bn"], kw["bk"], kw["bh"], kw["style"])
    kernel_ms = _adaptive_ms(lambda: tk(a, bb, d))
    plain_ms = _adaptive_ms(lambda: G.fused_gemm_chain_plain(
        a, bb, d, tiles[1], splits), reps=1)
    unfused_ms = _adaptive_ms(lambda: torch.bmm(torch.bmm(a, bb), d))
    # short launches: trace many, as the profiler may keep few of them
    prof = profile_phase(lambda: tk(a, bb, d), f"gemm chain {name}",
                         f"fused_gemm_chain {_dtname(dt)}", timed=3,
                         traced=20)
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
               **_bound(_nbytes(a, bb, d) + b * m * h * a.element_size(),
                        2.0 * b * m * n * (k + h), dt), tiles=kw,
               splits=splits, device_ms_by_kernel={
                   r["name"].replace("void (anonymous namespace)::",
                                     "")[:40]: r["ms_per_launch"]
                   for r in prof["top"]})
    if sweep:
        out["tile_sweep_ms"] = {}
        for t in (_chain_sweep_tiles(kw, CHAINS[name], dt) if sweep is True
                  else sweep):
            sp = G.check_gemm_chain(a, bb, d, t["bm"], t["bn"], t["bk"],
                                    t["bh"], t["style"])[1][0]
            out["tile_sweep_ms"][
                f"{t['style']} {t['bm']}/{t['bn']}/{t['bk']}/{t['bh']} "
                f"x{sp}"] = _adaptive_ms(
                    lambda t=t: G.fused_gemm_chain(a, bb, d, **t), reps=2)
    print(f"gemm chain times [{name}] {(b, m, n, k, h)} {_dtname(dt)}: "
          + json.dumps(out))
    return out


def chain3_time_phase() -> dict:
    """kernel_ms, plain_ms, unfused_ms (three cuBLAS bmm) and bound_ms
    of the three-GEMM chain at CHAIN3 in bf16 with the tuner's tiles
    (one block a (m tile, batch), no split), and its device time from a
    profile."""
    from repro_torch.kernels import gemm_chain3 as G3
    b, m, n, k, h, g = CHAIN3
    dt = torch.bfloat16
    tiles = _chain3_tiles(dt)
    xs = _randn([(b, m, k), (b, k, n), (b, n, h), (b, h, g)], dt, 96,
                scaled=True)
    a, bb, d, f = xs
    kernel_ms = _adaptive_ms(lambda: G3.fused_gemm_chain3(*xs, **tiles))
    plain_ms = _adaptive_ms(lambda: G3.fused_gemm_chain3_plain(
        *xs, tiles["bn"]), reps=1)
    unfused_ms = _adaptive_ms(
        lambda: torch.bmm(torch.bmm(torch.bmm(a, bb), d), f))
    prof = profile_phase(lambda: G3.fused_gemm_chain3(*xs, **tiles),
                         "gemm chain3", "fused_gemm_chain3 bf16", timed=3,
                         traced=20)
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
               **_bound(_nbytes(*xs) + b * m * g * a.element_size(),
                        2.0 * b * m * (n * k + n * h + h * g), dt),
               tiles=tiles, splits=1, device_ms_by_kernel={
                   r["name"].replace("void (anonymous namespace)::",
                                     "")[:40]: r["ms_per_launch"]
                   for r in prof["top"]})
    print(f"gemm chain3 times {CHAIN3} bf16: " + json.dumps(out))
    return out


def quickstart_phase() -> dict:
    """The front door: ``python -m repro_torch.launch.quickstart`` on the
    card, with the counters set to 0 just before and read just after —
    one fused_gemm_chain and one fused_attention launch, each within
    the f32 tolerance of its oracle (atol + rtol x the oracle's largest
    magnitude, as ``torch.testing.assert_close`` bounds an element)."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import gemm_chain as G
    from repro_torch.launch import quickstart
    G.fused_gemm_chain.launches = 0
    A.fused_attention.launches = 0
    errors = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"fused_gemm_chain": G.fused_gemm_chain.launches,
                "fused_attention": A.fused_attention.launches}
    print(f"[quickstart] launches {launches} (want 1 each), (max|err|, "
          f"max|oracle|) {errors}")
    if launches != {"fused_gemm_chain": 1, "fused_attention": 1}:
        raise RuntimeError(f"the quickstart launched {launches}")
    tol = TOL[torch.float32]
    if any(err > tol["atol"] + tol["rtol"] * scale
           for err, scale in errors.values()):
        raise RuntimeError(f"the quickstart's kernels disagree with their "
                           f"oracles: {errors}")
    return launches


# ---------------------------------------------------------------------------
# 4g. training (T1 numerics, T2 training, T3 restart)
# ---------------------------------------------------------------------------

def _train_cfg():
    """qwen3-8b FULL with the depth cut to ``TRAIN["n_layers"]``."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-8b"),
                               n_layers=TRAIN["n_layers"])


def _train_batch(cfg, step: int = 0) -> dict:
    """``launch.train``'s batch ``step`` (TokenPipeline, seed 0) on the
    card."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"],
                                    seed=TRAIN["seed"]))
    return {k: torch.from_numpy(v).to("cuda", torch.long)
            for k, v in pipe.batch_at(step).items()}


def _detach_output(name: str, layer: int):
    """A stand-in for ``layers.<name>`` (``attention_block`` or
    ``rglru_block``) whose call for ``layer`` (one call per layer of
    that kind and forward) returns its output detached from the graph:
    the forward is unchanged and that layer's weights of the block get
    no gradient."""
    from repro_torch.models import layers as L
    block, calls = getattr(L, name), []

    def faulty(*a, **k):
        out = block(*a, **k)
        calls.append(1)
        return out.detach() if len(calls) == layer + 1 else out
    return name, faulty


def _exclusive_scan():
    """A stand-in for ``layers.linear_scan`` off by one position (an
    exclusive scan: h_t takes h_{t-1}'s value), in every RG-LRU layer:
    the forward changes."""
    from repro_torch.models import layers as L
    scan = L.linear_scan

    def faulty(a, b):
        a_sc, h = scan(a, b)
        return a_sc, torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]],
                               dim=1)
    return "linear_scan", faulty


# ``--plant-faults``' training faults, each with the T1 limit it must go
# past: a detached block output leaves its weights without gradient (a
# leaf at relative error 1); the scan fault changes the forward, so the
# loss
TRAIN_FAULTS = {
    "detach_attention": (lambda: _detach_output("attention_block",
                                                TRAIN_FAULT_LAYER), "grad"),
    "detach_rglru": (lambda: _detach_output("rglru_block",
                                            TRAIN_FAULT_LAYER), "grad"),
    "exclusive_scan": (_exclusive_scan, "loss"),
}


def _loss_and_grads(model, params, batch, fault=None) -> tuple:
    """(loss, each leaf's gradient in leaf order, None for a leaf that
    got none) of one ``LM.loss`` backward, with ``fault`` (a (name of a
    ``layers`` function, stand-in) pair) patched in; the ``.grad`` are
    cleared."""
    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.models.lm import requires_grad
    requires_grad(params)
    name, stand_in = fault or ("attention_block", None)
    orig = getattr(L, name)
    if stand_in is not None:
        setattr(L, name, stand_in)
    try:
        loss = model.loss(params, batch)
        loss.backward()
    finally:
        setattr(L, name, orig)
    grads = [p.grad for p in T.leaves(params)]
    for p in T.leaves(params):
        p.grad = None
    return loss.detach(), grads


def _norm(grads) -> float:
    return math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                         for g in grads if g is not None))


def _grad_distance(got, want: torch.Tensor) -> tuple[float, float]:
    """(relative error in the 2-norm, cosine) of one leaf's gradient
    against the f32 step's; a missing gradient is zeros (relative error
    1, cosine 0)."""
    w = want.float()
    g = torch.zeros_like(w) if got is None else got.float()
    wn = float(w.norm())
    rel = float((g - w).norm()) / max(wn, 1e-30)
    cos = float(torch.sum(g * w)) / max(float(g.norm()) * wn, 1e-30)
    return rel, cos


def train_numerics_phase(cfg, faults=("none",), limits=None) -> dict:
    """T1: one step's loss and gradients at ``cfg`` in bf16 against the
    same step with the weights upcast to f32 (TF32 off), seed-0
    weights, ``launch.train``'s first batch.  Each entry of ``faults``
    is run: ``none`` must be within ``limits`` (loss, grad norm, every
    leaf; TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL and TRAIN_GRAD_REL_TOL
    unless given), and each planted fault of TRAIN_FAULTS must go past
    the limit it names there."""
    loss_tol, gnorm_tol, grad_tol = limits or (
        TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL, TRAIN_GRAD_REL_TOL)
    from repro_torch import tree as T
    from repro_torch.models.lm import LM, Runtime
    model = LM(cfg, Runtime(), device="cuda")
    params = model.init_params(TRAIN["seed"])
    batch = _train_batch(cfg)
    keys = [k for k, _ in T.leaves_with_paths(params)]
    t0 = time.perf_counter()
    want_loss, want = _loss_and_grads(
        model, T.map_tree(lambda p: p.detach().float(), params), batch)
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    want_norm = _norm(want)
    results = {}
    for name in faults:
        fault = None if name == "none" else TRAIN_FAULTS[name][0]()
        t0 = time.perf_counter()
        loss, grads = _loss_and_grads(model, params, batch, fault)
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        norm = _norm(grads)
        per_leaf = {k: _grad_distance(g, w)
                    for k, g, w in zip(keys, grads, want)}
        del grads
        worst = sorted(per_leaf, key=lambda k: -per_leaf[k][0])
        loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        gnorm_rel = abs(norm - want_norm) / want_norm
        r = dict(loss=float(loss), f32_loss=float(want_loss),
                 loss_rel=loss_rel, grad_norm=norm, f32_grad_norm=want_norm,
                 gnorm_rel=gnorm_rel, worst_leaf=worst[0],
                 worst_rel=per_leaf[worst[0]][0],
                 worst_cos=min(c for _, c in per_leaf.values()),
                 median_rel=sorted(r_ for r_, _ in per_leaf.values())[
                     len(per_leaf) // 2],
                 leaves=len(per_leaf), bf16_s=bf16_s, f32_s=f32_s)
        r["within"] = (loss_rel <= loss_tol and gnorm_rel <= gnorm_tol
                       and r["worst_rel"] <= grad_tol)
        results[name] = r
        print(f"[train T1, {name}] {cfg.name} {cfg.n_layers} layers B="
              f"{TRAIN['batch']} S={TRAIN['seq']}: bf16 loss "
              f"{r['loss']:.6f} vs f32 {r['f32_loss']:.6f} (rel "
              f"{loss_rel:.3g}, tol {loss_tol}); grad norm "
              f"{norm:.6g} vs {want_norm:.6g} (rel {gnorm_rel:.3g}, tol "
              f"{gnorm_tol}); per leaf ({len(per_leaf)}) rel err "
              f"median {r['median_rel']:.3g}, worst {r['worst_rel']:.3g} at "
              f"{worst[0]} (tol {grad_tol}), lowest cosine "
              f"{r['worst_cos']:.5f}; bf16 step {bf16_s:.2f}s, f32 "
              f"{f32_s:.2f}s (first calls): "
              f"{'within' if r['within'] else 'past the limits'}")
        print(f"[train T1, {name}] worst leaves: "
              + ", ".join(f"{k} {per_leaf[k][0]:.3g}/{per_leaf[k][1]:.4f}"
                          for k in worst[:6]))
    del want, params
    torch.cuda.empty_cache()
    if not results["none"]["within"]:
        raise RuntimeError("a bf16 training step diverges from the f32 one")
    missed = [n for n, r in results.items() if n != "none" and (
        r["worst_rel"] <= grad_tol if TRAIN_FAULTS[n][1] == "grad"
        else r["loss_rel"] <= loss_tol)]
    if missed:
        raise RuntimeError(f"planted training faults within the limit: "
                           f"{missed}")
    return results


def _train_flops(cfg, b: int, s: int) -> tuple[float, str]:
    """Model FLOPs of one training step: 6 x matmul parameters x tokens
    (forward 2, backward 4), plus the attention's two products over the
    causal (row, key) pairs, forward and backward (3 x)."""
    layer = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.dh
             + cfg.n_heads * cfg.dh * cfg.d_model
             + 3 * cfg.d_model * cfg.d_ff)
    n_mm = cfg.n_layers * layer + cfg.d_model * cfg.vocab
    pairs = s * (s + 1) // 2
    attn = 3 * 2 * 2 * b * cfg.n_heads * cfg.dh * pairs * cfg.n_layers
    formula = (f"6 x {n_mm} matmul params (layers x (qkvo + 3 x d x ff) + "
               f"lm_head) x {b * s} tokens + 3 x 2 products x 2 x B={b} x "
               f"Hq={cfg.n_heads} x dh={cfg.dh} x S(S+1)/2={pairs} x "
               f"{cfg.n_layers} layers")
    return 6 * n_mm * b * s + attn, formula


def _kernel_class(name: str) -> str:
    n = name.lower()
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas",
                            "gemv", "splitk")):
        return "gemm"
    if any(s in n for s in ("index", "gather", "scatter", "embedding")):
        return "index"
    if "reduce" in n or "softmax" in n:
        return "reduce"
    if "elementwise" in n or "foreach" in n:
        return "elementwise"
    return "other"


def _profile_groups(fn) -> dict:
    """Device ms of ``fn()`` by kernel class, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            c = _kernel_class(e.key)
            groups[c] = groups.get(c, 0.0) + e.self_device_time_total / 1e3
    return groups


def train_profile_phase(cfg, state) -> dict:
    """Where one training step's time goes, on T2's state and the next
    batch, after one warm-up step: the step cut at the final hidden
    state into five pieces —
    the stack's forward, the loss forward (final norm, lm_head, chunked
    cross-entropy), the loss backward, the stack's backward (fed the
    loss backward's gradient: together the step's backward) and the
    AdamW update — each piece's device span between CUDA events in one
    step, then each piece's device time by kernel class in a
    profiled step; and the streaming attention's forward and backward
    of one layer at the step's shape, by events."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models import layers as L
    from repro_torch.models.lm import Runtime, chunked_ce, requires_grad
    model = S.build_model(cfg, Runtime(), device="cuda")
    opt = TR.make_optimizer(TRAIN["lr"], TRAIN["steps"])
    params, opt_state = state
    batch = _train_batch(cfg, TRAIN["steps"])
    ctx = {}

    def stack_forward():
        requires_grad(params)
        ctx["x"] = model._hidden(params, batch["tokens"])

    def loss_forward():
        ctx["xd"] = ctx["x"].detach().requires_grad_()
        h = L.rmsnorm(ctx["xd"], params["final_norm"]["w"], cfg.norm_eps)
        ctx["loss"] = chunked_ce(h, params["lm_head"], batch["labels"])

    def loss_backward():
        ctx.pop("loss").backward()

    def stack_backward():
        ctx.pop("x").backward(ctx.pop("xd").grad)

    def adamw():
        opt.update(params, [p.grad for p in T.leaves(params)], opt_state)
        for p in T.leaves(params):
            p.grad = None

    pieces = [("stack forward", stack_forward),
              ("loss forward", loss_forward),
              ("loss backward", loss_backward),
              ("stack backward", stack_backward), ("adamw", adamw)]
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    for _, fn in pieces:          # a warm-up step, cut the same way
        fn()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t0 = time.perf_counter()
    ev[0].record()
    for i, (_, fn) in enumerate(pieces):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    span = {n: ev[i].elapsed_time(ev[i + 1])
            for i, (n, _) in enumerate(pieces)}
    retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                            0) - retries
    groups = {n: _profile_groups(fn) for n, fn in pieces}
    # the streaming attention twin of one layer at the step's shape
    b, s, hq, dh = TRAIN["batch"], TRAIN["seq"], cfg.n_heads, cfg.dh
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, go = (torch.randn(b, hq, s, dh, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    attn_ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for rep in range(2):          # the second repetition is timed
        attn_ev[0].record()
        o = L.streaming_attention(q, k, v, causal=True, window=0,
                                  scale=dh ** -0.5, bkv=Runtime().bkv)
        attn_ev[1].record()
        o.backward(go)
        attn_ev[2].record()
        torch.cuda.synchronize()
    attn = {"forward_ms": attn_ev[0].elapsed_time(attn_ev[1]),
            "backward_ms": attn_ev[1].elapsed_time(attn_ev[2])}
    del q, k, v, go, o
    total = sum(span.values())
    print(f"[train profile] one step, cut in five pieces: wall "
          f"{wall_ms:.2f} ms, device span {total:.2f} ms (the warm-up "
          f"step's wall {warm_ms:.2f} ms; {retries} allocator retries "
          f"over both)")
    for n in span:
        print(f"[train profile]   {n:15s} span {span[n]:8.3f} ms; device ms "
              f"by kernel class: "
              + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
                  groups[n].items(), key=lambda kv: -kv[1])))
    print(f"[train profile] streaming attention (twin) of one layer, "
          f"B={b} Hq={hq} S={s} dh={dh}: forward {attn['forward_ms']:.3f} "
          f"ms, backward {attn['backward_ms']:.3f} ms; x {cfg.n_layers} "
          f"layers = {cfg.n_layers * sum(attn.values()):.2f} ms a step")
    return dict(wall_ms=wall_ms, warmup_wall_ms=warm_ms,
                alloc_retries=retries, span_ms=span, groups_ms=groups,
                attention_layer_ms=attn)


def train_phase(cfg) -> dict:
    """T2: ``launch.train.train`` at ``cfg`` for TRAIN["steps"] steps
    with the CLI's defaults, every kernel counter set to 0 just before
    and read just after (no kernel is on the training path, as in the
    JAX package: each must read 0); every loss and grad norm finite,
    the mean of the last 5 losses below the mean of the first 5; the
    step wall (median of steps 2 to the last), tokens/s, peak memory
    and the model-FLOPs share; then ``train_profile_phase`` on the
    trained state."""
    from repro_torch.kernels import capture
    from repro_torch.launch import train as TR
    names = list(capture.counters())
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    _zero(*names)
    t0 = time.perf_counter()
    out = TR.train(cfg, steps=TRAIN["steps"], batch=TRAIN["batch"],
                   seq=TRAIN["seq"], lr=TRAIN["lr"], seed=TRAIN["seed"],
                   device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _read(*names)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # an allocation the caching allocator could not place frees its
    # cache and retries (a device sync): counted, as it inflates a step
    retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                            0) - retries
    losses, norms = out["losses"], out["grad_norms"]
    times = sorted(out["step_times"][2:])
    step_ms = times[len(times) // 2] * 1e3
    tokens = TRAIN["batch"] * TRAIN["seq"]
    flops, formula = _train_flops(cfg, TRAIN["batch"], TRAIN["seq"])
    share = flops / (step_ms / 1e3) / PEAK_OPS[torch.bfloat16]
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[train T2] {TRAIN['steps']} steps in {wall_s:.1f}s (init "
          f"included): losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"[train T2] mean loss of the first 5 steps {first5:.5f}, of "
          f"the last 5 {last5:.5f}; kernel launches {launches} (want 0)")
    print(f"[train T2] step wall {step_ms:.2f} ms (median of steps 2-"
          f"{TRAIN['steps'] - 1}, synchronised; first step "
          f"{out['step_times'][0] * 1e3:.1f} ms); {tokens / step_ms * 1e3:.1f}"
          f" tokens/s; peak memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated; {held_gb:.2f} GB of it held "
          f"before the phase), {retries} allocator retries")
    print(f"[train T2] model FLOPs {flops / 1e12:.3f} TFLOP a step = "
          f"{formula}; {100 * share:.2f}% of 989 TFLOP/s at {step_ms:.2f} ms")
    finite = all(math.isfinite(x) for x in losses + norms)
    if not finite:
        raise RuntimeError("a non-finite training loss or grad norm")
    if not last5 < first5:
        raise RuntimeError(f"the training loss did not fall: {losses}")
    if any(launches.values()):
        raise RuntimeError(f"the training path launched {launches}")
    first_ms = out["step_times"][0] * 1e3
    prof = train_profile_phase(cfg, out["state"])
    del out
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, first5=first5,
                last5=last5, step_ms=step_ms, first_step_ms=first_ms,
                tokens_per_s=tokens / step_ms * 1e3, peak_gb=peak_gb,
                held_before_gb=held_gb, alloc_retries=retries,
                model_tflop=flops / 1e12, flops_share=share,
                flops_formula=formula, launches=launches, profile=prof)


def restart_phase() -> dict:
    """T3: restart on the card at qwen3 SMOKE (RESTART): an uninterrupted
    run of 10 steps, then a StepRunner checkpointing every 4 steps into
    a temporary directory with a StepFailure planted at step 6 —
    ``latest_step`` 10, the replayed steps' batches bitwise equal, every
    loss within RESTART_LOSS_REL_TOL of the uninterrupted run's — then
    a runner that stops at step 8 and a second one that resumes there
    and runs only steps 8 and 9, and a bf16 state saved (async) and
    restored bit for bit.  Deterministic algorithms are on for the
    phase; the directory is removed after."""
    import shutil
    import tempfile
    from repro_torch import tree as T
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import Runtime
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.fault_tolerance import StepFailure, StepRunner
    r = RESTART
    cfg = get_config("qwen3-8b", smoke=True)
    model = S.build_model(cfg, Runtime(), device="cuda")
    opt = AdamW(lr=cosine_schedule(r["lr"], warmup=2, total=r["steps"]))
    train_step = S.make_train_step(model, opt)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=r["seq"],
                                    global_batch=r["batch"], seed=0))

    def batch_at(t: int) -> dict:
        return {k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in pipe.batch_at(t).items()}

    def fresh():
        params = model.init_params(0)
        return params, opt.init(params)

    def step_fn(log: list, fail_at=None):
        armed = [fail_at is not None]

        def fn(state, batch):
            n = int(state[1]["step"])
            if armed[0] and n == fail_at:
                armed[0] = False
                raise StepFailure(f"planted at step {n}")
            params, opt_state, info = train_step(*state, batch)
            log.append((n, float(info["loss"]),
                        batch["tokens"].cpu().numpy().tobytes()))
            return (params, opt_state), {"loss": log[-1][1]}
        return fn

    def worst(log, want) -> float:
        return max(abs(loss - want[n]) / abs(want[n]) for n, loss, _ in log)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.makedirs(os.path.join(ROOT, ".cache"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train-restart-",
                           dir=os.path.join(ROOT, ".cache"))
    try:
        ref_log = []
        state, fn = fresh(), step_fn(ref_log)
        for t in range(r["steps"]):
            state, _ = fn(state, batch_at(t))
        want = {n: loss for n, loss, _ in ref_log}
        # A: the planted failure, restored from the step-4 checkpoint
        a_log = []
        state, _ = StepRunner(step_fn(a_log, r["fail_at"]), batch_at,
                              os.path.join(tmp, "a"),
                              ckpt_every=r["ckpt_every"]).run(
            fresh(), r["steps"])
        latest = ckpt.latest_step(os.path.join(tmp, "a"))
        order = [n for n, _, _ in a_log]
        replays = {n: [b for m, _, b in a_log if m == n]
                   for n in set(order) if order.count(n) > 1}
        # B: a process stops at step 8, the next resumes there
        StepRunner(step_fn([]), batch_at, os.path.join(tmp, "b"),
                   ckpt_every=r["ckpt_every"]).run(fresh(), r["resume_at"])
        b_log = []
        b_state, _ = StepRunner(step_fn(b_log), batch_at,
                                os.path.join(tmp, "b"),
                                ckpt_every=r["ckpt_every"]).run(
            fresh(), r["steps"])
        # C: a bf16 state, saved async, restored bit for bit
        g = torch.Generator(device="cuda").manual_seed(5)
        w = torch.randn(257, 129, generator=g, device="cuda")
        tree = {"w": w.to(torch.bfloat16), "master": w,
                "step": torch.tensor(3, dtype=torch.int32, device="cuda")}
        ckpt.save(os.path.join(tmp, "c"), 1, tree, blocking=False).join()
        got = ckpt.restore(os.path.join(tmp, "c"), 1,
                           T.map_tree(torch.empty_like, tree))
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
                torch.int32: torch.int32}
        bit_exact = all(
            a.dtype == b.dtype and b.is_cuda
            and torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
            for a, b in zip(T.leaves(tree), T.leaves(got)))
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
    res = dict(order=order, latest_step=latest,
               replayed=sorted(replays),
               replay_batches_equal=all(len(set(v)) == 1
                                        for v in replays.values()),
               loss_rel_failure=worst(a_log, want),
               resumed_steps=[n for n, _, _ in b_log],
               loss_rel_resume=worst(b_log, want) if b_log else None,
               final_step=int(state[1]["step"]),
               resumed_final_step=int(b_state[1]["step"]),
               bf16_bit_exact=bit_exact)
    print(f"[train T3] qwen3 SMOKE on the card, failure planted at step "
          f"{r['fail_at']}: steps run {order}; latest checkpoint "
          f"{latest}; replayed {res['replayed']} with equal batches "
          f"{res['replay_batches_equal']}; losses vs the uninterrupted "
          f"run rel {res['loss_rel_failure']:.3g} (tol "
          f"{RESTART_LOSS_REL_TOL}); resumed from {r['resume_at']}: steps "
          f"{res['resumed_steps']}, rel {res['loss_rel_resume']:.3g}; bf16 "
          f"state bit-exact {bit_exact}")
    if not (latest == r["steps"] == res["final_step"]
            == res["resumed_final_step"]
            and res["replayed"] == list(range(r["ckpt_every"], r["fail_at"]))
            and res["replay_batches_equal"]
            and res["resumed_steps"] == list(range(r["resume_at"],
                                                   r["steps"]))
            and max(res["loss_rel_failure"], res["loss_rel_resume"])
            <= RESTART_LOSS_REL_TOL and bit_exact):
        raise RuntimeError(f"the training restart failed: {res}")
    return res


def training_phase(card: str) -> dict:
    """4g: T1 at the depth-cut qwen3-8b, T2 (with the step profile) on
    its weights, T3; the ``{"train": ...}`` line's content."""
    from repro_torch.configs import get_config
    print(f"[train] held on the card before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    cfg = _train_cfg()
    t1 = train_numerics_phase(cfg)
    t2 = train_phase(cfg)
    t3 = restart_phase()
    return dict(card=card, config=dict(
        name=cfg.name, full_layers=get_config("qwen3-8b").n_layers,
        **TRAIN), t1=t1["none"], t2=t2, t3=t3)


# ---------------------------------------------------------------------------
# Phase 4h: the mixture-of-experts family on the served path
# ---------------------------------------------------------------------------

def _tokens(engine) -> list:
    """The greedy tokens of every request ``engine`` finished, in
    submission order."""
    return [r.tokens for r in sorted(engine.finished, key=lambda r: r.rid)]


class _Routes:
    """Within ``with``: every ``models.layers.route`` call's top-k
    expert ids (T, K), one tensor per call in call order, kept in
    ``log``, and every attention block's output (B, S, D) in ``attn``.
    Given ``pinned`` (an earlier ``log``), each call routes to the
    pinned experts instead, weighted by its own router probabilities
    renormalised over them.  Given ``noise``, each attention output is
    scaled by 1 + noise * z, z seeded normal: a perturbation at the
    scale of one bf16 rounding (2^-9), the control of a comparison.
    Capture-safe: nothing leaves the card."""

    def __init__(self, pinned=None, noise: float = 0.0):
        self.log, self.attn, self.pinned, self.noise = [], [], pinned, noise
        self._gen = torch.Generator(device="cuda" if torch.cuda.is_available()
                                    else "cpu").manual_seed(7)

    def __enter__(self):
        from repro_torch.models import layers as L
        self._real = (L.route, L.attention_block, L.paged_attention_block)
        real_route, real_attn, real_paged = self._real

        def route(p, x2d, cfg):
            if self.pinned is None:
                topw, topi = real_route(p, x2d, cfg)
            else:
                topi = self.pinned[len(self.log)]
                probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
                topw = probs.gather(-1, topi)
                topw = topw / topw.sum(dim=-1, keepdim=True)
            self.log.append(topi)
            return topw, topi

        def tap(out):
            if self.noise:
                z = torch.randn(out.shape, generator=self._gen,
                                device=out.device)
                out = (out.float() * (1 + self.noise * z)).to(out.dtype)
            self.attn.append(out)
            return out

        L.route = route
        L.attention_block = lambda *a, **k: tap(real_attn(*a, **k))
        L.paged_attention_block = lambda *a, **k: (
            lambda out: (tap(out[0]), out[1]))(real_paged(*a, **k))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.route, L.attention_block, L.paged_attention_block = self._real


def _served(topi: torch.Tensor, cfg) -> torch.Tensor:
    """(T, K): the experts that serve each token, ascending, -1 where
    its assignment overflows the expert's capacity (assignments fill
    an expert in token order, as ``moe_local``'s do): the capacity
    ``max(8, ceil(K*T*cf/E/8)*8)`` derived here again from the
    config."""
    t, k = topi.shape
    e = cfg.moe.n_experts
    cap = max(8, math.ceil(k * t * cfg.moe.capacity_factor / e / 8) * 8)
    se, order = torch.sort(topi.reshape(-1), stable=True)
    first = torch.searchsorted(se, torch.arange(e, device=topi.device))
    kept = torch.arange(t * k, device=topi.device) - first[se] < cap
    kept = torch.empty_like(kept).scatter_(0, order, kept).reshape(t, k)
    return torch.where(kept, topi, -1).sort(-1).values


def _flips(a: list, b: list, cfg) -> torch.Tensor:
    """(T,): for each token, the layers whose experts serving it differ
    between two ``_Routes`` logs of the same stack: another top-k set,
    or an assignment kept on one side and dropped over capacity on the
    other (a flip of an earlier token moves an expert's load)."""
    if len(a) != len(b):
        raise RuntimeError(f"{len(a)} routings against {len(b)}")
    return torch.stack([(_served(x, cfg) != _served(y, cfg)).any(-1)
                        for x, y in zip(a, b)]).sum(0)


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative error (2-norm) of each row of the last axis."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def _reclaimed_inputs(dt, hq: int, hkv: int, n: int, window: int,
                      seed: int, d: int = 128, ps: int = 16) -> tuple:
    """Decode inputs of 4 requests (lengths n, n - 15, window, n // 2)
    gathered from a seeded page pool through page tables that sliding-
    window reclamation has edited exactly as the serving engine does
    (``RequestPages.reclaim_below(length - window)`` before the step
    that writes position length - 1): the pages wholly below every
    row's window are back in the pool, their entries ``RECLAIMED``, so
    the gather reads the scratch page there and the position mask
    rejects it.  Returns (q, k, v, kv_pos, q_pos) as ``_attn_inputs``."""
    from repro_torch.kernels import attention as A
    from repro_torch.serving import kv_pages as KP
    lengths = [n, n - 15, window, n // 2]
    pool = KP.PagePool(len(lengths) * (n // ps) + 1, ps)
    allocs = []
    for length in lengths:
        a = KP.RequestPages()
        if not a.ensure(length, pool):
            raise RuntimeError("the check's page pool is too small")
        a.reclaim_below(length - window, pool)
        allocs.append(a)
    reclaimed = [a.pages.count(KP.RECLAIMED) for a in allocs]
    if not reclaimed[0] or reclaimed[2]:
        raise RuntimeError(f"reclaimed pages per request {reclaimed}")
    table = torch.from_numpy(KP.table_array(allocs, n // ps)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    k_pages, v_pages = (
        torch.randn(pool.n_pages, hkv, ps, d, generator=g,
                    device="cuda").to(dt) for _ in range(2))
    q = torch.randn(4, hq, 1, d, generator=g, device="cuda").to(dt)
    k, v = (KP.gather_pages(p, table).contiguous()
            for p in (k_pages, v_pages))
    kv_pos = KP.paged_kv_positions(table, ps, invalid=A.INVALID_POS)
    q_pos = torch.tensor(lengths, dtype=torch.int32,
                         device="cuda")[:, None] - 1
    print(f"reclaimed pages per request at window {window}: {reclaimed} "
          f"(lengths {lengths}, page size {ps})")
    return q, k, v, kv_pos, q_pos


def _moe_tiles(olmoe, mixtral, n_ctx: int) -> dict:
    """The tuner's decode tiles (bq, bkv) at olmoe-1b-7b's decode shape
    (N = the serve phases' context) in bf16 and f32, and at
    mixtral-8x7b's (N = MIXTRAL_N) in bf16; B = the serve batch."""
    from repro_torch.core import api
    out = {}
    for key, cfg, n, dt in (("olmoe bf16", olmoe, n_ctx, "bfloat16"),
                            ("olmoe f32", olmoe, n_ctx, "float32"),
                            ("mixtral bf16", mixtral, MIXTRAL_N,
                             "bfloat16")):
        p = api.fuse_attention_paged(
            1, n, cfg.dh, cfg.dh, page_size=SERVE["page_size"],
            heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
            batch=SERVE["batch"], dtype=dt).params
        out[key] = (p.bq, p.bkv)
    print(f"tuner's decode tiles (bq, bkv) at the MoE shapes: {out}")
    return out


def moe_kernel_check_phase(olmoe, mixtral, tiles: dict, n_ctx: int) -> dict:
    """Phase 3 at the MoE family's shapes.  The partial kernel against
    its plain version at olmoe-1b-7b's decode shape (B=4, Hq=Hkv=16: a
    GQA group of 1, N = the serve context) at the tuner's tiles and
    tiles around them, and at mixtral-8x7b's (B=4, Hq=32, Hkv=8,
    N=MIXTRAL_N, window 4096) over page tables whose first entries are
    RECLAIMED; the normalised kernel at olmoe's cache-free forward (B=2,
    Hq=Hkv=16, S=2048, causal) at the tuner's tiles and around them.
    Returns the largest absolute error of each kernel."""
    bf, f32 = torch.bfloat16, torch.float32
    bq, bkv = tiles["olmoe bf16"]
    win = mixtral.window
    partial = [  # (name, dtype, m, n, bq, bkv, window, edit, splits, Hq, Hkv)
        ("olmoe decode bf16", bf, 1, n_ctx, bq, bkv, 0, None, None),
        ("olmoe decode f32", f32, 1, n_ctx, *tiles["olmoe f32"], 0, None,
         None),
        ("olmoe, kv tile x2", bf, 1, n_ctx, bq, 2 * bkv, 0, "ragged", None),
        ("olmoe, 32-key tiles", bf, 1, n_ctx, 1, 32, 0, "ragged", None),
        ("olmoe, one split", bf, 1, n_ctx, bq, bkv, 0, "ragged", 1),
        ("olmoe, uneven split", bf, 1, n_ctx, 1, 32, 0, "ragged", 3),
        ("olmoe window", bf, 1, n_ctx, bq, bkv, 40, "ragged", None),
    ]
    partial = [(*c, olmoe.n_heads, olmoe.n_kv_heads) for c in partial]
    mbq, mbkv = tiles["mixtral bf16"]
    partial += [(*c, mixtral.n_heads, mixtral.n_kv_heads) for c in (
        ("mixtral window, reclaimed pages", bf, 1, MIXTRAL_N, mbq, mbkv,
         win, "reclaimed", None),
        ("mixtral window, reclaimed, 128-key tiles", bf, 1, MIXTRAL_N, 1,
         128, win, "reclaimed", None),
        ("mixtral window, reclaimed, one split", bf, 1, MIXTRAL_N, mbq,
         mbkv, win, "reclaimed", 1),
    )]
    b, s = FORWARD["batch"], FORWARD["seq"]
    h, dh = olmoe.n_heads, olmoe.dh
    attn = [("olmoe forward", b, h, h, s, s, dh, bf, True, 0, None)]
    attn += [(f"olmoe forward, tiles {t}", b, h, h, s, s, dh, bf, True, 0,
              t) for t in ((64, 64), (128, 64), (128, 128))]
    return {"fused_attention_partial": _partial_cases(partial, seed0=200),
            "fused_attention": _attention_cases(attn, seed0=300)}


def _layerwise(label: str, cfg, kern, plain, layers, x, run_layer,
               tol: float) -> dict:
    """Every layer run on the same input, the plain path's own, through
    the kernel path and through the plain path with the kernel path's
    routing pinned: per token, the attention output and the layer output
    must agree within ``tol`` (relative, 2-norm).  The plain path's own
    layer (unpinned) gives x for the next layer, and beside it the flips
    (``_flips``) and, printed only, the unpinned layer output's distance.
    ``run_layer(model, p, x, i)`` runs layer i.  Returns the maxima."""
    attn, out, flips, free = [], [], [], []
    for i, p in enumerate(layers):
        with _Routes() as k:
            got = run_layer(kern, p, x, i)
        with _Routes(pinned=k.log) as q:
            pinned = run_layer(plain, p, x, i)
        with _Routes() as r:
            x = run_layer(plain, p, x, i)
        attn.append(float(_row_rel(k.attn[0], q.attn[0]).max()))
        out.append(float(_row_rel(got, pinned).max()))
        flips.append(int(_flips(k.log, r.log, cfg).sum()))
        free.append(float(_row_rel(got, x).max()))
    res = dict(attn_max=max(attn), out_max=max(out),
               flipped_pairs=sum(flips),
               pairs=len(layers) * got.shape[0] * got.shape[1],
               unpinned_out_max=max(free))
    print(f"[{label}] layer by layer on the same inputs, the kernel path's "
          f"routing pinned on the plain path: attention output rel err max "
          f"{res['attn_max']:.3g}, layer output {res['out_max']:.3g} (tol "
          f"{tol} each, per token); unpinned: {res['flipped_pairs']} of "
          f"{res['pairs']} (token, layer) pairs served by other experts, "
          f"layer output rel err max {res['unpinned_out_max']:.3g} (not "
          f"held)")
    if res["attn_max"] > tol or res["out_max"] > tol:
        raise RuntimeError(f"[{label}] a layer of the kernel path diverges "
                           f"from the plain path")
    return res


def moe_decode_check(cfg, params, engine) -> dict:
    """One full-width decode step of two requests, the kernel path (the
    engine's model and tiles) against the plain hand-wired path.

    Held, layer by layer on the same inputs with the kernel path's
    routing pinned on the plain path (``_layerwise``): each layer's
    attention output and output within E2E_REL_TOL per token.

    Printed, end to end (each path on its own trajectory): the flips,
    each token's relative error, the same with the kernel step's routing
    pinned on the plain path, and the control, the plain step against
    itself with every attention output perturbed at the scale of one
    bf16 rounding (routing pinned): this random model amplifies a
    rounding difference through its 16 layers, so the end-to-end
    distance of two correct paths is no limit's business (``PERF.md``
    §6, PR 20)."""
    from repro_torch.models.lm import LM, Runtime
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    kern = engine.model
    cache, args = _two_request_step(cfg, params, engine)
    tokens, positions, table = args
    pos2 = positions[:, None]
    with torch.inference_mode():
        held = _layerwise(f"{cfg.name} decode step", cfg, kern, plain,
                          params["layers"],
                          kern._embed(params, tokens[:, None], pos2),
                          lambda m, p, x, i: m._apply_layer(
                              p, x, pos2, cache[i], table), E2E_REL_TOL)
        with _Routes() as plain_routes:
            want, cache = plain.decode_step_paged(params, cache, *args)
        with _Routes() as kernel_routes:
            got, cache = kern.decode_step_paged(params, cache, *args)
        with _Routes(pinned=kernel_routes.log):
            pinned, cache = plain.decode_step_paged(params, cache, *args)
        with _Routes(pinned=plain_routes.log, noise=2.0 ** -9):
            control, cache = plain.decode_step_paged(params, cache, *args)
    torch.cuda.synchronize()
    if got.shape != (2, cfg.vocab) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad logits {tuple(got.shape)}")
    out = dict(layerwise=held,
               flips=_flips(kernel_routes.log, plain_routes.log,
                            cfg).tolist(),
               rel=_row_rel(got, want).tolist(),
               rel_pinned=_row_rel(got, pinned).tolist(),
               rel_control=_row_rel(control, want).tolist())
    print(f"[{cfg.name}] end-to-end decode step, kernel attention vs the "
          f"plain hand-wired path at full width: layers with a routing "
          f"flip per token {out['flips']} (of {cfg.n_layers}); rel err per "
          f"token {[f'{r:.3g}' for r in out['rel']]}; with the kernel "
          f"step's routing pinned {[f'{r:.3g}' for r in out['rel_pinned']]};"
          f" control (the plain step, attention perturbed at 2^-9, routing "
          f"pinned) {[f'{r:.3g}' for r in out['rel_control']]}; argmax "
          f"agree {(got.argmax(-1) == want.argmax(-1)).tolist()}")
    return out


def moe_forward_phase(cfg, params) -> dict:
    """The cache-free path of an MoE config at full width: ``LM.loss``
    and ``LM.forward`` of B=2 x S=2048 seeded tokens with
    ``Runtime(kernel_ops=True)``, the attention kernel's counter set to
    0 just before each and read just after (one launch per layer).

    Held, layer by layer on the same inputs with the kernel path's
    routing pinned on the plain path (``_layerwise``): each layer's
    attention output and output within FORWARD_REL_TOL per token; and
    the loss, each path on its own trajectory, within
    MOE_FLIP_LOSS_REL_TOL.  Printed: the logits and
    loss end to end, unpinned, with the kernel run's routing pinned,
    and the control as in ``moe_decode_check``.  Then a profile of one
    forward."""
    from repro_torch.kernels import attention as A
    from repro_torch.models.lm import LM, Runtime
    batch = _forward_batch(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    kern = LM(cfg, Runtime(kernel_ops=True), device="cuda")
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    launches = {}
    with torch.inference_mode():
        A.fused_attention.launches = 0
        loss = kern.loss(params, batch)
        torch.cuda.synchronize()
        launches["loss"] = A.fused_attention.launches
        A.fused_attention.launches = 0
        with _Routes() as kernel_routes:
            logits = kern.forward(params, tokens)
        torch.cuda.synchronize()
        launches["forward"] = A.fused_attention.launches
        print(f"[{cfg.name} forward] B={b} S={s}: loss {float(loss):.5f}; "
              f"fused_attention launches {launches} (want {cfg.n_layers} "
              f"each)")
        if any(n != cfg.n_layers for n in launches.values()):
            raise RuntimeError(f"the forward launched fused_attention "
                               f"{launches} times, not {cfg.n_layers}")
        if logits.shape != (b, s, cfg.vocab) or not (
                torch.isfinite(logits).all() and torch.isfinite(loss)):
            raise RuntimeError("non-finite or misshapen forward output")
        positions = torch.arange(s, dtype=torch.int32, device="cuda")
        held = _layerwise(f"{cfg.name} forward", cfg, kern, plain,
                          params["layers"],
                          kern._embed(params, tokens, positions),
                          lambda m, p, x, i: m._apply_block("attn", p, x,
                                                            positions),
                          FORWARD_REL_TOL)
        want_loss = plain.loss(params, batch)
        with _Routes() as plain_routes:
            want = plain.forward(params, tokens)
        unpinned = _divergence(loss, logits, want_loss, want)
        with _Routes(pinned=kernel_routes.log):
            pinned = _divergence(loss, logits, want_loss,
                                 plain.forward(params, tokens))
        with _Routes(pinned=plain_routes.log, noise=2.0 ** -9):
            control = _divergence(want_loss, plain.forward(params, tokens),
                                  want_loss, want)
        flips = _flips(kernel_routes.log, plain_routes.log, cfg)
        del want
    out = dict(launches=launches, layerwise=held, unpinned=unpinned,
               pinned=pinned, control=control,
               flipped_pairs=int(flips.sum()),
               tokens_with_a_flip=int((flips > 0).sum()), tokens=b * s)
    print(f"[{cfg.name} forward] end to end: {out['flipped_pairs']} (token, "
          f"layer) routing flips of {b * s * cfg.n_layers}, "
          f"{out['tokens_with_a_flip']} of {b * s} tokens with one; loss "
          f"{unpinned['loss']:.5f} vs {unpinned['plain_loss']:.5f} (rel "
          f"{unpinned['loss_rel']:.3g}, tol {MOE_FLIP_LOSS_REL_TOL}); "
          f"logits rel {unpinned['logits_rel']:.3g}, with the kernel run's "
          f"routing "
          f"pinned {pinned['logits_rel']:.3g}, control (the plain forward, "
          f"attention perturbed at 2^-9, routing pinned) "
          f"{control['logits_rel']:.3g}; argmax agree "
          f"{unpinned['argmax_agree']:.4f}")
    if unpinned["loss_rel"] > MOE_FLIP_LOSS_REL_TOL:
        raise RuntimeError(f"the {cfg.name} kernel loss diverges from the "
                           f"plain twin path's")
    with torch.inference_mode():
        out["profile"] = profile_phase(
            lambda: kern.forward(params, tokens), f"{cfg.name} forward",
            f"cache-free forward (B={b}, S={s}, {cfg.n_layers} layers)",
            timed=2, traced=1)
    return out


def golden_probe_check(cfg, params) -> dict:
    """An engine built with the golden probe armed (sentinels at rate
    0, the step eager): the probe's canned decode dispatch at position
    0, where attention returns v itself, through the configured tier
    (the kernel) and the twin must agree, and route every (token,
    layer) to the same experts; nothing degrades."""
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.reliability import sentinels
    model = LM(cfg, Runtime(kernel_ops=True), device="cuda")
    with sentinels.shadowing(0.0, probe=True), _Routes() as r:
        engine = make_engine(model, params, batch=SERVE["batch"],
                             prompt_len=SERVE["prompt_len"],
                             gen=SERVE["gen"], page_size=SERVE["page_size"],
                             verbose=False, eager_decode=True)
    half = len(r.log) // 2
    flips = int(_flips(r.log[:half], r.log[half:], cfg).sum())
    st = engine.stats
    print(f"[{cfg.name}] golden probe: {st['golden_probes']} run, "
          f"{st['golden_mismatches']} mismatches, tier "
          f"{engine.exec_tier}; routing flips between the tiers {flips} "
          f"(of {half} layers x {SERVE['batch']} slots)")
    if (st["golden_probes"], st["golden_mismatches"], engine.exec_tier,
            flips, half) != (1, 0, 0, 0, cfg.n_layers):
        raise RuntimeError(f"the {cfg.name} golden probe disagreed")
    _no_degradation(f"{cfg.name} golden probe")
    return dict(probes=st["golden_probes"], flips=flips)


def _decode_floor(cfg, params) -> dict:
    """The bytes one decode step must read: every expert's weights (the
    dispatch multiplies all E experts over their capacity slots), and
    every weight but the embedding (of which a step reads B rows);
    each over the card's memory rate."""
    from repro_torch import tree as T
    experts = sum(t.numel() * t.element_size()
                  for key, t in T.leaves_with_paths(params["layers"])
                  if key.rsplit("/", 1)[-1] in ("w_up", "w_gate", "w_down"))
    weights = sum(t.numel() * t.element_size()
                  for key, t in T.leaves_with_paths(params)
                  if key != "embed")
    out = dict(expert_gb=experts / 1e9,
               expert_ms=experts / HBM_BYTES_PER_S * 1e3,
               weight_gb=weights / 1e9,
               weight_ms=weights / HBM_BYTES_PER_S * 1e3)
    print(f"[{cfg.name}] decode step byte floor: expert weights "
          f"{out['expert_gb']:.2f} GB = {out['expert_ms']:.3f} ms, every "
          f"weight but the embedding {out['weight_gb']:.2f} GB = "
          f"{out['weight_ms']:.3f} ms at 3.35 TB/s")
    return out


def long_request_phase(cfg, params) -> dict:
    """One request of LONG: a prompt of 4096 tokens and 48 generated,
    served hand-wired with ``Runtime(kernel_ops=True)``, captured, then
    eager, then captured with reclamation off (``_window = 0``, the
    window mask still on).  Its decode positions cross the window: the
    reclaiming runs must give pages back, and all three runs must
    serve the same tokens; the partial kernel's counter (set to 0 just
    before each run, read just after) decode steps x layers; nothing
    degrades."""
    from repro_torch.launch.serve import make_engine
    from repro_torch.models.lm import LM, Runtime
    plen, gen = LONG["prompt_len"], LONG["gen"]
    g = torch.Generator().manual_seed(LONG["seed"])
    prompt = torch.randint(0, cfg.vocab, (plen,), generator=g,
                           dtype=torch.int32).numpy()
    runs = {}
    for mode in ("captured", "eager", "captured, no reclamation"):
        model = LM(cfg, Runtime(kernel_ops=True), device="cuda")
        engine = make_engine(model, params, batch=1, prompt_len=plen,
                             gen=gen, page_size=SERVE["page_size"],
                             verbose=False, eager_decode=mode == "eager")
        if mode.endswith("no reclamation"):
            engine._window = 0
        _zero(*SERVED)
        results, stats = engine.run([(prompt, gen)])
        torch.cuda.synchronize()
        launches = _read(*SERVED)
        steps = stats["decode_steps"]
        want = {"fused_attention_partial": steps * cfg.n_layers,
                "fused_mlp_chain": 0}
        median = sorted(stats["decode_step_wall_s"])[steps // 2]
        print(f"[{cfg.name} long, {mode}] prompt {plen}, {gen} tokens: "
              f"{steps} decode steps in {stats['wall_s']:.2f}s "
              f"(median step {1e3 * median:.3f} ms); window {engine._window}, reclaimed pages "
              f"{stats['reclaimed_pages']}; launches {launches} (want "
              f"{want})")
        if launches != want:
            raise RuntimeError(f"the long request launched {launches}")
        if [len(r.tokens) for r in results] != [gen] or (
                results[0].outcome != "complete"):
            raise RuntimeError("the long request did not complete")
        if (stats["reclaimed_pages"] > 0) == mode.endswith("reclamation"):
            raise RuntimeError(f"reclaimed pages {stats['reclaimed_pages']}"
                               f" in the {mode} run")
        _no_degradation(f"{cfg.name} long, {mode}", stats)
        runs[mode] = dict(tokens=results[0].tokens, steps=steps,
                          reclaimed=stats["reclaimed_pages"],
                          launches=launches["fused_attention_partial"],
                          tok_per_s=stats["tok_per_s"])
    tokens = [r["tokens"] for r in runs.values()]
    print(f"[{cfg.name} long] captured, eager and no-reclamation tokens "
          f"equal: {tokens[0] == tokens[1] == tokens[2]}")
    if not tokens[0] == tokens[1] == tokens[2]:
        raise RuntimeError("the long request's tokens differ between runs")
    return {mode: {k: v for k, v in r.items() if k != "tokens"}
            for mode, r in runs.items()}


def moe_phase() -> dict:
    """Phase 4h: olmoe-1b-7b at every FULL width and depth, then
    mixtral-8x7b at every FULL width with its depth cut to
    MIXTRAL_LAYERS, each after the one before's weights are freed.
    Nothing here is caught: a failure raises."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    olmoe = get_config(OLMOE)
    params = init_phase(olmoe)
    out = {"golden_probe": golden_probe_check(olmoe, params)}
    hand, _, hand_launches, hand_eager, _ = serve_phase(olmoe, params,
                                                        planned=False)
    req, _, req_launches, req_eager, _ = serve_phase(olmoe, params,
                                                     planned=True)
    same = _tokens(req) == _tokens(hand)
    print(f"[{OLMOE}] planner-requested tokens equal the hand-wired run's: "
          f"{same}")
    if not same:
        raise RuntimeError("the planner-requested run's tokens differ")
    out["launches"] = {"hand_wired": hand_launches,
                       "planner_requested": req_launches}
    out["decode_step"] = moe_decode_check(olmoe, params, hand)
    out["floor"] = _decode_floor(olmoe, params)
    out["step_profile"] = step_profile_phase(hand, OLMOE)
    del hand, hand_eager, req, req_eager
    torch.cuda.empty_cache()
    out["forward"] = moe_forward_phase(olmoe, params)
    _no_degradation(f"{OLMOE} forward")
    out["generate"] = generate_phase(olmoe, params)
    _no_degradation(f"{OLMOE} generate")
    del params
    torch.cuda.empty_cache()
    mixtral = dataclasses.replace(get_config(MIXTRAL),
                                  n_layers=MIXTRAL_LAYERS)
    params = init_phase(mixtral, depth=f"depth cut to {MIXTRAL_LAYERS} of "
                                       f"{get_config(MIXTRAL).n_layers} "
                                       f"layers")
    mx, _, mx_launches, mx_eager, _ = serve_phase(mixtral, params,
                                                  planned=False)
    out["launches"]["mixtral"] = mx_launches
    out["mixtral_floor"] = _decode_floor(mixtral, params)
    out["mixtral_step_profile"] = step_profile_phase(mx, MIXTRAL)
    del mx, mx_eager
    torch.cuda.empty_cache()
    out["mixtral_long"] = long_request_phase(mixtral, params)
    out["launches"]["mixtral_long"] = {
        "fused_attention_partial":
            out["mixtral_long"]["captured"]["launches"],
        "fused_mlp_chain": 0}
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[moe] phase seconds: {out['seconds']:.1f}")
    return out


def moe_time_phase(olmoe, mixtral, tiles: dict, n_ctx: int) -> dict:
    """Phase 7 at the MoE shapes: the partial kernel at olmoe-1b-7b's
    group of 1 (N = the serve context) with tiles around the pick, and
    at mixtral-8x7b's windowed decode (N = MIXTRAL_N, window 4096); the
    normalised kernel at olmoe's forward."""
    return {
        "olmoe_decode": time_phase(
            n_ctx, tiles["olmoe bf16"], f"{OLMOE} decode",
            hq=olmoe.n_heads, hkv=olmoe.n_kv_heads,
            other_tiles=((1, 32, None), (1, 32, 1), (1, 80, None),
                         (1, 80, 1))),
        "mixtral_decode": time_phase(
            MIXTRAL_N, tiles["mixtral bf16"], f"{MIXTRAL} windowed decode",
            hq=mixtral.n_heads, hkv=mixtral.n_kv_heads,
            window=mixtral.window),
        "olmoe_forward": attention_time_phase(olmoe, table_iii=False),
    }


# ---------------------------------------------------------------------------
# Phase 4i: the hybrid and vision-prefix decoders
# ---------------------------------------------------------------------------

def archs_kernel_check_phase(rg, pixtral) -> float:
    """Phase 3 at 4i's shapes: the normalised attention kernel against
    its plain version at recurrentgemma-2b's head dim 256 and GQA group
    of 10 (Hq=10, Hkv=1) with its window of 2048 — at its forward's
    shape (B=1, S=4096) and at S=2560 at the tuner's tiles and tiles
    around them, bf16 (the ``<256, 64>`` register bucket) and f32 — and
    at pixtral-12b's forward shape (qwen3-8b's); returns the largest
    absolute error."""
    bf, f32 = torch.bfloat16, torch.float32
    hq, hkv, d = rg.n_heads, rg.n_kv_heads, rg.dh
    win = rg.attn_window
    s, sf = win + 512, RG_FORWARD["s"]
    cases = [(f"{RG} D={d} group {hq // hkv} window {win}", 1, hq, hkv, s,
              s, d, bf, True, win, None)]
    cases += [(f"{RG} shape, tiles {t}", 1, hq, hkv, s, s, d, bf, True, win,
               t) for t in ((64, 64), (128, 64), (128, 32), (16, 16))]
    cases.append((f"{RG} shape f32, window 256", 1, hq, hkv, 512, 512, d,
                  f32, True, 256, None))
    cases.append((f"{PIXTRAL} forward", PIXTRAL_FORWARD["b"],
                  pixtral.n_heads, pixtral.n_kv_heads, PIXTRAL_FORWARD["s"],
                  PIXTRAL_FORWARD["s"], pixtral.dh, bf, True, 0, None))
    cases.append((f"{RG} forward", RG_FORWARD["b"], hq, hkv, sf, sf, d, bf,
                  True, win, None))
    return _attention_cases(cases, seed0=80)


def _wrong_cross_layer(cache) -> None:
    """``--plant-faults``' encoder-decoder fault: every decoder layer's
    cross-attention k/v replaced, in place, by the layer below's (the
    first layer's by the last's)."""
    kv = [{k: c["cross"][k].clone() for k in ("k", "v")} for c in cache]
    for i, c in enumerate(cache):
        for k in ("k", "v"):
            c["cross"][k].copy_(kv[i - 1][k])


def decode_check(cfg, params, fault=None, tol=E2E_REL_TOL,
                 profile=True) -> dict:
    """A batch-4 prefill of seeded prompts (after a vision config's
    prefix embeddings, over an encoder-decoder's frames), then
    teacher-forced ``decode_step`` calls over the contiguous cache
    (DECODE_CHECK), each step's logits against the cache-free forward's
    row at the same position on the plain twin path; the largest
    relative error (per step, 2-norm over the batch) is held to ``tol``.
    Then, with ``profile``, a profile of one decode step at the last
    position (rewriting its kv slot), captured (``CapturedStep``, a
    replay) and eager: host wall, device busy and share, device span.
    ``fault``
    (``_wrong_cross_layer``) is applied to the cache after the prefill;
    then the distance is returned unheld and nothing is profiled."""
    from repro_torch.kernels.capture import CapturedStep
    from repro_torch.launch.serve import demo_side_inputs
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    spec = DECODE_CHECK[cfg.name]
    plen, steps, n_pre = spec["prompt_len"], spec["steps"], \
        cfg.n_prefix_embeds
    b = GENERATE["batch"]
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    tokens = torch.randint(0, cfg.vocab, (b, plen + steps), generator=g,
                           device="cuda")
    side = demo_side_inputs(cfg, b, "cuda", spec["seed"])
    model = build_model(cfg, Runtime(kernel_ops=True), device="cuda")
    plain = build_model(cfg, Runtime(kernel_ops=False), device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(b, n_pre + plen + steps)
        model.prefill(params, tokens[:, :plen], cache, **side)
        if fault is not None:
            fault(cache)
        got = []
        for t in range(plen, plen + steps):
            logits, _ = model.decode_step(
                params, cache, tokens[:, t],
                torch.tensor(n_pre + t, dtype=torch.int32, device="cuda"))
            got.append(logits.float())
        want = plain.forward(params, tokens, **side)[
            :, n_pre + plen:].float()
        got = torch.stack(got, dim=1)
        rel = ((got - want).norm(dim=(0, 2))
               / want.norm(dim=(0, 2))).tolist()
        del got, want
        kv = [c.get("self", c) for c in cache]
        ring = next((c["k"].shape[2] for c in kv if "k" in c), None)
        slots = (f"attention caches of {ring} slots" if ring
                 else "no attention cache")
        print(f"[decode {cfg.name}{', ' + fault.__name__ if fault else ''}"
              f"] B={b} prefill of {n_pre} + {plen} positions, {steps} "
              f"decode steps (positions {n_pre + plen}.."
              f"{n_pre + plen + steps - 1}; {slots}"
              f") vs the cache-free forward: rel err per step max "
              f"{max(rel):.3g}, last {rel[-1]:.3g} (tol {tol}; "
              f"{cfg.dtype})")
        out = dict(rel_max=max(rel), rel_last=rel[-1], ring_slots=ring)
        if fault is not None:
            return out
        if max(rel) > tol or not all(map(math.isfinite, rel)):
            raise RuntimeError(f"{cfg.name}'s decode steps diverge from "
                               f"its forward")
        if not profile:
            return out
        tok = tokens[:, -1].clone()
        pos = torch.tensor(n_pre + plen + steps - 1, dtype=torch.int32,
                           device="cuda")

        def step():
            return model.decode_step(params, cache, tok, pos)[0]
        captured = CapturedStep(step, "cuda")
        what = f"decode step (batch {b}, {cfg.n_layers} layers)"
        prof = {}
        for mode, run in (("captured", captured.replay), ("eager", step)):
            prof[mode] = profile_phase(run, f"{cfg.name}, {mode}", what)
            prof[mode]["span_ms"] = _span_ms(run)
            print(f"profile [{cfg.name}, {mode}]: device span of one step "
                  f"{prof[mode]['span_ms']:.3f} ms (events)")
        del captured
    return dict(out, step_profile=prof)


def arch_train_step(cfg, depth: str, batch: int = ARCH_TRAIN["batch"],
                    seq: int = ARCH_TRAIN["seq"]) -> dict:
    """One step of ``launch.train.train`` at ``cfg`` (B=1 x S=2048
    unless given, the CLI's defaults, a vision config's prefix
    embeddings or an encoder-decoder's frames in its batch), every
    kernel counter set to 0 just before and read just after (each must
    read 0: no kernel is on the training path); the loss and grad norm
    finite; the step's wall (its first call), the bytes of weights and
    optimizer state from their tensors, and the peak memory."""
    from repro_torch import tree as T
    from repro_torch.launch import train as TR
    names = _path_counters()
    torch.cuda.reset_peak_memory_stats()
    _zero(*names)
    out = TR.train(cfg, steps=1, batch=batch, seq=seq, lr=TRAIN["lr"],
                   seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = _read(*names)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = sum(t.numel() * t.element_size()
                   for t in T.leaves(out["state"])) / 1e9
    n = sum(t.numel() for t in T.leaves(out["state"][0]))
    r = dict(loss=out["losses"][0], grad_norm=out["grad_norms"][0],
             step_s=out["step_times"][0], params_b=n / 1e9,
             state_gb=state_gb, peak_gb=peak_gb, launches=launches)
    frames = cfg.encoder.n_frames if cfg.encoder else 0
    print(f"[train {cfg.name}] {cfg.n_layers} layers ({depth}), B="
          f"{batch} x ({cfg.n_prefix_embeds} prefix + {seq} tokens, "
          f"{frames} frames): loss {r['loss']:.5f}, grad norm "
          f"{r['grad_norm']:.4g}, one step {r['step_s']:.2f}s (first "
          f"call); {r['params_b']:.3f} B parameters, weights and AdamW "
          f"state {state_gb:.2f} GB, peak {peak_gb:.2f} GB; kernel "
          f"launches {launches} (want 0)")
    del out
    torch.cuda.empty_cache()
    if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
        raise RuntimeError(f"a non-finite training step at {cfg.name}")
    if any(launches.values()):
        raise RuntimeError(f"the training path launched {launches}")
    return r


def _arch_serve(cfg, forward: dict, spec: dict) -> dict:
    """4i's inference paths at one config, its weights freed after: the
    cache-free forward and loss against the plain twin path, captured and
    eager ``generate`` against the forward, the decode check; nothing
    may degrade; the peak memory."""
    params = init_phase(cfg)
    torch.cuda.reset_peak_memory_stats()
    out = {"forward": forward_phase(cfg, params,
                                    _forward_batch(cfg, **forward))}
    _no_degradation(f"{cfg.name} forward")
    out["generate"] = generate_phase(cfg, params, spec)
    _no_degradation(f"{cfg.name} generate")
    out["decode"] = decode_check(cfg, params)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{cfg.name}] peak memory of the inference paths "
          f"{out['peak_gb']:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return out


def archs_phase() -> dict:
    """Phase 4i: recurrentgemma-2b, then pixtral-12b, each at every FULL
    width and depth through ``_arch_serve``, each model freed before the
    next; then training: T1 at recurrentgemma's full depth within
    RG_T1_LIMITS, one step of it, and one step of pixtral at
    PIXTRAL_TRAIN_LAYERS layers.  Nothing here is caught: a failure
    raises."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    rg, pixtral = get_config(RG), get_config(PIXTRAL)
    out = {RG: _arch_serve(rg, RG_FORWARD, RG_GENERATE),
           PIXTRAL: _arch_serve(pixtral, PIXTRAL_FORWARD, PIXTRAL_GENERATE)}
    out[RG]["t1"] = train_numerics_phase(rg, limits=RG_T1_LIMITS)["none"]
    out[RG]["train"] = arch_train_step(rg, "no depth cut")
    out[PIXTRAL]["train"] = arch_train_step(
        dataclasses.replace(pixtral, n_layers=PIXTRAL_TRAIN_LAYERS),
        f"depth cut to {PIXTRAL_TRAIN_LAYERS} of {pixtral.n_layers}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[archs] phase seconds: {out['seconds']:.1f}")
    return out


def archs_time_phase(rg, pixtral) -> dict:
    """Phase 7 at 4i's shapes: the normalised kernel at recurrentgemma's
    forward (B=1, S=4096, D=256, group 10, window 2048) with tiles
    around the pick, and at pixtral's (qwen3-8b's shape)."""
    return {
        "recurrentgemma_forward": attention_time_phase(
            rg, table_iii=False, b=RG_FORWARD["b"], m=RG_FORWARD["s"],
            window=rg.attn_window,
            other=((64, 64), (128, 64), (128, 32))),
        "pixtral_forward": attention_time_phase(
            pixtral, table_iii=False, b=PIXTRAL_FORWARD["b"],
            m=PIXTRAL_FORWARD["s"]),
    }


# ---------------------------------------------------------------------------
# Phase 4j: the state-space and encoder-decoder families
# ---------------------------------------------------------------------------

def _no_launches(label: str, fn):
    """``fn()`` with every path counter set to 0 just before and read just
    after: each must read 0 (no kernel is on 4j's paths, as in the JAX
    package); nothing may have degraded."""
    names = _path_counters()
    _zero(*names)
    out = fn()
    torch.cuda.synchronize()
    launches = _read(*names)
    if any(launches.values()):
        raise RuntimeError(f"[{label}] launched {launches}")
    _no_degradation(label)
    return out


def _drop_inter():
    """``--plant-faults``' SSD fault: a stand-in for
    ``layers._ssd_inter`` that returns zeros (the inter-chunk term
    dropped)."""
    from repro_torch.models import layers as L
    inter = L._ssd_inter
    return "_ssd_inter", lambda *a: torch.zeros_like(inter(*a))


def ssd_check(cfg, params, faults=("none",)) -> dict:
    """The chunked SSD against its recurrence on real inputs: layer
    SSD_LAYER's (xh, dA, B, C) recorded from a cache-free forward at
    MAMBA_FORWARD (16 chunks of 256), run through ``_ssd_chunked`` and
    through ``ssd_step`` stepped over all 4096 positions; y and the
    final state as relative errors in the 2-norm.  ``none`` must be
    within SSD_REL_TOL, each planted fault (``drop_inter``) past it."""
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM, Runtime
    model = LM(cfg, Runtime(), device="cuda")
    tokens = _forward_batch(cfg, **MAMBA_FORWARD)["tokens"]
    chunked, seen = L._ssd_chunked, []

    def record(*a):
        seen.append(a if len(seen) == SSD_LAYER else None)
        return chunked(*a)
    L._ssd_chunked = record
    try:
        with torch.inference_mode():
            model.forward(params, tokens)
    finally:
        L._ssd_chunked = chunked
    xh, da, bm, cm, chunk = seen[SSD_LAYER]
    del seen
    b, s, nh, pd = xh.shape
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        h = xh.new_zeros(b, nh, bm.shape[-1], pd)
        ys = torch.empty_like(xh)
        for t in range(s):
            ys[:, t], h = L.ssd_step(h, xh[:, t], da[:, t], bm[:, t],
                                     cm[:, t])
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        for name in faults:
            stand_in = None if name == "none" else _drop_inter()
            if stand_in is not None:
                inter = L._ssd_inter
                L._ssd_inter = stand_in[1]
            try:
                y, h_last = L._ssd_chunked(xh, da, bm, cm, chunk)
            finally:
                if stand_in is not None:
                    L._ssd_inter = inter
            r = dict(y_rel=float((y - ys).norm() / ys.norm()),
                     state_rel=float((h_last - h).norm() / h.norm()))
            r["within"] = max(r.values()) <= SSD_REL_TOL
            out[name] = r
            print(f"[ssd {cfg.name}, {name}] layer {SSD_LAYER}'s inputs "
                  f"of a B={b} x S={s} forward ({s // chunk} chunks of "
                  f"{chunk}, H={nh}, N={bm.shape[-1]}, P={pd}; dA mean "
                  f"{float(da.mean()):.3f}): chunked vs the recurrence "
                  f"stepped {s} times ({seq_s:.2f}s): y rel "
                  f"{r['y_rel']:.3g}, final state rel "
                  f"{r['state_rel']:.3g} (tol {SSD_REL_TOL}): "
                  f"{'within' if r['within'] else 'past the limit'}")
    if not out["none"]["within"]:
        raise RuntimeError("the chunked SSD diverges from its recurrence")
    missed = [n for n, r in out.items() if n != "none" and r["within"]]
    if missed:
        raise RuntimeError(f"planted SSD faults within the limit: {missed}")
    return out


def encoder_attention_check(cfg) -> dict:
    """The encoder's streaming twin at whisper's 1500 frames (B=4, its
    heads, bf16, not causal): the kv block of 512 shrinks to 500, three
    blocks; held against ``naive_attention`` on the card within the
    bf16 tolerance (the twin keeps P in f32, the naive one rounds it to
    bf16)."""
    from repro_torch.models import layers as L
    n, bkv = cfg.encoder.n_frames, 512
    while n % bkv:
        bkv -= 1
    q, k, v, _, _ = _attn_inputs(torch.bfloat16, GENERATE["batch"],
                                 cfg.n_heads, cfg.n_heads, n, n, cfg.dh,
                                 seed=90)
    scale = 1.0 / math.sqrt(cfg.dh)
    with torch.inference_mode():
        got = L.streaming_attention(q, k, v, causal=False, window=0,
                                    scale=scale, bkv=512)
        want = L.naive_attention(q, k, v, causal=False, window=0,
                                 scale=scale)
    err = float((got.float() - want.float()).abs().max())
    print(f"[attention {cfg.name}] encoder twin, {n} frames (kv block "
          f"512 -> {bkv}, {n // bkv} blocks), B={q.shape[0]} H={q.shape[1]}"
          f" D={cfg.dh} bf16, not causal, vs naive_attention: max |err| "
          f"{err:.3g}")
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    return dict(max_abs_err=err, bkv=bkv)


def cache_free_phase(cfg, params, batch) -> dict:
    """4j's cache-free loss and forward of ``batch`` (with an
    encoder-decoder's frames), each under ``_no_launches``: the loss
    finite, the logits finite and (B, S, V); each call's wall (its first
    call) and the peak memory of the two, then a profile of one forward
    (wall, device busy and share)."""
    from repro_torch.launch.steps import build_model
    from repro_torch.models.lm import Runtime
    model = build_model(cfg, Runtime(kernel_ops=True), device="cuda")
    tokens = batch["tokens"]
    side = {k: batch[k] for k in ("frames",) if k in batch}
    b, s = tokens.shape
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        loss = _no_launches(f"{cfg.name} loss",
                            lambda: model.loss(params, batch))
        loss_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits = _no_launches(f"{cfg.name} forward",
                              lambda: model.forward(params, tokens, **side))
        fwd_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ok = (logits.shape == (b, s, cfg.vocab)
              and bool(torch.isfinite(logits).all())
              and math.isfinite(float(loss)))
        print(f"[forward {cfg.name}] B={b} S={s} "
              f"{ {k: tuple(t.shape) for k, t in side.items()} }: loss "
              f"{float(loss):.5f} in {loss_s:.3f}s, forward "
              f"{tuple(logits.shape)} in {fwd_s:.3f}s (first calls); peak "
              f"{peak_gb:.2f} GB")
        if not ok:
            raise RuntimeError("non-finite or misshapen forward output")
        del logits
        prof = profile_phase(lambda: model.forward(params, tokens, **side),
                             f"forward {cfg.name}", f"cache-free forward "
                             f"(B={b}, S={s}, {cfg.n_layers} layers)",
                             timed=2, traced=1)
    return dict(loss=float(loss), loss_s=loss_s, forward_s=fwd_s,
                peak_gb=peak_gb, profile=prof)


def plant_ssm_encdec_faults() -> None:
    """``--plant-faults``' 4j faults, each of which must go past its
    check's limit: mamba's inter-chunk term dropped in the SSD check,
    and whisper's cross-attention fed the layer below's k/v in the
    decode check (its sound reading printed first)."""
    from repro_torch.configs import get_config
    mamba, whisper = get_config(MAMBA), get_config(WHISPER)
    params = init_phase(mamba)
    ssd_check(mamba, params, faults=("none", "drop_inter"))
    del params
    torch.cuda.empty_cache()
    params = init_phase(whisper)
    sound = decode_check(whisper, params)
    faulty = decode_check(whisper, params, fault=_wrong_cross_layer)
    print(f"[decode {WHISPER}] sound rel {sound['rel_max']:.3g}, wrong "
          f"cross layer rel {faulty['rel_max']:.3g} (tol {E2E_REL_TOL})")
    if faulty["rel_max"] <= E2E_REL_TOL:
        raise RuntimeError("the planted cross-attention fault is within "
                           "the decode check's limit")
    del params
    torch.cuda.empty_cache()


def ssm_encdec_phase() -> dict:
    """Phase 4j: mamba2-1.3b, then whisper-small, each at every FULL
    width and depth, its weights freed before the next: mamba's SSD
    check, cache-free loss and forward, teacher-forced decode in bf16
    (MAMBA_DECODE_REL_TOL) and with the weights upcast to f32
    (MAMBA_F32_REL_TOL), captured and eager ``generate`` (its distance
    to the forward printed), T1 within MAMBA_T1_LIMITS and one
    ``launch.train`` step; whisper's encoder attention twin, loss and
    forward, teacher-forced decode, ``generate`` and one training step.
    Every path under ``_no_launches`` or its own zero-launch check.
    Nothing here is caught: a failure raises."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    mamba, whisper = get_config(MAMBA), get_config(WHISPER)
    out = {MAMBA: {}, WHISPER: {}}
    m = out[MAMBA]
    params = init_phase(mamba)
    m["ssd"] = ssd_check(mamba, params)["none"]
    m["forward"] = cache_free_phase(mamba, params,
                                    _forward_batch(mamba, **MAMBA_FORWARD))
    m["decode"] = _no_launches(f"{MAMBA} decode", lambda: decode_check(
        mamba, params, tol=MAMBA_DECODE_REL_TOL))
    m["generate"] = generate_phase(mamba, params, MAMBA_GENERATE, tol=None)
    _no_degradation(f"{MAMBA} generate")
    params = T.map_tree(lambda t: t.float(), params)
    m["decode_f32"] = _no_launches(f"{MAMBA} decode, f32", lambda: (
        decode_check(dataclasses.replace(mamba, dtype="float32"), params,
                     tol=MAMBA_F32_REL_TOL, profile=False)))
    del params
    torch.cuda.empty_cache()
    m["t1"] = train_numerics_phase(mamba, limits=MAMBA_T1_LIMITS)["none"]
    m["train"] = arch_train_step(mamba, "no depth cut")
    w = out[WHISPER]
    w["encoder_attention"] = encoder_attention_check(whisper)
    params = init_phase(whisper)
    w["forward"] = cache_free_phase(
        whisper, params, _forward_batch(whisper, **WHISPER_FORWARD))
    w["decode"] = _no_launches(f"{WHISPER} decode",
                               lambda: decode_check(whisper, params))
    w["generate"] = generate_phase(whisper, params, WHISPER_GENERATE)
    _no_degradation(f"{WHISPER} generate")
    del params
    torch.cuda.empty_cache()
    w["train"] = arch_train_step(whisper, "no depth cut", **WHISPER_TRAIN)
    out["seconds"] = time.perf_counter() - t0
    print(f"[ssm_encdec] phase seconds: {out['seconds']:.1f}")
    return out


# ---------------------------------------------------------------------------
# Phase 4k: the distributed serving regimes
# ---------------------------------------------------------------------------

# A world of DIST["world"] ranks, one process each, gloo, every rank on the
# one card (NCCL refuses two ranks on one device), over a 1 x 4 ("data",
# "model") mesh.  Ranks sharing a card contend, so no kernel is timed
# inside the world: its walls are walls through gloo on one card, and
# the local-shape kernel times come from the parent, alone on the card.
# (a)'s attention held as a relative norm error: PERF.md §2's bf16
# limit, against outputs of order 1 (``_dist_attn_inputs``).  A ring
# that drops one rank's partial, or sums the partials without rescaling
# them to the global max, goes far past it: both are planted in (a).
DIST_ATTN_REL_TOL = 2e-2
DIST = dict(
    world=4,
    # (a) kernel level: the gemm chain of tests/test_dist_exec.py in f32
    # and bf16 and Table II G12 in bf16 ((B, M, N, K, H)); qwen3-8b's
    # forward attention and one query row over 4096 keys ((B, Hq, Hkv,
    # M, N), D = 128, causal, bf16)
    gemm={"test f32": ((4, 256, 256, 128, 512), torch.float32),
          "test bf16": ((4, 256, 256, 128, 512), torch.bfloat16),
          "G12 bf16": (CHAINS["G12"], torch.bfloat16)},
    attn={"forward": (2, 32, 8, 2048, 2048), "decode 4096": (2, 32, 8, 1,
                                                             4096)},
    head_dim=128,
    # (b) the cache-free forward of qwen3-8b FULL, (c) generate, (d) the
    # engine on 8 ragged requests of up to 96 + 32 positions: 8 pages of
    # 16, which the model dim of 4 divides, so the paged ring regimes
    # are offered
    forward=FORWARD, generate=GENERATE,
    serve=dict(SERVE, prompt_len=96),
    archs=("qwen3-8b", GRANITE),
    # granite-20b's depth cut to 4 of 52 layers (full widths) and
    # qwen3-8b's to 4 of 36, to keep the full run inside its time limit:
    # granite's two `generate` calls through gloo's host-staged
    # send/recv took ~60 s each at 52 layers and 14.9-25.8 s at 9,
    # qwen3's two engine runs 138 s at 36 layers and 59.2 s at 8 on a
    # loaded host, where the full run took 1504.6 s at these depths
    layers={"qwen3-8b": 4, GRANITE: 4})


def _dist_cfg(arch, dist, dev="cuda"):
    """Phase 4k's config of ``arch``: FULL on the card (SMOKE on the
    CPU), at ``dist["layers"]``' depth where it names the model."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=dev != "cuda")
    n = dist.get("layers", {}).get(arch)
    return cfg if n is None else dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, n))


def _seeded(shapes, dt, seed, dev, scaled=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*s, generator=g, device=dev)
             / (s[1] ** 0.5 if i and scaled else 1.0)).to(dt)
            for i, s in enumerate(shapes)]


def _dist_gemm_inputs(spec, dev):
    (b, m, n, k, h), dt = spec
    return _seeded([(b, m, k), (b, k, n), (b, n, h)], dt, 301, dev)


def _dist_attn_inputs(spec, d, dev):
    """(a)'s q, k, v: unit-variance k and v and q at 4x, so the scores'
    spread is 4 and each row's softmax is peaked, with outputs of order
    1 against which a wrong combine shows (``DIST_ATTN_REL_TOL``)."""
    b, hq, hkv, m, n = spec
    q, k, v = _seeded([(b, hq, m, d), (b, hkv, n, d), (b, hkv, n, d)],
                      torch.float32, 302, dev, scaled=False)
    dt = torch.bfloat16 if dev == "cuda" else torch.float32
    return (q * 4.0).to(dt), k.to(dt), v.to(dt)


def _dist_batch(cfg, spec, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    tokens = torch.randint(0, cfg.vocab, (spec["batch"], spec["seq"]),
                           generator=g, device=dev)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels}


def _dist_prompts(cfg, spec, dev):
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    return torch.randint(0, cfg.vocab, (spec["batch"], spec["prompt_len"]),
                         generator=g, device=dev)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


@contextlib.contextmanager
def _planted_combine(fault: str):
    """A fault planted in the ring's combine for the duration
    (``ring_attention`` calls ``ring_dispatch.ring_combine``): rank 1's
    partial replaced by the merge's identity, or every rank's max set
    to 0 so the partials are summed without their rescale to the
    global max."""
    from repro_torch.dist import ring_dispatch
    real = ring_dispatch.ring_combine

    def combine(o, m, l, ax, *args):
        if fault == "no rescale":
            m = torch.zeros_like(m)
        elif ax.index == 1:
            o, l = torch.zeros_like(o), torch.zeros_like(l)
            m = torch.full_like(m, -1e30)
        return real(o, m, l, ax, *args)

    ring_dispatch.ring_combine = combine
    try:
        yield
    finally:
        ring_dispatch.ring_combine = real


def _forced_generate(model, params, prompts, tokens) -> torch.Tensor:
    """The last decode step's logits of ``generate`` with its inputs
    forced to ``tokens`` (B, gen), another run's greedy tokens: the
    prompts prefilled, then ``tokens[:, j]`` decoded at position P + j
    for j < gen - 1."""
    b, plen = prompts.shape
    gen = tokens.shape[1]
    cache = model.init_cache(b, plen + gen)
    logits, cache = model.prefill(params, prompts, cache)
    for j in range(gen - 1):
        pos = torch.tensor(plen + j, dtype=torch.int32, device=prompts.device)
        logits, cache = model.decode_step(params, cache, tokens[:, j], pos)
    return logits


def _free(dev) -> None:
    """Collect the cycles an engine forms (each holds its model's
    weights) and return the freed blocks to the card."""
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The worlds' rank processes, kept across phases
# ---------------------------------------------------------------------------
# Each world of phases 4k-4p used to start its ranks anew: ~8 s a world on
# an H100 host (6 s of it importing torch), for fifteen worlds.  In the
# full run a pool of rank processes, started once, runs every world in
# turn instead (``_spawn``); between two worlds each process leaves its
# process group, frees its memory, resets its peak and seeds torch's
# generators as a fresh process has them, and drops every memo of the
# port (``_fresh_process``), so that a world starts as a spawned one does.
_POOL = None
_TORCH_DEFAULT_SEED = 67280421310721      # a fresh process's initial_seed()


def _pool_worker(tasks, out, parent: int) -> None:
    import pickle
    import queue
    import traceback
    import torch.distributed as dist
    from repro_torch.dist import collectives
    from repro_torch.kernels import capture, ops
    from repro_torch.launch.mesh import init_rank
    from repro_torch.reliability import faults
    while True:
        try:
            task = tasks.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent:      # the parent is gone
                return
            continue
        if task is None:
            return
        tag, rank, world, tmp, device, env = task
        os.environ.clear()
        os.environ.update(env)
        try:
            _fresh_process()
            _zero(*capture.counters())
            # a process's own records: the collectives' payloads and the
            # tiles the world agreed on (``ops._agree`` agrees once a
            # process, so a rank that kept them would skip a collective
            # the others run)
            collectives.TRAFFIC.clear()
            collectives.HOST_HOPS.clear()
            ops._AGREED.clear()
            faults.clear()
            torch.manual_seed(_TORCH_DEFAULT_SEED)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with open(os.path.join(tmp, "call.pkl"), "rb") as f:
                fn, args = pickle.load(f)
            init_rank(rank, world, os.path.join(tmp, "store"),
                      device=device)
            result = fn(rank, *args)
            out.put((tag, rank, True, result))
        except BaseException:  # noqa: BLE001 - reported to the parent
            out.put((tag, rank, False, traceback.format_exc()))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            fn = args = result = None
            _free(device)


class _WorldPool:
    """``size`` spawned rank processes that run one world after another:
    ``run`` is ``repro_torch.launch.mesh.spawn`` on the first ``world``
    of them."""

    def __init__(self, size: int):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.out = ctx.Queue()
        self.procs = [ctx.Process(target=_pool_worker,
                                  args=(self.tasks[i], self.out,
                                        os.getpid()))
                      for i in range(size)]
        for p in self.procs:
            p.start()
        self.n_worlds = 0

    def run(self, fn, world: int, *args, device: str = "cpu",
            timeout_s: float = 900.0) -> list:
        import pickle
        import queue
        if world > len(self.procs):
            raise RuntimeError(f"a world of {world} in a pool of "
                               f"{len(self.procs)}")
        self.n_worlds += 1
        tag = self.n_worlds
        tmp = tempfile.mkdtemp(prefix="world-")
        try:
            with open(os.path.join(tmp, "call.pkl"), "wb") as f:
                pickle.dump((fn, args), f)
            env = dict(os.environ)
            for r in range(world):
                self.tasks[r].put((tag, r, world, tmp, device, env))
            results, error = {}, None
            deadline = time.monotonic() + timeout_s
            while len(results) < world and error is None:
                try:
                    got, rank, ok, res = self.out.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(self.procs[:world])
                            if not p.is_alive()]
                    if dead:
                        error = (f"rank {dead[0]} died with exit code "
                                 f"{self.procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        error = f"the world outlived {timeout_s} s"
                    continue
                if got != tag:
                    continue
                if ok:
                    results[rank] = res
                else:
                    error = f"rank {rank} failed:\n{res}"
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if error is not None:
            self.close()
            raise RuntimeError(error)
        return [results[r] for r in range(world)]

    def close(self) -> None:
        global _POOL
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join()
        if _POOL is self:
            _POOL = None


@contextlib.contextmanager
def _world_pool(size: int = 4):
    """The pool that ``_spawn`` runs every world on while it is open."""
    global _POOL
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    _POOL = _WorldPool(size)
    pool = _POOL
    try:
        yield pool
    finally:
        pool.close()


def _spawn(fn, world: int, *args, device: str = "cpu",
           timeout_s: float = 900.0) -> list:
    """``repro_torch.launch.mesh.spawn``, on the open pool's processes
    when there is one."""
    if _POOL is not None:
        return _POOL.run(fn, world, *args, device=device,
                         timeout_s=timeout_s)
    from repro_torch.launch.mesh import spawn
    return spawn(fn, world, *args, device=device, timeout_s=timeout_s)


def dist_refs(cfg, params, refdir, first: bool, dist=DIST,
              dev="cuda") -> dict:
    """The single-card results phase 4k holds the world to, for one
    model (``params`` on the card): for the ``first`` (qwen3-8b) also
    the kernel-level
    outputs of each ``ops`` call at (a)'s shapes, the kernel path's loss
    and logits (b), and the engine's tokens and one decode step's
    logits on the same pages (d); for every model ``generate``'s tokens
    and last logits (c).  Saved under ``refdir``; returns their
    summary."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, run_continuous
    from repro_torch.models.lm import LM, Runtime
    t0 = time.perf_counter()
    refs = {}
    model = LM(cfg, Runtime(kernel_ops=True), device=dev)
    with torch.inference_mode():
        if first:
            for label, spec in dist["gemm"].items():
                refs[f"gemm {label}"] = ops.gemm_chain(
                    *_dist_gemm_inputs(spec, dev)).cpu()
            for label, spec in dist["attn"].items():
                refs[f"attn {label}"] = ops.attention(
                    *_dist_attn_inputs(spec, dist["head_dim"], dev),
                    causal=True).cpu()
            batch = _dist_batch(cfg, dist["forward"], dev)
            refs["loss"] = float(model.loss(params, batch))
            refs["logits"] = model.forward(params, batch["tokens"]).cpu()
            results, _, engine = run_continuous(
                cfg, model, params, **dist["serve"], verbose=False)
            refs["engine tokens"] = [r.tokens for r in results]
            cache, args = _two_request_step(cfg, params, engine,
                                            dist["serve"])
            refs["engine step"] = engine.model.decode_step_paged(
                params, cache, *args)[0].cpu()
            del engine, cache
        prompts = _dist_prompts(cfg, dist["generate"], dev)
        tokens, logits = generate(model, params, prompts,
                                  dist["generate"]["gen"])
        refs["generate tokens"] = torch.from_numpy(tokens)
        refs["generate logits"] = logits.cpu()
    torch.save(refs, os.path.join(refdir, f"{cfg.name}.pt"))
    _free(dev)
    print(f"[4k refs {cfg.name}] single-card results saved in "
          f"{time.perf_counter() - t0:.1f}s: {sorted(refs)}")
    return {k: v for k, v in refs.items() if isinstance(v, float)}


class _DistRank:
    """One rank of phase 4k (module doc, 4k): its mesh and rules, and a
    record of every step — the kernel counters set to 0 just before it
    and read just after, its wall and the device memory held after —
    and of every held check; rank 0 prints."""

    def __init__(self, rank, dist, dev):
        from repro_torch.dist.sharding import Rules
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.serve import sharded_runtime
        self.dist, self.dev, self.say = dist, dev, rank == 0
        self.mesh = make_host_mesh(dist["world"])
        self.rules = Rules(data=("data",), model="model", tp="model",
                           fsdp=False)
        self.rt = sharded_runtime(dist["world"], self.mesh)[2]
        self.names = _path_counters()
        self.out = {"launches": {}, "walls": {}, "checks": {}, "tiers": {},
                    "agree": {}, "regimes": {}, "memory_gb": {}}

    def step(self, label, fn):
        out = self.out
        _zero(*self.names)
        t0 = time.perf_counter()
        with torch.inference_mode():
            r = fn()
        if self.dev == "cuda":
            torch.cuda.synchronize()
        out["walls"][label] = time.perf_counter() - t0
        out["launches"][label] = {k: v for k, v in _read(*self.names).items()
                                  if v}
        out["memory_gb"][label] = (torch.cuda.memory_allocated() / 1e9
                                   if self.dev == "cuda" else 0.0)
        if self.say:
            print(f"[4k wall] {label}: {out['walls'][label]:.2f}s, "
                  f"{out['memory_gb'][label]:.2f} GB held after; "
                  f"{out['launches'][label]}", flush=True)
        return r

    def held(self, label, value, tol):
        self.out["checks"][label] = value
        if self.say:
            print(f"[4k {label}] {value:.4g} (tol {tol})")
        if value > tol:
            raise RuntimeError(f"[4k {label}] {value} > {tol}")

    def kernels(self, refs) -> None:
        """(a) each regime forced by calling its function — the spatial
        body on the rank's heads, ``ring_attention`` serial and
        pipelined — against the single-card kernel; then the serial
        ring with a fault planted in its combine, which must fail the
        check."""
        from repro_torch.kernels import ops
        dist, dev, mesh, rules = self.dist, self.dev, self.mesh, self.rules
        for label, spec in dist["gemm"].items():
            a, b, d = _dist_gemm_inputs(spec, dev)
            got = self.step(f"gemm {label}", lambda: ops.gemm_chain(
                a, b, d, mesh=mesh, rules=rules))
            self._close(f"gemm {label}", got, refs[f"gemm {label}"])
        for label, (b, hq, hkv, m, n) in dist["attn"].items():
            q, k, v = _dist_attn_inputs((b, hq, hkv, m, n),
                                        dist["head_dim"], dev)
            want = refs[f"attn {label}"]
            choice, plan = ops.attention_regime_choice(
                rules, mesh, batch=b, q_heads=hq, kv_heads=hkv, q_len=m,
                kv_len=n, head_dim=dist["head_dim"], dtype=_dtname(q.dtype),
                causal=True)
            self.out["regimes"][f"attn {label}"] = choice.regime
            if self.say:
                print(f"[4k attn {label}] the tuner picks {choice.regime}: "
                      + " ".join(f"{r}={t * 1e6:.2f}us"
                                 for r, t in choice.times.items())
                      + " (modelled, H100 at 450 GB/s a link); the "
                      f"single-card output's rms {_rms(want):.4g}")
            regimes = ["spatial", "ring"]
            if ops._pipelined_rows_ok(plan, b, hq, m):
                regimes.append("ring-pipelined")
            for regime in regimes:
                got = self.step(f"attn {label} {regime}",
                                lambda: self._forced(q, k, v, plan, regime))
                self._close(f"attn {label} {regime}", got, want)
            for fault in ("one rank's partial dropped", "no rescale"):
                with _planted_combine(fault), torch.inference_mode():
                    got = self._forced(q, k, v, plan, "ring")
                err = _rel(got, want.to(got.device))
                self.out["checks"][f"attn {label} planted {fault}"] = err
                if self.say:
                    print(f"[4k attn {label} planted: {fault}] rel {err:.4g}"
                          f" (must exceed {DIST_ATTN_REL_TOL})")
                if not err > DIST_ATTN_REL_TOL:
                    raise RuntimeError(f"[4k attn {label}] the planted "
                                       f"fault {fault!r} passed: {err}")

    def _forced(self, q, k, v, plan, regime):
        """Mesh attention on the whole q/k/v in ``regime``, by calling its
        function: ``ops._attn_body`` on this rank's heads (the spatial
        placement of the 1 x n mesh) gathered after, or ``ring_attention``
        on every head at the tiles the tuner gives its partial kernel."""
        from repro_torch.core import api
        from repro_torch.core.perf_model import H100
        from repro_torch.dist.collectives import axis
        from repro_torch.dist.ring_dispatch import ring_attention, ring_group
        from repro_torch.dist.sharding import dispatch_mesh_spec
        from repro_torch.kernels import ops
        b, hq, m, d = q.shape
        hkv, n = k.shape[1], k.shape[2]
        if regime == "spatial":
            spec, baxes, hax = dispatch_mesh_spec(
                self.rules, self.mesh, kind="attention", batch=b,
                feature_dims=(hkv, hq), ici_bw=H100.ici_bw)
            hx = axis(self.mesh, hax)
            if baxes or hx is None:
                raise RuntimeError(f"[4k] a spatial placement {baxes, hax} "
                                   f"this check does not shard")
            o = ops._attn_body(*(hx.shard(t, 1) for t in (q, k, v)),
                               spec=spec, batch=b, heads=hq, causal=True,
                               window=0, scale=None)
            return hx.all_gather(o, 1)
        p = api.fuse_attention(m, n, d, d, heads=hq, batch=b,
                               dtype=_dtname(q.dtype), causal=True,
                               mesh=plan.spec,
                               group=ring_group(hq, hkv, m)).params
        return ring_attention(q, k, v, mesh=self.mesh, axis_name=plan.axis,
                              causal=True, bq=p.bq, bkv=p.bkv,
                              pipelined=regime == "ring-pipelined")

    def _close(self, label, got, want) -> None:
        want = want.to(got.device)
        tol = TOL[got.dtype]
        torch.testing.assert_close(got, want, **tol)
        if label.startswith("attn"):
            self.held(f"{label} rel", _rel(got, want), DIST_ATTN_REL_TOL)
        self.held(f"{label} max|err|",
                  float((got.float() - want.float()).abs().max()),
                  tol["atol"] + tol["rtol"] * float(want.abs().max()))

    def forward(self, cfg, refs, params) -> None:
        """(b) the cache-free loss and forward with the kernels, against
        the single-card kernel path; one attention launch a layer a
        call, in the tuner's regime."""
        from repro_torch.models.lm import LM, Runtime
        fwd, dev = self.dist["forward"], self.dev
        model = LM(cfg, Runtime(kernel_ops=True, rules=self.rules,
                                mesh=self.mesh), device=dev)
        batch = _dist_batch(cfg, fwd, dev)
        loss = self.step("loss", lambda: model.loss(params, batch))
        self.held("loss rel",
                  abs(float(loss) - refs["loss"]) / abs(refs["loss"]),
                  LOSS_REL_TOL)
        logits = self.step("forward", lambda: model.forward(
            params, batch["tokens"]))
        if not torch.isfinite(logits).all():
            raise RuntimeError("non-finite sharded logits")
        if self.say:       # every rank holds the same gathered logits
            want, num, den = refs["logits"], 0.0, 0.0
            for c0 in range(0, want.shape[1], 256):
                w = want[:, c0:c0 + 256].to(logits.device).float()
                num += float((logits[:, c0:c0 + 256].float() - w).norm()) ** 2
                den += float(w.norm()) ** 2
            self.held("forward logits rel", (num / den) ** 0.5,
                      FORWARD_REL_TOL)
        for call in ("loss", "forward"):
            got = self.out["launches"][call]
            n_attn = sum(got.get(k, 0) for k in (
                "fused_attention", "fused_attention_partial"))
            if dev == "cuda" and (n_attn != cfg.n_layers or len(got) != 1):
                raise RuntimeError(f"[4k {call}] launches {got}, not "
                                   f"{cfg.n_layers} attention launches")

    def generate(self, arch, cfg, refs, params) -> None:
        """(c) ``generate`` on the sharded runtime of ``launch.serve
        --shard-model``: the tokens' agreement printed, the last logits
        with the inputs forced to the single-card tokens held."""
        from repro_torch.launch.serve import generate
        from repro_torch.models.lm import LM
        gen = self.dist["generate"]
        model = LM(cfg, self.rt, device=self.dev)
        prompts = _dist_prompts(cfg, gen, self.dev)
        tokens, _ = self.step(f"generate {arch}", lambda: generate(
            model, params, prompts, gen["gen"]))
        want = refs["generate tokens"].numpy()
        agree = self.out["agree"][f"generate {arch}"] = (
            int((tokens == want).sum()), tokens.size)
        forced = self.step(f"generate {arch} forced", lambda: _forced_generate(
            model, params, prompts, torch.from_numpy(want).to(prompts.device)))
        if self.say:
            cache = model.init_cache(prompts.shape[0],
                                     prompts.shape[1] + gen["gen"])[0]["k"]
            print(f"[4k generate {arch}] greedy tokens equal to the "
                  f"single-card run's: {agree} (printed, not held: bf16 "
                  f"all-reduces round in another order); a layer's k cache "
                  f"a rank {tuple(cache.shape)}")
        self.held(f"generate {arch} last logits rel",
                  _rel(forced, refs["generate logits"].to(forced.device)),
                  E2E_REL_TOL)

    def engines(self, cfg, refs, params) -> None:
        """(d) the continuous engine under the mesh: the tuner's paged
        regime printed, then paged-ring and paged-ring-pipelined each
        served once, forced; partial launches = decode steps x layers a
        rank, one decode step's logits on the same pages held to the
        single-card engine's, the tokens' agreement printed, nothing
        degraded."""
        from repro_torch.kernels import ops
        from repro_torch.models.lm import LM
        dev, out, serve = self.dev, self.out, self.dist["serve"]
        ps = serve["page_size"]
        n_ctx = ps * math.ceil((serve["prompt_len"] + serve["gen"]) / ps)
        choice, _ = ops.paged_attention_regime_choice(
            self.rules, self.mesh, batch=serve["batch"],
            q_heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, q_len=1,
            kv_len=n_ctx, head_dim=cfg.dh, page_size=ps, dtype=cfg.dtype)
        out["regimes"]["engine tuner"] = choice.regime
        if self.say:
            print(f"[4k engine] the tuner picks {choice.regime}: "
                  + " ".join(f"{r}={t * 1e6:.2f}us"
                             for r, t in choice.times.items())
                  + f" (modelled, q=1 over {n_ctx} paged slots)")
        for regime in ("paged-ring", "paged-ring-pipelined"):
            key = f"engine {regime}"
            # forced by the Runtime's flags, at the tiles the search gave
            # the regime, with the search off
            model = LM(cfg, dataclasses.replace(
                self.rt, dist_decode_attn=True,
                dist_decode_pipelined=regime == "paged-ring-pipelined",
                paged_block=(choice.kernels[regime].params.bq,
                             choice.kernels[regime].params.bkv)),
                device=dev)
            res, stats, engine = self.step(key, lambda: _forced_engine(
                cfg, model, params, serve, self.say))
            out["regimes"][key] = stats["regime"]
            out["tiers"][key] = (stats["exec_tier"], stats["tier_demotions"],
                                 stats["decode_graph"])
            got = out["launches"][key]
            want_n = stats["decode_steps"] * cfg.n_layers \
                if dev == "cuda" else 0
            if got.get("fused_attention_partial", 0) != want_n or set(
                    got) - {"fused_attention_partial"}:
                raise RuntimeError(f"[4k {key}] launches {got}, want "
                                   f"{want_n} partial launches")
            flat = [a == w for t, wt in zip([r.tokens for r in res],
                                            refs["engine tokens"])
                    for a, w in zip(t, wt)]
            out["agree"][key] = (sum(flat), len(flat))
            cache, args = _two_request_step(cfg, params, engine,
                                            self.dist["serve"])
            with torch.inference_mode():
                lg = engine.model.decode_step_paged(params, cache, *args)[0]
            if self.say:
                print(f"[4k {key}] regime {stats['regime']}: "
                      f"{stats['decode_steps']} decode steps, "
                      f"{stats['generated']} tokens, decode "
                      f"{stats['decode_graph']}, tier {stats['exec_tier']}, "
                      f"partial launches {want_n}; tokens equal to the "
                      f"single-card engine's {out['agree'][key]}")
            self.held(f"{key} decode step rel",
                      _rel(lg, refs["engine step"].to(lg.device)),
                      E2E_REL_TOL)
            if stats["exec_tier"] != "configured" or stats["tier_demotions"]:
                raise RuntimeError(f"[4k {key}] the engine degraded")
            del engine, cache
            _free(dev)


def _forced_engine(cfg, model, params, serve, verbose) -> tuple:
    """``launch.serve.run_continuous``'s workload on an engine sized as
    ``launch.serve.make_engine`` sizes it, with the regime search off
    (``choose_regime=False``): the engine runs the regime and tiles of
    ``model``'s Runtime.  (results, stats, engine)."""
    from repro_torch.serving import ServingEngine
    ps = serve["page_size"]
    max_pages = math.ceil((serve["prompt_len"] + serve["gen"]) / ps)
    b = serve["batch"]
    engine = ServingEngine(
        model, params, max_batch=b, page_size=ps,
        n_pages=1 + b * (max_pages + 1) + max(1, b * max_pages // 4),
        max_pages_per_seq=max_pages, verbose=verbose, choose_regime=False)
    results, stats = engine.run(_workload(cfg, serve))
    return results, stats, engine


def _dist_rank(rank, refdir, dist, dev, arch):
    """One rank of phase 4k on the model ``arch``: (a), (b), (c) and (d)
    on the first of ``dist["archs"]``, (c) on the others, each rank's
    shards of the weights made at seed 0 as one card's.  Returns the
    rank's launches, walls and device memory by step, its engine tiers,
    its denylist records and the tensors it moved through host
    memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import collectives
    from repro_torch.models.lm import LM
    from repro_torch.launch.serve import report_attention_regimes
    r = _DistRank(rank, dist, dev)
    cfg = _dist_cfg(arch, dist, dev)
    fwd = dist["forward"]       # the regime (b)'s forward shape gets
    r.out["regimes"][f"forward {arch}"] = report_attention_regimes(
        cfg, r.mesh, r.rules, batch=fwd["batch"], prompt_len=fwd["seq"],
        total_len=fwd["seq"], verbose=r.say)["prefill"]
    refs = torch.load(os.path.join(refdir, f"{cfg.name}.pt"))
    params = r.step(f"init {arch}", lambda: LM(
        cfg, r.rt, device=dev).init_params(0))
    if arch == dist["archs"][0]:
        r.kernels(refs)
        r.forward(cfg, refs, params)
        r.generate(arch, cfg, refs, params)
        r.engines(cfg, refs, params)
    else:
        r.generate(arch, cfg, refs, params)
    out = r.out
    out["deny"] = len(_deny_records())
    out["host_hops"] = dict(collectives.HOST_HOPS)
    out["backend"] = torch.distributed.get_backend()
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else 0.0)
    return out


def dist_refs_all(refdir, dist=DIST) -> None:
    """``dist_refs`` of every model of phase 4k, each initialised on the
    card as the ranks make it (seed 0) and freed."""
    for i, arch in enumerate(dist["archs"]):
        cfg = _dist_cfg(arch, dist)
        params = init_phase(cfg, "4k's depth")
        dist_refs(cfg, params, refdir, first=i == 0, dist=dist)
        del params
        _free("cuda")


def dist_phase(refdir, dist=DIST, dev="cuda") -> dict:
    """Phase 4k's world: ``dist["world"]`` spawned ranks run ``_dist_rank``
    against the single-card results under ``refdir``
    (``dist_refs``); the parent prints what each rank reports — the
    backend, the tensors it moved through host memory, its launches per
    step (every rank must launch alike, and each kernel of rows 1, 2 and
    4 at least once), its walls (through gloo on one card, not kernel
    times) — and fails if a rank degraded."""
    # the ranks' allocators grow segments in place: four of them share
    # the card with no block stranded between sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t0 = time.perf_counter()
    outs = None
    for arch in dist["archs"]:
        # a world per model: each rank's process, and every tensor it
        # made, ends before the next model's ranks start
        got = _spawn(_dist_rank, dist["world"], refdir, dist, dev, arch,
                    device=dev, timeout_s=900)
        if outs is None:
            outs = got
            continue
        for o, g in zip(outs, got):
            for key, val in g.items():
                if isinstance(val, dict):
                    o[key].update(val)
                elif key == "peak_gb":
                    o[key] = max(o[key], val)
                elif key == "deny":
                    o[key] += val
    wall = time.perf_counter() - t0
    first = outs[0]
    for r, o in enumerate(outs):
        if o["launches"] != first["launches"]:
            raise RuntimeError(f"[4k] rank {r} launched {o['launches']}, "
                               f"rank 0 {first['launches']}")
        if o["deny"] or any(t[0] != "configured" or t[1]
                            for t in o["tiers"].values()):
            raise RuntimeError(f"[4k] rank {r} degraded: {o['tiers']}, "
                               f"{o['deny']} denylist records")
    totals = {}
    for o in outs:
        for counts in o["launches"].values():
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    print(f"[4k] worlds of {dist['world']} ranks, backend "
          f"{first['backend']}, tensors through host memory a rank "
          f"{first['host_hops']}; peak device memory a rank "
          f"{max(o['peak_gb'] for o in outs):.2f} GB; {wall:.1f}s")
    print("[4k] launches a rank by step: " + json.dumps(first["launches"]))
    print(f"[4k] launches summed over the ranks: {totals}")
    print("[4k] walls a rank (s, through gloo on one card, ranks "
          "contending; not kernel times): "
          + json.dumps({k: round(v, 3) for k, v in first["walls"].items()}))
    if dev == "cuda":
        for name in ("fused_attention_partial", "fused_attention",
                     "fused_gemm_chain"):
            if not totals.get(name):
                raise RuntimeError(f"[4k] no rank launched {name}")
    return dict(world=dist["world"], backend=first["backend"],
                host_hops=first["host_hops"],
                peak_gb=max(o["peak_gb"] for o in outs),
                memory_gb=first["memory_gb"], launches=first["launches"],
                launches_summed=totals, walls=first["walls"],
                checks=first["checks"], agree=first["agree"],
                regimes=first["regimes"], tiers=first["tiers"],
                seconds=wall)


class _MeshShape:
    """A mesh's dims and sizes, for the tuner's MeshSpec of a rank's
    block (no process group needed)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def dist_time_phase(dist=DIST) -> dict:
    """Phase 4k's kernels at one rank's block (1 x 4 mesh), timed in
    the parent alone on the card, each beside its bound, its plain
    version and a library call: ``fused_gemm_chain`` on G12's H / 4
    columns, ``fused_attention`` (spatial regime) on qwen3-8b's forward
    at Hq / 4 and Hkv / 4 heads, and ``fused_attention_partial`` (ring
    regime) on the first of four blocks of its 2048 keys, every query
    row, at global positions, the kv heads repeated to the q heads as
    ``ring_attention`` runs it — each at the tiles the tuner picks for
    that block."""
    from repro_torch.core import api
    from repro_torch.core.perf_model import H100
    from repro_torch.dist.ring_dispatch import ring_group
    from repro_torch.dist.sharding import (Rules, dispatch_mesh_spec,
                                           ring_dispatch_spec)
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import gemm_chain as G
    n_dev = dist["world"]
    mesh = _MeshShape(data=1, model=n_dev)
    rules = Rules(data=("data",), model="model", tp="model", fsdp=False)
    out = {}
    (b, m, n, k, h), dt = dist["gemm"]["G12 bf16"]
    spec = dispatch_mesh_spec(rules, mesh, kind="gemm", batch=b,
                              feature_dims=(h,), ici_bw=H100.ici_bw)[0]
    tk = api.fuse_gemm_chain(m, n, k, h, batch=b, dtype=_dtname(dt),
                             mesh=spec)
    a, bb, d = _randn([(b, m, k), (b, k, n), (b, n, h // n_dev)], dt, 303,
                      scaled=True)
    kw = tk.params.as_kwargs()
    tiles, (splits, _), _ = G.check_gemm_chain(
        a, bb, d, kw["bm"], kw["bn"], kw["bk"], kw["bh"], kw["style"])
    out["fused_gemm_chain"] = dict(
        shape=[b, m, n, k, h // n_dev], tiles=kw, splits=splits,
        kernel_ms=_adaptive_ms(lambda: tk(a, bb, d)),
        plain_ms=_adaptive_ms(lambda: G.fused_gemm_chain_plain(
            a, bb, d, tiles[1], splits), reps=1),
        library_ms=None,
        unfused_ms=_adaptive_ms(lambda: torch.bmm(torch.bmm(a, bb), d)),
        **_bound(_nbytes(a, bb, d) + b * m * (h // n_dev) * a.element_size(),
                 2.0 * b * m * n * (k + h // n_dev), dt))
    b, hq, hkv, sq, sk = dist["attn"]["forward"]
    dh, dt = dist["head_dim"], torch.bfloat16
    scale = dh ** -0.5
    spec = dispatch_mesh_spec(rules, mesh, kind="attention", batch=b,
                              feature_dims=(hkv, hq), ici_bw=H100.ici_bw)[0]
    tk = api.fuse_attention(sq, sk, dh, dh, heads=hq, batch=b,
                            dtype=_dtname(dt), causal=True, mesh=spec)
    q, kk, vv = _randn([(b, hq // n_dev, sq, dh), (b, hkv // n_dev, sk, dh),
                        (b, hkv // n_dev, sk, dh)], dt, 304)
    out["fused_attention"] = dict(
        shape=[b, hq // n_dev, hkv // n_dev, sq, sk, dh],
        tiles=[tk.params.bq, tk.params.bkv],
        kernel_ms=_adaptive_ms(lambda: tk(q, kk, vv)),
        plain_ms=_adaptive_ms(lambda: A.fused_attention_plain(
            q, kk, vv, tk.params.bkv, True, 0, scale), reps=1),
        library_ms=_adaptive_ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True, scale=scale, enable_gqa=True)),
        **_bound(_nbytes(q, kk, vv) + q.numel() * q.element_size(),
                 _attention_ops(b, hq // n_dev, sq, sk, dh, dh, True), dt))
    spec = ring_dispatch_spec(rules, mesh, batch=b, kv_len=sk,
                              ici_bw=H100.ici_bw)[0]
    group = ring_group(hq, hkv, sq)     # 1: kv heads repeated to q heads
    tk = api.fuse_attention(sq, sk, dh, dh, heads=hq, batch=b,
                            dtype=_dtname(dt), causal=True, mesh=spec,
                            group=group)
    nl = sk // n_dev
    q, kk, vv = _randn([(b, hq, sq, dh), (b, hq // group, nl, dh),
                        (b, hq // group, nl, dh)], dt, 305)
    kv_pos = torch.arange(nl, dtype=torch.int32, device="cuda")
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32, device="cuda")
    bq, bkv, smem = A._check(q, kk, vv, kv_pos, q_pos, tk.params.bq,
                             tk.params.bkv)
    splits = A.partial_splits(b, hq // group, sq // bq, nl, bkv, smem)[0]
    mask = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
    live = float(mask.sum()) * b * hq           # (row, key) pairs
    out["fused_attention_partial"] = dict(
        shape=[b, hq, hq // group, sq, nl, dh], tiles=[bq, bkv],
        splits=splits,
        kernel_ms=_adaptive_ms(lambda: A.fused_attention_partial(
            q, kk, vv, kv_pos, q_pos, bq=bq, bkv=bkv, causal=True,
            scale=scale)),
        plain_ms=_adaptive_ms(lambda: A.fused_attention_partial_plain(
            q, kk, vv, kv_pos, q_pos, bkv, True, 0, scale, splits), reps=1),
        library_ms=_adaptive_ms(lambda: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)),
        # the function reads the Hkv heads' keys and values once, not
        # the repeated copies the kernel is given
        **_bound(_nbytes(q, kv_pos, q_pos)
                 + _nbytes(kk, vv) * hkv // kk.shape[1]
                 + (q.numel() + 2 * b * hq * sq) * 4,
                 4.0 * dh * live, dt))
    for name, t in out.items():
        print(f"[4k times, parent alone on the card] {name} at one rank's "
              f"block: " + json.dumps(t))
    return out


# ---------------------------------------------------------------------------
# Phase 4l: training under the mesh
# ---------------------------------------------------------------------------
# Worlds of spawned ranks as in 4k (gloo, every rank on the one card), each
# model in a world of its own.  (a) qwen3-8b at FULL widths cut to
# DIST_TRAIN["train"]["n_layers"] layers on a 2 x 2 world, one sequence a
# data rank, held against one single-card step on the same weights and
# batch (made first, in a process of its own, its results on the host);
# (b) its state after that step, written whole, re-meshed onto 1 x 2;
# (c) whisper-small's compressed step on 4 x 1; (d) olmoe-1b-7b on 1 x 4.
# The limits: the loss and norm of 4g's T1; each leaf's gradient, of
# this rank's block, as PERF.md's prediction for 4l states it (bf16 on
# both sides, sums in other orders).  After the update: Adam's first
# step moves each weight by about lr whatever its gradient's size, so
# two correct steps differ only where a gradient element's sign did
# (by 2 lr), and where the new weight rounded to the other side of a
# boundary of its type (one spacing): every element within 2 lr and one
# spacing, and in each rank's block of each leaf at most
# DIST_TRAIN_FLIP_SHARE of the elements moved apart by more than lr (a
# gradient within DIST_TRAIN_GRAD_REL_TOL flips about that limit / pi
# of its signs).  The zero-initialised norm scales (a few hundred
# elements, weights of about lr after the step, where one flip is a
# large share) are held by the elementwise rule alone, their flips
# printed.
DIST_TRAIN_LOSS_REL_TOL = 1e-4
DIST_TRAIN_GNORM_REL_TOL = 2e-3
DIST_TRAIN_GRAD_REL_TOL = 5e-2
DIST_TRAIN_FLIP_SHARE = 2e-2
ELASTIC_LOSS_REL_TOL = 1e-4
# (c): against one card's plain step on the whole batch: step 0's loss
# is the same function at other GEMM shapes (4g's T1 loss limit); every
# step's loss and step 0's gradient norm (int8 rounding) within the JAX
# package's own bound (tests/test_substrate.py)
COMPRESSED_STEP0_REL_TOL = 1e-4
COMPRESSED_REL_TOL = 5e-2
# (d): the engine's model under the mesh in f32 against one card's in
# f32, one card's routing pinned: the two prompts' prefill logits and
# the first decode step's (f32 on both sides, as MAMBA_F32_REL_TOL)
MOE_MESH_F32_REL_TOL = 1e-3
DIST_TRAIN = dict(
    world=4,
    train=dict(arch="qwen3-8b", n_layers=4, model_axis=2, batch=2,
               seq=2048, seed=11, lr=3e-4, more=2),
    remesh=dict(survivors=(0, 1, 2)),
    compressed=dict(arch=WHISPER, batch=4, seq=448, steps=3, seed=12,
                    lr=3e-4),
    moe=dict(arch=OLMOE, n_layers=8, model_axis=4, forward=FORWARD,
             serve=dict(SERVE, prompt_len=96)))


def _dt_cfg(spec, dev):
    """(a)'s config: FULL widths at ``spec["n_layers"]`` layers on the
    card, SMOKE on the CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"], smoke=dev != "cuda")
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                 spec["n_layers"]))


def _dt_rules():
    from repro_torch.dist.sharding import Rules
    return Rules(data=("data",), model="model", tp="model")


class _GradTap:
    """The optimizer of ``steps.make_train_step`` with ``seen(grads,
    layouts)`` called on the reduced gradients just before the update
    (which leaves them as they are)."""

    def __init__(self, opt, seen):
        self.opt, self.seen = opt, seen

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, state, layouts=None, mesh=None):
        self.seen(grads, layouts)
        return self.opt.update(params, grads, state, layouts, mesh)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0


def _dt_ref_rank(rank, refdir, spec, dev):
    """(a)'s reference: one single-card step of ``launch.steps``'
    ``make_train_step`` on (a)'s weights and batch, in a process of its
    own; its loss, norm, gradients and updated params to ``refdir``."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    model = LM(cfg, Runtime(), device=dev)
    params = model.init_params(0)
    opt = make_optimizer(spec["lr"], 1 + spec["more"])
    keys = [k for k, _ in T.leaves_with_paths(params)]
    grads = {}
    tap = _GradTap(opt, lambda gs, _: grads.update(
        {k: g.detach().cpu() for k, g in zip(keys, gs)}))
    step = S.make_train_step(model, tap)
    state = tap.init(params)
    batch = _dist_batch(cfg, spec, dev)
    with torch.inference_mode():    # 4o (b')'s reference, before the step
        prefill = _dr_prefill(model, params, cfg,
                              dict(DIST_REGIMES["prefill"], steps=0), dev)
    t0 = time.perf_counter()
    params, state, info = step(params, state, batch)
    loss, gnorm = float(info["loss"]), float(info["grad_norm"])
    wall = time.perf_counter() - t0
    torch.save({"grads": grads, "loss": loss, "grad_norm": gnorm,
                "prefill": prefill,
                "params": {k: p.detach().cpu()
                           for k, p in T.leaves_with_paths(params)}},
               os.path.join(refdir, "train_ref.pt"))
    return dict(loss=loss, grad_norm=gnorm, wall=wall, peak_gb=_peak_gb(dev))


@contextlib.contextmanager
def _dt_fault(fault: str, rank: int):
    """``--plant-faults``' training faults, for the duration: the
    data-dim gradient reduction skipped on rank 1 (it joins the
    all-reduce and keeps its own sums, so no rank waits), or
    ``Axis.enter`` an identity both ways (a replicated input's gradient
    left one rank's part)."""
    from repro_torch.dist import collectives
    from repro_torch.launch import steps as S
    real_reduce, real_enter = S.reduce_gradients, collectives.Axis.enter
    if fault == "data reduction skipped on rank 1" and rank == 1:
        S.reduce_gradients = lambda model, grads, *a: real_reduce(
            model, [g.clone() for g in grads], *a)
    elif fault == "enter an identity both ways":
        collectives.Axis.enter = lambda self, x: x
    try:
        yield
    finally:
        S.reduce_gradients, collectives.Axis.enter = real_reduce, real_enter


def _dt_train_rank(rank, refdir, ckdir, spec, dev, faults):
    """(a) on one rank of the 2 x 2 world: this rank's shards of (a)'s
    weights, one sharded ``make_train_step``, each leaf's reduced
    gradient and updated block held against the reference's block, the
    state saved whole (rank 0 writes), two more steps on the same batch;
    then each planted fault on a fresh copy of the weights."""
    from repro_torch import tree as T
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import collectives
    from repro_torch.dist.collectives import shard_dims
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    mesh = make_host_mesh(spec["model_axis"])
    model = LM(cfg, Runtime(rules=_dt_rules(), mesh=mesh), device=dev)
    ref = torch.load(os.path.join(refdir, "train_ref.pt"), mmap=True)
    batch = _dist_batch(cfg, spec, dev)
    out = {"walls": {}, "grad_rel": {}, "param_rel": {}, "faults": {}}

    def held(got, want, layouts) -> dict:
        return {k: _grad_distance(g, shard_dims(want[k], lay, mesh).to(
            g.device))[0] for (k, _), g, lay in zip(
                T.leaves_with_paths(params), got, layouts)}

    def one_step(tag):
        nonlocal params, state
        seen = {}
        tap = _GradTap(make_optimizer(spec["lr"], 1 + spec["more"]),
                       lambda gs, lay: seen.update(
                           held(gs, ref["grads"], lay)))
        step = S.make_train_step(model, tap)
        t0 = time.perf_counter()
        params, state, info = step(params, state, batch)
        loss = float(info["loss"])
        out["walls"][tag] = time.perf_counter() - t0
        return loss, float(info["grad_norm"]), seen

    opt = make_optimizer(spec["lr"], 1 + spec["more"])
    params = model.init_params(0)
    state = opt.init(params)
    zero_init = {k for k, p in T.leaves_with_paths(params) if not p.any()}
    out["loss"], out["grad_norm"], out["grad_rel"] = one_step("step 1")
    layouts = T.leaves(model.param_specs(), like=params)
    out["param_rel"], out["update"] = {}, {}
    for (k, p), lay in zip(T.leaves_with_paths(params), layouts):
        want = shard_dims(ref["params"][k], lay, mesh).to(p.device).float()
        d = (p.detach().float() - want).abs()
        spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
            min=1e-30)))) * torch.finfo(p.dtype).eps
        out["update"][k] = dict(
            flipped=int((d > spec["lr"]).sum()), elements=d.numel(),
            over_bound=int((d > 2 * spec["lr"] + spacing).sum()),
            zero_init=k in zero_init)
        out["param_rel"][k] = _grad_distance(p.detach(), want)[0]
    t0 = time.perf_counter()
    ckpt.save(ckdir, 1, {"params": params, "step": state["step"]},
              layouts={"params": model.param_specs(), "step": ()},
              mesh=mesh)
    out["walls"]["save whole"] = time.perf_counter() - t0
    out["more_losses"] = []
    for i in range(spec["more"]):
        loss, _, _ = one_step(f"step {i + 2}")
        out["more_losses"].append(loss)
    out["peak_gb"] = _peak_gb(dev)
    out["host_hops"] = {k: list(v) for k, v in
                        collectives.HOST_HOPS.items()}
    out["traffic"] = {k: list(v) for k, v in collectives.TRAFFIC.items()}
    for fault in faults:
        del params, state
        _free(dev)
        params = model.init_params(0)
        state = opt.init(params)
        with _dt_fault(fault, rank):
            _, _, rel = one_step(f"planted {fault}")
        out["faults"][fault] = max(rel.values())
    return out


def _dt_remesh_rank(rank, ckdir, spec, dev):
    """(b) on one rank of the re-meshed world: the whole state read on
    the host, ``replace_state`` onto the 1 x 2 mesh, (a)'s loss."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.runtime.fault_tolerance import replace_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    mesh = make_host_mesh(spec["model_axis"])
    model = LM(cfg, Runtime(rules=_dt_rules(), mesh=mesh), device=dev)
    t0 = time.perf_counter()
    whole = ckpt.restore(ckdir, 1)
    params = replace_state(whole["params"], mesh, model.param_specs(),
                           device=dev)
    restore_s = time.perf_counter() - t0
    del whole
    with torch.inference_mode():
        loss = float(model.loss(params, _dist_batch(cfg, spec, dev)))
    return dict(loss=loss, step=int(ckpt.restore(ckdir, 1)["step"]),
                restore_s=restore_s, peak_gb=_peak_gb(dev))


def _dt_compressed_setup(spec, dev) -> tuple:
    """(c)'s model without a mesh and its ``spec["steps"]`` whole
    batches (tokens, labels, frames)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import side_embeds
    from repro_torch.models.lm import Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(spec["arch"], smoke=dev != "cuda")
    batches = []
    for t in range(spec["steps"]):
        b = _dist_batch(cfg, dict(spec, seed=spec["seed"] + t), dev)
        b["frames"] = side_embeds(cfg, cfg.encoder.n_frames, spec["batch"],
                                  spec["seed"], t, dev)
        batches.append(b)
    return S.build_model(cfg, Runtime(), device=dev), batches


def _dt_steps(step, state, batches) -> dict:
    """Run ``step(*state, batch)`` over ``batches``: each step's loss,
    gradient norm and wall, and the last state."""
    out = dict(losses=[], grad_norms=[], walls=[])
    for b in batches:
        t0 = time.perf_counter()
        *state, info = step(*state, b)
        out["losses"].append(float(info["loss"]))
        out["grad_norms"].append(float(info["grad_norm"]))
        out["walls"].append(time.perf_counter() - t0)
    return out, state


def _dt_compressed_ref(rank, spec, dev):
    """(c)'s reference, in a process of its own: one card's plain
    ``steps.make_train_step`` on the whole batches from the seed-0
    weights."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_optimizer
    model, batches = _dt_compressed_setup(spec, dev)
    opt = make_optimizer(spec["lr"], spec["steps"])
    params = model.init_params(0)
    out, _ = _dt_steps(S.make_train_step(model, opt),
                       (params, opt.init(params)), batches)
    return dict(out, peak_gb=_peak_gb(dev))


def _dt_compressed_rank(rank, spec, dev):
    """(c) on one rank of the 4 x 1 world: whisper-small's
    ``make_compressed_train_step`` for ``spec["steps"]`` steps from the
    seed-0 weights, each rank on its block of the whole batches."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_optimizer
    model, batches = _dt_compressed_setup(spec, dev)
    opt = make_optimizer(spec["lr"], spec["steps"])
    params = model.init_params(0)
    out, (_, _, res) = _dt_steps(
        S.make_compressed_train_step(model, opt, make_host_mesh(1)),
        (params, opt.init(params), S.init_grad_residuals(params)), batches)
    return dict(out, peak_gb=_peak_gb(dev), residual_max=max(
        float(r.abs().max()) for r in T.leaves(res)))


def _dt_f32_two_request(cfg, engine, spec, dev, pinned=None) -> tuple:
    """The f32 twin of ``engine`` (an engine of its sizes on its model's
    Runtime, the seed-0 weights drawn in f32, its regime and tiles tuned
    anew for f32) on ``_two_request_step``'s two prompts: (the prefills'
    last logits, the first decode step's logits, the routing log of
    every route call), routed as ``pinned`` when it is given.  Frees
    ``engine`` first."""
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServingEngine
    rt = engine.model.rt
    sizes = dict(max_batch=engine.max_batch, page_size=engine.page_size,
                 n_pages=engine.pool.n_pages,
                 max_pages_per_seq=engine.max_pages)
    del engine
    _free(dev)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = LM(cfg, rt, device=dev)
    params = model.init_params(0)
    engine = ServingEngine(model, params, **sizes)
    prefill = []
    with torch.inference_mode(), _Routes(pinned=pinned) as routes:
        cache, args = _two_request_step(cfg, params, engine, spec, prefill)
        step = engine.model.decode_step_paged(params, cache, *args)[0]
    out = (torch.cat(prefill).float(), step.float(), routes.log)
    del params, model, engine, cache
    _free(dev)
    return out


def _dt_moe_refs(refdir, spec, dev) -> dict:
    """(d)'s single-card results, on the card in the parent: olmoe-1b-7b
    at seed 0 with the kernels — every layer's input, attention output,
    output and routing on (d)'s batch (``_Routes``), the loss, the
    engine's greedy tokens on (d)'s workload, and its model's f32 twin
    on two prompts (``_dt_f32_two_request``)."""
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models.lm import LM, Runtime
    cfg = _dt_cfg(spec, dev)
    model = LM(cfg, Runtime(kernel_ops=True), device=dev)
    params = model.init_params(0)
    batch = _dist_batch(cfg, spec["forward"], dev)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=dev)
    refs = {"x": [], "attn": [], "out": [], "topi": []}
    with torch.inference_mode():
        refs["loss"] = float(model.loss(params, batch))
        x = model._embed(params, tokens, positions)
        for p in params["layers"]:
            with _Routes() as r:
                y = model._apply_block("attn", p, x, positions)
            for key, t in (("x", x), ("attn", r.attn[0]), ("out", y),
                           ("topi", r.log[0])):
                refs[key].append(t.cpu())
            x = y
        results, _, engine = run_continuous(cfg, model, params,
                                            **spec["serve"], verbose=False)
    refs["engine tokens"] = [r.tokens for r in results]
    del params, model, results
    prefill, step, log = _dt_f32_two_request(cfg, engine, spec["serve"],
                                             dev)
    refs["f32"] = dict(prefill=prefill.cpu(), decode=step.cpu(),
                       routes=[t.cpu() for t in log])
    torch.save(refs, os.path.join(refdir, "moe_ref.pt"))
    return {"loss": refs["loss"]}


def _dt_moe_rank(rank, refdir, spec, dev):
    """(d) on one rank of the 1 x 4 world (``ep``: 16 of 64 experts a
    rank): every layer on the single-card layer's input with its routing
    pinned, held per token; the loss and forward with the kernels (one
    ``fused_attention`` launch a layer a call); the engine in the
    tuner's paged regime (one partial launch a layer a decode step),
    nothing degraded; then the engine's model in f32 on two prompts, one
    card's routing pinned (``_dt_f32_two_request``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import run_continuous, sharded_runtime
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    mesh = make_host_mesh(spec["model_axis"])
    model = LM(cfg, Runtime(kernel_ops=True, rules=_dt_rules(), mesh=mesh),
               device=dev)
    params = model.init_params(0)
    refs = torch.load(os.path.join(refdir, "moe_ref.pt"))
    batch = _dist_batch(cfg, spec["forward"], dev)
    b, s = batch["tokens"].shape
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    names = _path_counters()
    out = {"launches": {}, "walls": {}}
    attn_rel, out_rel = [], []
    with torch.inference_mode():
        for i, p in enumerate(params["layers"]):
            x = model._local(refs["x"][i].to(dev), b)
            with _Routes(pinned=[refs["topi"][i].to(dev)]) as r:
                y = model._apply_block("attn", p, x, positions,
                                       ctx=model._ctx(b))
            attn_rel.append(float(_row_rel(r.attn[0], refs["attn"][i].to(
                dev)).max()))
            out_rel.append(float(_row_rel(y, refs["out"][i].to(dev)).max()))
        out["layer_attn_rel"], out["layer_out_rel"] = max(attn_rel), max(
            out_rel)
        for call in ("loss", "forward"):
            _zero(*names)
            t0 = time.perf_counter()
            res = (model.loss(params, batch) if call == "loss"
                   else model.forward(params, batch["tokens"]))
            if dev == "cuda":
                torch.cuda.synchronize()
            out["walls"][call] = time.perf_counter() - t0
            out["launches"][call] = {k: v for k, v in _read(*names).items()
                                     if v}
            if call == "loss":
                out["loss"] = float(res)
            elif not torch.isfinite(res).all():
                raise RuntimeError("[4l (d)] non-finite sharded logits")
        del res
    _, _, rt = sharded_runtime(spec["model_axis"], mesh)
    model = LM(cfg, rt, device=dev)
    _zero(*names)
    t0 = time.perf_counter()
    results, stats, engine = run_continuous(cfg, model, params,
                                            **spec["serve"],
                                            verbose=rank == 0)
    out["walls"]["engine"] = time.perf_counter() - t0
    out["launches"]["engine"] = {k: v for k, v in _read(*names).items()
                                 if v}
    flat = [a == w for t, wt in zip([r.tokens for r in results],
                                    refs["engine tokens"])
            for a, w in zip(t, wt)]
    out["engine"] = dict(regime=stats["regime"],
                         decode_steps=stats["decode_steps"],
                         exec_tier=stats["exec_tier"],
                         demotions=stats["tier_demotions"],
                         agree=(sum(flat), len(flat)),
                         pools=tuple(engine.cache[0]["k_pages"].shape))
    del params, model, results
    want = refs["f32"]
    t0 = time.perf_counter()
    prefill, step, _ = _dt_f32_two_request(
        cfg, engine, spec["serve"], dev,
        pinned=[t.to(dev) for t in want["routes"]])
    out["f32"] = dict(prefill=_rel(prefill, want["prefill"].to(dev)),
                      decode=_rel(step, want["decode"].to(dev)),
                      wall=time.perf_counter() - t0)
    out["deny"] = len(_deny_records())
    out["peak_gb"] = _peak_gb(dev)
    return out


def dist_train_phase(dist=DIST_TRAIN, dev="cuda",
                     faults=("none",)) -> dict:
    """Phase 4l (module doc): (a)–(d), each world spawned after the
    last one's ranks ended; ``faults`` other than "none" are planted in
    (a) and must each go past its gradient limit.  Prints every check
    beside its limit and returns the readings."""
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dist-train-")
    ckdir = os.path.join(tmp, "ckpt")
    out = {}
    planted = tuple(f for f in faults if f != "none")
    try:
        spec = dist["train"]
        t0 = time.perf_counter()
        ref = _spawn(_dt_ref_rank, 1, tmp, spec, dev, device=dev,
                    timeout_s=900)[0]
        print(f"[4l (a) reference] one card, one step: loss "
              f"{ref['loss']:.6f}, grad_norm {ref['grad_norm']:.6f}, step "
              f"{ref['wall']:.2f}s, peak {ref['peak_gb']:.2f} GB "
              f"({time.perf_counter() - t0:.1f}s with the process)",
              flush=True)
        t0 = time.perf_counter()
        ranks = _spawn(_dt_train_rank, dist["world"], tmp, ckdir, spec, dev,
                      planted, device=dev, timeout_s=900)
        a_s = time.perf_counter() - t0
        r0 = ranks[0]
        loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
        gnorm_rel = abs(r0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        grad_rel = max(max(r["grad_rel"].values()) for r in ranks)
        param_rel = max(max(r["param_rel"].values()) for r in ranks)
        blocks = [(k, u) for r in ranks for k, u in r["update"].items()]
        upd = {k: sum(u[k] for _, u in blocks)
               for k in ("flipped", "over_bound", "elements")}
        shares = sorted(((k, u["flipped"] / u["elements"])
                         for k, u in blocks if not u["zero_init"]),
                        key=lambda kv: -kv[1])
        flip_share = shares[0][1]
        norms = [u for _, u in blocks if u["zero_init"]]
        norm_flips = (sum(u["flipped"] for u in norms),
                      sum(u["elements"] for u in norms),
                      max(u["flipped"] / u["elements"] for u in norms))
        worst_p = sorted(((k, v) for r in ranks
                          for k, v in r["param_rel"].items()),
                         key=lambda kv: -kv[1])
        worst = sorted(((k, v) for r in ranks
                        for k, v in r["grad_rel"].items()),
                       key=lambda kv: -kv[1])
        print(f"[4l (a)] {spec['arch']} at "
              f"{_dt_cfg(spec, dev).n_layers} layers on a "
              f"{dist['world'] // spec['model_axis']} x {spec['model_axis']}"
              f" world: loss {r0['loss']:.6f} rel {loss_rel:.3g} (tol "
              f"{DIST_TRAIN_LOSS_REL_TOL}), grad_norm rel {gnorm_rel:.3g} "
              f"(tol {DIST_TRAIN_GNORM_REL_TOL}); each rank's block of each "
              f"leaf: gradient rel max {grad_rel:.3g} (tol "
              f"{DIST_TRAIN_GRAD_REL_TOL}; the worst "
              f"{[(k, float(f'{v:.3g}')) for k, v in worst[:3]]}); after the "
              f"update, elements moved apart by more than lr "
              f"{upd['flipped']} of {upd['elements']} in all, in a rank's "
              f"block of a leaf at most {flip_share:.3g} (tol "
              f"{DIST_TRAIN_FLIP_SHARE}; the worst "
              f"{[(k, float(f'{v:.3g}')) for k, v in shares[:3]]}), in the "
              f"zero-initialised norm scales {norm_flips[0]} of "
              f"{norm_flips[1]} (a block at most {norm_flips[2]:.3g}; "
              f"printed), past 2 lr and one spacing "
              f"{upd['over_bound']} (tol 0), a leaf's rel max "
              f"{param_rel:.3g} (printed; the worst "
              f"{[(k, float(f'{v:.3g}')) for k, v in worst_p[:3]]}); two more "
              f"steps' losses {r0['more_losses']}", flush=True)
        print(f"[4l (a)] walls a rank (s, through gloo on one card, "
              f"ranks contending): "
              + json.dumps({k: round(v, 3) for k, v in r0["walls"].items()})
              + f"; collectives' payload a rank by op (count, bytes; "
              f"through host memory under gloo) {r0['traffic']}, of it "
              f"moved by via_host {r0['host_hops']}; "
              f"peak device memory a rank "
              f"{[round(r['peak_gb'], 2) for r in ranks]} GB; {a_s:.1f}s")
        checks = [(loss_rel, DIST_TRAIN_LOSS_REL_TOL, "loss"),
                  (gnorm_rel, DIST_TRAIN_GNORM_REL_TOL, "grad_norm"),
                  (grad_rel, DIST_TRAIN_GRAD_REL_TOL, "gradients"),
                  (flip_share, DIST_TRAIN_FLIP_SHARE, "updates apart"),
                  (upd["over_bound"], 0, "updates past 2 lr")]
        if not r0["more_losses"][-1] < r0["loss"]:
            checks.append((1.0, 0.0, "the loss did not fall"))
        for fault in planted:
            got = max(r["faults"][fault] for r in ranks)
            print(f"[4l (a) planted: {fault}] gradient rel max {got:.4g} "
                  f"(must exceed {DIST_TRAIN_GRAD_REL_TOL})")
            if not got > DIST_TRAIN_GRAD_REL_TOL:
                raise RuntimeError(f"[4l (a)] the planted fault {fault!r} "
                                   f"passed: {got}")
        for val, tol, what in checks:
            if val > tol:
                raise RuntimeError(f"[4l (a)] {what}: {val} > {tol}")
        out["train"] = dict(
            ref=ref, loss=r0["loss"], loss_rel=loss_rel, gnorm_rel=gnorm_rel,
            grad_rel=grad_rel, param_rel=param_rel, update=upd,
            flip_share=flip_share, worst_shares=shares[:3],
            norm_flips=norm_flips,
            more_losses=r0["more_losses"], walls=r0["walls"],
            host_hops=r0["host_hops"], traffic=r0["traffic"],
            peak_gb=[r["peak_gb"] for r in ranks],
            faults={f: max(r["faults"][f] for r in ranks) for f in planted},
            seconds=a_s)
        if planted:
            return out
        out["sp"] = sp_world_phase(tmp, spec, dev, dist["world"], ref,
                                   max(r["peak_gb"] for r in ranks))
        out["zero3"] = zero3_world_phase(tmp, spec, dev, dist["world"], ref)

        shape, kept = elastic_remesh(list(dist["remesh"]["survivors"]),
                                     spec["model_axis"])
        if shape != (1, spec["model_axis"]):
            raise RuntimeError(f"[4l (b)] elastic_remesh gave {shape}")
        t0 = time.perf_counter()
        rem = _spawn(_dt_remesh_rank, math.prod(shape), ckdir, spec, dev,
                    device=dev, timeout_s=900)
        want = r0["more_losses"][0]     # the loss on (a)'s batch after step 1
        rel = abs(rem[0]["loss"] - want) / abs(want)
        print(f"[4l (b)] rank 3 dropped: elastic_remesh over ranks "
              f"{list(dist['remesh']['survivors'])} -> {shape}, ranks kept "
              f"{kept}; the state of step {rem[0]['step']} re-sharded by "
              f"replace_state: loss {rem[0]['loss']:.6f} against the 2 x 2 "
              f"world's {want:.6f}, rel {rel:.3g} (tol "
              f"{ELASTIC_LOSS_REL_TOL}); restore {rem[0]['restore_s']:.2f}s"
              f"; {time.perf_counter() - t0:.1f}s", flush=True)
        if rel > ELASTIC_LOSS_REL_TOL:
            raise RuntimeError(f"[4l (b)] re-meshed loss rel {rel}")
        out["remesh"] = dict(shape=shape, kept=kept, loss=rem[0]["loss"],
                             want=want, rel=rel,
                             restore_s=rem[0]["restore_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    spec = dist["compressed"]
    t0 = time.perf_counter()
    plain = _spawn(_dt_compressed_ref, 1, spec, dev, device=dev,
                  timeout_s=900)[0]
    comp = _spawn(_dt_compressed_rank, dist["world"], spec, dev, device=dev,
                 timeout_s=900)[0]
    c, u = comp["losses"], plain["losses"]
    step0 = abs(c[0] - u[0]) / abs(u[0])
    each = max(abs(a - b) / abs(b) for a, b in zip(c, u))
    gnorm0 = abs(comp["grad_norms"][0] - plain["grad_norms"][0]) \
        / plain["grad_norms"][0]
    print(f"[4l (c)] {spec['arch']} on a {dist['world']} x 1 world, "
          f"B={spec['batch']} x {spec['seq']}: compressed losses {c}, "
          f"one card's plain step on the whole batch {u}; step 0 rel "
          f"{step0:.3g} (tol {COMPRESSED_STEP0_REL_TOL}), every step "
          f"{each:.3g} (tol {COMPRESSED_REL_TOL}), step 0's grad_norm "
          f"{comp['grad_norms'][0]:.6g} against {plain['grad_norms'][0]:.6g}"
          f", rel {gnorm0:.3g} (tol {COMPRESSED_REL_TOL}); residual max "
          f"{comp['residual_max']:.4g}; step walls (s) compressed "
          f"{[round(w, 3) for w in comp['walls']]}, one card's "
          f"{[round(w, 3) for w in plain['walls']]}; peak "
          f"{comp['peak_gb']:.2f} GB a rank, {plain['peak_gb']:.2f} GB one "
          f"card; {time.perf_counter() - t0:.1f}s", flush=True)
    if step0 > COMPRESSED_STEP0_REL_TOL or each > COMPRESSED_REL_TOL \
            or gnorm0 > COMPRESSED_REL_TOL or not comp["residual_max"] > 0:
        raise RuntimeError("[4l (c)] the compressed step left its limits")
    out["compressed"] = dict(comp, plain=plain, step0_rel=step0,
                             step_rel=each, grad_norm0_rel=gnorm0)

    spec = dist["moe"]
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dist-train-moe-")
    try:
        mref = _dt_moe_refs(tmp, spec, dev)
        ranks = _spawn(_dt_moe_rank, dist["world"], tmp, spec, dev,
                      device=dev, timeout_s=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    cfg = _dt_cfg(spec, dev)
    loss_rel = abs(r0["loss"] - mref["loss"]) / abs(mref["loss"])
    eng = r0["engine"]
    want_attn = cfg.n_layers if dev == "cuda" else 0
    want_partial = eng["decode_steps"] * cfg.n_layers if dev == "cuda" \
        else 0
    print(f"[4l (d)] {spec['arch']} on a 1 x {spec['model_axis']} world: "
          f"layer by layer on the single-card inputs, routing pinned: "
          f"attention output rel max {max(r['layer_attn_rel'] for r in ranks):.3g}"
          f", layer output {max(r['layer_out_rel'] for r in ranks):.3g} "
          f"(tol {FORWARD_REL_TOL} each, per token); loss "
          f"{r0['loss']:.5f} against one card's {mref['loss']:.5f}, rel "
          f"{loss_rel:.3g} (tol {MOE_FLIP_LOSS_REL_TOL}); launches a rank "
          f"{r0['launches']} (want {want_attn} fused_attention a call, "
          f"{want_partial} partial in the engine); engine regime "
          f"{eng['regime']}, {eng['decode_steps']} decode steps, pools a "
          f"rank {eng['pools']}, tier {eng['exec_tier']}, greedy tokens "
          f"equal to one card's {eng['agree']} (printed, not held); the "
          f"engine's model in f32, one card's routing pinned: two prefills'"
          f" logits rel {max(r['f32']['prefill'] for r in ranks):.3g}, the "
          f"first decode step's {max(r['f32']['decode'] for r in ranks):.3g}"
          f" (tol {MOE_MESH_F32_REL_TOL} each); walls "
          f"(s) {json.dumps({k: round(v, 2) for k, v in r0['walls'].items()})}"
          f"; peak {[round(r['peak_gb'], 2) for r in ranks]} GB; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for r, o in enumerate(ranks):
        for call in ("loss", "forward"):
            got = o["launches"][call]
            if got.get("fused_attention", 0) != want_attn or set(got) - {
                    "fused_attention"}:
                raise RuntimeError(f"[4l (d)] rank {r} {call} launched "
                                   f"{got}")
        got = o["launches"]["engine"]
        if got.get("fused_attention_partial", 0) != want_partial or set(
                got) - {"fused_attention_partial"}:
            raise RuntimeError(f"[4l (d)] rank {r} engine launched {got}")
        if o["deny"] or o["engine"]["exec_tier"] != "configured" \
                or o["engine"]["demotions"]:
            raise RuntimeError(f"[4l (d)] rank {r} degraded")
        if max(o["layer_attn_rel"], o["layer_out_rel"]) > FORWARD_REL_TOL:
            raise RuntimeError(f"[4l (d)] rank {r}: a layer diverges")
        if max(o["f32"]["prefill"], o["f32"]["decode"]) \
                > MOE_MESH_F32_REL_TOL:
            raise RuntimeError(f"[4l (d)] rank {r}: the f32 engine model "
                               f"diverges {o['f32']}")
    if loss_rel > MOE_FLIP_LOSS_REL_TOL:
        raise RuntimeError(f"[4l (d)] loss rel {loss_rel}")
    out["moe"] = dict(ref_loss=mref["loss"], loss=r0["loss"],
                      loss_rel=loss_rel,
                      layer_attn_rel=max(r["layer_attn_rel"] for r in ranks),
                      layer_out_rel=max(r["layer_out_rel"] for r in ranks),
                      f32=r0["f32"], launches=r0["launches"], engine=eng,
                      walls=r0["walls"],
                      peak_gb=[r["peak_gb"] for r in ranks],
                      seconds=time.perf_counter() - t0)
    out["seconds"] = time.perf_counter() - t_all
    print(f"[4l] {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 4n: the hybrid, state-space and encoder-decoder families under the
# mesh
# ---------------------------------------------------------------------------
# A world of four spawned ranks on the one card (gloo, as 4k and 4l), 2 x 2
# ("data", "model"): the only world shape whose model dim divides all three
# models' heads (recurrentgemma-2b's 10, mamba2-1.3b's 64, whisper-small's
# 12).  FULL widths; recurrentgemma-2b at 3 of 26 layers (one (R, R, A)
# super-block), mamba2-1.3b at 4 of 48, whisper-small whole (12 + 12).
# Each check is held against one card's run of the same port code on the
# same weights, made first in a process of its own (its results on the
# host): (a) one ``make_train_step`` under Megatron-SP (``tp+sp``), one
# sequence a data rank, to 4l (a)'s limits; (b) under the serving rules
# (``tp``: resident weights, distributed decode over a sequence-sharded
# cache) a prefill, then 16 teacher-forced decode steps, each step's
# logits within E2E_REL_TOL — recurrentgemma's steps cross its 2048-slot
# ring; (c) recurrentgemma-2b's loss and forward with the kernels
# (``Runtime(kernel_ops=True)``, ``tp``), each rank's q heads (5 of 10)
# over its gathered kv head: one ``fused_attention`` launch an attention
# layer a call on every rank, the loss within LOSS_REL_TOL and the
# logits within FORWARD_REL_TOL of one card's kernel path, nothing
# degraded.
DIST_FAMILIES = dict(
    world=4, model_axis=2, seed=21, lr=3e-4,
    archs={
        RG: dict(n_layers=3, train=dict(batch=2, seq=4096),
                 decode=dict(batch=2, prompt_len=2040, steps=16)),
        MAMBA: dict(n_layers=4, train=dict(batch=2, seq=4096),
                    decode=dict(batch=2, prompt_len=4080, steps=16)),
        WHISPER: dict(n_layers=None, train=dict(batch=4, seq=448),
                      decode=dict(batch=2, prompt_len=432, steps=16))},
    forward=RG)
# ``--plant-faults``: each must go past (a)'s gradient limit
DF_FAULTS = {"rglru main gathered own": RG,
             "mamba norm unsummed on rank 1": MAMBA}


def _df_cfg(arch, spec, dev):
    """4n's config of ``arch``: FULL widths at its depth on the card,
    SMOKE on the CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=dev != "cuda")
    n = spec["archs"][arch]["n_layers"]
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, n)) if n \
        else cfg


def _df_batch(cfg, shape, seed, dev) -> dict:
    """Seeded tokens and labels of ``shape`` (batch x seq), and an
    encoder-decoder's frames."""
    from repro_torch.launch.train import side_embeds
    out = _dist_batch(cfg, dict(shape, seed=seed), dev)
    if cfg.encoder is not None:
        out["frames"] = side_embeds(cfg, cfg.encoder.n_frames,
                                    shape["batch"], seed, 0, dev)
    return out


def _df_decode(model, params, cfg, shape, seed, dev) -> tuple:
    """(b): a prefill of ``prompt_len`` seeded tokens (over seeded
    frames), then ``steps`` decode steps fed the next seeded tokens:
    every logits (prefill's first) on the host, and the walls."""
    p, k = shape["prompt_len"], shape["steps"]
    batch = _df_batch(cfg, dict(batch=shape["batch"], seq=p + k), seed, dev)
    toks = batch["tokens"]
    side = (batch["frames"],) if cfg.encoder is not None else ()
    cache = model.init_cache(shape["batch"], p + k)
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, toks[:, :p], cache, *side)
    logits, walls = [lg.float().cpu()], [time.perf_counter() - t0]
    for j in range(k):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(
            params, cache, toks[:, p + j],
            torch.tensor(p + j, dtype=torch.int32, device=dev))
        logits.append(lg.float().cpu())
        walls.append(time.perf_counter() - t0)
    return logits, walls


def _df_ref_rank(rank, refdir, spec, dev):
    """One card's results of 4n's checks, in a process of its own: for
    each model (a) one ``make_train_step`` (loss, norm, every leaf's
    gradient), (b) the prefill and decode steps' logits, and for
    ``spec["forward"]`` (c) the kernel path's loss and forward logits;
    saved under ``refdir``."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, a in spec["archs"].items():
        cfg = _df_cfg(arch, spec, dev)
        model = S.build_model(cfg, Runtime(), device=dev)
        params = model.init_params(0)
        keys = [k for k, _ in T.leaves_with_paths(params)]
        grads = {}
        tap = _GradTap(make_optimizer(spec["lr"], 1), lambda gs, _: grads.update(
            {k: g.detach().cpu() for k, g in zip(keys, gs)}))
        state = tap.init(params)
        batch = _df_batch(cfg, a["train"], spec["seed"], dev)
        t0 = time.perf_counter()
        params, state, info = S.make_train_step(model, tap)(params, state,
                                                            batch)
        rec = dict(loss=float(info["loss"]), grad_norm=float(
            info["grad_norm"]), wall=time.perf_counter() - t0)
        del params, state, info
        _free(dev)
        save = {"grads": grads}
        params = model.init_params(0)
        with torch.inference_mode():
            if not spec.get("train_only"):
                save["decode"], rec["decode_walls"] = _df_decode(
                    model, params, cfg, a["decode"], spec["seed"] + 1, dev)
            if arch == spec["forward"] and not spec.get("train_only"):
                kmodel = S.build_model(cfg, Runtime(kernel_ops=True),
                                       device=dev)
                rec["kernel_loss"] = float(kmodel.loss(params, batch))
                save["forward"] = kmodel.forward(params, batch["tokens"]
                                                 ).cpu()
        torch.save(save, os.path.join(refdir, f"{cfg.name}.pt"))
        rec["peak_gb"] = _peak_gb(dev)
        out[arch] = rec
        del params, grads, save, model
        _free(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
    return out


@contextlib.contextmanager
def _df_fault(fault: str, rank: int):
    """A planted 4n fault, for the duration: the RG-LRU's gathered main
    branch taking its gradient ``"own"`` instead of ``"sum"``, or the
    Mamba-2 gated norm's sum of squares left unsummed over the model dim
    on rank 1 (it joins the all-reduce and keeps its own sums, so no
    rank waits)."""
    from repro_torch.models import layers as L
    real_g, real_s = L._gather_channels, L._sum_squares
    if fault == "rglru main gathered own":
        L._gather_channels = lambda tp, t: tp.gather(t, -1, "own")
    elif fault == "mamba norm unsummed on rank 1" and rank == 1:
        L._sum_squares = lambda tp, ss: ss + 0.0 * real_s(tp, ss)
    try:
        yield
    finally:
        L._gather_channels, L._sum_squares = real_g, real_s


def _df_rank(rank, refdir, spec, dev, faults):
    """4n on one rank of the 2 x 2 world: for each model (a) one
    sharded step under ``tp+sp``, each leaf's reduced gradient block
    against the reference's block (then each planted fault of the
    model's on fresh weights), (b) the serving rules' prefill and decode
    steps, (c) the kernel path's loss and forward, launches counted."""
    from repro_torch import tree as T
    from repro_torch.dist import collectives
    from repro_torch.dist.collectives import shard_dims
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import sharded_runtime
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(spec["model_axis"])
    names = _path_counters()
    out = {}
    for arch, a in spec["archs"].items():
        mine = [f for f in faults if DF_FAULTS[f] == arch]
        if faults and not mine:
            continue
        cfg = _df_cfg(arch, spec, dev)
        collectives.TRAFFIC.clear()
        ref = torch.load(os.path.join(refdir, f"{cfg.name}.pt"), mmap=True)
        model = S.build_model(cfg, Runtime(rules=_sp_rules(), mesh=mesh),
                              device=dev)
        batch = _df_batch(cfg, a["train"], spec["seed"], dev)
        rec = {"walls": {}, "faults": {}}

        def step(tag):
            params = model.init_params(0)
            seen = {}
            tap = _GradTap(make_optimizer(spec["lr"], 1), lambda gs, lay:
                           seen.update({k: _grad_distance(g, shard_dims(
                               ref["grads"][k], ly, mesh).to(g.device))[0]
                               for (k, _), g, ly in zip(
                                   T.leaves_with_paths(params), gs, lay)}))
            state = tap.init(params)
            t0 = time.perf_counter()
            _, _, info = S.make_train_step(model, tap)(params, state, batch)
            rec["walls"][tag] = time.perf_counter() - t0
            return float(info["loss"]), float(info["grad_norm"]), seen

        if not faults:
            rec["loss"], rec["grad_norm"], rec["grad_rel"] = step("(a) step")
        for fault in mine:
            _free(dev)
            with _df_fault(fault, rank):
                rec["faults"][fault] = max(step(f"planted {fault}")[2]
                                           .values())
        rec["peak_gb"] = {"(a)": _peak_gb(dev)}
        _free(dev)
        if faults:
            out[arch] = rec
            continue
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _, _, rt = sharded_runtime(spec["model_axis"], mesh)
        smodel = S.build_model(cfg, rt, device=dev)
        params = smodel.init_params(0)
        with torch.inference_mode():
            logits, walls = _df_decode(smodel, params, cfg, a["decode"],
                                       spec["seed"] + 1, dev)
        rec["decode_rel"] = [_rel(g, w) for g, w in zip(logits,
                                                        ref["decode"])]
        rec["walls"]["(b) prefill"] = walls[0]
        rec["walls"]["(b) decode step, mean"] = sum(walls[1:]) / len(
            walls[1:])
        rec["peak_gb"]["(b)"] = _peak_gb(dev)
        del params, smodel
        _free(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if arch == spec["forward"]:
            kmodel = S.build_model(cfg, Runtime(kernel_ops=True,
                                                rules=_dt_rules(),
                                                mesh=mesh), device=dev)
            params = kmodel.init_params(0)
            rec["launches"] = {}
            with torch.inference_mode():
                for call in ("loss", "forward"):
                    _zero(*names)
                    t0 = time.perf_counter()
                    res = (kmodel.loss(params, batch) if call == "loss"
                           else kmodel.forward(params, batch["tokens"]))
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    rec["walls"][f"(c) {call}"] = time.perf_counter() - t0
                    rec["launches"][call] = {
                        k: v for k, v in _read(*names).items() if v}
                    if call == "loss":
                        rec["kernel_loss"] = float(res)
                    elif rank == 0:
                        want = ref["forward"]
                        num = den = 0.0
                        for r0 in range(0, res.shape[1], 256):
                            w = want[:, r0:r0 + 256].to(dev).float()
                            num += float((res[:, r0:r0 + 256].float() - w)
                                         .pow(2).sum())
                            den += float(w.pow(2).sum())
                        rec["forward_rel"] = (num / den) ** 0.5
                    del res
            rec["peak_gb"]["(c)"] = _peak_gb(dev)
            del params, kmodel
            _free(dev)
        rec["deny"] = len(_deny_records())
        rec["traffic"] = {k: list(v) for k, v in
                          collectives.TRAFFIC.items()}
        out[arch] = rec
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
    return out


def dist_families_phase(dist=DIST_FAMILIES, dev="cuda", faults=()) -> dict:
    """Phase 4n (above): one card's reference in a process of its own,
    then the 2 x 2 world; every check printed beside its limit.  With
    ``faults`` only (a) of their models runs, each fault on fresh
    weights, and each must go past (a)'s gradient limit."""
    from repro_torch.models.lm import layer_kinds
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t_all = time.perf_counter()
    # the ranks' peaks add up to ~72 GB of the card: the parent keeps
    # nothing of the phases before (4l (d)'s one-card references)
    _free(dev)
    if dev == "cuda":
        print(f"[4n] the parent holds {torch.cuda.memory_reserved() / 1e9:.2f}"
              f" GB reserved before the world", flush=True)
    tmp = tempfile.mkdtemp(prefix="dist-families-")
    try:
        t0 = time.perf_counter()
        spec = dict(dist, train_only=bool(faults),
                    archs={a: s for a, s in dist["archs"].items()
                           if not faults or a in
                           {DF_FAULTS[f] for f in faults}})
        ref = _spawn(_df_ref_rank, 1, tmp, spec, dev, device=dev,
                    timeout_s=900)[0]
        ref_s = time.perf_counter() - t0
        print(f"[4n reference] one card, in a process of its own: "
              + json.dumps({a: {k: (round(v, 6) if isinstance(v, float)
                                    else v) for k, v in r.items()
                                if k != "decode_walls"}
                            for a, r in ref.items()})
              + f" ({ref_s:.1f}s)", flush=True)
        t0 = time.perf_counter()
        ranks = _spawn(_df_rank, dist["world"], tmp, spec, dev,
                      tuple(faults), device=dev, timeout_s=900)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"reference_s": ref_s, "world_s": world_s, "archs": {}}
    checks = []
    for arch in spec["archs"]:
        recs = [r[arch] for r in ranks]
        r0, want = recs[0], ref[arch]
        res = out["archs"][arch] = {"peak_gb": [r["peak_gb"] for r in recs],
                                    "walls": r0["walls"]}
        for fault in (f for f in faults if DF_FAULTS[f] == arch):
            got = max(r["faults"][fault] for r in recs)
            res.setdefault("faults", {})[fault] = got
            print(f"[4n (a) planted: {fault}] gradient rel max {got:.4g} "
                  f"(must exceed {DIST_TRAIN_GRAD_REL_TOL})")
            if not got > DIST_TRAIN_GRAD_REL_TOL:
                raise RuntimeError(f"[4n (a)] the planted fault {fault!r} "
                                   f"passed: {got}")
        if faults:
            continue
        cfg = _df_cfg(arch, spec, dev)
        loss_rel = abs(r0["loss"] - want["loss"]) / abs(want["loss"])
        gnorm_rel = abs(r0["grad_norm"] - want["grad_norm"]) \
            / want["grad_norm"]
        worst = sorted(((k, v) for r in recs for k, v in r["grad_rel"].items()),
                       key=lambda kv: -kv[1])
        dec = max(max(r["decode_rel"]) for r in recs)
        res.update(loss=r0["loss"], loss_rel=loss_rel, gnorm_rel=gnorm_rel,
                   grad_rel=worst[0][1], decode_rel=dec,
                   decode_rel_by_step=r0["decode_rel"],
                   ref_walls=dict(step=want["wall"],
                                  decode_step=sum(want["decode_walls"][1:])
                                  / len(want["decode_walls"][1:])))
        a = spec["archs"][arch]
        print(f"[4n] {arch} at {cfg.n_layers} layers on 2 x 2: (a) tp+sp "
              f"B={a['train']['batch']} x {a['train']['seq']}: loss "
              f"{r0['loss']:.6f} rel {loss_rel:.3g} (tol "
              f"{DIST_TRAIN_LOSS_REL_TOL}), grad_norm rel {gnorm_rel:.3g} "
              f"(tol {DIST_TRAIN_GNORM_REL_TOL}), each rank's block of each "
              f"leaf rel max {worst[0][1]:.3g} (tol "
              f"{DIST_TRAIN_GRAD_REL_TOL}; the worst "
              f"{[(k, float(f'{v:.3g}')) for k, v in worst[:3]]}); (b) tp, "
              f"prefill {a['decode']['prompt_len']} + "
              f"{a['decode']['steps']} decode steps: logits rel max {dec:.3g}"
              f" (tol {E2E_REL_TOL}; rank 0 by step "
              f"{[float(f'{v:.3g}') for v in r0['decode_rel']]})",
              flush=True)
        checks += [(loss_rel, DIST_TRAIN_LOSS_REL_TOL, f"{arch} loss"),
                   (gnorm_rel, DIST_TRAIN_GNORM_REL_TOL, f"{arch} norm"),
                   (worst[0][1], DIST_TRAIN_GRAD_REL_TOL,
                    f"{arch} gradients"),
                   (dec, E2E_REL_TOL, f"{arch} decode logits")]
        if arch == spec["forward"]:
            n_attn = sum(k == "attn" for k in layer_kinds(cfg))
            want_attn = n_attn if dev == "cuda" else 0
            krel = abs(r0["kernel_loss"] - want["kernel_loss"]) \
                / abs(want["kernel_loss"])
            res.update(kernel_loss_rel=krel, forward_rel=r0["forward_rel"],
                       launches=[r["launches"] for r in recs])
            print(f"[4n (c)] {arch} with the kernels (tp), B="
                  f"{a['train']['batch']} x {a['train']['seq']}: loss rel "
                  f"{krel:.3g} (tol {LOSS_REL_TOL}), forward logits rel "
                  f"{r0['forward_rel']:.3g} (tol {FORWARD_REL_TOL}); "
                  f"launches a rank {[r['launches'] for r in recs]} (want "
                  f"{want_attn} fused_attention a call, at "
                  f"{cfg.n_heads // spec['model_axis']} of {cfg.n_heads} q "
                  f"heads)", flush=True)
            checks += [(krel, LOSS_REL_TOL, f"{arch} kernel loss"),
                       (r0["forward_rel"], FORWARD_REL_TOL,
                        f"{arch} kernel forward")]
            for r, rec in enumerate(recs):
                for call, got in rec["launches"].items():
                    if got.get("fused_attention", 0) != want_attn or set(
                            got) - {"fused_attention"}:
                        raise RuntimeError(f"[4n (c)] rank {r} {call} "
                                           f"launched {got}")
        for r, rec in enumerate(recs):
            if rec["deny"]:
                raise RuntimeError(f"[4n] rank {r} degraded")
        print(f"[4n] {arch} walls a rank (s, through gloo on one card, "
              f"ranks contending): "
              + json.dumps({k: round(v, 3) for k, v in r0["walls"].items()})
              + f"; one card's step {want['wall']:.3f}s and decode step "
              f"{res['ref_walls']['decode_step']:.4f}s; peak a rank (GB) "
              f"{[{k: round(v, 2) for k, v in p.items()} for p in res['peak_gb']]}"
              f", one card's {want['peak_gb']:.2f}; collectives' payload "
              f"a rank by op (count, bytes; through host memory under gloo) "
              f"{r0['traffic']}", flush=True)
    for val, tol, what in checks:
        if val > tol:
            raise RuntimeError(f"[4n] {what}: {val} > {tol}")
    out["seconds"] = time.perf_counter() - t_all
    print(f"[4n] {out['seconds']:.1f}s (reference {ref_s:.1f}s, world "
          f"{world_s:.1f}s)")
    return out


def dist_families_time_phase(dist=DIST_FAMILIES) -> dict:
    """4n (c)'s kernel at one rank's block, timed in the parent alone on
    the card: ``fused_attention`` on recurrentgemma-2b's forward at
    B=1, its 5 of 10 q heads over the gathered kv head, S=4096, D=256,
    window 2048, at the tiles the tuner picks for that block (the
    regime search ``kernels.ops.attention_shard`` runs), beside its
    bound, its plain version and SDPA with the same boolean window
    mask."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.perf_model import H100
    from repro_torch.dist.sharding import dispatch_mesh_spec
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import ops
    cfg = get_config(dist["forward"])
    a = dist["archs"][dist["forward"]]["train"]
    n = dist["model_axis"]
    mesh = _MeshShape(data=dist["world"] // n, model=n)
    rules = _dt_rules()
    b, s, d, win = a["batch"], a["seq"], cfg.dh, cfg.attn_window
    hq, hkv = cfg.n_heads, cfg.n_kv_heads * n   # the ranks' kv blocks
    scale = d ** -0.5
    dt = torch.bfloat16
    spatial = dispatch_mesh_spec(rules, mesh, kind="attention", batch=b,
                                 feature_dims=(hkv, hq), ici_bw=H100.ici_bw)
    choice, _ = ops.attention_regime_choice(
        rules, mesh, batch=b, q_heads=hq, kv_heads=hkv, q_len=s, kv_len=s,
        head_dim=d, dtype=_dtname(dt), causal=True, window=win, scale=scale,
        spatial=spatial)
    tk = choice.kernel if choice is not None else api.fuse_attention(
        s, s, d, d, heads=hq, batch=b, dtype=_dtname(dt), causal=True,
        window=win, scale=scale, mesh=spatial[0])
    bl = b // (dist["world"] // n)
    q, k, v = _randn([(bl, hq // n, s, d), (bl, 1, s, d), (bl, 1, s, d)],
                     dt, 306)
    rows = torch.arange(s, device="cuda")[:, None]
    cols = torch.arange(s, device="cuda")[None, :]
    mask = (cols <= rows) & (cols > rows - win)
    with torch.inference_mode():
        out = dict(
            shape=[bl, hq // n, 1, s, s, d], window=win,
            regime=choice.regime if choice is not None else "spatial",
            tiles=[tk.params.bq, tk.params.bkv],
            kernel_ms=_adaptive_ms(lambda: tk(q, k, v)),
            plain_ms=_adaptive_ms(lambda: A.fused_attention_plain(
                q, k, v, tk.params.bkv, True, win, scale), reps=1),
            library_ms=_adaptive_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)),
            **_bound(_nbytes(q, k, v, q),
                     _attention_ops(bl, hq // n, s, s, d, d, True, win), dt))
    print(f"[4n times, parent alone on the card] fused_attention at one "
          f"rank's block: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 4o: the remaining distributed regimes — the planned path under the
# mesh, paged serving under sequence parallelism, zero3's multi-pod form
# ---------------------------------------------------------------------------

# qwen3-8b at FULL widths, its depth cut to 4 of 36 layers (the full
# run's time limit), on a 1 x 4 world: (a) the planned engine in the
# tuner's paged regime and forced to each of paged-spatial and paged-ring
# the tuner did not pick, on 8 ragged requests of up to 96 + 32
# positions (8 pages of 16, which the model dim divides: the paged ring
# is offered), (b) a 128-token prompt's paged prefill under
# ``Rules(seq="model")`` (32 rows a rank), then 3 decode steps; (c) runs
# in 4l after 4m (c), on 4l (a)'s reference.  The MLP kernel's rank
# blocks: d_ff over 4 ranks (qwen3-8b N = 3072, granite-20b N = 6144), at
# the decode and a prefill row count.
DIST_REGIMES = dict(
    world=4, arch="qwen3-8b", n_layers=4,
    serve=dict(SERVE, prompt_len=96),
    prefill=dict(prompt_len=128, steps=3, page_size=16, seed=31),
    blocks={"qwen3-8b": 4, GRANITE: 4}, block_ms=(4, 144), pods=2)
# ``--plant-faults``: each must go past E2E_REL_TOL
DR_FAULTS = ("residual before the MLP's reduction",
             "reduce-scatter for the shard under SP alone")


def _dr_cfg(spec, dev):
    """4o's config: FULL widths at ``spec["n_layers"]`` layers on the
    card, SMOKE on the CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"], smoke=dev != "cuda")
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                 spec["n_layers"]))


def _planted_res2(L):
    """``run_planned_layer`` with the MLP's rank-partial output left
    unsummed and the sum taken after the stitched ``res2`` has added the
    residual on every rank: the residual counted once a rank."""
    import inspect
    import textwrap
    src = textwrap.dedent(inspect.getsource(L.run_planned_layer))
    for old, new in (
            ("            out = _leave(ctx, out)\n"
             "            nm = mlp_unit.ops[-1]\n",
             "            nm = mlp_unit.ops[-1]\n"),
            ("                   else res + mix)\n",
             "                   else res + mix)\n"
             "            if nm == \"res2\" and mlp_unit is not None:\n"
             "                out = _leave(ctx, out)\n")):
        if old not in src:
            raise RuntimeError("4o: the planted fault's seam moved")
        src = src.replace(old, new)
    ns: dict = {}
    exec(compile(src, L.__file__, "exec"), vars(L), ns)
    return ns["run_planned_layer"]


@contextlib.contextmanager
def _dr_fault(fault):
    """A planted 4o fault, for the duration (DR_FAULTS): the residual
    added before the planned MLP's reduction, or a reduce-scatter where
    a block keeps its rank's rows under sequence parallelism without
    tensor parallelism (``layers._leave`` and ``_leave_whole``)."""
    from repro_torch.models import layers as L
    real = L.run_planned_layer, L._leave, L._leave_whole
    if fault == DR_FAULTS[0]:
        L.run_planned_layer = _planted_res2(L)
    elif fault == DR_FAULTS[1]:
        def leave(ctx, out, real_fn):
            if ctx is not None and ctx.seq is not None and ctx.tp is None:
                return ctx.seq.scatter(out, 1)
            return real_fn(ctx, out)
        L._leave = lambda ctx, out: leave(ctx, out, real[1])
        L._leave_whole = lambda ctx, out: leave(ctx, out, real[2])
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        L.run_planned_layer, L._leave, L._leave_whole = real


class _ForcedExec:
    """An engine's ``_exec`` wrapped: each dispatch's live logits (the
    prefill's row, a decode step's active slots) recorded; given
    ``want`` (another engine's record) the engine is handed that
    engine's logits or greedy tokens, so it schedules as that engine
    did, and each dispatch's logits are held to that engine's (relative
    norm over the live rows)."""

    def __init__(self, engine, want=None):
        self.real, self.want, self.dev = engine._exec, want, engine.device
        self.got, self.rel = [], []
        engine._exec = self

    def __call__(self, phase, *args):
        out = self.real(phase, *args)
        rows = [0] if phase == "prefill" else list(args[0])
        logits = out if phase == "prefill" else out[1]
        live = logits[rows].float().cpu()
        host = None if phase == "prefill" else out[0].cpu()
        i = len(self.got)
        self.got.append((phase, rows, live, host))
        if self.want is None:
            return out
        wphase, wrows, wlive, whost = self.want[i]
        if (wphase, wrows) != (phase, rows):
            raise RuntimeError(f"4o: dispatch {i} is {phase} {rows}, the "
                               f"reference's {wphase} {wrows}")
        self.rel.append(_rel(live, wlive))
        if phase == "prefill":
            return wlive.to(self.dev)
        return whost.to(self.dev), out[1]


def _dr_serve(model, params, cfg, spec, dev, want=None,
              choose_regime=False) -> dict:
    """(a): the planned engine of ``model`` on 4o's workload, sized as
    ``_forced_engine`` sizes it, each dispatch through ``_ForcedExec``;
    the kernel counters set to 0 just before the run and read just
    after."""
    from repro_torch.serving import ServingEngine
    serve = spec["serve"]
    ps, b = serve["page_size"], serve["batch"]
    max_pages = math.ceil((serve["prompt_len"] + serve["gen"]) / ps)
    names = _path_counters()
    _zero(*names)
    t0 = time.perf_counter()
    engine = ServingEngine(
        model, params, max_batch=b, page_size=ps,
        n_pages=1 + b * (max_pages + 1) + max(1, b * max_pages // 4),
        max_pages_per_seq=max_pages, choose_regime=choose_regime)
    rec = _ForcedExec(engine, want)
    results, stats = engine.run(_workload(cfg, serve))
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(tokens=[r.tokens for r in results], stats=stats,
                regime=engine.regime, record=rec.got, rel=rec.rel,
                phases=[g[0] for g in rec.got],
                launches={k: v for k, v in _read(*names).items() if v},
                planned=engine.decode_plan is not None,
                wall=time.perf_counter() - t0)


def _dr_ref_rank(rank, refdir, spec, dev):
    """4o's one-card reference, in a process of its own: (a) the planned
    engine on the workload, every dispatch's live logits and greedy
    tokens recorded; (b) the planned paged prefill and its decode steps;
    saved under ``refdir``."""
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dr_cfg(spec, dev)
    model = LM(cfg, Runtime(kernel_ops=True, planner=True), device=dev)
    params = model.init_params(0)
    with torch.inference_mode():
        a = _dr_serve(model, params, cfg, spec, dev, choose_regime=True)
        b = _dr_prefill(model, params, cfg, spec["prefill"], dev)
    torch.save({"record": a["record"], "tokens": a["tokens"], "prefill": b},
               os.path.join(refdir, "regimes_ref.pt"))
    return dict(stats={k: a["stats"][k] for k in (
        "decode_steps", "prefills", "generated", "decode_graph",
        "exec_tier")}, launches=a["launches"], wall=a["wall"],
        peak_gb=_peak_gb(dev))


def _dr_rank(rank, refdir, spec, dev, faults):
    """4o (a) and (b) on one rank of the 1 x 4 world: the planned engine
    (``Runtime(kernel_ops=True, planner=True)`` on the serving rules)
    in the tuner's pick and forced to each of paged-spatial and
    paged-ring the tuner did not pick, each dispatch teacher-forced to
    the reference's and held to it;
    then the planned paged prefill under ``Rules(seq="model")`` and its
    decode steps.  With ``faults`` only (a)'s paged-spatial run, each
    fault planted."""
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import sharded_runtime
    from repro_torch.models.lm import LM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dr_cfg(spec, dev)
    mesh = make_host_mesh(spec["world"])
    _, _, rt = sharded_runtime(spec["world"], mesh)
    rt = dataclasses.replace(rt, planner=True)
    ref = torch.load(os.path.join(refdir, "regimes_ref.pt"))
    params = LM(cfg, rt, device=dev).init_params(0)
    serve = spec["serve"]
    ps = serve["page_size"]
    choice, _ = ops.paged_attention_regime_choice(
        rt.rules, mesh, batch=serve["batch"], q_heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, q_len=1,
        kv_len=ps * math.ceil((serve["prompt_len"] + serve["gen"]) / ps),
        head_dim=cfg.dh, page_size=ps, dtype=cfg.dtype)

    def forced(regime):
        # the Runtime's flags and the tiles the search gave the regime
        p = choice.kernels[regime].params
        return LM(cfg, dataclasses.replace(
            rt, dist_decode_attn=regime != "paged-spatial",
            dist_decode_pipelined=regime == "paged-ring-pipelined",
            paged_block=(p.bq, p.bkv)), device=dev)

    out = {"engines": {}, "faults": {}, "tuner": choice.regime,
           "modelled": dict(choice.times)}
    for fault in faults:
        with _dr_fault(fault), torch.inference_mode():
            got = _dr_serve(forced("paged-spatial"), params, cfg, spec, dev,
                            ref["record"])
        out["faults"][fault] = max(got["rel"])
        _free(dev)
    if faults:
        return out
    for label in ["tuner"] + [r for r in ("paged-spatial", "paged-ring")
                              if r != choice.regime]:
        model = forced(label) if label != "tuner" else LM(cfg, rt,
                                                          device=dev)
        with torch.inference_mode():
            got = _dr_serve(model, params, cfg, spec, dev, ref["record"],
                            choose_regime=label == "tuner")
        out["engines"][label] = dict(
            regime=got["regime"], rel=got["rel"], phases=got["phases"],
            launches=got["launches"],
            planned=got["planned"], wall=got["wall"],
            agree=sum(a == w for t, wt in zip(got["tokens"], ref["tokens"])
                      for a, w in zip(t, wt)),
            stats={k: got["stats"][k] for k in (
                "decode_steps", "prefills", "generated", "decode_graph",
                "exec_tier", "tier_demotions")})
        _free(dev)
    rules = Rules(data=("data",), model="model", tp="model", seq="model",
                  fsdp=False)
    model = LM(cfg, dataclasses.replace(rt, rules=rules,
                                        dist_decode_attn=False), device=dev)
    _zero(*_path_counters())
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre = _dr_prefill(model, params, cfg, spec["prefill"], dev)
    out["prefill"] = dict(
        rel=[_rel(g, w) for g, w in zip(pre, ref["prefill"])],
        launches={k: v for k, v in _read(*_path_counters()).items() if v},
        wall=time.perf_counter() - t0)
    out["deny"] = len(_deny_records())
    out["peak_gb"] = _peak_gb(dev)
    return out


def _dr_block_shapes(spec) -> dict:
    """{(arch, M): (M, N, H)}: the MLP kernel's rank blocks of 4o, d_ff
    over the model dim's ranks, at the decode and a prefill row
    count."""
    from repro_torch.configs import get_config
    out = {}
    for arch, ways in spec["blocks"].items():
        cfg = get_config(arch)
        for m in spec["block_ms"]:
            out[arch, m] = (m, cfg.d_ff // ways, cfg.d_model)
    return out


def _dr_pretune(shapes) -> dict:
    """A worker process's call: the MLP kernel tuned (bf16, gated silu)
    at each of ``shapes`` ((M, N, H)), so that the schedules reach the
    disk cache before the phases that launch them; {shape: (tiles,
    source, seconds)}."""
    from repro_torch.core import api
    out = {}
    for m, n, h in shapes:
        t0 = time.perf_counter()
        tk = api.fuse_mlp_chain(m, n, h, dtype="bfloat16", gated=True,
                                act="silu")
        out[m, n, h] = (tk.params.as_kwargs(), tk.source,
                        time.perf_counter() - t0)
    return out


def start_pretune(spec=DIST_REGIMES):
    """4o's MLP shapes tuned in a worker process while the card runs the
    earlier phases: the rank blocks, and the 1 x 4 world's decode and
    prefill rows at qwen3-8b's block (the padded prompt lengths of the
    workload and of (b)).  Returns (the pool, the future)."""
    import multiprocessing
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    n, h = cfg.d_ff // spec["world"], cfg.d_model
    ps = spec["serve"]["page_size"]
    rows = {spec["serve"]["batch"], spec["prefill"]["prompt_len"]}
    rows |= {math.ceil(len(p) / ps) * ps
             for p, _ in _workload(cfg, spec["serve"])}
    shapes = list(_dr_block_shapes(spec).values())
    shapes += [(m, n, h) for m in sorted(rows) if (m, n, h) not in shapes]
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(_dr_pretune, shapes)


def dist_regimes_phase(spec=DIST_REGIMES, dev="cuda", faults=(),
                       zero3=None) -> dict:
    """Phase 4o (above): one card's reference in a process of its own,
    then the 1 x 4 world for (a) and (b); (c) is ``zero3`` (4l's
    reading) or runs here on a 4l (a) reference of its own.  Every check
    printed beside its limit.  With ``faults`` each fault is planted in
    (a)'s paged-spatial run or (c)'s prefill, and must go past
    E2E_REL_TOL."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t_all = time.perf_counter()
    _free(dev)
    tmp = tempfile.mkdtemp(prefix="dist-regimes-")
    cfg = _dr_cfg(spec, dev)
    try:
        t0 = time.perf_counter()
        ref = _spawn(_dr_ref_rank, 1, tmp, spec, dev, device=dev,
                    timeout_s=900)[0]
        ref_s = time.perf_counter() - t0
        print(f"[4o reference] {cfg.name} at {cfg.n_layers} layers, one "
              f"card, planned, in a process of its own: {ref['stats']}, "
              f"launches {ref['launches']}, engine {ref['wall']:.1f}s, peak "
              f"{ref['peak_gb']:.2f} GB ({ref_s:.1f}s)", flush=True)
        t0 = time.perf_counter()
        ranks = _spawn(_dr_rank, spec["world"], tmp, spec, dev,
                      tuple(f for f in faults if f == DR_FAULTS[0]),
                      device=dev, timeout_s=900)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"reference_s": ref_s, "world_s": world_s, "faults": {}}
    if faults:
        got = max(r["faults"][DR_FAULTS[0]] for r in ranks)
        out["faults"][DR_FAULTS[0]] = got
        print(f"[4o (a) planted: {DR_FAULTS[0]}] the planned engine's "
              f"teacher-forced logits rel max {got:.4g} (must exceed "
              f"{E2E_REL_TOL})", flush=True)
        if not got > E2E_REL_TOL:
            raise RuntimeError(f"[4o (a)] the planted fault passed: {got}")
        zero3_phase_alone(dev, faults=(DR_FAULTS[1],))
        return out
    r0, layers = ranks[0], cfg.n_layers
    print(f"[4o (a)] the tuner picks {r0['tuner']}: "
          + " ".join(f"{r}={t * 1e6:.2f}us" for r, t in r0["modelled"].items())
          + " (modelled, q=1 over the engine's paged slots)", flush=True)
    checks = []
    for label, e in r0["engines"].items():
        st = e["stats"]
        want = {"fused_mlp_chain": (st["decode_steps"] + st["prefills"])
                * layers, "fused_attention_partial": st["decode_steps"]
                * layers}
        if dev != "cuda":
            want = {}
        for r, rec in enumerate(ranks):
            got = rec["engines"][label]
            if got["launches"] != want:
                raise RuntimeError(f"[4o (a) {label}] rank {r} launched "
                                   f"{got['launches']}, want {want}")
            if got["stats"] != st or not got["planned"]:
                raise RuntimeError(f"[4o (a) {label}] rank {r} served "
                                   f"{got['stats']} (rank 0 {st})")
        if st["exec_tier"] != "configured" or st["tier_demotions"]:
            raise RuntimeError(f"[4o (a) {label}] the engine degraded")
        worst = max(max(r["engines"][label]["rel"]) for r in ranks)
        by = {ph: [v for v, p in zip(e["rel"], e["phases"]) if p == ph]
              for ph in ("prefill", "decode")}
        out.setdefault("engines", {})[label] = dict(
            regime=e["regime"], rel_max=worst, launches=e["launches"],
            rel_decode=by["decode"], rel_prefill=by["prefill"],
            stats=st, wall=e["wall"], agree=e["agree"])
        print(f"[4o (a) {label}] regime {e['regime']}, planned: "
              f"{st['decode_steps']} decode steps, {st['prefills']} "
              f"prefills, decode {st['decode_graph']}, tier "
              f"{st['exec_tier']}; every dispatch teacher-forced to one "
              f"card's planned engine: logits rel max over the ranks "
              f"{worst:.3g} (tol {E2E_REL_TOL}; rank 0's prefills "
              f"{[float(f'{v:.3g}') for v in by['prefill']]}, decode steps "
              f"{[float(f'{v:.3g}') for v in by['decode']]}); launches a rank "
              f"{e['launches']} (want {want}, alike on every rank); "
              f"greedy tokens equal to one card's before forcing "
              f"{e['agree']}; {e['wall']:.1f}s through gloo", flush=True)
        checks.append((worst, E2E_REL_TOL, f"(a) {label} logits"))
    pre = r0["prefill"]
    want_pre = ({"fused_mlp_chain": (1 + spec["prefill"]["steps"]) * layers,
                 "fused_attention_partial": spec["prefill"]["steps"]
                 * layers} if dev == "cuda" else {})
    for r, rec in enumerate(ranks):
        if rec["prefill"]["launches"] != want_pre:
            raise RuntimeError(f"[4o (b)] rank {r} launched "
                               f"{rec['prefill']['launches']}, want "
                               f"{want_pre}")
    rel_pre = max(max(r["prefill"]["rel"]) for r in ranks)
    print(f"[4o (b)] the planned paged prefill of "
          f"{spec['prefill']['prompt_len']} tokens under Rules(seq='model')"
          f" ({spec['prefill']['prompt_len'] // spec['world']} rows a "
          f"rank), then {spec['prefill']['steps']} decode steps under plain "
          f"tensor parallelism: logits rel by step (the prefill's last "
          f"real token first) {[float(f'{v:.3g}') for v in pre['rel']]} "
          f"(tol {E2E_REL_TOL}); launches a rank {pre['launches']} (want "
          f"{want_pre}); {pre['wall']:.2f}s", flush=True)
    checks.append((rel_pre, E2E_REL_TOL, "(b) logits"))
    for r, rec in enumerate(ranks):
        if rec["deny"]:
            raise RuntimeError(f"[4o] rank {r} degraded")
    for val, tol, what in checks:
        if val > tol:
            raise RuntimeError(f"[4o] {what}: {val} > {tol}")
    if zero3 is None:
        zero3 = zero3_phase_alone(dev)
    out.update(tuner=r0["tuner"], modelled=r0["modelled"],
               prefill=dict(rel=pre["rel"], launches=pre["launches"]),
               zero3=zero3, peak_gb=[r["peak_gb"] for r in ranks],
               seconds=time.perf_counter() - t_all)
    print(f"[4o] {out['seconds']:.1f}s (reference {ref_s:.1f}s, world "
          f"{world_s:.1f}s; (c) {zero3.get('seconds', 0.0):.1f}s)",
          flush=True)
    return out


def zero3_phase_alone(dev="cuda", faults=()) -> dict:
    """4o (c) outside 4l: 4l (a)'s one-card reference in a process of its
    own, then ``zero3_world_phase``."""
    spec = DIST_TRAIN["train"]
    tmp = tempfile.mkdtemp(prefix="dist-regimes-zero3-")
    try:
        ref = _spawn(_dt_ref_rank, 1, tmp, spec, dev, device=dev,
                    timeout_s=900)[0]
        return zero3_world_phase(tmp, spec, dev, DIST_TRAIN["world"], ref,
                                 DIST_REGIMES["pods"], faults)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dist_regimes_kernel_phase(spec=DIST_REGIMES, pretuned=None) -> tuple:
    """Phase 3 at 4o's shapes, then their times, the parent alone on the
    card: the MLP kernel at each rank block of ``_dr_block_shapes`` (N =
    d_ff / 4, K = H = d_model) at the tuner's tiles and the tiles around
    them (``_mlp_sweep_tiles``) against its plain version with the same
    split within bf16 TOL; then ``mlp_time_phase`` at each block.
    ``pretuned``: the worker's future (its tiles printed beside the
    parent's).  Returns (the largest error, {label: times})."""
    from repro_torch.configs import get_config
    bf = torch.bfloat16
    pre = pretuned.result(timeout=900) if pretuned is not None else {}
    worst, times = 0.0, {}
    for (arch, m), (_, n, h) in _dr_block_shapes(spec).items():
        cfg = get_config(arch)
        bcfg = dataclasses.replace(cfg, d_ff=n)
        x, kw = _mlp_case(bcfg, m, bf, True, "silu", 40 + m)
        if (m, n, h) in pre and pre[m, n, h][0] != kw:
            raise RuntimeError(f"4o: the worker tuned {pre[m, n, h][0]}, "
                               f"the parent {kw}")
        for t in _mlp_sweep_tiles(m, kw, n, h, h):
            got, want, tl, sp = _mlp_run(x, "silu", t, None)
            torch.testing.assert_close(got, want, **TOL[bf])
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            print(f"MLP kernel vs plain [4o rank block, {arch} N = d_ff / "
                  f"{spec['blocks'][arch]}] M={m} N={n} K=H={h} bf16 "
                  f"{t['style']} tiles={tl} splits={sp}"
                  f"{' (the tuner' + chr(39) + 's)' if t == kw else ''}: "
                  f"max|err|={err:.3g} tol={TOL[bf]} ok")
        del x
        label = f"{arch} rank block M={m}"
        times[label] = mlp_time_phase(bcfg, label, m, profile=False)
        times[label]["tuning_s"] = pre[m, n, h][2] if (m, n, h) in pre \
            else None
        _free("cuda")
    return worst, times


# ---------------------------------------------------------------------------
# Phase 4m: the dry run and its roofline, held against the card
# ---------------------------------------------------------------------------

# (a): the records printed, each cell traced in a worker process of its
# own on the meta device (no card), while (b) runs on the card
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
                ("qwen3-8b", "decode_32k"), ("qwen3-8b", "long_500k"),
                ("olmoe-1b-7b", "train_4k"))
# (b): 4g's step (TRAIN) with recomputation off, full and "dots"
REMAT_MODES = {"none": (False, None), "full": (True, None),
               "dots": (True, "dots")}
# recomputation runs the forward's ops again on the same values: the
# loss is the plain step's; each leaf's gradient within 4g's T1 limit
# (atomics in the embedding's backward may add in another order)
REMAT_LOSS_REL_TOL = 1e-6
# the card's op stream against the meta trace: the matmul class's flops
# equal, every op's flops and bytes within 1 %, the step's peak
# (max_memory_allocated over the step, less what was allocated before
# it beside its arguments) within 10 % of the trace's
DRYRUN_COUNT_REL_TOL = 1e-2
DRYRUN_PEAK_REL_TOL = 0.10
# (c): 4l (a)'s step under sequence parallelism; 4l (a)'s peak a rank
# without it, as read on an NVIDIA H100 80GB HBM3 at 700 W (printed
# beside (c)'s when 4l (a) does not run first)
DIST_TRAIN_TP_PEAK_GB = 14.71


def _sp_rules():
    from repro_torch.dist.sharding import Rules
    return Rules(data=("data",), model="model", tp="model", seq="model")


def _counted(fn, *args) -> tuple:
    """(OpCost, output) of ``fn(*args)`` under the op counter, its
    arguments held."""
    from repro_torch.launch.op_cost import OpCost
    c = OpCost()
    with c:
        c.hold(*args)
        out = fn(*args)
    return c, out


def _meta_like(tree):
    from repro_torch import tree as T
    return T.map_tree(lambda t: torch.empty_like(t, device="meta"), tree)


def _start_peak(dev) -> int:
    """The card's peak stats reset; returns what is allocated now."""
    gc.collect()
    if dev != "cuda":
        return 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return base


def _step_peak(c, base: int, dev) -> float:
    """A counted step's peak in bytes: on the card what it allocated at
    most since ``_start_peak``, less what was allocated then beside its
    arguments (``c.held``); on the CPU the counter's own (a rehearsal)."""
    if dev != "cuda":
        return float(c.peak)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base + c.held


def _dt_sp_rank(rank, refdir, spec, dev, world):
    """4m (c) on one rank: this rank's step of 4l (a) under
    ``Rules(seq="model")`` traced first on a dry mesh as this rank
    (meta), then run under the same counter on the card; the reduced
    gradients' blocks against 4l (a)'s one-card step's."""
    from repro_torch import tree as T
    from repro_torch.dist.collectives import DryMesh, shard_dims
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    ma = spec["model_axis"]
    kept = []
    opt = make_optimizer(spec["lr"], 1 + spec["more"])
    tap = _GradTap(opt, lambda gs, lay: kept.append((list(gs), lay)))
    batch = _dist_batch(cfg, spec, dev)
    t0 = time.perf_counter()
    dmesh = DryMesh({"data": world // ma, "model": ma}, rank=rank)
    dmodel = LM(cfg, Runtime(rules=_sp_rules(), mesh=dmesh), device="meta")
    dparams = S.local_specs(dmodel.abstract_params(), dmodel.param_specs(),
                            dmesh)
    pred, _ = _counted(S.make_train_step(dmodel, tap), dparams,
                       opt.abstract_state(dparams), _meta_like(batch))
    trace_s = time.perf_counter() - t0
    kept.clear()
    mesh = make_host_mesh(ma)
    model = LM(cfg, Runtime(rules=_sp_rules(), mesh=mesh), device=dev)
    params = model.init_params(0)
    state = opt.init(params)
    step = S.make_train_step(model, tap)
    base = _start_peak(dev)
    t0 = time.perf_counter()
    got, (_, _, info) = _counted(step, params, state, batch)
    wall = time.perf_counter() - t0
    peak = _step_peak(got, base, dev)
    ref = torch.load(os.path.join(refdir, "train_ref.pt"), mmap=True)
    grads, layouts = kept.pop()
    grad_rel = {k: _grad_distance(g, shard_dims(ref["grads"][k], lay, mesh)
                                  .to(g.device))[0]
                for (k, _), g, lay in zip(T.leaves_with_paths(params), grads,
                                          layouts)}
    return dict(loss=float(info["loss"]), grad_norm=float(info["grad_norm"]),
                grad_rel=grad_rel, records=got.collectives.records,
                pred_records=pred.collectives.records,
                counts=(got.total.flops, got.total.bytes),
                pred_counts=(pred.total.flops, pred.total.bytes),
                peak_gb=peak / 1e9, pred_peak_gb=pred.peak / 1e9,
                held_gb=got.held / 1e9, trace_s=trace_s, wall=wall)


def sp_world_phase(refdir, spec, dev, world, ref, tp_peak_gb=None) -> dict:
    """4m (c): 4l (a)'s step at ``spec``'s depth on its 2 x 2 world
    under sequence parallelism, against 4l (a)'s one-card reference
    ``ref`` (its results in ``refdir``) within 4l (a)'s limits; each
    rank's recorded collectives equal to the dry trace's, by kind, count
    and bytes in order, and its peak within DRYRUN_PEAK_REL_TOL of the
    trace's.  Printed beside 4l (a)'s peak a rank without SP."""
    t0 = time.perf_counter()
    ranks = _spawn(_dt_sp_rank, world, refdir, spec, dev, world, device=dev,
                  timeout_s=900)
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    gnorm_rel = abs(r0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    worst = sorted(((k, v) for r in ranks for k, v in r["grad_rel"].items()),
                   key=lambda kv: -kv[1])
    peak_rel = max(abs(r["peak_gb"] - r["pred_peak_gb"]) / r["pred_peak_gb"]
                   for r in ranks)
    same = [r["records"] == r["pred_records"] for r in ranks]
    kinds = {}
    for kind, nb, _ in r0["records"]:
        c = kinds.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nb
    tp = tp_peak_gb if tp_peak_gb is not None else DIST_TRAIN_TP_PEAK_GB
    print(f"[4m (c)] {spec['arch']} at {_dt_cfg(spec, dev).n_layers} layers "
          f"on a {world // spec['model_axis']} x {spec['model_axis']} world "
          f"under Rules(seq='model'): loss {r0['loss']:.6f} rel "
          f"{loss_rel:.3g} (tol {DIST_TRAIN_LOSS_REL_TOL}), grad_norm rel "
          f"{gnorm_rel:.3g} (tol {DIST_TRAIN_GNORM_REL_TOL}), each rank's "
          f"block of each leaf rel max {worst[0][1]:.3g} (tol "
          f"{DIST_TRAIN_GRAD_REL_TOL}; the worst "
          f"{[(k, float(f'{v:.3g}')) for k, v in worst[:3]]}); rank 0's "
          f"collectives (kind: count, result bytes) {kinds}, equal to the "
          f"dry trace's by kind, count and bytes in order on every rank: "
          f"{same}; the step's peak a rank "
          f"{[round(r['peak_gb'], 3) for r in ranks]} GB against the trace's "
          f"{[round(r['pred_peak_gb'], 3) for r in ranks]} GB (rel max "
          f"{peak_rel:.3g}, tol {DRYRUN_PEAK_REL_TOL}; the arguments "
          f"{r0['held_gb']:.3f} GB), beside 4l (a)'s {tp:.2f} GB a rank "
          f"without SP{'' if tp_peak_gb is not None else ' (an earlier run)'}"
          f"; flops, bytes {r0['counts']} against the trace's "
          f"{r0['pred_counts']}; rank 0 trace {r0['trace_s']:.1f}s, step "
          f"{r0['wall']:.2f}s under the counter through gloo; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    checks = [(loss_rel, DIST_TRAIN_LOSS_REL_TOL, "loss"),
              (gnorm_rel, DIST_TRAIN_GNORM_REL_TOL, "grad_norm"),
              (worst[0][1], DIST_TRAIN_GRAD_REL_TOL, "gradients"),
              (peak_rel, DRYRUN_PEAK_REL_TOL, "peak against the trace")]
    for val, tol, what in checks:
        if val > tol:
            raise RuntimeError(f"[4m (c)] {what}: {val} > {tol}")
    if not all(same):
        raise RuntimeError(f"[4m (c)] a rank's collectives differ from the "
                           f"dry trace's: {same}")
    return dict(loss=r0["loss"], loss_rel=loss_rel, gnorm_rel=gnorm_rel,
                grad_rel=worst[0][1], collectives=kinds,
                peak_gb=[r["peak_gb"] for r in ranks],
                pred_peak_gb=[r["pred_peak_gb"] for r in ranks],
                peak_rel=peak_rel, tp_peak_gb=tp,
                seconds=time.perf_counter() - t0)


def _zero3_rules():
    """The ``zero3`` regime's multi-pod rules (``launch.dryrun``
    ``cell_rules``): every weight gathered whole, no tensor parallelism,
    the batch over the pod and data dims, the sequence over the model
    dim."""
    from repro_torch.launch.dryrun import cell_rules
    return cell_rules("train", True, "zero3")[1]


def _dr_prefill(model, params, cfg, spec, dev) -> list:
    """4o (b): one prompt of ``spec["prompt_len"]`` seeded tokens (a page
    multiple) prefilled into fresh pages under ``model``'s rules, then
    ``spec["steps"]`` decode steps fed the next seeded tokens; every
    logits (the prefill's last real token's first) on the host."""
    from repro_torch.serving import kv_pages as KP
    p, k, ps = spec["prompt_len"], spec["steps"], spec["page_size"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"])
    toks = torch.randint(0, cfg.vocab, (1, p + k), generator=g, device=dev)
    n = math.ceil((p + k) / ps)
    alloc = KP.RequestPages()
    if not alloc.ensure(p + k, KP.PagePool(n + 1, ps)):
        raise RuntimeError("4o (b): the page pool is too small")
    table = torch.from_numpy(KP.table_array([alloc], n)).to(dev)
    cache = model.init_paged_cache(n + 1, ps)
    logits, cache = model.prefill_paged(params, toks[:, :p], cache, table, p)
    out = [logits.float().cpu()]
    for j in range(k):
        logits, cache = model.decode_step_paged(
            params, cache, toks[:, p + j],
            torch.tensor([p + j], dtype=torch.int32, device=dev), table)
        out.append(logits.float().cpu())
    return out


def _dt_zero3_rank(rank, refdir, spec, dev, pods, fault=None):
    """4o (c) on one rank of the (pod, data, model) world: (b') the
    paged prefill of ``DIST_REGIMES["prefill"]`` under the zero3
    multi-pod rules on the initial weights (hand-wired: the blocks keep
    the rank's rows of the prompt), then 4l (a)'s step under the same
    rules, traced first on a dry mesh as this rank (meta), then run
    under the same counter on the card; the reduced gradients' blocks
    against 4l (a)'s one-card step's.  With ``fault`` only (b') runs,
    the fault planted."""
    from repro_torch import tree as T
    from repro_torch.dist.collectives import DryMesh, shard_dims
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dt_cfg(spec, dev)
    ma = spec["model_axis"]
    world = torch.distributed.get_world_size()
    shape = {"pod": pods, "data": world // (pods * ma), "model": ma}
    mesh = make_host_mesh(ma, pods=pods)
    model = LM(cfg, Runtime(rules=_zero3_rules(), mesh=mesh), device=dev)
    params = model.init_params(0)
    ref = torch.load(os.path.join(refdir, "train_ref.pt"), mmap=True)
    t0 = time.perf_counter()
    with _dr_fault(fault), torch.inference_mode():
        pre = _dr_prefill(model, params, cfg,
                          dict(DIST_REGIMES["prefill"], steps=0), dev)
    out = dict(prefill_rel=_rel(pre[0], ref["prefill"][0]),
               prefill_s=time.perf_counter() - t0)
    if fault is not None:
        return out
    kept = []
    opt = make_optimizer(spec["lr"], 1 + spec["more"])
    tap = _GradTap(opt, lambda gs, lay: kept.append((list(gs), lay)))
    batch = _dist_batch(cfg, spec, dev)
    t0 = time.perf_counter()
    dmesh = DryMesh(shape, rank=rank)
    dmodel = LM(cfg, Runtime(rules=_zero3_rules(), mesh=dmesh),
                device="meta")
    dparams = S.local_specs(dmodel.abstract_params(), dmodel.param_specs(),
                            dmesh)
    pred, _ = _counted(S.make_train_step(dmodel, tap), dparams,
                       opt.abstract_state(dparams), _meta_like(batch))
    trace_s = time.perf_counter() - t0
    kept.clear()
    state = opt.init(params)
    step = S.make_train_step(model, tap)
    base = _start_peak(dev)
    t0 = time.perf_counter()
    got, (_, _, info) = _counted(step, params, state, batch)
    wall = time.perf_counter() - t0
    peak = _step_peak(got, base, dev)
    grads, layouts = kept.pop()
    grad_rel = {k: _grad_distance(g, shard_dims(ref["grads"][k], lay, mesh)
                                  .to(g.device))[0]
                for (k, _), g, lay in zip(T.leaves_with_paths(params), grads,
                                          layouts)}
    p, g = pred.total, got.total
    out.update(loss=float(info["loss"]), grad_norm=float(info["grad_norm"]),
               grad_rel=grad_rel, records=got.collectives.records,
               pred_records=pred.collectives.records,
               counts=(g.flops, g.bytes), pred_counts=(p.flops, p.bytes),
               flops_rel=abs(g.flops - p.flops) / p.flops,
               bytes_rel=abs(g.bytes - p.bytes) / p.bytes,
               peak_gb=peak / 1e9, pred_peak_gb=pred.peak / 1e9,
               held_gb=got.held / 1e9, trace_s=trace_s, wall=wall,
               shape=shape)
    return out


def zero3_world_phase(refdir, spec, dev, world, ref, pods=2,
                      faults=()) -> dict:
    """4o (c): 4l (a)'s step at ``spec``'s depth under the zero3
    multi-pod rules on a ``pods`` x 1 x model-axis world (one sequence a
    pod, its 2048 positions over the model dim), against 4l (a)'s
    one-card reference ``ref`` (its results in ``refdir``) within 4l
    (a)'s limits; each rank's flops and bytes within
    DRYRUN_COUNT_REL_TOL of its dry trace's, its recorded collectives
    equal to the trace's, its peak within DRYRUN_PEAK_REL_TOL; and (b')
    the paged prefill under the same rules within E2E_REL_TOL of one
    card's.  With ``faults`` only (b') runs, each fault planted, and
    each must go past E2E_REL_TOL."""
    t0 = time.perf_counter()
    for fault in faults:
        ranks = _spawn(_dt_zero3_rank, world, refdir, spec, dev, pods, fault,
                      device=dev, timeout_s=900)
        got = max(r["prefill_rel"] for r in ranks)
        print(f"[4o (b') planted: {fault}] the zero3 prefill's last logits "
              f"rel {got:.4g} (must exceed {E2E_REL_TOL})", flush=True)
        if not got > E2E_REL_TOL:
            raise RuntimeError(f"[4o (b')] the planted fault {fault!r} "
                               f"passed: {got}")
    if faults:
        return {}
    ranks = _spawn(_dt_zero3_rank, world, refdir, spec, dev, pods,
                  device=dev, timeout_s=900)
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    gnorm_rel = abs(r0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    worst = sorted(((k, v) for r in ranks for k, v in r["grad_rel"].items()),
                   key=lambda kv: -kv[1])
    counts_rel = max(max(r["flops_rel"], r["bytes_rel"]) for r in ranks)
    peak_rel = max(abs(r["peak_gb"] - r["pred_peak_gb"]) / r["pred_peak_gb"]
                   for r in ranks)
    same = [r["records"] == r["pred_records"] for r in ranks]
    pre = max(r["prefill_rel"] for r in ranks)
    kinds = {}
    for kind, nb, _ in r0["records"]:
        c = kinds.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nb
    print(f"[4o (c)] {spec['arch']} at {_dt_cfg(spec, dev).n_layers} layers "
          f"on a {r0['shape']} world under the zero3 multi-pod rules (no "
          f"tensor parallelism, the sequence over the model dim): loss "
          f"{r0['loss']:.6f} rel {loss_rel:.3g} (tol "
          f"{DIST_TRAIN_LOSS_REL_TOL}), grad_norm rel {gnorm_rel:.3g} (tol "
          f"{DIST_TRAIN_GNORM_REL_TOL}), each rank's block of each leaf rel "
          f"max {worst[0][1]:.3g} (tol {DIST_TRAIN_GRAD_REL_TOL}; the worst "
          f"{[(k, float(f'{v:.3g}')) for k, v in worst[:3]]}); flops, bytes "
          f"{r0['counts']} against the dry trace's {r0['pred_counts']} (rel "
          f"max over the ranks {counts_rel:.3g}, tol {DRYRUN_COUNT_REL_TOL});"
          f" rank 0's collectives (kind: count, result bytes) {kinds}, equal"
          f" to the trace's on every rank: {same}; the step's peak a rank "
          f"{[round(r['peak_gb'], 3) for r in ranks]} GB against the "
          f"trace's {[round(r['pred_peak_gb'], 3) for r in ranks]} GB (rel "
          f"max {peak_rel:.3g}, tol {DRYRUN_PEAK_REL_TOL}); (b') the paged "
          f"prefill of {DIST_REGIMES['prefill']['prompt_len']} tokens under "
          f"the same rules: last logits rel max {pre:.3g} (tol "
          f"{E2E_REL_TOL}); rank 0 trace {r0['trace_s']:.1f}s, step "
          f"{r0['wall']:.2f}s under the counter through gloo, prefill "
          f"{r0['prefill_s']:.2f}s; {time.perf_counter() - t0:.1f}s",
          flush=True)
    checks = [(loss_rel, DIST_TRAIN_LOSS_REL_TOL, "loss"),
              (gnorm_rel, DIST_TRAIN_GNORM_REL_TOL, "grad_norm"),
              (worst[0][1], DIST_TRAIN_GRAD_REL_TOL, "gradients"),
              (counts_rel, DRYRUN_COUNT_REL_TOL, "flops and bytes"),
              (peak_rel, DRYRUN_PEAK_REL_TOL, "peak against the trace"),
              (pre, E2E_REL_TOL, "the paged prefill's logits")]
    for val, tol, what in checks:
        if val > tol:
            raise RuntimeError(f"[4o (c)] {what}: {val} > {tol}")
    if not all(same):
        raise RuntimeError(f"[4o (c)] a rank's collectives differ from the "
                           f"dry trace's: {same}")
    return dict(loss=r0["loss"], loss_rel=loss_rel, gnorm_rel=gnorm_rel,
                grad_rel=worst[0][1], counts=r0["counts"],
                pred_counts=r0["pred_counts"], counts_rel=counts_rel,
                collectives=kinds, peak_gb=[r["peak_gb"] for r in ranks],
                pred_peak_gb=[r["pred_peak_gb"] for r in ranks],
                peak_rel=peak_rel, prefill_rel=pre, wall=r0["wall"],
                seconds=time.perf_counter() - t0)


def _dry_cell(arch: str, shape: str) -> dict:
    """One record of the dry run (a worker process's call)."""
    from repro_torch.launch.dryrun import run_cell
    return run_cell(arch, shape, False)


def _sync(dev) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _remat_mode(cfg, batch, mode, want, dev="cuda") -> tuple:
    """4m (b) in one mode: the step traced on meta, then run on ``dev``
    under the same counter; returns (readings, the loss and gradients
    on the host when ``want`` is None)."""
    from repro_torch.core.perf_model import H100
    from repro_torch.launch import analysis, steps as S
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.lm import LM, Runtime
    remat, policy = REMAT_MODES[mode]
    rt = Runtime(remat=remat, remat_policy=policy)
    kept = []
    opt = make_optimizer(TRAIN["lr"], 2)
    tap = _GradTap(opt, lambda gs, _: kept.extend(gs))
    t0 = time.perf_counter()
    mmodel = LM(cfg, rt, device="meta")
    mparams = mmodel.abstract_params()
    pred, _ = _counted(S.make_train_step(mmodel, tap), mparams,
                       opt.abstract_state(mparams), _meta_like(batch))
    trace_s = time.perf_counter() - t0
    kept.clear()
    model = LM(cfg, rt, device=dev)
    params = model.init_params(TRAIN["seed"])
    state = opt.init(params)
    base = _start_peak(dev)
    got, (_, _, info) = _counted(S.make_train_step(model, tap), params,
                                 state, batch)
    peak = _step_peak(got, base, dev)
    loss = float(info["loss"])
    grads = [g.detach() for g in kept]
    kept.clear()
    if want is None:
        want = (loss, [g.cpu() for g in grads])
    rels = [_grad_distance(g, w.to(dev))[0] for g, w in zip(grads, want[1])]
    del grads
    step = S.make_train_step(model, opt)
    _sync(dev)
    t0 = time.perf_counter()
    step(params, state, batch)
    _sync(dev)
    wall = time.perf_counter() - t0
    del model, params, state, step
    _free(dev)
    terms = analysis.roofline_terms(pred.total, pred.collectives, hw=H100)
    floor = max(terms.compute_s, terms.memory_s)
    p, g = pred.total, got.total
    r = dict(loss=loss, loss_rel=abs(loss - want[0]) / abs(want[0]),
             grad_rel=max(rels), mm_flops=(g.mm_flops, p.mm_flops),
             flops_rel=abs(g.flops - p.flops) / p.flops,
             bytes_rel=abs(g.bytes - p.bytes) / p.bytes,
             flops=g.flops, bytes=g.bytes, n_ops=(got.n_ops, pred.n_ops),
             peak_gb=peak / 1e9, pred_peak_gb=pred.peak / 1e9,
             peak_rel=abs(peak - pred.peak) / pred.peak,
             compute_s=terms.compute_s, memory_s=terms.memory_s,
             floor_s=floor, wall_s=wall, wall_over_floor=wall / floor,
             trace_s=trace_s)
    print(f"[4m (b) {mode}] {cfg.name} {cfg.n_layers} layers B="
          f"{TRAIN['batch']} S={TRAIN['seq']}: loss {loss:.6f} rel "
          f"{r['loss_rel']:.3g} (tol {REMAT_LOSS_REL_TOL}), each leaf's "
          f"gradient against remat none rel max {r['grad_rel']:.3g} (tol "
          f"{TRAIN_GRAD_REL_TOL}); the card's op stream against the meta "
          f"trace: ops {r['n_ops']}, matmul flops {g.mm_flops:.6g} / "
          f"{p.mm_flops:.6g} (equal), flops rel {r['flops_rel']:.3g}, bytes "
          f"rel {r['bytes_rel']:.3g} (tol {DRYRUN_COUNT_REL_TOL}); the "
          f"step's peak {r['peak_gb']:.3f} GB against {r['pred_peak_gb']:.3f}"
          f" GB (rel {r['peak_rel']:.3g}, tol {DRYRUN_PEAK_REL_TOL}); "
          f"roofline under H100: compute {terms.compute_s * 1e3:.2f} ms, "
          f"memory {terms.memory_s * 1e3:.2f} ms, floor {floor * 1e3:.2f} ms"
          f" against the step's wall {wall * 1e3:.2f} ms (uncounted), wall "
          f"/ floor {r['wall_over_floor']:.2f}; trace {trace_s:.1f}s",
          flush=True)
    checks = [(r["flops_rel"], DRYRUN_COUNT_REL_TOL, "flops"),
              (r["bytes_rel"], DRYRUN_COUNT_REL_TOL, "bytes"),
              (r["peak_rel"], DRYRUN_PEAK_REL_TOL, "peak against the trace"),
              (r["loss_rel"], REMAT_LOSS_REL_TOL, "loss against none"),
              (r["grad_rel"], TRAIN_GRAD_REL_TOL, "gradients against none")]
    for val, tol, what in checks:
        if val > tol:
            raise RuntimeError(f"[4m (b) {mode}] {what}: {val} > {tol}")
    if g.mm_flops != p.mm_flops:
        raise RuntimeError(f"[4m (b) {mode}] matmul flops {g.mm_flops} on "
                           f"the card, {p.mm_flops} traced")
    if not floor <= wall:
        raise RuntimeError(f"[4m (b) {mode}] the roofline floor {floor} s "
                           f"is above the measured wall {wall} s")
    return r, want


def _print_dry_record(arch: str, shape: str, rec: dict) -> None:
    if "skipped" in rec:
        print(f"[4m (a)] {arch} {shape}: skipped ({rec['skipped']})")
        return
    r = rec["roofline"]
    print(f"[4m (a)] {arch} {shape} on {rec['mesh']} ({rec['regime']}, "
          f"remat {rec['remat']}; priced under H100, not measured): compute "
          f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, collective "
          f"{r['collective_s']:.4g} s, dominant {r['dominant']}; peak a rank "
          f"{rec['memory']['peak_per_device_gb']} GiB; useful_ratio "
          f"{r['useful_ratio']:.3f}; trace {rec['trace_s']}s", flush=True)


def dryrun_phase(card: str, sp=None) -> dict:
    """4m: (a) the dry-run records of DRYRUN_CELLS, traced in worker
    processes while (b) runs on the card: 4g's step in each of
    REMAT_MODES traced on meta, then run on the card under the same
    counter; (c) ``sp``, 4l's world under sequence parallelism (run
    here, with 4l (a)'s reference, when not given)."""
    import multiprocessing
    t_all = time.perf_counter()
    if sp is None:
        spec = DIST_TRAIN["train"]
        tmp = tempfile.mkdtemp(prefix="dryrun-sp-")
        try:
            ref = _spawn(_dt_ref_rank, 1, tmp, spec, "cuda", device="cuda",
                        timeout_s=900)[0]
            sp = sp_world_phase(tmp, spec, "cuda", DIST_TRAIN["world"], ref)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    pool = concurrent.futures.ProcessPoolExecutor(
        len(DRYRUN_CELLS), mp_context=multiprocessing.get_context("spawn"))
    try:
        futs = {cell: pool.submit(_dry_cell, *cell) for cell in DRYRUN_CELLS}
        cfg = _train_cfg()
        batch = _train_batch(cfg)
        remat, want = {}, None
        for mode in REMAT_MODES:
            remat[mode], want = _remat_mode(cfg, batch, mode, want)
        del want
        records = {}
        for (arch, shape), f in futs.items():
            rec = f.result(timeout=900)
            _print_dry_record(arch, shape, rec)
            records[f"{arch} {shape}"] = rec if "skipped" in rec else {
                "roofline": {k: rec["roofline"][k] for k in (
                    "compute_s", "memory_s", "collective_s", "dominant",
                    "useful_ratio")},
                "peak_per_device_gb": rec["memory"]["peak_per_device_gb"],
                "regime": rec["regime"], "trace_s": rec["trace_s"]}
    finally:
        pool.shutdown(cancel_futures=True)
    out = dict(card=card, records=records, remat=remat, sp=sp,
               seconds=time.perf_counter() - t_all)
    print(f"[4m] {out['seconds']:.1f}s", flush=True)
    return out



# ---------------------------------------------------------------------------
# 4p: the planned cache-free forward
# ---------------------------------------------------------------------------

def _loss_tol(labels: torch.Tensor) -> float:
    """The planned kernel path's loss limit against the hand-wired
    kernel path, over the labelled tokens of ``labels``: LOSS_REL_TOL,
    the limit of the forward's 4094 per-token terms, scaled by the
    square root of 4094 over their count, as the relative rounding
    noise of a mean of n terms falls with the square root of n (2 x 256
    tokens: 510 terms, 2.83e-4).  Only this comparison takes it: the
    plan's stitched f32 glue moves the mean by itself, which the
    witness beside it reads (the planned plain path against the
    hand-wired plain path); the planned plain path and the mesh are
    held to LOSS_REL_TOL."""
    n = int((labels != -100).sum())
    return LOSS_REL_TOL * math.sqrt(max(4094 / n, 1.0))


# The planned forward (``Runtime(planner=True, kernel_ops=True)``) of
# qwen3-8b FULL at two shapes: B x S -> (the MLP kernel's launches a
# call: the H100 plan fuses the MLP at 2 x 256 = 512 rows and keeps it
# three GEMMs at 2 x 2048); a world of 4 ranks over a 1 x 4 mesh at
# ``mesh_layers`` of 36 layers (2 x 256, the serving rules); the
# examples' arguments on the card
PLANNED = dict(shapes={"2x2048": (2, 2048), "2x256": (2, 256)},
               fused_mlp={"2x2048": False, "2x256": True},
               mesh=dict(world=4, layers=4, batch=2, seq=256, seed=2),
               serve_batched=(["--gen", "8"],
                              ["--arch", "qwen3-8b", "--continuous"]))


def _planned_calls(model, params, batch, names, dev) -> tuple:
    """(loss, logits, launches by call) of ``model``'s loss and forward
    on ``batch``, each call's counters set to 0 just before and read
    just after."""
    launches = {}
    with torch.inference_mode():
        _zero(*names)
        loss = model.loss(params, batch)
        launches["loss"] = _read(*names)
        _zero(*names)
        logits = model.forward(params, batch["tokens"],
                               batch.get("prefix_embeds"))
        launches["forward"] = _read(*names)
    if dev == "cuda":
        torch.cuda.synchronize()
    return loss, logits, launches


def planned_phase(cfg, params, spec=PLANNED, dev="cuda") -> dict:
    """Phase 4p on one card: the planned loss and forward of ``cfg`` at
    each of ``spec["shapes"]`` — their plans printed, the attention
    kernel launched once a layer and call, the MLP kernel once a layer
    and call where the plan fuses the MLP and never where it does not,
    nothing degraded — each held within FORWARD_REL_TOL (logits) of the
    hand-wired kernel path and of the planned plain path (the model's
    twins), its loss within ``_loss_tol`` of the first and LOSS_REL_TOL
    of the second; beside each, that path against the hand-wired plain
    path (the witness: what the plan's glue alone, and the kernels
    alone, move); then the planned and the hand-wired forward's walls
    and a profile of the planned one."""
    from repro_torch.core import planner
    from repro_torch.models.lm import LM, Runtime
    planned = LM(cfg, Runtime(kernel_ops=True, planner=True), device=dev)
    refs = {"hand-wired kernel path": LM(cfg, Runtime(kernel_ops=True),
                                         device=dev),
            "planned plain path": LM(cfg, Runtime(planner=True),
                                     device=dev)}
    witness = LM(cfg, Runtime(), device=dev)    # the hand-wired plain path
    names = _path_counters()
    n_attn = planned.kinds.count("attn")
    out = {}
    for label, (b, s) in spec["shapes"].items():
        plan = planner.plan_model(cfg, b, s)
        fused = any(c.kind == "mlp" and c.fused for c in plan.layer.chains)
        print(f"[4p {label}] {cfg.name} plan: " + "; ".join(
            f"{c.kind}{' fused' if c.fused else ''}"
            f"{' <' + ','.join(c.prologue) if c.prologue else ''}"
            f"{' >' + ','.join(c.epilogue) if c.epilogue else ''}"
            for c in plan.layer.chains))
        if fused != spec["fused_mlp"][label]:
            raise RuntimeError(f"[4p {label}] the plan fuses the MLP: "
                               f"{fused}, want {spec['fused_mlp'][label]}")
        batch = (_forward_batch(cfg, b, s) if dev == "cuda"
                 else _dist_batch(cfg, dict(batch=b, seq=s, seed=2), dev))
        t0 = time.perf_counter()
        loss, logits, launches = _planned_calls(planned, params, batch,
                                                names, dev)
        first_s = time.perf_counter() - t0
        want = {"fused_attention": n_attn,
                "fused_mlp_chain": n_attn if fused else 0}
        got = {call: {k: v for k, v in c.items() if v}
               for call, c in launches.items()}
        print(f"[4p {label}] planned loss {float(loss):.5f}, forward "
              f"{tuple(logits.shape)} in {first_s:.2f}s (first calls, the "
              f"tuning included); launches {got} (want {want} each)")
        if dev == "cuda" and any(c != {k: v for k, v in want.items() if v}
                                 for c in got.values()):
            raise RuntimeError(f"[4p {label}] launches {got}, want {want}")
        if logits.shape != (b, s, cfg.vocab) or not (
                torch.isfinite(logits).all() and torch.isfinite(loss)):
            raise RuntimeError(f"[4p {label}] non-finite or misshapen "
                               f"output")
        res = dict(launches=got, plan_fuses_mlp=fused, first_s=first_s)
        with torch.inference_mode():
            base_loss = witness.loss(params, batch)
            base_logits = witness.forward(params, batch["tokens"])
        loss_tols = {"hand-wired kernel path": _loss_tol(batch["labels"]),
                     "planned plain path": LOSS_REL_TOL}
        for ref_label, model in refs.items():
            with torch.inference_mode():
                want_loss = model.loss(params, batch)
                want_logits = model.forward(params, batch["tokens"])
            loss_tol = loss_tols[ref_label]
            div = _divergence(loss, logits, want_loss, want_logits,
                              loss_tol)
            wit = _divergence(want_loss, want_logits, base_loss,
                              base_logits)
            del want_logits, wit["within"]
            print(f"[4p {label}] planned kernel path vs the {ref_label}: "
                  f"loss rel {div['loss_rel']:.3g} (tol {loss_tol:.3g}), "
                  f"logits rel {div['logits_rel']:.3g} (tol "
                  f"{FORWARD_REL_TOL}), argmax agree "
                  f"{div['argmax_agree']:.4f}; witness, the {ref_label} "
                  f"vs the hand-wired plain path: loss rel "
                  f"{wit['loss_rel']:.3g}, logits rel "
                  f"{wit['logits_rel']:.3g}")
            if not div["within"]:
                raise RuntimeError(f"[4p {label}] the planned forward "
                                   f"diverges from the {ref_label}")
            res[ref_label] = div
            res[f"{ref_label} vs the hand-wired plain path"] = wit
        del logits, base_logits
        _no_degradation(f"4p {label}")
        if dev == "cuda":
            tokens = batch["tokens"]
            with torch.inference_mode():
                res["planned_forward_ms"] = _span_ms(
                    lambda: planned.forward(params, tokens), reps=3)
                res["hand_wired_forward_ms"] = _span_ms(
                    lambda: refs["hand-wired kernel path"].forward(
                        params, tokens), reps=3)
                res["profile"] = profile_phase(
                    lambda: planned.forward(params, tokens),
                    f"4p planned forward {label}",
                    f"planned forward (B={b}, S={s}, {cfg.n_layers} "
                    f"layers)", timed=2, traced=1)
            print(f"[4p {label}] forward device span: planned "
                  f"{res['planned_forward_ms']:.2f} ms, hand-wired "
                  f"{res['hand_wired_forward_ms']:.2f} ms")
        out[label] = res
    return out


def _planned_cfg(spec, dev):
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-8b", smoke=dev != "cuda")
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                 spec["layers"]))


def _planned_rank(rank, refdir, spec, dev):
    """One rank of 4p's world: the planned loss and forward on the
    rank's shards (the serving rules, seed 0 as one card's weights)
    against one card's planned kernel path; returns its launches by
    call, its relative errors, the attention regime the tuner picks and
    its denylist records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import report_attention_regimes
    from repro_torch.models.lm import LM, Runtime
    mesh = make_host_mesh(spec["world"])
    rules = Rules(data=("data",), model="model", tp="model", fsdp=False)
    cfg = _planned_cfg(spec, dev)
    regime = report_attention_regimes(
        cfg, mesh, rules, batch=spec["batch"], prompt_len=spec["seq"],
        total_len=spec["seq"], verbose=rank == 0)["prefill"]
    model = LM(cfg, Runtime(kernel_ops=True, planner=True, rules=rules,
                            mesh=mesh), device=dev)
    params = model.init_params(0)
    batch = _dist_batch(cfg, spec, dev)
    t0 = time.perf_counter()
    loss, logits, launches = _planned_calls(model, params, batch,
                                            _path_counters(), dev)
    wall = time.perf_counter() - t0
    refs = torch.load(os.path.join(refdir, "planned.pt"))
    loss_rel = abs(float(loss) - refs["loss"]) / abs(refs["loss"])
    return dict(launches={c: {k: v for k, v in n.items() if v}
                          for c, n in launches.items()},
                loss_rel=loss_rel,
                logits_rel=_rel(logits.float().cpu(), refs["logits"]),
                regime=regime, wall_s=wall, deny=len(_deny_records()))


def planned_mesh_phase(spec=PLANNED["mesh"], dev="cuda") -> dict:
    """4p under a mesh: one card's planned kernel path at
    ``spec["layers"]`` layers first (its loss and logits saved, its
    weights freed), then ``spec["world"]`` spawned ranks (gloo, every
    rank on the card) over a 1 x world mesh: on every rank the MLP
    kernel launched once a layer and call on the rank's block (the plan
    fuses the MLP at 2 x 256), the attention kernel at least once a
    layer, the loss within LOSS_REL_TOL and the logits within
    FORWARD_REL_TOL of one card's, nothing degraded, every rank
    launching alike."""
    from repro_torch.models.lm import LM, Runtime
    cfg = _planned_cfg(spec, dev)
    refdir = tempfile.mkdtemp(prefix="planned-refs-")
    try:
        model = LM(cfg, Runtime(kernel_ops=True, planner=True), device=dev)
        params = model.init_params(0)
        batch = _dist_batch(cfg, spec, dev)
        loss_tol = LOSS_REL_TOL
        loss, logits, _ = _planned_calls(model, params, batch,
                                         _path_counters(), dev)
        torch.save({"loss": float(loss), "logits": logits.float().cpu()},
                   os.path.join(refdir, "planned.pt"))
        del model, params, logits, batch
        _free(dev)
        t0 = time.perf_counter()
        outs = _spawn(_planned_rank, spec["world"], refdir, spec, dev,
                     device=dev, timeout_s=600)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    first = outs[0]
    print(f"[4p mesh] {spec['world']} ranks, {cfg.name} at {cfg.n_layers} "
          f"layers, B={spec['batch']} x S={spec['seq']}, attention regime "
          f"{first['regime']}: launches a rank {first['launches']}; "
          f"loss rel {max(o['loss_rel'] for o in outs):.3g} (tol "
          f"{loss_tol:.3g}), logits rel "
          f"{max(o['logits_rel'] for o in outs):.3g} (tol "
          f"{FORWARD_REL_TOL}); {wall:.1f}s")
    for r, o in enumerate(outs):
        if o["launches"] != first["launches"] or o["deny"]:
            raise RuntimeError(f"[4p mesh] rank {r} launched "
                               f"{o['launches']} ({o['deny']} denylist "
                               f"records), rank 0 {first['launches']}")
        if o["loss_rel"] > loss_tol or o["logits_rel"] > FORWARD_REL_TOL:
            raise RuntimeError(f"[4p mesh] rank {r} diverges: {o}")
    if dev == "cuda":
        for call, c in first["launches"].items():
            if (c.get("fused_mlp_chain") != cfg.n_layers
                    or c.get("fused_attention", 0)
                    + c.get("fused_attention_partial", 0) < cfg.n_layers):
                raise RuntimeError(f"[4p mesh] {call} launched {c}")
    return dict(world=spec["world"], layers=cfg.n_layers,
                regime=first["regime"], launches=first["launches"],
                loss_rel=max(o["loss_rel"] for o in outs),
                logits_rel=max(o["logits_rel"] for o in outs),
                wall_s=first["wall_s"], seconds=wall)


def _planned_rank_attention(cfg, spec=PLANNED):
    """The attention kernel of a rank of 4p's 1 x world mesh (the
    serving rules): (the tuned kernel ``kernels.ops.attention_shard``
    runs on the rank's block, its regime, the block's shape (B, Hq, Hkv,
    S, D))."""
    from repro_torch.core import api
    from repro_torch.core.perf_model import H100
    from repro_torch.dist.sharding import Rules, dispatch_mesh_spec
    from repro_torch.kernels import ops
    w, b, s = (spec["mesh"][k] for k in ("world", "batch", "seq"))
    d = cfg.dh
    mesh = _MeshShape(data=1, model=w)
    rules = Rules(data=("data",), model="model", tp="model", fsdp=False)
    hq, hkv, dt = cfg.n_heads, cfg.n_kv_heads, torch.bfloat16
    spatial = dispatch_mesh_spec(rules, mesh, kind="attention", batch=b,
                                 feature_dims=(hkv, hq), ici_bw=H100.ici_bw)
    choice, _ = ops.attention_regime_choice(
        rules, mesh, batch=b, q_heads=hq, kv_heads=hkv, q_len=s, kv_len=s,
        head_dim=d, dtype=_dtname(dt), causal=True, window=0,
        scale=d ** -0.5, spatial=spatial)
    regime = choice.regime if choice is not None else "spatial"
    if regime != "spatial":
        raise RuntimeError(f"[4p] the rank's attention regime is {regime}")
    tk = choice.kernel if choice is not None else api.fuse_attention(
        s, s, d, d, heads=hq, batch=b, dtype=_dtname(dt), causal=True,
        scale=d ** -0.5, mesh=spatial[0] if any(spatial[1:]) else None)
    return tk, regime, (b, hq // w, hkv // w, s, d)


def planned_kernel_phase(cfg, spec=PLANNED) -> dict:
    """Phase 3 at 4p's new shapes, each against its plain version within
    bf16 TOL: the MLP kernel at M = 2 x 256 = 512 rows, at full width
    and at the N = d_ff / world block of a rank of the 1 x world mesh
    (the tuner's tiles and split for each); the normalised attention at
    qwen3-8b's 2 x 256 forward and at the rank's block (its q and kv
    heads, the tiles of the rank's regime search).  Returns the largest
    absolute error of each kernel."""
    (b, s), bf = spec["shapes"]["2x256"], torch.bfloat16
    w = spec["mesh"]["world"]
    err = dict(fused_mlp_chain=0.0)
    for label, n in (("", cfg.d_ff), (f", a rank's block (d_ff / {w})",
                                      cfg.d_ff // w)):
        x, kw = _mlp_case(dataclasses.replace(cfg, d_ff=n), b * s, bf, True,
                          "silu", 40)
        got, want, tiles, splits = _mlp_run(x, "silu", kw, None)
        torch.testing.assert_close(got, want, **TOL[bf])
        e = float((got.float() - want.float()).abs().max())
        err["fused_mlp_chain"] = max(err["fused_mlp_chain"], e)
        print(f"MLP kernel vs plain [4p M={b * s}{label}] N={n} K=H="
              f"{cfg.d_model} bf16 {kw['style']} tiles={tiles} "
              f"splits={splits}: max|err|={e:.3g} tol={TOL[bf]} ok")
        del x, got, want
    tk, regime, (rb, rh, rg, rs, d) = _planned_rank_attention(cfg, spec)
    err["fused_attention"] = _attention_cases(
        [("4p forward 2x256", b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.dh,
          bf, True, 0, None),
         (f"4p forward 2x256, a rank's block ({regime})", rb, rh, rg, rs,
          rs, d, bf, True, 0, (tk.params.bq, tk.params.bkv))], 41)
    return err


def planned_time_phase(cfg, spec=PLANNED) -> dict:
    """Kernel times at 4p's new shapes: the MLP kernel at M = 512 beside
    its plain version, the unfused ``mlp_block`` and its bound, at full
    width and at a rank's N = d_ff / world block; the normalised
    attention at 2 x 256 beside its plain version, SDPA and its bound,
    and at the rank's block (the tiles of its regime search)."""
    from repro_torch.kernels import attention as A
    b, s = spec["shapes"]["2x256"]
    w = spec["mesh"]["world"]
    out = {"fused_mlp_chain": mlp_time_phase(cfg, "4p m512", b * s,
                                             profile=False),
           "fused_attention": attention_time_phase(
               cfg, table_iii=False, b=b, m=s, other=())}
    out["fused_mlp_chain"]["rank_block"] = mlp_time_phase(
        dataclasses.replace(cfg, d_ff=cfg.d_ff // w),
        f"4p m512 rank block N={cfg.d_ff // w}", b * s, profile=False)
    tk, regime, (rb, rh, rg, rs, d) = _planned_rank_attention(cfg, spec)
    dt, scale = torch.bfloat16, d ** -0.5
    q, k, v = _randn([(rb, rh, rs, d), (rb, rg, rs, d), (rb, rg, rs, d)],
                     dt, 307)
    with torch.inference_mode():
        out["fused_attention"]["rank_block"] = dict(
            shape=[rb, rh, rg, rs, rs, d], regime=regime,
            tiles=[tk.params.bq, tk.params.bkv],
            kernel_ms=_adaptive_ms(lambda: tk(q, k, v)),
            plain_ms=_adaptive_ms(lambda: A.fused_attention_plain(
                q, k, v, tk.params.bkv, True, 0, scale), reps=1),
            library_ms=_adaptive_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True)),
            **_bound(_nbytes(q, k, v) + q.numel() * q.element_size(),
                     _attention_ops(rb, rh, rs, rs, d, d, True), dt))
    for name, t in out.items():
        print(f"[4p times] {name} at a rank's block: "
              + json.dumps(t["rank_block"]))
    return out


def examples_phase(spec=PLANNED) -> dict:
    """The three example drivers, each run once on the card with its
    defaults (``serve_batched`` also with ``--continuous``), the kernel
    counters set to 0 just before each and read after; nothing may
    degrade.  ``train_lm`` asserts its loss falls."""
    from repro_torch.launch import fuse_custom_chain, serve_batched, train_lm
    runs = {"fuse_custom_chain": (fuse_custom_chain.main, [])}
    for argv in spec["serve_batched"]:
        runs["serve_batched " + " ".join(argv)] = (serve_batched.main, argv)
    ckdir = tempfile.mkdtemp(prefix="train-lm-")
    runs["train_lm"] = (train_lm.main, ["--ckpt-dir", ckdir])
    names = _path_counters()
    out = {}
    try:
        for label, (main, argv) in runs.items():
            _zero(*names)
            t0 = time.perf_counter()
            res = main(argv)
            torch.cuda.synchronize()
            out[label] = dict(seconds=time.perf_counter() - t0,
                              launches={k: v for k, v in _read(*names).items()
                                        if v})
            if label == "train_lm":
                out[label].update(first_loss=res["first_loss"],
                                  final_loss=res["final_loss"])
            elif label.startswith("serve_batched"):
                out[label].update(counts=res["counts"])
            print(f"[4p examples] {label}: {out[label]}")
            _no_degradation(f"4p example {label}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return out

def codeqwen_phase() -> dict:
    """codeqwen1.5-7b at every FULL width and depth (32 layers, 32 q
    heads on 32 kv heads: the partial kernel at a GQA group of 1),
    served captured and eager (equal tokens, partial launches = decode
    steps x 32, nothing degraded), then ``generate`` against its
    forward; its weights freed after."""
    from repro_torch.configs import get_config
    cfg = get_config(CODEQWEN)
    params = init_phase(cfg)
    engine, stats, launches, eager_engine, eager_stats = serve_phase(
        cfg, params, planned=False)
    profile = step_profile_phase(engine, CODEQWEN)
    del engine, eager_engine
    gen = generate_phase(cfg, params)
    _no_degradation(f"{CODEQWEN} generate")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, decode_steps=stats["decode_steps"],
                tok_per_s=stats["tok_per_s"],
                eager_tok_per_s=eager_stats["tok_per_s"], step=profile,
                generate=gen)


# ---------------------------------------------------------------------------
# 4q: the kernels' stitching hooks and the tuner's measured trials
# ---------------------------------------------------------------------------

# The hooks 4q (a) holds each kernel to its plain version with: the MLP
# a tanh prologue and a non-linear epilogue across its n splits; the
# GEMM chains those of tests/test_planner.py::test_gemm_chain_hooks_
# interpret (jnp.tanh, x * 0.5); the attention q * 2, tanh(k), o + 1
HOOKS = dict(mlp=(("tanh",), (("mul", 0.5), "tanh")),
             chain=(("tanh",), (("mul", 0.5),)),
             attention=((("mul", 2.0),), ("tanh",), (("add", 1.0),)))
# The MLP inputs of 4q (a): A at twice a unit normal's scale and the
# weights at twice the model's, so that E is of order 1 to 10 and
# tanh(0.5 E) is far from linear; the epilogue of each of M=4's 128
# split's partial E, summed (the planted fault), then lands past bf16
# TOL
HOOK_MLP_SCALE = 2.0
# 4q (b): the measured trials' cases, (kind, label, the front door's
# arguments): the MLP at qwen3-8b's rank block of 4o (N = d_ff / 4) at
# M = 4 and 512 and at the planned forward's M = 512, the attention at
# qwen3-8b's forward (B=2, S=2048, GQA 32 / 8) — where the analytic
# picks missed tiles a sweep found (PERF.md §6)
MEASURED = (("mlp", "qwen3-8b rank block N=3072 M=4", (4, 3072, 4096)),
            ("mlp", "qwen3-8b rank block N=3072 M=512", (512, 3072, 4096)),
            ("mlp", "qwen3-8b planned forward M=512", (512, 12288, 4096)),
            ("attn", "qwen3-8b forward B=2 S=2048", (2048, 2048, 128, 128)))
# the wall clock's device time budget a candidate (ms)
MEASURE_BUDGET_MS = 30.0


def _elementwise(steps):
    from repro_torch.kernels.hooks import Elementwise
    return Elementwise.of(*steps)


def _host_ms(fn, **_) -> float:
    """Host milliseconds of one ``fn()`` (CPU rehearsals only: never a
    device time)."""
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def _hooked_case(label, run, plain, dt, unhooked, wrapper, keys) -> dict:
    """One hooked kernel case of 4q (a): ``run()`` (one hooked launch,
    the wrapper's counters set to 0 just before and read after: one
    launch, counted under the hooks' ``keys``) against ``plain()``
    within TOL[dt]; then the hooked and the unhooked (``unhooked()``)
    launch timed in turns (on a CPU rehearsal, where the wrapper runs
    the plain version and counts nothing, by the host's clock)."""
    wrapper.launches, wrapper.hooked = 0, {}
    with torch.inference_mode():
        got = run()
        _sync(got.device.type)
        counted = (wrapper.launches, dict(wrapper.hooked))
        want = plain()
    if got.is_cuda and counted != (1, {keys: 1}):
        raise RuntimeError(f"[4q {label}] counted {counted}, want one "
                           f"launch under {keys}")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"[4q {label}] bad output {tuple(got.shape)}")
    torch.testing.assert_close(got, want, **TOL[dt])
    err = float((got.float() - want.float()).abs().max())
    timer = _adaptive_ms if got.is_cuda else _host_ms
    with torch.inference_mode():
        t = [timer(f) for f in (unhooked, run, run, unhooked)]
        plain_ms = timer(plain, reps=1)
    out = dict(max_abs_err=err, hooked_ms=min(t[1], t[2]),
               ms=min(t[0], t[3]), plain_ms=plain_ms,
               hooks=[list(k) if k else None for k in keys])
    print(f"[4q hooks] {label} {_dtname(dt)}: max|err|={err:.3g} "
          f"tol={TOL[dt]} ok; hooked {t[1]:.4f} / {t[2]:.4f} ms, unhooked "
          f"{t[0]:.4f} / {t[3]:.4f} ms, the hooked plain version "
          f"{plain_ms:.4f} ms")
    return out


def _hook_mlp_inputs(cfg, m, seed, dev):
    """(a, wu, wd, wg) in bf16 at HOOK_MLP_SCALE."""
    x = _seeded([(1, m, cfg.d_model), (1, cfg.d_model, cfg.d_ff),
                 (1, cfg.d_ff, cfg.d_model), (1, cfg.d_model, cfg.d_ff)],
                torch.float32, seed, dev)
    return [(t * HOOK_MLP_SCALE).to(torch.bfloat16) for t in x]


def _per_split_epilogue(x, kw, pro, epi) -> torch.Tensor:
    """The planted fault: the MLP kernel launched on each split's n range
    alone (one split each, with the prologue and the epilogue), the
    results summed in f32 — the epilogue of each partial instead of the
    epilogue of their sum (on a CPU rehearsal, the plain version)."""
    from repro_torch.kernels import gemm_chain as G
    a, wu, wd, wg = x
    (bm, bn, bk, be), (splits, per) = G._check(a, wu, wd, wg, "silu", **kw)
    n, step, total = wu.shape[2], per * bn, None
    for n0 in range(0, n, step):
        xs = (a, wu[:, :, n0:n0 + step].contiguous(),
              wd[:, n0:n0 + step].contiguous(),
              wg[:, :, n0:n0 + step].contiguous(), "silu")
        part = (G._launch(*xs, bm, bn, bk, be, 1, pro, epi) if a.is_cuda
                else G.fused_mlp_chain_plain(*xs, bn, 1, pro, epi)).float()
        total = part if total is None else total + part
    return total.to(a.dtype)


def hook_check_phase(cfg, dev="cuda") -> dict:
    """4q (a): every hooked kernel against its plain version with the
    same hooks (TOL), at the shapes the kernel table times: the MLP
    kernel at qwen3-8b's decode (M=4, the tuner's split), prefill
    (M=144) and the planned forward's M=512 with ``HOOKS["mlp"]``, a
    non-linear epilogue across the splits; the GEMM chain at G12 bf16
    and G1 f32 and the three-GEMM chain in bf16 with ``HOOKS["chain"]``;
    the attention at qwen3-8b's forward and at Table III S2 f32 with
    ``HOOKS["attention"]``.  Each hooked launch is counted once under
    its hooks' keys and timed beside the unhooked one.  Then the planted
    fault, the epilogue of each of M=4's splits summed, must go past
    TOL.  Returns {kernel: {case: readings}}."""
    from repro_torch.core import api
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import gemm_chain as G
    from repro_torch.kernels import gemm_chain3 as G3
    bf, f32 = torch.bfloat16, torch.float32
    pro, epi = (_elementwise(s) for s in HOOKS["mlp"])
    out = {"fused_mlp_chain": {}, "fused_gemm_chain": {},
           "fused_gemm_chain3": {}, "fused_attention": {}}
    planted = None
    for label, m in (("decode M=4", MLP_SHAPES["decode"]),
                     ("prefill M=144", MLP_SHAPES["prefill"]),
                     ("planned forward M=512", 512)):
        a, wu, wd, wg = _hook_mlp_inputs(cfg, m, 60 + m, dev)
        kw = api.fuse_mlp_chain(m, cfg.d_ff, cfg.d_model,
                                dtype="bfloat16").params.as_kwargs()
        tiles, (splits, _) = G._check(a, wu, wd, wg, "silu", **kw)
        case = _hooked_case(
            f"MLP {label} {kw['style']} tiles={tiles} splits={splits}",
            lambda: G.fused_mlp_chain(a, wu, wd, wg=wg, prologue=pro,
                                      epilogue=epi, **kw),
            lambda: G.fused_mlp_chain_plain(a, wu, wd, wg, "silu", tiles[1],
                                            splits, pro, epi),
            bf, lambda: G.fused_mlp_chain(a, wu, wd, wg=wg, **kw),
            G.fused_mlp_chain, (pro.key(), epi.key()))
        out["fused_mlp_chain"][label] = dict(case, tiles=kw, splits=splits)
        if m == MLP_SHAPES["decode"]:
            with torch.inference_mode():
                bad = _per_split_epilogue((a, wu, wd, wg), kw, pro, epi)
                want = G.fused_mlp_chain_plain(a, wu, wd, wg, "silu",
                                               tiles[1], splits, pro, epi)
            planted = _tol_ratio(bad, want)
            print(f"[4q hooks] planted fault: the epilogue of each of "
                  f"{splits} splits, summed: {planted:.3g} x bf16 TOL "
                  f"(must exceed 1)")
            if splits < 4 or planted <= 1.0:
                raise RuntimeError("[4q] the per-split epilogue went "
                                   "unnoticed")
        del a, wu, wd, wg
    cpro, cepi = (_elementwise(s) for s in HOOKS["chain"])
    for name, dt in (("G12", bf), ("G1", f32)):
        b, m, n, k, h = CHAINS[name]
        kw = api.fuse_gemm_chain(m, n, k, h, batch=b,
                                 dtype=_dtname(dt)).params.as_kwargs()
        a, bb, d = _seeded([(b, m, k), (b, k, n), (b, n, h)], dt, 61, dev)
        tiles, (splits, _), _ = G.check_gemm_chain(
            a, bb, d, kw["bm"], kw["bn"], kw["bk"], kw["bh"], kw["style"])
        out["fused_gemm_chain"][f"{name} {_dtname(dt)}"] = dict(
            _hooked_case(
                f"GEMM chain {name} {kw['style']} tiles={tiles} "
                f"splits={splits}",
                lambda: G.fused_gemm_chain(a, bb, d, prologue=cpro,
                                           epilogue=cepi, **kw),
                lambda: G.fused_gemm_chain_plain(a, bb, d, tiles[1], splits,
                                                 cpro, cepi),
                dt, lambda: G.fused_gemm_chain(a, bb, d, **kw),
                G.fused_gemm_chain, (cpro.key(), cepi.key())),
            tiles=kw, splits=splits)
    tiles = _chain3_tiles(bf)
    b, m, n, k, h, g = CHAIN3
    xs = _seeded([(b, m, k), (b, k, n), (b, n, h), (b, h, g)], bf, 62, dev)
    out["fused_gemm_chain3"]["CHAIN3 bf16"] = dict(_hooked_case(
        f"three-GEMM chain {CHAIN3} tiles={tiles}",
        lambda: G3.fused_gemm_chain3(*xs, prologue=cpro, epilogue=cepi,
                                     **tiles),
        lambda: G3.fused_gemm_chain3_plain(*xs, tiles["bn"], cpro, cepi),
        bf, lambda: G3.fused_gemm_chain3(*xs, **tiles),
        G3.fused_gemm_chain3, (cpro.key(), cepi.key())), tiles=tiles)
    qp, kp, oe = (_elementwise(s) for s in HOOKS["attention"])
    keys = (qp.key(), kp.key(), oe.key())
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    h2, m2, n2, k2, _ = ATTN_TABLE_III["S2"]
    for label, (bb, h, g, m, n, dd, dt, causal) in (
            (f"{cfg.name} forward", (FORWARD["batch"], hq, hkv,
                                     FORWARD["seq"], FORWARD["seq"], d, bf,
                                     True)),
            ("Table III S2", (1, h2, h2, m2, n2, k2, f32, False))):
        tk = api.fuse_attention(m, n, dd, dd, heads=h, batch=bb,
                                dtype=_dtname(dt), causal=causal)
        q, k, v = _seeded([(bb, h, m, dd), (bb, g, n, dd), (bb, g, n, dd)],
                          dt, 63, dev, scaled=False)
        scale = dd ** -0.5
        out["fused_attention"][label] = dict(_hooked_case(
            f"attention {label} B={bb} Hq={h} Hkv={g} M={m} N={n} D={dd} "
            f"causal={causal} tiles=({tk.params.bq},{tk.params.bkv})",
            lambda: tk(q, k, v, q_prologue=qp, k_prologue=kp, o_epilogue=oe),
            lambda: A.fused_attention_plain(q, k, v, tk.params.bkv, causal,
                                            0, scale, qp, kp, oe),
            dt, lambda: tk(q, k, v), A.fused_attention, keys),
            tiles=tk.params.as_kwargs())
        del q, k, v
    out["planted_per_split_epilogue_tol_ratio"] = planted
    return out


def _wall_clock(kind: str, inputs: tuple, call_kw: dict):
    """The card's ``measure_fn`` for ``kind`` ("mlp" or "attn"): the
    candidate schedule's kernel (``codegen.params_for``) launched on
    ``inputs``, device seconds from CUDA events over a CUDA graph of
    launches (``_adaptive_ms``; on a CPU rehearsal the host's clock
    over the plain version); a tile the wrapper refuses takes
    infinity."""
    from repro_torch.core import codegen
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import gemm_chain as G
    kernel = G.fused_mlp_chain if kind == "mlp" else A.fused_attention

    def measure(sched) -> float:
        kw = codegen.params_for(kind, sched).as_kwargs()
        try:
            with torch.inference_mode():
                kernel(*inputs, **call_kw, **kw)
        except ValueError:
            return math.inf
        timer = _adaptive_ms if inputs[0].is_cuda else _host_ms
        with torch.inference_mode():
            return 1e-3 * timer(lambda: kernel(*inputs, **call_kw, **kw),
                                budget_ms=MEASURE_BUDGET_MS, reps=2)
    return measure


def _record_bytes() -> dict:
    """{file name: bytes} of every record of the schedule cache."""
    from repro_torch.core import schedule_cache
    return {p.name: p.read_bytes()
            for p in schedule_cache.cache_dir().glob("*.json")}


def _is_measured(blob: bytes) -> bool:
    try:
        return json.loads(blob).get("trial") == "measured"
    except ValueError:
        return False


def measured_trials_phase(cfg, dev="cuda", cases=MEASURED) -> dict:
    """4q (b): Algorithm 1 with wall-clocked trials on the card.  For each
    case of MEASURED, ``api.fuse_mlp_chain`` / ``api.fuse_attention``
    under ``H100`` with ``_wall_clock`` as ``measure_fn`` (the analytical
    model ranks every population, the card times its top candidates);
    printed: the analytic pick and the measured pick, each timed again
    by the same clock in turns (analytic, measured, measured, analytic),
    ``n_measured``, ``n_iterations`` and the tuning seconds.  A second
    call, the process's memo of it dropped, must load the record from
    disk; every record there before the phase (the main paths' analytic
    ones) must be left byte for byte, and the phase adds only measured
    ones.  No speed is claimed and no limit is set on the times."""
    from repro_torch.core import api, schedule_cache
    from repro_torch.core.perf_model import H100
    stale = [n for n, blob in _record_bytes().items() if _is_measured(blob)]
    for name in stale:  # this phase's own records, from an earlier run
        (schedule_cache.cache_dir() / name).unlink()
    before = _record_bytes()
    out = {}
    for kind, label, dims in cases:
        if kind == "mlp":
            m, n, h = dims
            x = _seeded([(1, m, h), (1, h, n), (1, n, h), (1, h, n)],
                        torch.bfloat16, 64, dev)
            inputs, call_kw = x[:3], dict(wg=x[3])

            def fuse(**kw):
                return api.fuse_mlp_chain(m, n, h, dtype="bfloat16",
                                          hw=H100, **kw)
        else:
            m, n, k, h = dims
            b, hq, hkv = FORWARD["batch"], cfg.n_heads, cfg.n_kv_heads
            inputs = tuple(_seeded([(b, hq, m, k), (b, hkv, n, k),
                                    (b, hkv, n, h)], torch.bfloat16, 65,
                                   dev, scaled=False))
            call_kw = dict(causal=True)

            def fuse(**kw):
                return api.fuse_attention(m, n, k, h, heads=hq, batch=b,
                                          dtype="bfloat16", causal=True,
                                          hw=H100, **kw)
        clock = _wall_clock(kind, inputs, call_kw)
        analytic = fuse()
        measured = fuse(measure_fn=clock)
        if measured.source != "search":
            raise RuntimeError(f"[4q {label}] the measured trials did not "
                               f"search ({measured.source})")
        t = [clock(s.report.best) * 1e3
             for s in (analytic, measured, measured, analytic)]
        for key in [key for key in api._CACHE if key[-1] == "measured"]:
            del api._CACHE[key]
        again = fuse(measure_fn=clock)
        if again.source != "disk" or again.params != measured.params:
            raise RuntimeError(f"[4q {label}] the second call did not load "
                               f"the measured record ({again.source})")
        r = measured.report
        out[label] = dict(
            analytic_pick=analytic.params.as_kwargs(),
            analytic_ms=[t[0], t[3]],
            measured_pick=measured.params.as_kwargs(),
            measured_ms=[t[1], t[2]], search_best_ms=r.best_time * 1e3,
            n_measured=r.n_measured, n_iterations=r.n_iterations,
            tuning_s=measured.tuning_seconds, reload_source=again.source,
            reload_s=again.tuning_seconds)
        print(f"[4q measured] {label}: analytic pick "
              f"{out[label]['analytic_pick']} {t[0]:.4f} / {t[3]:.4f} ms; "
              f"measured pick {out[label]['measured_pick']} {t[1]:.4f} / "
              f"{t[2]:.4f} ms; "
              f"n_measured={r.n_measured} n_iterations={r.n_iterations} "
              f"tuning {measured.tuning_seconds:.2f} s; reloaded from "
              f"{again.source} in {again.tuning_seconds:.4f} s")
        del inputs, call_kw
    after = _record_bytes()
    changed = [n for n, blob in before.items() if after.get(n) != blob]
    added = [n for n in after if n not in before]
    measured = [n for n in added if _is_measured(after[n])]
    if changed or len(measured) != len(cases):
        raise RuntimeError(f"[4q] records changed: {changed}; measured "
                           f"records added: {len(measured)}, want "
                           f"{len(cases)}")
    print(f"[4q measured] {len(before)} earlier records untouched; added "
          f"{len(measured)} measured records and {len(added) - len(measured)}"
          f" analytic ones (shapes no earlier phase tuned)")
    return out


def hooks_phase(cfg, dev="cuda", cases=MEASURED) -> dict:
    """Phase 4q: (a) ``hook_check_phase``, (b) ``measured_trials_phase``;
    nothing degraded."""
    out = {"hooks": hook_check_phase(cfg, dev),
           "measured": measured_trials_phase(cfg, dev, cases)}
    _no_degradation("4q")
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--plant-faults"], ["--reliability"], ["--train"],
                    ["--moe"], ["--archs"], ["--dist"], ["--dist-train"],
                    ["--dryrun"], ["--dist-families"], ["--dist-regimes"],
                    ["--planned"], ["--hooks"]):
        raise SystemExit("usage: python3 chip_smoke.py "
                         "[--plant-faults | --reliability | --train | "
                         "--moe | --archs | --dist | --dist-train | "
                         "--dryrun | --dist-families | --dist-regimes | "
                         "--planned | --hooks]")
    smi = device_phase()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # tuned schedules persist inside the checkout (.cache/ is gitignored)
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR",
                          os.path.join(ROOT, ".cache", "schedules"))
    from repro_torch.configs import get_config
    from repro_torch.core import api
    if argv == ["--train"]:
        print(json.dumps({"train": training_phase(smi)}))
        print(smi)
        return
    if argv == ["--dryrun"]:
        print(json.dumps({"dryrun": dryrun_phase(smi)}, default=str))
        print(smi)
        return
    build_phase()
    cfg = get_config("qwen3-8b")
    if argv == ["--hooks"]:
        print(json.dumps({"hooks": hooks_phase(cfg)}, default=str))
        _clock("4q")
        print(smi)
        return
    if argv == ["--dist"]:
        refdir = tempfile.mkdtemp(prefix="dist-refs-")
        dist_refs_all(refdir)
        dist = dist_phase(refdir)
        shutil.rmtree(refdir)
        dist["times"] = dist_time_phase()
        print(json.dumps({"dist": dist}, default=str))
        print(smi)
        return
    if argv == ["--dist-train"]:
        dist_train = dist_train_phase()
        _no_degradation("4l")
        print(json.dumps({"dist_train": dist_train}, default=str))
        print(smi)
        return
    if argv == ["--dist-families"]:
        families = dist_families_phase()
        _no_degradation("4n")
        families["times"] = dist_families_time_phase()
        print(json.dumps({"dist_families": families}, default=str))
        print(smi)
        return
    if argv == ["--dist-regimes"]:
        pool, pretuned = start_pretune()
        try:
            regimes = dist_regimes_phase()
            _no_degradation("4o")
            regimes["max_abs_err"], regimes["times"] = (
                dist_regimes_kernel_phase(pretuned=pretuned))
        finally:
            pool.shutdown(cancel_futures=True)
        print(json.dumps({"dist_regimes": regimes}, default=str))
        print(smi)
        return
    if argv == ["--planned"]:
        err = planned_kernel_phase(cfg)
        params = init_phase(cfg)
        planned = planned_phase(cfg, params)
        del params
        torch.cuda.empty_cache()
        planned["mesh"] = planned_mesh_phase()
        planned["examples"] = examples_phase()
        planned["max_abs_err"] = err
        planned["times"] = planned_time_phase(cfg)
        print(json.dumps({"planned": planned}, default=str))
        print(smi)
        return
    if argv == ["--plant-faults"]:
        params = init_phase(cfg)
        fault_phase(cfg, params)
        del params
        torch.cuda.empty_cache()
        train_numerics_phase(_train_cfg(),
                             faults=("none", "detach_attention"))
        train_numerics_phase(get_config(RG), limits=RG_T1_LIMITS,
                             faults=("none", "detach_rglru",
                                     "exclusive_scan"))
        plant_ssm_encdec_faults()
        dist_train_phase(faults=("none", "data reduction skipped on rank 1",
                                 "enter an identity both ways"))
        dist_families_phase(faults=tuple(DF_FAULTS))
        dist_regimes_phase(faults=DR_FAULTS)
        print(smi)
        return
    if argv == ["--reliability"]:
        reliability_phase(cfg, init_phase(cfg))
        print(smi)
        return
    n_ctx = SERVE["page_size"] * math.ceil(
        (SERVE["prompt_len"] + SERVE["gen"]) / SERVE["page_size"])
    olmoe, mixtral = get_config(OLMOE), get_config(MIXTRAL)
    moe_tiles = _moe_tiles(olmoe, mixtral, n_ctx)
    rg, pixtral = get_config(RG), get_config(PIXTRAL)
    if argv == ["--archs"]:
        archs_err = archs_kernel_check_phase(rg, pixtral)
        archs = archs_phase()
        ssm_encdec = ssm_encdec_phase()
        archs["max_abs_err"] = archs_err
        archs["times"] = archs_time_phase(rg, pixtral)
        print(json.dumps({"archs": archs}, default=str))
        print(json.dumps({"ssm_encdec": ssm_encdec}, default=str))
        print(smi)
        return
    if argv == ["--moe"]:
        moe_err = moe_kernel_check_phase(olmoe, mixtral, moe_tiles, n_ctx)
        moe = moe_phase()
        moe["max_abs_err"] = moe_err
        moe["times"] = moe_time_phase(olmoe, mixtral, moe_tiles, n_ctx)
        print(json.dumps({"moe": moe}, default=str))
        print(smi)
        return
    # 4o's MLP shapes tuned in a worker while the card runs what follows
    pool, pretuned = start_pretune()
    tuned = {}
    for n in (n_ctx, 4096):
        for dt in (torch.bfloat16, torch.float32):
            p = api.fuse_attention_paged(
                1, n, cfg.dh, cfg.dh, page_size=SERVE["page_size"],
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                batch=SERVE["batch"], dtype=_dtname(dt)).params
            tuned[n, dt] = (p.bq, p.bkv)
    print(f"tuner's decode tiles (bq, bkv): "
          f"{ {f'N={n} {_dtname(dt)}': t for (n, dt), t in tuned.items()} }")
    granite = get_config(GRANITE)
    tuned_mqa = {}
    for dt in (torch.bfloat16, torch.float32):
        p = api.fuse_attention_paged(
            1, n_ctx, granite.dh, granite.dh, page_size=SERVE["page_size"],
            heads=granite.n_heads, kv_heads=granite.n_kv_heads,
            batch=SERVE["batch"], dtype=_dtname(dt)).params
        tuned_mqa[dt] = (p.bq, p.bkv)
    print(f"tuner's decode tiles (bq, bkv) at {GRANITE}'s group of "
          f"{granite.n_heads // granite.n_kv_heads}, N={n_ctx}: "
          f"{ {_dtname(dt): t for dt, t in tuned_mqa.items()} }")
    decode_tiles = tuned[n_ctx, torch.bfloat16]
    max_err = kernel_check_phase(tuned, tuned_mqa)
    mlp_err = mlp_check_phase(cfg)
    slice3_err = slice3_check_phase(cfg)
    moe_err = moe_kernel_check_phase(olmoe, mixtral, moe_tiles, n_ctx)
    archs_err = archs_kernel_check_phase(rg, pixtral)
    planned_err = planned_kernel_phase(cfg)
    _clock("kernel checks")
    # the three-GEMM kernel is on no main path, as in the JAX package:
    # its counter, set to 0 here, must still read 0 after them all
    _zero("fused_gemm_chain3")
    front = quickstart_phase()
    _no_degradation("quickstart")
    _clock("quickstart")
    params = init_phase(cfg)
    hand, _, hand_launches, hand_eager, _ = serve_phase(
        cfg, params, planned=False)
    planned, _, launches, planned_eager, _ = serve_phase(cfg, params,
                                                         planned=True)
    for engine in (hand, planned):
        if engine.model.rt.paged_block != decode_tiles:
            raise RuntimeError("the engine ran other tiles than the "
                               "tuner's")
    end_to_end_check(cfg, params, hand, planned)
    _clock("serve")
    steps = {"hand_wired": step_profile_phase(hand, "hand-wired"),
             "planned": step_profile_phase(planned, "planned")}
    # ``engine``, the loop variable above, holds the planned engine and
    # with it qwen3-8b's weights (17.3 GB on the card)
    del hand, planned, hand_eager, planned_eager, engine
    torch.cuda.empty_cache()
    reliability_phase(cfg, params)
    _clock("reliability")
    torch.cuda.empty_cache()
    fwd = forward_phase(cfg, params)
    _no_degradation("forward")
    generate_phase(cfg, params)
    _no_degradation("generate")
    _clock("forward and generate")
    planned_fwd = planned_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    planned_fwd["examples"] = examples_phase()
    _clock("4p")
    codeqwen = codeqwen_phase()
    steps[CODEQWEN] = codeqwen["step"]
    _clock("codeqwen")
    gparams = init_phase(granite)
    mqa, _, mqa_launches, mqa_eager, _ = serve_phase(
        granite, gparams, planned=False)
    if mqa.model.rt.paged_block != tuned_mqa[torch.bfloat16]:
        raise RuntimeError(f"the {GRANITE} engine ran other tiles than "
                           f"the tuner's")
    steps["granite_20b"] = step_profile_phase(mqa, GRANITE)
    _clock("granite-20b")
    del mqa, mqa_eager, gparams
    _free("cuda")
    # every weight of the parent freed, the worlds' ranks share the card;
    # each world runs on the pool's processes
    with _world_pool(DIST["world"]):
        planned_fwd["mesh"] = planned_mesh_phase()
        _clock("4p mesh")
        refdir = tempfile.mkdtemp(prefix="dist-refs-")
        dist_refs_all(refdir)
        dist = dist_phase(refdir)
        shutil.rmtree(refdir)
        _no_degradation("4k")
        _clock("4k")
        dist_train = dist_train_phase()
        _no_degradation("4l")
        _clock("4l")
        families = dist_families_phase()
        _no_degradation("4n")
        _clock("4n")
        regimes = dist_regimes_phase(zero3=dist_train["zero3"])
        _no_degradation("4o")
        _clock("4o")
    moe = moe_phase()
    steps[OLMOE] = moe["step_profile"]
    steps[MIXTRAL] = moe["mixtral_step_profile"]
    _clock("moe")
    archs = archs_phase()
    ssm_encdec = ssm_encdec_phase()
    _clock("archs")
    chain3_launches = _read("fused_gemm_chain3")["fused_gemm_chain3"]
    print(f"[main paths] fused_gemm_chain3 launches: {chain3_launches} "
          f"(want 0)")
    if chain3_launches:
        raise RuntimeError("a main path launched fused_gemm_chain3")
    # 4g, after every serving phase and the counters' last read
    train = training_phase(smi)
    _clock("training")
    dry = dryrun_phase(smi, sp=dist_train["sp"])
    _clock("4m")
    print("[steps] decode step wall / device busy / busy share / span (ms):"
          + "".join(f" {path} {mode} {p['wall_ms']:.3f} / "
                    f"{p['busy_ms']:.3f} / "
                    f"{100 * p['busy_ms'] / p['wall_ms']:.1f}% / "
                    f"{p['span_ms']:.3f};"
                    for path, by in steps.items()
                    for mode, p in by.items()))
    t_dec = time_phase(n_ctx, decode_tiles, "slice decode")
    t_long = time_phase(4096, tuned[4096, torch.bfloat16], "long decode")
    t_mqa = time_phase(n_ctx, tuned_mqa[torch.bfloat16], f"{GRANITE} decode",
                       hq=granite.n_heads, hkv=granite.n_kv_heads,
                       other_tiles=((1, 16, 1), (1, 32, None), (1, 32, 1),
                                    (1, 80, None), (1, 80, 1)))
    t_mlp = {label: mlp_time_phase(cfg, label, m)
             for label, m in MLP_SHAPES.items()}
    t_attn = attention_time_phase(cfg)
    t_chain = {"G12 bf16": chain_time_phase("G12", torch.bfloat16,
                                            sweep=True),
               "quickstart G1 f32": chain_time_phase("G1", torch.float32)}
    t_chain3 = chain3_time_phase()
    t_moe = moe_time_phase(olmoe, mixtral, moe_tiles, n_ctx)
    t_archs = archs_time_phase(rg, pixtral)
    t_dist = dist_time_phase()
    t_families = dist_families_time_phase()
    dr_err, t_regimes = dist_regimes_kernel_phase(pretuned=pretuned)
    t_planned = planned_time_phase(cfg)
    _clock("times")
    q4 = hooks_phase(cfg)
    _clock("4q")
    pool.shutdown()
    dist_launches = {
        name: sum(counts.get(name, 0) for counts in dist["launches"].values())
        for name in ("fused_attention_partial", "fused_attention",
                     "fused_gemm_chain")}
    moe_paths = {f"{OLMOE} hand_wired": "hand_wired",
                 f"{OLMOE} planner_requested": "planner_requested",
                 f"{MIXTRAL} (16 layers)": "mixtral",
                 f"{MIXTRAL} (16 layers) long": "mixtral_long"}
    by_path = {name: {"hand_wired": hand_launches[name],
                      "planned": launches[name],
                      "granite_20b": mqa_launches[name],
                      "codeqwen1.5_7b": codeqwen["launches"][name],
                      **{path: moe["launches"][key][name]
                         for path, key in moe_paths.items()}}
               for name in launches}
    by_path["fused_attention_partial"]["4k a rank"] = dist_launches[
        "fused_attention_partial"]
    by_path["fused_attention_partial"]["4l (d) a rank"] = dist_train[
        "moe"]["launches"]["engine"]["fused_attention_partial"]
    planned_by_path = {name: {
        **{f"4p planned {call} {label}": planned_fwd[label]["launches"][
            call].get(name, 0)
           for label in PLANNED["shapes"] for call in ("loss", "forward")},
        **{f"4p (1x4) planned {call} a rank": planned_fwd["mesh"][
            "launches"][call].get(name, 0) for call in ("loss", "forward")}}
        for name in ("fused_mlp_chain", "fused_attention")}
    by_path["fused_mlp_chain"].update(planned_by_path["fused_mlp_chain"])
    for name in SERVED:
        by_path[name]["4o (a) a rank"] = sum(
            e["launches"].get(name, 0) for e in regimes["engines"].values())
        by_path[name]["4o (b) a rank"] = regimes["prefill"]["launches"].get(
            name, 0)
    moe_times = ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "tiles", "splits", "other_tiles_ms")
    kernels = [{
        "name": "fused_attention_partial",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention_partial.cu",
        "replaces": "src/repro/kernels/attention.py:160",
        "launches": launches["fused_attention_partial"],
        "launches_by_path": by_path["fused_attention_partial"],
        "max_abs_err": max(max_err, moe_err["fused_attention_partial"]),
        "ms": t_dec["kernel_ms"],
        "plain_ms": t_dec["plain_ms"],
        "bound_ms": t_dec["bound_ms"],
        "bound_by": t_dec["bound_by"],
        "library_ms": t_dec["library_ms"],
        "tiles": t_dec["tiles"],
        "splits": t_dec["splits"],
        "long_decode_4096": {k: t_long[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tiles", "splits")},
        "granite_20b_decode": {k: t_mqa[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tiles", "splits", "other_tiles_ms")},
        "olmoe_1b_7b_decode_group_1": {
            k: t_moe["olmoe_decode"][k] for k in moe_times},
        "mixtral_8x7b_decode_window_4096": {
            k: t_moe["mixtral_decode"][k] for k in moe_times},
        "ring_rank_block": t_dist["fused_attention_partial"],
        "hooked": None,    # no hooks, as in the JAX package
        "passed": True,
    }, {
        "name": "fused_mlp_chain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlp_chain.cu",
        "replaces": "src/repro/kernels/gemm_chain.py:205",
        "launches": launches["fused_mlp_chain"],
        "launches_by_path": by_path["fused_mlp_chain"],
        "max_abs_err": max(mlp_err, dr_err,
                           planned_err["fused_mlp_chain"]),
        "ms": t_mlp["decode"]["kernel_ms"],
        "plain_ms": t_mlp["decode"]["plain_ms"],
        "bound_ms": t_mlp["decode"]["bound_ms"],
        "bound_by": t_mlp["decode"]["bound_by"],
        "library_ms": None,
        "unfused_ms": t_mlp["decode"]["unfused_ms"],
        "tiles": t_mlp["decode"]["tiles"],
        "splits": t_mlp["decode"]["splits"],
        "tile_sweep_ms": t_mlp["decode"]["tile_sweep_ms"],
        "device_ms_by_kernel": t_mlp["decode"]["device_ms_by_kernel"],
        **{label: {k: t_mlp[label][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms",
            "tiles", "splits", "tile_sweep_ms", "device_ms_by_kernel")}
           for label in ("prefill", "m4096")},
        "rank_blocks_4o": {label: {k: t[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms",
            "tiles", "splits", "tile_sweep_ms", "tuning_s")}
            for label, t in t_regimes.items()},
        **{key: {k: t[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms",
            "tiles", "splits", "tile_sweep_ms")}
           for key, t in (("m512_4p", t_planned["fused_mlp_chain"]),
                          ("m512_rank_block_4p",
                           t_planned["fused_mlp_chain"]["rank_block"]))},
        "hooked": q4["hooks"]["fused_mlp_chain"],
        "planted_per_split_epilogue_tol_ratio": q4["hooks"][
            "planted_per_split_epilogue_tol_ratio"],
        "measured_trials": {label: t for label, t in q4["measured"].items()
                            if label.startswith("qwen3-8b rank block")
                            or "M=512" in label},
        "passed": True,
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention_partial.cu",
        "replaces": "src/repro/kernels/attention.py:255",
        "launches": fwd["launches"]["forward"],
        "launches_by_path": {
            "loss": fwd["launches"]["loss"],
            "forward": fwd["launches"]["forward"],
            "quickstart": front["fused_attention"],
            f"{OLMOE} loss": moe["forward"]["launches"]["loss"],
            f"{OLMOE} forward": moe["forward"]["launches"]["forward"],
            **{f"{arch} {call}": archs[arch]["forward"]["launches"][call]
               for arch in (RG, PIXTRAL) for call in ("loss", "forward")},
            "4k a rank": dist_launches["fused_attention"],
            "4l (d) loss a rank": dist_train["moe"]["launches"]["loss"][
                "fused_attention"],
            "4l (d) forward a rank": dist_train["moe"]["launches"][
                "forward"]["fused_attention"],
            **{f"4n (c) {RG} {call} a rank": families["archs"][RG][
                "launches"][0][call]["fused_attention"]
               for call in ("loss", "forward")},
            **planned_by_path["fused_attention"]},
        "max_abs_err": max(slice3_err["fused_attention"],
                           moe_err["fused_attention"], archs_err,
                           planned_err["fused_attention"]),
        "ms": t_attn["kernel_ms"],
        "plain_ms": t_attn["plain_ms"],
        "bound_ms": t_attn["bound_ms"],
        "bound_by": t_attn["bound_by"],
        "library_ms": t_attn["library_ms"],
        "tiles": t_attn["tiles"],
        "other_tiles_ms": t_attn["other_tiles_ms"],
        "table_iii_s2_f32": t_attn["s2_f32"],
        "olmoe_1b_7b_forward": {k: t_moe["olmoe_forward"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tiles", "other_tiles_ms")},
        "recurrentgemma_2b_forward_d256": t_archs["recurrentgemma_forward"],
        "pixtral_12b_forward": t_archs["pixtral_forward"],
        "spatial_rank_block": t_dist["fused_attention"],
        "forward_2x256_4p": {k: t_planned["fused_attention"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tiles")},
        "forward_2x256_rank_block_4p": t_planned["fused_attention"][
            "rank_block"],
        "recurrentgemma_2b_rank_block_4n": t_families,
        "hooked": q4["hooks"]["fused_attention"],
        "measured_trials": {label: t for label, t in q4["measured"].items()
                            if "forward B=2" in label},
        "passed": True,
    }, {
        "name": "fused_gemm_chain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_chain.cu",
        "replaces": "src/repro/kernels/gemm_chain.py:80",
        "launches": front["fused_gemm_chain"],
        "launches_by_path": {"quickstart": front["fused_gemm_chain"],
                             "4k a rank": dist_launches["fused_gemm_chain"]},
        "max_abs_err": slice3_err["fused_gemm_chain"],
        "ms": t_chain["G12 bf16"]["kernel_ms"],
        "plain_ms": t_chain["G12 bf16"]["plain_ms"],
        "bound_ms": t_chain["G12 bf16"]["bound_ms"],
        "bound_by": t_chain["G12 bf16"]["bound_by"],
        "library_ms": None,
        "unfused_ms": t_chain["G12 bf16"]["unfused_ms"],
        "tiles": t_chain["G12 bf16"]["tiles"],
        "splits": t_chain["G12 bf16"]["splits"],
        "tile_sweep_ms": t_chain["G12 bf16"]["tile_sweep_ms"],
        "device_ms_by_kernel": t_chain["G12 bf16"]["device_ms_by_kernel"],
        "quickstart_g1_f32": {k: t_chain["quickstart G1 f32"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms",
            "tiles", "splits", "device_ms_by_kernel")},
        "g12_rank_block": t_dist["fused_gemm_chain"],
        "hooked": q4["hooks"]["fused_gemm_chain"],
        "passed": True,
    }, {
        "name": "fused_gemm_chain3",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_chain.cu",
        "replaces": "src/repro/kernels/gemm_chain3.py:60",
        "launches": chain3_launches,
        "max_abs_err": slice3_err["fused_gemm_chain3"],
        "ms": t_chain3["kernel_ms"],
        "plain_ms": t_chain3["plain_ms"],
        "bound_ms": t_chain3["bound_ms"],
        "bound_by": t_chain3["bound_by"],
        "library_ms": None,
        "unfused_ms": t_chain3["unfused_ms"],
        "tiles": t_chain3["tiles"],
        "splits": t_chain3["splits"],
        "device_ms_by_kernel": t_chain3["device_ms_by_kernel"],
        "hooked": q4["hooks"]["fused_gemm_chain3"],
        "passed": True,
    }]
    print(json.dumps({"train": train}))
    print(json.dumps({"moe": {k: moe[k] for k in (
        "golden_probe", "decode_step", "floor", "mixtral_floor", "forward",
        "generate", "mixtral_long", "seconds")}}, default=str))
    print(json.dumps({"archs": archs}, default=str))
    print(json.dumps({"ssm_encdec": ssm_encdec}, default=str))
    print(json.dumps({"codeqwen": {k: codeqwen[k] for k in (
        "launches", "decode_steps", "tok_per_s", "eager_tok_per_s",
        "generate")}}, default=str))
    print(json.dumps({"dist": dict(dist, times=t_dist)}, default=str))
    print(json.dumps({"dist_train": dist_train}, default=str))
    print(json.dumps({"dist_families": families}, default=str))
    print(json.dumps({"dist_regimes": regimes}, default=str))
    print(json.dumps({"dryrun": dry}, default=str))
    print(json.dumps({"planned": planned_fwd}, default=str))
    print(json.dumps({"hooks": q4}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
