#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase16     # phase 16 alone, on every card
    python3 chip_smoke.py --phase17     # phase 17 alone, on one card
    python3 chip_smoke.py --phase18     # phase 18 alone, default sizes

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``);
run from a checkout, since it imports ``src/repro_torch``.  Phases, each
of which stops the run with a non-zero exit when it fails:

1. build the seven kernels from ``src/`` (``zns_alloc``, flash
   attention, decode attention, ``ssm_scan``, ``page_clock``,
   ``mlstm_scan`` -- its two designs, two sources -- and ``slstm_scan``),
   one ``nvcc`` a source, all started together, and print each build
   time; beside them, ``ptxas -v`` of all eight sources (registers and
   spills of each kernel);
2. hold the ``zns_alloc`` kernels to their plain PyTorch versions, bit
   for bit, on CUDA tensors: the row selection at the main path's zn540
   shapes and at random ragged shapes, the fused ALLOC and grow
   selections on random lane batches (both policies, cost ties, groups
   with no feasible row, wear bound 0, hint 0, union lanes) and at the
   zn540 grid under the 128-lane fleet's own lane table;
3. the main path: ``paper_report(device="cuda")`` at the paper's zn540
   device, held to the reference's ``BENCH_paper.json`` (DLWA and erases
   exactly, execution seconds at rel 1e-5), with the kernels' launch
   counts zeroed just before and read just after; 3b. the Pallas
   contract, ``allocator.allocate``, on the card (the row kernel);
4. the headline's dispatches and a 128-lane zn540 fleet batch run on the
   card and on the CPU; every ``DeviceState`` / ``OpTrace`` field must be
   bit-identical;
5. phase 3 launched exactly one fused ALLOC and one fused grow selection
   per op step of its dispatches (1184 launches), and nothing else;
6. timings: an empty kernel through the same ctypes route (the floor of
   any small launch), both fused selections at the zn540 grid (held
   bit for bit against their plain versions on the timed inputs; CUDA
   events a call, ``torch.profiler`` device time a launch, plain
   version, bound), the row kernel beside ``torch.topk``, one
   ``paper_report`` and the fleet dispatch; and a 16-op-step prefix of
   one headline dispatch under ``torch.profiler`` for the card's busy share, its device events
   per op step and the fused kernels' device time;
11. the key-value storage path: six zn540 lanes of recorded application
    traffic -- 0.28 of a drive-write of KVBench LSM flush/compaction
    traffic (``scaled_kv_config(..., n_flushes=70)`` on ``ZoneFS``; one
    drive-write, 250 flushes, until the script passed 1,200 s on a slow
    host), checkpoint
    bursts and a Zipfian flash cache, each on a traditional whole-zone
    lane and a silent BLOCK lane -- recorded with the port's
    ``RecordingBackend`` and replayed as ONE ``replay_recorders`` dispatch
    on the card (rows checked before, every lane's state sanitized
    after), every lane held to the reference's summary
    ``tests/data/torch_kv_zn540.json`` (sha256 of the programs and of
    every ``DeviceState`` / ``OpTrace`` field, metrics exactly, makespans
    and class latencies at rel 1e-5), with exactly one ``alloc_select``
    and one ``grow_select`` launch per op step (2,048 each) and nothing
    else of ``zns_alloc``; the record and dispatch seconds, lane-ops/s,
    the per-lane table, a 16-op-step prefix under ``torch.profiler``,
    and both fused selections held against their plain versions and
    timed at this batch's lane table;
12. ZoneFS + the LSM simulator over the device shim
    (``ZNSDevice(zn540, BLOCK)``) on the card and on the CPU: reports,
    counters and element state equal, and a recorder's one-program
    replay of the same traffic on the card gives the shim's DLWA;
13. the allocator design-space search at zn540, at the reference's
    ``tools/bench.py`` full-mode sizes (:data:`FLEET_PARAMS`): (a) the
    32-config ``grid_space()`` through ``Evaluator(n_devices=4)`` (128
    lanes x 256 op steps), (b) the 12-config mixed-spec grid over the
    SUPERBLOCK + BLOCK + vchunk(2) union (48 lanes), (c)
    ``evolve_vs_random`` (random-32 against evolve), (d) the telemetry
    batch (32 lanes x 384 steps) run off and on -- states and traces
    bit-identical, the Perfetto trace and sidecar written to
    ``build/fleet_zn540_{trace,obs}.json`` and validated, the overhead
    as one paired off/on ratio (the reference takes the median of 9) --
    (e) 2 generations of a 4-config x 2-device Evaluator whose launch
    plans must stay flat, (f) the 8 arrays of the reference
    comparator's engine leg in one ``run_array_batch`` and two
    ``rebuild_storm`` calls (the second adds no plan); every section
    held to ``tests/data/torch_fleet_zn540.json`` (rows, rankings,
    reports and sha256 of programs, lane configs, states, traces and
    telemetry exactly; clocks at rel 1e-5; the float64 wear statistics
    at rel 1e-12, see :data:`FLEET_STAT_KEYS`), with exactly one
    ``alloc_select`` and one ``grow_select`` launch per op step of
    every dispatch; each section's seconds and lane-ops/s, a profiled
    16-step prefix of (a) and an 8-step prefix of (d) off and on, and
    both fused selections held bit for bit against their plain versions
    and timed at (a)'s 128-lane SUPERBLOCK table and (b)'s 48-lane union
    table;
14. (run after phase 17) the paper's per-op benchmarks and the legacy
    oracles (:data:`WORKLOAD_PARAMS`), each section held to
    ``tests/data/torch_workloads_zn540.json`` (counts, DLWA and page
    totals exactly, clocks and interference factors at rel 1e-5, wear
    statistics at rel 1e-12): (a) Fig. 4b / 7d at zn540, concurrency
    1-7, FIXED and SUPERBLOCK, through the device shim, the per-op
    ``LegacyZNSDevice`` and the batched engine sweep (phase 17's Fig. 4b
    / 7d, the same engines and parameters), which must agree exactly;
    (b) Fig. 9's FIO grid on custom16 through the legacy device and the
    engine (phase 17's Fig. 9; one geometry row through the shim too),
    which must agree exactly; (c) Table 4's
    allocation latency on both devices for four specs; (d)-(f) the
    engine-vs-legacy comparators of the per-op workloads, the fleet
    sweep (32 configs and the 12-config union) and the arrays, each with
    its DLWA or report exactness asserts, and no new launch plan across
    the interference sweep's timed repeats; (g) phase 11's three
    traditional lanes replayed through ``LegacyZNSDevice``, each with its
    dispatch's DLWA.  Every page-granular timing call is one
    ``page_clock`` launch and every legacy selection one ``zns_alloc``
    row launch (counts zeroed before and read after each section), and
    every device row it steps is one chain a channel (no LUN of these
    geometries meets two channels; the kernel reports each row's path);
    (h) ``page_clock`` against its plain version, bit for bit, on both
    paths: 16 random padded batches stepped whole, 16 partitioned (each
    LUN on one channel), one of sixteen LUNs a channel, the custom16
    stream of Fig. 9's P16 S1 (20,000 requests, two LUNs a channel) and a
    20,000-request prefix of (a)'s FIXED concurrency-7 contended zn540
    stream (473,088 requests); then timed on that whole stream beside its
    bound and the plain loop on the prefix, on a random stream of the
    same length stepped whole, and on a one-channel stream of that length
    (the step chain's floor a request);
17. the paper's figures at the paper's sizes (:data:`FIGURES`; in the
    whole script Fig. 7c and Table 4 cut as :data:`FIGURE_CUTS` says,
    ``--phase17`` runs them whole): every
    function of ``src/repro_torch/tools/paper_figures.py`` -- Fig. 4a /
    7a and Fig. 8 as occupancy sweeps, Fig. 4b / 7d and Table 3 as
    interference sweeps, Fig. 9 as write programs, Fig. 7b (five FINISH
    thresholds x 1M KVBench ops) and Fig. 7c (4 x 1M ops on one mount;
    400 churn rounds on two lanes, wear-aware off and on) recorded and
    replayed as one dispatch a spec, Table 4 on the device shim -- and
    ``tools/ckpt_zns.run_all`` (every arch's checkpoint epochs, one lane
    an arch), each held to the reference's outputs in
    ``tests/data/torch_figures_paper.json`` (counts, pages, erases, DLWA
    and SA exactly; interference factors and bandwidths at rel 1e-5,
    Table 3's unrounded factors too; wear spreads at rel 1e-12; Table 4
    by its keys, sample counts and N/A cells), with one ``alloc_select``
    and one ``grow_select`` launch per op step of a non-FIXED engine
    (a FIXED engine's ALLOC is a plain argmin), no row selection and one
    ``page_clock`` launch per page-granular timing call (counts
    zeroed before and read after each figure); each figure's seconds,
    dispatches, op steps and lane-ops/s, its derived values beside the
    paper's claim, Table 4's median microseconds on the card; both fused
    selections held to their plain versions, bit for bit, at all 23
    custom16 grids of the figures' selecting engines (each engine's own
    lane table and random lanes), held and timed at Fig. 7c's two-lane
    table, and ``page_clock`` at Table 3's widest stream;
18. (run after phase 14) the reference's CLIs and examples as port-side
    drivers (:data:`CLI_RUNS`): ``repro_torch.tools.fleet_search``
    (``--quick`` under each strategy, with ``--obs``, and ``--workload
    lsm``), ``raid_zns`` (the ``--quick`` sweep, a single run with
    parity, ``--rebuild``), ``quickstart``, ``zns_design_space`` (two
    geometries), ``raid_array`` and ``fleet_example``, each run in this
    process as its command line with ``--device cuda`` and held to the
    reference scripts' outputs in ``tests/data/torch_clis_zn540.json``
    (printed lines with the clocks masked exactly, the outputs of
    :data:`CLI_SPIES` and the files written: counts and DLWA exactly,
    clocks at rel 1e-5), with one ``alloc_select`` and one
    ``grow_select`` launch per op step of a non-FIXED engine and no row
    selection; each run's seconds, dispatches, op steps and shim
    commands.  ``--phase18`` runs the drivers at their default sizes
    instead (:data:`CLI_DEFAULT_RUNS`) and logs their times;
7. hold the two attention kernels to their plain versions on CUDA
   tensors, f32 and bf16, at the three serving paths' shapes (granite's,
   the Jamba cut's: S 2048, G 8, and the llama4-scout cut's: G 5, 40
   query over 8 KV heads, S 512, decode lengths 513-544), at S and Sk
   on, one before and one
   after the flash kernel's 128-row tiles and at D 16, at lengths on,
   one before and one after a split boundary of the decode kernel's
   plan and with most splits empty, and at random ragged shapes
   (``rel_err`` within the reference's ``tol(dtype)``);
7b. hold the ``ssm_scan`` kernel to its plain version the same way: the
    Jamba cut's prefill shape with b and c as column views, T = 1, T and P
    off every chunk and CTA width, T and P one before, on and one after
    the kernel's chunk and tile widths, odd P, ``dt * a`` = 0 and below
    -126, and 12 random shapes;
8. the serving path: ``repro_torch.launch.serve.main`` for granite-3-8b
   at full width and depth (8 prompts of 512 tokens, 31 greedy decode
   steps), with both launch counts zeroed just before and read just
   after: 40 flash-attention launches in prefill, 40 x 31
   decode-attention launches in decode, none crossed;
9. the same run through the plain attention (``attn_impl="ref"``),
   teacher-forced with phase 8's tokens: prefill logits, every decode
   step's logits and the final KV caches held to phase 8's;
10. timings with CUDA events at the slice's shapes -- each attention
    kernel, its plain version and one ``scaled_dot_product_attention``
    call (decode over 40 distinct layer caches, read cold as in a step),
    with each kernel's design, registers, spills, device time per launch
    (``torch.profiler``) and share of its bound -- a second timed serve
    run, and one decode step under ``torch.profiler`` for the card's busy
    share;

then, with granite's model and caches freed, the Mamba path:

8b. ``serve.build`` and ``serve.generate`` (the functions ``serve.main``
    calls) for the one-card cut of jamba-1.5-large-398b
    (``configs/jamba15_large_398b.ONE_CHIP``: 8 layers at full width, 7
    Mamba and 1 attention, dense FFNs; weights from seed 0 on the card):
    8 prompts of 2048 tokens, 31 greedy decode steps, with every launch
    count zeroed just before and read just after -- ``ssm_scan`` 7 and
    ``flash_attention`` 1 in prefill, ``decode_attention`` 31 in decode,
    none crossed;
9b. the same run through the plain attention and the plain scan
    (``attn_impl="ref", ssm_impl="ref"``), teacher-forced with phase 8b's
    tokens: every step's logits and the final KV and Mamba caches held to
    phase 8b's;
10b. CUDA-event times at the Jamba cut's shapes -- ``ssm_scan`` beside
     its device time per launch, its plain version and its bound (the
     issue floor of its
     exponentials and f32 instructions, with the share of exponentials
     best moved from the SFU to the f32 pipes, see :func:`scan_floor`), flash attention (S 2048, G 8) and
     decode attention (G 8) beside their plain versions and SDPA -- a
     second timed serve run, and one profiled decode step;

then, with the Jamba cut freed, the MoE path:

7c. deepseek-v2's routed layer at its published ``MoEDims`` (160
    experts, top-6, d 5120, f 1536, 2 shared experts, capacity factor
    1.25, device-limited routing over 16 groups with limit 3, int8
    dispatch; 3.82 B parameters from a seeded generator on the card):
    two runs bit-identical at T = 4096 and T = 8, and at T = 512 the
    routes, kept mask and positions equal to a CPU run of the same
    function on the same tensors (a route may differ only where the
    chosen and the next probability are within 1e-5; the rest is then
    held under the card's routes) and the output within the bf16 kernel
    tolerance; the weights are freed after;
8c. ``serve.build`` and ``serve.generate`` for the one-card cut of
    llama4-scout-17b-a16e (``configs/llama4_scout_17b_a16e.ONE_CHIP``:
    every width, all 16 experts and the shared expert as published,
    depth 48 -> 16; weights from seed 0 on the card): 8 prompts of 512
    tokens, 31 greedy decode steps, every launch count zeroed just
    before and read just after -- ``flash_attention`` 16 in prefill,
    ``decode_attention`` 16 x 31 in decode, nothing crossed, no
    ``ssm_scan``, ``zns_alloc`` or ``page_clock`` launch -- with every
    MoE layer recording its routes; the peak device memory and the
    pairs prefill dropped at capacity 320;
9c. the same run through the plain attention, teacher-forced, with every
    MoE layer replaying 8c's routes: every step's logits and the final
    caches held to 8c's; then routing on its own, with the (layer, token)
    routes that flipped and the largest flipped top-1/top-2 margin
    printed (not gated);
10c. CUDA-event times at the cut's shapes -- one MoE layer at T = 4096
     and T = 8 beside its bound (all E x C slots and the shared expert at
     the bf16 peak; every weight read once) with its device events under
     ``torch.profiler``, flash (G 5) and decode attention (G 5) beside
     their plain versions and SDPA -- a second timed serve run, and one
     profiled decode step;

then, with the llama4 cut freed, multi-head latent attention:

7d. the flash kernel above head dim 128 against its plain version, f32
    and bf16: the deepseek-v2 cut's prefill shape (B 8, 128 heads, S
    512, D 192, V zero-padded from 128), S and Sk one before, on and one
    after the bf16 kernel's 64-row K/V tiles and 128-row q tiles, D 136
    and 184, and random ragged shapes with G > 1;
8d. ``serve.build`` and ``serve.generate`` for the one-card cut of
    deepseek-v2-236b (``configs/deepseek_v2_236b.ONE_CHIP``: MLA, all 160
    experts and the 2 shared ones at published widths, depth 60 -> 10;
    weights from seed 0 on the card): 8 prompts of 512 tokens, 31 greedy
    decode steps, every launch count zeroed just before and read just
    after -- ``flash_attention`` 10 in prefill (D 192), no
    ``decode_attention`` launch (MLA's absorbed decode is plain products,
    as in the reference), no ``ssm_scan``, ``zns_alloc`` or
    ``page_clock`` launch -- with every MoE layer recording its routes;
    the peak device memory and the pairs prefill dropped;
9d. as 9c: the plain attention under replayed routes, every step's
    logits and the final ``c_kv`` / ``k_rope`` caches held to 8d's; then
    routing on its own, the flipped routes counted (not gated);
10d. CUDA-event times: one MLA decode layer beside its bound (its
     weights and latent rows read once), one MoE layer at T = 4096 and
     T = 8 beside its bound, flash at D 192 beside its device time per
     launch, its plain version and SDPA, a second timed serve run, and
     one profiled decode step;

then, with the deepseek-v2 cut freed, cross-attention and the encoder:

7e. both attention kernels against their plain versions at the two
    cross-attention models' shapes, f32 and bf16: flash self-attention
    (causal) and cross-attention (not causal, S 512 over the memory's Sk
    1601, also as the strided ``(B, M, Hkv, D)`` views the model passes)
    of llama-3.2-vision-11b, the encoder (S = Sk = 1024, D 64, G 1),
    causal decoder and cross-attention (Sk 1024) of seamless-m4t-medium;
    Sk one before, on and one after 1601's 64- and 128-row tile
    boundaries (1535-1537, 1599-1603); not causal with S > Sk; decode
    attention over memories of 1601 and 1024 rows with every length
    equal to M, at G 1 and G 4, beside the self-attention decodes; and
    self and cross decodes interleaved in one stream (they share the
    kernel's scratch, grown to the larger plan);
8e. ``serve.build`` and ``serve.generate`` for llama-3.2-vision-11b as
    published (40 layers, every 5th a cross layer; weights from seed 0 on
    the card): 8 prompts of 512 tokens and a memory of (8, 1601, 4096)
    bf16 from the reference's recipe (its ``memory_len``), 31 greedy
    decode steps, every launch count zeroed just before and read just
    after -- ``flash_attention`` 48 in prefill (40 causal + 8 cross),
    ``decode_attention`` 48 x 31 in decode, nothing crossed, no
    ``ssm_scan``, ``zns_alloc`` or ``page_clock`` launch; the peak device
    memory;
9e. the same run through the plain attention, teacher-forced with 8e's
    tokens and memory: every step's logits, the final KV caches and the
    memory K/V held to 8e's;
10e. CUDA-event times at the cross-attention shapes -- flash (S 512 over
     Sk 1601, not causal) and decode attention (every length 1601, over
     the 8 cross layers' memories) beside their device time per launch,
     plain versions, SDPA and bounds -- a second timed serve run, and
     one profiled decode step;
8f-10f. the same for seamless-m4t-medium as published (12 encoder and 12
     decoder layers): 8 requests of 1024 encoder frames (its
     ``memory_len`` at the 4k cell) and decoder prompts of 512 tokens, 31
     decode steps; ``flash_attention`` 36 in prefill (12 encoder + 12
     causal + 12 cross), ``decode_attention`` 24 x 31; prefill split into
     its encoder and decoder spans; the encoder's flash shape timed too;
7f. the two xLSTM scans held to their plain versions on CUDA tensors, f32
    and bf16: the served shapes (B 8, T 2048, H 4, P 384 for
    ``mlstm_scan``, d 768 in 4 heads for ``slstm_scan``), T 1, 37, 129
    and 2047 at B 1-8 and the reduced widths (P 32; d 64), q/k/v as
    strided views of one projection, the gates as column views, each scan
    on the design its launch plan picks (the mLSTM's chunkwise
    tensor-core kernel in bf16 up to P 384, its recurrent kernel in f32
    and at P 512; the sLSTM's tensor-core cluster kernel in bf16 at d
    768, ragged T at d 256 and d 1024 in 8 heads, 16 CTAs; the L2 kernel
    in f32 and at the reduced widths) and on the other design forced (the
    mLSTM's recurrent kernel at the served shape and at T 129, strided;
    the sLSTM's L2 kernel at d 768), the chunkwise kernel also on padded
    head sizes (P 64, 96, 160, 256), its share of bf16 values that
    differ from the stepped version's held to ``CHUNKWISE_FLIP_TOL``
    (which the plain chunkwise version with hi/lo pairs must exceed),
    and against its own plain version with its operand roundings; the
    worst error by design logged; each kernel timed at the served shape beside its
    device time, plain version and bound (no library call computes either
    recurrence), both scans on both designs, the sLSTM also at d 256 (the
    step chain's floor);
8g. ``serve.build`` and ``serve.generate`` for xlstm-125m as published
    (12 layers, 3 x (mLSTM, mLSTM, mLSTM, sLSTM), d 768, no FFN;
    145,044,480 parameters from seed 0): 8 prompts of 2048 tokens, 31
    decode steps -- ``mlstm_scan`` 9 (all on the chunkwise kernel) and
    ``slstm_scan`` 3 in prefill, none in decode, no attention,
    ``ssm_scan``, ``zns_alloc`` or ``page_clock`` launch;
9g. the plain path (``ssm_impl="ref"``: the stepped recurrences),
    teacher-forced with 8g's tokens: logits and caches held to 8g's; the
    prefill again with the mLSTM forced onto its recurrent kernel, and
    again with the sLSTM forced onto its L2 kernel, their logits against
    the plain path's beside 8g's; then all three against an f32
    reference that no bf16 rounding moves (8g's weights upcast, both
    scans stepped in f32): the served path's last-token logits at most
    :data:`F32_RATIO` times as far from it as the bf16 plain path's;
10g. a second timed serve run, one profiled prefill (each scan's device
     time) and one profiled decode step (busy time, device events);
then the profiled dispatches of phases 6, 11 and 13, set aside until
every kernel's device time was read (after windows of ~10^5 device
events, later small windows of the process lost their device events);
15. training, which launches no kernel (the reference trains through
    none: ``make_train_step``'s defaults are ``attn_impl="qchunk"`` and
    ``ssm_impl="ref"``, plain PyTorch under autograd): 15a one
    ``make_train_step`` step in f32 on the card and on the CPU from the
    same parameters (drawn on the CPU from seed 0) and ``SyntheticLM``
    batch, for phi3-mini-3.8b cut to depth 2 (B 1, S 256) and xlstm-125m
    cut to one repetition, depth 4 (B 2, S 128): loss, aux and gradient
    norm at rel 1e-5, each gradient leaf at 1e-4 (TF32 off); 15b
    phi3-mini-3.8b as published (3,723,168,768 parameters, bf16, f32
    AdamW state at the reference's defaults, remat, ``qchunk``; B 4 x S
    2048): a warm-up step, three
    timed steps (ms a step, tokens/s, the optimizer's share, peak
    memory, 6·N·tokens against the dense bf16 peak), losses finite and
    falling, and one profiled step (busy time, the kernels taking most
    of it); 15c xlstm-125m as published through
    ``launch.train.main --steps 6 --batch 8 --seq 32 --ckpt-every 3``,
    then ``--fail-at 4`` from a fresh directory and its restart, which
    restores step 2 and must repeat the first run's losses for steps 3-5
    bit for bit; the checkpoint store's ZNS telemetry, bytes and
    seconds a save, ms a step; 15d no kernel launches in a train step of
    15a-15c (``zns_alloc`` launches of the checkpoint store's simulated
    device aside), and a flash-attention call on CUDA tensors that
    require grad raises under grad mode and launches once under
    ``torch.no_grad()``;
16. the distributed paths, one spawned process a card over NCCL (world
    size ``min(4, cards)``; with one card the same code at world size 1,
    where no collective crosses cards): 16a ``hierarchical_psum`` over
    (pod, data) = (2, 2) on four cards, (1, n) otherwise, on a 256 MB f32
    buffer against a flat ``all_reduce`` (rtol 1e-6), both timed by CUDA
    events with their bus GB/s; 16b ``pipeline_apply`` of the reference
    test's ``tanh(a @ w)`` block at width 4096, one stage a card, M 8,
    against the stages in sequence on one card (f32, TF32 off, 1e-5);
    16c phi3-mini-3.8b at published widths on (data, model) = (2, 2)
    (four cards; (1, n) otherwise) by the production rules: cut to depth
    2 in f32, against one card's unsharded run: every gathered gradient
    leaf at 1e-4, then two train steps' loss, nll and gradient norm at
    rel 1e-5 and every moment after them at 1e-4, and every parameter
    and moment at 1e-4 after two steps with AdamW's eps at 1e-3; full
    depth in bf16 with remat, global B 4 x |data| x S 2048 (each data
    rank 15b's B 4), a step with its collectives recorded and
    three timed steps (ms, tokens/s, peak memory a card), the first
    loss within 2e-2 of the unsharded loss of the same batch (15b's
    first loss on one card); and the depth-2 state saved from that mesh
    and restored by ``restore(shardings=)`` on (1, n), parameters and
    moments bit for bit; 16d granite-3-8b at published widths (caches
    head-sharded on model 2 on four cards): 8 prompts of 512 prefilled,
    8 decode steps on sharded caches, the logits within rel 3e-2 of the
    same run unsharded on one card, ms a decode step; 16e a kernel
    wrapper given a DTensor raises, and 16c / 16d launch no kernel (the
    plain versions: ``qchunk`` attention, dense decode attention); 16f
    Jamba-1.5-Large cut to depth 4 with its 16 experts, unplaced on card
    0 and placed with the routes replayed: kept masks, positions, aux and
    logits, and each layer's mixer and FFN output placed vs unplaced a
    call (:class:`ResidualTaps`), and on four cards the full period;
    under ``--phase16`` also the first Mamba mixer product by product
    (:class:`MambaTaps`) and its matmuls at four cards' shards on card 0
    (:func:`mamba_product_split`).

The last three lines are the card's name and power limit (from
``nvidia-smi``), a JSON line with every kernel's numbers -- one entry
per kernel and path (``path``: ``paper_report``, ``kv_zn540`` and
``fleet_sweep_zn540`` for the two fused ``zns_alloc`` selections, the
Pallas contract and phase 14's legacy ALLOCs for its row kernel,
granite-3-8b, the Jamba cut, the llama4-scout cut and the deepseek-v2
cut, llama-3.2-vision-11b and seamless-m4t-medium for the serving
kernels, phase 14 for ``page_clock``, phase 17 for the fused selections
and ``page_clock``, xlstm-125m for the two xLSTM
scans), each with that
path's launches and the times at its shapes -- and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peak rates (NVIDIA data sheet) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12            # non-tensor-core 32-bit rate
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor-core rate
#: the scan's issue floor.  Per SM and clock, compute capability 9.0
#: issues one warp instruction on each of its 4 schedulers (128 lane-
#: instructions, which is also the f32 pipes' width) and computes 16 ex2
#: on its special-function units (CUDA C++ Programming Guide, "Arithmetic
#: Instructions" throughput table), on 132 SMs at the clock the data
#: sheet's f32 rate implies, 67e12 / (132 SMs x 128 lanes x 2 flops per
#: FMA) = 1.983 GHz
SMS = 132
LANES_PER_SM_PER_CLOCK = 128
SFU_EX2_PER_SM_PER_CLOCK = 16
SM_CLOCK_HZ = OPS_PER_S / (SMS * LANES_PER_SM_PER_CLOCK * 2)
#: an exp2 on the f32 pipes instead of the SFU: round to an integer, one
#: subtract, a degree-3 polynomial (3 FMAs), a shift and an integer add
#: into the exponent field -- 7 instructions
EXP_POLY_INSTRUCTIONS = 7
FLEET_LANES = 128

#: the serving slice: granite-3-8b, 8 prompts of 512 tokens, 32 tokens out
SERVE_ARGS = ["--arch", "granite-3-8b", "--batch", "8", "--prompt-len",
              "512", "--decode-tokens", "32", "--device", "cuda"]
GRANITE_PARAMS = 8_171_884_544
#: every kernel vs its plain version: the reference's tol(dtype) on rel_err
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2.5e-2}
#: the chunkwise mLSTM kernel's share of h's bf16 values that may differ
#: from the stepped plain version's (and from its own plain version's),
#: on a case of at least FLIP_MIN_VALUES values.  h's own rounding fills
#: KERNEL_TOL, so the rel err cannot see the operand precision; the flip
#: rate can: at the served shape the kernel's hi/mid/lo triples flip
#: 2.4e-4, hi/lo pairs 2.0e-3 and one bf16 rounding 0.40
#: (tools/mlstm_operands.py), and 7f holds the pairs above this bar
CHUNKWISE_FLIP_TOL = 1e-3
FLIP_MIN_VALUES = 100_000
#: kernel path vs plain path through 40 bf16 layers: the two attention
#: outputs differ by an ulp of bf16 here and there, and every layer
#: rounds its residual stream to bf16 again.  For an MoE stack it holds
#: under replayed routes (phases 9c, 9d): routing is discontinuous, so an ulp
#: in an attention output may flip a near-tied expert choice, and the
#: check is of the kernels, not of the router
SERVE_TOL = 5e-2
#: 9g against the f32 reference: the served xLSTM path's error at most
#: this many times the bf16 plain path's
F32_RATIO = 1.5
#: the Mamba slice: 8 prompts of 2048 tokens, 32 tokens out
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_TOKENS = 8, 2048, 32
JAMBA_PARAMS = 8_462_049_280
#: the MoE slice: llama4-scout's one-card cut, 8 prompts of 512 tokens,
#: 32 tokens out
LLAMA4_BATCH, LLAMA4_PROMPT, LLAMA4_TOKENS = 8, 512, 32
LLAMA4_PARAMS = 36_269_102_080
#: the MLA slice: deepseek-v2's one-card cut, 8 prompts of 512 tokens, 32
#: tokens out
DEEPSEEK_BATCH, DEEPSEEK_PROMPT, DEEPSEEK_TOKENS = 8, 512, 32
DEEPSEEK_PARAMS = 36_611_322_880
#: phase 7c: deepseek-v2's routed layer, run twice at a prefill-sized and
#: a decode-sized call, and held to a CPU run of the same function at
#: MOE_CPU_TOKENS; only an f32 near-tie (a gap under ROUTE_FLIP_MARGIN
#: between the chosen and the next probability) may route differently
MOE_REPEAT_TOKENS = (4096, 8)
MOE_CPU_TOKENS = 512
ROUTE_FLIP_MARGIN = 1e-5
#: the cross-attention slice: both models as published, 8 prompts of 512
#: tokens, 32 tokens out, the memory at the reference's memory_len (the
#: 4k cell for the audio model's frames)
CROSS_BATCH, CROSS_PROMPT, CROSS_TOKENS = 8, 512, 32
#: phases 8g-10g: xlstm-125m as published
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_TOKENS = 8, 2048, 32
XLSTM_PARAMS = 145_044_480
CROSS_CELL = "train_4k"
VISION_PARAMS = 9_585_397_760
SEAMLESS_PARAMS = 614_854_656


#: op steps of each dispatch prefix profiled under ``torch.profiler``
#: (phases 6, 11 and 13): the profiler's decoding is most of a window's
#: time, and the rates it gives are per op step (64 until the script
#: passed 1,200 s on a slow host, 256 and 192 before that)
PROFILED_STEPS = 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class Laps:
    """The seconds since the script started, logged at each phase's end
    on standard output and on standard error, so that a run stopped at
    its time limit still shows in its error's tail where the time went."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        msg = (f"lap: {what} {now - self.last:.1f} s, "
               f"{now - self.t0:.1f} s in all")
        self.last = now
        log(msg)
        print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------- #
# phase 2: kernel vs plain version
# --------------------------------------------------------------------- #
def random_rows(torch, rng, L, G, W, take, dev):
    """A selection batch: wear spread like a worn device, availability
    codes mixed, ragged eligibility, both ``by_wear`` values, a
    ``take_eff`` in [0, take] and a ``per_group_eff`` in [1, W]."""
    import numpy as np
    wear = rng.integers(0, 3000, (L, G, W)).astype(np.int32)
    wear[:, :, ::7] = 5                       # ties on wear
    avail = rng.choice([0, 1, 2, 3], (L, G, W),
                       p=[0.4, 0.2, 0.2, 0.2]).astype(np.int32)
    elig = (rng.random((L, G)) < 0.85).astype(np.int32)
    by_wear = (np.arange(L) % 2).astype(np.int32)
    take_eff = rng.integers(0, take + 1, L).astype(np.int32)
    pge = rng.integers(1, W + 1, L).astype(np.int32)
    pge[0] = W
    return [torch.from_numpy(a).to(dev) for a in
            (wear, avail, elig, by_wear, take_eff, pge)]


def compare_kernel(torch, ops, ref, args, take) -> float:
    got = ops.zns_alloc_rows(*args, take=take, with_sel=True)
    want = ref.zns_alloc_rows_ref(*args, take=take)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("cols", "ok", "cost", "sel"), got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"kernel {name} dtype/shape {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        check(torch.equal(a, b),
              f"kernel {name} differs from its plain version at shape "
              f"{tuple(args[0].shape)} take {take}")
        finite = torch.isfinite(b.float())
        check(torch.equal(finite, torch.isfinite(a.float())),
              f"kernel {name} inf pattern differs")
        err = max(err, float((a.float() - b.float())[finite].abs().max())
                  if finite.any() else 0.0)
    return err


def random_lanes(torch, np, rng, L, G, W, take, ZG, P, n_zones, dev):
    """A lane batch for the fused selections: element arrays of a
    ``G`` x ``W`` grid plus its scratch slot, with wear spans from flat
    (cost ties) to wide and availability from all free to all busy (no
    feasible group); lanes mixing policies, wear-aware and first fit,
    wear bounds 0 to unbounded, ragged (union) group counts and widths,
    hints from 0 up; a zone column map, zones and grow counts."""
    n = G * W + 1
    span = rng.choice([1, 4, 60, 5000], L)
    wear = (rng.random((L, n)) * span[:, None]).astype(np.int32)
    p_free = rng.choice([0.0, 0.05, 0.5, 1.0], L)
    avail = np.where(rng.random((L, n)) < p_free[:, None], rng.choice(
        [0, 3], (L, n)), rng.choice([1, 2], (L, n))).astype(np.int32)
    zg = rng.integers(1, ZG + 1, L)
    ng = np.maximum(zg, rng.integers(1, G + 1, L))
    dtake = rng.integers(1, take + 1, L)
    lanes = np.stack([
        np.where(rng.random(L) < 0.7, W, rng.integers(1, W + 1, L)),
        ng, zg, rng.integers(1, dtake + 1), rng.integers(0, 2, L),
        rng.integers(0, 2, L), rng.choice([0, 1, 3, 2**30], L),
        rng.integers(1, 300, L), dtake, P // zg], 1).astype(np.int32)
    programs = np.zeros((L, 5, 4), np.int32)
    programs[:, 2, 2] = np.where(rng.random(L) < 0.3, 0,
                                 rng.integers(1, 4000, L))
    zone_cols = rng.integers(0, G * (P // zg.min()), (L, n_zones, P))
    out = {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for name, a in (("wear", wear), ("avail", avail),
                           ("lanes", lanes),
                           ("rr", rng.integers(0, ng).astype(np.int32)),
                           ("zone_cols", zone_cols.astype(np.int32)),
                           ("zone", rng.integers(0, n_zones, L).astype(
                               np.int32)),
                           ("k", rng.integers(-2, take + 1, L).astype(
                               np.int32)))}
    out["hint"] = torch.from_numpy(programs).to(dev)[:, 2, 2]
    return out


def compare_fused(torch, ops, ref, b, dims) -> int:
    """Both fused selections against their plain versions, every output
    bit for bit; returns the largest absolute difference (0)."""
    kw = dict(zip(("n_groups", "per_group", "take", "zone_groups"), dims))
    before = dict(ops.counts)
    got = ops.alloc_select(b["wear"], b["avail"], b["lanes"], b["rr"],
                           b["hint"], **kw)
    want = ref.alloc_select_ref(b["wear"], b["avail"], b["lanes"], b["rr"],
                                b["hint"], **kw)
    got_g = ops.grow_select(b["wear"], b["avail"], b["lanes"],
                            b["zone_cols"], b["zone"], b["k"], **kw)
    want_g = ref.grow_select_ref(b["wear"], b["avail"], b["lanes"],
                                 b["zone_cols"], b["zone"], b["k"], **kw)
    torch.cuda.synchronize()
    check(ops.counts["alloc_select"] == before["alloc_select"] + 1
          and ops.counts["grow_select"] == before["grow_select"] + 1,
          "fused launches not counted")
    err = 0
    for kind, g, w in (("alloc_select", got, want),
                       ("grow_select", got_g, want_g)):
        for name, a, e in zip(("win/eids", "eids/feasible", "feasible",
                               "rr_next", "rank_lim"), g, w):
            check(a.dtype == e.dtype and a.shape == e.shape,
                  f"{kind} {name} differs from its plain version in dtype "
                  f"or shape at {tuple(b['wear'].shape)} dims {dims}")
            if a.numel():
                err = max(err, int((a.long() - e.long()).abs().max()))
            check(torch.equal(a, e),
                  f"{kind} {name} differs from its plain version at "
                  f"{tuple(b['wear'].shape)} dims {dims}")
    return err


def phase_kernel(torch, np, ops, ref, engine, fleet_dyn, fleet_cfg) -> float:
    rng = np.random.default_rng(2025)
    dev = "cuda"
    err = 0.0
    shapes = [(2, 4, 1056, 22), (12, 4, 1056, 22),
              (FLEET_LANES, 4, 1056, 22), (2, 4, 48, 1),
              (FLEET_LANES, 4, 48, 1)]
    for _ in range(12):
        W = int(rng.integers(1, ops.MAX_WIDTH + 1))
        shapes.append((int(rng.integers(1, 10)), int(rng.integers(1, 8)),
                       W, int(rng.integers(1, min(W, ops.MAX_TAKE) + 1))))
    for L, G, W, take in shapes:
        err = max(err, compare_kernel(
            torch, ops, ref, random_rows(torch, rng, L, G, W, take, dev),
            take))
    # the fused selections: random lane batches, then the zn540 grid
    # under the 128-lane fleet's own lane table
    fused = [(6, 4, 1056, 22, 4, 4, 48), (9, 32, 40, 7, 5, 8, 3),
             (5, 3, 33, 33, 3, 3, 2), (4, 2, 300, 64, 2, 4, 5),
             (FLEET_LANES, 4, 1056, 22, 4, 4, 48)]
    for _ in range(12):
        G = int(rng.integers(1, ops.MAX_GROUPS + 1))
        W = int(rng.integers(1, 1100))
        fused.append((int(rng.integers(1, 20)), G, W,
                      int(rng.integers(1, min(W, ops.MAX_TAKE) + 1)),
                      int(rng.integers(1, G + 1)), int(rng.integers(1, 9)),
                      int(rng.integers(1, 40))))
    for L, G, W, take, ZG, P, Z in fused:
        if ops._fused_smem(G, W, take) > ops.MAX_SMEM:
            continue
        compare_fused(torch, ops, ref, random_lanes(
            torch, np, rng, L, G, W, take, ZG, max(P, ZG), Z, dev),
            (G, W, take, ZG))
    ln = engine._lanes(fleet_cfg, engine._lane_dyn(
        fleet_cfg, fleet_dyn, FLEET_LANES, torch.device(dev)))
    zn540 = random_lanes(torch, np, rng, FLEET_LANES, fleet_cfg.n_groups,
                         fleet_cfg.per_group, fleet_cfg.take,
                         fleet_cfg.zone_groups, fleet_cfg.parallelism,
                         fleet_cfg.n_zones, dev)
    zn540["lanes"] = ln.sel
    compare_fused(torch, ops, ref, zn540, (
        fleet_cfg.n_groups, fleet_cfg.per_group, fleet_cfg.take,
        fleet_cfg.zone_groups))
    # the Pallas contract on the card
    for G, W, take in [(4, 1056, 22), (3, 33, 5), (16, 256, 8)]:
        wear, avail, elig = random_rows(torch, rng, 1, G, W, take, dev)[:3]
        sel, feasible = ops.zns_alloc(wear[0], avail[0], elig[0],
                                      take=take)
        s_ref, ok = ref.zns_alloc_ref(wear[0], avail[0], elig[0],
                                      take=take)
        want = bool(((ok >= take) | (elig[0] == 0)).all())
        check(torch.equal(sel, s_ref.bool()) and bool(feasible) == want,
              f"zns_alloc contract differs at {(G, W, take)}")
    log(f"phase 2: zns_alloc kernels == plain versions, bit for bit "
        f"(tolerance 0): the row selection on {len(shapes)} shapes, the "
        f"fused ALLOC and grow selections on {len(fused) + 1} lane batches "
        f"(the last the zn540 grid under the fleet's lane table), the "
        f"Pallas contract on 3 (max_abs_err {err})")
    return err


# --------------------------------------------------------------------- #
# phases 3-4: the main path and the CPU twin
# --------------------------------------------------------------------- #
def check_report(rep: dict, bench: dict) -> None:
    for fig in ("dlwa", "wear"):
        for key, value in bench[fig].items():
            check(rep[fig][key] == value,
                  f"{fig}.{key}: {rep[fig][key]!r} != {value!r}")
    for key, value in bench["exec"].items():
        got = rep["exec"][key]
        if key in ("traditional_s", "silent_s", "speedup"):
            check(abs(got - value) <= 1e-5 * abs(value),
                  f"exec.{key}: {got!r} vs {value!r} (rel 1e-5)")
        else:
            check(got == value, f"exec.{key}: {got!r} != {value!r}")


def headline_batches(headline, workloads, eng):
    """The programs and lane configs of the headline's three figure
    dispatches, at ``paper_report``'s defaults."""
    import numpy as np
    occ = headline.DEFAULT_OCCUPANCIES
    dlwa = np.stack([p for o in occ for p in (workloads.dlwa_program(
        eng, occupancy=o, n_zones=4),) * 2])
    wear = headline._churn_program(eng, occupancy=0.3, n_zones=8, cycles=8)
    exe = headline._churn_program(eng, occupancy=0.3, n_zones=8, cycles=4)
    return [("dlwa", dlwa, headline._policy_dyns(eng, len(occ))),
            ("wear", np.stack([wear, wear]), headline._policy_dyns(eng, 1)),
            ("exec", np.stack([exe, exe]), headline._policy_dyns(eng, 1))]


def fleet_batch(headline, engine, eng):
    """64 traditional/silent lane pairs of the RESET-churn program at
    four occupancies, with mixed capacity shrinks and wear bounds."""
    import numpy as np
    zp = eng.cfg.zone_pages
    trad_spec = headline.traditional_spec(eng.zone_geom)
    programs, dyns = [], []
    for k in range(FLEET_LANES // 2):
        occ = (0.1, 0.2, 0.3, 0.4)[k % 4]
        prog = headline._churn_program(eng, occupancy=occ, n_zones=8,
                                       cycles=4)
        shrink = (None, zp * 3 // 4, zp // 2, None)[(k // 4) % 4]
        bound = (None, 0, 2, 8)[(k // 16) % 4]
        programs += [prog, prog]
        dyns += [eng.dyn(spec=trad_spec, zone_pages=shrink),
                 eng.dyn(spec=headline.BLOCK, alloc_policy="silent",
                         wear_bound=bound, zone_pages=shrink)]
    return np.stack(programs), engine.stack_dyn(dyns)


def assert_same_run(torch, name, gpu, cpu) -> None:
    for kind, a, b in (("state", gpu[0], cpu[0]), ("trace", gpu[1],
                                                    cpu[1])):
        for field in type(a)._fields:
            x, y = getattr(a, field).cpu(), getattr(b, field)
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{name}: {kind}.{field} differs between cuda and cpu")


# --------------------------------------------------------------------- #
# phase 6: timing
# --------------------------------------------------------------------- #
def cuda_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_timing(torch, np, ops, ref, L, G, W, take) -> dict:
    """The row selection (the Pallas contract's kernel) at a zn540 grid:
    the kernel, its plain version and ``torch.topk`` of the same keys."""
    rng = np.random.default_rng(L * 7 + W)
    args = random_rows(torch, rng, L, G, W, take, "cuda")
    args[3].fill_(1)                           # the wear-aware key
    args[5].fill_(W)
    key = ((args[0].long() << 32) | torch.arange(W, device="cuda")).where(
        ((args[1] == 0) | (args[1] == 3)) & (args[2] != 0)[..., None],
        (1 << 62) | torch.arange(W, device="cuda")).reshape(L * G, W)
    before = dict(ops.counts)
    ms = cuda_ms(torch, lambda: ops.zns_alloc_rows(*args, take=take))
    dev_us = device_us(torch, lambda: ops.zns_alloc_rows(*args, take=take),
                       "rows_kernel", reps=50)
    ops.counts.update(before)                  # timing launches not counted
    plain_ms = cuda_ms(torch, lambda: ref.zns_alloc_rows_ref(*args,
                                                             take=take))
    library_ms = cuda_ms(torch, lambda: torch.topk(key, take, dim=1,
                                                   largest=False,
                                                   sorted=True))
    rows = L * G
    # each input read once, each output written once
    bytes_moved = (2 * 4 * rows * W + 4 * rows + 3 * 4 * L
                   + 4 * rows * take + 4 * rows + 4 * rows)
    # one key build and one compare per column and selection, whatever
    # the design
    return dict(bound(bytes_moved, 2 * rows * W), shape=[L, G, W],
                take=take, ms=ms, device_us=dev_us, plain_ms=plain_ms,
                library_ms=library_ms)


def bound(bytes_moved: int, ops_done: int) -> dict:
    """The least time for ``bytes_moved`` at the memory rate and
    ``ops_done`` 32-bit operations at the f32/int32 rate."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_done / OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "ops": ops_done}


def fused_timing(torch, np, ops, ref, engine, eng, dyn, seed) -> dict:
    """Both fused selections at the zn540 grid under the lane table of
    ``dyn`` (one lane each): the kernel's time a call (CUDA events over
    back-to-back calls) and a launch (``torch.profiler``), the plain
    version's, and the bound from these inputs.  Before any timing, both
    kernels are held bit for bit against their plain versions on the same
    inputs (``max_abs_err``, 0), and the run fails on any difference.  No
    PyTorch call computes either selection, so there is no library
    time."""
    cfg = eng.cfg
    L = dyn.zone_pages.shape[0]
    rng = np.random.default_rng(seed)
    b = random_lanes(torch, np, rng, L, cfg.n_groups, cfg.per_group,
                     cfg.take, cfg.zone_groups, cfg.parallelism,
                     cfg.n_zones, "cuda")
    # a worn device with most elements free, as mid-run
    b["wear"] = torch.from_numpy(rng.integers(0, 8, tuple(
        b["wear"].shape)).astype(np.int32)).cuda()
    b["avail"] = torch.from_numpy(np.where(rng.random(tuple(
        b["avail"].shape)) < 0.7, 0, 1).astype(np.int32)).cuda()
    b["lanes"] = engine._lanes(cfg, engine._lane_dyn(
        cfg, dyn, L, torch.device("cuda"))).sel
    # every zone on the lane's first zone_groups groups, its column c on
    # LUN c, as ALLOC writes the map
    b["zone_cols"] = torch.arange(
        cfg.parallelism, dtype=torch.int32, device="cuda").expand(
        L, cfg.n_zones, cfg.parallelism).contiguous()
    b["k"].fill_(cfg.take)
    kw = dict(n_groups=cfg.n_groups, per_group=cfg.per_group,
              take=cfg.take, zone_groups=cfg.zone_groups)
    # the kernels against their plain versions on these very inputs
    before = dict(ops.counts)
    err = compare_fused(torch, ops, ref, b, (
        cfg.n_groups, cfg.per_group, cfg.take, cfg.zone_groups))
    ops.counts.update(before)
    calls = {
        "alloc_select": (
            lambda: ops.alloc_select(b["wear"], b["avail"], b["lanes"],
                                     b["rr"], b["hint"], **kw),
            lambda: ref.alloc_select_ref(b["wear"], b["avail"], b["lanes"],
                                         b["rr"], b["hint"], **kw)),
        "grow_select": (
            lambda: ops.grow_select(b["wear"], b["avail"], b["lanes"],
                                    b["zone_cols"], b["zone"], b["k"], **kw),
            lambda: ref.grow_select_ref(b["wear"], b["avail"], b["lanes"],
                                        b["zone_cols"], b["zone"], b["k"],
                                        **kw))}
    # the rows this run's lanes select: a silent lane ranks every group
    # once; a traditional lane selects its window, and every group again
    # when the window fails; a grow selects the zone's groups
    f = dict(zip(ref.LANE_FIELDS, b["lanes"].cpu().numpy().T))
    w2, a2 = ref._grids(b["wear"], b["avail"], cfg.n_groups, cfg.per_group)
    rr_rows = 0
    for lane in range(L):
        if f["silent"][lane]:
            continue
        g = [(int(b["rr"][lane]) + p) % f["n_groups"][lane]
             for p in range(f["zone_groups"][lane])]
        free = ((a2[lane, g] == 0) | (a2[lane, g] == 3))[
            :, :f["per_group"][lane]].sum(1)
        rr_rows += len(g) + cfg.n_groups * int(
            bool((free < f["take_eff"][lane]).any()))
    rows = {"alloc_select": rr_rows + cfg.n_groups * int(
        f["silent"].sum()), "grow_select": int(f["zone_groups"].sum())}
    grid = 2 * 4 * cfg.n_groups * cfg.per_group
    outs = {"alloc_select": 4 * cfg.zone_groups * (cfg.take + 1) + 4 * 2 + 1,
            "grow_select": 4 * cfg.zone_groups * cfg.take + 1}
    names = {"alloc_select": "alloc_select_kernel",
             "grow_select": "grow_select_kernel"}
    out = {}
    for name, (kernel, plain) in calls.items():
        before = dict(ops.counts)
        ms = cuda_ms(torch, kernel)
        dev_us = device_us(torch, kernel, names[name], reps=50)
        ops.counts.update(before)
        plain_ms = cuda_ms(torch, plain, iters=10)
        # each lane's grid read once (wear and availability), its table
        # row, window start and hint (or zone map row, zone and count),
        # the outputs written once
        bytes_moved = L * (grid + 4 * len(ref.LANE_FIELDS) + 8
                           + outs[name]) + (
            L * 4 * cfg.parallelism if name == "grow_select" else 0)
        out[name] = dict(bound(bytes_moved, 2 * rows[name] * cfg.per_group),
                         ms=ms, device_us=dev_us, plain_ms=plain_ms,
                         library_ms=None, lanes=L, rows=rows[name],
                         max_abs_err=err)
    return out


def empty_timing(torch, ops) -> dict:
    """An empty kernel through the same ctypes route: the host's time a
    call (back-to-back, CUDA events) and the device's a launch -- the
    practical floor of any small kernel here."""
    ms = cuda_ms(torch, ops.empty_launch, iters=200)
    dev_us = device_us(torch, ops.empty_launch, "empty_kernel", reps=200)
    return {"ms": ms, "device_us": dev_us}


def profile_dispatch(torch, eng, programs, dyn, obs=None) -> dict:
    """One dispatch (with telemetry ``obs`` when given) under
    ``torch.profiler``: the card's busy time (the sum of its kernel and
    copy spans, which do not overlap on one stream) against the wall
    time, and the ``zns_alloc`` kernel's own device time.  The profiler's
    host cost inflates the wall time, so the busy share is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile
    eng.run_batch(eng.init_state(), programs, dyn, obs=obs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_batch(eng.init_state(), programs, dyn, obs=obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    out = {"wall_us": wall_us, "busy_us": busy_us,
           "device_events": len(device)}
    for name in ("alloc_select_kernel", "grow_select_kernel"):
        kern = [e.time_range.elapsed_us() for e in device
                if name in e.name]
        out[name] = (len(kern), sum(kern) / len(kern) if kern else None)
    return out


def profile_dispatches(ops, deferred: list) -> None:
    """Run the profiled dispatches that phases 6, 11 and 13 set aside,
    in order, each logging under its phase, with the zns_alloc counts
    as they were.  They run after every :func:`device_us` window: after
    profiled windows of ~10^5 device events each (105k here in phase 6,
    140k in phase 11), the process's later windows of a few launches
    came back without device events, while their host events were all
    there."""
    before = dict(ops.counts)
    t0 = time.perf_counter()
    for profiled in deferred:
        profiled()
    ops.counts.update(before)
    log(f"phases 6-13's profiled dispatches took "
        f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- #
# phases 11-12: the key-value storage path
# --------------------------------------------------------------------- #
def kv_recorders(S, eng, p: dict) -> dict:
    """One class-tagged recorder per workload of the KV dispatch, with the
    golden file's parameters ``p`` (those of the reference's
    ``tools/bench.py`` trace recorders, the LSM at 70 flushes)."""
    recs = {}
    for name in ("lsm", "ckpt", "cache"):
        classes = S.WORKLOADS[name]
        rec = S.RecordingBackend(
            eng.flash, zone_pages=eng.cfg.zone_pages, n_zones=p["n_zones"],
            max_active=p["max_active"],
            class_tenants={c: i for i, c in enumerate(classes)})
        if name == "lsm":
            cfg = S.scaled_kv_config(
                rec.zone_pages, eng.flash.page_bytes, seed=p["lsm"]["seed"],
                n_flushes=p["lsm"]["n_flushes"],
                max_jobs=S.compile._lsm_jobs(rec))
            sim = S.LSMSimulator(S.ZoneFS(rec), cfg)
            sim.run()
            check(not sim.failed, "the KV LSM recording failed to place "
                  "a file")
        elif name == "ckpt":
            S.record_checkpoints(rec, S.CheckpointSchedule(**p["ckpt"]))
        else:
            S.record_cache(rec, **p["cache"])
        recs[name] = rec
    return recs


def sha256(np, a) -> str:
    """sha256 of an integer array's int32 (bool: uint8) C-order bytes."""
    import hashlib
    a = np.asarray(a)
    a = a.astype(np.uint8 if a.dtype == np.bool_ else np.int32)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


#: the report keys that are times (or their ratio): held at rel 1e-5
KV_TIME_KEYS = {"makespan_s", "mean_latency_s", "p50_latency_s",
                "p99_latency_s", "max_latency_s", "p99_over_p50"}


def check_golden(got, want, where: str, key: str = "") -> None:
    """``got`` equals ``want``: times at rel 1e-5, the rest exactly."""
    if isinstance(want, dict):
        check(sorted(got) == sorted(want), f"{where}: keys differ")
        for k in want:
            check_golden(got[k], want[k], f"{where}.{k}", k)
    elif isinstance(want, list):
        check(len(got) == len(want), f"{where}: lengths differ")
        for i, (a, b) in enumerate(zip(got, want)):
            check_golden(a, b, f"{where}[{i}]", key)
    elif key in KV_TIME_KEYS:
        check(abs(got - want) <= 1e-5 * abs(want),
              f"{where}: {got!r} vs {want!r} (rel 1e-5)")
    else:
        check(got == want, f"{where}: {got!r} != {want!r}")


def phase_kv(torch, np, S, headline, ops, golden: dict,
             deferred: list) -> dict:
    """Phase 11: record six zn540 lanes (lsm, ckpt, cache, each on a
    traditional whole-zone lane and a silent BLOCK lane), replay them as
    ONE dispatch on the card, hold every lane to the reference's golden
    summary, and count the zns_alloc launches of that dispatch."""
    from repro_torch.core.elements import BLOCK
    from repro_torch.core.engine import stack_dyn
    p = golden["params"]
    eng = headline.build_headline_engine(device="cuda")
    t0 = time.perf_counter()
    recs = kv_recorders(S, eng, p)
    record_s = time.perf_counter() - t0
    trad = eng.dyn(spec=headline.traditional_spec(eng.zone_geom))
    silent = eng.dyn(spec=BLOCK, alloc_policy="silent")
    labels = [(name, policy) for name in recs
              for policy in ("traditional", "silent")]
    lanes = [recs[name] for name, _ in labels]
    dyns = [trad if policy == "traditional" else silent
            for _, policy in labels]
    # the runner's engine dispatch, timed and kept for its op traces
    dispatched = {}
    run_batch = eng.run_batch

    def timed_run_batch(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_batch(*args, **kw)
        torch.cuda.synchronize()
        dispatched.update(out=out, s=time.perf_counter() - t0)
        return out
    eng.run_batch = timed_run_batch
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = S.replay_recorders(eng, lanes, dyns=dyns, n_tenants=p["n_tenants"],
                             pad_quantum=p["pad_quantum"], check=True,
                             sanitize=True)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    counts = dict(ops.counts)
    eng.run_batch = run_batch
    states, trace = dispatched["out"]
    steps = int(res.programs.shape[1])
    check(steps == golden["op_steps"],
          f"KV dispatch has {steps} op steps, the golden file "
          f"{golden['op_steps']}")
    check(counts == {"alloc_select": steps, "grow_select": steps,
                     "rows": 0},
          f"KV dispatch launched {counts}, want {steps} each of "
          f"alloc_select and grow_select over {steps} op steps")
    got = []
    for k, (name, policy) in enumerate(labels):
        got.append({
            "workload": name, "policy": policy, "n_ops": len(lanes[k]),
            "program_sha256": sha256(np, lanes[k].program()),
            "state_sha256": {f: sha256(np, getattr(states, f)[k].cpu())
                             for f in type(states)._fields},
            "trace_sha256": {f: sha256(np, getattr(trace, f)[k].cpu())
                             for f in type(trace)._fields},
            "metrics": S.lane_metrics(eng, res, k),
            "makespan_s": float(res.makespans[k]),
            "classes": res.tenant_class_report(
                lanes=[k], names=list(S.WORKLOADS[name]))})
    check_golden(got, golden["lanes"], "kv_zn540")
    dispatch_s = dispatched["s"]
    log(f"phase 11: KV storage dispatch at zn540 == "
        f"tests/data/torch_kv_zn540.json (6 lanes x {steps} op steps; "
        f"programs, every state and trace field, metrics exactly; "
        f"makespans and class latencies at rel 1e-5); zns_alloc launches "
        f"{counts}: 1 alloc_select + 1 grow_select per op step")
    log(f"phase 11: recorded {sum(len(r) for r in recs.values())} ops in "
        f"{record_s:.3f} s; engine dispatch {dispatch_s:.3f} s on cuda = "
        f"{len(lanes) * steps / dispatch_s:.1f} lane-ops/s "
        f"({dispatch_s / steps * 1e3:.3f} ms per op step); replay_recorders "
        f"with timing, checks and sanitizer {replay_s:.3f} s")
    log("phase 11: lane | n_ops | DLWA | block erases | makespan s | "
        "alloc_calls")
    for lane in got:
        m = lane["metrics"]
        log(f"phase 11: {lane['workload']} / {lane['policy']} | "
            f"{lane['n_ops']} | {m['dlwa']!r} | {m['block_erases']!r} | "
            f"{lane['makespan_s']!r} | {m['alloc_calls']!r}")
    for name in recs:
        t, s_ = [lane for lane in got if lane["workload"] == name]
        ratio = {key: (s_v / t_v if t_v else None) for key, s_v, t_v in (
            ("dlwa", s_["metrics"]["dlwa"], t["metrics"]["dlwa"]),
            ("erases", s_["metrics"]["block_erases"],
             t["metrics"]["block_erases"]),
            ("makespan", s_["makespan_s"], t["makespan_s"]))}
        log(f"phase 11: {name} silent/traditional: {ratio}")
    out = {"eng": eng, "dyn": stack_dyn(dyns), "counts": counts,
           "dispatch_s": dispatch_s, "steps": steps, "recs": recs,
           "lanes": {(lane["workload"], lane["policy"]): lane["metrics"]
                     for lane in got}}

    # a PROFILED_STEPS prefix of the same batch under the profiler,
    # taken with the other profiled dispatches (see profile_dispatches)
    def profiled():
        prefix = res.programs[:, :PROFILED_STEPS]
        prof = out["prof"] = profile_dispatch(torch, eng, prefix, out["dyn"])
        check(prof["device_events"] > 0,
              "phase 11: the profiled KV prefix holds no device event")
        log(f"phase 11: profiled a {prefix.shape[1]}-op-step prefix of the "
            f"KV batch ({prefix.shape[0]} lanes): wall "
            f"{prof['wall_us']:.1f} us, device busy {prof['busy_us']:.1f} "
            f"us ({prof['busy_us'] / prof['wall_us']:.4f} of wall), "
            f"{prof['device_events'] / prefix.shape[1]:.1f} device events "
            f"per op step; alloc_select (launches, us each) "
            f"{prof['alloc_select_kernel']}, grow_select "
            f"{prof['grow_select_kernel']}")
    deferred.append(profiled)
    return out


def phase_shim(torch, np, S) -> None:
    """Phase 12: ZoneFS + the LSM simulator over the device shim on the
    card and on the CPU must agree, and a recorder's replay of the same
    traffic on the card must give the shim's DLWA."""
    from repro_torch.core.device import ZNSDevice
    from repro_torch.core.elements import BLOCK
    from repro_torch.core.geometry import zn540
    out = {}
    for dev_name in ("cuda", "cpu"):
        dev = ZNSDevice(*zn540(), BLOCK, device=dev_name)
        cfg = S.scaled_kv_config(dev.zone_pages, dev.flash.page_bytes,
                                 seed=0, n_flushes=8,
                                 max_jobs=S.compile._lsm_jobs(dev))
        if dev_name == "cuda":
            dev.warmup_alloc()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = S.LSMSimulator(S.ZoneFS(dev), cfg).run()
        secs = time.perf_counter() - t0
        out[dev_name] = (rep, dev, secs)
    (rep, dev, secs), (cpu_rep, cpu_dev, cpu_secs) = out["cuda"], out["cpu"]
    check(rep == cpu_rep, f"phase 12: report() differs: {rep} vs {cpu_rep}")
    for name in ("dlwa", "host_pages", "dummy_pages", "block_erases",
                 "alloc_calls"):
        check(getattr(dev, name) == getattr(cpu_dev, name),
              f"phase 12: {name} differs between cuda and cpu")
    for name in ("elem_wear", "elem_avail", "elem_pages", "elem_zone"):
        check(np.array_equal(getattr(dev, name), getattr(cpu_dev, name)),
              f"phase 12: {name} differs between cuda and cpu")
    # the same traffic recorded and replayed as one program on the card
    rec = S.RecordingBackend.for_engine(dev.engine)
    S.LSMSimulator(S.ZoneFS(rec), cfg).run()
    check(rec.dlwa == dev.dlwa and rec.dummy_pages == dev.dummy_pages,
          f"phase 12: replayed DLWA {rec.dlwa!r} != shim's {dev.dlwa!r}")
    n = len(rec)
    log(f"phase 12: ZoneFS + LSM over ZNSDevice(zn540, BLOCK): cuda == cpu "
        f"(report, counters, element state), DLWA {dev.dlwa!r}; the "
        f"recorder's one-program replay on cuda gives the same DLWA; "
        f"{n} commands: {secs / n * 1e3:.3f} ms a command on cuda, "
        f"{cpu_secs / n * 1e3:.3f} ms on cpu")


# --------------------------------------------------------------------- #
# phase 13: the allocator design-space search at zn540
# --------------------------------------------------------------------- #
#: phase 13's workloads: the reference's tools/bench.py full mode
#: (bench_fleet, _obs_overhead, _evaluator_recompiles, _bench_array) on
#: zn540 with 14 active zones; the telemetry overhead takes 1 paired
#: timing where the reference takes 9, and the launch-plan check 2
#: generations where it takes 4 (3 and 4 until the script passed 1,200 s
#: on a slow host)
FLEET_PARAMS = {
    "device": "zn540", "max_active": 14, "n_devices": 4,
    "fleet_sweep": {"configs": "grid_space()"},
    "mixed_spec": {"specs": ["superblock", "block", "vchunk2"],
                   "segments": [22, 11], "chunks": [1536],
                   "parities": [False], "wear": [True]},
    "evolve": {"space": "SearchSpace()", "random_n": 32, "seed": 0},
    "obs": {"segments": [22, 11], "chunks": [1536, 768],
            "parities": [False, True], "wear": [True, False],
            "n_configs": 8, "pad_quantum": 64, "n_buckets": 32,
            "overhead_pairs": 1},
    "recompiles": {"segments": [22, 11], "chunks": [1536],
                   "parities": [False, True], "wear": [True],
                   "n_configs": 4, "n_devices": 2, "generations": 2},
    "array": {"n_arrays": 8, "n_zones": 8, "pad_quantum": 64},
    "storm": {"scenarios": [[3, 2, 0.5], [4, 2, 0.6]], "n_buckets": 16,
              "n_tenants": 3},
}
FLEET_SECTIONS = ("fleet_sweep", "mixed_spec", "evolve", "obs",
                  "recompiles", "array", "storm")
#: golden keys that are clocks, or built from one: held at rel 1e-5 (as
#: is every key ending in ``_s``)
FLEET_TIME_KEYS = {"best_objective", "best_of_gen", "best_so_far",
                   "rebuild_interference"}
#: float64 statistics of the (bit-identical, sha256-checked) integer wear:
#: held at rel 1e-12, since numpy 2.0 and 2.3 gave rows pooling more than
#: 8192 elements 2-3 ulp apart from the same integers (assumed to be the
#: order of the sum; numpy's source not checked)
FLEET_STAT_KEYS = {"wear_cv", "mean_wear", "std_wear", "cv_wear"}


class Dispatches:
    """Stands in for ``eng.run_batch`` and records every dispatch: its
    lanes and op steps, its seconds (between two ``sync`` calls when
    given) and, with ``keep``, its programs, lane configs and outputs.
    :meth:`close` restores the engine's own method."""

    def __init__(self, eng, *, sync=None, keep: bool = False):
        self.eng, self.sync, self.keep = eng, sync, keep
        self.inner = eng.run_batch
        self.shapes, self.seconds, self.outs = [], [], []
        eng.run_batch = self

    def __call__(self, state, programs, dyn=None, **kw):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        out = self.inner(state, programs, dyn, **kw)
        if self.sync is not None:
            self.sync()
        self.seconds.append(time.perf_counter() - t0)
        self.shapes.append([int(programs.shape[0]), int(programs.shape[1])])
        if self.keep:
            self.outs.append((programs, dyn, out))
        return out

    def close(self) -> None:
        del self.eng.run_batch


def dispatch_record(P, np, programs, dyn, out) -> dict:
    """One dispatch's inputs and outputs as hashes: programs, every lane
    config field, every state and trace field (and telemetry field)."""
    rec = {"lanes": int(programs.shape[0]),
           "op_steps": int(programs.shape[1]),
           "real_ops": int((P.host(programs)[:, :, 0] != 0).sum()),
           "programs_sha256": sha256(np, P.host(programs))}
    parts = [("dyn", dyn), ("state", out[0]), ("trace", out[1])]
    if len(out) > 2:
        parts.append(("telemetry", out[2]))
    for name, part in parts:
        rec[f"{name}_sha256"] = {f: sha256(np, P.host(getattr(part, f)))
                                 for f in type(part)._fields}
    return rec


def fleet_section(P, np, name: str) -> dict:
    """Run phase 13's section ``name`` through package ``P`` (the port on
    the card, or the reference when the golden file is written) and
    summarise it.  Keys starting with ``_`` are the run's own (dispatch
    seconds, plan counts, results to export) and stay out of the golden
    file; ``dispatches`` lists every engine dispatch as ``[lanes, op
    steps]``."""
    E, FL, p = P.elements, P.fleet, FLEET_PARAMS
    specs = (E.SUPERBLOCK, E.BLOCK, E.vchunk(2))
    eng = P.make_engine(specs if name == "mixed_spec" else E.SUPERBLOCK)
    spy = Dispatches(eng, sync=P.sync,
                     keep=name in ("fleet_sweep", "mixed_spec", "obs"))
    out: dict = {}
    try:
        if name in ("fleet_sweep", "mixed_spec"):
            configs = (FL.grid_space() if name == "fleet_sweep" else
                       FL.grid_space(segments=(22, 11), chunks=(1536,),
                                     parities=(False,), wear=(True,),
                                     specs=specs))
            ev = FL.Evaluator(eng, n_devices=p["n_devices"])
            t0 = time.perf_counter()
            rows = ev.evaluate(configs)
            out["_evaluate_s"] = time.perf_counter() - t0
            out.update(dispatch_record(P, np, *spy.outs[-1]),
                       rows=rows, ledger=ev.ledger())
            out["_batch"] = spy.outs[-1][:2]
        elif name == "evolve":
            inner, results = P.evolve.evolve, []

            def evolve(*args, **kw):
                results.append(inner(*args, **kw))
                return results[-1]
            P.evolve.evolve = evolve
            try:
                out["comparison"] = P.evolve.evolve_vs_random(
                    eng, space=FL.SearchSpace(), random_n=32, seed=0,
                    n_devices=p["n_devices"])
            finally:
                P.evolve.evolve = inner
            res = results[-1]
            out.update(history=res.history, best=res.best,
                       archive=res.archive, rows=res.rows,
                       ledger=res.ledger, reached_target=res.reached_target)
        elif name == "obs":
            q = p["obs"]
            configs = FL.grid_space(
                segments=tuple(q["segments"]), chunks=tuple(q["chunks"]),
                parities=tuple(q["parities"]),
                wear=tuple(q["wear"]))[:q["n_configs"]]
            programs, dyn, _ = FL.build_fleet_batch(
                eng, configs, n_devices=p["n_devices"],
                pad_quantum=q["pad_quantum"])
            obs = P.obs.ObsConfig(q["n_buckets"], FL.N_TENANTS + 1)
            runs = [FL.run_fleet(eng, programs, dyn=dyn,
                                 n_tenants=FL.N_TENANTS,
                                 parity_tenant=FL.N_TENANTS, obs=o)
                    for o in (None, obs)]
            off, on = (dispatch_record(P, np, *o) for o in spy.outs)
            res = runs[1]
            lanes = P.obs.fleet_timelines(obs, res.telemetry)
            out.update(on, effect_free=all(
                off[k] == on[k] for k in ("state_sha256", "trace_sha256")),
                metrics=P.obs_export.fleet_metrics(res, eng).as_dict(),
                fleet_timeline=P.obs.device_rollup(lanes),
                tenant_timelines=P.obs.tenant_timelines(obs,
                                                        res.telemetry))
            out.update(_res=res, _eng=eng, _obs=obs, _configs=configs,
                       _batch=(programs, dyn))
        elif name == "recompiles":
            q = p["recompiles"]
            configs = FL.grid_space(
                segments=tuple(q["segments"]), chunks=tuple(q["chunks"]),
                parities=tuple(q["parities"]),
                wear=tuple(q["wear"]))[:q["n_configs"]]
            ev = FL.Evaluator(eng, n_devices=q["n_devices"],
                              profiler=P.obs.Profiler())
            gens, plans = [], []
            for _ in range(q["generations"]):
                gens.append(ev.evaluate(configs))
                plans.append(ev.jit_cache()["run_programs"])
            out.update(rows=gens[0], same_rows_every_generation=all(
                g == gens[0] for g in gens), ledger=ev.ledger(),
                _plans=plans, _profile=ev.profiler.snapshot())
        elif name == "array":
            q = p["array"]
            arrays, commands = P.array_batch(eng, n_arrays=q["n_arrays"],
                                             n_zones=q["n_zones"])
            P.array.run_array_batch(arrays, pad_quantum=q["pad_quantum"])
            out.update(
                commands_per_array=[len(c) for c in commands],
                lane_ops=sum(len(m) for a in arrays
                             for m in a.member_programs()),
                reports=[a.report() for a in arrays],
                device_reports=[a.device_reports() for a in arrays])
        elif name == "storm":
            q = p["storm"]
            scenarios = [P.array.StormScenario(
                n_devices=d, n_zones_filled=z, occupancy=o)
                for d, z, o in q["scenarios"]]
            obs = P.obs.ObsConfig(q["n_buckets"], q["n_tenants"])
            counter = P.obs.RecompileCounter(
                run_programs=P.engine.run_programs,
                simulate_fleet_ops=P.timing.simulate_fleet_ops)
            first = P.array.rebuild_storm(eng, scenarios, obs=obs)
            before = counter.counts()
            second = P.array.rebuild_storm(eng, scenarios, obs=obs)
            out.update(
                scenarios=first["scenarios"],
                telemetry_sha256=[{f: sha256(np, P.host(getattr(t, f)))
                                   for f in type(t)._fields}
                                  for t in first["telemetry"]],
                second_call_equal=second["scenarios"] == first["scenarios"],
                _plan_delta=counter.delta(before))
        else:
            raise KeyError(name)
    finally:
        spy.close()
    out["dispatches"] = spy.shapes
    out["_dispatch_s"] = spy.seconds
    return out


def golden_part(section: dict) -> dict:
    """A section's summary as the golden file holds it: the run's own
    keys dropped, JSON-typed (integer keys become strings)."""
    return json.loads(json.dumps({k: v for k, v in section.items()
                                  if not k.startswith("_")}))


def fleet_mismatches(got, want, where: str, key: str = "",
                     time_keys=FLEET_TIME_KEYS,
                     stat_keys=FLEET_STAT_KEYS) -> list:
    """Where ``got`` differs from ``want``: clocks (keys ending in ``_s``
    and ``time_keys``) at rel 1e-5, float64 wear statistics
    (``stat_keys``) at rel 1e-12, the rest exactly (NaN equal to NaN)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [f"{where}: keys differ"]
        return [m for k in want
                for m in fleet_mismatches(got[k], want[k], f"{where}.{k}",
                                          k, time_keys, stat_keys)]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{where}: lengths differ"]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in fleet_mismatches(a, b, f"{where}[{i}]", key,
                                          time_keys, stat_keys)]
    if isinstance(want, float) and math.isnan(want):
        if not (isinstance(got, float) and math.isnan(got)):
            return [f"{where}: {got!r} != NaN"]
    elif key.endswith("_s") or key in time_keys:
        if not abs(got - want) <= 1e-5 * abs(want):
            return [f"{where}: {got!r} vs {want!r} (rel 1e-5)"]
    elif key in stat_keys:
        if not abs(got - want) <= 1e-12 * abs(want):
            return [f"{where}: {got!r} vs {want!r} (rel 1e-12)"]
    elif got != want:
        return [f"{where}: {got!r} != {want!r}"]
    return []


def check_fleet_golden(got, want, where: str,
                       time_keys=FLEET_TIME_KEYS) -> None:
    """``got`` equals ``want`` (:func:`fleet_mismatches` finds nothing);
    else every mismatch is printed and the run fails."""
    bad = fleet_mismatches(got, want, where, time_keys=time_keys)
    for m in bad[:40]:
        print(f"chip_smoke: mismatch: {m}", file=sys.stderr, flush=True)
    check(not bad, f"{where}: {len(bad)} mismatches with the golden file")


def torch_fleet_package(torch, np):
    """Phase 13's view of the port: its modules and a zn540 engine
    builder on the card."""
    from types import SimpleNamespace

    import repro_torch.array as A
    import repro_torch.fleet as FL
    import repro_torch.obs as O
    from repro_torch.core import elements, engine, timing
    from repro_torch.core.geometry import zn540
    from repro_torch.obs import export
    return SimpleNamespace(
        fleet=FL, evolve=sys.modules["repro_torch.fleet.evolve"], obs=O,
        obs_export=export, array=A, array_batch=A.array_batch,
        elements=elements, engine=engine, timing=timing,
        make_engine=lambda spec: engine.ZoneEngine(
            *zn540(), spec, max_active=FLEET_PARAMS["max_active"],
            device="cuda"),
        host=lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a)),
        sync=torch.cuda.synchronize)


def phase_fleet(torch, np, ops, ref, engine, golden: dict,
                deferred: list) -> dict:
    """Phase 13: every section of the design-space search at zn540 on the
    card, each held to the reference's golden summary, with exactly one
    ``alloc_select`` and one ``grow_select`` launch per op step of every
    dispatch; then the telemetry export, the overhead pairs, the plan
    counts and a profiled prefix of the fleet sweep."""
    check(golden["params"] == json.loads(json.dumps(FLEET_PARAMS)),
          "phase 13: the golden file's parameters are not this script's")
    P = torch_fleet_package(torch, np)
    got, secs = {}, {}
    for name in FLEET_SECTIONS:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = fleet_section(P, np, name)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = dict(ops.counts)
        steps = sum(n for _, n in got[name]["dispatches"])
        check(counts == {"alloc_select": steps, "grow_select": steps,
                         "rows": 0},
              f"phase 13: {name} launched {counts}, want {steps} each of "
              f"alloc_select and grow_select over {steps} op steps")
        got[name]["_counts"] = counts
        check_fleet_golden(golden_part(got[name]), golden[name],
                           f"phase 13: {name}")
        shapes = [tuple(d) for d in got[name]["dispatches"]]
        lane_steps = sum(lanes * n for lanes, n in shapes)
        engine_s = sum(got[name]["_dispatch_s"])
        log(f"phase 13: {name} == tests/data/torch_fleet_zn540.json "
            f"({len(shapes)} dispatches of (lanes, op steps) {shapes} "
            f"= {steps} op steps, {lane_steps} lane-op cells); zns_alloc "
            f"launches {counts}: 1 alloc_select + 1 grow_select per op "
            f"step; section {secs[name]:.3f} s, engine dispatches "
            f"{engine_s:.3f} s = {lane_steps / engine_s:.1f} lane-ops/s "
            f"({engine_s / steps * 1e3:.3f} ms per op step)")
    sweep = got["fleet_sweep"]
    log(f"phase 13: fleet sweep: {len(sweep['rows'])} configs x 4 devices "
        f"= {sweep['lanes']} lanes x {sweep['op_steps']} op steps "
        f"({sweep['real_ops']} real ops): Evaluator.evaluate "
        f"{sweep['_evaluate_s']:.3f} s (engine {sweep['_dispatch_s'][0]:.3f}"
        f" s + timing, decode and rollups)")
    mixed = got["mixed_spec"]
    log(f"phase 13: mixed spec (superblock + block + vchunk2 union): "
        f"{len(mixed['rows'])} configs = {mixed['lanes']} lanes x "
        f"{mixed['op_steps']} op steps: Evaluator.evaluate "
        f"{mixed['_evaluate_s']:.3f} s (engine {mixed['_dispatch_s'][0]:.3f}"
        f" s)")
    evo = got["evolve"]["comparison"]
    log(f"phase 13: evolve vs random-32: random best "
        f"{evo['random']['best_objective']!r} ({evo['random']['best_config']}"
        f", {evo['random']['n_dispatches']:.0f} dispatches), evolve best "
        f"{evo['evolve']['best_objective']!r} in "
        f"{evo['evolve']['generations']:.0f} generation(s), "
        f"{evo['evolve']['n_dispatches']:.0f} dispatches, reached "
        f"{evo['evolve']['reached_target']}; savings dispatches "
        f"{evo['n_dispatches_savings']!r}, evals {evo['n_evals_savings']!r}"
        f", lane-ops {evo['lane_ops_savings']!r}")

    # (d) the telemetry export and its overhead: the median of paired
    # off/on ratios (FLEET_PARAMS' pairs; the reference takes 9)
    tele = got["obs"]
    check(tele["effect_free"], "phase 13: telemetry changed the dispatch")
    res, eng, obs = tele["_res"], tele["_eng"], tele["_obs"]
    (ROOT / "build").mkdir(exist_ok=True)
    labels = [f"{fc.describe()}/dev{d}" for fc in tele["_configs"]
              for d in range(FLEET_PARAMS["n_devices"])]
    prof = P.obs.Profiler()
    emitted = P.obs.emit_fleet_obs(
        res, eng, obs=obs, out_prefix=str(ROOT / "build" / "fleet_zn540"),
        lane_labels=labels, profiler=prof,
        recompiles=P.obs.RecompileCounter.engine_default(),
        meta={"phase": "13", "device": torch.cuda.get_device_name(0)})
    P.obs.validate_trace(json.loads(Path(emitted["trace"]).read_text()))
    programs, dyn = tele["_batch"]

    def once(o):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.fleet.run_fleet(eng, programs, dyn=dyn,
                          n_tenants=P.fleet.N_TENANTS,
                          parity_tenant=P.fleet.N_TENANTS, obs=o)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    before = dict(ops.counts)
    t0 = time.perf_counter()
    pairs = [(once(None), once(obs))
             for _ in range(FLEET_PARAMS["obs"]["overhead_pairs"])]
    ops.counts.update(before)
    ratios = sorted(on / off for off, on in pairs)
    overhead = ratios[len(ratios) // 2]
    log(f"phase 13: telemetry: states and traces bit-identical on and off;"
        f" {emitted['n_events']} trace events validated, written to "
        f"build/fleet_zn540_trace.json and build/fleet_zn540_obs.json; "
        f"run_fleet off/on seconds {pairs}: overhead (median of "
        f"{len(pairs)} paired ratios; the reference's gate is 1.10 over 9) "
        f"{overhead!r} (the pairs took {time.perf_counter() - t0:.1f} s)")
    tele_batch = (eng, obs, programs, dyn)

    def profiled_telemetry():
        eng, obs, programs, dyn = tele_batch
        t0 = time.perf_counter()
        prefix = programs[:, :PROFILED_STEPS // 2]    # off and on
        prof_off = profile_dispatch(torch, eng, prefix, dyn)
        prof_on = profile_dispatch(torch, eng, prefix, dyn, obs=obs)
        check(prof_off["device_events"] > 0 and prof_on["device_events"] > 0,
              "phase 13: a profiled telemetry prefix holds no device event")
        log(f"phase 13: telemetry batch ({programs.shape[0]} lanes), a "
            f"{prefix.shape[1]}-op-step prefix profiled off and on: "
            f"{prof_off['device_events'] / prefix.shape[1]:.1f} and "
            f"{prof_on['device_events'] / prefix.shape[1]:.1f} device events"
            f" per op step; device busy {prof_off['busy_us']:.1f} us of "
            f"{prof_off['wall_us']:.1f} off, {prof_on['busy_us']:.1f} us of "
            f"{prof_on['wall_us']:.1f} on ({time.perf_counter() - t0:.1f} s "
            f"with the profiler's decoding)")
    deferred.append(profiled_telemetry)

    rec = got["recompiles"]
    check(len(set(rec["_plans"][1:])) == 1 and rec["_plans"][0]
          == rec["_plans"][-1],
          f"phase 13: launch plans grew across generations {rec['_plans']}")
    storm = got["storm"]
    check(sum(storm["_plan_delta"].values()) == 0,
          f"phase 13: the second storm call added plans "
          f"{storm['_plan_delta']}")
    log(f"phase 13: plan stability: run_programs launch plans per "
        f"generation {rec['_plans']} ({len(rec['_plans'])} generations of "
        f"4 configs x 2 devices); second "
        f"rebuild_storm call added {storm['_plan_delta']}")
    for sc in storm["scenarios"]:
        log(f"phase 13: storm {sc['scenario']}: rebuild pages "
            f"{sc['rebuild_pages']!r}, interference "
            f"{sc['rebuild_interference']!r}")

    programs, dyn = sweep["_batch"]
    eng = P.make_engine(P.elements.SUPERBLOCK)
    # both selections against their plain versions, then timed, under
    # the sweep's SUPERBLOCK lane table and the mixed spec's union table
    t0 = time.perf_counter()
    timed = fused_timing(torch, np, ops, ref, engine, eng, dyn, seed=13)
    union = P.make_engine((P.elements.SUPERBLOCK, P.elements.BLOCK,
                           P.elements.vchunk(2)))
    timed_mixed = fused_timing(torch, np, ops, ref, engine, union,
                               mixed["_batch"][1], seed=17)
    log(f"phase 13: selection checks and timings took "
        f"{time.perf_counter() - t0:.1f} s")
    for where, entry in (("fleet sweep", timed), ("mixed spec", timed_mixed)):
        for kname, t in entry.items():
            log(f"phase 13: zns_alloc {kname} at the {where} ({t['lanes']} "
                f"lanes, {t['rows']} row selections): == plain version bit "
                f"for bit (max_abs_err {t['max_abs_err']}); kernel "
                f"{t['ms']:.6f} ms a call, device {t['device_us']} us a "
                f"launch, plain {t['plain_ms']:.6f} ms, bound "
                f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    err = max(t["max_abs_err"] for entry in (timed, timed_mixed)
              for t in entry.values())
    out = {"counts": sweep["_counts"], "timed": timed,
           "timed_mixed": timed_mixed, "max_abs_err": err,
           "overhead": overhead, "secs": secs}

    # a PROFILED_STEPS prefix of the fleet sweep under the profiler,
    # taken with the other profiled dispatches (see profile_dispatches)
    def profiled_sweep():
        prefix = programs[:, :PROFILED_STEPS]
        t0 = time.perf_counter()
        prof = out["prof"] = profile_dispatch(torch, eng, prefix, dyn)
        check(prof["device_events"] > 0,
              "phase 13: the profiled fleet sweep holds no device event")
        log(f"phase 13: the profiled fleet sweep took "
            f"{time.perf_counter() - t0:.1f} s with the profiler's decoding")
        log(f"phase 13: profiled a {prefix.shape[1]}-op-step prefix of the "
            f"fleet sweep ({prefix.shape[0]} lanes): wall "
            f"{prof['wall_us']:.1f} us, device busy {prof['busy_us']:.1f} "
            f"us ({prof['busy_us'] / prof['wall_us']:.4f} of wall), "
            f"{prof['device_events'] / prefix.shape[1]:.1f} device events "
            f"per op step; alloc_select (launches, us each) "
            f"{prof['alloc_select_kernel']}, grow_select "
            f"{prof['grow_select_kernel']}")
    deferred.append(profiled_sweep)
    return out


# --------------------------------------------------------------------- #
# phase 14: the paper's per-op benchmarks and the legacy oracles
# --------------------------------------------------------------------- #
#: phase 14's workloads: ``benchmarks/paper_figures.py``'s Fig. 4b / 7d
#: (``fig4b_7d_interference``) and Fig. 9 (``fig9_throughput``)
#: parameters, Table 4's benchmark on zn540 for four specs, and the
#: reference's three engine-vs-legacy comparators: the per-op workloads'
#: at its defaults (``BENCH_zoneengine.json``'s sizes) but for 1 timed
#: repeat where they take 3, the fleet's at ``tools/bench.py``'s full mode
#: with 1 timed repeat where the bench takes 3 (the smoke run's time), and
#: the arrays' at its defaults with one timed legacy array and 1 timed
#: repeat (the bench's full mode takes 8 zones an array, the defaults 4;
#: the per-op workloads and the arrays took 3 repeats, the arrays 2 legacy
#: arrays, until the script passed 1,200 s on a slow host)
WORKLOAD_PARAMS = {
    "interference": {"device": "zn540", "max_active": 28,
                     "concurrency": [1, 2, 3, 4, 5, 6, 7],
                     "specs": ["fixed", "superblock"],
                     "fill_occupancy": 0.4},
    "fio": {"device": "custom16", "spec": "fixed", "max_active": 64,
            "geometries": [[16, 1], [16, 2], [8, 1], [8, 2], [4, 1],
                           [4, 2]],
            "request_kib": [4, 16, 64], "jobs": [1, 2, 4, 8, 16],
            "mib_per_job": 4, "shim_geometry": [16, 1]},
    "alloc_latency": {"device": "zn540", "max_active": 14, "n_allocs": 32,
                      "specs": ["fixed", "superblock", "vchunk2",
                                "block"]},
    "engine_vs_legacy": {"occupancies": 16, "n_zones": 8,
                         "concurrencies": [1, 2, 4, 7], "repeats": 1},
    "fleet_vs_legacy": {"repeats": 1,
                        "sweep": {"configs": "grid_space()",
                                  "legacy_configs": 8},
                        "mixed": {"specs": ["superblock", "block",
                                            "vchunk2"],
                                  "segments": [22, 11], "chunks": [1536],
                                  "parities": [False], "wear": [True]}},
    "array_vs_legacy": {"n_arrays": 8, "n_zones": 4, "legacy_arrays": 1,
                        "repeats": 1},
    "kv_legacy": {"lanes": ["lsm", "ckpt", "cache"],
                  "spec": "traditional_spec(zn540)"},
}
WORKLOAD_SECTIONS = tuple(WORKLOAD_PARAMS)
#: golden keys that are built from clocks (the interference factor, a
#: ratio of two throughputs): held at rel 1e-5, as is every key ending in
#: ``_s``
WORKLOAD_TIME_KEYS = {"interference"}
#: the comparators' non-timing results, held to the golden file exactly
SPEEDUP_KEYS = {
    "engine_vs_legacy": ("dlwa_ops", "interference_ops",
                         "interference_dispatches",
                         "interference_recompiles"),
    "fleet_vs_legacy": ("n_configs", "n_devices", "fleet_ops",
                        "legacy_timed_configs", "legacy_scale"),
    "array_vs_legacy": ("n_arrays", "lane_ops", "legacy_timed_arrays",
                        "legacy_scale"),
}
#: the page_clock check's random batches and its prefix of the real stream
PAGE_CLOCK_CASES, PAGE_CLOCK_PREFIX = 16, 20_000


def spec_named(E, name: str):
    return {"fixed": E.FIXED, "superblock": E.SUPERBLOCK, "block": E.BLOCK,
            "vchunk2": E.vchunk(2)}[name]


def workloads_section(P, np, name: str, recs=None, figures=None) -> dict:
    """Run phase 14's section ``name`` through package ``P`` (the port on
    the card, or the reference when the golden file is written) and
    summarise it.  Keys starting with ``_`` are the run's own (timings,
    counts) and stay out of the golden file.  ``recs`` are the KV
    recorders to replay in ``kv_legacy`` (recorded anew when None).
    ``figures`` are phase 17's outputs: ``interference`` and ``fio`` then
    take their engine rows from its Fig. 4b / 7d sweeps and Fig. 9
    points, which ran the same engines at the same parameters, instead of
    running them again (None: run here)."""
    W, E, G, p = P.workloads, P.elements, P.geometry, WORKLOAD_PARAMS[name]
    out: dict = {}
    if name == "interference":
        flash, zone = G.zn540()
        kw = {"max_active": p["max_active"]}
        for spec_name in p["specs"]:
            spec = spec_named(E, spec_name)

            def point(dev, c):
                return W.interference_benchmark(
                    dev, concurrency=c, fill_occupancy=p["fill_occupancy"])
            shim = [point(P.shim(flash, zone, spec, **kw), c)
                    for c in p["concurrency"]]
            legacy = [point(P.legacy(flash, zone, spec, **kw), c)
                      for c in p["concurrency"]]
            sweep = (figures["fig4b_7d_interference"]["_sweeps"][spec_name]
                     if figures else W.interference_sweep_engine(
                         P.make_engine(flash, zone, spec, **kw),
                         p["concurrency"],
                         fill_occupancy=p["fill_occupancy"]))
            out[spec_name] = {"rows": shim, "legacy_equal": legacy == shim,
                              "sweep_equal": sweep == shim}
        out["_fill"] = max(1, int(round(zone.zone_pages(flash)
                                        * p["fill_occupancy"])))
    elif name == "fio":
        flash = G.custom16()
        rows, eng_rows, shim_rows = [], [], []
        kw = {"max_active": p["max_active"]}
        fixed = spec_named(E, p["spec"])
        points = {(r["geometry"], r["request_kib"], r["n_jobs"]): r
                  for r in figures["fig9_throughput"]["_points"]
                  } if figures else None
        for par, segs in p["geometries"]:
            geom = G.ZoneGeometry(parallelism=par, n_segments=segs)
            where = geom.describe(flash)
            eng = None if figures else P.make_engine(flash, geom, fixed,
                                                     **kw)
            for req in p["request_kib"]:
                for jobs in p["jobs"]:
                    dev = P.legacy(flash, geom, fixed, **kw)
                    if jobs > dev.n_zones:
                        continue
                    bkw = {"request_kib": req, "n_jobs": jobs,
                           "mib_per_job": p["mib_per_job"]}
                    rows.append(dict(W.write_benchmark(dev, **bkw),
                                     geometry=where))
                    eng_rows.append(
                        points[(where, float(req), float(jobs))] if figures
                        else dict(W.write_benchmark_engine(eng, **bkw),
                                  geometry=where))
                    if [par, segs] == p["shim_geometry"]:
                        shim_rows.append(dict(W.write_benchmark(
                            P.shim(flash, geom, fixed, **kw), **bkw),
                            geometry=where))
        shim_where = shim_rows[0]["geometry"]
        out.update(rows=rows, engine_equal=eng_rows == rows,
                   shim_equal=shim_rows == [r for r in rows
                                            if r["geometry"] == shim_where],
                   shim_geometry=shim_where)
    elif name == "alloc_latency":
        flash, zone = G.zn540()
        kw = {"max_active": p["max_active"]}
        for spec_name in p["specs"]:
            spec = spec_named(E, spec_name)
            for path, make in (("shim", P.shim), ("legacy", P.legacy)):
                dev = make(flash, zone, spec, **kw)
                r = W.alloc_latency_benchmark(dev, n_allocs=p["n_allocs"])
                out[f"{spec_name}_{path}"] = {"n_allocs": r["n_allocs"]}
                out[f"_{spec_name}_{path}"] = r
    elif name == "engine_vs_legacy":
        rep = W.engine_vs_legacy_speedup(
            occupancies=tuple(np.linspace(0.05, 0.95, p["occupancies"])),
            n_zones=p["n_zones"], concurrencies=tuple(p["concurrencies"]),
            repeats=p["repeats"], **P.kw)
        out.update({k: rep[k] for k in SPEEDUP_KEYS[name]}, _rep=rep)
    elif name == "fleet_vs_legacy":
        S = P.fleet_search
        inner, calls = S.run_configs_legacy, []

        def spy(*args, **kw):
            calls.append(inner(*args, **kw))
            return calls[-1]
        q = p["mixed"]
        specs = tuple(spec_named(E, s) for s in q["specs"])
        runs = {
            "sweep": {"legacy_configs": p["sweep"]["legacy_configs"]},
            "mixed": {"configs": S.grid_space(
                segments=tuple(q["segments"]), chunks=tuple(q["chunks"]),
                parities=tuple(q["parities"]), wear=tuple(q["wear"]),
                specs=specs), "specs": specs}}
        S.run_configs_legacy = spy
        try:
            for run, kw in runs.items():
                calls.clear()
                rep = S.fleet_vs_legacy_speedup(repeats=p["repeats"],
                                                **kw, **P.kw)
                # the first legacy pass is the oracle over every config
                out[run] = dict({k: rep[k] for k in SPEEDUP_KEYS[name]},
                                legacy_rows=calls[0])
                out[f"_{run}"] = rep
        finally:
            S.run_configs_legacy = inner
    elif name == "array_vs_legacy":
        rep = P.array.array_vs_legacy_speedup(
            n_arrays=p["n_arrays"], n_zones=p["n_zones"],
            legacy_arrays=p["legacy_arrays"], repeats=p["repeats"], **P.kw)
        out.update({k: rep[k] for k in SPEEDUP_KEYS[name]}, _rep=rep)
    elif name == "kv_legacy":
        kvp = json.loads((ROOT / "tests" / "data" /
                          "torch_kv_zn540.json").read_text())["params"]
        eng = P.headline_engine()
        if recs is None:
            recs = kv_recorders(P.storage, eng, kvp)
        spec = P.headline.traditional_spec(eng.zone_geom)
        Z, lanes = P.engine, []
        for lane in p["lanes"]:
            leg = P.legacy(eng.flash, eng.zone_geom, spec,
                           max_active=kvp["max_active"])
            program = recs[lane].program()
            for op, zone, n, flags, _tenant in program.tolist():
                if op == Z.OP_WRITE:
                    leg.zone_write(zone, n, host=bool(flags & Z.F_HOST))
                elif op == Z.OP_FINISH:
                    leg.zone_finish(zone)
                elif op == Z.OP_RESET:
                    leg.zone_reset(zone)
                elif op == Z.OP_READ:
                    leg.zone_read(zone, np.arange(n))
            lanes.append({"workload": lane, "n_ops": len(program),
                          "program_sha256": sha256(np, program),
                          "dlwa": leg.dlwa, "host_pages": leg.host_pages,
                          "dummy_pages": leg.dummy_pages,
                          "block_erases": leg.block_erases,
                          "alloc_calls": leg.alloc_calls})
        out["lanes"] = lanes
    else:
        raise KeyError(name)
    return out


def torch_workloads_package(device: str = "cuda"):
    """Phase 14's view of the port, every device, engine and comparator
    on ``device``."""
    from types import SimpleNamespace

    import repro_torch.array as A
    import repro_torch.fleet as FL
    import repro_torch.storage as S
    from repro_torch.core import (elements, engine, geometry, headline,
                                  timing, workloads)
    from repro_torch.core.device import ZNSDevice
    from repro_torch.core.device_legacy import LegacyZNSDevice
    return SimpleNamespace(
        workloads=workloads, elements=elements, geometry=geometry,
        engine=engine, timing=timing, headline=headline, fleet=FL,
        fleet_search=sys.modules["repro_torch.fleet.search"], array=A,
        storage=S, kw={"device": device},
        shim=lambda *a, **kw: ZNSDevice(*a, device=device, **kw),
        legacy=lambda *a, **kw: LegacyZNSDevice(*a, device=device, **kw),
        make_engine=lambda *a, **kw: workloads.make_engine(
            *a, device=device, **kw),
        headline_engine=lambda: headline.build_headline_engine(
            device=device),
        legacy_cls=LegacyZNSDevice)


class Instances:
    """Keeps every instance of ``cls`` built while it is open (the legacy
    devices a comparator builds inside), so a section can read their
    counters; :meth:`close` restores the class."""

    def __init__(self, cls):
        self.cls, self.made, self.init = cls, [], cls.__init__
        made, init = self.made, self.init

        def __init__(obj, *args, **kw):
            init(obj, *args, **kw)
            made.append(obj)
        cls.__init__ = __init__

    def close(self) -> None:
        self.cls.__init__ = self.init


class Calls:
    """Counts the calls of ``module.name`` while open; with ``key``, also
    apart by ``key(*args)`` (in ``by``)."""

    def __init__(self, module, name: str, key=None):
        self.module, self.name, self.n, self.by = module, name, 0, {}
        self.inner = getattr(module, name)

        def counted(*args, **kw):
            self.n += 1
            if key is not None:
                k = key(*args)
                self.by[k] = self.by.get(k, 0) + 1
            return self.inner(*args, **kw)
        setattr(module, name, counted)

    def close(self) -> None:
        setattr(self.module, self.name, self.inner)


def page_clock_batch(torch, np, rng, dev: str, *, chains: bool = False,
                     n_luns: int = None, n_ch: int = None):
    """A random right-padded request batch (1-64 device rows, 1-5,000
    requests, every op code, 1-16 LUNs and channels unless given) and its
    times.  With ``chains``, every LUN keeps channel ``lun % n_ch``, as in
    every geometry of the repo, so the kernel steps a chain a channel;
    else the channels are random and most rows are stepped whole."""
    nd, n = int(rng.integers(1, 65)), int(rng.integers(1, 5001))
    n_luns = n_luns or int(rng.integers(1, 17))
    n_ch = n_ch or int(rng.integers(1, 17))
    lengths = rng.integers(0, n + 1, nd)
    lengths[rng.integers(nd)] = n               # one row unpadded
    t_op = rng.uniform(1e-6, 5e-3, 3).astype(np.float32)
    t_x = np.float32(rng.uniform(1e-6, 1e-4))
    ops_ = rng.integers(0, 3, (nd, n), dtype=np.int32)
    ops_[0, : min(n, 3)] = np.arange(min(n, 3))  # every op code present
    luns = rng.integers(0, n_luns, (nd, n), dtype=np.int32)
    chans = (luns % n_ch).astype(np.int32) if chains else rng.integers(
        0, n_ch, (nd, n), dtype=np.int32)
    arrs = [ops_, luns, chans, np.arange(n)[None, :] < lengths[:, None]]
    return ([torch.from_numpy(a).to(dev) for a in arrs]
            + [torch.from_numpy(t_op).to(dev), torch.tensor(t_x).to(dev),
               n_luns, n_ch])


def merged_stream(torch, P, traces, flash):
    """``timing``'s round-robin merge of ``traces`` as one device row on
    the card, and the geometry's times."""
    ops_, luns, chans, _ = P.timing._merge(traces, True)
    full = [torch.from_numpy(a)[None].cuda() for a in (ops_, luns, chans)]
    full.append(torch.ones_like(full[0], dtype=torch.bool))
    times = [P.timing._t_op(flash, torch.device("cuda")),
             torch.tensor(flash.t_xfer, dtype=torch.float32, device="cuda"),
             flash.n_luns, flash.n_channels]
    return full, times


def page_clock_rows(pc_ops, fn):
    """``fn()``'s result and the rows each of the kernel's paths stepped
    in it."""
    before = dict(pc_ops.rows)
    out = fn()
    return out, {k: pc_ops.rows[k] - before[k] for k in before}


def phase_page_clock(torch, np, P, pc_ops, pc_ref) -> dict:
    """Phase 14 (h): ``page_clock`` against its plain version, bit for
    bit, on both of its paths: random padded batches stepped whole (LUNs
    on random channels) and partitioned (every LUN on one channel), a
    batch of sixteen LUNs a channel (the LUN clocks in shared memory), the
    whole custom16 stream of Fig. 9's geometry P16 S1 (two LUNs a
    channel) and a prefix of the real FIXED concurrency-7 contended zn540
    stream of (a); then timed on that whole stream (a chain a channel),
    on a random stream of the same length stepped whole (the first
    design's one chain), and on a one-channel stream of the same length
    (the step chain's floor: a request's time on one chain)."""
    rng = np.random.default_rng(14)
    before = pc_ops.launches
    n_req = 0

    def plain_equal(args, what, want_rows=None):
        got, rows = page_clock_rows(pc_ops,
                                    lambda: pc_ops.simulate_fleet(*args))
        # the plain version on the same inputs, moved to the CPU (the
        # same f32 additions; it steps ~3x faster there than on the card)
        want = pc_ref.simulate_fleet_ref(*[a.cpu() if hasattr(a, "cpu")
                                           else a for a in args])
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"phase 14: page_clock differs from its plain version on "
              f"{what} {tuple(args[0].shape)}")
        check(want_rows is None or rows == want_rows,
              f"phase 14: page_clock stepped {what} {rows}, want "
              f"{want_rows}")
        return rows

    rows = {"chains": 0, "whole": 0}
    for i in range(2 * PAGE_CLOCK_CASES):
        chains = i % 2 == 1
        args = page_clock_batch(torch, np, rng, "cuda", chains=chains)
        r = plain_equal(args, "a random padded batch", {
            "chains": args[0].shape[0], "whole": 0} if chains else None)
        rows = {k: rows[k] + r[k] for k in rows}
        n_req += args[0].numel()
    args = page_clock_batch(torch, np, rng, "cuda", chains=True, n_luns=64,
                            n_ch=4)
    plain_equal(args, "sixteen LUNs a channel",
                {"chains": args[0].shape[0], "whole": 0})
    n_req += args[0].numel()
    # custom16 at Fig. 9's P16 S1: eight writers, round-robin
    flash16 = P.geometry.custom16()
    dev16 = P.legacy(flash16, P.geometry.ZoneGeometry(parallelism=16,
                                                      n_segments=1),
                     P.elements.FIXED, max_active=64)
    c16, c16_times = merged_stream(
        torch, P, [dev16.zone_write(z, PAGE_CLOCK_PREFIX // 8, trace=True)
                   for z in range(8)], flash16)
    plain_equal(c16 + c16_times, "the custom16 stream",
                {"chains": 1, "whole": 0})
    # the real stream: FIXED at concurrency 7, host writes + FINISH pads
    flash, zone = P.geometry.zn540()
    q = WORKLOAD_PARAMS["interference"]
    dev = P.legacy(flash, zone, P.elements.FIXED, max_active=q["max_active"])
    c = max(q["concurrency"])
    fill = max(1, int(round(dev.zone_pages * q["fill_occupancy"])))
    for z in range(c):
        dev.zone_write(z, fill)
    traces = [dev.zone_write(z, fill, trace=True) for z in range(c, 2 * c)]
    traces += [dev.zone_finish(z, trace=True) for z in range(c)]
    full, times = merged_stream(torch, P, traces, flash)
    k = PAGE_CLOCK_PREFIX
    prefix = [a[:, :k].contiguous() for a in full]
    got = pc_ops.simulate_fleet(*prefix, *times)
    got_full, full_rows = page_clock_rows(
        pc_ops, lambda: pc_ops.simulate_fleet(*full, *times))
    check(full_rows == {"chains": 1, "whole": 0},
          f"phase 14: Fig. 4b's stream took {full_rows}, want one chain a "
          f"channel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pc_ref.simulate_fleet_ref(*prefix, *times)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and torch.equal(got_full[0][:, :k], want[0]),
          "phase 14: page_clock differs from its plain version on the "
          "real stream's prefix")
    n = full[0].shape[1]
    per_channel = torch.bincount(full[2][0].long(),
                                 minlength=flash.n_channels)
    ms = cuda_ms(torch, lambda: pc_ops.simulate_fleet(*full, *times),
                 iters=10)
    prefix_ms = cuda_ms(torch, lambda: pc_ops.simulate_fleet(*prefix,
                                                             *times))
    dev_us = device_us(torch, lambda: pc_ops.simulate_fleet(*full, *times),
                       "page_clock", reps=5)
    # the same length stepped whole (random LUNs and channels) and as one
    # chain (one LUN on one channel)
    g = torch.Generator(device="cuda").manual_seed(14)
    rnd = [full[0], torch.randint(0, flash.n_luns, (1, n), generator=g,
                                  device="cuda", dtype=torch.int32),
           torch.randint(0, flash.n_channels, (1, n), generator=g,
                         device="cuda", dtype=torch.int32), full[3]]
    one = [full[0], torch.zeros_like(full[1]), torch.zeros_like(full[2]),
           full[3]]
    for what, stream, want_rows in (
            ("the whole-row stream", rnd, {"chains": 0, "whole": 1}),
            ("the one-chain stream", one, {"chains": 1, "whole": 0})):
        _, r = page_clock_rows(pc_ops,
                               lambda: pc_ops.simulate_fleet(*stream, *times))
        check(r == want_rows, f"phase 14: {what} took {r}")
    whole_ms = cuda_ms(torch, lambda: pc_ops.simulate_fleet(*rnd, *times),
                       iters=3)
    chain_ms = cuda_ms(torch, lambda: pc_ops.simulate_fleet(*one, *times),
                       iters=3)
    pc_ops.launches = before                 # checks and timings
    chain_ns = chain_ms / n * 1e6
    longest = int(per_channel.max())
    # each input read once (ops, luns, channels: 4 bytes; valid: 1), each
    # output written once (a completion, 4 bytes; one makespan); the max
    # and two adds of a request
    return dict(bound(17 * n + 4, 3 * n), requests=n, ms=ms,
                prefix_ms=prefix_ms, plain_ms=plain_ms, prefix=k,
                device_us=dev_us, ns_per_request=ms / n * 1e6,
                random_requests=n_req, random_rows=rows,
                custom16_requests=c16[0].shape[1], max_abs_err=0.0,
                whole_ms=whole_ms, whole_ns=whole_ms / n * 1e6,
                chain_ns=chain_ns, longest_chain=longest,
                per_channel=per_channel.tolist(),
                chain_floor_ms=longest * chain_ns * 1e-6)


def phase_workloads(torch, np, ops, pc_ops, pc_ref, golden: dict,
                    kv: dict, figures: dict) -> dict:
    """Phase 14: every section of the paper's per-op benchmarks and the
    legacy oracles on the card, each held to the reference's golden
    summary; each page-granular timing call one ``page_clock`` launch and
    each legacy allocation one ``zns_alloc`` row launch; then ``page_clock``
    against its plain version and timed.  The engine paths of (a) and (b)
    are phase 17's ``figures`` (:func:`workloads_section`)."""
    check(golden["params"] == json.loads(json.dumps(WORKLOAD_PARAMS)),
          "phase 14: the golden file's parameters are not this script's")
    P = torch_workloads_package()
    card = gpu_name_and_limit()
    got, secs, counts = {}, {}, {}
    for name in WORKLOAD_SECTIONS:
        made = Instances(P.legacy_cls)
        timed = Calls(P.timing, "simulate_fleet")
        ops.reset_launches()
        pc_ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            got[name] = workloads_section(
                P, np, name, recs=kv["recs"] if name == "kv_legacy" else None,
                figures=figures)
            torch.cuda.synchronize()
        finally:
            made.close()
            timed.close()
        secs[name] = time.perf_counter() - t0
        c = counts[name] = dict(ops.counts, page_clock=pc_ops.launches,
                                page_clock_rows=dict(pc_ops.rows))
        allocs = sum(d.allocate_calls for d in made.made)
        check(c["page_clock"] == timed.n and c["rows"] == allocs
              and c["alloc_select"] == c["grow_select"]
              and pc_ops.rows["whole"] == 0,
              f"phase 14: {name} launched {c}, want page_clock once per "
              f"page-granular timing call ({timed.n}) with every device "
              f"row a chain a channel (each LUN on one channel), a row "
              f"selection per legacy allocate call ({allocs}) and one grow "
              f"per ALLOC selection")
        check_fleet_golden(golden_part(got[name]), golden[name],
                           f"phase 14: {name}",
                           time_keys=WORKLOAD_TIME_KEYS)
        log(f"phase 14: {name} == tests/data/torch_workloads_zn540.json; "
            f"launches {c} ({len(made.made)} legacy devices, {allocs} "
            f"allocate calls); {secs[name]:.3f} s ({card})")

    # (a) Fig. 4b / 7d: the three paths agree exactly
    intf = got["interference"]
    for spec_name in WORKLOAD_PARAMS["interference"]["specs"]:
        s = intf[spec_name]
        check(s["legacy_equal"] and s["sweep_equal"],
              f"phase 14: the interference paths disagree on {spec_name}")
    fill = intf["_fill"]
    log(f"phase 14 (a): Fig. 4b / 7d at zn540 (fill {fill} pages a zone, "
        f"max_active 28): shim == legacy == engine sweep (phase 17's), "
        f"exactly; "
        f"concurrency | FIXED interference, dummy pages | SUPERBLOCK "
        f"interference, dummy pages | page steps (FIXED base + contended)")
    page_steps = 0
    for fx, sb in zip(intf["fixed"]["rows"], intf["superblock"]["rows"]):
        c = int(fx["concurrency"])
        steps = sum(2 * c * fill + r["dummy_pages"] for r in (fx, sb))
        page_steps += int(steps)
        log(f"phase 14 (a): {c} | {fx['interference']!r}, "
            f"{fx['dummy_pages']:.0f} | {sb['interference']!r}, "
            f"{sb['dummy_pages']:.0f} | "
            f"{2 * c * fill + int(fx['dummy_pages'])}")
    log(f"phase 14 (a): worst FIXED {max(r['interference'] for r in intf['fixed']['rows'])!r}, "
        f"worst SUPERBLOCK "
        f"{max(r['interference'] for r in intf['superblock']['rows'])!r}; "
        f"{page_steps} page steps a path, {3 * page_steps} in all")
    # (b) Fig. 9
    fio = got["fio"]
    check(fio["engine_equal"] and fio["shim_equal"],
          "phase 14: the Fig. 9 paths disagree")
    for where in dict.fromkeys(r["geometry"] for r in fio["rows"]):
        cells = [f"{r['request_kib']:.0f}K x{r['n_jobs']:.0f} "
                 f"{r['bandwidth_mib_s']:.1f}" for r in fio["rows"]
                 if r["geometry"] == where]
        log(f"phase 14 (b): Fig. 9 {where} MiB/s: {'; '.join(cells)}")
    log(f"phase 14 (b): legacy == engine (phase 17's Fig. 9) on all "
        f"{len(fio['rows'])} points, "
        f"shim == legacy on {fio['shim_geometry']}")
    # (c) Table 4
    lat = got["alloc_latency"]
    for spec_name in WORKLOAD_PARAMS["alloc_latency"]["specs"]:
        sh, lg = lat[f"_{spec_name}_shim"], lat[f"_{spec_name}_legacy"]
        log(f"phase 14 (c): Table 4 {spec_name} at zn540: median alloc "
            f"latency shim {sh['median_us']:.1f} us (mean "
            f"{sh['mean_us']:.1f}), legacy {lg['median_us']:.1f} us (mean "
            f"{lg['mean_us']:.1f}); {lg['n_allocs']:.0f} allocs each")
    # (d)-(f) the comparators
    evl = got["engine_vs_legacy"]["_rep"]
    check(evl["interference_recompiles"] == 0,
          "phase 14: the interference sweep added launch plans across "
          "its timed repeats")
    log(f"phase 14 (d): engine vs legacy at zn540 ({card}): dlwa sweep "
        f"legacy {evl['dlwa_legacy_s']:.6f} s, engine "
        f"{evl['dlwa_engine_s']:.6f} s, speedup {evl['dlwa_speedup']:.4f}; "
        f"interference legacy {evl['interference_legacy_s']:.6f} s, engine "
        f"{evl['interference_engine_s']:.6f} s, speedup "
        f"{evl['interference_speedup']:.4f}; plan growth "
        f"{evl['interference_recompiles']:.0f}")
    for run in ("sweep", "mixed"):
        r = got["fleet_vs_legacy"][f"_{run}"]
        log(f"phase 14 (e): fleet {run} ({r['n_configs']:.0f} configs, "
            f"{r['fleet_ops']:.0f} ops; {card}): legacy {r['legacy_s']:.3f} "
            f"s (measured {r['legacy_measured_s']:.3f} s on "
            f"{r['legacy_timed_configs']:.0f} configs x scale "
            f"{r['legacy_scale']:.0f}; replay only "
            f"{r['legacy_replay_s']:.3f} s), engine {r['engine_s']:.3f} s, "
            f"speedup {r['speedup']:.4f}, replay speedup "
            f"{r['replay_speedup']:.4f}")
    arr = got["array_vs_legacy"]["_rep"]
    log(f"phase 14 (f): arrays ({arr['n_arrays']:.0f}, "
        f"{arr['lane_ops']:.0f} lane ops; {card}): legacy "
        f"{arr['legacy_s']:.3f} s (measured "
        f"{arr['legacy_measured_s']:.3f} s on "
        f"{arr['legacy_timed_arrays']:.0f} arrays x "
        f"{arr['legacy_scale']:.0f}), engine {arr['engine_s']:.3f} s, "
        f"speedup {arr['speedup']:.4f}")
    # (g) the KV lanes: the legacy replay's DLWA is the dispatch's
    for lane in got["kv_legacy"]["lanes"]:
        want = kv["lanes"][(lane["workload"], "traditional")]["dlwa"]
        check(lane["dlwa"] == want,
              f"phase 14: legacy {lane['workload']} DLWA {lane['dlwa']!r} "
              f"!= phase 11's traditional lane {want!r}")
        log(f"phase 14 (g): {lane['workload']} traditional lane replayed "
            f"through LegacyZNSDevice: DLWA {lane['dlwa']!r} == phase 11's "
            f"dispatch, {lane['block_erases']} block erases")

    # (h) the kernel against its plain version, then timed
    t0 = time.perf_counter()
    pc = phase_page_clock(torch, np, P, pc_ops, pc_ref)
    log(f"phase 14 (h): page_clock == plain version bit for bit on "
        f"{2 * PAGE_CLOCK_CASES} random padded batches and 16 LUNs a "
        f"channel ({pc['random_requests']} requests; rows "
        f"{pc['random_rows']}), the custom16 stream "
        f"({pc['custom16_requests']} requests, one chain a channel) and "
        f"the first {pc['prefix']} of the FIXED concurrency-7 contended "
        f"stream ({pc['requests']} requests, one chain a channel: "
        f"{pc['per_channel']} a channel); kernel {pc['ms']:.6f} ms a launch "
        f"on the whole stream = {pc['ns_per_request']:.3f} ns a request, "
        f"device {pc['device_us']} us a launch; the same length stepped "
        f"whole {pc['whole_ms']:.6f} ms ({pc['whole_ns']:.3f} ns a "
        f"request), as one chain {pc['chain_ns']:.3f} ns a request, so the "
        f"longest chain ({pc['longest_chain']}) floors the stream at "
        f"{pc['chain_floor_ms']:.6f} ms; {pc['prefix_ms']:.6f} ms on the "
        f"prefix, plain {pc['plain_ms']:.3f} ms on the prefix; bound "
        f"{pc['bound_ms']:.6f} ms ({pc['bound_by']}: {pc['bytes']} bytes); "
        f"checks and timings {time.perf_counter() - t0:.1f} s ({card})")
    log(f"phase 14: {sum(secs.values()):.1f} s of sections "
        f"{ {k: round(v, 3) for k, v in secs.items()} }")
    return {"counts": counts, "secs": secs, "page_clock": pc,
            "rows_launches": sum(c["rows"] for c in counts.values()),
            "page_clock_launches": sum(c["page_clock"]
                                       for c in counts.values()),
            "page_clock_rows": {k: sum(c["page_clock_rows"][k]
                                       for c in counts.values())
                                for k in ("chains", "whole")}}


# --------------------------------------------------------------------- #
# phase 17: the paper's figures
# --------------------------------------------------------------------- #
#: phase 17's figures: every function of ``tools/paper_figures.py`` at its
#: paper defaults, and ``tools/ckpt_zns.run_all`` (the golden file's
#: sections, named as the reference's ``benchmarks/run.py`` rows)
FIGURES = ("fig4a_7a_dlwa_vs_occupancy", "fig4b_7d_interference",
           "fig7b_sa_dlwa_tradeoff", "fig7c_wear", "fig7c_wear_leveling",
           "fig8_geometry_sweep", "fig9_throughput", "table3_interference",
           "table4_alloc_latency", "ckpt_zns_all_archs")
#: golden keys built from clocks (interference factors, bandwidths): held
#: at rel 1e-5
FIGURE_TIME_KEYS = {"baseline", "silentzns", "worst_baseline",
                    "worst_silentzns", "mib_s", "peak_P16_1job", "P8_1job",
                    "P8_2jobs"}
#: float64 wear statistics: held at rel 1e-12 (see FLEET_STAT_KEYS)
FIGURE_STAT_KEYS = {"baseline_std", "silentzns_std"}
#: the Table 3 stream that phase 17 times ``page_clock`` on: the widest
#: custom16 geometry's FIXED contended stream
FIGURE_STREAM = (16, 2)


#: the whole script's cuts of phase 17 (``--phase17`` runs every figure
#: whole; the paper's sizes until the script passed 1,200 s on a slow
#: host): Fig. 7c's wear at 4 x 400k ops (1M; at 250k no block is
#: erased) and its leveling at 100 rounds (400), held to
#: ``tests/data/torch_figures_cut.json``; Table 4, one shim command an
#: allocation, over two of the six geometries (those of phase 18's design
#: space), held to the golden file's cells of them
FIGURE_CUTS = {"fig7c_wear": {"n_ops": 400_000},
               "fig7c_wear_leveling": {"rounds": 100},
               "table4_alloc_latency": {"geometries": "P4,S32;P16,S256"}}


def cut_figure(name: str, fn, want: dict, cuts: dict, cut_golden: dict):
    """Figure ``name``'s function and golden summary under ``cuts``
    (:data:`FIGURE_CUTS`): its keywords given to ``fn``; the summary
    ``cut_golden``'s, or for a cut of geometries ``want``'s cells of
    those geometries."""
    if name not in cuts:
        return fn, want
    import functools
    kw = dict(cuts[name])
    if "geometries" not in kw:
        return functools.partial(fn, **kw), cut_golden[name]
    from repro_torch.tools.zns_design_space import named_geometries
    names = {n.replace(" ", "") for n in kw["geometries"].split(";")}
    return (functools.partial(fn, geometries=named_geometries(
                kw["geometries"])),
            dict(want, n_allocs=[r for r in want["n_allocs"]
                                 if r["geometry"].replace(" ", "")
                                 in names]))


def figure_functions(device: str) -> dict:
    """Phase 17's figures through the port on ``device``."""
    import functools

    from repro_torch.tools import ckpt_zns
    from repro_torch.tools import paper_figures as PF
    return {name: functools.partial(
        ckpt_zns.run_all if name == "ckpt_zns_all_archs"
        else getattr(PF, name), device=device) for name in FIGURES}


def figure_summary(name: str, out: dict) -> dict:
    """A figure's output as the golden file holds it: the run's own keys
    dropped; Table 3 with its unrounded factors beside the rounded ones
    (``unrounded``); Table 4, whose times are the card's own, as its keys
    and each cell's sample count (None where the element does not apply
    to the geometry)."""
    if name == "table4_alloc_latency":
        return json.loads(json.dumps({
            "keys": sorted(k for k in out if not k.startswith("_")),
            "n_allocs": out["_n_allocs"]}))
    part = golden_part(out)
    if name == "table3_interference":
        part["unrounded"] = json.loads(json.dumps(out["_rows"]))
    return part


def figure_mismatches(name: str, got: dict, want: dict) -> list:
    """Where a figure's summary (:func:`figure_summary`) differs from the
    golden file's.  Table 3's unrounded factors are held at rel 1e-5;
    its 2-decimal factors must be this run's own factors rounded, and
    equal the golden file's unless a clock's last f32 bit moved a factor
    across a rounding boundary (one step, 0.01), which also frees the
    multi-segment gap by as much."""
    if name != "table3_interference":
        return fleet_mismatches(got, want, name, time_keys=FIGURE_TIME_KEYS,
                                stat_keys=FIGURE_STAT_KEYS)
    specs = {k for row in want["unrounded"] for k in row} - {"geometry"}
    bad = fleet_mismatches(got["unrounded"], want["unrounded"],
                           f"{name}.unrounded", time_keys=specs,
                           stat_keys=FIGURE_STAT_KEYS)
    if sorted(got) != sorted(want) or len(got["rows"]) != len(want["rows"]):
        return bad + [f"{name}: keys or rows differ"]
    flips = 0
    for i, (g, w, u) in enumerate(zip(got["rows"], want["rows"],
                                      got["unrounded"])):
        if sorted(g) != sorted(w) or g["geometry"] != w["geometry"]:
            bad.append(f"{name}.rows[{i}]: keys differ")
            continue
        for k in specs & set(w):
            if math.isnan(w[k]) and math.isnan(g[k]):
                continue
            if g[k] != round(u[k], 2):
                bad.append(f"{name}.rows[{i}].{k}: {g[k]!r} is not "
                           f"round({u[k]!r}, 2)")
            elif g[k] != w[k]:
                flips += 1
                if not abs(g[k] - w[k]) <= 0.0100001:
                    bad.append(f"{name}.rows[{i}].{k}: {g[k]!r} != "
                               f"{w[k]!r}")
    gap = "fixed_minus_vchunk2_multiseg"
    g, w = got[gap], want[gap]
    if not (math.isnan(g) and math.isnan(w)) and not (
            g == w or (flips and abs(g - w) <= 0.0100001)):
        bad.append(f"{name}.{gap}: {g!r} != {w!r} ({flips} rounding "
                   f"flips)")
    return bad


def figures_page_clock_timing(torch, np, pc_ops, pc_ref) -> dict:
    """``page_clock`` at phase 17's widest stream: Table 3's FIXED
    contended stream at custom16 :data:`FIGURE_STREAM`, held bit for bit
    against the plain version on its first :data:`PAGE_CLOCK_PREFIX`
    requests (on the CPU, as phase 14 does), then timed: the kernel
    (CUDA events a call, ``torch.profiler`` a launch), the plain version
    on a 2,000-request prefix, and the bound from these inputs."""
    from types import SimpleNamespace

    from repro_torch.core import FIXED, ZoneGeometry, custom16, timing
    from repro_torch.core import workloads as W
    flash = custom16()
    eng = W.make_engine(flash, ZoneGeometry(
        parallelism=FIGURE_STREAM[0], n_segments=FIGURE_STREAM[1]), FIXED,
        max_active=64, device="cuda")
    c = min(8, eng.cfg.n_zones // 2)
    prog = W.interference_program(eng, concurrency=c)
    before = pc_ops.launches
    _, trace = eng.run(eng.init_state(), prog)
    streams = W._op_traces(eng, prog, trace)
    traces = [t for t in streams[c:] if t is not None and len(t.luns)]
    full, times = merged_stream(torch, SimpleNamespace(timing=timing),
                                traces, flash)
    n = full[0].shape[1]
    k = min(PAGE_CLOCK_PREFIX, n)
    prefix = [a[:, :k].contiguous() for a in full]
    got, rows = page_clock_rows(pc_ops,
                                lambda: pc_ops.simulate_fleet(*full, *times))
    want = pc_ref.simulate_fleet_ref(*[a.cpu() if hasattr(a, "cpu") else a
                                       for a in prefix + times])
    check(torch.equal(got[0][:, :k].cpu(), want[0]) and rows == {
        "chains": 1, "whole": 0},
        f"phase 17: page_clock differs from its plain version on the "
        f"Table 3 stream's prefix, or stepped it {rows}")
    short = [a[:, :2000].contiguous() for a in full]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc_ref.simulate_fleet_ref(*short, *times)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = cuda_ms(torch, lambda: pc_ops.simulate_fleet(*full, *times),
                 iters=10)
    dev_us = device_us(torch, lambda: pc_ops.simulate_fleet(*full, *times),
                       "page_clock", reps=5)
    pc_ops.launches = before                 # checks and timings
    # as phase 14: each input read once, each output written once; the
    # max and two adds of a request
    return dict(bound(17 * n + 4, 3 * n), requests=n, ms=ms,
                device_us=dev_us, plain_ms=plain_ms, plain_requests=2000,
                prefix=k, max_abs_err=0.0, concurrency=c)


def figures_fused_shapes(torch, np, ops, ref) -> dict:
    """Both fused selections against their plain versions, bit for bit,
    at every custom16 shape that a selecting engine of Fig. 8 and Tables
    3-4 launches them at (each (geometry, element) pair's grid, at
    ``max_active`` 64: 32 gives the same grids), on 8 lanes of the
    engine's own lane table and on 8 random lanes of the same grid.
    Returns the shapes checked and the largest difference (0)."""
    from repro_torch.core import (FIXED, PAPER_GEOMETRIES, custom16,
                                  engine, is_applicable)
    from repro_torch.core import workloads as W
    from repro_torch.tools.paper_figures import ELEMENTS
    flash, dev, L = custom16(), torch.device("cuda"), 8
    rng = np.random.default_rng(1717)
    before = dict(ops.counts)
    shapes, err = {}, 0
    for geom in PAPER_GEOMETRIES:
        for spec in ELEMENTS:
            if spec is FIXED or not is_applicable(spec, geom, flash):
                continue
            cfg = W.make_engine(flash, geom, spec, max_active=64,
                                device="cuda").cfg
            dims = (cfg.n_groups, cfg.per_group, cfg.take, cfg.zone_groups)
            if dims + (cfg.parallelism, cfg.n_zones) in shapes.values():
                continue
            shapes[f"{geom.describe(flash)} {spec.name}"] = dims + (
                cfg.parallelism, cfg.n_zones)
            b = random_lanes(torch, np, rng, L, *dims, cfg.parallelism,
                             cfg.n_zones, "cuda")
            err = max(err, compare_fused(torch, ops, ref, b, dims))
            b["lanes"] = engine._lanes(cfg, engine._lane_dyn(
                cfg, None, L, dev)).sel
            err = max(err, compare_fused(torch, ops, ref, b, dims))
    ops.counts.update(before)
    return {"shapes": shapes, "max_abs_err": err}


def phase_figures(torch, np, ops, ref, pc_ops, pc_ref, golden: dict,
                  cuts: dict = None, cut_golden: dict = None) -> dict:
    """Phase 17: every figure of ``tools/paper_figures.py`` at the paper's
    sizes (but for ``cuts``, :func:`cut_figure`) and
    ``tools/ckpt_zns.run_all`` on the card, each held to the
    reference's outputs (``tests/data/torch_figures_paper.json``), with
    one ``alloc_select`` and one ``grow_select`` launch per op step of a
    non-FIXED engine (a FIXED engine's ALLOC is a plain argmin over
    whole-zone elements) and one ``page_clock`` launch per
    page-granular timing call
    (counts zeroed before and read after each figure); then both fused
    selections held to their plain versions at every custom16 shape the
    figures launch them at (:func:`figures_fused_shapes`), held and timed
    at Fig. 7c's two-lane table, and ``page_clock`` at Table 3's widest
    stream."""
    from repro_torch.core import (SUPERBLOCK, ElementKind, engine,
                                  stack_dyn, timing, zn540)
    from repro_torch.core import workloads as W
    from repro_torch.tools.run_figures import DERIVED
    check(sorted(golden) == sorted(FIGURES),
          "phase 17: the golden file's sections are not this script's")
    cuts = cuts or {}
    check(not cuts or cut_golden["params"] == json.loads(json.dumps(cuts)),
          "phase 17: tests/data/torch_figures_cut.json was written for "
          "other cuts")
    card = gpu_name_and_limit()
    fns = figure_functions("cuda")
    got, counts = {}, {}
    for name in FIGURES:
        steps = Calls(engine, "_apply_op_impl", key=lambda cfg, *_: (
            "fixed" if cfg.kind is ElementKind.FIXED else "selecting"))
        timed = Calls(timing, "simulate_fleet")
        ops.reset_launches()
        pc_ops.reset_launches()
        torch.cuda.synchronize()
        fn, want = cut_figure(name, fns[name], golden[name], cuts,
                              cut_golden)
        try:
            out = got[name] = fn()
            torch.cuda.synchronize()
        finally:
            steps.close()
            timed.close()
        c = counts[name] = dict(ops.counts, page_clock=pc_ops.launches,
                                page_clock_rows=dict(pc_ops.rows),
                                op_steps=dict(steps.by),
                                timing_calls=timed.n)
        facts = {k: v for k, v in out.items()
                 if k.startswith("_") and not isinstance(v, (list, dict))}
        selecting = steps.by.get("selecting", 0)
        check(c["alloc_select"] == c["grow_select"] == selecting
              == out["_alloc_select"]
              and steps.n == out["_op_steps"]
              and c["rows"] == 0
              and c["page_clock"] == timed.n == out["_page_clock"]
              and pc_ops.rows["whole"] == 0,
              f"phase 17: {name} launched {c} (run facts {facts}), want "
              f"one alloc_select and one grow_select per op step of a "
              f"non-FIXED engine ({steps.by}), no row selection, and "
              f"page_clock once per page-granular timing call "
              f"({timed.n}), a chain a channel")
        bad = figure_mismatches(name, figure_summary(name, out), want)
        held = ("tests/data/torch_figures_cut.json" if name in cuts
                and "geometries" not in cuts[name]
                else "tests/data/torch_figures_paper.json")
        for m in bad[:40]:
            print(f"chip_smoke: mismatch: {m}", file=sys.stderr, flush=True)
        check(not bad, f"phase 17: {name}: {len(bad)} mismatches with "
                       f"{held}")
        derived = "; ".join(f"{k} {out[k]!r}" for k in DERIVED[name])
        cut = f" (cut: {cuts[name]})" if name in cuts else ""
        log(f"phase 17: {name}{cut} == {held}; "
            f"{out['_seconds']:.3f} s, {out['_dispatches']} dispatches, "
            f"{out['_op_steps']} op steps ({selecting} on "
            f"selecting engines), {out['_lane_ops']} lane ops = "
            f"{out['_lane_ops'] / out['_seconds']:.1f} lane-ops/s; "
            f"alloc_select {c['alloc_select']}, grow_select "
            f"{c['grow_select']}, page_clock {c['page_clock']} "
            f"({c['timing_calls']} timing calls); {derived} ({card})")

    fig7b = got["fig7b_sa_dlwa_tradeoff"]
    log(f"phase 17: Fig. 7b recorded ops a threshold "
        f"{fig7b['_recorded_ops']} (1M KVBench ops each); rows "
        + "; ".join(f"thr {r['threshold']}: SA {r['sa']!r}, DLWA "
                    f"{r['baseline_dlwa']!r} -> {r['silentzns_dlwa']!r}"
                    for r in fig7b["rows"]))
    wear = got["fig7c_wear"]["_wear"]
    n_ops = cuts.get("fig7c_wear", {}).get("n_ops", 1_000_000)
    log(f"phase 17: Fig. 7c wear (4 x {n_ops} ops, "
        f"{got['fig7c_wear']['_recorded_ops']} recorded ops a device): "
        + "; ".join(f"{k} {v}" for k, v in wear.items()))
    log(f"phase 17: Fig. 7c leveling "
        f"({cuts.get('fig7c_wear_leveling', {}).get('rounds', 400)} "
        f"rounds): "
        f"{got['fig7c_wear_leveling']['_wear']}")
    fig8 = got["fig8_geometry_sweep"]
    sel = {(r["geometry"], r["element"]): r["dummy_pages_per_zone"]
           for r in fig8["rows"] if r["occupancy"] == 0.0001}
    log(f"phase 17: Fig. 8 at P8, S128, occupancy 0.0001: fixed "
        f"{sel[('P8, S128', 'fixed')]!r} / vchunk2 "
        f"{sel[('P8, S128', 'vchunk2')]!r} dummy pages a zone = "
        f"{fig8['fixed_over_vchunk2_P8S128']!r} (paper 4.0)")
    for row in got["table3_interference"]["rows"]:
        log(f"phase 17: Table 3 {row['geometry']}: "
            + ", ".join(f"{k} {v!r}" for k, v in row.items()
                        if k != "geometry"))
    t4 = got["table4_alloc_latency"]["rows"]
    for row in t4:
        log(f"phase 17: Table 4 {row['geometry']} median allocation us on "
            f"the card ({card}): "
            + ", ".join(f"{k} {v!r}" for k, v in row.items()
                        if k != "geometry"))
    log("phase 17: Table 4 median over geometries a element, us: "
        + ", ".join(f"{k} {float(np.nanmedian([r[k] for r in t4]))!r}"
                    for k in t4[0] if k != "geometry"))
    total_s = sum(o["_seconds"] for o in got.values())
    log(f"phase 17: {total_s:.1f} s of figures, "
        f"{sum(o['_op_steps'] for o in got.values())} op steps, "
        f"{sum(o['_dispatches'] for o in got.values())} dispatches")

    # both fused selections at the figures' custom16 shapes, and at
    # Fig. 7c's two-lane table (one dispatch, wear_aware off and on);
    # page_clock at Table 3's widest stream
    shapes = figures_fused_shapes(torch, np, ops, ref)
    log(f"phase 17: zns_alloc alloc_select and grow_select == plain "
        f"versions, bit for bit (max_abs_err {shapes['max_abs_err']}), at "
        f"the {len(shapes['shapes'])} custom16 grids of Fig. 8 and Tables "
        f"3-4's selecting engines (G, W, take, zone groups, P, zones): "
        + "; ".join(f"{k} {v}" for k, v in shapes["shapes"].items()))
    flash, zone = zn540()
    eng = W.make_engine(flash, zone, SUPERBLOCK, max_active=14,
                        device="cuda")
    dyn = stack_dyn([eng.dyn(wear_aware=False), eng.dyn(wear_aware=True)])
    fused = fused_timing(torch, np, ops, ref, engine, eng, dyn, seed=17)
    for kname, t in fused.items():
        log(f"phase 17: zns_alloc {kname} at Fig. 7c's two-lane table "
            f"({t['rows']} row selections): kernel {t['ms']:.6f} ms a "
            f"call, device {t['device_us']} us a launch, plain "
            f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
    pc = figures_page_clock_timing(torch, np, pc_ops, pc_ref)
    log(f"phase 17: page_clock at Table 3's custom16 P{FIGURE_STREAM[0]} "
        f"x{FIGURE_STREAM[1]} FIXED contended stream (concurrency "
        f"{pc['concurrency']}, {pc['requests']} requests; == plain on the "
        f"first {pc['prefix']}): kernel {pc['ms']:.6f} ms a launch, device "
        f"{pc['device_us']} us, plain {pc['plain_ms']:.3f} ms on "
        f"{pc['plain_requests']} requests, bound {pc['bound_ms']:.6f} ms "
        f"({pc['bound_by']}) ({card})")
    return {"got": got, "counts": counts, "fused": fused, "page_clock": pc,
            "seconds": total_s, "shapes_err": shapes["max_abs_err"],
            "launches": {k: sum(c[k] for c in counts.values())
                         for k in ("alloc_select", "grow_select",
                                   "page_clock")}}


# --------------------------------------------------------------------- #
# phase 18: the reference's CLIs and examples as port-side drivers
# --------------------------------------------------------------------- #
#: the reference's script behind each port driver
#: (``repro_torch.tools.<driver>``)
CLI_SCRIPTS = {"fleet_search": "benchmarks/fleet_search.py",
               "raid_zns": "benchmarks/raid_zns.py",
               "quickstart": "examples/quickstart.py",
               "zns_design_space": "examples/zns_design_space.py",
               "raid_array": "examples/raid_array.py",
               "fleet_example": "examples/fleet.py"}
#: phase 18's runs at the golden file's sizes: name -> (driver, argv).
#: ``zns_design_space``'s ``--geometries`` is the port driver's (the
#: reference's example has no flag: the golden file swaps its geometry
#: constant); the others are the reference's own flags
CLI_RUNS = {
    "fleet_search_grid_obs": ("fleet_search", ["--quick", "--obs"]),
    "fleet_search_random": ("fleet_search", ["--quick", "--strategy",
                                             "random"]),
    "fleet_search_evolve": ("fleet_search", ["--quick", "--strategy",
                                             "evolve"]),
    "fleet_search_workload": ("fleet_search", ["--workload", "lsm",
                                               "--quick"]),
    "raid_zns_sweep": ("raid_zns", ["--quick"]),
    "raid_zns_parity": ("raid_zns", ["--devices", "4", "--parity",
                                     "--files", "12"]),
    "raid_zns_rebuild": ("raid_zns", ["--rebuild", "--devices", "4"]),
    "quickstart": ("quickstart", []),
    "zns_design_space": ("zns_design_space", ["--geometries",
                                              "P4,S32;P16,S256"]),
    "raid_array": ("raid_array", []),
    "fleet_example": ("fleet_example", []),
}
#: ``--phase18``: every driver at its defaults (the reference's), timed
CLI_DEFAULT_RUNS = {
    "fleet_search_grid": ("fleet_search", []),
    "fleet_search_evolve": ("fleet_search", ["--strategy", "evolve"]),
    "raid_zns_sweep": ("raid_zns", []),
    "raid_zns_parity": ("raid_zns", ["--devices", "8", "--parity"]),
    "raid_zns_rebuild": ("raid_zns", ["--rebuild", "--devices", "4"]),
    "quickstart": ("quickstart", []),
    "zns_design_space": ("zns_design_space", []),
    "raid_array": ("raid_array", []),
    "fleet_example": ("fleet_example", []),
}
#: the functions whose outputs a driver's summary holds, by attribute path
#: in the driver's module (the same names in the reference's script),
#: read off each call by wrapping them for the run
CLI_SPIES = {
    "fleet_search": ("score_rows",),
    "raid_zns": ("raid_benchmark", "fleet_run", "rebuild_run"),
    "quickstart": ("dlwa_benchmark",),
    "zns_design_space": ("dlwa_benchmark", "interference_benchmark",
                         "alloc_latency_benchmark"),
    "raid_array": ("lsm_over", "timing.run_fleet_trace"),
    "fleet_example": ("score_rows", "evolve"),
}
#: the files a run writes that its summary holds (in the run's directory)
CLI_FILES = ("fleet_pareto.json", "fleet_workload_lsm.json",
             "fleet_obs.json", "fleet_trace.json")
#: the sidecar keys that are the run's own: the reference's compile
#: profile and recompile table, the port's profile and launch counts
CLI_OBS_OWN = ("profile", "jit_cache")
#: printed numbers that are clocks or built from one, masked in the
#: printed lines (the summary holds them at rel 1e-5), by run: (regex,
#: replacement); a CSV row's own time column goes too
_CSV = (r"^([a-z][^,]*),[0-9.e+-]+,", r"\1,")
_CLOCK_KEYS = (r"(p99_latency_s|makespan_s|score|best_so_far|best_of_gen|"
               r"best_objective)=[^;]*", r"\1=#")
CLI_MASKS = {
    "fleet_search": (_CSV, _CLOCK_KEYS),
    "raid_zns_sweep": (_CSV, _CLOCK_KEYS),
    "raid_zns_parity": ((r"^fleet_makespan_s,.*", "fleet_makespan_s,#"),),
    "raid_zns_rebuild": ((r"^(\w*makespan_s|rebuild_interference),.*",
                          r"\1,#"),),
    "quickstart": (),
    "zns_design_space": ((r"^(\s*P\d+, S\d+\s+\S+\s+\S+)\s+\S+\s+\S+$",
                          r"\1 # #"),),
    "raid_array": ((r"fleet makespan: [0-9.]+ ms", "fleet makespan: # ms"),
                   (r"in one (vmapped scan|batched pass)", "in one #")),
    "fleet_example": ((r"in [0-9.]+s", "in #s"),
                      (r"(p99|score|best_so_far)=[0-9.]+", r"\1=#"),
                      (r"objective [0-9.]+", "objective #")),
}
#: summary keys built from clocks, held at rel 1e-5 (as is every key
#: ending in ``_s``)
CLI_TIME_KEYS = FLEET_TIME_KEYS | {"score", "objective", "target",
                                   "p99_over_p50", "interference"}


def cli_masks(name: str) -> tuple:
    """Run ``name``'s masks: its own, else its driver's."""
    if name in CLI_MASKS:
        return CLI_MASKS[name]
    return CLI_MASKS.get((CLI_RUNS.get(name) or CLI_DEFAULT_RUNS[name])[0],
                         ())


def cli_jsonable(x):
    """A spied output as JSON holds it: dataclasses as dicts, keys of
    wall-clock times (``*_us``) dropped, NaN kept."""
    import dataclasses
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): cli_jsonable(v) for k, v in x.items()
                if not str(k).endswith("_us")}
    if isinstance(x, (list, tuple)):
        return [cli_jsonable(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    return x


def run_cli(module, argv: list, driver: str, cwd, script=None) -> dict:
    """Run ``module.main`` with ``argv`` as its command line (passed in,
    or with ``script`` as ``sys.argv`` for a main that reads it) in
    directory ``cwd``, its standard output captured and the outputs of the
    functions :data:`CLI_SPIES` names for ``driver`` recorded: ``{"lines":
    printed lines, "spied": {name: [outputs]}, "files": {file: text},
    "seconds": wall seconds}``."""
    import contextlib
    import io
    import os
    spied = {}
    patches = []
    for path in CLI_SPIES[driver]:
        *owner, attr = path.split(".")
        obj = module
        for o in owner:
            obj = getattr(obj, o)
        inner, sink = getattr(obj, attr), spied.setdefault(path, [])

        def spy(*a, _inner=inner, _sink=sink, **kw):
            out = _inner(*a, **kw)
            _sink.append(out)
            return out
        setattr(obj, attr, spy)
        patches.append((obj, attr, inner))
    buf, here, saved_argv = io.StringIO(), os.getcwd(), sys.argv
    os.chdir(cwd)
    try:
        for f in CLI_FILES:
            Path(f).unlink(missing_ok=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if script is None:
                module.main(argv)
            else:
                sys.argv = [script] + list(argv)
                module.main()
        secs = time.perf_counter() - t0
        files = {f: Path(f).read_text() for f in CLI_FILES
                 if Path(f).exists()}
    finally:
        os.chdir(here)
        sys.argv = saved_argv
        for obj, attr, inner in patches:
            setattr(obj, attr, inner)
    return {"lines": buf.getvalue().splitlines(), "spied": spied,
            "files": files, "seconds": secs}


def cli_summary(name: str, argv: list, run: dict) -> dict:
    """A run as the golden file holds it: its command line, its printed
    lines with the clocks masked (:data:`CLI_MASKS`), the spied outputs,
    the files it wrote (the Perfetto trace as its event count, the
    sidecar without :data:`CLI_OBS_OWN`, whose values are the run's own,
    but with its keys and the names in its ``jit_cache`` under ``_keys``
    and ``_jit_cache``)."""
    import re
    lines = []
    for line in run["lines"]:
        for pat, rep in cli_masks(name):
            line = re.sub(pat, rep, line)
        lines.append(line)
    files = {}
    for f, text in run["files"].items():
        obj = json.loads(text)
        if f == "fleet_trace.json":
            obj = {"n_events": len(obj["traceEvents"])}
        elif f == "fleet_obs.json":
            obj = dict({k: v for k, v in obj.items()
                        if k not in CLI_OBS_OWN},
                       _keys=sorted(obj), _jit_cache=sorted(
                           obj.get("jit_cache", {})))
        files[f] = obj
    return json.loads(json.dumps({
        "argv": list(argv), "lines": lines,
        "spied": cli_jsonable(run["spied"]), "files": files}))


def cli_mismatches(name: str, got: dict, want: dict) -> list:
    """Where a run's summary differs from the golden file's: lines
    exactly, spied outputs and files as :func:`fleet_mismatches` holds
    them (clocks at rel 1e-5, :data:`CLI_TIME_KEYS`), but for the names in
    the sidecar's ``jit_cache``, which differ by design (the reference
    counts compiled shapes a dispatch surface, the port its selection
    kernels' launches)."""
    got, want = (dict(x, files={
        f: {k: v for k, v in obj.items() if k != "_jit_cache"}
        for f, obj in x["files"].items()}) for x in (got, want))
    bad = []
    if got["lines"] != want["lines"]:
        bad += [f"{name}.lines[{i}]: {g!r} != {w!r}"
                for i, (g, w) in enumerate(zip(got["lines"],
                                               want["lines"])) if g != w]
        if len(got["lines"]) != len(want["lines"]):
            bad.append(f"{name}.lines: {len(got['lines'])} lines, want "
                       f"{len(want['lines'])}")
    for part in ("argv", "spied", "files"):
        bad += fleet_mismatches(got[part], want[part], f"{name}.{part}",
                                time_keys=CLI_TIME_KEYS)
    return bad


def cli_modules() -> dict:
    """The port's drivers, by driver name."""
    import importlib
    return {d: importlib.import_module(f"repro_torch.tools.{d}")
            for d in CLI_SCRIPTS}


def phase_clis(torch, ops, pc_ops, golden: "dict | None",
               runs: dict) -> dict:
    """Phase 18: each port driver of ``runs`` in this process on the card,
    in ``build/cli``, as its command line with ``--device cuda``; with
    ``golden``, every printed line, spied output and written file held to
    it (:func:`cli_mismatches`).  Each run: exactly one ``alloc_select``
    and one ``grow_select`` launch an op step of a non-FIXED engine (none
    on a FIXED engine's, whose ALLOC is a plain argmin) and no row
    selection; its seconds, dispatches (``run_programs`` calls), op steps
    by engine kind, shim commands and ``page_clock`` launches logged."""
    from repro_torch.core import ElementKind, engine
    mods = cli_modules()
    card = gpu_name_and_limit()
    cwd = ROOT / "build" / "cli"
    cwd.mkdir(parents=True, exist_ok=True)
    facts = {}
    for name, (driver, argv) in runs.items():
        steps = Calls(engine, "_apply_op_impl", key=lambda cfg, *_: (
            "fixed" if cfg.kind is ElementKind.FIXED else "selecting"))
        dispatches = Calls(engine, "run_programs")
        commands = Calls(engine, "apply_op")
        ops.reset_launches()
        pc_ops.reset_launches()
        torch.cuda.synchronize()
        try:
            run = run_cli(mods[driver], argv + ["--device", "cuda"],
                          driver, cwd)
            torch.cuda.synchronize()
        finally:
            for c in (steps, dispatches, commands):
                c.close()
        c = dict(ops.counts)
        selecting = steps.by.get("selecting", 0)
        f = facts[name] = {
            "seconds": run["seconds"], "dispatches": dispatches.n,
            "op_steps": steps.n, "selecting_op_steps": selecting,
            "shim_commands": commands.n, "launches": c,
            "page_clock": pc_ops.launches}
        check(c["alloc_select"] == c["grow_select"] == selecting
              and c["rows"] == 0,
              f"phase 18: {name} launched {c}, want one alloc_select and "
              f"one grow_select an op step of a non-FIXED engine "
              f"({steps.by}) and no row selection")
        held = "not held (no golden section at this command line)"
        if golden is not None and golden.get(name, {}).get("argv") == argv:
            got = cli_summary(name, argv, run)
            bad = cli_mismatches(name, got, golden[name])
            for m in bad[:40]:
                print(f"chip_smoke: mismatch: {m}", file=sys.stderr,
                      flush=True)
            check(not bad, f"phase 18: {name}: {len(bad)} mismatches with "
                           f"tests/data/torch_clis_zn540.json")
            held = "== tests/data/torch_clis_zn540.json"
        log(f"phase 18: {name} (python -m repro_torch.tools.{driver} "
            f"{' '.join(argv)}) {held}; {f['seconds']:.3f} s, "
            f"{f['dispatches']} dispatches, {f['op_steps']} op steps "
            f"({selecting} on selecting engines), {f['shim_commands']} "
            f"shim commands; alloc_select {c['alloc_select']}, grow_select "
            f"{c['grow_select']}, page_clock {f['page_clock']} ({card})")
        for line in run["lines"][:3]:
            log(f"phase 18: {name}: | {line}")
    total = sum(f["seconds"] for f in facts.values())
    log(f"phase 18: {total:.1f} s of drivers, "
        f"{sum(f['dispatches'] for f in facts.values())} dispatches, "
        f"{sum(f['op_steps'] for f in facts.values())} op steps, "
        f"{sum(f['shim_commands'] for f in facts.values())} shim commands")
    return {"facts": facts, "seconds": total,
            "launches": {k: sum(f["launches"][k] for f in facts.values())
                         for k in ("alloc_select", "grow_select")}}


# --------------------------------------------------------------------- #
# phase 7: the attention kernels vs their plain versions
# --------------------------------------------------------------------- #
def rel_err(torch, got, want) -> tuple:
    """(max |got - want| / max |want|, max |got - want|), in f32."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / (float(want.float().abs().max()) + 1e-9), diff


def flash_cases(rng) -> list:
    """(b, hq, hkv, s, sk, d, causal): the three serving paths' prefills
    (granite, the Jamba cut at S 2048 and G 8, the llama4-scout cut at G
    5); S and Sk at 127, 128,
    129 and 64 mod 128 about the bf16 kernel's 128-row tiles, and D 16;
    then random ragged shapes -- S and Sk off the 64-row tiles, D in {64,
    96, 128}, G in {1, 4, 8}, causal with S <= Sk and not causal."""
    cases = [(8, 32, 8, 512, 512, 128, True),
             (8, 64, 8, 2048, 2048, 128, True),
             (8, 40, 8, 512, 512, 128, True), (1, 4, 4, 1, 1, 64, True),
             (2, 8, 1, 1, 300, 128, True),
             (2, 8, 2, 127, 127, 128, True), (2, 8, 2, 128, 128, 128, True),
             (2, 8, 2, 129, 129, 128, True), (1, 8, 1, 192, 320, 128, True),
             (2, 4, 4, 127, 129, 64, True), (1, 4, 2, 128, 192, 96, False),
             (2, 4, 2, 129, 192, 16, True), (1, 2, 1, 64, 64, 16, False)]
    for i in range(12):
        d = (64, 96, 128)[i % 3]
        g = (1, 4, 8)[(i // 3) % 3]
        hkv = 1 + i % 2
        causal = i % 4 != 3
        s = int(rng.integers(2, 300))
        if s % 64 == 0:
            s += 1
        sk = s + int(rng.integers(0, 150)) if causal else int(
            rng.integers(1, 300))
        cases.append((int(rng.integers(1, 4)), g * hkv, hkv, s, sk, d,
                      causal))
    return cases


def decode_cases(rng, split_plan, n_sm) -> list:
    """(b, hq, hkv, s, d, lengths): the three serving paths' decodes
    (granite: lengths 513 to 544 over a 544-row cache; the Jamba cut at G
    8: 2049 to 2080 over 2080 rows; the llama4-scout cut at G 5, the
    first odd G, over granite's lengths); lengths on, one before and one
    after a split boundary of the plan the kernel runs (``split_plan`` on
    this card's ``n_sm``), and a batch whose splits are mostly empty; then
    random shapes with lengths 0, 1, full and random."""
    cases = [(8, 32, 8, 544, 128, [513, 517, 522, 526, 531, 535, 540,
                                   544]),
             (8, 64, 8, 2080, 128, [2049, 2053, 2058, 2062, 2067, 2071,
                                    2076, 2080]),
             (8, 40, 8, 544, 128, [513, 517, 522, 526, 531, 535, 540,
                                   544])]
    for b, hq, hkv, s in ((4, 32, 8, 1000), (3, 64, 8, 2080)):
        rps, _ = split_plan(b, hkv, s, n_sm)
        cases.append((b, hq, hkv, s, 128, [rps, rps - 1, rps + 1,
                                           2 * rps][:b]))
    cases.append((8, 32, 8, 2080, 128, [1, 0, 64, 65, 100, 3, 128, 2]))
    for i in range(12):
        d = (64, 96, 128)[i % 3]
        g = (1, 4, 8)[(i // 3) % 3]
        hkv = 1 + (i % 4) // 2 * 7
        s = int(rng.integers(1, 700))
        b = int(rng.integers(3, 7))
        lengths = [0, 1, s] + [int(x) for x in rng.integers(0, s + 1,
                                                          b - 3)]
        cases.append((b, g * hkv, hkv, s, d, lengths))
    return cases


def phase_attention(torch, np, fops, fref, dops, dref) -> dict:
    """Each attention kernel against its plain version on the same CUDA
    tensors, f32 and bf16; returns the worst max-abs error per kernel."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        for b, hq, hkv, s, sk, d, causal in flash_cases(rng):
            q = randn((b, hq, s, d), dtype)
            k, v = randn((b, hkv, sk, d), dtype), randn((b, hkv, sk, d),
                                                        dtype)
            before = fops.launches
            got = fops.attention(q, k, v, causal=causal)
            check(fops.launches == before + 1, "flash launch not counted")
            want = fref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and err <= tol,
                  f"flash_attention {dtype} {(b, hq, hkv, s, sk, d)} "
                  f"causal={causal}: rel err {err} > {tol}")
            worst["flash_attention"] = max(worst["flash_attention"], diff)
            n += 1
        for b, hq, hkv, s, d, lengths in decode_cases(rng, dops.split_plan,
                                                      n_sm):
            q = randn((b, hq, d), dtype)
            k, v = randn((b, s, hkv, d), dtype), randn((b, s, hkv, d),
                                                       dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            before = dops.launches
            got = dops.decode_attention(q, k, v, lens)
            check(dops.launches == before + 1, "decode launch not counted")
            want = dref.decode_attention_ref(q, k, v, lens)
            torch.cuda.synchronize()
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and err <= tol,
                  f"decode_attention {dtype} {(b, hq, hkv, s, d)} "
                  f"lengths {lengths}: rel err {err} > {tol}")
            check(bool((got[lens == 0] == 0).all()),
                  "decode_attention: a zero-length row is not 0")
            worst["decode_attention"] = max(worst["decode_attention"],
                                            diff)
            n += 1
    log(f"phase 7: attention kernels == plain versions on {n} cases "
        f"(f32 rel err <= {KERNEL_TOL['float32']}, bf16 <= "
        f"{KERNEL_TOL['bfloat16']}); max_abs_err {worst}")
    return worst


# --------------------------------------------------------------------- #
# phase 7b: the selective scan vs its plain version
# --------------------------------------------------------------------- #
def ssm_inputs(torch, gen, bh, t, p, n, dtype, *, rank=0, model_a=False,
               scale_a=1.0):
    """x ~ N(0, 1), dt a softplus of N(0, 1) (as the Mamba layer makes
    it), b and c ~ N(0, 1) -- column views of one ``(BH, T, rank + 2N)``
    tensor when ``rank`` > 0, as ``x_proj``'s output is sliced -- a the
    Mamba init's ``-(1..N)`` per channel or random in [-16.1, -0.1),
    times ``scale_a`` (0 makes dt * a = 0; 100 puts most of it below
    -126), d ~ N(0, 1)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(bh, t, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bh, t, p)).to(dtype)
    if rank:
        xdbc = randn(bh, t, rank + 2 * n).to(dtype)
        b, c = xdbc[..., rank:rank + n], xdbc[..., rank + n:]
    else:
        b, c = randn(bh, t, n).to(dtype), randn(bh, t, n).to(dtype)
    if model_a:
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device="cuda").repeat(p, 1)
    else:
        a = -(torch.rand((p, n), generator=gen, device="cuda") * 16 + 0.1)
    return x, dt, b, c, a * scale_a, randn(p)


def ssm_cases(rng, tile: int, chunk: int) -> list:
    """(bh, t, p, n, rank, model_a, scale_a): the Jamba cut's prefill
    scan (b and c as views of the 544-column ``x_proj`` output), T = 1,
    T and P off every chunk and CTA width; T one before, on and one after
    the kernel's ``chunk`` steps and twice it, P likewise about its
    ``tile`` channels and odd (unaligned rows, the plain-load path);
    ``dt * a`` = 0 and ``dt * a`` < -126; then 12 random shapes."""
    cases = [(8, 2048, 16384, 16, 512, True, 1.0),
             (2, 1, 300, 16, 0, False, 1.0),
             (3, 777, 1000, 16, 7, False, 1.0),
             (2, 130, 200, 8, 0, True, 1.0)]
    for t in (chunk - 1, chunk, chunk + 1, 2 * chunk + 1):
        cases.append((2, t, 3 * tile, 16, 512, False, 1.0))
    for p in (tile - 1, tile, tile + 1, 2 * tile + 3, 1001):
        cases.append((2, 2 * chunk + 5, p, 16, 0, True, 1.0))
    cases += [(2, 50, 2 * tile, 16, 512, False, 0.0),
              (2, 50, 2 * tile, 16, 512, False, 100.0),
              (1, 40, tile + 3, 5, 3, False, 100.0)]
    for i in range(12):
        cases.append((int(rng.integers(1, 7)), int(rng.integers(1, 700)),
                      int(rng.integers(1, 2000)), int(rng.integers(1, 17)),
                      int(rng.integers(0, 2)) * int(rng.integers(1, 40)),
                      bool(i % 2), 1.0))
    return cases


def phase_ssm(torch, np, sops, sref) -> float:
    """The scan kernel against its plain version on the same CUDA
    tensors, f32 and bf16; returns the worst max-abs error."""
    rng = np.random.default_rng(13)
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst, n_cases = 0.0, 0
    cases = ssm_cases(rng, sops.TILE, sops.CHUNK)
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        for bh, t, p, n, rank, model_a, scale_a in cases:
            args = ssm_inputs(torch, gen, bh, t, p, n, dtype, rank=rank,
                              model_a=model_a, scale_a=scale_a)
            before = sops.launches
            got = sops.ssm_scan(*args)
            check(sops.launches == before + 1, "ssm_scan launch not counted")
            want = sref.ssm_scan_ref(*args)
            torch.cuda.synchronize()
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and tuple(got.shape) == (bh, t, p)
                  and err <= tol,
                  f"ssm_scan {dtype} {(bh, t, p, n)} rank {rank} a x "
                  f"{scale_a}: rel err {err} > {tol}")
            worst = max(worst, diff)
            n_cases += 1
            del args, got, want
    log(f"phase 7b: ssm_scan kernel == plain version on {n_cases} cases "
        f"(f32 rel err <= {KERNEL_TOL['float32']}, bf16 <= "
        f"{KERNEL_TOL['bfloat16']}); max_abs_err {worst}")
    return worst


# --------------------------------------------------------------------- #
# phases 8-10: the serving path
# --------------------------------------------------------------------- #
def read_counts(kernels) -> dict:
    return {name: mod.launches for name, mod in kernels.items()}


def check_serve(torch, run, counts, kernels, n_params, want_params) -> None:
    """Exact launch counts per phase (a prefill kernel launch per layer
    of its kind, a decode-attention launch per attention layer and step --
    none for MLA, whose absorbed decode is plain products -- nothing
    crossed), the counters agreeing with them, and tokens and logits in
    range."""
    cfg = run["cfg"]
    kinds = cfg.layer_kinds()
    n_mamba, n_cross = kinds.count("mamba"), kinds.count("cross")
    n_attn = kinds.count("attn") + 2 * n_cross  # a cross layer attends twice
    steps = run["tokens"].shape[1] - 1
    want = {"prefill": {"flash_attention": n_attn + cfg.encoder_layers,
                        "decode_attention": 0, "ssm_scan": n_mamba,
                        "mlstm_scan": kinds.count("mlstm"),
                        "slstm_scan": kinds.count("slstm")},
            "decode": {"flash_attention": 0,
                       "decode_attention": 0 if cfg.mla else n_attn * steps,
                       "ssm_scan": 0, "mlstm_scan": 0, "slstm_scan": 0}}
    check(n_params == want_params,
          f"{cfg.name} has {n_params} parameters, not {want_params}")
    check(run["launches"] == want,
          f"{cfg.name}: serve launches per phase {run['launches']}, want "
          f"{want}")
    check(counts == {name: want["prefill"][name] + want["decode"][name]
                     for name in kernels},
          f"{cfg.name}: serve launch counts {counts}")
    tokens = run["tokens"]
    check(bool((tokens >= 0).all()) and bool((tokens < cfg.vocab).all()),
          "serve tokens out of range")
    for i, lg in enumerate(run["logits"]):
        check(tuple(lg.shape) == (tokens.shape[0], cfg.padded_vocab)
              and bool(torch.isfinite(lg[:, :cfg.vocab]).all()),
              f"{cfg.name}: bad logits at step {i}")


def phase_serve(torch, serve, kernels) -> dict:
    """granite-3-8b through ``serve.main``, the counts zeroed just before
    and read just after."""
    for mod in kernels.values():
        mod.reset_launches()
    run = serve.main(SERVE_ARGS)
    counts = read_counts(kernels)
    check_serve(torch, run, counts, kernels, run["n_params"],
                GRANITE_PARAMS)
    check(tuple(run["tokens"].shape) == (8, 32), "serve token shape")
    cfg = run["cfg"]
    b, p = run["prompts"].shape
    log(f"phase 8: served {cfg.name} ({run['n_params']} parameters, "
        f"{cfg.n_layers} layers) on cuda: {b} x {p} prompt, "
        f"{run['tokens'].shape[1] - 1} decode steps; launches {counts} "
        f"(prefill {run['launches']['prefill']}, decode "
        f"{run['launches']['decode']}); first row "
        f"{run['tokens'][0, :12].tolist()}")
    return dict(run, counts=counts)


def phase_jamba(torch, serve, cfg, kernels) -> dict:
    """The one-card Jamba cut through ``serve.build`` and
    ``serve.generate`` -- the functions ``serve.main`` calls -- with
    weights from seed 0 on the card, the counts zeroed just before the
    run and read just after."""
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in model.parameters())
    prompts = torch.from_numpy(serve.make_prompts(
        cfg, JAMBA_BATCH, JAMBA_PROMPT, seed=0)).to("cuda")
    for mod in kernels.values():
        mod.reset_launches()
    run = serve.generate(model, cfg, prompts, JAMBA_TOKENS)
    counts = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run = dict(run, cfg=cfg, model=model, prompts=prompts,
               n_params=n_params, counts=counts)
    check_serve(torch, run, counts, kernels, n_params, JAMBA_PARAMS)
    check(tuple(run["tokens"].shape) == (JAMBA_BATCH, JAMBA_TOKENS),
          "jamba token shape")
    # prefill leaves the Mamba state as it was, as the reference does;
    # decode then moved it
    check(bool(run["caches"]["ssm"].abs().sum() > 0),
          "decode left the Mamba state at zero")
    steps = JAMBA_TOKENS - 1
    log(f"phase 8b: served {cfg.name} one-card cut ({n_params} "
        f"parameters, {cfg.n_layers} layers: {cfg.layer_kinds()}) on "
        f"cuda: {JAMBA_BATCH} x {JAMBA_PROMPT} prompt, {steps} decode "
        f"steps; launches {counts} (prefill {run['launches']['prefill']}, "
        f"decode {run['launches']['decode']}); prefill "
        f"{run['prefill_s']:.6f} s, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step (first run); peak "
        f"device memory {peak_gb:.2f} GB; first row "
        f"{run['tokens'][0, :12].tolist()}")
    return run


def phase_serve_ref(torch, serve, run, phase: str) -> dict:
    """The plain path (attention and scan), teacher-forced with the
    kernel run's tokens, against the kernel run: every step's logits and
    every cache."""
    cfg = run["cfg"]
    ref = serve.generate(run["model"], cfg, run["prompts"],
                         run["tokens"].shape[1], memory=run.get("memory"),
                         attn_impl="ref", ssm_impl="ref",
                         forced=run["tokens"])
    check(all(v == 0 for phase_counts in ref["launches"].values()
              for v in phase_counts.values()),
          f"the plain path launched a kernel: {ref['launches']}")
    errs = [rel_err(torch, a[:, :cfg.vocab], b[:, :cfg.vocab])[0]
            for a, b in zip(run["logits"], ref["logits"])]
    check(set(run["caches"]) == set(ref["caches"]), "cache names differ")
    cache_errs = {n: rel_err(torch, run["caches"][n], ref["caches"][n])[0]
                  for n in run["caches"]}
    agree = float((run["tokens"] == ref["tokens"]).float().mean())
    log(f"phase {phase}: {cfg.name} kernel path vs plain path "
        f"(teacher-forced, allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}): prefill logits rel err "
        f"{errs[0]:.3e}, decode steps max {max(errs[1:]):.3e}, caches "
        f"{cache_errs}, greedy tokens agree {agree:.4f} (tolerance "
        f"{SERVE_TOL})")
    check(max(errs) <= SERVE_TOL and max(cache_errs.values()) <= SERVE_TOL,
          f"{cfg.name}: serve kernel path vs plain path beyond {SERVE_TOL}")
    return {"logit_errs": errs, "cache_errs": cache_errs,
            "prefill_logits": ref["logits"][0]}


def attention_timing(torch, F, fops, fref, dops, dref, *, b, s, hq, hkv,
                     d, n_caches, seq, v_dim=None, sk=None,
                     causal=True) -> dict:
    """CUDA-event times at one serving path's shapes: each kernel, its
    plain version and one SDPA call, with the bound from this run's
    inputs.  Flash runs S query rows over ``sk`` key rows (S by default),
    causal or not (cross-attention over a memory).  Decode is timed over
    ``n_caches`` distinct caches of ``seq`` rows at full length, so each
    call reads its cache from device memory as a real step does; a path
    with no decode kernel (MLA) passes ``n_caches=0``.  ``v_dim``: V's
    columns past it are zero (MLA's padding)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(bf16)

    out = {}
    sk = sk or s
    # prefill, in the serving layout: (B, S, H, D) viewed as (B, H, S, D)
    q = randn(b, s, hq, d).transpose(1, 2)
    k = randn(b, sk, hkv, d).transpose(1, 2)
    v = randn(b, sk, hkv, d).transpose(1, 2)
    if v_dim is not None:
        v[..., v_dim:] = 0
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    iters = max(10, 50 * 512 * 512 // (s * sk))
    before = fops.launches
    ms = cuda_ms(torch, lambda: fops.attention(q, k, v, causal=causal),
                 iters=iters)
    flash_dev_us = device_us(torch, lambda: fops.attention(q, k, v,
                                                           causal=causal),
                             "flash_fwd_tc", reps=20)
    fops.launches = before                     # timing launches not counted
    plain_ms = cuda_ms(torch, lambda: fref.attention_ref(q, k, v,
                                                         causal=causal),
                       iters=min(10, iters))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=causal, enable_gqa=True))
    bytes_moved = 2 * (2 * q.numel() + k.numel() + v.numel())
    # the (query, key) pairs: the causal triangle, or every pair
    pairs = s * (s + 1) // 2 if causal else s * sk
    flops = 4 * d * b * hq * pairs
    plan = ("2 x 64-column swizzle atoms, a 2-stage cp.async ring of "
            "128-row K/V tiles, wgmma m64n128k16 for Q.K^T and P.V"
            if d <= 128 else
            "3 x 64-column swizzle atoms, a 2-stage cp.async ring of "
            "64-row K/V tiles, wgmma m64n64k16 for Q.K^T and m64n192k16 "
            "for P.V")
    out["flash_attention"] = dict(
        bound_entry(ms, plain_ms, library_ms, bytes_moved, flops),
        device_us=flash_dev_us,
        design=f"bf16 on the tensor cores: {plan} (Q.K^T with both "
               f"operands in shared memory, P.V with P in registers), 2 "
               f"warpgroups per 128-row q tile = {b * hq * -(-s // 128)} "
               f"CTAs")
    del q, k, v, qc, kc, vc
    if not n_caches:
        return out

    qd = randn(b, hq, d)
    lengths = torch.full((b,), seq, dtype=torch.int32, device="cuda")
    caches = [(randn(b, seq, hkv, d), randn(b, seq, hkv, d))
              for _ in range(n_caches)]

    def every_layer(fn):
        return lambda: [fn(kl, vl) for kl, vl in caches]

    before = dops.launches
    ms = cuda_ms(torch, every_layer(lambda kl, vl: dops.decode_attention(
        qd, kl, vl, lengths)), iters=10) / n_caches
    decode_dev_us = device_us(torch, every_layer(
        lambda kl, vl: dops.decode_attention(qd, kl, vl, lengths)),
        "decode_kernel", reps=max(1, 40 // n_caches))
    dops.launches = before
    plain_ms = cuda_ms(torch, every_layer(
        lambda kl, vl: dref.decode_attention_ref(qd, kl, vl, lengths)),
        iters=3) / n_caches
    laid = [(kl.transpose(1, 2).contiguous(), vl.transpose(1, 2).contiguous())
            for kl, vl in caches]
    mask = (torch.arange(seq, device="cuda")[None, :] < lengths[:, None]
            )[:, None, None, :]
    q4 = qd[:, :, None, :]
    library_ms = cuda_ms(torch, lambda: [F.scaled_dot_product_attention(
        q4, kl, vl, attn_mask=mask, enable_gqa=True) for kl, vl in laid],
        iters=10) / n_caches
    rows = int(lengths.sum())                     # cache rows these reads
    bytes_moved = 2 * (2 * rows * hkv * d + 2 * qd.numel())
    flops = 4 * d * (hq // hkv) * hkv * rows
    pairs = hkv * -(-(hq // hkv) // 16)     # KV heads x 16-head tiles
    rows_per_split, n_split = dops.split_plan(
        b, pairs, seq,
        torch.cuda.get_device_properties(0).multi_processor_count)
    out["decode_attention"] = dict(
        bound_entry(ms, plain_ms, library_ms, bytes_moved, flops),
        device_us=decode_dev_us,
        design=f"bf16 on the tensor cores (mma.sync m16n8k16, the G heads "
               f"as the A operand's rows, P in registers); split-S: "
               f"{n_split} splits of {rows_per_split} rows = "
               f"{b * pairs * n_split} CTAs of 128 "
               f"threads, 16-byte cp.async into a two-slot ring (a K tile "
               f"and a V tile of 64 rows, each refilled once consumed), "
               f"last-CTA log-sum-exp combine in the same launch")
    del caches, laid
    return out


def ssm_timing(torch, sops, sref) -> dict:
    """CUDA-event times of the scan at the Jamba cut's prefill shape
    (BH 8, T 2048, P 16384, N 16, bf16, b and c views of the x_proj
    output, the init's A), kernel and plain version, with the bound from
    this run's inputs.  No single PyTorch call computes the scan, so
    there is no library time."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    bh, t, p, n, rank = JAMBA_BATCH, JAMBA_PROMPT, 16384, 16, 512
    args = ssm_inputs(torch, gen, bh, t, p, n, torch.bfloat16, rank=rank,
                      model_a=True)
    before = sops.launches
    ms = cuda_ms(torch, lambda: sops.ssm_scan(*args), iters=20)
    dev_us = device_us(torch, lambda: sops.ssm_scan(*args),
                       "ssm_scan_kernel", reps=30)
    sops.launches = before                     # timing launches not counted
    plain_ms = cuda_ms(torch, lambda: sref.ssm_scan_ref(*args), iters=2)
    # each input read once and y written once: x, dt, y (BH, T, P) bf16;
    # b, c (BH, T, N) bf16; a (P, N) and d (P,) f32
    bytes_moved = 3 * 2 * bh * t * p + 2 * 2 * bh * t * n + 4 * (p * n + p)
    exps = bh * t * p * n
    # f32 instructions per state entry and step: dt * a, u * b, h * da +
    # u * b and h * c + acc; per channel and step: dt * x, d * x + acc
    instr = 4 * exps + 2 * bh * t * p
    del args
    floor = scan_floor(exps, instr)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return dict(floor, ms=ms, device_us=dev_us, plain_ms=plain_ms,
                library_ms=None,
                bound_ms=max(bytes_ms, floor["ops_ms"]),
                bound_by=("bytes" if bytes_ms >= floor["ops_ms"]
                          else "operations"),
                bytes=bytes_moved, bytes_ms=bytes_ms)


def scan_floor(exps: int, instr: int) -> dict:
    """The least time for ``exps`` exponentials and ``instr`` other f32
    instructions, given that each exponential runs either on the SFU (one
    issue slot) or on the f32 pipes (``EXP_POLY_INSTRUCTIONS`` issue
    slots): the share ``f`` done on the f32 pipes balances the SFU's time
    ``(1 - f) E / 16`` against the issue time ``(instr + (1 - f) E +
    c f E) / 128`` per SM and clock.  Also the floor with every
    exponential on the SFU, the present kernel's design."""
    r = LANES_PER_SM_PER_CLOCK / SFU_EX2_PER_SM_PER_CLOCK
    c = EXP_POLY_INSTRUCTIONS
    f = min(max(((r - 1) * exps - instr) / ((c + r - 1) * exps), 0.0), 1.0)
    clocks = max((1 - f) * exps / SFU_EX2_PER_SM_PER_CLOCK,
                 (instr + (1 - f + c * f) * exps) / LANES_PER_SM_PER_CLOCK)
    sfu_only = max(exps / SFU_EX2_PER_SM_PER_CLOCK,
                   (instr + exps) / LANES_PER_SM_PER_CLOCK)
    per_ms = 1e3 / (SMS * SM_CLOCK_HZ)
    return {"ops_ms": clocks * per_ms, "poly_share": f,
            "sfu_only_ms": sfu_only * per_ms, "exps": exps,
            "instr": instr}


def profile_steps(torch, fn) -> list:
    """``fn()`` twice under ``torch.profiler``, the first call a warm-up
    step whose events the profiler drops, and the device events of the
    second: the first events of a profiling window can go missing (a
    layer's launches at the start of a profiled prefill), so only a
    window that opens after a warm-up step is read.  The step's own span
    on the device (``ProfilerStep#``, which covers its kernels) is not
    one of them."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


#: cycles of the spin kernel (``torch.cuda._sleep``) that keeps the card
#: busy while a burst of launches is enqueued: about 5 ms at the H100's
#: clock
SPIN_CYCLES = 10_000_000
#: the device times :func:`device_us` took from CUDA events, not from
#: the profiler (see :func:`device_us_method`)
EVENT_READINGS = set()


def device_us(torch, fn, name: str, reps: int) -> float:
    """The mean device time of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn``, free of the host's launch cost: from one
    ``torch.profiler`` window, or, where that window holds none of them,
    from CUDA events around the ``reps`` calls enqueued behind a spin
    kernel (so the card runs them back to back; the span also holds the
    gaps between launches, ~1 us each).  The log and the kernels line
    say which (:func:`device_us_method`).

    The profiled dispatches of phases 6, 11 and 13 (~10^5 device events
    each) run after every caller (:func:`profile_dispatches`): before
    that, small windows after them came back without device events.
    Windows after phase 9g's stepped plain path still can (PR 26's
    runs, ``PERF.md``)."""
    fn()
    torch.cuda.synchronize()
    device = profile_steps(torch, lambda: [fn() for _ in range(reps)])
    spans = [e.time_range.elapsed_us() for e in device if name in e.name]
    if spans:
        return sum(spans) / len(spans)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / reps
    EVENT_READINGS.add(us)
    log(f"device_us: the profiler window held no {name!r} (of "
        f"{len(device)} device events); {us:.3f} us a call from CUDA "
        f"events behind a spin kernel")
    return us


def device_us_method(us) -> str:
    """How :func:`device_us` took the reading ``us``."""
    return "cuda events" if us in EVENT_READINGS else "torch.profiler"


def bound_entry(ms, plain_ms, library_ms, bytes_moved, flops) -> dict:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "flops": flops}


def profile_region(torch, fn, mark: str = None) -> dict:
    """One call of ``fn`` (after a warm one, and a profiled warm-up step,
    see :func:`profile_steps`) under ``torch.profiler``: its wall time,
    the card's busy time (its kernel and copy spans, which do not overlap
    on one stream), its device events, and the launches and mean device
    time of the kernels whose name holds ``mark``."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)
    with torch.inference_mode():
        fn()                                       # warm
        torch.cuda.synchronize()
        device = profile_steps(torch, timed)
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    kern = [e.time_range.elapsed_us() for e in device
            if mark is not None and mark in e.name]
    return {"wall_us": wall[-1], "busy_us": busy_us,
            "device_events": len(device), "kernel_launches": len(kern),
            "kernel_us": sum(kern) / len(kern) if kern else None}


def profile_decode_step(torch, MDL, run) -> dict:
    """One more decode step (at the cache's last row) under
    ``torch.profiler``, with the decode-attention kernel's own device
    time (see :func:`profile_region`)."""
    cfg, model, caches = run["cfg"], run["model"], run["caches"]
    step = MDL.make_decode_step(cfg)
    token = run["tokens"][:, -1]
    last = run["prompts"].shape[1] + run["tokens"].shape[1] - 1
    pos = torch.full((token.shape[0],), last, dtype=torch.int32,
                     device="cuda")
    return profile_region(torch, lambda: step(model, token, caches, pos),
                          "decode_kernel")


def log_serve_timing(torch, F, serve, MDL, run, phase, fops, fref, dops,
                     dref, usage, **shapes) -> dict:
    """One serving path's timings: the attention kernels at its shapes
    (with each kernel's design and ``ptxas`` resources from ``usage``),
    a second timed serve run, and one profiled decode step."""
    attn_t = attention_timing(torch, F, fops, fref, dops, dref, **shapes)
    # the bf16 flash kernel's instantiation at this head dim (column
    # atoms, KV tile rows)
    marks = {"flash_attention": ("flash_fwd_tcILi2ELi128E"
                                 if shapes["d"] <= 128
                                 else "flash_fwd_tcILi3ELi64E"),
             "decode_attention": "decode_kernel_tc"}
    for name, t in attn_t.items():
        res = [u for m, u in usage[name].items() if marks[name] in m]
        log(f"phase {phase}: {name} at {run['cfg'].name}'s shape {shapes}: "
            f"kernel {t['ms']:.6f} ms ({t['bound_ms'] / t['ms']:.4f} of "
            f"its bound; device {t['device_us']} us per launch), plain "
            f"{t['plain_ms']:.6f} ms, "
            f"scaled_dot_product_attention {t['library_ms']:.6f} ms, "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
            f"{t['bytes']} bytes, {t['flops']} flop); design: "
            f"{t['design']}; bf16 kernel resources {res}")
    timed = serve.generate(run["model"], run["cfg"], run["prompts"],
                           run["tokens"].shape[1], memory=run.get("memory"))
    steps = run["tokens"].shape[1] - 1
    b = run["prompts"].shape[0]
    split = (f" (encoder {timed['encode_s']:.6f} s, decoder "
             f"{timed['prefill_s'] - timed['encode_s']:.6f} s)"
             if run["cfg"].encoder_layers else "")
    log(f"phase {phase}: serve {run['cfg'].name}, second run: prefill "
        f"{timed['prefill_s']:.6f} s{split} = "
        f"{run['prompts'].numel() / timed['prefill_s']:.1f} tokens/s; "
        f"decode {timed['decode_s'] / steps * 1e3:.6f} ms/step ({steps} "
        f"steps of {b} sequences); first run prefill "
        f"{run['prefill_s']:.6f} s, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step; tokens equal to "
        f"the first run: {bool(torch.equal(timed['tokens'], run['tokens']))}")
    del timed
    prof = profile_decode_step(torch, MDL, run)
    if prof["device_events"]:
        log(f"phase {phase}: profiled one {run['cfg'].name} decode step: "
            f"wall {prof['wall_us']:.1f} us, device busy "
            f"{prof['busy_us']:.1f} us "
            f"({prof['busy_us'] / prof['wall_us']:.4f} of wall) over "
            f"{prof['device_events']} device events; decode_attention "
            f"{prof['kernel_launches']} launches, {prof['kernel_us']} us "
            f"device time each")
    else:
        log(f"phase {phase}: profiler recorded no device events: device "
            f"busy share not measured")
    return attn_t


# --------------------------------------------------------------------- #
# phases 7c-10c: the MoE path
# --------------------------------------------------------------------- #
def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    return tree.numel()


def same_routing(torch, a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def phase_moe_layer(torch, MOE, dims) -> dict:
    """deepseek-v2's routed layer at its published ``MoEDims`` (160
    experts, top-6 over 16 groups with limit 3, int8 dispatch, 2 shared
    experts) with weights drawn on the card: two runs of the same call
    must be bit-identical (any atomic combine would show), and a call of
    :data:`MOE_CPU_TOKENS` must route as the same function does on the
    CPU -- a route that differs only at an f32 near-tie is printed and
    the rest is then held under the card's routes -- with kept mask and
    positions equal and the output within ``KERNEL_TOL["bfloat16"]``."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    t0 = time.perf_counter()
    p = MOE.moe_init(gen, dims, device="cuda")
    n_params = sum(numel(v) for v in p.values())

    def tokens(n):
        return torch.randn((n, dims.d_model), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
    drops = {}
    for n in MOE_REPEAT_TOKENS:
        x = tokens(n)
        a, ra = MOE.moe_forward(p, x, dims)
        b, rb = MOE.moe_forward(p, x, dims)
        torch.cuda.synchronize()
        check(torch.equal(a, b) and same_routing(torch, ra, rb),
              f"phase 7c: two runs of the routed layer at T={n} differ")
        check(tuple(a.shape) == (n, dims.d_model)
              and bool(torch.isfinite(a.float()).all()),
              f"phase 7c: bad output at T={n}")
        drops[n] = (int((~ra.keep).sum()), MOE.capacity(n, dims))
    x = tokens(MOE_CPU_TOKENS)
    out, r = MOE.moe_forward(p, x, dims)
    drops[MOE_CPU_TOKENS] = (int((~r.keep).sum()),
                             MOE.capacity(MOE_CPU_TOKENS, dims))
    cpu_p = {k: ({n: w.cpu() for n, w in v.items()} if k == "shared"
                 else v.cpu()) for k, v in p.items()}
    t1 = time.perf_counter()
    out_c, rc = MOE.moe_forward(cpu_p, x.cpu(), dims)
    cpu_s = time.perf_counter() - t1
    idx = r.gate_idx.cpu()
    differ = (idx != rc.gate_idx).any(dim=1).nonzero().flatten().tolist()
    for t in differ:
        log(f"phase 7c: token {t} routes to {idx[t].tolist()} on the card, "
            f"{rc.gate_idx[t].tolist()} on the CPU; top-6/top-7 margin "
            f"{float(r.margin[t]):.3e} (card), {float(rc.margin[t]):.3e} "
            f"(CPU)")
        check(min(float(r.margin[t]), float(rc.margin[t]))
              <= ROUTE_FLIP_MARGIN,
              f"phase 7c: token {t} routes differently beyond an f32 "
              f"near-tie")
    if differ:                 # hold the rest under the card's routes
        out_c, rc = MOE.moe_forward(cpu_p, x.cpu(), dims, routes=idx)
    check(torch.equal(r.keep.cpu(), rc.keep)
          and torch.equal(r.pos.cpu(), rc.pos),
          "phase 7c: kept mask or positions differ from the CPU run")
    err, diff = rel_err(torch, out.cpu(), out_c)
    check(err <= KERNEL_TOL["bfloat16"],
          f"phase 7c: routed layer on the card vs the CPU: rel err {err}")
    log(f"phase 7c: deepseek-v2 routed layer ({dims}; {n_params} "
        f"parameters from seed 19 on the card): two runs bit-identical at "
        f"T = {list(MOE_REPEAT_TOKENS)}; at T = {MOE_CPU_TOKENS} routes == "
        f"the CPU run's "
        f"({len(differ)} near-tie flips), kept mask and positions equal, "
        f"output rel err {err:.3e} (max abs {diff:.3e}; tolerance "
        f"{KERNEL_TOL['bfloat16']}); (token, expert) pairs dropped / "
        f"capacity by T {drops}; the CPU run took {cpu_s:.1f} s; "
        f"phase {time.perf_counter() - t0:.1f} s")
    return {"flips": len(differ), "err": err}


def moe_layers(TT, model) -> list:
    return [m for m in model.modules() if isinstance(m, TT.MoEFFN)]


def phase_moe_serve(torch, serve, TT, MOE, cfg, kernels, others, *,
                    phase: str, want_params: int, batch: int, prompt: int,
                    tokens: int) -> dict:
    """A one-card MoE cut through ``serve.build`` and ``serve.generate``
    with weights from seed 0 on the card, every MoE layer recording its
    routes, every launch count (``others``: kernels this path must not
    launch) zeroed just before the run and read just after."""
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in model.parameters())
    prompts = torch.from_numpy(serve.make_prompts(
        cfg, batch, prompt, seed=0)).to("cuda")
    layers = moe_layers(TT, model)
    for m in layers:
        m.record = []
    for mod in list(kernels.values()) + list(others.values()):
        mod.reset_launches()
    run = serve.generate(model, cfg, prompts, tokens)
    counts = read_counts(kernels)
    other = {"zns_alloc": sum(others["zns_alloc"].counts.values()),
             "page_clock": others["page_clock"].launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    routes = [m.record for m in layers]
    for m in layers:
        m.record = None
    run = dict(run, cfg=cfg, model=model, prompts=prompts,
               n_params=n_params, counts=counts, routes=routes)
    check_serve(torch, run, counts, kernels, n_params, want_params)
    check(other == {"zns_alloc": 0, "page_clock": 0},
          f"{cfg.name}: launched {other}")
    n_moe = sum(moe for _, moe in TT.layer_plan(cfg))
    check(tuple(run["tokens"].shape) == (batch, tokens)
          and len(layers) == n_moe
          and all(len(rec) == tokens for rec in routes),
          f"{cfg.name}: token shape or route records")
    pairs = routes[0][0].keep.numel()
    cap = MOE.capacity(pairs // cfg.top_k, TT.moe_dims(cfg))
    dropped = [int((~rec[0].keep).sum()) for rec in routes]
    steps = tokens - 1
    log(f"phase {phase}: served {cfg.name} one-card cut ({n_params} "
        f"parameters, {cfg.n_layers} layers, {n_moe} of them MoE with "
        f"{cfg.n_experts} experts, top-{cfg.top_k}, "
        f"{cfg.n_shared_experts} shared; mla={cfg.mla}) on cuda: {batch} x "
        f"{prompt} prompt, {steps} decode steps; launches {counts} "
        f"(prefill {run['launches']['prefill']}, decode "
        f"{run['launches']['decode']}), {other}; prefill "
        f"{run['prefill_s']:.6f} s, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step (first run); peak "
        f"device memory {peak_gb:.2f} GB "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); prefill "
        f"dropped {sum(dropped)} of {pairs * n_moe} (token, expert) pairs "
        f"at capacity {cap} (per layer {dropped}); first row "
        f"{run['tokens'][0, :12].tolist()}")
    return dict(run, peak_gb=peak_gb, dropped=dropped)


def phase_moe_serve_ref(torch, serve, TT, run, phase: str,
                        served: str) -> dict:
    """The plain path, teacher-forced with phase ``served``'s tokens,
    first with every MoE layer replaying that run's routes -- held to its
    logits and caches at :data:`SERVE_TOL` -- then routing on its own,
    where the (layer, token) routes that flip are counted (a finding,
    not a gate)."""
    cfg = run["cfg"]
    layers = moe_layers(TT, run["model"])
    for m, rec in zip(layers, run["routes"]):
        m.replay = iter([r.gate_idx for r in rec])
    errs = phase_serve_ref(torch, serve, run, phase)
    check(all(next(m.replay, None) is None for m in layers),
          f"phase {phase}: a layer did not replay every recorded route")
    for m in layers:
        m.replay, m.record = None, []
    free = serve.generate(run["model"], cfg, run["prompts"],
                          run["tokens"].shape[1], attn_impl="ref",
                          ssm_impl="ref", forced=run["tokens"])
    # flips in the first MoE layer follow from the attention alone; a
    # later layer's also from the flips before it
    flips, total, worst, per_layer = 0, 0, 0.0, []
    first, first_worst = 0, 0.0
    for li, (m, rec) in enumerate(zip(layers, run["routes"])):
        n_layer = 0
        for a, b in zip(rec, m.record):
            d = (a.gate_idx != b.gate_idx).any(dim=1)
            n = int(d.sum())
            total += d.numel()
            if n:
                n_layer += n
                worst = max(worst, float(a.margin[d].max()))
                if li == 0:
                    first_worst = max(first_worst, float(a.margin[d].max()))
        flips += n_layer
        first += n_layer if li == 0 else 0
        per_layer.append(n_layer)
        m.record = None
    free_errs = [rel_err(torch, a[:, :cfg.vocab], b[:, :cfg.vocab])[0]
                 for a, b in zip(run["logits"], free["logits"])]
    log(f"phase {phase}: {cfg.name} plain path routing on its own "
        f"(teacher-forced): {flips} of {total} (layer, token) routes "
        f"flipped against phase {served} (per MoE layer {per_layer}), "
        f"largest flipped top-{cfg.top_k}/top-{cfg.top_k + 1} margin "
        f"{worst:.3e}; in the first MoE "
        f"layer, where only the attention differs upstream, {first} "
        f"flips, largest margin {first_worst:.3e}; logits rel err prefill "
        f"{free_errs[0]:.3e}, decode max {max(free_errs[1:]):.3e} (not "
        f"gated)")
    del free
    return dict(errs, flips=flips, routes=total, worst_margin=worst,
                first_flips=first, first_worst_margin=first_worst)


def moe_layer_timing(torch, MOE, ffn, n_tokens: int) -> dict:
    """CUDA-event time of one MoE FFN call on ``n_tokens`` tokens, beside
    its bound -- the expert products over all E x C slots, the shared
    expert and the router at the bf16 peak, against every weight read
    once -- and one call under ``torch.profiler``."""
    gen = torch.Generator(device="cuda").manual_seed(n_tokens)
    dims = ffn.dims
    x = torch.randn((n_tokens, dims.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: ffn(x), iters=20)
    c = MOE.capacity(n_tokens, dims)
    d, f, e = dims.d_model, dims.d_ff, dims.n_experts
    fs = f * dims.n_shared
    flops = 2 * 3 * (e * c * d * f + n_tokens * d * fs) + 2 * n_tokens * d * e
    bytes_moved = (sum(t.numel() * t.element_size() for t in
                       ffn.parameters()) + 2 * x.numel() * x.element_size())
    prof = profile_region(torch, lambda: ffn(x))
    return dict(bound_entry(ms, None, None, bytes_moved, flops),
                tokens=n_tokens, capacity=c, prof=prof)


# --------------------------------------------------------------------- #
# phases 7d-10d: multi-head latent attention
# --------------------------------------------------------------------- #
def flash_mla_cases(rng) -> list:
    """(b, hq, hkv, s, sk, d, causal, v_dim): the deepseek-v2 cut's
    prefill (V zero-padded from 128 to 192); S and Sk one before, on and
    one after the bf16 kernel's 64-row K/V tiles and 128-row q tiles; D
    136 and 184; then random ragged shapes with G > 1."""
    cases = [(DEEPSEEK_BATCH, 128, 128, DEEPSEEK_PROMPT, DEEPSEEK_PROMPT,
              192, True, 128)]
    for n in (63, 64, 65, 127, 128, 129):
        cases.append((2, 4, 2, n, n, 192, True, None))
    cases += [(1, 8, 1, 64, 191, 192, True, None),
              (2, 4, 4, 129, 129, 136, True, None),
              (1, 8, 2, 100, 300, 184, True, None),
              (2, 4, 2, 65, 127, 192, False, None)]
    for i in range(6):
        g = (2, 4, 8)[i % 3]
        hkv = 1 + i % 2
        causal = i % 3 != 2
        s = int(rng.integers(2, 300))
        sk = s + int(rng.integers(0, 150)) if causal else int(
            rng.integers(1, 300))
        cases.append((int(rng.integers(1, 4)), g * hkv, hkv, s, sk,
                      (192, 136, 184)[i % 3], causal, None))
    return cases


def phase_flash_mla(torch, np, fops, fref) -> float:
    """The flash kernel above head dim 128 against its plain version on
    the same CUDA tensors, f32 (the SIMT kernel) and bf16 (the wgmma
    kernel's 64-row K/V tile plan); returns the worst max-abs error."""
    rng = np.random.default_rng(20)
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst, n, t0 = 0.0, 0, time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        for b, hq, hkv, s, sk, d, causal, v_dim in flash_mla_cases(rng):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
                       for shape in ((b, hq, s, d), (b, hkv, sk, d),
                                     (b, hkv, sk, d)))
            if v_dim is not None:
                v[..., v_dim:] = 0
            before = fops.launches
            got = fops.attention(q, k, v, causal=causal)
            check(fops.launches == before + 1, "flash launch not counted")
            want = fref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and err <= tol,
                  f"phase 7d: flash_attention {dtype} "
                  f"{(b, hq, hkv, s, sk, d)} causal={causal}: rel err "
                  f"{err} > {tol}")
            if v_dim is not None:
                check(not bool(got[..., v_dim:].any()),
                      "phase 7d: padded V columns gave a nonzero output")
            worst = max(worst, diff)
            n += 1
            del q, k, v, got, want
    log(f"phase 7d: flash_attention at head dims 136-192 == plain version "
        f"on {n} cases (f32 rel err <= {KERNEL_TOL['float32']}, bf16 <= "
        f"{KERNEL_TOL['bfloat16']}); max_abs_err {worst}; "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def mla_decode_timing(torch, MLA, blk, caches, slot, run) -> dict:
    """CUDA-event time of one MLA layer's absorbed decode (the cut's
    layer ``slot`` over its latent cache at the last row, B sequences)
    beside its bound: its weights and its cache rows read once, and the
    products it needs at the bf16 peak."""
    cfg = blk.cfg
    b = run["prompts"].shape[0]
    last = run["prompts"].shape[1] + run["tokens"].shape[1] - 1
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((b, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    pos = torch.full((b,), last, dtype=torch.int32, device="cuda")
    cache = {name: caches[name][slot] for name in ("c_kv", "k_rope")}
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: MLA.mla_decode(blk.mixer, x, cache, pos,
                                                   cfg), iters=20)
        prof = profile_region(torch, lambda: MLA.mla_decode(
            blk.mixer, x, cache, pos, cfg))
    weights = sum(t.numel() for t in blk.mixer.values())
    rows = b * (last + 1)
    lat = cfg.kv_lora + cfg.rope_head_dim
    bytes_moved = (2 * weights + 2 * rows * lat + 2 * 2 * x.numel())
    # every weight multiplies each token once (W_uk and W_uv in the
    # absorbed products too); the logits and the context read every row
    flops = 2 * b * weights + 2 * 2 * cfg.n_heads * rows * lat
    return dict(bound_entry(ms, None, None, bytes_moved, flops), prof=prof)


def log_moe_layer_timing(torch, MOE, ffn, cfg, phase: str,
                         sizes: tuple) -> None:
    for n in sizes:
        t = moe_layer_timing(torch, MOE, ffn, n)
        pr = t["prof"]
        log(f"phase {phase}: one {cfg.name} MoE layer at T = {n} "
            f"(capacity {t['capacity']}): {t['ms']:.6f} ms "
            f"({t['bound_ms'] / t['ms']:.4f} of its bound), bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['flops']} flop); profiled call: {pr['device_events']} "
            f"device events, busy {pr['busy_us']:.1f} us of "
            f"{pr['wall_us']:.1f} us wall")


# --------------------------------------------------------------------- #
# phases 7e-10f: cross-attention and the encoder
# --------------------------------------------------------------------- #
def cross_flash_cases() -> list:
    """(b, hq, hkv, s, sk, d, causal, views): llama-3.2-vision's
    self-attention and its cross-attention over the 1601-row memory (also
    as ``(B, S, H, D)`` / ``(B, M, Hkv, D)`` views, the model's layout),
    seamless's encoder (S = Sk = 1024, D 64, G 1), causal decoder and
    cross-attention over 1024 frames; Sk one before, on and one after
    1601's 64- and 128-row tile boundaries; not causal with S > Sk."""
    cases = [(8, 32, 8, 512, 512, 128, True, False),
             (8, 32, 8, 512, 1601, 128, False, False),
             (8, 32, 8, 512, 1601, 128, False, True),
             (8, 16, 16, 1024, 1024, 64, False, False),
             (8, 16, 16, 512, 512, 64, True, False),
             (8, 16, 16, 512, 1024, 64, False, True)]
    for sk in (1535, 1536, 1537, 1599, 1600, 1601, 1602, 1603):
        cases.append((2, 8, 2, 128, sk, 128, False, sk % 2 == 1))
    cases += [(2, 8, 2, 300, 129, 128, False, False),
              (1, 4, 4, 1024, 1000, 64, False, True),
              (2, 4, 1, 130, 65, 64, False, False)]
    return cases


#: (b, hq, hkv, s, d, lengths): cross decode over a memory, every length
#: M (vision G 4 at 1601, seamless G 1 at 1024, and the other G at each),
#: and both models' self-attention decodes over 544 rows
CROSS_DECODE_CASES = [
    (8, 32, 8, 1601, 128, [1601] * 8), (8, 16, 16, 1024, 64, [1024] * 8),
    (8, 16, 16, 1601, 64, [1601] * 8), (8, 32, 8, 1024, 128, [1024] * 8),
    (8, 32, 8, 544, 128, [513, 517, 522, 526, 531, 535, 540, 544]),
    (8, 16, 16, 544, 64, [513, 517, 522, 526, 531, 535, 540, 544])]


def phase_cross_attention(torch, fops, fref, dops, dref) -> dict:
    """Both attention kernels against their plain versions at the cross
    models' shapes, f32 and bf16; then self and cross decodes enqueued
    back to back on one stream (the kernel's scratch is shared) and held
    after one sync.  Returns the worst max-abs error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    t0, n = time.perf_counter(), 0

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        for b, hq, hkv, s, sk, d, causal, views in cross_flash_cases():
            if views:
                q = randn((b, s, hq, d), dtype).transpose(1, 2)
                k, v = (randn((b, sk, hkv, d), dtype).transpose(1, 2)
                        for _ in range(2))
            else:
                q = randn((b, hq, s, d), dtype)
                k, v = randn((b, hkv, sk, d), dtype), randn((b, hkv, sk, d),
                                                            dtype)
            before = fops.launches
            got = fops.attention(q, k, v, causal=causal)
            check(fops.launches == before + 1, "flash launch not counted")
            want = fref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and err <= tol,
                  f"phase 7e: flash_attention {dtype} "
                  f"{(b, hq, hkv, s, sk, d)} causal={causal} views={views}: "
                  f"rel err {err} > {tol}")
            worst["flash_attention"] = max(worst["flash_attention"], diff)
            n += 1
            del q, k, v, got, want
        calls = []
        for b, hq, hkv, m, d, lengths in CROSS_DECODE_CASES * 2:
            q = randn((b, hq, d), dtype)
            k, v = randn((b, m, hkv, d), dtype), randn((b, m, hkv, d), dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            before = dops.launches
            calls.append((q, k, v, lens, dops.decode_attention(q, k, v,
                                                               lens)))
            check(dops.launches == before + 1, "decode launch not counted")
        torch.cuda.synchronize()              # every launch enqueued first
        for q, k, v, lens, got in calls:
            want = dref.decode_attention_ref(q, k, v, lens)
            err, diff = rel_err(torch, got, want)
            check(got.dtype == dtype and err <= tol,
                  f"phase 7e: decode_attention {dtype} {tuple(k.shape)} "
                  f"G {q.shape[1] // k.shape[2]} lengths "
                  f"{lens.tolist()}: rel err {err} > {tol}")
            worst["decode_attention"] = max(worst["decode_attention"], diff)
            n += 1
        del calls
    log(f"phase 7e: attention kernels == plain versions at the cross "
        f"models' shapes on {n} cases (decodes of both kinds enqueued "
        f"back to back before one sync; f32 rel err <= "
        f"{KERNEL_TOL['float32']}, bf16 <= {KERNEL_TOL['bfloat16']}); "
        f"max_abs_err {worst}; {time.perf_counter() - t0:.1f} s")
    return worst


def phase_cross_serve(torch, serve, MDL, shapes, cfg, kernels, others, *,
                      phase: str, want_params: int) -> dict:
    """A cross-attention model as published through ``serve.build`` and
    ``serve.generate``: weights from seed 0 on the card, prompts and the
    memory (its ``memory_len`` at :data:`CROSS_CELL`) drawn as the
    reference's CLI draws them, every launch count zeroed just before the
    run and read just after."""
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in model.parameters())
    mem_len = MDL.memory_len(cfg, shapes[CROSS_CELL])
    prompts, memory = serve.make_inputs(cfg, CROSS_BATCH, CROSS_PROMPT, 0,
                                        mem_len)
    prompts, memory = (torch.from_numpy(prompts).to("cuda"),
                       memory.to("cuda"))
    for mod in list(kernels.values()) + list(others.values()):
        mod.reset_launches()
    run = serve.generate(model, cfg, prompts, CROSS_TOKENS, memory=memory)
    counts = read_counts(kernels)
    other = {"zns_alloc": sum(others["zns_alloc"].counts.values()),
             "page_clock": others["page_clock"].launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run = dict(run, cfg=cfg, model=model, prompts=prompts, memory=memory,
               n_params=n_params, counts=counts)
    check_serve(torch, run, counts, kernels, n_params, want_params)
    check(other == {"zns_alloc": 0, "page_clock": 0},
          f"{cfg.name}: launched {other}")
    n_cross = cfg.layer_kinds().count("cross")
    mk = run["caches"]["memory_k"]
    check(tuple(mk.shape) == (n_cross, CROSS_BATCH, mem_len, cfg.n_kv_heads,
                              cfg.resolved_head_dim)
          and mk.dtype == torch.bfloat16
          and bool(torch.isfinite(mk).all()) and bool(mk.abs().sum() > 0)
          and run["caches"]["memory_len"].tolist() == [mem_len] * CROSS_BATCH,
          f"{cfg.name}: memory K/V {tuple(mk.shape)} {mk.dtype}")
    steps = CROSS_TOKENS - 1
    split = (f" (encoder {run['encode_s']:.6f} s)" if cfg.encoder_layers
             else "")
    log(f"phase {phase}: served {cfg.name} as published ({n_params} "
        f"parameters, {cfg.n_layers} decoder layers, {n_cross} of them "
        f"cross, {cfg.encoder_layers} encoder layers) on cuda: "
        f"{CROSS_BATCH} x {CROSS_PROMPT} prompt, memory "
        f"{tuple(memory.shape)} {memory.dtype}, {steps} decode steps; "
        f"launches {counts} (prefill {run['launches']['prefill']}, decode "
        f"{run['launches']['decode']}), {other}; prefill "
        f"{run['prefill_s']:.6f} s{split}, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step (first run); peak "
        f"device memory {peak_gb:.2f} GB "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); first row "
        f"{run['tokens'][0, :12].tolist()}")
    return run


# --------------------------------------------------------------------- #
# phases 7f-10g: xLSTM
# --------------------------------------------------------------------- #
def mlstm_inputs(torch, gen, b, s, h, p, dtype, *, strided=False):
    """q, k, v ``(B, S, H, P)`` ~ N(0, 1) (k scaled by 1/sqrt(P), as the
    layer scales it) -- with ``strided``, views of one ``(B, S, 3, H, P)``
    tensor -- and the log gates: li a column view of one ``(B, S, 2H)``
    f32 tensor ~ N(0, 2^2), as the layer's split gives it, lf the
    log-sigmoid of N(3, 1) (forget gates near 1)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strided:
        qkv = randn(b, s, 3, h, p)
        qkv[:, :, 1] *= p ** -0.5
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q, v = randn(b, s, h, p).to(dtype), randn(b, s, h, p).to(dtype)
        k = (randn(b, s, h, p) * p ** -0.5).to(dtype)
    gates = randn(b, s, 2 * h) * 2
    li = gates[..., :h]
    lf = torch.nn.functional.logsigmoid(randn(b, s, h) + 3)
    return q, k, v, li, lf


def slstm_inputs(torch, gen, b, s, d, h, dtype, *, strided=False):
    """pre_x ``(B, S, 4d)`` ~ N(0, 1) -- with ``strided``, a column view
    of a wider row -- and r_rec ``(H, ph, 4 ph)`` ~ N(0, 1/ph), as
    ``slstm_init`` draws it."""
    ph = d // h
    gen_x = torch.randn((b, s, 4 * d + (8 if strided else 0)),
                        generator=gen, device="cuda").to(dtype)
    pre = gen_x[..., 8:] if strided else gen_x
    r = (torch.randn((h, ph, 4 * ph), generator=gen, device="cuda")
         * ph ** -0.5).to(dtype)
    return pre, r


def xlstm_cases() -> dict:
    """Each scan's cases: the served shape, then T 1, 37, 129 and 2047 at
    B 1-8 and the reduced widths, strided inputs, and a second width; for
    ``slstm_scan``, each on the design its launch plan picks (the ragged
    lengths also at d 256, and d 1024 in 8 heads, where bf16 takes
    clusters of 8 and of 16), then ``slstm_l2``: the served shape and a
    strided one forced onto the L2 kernel, and the widths the plan gives
    it (f32 d 1024, bf16 d 2048), as (B, T, d, H, strided, dtypes).  The
    mLSTM's cases run on its plan's design (bf16 on the chunkwise kernel
    but at P 512; f32 on the recurrent one), and ``mlstm_recurrent`` has
    the bf16 shapes forced onto the recurrent kernel: the served one and
    a strided ragged one, as (B, T, H, P, strided, dtypes).  The
    chunkwise kernel's head sizes cover its three tiles, exact (P 32,
    384) and padded (P 64, 96 on the 128 tile; 160, 256 on the 384
    tile, where CTAs hold rows past P)."""
    ragged = [(1, 1), (3, 37), (8, 129), (2, 2047)]
    mlstm = [(8, 2048, 4, 384, False)]
    mlstm += [(b, t, 4, 32, i % 2 == 1) for i, (b, t) in enumerate(ragged)]
    mlstm += [(2, 129, 4, 384, True), (3, 40, 2, 512, False),
              (2, 33, 4, 96, True), (3, 65, 2, 64, False),
              (4, 129, 2, 160, True), (2, 100, 2, 256, True)]
    slstm = [(8, 2048, 768, 4, False)]
    slstm += [(b, t, dm, 4, i % 2 == 1) for dm in (64, 256)
              for i, (b, t) in enumerate(ragged)]
    slstm += [(2, 129, 768, 4, True), (3, 40, 96, 3, False),
              (2, 33, 1024, 8, True)]
    both = ("float32", "bfloat16")
    slstm_l2 = [(8, 2048, 768, 4, False, both), (2, 129, 768, 4, True, both),
                (2, 33, 1024, 4, False, ("float32",)),
                (2, 33, 2048, 4, False, ("bfloat16",))]
    mlstm_recurrent = [(8, 2048, 4, 384, False, ("bfloat16",)),
                       (2, 129, 4, 384, True, ("bfloat16",))]
    return {"mlstm_scan": mlstm, "mlstm_recurrent": mlstm_recurrent,
            "slstm_scan": slstm, "slstm_l2": slstm_l2}


def phase_xlstm_scans(torch, np, mops, slops) -> dict:
    """Both scans against their plain versions on the same CUDA tensors,
    f32 and bf16, each on both of its designs; returns each kernel's
    worst max-abs error, and each one's by design."""
    from repro_torch.kernels.mlstm_scan import ref as mref
    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = xlstm_cases()
    worst = {"mlstm_scan": 0.0, "slstm_scan": 0.0,
             "mlstm_by_design": {"chunkwise": 0.0, "recurrent": 0.0},
             "mlstm_chunkwise_flips": 0.0,
             "slstm_by_design": {"cluster": 0.0, "l2": 0.0}}
    n = 0

    def mlstm_case(b, t, h, p, dtype, strided, design):
        """One case on the plan's design, or on ``design`` forced.  The
        chunkwise kernel's flip rate is held to CHUNKWISE_FLIP_TOL on
        every case of FLIP_MIN_VALUES values or more; at (2, 129, 4,
        384) also against its own plain version with the kernel's
        operand roundings, and at the served shape the plain version
        with hi/lo pairs must exceed the bar."""
        args = mlstm_inputs(torch, gen, b, t, h, p, dtype, strided=strided)
        plan = mops.launch_plan(p, dtype)
        before, designs = mops.launches, dict(mops.designs)
        got = (mops.launch(*args, mops.Plan(design)) if design
               else mops.mlstm_scan(*args))
        took = [k for k in designs if mops.designs[k] != designs[k]]
        check(mops.launches == before + 1
              and took == [design or plan.design],
              f"mlstm_scan {(b, t, h, p)} {dtype} launched {took}, want "
              f"{design or plan.design}")
        want = mops.mlstm_scan(*args, impl="ref")
        torch.cuda.synchronize()
        err, diff = rel_err(torch, got, want)
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        check(got.dtype == dtype and tuple(got.shape) == (b, t, h, p)
              and err <= tol,
              f"mlstm_scan {dtype} {(b, t, h, p)} strided {strided} on "
              f"{took}: rel err {err} > {tol}")
        worst["mlstm_scan"] = max(worst["mlstm_scan"], diff)
        by = worst["mlstm_by_design"]
        by[took[0]] = max(by[took[0]], diff)
        def flips(a, b_):
            return float((a != b_).float().mean())
        flip = ""
        if took == ["chunkwise"] and got.numel() >= FLIP_MIN_VALUES:
            f = flips(got, want)
            flip = f", flips {f:.3e}"
            check(f <= CHUNKWISE_FLIP_TOL, f"mlstm_scan chunkwise kernel "
                  f"{(b, t, h, p)}: flips {f} > {CHUNKWISE_FLIP_TOL}")
            worst["mlstm_chunkwise_flips"] = max(
                worst["mlstm_chunkwise_flips"], f)
        if took == ["chunkwise"] and (b, t, h, p) == (2, 129, 4, 384):
            alg = mref.mlstm_chunkwise_ref(*args,
                                           operands=mref.KERNEL_OPERANDS)
            alg_err, f = rel_err(torch, got, alg)[0], flips(got, alg)
            log(f"phase 7f: mlstm_scan chunkwise kernel {(b, t, h, p)} "
                f"vs its plain chunkwise version ({mref.KERNEL_OPERANDS} "
                f"operands emulated) rel err {alg_err:.4e}, flips {f:.3e}")
            check(alg_err <= tol and f <= CHUNKWISE_FLIP_TOL,
                  f"chunkwise kernel vs its plain version: rel err "
                  f"{alg_err} > {tol} or flips {f} > {CHUNKWISE_FLIP_TOL}")
        if took == ["chunkwise"] and (b, t, h, p) == (8, 2048, 4, 384):
            pairs = flips(mref.mlstm_chunkwise_ref(*args, operands="bf16x2"),
                          want)
            log(f"phase 7f: the plain chunkwise version with bf16 hi/lo "
                f"pairs at {(b, t, h, p)}: flips {pairs:.3e} (the bar "
                f"{CHUNKWISE_FLIP_TOL} must tell it from the kernel)")
            check(pairs > CHUNKWISE_FLIP_TOL, f"hi/lo pairs flip {pairs}, "
                  f"within the bar {CHUNKWISE_FLIP_TOL}: 7f's flip check "
                  f"cannot see the operand precision")
        log(f"phase 7f: mlstm_scan {dtype} {(b, t, h, p)} strided {strided} "
            f"on {took[0]}: rel err {err:.4e}{flip}")
        del args, got, want

    def slstm_case(b, t, d, h, dtype, strided, design):
        args = slstm_inputs(torch, gen, b, t, d, h, dtype, strided=strided)
        plan = slops.launch_plan(d, h, dtype)
        before = dict(slops.designs)
        got = (slops.launch(*args, slops.Plan("l2")) if design == "l2"
               else slops.slstm_scan(*args))
        took = [k for k in before if slops.designs[k] != before[k]]
        check(took == [design or plan.design],
              f"slstm_scan {(b, t, d, h)} {dtype} launched {took}, want "
              f"{design or plan.design}")
        want = slops.slstm_scan(*args, impl="ref")
        torch.cuda.synchronize()
        err, diff = rel_err(torch, got, want)
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        check(got.dtype == dtype and tuple(got.shape) == (b, t, d)
              and err <= tol,
              f"slstm_scan {dtype} {(b, t, d, h)} strided {strided} on "
              f"{took}: rel err {err} > {tol}")
        worst["slstm_scan"] = max(worst["slstm_scan"], diff)
        by = worst["slstm_by_design"]
        by[took[0]] = max(by[took[0]], diff)
        return plan
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, p, strided in cases["mlstm_scan"]:
            mlstm_case(b, t, h, p, dtype, strided, None)
            n += 1
        for b, t, h, p, strided, dtypes in cases["mlstm_recurrent"]:
            if str(dtype).split(".")[1] in dtypes:
                mlstm_case(b, t, h, p, dtype, strided, "recurrent")
                n += 1
        for b, t, d, h, strided in cases["slstm_scan"]:
            before = slops.launches
            plan = slstm_case(b, t, d, h, dtype, strided, None)
            check(slops.launches == before + 1,
                  "slstm_scan launch not counted")
            log(f"phase 7f: slstm_scan {dtype} {(b, t, d, h)} on {plan}")
            n += 1
        for b, t, d, h, strided, dtypes in cases["slstm_l2"]:
            if str(dtype).split(".")[1] in dtypes:
                slstm_case(b, t, d, h, dtype, strided,
                           "l2" if d == 768 else None)
                n += 1
    log(f"phase 7f: mlstm_scan and slstm_scan == plain versions on {n} "
        f"cases (f32 rel err <= {KERNEL_TOL['float32']}, bf16 <= "
        f"{KERNEL_TOL['bfloat16']}); max_abs_err {worst}")
    return worst


def mlstm_chunkwise_flops(b, t, h, p, plan, chunk: int) -> int:
    """The MMA flops the chunkwise kernel issues (4096 an m16n8k16) at a
    shape and plan, from the source's loops: per CTA and chunk the six
    causal 16 x 8 tiles of S over the tile's columns; per warp whose 16
    rows lie below P (two a row group) C q (``3 tile / 8`` MMAs, C in
    three bf16 parts) and (S D) V over half the chunk (12, three parts),
    and on every chunk but the last the update (``3 tile / 8``, three
    parts).  No operand depends on the data.  Reported beside the bound,
    not as it: the parts and the recomputed scores are this design's
    cost, not the function's."""
    chunks = -(-t // chunk)
    warps = 2 * sum(16 * g < p for g in range(6 * plan.ctas))
    per_head = (chunks * (plan.ctas * 6 * plan.tile // 16
                          + warps * (3 * plan.tile // 8 + 12))
                + (chunks - 1) * warps * 3 * plan.tile // 8)
    return 4096 * b * h * per_head


def mlstm_flops(b, t, h, p, chunk: int) -> int:
    """The products the chunkwise form needs, each counted once (2 flop a
    multiply-add): per chunk of ``l`` steps the causal scores ``Q K^T``
    and ``(S D) V`` (``l (l + 1) / 2`` pairs of P-long dot products
    each), per step ``C q`` and ``n . q`` from the carried state, and at
    every chunk boundary but the last (the terminal state is dropped)
    the rank-``l`` update of C and n."""
    per_head = 0
    for start in range(0, t, chunk):
        n = min(chunk, t - start)
        per_head += 2 * (n * (n + 1) // 2) * p * 2       # Q K^T, (S D) V
        per_head += n * (2 * p * p + 2 * p)              # C q, n . q
        if start + n < t:
            per_head += n * (2 * p * p + 2 * p)          # C, n update
    return b * h * per_head


def mlstm_timing(torch, mops, usage, args) -> dict:
    """``mlstm_scan`` at the served shape on both designs, in turns
    (recurrent, chunkwise, chunkwise, recurrent; CUDA events), each one's
    device time, the stepped plain version's time, and both bounds from
    this run's inputs: the bytes (q, k, v and h in bf16, the gates), the
    chunkwise form's products (:func:`mlstm_flops`) on the bf16 rate,
    and the recurrent form's 5 f32 operations per state entry and step
    (``fp C``, ``(ip v) k``, the add, ``C q``'s multiply-add) on the
    non-tensor-core rate.  The MMA flops the chunkwise kernel issues
    (:func:`mlstm_chunkwise_flops`) are reported beside its bound.  No
    PyTorch call computes the recurrence."""
    b, t, h, p = args[0].shape
    plan = mops.launch_plan(p, torch.bfloat16)
    check(plan.design == "chunkwise", f"the served mLSTM plans {plan}")
    before, designs = mops.launches, dict(mops.designs)
    fns = {"chunkwise": lambda: mops.mlstm_scan(*args),
           "recurrent": lambda: mops.launch(*args, mops.Plan("recurrent"))}
    iters = {"chunkwise": 20, "recurrent": 3}
    turns = [(k, cuda_ms(torch, fns[k], iters=iters[k]))
             for k in ("recurrent", "chunkwise", "chunkwise", "recurrent")]
    ms = {k: sum(v for n, v in turns if n == k) / 2 for k in fns}
    dev = {k: device_us(torch, fns[k], MLSTM_MARK[k],
                        reps=10 if k == "chunkwise" else 3) for k in fns}
    mops.launches = before                     # timing launches not counted
    mops.designs.update(designs)
    # one call: phase 7f has run the plain version at this shape
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mops.mlstm_scan(*args, impl="ref")
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    bytes_moved = 4 * 2 * b * t * h * p + 2 * 4 * b * t * h
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops = {"chunkwise": mlstm_flops(b, t, h, p, mops.CHUNK),
             "recurrent": b * h * t * (5 * p * p + 6 * p)}
    issued = mlstm_chunkwise_flops(b, t, h, p, plan, mops.CHUNK)
    issued_ms = issued / BF16_FLOPS_PER_S * 1e3
    ops_ms = {"chunkwise": flops["chunkwise"] / BF16_FLOPS_PER_S * 1e3,
              "recurrent": flops["recurrent"] / OPS_PER_S * 1e3}
    res = [u for m, u in usage["mlstm_chunkwise"].items()
           if f"ILi{plan.tile}E" in m]
    sources = {"chunkwise": str(mops.CHUNKWISE_SOURCE.relative_to(ROOT)),
               "recurrent": str(mops.SOURCE.relative_to(ROOT))}
    out = {"ms": ms["chunkwise"], "device_us": dev["chunkwise"],
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(bytes_ms, ops_ms["chunkwise"]),
           "bound_by": ("bytes" if bytes_ms >= ops_ms["chunkwise"]
                        else "operations"),
           "bytes": bytes_moved, "flops": flops["chunkwise"],
           "turns_ms": turns,
           "designs": {k: {"ms": ms[k], "device_us": dev[k],
                           "bound_ms": max(bytes_ms, ops_ms[k]),
                           "flops": flops[k], "source": sources[k]}
                       for k in fns}}
    out["designs"]["chunkwise"].update(plan=plan.__dict__,
                                       issued_flops=issued,
                                       issued_flops_ms=issued_ms)
    for k in fns:
        d = out["designs"][k]
        log(f"phase 10g: mlstm_scan {k} kernel at xlstm-125m's prefill "
            f"shape ({b} x {t}, H {h}, P {p}, bf16): {d['ms']:.6f} ms "
            f"({d['bound_ms'] / d['ms']:.4f} of its bound; device "
            f"{d['device_us']:.3f} us per launch); bound "
            f"{d['bound_ms']:.6f} ms (bytes {bytes_moved} = "
            f"{bytes_ms:.6f} ms, {flops[k]} flop = {ops_ms[k]:.6f} ms on "
            f"the {'bf16 tensor-core' if k == 'chunkwise' else 'f32'} "
            f"rate)")
    log(f"phase 10g: the chunkwise kernel issues {issued} flop of bf16 "
        f"MMA ({issued_ms:.6f} ms at the bf16 rate): "
        f"{issued / flops['chunkwise']:.3f}x the form's products")
    log(f"phase 10g: mlstm_scan turns (ms) {turns}: chunkwise "
        f"{ms['recurrent'] / ms['chunkwise']:.3f}x faster than recurrent; "
        f"plain {plain_ms:.6f} ms, no library call; {plan}; chunkwise "
        f"kernel resources {res}")
    return out


def xlstm_timing(torch, mops, slops, usage) -> dict:
    """CUDA-event times of both scans at xlstm-125m's served prefill shape
    (bf16), their device time per launch, the plain versions' times and
    the bounds from this run's inputs: the mLSTM on both of its designs
    (:func:`mlstm_timing`); ``slstm_scan``'s recurrent product (bf16
    inputs) on the bf16 rate, and its bytes.  No PyTorch call computes
    either recurrence: no library time.  The sLSTM is timed on both
    designs (the plan's cluster kernel, and the L2 kernel forced at the
    same shape), and at :data:`SLSTM_FLOOR` (the cluster kernel's
    narrowest width in 4 heads, 32 units a CTA and 4 row blocks: the step
    chain's floor, its exchanges and the math between them)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    b, t, h = XLSTM_BATCH, XLSTM_PROMPT, 4
    p, d = 384, 768
    margs = mlstm_inputs(torch, gen, b, t, h, p, torch.bfloat16)
    out = {"mlstm_scan": mlstm_timing(torch, mops, usage, margs)}
    del margs
    sargs = slstm_inputs(torch, gen, b, t, d, h, torch.bfloat16)
    kname = SLSTM_MARK[slops.launch_plan(d, h, torch.bfloat16).design]
    before = slops.launches
    ms = cuda_ms(torch, lambda: slops.slstm_scan(*sargs), iters=5)
    dev = device_us(torch, lambda: slops.slstm_scan(*sargs), kname, reps=3)
    slops.launches = before                    # timing launches not counted
    # one call: phase 7f has run the plain version at this shape
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    slops.slstm_scan(*sargs, impl="ref")
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    ph = d // h
    bytes_moved = 2 * (b * t * 4 * d + b * t * d + h * ph * 4 * ph)
    flops = 2 * h * ph * 4 * ph * b * t
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    f32_ms = flops / OPS_PER_S * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    res = [u for m, u in usage["slstm_scan"].items() if "bfloat16" in m]
    slstm = {"ms": ms, "device_us": dev, "plain_ms": plain_ms,
             "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bytes": bytes_moved, "flops": flops, "f32_pipes_ms": f32_ms}
    out["slstm_scan"] = slstm
    log(f"phase 10g: slstm_scan at xlstm-125m's prefill shape ({b} x {t}, "
        f"d 768, H 4, bf16): kernel {ms:.6f} ms "
        f"({slstm['bound_ms'] / ms:.4f} of its bound; device {dev} us per "
        f"launch), plain {plain_ms:.6f} ms, no library call; bound "
        f"{slstm['bound_ms']:.6f} ms ({slstm['bound_by']}: {bytes_moved} "
        f"bytes = {bytes_ms:.6f} ms, {flops} flop = {ops_ms:.6f} ms; on the "
        f"f32 pipes {f32_ms:.6f} ms); bf16 kernel resources {res}")
    before = slops.launches
    plan = slops.launch_plan(d, h, torch.bfloat16)
    l2_ms = cuda_ms(torch, lambda: slops.launch(*sargs, slops.Plan("l2")),
                    iters=3)
    fd, fh = SLSTM_FLOOR
    floor_plan = slops.launch_plan(fd, fh, torch.bfloat16)
    check(floor_plan.design == "cluster" and floor_plan.cluster
          == plan.cluster, f"slstm_scan's floor width takes {floor_plan}")
    fargs = slstm_inputs(torch, gen, b, t, fd, fh, torch.bfloat16)
    floor_ms = cuda_ms(torch, lambda: slops.slstm_scan(*fargs), iters=5)
    slops.launches = before
    slstm["designs"] = {
        "cluster": {"ms": slstm["ms"], "plan": plan.__dict__},
        "l2": {"ms": l2_ms}}
    slstm.update(floor_ms=floor_ms, floor_us_per_step=floor_ms / t * 1e3,
                 floor_plan=floor_plan.__dict__)
    log(f"phase 10g: slstm_scan designs at the served shape (bf16): "
        f"cluster {slstm['ms']:.6f} ms ({slstm['ms'] / t * 1e3:.4f} us a "
        f"step; {plan}), L2 kernel {l2_ms:.6f} ms "
        f"({l2_ms / t * 1e3:.4f} us a step); the step chain's floor, d "
        f"{fd} in {fh} heads ({floor_plan}), {floor_ms:.6f} ms = "
        f"{slstm['floor_us_per_step']:.4f} us a step")
    del sargs, fargs
    return out


def phase_xlstm_serve(torch, serve, cfg, kernels, others) -> dict:
    """xlstm-125m as published through ``serve.build`` and
    ``serve.generate``, weights from seed 0 on the card, every launch
    count zeroed just before the run and read just after."""
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in model.parameters())
    prompts = torch.from_numpy(serve.make_prompts(
        cfg, XLSTM_BATCH, XLSTM_PROMPT, seed=0)).to("cuda")
    for mod in list(kernels.values()) + list(others.values()):
        mod.reset_launches()
    run = serve.generate(model, cfg, prompts, XLSTM_TOKENS)
    counts = read_counts(kernels)
    other = {"zns_alloc": sum(others["zns_alloc"].counts.values()),
             "page_clock": others["page_clock"].launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run = dict(run, cfg=cfg, model=model, prompts=prompts,
               n_params=n_params, counts=counts)
    check_serve(torch, run, counts, kernels, n_params, XLSTM_PARAMS)
    check(other == {"zns_alloc": 0, "page_clock": 0},
          f"{cfg.name}: launched {other}")
    check(run["launches"]["prefill"]["mlstm_scan"] == 9
          and run["launches"]["prefill"]["slstm_scan"] == 3,
          f"{cfg.name}: prefill launches {run['launches']['prefill']}")
    mlstm_designs = dict(kernels["mlstm_scan"].designs)
    check(mlstm_designs == {"chunkwise": 9, "recurrent": 0},
          f"{cfg.name}: mlstm_scan launched {mlstm_designs} (prefill and "
          f"decode), want 9 chunkwise in prefill and none in decode")
    check(tuple(run["tokens"].shape) == (XLSTM_BATCH, XLSTM_TOKENS),
          "xlstm token shape")
    # prefill left the states as made; decode then moved them
    for name in ("mlstm_c", "mlstm_n", "slstm_c", "slstm_h"):
        check(bool(run["caches"][name].abs().sum() > 0)
              and bool(torch.isfinite(run["caches"][name]).all()),
              f"{cfg.name}: decode left {name} at zero or not finite")
    steps = XLSTM_TOKENS - 1
    log(f"phase 8g: served {cfg.name} as published ({n_params} "
        f"parameters, {cfg.n_layers} layers: {cfg.layer_kinds()}, d_ff "
        f"{cfg.d_ff}) on cuda: {XLSTM_BATCH} x {XLSTM_PROMPT} prompt, "
        f"{steps} decode steps; launches {counts} (prefill "
        f"{run['launches']['prefill']}, decode {run['launches']['decode']}; "
        f"mlstm_scan by design {mlstm_designs}), {other}; prefill {run['prefill_s']:.6f} s, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step (first run); peak "
        f"device memory {peak_gb:.2f} GB "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); first row "
        f"{run['tokens'][0, :12].tolist()}")
    return dict(run, peak_gb=peak_gb)


def slstm_design_logits(torch, MDL, TT, run, slops, ref_logits) -> dict:
    """9g's prefill logits against the plain path's with the sLSTM on each
    design: the served plan's (the cluster kernel's tensor-core sums) from
    8g's run, and one more prefill with the plan forced onto the L2 kernel
    (f32 sums on the CUDA cores): what of 9g's error the cluster kernel's
    sums add.  The forced prefill's launches are not counted."""
    from unittest import mock
    cfg, v = run["cfg"], run["cfg"].vocab
    caches = TT.init_caches(cfg, run["prompts"].shape[0],
                            run["prompts"].shape[1] + 1, device="cuda")
    before, designs = slops.launches, dict(slops.designs)
    with torch.inference_mode(), mock.patch.object(
            slops, "launch_plan", lambda *a, **k: slops.Plan("l2")):
        logits, _ = MDL.make_prefill_step(cfg)(run["model"], run["prompts"],
                                               caches)
    torch.cuda.synchronize()
    took = {k: slops.designs[k] - designs[k] for k in designs}
    slops.launches = before
    slops.designs.update(designs)
    check(took == {"cluster": 0, "l2": 3},
          f"the L2-forced prefill launched {took}")
    errs = {"cluster": rel_err(torch, run["logits"][0][:, :v],
                               ref_logits[:, :v])[0],
            "l2": rel_err(torch, logits[:, :v], ref_logits[:, :v])[0],
            "cluster_vs_l2": rel_err(torch, run["logits"][0][:, :v],
                                     logits[:, :v])[0]}
    log(f"phase 9g: {cfg.name} prefill logits rel err against the plain "
        f"path, by sLSTM design: cluster kernel (served) "
        f"{errs['cluster']:.4e}, L2 kernel {errs['l2']:.4e}; cluster vs "
        f"L2 {errs['cluster_vs_l2']:.4e} (tolerance {SERVE_TOL})")
    check(errs["l2"] <= SERVE_TOL, f"{cfg.name}: the L2-forced prefill "
          f"is {errs['l2']} from the plain path")
    del caches, logits
    return errs


def mlstm_design_logits(torch, MDL, TT, run, mops, ref_logits) -> dict:
    """9g's prefill logits against the plain path's with the mLSTM on each
    design: the served plan's (the chunkwise kernel's tensor-core sums)
    from 8g's run, and one more prefill with the plan forced onto the
    recurrent kernel (f32 state sums on the CUDA cores): what of 9g's
    error the chunkwise kernel adds.  The forced prefill's launches are
    not counted."""
    from unittest import mock
    cfg, v = run["cfg"], run["cfg"].vocab
    caches = TT.init_caches(cfg, run["prompts"].shape[0],
                            run["prompts"].shape[1] + 1, device="cuda")
    before, designs = mops.launches, dict(mops.designs)
    with torch.inference_mode(), mock.patch.object(
            mops, "launch_plan", lambda *a, **k: mops.Plan("recurrent")):
        logits, _ = MDL.make_prefill_step(cfg)(run["model"], run["prompts"],
                                               caches)
    torch.cuda.synchronize()
    took = {k: mops.designs[k] - designs[k] for k in designs}
    mops.launches = before
    mops.designs.update(designs)
    check(took == {"chunkwise": 0, "recurrent": 9},
          f"the recurrent-forced prefill launched {took}")
    errs = {"chunkwise": rel_err(torch, run["logits"][0][:, :v],
                                 ref_logits[:, :v])[0],
            "recurrent": rel_err(torch, logits[:, :v], ref_logits[:, :v])[0],
            "chunkwise_vs_recurrent": rel_err(torch, run["logits"][0][:, :v],
                                              logits[:, :v])[0]}
    log(f"phase 9g: {cfg.name} prefill logits rel err against the plain "
        f"path, by mLSTM design: chunkwise kernel (served) "
        f"{errs['chunkwise']:.4e}, recurrent kernel {errs['recurrent']:.4e};"
        f" chunkwise vs recurrent {errs['chunkwise_vs_recurrent']:.4e} "
        f"(tolerance {SERVE_TOL})")
    check(errs["recurrent"] <= SERVE_TOL, f"{cfg.name}: the recurrent-forced "
          f"prefill is {errs['recurrent']} from the plain path")
    del caches
    return dict(errs, _logits=logits)


def f32_reference_logits(torch, MDL, TT, run, served, recurrent,
                         plain) -> dict:
    """9g against a reference that no bf16 rounding moves: 8g's weights
    upcast to f32 (exact), prefilled on the plain path (both scans stepped,
    f32 activations).  The last-token logits' rel err of the served path
    (``served``: the chunkwise mLSTM and cluster sLSTM kernels), of the
    prefill with the mLSTM forced onto its recurrent kernel
    (``recurrent``) and of the bf16 plain path (``plain``) against it;
    the served path's must be at most :data:`F32_RATIO` times the bf16
    plain path's."""
    import copy
    cfg, v = run["cfg"], run["cfg"].vocab
    model32 = copy.deepcopy(run["model"]).float()
    caches = TT.init_caches(cfg, run["prompts"].shape[0],
                            run["prompts"].shape[1] + 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        f32, _ = TT.forward_prefill(model32, cfg, run["prompts"], caches,
                                    ssm_impl="ref")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    f32 = f32[:, :v]
    errs = {k: rel_err(torch, x[:, :v], f32)[0] for k, x in (
        ("served", served), ("recurrent", recurrent), ("bf16_plain", plain))}
    for k in ("served", "recurrent"):
        errs[f"{k}_over_bf16_plain"] = errs[k] / errs["bf16_plain"]
    log(f"phase 9g: {cfg.name} prefill logits rel err against the f32 "
        f"reference (8g's weights in f32, both scans stepped; "
        f"{secs:.1f} s): served path {errs['served']:.4e}, mLSTM on its "
        f"recurrent kernel {errs['recurrent']:.4e}, bf16 plain path "
        f"{errs['bf16_plain']:.4e}; served / plain "
        f"{errs['served_over_bf16_plain']:.4f}, recurrent / plain "
        f"{errs['recurrent_over_bf16_plain']:.4f} (bar {F32_RATIO}) "
        f"[{gpu_name_and_limit()}]")
    check(errs["served_over_bf16_plain"] <= F32_RATIO,
          f"{cfg.name}: the served prefill is {errs['served']:.4e} from the "
          f"f32 reference, {errs['served_over_bf16_plain']:.4f} times the "
          f"bf16 plain path's {errs['bf16_plain']:.4e} (bar {F32_RATIO})")
    del model32, caches
    return dict(errs, seconds=secs)


#: the sLSTM's step-chain floor (d, H): the cluster kernel's narrowest
#: width in 4 heads, 32 units a CTA in a cluster of 8, 4 row blocks of 16
SLSTM_FLOOR = (256, 4)
#: the sLSTM's kernel name in a profile, by design
SLSTM_MARK = {"cluster": "slstm_cluster_kernel", "l2": "slstm_scan_kernel"}
#: the mLSTM's, by design
MLSTM_MARK = {"chunkwise": "mlstm_chunkwise_kernel",
              "recurrent": "mlstm_scan_kernel"}


def log_xlstm_serve_timing(torch, serve, MDL, TT, run, mops,
                           slops) -> dict:
    """A second timed serve run, one profiled prefill (each scan's launches
    and device time, and the card's busy share) and one profiled decode
    step; returns each scan's device µs a launch in the profiled prefill
    (None where the profiler saw none)."""
    cfg = run["cfg"]
    timed = serve.generate(run["model"], cfg, run["prompts"],
                           run["tokens"].shape[1])
    steps = run["tokens"].shape[1] - 1
    b = run["prompts"].shape[0]
    log(f"phase 10g: serve {cfg.name}, second run: prefill "
        f"{timed['prefill_s']:.6f} s = "
        f"{run['prompts'].numel() / timed['prefill_s']:.1f} tokens/s; "
        f"decode {timed['decode_s'] / steps * 1e3:.6f} ms/step ({steps} "
        f"steps of {b} sequences); first run prefill "
        f"{run['prefill_s']:.6f} s, decode "
        f"{run['decode_s'] / steps * 1e3:.6f} ms/step; tokens equal to "
        f"the first run: {bool(torch.equal(timed['tokens'], run['tokens']))}")
    del timed
    prefill = MDL.make_prefill_step(cfg)
    caches = TT.init_caches(cfg, b, run["prompts"].shape[1] + 1,
                            device="cuda")
    device = {}
    dtype = next(run["model"].parameters()).dtype
    plan = slops.launch_plan(cfg.d_model, cfg.n_heads, dtype)
    mplan = mops.launch_plan(2 * cfg.d_model // cfg.n_heads, dtype)
    for name, mark in (("mlstm_scan", MLSTM_MARK[mplan.design]),
                       ("slstm_scan", SLSTM_MARK[plan.design])):
        prof = profile_region(torch, lambda: prefill(run["model"],
                                                     run["prompts"], caches),
                              mark)
        device[name] = prof["kernel_us"]
        if prof["device_events"]:
            log(f"phase 10g: profiled one {cfg.name} prefill: wall "
                f"{prof['wall_us']:.1f} us, device busy "
                f"{prof['busy_us']:.1f} us "
                f"({prof['busy_us'] / prof['wall_us']:.4f} of wall) over "
                f"{prof['device_events']} device events; {mark} "
                f"{prof['kernel_launches']} launches, {prof['kernel_us']} us "
                f"device time each")
        else:
            log("phase 10g: profiler recorded no device events: prefill "
                "busy share not measured")
    prof = profile_decode_step(torch, MDL, run)
    if prof["device_events"]:
        log(f"phase 10g: profiled one {cfg.name} decode step: wall "
            f"{prof['wall_us']:.1f} us, device busy {prof['busy_us']:.1f} "
            f"us ({prof['busy_us'] / prof['wall_us']:.4f} of wall) over "
            f"{prof['device_events']} device events")
    else:
        log("phase 10g: profiler recorded no device events: decode busy "
            "share not measured")
    return device


# --------------------------------------------------------------------- #
# phase 15: training
# --------------------------------------------------------------------- #
PHI3_PARAMS = 3_723_168_768
#: 15b: one card's share of a data-parallel step, 8,192 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 2048, 3
#: 15a: (arch, depth, batch, seq) of the f32 card-vs-CPU step
TRAIN_CUTS = (("phi3-mini-3.8b", 2, 1, 256), ("xlstm-125m", 4, 2, 128))
TRAIN_TOL = {"scalar": 1e-5, "leaf": 1e-4}


#: 15c: the reference CLI's docstring example, its sequence cut from 128
#: to 32 (the train step runs the stepped plain scans, so its time is
#: linear in the sequence; 15a holds a step at 128 against the CPU)
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-125m", "--steps", "6", "--batch", "8",
                    "--seq", "32", "--ckpt-every", "3"]


def all_counts(kernels, others) -> dict:
    return dict(read_counts(kernels),
                zns_alloc=sum(others["zns_alloc"].counts.values()),
                page_clock=others["page_clock"].launches)


def reset_all(kernels, others) -> None:
    for mod in list(kernels.values()) + list(others.values()):
        mod.reset_launches()


class HookedUpdate:
    """A check hook around ``train.optimizer.update``, which
    ``make_train_step`` calls.  It times each update apart, by CUDA
    events on the card (so a timed step does not synchronise for it),
    and with ``keep_grads`` keeps the last step's gradients: 15a compares
    them, and 15b must not hold its 7.45 GB of them through the next
    step.  Restores the function on exit."""

    def __init__(self, torch, OPT, keep_grads: bool = False):
        self.torch, self.OPT, self.keep_grads = torch, OPT, keep_grads
        self.marks, self.grads = [], None

    def _mark(self, cuda: bool):
        if not cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        orig = self.orig = self.OPT.update

        def update(cfg, params, grads, state):
            cuda = next(params.parameters()).is_cuda
            t0 = self._mark(cuda)
            out = orig(cfg, params, grads, state)
            self.marks.append((t0, self._mark(cuda)))
            if self.keep_grads:
                self.grads = [g.detach() for g in grads]
            return out
        self.OPT.update = update
        return self

    def __exit__(self, *exc):
        self.OPT.update = self.orig

    @property
    def seconds(self) -> list:
        """Each update's seconds, in call order."""
        if any(not isinstance(t0, float) for t0, _ in self.marks):
            self.torch.cuda.synchronize()
        return [t1 - t0 if isinstance(t0, float)
                else t0.elapsed_time(t1) / 1e3 for t0, t1 in self.marks]


def train_cut_step(torch, TT, MDL, OPT, TD, cfg, batch, seq, devices):
    """One ``make_train_step`` step of ``cfg`` in f32 on each device, from
    parameters drawn once on the CPU from seed 0, on ``SyntheticLM``'s
    first batch: {device: (metrics, gradients, seconds)}."""
    cpu = TT.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    data = TD.SyntheticLM(vocab=cfg.vocab, batch=batch, seq=seq,
                          seed=0).batch_at(0)
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for dev in devices:
        model = cpu if dev == "cpu" else TT.like(
            cpu, [p.detach().to(dev) for p in cpu.parameters()])
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        b = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        step = MDL.make_train_step(cfg, opt_cfg)
        with HookedUpdate(torch, OPT, keep_grads=True) as hook:
            sync()
            t0 = time.perf_counter()
            _, _, m = step(model, OPT.init(model), b)
            sync()
            dt = time.perf_counter() - t0
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [g.cpu() for g in hook.grads], dt)
        del model
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train_vs_cpu(torch, TT, MDL, OPT, TD, get_arch, kernels,
                       others) -> None:
    """15a: each cut's step on the card against the same step on the
    CPU, the launch counts zeroed just before and read just after."""
    import dataclasses
    for name, depth, batch, seq in TRAIN_CUTS:
        cfg = dataclasses.replace(get_arch(name), n_layers=depth)
        reset_all(kernels, others)
        run = train_cut_step(torch, TT, MDL, OPT, TD, cfg, batch, seq,
                             ("cuda", "cpu"))
        counts = all_counts(kernels, others)
        (gm, gg, gs), (cm, cg, cs) = run["cuda"], run["cpu"]
        errs = {k: rel(gm[k], cm[k]) for k in ("loss", "nll", "grad_norm")}
        aux_err = abs(gm["aux"] - cm["aux"])
        leaf = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(gg, cg))
        check(all(v == 0 for v in counts.values()),
              f"phase 15a: {name} train step launched {counts}")
        check(all(v <= TRAIN_TOL["scalar"] for v in errs.values())
              and aux_err <= TRAIN_TOL["scalar"] * max(1.0, abs(cm["aux"])),
              f"phase 15a: {name} cuda vs cpu {errs}, aux {aux_err}")
        check(leaf <= TRAIN_TOL["leaf"],
              f"phase 15a: {name} gradient leaf rel err {leaf}")
        check(all(math.isfinite(v) for v in gm.values()),
              f"phase 15a: {name} metrics {gm}")
        log(f"phase 15a: {name} cut to depth {depth} (published widths, "
            f"f32, B {batch} x S {seq}), one make_train_step step: cuda "
            f"vs cpu loss {gm['loss']!r} vs {cm['loss']!r} (rel "
            f"{errs['loss']:.3e}), aux {gm['aux']!r}, grad norm "
            f"{gm['grad_norm']!r} vs {cm['grad_norm']!r} (rel "
            f"{errs['grad_norm']:.3e}), worst of {len(gg)} gradient leaves "
            f"{leaf:.3e} (bars {TRAIN_TOL}); {gs:.3f} s on cuda, "
            f"{cs:.3f} s on cpu; launches {counts}")
        del run
        gc.collect()
        torch.cuda.empty_cache()


def profile_train_step(torch, fn, top: int = 12) -> dict:
    """One train step under ``torch.profiler``: wall and busy time, the
    device events, and the kernels taking the most device time (name,
    launches, total us)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_us": wall_us, "busy_us": busy_us,
            "device_events": len(device),
            "top": [(n[:90], c, us) for n, (c, us) in ranked]}


def phi3_train_run(torch, serve, MDL, OPT, TD, cfg, opt_cfg, batch,
                   kernels, others) -> dict:
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == PHI3_PARAMS,
          f"{cfg.name}: {n_params} parameters, not {PHI3_PARAMS}")
    opt = OPT.init(model)
    step = MDL.make_train_step(cfg, opt_cfg)
    data = TD.SyntheticLM(vocab=cfg.vocab, batch=batch, seq=TRAIN_SEQ,
                          seed=0)
    state = {"model": model, "opt": opt}
    losses, times = [], []

    dev = next(model.parameters()).device

    def one(i: int) -> None:
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch_at(i).items()}
        state["model"], state["opt"], m = step(state["model"], state["opt"],
                                               b)
        losses.append(float(m["loss"]))

    with HookedUpdate(torch, OPT) as hook:
        for i in range(1 + TRAIN_TIMED):
            if i == 1:                      # after the warm-up step
                reset_all(kernels, others)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = all_counts(kernels, others)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_train_step(torch, lambda: one(1 + TRAIN_TIMED))
    return {"n_params": n_params, "losses": losses, "times": times,
            "update_s": hook.seconds, "counts": counts, "peak": peak,
            "prof": prof, "batch": batch}


def phase_train_phi3(torch, serve, MDL, OPT, TD, cfg, kernels,
                     others) -> dict:
    """15b: phi3-mini-3.8b as published, bf16 parameters, f32 AdamW
    state, remat, qchunk; one warm-up step, three timed, one profiled.
    The batch is halved only if the card runs out of memory."""
    # the reference's AdamW defaults: lr 3e-4 after 100 warm-up steps, so
    # 3e-6 to 1.5e-5 here (a first try's 2e-5 to 1e-4 sign-like steps,
    # every weight moving at once, sent the loss up within four steps)
    opt_cfg = OPT.AdamWConfig()
    batch = TRAIN_BATCH
    while True:
        err = None
        try:
            run = phi3_train_run(torch, serve, MDL, OPT, TD, cfg,
                                 opt_cfg, batch, kernels, others)
            break
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        gc.collect()                # the failed run's tensors, freed
        torch.cuda.empty_cache()
        check(batch > 1, f"phase 15b: out of memory at batch 1: {err}")
        log(f"phase 15b: out of memory at batch {batch} ({err}); halving "
            f"the batch")
        batch //= 2
    losses, times = run["losses"], run["times"]
    import statistics
    step_s = statistics.median(times[1:])
    upd_s = statistics.median(run["update_s"][1:1 + TRAIN_TIMED])
    tokens = batch * TRAIN_SEQ
    flops = 6 * run["n_params"] * tokens
    pr = run["prof"]
    log(f"phase 15b: {cfg.name} as published ({run['n_params']} "
        f"parameters, {cfg.n_layers} layers, d {cfg.d_model}, bf16, f32 "
        f"AdamW state, remat, qchunk), B {batch} x S {TRAIN_SEQ} = "
        f"{tokens} tokens a step: losses {losses}; step s {times} (first "
        f"= warm-up); median {step_s * 1e3:.3f} ms a step = "
        f"{tokens / step_s:.1f} tokens/s; optimizer update "
        f"{upd_s * 1e3:.3f} ms = {upd_s / step_s:.4f} of the step; peak "
        f"device memory {run['peak'] / 1e9:.3f} GB "
        f"({run['peak'] / 2**30:.3f} GiB); 6*N*tokens = {flops:.4e} flop "
        f"= {flops / step_s / 1e12:.2f} TFLOP/s = "
        f"{flops / step_s / BF16_FLOPS_PER_S:.4f} of the dense bf16 peak; "
        f"launches in the timed steps {run['counts']}")
    log(f"phase 15b: a profiled step: wall {pr['wall_us'] / 1e3:.3f} ms, "
        f"device busy {pr['busy_us'] / 1e3:.3f} ms "
        f"({pr['busy_us'] / pr['wall_us']:.4f} of wall) over "
        f"{pr['device_events']} device events")
    for name, n, us in pr["top"]:
        log(f"phase 15b: profiled step: {us / 1e3:.3f} ms "
            f"({us / pr['busy_us']:.4f} of busy) in {n} launches of "
            f"{name}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"phase 15b: losses {losses}")
    check(all(v == 0 for v in run["counts"].values()),
          f"phase 15b: the timed steps launched {run['counts']}")
    return dict(run, step_s=step_s, update_s=upd_s)


def counted_steps(MDL, kernels, others, deltas: list):
    """A check hook: ``MDL.make_train_step`` wrapped so each step records
    the launch counts it added (the counters are module globals; the
    checkpoint store's simulated device may launch ``zns_alloc`` from
    its save thread meanwhile)."""
    orig = MDL.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def counted(*args):
            before = all_counts(kernels, others)
            out = step(*args)
            after = all_counts(kernels, others)
            deltas.append({k: after[k] - before[k] for k in after})
            return out
        return counted
    return orig, make


def phase_train_xlstm(torch, launch_train, MDL, kernels, others) -> dict:
    """15c: xlstm-125m as published through the port's training CLI: an
    uninterrupted run, a run failing at step 4 from a fresh directory,
    and its restart, which must replay the uninterrupted run's losses
    for steps 3-5 bit for bit."""
    import shutil
    import statistics
    base = ROOT / "build" / "train_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    deltas: list = []
    orig, MDL.make_train_step = counted_steps(MDL, kernels, others, deltas)
    try:
        reset_all(kernels, others)
        torch.cuda.reset_peak_memory_stats()
        full = launch_train.main(XLSTM_TRAIN_ARGS + ["--ckpt-dir",
                                                     str(base / "a")])
        peak = torch.cuda.max_memory_allocated()
        counts = all_counts(kernels, others)
        try:
            launch_train.main(XLSTM_TRAIN_ARGS + [
                "--ckpt-dir", str(base / "b"), "--fail-at", "4"])
            fail("phase 15c: --fail-at 4 did not fail")
        except RuntimeError as e:
            check("injected failure at step 4" in str(e),
                  f"phase 15c: unexpected failure {e}")
        again = launch_train.main(XLSTM_TRAIN_ARGS + ["--ckpt-dir",
                                                      str(base / "b")])
    finally:
        MDL.make_train_step = orig
    res, res2 = full["result"], again["result"]
    check(res2.restored_from == 2,
          f"phase 15c: restored from {res2.restored_from}, not step 2")
    check(res2.losses == res.losses[3:],
          f"phase 15c: restart losses {res2.losses} != the uninterrupted "
          f"run's {res.losses[3:]}")
    check(all(math.isfinite(x) for x in res.losses)
          and res.losses[-1] < res.losses[0],
          f"phase 15c: losses {res.losses}")
    in_steps = {k: sum(d[k] for d in deltas) for k in deltas[0]}
    check(all(v == 0 for k, v in in_steps.items() if k != "zns_alloc"),
          f"phase 15c: train steps launched {in_steps}")
    ck, rep = full["ckpt"], full["zns"]
    n_params = sum(p.numel() for p in full["model"].parameters())
    check(n_params == XLSTM_PARAMS, f"xlstm-125m: {n_params} parameters")
    step_ms = statistics.median(res.step_times[1:]) * 1e3
    tokens = (int(XLSTM_TRAIN_ARGS[XLSTM_TRAIN_ARGS.index("--batch") + 1])
              * int(XLSTM_TRAIN_ARGS[XLSTM_TRAIN_ARGS.index("--seq") + 1]))
    log(f"phase 15c: xlstm-125m as published ({n_params} parameters) "
        f"through launch.train.main {' '.join(XLSTM_TRAIN_ARGS)}: losses "
        f"{res.losses}; step s {res.step_times} (first = warm-up); median "
        f"{step_ms:.3f} ms a step = {tokens / step_ms * 1e3:.1f} tokens/s; "
        f"peak device memory {peak / 1e9:.3f} GB; whole run "
        f"{full['seconds']:.2f} s")
    log(f"phase 15c: restart after --fail-at 4: restored from checkpoint "
        f"step {res2.restored_from}, losses {res2.losses} == the "
        f"uninterrupted run's steps 3-5 bit for bit")
    log(f"phase 15c: ZNS checkpoint-store telemetry (zn540, SUPERBLOCK, "
        f"keep 2): DLWA {rep['dlwa']!r}, SA {rep['sa']!r}, finishes "
        f"{rep['finishes']:.0f}, resets {rep['resets']:.0f}, host pages "
        f"{rep['host_pages']:.0f}, dummy pages {rep['dummy_pages']:.0f}; "
        f"{ck.saves} saves, {ck.bytes_saved / ck.saves:.0f} bytes a save, "
        f"{ck.save_seconds / ck.saves:.3f} s a save (disk and telemetry, "
        f"on the writer thread); launches in the run {counts} "
        f"(zns_alloc: the store's simulated device), in its train steps "
        f"{in_steps}")
    shutil.rmtree(base, ignore_errors=True)
    return {"step_ms": step_ms, "zns": rep, "peak": peak}


def phase_autograd_guard(torch, fops) -> None:
    """15d: a kernel call on CUDA tensors that require grad, grad mode
    on, raises; under ``torch.no_grad()`` it launches once."""
    q = torch.randn(1, 4, 128, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    fops.reset_launches()
    try:
        fops.attention(q, q, q, causal=True)
        fail("phase 15d: flash attention under autograd did not raise")
    except RuntimeError as e:
        check("no backward" in str(e), f"phase 15d: raised {e}")
    check(fops.launches == 0, "phase 15d: the refused call launched")
    with torch.no_grad():
        out = fops.attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    check(fops.launches == 1 and out.grad_fn is None,
          f"phase 15d: no_grad call launched {fops.launches}")
    log("phase 15d: flash_attention on CUDA tensors requiring grad raised "
        "under grad mode and launched once under torch.no_grad()")

# --------------------------------------------------------------------- #
# phase 16: the distributed paths, one process a card
# --------------------------------------------------------------------- #
#: 16a: a 256 MB f32 buffer
PSUM_SHAPE = (65536, 1024)
#: 16b: the reference test's block at width 4096, M 8 microbatches
PIPE_WIDTH, PIPE_MICRO, PIPE_BATCH = 4096, 8, 64
#: 16c: the check's cut (depth, global batch, seq)
DIST_CUT = (2, 2, 256)
#: 16d: granite's prompts and decode steps
DIST_DECODE = (8, 512, 8)
DIST_TOL = {"psum": 1e-6, "pipe": 1e-5, "scalar": 1e-5, "leaf": 1e-4,
            "loss": 2e-2, "decode": 3e-2, "aux": 1e-5, "moe_out": 2.5e-2}
#: 16f: Jamba-1.5-Large's prompts and decode steps (depth 4 everywhere,
#: the full period of 8 layers on four cards)
DIST_MOE = (8, 512, 8)


def worst(errs) -> float:
    """The largest of ``errs``, or inf where one is not finite (Python's
    ``max`` passes over a NaN that is not first)."""
    errs = list(errs)
    return max(errs) if all(map(math.isfinite, errs)) else math.inf


def dist_mesh(world: int) -> dict:
    """(data, model) of phases 16c / 16d: (2, 2) on four cards."""
    return {"data": 2, "model": 2} if world == 4 else \
        {"data": 1, "model": world}


def dist_psum(torch, dist, G, M, world: int) -> dict:
    """16a: hierarchical vs flat all-reduce of each rank's own buffer."""
    pod = 2 if world == 4 else 1
    mesh = M.make_mesh({"pod": pod, "data": world // pod})
    gen = torch.Generator(device="cuda").manual_seed(dist.get_rank())
    x = torch.rand(PSUM_SHAPE, generator=gen, device="cuda") + 1.0
    flat = x.clone()
    dist.all_reduce(flat)
    hier = G.hierarchical_psum(x, mesh)
    err = float(((hier - flat).abs() / flat.abs()).max())
    del hier, flat

    y = x.clone()           # the flat all-reduce sums into it in place
    times = {"flat": [], "hier": []}
    for name in ("flat", "hier", "hier", "flat"):
        fn = (lambda: dist.all_reduce(y)) if name == "flat" else (
            lambda: G.hierarchical_psum(x, mesh))
        times[name].append(cuda_ms(torch, fn, 5))
    nbytes = x.numel() * x.element_size()
    out = {"rel_err": err, "mesh": {"pod": pod, "data": world // pod},
           "bytes": nbytes}
    for name, ms in times.items():
        best = min(ms)
        # NCCL's bus bandwidth of an all-reduce: bytes x 2(n-1)/n over time
        out[name] = {"ms": ms, "bus_gb_s": nbytes * 2 * (world - 1) / world
                     / (best / 1e3) / 1e9}
    return out


def dist_pipeline(torch, M, pipeline_apply, pipeline_utilization,
                  world: int) -> dict:
    """16b: the pipeline over one stage a card vs the stages in sequence."""
    mesh = M.make_mesh({"stage": world})
    gen = torch.Generator(device="cuda").manual_seed(16)
    ws = torch.randn((world, PIPE_WIDTH, PIPE_WIDTH), generator=gen,
                     device="cuda") / math.sqrt(PIPE_WIDTH)
    x = torch.randn((PIPE_BATCH, PIPE_WIDTH), generator=gen, device="cuda")

    def block(w, a):
        return torch.tanh(a @ w)

    def run():
        return pipeline_apply(block, ws, x, mesh=mesh, axis="stage",
                              n_micro=PIPE_MICRO)
    out = run()
    ref = x
    for w in ws:
        ref = block(w, ref)
    err = float((out - ref).abs().max())
    return {"max_abs_err": err, "ms": cuda_ms(torch, run, 5),
            "utilization": pipeline_utilization(PIPE_MICRO, world)}


def dist_train_check(torch, SH, M, MDL, OPT, TD, serve, cfg, world,
                     ckpt_dir) -> dict:
    """16c check: the depth-2 f32 cut, sharded vs one card's unsharded:
    the gradients, then two train steps -- their metrics, and every
    parameter and moment after them; then the state saved at this mesh
    and restored on (1, n)."""
    import dataclasses
    from repro_torch.models.shards import whole as gathered
    from repro_torch.train.checkpoint import CheckpointManager
    depth, batch, seq = DIST_CUT
    cut = dataclasses.replace(cfg, n_layers=depth)
    mesh = M.make_mesh(dist_mesh(world))
    data = TD.SyntheticLM(vocab=cut.vocab, batch=batch, seq=seq, seed=0)
    bs = [{k: torch.as_tensor(v, device="cuda")
           for k, v in data.batch_at(i).items()} for i in range(2)]
    b = bs[0]
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def fresh():
        return serve.build(cut, seed=0, device="cuda", dtype=torch.float32)

    def grads(model, batch):
        with SH.implicit_replication():
            loss, _ = MDL.loss_fn(SH.T.set_trainable(model), cut, batch)
            gs = torch.autograd.grad(loss, list(model.parameters()))
        return [gathered(g) for g in gs]
    ref_g = grads(fresh(), b)
    got_g = grads(SH.shard_model(fresh(), mesh),
                  SH.shard_batch(b, mesh, batch))
    leaf = worst(rel_err(torch, a, r)[0] for a, r in zip(got_g, ref_g))
    del ref_g, got_g

    def whole(model, opt):
        return [gathered(p.detach()) for mod in (model, opt.mu, opt.nu)
                for p in mod.parameters()]

    def two_steps(opt_cfg):
        """Two steps sharded and unsharded: the sharded model and state,
        the metrics' rel errs, and the worst rel err of the parameters
        and of the moments after them."""
        step = MDL.make_train_step(cut, opt_cfg)

        def steps(model, batches):
            opt, metrics = OPT.init(model), []
            for one in batches:
                model, opt, m = step(model, opt, one)
                metrics.append(m)
            return model, opt, metrics
        ref, ref_opt, ref_m = steps(fresh(), bs)
        ref_state = whole(ref, ref_opt)
        del ref, ref_opt
        model, opt, ms = steps(SH.shard_model(fresh(), mesh), [
            SH.shard_batch(one, mesh, batch) for one in bs])
        errs = {k: worst(rel(float(m[k]), float(r[k]))
                         for m, r in zip(ms, ref_m))
                for k in ("loss", "nll", "grad_norm")}
        state = [rel_err(torch, a, r)[0]
                 for a, r in zip(whole(model, opt), ref_state)]
        n = len(state) // 3
        return model, opt, errs, worst(state[:n]), worst(state[n:])
    model, opt, errs, params, moments = two_steps(opt_cfg)
    # eps 1e-8 makes AdamW's first steps take each element's sign, so an
    # element whose gradient is at rounding noise may flip: the
    # parameters are then held with eps 1e-3, where the update is at
    # most lr / eps times the gradient's error
    *_, params_eps, moments_eps = two_steps(
        dataclasses.replace(opt_cfg, eps=1e-3))
    want = whole(model, opt)

    # the elastic restore: saved at this mesh, restored on (1, n)
    ck = CheckpointManager(ckpt_dir, async_save=True)
    ck.save(1, {"params": model, "opt": opt})
    other = M.make_mesh({"data": 1, "model": world})
    blank = serve.build(cut, seed=1, device="cuda", dtype=torch.float32)
    state, _ = ck.restore({"params": blank, "opt": OPT.init(blank)},
                          shardings=other)
    got = whole(state["params"], state["opt"])
    same = len(got) == len(want) and all(
        torch.equal(a, w) for a, w in zip(got, want))
    on = next(state["params"].parameters()).device_mesh
    return {"errs": errs, "leaf": leaf, "params": params,
            "moments": moments, "params_eps": params_eps,
            "moments_eps": moments_eps,
            "restore_bit_equal": same,
            "restore_mesh": M.mesh_shape(on), "saved_mesh": dist_mesh(world)}


def dist_train_timed(torch, SH, M, MDL, OPT, TD, CO, serve, cfg, world,
                     base_loss) -> dict:
    """16c timed: phi3 at full depth, bf16, remat; a step with its
    collectives recorded, then three timed steps."""
    shape = dist_mesh(world)
    mesh = M.make_mesh(shape)
    batch = TRAIN_BATCH * shape["data"]
    data = TD.SyntheticLM(vocab=cfg.vocab, batch=batch, seq=TRAIN_SEQ,
                          seed=0)
    model = serve.build(cfg, seed=0, device="cuda")
    first = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(0).items()}
    if base_loss is None:       # the unsharded loss of the same batch
        with torch.no_grad():
            base_loss = float(MDL.loss_fn(model, cfg, first)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SH.shard_model(model, mesh)
    opt = OPT.init(model)
    step = MDL.make_train_step(cfg, OPT.AdamWConfig())
    losses, times = [], []
    rec = None
    for i in range(1 + TRAIN_TIMED):
        b = SH.shard_batch({k: torch.as_tensor(v, device="cuda")
                            for k, v in data.batch_at(i).items()},
                           mesh, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with CO.CollectiveRecord() as rec:
                model, opt, m = step(model, opt, b)
        else:
            model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "times": times, "batch": batch,
            "base_loss": base_loss, "mesh": shape,
            "peak": torch.cuda.max_memory_allocated(),
            "collectives": CO.collective_bytes(rec),
            "collective_counts": CO.collective_count(rec)}


def dist_decode(torch, SH, M, T, serve, cfg, world) -> dict:
    """16d: granite prefill + decode on sharded caches vs one card."""
    from repro_torch.models.shards import whole as gathered
    n_seq, prompt_len, steps = DIST_DECODE
    mesh = M.make_mesh(dist_mesh(world))
    model = serve.build(cfg, seed=0, device="cuda")
    prompts, _ = serve.make_inputs(cfg, n_seq, prompt_len, seed=0)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    max_seq = prompt_len + steps

    def run(caches, wrap):
        outs, times = [], []
        with torch.no_grad(), SH.implicit_replication():
            lg, caches = T.forward_prefill(model, cfg, wrap(prompts), caches,
                                           attn_impl="qchunk",
                                           ssm_impl="ref")
            outs.append(lg)
            for i in range(steps):
                tok = torch.full((n_seq,), i + 1, dtype=torch.int32,
                                 device="cuda")
                pos = torch.full((n_seq,), prompt_len + i,
                                 dtype=torch.int32, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = T.forward_decode(model, cfg, wrap(tok), caches,
                                              wrap(pos), attn_impl="dense")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                outs.append(lg)
        return [gathered(o) for o in outs], times
    ref, ref_t = run(T.init_caches(cfg, n_seq, max_seq, device="cuda"),
                     lambda t: t)
    SH.shard_model(model, mesh)
    caches = SH.shard_caches(cfg, T.init_caches(cfg, n_seq, max_seq,
                                                device="cuda"), mesh, n_seq)
    dp = SH.spec(SH.fit_batch_axes(mesh, n_seq))
    got, got_t = run(caches, lambda t: SH.place(t, dp, mesh))
    k_place = [str(p) for p in caches["k"].placements]
    err = worst(rel_err(torch, g[:, :cfg.vocab], r[:, :cfg.vocab])[0]
                for g, r in zip(got, ref))
    return {"rel_err": err, "step_s": got_t, "unsharded_step_s": ref_t,
            "mesh": dist_mesh(world), "k_placements": k_place}


def moe_ffns(T, model) -> list:
    return [m for m in model.modules() if isinstance(m, T.MoEFFN)]


def moe_serve(torch, SH, T, serve, cfg, model, caches, wrap,
              times=None) -> list:
    """16f: prefill the DIST_MOE prompts on the plain paths, then decode
    teacher-forced steps (token i + 1 at step i); the logits of each call,
    gathered.  ``times``: a list to take each call's seconds."""
    from repro_torch.models.shards import whole
    n_seq, prompt_len, steps = DIST_MOE
    prompts = torch.as_tensor(serve.make_inputs(cfg, n_seq, prompt_len,
                                                seed=0)[0],
                              dtype=torch.int32, device="cuda")
    out = []
    with torch.no_grad(), SH.implicit_replication():
        for i in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                lg, caches = T.forward_prefill(model, cfg, wrap(prompts),
                                               caches, attn_impl="qchunk",
                                               ssm_impl="ref")
            else:
                tok = torch.full((n_seq,), i, dtype=torch.int32,
                                 device="cuda")
                pos = torch.full((n_seq,), prompt_len + i - 1,
                                 dtype=torch.int32, device="cuda")
                lg, caches = T.forward_decode(model, cfg, wrap(tok), caches,
                                              wrap(pos), attn_impl="dense")
            torch.cuda.synchronize()
            if times is not None:
                times.append(time.perf_counter() - t0)
            out.append(whole(lg)[:, :cfg.vocab])
    return out


class ResidualTaps:
    """While open, every residual add's operand (each layer's mixer
    output, then its FFN's) gathered whole in call order, for 16f's
    per-layer comparison; on placed tensors each is a collective, which
    every rank makes in the same order."""

    def __init__(self, T):
        from repro_torch.models.shards import whole
        self.T, self.inner, self.taps = T, T._add, []

        def tapped(res, o):
            self.taps.append(whole(o))
            return self.inner(res, o)
        T._add = tapped

    def close(self) -> list:
        self.T._add = self.inner
        return self.taps


class MambaTaps:
    """While open, the first Mamba mixer of every call (prefill, then each
    decode call) tapped product by product, each gathered whole: the
    column-parallel ``in_proj`` (its input too), the conv (after its
    SiLU), the row-parallel ``x_proj``, ``dt_proj``, the scan (before
    the gate), the gate and the row-parallel ``out_proj``; and that
    mixer's weights where ``weights``.  Only 16f under ``--phase16``
    opens it.  The port's code runs as it is: module functions are
    wrapped to note their results, and a scan's local output is placed as
    its region places the gate's."""

    def __init__(self, M, shards, ssm_ops, weights=False):
        from torch.distributed.tensor import DTensor
        self.mods = [(M, n, getattr(M, n)) for n in (
            "mamba_forward", "mamba_decode", "_parts", "_dt_b_c")] + [
            (shards, "row_parallel", shards.row_parallel)] + [
            (ssm_ops, n, getattr(ssm_ops, n))
            for n in ("ssm_scan", "single_step")]
        orig = {n: f for _, n, f in self.mods}
        self.calls, self.first, self.cur, self.stash = [], None, None, None

        def note(name, t):
            if self.cur is not None:
                self.cur[name] = shards.whole(t)

        def mixer(name):
            def call(p, *args, **kwargs):
                if self.first is None:
                    self.first = p
                    self.weights = {k: shards.whole(p[k]) for k in (
                        "in_proj", "x_proj", "dt_proj", "out_proj")
                        if weights}
                if p is not self.first:
                    return orig[name](p, *args, **kwargs)
                self.cur = {}
                try:
                    return orig[name](p, *args, **kwargs)
                finally:
                    self.calls.append(self.cur)
                    self.cur = None
            return call

        def region_of(region):
            def call(fn, args, dims, out_dims, in_place=()):
                out = region(fn, args, dims, out_dims, in_place)
                first = out[0] if isinstance(out, tuple) else out
                if self.cur is not None and self.stash is not None:
                    y, self.stash = self.stash, None
                    if isinstance(first, DTensor):
                        y = DTensor.from_local(y, region.mesh,
                                               region.placements(out_dims),
                                               run_check=False)
                    note("scan", y)
                    note("gate", first)
                elif self.cur is not None:
                    note("conv", first)
                return out
            return call

        def parts(p, x, state=None):
            region, xz, d_inner = orig["_parts"](p, x, state)
            note("in_proj_input", x)
            note("in_proj", xz)
            return region_of(region), xz, d_inner

        def dt_b_c(p, xc, state):
            dt_lin, b, c = orig["_dt_b_c"](p, xc, state)
            note("dt_proj", dt_lin)
            return dt_lin, b, c

        def row_parallel(a, w, groups=()):
            y = orig["row_parallel"](a, w, groups)
            if self.cur is not None:
                note("out_proj" if "x_proj" in self.cur else "x_proj", y)
            return y

        def scan_out(name, pick):
            def call(*args, **kwargs):
                out = orig[name](*args, **kwargs)
                if self.cur is not None:
                    self.stash = pick(out)
                return out
            return call
        wrapped = {"mamba_forward": mixer("mamba_forward"),
                   "mamba_decode": mixer("mamba_decode"), "_parts": parts,
                   "_dt_b_c": dt_b_c, "row_parallel": row_parallel,
                   "ssm_scan": scan_out("ssm_scan", lambda y: y),
                   "single_step": scan_out("single_step", lambda o: o[1])}
        for mod, n, _ in self.mods:
            setattr(mod, n, wrapped[n])

    def close(self) -> list:
        for mod, n, f in self.mods:
            setattr(mod, n, f)
        return self.calls


#: the first Mamba mixer's products, in order
MAMBA_PRODUCTS = ("in_proj", "conv", "x_proj", "dt_proj", "scan", "gate",
                  "out_proj")


def mamba_product_split(torch, call: dict, w: dict, mesh: dict) -> dict:
    """The first Mamba mixer's four matmuls recomputed on card 0 from the
    unplaced run's inputs, at the shards ``mesh`` (data, model) gives each
    rank -- rows over ``data``; ``in_proj`` / ``dt_proj`` columns and
    ``x_proj`` / ``out_proj`` rows over ``model``, those partials summed
    in f32 and rounded once as ``shards.row_parallel`` sums them on
    DTensors -- against the unplaced products: {product: (share of
    elements that differ, rel err)}."""
    nd, nm = mesh["data"], mesh["model"]
    dt_rank = w["dt_proj"].shape[0]
    ins = {"in_proj": call["in_proj_input"], "x_proj": call["conv"],
           "dt_proj": call["x_proj"][..., :dt_rank], "out_proj": call["gate"]}
    out = {}
    for name, a in ins.items():
        wt = w[name]
        rows = a.chunk(nd, dim=0)
        if name in ("in_proj", "dt_proj"):
            got = torch.cat([torch.cat([r @ c for c in wt.chunk(nm, dim=1)],
                                       dim=-1) for r in rows])
        else:
            k = a.shape[-1] // nm
            got = torch.cat([sum(r[..., i * k:(i + 1) * k].float()
                                 @ wt[i * k:(i + 1) * k].float()
                                 for i in range(nm)).to(a.dtype)
                             for r in rows])
        want = a @ wt
        out[name] = (float((got != want).float().mean()),
                     rel_err(torch, got, want)[0])
    return out


def op_labels(T, cfg) -> list:
    """The residual adds of one call of ``cfg``, in order: ``L<i> <mixer
    kind>`` and ``L<i> moe`` or ``L<i> ffn``."""
    return [f"L{i} {name}" for i, (kind, moe) in enumerate(T.layer_plan(cfg))
            for name in (kind, "moe" if moe else "ffn")]


def dist_moe_check(torch, dist, SH, M, T, serve, cfg, world,
                   products=False) -> dict:
    """16f check: a Jamba cut with its 16 experts, unplaced on card 0
    (plain paths; every MoE layer records its routes), freed; then placed
    on every card by the production rules from the same seed, replaying
    those routes: each MoE call's kept mask and positions, its aux loss,
    and every call's logits against card 0's.  ``products``
    (``--phase16``): the first Mamba mixer of each call product by
    product too (:class:`MambaTaps`), and its matmuls at four cards'
    shards on card 0 (:func:`mamba_product_split`)."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import mamba as MB
    from repro_torch.models import shards as SHD
    from repro_torch.models.shards import whole

    def mamba_taps(weights=False):
        return MambaTaps(MB, SHD, ssm_ops, weights) if products else None
    n_seq, prompt_len, steps = DIST_MOE
    mesh = M.make_mesh(dist_mesh(world))
    rank = dist.get_rank()
    max_seq = prompt_len + steps
    k = cfg.top_k
    rows = [n_seq * prompt_len] + [n_seq] * steps     # tokens a call
    n_moe = sum(moe for _, moe in T.layer_plan(cfg))
    routes = torch.empty((n_moe, sum(rows) * k), dtype=torch.int64,
                         device="cuda")
    ref, ref_taps, ref_products, split = None, [], [], []
    t0 = time.perf_counter()
    if rank == 0:
        model = serve.build(cfg, seed=0, device="cuda")
        for ffn in moe_ffns(T, model):
            ffn.record = []
        del ffn                 # a layer's 19 GB of experts
        taps, mtaps = ResidualTaps(T), mamba_taps(weights=True)
        try:
            logits = moe_serve(torch, SH, T, serve, cfg, model,
                               T.init_caches(cfg, n_seq, max_seq,
                                             device="cuda"), lambda t: t)
        finally:
            ref_taps = taps.close()
            ref_products = mtaps.close() if mtaps else []
        split = [mamba_product_split(torch, c, mtaps.weights,
                                     {"data": 2, "model": 2})
                 for c in ref_products[:2]]
        if mtaps:
            del mtaps.weights
        recs = [f.record for f in moe_ffns(T, model)]
        routes.copy_(torch.stack([torch.cat([r.gate_idx.reshape(-1)
                                             for r in rec]) for rec in recs]))
        ref = {"logits": logits,
               "keep": [[r.keep for r in rec] for rec in recs],
               "pos": [[r.pos for r in rec] for rec in recs],
               "aux": [[float(r.aux) for r in rec] for rec in recs]}
        del model, recs
        gc.collect()
        torch.cuda.empty_cache()
    unplaced_s = time.perf_counter() - t0
    dist.broadcast(routes, src=0)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = serve.build(cfg, seed=0, device="cuda", mesh=mesh)
    for ffn, r in zip(moe_ffns(T, model), routes):
        ffn.record = []
        ffn.replay = iter(r.view(-1, k).split(rows))
    del ffn
    caches = SH.shard_caches(cfg, T.init_caches(cfg, n_seq, max_seq,
                                                device="cuda"), mesh, n_seq)
    dp = SH.spec(SH.fit_batch_axes(mesh, n_seq))
    taps, mtaps = ResidualTaps(T), mamba_taps()
    try:
        logits = moe_serve(torch, SH, T, serve, cfg, model, caches,
                           lambda t: SH.place(t, dp, mesh))
    finally:
        placed_taps = taps.close()
        placed_products = mtaps.close() if mtaps else []
    got = [[(whole(r.keep), whole(r.pos), float(r.aux)) for r in f.record]
           for f in moe_ffns(T, model)]
    peak = torch.cuda.max_memory_allocated()
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    out = {"mesh": dist_mesh(world), "unplaced_s": unplaced_s,
           "placed_s": time.perf_counter() - t0, "peak": peak,
           "calls": len(rows), "moe_layers": n_moe}
    if rank == 0:
        out["routes_equal"] = all(
            torch.equal(g[0], rk) and torch.equal(g[1], rp)
            for gl, kl, pl in zip(got, ref["keep"], ref["pos"])
            for g, rk, rp in zip(gl, kl, pl))
        out["dropped"] = sum(int((~rk).sum()) for kl in ref["keep"]
                             for rk in kl)
        out["aux_pairs"] = [[(a, g[2]) for g, a in zip(gl, al)]
                            for gl, al in zip(got, ref["aux"])]
        out["aux"] = worst(abs(g - a) for pl in out["aux_pairs"]
                           for a, g in pl)
        errs = [rel_err(torch, g, r)[0]
                for g, r in zip(logits, ref["logits"])]
        out["prefill_logits"], out["decode_logits"] = errs[0], worst(
            errs[1:])
        out["finite"] = all(bool(torch.isfinite(g).all()) for g in logits)
        # each layer's mixer and FFN output, placed vs unplaced, a call
        labels = op_labels(T, cfg)
        check(len(placed_taps) == len(ref_taps) == len(labels) * len(rows),
              f"16f: {len(placed_taps)} placed and {len(ref_taps)} unplaced "
              f"residual adds, want {len(labels)} a call x {len(rows)}")
        op_errs = [rel_err(torch, g, r)[0]
                   for g, r in zip(placed_taps, ref_taps)]
        out["op_labels"] = labels
        out["op_errs"] = [op_errs[i:i + len(labels)]
                          for i in range(0, len(op_errs), len(labels))]
        # the aux by MoE layer: the largest difference over the calls and
        # the aux it was taken at
        out["aux_by_layer"] = [max(((abs(g - a), a) for a, g in pl),
                                   key=lambda t: t[0])
                               for pl in out["aux_pairs"]]
        if products:
            check(len(placed_products) == len(ref_products) == len(rows),
                  f"16f: {len(placed_products)} placed and "
                  f"{len(ref_products)} unplaced first Mamba mixers, want "
                  f"{len(rows)}")
            out["mamba_products"] = [
                {k: rel_err(torch, g[k], r[k])[0]
                 for k in ("in_proj_input",) + MAMBA_PRODUCTS}
                for g, r in zip(placed_products, ref_products)]
            out["mamba_split"] = split
    del ref_taps, placed_taps
    return out


def dist_moe_period(torch, SH, M, T, MOE, CO, serve, cfg, world) -> dict:
    """16f on four cards: Jamba's full pattern period with its 16 experts
    (89 GB of bf16 weights: no card holds it whole), placed on (data,
    model) = (2, 2) layer by layer as drawn; prefill and decode timed,
    memory a card, one decode step's collectives; then each MoE layer's
    placed prefill output against ``moe_forward`` on card 0 on the same
    gathered input, routes (replayed) and weights (gathered one layer at
    a time)."""
    from repro_torch.models.shards import whole
    import statistics
    n_seq, prompt_len, steps = DIST_MOE
    mesh = M.make_mesh(dist_mesh(world))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build(cfg, seed=0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated()
    seen = []
    for f in moe_ffns(T, model):
        f.record = []

        def capture(x, _f=f, _apply=f.apply_aux):
            out = _apply(x)
            seen.append((_f, x, out[0]))
            return out
        f.apply_aux = capture

    def caches():
        return SH.shard_caches(cfg, T.init_caches(
            cfg, n_seq, prompt_len + steps, device="cuda"), mesh, n_seq)
    dp = SH.spec(SH.fit_batch_axes(mesh, n_seq))

    def wrap(t):
        return SH.place(t, dp, mesh)
    first = []
    logits = moe_serve(torch, SH, T, serve, cfg, model, caches(), wrap,
                       first)
    checks = list(seen)[:sum(1 for _ in moe_ffns(T, model))]
    seen.clear()
    times = []
    moe_serve(torch, SH, T, serve, cfg, model, caches(), wrap, times)
    seen.clear()
    # one decode step's collectives, on fresh caches after a prefill
    c = caches()
    n_prompt = torch.full((n_seq, prompt_len), 1, dtype=torch.int32,
                          device="cuda")
    with torch.no_grad(), SH.implicit_replication():
        T.forward_prefill(model, cfg, wrap(n_prompt), c, attn_impl="qchunk",
                          ssm_impl="ref")
        with CO.CollectiveRecord() as rec:
            T.forward_decode(model, cfg, wrap(torch.ones(
                n_seq, dtype=torch.int32, device="cuda")), c,
                wrap(torch.full((n_seq,), prompt_len, dtype=torch.int32,
                                device="cuda")), attn_impl="dense")
    del c
    seen.clear()
    peak = torch.cuda.max_memory_allocated()

    layer_errs, layer_equal, layer_aux = [], [], []
    for f, x, y in checks:
        r = f.record[0]
        x_all, y_all = whole(x), whole(y)
        p = {n: whole(getattr(f, n)) for n in ("router", "w_gate", "w_up",
                                               "w_down")}
        keep, pos, gate = whole(r.keep), whole(r.pos), whole(r.gate_idx)
        if torch.distributed.get_rank() == 0:
            with torch.no_grad():
                want, wr = MOE.moe_forward(p, x_all, f.dims, routes=gate)
            layer_equal.append(torch.equal(wr.keep, keep)
                               and torch.equal(wr.pos, pos))
            layer_errs.append(rel_err(torch, y_all, want)[0])
            layer_aux.append(abs(float(r.aux) - float(wr.aux)))
        del p, x_all, y_all
        torch.cuda.empty_cache()
    for f in moe_ffns(T, model):
        del f.apply_aux
    return {"mesh": dist_mesh(world), "params": sum(
        p.numel() for p in model.parameters()), "build_s": build_s,
            "weights_bytes": weights, "peak": peak,
            "prefill_s": times[0], "first_prefill_s": first[0],
            "decode_s": times[1:],
            "decode_ms": statistics.median(times[1:]) * 1e3,
            "prefill_tok_s": n_seq * prompt_len / times[0],
            "collective_counts": CO.collective_count(rec),
            "collectives": CO.collective_bytes(rec),
            "layer_equal": layer_equal, "layer_errs": layer_errs,
            "layer_aux": layer_aux,
            "finite": all(bool(torch.isfinite(g).all()) for g in logits)}


def dist_kernel_refusal(torch, SH, M, fops, world: int) -> str:
    """16e: a kernel wrapper given a DTensor raises."""
    mesh = M.make_mesh({"data": world})
    q = SH.place(torch.randn(world, 4, 128, 64, device="cuda",
                             dtype=torch.bfloat16), ("data",), mesh)
    try:
        fops.attention(q, q, q, causal=True)
    except TypeError as e:
        return str(e)
    fail("phase 16e: flash attention took a DTensor")


def phase16_rank(rank: int, world: int, base_loss, ckpt_dir: str,
                 products: bool = False) -> dict:
    """One rank of phase 16 (a spawned process on card ``rank``);
    ``products``: 16f's first Mamba mixer product by product
    (``--phase16``)."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.analysis import collectives as CO
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.page_clock import ops as pc_ops
    from repro_torch.kernels.slstm_scan import ops as slops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.zns_alloc import ops as zops
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as MDL
    from repro_torch.models import transformer as T
    from repro_torch.train import data as TD
    from repro_torch.train import grad as G
    from repro_torch.train import optimizer as OPT
    from repro_torch.train.pipeline import (pipeline_apply,
                                            pipeline_utilization)
    kernels = {"flash_attention": fops, "decode_attention": dops,
               "ssm_scan": sops, "mlstm_scan": mops, "slstm_scan": slops}
    others = {"zns_alloc": zops, "page_clock": pc_ops}
    out, secs = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    timed("16a", lambda: dist_psum(torch, dist, G, M, world))
    timed("16b", lambda: dist_pipeline(torch, M, pipeline_apply,
                                       pipeline_utilization, world))
    reset_all(kernels, others)
    phi3 = get_arch("phi3-mini-3.8b")
    timed("16c_check", lambda: dist_train_check(
        torch, SH, M, MDL, OPT, TD, serve, phi3, world, ckpt_dir))
    gc.collect()
    torch.cuda.empty_cache()
    timed("16c", lambda: dist_train_timed(
        torch, SH, M, MDL, OPT, TD, CO, serve, phi3, world, base_loss))
    gc.collect()
    torch.cuda.empty_cache()
    timed("16d", lambda: dist_decode(torch, SH, M, T, serve,
                                     get_arch("granite-3-8b"), world))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs.jamba15_large_398b import DEPTH4, PERIOD
    from repro_torch.models import moe as MOE
    timed("16f_check", lambda: dist_moe_check(torch, dist, SH, M, T, serve,
                                              DEPTH4, world, products))
    gc.collect()
    torch.cuda.empty_cache()
    if world == 4:
        timed("16f", lambda: dist_moe_period(torch, SH, M, T, MOE, CO,
                                             serve, PERIOD, world))
        gc.collect()
        torch.cuda.empty_cache()
    out["counts"] = all_counts(kernels, others)
    out["16e"] = dist_kernel_refusal(torch, SH, M, fops, world)
    out["secs"] = secs
    out["card"] = torch.cuda.get_device_name(torch.cuda.current_device())
    return out


def phase_distributed(torch, base, products: bool = False) -> None:
    """16: spawn one process a card and check what they return.  ``base``:
    the unsharded loss of 16c's first batch where it is known (15b's first
    loss, on one card), else None and rank 0 computes it.  ``products``
    (``--phase16``): 16f's first Mamba mixer product by product."""
    import shutil
    from repro_torch.launch import mesh as M
    world = min(4, torch.cuda.device_count())
    gc.collect()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        res = M.run_ranks(phase16_rank, world, base,
                          str(work / "ckpt"), products, backend="nccl",
                          work_dir=str(work), timeout_s=900)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 16: {e}")
    wall = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    r = res[0]
    log(f"phase 16: {world} process(es), one a card ({r['card']} x "
        f"{torch.cuda.device_count()} visible), NCCL; wall {wall:.1f} s "
        f"(process start and NCCL set-up included); each check's s on "
        f"rank 0: { {k: round(v, 3) for k, v in r['secs'].items()} }")
    if world == 1:
        log("phase 16: one card: world size 1, so no collective crossed "
            "cards")
    a = r["16a"]
    check(a["rel_err"] <= DIST_TOL["psum"],
          f"phase 16a: hierarchical vs flat all-reduce rel {a['rel_err']}")
    log(f"phase 16a: hierarchical_psum over (pod, data) = "
        f"({a['mesh']['pod']}, {a['mesh']['data']}) == flat all_reduce "
        f"(max rel {a['rel_err']:.3e}) on a {a['bytes']} B f32 buffer; "
        f"flat {min(a['flat']['ms']):.4f} ms ({a['flat']['bus_gb_s']:.2f} "
        f"bus GB/s), hierarchical {min(a['hier']['ms']):.4f} ms "
        f"({a['hier']['bus_gb_s']:.2f} bus GB/s); runs (ms) flat "
        f"{a['flat']['ms']}, hierarchical {a['hier']['ms']}")
    b = r["16b"]
    check(b["max_abs_err"] <= DIST_TOL["pipe"],
          f"phase 16b: pipeline vs sequential {b['max_abs_err']}")
    log(f"phase 16b: pipeline_apply over {world} stage(s), width "
        f"{PIPE_WIDTH}, M {PIPE_MICRO}, B {PIPE_BATCH}: == the stages in "
        f"sequence (max abs {b['max_abs_err']:.3e}), {b['ms']:.4f} ms a "
        f"call; pipeline_utilization {b['utilization']:.4f}")
    c = r["16c_check"]
    check(all(v <= DIST_TOL["scalar"] for v in c["errs"].values())
          and all(c[k] <= DIST_TOL["leaf"] for k in (
              "leaf", "moments", "params_eps", "moments_eps"))
          and math.isfinite(c["params"]),
          f"phase 16c: sharded vs unsharded {c['errs']}, gradient leaf "
          f"{c['leaf']}, after two steps parameters {c['params']} "
          f"moments {c['moments']}, with eps 1e-3 parameters "
          f"{c['params_eps']} moments {c['moments_eps']}")
    check(c["restore_bit_equal"] and c["restore_mesh"] == {
        "data": 1, "model": world},
          f"phase 16c: restore on {c['restore_mesh']}: bit equal "
          f"{c['restore_bit_equal']}")
    log(f"phase 16c: phi3-mini-3.8b cut to depth {DIST_CUT[0]} (f32, TF32 "
        f"off, B {DIST_CUT[1]} x S {DIST_CUT[2]}) on (data, model) = "
        f"{tuple(c['saved_mesh'].values())}: sharded vs one card's "
        f"unsharded rel: gradients (worst leaf) {c['leaf']:.3e}, two "
        f"train steps' metrics {c['errs']}, after them the worst moment "
        f"{c['moments']:.3e} and parameter {c['params']:.3e} (not held: "
        f"AdamW's eps 1e-8); with eps 1e-3, moment "
        f"{c['moments_eps']:.3e}, parameter {c['params_eps']:.3e}; saved "
        f"there and restored by "
        f"restore(shardings=) on {tuple(c['restore_mesh'].values())}: "
        f"parameters and moments bit for bit")
    t = r["16c"]
    import statistics
    step_s = statistics.median(t["times"][1:])
    tokens = t["batch"] * TRAIN_SEQ
    check(abs(t["losses"][0] - t["base_loss"]) <= DIST_TOL["loss"],
          f"phase 16c: first loss {t['losses'][0]} vs unsharded "
          f"{t['base_loss']}")
    check(all(math.isfinite(x) for x in t["losses"]),
          f"phase 16c: losses {t['losses']}")
    log(f"phase 16c: phi3-mini-3.8b as published, bf16, remat, qchunk, on "
        f"(data, model) = {tuple(t['mesh'].values())}: global B "
        f"{t['batch']} x S {TRAIN_SEQ}; losses {t['losses']} (first vs "
        f"unsharded {t['base_loss']!r}); step s {t['times']} (first = "
        f"warm-up with its collectives recorded); median "
        f"{step_s * 1e3:.3f} ms a step = {tokens / step_s:.1f} tokens/s; "
        f"peak device memory rank 0 {t['peak'] / 2**30:.3f} GiB; "
        f"collectives a step {t['collective_counts']}, bytes a device "
        f"{t['collectives']}")
    d = r["16d"]
    check(d["rel_err"] <= DIST_TOL["decode"],
          f"phase 16d: sharded decode logits rel {d['rel_err']}")
    log(f"phase 16d: granite-3-8b as published on (data, model) = "
        f"{tuple(d['mesh'].values())}, K cache placements "
        f"{d['k_placements']}: {DIST_DECODE[0]} x {DIST_DECODE[1]} "
        f"prefill + {DIST_DECODE[2]} decode steps, logits within rel "
        f"{d['rel_err']:.3e} of one card unsharded; decode "
        f"{statistics.median(d['step_s']) * 1e3:.3f} ms a step sharded "
        f"(steps {d['step_s']}), "
        f"{statistics.median(d['unsharded_step_s']) * 1e3:.3f} ms "
        f"unsharded")
    card = gpu_name_and_limit()
    f = r["16f_check"]
    log(f"phase 16f: Jamba-1.5-Large cut to depth 4 (Mamba, Mamba+MoE, "
        f"Mamba, attention+MoE; 45.0 GB of bf16 weights), 16 experts at "
        f"published widths, on (data, model) = {tuple(f['mesh'].values())}, "
        f"{DIST_MOE[0]} x {DIST_MOE[1]} prefill + {DIST_MOE[2]} decode "
        f"steps on the plain paths, placed with the routes card 0 recorded "
        f"unplaced: kept masks and positions of all {f['moe_layers']} x "
        f"{f['calls']} MoE calls equal {f['routes_equal']} "
        f"({f['dropped']} pairs dropped), aux within {f['aux']:.3e}, "
        f"logits rel prefill {f['prefill_logits']:.3e} decode "
        f"{f['decode_logits']:.3e}; unplaced {f['unplaced_s']:.1f} s, "
        f"placed {f['placed_s']:.1f} s, placed peak "
        f"{f['peak'] / 2**30:.3f} GiB rank 0 [{card}]")
    log(f"phase 16f: aux (unplaced, placed) by layer and call: "
        f"{f['aux_pairs']}")
    log(f"phase 16f: aux by MoE layer (largest |placed - unplaced| over "
        f"the calls, at aux): "
        + "; ".join(f"MoE layer {i}: {d:.3e} at {a:.4f}"
                    for i, (d, a) in enumerate(f["aux_by_layer"])))
    for i, errs in enumerate(f["op_errs"]):
        log(f"phase 16f: {'prefill' if i == 0 else f'decode call {i}'}: "
            f"each layer's output rel err placed vs unplaced: "
            + ", ".join(f"{lab} {e:.3e}"
                        for lab, e in zip(f["op_labels"], errs)))
    for i, errs in enumerate(f.get("mamba_products", [])):
        log(f"phase 16f: {'prefill' if i == 0 else f'decode call {i}'}: "
            f"the first Mamba mixer's products rel err placed vs unplaced: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    for i, split in enumerate(f.get("mamba_split", [])):
        log(f"phase 16f: {'prefill' if i == 0 else 'decode call 1'}: the "
            f"first Mamba mixer's matmuls at (data, model) = (2, 2)'s shards "
            f"on card 0 vs unplaced (share of elements that differ, rel "
            f"err): " + ", ".join(f"{k} {d:.3e} {e:.3e}"
                                  for k, (d, e) in split.items()))
    if world == 4:
        g = r["16f"]
        log(f"phase 16f: Jamba-1.5-Large's full period (8 layers, 4 MoE "
            f"layers of 16 experts, {g['params']} parameters as placed, "
            f"89.4 GB of bf16 weights) on (data, model) = "
            f"{tuple(g['mesh'].values())}, built layer by layer in "
            f"{g['build_s']:.1f} s: prefill {DIST_MOE[0]} x {DIST_MOE[1]} "
            f"{g['prefill_s'] * 1e3:.1f} ms = {g['prefill_tok_s']:.1f} "
            f"tokens/s (first run {g['first_prefill_s'] * 1e3:.1f} ms); "
            f"decode {g['decode_ms']:.3f} ms a step (steps "
            f"{g['decode_s']}) [{card}]")
        log(f"phase 16f: memory a card (rank 0): weights "
            f"{g['weights_bytes'] / 2**30:.3f} GiB, peak "
            f"{g['peak'] / 2**30:.3f} GiB; collectives a decode step "
            f"{g['collective_counts']}, bytes a device {g['collectives']} "
            f"[{card}]")
        log(f"phase 16f: each MoE layer's placed prefill output vs "
            f"moe_forward on card 0 (same gathered input, routes replayed, "
            f"weights gathered one layer at a time): kept masks and "
            f"positions equal {g['layer_equal']}, rel "
            f"{[f'{e:.3e}' for e in g['layer_errs']]} (bar "
            f"{DIST_TOL['moe_out']}), aux within "
            f"{[f'{e:.3e}' for e in g['layer_aux']]} (bar "
            f"{DIST_TOL['aux']})")
    else:
        log("phase 16f: the full period (89.4 GB) needs four cards; "
            f"{world} here")
    for rank, rr in enumerate(res):
        check(all(v == 0 for v in rr["counts"].values()),
              f"phase 16e: rank {rank} launched {rr['counts']}")
    log(f"phase 16e: every rank's 16c, 16d and 16f launched no kernel "
        f"({res[0]['counts']}); a kernel given a DTensor raised: "
        f"{r['16e']}")
    if world == 4:
        check(all(g["layer_equal"]) and len(g["layer_equal"]) == 4
              and worst(g["layer_errs"]) <= DIST_TOL["moe_out"]
              and worst(g["layer_aux"]) <= DIST_TOL["aux"] and g["finite"],
              f"phase 16f: period placed vs moe_forward on card 0: kept and "
              f"positions equal {g['layer_equal']}, outputs rel "
              f"{g['layer_errs']}, aux {g['layer_aux']}, finite "
              f"{g['finite']}")
    check(f["routes_equal"] and f["aux"] <= DIST_TOL["aux"]
          and f["prefill_logits"] <= DIST_TOL["decode"]
          and f["decode_logits"] <= DIST_TOL["decode"] and f["finite"],
          f"phase 16f: depth 4 placed vs card 0 unplaced: kept masks and "
          f"positions equal {f['routes_equal']}, aux {f['aux']}, logits "
          f"rel prefill {f['prefill_logits']} decode "
          f"{f['decode_logits']}, finite {f['finite']}")


def gpu_name_and_limit() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK
    from repro_torch.configs.deepseek_v2_236b import (
        ONE_CHIP as DEEPSEEK_ONE_CHIP)
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.jamba15_large_398b import ONE_CHIP
    from repro_torch.configs.llama32_vision_11b import CONFIG as VISION
    from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS
    from repro_torch.configs.xlstm_125m import CONFIG as XLSTM
    from repro_torch.configs.llama4_scout_17b_a16e import (
        ONE_CHIP as LLAMA4_ONE_CHIP)
    from repro_torch.core import allocator, engine, headline, workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.page_clock import ops as pc_ops
    from repro_torch.kernels.page_clock import ref as pc_ref
    from repro_torch.kernels.slstm_scan import ops as slops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.kernels.zns_alloc import ops, ref
    from repro_torch.configs import get_arch
    from repro_torch.configs.phi3_mini_38b import CONFIG as PHI3
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as MDL
    from repro_torch.train import data as TD
    from repro_torch.train import optimizer as OPT
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TT

    t_start = time.perf_counter()
    lap = Laps()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")

    # 1. build: one nvcc per source, all started together, and ptxas -v
    # of every source beside them
    def timed_build(source):
        t0 = time.perf_counter()
        return _build.build(source), time.perf_counter() - t0
    sources = {"zns_alloc": ops.SOURCE, "flash_attention": fops.SOURCE,
               "decode_attention": dops.SOURCE, "ssm_scan": sops.SOURCE,
               "page_clock": pc_ops.SOURCE, "mlstm_scan": mops.SOURCE,
               "mlstm_chunkwise": mops.CHUNKWISE_SOURCE,
               "slstm_scan": slops.SOURCE}
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        usage = pool.map(_build.resource_usage, sources.values())
        for lib, secs in pool.map(timed_build, sources.values()):
            log(f"phase 1: built {lib.name} in {secs:.2f} s")
        usage = dict(zip(sources, usage))
    for name, kernels_of in usage.items():
        for mangled, u in kernels_of.items():
            log(f"phase 1: ptxas {name} {mangled}: {u}")
    lap("phase 1")

    # 2. the kernels vs their plain versions
    gpu_eng = headline.build_headline_engine(device="cuda")
    cpu_eng = headline.build_headline_engine(device="cpu")
    fleet_progs, fleet_dyn = fleet_batch(headline, engine, gpu_eng)
    max_abs_err = phase_kernel(torch, np, ops, ref, engine, fleet_dyn,
                               gpu_eng.cfg)

    # 3. the main path
    bench = json.loads((ROOT / "BENCH_paper.json").read_text())
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    zns_counts = dict(ops.counts)
    launches = sum(zns_counts.values())
    check_report(rep, bench)
    log(f"phase 3: paper_report on cuda == BENCH_paper.json "
        f"(DLWA {rep['dlwa']['traditional_dlwa'][0]} -> "
        f"{rep['dlwa']['silent_dlwa'][0]}, erases "
        f"{rep['wear']['traditional_erases']} -> "
        f"{rep['wear']['silent_erases']}, exec "
        f"{rep['exec']['traditional_s']} s -> {rep['exec']['silent_s']} s)")
    check(sum(rep["launches"]["zns_alloc_per_pass"]) == launches,
          "paper_report's per-pass launch counts disagree with the "
          "wrapper's counter")
    # 3b. the Pallas contract (core/allocator.allocate) on the card: the
    # row selection kernel
    ops.reset_launches()
    sel, feasible = allocator.allocate(
        np.arange(4 * 1056, dtype=np.int32).reshape(4, 1056) % 97,
        np.zeros((4, 1056), np.int32), np.ones(4, bool), 22,
        device="cuda")
    contract_counts = dict(ops.counts)
    check(bool(feasible) and sel.sum() == 4 * 22
          and contract_counts["rows"] == 1,
          f"allocator.allocate on cuda: feasible {feasible}, "
          f"{sel.sum()} picks, launches {contract_counts}")
    log(f"phase 3b: allocator.allocate (the Pallas contract) on cuda: "
        f"{int(sel.sum())} picks, launches {contract_counts}")

    # 4. the same dispatches and the fleet batch, cuda vs cpu
    batches = headline_batches(headline, workloads, gpu_eng)
    for name, programs, dyn in batches:
        assert_same_run(torch, name, gpu_eng.run_batch(
            gpu_eng.init_state(), programs, dyn), cpu_eng.run_batch(
            cpu_eng.init_state(), programs, dyn))
    gpu_eng.run_batch(gpu_eng.init_state(), fleet_progs, fleet_dyn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu_fleet = gpu_eng.run_batch(gpu_eng.init_state(), fleet_progs,
                                  fleet_dyn)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_fleet = cpu_eng.run_batch(cpu_eng.init_state(), fleet_progs,
                                  fleet_dyn)
    cpu_fleet_s = time.perf_counter() - t0
    assert_same_run(torch, "fleet", gpu_fleet, cpu_fleet)
    n_ok = int(gpu_fleet[1].ok.sum())
    n_ops = fleet_progs.shape[0] * fleet_progs.shape[1]
    log(f"phase 4: headline dispatches and the {FLEET_LANES}-lane fleet "
        f"({fleet_progs.shape[1]} ops/lane, {n_ok}/{n_ops} ok) "
        f"bit-identical on cuda and cpu")

    # 5. the main path went through the kernels: one ALLOC and one grow
    # selection per op step of each dispatch, both passes
    steps = 2 * sum(programs.shape[1] for _, programs, _ in batches)
    check(zns_counts == {"alloc_select": steps, "grow_select": steps,
                         "rows": 0} and launches == 2 * steps,
          f"paper_report launched {zns_counts}, want {steps} each of "
          f"alloc_select and grow_select over {steps} op steps")
    log(f"phase 5: zns_alloc launches in paper_report: {launches} "
        f"({rep['launches']['zns_alloc_per_pass']} per pass; "
        f"{zns_counts}) "
        f"over {steps} op steps: 2 per op step, as expected")

    # 6. timing
    empty = empty_timing(torch, ops)
    log(f"phase 6: empty kernel through the same ctypes route (the "
        f"practical floor of a small kernel here): {empty['ms']:.6f} ms "
        f"a call back to back, {empty['device_us']} us device time a "
        f"launch")
    fused = {name: fused_timing(torch, np, ops, ref, engine, gpu_eng, d,
                                seed=len(name))
             for name, _, d in batches[1:2]}
    fused["fleet"] = fused_timing(torch, np, ops, ref, engine, gpu_eng,
                                  fleet_dyn, seed=7)
    for where, entry in fused.items():
        for kname, t in entry.items():
            log(f"phase 6: zns_alloc {kname} at zn540, {t['lanes']} lanes "
                f"({where}'s lane table, {t['rows']} row selections): "
                f"kernel {t['ms']:.6f} ms a call, device {t['device_us']} "
                f"us a launch (empty kernel {empty['ms']:.6f} ms, "
                f"{empty['device_us']} us), plain {t['plain_ms']:.6f} ms, "
                f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
                f"{t['bytes']} bytes, {t['ops']} operations)")
    timings = [kernel_timing(torch, np, ops, ref, *shape) for shape in (
        (2, 4, 1056, 22), (12, 4, 1056, 22), (FLEET_LANES, 4, 1056, 22))]
    for t in timings:
        log(f"phase 6: zns_alloc rows {t['shape']} take {t['take']}: "
            f"kernel {t['ms']:.6f} ms a call, device {t['device_us']} us "
            f"a launch, plain {t['plain_ms']:.6f} ms, torch.topk "
            f"{t['library_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    report2_s = time.perf_counter() - t0
    log(f"phase 6: paper_report (2 passes of 3 dispatches) on cuda: "
        f"{report_s:.3f} s first call, {report2_s:.3f} s second call")
    log(f"phase 6: {FLEET_LANES}-lane fleet dispatch: {fleet_s:.3f} s on "
        f"cuda = {n_ops / fleet_s:.1f} lane-ops/s "
        f"(cpu twin {cpu_fleet_s:.3f} s)")
    lap("phases 2-6")
    # the profiled dispatches of phases 6, 11 and 13, run after phase
    # 10g (see profile_dispatches)
    deferred = []

    def profiled_wear(batch=batches[1]):
        # a PROFILED_STEPS prefix (the whole 192 until the script neared
        # 1,100 s; the rates are per op step)
        name, programs, dyn = batch
        programs = programs[:, :PROFILED_STEPS]
        prof = profile_dispatch(torch, gpu_eng, programs, dyn)
        check(prof["device_events"] > 0,
              f"phase 6: the profiled {name} dispatch holds no device event")
        log(f"phase 6: profiled {name} dispatch ({programs.shape[0]} x "
            f"{programs.shape[1]}-op-step prefix): wall {prof['wall_us']:.1f} us, "
            f"device busy {prof['busy_us']:.1f} us "
            f"({prof['busy_us'] / prof['wall_us']:.4f} of wall) over "
            f"{prof['device_events']} device events = "
            f"{prof['device_events'] / programs.shape[1]:.1f} per op step; "
            f"alloc_select (launches, us each) "
            f"{prof['alloc_select_kernel']}, grow_select "
            f"{prof['grow_select_kernel']}")
    deferred.append(profiled_wear)

    # 11. the key-value storage path: six zn540 lanes of recorded
    # application traffic as one dispatch, held to the reference's
    # golden summary; 12. the device shim on the card vs the CPU
    import repro_torch.storage as S
    golden = json.loads((ROOT / "tests" / "data" /
                         "torch_kv_zn540.json").read_text())
    kv = phase_kv(torch, np, S, headline, ops, golden, deferred)
    kv_t = fused_timing(torch, np, ops, ref, engine, kv["eng"], kv["dyn"],
                        seed=11)
    for kname, t in kv_t.items():
        log(f"phase 11: zns_alloc {kname} at the KV batch ({t['lanes']} "
            f"lanes, {t['rows']} row selections): kernel {t['ms']:.6f} ms "
            f"a call, device {t['device_us']} us a launch, plain "
            f"{t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
    del kv["eng"]
    lap("phase 11")
    phase_shim(torch, np, S)
    lap("phase 12")

    # 13. the allocator design-space search at zn540, held to the
    # reference's golden summary
    fleet_golden = json.loads((ROOT / "tests" / "data" /
                               "torch_fleet_zn540.json").read_text())
    fleet = phase_fleet(torch, np, ops, ref, engine, fleet_golden,
                        deferred)
    lap("phase 13")

    # 17. the paper's figures at the paper's sizes, each held to the
    # reference's outputs (before phase 14, which reuses its Fig. 4b / 7d
    # and Fig. 9 engine rows)
    t0 = time.perf_counter()
    figs = phase_figures(
        torch, np, ops, ref, pc_ops, pc_ref,
        json.loads((ROOT / "tests" / "data" /
                    "torch_figures_paper.json").read_text()), FIGURE_CUTS,
        json.loads((ROOT / "tests" / "data" /
                    "torch_figures_cut.json").read_text()))
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    lap("phase 17")

    # 14. the paper's per-op benchmarks and the legacy oracles, held to
    # the reference's golden summary; page_clock vs its plain version
    t0 = time.perf_counter()
    work = phase_workloads(
        torch, np, ops, pc_ops, pc_ref,
        json.loads((ROOT / "tests" / "data" /
                    "torch_workloads_zn540.json").read_text()), kv,
        figs["got"])
    legacy_rows_t = kernel_timing(torch, np, ops, ref, 1, 4, 1056, 22)
    log(f"phase 14: zns_alloc rows at the legacy device's BLOCK shape "
        f"(1 x 4 x 1056, take 22): kernel {legacy_rows_t['ms']:.6f} ms a "
        f"call, device {legacy_rows_t['device_us']} us a launch, plain "
        f"{legacy_rows_t['plain_ms']:.6f} ms, torch.topk "
        f"{legacy_rows_t['library_ms']:.6f} ms, bound "
        f"{legacy_rows_t['bound_ms']:.6f} ms ({legacy_rows_t['bound_by']})")
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    lap("phase 14")

    # 18. the reference's CLIs and examples as port-side drivers, each
    # held to the reference's outputs at the golden file's sizes
    t0 = time.perf_counter()
    phase_clis(torch, ops, pc_ops, json.loads(
        (ROOT / "tests" / "data" / "torch_clis_zn540.json").read_text()),
        CLI_RUNS)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    lap("phase 18")
    del kv["recs"]

    # 7. the attention kernels vs their plain versions; 7b. the scan
    attn_err = phase_attention(torch, np, fops, fref, dops, dref)
    ssm_err = phase_ssm(torch, np, sops, sref)
    lap("phases 7, 7b")

    # 8. the serving path, granite-3-8b, through both attention kernels
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": fops, "decode_attention": dops,
               "ssm_scan": sops, "mlstm_scan": mops, "slstm_scan": slops}
    run = phase_serve(torch, serve, kernels)

    # 9. the plain attention path, teacher-forced, against it
    phase_serve_ref(torch, serve, run, "9")

    # 10. timing
    granite_t = log_serve_timing(torch, F, serve, MDL, run, "10", fops,
                                 fref, dops, dref, usage, b=8, s=512,
                                 hq=32, hkv=8, d=128, n_caches=40, seq=544)
    granite = (run["cfg"].name, run["counts"], granite_t)
    del run                         # granite's weights and caches
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 8-10")

    # 8b. the Mamba path: the one-card Jamba cut through all three
    # serving kernels
    run = phase_jamba(torch, serve, ONE_CHIP, kernels)

    # 9b. the plain attention and scan, teacher-forced, against it
    phase_serve_ref(torch, serve, run, "9b")

    # 10b. timing
    ssm_t = ssm_timing(torch, sops, sref)
    log(f"phase 10b: ssm_scan at the slice's shape (8 x 2048 x 16384, N "
        f"16, bf16): kernel {ssm_t['ms']:.6f} ms (device "
        f"{ssm_t['device_us']} us a launch; "
        f"{ssm_t['bound_ms'] / ssm_t['ms']:.4f} of its bound), plain "
        f"{ssm_t['plain_ms']:.6f} ms, no library call; bound "
        f"{ssm_t['bound_ms']:.6f} ms ({ssm_t['bound_by']}: {ssm_t['exps']} "
        f"exponentials and {ssm_t['instr']} other f32 instructions, "
        f"{ssm_t['poly_share']:.4f} of the exponentials as "
        f"{EXP_POLY_INSTRUCTIONS}-instruction polynomials, at "
        f"{SFU_EX2_PER_SM_PER_CLOCK} ex2 and {LANES_PER_SM_PER_CLOCK} issued "
        f"lanes per SM per clock, {SMS} SMs at {SM_CLOCK_HZ / 1e9:.4f} GHz = "
        f"{ssm_t['ops_ms']:.6f} ms; all exponentials on the SFU "
        f"{ssm_t['sfu_only_ms']:.6f} ms; {ssm_t['bytes']} bytes = "
        f"{ssm_t['bytes_ms']:.6f} ms)")
    attn_t = log_serve_timing(torch, F, serve, MDL, run, "10b", fops, fref,
                              dops, dref, usage, b=JAMBA_BATCH,
                              s=JAMBA_PROMPT,
                              hq=ONE_CHIP.n_heads,
                              hkv=ONE_CHIP.n_kv_heads, d=128, n_caches=4,
                              seq=JAMBA_PROMPT + JAMBA_TOKENS)
    jamba = (f"{ONE_CHIP.name} one-card cut", run["counts"],
             dict(attn_t, ssm_scan=ssm_t))
    del run                         # the Jamba cut's weights and caches
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 8b-10b")

    # 7c. deepseek-v2's routed layer at its published size
    phase_moe_layer(torch, MOE, TT.moe_dims(DEEPSEEK))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7c")

    # 8c. the MoE path: the one-card llama4-scout cut through both
    # attention kernels
    others = {"zns_alloc": ops, "page_clock": pc_ops}
    run = phase_moe_serve(torch, serve, TT, MOE, LLAMA4_ONE_CHIP, kernels,
                          others, phase="8c", want_params=LLAMA4_PARAMS,
                          batch=LLAMA4_BATCH, prompt=LLAMA4_PROMPT,
                          tokens=LLAMA4_TOKENS)

    # 9c. the plain attention under replayed routes, against it; then
    # the plain path routing on its own
    phase_moe_serve_ref(torch, serve, TT, run, "9c", "8c")

    # 10c. timing: one MoE layer at prefill and decode size, the
    # attention kernels at G 5, a second serve run, a profiled step
    log_moe_layer_timing(torch, MOE, moe_layers(TT, run["model"])[0],
                         LLAMA4_ONE_CHIP, "10c",
                         (LLAMA4_BATCH * LLAMA4_PROMPT, LLAMA4_BATCH))
    llama4_t = log_serve_timing(
        torch, F, serve, MDL, run, "10c", fops, fref, dops, dref, usage,
        b=LLAMA4_BATCH, s=LLAMA4_PROMPT, hq=LLAMA4_ONE_CHIP.n_heads,
        hkv=LLAMA4_ONE_CHIP.n_kv_heads, d=128,
        n_caches=LLAMA4_ONE_CHIP.n_layers,
        seq=LLAMA4_PROMPT + LLAMA4_TOKENS)
    llama4 = (f"{LLAMA4_ONE_CHIP.name} one-card cut", run["counts"],
              llama4_t)
    del run                         # the llama4 cut's weights and caches
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 8c-10c")

    # 7d. the flash kernel above head dim 128 vs its plain version
    mla_err = phase_flash_mla(torch, np, fops, fref)

    # 8d. multi-head latent attention: the one-card deepseek-v2 cut, its
    # prefill through the flash kernel at head dim 192
    run = phase_moe_serve(torch, serve, TT, MOE, DEEPSEEK_ONE_CHIP, kernels,
                          others, phase="8d", want_params=DEEPSEEK_PARAMS,
                          batch=DEEPSEEK_BATCH, prompt=DEEPSEEK_PROMPT,
                          tokens=DEEPSEEK_TOKENS)

    # 9d. the plain attention under replayed routes, against it; then
    # the plain path routing on its own
    phase_moe_serve_ref(torch, serve, TT, run, "9d", "8d")

    # 10d. timing: one MLA decode layer, one MoE layer at prefill and
    # decode size, flash at D 192, a second serve run, a profiled step
    cfg = DEEPSEEK_ONE_CHIP
    t = mla_decode_timing(torch, MLA, run["model"].blocks[1], run["caches"],
                          TT.cache_slots(cfg)[1][1], run)
    pr = t["prof"]
    log(f"phase 10d: one {cfg.name} MLA decode layer (absorbed, B "
        f"{DEEPSEEK_BATCH}, {DEEPSEEK_PROMPT + DEEPSEEK_TOKENS} cache "
        f"rows): {t['ms']:.6f} ms ({t['bound_ms'] / t['ms']:.4f} of its "
        f"bound), bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
        f"{t['bytes']} bytes, {t['flops']} flop); profiled call: "
        f"{pr['device_events']} device events, busy {pr['busy_us']:.1f} us "
        f"of {pr['wall_us']:.1f} us wall")
    log_moe_layer_timing(torch, MOE, moe_layers(TT, run["model"])[0], cfg,
                         "10d", (DEEPSEEK_BATCH * DEEPSEEK_PROMPT,
                                 DEEPSEEK_BATCH))
    deepseek_t = log_serve_timing(
        torch, F, serve, MDL, run, "10d", fops, fref, dops, dref, usage,
        b=DEEPSEEK_BATCH, s=DEEPSEEK_PROMPT, hq=cfg.n_heads,
        hkv=cfg.n_heads, d=cfg.nope_head_dim + cfg.rope_head_dim,
        n_caches=0, seq=0, v_dim=cfg.v_head_dim)
    deepseek = (f"{DEEPSEEK_ONE_CHIP.name} one-card cut", run["counts"],
                deepseek_t)
    del run                         # the deepseek-v2 cut's weights, caches
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 7d-10d")

    # 7e. both attention kernels at the cross-attention models' shapes
    cross_err = phase_cross_attention(torch, fops, fref, dops, dref)

    # 8e. cross-attention: llama-3.2-vision-11b as published, over a
    # memory of 1601 image patches
    run = phase_cross_serve(torch, serve, MDL, SHAPES, VISION, kernels,
                            others, phase="8e", want_params=VISION_PARAMS)

    # 9e. the plain attention, teacher-forced, against it (memory K/V
    # included)
    phase_serve_ref(torch, serve, run, "9e")

    # 10e. timing: flash and decode attention over the memory, a second
    # serve run, a profiled step
    vision_t = log_serve_timing(
        torch, F, serve, MDL, run, "10e", fops, fref, dops, dref, usage,
        b=CROSS_BATCH, s=CROSS_PROMPT, sk=run["memory"].shape[1],
        causal=False, hq=VISION.n_heads, hkv=VISION.n_kv_heads,
        d=VISION.resolved_head_dim,
        n_caches=VISION.layer_kinds().count("cross"),
        seq=run["memory"].shape[1])
    vision = (VISION.name, run["counts"], vision_t)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 7e-10e")

    # 8f-10f. the encoder: seamless-m4t-medium as published, over 1024
    # speech frames
    run = phase_cross_serve(torch, serve, MDL, SHAPES, SEAMLESS, kernels,
                            others, phase="8f", want_params=SEAMLESS_PARAMS)
    phase_serve_ref(torch, serve, run, "9f")
    m = run["memory"].shape[1]
    enc_t = attention_timing(
        torch, F, fops, fref, dops, dref, b=CROSS_BATCH, s=m, causal=False,
        hq=SEAMLESS.n_heads, hkv=SEAMLESS.n_kv_heads,
        d=SEAMLESS.resolved_head_dim, n_caches=0, seq=0)["flash_attention"]
    log(f"phase 10f: flash_attention at {SEAMLESS.name}'s encoder shape "
        f"({CROSS_BATCH} x {SEAMLESS.n_heads} heads, S = Sk = {m}, D "
        f"{SEAMLESS.resolved_head_dim}, not causal): kernel "
        f"{enc_t['ms']:.6f} ms ({enc_t['bound_ms'] / enc_t['ms']:.4f} of "
        f"its bound; device {enc_t['device_us']} us per launch), plain "
        f"{enc_t['plain_ms']:.6f} ms, scaled_dot_product_attention "
        f"{enc_t['library_ms']:.6f} ms, bound {enc_t['bound_ms']:.6f} ms "
        f"({enc_t['bound_by']}: {enc_t['bytes']} bytes, {enc_t['flops']} "
        f"flop)")
    seamless_t = log_serve_timing(
        torch, F, serve, MDL, run, "10f", fops, fref, dops, dref, usage,
        b=CROSS_BATCH, s=CROSS_PROMPT, sk=m, causal=False,
        hq=SEAMLESS.n_heads, hkv=SEAMLESS.n_kv_heads,
        d=SEAMLESS.resolved_head_dim,
        n_caches=SEAMLESS.layer_kinds().count("cross"), seq=m)
    seamless = (SEAMLESS.name, run["counts"], seamless_t)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 8f-10f")

    # 7f. the xLSTM scans vs their plain versions
    t0 = time.perf_counter()
    xlstm_err = phase_xlstm_scans(torch, np, mops, slops)
    log(f"phase 7f took {time.perf_counter() - t0:.1f} s")
    lap("phase 7f")

    # 8g. xlstm-125m as published through both scans
    t0 = time.perf_counter()
    run = phase_xlstm_serve(torch, serve, XLSTM, kernels, others)

    # 9g. the stepped plain recurrences, teacher-forced, against it; the
    # prefill again with the mLSTM on its recurrent kernel, and with the
    # sLSTM on its L2 kernel
    ref = phase_serve_ref(torch, serve, run, "9g")
    mlstm_logits = mlstm_design_logits(torch, MDL, TT, run, mops,
                                       ref["prefill_logits"])
    slstm_design_logits(torch, MDL, TT, run, slops, ref["prefill_logits"])
    # and all three against the f32 reference
    mlstm_logits["f32_reference"] = f32_reference_logits(
        torch, MDL, TT, run, run["logits"][0], mlstm_logits.pop("_logits"),
        ref["prefill_logits"])
    del ref

    # 10g. the scans at the served shape, a second serve run, profiled
    # prefill and decode
    xlstm_t = xlstm_timing(torch, mops, slops, usage)
    prefill_us = log_xlstm_serve_timing(torch, serve, MDL, TT, run, mops,
                                        slops)
    for name, t in xlstm_t.items():
        t["prefill_device_us"] = prefill_us[name]
    xlstm_t["mlstm_scan"]["serve_logits_err"] = mlstm_logits
    xlstm = (XLSTM.name, run["counts"], xlstm_t)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 8g-10g took {time.perf_counter() - t0:.1f} s")
    lap("phases 8g-10g")

    # the profiled dispatches of phases 6, 11 and 13, after every
    # device_us window
    profile_dispatches(ops, deferred)
    del deferred
    gc.collect()
    torch.cuda.empty_cache()
    lap("profiled dispatches of phases 6-13")

    # 15. training: the card against the CPU at full width (15a), then
    # phi3-mini-3.8b (15b) and xlstm-125m (15c) as published; no kernel
    # in a train step, none silently under autograd (15d)
    t0 = time.perf_counter()
    phase_train_vs_cpu(torch, TT, MDL, OPT, TD, get_arch, kernels, others)
    lap("phase 15a")
    phi3_run = phase_train_phi3(torch, serve, MDL, OPT, TD, PHI3, kernels,
                                others)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15b")
    phase_train_xlstm(torch, launch_train, MDL, kernels, others)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 15c")
    phase_autograd_guard(torch, fops)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. the distributed paths: one process a card over NCCL; with one
    # card, 16c's first batch is 15b's, and so is its unsharded loss
    t0 = time.perf_counter()
    one = torch.cuda.device_count() == 1 and phi3_run["batch"] == TRAIN_BATCH
    phase_distributed(torch, phi3_run["losses"][0] if one else None)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    lap("phases 15d-16")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    main_t = timings[0]
    errs = dict(attn_err, ssm_scan=ssm_err)
    mla_errs = dict(errs, flash_attention=mla_err)
    cross_errs = dict(errs, **cross_err)
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:36",
        "decode_attention":
            "src/repro/kernels/decode_attention/decode_attention.py:30",
        "ssm_scan": "src/repro/kernels/ssm_scan/ssm_scan.py:36",
        "mlstm_scan": "src/repro/models/xlstm.py:95 (mlstm_forward's "
                      "lax.scan through layers.chunked_remat_scan; no "
                      "Pallas counterpart): two designs, the chunkwise "
                      "kernel (mlstm_chunkwise.cu, bf16, the served "
                      "path) and the recurrent one (mlstm_scan.cu, f32 "
                      "and the other shapes)",
        "slstm_scan": "src/repro/models/xlstm.py:188 (slstm_forward's "
                      "lax.scan through layers.chunked_remat_scan; no "
                      "Pallas counterpart)"}
    # one entry per kernel and serving path, each with that path's
    # launches and the times at that path's shapes
    paths = [granite + (errs,), jamba + (errs,), llama4 + (errs,),
             deepseek + (mla_errs,), vision + (cross_errs,),
             seamless + (cross_errs,), xlstm + (xlstm_err,)]
    serve_entries = [{
        "name": name,
        "path": path,
        "route": "cuda",
        "source": timed[name].get("designs", {}).get(
            "chunkwise", {}).get(
                "source", f"src/repro_torch/kernels/{name}/csrc/{name}.cu"),
        "replaces": replaces[name],
        "launches": counts[name],
        "max_abs_err": path_errs[name],
        "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": timed[name]["library_ms"],
        **({"device_us": timed[name]["device_us"]}
           if "device_us" in timed[name] else {}),
        **{k: timed[name][k] for k in ("designs", "floor_ms",
                                        "floor_us_per_step",
                                        "prefill_device_us",
                                        "serve_logits_err")
           if k in timed[name]},
    } for path, counts, timed, path_errs in paths for name in timed]
    for e in serve_entries:         # each xLSTM scan's error by design
        if "designs" in e:
            by = xlstm_err[e["name"].replace("_scan", "_by_design")]
            for k, v in by.items():
                e["designs"][k]["max_abs_err"] = v
            if e["name"] == "mlstm_scan":
                e["designs"]["chunkwise"]["max_flips"] = xlstm_err[
                    "mlstm_chunkwise_flips"]
    log(gpu_name_and_limit())
    zns = "src/repro_torch/kernels/zns_alloc/csrc/zns_alloc.cu"
    zns_entries = [{
        "name": f"zns_alloc/{kname}",
        "path": "paper_report",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": zns_counts[kname],
        "max_abs_err": max([max_abs_err] + [f[kname]["max_abs_err"]
                                            for f in fused.values()]),
        "ms": fused["wear"][kname]["ms"],
        "plain_ms": fused["wear"][kname]["plain_ms"],
        "bound_ms": fused["wear"][kname]["bound_ms"],
        "bound_by": fused["wear"][kname]["bound_by"],
        "library_ms": None,
    } for kname in ("alloc_select", "grow_select")]
    zns_entries += [{
        "name": f"zns_alloc/{kname}",
        "path": "kv_zn540",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": kv["counts"][kname],
        "max_abs_err": max(max_abs_err, kv_t[kname]["max_abs_err"]),
        "ms": kv_t[kname]["ms"],
        "device_us": kv["prof"][f"{kname}_kernel"][1],
        "plain_ms": kv_t[kname]["plain_ms"],
        "bound_ms": kv_t[kname]["bound_ms"],
        "bound_by": kv_t[kname]["bound_by"],
        "library_ms": None,
    } for kname in ("alloc_select", "grow_select")]
    zns_entries += [{
        "name": f"zns_alloc/{kname}",
        "path": "fleet_sweep_zn540",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": fleet["counts"][kname],
        "max_abs_err": fleet["max_abs_err"],
        "ms": fleet["timed"][kname]["ms"],
        "device_us": fleet["prof"][f"{kname}_kernel"][1],
        "plain_ms": fleet["timed"][kname]["plain_ms"],
        "bound_ms": fleet["timed"][kname]["bound_ms"],
        "bound_by": fleet["timed"][kname]["bound_by"],
        "library_ms": None,
    } for kname in ("alloc_select", "grow_select")]
    zns_entries.append({
        "name": "zns_alloc/rows",
        "path": "allocator.allocate (the Pallas contract)",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": contract_counts["rows"],
        "max_abs_err": max_abs_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
    })
    zns_entries.append({
        "name": "zns_alloc/rows",
        "path": "LegacyZNSDevice ALLOCs of phase 14",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": work["rows_launches"],
        "max_abs_err": max_abs_err,
        "ms": legacy_rows_t["ms"],
        "device_us": legacy_rows_t["device_us"],
        "plain_ms": legacy_rows_t["plain_ms"],
        "bound_ms": legacy_rows_t["bound_ms"],
        "bound_by": legacy_rows_t["bound_by"],
        "library_ms": legacy_rows_t["library_ms"],
    })
    pc = work["page_clock"]
    pc_entry = {
        "name": "page_clock",
        "path": "per-op benchmarks and legacy comparators (phase 14)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/page_clock/csrc/page_clock.cu",
        "replaces": "src/repro/core/timing.py:82 (simulate_fleet, a "
                    "lax.scan; no Pallas counterpart)",
        "launches": work["page_clock_launches"],
        "max_abs_err": pc["max_abs_err"],
        "ms": pc["ms"],
        "device_us": pc["device_us"],
        "requests": pc["requests"],
        "prefix_ms": pc["prefix_ms"],
        "plain_ms": pc["plain_ms"],
        "plain_requests": pc["prefix"],
        "bound_ms": pc["bound_ms"],
        "bound_by": pc["bound_by"],
        "library_ms": None,
        "rows": work["page_clock_rows"],
        "designs": {"chains": {"ms": pc["ms"]},
                    "whole": {"ms": pc["whole_ms"],
                              "requests": pc["requests"]}},
        "chain_ns": pc["chain_ns"],
        "chain_floor_ms": pc["chain_floor_ms"],
    }
    zns_entries += [{
        "name": f"zns_alloc/{kname}",
        "path": "the paper's figures (phase 17)",
        "route": "cuda",
        "source": zns,
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": figs["launches"][kname],
        "max_abs_err": max(max_abs_err, figs["fused"][kname]["max_abs_err"],
                           figs["shapes_err"]),
        "ms": figs["fused"][kname]["ms"],
        "device_us": figs["fused"][kname]["device_us"],
        "plain_ms": figs["fused"][kname]["plain_ms"],
        "bound_ms": figs["fused"][kname]["bound_ms"],
        "bound_by": figs["fused"][kname]["bound_by"],
        "library_ms": None,
    } for kname in ("alloc_select", "grow_select")]
    fpc = figs["page_clock"]
    figs_pc_entry = {
        "name": "page_clock",
        "path": "the paper's figures (phase 17)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/page_clock/csrc/page_clock.cu",
        "replaces": pc_entry["replaces"],
        "launches": figs["launches"]["page_clock"],
        "max_abs_err": fpc["max_abs_err"],
        "ms": fpc["ms"],
        "device_us": fpc["device_us"],
        "requests": fpc["requests"],
        "plain_ms": fpc["plain_ms"],
        "plain_requests": fpc["plain_requests"],
        "bound_ms": fpc["bound_ms"],
        "bound_by": fpc["bound_by"],
        "library_ms": None,
    }
    entries = zns_entries + serve_entries + [pc_entry, figs_pc_entry]
    for e in entries + [d for e in entries
                        for d in e.get("designs", {}).values()]:
        if e.get("device_us") is not None:
            e["device_us_method"] = device_us_method(e["device_us"])
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


def phase16_alone() -> int:
    """``--phase16``: phase 16 alone, on every visible card (world
    ``min(4, cards)``), for measuring the distributed paths on four."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"{gpu_name_and_limit()} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_distributed(torch, None, products=True)
    log(f"phase 16 alone: {time.perf_counter() - t0:.1f} s")
    return 0


def phase17_alone() -> int:
    """``--phase17``: phase 17 alone on one card, its two kernels built
    first (one ``nvcc`` each, started together)."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.page_clock import ops as pc_ops
    from repro_torch.kernels.page_clock import ref as pc_ref
    from repro_torch.kernels.zns_alloc import ops, ref
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"{gpu_name_and_limit()}")
    with ThreadPoolExecutor(2) as pool:
        for lib in pool.map(_build.build, (ops.SOURCE, pc_ops.SOURCE)):
            log(f"phase 17 alone: built {lib.name}")
    t0 = time.perf_counter()
    phase_figures(torch, np, ops, ref, pc_ops, pc_ref, json.loads(
        (ROOT / "tests" / "data" / "torch_figures_paper.json").read_text()))
    log(f"phase 17 alone: {time.perf_counter() - t0:.1f} s")
    return 0


def phase18_alone() -> int:
    """``--phase18``: phase 18 alone on one card at the drivers' default
    sizes (:data:`CLI_DEFAULT_RUNS`), timed, each held to the golden file
    where it holds that command line; ``zns_alloc`` and ``page_clock``
    built first (one ``nvcc`` each, started together)."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.page_clock import ops as pc_ops
    from repro_torch.kernels.zns_alloc import ops
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"{gpu_name_and_limit()}")
    with ThreadPoolExecutor(2) as pool:
        for lib in pool.map(_build.build, (ops.SOURCE, pc_ops.SOURCE)):
            log(f"phase 18 alone: built {lib.name}")
    t0 = time.perf_counter()
    phase_clis(torch, ops, pc_ops, json.loads(
        (ROOT / "tests" / "data" / "torch_clis_zn540.json").read_text()),
        CLI_DEFAULT_RUNS)
    log(f"phase 18 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    alone = {"--phase16": phase16_alone, "--phase17": phase17_alone,
             "--phase18": phase18_alone}
    args = sys.argv[1:]
    sys.exit(alone[args[0]]() if len(args) == 1 and args[0] in alone
             else main())
