#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, run in this order (any failure raises and exits non-zero; nothing is
caught):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold the flash-attention kernel against its plain PyTorch version on the
   card (serving shape B=1, H=32, KV=8, hd=64, S=T=512 causal bf16; ragged
   S=T=300; the serving soak's longest and shortest prefills S=T=15 and 4;
   window 128; f32; the training shape B=4, S=T=1024 causal bf16;
   moonshot-v1-16b-a3b's serving shape, hd=128 MHA 16/16 heads, S=T=512 and
   ragged 300, and its training shape B=4, S=T=1024 causal bf16;
   internvl2-26b's, hd=128 GQA 48/8 heads, its prefills behind the 256
   patches S=T=768 and ragged 556, and its training shape B=4, S=T=1280;
   seamless-m4t-large-v2's, hd=64 MHA 16/16 heads not causal, S=T=512,
   ragged 300, S=300 T=512, f32 S=T=512, and its training shape B=4,
   S=T=1024) and time kernel, plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it);
3. the same for the RMSNorm kernel at (512, 2048), (300, 2048), (4, 2048),
   (512*32, 64), the training shape (4096, 2048), phases 18-19's
   (4096, 4096) and (4096*32, 64), and recurrentgemma-9b's serving shapes
   (2560, 4096) (the long prompt's prefill) and (4, 4096) (a decode step
   of 4 slots) bf16, and internvl2-26b's width 6144, past the rows the
   register kernel holds (the looped kernel): (768, 6144), (556, 6144),
   (4, 6144) and (5120, 6144), and seamless-m4t-large-v2's width 1024:
   (512, 1024), (300, 1024), (4, 1024) and (4096, 1024), and the serving
   soak's longest prefill (15, 2048), with
   ``F.rms_norm`` as the yardstick; each case
   prints the kernel's plan (registers, threads and blocks, one launch);
4. serve full-width llama3.2-1b (16 layers, d_model 2048, 32/8 heads,
   vocab 128256, tied; seeded random bf16 weights) through
   ``repro_torch.launch.serve.run_serving`` with both kernels selected:
   8 requests with prompts of 512 and 300 tokens, 16 new tokens each,
   4 slots.  The launch counters are set to 0 just before and read just
   after; they must equal 16 x prefills (flash) and 2 x 16 x (prefills +
   decode steps) (RMSNorm).  Each prompt's prefill logits, and one decode
   step, are held against the same model on the plain path
   (``attn_impl="chunked"``, ``norm_impl="ref"``) on the card;
5. profile a warm window of the same engine (4 more requests) with
   ``torch.profiler``: device busy share and the top kernels by device time;
6. hold the flash backward kernels (dq, and dk/dv summed over the GQA
   group), and the forward kernel that makes their inputs, against their
   plain versions at the training shape B=4,
   S=T=1024, H=32, KV=8, hd=64 causal bf16, ragged S=T=300, window 128 and
   f32, and at head_dim 256 (recurrentgemma-9b's MQA, 16/1 heads): phase
   19's path B=1 S=T=4096 window 2048 bf16, ragged S=T=300 window 128 bf16
   and S=T=512 window 2048 f32, and at head_dim 128 (moonshot-v1-16b-a3b's
   MHA, 16/16 heads): phase 21's path B=4 S=T=1024 causal bf16 and ragged
   S=T=300, and at head_dim 128 under GQA (internvl2-26b's 48/8 heads, the
   dkv kernel summing a group of 6 in each block): phase 23's path B=4
   S=T=1280 causal bf16 and ragged S=T=300, and at head_dim 64 not causal
   (seamless-m4t-large-v2's 16/16 heads): phase 25's path B=4 S=T=1024
   bf16, ragged S=T=300, S=300 T=512 and f32 S=T=512; time them beside
   the plain versions and the
   backward of ``F.scaled_dot_product_attention`` (a yardstick only).  Each
   dkv case prints its plan (the split of the GQA group across blocks, the
   grid and the launches a call) and must give the same bits on a second
   call;
7. the same for the RMSNorm backward kernel at (4096, 2048), (300, 2048),
   (16384, 64) bf16, (7, 100) f32 and phases 18-19's (4096, 4096) and
   (4096*32, 64) bf16, phase 23's (5120, 6144) bf16 and phase 25's
   (4096, 1024) bf16 with (512, 1024), (300, 1024) and (4, 1024), with
   ``F.rms_norm``'s backward as the yardstick;
8. train full-width llama3.2-1b (bf16, remat "dots") through
   ``repro_torch.launch.train.run_training`` with both kernel pairs
   selected: global batch 4, seq 1024, 6 AdamW steps on the copy task.  The
   five launch counters are set to 0 just before and read just after; per
   step they must equal 2L flash forwards (the block forward runs again in
   the backward), L dq, L dkv, 4L RMSNorm forwards and 2L RMSNorm backwards
   (L = 16; the final norm is the unfused one).  Every loss must be finite.
   One loss-and-gradient step on the kernel path is held against the plain
   path (``attn_impl="chunked"``, ``norm_impl="ref"``) on the card from the
   same weights and batch: loss, gradient norm and each leaf's relative
   error; every leaf's gradient must be finite and nonzero;
9. profile one warm training step with ``torch.profiler``;
10. hold the RG-LRU kernel against its plain version at recurrentgemma-9b's
    prefill shape (1, 2560, 4096) f32 with h0, and at (1, 512, 4096),
    ragged (1, 300, 4096), (4, 1024, 4096) and bf16: y and the final state;
    time kernel and plain version (no single PyTorch call computes a linear
    recurrence, so there is no library yardstick);
11. the same for the WKV-6 kernel at rwkv6-1.6b's prefill shape
    (1, 512, 32, 64) with bf16 r/k/v, f32 w and a state, ragged S=300,
    (4, 1024, 32, 64) and all-f32;
12. serve full-width recurrentgemma-9b (38 layers, d_model 4096, 16/1 heads,
    hd 256, vocab 256000, window 2048; seeded random bf16 weights) with
    ``attn_impl="pallas"``, ``norm_impl="fused"``, ``seq_impl="pallas"``:
    8 requests with prompts of 2560 and 512 tokens (the 2048-slot ring wraps
    on the long ones), 16 new tokens each, 4 slots.  The launch counters,
    set to 0 just before, must equal 13 x prefills (RG-LRU), 25 x prefills
    (flash) and 76 x (prefills + decode steps) (RMSNorm), and 0 for WKV-6;
    each prompt's prefill logits and one decode step are held against the
    plain path (``attn_impl="chunked"``, ``norm_impl="ref"``,
    ``seq_impl="parallel"``) on the card, in relative L2 norm (50%, against
    gross failure: 38 random bf16 layers amplify the paths' rounding
    differences; the plain path's spread under ``seq_impl="ref"`` is
    printed beside it);
13. profile a warm window of that engine; then hold the same architecture
    in f32, cut to 4 layers (one unit and its tail), kernel path against
    plain path at the f32 model tolerance 2e-4, prompts of 2560 and 512;
14. serve full-width rwkv6-1.6b (24 layers, d_model 2048, head size 64,
    vocab 65536) the same way, prompts of 512 and 300 tokens: WKV-6
    24 x prefills, RMSNorm 72 x (prefills + decode steps) (ln1, the group
    norm and ln2), RG-LRU and flash 0; held against the plain path;
15. profile a warm window of that engine; then the same architecture in f32
    at full depth, kernel path against plain path at 2e-4;
16. head_dim 16, the smoke configs' (``_smoke_phase``): serve the
    llama3.2-1b and recurrentgemma-9b smoke configs (bf16) through
    ``attn_impl="pallas"``, ``norm_impl="fused"``, ``seq_impl="pallas"``,
    4 requests of 128-token prompts each, with exact launch counts and the
    prefill logits held against the plain path at the repo's bf16 model
    tolerance; train the llama3.2-1b smoke config 3 steps (bf16, batch
    2 x 128) with exact flash forward/dq/dkv launch counts; one
    loss-and-gradient step against the plain path in bf16 (as phase 8) and
    one in f32 (each leaf to 1e-3);
17. checkpoint and resume full-width llama3.2-1b (``_ckpt_phase``), under
    the temporary directory or, when that has under 25 GB free, the
    checkout's ``build/`` (the free space of each is printed): the bf16
    params from the seed go through ``CheckpointManager(keep_n=1)``
    (``save``, ``wait``, ``restore_latest(device="cuda")``) and every leaf
    must come back ``torch.equal``, bf16 kept (bytes, blocking, write,
    validate and load seconds printed); then, cut to 4 of its 16 layers,
    phase 8's 6 steps run without a break, run A trains the first 3
    (``lr_total_steps=6``, ``ckpt_mode="fixed"``, ``ckpt_every`` above 3, a
    metrics textfile and a status file) and saves the 7.08 GB training
    state at shutdown (label 3), and run B (``steps=6``,
    ``ckpt_mode="off"``, ``restore=True``) restores it and trains steps
    4-6.  Each run's launch counts must equal the per-step counts at 4
    layers x its 3 steps; run B's resume summary must show one valid
    checkpoint and none quarantined, and it writes nothing; both runs'
    losses are held against the unbroken run's at the same steps at
    TRAIN_RTOL (the largest difference and whether they are bitwise equal
    are printed); the
    textfile must parse under ``repro_torch.monitor.promparse`` with its
    ``io_bytes`` sample equal to the checkpoint's array bytes, and the
    status file must hold run A's last iteration and loss;
18. train full-width rwkv6-1.6b cut to 8 of its 24 layers (d_model 2048,
    32 WKV heads of 64, vocab 65536; bf16, remat "dots",
    ``seq_impl="parallel"``) through
    ``run_training`` as phase 8 does: batch 4 x 1024, 6 AdamW steps, the
    launch counters set to 0 just before and read just after and held to
    ``_per_step_launches`` x 6 (per step 6L RMSNorm forwards, 3L backwards,
    L = 8; no flash, RG-LRU or WKV-6 launch: the recurrence trains through
    its PyTorch form, as the reference's does), finite losses; one
    loss-and-gradient step against the plain path (``_train_family_phase``:
    loss and gradient norm at TRAIN_RTOL, each leaf in relative norm at
    RECURRENT_REL, with each path's distance from the plain path in f32
    printed beside it), the same step in f32 (each leaf to 1e-3); one warm
    step under ``torch.profiler`` (device activity only);
19. the same for recurrentgemma-9b at full width (d_model 4096, 16/1 heads
    of 256, window 2048, vocab 256000, untied) cut to 4 of its 38 layers,
    batch 1 x 4096: per step 4 flash forwards, 2 dq and 2 dkv at head_dim
    256 (two ``attn_local`` layers in the stacked unit), 14 RMSNorm
    forwards and 8 backwards; peak device memory under CUT_TRAIN_MAX_GB; the
    bf16 leaves at LEAF_RTOL, as phase 8's; the f32 step runs the f32-FMA
    flash instances at head_dim 256 in a model.  The median step prints
    beside HYBRID_STEP_UNSPLIT_S, the one measured with the earlier hd-256
    dkv kernel;
20. serve full-width moonshot-v1-16b-a3b (48 layers, d_model 2048, 16/16
    heads of 128, MoE of 64 experts of width 1408, top 6, capacity factor
    1.25, vocab 163840, untied: 28.06 B parameters, 56.1 GB of bf16
    weights drawn on the card) as phase 4 serves llama3.2-1b, after the
    earlier phases' memory is freed: the launch counters must equal
    48 x prefills (flash, hd 128) and 96 x (prefills + decode steps)
    (RMSNorm: ln and ln2 of each layer); each prompt's prefill logits and
    one decode step are held against the plain path in relative L2 norm at
    RECURRENT_REL (a top-6 choice of 64 that flips between the paths
    changes which tokens drop); the share of (token, expert) choices and
    of kept slots on which the two paths agree is printed per layer for
    one prefill; the peak device memory is printed.  Then profile a warm
    window of that engine, and hold the architecture in f32 cut to 4 of
    its 48 layers, kernel against plain path at 2e-4;
21. train moonshot-v1-16b-a3b at full width cut to 4 of its 48 layers
    (2.95 B parameters), batch 4 x 1024, as phase 19 trains
    recurrentgemma-9b: the loss adds the routers' load-balancing loss
    (0.01 x aux); per step 8 flash forwards, 4 dq and 4 dkv at head_dim 128
    and 16 RMSNorm forwards and 8 backwards, exactly; peak device memory
    under CUT_TRAIN_MAX_GB; the bf16 step against the plain path with the
    plain path (and the f32 anchor) replaying the kernel path's top-k
    choices layer by layer (``_routing_tap``, which phase 20 shares; the
    share of choices the plain path would have made alike is printed), the
    kernel path's loss-and-gradient step run twice and bit-equal (autograd's
    backward of the dispatch adds up to top_k gradient rows into each
    token), the f32 step with each path routing on its own and every
    choice equal, and a profiled warm step;
22. serve full-width internvl2-26b (48 layers, d_model 6144, 48/8 heads of
    128, d_ff 16384, vocab 92553, untied, 256 stub patch embeddings:
    19.86 B parameters, 39.7 GB of bf16 weights drawn on the card) as phase
    20 serves moonshot: every prefill runs behind the engine's zero patch
    prefix (the slots hold it: max_seq = 256 + 512 + 16 + 8), the launch
    counters must equal 48 x prefills (flash at hd 128 under GQA 48/8,
    S=T=768 and 556) and 96 x (prefills + decode steps) (RMSNorm at width
    6144); each prompt's prefill logits and one decode step are held to
    the plain path in f32 on the same weights (its stacked units upcast one
    at a time, ``_f32_units``): in relative L2 norm the kernel path lies no
    farther from it than ANCHOR_RATIO times the plain bf16 path (phase 4's
    elementwise tolerance does not hold at this depth and width even for
    the plain path against its f32 version; the kernel-vs-plain difference
    and the share of logits outside that tolerance are printed); then a
    profiled warm window, and the architecture in f32 cut to 4 of its 48
    layers (48 in f32 are 79.4 GB), kernel against plain path at 2e-4,
    behind a prefix of seeded random patch embeddings;
23. train internvl2-26b at full width cut to 4 of its 48 layers (2.70 B
    parameters), batch 4 x 1024 text tokens behind 256 patch embeddings
    (1280 positions a row; the loss scores the text positions, tokens/s
    and the FLOP share count text tokens and print the positions beside
    them), as phase 21 trains moonshot: per step 8 flash forwards, 4 dq and
    4 dkv at hd 128 under GQA 48/8, 16 RMSNorm forwards and 8 backwards at
    width 6144, exactly; peak device memory under CUT_TRAIN_MAX_GB; the bf16
    step against the plain path, the kernel path's step twice and bit-equal,
    the f32 step, and a profiled warm step;
24. serve full-width seamless-m4t-large-v2 (24 encoder and 24 decoder
    layers, d_model 1024, 16/16 heads of 64, d_ff 8192, vocab 256206
    padded to 256256, untied: 2.03 B parameters, 4.07 GB of bf16 weights,
    nothing cut) as phase 4 serves llama3.2-1b: every prefill encodes the
    engine's zero source frames, as long as the prompt (the reference's
    engine does the same), so the launch counters must equal 72 x prefills
    (flash: the encoder's 24 non-causal self-attentions, the decoder's 24
    causal self- and 24 non-causal cross-attentions) + 48 x prefills
    (RMSNorm, the encoder's) + 72 x (prefills + decode steps) (RMSNorm, the
    decoder's three a layer; both final norms are the unfused ones), and
    the logits are held to the plain path elementwise at phase 4's
    tolerance.  Zero frames leave the encoder and the cross-attention out
    of the logits, so outside the engine a prefill from seeded random
    frames and ENCDEC_DECODE_STEPS decode steps are held to the plain path
    too, for each prompt length and for the 300-token prompt from 512
    frames (S != T), with both paths' distance from the plain path in f32
    printed (``_encdec_frames_phase``); then a profiled warm window and the
    architecture in f32 at full depth (8.1 GB of f32 weights), kernel
    against plain path at 2e-4, from seeded random frames;
25. train seamless-m4t-large-v2 at full depth, batch 4 x 1024 tokens from
    1024 source frames a row, as phase 23 trains internvl2-26b: per step 144
    flash forwards, 72 dq and 72 dkv (48 of each non-causal), 240 RMSNorm
    forwards and 120 backwards at width 1024, exactly; the bf16 step against
    the plain path (every encoder leaf among the leaves held), and held to
    the plain path in f32 leaf by leaf: the kernel path no farther from it
    than ANCHOR_RATIO times the kernel path with every kernel swapped for
    its plain version (``_plain_kernels``); the kernel path's step twice
    and bit-equal, the f32 step, and a profiled warm step;
26. llama3.2-1b through the 1F1B pipeline schedule (``_pipeline_phase``):
    first the five training kernels at the shapes one microbatch gives them
    inside the stages (flash B=1 S=T=1024, 32/8 heads of 64 causal bf16;
    RMSNorm (1024, 2048) bf16), held against their plain versions and
    timed; then (a) ``run_training`` at full width with
    ``pipeline_stages=1``, ``pipeline_model=True``, ``pipeline_micro=4``,
    batch 4 x 1024, bf16, 4 steps (the whole tick clock runs with one
    stage): per step exactly 2LM flash forwards (the forward tick and the
    backward's recompute), LM dq, LM dkv, 4LM + M RMSNorm forwards and
    2LM + M backwards (the final norm is the fused kernel on this path;
    L = 16 units, M = 4: 128 / 64 / 64 / 260 / 132), finite losses,
    ``summary["pipeline"]``, the median step and the peak memory; (b) 4
    ranks on one card (``Mesh([cuda:0] * 4, ("pod",))``), 16 units over 4
    stages, 8 microbatches of batch 1 x 1024: one loss-and-gradient call
    held against the non-pipelined kernel path (remat dots) from the same
    weights and batch (loss and gradient norm at TRAIN_RTOL, each leaf at
    LEAF_RTOL in relative norm), then stage 1 derated to weight 0.5
    (depths 5/3/4/4, 4 padded slots) and the call again: loss, every
    gradient leaf and the launch counts bit-equal (the same layers run in
    the same order; padded slots launch nothing); then (c) one warm step
    of (b) with AdamW under ``torch.profiler`` (busy share, device
    operations, ms a tick and the card's wait on the host a tick; the
    ranks share the card and run one after another, so the phase times
    hold no bubble); and the same pipeline in f32 cut to 4 layers against
    the non-pipelined path at the f32 model tolerance 2e-4.
27. soak and fleet (``_soak_phase``): (a) ``run_soak`` serves full-width
    llama3.2-1b through the flash and RMSNorm kernels for SOAK_BUDGET_S of
    wall clock (seeded bursts of prompts 4 to 15 tokens long, 6 new tokens,
    4 slots, the reference's SLO of a 5 ms decode step, so the serving
    controller narrows and sheds), scraping its live ``MonitorServer`` over
    HTTP on 127.0.0.1 every SOAK_INTERVAL_S: the soak invariants hold on
    every page (``check_snapshots``), ``completed > 0``, and the launches are
    exactly 16 flash forwards a prefill and 32 RMSNorm forwards a model call
    (prefills and decode steps counted by the soak's ``serve/prefill`` and
    ``serve/decode`` timers), every other kernel 0; it prints the ADAPT
    actions, the median decode step and the peak memory; (b) the training
    soak (the simulated fleet under seeded faults, on the card) with its
    invariants and faults injected; (c) the fault drills
    (``repro_torch.faults.soak.main --seed 1 --steps 200 --device cuda``:
    the simulated fleet's recovery and bounded timers, then training the
    MLP stack through the one-stage pipeline on the card, corrupting its
    newest checkpoint, planting killed-writer debris and resuming from the
    newest valid step with both quarantined); (d) real ranks: the seeded
    fleet drill (seed 0, 3 ranks, 40 polls) with every rank done or fenced,
    and a 2-rank fleet (FLEET_POLLS polls, liveness FLEET_LIVENESS_S) with
    a join at poll 6 and a SIGKILL at poll 18 whose join and leave (rank 0,
    after poll 18) are ``ADAPT/fleet::*`` rows and whose epoch, joins and
    leaves move between the first and the last scraped page.
28. sharded training (``_dist_train_phase``): the five training kernels at
    a rank's local shapes (flash B=2 S=T=1024, 16/4 heads of 64 causal
    bf16; RMSNorm (2048, 2048)), held and timed as in phase 26; the
    unsharded kernel path's loss-and-gradient step from phase 8's weights
    and batch, saved to the host; DTensor's own all-gather on the card
    over gloo in 2 ranks with nothing routed (its outcome printed); then
    4 ranks on the card (``dist.spawn.run_ranks``, gloo, each capped at
    DIST_MEMORY_FRACTION of the card) on a (2, 2) ("data", "model")
    ``DeviceMesh``: the five collectives through DTensor on bf16 and f32
    tensors over "data" (routed through the process group,
    ``dist.collectives``), then (a) "tp" and (b) "tp+fsdp":
    ``run_training`` at full width with ``mesh_shape=(2, 2)``, 3 steps of
    phase 8's schedule, each rank's launches exactly phase 8's per-step
    counts x 3, the losses at TRAIN_RTOL of phase 8's first three; one
    sharded loss-and-gradient step whose gathered leaves are held to the
    unsharded step at LEAF_RTOL (its loss at TRAIN_RTOL); after (a)
    ``cross_pod_mean_compressed`` over "data" on each rank's own part of
    that gradient against the mean of the ranks' dequantized payloads.
    It prints each rank's peak memory and time in collectives (the
    ``dist/collective/*`` timers), the median step, the card's name and
    power limit, and that 4 ranks share one card over gloo.
29. the pipeline with one process a stage (``_procs_phase``): 4 processes
    on the card (``dist.spawn.run_ranks``, gloo, each capped at
    PROCS_MEMORY_FRACTION of it) on a ``("pod",)`` ``DeviceMesh``, phase
    26 (b)'s full-width llama3.2-1b, 16 units over 4 stages and 8
    microbatches of 1 x 1024, each process holding only its units, its
    pinned pieces (the embedding on rank 0; the final norm and the tied
    table on rank 3) and their AdamW state, the rings point-to-point
    messages staged through pinned host memory: (a) the loss and every
    gradient leaf, gathered to rank 0, bit-equal to phase 26 (b)'s single
    controller (SHA-1 of each leaf), each process's launches exactly its
    stage's share and their sum (b)'s; (b) stage 1 derated to 0.5 (depths
    5/3/4/4, the units moved between the processes): bit-equal again; (c)
    one AdamW step: every parameter bit-equal to phase 26 (c)'s first
    step, the tied table's two copies bit-identical; a warm step profiled
    on rank 0 (busy share of its own kernels, device operations) beside
    phase 26 (c)'s; (d) ``run_training`` on the 4 processes for 4 steps,
    each rank's launches exact, its median step, phase seconds, P2P calls,
    bytes and seconds and peak memory printed; (e) cut to 4 layers, 4
    steps uninterrupted, and 2 steps saved (gathered to rank 0) then
    resumed on 2 processes (started beside the 4, they wait for the save):
    the resumed losses equal the uninterrupted run's.  It prints each
    process's wall-clock parts.  The kernels' record adds each kernel's launches by rank in
    (d) under ``pipeline_procs``.
30. sharded serving (``_sharded_serve_phase``): llama3.2-1b,
    recurrentgemma-9b and rwkv6-1.6b at full width (SHARDED_CELLS: depth
    and decode steps), bf16, the kernel path (``seq_impl="pallas"``).  This
    process first runs each unsharded (``M.prefill`` on SHARDED_BATCH
    seeded prompts of SHARDED_PROMPT tokens, then seeded decode tokens)
    and keeps the logits and each call's launches; then 4 ranks on the
    card (gloo, capped at SHARDED_MEMORY_FRACTION) on a (2, 2) ("data",
    "model") ``DeviceMesh`` draw the same weights one leaf at a time,
    keeping their shards, and run ``launch.steps.make_prefill_step`` and
    ``make_serve_step``: each rank's launches of each call exactly the
    unsharded call's (the flash, RMSNorm, RG-LRU and WKV-6 kernels on its
    local shards), the gathered logits of the prefill and of every decode
    step held to the unsharded path in relative L2 norm (llama at
    MODEL_RTOL, the deep recurrent ones at RECURRENT_REL, and in f32 at 4
    layers elementwise at F32_ATOL: SHARDED_F32).  Beside the
    ranks, a process of its own runs the dry run (``launch.dryrun``) of
    the same cells on a fake group of 4 (mesh label "chip22"): its
    per-device params and cache bytes must equal each rank's measured
    local shard bytes.  It prints each rank's prefill and median decode
    step, the dry run's local FLOPs beside the prefill, peak memory, time
    in collectives (``dist/collective/*``), and the card's name and power
    limit.  Each rank records the shapes and dtypes its kernel wrappers are
    called at (``_shape_tap``; every launch one such call, every rank the
    same); then this process holds each kernel at each of those local
    shapes against its plain version, times it and bounds it.  The
    kernels' record adds, under ``serve_sharded``, each kernel's launches
    by arch and rank and its rows at those shapes.
31. the examples on the card (``_examples_phase``), each through its
    ``main`` or its functions, in this process: (a)
    ``examples/quickstart_torch.py``: its printed timer tree must be the
    reference quickstart's (QUICKSTART_TREE: paths, nesting, counts), with
    xla_flops 24576 and steps_done 6; (b) ``amr_adaptive_checkpoint_torch``'s
    ``run_experiment``, fixed then adaptive, at the example's defaults (120
    iterations, levels of 48^3 on the card, up to 4): each run's checkpoint
    share, seconds, checkpoints and suppressed decisions and the runtime cut
    beside the paper's ~17% are printed; the fixed run takes 14
    checkpoints, the adaptive share is at most 0.08 and its checkpoint
    seconds under half the fixed run's (the reference benchmark's checks);
    (c) ``serve_llm_torch`` at full-width llama3.2-1b with the kernels and a
    50 ms decode target (24 requests, prompts of 32, 16 new tokens, 8
    slots): every handle resolves, 16 flash forwards a prefill and 32
    RMSNorm forwards a prefill and a decode step exactly; the ADAPT/serving
    decisions, tokens/s and p95 TTFT are printed; (d) ``train_llm_torch``'s
    demo-100m with the kernels, TRAIN_LLM_STEPS steps of the example's
    defaults (batch 8 x 256, copy task, adaptive checkpointing at 5%):
    launches exactly TRAIN_LLM_PER_STEP a step, the logged loss falling
    (the mean of its last tenth under that of its first), the checkpoint
    share at most 0.08; then the five training kernels at demo-100m's
    shapes (flash B=8 S=T=256, 10/5 heads of 64 causal bf16; RMSNorm
    (2048, 640)) and the forward kernels at serve_llm's prefill (B=1 S=T=32,
    32/8 heads; (32, 2048)), held and timed as in phase 26.
32. sharded MoE training (``_moe_dist_train_phase``): the five training
    kernels at a rank's local shapes (flash B=2 S=T=1024, 8/8 heads of 128
    causal bf16; RMSNorm (2048, 2048)), held and timed; the unsharded
    kernel path's loss-and-gradient step of moonshot-v1-16b-a3b at phase
    21's depth (4 layers), weights and batch, with each layer's routing
    (``_routing_tap``: top-k choices keyed by the router weight's bits),
    saved to the host; then phase 28's 4 processes on the card, (2, 2)
    ("data", "model"), "tp+fsdp" with ``moe_dispatch_mode="embed"``:
    ``run_training`` for MOE_DIST_STEPS steps, each rank's launches exactly
    phase 21's per-step counts x MOE_DIST_STEPS, finite losses, the first
    at TRAIN_RTOL of the unsharded step's; one sharded loss-and-gradient
    step whose every layer replays the unsharded path's choices for the
    rank's batch rows (a near-tie that the split matmuls round differently
    would move a token to another expert), its loss at TRAIN_RTOL and every
    gathered leaf at LEAF_RTOL (relative norm) of the unsharded step.  It
    prints each rank's peak memory, collective seconds, calls and bytes,
    the share of the choices it would have made alike, the step seconds,
    and the card's name and power limit.

Every phase ends with a ``[phase N] seconds`` line (wall seconds since the
line before), and with a line on standard error giving the seconds since
the script started.

Phase 2 also holds the flash kernel at head_dim 256 (recurrentgemma-9b's MQA
heads, window 2048) at S=T=2560, 512 and phase 19's 4096 bf16.  Phases 2
and 6 also hold the flash kernels at head_dim 16, at phase 16's shapes (B=2, S=T=128; 4/2 heads
causal and 4/1 heads with window 16; bf16 and f32), elementwise at the
kernel tolerances.  Memory is freed between the
serving and the training phases, before phase 10 and around phases 18
to 25.  Each serving profile also counts the device operations of one
decode step of N_SLOTS rows.

Which design runs where: in bf16 at head_dim 32 to 256, ``flash_fwd``
(phases 2, 4, 8, 12, 19 to 25), ``flash_bwd_dq`` and ``flash_bwd_dkv`` (phases
6, 8, 19, 21, 23, 25) are tensor-core kernels (``wgmma`` fed by TMA through an
mbarrier-guarded shared-memory ring, sm_90a; at head_dim 256 dq streams
32-key tiles; dkv keeps dv and dk on the two warpgroups of a 64-key
block, passing P^T between them through shared memory, and splits the GQA
group's heads across blocks where that grid is under one wave, adding the
split's f32 partials in a second, fixed-order launch); their f32
instances (the f32 cases of phases 2 and 6, the f32 models of phases 13, 20, 22
and 24, the f32 gradient steps of phases 16, 19, 21, 23 and 25) and their bf16 instances at
head_dim 16 (phases 2, 6 and 16) are f32-FMA kernels on the CUDA cores,
as are the RMSNorm, RG-LRU and WKV-6 kernels (the RMSNorm forward holds
rows of up to 4096 bf16 in registers, narrow rows several to a warp, and
loops over wider ones: phase 22's and 23's 6144).
Phases 2 and 6 print, for every case, the design (as the kernel library
reports it), registers a thread (and local spill bytes) and shared memory a
block of the instance that ran; phase 7 the
RMSNorm backward's registers, grid and launches per call (one, or two with
the column sum of dw).  RG-LRU is one chunked pass with a decoupled
look-back (one launch a call, after a memset of its look-back words), WKV-6
three chunked launches (chunk states, their carry, chunk outputs) counted as
one call; phases 10 and 11 assert one counted launch a call and print each
case's grid.

Kernel times are medians over 7 windows of 20 calls queued behind a
device-side sleep (so host overhead is not in them), each call timed by its
own pair of CUDA events with a 256 MB write queued before it, outside the
pair: no call finds its inputs in the 50 MB L2 from the call before.  The
plain versions and the library calls are timed the same way.  The
recurrences' plain versions are Python loops of small launches, so their
times are host-bound.  Bounds use the H100 SXM data-sheet peaks:
3.35 TB/s, 989 TFLOP/s for bf16 tensor-core work, 67 TFLOP/s for f32
CUDA-core work.  Every kernel line prints its share of its bound and, where
a library call computes the same function, its time over that call's; a
kernel time below its bound fails the run.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}

# full-width serving runs (configs/llama3_2_1b.py, recurrentgemma_9b.py, rwkv6_1_6b.py)
N_REQUESTS, PROMPT_LENS, MAX_NEW, N_SLOTS, SEED = 8, (512, 300), 16, 4, 0
HYBRID_PROMPT_LENS = (2560, 512)
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, vocab, window) of the
# MoE serving run (configs/moonshot_v1_16b_a3b.py), and the depth of its f32 check
MOE_SHAPE, MOE_F32_LAYERS = (48, 2048, 16, 16, 128, 163840, None), 4
# bf16 model tolerance of the repo (tests/test_model_pallas_path.py)
MODEL_ATOL, MODEL_RTOL = 0.1, 0.05
# the hybrid and SSM families, 38 and 24 random bf16 layers deep: the kernel
# and plain paths round differently (f32 against bf16 attention
# probabilities, the norms' and scans' summation orders), and random deep
# layers amplify rare bf16 rounding flips, so their bf16 logits are only
# held in relative L2 norm against gross failure (unrelated logits differ by
# ~1.41); the plain path's own spread under a second recurrence order
# (seq_impl="ref") is printed beside it.  The semantics are held in f32 at
# full width (the hybrid cut to one unit plus its tail) elementwise at the
# repo's f32 model tolerance (tests/test_torch_model.py)
RECURRENT_REL = 0.5
# The same holds for rwkv6-1.6b's bf16 gradients (phase 18): at full depth,
# in development runs on the card, kernel and plain path differed by
# 0.24-0.27 in relative norm on every leaf, with loss and gradient norm
# within TRAIN_RTOL, while each path lay ~0.86 (median leaf) from the plain
# path in f32 on the same weights: bf16 rounding, not the kernels.  So its
# leaves are held at RECURRENT_REL, that distance printed beside them, and
# in f32 to 1e-3 (phase 18 now trains SSM_TRAIN_LAYERS of the 24)
F32_ATOL = 2e-4
# internvl2-26b in bf16 at 48 layers of width 6144 (phase 22): phase 4's
# elementwise tolerance held at 4 and 16 layers but not at 48, where the
# plain path itself lies outside it for 1.5-2.5% of the logits of its own
# f32 version on the same weights (development runs on the card, NVIDIA H100
# 80GB HBM3, 700.00 W).  So the kernel path is held to that f32 path: in
# relative L2 norm it may lie no farther from it than ANCHOR_RATIO times the
# plain bf16 path does (0.96-1.01 times in those runs, at 4, 16 and 48
# layers): it may round differently from the plain path, not worse.
# seamless-m4t-large-v2's bf16 gradients (phase 25) are held the same way,
# leaf by leaf, against the kernel path run on the kernels' plain versions:
# the plain path's autograd forms the flash backward's row sums from f32
# probabilities, while the kernel path, as the reference's flash VJP
# (src/repro/kernels/flash_attention/ops.py:51), takes delta from the
# bf16-rounded output, which alone puts its cross-attention leaves (ln, wq,
# wk) ~3x farther from f32 than the plain path's (tools/delta_precision.py,
# on the CPU at full width and depth, batch 1 x 1024: cross/ln 9.078e-02
# with every kernel's arithmetic in f32, 9.105e-02 with the tensor-core
# kernels' bf16 P and dS, 3.009e-02 with delta from the f32 output; the
# plain path 3.082e-02)
ANCHOR_RATIO = 1.25
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# gradient tolerances of the repo (tests/test_kernels_flash.py:62,
# tests/test_kernel_dtype_drift.py): flash f32 5e-4; dw sums over rows
GRAD_TOL = {"bfloat16": 3e-2, "float32": 5e-4}
DW_TOL = {"bfloat16": 3e-2, "float32": 2e-4}

DEVICE = "cuda"
# full-width training run (configs/llama3_2_1b.py, remat "dots")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
# kernel path vs plain path on the card, bf16: loss and gradient norm to the
# bf16 gradient tolerance, each leaf's gradient to 10% in relative norm
TRAIN_RTOL, LEAF_RTOL = 3e-2, 0.1
# the smoke configs' phase (head_dim 16): prompt and sequence length, steps
SMOKE_SEQ, SMOKE_STEPS = 128, 3
# training the hybrid and SSM families (phases 18 and 19): rwkv6-1.6b at full
# width cut to SSM_TRAIN_LAYERS of its 24 layers (all 24 took 33 s of a
# run's 858 s, NVIDIA H100 80GB HBM3, 700.00 W) at phase 8's batch x seq;
# recurrentgemma-9b at full width
# cut to 4 of its 38 layers (one (rglru, attn_local, attn_local) unit and the
# first layer of the next: 9.8 B params x 16 B of training state are past one
# card), batch 1 x seq 4096, twice the 2048 window
SSM_TRAIN_LAYERS = 8
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 4, 1, 4096
# training moonshot-v1-16b-a3b (phase 21): full width cut to 4 of its 48
# layers (2.95 B params, ~41 GB of training state; all 48 would need ~393
# GB), phase 8's batch x seq; per step 8 flash forwards at head_dim 128, 4
# dq, 4 dkv, 16 RMSNorm forwards and 8 backwards
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "rmsnorm_fwd": 16,
                      "rmsnorm_bwd": 8, "rglru_fwd": 0, "wkv6_fwd": 0}
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, vocab, window) of the
# vlm serving run (configs/internvl2_26b.py: 19.86 B parameters, 39.7 GB of
# bf16 weights), its patch prefix, and the depth of its f32 check (48 layers
# in f32 would take 79.4 GB)
VLM_SHAPE, VLM_PATCHES, VLM_F32_LAYERS = (48, 6144, 48, 8, 128, 92553, None), 256, 4
# training internvl2-26b (phase 23): full width cut to 4 of its 48 layers
# (2.70 B params; all 48 would need ~280 GB of training state), phase 8's
# batch x seq text tokens behind the 256 patches (1280 positions a row); per
# step the launches of phase 21, flash at head_dim 128 under GQA 48/8
VLM_TRAIN_LAYERS = 4
VLM_TRAIN_SEQ = VLM_PATCHES + TRAIN_SEQ
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, vocab, window) of the
# enc-dec serving run (configs/seamless_m4t_large_v2.py: 24 decoder layers
# behind 24 encoder layers, 2.03 B parameters, 4.07 GB of bf16 weights),
# served and trained at full depth; its encoder's depth
ENCDEC_SHAPE, ENCDEC_ENC_LAYERS = (24, 1024, 16, 16, 64, 256206, None), 24
# per prefill: a flash forward for each encoder layer (not causal), and for
# each decoder layer's causal self-attention and non-causal cross-attention;
# an RMSNorm for each encoder layer's ln and ln2 (the encoder runs at
# prefill only); per call, one for each decoder layer's self, cross and
# feed-forward norms
ENCDEC_PER_PREFILL = {"flash_fwd": 3 * 24, "rmsnorm_fwd": 2 * 24}
ENCDEC_PER_CALL = {"rmsnorm_fwd": 3 * 24}
# per training step under remat "dots" (``_per_step_launches``): the 24
# encoder units and 24 decoder units each run twice
ENCDEC_TRAIN_PER_STEP = {"flash_fwd": 144, "flash_bwd_dq": 72, "flash_bwd_dkv": 72,
                         "rmsnorm_fwd": 240, "rmsnorm_bwd": 120, "rglru_fwd": 0, "wkv6_fwd": 0}
# decode steps held against the plain path after each prefill from seeded
# random source frames (phase 24)
ENCDEC_DECODE_STEPS = 3
# the serving soak's prompts are 4 to 15 tokens long (phase 27)
SOAK_PROMPT_MAX = 15
# phase 26, llama3.2-1b through the 1F1B pipeline schedule: (a) the
# launcher with one stage, PIPE_MICRO microbatches of phase 8's batch x seq,
# PIPE_STEPS steps; (b) PIPE_RANKS ranks sharing the card, 16 units over 4
# stages, PIPE_RANK_MICRO microbatches of batch PIPE_RANK_BATCH x seq, and in
# f32 at PIPE_F32_LAYERS layers
PIPE_MICRO, PIPE_STEPS = 4, 4
PIPE_RANKS, PIPE_RANK_MICRO, PIPE_RANK_BATCH, PIPE_F32_LAYERS = 4, 8, 8, 4
# per pipelined step at (a)'s L = 16 units and M = 4 (``_pipeline_launches``)
PIPE_PER_STEP = {"flash_fwd": 128, "flash_bwd_dq": 64, "flash_bwd_dkv": 64,
                 "rmsnorm_fwd": 260, "rmsnorm_bwd": 132, "rglru_fwd": 0, "wkv6_fwd": 0}
# the peak device memory of a training run cut in depth (phases 19, 21 and
# 23) must stay under this
CUT_TRAIN_MAX_GB = 76.0
# phase 19's median step with the earlier hd-256 dkv kernel (two blocks a
# 128-key tile, one per column half, no split of the GQA group; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside the step of this run
HYBRID_STEP_UNSPLIT_S = 0.34754
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, vocab, tied, window) of
# each trained configuration, held before a run
TRAIN_SHAPES = {
    ("llama3.2-1b", True): (2, 64, 4, 2, 16, 256, True, None),
    ("llama3.2-1b", False): (16, 2048, 32, 8, 64, 128256, True, None),
    ("rwkv6-1.6b", False): (24, 2048, 32, 32, 64, 65536, False, None),
    ("recurrentgemma-9b", False): (HYBRID_TRAIN_LAYERS, 4096, 16, 1, 256, 256000, False, 2048),
    ("moonshot-v1-16b-a3b", False): (MOE_TRAIN_LAYERS, 2048, 16, 16, 128, 163840, False, None),
    ("internvl2-26b", False): (VLM_TRAIN_LAYERS, 6144, 48, 8, 128, 92553, False, None),
    ("seamless-m4t-large-v2", False): ENCDEC_SHAPE[:6] + (False, None),
}
# the checkpoint phase: run A trains steps 1-3 of phase 8's 6-step schedule
# and saves at shutdown (label 3); run B restores it and trains steps 4-6;
# both at full width cut to CKPT_LAYERS layers (7.08 GB of training state;
# at all 16 layers the 17.30 GB save and its restore took 69 s of the
# phase's 90 s, NVIDIA H100 80GB HBM3, 700.00 W), held to an uninterrupted
# run at that depth.  The checkpoints need a local directory with this much
# room
CKPT_STEPS, CKPT_LAYERS, CKPT_FREE_BYTES = 3, 4, 25e9


def _print(*args) -> None:
    print(*args, flush=True)


# bytes written between timed calls: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
# a call is timed over REPS windows of INNER calls; one slower than
# SLOW_CALL_MS over SLOW_REPS windows of SLOW_INNER: the plain versions at
# the path shapes take 3-18 ms a call, and 7 windows of 20 of them took ~2 s
# each, a quarter of phases 2 and 6
REPS, INNER, SLOW_CALL_MS, SLOW_REPS, SLOW_INNER = 7, 20, 2.0, 3, 2


def _device_ms(torch, fn) -> float:
    """Median over REPS windows of INNER calls queued behind a device sleep,
    per call (over SLOW_REPS windows of SLOW_INNER when a timed warm-up
    call takes more than SLOW_CALL_MS).  Before each call a write of
    ``L2_FLUSH_BYTES`` evicts the L2, and each call is timed by its own pair
    of CUDA events, so no call finds its inputs in L2 from the call before
    and the flush is not in the time."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    slow = start.elapsed_time(end) > SLOW_CALL_MS
    reps, inner = (SLOW_REPS, SLOW_INNER) if slow else (REPS, INNER)
    times = []
    for _ in range(reps):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(inner)]
        torch.cuda._sleep(40_000_000)  # ~20 ms: the host queues every call first
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times.append(sum(start.elapsed_time(end) for start, end in events) / inner)
    del flush
    return sorted(times)[len(times) // 2]


def _bound_ms(n_bytes: float, flops: float, peak: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _shares(ms, bound_ms, library_ms=None) -> str:
    """A kernel's share of its bound, which no time can beat (the run fails
    if one does), and its time over the library call's where there is one."""
    assert ms >= bound_ms, f"a kernel time of {ms} ms reads below its bound of {bound_ms} ms"
    note = f"bound_share={bound_ms / ms:.4f}"
    return note + (f" kernel/library={ms / library_ms:.3f}" if library_ms else "")


def _kernel_note(fa_ops, kernel, dtype, hd, split=1) -> str:
    """Which design runs, as the kernel library reports it (tensor cores or
    f32 FMAs), and the instance's registers and shared memory (for dkv, of
    the instance that ``split`` launches)."""
    info = fa_ops.kernel_info(kernel, dtype, hd, split)
    design = "tensor-core (wgmma + TMA)" if info["tensor_cores"] else "f32-FMA"
    return (f"[{design} kernel: {info['registers']} registers/thread, "
            f"{info['local_bytes']} B local/thread, {info['smem_bytes']} B shared/block, "
            f"{info['threads']} threads/block]")


# the smoke configs' attention at phase 16's shapes (batch 2 x SMOKE_SEQ):
# llama3.2-1b's 4/2 heads causal, recurrentgemma-9b's 4/1 with window 16
SMOKE_GQA, SMOKE_MQA = (4, 2, 16), (4, 1, 16)
SMOKE_CASE = f"smoke hd=16 causal B=2 S=T={SMOKE_SEQ} bfloat16"


def _mask_pairs(torch, s, t, causal, window):
    """(S, T) bool mask of the (query, key) pairs a flash call computes."""
    pos_q = torch.arange(s, device=DEVICE)[:, None]
    pos_k = torch.arange(t, device=DEVICE)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=DEVICE)
    if causal:
        ok &= pos_k <= pos_q
    if window is not None:
        ok &= pos_k > pos_q - window
    return ok


# seamless-m4t-large-v2's attention (16/16 heads of 64): the encoder's
# self-attention and the decoder's cross-attention are not causal; S = T
# on its entry points (the source as long as the prompt), S != T held too
ENCDEC_HEADS = (16, 16, 64)


def _flash_phase(torch, F, fa_ops, gen):
    llama, hybrid, moe, vlm = (32, 8, 64), (16, 1, 256), (16, 16, 128), (48, 8, 128)
    encdec = ENCDEC_HEADS
    vlm_prompts = [VLM_PATCHES + n for n in PROMPT_LENS]
    # (role, name, B, S, (H, KV, hd), window, dtype[, causal, T]): causal
    # with T = S unless the case says otherwise
    cases = [
        ("serve", "path S=T=512 causal bf16", 1, 512, llama, None, torch.bfloat16),
        ("", "ragged S=T=300 causal bf16", 1, 300, llama, None, torch.bfloat16),
        ("soak", f"soak path S=T={SOAK_PROMPT_MAX} causal bf16", 1, SOAK_PROMPT_MAX, llama, None,
         torch.bfloat16),
        ("", "soak shortest S=T=4 causal bf16", 1, 4, llama, None, torch.bfloat16),
        ("", "window=128 S=T=512 bf16", 1, 512, llama, 128, torch.bfloat16),
        ("", "f32 S=T=512 causal", 1, 512, llama, None, torch.float32),
        ("train", f"training path B={TRAIN_BATCH} S=T={TRAIN_SEQ} causal bf16", TRAIN_BATCH,
         TRAIN_SEQ, llama, None, torch.bfloat16),
        ("hybrid", "hybrid path hd=256 MQA S=T=2560 window=2048 bf16", 1, 2560, hybrid, 2048,
         torch.bfloat16),
        ("", "hybrid hd=256 MQA S=T=512 window=2048 bf16", 1, 512, hybrid, 2048, torch.bfloat16),
        ("hybrid_train", f"hybrid training path hd=256 MQA B=1 S=T={HYBRID_TRAIN_SEQ} "
         "window=2048 bf16", HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, hybrid, 2048, torch.bfloat16),
        ("moe", "moe path hd=128 MHA S=T=512 causal bf16", 1, 512, moe, None, torch.bfloat16),
        ("", "moe ragged hd=128 MHA S=T=300 causal bf16", 1, 300, moe, None, torch.bfloat16),
        ("moe_train", f"moe training path hd=128 MHA B={TRAIN_BATCH} S=T={TRAIN_SEQ} causal "
         "bf16", TRAIN_BATCH, TRAIN_SEQ, moe, None, torch.bfloat16),
        ("vlm", f"vlm path hd=128 GQA 48/8 S=T={vlm_prompts[0]} causal bf16", 1, vlm_prompts[0],
         vlm, None, torch.bfloat16),
        ("", f"vlm ragged hd=128 GQA 48/8 S=T={vlm_prompts[1]} causal bf16", 1, vlm_prompts[1],
         vlm, None, torch.bfloat16),
        ("vlm_train", f"vlm training path hd=128 GQA 48/8 B={TRAIN_BATCH} S=T={VLM_TRAIN_SEQ} "
         "causal bf16", TRAIN_BATCH, VLM_TRAIN_SEQ, vlm, None, torch.bfloat16),
        ("encdec", "encdec path hd=64 MHA S=T=512 non-causal bf16", 1, 512, encdec, None,
         torch.bfloat16, False, 512),
        ("", "encdec ragged hd=64 MHA S=T=300 non-causal bf16", 1, 300, encdec, None,
         torch.bfloat16, False, 300),
        ("", "encdec hd=64 MHA S=300 T=512 non-causal bf16", 1, 300, encdec, None,
         torch.bfloat16, False, 512),
        ("", "encdec f32 hd=64 MHA S=T=512 non-causal", 1, 512, encdec, None, torch.float32,
         False, 512),
        ("encdec_train", f"encdec training path hd=64 MHA B={TRAIN_BATCH} S=T={TRAIN_SEQ} "
         "non-causal bf16", TRAIN_BATCH, TRAIN_SEQ, encdec, None, torch.bfloat16, False,
         TRAIN_SEQ),
    ] + [
        ("", f"smoke hd=16 {name} B=2 S=T={SMOKE_SEQ} {_dtype_name(dtype)}", 2, SMOKE_SEQ,
         heads, window, dtype)
        for name, heads, window in (("causal", SMOKE_GQA, None),
                                    ("MQA window=16", SMOKE_MQA, 16))
        for dtype in (torch.bfloat16, torch.float32)
    ]
    rows = []
    for role, name, b, s, (h, kv, hd), window, dtype, *rest in cases:
        causal, t = rest or (True, s)
        mask = dict(causal=causal, window=window)
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, t, kv, hd), generator=gen, device="cuda").to(dtype)
        out, lse = fa_ops.flash_fwd(q, k, v, **mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
        tol = KERNEL_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        err = (out.float() - ref_out.float()).abs().max().item()

        ok = _mask_pairs(torch, s, t, causal, window)
        pairs = int(ok.sum())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_mask = None if window is None else ok
        ms = _device_ms(torch, lambda: fa_ops.flash_fwd(q, k, v, **mask))
        plain_ms = _device_ms(torch, lambda: fa_ops.flash_fwd_plain(q, k, v, **mask))
        library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None,
            enable_gqa=True))
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, lse))
        flops = 4.0 * b * h * pairs * hd
        bound_ms, bound_by = _bound_ms(
            n_bytes, flops, "bf16_tensor" if dtype == torch.bfloat16 else "f32")
        rows.append(dict(role=role, case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        _print(f"[flash] {name}: max_abs_err={err:.3e} lse_err="
               f"{(lse - ref_lse).abs().max().item():.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}) "
               f"library_ms={library_ms:.5f} {_shares(ms, bound_ms, library_ms)} "
               f"{_kernel_note(fa_ops, 'flash_fwd', dtype, hd)}")
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
    return rows


def _role(rows, role):
    return next(r for r in rows if r.get("role") == role)


def _rmsnorm_phase(torch, F, rn_ops, gen):
    # the serving path, the training path (batch x seq rows), then the
    # hybrid training path's width (4096), the SSM training path's
    # per-head group norm (batch x seq x 32 heads rows of 64), the hybrid
    # serving path's long prefill and decode step, and the vlm paths' width
    # (6144, past the rows the register kernel holds): its prefills (the
    # 256 patches and a prompt of 512 or 300), a decode step and a training
    # step
    cases = [(512, 2048), (300, 2048), (N_SLOTS, 2048), (512 * 32, 64),
             (TRAIN_BATCH * TRAIN_SEQ, 2048), (HYBRID_TRAIN_BATCH * HYBRID_TRAIN_SEQ, 4096),
             (TRAIN_BATCH * TRAIN_SEQ * 32, 64), (HYBRID_PROMPT_LENS[0], 4096), (N_SLOTS, 4096)]
    cases += [(VLM_PATCHES + n, 6144) for n in PROMPT_LENS]
    cases += [(N_SLOTS, 6144), (TRAIN_BATCH * VLM_TRAIN_SEQ, 6144)]
    # the enc-dec paths' width (1024): its prefills, a decode step, a training step
    cases += [(n, 1024) for n in PROMPT_LENS] + [(N_SLOTS, 1024), (TRAIN_BATCH * TRAIN_SEQ, 1024)]
    # the serving soak's longest prefill (phase 27)
    cases += [(SOAK_PROMPT_MAX, 2048)]
    rows = []
    for n, d in cases:
        x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(torch.bfloat16)
        y = rn_ops.rms_norm_fused(x, w, 1e-5)
        torch.cuda.synchronize()
        ref = rn_ops.rms_norm_plain(x, w, 1e-5)
        tol = KERNEL_TOL["bfloat16"]
        torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
        err = (y.float() - ref.float()).abs().max().item()
        ms = _device_ms(torch, lambda: rn_ops.rms_norm_fused(x, w, 1e-5))
        plain_ms = _device_ms(torch, lambda: rn_ops.rms_norm_plain(x, w, 1e-5))
        library_ms = _device_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5))
        n_bytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        bound_ms, bound_by = _bound_ms(n_bytes, 4.0 * n * d, "f32")
        rows.append(dict(case=f"({n}, {d}) bf16", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        plan = rn_ops.fwd_kernel_info(x, w)
        _print(f"[rmsnorm] ({n}, {d}) bf16: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}) "
               f"library_ms={library_ms:.5f} {_shares(ms, bound_ms, library_ms)} "
               f"[{plan['kernel']} kernel, {plan['launches']} launch a call, {plan['blocks']} "
               f"blocks of {plan['threads']} threads, {plan['registers']} registers/thread, "
               f"{plan['local_bytes']} B local/thread, {plan['smem_bytes']} B shared/block]")
    return rows


def _scope(sess, name):
    for root in sess.tree():
        for _, node in root.walk():
            if node.name == name:
                return node.count, node.inclusive
    raise KeyError(name)


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _hold(torch, got, want, tol, anchor=None):
    """``tol``: ``("elementwise", atol)`` with MODEL_RTOL, ``("relnorm",
    limit)`` on ||got - want|| / ||want||, or ``("anchor", ratio)``: ``got``
    no farther from ``anchor`` (the plain path in f32 on the same weights) in
    relative L2 norm than ``ratio`` times ``want`` is.  Returns the max abs
    difference of ``got`` and ``want``."""
    kind, limit = tol
    if kind == "elementwise":
        torch.testing.assert_close(got, want, atol=limit, rtol=MODEL_RTOL)
    elif kind == "relnorm":
        assert _rel(got, want) < limit, (_rel(got, want), limit)
    else:
        assert _rel(got, anchor) <= limit * _rel(want, anchor), (
            _rel(got, anchor), _rel(want, anchor), limit)
    return (got - want).abs().max().item()


@contextlib.contextmanager
def _f32_units(torch):
    """Run a model's stacked units in f32 from bf16 weights, one unit's
    upcast at a time (``model._unstack`` made a generator): the f32 anchor
    of a model whose f32 weights would not fit the card beside its bf16
    ones.  The caller passes the unstacked leaves (embedding, final norm,
    LM head) in f32."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map

    unstack = M._unstack

    def upcast(tree, n):
        for unit in unstack(tree, n):
            yield tree_map(lambda x: x.float(), unit)

    M._unstack = upcast
    try:
        yield
    finally:
        M._unstack = unstack


def _f32_outside_units(params):
    """``params`` with every leaf outside the stacked units (``scan`` and an
    encoder's ``enc_scan``, which ``_f32_units`` upcasts one unit at a time)
    in f32."""
    from repro_torch.models.layers import tree_map

    return {k: v if k in ("scan", "enc_scan") else tree_map(lambda x: x.float(), v)
            for k, v in params.items()}


def _serve_phase(torch, K, arch, prompt_lens, per_prefill, per_call, shape, tol, *,
                 smoke=False, n_requests=N_REQUESTS, max_new=MAX_NEW, n_slots=N_SLOTS):
    """Serve ``arch`` at full width (its smoke config with ``smoke``) through
    the kernels; the launch counts must equal ``per_prefill[k] x prefills +
    per_call[k] x (prefills + decode steps)`` for every kernel ``k`` (0 where
    neither names it)."""
    import numpy as np

    from repro_torch.launch.serve import make_requests, run_serving
    from repro_torch.models import model as M
    from repro_torch.serving.engine import prefill_batch
    from repro_torch.timing import TimingSession

    tag = f"[serve {arch}{' smoke' if smoke else ''}]"
    sess = TimingSession()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(K)
    t0 = time.perf_counter()
    with sess:
        engine = run_serving(
            arch, n_requests, prompt_lens, max_new,
            n_slots=n_slots, seed=SEED, session=sess, smoke=smoke,
            attn_impl="pallas", norm_impl="fused", seq_impl="pallas", dtype="bfloat16",
            device="cuda",
        )
    wall = time.perf_counter() - t0
    launches = _read_counters(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cfg = engine.cfg
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.vocab_size, cfg.window)
    assert got == shape, (got, shape)
    n_prefill, prefill_s = _scope(sess, "serve/prefill")
    n_decode, decode_s = _scope(sess, "serve/decode")
    stats = engine.stats()
    results = sorted(engine.completed, key=lambda r: r.rid)
    assert len(results) == n_requests and stats["shed"] == 0.0, stats
    assert all(r.status == "completed" and len(r.tokens) == max_new for r in results)
    assert not any(r.truncated for r in results), [r.truncated for r in results]
    assert n_prefill == n_requests, n_prefill
    expected = {name: per_prefill.get(name, 0) * n_prefill
                + per_call.get(name, 0) * (n_prefill + n_decode) for name, _, _ in COUNTERS}
    assert launches == expected, (launches, expected, n_prefill, n_decode)
    _print(f"{tag} {n_requests} requests, prompts {prompt_lens}, max_new {max_new}, "
           f"{n_slots} slots: wall_s={wall:.3f} prefills={n_prefill} decode_steps={n_decode} "
           f"launches={launches}")
    _print(f"{tag} tokens_per_s={stats['throughput_tokens_per_s']:.3f} "
           f"p95_ttft_s={stats['p95_ttft_s']:.5f} p95_latency_s={stats['p95_latency_s']:.5f} "
           f"timer serve/prefill_s={prefill_s:.5f} serve/decode_s={decode_s:.5f} "
           f"max_memory_allocated_GB={peak_gb:.3f}")

    # the served model against itself on the plain path, on the card
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref", seq_impl="parallel")
    requests = make_requests(cfg.vocab_size, n_requests, prompt_lens, max_new,
                             np.random.default_rng(SEED))
    exact = 0
    worst = 0.0
    worst_rel = 0.0
    spread = 0.0  # the plain path against itself under another recurrence order
    recurrent = any(kind in ("rglru", "rwkv") for kind in cfg.block_pattern)
    paths = [(cfg, engine.params), (plain, engine.params)]
    if recurrent:
        paths.append((plain.replace(seq_impl="ref"), engine.params))
    anchored = tol[0] == "anchor"
    if anchored:  # the plain path in f32, its stacked units upcast one at a time
        paths.append((plain.replace(dtype="float32"), _f32_outside_units(engine.params)))
    dist = []  # (kernel, plain) path's distance from the f32 path, by prompt
    outside = 0.0  # the largest share of logits past phase 4's elementwise tolerance

    def run(c, p, fn, *args):
        with _f32_units(torch) if c.dtype == "float32" and anchored else contextlib.nullcontext():
            cache, logits = fn(c, p, *args)
        return cache, logits[0, : c.vocab_size].float()

    for req, res in zip(requests, results):
        batch = prefill_batch(cfg, req.prompt, "cuda")  # the engine's, vlm's zero prefix too
        outs = [run(c, p, M.prefill, batch, M.init_cache(c, 1, engine.max_seq, device="cuda"))
                for c, p in paths]
        (cache_k, lk), (cache_p, lp) = outs[:2]
        anchor = outs[-1][1] if anchored else None
        if recurrent:
            spread = max(spread, _rel(outs[2][1], lp))
        assert lk.shape == (cfg.vocab_size,) and bool(torch.isfinite(lk).all())
        worst = max(worst, _hold(torch, lk, lp, tol, anchor))
        worst_rel = max(worst_rel, _rel(lk, lp))
        outside = max(outside, ((lk - lp).abs() > MODEL_ATOL + MODEL_RTOL * lp.abs()).float()
                      .mean().item())
        if anchored:
            dist.append((_rel(lk, anchor), _rel(lp, anchor)))
        first = res.tokens[0]
        assert int(lk.argmax()) == first, (req.rid, int(lk.argmax()), first)
        exact += int(lp.argmax()) == first
        if req.rid == 0:  # one decode step on the kernel, the plain (and the f32) path
            step = torch.tensor([[first]], dtype=torch.int32, device="cuda")
            held = [0, 1, len(paths) - 1] if anchored else [0, 1]
            dk, dp, *da = [run(*paths[i], M.decode_step, outs[i][0], step)[1] for i in held]
            _hold(torch, dk, dp, tol, *da)
        del outs, cache_k, cache_p
    spread_note = (f"; plain path vs itself with seq_impl=ref: max_rel_l2={spread:.4e}"
                   if recurrent else "")
    _print(f"{tag} prefill logits vs plain path: max_abs_diff={worst:.4f} "
           f"max_rel_l2={worst_rel:.4e} (tolerance {tol}{spread_note}); largest share of "
           f"logits outside atol {MODEL_ATOL} rtol {MODEL_RTOL}: {outside:.4f}; first token "
           f"equal on {exact}/{n_requests}")
    if anchored:
        _print(f"{tag} relative L2 distance from the plain path in f32, (kernel, plain) by "
               f"prompt: {[(round(a, 5), round(b, 5)) for a, b in dist]}; kernel/plain at most "
               f"{max(a / b for a, b in dist):.4f} (limit {tol[1]})")
    return launches, engine, sess


def _f32_phase(torch, arch, n_layers, prompt_lens):
    """The served architecture in f32 at full width (``n_layers`` deep, seeded
    random weights): prefill logits of the kernel path against the plain path
    on the card, elementwise at the f32 model tolerance, for a prompt of each
    length (for vlm behind a prefix of seeded random patch embeddings, for
    encdec from as many seeded random source frames as the prompt has
    tokens, both 0.02 x N(0, 1) as the synthetic data's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).replace(
        dtype="float32", n_layers=n_layers, attn_impl="pallas", norm_impl="fused",
        seq_impl="pallas")
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref", seq_impl="parallel")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    rng = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_prefix = M.prefix_positions(cfg)
    worst = 0.0
    for n in prompt_lens:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n), generator=rng,
                                         device="cuda", dtype=torch.int32)}
        if n_prefix:
            batch["patch_embeds"] = 0.02 * torch.randn((1, n_prefix, cfg.d_model), generator=rng,
                                                       device="cuda")
        if cfg.family == "encdec":
            batch["src_frames"] = 0.02 * torch.randn((1, n, cfg.d_model), generator=rng,
                                                     device="cuda")
        logits = []
        for c in (cfg, plain):
            cache = M.init_cache(c, 1, n_prefix + n + 8, device="cuda")
            logits.append(M.prefill(c, params, batch, cache)[1][0, : c.vocab_size])
        torch.testing.assert_close(logits[0], logits[1], atol=F32_ATOL, rtol=F32_ATOL)
        worst = max(worst, (logits[0] - logits[1]).abs().max().item())
    _print(f"[f32 {arch}] {n_layers} layers at full width, f32, prompts {prompt_lens}: kernel "
           f"vs plain path prefill logits max_abs_diff={worst:.3e} (atol = rtol = {F32_ATOL})")
    del params


def _free(torch) -> None:
    """Release what the last phase held: an engine and its control loop
    reference each other, so only the cycle collector frees its weights."""
    gc.collect()
    torch.cuda.empty_cache()


def _device_ops(prof):
    """The device operations (kernels, copies, fills) of a finished
    ``torch.profiler`` window, one row a name with ``key``, ``count`` and
    ``self_device_time_total`` (microseconds) as ``key_averages()`` gives
    them, read from the profiler's raw events: turning every event into a
    ``FunctionEvent`` first, as ``key_averages()`` does, took 14-82 s a
    serving window (NVIDIA H100 80GB HBM3, 700.00 W), longer than the window."""
    import types

    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        row = rows.setdefault(e.name(), types.SimpleNamespace(
            key=e.name(), count=0, self_device_time_total=0.0))
        row.count += 1
        row.self_device_time_total += e.duration_ns() / 1e3
    return list(rows.values())


def _profile_phase(torch, engine, sess, prompt_lens, tag="[profile]"):
    """Where a warm serving window's time goes: the same engine serves
    N_SLOTS more requests under ``torch.profiler``, which traces the
    device only; device busy share = summed kernel time over the window's
    wall time (the profiler's own host cost inflates the wall, so the idle
    share is an upper bound).  Then the
    device operations (kernels, copies, fills) of one decode step of
    N_SLOTS fresh cache rows, the engine's step shape."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 1)
    requests = [
        Request(1000 + i, prompt=[int(t) for t in rng.integers(
            0, engine.cfg.vocab_size, prompt_lens[i % len(prompt_lens)])],
            max_new_tokens=MAX_NEW)
        for i in range(N_SLOTS)
    ]
    before = {name: _scope(sess, name) for name in ("serve/prefill", "serve/decode")}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            engine.submit(req)
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ops(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    phases = {}
    for name, (count0, seconds0) in before.items():
        count, seconds = _scope(sess, name)
        phases[name] = f"{count - count0} x {1e3 * (seconds - seconds0) / max(count - count0, 1):.3f} ms"
    _print(f"{tag} warm window: {len(requests)} requests, wall_s={wall:.4f} "
           f"device_kernel_s={device_s:.4f} device_busy_share={device_s / wall:.4f}; {phases}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        _print(f"{tag}   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")
    cache = M.init_cache(engine.cfg, engine.n_slots, engine.max_seq, device="cuda")
    step = torch.zeros((engine.n_slots, 1), dtype=torch.int32, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        M.decode_step(engine.cfg, engine.params, cache, step)
        torch.cuda.synchronize()
    ops = sum(e.count for e in _device_ops(prof))
    _print(f"{tag} one decode step of {engine.n_slots} rows: {ops} device operations")
    del cache


def _rglru_phase(torch, rg_ops, gen):
    cases = [  # (name, B, S, D, dtype, with h0); the path first
        ("path (1, 2560, 4096) f32 h0", 1, 2560, 4096, torch.float32, True),
        ("(1, 512, 4096) f32 h0", 1, 512, 4096, torch.float32, True),
        ("ragged (1, 300, 4096) f32", 1, 300, 4096, torch.float32, False),
        ("(4, 1024, 4096) f32 h0", 4, 1024, 4096, torch.float32, True),
        ("(1, 2560, 4096) bf16 h0", 1, 2560, 4096, torch.bfloat16, True),
    ]
    rows = []
    for name, b, s, d, dtype, with_h0 in cases:
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=DEVICE)).to(dtype)
        x = torch.randn((b, s, d), generator=gen, device=DEVICE).to(dtype)
        h0 = torch.randn((b, d), generator=gen, device=DEVICE) if with_h0 else None
        before = rg_ops.launches
        y, h = rg_ops.rglru_fwd(a, x, h0)
        torch.cuda.synchronize()
        assert rg_ops.launches == before + 1, (name, rg_ops.launches - before)
        ref_y, ref_h = rg_ops.rglru_fwd_plain(a, x, h0)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(h, ref_h, atol=2e-5, rtol=2e-5)
        err = max((y.float() - ref_y.float()).abs().max().item(), (h - ref_h).abs().max().item())
        bit_equal = torch.equal(y, ref_y) and torch.equal(h, ref_h)  # printed, not asserted
        ms = _device_ms(torch, lambda: rg_ops.rglru_fwd(a, x, h0))
        plain_ms = _device_ms(torch, lambda: rg_ops.rglru_fwd_plain(a, x, h0))
        n_bytes = sum(t.numel() * t.element_size() for t in (a, x, y, h)) + (
            0 if h0 is None else h0.numel() * 4)
        bound_ms, bound_by = _bound_ms(n_bytes, 2.0 * b * s * d, "f32")
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        blocks, threads = rg_ops.kernel_plan(b, s, d)
        _print(f"[rglru] {name}: max_abs_err={err:.3e} bit_equal={bit_equal} "
               f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
               f"({bound_by}; {n_bytes / 1e6:.1f} MB) library_ms=None (no single PyTorch call) "
               f"{_shares(ms, bound_ms)} [1 counted launch a call: one kernel of {blocks} "
               f"blocks x {threads} threads, after a memset of its look-back words]")
        del a, x, y, h, ref_y, ref_h
    return rows


def _wkv6_phase(torch, wk_ops, gen):
    cases = [  # (name, B, S, H, K = V, r/k/v dtype); the path first; w f32, a state
        ("path (1, 512, 32, 64) bf16, f32 w, state", 1, 512, 32, 64, torch.bfloat16),
        ("ragged (1, 300, 32, 64) bf16", 1, 300, 32, 64, torch.bfloat16),
        ("(4, 1024, 32, 64) bf16", 4, 1024, 32, 64, torch.bfloat16),
        ("(1, 512, 32, 64) all f32", 1, 512, 32, 64, torch.float32),
    ]
    rows = []
    for name, b, s, h, k, dtype in cases:
        r, kk, v = (torch.randn((b, s, h, k), generator=gen, device=DEVICE).to(dtype)
                    for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((b, s, h, k), generator=gen, device=DEVICE)))
        u = 0.5 * torch.randn((h, k), generator=gen, device=DEVICE)
        state = torch.randn((b, h, k, k), generator=gen, device=DEVICE)
        before = wk_ops.launches
        y, s_out = wk_ops.wkv6_fwd(r, kk, v, w, u, state)
        torch.cuda.synchronize()
        assert wk_ops.launches == before + 1, (name, wk_ops.launches - before)
        ref_y, ref_s = wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(s_out, ref_s, atol=2e-5, rtol=2e-5)
        err = max((y.float() - ref_y.float()).abs().max().item(),
                  (s_out - ref_s).abs().max().item())
        state_equal = torch.equal(s_out, ref_s)  # printed, not asserted
        ms = _device_ms(torch, lambda: wk_ops.wkv6_fwd(r, kk, v, w, u, state))
        plain_ms = _device_ms(torch, lambda: wk_ops.wkv6_fwd_plain(r, kk, v, w, u, state))
        n_bytes = sum(t.numel() * t.element_size() for t in (r, kk, v, w, u, state, y, s_out))
        # per state element and step: r_i S_ij (2 flops), w_i S_ij + k_i v_j (3)
        flops = 5.0 * b * s * h * k * k
        bound_ms, bound_by = _bound_ms(n_bytes, flops, "f32")
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        plan = ", ".join(f"{part} {blocks} x {threads} ({smem} B shared)"
                         for part, blocks, threads, smem in wk_ops.kernel_plan(b, s, h, k))
        _print(f"[wkv6] {name}: max_abs_err={err:.3e} state_bit_equal={state_equal} "
               f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
               f"({bound_by}; {n_bytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP) "
               f"library_ms=None (no single PyTorch call) {_shares(ms, bound_ms)} "
               f"[1 counted launch a call: 3 kernels, blocks x threads: {plan}]")
        del r, kk, v, w, y, s_out, ref_y, ref_s
    return rows


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def _flash_bwd_phase(torch, F, fa_ops, gen):
    llama, hybrid, moe, vlm = (32, 8, 64), (16, 1, 256), (16, 16, 128), (48, 8, 128)
    encdec = ENCDEC_HEADS
    # (role, name, B, S, (H, KV, hd), window, dtype[, causal, T]), as phase 2's
    cases = [
        ("train", "path B=4 S=T=1024 causal bf16", TRAIN_BATCH, TRAIN_SEQ, llama, None,
         torch.bfloat16),
        ("", "ragged B=4 S=T=300 causal bf16", TRAIN_BATCH, 300, llama, None, torch.bfloat16),
        ("", "window=128 B=4 S=T=1024 bf16", TRAIN_BATCH, TRAIN_SEQ, llama, 128, torch.bfloat16),
        ("", "f32 B=4 S=T=1024 causal", TRAIN_BATCH, TRAIN_SEQ, llama, None, torch.float32),
        ("hybrid", f"hybrid path hd=256 MQA B=1 S=T={HYBRID_TRAIN_SEQ} window=2048 bf16",
         HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, hybrid, 2048, torch.bfloat16),
        ("", "hybrid ragged hd=256 MQA B=1 S=T=300 window=128 bf16", 1, 300, hybrid, 128,
         torch.bfloat16),
        ("", "hybrid f32 hd=256 MQA B=1 S=T=512 window=2048", 1, 512, hybrid, 2048,
         torch.float32),
        ("moe_train", f"moe training path hd=128 MHA B={TRAIN_BATCH} S=T={TRAIN_SEQ} causal "
         "bf16", TRAIN_BATCH, TRAIN_SEQ, moe, None, torch.bfloat16),
        ("", f"moe ragged hd=128 MHA B={TRAIN_BATCH} S=T=300 causal bf16", TRAIN_BATCH, 300,
         moe, None, torch.bfloat16),
        ("vlm_train", f"vlm training path hd=128 GQA 48/8 B={TRAIN_BATCH} S=T={VLM_TRAIN_SEQ} "
         "causal bf16", TRAIN_BATCH, VLM_TRAIN_SEQ, vlm, None, torch.bfloat16),
        ("", f"vlm ragged hd=128 GQA 48/8 B={TRAIN_BATCH} S=T=300 causal bf16", TRAIN_BATCH, 300,
         vlm, None, torch.bfloat16),
        ("encdec_train", f"encdec training path hd=64 MHA B={TRAIN_BATCH} S=T={TRAIN_SEQ} "
         "non-causal bf16", TRAIN_BATCH, TRAIN_SEQ, encdec, None, torch.bfloat16, False,
         TRAIN_SEQ),
        ("", f"encdec ragged hd=64 MHA B={TRAIN_BATCH} S=T=300 non-causal bf16", TRAIN_BATCH,
         300, encdec, None, torch.bfloat16, False, 300),
        ("", f"encdec hd=64 MHA B={TRAIN_BATCH} S=300 T=512 non-causal bf16", TRAIN_BATCH, 300,
         encdec, None, torch.bfloat16, False, 512),
        ("", f"encdec f32 hd=64 MHA B={TRAIN_BATCH} S=T=512 non-causal", TRAIN_BATCH, 512,
         encdec, None, torch.float32, False, 512),
    ] + [
        ("", f"smoke hd=16 {name} B=2 S=T={SMOKE_SEQ} {_dtype_name(dtype)}", 2, SMOKE_SEQ,
         heads, window, dtype)
        for name, heads, window in (("causal", SMOKE_GQA, None),
                                    ("MQA window=16", SMOKE_MQA, 16))
        for dtype in (torch.bfloat16, torch.float32)
    ]
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for role, name, b, s, (h, kv, hd), window, dtype, *rest in cases:
        causal, t = rest or (True, s)
        q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((b, t, kv, hd), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((b, t, kv, hd), generator=gen, device=DEVICE).to(dtype)
        do = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(dtype)
        mask = dict(causal=causal, window=window)
        out, lse = fa_ops.flash_fwd(q, k, v, **mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa_ops.flash_fwd_plain(q, k, v, **mask)
        tol = KERNEL_TOL[_dtype_name(dtype)]
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5)
        _print(f"[flash_bwd] {name}: forward out max_abs_err="
               f"{(out.float() - ref_out.float()).abs().max().item():.3e} lse_err="
               f"{(lse - ref_lse).abs().max().item():.3e}")
        del ref_out, ref_lse
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = fa_ops.flash_bwd_dq(*args, **mask)
        dk, dv = fa_ops.flash_bwd_dkv(*args, **mask)
        dk2, dv2 = fa_ops.flash_bwd_dkv(*args, **mask)
        torch.cuda.synchronize()
        # the split's partials are added in a fixed order: the same bits again
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv), name
        del dk2, dv2
        plan = fa_ops.dkv_plan(b, t, kv, h // kv, hd, dtype,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        _print(f"[flash_bwd_dkv] {name}: split={plan['split']} grid={plan['blocks']} blocks "
               f"launches_per_call={plan['launches']} workspace_MB="
               f"{plan['workspace_bytes'] / 1e6:.2f}; a second call bit-equal")
        ref_dq = fa_ops.flash_bwd_dq_plain(*args, **mask)
        ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(*args, **mask)
        tol = GRAD_TOL[_dtype_name(dtype)]
        stats = []
        for grad, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
            scale = got.float().abs().max().item()
            assert scale > 0 and ref.float().abs().max().item() > 0, (name, grad)
            stats.append(f"{grad}: max|kernel|={scale:.4g} "
                         f"bit-equal={(got == ref).float().mean().item():.4f}")
        _print(f"[flash_bwd] {name}: " + "; ".join(stats))
        err_dq = (dq.float() - ref_dq.float()).abs().max().item()
        err_dkv = max((dk.float() - ref_dk.float()).abs().max().item(),
                      (dv.float() - ref_dv.float()).abs().max().item())

        ok = _mask_pairs(torch, s, t, causal, window)
        pairs = int(ok.sum())
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if window is None else ok,
            is_causal=causal and window is None, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        # one call computes dq, dk and dv: the yardstick of both kernels
        library_ms = _device_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        peak = "bf16_tensor" if dtype == torch.bfloat16 else "f32"
        nbytes = lambda *xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
        for kernel, matmuls, moved, err, fn, plain in (
            ("flash_bwd_dq", 3, nbytes(q, k, v, do, lse, delta, dq), err_dq,
             lambda: fa_ops.flash_bwd_dq(*args, **mask),
             lambda: fa_ops.flash_bwd_dq_plain(*args, **mask)),
            ("flash_bwd_dkv", 4, nbytes(q, k, v, do, lse, delta, dk, dv), err_dkv,
             lambda: fa_ops.flash_bwd_dkv(*args, **mask),
             lambda: fa_ops.flash_bwd_dkv_plain(*args, **mask)),
        ):
            ms = _device_ms(torch, fn)
            plain_ms = _device_ms(torch, plain)
            bound_ms, bound_by = _bound_ms(moved, 2.0 * matmuls * b * h * pairs * hd, peak)
            rows[kernel].append(dict(role=role, case=name, max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=library_ms))
            note = _kernel_note(fa_ops, kernel, dtype, hd,
                                plan["split"] if kernel == "flash_bwd_dkv" else 1)
            _print(f"[{kernel}] {name}: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
                   f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}; "
                   f"{moved / 1e6:.1f} MB, {2e-9 * matmuls * b * h * pairs * hd:.1f} GFLOP) "
                   f"library_ms={library_ms:.5f} (SDPA backward: dq, dk, dv) "
                   f"{_shares(ms, bound_ms, library_ms)} {note}")
        del sdpa_out, qt, kt, vt
    return rows


def _rmsnorm_bwd_phase(torch, F, rn_ops, gen):
    cases = [(TRAIN_BATCH * TRAIN_SEQ, 2048, torch.bfloat16), (300, 2048, torch.bfloat16),
             (16384, 64, torch.bfloat16), (7, 100, torch.float32),
             (HYBRID_TRAIN_BATCH * HYBRID_TRAIN_SEQ, 4096, torch.bfloat16),
             (TRAIN_BATCH * TRAIN_SEQ * 32, 64, torch.bfloat16),
             (TRAIN_BATCH * VLM_TRAIN_SEQ, 6144, torch.bfloat16)]
    # the enc-dec training path's width, and its serving path's rows
    cases += [(TRAIN_BATCH * TRAIN_SEQ, 1024, torch.bfloat16)] + [
        (n, 1024, torch.bfloat16) for n in PROMPT_LENS + (N_SLOTS,)]
    rows = []
    for n, d, dtype in cases:
        x = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
        w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)).to(dtype)
        dy = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
        dx, dw = rn_ops.rms_norm_bwd(x, w, dy, 1e-5)
        torch.cuda.synchronize()
        ref_dx, ref_dw = rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5)
        name = _dtype_name(dtype)
        tol_dx, tol_dw = KERNEL_TOL[name], DW_TOL[name]
        torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol_dx, rtol=tol_dx)
        torch.testing.assert_close(dw, ref_dw, atol=tol_dw, rtol=tol_dw)
        assert torch.equal(rn_ops.rms_norm_bwd(x, w, dy, 1e-5)[1], dw)  # fixed-order dw
        err = max((dx.float() - ref_dx.float()).abs().max().item(),
                  (dw - ref_dw).abs().max().item())
        ms = _device_ms(torch, lambda: rn_ops.rms_norm_bwd(x, w, dy, 1e-5))
        plain_ms = _device_ms(torch, lambda: rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5))
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.rms_norm(xl, (d,), wl, 1e-5)
        library_ms = _device_ms(torch, lambda: torch.autograd.grad(
            y, (xl, wl), dy, retain_graph=True))
        moved = 3 * x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * d
        bound_ms, bound_by = _bound_ms(moved, 10.0 * n * d, "f32")
        rows.append(dict(case=f"({n}, {d}) {name}", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        plan = rn_ops.bwd_kernel_info(x, w, dy)
        _print(f"[rmsnorm_bwd] ({n}, {d}) {name}: max_abs_err={err:.3e} kernel_ms={ms:.5f} "
               f"plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} ({bound_by}; "
               f"{moved / 1e6:.1f} MB) library_ms={library_ms:.5f} "
               f"{_shares(ms, bound_ms, library_ms)} [{plan['launches']} launch(es) a call, "
               f"{plan['blocks']} blocks of {plan['threads']} threads, {plan['registers']} "
               f"registers/thread, {plan['local_bytes']} B local/thread, {plan['smem_bytes']} B "
               f"shared/block]")
        del y, xl, wl
    return rows


# (kernel, module of its wrapper, counter attribute)
COUNTERS = (("flash_fwd", "fa", "launches"), ("flash_bwd_dq", "fa", "dq_launches"),
            ("flash_bwd_dkv", "fa", "dkv_launches"), ("rmsnorm_fwd", "rn", "launches"),
            ("rmsnorm_bwd", "rn", "bwd_launches"), ("rglru_fwd", "rg", "launches"),
            ("wkv6_fwd", "wk", "launches"))


def _zero_counters(K) -> None:
    for _, mod, attr in COUNTERS:
        setattr(getattr(K, mod), attr, 0)


def _read_counters(K) -> dict[str, int]:
    return {name: getattr(getattr(K, mod), attr) for name, mod, attr in COUNTERS}


@contextlib.contextmanager
def _plain_kernels():
    """Swap each flash and RMSNorm kernel wrapper for its plain version (f32
    inside, no launch, no count): the kernel path's own algorithm (the flash
    backward's delta from the rounded output included, as the reference's
    ``flash_attention`` VJP forms it) with no CUDA kernel in it."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn

    swaps = [(fa, "flash_fwd", fa.flash_fwd_plain), (fa, "flash_bwd_dq", fa.flash_bwd_dq_plain),
             (fa, "flash_bwd_dkv", fa.flash_bwd_dkv_plain), (rn, "rms_norm_fwd", rn.rms_norm_plain),
             (rn, "rms_norm_bwd", rn.rms_norm_bwd_plain)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, wrapper in kept:
            setattr(mod, name, wrapper)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named_leaves(value, f"{prefix}/{key}" if prefix else key)
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _named_leaves(value, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _per_step_launches(cfg) -> dict[str, int]:
    """Kernel launches of one training step under remat "dots", from the
    model's structure: the stacked units' forward runs twice (again in the
    backward), the tail layers' once.  An attention layer launches one flash
    forward per run, one dq and one dkv; a layer launches two RMSNorm
    forwards per run (ln and ln2; an rwkv layer three: ln1, the per-head
    group norm, ln2) and as many backwards; the final norm is the unfused
    one, and the recurrences train through seq_impl "parallel", no kernel.
    So llama3.2-1b (L = 16, all stacked): 2L flash forwards, L dq, L dkv,
    4L RMSNorm forwards, 2L backwards; rwkv6-1.6b (L = 24): 6L RMSNorm
    forwards, 3L backwards; recurrentgemma-9b at 4 layers (one unit and an
    rglru tail): 4 flash forwards, 2 dq, 2 dkv, 14 RMSNorm forwards, 8
    backwards (``tests/test_torch_train_hybrid_ssm.py`` counts the same on
    the CPU).  An enc-dec model adds its encoder's ``attn`` layers (all
    stacked), and each decoder layer (``xattn``, all stacked) runs two
    flash calls (self- and cross-attention) and three norms; so
    seamless-m4t-large-v2 (24 + 24 layers): 144 flash forwards, 72 dq, 72
    dkv, 240 RMSNorm forwards, 120 backwards."""
    from repro_torch.models.model import decoder_pattern

    pattern = decoder_pattern(cfg)
    p = len(pattern)
    kinds = [pattern[i % p] for i in range(cfg.n_layers)] + ["attn"] * cfg.n_enc_layers
    runs = [2 if i < cfg.n_layers // p * p else 1 for i in range(cfg.n_layers)]
    runs += [2] * cfg.n_enc_layers
    norms = [3 if kind in ("rwkv", "xattn") else 2 for kind in kinds]
    attn = [2 if kind == "xattn" else int(kind.startswith("attn")) for kind in kinds]
    return {"flash_fwd": sum(r * a for r, a in zip(runs, attn)), "flash_bwd_dq": sum(attn),
            "flash_bwd_dkv": sum(attn), "rmsnorm_fwd": sum(r * n for r, n in zip(runs, norms)),
            "rmsnorm_bwd": sum(norms), "rglru_fwd": 0, "wkv6_fwd": 0}


def _pipeline_launches(cfg, n_micro) -> dict[str, int]:
    """Kernel launches of one 1F1B pipelined step of ``n_micro``
    microbatches (``repro_torch.models.pipeline``), from the model's
    structure: each of the L stacked units runs at its forward tick and
    again in its backward's recompute (no remat inside), one dq and one dkv
    per attention layer and microbatch, as many RMSNorm backwards as
    forwards per run; the final norm is the fused kernel here, one forward
    and one backward a microbatch at the last rank's forward tick.  Padded
    slots of a restaged plan run nothing.  So llama3.2-1b (L = 16): 2LM
    flash forwards, LM dq, LM dkv, 4LM + M RMSNorm forwards, 2LM + M
    backwards."""
    from repro_torch.models.model import decoder_pattern
    from repro_torch.models.pipeline import check_pipelineable

    units, pattern = check_pipelineable(cfg), decoder_pattern(cfg)
    attn = sum(kind.startswith("attn") for kind in pattern)
    norms = sum(3 if kind == "rwkv" else 2 for kind in pattern)
    m = units * n_micro
    return {"flash_fwd": 2 * attn * m, "flash_bwd_dq": attn * m, "flash_bwd_dkv": attn * m,
            "rmsnorm_fwd": 2 * norms * m + n_micro, "rmsnorm_bwd": norms * m + n_micro,
            "rglru_fwd": 0, "wkv6_fwd": 0}


def _train_cfg(arch, smoke=False, n_layers=None):
    """The trained configuration: bf16, the kernel settings, remat "dots"."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(arch).replace(
        attn_impl="pallas", norm_impl="fused", seq_impl="parallel", remat="dots",
        dtype="bfloat16")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
             cfg.vocab_size, cfg.tied_embeddings, cfg.window)
    want = TRAIN_SHAPES[(arch, smoke)]
    assert shape == (want[0] if n_layers is None else n_layers,) + want[1:], cfg
    return cfg


def _train_phase(torch, K, arch="llama3.2-1b", smoke=False, steps=TRAIN_STEPS,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, start=0, tag=None, n_layers=None, **extra):
    """Train ``arch`` (its smoke config with ``smoke``; ``n_layers`` deep when
    given) through the kernels with ``run_training``; the launch counts must
    equal ``_per_step_launches`` x the steps that ran (``steps - start``: a
    run restored at label ``start`` runs the rest).  ``extra`` goes to
    ``TrainSettings``.  Returns the launch counts, the config, the losses of
    the steps that ran, the summary and the timer database (not the session:
    its scheduler's routines hold the run's state, 17.3 GB on the card for
    llama3.2-1b at full width)."""
    from repro_torch.core import TimerLogger
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.models import model as M
    from repro_torch.timing import TimingSession

    cfg = _train_cfg(arch, smoke, n_layers)
    tag = tag or f"[train {arch}{' smoke' if smoke else ''}]"
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "train.jsonl")
        settings = TrainSettings(
            arch=arch, smoke=smoke, steps=steps, global_batch=batch,
            seq_len=seq, data_mode="copy", seed=SEED, report_every=0,
            log_path=log_path, device=DEVICE, **extra,
        )
        sess = TimingSession()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(K)
        t0 = time.perf_counter()
        summary = run_training(settings, cfg=cfg, session=sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(K)
        records = TimerLogger(log_path, sess.db).read_all()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    per_step = _per_step_launches(cfg)
    ran = steps - start
    assert launches == {k: v * ran for k, v in per_step.items()}, launches
    assert summary["iterations"] == steps and len(records) == ran, summary
    assert [r["iteration"] for r in records] == list(range(start, steps)), records
    losses = [r["extra"]["loss"] for r in records]
    assert all(math.isfinite(x) for x in losses), losses
    cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
    step_s = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = batch * seq  # text tokens: a vlm's patch prefix is not counted
    active = M.param_counts(cfg)[1]
    head = cfg.d_model * cfg.padded_vocab
    mfu = 6.0 * active * tokens / median_s / PEAK_FLOPS["bf16_tensor"]
    mfu_head = 6.0 * (active + head) * tokens / median_s / PEAK_FLOPS["bf16_tensor"]
    _print(f"{tag} {cfg.name} {'smoke config' if smoke else 'full width'}, {cfg.n_layers} "
           f"layers, bf16, remat dots, batch {batch} x seq {seq}, steps {start + 1}-{steps}: "
           f"wall_s={wall:.3f} launches={launches} (per step {per_step})")
    _print(f"{tag} losses={[round(x, 5) for x in losses]} "
           f"grad_norm={summary['final_metrics']['grad_norm']:.5f}")
    if smoke:  # a toy model's step times are launch overhead
        return launches, cfg, losses, summary, sess.db
    _print(f"{tag} step_s={[round(x, 5) for x in step_s]} "
           f"median_s(steps {start + 2}-{steps})={median_s:.5f} "
           f"tokens_per_s(EVOL, all steps)={ran * tokens / cum[-1]:.1f} "
           f"tokens_per_s(median step)={tokens / median_s:.1f} "
           f"mfu(6*{active}*tokens vs 989 TFLOP/s)={mfu:.4f} "
           f"mfu_with_lm_head(6*{active + head}*tokens)={mfu_head:.4f} "
           f"max_memory_allocated_GB={peak_gb:.3f}")
    n_prefix = M.prefix_positions(cfg)
    if n_prefix:  # the stack runs the patch prefix too
        positions = batch * (n_prefix + seq)
        _print(f"{tag} with the {n_prefix}-patch prefix the stack runs {positions} "
               f"positions a step: positions_per_s(median step)={positions / median_s:.1f} "
               f"mfu(6*{active}*positions)="
               f"{6.0 * active * positions / median_s / PEAK_FLOPS['bf16_tensor']:.4f}")
    if n_layers is not None:
        assert peak_gb < CUT_TRAIN_MAX_GB, (peak_gb, CUT_TRAIN_MAX_GB)
    if arch == "recurrentgemma-9b":
        _print(f"{tag} median_s={median_s:.5f} against {HYBRID_STEP_UNSPLIT_S} s with the "
               f"earlier hd-256 dkv kernel (ratio {median_s / HYBRID_STEP_UNSPLIT_S:.4f})")
    return launches, cfg, losses, summary, sess.db


def _router_key(torch, router) -> str:
    """A layer's router weight by its bits: the same in the forward and the
    backward's recompute, on two paths that share the weights, and in every
    process that holds the same weights, whatever its address (an FSDP
    gather makes a new tensor each call)."""
    import hashlib

    t = router.detach().contiguous()
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha1(bits.cpu().numpy().tobytes()).hexdigest()


@contextlib.contextmanager
def _routing_tap(torch, replay=None, rows=slice(None)):
    """Wrap ``moe.route`` inside the block; yields ``{key: (top_i, mask,
    keep, own)}``, what each MoE layer chose the first time it routed, in
    that order.  A layer's key is its router weight's bits
    (``_router_key``): the same in the forward and in the backward's
    recompute (which under remat runs the layers again, in reverse order).
    With ``replay`` (``{key: top_i}``) each layer routes with those
    choices, the groups ``rows`` of them (a sharded rank's batch rows),
    instead of its own (the indices only: gates and renormalised weights
    stay the path's own), and ``own`` is the top-k it would have chosen;
    else ``own`` is ``top_i``."""
    from repro_torch.models import moe

    route = moe.route
    seen = {}

    def tapped(cfg, router, x, top_i=None):
        key = _router_key(torch, router)
        given = None if replay is None else replay[key][rows].to(x.device)
        r = route(cfg, router, x, top_i=given)
        if key not in seen:
            with torch.no_grad():
                own = r.top_i if replay is None else torch.topk(r.gates, cfg.moe.top_k, -1)[1]
            seen[key] = (r.top_i.detach(), r.mask.bool(), r.keep, own)
        return r

    moe.route = tapped
    try:
        yield seen
    finally:
        moe.route = route


def _choice_share(torch, top_a, top_b, n_experts) -> float:
    """The share of ``top_b``'s (token, expert) choices that ``top_a`` makes too."""
    def chosen(top_i):
        return torch.zeros(top_i.shape[:-1] + (n_experts,), dtype=torch.bool,
                           device=top_i.device).scatter_(-1, top_i, True)
    a, b = chosen(top_a), chosen(top_b)
    return ((a & b).sum() / b.sum()).item()


def _loss_and_grads(torch, cfg, params, batch):
    """(loss, gradient norm, gradients as a list of leaves) of one step."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import global_norm

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = M.loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), global_norm(list(grads)).item(), grads


def _train_compare_phase(torch, cfg, batch_size=TRAIN_BATCH, seq=TRAIN_SEQ,
                         loss_rtol=TRAIN_RTOL, leaf_rtol=LEAF_RTOL, label="[train]",
                         f32_anchor=False, repeat=False, anchor_ratio=None):
    """One loss-and-gradient step, kernel path vs plain path, same weights and
    batch, on the card.  With ``f32_anchor`` it also prints each path's
    distance, leaf by leaf in relative norm, from the plain path in f32 on
    the same weights upcast: the rounding of the working dtype alone, which
    the kernel-vs-plain difference is to be read against.  With
    ``anchor_ratio`` (and ``f32_anchor``) the kernel path runs once more
    with every kernel swapped for its plain version (``_plain_kernels``),
    and leaf by leaf the kernel path may lie no farther from the f32 path
    than ``anchor_ratio`` times that one does: the kernels may round
    differently from their plain versions, not worse.  With ``repeat`` the
    kernel path's step runs a second time and must give the same bits.

    With experts (``cfg.moe``), the routing: in bf16 the two paths' rounding
    breaks near-ties in the top-k differently, and one moved choice sends a
    token to another expert and changes which tokens drop after it, so the
    plain path and the f32 anchor replay the kernel path's choices layer by
    layer (``_routing_tap``) and the share of choices they would have made
    alike is printed; in f32 each path routes on its own, and every choice
    must be the same."""
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map

    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, seq, batch_size, mode="copy",
                                        seed=SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    names = [name for name, _ in _named_leaves(params)]
    with _routing_tap(torch) as chosen:
        loss_k, gn_k, g_k = _loss_and_grads(torch, cfg, params, batch)
    if repeat:
        with _routing_tap(torch) as again:
            loss_r, gn_r, g_r = _loss_and_grads(torch, cfg, params, batch)
        assert all(torch.equal(again[key][0], chosen[key][0]) for key in chosen)
        assert loss_r == loss_k and gn_r == gn_k, (loss_r, loss_k, gn_r, gn_k)
        same = [name for name, a, b in zip(names, g_r, g_k) if not torch.equal(a, b)]
        assert not same, f"leaves whose gradient changed on a second call: {same}"
        del g_r
        _print(f"{label} the kernel path's loss-and-gradient step again: the same bits "
               f"(loss, gradient norm and all {len(names)} leaves)")
    replay = {key: tap[0] for key, tap in chosen.items()} if cfg.dtype == "bfloat16" else None
    with _routing_tap(torch, replay) as routed:
        loss_p, gn_p, g_p = _loss_and_grads(torch, plain, params, batch)
    if chosen:
        assert list(routed) == list(chosen)
        share = [_choice_share(torch, chosen[key][0], routed[key][3], cfg.moe.n_experts)
                 for key in chosen]
        how = ("the plain path replays the kernel path's choices; share it would have made "
               "alike" if replay else "each path routes on its own; share of choices equal")
        _print(f"{label} routing, {len(share)} MoE layers: {how}, by layer "
               f"{[round(x, 5) for x in share]}")
        if replay is None:
            assert min(share) == 1.0, share
    if f32_anchor:
        up = tree_map(lambda p: p.float(), params)
        with _routing_tap(torch, replay):
            loss_a, gn_a, g_a = _loss_and_grads(torch, plain.replace(dtype="float32"), up,
                                                batch)
        del up
        paths = [("kernel", g_k), ("plain", g_p)]
        if anchor_ratio is not None:
            with _plain_kernels():
                _, _, g_v = _loss_and_grads(torch, cfg, params, batch)
            paths.append(("kernel (plain versions)", g_v))
        dist = {}
        for path, grads in paths:
            dist[path] = {name: ((g.float() - a).norm() / a.norm()).item()
                          for name, g, a in zip(names, grads, g_a)}
            far = max(dist[path], key=dist[path].get)
            _print(f"{label} {path} path vs the plain path in f32 (loss {loss_a:.6f}, "
                   f"grad_norm {gn_a:.6f}): largest leaf relative error {dist[path][far]:.3e} "
                   f"({far}), median {sorted(dist[path].values())[len(names) // 2]:.3e}")
        del g_a
        if anchor_ratio is not None:
            mine, theirs = dist["kernel"], dist["kernel (plain versions)"]
            ratio = {name: mine[name] / theirs[name] for name in names}
            top = max(ratio, key=ratio.get)
            vs_plain = {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
                        for name, a, b in zip(names, g_k, g_v)}
            del g_v
            _print(f"{label} from the f32 path, the kernel path / the kernel path on plain "
                   f"versions: largest leaf ratio {ratio[top]:.4f} ({top}: {mine[top]:.3e} / "
                   f"{theirs[top]:.3e}; limit {anchor_ratio}), median "
                   f"{sorted(ratio.values())[len(ratio) // 2]:.4f}; kernels vs their plain "
                   f"versions, largest leaf {max(vs_plain.values()):.3e} "
                   f"({max(vs_plain, key=vs_plain.get)})")
            assert ratio[top] <= anchor_ratio, ratio
    rel = {}
    for name, a, b in zip(names, g_k, g_p):
        for tag, g in (("kernel", a), ("plain", b)):
            assert bool(torch.isfinite(g).all()) and g.abs().max().item() > 0, (tag, name)
        rel[name] = ((a.float() - b.float()).norm() / b.float().norm()).item()
    assert abs(loss_k - loss_p) <= loss_rtol * abs(loss_p), (loss_k, loss_p)
    assert abs(gn_k - gn_p) <= loss_rtol * gn_p, (gn_k, gn_p)
    worst = max(rel, key=rel.get)
    assert rel[worst] < leaf_rtol, rel
    _print(f"{label} one step on the card, kernel vs plain path: loss {loss_k:.6f} vs "
           f"{loss_p:.6f}; grad_norm {gn_k:.6f} vs {gn_p:.6f}; every leaf finite and nonzero; "
           f"worst leaf relative error {rel[worst]:.3e} ({worst}; limit {leaf_rtol})")
    _print(f"{label} relative error by leaf: "
           + ", ".join(f"{k}={v:.2e}" for k, v in rel.items()))
    return params, batch


def _train_profile_phase(torch, cfg, params, batch, tag="[profile-train]"):
    """Where a warm training step's time goes: one warm-up step, then one
    step under ``torch.profiler`` (device busy share = summed kernel time over
    the step's wall time, the profiler's host cost included).  Only the
    device is traced: rwkv6-1.6b's step runs its chunked WKV-6 as small
    host ops (over 100,000 kernel launches a step), whose host events the
    profiler would otherwise record and aggregate too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig, init_opt_state

    b, s = batch["tokens"].shape
    built = make_train_step(cfg, ShapeConfig("train", "train", s, b),
                            peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    opt_state = init_opt_state(AdamWConfig(), params)
    params, opt_state, metrics = built.fn(params, opt_state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ops(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    _print(f"{tag} one warm step: wall_s={wall:.4f} device_kernel_s={device_s:.4f} "
           f"device_busy_share={device_s / wall:.4f} kernel_launches="
           f"{sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _print(f"{tag}   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} "
               f"{e.key[:90]}")


def _smoke_phase(torch, K):
    """Head_dim 16 through the flash kernels: serve the llama3.2-1b and
    recurrentgemma-9b smoke configs (bf16, 2 layers / 4 layers of d_model 64
    with 4 heads of 16; recurrentgemma's MQA with window 16) through all the
    kernels, 4 requests of SMOKE_SEQ-token prompts, 8 new tokens, 2 slots,
    with exact launch counts (one flash forward per attention layer and
    prefill, one RG-LRU per recurrent layer and prefill, two RMSNorms per
    layer and call) and every prefill's logits against the plain path at the
    repo's bf16 model tolerance (tests/test_model_pallas_path.py: these
    configs, 128 tokens, atol 0.1, rtol 0.05); then train the llama3.2-1b
    smoke config SMOKE_STEPS steps (bf16, remat dots, batch 2 x SMOKE_SEQ)
    with exact flash forward/dq/dkv and RMSNorm launch counts and finite
    losses, and hold one loss-and-gradient step against the plain path in
    bf16 (the training phase's TRAIN_RTOL and LEAF_RTOL) and in f32 (loss
    and gradient norm to 1e-4 relative, each leaf to 1e-3 in relative norm,
    as tests/test_torch_cuda.py's every-leaf test).  The kernels' own
    instances at these shapes are held elementwise in phases 2 and 6."""
    from repro_torch.configs import get_smoke_config

    launches = {}
    for arch in ("llama3.2-1b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        kinds = cfg.layer_kinds()
        assert cfg.resolved_head_dim == 16, cfg
        launches[arch], engine, _ = _serve_phase(
            torch, K, arch, (SMOKE_SEQ,),
            {"flash_fwd": sum(kind.startswith("attn") for kind in kinds),
             "rglru_fwd": kinds.count("rglru")},
            {"rmsnorm_fwd": 2 * cfg.n_layers},
            (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, 16, cfg.vocab_size,
             cfg.window),
            ("elementwise", MODEL_ATOL), smoke=True, n_requests=4, max_new=8, n_slots=2)
        del engine
    launches["train"], cfg, *_ = _train_phase(torch, K, smoke=True, steps=SMOKE_STEPS,
                                              batch=2, seq=SMOKE_SEQ)
    _train_compare_phase(torch, cfg, batch_size=2, seq=SMOKE_SEQ, label="[train smoke bf16]")
    _train_compare_phase(torch, cfg.replace(dtype="float32"), batch_size=2, seq=SMOKE_SEQ,
                         loss_rtol=1e-4, leaf_rtol=1e-3, label="[train smoke f32]")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        _print(f"[smoke] {name} at head_dim 16: "
               + ", ".join(f"{_dtype_name(dtype)} {_kernel_note(K.fa, name, dtype, 16)}"
                           for dtype in (torch.bfloat16, torch.float32)))
    return launches


def _ckpt_root() -> str:
    """The first local directory with room for a full-width training state:
    the temporary directory, else the checkout's gitignored ``build/``."""
    for root in (tempfile.gettempdir(), str(ROOT / "build")):
        os.makedirs(root, exist_ok=True)
        usage = shutil.disk_usage(root)
        _print(f"[ckpt] {root}: total {usage.total / 1e9:.1f} GB, free {usage.free / 1e9:.1f} GB")
        if usage.free >= CKPT_FREE_BYTES:
            return root
    raise RuntimeError(f"no local directory with {CKPT_FREE_BYTES / 1e9:.0f} GB free")


def _payload_bytes(ckpt_path: str) -> int:
    """Array bytes of a checkpoint from its manifest (what ``io_bytes`` counts)."""
    import numpy as np

    with open(os.path.join(ckpt_path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return sum(math.prod(e["shape"]) * np.dtype(e["stored_dtype"]).itemsize for e in leaves)


def _ckpt_phase(torch, K):
    """Phase 17: checkpoint and resume full-width llama3.2-1b (module
    docstring)."""
    from repro_torch.checkpoint import CheckpointManager, validate_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.clocks import counter_channel
    from repro_torch.models import model as M
    from repro_torch.monitor import parse_exposition

    root = _ckpt_root()
    _print(f"[ckpt] checkpoints under {root}")

    # 1. the params' round trip through the manager, onto the card
    cfg = get_config("llama3.2-1b").replace(dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    named = dict(_named_leaves(params))
    tmp = tempfile.mkdtemp(prefix="ckpt_params_", dir=root)
    try:
        mgr = CheckpointManager(tmp, keep_n=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = mgr.save(0, params)
        mgr.wait()
        write_s = time.perf_counter() - t0
        path = mgr.checkpoints()[-1][1]
        file_bytes = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
        t0 = time.perf_counter()
        validate_checkpoint(path)
        validate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, tree, _ = mgr.restore_latest(device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mgr.close()
        got = dict(_named_leaves(tree))
        assert step == 0 and sorted(got) == sorted(named), sorted(got)
        for name, want in named.items():
            assert got[name].device.type == "cuda", name
            assert got[name].dtype == want.dtype == torch.bfloat16, name
            assert torch.equal(got[name], want), name
        n_params = sum(t.numel() for t in named.values())
        del tree, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, named
    _free(torch)
    _print(f"[ckpt] params round trip: {n_params} bf16 params, every leaf torch.equal after "
           f"restore_latest(device='cuda'), bf16 kept; bytes={stats['nbytes']:.0f} "
           f"(files {file_bytes}) blocking_s={stats['blocking_seconds']:.4f} "
           f"write_s(save+wait)={write_s:.4f} ({file_bytes / write_s / 1e9:.3f} GB/s) "
           f"validate_s={validate_s:.4f} ({file_bytes / validate_s / 1e9:.3f} GB/s) "
           f"restore_s(validate+load onto the card)={restore_s:.4f} "
           f"load_s(restore - validate)={restore_s - validate_s:.4f}")

    # 2. run A saves at shutdown (label 3), run B restores it and trains on,
    # both held to the same schedule run without a break
    _, _, train_losses, *_ = _train_phase(torch, K, n_layers=CKPT_LAYERS,
                                          tag="[ckpt uninterrupted]")
    _free(torch)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_train_", dir=root)
    textfile, status_path = ckpt_dir + ".prom", ckpt_dir + ".json"
    try:
        io_before = counter_channel("io_bytes")
        launches_a, _, losses_a, summary_a, db_a = _train_phase(
            torch, K, steps=CKPT_STEPS, n_layers=CKPT_LAYERS, tag="[ckpt run A]",
            lr_total_steps=TRAIN_STEPS,
            ckpt_dir=ckpt_dir, ckpt_mode="fixed", ckpt_every=1000,
            metrics_textfile=textfile, status_path=status_path)
        label = f"step_{CKPT_STEPS:08d}"
        assert sorted(os.listdir(ckpt_dir)) == [label], os.listdir(ckpt_dir)
        written = _payload_bytes(os.path.join(ckpt_dir, label))
        write_timer = db_a.get("CHECKPOINT/adaptcheck::write")
        shutdown_s = db_a.get("SHUTDOWN/driver::shutdown").seconds()
        # 3. the monitor surfaces of run A
        with open(textfile) as f:
            exp = parse_exposition(f.read())
        io_bytes = exp.value("repro_counter_total", channel="io_bytes") - io_before
        assert io_bytes == written, (io_bytes, written)
        saved = exp.value("repro_checkpoint_write_bytes_total")
        blocking_s = exp.value("repro_checkpoint_blocking_seconds_total")
        assert exp.value("repro_checkpoint_saves_total") == 1.0 and write_timer.count == 1
        with open(status_path) as f:
            status = json.load(f)["status"]
        assert status["iteration"] == CKPT_STEPS - 1, status
        assert status["loss"] == losses_a[-1], (status, losses_a)
        _free(torch)

        launches_b, _, losses_b, summary_b, db_b = _train_phase(
            torch, K, steps=TRAIN_STEPS, start=CKPT_STEPS, n_layers=CKPT_LAYERS,
            tag="[ckpt run B]",
            lr_total_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir, ckpt_mode="off", restore=True)
        resume = summary_b["resume"]
        assert (resume["selected_step"], resume["n_valid"], resume["n_quarantined"]) == \
            (CKPT_STEPS, 1, 0), resume
        assert sorted(os.listdir(ckpt_dir)) == [label], os.listdir(ckpt_dir)
        restore_timer = db_b.get("STARTUP/restore").seconds()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        for leftover in (textfile, status_path):
            if os.path.exists(leftover):
                os.remove(leftover)
    _free(torch)
    # run A is the uninterrupted run's first three steps, run B its last three
    for got, want in ((losses_a, train_losses[:CKPT_STEPS]),
                      (losses_b, train_losses[CKPT_STEPS:])):
        for a, b in zip(got, want):
            assert abs(a - b) <= TRAIN_RTOL * abs(b), (got, want)
    diff_b = max(abs(a - b) for a, b in zip(losses_b, train_losses[CKPT_STEPS:]))
    _print(f"[ckpt] run A saved label {CKPT_STEPS} at shutdown: bytes={saved:.0f} "
           f"(io_bytes sample {io_bytes:.0f} = the checkpoint's array bytes) "
           f"blocking_s={blocking_s:.4f} CHECKPOINT/adaptcheck::write_s={write_timer.seconds():.4f} "
           f"ckpt_fraction={summary_a['ckpt_fraction']:.4f} "
           f"SHUTDOWN_s(blocking save + wait until durable)={shutdown_s:.4f} "
           f"({written / max(shutdown_s - blocking_s, 1e-9) / 1e9:.3f} GB/s written after the "
           f"snapshot); textfile parses, status iteration {status['iteration']}")
    _print(f"[ckpt] run B restored label {resume['selected_step']} (valid {resume['n_valid']}, "
           f"quarantined {resume['n_quarantined']}): STARTUP/restore_s(validate+load onto the "
           f"card)={restore_timer:.4f} ({written / restore_timer / 1e9:.3f} GB/s), wrote nothing")
    _print(f"[ckpt] losses steps 4-6 resumed {[round(x, 6) for x in losses_b]} vs the "
           f"uninterrupted run's "
           f"{[round(x, 6) for x in train_losses[CKPT_STEPS:]]}: max |diff| {diff_b:.3e} "
           f"(limit {TRAIN_RTOL} relative), bitwise equal: {losses_b == train_losses[CKPT_STEPS:]}; "
           f"steps 1-3 of run A bitwise equal to the uninterrupted run's: "
           f"{losses_a == train_losses[:CKPT_STEPS]}")
    return {"run_a": launches_a, "run_b": launches_b}


def _train_family_phase(torch, K, arch, batch, seq, n_layers=None, leaf_rtol=LEAF_RTOL,
                        repeat=False, anchor_ratio=None):
    """Phases 18, 19 and 21: train ``arch`` at full width (``n_layers`` deep
    when given) through ``run_training`` on the card, TRAIN_STEPS AdamW
    steps, with exact launch counts, finite losses and the step's seconds,
    tokens/s, share of 989 TFLOP/s and peak memory; then hold one
    loss-and-gradient step against the plain path in bf16 (loss and
    gradient norm at TRAIN_RTOL, as phase 8; each leaf in relative norm
    under ``leaf_rtol``, each path's distance from the plain path in f32
    printed beside it; with ``repeat`` the kernel path's step again, bit for
    bit; with ``anchor_ratio`` each leaf held to the f32 path against the
    kernel path on the kernels' plain versions) and in f32 (loss and
    gradient norm to 1e-4, each leaf to 1e-3 in relative norm, as phase 16;
    at head_dim 256 the f32-FMA flash instances in a model); and profile one
    warm step."""
    tag = f"[train {arch}]"
    launches, cfg, *_ = _train_phase(torch, K, arch=arch, batch=batch, seq=seq,
                                     n_layers=n_layers, tag=tag)
    _free(torch)
    params, data = _train_compare_phase(torch, cfg, batch_size=batch, seq=seq,
                                        leaf_rtol=leaf_rtol, label=f"{tag} bf16",
                                        f32_anchor=True, repeat=repeat,
                                        anchor_ratio=anchor_ratio)
    _train_profile_phase(torch, cfg, params, data, tag=f"[profile-train {arch}]")
    del params, data
    _free(torch)
    _train_compare_phase(torch, cfg.replace(dtype="float32"), batch_size=batch, seq=seq,
                         loss_rtol=1e-4, leaf_rtol=1e-3, label=f"{tag} f32")
    _free(torch)
    return launches


def _routing_phase(torch, engine):
    """Per layer, the share of the (token, expert) choices of one prefill
    (request 0's prompt) on which the kernel path and the plain path agree,
    and of the choices that kept a slot: a near-tie that the paths' rounding
    breaks differently moves a choice, and under capacity the drops after it
    (``_routing_tap`` records the two prefills, layer by layer)."""
    import numpy as np

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model as M

    cfg = engine.cfg
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    prompt = make_requests(cfg.vocab_size, 1, PROMPT_LENS, 1, np.random.default_rng(SEED))[0].prompt
    tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    seen = {}
    for path, c in (("kernel", cfg), ("plain", plain)):
        with _routing_tap(torch) as seen[path]:
            M.prefill(c, engine.params, {"tokens": tokens},
                      M.init_cache(c, 1, engine.max_seq, device="cuda"))
    assert list(seen["kernel"]) == list(seen["plain"]) and len(seen["plain"]) == cfg.n_layers
    chosen, kept, dropped = [], [], []
    for key, (_, mask_p, keep_p, _) in seen["plain"].items():
        _, mask_k, keep_k, _ = seen["kernel"][key]
        chosen.append(((mask_k & mask_p).sum() / mask_p.sum()).item())
        kept.append(((keep_k & keep_p).sum() / keep_p.sum()).item())
        dropped.append((int((mask_k & ~keep_k).sum()), int((mask_p & ~keep_p).sum())))
    tag = f"[routing {cfg.name}]"
    _print(f"{tag} one prefill of {len(prompt)} tokens, top {cfg.moe.top_k} of "
           f"{cfg.moe.n_experts}: kernel vs plain path, share of choices equal by layer: "
           f"{[round(x, 4) for x in chosen]}; min {min(chosen):.4f} mean "
           f"{sum(chosen) / len(chosen):.4f}")
    _print(f"{tag} share of kept (token, expert) slots equal by layer: "
           f"{[round(x, 4) for x in kept]}; min {min(kept):.4f} mean {sum(kept) / len(kept):.4f}")
    _print(f"{tag} dropped choices by layer (kernel, plain): {dropped}")


def _moe_phase(torch, K):
    """Phase 20: serve full-width moonshot-v1-16b-a3b (module docstring)."""
    launches, engine, sess = _serve_phase(
        torch, K, "moonshot-v1-16b-a3b", PROMPT_LENS, {"flash_fwd": MOE_SHAPE[0]},
        {"rmsnorm_fwd": 2 * MOE_SHAPE[0]}, MOE_SHAPE, ("relnorm", RECURRENT_REL))
    _routing_phase(torch, engine)
    _profile_phase(torch, engine, sess, PROMPT_LENS, "[profile moonshot-v1-16b-a3b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "moonshot-v1-16b-a3b", MOE_F32_LAYERS, PROMPT_LENS)
    _free(torch)
    return launches


def _moe_train_phase(torch, K):
    """Phase 21: train moonshot-v1-16b-a3b at 4 layers (module docstring)."""
    cfg = _train_cfg("moonshot-v1-16b-a3b", n_layers=MOE_TRAIN_LAYERS)
    assert _per_step_launches(cfg) == MOE_TRAIN_PER_STEP, _per_step_launches(cfg)
    return _train_family_phase(torch, K, "moonshot-v1-16b-a3b", TRAIN_BATCH, TRAIN_SEQ,
                               n_layers=MOE_TRAIN_LAYERS, repeat=True)


def _vlm_phase(torch, K):
    """Phase 22: serve full-width internvl2-26b (module docstring)."""
    n_layers = VLM_SHAPE[0]
    launches, engine, sess = _serve_phase(
        torch, K, "internvl2-26b", PROMPT_LENS, {"flash_fwd": n_layers},
        {"rmsnorm_fwd": 2 * n_layers}, VLM_SHAPE, ("anchor", ANCHOR_RATIO))
    # each slot holds the patch prefix, the longest prompt and its new tokens
    assert engine.max_seq == VLM_PATCHES + max(PROMPT_LENS) + MAX_NEW + 8, engine.max_seq
    _profile_phase(torch, engine, sess, PROMPT_LENS, "[profile internvl2-26b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "internvl2-26b", VLM_F32_LAYERS, PROMPT_LENS)
    _free(torch)
    return launches


def _vlm_train_phase(torch, K):
    """Phase 23: train internvl2-26b at 4 layers (module docstring)."""
    cfg = _train_cfg("internvl2-26b", n_layers=VLM_TRAIN_LAYERS)
    # four attention layers with a dense MLP each: phase 21's launches a step
    assert _per_step_launches(cfg) == MOE_TRAIN_PER_STEP, _per_step_launches(cfg)
    return _train_family_phase(torch, K, "internvl2-26b", TRAIN_BATCH, TRAIN_SEQ,
                               n_layers=VLM_TRAIN_LAYERS, repeat=True)


def _encdec_frames_phase(torch, engine, tol):
    """Phase 24's check of the encoder and the cross-attention, which the
    engine's zero source frames leave out (RMSNorm of zeros is zero, so
    their encoder output, cross K/V and cross-attention outputs are zero):
    outside the engine, on the served weights, a prefill from seeded random
    source frames (0.02 x N(0, 1), as the synthetic data's) and
    ENCDEC_DECODE_STEPS decode steps of given tokens, on the kernel path,
    the plain path and the plain path in f32 (its stacked units upcast one
    at a time).  The prompts of PROMPT_LENS from as many frames, then the
    short prompt from the long prompt's frame count (S != T in every
    cross-attention).  The kernel path's logits are held to the plain
    path's under ``tol`` (``_hold``); each path's distance from the f32
    path and the share of logits past phase 4's elementwise tolerance are
    printed first."""
    from repro_torch.models import model as M

    cfg = engine.cfg
    plain = cfg.replace(attn_impl="chunked", norm_impl="ref")
    paths = (("kernel", cfg, engine.params), ("plain", plain, engine.params),
             ("f32", plain.replace(dtype="float32"), _f32_outside_units(engine.params)))
    rng = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tag = f"[serve {cfg.name} random frames]"
    held = []
    for n_tok, n_src in [(n, n) for n in PROMPT_LENS] + [(min(PROMPT_LENS), max(PROMPT_LENS))]:
        tokens = torch.randint(0, cfg.vocab_size, (1, n_tok + ENCDEC_DECODE_STEPS),
                               generator=rng, device="cuda", dtype=torch.int32)
        batch = {"tokens": tokens[:, :n_tok],
                 "src_frames": 0.02 * torch.randn((1, n_src, cfg.d_model), generator=rng,
                                                  device="cuda")}
        logits = {}
        for name, c, p in paths:
            with _f32_units(torch) if name == "f32" else contextlib.nullcontext():
                cache, first = M.prefill(c, p, batch, M.init_cache(c, 1, engine.max_seq,
                                                                   device="cuda"))
                assert cache["scan"][0]["xlen"].tolist() == [[n_src]] * cfg.n_layers
                out = [first]
                for i in range(n_tok, n_tok + ENCDEC_DECODE_STEPS):
                    cache, step = M.decode_step(c, p, cache, tokens[:, i : i + 1])
                    out.append(step)
            logits[name] = torch.cat(out)[:, : cfg.vocab_size].float()
            del cache, out
        lk, lp, la = logits["kernel"], logits["plain"], logits["f32"]
        assert bool(torch.isfinite(lk).all()), (n_tok, n_src)
        outside = ((lk - lp).abs() > MODEL_ATOL + MODEL_RTOL * lp.abs()).float().mean().item()
        plain_outside = ((lp - la).abs() > MODEL_ATOL + MODEL_RTOL * la.abs()).float().mean()
        _print(f"{tag} prompt {n_tok} from {n_src} frames, prefill and {ENCDEC_DECODE_STEPS} "
               f"decode steps: kernel vs plain max_abs_diff={(lk - lp).abs().max().item():.4f} "
               f"rel_l2={_rel(lk, lp):.4e}, share outside atol {MODEL_ATOL} rtol {MODEL_RTOL} "
               f"{outside:.4f} (plain vs f32: {plain_outside.item():.4f}); relative L2 from the "
               f"f32 path: kernel {_rel(lk, la):.5f}, plain {_rel(lp, la):.5f}; argmax equal "
               f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}")
        held.append((lk, lp, la))
    for lk, lp, la in held:
        _hold(torch, lk, lp, tol, la)
    _print(f"{tag} held under {tol}")


def _encdec_phase(torch, K):
    """Phase 24: serve full-width seamless-m4t-large-v2 (module docstring)."""
    launches, engine, sess = _serve_phase(
        torch, K, "seamless-m4t-large-v2", PROMPT_LENS, ENCDEC_PER_PREFILL, ENCDEC_PER_CALL,
        ENCDEC_SHAPE, ("elementwise", MODEL_ATOL))
    assert engine.cfg.n_enc_layers == ENCDEC_ENC_LAYERS, engine.cfg
    _encdec_frames_phase(torch, engine, ("elementwise", MODEL_ATOL))
    _profile_phase(torch, engine, sess, PROMPT_LENS, "[profile seamless-m4t-large-v2]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "seamless-m4t-large-v2", ENCDEC_SHAPE[0], PROMPT_LENS)
    _free(torch)
    return launches


def _encdec_train_phase(torch, K):
    """Phase 25: train seamless-m4t-large-v2 at full depth (module docstring)."""
    cfg = _train_cfg("seamless-m4t-large-v2")
    assert cfg.n_enc_layers == ENCDEC_ENC_LAYERS, cfg
    assert _per_step_launches(cfg) == ENCDEC_TRAIN_PER_STEP, _per_step_launches(cfg)
    return _train_family_phase(torch, K, "seamless-m4t-large-v2", TRAIN_BATCH, TRAIN_SEQ,
                               repeat=True, anchor_ratio=ANCHOR_RATIO)


def _pipeline_kernels_phase(torch, F, K, gen):
    """Phase 26's kernels at the shapes one microbatch gives them inside the
    stages (batch 1 x TRAIN_SEQ, llama3.2-1b's 32/8 heads of 64 causal
    bf16; RMSNorm rows of 1024 x 2048), held against their plain versions
    and timed as phases 2, 3, 6 and 7 time theirs.  Returns ``{kernel:
    row}``."""
    return _training_kernels_rows(torch, F, K, gen, 1, (32, 8), "[pipeline kernels]",
                                  "at one microbatch")


def _training_kernels_rows(torch, F, K, gen, b, heads, tag, where, s=TRAIN_SEQ, hd=64, d=2048,
                           only=None):
    """The five training kernels at the shapes of a batch of ``b`` x ``s``
    (llama3.2-1b's by default): ``heads`` (q, KV) heads of ``hd``, causal
    bf16, and RMSNorm rows of ``b`` x ``s`` x ``d``: held against their
    plain versions and timed as phases 2, 3, 6 and 7 time theirs (those
    named in ``only``, when given).  Returns ``{kernel: row}``."""
    fa_ops, rn_ops = K.fa, K.rn
    h, kv = heads
    n = b * s
    q = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((b, s, h, hd), generator=gen, device=DEVICE).to(torch.bfloat16)
    out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=None)
    ref_out, _ = fa_ops.flash_fwd_plain(q, k, v, causal=True, window=None)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq = fa_ops.flash_bwd_dq(*args, causal=True, window=None)
    dk, dv = fa_ops.flash_bwd_dkv(*args, causal=True, window=None)
    dk2, dv2 = fa_ops.flash_bwd_dkv(*args, causal=True, window=None)
    torch.cuda.synchronize()
    # the split's partials are added in a fixed order: the same bits again
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv), tag
    del dk2, dv2
    plan = fa_ops.dkv_plan(b, s, kv, h // kv, hd, torch.bfloat16,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    _print(f"{tag} flash_bwd_dkv {where}: split={plan['split']} grid={plan['blocks']} blocks "
           f"launches_per_call={plan['launches']} workspace_MB="
           f"{plan['workspace_bytes'] / 1e6:.2f}; a second call bit-equal "
           f"{_kernel_note(fa_ops, 'flash_bwd_dkv', torch.bfloat16, hd, plan['split'])}")
    ref_dq = fa_ops.flash_bwd_dq_plain(*args, causal=True, window=None)
    ref_dk, ref_dv = fa_ops.flash_bwd_dkv_plain(*args, causal=True, window=None)
    x = torch.randn((n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=DEVICE)).to(torch.bfloat16)
    dy = torch.randn((n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    y = rn_ops.rms_norm_fused(x, w, 1e-5)
    dx, dw = rn_ops.rms_norm_bwd(x, w, dy, 1e-5)
    ref_y = rn_ops.rms_norm_plain(x, w, 1e-5)
    ref_dx, ref_dw = rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    tol, gtol = KERNEL_TOL["bfloat16"], GRAD_TOL["bfloat16"]
    for got, want, t in ((out, ref_out, tol), (dq, ref_dq, gtol), (dk, ref_dk, gtol),
                         (dv, ref_dv, gtol), (y, ref_y, tol), (dx, ref_dx, tol),
                         (dw, ref_dw, DW_TOL["bfloat16"])):
        torch.testing.assert_close(got.float(), want.float(), atol=t, rtol=t)
    nbytes = lambda *xs: sum(t.numel() * t.element_size() for t in xs)  # noqa: E731
    pairs = b * s * (s + 1) // 2
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd = _device_ms(torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                              retain_graph=True))
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    yl = F.rms_norm(xl, (d,), wl, 1e-5)
    attn, norm = f"B={b} S=T={s} {h}/{kv} heads of {hd} causal bf16", f"({n}, {d}) bf16"
    cases = [
        ("flash_fwd", attn, err(out, ref_out), lambda: fa_ops.flash_fwd(q, k, v, causal=True),
         lambda: fa_ops.flash_fwd_plain(q, k, v, causal=True, window=None),
         _device_ms(torch, lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True)),
         nbytes(q, k, v, out, lse), 4.0 * h * pairs * hd, "bf16_tensor"),
        ("flash_bwd_dq", attn, err(dq, ref_dq), lambda: fa_ops.flash_bwd_dq(*args, causal=True),
         lambda: fa_ops.flash_bwd_dq_plain(*args, causal=True, window=None), sdpa_bwd,
         nbytes(q, k, v, do, lse, delta, dq), 6.0 * h * pairs * hd, "bf16_tensor"),
        ("flash_bwd_dkv", attn, max(err(dk, ref_dk), err(dv, ref_dv)),
         lambda: fa_ops.flash_bwd_dkv(*args, causal=True),
         lambda: fa_ops.flash_bwd_dkv_plain(*args, causal=True, window=None), sdpa_bwd,
         nbytes(q, k, v, do, lse, delta, dk, dv), 8.0 * h * pairs * hd, "bf16_tensor"),
        ("rmsnorm_fwd", norm, err(y, ref_y), lambda: rn_ops.rms_norm_fused(x, w, 1e-5),
         lambda: rn_ops.rms_norm_plain(x, w, 1e-5),
         _device_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5)),
         2 * nbytes(x) + nbytes(w), 4.0 * n * d, "f32"),
        ("rmsnorm_bwd", norm, max(err(dx, ref_dx), err(dw, ref_dw)),
         lambda: rn_ops.rms_norm_bwd(x, w, dy, 1e-5),
         lambda: rn_ops.rms_norm_bwd_plain(x, w, dy, 1e-5),
         _device_ms(torch, lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)),
         3 * nbytes(x) + nbytes(w) + 4 * d, 10.0 * n * d, "f32"),
    ]
    rows = {}
    for name, shape, e, fn, plain, library_ms, moved, flops, peak in cases:
        if only is not None and name not in only:
            continue
        ms, plain_ms = _device_ms(torch, fn), _device_ms(torch, plain)
        bound_ms, bound_by = _bound_ms(moved, flops, peak)
        rows[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        _print(f"{tag} {name} {where}, {shape}: max_abs_err={e:.3e} "
               f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_us={1e3 * bound_ms:.3f} "
               f"({bound_by}) library_ms={library_ms:.5f} {_shares(ms, bound_ms, library_ms)}")
    return rows


def _pipeline_launcher_phase(torch, K):
    """Phase 26 (a): ``run_training`` on full-width llama3.2-1b through the
    1F1B schedule with one stage (the reference's tier-1 and drill setting:
    the whole tick clock still runs), PIPE_MICRO microbatches of batch
    TRAIN_BATCH x TRAIN_SEQ, PIPE_STEPS steps, the launches exact."""
    from repro_torch.core import TimerLogger
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.timing import TimingSession

    cfg = _train_cfg("llama3.2-1b")
    per_step = _pipeline_launches(cfg, PIPE_MICRO)
    assert per_step == PIPE_PER_STEP, per_step
    tag = "[pipeline llama3.2-1b]"
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "train.jsonl")
        settings = TrainSettings(
            arch="llama3.2-1b", smoke=False, steps=PIPE_STEPS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, data_mode="copy", seed=SEED, report_every=0, ckpt_mode="off",
            log_path=log_path, device=DEVICE, pipeline_stages=1, pipeline_model=True,
            pipeline_micro=PIPE_MICRO)
        sess = TimingSession()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(K)
        t0 = time.perf_counter()
        summary = run_training(settings, cfg=cfg, session=sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(K)
        records = TimerLogger(log_path, sess.db).read_all()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches == {k: v * PIPE_STEPS for k, v in per_step.items()}, launches
    losses = [r["extra"]["loss"] for r in records]
    assert len(losses) == PIPE_STEPS and all(math.isfinite(x) for x in losses), losses
    cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
    step_s = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    pipe = summary["pipeline"]
    assert pipe["n_stages"] == 1 and pipe["workload"] == cfg.name and pipe["depths"] == {0: cfg.n_layers}
    phases = {name: round(sec / PIPE_STEPS, 5) for name, sec in pipe["phase_seconds"].items()}
    _print(f"{tag} run_training, pipeline_stages=1 pipeline_model=True pipeline_micro="
           f"{PIPE_MICRO}, bf16, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {PIPE_STEPS} steps: "
           f"wall_s={wall:.3f} launches={launches} (per step {per_step})")
    _print(f"{tag} summary['pipeline']={json.dumps(pipe)}")
    _print(f"{tag} losses={[round(x, 5) for x in losses]} step_s={[round(x, 5) for x in step_s]} "
           f"median_s(steps 2-{PIPE_STEPS})={median_s:.5f} tokens_per_s(median step)="
           f"{TRAIN_BATCH * TRAIN_SEQ / median_s:.1f} phase_s_per_step={phases} "
           f"max_memory_allocated_GB={peak_gb:.3f}")
    return launches


def _pipeline_grads(torch, built, params, batch):
    """(loss, gradient leaves) of one pipelined loss-and-gradient call."""
    from repro_torch.models.layers import tree_leaves

    loss, grads = built.pipeline_call(params, batch)
    return loss.item(), tree_leaves(grads)


def _pipeline_ranks_phase(torch, K):
    """Phase 26 (b) and (c): PIPE_RANKS ranks on one card (an explicit
    ``Mesh`` that repeats it), 16 units over 4 stages, PIPE_RANK_MICRO
    microbatches; the equal plan against the non-pipelined kernel path, the
    restaged plan bit-equal to it with equal launches, f32 at
    PIPE_F32_LAYERS layers at the f32 model tolerance, and one profiled
    warm step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.meshutil import Mesh
    from repro_torch.dist.pipeline import StagePlan, phase_ticks
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.optim import AdamWConfig, global_norm, init_opt_state

    tag = f"[pipeline {PIPE_RANKS} ranks]"
    mesh = Mesh([torch.device(DEVICE, 0)] * PIPE_RANKS, ("pod",))
    phase_s = {}

    @contextlib.contextmanager
    def timed_phase(name):
        t0 = time.perf_counter()
        yield  # the step synchronizes the card before the scope closes
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0

    def build(cfg, plan):
        return make_transformer_pipeline_train_step(
            cfg, mesh, plan, seq_len=TRAIN_SEQ, global_batch=PIPE_RANK_BATCH,
            n_micro=PIPE_RANK_MICRO, seed=SEED, device=DEVICE, phase_cb=timed_phase,
            peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)

    def data(cfg):
        b = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, PIPE_RANK_BATCH,
                                        mode="copy", seed=SEED), arch=cfg).batch_at(0)
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}

    cfg = _train_cfg("llama3.2-1b")
    plan = StagePlan.equal(range(PIPE_RANKS), cfg.n_layers)
    built = build(cfg, plan)
    params, batch = built.init_params(), data(cfg)
    names = [name for name, _ in _named_leaves(params)]
    want = _pipeline_launches(cfg, PIPE_RANK_MICRO)
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(K)
    loss_e, g_e = _pipeline_grads(torch, built, params, batch)
    torch.cuda.synchronize()
    launches = _read_counters(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches == want, (launches, want)
    # what phase 29's processes are held to, bit for bit
    ref = {"loss": loss_e, "grads": {name: _digest(torch, g) for name, g in zip(names, g_e)}}
    depths_equal = plan.depths()
    plan.set_weight(1, 0.5)
    _zero_counters(K)
    loss_r, g_r = _pipeline_grads(torch, built, params, batch)
    torch.cuda.synchronize()
    assert _read_counters(K) == launches, _read_counters(K)
    assert loss_r == loss_e, (loss_r, loss_e)
    moved = [name for name, a, b in zip(names, g_e, g_r) if not torch.equal(a, b)]
    assert not moved, f"leaves whose gradient changed with the restage: {moved}"
    _print(f"{tag} {cfg.name} full width, bf16, {PIPE_RANK_MICRO} microbatches of batch "
           f"{PIPE_RANK_BATCH // PIPE_RANK_MICRO} x seq {TRAIN_SEQ}, ranks on "
           f"{[str(d) for d in mesh.devices.flat]}: equal plan depths {depths_equal} and "
           f"restaged plan (stage 1 at weight 0.5) depths {plan.depths()} (max depth "
           f"{plan.max_depth()}, {PIPE_RANKS * plan.max_depth() - cfg.n_layers} padded slots): "
           f"loss {loss_e:.6f}, every one of {len(names)} gradient leaves and the launches "
           f"{launches} bit-equal; peak memory of the call {peak_gb:.3f} GB")
    del g_r
    # the non-pipelined kernel path from the same weights and batch
    loss_n, gn_n, g_n = _loss_and_grads(torch, cfg, params, batch)
    gn_e = global_norm(list(g_e)).item()
    rel = {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for name, a, b in zip(names, g_e, g_n)}
    for name, g in zip(names, g_e):
        assert bool(torch.isfinite(g).all()) and g.abs().max().item() > 0, name
    worst = max(rel, key=rel.get)
    assert abs(loss_e - loss_n) <= TRAIN_RTOL * abs(loss_n), (loss_e, loss_n)
    assert abs(gn_e - gn_n) <= TRAIN_RTOL * gn_n, (gn_e, gn_n)
    assert rel[worst] < LEAF_RTOL, rel
    _print(f"{tag} pipelined vs the non-pipelined kernel path (remat dots, one batch of "
           f"{PIPE_RANK_BATCH}): loss {loss_e:.6f} vs {loss_n:.6f}; grad_norm {gn_e:.6f} vs "
           f"{gn_n:.6f}; worst leaf relative error {rel[worst]:.3e} ({worst}; limit "
           f"{LEAF_RTOL}), median {sorted(rel.values())[len(rel) // 2]:.3e}")
    del g_e, g_n
    _free(torch)

    # (c) one warm step of (b), the optimizer included, under the profiler
    opt_state = init_opt_state(AdamWConfig(), params)
    params, opt_state, metrics = built.fn(params, opt_state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    ref["params1"] = {name: _digest(torch, leaf) for name, leaf in _named_leaves(params)}
    phase_s.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_ops(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    ticks = PIPE_RANK_MICRO + 2 * PIPE_RANKS - 1
    ref["warm"] = dict(wall_s=wall, busy=device_s / wall, ops=sum(e.count for e in kernels))
    _print(f"[profile-train pipeline {PIPE_RANKS} ranks] one warm step (AdamW included): "
           f"wall_s={wall:.4f} device_kernel_s={device_s:.4f} device_busy_share="
           f"{device_s / wall:.4f} device_operations={sum(e.count for e in kernels)} "
           f"ms_per_tick={1e3 * wall / ticks:.3f} of which the card waited on the host "
           f"{1e3 * (wall - device_s) / ticks:.3f} ({ticks} ticks) "
           f"phase_s={ {k: round(v, 5) for k, v in phase_s.items()} } (ticks "
           f"{phase_ticks(PIPE_RANK_MICRO, PIPE_RANKS)}); the {PIPE_RANKS} ranks share one "
           f"card and run one after another, so these phase times hold no bubble")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _print(f"[profile-train pipeline {PIPE_RANKS} ranks]   "
               f"{e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")
    del params, opt_state, metrics, built, prof
    _free(torch)

    # f32 at PIPE_F32_LAYERS layers: pipelined against non-pipelined at 2e-4
    cfg32 = cfg.replace(dtype="float32", n_layers=PIPE_F32_LAYERS)
    built = build(cfg32, StagePlan.equal(range(PIPE_RANKS), PIPE_F32_LAYERS))
    params, batch = built.init_params(), data(cfg32)
    loss_p, g_p = _pipeline_grads(torch, built, params, batch)
    loss_n, _, g_n = _loss_and_grads(torch, cfg32, params, batch)
    diff = {name: (a - b).abs().max().item()
            for name, a, b in zip([n for n, _ in _named_leaves(params)], g_p, g_n)}
    worst = max(diff, key=diff.get)
    assert abs(loss_p - loss_n) <= F32_ATOL, (loss_p, loss_n)
    assert diff[worst] <= F32_ATOL, diff
    _print(f"{tag} f32 at {PIPE_F32_LAYERS} layers, one unit a rank: loss {loss_p:.7f} vs "
           f"non-pipelined {loss_n:.7f}; largest gradient difference {diff[worst]:.3e} "
           f"({worst}; limit {F32_ATOL})")
    del built, params, batch, g_p, g_n
    _free(torch)
    return launches, ref


def _digest(torch, t) -> str:
    """SHA-1 of a tensor's bytes: phase 29 holds its leaves bit for bit."""
    import hashlib

    host = t.detach().contiguous().cpu().reshape(-1)
    return hashlib.sha1(host.view(torch.uint8).numpy()).hexdigest()


def _pipeline_phase(torch, F, K, gen):
    """Phase 26: llama3.2-1b through the 1F1B pipeline schedule (module
    docstring).  Returns the kernels' rows at one microbatch's shapes, the
    launches of (a) and (b), and (b)'s and (c)'s results that phase 29 is
    held to."""
    t0 = time.perf_counter()
    rows = _pipeline_kernels_phase(torch, F, K, gen)
    _free(torch)
    launches = {"pipeline": _pipeline_launcher_phase(torch, K)}
    _free(torch)
    launches["pipeline_4"], ref = _pipeline_ranks_phase(torch, K)
    _print(f"[pipeline] phase 26 took {time.perf_counter() - t0:.1f} s")
    return rows, launches, ref


# phase 27: the serving soak's wall-clock budget and scrape cadence, the
# training soak's, and the real-process fleet run beside the seeded drill
SOAK_BUDGET_S, SOAK_INTERVAL_S = 20.0, 2.0
SOAK_TRAIN_BUDGET_S, SOAK_TRAIN_INTERVAL_S = 5.0, 0.5
# full-width llama3.2-1b: 16 flash forwards a prefill, 32 RMSNorm forwards a
# model call (prefill or decode step), as phase 4
SOAK_PER_PREFILL, SOAK_PER_CALL = {"flash_fwd": 16}, {"rmsnorm_fwd": 32}
# the real fleet: 2 ranks, a join at poll 6, a SIGKILL at poll 18. On the
# H100 host a rank that starts cold may first beat more than 0.8 s after the
# launcher publishes its membership (at a 0.8 s timeout rank 0 was fenced
# at poll 7, before its kill), so the liveness timeout leaves seconds of
# margin, and the run lasts long enough for the kill to expire (polls take
# at least 0.1 s each)
FLEET_POLLS, FLEET_LIVENESS_S = 60, 2.5


def _soak_serve_phase(torch, K):
    """Phase 27 (a): the serving soak at full width through the kernels,
    scraped over HTTP; returns its launches."""
    from repro_torch.models import model as M
    from repro_torch.soak import SoakConfig, run_soak

    decode_s = []
    decode_step = M.decode_step

    def timed_decode(*args, **kwargs):  # the engine syncs right after, so this adds no wait
        t0 = time.perf_counter()
        out = decode_step(*args, **kwargs)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    M.decode_step = timed_decode
    _zero_counters(K)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as out_dir:
            cfg = SoakConfig(mode="serve", smoke=False, arch="llama3.2-1b", attn_impl="pallas",
                             norm_impl="fused", dtype="bfloat16", device="cuda",
                             budget_s=SOAK_BUDGET_S, interval_s=SOAK_INTERVAL_S, seed=SEED,
                             out_dir=out_dir)
            t0 = time.perf_counter()
            result = run_soak(cfg)
            wall = time.perf_counter() - t0
            n_pages = len(os.listdir(out_dir))
    finally:
        M.decode_step = decode_step
    launches = _read_counters(K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = result.summary
    prefills, decodes = summary["prefills"], summary["decode_steps"]
    expected = {name: SOAK_PER_PREFILL.get(name, 0) * prefills
                + SOAK_PER_CALL.get(name, 0) * (prefills + decodes) for name, _, _ in COUNTERS}
    assert result.failures == [], result.failures
    assert summary["completed"] > 0, summary
    assert len(result.snapshots) >= cfg.min_snapshots, len(result.snapshots)
    assert n_pages == len(result.snapshots)
    assert all(snap.source == "http" and snap.parse_error is None for snap in result.snapshots)
    assert launches == expected, (launches, expected, prefills, decodes)
    assert len(decode_s) == decodes > 0, (len(decode_s), decodes)
    adapt = summary["adapt"]
    _print(f"[soak serve] llama3.2-1b full width, {SOAK_BUDGET_S:g} s budget, scrape every "
           f"{SOAK_INTERVAL_S:g} s over HTTP: wall_s={wall:.3f} steps={result.steps} "
           f"submitted={summary['submitted']} completed={summary['completed']:g} "
           f"shed={summary['shed']:g} prefills={prefills} decode_steps={decodes} "
           f"snapshots={len(result.snapshots)} launches={launches}")
    _print(f"[soak serve] ADAPT actions {adapt['n_actions']}: {adapt['action_counts']}; "
           f"median decode step {1e3 * sorted(decode_s)[len(decode_s) // 2]:.4f} ms (SLO "
           f"target 5 ms); max_memory_allocated_GB={peak_gb:.3f}; invariants held on "
           f"{len(result.snapshots)} scraped pages")
    del result
    return launches


def _soak_phase(torch, K):
    """Phase 27: soak and fleet (module docstring).  Returns (a)'s launches."""
    from repro_torch.faults import soak as drills
    from repro_torch.fleet.drill import run_drill
    from repro_torch.fleet.launch import FleetSettings, run_fleet
    from repro_torch.monitor.promparse import parse_exposition
    from repro_torch.soak import SoakConfig, run_soak

    t0 = time.perf_counter()
    launches = _soak_serve_phase(torch, K)
    _free(torch)

    # (b) the training soak: the simulated fleet under seeded faults
    result = run_soak(SoakConfig(mode="train", device="cuda", budget_s=SOAK_TRAIN_BUDGET_S,
                                 interval_s=SOAK_TRAIN_INTERVAL_S, seed=SEED))
    assert result.failures == [], result.failures
    assert result.summary["faults_injected"] > 0, result.summary
    _print(f"[soak train] {result.steps} steps, {len(result.snapshots)} snapshots, "
           f"faults_injected={result.summary['faults_injected']} "
           f"evicted={result.summary['evicted_hosts']} "
           f"ADAPT {result.summary['adapt']['action_counts']}")

    # (c) the fault drills: the simulated fleet, then train, corrupt, plant
    # killed-writer debris and resume on the card
    rc = drills.main(["--seed", "1", "--steps", "200", "--device", "cuda"])
    assert rc == 0, rc
    _free(torch)

    # (d) real ranks: the seeded drill, then a join and a kill
    drill = run_drill(0, hosts=3, steps=40)
    assert drill["failures"] == [], drill["failures"]
    statuses = {host: final["status"] for host, final in drill["finals"].items()}
    assert statuses and set(statuses.values()) <= {"done", "fenced"}, statuses
    _print(f"[fleet drill] seed 0, 3 ranks, 40 polls: epoch={drill['epoch']} "
           f"ranks={statuses} ADAPT {drill['action_counts']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as root:
        fleet = run_fleet(FleetSettings(hosts=2, steps=FLEET_POLLS, step_floor_s=0.02,
                                        poll_interval_s=0.1, liveness_timeout_s=FLEET_LIVENESS_S,
                                        snapshot_every=5, rendezvous=root,
                                        join_at=[(6, 2)], kill_at=[(18, 0)]))
    counts = fleet["action_counts"]
    assert counts.get("fleet::join") == 1 and counts.get("fleet::leave") == 1, counts
    # the leave is the kill's expiry, not a slow start's: rank 0 leaves after poll 18
    rows = {row.split(": ")[1].split()[0]: row for row in fleet["actions"]
            if row.startswith("[fleet]")}
    assert int(rows["leave"].split()[2].rstrip(":")) >= 18 and " host=0 " in rows["leave"], rows
    assert " host=2 " in rows["join"], rows
    first, last = (parse_exposition(fleet["snapshots"][i]["exposition"]) for i in (0, -1))
    delta = {name: last.value(f"repro_fleet_{name}") - first.value(f"repro_fleet_{name}")
             for name in ("membership_epoch", "joins_total", "leaves_total")}
    evicts = counts.get("stragglers::evict", 0)
    assert delta == {"membership_epoch": fleet["epoch"] - 1.0, "joins_total": 1.0,
                     "leaves_total": 1.0}, delta
    assert fleet["epoch"] == 1 + fleet["joins_total"] + fleet["leaves_total"] + evicts
    assert 0 not in fleet["hosts"] and "0" not in fleet["finals"], fleet["hosts"]
    _print(f"[fleet] 2 ranks, {FLEET_POLLS} polls, liveness {FLEET_LIVENESS_S:g} s, join of rank "
           f"2 at poll 6, SIGKILL of rank 0 at poll 18: "
           f"epoch={fleet['epoch']} hosts={fleet['hosts']} wire deltas {delta}; "
           + "; ".join(row for row in fleet["actions"] if row.startswith("[fleet]")))
    _print(f"[soak] phase 27 took {time.perf_counter() - t0:.1f} s")
    return launches


# phase 28: llama3.2-1b on a ("data", "model") DeviceMesh of DIST_MESH
# processes sharing the card (gloo), (a) "tp" and (b) "tp+fsdp", DIST_STEPS
# steps of phase 8's 6-step schedule at its batch x seq; each rank capped at
# DIST_MEMORY_FRACTION of the card, its allocator on expandable segments
# (development runs on the card: under a cap of 0.22 without expandable
# segments a rank ran out with 13.04 GiB allocated and 3.95 GiB reserved but
# free; with them, at 0.23, the peaks were 15.054 GB a rank under "tp" and
# 17.658-18.732 GB under "tp+fsdp")
DIST_MESH, DIST_STEPS, DIST_MEMORY_FRACTION = (2, 2), 3, 0.235
DIST_ALLOC_CONF = "expandable_segments:True"
DIST_RANKS = DIST_MESH[0] * DIST_MESH[1]
DIST_NOTE = f"{DIST_RANKS} ranks sharing one card, gloo; not a multi-card number"


def _probe_cases(torch, mesh, rank, world):
    """The five collectives the sharded step needs, through DTensor on
    bf16 and f32 tensors on the card over the 1-D ``mesh``: {case: (result,
    functional calls routed)}; each result held against the value computed
    on one rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.dist import collectives

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(SEED)
        full = torch.randn((world * 4, world * 8), generator=gen).to(dtype)
        parts = [torch.randn(full.shape, generator=gen).to(dtype) for _ in range(world)]
        total = sum(p.float() for p in parts).to(dtype)
        dev = lambda t: t.to(DEVICE)  # noqa: E731
        mine = DTensor.from_local(dev(parts[rank]), mesh, [Partial()], run_check=False)
        shard = DTensor.from_local(dev(full.chunk(world)[rank]), mesh, [Shard(0)],
                                   run_check=False)
        cases = {
            "all_reduce": (lambda: mine.redistribute(mesh, [Replicate()]), total),
            "all_gather": (lambda: shard.redistribute(mesh, [Replicate()]), full),
            "reduce_scatter": (lambda: mine.redistribute(mesh, [Shard(0)]),
                               total.chunk(world)[rank]),
            "broadcast": (lambda: distribute_tensor(dev(full if rank == 0 else 0 * full), mesh,
                                                    [Replicate()]), full),
            "all_to_all": (lambda: shard.redistribute(mesh, [Shard(1)]),
                           full.chunk(world, 1)[rank]),
        }
        for name, (fn, want) in cases.items():
            before = dict(collectives.COUNTS)
            got = fn().to_local()
            torch.cuda.synchronize()
            ok = torch.allclose(got.float().cpu(), want.float(), rtol=1e-2, atol=1e-2)
            routed = sum(collectives.COUNTS[k] - before[k] for k in before)
            out[f"{name}/{_dtype_name(dtype)}"] = ("ok" if ok else "wrong", routed)
    return out


def _native_all_gather_rank(rank, world):
    """DTensor's own all-gather (Shard(0) -> Replicate) on a bf16 tensor on
    the card, with nothing routed (the mesh is built directly)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    full = torch.arange(world * 8, dtype=torch.bfloat16).reshape(world * 4, 2)
    local = full.chunk(world)[rank].to(DEVICE)
    got = DTensor.from_local(local, mesh, [Shard(0)], run_check=False).redistribute(
        mesh, [Replicate()]).to_local()
    return bool(torch.equal(got.cpu(), full))


def _dist_rank(rank, world, ref_path, log_dir):
    """One rank of phase 28: the routed collectives' check, then for each
    preset ``run_training`` (DIST_STEPS steps, the launches counted), one
    loss-and-gradient step of the sharded path, gathered and (rank 0) held
    leaf by leaf against the unsharded step's gradient saved at
    ``ref_path``, and after "tp" the compressed cross-pod mean over "data".
    Returns what the parent prints and holds."""
    import types

    import torch

    from repro_torch.core import TimerLogger
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.context import use_sharding
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.sharding import Axes, distribute_tree
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import compression
    from repro_torch.timing import TimingSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_per_process_memory_fraction(DIST_MEMORY_FRACTION)
    K = types.SimpleNamespace(fa=fa, rn=rn)
    counters = COUNTERS[:5]  # the flash and RMSNorm kernels
    mesh = device_mesh(DIST_MESH, ("data", "model"), DEVICE, allow_shared_card=True)
    out = {"probe": _probe_cases(torch, mesh["data"], mesh.get_local_rank(0), DIST_MESH[0]),
           "runs": {}}
    ref = torch.load(ref_path, mmap=True, weights_only=True) if rank == 0 else None
    for preset in ("tp", "tp+fsdp"):
        run = {}
        cfg = _train_cfg("llama3.2-1b").replace(sharding=preset)
        reset_timer_db()
        reset_param_registry()
        reset_default_clocks()
        log_path = os.path.join(log_dir, f"{preset}.jsonl")
        settings = TrainSettings(
            arch="llama3.2-1b", smoke=False, steps=DIST_STEPS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, data_mode="copy", seed=SEED, report_every=0, log_path=log_path,
            device=DEVICE, lr_total_steps=TRAIN_STEPS, mesh_shape=DIST_MESH,
            allow_shared_card=True)
        sess = TimingSession()
        torch.cuda.reset_peak_memory_stats()
        for name, mod, attr in counters:
            setattr(getattr(K, mod), attr, 0)
        t0 = time.perf_counter()
        summary = run_training(settings, cfg=cfg, session=sess)
        torch.cuda.synchronize()
        run["wall_s"] = time.perf_counter() - t0
        run["launches"] = {name: getattr(getattr(K, mod), attr) for name, mod, attr in counters}
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["mesh"] = summary["mesh"]
        if rank == 0:
            records = TimerLogger(log_path, sess.db).read_all()
            run["losses"] = [r["extra"]["loss"] for r in records]
            cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
            run["step_s"] = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
        del sess, summary
        gc.collect()
        torch.cuda.empty_cache()

        # one loss-and-gradient step of the sharded path, from phase 8's weights and batch
        rules = ST.rules_for(cfg)
        params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        params = distribute_tree(params, M.param_axes(cfg), mesh, rules)
        data = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, mode="copy",
                                           seed=SEED), arch=cfg).batch_at(0)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
        axes = {k: Axes(v) for k, v in ST.batch_axes(cfg, "train").items()}
        with use_sharding(mesh, rules):
            grads, metrics = ST._grads(cfg, params, distribute_tree(batch, axes, mesh, rules))
            run["loss"] = metrics["loss"].full_tensor().item()
            if preset == "tp":
                # each rank's own part of the gradient (its batch rows) over "data"
                own = tree_map(lambda g: g.to_local(), grads)
                ef = compression.ef_init(own)
                mean, _ = compression.cross_pod_mean_compressed(own, ef, axis_name="data")
                q, sc, _ = compression.ef_quantize(own, ef)
                group = mesh.get_group("data")
                err = 0.0
                for qq, ss, got in zip(tree_leaves(q), tree_leaves(sc), tree_leaves(mean)):
                    dq = qq.float() * ss  # this rank's dequantized payload
                    every = [torch.empty_like(dq) for _ in range(DIST_MESH[0])]
                    torch.distributed.all_gather(every, dq, group=group)
                    plain = torch.stack(every).sum(0) / DIST_MESH[0]
                    err = max(err, ((got - plain).abs().max() / plain.abs().max().clamp_min(
                        1e-30)).item())
                run["compressed_mean_err"] = err
                run["compressed_leaves"] = len(tree_leaves(own))
                del own, ef, mean, q, sc
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                             grads, params)
        del params
        rel = {}
        for (name, g) in _named_leaves(grads):
            full = g.full_tensor()  # a collective: every rank gathers every leaf
            if rank == 0:
                want = ref[name].to(DEVICE).float()
                rel[name] = ((full.float() - want).norm() / want.norm()).item()
            del full
        run["grad_rel"] = rel
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        out["runs"][preset] = run
    return out


def _dist_train_phase(torch, F, K, gen, train_losses):
    """Phase 28: full-width llama3.2-1b trained on a ("data", "model") mesh
    of DIST_RANKS processes sharing the card (module docstring).  Returns
    the kernels' rows at a rank's local shapes and rank 0's launches."""
    from repro_torch.dist.collectives import COLLECTIVES
    from repro_torch.dist.spawn import run_ranks

    t0 = time.perf_counter()
    tag = "[dist]"
    smi = _smi()
    # a rank's local shapes: batch TRAIN_BATCH / data, heads / model
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.models import model as M

    cfg = _train_cfg("llama3.2-1b")
    local_batch = TRAIN_BATCH // DIST_MESH[0]
    heads = (cfg.n_heads // DIST_MESH[1], cfg.n_kv_heads // DIST_MESH[1])
    rows = _training_kernels_rows(torch, F, K, gen, local_batch, heads, "[dist kernels]",
                                  "at a rank's local shards")
    _free(torch)
    # the unsharded step's gradient (phase 8's kernel path, weights and batch)
    per_step = _per_step_launches(cfg)
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, mode="copy",
                                       seed=SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    loss_ref, gn_ref, grads = _loss_and_grads(torch, cfg, params, batch)
    names = [name for name, _ in _named_leaves(params)]
    with tempfile.TemporaryDirectory(dir=_ckpt_root()) as tmp:
        ref_path = os.path.join(tmp, "unsharded_grads.pt")
        torch.save({name: g.cpu() for name, g in zip(names, grads)}, ref_path)
        del params, batch, grads
        _free(torch)
        # DTensor's own all-gather on the card over gloo, nothing routed
        try:
            native = "ok" if run_ranks(_native_all_gather_rank, 2, device=DEVICE)[0] else "wrong"
        except RuntimeError as exc:  # the probe's finding, printed, not the path's
            native = "failed: " + str(exc.__cause__ or exc).strip().splitlines()[-1][:120]
        _print(f"{tag} step 0, DTensor's own all-gather (Shard(0) -> Replicate) on a bf16 "
               f"tensor on the card, 2 ranks over gloo, nothing routed: {native}")
        t1 = time.perf_counter()
        kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = DIST_ALLOC_CONF  # read by each rank's allocator
        try:
            results = run_ranks(_dist_rank, DIST_RANKS, ref_path, tmp, device=DEVICE)
        finally:
            if kept is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = kept
        ranks_s = time.perf_counter() - t1
    lead = results[0]
    for case, (result, routed) in lead["probe"].items():
        _print(f"{tag} step 0, {case:26s} through DTensor over 'data' on the card: {result}, "
               f"{routed} functional call(s) routed through the process group (gloo)")
        assert result == "ok", (case, result)
    launches = {}
    for preset, run in lead["runs"].items():
        label = f"{tag} ({'a' if preset == 'tp' else 'b'}) {preset}"
        want = {k: v * DIST_STEPS for k, v in per_step.items() if k in run["launches"]}
        for rank, r in enumerate(results):
            got = r["runs"][preset]
            assert got["launches"] == want, (rank, preset, got["launches"], want)
            coll = got["mesh"]["collective_seconds"]
            calls, moved = got["mesh"]["collective_calls"], got["mesh"]["collective_bytes"]
            _print(f"{label} rank {rank}: launches {got['launches']} (phase 8's per step x "
                   f"{DIST_STEPS}); peak memory {got['peak_gb']:.3f} GB (cap "
                   f"{DIST_MEMORY_FRACTION} of the card); collectives from the timers "
                   f"{sum(coll.values()):.3f} s "
                   f"{ {k: round(v, 4) for k, v in coll.items() if calls[k]} } over "
                   f"{ {k: v for k, v in calls.items() if v} } calls of "
                   f"{ {k: round(v / 1e9, 4) for k, v in moved.items() if v} } GB; {smi}; "
                   f"{DIST_NOTE}")
            assert set(calls) == set(COLLECTIVES), calls
        launches[preset] = run["launches"]
        losses, ref = run["losses"], train_losses[:DIST_STEPS]
        for a, b in zip(losses, ref):
            assert abs(a - b) <= TRAIN_RTOL * abs(b), (preset, losses, ref)
        assert abs(run["loss"] - loss_ref) <= TRAIN_RTOL * abs(loss_ref), (run["loss"], loss_ref)
        rel = run["grad_rel"]
        worst = max(rel, key=rel.get)
        assert sorted(rel) == sorted(names) and rel[worst] < LEAF_RTOL, rel
        step_s = run["step_s"]
        median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
        _print(f"{label}: full-width llama3.2-1b ({cfg.n_layers} layers, nothing cut), bf16, "
               f"remat dots, batch {TRAIN_BATCH} x {TRAIN_SEQ} over a {DIST_MESH} "
               f"('data', 'model') mesh ({heads[0]}/{heads[1]} heads and batch {local_batch} "
               f"a rank): losses {[round(x, 5) for x in losses]} vs phase 8's "
               f"{[round(x, 5) for x in ref]} (TRAIN_RTOL {TRAIN_RTOL}); step_s "
               f"{[round(x, 4) for x in step_s]} median_s(steps 2-{DIST_STEPS})={median_s:.4f}; "
               f"one sharded loss-and-gradient step vs the unsharded kernel path: loss "
               f"{run['loss']:.6f} vs {loss_ref:.6f}, worst of {len(rel)} gathered leaves "
               f"{rel[worst]:.3e} ({worst}; LEAF_RTOL {LEAF_RTOL}), median "
               f"{sorted(rel.values())[len(rel) // 2]:.3e}; wall_s {run['wall_s']:.2f}; {smi}; "
               f"{DIST_NOTE}")
    err = lead["runs"]["tp"]["compressed_mean_err"]
    assert err <= 1e-6, err
    _print(f"{tag} (a) cross_pod_mean_compressed over 'data' on each rank's own part of step "
           f"1's gradient ({lead['runs']['tp']['compressed_leaves']} leaves, int8 payload and "
           f"f32 scales all-gathered): largest difference from the mean of the ranks' "
           f"dequantized payloads {err:.3e} of the leaf's largest value (limit 1e-6)")
    _print(f"[dist] phase 28 took {time.perf_counter() - t0:.1f} s ({ranks_s:.1f} s in the "
           f"{DIST_RANKS} ranks); {smi}; {DIST_NOTE}")
    total = {k: launches["tp"][k] + launches["tp+fsdp"][k] for k in launches["tp"]}
    return rows, total



# phase 29: llama3.2-1b through the 1F1B schedule with one process a stage:
# PIPE_RANKS processes sharing the card (gloo, the ring messages staged
# through pinned host memory), phase 26 (b)'s 16 units over 4 stages and
# PIPE_RANK_MICRO microbatches of batch PIPE_RANK_BATCH x TRAIN_SEQ, each
# process capped at PROCS_MEMORY_FRACTION of the card on expandable
# segments; then run_training on them for PROCS_STEPS steps; and, cut to
# PROCS_CKPT_LAYERS layers (one unit a stage: at full depth the 17.3 GB
# save and its restore took ~110 s of a development call's 186 s),
# PROCS_STEPS steps uninterrupted and PROCS_SAVE_AT steps saved, resumed
# on PROCS_RESUME processes (capped at PROCS_RESUME_FRACTION: each holds
# twice the units), which start with the 4 and wait for their save.  The
# uninterrupted run and the saved one stay two runs: run_training always
# saves at shutdown, so a save at label PROCS_SAVE_AT inside the 4-step
# run would add a second save, which costs more than the 2-step run.
PROCS_MEMORY_FRACTION, PROCS_RESUME_FRACTION = 0.22, 0.3
PROCS_STEPS, PROCS_SAVE_AT, PROCS_RESUME, PROCS_CKPT_LAYERS = 4, 2, 2, 4
PROCS_NOTE = f"{PIPE_RANKS} processes sharing one card, gloo; not a multi-card number"


def _pipeline_rank_launches(cfg, n_micro, depth, last) -> dict[str, int]:
    """Kernel launches of one pipelined step on a rank that holds ``depth``
    units (``_pipeline_launches`` of those units); the final norm's only on
    the last rank.  The ranks' shares add up to ``_pipeline_launches``."""
    from repro_torch.models.model import decoder_pattern

    out = _pipeline_launches(cfg.replace(n_layers=depth * len(decoder_pattern(cfg))), n_micro)
    if not last:
        out["rmsnorm_fwd"] -= n_micro
        out["rmsnorm_bwd"] -= n_micro
    return out


class _StepClock:
    """A controller that stamps every poll of the control loop (one an
    iteration, after the step): the differences are a rank's step times."""

    name = "step_clock"
    channels = ()

    def __init__(self):
        self.stamps = []

    def control(self, step, measurements):
        self.stamps.append(time.perf_counter())
        return []


def _procs_train(torch, K, root, name, world, steps, ckpt=None, n_layers=None):
    """``run_training`` of full-width llama3.2-1b (cut to ``n_layers``) on
    this process's pipeline rank: {summary's pipeline block, launches, step
    times, peak memory, wall; rank 0: the losses}."""
    from repro_torch.core import TimerLogger
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.timing import TimingSession

    reset_timer_db()
    reset_param_registry()
    reset_default_clocks()
    log_path = os.path.join(root, f"{name}.jsonl")
    settings = TrainSettings(
        arch="llama3.2-1b", smoke=False, steps=steps, global_batch=PIPE_RANK_BATCH,
        seq_len=TRAIN_SEQ, data_mode="copy", seed=SEED, report_every=0, log_path=log_path,
        device=DEVICE, lr_total_steps=PROCS_STEPS, pipeline_stages=world, pipeline_model=True,
        pipeline_micro=PIPE_RANK_MICRO, allow_shared_card=True, ckpt_dir=ckpt,
        ckpt_mode="fixed" if ckpt and steps < PROCS_STEPS else "off", ckpt_every=1000)
    sess = TimingSession()
    clock = _StepClock()
    sess.control_loop.register(clock)
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(K)
    t0 = time.perf_counter()
    cfg = _train_cfg("llama3.2-1b")
    summary = run_training(settings, cfg=cfg if n_layers is None else cfg.replace(
        n_layers=n_layers), session=sess)
    torch.cuda.synchronize()
    out = dict(pipeline=summary["pipeline"], launches=_read_counters(K),
               wall_s=time.perf_counter() - t0,
               step_s=[b - a for a, b in zip(clock.stamps, clock.stamps[1:])],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               restore_s=sess.db.get("STARTUP/restore").seconds()
               if sess.db.exists("STARTUP/restore") else 0.0)
    if torch.distributed.get_rank() == 0:
        out["losses"] = [r["extra"]["loss"] for r in TimerLogger(log_path, sess.db).read_all()]
    del sess, summary
    _free(torch)
    return out


def _procs_kernels(fraction):
    """This process's kernels, built (cached) and loaded, counters at 0."""
    import types

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rwkv6 import ops as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_per_process_memory_fraction(fraction)
    build.build_all()
    return types.SimpleNamespace(fa=fa, rn=rn, rg=rg, wk=wk)


def _procs_rank(rank, world, ref, root):
    """One process of phase 29: the pipelined call held to phase 26 (b),
    the restaged plan, one AdamW step held to phase 26 (c), a profiled warm
    step (rank 0), then ``run_training`` uninterrupted and saved."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.launch.steps import make_transformer_pipeline_train_step
    from repro_torch.optim import AdamWConfig, init_opt_state

    marks = [("entered", time.time())]  # the wall clock: the parent's spawn included
    K = _procs_kernels(PROCS_MEMORY_FRACTION)
    marks.append(("kernels loaded", time.time()))
    mesh = device_mesh((world,), ("pod",), DEVICE, allow_shared_card=True)
    cfg = _train_cfg("llama3.2-1b")
    plan = StagePlan.equal(range(world), cfg.n_layers)
    phase_s = {}

    @contextlib.contextmanager
    def timed_phase(name):
        t0 = time.perf_counter()
        yield  # the step synchronizes the card before the scope closes
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0

    built = make_transformer_pipeline_train_step(
        cfg, mesh, plan, seq_len=TRAIN_SEQ, global_batch=PIPE_RANK_BATCH,
        n_micro=PIPE_RANK_MICRO, seed=SEED, device=DEVICE, phase_cb=timed_phase,
        peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    params = built.init_params()
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, PIPE_RANK_BATCH, mode="copy",
                                       seed=SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    out = {"held": [name for name in params]}
    marks.append(("step built", time.time()))

    def call(tag):
        """One loss-and-gradient call: this rank's launches and units; on
        rank 0 the loss and the gathered gradient's digests."""
        _zero_counters(K)
        dist.barrier()
        marks.append((f"({tag} barrier)", time.time()))
        loss, grads = built.pipeline_call(params, batch)
        torch.cuda.synchronize()
        marks.append((f"({tag} call)", time.time()))
        out[f"{tag}_launches"] = _read_counters(K)
        out[f"{tag}_units"] = built.share.units
        whole, _ = built.share.gather(grads, {})
        marks.append((f"({tag} gathered)", time.time()))
        if rank == 0:
            out[f"{tag}_loss"] = loss.item()
            out[f"{tag}_grads"] = {n: _digest(torch, g) for n, g in _named_leaves(whole)}
        marks.append((f"({tag} digests)", time.time()))

    call("equal")
    plan.set_weight(1, 0.5)  # phase 26 (b)'s restage: depths 5/3/4/4
    params, _ = built.share.restage(params, {})
    call("restaged")
    # one AdamW step from the seed's weights, as phase 26 (c)'s first
    opt_state = init_opt_state(AdamWConfig(), params)
    params, opt_state, metrics = built.fn(params, opt_state, batch)
    float(metrics["loss"])
    whole, _ = built.share.gather(params, {})
    if rank == 0:
        out["params1"] = {n: _digest(torch, leaf) for n, leaf in _named_leaves(whole)}
    del whole
    out["embed"] = _digest(torch, params["embed"]["tokens"]) if "embed" in params else None
    marks.append(("(c)", time.time()))
    # a warm step, profiled on rank 0
    phase_s.clear()
    prof = profile(activities=[ProfilerActivity.CUDA]) if rank == 0 else contextlib.nullcontext()
    with prof:
        dist.barrier()  # every rank starts its clock with the profiler running
        t0 = time.perf_counter()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["warm"] = dict(wall_s=wall, phase_s=dict(phase_s))
    if rank == 0:
        kernels = _device_ops(prof)
        device_s = sum(e.self_device_time_total for e in kernels) / 1e6
        out["warm"].update(device_s=device_s, busy=device_s / wall,
                           ops=sum(e.count for e in kernels),
                           top=[(e.self_device_time_total / 1e3, e.count, e.key[:90])
                                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
                                [:6]])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del built, params, opt_state, metrics, prof
    _free(torch)
    marks.append(("warm step", time.time()))
    out["run"] = _procs_train(torch, K, root, "uninterrupted", world, PROCS_STEPS)
    marks.append(("(d) run_training", time.time()))
    out["cut"] = _procs_train(torch, K, root, "cut", world, PROCS_STEPS,
                              n_layers=PROCS_CKPT_LAYERS)
    marks.append(("(e) uninterrupted", time.time()))
    out["saved"] = _procs_train(torch, K, root, "saved", world, PROCS_SAVE_AT,
                                ckpt=os.path.join(root, "ckpt"), n_layers=PROCS_CKPT_LAYERS)
    marks.append(("(e) saved", time.time()))
    out["marks"] = marks
    return out


def _procs_resume_rank(rank, world, root, go):
    """One process of phase 29's resume: started beside the 4 processes,
    it waits for the file ``go`` (written once they have returned: "go",
    or "stop" if they failed), then ``run_training`` restores their save
    and trains to PROCS_STEPS."""
    import torch

    marks = [("entered", time.time())]
    K = _procs_kernels(PROCS_RESUME_FRACTION)
    marks.append(("kernels loaded", time.time()))
    while not os.path.exists(go):
        time.sleep(0.05)
    marks.append(("waited for the save", time.time()))
    with open(go) as fh:
        if fh.read() != "go":
            return None
    out = _procs_train(torch, K, root, "resumed", world, PROCS_STEPS,
                       ckpt=os.path.join(root, "ckpt"), n_layers=PROCS_CKPT_LAYERS)
    out["marks"] = marks + [("(e) resumed", time.time())]
    return out


def _procs_phase(torch, ref):
    """Phase 29: full-width llama3.2-1b through the 1F1B schedule with one
    process a stage (module docstring), held to phase 26's single
    controller (``ref``).  Returns the uninterrupted run's launches by
    rank."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.dist.pipeline import StagePlan
    from repro_torch.dist.spawn import run_ranks

    t0 = time.perf_counter()
    tag = f"[pipeline procs {PIPE_RANKS}]"
    smi = _smi()
    cfg = _train_cfg("llama3.2-1b")
    kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = DIST_ALLOC_CONF  # read by each rank's allocator
    try:
        with tempfile.TemporaryDirectory(dir=_ckpt_root()) as root:
            digests = {k: ref[k] for k in ("loss", "grads", "params1")}
            go = os.path.join(root, "resume_go")
            t1, w1 = time.perf_counter(), time.time()
            with ThreadPoolExecutor(1) as pool:
                # the resume's processes start beside the 4 (their start-up
                # overlaps the 4's work) and wait for the save
                later = pool.submit(run_ranks, _procs_resume_rank, PROCS_RESUME, root, go,
                                    device=DEVICE)
                word = "stop"
                try:
                    ranks = run_ranks(_procs_rank, PIPE_RANKS, digests, root, device=DEVICE)
                    word = "go"
                finally:
                    t2, w2 = time.perf_counter(), time.time()
                    with open(go + ".tmp", "w") as fh:
                        fh.write(word)
                    os.replace(go + ".tmp", go)
                labels = sorted(os.listdir(os.path.join(root, "ckpt")))
                resumed = later.result()
            t3, w3 = time.perf_counter(), time.time()
    finally:
        if kept is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = kept
    lead = ranks[0]
    n_leaves = len(ref["grads"])

    def differ(got, want):
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        return [name for name in want if got[name] != want[name]]

    # (a) the equal plan against phase 26 (b)'s single controller
    moved = differ(lead["equal_grads"], ref["grads"])
    assert lead["equal_loss"] == ref["loss"], (lead["equal_loss"], ref["loss"])
    assert not moved, f"gradient leaves that differ from the single controller's: {moved}"
    plans = {"equal": StagePlan.equal(range(PIPE_RANKS), cfg.n_layers)}
    plans["restaged"] = StagePlan(n_layers=cfg.n_layers, weights={
        **plans["equal"].weights, 1: 0.5})
    want_sum = _pipeline_launches(cfg, PIPE_RANK_MICRO)
    for name, plan in plans.items():
        depths = plan.depths()
        for rank, r in enumerate(ranks):
            assert r[f"{name}_units"] == plan.boundaries()[rank], (name, rank, r[f"{name}_units"])
            want = _pipeline_rank_launches(cfg, PIPE_RANK_MICRO, depths[rank],
                                           rank == PIPE_RANKS - 1)
            assert r[f"{name}_launches"] == want, (name, rank, r[f"{name}_launches"], want)
        total = {k: sum(r[f"{name}_launches"][k] for r in ranks) for k in want_sum}
        assert total == want_sum, (name, total, want_sum)
        _print(f"{tag} ({'a' if name == 'equal' else 'b'}) {name} plan, depths {depths}: "
               f"launches by rank {[r[f'{name}_launches'] for r in ranks]} (each rank its "
               f"stage's share), summed {total} = phase 26 (b)'s {want_sum}")
    assert lead["restaged_loss"] == lead["equal_loss"]
    moved = differ(lead["restaged_grads"], lead["equal_grads"])
    assert not moved, f"leaves whose gradient changed with the restage: {moved}"
    _print(f"{tag} (a) {cfg.name} full width, bf16, {PIPE_RANK_MICRO} microbatches of batch "
           f"{PIPE_RANK_BATCH // PIPE_RANK_MICRO} x seq {TRAIN_SEQ}, {PIPE_RANKS} processes "
           f"holding {[r['held'] for r in ranks]}: loss {lead['equal_loss']:.6f} and every one "
           f"of {n_leaves} gradient leaves (gathered to rank 0) bit-equal to phase 26 (b)'s "
           f"single controller; (b) the restaged plan (stage 1 at weight 0.5, its units moved "
           f"between the processes) bit-equal to the equal plan")
    # (c) one AdamW step against phase 26 (c)'s first, and the tied copies
    moved = differ(lead["params1"], ref["params1"])
    assert not moved, f"parameters after one AdamW step that differ: {moved}"
    ends = [r["embed"] for r in ranks]
    assert ends[0] is not None and ends[0] == ends[-1] and not any(ends[1:-1]), ends
    _print(f"{tag} (c) one AdamW step (the clip norm from the ranks' per-unit square sums): "
           f"all {len(ref['params1'])} parameter leaves (gathered to rank 0) bit-equal to phase "
           f"26 (c)'s single controller; the tied table's two copies (ranks 0 and "
           f"{PIPE_RANKS - 1}) bit-identical after the step")
    warm = lead["warm"]
    ticks = PIPE_RANK_MICRO + 2 * PIPE_RANKS - 1
    _print(f"[profile-train pipeline procs {PIPE_RANKS}] one warm step (AdamW included), rank "
           f"0's process: wall_s={warm['wall_s']:.4f} device_kernel_s={warm['device_s']:.4f} "
           f"device_busy_share={warm['busy']:.4f} (rank 0's own kernels; the card runs "
           f"{PIPE_RANKS} processes) device_operations={warm['ops']} "
           f"ms_per_tick={1e3 * warm['wall_s'] / ticks:.3f}; each rank's wall_s and phase_s "
           f"{[(round(r['warm']['wall_s'], 4), {k: round(v, 4) for k, v in r['warm']['phase_s'].items()}) for r in ranks]}; "
           f"phase 26 (c)'s single controller in this run: wall_s={ref['warm']['wall_s']:.4f} "
           f"device_busy_share={ref['warm']['busy']:.4f} device_operations={ref['warm']['ops']}; "
           f"{smi}; {PROCS_NOTE}")
    for ms, count, key in warm["top"]:
        _print(f"[profile-train pipeline procs {PIPE_RANKS}]   {ms:10.3f} ms  x{count:<6d} {key}")
    # (d) run_training: uninterrupted; at PROCS_CKPT_LAYERS, saved and resumed
    losses, cut = lead["run"]["losses"], lead["cut"]["losses"]
    for run in (losses, cut):
        assert len(run) == PROCS_STEPS and all(math.isfinite(x) for x in run), run
    assert lead["saved"]["losses"] == cut[:PROCS_SAVE_AT], (lead["saved"]["losses"], cut)
    assert resumed[0]["losses"] == cut[PROCS_SAVE_AT:], (resumed[0]["losses"], cut)
    assert labels == [f"step_{PROCS_SAVE_AT:08d}"], labels
    launches = {}
    for rank, r in enumerate(ranks):
        run = r["run"]
        want = _pipeline_rank_launches(cfg, PIPE_RANK_MICRO, plans["equal"].depths()[rank],
                                       rank == PIPE_RANKS - 1)
        assert run["launches"] == {k: v * PROCS_STEPS for k, v in want.items()}, (
            rank, run["launches"], want)
        launches[f"rank{rank}"] = run["launches"]
        pipe = run["pipeline"]
        assert pipe["mode"] == "processes" and pipe["rank"] == rank and pipe["backend"] == "gloo"
        median = sorted(run["step_s"])[len(run["step_s"]) // 2]
        _print(f"{tag} (d) run_training rank {rank}: steps {PROCS_STEPS}, step_s "
               f"{[round(x, 4) for x in run['step_s']]} (steps 2-{PROCS_STEPS}) median_s="
               f"{median:.4f}; phase_s_per_step "
               f"{ {k: round(v / PROCS_STEPS, 5) for k, v in pipe['phase_seconds'].items()} }; "
               f"P2P calls {pipe['p2p_calls']} bytes "
               f"{ {k: v for k, v in pipe['p2p_bytes'].items()} } seconds "
               f"{ {k: round(v, 4) for k, v in pipe['p2p_seconds'].items()} }; launches "
               f"{run['launches']}; peak memory {run['peak_gb']:.3f} GB (cap "
               f"{PROCS_MEMORY_FRACTION} of the card; the checks before it "
               f"{r['peak_gb']:.3f} GB); wall_s {run['wall_s']:.2f}")
    launches["sum"] = {k: sum(launches[f"rank{r}"][k] for r in range(PIPE_RANKS))
                       for k in want_sum}
    assert launches["sum"] == {k: v * PROCS_STEPS for k, v in want_sum.items()}, launches
    _print(f"{tag} (d) run_training on {PIPE_RANKS} processes, {PROCS_STEPS} steps: losses "
           f"{[round(x, 6) for x in losses]}; launches summed over the ranks "
           f"{launches['sum']} = phase 26 (b)'s per step x {PROCS_STEPS}")
    _print(f"{tag} (e) cut to {PROCS_CKPT_LAYERS} layers (one unit a stage), {PROCS_STEPS} steps "
           f"uninterrupted: losses {cut} (median step "
           f"{sorted(lead['cut']['step_s'])[len(lead['cut']['step_s']) // 2]:.4f} s); saved at "
           f"label {labels} after {PROCS_SAVE_AT} steps (losses {lead['saved']['losses']}, "
           f"the save gathered to rank 0: {lead['saved']['wall_s']:.1f} s for the run), resumed "
           f"on {PROCS_RESUME} processes (cap {PROCS_RESUME_FRACTION}; peak memory "
           f"{[round(r['peak_gb'], 3) for r in resumed]} GB; launches "
           f"{[r['launches'] for r in resumed]}; wall_s "
           f"{[round(r['wall_s'], 2) for r in resumed]}, of which restoring "
           f"{[round(r['restore_s'], 2) for r in resumed]}): losses {resumed[0]['losses']} equal "
           f"to the uninterrupted run's steps {PROCS_SAVE_AT + 1}-{PROCS_STEPS}")
    def parts(marks, end):
        """Seconds of each part of a process's run, from the parent's
        spawn call to its return."""
        stamps = [("spawn", w1), *marks, ("returned", end)]
        return ", ".join(f"{name} {b - a:.1f}" for (_, a), (name, b) in zip(stamps, stamps[1:]))

    for rank, r in enumerate(ranks[1:], 1):
        _print(f"{tag} rank {rank}'s parts (s): {parts(r['marks'], w2)}")
    _print(f"[pipeline procs] phase 29 took {time.perf_counter() - t0:.1f} s ({t2 - t1:.1f} s in "
           f"the {PIPE_RANKS} processes, rank 0's parts: {parts(lead['marks'], w2)}; {t3 - t2:.1f} "
           f"s more for the {PROCS_RESUME}, started with them, rank 0's parts: "
           f"{parts(resumed[0]['marks'], w3)}); {smi}; {PROCS_NOTE}")
    return launches


# phase 30: sharded serving on a ("data", "model") DeviceMesh of
# SHARDED_MESH processes sharing the card (gloo, the collectives routed):
# each family at full width, SHARDED_BATCH seeded prompts of SHARDED_PROMPT
# tokens (phase 4's long prompt) prefilled through
# ``launch.steps.make_prefill_step``, then seeded tokens decoded through
# ``make_serve_step``; this process first runs the unsharded kernel path
# on the same weights and tokens and keeps its logits on the host; each
# rank draws the weights leaf by leaf and keeps its shard of each
# (``_sharded_params``), capped at SHARDED_MEMORY_FRACTION of the card on
# expandable segments.  By arch: (layers or None for all of them, decode
# steps, tolerance of the gathered logits against the unsharded path)
SHARDED_MESH, SHARDED_BATCH, SHARDED_PROMPT, SHARDED_MEMORY_FRACTION = (2, 2), 4, 512, 0.235
SHARDED_CELLS = {
    "llama3.2-1b": (None, 16, ("relnorm", MODEL_RTOL)),
    "recurrentgemma-9b": (None, 1, ("relnorm", RECURRENT_REL)),
    "rwkv6-1.6b": (None, 4, ("relnorm", RECURRENT_REL)),
}
# the deep recurrent cells' bf16 logits are held only against gross
# failure (RECURRENT_REL); their witness is the same sharded path in f32 at
# (layers, decode steps), every layer kind at full width, held elementwise
# to the unsharded f32 path at the repo's f32 model tolerance: the two
# differ only in the order the shards' partial sums add up
SHARDED_F32 = {"recurrentgemma-9b": (4, 1), "rwkv6-1.6b": (4, 2)}
SHARDED_RANKS = SHARDED_MESH[0] * SHARDED_MESH[1]
SHARDED_NOTE = f"{SHARDED_RANKS} ranks sharing one card, gloo; not a multi-card number"
# the forward kernels' wrappers whose calls phase 30 records by shape:
# (counter name, module of K, wrapper), and the value range of each
# positional input (None: N(0, 1); "gate": RG-LRU's a in (0, 1); "decay":
# WKV-6's w = exp(-exp(N)); "weight": 1 + 0.1 N; "bonus": 0.5 N)
SHARDED_WRAPPERS = (
    ("flash_fwd", "fa", "flash_fwd", (None, None, None)),
    ("rmsnorm_fwd", "rn", "rms_norm_fwd", (None, "weight")),
    ("rglru_fwd", "rg", "rglru_fwd", ("gate", None, None)),
    ("wkv6_fwd", "wk", "wkv6_fwd", (None, None, None, "decay", "bonus", None)),
)
# the dry run of phase 30's cells, in a process of its own beside the ranks
SHARDED_DRYRUN = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import start_fake_group
from repro_torch.models.config import ShapeConfig

cells, out_dir = json.loads(sys.argv[1]), sys.argv[2]
start_fake_group(len(cells["ranks"]))
mesh = init_device_mesh("cpu", tuple(cells["mesh"]), mesh_dim_names=("data", "model"))
out = {}
for arch, (layers, steps) in cells["archs"].items():
    over = {"n_layers": layers} if layers else None
    for kind, seq in (("prefill", cells["prompt"]), ("decode", cells["prompt"] + steps)):
        shape = ShapeConfig(f"chip22_{kind}", kind, seq, cells["batch"])
        rec = D.run_cell(arch, shape.name, False, mesh=mesh, mesh_label="chip22",
                         shape_override=shape, arch_overrides=over, out_dir=out_dir,
                         verbose=False)
        out[f"{arch}:{kind}"] = {k: rec[k] for k in (
            "status", "state_bytes", "cost_analysis", "memory_analysis",
            "collective_operand_bytes_per_device", "op_census", "wall_seconds")}
print("DRYRUN " + json.dumps(out))
"""


def _sharded_cfg(arch, f32=False):
    """Phase 30's config of ``arch``: SHARDED_CELLS' depth in bf16, or
    SHARDED_F32's in f32."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(attn_impl="pallas", norm_impl="fused", seq_impl="pallas")
    if f32:
        return cfg.replace(dtype="float32", n_layers=SHARDED_F32[arch][0])
    layers = SHARDED_CELLS[arch][0]
    return cfg.replace(n_layers=layers) if layers else cfg


def _sharded_runs():
    """Phase 30's runs in order: (key, arch, f32, decode steps)."""
    return ([(arch, arch, False, c[1]) for arch, c in SHARDED_CELLS.items()]
            + [(f"{arch}:f32", arch, True, c[1]) for arch, c in SHARDED_F32.items()])


def _sharded_params(torch, cfg, mesh, rules):
    """``M.init_params(cfg, seed SEED)`` laid out on ``mesh``, drawn one leaf
    at a time from the same generator (the same values, in the same order),
    each rank keeping its shard of each leaf before the next is drawn."""
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.models import model as M
    from repro_torch.models.layers import materialize, tree_map

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return tree_map(lambda spec, ax: distribute_tree(materialize(spec, gen, DEVICE), ax, mesh,
                                                     rules),
                    M.model_specs(cfg), M.param_axes(cfg))


def _local_bytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves

    return sum(x.to_local().numel() * x.element_size() for x in tree_leaves(tree))


@contextlib.contextmanager
def _shape_tap(torch, K, seen):
    """Count in ``seen`` each call of the forward kernels' wrappers by
    (kernel, positional arguments, keyword arguments), a tensor as
    ("tensor", shape, dtype name): the local shapes and dtypes a rank's path
    gives them.  The wrappers run as before."""

    def sig(a):
        return ("tensor", tuple(a.shape), _dtype_name(a.dtype)) if torch.is_tensor(a) else a

    kept = []
    for name, mod, attr, _ in SHARDED_WRAPPERS:
        module = getattr(K, mod)
        fn = getattr(module, attr)

        def tapped(*args, _fn=fn, _name=name, **kw):
            key = (_name, tuple(sig(a) for a in args),
                   tuple(sorted((k, sig(v)) for k, v in kw.items())))
            seen[key] = seen.get(key, 0) + 1
            return _fn(*args, **kw)

        setattr(module, attr, tapped)
        kept.append((module, attr, fn))
    try:
        yield
    finally:
        for module, attr, fn in kept:
            setattr(module, attr, fn)


def _serve_sharded_rank(rank, world, ref_path):
    """One rank of phase 30: for each run, the sharded prefill and decode
    steps on the rank's shards, the launches counted and the kernel calls'
    local shapes recorded around each call, the gathered logits held (rank
    0) against the unsharded path's (an f32 run's returned whole)."""
    import types

    import torch

    from repro_torch.dist import collectives
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_per_process_memory_fraction(SHARDED_MEMORY_FRACTION)
    K = types.SimpleNamespace(fa=fa, rn=rn, rg=rg, wk=wk)
    mesh = device_mesh(SHARDED_MESH, ("data", "model"), DEVICE, allow_shared_card=True)
    ref = torch.load(ref_path, weights_only=True)
    out = {}
    for key, arch, f32, steps in _sharded_runs():
        cfg = _sharded_cfg(arch, f32)
        rules = ST.rules_for(cfg)
        t0 = time.perf_counter()
        params = _sharded_params(torch, cfg, mesh, rules)
        draw_s = time.perf_counter() - t0
        b, s = SHARDED_BATCH, SHARDED_PROMPT
        prefill = ST.make_prefill_step(cfg, mesh, rules, ShapeConfig("p", "prefill", s, b))
        serve = ST.make_serve_step(cfg, mesh, rules, ShapeConfig("d", "decode", s + steps, b))
        tokens = ref[key]["tokens"].to(DEVICE)
        cache = M.init_cache(cfg, b, s + steps, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds0 = collectives.collective_seconds()
        calls0 = dict(collectives.COUNTS)
        times, launches, logits, shapes = [], [], [], []
        for i in range(steps + 1):
            seen = {}
            _zero_counters(K)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with _shape_tap(torch, K, seen):
                if i == 0:
                    cache, lg = prefill.fn(params, {"tokens": tokens[:, :s]}, cache)
                else:
                    cache, lg = serve.fn(params, cache, tokens[:, s + i - 1:s + i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            launches.append(_read_counters(K))
            shapes.append(seen)
            logits.append(lg.full_tensor()[:, :cfg.vocab_size].float())  # a collective
        seconds1 = collectives.collective_seconds()
        cell = {
            "draw_s": draw_s, "times": times, "launches": launches, "shapes": shapes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_bytes": _local_bytes(params), "cache_bytes": _local_bytes(cache),
            "collective_s": {k: seconds1[k] - seconds0[k] for k in seconds1},
            "collective_calls": {k: collectives.COUNTS[k] - calls0[k] for k in calls0},
        }
        if rank == 0 and f32:
            cell["logits"] = [lg.cpu() for lg in logits]
        elif rank == 0:
            want = ref[key]["logits"]
            cell["finite"] = all(bool(torch.isfinite(lg).all()) for lg in logits)
            cell["rel"] = [_rel(lg.cpu(), w) for lg, w in zip(logits, want)]
            cell["max_abs"] = max((lg.cpu() - w).abs().max().item() for lg, w in zip(logits, want))
        out[key] = cell
        del params, cache, logits, prefill, serve
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _sharded_kernel_case(torch, F, K, gen, kernel, args, kw):
    """One kernel call of phase 30 rebuilt at a rank's local shapes and
    dtypes (``_shape_tap``'s record; seeded inputs in the ranges the path
    gives them), held against its plain version at KERNEL_TOL (its f32
    second output, the lse or the final state, at 2e-5) and timed as phases
    2, 3, 10 and 11 time theirs.  Returns the row."""
    mod, attr, roles = next((getattr(K, m), a, r) for n, m, a, r in SHARDED_WRAPPERS
                            if n == kernel)
    plain = {"flash_fwd": "flash_fwd_plain", "rmsnorm_fwd": "rms_norm_plain",
             "rglru_fwd": "rglru_fwd_plain", "wkv6_fwd": "wkv6_fwd_plain"}[kernel]
    wrapper, plain = getattr(mod, attr), getattr(mod, plain)

    def make(sig, role):
        if not (isinstance(sig, tuple) and sig[:1] == ("tensor",)):
            return sig
        x = torch.randn(sig[1], generator=gen, device=DEVICE)
        x = {"gate": torch.sigmoid, "decay": lambda t: torch.exp(-torch.exp(t)),
             "weight": lambda t: 1.0 + 0.1 * t, "bonus": lambda t: 0.5 * t}.get(
                 role, lambda t: t)(x)
        return x.to(getattr(torch, sig[2]))

    a = [make(sig, role) for sig, role in zip(args, roles + (None,) * len(args))]
    kwargs = {k: make(sig, None) for k, sig in kw}
    outs, refs = wrapper(*a, **kwargs), plain(*a, **kwargs)
    torch.cuda.synchronize()
    outs, refs = (x if isinstance(x, tuple) else (x,) for x in (outs, refs))
    for i, (o, r) in enumerate(zip(outs, refs)):
        tol = KERNEL_TOL[_dtype_name(o.dtype)] if i == 0 else 2e-5
        torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol)
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
    moved = sum(t.numel() * t.element_size() for t in (*a, *kwargs.values(), *outs)
                if torch.is_tensor(t))
    x = a[0]
    library_ms, peak = None, "f32"
    if kernel == "flash_fwd":
        q, k, v = a
        causal, window = kwargs.get("causal", True), kwargs.get("window")
        ok = _mask_pairs(torch, q.shape[1], k.shape[1], causal, window)
        flops = 4.0 * q.shape[0] * q.shape[2] * int(ok.sum()) * q.shape[3]
        peak = "bf16_tensor" if q.dtype == torch.bfloat16 else "f32"
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in a)
        sdpa_mask = None if window is None else ok
        library_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None,
            enable_gqa=True))
        shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} {_dtype_name(q.dtype)} "
                 f"causal={causal} window={window}")
    elif kernel == "rmsnorm_fwd":
        w, eps = a[1], (a[2] if len(a) > 2 else kwargs.get("eps", 1e-5))
        flops = 4.0 * x.numel()
        library_ms = _device_ms(torch, lambda: F.rms_norm(x, (x.shape[-1],), w, eps))
        shape = f"{tuple(x.shape)} {_dtype_name(x.dtype)}"
    else:  # the recurrences: per element, or per state element and step
        flops = (2.0 * x.numel() if kernel == "rglru_fwd"
                 else 5.0 * x.numel() * a[2].shape[-1])
        shape = ", ".join(f"{tuple(t.shape)} {_dtype_name(t.dtype)}" for t in a
                          if torch.is_tensor(t))
    ms = _device_ms(torch, lambda: wrapper(*a, **kwargs))
    plain_ms = _device_ms(torch, lambda: plain(*a, **kwargs))
    bound_ms, bound_by = _bound_ms(moved, flops, peak)
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _sharded_kernel_rows(torch, F, K, shapes):
    """Each forward kernel of phase 30 at every local shape its ranks gave it
    (``shapes``: by arch, (call, kernel call key, count) as ``_shape_tap``
    recorded them), held and timed by ``_sharded_kernel_case``.  Returns
    ``{kernel: {arch: [row, ...]}}``, each row with its call ("prefill" or
    "decode") and its launches a call on every rank."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    rows = {}
    for arch, calls in shapes.items():
        for call, (kernel, args, kw), count in calls:
            row = _sharded_kernel_case(torch, F, K, gen, kernel, args, kw)
            row.update(call=call, per_call=count)
            rows.setdefault(kernel, {}).setdefault(arch, []).append(row)
            lib = row["library_ms"]
            _print(f"[serve sharded kernels] {kernel} on a rank's shards, {arch} {call} "
                   f"({count} a call), {row['shape']}: max_abs_err={row['max_abs_err']:.3e} "
                   f"kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                   f"bound_us={1e3 * row['bound_ms']:.3f} ({row['bound_by']}) library_ms="
                   f"{'None' if lib is None else f'{lib:.5f}'} "
                   f"{_shares(row['ms'], row['bound_ms'], lib)}")
    return rows


def _sharded_serve_phase(torch, F, K):
    """Phase 30: every family's sharded prefill and decode steps on a (2, 2)
    mesh of SHARDED_RANKS processes sharing the card, held to the unsharded
    kernel path (the recurrent ones also in f32); the dry run of the same
    cells beside it; then each forward kernel at the local shapes the ranks
    gave it.  Returns each kernel's launches by arch and rank and its rows
    (``_sharded_kernel_rows``)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    tag = "[serve sharded]"
    smi = _smi()
    ref, per_call = {}, {}
    for key, arch, f32, steps in _sharded_runs():
        cfg = _sharded_cfg(arch, f32)
        gen = torch.Generator().manual_seed(SEED + 30)
        tokens = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, SHARDED_PROMPT + steps),
                               generator=gen, dtype=torch.int32)
        params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        cache = M.init_cache(cfg, SHARDED_BATCH, SHARDED_PROMPT + steps, device=DEVICE)
        tok = tokens.to(DEVICE)
        logits, counts = [], []
        with torch.no_grad():
            for i in range(steps + 1):
                _zero_counters(K)
                if i == 0:
                    cache, lg = M.prefill(cfg, params, {"tokens": tok[:, :SHARDED_PROMPT]}, cache)
                else:
                    cache, lg = M.decode_step(cfg, params, cache,
                                              tok[:, SHARDED_PROMPT + i - 1:SHARDED_PROMPT + i])
                torch.cuda.synchronize()
                counts.append(_read_counters(K))
                logits.append(lg[:, :cfg.vocab_size].float().cpu())
        ref[key] = {"tokens": tokens, "logits": logits}
        per_call[key] = counts
        del params, cache
        _free(torch)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:  # the logits: tens of MB
        ref_path = os.path.join(tmp, "unsharded.pt")
        torch.save(ref, ref_path)
        cells = {"ranks": list(range(SHARDED_RANKS)), "mesh": list(SHARDED_MESH),
                 "batch": SHARDED_BATCH, "prompt": SHARDED_PROMPT,
                 "archs": {a: (c[0], c[1]) for a, c in SHARDED_CELLS.items()}}
        env = dict(os.environ, PYTHONPATH=str(SRC))
        dry = subprocess.Popen([sys.executable, "-c", SHARDED_DRYRUN, json.dumps(cells), tmp],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = DIST_ALLOC_CONF  # read by each rank's allocator
        try:
            results = run_ranks(_serve_sharded_rank, SHARDED_RANKS, ref_path, device=DEVICE)
        finally:
            if kept is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = kept
            t2 = time.perf_counter()
            stdout, stderr = dry.communicate(timeout=600)
        t3 = time.perf_counter()
    assert dry.returncode == 0, stderr[-4000:]
    dryrun = json.loads(next(x for x in stdout.splitlines()
                             if x.startswith("DRYRUN "))[len("DRYRUN "):])
    launches = {arch: {rank: {name: 0 for name, _, _ in COUNTERS}
                       for rank in range(SHARDED_RANKS)} for arch in SHARDED_CELLS}
    shapes = {}
    for key, arch, f32, steps in _sharded_runs():
        cfg = _sharded_cfg(arch, f32)
        want = per_call[key]
        for rank, result in enumerate(results):
            cell = result[key]
            # every rank launches exactly what the unsharded path launches,
            # each launch a wrapper call the tap saw, at the same local shapes
            assert cell["launches"] == want, (key, rank, cell["launches"], want)
            for counts, seen in zip(cell["launches"], cell["shapes"]):
                tapped = {name: sum(n for (k, _, _), n in seen.items() if k == name)
                          for name in counts}
                assert all(tapped[n] == counts[n] for n, _, _, _ in SHARDED_WRAPPERS), (
                    key, rank, tapped, counts)
            assert cell["shapes"] == results[0][key]["shapes"], (key, rank)
        if f32:
            lead = results[0][key]
            worst = 0.0
            for got, w in zip(lead["logits"], ref[key]["logits"]):
                torch.testing.assert_close(got, w, atol=F32_ATOL, rtol=F32_ATOL)
                worst = max(worst, (got - w).abs().max().item())
            _print(f"{tag} {arch} in f32 at {cfg.n_layers} of {get_config(arch).n_layers} "
                   f"layers, full width, preset {cfg.sharding}: gathered logits of the prefill "
                   f"and {steps} decode step(s) vs the unsharded f32 kernel path: max_abs_diff "
                   f"{worst:.3e}, max_rel_l2 "
                   f"{max(_rel(g, w) for g, w in zip(lead['logits'], ref[key]['logits'])):.3e} "
                   f"(atol = rtol = {F32_ATOL}); launches a prefill {want[0]} on every rank")
            continue
        layers, _, tol = SHARDED_CELLS[arch]
        calls = {}
        for i, seen in enumerate(results[0][key]["shapes"]):
            for sig, n in seen.items():
                calls.setdefault(("prefill" if i == 0 else "decode", sig), n)
        shapes[arch] = [(call, sig, n) for (call, sig), n in calls.items()]
        pre, dec = dryrun[f"{arch}:prefill"], dryrun[f"{arch}:decode"]
        assert pre["status"] == dec["status"] == "ok", (pre, dec)
        for rank, result in enumerate(results):
            cell = result[key]
            for counts in cell["launches"]:
                for name in counts:
                    launches[arch][rank][name] += counts[name]
            # the dry run's per-device state is each rank's measured shard
            assert pre["state_bytes"]["params_bytes_per_device"] == cell["params_bytes"], (
                arch, rank, pre["state_bytes"], cell["params_bytes"])
            assert dec["state_bytes"]["params_bytes_per_device"] == cell["params_bytes"]
            assert dec["state_bytes"]["cache_bytes_per_device"] == cell["cache_bytes"], (
                arch, rank, dec["state_bytes"], cell["cache_bytes"])
            decode_s = sorted(cell["times"][1:])[len(cell["times"][1:]) // 2]
            coll = cell["collective_s"]
            calls_n = cell["collective_calls"]
            flops = pre["cost_analysis"]["flops"]
            _print(f"{tag} {arch} rank {rank}: prefill {cell['times'][0]:.4f} s (dry run: "
                   f"{flops:.4e} local matmul FLOPs, {flops / cell['times'][0] / 1e12:.3f} "
                   f"TFLOP/s over the measured prefill), median decode step {decode_s:.4f} s "
                   f"of {steps}; peak memory {cell['peak_gb']:.3f} GB (cap "
                   f"{SHARDED_MEMORY_FRACTION} of the card); collectives from the timers "
                   f"{sum(coll.values()):.3f} s "
                   f"{ {k: round(v, 4) for k, v in coll.items() if calls_n[k]} } over "
                   f"{ {k: v for k, v in calls_n.items() if v} } calls; local params "
                   f"{cell['params_bytes']} B and cache {cell['cache_bytes']} B = the dry "
                   f"run's; weights drawn in {cell['draw_s']:.2f} s; {smi}; {SHARDED_NOTE}")
        lead = results[0][key]
        assert lead["finite"], arch
        for rel in lead["rel"]:
            assert rel < tol[1], (arch, lead["rel"], tol)
        depth = f"{layers} of {get_config(arch).n_layers} layers" if layers else "nothing cut"
        _print(f"{tag} {arch} ({depth}), bf16, batch {SHARDED_BATCH} x {SHARDED_PROMPT} on a "
               f"{SHARDED_MESH} ('data', 'model') mesh, preset {cfg.sharding}: gathered logits "
               f"vs the unsharded kernel path, prefill then {steps} decode steps: max_rel_l2 "
               f"{max(lead['rel']):.4e} (tolerance {tol}), max_abs_diff {lead['max_abs']:.4f}; "
               f"launches a prefill {want[0]}, a decode step {want[1]} on every rank; dry run "
               f"per device: params {pre['state_bytes']['params_bytes_per_device']} B, cache "
               f"{dec['state_bytes']['cache_bytes_per_device']} B, collectives "
               f"{pre['collective_operand_bytes_per_device']} (prefill) "
               f"{dec['collective_operand_bytes_per_device']} (decode), peak "
               f"{pre['memory_analysis']['peak_bytes'] / 1e9:.3f} GB (prefill), "
               f"{pre['wall_seconds'] + dec['wall_seconds']:.1f} s of dry run")
    t4 = time.perf_counter()
    rows = _sharded_kernel_rows(torch, F, K, shapes)
    _print(f"{tag} phase 30 took {time.perf_counter() - t0:.1f} s ({t1 - t0:.1f} s for the "
           f"unsharded paths, {t2 - t1:.1f} s in the {SHARDED_RANKS} ranks, {t3 - t2:.1f} s "
           f"more waiting for the dry run beside them, {time.perf_counter() - t4:.1f} s for "
           f"the kernels at the ranks' shapes); {smi}; {SHARDED_NOTE}")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 31: the examples on the card (examples/*_torch.py)
# ---------------------------------------------------------------------------

# the reference quickstart's timer tree (examples/quickstart.py): (depth, path, count)
QUICKSTART_TREE = [
    (0, "poisson", 1), (1, "poisson/residual", 1), (0, "simulation/total", 1),
    (1, "bin/STARTUP", 1), (1, "bin/INITIAL", 1), (1, "bin/PRESTEP", 6), (1, "bin/EVOL", 6),
    (2, "EVOL/demo::evolve", 6), (3, "poisson/hot_loop", 6), (1, "bin/ANALYSIS", 6),
    (2, "ANALYSIS/demo::analysis", 3), (1, "bin/CHECKPOINT", 6), (1, "bin/OUTPUT", 6),
    (1, "bin/SHUTDOWN", 1)]
# the AMR demonstration at the example's defaults: the reference benchmark's
# checks (benchmarks/bench_adaptive_checkpoint.py:45-46) and the fixed run's
# checkpoints (every 8th of 120 iterations)
AMR_MAX_ADAPTIVE_SHARE, AMR_FIXED_CHECKPOINTS, AMR_PAPER_CUT = 0.08, 14, 0.17
# serve_llm at full-width llama3.2-1b through the kernels, the example's
# defaults otherwise (24 requests, prompts of 32, 16 new tokens, 8 slots)
SERVE_LLM_ARGV = ["--full", "--attn-impl", "pallas", "--norm-impl", "fused", "--target-ms", "50"]
# (n_layers, d_model) served, and the launches a prefill and a model call (phase 4's)
SERVE_LLM_SHAPE, SERVE_LLM_PER_PREFILL, SERVE_LLM_PER_CALL = (16, 2048), 16, 32
# train_llm: demo-100m at the example's defaults (batch 8 x seq 256, the copy
# task, adaptive checkpointing at 5%) through the kernels, TRAIN_LLM_STEPS
# steps (the example's 300 halved: the script's time limit); per step under
# remat "dots" (10 layers) 20 flash forwards, 10 dq, 10 dkv, 40 RMSNorm
# forwards and 20 backwards
TRAIN_LLM_STEPS, TRAIN_LLM_MAX_CKPT_SHARE = 150, 0.08
TRAIN_LLM_ARGV = ["--steps", str(TRAIN_LLM_STEPS), "--attn-impl", "pallas", "--norm-impl", "fused"]
TRAIN_LLM_PER_STEP = {"flash_fwd": 20, "flash_bwd_dq": 10, "flash_bwd_dkv": 10,
                      "rmsnorm_fwd": 40, "rmsnorm_bwd": 20, "rglru_fwd": 0, "wkv6_fwd": 0}


def _example(name):
    """``examples/<name>.py`` as a module (the directory is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses resolve their annotations there
    spec.loader.exec_module(module)
    return module


def _printed_tree(out):
    """(depth, path, count) of each row of a printed timer tree."""
    rows = []
    for line in out.split("Timer tree", 1)[1].splitlines()[4:]:
        if not line.strip():
            break
        path, count = line.split()[:2]
        rows.append(((len(line) - len(line.lstrip())) // 2, path, int(count)))
    return rows


def _fresh_registries() -> None:
    """The port's process-global timer database, steerable parameters and
    clocks as a fresh process has them, so that an example starts as its
    script does (an earlier phase's serving controller leaves
    ``serving.max_active`` steered, and a new ``ServeSession`` takes it)."""
    from repro_torch.core.clocks import reset_default_clocks
    from repro_torch.core.params import reset_param_registry
    from repro_torch.core.timers import reset_timer_db

    reset_timer_db()
    reset_param_registry()
    reset_default_clocks()


def _quickstart_phase(torch):
    """Phase 31 (a): the quickstart's ``main`` on the card; its timer tree
    must be the reference's (paths, nesting, counts), with xla_flops 24576
    and steps_done 6 on its EVOL routine and on the whole run."""
    import io

    example = _example("quickstart_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert example.main(["--device", DEVICE]) == 0
    out = out.getvalue()
    _print(out)
    tree = _printed_tree(out)
    assert tree == QUICKSTART_TREE, tree
    report = {line.split()[0]: line.split() for line in out.split("Timer tree")[0].splitlines()
              if line.startswith(("EVOL/demo::evolve ", "simulation/total "))}
    for name, fields in report.items():
        assert (int(fields[1]), float(fields[4]), float(fields[5])) == (
            6 if name.startswith("EVOL") else 1, 24576.0, 6.0), fields
    _print(f"[examples quickstart] on {torch.cuda.get_device_name(0)}: the timer tree is the "
           f"reference's ({len(tree)} rows); xla_flops 24576 and steps_done 6 on "
           f"EVOL/demo::evolve and simulation/total; {_smi()}")


def _amr_phase(torch):
    """Phase 31 (b): the AMR adaptive-checkpoint demonstration, fixed then
    adaptive, at the example's defaults with the levels on the card."""
    example = _example("amr_adaptive_checkpoint_torch")
    smi = _smi()
    res = {}
    with tempfile.TemporaryDirectory(dir=_ckpt_root()) as tmp:
        for mode in ("fixed", "adaptive"):
            res[mode] = example.run_experiment(example.AMRSettings(
                mode=mode, device=DEVICE, ckpt_dir=os.path.join(tmp, "amr")))
    for mode, r in res.items():
        at = [int(x["iteration"]) for x in r["fraction_trace"] if x["checkpointed"]]
        _print(f"[examples amr] {mode}: {r['iterations']} iterations, {r['final_levels']} "
               f"levels of 48^3 on the card: checkpoint share {r['checkpoint_fraction']:.6f}, "
               f"checkpoint_s {r['checkpoint_seconds']:.6f}, total_s {r['total_seconds']:.6f}, "
               f"checkpoints {r['n_checkpoints']} at iterations {at}, suppressed "
               f"{r['n_suppressed']}; {smi}")
    fixed, adaptive = res["fixed"], res["adaptive"]
    cut = 1.0 - adaptive["total_seconds"] / fixed["total_seconds"]
    _print(f"[examples amr] total runtime cut {cut:.4f} (the paper: ~{AMR_PAPER_CUT}); adaptive "
           f"checkpoint seconds {adaptive['checkpoint_seconds'] / fixed['checkpoint_seconds']:.4f}"
           f" of the fixed run's; {smi}")
    assert fixed["n_checkpoints"] == AMR_FIXED_CHECKPOINTS, fixed["n_checkpoints"]
    assert adaptive["checkpoint_fraction"] <= AMR_MAX_ADAPTIVE_SHARE, adaptive
    assert adaptive["checkpoint_seconds"] < 0.5 * fixed["checkpoint_seconds"], res
    return res


def _serve_llm_phase(torch, K):
    """Phase 31 (c): serve_llm at full-width llama3.2-1b through the kernels
    (SERVE_LLM_ARGV): every handle resolves, 16 flash forwards a prefill and
    32 RMSNorm forwards a prefill and a decode step, as phase 4 counts them."""
    from repro_torch import timing
    from repro_torch.core import adapt_rows

    tag = "[examples serve_llm]"
    example = _example("serve_llm_torch")
    args = example.parse_args(SERVE_LLM_ARGV)
    cfg, params = example.build(args)
    assert (cfg.n_layers, cfg.d_model, cfg.attn_impl, cfg.norm_impl) == (
        SERVE_LLM_SHAPE + ("pallas", "fused")), cfg
    with timing.session() as sess:
        _zero_counters(K)
        t0 = time.perf_counter()
        engine, handles = example.serve(cfg, params, args, sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(K)
        example.report(engine, handles, sess)
    n_prefill, prefill_s = _scope(sess, "serve/prefill")
    n_decode, decode_s = _scope(sess, "serve/decode")
    stats = engine.stats()
    assert all(h.done for h in handles) and len(handles) == args.requests, stats
    assert n_prefill == args.requests, n_prefill
    want = {name: 0 for name, _, _ in COUNTERS}
    want.update(flash_fwd=SERVE_LLM_PER_PREFILL * n_prefill,
                rmsnorm_fwd=SERVE_LLM_PER_CALL * (n_prefill + n_decode))
    assert launches == want, (launches, want, n_prefill, n_decode)
    decisions = [(r["step"], r["action"], r["trigger"]) for r in adapt_rows(engine.control_loop)
                 if r["controller"] == "serving"]
    _print(f"{tag} {args.requests} requests, prompts of {args.prompt_len}, {args.max_new} new "
           f"tokens, {args.slots} slots, target {args.target_ms} ms a decode step: wall_s="
           f"{wall:.3f} prefills={n_prefill} decode_steps={n_decode} launches={launches}; "
           f"completed {stats['completed']:.0f}, shed {stats['shed']:.0f}; tokens_per_s="
           f"{stats['throughput_tokens_per_s']:.3f} p95_ttft_s={stats['p95_ttft_s']:.5f} "
           f"serve/prefill_s={prefill_s:.5f} serve/decode_s={decode_s:.5f} (mean decode "
           f"{1e3 * decode_s / max(n_decode, 1):.3f} ms a step); {_smi()}")
    _print(f"{tag} ADAPT/serving decisions ({len(decisions)}): {decisions[:20]}")
    del engine, handles, params
    return launches, n_prefill, n_decode


def _train_llm_phase(torch, F, K, gen):
    """Phase 31 (d): train_llm's demo-100m through the kernels
    (TRAIN_LLM_STEPS steps of the example's defaults): exact launches a
    step, the logged loss falling, the checkpoint share at most
    TRAIN_LLM_MAX_CKPT_SHARE; then the five training kernels at its shapes
    and serve_llm's prefill's, held and timed as in phase 26."""
    from repro_torch.core import TimerLogger

    tag = "[examples train_llm]"
    example = _example("train_llm_torch")
    with tempfile.TemporaryDirectory(dir=_ckpt_root()) as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        argv = TRAIN_LLM_ARGV + ["--ckpt-dir", ckpt]
        cfg, settings = example.settings_for(example.parse_args(argv))
        cfg = cfg.replace(attn_impl=settings.attn_impl, norm_impl=settings.norm_impl)
        assert _per_step_launches(cfg) == TRAIN_LLM_PER_STEP, _per_step_launches(cfg)
        torch.cuda.reset_peak_memory_stats()
        _zero_counters(K)
        t0 = time.perf_counter()
        summary, sess = example.train(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(K)
        records = TimerLogger(os.path.join(ckpt, "timers.jsonl"), sess.db).read_all()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["extra"]["loss"] for r in records]
    window = max(len(losses) // 10, 1)
    first, last = (sum(xs) / len(xs) for xs in (losses[:window], losses[-window:]))
    share = summary["ckpt_fraction"]
    cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
    step_s = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    b, s = settings.global_batch, settings.seq_len
    at = sorted({0, 1, 10, 50, 100, 150, 200, 250, len(losses) - 1} & set(range(len(losses))))
    _print(f"{tag} {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
           f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}), bf16, batch {b} x {s}, "
           f"{TRAIN_LLM_STEPS} steps: wall_s={wall:.3f} launches={launches} (per step "
           f"{TRAIN_LLM_PER_STEP}); loss at steps {at}: {[round(losses[i], 4) for i in at]}; "
           f"mean of the first {window} {first:.4f}, of the last {window} {last:.4f}")
    _print(f"{tag} median_s(steps 2-{TRAIN_LLM_STEPS})={median_s:.5f} tokens_per_s(median step)="
           f"{b * s / median_s:.1f} checkpoint share {share:.5f} (limit "
           f"{TRAIN_LLM_MAX_CKPT_SHARE}), AdaptCheck {summary['checkpoint']['n_checkpoints']} "
           f"taken, {summary['checkpoint']['n_suppressed']} suppressed; "
           f"max_memory_allocated_GB={peak_gb:.3f}; {_smi()}")
    assert launches == {k: v * TRAIN_LLM_STEPS for k, v in TRAIN_LLM_PER_STEP.items()}, launches
    assert summary["iterations"] == TRAIN_LLM_STEPS == len(records), summary["iterations"]
    assert all(math.isfinite(x) for x in losses), losses
    assert last < first, (first, last)
    assert share <= TRAIN_LLM_MAX_CKPT_SHARE, summary["checkpoint"]
    del summary, sess
    _free(torch)
    rows = _training_kernels_rows(torch, F, K, gen, b, (cfg.n_heads, cfg.n_kv_heads),
                                  "[examples kernels]", f"at train_llm's {cfg.name}", s=s,
                                  hd=cfg.resolved_head_dim, d=cfg.d_model)
    serve = _training_kernels_rows(torch, F, K, gen, 1, (32, 8), "[examples kernels]",
                                   "at serve_llm's prefill", s=32,
                                   only=("flash_fwd", "rmsnorm_fwd"))
    return launches, rows, serve


def _examples_phase(torch, F, K, gen):
    """Phase 31: the four examples on the card (module docstring); returns
    the kernels' launches by example and their rows at the examples' shapes."""
    t0 = time.perf_counter()
    _fresh_registries()
    _quickstart_phase(torch)
    _fresh_registries()  # drops the quickstart's own clock too
    _amr_phase(torch)
    _fresh_registries()
    serve_launches, _, _ = _serve_llm_phase(torch, K)
    _free(torch)
    _fresh_registries()
    train_launches, rows, serve_rows = _train_llm_phase(torch, F, K, gen)
    _fresh_registries()
    _free(torch)
    _print(f"[examples] phase 31 took {time.perf_counter() - t0:.1f} s; {_smi()}")
    return {"serve_llm": serve_launches, "train_llm": train_launches}, rows, serve_rows


# ---------------------------------------------------------------------------
# phase 32: sharded MoE training
# ---------------------------------------------------------------------------

# moonshot-v1-16b-a3b at phase 21's depth and batch x seq on phase 28's (2, 2)
# mesh of processes sharing the card, "tp+fsdp" with the "embed" dispatch
# mode, MOE_DIST_STEPS steps ("tp" alone would hold ~20 GB of training state
# a rank, past the cap of DIST_MEMORY_FRACTION)
MOE_DIST_STEPS = 2


def _moe_dist_cfg():
    return _train_cfg("moonshot-v1-16b-a3b", n_layers=MOE_TRAIN_LAYERS).replace(
        sharding="tp+fsdp", moe_dispatch_mode="embed")


def _moe_dist_rank(rank, world, ref_path, log_dir):
    """One rank of phase 32: ``run_training`` for MOE_DIST_STEPS steps (the
    launches counted), then one loss-and-gradient step of the sharded path
    replaying the unsharded path's routing for this rank's rows, gathered
    and (rank 0) held leaf by leaf against the unsharded step saved at
    ``ref_path``.  Returns what the parent prints and holds."""
    import types

    import torch

    from repro_torch.core import TimerLogger
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.context import use_sharding
    from repro_torch.dist.meshutil import device_mesh
    from repro_torch.dist.sharding import Axes, distribute_tree
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import TrainSettings, run_training
    from repro_torch.models.layers import tree_map
    from repro_torch.timing import TimingSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_per_process_memory_fraction(DIST_MEMORY_FRACTION)
    K = types.SimpleNamespace(fa=fa, rn=rn)
    counters = COUNTERS[:5]  # the flash and RMSNorm kernels
    mesh = device_mesh(DIST_MESH, ("data", "model"), DEVICE, allow_shared_card=True)
    cfg = _moe_dist_cfg()
    out = {}
    _fresh_registries()
    log_path = os.path.join(log_dir, "moe.jsonl")
    settings = TrainSettings(
        arch="moonshot-v1-16b-a3b", smoke=False, steps=MOE_DIST_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, data_mode="copy", seed=SEED,
        report_every=0, log_path=log_path, device=DEVICE, lr_total_steps=TRAIN_STEPS,
        mesh_shape=DIST_MESH, allow_shared_card=True)
    sess = TimingSession()
    torch.cuda.reset_peak_memory_stats()
    for name, mod, attr in counters:
        setattr(getattr(K, mod), attr, 0)
    t0 = time.perf_counter()
    summary = run_training(settings, cfg=cfg, session=sess)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {name: getattr(getattr(K, mod), attr) for name, mod, attr in counters}
    out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["mesh"] = summary["mesh"]
    if rank == 0:
        records = TimerLogger(log_path, sess.db).read_all()
        out["losses"] = [r["extra"]["loss"] for r in records]
        cum = [r["timers"]["EVOL/trainer::train_step"]["walltime"] for r in records]
        out["step_s"] = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
    del sess, summary
    gc.collect()
    torch.cuda.empty_cache()

    # one loss-and-gradient step of the sharded path, from phase 21's weights
    # and batch, routing this rank's rows as the unsharded path did
    torch.cuda.reset_peak_memory_stats()
    rules = ST.rules_for(cfg)
    params = _sharded_params(torch, cfg, mesh, rules)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, mode="copy",
                                       seed=SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    axes = {k: Axes(v) for k, v in ST.batch_axes(cfg, "train").items()}
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    local = TRAIN_BATCH // DIST_MESH[0]  # "batch" lies on "data"
    rows = slice(mesh.get_local_rank(0) * local, (mesh.get_local_rank(0) + 1) * local)
    with use_sharding(mesh, rules), _routing_tap(torch, ref["routing"], rows) as seen:
        grads, metrics = ST._grads(cfg, params, distribute_tree(batch, axes, mesh, rules))
        out["loss"] = metrics["loss"].full_tensor().item()
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                         grads, params)
    assert list(seen) == list(ref["routing"]), "the layers routed in another order"
    out["own_share"] = [_choice_share(torch, own, top_i, cfg.moe.n_experts)
                        for top_i, _, _, own in seen.values()]
    del params
    rel = {}
    for name, g in _named_leaves(grads):
        full = g.full_tensor()  # a collective: every rank gathers every leaf
        if rank == 0:
            want = ref["grads"][name].to(DEVICE).float()
            rel[name] = ((full.float() - want).norm() / want.norm()).item()
        del full
    out["grad_rel"] = rel
    out["grad_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_dist_train_phase(torch, F, K, gen):
    """Phase 32: moonshot-v1-16b-a3b trained sharded over a ("data",
    "model") mesh of DIST_RANKS processes sharing the card (module
    docstring).  Returns the kernels' rows at a rank's local shapes and each
    rank's launches."""
    from repro_torch.data import SyntheticConfig, SyntheticLM
    from repro_torch.dist.collectives import COLLECTIVES
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    tag = "[moe dist]"
    smi = _smi()
    cfg = _moe_dist_cfg()
    local_batch = TRAIN_BATCH // DIST_MESH[0]
    heads = (cfg.n_heads // DIST_MESH[1], cfg.n_kv_heads // DIST_MESH[1])
    rows = _training_kernels_rows(torch, F, K, gen, local_batch, heads, "[moe dist kernels]",
                                  "at a rank's local shards", hd=cfg.resolved_head_dim,
                                  d=cfg.d_model)
    _free(torch)
    per_step = _per_step_launches(cfg)
    assert per_step == MOE_TRAIN_PER_STEP, per_step
    # the unsharded kernel path's step on phase 21's weights and batch, and its routing
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    data = SyntheticLM(SyntheticConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, mode="copy",
                                       seed=SEED), arch=cfg).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.items()}
    with _routing_tap(torch) as chosen:
        loss_ref, gn_ref, grads = _loss_and_grads(torch, cfg, params, batch)
    assert len(chosen) == cfg.n_layers, len(chosen)
    names = [name for name, _ in _named_leaves(params)]
    with tempfile.TemporaryDirectory(dir=_ckpt_root()) as tmp:
        ref_path = os.path.join(tmp, "unsharded.pt")
        torch.save({"grads": {name: g.cpu() for name, g in zip(names, grads)},
                    "routing": {key: tap[0].cpu() for key, tap in chosen.items()}},
                   ref_path)
        del params, batch, grads, chosen
        _free(torch)
        t1 = time.perf_counter()
        kept = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = DIST_ALLOC_CONF  # read by each rank's allocator
        try:
            results = run_ranks(_moe_dist_rank, DIST_RANKS, ref_path, tmp, device=DEVICE)
        finally:
            if kept is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = kept
        ranks_s = time.perf_counter() - t1
    want = {k: v * MOE_DIST_STEPS for k, v in per_step.items() if k in results[0]["launches"]}
    for rank, r in enumerate(results):
        assert r["launches"] == want, (rank, r["launches"], want)
        coll = r["mesh"]["collective_seconds"]
        calls, moved = r["mesh"]["collective_calls"], r["mesh"]["collective_bytes"]
        assert set(calls) == set(COLLECTIVES), calls
        _print(f"{tag} rank {rank}: launches {r['launches']} (phase 21's per step x "
               f"{MOE_DIST_STEPS}); peak memory {r['train_peak_gb']:.3f} GB training, "
               f"{r['grad_peak_gb']:.3f} GB in the held step (cap {DIST_MEMORY_FRACTION} of "
               f"the card); collectives from the timers {sum(coll.values()):.3f} s "
               f"{ {k: round(v, 4) for k, v in coll.items() if calls[k]} } over "
               f"{ {k: v for k, v in calls.items() if v} } calls of "
               f"{ {k: round(v / 1e9, 4) for k, v in moved.items() if v} } GB; routing: the "
               f"share of the unsharded path's choices this rank would have made alike, by "
               f"layer {[round(x, 5) for x in r['own_share']]}; wall_s {r['wall_s']:.2f}; "
               f"{smi}; {DIST_NOTE}")
    lead = results[0]
    losses, step_s = lead["losses"], lead["step_s"]
    assert len(losses) == MOE_DIST_STEPS and all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - loss_ref) <= TRAIN_RTOL * abs(loss_ref), (losses, loss_ref)
    assert abs(lead["loss"] - loss_ref) <= TRAIN_RTOL * abs(loss_ref), (lead["loss"], loss_ref)
    rel = lead["grad_rel"]
    worst = max(rel, key=rel.get)
    assert sorted(rel) == sorted(names) and rel[worst] < LEAF_RTOL, rel
    _print(f"{tag} moonshot-v1-16b-a3b at full width, {cfg.n_layers} of 48 layers, bf16, "
           f"remat dots, \"tp+fsdp\", moe_dispatch_mode \"embed\", batch {TRAIN_BATCH} x "
           f"{TRAIN_SEQ} over a {DIST_MESH} ('data', 'model') mesh ({heads[0]}/{heads[1]} heads "
           f"of {cfg.resolved_head_dim}, {cfg.moe.n_experts // DIST_MESH[1]} of "
           f"{cfg.moe.n_experts} experts and batch {local_batch} a rank): losses "
           f"{[round(x, 5) for x in losses]} (the unsharded step's {loss_ref:.5f}); step_s "
           f"{[round(x, 4) for x in step_s]}; one sharded loss-and-gradient step replaying the "
           f"unsharded path's routing vs that path: loss {lead['loss']:.6f} vs {loss_ref:.6f} "
           f"(TRAIN_RTOL {TRAIN_RTOL}), worst of {len(rel)} gathered leaves {rel[worst]:.3e} "
           f"({worst}; LEAF_RTOL {LEAF_RTOL}), median {sorted(rel.values())[len(rel) // 2]:.3e}"
           f"; {smi}; {DIST_NOTE}")
    _print(f"{tag} phase 32 took {time.perf_counter() - t0:.1f} s ({ranks_s:.1f} s in the "
           f"{DIST_RANKS} ranks); {smi}; {DIST_NOTE}")
    return rows, {rank: r["launches"] for rank, r in enumerate(results)}


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _setup(torch):
    """Phase 1: print the card and its power limit, build and load the
    kernels; returns their wrapper modules.  One phase alone runs as
    ``python3 -c 'import torch, chip_smoke as cs; cs._moe_train_phase(torch,
    cs._setup(torch))'`` from the checkout's root."""
    import types

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rwkv6 import ops as wk_ops

    smi = _smi()
    _print(smi)
    _print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _print(f"[build] {len(COUNTERS)} kernels from {', '.join(f'{n}.cu' for n in build.SOURCES)} "
           f"built and loaded in {build.build_all():.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    return types.SimpleNamespace(fa=fa_ops, rn=rn_ops, rg=rg_ops, wk=wk_ops)


_SCRIPT_START = time.perf_counter()
_PHASE_START = [_SCRIPT_START]


def _phase_done(label: str) -> None:
    """Print the wall seconds since the last phase ended (or the script
    started) under ``label``, the phase or phases that ran in them; on
    standard error too, with the seconds since the script started, so the
    end of the error stream shows how far a run that was stopped got."""
    now = time.perf_counter()
    _print(f"[phase {label}] {now - _PHASE_START[0]:.1f} s")
    print(f"chip_smoke: phase {label} done, {now - _SCRIPT_START:.1f} s since the start",
          file=sys.stderr, flush=True)
    _PHASE_START[0] = now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    K = _setup(torch)
    _phase_done("1")
    fa_ops, rn_ops, rg_ops, wk_ops = K.fa, K.rn, K.rg, K.wk
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = _flash_phase(torch, F, fa_ops, gen)
    _phase_done("2")
    rms = _rmsnorm_phase(torch, F, rn_ops, gen)
    _phase_done("3")
    launches, engine, sess = _serve_phase(
        torch, K, "llama3.2-1b", PROMPT_LENS, {"flash_fwd": 16}, {"rmsnorm_fwd": 32},
        (16, 2048, 32, 8, 64, 128256, None), ("elementwise", MODEL_ATOL))
    _phase_done("4")
    _profile_phase(torch, engine, sess, PROMPT_LENS)
    del engine, sess
    _free(torch)
    _phase_done("5")

    flash_bwd = _flash_bwd_phase(torch, F, fa_ops, gen)
    _phase_done("6")
    rms_bwd = _rmsnorm_bwd_phase(torch, F, rn_ops, gen)
    torch.cuda.empty_cache()
    _phase_done("7")
    train_launches, cfg, train_losses, *_ = _train_phase(torch, K)
    params, batch = _train_compare_phase(torch, cfg)
    _phase_done("8")
    _train_profile_phase(torch, cfg, params, batch)
    del params, batch
    _free(torch)
    _phase_done("9")

    rglru = _rglru_phase(torch, rg_ops, gen)
    _phase_done("10")
    wkv6 = _wkv6_phase(torch, wk_ops, gen)
    _free(torch)
    _phase_done("11")
    # recurrentgemma-9b: 13 rglru and 25 attn_local layers, 2 norms each
    hybrid_launches, engine, sess = _serve_phase(
        torch, K, "recurrentgemma-9b", HYBRID_PROMPT_LENS,
        {"rglru_fwd": 13, "flash_fwd": 25}, {"rmsnorm_fwd": 76},
        (38, 4096, 16, 1, 256, 256000, 2048), ("relnorm", RECURRENT_REL))
    _phase_done("12")
    _profile_phase(torch, engine, sess, HYBRID_PROMPT_LENS, "[profile recurrentgemma-9b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "recurrentgemma-9b", 4, HYBRID_PROMPT_LENS)
    _free(torch)
    _phase_done("13")
    # rwkv6-1.6b: 24 rwkv layers, 3 norms each (ln1, the group norm, ln2)
    ssm_launches, engine, sess = _serve_phase(
        torch, K, "rwkv6-1.6b", PROMPT_LENS, {"wkv6_fwd": 24}, {"rmsnorm_fwd": 72},
        (24, 2048, 32, 32, 64, 65536, None), ("relnorm", RECURRENT_REL))
    _phase_done("14")
    _profile_phase(torch, engine, sess, PROMPT_LENS, "[profile rwkv6-1.6b]")
    del engine, sess
    _free(torch)
    _f32_phase(torch, "rwkv6-1.6b", 24, PROMPT_LENS)
    _free(torch)
    _phase_done("15")
    smoke_launches = _smoke_phase(torch, K)
    _free(torch)
    _phase_done("16")
    ckpt_launches = _ckpt_phase(torch, K)
    _free(torch)
    _phase_done("17")
    ssm_train_launches = _train_family_phase(torch, K, "rwkv6-1.6b", TRAIN_BATCH, TRAIN_SEQ,
                                             n_layers=SSM_TRAIN_LAYERS, leaf_rtol=RECURRENT_REL)
    _phase_done("18")
    hybrid_train_launches = _train_family_phase(
        torch, K, "recurrentgemma-9b", HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ,
        n_layers=HYBRID_TRAIN_LAYERS)
    _phase_done("19")
    # moonshot-v1-16b-a3b: 48 attention layers with MoE feed-forwards, 2 norms each
    moe_launches = _moe_phase(torch, K)
    _phase_done("20")
    # and its training at 4 layers, the flash backward at head_dim 128
    moe_train_launches = _moe_train_phase(torch, K)
    _phase_done("21")
    # internvl2-26b: 48 attention layers (GQA 48/8 at head_dim 128), 2 norms
    # each at width 6144, behind a 256-patch prefix; then its training at 4
    vlm_launches = _vlm_phase(torch, K)
    _phase_done("22")
    vlm_train_launches = _vlm_train_phase(torch, K)
    _phase_done("23")
    # seamless-m4t-large-v2: 24 encoder and 24 decoder layers (16/16 heads
    # of 64, width 1024), the non-causal flash instances; served, then
    # trained, at full depth
    encdec_launches = _encdec_phase(torch, K)
    _phase_done("24")
    encdec_train_launches = _encdec_train_phase(torch, K)
    _phase_done("25")
    # llama3.2-1b through the 1F1B pipeline schedule: one stage through the
    # launcher, then 4 ranks sharing the card
    pipe_rows, pipe_launches, pipe_ref = _pipeline_phase(torch, F, K, gen)
    _free(torch)
    _phase_done("26")
    # the serving soak at full width under its live /metrics scrape, the
    # training soak, the fault drills, and real multi-process fleets
    soak_launches = _soak_phase(torch, K)
    _free(torch)
    _phase_done("27")
    # full-width llama3.2-1b sharded over a (2, 2) DeviceMesh of 4 processes
    # sharing the card, under "tp" and "tp+fsdp"
    dist_rows, dist_launches = _dist_train_phase(torch, F, K, gen, train_losses)
    _free(torch)
    _phase_done("28")
    # full-width llama3.2-1b through the 1F1B schedule with one process a
    # stage (4 sharing the card), held to phase 26's single controller
    procs_launches = _procs_phase(torch, pipe_ref)
    _free(torch)
    _phase_done("29")
    # every family's sharded prefill and decode steps on a (2, 2) mesh of 4
    # processes sharing the card, and the dry run of the same cells
    sharded_launches, sharded_rows = _sharded_serve_phase(torch, F, K)
    _free(torch)
    _phase_done("30")
    # the four examples on the card: the quickstart, the paper's AMR
    # adaptive-checkpoint demonstration, serve_llm and train_llm
    example_launches, example_rows, example_serve_rows = _examples_phase(torch, F, K, gen)
    _phase_done("31")
    # moonshot-v1-16b-a3b at 4 layers, "tp+fsdp" over a (2, 2) DeviceMesh of 4
    # processes sharing the card
    moe_dist_rows, moe_dist_launches = _moe_dist_train_phase(torch, F, K, gen)
    _free(torch)
    _phase_done("32")

    # each kernel at the shapes of its main path: the forward kernels on the
    # serving path (their launches in phase 4) and, under "train", on the
    # training path (phase 8); the backward kernels on the training path; the
    # recurrence kernels and, under "hybrid", flash at head_dim 256 and the
    # RMSNorm forward at width 4096 on the serving paths of phases 12 and 14;
    # under "smoke", the flash kernels at
    # head_dim 16 on phase 16's paths; under "resume", the training kernels
    # on phase 17's two runs (phase 8's shapes); under "ssm_train" and
    # "hybrid_train", the training paths of phases 18 and 19 (rwkv6-1.6b's
    # norms; recurrentgemma-9b's flash kernels at head_dim 256 and norms);
    # under "moe", phase 20's serving path (flash at head_dim 128, the
    # norms at llama's prefill rows); under "moe_train", phase 21's training
    # path (flash forward and backward at head_dim 128, the norms at
    # (4096, 2048), phase 8's rows); under "vlm", phase 22's serving path
    # (flash at head_dim 128 under GQA 48/8 behind the 256 patches, the
    # norms at width 6144 at the long prompt's prefill rows); under
    # "vlm_train", phase 23's training path (B=4 x 1280 positions); under
    # "encdec", phase 24's serving path (flash not causal at head_dim 64,
    # the norms at width 1024 at the long prompt's prefill rows); under
    # "encdec_train", phase 25's training path (B=4 x 1024, width 1024);
    # under "pipeline" and "pipeline_4", phase 26's two pipelined paths (the
    # launches of (a)'s 4 steps and of (b)'s one equal-plan call; the
    # kernels at one microbatch's shapes, B=1 x 1024 and 1024 RMSNorm rows);
    # under "soak", phase 27's serving soak (its launches; the kernels at its
    # longest prefill, S=T=15 and 15 RMSNorm rows); under "dist_train", phase
    # 28's sharded training (rank 0's launches over its two runs; the
    # kernels at a rank's local shapes, B=2 x 1024 with 16/4 heads and 2048
    # RMSNorm rows); under "pipeline_procs", phase 29's run_training on 4
    # processes (each rank's launches over its 4 steps, and their sum; the
    # kernels at phase 26's one-microbatch shapes, which each process gives
    # them); under "serve_sharded", phase 30's sharded prefills and decode
    # steps by arch (each rank's launches; the kernel at every local shape
    # the ranks gave it, the heaviest one's numbers on top); under
    # "examples", phase 31's examples (train_llm's launches and the kernels
    # at demo-100m's shapes, B=8 S=T=256 10/5 heads of 64 and (2048, 640)
    # RMSNorm rows; serve_llm's launches and the forward kernels at its
    # prefill, B=1 S=T=32 32/8 heads of 64 and (32, 2048)); under
    # "moe_dist_train", phase 32's sharded MoE training (each rank's
    # launches; the kernels at a rank's local shapes, B=2 S=T=1024 8/8 heads
    # of 128 and (2048, 2048))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    csrc = "src/repro_torch/kernels/csrc/"
    pick = lambda row: {k: row[k] for k in keys}  # noqa: E731
    # the head_dim-16 kernels on phase 16's paths: launches by path, and the
    # bf16 causal case of phases 2 and 6 at their shapes
    smoke = lambda name, rows: dict(  # noqa: E731
        launches={path: n[name] for path, n in smoke_launches.items()},
        **pick(next(r for r in rows if r["case"] == SMOKE_CASE)))
    resume = lambda name, row: dict(  # noqa: E731
        launches={run: n[name] for run, n in ckpt_launches.items()}, **pick(row))
    case = lambda rows, name: next(r for r in rows if r["case"] == name)  # noqa: E731
    ssm = lambda name, row: dict(launches=ssm_train_launches[name], **pick(row))  # noqa: E731
    hyb = lambda name, row: dict(launches=hybrid_train_launches[name], **pick(row))  # noqa: E731
    moe_tr = lambda name, row: dict(launches=moe_train_launches[name], **pick(row))  # noqa: E731
    vlm_tr = lambda name, row: dict(launches=vlm_train_launches[name], **pick(row))  # noqa: E731
    enc_tr = lambda name, row: dict(launches=encdec_train_launches[name], **pick(row))  # noqa: E731
    pipe = lambda name: {path: dict(launches=n[name], **pick(pipe_rows[name]))  # noqa: E731
                         for path, n in pipe_launches.items()}
    dist = lambda name: dict(launches=dist_launches[name], **pick(dist_rows[name]))  # noqa: E731
    procs = lambda name: dict(  # noqa: E731
        launches={rank: n[name] for rank, n in procs_launches.items()}, **pick(pipe_rows[name]))
    def examples(name):
        """Phase 31's rows of a kernel: train_llm's, and serve_llm's for the
        forward kernels."""
        out = {"train_llm": dict(launches=example_launches["train_llm"][name],
                                 **pick(example_rows[name]))}
        if name in ("flash_fwd", "rmsnorm_fwd"):
            out["serve_llm"] = dict(launches=example_launches["serve_llm"][name],
                                    **pick(example_serve_rows[name]))
        return out
    moe_dist = lambda name: dict(  # noqa: E731
        launches={rank: n[name] for rank, n in moe_dist_launches.items()},
        **pick(moe_dist_rows[name]))
    def sharded(name):
        """Phase 30's rows of a kernel by arch: its launches by rank, the
        numbers of its heaviest call (the largest bound) and every local
        shape the ranks gave it."""
        out = {}
        for arch, cases in sharded_rows[name].items():
            top = max(cases, key=lambda r: r["bound_ms"])
            out[arch] = dict(
                launches={rank: n[name] for rank, n in sharded_launches[arch].items()},
                shape=top["shape"], **pick(top),
                cases=[dict(call=r["call"], shape=r["shape"], per_call=r["per_call"], **pick(r))
                       for r in cases])
        return out
    # the RMSNorm cases of phases 3 and 7 at the training paths' rows
    rows_2048 = f"({TRAIN_BATCH * TRAIN_SEQ}, 2048)"
    rows_4096 = f"({HYBRID_TRAIN_BATCH * HYBRID_TRAIN_SEQ}, 4096)"
    fwd_2048, fwd_4096 = (case(rms, f"{n} bf16") for n in (rows_2048, rows_4096))
    fwd_prefill = case(rms, f"({HYBRID_PROMPT_LENS[0]}, 4096) bf16")
    bwd_2048, bwd_4096 = (case(rms_bwd, f"{n} bfloat16") for n in (rows_2048, rows_4096))
    rows_6144 = f"({TRAIN_BATCH * VLM_TRAIN_SEQ}, 6144)"
    fwd_vlm = case(rms, f"({VLM_PATCHES + PROMPT_LENS[0]}, 6144) bf16")
    fwd_6144, bwd_6144 = case(rms, f"{rows_6144} bf16"), case(rms_bwd, f"{rows_6144} bfloat16")
    rows_1024 = f"({TRAIN_BATCH * TRAIN_SEQ}, 1024)"
    fwd_encdec = case(rms, f"({PROMPT_LENS[0]}, 1024) bf16")
    fwd_1024, bwd_1024 = case(rms, f"{rows_1024} bf16"), case(rms_bwd, f"{rows_1024} bfloat16")
    record = {"kernels": [
        dict(name="flash_fwd", route="cuda", source=csrc + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=launches["flash_fwd"], **pick(_role(flash, "serve")),
             train=dict(launches=train_launches["flash_fwd"], **pick(_role(flash, "train"))),
             hybrid=dict(launches=hybrid_launches["flash_fwd"], **pick(_role(flash, "hybrid"))),
             smoke=smoke("flash_fwd", flash), resume=resume("flash_fwd", _role(flash, "train")),
             hybrid_train=hyb("flash_fwd", _role(flash, "hybrid_train")),
             moe=dict(launches=moe_launches["flash_fwd"], **pick(_role(flash, "moe"))),
             moe_train=moe_tr("flash_fwd", _role(flash, "moe_train")),
             vlm=dict(launches=vlm_launches["flash_fwd"], **pick(_role(flash, "vlm"))),
             vlm_train=vlm_tr("flash_fwd", _role(flash, "vlm_train")),
             encdec=dict(launches=encdec_launches["flash_fwd"], **pick(_role(flash, "encdec"))),
             encdec_train=enc_tr("flash_fwd", _role(flash, "encdec_train")),
             **pipe("flash_fwd"),
             soak=dict(launches=soak_launches["flash_fwd"], **pick(_role(flash, "soak"))),
             dist_train=dist("flash_fwd"),
             pipeline_procs=procs("flash_fwd"),
             serve_sharded=sharded("flash_fwd"),
             examples=examples("flash_fwd"), moe_dist_train=moe_dist("flash_fwd")),
        dict(name="flash_bwd_dq", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:176",
             launches=train_launches["flash_bwd_dq"], **pick(flash_bwd["flash_bwd_dq"][0]),
             smoke=smoke("flash_bwd_dq", flash_bwd["flash_bwd_dq"]),
             resume=resume("flash_bwd_dq", flash_bwd["flash_bwd_dq"][0]),
             hybrid_train=hyb("flash_bwd_dq", _role(flash_bwd["flash_bwd_dq"], "hybrid")),
             moe_train=moe_tr("flash_bwd_dq", _role(flash_bwd["flash_bwd_dq"], "moe_train")),
             vlm_train=vlm_tr("flash_bwd_dq", _role(flash_bwd["flash_bwd_dq"], "vlm_train")),
             encdec_train=enc_tr("flash_bwd_dq",
                                 _role(flash_bwd["flash_bwd_dq"], "encdec_train")),
             **pipe("flash_bwd_dq"), dist_train=dist("flash_bwd_dq"),
             pipeline_procs=procs("flash_bwd_dq"),
             examples=examples("flash_bwd_dq"), moe_dist_train=moe_dist("flash_bwd_dq")),
        dict(name="flash_bwd_dkv", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:242",
             launches=train_launches["flash_bwd_dkv"], **pick(flash_bwd["flash_bwd_dkv"][0]),
             smoke=smoke("flash_bwd_dkv", flash_bwd["flash_bwd_dkv"]),
             resume=resume("flash_bwd_dkv", flash_bwd["flash_bwd_dkv"][0]),
             hybrid_train=hyb("flash_bwd_dkv", _role(flash_bwd["flash_bwd_dkv"], "hybrid")),
             moe_train=moe_tr("flash_bwd_dkv", _role(flash_bwd["flash_bwd_dkv"], "moe_train")),
             vlm_train=vlm_tr("flash_bwd_dkv", _role(flash_bwd["flash_bwd_dkv"], "vlm_train")),
             encdec_train=enc_tr("flash_bwd_dkv",
                                 _role(flash_bwd["flash_bwd_dkv"], "encdec_train")),
             **pipe("flash_bwd_dkv"), dist_train=dist("flash_bwd_dkv"),
             pipeline_procs=procs("flash_bwd_dkv"),
             examples=examples("flash_bwd_dkv"), moe_dist_train=moe_dist("flash_bwd_dkv")),
        dict(name="rmsnorm_fwd", route="cuda", source=csrc + "rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:30",
             launches=launches["rmsnorm_fwd"], **pick(rms[0]),
             train=dict(launches=train_launches["rmsnorm_fwd"], **pick(fwd_2048)),
             hybrid=dict(launches=hybrid_launches["rmsnorm_fwd"], **pick(fwd_prefill)),
             resume=resume("rmsnorm_fwd", fwd_2048), ssm_train=ssm("rmsnorm_fwd", fwd_2048),
             hybrid_train=hyb("rmsnorm_fwd", fwd_4096),
             moe=dict(launches=moe_launches["rmsnorm_fwd"], **pick(rms[0])),
             moe_train=moe_tr("rmsnorm_fwd", fwd_2048),
             vlm=dict(launches=vlm_launches["rmsnorm_fwd"], **pick(fwd_vlm)),
             vlm_train=vlm_tr("rmsnorm_fwd", fwd_6144),
             encdec=dict(launches=encdec_launches["rmsnorm_fwd"], **pick(fwd_encdec)),
             encdec_train=enc_tr("rmsnorm_fwd", fwd_1024), **pipe("rmsnorm_fwd"),
             soak=dict(launches=soak_launches["rmsnorm_fwd"],
                       **pick(case(rms, f"({SOAK_PROMPT_MAX}, 2048) bf16"))),
             dist_train=dist("rmsnorm_fwd"),
             pipeline_procs=procs("rmsnorm_fwd"),
             serve_sharded=sharded("rmsnorm_fwd"),
             examples=examples("rmsnorm_fwd"), moe_dist_train=moe_dist("rmsnorm_fwd")),
        dict(name="rmsnorm_bwd", route="cuda", source=csrc + "rmsnorm_bwd.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:75",
             launches=train_launches["rmsnorm_bwd"], **pick(rms_bwd[0]),
             resume=resume("rmsnorm_bwd", rms_bwd[0]),
             ssm_train=ssm("rmsnorm_bwd", bwd_2048), hybrid_train=hyb("rmsnorm_bwd", bwd_4096),
             moe_train=moe_tr("rmsnorm_bwd", bwd_2048),
             vlm_train=vlm_tr("rmsnorm_bwd", bwd_6144),
             encdec_train=enc_tr("rmsnorm_bwd", bwd_1024), **pipe("rmsnorm_bwd"),
             dist_train=dist("rmsnorm_bwd"),
             pipeline_procs=procs("rmsnorm_bwd"),
             examples=examples("rmsnorm_bwd"), moe_dist_train=moe_dist("rmsnorm_bwd")),
        dict(name="rglru_fwd", route="cuda", source=csrc + "rglru.cu",
             replaces="src/repro/kernels/rglru/kernel.py:53",
             launches=hybrid_launches["rglru_fwd"], **pick(rglru[0]),
             serve_sharded=sharded("rglru_fwd")),
        dict(name="wkv6_fwd", route="cuda", source=csrc + "rwkv6.cu",
             replaces="src/repro/kernels/rwkv6/kernel.py:65",
             launches=ssm_launches["wkv6_fwd"], **pick(wkv6[0]),
             serve_sharded=sharded("wkv6_fwd")),
    ]}
    _print(json.dumps(record))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
