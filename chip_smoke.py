#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Netflix x 0.1, k=100, p=8, 3 epochs;
                                     # Qwen2.5-32B serving and training;
                                     # the MoE, SSM and hybrid LMs;
                                     # the LMs on 4 ranks (serving;
                                     # Qwen2.5-32B, Qwen3-MoE and
                                     # Falcon-Mamba training);
                                     # streaming; then
                                     # the full Netflix size: NOMAD, its
                                     # SPMD executor in 8 ranks (then, in
                                     # the same ranks, Qwen3-MoE at tp 8
                                     # with its 4 KV heads shared), then
                                     # the paper's baselines

Phases, one line each (any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions;
1. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, in parallel, sm_90a) and prints the build seconds;
2. data + pack of the main path's problem, then every kernel wrapper
   against its plain PyTorch version on cells cut from that pack (a
   window of its padded wave layout, ``partition.padded_waves``), at
   k=100, in fp32 and in bf16 with fp32 accumulation (bf16 also held to
   ``repro_torch.testing.assert_rare_flips``, with two controls that it
   must reject: the plain version accumulating in bf16, and no update at
   all); grid == per-cell == sequential, bitwise;
3. the main path: ``repro_torch.api.solve`` with ``kernel="wave_pallas"``
   for 3 epochs (one kernel launch per schedule step), then one epoch
   of each other route (``wave_pallas`` per cell, and ``pallas``: every
   rating its own wave, one launch per step), each with the launch
   counts zeroed before and read after, and a sha256 digest of its
   factors (equal digests from two trees in one call: bitwise equal
   results); and a small problem solved on the card against the plain
   versions on the CPU;
4. timing with CUDA events on the main path's real step layout, for
   each route the launch it makes, beside its byte bound, chain length,
   chain bound and the plain version's time on the same inputs, with the
   kernel's plan (``variant``) on every line; where the hottest cell's
   waves spend their time (``[4.wave.split]``, ``clock64()`` samples of
   the kernel's profile build) with H in global memory beside the ring
   and as the plan lays it out, each bitwise the launch's result (the
   variant for an H block too large for shared memory is held against
   its plain version at full Netflix, phase 9); and
   ``nomad_sgd_block`` on a whole cell, bitwise equal to the sequential
   route's launch;
5. serving: the main path's result saved with ``save_fit_result``,
   ``RecServer.from_checkpoint`` booted from it (factors bitwise the
   trained ones), 500 queries through ``serve_mc.run_load`` (4 clients,
   ``max_batch=64``, top-10) without and with ``filter_rated``, every
   microbatch through the CUDA top-k kernel and none through its plain
   version; then the kernel against its plain version on the trained
   factors (within tolerance) at every user bucket the serving runs
   launched (top-10 and their filtered over-fetch) and at U=64, and its
   time, taken three times;
6. the top-k kernel at the Yahoo! Music catalog (624,961 items, 1,999,990
   users, k=100) on seeded factors published through ``FactorStore`` in
   fp32, bf16 and int8: for U in {1, 8, 64} users at top-10 and U=64 at
   top-1,000, its plan (users per CTA, stripes, shared memory, registers
   from ``cudaFuncGetAttributes``) and time (CUDA events) beside its
   bound, the plain version's and ``torch.topk(W_u @ H.T)``'s, and at
   U=64 where the device time goes (``[6.topk.split]``: pass 1, the
   merge rounds, the decode, and pass 1 scoring alone); bitwise against
   the plain version on integer-valued factors and on a catalog whose
   scores rise with the item id (every item passes the threshold), with
   that catalog's time; within tolerance on the seeded factors; and a
   control that must be rejected (the tie rule reversed);
7. the LM: Qwen2.5-32B at full width and depth (64 layers, bf16, seeded
   weights on the card) served through ``repro_torch.launch.serve``:
   prefill of 4 prompts of 1,024 tokens (every layer's attention through
   the CUDA flash kernel, none through its plain version), the merge into
   decode caches of 1,028 positions and 4 greedy decode steps, twice
   (warm-up, measured); prefill and decode times
   beside their bounds,
   peak memory; on the same weights the prefill's logits with the kernel
   against the plain chunked flash (``impl="xla"``), a control that
   check must reject (the first layer's attention unmasked), and decode
   after prefill against the full forward; the prefill and 4 decode steps
   under ``torch.profiler`` (device busy share, largest kernels); then
   each flash kernel's registers, shared memory and spills
   (``cudaFuncGetAttributes``); the kernel against its plain version at
   the served shape in bf16, fp16 and fp32 (fp32 also against the
   materialized oracle; bf16/fp16 within the P-rounding bound of
   ``repro_torch.testing.flash_p_rounding_tolerance``) and in bf16 at
   (S, D) = (200, 64) and (1024, 36), two controls it must reject in
   each (no causal mask; KV head ``h % Hkv``), and at the served shape
   its time beside its bound, the plain version's and SDPA's;
8. streaming, elasticity and integrity at the main path's full width,
   warm from phase 3's result (its pack a cache hit): a
   ``StreamingSession`` absorbs two arrival batches (each 1 % new
   ratings, 1 % new users and items, a 5 % held-out share), one epoch
   each (``[8.stream]``: repack, grow and epoch seconds, the layout and
   the kernel's plan, RMSE and digest per round), equal to the same
   chain through ``partial_fit``; a worker leaves and one joins
   (``[8.elastic]``: re-pack and migrate seconds), and after every grow
   and migrate the wave kernel runs the new layout's hottest step (256
   waves) against its plain version, with a control it must reject; a
   killed worker recovers from the session's checkpoints onto the
   digest of a graceful twin, once more with the newest checkpoint
   bit-flipped (quarantined) (``[8.kill]``); ``solve(faults=)`` cut
   after 2 epochs and resumed equals phase 3's run (``[8.faults]``); a
   ``FactorStore`` attached to the session serves 64 queries (16 new
   users) after every round, every microbatch through the CUDA top-k
   kernel and none through its plain version, one version per round
   (``[8.swap]``).  Each path is driven with the launch counts zeroed
   before and read after;
9. the main path at the paper's full Netflix size (``[9.netflix]``):
   ``MCProblem.synthetic(2,649,429, 17,770, 99,072,112, k=100, seed=0)``
   with 10 % held out, through ``api.solve`` (k=100, p=8, the ring,
   ``kernel="wave_pallas"``, fp32, the paper's Netflix step sizes, 3
   epochs): generation and pack seconds, host and card peak memory, the
   padded wave layout never built, the plan (H in global memory: 2,222
   item rows do not fit in shared memory), 8 launches per epoch and no
   plain call, a descending RMSE trace; the engine's pieces, each step's
   time (CUDA events) beside its byte bound and its chain bound (chain x
   ``[4.floor]``'s ns per wave), seconds per epoch and updates per
   second; the kernel against its plain version on the hottest cell's
   first waves (at most 100,000 ratings, a window of the padded layout)
   with a no-update control.  Then ``[9.sim]``: the discrete-event
   simulator (``AsyncSimConfig(p=8, emit_schedule=True)``) on a small
   problem on the host, its ``update_log`` replayed bitwise by
   ``serial.replay_np``, and its schedule through the wave kernel on the
   card (``n_steps`` launches per epoch, 0 plain), held against
   ``serial.replay_torch`` of ``schedule_order()`` on the card at
   ``rtol=2e-5, atol=2e-6``, with a shuffled order as a control.
10. the paper's baselines at full Netflix on phase 9's problem (its wave
   pack released first): DSGD through ``api.solve`` with phase 9's
   settings (``DsgdConfig(k=100, p=8)``, 3 epochs; ``[10.dsgd]``): pack
   seconds (no coloring), solve seconds, 8 launches an epoch of the
   kernel's sequential route and no plain call, factors whose digest
   must equal ``[9.solve]``'s, a descending trace; each sub-epoch's
   launch by CUDA events beside its byte and chain bounds; the kernel
   against its plain version on the first 50,000 ratings of the hottest
   sub-epoch's largest cell, with a no-update control.  Then CCD++ (1
   epoch, ``inner=3``, eq. (1) read after it), ALS (1 epoch) and
   Hogwild (1 epoch, minibatches of 256), cold from seed 0: seconds per
   epoch, card and host peaks, the RMSE trace against the initial
   factors', all-finite factors; and ``[10.als.resume]``: on phase 2's
   problem, 1 + 1 ALS epochs through ``warm_start`` equal 2, bitwise.
11. NOMAD's SPMD executor (it runs between ``[9.sim]`` and phase 10, on
   phase 9's wave pack): 8 ranks started by
   ``launch.mesh.spawn_ranks`` share the card, so their H blocks travel
   by gloo through pinned host buffers (the transport is printed).
   Phase 9's pack, cold start and held-out ratings are written once
   under ``build/`` and mapped read-only by the ranks.
   ``[11.netflix]``: ``NomadRingEngine(mesh=)`` with ``[9.solve]``'s
   settings for 3 fused epochs; the factors' digest must be
   ``[9.solve]``'s, every rank must launch the wave kernel 24 times and
   call no plain version, the RMSE trace must be ``[9.solve]``'s
   (bitwise, or within 1e-6); per step each rank's kernel ms (CUDA
   events), staging and gloo ms per hop, the step's wall; seconds per
   epoch beside ``[9.split]``'s, spawn to ready, card and host peaks.
   ``[11.api]``: ``api.solve(mesh=)`` on Netflix x 0.02 (1 epoch) for
   the ring, random and balanced schedules, each digest equal to this
   process's one-device ``solve``, the ring's loop dispatch equal to its
   fused one, and ``sub_blocks=2`` (the sequential route, sub-block by
   sub-block) equal to the one-device ``solve`` of the same config.  Any
   rank's failure or timeout fails the phase.
12. NOMAD's streaming, elastic and fault-tolerant paths on the mesh, in
   the same spawn as phase 11, after it: phase 2's ratings, phase 3's
   factors and packing (with the ratings' ids) are written once under
   ``build/`` and mapped by the ranks.  ``StreamingSession(mesh=)`` warm
   from phase 3's result replays phase 8's sequence: the two arrival
   batches, one epoch each; a leave (worker 3) and a join, each onto a
   mesh of the new worker count within the 8 ranks
   (``McMesh.ranks_after``), each followed by ``fit()``; ``kill(5)``;
   ``fit()``; the newest checkpoint bit-flipped; ``kill(0)``
   (``[12.op]``, one line an op: the digest, which must equal phase 8's
   for the same op, or the factors before a resize; the wave kernel's
   launches, steps x epochs on member ranks and 0 on idle ones; 0 plain
   calls; the idle ranks; the slowest rank's seconds of each part: the
   lead rank's re-pack that the others map, migrate with its gather, the
   epoch, checkpoint save, restore and replay).  ``[12.faults]``:
   ``solve(faults=, mesh=)`` cut after 2 epochs and resumed equals phase
   3's run.  ``[12.chaos]``: ``ChaosHarness(mesh_factory=make_mc_mesh)``
   with a leave, a join, a kill and a NaN on a small problem equals the
   same harness on one device in this process.  ``[12.ranks]``: each
   rank's card and host peaks.  Phase 19's ranks' runs follow in the
   same spawn.
13. LM training (it runs after phase 7's flash checks, phase 7's model
   freed): Qwen2.5-32B at full width, 2 of its 64 layers, bf16 with an
   fp32 AdamW state and master copy, ``remat``, through
   ``repro_torch.launch.train`` (``init_state``, ``make_train_step``
   with ``impl="pallas"`` and the trainer's schedule, 100 warm-up steps of
   10,000) on ``TokenPipeline(seed=0)`` batches of 2 x 1,024 tokens, 5
   steps (``[13.run]``: seconds a step, tokens/s, the
   loss of each step, the flash kernel's launches, 2 a layer a step (the
   forward and its recomputation), and 0 plain calls, card and host
   memory); ``[13.split]``: forward, backward and optimizer of one step
   by CUDA events; ``[13.kernel.L]``: the kernel's log-normaliser ``L``
   and output in fp32 and bf16 at the train shape against its plain
   version, with a control; ``[13.flash]``: the training flash, the
   kernel's forward with ``L``, the torch-ops backward and SDPA's
   forward and forward + backward, beside the bound; ``[13.grad]``: one
   step's loss and every parameter's gradient with the kernel's forward
   against the plain forward (``impl="xla"``), the same backward, within
   the bound PERF.md states, with a control (one layer's ``dq`` zeroed);
   ``[13.accum]``: ``grad_accum=2`` (fp32 accumulation) against 1, with a
   control (the second microbatch dropped); ``[13.learn]``: one batch
   repeated for 2 steps at a small learning rate lowers the loss at every
   step.  ``[13.init]``'s state is the card memory its construction
   adds.
14. the MoE, SSM and hybrid LMs (after phase 13), each model at full
   width, bf16, seeded, freed before the next, its memory the difference
   ``memory_allocated()`` makes around its construction; the flash
   kernel's launches counted on each served or trained path, 0 plain
   calls.  ``[14.moe]``: Qwen3-30B-A3B at full depth (48 layers, 128
   experts, top-8) through ``launch.serve.generate``, 4 prompts of 1,024
   tokens and 4 greedy decode steps, twice (warm-up, measured): prefill
   and decode times beside their bounds (the function's work on the
   warm-up's routes: kept routes, the experts a decode step reaches),
   peak memory, the prefill's summed MoE ``aux_loss`` and ``dropped``;
   ``[14.moe.check]``: 2 of its
   layers, the kernel's prefill against the plain one (``impl="xla"``):
   the share of (token, choice) routes whose expert or kept slot differ,
   and the logits of the tokens whose routes agree, with a control (the
   first attention layer unmasked); ``[14.moe.train]``: 2 of its layers
   through ``launch.train`` (the flash kernel's forward with ``L`` at
   this train shape against its plain version, with a control, as
   ``[13.kernel.L]``; 3 steps with the trainer's schedule, one
   split into forward, backward and optimizer, then a repeated batch
   whose loss must fall); ``[14.kimi]``: Kimi-K2's dense prologue and one
   384-expert layer with its shared expert, 2 prompts of 1,024 tokens, 4
   decode steps; ``[14.ssm]``: Falcon-Mamba-7B at full width, 32 of its
   64 layers (64 before phase 18 came), 4 prompts of 1,024 tokens, 4
   decode steps, once, with no warm-up run (no TPU kernel:
   attention-free), and ``[14.ssm.check]``: prefill of 192 tokens and a
   decode step against the prefill of 193 (logits and each layer's
   state, printed layer by layer), with a control (the states zeroed),
   then the same check with the weights cast to fp32; ``[14.hybrid]``:
   Jamba-1.5-Large's first 4 layers (SSM and attention, dense and MoE
   FFNs), 2 prompts of 1,024 tokens, 4 decode steps, and its kernel
   prefill against the plain one as ``[14.moe.check]``; ``[14.profile]``:
   one Qwen3-MoE and one Falcon-Mamba prefill under ``torch.profiler``;
   ``[14.flash]``: the flash kernel at each shape phase 14 serves (B=4,
   Hq=32, Hkv=4 for Qwen3-MoE; B=2, 64/8 for Kimi-K2 and Jamba) against
   its plain version with two controls, its time beside its bound, the
   plain version's and SDPA's: each shape a kernel record of its own,
   whose launches are its models' measured prefills.
15. sharded LM serving (after phase 14): Qwen2.5-32B at full width, 2 of
   its 64 layers (4 before phase 18 came), bf16, seeded, served unsharded in this process
   (``launch.serve.generate``, 4 prompts of 1,024 tokens, 1 greedy
   decode step, every step's logits kept), then by 4 ranks on a (2, 2)
   (data, model) mesh started by ``launch.mesh.spawn_ranks`` (they share
   the card: staged gloo), each drawing the same model and keeping its
   blocks (``convert.shard_lm_params``), through ``generate(ctx=)``
   under ``tp_collectives="manual"`` and ``"gspmd"`` (``[15.tp]``: each
   rank's prefill and decode seconds, its collectives' calls, bytes and
   host seconds of staging and wire, its card peak, its flash launches
   and plain calls); the ranks' blocks against the unsharded weights
   (``[15.weights]``), the logits of the prefill and every decode step
   and the greedy tokens against the unsharded run, "manual" against
   "gspmd" (``LM_TP_LOGIT_BOUND``), and a control it must reject
   (layer 0's wo blocks of the two model ranks swapped); then the flash
   kernel at the ranks' shape (B=2, Hq=20, Hkv=4) against its plain
   version with two controls, beside its bound and SDPA's time, a
   kernel record whose launches are the "gspmd" run's, summed over the
   ranks.
16. expert-parallel MoE and ``d_inner``-parallel Mamba on the same mesh
   (after phase 15): ``[16.ep]`` Qwen3-30B-A3B (128 experts, top-8; each
   model rank owns 64) and ``[16.ssm]`` Falcon-Mamba-7B (each model rank
   holds 4,096 of the 8,192 ``d_inner`` channels), each at full width,
   2 layers, bf16, seeded, served unsharded in this process on each data
   row's 2 prompts (an MoE layer's capacity counts its call's tokens, so
   the sharded run drops per data row), then by phase 15's 4 ranks (one
   spawn serves both phases' runs, ``[15.spawn]``, so the ranks start
   and warm up once) through ``generate(ctx=)`` (4 prompts of 1,024
   tokens) under ``"gspmd"`` (2 greedy decode steps) and, for Qwen3-MoE,
   ``"manual"`` (2): the ranks' blocks (``[16.*.weights]``), the logits
   and tokens (``tp_agree``, a row whose token's routes moved set aside
   at that step, at least ``ROWS_COMPARED_SHARE`` of the pairs
   compared), the share of routes that differ in the prefill
   (``ROUTE_SHARE_BOUND``) and over the decode steps
   (``DECODE_ROUTE_SHARE_BOUND``), each SSM layer's final state
   (``SSM_TP_STATE_BOUND``), "manual" against "gspmd", the two model
   ranks of a data row routing alike (equal digests), and a control for
   each (the first MoE layer's experts, or layer 0's ``out_proj``, of the
   two model ranks swapped; every decode route of the "gspmd" run moved
   to the next expert); each rank's prefill and decode seconds,
   collectives, card peak, ``aux_loss`` and ``dropped``; then the flash
   kernel at the ``[16.ep]`` ranks' shape (B=2, Hq=16, Hkv=2) against its
   plain version with two controls, a kernel record whose launches are
   the "gspmd" run's, summed over the ranks.
17. dense LM training on the same mesh (``[17.train]``, in phase 15's
   spawn, after phase 16): Qwen2.5-32B at full width, 2 of its 64
   layers, bf16, ``remat``, seeded, trained unsharded in this process
   first (``[17.unsharded]``: ``launch.train.init_state`` and 2 steps of
   ``make_train_step`` on a global batch of 4 x 1,024 tokens at lr 3e-6
   without warm-up, its state then freed), then by the 4 ranks through
   ``init_state(ctx=)`` and ``make_train_step(cfg, ctx, ...)`` under
   ``"gspmd"`` on the same batches (in both runs the first step is the
   two calls that step makes, ``testing.split_train_step``, to read its
   gradients): each step's loss, the first step's gradients of one
   tensor of each spec kind (the embedding's and the head's rows),
   ``grad_norm`` (equal on every rank) and the square of each spec
   kind's part as the ranks' ``sharding.global_norm`` gives it, the
   masters after the last step
   (``testing.assert_rare_flips`` on moves more than lr apart), each
   rank's state blocks against ``launch.specs.train_state_struct``, 2
   flash launches a layer a step on every rank (the forward and its
   recomputation) and 0 plain calls, and two controls that must fail
   (data row 0's half-batch gradient; those parts with the tp-replicated
   tensors counted once a model rank); each rank's step seconds (the
   first split into its gradients and its update), collectives'
   calls, bytes and wire seconds, card peak; then the flash kernel with
   ``L`` at the ranks' training shape (B=2, Hq=20, Hkv=4) against its
   plain version with a control, beside its bound, the torch-ops
   backward's and SDPA's times, a kernel record whose launches are the
   ranks'.
18. MoE and SSM training on the same mesh (in phase 15's spawn, after
   phase 17): ``[18.moe.train]`` Qwen3-30B-A3B (128 experts, top-8; 64
   a model rank) and ``[18.ssm.train]`` Falcon-Mamba-7B (``d_inner``
   8,192; 4,096 a model rank), each at full width, 2 layers, bf16,
   ``remat``, ``"gspmd"``, seeded, first run unsharded in this process on
   each data row's rows of a global batch of 4 x 1,024 tokens and
   combined as the sharded loss combines them
   (``testing.row_oracle``; ``[18.*.unsharded]``, the state freed), then
   one step by the 4 ranks through ``init_state(ctx=)`` and the two calls
   ``make_train_step(cfg, ctx, ...)`` makes (``testing.split_train_step``),
   after gradient passes on the same state: Qwen3-MoE's routers'
   gradients of the aux term alone (every label ignored, aux_weight 1);
   two controls, each a backward of the step's loss in which one kind of
   ``tp.copy_to_tp`` passes on the rank's own gradient instead of the
   model group's sum (``testing.unsum_over_tp``): Qwen3-MoE's routers'
   with the combine weights' (``testing.combine_weights``), Falcon's
   ``x_proj``'s with the one after the sum of its partials
   (``testing.x_proj_partials``).
   Checks: the loss; the gradients of one tensor of each spec kind (the
   router, the experts, ``x_proj``, ``dt_proj``, ``A_log`` among them),
   each as one tensor, an MoE layer's within a bound that holds moved
   routes; ``grad_norm`` (equal on every rank) and each spec kind's part
   by ``sharding.global_norm``; the state blocks; 2 flash launches a
   layer on every rank for Qwen3-MoE, 0 for Falcon, 0 plain calls; the
   aux term's router gradients; and the controls (the norm counting the
   tp-replicated tensors once a model rank; the routers' gradients with
   the combine weights' sum over tp dropped, against the MoE layers'
   bound; each model rank's unsummed ``x_proj`` gradient).  Prints each
   rank's step seconds (its gradients and its update), the gradient
   passes', wire seconds, bytes and card peak (the step's, and each
   pass's apart); then
   the flash kernel with ``L`` at the Qwen3-MoE ranks' training shape
   (B=2, Hq=16, Hkv=2) against its plain version with a control, beside
   its bound, the torch-ops backward's and SDPA's times, a kernel record
   whose launches are the ranks' (``[18.flash]``).
19. KV heads shared across model ranks, tp above ``n_kv_heads`` (its
   unsharded runs after ``[9.sim]``, its ranks' runs in phase 11's spawn
   after phase 12's, its checks after phase 12's report, before phase
   10): Qwen3-30B-A3B (32 query, 4 KV heads) at full width, 2 layers,
   bf16, seeded, on a (1, 8) mesh of phase 11's 8 ranks (its layout on
   one 8-GPU node: tp 8, each KV head shared by 2 model ranks, which
   gather its column slices over the model axis); ``[19.kvrep]`` serves
   4 prompts of 1,024 tokens and 2 greedy decode steps under "manual"
   and "gspmd" against the unsharded run in this process (the ranks'
   blocks by fingerprint; logits, tokens and routes with ``[16.ep]``'s
   bounds; "manual" against "gspmd"; the model ranks routing alike;
   each rank's prefill and decode seconds, collectives and card peak);
   ``[19.kvrep.control]``, one prefill with layer 0's wk and wv blocks of
   KV group 0's two model ranks swapped, must be rejected;
   ``[19.kvrep.train]``, one "gspmd" step on a global batch of 2 x 1,024
   tokens without remat, against the unsharded step (loss, ``grad_norm``,
   the gradients of ``[18.moe.train]``'s tensors and of each layer's wk
   and wv with ``[18.moe.train]``'s bounds, the state blocks, one flash
   launch a layer on every rank and 0 plain calls); then ``[19.flash]``,
   the flash kernel at the ranks' shape (B=4, Hq=4, Hkv=1) against its
   plain version with two controls (no causal mask; the KV head's
   column halves swapped), beside its bound and SDPA's time, a kernel
   record whose launches are the "gspmd" prefill's, summed over the
   ranks, with each rank's launches, plain calls and card peak.
20. the LM dry-run (``repro_torch.launch.dryrun``; its traces run on
   the host in DRY_WORKERS niced processes from after phase 1 until
   phase 13, which waits for them (``[20.wait]``), its checks at the
   end): (a) every rank of ``[17.train]`` (each step on
   its batch's tokens) and of ``[15.tp]`` (the prefill and the decode
   step under "manual" and "gspmd") traced on the meta device over a
   ``DryMesh``, held to the ranks' own records of that step
   (``testing.StepLog`` and the train case's per-step records): the
   collectives' calls, bytes in and bytes out equal, the argument bytes
   (params, and AdamW's state) equal to the rank's state, the dry-run's
   temporaries within DRY_TEMP_FACTOR of the rank's card peak over the
   step less what it held before, and a control that must be rejected
   (rank 0's first step with one collective dropped from the ledger);
   (b) one rank of each of the 32 (arch x shape) cells of the port's
   (32, 8) H100 mesh: its argument and temporary GB, whether they fit the
   card's memory, its TFLOPs (matrix products) and its wire GB; and
   Qwen2.5-32B's cells refused on the JAX package's (16, 16) (ROADMAP
   item 29).

The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
EPOCHS = 3
KERNEL_SRC = "src/repro_torch/kernels/csrc/nomad_sgd.cu"
TOPK_SRC = "src/repro_torch/kernels/csrc/topk.cu"
#: the pallas_call of the JAX package's serving top-k kernel
TOPK_REPLACES = "src/repro/serve/topk.py:312"
#: the Yahoo! Music catalog (configs/nomad_mf.py): items, users, rank
YAHOO_N, YAHOO_M, YAHOO_K = 624_961, 1_999_990, 100
#: [5.serve]: queries in each of its two runs (cut from 2,000, ~1.7 s of
#: repeated queries a run, to pay for phase 17)
SERVE_QUERIES = 500
#: the Pallas kernel (pallas_call line) each route's launches replace:
#: all three routes launch the one CUDA kernel through
#: ``nomad_sgd_waves_csr``
REPLACES = {
    "grid": "src/repro/kernels/nomad_sgd.py:381",        # waves_grid
    "per_cell": "src/repro/kernels/nomad_sgd.py:259",    # waves_block
    "sequential": "src/repro/kernels/nomad_sgd.py:146",  # nomad_sgd_block
}
#: the padded wrappers with the JAX package's signatures
PADDED = ("nomad_sgd_waves_grid", "nomad_sgd_waves_block", "nomad_sgd_block")
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attn.cu"
#: the pallas_call of the JAX package's flash-attention kernel
FLASH_REPLACES = "src/repro/kernels/flash_attn.py:99"
#: the LM serving cell: Qwen2.5-32B, B prompts of P tokens, G decode steps
#: in each of its two runs (cut from 32, ~94 ms a step, to pay for phase
#: 17)
LM_B, LM_P, LM_G = 4, 1024, 4
#: max |logit difference| between two runs on the same bf16 weights
#: (see lm_phase's checks): 128 residual additions (rms ~10) each rounded
#: to bf16 walk to ~2 % of the final norm's input, ~0.02 rms in logits of
#: rms ~1 and ~5x that at the max of 608k of them; the bound is 2.5x that.
#: A control (one layer's attention unmasked) must exceed it.
LM_LOGIT_BOUND = 0.25
#: [13.*]: the training cell: Qwen2.5-32B at full width, TRAIN_LAYERS of
#: its 64 layers (AdamW's fp32 m, v and master copy of 32.76 B parameters
#: are ~393 GB, beyond one card; 2 layers hold ~2.53 B parameters, a
#: ~40 GB state), TRAIN_B sequences of TRAIN_S tokens, TRAIN_STEPS steps
#: ([13.run]'s and [13.learn]'s: cut from 5, ~0.25 s a step, to pay for
#: phase 17)
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2, 1024, 2
#: [13.grad]: the kernel's forward against the plain forward, the same
#: backward: per parameter tensor ||g_kernel - g_plain|| / ||g_plain||,
#: and the loss's relative difference (PERF.md states why)
TRAIN_GRAD_BOUND, TRAIN_LOSS_BOUND = 2.0 ** -4, 2.0 ** -7
#: [13.accum]: grad_accum=2 (fp32 sums) against 1 (bf16 gradients), the
#: same norms (PERF.md states why)
TRAIN_ACCUM_BOUND, TRAIN_ACCUM_LOSS_BOUND = 2.0 ** -6, 2.0 ** -8
#: [13.learn]'s learning rate, without warm-up: Adam's first step moves
#: every weight by lr, in the sign of its gradient, so a down projection's
#: 27,648 inputs move its output by ~lr * 27,648; at the default 3e-4 that
#: is ~7 and the loss jumps (measured: 12.45 -> 19.82); 3e-6 is what the
#: trainer's schedule gives step 1 of its 100 warm-up steps
LEARN_LR = 3e-6
#: [13.kernel.L]: |L_kernel - L_plain| <= LSE_REL (1 + |L_plain|)
LSE_REL = 2e-5
#: H100 SXM peaks: HBM bytes/s, fp32 FLOP/s outside the tensor cores,
#: dense bf16/fp16 tensor-core FLOP/s (fp32 accumulate); main() reads
#: them from repro_torch.launch.mesh, the port's one source of them
PEAK_BW = PEAK_FP32 = PEAK_TC16 = None
EPS_FP32 = 2.0 ** -24


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|), the tolerance tier's measure."""
    a64, b64 = a.double(), b.double()
    return float(((a64 - b64).abs() / (1 + b64.abs())).max())


def check_close(what, got, want, n_updates, start=None) -> float:
    """Hold ``got`` against its plain version ``want``; return the max
    abs error.  The tolerance tier: ``16 eps sqrt(n_updates)`` of
    ``|a - b| / (1 + |b|)`` (the k-dot is summed in another order, and
    the difference walks with the updates).  Below fp32 storage, where
    both compute in fp32 over the same storage, also: they differ on
    few of the elements the update changed from ``start``
    (``repro_torch.testing.assert_rare_flips``)."""
    from repro_torch.testing import assert_rare_flips
    eps = EPS_FP32 if got.dtype == torch.float32 else 2.0 ** -9
    bound = 16 * eps * max(float(n_updates), 1.0) ** 0.5
    err = rel_err(got, want)
    flips = {}
    if got.dtype != torch.float32:
        differing, changed = assert_rare_flips(got, want, start, what)
        flips = dict(differing=differing, of_updated=changed)
    phase("check", what=what, max_rel_err=f"{err:.3e}",
          bound=f"{bound:.3e}", n_updates=n_updates, **flips)
    if not err <= bound:
        raise AssertionError(f"{what}: {err:.3e} > bound {bound:.3e}")
    return float((got.double() - want.double()).abs().max())


def check_control(what, got, want, start) -> None:
    """A wrong result the low-precision check must reject: fail unless
    ``assert_rare_flips`` rejects it."""
    from repro_torch.testing import FLIP_SHARE, FLIP_SLACK, flips
    differing, changed = flips(got, want, start)
    rejected = differing > FLIP_SLACK + FLIP_SHARE * changed
    phase("control", what=what, differing=differing, of_updated=changed,
          rejected=rejected)
    if not rejected:
        raise AssertionError(f"{what}: the bf16 check cannot tell it from "
                             "the plain version")


def check_bitwise(what, a, b) -> None:
    if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)):
        raise AssertionError(f"{what}: not bitwise-identical")
    phase("check", what=what, bitwise=True)


def cell_ratings(csr):
    """(cell, rows, cols) of the ratings of ``csr``'s cells."""
    bounds = csr.woff.long()[csr.cell_woff.long()]
    lo, hi = int(bounds[0]), int(bounds[-1])
    cell = torch.repeat_interleave(
        torch.arange(csr.n_cells, device=bounds.device), torch.diff(bounds))
    return cell, csr.rows[lo:hi].long(), csr.cols[lo:hi].long()


def max_row_updates(csr, n_w: int, n_h: int) -> int:
    """Most updates any one factor row receives from ``csr``'s ratings
    (cells of ``n_w`` W rows and ``n_h`` H rows)."""
    cell, rows, cols = cell_ratings(csr)
    if not rows.numel():
        return 0
    return max(int(torch.bincount(cell * n_w + rows).max()),
               int(torch.bincount(cell * n_h + cols).max()))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """``(fn(), milliseconds)`` by the host clock, synchronised on both
    ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(Ws, Hs, csr):
    """Least time of one launch, ``(ms, "bytes" | "operations")``: each
    factor row the ratings touch read once and written once, each rating
    (row, col, value) and wave offset read once, over HBM bandwidth — or
    the update arithmetic (14k + 8 FLOPs per rating) over the fp32 peak,
    whichever is larger."""
    k, elem = Ws.shape[-1], Ws.element_size()
    cell, rows, cols = cell_ratings(csr)
    touched = (torch.unique(cell * Ws.shape[1] + rows).numel()
               + torch.unique(cell * Hs.shape[1] + cols).numel())
    n_waves = int(csr.cell_woff[-1] - csr.cell_woff[0])
    nbytes = (2 * touched * k * elem + 12 * rows.numel()
              + 4 * (n_waves + 1 + csr.cell_woff.numel()))
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = (14 * k + 8) * rows.numel() / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def factor_digest(W, H) -> str:
    """sha256 of the factors' bytes, W then H
    (``repro_torch.testing.factor_digest``, which the ranks of phase 11
    use too): equal digests from two trees in one call show their results
    bitwise equal."""
    from repro_torch.testing import factor_digest as digest
    return digest(W, H)


#: the segments of ``nomad_sgd.wave_split``: warp 0's index fetch, row
#: fetch, butterfly, update and wait to the barrier's end; the stager
#: warp's staging, copy wait and wait to the barrier's end
SPLIT_NAMES = ("index", "rows", "butterfly", "update", "barrier", "stage",
               "wait", "stager_barrier")


def wave_split(ks, W, H, csr, lr, lam, plan, what: str,
               tag: str = "4.wave.split") -> dict:
    """[4.wave.split]: one cell's waves under ``plan``, split by
    ``clock64()`` samples of lane 0 of warp 0 and of the stager warp
    (``nomad_sgd.wave_split``): cycles and ns per wave of each segment,
    ns per cycle from the launch's CUDA-event time over its sampled
    cycles.  Fails unless the result is bitwise the kernel's under the
    launch's own plan."""
    want = ks.nomad_sgd_waves_csr(W.clone(), H.clone(), csr, lr, lam)
    got = (W.clone(), H.clone())
    sp = ks.wave_split(*got, csr, lr, lam, plan)
    check_bitwise(f"{plan.describe()} == launch plan W", got[0], want[0])
    check_bitwise(f"{plan.describe()} == launch plan H", got[1], want[1])
    ns_per_cycle = sp["ms"] * 1e6 / max(sp["cycles"], 1)
    us_per_wave = sp["ms"] * 1e3 / max(sp["waves"], 1)
    phase(tag, what=what, variant=plan.describe(),
          waves=sp["waves"], trips=sp["trips"], ms=f"{sp['ms']:.3f}",
          us_per_wave=f"{us_per_wave:.4f}",
          ns_per_cycle=f"{ns_per_cycle:.4f}",
          cycles_per_wave=json.dumps({name: round(sp[name + "_cycles"], 1)
                                      for name in SPLIT_NAMES}),
          ns_per_wave=json.dumps({name: round(sp[name + "_cycles"]
                                              * ns_per_cycle, 1)
                                  for name in SPLIT_NAMES}))
    sp["ns_per_cycle"] = ns_per_cycle
    return sp


def dependency_path(br, csr) -> tuple:
    """``(sum of step maxima, longest dependency path)`` of one epoch, in
    waves: the step loop costs each step its longest cell; a kernel that
    started each cell once its W shard's and its H block's previous cells
    were done would cost the longest path through those dependencies."""
    p, n_steps = br.p, br.n_steps
    chains = torch.diff(csr.cell_woff.long()).view(n_steps, p).tolist()
    done_w, done_h = [0] * p, [0] * p
    for s in range(n_steps):
        for q in range(p):
            b = br.block_at(q, s)
            done_w[q] = done_h[b] = max(done_w[q], done_h[b]) + chains[s][q]
    return sum(max(c) for c in chains), max(done_w)


def chain(csr) -> int:
    """Dependent waves of a launch: the most waves any of its cells has."""
    return int(torch.diff(csr.cell_woff.long()).max())


def interleave(csr, m_tile: int, n_tile: int):
    """``csr``'s cells as one cell over the flat ``(n_cells * m_tile, k)``
    / ``(n_cells * n_tile, k)`` factors, wave ``j`` holding the ``j``-th
    wave of every cell.  The cells touch disjoint factor blocks, so this
    is the same update, with one plain-PyTorch wave step per ``j``
    instead of one per cell and ``j``."""
    from repro_torch.kernels.nomad_sgd import WaveCSR
    cw = csr.cell_woff.long()
    w0, w1 = int(cw[0]), int(cw[-1])
    n_cells, dev = csr.n_cells, cw.device
    woff = csr.woff.long()[w0:w1 + 1]
    w_cell = torch.repeat_interleave(torch.arange(n_cells, device=dev),
                                     torch.diff(cw))
    w_idx = torch.arange(w0, w1, device=dev) - cw[:-1][w_cell]
    order = torch.argsort(w_idx * n_cells + w_cell)
    size = torch.diff(woff)[order]
    take = (torch.repeat_interleave(woff[:-1][order] - (torch.cumsum(
        size, 0) - size), size) + torch.arange(int(size.sum()), device=dev))
    cell = torch.repeat_interleave(w_cell[order], size)
    merged = torch.zeros(int(w_idx.max()) + 2, dtype=torch.int64,
                         device=dev)
    torch.cumsum(torch.bincount(w_idx, weights=torch.diff(woff).double())
                 .long(), 0, out=merged[1:])
    return WaveCSR(
        rows=(csr.rows[take] + cell * m_tile).int(),
        cols=(csr.cols[take] + cell * n_tile).int(),
        vals=csr.vals[take], woff=merged.int(),
        cell_woff=torch.tensor([0, merged.numel() - 1], dtype=torch.int32,
                               device=dev))


def topk_tolerance(ps, k: int):
    """Per-score bound of the top-k kernel against its plain version:
    the fp32 k-dot summed in another order (``16 eps sqrt(k)`` of ``1 +
    |s|``), plus one ulp of the score dtype where the sum is rounded to
    it afterwards."""
    ulp = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -10}[ps.dtype]
    a = ps.double().abs()
    return 16 * EPS_FP32 * k ** 0.5 * (1 + a) + ulp * a


def check_topk(what, s, i, ps, pi, k: int) -> float:
    """Hold the kernel's ``(s, i)`` against the plain version's ``(ps,
    pi)``, which may hold one column more (the next item, for the gap
    below the last): scores within :func:`topk_tolerance`, ids equal
    wherever neighbouring plain scores are further apart than twice it.
    Returns the max abs score error."""
    k_top = s.shape[1]
    tol = topk_tolerance(ps, k)
    psd = ps.double()
    finite = torch.isfinite(psd[:, :k_top])
    d = (s.double() - psd[:, :k_top]).abs()
    close = (torch.equal(torch.isfinite(s.double()), finite)
             and bool((d[finite] <= tol[:, :k_top][finite]).all()))
    gap = psd[:, :-1] - psd[:, 1:]
    apart = torch.ones(psd.shape, dtype=torch.bool, device=psd.device)
    apart[:, 1:] &= gap > 2 * tol[:, 1:]
    apart[:, :-1] &= gap > 2 * tol[:, :-1]
    apart = apart[:, :k_top]
    same = bool((i[apart] == pi[:, :k_top][apart]).all())
    err = float(d[finite].max()) if bool(finite.any()) else 0.0
    phase("check", what=what, max_abs_err=f"{err:.3e}",
          ids_checked=f"{float(apart.float().mean()):.3f}", ids_equal=same,
          ids_differing=int((i != pi[:, :k_top]).sum()),
          scores_close=close)
    if not (close and same):
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return err


def topk_bound(W_u, H, h_scale, k_top: int):
    """Least time of one top-k call, ``(ms, "bytes" | "operations")``:
    ``H``, ``W_u`` and the scales read once and the ``(U, k_top)`` result
    written once, over HBM bandwidth, or the ``2 U n k`` flops of the
    scores over the peak for their operands, whichever is larger.  bf16
    and fp16 products are exact in fp32, so their peak is the tensor
    cores' with fp32 accumulation; fp32 ``W_u`` (against an fp32 or an
    int8 ``H``) takes the fp32 peak outside the tensor cores."""
    U, k = W_u.shape
    n = H.shape[0]
    nbytes = (H.numel() * H.element_size() + W_u.numel() * W_u.element_size()
              + (0 if h_scale is None else 4 * n)
              + U * k_top * (W_u.element_size() + 4))
    t_bytes = nbytes / PEAK_BW * 1e3
    peak = PEAK_FP32 if W_u.dtype == torch.float32 else PEAK_TC16
    t_ops = 2 * U * n * k / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(W_u, H, h_scale, k_top: int):
    """``torch.topk(W_u @ H.T, k_top)`` (an int8 ``H`` widened to fp32
    beforehand, its scale applied to the product): the yardstick, never
    called by the port."""
    if h_scale is None:
        return lambda: torch.topk(W_u @ H.T, k_top)
    Hf = H.float()
    return lambda: torch.topk((W_u @ Hf.T) * h_scale, k_top)


def serve_phase(result, problem, dev):
    """[5.serve]: the slice end to end on the main path's result.
    Returns the kernel record at the serving shape and the top-k launches
    the serving runs made."""
    import shutil
    from collections import Counter

    from repro_torch.checkpoint import save_fit_result
    from repro_torch.kernels import topk as ktopk
    from repro_torch.launch.serve_mc import run_load
    from repro_torch.serve import RecServer, ServeConfig

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save_fit_result(str(ckpt), int(result.epochs_done), result)
    save_s = time.perf_counter() - t0
    cfg = ServeConfig(top_k=10, max_batch=64)
    t0 = time.perf_counter()
    server = RecServer.from_checkpoint(str(ckpt), cfg, device=dev)
    boot_s = time.perf_counter() - t0
    store = server.store
    view = store.view()
    for x in ("W", "H"):
        check_bitwise(f"restored {x} == trained {x}",
                      getattr(view, x).cpu(),
                      torch.from_numpy(getattr(result, x)))
    phase("5.boot", step=store.boot_step, save_s=f"{save_s:.2f}",
          boot_s=f"{boot_s:.2f}", m=view.m, n=view.n, k=view.k,
          device=view.W.device)

    # instruments for the serving runs: calls of the plain version, and
    # the (users, k_top) shape of every launch, recorded where the
    # wrapper hands its inputs to the kernel; the launch counter stays
    # the wrapper's own
    plain, launch = ktopk.topk_plain, ktopk._launch
    plain_calls, shapes = [0], Counter()

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    def recorded_launch(W_u, H, h_scale, k_top):
        shapes[W_u.shape[0], k_top] += 1
        return launch(W_u, H, h_scale, k_top)

    ktopk.topk_plain, ktopk._launch = counted_plain, recorded_launch
    total_launches = 0
    rng = np.random.default_rng(5)
    try:
        for filt in (False, True):
            if filt:
                t0 = time.perf_counter()
                view = store.publish(view.W, view.H,
                                     rated=(problem.rows, problem.cols))
                phase("5.rated", version=view.version,
                      publish_s=f"{time.perf_counter() - t0:.2f}",
                      rated=len(view.rated_items))
            srv = RecServer(store, dataclasses.replace(cfg,
                                                       filter_rated=filt))
            ktopk.reset_launches()
            plain_calls[0] = 0
            with srv:
                srv.recommend([0])
                qps, p50, p99 = run_load(srv, view.m, SERVE_QUERIES,
                                         clients=4)
                sample = rng.choice(view.m, 16, replace=False)
                recs = [srv.recommend([u]) for u in sample]
            launches = ktopk.topk_scores_cuda.launches
            batches = srv.n_batches
            total_launches += launches
            for u, rec in zip(sample, recs):
                again = srv.score([u])
                if not (rec.items.shape == (1, 10)
                        and np.all((rec.items >= 0) & (rec.items < view.n))
                        and np.all(np.isfinite(rec.scores))
                        and np.all(np.diff(rec.scores[0]) <= 0)
                        and np.array_equal(rec.items, again.items)
                        and np.array_equal(rec.scores, again.scores)):
                    raise AssertionError(f"user {u}: bad recommendation "
                                         f"{rec}")
                if filt and set(rec.items[0].tolist()) & set(
                        view.rated_for([u])[0].tolist()):
                    raise AssertionError(f"user {u}: a rated item served")
            phase("5.serve", filter_rated=filt, queries=SERVE_QUERIES,
                  answered=srv.n_queries, qps=f"{qps:.1f}",
                  p50_ms=f"{p50:.3f}", p99_ms=f"{p99:.3f}",
                  microbatches=batches, topk_launches=launches,
                  plain_calls=plain_calls[0])
            if launches < batches or plain_calls[0] != 0:
                raise AssertionError(
                    f"serving: {launches} kernel launches for {batches} "
                    f"microbatches, {plain_calls[0]} plain calls")
    finally:
        ktopk.topk_plain, ktopk._launch = plain, launch
    buckets = Counter()
    for (U, _), c in shapes.items():
        buckets[U] += c
    phase("5.buckets", users_per_launch=json.dumps(dict(sorted(
        buckets.items()))), k_tops=len({kt for _, kt in shapes}))

    # one microbatch of 4 users scored synchronously, host clock: the
    # scoring part of a served request's latency
    srv = RecServer(store, cfg)
    four = rng.choice(view.m, 4, replace=False)
    srv.score(four)
    t0 = time.perf_counter()
    for _ in range(50):
        srv.score(four)
    phase("5.score", users=4, sync_ms=f"{(time.perf_counter() - t0) * 20:.3f}")

    # the kernel against its plain version at the shapes the serving runs
    # launched: each user bucket at top-10 and at the smallest and the
    # largest filtered over-fetch it saw; and a full microbatch (U=64)
    # at top-10, the over-fetch of its users and the whole catalog
    H = view.H
    cases = []
    for U in sorted(buckets):
        over = sorted(kt for u, kt in shapes if u == U and kt != 10)
        cases += [(U, kt) for kt in sorted({10, *over[:1], *over[-1:]})]
    rows = torch.from_numpy(rng.choice(view.m, 64, replace=False)).to(dev)
    over = 10 + max(len(r) for r in view.rated_for(rows.cpu().numpy()))
    cases += [(64, 10), (64, min(view.n, over)), (64, view.n)]
    errs = []
    for U, k_top in cases:
        W_u = view.W.index_select(0, rows[:U])
        s, i = ktopk.topk_scores_cuda(W_u, H, k_top=k_top)
        ps, pi = plain(W_u, H, k_top=min(view.n, k_top + 1))
        errs.append(check_topk(f"topk serving U={U} k_top={k_top}", s, i,
                               ps, pi, view.k))
    serve_err = max(errs)
    W_u = view.W.index_select(0, rows)
    # three timings, for the spread between them
    times = [cuda_ms(lambda: ktopk.topk_scores_cuda(W_u, H, k_top=10), 20)
             for _ in range(3)]
    k_ms = float(np.median(times))
    _, p_ms = timed(lambda: plain(W_u, H, k_top=10))
    lib_ms = cuda_ms(library_call(W_u, H, None, 10), 20)
    b_ms, b_by = topk_bound(W_u, H, None, 10)
    phase("5.topk", U=64, n=view.n, k_top=10, kernel_ms=f"{k_ms:.4f}",
          kernel_ms_each=json.dumps([round(t, 4) for t in times]),
          bound_ms=f"{b_ms:.5f}", bound_by=b_by, plain_ms=f"{p_ms:.3f}",
          library_ms=f"{lib_ms:.4f}", **ktopk.kernel_attrs(W_u, H, 10))
    return dict(name="topk_scores_cuda[serve,fp32,U=64,k_top=10]",
                route="cuda", source=TOPK_SRC, replaces=TOPK_REPLACES,
                launches=total_launches, launches_on="[5.serve]",
                max_abs_err=serve_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms), total_launches


def topk_split(storage, W_u, H, h_scale, k_top: int, reps: int = 5):
    """[6.topk.split]: where one top-k call's device time goes, by kernel
    name under the profiler over ``reps`` calls: pass 1, the merge rounds
    (launches per call, summed time) and the decode; and the scoring
    alone: pass 1 with its selection compiled out (``topk_score_only``,
    one checksum per CTA), on the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk as ktopk
    lib = _build.load("topk")
    U, k = W_u.shape
    n = H.shape[0]
    # the profiler may drop events (a whole window's, now and then): each
    # part is averaged over the launches it saw, the merge rounds counted
    # per decode seen, and a window that saw none is taken again
    for _ in range(3):
        counts = {}
        _, _, by_name = device_busy(lambda: [ktopk.topk_scores_cuda(
            W_u, H, h_scale, k_top=k_top) for _ in range(reps)], counts)
        parts = {"pass1": [0, 0.0], "merge": [0, 0.0], "decode": [0, 0.0]}
        for name, ms in by_name.items():
            part = ("merge" if "merge" in name else
                    "decode" if "decode" in name else "pass1")
            parts[part][0] += counts[name]
            parts[part][1] += ms
        calls = parts["decode"][0]
        if parts["pass1"][0] and calls:
            break
    else:
        raise AssertionError(f"top-k split: kernels seen {counts}")
    p = ktopk.device_plan(W_u, H, k_top)
    sums = torch.empty(-(-U // p.ub) * p.stripes, dtype=torch.int64,
                       device=W_u.device)

    def score_only():
        err = lib.topk_score_only(
            W_u.data_ptr(), H.data_ptr(),
            None if h_scale is None else h_scale.data_ptr(), U, n, k,
            ktopk._DTYPE_CODE[W_u.dtype], ktopk._DTYPE_CODE[H.dtype], k_top,
            *ktopk.plan_args(p), sums.data_ptr(), sums.numel(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"topk_score_only failed: code {err}")

    score_only()
    for _ in range(3):
        score_counts = {}
        _, score_busy, _ = device_busy(
            lambda: [score_only() for _ in range(reps)], score_counts)
        if score_counts:
            break
    else:
        raise AssertionError("score-only: the profiler saw no kernel")
    pass1, decode = (parts[x][1] / parts[x][0] for x in ("pass1", "decode"))
    merge = parts["merge"][1] / calls
    phase("6.topk.split", storage=storage, U=U, k_top=k_top,
          total_ms=f"{pass1 + merge + decode:.4f}",
          pass1_ms=f"{pass1:.4f}",
          merge_rounds=f"{parts['merge'][0] / calls:g}",
          merge_ms=f"{merge:.4f}",
          decode_ms=f"{decode:.4f}",
          score_only_ms=f"{score_busy / sum(score_counts.values()):.4f}")


def topk_rising(dev):
    """[6.topk.rising]: the worst case of the running threshold, a
    catalog of Yahoo! Music size whose scores rise with the item id, so
    every item passes every user's threshold: the kernel against its
    plain version, bitwise (fp32 and int8 scores are exact; bf16 rounds
    ids to equal, non-decreasing scores), and its time."""
    from repro_torch.kernels import topk as ktopk
    ids = torch.arange(YAHOO_N, device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(2)
    # score = W[:, 0] * id: W's other columns are 0, H's random integers
    H = torch.randint(-2, 3, (YAHOO_N, YAHOO_K), generator=g, device=dev,
                      dtype=torch.float32)
    H[:, 0] = ids
    W = torch.zeros((64, YAHOO_K), device=dev)
    W[:, 0] = torch.arange(64, device=dev) % 16 + 1
    # int8: one integer dot per user against a rising per-item scale
    hs = (ids + 1) / YAHOO_N
    for storage, args in (
            ("fp32", (W, H, None)),
            ("bf16", (W.bfloat16(), H.bfloat16(), None)),
            ("int8", (W, torch.ones_like(H, dtype=torch.int8), hs))):
        dense = ktopk._tile_scores(args[0], args[1], args[2])
        if not bool((dense[:, 1:] >= dense[:, :-1]).all()):
            raise AssertionError(f"rising catalog {storage}: scores fall")
        del dense
        for k_top in (10, 1000):
            s, i = ktopk.topk_scores_cuda(*args, k_top=k_top)
            ps, pi = ktopk.topk_plain(*args, k_top=k_top)
            if not (torch.equal(s, ps) and torch.equal(i, pi)):
                raise AssertionError(f"topk rising {storage} k_top={k_top}:"
                                     " kernel != plain")
            k_ms = cuda_ms(lambda: ktopk.topk_scores_cuda(*args,
                                                          k_top=k_top), 10)
            phase("6.topk.rising", storage=storage, U=64, k_top=k_top,
                  kernel_equals_plain=True, kernel_ms=f"{k_ms:.4f}")


def topk_phase(dev, launches: int):
    """[6.topk]: the kernel at the Yahoo! Music catalog.  Returns one
    kernel record per (storage, cell); the cells bypass the server, so
    each record's ``launches`` is the kernel's count on the serving path
    (``launches_on``), not this phase's."""
    from repro_torch.kernels import topk as ktopk
    from repro_torch.serve import FactorStore

    g = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn((YAHOO_M, YAHOO_K), generator=g, device=dev) * 0.3
    H = torch.randn((YAHOO_N, YAHOO_K), generator=g, device=dev) * 0.3
    views = {}
    for storage, kw in (("fp32", {}), ("bf16", dict(dtype=torch.bfloat16)),
                        ("int8", dict(quantize="int8"))):
        t0 = time.perf_counter()
        views[storage] = FactorStore(dev).publish(W, H, **kw)
        v = views[storage]
        phase("6.publish", storage=storage,
              seconds=f"{time.perf_counter() - t0:.2f}",
              W_bytes=v.W.numel() * v.W.element_size(),
              H_bytes=v.H.numel() * v.H.element_size())
    del W, H

    # integer-valued factors: kernel == plain, bitwise; and a control
    gi = torch.Generator(device=dev).manual_seed(1)
    Hi = torch.randint(-2, 3, (YAHOO_N, YAHOO_K), generator=gi, device=dev)
    Wi = torch.randint(-2, 3, (64, YAHOO_K), generator=gi, device=dev)
    hs = torch.rand(YAHOO_N, generator=gi, device=dev) + 0.01
    for storage, args in (
            ("fp32", (Wi.float(), Hi.float(), None)),
            ("bf16", (Wi.bfloat16(), Hi.bfloat16(), None)),
            ("int8", (Wi.float(), Hi.to(torch.int8), hs))):
        for k_top in (10, 1000):
            s, i = ktopk.topk_scores_cuda(*args, k_top=k_top)
            ps, pi = ktopk.topk_plain(*args, k_top=k_top)
            if not (torch.equal(s, ps) and torch.equal(i, pi)):
                raise AssertionError(f"topk integer {storage} k_top="
                                     f"{k_top}: kernel != plain")
            phase("check", what=f"topk integer-valued {storage} U=64 "
                  f"k_top={k_top} kernel == plain", bitwise=True)
    # control: the same selection with ties broken to the larger id
    s, i = ktopk.topk_scores_cuda(Wi.float(), Hi.float(), k_top=1000)
    dense = Wi.float() @ Hi.float().T
    desc = torch.arange(YAHOO_N - 1, -1, -1, device=dev)
    order = torch.sort(-dense[:, desc], dim=1, stable=True).indices[:, :1000]
    reversed_ids = desc[order].int()
    rejected = not torch.equal(reversed_ids, i)
    phase("control", what="topk ties to the larger id", rejected=rejected,
          differing=int((reversed_ids != i).sum()))
    if not rejected:
        raise AssertionError("the top-k check cannot tell the tie rule")
    del Hi, Wi, dense
    topk_rising(dev)

    records = []
    for storage, view in views.items():
        for U, k_top in ((1, 10), (8, 10), (64, 10), (64, 1000)):
            rows = torch.from_numpy(np.random.default_rng(U).choice(
                YAHOO_M, U, replace=False)).to(dev)
            W_u, H, h_scale = view.W.index_select(0, rows), view.H, None
            if view.quantized:
                W_u = W_u.float() * view.w_scale.index_select(0, rows)[:,
                                                                    None]
                h_scale = view.h_scale
            s, i = ktopk.topk_scores_cuda(W_u, H, h_scale, k_top=k_top)
            ps, pi = ktopk.topk_plain(W_u, H, h_scale, k_top=k_top + 1)
            err = check_topk(f"topk {storage} U={U} k_top={k_top}", s, i,
                             ps, pi, YAHOO_K)
            attrs = ktopk.kernel_attrs(W_u, H, k_top)
            k_ms = cuda_ms(lambda: ktopk.topk_scores_cuda(
                W_u, H, h_scale, k_top=k_top), 10)
            _, p_ms = timed(lambda: ktopk.topk_plain(W_u, H, h_scale,
                                                     k_top=k_top))
            lib_ms = cuda_ms(library_call(W_u, H, h_scale, k_top), 10)
            b_ms, b_by = topk_bound(W_u, H, h_scale, k_top)
            phase("6.topk", storage=storage, U=U, k_top=k_top,
                  kernel_ms=f"{k_ms:.4f}", bound_ms=f"{b_ms:.4f}",
                  bound_by=b_by, plain_ms=f"{p_ms:.2f}",
                  library_ms=f"{lib_ms:.4f}", **attrs)
            if U == 64:
                topk_split(storage, W_u, H, h_scale, k_top)
            records.append(dict(
                name=f"topk_scores_cuda[{storage},U={U},k_top={k_top}]",
                route="cuda", source=TOPK_SRC, replaces=TOPK_REPLACES,
                launches=launches, launches_on="[5.serve]",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms))
    return records


def flash_within(got, want, dtype, abs_v=None) -> bool:
    """The flash kernel's result ``got`` against ``want`` (its plain
    version's, or the oracle's).  fp32: both accumulate in fp32, the
    reference's own ``2e-5`` abs and rel between two orders of
    summation.  bf16 and fp16: the tensor-core kernel also rounds its
    probabilities once to the type before ``P V``, so the bound is
    ``repro_torch.testing.flash_p_rounding_tolerance``: that fp32 bound,
    two ulps of the output, and the type's epsilon times ``abs_v``, the
    plain version on ``|v|``."""
    from repro_torch.testing import flash_p_rounding_tolerance
    w = want.double()
    tol = (2e-5 * (1 + w.abs()) if dtype == torch.float32
           else flash_p_rounding_tolerance(w, abs_v, dtype))
    return bool(((got.double() - w).abs() <= tol).all())


def flash_bound(B, Hq, Hkv, S, D, dtype):
    """Least time of one causal flash call, ``(ms, "bytes" |
    "operations")``: the two products over the keys each query sees
    (``2 * 2 * B * Hq * D * S (S + 1) / 2`` flops) at the peak of the
    operand type (bf16/fp16 tensor cores, fp32 FMA units), or q, k, v
    read once and o written once over HBM bandwidth."""
    elem = torch.empty((), dtype=dtype).element_size()
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)
    nbytes = elem * B * S * D * (2 * Hq + 2 * Hkv)
    t_ops = flops / (PEAK_FP32 if dtype == torch.float32 else PEAK_TC16) * 1e3
    t_bytes = nbytes / PEAK_BW * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: [7.flash]'s cases: (dtype, S, D, timed); the served shape in each type,
#: then a ragged last tile (S=200, D padded to 64) and rows of 72 bytes
#: (D=36: the element-wise loading variant), B, Hq, Hkv as served
FLASH_CASES = ((torch.bfloat16, LM_P, 128, True),
               (torch.float16, LM_P, 128, True),
               (torch.float32, LM_P, 128, True),
               (torch.bfloat16, 200, 64, False),
               (torch.bfloat16, LM_P, 36, False))


def flash_case(dev, g, dtype, B, Hq, Hkv, S, D, tag="7.flash",
               timed_case=True):
    """One shape of the flash kernel, on q/k/v laid out as the prefill
    hands them over ((B, S, H, D) projections viewed as (B, H, S, D)):
    the kernel against its plain version, fp32 also against the
    materialized oracle, and two controls the check must reject; if
    ``timed_case``, its time beside its bound, the plain version's and
    SDPA's, and its kernel record (``launches`` 0: the caller's)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import ref
    name = {torch.bfloat16: "bf16", torch.float16: "fp16",
            torch.float32: "fp32"}[dtype]
    q, k, v = ((torch.randn((B, S, h, D), generator=g, device=dev)
                * sc).to(dtype).transpose(1, 2)
               for h, sc in ((Hq, 0.3), (Hkv, 0.3), (Hkv, 1.0)))
    got = kfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    kernel = kfa.KERNELS[kfa.kernel_index(q, k, v, got)]
    want = kfa.flash_attention_plain(q, k, v, causal=True)
    abs_v = (None if dtype == torch.float32 else kfa.flash_attention_plain(
        q.float(), k.float(), v.abs().float(), causal=True))
    err = float((got.double() - want.double()).abs().max())
    ok = flash_within(got, want, dtype, abs_v)
    phase("check", what=f"flash_attention {name} B={B} Hq={Hq} Hkv={Hkv} "
          f"S={S} D={D} kernel vs plain", kernel=kernel,
          max_abs_err=f"{err:.3e}", within=ok)
    if not ok:
        raise AssertionError(f"flash_attention {name} B={B} Hq={Hq} "
                             f"Hkv={Hkv} S={S} D={D}: kernel and plain "
                             "version disagree")
    if dtype == torch.float32:
        # a second witness: the materialized oracle (in bf16 it rounds
        # the probabilities to bf16, which the fp32 kernel does not)
        oracle = ref.flash_attention_ref(q, k, v, causal=True)
        ok = flash_within(got, oracle, dtype)
        phase("check", what=f"flash_attention {name} kernel vs "
              "materialized oracle", max_abs_err=(
                  f"{float((got.double() - oracle.double()).abs().max()):.3e}"),
              within=ok)
        del oracle
        if not ok:
            raise AssertionError("flash_attention fp32: kernel and "
                                 "materialized oracle disagree")
    # wrong results the check must reject: no causal mask, and query
    # head h reading KV head h % Hkv instead of h // (Hq / Hkv); with one
    # KV head (a head shared by model ranks) that is the right one, so
    # instead the head with its two column halves swapped, as two ranks'
    # slices assembled in the wrong order
    if Hkv > 1:
        wrong_heads = torch.arange(Hq, device=dev) % Hkv
        wrong = ("plain with KV head h % Hkv",
                 kfa.flash_attention_plain(q, k[:, wrong_heads],
                                           v[:, wrong_heads], causal=True))
    else:
        wrong = ("plain with the KV head's column halves swapped",
                 kfa.flash_attention_plain(q, k.roll(D // 2, -1),
                                           v.roll(D // 2, -1), causal=True))
    for what, bad in (
            ("plain without the causal mask",
             kfa.flash_attention_plain(q, k, v, causal=False)), wrong):
        rejected = not flash_within(got, bad, dtype, abs_v)
        phase("control", what=f"flash {name} B={B} Hq={Hq} Hkv={Hkv} S={S} "
              f"D={D} {what}", rejected=rejected)
        if not rejected:
            raise AssertionError(f"the flash check cannot tell {what}")
    del want, abs_v
    if not timed_case:
        return None
    k_ms = cuda_ms(lambda: kfa.flash_attention(q, k, v), 10)
    p_ms = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v), 3)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10)
    b_ms, b_by = flash_bound(B, Hq, Hkv, S, D, dtype)
    phase(tag, dtype=name, shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},D={D}",
          kernel=kernel, kernel_ms=f"{k_ms:.4f}", bound_ms=f"{b_ms:.4f}",
          bound_by=b_by, plain_ms=f"{p_ms:.3f}", sdpa_ms=f"{lib_ms:.4f}")
    return dict(
        name=f"flash_attention[{name},B={B},Hq={Hq},Hkv={Hkv},S={S},D={D}]",
        route="cuda", source=FLASH_SRC, replaces=FLASH_REPLACES,
        kernel=kernel, launches=0, launches_on=None, max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)


def flash_kernel_checks(dev, launches: int):
    """[7.flash]: each kernel of ``csrc/flash_attn.cu`` with its registers,
    shared memory and spills; then :func:`flash_case` at each of
    :data:`FLASH_CASES` (B, Hq, Hkv as [7.lm] serves them).  Returns the
    timed cases' kernel records (``launches`` is the main path's count,
    bf16)."""
    from repro_torch.kernels import flash_attn as kfa
    for name, attrs in kfa.kernel_attrs().items():
        phase("7.flash", kernel=name, **attrs)
        if attrs["local_bytes"]:
            raise AssertionError(f"{name} spills {attrs['local_bytes']} "
                                 "bytes per thread")
    g = torch.Generator(device=dev).manual_seed(3)
    records = []
    for dtype, S, D, timed_case in FLASH_CASES:
        rec = flash_case(dev, g, dtype, LM_B, 40, 8, S, D,
                         timed_case=timed_case)
        if rec is None:
            continue
        unserved = {torch.float16: "fp16", torch.float32: "fp32"}.get(dtype)
        rec["launches"] = 0 if unserved else launches
        rec["launches_on"] = ("[7.lm] prefill" + (
            f" (bf16 only; {unserved} is not served)" if unserved else ""))
        records.append(rec)
    return records


def logits_agree(what, got, want, bound: float, tag="check") -> bool:
    """Two runs' logits (B, V) on the same bf16 weights agree when their
    max abs difference is within ``bound`` and the greedy token is the
    same in every row whose top-2 margin (in ``want``) is more than twice
    the difference."""
    d = float((got.float() - want.float()).abs().max())
    top2 = torch.topk(want.float(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * d
    same = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    phase(tag, what=what, max_abs_diff=f"{d:.4f}", bound=bound,
          rows_with_clear_argmax=f"{int(clear.sum())}/{clear.numel()}",
          argmax_equal=same)
    return d <= bound and same


def check_logits(what, got, want, bound: float) -> None:
    if not logits_agree(what, got, want, bound):
        raise AssertionError(f"{what}: logits differ beyond {bound} or a "
                             "clear argmax differs")


def free_cuda() -> None:
    """Drop what Python still holds and return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def build_on_card(fn):
    """``(fn(), seconds, bytes)``: the card memory ``fn``'s result holds,
    the difference of ``memory_allocated()`` around it (memory that
    earlier phases still hold is not counted)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.memory_allocated() - before)


class FirstAttentionUnmasked:
    """Over a ``with`` block, the first attention call of each prefill
    runs without the causal mask (its plain version); the others through
    the kernel: the control of the prefill checks."""

    def __enter__(self):
        from repro_torch.kernels import flash_attn as kfa
        from repro_torch.models import attention as A
        self._A, self._kfa, self.calls = A, kfa, 0

        def first_unmasked(q, k, v, *, causal=True, **kw):
            self.calls += 1
            if self.calls == 1:
                return kfa.flash_attention_plain(q, k, v, causal=False)
            return kfa.flash_attention(q, k, v, causal=causal, **kw)

        A.flash_attn = types.SimpleNamespace(flash_attention=first_unmasked)
        return self

    def __exit__(self, *exc):
        self._A.flash_attn = self._kfa
        return False


def train_split(model, cfg, batch, opt_state, opt_cfg):
    """One more step in its parts by CUDA events: ``[forward, backward,
    optimizer]`` ms (the trainer's schedule at ``opt_state``'s step)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as optim
    from repro_torch.optim.schedule import cosine_warmup
    named = dict(model.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in named.values():
        p.requires_grad_(True)
    try:
        torch.cuda.synchronize()
        ev[0].record()
        loss, _ = T.loss_and_metrics(model, cfg, batch, impl="pallas")
        ev[1].record()
        grads = torch.autograd.grad(loss, list(named.values()))
        ev[2].record()
    finally:
        for p in named.values():
            p.requires_grad_(False)
    del loss
    optim.adamw_update(model, dict(zip(named, grads)), opt_state, opt_cfg,
                       lr_scale=cosine_warmup(opt_state["step"],
                                              base_lr=1.0, warmup=100,
                                              total=10_000))
    ev[3].record()
    torch.cuda.synchronize()
    del grads
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def device_busy(fn, counts=None):
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA); returns ``(wall
    ms, device busy ms, {kernel name: ms})``: busy is the union of the
    kernels' intervals on the card, so overlapping kernels count once.
    A ``counts`` dict, if given, receives each kernel's launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e3)
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3, by_name


def lm_profile(model, cfg, prompts, dev, unprofiled_ms) -> None:
    """[7.profile]: where the served path's time goes: the prefill and 4
    decode steps under the profiler, each with its device busy time, its
    largest kernels and its busy share, of the profiled wall time and of
    ``unprofiled_ms[what]`` (the same work's time in the measured run:
    the profiler adds host time to every op, so where the host sets the
    pace the second share is the one a user sees)."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    state = {}

    def prefill():
        state["logits"], state["pre"] = lserve.make_prefill(cfg)(
            model, {"inputs": prompts})

    def decode(steps=4):
        step = lserve.make_decode_step(cfg)
        tok = state["logits"].argmax(-1)
        for i in range(steps):
            logits, state["cache"] = step(model, {"inputs": tok[:, None]},
                                          state["cache"], P + i)
            tok = logits.argmax(-1)

    with torch.inference_mode():
        for what, fn, per in (("prefill", prefill, 1), ("decode", decode, 4)):
            wall, busy, by_name = device_busy(fn)
            if not busy > 0:
                raise AssertionError(f"{what}: the profiler saw no kernel "
                                     "run on the card")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            phase("7.profile", what=what, wall_ms=f"{wall / per:.2f}",
                  device_busy_ms=f"{busy / per:.2f}",
                  busy_share=f"{busy / wall:.3f}",
                  unprofiled_ms=f"{unprofiled_ms[what]:.2f}",
                  busy_share_unprofiled=(
                      f"{busy / per / unprofiled_ms[what]:.3f}"),
                  top_kernels_ms=json.dumps({n[:48]: round(t / per, 3)
                                             for n, t in top}))
            if what == "prefill":
                state["cache"] = lserve._merge_prefill_cache(
                    T.init_cache(cfg, B, P + 4, device=dev), state["pre"],
                    cfg, P)
                del state["pre"]


def family_model(tag: str, arch: str, dev, layers=None):
    """``(model, cfg)``: the config of ``arch`` (cut to ``layers``) with
    seeded weights on the card, and its ``[<tag>.init]`` line:
    parameters, weight bytes, the card memory it holds (a difference),
    seconds."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    full = configs.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    model, secs, held = build_on_card(lambda: T.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    phase(f"{tag}.init", model=cfg.name,
          layers=f"{cfg.n_layers} of {full.n_layers}", d_model=cfg.d_model,
          params=n_params, weight_bytes=sum(p.numel() * p.element_size()
                                            for p in model.parameters()),
          state_bytes=held, seconds=f"{secs:.2f}")
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config has "
                             f"{cfg.param_count()}")
    return model, cfg


def prompts_for(cfg, B: int, P: int, dev, seed: int = 0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, P))).to(dev)


def lm_bounds(model, cfg, B: int, P: int, G: int, calls):
    """``(prefill bound ms, decode bound ms a step)`` of the function on
    this run's routes (``calls``: ``testing.MoeLog().routes`` of one
    prefill of B x P tokens and G decode steps).  Prefill: 2 flops a
    token for every weight but the embedding table (a gather), the
    lm_head and the routed experts; 2 x 3 d ff for each kept route; the
    lm_head for the B last positions only (prefill returns their
    logits); the causal attention products; at the bf16 tensor-core
    peak.  Decode: a step
    reads every weight but the embedding table (B rows of it) and the
    routed experts, and of those only the experts its kept routes reach
    (at most min(E, B k) a layer), the valid part of the KV caches and
    the SSM states read and written, over HBM bandwidth."""
    from repro_torch.models.moe import MoE
    elem = model.lm_head.w.element_size()
    emb = cfg.vocab_size * cfg.d_model
    per_expert = 3 * cfg.d_model * cfg.d_expert
    routed = sum(t.numel() for m in model.modules() if isinstance(m, MoE)
                 for t in (m.gate, m.up, m.down))
    rest = [(p.numel(), p.element_size())
            for p in model.parameters()]
    dense = sum(n for n, _ in rest) - 2 * emb - routed
    dense_bytes = sum(n * e for n, e in rest) - (2 * emb + routed) * elem
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    pre = [kept for topi, kept in calls if topi.shape[0] == B * P]
    dec = [topi[kept] for topi, kept in calls if topi.shape[0] == B]
    if (len(pre), len(dec)) != (n_moe, n_moe * G):
        raise AssertionError(f"{len(pre)} prefill and {len(dec)} decode "
                             f"MoE calls, want {n_moe} and {n_moe * G}")
    kept_routes = sum(int(k.sum()) for k in pre)
    reached = sum(int(torch.unique(e).numel()) for e in dec) / G
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_ssm = cfg.n_layers - n_attn
    flops = (2 * dense * B * P + 2 * per_expert * kept_routes + 2 * emb * B
             + n_attn * 4 * B * cfg.n_heads * cfg.head_dim
             * (P * (P + 1) // 2))
    cache = (2 * n_attn * B * (P + G // 2) * cfg.n_kv_heads
             * cfg.head_dim * elem
             + n_ssm * B * cfg.d_inner * (2 * 4 * cfg.ssm_state
                                          + 2 * elem * (cfg.ssm_conv - 1)))
    dec_bytes = (dense_bytes + emb * elem + B * cfg.d_model * elem
                 + reached * per_expert * elem + cache)
    return flops / PEAK_TC16 * 1e3, dec_bytes / PEAK_BW * 1e3


def serve_family(tag: str, model, cfg, prompts, G: int, want_launches: int,
                 warm_up: bool = True):
    """``[<tag>.run]`` (a warm-up and a measured run of
    ``launch.serve.generate``: prefill, merge, G greedy decode steps,
    each with the flash kernel's launches and plain calls counted; the
    first run's MoE routes logged for the bounds; no warm-up where
    ``warm_up`` is false) and ``[<tag>]``: times beside
    their bounds (:func:`lm_bounds`), peak memory, and the summed MoE aux
    of a forward of the same prompts.  Returns the measured run's
    ``launches``, ``tokens`` and ``timings``."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T
    from repro_torch.testing import FlashCounts, MoeLog
    B, P = prompts.shape
    runs, routes = [], MoeLog()
    plan = ["warm-up"] if warm_up else []
    for i, run in enumerate(plan + ["measured"]):
        torch.cuda.reset_peak_memory_stats()
        log = routes if i == 0 else contextlib.nullcontext()
        with torch.inference_mode(), FlashCounts() as fc, log:
            toks, t = lserve.generate(model, cfg, prompts, G + 1)
        del t["cache"]
        runs.append((toks, t, fc.launches, fc.plain_calls,
                     torch.cuda.max_memory_allocated()))
        phase(f"{tag}.run", run=run, prefill_s=f"{t['prefill_s']:.4f}",
              decode_s=f"{t['decode_s']:.4f}", flash_launches=fc.launches,
              want=want_launches, plain_calls=fc.plain_calls)
    if any(r[2] != want_launches or r[3] for r in runs):
        raise AssertionError(f"{tag}: flash launches "
                             f"{[r[2] for r in runs]} (want {want_launches}),"
                             f" plain calls {[r[3] for r in runs]}")
    toks, t, launches, n_plain, peak = runs[-1]
    if not (toks.shape == (B, G + 1) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all())
            and torch.equal(toks, runs[0][0])):
        raise AssertionError(f"{tag}: tokens misshapen, out of range or "
                             "not the same in both runs")
    with torch.inference_mode():
        logits, _, aux = T.forward(model, cfg, prompts, impl="pallas")
        finite = bool(torch.isfinite(logits.float()).all())
        del logits
    pre_ms, dec_ms = lm_bounds(model, cfg, B, P, G, routes.routes)
    step_ms = t["decode_s"] / G * 1e3
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    phase(tag, batch=B, prompt=P, decode_steps=G,
          prefill_ms=f"{t['prefill_s'] * 1e3:.2f}",
          prefill_tok_s=f"{B * P / t['prefill_s']:.1f}",
          prefill_bound_ms=f"{pre_ms:.2f}",
          decode_ms_per_step=f"{step_ms:.3f}",
          decode_tok_s=f"{B * G / t['decode_s']:.1f}",
          decode_bound_ms_per_step=f"{dec_ms:.3f}", peak_mem_bytes=peak,
          flash_launches=launches, plain_calls=n_plain,
          moe_layers=n_moe, aux_loss=f"{float(aux['aux_loss']):.4f}",
          dropped=f"{float(aux['dropped']):.4f}", finite=finite,
          tokens=json.dumps(toks[:, :6].tolist()))
    if not (finite and np.isfinite(float(aux["aux_loss"]))):
        raise AssertionError(f"{tag}: non-finite logits or aux")
    return {"launches": launches, "tokens": toks, "timings": t}


def lm_phase(dev):
    """[7.lm]: Qwen2.5-32B served end to end on the card by
    :func:`serve_family` (init, prefill of B prompts, merge into the
    decode caches, greedy decode steps, all through
    ``repro_torch.launch.serve``), its profile; then checks on the same
    weights.  Returns the flash kernel's launches in the prefill."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T

    B, P = LM_B, LM_P
    model, cfg = family_model("7", "qwen2_5_32b", dev)
    prompts = prompts_for(cfg, B, P, dev)
    served = serve_family("7.lm", model, cfg, prompts, LM_G, cfg.n_layers)
    t = served["timings"]
    lm_profile(model, cfg, prompts, dev,
               {"prefill": t["prefill_s"] * 1e3,
                "decode": t["decode_s"] / LM_G * 1e3})

    # the same weights: the prefill's last logits with the kernel and
    # with the plain chunked flash; then decode after prefill against the
    # full forward (tests/test_models.py:58)
    with torch.inference_mode():
        pal, _ = lserve.make_prefill(cfg, impl="pallas")(
            model, {"inputs": prompts})
        xla, _ = lserve.make_prefill(cfg, impl="xla")(
            model, {"inputs": prompts})
        if not torch.equal(pal.argmax(-1), served["tokens"][:, 0]):
            raise AssertionError("the prefill's greedy token differs from "
                                 "the served one")
        check_logits("prefill last logits pallas vs xla", pal, xla,
                     LM_LOGIT_BOUND)
        # control: the first layer's attention without the causal mask
        # (its plain version), every other layer through the kernel
        with FirstAttentionUnmasked():
            bad, _ = lserve.make_prefill(cfg)(model, {"inputs": prompts})
        if logits_agree("prefill, layer 0 unmasked, vs xla", bad, xla,
                        LM_LOGIT_BOUND, tag="control"):
            raise AssertionError("the logits check cannot tell one layer's "
                                 "attention without the causal mask")
        del pal, xla, bad
        # the flash kernel's contract (S a multiple of its 256-row blocks)
        # holds at t = P - 256; causal, so forward(x)[t] sees x[:t + 1]
        t = P - 256
        last, pre = lserve.make_prefill(cfg)(model,
                                             {"inputs": prompts[:, :t]})
        cache = lserve._merge_prefill_cache(
            T.init_cache(cfg, B, t + 1, device=dev), pre, cfg, t)
        del pre
        dec, cache = lserve.make_decode_step(cfg)(
            model, {"inputs": prompts[:, t:t + 1]}, cache, t)
        del cache
        full, _, _ = T.forward(model, cfg, prompts, impl="pallas")
        check_logits(f"prefill(x[:{t}]) logits vs forward(x)[{t - 1}]",
                     last, full[:, t - 1], LM_LOGIT_BOUND)
        check_logits(f"decode(prefill(x[:{t}]), x[{t}]) vs forward(x)[{t}]",
                     dec, full[:, t], LM_LOGIT_BOUND)
        finite = bool(torch.isfinite(full.float()).all())
        del full
    if not finite:
        raise AssertionError("non-finite logits")
    return served["launches"]


# --------------------------------------------------------------------- #
# 13. LM training                                                       #
# --------------------------------------------------------------------- #

def lse_within(got, want) -> bool:
    """The kernel's log-normaliser ``L`` against its plain version's:
    ``LSE_REL (1 + |want|)``, the fp32 bound of two orders of summation
    (the tensor-core kernel keeps its running max in log2 units and sums
    ``exp2``: a few fp32 ulps of ``L`` more)."""
    w = want.double()
    return bool(((got.double() - w).abs() <= LSE_REL * (1 + w.abs())).all())


def grad_rel(got: dict, want: dict, scale: float = 1.0) -> dict:
    """``{name: ||scale got - want|| / ||want||}`` in fp32, per tensor."""
    out = {}
    for k, w in want.items():
        wf = w.float()
        out[k] = float(torch.linalg.vector_norm(got[k].float() * scale - wf)
                       / torch.linalg.vector_norm(wf))
    return out


def worst(rel: dict, n: int = 3) -> str:
    """The ``n`` largest entries of ``rel``, largest first."""
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:n]
    return json.dumps({k: f"{v:.3e}" for k, v in top})


def train_flash_checks(dev, cfg, tag: str, launches_on: str) -> dict:
    """[<tag>.kernel.L] and [<tag>.flash]: the flash kernel's forward
    with its log-normaliser at the train shape of ``cfg`` (B=TRAIN_B,
    its Hq, Hkv and D, S=TRAIN_S, q/k/v laid out as the layer hands them
    over), in fp32 and bf16, against its plain version, with a control;
    then in bf16 its time, the torch-ops backward's
    (``flash_xla.flash_bwd`` over key chunks of ``cfg.attn_chunk``), the
    plain forward's and SDPA's forward and forward + backward, beside
    the bounds.  Returns the kernel record (``launches`` filled in by the
    caller)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.models import flash_xla as fx
    B, Hq, Hkv, S, D = (TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_S,
                        cfg.head_dim)
    chunk = cfg.attn_chunk
    g = torch.Generator(device=dev).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        name = {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]
        q, k, v = ((torch.randn((B, S, h, D), generator=g, device=dev)
                    * sc).to(dtype).transpose(1, 2)
                   for h, sc in ((Hq, 0.3), (Hkv, 0.3), (Hkv, 1.0)))
        o, L = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        kernel = kfa.KERNELS[kfa.kernel_index(q, k, v, o)]
        want_o, want_L = kfa.flash_attention_plain(q, k, v, causal=True,
                                                   return_lse=True)
        abs_v = (None if dtype == torch.float32 else kfa.flash_attention_plain(
            q.float(), k.float(), v.abs().float(), causal=True))
        l_err = float((L.double() - want_L.double()).abs().max())
        o_err = float((o.double() - want_o.double()).abs().max())
        ok = lse_within(L, want_L) and flash_within(o, want_o, dtype, abs_v)
        phase("check", what=f"[{tag}.kernel.L] flash {name} B={B} Hq={Hq} "
              f"Hkv={Hkv} S={S} D={D} L and o, kernel vs plain",
              kernel=kernel, max_abs_err_L=f"{l_err:.3e}",
              max_abs_err_o=f"{o_err:.3e}", within=ok)
        if not ok:
            raise AssertionError(f"flash {name}: the kernel's L or o and "
                                 "its plain version's disagree")
        _, bad_L = kfa.flash_attention_plain(q, k, v, causal=False,
                                             return_lse=True)
        rejected = not lse_within(L, bad_L)
        phase("control", what=f"[{tag}.kernel.L] flash {name} L of the plain "
              "version without the causal mask", rejected=rejected)
        if not rejected:
            raise AssertionError("the L check cannot tell a missing mask")
        del want_o, want_L, abs_v, bad_L
    do = torch.randn(o.shape, generator=g, device=dev).to(o.dtype)
    k_ms = cuda_ms(lambda: kfa.flash_attention(q, k, v, return_lse=True), 10)
    p_ms = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v,
                                                     return_lse=True), 3)
    b_ms = cuda_ms(lambda: fx.flash_bwd(q, k, v, o, L, do, True, chunk), 5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, (qr, kr, vr), do)

    lib_fb_ms = cuda_ms(sdpa_fwd_bwd, 10)
    f_ms, f_by = flash_bound(B, Hq, Hkv, S, D, torch.bfloat16)
    # the backward: five products over the keys each query sees, 2.5x the
    # forward's two, at the bf16 peak; or q, k, v, o, do and L read and
    # dq, dk, dv written once
    bwd_flops = 2.5 * 4 * B * Hq * D * (S * (S + 1) // 2)
    bwd_bytes = 2 * B * S * D * (4 * Hq + 4 * Hkv) + 4 * B * Hq * S
    bb_ms = max(bwd_flops / PEAK_TC16, bwd_bytes / PEAK_BW) * 1e3
    phase(f"{tag}.flash", dtype="bf16",
          shape=f"B={B},Hq={Hq},Hkv={Hkv},S={S},D={D}", kernel=kernel,
          fwd_lse_ms=f"{k_ms:.4f}",
          fwd_bound_ms=f"{f_ms:.4f}", fwd_bound_by=f_by,
          bwd_torch_ops_ms=f"{b_ms:.4f}", bwd_bound_ms=f"{bb_ms:.4f}",
          plain_fwd_ms=f"{p_ms:.3f}", sdpa_fwd_ms=f"{lib_ms:.4f}",
          sdpa_fwd_bwd_ms=f"{lib_fb_ms:.4f}", bwd_chunk=min(chunk, S))
    return dict(
        name=f"flash_attention[bf16,train,lse,B={B},Hq={Hq},Hkv={Hkv},"
             f"S={S},D={D}]", route="cuda", source=FLASH_SRC,
        replaces=FLASH_REPLACES, kernel=kernel, launches=0,
        launches_on=launches_on,
        max_abs_err=o_err, max_abs_err_lse=l_err, ms=k_ms, plain_ms=p_ms,
        bound_ms=f_ms, bound_by=f_by, library_ms=lib_ms,
        backward_torch_ops_ms=b_ms, backward_bound_ms=bb_ms,
        library_fwd_bwd_ms=lib_fb_ms)


def timed_steps(step, state, pipe, n: int,
                keys=("loss", "grad_norm")):
    """``n`` steps of a ``make_train_step`` on ``pipe``'s batches
    ``0..n-1`` under :class:`FlashCounts`, each timed between device
    synchronisations: ``(state, seconds, [{key: value}], counts)``."""
    from repro_torch.testing import FlashCounts
    secs, ms = [], []
    with FlashCounts() as fc:
        for s in range(n):
            batch = pipe.batch_at(s)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            ms.append({k: float(m[k]) for k in keys})
    return state, secs, ms, fc


def learn(cfg, opt_cfg, batch, steps: int, dev, tag: str) -> None:
    """[<tag>]: ``steps`` steps at LEARN_LR without warm-up from a fresh
    state on one repeated ``batch``, then that batch's loss: it must fall
    at every step, and the parameters stay finite."""
    from repro_torch.launch import train as ltrain
    from repro_torch.models import transformer as T
    learn_cfg = dataclasses.replace(opt_cfg, lr=LEARN_LR)
    state = ltrain.init_state(torch.Generator(device=dev).manual_seed(0),
                              cfg, learn_cfg, device=dev)
    step = ltrain.make_train_step(cfg, None, learn_cfg, total_steps=steps,
                                  warmup=0)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        losses.append(float(T.loss_and_metrics(
            state["params"], cfg, ltrain.to_device(batch, dev),
            impl="pallas")[0]))
    falling = all(b < a for a, b in zip(losses, losses[1:]))
    finite = all(bool(torch.isfinite(p).all())
                 for p in state["params"].parameters())
    phase(tag, steps=steps, lr=LEARN_LR, warmup=0,
          loss=json.dumps([round(x, 4) for x in losses]), falling=falling,
          finite=finite)
    del state, step
    free_cuda()
    if not (falling and finite):
        raise AssertionError(f"[{tag}]: losses {losses}, finite={finite}")


def train_phase(dev) -> dict:
    """[13.*]: Qwen2.5-32B trained on the card through
    ``repro_torch.launch.train`` (see the module docstring); returns the
    training flash record."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.models import flash_xla as fx
    from repro_torch.optim import adamw as optim
    from repro_torch.testing import HostPeak

    t_phase = time.perf_counter()
    peak = HostPeak()
    cfg = dataclasses.replace(configs.get_config("qwen2_5_32b"),
                              n_layers=TRAIN_LAYERS)
    if not (cfg.remat and cfg.dtype == "bfloat16"):
        raise AssertionError(f"{cfg.name}: want remat and bf16")
    record = train_flash_checks(dev, cfg, "13", (
        "[13.run]: the training forward with L, and its recomputation "
        "under remat"))
    opt_cfg = optim.AdamWConfig()
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                         global_batch=TRAIN_B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state, secs, held = build_on_card(lambda: ltrain.init_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg,
        device=dev))
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    phase("13.init", model=cfg.name, layers=f"{cfg.n_layers} of 64",
          d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
          d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
          state_bytes=held, seconds=f"{secs:.2f}")
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config has "
                             f"{cfg.param_count()}")

    # the main path: TRAIN_STEPS steps of make_train_step (impl "pallas")
    step = ltrain.make_train_step(cfg, None, opt_cfg, total_steps=10_000,
                                  warmup=100)
    state, secs, ms, fc = timed_steps(step, state, pipe, TRAIN_STEPS)
    launches, n_plain = fc.launches, fc.plain_calls
    losses = [x["loss"] for x in ms]
    want = 2 * cfg.n_layers * TRAIN_STEPS
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    s_step = sum(secs[1:]) / (len(secs) - 1)
    phase("13.run", batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
          step_s=json.dumps([round(x, 4) for x in secs]),
          s_per_step=f"{s_step:.4f}", tok_s=f"{TRAIN_B * TRAIN_S / s_step:.1f}",
          loss=json.dumps([round(x, 4) for x in losses]),
          grad_norm=json.dumps([round(x["grad_norm"], 3) for x in ms]),
          flash_launches=launches, want=want, plain_calls=n_plain,
          finite=finite, card_peak_bytes=torch.cuda.max_memory_allocated(),
          host_rss_gb=peak.gb())
    if launches != want or n_plain or not finite or not all(
            np.isfinite(losses)):
        raise AssertionError(f"training launched the flash kernel {launches} "
                             f"times (want {want}), {n_plain} plain calls, "
                             f"finite={finite}, losses {losses}")
    record["launches"] = launches

    # one more step in its parts, by CUDA events
    batch = ltrain.to_device(pipe.batch_at(0), dev)
    split = train_split(model, cfg, batch, state["opt"], opt_cfg)
    attn_bwd = cfg.n_layers * record["backward_torch_ops_ms"]
    phase("13.split", forward_ms=f"{split[0]:.2f}",
          backward_ms=f"{split[1]:.2f}", optimizer_ms=f"{split[2]:.2f}",
          step_ms=f"{sum(split):.2f}",
          flash_bwd_ms=f"{attn_bwd:.2f}",
          flash_bwd_share=f"{attn_bwd / sum(split):.4f}",
          flash_fwd_share=f"{2 * cfg.n_layers * record['ms'] / sum(split):.4f}")

    # [13.grad]: the kernel's forward against the plain one, same backward
    del state["opt"]
    torch.cuda.empty_cache()
    g_pal, m_pal = ltrain.grads_and_metrics(model, cfg, batch, impl="pallas")
    g_xla, m_xla = ltrain.grads_and_metrics(model, cfg, batch, impl="xla")
    g_rep, _ = ltrain.grads_and_metrics(model, cfg, batch, impl="xla")
    rep = grad_rel(g_rep, g_xla)
    del g_rep
    rel = grad_rel(g_pal, g_xla)
    lp, lx = float(m_pal["loss"]), float(m_xla["loss"])
    ok = (max(rel.values()) <= TRAIN_GRAD_BOUND
          and abs(lp - lx) <= TRAIN_LOSS_BOUND * abs(lx))
    phase("13.grad", loss_pallas=f"{lp:.6f}", loss_xla=f"{lx:.6f}",
          loss_bound=f"{TRAIN_LOSS_BOUND * abs(lx):.4f}",
          max_rel=worst(rel), bound=TRAIN_GRAD_BOUND,
          repeat_xla_max_rel=worst(rep), tensors=len(rel), within=ok)
    if not ok:
        raise AssertionError("[13.grad]: the kernel's forward moves the loss "
                             "or a gradient beyond the bound")
    real_bwd, calls = fx.flash_bwd, [0]

    def first_dq_zeroed(*a, **kw):
        dq, dk, dv = real_bwd(*a, **kw)
        calls[0] += 1
        return (torch.zeros_like(dq) if calls[0] == 1 else dq), dk, dv

    fx.flash_bwd = first_dq_zeroed
    try:
        g_bad, _ = ltrain.grads_and_metrics(model, cfg, batch, impl="pallas")
    finally:
        fx.flash_bwd = real_bwd
    bad = grad_rel(g_bad, g_xla)
    del g_bad
    rejected = max(bad.values()) > TRAIN_GRAD_BOUND
    phase("control", what="[13.grad] the last layer's dq zeroed (the "
          "step's first attention backward)", max_rel=worst(bad),
          rejected=rejected)
    if not rejected:
        raise AssertionError("the gradient check cannot tell a zeroed dq")

    # [13.accum]: two microbatches summed in fp32 against one batch
    g2, m2 = ltrain.grads_and_metrics(model, cfg, batch, impl="pallas",
                                      grad_accum=2)
    acc = grad_rel(g2, g_pal)
    del g2
    l2 = float(m2["loss"])
    ok = (max(acc.values()) <= TRAIN_ACCUM_BOUND
          and abs(l2 - lp) <= TRAIN_ACCUM_LOSS_BOUND * abs(lp))
    phase("13.accum", grad_accum=2, loss=f"{l2:.6f}", loss_one=f"{lp:.6f}",
          loss_bound=f"{TRAIN_ACCUM_LOSS_BOUND * abs(lp):.4f}",
          max_rel=worst(acc), bound=TRAIN_ACCUM_BOUND, within=ok)
    if not ok:
        raise AssertionError("[13.accum]: grad_accum=2 and 1 disagree")
    g_first, _ = ltrain.grads_and_metrics(
        model, cfg, {k: x[:TRAIN_B // 2] for k, x in batch.items()},
        impl="pallas")
    bad = grad_rel(g_first, g_pal, scale=0.5)
    del g_first, g_pal, g_xla
    rejected = max(bad.values()) > TRAIN_ACCUM_BOUND
    phase("control", what="[13.accum] the second microbatch dropped",
          max_rel=worst(bad), rejected=rejected)
    if not rejected:
        raise AssertionError("the accumulation check cannot tell a dropped "
                             "microbatch")

    # [13.learn]: one batch, repeated, from a fresh state, at LEARN_LR
    del model, state, batch
    torch.cuda.empty_cache()
    learn(cfg, opt_cfg, pipe.batch_at(0), TRAIN_STEPS, dev, "13.learn")
    phase("13.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          host_peak_rss_gb=peak.gb())
    peak.close()
    return record


# --------------------------------------------------------------------- #
# 14. MoE, SSM and hybrid LMs                                           #
# --------------------------------------------------------------------- #

#: [14.moe]: Qwen3-30B-A3B at full width and depth, MOE_B prompts of
#: MOE_P tokens, MOE_G greedy decode steps (cut from 16, ~0.13 s a step
#: in each of its two runs, to pay for phase 17)
MOE_B, MOE_P, MOE_G = 4, 1024, 4
#: [14.moe.check], [14.hybrid]: the kernel's prefill against the plain
#: one on the same weights.  At most this share of (token, choice) routes
#: may differ in expert or in kept slot (PERF.md states why); the logits
#: of the tokens whose routes agree in every MoE layer are held to
#: LM_LOGIT_BOUND.  MOE_CHECK_LAYERS of Qwen3-30B-A3B's 48 layers
ROUTE_SHARE_BOUND, MOE_CHECK_LAYERS = 0.05, 2
#: [14.moe.train]: Qwen3-30B-A3B at full width, TRAIN_LAYERS of its 48
#: layers, TRAIN_B x TRAIN_S tokens, MOE_TRAIN_STEPS steps with the
#: trainer's schedule, then MOE_LEARN_STEPS on one repeated batch at
#: LEARN_LR from a fresh state (each cut from 3, ~0.18 s a step, to pay
#: for phase 17)
MOE_TRAIN_STEPS, MOE_LEARN_STEPS = 2, 2
#: [14.kimi]: Kimi-K2 at full width, its dense prologue and one MoE layer
KIMI_LAYERS, KIMI_B, KIMI_P, KIMI_G = 2, 2, 1024, 4
#: [14.ssm]: Falcon-Mamba-7B at full width and SSM_LAYERS of its 64
#: layers, served once (its warm-up, ~8 s repeating the measured prefill
#: and decode, and 12 of its 16 decode steps, ~48 ms each, were cut to pay
#: for phase 17; half its depth, ~3.4 s of scan in each of its two
#: prefills, to pay for phase 18; the process is warm from the models
#: before it)
SSM_LAYERS, SSM_B, SSM_P, SSM_G = 32, 4, 1024, 4
#: [14.ssm.check]: prefill(P) and one decode step against prefill(P + 1),
#: both within one scan chunk
SSM_CHECK_P = 192
#: [14.ssm.check]: each layer's SSM state after the decode step against
#: the prefill's, ||h_decode - h_prefill|| / ||h_prefill|| (PERF.md states
#: why)
SSM_STATE_BOUND = 2.0 ** -3
#: [14.ssm.check] with the weights cast to fp32
SSM_STATE_BOUND_FP32 = 2.0 ** -10
#: [14.hybrid]: Jamba-1.5-Large at full width, its first 4 layers (ssm +
#: dense, ssm + moe, ssm + dense, attention + moe), HYB_G decode steps in
#: each of its two runs (cut from 8 to pay for phase 17)
HYB_LAYERS, HYB_B, HYB_P, HYB_G = 4, 2, 1024, 4


def family_profile(model, cfg, prompts) -> None:
    """[14.profile]: one prefill under the profiler: device busy share and
    the largest device ops."""
    from repro_torch.launch import serve as lserve
    prefill = lserve.make_prefill(cfg)
    with torch.inference_mode():
        prefill(model, {"inputs": prompts})
        wall, busy, by_name = device_busy(
            lambda: prefill(model, {"inputs": prompts}))
    if not busy > 0:
        raise AssertionError(f"{cfg.name}: the profiler saw no kernel run "
                             "on the card")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    phase("14.profile", model=cfg.name, what="prefill",
          batch=prompts.shape[0], prompt=prompts.shape[1],
          wall_ms=f"{wall:.2f}", device_busy_ms=f"{busy:.2f}",
          busy_share=f"{busy / wall:.3f}",
          top_kernels_ms=json.dumps({n[:60]: round(ms, 3)
                                     for n, ms in top}))


def route_agreement(a, b):
    """``(share of (token, choice) routes whose expert or kept slot
    differ over all MoE calls, tokens whose routes agree in every call)``
    between two ``testing.MoeLog().routes`` lists of one forward each."""
    if len(a) != len(b) or not a:
        raise AssertionError(f"MoE calls {len(a)} and {len(b)}")
    differ = [(ea != eb) | (ka != kb) for (ea, ka), (eb, kb) in zip(a, b)]
    share = float(torch.stack(differ).float().mean())
    agree = ~torch.stack([d.any(-1) for d in differ]).any(0)
    return share, agree


def routes_and_logits_agree(what, got, want, tag="check") -> bool:
    """The kernel's forward (logits, routes) against the plain one's:
    the route share within ROUTE_SHARE_BOUND, the logits of the tokens
    whose routes agree within LM_LOGIT_BOUND (``logits_agree``)."""
    (g_logits, g_calls), (w_logits, w_calls) = got, want
    share, agree = route_agreement(g_calls, w_calls)
    n = int(agree.sum())
    V = g_logits.shape[-1]
    ok = share <= ROUTE_SHARE_BOUND and n > 0
    phase(tag, what=f"{what}: routes", route_share_differing=f"{share:.5f}",
          bound=ROUTE_SHARE_BOUND,
          per_layer=json.dumps([round(float(((ea != eb) | (ka != kb))
                                             .float().mean()), 5)
                                for (ea, ka), (eb, kb) in zip(g_calls,
                                                              w_calls)]),
          tokens_agreeing=f"{n}/{agree.numel()}", within=ok)
    if n:
        ok = logits_agree(f"{what}: logits of the {n} tokens whose routes "
                          "agree", g_logits.reshape(-1, V)[agree],
                          w_logits.reshape(-1, V)[agree], LM_LOGIT_BOUND,
                          tag=tag) and ok
    return ok


def prefill_routes(model, cfg, prompts, impl: str):
    """``(logits (B, S, V), MoeLog routes)`` of one forward."""
    from repro_torch.models import transformer as T
    from repro_torch.testing import MoeLog
    with torch.inference_mode(), MoeLog() as log:
        logits = T.forward(model, cfg, prompts, impl=impl)[0]
    return logits, log.routes


def kernel_vs_plain_routes(what: str, model, cfg, prompts) -> None:
    """The kernel's forward against the plain one's by
    :func:`routes_and_logits_agree`, and its control: the first attention
    layer without the causal mask must be rejected."""
    plain = prefill_routes(model, cfg, prompts, "xla")
    got = prefill_routes(model, cfg, prompts, "pallas")
    if not routes_and_logits_agree(f"{what} pallas vs xla", got, plain):
        raise AssertionError(f"{what}: the kernel's prefill moves routes "
                             "or logits beyond the bounds")
    del got
    with FirstAttentionUnmasked():
        bad = prefill_routes(model, cfg, prompts, "pallas")
    rejected = not routes_and_logits_agree(
        f"{what}, the first attention layer unmasked, vs xla", bad, plain,
        tag="control")
    phase("control", what=f"{what}: the first attention layer unmasked",
          rejected=rejected)
    if not rejected:
        raise AssertionError(f"{what}: the check cannot tell one attention "
                             "layer without the causal mask")


def moe_train_phase(dev) -> dict:
    """[14.moe.train]: Qwen3-30B-A3B at full width, TRAIN_LAYERS layers,
    through ``launch/train.py``: the flash kernel's forward with L at its
    train shape against the plain version (:func:`train_flash_checks`),
    MOE_TRAIN_STEPS steps with the trainer's schedule (flash launches
    with L, 2 a layer a step under remat; the loss and aux finite), one
    step split into its parts, then MOE_LEARN_STEPS steps from a fresh
    state on one repeated batch, whose loss must fall every step.
    Returns the training flash record at this shape."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.optim import adamw as optim

    cfg = dataclasses.replace(configs.get_config("qwen3_moe_30b_a3b"),
                              n_layers=TRAIN_LAYERS)
    if not (cfg.remat and cfg.dtype == "bfloat16"):
        raise AssertionError(f"{cfg.name}: want remat and bf16")
    record = train_flash_checks(dev, cfg, "14.moe.train", (
        "[14.moe.train]: the training forward with L, and its "
        "recomputation under remat"))
    opt_cfg = optim.AdamWConfig()
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                         global_batch=TRAIN_B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state, secs, held = build_on_card(lambda: ltrain.init_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg,
        device=dev))
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    phase("14.moe.train.init", model=cfg.name, layers=f"{cfg.n_layers} of 48",
          params=n_params, state_bytes=held, seconds=f"{secs:.2f}")
    step = ltrain.make_train_step(cfg, None, opt_cfg, total_steps=10_000,
                                  warmup=100)
    state, secs, ms, fc = timed_steps(
        step, state, pipe, MOE_TRAIN_STEPS,
        keys=("loss", "aux_loss", "dropped", "grad_norm"))
    want = 2 * cfg.n_layers * MOE_TRAIN_STEPS
    finite = all(np.isfinite(list(x.values())).all() for x in ms) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    s_step = sum(secs[1:]) / (len(secs) - 1)
    phase("14.moe.train", batch=TRAIN_B, seq=TRAIN_S, steps=MOE_TRAIN_STEPS,
          step_s=json.dumps([round(x, 4) for x in secs]),
          s_per_step=f"{s_step:.4f}", tok_s=f"{TRAIN_B * TRAIN_S / s_step:.1f}",
          **{k: json.dumps([round(x[k], 4) for x in ms]) for k in ms[0]},
          flash_launches=fc.launches, want=want,
          plain_calls=fc.plain_calls, finite=finite,
          card_peak_bytes=torch.cuda.max_memory_allocated())
    if fc.launches != want or fc.plain_calls or not finite:
        raise AssertionError(f"[14.moe.train]: flash launches {fc.launches} "
                             f"(want {want}), {fc.plain_calls} plain calls, "
                             f"finite={finite}")
    record["launches"] = fc.launches
    split = train_split(model, cfg, ltrain.to_device(pipe.batch_at(0), dev),
                        state["opt"], opt_cfg)
    phase("14.moe.train.split", forward_ms=f"{split[0]:.2f}",
          backward_ms=f"{split[1]:.2f}", optimizer_ms=f"{split[2]:.2f}",
          step_ms=f"{sum(split):.2f}")
    del model, state, step
    free_cuda()
    learn(cfg, opt_cfg, pipe.batch_at(0), MOE_LEARN_STEPS, dev,
          "14.moe.train.learn")
    return record


def ssm_state_rel(got, want) -> list:
    """Each layer's ``||h_got - h_want|| / ||h_want||`` of the SSM
    states."""
    return [float(torch.linalg.vector_norm(a.ssm - b.ssm)
                  / torch.linalg.vector_norm(b.ssm))
            for a, b in zip(got, want)]


def ssm_check(model, cfg, prompts, dev) -> None:
    """[14.ssm.check]: prefill of SSM_CHECK_P tokens and one decode step
    against the prefill of the same SSM_CHECK_P + 1 tokens (both within
    one scan chunk): the logits by ``logits_agree`` at LM_LOGIT_BOUND,
    and every layer's SSM state after the step (:func:`ssm_state_rel`,
    each layer's reading printed) within SSM_STATE_BOUND.  Control: the
    states zeroed before the decode step, which the check must reject.
    Then the same check with the weights cast to fp32 (the model is
    left in fp32), within SSM_STATE_BOUND_FP32: what the bf16 reading
    owes to bf16 rounding."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T
    from repro_torch.models.mamba import SSMState
    B, P = prompts.shape[0], SSM_CHECK_P
    if P + 1 > cfg.ssm_chunk:
        raise AssertionError("the check must stay within one scan chunk")
    ids = prompts[:, :P + 1]

    def held(cfg, tag, what, states, want, full, bound) -> bool:
        cache = lserve._merge_prefill_cache(
            T.init_cache(cfg, B, P + 1, device=dev), states, cfg, P)
        logits, new = lserve.make_decode_step(cfg)(
            model, {"inputs": ids[:, P:]}, cache, P)
        rel = ssm_state_rel(new, full)
        ok = logits_agree(f"{what}: logits", logits, want, LM_LOGIT_BOUND,
                          tag=tag)
        worst_layer = int(np.argmax(rel))
        phase(tag, what=f"{what}: SSM states after the step",
              max_rel_state_diff=f"{max(rel):.3e}", bound=bound,
              worst_layer=worst_layer, within=max(rel) <= bound,
              per_layer=json.dumps([float(f"{x:.2e}") for x in rel]))
        return ok and max(rel) <= bound

    def prefills(cfg):
        want, full = lserve.make_prefill(cfg)(model, {"inputs": ids})
        _, pre = lserve.make_prefill(cfg)(model, {"inputs": ids[:, :P]})
        return want, full, pre

    what = (f"[14.ssm.check] decode(prefill(x[:{P}]), x[{P}]) vs "
            f"prefill(x[:{P + 1}])")
    with torch.inference_mode():
        want, full, pre = prefills(cfg)
        if not held(cfg, "check", f"{what} bf16", pre, want, full,
                    SSM_STATE_BOUND):
            raise AssertionError(f"{what}: beyond the bounds")
        zeroed = [SSMState(conv=s.conv, ssm=torch.zeros_like(s.ssm))
                  for s in pre]
        rejected = not held(cfg, "control", "[14.ssm.check] the SSM states "
                            "zeroed before the decode step", zeroed, want,
                            full, SSM_STATE_BOUND)
        phase("control", what="[14.ssm.check] states zeroed",
              rejected=rejected)
        if not rejected:
            raise AssertionError("the SSM check cannot tell a lost state")
        del want, full, pre, zeroed
    model.float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        want, full, pre = prefills(cfg32)
        if not held(cfg32, "check", f"{what} fp32 (the bf16 weights cast)",
                    pre, want, full, SSM_STATE_BOUND_FP32):
            raise AssertionError(f"{what} fp32: beyond the bounds")


def lm_families_phase(dev) -> list:
    """Phase 14 (see the module docstring).  Returns the flash kernel's
    records at this phase's shapes: one for each served shape (Qwen3-MoE;
    Kimi-K2 and Jamba share theirs), each held against the plain
    version (:func:`flash_case`), with the prefill launches of its
    models' measured runs, and [14.moe.train]'s."""
    t_phase = time.perf_counter()
    served = {}                       # (B, Hq, Hkv, S, D) -> [launches, tags]

    def serve(tag, model, cfg, B, P, G, warm_up=True):
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        prompts = prompts_for(cfg, B, P, dev)
        out = serve_family(tag, model, cfg, prompts, G, n_attn,
                           warm_up=warm_up)
        if n_attn:
            shape = (B, cfg.n_heads, cfg.n_kv_heads, P, cfg.head_dim)
            entry = served.setdefault(shape, [0, []])
            entry[0] += out["launches"]
            entry[1].append(f"[{tag}]")
        return prompts

    # [14.moe]: Qwen3-30B-A3B, full width and depth
    model, cfg = family_model("14.moe", "qwen3_moe_30b_a3b", dev)
    prompts = serve("14.moe", model, cfg, MOE_B, MOE_P, MOE_G)
    family_profile(model, cfg, prompts)
    del model
    free_cuda()
    # [14.moe.check]: the same width, MOE_CHECK_LAYERS layers
    model, cfg = family_model("14.moe.check", "qwen3_moe_30b_a3b", dev,
                              MOE_CHECK_LAYERS)
    kernel_vs_plain_routes("[14.moe.check]", model, cfg, prompts)
    del model
    free_cuda()
    records = [moe_train_phase(dev)]

    # [14.kimi]: the dense prologue, then 384 experts with a shared one
    model, cfg = family_model("14.kimi", "kimi_k2_1t_a32b", dev,
                              KIMI_LAYERS)
    serve("14.kimi", model, cfg, KIMI_B, KIMI_P, KIMI_G)
    del model
    free_cuda()

    # [14.ssm]: Falcon-Mamba-7B, full width, SSM_LAYERS: no TPU kernel
    t_ssm = time.perf_counter()
    model, cfg = family_model("14.ssm", "falcon_mamba_7b", dev, SSM_LAYERS)
    prompts = serve("14.ssm", model, cfg, SSM_B, SSM_P, SSM_G,
                    warm_up=False)
    phase("14.ssm.kernels", tpu_kernels="none: attention-free, so no flash "
          "launch; the scan and the state hand-off are torch ops")
    family_profile(model, cfg, prompts)
    ssm_check(model, cfg, prompts, dev)
    del model
    free_cuda()
    phase("14.ssm.done", layers=cfg.n_layers,
          seconds=f"{time.perf_counter() - t_ssm:.1f}")

    # [14.hybrid]: Jamba-1.5-Large's first HYB_LAYERS layers
    model, cfg = family_model("14.hybrid", "jamba_1_5_large_398b", dev,
                              HYB_LAYERS)
    prompts = serve("14.hybrid", model, cfg, HYB_B, HYB_P, HYB_G)
    kernel_vs_plain_routes("[14.hybrid]", model, cfg, prompts)
    del model, prompts
    free_cuda()

    g = torch.Generator(device=dev).manual_seed(14)
    for (B, Hq, Hkv, S, D), (launches, tags) in served.items():
        rec = flash_case(dev, g, torch.bfloat16, B, Hq, Hkv, S, D,
                         tag="14.flash")
        rec["launches"] = launches
        rec["launches_on"] = " and ".join(tags) + " prefill"
        records.append(rec)
    phase("14.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          flash_launches=json.dumps({r["name"]: r["launches"]
                                     for r in records}))
    return records


# --------------------------------------------------------------------- #
# 15. sharded LM serving on a (data, model) mesh of ranks                #
# --------------------------------------------------------------------- #

#: [15.tp]: Qwen2.5-32B at full width, TP_LAYERS of its 64 layers, bf16,
#: served by TP_MESH = (data, model) ranks that share the card, LM_B
#: prompts of LM_P tokens and TP_G greedy decode steps (cut from 8 to pay
#: for phase 17: ~1.0 s a step on the ranks under "gspmd", ~0.22 under
#: "manual"; the layers cut from 4 to 2, the depth of [16.*] and
#: [17.train], to pay for phase 18)
TP_LAYERS, TP_MESH, TP_G = 2, (2, 2), 1
TP_SEED, TP_TIMEOUT = 15, 600
#: max |logit difference| of the sharded run against the unsharded one
#: (and of "manual" against "gspmd") on the same bf16 weights, derived as
#: LM_LOGIT_BOUND is: 8 residual additions (4 layers; 2 since phase 18
#: came, a shorter walk) instead of 128 walk to a quarter of its ~2 %
#: (sqrt(8/128)); a sharded sublayer rounds each
#: rank's partial product to bf16 before the sum over the model axis and
#: the sum once more, two roundings where one rank makes one, which at
#: most doubles that walk's variance: ~0.7 % of the final norm's input,
#: ~0.007 rms in logits of rms ~1, ~5x that at the max of 608k of them;
#: the bound is 2.5x that, rounded up to a power of two (the bf16 step of
#: a logit in [4, 8) is 2^-5).  A control (two ranks' wo blocks of layer
#: 0 swapped) must exceed it.
LM_TP_LOGIT_BOUND = 2.0 ** -3
#: with MoE layers, the least share of (step, row) pairs still fed the
#: same tokens whose logits tp_agree compares.  The rest had a token's
#: routes move at a near tie of the router: on the card 3 of [16.ep]'s 4
#: rows had one within 9 steps, ~14 % of pairs, so ~86 % are compared
#: with an sd of ~6 % over 36 pairs; 50 % is ~6 sd below.  A fault that
#: moves the routes of whole steps leaves fewer.
ROWS_COMPARED_SHARE = 0.5


def tp_agree(what, got, toks, want, want_toks, bound, tag="check",
             agree=None) -> bool:
    """Two runs' logits ``(steps, B, V)`` (step 0 the prefill's) and
    greedy tokens ``(B, steps)``: every step's max abs difference ``d``
    over the rows still on the same tokens within ``bound``, and a token
    may differ only where ``want``'s top-2 margin is within ``2 d`` (a
    near tie, as :func:`logits_agree` allows); a row leaves the
    comparison after its first differing token.  ``agree`` (steps, B),
    for MoE models: whether the row's token of that step has the same
    routes in every MoE layer in both runs; a row whose routes moved is
    not compared at that step (its logits, so its token, may differ) and
    stays while its tokens agree, and at least ROWS_COMPARED_SHARE of the
    (step, row) pairs still fed the same tokens must be compared.  Prints
    each step's ``d`` and the flipped rows' margins."""
    live = torch.ones(got.shape[1], dtype=torch.bool)
    diffs, margins, moved, fed, ok = [], [], 0, 0, True
    for s in range(got.shape[0]):
        same = live if agree is None else live & agree[s]
        d = float((got[s][same] - want[s][same]).abs().max()) if bool(
            same.any()) else 0.0
        diffs.append(round(d, 4))
        top2 = torch.topk(want[s], 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        differ = (toks[:, s] != want_toks[:, s]) & same
        ok &= not bool((differ & (margin > 2 * d)).any())
        margins += [round(float(m), 4) for m in margin[differ]]
        moved += int((live & ~same).sum())
        fed += int(live.sum())
        live &= toks[:, s] == want_toks[:, s]
    within = ok and max(diffs) <= bound
    extra = {}
    if agree is not None:
        within &= fed - moved >= ROWS_COMPARED_SHARE * fed
        extra = dict(pairs_set_aside_by_routes=moved,
                     pairs_compared=f"{fed - moved}/{fed}",
                     min_share=ROWS_COMPARED_SHARE)
    phase(tag, what=what, max_abs_diff=json.dumps(diffs), bound=bound,
          tokens_equal=bool(torch.equal(toks, want_toks)),
          near_tie_flips=len(margins), flip_margins=json.dumps(margins),
          **extra, within=within)
    return within


def rank_fingerprints(model, dev, mesh=TP_MESH) -> list:
    """The fingerprint of the blocks each rank of ``mesh`` (data, model)
    must hold of ``model``: the spec's slices of its weights."""
    from repro_torch.distributed.sharding import make_ctx, shard_param
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.testing import param_fingerprint
    state = model.state_dict()
    out = []
    for rank in range(mesh[0] * mesh[1]):
        ctx = make_ctx(LmMesh(("data", "model"), mesh, tuple(
            int(c) for c in np.unravel_index(rank, mesh)), dev,
            "gloo-staged"))
        out.append(param_fingerprint({n: shard_param(n, w, ctx)
                                      for n, w in state.items()}))
    return out


def tp_runs(dev):
    """[15.unsharded]: Qwen2.5-32B at full width and TP_LAYERS layers,
    bf16, served unsharded in this process (``launch.serve.generate``,
    logits of every step kept).  Returns the ranks' runs of phase 15
    (for :func:`mesh_phases`) and what :func:`tp_check` holds them to:
    ``generate(ctx=)`` of the same model, drawn from the seed on each
    rank and cut to its blocks (``convert.shard_lm_params``), under
    ``tp_collectives="manual"`` (first, also the ranks' warm-up),
    ``"gspmd"`` (the config's default, the timed main path), and the
    control (layer 0's wo blocks of the two model ranks swapped, prefill
    only)."""
    from repro_torch import configs
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T
    from repro_torch.testing import FlashCounts

    t_phase = time.perf_counter()
    full = configs.get_config("qwen2_5_32b")
    cfg = dataclasses.replace(full, n_layers=TP_LAYERS)
    B, P, world = LM_B, LM_P, TP_MESH[0] * TP_MESH[1]
    model, secs, held = build_on_card(lambda: T.init_params(
        torch.Generator(device=dev).manual_seed(TP_SEED), cfg, device=dev))
    prompts = prompts_for(cfg, B, P, dev)
    with torch.inference_mode(), FlashCounts() as fc:
        toks, t = lserve.generate(model, cfg, prompts, TP_G + 1,
                                  keep_logits=True)
    want = torch.stack([x.float().cpu() for x in t["logits"]])
    want_toks = toks.cpu()
    phase("15.unsharded", model=cfg.name,
          layers=f"{cfg.n_layers} of {full.n_layers}", state_bytes=held,
          init_s=f"{secs:.2f}", prefill_ms=f"{t['prefill_s'] * 1e3:.2f}",
          decode_ms_per_step=f"{t['decode_s'] / TP_G * 1e3:.3f}",
          flash_launches=fc.launches, plain_calls=fc.plain_calls,
          tokens=json.dumps(want_toks[:, :6].tolist()))
    want_fp = rank_fingerprints(model, dev)
    del model
    free_cuda()

    common = dict(kind="serve", mesh=TP_MESH, cfg=cfg, seed=TP_SEED,
                  weights="seeded", prompts=prompts.cpu().numpy())
    runs = [dict(common, name="manual", mode="manual", gen=TP_G + 1),
            dict(common, name="gspmd", mode="gspmd", gen=TP_G + 1),
            dict(common, name="control", mode="manual", gen=1,
                 swap="wo")]
    return runs, dict(cfg=cfg, want=want, want_toks=want_toks,
                      want_fp=want_fp,
                      seconds=time.perf_counter() - t_phase)


def tp_check(dev, st: dict, outs: list) -> dict:
    """[15.tp]: phase 15's runs on the ranks (``outs``) against
    :func:`tp_runs`'s ``st``.  Checks: each rank's blocks are the
    unsharded model's (their fingerprints), the logits of the prefill
    and every decode step and the greedy tokens against the unsharded
    run and "manual" against "gspmd" (:func:`tp_agree`,
    LM_TP_LOGIT_BOUND), the control rejected, TP_LAYERS flash launches a
    prefill on every rank and 0 plain calls.  Prints each rank's prefill
    and decode seconds, its collectives' calls, bytes and host seconds
    (staging, wire), its card peak; then the flash kernel at the ranks'
    shape (B/dp, Hq/tp, Hkv/tp) against its plain version.  Returns
    that shape's kernel record."""
    t_phase = time.perf_counter() - st["seconds"]
    cfg, want, want_toks = st["cfg"], st["want"], st["want_toks"]
    want_fp = st["want_fp"]
    B, P, world = LM_B, LM_P, TP_MESH[0] * TP_MESH[1]
    fps = [o["gspmd.fingerprint"] for o in outs]
    phase("15.weights", ranks=world, equal=fps == want_fp,
          fingerprints=json.dumps(fps))
    if fps != want_fp:
        raise AssertionError(f"[15.tp] the ranks' blocks {fps} are not the "
                             f"unsharded weights' {want_fp}")

    def gathered(name):
        # rank (i, 0) holds rows i of the batch, the whole vocabulary
        rows = [torch.from_numpy(outs[i * TP_MESH[1]][f"{name}.logits"])
                for i in range(TP_MESH[0])]
        tk = [torch.from_numpy(o[f"{name}.tokens"]).long() for o in outs]
        if any(not torch.equal(x, tk[0]) for x in tk):
            raise AssertionError(f"[15.tp] {name}: the ranks' tokens differ")
        return torch.cat(rows, dim=1), tk[0]

    got = {}
    for name in ("manual", "gspmd"):
        got[name] = gathered(name)
        launches = [o[f"{name}.flash_launches"] for o in outs]
        plain = [o[f"{name}.plain_calls"] for o in outs]
        phase("15.tp", run=name, transport=repr(outs[0]["transport"]),
              mesh="x".join(map(str, TP_MESH)), batch=B, prompt=P,
              decode_steps=TP_G,
              prefill_ms=json.dumps([round(o[f"{name}.prefill_s"] * 1e3, 2)
                                     for o in outs]),
              decode_ms_per_step=json.dumps(
                  [round(o[f"{name}.decode_s"] / TP_G * 1e3, 2)
                   for o in outs]),
              collective_calls=json.dumps([o[f"{name}.calls"] for o in outs]),
              bytes_in=json.dumps([o[f"{name}.bytes_in"] for o in outs]),
              bytes_out=json.dumps([o[f"{name}.bytes_out"] for o in outs]),
              stage_s=json.dumps([round(o[f"{name}.stage_s"], 3)
                                  for o in outs]),
              wire_s=json.dumps([round(o[f"{name}.wire_s"], 3)
                                 for o in outs]),
              card_peak_bytes=json.dumps([o[f"{name}.card_peak_bytes"]
                                          for o in outs]),
              flash_launches=json.dumps(launches), want=TP_LAYERS,
              plain_calls=json.dumps(plain))
        if launches != [TP_LAYERS] * world or any(plain):
            raise AssertionError(f"[15.tp] {name}: flash launches {launches} "
                                 f"(want {TP_LAYERS} a rank), plain calls "
                                 f"{plain}")
        if not tp_agree(f"[15.tp] {name} vs unsharded, prefill and "
                        f"{TP_G} decode steps", *got[name], want, want_toks,
                        LM_TP_LOGIT_BOUND):
            raise AssertionError(f"[15.tp] {name}: logits or tokens differ "
                                 "from the unsharded run's")
    if not tp_agree("[15.tp] manual vs gspmd", *got["manual"], *got["gspmd"],
                    LM_TP_LOGIT_BOUND):
        raise AssertionError("[15.tp] manual and gspmd disagree")
    bad, bad_toks = gathered("control")
    if tp_agree("[15.tp] layer 0's wo blocks of the two model ranks "
                "swapped, prefill vs unsharded", bad, bad_toks, want[:1],
                want_toks[:, :1], LM_TP_LOGIT_BOUND, tag="control"):
        raise AssertionError("the sharded logits check cannot tell two "
                             "swapped wo blocks")
    phase("control", what="[15.tp] swapped wo blocks", rejected=True,
          prefill_ms=json.dumps([round(o["control.prefill_s"] * 1e3, 2)
                                 for o in outs]))
    finite = all(bool(torch.isfinite(g[0]).all()) for g in got.values())
    if not finite:
        raise AssertionError("[15.tp] non-finite logits")

    # the flash kernel at the shape every rank's prefill runs it at
    g = torch.Generator(device=dev).manual_seed(15)
    rec = flash_case(dev, g, torch.bfloat16, B // TP_MESH[0],
                     cfg.n_heads // TP_MESH[1], cfg.n_kv_heads // TP_MESH[1],
                     P, cfg.head_dim, tag="15.flash")
    rec["launches"] = sum(o["gspmd.flash_launches"] for o in outs)
    rec["launches_on"] = (f"[15.tp] gspmd prefill, summed over its {world} "
                          "ranks")
    phase("15.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          finite=finite)
    return rec


# --------------------------------------------------------------------- #
# 16. expert-parallel MoE and d_inner-parallel Mamba on the mesh         #
# --------------------------------------------------------------------- #

#: [16.ep], [16.ssm]: Qwen3-30B-A3B and Falcon-Mamba-7B at full width,
#: EP_LAYERS of their layers each, bf16, served by TP_MESH ranks that share
#: the card, LM_B prompts of LM_P tokens; the unsharded run takes EP_G
#: greedy decode steps.  Each model's sharded runs: its tp_collectives,
#: each with its decode steps (the first run is also the warm-up); its
#: control (prefill only, "manual").  Cut to keep the smoke well inside
#: its time limit: "manual" serves Qwen3-MoE 4 steps and Falcon only in
#: its control, where "manual" against "gspmd" read 9 routes and exactly
#: 0 on the card over 8 steps (the CPU tests hold both modes); to pay for
#: phase 17, "gspmd" (~2.0 and ~0.7 s a step on the ranks) 2 steps, not 8,
#: and Qwen3-MoE's "manual" (~1.5 s a step) 2, not 4: its decode routes
#: equal "gspmd"'s (0 of 128 differ on the card), so "gspmd"'s first 2
#: steps read as "manual"'s did (8 of 128 apart from the unsharded run).
EP_LAYERS, EP_G, EP_SEED = 2, 2, 16
EP_MODELS = (("16.ep", "qwen3_moe_30b_a3b", "experts",
              (("manual", 2), ("gspmd", EP_G))),
             ("16.ssm", "falcon_mamba_7b", "out_proj", (("gspmd", EP_G),)))
#: the share of decode (token, choice) routes that may differ, all decode
#: steps together (128 entries at EP_G steps): ROUTE_SHARE_BOUND holds the
#: prefill's ~66,000.  Derived before the run that tested it: at the
#: prefill's ~1.65 % rate, 512 entries moving two at a time (a swap of
#: two ranks of a token's top-k) have a share of sd ~0.6 %; 2^-3 is
#: ~18 sd above, and a fault in the decode path of one of the 2 layers
#: moves ~50 %.  At 128 entries that sd is ~1.6 %, the bound ~7 sd above.
DECODE_ROUTE_SHARE_BOUND = 2.0 ** -3
#: each SSM layer's final state of the sharded run against the unsharded
#: one on the same bf16 weights, ||h_got - h_want|| / ||h_want|| over the
#: rows whose tokens agree.  Derived as LM_TP_LOGIT_BOUND is: the sharded
#: mixer rounds each rank's x_proj and out_proj partial to bf16 before the
#: sum over the model axis, and its in_proj and x_proj are other GEMM
#: shapes, so a share of the scan's bf16 inputs (x, dt, B, C) move by one
#: bf16 step (2^-8 relative); the state sums ~1,000 such terms of random
#: sign, which brings the relative error near 2^-8 / sqrt(#terms) a layer
#: and at most doubles it in the second layer: ~1e-3.  [14.ssm.check]
#: read 3.3e-4 at layer 0 for a smaller change (the scan's tree alone).
#: The bound is 2^-5, ~30x that; the control (layer 0's out_proj blocks
#: of the two model ranks swapped) moves layer 1's state by O(1).
SSM_TP_STATE_BOUND = 2.0 ** -5


def route_compare(got, want, n_moe: int, P: int, same_prefix):
    """Two runs' MoE routes on one dp shard's rows: each a list of
    ``(experts (T, k), kept (T, k))`` a call, the prefill's layer by layer
    (T = rows * P), then each decode step's (T = rows).  Returns
    ``(counts (2, 2), agree (steps, rows))``: the entries differing and
    compared, of the prefill (row 0) and of all decode steps (row 1); an
    entry differs where its expert or kept slot does; a row agrees at a
    step where the routes of its token of that step (the prefill's last)
    agree in every MoE layer.  Decode steps count only the rows of
    ``same_prefix`` (steps, rows): those fed the same tokens so far."""
    steps = len(got) // n_moe
    rows = got[0][0].shape[0] // P
    counts = np.zeros((2, 2), dtype=np.int64)
    agree = np.ones((steps, rows), dtype=bool)
    for s in range(steps):
        for layer in range(n_moe):
            (ge, gk) = got[s * n_moe + layer]
            (we, wk) = want[s * n_moe + layer]
            d = (ge != we) | (gk != wk)                          # (T, k)
            if s == 0:
                agree[0] &= ~d.reshape(rows, P, -1)[:, -1].any(-1)
            else:
                agree[s] &= ~d.any(-1)
                d = d[same_prefix[s]]
            counts[min(s, 1)] += (int(d.sum()), d.size)
    return counts, agree


def ep_head(recs: list, steps: int, n_moe: int) -> list:
    """:func:`ep_compare`'s records cut to their first ``steps`` tokens
    (the prefill's and ``steps - 1`` decode steps'), without the SSM
    states (the last step's)."""
    return [dict(r, tokens=r["tokens"][:, :steps], logits=r["logits"][:steps],
                 routes=r["routes"][:steps * n_moe], ssm=[]) for r in recs]


def ep_compare(what, cfg, got: list, want: list, P: int, tag="check"
               ) -> bool:
    """Two runs of one model, each a :func:`repro_torch.testing.
    serve_record` for each dp shard (in row order): the greedy tokens
    and every step's logits by :func:`tp_agree` at LM_TP_LOGIT_BOUND
    (rows whose routes moved set aside at that step), the share of
    (token, choice) routes that differ within ROUTE_SHARE_BOUND in the
    prefill and DECODE_ROUTE_SHARE_BOUND over the decode steps (where
    there are any), each SSM layer's final
    state over the rows whose tokens all agree within
    SSM_TP_STATE_BOUND (where ``want`` holds states).  Prints each
    reading; True if all hold."""
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    toks, wtoks = (torch.from_numpy(np.concatenate(
        [r["tokens"] for r in recs])).long() for recs in (got, want))
    logits, wlogits = (torch.from_numpy(np.concatenate(
        [r["logits"] for r in recs], axis=1)).float()
        for recs in (got, want))
    ok, agree = True, None
    if n_moe:
        counts = np.zeros((2, 2), dtype=np.int64)
        parts = []
        for g, w in zip(got, want):
            steps = g["tokens"].shape[1]
            same = np.stack([(g["tokens"][:, :s] == w["tokens"][:, :s])
                             .all(1) for s in range(steps)])
            c, a = route_compare(g["routes"], w["routes"], n_moe, P, same)
            counts += c
            parts.append(a)
        agree = torch.from_numpy(np.concatenate(parts, axis=1))
        for part, (differ, total), bound in (
                ("prefill", counts[0], ROUTE_SHARE_BOUND),
                ("decode steps", counts[1], DECODE_ROUTE_SHARE_BOUND)):
            if not total:
                continue
            share = differ / total
            phase(tag, what=f"{what}: routes of the {part}",
                  route_share_differing=f"{share:.5f}", differing=int(differ),
                  compared=int(total), bound=bound, within=share <= bound)
            ok &= share <= bound
    ok &= tp_agree(f"{what}: logits and tokens", logits, toks, wlogits,
                   wtoks, LM_TP_LOGIT_BOUND, tag=tag, agree=agree)
    if want[0]["ssm"]:
        rows = (toks == wtoks).all(1).numpy()
        rel = []
        for layer in range(len(want[0]["ssm"])):
            a = np.concatenate([r["ssm"][layer][1] for r in got])[rows]
            b = np.concatenate([r["ssm"][layer][1] for r in want])[rows]
            rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                       if rows.any() else float("inf"))
        within = max(rel) <= SSM_TP_STATE_BOUND
        phase(tag, what=f"{what}: SSM states after the last step",
              max_rel_state_diff=f"{max(rel):.3e}", bound=SSM_TP_STATE_BOUND,
              per_layer=json.dumps([float(f"{x:.3e}") for x in rel]),
              rows=int(rows.sum()), within=within)
        ok &= within
    return bool(ok)


def mesh_records(outs, name, mesh, rows) -> list:
    """A serve run's results on the ranks of ``mesh`` (``outs``) as one
    record a data row, as :func:`ep_compare` reads them: the ranks (i, j)
    hold rows i of the batch (``rows[i]``), their logits and routes alike
    (rank (i, 0)'s taken), the SSM states their d_inner blocks j (joined);
    the tokens every rank's, which must be equal."""
    tk = [o[f"{name}.tokens"] for o in outs]
    if any(not np.array_equal(x, tk[0]) for x in tk):
        raise AssertionError(f"[{name}] the ranks' tokens differ")
    recs = []
    for i in range(mesh[0]):
        group = outs[i * mesh[1]:(i + 1) * mesh[1]]
        r = {k: group[0][f"{name}.{k}"] for k in ("logits", "routes")}
        r["ssm"] = [tuple(np.concatenate([o[f"{name}.ssm"][layer][n]
                                          for o in group], axis=axis)
                          for n, axis in ((0, 2), (1, 1)))
                    for layer in range(len(group[0][f"{name}.ssm"]))]
        r["tokens"] = tk[0][rows[i]]
        recs.append(r)
    return recs


def ep_runs(dev):
    """[16.*.unsharded]: Qwen3-30B-A3B and Falcon-Mamba-7B at full width,
    EP_LAYERS layers each, bf16, seeded, each served unsharded in this
    process on each dp row's LM_B / dp prompts
    (:func:`repro_torch.testing.serve_record`: an MoE layer's capacity
    counts the tokens of its call, so the sharded run drops per dp
    shard).  Returns the ranks' runs of phase 16 (for
    :func:`mesh_phases`) and what :func:`ep_check` holds them to: each
    model drawn from the seed on each rank and cut to its blocks,
    ``generate(ctx=)`` under each of its EP_MODELS modes, and a control
    (Qwen3-MoE: the first MoE layer's experts of the two model ranks
    swapped; Falcon: layer 0's ``out_proj`` blocks swapped; prefill
    only)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.testing import serve_record

    t_phase = time.perf_counter()
    B, P = LM_B, LM_P
    rows = [slice(i * B // TP_MESH[0], (i + 1) * B // TP_MESH[0])
            for i in range(TP_MESH[0])]
    runs, oracle = [], {}
    for tag, arch, control, modes in EP_MODELS:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=EP_LAYERS)
        model, secs, held = build_on_card(lambda: T.init_params(
            torch.Generator(device=dev).manual_seed(EP_SEED), cfg,
            device=dev))
        prompts = prompts_for(cfg, B, P, dev)
        want = [serve_record(model, cfg, prompts[r], EP_G + 1) for r in rows]
        oracle[tag] = (cfg, want, rank_fingerprints(model, dev))
        phase(f"{tag}.unsharded", model=cfg.name,
              layers=f"{cfg.n_layers} of {full.n_layers}",
              params=sum(p.numel() for p in model.parameters()),
              state_bytes=held, init_s=f"{secs:.2f}", shards=len(rows),
              prefill_ms=json.dumps([round(w["prefill_s"] * 1e3, 2)
                                     for w in want]),
              decode_ms_per_step=json.dumps([round(w["decode_s"] / EP_G
                                                   * 1e3, 3) for w in want]),
              flash_launches=json.dumps([w["flash_launches"] for w in want]),
              plain_calls=json.dumps([w["plain_calls"] for w in want]),
              aux_loss=json.dumps([round(w["aux_loss"], 4) for w in want]),
              dropped=json.dumps([round(w["dropped"], 4) for w in want]))
        del model
        free_cuda()
        common = dict(kind="serve", mesh=TP_MESH, cfg=cfg, seed=EP_SEED,
                      weights=tag, prompts=prompts.cpu().numpy())
        runs += [dict(common, name=f"{tag}.{mode}", mode=mode, gen=steps + 1)
                 for mode, steps in modes]
        runs.append(dict(common, name=f"{tag}.control", mode="manual", gen=1,
                         swap=control))
    return runs, dict(oracle=oracle, rows=rows,
                      seconds=time.perf_counter() - t_phase)


def ep_check(dev, st: dict, outs: list) -> dict:
    """Phase 16's runs on the ranks (``outs``) against :func:`ep_runs`'s
    ``st``.  Checks: the ranks' blocks (fingerprints), every step's
    logits and the greedy tokens, the routes and the SSM states against
    the unsharded run (:func:`ep_compare`; a shorter run against the
    unsharded run's first steps), "manual" against "gspmd" over the
    steps both took, the route digests of the two model ranks of a data
    row equal, the controls rejected, EP_LAYERS flash launches a prefill
    on every Qwen3-MoE rank and 0 plain calls.  Prints each rank's
    prefill and decode seconds, its collectives' calls, bytes and host
    seconds, its card peak, its prefill's ``aux_loss`` and ``dropped``;
    then the flash kernel at the ranks' shape against its plain version.
    Returns that shape's kernel record."""
    t_phase = time.perf_counter() - st["seconds"]
    B, P, world = LM_B, LM_P, TP_MESH[0] * TP_MESH[1]
    oracle, rows = st["oracle"], st["rows"]

    def shards(name):
        return mesh_records(outs, name, TP_MESH, rows)

    launches = 0
    for tag, arch, control, modes in EP_MODELS:
        cfg, want, want_fp = oracle[tag]
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
        fps = [o[f"{tag}.gspmd.fingerprint"] for o in outs]
        phase(f"{tag}.weights", ranks=world, equal=fps == want_fp,
              fingerprints=json.dumps(fps))
        if fps != want_fp:
            raise AssertionError(f"[{tag}] the ranks' blocks {fps} are not "
                                 f"the unsharded weights' {want_fp}")
        got = {}
        for mode, steps in modes:
            name = f"{tag}.{mode}"
            fl = [o[f"{name}.flash_launches"] for o in outs]
            plain = [o[f"{name}.plain_calls"] for o in outs]
            digests = [o[f"{name}.route_digests"] for o in outs]
            same_routes = all(digests[i * TP_MESH[1] + j] == digests[
                i * TP_MESH[1]] for i in range(TP_MESH[0])
                for j in range(TP_MESH[1]))
            phase(tag, run=mode, transport=repr(outs[0]["transport"]),
                  mesh="x".join(map(str, TP_MESH)), batch=B, prompt=P,
                  decode_steps=steps,
                  prefill_ms=json.dumps([round(o[f"{name}.prefill_s"] * 1e3,
                                               2) for o in outs]),
                  decode_ms_per_step=json.dumps(
                      [round(o[f"{name}.decode_s"] / steps * 1e3, 2)
                       for o in outs]),
                  collective_calls=json.dumps([o[f"{name}.calls"]
                                               for o in outs]),
                  bytes_in=json.dumps([o[f"{name}.bytes_in"] for o in outs]),
                  bytes_out=json.dumps([o[f"{name}.bytes_out"]
                                        for o in outs]),
                  stage_s=json.dumps([round(o[f"{name}.stage_s"], 3)
                                      for o in outs]),
                  wire_s=json.dumps([round(o[f"{name}.wire_s"], 3)
                                     for o in outs]),
                  card_peak_bytes=json.dumps([o.get(
                      f"{name}.card_peak_bytes") for o in outs]),
                  aux_loss=json.dumps([round(o[f"{name}.aux_loss"], 4)
                                       for o in outs]),
                  dropped=json.dumps([round(o[f"{name}.dropped"], 4)
                                      for o in outs]),
                  route_digests=json.dumps([d[0] if d else None
                                            for d in digests]),
                  model_ranks_route_alike=same_routes,
                  flash_launches=json.dumps(fl), want=n_attn,
                  plain_calls=json.dumps(plain))
            if fl != [n_attn] * world or any(plain):
                raise AssertionError(f"[{tag}] {mode}: flash launches {fl} "
                                     f"(want {n_attn} a rank), plain calls "
                                     f"{plain}")
            if not same_routes:
                raise AssertionError(f"[{tag}] {mode}: the model ranks of a "
                                     f"data row routed differently: {digests}")
            got[mode] = shards(name)
            if not ep_compare(f"[{tag}] {mode} vs unsharded, prefill and "
                              f"{steps} decode steps", cfg, got[mode],
                              want if steps == EP_G else
                              ep_head(want, steps + 1, n_moe), P):
                raise AssertionError(f"[{tag}] {mode}: beyond the bounds "
                                     "against the unsharded run")
            if not all(np.isfinite(r["logits"]).all() for r in got[mode]):
                raise AssertionError(f"[{tag}] {mode}: non-finite logits")
        if len(got) == 2:
            steps = min(s for _, s in modes)
            if not ep_compare(f"[{tag}] manual vs gspmd, prefill and {steps}"
                              " decode steps", cfg, got["manual"],
                              ep_head(got["gspmd"], steps + 1, n_moe), P):
                raise AssertionError(f"[{tag}] manual and gspmd disagree")
        if n_moe:
            # the checks' own control: the "gspmd" run's routes with every
            # decode route moved to the next expert, as a fault of the MoE
            # decode path alone would move them
            moved = [dict(r, routes=r["routes"][:n_moe] + [
                ((e + 1) % cfg.n_experts, k) for e, k in r["routes"][n_moe:]])
                for r in got["gspmd"]]
            if ep_compare(f"[{tag}] gspmd with every decode route moved to "
                          "the next expert, vs unsharded", cfg, moved, want,
                          P, tag="control"):
                raise AssertionError(f"[{tag}] the check cannot tell decode "
                                     "routes that all moved")
            phase("control", what=f"[{tag}] every decode route moved",
                  rejected=True)
        bad = [dict(r, ssm=[]) for r in shards(f"{tag}.control")]
        if ep_compare(f"[{tag}] the {control} blocks of the two model ranks "
                      "swapped, prefill vs unsharded", cfg, bad,
                      ep_head(want, 1, n_moe), P, tag="control"):
            raise AssertionError(f"[{tag}] the check cannot tell swapped "
                                 f"{control} blocks")
        phase("control", what=f"[{tag}] swapped {control} blocks",
              rejected=True)
        launches += sum(o[f"{tag}.gspmd.flash_launches"] for o in outs)

    # the flash kernel at the shape every [16.ep] rank's prefill runs it at
    cfg = oracle["16.ep"][0]
    g = torch.Generator(device=dev).manual_seed(16)
    rec = flash_case(dev, g, torch.bfloat16, B // TP_MESH[0],
                     cfg.n_heads // TP_MESH[1], cfg.n_kv_heads // TP_MESH[1],
                     P, cfg.head_dim, tag="16.flash")
    rec["launches"] = launches
    rec["launches_on"] = (f"[16.ep] gspmd prefill, summed over its {world} "
                          "ranks")
    phase("16.done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return rec


# --------------------------------------------------------------------- #
# 17. dense LM training on the mesh                                       #
# --------------------------------------------------------------------- #

#: [17.train]: Qwen2.5-32B at full width, TRAIN_LAYERS layers, bf16,
#: remat, trained by the TP_MESH ranks that share the card under its
#: config's "gspmd": a global batch of MESH_TRAIN_B x TRAIN_S tokens (each
#: data row's TRAIN_B x TRAIN_S, [13.run]'s batch), MESH_TRAIN_STEPS steps
#: at LEARN_LR without warm-up, from the seed MESH_TRAIN_SEED
MESH_TRAIN_B, MESH_TRAIN_STEPS, MESH_TRAIN_SEED = 4, 2, 17
#: [17.train]'s tensors held against the unsharded run, one of each spec
#: kind, and the rows of each (None: whole; the embedding's: the first
#: step's tokens and MESH_TRAIN_ZERO_ROWS ids it has not, whose gradient
#: is zero; the head's: MESH_TRAIN_HEAD_ROWS rows of each dp block)
MESH_TRAIN_TENSORS = ("layers.0.mixer.wq.w", "layers.1.mixer.wo.w",
                      "layers.0.mixer.wq.b", "layers.0.norm1.scale",
                      "final_norm.scale", "embed.table", "lm_head.w")
MESH_TRAIN_ZERO_ROWS, MESH_TRAIN_HEAD_ROWS, MESH_TRAIN_W_ROWS = 8, 64, 256
#: [17.train]: each spec kind's part of the squared gradient norm (the
#: square of the ranks' sharding.global_norm of that kind's blocks, which
#: divides each block's sum of squares by its copies) against the
#: unsharded gradients', relative: PERF.md states why
NORM_PART_BOUND = 2.0 ** -4
#: [17.train]: the masters after the last step, held with
#: testing.assert_rare_flips: an element "flips" where its move differs
#: from the unsharded run's by more than MASTER_MOVE_UNIT x lr (a step's
#: sign flipped: Adam's first steps are about lr sign(g)), and at most
#: MASTER_FLIP_SHARE of the updated elements may.  The ranks' bf16
#: activations differ from one card's by about an ulp (two roundings of a
#: row-parallel sum where one card makes one), so a gradient element's
#: noise is ~2^-9 of the spread of its terms, and an element whose
#: gradient lies within that of 0 (~0.8 x 2^-9 ~ 0.16 % of a Gaussian
#: spread) may step the other way, in either of two steps: ~0.3 %; the
#: bound is 2.5x that, rounded to a power of two (on the card: 0.16 % of
#: the final norm's scale, 0.046 % of wq's; PERF.md)
MASTER_MOVE_UNIT, MASTER_FLIP_SHARE = 1.0, 2.0 ** -7


def mesh_train_rows(cfg, batch) -> dict:
    """``{tensor: global rows or None}`` of MESH_TRAIN_TENSORS (sorted
    numpy indices): whole, or the rows named above."""
    toks = np.unique(batch["inputs"])
    absent = np.setdiff1d(np.arange(cfg.vocab_size), toks)
    absent = absent[np.linspace(0, len(absent) - 1,
                                MESH_TRAIN_ZERO_ROWS).astype(int)]
    half = cfg.d_model // 2
    head = np.concatenate([np.arange(MESH_TRAIN_HEAD_ROWS),
                           half + np.arange(MESH_TRAIN_HEAD_ROWS)])
    w = np.concatenate([np.arange(MESH_TRAIN_W_ROWS),
                        half + np.arange(MESH_TRAIN_W_ROWS)])
    rows = {k: None for k in MESH_TRAIN_TENSORS}
    rows.update({"embed.table": np.union1d(toks, absent), "lm_head.w": head,
                 "layers.0.mixer.wq.w": w, "layers.1.mixer.wo.w": w})
    return rows


def mesh_train_runs(dev):
    """[17.unsharded]: the unsharded port's run of [17.train] in this
    process: ``init_state`` from MESH_TRAIN_SEED, then MESH_TRAIN_STEPS
    steps on the global batches (the first through
    ``testing.split_train_step``, the two calls ``make_train_step``
    makes, to read its gradients; the second through
    ``make_train_step``), and the unsharded gradient
    of data row 0's half of the first batch (a control).  Keeps the rows
    of MESH_TRAIN_TENSORS (gradients, masters before and after), each
    spec kind's part of the squared gradient norm, the losses and
    ``grad_norm`` s, then frees the state.  Returns the ranks' run and
    what :func:`mesh_train_check` holds it to."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import make_ctx, spec_for
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.optim import adamw as optim
    from repro_torch.testing import FlashCounts, block_rows, split_train_step

    t_phase = time.perf_counter()
    full = configs.get_config("qwen2_5_32b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    layout = make_ctx(LmMesh(("data", "model"), TP_MESH, (0, 0), dev,
                             "gloo-staged"))
    opt_cfg = optim.AdamWConfig(lr=LEARN_LR)
    batches = mesh_train_batches(cfg)
    rows = mesh_train_rows(cfg, batches[0])
    torch.cuda.reset_peak_memory_stats()
    state, init_s, held = build_on_card(lambda: ltrain.init_state(
        torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED), cfg,
        opt_cfg, device=dev))
    model = state["params"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}

    def windows(tensors):
        return {k: block_rows(tensors[k], (None,) * len(shapes[k]), None,
                              rows[k]) for k in MESH_TRAIN_TENSORS}

    start = windows(state["opt"]["master"])
    # the control: data row 0's half of the first batch, unsharded
    half = ltrain.to_device({k: v[:MESH_TRAIN_B // TP_MESH[0]]
                             for k, v in batches[0].items()}, dev)
    g_half, _ = ltrain.grads_and_metrics(model, cfg, half, impl="pallas")
    half_w = windows(g_half)
    del g_half, half
    got = {}
    kw = dict(total_steps=MESH_TRAIN_STEPS, warmup=0)
    step = ltrain.make_train_step(cfg, None, opt_cfg, **kw)
    metrics, secs = [], []
    with FlashCounts() as fc:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                state, m, grads, _ = split_train_step(state, batch, cfg,
                                                      opt_cfg, **kw)
            else:
                state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                got["grad"], parts = windows(grads), {}
                for k, g in grads.items():
                    kind = str(spec_for(k, g.dim(), layout))
                    parts[kind] = parts.get(kind, 0.0) + float(
                        torch.sum(torch.square(g.float())))
                got["parts"] = parts
                del grads
    end = windows(state["opt"]["master"])
    phase("17.unsharded", seconds=f"{time.perf_counter() - t_phase:.1f}",
          model=cfg.name,
          layers=f"{cfg.n_layers} of {full.n_layers}", batch=MESH_TRAIN_B,
          seq=TRAIN_S, steps=MESH_TRAIN_STEPS, state_bytes=held,
          init_s=f"{init_s:.2f}",
          step_s=json.dumps([round(x, 4) for x in secs]),
          loss=json.dumps([round(x["loss"], 5) for x in metrics]),
          grad_norm=json.dumps([round(x["grad_norm"], 5) for x in metrics]),
          flash_launches=fc.launches, plain_calls=fc.plain_calls,
          card_peak_bytes=torch.cuda.max_memory_allocated())
    del state, model, step
    free_cuda()
    run = dict(name="train", kind="train", mesh=TP_MESH, mode="gspmd",
               cfg=cfg, seed=MESH_TRAIN_SEED, batches=batches,
               opt=dict(lr=LEARN_LR), warmup=0,
               total_steps=MESH_TRAIN_STEPS, impl="pallas", keep=rows,
               state_keys=("master",))
    return [run], dict(cfg=cfg, rows=rows, shapes=shapes, start=start,
                       end=end, half=half_w, metrics=metrics,
                       seconds=time.perf_counter() - t_phase, **got)


def mesh_train_check(dev, st: dict, outs: list) -> dict:
    """[17.train]: the ranks' run (``outs``) against
    :func:`mesh_train_runs`'s ``st``.  Checks: every step's loss
    (TRAIN_LOSS_BOUND, relative), the first step's gradients of
    MESH_TRAIN_TENSORS (TRAIN_GRAD_BOUND, per tensor as [13.grad]; the
    ranks' copies of a replicated block equal), ``grad_norm`` (the same
    on every rank, within TRAIN_LOSS_BOUND of the unsharded one) and
    the square of each spec kind's part, the ranks' own
    ``sharding.global_norm`` of that kind's blocks
    (``testing.kind_norms``, the same on every rank; NORM_PART_BOUND),
    the masters
    after the last step (MASTER_MOVE_UNIT, ``assert_rare_flips``), the
    ranks' state blocks (``launch.specs.train_state_struct``), 2 flash
    launches a layer a step on every rank (remat) and 0 plain calls; two
    controls rejected (data row 0's half-batch gradient; a norm that
    counts the tp-replicated tensors once a model rank).  Prints each
    rank's step seconds, collectives' calls, bytes and wire seconds and
    card peak.  Then [17.flash]: the flash kernel with L at the ranks'
    shape (B/dp, Hq/tp, Hkv/tp).  Returns that shape's kernel record."""
    from repro_torch.distributed.sharding import make_ctx, spec_for
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.testing import assemble_rows, assert_rare_flips

    t_phase = time.perf_counter() - st["seconds"]
    cfg, rows, shapes = st["cfg"], st["rows"], st["shapes"]
    world = TP_MESH[0] * TP_MESH[1]
    layout = make_ctx(LmMesh(("data", "model"), TP_MESH, (0, 0), dev,
                             "gloo-staged"))
    coords = [o["train.coords"] for o in outs]
    want_m = st["metrics"]

    def assembled(what, k):
        spec = spec_for(k, len(shapes[k]), layout)
        return assemble_rows([o[f"train.{what}.{k}"] for o in outs], coords,
                             shapes[k], spec, ("data", "model"), TP_MESH,
                             rows[k])

    def rel(got, want):
        return {k: float(np.linalg.norm(got[k].astype(np.float64)
                                        - want[k])
                         / np.linalg.norm(want[k].astype(np.float64)))
                for k in want}

    metrics = [o["train.metrics"] for o in outs]
    same = all(m == metrics[0] for m in metrics)
    launches = [o["train.flash_launches"] for o in outs]
    plain = [o["train.plain_calls"] for o in outs]
    want_l = 2 * cfg.n_layers * MESH_TRAIN_STEPS
    bad_struct = [o["train.struct_mismatches"] for o in outs]
    phase("17.train", transport=repr(outs[0]["transport"]),
          mesh="x".join(map(str, TP_MESH)), batch=MESH_TRAIN_B, seq=TRAIN_S,
          steps=MESH_TRAIN_STEPS, lr=LEARN_LR,
          step_s=json.dumps([[round(x, 3) for x in o["train.step_s"]]
                             for o in outs]),
          step1_grads_update_s=json.dumps(
              [round(x, 3) for x in outs[0]["train.step_split_s"]]),
          step_wire_s=json.dumps([round(x, 3)
                                  for x in outs[0]["train.step_wire_s"]]),
          pin_s=json.dumps([round(o["train.pin_s"], 3) for o in outs]),
          run_s=json.dumps([round(o["train.run_s"], 2) for o in outs]),
          loss=json.dumps([round(x["loss"], 5) for x in metrics[0]]),
          grad_norm=json.dumps([round(x["grad_norm"], 5)
                                for x in metrics[0]]),
          metrics_equal_on_ranks=same,
          collective_calls=json.dumps([o["train.calls"] for o in outs]),
          bytes_in=json.dumps([o["train.bytes_in"] for o in outs]),
          bytes_out=json.dumps([o["train.bytes_out"] for o in outs]),
          stage_s=json.dumps([round(o["train.stage_s"], 3) for o in outs]),
          wire_s=json.dumps([round(o["train.wire_s"], 3) for o in outs]),
          card_peak_bytes=json.dumps([o.get("train.card_peak_bytes")
                                      for o in outs]),
          flash_launches=json.dumps(launches), want=want_l,
          plain_calls=json.dumps(plain),
          state_struct_equal=not any(bad_struct))
    fails = []
    if not same:
        fails.append("the ranks' metrics differ")
    if launches != [want_l] * world or any(plain):
        fails.append(f"flash launches {launches} (want {want_l} a rank), "
                     f"plain calls {plain}")
    if any(bad_struct):
        fails.append(f"state blocks unlike train_state_struct: {bad_struct}")

    # the loss of every step
    dl = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
          for g, w in zip(metrics[0], want_m)]
    ok = max(dl) <= TRAIN_LOSS_BOUND
    phase("check", what="[17.train] loss of each step vs unsharded",
          got=json.dumps([round(x["loss"], 5) for x in metrics[0]]),
          want=json.dumps([round(x["loss"], 5) for x in want_m]),
          max_rel=f"{max(dl):.3e}", bound=TRAIN_LOSS_BOUND, within=ok)
    if not ok:
        fails.append("losses")

    # the first step's gradients
    grads, equal = {}, {}
    for k in MESH_TRAIN_TENSORS:
        grads[k], equal[k] = assembled("grad", k)
    g_rel = rel(grads, st["grad"])
    ok = max(g_rel.values()) <= TRAIN_GRAD_BOUND and all(equal.values())
    phase("check", what="[17.train] step 1 gradients vs unsharded",
          max_rel=worst(g_rel, len(g_rel)), bound=TRAIN_GRAD_BOUND,
          copies_equal=json.dumps(equal), embed_rows=len(rows["embed.table"]),
          head_rows=len(rows["lm_head.w"]), within=ok)
    if not ok:
        fails.append("gradients")
    bad = rel(grads, st["half"])
    rejected = min(bad.values()) > TRAIN_GRAD_BOUND
    phase("control", what="[17.train] the unsharded gradient of data row "
          "0's half of the batch", min_rel=f"{min(bad.values()):.3e}",
          max_rel=worst(bad), rejected=rejected)
    if not rejected:
        fails.append("the half-batch control")

    # grad_norm and each spec kind's part, as the ranks' global_norm gives
    specs_ = {str(spec_for(k, len(v), layout)): spec_for(k, len(v), layout)
              for k, v in shapes.items()}
    norms = [o["train.kind_norms"] for o in outs]
    parts = {k: v * v for k, v in norms[0].items()}
    twice = {k: v * (1 if layout.tp in specs_[k] else TP_MESH[1])
             for k, v in parts.items()}
    gn = [x["grad_norm"] for x in metrics[0]]
    dn = abs(gn[0] - want_m[0]["grad_norm"]) / want_m[0]["grad_norm"]
    p_rel = {k: abs(parts.get(k, 0.0) - v) / v
             for k, v in st["parts"].items()}
    ok = (dn <= TRAIN_LOSS_BOUND and max(p_rel.values()) <= NORM_PART_BOUND
          and set(parts) == set(st["parts"])
          and all(n == norms[0] for n in norms)
          and len({o["train.metrics"][0]["grad_norm"] for o in outs}) == 1)
    phase("check", what="[17.train] step 1 grad_norm, and each spec kind's "
          "part of its square by the ranks' global_norm, vs unsharded",
          grad_norm=f"{gn[0]:.6f}",
          want=f"{want_m[0]['grad_norm']:.6f}", rel=f"{dn:.3e}",
          bound=TRAIN_LOSS_BOUND, part_rel=worst(p_rel, len(p_rel)),
          part_bound=NORM_PART_BOUND,
          part_share=json.dumps({k: f"{v / sum(st['parts'].values()):.3e}"
                                 for k, v in st["parts"].items()}),
          within=ok)
    if not ok:
        fails.append("grad_norm")
    t_rel = {k: abs(twice.get(k, 0.0) - v) / v
             for k, v in st["parts"].items()}
    rejected = max(t_rel.values()) > NORM_PART_BOUND
    phase("control", what="[17.train] a norm counting each tp-replicated "
          "tensor once a model rank", part_rel=worst(t_rel, len(t_rel)),
          rejected=rejected)
    if not rejected:
        fails.append("the norm control")

    # the masters after the last step
    flips = {}
    unit = MASTER_MOVE_UNIT * LEARN_LR
    for k in MESH_TRAIN_TENSORS:
        got, eq = assembled("master", k)
        g, w, s0 = (torch.from_numpy(np.ascontiguousarray(a)) for a in (
            got, st["end"][k], st["start"][k]))
        far = (g - w).abs() > unit
        try:
            flips[k] = assert_rare_flips(torch.where(far, g, w), w, s0,
                                         what=k, share=MASTER_FLIP_SHARE)
        except AssertionError as e:
            flips[k] = str(e)
            fails.append(f"master {k}")
        if not eq:
            fails.append(f"master {k} copies differ")
    phase("check", what=f"[17.train] masters after step {MESH_TRAIN_STEPS} "
          f"vs unsharded, moves apart by more than {MASTER_MOVE_UNIT} lr "
          "(differing, updated)", flips=json.dumps(flips),
          share_bound=MASTER_FLIP_SHARE,
          within=not any(isinstance(v, str) for v in flips.values()))
    if fails:
        raise AssertionError(f"[17.train]: {fails}")

    # the flash kernel with L at the shape every rank trains it at
    rec = train_flash_checks(dev, dataclasses.replace(
        cfg, n_heads=cfg.n_heads // TP_MESH[1],
        n_kv_heads=cfg.n_kv_heads // TP_MESH[1]), "17", (
        f"[17.train]: the ranks' training forwards and their recomputation "
        f"under remat, summed over its {world} ranks"))
    rec["launches"] = sum(launches)
    phase("17.done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return rec


# --------------------------------------------------------------------- #
# 18. MoE and SSM training on the mesh                                   #
# --------------------------------------------------------------------- #

#: [18.moe.train], [18.ssm.train]: each model at full width, TRAIN_LAYERS
#: of its layers, bf16, remat, "gspmd", seeded from EP_TRAIN_SEED, one
#: step by the TP_MESH ranks on a global batch of MESH_TRAIN_B x TRAIN_S
#: tokens at LEARN_LR without warm-up, against the unsharded port's run
#: on each data row's rows in this process (testing.row_oracle)
EP_TRAIN_MODELS = (("18.moe.train", "qwen3_moe_30b_a3b"),
                   ("18.ssm.train", "falcon_mamba_7b"))
EP_TRAIN_SEED = 18
#: the tensors held against the unsharded run: one of each spec kind (the
#: experts' two, the router's, the Mamba mixer's tp-only ones among them),
#: each as one tensor (the experts of a layer together)
EP_TRAIN_TENSORS = {
    "qwen3_moe_30b_a3b": (
        "layers.0.mixer.wq.w", "layers.1.mixer.wo.w",
        "layers.0.norm1.scale", "layers.1.norm2.scale", "final_norm.scale",
        "layers.0.moe.router.w", "layers.1.moe.router.w",
        "layers.0.moe.gate", "layers.1.moe.up", "layers.1.moe.down",
        "embed.table", "lm_head.w"),
    "falcon_mamba_7b": (
        "layers.0.mixer.in_proj.w", "layers.1.mixer.out_proj.w",
        "layers.0.mixer.x_proj.w", "layers.1.mixer.x_proj.w",
        "layers.0.mixer.dt_proj.w", "layers.1.mixer.dt_proj.w",
        "layers.0.mixer.A_log", "layers.1.mixer.A_log",
        "layers.1.mixer.conv_w", "layers.0.mixer.conv_b",
        "layers.0.mixer.dt_bias", "layers.1.mixer.D",
        "layers.0.norm1.scale", "final_norm.scale", "embed.table",
        "lm_head.w")}
#: of a tensor larger than this many elements, the first rows of each
#: half of dim 0 are held: EP_TRAIN_EXPERTS experts of each model rank's,
#: else MESH_TRAIN_W_ROWS (the embedding's: as mesh_train_rows)
EP_TRAIN_WHOLE, EP_TRAIN_EXPERTS = 1 << 22, 8
#: a step's gradient of an MoE layer's tensor (router, experts, the norm
#: before it), ||g - want|| / ||want||: the ranks' bf16 activations differ
#: from one card's by an ulp, which moves ~1.6 % of the routes ([16.ep]),
#: and a moved route moves its token's whole share of the experts' and the
#: router's gradients.  At moderate width on the CPU in bf16 (d_model
#: 512, 128 experts, top-8, 4 x 256 tokens; PERF.md) these read 4.3-8.6
#: %; the bound is 2^-2, 3x that.  The fault it is there for, a missing
#: sum over tp of the expert path's gradient, is run as a control: the
#: combine weights' f passing on each model rank's own share
#: (testing.combine_weights).  The rest keep [17.train]'s
#: TRAIN_GRAD_BOUND.
EP_GRAD_BOUND = 2.0 ** -2
#: the routers' gradients of the aux term alone (aux_weight 1, every
#: label ignored): the dispatch fractions move with the routes, 4.0-5.6 %
#: on the CPU run above; the bound is 2^-2 (an aux path dropped, the
#: fault it is there for, leaves no gradient: has_gradient False)
AUX_GRAD_BOUND = 2.0 ** -2


def ep_train_rows(tensors, cfg, shapes: dict, batch) -> dict:
    """``{tensor: global rows of dim 0 or None}`` of ``tensors`` (as
    EP_TRAIN_TENSORS names them for an arch): the embedding's as
    :func:`mesh_train_rows` names them, a tensor above EP_TRAIN_WHOLE
    elements the first rows of each half of dim 0 (EP_TRAIN_EXPERTS
    experts, else MESH_TRAIN_W_ROWS), the rest whole."""
    out = {}
    for k in tensors:
        shape = shapes[k]
        if k == "embed.table":
            out[k] = mesh_train_rows(cfg, batch)["embed.table"]
        elif int(np.prod(shape)) <= EP_TRAIN_WHOLE:
            out[k] = None
        else:
            n = EP_TRAIN_EXPERTS if ".moe." in k else MESH_TRAIN_W_ROWS
            half = shape[0] // 2
            out[k] = np.concatenate([np.arange(n), half + np.arange(n)])
    return out


def ep_train_runs(dev):
    """[18.*.unsharded]: each of EP_TRAIN_MODELS drawn from EP_TRAIN_SEED
    in this process and its gradients on the global batch taken by
    ``testing.row_oracle`` (each data row's rows on their own, combined
    as the sharded loss combines them), with an MoE model also its
    gradients of the aux term alone (aux_weight 1, every label ignored);
    the rows of EP_TRAIN_TENSORS, each spec kind's part of the squared
    norm and ``grad_norm`` kept, the model then freed.  Returns the
    ranks' runs (one step each, after gradient passes on the same state:
    the MoE's aux term alone with respect to the routers and its
    routers' control, ``testing.unsum_over_tp`` with
    ``testing.combine_weights``, both without remat; Falcon's ``x_proj``
    control, with ``testing.x_proj_partials``, with remat: without it
    the scan's saved chunks, ~18 GB a rank, put the 4 ranks past the
    card) and what :func:`ep_train_check` holds them to."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.sharding import make_ctx, spec_for
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.models import transformer as T
    from repro_torch.testing import (FlashCounts, block_rows,
                                     combine_weights, row_oracle,
                                     x_proj_partials)

    t_phase = time.perf_counter()
    layout = make_ctx(LmMesh(("data", "model"), TP_MESH, (0, 0), dev,
                             "gloo-staged"))
    runs, oracle = [], {}
    for tag, arch in EP_TRAIN_MODELS:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                             global_batch=MESH_TRAIN_B, seed=EP_TRAIN_SEED)
        batch = pipe.batch_at(0)
        aux_batch = dict(batch, labels=np.full_like(batch["labels"], -100))
        model, init_s, held = build_on_card(lambda: T.init_params(
            torch.Generator(device=dev).manual_seed(EP_TRAIN_SEED), cfg,
            device=dev))
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        rows = ep_train_rows(EP_TRAIN_TENSORS[arch], cfg, shapes, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with FlashCounts() as fc:
            grads, m = row_oracle(model, cfg, batch, TP_MESH[0])
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t0
        want = {k: block_rows(grads[k], (None,) * len(shapes[k]), None,
                              r) for k, r in rows.items()}
        parts = {}
        for k, g in grads.items():
            kind = str(spec_for(k, g.dim(), layout))
            parts[kind] = parts.get(kind, 0.0) + float(
                torch.sum(torch.square(g.double())))
        del grads
        routers = [k for k in shapes if k.endswith("router.w")]
        aux = {}
        if routers:
            ga, am = row_oracle(model, cfg, aux_batch, TP_MESH[0],
                                aux_weight=1.0)
            aux = {k: ga[k].cpu().numpy() for k in routers}
            del ga
        phase(f"{tag}.unsharded", model=cfg.name,
              layers=f"{cfg.n_layers} of {full.n_layers}",
              params=sum(p.numel() for p in model.parameters()),
              state_bytes=held, init_s=f"{init_s:.2f}",
              row_grads_s=f"{grads_s:.3f}", rows=TP_MESH[0],
              loss=f"{m['loss']:.6f}", xent=f"{m['xent']:.6f}",
              aux_loss=f"{m['aux_loss']:.6f}",
              grad_norm=f"{math.sqrt(sum(parts.values())):.6f}",
              flash_launches=fc.launches, plain_calls=fc.plain_calls,
              card_peak_bytes=torch.cuda.max_memory_allocated())
        del model
        free_cuda()
        extra = ({"aux": dict(batch=aux_batch, aux_weight=1.0,
                              only=("router",), cfg_kw=dict(remat=False)),
                  "combine_unsummed": dict(batch=batch, only=("router",),
                                           unsum=combine_weights,
                                           cfg_kw=dict(remat=False))}
                 if routers else
                 {"x_proj_unsummed": dict(batch=batch, only=("x_proj",),
                                          unsum=x_proj_partials)})
        runs.append(dict(name=tag, kind="train", mesh=TP_MESH, mode="gspmd",
                         cfg=cfg, seed=EP_TRAIN_SEED, batches=[batch],
                         opt=dict(lr=LEARN_LR), warmup=0, total_steps=1,
                         impl="pallas", keep=rows, state_keys=(),
                         extra=extra))
        oracle[tag] = dict(cfg=cfg, shapes=shapes, rows=rows, want=want,
                           parts=parts, metrics=m, aux=aux,
                           grad_norm=math.sqrt(sum(parts.values())))
    return runs, dict(oracle=oracle, seconds=time.perf_counter() - t_phase)


def ep_train_check(dev, st: dict, outs: list) -> dict:
    """[18.moe.train] and [18.ssm.train]: the ranks' step (``outs``)
    against :func:`ep_train_runs`'s ``st``.  Checks, for each model: the
    loss (TRAIN_LOSS_BOUND, relative); the step's gradients of
    EP_TRAIN_TENSORS, each as one tensor (EP_GRAD_BOUND for an MoE
    layer's, TRAIN_GRAD_BOUND for the rest; the ranks' copies of a
    replicated block equal; Mamba's ``in_proj`` back in its ``[x | z]``
    layout, ``testing.unhalve``); ``grad_norm`` (the same on every rank,
    TRAIN_LOSS_BOUND) and each spec kind's part of its square by the
    ranks' ``sharding.global_norm`` (NORM_PART_BOUND), with a control
    counting the tp-replicated kinds once a model rank; the state blocks
    against ``launch.specs.train_state_struct``; 2 flash launches a layer
    on every rank (the forward and its recomputation; 0 for Falcon) and
    0 plain calls.  Qwen3-MoE: the routers' gradients of the aux term
    alone (AUX_GRAD_BOUND, a gradient at all), and a control outside
    EP_GRAD_BOUND: the routers' gradients with the combine weights' f
    passing on each model rank's own share (one f an MoE layer).
    Falcon-Mamba: each model rank's unsummed ``x_proj`` gradient (one f
    a layer), a control outside TRAIN_GRAD_BOUND.  Prints each rank's
    step seconds (its gradients and its update), the gradient passes',
    wire seconds, bytes, card peak (the step's; the passes' apart).
    Then [18.flash]: the flash kernel with L at the MoE ranks' training
    shape.  Returns its record."""
    from repro_torch.distributed.sharding import make_ctx, spec_for
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.testing import assemble_rows, unhalve

    t_phase = time.perf_counter() - st["seconds"]
    world = TP_MESH[0] * TP_MESH[1]
    layout = make_ctx(LmMesh(("data", "model"), TP_MESH, (0, 0), dev,
                             "gloo-staged"))
    fails, moe_launches, moe_cfg = [], 0, None
    for tag, arch in EP_TRAIN_MODELS:
        o_ = st["oracle"][tag]
        cfg, shapes, rows = o_["cfg"], o_["shapes"], o_["rows"]
        coords = [o[f"{tag}.coords"] for o in outs]

        def assembled(what, k, rows_k):
            spec = spec_for(k, len(shapes[k]), layout)
            got, eq = assemble_rows([o[f"{tag}.{what}.{k}"] for o in outs],
                                    coords, shapes[k], spec,
                                    ("data", "model"), TP_MESH, rows_k)
            return unhalve(k, got, TP_MESH[1]), eq

        def rel(got, want):
            w = np.asarray(want, np.float64)
            return float(np.linalg.norm(np.asarray(got, np.float64) - w)
                         / np.linalg.norm(w))

        metrics = [o[f"{tag}.metrics"] for o in outs]
        same = all(x == metrics[0] for x in metrics)
        m0, want_m = metrics[0][0], o_["metrics"]
        # the forward's and, under remat, its recomputation's
        want_l = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers)) * (2 if cfg.remat else 1)
        launches = [o[f"{tag}.flash_launches"] for o in outs]
        plain = [o[f"{tag}.plain_calls"] for o in outs]
        bad_struct = [o[f"{tag}.struct_mismatches"] for o in outs]
        extras = (("aux", "combine_unsummed") if o_["aux"]
                  else ("x_proj_unsummed",))
        phase(tag, transport=repr(outs[0]["transport"]),
              mesh="x".join(map(str, TP_MESH)), batch=MESH_TRAIN_B,
              seq=TRAIN_S, model=cfg.name, layers=cfg.n_layers,
              step_s=json.dumps([round(o[f"{tag}.step_s"][0], 3)
                                 for o in outs]),
              grads_update_s=json.dumps([[round(x, 3) for x in o[
                  f"{tag}.step_split_s"]] for o in outs]),
              wire_s=json.dumps([round(o[f"{tag}.step_wire_s"][0], 3)
                                 for o in outs]),
              pass_s=json.dumps({e: [round(o[f"{tag}.{e}.seconds"], 3)
                                     for o in outs] for e in extras}),
              run_s=json.dumps([round(o[f"{tag}.run_s"], 2) for o in outs]),
              loss=f"{m0['loss']:.6f}", aux_loss=f"{m0['aux_loss']:.6f}",
              dropped=f"{m0['dropped']:.6f}",
              grad_norm=f"{m0['grad_norm']:.6f}",
              metrics_equal_on_ranks=same,
              collective_calls=json.dumps([o[f"{tag}.calls"] for o in outs]),
              bytes_in=json.dumps([o[f"{tag}.bytes_in"] for o in outs]),
              bytes_out=json.dumps([o[f"{tag}.bytes_out"] for o in outs]),
              card_peak_bytes=json.dumps([o.get(f"{tag}.card_peak_bytes")
                                          for o in outs]),
              pass_peak_bytes=json.dumps({e: [o.get(
                  f"{tag}.{e}.card_peak_bytes") for o in outs]
                  for e in extras}),
              flash_launches=json.dumps(launches), want=want_l,
              plain_calls=json.dumps(plain),
              state_struct_equal=not any(bad_struct))
        if not same:
            fails.append(f"{tag}: the ranks' metrics differ")
        if launches != [want_l] * world or any(plain):
            fails.append(f"{tag}: flash launches {launches} (want "
                         f"{want_l} a rank), plain calls {plain}")
        if any(bad_struct):
            fails.append(f"{tag}: state blocks unlike train_state_struct: "
                         f"{bad_struct}")
        if want_l:
            moe_launches, moe_cfg = sum(launches), cfg

        dl = abs(m0["loss"] - want_m["loss"]) / abs(want_m["loss"])
        ok = dl <= TRAIN_LOSS_BOUND
        phase("check", what=f"[{tag}] loss vs unsharded on each data row",
              got=f"{m0['loss']:.6f}", want=f"{want_m['loss']:.6f}",
              rel=f"{dl:.3e}", bound=TRAIN_LOSS_BOUND,
              aux_loss=f"{m0['aux_loss']:.6f}",
              want_aux_loss=f"{want_m['aux_loss']:.6f}", within=ok)
        if not ok:
            fails.append(f"{tag}: loss")

        g_rel, equal, bounds = {}, {}, {}
        for k, r in rows.items():
            got, equal[k] = assembled("grad", k, r)
            g_rel[k] = rel(got, o_["want"][k])
            moe_kind = ".moe." in k or "norm2" in k
            bounds[k] = EP_GRAD_BOUND if moe_kind else TRAIN_GRAD_BOUND
        ok = (all(g_rel[k] <= bounds[k] for k in g_rel)
              and all(equal.values()))
        phase("check", what=f"[{tag}] step gradients vs unsharded on each "
              "data row, one tensor of each spec kind",
              rel=json.dumps({k: f"{v:.3e}" for k, v in g_rel.items()}),
              bound_moe_layers=EP_GRAD_BOUND, bound=TRAIN_GRAD_BOUND,
              copies_equal=all(equal.values()), within=ok)
        if not ok:
            fails.append(f"{tag}: gradients")

        specs_ = {str(spec_for(k, len(v), layout)): spec_for(k, len(v),
                                                              layout)
                  for k, v in shapes.items()}
        norms = [o[f"{tag}.kind_norms"] for o in outs]
        parts = {k: v * v for k, v in norms[0].items()}
        twice = {k: v * (1 if layout.tp in specs_[k] else TP_MESH[1])
                 for k, v in parts.items()}
        dn = abs(m0["grad_norm"] - o_["grad_norm"]) / o_["grad_norm"]
        p_rel = {k: abs(parts.get(k, 0.0) - v) / v
                 for k, v in o_["parts"].items()}
        ok = (dn <= TRAIN_LOSS_BOUND
              and max(p_rel.values()) <= NORM_PART_BOUND
              and set(parts) == set(o_["parts"])
              and all(n == norms[0] for n in norms)
              and len({o[f"{tag}.metrics"][0]["grad_norm"]
                       for o in outs}) == 1)
        phase("check", what=f"[{tag}] grad_norm, and each spec kind's part "
              "of its square by the ranks' global_norm, vs unsharded",
              grad_norm=f"{m0['grad_norm']:.6f}",
              want=f"{o_['grad_norm']:.6f}", rel=f"{dn:.3e}",
              bound=TRAIN_LOSS_BOUND, part_rel=worst(p_rel, len(p_rel)),
              part_bound=NORM_PART_BOUND, within=ok)
        if not ok:
            fails.append(f"{tag}: grad_norm")
        t_rel = {k: abs(twice.get(k, 0.0) - v) / v
                 for k, v in o_["parts"].items()}
        rejected = max(t_rel.values()) > NORM_PART_BOUND
        phase("control", what=f"[{tag}] a norm counting each tp-replicated "
              "tensor once a model rank", part_rel=worst(t_rel),
              rejected=rejected)
        if not rejected:
            fails.append(f"{tag}: the norm control")

        if o_["aux"]:
            a_rel = {}
            live = all(o[f"{tag}.aux.requires_grad"] for o in outs)
            for k, w in o_["aux"].items():
                got, equal[k] = assembled("aux.grad", k, None)
                a_rel[k] = rel(got, w)
            ok = live and all(v <= AUX_GRAD_BOUND for v in a_rel.values())
            phase("check", what=f"[{tag}] the routers' gradients of the aux "
                  "term alone (aux_weight 1, labels ignored) vs unsharded",
                  rel=json.dumps({k: f"{v:.3e}" for k, v in a_rel.items()}),
                  bound=AUX_GRAD_BOUND, has_gradient=live,
                  copies_equal=all(equal.values()), within=ok)
            if not ok:
                fails.append(f"{tag}: the aux term's router gradients")
        c_rel, c_eq = {}, {}
        ctl, pick = (("combine_unsummed", ".router.w") if o_["aux"]
                     else ("x_proj_unsummed", ".x_proj.w"))
        ctl_bound = EP_GRAD_BOUND if o_["aux"] else TRAIN_GRAD_BOUND
        for k in rows:
            if k.endswith(pick):
                got, c_eq[k] = assembled(f"{ctl}.grad", k, None)
                c_rel[k] = rel(got, o_["want"][k])
        n_f = [o[f"{tag}.{ctl}.unsummed"] for o in outs]
        want_f = sum((cfg.mlp_kind(i) == "moe") if o_["aux"]
                     else (cfg.layer_kind(i) == "ssm")
                     for i in range(cfg.n_layers))
        rejected = (n_f == [want_f] * world
                    and min(c_rel.values()) > ctl_bound)
        phase("control", what=(
            f"[{tag}] the routers' gradients with the combine weights' f "
            "passing on each model rank's own share (testing."
            "combine_weights)" if o_["aux"] else
            f"[{tag}] each model rank's unsummed x_proj gradient "
            "(testing.x_proj_partials)"),
              rel=json.dumps({k: f"{v:.3e}" for k, v in c_rel.items()}),
              bound=ctl_bound, copies_equal=all(c_eq.values()),
              f_unsummed=json.dumps(n_f), rejected=rejected)
        if not rejected:
            fails.append(f"{tag}: the {ctl} control")
    if fails:
        raise AssertionError(f"[18]: {fails}")

    rec = train_flash_checks(dev, dataclasses.replace(
        moe_cfg, n_heads=moe_cfg.n_heads // TP_MESH[1],
        n_kv_heads=moe_cfg.n_kv_heads // TP_MESH[1]), "18", (
        f"[18.moe.train]: the ranks' training forwards and their "
        f"recomputation under remat, summed over its {world} ranks"))
    rec["launches"] = moe_launches
    phase("18.done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return rec


def mesh_phases(dev) -> list:
    """Phases 15 to 18: their unsharded runs in this process
    (:func:`tp_runs`, :func:`ep_runs`, :func:`mesh_train_runs`,
    :func:`ep_train_runs`), then all their sharded runs in one
    ``launch.mesh.spawn_ranks`` of TP_MESH ranks that share the card over
    staged gloo (the ranks start, and warm up on phase 15's first run,
    once), then each phase's checks (:func:`tp_check`, :func:`ep_check`,
    :func:`mesh_train_check`, :func:`ep_train_check`).  Prints the
    spawn's seconds, each phase's runs' seconds on the ranks and its
    ranks' time to their mesh.  Returns the phases' flash kernel
    records and what [20.dryrun] holds its dry-runs to
    (:func:`dry_ranks`)."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.testing import run_lm_on_mesh
    t0 = time.perf_counter()
    runs15, st15 = tp_runs(dev)
    runs16, st16 = ep_runs(dev)
    runs17, st17 = mesh_train_runs(dev)
    runs18, st18 = ep_train_runs(dev)
    phases = (runs15, runs16, runs17, runs18)
    t_spawn, t1 = time.time(), time.perf_counter()
    outs = spawn_ranks(run_lm_on_mesh, TP_MESH[0] * TP_MESH[1],
                       [r for runs in phases for r in runs], None,
                       timeout=TP_TIMEOUT)
    spawn_s = time.perf_counter() - t1

    def run_s(runs):
        return sum(outs[0][f"{r['name']}.run_s"] for r in runs)

    phase("15.spawn", ranks=len(outs), runs=sum(map(len, phases)),
          seconds=f"{spawn_s:.1f}", spawn_to_ready_s=(
              f"{max(o['ready_at'] for o in outs) - t_spawn:.2f}"),
          **{f"phase{n}_runs_s": f"{run_s(runs):.1f}"
             for n, runs in zip((15, 16, 17, 18), phases)})
    recs = [tp_check(dev, st15, outs), ep_check(dev, st16, outs),
            mesh_train_check(dev, st17, outs),
            ep_train_check(dev, st18, outs)]
    phase("15+16+17+18.done", seconds=f"{time.perf_counter() - t0:.1f}")
    return recs, dry_ranks(outs)


# --------------------------------------------------------------------- #
# 19. KV heads shared across model ranks (tp above n_kv_heads)           #
# --------------------------------------------------------------------- #

#: [19.kvrep]: Qwen3-30B-A3B (32 query heads, 4 KV heads) at full width,
#: EP_LAYERS layers, bf16, seeded from EP_SEED, on KV_MESH = (data, model)
#: ranks that share the card over staged gloo: the model's layout on one
#: 8-GPU node, tp 8 against 4 KV heads, so each KV head is shared by 2
#: model ranks (each rank 4 query heads and a 64-column slice of one KV
#: head's wk and wv); LM_B prompts of LM_P tokens, EP_G greedy decode
#: steps under each tp_collectives ("manual" first, the ranks' warm-up)
KV_ARCH, KV_MESH, KV_TIMEOUT = "qwen3_moe_30b_a3b", (1, 8), 600
#: [19.kvrep.train]: one "gspmd" step on a global batch of KV_TRAIN_B x
#: TRAIN_S tokens (each rank's tokens a [18.moe.train] rank's), at
#: LEARN_LR without warm-up, without remat (2 layers fit; a new spawn's
#: first remat'd step imports torch._dynamo, ~14 s a rank in [18]), held
#: with [18.moe.train]'s bounds on [18.moe.train]'s tensors and each
#: layer's wk and wv
KV_TRAIN_B = 2
KV_TRAIN_TENSORS = EP_TRAIN_TENSORS[KV_ARCH] + tuple(
    f"layers.{i}.mixer.{w}.w" for i in (0, 1) for w in ("wk", "wv"))


def kvrep_runs(dev):
    """[19.kvrep.unsharded]: KV_ARCH at full width, EP_LAYERS layers,
    bf16, drawn from EP_SEED in this process: served unsharded
    (``testing.serve_record``, EP_G decode steps; one data row, so the
    whole batch is the oracle), the fingerprints of each KV_MESH rank's
    blocks, and the gradients of one unsharded step's loss on the global
    training batch (``testing.row_oracle``, one data row) of which the
    rows of KV_TRAIN_TENSORS, the squared norm and the metrics are kept;
    the model then freed.  Returns the ranks' runs (``generate(ctx=)``
    under "manual" and "gspmd", the control: the first attention layer's
    wk and wv blocks of KV group 0's two model ranks swapped, one
    prefill; one training step) and what :func:`kvrep_check` holds them
    to."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.sharding import kv_share
    from repro_torch.models import transformer as T
    from repro_torch.testing import (FlashCounts, block_rows, row_oracle,
                                     serve_record)

    t_phase = time.perf_counter()
    full = configs.get_config(KV_ARCH)
    cfg = dataclasses.replace(full, n_layers=EP_LAYERS, remat=False)
    model, secs, held = build_on_card(lambda: T.init_params(
        torch.Generator(device=dev).manual_seed(EP_SEED), cfg, device=dev))
    prompts = prompts_for(cfg, LM_B, LM_P, dev)
    want = [serve_record(model, cfg, prompts, EP_G + 1)]
    want_fp = rank_fingerprints(model, dev, KV_MESH)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                         global_batch=KV_TRAIN_B, seed=EP_SEED)
    batch = pipe.batch_at(0)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    rows = ep_train_rows(KV_TRAIN_TENSORS, cfg, shapes, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with FlashCounts() as fc:
        grads, m = row_oracle(model, cfg, batch, KV_MESH[0])
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    grad_want = {k: block_rows(grads[k], (None,) * len(shapes[k]), None, r)
                 for k, r in rows.items()}
    grad_norm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                              for g in grads.values()))
    del grads
    phase("19.kvrep.unsharded", model=cfg.name,
          layers=f"{cfg.n_layers} of {full.n_layers}",
          heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
          kv_share=kv_share(cfg.n_kv_heads, KV_MESH[1]),
          params=sum(p.numel() for p in model.parameters()),
          state_bytes=held, init_s=f"{secs:.2f}",
          prefill_ms=f"{want[0]['prefill_s'] * 1e3:.2f}",
          decode_ms_per_step=f"{want[0]['decode_s'] / EP_G * 1e3:.3f}",
          serve_flash_launches=want[0]["flash_launches"],
          serve_plain_calls=want[0]["plain_calls"],
          aux_loss=f"{want[0]['aux_loss']:.4f}",
          dropped=f"{want[0]['dropped']:.4f}",
          train_batch=KV_TRAIN_B, row_grads_s=f"{grads_s:.3f}",
          loss=f"{m['loss']:.6f}", grad_norm=f"{grad_norm:.6f}",
          train_flash_launches=fc.launches, train_plain_calls=fc.plain_calls)
    del model
    free_cuda()
    common = dict(kind="serve", mesh=KV_MESH, cfg=cfg, seed=EP_SEED,
                  weights="19.kvrep", prompts=prompts.cpu().numpy())
    runs = [dict(common, name=f"19.kvrep.{mode}", mode=mode, gen=EP_G + 1)
            for mode in ("manual", "gspmd")]
    runs.append(dict(common, name="19.kvrep.control", mode="manual", gen=1,
                     swap="kv"))
    runs.append(dict(name="19.kvrep.train", kind="train", mesh=KV_MESH,
                     mode="gspmd", cfg=cfg, seed=EP_SEED, batches=[batch],
                     opt=dict(lr=LEARN_LR), warmup=0, total_steps=1,
                     impl="pallas", keep=rows, state_keys=()))
    return runs, dict(cfg=cfg, want=want, want_fp=want_fp, shapes=shapes,
                      rows=rows, grad_want=grad_want, grad_norm=grad_norm,
                      metrics=m, seconds=time.perf_counter() - t_phase)


def kvrep_check(dev, st: dict, outs: list) -> dict:
    """[19.kvrep], [19.kvrep.control], [19.kvrep.train] and [19.flash]:
    the KV_MESH ranks' runs (``outs``) against :func:`kvrep_runs`'s
    ``st``.  Serving: the ranks' blocks (fingerprints); under each mode
    the logits, tokens and routes against the unsharded run
    (:func:`ep_compare`: ROUTE_SHARE_BOUND for the prefill's routes,
    DECODE_ROUTE_SHARE_BOUND for the decode steps', LM_TP_LOGIT_BOUND),
    "manual" against "gspmd", the model ranks routing alike, EP_LAYERS
    flash launches a prefill on every rank and 0 plain calls; the
    control rejected.  Training: the loss and ``grad_norm``
    (TRAIN_LOSS_BOUND, the same on every rank), the gradients of
    KV_TRAIN_TENSORS each as one tensor (EP_GRAD_BOUND for an MoE layer's,
    TRAIN_GRAD_BOUND for the rest, wk and wv among them; a replicated
    block's copies equal), the state blocks against
    ``launch.specs.train_state_struct``, one flash launch a layer on every
    rank and 0 plain calls.  Prints each rank's seconds, collectives and
    card peak; then the flash kernel at the ranks' shape (B=LM_B, Hq/tp
    query heads against one KV head).  Returns its kernel record."""
    from repro_torch.distributed.sharding import kv_share, make_ctx, spec_for
    from repro_torch.launch.mesh import LmMesh
    from repro_torch.testing import assemble_rows

    t_phase = time.perf_counter() - st["seconds"]
    cfg, want = st["cfg"], st["want"]
    B, P, world = LM_B, LM_P, KV_MESH[0] * KV_MESH[1]
    names = ("19.kvrep.manual", "19.kvrep.gspmd", "19.kvrep.control",
             "19.kvrep.train")
    ranks_s = (max(o["ended_at"] for o in outs)
               - min(o["started_at"] for o in outs))
    phase("19.runs", ranks=len(outs), spawn="phase 11's, after phase 12",
          seconds=f"{ranks_s:.1f}", to_lm_mesh_s=(
              f"{max(o['ready_at'] - o['started_at'] for o in outs):.2f}"),
          runs_s=json.dumps({n: round(max(o[f"{n}.run_s"] for o in outs),
                                      2) for n in names}))
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    rows = [slice(0, B)]
    fps = [o["19.kvrep.gspmd.fingerprint"] for o in outs]
    phase("19.kvrep.weights", ranks=world, equal=fps == st["want_fp"],
          fingerprints=json.dumps(fps))
    if fps != st["want_fp"]:
        raise AssertionError(f"[19.kvrep] the ranks' blocks {fps} are not "
                             f"the unsharded weights' {st['want_fp']}")
    got = {}
    for mode in ("manual", "gspmd"):
        name = f"19.kvrep.{mode}"
        fl = [o[f"{name}.flash_launches"] for o in outs]
        plain = [o[f"{name}.plain_calls"] for o in outs]
        digests = [o[f"{name}.route_digests"] for o in outs]
        phase("19.kvrep", run=mode, transport=repr(outs[0]["transport"]),
              mesh="x".join(map(str, KV_MESH)), batch=B, prompt=P,
              decode_steps=EP_G, kv_share=kv_share(cfg.n_kv_heads,
                                                   KV_MESH[1]),
              prefill_ms=json.dumps([round(o[f"{name}.prefill_s"] * 1e3, 2)
                                     for o in outs]),
              decode_ms_per_step=json.dumps(
                  [round(o[f"{name}.decode_s"] / EP_G * 1e3, 2)
                   for o in outs]),
              collective_calls=json.dumps([o[f"{name}.calls"] for o in outs]),
              bytes_in=json.dumps([o[f"{name}.bytes_in"] for o in outs]),
              bytes_out=json.dumps([o[f"{name}.bytes_out"] for o in outs]),
              stage_s=json.dumps([round(o[f"{name}.stage_s"], 3)
                                  for o in outs]),
              wire_s=json.dumps([round(o[f"{name}.wire_s"], 3)
                                 for o in outs]),
              card_peak_bytes=json.dumps([o.get(f"{name}.card_peak_bytes")
                                          for o in outs]),
              aux_loss=json.dumps([round(o[f"{name}.aux_loss"], 4)
                                   for o in outs]),
              dropped=json.dumps([round(o[f"{name}.dropped"], 4)
                                  for o in outs]),
              model_ranks_route_alike=all(d == digests[0] for d in digests),
              flash_launches=json.dumps(fl), want=n_attn,
              plain_calls=json.dumps(plain))
        if fl != [n_attn] * world or any(plain):
            raise AssertionError(f"[19.kvrep] {mode}: flash launches {fl} "
                                 f"(want {n_attn} a rank), plain calls "
                                 f"{plain}")
        if any(d != digests[0] for d in digests):
            raise AssertionError(f"[19.kvrep] {mode}: the model ranks routed "
                                 f"differently: {digests}")
        got[mode] = mesh_records(outs, name, KV_MESH, rows)
        if not ep_compare(f"[19.kvrep] {mode} vs unsharded, prefill and "
                          f"{EP_G} decode steps", cfg, got[mode], want, P):
            raise AssertionError(f"[19.kvrep] {mode}: beyond the bounds "
                                 "against the unsharded run")
        if not all(np.isfinite(r["logits"]).all() for r in got[mode]):
            raise AssertionError(f"[19.kvrep] {mode}: non-finite logits")
    if not ep_compare(f"[19.kvrep] manual vs gspmd, prefill and {EP_G} "
                      "decode steps", cfg, got["manual"], got["gspmd"], P):
        raise AssertionError("[19.kvrep] manual and gspmd disagree")
    bad = mesh_records(outs, "19.kvrep.control", KV_MESH, rows)
    if ep_compare("[19.kvrep.control] layer 0's wk and wv blocks of KV group "
                  "0's two model ranks swapped, prefill vs unsharded", cfg,
                  bad, ep_head(want, 1, n_moe), P, tag="control"):
        raise AssertionError("[19.kvrep] the check cannot tell a KV head "
                             "assembled from swapped slices")
    phase("control", what="[19.kvrep.control] swapped KV slices",
          rejected=True,
          prefill_ms=json.dumps([round(o["19.kvrep.control.prefill_s"] * 1e3,
                                       2) for o in outs]))

    # -- [19.kvrep.train] --------------------------------------------------
    tag, shapes = "19.kvrep.train", st["shapes"]
    layout = make_ctx(LmMesh(("data", "model"), KV_MESH, (0, 0), dev,
                             "gloo-staged"))
    coords = [o[f"{tag}.coords"] for o in outs]
    metrics = [o[f"{tag}.metrics"] for o in outs]
    same = all(x == metrics[0] for x in metrics)
    m0, want_m = metrics[0][0], st["metrics"]
    launches = [o[f"{tag}.flash_launches"] for o in outs]
    plain = [o[f"{tag}.plain_calls"] for o in outs]
    bad_struct = [o[f"{tag}.struct_mismatches"] for o in outs]
    phase(tag, transport=repr(outs[0]["transport"]),
          mesh="x".join(map(str, KV_MESH)), batch=KV_TRAIN_B, seq=TRAIN_S,
          model=cfg.name, layers=cfg.n_layers, remat=cfg.remat,
          step_s=json.dumps([round(o[f"{tag}.step_s"][0], 3) for o in outs]),
          grads_update_s=json.dumps([[round(x, 3) for x in o[
              f"{tag}.step_split_s"]] for o in outs]),
          wire_s=json.dumps([round(o[f"{tag}.step_wire_s"][0], 3)
                             for o in outs]),
          run_s=json.dumps([round(o[f"{tag}.run_s"], 2) for o in outs]),
          loss=f"{m0['loss']:.6f}", aux_loss=f"{m0['aux_loss']:.6f}",
          grad_norm=f"{m0['grad_norm']:.6f}", metrics_equal_on_ranks=same,
          collective_calls=json.dumps([o[f"{tag}.calls"] for o in outs]),
          bytes_in=json.dumps([o[f"{tag}.bytes_in"] for o in outs]),
          bytes_out=json.dumps([o[f"{tag}.bytes_out"] for o in outs]),
          card_peak_bytes=json.dumps([o.get(f"{tag}.card_peak_bytes")
                                      for o in outs]),
          flash_launches=json.dumps(launches), want=n_attn,
          plain_calls=json.dumps(plain),
          state_struct_equal=not any(bad_struct))
    fails = []
    if not same:
        fails.append("the ranks' metrics differ")
    if launches != [n_attn] * world or any(plain):
        fails.append(f"flash launches {launches} (want {n_attn} a rank), "
                     f"plain calls {plain}")
    if any(bad_struct):
        fails.append(f"state blocks unlike train_state_struct: {bad_struct}")
    dl = abs(m0["loss"] - want_m["loss"]) / abs(want_m["loss"])
    dn = abs(m0["grad_norm"] - st["grad_norm"]) / st["grad_norm"]
    ok = dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_LOSS_BOUND
    phase("check", what=f"[{tag}] loss and grad_norm vs unsharded",
          loss=f"{m0['loss']:.6f}", want=f"{want_m['loss']:.6f}",
          rel=f"{dl:.3e}", grad_norm=f"{m0['grad_norm']:.6f}",
          want_grad_norm=f"{st['grad_norm']:.6f}", grad_norm_rel=f"{dn:.3e}",
          bound=TRAIN_LOSS_BOUND, within=ok)
    if not ok:
        fails.append("loss or grad_norm")
    g_rel, equal = {}, {}
    for k, r in st["rows"].items():
        g, equal[k] = assemble_rows(
            [o[f"{tag}.grad.{k}"] for o in outs], coords, shapes[k],
            spec_for(k, len(shapes[k]), layout), ("data", "model"), KV_MESH,
            r)
        w = np.asarray(st["grad_want"][k], np.float64)
        g_rel[k] = float(np.linalg.norm(np.asarray(g, np.float64) - w)
                         / np.linalg.norm(w))
    bounds = {k: EP_GRAD_BOUND if ".moe." in k or "norm2" in k
              else TRAIN_GRAD_BOUND for k in g_rel}
    ok = all(g_rel[k] <= bounds[k] for k in g_rel) and all(equal.values())
    phase("check", what=f"[{tag}] step gradients vs unsharded, one tensor "
          "of each spec kind and each layer's wk and wv",
          rel=json.dumps({k: f"{v:.3e}" for k, v in g_rel.items()}),
          bound_moe_layers=EP_GRAD_BOUND, bound=TRAIN_GRAD_BOUND,
          copies_equal=all(equal.values()), within=ok)
    if not ok:
        fails.append("gradients")
    if fails:
        raise AssertionError(f"[19.kvrep.train]: {fails}")

    # -- [19.flash]: the kernel at the shape every rank's prefill runs ----
    r = kv_share(cfg.n_kv_heads, KV_MESH[1])
    g = torch.Generator(device=dev).manual_seed(19)
    rec = flash_case(dev, g, torch.bfloat16, B // KV_MESH[0],
                     cfg.n_heads // KV_MESH[1],
                     cfg.n_kv_heads * r // KV_MESH[1], P, cfg.head_dim,
                     tag="19.flash")
    rec["launches"] = sum(o["19.kvrep.gspmd.flash_launches"] for o in outs)
    rec["launches_on"] = (f"[19.kvrep] gspmd prefill, summed over its {world} "
                          "ranks")
    phase("19.flash", runs=json.dumps(names),
          flash_launches=json.dumps([[o[f"{n}.flash_launches"]
                                      for n in names] for o in outs]),
          plain_calls=json.dumps([[o[f"{n}.plain_calls"] for n in names]
                                  for o in outs]),
          card_peak_bytes=json.dumps([max(o.get(f"{n}.card_peak_bytes", 0)
                                          for n in names) for o in outs]))
    parent_s = time.perf_counter() - t_phase
    phase("19.done", seconds=f"{parent_s + ranks_s:.1f}",
          parent_s=f"{parent_s:.1f}", ranks_s=f"{ranks_s:.1f}")
    return rec


# --------------------------------------------------------------------- #
# 20. the LM dry-run                                                     #
# --------------------------------------------------------------------- #

#: [20.dryrun]: processes that trace the dry-runs on the host, at the
#: lowest priority, from after phase 1 until phase 13 waits for them (the
#: dry-runs take 385-660 s of one core: they could not fit the phase's
#: 30 s in line; 6 of the host's 8 cores finish them beside phases 2-7,
#: and no later phase runs beside them)
DRY_WORKERS = 6
#: [20.dryrun]: seconds phase 13 waits for them at most
DRY_TIMEOUT = 600
#: [20.dryrun]: the dry-run's temporaries against a rank's card peak over
#: the step less what it held before the step: within this factor either
#: way (the dry-run runs attention's plain route, the card the flash
#: kernel; the rest is the same code)
DRY_TEMP_FACTOR = 2.0
#: [20.dryrun]: the [15.tp] runs held to their dry-runs
DRY_SERVE_RUNS = ("manual", "gspmd")


def dry_init(src: str) -> None:
    """A dry-run process: the lowest priority, one thread, the port on
    the path."""
    os.nice(19)
    sys.path.insert(0, src)
    torch.set_num_threads(1)


def mesh_train_batches(cfg) -> list:
    """[17.train]'s global batches (``TokenPipeline`` from
    MESH_TRAIN_SEED)."""
    from repro_torch.data import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                         global_batch=MESH_TRAIN_B, seed=MESH_TRAIN_SEED)
    return [pipe.batch_at(s) for s in range(MESH_TRAIN_STEPS)]


def dry_jobs() -> list:
    """[20.dryrun]'s dry-runs: (a) every rank of [17.train] (each step on
    its batch's tokens; rank 0's first step again with its first
    collective dropped, the control) and of [15.tp] (a prefill and its
    decode step, under each of DRY_SERVE_RUNS); (b) the 32 cells of the
    port's production mesh (32, 8), and Qwen2.5-32B's on the JAX
    package's (16, 16).  The slowest first (the SSM scans)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import production_axes
    world = TP_MESH[0] * TP_MESH[1]
    jobs = []
    slow = ("falcon_mamba_7b", "jamba_1_5_large_398b")
    cells = [(a, s) for a, s, skip in configs.cells() if not skip]
    cells.sort(key=lambda c: (c[0] not in slow, c[1] not in ("train_4k",
                                                            "prefill_32k")))
    jobs += [dict(what="cell", arch=a, shape=s, mesh=production_axes())
             for a, s in cells]
    jobs += [dict(what="cell", arch="qwen2_5_32b", shape=s,
                  mesh={"data": 16, "model": 16})
             for s in ("train_4k", "prefill_32k", "decode_32k")]
    for r in range(world):
        jobs += [dict(what="train", rank=r, step=i)
                 for i in range(MESH_TRAIN_STEPS)]
        jobs += [dict(what=kind, rank=r, mode=mode)
                 for mode in DRY_SERVE_RUNS for kind in ("prefill", "decode")]
    jobs.append(dict(what="train", rank=0, step=0, drop=0))
    return jobs


def dry_job(job: dict) -> dict:
    """One of :func:`dry_jobs` in a dry-run process: a cell's record
    (``launch.dryrun.run_cell``; a refused cell's text), or a faithfulness
    run's counters, argument bytes and temporaries
    (``launch.dryrun.lower_cell``), with the process's CPU seconds and
    the time it ended."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import COUNTERS
    t0 = time.process_time()
    out = dict(job)
    if job["what"] == "cell":
        try:
            rec = D.run_cell(job["arch"], job["shape"], job["mesh"])
            out.update(memory=rec["memory"], flops=rec["cost"]["flops"],
                       wire=rec["collectives"]["wire_bytes_per_device"],
                       trace_s=rec["trace_s"])
        except D.Refused as e:
            out["refused"] = str(e)
    else:
        axes = {"data": TP_MESH[0], "model": TP_MESH[1]}
        full = configs.get_config("qwen2_5_32b")
        if job["what"] == "train":
            cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS,
                                      tp_collectives="gspmd")
            batch = mesh_train_batches(cfg)[job["step"]]
            tr = D.lower_cell(
                cfg, dict(kind="train", seq_len=TRAIN_S,
                          global_batch=MESH_TRAIN_B), axes, rank=job["rank"],
                opt_overrides=dict(lr=LEARN_LR),
                train_kwargs=dict(total_steps=MESH_TRAIN_STEPS, warmup=0),
                tokens=batch["inputs"], drop=job.get("drop"))
        else:
            cfg = dataclasses.replace(full, n_layers=TP_LAYERS,
                                      tp_collectives=job["mode"])
            # generate's caches hold P + G positions; its first decode
            # step writes position P
            S = LM_P if job["what"] == "prefill" else LM_P + TP_G
            tr = D.lower_cell(cfg, dict(kind=job["what"], seq_len=S,
                                        global_batch=LM_B), axes,
                              rank=job["rank"], pos=LM_P)
        out.update(counters={k: tr.mesh.stats[k] for k in COUNTERS},
                   coords=list(tr.mesh.coords), arguments=tr.arguments,
                   temp=tr.temp_bytes, trace_s=tr.trace_s)
    out.update(cpu_s=time.process_time() - t0, done_at=time.time())
    return out


def dry_start():
    """Start [20.dryrun]'s processes on :func:`dry_jobs`: ``(pool, [(job,
    pending result)], start)``."""
    import multiprocessing as mp
    pool = mp.get_context("spawn").Pool(DRY_WORKERS, initializer=dry_init,
                                        initargs=(str(ROOT / "src"),))
    return pool, [(j, pool.apply_async(dry_job, (j,))) for j in dry_jobs()], \
        time.time()


def dry_wait(dry) -> dict:
    """Wait (at most DRY_TIMEOUT s) for the dry-runs that :func:`dry_start`
    started, then stop their processes: ``{"res": each job's result,
    "waited": the seconds waited, "at": the seconds from their start to
    the wait}``, with a ``[20.wait]`` line."""
    pool, pending, t_start = dry
    at = time.time() - t_start
    t0 = time.perf_counter()
    try:
        res = [r.get(timeout=max(
            1.0, DRY_TIMEOUT - (time.perf_counter() - t0)))
            for _, r in pending]
    finally:
        pool.terminate()
        pool.join()
    waited = time.perf_counter() - t0
    phase("20.wait", waited_s=f"{waited:.1f}", at_s=f"{at:.1f}",
          workers=DRY_WORKERS,
          workers_cpu_s=f"{sum(r['cpu_s'] for r in res):.1f}",
          workers_span_s=f"{max(r['done_at'] for r in res) - t_start:.1f}")
    return dict(res=res, waited=waited, at=at)


def dry_ranks(outs: list) -> list:
    """What [20.dryrun] holds the dry-runs to, from phases 15 and 17's
    ranks: each rank's coordinates, and for [17.train] and each of
    DRY_SERVE_RUNS its steps' counters and card memory and its state's
    bytes."""
    keep = ("train",) + DRY_SERVE_RUNS
    return [{"coords": o["train.coords"],
             **{f"{n}.{k}": o[f"{n}.{k}"] for n in keep
                for k in ("steps", "state_bytes")}} for o in outs]


def dryrun_phase(dry: dict, ranks: list, smi: str) -> None:
    """[20.dryrun]: the dry-runs of :func:`dry_jobs` (:func:`dry_wait`'s
    results) against the ranks of [17.train] and [15.tp]
    (:func:`dry_ranks`).  (a) For every rank and step kind (each train
    step, the prefill, the decode step): the collectives' calls, bytes in
    and bytes out equal; the argument bytes (params, and AdamW's state)
    equal the rank's state; the dry-run's temporaries within
    DRY_TEMP_FACTOR of the rank's card peak over the step less what it
    held before; the control (a collective dropped) rejected.  (b) Each
    production cell's argument and temporary GB a rank, whether they fit
    the card's memory, its TFLOPs and its wire GB, and the refusals."""
    t0 = time.perf_counter()
    by = {}
    for r in dry["res"]:
        by.setdefault(r["what"], []).append(r)

    fails = []

    def held(counters, steps_rec):
        return {k: steps_rec[k] for k in counters}

    lines = []
    for r in by["train"] + by["prefill"] + by["decode"]:
        if r.get("drop") is not None:
            continue
        rank = ranks[r["rank"]]
        if r["what"] == "train":
            run, have = "train", rank["train.steps"][r["step"]]
            state = r["arguments"]["params"] + r["arguments"]["opt"]
        else:
            run = r["mode"]
            have = next(s for s in rank[f"{run}.steps"]
                        if s["kind"] == r["what"])
            state = r["arguments"]["params"]
        real_temp = have["peak"] - have["allocated"]
        ratio = r["temp"] / max(real_temp, 1)
        equal = r["counters"] == held(r["counters"], have) and \
            tuple(r["coords"]) == tuple(rank["coords"])
        same_state = state == rank[f"{run}.state_bytes"]
        within = 1 / DRY_TEMP_FACTOR <= ratio <= DRY_TEMP_FACTOR
        what = f"{run}:{r['what']}" + (f"{r['step']}" if run == "train"
                                       else "")
        lines.append(dict(rank=r["rank"], step=what, **{
            f"dry_{k}": v for k, v in r["counters"].items()},
            **{f"card_{k}": have[k] for k in r["counters"]},
            equal=equal, dry_state_bytes=state,
            card_state_bytes=rank[f"{run}.state_bytes"],
            state_equal=same_state, dry_temp_bytes=r["temp"],
            card_temp_bytes=real_temp, temp_ratio=f"{ratio:.3f}"))
        if not (equal and same_state and within):
            fails.append(what + f" rank {r['rank']}")
    lines.sort(key=lambda x: (x["step"], x["rank"]))
    for line in lines:
        phase("20.dryrun", card=repr(smi), **line)
    ctrl = next(r for r in by["train"] if r.get("drop") is not None)
    have = ranks[0]["train.steps"][0]
    rejected = ctrl["counters"] != held(ctrl["counters"], have)
    phase("control", what="[20.dryrun] train step 0 of rank 0 with its "
          "first collective dropped from the ledger", rejected=rejected,
          dry_calls=ctrl["counters"]["calls"], card_calls=have["calls"])
    if not rejected:
        fails.append("the control was not rejected")

    total = torch.cuda.get_device_properties(0).total_memory
    for r in sorted(by["cell"], key=lambda r: (
            "x".join(map(str, r["mesh"].values())), r["arch"], r["shape"])):
        mesh = "x".join(map(str, r["mesh"].values()))
        if "refused" in r:
            phase("20.refused", arch=r["arch"], shape=r["shape"], mesh=mesh,
                  why=repr(r["refused"]))
            continue
        args = r["memory"]["argument_size_in_bytes"]
        temp = r["memory"]["temp_size_in_bytes"]
        phase("20.cell", arch=r["arch"], shape=r["shape"], mesh=mesh,
              args_gb=f"{args / 1e9:.2f}", temp_gb=f"{temp / 1e9:.2f}",
              fits=args + temp <= total, tflop=f"{r['flops'] / 1e12:.1f}",
              wire_gb=f"{r['wire'] / 1e9:.2f}", trace_s=r["trace_s"])
    cells = [r for r in by["cell"] if "refused" not in r]
    refused = [r for r in by["cell"] if "refused" in r]
    want_refused = {("qwen2_5_32b", s) for s in ("train_4k", "prefill_32k",
                                                 "decode_32k")}
    if len(cells) != 32 or {(r["arch"], r["shape"]) for r in refused} \
            != want_refused or any("item 29" not in r["refused"]
                                   for r in refused):
        fails.append(f"{len(cells)} production cells traced, "
                     f"{len(refused)} refused")
    phase("20.done", seconds=f"{time.perf_counter() - t0:.1f}",
          waited_s=f"{dry['waited']:.1f}", cells=len(cells),
          refused=len(refused), card_total_gb=f"{total / 1e9:.2f}",
          fit=sum(r["memory"]["argument_size_in_bytes"]
                  + r["memory"]["temp_size_in_bytes"] <= total
                  for r in cells))
    if fails:
        raise AssertionError(f"[20.dryrun]: {fails}")


#: [8.*]'s arrival batches: new ratings as a share of the training set,
#: new users and items as a share of m and n, held-out share of a batch
#: (a third batch, a repeat of the second, was cut to keep the smoke near
#: half its time limit once phase 11 came)
ARRIVALS, ARRIVE_SHARE, ARRIVE_TEST = 2, 0.01, 0.05
#: [8.swap]: queries after each round, of which new users
SWAP_QUERIES, SWAP_NEW = 64, 16


def layout_check(ks, ref, eng, lr, lam, what: str) -> str:
    """After a grow or a migrate: the wave kernel on the new layout's
    hottest step (the longest wave chain), cut to its first 256 waves as
    in phase 2, from the live factors, held against ``ref.block_sgd_waves``
    with ``check_close``; the starting factors (no update) are a control
    the check must reject.  Returns the plan of the engine's launches."""
    from repro_torch.core.partition import padded_waves
    br, dev = eng.br, eng.Ws.device
    s = int((br.wave_cnt > 0).sum(-1).max(0).argmax())
    pad = [torch.from_numpy(a).to(dev)
           for a in padded_waves(br, s, slice(0, 256))[:4]]
    held = torch.from_numpy(eng.sched.table[s].astype(np.int64)).to(dev)
    Ws, Hs = eng.Ws, eng.Hs.index_select(0, held)
    Wg, Hg = ks.nomad_sgd_waves_grid(Ws, Hs, *pad, lr, lam)
    plain = [ref.block_sgd_waves(Ws[c], Hs[c], *(a[c] for a in pad), lr,
                                 lam) for c in range(br.p)]
    n_upd = max_row_updates(ks.WaveCSR.from_padded(*pad), br.m_local,
                            br.n_local)
    want_W = torch.stack([w for w, _ in plain])
    for x, got, want in (("W", Wg, want_W),
                         ("H", Hg, torch.stack([h for _, h in plain]))):
        check_close(f"{what} step {s} {x} p={br.p} n_local={br.n_local}",
                    got, want, n_upd)
    bound_ = 16 * EPS_FP32 * max(float(n_upd), 1.0) ** 0.5
    err = rel_err(Ws, want_W)
    phase("control", what=f"{what} no update", max_rel_err=f"{err:.3e}",
          bound=f"{bound_:.3e}", rejected=err > bound_)
    if not err > bound_:
        raise AssertionError(f"{what}: the check cannot tell a launch that "
                             "did nothing from the plain version")
    return ks.launch_plan(eng.Ws, eng.Hs).describe()


def arrival_batches(result, m: int, n: int, nnz: int, k: int):
    """[8.stream]'s arrival batches, drawn from a seeded numpy generator:
    each 1 % new ratings, 1 % new users and items, and a 5 % held-out
    share, valued by phase 3's trained factors (new users and items get
    seeded ones) plus noise, so the stream stays a low-rank problem."""
    rng = np.random.default_rng(8)
    m_new, n_new = round(m * ARRIVE_SHARE), round(n * ARRIVE_SHARE)
    count = round(nnz * ARRIVE_SHARE)
    Wt = np.concatenate([result.W, rng.standard_normal(
        (ARRIVALS * m_new, k)).astype(np.float32) / k ** 0.5])
    Ht = np.concatenate([result.H, rng.standard_normal(
        (ARRIVALS * n_new, k)).astype(np.float32) / k ** 0.5])
    out = []
    for t in range(ARRIVALS):
        hi_m, hi_n = m + (t + 1) * m_new, n + (t + 1) * n_new

        def draw(c):
            r, cc = rng.integers(0, hi_m, c), rng.integers(0, hi_n, c)
            v = (np.einsum("ij,ij->i", Wt[r], Ht[cc])
                 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            return r, cc, v

        rows, cols, vals = draw(count)
        out.append(dict(rows=rows, cols=cols, vals=vals, m_new=m_new,
                        n_new=n_new, test=draw(round(count * ARRIVE_TEST))))
    return out


def stream_phase(api, ks, ref, problem, config, warm, dev):
    """[8.*]: streaming, elasticity and integrity on the card, warm from
    phase 3's result at its full width.  Returns the wave kernel's and
    the top-k kernel's launches on these paths, and the digests phase 12
    is held to (keyed by its ops: ``arrive1``, ``arrive2``, ``fit after
    leave``, ``fit after join``, ``kill5``, ``fit after kill5``,
    ``kill0``, ``faults``)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import topk as ktopk
    from repro_torch.runtime.chaos import bitflip_checkpoint
    from repro_torch.serve import FactorStore, RecServer, ServeConfig

    t_phase = time.perf_counter()
    cfg1 = dataclasses.replace(config, epochs=1)
    lr, lam = float(np.float32(config.make_stepsize()(warm.epochs_done))), \
        config.lam
    batches = arrival_batches(warm, problem.m, problem.n, problem.nnz,
                              config.k)
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_",
                                 dir=ROOT / "build"))
    launches = {"wave": 0, "topk": 0}
    want = {}

    def run(fn, epochs_of):
        """``fn()`` with the wave kernel's count zeroed before and read
        after; it must be one launch per schedule step of every epoch,
        and no other wrapper (``epochs_of(result)`` gives the epochs and
        steps it ran)."""
        ks.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        want = epochs_of(out)
        if ks.nomad_sgd_waves_csr.launches != want \
                or sum(counts.values()) != want:
            raise AssertionError(f"launches {counts}, want {want} on "
                                 "nomad_sgd_waves_csr")
        launches["wave"] += want
        return out, want

    # [8.swap]'s store and server, attached to session A
    store = FactorStore(dev)
    store.publish_result(warm)
    sess = api.StreamingSession(
        problem, cfg1, warm_start=warm, device=dev,
        faults=api.FaultPolicy(checkpoint_dir=str(ckpt), keep=2))
    store.attach(sess)
    srv = RecServer(store, ServeConfig(top_k=10, max_batch=64))
    plain, calls = ktopk.topk_plain, [0]
    qrng = np.random.default_rng(88)

    def counted_plain(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    def swap_check(tag, m_before, version_before):
        """64 queries (16 of them new users) against the round's version:
        every microbatch through the kernel, none through the plain
        version, answers within check_topk of the plain version on the
        round's factors."""
        view = store.view()
        if view.version != version_before + 1:
            raise AssertionError(f"{tag}: version {view.version} after "
                                 f"{version_before}")
        fresh = (qrng.choice(np.arange(m_before, view.m), SWAP_NEW,
                             replace=False) if view.m > m_before
                 else np.zeros(0, np.int64))
        users = np.concatenate([fresh, qrng.choice(
            m_before, SWAP_QUERIES - len(fresh), replace=False)])
        ktopk.reset_launches()
        calls[0] = 0
        b0 = srv.n_batches
        ktopk.topk_plain = counted_plain
        try:
            with ThreadPoolExecutor(max_workers=4) as pool:
                recs = list(pool.map(lambda u: srv.recommend([u]), users))
        finally:
            ktopk.topk_plain = plain
        n_launch = ktopk.topk_scores_cuda.launches
        batches_ = srv.n_batches - b0
        launches["topk"] += n_launch
        if {r.version for r in recs} != {view.version}:
            raise AssertionError(f"{tag}: answers from versions "
                                 f"{sorted({r.version for r in recs})}")
        W_u = view.W.index_select(0, torch.from_numpy(users).to(dev))
        ps, pi = plain(W_u, view.H, k_top=11)
        s = torch.from_numpy(np.concatenate([r.scores for r in recs])).to(dev)
        i = torch.from_numpy(np.concatenate([r.items for r in recs])).to(dev)
        check_topk(f"{tag} served v{view.version}", s, i.to(pi.dtype), ps,
                   pi, view.k)
        phase("8.swap", round=tag, version=view.version, m=view.m, n=view.n,
              queries=len(users), new_users=len(fresh),
              microbatches=batches_, topk_launches=n_launch,
              plain_calls=calls[0])
        if n_launch < batches_ or calls[0] != 0:
            raise AssertionError(f"{tag}: {n_launch} launches for "
                                 f"{batches_} microbatches, {calls[0]} "
                                 "plain calls")

    def epochs_steps(res):
        return int(res.trace_epochs.size) * sess._eng.br.n_steps

    # -- [8.stream]: the arrivals, one epoch each -----------------------
    digests = []
    with srv:
        for t, b in enumerate(batches):
            m_before, v0 = sess.problem.m, store.version
            res, n_l = run(lambda: sess.arrive(**b), epochs_steps)
            eng = sess._eng
            tm = sess.timings
            digests.append(factor_digest(res.W, res.H))
            want[f"arrive{t + 1}"] = digests[-1]
            phase("8.stream", round=t + 1, m=eng.br.m, n=eng.br.n,
                  nnz=sess.problem.nnz, m_local=eng.br.m_local,
                  n_local=eng.br.n_local,
                  repack_delta_s=f"{tm['repack_delta']:.3f}",
                  grow_s=f"{tm['grow']:.3f}", epoch_s=f"{tm['train']:.3f}",
                  checkpoint_s=f"{tm['checkpoint']:.3f}",
                  rmse=f"{float(res.trace_rmse[-1]):.6f}",
                  launches=n_l, digest=digests[-1],
                  plan=ks.launch_plan(eng.Ws, eng.Hs).describe())
            swap_check(f"arrive{t + 1}", m_before, v0)
            layout_check(ks, ref, eng, lr, lam, f"grow {t + 1}")

        # the same chain through partial_fit calls, a session of its own
        chain, pr = warm, problem
        t0 = time.perf_counter()
        for b in batches:
            chain, _ = run(lambda: api.partial_fit(
                chain, pr.extend(**b), cfg1, device=dev),
                lambda r: r.extras["problem"].packed(
                    config.p, waves=True).n_steps)
            pr = chain.extras["problem"]
        chain_digest = factor_digest(chain.W, chain.H)
        phase("8.stream", chain="partial_fit", rounds=len(batches),
              seconds=f"{time.perf_counter() - t0:.2f}",
              digest=chain_digest, session_digest=digests[-1],
              equal=chain_digest == digests[-1])
        if chain_digest != digests[-1]:
            raise AssertionError("the partial_fit chain and the session "
                                 "differ")

        # -- [8.elastic]: a worker leaves, one joins ----------------------
        for what, kw in (("leave", dict(leave=(3,))), ("join",
                                                       dict(join=1))):
            tr = sess.resize(**kw)
            eng = sess._eng
            tm = sess.timings
            plan_ = layout_check(ks, ref, eng, lr, lam, f"migrate {what}")
            m_before, v0 = sess.problem.m, store.version
            res, n_l = run(lambda: sess.fit(), epochs_steps)
            want[f"fit after {what}"] = factor_digest(res.W, res.H)
            phase("8.elastic", op=what, p=f"{tr.p_old}->{tr.p_new}",
                  moved_rows=len(tr.moved_rows),
                  moved_cols=len(tr.moved_cols),
                  repack_transition_s=f"{tm['repack_transition']:.3f}",
                  migrate_s=f"{tm['migrate']:.3f}",
                  epoch_s=f"{tm['train']:.3f}", n_steps=eng.br.n_steps,
                  m_local=eng.br.m_local, n_local=eng.br.n_local,
                  rmse=f"{float(res.trace_rmse[-1]):.6f}", launches=n_l,
                  digest=factor_digest(res.W, res.H), plan=plan_)
            swap_check(f"{what}", m_before, v0)
    sess.unsubscribe(store.publish_result)

    # -- [8.kill]: kill recovery against a graceful twin -----------------
    # the twin: a session warm from the session's result, on its problem
    # (pinned to its partition and schedule, the packing a cache hit) and
    # config, which departs gracefully where the session is killed
    twin = api.StreamingSession(sess.problem, sess.config,
                                warm_start=sess.result, device=dev)
    for worker, flip in ((5, False), (0, True)):
        if flip:
            # one more round each, then the newest checkpoint corrupted
            res = sess.fit()
            want["fit after kill5"] = factor_digest(res.W, res.H)
            twin.fit()
            flipped = bitflip_checkpoint(str(ckpt), seed=8)
        t0 = time.perf_counter()
        sess.kill(worker)
        kill_s = time.perf_counter() - t0
        twin.resize(leave=(worker,))
        got = factor_digest(*sess._eng.factors())
        twin_d = factor_digest(*twin._eng.factors())
        want[f"kill{worker}"] = got
        tm = sess.timings
        quarantined = (flip and (ckpt / f"step_{flipped:08d}.corrupt")
                       .is_dir())
        phase("8.kill", worker=worker, p=sess.config.p,
              bitflipped_newest=flip,
              **({"quarantined_step": flipped, "quarantined": quarantined}
                 if flip else {}),
              checkpoint_save_s=f"{tm['checkpoint']:.3f}",
              restore_s=f"{tm['restore']:.3f}",
              replay_s=f"{tm['replay']:.3f}",
              repack_transition_s=f"{tm['repack_transition']:.3f}",
              migrate_s=f"{tm['migrate']:.3f}", kill_s=f"{kill_s:.3f}",
              digest=got, twin_digest=twin_d, equal=got == twin_d)
        if got != twin_d or (flip and not quarantined):
            raise AssertionError(f"kill({worker}): recovery {got} against "
                                 f"the twin's {twin_d}, quarantined "
                                 f"{quarantined}")
    del twin, sess, chain, pr
    shutil.rmtree(ckpt, ignore_errors=True)

    # -- [8.faults]: crash-resume equals the uninterrupted run -----------
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_faults_",
                                 dir=ROOT / "build"))
    policy = api.FaultPolicy(checkpoint_dir=str(ckpt), checkpoint_every=1)
    n_steps = problem.packed(config.p, waves=True).n_steps
    t0 = time.perf_counter()
    _, n1 = run(lambda: api.solve(problem, dataclasses.replace(
        config, epochs=2), faults=policy, device=dev), lambda r: 2 * n_steps)
    part1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, n2 = run(lambda: api.solve(problem, config, faults=policy,
                                    device=dev),
                  lambda r: (config.epochs - 2) * n_steps)
    part2_s = time.perf_counter() - t0
    got, whole = factor_digest(res.W, res.H), factor_digest(warm.W, warm.H)
    want["faults"] = got
    same_trace = np.array_equal(res.trace_rmse, warm.trace_rmse)
    phase("8.faults", epochs=f"2+{config.epochs - 2}",
          part1_s=f"{part1_s:.3f}", part2_s=f"{part2_s:.3f}",
          launches=n1 + n2, digest=got, uninterrupted_digest=whole,
          equal=got == whole, trace_equal=same_trace)
    if got != whole or not same_trace:
        raise AssertionError("crash-resume differs from the uninterrupted "
                             "run")
    shutil.rmtree(ckpt, ignore_errors=True)
    import resource
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    phase("8.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          wave_launches=launches["wave"], topk_launches=launches["topk"],
          host_peak_rss_gb=f"{rss_gb:.1f}")
    return launches, want


#: [9.netflix]: the paper's Netflix (its Table 2) with its
#: hyperparameters (``configs/nomad_mf.py``), synthetic from seed 0, 10 %
#: held out; epochs of ``solve``
NETFLIX_EPOCHS = 3
#: [9.netflix]'s kernel check: the hottest cell's first waves, up to this
#: many ratings
CHECK_RATINGS = 100_000
#: [9.sim]: the simulator's problem (users, items, ratings, rank), its
#: workers, and the epochs its schedule runs on the card
SIM_M, SIM_N, SIM_NNZ, SIM_K, SIM_P = 2000, 500, 40_000, 16, 8
SIM_EPOCHS = 1
#: the reference tests' tolerance of an engine against the serial replay
REPLAY_RTOL, REPLAY_ATOL = 2e-5, 2e-6
#: bytes of one padded wave slot: row, col, value, mask, global id
SLOT_BYTES = 4 + 4 + 4 + 1 + 8


def count_plain(ks):
    """Count the calls of the wave kernel's plain version (the wrappers'
    CPU path) until the returned ``restore()``; returns ``(calls,
    restore)`` with ``calls[0]`` the count."""
    plain, calls = ks.block_sgd_waves_csr, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    ks.block_sgd_waves_csr = counted

    def restore():
        ks.block_sgd_waves_csr = plain
    return calls, restore


def netflix_phase(api, ks, ref, dev, floor_ns):
    """[9.netflix]: the main path at the paper's full Netflix size —
    ``MCProblem.synthetic(2,649,429, 17,770, 99,072,112, k=100, seed=0)``
    through ``api.solve`` with k=100, p=8, the ring schedule,
    ``kernel="wave_pallas"``, fp32, 3 epochs — with its generation and
    pack seconds, host and card peak memory, the padded wave layout never
    built, the plan (H in global memory), launches (8 per epoch, 0 plain
    calls), a descending RMSE trace; then the engine's pieces, each step's
    time by CUDA events beside its byte bound and its chain bounds (chain
    x ``floor_ns``, ``[4.floor]``'s ns per wave of the H-resident plan,
    and chain x the H-global plan's own floor from ``[9.wave.split]``),
    and the kernel against its plain version on the hottest
    cell's first waves, read through ``partition.padded_waves``, with a
    no-update control.  Returns the kernel record, the problem (its wave
    pack kept for phase 11), ``[9.solve]``'s digest, the H-global plan's
    ns per wave, and what phase 11 reads of this run: the packing, the
    config, ``[9.solve]``'s RMSE trace and ``[9.split]``'s epoch ms."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core.nomad import NomadRingEngine
    from repro_torch.core.partition import padded_waves
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    t_phase = time.perf_counter()
    peak = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = api.MCProblem.synthetic(NETFLIX.m, NETFLIX.n, NETFLIX.nnz,
                                      k=NETFLIX.k, seed=0)
    gen_s = time.perf_counter() - t0
    n_test = len(problem.test[0])
    phase("9.data", m=problem.m, n=problem.n, ratings=problem.nnz + n_test,
          train=problem.nnz, test=n_test, requested=NETFLIX.nnz,
          gen_s=f"{gen_s:.2f}", host_peak_rss_gb=peak.gb())
    k, p = NETFLIX.k, 8
    config = api.NomadConfig(
        k=k, p=p, lam=NETFLIX.lam,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta),
        kernel="wave_pallas", epochs=NETFLIX_EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=config.balanced, waves=True,
                        sub_blocks=1, schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    pack_s = time.perf_counter() - t0
    built = br.__dict__.get("_padded_waves") is not None
    slots = br.p * br.n_steps * br.n_waves * br.wave_width
    plan = ks.plan(br.n_local, k, 4)
    waves_per = (br.wave_cnt > 0).sum(-1)                  # (p, n_steps)
    s_hot = int(waves_per.max(0).argmax())
    q_hot = int(waves_per[:, s_hot].argmax())
    phase("9.pack", pack_s=f"{pack_s:.2f}", p=p, n_steps=br.n_steps,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          n_waves=br.n_waves, wave_width=br.wave_width,
          padded_built=built, padded_slots=slots,
          padded_bytes=slots * SLOT_BYTES, variant=plan.describe(),
          hot_step=s_hot, hot_cell=q_hot,
          hot_step_waves=json.dumps(waves_per[:, s_hot].tolist()),
          hot_step_ratings=json.dumps(br.nnz_cell[:, s_hot].tolist()),
          host_peak_rss_gb=peak.gb())
    if built or plan.resident:
        raise AssertionError(f"padded layout built {built}, plan "
                             f"{plan.describe()} (want H_global)")

    # the main path: launches counted, plain calls counted
    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        t0 = time.perf_counter()
        res = api.solve(problem, config, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    launched = ks.nomad_sgd_waves_csr.launches
    want = NETFLIX_EPOCHS * br.n_steps
    card_peak = torch.cuda.max_memory_allocated()
    rm = [float(x) for x in res.rmse]
    digest = factor_digest(res.W, res.H)
    phase("9.solve", epochs=NETFLIX_EPOCHS, wall_s=f"{solve_s:.2f}",
          rmse=json.dumps(rm), last_finite=res.extras["divergence"]["finite"],
          digest=digest,
          launches=json.dumps(counts), want=want, plain_calls=calls[0],
          card_peak_bytes=card_peak, host_peak_rss_gb=peak.gb())
    if launched != want or sum(counts.values()) != want or calls[0]:
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want} launches")
    if not (len(rm) == NETFLIX_EPOCHS and all(
            b < a for a, b in zip([float("inf")] + rm, rm))):
        raise AssertionError(f"RMSE trace {rm} not strictly descending")
    if not (res.extras["divergence"]["finite"]
            and res.W.shape == (problem.m, k)
            and res.H.shape == (problem.n, k)
            and bool(np.isfinite(res.W).all())
            and bool(np.isfinite(res.H).all())):
        raise AssertionError("non-finite or misshapen factors")

    # where solve's time goes: its engine's pieces, on the trained factors
    eng, engine_ms = timed(lambda: NomadRingEngine(
        br=br, k=k, lam=config.lam, stepsize=config.make_stepsize(),
        policy=config.kernel, device=dev))
    _, init_ms = timed(lambda: eng.init_factors(res.W, res.H))
    live = ks.launch_plan(eng.Ws, eng.Hs)
    variant = live.describe()
    if live.resident:
        raise AssertionError(f"launch plan {variant} keeps H resident")
    eng.epoch_idx = NETFLIX_EPOCHS
    lr = float(np.float32(config.make_stepsize()(NETFLIX_EPOCHS)))
    lam = config.lam

    # the kernel against its plain version: the hottest cell's first
    # waves, from the trained factors (every H block home)
    cum = np.cumsum(br.wave_cnt[q_hot, s_hot])
    w_cut = max(1, int(np.searchsorted(cum, CHECK_RATINGS, side="right")))
    pad = [torch.from_numpy(a).to(dev) for a in padded_waves(
        br, s_hot, slice(0, w_cut), workers=q_hot)[:4]]
    csr = ks.WaveCSR.from_padded(*(a[None] for a in pad))
    csr.check_bounds(br.m_local, br.n_local)
    b_hot = br.block_at(q_hot, s_hot)
    W1 = eng.Ws[q_hot:q_hot + 1].clone()
    H1 = eng.Hs[b_hot:b_hot + 1].clone()
    # where those waves spend their time under the H-global plan, and
    # that plan's own floor (a row fetch, the butterfly, a barrier)
    sp = wave_split(ks, W1, H1, csr, lr, lam, ks.launch_plan(W1, H1),
                    f"full Netflix step {s_hot} cell {q_hot}",
                    tag="9.wave.split")
    global_floor_ns = ((sp["rows_cycles"] + sp["butterfly_cycles"]
                        + sp["barrier_cycles"]) * sp["ns_per_cycle"])
    Wk, Hk = ks.nomad_sgd_waves_csr(W1.clone(), H1.clone(), csr, lr, lam)
    Wt, Ht = W1.clone(), H1.clone()
    k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr, lr, lam), 3)
    (Wp, Hp), p_ms = timed(lambda: ref.block_sgd_waves(
        W1[0].clone(), H1[0].clone(), *pad, lr, lam))
    n_cut = int(pad[3].sum())
    upd = max_row_updates(csr, br.m_local, br.n_local)
    what = (f"full Netflix step {s_hot} cell {q_hot} first {w_cut} waves "
            f"({variant})")
    err = max(check_close(f"W kernel vs plain, {what}", Wk[0], Wp, upd),
              check_close(f"H kernel vs plain, {what}", Hk[0], Hp, upd))
    bound_ = 16 * EPS_FP32 * max(float(upd), 1.0) ** 0.5
    ctrl = rel_err(W1[0], Wp)
    phase("control", what=f"{what} no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell a launch that did "
                             "nothing from the plain version")
    b_ms, b_by = bound(W1, H1, csr)
    del Wk, Hk, Wt, Ht, Wp, Hp

    # one epoch as solve runs it, then one with each step's launch
    # between CUDA events
    _, epoch_ms = timed(lambda: eng.train(1))
    cells, perm = eng._data
    Ws, Hs = eng.Ws, eng.Hs
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(br.n_steps)]
    steps = [cells.cells(s * p, (s + 1) * p) for s in range(br.n_steps)]
    for s, c in enumerate(steps):
        events[s][0].record()
        ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam)
        events[s][1].record()
        Hs = Hs.index_select(0, perm[s])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    for s, c in enumerate(steps):
        sb_ms, sb_by = bound(Ws, Hs, c)
        phase("9.step", step=s, kernel_ms=f"{step_ms[s]:.3f}",
              bound_ms=f"{sb_ms:.4f}", bound_by=sb_by, chain=chain(c),
              chain_bound_ms=f"{chain(c) * floor_ns * 1e-6:.3f}",
              h_global_chain_bound_ms=(
                  f"{chain(c) * global_floor_ns * 1e-6:.3f}"),
              ratings=cell_ratings(c)[1].numel(), variant=variant)
    _, factors_ms = timed(eng.factors)
    epoch_chain = sum(chain(c) for c in steps)
    phase("9.split", engine_ms=f"{engine_ms:.1f}",
          init_factors_ms=f"{init_ms:.1f}", epoch_ms=f"{epoch_ms:.1f}",
          factors_ms=f"{factors_ms:.1f}",
          epoch_kernel_ms=f"{sum(step_ms):.2f}", epoch_chain=epoch_chain,
          epoch_chain_bound_ms=f"{epoch_chain * floor_ns * 1e-6:.2f}",
          updates_per_s=f"{problem.nnz / epoch_ms * 1e3:.4g}",
          solve_s_per_epoch=f"{solve_s / NETFLIX_EPOCHS:.3f}",
          floor_ns_per_wave=f"{floor_ns:.1f}",
          h_global_floor_ns_per_wave=f"{global_floor_ns:.1f}",
          variant=variant)
    card_peak = max(card_peak, torch.cuda.max_memory_allocated())
    peak.close()
    phase("9.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          host_peak_rss_gb=peak.gb(), rss_sampled_every_s=0.02,
          card_peak_bytes=card_peak, padded_built=br.__dict__.get(
              "_padded_waves") is not None)
    record = dict(
        name="nomad_sgd_waves_csr[grid,full_netflix]", route="cuda",
        source=KERNEL_SRC, replaces=REPLACES["grid"], launches=launched,
        launches_on="[9.solve]", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, variant=variant,
        work=f"step {s_hot} cell {q_hot}, first {w_cut} waves, {n_cut} "
        "ratings", step_ms_max=max(step_ms),
        step_chain_bound_ms=max(chain(c) for c in steps) * floor_ns * 1e-6)
    ran = dict(br=br, config=config, rmse=rm, epoch_ms=epoch_ms)
    return record, problem, digest, global_floor_ns, ran


#: [10.dsgd]'s kernel check: the hottest sub-epoch's largest cell's
#: first ratings, each its own wave (the plain version takes ~0.2 ms a
#: rating on the card)
DSGD_CHECK_RATINGS = 50_000
#: [10.*]: CCD++'s epochs (each one solve, warm from the last) and inner
#: sweeps, ALS's epochs, Hogwild's epochs and minibatch (CCD++'s and
#: ALS's second epochs, repeats of the first, were cut to keep the smoke
#: near half its time limit once phase 11 came)
CCD_EPOCHS, CCD_INNER, ALS_EPOCHS, HOG_EPOCHS, HOG_BATCH = 1, 3, 1, 1, 256


def objective_chunked(W, H, rows, cols, vals, lam) -> float:
    """eq. (1) over the ratings, 2**20 at a time on the card (fp32 terms,
    summed in fp64)."""
    tot = 0.0
    for lo in range(0, vals.numel(), 1 << 20):
        hi = lo + (1 << 20)
        wi, hj = W[rows[lo:hi]], H[cols[lo:hi]]
        err = vals[lo:hi] - torch.sum(wi * hj, dim=-1)
        reg = torch.sum(wi * wi, dim=-1) + torch.sum(hj * hj, dim=-1)
        tot += float(torch.sum(err * err + lam * reg, dtype=torch.float64))
    return 0.5 * tot


def dsgd_phase(api, ks, dev, problem, want_digest, floor_ns,
               global_floor_ns):
    """[10.pack], [10.dsgd], [10.step], [10.split]: DSGD at the paper's
    full Netflix on phase 9's problem, through ``api.solve`` with phase
    9's settings.  Fails unless its factors' digest is ``[9.solve]``'s,
    it launched the kernel 8 times an epoch and never its plain version,
    and its trace strictly descends.  Then each sub-epoch's launch by
    CUDA events beside its bounds, and the kernel against its plain
    version on a window of the hottest sub-epoch's largest cell, with a
    no-update control.  Returns the kernel record."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.convert import factors_from_reference
    from repro_torch.core.nomad import wave_csr
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    peak = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    k, p = NETFLIX.k, 8
    config = api.DsgdConfig(
        k=k, p=p, lam=NETFLIX.lam,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta),
        epochs=NETFLIX_EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=True, waves=False)
    pack_s = time.perf_counter() - t0
    s_hot = int(br.nnz_cell.max(0).argmax())
    q_hot = int(br.nnz_cell[:, s_hot].argmax())
    phase("10.pack", pack_s=f"{pack_s:.2f}", p=p, n_steps=br.n_steps,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          waves=br.wave_cnt is not None, hot_step=s_hot, hot_cell=q_hot,
          host_peak_rss_gb=peak.gb())

    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        t0 = time.perf_counter()
        res = api.solve(problem, config, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    launched = ks.nomad_sgd_waves_csr.launches
    want = NETFLIX_EPOCHS * p
    card_peak = torch.cuda.max_memory_allocated()
    rm = [float(x) for x in res.rmse]
    digest = factor_digest(res.W, res.H)
    phase("10.dsgd", epochs=NETFLIX_EPOCHS, wall_s=f"{solve_s:.2f}",
          s_per_epoch=f"{solve_s / NETFLIX_EPOCHS:.3f}", rmse=json.dumps(rm),
          digest=digest, want_digest=want_digest,
          equal=digest == want_digest, launches=json.dumps(counts),
          want=want, plain_calls=calls[0], card_peak_bytes=card_peak,
          host_peak_rss_gb=peak.gb())
    if digest != want_digest:
        raise AssertionError(f"DSGD digest {digest} != [9.solve]'s "
                             f"{want_digest}")
    if launched != want or sum(counts.values()) != want or calls[0]:
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want} launches")
    if not (len(rm) == NETFLIX_EPOCHS and all(
            b < a for a, b in zip([float("inf")] + rm, rm))):
        raise AssertionError(f"RMSE trace {rm} not strictly descending")

    # one more epoch as solve runs it, each sub-epoch between CUDA events
    Ws, Hs = factors_from_reference(res.W, res.H, br, device=dev)
    del res
    cells = wave_csr(br, sequential=True).to(dev)
    steps = [cells.cells(s * p, (s + 1) * p) for s in range(p)]
    lr = float(np.float32(config.make_stepsize()(NETFLIX_EPOCHS)))
    lam = config.lam
    W1 = Ws[q_hot:q_hot + 1].clone()
    H1 = Hs[br.block_at(q_hot, s_hot)].clone()[None]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in steps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (a, b), c in zip(events, steps):
        a.record()
        ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam)
        b.record()
        Hs = torch.roll(Hs, 1, 0)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    step_ms = [a.elapsed_time(b) for a, b in events]
    for s, c in enumerate(steps):
        sb_ms, sb_by = bound(Ws, Hs, c)
        phase("10.step", step=s, kernel_ms=f"{step_ms[s]:.3f}",
              bound_ms=f"{sb_ms:.4f}", bound_by=sb_by, chain=chain(c),
              chain_bound_ms=f"{chain(c) * floor_ns * 1e-6:.3f}",
              h_global_chain_bound_ms=(
                  f"{chain(c) * global_floor_ns * 1e-6:.3f}"),
              ratings=cell_ratings(c)[1].numel(),
              variant=ks.launch_plan(Ws, Hs).describe())
    epoch_chain = sum(chain(c) for c in steps)
    phase("10.split", epoch_ms=f"{epoch_ms:.1f}",
          epoch_kernel_ms=f"{sum(step_ms):.2f}", epoch_chain=epoch_chain,
          epoch_chain_bound_ms=f"{epoch_chain * floor_ns * 1e-6:.2f}",
          h_global_epoch_chain_bound_ms=(
              f"{epoch_chain * global_floor_ns * 1e-6:.2f}"),
          updates_per_s=f"{problem.nnz / epoch_ms * 1e3:.4g}",
          ns_per_update=f"{sum(step_ms) * 1e6 / epoch_chain:.1f}")
    del Ws, Hs

    # the kernel against its plain version: the first ratings of the
    # hottest sub-epoch's largest cell, each its own wave
    hot = steps[s_hot].cells(q_hot, q_hot + 1)
    lo = int(hot.woff[hot.cell_woff[0]])
    n_cut = min(DSGD_CHECK_RATINGS, int(br.nnz_cell[q_hot, s_hot]))
    csr = ks.WaveCSR(
        rows=hot.rows[lo:lo + n_cut].contiguous(),
        cols=hot.cols[lo:lo + n_cut].contiguous(),
        vals=hot.vals[lo:lo + n_cut].contiguous(),
        woff=torch.arange(n_cut + 1, dtype=torch.int32, device=dev),
        cell_woff=torch.tensor([0, n_cut], dtype=torch.int32, device=dev))
    Wk, Hk = ks.nomad_sgd_waves_csr(W1.clone(), H1.clone(), csr, lr, lam)
    Wt, Ht = W1.clone(), H1.clone()
    k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr, lr, lam), 3)
    (Wp, Hp), p_ms = timed(lambda: ks.block_sgd_waves_csr(
        W1.clone(), H1.clone(), csr, lr, lam))
    upd = max_row_updates(csr, br.m_local, br.n_local)
    what = (f"DSGD full Netflix sub-epoch {s_hot} cell {q_hot} first "
            f"{n_cut} ratings (sequential)")
    err = max(check_close(f"W kernel vs plain, {what}", Wk, Wp, upd),
              check_close(f"H kernel vs plain, {what}", Hk, Hp, upd))
    bound_ = 16 * EPS_FP32 * max(float(upd), 1.0) ** 0.5
    ctrl = rel_err(W1, Wp)
    phase("control", what=f"{what} no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell a launch that did "
                             "nothing from the plain version")
    b_ms, b_by = bound(W1, H1, csr)
    peak.close()
    problem._pack_cache.clear()
    return dict(
        name="nomad_sgd_waves_csr[sequential,dsgd,full_netflix]",
        route="cuda", source=KERNEL_SRC, replaces=REPLACES["sequential"],
        launches=launched, launches_on="[10.dsgd]", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, variant=ks.launch_plan(W1, H1).describe(),
        work=f"sub-epoch {s_hot} cell {q_hot}, first {n_cut} ratings",
        step_ms_max=max(step_ms),
        step_chain_bound_ms=max(chain(c) for c in steps) * floor_ns * 1e-6)


def baselines_phase(api, dev, problem, small):
    """[10.ccdpp], [10.als], [10.hogwild] at the paper's full Netflix on
    phase 9's problem (cold starts from seed 0, one solve per epoch, each
    warm from the last, so eq. (1) is read after each), and
    [10.als.resume] on phase 2's problem: seconds per epoch, card and
    host peaks, the RMSE trace against the initial factors', all-finite
    factors.  Fails unless every epoch's RMSE is below the initial one,
    CCD++ and ALS (exact coordinate minimizers of eq. (1)) lower it every
    epoch (1.001 slack, as the JAX package's test), and 1 + 1 ALS epochs
    through ``warm_start`` equal 2 bitwise."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core.nomad import _sharded_rmse_body
    from repro_torch.core.objective import init_factors
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    k, lam = NETFLIX.k, NETFLIX.lam
    W0, H0 = (x.to(dev) for x in init_factors(
        torch.Generator().manual_seed(0), problem.m, problem.n, k))
    tr, tc = (torch.tensor(a, device=dev) for a in problem.test[:2])
    tv = torch.tensor(problem.test[2], dtype=torch.float32, device=dev)
    rmse0 = float(_sharded_rmse_body(W0, H0, tr, tc, tv))
    rows, cols = (torch.tensor(a, device=dev)
                  for a in (problem.rows, problem.cols))
    vals = torch.tensor(problem.vals, dtype=torch.float32, device=dev)
    obj = [objective_chunked(W0, H0, rows, cols, vals, lam)]
    del W0, H0

    def run(tag, cfg, epochs):
        """``epochs`` solves of one epoch each, warm from the last, with
        their seconds, peaks, RMSE and objective."""
        peak = HostPeak()
        torch.cuda.reset_peak_memory_stats()
        res, secs, rm, objs = None, [], [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            res = api.solve(problem, cfg, warm_start=res, device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rm.append(float(res.rmse[-1]))
            if tag in ("ccdpp", "als"):
                objs.append(objective_chunked(
                    torch.from_numpy(res.W).to(dev),
                    torch.from_numpy(res.H).to(dev), rows, cols, vals, lam))
        finite = bool(np.isfinite(res.W).all() and np.isfinite(res.H).all())
        peak.close()
        phase(f"10.{tag}", epochs=epochs,
              s_per_epoch=json.dumps([round(x, 3) for x in secs]),
              rmse_initial=rmse0, rmse=json.dumps(rm),
              **({"objective_initial": f"{obj[0]:.6e}",
                  "objective": json.dumps([f"{o:.6e}" for o in objs])}
                 if objs else {}),
              finite=finite, card_peak_bytes=torch.cuda.max_memory_allocated(),
              host_peak_rss_gb=peak.gb(), config=repr(cfg))
        if not (finite and res.W.shape == (problem.m, k)
                and res.H.shape == (problem.n, k)):
            raise AssertionError(f"{tag}: non-finite or misshapen factors")
        if not all(r < rmse0 for r in rm):
            raise AssertionError(f"{tag}: RMSE {rm} not below the "
                                 f"initial {rmse0}")
        if objs and not all(b <= a * 1.001
                            for a, b in zip(obj + objs, objs)):
            raise AssertionError(f"{tag}: objective {objs} rose from "
                                 f"{obj[0]}")
        return res

    run("ccdpp", api.CcdConfig(k=k, lam=lam, epochs=1, inner=CCD_INNER),
        CCD_EPOCHS)
    run("als", api.AlsConfig(k=k, lam=lam, epochs=1), ALS_EPOCHS)
    run("hogwild", api.HogwildConfig(
        k=k, lam=lam, epochs=1, batch=HOG_BATCH,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta)), HOG_EPOCHS)
    del rows, cols, vals, tr, tc, tv
    torch.cuda.empty_cache()

    # Hogwild's CUDA graphs against its eager loop, one epoch of phase 2's
    # problem from the same factors: the racing sums (float atomics) may
    # differ in the last bits, so within the tolerance tier, and a
    # no-update control
    from repro_torch.core import baselines
    t0 = time.perf_counter()
    args = (small.rows, small.cols, small.vals, small.m, small.n, k)
    W0, H0 = (x.numpy() for x in init_factors(
        torch.Generator().manual_seed(0), small.m, small.n, k))
    kw = dict(lam=0.01, epochs=1, batch=HOG_BATCH, W0=W0, H0=H0,
              schedule=PowerSchedule(0.096, 0.05), device=dev)
    Wg, Hg, _ = baselines.hogwild(*args, **kw)
    graph_s = time.perf_counter() - t0
    per_graph, baselines.HOG_GRAPH = baselines.HOG_GRAPH, 1 << 62
    try:
        t0 = time.perf_counter()
        We, He, _ = baselines.hogwild(*args, **kw)
        eager_s = time.perf_counter() - t0
    finally:
        baselines.HOG_GRAPH = per_graph
    upd = max(np.bincount(small.rows).max(), np.bincount(small.cols).max())
    what = "Hogwild CUDA graphs vs eager, phase 2's problem, 1 epoch"
    for x, got, want in (("W", Wg, We), ("H", Hg, He)):
        check_close(f"{x} {what}", torch.from_numpy(got),
                    torch.from_numpy(want), upd)
    bound_ = 16 * EPS_FP32 * float(upd) ** 0.5
    ctrl = rel_err(torch.from_numpy(W0), torch.from_numpy(We))
    phase("control", what=f"{what}: no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell no update from eager")
    phase("10.hogwild.graph", graph_s=f"{graph_s:.2f}",
          eager_s=f"{eager_s:.2f}", minibatches=small.nnz // HOG_BATCH,
          per_graph=per_graph)

    # ALS resumes bitwise on the card: 1 + 1 epochs == 2
    cfg = api.AlsConfig(k=k, lam=0.01, epochs=1)
    t0 = time.perf_counter()
    whole = api.solve(small, dataclasses.replace(cfg, epochs=2), device=dev)
    half = api.solve(small, cfg, device=dev)
    rest = api.solve(small, cfg, warm_start=half, device=dev)
    equal = (np.array_equal(whole.W, rest.W)
             and np.array_equal(whole.H, rest.H))
    phase("10.als.resume", m=small.m, n=small.n, nnz=small.nnz, k=k,
          digest_2=factor_digest(whole.W, whole.H),
          digest_1_1=factor_digest(rest.W, rest.H), equal=equal,
          rmse=json.dumps([float(x) for x in whole.rmse]),
          seconds=f"{time.perf_counter() - t0:.1f}")
    if not equal:
        raise AssertionError("ALS 1 + 1 epochs != 2 epochs on the card")


def log_order(update_log, stepsize):
    """The simulator's ``update_log`` in execution order (start time, then
    log position), with each update's step size (its rating's count of
    earlier updates)."""
    idx = sorted(range(len(update_log)), key=lambda t: (update_log[t][0], t))
    order = np.array([update_log[t][1] for t in idx], dtype=np.int64)
    seen, lrs = {}, np.empty(len(order))
    for t, g in enumerate(order.tolist()):
        c = seen.get(g, 0)
        lrs[t] = stepsize(c)
        seen[g] = c + 1
    return order, lrs


def sim_phase(api, ks, dev) -> int:
    """[9.sim]: ``solve(AsyncSimConfig(p=8, emit_schedule=True))`` on a
    small problem on the host, its ``update_log`` replayed with
    ``serial.replay_np`` (bitwise its factors), then its schedule through
    ``solve(NomadConfig(schedule=..., kernel="wave_pallas"))`` on the card
    (``n_steps`` launches per epoch, 0 plain calls), held against
    ``serial.replay_torch`` of ``schedule_order()`` on the card within
    the reference tests' tolerance; a replay of a shuffled order is a
    control it must reject.  Returns the wave kernel's launches."""
    from repro_torch.core import serial
    from repro_torch.core.objective import init_factors_np
    from repro_torch.core.stepsize import PowerSchedule

    t_phase = time.perf_counter()
    small = api.MCProblem.synthetic(SIM_M, SIM_N, SIM_NNZ, k=SIM_K, seed=9,
                                    noise=0.1)
    lam, stepsize = 0.05, PowerSchedule(0.05, 0.1)
    t0 = time.perf_counter()
    sim = api.solve(small, api.AsyncSimConfig(
        k=SIM_K, p=SIM_P, lam=lam, stepsize=stepsize,
        epochs=float(SIM_EPOCHS), seed=9, emit_schedule=True), device=dev)
    sim_s = time.perf_counter() - t0
    W0, H0 = init_factors_np(9, small.m, small.n, SIM_K)
    order, lrs = log_order(sim.extras["update_log"], stepsize)
    Wr, Hr = serial.replay_np(W0, H0, small.rows, small.cols, small.vals,
                              order, lrs, lam)
    replay_equal = bool(np.array_equal(Wr, sim.W)
                        and np.array_equal(Hr, sim.H))
    sched = sim.extras["schedule"]
    phase("9.sim", m=small.m, n=small.n, nnz=small.nnz, p=SIM_P,
          sim_s=f"{sim_s:.2f}", updates=sim.extras["n_updates"],
          virtual_time=f"{sim.virtual_time:.6g}",
          throughput=f"{sim.extras['throughput']:.6g}",
          rmse=f"{float(sim.rmse[-1]):.6f}", n_steps=sched.n_steps,
          update_log_replay_bitwise=replay_equal)
    if not replay_equal:
        raise AssertionError("the simulator's update_log does not replay "
                             "to its factors")

    # its schedule through the engine on the card, from seeded factors
    rng = np.random.default_rng(9)
    Wi = rng.uniform(0, SIM_K ** -0.5, (small.m, SIM_K)).astype(np.float32)
    Hi = rng.uniform(0, SIM_K ** -0.5, (small.n, SIM_K)).astype(np.float32)
    warm = api.FitResult(W=Wi, H=Hi, trace_epochs=np.zeros(0),
                         trace_rmse=np.zeros(0), epochs_done=0)
    cfg = api.NomadConfig(k=SIM_K, p=SIM_P, lam=lam, stepsize=stepsize,
                          epochs=SIM_EPOCHS, schedule=sched,
                          kernel="wave_pallas")
    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        res = api.solve(small, cfg, warm_start=warm, device=dev)
        torch.cuda.synchronize()
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    want = SIM_EPOCHS * sched.n_steps
    if (ks.nomad_sgd_waves_csr.launches != want
            or sum(counts.values()) != want or calls[0]):
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want}")
    order = small.packed(SIM_P, waves=True, schedule=sched).schedule_order()

    def replay(o):
        W, H = torch.from_numpy(Wi), torch.from_numpy(Hi)
        for e in range(SIM_EPOCHS):
            W, H = serial.replay_torch(W, H, small.rows, small.cols,
                                       small.vals, o, stepsize(e), lam,
                                       device=dev)
        return W, H

    def within(got, want_):
        return (bool(torch.allclose(got, want_, rtol=REPLAY_RTOL,
                                    atol=REPLAY_ATOL)),
                float((got - want_).abs().max()))

    t0 = time.perf_counter()
    Wr, Hr = replay(order)
    replay_s = time.perf_counter() - t0
    Wg = torch.from_numpy(res.W).to(dev)
    Hg = torch.from_numpy(res.H).to(dev)
    (okW, eW), (okH, eH) = within(Wg, Wr), within(Hg, Hr)
    phase("check", what="[9.sim] engine on the card vs replay_torch of "
          "schedule_order()", within=okW and okH,
          max_abs_err=f"{max(eW, eH):.3e}", rtol=REPLAY_RTOL,
          atol=REPLAY_ATOL, replay_s=f"{replay_s:.2f}")
    if not (okW and okH):
        raise AssertionError("the simulator's schedule on the card is not "
                             "its serial order")
    Wc, Hc = replay(np.random.default_rng(9).permutation(order))
    (cW, eW), (cH, eH) = within(Wg, Wc), within(Hg, Hc)
    phase("control", what="[9.sim] replay of a shuffled order",
          max_abs_err=f"{max(eW, eH):.3e}", rejected=not (cW and cH))
    if cW and cH:
        raise AssertionError("the replay check cannot tell a shuffled "
                             "order from the schedule's")
    phase("9.sim", schedule="on the card", epochs=SIM_EPOCHS,
          launches=json.dumps(counts), want=want, plain_calls=calls[0],
          rmse=json.dumps([float(x) for x in res.rmse]),
          seconds=f"{time.perf_counter() - t_phase:.1f}")
    return want


#: [11.*]: ranks of the SPMD executor (all on the one card), the seconds
#: they may take, [11.api]'s problem (Netflix x SPMD_API_SCALE, built as
#: phases 2-8 build theirs; below the pack's fork threshold, so ranks
#: pack it without forking) and its epochs (the sub_blocks=2 run's too),
#: and the bound of [11.netflix]'s RMSE trace against [9.solve]'s where
#: it is not bitwise
SPMD_P, SPMD_TIMEOUT = 8, 900
SPMD_API_SCALE, SPMD_API_EPOCHS = 0.02, 1
SPMD_TRACE_RTOL = 1e-6


def spmd_phase(api, ks, dev, problem, ran, want_digest, floor_ns, stream,
               lm_runs):
    """[11.netflix], [11.api]: NOMAD's SPMD executor in ``SPMD_P`` ranks
    started by ``launch.mesh.spawn_ranks`` (spawned, one process group, the
    transport ``make_mc_mesh`` picks: staged gloo when the ranks share the
    card).  Phase 9's packing, cold start and held-out ratings are written
    once under ``build/`` and mapped read-only by the ranks.
    ``[11.netflix]``: ``NomadRingEngine(mesh=)`` with phase 9's settings for
    its epochs (fused), each rank's steps logged; the factors' digest must
    be ``[9.solve]``'s, each rank must launch the wave kernel once per step
    and call no plain version, and the RMSE trace must be ``[9.solve]``'s
    (bitwise, or within ``SPMD_TRACE_RTOL``).  ``[11.api]``:
    ``api.solve(mesh=)`` on Netflix x ``SPMD_API_SCALE`` for the ring,
    random and balanced schedules (digests equal to this process's
    one-device ``solve``), the ring under both dispatches, and
    ``sub_blocks=2`` (the sequential route, sub-block by sub-block) held
    to the one-device ``solve`` of the same config.
    Returns the ranks' launches of the per-cell and the sequential route,
    and each rank's results of ``lm_runs`` (phase 19's, which the same
    spawn runs after phase 12's, ``testing.run_mc_then_lm``).
    Chain bounds are waves x ``floor_ns`` (``[4.floor]``): a step's longest
    cell, and its cells one after another (what 8 processes time-slicing one
    card can at best do).  Phase 12's runs (:func:`mesh_stream_runs`, on
    ``stream``) follow in the same spawn, reported by
    :func:`mesh_stream_report`."""
    import shutil

    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core import partition as part
    from repro_torch.core.objective import init_factors
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.testing import HostPeak, run_mc_then_lm

    t_phase = time.perf_counter()
    peak = HostPeak()
    br, config = ran["br"], ran["config"]
    k, p = config.k, SPMD_P

    # phase 9's pack, cold start and held-out ratings, written once
    out = ROOT / "build" / "spmd_netflix"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    part.save_pack(br, str(out / "pack"))
    W0, H0 = init_factors(torch.Generator().manual_seed(int(config.seed)),
                          problem.m, problem.n, k)
    np.save(out / "W0.npy", W0.numpy())
    np.save(out / "H0.npy", H0.numpy())
    del W0, H0
    for name, a in zip(("rows", "cols", "vals"), problem.test):
        np.save(out / f"test_{name}.npy", a)
    write_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    netflix = dict(kind="engine", br=str(out / "pack"), k=k, lam=config.lam,
                   stepsize=config.make_stepsize(), policy=config.kernel,
                   W0=str(out / "W0.npy"), H0=str(out / "H0.npy"),
                   test=str(out / "test"), epochs=NETFLIX_EPOCHS,
                   dispatch=config.dispatch,
                   record_every=config.record_every, log_steps=True,
                   return_factors=False)

    # [11.api]'s problem, and its one-device solves on the card
    m_a = int(NETFLIX.m * SPMD_API_SCALE)
    n_a = int(NETFLIX.n * SPMD_API_SCALE)
    small = api.MCProblem.synthetic(m_a, n_a, 37 * m_a, k=k, seed=0,
                                    noise=0.1, test_frac=0.05, split_seed=1)
    base = api.NomadConfig(k=k, p=p, lam=NETFLIX.lam,
                           stepsize=PowerSchedule(NETFLIX.alpha,
                                                  NETFLIX.beta),
                           kernel="wave_pallas", epochs=SPMD_API_EPOCHS)
    cases = {s: dataclasses.replace(base, schedule=s)
             for s in ("ring", "random", "balanced")}
    cases["ring, loop"] = dataclasses.replace(base, dispatch="loop")
    sub = dataclasses.replace(base, kernel="pallas", sub_blocks=2)
    local = {}
    t0 = time.perf_counter()
    for name, cfg in (("ring", cases["ring"]), ("random", cases["random"]),
                      ("balanced", cases["balanced"]), ("sub", sub)):
        res = api.solve(small, cfg, device=dev)
        local[name] = (factor_digest(res.W, res.H),
                       [float(x) for x in res.rmse])
    local_s = time.perf_counter() - t0
    fresh = api.MCProblem(small.rows, small.cols, small.vals, small.m,
                          small.n, test=small.test)     # no packs pickled
    runs = [netflix]
    runs += [dict(kind="solve", problem=fresh, config=c)
             for c in cases.values()]
    runs += [dict(kind="solve", problem=fresh, config=sub)]
    first12 = len(runs)
    t12 = time.perf_counter()
    runs12, chaos_local = mesh_stream_runs(api, stream, dev)
    runs += runs12
    t12 = time.perf_counter() - t12
    phase("11.write", seconds=f"{write_s:.2f}", bytes=written,
          api_m=small.m, api_n=small.n, api_train=small.nnz,
          api_local_solves_s=f"{local_s:.2f}", host_peak_rss_gb=peak.gb())

    torch.cuda.empty_cache()
    t_spawn = time.time()
    t0 = time.perf_counter()
    outs = spawn_ranks(run_mc_then_lm, p, runs, lm_runs, None,
                       timeout=SPMD_TIMEOUT)
    spawn_s = time.perf_counter() - t0

    # -- [11.netflix] ---------------------------------------------------
    steps_per_epoch = br.n_steps
    want = NETFLIX_EPOCHS * steps_per_epoch
    waves = [o["launches0"]["nomad_sgd_waves_csr"] for o in outs]
    totals = [sum(o["launches0"].values()) for o in outs]
    plain = [o["plain0"] for o in outs]
    digests = sorted({o["digest0"] for o in outs})
    rm = [[x for _, x in o["trace0"]] for o in outs]
    trace_bitwise = all(r == ran["rmse"] for r in rm)
    trace_rel = max(abs(a - b) / abs(b) for r in rm
                    for a, b in zip(r, ran["rmse"]))
    train_s = [o["train_s0"] for o in outs]
    phase("11.netflix", transport=repr(outs[0]["transport"]), ranks=p,
          epochs=NETFLIX_EPOCHS, digest=",".join(digests),
          want_digest=want_digest, equal=digests == [want_digest],
          launches=json.dumps(waves), all_wrappers=json.dumps(totals),
          want=want, plain_calls=json.dumps(plain),
          rmse=json.dumps(rm[0]), want_rmse=json.dumps(ran["rmse"]),
          trace_bitwise=trace_bitwise, trace_max_rel=f"{trace_rel:.3e}",
          finite=all(o["finite0"] for o in outs),
          spawn_to_ready_s=(
              f"{max(o['ready_at'] for o in outs) - t_spawn:.2f}"),
          load_s=f"{max(o['load_s0'] for o in outs):.2f}",
          train_s=f"{max(train_s):.2f}",
          factors_s=f"{max(o['factors_s0'] for o in outs):.2f}")
    if digests != [want_digest]:
        raise AssertionError(f"[11.netflix] digests {digests} != "
                             f"[9.solve]'s {want_digest}")
    if waves != [want] * p or totals != [want] * p or any(plain):
        raise AssertionError(f"[11.netflix] launches {waves}/{totals}, plain "
                             f"calls {plain}, want {want} each")
    if not (trace_bitwise or trace_rel <= SPMD_TRACE_RTOL) or not all(
            o["finite0"] for o in outs):
        raise AssertionError(f"[11.netflix] trace {rm} vs [9.solve]'s "
                             f"{ran['rmse']}, or non-finite factors")
    hop_bytes = br.n_local * k * 4
    last = [o["steps0"][-steps_per_epoch:] for o in outs]
    cell_waves = (br.wave_cnt > 0).sum(-1)                # (p, n_steps)
    for s in range(steps_per_epoch):
        rec = [r[s] for r in last]
        phase("11.step", step=s, epoch=NETFLIX_EPOCHS - 1,
              kernel_ms=json.dumps([round(x["kernel_ms"], 3) for x in rec]),
              stage_ms=json.dumps([round(x["stage_ms"], 3) for x in rec]),
              wire_ms=json.dumps([round(x["wire_ms"], 3) for x in rec]),
              wall_ms=f"{max(x['wall_ms'] for x in rec):.3f}",
              hop_bytes=hop_bytes,
              cells_waves=json.dumps(cell_waves[:, s].tolist()),
              chain_bound_ms=(
                  f"{cell_waves[:, s].max() * floor_ns * 1e-6:.1f}"),
              serial_chain_bound_ms=(
                  f"{cell_waves[:, s].sum() * floor_ns * 1e-6:.1f}"))
    epoch_ms = [sum(x["wall_ms"] for x in r) for r in last]
    kernel_ms = [sum(x["kernel_ms"] for x in r) for r in last]
    phase("11.split", epoch_ms=f"{max(epoch_ms):.1f}",
          s_per_epoch=f"{max(train_s) / NETFLIX_EPOCHS:.3f}",
          one_device_epoch_ms=f"{ran['epoch_ms']:.1f}",
          epoch_chain_bound_ms=(
              f"{cell_waves.max(0).sum() * floor_ns * 1e-6:.1f}"),
          epoch_serial_chain_bound_ms=(
              f"{cell_waves.sum() * floor_ns * 1e-6:.1f}"),
          kernel_ms_per_rank=json.dumps([round(x, 1) for x in kernel_ms]),
          kernel_ms_sum=f"{sum(kernel_ms):.1f}",
          stage_ms_per_rank=json.dumps([round(sum(
              x["stage_ms"] for x in r), 2) for r in last]),
          wire_ms_per_rank=json.dumps([round(sum(
              x["wire_ms"] for x in r), 2) for r in last]),
          card_peak_bytes_per_rank=json.dumps(
              [o["card_peak_bytes"] for o in outs]),
          card_peak_bytes_sum=sum(o["card_peak_bytes"] for o in outs),
          rank_host_peak_rss_gb=json.dumps(
              [round(o["host_peak_rss_gb"], 2) for o in outs]),
          parent_host_peak_rss_gb=peak.gb())

    # -- [11.api] -------------------------------------------------------
    launched = {"per_cell": sum(waves), "sequential": 0}
    for i, name in enumerate(cases, start=1):
        sched = small.packed(p, waves=True, schedule=cases[name].schedule,
                             schedule_seed=base.schedule_seed).schedule
        want_l = [SPMD_API_EPOCHS * int(sched.active[:, q].sum())
                  for q in range(p)]
        got_l = [o[f"launches{i}"]["nomad_sgd_waves_csr"] for o in outs]
        ds = sorted({o[f"digest{i}"] for o in outs})
        want_d, want_rm = local[name.split(",")[0]]
        traces = {tuple(x for _, x in o[f"trace{i}"]) for o in outs}
        phase("11.api", schedule=repr(name), digest=",".join(ds),
              want_digest=want_d, equal=ds == [want_d],
              trace_equal=traces == {tuple(want_rm)},
              launches=json.dumps(got_l), want=json.dumps(want_l),
              plain_calls=json.dumps([o[f"plain{i}"] for o in outs]),
              solve_s=f"{max(o[f'train_s{i}'] for o in outs):.2f}")
        if ds != [want_d] or traces != {tuple(want_rm)}:
            raise AssertionError(f"[11.api] {name}: digests {ds}, want "
                                 f"{want_d}; traces {traces}")
        if got_l != want_l or any(o[f"plain{i}"] for o in outs) or any(
                sum(o[f"launches{i}"].values()) != w
                for o, w in zip(outs, want_l)):
            raise AssertionError(f"[11.api] {name}: launches {got_l}, want "
                                 f"{want_l}, or plain calls")
        launched["per_cell"] += sum(got_l)
    card = len(cases) + 1
    want_l = SPMD_API_EPOCHS * p * sub.sub_blocks    # the ring: p steps
    got_l = [o[f"launches{card}"]["nomad_sgd_waves_csr"] for o in outs]
    ds = sorted({o[f"digest{card}"] for o in outs})
    traces = {tuple(x for _, x in o[f"trace{card}"]) for o in outs}
    phase("11.api", schedule="'ring'", sub_blocks=2, kernel="pallas",
          digest=",".join(ds), want_digest=local["sub"][0],
          equal=ds == [local["sub"][0]],
          trace_equal=traces == {tuple(local["sub"][1])},
          launches=json.dumps(got_l), want=want_l,
          plain_calls=json.dumps([o[f"plain{card}"] for o in outs]),
          solve_s=f"{max(o[f'train_s{card}'] for o in outs):.2f}")
    if ds != [local["sub"][0]] or traces != {tuple(local["sub"][1])}:
        raise AssertionError(f"[11.api] sub_blocks=2: digests {ds}, want "
                             f"{local['sub'][0]}; traces {traces}")
    if got_l != [want_l] * p or any(o[f"plain{card}"] for o in outs):
        raise AssertionError(f"[11.api] sub_blocks=2: launches {got_l}, "
                             f"want {want_l}, or plain calls")
    launched["sequential"] = sum(got_l)
    shutil.rmtree(out, ignore_errors=True)
    peak.close()
    phase("11.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          spawn_s=f"{spawn_s:.1f}", host_peak_rss_gb=peak.gb())
    launched["per_cell"] += mesh_stream_report(outs, first12, stream,
                                               chaos_local, t12)
    return launched, [o["lm"] for o in outs]


#: [12.*]: phase 8's sequence on the mesh, each op with the phase 8
#: digest it is held to (``None``: a resize, held to the factors before
#: it, which it only moves)
MESH_SCRIPT = [("arrive", 0, "arrive1"), ("arrive", 1, "arrive2"),
               ("leave", (3,), None), ("fit", None, "fit after leave"),
               ("join", 1, None), ("fit", None, "fit after join"),
               ("kill", (5,), "kill5"), ("fit", None, "fit after kill5"),
               ("bitflip", 8, None), ("kill", (0,), "kill0")]
#: [12.chaos]: the harness's problem (users, items, ratings; k and p are
#: phase 8's), its seed; its script is a leave, a join, a kill and a NaN
#: in worker 0's shard, one epoch a round
CHAOS_M, CHAOS_N, CHAOS_NNZ, CHAOS_SEED = 4000, 400, 80_000, 5


def mesh_stream_inputs(problem, config, warm, br, want) -> dict:
    """Phase 12's inputs, written once under ``build/spmd_stream`` for the
    ranks to map: phase 2's ratings and held-out ratings, phase 3's
    factors and its packing (with the ratings' ids, which the lead rank's
    re-packs read); the digests of phase 8 the ops are held to."""
    import shutil

    from repro_torch.core import partition as part

    out = ROOT / "build" / "spmd_stream"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    part.save_pack(br, str(out / "pack"), ids=True)
    files = {}
    for name, a in (("rows", problem.rows), ("cols", problem.cols),
                    ("vals", problem.vals), ("W", warm.W), ("H", warm.H),
                    *((f"test_{c}", t) for c, t in zip(
                        ("rows", "cols", "vals"), problem.test))):
        files[name] = str(out / f"{name}.npy")
        np.save(files[name], a)
    write_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    phase("12.write", seconds=f"{write_s:.2f}", bytes=written)
    return dict(
        dir=out, config=config, want=want, n=problem.n, m=problem.m,
        write_s=write_s,
        nnz=problem.nnz, k=config.k, epochs_done=warm.epochs_done,
        trace_epochs=warm.trace_epochs, trace_rmse=warm.trace_rmse,
        problem=dict(rows=files["rows"], cols=files["cols"],
                     vals=files["vals"], m=problem.m, n=problem.n,
                     test=tuple(files[f"test_{c}"]
                                for c in ("rows", "cols", "vals"))),
        pack=str(out / "pack"),
        warm=dict(W=files["W"], H=files["H"], trace_epochs=warm.trace_epochs,
                  trace_rmse=warm.trace_rmse, epochs_done=warm.epochs_done))


def mesh_stream_runs(api, stream, dev):
    """Phase 12's runs for the ranks (``testing.run_script`` kinds): the
    session through :data:`MESH_SCRIPT` with phase 8's arrival batches,
    ``solve(faults=)`` cut after 2 epochs, and the chaos harness on a
    small problem (:data:`CHAOS_M` ...) with phase 8's k, p and step
    sizes; and the harness's one-device run on the card in this process,
    which the ranks' must equal."""
    from repro_torch import testing
    from repro_torch.runtime.chaos import ChaosEvent

    cfg1 = dataclasses.replace(stream["config"], epochs=1)
    warm = api.FitResult(W=np.load(stream["warm"]["W"]),
                         H=np.load(stream["warm"]["H"]),
                         trace_epochs=stream["trace_epochs"],
                         trace_rmse=stream["trace_rmse"],
                         epochs_done=stream["epochs_done"])
    batches = arrival_batches(warm, stream["m"], stream["n"],
                              stream["nnz"], stream["k"])
    del warm
    ckpt = stream["dir"] / "ckpt"
    script = [(op, batches[arg] if op == "arrive" else arg)
              for op, arg, _ in MESH_SCRIPT]
    base = dict(problem=stream["problem"], pack=stream["pack"])
    events = [ChaosEvent(1, "leave", 3), ChaosEvent(2, "join"),
              ChaosEvent(3, "kill", 5), ChaosEvent(4, "nan")]

    chaos_config = dataclasses.replace(cfg1, stepsize=stream["config"]
                                       .stepsize)

    def chaos(where):
        d = stream["dir"] / f"chaos_{where}"
        d.mkdir()
        # a problem of its own for each run: no pack cache is pickled
        problem = api.MCProblem.synthetic(
            CHAOS_M, CHAOS_N, CHAOS_NNZ, k=stream["k"], seed=CHAOS_SEED,
            noise=0.1, test_frac=0.05, split_seed=1)
        return dict(kind="chaos", problem=problem, config=chaos_config,
                    events=events, seed=CHAOS_SEED,
                    faults=api.FaultPolicy(
                        checkpoint_dir=str(d), checkpoint_every=1,
                        divergence=api.DivergencePolicy(max_rollbacks=3)))

    runs = [dict(base, kind="session", config=cfg1, warm=stream["warm"],
                 script=script,
                 faults=api.FaultPolicy(checkpoint_dir=str(ckpt), keep=2)),
            dict(base, kind="faults", config=stream["config"], cut=2,
                 ckpt=str(stream["dir"] / "faults")),
            chaos("mesh")]
    t0 = time.perf_counter()
    with testing.KernelCounts() as counts:
        local = testing.run_script(chaos("card"), counts, device=dev)
    local["seconds"] = time.perf_counter() - t0
    return runs, local


def mesh_stream_report(outs, first: int, stream, chaos_local,
                       setup_s: float) -> int:
    """[12.*] from the ranks' results (runs ``first`` .. ``first + 2`` of
    the spawn): each op's digest against phase 8's, its launches against
    steps x epochs on member ranks and 0 on idle ones, 0 plain calls,
    the slowest rank's seconds for each part of the op; the crash-resume
    against phase 3's run; the harness against its one-device run.
    ``setup_s`` is this process's part before the spawn.  Returns the
    ranks' launches of the per-cell route."""
    import shutil

    p = len(outs)
    want = stream["want"]
    recs = [[o[f"script{first}"]["ops"][j] for o in outs]
            for j in range(len(MESH_SCRIPT))]
    launched = 0
    last = None
    for j, ((op, arg, key), rs) in enumerate(zip(MESH_SCRIPT, recs)):
        digests = sorted({r.get("digest") for r in rs} - {None})
        target = want[key] if key else last
        waves = [r["launches"]["nomad_sgd_waves_csr"] for r in rs]
        totals = [sum(r["launches"].values()) for r in rs]
        plain = [r["plain"] for r in rs]
        before = rs[0]["ranks_before"]
        epochs = rs[0]["rounds"]
        want_l = [epochs * len(before) if q in before else 0
                  for q in range(p)]
        timings = {}
        for r in rs:
            for name, v in r["timings"].items():
                timings[name] = max(timings.get(name, 0.0), v)
        fields = dict(op=op, arg=repr(arg) if op != "arrive" else arg + 1,
                      p=rs[0]["p"],
                      idle=json.dumps([q for q in range(p)
                                       if not rs[q]["member"]]),
                      seconds=f"{max(r['seconds'] for r in rs):.3f}",
                      **{f"{n}_s": f"{v:.3f}" for n, v in timings.items()})
        if op != "bitflip":
            fields.update(digest=",".join(digests), want_digest=target,
                          equal=digests == [target])
        else:
            fields.update(flipped_step=rs[0]["flipped"])
        if op == "kill":
            fields.update(quarantined=json.dumps(rs[0]["corrupt"]))
        fields.update(launches=json.dumps(waves), want=json.dumps(want_l),
                      plain_calls=json.dumps(plain))
        if "trace" in rs[0]:
            fields.update(rmse=f"{rs[0]['trace'][-1]:.6f}")
        phase("12.op", i=j, **fields)
        if op != "bitflip" and digests != [target]:
            raise AssertionError(f"[12.op] {j} {op}: digests {digests}, "
                                 f"want {target}")
        if waves != want_l or totals != want_l or any(plain):
            raise AssertionError(f"[12.op] {j} {op}: launches {waves} / "
                                 f"{totals}, want {want_l}, plain {plain}")
        if op == "kill" and arg == (0,) and rs[0]["corrupt"] != [
                f"step_{recs[j - 1][0]['flipped']:08d}.corrupt"]:
            raise AssertionError("[12.op] the bit-flipped checkpoint was "
                                 "not quarantined")
        if op != "bitflip":
            last = digests[0]
        launched += sum(waves)

    # -- [12.faults]: solve(faults=, mesh=) cut after 2 epochs, resumed ---
    parts = [[o[f"script{first + 1}"]["ops"][j] for o in outs]
             for j in (0, 1)]
    digests = sorted({r["digest"] for r in parts[1]})
    traces = {tuple(r["trace"]) for r in parts[1]}
    waves = [[r["launches"]["nomad_sgd_waves_csr"] for r in rs]
             for rs in parts]
    want_l = [[2 * p] * p, [(EPOCHS - 2) * p] * p]
    plain = [r["plain"] for rs in parts for r in rs]
    phase("12.faults", epochs=f"2+{EPOCHS - 2}", digest=",".join(digests),
          want_digest=want["faults"], equal=digests == [want["faults"]],
          trace_equal=traces == {tuple(float(x)
                                       for x in stream["trace_rmse"])},
          launches=json.dumps(waves), want=json.dumps(want_l),
          plain_calls=json.dumps(plain),
          part1_s=f"{max(r['seconds'] for r in parts[0]):.3f}",
          part2_s=f"{max(r['seconds'] for r in parts[1]):.3f}")
    if digests != [want["faults"]] or len(traces) != 1 or any(plain) \
            or waves != want_l:
        raise AssertionError(f"[12.faults] digests {digests}, traces "
                             f"{traces}, launches {waves}, plain {plain}")
    launched += sum(map(sum, waves))

    # -- [12.chaos]: ChaosHarness(mesh_factory=) against one device ------
    ch = [o[f"script{first + 2}"] for o in outs]
    digests = sorted({c["digest"] for c in ch})
    plain = [c["plain"] for c in ch]
    waves = [c["launches"]["nomad_sgd_waves_csr"] for c in ch]
    phase("12.chaos", actions=json.dumps(ch[0]["actions"]),
          rollbacks=ch[0]["rollbacks"], p_final=ch[0]["p_final"],
          digest=",".join(digests), one_device_digest=chaos_local["digest"],
          equal=digests == [chaos_local["digest"]],
          rmse_equal=all(c["rmse"] == chaos_local["rmse"] for c in ch),
          launches=json.dumps(waves), plain_calls=json.dumps(plain),
          one_device_s=f"{chaos_local['seconds']:.2f}")
    if digests != [chaos_local["digest"]] or any(plain) or not all(
            c["rmse"] == chaos_local["rmse"] for c in ch) \
            or not ch[0]["rollbacks"]:
        raise AssertionError(f"[12.chaos] digests {digests} against "
                             f"{chaos_local['digest']}, plain {plain}")
    launched += sum(waves)
    phase("12.ranks", card_peak_bytes=json.dumps(
              [o[f"card_peak_bytes{first}"] for o in outs]),
          host_peak_rss_gb=json.dumps(
              [round(o[f"host_peak_rss_gb{first}"], 2) for o in outs]))
    shutil.rmtree(stream["dir"], ignore_errors=True)
    ranks_s = (max(o[f"span{first + 2}"][1] for o in outs)
               - min(o[f"span{first}"][0] for o in outs))
    phase("12.done", seconds=f"{stream['write_s'] + setup_s + ranks_s:.1f}",
          write_s=f"{stream['write_s']:.2f}", setup_s=f"{setup_s:.2f}",
          ranks_s=f"{ranks_s:.1f}", wave_launches=launched)
    return launched


def main_path(args, api, ks, ref, dev, dry):
    """Phases 2-8 at Netflix x ``args.scale``, with [20.dryrun]'s
    processes (``dry``, :func:`dry_start`) beside phases 2-7 and waited
    for before phase 13.  Returns the kernel records, phase 2's errors,
    ``[4.floor]``'s ns per wave, phase 2's problem (its packs released),
    phase 12's inputs (:func:`mesh_stream_inputs`), [20.dryrun]'s ranks
    (:func:`dry_ranks`) and the dry-runs (:func:`dry_wait`)."""
    from repro_torch.core.nomad import wave_csr
    from repro_torch.core.partition import padded_waves
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.kernels.policy import KernelPolicy

    # -- 2. data, pack, kernels against their plain versions -------------
    m = max(500, int(2_649_429 * args.scale))
    n = max(200, int(17_770 * args.scale))
    k, p = 100, 8
    t0 = time.perf_counter()
    problem = api.MCProblem.synthetic(m, n, 37 * m, k=100, seed=0,
                                      noise=0.1, test_frac=0.05,
                                      split_seed=1)
    t_data = time.perf_counter() - t0
    config = api.NomadConfig(k=k, p=p, lam=0.01,
                             stepsize=PowerSchedule(0.096, 0.05),
                             kernel="wave_pallas", epochs=EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=config.balanced, waves=True,
                        sub_blocks=1, schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    t_pack = time.perf_counter() - t0
    phase("2.data", m=m, n=n, nnz=problem.nnz, test=len(problem.test[0]),
          data_s=f"{t_data:.2f}", pack_s=f"{t_pack:.2f}", p=p,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          n_waves=br.n_waves, wave_width=br.wave_width, n_steps=br.n_steps)

    gen = torch.Generator().manual_seed(0)
    Ws0 = (torch.rand((p, br.m_local, k), generator=gen) / k ** 0.5).to(dev)
    Hs0 = (torch.rand((p, br.n_local, k), generator=gen) / k ** 0.5).to(dev)
    lr, lam = 0.096, 0.01
    # the step with the longest wave chain, cut to its first cut_w waves
    waves_per = (br.wave_cnt > 0).sum(-1)               # (p, n_steps)
    s_hot = int(waves_per.max(0).argmax())
    cut_w = 256
    pad = [torch.from_numpy(a).to(dev)
           for a in padded_waves(br, s_hot, slice(0, cut_w))[:4]]
    cnt_cut = br.wave_cnt[:, s_hot, :cut_w].sum(-1)     # ratings per cell
    c_hot = int(cnt_cut.argmax())
    flat = [torch.from_numpy(a[c_hot, s_hot, :cnt_cut[c_hot]]).to(dev)
            for a in (br.rows, br.cols, br.vals)]
    n_upd = max_row_updates(ks.WaveCSR.from_padded(*pad), br.m_local,
                            br.n_local)
    errs = {}
    for policy in ("fp32", "bf16"):
        sd = torch.float32 if policy == "fp32" else torch.bfloat16
        cd = None if policy == "fp32" else torch.float32
        acc = policy != "fp32"
        Ws, Hs = Ws0.to(sd), Hs0.to(sd)
        ks.reset_launches()
        Wg, Hg = ks.nomad_sgd_waves_grid(Ws, Hs, *pad, lr, lam,
                                         accum_fp32=acc)
        cells = [ks.nomad_sgd_waves_block(Ws[c], Hs[c], *(a[c] for a in pad),
                                          lr, lam, accum_fp32=acc)
                 for c in range(p)]
        Wb, Hb = ks.nomad_sgd_block(
            Ws[c_hot], Hs[c_hot], *flat,
            torch.ones_like(flat[0], dtype=torch.bool), lr, lam,
            accum_fp32=acc)
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        if min(counts[name] for name in PADDED) < 1:
            raise AssertionError(f"a wrapper did not launch: {counts}")
        check_bitwise(f"grid==per-cell W {policy}", Wg,
                      torch.stack([w for w, _ in cells]))
        check_bitwise(f"grid==per-cell H {policy}", Hg,
                      torch.stack([h for _, h in cells]))
        check_bitwise(f"sequential==waves W {policy}", Wb, cells[c_hot][0])
        check_bitwise(f"sequential==waves H {policy}", Hb, cells[c_hot][1])
        plain = [ref.block_sgd_waves(Ws[c], Hs[c], *(a[c] for a in pad),
                                     lr, lam, compute_dtype=cd)
                 for c in range(p)]
        e = [check_close(f"nomad_sgd_waves_grid {x} {policy}", g,
                         torch.stack([pl[i] for pl in plain]), n_upd, s0)
             for i, (x, g, s0) in enumerate((("W", Wg, Ws), ("H", Hg, Hs)))]
        errs["nomad_sgd_waves_grid", policy] = max(e)
        e = [check_close(f"nomad_sgd_waves_block {x} {policy}",
                         cells[c_hot][i], plain[c_hot][i], n_upd, s0)
             for i, (x, s0) in enumerate((("W", Ws[c_hot]),
                                          ("H", Hs[c_hot])))]
        errs["nomad_sgd_waves_block", policy] = max(e)
        Wr, Hr = ref.block_sgd_ref(
            Ws[c_hot], Hs[c_hot], *flat,
            torch.ones_like(flat[0], dtype=torch.bool), lr, lam,
            compute_dtype=cd)
        e = [check_close(f"nomad_sgd_block {x} {policy}", got, want, n_upd,
                         s0)
             for x, got, want, s0 in (("W", Wb, Wr, Ws[c_hot]),
                                      ("H", Hb, Hr, Hs[c_hot]))]
        errs["nomad_sgd_block", policy] = max(e)
        if policy == "bf16":
            # wrong results the bf16 check must reject: the update
            # accumulated in bf16, and no update at all
            Wa, Ha = ref.block_sgd_waves(
                Ws[c_hot], Hs[c_hot], *(a[c_hot] for a in pad), lr, lam)
            start = torch.cat([Ws[c_hot], Hs[c_hot]])
            check_control("plain accumulating in bf16",
                          torch.cat([Wa, Ha]), torch.cat(plain[c_hot]), start)
            check_control("no update", start, torch.cat(plain[c_hot]), start)
        phase("2.kernels", policy=policy, step=s_hot, waves_cut=cut_w,
              ratings=int(cnt_cut.sum()), launches=json.dumps(counts))

    # -- 3. the main path, then the other routes --------------------------
    n_steps = br.n_steps
    routes = {}
    for route, kernel, epochs, per_step in (
            ("grid", "wave_pallas", EPOCHS, 1),
            ("per_cell", KernelPolicy(impl="wave_pallas", block_rows=-1), 1,
             p),
            ("sequential", "pallas", 1, 1)):
        cfg = api.NomadConfig(k=k, p=p, lam=0.01,
                              stepsize=PowerSchedule(0.096, 0.05),
                              kernel=kernel, epochs=epochs)
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launches()
        t0 = time.perf_counter()
        res = api.solve(problem, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        want = epochs * n_steps * per_step
        launched = ks.nomad_sgd_waves_csr.launches
        if launched != want or sum(counts.values()) != want:
            raise AssertionError(f"{route}: launches {counts}, want {want} "
                                 "on nomad_sgd_waves_csr")
        rm = [float(x) for x in res.rmse]
        if not (len(rm) == epochs and all(b < a for a, b in zip(
                [float("inf")] + rm, rm))):
            raise AssertionError(f"{route}: RMSE trace {rm} not strictly "
                                 "descending")
        finite = res.extras["divergence"]["finite"]
        if not (finite and res.W.shape == (m, k) and res.H.shape == (n, k)
                and bool(np.isfinite(res.W).all())
                and bool(np.isfinite(res.H).all())):
            raise AssertionError(f"{route}: non-finite or misshapen factors")
        routes[route] = dict(launches=launched, wall_s=wall, result=res)
        phase(f"3.{route}", epochs=epochs, wall_s=f"{wall:.3f}",
              rmse=json.dumps(rm), last_finite=finite,
              digest=factor_digest(res.W, res.H),
              max_mem_bytes=torch.cuda.max_memory_allocated(),
              launches=json.dumps(counts), want=want)

    # a small problem on the card against the plain versions on the CPU
    small = api.MCProblem.synthetic(2000, 400, 40_000, k=16, seed=0,
                                    noise=0.1, test_frac=0.1)
    rng = np.random.default_rng(0)
    warm = api.FitResult(
        W=rng.uniform(0, 0.25, (2000, 16)).astype(np.float32),
        H=rng.uniform(0, 0.25, (400, 16)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=0)
    scfg = api.NomadConfig(k=16, p=4, lam=0.05, kernel="wave_pallas",
                           epochs=3)
    on_card = api.solve(small, scfg, warm_start=warm, device=dev)
    on_cpu = api.solve(small, scfg, warm_start=warm, device="cpu")
    n_small = 3 * small.nnz / (2000 + 400)
    for x in "WH":
        check_close(f"small solve {x} card vs cpu", torch.from_numpy(
            getattr(on_card, x)), torch.from_numpy(getattr(on_cpu, x)),
            n_small)
    gap = float(np.max(np.abs(on_card.rmse - on_cpu.rmse) / on_cpu.rmse))
    if not gap <= 1e-5:
        raise AssertionError(f"small solve RMSE traces differ by {gap}")
    phase("3.small", rmse_card=json.dumps(on_card.rmse.tolist()),
          rmse_cpu=json.dumps(on_cpu.rmse.tolist()), rel_gap=f"{gap:.2e}")

    # -- 4. timing on the main path's real step layout --------------------
    csr = wave_csr(br).to(dev)
    steps = [csr.cells(s * p, (s + 1) * p) for s in range(n_steps)]
    chains = [chain(c) for c in steps]
    plan = ks.launch_plan(Ws0, Hs0)
    variant = plan.describe()
    # the step with the longest chain, and its longest cell
    s_t = max(range(n_steps), key=chains.__getitem__)
    step = steps[s_t]
    c_t = int(torch.diff(step.cell_woff.long()).argmax())
    one = step.cells(c_t, c_t + 1)
    W1, H1 = Ws0[c_t:c_t + 1], Hs0[c_t:c_t + 1]
    # where that cell's waves spend their time: with H in global memory
    # beside the ring (the variant for a larger H block), and as the plan
    # lays it out
    h_global = ks.Plan(False, plan.R, plan.copy_bytes,
                       ks.plan_smem(br.n_local, k, 4, False, plan.R))
    if h_global != plan:
        wave_split(ks, W1, H1, one, lr, lam, h_global,
                   f"step {s_t} cell {c_t}")
    split = wave_split(ks, W1, H1, one, lr, lam, plan,
                       f"step {s_t} cell {c_t}")
    # the chain bound: each dependent wave at least a shared-memory row
    # round trip, the butterfly and a barrier, as warp 0 measured them
    floor_ns = (split["rows_cycles"] + split["butterfly_cycles"]
                + split["barrier_cycles"]) * split["ns_per_cycle"]
    phase("4.floor", variant=variant, floor_ns_per_wave=f"{floor_ns:.1f}",
          of="rows + butterfly + barrier of the split above")

    def chain_ms(c) -> float:
        return chain(c) * floor_ns * 1e-6

    Ws, Hs = Ws0.clone(), Hs0.clone()
    step_ms = []
    for s, c in enumerate(steps):
        t = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam), 3)
        step_ms.append(t)
        b_ms, b_by = bound(Ws, Hs, c)
        phase("4.step", step=s, kernel_ms=f"{t:.3f}", bound_ms=f"{b_ms:.4f}",
              bound_by=b_by, chain=chains[s],
              chain_bound_ms=f"{chain_ms(c):.3f}",
              ratings=cell_ratings(c)[1].numel(), variant=variant)

    def timed_pair(csr_t, W0, H0):
        """One launch of ``nomad_sgd_waves_csr`` on ``csr_t`` from
        ``(W0, H0)``: its time (CUDA events), the plain version's time
        (host clock) on the same inputs, the kernel's max abs error
        against it, and the kernel's result."""
        Wt, Ht = W0.clone(), H0.clone()
        k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr_t, lr,
                                                      lam), 3)
        Wk, Hk = ks.nomad_sgd_waves_csr(W0.clone(), H0.clone(), csr_t, lr,
                                        lam)
        n_c, m_t, kk = W0.shape
        n_t = H0.shape[1]
        flat = interleave(csr_t, m_t, n_t)
        (Wp, Hp), p_ms = timed(lambda: ks.block_sgd_waves_csr(
            W0.clone().view(1, n_c * m_t, kk),
            H0.clone().view(1, n_c * n_t, kk), flat, lr, lam))
        upd = max_row_updates(csr_t, m_t, n_t)
        err = max(check_close(f"{x} kernel vs plain", got, want.view_as(got),
                              upd) for x, got, want in (("W", Wk, Wp),
                                                        ("H", Hk, Hp)))
        return k_ms, p_ms, err, (Wk, Hk)

    # each cell of the hottest step alone: does a step cost its slowest
    # cell?
    alone = [cuda_ms(lambda: ks.nomad_sgd_waves_csr(
        Ws[c:c + 1], Hs[c:c + 1], step.cells(c, c + 1), lr, lam), 1)
        for c in range(p)]
    phase("4.cells", step=s_t, alone_ms=json.dumps([round(t, 3)
                                                    for t in alone]),
          chains=json.dumps(torch.diff(step.cell_woff.long()).tolist()),
          chain_bound_ms=json.dumps([round(chain_ms(step.cells(c, c + 1)),
                                           3) for c in range(p)]),
          ratings=json.dumps(torch.bincount(cell_ratings(step)[0],
                                            minlength=p).tolist()),
          variant=variant)

    # where solve's time goes: its engine's pieces, one by one
    from repro_torch.core.nomad import NomadRingEngine
    from repro_torch.core.objective import init_factors
    W0, H0 = (x.numpy() for x in init_factors(
        torch.Generator().manual_seed(config.seed), m, n, k))
    eng, engine_ms = timed(lambda: NomadRingEngine(
        br=br, k=k, lam=config.lam, stepsize=config.make_stepsize(),
        policy=config.kernel, device=dev))
    _, init_ms = timed(lambda: eng.init_factors(W0, H0))
    _, train_ms = timed(lambda: eng.train(EPOCHS, test=problem.test,
                                          dispatch="fused"))
    _, factors_ms = timed(eng.factors)
    phase("4.split", epochs=EPOCHS, engine_ms=f"{engine_ms:.1f}",
          init_factors_ms=f"{init_ms:.1f}", train_ms=f"{train_ms:.1f}",
          factors_ms=f"{factors_ms:.1f}", variant=variant)

    # grid route: the step, one launch for its p cells
    grid_ms, grid_plain_ms, grid_err, _ = timed_pair(step, Ws0, Hs0)
    # per-cell route: that step's longest cell, one launch for the cell
    cell_ms, cell_plain_ms, cell_err, _ = timed_pair(one, W1, H1)
    # sequential route: the same step with every rating its own wave,
    # one launch for its p cells, as the engine builds it
    seq = wave_csr(br, sequential=True).to(dev).cells(s_t * p,
                                                      (s_t + 1) * p)
    seq_ms, seq_plain_ms, seq_err, (Wq, Hq) = timed_pair(seq, Ws0, Hs0)
    # the padded sequential wrapper on one whole cell of it: bitwise the
    # sequential route's result for that cell
    _, r1, c1 = cell_ratings(seq.cells(c_t, c_t + 1))
    lo, hi = (int(seq.woff[seq.cell_woff[c_t + i]]) for i in (0, 1))
    v1 = seq.vals[lo:hi]
    ones = torch.ones_like(r1, dtype=torch.bool)
    ks.reset_launches()
    (Wb, Hb), block_ms = timed(lambda: ks.nomad_sgd_block(
        Ws0[c_t], Hs0[c_t], r1.int(), c1.int(), v1, ones, lr, lam))
    if ks.nomad_sgd_block.launches != 1:
        raise AssertionError("nomad_sgd_block did not launch once")
    check_bitwise("nomad_sgd_block whole cell == sequential route W", Wb,
                  Wq[c_t])
    check_bitwise("nomad_sgd_block whole cell == sequential route H", Hb,
                  Hq[c_t])
    epoch_kernel_ms = sum(step_ms)
    phase("4.timing", step=s_t, chain=chains[s_t],
          step_kernel_ms=f"{grid_ms:.3f}", step_plain_ms=f"{grid_plain_ms:.1f}",
          cell=c_t, cell_chain=chain(one), cell_kernel_ms=f"{cell_ms:.3f}",
          cell_plain_ms=f"{cell_plain_ms:.1f}", seq_chain=chain(seq),
          seq_kernel_ms=f"{seq_ms:.3f}", seq_plain_ms=f"{seq_plain_ms:.1f}",
          block_cell_ratings=r1.numel(), block_host_ms=f"{block_ms:.1f}",
          epoch_kernel_ms=f"{epoch_kernel_ms:.2f}", epoch_chain=sum(chains),
          step_chain_bound_ms=f"{chain_ms(step):.3f}",
          cell_chain_bound_ms=f"{chain_ms(one):.3f}",
          seq_chain_bound_ms=f"{chain_ms(seq):.3f}",
          epoch_chain_bound_ms=f"{sum(map(chain_ms, steps)):.2f}",
          kernel_updates_per_s=f"{problem.nnz / epoch_kernel_ms * 1e3:.4g}",
          solve_s_per_epoch=f"{routes['grid']['wall_s'] / EPOCHS:.3f}",
          variant=variant)

    # a persistent kernel that passes H blocks between cells as they
    # finish (ROADMAP R2b) against the step loop, at the hottest cell's
    # measured cost per wave
    step_waves, path_waves = dependency_path(br, csr)
    us_wave = alone[c_t] * 1e3 / chain(one)
    phase("4.r2b", step_max_sum_waves=step_waves,
          longest_path_waves=path_waves,
          us_per_wave=f"{us_wave:.4f}",
          step_loop_ms=f"{step_waves * us_wave * 1e-3:.2f}",
          longest_path_ms=f"{path_waves * us_wave * 1e-3:.2f}",
          variant=variant)

    kernels = []
    for route, k_ms, p_ms, err, (b_ms, b_by) in (
            ("grid", grid_ms, grid_plain_ms, grid_err,
             bound(Ws0, Hs0, step)),
            ("per_cell", cell_ms, cell_plain_ms, cell_err,
             bound(W1, H1, one)),
            ("sequential", seq_ms, seq_plain_ms, seq_err,
             bound(Ws0, Hs0, seq))):
        kernels.append(dict(
            name=f"nomad_sgd_waves_csr[{route}]", route="cuda",
            source=KERNEL_SRC, replaces=REPLACES[route],
            launches=routes[route]["launches"], max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            variant=variant))
    record, serve_launches = serve_phase(routes["grid"]["result"], problem,
                                         dev)
    kernels.append(record)
    kernels.extend(topk_phase(dev, serve_launches))
    torch.cuda.empty_cache()
    flash_launches = lm_phase(dev)
    torch.cuda.empty_cache()
    kernels.extend(flash_kernel_checks(dev, flash_launches))
    # -- 20. the dry-runs' processes end here: none beside phases 13-19 --
    dry_out = dry_wait(dry)
    torch.cuda.empty_cache()
    kernels.append(train_phase(dev))
    torch.cuda.empty_cache()
    kernels.extend(lm_families_phase(dev))
    free_cuda()
    recs, ranks = mesh_phases(dev)
    kernels.extend(recs)
    stream, digests = stream_phase(api, ks, ref, problem, config,
                                   routes["grid"]["result"], dev)
    for rec in kernels:
        if rec["name"] == "nomad_sgd_waves_csr[grid]":
            rec["launches"] += stream["wave"]
            rec["launches_on"] = "[3.grid] and [8.*]"
        elif rec["name"].startswith("topk_scores_cuda"):
            rec["launches"] += stream["topk"]
            rec["launches_on"] = "[5.serve] and [8.swap]"
    stream_in = mesh_stream_inputs(problem, config, routes["grid"]["result"],
                                   br, digests)
    problem._pack_cache.clear()
    return kernels, errs, floor_ns, problem, stream_in, ranks, dry_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="Netflix scale of phases 2-8's problem")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global PEAK_BW, PEAK_FP32, PEAK_TC16
    from repro_torch import api
    from repro_torch.kernels import _build, nomad_sgd as ks, ref
    from repro_torch.launch.mesh import (HBM_BW as PEAK_BW,
                                         PEAK_FLOPS_BF16 as PEAK_TC16,
                                         PEAK_FLOPS_FP32 as PEAK_FP32)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 0. device ------------------------------------------------------
    smi = nvidia_smi()
    nvcc_ver = subprocess.run([_build.nvcc_path(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    phase("0.device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(nvcc_ver))

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load("nomad_sgd")
    phase("1.build", seconds=f"{time.perf_counter() - t0:.2f}",
          libraries=",".join(x.name for x in _build.library_paths()),
          max_k=lib.nomad_sgd_max_k(),
          flash_max_d=_build.load("flash_attn").flash_attention_max_d())
    # the wave kernel's plan and its C layout agree
    for n_t, kk, elem in ((228, 100, 4), (228, 100, 2), (2222, 100, 4),
                          (228, ks.MAX_K, 4), (1, 1, 2)):
        pl = ks.plan(n_t, kk, elem)
        c_smem = lib.nomad_sgd_smem(n_t, kk, elem, int(pl.resident), pl.R)
        if c_smem != pl.smem or lib.nomad_sgd_max_k() != ks.MAX_K:
            raise AssertionError(f"plan {pl} for ({n_t}, {kk}, {elem}): C "
                                 f"layout {c_smem} bytes")
    phase("1.plan", shapes=5, main=ks.plan(228, 100, 4).describe(),
          full_netflix=ks.plan(2222, 100, 4).describe())

    # -- 20. the dry-runs' processes: from here to phase 13, on the host --
    dry = dry_start()
    try:
        kernels, errs, floor_ns, small, stream_in, ranks, dry_out = \
            main_path(args, api, ks, ref, dev, dry)
        # -- 9. full Netflix on the main path; the simulator's schedule --
        torch.cuda.empty_cache()
        record, netflix, digest, global_floor_ns, ran = netflix_phase(
            api, ks, ref, dev, floor_ns)
        kernels.append(record)
        sim_launches = sim_phase(api, ks, dev)
        # -- 11, 12. the SPMD executor in ranks on the card: phase 9's
        # pack; phase 8's streaming, elastic and fault-tolerant sequence --
        # -- 19. KV heads shared over tp: its unsharded runs here, its
        # ranks' runs in phase 11's spawn after phase 12's ---------------
        torch.cuda.empty_cache()
        runs19, st19 = kvrep_runs(dev)
        free_cuda()
        spmd_launches, outs19 = spmd_phase(api, ks, dev, netflix, ran,
                                           digest, floor_ns, stream_in,
                                           runs19)
        del ran
        netflix._pack_cache.clear()
        kernels.append(kvrep_check(dev, st19, outs19))
        # -- 10. the paper's baselines at full Netflix -------------------
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kernels.append(dsgd_phase(api, ks, dev, netflix, digest, floor_ns,
                                  global_floor_ns))
        torch.cuda.empty_cache()
        baselines_phase(api, dev, netflix, small)
        del netflix, small
        phase("10.done", seconds=f"{time.perf_counter() - t0:.1f}")
        for rec in kernels:
            if rec["name"] == "nomad_sgd_waves_csr[grid]":
                rec["launches"] += sim_launches
                rec["launches_on"] = "[3.grid], [8.*] and [9.sim]"
            elif rec["name"] == "nomad_sgd_waves_csr[per_cell]":
                rec["launches"] += spmd_launches["per_cell"]
                rec["launches_on"] = ("[3.per_cell], and [11.netflix], "
                                      "[11.api] and [12.*] summed over their "
                                      "ranks")
            elif rec["name"] == "nomad_sgd_waves_csr[sequential]":
                rec["launches"] += spmd_launches["sequential"]
                rec["launches_on"] = ("[3.sequential], and [11.api]'s "
                                      "sub_blocks=2 summed over its ranks")
        # -- 20. the LM dry-run against phases 15 and 17's ranks; the
        # production table ----------------------------------------------
        dryrun_phase(dry_out, ranks, smi)
    finally:
        dry[0].terminate()
        dry[0].join()
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}",
          errors=json.dumps({f"{a}/{b}": f"{v:.3e}"
                             for (a, b), v in errs.items()}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
