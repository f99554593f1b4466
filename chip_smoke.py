#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``p2pfl_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own printed lines:

1. env: the card (``nvidia-smi``), torch / CUDA / nvcc versions, and the
   kernels' build from ``p2pfl_tpu_torch/csrc`` (time and ptxas report:
   registers and spills of each kernel; the tensor-core forward and
   backward pair (D = 64, the wide ones at D = 128 and 256, the grouped
   ones at every D above 256, the narrow forward's six instances and the
   narrow backward pair's six below 64) and the tensor-core carry kernels
   (the narrow carry's three instances below 64; D 64; the grouped one
   above 64) must not spill, no CUDA-core
   kernel has a bf16 instance, and every chunked kernel (rows 1-5 above
   D = 512, f32 only) is built). The count of ``HGMMA`` (wgmma) instructions in
   each tensor-core kernel from ``cuobjdump -sass`` (each must have some)
   runs last, after phase 23: on the card, torch.profiler sessions run in
   this process after that count recorded none of the library's kernels
   (why is not known), and ``--profile``'s breakdowns read them.
2. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the main paths' shapes (bf16 [8, 1024, 8, 64] causal; the eval
   forward at [16, 1024, 8, 64], and at the learner's [8, 1024, 8, 64]) plus a ragged S=1000, a non-causal, causal
   S=1 and S=129 (one partial q tile; one full tile and a row) and an f32
   case; the bf16 forward's output must lie within 1e-6 + 1 bf16 ulp +
   2^-15 of its row's weighted mass sum_j (p_j / l) |v_j| of the plain
   version's (it splits P into two bf16 halves for the tensor cores), the
   bf16 gradients within 1e-6 + 1 bf16 ulp + 2^-15 of their weighted mass
   (``plain_flash_grad_mass``: scale |dS| @ |K|, scale |dS|^T @ |Q|,
   P^T @ |dO|, with dS's own f32 rounding floor beside |dS|; the backward
   splits dS, dS^T and P^T alike), f32 outputs
   within the JAX package's f32 tolerances, lse within 1e-5; the forward
   without lse must equal the one with it bit for bit. Then each
   kernel's time (CUDA events over many launches after a warm-up), its
   plain version's time, the library's time as a yardstick (never called by
   the port: ``aten._scaled_dot_product_flash_attention``, which also returns
   the logsumexp, for the forward with lse; ``F.scaled_dot_product_attention``
   for the one without; the aten
   flash-attention backward for the dq and dk/dv pair) and its bound: the
   larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s (H100 SXM bf16 dense
   and HBM peaks), FLOPs counted over the causal lower triangle.
   The ring's carry kernel at its chunk shape [2, 1024, 8, 64]: the
   diagonal fold into a fresh carry (shard 7 of 8), a past fold into that
   carry, a wholly future fold (the carry must come back bit-identical), a
   fold whose diagonal crosses a key tile (kv_offset = q_offset - 100), a
   ragged non-causal 1000 x 1000 fold, diagonal and past folds of chunks
   of 129 and 1, and f32; m to 1e-5 (bf16; f32 1e-6), l to
   1e-5 + 1e-5 |ref|, acc to that plus 1e-6 l (its rounding scales with the
   row's weight mass) plus, for bf16 (P split into two bf16 halves),
   2^-15 of the fold's mass exp(S - m_new) @ |V|
   (``plain_flash_chunk_mass``); the past fold's finalized bf16 output
   within one bf16 ulp (+ 2^-15 mass / l for bf16). No PyTorch call folds
   a chunk into an unnormalized carry, so its row has no library time;
   SDPA on the same chunk is printed for information.
3. slice: ``MeshSimulation(task="lm")`` at the full-width LM configuration
   (8 nodes, committee 4, 64 sequences of 1024 tokens per node, vocab 8192,
   4 layers, 8 heads, width 512, batch 8, Adam lr 3e-4) for 3 rounds after a
   warm-up round on copied state; s/round, test loss (finite and falling),
   peak device memory, and each kernel's launches in that run, which must
   equal the per-round counts times the 4 rounds driven.
3a. telemetry (``phase_telemetry``, right after phase 3: a long process's
   later profiler sessions were seen to record no kernel): the host
   telemetry plane and the profiler on phase 3's LM, 2 rounds a run after a
   warm-up round (a new engine's allocator grows in it): the device observatory off twice (does the card's round
   reproduce bit for bit?), then on, once with the first round under
   ``run(profile_dir=...)``'s ``torch.profiler`` window, whose Chrome trace
   must name ``flash_fwd_sm90_kernel``, ``flash_bwd_dq_sm90_kernel`` and
   ``flash_bwd_dkv_sm90_kernel``, and once untraced; the params hash must
   not move with devobs on (or, where the off runs differ, by no more than
   twice their spread), the ``update_norm`` sketch holds committee x rounds
   norms and ``fleet_snapshot`` writes its document; s/round with devobs on
   and off; the round's devobs row built under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync).
   ``device_bucket_stats`` on 1e6 seeded values, card against CPU.
   ``DEVOBS_NAN_INJECT_ROUND=1`` under ``park`` (the trip, the flight
   recorder's dump with ``bytes_in_use`` on its chunk events, the bundle's
   manifest) and ``abort`` (the message names the dump).
   ``round_cost_analysis`` of the LM (attention equal to the analytic count;
   TFLOP per round and TFLOP/s beside the card's name and power limit), the
   same count on the card and on the CPU for a one-layer LM, and
   ``TorchLearner.cost_analysis``'s keys. Every artifact goes to a
   temporary directory that the phase removes.
4. ring: the same LM with ``attention_kind="ring_flash"`` over a sequence of
   8192 tokens sharded on a virtual ``"seq"`` axis of 8. Its logits on a
   [2, 2048] input against the flash model's (6e-2); then
   ``make_sequence_parallel_train_step`` (batch 2, Adam lr 3e-4), one
   warm-up step and 4 timed steps: s/step, the loss of every step (finite
   and falling), peak device memory, and exactly 144 carry launches per
   step (4 layers x 36 folds).

5. narrow: rows 1-5 at head sizes 32 and 16 (the width of rows 1-5 over 16
   and 32 heads: [8, 1024, H, D], the eval forward at [16, 1024, H, D], the
   carry at one ring chunk [2, 1024, H, D]) in bf16 (rows 1-5 on the narrow
   tensor-core forward, backward pair and carry at the true D, no host copy;
   a future fold must return the carry bit-identical) and f32 (the
   CUDA-core instances at D), held to the bars of phase 2 and the carry
   phase, then timed beside the aten flash forward and backward at the same
   shape, with the bound at the true D; under torch.profiler one call each
   of the forward (with and without lse), dq and dk/dv at [8, 1024, 16, 32]
   must be one CUDA kernel each (no pad copies), and, in phase 16's process
   of its own, one carry call at [2, 1024, 16, 32]. Then rows 1-4 the same way
   at the flash classifier's own shapes (bf16, head size 32, a sequence of
   64: one 64-row tile of the narrow kernels): training at [16, 64, 4, 32],
   eval at [256, 64, 4, 32]. Each row 2 also records the backend SDPA takes
   (``library_backend``; phase 23 names its kernel).
6. narrow paths: the slice's LM at 16 and 32 heads (head sizes 32 and 16),
   one round each (no warm-up round: the kernels are built and checked by
   then), and the ring trainer at 16 and 32 heads, one step after a warm-up
   step each; exact launch counts.
7. mlp: ``MeshSimulation`` (task ``"classification"``, the default) at
   ``bench.py``'s metric configuration (``bench.py:78-86``,
   ``_metric_sim_run``, ``_make_data``): ``mlp_model(seed=0)`` (hidden 256,
   128), 100 nodes of 600 samples from ``synthetic_mnist(n_train=60000,
   n_test=1024)`` with 10 % of the train and test labels redrawn, split IID,
   committee 4, batch 64, 1 epoch, seed 1, 10 rounds after a warm-up round:
   s/round, test loss and accuracy per round (finite, loss falling, final
   accuracy > 0.5), peak memory; no flash kernel launched. Then two
   scheduled rounds at f32 compute on the card and on the CPU: node 0's
   parameters within 1e-2 of the rounds' update (L2), test loss within
   5e-4, accuracy within one test sample.
8. classifier: ``transformer_classifier_model(attention_kind="flash")`` at
   the JAX package's defaults (2 layers, 4 heads, width 128: head size 32;
   vocab 256, 10 classes, sequence 64, bf16), 8 nodes of 64 samples of
   label-dependent tokens, committee 4, batch 16, 3 rounds after a warm-up
   round: 32 ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv`` and 2
   ``flash_fwd_no_lse`` launches per round, test loss falling.
9. options: phase 7's configuration for 2 rounds each with SCAFFOLD,
   FedProx, DP-SGD (with its privacy spent), FedAdam, 10 % Byzantine nodes
   under Krum, the update-norm clip and ``eval_every=2``: finite losses;
   then each held on the card against the CPU as in phase 7.

10. c1: rows 1-5 at head sizes 48 ([8, 1024, 8, 48]: the bf16 forward,
   backward pair and carry on the narrow tensor-core kernels at the true D,
   f32 padded to the 64 instance) and
   128 ([8, 1024, 4,
   128]: the bf16 forward and backward pair on the wide tensor-core kernels,
   the bf16 carry on the grouped tensor-core carry, every f32 row on the
   CUDA-core <f32, 128> instances), held to the bars of phases 2 and 5 and
   timed beside aten;
   phase 6 also runs the LM and the ring at width 384 over 8 heads and at 4
   heads (D = 48 / 128).
11. learner: ``TorchLearner`` fits one node of phase 3's LM (64 sequences,
   batch 8: one epoch of 8 steps) and evaluates it: exactly 32 launches of
   rows 1, 3 and 4 per fit and 4 of row 2 per test batch, s/fit, s/step,
   peak memory, test loss falling; then a learner whose model was set from
   the fitted model's PFLT frame and a fresh learner on the same weights fit
   to the same loss (1e-5).
12. wire: the fitted LM's update (20,990,976 parameters) against its
   round-start anchor through ``DeltaWireCodec``, coalesced top-k 10 % in
   bf16, int8 and int4: ms to encode on the card, frame bytes and ratio
   against the dense f32 frame; every leaf's residual + scatter(dequant)
   equals acc bit for bit, a second codec holding the anchor decodes each
   frame to anchor + scatter(dequant) bit for bit, and the dense frame
   round-trips bit for bit.
12a. transport: the fitted LM's frames between four fully connected
   in-memory protocols of ``p2pfl_tpu_torch/comm/`` (heartbeat 0.25 s),
   each receiver decoding on the card with its own ``DeltaWireCodec``: the
   dense f32 frame to the fitted leaves and the coalesced top-k int8 frame
   to anchor + scatter(dequant) bit for bit (bytes, ms from send to the
   last decode); every observatory holds the other three's heartbeat
   digests (device memory > 0); under seeded faults (drop and duplicate
   0.25, jitter 10 ms, seed 7) 8 dense sends to each peer arrive as a fresh
   ``ChaosPlane``'s streams predict, twice, with node 0's digest counting
   the faults; a Byzantine node 0 (``signflip``, ``scaled``, ``nan``,
   ``inflate``; ``signflip`` on the top-k bf16 frame) decodes as the attack
   says bit for bit; ``adaptive_poison`` on the card equals the CPU's; a
   traced send's ``recv:`` span is parented on the sender's; teardown
   leaves no transport thread and an empty registry.
12a'. native: the native PFLT codec (``p2pfl_tpu_torch/native/``) built
   with ``g++`` into ``build/`` (the compiler's version and the library's
   path printed; a failed build or load fails the run). The fitted LM's
   dense f32 frame (83,964,992 bytes): the native and the pure-Python
   encodes byte-equal with and without CRC, each encode's median ms over 9
   runs taken in turns, ``zlib.crc32``'s ms over the payload and its share
   of each, and the wire's encode from the card's leaves either way; a
   decode onto the card bit-equal to the leaves; a flipped tensor byte and a
   flipped header byte each fail the decode. The interop arm: a user's
   ``nn.Module`` MLP (784-256-128-10) in a canonical ``TorchModelHandle``
   trains through the interop ``TorchLearner`` on the card against the
   port's zoo MLP Node on the card, over the in-memory wire, two rounds:
   both finish and their final canonical parameters lie within 1e-5. The
   gRPC arm runs two port Nodes of the full-width LM over localhost gRPC
   for one round (equal committed hashes, exact launches of rows 1-4) where
   ``grpc`` and ``google.protobuf`` import, and otherwise prints that it
   did not run.
12b. node: three port ``Node`` s on the in-memory transport, fully
   connected, each training phase 11's full-width LM on the card (64
   sequences of 1024 tokens a node, batch 8, Adam 3e-4) through the default
   ``LearnerExecutor``, committee 3, dense frames, ``CanonicalFedAvg``, two
   rounds from ``set_start_learning``: every node finishes; each round's
   committed hash equal on the three ledgers; the final parameters
   bit-identical across the nodes; round 0's aggregate equal, bit for bit, to
   FedAvg recomputed on the card from the three fitted models' dense frames;
   rows 1-4 launched exactly 2 x 3 x 32 times (row 2: 3 evaluations a node x
   8); the test loss falling; s/round (host clock), stage seconds, the fits'
   seconds on the executor's threads, peak memory, frame bytes a round; then
   one more round under phase 12a's seeded faults. The two rounds' frames
   go through the native codec: its pack counter rises by at least the
   dense frames the nodes built (one encode each; an init or full model goes
   to every peer from one), and the pure-Python one does not rise.
   First, the wire's
   NaN-preserving bf16 round on the card against the CPU's on 2^20 f32
   values with NaN payloads of both signs.
12c. secagg: the privacy plane. Its full-size passes on the card against
   the CPU on the full-width LM's leaves (committee 3, fixed keys, two
   rounds of error feedback, a NaN, an inf and clamped values):
   ``mask_own``'s lattice bytes and residual bits and ``finalize``'s
   parameter bits equal; then phase 12b's three Nodes under
   ``PRIVACY_SECAGG`` (default ``MaskedFedAvg``, committee 3, two rounds)
   and the same federation with ``mask_own(..., mask=False)``: each round's
   committed hash equal on the three ledgers and between the two runs,
   finalize outcome ``ok`` on every node and round (``range`` fails the
   phase), rows 1-4 launched as in phase 12b in both runs; s/round, frame
   bytes a round, a masked frame's bytes beside the dense frame's,
   ``mask_own`` / ``finalize`` ms, peak memory.
12d. recovery: checkpoint and recovery on the card. A: phase 3's LM,
   data and seed; a control runs 4 rounds; a victim runs 2 under
   ``run(checkpointer=, checkpoint_every=1)`` (``FLCheckpointer``,
   ``max_to_keep=2``) and is dropped; a bare step ``9`` and a marker-only
   ``7`` are planted; a simulation built with another seed ``load_from`` s
   (-> 2, the seed adopted) and runs 2: committees, test losses and all 8
   nodes' parameters bit-identical to the control's, rows 1-4 launched
   exactly per-round counts x 8 rounds; the save's host copy and write
   apart, ``load_from`` ms, bytes a step, s/round. B: one LM Node under
   top-k with an anchor and residuals journaled and brought back by
   ``Node.resume(..., device="cuda")``: params, anchor, residuals,
   ``anchor_crc`` and privacy keys bit-exact. C: phase 12b's three LM Nodes
   with journals, 3 rounds; node 2 crashes once journaled and comes back
   as itself (``Node.resume``, ``start``, ``resume_learning``): its history
   starts with ``ResumeStage`` and trains; every node finishes; the loss
   falls; the final parameters bit-equal, or each node's the last
   aggregate its own ledger committed (see ``recovery_crash``).
12e. population: ``PopulationEngine`` at ``bench.py --population``'s
   acceptance shape (100,000 virtual nodes, cohort 0.01, speed tiers,
   ledger attached; its 10 rounds cut to 2): mean fill x n == K, ``cohort_fill`` in the
   snapshot, host times of the schedules, ``fleet_health`` and the
   snapshot; then its recovery arm (n 256, killed after 3 of 6 rounds):
   node 0's hash, accuracy and cohort fill equal to the control's.
12f. asyncpop: ``AsyncPopulationEngine`` at ``bench.py --asyncpop``'s
   shapes. Throughput: 100,000 vnodes, cohort 0.01, tiers (1, 1, 1, 2, 5),
   its 12 windows cut to 6, ledger attached: every window closes, fold lag <=
   ``ASYNCPOP_MAX_LAG``, simulated throughput per contribution >= 2x the
   sync barrier's over the matching committee schedule, accuracy finite.
   IID control (n 256): the async global's hash equal to the sync engine's,
   accuracy delta 0.0 pp. Flash crowd (n 4096, period 8, 24 windows): folds
   in every spike and trough, lag and queue bounded. Ceiling: 1,000,000
   vnodes, bf16 ring, K 2048, 2 windows. Supervisor: the soak gate's
   kill / oom / sigterm drill on both engines (64 vnodes) heals to the
   fault-free hash with an identical event log on replay; a real
   ``torch.cuda.OutOfMemoryError`` in the second round (window) of a
   three-round chunk heals to it too; the degrade ladder replays
   identically. Devobs: on / off hash equal; a NaN at window
   3 under ``park`` stops at its chunk's end with a bundle.
13. parity: a ``ParityScenario`` (8 MLP nodes, full committee, 3 rounds, one
   signflip node) through the wire's model plane (``run_frames``), real port
   Nodes over the in-memory transport (``run_wire``) and the fused round
   (``run_fused``): every round's ``canonical_params_hash`` equal, the model
   plane's and the fused ledgers' trajectories equal, and
   ``scripts/parity_diff.py`` exit 0 on each Node's ledger against the fused
   one.
13a. campaign (``phase_campaign``): the seeded campaign's check prefix
   (``run_campaign(seed=Settings.CAMPAIGN_SEED, n_scenarios=
   Settings.CAMPAIGN_CHECK_SCENARIOS, device="cuda")``: the adaptive,
   baseline, chaos_drop and host_fault families' first scenarios, MLP
   federations of port Nodes and the port's fused round, both on the card,
   parity-differed and graded): every verdict ``ok`` with parity ``OK``,
   wire hashes bit-equal to fused hashes for the replay-stable families,
   scenario keys and the adaptive attack ladder equal to
   ``tests/torch_campaign_fixtures/campaign_baseline.json``'s (the host's
   baseline: card hashes are not held to its hashes); each scenario's wire
   and fused seconds and the rejection counts beside the fixture's. Then
   the baseline family's wire run once more under the lock-order sentinel
   (``SENTINEL.patched()``): the observed acquisition graph acyclic and not
   empty. Then ``mnist()`` with the hub offline (``hub_offline``: set in
   ``main`` and again here, ``HF_HOME`` under ``build/``): arrays equal to
   ``synthetic_mnist()``'s, and whether ``datasets`` imports here.
13b. multirank (``phase_multirank``): the ``nodes`` axis over ranks. Phase
   3's LM (its data and seeds) for a warm-up round and 2 rounds of a fixed
   schedule (round 0's committee on both halves of the population, round
   1's on nodes 0-3) in this process, then in W rank processes of this
   script (``--rank-worker DIR``, started fresh by
   ``p2pfl_tpu_torch.parallel.launch`` with a deadline that kills the
   world): with one card two gloo ranks sharing it and a one-rank NCCL
   world, with two or more min(cards, 4) NCCL ranks, one card each. Every
   rank must exit 0 with the backend ``initialize_multihost`` chose, its
   final hash and test losses equal to this process's (losses falling),
   rows 1, 3, 4 launched 32 times a member it trained and row 2 four times
   a round; per arm the backend, W, s/round, bytes all-gathered a round,
   peak memory, members per rank and devices seen are printed.
13c. seqstage (``phase_seqstage``): the ``seq`` and ``stage`` axes over
   ranks. In this process the ring phase's run (its model, tokens, a
   warm-up and ``RING_STEPS`` Adam steps) at W virtual shards and the
   pipeline phase's (its flash LM, batch, ``PP_MICRO`` microbatches and
   ``PP_STEPS`` steps) at W virtual stages; then the same in W rank
   processes of this script (``--seqstage-worker DIR``): with one card two
   gloo ranks sharing it (``ppermute`` copies through host memory), with two
   or more min(cards, 4) NCCL ranks. Ring: each rank's first-step logits
   shard within 6e-2 of this process's, its loss per step within
   ``SEQSTAGE_LOSS_BAR``, finite and falling, its parameters' hash equal to
   rank 0's, row 5 launched exactly ``LAYERS * (rank + 1)`` times a step
   (causal skips) and rows 1-4 never, ``ppermute`` bytes a step equal to
   ``ring_ppermute_bytes``. Pipeline: each rank's logits and losses equal to
   this process's, its final parameters (its stage and the replicated
   leaves) bit-equal, kernels at [2, 1024, 8, 64], rows 1, 3, 4 launched
   ``(LAYERS / W) * PP_MICRO`` times a step and row 2 as often in the no-grad
   forward, ``ppermute`` bytes equal to ``pp_ppermute_bytes``. Per rank the
   backend, W, device, s/step and peak memory are printed.
13d. expertmodel (``phase_expertmodel``): the ``expert`` and ``model`` axes
   over ranks, with one card two gloo ranks sharing it, with two or more
   min(cards, 4) NCCL ranks (``--expertmodel-worker DIR``), each arm held
   against the same run in this process. Expert: phase 20's MoE LM (4
   experts, ``shard_moe_params`` over ``expert`` = W) at batch 8 x 1024, a
   warm-up and ``MOE_STEPS`` Adam steps on loss + 0.01 aux: first-step
   logits within ``EM_LOGITS_BAR``, the loss per step within
   ``EM_LOSS_BAR``, finite and falling, the replicated leaves' hash equal to
   rank 0's, the gathered parameters within ``EM_PARAMS_RTOL`` of the run's
   update (L2), each rank holding X / W experts, the bytes summed equal to
   ``em_ep_bytes`` a step, rows 1, 3, 4 launched ``LAYERS`` times a step and
   row 2 never. Model: phase 3's flash LM round on ``{"nodes": 1, "model":
   W}`` (a warm-up round and one round of ``EM_SCHEDULE``; the gloo arm at
   one batch a node, the NCCL arm at the slice's 64 sequences): the eval
   loss within ``EM_LOSS_BAR``, node 0's gathered parameters within
   ``EM_PARAMS_RTOL`` of the update, the hash equal on every rank, the
   bytes gathered and summed equal to ``em_tp_bytes``' count, rows 1-4
   launched as often as in the one process. Per rank the backend, W,
   device, s/step or s/round, the bytes and peak memory are printed.
13e. sharded (``phase_sharded``): sharded checkpoints and both population
   engines over ranks, in the rank layout of 13c (``--sharded-worker DIR
   A|B``). World A: phase 3's LM over ``nodes`` (a warm-up and the 2 rounds
   of 13b's schedule, saving after each round, ``max_to_keep`` 2), the LM
   on ``{"nodes": 1, "model": W}`` (13d's sequences a node, 2 rounds,
   saving after each, its gathered state hashed), ``PopulationEngine`` at
   100,000 nodes (cohort 0.01, 2 rounds, a save after each) and
   ``AsyncPopulationEngine`` (2 windows in chunks of 1, a save after each
   chunk). World B resumes every arm from A's first save. This process runs
   the one-process references and restores A's W-rank steps in one process.
   Checks: every hash equal to world A's and the one process's (the model
   arm: A's gathered state at step 1 equal to its one-process restore, B's
   after round 2 equal to A's step 2), rows 1-4 launched exactly as the
   members each rank trained imply (the model arm: as one process), the
   shards' tensor bytes plus the replicated file's equal to the one-process
   step's, and no ``all_gather`` or ``all_gather_dim`` byte in any
   ``save_to`` / ``load_from``. Per rank the save's host-copy, write and
   commit-wait ms, the load ms, s/round or s/window, members per rank and
   peak memory are printed.
14. longcontext: rows 1-4 at the example's own shapes at its defaults
   (bf16, head size 16: the forward and backward pair on the narrow
   kernels; a sequence of 256): training at
   [4, 256, 4, 16], eval at [16, 256, 4, 16], held to phase 2's bars and
   timed beside aten; then ``p2pfl_tpu_torch.examples.longcontext
   --attention flash`` at its defaults (in this process): the token loss
   falls, rows 1-4 launch.
15. entry: ``entry()``'s forward gives [64, 10] finite logits on the card,
   and on a seeded random batch agrees with the CPU's to four bf16 ulps of
   the largest logit.

16. d256: rows 1-5 at head size 256 ([8, 1024, 2, 256], the eval forward
   at [16, 1024, 2, 256], one ring chunk [2, 1024, 2, 256]; the bf16 forward
   and backward pair on the wide tensor-core kernels, the bf16 carry on the
   grouped tensor-core carry, f32 on the CUDA-core <f32, 256> instances),
   held to the bars of phases 2 and 5 and timed beside aten; then d512: rows
   1-5 the same way at head size 512 ([8, 1024, 1, 512], eval [16, 1024, 1,
   512], ring chunk [2, 1024, 1, 512]; the bf16 rows on the grouped
   tensor-core kernels, f32 on the CUDA-core <f32, 512> instances; aten's
   flash attention stops at 256, so the library times there are its
   memory-efficient attention's); then d1024: rows 1-5 at [8, 1024, 1, 1024]
   (eval [16, ...], ring chunk [2, 1024, 1, 1024]) and at D 600 (zero-padded
   to 640) at [1, 1024, 1, 600], the bf16 rows on the grouped kernels and
   f32 on the chunked kernels, held to the same bars and timed beside
   whatever fused library call takes the shape, its backend recorded
   ("none" where none does); in a process of its own, one bf16 carry call at
   [2, 1024, 1, 512] must be one CUDA kernel, the grouped carry, and one at
   [2, 1024, 16, 32] the narrow carry. Then the LM
   and the ring at width 512 over 2 heads and over 1 head (D = 256 / 512),
   and at width 1024 over 1 head (D = 1024) cut to one layer, as in phase
   6, exact launch counts; each LM after a warm-up round, the ring's s/step
   (host clock) after a warm-up step.
17. cnn: ``cnn_model`` in phase 7's round (its data, committee 4, batch 64)
   for 10 rounds after a warm-up round: loss falling, final accuracy > 0.5;
   then held on the card against the CPU as phase 7 holds the MLP.
18. topk-ties: ``topk_select`` and the three error-feedback encoders on 2^20
   values whose magnitudes tie at the k-th place (a {-2, -1, 1, 2} grid plus
   a 0.25 grid; a block of zeros crossing the k-th place): the card keeps
   the same lowest-index members, values, scales and residuals as the CPU.
19. cifar: ``p2pfl_tpu_torch.examples.cifar`` at its defaults (50 nodes,
   committee 8, 128 samples a node, batch 32, 32 x 32, ResNet-18, Krum,
   Dirichlet 0.5) with ``--rounds 2 --cost-analysis``: s/round, peak memory,
   test accuracy per round, the round's counted TFLOP and TFLOP/s; then at
   f64 compute (the f32 gradient of a GroupNorm ResNet is itself
   ill-conditioned) the ResNet's loss gradients on one batch (1e-5
   of each leaf's largest) and one scheduled round at 4 nodes, on the card
   against the CPU as in phase 7.
20. moe: ``moe_lm_model`` at phase 3's widths (vocab 8192, 4 layers of which
   2 routed, 8 heads, width 512, 4 experts, flash attention, bf16): its f32
   logits against dense attention's on [2, 256] (1e-4), then 4 Adam steps
   on loss + 0.01 aux at batch 8 and an eval forward at batch 16, with
   exact launch counts at rows 1-4's shapes.
21. pipeline: rows 1-4 at the pipeline's microbatch shape [2, 1024, 8, 64]
   (the ``_pp`` rows), then ``make_pipelined_transformer_lm`` of phase 3's
   flash LM over 4 stages of one layer, a batch of 8 in 4 microbatches: its
   logits against the unpipelined model's (2^-5 of the largest logit), 3
   Adam steps, exact launch counts at [2, 1024, 8, 64].
22. dryrun: ``dryrun_multichip(4)`` on the card, five OK lines.
23. sdpa: in a process of its own, the kernel each row 2's SDPA call runs
   at the row's shape under its recorded backend, its longest CUDA kernel
   under torch.profiler (``library_kernel``): the smoke's own process
   was seen to record no kernel in its later profiler sessions (why is not
   known).

``--profile`` adds one more slice round, one more ring train step, one more
MLP round, one more run of the cifar example with ``--rounds 1`` (its set-up,
warm-up round and round) and one more MoE train step, each under
``torch.profiler``, printing device time by kernel class and the device's
busy share.

Each phase prints its wall time (``[time] phase_<name>: <s> s``). Any
failed check exits 1 without the result lines. On success the last
three lines are the card's name and power limit, one JSON object with a row
per kernel (rows 1-5 at head size 64, then ``<name>_d32`` and
``<name>_d16``: bf16 times, with the f32 instance's beside them; then
``<name>_d48``, ``<name>_d128``, ``<name>_d256``, ``<name>_d512`` and
``<name>_d1024`` the same way; then rows
1-4 at the classifier's shapes, ``<name>_d32_cls``, at the longcontext
example's, ``<name>_d16_lc``, and at the pipeline's, ``<name>_pp``; rows 1-4
at head size 64 also carry the MoE phase's ``launches_moe``), and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3

# Full-width LM configuration (bench.py's --lm-mfu arm).
NODES, COMMITTEE, SEQS, SEQ_LEN, VOCAB = 8, 4, 64, 1024, 8192
LAYERS, HEADS, EMBED, BATCH, LR, ROUNDS = 4, 8, 512, 8, 3e-4, 3
N_PARAMS = 20_990_976
EVAL_SEQS = 16

SOURCE_FWD = "p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu"  # the bf16 forward (slice) and carry fold (ring)
SOURCE_BWD = "p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu"  # the bf16 backward pair the slice runs
KERNEL_ROWS = {  # name -> (replaced TPU kernel body, launches per round on the slice, source)
    "flash_fwd": ("p2pfl_tpu/ops/attention.py:183", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_FWD),
    "flash_fwd_no_lse": ("p2pfl_tpu/ops/attention.py:243", LAYERS, SOURCE_FWD),
    "flash_bwd_dq": ("p2pfl_tpu/ops/attention.py:326", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_BWD),
    "flash_bwd_dkv": ("p2pfl_tpu/ops/attention.py:370", LAYERS * (SEQS // BATCH) * COMMITTEE, SOURCE_BWD),
}

# Sequence-parallel (ring) configuration: the same model over 8192 tokens
# in 8 shards of 1024 (the tutorial's length, the JAX tests' largest ring).
RING_SHARDS, RING_SEQ, RING_BATCH, RING_STEPS = 8, 8192, 2, 4
RING_SHARD = RING_SEQ // RING_SHARDS
RING_FOLDS = LAYERS * RING_SHARDS * (RING_SHARDS + 1) // 2  # carry launches per forward
RING_KERNEL_ROWS = {  # name -> (replaced TPU kernel body, launches per train step on the ring, source)
    "flash_carry": ("p2pfl_tpu/ops/attention.py:485", RING_FOLDS, SOURCE_FWD),
}

# Head sizes below 64: the width above over 16 and 32 heads. The bf16
# forward, backward pair and carry run the narrow tensor-core kernels at the
# true D; f32 has its own instances.
NARROW_HEAD_DIMS = (32, 16)
SOURCE_F32 = "p2pfl_tpu_torch/csrc/flash_attn.cu"  # the CUDA-core kernels: f32
SOURCE_FWD_WIDE = "p2pfl_tpu_torch/csrc/flash_fwd_wide_sm90.cu"  # the bf16 forward at D = 128 and 256
SOURCE_FWD_GROUPED = "p2pfl_tpu_torch/csrc/flash_fwd_grouped_sm90.cu"  # the bf16 forward above D = 256
SOURCE_FWD_NARROW = "p2pfl_tpu_torch/csrc/flash_fwd_narrow_sm90.cu"  # the bf16 forward below D = 64
SOURCE_BWD_NARROW = "p2pfl_tpu_torch/csrc/flash_bwd_narrow_sm90.cu"  # the bf16 backward pair below D = 64
SOURCE_CARRY_NARROW = "p2pfl_tpu_torch/csrc/flash_carry_narrow_sm90.cu"  # the bf16 carry below D = 64
SOURCE_BWD_WIDE = "p2pfl_tpu_torch/csrc/flash_bwd_wide_sm90.cu"  # the bf16 backward pair at D = 128 and 256
SOURCE_BWD_GROUPED = "p2pfl_tpu_torch/csrc/flash_bwd_grouped_sm90.cu"  # the bf16 backward pair above D = 256
SOURCE_CHUNKED = "p2pfl_tpu_torch/csrc/flash_chunked.cu"  # above D = 512: f32
SOURCE_CARRY_GROUPED = "p2pfl_tpu_torch/csrc/flash_carry_grouped_sm90.cu"  # the bf16 carry above D = 64
# Head sizes up to 128 (the repair of ROADMAP queue C item 1): 48 at the LM's
# width over 8 heads (width 384; the bf16 forward, backward pair and carry on
# the narrow kernels, f32 padded to the 64 instance) and 128 at width 512
# over 4 heads (bf16 on the wide kernels and the grouped carry, f32 on the
# CUDA-core <f32, 128> instances).
# Head size -> heads.
C1_HEAD_DIMS = {48: 8, 128: 4}
# Head size 256: the LM's width over 2 heads (the bf16 forward and backward
# pair on the wide tensor-core kernels, the bf16 carry on the grouped one;
# f32 on the CUDA-core <f32, 256> instances, 32-row tiles). Head size 512,
# the largest compiled f32 instance: the width over 1 head (bf16 on the
# grouped tensor-core kernels, f32 on the CUDA-core <f32, 512> instances,
# 16-row tiles).
D256_HEAD_DIMS = {256: 2}
D512_HEAD_DIMS = {512: 1}
# Head sizes above 512 (the head size a run-time argument: bf16 on the
# grouped tensor-core kernels, f32 on the chunked kernels): rows 1-5 at [8, 1024, 1, 1024] and at 600 (zero-padded
# to 640) at B 1, and the LM and the ring at width 1024 over 1 head, cut to
# one layer.
D1024_HEAD_DIMS = {1024: 1}
CHUNKED_PADDED_DIM = 600
CHUNKED_LAYERS = 1

# The MoE LM at the federated LM's widths (4 experts, every second block
# routed, flash attention, bf16): 4 Adam steps on loss + 0.01 aux at batch
# BATCH, then an eval forward at EVAL_SEQS; the kernels run at rows 1-4's
# shapes.
MOE_EXPERTS, MOE_STEPS, MOE_AUX = 4, 4, 0.01
MOE_PER_STEP = LAYERS  # training launches of rows 1, 3, 4 per step (one batch)
# The pipelined LM: the flash LM above over 4 stages of one layer, a batch of
# BATCH in 4 microbatches (kernels at [2, 1024, 8, 64], the "_pp" rows), 3
# train steps.
PP_STAGES, PP_MICRO, PP_STEPS = 4, 4, 3
PP_SUFFIX = "_pp"
PP_PER_PASS = LAYERS * PP_MICRO  # launches of a kernel per pipelined forward (or backward)
# examples/cifar.py at its defaults (50 nodes, committee 8, 128 samples a
# node, batch 32, 32 x 32, ResNet-18, Krum, Dirichlet 0.5), rounds cut to 2.
CIFAR_ROUNDS = 2
# The CNN round: bench.py's MNIST data (phase 7), committee 4, batch 64.
CNN_ROUNDS = 10

# bench.py's metric configuration (bench.py:78-86, _metric_sim_run).
MLP_NODES, MLP_SAMPLES, MLP_COMMITTEE, MLP_BATCH, MLP_TEST, MLP_ROUNDS = 100, 600, 4, 64, 1024, 10
MLP_LABEL_FLIP = 0.10  # bench.py's LABEL_FLIP
OPTION_ROUNDS = 2
# The card-against-CPU check: two scheduled rounds in which nodes 0, 11 and
# 33 train twice (their optimizer state must be written back between) and
# node 0 is one of the options phase's Byzantine nodes.
PARITY_SCHEDULE = ((0, 11, 22, 33), (33, 0, 44, 11))
PARITY_RTOL, PARITY_LOSS_ATOL = 1e-2, 5e-4

# The JAX package's transformer_classifier_model defaults (head size 32).
CLS_NODES, CLS_PER_NODE, CLS_COMMITTEE, CLS_BATCH, CLS_TEST, CLS_ROUNDS = 8, 64, 4, 16, 256, 3
CLS_SEQ, CLS_VOCAB, CLS_CLASSES, CLS_LAYERS, CLS_HEADS = 64, 256, 10, 2, 4
CLS_SUFFIX = "_d32_cls"  # the rows of the classifier's own kernel shapes
CLS_STEPS = CLS_COMMITTEE * (CLS_PER_NODE // CLS_BATCH) * CLS_LAYERS  # training launches per round
LC_SUFFIX = "_d16_lc"  # the rows of examples/longcontext.py's own kernel shapes


def narrow_suffix(d: int) -> str:
    """The suffix of a row at head size ``d`` and the width of rows 1-5."""
    return f"_d{d}"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls. A
    device-side sleep holds the stream first, long enough that every call is
    queued before the first one runs, so a kernel shorter than its host-side
    launch is timed by the device and not by the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0  # host and device time of one call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.0, 2 * iters * one + 1e-3) * 2e9))  # cycles, at most ~1 s at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, what: str, atol: float, bf16_ulps: int = 0, mass=None) -> float:
    """Max |got - ref|; fails unless every element is within atol plus
    ``bf16_ulps`` bf16 ulps of ``ref`` (the ulp of ``ref``'s own binade),
    plus ``2^-15 * mass`` where a weighted mass is given (the bf16 forward:
    ``mass = (P / l) @ |V|``; the bf16 gradients: ``plain_flash_grad_mass``;
    both from the plain side)."""
    import torch

    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    diff = (got - ref).abs()
    _, exp = torch.frexp(ref)  # ref = m * 2**exp with 0.5 <= |m| < 1
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), exp - 8))
    room = 2.0**-15 * mass if mass is not None else torch.zeros_like(ref)
    ok = bool((diff <= atol + bf16_ulps * ulp + room).all())
    err = float(diff.max())
    tol = f"atol {atol:g}"
    if bf16_ulps:  # the largest share of the ulp allowance that an element uses
        used = ((diff - atol).clamp(min=0) / torch.where(ulp > 0, ulp, torch.ones_like(ulp))).max()
        tol += f" + {bf16_ulps} bf16 ulp (worst element uses {float(used):.2f} ulp)"
    if mass is not None:  # the largest share of the mass term that an element needs beyond atol + ulps
        past = (diff - atol - bf16_ulps * ulp).clamp(min=0)
        used = (past / torch.where(room > 0, room, torch.ones_like(room))).max()
        tol += f" + 2^-15 mass (worst element uses {float(used):.3f} of it)"
    print(f"  {what}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
    check(ok, f"{what} disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def cuda_kernels(prof) -> list:
    """``[(us, name)]`` of the CUDA kernels a ``torch.profiler`` run
    recorded (older layouts attach them to the CPU op that launched them)."""
    from torch.autograd import DeviceType

    kernels = [(e.time_range.elapsed_us(), e.name) for e in prof.events() if e.device_type == DeviceType.CUDA]
    return kernels or [(k.duration, k.name) for e in prof.events() for k in getattr(e, "kernels", [])]


def sdpa_backend(q, k, v) -> dict:
    """The row's library call's backend: ``library_backend``, the one
    ``F.scaled_dot_product_attention(q, k, v, is_causal=True)`` takes under
    the backends enabled here (SDPA's own choice,
    ``torch._fused_sdp_choice``), and ``library_shape``, q's shape, from
    which :func:`phase_sdpa_kernels` names the kernel it runs."""
    import torch
    from torch.nn.attention import SDPBackend

    return {"library_backend": SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name,
            "library_shape": list(q.shape)}


def sdpa_kernels(calls: list) -> list:
    """For each ``(backend, [B, H, S, D])`` the longest CUDA kernel of one
    bf16 causal ``F.scaled_dot_product_attention`` call under that backend
    alone, under torch.profiler after a warm-up call, or "kernel not
    recorded"."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    names = []
    for backend, shape in calls:
        q, k, v = (torch.randn(shape).to("cuda", torch.bfloat16) for _ in range(3))
        with sdpa_kernel([getattr(SDPBackend, backend)]), torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
                torch.cuda.synchronize()
        kernels = cuda_kernels(prof)
        names.append(max(kernels)[1][:120] if kernels else "kernel not recorded")
    return names


def phase_sdpa_kernels(rows: dict) -> None:
    """``library_kernel``: the kernel each row's SDPA call runs (every row
    :func:`sdpa_backend` recorded), named by :func:`sdpa_kernels` in a
    process of its own at the row's shape and backend. In this process's
    own later profiler sessions the card's kernels were seen to go
    unrecorded; why is not known."""
    keys = [key for key, r in rows.items() if "library_shape" in r]
    calls = [(rows[key]["library_backend"], rows[key]["library_shape"]) for key in keys]
    for key, (backend, shape), name in zip(keys, calls, in_fresh_process(f"sdpa_kernels({calls!r})")):
        rows[key]["library_kernel"] = name
        print(f"[sdpa] {key}: {backend} at {shape}: {name}")


def narrow_call_kernels(shape: list) -> list:
    """The names of the CUDA kernels that one bf16 causal call each of the
    port's forward with lse, forward without lse, dq and dk/dv at ``shape``
    run, under one torch.profiler session (after a warm-up call of each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from p2pfl_tpu_torch.ops import _kernels

    q, k, v, g = (torch.randn(shape).to("cuda", torch.bfloat16) for _ in range(4))
    out, lse = _kernels.flash_fwd(q, k, v, True, True)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    calls = (lambda: _kernels.flash_fwd(q, k, v, True, True), lambda: _kernels.flash_fwd(q, k, v, True, False),
             lambda: _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),
             lambda: _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True))
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    return [name for _, name in cuda_kernels(prof)]


def carry_call_kernels(shape: list) -> list:
    """The names of the CUDA kernels that one bf16 causal carry fold (a past
    chunk into a fresh carry) at ``shape`` runs under torch.profiler (after
    a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    q, k, v = (torch.randn(shape).to("cuda", torch.bfloat16) for _ in range(3))
    carry = att.init_carry(q.shape, q.device)
    _kernels.flash_carry(carry, q, k, v, shape[1], 0, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _kernels.flash_carry(carry, q, k, v, shape[1], 0, True)
        torch.cuda.synchronize()
    return [name for _, name in cuda_kernels(prof)]


def in_fresh_process(call: str) -> list:
    """The JSON value that ``chip_smoke.<call>`` prints in a fresh Python
    process (a profiler check: on the card, the later profiler sessions of a
    process that had run many were seen to record no kernel)."""
    import os

    code = f"import json, chip_smoke; print(json.dumps(chip_smoke.{call}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"{call} failed: {out.stderr.strip()[-500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def bound(name: str, b: int, s: int, h: int, d: int, causal: bool, esize: int) -> tuple:
    """(bound_ms, bound_by): FLOPs of the products (causal: lower triangle, as
    bench.py counts) over the bf16 peak vs bytes (each input read once, each
    output written once) over the HBM rate."""
    tri = 0.5 if causal else 1.0
    full = b * h * s * s * d  # one S x S x D product is 2 * full FLOPs
    tensor = b * s * h * d * esize
    rows = b * h * s * 4
    flops, nbytes = {
        "flash_fwd": (4 * full * tri, 4 * tensor + rows),
        "flash_fwd_no_lse": (4 * full * tri, 4 * tensor),
        "flash_bwd_dq": (6 * full * tri, 5 * tensor + 2 * rows),
        "flash_bwd_dkv": (8 * full * tri, 6 * tensor + 2 * rows),
    }[name]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_env() -> str:
    import torch
    from p2pfl_tpu_torch.ops import _kernels

    card = nvidia_smi()
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([_kernels._find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    print(f"[env] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.monotonic()
    path, log = _kernels.build()
    print(f"[env] built {path.name} in {time.monotonic() - t0:.1f} s")
    # One line per compiled kernel from the -Xptxas -v report.
    entry, seen = None, []
    for line in log.splitlines():
        m = re.search(r"(flash_fwd_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel|flash_carry_kernel)"
                      r"I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)E)?", line)
        m90 = re.search(r"flash_fwd_sm90_kernelILb(\d)E", line)
        mw90 = re.search(r"flash_fwd_wide_sm90_kernelILi(\d+)ELb(\d)E", line)
        mg90 = re.search(r"flash_fwd_grouped_sm90_kernelILb(\d)E", line)
        mn90 = re.search(r"flash_fwd_narrow_sm90_kernelILi(\d+)ELb(\d)E", line)
        mnb = re.search(r"(flash_bwd_dq_narrow_sm90_kernel|flash_bwd_dkv_narrow_sm90_kernel|"
                        r"flash_carry_narrow_sm90_kernel)ILi(\d+)E", line)
        mb90 = re.search(r"(flash_bwd_dq_sm90_kernel|flash_bwd_dkv_sm90_kernel|flash_carry_sm90_kernel)", line)
        mwb = re.search(r"(flash_bwd_dq_wide_sm90_kernel|flash_bwd_dkv_wide_sm90_kernel)ILi(\d+)E", line)
        mgb = re.search(r"(flash_bwd_dq_grouped_sm90_kernel|flash_bwd_dkv_grouped_sm90_kernel|"
                        r"flash_carry_grouped_sm90_kernel)", line)
        mch = re.search(r"(flash_fwd_chunked_kernel|flash_bwd_dq_chunked_kernel|flash_bwd_dkv_chunked_kernel|"
                        r"flash_carry_chunked_kernel)I(13__nv_bfloat16|f)(?:Lb(\d)E)?", line)
        if m:
            entry = f"{m[1]}<{'bf16' if m[2] != 'f' else 'f32'}, D={m[3]}{', lse=' + m[4] if m[4] else ''}>"
        elif m90:
            entry = f"flash_fwd_sm90_kernel<bf16, D=64, lse={m90[1]}>"
        elif mw90:
            entry = f"flash_fwd_wide_sm90_kernel<bf16, D={mw90[1]}, lse={mw90[2]}>"
        elif mg90:
            entry = f"flash_fwd_grouped_sm90_kernel<bf16, lse={mg90[1]}>"
        elif mn90:
            entry = f"flash_fwd_narrow_sm90_kernel<bf16, W={mn90[1]}, lse={mn90[2]}>"
        elif mnb:
            entry = f"{mnb[1]}<bf16, W={mnb[2]}>"
        elif mb90:
            entry = f"{mb90[1]}<bf16, D=64>"
        elif mwb:
            entry = f"{mwb[1]}<bf16, D={mwb[2]}>"
        elif mgb:
            entry = f"{mgb[1]}<bf16>"
        elif mch:
            entry = f"{mch[1]}<{'bf16' if mch[2] != 'f' else 'f32'}{', lse=' + mch[3] if mch[3] else ''}>"
        elif entry and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)[1]
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            print(f"[env] ptxas {entry}: {regs} registers, {spill} bytes spilled")
            seen.append(entry)
            if "_sm90_kernel" in entry:  # the tensor-core kernels
                check(spill == "0", f"{entry} spills {spill} bytes")
            entry = None
    check(sum(e.startswith("flash_fwd_sm90") for e in seen) == 2,
          "the build log lacks the two tensor-core forward instances")
    check(sorted(e for e in seen if e.startswith("flash_fwd_wide_sm90")) ==
          [f"flash_fwd_wide_sm90_kernel<bf16, D={d}, lse={w}>" for d in (128, 256) for w in (0, 1)],
          "the build log lacks a wide tensor-core forward instance (D = 128 / 256, with and without lse)")
    check(sorted(e for e in seen if e.startswith("flash_fwd_grouped_sm90")) ==
          [f"flash_fwd_grouped_sm90_kernel<bf16, lse={w}>" for w in (0, 1)],
          "the build log lacks a grouped tensor-core forward instance (above D = 256, with and without lse)")
    check(sorted(e for e in seen if e.startswith("flash_fwd_narrow_sm90")) ==
          sorted(f"flash_fwd_narrow_sm90_kernel<bf16, W={w}, lse={x}>" for w in (16, 32, 64) for x in (0, 1)),
          "the build log lacks a narrow tensor-core forward instance (box width 16 / 32 / 64, with and without lse)")
    check(sorted(e for e in seen if "_narrow_sm90" in e and e.startswith("flash_bwd")) ==
          sorted(f"flash_bwd_{k}_narrow_sm90_kernel<bf16, W={w}>" for k in ("dq", "dkv") for w in (16, 32, 64)),
          "the build log lacks a narrow tensor-core backward instance (dq, dk/dv at box width 16 / 32 / 64)")
    check(sorted(e for e in seen if e.startswith("flash_carry_narrow_sm90")) ==
          [f"flash_carry_narrow_sm90_kernel<bf16, W={w}>" for w in (16, 32, 64)],
          "the build log lacks a narrow tensor-core carry instance (box width 16 / 32 / 64)")
    check(all(any(e.startswith(f"flash_bwd_{k}_sm90") for e in seen) for k in ("dq", "dkv")),
          "the build log lacks a tensor-core backward kernel")
    check(sorted(e for e in seen if "_wide_sm90" in e and e.startswith("flash_bwd")) ==
          [f"flash_bwd_{k}_wide_sm90_kernel<bf16, D={d}>" for k in ("dkv", "dq") for d in (128, 256)],
          "the build log lacks a wide tensor-core backward instance (dq, dk/dv at D = 128 / 256)")
    check(sorted(e for e in seen if "_grouped_sm90" in e and e.startswith("flash_bwd")) ==
          [f"flash_bwd_{k}_grouped_sm90_kernel<bf16>" for k in ("dkv", "dq")],
          "the build log lacks a grouped tensor-core backward kernel (dq, dk/dv above D = 256)")
    check(sorted(e for e in seen if "_chunked_kernel" in e) ==
          sorted([f"flash_fwd_chunked_kernel<f32, lse={w}>" for w in (0, 1)] +
                 [f"flash_{k}_chunked_kernel<f32>" for k in ("bwd_dq", "bwd_dkv", "carry")]),
          "the chunked kernels are not rows 1-5 above D = 512 in f32 alone")
    check(any(e.startswith("flash_carry_sm90_kernel") for e in seen),
          "the build log lacks the tensor-core carry kernel (D 64)")
    check(seen.count("flash_carry_grouped_sm90_kernel<bf16>") == 1,
          "the build log lacks the grouped tensor-core carry kernel (above D 64)")
    for simt in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_carry_kernel"):
        # bf16 runs the tensor-core kernels only: no CUDA-core kernel has a
        # bf16 instance.
        check(not any(e.startswith(f"{simt}<bf16") for e in seen), f"{simt} has a bf16 CUDA-core instance")
        for d in (128, 256, 512):
            check(any(e.startswith(f"{simt}<f32, D={d}") for e in seen),
                  f"the build log lacks the f32 D = {d} instance of {simt}")
    return card


def phase_sass(lib, nvcc: str) -> None:
    """Count the HGMMA (wgmma) instructions in each forward, backward and
    carry kernel of the built library with ``cuobjdump -sass``, found beside
    ``nvcc``."""
    import os

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print("[env] HGMMA per forward / backward / carry kernel: not measured (no cuobjdump beside nvcc)")
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts: dict = {}
    fn = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts.setdefault(fn, 0)
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    shown = {name: n for name, n in counts.items() if re.search(r"flash_(fwd|bwd|carry)", name)}
    for name, n in sorted(shown.items()):
        print(f"[env] HGMMA in {name}: {n}")
    sm90 = [n for name, n in shown.items() if "flash_fwd_sm90_kernel" in name]
    check(len(sm90) == 2 and all(n > 0 for n in sm90), "a bf16 forward instance holds no HGMMA instruction")
    wide90 = [n for name, n in shown.items() if "flash_fwd_wide_sm90_kernel" in name]
    check(len(wide90) == 4 and all(n > 0 for n in wide90),
          "a wide bf16 forward instance (D = 128 / 256) holds no HGMMA instruction")
    grouped90 = [n for name, n in shown.items() if "flash_fwd_grouped_sm90_kernel" in name]
    check(len(grouped90) == 2 and all(n > 0 for n in grouped90),
          "a grouped bf16 forward instance (above D = 256) holds no HGMMA instruction")
    narrow90 = [n for name, n in shown.items() if "flash_fwd_narrow_sm90_kernel" in name]
    check(len(narrow90) == 6 and all(n > 0 for n in narrow90),
          "a narrow bf16 forward instance (box width 16 / 32 / 64) holds no HGMMA instruction")
    bwd90 = [n for name, n in shown.items() if "flash_bwd_dq_sm90" in name or "flash_bwd_dkv_sm90" in name]
    check(len(bwd90) == 2 and all(n > 0 for n in bwd90), "a bf16 backward kernel holds no HGMMA instruction")
    narrow_bwd90 = [n for name, n in shown.items() if re.search(r"flash_bwd_(dq|dkv)_narrow_sm90", name)]
    check(len(narrow_bwd90) == 6 and all(n > 0 for n in narrow_bwd90),
          "a narrow bf16 backward instance (dq, dk/dv at box width 16 / 32 / 64) holds no HGMMA instruction")
    wide_bwd90 = [n for name, n in shown.items() if re.search(r"flash_bwd_(dq|dkv)_wide_sm90", name)]
    check(len(wide_bwd90) == 4 and all(n > 0 for n in wide_bwd90),
          "a wide bf16 backward instance (D = 128 / 256) holds no HGMMA instruction")
    grouped_bwd90 = [n for name, n in shown.items() if re.search(r"flash_bwd_(dq|dkv)_grouped_sm90", name)]
    check(len(grouped_bwd90) == 2 and all(n > 0 for n in grouped_bwd90),
          "a grouped bf16 backward kernel (above D = 256) holds no HGMMA instruction")
    carry_narrow90 = [n for name, n in shown.items() if "flash_carry_narrow_sm90_kernel" in name]
    check(len(carry_narrow90) == 3 and all(n > 0 for n in carry_narrow90),
          "a narrow bf16 carry instance (box width 16 / 32 / 64) holds no HGMMA instruction")
    carry90 = [n for name, n in shown.items() if "flash_carry_sm90" in name]
    check(len(carry90) == 1 and carry90[0] > 0, "the bf16 carry kernel (D 64) holds no HGMMA instruction")
    carry_grouped90 = [n for name, n in shown.items() if "flash_carry_grouped_sm90" in name]
    check(len(carry_grouped90) == 1 and carry_grouped90[0] > 0,
          "the grouped bf16 carry kernel (above D 64) holds no HGMMA instruction")


def phase_kernels() -> dict:
    """Returns {name: row} with max_abs_err, ms, plain_ms, library_ms, bound."""
    import torch
    import torch.nn.functional as F
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def inputs(b, s, dtype=torch.bfloat16):
        return [torch.randn((b, s, HEADS, EMBED // HEADS), generator=gen).to(dev, dtype) for _ in range(4)]

    # Kernel and plain version both compute in f32 and differ only in the
    # order of their sums: a bf16 output may sit one bf16 ulp from the plain
    # one (rounding two nearly equal f32 values), and no further; 1e-6 covers
    # values so near zero that the f32 sums' own rounding shows. The bf16
    # forward multiplies P as two bf16 halves (within 2^-17 P of P), so its
    # output gets 2^-15 of the row's weighted mass (P / l) @ |V| beyond that;
    # the bf16 backward splits dS, dS^T and P^T alike, so each gradient gets
    # 2^-15 of its own weighted mass (plain_flash_grad_mass).
    # f32 outputs are held to the JAX package's f32 tolerances (forward
    # 1e-5, gradients 1e-4), lse to 1e-5 in every case.
    tols = {torch.bfloat16: ({"atol": 1e-6, "bf16_ulps": 1},) * 2,
            torch.float32: ({"atol": 1e-5}, {"atol": 1e-4})}
    rows: dict = {}
    cases = ((SEQ_LEN, True, torch.bfloat16), (1000, True, torch.bfloat16),
             (SEQ_LEN, False, torch.bfloat16), (1, True, torch.bfloat16), (129, True, torch.bfloat16),
             (SEQ_LEN, True, torch.float32))
    for s, causal, dtype in cases:
        main = (s, causal, dtype) == cases[0]
        print(f"[kernels] B={BATCH} S={s} H={HEADS} D={EMBED // HEADS} {str(dtype)[6:]} causal={causal}")
        fwd_tol, grad_tol = tols[dtype]
        q, k, v, g = inputs(BATCH, s, dtype)
        out, lse = _kernels.flash_fwd(q, k, v, causal, True)
        out_p, lse_p = att.plain_flash_forward(q, k, v, causal)
        if dtype == torch.bfloat16:  # the tensor-core forward splits P: its bar adds 2^-15 of the mass
            fwd_tol = {**fwd_tol, "mass": att.plain_flash_row_mass(q, k, v, causal)}
        e_fwd = max(max_err(out, out_p, "flash_fwd out", **fwd_tol),
                    max_err(lse, lse_p, "flash_fwd lse", atol=1e-5))
        out_n, _ = _kernels.flash_fwd(q, k, v, causal, False)
        check(torch.equal(out_n, out), "the forward without lse differs from the one with it")
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
        dq_p = att.plain_flash_backward_dq(q, k, v, g, lse, delta, causal)
        dk_p, dv_p = att.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal)
        masses = (att.plain_flash_grad_mass(q, k, v, g, lse, delta, causal) if dtype == torch.bfloat16
                  else (None, None, None))  # the tensor-core backward splits dS, dS^T and P^T
        e_dq = max_err(dq, dq_p, "flash_bwd_dq dq", **grad_tol, mass=masses[0])
        e_dkv = max(max_err(dk, dk_p, "flash_bwd_dkv dk", **grad_tol, mass=masses[1]),
                    max_err(dv, dv_p, "flash_bwd_dkv dv", **grad_tol, mass=masses[2]))
        if not main:
            continue
        # Library yardsticks on the same inputs, never called by the port: the
        # SDPA forward, and the one aten call that computes the backward pair's
        # function, (dq, dk, dv) from (dO, q, k, v, out, lse), fed the outputs
        # of its own forward.
        qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 20)
            # Row 1's yardstick also returns the logsumexp, as row 1 does.
            flash_fwd_lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qh, kh, vh, 0.0, True, False), 20)
            fa = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True, False)
            o_l, lse_l, cq, ck, mq, mk, seed, offset = fa[:8]

            def lib_bwd():
                return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    gh, qh, kh, vh, o_l, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset)

            dq_l = lib_bwd()[0]
            sdpa_bwd = time_ms(lib_bwd, 20)
        print(f"[kernels] library backward's dq against the kernel's: max_abs_err "
              f"{float((dq_l.transpose(1, 2).float() - dq.float()).abs().max()):.3e} (information only)")
        timings = {
            "flash_fwd": (lambda: _kernels.flash_fwd(q, k, v, True, True),
                          lambda: att.plain_flash_forward(q, k, v, True), flash_fwd_lib, e_fwd),
            "flash_bwd_dq": (lambda: _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),
                             lambda: att.plain_flash_backward_dq(q, k, v, g, lse, delta, True), sdpa_bwd, e_dq),
            "flash_bwd_dkv": (lambda: _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                              lambda: att.plain_flash_backward_dkv(q, k, v, g, lse, delta, True), sdpa_bwd, e_dkv),
        }
        for name, (kern, plain, lib_ms, err) in timings.items():
            b_ms, b_by = bound(name, BATCH, s, HEADS, EMBED // HEADS, True, 2)
            rows[name] = {"max_abs_err": err, "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, 5),
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"[kernels] library (not used by the port): aten flash forward with logsumexp (row 1's "
              f"library_ms) {flash_fwd_lib:.4f} ms, sdpa forward {sdpa_fwd:.4f} ms, flash backward "
              f"(dq, dk, dv in one call; the library_ms of both backward rows) {sdpa_bwd:.4f} ms")
        pair = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
        print(f"[kernels] bwd: dq {rows['flash_bwd_dq']['ms']:.4f} + dk/dv {rows['flash_bwd_dkv']['ms']:.4f} = "
              f"{pair:.4f} ms against the aten flash backward's {sdpa_bwd:.4f} ms ({pair / sdpa_bwd:.2f}x of it)")

    # The eval forward (no logsumexp) at its shapes: the slice's test set in
    # one batch (the row), and the learner's test batches of BATCH.
    for b_eval in (EVAL_SEQS, BATCH):
        print(f"[kernels] B={b_eval} S={SEQ_LEN} H={HEADS} D={EMBED // HEADS} bfloat16 causal=True (no lse)")
        q, k, v, _ = inputs(b_eval, SEQ_LEN)
        out, none = _kernels.flash_fwd(q, k, v, True, False)
        check(none is None, "the no-lse forward returned an lse")
        check(torch.equal(out, _kernels.flash_fwd(q, k, v, True, True)[0]),
              "the forward without lse differs from the one with it")
        out_p, _ = att.plain_flash_forward(q, k, v, True)
        err = max_err(out, out_p, f"flash_fwd_no_lse out (B={b_eval})", **tols[torch.bfloat16][0],
                      mass=att.plain_flash_row_mass(q, k, v, True))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with torch.no_grad():
            lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 20)
        b_ms, b_by = bound("flash_fwd_no_lse", b_eval, SEQ_LEN, HEADS, EMBED // HEADS, True, 2)
        row = {
            "max_abs_err": err, "ms": time_ms(lambda: _kernels.flash_fwd(q, k, v, True, False), 20),
            "plain_ms": time_ms(lambda: att.plain_flash_forward(q, k, v, True), 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, **sdpa_backend(qh, kh, vh),
        }
        if b_eval == EVAL_SEQS:
            rows["flash_fwd_no_lse"] = row
        else:
            print(f"[kernels] flash_fwd_no_lse at the learner's B={b_eval}: {row['ms']:.4f} ms (bound "
                  f"{b_ms:.4f} ms by {b_by}), plain {row['plain_ms']:.4f} ms, library {lib:.4f} ms")
    for name, r in rows.items():
        print(f"[kernels] {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); plain {r['plain_ms']:.4f} ms (not a yardstick); "
              f"library {r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x of it)"
              + (f" [{r['library_backend'][:80]}]" if "library_backend" in r else ""))
    return rows


def carry_bound(b: int, sq: int, sk: int, h: int, d: int, esize: int, diagonal: bool) -> tuple:
    """(bound_ms, bound_by) of one carry fold: FLOPs 4 B H Sq Sk D (halved on
    the diagonal chunk) over the bf16 peak vs bytes (q, k, v in their type;
    m, l, acc read and written in f32) over the HBM rate."""
    flops = 4 * b * h * sq * sk * d * (0.5 if diagonal else 1.0)
    nbytes = (b * sq + 2 * b * sk) * h * d * esize + 2 * (2 * b * h * sq + b * sq * h * d) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def carry_err(got, ref, what: str, mass=None) -> float:
    """Max |got - ref| over a carry; fails unless m is within 1e-6 (1e-5
    where ``mass`` is given: the bf16 kernel's wgmma sums the scores in its
    own order), l within 1e-5 + 1e-5 |ref| and acc within 1e-5 + 1e-5 |ref|
    + 1e-6 l, plus 2^-15 ``mass`` for the bf16 kernel, which splits P into
    two bf16 halves (``mass = plain_flash_chunk_mass``: the fold's
    exp(S - m_new) @ |V|). Both sides are f32 sums of ~1000 weighted
    terms, folded one key tile at a time by the kernel and in one step by
    the plain version; an acc element near 0 sums terms of size up to ~l,
    so its rounding scales with l (1e-6 l is 1e-6 in the normalized
    output)."""
    import torch

    worst = 0.0
    l_ref = ref[1].transpose(1, 2)[..., None]
    m_tol = 1e-5 if mass is not None else 1e-6
    room = 2.0**-15 * mass if mass is not None else 0.0
    tols = {"m": (f"{m_tol:g}", lambda r: torch.full_like(r, m_tol)),
            "l": ("1e-5 + 1e-5|ref|", lambda r: 1e-5 + 1e-5 * r.abs()),
            "acc": ("1e-5 + 1e-5|ref| + 1e-6 l" + (" + 2^-15 mass" if mass is not None else ""),
                    lambda r: 1e-5 + 1e-5 * r.abs() + 1e-6 * l_ref + room)}
    for name, a, r in zip(("m", "l", "acc"), got, ref):
        check(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite values")
        diff = (a - r).abs()
        label, tol = tols[name]
        ok = bool((diff <= tol(r)).all())
        err = float(diff.max())
        note = ""
        if name == "acc":  # what the l and mass terms are needed for
            core = 1e-5 + 1e-5 * r.abs()
            note = f" ({int((diff > core).sum())} of {diff.numel()} elements past 1e-5 + 1e-5|ref| alone"
            if mass is not None:  # the largest share of the mass term that an element needs
                past = (diff - core - 1e-6 * l_ref).clamp(min=0)
                note += f"; worst element uses {float((past / room.clamp(min=1e-30)).max()):.3f} of the mass term"
            note += ")"
        print(f"  {what} {name}: max_abs_err={err:.3e} tol={label} {'ok' if ok else 'FAIL'}{note}")
        check(ok, f"{what} {name} disagrees with the plain version (max_abs_err {err:.3e})")
        worst = max(worst, err)
    return worst


def phase_carry() -> dict:
    """The ring's carry kernel against its plain version, then its times."""
    import torch
    import torch.nn.functional as F
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    hd = EMBED // HEADS

    def inputs(s, dtype):
        return [torch.randn((RING_BATCH, s, HEADS, hd), generator=gen).to(dev, dtype) for _ in range(5)]

    def fold(carry, q, k, v, q_off, kv_off, causal, what):
        """One kernel fold against the plain one; returns both carries, the
        fold's mass (bf16) and the error."""
        got = _kernels.flash_carry(carry, q, k, v, q_off, kv_off, causal)
        ref = att.plain_flash_chunk_update(carry, q, k, v, q_off, kv_off, causal)
        mass = (att.plain_flash_chunk_mass(carry, q, k, v, q_off, kv_off, causal)
                if q.dtype == torch.bfloat16 else None)  # the bf16 kernel splits P
        return got, ref, mass, carry_err(got, ref, what, mass)

    def finalized_err(past, past_p, mass, what):
        """The finalized bf16 output within one bf16 ulp of the plain one's,
        plus 2^-15 of the fold's mass / l where the fold split P."""
        l = past_p[1].transpose(1, 2)[..., None].clamp(min=1e-30)
        return max_err(att.finalize_carry(past, torch.bfloat16), att.finalize_carry(past_p, torch.bfloat16),
                       what, atol=1e-6, bf16_ulps=1, mass=mass / l if mass is not None else None)

    off = (RING_SHARDS - 1) * RING_SHARD  # shard 7: its diagonal chunk, then a past one
    rows, errs = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        print(f"[carry] B={RING_BATCH} Sq=Sk={RING_SHARD} H={HEADS} D={hd} {str(dtype)[6:]} causal=True "
              f"q_offset={off}")
        q, k, v, kp, vp = inputs(RING_SHARD, dtype)
        fresh = att.init_carry(q.shape, dev)
        diag, _, _, e_diag = fold(fresh, q, k, v, off, off, True, "diagonal fold (kv_offset = q_offset)")
        past, past_p, mass, e_past = fold(diag, q, kp, vp, off, 0, True, "past fold (kv_offset 0)")
        future = _kernels.flash_carry(past, q, kp, vp, off, off + RING_SHARD, True)
        same = all(torch.equal(a, b) for a, b in zip(future, past))
        print(f"  future fold (kv_offset {off + RING_SHARD}): carry bit-identical {'ok' if same else 'FAIL'}")
        check(same, "a fold wholly in the future changed the carry")
        e_out = finalized_err(past, past_p, mass, "past fold's finalized bf16 output")
        if not main:
            continue
        errs += [e_diag, e_past, e_out]
        errs.append(fold(fresh, q, k, v, off, off - 100, True,
                         "fold with the diagonal inside a key tile (kv_offset = q_offset - 100)")[3])
        print(f"[carry] B={RING_BATCH} Sq=Sk=1000 H={HEADS} D={hd} bfloat16 causal=False (ragged)")
        qr, kr, vr, _, _ = inputs(1000, torch.bfloat16)
        errs.append(fold(att.init_carry(qr.shape, dev), qr, kr, vr, 0, 0, False, "ragged non-causal fold")[3])
        for s in (129, 1):  # one full q tile and a row; one row and one key
            print(f"[carry] B={RING_BATCH} Sq=Sk={s} H={HEADS} D={hd} bfloat16 causal=True q_offset={7 * s}")
            qs, ks, vs, kps, vps = inputs(s, torch.bfloat16)
            diag_s, _, _, e = fold(att.init_carry(qs.shape, dev), qs, ks, vs, 7 * s, 7 * s, True,
                                   f"S={s} diagonal fold")
            past_s, past_sp, mass_s, e2 = fold(diag_s, qs, kps, vps, 7 * s, 0, True, f"S={s} past fold")
            errs += [e, e2, finalized_err(past_s, past_sp, mass_s, f"S={s} past fold's finalized bf16 output")]
        ms_past = time_ms(lambda: _kernels.flash_carry(diag, q, kp, vp, off, 0, True), 20)
        ms_diag = time_ms(lambda: _kernels.flash_carry(fresh, q, k, v, off, off, True), 20)
        plain_past = time_ms(lambda: att.plain_flash_chunk_update(diag, q, kp, vp, off, 0, True), 5)
        plain_diag = time_ms(lambda: att.plain_flash_chunk_update(fresh, q, k, v, off, off, True), 5)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, kp, vp))
        with torch.no_grad():
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
        b_past, by_past = carry_bound(RING_BATCH, RING_SHARD, RING_SHARD, HEADS, hd, 2, False)
        b_diag, by_diag = carry_bound(RING_BATCH, RING_SHARD, RING_SHARD, HEADS, hd, 2, True)
        rows["flash_carry"] = {"max_abs_err": max(errs), "ms": ms_past, "plain_ms": plain_past,
                               "bound_ms": b_past, "bound_by": by_past, "library_ms": None,
                               "ms_diagonal": ms_diag, "plain_ms_diagonal": plain_diag,
                               "bound_ms_diagonal": b_diag}
        print(f"[carry] past fold {ms_past:.4f} ms (bound {b_past:.4f} ms by {by_past}, {b_past / ms_past:.1%} "
              f"of it), plain {plain_past:.4f} ms; diagonal fold {ms_diag:.4f} ms (bound {b_diag:.4f} ms by "
              f"{by_diag}, {b_diag / ms_diag:.1%}), plain {plain_diag:.4f} ms")
        print(f"[carry] library: none (no PyTorch call folds a chunk into an unnormalized carry); for "
              f"information only, SDPA on the same past chunk (a different function: normalized, no "
              f"carry) {sdpa:.4f} ms")
    return rows


def narrow_rows(label: str, suffix: str, d: int, h: int, b: int, b_eval: int, s: int, dtypes: tuple,
                carry: bool, gen) -> dict:
    """Rows 1-4 (and the carry, with ``carry``) at head size ``d`` over ``h``
    heads: the forward and backward pair at [b, s, h, d], the eval forward at
    [b_eval, s, h, d], one ring chunk [2, 1024, h, d], each against its plain
    version, then timed; returns {"<name><suffix>": row} (bf16 numbers, f32
    beside them when ``dtypes`` holds it)."""
    import torch
    import torch.nn.functional as F
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    rows: dict = {}

    def inputs(b, s, dtype, n):
        return [torch.randn((b, s, h, d), generator=gen).to(dev, dtype) for _ in range(n)]

    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        kind = str(dtype)[6:]
        how = []
        for name in ("flash_fwd", "flash_bwd_dq", "flash_carry"):
            hd = _kernels.host_head_dim(name, dtype, d)  # the head size the kernel is handed
            how.append(f"{name} on the {_kernels.kernel_route(name, dtype, d)[1]}"
                       + ("" if hd == d else f" zero-padded to {hd}"))
        print(f"[{label}] D={d} {kind} ({', '.join(how)}; dk/dv as dq, the eval forward as the forward): "
              f"B={b} S={s} H={h} causal=True; eval B={b_eval}")
        # The bars of phase 2 (bf16: 1e-6 + 1 ulp + 2^-15 mass; f32: the
        # JAX package's 1e-5 / 1e-4) and of the carry phase.
        grad_tol = {"atol": 1e-6, "bf16_ulps": 1} if bf16 else {"atol": 1e-4}

        def fwd_tol(q, k, v):
            return ({"atol": 1e-6, "bf16_ulps": 1, "mass": att.plain_flash_row_mass(q, k, v, True)} if bf16
                    else {"atol": 1e-5})

        q, k, v, g = inputs(b, s, dtype, 4)
        out, lse = _kernels.flash_fwd(q, k, v, True, True)
        check(out.shape == q.shape and out.is_contiguous(), f"D={d}: forward output shape {tuple(out.shape)}")
        out_p, lse_p = att.plain_flash_forward(q, k, v, True)
        e_fwd = max(max_err(out, out_p, f"D={d} flash_fwd out", **fwd_tol(q, k, v)),
                    max_err(lse, lse_p, f"D={d} flash_fwd lse", atol=1e-5))
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True)
        dq_p = att.plain_flash_backward_dq(q, k, v, g, lse, delta, True)
        dk_p, dv_p = att.plain_flash_backward_dkv(q, k, v, g, lse, delta, True)
        masses = att.plain_flash_grad_mass(q, k, v, g, lse, delta, True) if bf16 else (None,) * 3
        e_dq = max_err(dq, dq_p, f"D={d} flash_bwd_dq dq", **grad_tol, mass=masses[0])
        e_dkv = max(max_err(dk, dk_p, f"D={d} flash_bwd_dkv dk", **grad_tol, mass=masses[1]),
                    max_err(dv, dv_p, f"D={d} flash_bwd_dkv dv", **grad_tol, mass=masses[2]))

        qe, ke, ve = inputs(b_eval, s, dtype, 3)  # the eval forward's shape
        out_e, none = _kernels.flash_fwd(qe, ke, ve, True, False)
        check(none is None and torch.equal(out_e, _kernels.flash_fwd(qe, ke, ve, True, True)[0]),
              f"D={d}: the forward without lse differs from the one with it")
        e_nolse = max_err(out_e, att.plain_flash_forward(qe, ke, ve, True)[0], f"D={d} flash_fwd_no_lse out",
                          **fwd_tol(qe, ke, ve))

        timings = {
            "flash_fwd": (lambda: _kernels.flash_fwd(q, k, v, True, True),
                          lambda: att.plain_flash_forward(q, k, v, True), e_fwd),
            "flash_fwd_no_lse": (lambda: _kernels.flash_fwd(qe, ke, ve, True, False),
                                 lambda: att.plain_flash_forward(qe, ke, ve, True), e_nolse),
            "flash_bwd_dq": (lambda: _kernels.flash_bwd_dq(q, k, v, g, lse, delta, True),
                             lambda: att.plain_flash_backward_dq(q, k, v, g, lse, delta, True), e_dq),
            "flash_bwd_dkv": (lambda: _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                              lambda: att.plain_flash_backward_dkv(q, k, v, g, lse, delta, True), e_dkv),
        }
        if carry:
            # One ring chunk of shard 7: the diagonal fold into a fresh carry,
            # a past fold into it, a future fold that must change nothing.
            qc, kc, vc, kpc, vpc = inputs(RING_BATCH, RING_SHARD, dtype, 5)
            off = (RING_SHARDS - 1) * RING_SHARD
            fresh = att.init_carry(qc.shape, dev)

            def fold(carry, kk, vv, kv_off, what):
                got = _kernels.flash_carry(carry, qc, kk, vv, off, kv_off, True)
                ref = att.plain_flash_chunk_update(carry, qc, kk, vv, off, kv_off, True)
                mass = att.plain_flash_chunk_mass(carry, qc, kk, vv, off, kv_off, True) if bf16 else None
                return got, carry_err(got, ref, f"D={d} {what} fold", mass)

            diag, e_diag = fold(fresh, kc, vc, off, "diagonal")
            past, e_past = fold(diag, kpc, vpc, 0, "past")
            future = _kernels.flash_carry(past, qc, kpc, vpc, off, off + RING_SHARD, True)
            check(all(torch.equal(a, b) for a, b in zip(future, past)),
                  f"D={d}: a fold wholly in the future changed the carry")
            timings["flash_carry"] = (lambda: _kernels.flash_carry(diag, qc, kpc, vpc, off, 0, True),
                                      lambda: att.plain_flash_chunk_update(diag, qc, kpc, vpc, off, 0, True),
                                      max(e_diag, e_past))
        lib: dict = {"flash_carry": None}  # no PyTorch call folds a chunk into an unnormalized carry
        backends: dict = {}
        if bf16 and d > _kernels.MAX_HEAD_DIM:  # the chunked kernels: whatever fused backend takes the shape
            qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
            qeh, keh, veh = (t.transpose(1, 2).contiguous() for t in (qe, ke, ve))
            lib, backends = library_above_512(qh, kh, vh, gh, qeh, keh, veh)
        elif bf16:  # aten's flash attention takes bf16 only: library times at the same shape
            qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
            qeh, keh, veh = (t.transpose(1, 2).contiguous() for t in (qe, ke, ve))
            with torch.no_grad():
                lib["flash_fwd_no_lse"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qeh, keh, veh, is_causal=True), 20)
                backends["flash_fwd_no_lse"] = sdpa_backend(qeh, keh, veh)
                if d <= 256:  # aten's flash attention
                    lib["flash_fwd"] = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                        qh, kh, vh, 0.0, True, False), 20)
                    o_l, lse_l, cq, ck, mq, mk, seed, offset = torch.ops.aten._scaled_dot_product_flash_attention(
                        qh, kh, vh, 0.0, True, False)[:8]
                    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = time_ms(
                        lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                            gh, qh, kh, vh, o_l, lse_l, cq, ck, mq, mk, 0.0, True, seed, offset), 20)
                else:  # its flash attention stops at 256: the memory-efficient one, with its logsumexp
                    lib.update(efficient_attention_ms(qh, kh, vh, gh))
        for name, (kern, plain, err) in timings.items():
            ms, plain_ms = time_ms(kern, 20), time_ms(plain, 5)
            key = name + suffix
            if bf16:
                if name == "flash_carry":
                    b_ms, b_by = carry_bound(RING_BATCH, RING_SHARD, RING_SHARD, h, d, 2, False)
                else:
                    b_ms, b_by = bound(name, b_eval if name == "flash_fwd_no_lse" else b, s, h, d, True, 2)
                rows[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib[name]}
                if name in backends:
                    rows[key].update(backends[name])
            else:
                rows[key].update({"max_abs_err_f32": err, "ms_f32": ms, "plain_ms_f32": plain_ms})
    for key, r in rows.items():
        against = (f"library {r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x of it)"
                   if r["library_ms"] else "library: none")
        if "library_backend" in r:
            against += f" [{r['library_backend'][:80]}]"
        f32 = f"; f32 {r['ms_f32']:.4f} ms, plain {r['plain_ms_f32']:.4f} ms" if "ms_f32" in r else ""
        print(f"[{label}] {key}: bf16 {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it), plain {r['plain_ms']:.4f} ms; {against}{f32}")
    return rows


def library_above_512(qh, kh, vh, gh, qeh, keh, veh) -> tuple:
    """Library times of rows 1-4 at a head size above 512, where aten's flash
    attention refuses the shape: ``(times, backends)``, each keyed by row.
    Rows 1, 3 and 4 take the memory-efficient attention with its logsumexp
    and its backward where it takes the shape; row 2 takes
    ``F.scaled_dot_product_attention`` under the first fused backend
    (flash, memory-efficient, cuDNN) that takes it, its backend recorded
    (:func:`sdpa_backend`). A row no fused backend takes has no library time
    (None) and backend "none"; SDPA's composite math path is not one call of
    a kernel and does not count."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {"flash_fwd": None, "flash_fwd_no_lse": None, "flash_bwd_dq": None, "flash_bwd_dkv": None,
             "flash_carry": None}
    backends = {name: {"library_backend": "none"} for name in times}
    try:
        times.update(efficient_attention_ms(qh, kh, vh, gh))
        backends.update({name: {"library_backend": "efficient"} for name in ("flash_fwd", "flash_bwd_dq",
                                                                            "flash_bwd_dkv")})
    except RuntimeError as e:  # refused on the host: no kernel ran
        print(f"  memory-efficient attention refuses the shape: {str(e).splitlines()[0][:160]}")
    for backend, label in ((SDPBackend.FLASH_ATTENTION, "flash"), (SDPBackend.EFFICIENT_ATTENTION, "efficient"),
                           (SDPBackend.CUDNN_ATTENTION, "cudnn")):
        try:
            with sdpa_kernel([backend]), torch.no_grad():
                times["flash_fwd_no_lse"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qeh, keh, veh, is_causal=True), 20)
                backends["flash_fwd_no_lse"] = sdpa_backend(qeh, keh, veh)
            break
        except RuntimeError as e:
            print(f"  SDPA's {label} backend refuses the shape: {str(e).splitlines()[0][:160]}")
    return times, backends


def efficient_attention_ms(qh, kh, vh, gh) -> dict:
    """Library times of rows 1, 3 and 4 where aten's flash attention refuses
    the head size (above 256): the memory-efficient attention forward with
    its logsumexp, and its backward (dq, dk, dv in one autograd call of its
    own derivative)."""
    import torch

    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    fwd = time_ms(lambda: eff(qh, kh, vh, None, True, 0.0, True), 20)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qh, kh, vh))
    with torch.enable_grad():
        o_r = eff(qr, kr, vr, None, True, 0.0, True)[0]
    bwd = time_ms(lambda: torch.autograd.grad(o_r, (qr, kr, vr), gh, retain_graph=True), 20)
    return {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd}


def phase_kernels_narrow() -> dict:
    """Rows 1-5 at head sizes 32 and 16 (the width of rows 1-5 over more
    heads), in bf16 and f32; then, under torch.profiler, one bf16 call each
    of the forward (with lse and without), dq and dk/dv at [8, 1024, 16, 32]
    must be one CUDA kernel each, the narrow kernels: no pad or slice
    copies. That check runs in a process of its own
    (``narrow_call_kernels``): on the card, the later profiler sessions of a
    process that had run many were seen to record no kernel (why is not
    known). Returns {"<name>_d<D>": row}."""
    import torch

    gen = torch.Generator().manual_seed(4)
    rows: dict = {}
    for d in NARROW_HEAD_DIMS:
        rows.update(narrow_rows("narrow", narrow_suffix(d), d, EMBED // d, BATCH, EVAL_SEQS, SEQ_LEN,
                                (torch.bfloat16, torch.float32), True, gen))
    shape = [BATCH, SEQ_LEN, EMBED // 32, 32]
    names = in_fresh_process(f"narrow_call_kernels({shape})")
    print(f"[narrow] one call each of flash_fwd (lse, no lse), flash_bwd_dq and flash_bwd_dkv at {shape}: "
          f"CUDA kernels {names}")
    # Four calls, four kernels, each call's own: so each call is one kernel.
    want = {"flash_fwd_narrow_sm90_kernel": 2, "flash_bwd_dq_narrow_sm90_kernel": 1,
            "flash_bwd_dkv_narrow_sm90_kernel": 1}
    check(len(names) == 4 and all(sum(kern in n for n in names) == c for kern, c in want.items()),
          f"the calls at {shape} are not the narrow kernels alone, one each: {names}")
    return rows


def phase_kernels_classifier() -> dict:
    """Rows 1-4 at the flash classifier's own shapes (head size 32, a
    sequence of 64: one 64-row tile), in bf16 as the classifier runs
    them: training at [16, 64, 4, 32], eval at [256, 64, 4, 32]; returns
    {"<name>_d32_cls": row}."""
    import torch

    return narrow_rows("classifier-kernels", CLS_SUFFIX, 32, CLS_HEADS, CLS_BATCH, CLS_TEST, CLS_SEQ,
                       (torch.bfloat16,), False, torch.Generator().manual_seed(10))


def phase_kernels_c1() -> dict:
    """Rows 1-5 at head sizes 48 and 128 (the repair of queue C item 1):
    [8, 1024, H, D], the eval forward at [16, 1024, H, D], one ring chunk
    [2, 1024, H, D], in bf16 and f32, held to the bars of phases 2 and 5 and
    timed beside aten; returns {"<name>_d<D>": row}."""
    import torch

    gen = torch.Generator().manual_seed(12)
    rows: dict = {}
    for d, heads in C1_HEAD_DIMS.items():
        rows.update(narrow_rows("c1", narrow_suffix(d), d, heads, BATCH, EVAL_SEQS, SEQ_LEN,
                                (torch.bfloat16, torch.float32), True, gen))
    return rows


def phase_kernels_longcontext() -> dict:
    """Rows 1-4 at ``examples/longcontext.py``'s own shapes at its defaults
    (width 64 over 4 heads: head size 16, a sequence of 256), in bf16 as the
    example runs them: training at [batch, 256, 4, 16], eval at
    [TEST_SEQS, 256, 4, 16]; returns {"<name>_d16_lc": row}."""
    import torch
    from p2pfl_tpu_torch.examples import longcontext

    args = longcontext.build_parser().parse_args(["--attention", "flash"])
    return narrow_rows("longcontext-kernels", LC_SUFFIX, args.embed_dim // args.heads, args.heads, args.batch_size,
                       longcontext.TEST_SEQS, args.seq_len, (torch.bfloat16,), False,
                       torch.Generator().manual_seed(14))


def lm_data(seed: int, seqs: int = SEQS) -> tuple:
    """Synthetic tokens as bench.py's --lm-mfu arm makes them: each sequence
    ``(start + i) % vocab``; returns the stacked train split and the test
    tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, VOCAB, size=(NODES, seqs, 1))
    x = ((starts + np.arange(SEQ_LEN)[None, None, :]) % VOCAB).astype(np.int32)
    y = np.zeros((NODES, seqs), np.int32)
    mask = np.ones((NODES, seqs), np.float32)
    xt = ((rng.integers(0, VOCAB, size=(EVAL_SEQS, 1)) + np.arange(SEQ_LEN)) % VOCAB).astype(np.int32)
    return (x, y, mask), xt


def phase_slice() -> dict:
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM, transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                 embed_dim=EMBED, attention_kind="flash", device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    print(f"[slice] TransformerLM {LAYERS}L/{EMBED}d/{HEADS}h vocab {VOCAB}: {n_params} params")
    check(n_params == N_PARAMS, f"expected {N_PARAMS} params, got {n_params}")

    # Reference on a small input: the flash path against dense attention.
    with torch.device("meta"):
        dense = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                              embed_dim=EMBED, attention_kind="dense")
    toks = torch.randint(0, VOCAB, (2, 256), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        got = model.apply(model.params, toks)
        ref = ModelHandle(model.params, dense).apply(model.params, toks)
    check(got.shape == (2, 256, VOCAB), f"logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    print(f"[slice] flash vs dense logits on [2, 256]: max_abs_err={err:.3e} tol 6e-2")
    check(bool(torch.isfinite(got).all()) and err <= 6e-2, "flash logits disagree with dense attention")

    train, xt = lm_data(5)
    sim = MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE,
                         batch_size=BATCH, lr=LR, seed=1, task="lm", device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = sim.run(rounds=ROUNDS, epochs=1, warmup=True)
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    print(f"[slice] {ROUNDS} rounds: {res.seconds_per_round:.4f} s/round "
          f"({res.seconds_total:.3f} s, host clock ending in torch.cuda.synchronize())")
    print(f"[slice] test loss per round: {res.test_loss}")
    print(f"[slice] test token accuracy per round: {res.test_acc}")
    print(f"[slice] committees: {res.committees.tolist()}")
    print(f"[slice] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"[slice] kernels: {json.dumps(launches)}")
    check(all(np.isfinite(res.test_loss)), "non-finite test loss")
    check(res.test_loss[-1] < res.test_loss[0], "test loss did not fall over the rounds")
    for name, (_, per_round, _) in KERNEL_ROWS.items():
        # run() drives the warm-up round and then the timed rounds.
        check(launches[name] > 0, f"{name} was never launched on the main path")
        check(launches[name] == per_round * (ROUNDS + 1),
              f"{name}: {launches[name]} launches, expected {per_round} per round x {ROUNDS + 1} "
              f"(warm-up + {ROUNDS})")
    return launches, sim


# The telemetry phase: the slice's LM for TELEMETRY_ROUNDS rounds a run
# (one round a chunk; the first chunk traced), a NaN injected at round 1 for
# the trip, and the cost count checked on the card against the CPU on a
# one-layer LM of the same kind (COST_CHECK_*).
TELEMETRY_ROUNDS = 2
COST_CHECK_NODES, COST_CHECK_SEQS, COST_CHECK_SEQ, COST_CHECK_BATCH = 2, 4, 256, 2
FLASH_TRACE_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")


def attention_flops(name: str, b: int, s: int, h: int, d: int) -> float:
    """FLOPs of one causal flash call as ``bound`` counts them (the lower
    triangle: half the S x S pairs)."""
    full = b * h * s * s * d
    return {"flash_fwd": 4, "flash_fwd_no_lse": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[name] * full * 0.5


def phase_telemetry(card: str) -> None:
    """The host telemetry plane and the profiler on the slice's LM (phase 3's
    configuration, bf16, one round a chunk, after a warm-up round, which
    absorbs a new engine's allocator growth): two runs with the device observatory off
    show whether the card's round reproduces bit for bit; then the same
    rounds with it on, the first chunk under a ``device_trace_window``
    (``run(profile_dir=...)``) whose Chrome trace must hold the three flash
    kernels, must give the same canonical params hash (or, if the off runs
    differ, differ from them by no more than twice their own spread), and an
    ``update_norm`` sketch of committee x rounds members; ``fleet_snapshot``
    writes its document; the round's devobs row (each member's update norm
    from ``_member_update``, then ``_devobs_aux``, which runs
    ``device_bucket_stats``) is built under ``set_sync_debug_mode("error")``
    and must not wait for the card. ``device_bucket_stats`` on 1e6 seeded values: the
    card's counts and zeros equal the CPU's but for values whose log lies
    within 2 f32 ulps of a bucket edge (counted), min and max exact, sum
    within 1e-6. ``DEVOBS_NAN_INJECT_ROUND=1``: ``park`` returns the trip
    ``nonfinite`` at round 1 with a flight-recorder dump whose chunk events
    carry the allocator's bytes in use and a bundle manifest; ``abort``'s
    message names that dump. ``round_cost_analysis`` of the LM: FLOPs per
    round > 0 with its attention part equal to the analytic count, TFLOP/s
    against the devobs-on s/round; the same count on the card and on the
    CPU for a one-layer LM within 1e-6; ``TorchLearner.cost_analysis``
    returns the JAX package's keys. Every artifact goes to a temporary
    directory (the flight recorder's ``artifacts/`` below the working
    directory, which the phase moves there)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES, device_bucket_spec, device_bucket_stats

    train, xt = lm_data(5)

    def lm_sim(device: str = "cuda", layers: int = LAYERS, data=train, test=xt, nodes: int = NODES,
               committee: int = COMMITTEE, batch: int = BATCH):
        model = transformer_lm_model(seed=0, seq_len=data[0].shape[-1], vocab_size=VOCAB, num_layers=layers,
                                     num_heads=HEADS, embed_dim=EMBED, attention_kind="flash", device=device)
        return MeshSimulation(model, data, test_data=(test, None), train_set_size=committee, batch_size=batch,
                              lr=LR, seed=1, task="lm", device=device)

    def node0(sim) -> dict:
        return {k: v[0].detach().float().cpu() for k, v in sim.params_stack.items()}

    def max_diff(a: dict, b: dict) -> float:
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    tmp = tempfile.mkdtemp(prefix="p2pfl_telemetry_")
    cwd = os.getcwd()
    os.chdir(tmp)  # the flight recorder dumps into ./artifacts
    try:
        with Settings.overridden(DOCTOR_BUNDLE_DIR=os.path.join(tmp, "bundles"), PERF_TRACE_DIR="",
                                 DEVOBS_PROFILE_CHUNKS=1):
            runs: dict = {}
            for label, devobs, traced in (("off", False, False), ("off again", False, False),
                                          ("on, traced", True, True), ("on", True, False)):
                sim = lm_sim()
                SKETCHES.reset()
                with Settings.overridden(DEVOBS_ENABLED=devobs):
                    res = sim.run(rounds=TELEMETRY_ROUNDS, warmup=True,
                                  profile_dir=os.path.join(tmp, "traces") if traced else None)
                runs[label] = (res, node0(sim), canonical_params_hash(node0(sim)))
                if label == "on":
                    extras, sketches = sim.devobs_summary()
                    snap_path = os.path.join(tmp, "federation_snapshot.json")
                    snap = sim.fleet_snapshot(res, path=snap_path)
                    on_sim_cost = sim.round_cost_analysis()
                    # The round's devobs row must not wait for the card: build
                    # it from the live params under CUDA's sync check.
                    p_k = [{k: v[i] for k, v in sim.params_stack.items()} for i in range(COMMITTEE)]
                    p_k_new = [{k: v * 1.001 for k, v in p.items()} for p in p_k]
                    agg = {k: v[0] for k, v in sim.params_stack.items()}
                    member_losses = torch.rand(COMMITTEE, device="cuda")
                    weights = torch.ones(COMMITTEE, device="cuda")
                    torch.cuda.synchronize()
                    row = None
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        un_sq = torch.stack([sim._member_update(i, p_k[i], p_k_new[i], True)["un_sq"]
                                             for i in range(COMMITTEE)])
                        row = sim._devobs_aux(un_sq, agg, member_losses, weights, COMMITTEE)
                        synced = None
                    except RuntimeError as e:
                        synced = str(e)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    print(f"[telemetry] devobs row under torch.cuda.set_sync_debug_mode('error'): "
                          f"{'no host sync' if synced is None else synced}")
                    check(synced is None and row is not None and tuple(row.shape) == (device_bucket_spec()[2] + 7,),
                          "the devobs row synchronises with the host")
                    del p_k, p_k_new, agg, row
                del sim
                gc.collect()
                print(f"[telemetry] devobs {label}: {res.seconds_per_round:.4f} s/round over {TELEMETRY_ROUNDS} "
                      f"rounds after a warm-up round{'; round 0 traced' if traced else ''}, params hash "
                      f"{runs[label][2]}")
            spread = max_diff(runs["off"][1], runs["off again"][1])
            if runs["off"][2] == runs["off again"][2]:
                print("[telemetry] two devobs-off runs reproduce bit for bit: the devobs runs are held to the hash")
                for label in ("on, traced", "on"):
                    check(runs[label][2] == runs["off"][2], f"devobs {label} changed the params hash")
            else:
                print(f"[telemetry] two devobs-off runs differ: hashes {runs['off'][2]} / {runs['off again'][2]}, "
                      f"largest param difference {spread:.3e}; the devobs runs are held to twice that")
                for label in ("on, traced", "on"):
                    err = max_diff(runs[label][1], runs["off"][1])
                    print(f"[telemetry] devobs {label} against off: largest param difference {err:.3e}")
                    check(err <= 2 * spread, f"devobs {label} moved the params beyond the card's own spread")
            print(f"[telemetry] s/round: devobs off {runs['off'][0].seconds_per_round:.4f} / "
                  f"{runs['off again'][0].seconds_per_round:.4f}, on {runs['on'][0].seconds_per_round:.4f} "
                  f"(traced run {runs['on, traced'][0].seconds_per_round:.4f}, the trace's export included)")

            # The trace of round 0.
            trace = os.path.join(tmp, "traces", "mesh_round_chunk0", "trace.json")
            check(os.path.isfile(trace), "run(profile_dir=...) wrote no trace")
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
            found = {k: sum(k in n for n in kernels) for k in FLASH_TRACE_KERNELS}
            print(f"[telemetry] trace of round 0: {os.path.getsize(trace)} bytes, {len(events)} events, "
                  f"{len(kernels)} kernel events; flash kernels {json.dumps(found)}")
            check(all(found.values()), f"the trace lacks flash kernels: {found}; it has {sorted(set(kernels))[:8]}")

            # The device observatory's summary.
            un = sketches.get("update_norm")
            print(f"[telemetry] devobs summary: {json.dumps(extras)}; update_norm count "
                  f"{un.count if un else 0}, p50 {un.quantile(0.5) if un else float('nan'):.6g}; "
                  f"snapshot {snap_path} ({os.path.getsize(snap_path)} bytes, fleet size {snap['fleet']['size']})")
            check(un is not None and un.count == COMMITTEE * TELEMETRY_ROUNDS,
                  "the update_norm sketch does not hold committee x rounds norms")
            check(snap["fleet"]["size"] == NODES + 1, "fleet_snapshot: wrong fleet size")

            # device_bucket_stats, card against CPU.
            gamma, lo, nbins = device_bucket_spec()
            g = torch.Generator().manual_seed(7)
            vals = torch.exp(torch.empty(10**6).uniform_(float(np.log(1e-8)), float(np.log(1e4)), generator=g))
            vals = vals * torch.where(torch.rand(10**6, generator=g) < 0.5, -1.0, 1.0)
            vals[:1000] = 0.0
            cpu = device_bucket_stats(vals, gamma_log=gamma, lo_idx=lo, nbins=nbins)
            dev = {k: v.cpu() for k, v in device_bucket_stats(vals.cuda(), gamma_log=gamma, lo_idx=lo,
                                                              nbins=nbins).items()}
            mag = vals.abs().double().numpy()
            logs = np.log(mag[mag >= 1e-9])
            edges = np.round(logs / gamma) * gamma
            near = int((np.abs(logs - edges) <= 2 * np.spacing(np.abs(logs).astype(np.float32))).sum())
            moved = int((dev["counts"] - cpu["counts"]).abs().sum())
            rel_sum = abs(float(dev["sum"]) - float(cpu["sum"])) / float(cpu["sum"])
            print(f"[telemetry] device_bucket_stats on 1e6 values, card against CPU: counts differ by {moved} "
                  f"(values within 2 ulp of a bucket edge: {near}), zeros {int(dev['zeros'])} / {int(cpu['zeros'])}, "
                  f"min/max equal {bool(dev['min'] == cpu['min'] and dev['max'] == cpu['max'])}, sum rel err "
                  f"{rel_sum:.2e} (tol 1e-6)")
            check(moved <= 2 * near and int(dev["zeros"]) == int(cpu["zeros"]), "device_bucket_stats: counts differ")
            check(bool(dev["min"] == cpu["min"]) and bool(dev["max"] == cpu["max"]) and rel_sum <= 1e-6,
                  "device_bucket_stats: min, max or sum differ")

            # The trip.
            with Settings.overridden(DEVOBS_NAN_INJECT_ROUND=1, DEVOBS_TRIP_ACTION="park"):
                parked = lm_sim().run(rounds=TELEMETRY_ROUNDS + 1, warmup=False)
            trip = parked.tripped
            print(f"[telemetry] park: tripped {json.dumps(trip)}, {parked.rounds} rounds returned")
            check(trip is not None and (trip["kind"], trip["round"]) == ("nonfinite", 1), "park: wrong trip")
            with open(trip["flightrec"]) as f:
                starts = [e for e in json.load(f)["events"] if e["kind"] == "chunk_start"]
            print(f"[telemetry] flight recorder: chunk_start bytes_in_use {[e['bytes_in_use'] for e in starts]}")
            check(bool(starts) and all(e["bytes_in_use"] > 0 for e in starts), "chunk events lack bytes_in_use")
            check(os.path.isfile(os.path.join(trip["bundle"], "manifest.json")), "park: no bundle manifest")
            dump = os.path.abspath(trip["flightrec"])
            with Settings.overridden(DEVOBS_NAN_INJECT_ROUND=1, DEVOBS_TRIP_ACTION="abort"):
                try:
                    lm_sim().run(rounds=TELEMETRY_ROUNDS + 1, warmup=False)
                    message = "no error"
                except RuntimeError as e:
                    message = str(e)
            print(f"[telemetry] abort: {message}")
            check(f"flight recorder dump: {trip['flightrec']};" in message and os.path.isfile(dump),
                  "abort: the message does not name the dump")
            gc.collect()

            # The cost analysis.
            cost = on_sim_cost
            seqs, seq_len = train[0].shape[1:]
            want_attn = COMMITTEE * (seqs // BATCH) * LAYERS * sum(
                attention_flops(n, BATCH, seq_len, HEADS, EMBED // HEADS)
                for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            want_attn += LAYERS * attention_flops("flash_fwd_no_lse", xt.shape[0], seq_len, HEADS, EMBED // HEADS)
            s_round = runs["on"][0].seconds_per_round
            print(f"[telemetry] round_cost_analysis: {cost['flops_per_round'] / 1e12:.4f} TFLOP/round, "
                  f"{cost['bytes_accessed_per_round'] / 1e9:.3f} GB counted per round, attention "
                  f"{cost['attention_flops_per_round'] / 1e12:.4f} TFLOP (analytic {want_attn / 1e12:.4f}); "
                  f"{cost['flops_per_round'] / s_round / 1e12:.2f} TFLOP/s at {s_round:.4f} s/round on {card}")
            check(cost["flops_per_round"] > 0 and cost["attention_flops_per_round"] == want_attn,
                  "round_cost_analysis: missing FLOPs or attention count off the analytic one")
            counts = {}
            small = tuple(a[:COST_CHECK_NODES, :COST_CHECK_SEQS] for a in train)
            small = (small[0][..., :COST_CHECK_SEQ], small[1], small[2])
            for device in ("cuda", "cpu"):
                sim = lm_sim(device, 1, small, xt[:2, :COST_CHECK_SEQ], COST_CHECK_NODES, COST_CHECK_NODES,
                             COST_CHECK_BATCH)
                counts[device] = sim.round_cost_analysis()["flops_per_round"]
                del sim
            rel = abs(counts["cuda"] - counts["cpu"]) / counts["cpu"]
            print(f"[telemetry] one-layer LM ({COST_CHECK_NODES} nodes x {COST_CHECK_SEQS} x {COST_CHECK_SEQ} tokens): "
                  f"{counts['cuda']:.6e} FLOP/round on the card, {counts['cpu']:.6e} on the CPU (rel {rel:.1e})")
            check(rel <= 1e-6, "round_cost_analysis differs between the card and the CPU")
            x0 = train[0][0]
            data = FederatedDataset.from_arrays(x0, np.zeros(len(x0), np.int32), xt, np.zeros(len(xt), np.int32))
            model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                         embed_dim=EMBED, attention_kind="flash", device="cuda")
            lcost = TorchLearner(model, data, batch_size=BATCH, seed=0, task="lm", device="cuda").cost_analysis()
            print(f"[telemetry] TorchLearner.cost_analysis of the LM learner: {json.dumps(lcost)}")
            check(lcost is not None and set(lcost) == {"flops_per_epoch", "bytes_accessed_per_epoch",
                                                       "flops_per_step", "steps_per_epoch"},
                  "TorchLearner.cost_analysis: not the JAX package's keys")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_ring() -> tuple:
    """The sequence-parallel trainer at the ring configuration; returns the
    launches of the ring's kernels in its run (warm-up step + timed steps)
    and a function that runs one more step."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import TransformerLM, transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        shard_tokens,
    )

    mesh = Mesh({"seq": RING_SHARDS}, device="cuda")
    model = transformer_lm_model(0, RING_SEQ, VOCAB, LAYERS, HEADS, EMBED, "ring_flash", "seq", device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    print(f"[ring] TransformerLM ring_flash {LAYERS}L/{EMBED}d/{HEADS}h vocab {VOCAB}: {n_params} params; "
          f"sequence {RING_SEQ} over {mesh}")
    check(n_params == N_PARAMS, f"expected {N_PARAMS} params, got {n_params}")

    # Reference on a small input: the ring against flash attention (both exact).
    with torch.device("meta"):
        flash = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                              embed_dim=EMBED, attention_kind="flash")
    toks = torch.randint(0, VOCAB, (2, 2048), generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        got = sequence_parallel_apply(model.apply, mesh)(model.params, toks)
        ref = ModelHandle(model.params, flash).apply(model.params, toks)
    check(got.shape == (2, 2048, VOCAB), f"logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    print(f"[ring] ring_flash vs flash logits on [2, 2048]: max_abs_err={err:.3e} tol 6e-2")
    check(bool(torch.isfinite(got).all()) and err <= 6e-2, "ring_flash logits disagree with flash attention")
    del got, ref

    # Synthetic tokens as bench.py's --lm-mfu arm makes them.
    rng = np.random.default_rng(7)
    x = (rng.integers(0, VOCAB, size=(RING_BATCH, 1)) + np.arange(RING_SEQ)) % VOCAB
    tokens = shard_tokens(x.astype(np.int32), mesh)
    opt = adam(LR)
    params, state = model.params, opt.init(model.params)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    params, state, loss = step(params, state, tokens)  # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(RING_STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = [float(l) for l in losses]
    print(f"[ring] {RING_STEPS} steps after a warm-up: {seconds / RING_STEPS:.4f} s/step ({seconds:.3f} s, "
          f"host clock ending in torch.cuda.synchronize()); {RING_BATCH * RING_SEQ} tokens per step")
    print(f"[ring] loss per step (warm-up first): {losses}")
    print(f"[ring] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB; {held} bytes held before "
          f"the first step: weights, tokens)")
    print(f"[ring] kernels: {json.dumps(launches)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "training loss did not fall over the steps")
    for name, (_, per_step, _) in RING_KERNEL_ROWS.items():
        check(launches[name] > 0, f"{name} was never launched on the ring path")
        check(launches[name] == per_step * (RING_STEPS + 1),
              f"{name}: {launches[name]} launches, expected {per_step} per step x {RING_STEPS + 1} "
              f"(warm-up + {RING_STEPS})")

    def one_more_step() -> None:
        step(params, state, tokens)
        torch.cuda.synchronize()

    return {name: launches[name] for name in RING_KERNEL_ROWS}, one_more_step


def phase_narrow_paths() -> dict:
    """The slice's LM at 16 and 32 heads (head sizes 32 and 16), at width 384
    over 8 heads (48) and at 4 heads (128; one round after a warm-up round),
    one round each, and the ring trainer at the same widths and heads, one
    step after a warm-up step each; returns the launches of each run under
    its rows' names (``<name>_d<D>``)."""
    shapes = [(d, EMBED // d, EMBED) for d in NARROW_HEAD_DIMS] + [(d, h, d * h) for d, h in C1_HEAD_DIMS.items()]
    return head_size_paths("narrow-paths", shapes, warm=(128,))


def head_size_paths(label: str, shapes: list, layers: int = LAYERS, warm: tuple = ()) -> dict:
    """For each ``(head size, heads, width)``: the slice's LM (``layers``
    layers) one round, after a warm-up round where the head size is in
    ``warm`` (its s/round is then a warm round's; elsewhere the kernels are
    built and checked before these paths run and the round is timed cold),
    and the ring trainer one step after a warm-up step (that step's s/step
    on the host clock, ending in ``torch.cuda.synchronize()``), with every
    count set to 0 before and read after each run; returns the launches
    under the rows' names (``<name>_d<D>``)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.sequence import make_sequence_parallel_train_step, shard_tokens
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    out: dict = {}
    for d, heads, width in shapes:
        model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=layers, num_heads=heads,
                                     embed_dim=width, attention_kind="flash", device="cuda")
        train, xt = lm_data(6)
        sim = MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE,
                             batch_size=BATCH, lr=LR, seed=1, task="lm", device="cuda")
        _kernels.reset_launches()
        runs = 2 if d in warm else 1  # the warm-up round launches as a round does
        res = sim.run(rounds=1, epochs=1, warmup=runs == 2)
        launches = dict(_kernels.LAUNCHES)
        print(f"[{label}] LM at width {width} over {heads} heads (D={d}, {layers} layers): "
              f"{res.seconds_per_round:.4f} s/round ({'after a warm-up round' if runs == 2 else 'cold'}), "
              f"test loss {res.test_loss}, kernels {json.dumps(launches)}")
        check(all(np.isfinite(res.test_loss)), f"D={d} LM: non-finite test loss")
        for name, (_, per_round, _) in KERNEL_ROWS.items():
            per_round = per_round * layers // LAYERS
            check(launches[name] == per_round * runs,
                  f"D={d} LM: {name} launched {launches[name]} times, expected {per_round} x {runs}")
            out[name + narrow_suffix(d)] = launches[name]
        del sim, model
        gc.collect()

    rng = np.random.default_rng(8)
    x = ((rng.integers(0, VOCAB, size=(RING_BATCH, 1)) + np.arange(RING_SEQ)) % VOCAB).astype(np.int32)
    mesh = Mesh({"seq": RING_SHARDS}, device="cuda")
    tokens = shard_tokens(x, mesh)
    for d, heads, width in shapes:
        model = transformer_lm_model(0, RING_SEQ, VOCAB, layers, heads, width, "ring_flash", "seq", device="cuda")
        opt = adam(LR)
        step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")
        params, state = model.params, opt.init(model.params)
        _kernels.reset_launches()
        losses = []
        for _ in range(2):  # a warm-up step and one more, timed
            torch.cuda.synchronize()
            t0 = time.monotonic()
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
        n = _kernels.LAUNCHES["flash_carry"]
        print(f"[{label}] ring at width {width} over {heads} heads (D={d}, {layers} layers): losses {losses}, "
              f"{seconds:.4f} s/step (host clock, the step after a warm-up step), flash_carry launches {n}")
        check(all(np.isfinite(losses)), f"D={d} ring: non-finite loss")
        folds = RING_FOLDS * layers // LAYERS
        check(n == folds * 2, f"D={d} ring: {n} carry launches, expected {folds} x 2")
        out["flash_carry" + narrow_suffix(d)] = n
        del model, params, state, step
        gc.collect()
    return out


def mlp_partitions() -> list:
    """bench.py's metric data (``_make_data``): class templates plus noise
    0.35 (``synthetic_mnist``), then 10 % of the train and of the test labels
    redrawn uniformly from the 10 classes (``LABEL_FLIP``, which caps the
    accuracy near 0.9), split IID over the nodes."""
    import numpy as np
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset, RandomIIDPartitionStrategy, synthetic_mnist

    data = synthetic_mnist(n_train=MLP_NODES * MLP_SAMPLES, n_test=MLP_TEST)
    (x, y), (xt, yt) = data.export_arrays(train=True), data.export_arrays(train=False)
    rng = np.random.default_rng(11)

    def flip(labels):
        redraw = rng.random(labels.shape) < MLP_LABEL_FLIP
        return np.where(redraw, rng.integers(0, 10, labels.shape), labels).astype(labels.dtype)

    flipped = FederatedDataset.from_arrays(x, flip(y), xt, flip(yt))
    return flipped.generate_partitions(MLP_NODES, RandomIIDPartitionStrategy)


def device_parity(label: str, parts: list, kwargs: dict, run_kwargs: dict, make_model=None,
                  schedule: tuple = PARITY_SCHEDULE, batch: int = MLP_BATCH, n_test: int = MLP_TEST,
                  compute: str = "float32") -> None:
    """The MLP configuration (or ``make_model(device)``'s model, built at f32
    compute) with ``kwargs`` for the rounds of ``schedule`` at f32 compute,
    on the card and on the CPU (the path the CPU tests hold to the JAX
    package). Both draw their shuffles and DP
    noise from the same seeded CPU generators and TF32 is off, so they differ
    only in the order of their f32 sums. That can still flip a ReLU whose
    pre-activation is within rounding of 0, and Adam then moves a few weights
    by up to lr on one side only, so the bar is on the whole update: node
    0's parameters differ by at most ``PARITY_RTOL`` of the L2 norm of the
    rounds' update (a dropped optimizer-state write-back or a wrong
    aggregate moves every weight, by ~lr a step). Every evaluated test loss
    within ``PARITY_LOSS_ATOL`` and every accuracy within one test sample."""
    import math
    import warnings

    import numpy as np
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    if make_model is None:
        def make_model(dev):
            return mlp_model(seed=0, device=dev)

    runs = []
    for dev in ("cuda", "cpu"):
        with Settings.overridden(COMPUTE_DTYPE=compute):
            model = make_model(dev)
        start = {k: v.detach().float().cpu() for k, v in model.params.items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # DP with a pinned seed says its epsilon is void
            sim = MeshSimulation(model, parts, train_set_size=len(schedule[0]), batch_size=batch, seed=1,
                                 device=dev, **kwargs)
        with sim:
            res = sim.run(rounds=len(schedule), epochs=1, warmup=False,
                          committee_schedule=np.asarray(schedule), **run_kwargs)
            runs.append((res, {k: v[0].cpu() for k, v in sim.params_stack.items()}))
    (card, p_card), (host, p_host) = runs
    check(len(card.test_loss) == len(host.test_loss) >= 1, f"{label}: the two runs evaluated different rounds")
    e_loss = max(abs(a - b) for a, b in zip(card.test_loss, host.test_loss))
    e_acc = max(abs(a - b) for a, b in zip(card.test_acc, host.test_acc))
    diff = {k: (p_card[k] - p_host[k]).abs() for k in p_card}
    e_par = max(float(d.max()) for d in diff.values())
    n_past = sum(int((d > 1e-5).sum()) for d in diff.values())
    update = math.sqrt(sum(float(((p_host[k] - start[k]) ** 2).sum()) for k in p_host))
    rel = math.sqrt(sum(float((d**2).sum()) for d in diff.values())) / update
    ok = rel <= PARITY_RTOL and e_loss <= PARITY_LOSS_ATOL and e_acc <= 1.0 / n_test + 1e-9
    print(f"  {label}: card against CPU, {len(schedule)} scheduled rounds at {compute}: node 0's params differ "
          f"by {rel:.3e} of the update's L2 norm {update:.4f} (tol {PARITY_RTOL:g}; max_abs_err {e_par:.3e}, "
          f"{n_past} elements past 1e-5), test loss {e_loss:.3e} (tol {PARITY_LOSS_ATOL:g}), accuracy "
          f"{e_acc:.5f} (tol 1/{n_test}) {'ok' if ok else 'FAIL'}")
    check(all(np.isfinite(card.test_loss)), f"{label}: non-finite test loss on the card")
    check(ok, f"{label}: the card's round disagrees with the CPU's")


def phase_mlp(parts: list, profiling: bool) -> None:
    """The classification round at bench.py's metric configuration (with
    ``profiling``, one more round under torch.profiler)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = mlp_model(seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    print(f"[mlp] MLP 784-256-128-10 ({n_params} params, {model.module.compute_dtype}); {MLP_NODES} nodes x "
          f"{MLP_SAMPLES} samples, committee {MLP_COMMITTEE}, batch {MLP_BATCH}")
    with MeshSimulation(model, parts, train_set_size=MLP_COMMITTEE, batch_size=MLP_BATCH, seed=1,
                        device="cuda") as sim:
        check(sim.task == "classification" and tuple(sim.x_test.shape) == (MLP_TEST, 28, 28),
              "the MLP simulation is not a classification over the 1024 test samples")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        res = sim.run(rounds=MLP_ROUNDS, epochs=1, warmup=True)
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if profiling:
            phase_profile("mlp: one round", lambda: sim.run(rounds=1, warmup=False))
    print(f"[mlp] {MLP_ROUNDS} rounds: {res.seconds_per_round:.4f} s/round ({res.seconds_total:.3f} s, host "
          f"clock ending in torch.cuda.synchronize()); {json.dumps(res.summary())}")
    print(f"[mlp] test loss per round: {res.test_loss}")
    print(f"[mlp] test accuracy per round: {res.test_acc}")
    print(f"[mlp] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB); kernels {json.dumps(launches)}")
    check(all(np.isfinite(res.test_loss)), "MLP: non-finite test loss")
    check(res.test_loss[-1] < res.test_loss[0], "MLP: test loss did not fall over the rounds")
    check(res.test_acc[-1] > 0.5, f"MLP: final test accuracy {res.test_acc[-1]} is not above 0.5")
    check(not any(launches.values()), "MLP: the classification round launched a flash kernel")
    device_parity("fedavg", parts, {}, {})


def classifier_data(seed: int) -> tuple:
    """Label-dependent tokens: class c draws its tokens from its own band of
    the vocabulary; returns the stacked train split and the test split."""
    import numpy as np

    rng = np.random.default_rng(seed)
    band = CLS_VOCAB // CLS_CLASSES

    def tokens(labels):
        return (labels[..., None] * band + rng.integers(0, band, size=labels.shape + (CLS_SEQ,))).astype(np.int32)

    y = rng.integers(0, CLS_CLASSES, size=(CLS_NODES, CLS_PER_NODE)).astype(np.int32)
    yt = rng.integers(0, CLS_CLASSES, size=CLS_TEST).astype(np.int32)
    return (tokens(y), y, np.ones(y.shape, np.float32)), (tokens(yt), yt)


def phase_classifier() -> dict:
    """The classification round of the flash TransformerClassifier; returns
    the launches of its run under the names of the rows at its shapes
    (``<name>_d32_cls``)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.transformer import transformer_classifier_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = transformer_classifier_model(seed=0, attention_kind="flash", device="cuda")
    attn = model.module.blocks[0].attn
    d = model.module.embed.weight.shape[1] // attn.num_heads
    print(f"[classifier] TransformerClassifier flash {CLS_LAYERS}L/{attn.num_heads}h/D={d}, seq {CLS_SEQ}, "
          f"{sum(p.numel() for p in model.params.values())} params; {CLS_NODES} nodes x {CLS_PER_NODE} samples")
    check(d == 32 and attn.num_heads == CLS_HEADS, f"the classifier has {attn.num_heads} heads of size {d}, "
          f"expected {CLS_HEADS} of 32")
    train, test = classifier_data(9)
    with MeshSimulation(model, train, test_data=test, train_set_size=CLS_COMMITTEE, batch_size=CLS_BATCH,
                        seed=1, device="cuda") as sim:
        _kernels.reset_launches()
        res = sim.run(rounds=CLS_ROUNDS, epochs=1, warmup=True)
        launches = dict(_kernels.LAUNCHES)
    print(f"[classifier] {CLS_ROUNDS} rounds: {res.seconds_per_round:.4f} s/round; test loss {res.test_loss}, "
          f"accuracy {res.test_acc}; kernels {json.dumps(launches)}")
    check(all(np.isfinite(res.test_loss)), "classifier: non-finite test loss")
    check(res.test_loss[-1] < res.test_loss[0], "classifier: test loss did not fall over the rounds")
    per_round = {"flash_fwd": CLS_STEPS, "flash_bwd_dq": CLS_STEPS, "flash_bwd_dkv": CLS_STEPS,
                 "flash_fwd_no_lse": CLS_LAYERS, "flash_carry": 0}
    for name, n in per_round.items():
        check(launches[name] == n * (CLS_ROUNDS + 1),
              f"classifier: {name} launched {launches[name]} times, expected {n} per round x {CLS_ROUNDS + 1}")
    return {name + CLS_SUFFIX: launches[name] for name in KERNEL_ROWS}


def phase_options(parts: list) -> None:
    """Each ported MeshSimulation option for a few rounds on the MLP
    configuration (every loss finite), then held on the card against the
    CPU (``device_parity``)."""
    import warnings

    import numpy as np
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.ops.aggregation import krum
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    byz = np.zeros(MLP_NODES, np.float32)
    byz[::10] = 1.0  # 10 % of the nodes poison their updates
    # name -> (MeshSimulation options, run options, the card-against-CPU
    # check's MeshSimulation options where they differ)
    options = {
        "scaffold": (dict(algorithm="scaffold"), {}, None),
        "fedprox": (dict(fedprox_mu=0.01), {}, None),
        "dp-sgd": (dict(dp_clip_norm=1.0, dp_noise_multiplier=0.5), {}, None),
        "fedadam": (dict(server_optimizer="fedadam", server_lr=0.01), {}, None),
        # Krum with f = 1 over 4 members scores each by its one nearest
        # neighbour: the two closest members tie exactly, and f32 rounding
        # picks between them, so the two devices' runs compare Krum at f = 0.
        "byzantine+krum": (dict(byzantine_mask=byz, aggregate_fn=lambda s, w: krum(s, w, 1)[0]), {},
                           dict(byzantine_mask=byz, aggregate_fn=lambda s, w: krum(s, w, 0)[0])),
        "clip_update_norm": (dict(clip_update_norm=1.0), {}, None),
        "eval_every=2": ({}, dict(eval_every=2), None),
    }
    for label, (kwargs, run_kwargs, parity_kwargs) in options.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # DP with a pinned seed says its epsilon is void
            sim = MeshSimulation(mlp_model(seed=0, device="cuda"), parts, train_set_size=MLP_COMMITTEE,
                                 batch_size=MLP_BATCH, seed=1, device="cuda", **kwargs)
        with sim:
            res = sim.run(rounds=OPTION_ROUNDS, epochs=1, warmup=False, **run_kwargs)
            extra = f"; privacy_spent {json.dumps(sim.privacy_spent())}" if "dp_clip_norm" in kwargs else ""
        print(f"[options] {label}: {res.seconds_per_round:.4f} s/round, test loss {res.test_loss}, "
              f"accuracy {res.test_acc}{extra}")
        check(len(res.test_loss) >= 1 and all(np.isfinite(res.test_loss)), f"{label}: non-finite test loss")
        device_parity(label, parts, kwargs if parity_kwargs is None else parity_kwargs, run_kwargs)


def phase_learner() -> tuple:
    """``TorchLearner`` fits one node of the full-width LM (one epoch of
    ``SEQS / BATCH`` steps, then ``evaluate``): exact launches, s/fit,
    s/step, peak memory, test loss before and after; then a learner whose
    model was set from the fitted model's PFLT frame and a fresh learner on
    the same weights fit to the same loss. Returns the fitted handle and its
    round-start canonical leaves (the wire phase's anchor)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels

    (x, y, _), xt = lm_data(12)
    data = FederatedDataset.from_arrays(x[0], y[0], xt, np.zeros(len(xt), np.int32))

    def lm(seed):
        return transformer_lm_model(seed=seed, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                    attention_kind="flash", device="cuda")

    def learner(model, seed):
        out = TorchLearner(model, data, "node-0", lr=LR, batch_size=BATCH, seed=seed, task="lm", device="cuda")
        out.metric_reporter = lambda name, value, step: losses.__setitem__(name, value)
        return out

    losses: dict = {}
    model = lm(0)
    start = [t.clone() for t in model.get_parameters()]
    node = learner(model, 3)
    _kernels.reset_launches()
    before = node.evaluate()
    eval_launches = dict(_kernels.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.monotonic()
    node.fit()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    fit_launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    after = node.evaluate()
    steps = SEQS // BATCH
    print(f"[learner] TorchLearner, the full-width LM on one node ({SEQS} sequences, batch {BATCH}, Adam {LR}): "
          f"{seconds:.4f} s/fit, {seconds / steps:.4f} s/step ({steps} steps), train loss {losses['train_loss']:.4f}, "
          f"peak {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"[learner] test loss {before['test_loss']:.4f} -> {after['test_loss']:.4f}, token accuracy "
          f"{before['test_acc']:.4f} -> {after['test_acc']:.4f}; fit kernels {json.dumps(fit_launches)}; "
          f"evaluate kernels {json.dumps(eval_launches)}")
    per_fit = LAYERS * steps
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(fit_launches[name] == per_fit, f"learner: {name} launched {fit_launches[name]} times in a fit, "
              f"expected {per_fit}")
    eval_batches = -(-len(xt) // BATCH)
    check(fit_launches["flash_fwd_no_lse"] == 0 and eval_launches["flash_fwd_no_lse"] == LAYERS * eval_batches,
          f"learner: evaluate launched {eval_launches['flash_fwd_no_lse']} no-lse forwards, expected "
          f"{LAYERS * eval_batches}")
    check(np.isfinite(after["test_loss"]) and after["test_loss"] < before["test_loss"],
          "learner: the test loss did not fall over the fit")

    frame = node.get_model().encode_parameters()
    framed = lm(1)
    framed.set_parameters(frame)
    refit = {}
    for label, handle in (("set from the frame", framed), ("fresh, same weights", node.get_model().build_copy())):
        learner(handle, 4).fit()
        refit[label] = losses["train_loss"]
    diff = abs(refit["set from the frame"] - refit["fresh, same weights"])
    print(f"[learner] a fit after set_parameters from the {len(frame)}-byte frame: train loss "
          f"{refit['set from the frame']:.6f}; a fresh learner on the same weights: {refit['fresh, same weights']:.6f} "
          f"(|diff| {diff:.3e}, tol 1e-5)")
    check(diff <= 1e-5, "learner: the frame-loaded model trains to another loss than the same weights in memory")
    return node.get_model(), start


def topk_leaf(leaf, start, values: str, ratio: float) -> tuple:
    """One leaf's update against its anchor through the top-k encoder that
    ``DeltaWireCodec`` runs, with a zero residual: ``(flat anchor, delta,
    idx, dequantized values, residual, seconds of the encoder, a sync after
    it)``."""
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.ops import compression as comp

    flat = start.float().reshape(-1)
    delta = leaf.float().reshape(-1) - flat
    k = comp.topk_count(delta.numel(), ratio)
    vd = values if values == "bf16" or k >= Settings.QUANT_MIN_VALUES else "bf16"
    zeros = torch.zeros_like(delta)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if vd == "bf16":
        idx, wire, resid = comp.ef_topk_encode(delta, zeros, k, "bf16")
        deq = wire.float()
    else:
        idx, q, scale, resid = comp.ef_topk_quant_encode(delta, zeros, k, 8 if vd == "int8" else 4)
        deq = q.float() * torch.tensor(scale, dtype=torch.float32, device=q.device)
    torch.cuda.synchronize()
    return flat, delta, idx, deq, resid, time.monotonic() - t0


def phase_wire(model, anchor: list) -> None:
    """The fitted LM's update against its round-start anchor through
    ``DeltaWireCodec`` as coalesced top-k bf16, int8 and int4: ms on the
    card, frame bytes and ratio against the dense f32 frame; for every leaf
    ``scatter(idx, dequant) + residual == acc`` bit for bit on the card, and
    a second codec holding the anchor decodes each frame to ``anchor +
    scatter(dequant)`` bit for bit. Dense frames round-trip bit for bit."""
    import torch
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model

    leaves = model.get_parameters()
    n_params = sum(t.numel() for t in leaves)
    check(n_params == N_PARAMS, f"wire: {n_params} parameters, expected {N_PARAMS}")
    t0 = time.monotonic()
    dense = model.encode_parameters(compression="none")
    dense_ms = (time.monotonic() - t0) * 1e3
    copy = transformer_lm_model(seed=2, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                attention_kind="flash", device="cuda")
    copy.set_parameters(dense)
    same = all(torch.equal(copy.params[n], t) for n, t in model.params.items())
    print(f"[wire] dense f32 frame: {len(dense)} bytes for {n_params} parameters, encoded in {dense_ms:.1f} ms "
          f"(host clock); decoded back bit for bit {'ok' if same else 'FAIL'}")
    check(same, "wire: the dense frame did not round-trip bit for bit")
    ratio = 0.1
    for values in ("bf16", "int8", "int4"):
        knobs = dict(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=ratio, WIRE_TOPK_VALUES=values, COALESCE_ENABLED=True)
        with Settings.overridden(**knobs):
            for attempt in ("warm-up", "timed"):  # the first encode also warms torch.topk's workspaces
                codec = DeltaWireCodec("node-0", device="cuda")
                codec.set_anchor(anchor, 0)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                blob, label = codec.encode_tagged(model, 0)
                torch.cuda.synchronize()
                ms = (time.monotonic() - t0) * 1e3
            rx = DeltaWireCodec("node-1", device="cuda")
            rx.set_anchor(anchor, 0)
            decoded, meta = rx.decode_frame(blob)
            kept, select_s = 0, 0.0
            for i, (leaf, start) in enumerate(zip(leaves, anchor)):
                flat, delta, idx, deq, resid, seconds = topk_leaf(leaf, start, values, ratio)
                select_s += seconds
                check(torch.equal(resid.index_add(0, idx, deq), delta),
                      f"wire {values}: leaf {i}: scatter(idx, dequant) + residual != acc")
                check(torch.equal(decoded[i].reshape(-1), flat.index_add(0, idx, deq)),
                      f"wire {values}: leaf {i}: the second codec's decode != anchor + scatter(dequant)")
                kept += int(idx.numel())
        print(f"[wire] topk {values} ({label}, coalesced, ratio {ratio}): {ms:.1f} ms to encode on the card (host "
              f"clock, DEFLATE of the planes included; the {len(leaves)} leaves' top-k encoders alone, a sync after "
              f"each: {select_s * 1e3:.1f} ms), {len(blob)} bytes ({len(dense) / len(blob):.2f}x smaller than the "
              f"dense f32 frame), {kept} values kept; every leaf: residual + scatter(dequant) == acc and the second "
              f"codec's decode == anchor + scatter(dequant), bit for bit ok")


# The reference's test timings (p2pfl_tpu/utils/utils.py::set_test_settings)
# for the fields the port has: a beat every 0.25 s.
TRANSPORT_TIMINGS = dict(HEARTBEAT_PERIOD=0.25, HEARTBEAT_TIMEOUT=1.5, GOSSIP_PERIOD=0.05, TTL=10,
                         GOSSIP_MESSAGES_PER_PERIOD=100, GOSSIP_MODELS_PERIOD=0.1, GOSSIP_MODELS_PER_ROUND=4,
                         GOSSIP_EXIT_ON_X_EQUAL_ROUNDS=20, GOSSIP_SEND_RETRIES=2, GOSSIP_SEND_BACKOFF=0.05,
                         CHAOS_ENABLED=False)
TRANSPORT_PEERS = 4
TRANSPORT_FAULT_SENDS = 8
TRANSPORT_CHAOS = dict(seed=7, drop_rate=0.25, duplicate_rate=0.25, delay_jitter_s=0.01)
TRANSPORT_SAMPLES = 64  # the num_samples claim of node 0's frames


def wait_for(cond, what: str, timeout: float = 60.0) -> None:
    """Poll ``cond`` every 10 ms until it holds; fail the run at ``timeout``."""
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"{what} (waited {timeout:.0f} s)")
        time.sleep(0.01)


def phase_transport(model, anchor: list, card: str) -> None:
    """The fitted full-width LM's frames between four fully connected
    in-memory protocols of the port (``comm/``) on the card, under the
    reference's test timings: node 0 sends, and each receiver decodes every
    frame on the card with its own ``DeltaWireCodec``, which holds the
    round-start anchor.

    Clean path: the dense f32 frame decodes to the fitted leaves and the
    coalesced top-k int8 frame to ``anchor + scatter(dequant)``, bit for
    bit (bytes, and ms from send to the last receiver's decode). Each
    observatory holds the other three's heartbeat digests, whose device
    memory reads the card's allocator. Seeded faults (drop 0.25, duplicate
    0.25, jitter 10 ms, seed 7; heartbeats paused, so that only the frames
    draw from node 0's decision streams): 8 dense sends to each peer arrive
    8 - drops + duplicates times, as a fresh ``ChaosPlane`` predicts; the
    fault table is the same over two runs and node 0's digest counts it. A
    Byzantine node 0: ``signflip``, ``scaled`` and ``nan`` decode to
    ``-leaves``, ``leaves * 10`` and the quiet NaN, ``inflate`` multiplies
    ``num_samples``, and ``signflip`` on the coalesced top-k bf16 frame
    decodes to ``anchor - scatter(vals)``. ``adaptive_poison`` on the card
    equals the CPU's. A traced dense send gives a ``recv:`` span parented on
    the sender's span. Teardown leaves no transport thread and an empty
    registry."""
    import threading

    import torch
    from p2pfl_tpu_torch.chaos import CHAOS, ChaosPlane
    from p2pfl_tpu_torch.chaos.plane import ADAPTIVE_LADDER, adaptive_poison
    from p2pfl_tpu_torch.comm.commands.command import Command
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.comm.memory import InMemoryCommunicationProtocol
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER, digest
    from p2pfl_tpu_torch.telemetry.flight_recorder import reset_live_recorders

    leaves = model.get_parameters()
    check(sum(t.numel() for t in leaves) == N_PARAMS and all(t.is_cuda for t in leaves),
          "transport: the fitted LM is not the full-width LM on the card")

    class Receiver(Command):
        """Decodes every weights frame on the card; keeps the last decode."""

        def __init__(self, addr: str) -> None:
            self.codec = DeltaWireCodec(addr, device="cuda")
            self.codec.set_anchor(anchor, 0)
            self.lock = threading.Lock()
            self.errors: list = []
            self.reset()

        def reset(self) -> None:
            self.delivered = self.frames = 0
            self.leaves, self.num_samples, self.done_at = None, None, 0.0

        @staticmethod
        def get_name() -> str:
            return "partial_model"

        def execute(self, source, round, *args, **kwargs) -> None:
            try:
                decoded, _ = self.codec.decode_frame(kwargs["weights"])
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - send_each fails the run on it
                self.errors.append(f"{type(e).__name__}: {e}")
                raise
            with self.lock:
                self.frames += 1
                self.leaves, self.num_samples, self.done_at = decoded, kwargs["num_samples"], time.monotonic()

    def counting(proto, rx):
        """``proto.deliver`` counting the weights frames handed to ``rx``."""
        deliver = proto.deliver

        def run(env):
            if env.payload is not None:
                with rx.lock:
                    rx.delivered += 1
            deliver(env)
        return run

    def settled() -> bool:  # every frame handed to a receiver is decoded (or failed)
        return all(rx.frames + len(rx.errors) == rx.delivered for rx in receivers)

    def send_each(env, count: int = 1) -> float:
        """Node 0 sends ``env`` ``count`` times to each peer; returns the
        host-clock ms from the first send to the last receiver's decode."""
        for rx in receivers:
            rx.reset()
        t0 = time.monotonic()
        for _ in range(count):
            for peer in peers:
                node0.send(peer.addr, env)
        wait_for(settled, "transport: a frame handed to a receiver was not decoded")
        check(not any(rx.errors for rx in receivers), f"transport: decode failed: {[rx.errors for rx in receivers]}")
        return (max(rx.done_at for rx in receivers) - t0) * 1e3

    def all_equal(got, want, what: str) -> None:
        check(got is not None and len(got) == len(want) and all(
            g.is_cuda and torch.equal(g.reshape(-1), w.reshape(-1)) for g, w in zip(got, want)), f"transport: {what}")

    def transport_threads() -> list:
        return [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(("memsrv-", "heartbeater-", "gossiper-"))]

    def traffic() -> tuple:  # (envelopes taken in, envelopes queued for gossip) over the four
        addrs = {p.addr for p in protos}
        return tuple(sum(c.value for lbl, c in REGISTRY.get(name).samples() if lbl.get("node") in addrs)
                     for name in ("p2pfl_gossip_rx_frames_total", "p2pfl_gossip_queue_depth"))

    check(not transport_threads(), f"transport: threads alive before the phase: {transport_threads()}")
    dense = model.encode_parameters(compression="none")
    frames = {}
    for values in ("int8", "bf16"):
        knobs = dict(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES=values, COALESCE_ENABLED=True)
        with Settings.overridden(**knobs):
            codec = DeltaWireCodec("node-0", device="cuda")
            codec.set_anchor(anchor, 0)
            frames[values] = codec.encode_tagged(model, 0)
    expected = {"int8": [], "bf16 signflip": []}
    for leaf, start in zip(leaves, anchor):
        flat, _, idx, deq, _, _ = topk_leaf(leaf, start, "int8", 0.1)
        expected["int8"].append(flat.index_add(0, idx, deq))
        flat, _, idx, deq, _, _ = topk_leaf(leaf, start, "bf16", 0.1)
        expected["bf16 signflip"].append(flat.index_add(0, idx, -deq))

    protos: list = []
    with Settings.overridden(**TRANSPORT_TIMINGS):
        try:
            protos = [InMemoryCommunicationProtocol() for _ in range(TRANSPORT_PEERS)]
            node0, peers = protos[0], protos[1:]
            receivers = []
            for p in peers:
                rx = Receiver(p.addr)
                p.add_command(rx)
                p.deliver = counting(p, rx)
                receivers.append(rx)
            started = time.monotonic()
            for p in protos:
                p.start()
            for i, p in enumerate(protos):
                for q in protos[i + 1:]:
                    p.connect(q.addr)
            check(all(len(p.get_neighbors(only_direct=True)) == TRANSPORT_PEERS - 1 for p in protos),
                  "transport: the four protocols are not fully connected")

            # Clean path: the dense f32 frame and the coalesced top-k int8 frame.
            env = node0.build_weights("partial_model", 0, dense, [node0.addr], TRANSPORT_SAMPLES)
            ms = [send_each(env) for _ in range(2)]
            for rx in receivers:
                all_equal(rx.leaves, leaves, "the dense frame did not decode to the fitted leaves bit for bit")
            print(f"[transport] dense f32 frame, {len(dense)} bytes, node 0 -> {len(peers)} peers: {ms[0]:.1f} ms "
                  f"(first send), {ms[1]:.1f} ms (second) from send to the last receiver's decode on the card (host "
                  f"clock); every decode == the fitted leaves bit for bit [{card}]")
            blob, label = frames["int8"]
            env = node0.build_weights("partial_model", 0, blob, [node0.addr], TRANSPORT_SAMPLES, codec=label)
            ms = [send_each(env) for _ in range(2)]
            for rx in receivers:
                all_equal(rx.leaves, expected["int8"],
                          "the top-k int8 frame did not decode to anchor + scatter(dequant) bit for bit")
            print(f"[transport] top-k int8 frame ({label}, coalesced, ratio 0.1), {len(blob)} bytes: {ms[0]:.1f} ms "
                  f"(first), {ms[1]:.1f} ms (second) from send to the last receiver's decode; every decode == anchor "
                  f"+ scatter(dequant) bit for bit [{card}]")

            # The heartbeats' digests (at least three beats since start).
            others = {p.addr: {q.addr for q in protos} - {p.addr} for p in protos}
            wait_for(lambda: time.monotonic() - started >= 3 * Settings.HEARTBEAT_PERIOD and all(
                set(p.observatory.snapshot()["peers"]) >= others[p.addr] for p in protos),
                "transport: an observatory lacks a peer's digest", timeout=20.0)
            mem = {p.addr: {q: e["mem_bytes"] for q, e in p.observatory.snapshot()["peers"].items()
                            if q in others[p.addr]} for p in protos}
            check(all(v > 0 for row in mem.values() for v in row.values()),
                  f"transport: a digest's device memory is not the card's allocator: {mem}")
            print(f"[transport] heartbeats: every observatory holds the other three's digests "
                  f"({time.monotonic() - started:.2f} s after start, a beat every {Settings.HEARTBEAT_PERIOD} s); "
                  f"device memory in node 0's digest at node 1: {mem[peers[0].addr][node0.addr] / 2**30:.2f} GiB")

            # Seeded faults, heartbeats paused: only node 0's frames draw from its streams.
            for p in protos:
                p.heartbeater.stop()
            quiet_since, last = time.monotonic(), traffic()
            while time.monotonic() - quiet_since < 0.5:  # nothing moved for half a second
                check(time.monotonic() - started < 120.0, "transport: control traffic did not settle")
                time.sleep(0.02)
                now = traffic()
                if now != last or now[1]:
                    quiet_since, last = time.monotonic(), now
            env = node0.build_weights("partial_model", 0, dense, [node0.addr], TRANSPORT_SAMPLES)
            runs = []
            for _ in range(2):
                with CHAOS.overridden(**TRANSPORT_CHAOS):
                    oracle = ChaosPlane()
                    predicted = {}
                    for peer in peers:
                        stream = [oracle.intercept(node0.addr, peer.addr) for _ in range(TRANSPORT_FAULT_SENDS)]
                        predicted[peer.addr] = sum(0 if d.drop else 1 + d.duplicates for d in stream)
                    # after the oracle: its faults count in the process-wide registry too
                    faults_before = digest.collect(node0.addr).faults_seen
                    t0 = time.monotonic()
                    send_each(env, TRANSPORT_FAULT_SENDS)
                    seconds = time.monotonic() - t0
                    counts = CHAOS.fault_counts()
                got = {p.addr: rx.frames for p, rx in zip(peers, receivers)}
                check(got == predicted, f"transport: frames received {got}, the seeded streams predict {predicted}")
                for rx in receivers:
                    if rx.frames:
                        all_equal(rx.leaves, leaves, "a frame under faults did not decode bit for bit")
                seen = digest.collect(node0.addr).faults_seen - faults_before
                check(seen == sum(counts.values()),
                      f"transport: node 0's digest saw {seen} faults, its plane counted {counts}")
                runs.append((counts, got))
                print(f"[transport] seeded faults ({TRANSPORT_CHAOS}): {TRANSPORT_FAULT_SENDS} dense sends to each "
                      f"peer, frames received {list(got.values())} (predicted {list(predicted.values())}), faults "
                      f"{counts}, node 0's digest faults_seen +{seen:.0f}; {seconds:.2f} s (host clock) [{card}]")
            check(runs[0] == runs[1], f"transport: the fault table differs between two runs: {runs}")

            # A Byzantine node 0.
            for attack in ("signflip", "scaled", "nan", "inflate"):
                CHAOS.set_byzantine(node0.addr, attack)
                try:
                    ms = send_each(env)
                finally:
                    CHAOS.clear_byzantine(node0.addr)
                for rx in receivers:
                    if attack == "signflip":
                        all_equal(rx.leaves, [-t for t in leaves], "signflip did not decode to -leaves")
                    elif attack == "scaled":
                        all_equal(rx.leaves, [t.float() * 10.0 for t in leaves], "scaled did not decode to leaves * 10")
                    elif attack == "nan":
                        check(all(g.dtype == torch.float32 and bool((g.view(torch.int32) == 0x7FC00000).all())
                                  for g in rx.leaves), "transport: nan did not decode to the quiet NaN everywhere")
                    else:
                        all_equal(rx.leaves, leaves, "inflate changed the weights")
                        check(rx.num_samples == TRANSPORT_SAMPLES * 1_000_000_000,
                              f"transport: inflate claimed {rx.num_samples} samples")
                print(f"[transport] Byzantine {attack}: {ms:.1f} ms from send (the frame corrupted on the host once "
                      f"for each peer) to the last decode; every decode bit for bit as the attack says [{card}]")
            blob, label = frames["bf16"]
            CHAOS.set_byzantine(node0.addr, "signflip")
            try:
                ms = send_each(node0.build_weights("partial_model", 0, blob, [node0.addr], TRANSPORT_SAMPLES,
                                                   codec=label))
            finally:
                CHAOS.clear_byzantine(node0.addr)
            for rx in receivers:
                all_equal(rx.leaves, expected["bf16 signflip"],
                          "signflip on the top-k bf16 frame did not decode to anchor - scatter(vals)")
            print(f"[transport] Byzantine signflip on the coalesced top-k bf16 frame ({len(blob)} bytes): {ms:.1f} ms; "
                  f"every decode == anchor - scatter(vals) bit for bit [{card}]")

            # adaptive_poison on the card against the CPU.
            for attack in ADAPTIVE_LADDER:
                for t, s in zip(leaves, anchor):
                    on_card = adaptive_poison(t, s, attack)
                    check(on_card.is_cuda and torch.equal(on_card.cpu(), adaptive_poison(t.cpu(), s.cpu(), attack)),
                          f"transport: adaptive_poison {attack} on the card differs from the CPU's")
            print(f"[transport] adaptive_poison {' / '.join(ADAPTIVE_LADDER)} of the fitted leaves against the "
                  f"anchor: the card's == the CPU's bit for bit")

            # A traced dense send.
            with TRACER.span("transport_send", node=node0.addr) as ctx:
                traced = node0.build_weights("partial_model", 0, dense, [node0.addr], TRANSPORT_SAMPLES)
            node0.send(peers[0].addr, traced)
            wait_for(lambda: [s for s in TRACER.spans() if s.parent_id == ctx.span_id],
                     "transport: no recv span for the traced send", timeout=20.0)
            spans = [s for s in TRACER.spans() if s.parent_id == ctx.span_id]
            check(len(spans) == 1 and spans[0].name == "recv:partial_model" and spans[0].node == peers[0].addr
                  and spans[0].trace_id == ctx.trace_id, f"transport: recv spans {spans}")
            print(f"[transport] traced dense send: recv:partial_model at node 1 parented on the sender's span "
                  f"({spans[0].dur_s * 1e3:.1f} ms, the decode inside it) [{card}]")
        finally:
            for p in protos:
                p.stop()
            CHAOS.reset()
    wait_for(lambda: not transport_threads(), f"transport: threads left after stop: {transport_threads()}",
             timeout=10.0)
    check(not InMemoryRegistry._servers, f"transport: the registry still holds {sorted(InMemoryRegistry._servers)}")
    reset_live_recorders()
    print("[transport] teardown: all four stopped; no memsrv / heartbeater / gossiper thread left; registry empty")


NATIVE_RUNS = 9  # encodes timed per variant, the variants in turns (the median is printed)


def phase_native(card: str, model=None) -> None:
    """Phase 12a' (see the module docstring): the native PFLT codec's build,
    the dense frame of ``model`` (the fitted full-width LM; run alone, the
    LM from seed 0, whose frame has the same shapes and bytes) through both
    encoders, decode onto the card and corruption; then the interop arm and
    the gRPC arm."""
    import importlib.util
    import os
    import statistics
    import struct
    import zlib

    import numpy as np
    import torch
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.exceptions import DecodingParamsError
    from p2pfl_tpu_torch.models.model_handle import decode_wire_frame
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops.serialization import serialize_arrays

    try:
        path, cxx = native.build()
    except Exception as e:  # noqa: BLE001 - a failed build fails the phase
        check(False, f"native: the codec did not build: {type(e).__name__}: {e}")
    check(native.native_available() and native.BUILD_ERROR is None,
          f"native: the codec did not load: {native.BUILD_ERROR}")
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[native] {cxx}; library {os.path.relpath(path, root)} ({os.path.getsize(path)} bytes), loaded")

    if model is None:
        model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                     attention_kind="flash", device="cuda")
    leaves = model.get_parameters()
    host = [t.detach().cpu() for t in leaves]
    meta = {"contributors": model.contributors, "num_samples": model.num_samples,
            "additional_info": model.additional_info}

    def encode(checksum: bool, pure: bool):
        with Settings.overridden(NO_NATIVE=pure):
            return serialize_arrays(host, meta, checksum)

    def median_ms(*fns) -> list:
        """Each of ``fns``' median ms over ``NATIVE_RUNS`` calls, the
        functions taken in turns (the host's speed drifts within a run)."""
        times: list = [[] for _ in fns]
        for _ in range(NATIVE_RUNS):
            for fn, ts in zip(fns, times):
                t0 = time.perf_counter()
                out = fn()
                ts.append((time.perf_counter() - t0) * 1e3)
                del out
        return [statistics.median(ts) for ts in times]

    native.reset_packs()
    frames = {}
    for checksum in (True, False):
        nat, pure = encode(checksum, False), encode(checksum, True)
        check(isinstance(nat, bytearray) and isinstance(pure, bytes),
              f"native: encoders returned {type(nat).__name__} / {type(pure).__name__}")
        check(nat == pure, f"native: the native and pure-Python frames differ (crc {checksum})")
        frames[checksum] = nat
    check(native.PACKS == {"native": 2, "pure": 2}, f"native: pack counts {native.PACKS}")
    frame = frames[True]
    wire = model.encode_parameters(compression="none")
    check(bytes(wire) == frame, "native: the model's dense wire frame differs from its leaves' frame")
    raws = [t.numpy() for t in host]

    def crc_payload() -> int:
        crc = 0
        for r in raws:
            crc = zlib.crc32(r.view(np.uint8).data, crc)
        return crc

    def wire_encode(pure: bool):
        with Settings.overridden(NO_NATIVE=pure):
            return model.encode_parameters(compression="none")

    variants = [(checksum, pure) for checksum in (True, False) for pure in (False, True)]
    timed = median_ms(*[lambda c=c, p=p: encode(c, p) for c, p in variants], crc_payload,
                      lambda: wire_encode(False), lambda: wire_encode(True))
    ms = dict(zip(variants, timed))
    crc_ms, wire_ms = timed[4], {False: timed[5], True: timed[6]}
    print(f"[native] the dense f32 frame ({len(host)} leaves, {len(frame)} bytes): native == pure-Python bytes "
          f"with and without CRC; median of {NATIVE_RUNS} encodes from host leaves: native {ms[True, False]:.2f} ms, "
          f"pure {ms[True, True]:.2f} ms with CRC; native {ms[False, False]:.2f} ms, pure {ms[False, True]:.2f} ms "
          f"without [{card}]")
    print(f"[native] zlib.crc32 over the payload {crc_ms:.2f} ms: {100 * crc_ms / ms[True, False]:.1f} % of the "
          f"native encode, {100 * crc_ms / ms[True, True]:.1f} % of the pure one; from the card's leaves "
          f"(encode_parameters, device-to-host copies included): native {wire_ms[False]:.2f} ms, pure "
          f"{wire_ms[True]:.2f} ms [{card}]")

    decoded, got_meta = decode_wire_frame(frame, "cuda")
    torch.cuda.synchronize()
    check(len(decoded) == len(leaves) and all(d.is_cuda and torch.equal(d, t) for d, t in zip(decoded, leaves)),
          "native: the frame decoded onto the card differs from the leaves")
    _, header_len, _ = struct.unpack_from("<HII", frame, 4)
    for label, offset in (("tensor", len(frame) // 2), ("header", 14 + header_len // 2)):
        bad = bytearray(frame)
        bad[offset] ^= 0x5A
        try:
            decode_wire_frame(bad, "cuda")
        except DecodingParamsError as e:
            print(f"[native] a flipped {label} byte (offset {offset}) fails the decode: {e}")
        else:
            check(False, f"native: a flipped {label} byte at offset {offset} decoded")
    print(f"[native] the frame decoded onto the card equals the {len(leaves)} leaves bit for bit")
    native_interop(card)
    if importlib.util.find_spec("grpc") is None or importlib.util.find_spec("google.protobuf") is None:
        print("grpc: not run on this machine (grpcio/protobuf not installed)")
    else:
        native_grpc(card, model)


INTEROP_ROUNDS = 2


def native_interop(card: str) -> None:
    """The interop arm of phase 12a': a user's ``nn.Module`` MLP in a
    canonical ``TorchModelHandle`` (the flax layout on the wire) trained by
    the interop ``TorchLearner`` on the card, and the port's zoo MLP Node on
    the card, over the in-memory wire, FedAvg, ``INTEROP_ROUNDS`` rounds."""
    import torch
    from torch import nn
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import FedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.learning.interop import TorchLearner, TorchModelHandle, torch_mlp_from_wire, torch_mlp_to_wire
    from p2pfl_tpu_torch.learning.learner import LearnerFactory
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    torch.manual_seed(24)
    user = nn.Sequential(nn.Flatten(), nn.Linear(784, 256), nn.ReLU(), nn.Linear(256, 128), nn.ReLU(),
                         nn.Linear(128, 10))
    handle = TorchModelHandle(user, to_wire=torch_mlp_to_wire, from_wire=torch_mlp_from_wire, device="cuda")
    check(LearnerFactory.create_learner(handle) is TorchLearner, "native: 'pytorch' is not the interop learner")
    parts = synthetic_mnist(n_train=2 * 512, n_test=256).generate_partitions(2, RandomIIDPartitionStrategy)
    snap = Settings.snapshot()
    nodes: list = []
    try:
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.WIRE_COMPRESSION = "none"
        Settings.HEARTBEAT_TIMEOUT = 30.0  # no node dies here: a write-off could only be a starved beat
        nodes = [Node(mlp_model(seed=0, device="cuda"), parts[0], addr="mem://interop-zoo", aggregator=FedAvg(),
                      batch_size=64, device="cuda"),
                 Node(handle, parts[1], addr="mem://interop-user", learner=TorchLearner, aggregator=FedAvg(),
                      batch_size=64, device="cuda")]
        for nd in nodes:
            nd.start()
        nodes[1].connect(nodes[0].addr)
        wait_convergence(nodes, 1, wait=30)
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=INTEROP_ROUNDS, epochs=1)
        wait_for(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes),
                 f"native: the interop federation did not finish {INTEROP_ROUNDS} rounds", timeout=300.0)
        seconds = time.monotonic() - t0
        for nd in nodes:
            check(nd.learning_workflow.history.count("RoundFinishedStage") == INTEROP_ROUNDS,
                  f"native: {nd.addr} ran {nd.learning_workflow.history}")
        zoo, mine = (nd.learner.get_model().get_parameters() for nd in nodes)
        check(all(t.is_cuda for t in mine) and next(user.parameters()).is_cuda,
              "native: the user's module did not train on the card")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(zoo, mine))
        metrics = [nd.learner.evaluate() for nd in nodes]
        print(f"[native] interop: a user nn.Module MLP (interop TorchLearner) and the zoo MLP Node, {INTEROP_ROUNDS} "
              f"rounds on the card over canonical frames in {seconds:.3f} s; final parameters max |diff| {err:.3e} "
              f"(tol 1e-5); test accuracy zoo {metrics[0]['test_acc']:.4f}, user {metrics[1]['test_acc']:.4f} [{card}]")
        check(err <= 1e-5, "native: the interop Node's final parameters differ from the zoo Node's")
    finally:
        for nd in nodes:
            nd.stop()
        InMemoryRegistry.reset()
        Settings.restore(snap)


def native_grpc(card: str, model) -> None:
    """The gRPC arm of phase 12a': two port Nodes of the full-width LM over
    localhost gRPC sockets, committee 2, ``CanonicalFedAvg``, dense frames,
    one round: both finish and commit the same hash, and rows 1-4 launch
    exactly two fits' and four evaluations' worth."""
    import numpy as np
    from p2pfl_tpu_torch.comm.grpc import GrpcCommunicationProtocol
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    (x, y, _), xt = lm_data(24)
    snap = Settings.snapshot()
    nodes: list = []
    try:
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        Settings.WIRE_COMPRESSION = "none"
        Settings.TRAIN_SET_SIZE = 2
        Settings.GRPC_TIMEOUT = 60.0  # an 84 MB frame a unary call
        Settings.HEARTBEAT_TIMEOUT = 30.0
        Settings.AGGREGATION_TIMEOUT = 120.0
        Settings.AGGREGATION_STALL_PATIENCE = 60.0
        Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        for i in range(2):
            data = FederatedDataset.from_arrays(x[i], y[i], xt, np.zeros(len(xt), np.int32))
            nodes.append(Node(model.build_copy(), data, addr="127.0.0.1", protocol=GrpcCommunicationProtocol,
                              aggregator=CanonicalFedAvg(), lr=LR, batch_size=BATCH, seed=i, task="lm",
                              device="cuda"))
        for nd in nodes:
            nd.start()
        nodes[1].connect(nodes[0].addr)
        wait_convergence(nodes, 1, wait=30)
        LEDGERS.reset()
        _kernels.reset_launches()
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=1, epochs=1)
        wait_for(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes),
                 "native: the gRPC federation did not finish its round", timeout=300.0)
        seconds = time.monotonic() - t0
        launches = dict(_kernels.LAUNCHES)
        hashes = [{e["round"]: e["hash"] for e in LEDGERS.peek(nd.addr).canonical_events()
                   if e["kind"] == "aggregate_committed"} for nd in nodes]
        per_fit, eval_batches = LAYERS * (SEQS // BATCH), -(-len(xt) // BATCH)
        expected = {name: 2 * per_fit for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        expected.update(flash_fwd_no_lse=2 * 2 * LAYERS * eval_batches, flash_carry=0)
        print(f"[native] grpc: two LM Nodes over localhost gRPC ({nodes[0].addr}, {nodes[1].addr}), one round in "
              f"{seconds:.3f} s; committed {[h.get(0) for h in hashes]}; kernels {json.dumps(launches)} [{card}]")
        check(hashes[0].get(0) is not None and hashes[0].get(0) == hashes[1].get(0),
              "native: the gRPC Nodes committed different aggregates")
        check(launches == expected, f"native: the gRPC round's flash launches differ from {expected}")
    finally:
        for nd in nodes:
            nd.stop()
        Settings.restore(snap)


# The Node federation (phase 12b): three port Nodes of the full-width LM
# on the in-memory transport, fully connected, committee 3, two rounds.
NODE_PEERS, NODE_ROUNDS, NODE_DEADLINE_S = 3, 2, 600.0


def phase_node(card: str) -> None:
    """Three port ``Node`` s on the in-memory transport, fully connected, each
    training the full-width flash LM of phase 11 on the card (64 sequences of
    1024 tokens a node from ``lm_data``, batch 8, Adam 3e-4, one epoch a
    round) through the default ``LearnerExecutor``, committee 3, dense
    frames, FedAvg in its canonical reduction order (``CanonicalFedAvg``:
    every node folds the same three models in contributor order, so the
    three aggregates are bit-equal), under the reference's test timings; two
    rounds from ``set_start_learning``. Checks: every node finishes before
    the deadline; each round's ``aggregate_committed`` hash is equal on the
    three ledgers; the final parameters are bit-identical across the nodes;
    round 0's aggregate equals, bit for bit, FedAvg recomputed on the card
    from the three fitted models' dense frames; rows 1-4 launch exactly 2
    rounds x 3 fits x phase 11's launches a fit, plus the evaluations' no-lse
    forwards (one before each fit and a final one a node); the test loss
    falls. Prints s/round (host clock), where a node's time went (stage
    seconds, and its fits' seconds on the executor's threads), peak device
    memory and frame bytes a round. Then, under phase 12a's seeded faults, one more round of the same
    federation must complete. First, the card's NaN-preserving bf16 round
    (``bf16_round``, the wire's casts) against the CPU's and the chaos
    plane's on f32 NaN payloads of both signs."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.chaos import CHAOS
    from p2pfl_tpu_torch.chaos.plane import _bf16_round
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import aggregation as agg_ops
    from p2pfl_tpu_torch.ops.compression import bf16_round
    from p2pfl_tpu_torch.telemetry import REGISTRY
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    rng = np.random.default_rng(20)
    u = rng.integers(0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    u[: 1 << 17] = (np.uint32(0x7F800001) + u[: 1 << 17] % np.uint32(0x7FFFFF)) | (u[1 << 17: 1 << 18] & np.uint32(1 << 31))
    f32 = u.view(np.float32)
    on_card = bf16_round(torch.from_numpy(f32).cuda()).view(torch.int16).cpu().numpy().view(np.uint16)
    on_cpu = bf16_round(torch.from_numpy(f32)).view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(f32)
    check(np.array_equal(on_card, on_cpu) and np.array_equal(on_cpu, _bf16_round(f32)),
          "node: the card's NaN-preserving bf16 round differs from the CPU's")
    check(set(on_card[nan]) == {0x7FC0, 0xFFC0}, f"node: NaNs round to {sorted(set(on_card[nan]))}")
    print(f"[node] bf16_round on {f32.size} f32 values ({int(nan.sum())} NaN payloads of both signs): the card's "
          f"bits equal the CPU's and the chaos plane's; NaN -> 0x7FC0 / 0xFFC0 by sign")

    (x, y, _), xt = lm_data(20)
    snap = Settings.snapshot()
    nodes: list = []
    frames: dict = {}
    fit_seconds: list = []

    def stage_seconds() -> dict:  # {stage: seconds summed over the three nodes}
        out: dict = {}
        for labels, child in REGISTRY.get("p2pfl_stage_duration_seconds").samples():
            if labels.get("node") in {nd.addr for nd in nodes}:
                out[labels["stage"]] = out.get(labels["stage"], 0.0) + child.sum
        return out
    try:
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        Settings.TRAIN_SET_SIZE = NODE_PEERS
        Settings.WIRE_COMPRESSION = "none"
        Settings.AGGREGATION_TIMEOUT = 120.0
        Settings.AGGREGATION_STALL_PATIENCE = 60.0
        # Raw per-sender models (CanonicalFedAvg): the gossip loop waits out
        # peers' fits on their coverage reports, as the parity harness's.
        Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        Settings.GOSSIP_MODELS_PER_ROUND = NODE_PEERS
        for i in range(NODE_PEERS):
            data = FederatedDataset.from_arrays(x[i], y[i], xt, np.zeros(len(xt), np.int32))
            model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                         embed_dim=EMBED, attention_kind="flash", device="cuda")
            node = Node(model, data, addr=f"mem://lm-node-{i}", aggregator=CanonicalFedAvg(), lr=LR,
                        batch_size=BATCH, seed=i, task="lm", device="cuda")
            inner = node.learner.learner  # the TorchLearner inside the executor's wrapper
            frames[node.addr] = []

            def recording_fit(fit=inner.fit, addr=node.addr):
                t_fit = time.monotonic()
                fitted = fit()  # ends on host reads of its losses: the card is done with it
                fit_seconds.append(time.monotonic() - t_fit)
                if not frames[addr]:  # round 0: the fitted model's dense frame
                    frames[addr].append(fitted.encode_parameters(compression="none"))
                return fitted

            inner.fit = recording_fit
            nodes.append(node)
        check(type(nodes[0].learner).__name__ == "VirtualNodeLearner", "node: the default executor is not in use")
        built: list = []  # commands of the dense weights frames the nodes built (one encode each)
        for nd in nodes:
            def counting_build(*args, build=nd.protocol.build_weights, **kwargs):
                env = build(*args, **kwargs)
                if env.codec == "dense":
                    built.append(env.cmd)
                return env

            nd.protocol.build_weights = counting_build
        for nd in nodes:
            nd.start()
        for i, nd in enumerate(nodes):
            for other in nodes[i + 1:]:
                nd.connect(other.addr)
        wait_convergence(nodes, NODE_PEERS - 1, wait=30)
        before = nodes[0].learner.evaluate()
        LEDGERS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        check(native.native_available(), f"node: the native codec is not loaded ({native.BUILD_ERROR})")
        native.reset_packs()
        stages_before = stage_seconds()
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=NODE_ROUNDS, epochs=1)
        wait_for(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes),
                 f"node: the federation did not finish {NODE_ROUNDS} rounds", timeout=NODE_DEADLINE_S)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = dict(_kernels.LAUNCHES)
        packs, dense_built = dict(native.PACKS), len(built)
        peak = torch.cuda.max_memory_allocated()
        stages = {k: (v - stages_before.get(k, 0.0)) / NODE_PEERS for k, v in stage_seconds().items()}
        fits = list(fit_seconds)
        after = nodes[0].learner.evaluate()
        for nd in nodes:
            check(nd.learning_workflow.history.count("RoundFinishedStage") == NODE_ROUNDS
                  and nd.learning_workflow.history.count("TrainStage") == NODE_ROUNDS,
                  f"node: {nd.addr} ran {nd.learning_workflow.history}")
        hashes = {}
        for nd in nodes:
            events = LEDGERS.peek(nd.addr).canonical_events()
            hashes[nd.addr] = {e["round"]: e["hash"] for e in events if e["kind"] == "aggregate_committed"}
        for r in range(NODE_ROUNDS):
            seen = {h.get(r) for h in hashes.values()}
            print(f"[node] round {r}: aggregate_committed {sorted(map(str, seen))} on the {NODE_PEERS} ledgers")
            check(len(seen) == 1 and None not in seen, f"node: round {r}'s committed hashes differ: {hashes}")
        leaves = [nd.learner.get_model().get_parameters() for nd in nodes]
        check(all(len(ls) == len(leaves[0]) and all(torch.equal(a, b) for a, b in zip(ls, leaves[0]))
                  for ls in leaves[1:]), "node: the final parameters differ between the nodes")
        check(all(len(f) == 1 for f in frames.values()), f"node: round-0 frames {[len(f) for f in frames.values()]}")
        template = nodes[0].learner.get_model()
        handles = sorted((template.build_copy(params=f[0]) for f in frames.values()),
                         key=lambda h: sorted(h.contributors))
        weights = torch.tensor([h.get_num_samples() for h in handles], dtype=torch.float32, device="cuda")
        recomputed = agg_ops.fedavg(agg_ops.tree_stack([h.params for h in handles]), weights)
        recomputed_hash = canonical_params_hash(template.build_copy(params=recomputed).get_parameters())
        check(recomputed_hash == hashes[nodes[0].addr][0],
              f"node: FedAvg of the fitted frames {recomputed_hash} is not round 0's aggregate "
              f"{hashes[nodes[0].addr][0]}")
        print(f"[node] round 0's aggregate == FedAvg recomputed on the card from the {NODE_PEERS} fitted models' "
              f"dense frames ({len(frames[nodes[0].addr][0])} bytes each), bit for bit")
        per_fit = LAYERS * (SEQS // BATCH)
        eval_batches = -(-len(xt) // BATCH)
        expected = {name: NODE_ROUNDS * NODE_PEERS * per_fit for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        expected["flash_fwd_no_lse"] = (NODE_ROUNDS + 1) * NODE_PEERS * LAYERS * eval_batches
        expected["flash_carry"] = 0
        print(f"[node] kernels {json.dumps(launches)} (expected {json.dumps(expected)}: {NODE_ROUNDS} rounds x "
              f"{NODE_PEERS} fits x {per_fit}, and {NODE_ROUNDS + 1} evaluations a node x {LAYERS * eval_batches})")
        check(launches == expected, "node: the flash launches differ from the federation's fits and evaluations")
        dense_sent = sum(v[0] for nd in nodes for (_, r, codec), v in nd.protocol.gossiper.wire_stats().items()
                         if codec == "dense" and r < NODE_ROUNDS)
        print(f"[node] frames through the native codec in the {NODE_ROUNDS} rounds: packs {json.dumps(packs)} "
              f"(native / pure-Python); dense frames built {dense_built} (one encode each; the init and full "
              f"models go to every peer from one encode), sent {dense_sent}")
        check(packs["native"] >= dense_built > 0 and dense_sent >= dense_built and packs["pure"] == 0,
              "node: the federation's frames did not all go through the native codec")
        check(np.isfinite(after["test_loss"]) and after["test_loss"] < before["test_loss"],
              f"node: the test loss did not fall ({before['test_loss']} -> {after['test_loss']})")
        tx = [sum(nd.protocol.gossiper.bytes_for_round(r) for nd in nodes) for r in range(NODE_ROUNDS)]
        print(f"[node] {NODE_PEERS} Nodes of the full-width LM ({N_PARAMS} parameters), {NODE_ROUNDS} rounds: "
              f"{seconds / NODE_ROUNDS:.3f} s/round (host clock, {seconds:.3f} s from set_start_learning to the last "
              f"node's finish) [{card}]")
        print(f"[node] where a node's {seconds:.3f} s went (stage seconds, mean of the {NODE_PEERS} nodes): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items(), key=lambda kv: -kv[1]))
              + f"; its {NODE_ROUNDS} fits {sum(fits) / NODE_PEERS:.3f} s ({len(fits)} fits on the executor's "
              f"threads, {min(fits):.3f}-{max(fits):.3f} s each, 0.21 s alone in phase 11) [{card}]")
        print(f"[node] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")
        print(f"[node] model-plane frame bytes a round (all nodes): {tx} [{card}]")
        print(f"[node] test loss {before['test_loss']:.4f} -> {after['test_loss']:.4f}, token accuracy "
              f"{before['test_acc']:.4f} -> {after['test_acc']:.4f}")

        with CHAOS.overridden(**TRANSPORT_CHAOS):
            t0 = time.monotonic()
            nodes[0].set_start_learning(rounds=1, epochs=1)
            wait_for(lambda: all(not nd.learning_in_progress() for nd in nodes)
                     and all(nd.learning_workflow.history.count("RoundFinishedStage") == 1 for nd in nodes),
                     "node: the federation did not finish its round under seeded faults", timeout=NODE_DEADLINE_S)
            faults = CHAOS.fault_counts()
        print(f"[node] under seeded faults ({TRANSPORT_CHAOS}): one round in {time.monotonic() - t0:.3f} s, "
              f"every node finished; faults {json.dumps(faults)}")
    finally:
        for nd in nodes:
            nd.stop()
        InMemoryRegistry.reset()
        CHAOS.reset()
        Settings.restore(snap)


# The masked federation (phase 12c): phase 12b's three LM Nodes under
# PRIVACY_SECAGG with MaskedFedAvg, and their maskless twin.
SECAGG_PRIVATE = (0x5EC4A6_0001, 0x5EC4A6_0002, 0x5EC4A6_0003)


def secagg_card_vs_cpu(card: str) -> int:
    """Phase 12c part 1: the privacy plane's full-size passes on the card
    against the CPU, on the full-width LM's leaves. Three planes a device
    with fixed keys, committee 3; node 0's leaves are the initial model
    plus seeded noise (a NaN, an inf and values past the clamp in the
    first leaf). Over two rounds of error feedback, ``mask_own`` on the
    card gives node 0 the CPU's lattice bytes for every leaf and the CPU's
    residual bits, and ``finalize`` of the committee's merged lattices
    gives the CPU's parameter bits. Returns the bytes of a masked frame and
    of the model's dense f32 frame."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.learning.aggregators import MaskedFedAvg
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.privacy import PairwiseMasker, PrivacyPlane

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda")
    anchor = [t.cpu() for t in model.get_parameters()]
    dense = len(model.encode_parameters(compression="none"))
    n_params = sum(t.numel() for t in anchor)
    gen = torch.Generator().manual_seed(21)
    committee = [f"mem://secagg-{i}" for i in range(NODE_PEERS)]
    leaves = {a: [t + 1e-3 * torch.randn(t.shape, generator=gen) for t in anchor] for a in committee}
    first = leaves[committee[0]][0].view(-1)
    first[:4] = torch.tensor([float("nan"), float("inf"), 3.0, -3.0])
    planes = {}
    for dev in ("cuda", "cpu"):
        planes[dev] = {a: PrivacyPlane(a, device=dev) for a in committee}
        for i, a in enumerate(committee):
            planes[dev][a].masker = PairwiseMasker(a, _private=SECAGG_PRIVATE[i])
        for a in committee:
            for b in committee:
                if a != b:
                    planes[dev][a].learn_key(b, planes[dev][b].key_payload())
    anchors = {"cuda": [t.cuda() for t in anchor], "cpu": anchor}
    handles = {dev: {a: ModelHandle([t.to(dev) for t in leaves[a]], contributors=[a], num_samples=SEQS)
                     for a in committee} for dev in ("cuda", "cpu")}
    agg = MaskedFedAvg()
    agg.set_addr(committee[0])
    mask_ms, final_ms = [], []
    for rnd in (0, 1):
        masked = {}
        for dev in ("cuda", "cpu"):
            for a in committee if dev == "cuda" else committee[:1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                masked[dev, a] = planes[dev][a].mask_own(handles[dev][a], anchors[dev], rnd, committee)
                torch.cuda.synchronize()
                if dev == "cuda":
                    mask_ms.append((time.perf_counter() - t0) * 1e3)
        a0 = committee[0]
        got, want = masked["cuda", a0].get_parameters(), masked["cpu", a0].get_parameters()
        check(len(got) == len(want) == len(anchor), f"secagg: {len(got)} / {len(want)} lattices for {len(anchor)} leaves")
        for i, (x, y) in enumerate(zip(got, want)):
            check(x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"secagg: round {rnd} leaf {i}: the card's "
                  f"lattice differs from the CPU's")
        for i, (x, y) in enumerate(zip(planes["cuda"][a0].residual(), planes["cpu"][a0].residual())):
            check(torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)),
                  f"secagg: round {rnd} leaf {i}: the card's residual bits differ from the CPU's")
        merged = agg.aggregate([masked["cuda", a] for a in committee])
        outs = {}
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[dev], outcome = planes[dev][a0].finalize(merged, committee, anchors[dev], anchor_round=rnd)
            torch.cuda.synchronize()
            if dev == "cuda":
                final_ms.append((time.perf_counter() - t0) * 1e3)
            check(outcome == "ok", f"secagg: round {rnd}: finalize on the {dev} gave {outcome}")
        for i, (x, y) in enumerate(zip(outs["cuda"], outs["cpu"])):
            check(x.is_cuda and torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)),
                  f"secagg: round {rnd} leaf {i}: finalize's parameter bits on the card differ from the CPU's")
        anchors = {"cuda": outs["cuda"], "cpu": outs["cpu"]}
    frame = len(PrivacyPlane.encode_frame(masked["cuda", committee[0]]))
    k = sum(masked["cuda", committee[0]].additional_info["__masked__"]["ks"])
    print(f"[secagg] card vs CPU on the full-width LM's {len(anchor)} leaves ({n_params} parameters), committee "
          f"{NODE_PEERS}, two rounds: mask_own's lattice bytes and residual bits, and finalize's parameter bits, "
          f"equal on every leaf; {k} values a frame, {frame} bytes, {dense / frame:.1f}x smaller than the "
          f"{dense}-byte dense f32 frame")
    print(f"[secagg] mask_own {np.median(mask_ms):.1f} ms (median of {len(mask_ms)}, {min(mask_ms):.1f}-"
          f"{max(mask_ms):.1f}), finalize {np.median(final_ms):.1f} ms (median of {len(final_ms)}) on the card, host "
          f"clock: support, mask streams and packing on the host included [{card}]")
    return frame, dense


def secagg_federation(mask: bool, card: str) -> dict:
    """Phase 12c part 2: phase 12b's three LM Nodes (model, data, seeds and
    settings) under ``PRIVACY_SECAGG`` with the default aggregator
    (``MaskedFedAvg``) and executor, committee 3, two rounds; ``mask=False``
    runs the identical lattice pipeline with a zero mask. Returns each
    round's committed hashes, outcomes, launches, s/round, frame bytes a
    round and peak memory."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.privacy import PrivacyPlane
    from p2pfl_tpu_torch.telemetry import REGISTRY
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    (x, y, _), xt = lm_data(20)
    snap = Settings.snapshot()
    mask_own = PrivacyPlane.mask_own
    nodes: list = []
    fitted: dict = {}
    try:
        if not mask:
            PrivacyPlane.mask_own = lambda self, *a, **kw: mask_own(self, *a, **{**kw, "mask": False})
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        Settings.TRAIN_SET_SIZE = NODE_PEERS
        Settings.WIRE_COMPRESSION = "none"
        Settings.AGGREGATION_TIMEOUT = 120.0
        Settings.AGGREGATION_STALL_PATIENCE = 60.0
        Settings.PRIVACY_SECAGG = True

        def outcome_counts() -> dict:
            fam = REGISTRY.get("p2pfl_privacy_masked_rounds_total")
            return {(lbl["node"], lbl["outcome"]): int(c.value) for lbl, c in (fam.samples() if fam else [])}

        outcomes_before = outcome_counts()
        for i in range(NODE_PEERS):
            data = FederatedDataset.from_arrays(x[i], y[i], xt, np.zeros(len(xt), np.int32))
            model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                         embed_dim=EMBED, attention_kind="flash", device="cuda")
            node = Node(model, data, addr=f"mem://secagg-{i}", lr=LR, batch_size=BATCH, seed=i, task="lm",
                        device="cuda")
            inner = node.learner.learner  # the TorchLearner inside the executor's wrapper

            def recording_fit(fit=inner.fit, addr=node.addr):
                out = fit()
                fitted.setdefault(addr, []).append(canonical_params_hash(out.get_parameters()))
                return out

            inner.fit = recording_fit
            nodes.append(node)
        check(type(nodes[0].aggregator).__name__ == "MaskedFedAvg", "secagg: the default aggregator is not "
              "MaskedFedAvg")
        for nd in nodes:
            nd.start()
        for i, nd in enumerate(nodes):
            for other in nodes[i + 1:]:
                nd.connect(other.addr)
        wait_convergence(nodes, NODE_PEERS - 1, wait=30)
        LEDGERS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=NODE_ROUNDS, epochs=1)
        wait_for(lambda: all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes),
                 f"secagg: the masked federation did not finish {NODE_ROUNDS} rounds", timeout=NODE_DEADLINE_S)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for nd in nodes:
            check(nd.learning_workflow.history.count("RoundFinishedStage") == NODE_ROUNDS,
                  f"secagg: {nd.addr} ran {nd.learning_workflow.history}")
        hashes = {}
        for nd in nodes:
            events = LEDGERS.peek(nd.addr).canonical_events()
            hashes[nd.addr] = {e["round"]: e["hash"] for e in events if e["kind"] == "aggregate_committed"}
        outcomes = {k: v - outcomes_before.get(k, 0) for k, v in outcome_counts().items()
                    if v - outcomes_before.get(k, 0)}
        return {"hashes": hashes, "outcomes": outcomes, "launches": launches, "seconds": seconds, "peak": peak,
                "fitted": fitted, "tx": [sum(nd.protocol.gossiper.bytes_for_round(r) for nd in nodes)
                                         for r in range(NODE_ROUNDS)],
                "codecs": nodes[0].protocol.gossiper.bytes_by_codec()}
    finally:
        PrivacyPlane.mask_own = mask_own
        for nd in nodes:
            nd.stop()
        InMemoryRegistry.reset()
        Settings.restore(snap)


def phase_secagg(card: str) -> None:
    """Phase 12c: the privacy plane on the card. Part 1
    (:func:`secagg_card_vs_cpu`): the full-size passes on the card give the
    CPU's bytes. Part 2 (:func:`secagg_federation`): the masked three-Node
    federation, then its maskless twin: each round's committed hash equal on
    the three ledgers of each run and between the two runs; every node
    counts finalize outcome ``ok`` for every round (a ``range`` outcome
    fails the phase and says so); rows 1-4 launch exactly as in phase 12b
    in both runs. Prints s/round, frame bytes a round beside phase 12b's,
    and peak memory."""
    frame, dense = secagg_card_vs_cpu(card)
    runs = {mask: secagg_federation(mask, card) for mask in (True, False)}
    per_fit = LAYERS * (SEQS // BATCH)
    eval_batches = -(-EVAL_SEQS // BATCH)
    expected = {name: NODE_ROUNDS * NODE_PEERS * per_fit for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    expected["flash_fwd_no_lse"] = (NODE_ROUNDS + 1) * NODE_PEERS * LAYERS * eval_batches
    expected["flash_carry"] = 0
    for mask, run in runs.items():
        label = "masked" if mask else "maskless twin"
        for r in range(NODE_ROUNDS):
            seen = {h.get(r) for h in run["hashes"].values()}
            print(f"[secagg] {label}, round {r}: aggregate_committed {sorted(map(str, seen))} on the "
                  f"{NODE_PEERS} ledgers")
            check(len(seen) == 1 and None not in seen, f"secagg: {label}: round {r}'s hashes differ: {run['hashes']}")
        ranged = {k: v for k, v in run["outcomes"].items() if k[1] == "range"}
        check(not ranged, f"secagg: {label}: finalize counted outcome range {ranged}: a member's lattice entered a "
              f"sum twice or a mask share failed to cancel (outcomes {run['outcomes']})")
        want = {(f"mem://secagg-{i}", "ok"): NODE_ROUNDS for i in range(NODE_PEERS)}
        check(run["outcomes"] == want, f"secagg: {label}: finalize outcomes {run['outcomes']}, expected {want}")
        print(f"[secagg] {label}: kernels {json.dumps(run['launches'])} (expected {json.dumps(expected)})")
        check(run["launches"] == expected, f"secagg: {label}: the flash launches differ from the fits and evaluations")
        print(f"[secagg] {label}: {NODE_PEERS} Nodes of the full-width LM, {NODE_ROUNDS} rounds: "
              f"{run['seconds'] / NODE_ROUNDS:.3f} s/round (host clock) [{card}]")
        print(f"[secagg] {label}: model-plane frame bytes a round (all nodes) {run['tx']}, by codec "
              f"{json.dumps(run['codecs'])} (node 0); a masked frame {frame} bytes against the {dense}-byte dense "
              f"frame of phase 12b [{card}]")
        print(f"[secagg] {label}: peak device memory {run['peak']} bytes ({run['peak'] / 2**30:.2f} GiB) [{card}]")
    masked, twin = runs[True], runs[False]
    if masked["fitted"] != twin["fitted"]:
        print(f"[secagg] the two runs' fitted models differ: {masked['fitted']} vs {twin['fitted']}")
    for r in range(NODE_ROUNDS):
        a = masked["hashes"]["mem://secagg-0"][r]
        b = twin["hashes"]["mem://secagg-0"][r]
        check(a == b, f"secagg: round {r}: the masked aggregate {a} differs from its maskless twin's {b}")
    print(f"[secagg] masked == maskless twin bit for bit, every round ({NODE_ROUNDS}), on all {NODE_PEERS} nodes; "
          f"outcome ok everywhere")


# The recovery phase (phase 12d): slice 1's LM, data and seed resumed from a
# checkpoint; a journaled LM Node; phase 12b's federation with a crash.
RECOVERY_ROUNDS, RECOVERY_KILL = 4, 2  # the control's rounds; the victim's before its save
RECOVERY_NODE_ROUNDS = 3
RECOVERY_AGG_TIMEOUT_S, RECOVERY_STALL_S = 60.0, 15.0


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def recovery_resume(card: str, root: str) -> None:
    """Phase 12d part A: a control ``MeshSimulation`` (phase 3's LM, data and
    seed) runs ``RECOVERY_ROUNDS`` rounds; a victim of the same spec runs
    ``RECOVERY_KILL`` rounds under ``run(checkpointer=, checkpoint_every=1)``
    (an ``FLCheckpointer`` with ``max_to_keep=2``) and is dropped (its save is
    also timed apart, host copy and write, into a directory removed after); a bare step
    directory ``9`` and a marker-only ``7`` are planted; a third simulation
    built with another seed ``load_from`` s the checkpoint and runs the rest.
    Checks: the seed adopted, the committees and test losses equal to the
    control's, all 8 nodes' parameters bit-identical to the control's, rows
    1-4 launched exactly per-round counts x rounds run."""
    import os
    import shutil

    import numpy as np
    import torch
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda")
    train, xt = lm_data(5)

    def make(seed: int = 1):
        return MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE, batch_size=BATCH, lr=LR,
                              seed=seed, task="lm", device="cuda")

    def node_hashes(sim) -> list:
        return [canonical_params_hash({k: v[i] for k, v in sim.params_stack.items()}) for i in range(NODES)]

    _kernels.reset_launches()
    control = make()
    ref = control.run(rounds=RECOVERY_ROUNDS, warmup=False)
    want = node_hashes(control)
    control.close()
    del control
    gc.collect()

    ck_dir = os.path.join(root, "sim")
    ck = FLCheckpointer(ck_dir, max_to_keep=2)
    victim = make()
    part1 = victim.run(rounds=RECOVERY_KILL, warmup=False, checkpointer=ck, checkpoint_every=1)
    ck.wait()
    steps = ck.all_steps()
    step_bytes = dir_bytes(os.path.join(ck_dir, str(steps[-1])))
    # The save alone, timed apart: the host copy (save_to returns once every
    # leaf is on the host) and the write (wait joins the writer thread).
    times = []
    with FLCheckpointer(os.path.join(root, "timing"), max_to_keep=1) as tck:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            victim.save_to(tck)
            t1 = time.monotonic()
            tck.wait()
            times.append((t1 - t0, time.monotonic() - t1))
    shutil.rmtree(os.path.join(root, "timing"))
    victim.close()
    del victim
    ck.close()
    gc.collect()

    os.makedirs(os.path.join(ck_dir, "9"))  # a crash before the commit marker
    os.makedirs(os.path.join(ck_dir, "7"))  # a marker whose payload never landed
    open(os.path.join(ck_dir, "7", "_CHECKPOINT_METADATA"), "w").close()
    healed = make(seed=12345)
    t0 = time.monotonic()
    restored = healed.load_from(FLCheckpointer(ck_dir, max_to_keep=2))
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    check(restored == RECOVERY_KILL, f"recovery: load_from restored {restored} rounds, expected {RECOVERY_KILL}")
    check(healed.seed == 1, f"recovery: the checkpoint's seed was not adopted ({healed.seed})")
    part2 = healed.run(rounds=RECOVERY_ROUNDS - RECOVERY_KILL, warmup=False)
    got = node_hashes(healed)
    launches = dict(_kernels.LAUNCHES)
    healed.close()
    del healed
    gc.collect()

    committees = np.concatenate([part1.committees, part2.committees])
    print(f"[recovery] committees: control {ref.committees.tolist()}, victim + resumed {committees.tolist()}")
    check(np.array_equal(committees, ref.committees), "recovery: the resumed committees differ from the control's")
    losses = part1.test_loss + part2.test_loss
    print(f"[recovery] test loss: control {ref.test_loss}, victim + resumed {losses}")
    check(losses == ref.test_loss, "recovery: the resumed test losses differ from the control's")
    check(got == want, f"recovery: the resumed params differ from the control's: {got} vs {want}")
    print(f"[recovery] all {NODES} nodes' params after {RECOVERY_ROUNDS} rounds bit-identical to the control's "
          f"({want[0]}); steps on disk {steps}, torn 9 / 7 skipped, the seed adopted")
    ran = RECOVERY_ROUNDS * 2
    for name, (_, per_round, _) in KERNEL_ROWS.items():
        check(launches.get(name) == per_round * ran,
              f"recovery: {name}: {launches.get(name)} launches, expected {per_round} per round x {ran}")
    print(f"[recovery] kernels {json.dumps(launches)} ({ran} rounds: control {RECOVERY_ROUNDS}, victim "
          f"{RECOVERY_KILL}, resumed {RECOVERY_ROUNDS - RECOVERY_KILL})")
    n_state = sum(v.numel() for v in model.params.values()) * NODES * 3
    print(f"[recovery] a step {step_bytes} bytes ({step_bytes / 2**30:.3f} GiB: {NODES} nodes x params + Adam mu / "
          f"nu, {n_state} f32); save: host copy {', '.join(f'{c * 1e3:.1f}' for c, _ in times)} ms, write (wait) "
          f"{', '.join(f'{w * 1e3:.1f}' for _, w in times)} ms; load_from {load_s * 1e3:.1f} ms [{card}]")
    print(f"[recovery] s/round: control {ref.seconds_per_round:.4f}, victim with a save every round "
          f"{part1.seconds_per_round:.4f}, resumed {part2.seconds_per_round:.4f} (host clock) [{card}]")


def recovery_journal(card: str, root: str) -> None:
    """Phase 12d part B: one port Node of the full-width LM on the card under
    ``WIRE_COMPRESSION="topk"`` with an anchor and error-feedback residuals
    (one perturbed model encoded), journaled and brought back by
    ``Node.resume(..., device="cuda")``: params, anchor, residuals,
    ``anchor_crc`` and the privacy keys bit-exact, the params on the card."""
    import os

    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.management.checkpoint import NodeJournal
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.node import Node

    (x, y, _), xt = lm_data(20)
    data = FederatedDataset.from_arrays(x[0], y[0], xt, np.zeros(len(xt), np.int32))

    def lm(seed: int):
        return transformer_lm_model(seed=seed, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                    embed_dim=EMBED, attention_kind="flash", device="cuda")

    kw = dict(lr=LR, batch_size=BATCH, seed=0, task="lm", device="cuda", executor=False)
    snap = Settings.snapshot()
    try:
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LOG_LEVEL = "WARNING"
        node = Node(lm(0), data, addr="mem://recovery-journal", **kw)
        node.state.set_experiment("journal", 5)
        node.state.experiment.round = 2
        with Settings.overridden(WIRE_COMPRESSION="topk"):
            model = node.learner.get_model()
            node.state.wire.set_anchor(model.get_parameters(), 2)
            moved = model.build_copy(params=[p + 0.01 for p in model.get_parameters()])
            check(node.state.wire.encode_model(moved, 2) is not None, "journal: the top-k encode fell back to dense")
        before = node.state.wire.export_state()
        with NodeJournal(os.path.join(root, "journal")) as journal:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            check(journal.snapshot(node), "journal: the snapshot was not taken")
            t1 = time.monotonic()
            journal.wait()
            t2 = time.monotonic()
            nbytes = dir_bytes(os.path.join(journal.directory, "2"))
            restored = Node.resume(lm(99), data, journal, **kw)
            t3 = time.monotonic()
        check(restored.addr == node.addr, f"journal: resumed as {restored.addr}, not {node.addr}")
        after = restored.state.wire.export_state()
        check(after["anchor_round"] == 2 and after["anchor_crc"] == before["anchor_crc"],
              f"journal: anchor round / crc {after['anchor_round']} / {after['anchor_crc']}")
        for part in ("anchor", "residual"):
            check(all(np.array_equal(a, b) for a, b in zip(before[part], after[part]))
                  and len(before[part]) == len(after[part]), f"journal: the {part} did not come back bit-exact")
        check(any(np.any(r != 0) for r in after["residual"]), "journal: the residuals are all zero")
        mine, theirs = node.learner.get_model().get_parameters(), restored.learner.get_model().get_parameters()
        check(all(b.is_cuda and torch.equal(a, b) for a, b in zip(mine, theirs)),
              "journal: the params did not come back bit-exact on the card")
        check(restored.state.privacy.export_state() == node.state.privacy.export_state(),
              "journal: the privacy key material differs")
        print(f"[recovery] journal round trip on the card: params ({len(mine)} leaves), anchor, residuals, anchor_crc "
              f"{after['anchor_crc']} and privacy keys bit-exact; snapshot {(t1 - t0) * 1e3:.1f} ms (host copies) + "
              f"{(t2 - t1) * 1e3:.1f} ms (write), {nbytes} bytes; Node.resume {(t3 - t2) * 1e3:.1f} ms [{card}]")
    finally:
        Settings.restore(snap)


def recovery_crash(card: str, root: str) -> None:
    """Phase 12d part C: phase 12b's three LM Nodes (model, seeds, executor,
    timings, ``CanonicalFedAvg``; committee 3, ``RECOVERY_NODE_ROUNDS``
    rounds) with a journal each. Once node 2 has journaled it crashes and
    comes back through ``Node.resume(..., device="cuda")``, ``start()`` and
    ``resume_learning()``. Checks: the resumed Node has the victim's
    address, its history starts with ``ResumeStage`` and holds a
    ``TrainStage`` and a ``RoundFinishedStage``; every node finishes before
    the deadline; node 0's test loss is finite and below its loss before
    training; the three final parameter sets are bit-equal, or, where the
    fleet closed a round the resumed Node sat out (the JAX package ends the
    same way on the CPU: ROADMAP, queue C, "Seen in both packages"), each
    node's final params hash is the last one its own ledger committed.
    Prints s/round, journal ms a round, the time from ``crash()`` to the
    resumed Node's first ``TrainStage`` and peak memory."""
    import os

    import numpy as np
    import torch
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.management.checkpoint import NodeJournal, attach_node_journal
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    (x, y, _), xt = lm_data(20)

    def lm(seed: int = 0):
        return transformer_lm_model(seed=seed, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                                    embed_dim=EMBED, attention_kind="flash", device="cuda")

    def kw(i: int) -> dict:
        return dict(aggregator=CanonicalFedAvg(), lr=LR, batch_size=BATCH, seed=i, task="lm", device="cuda")

    datas = [FederatedDataset.from_arrays(x[i], y[i], xt, np.zeros(len(xt), np.int32)) for i in range(NODE_PEERS)]
    snap = Settings.snapshot()
    nodes: list = []
    journals: list = []
    journal_s: list = []
    try:
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        Settings.TRAIN_SET_SIZE = NODE_PEERS
        Settings.WIRE_COMPRESSION = "none"
        Settings.AGGREGATION_TIMEOUT = RECOVERY_AGG_TIMEOUT_S
        Settings.AGGREGATION_STALL_PATIENCE = RECOVERY_STALL_S
        Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        Settings.GOSSIP_MODELS_PER_ROUND = NODE_PEERS
        for i in range(NODE_PEERS):
            node = Node(lm(), datas[i], addr=f"mem://crash-{i}", **kw(i))
            journal = NodeJournal(os.path.join(root, f"j{i}"))
            snapshot = journal.snapshot

            def timed(nd, snapshot=snapshot):
                t0 = time.monotonic()
                out = snapshot(nd)
                journal_s.append(time.monotonic() - t0)
                return out

            journal.snapshot = timed
            attach_node_journal(node, journal)
            nodes.append(node)
            journals.append(journal)
        for nd in nodes:
            nd.start()
        for i, nd in enumerate(nodes):
            for other in nodes[i + 1:]:
                nd.connect(other.addr)
        wait_convergence(nodes, NODE_PEERS - 1, wait=30)
        before = nodes[0].learner.evaluate()
        fresh = lm(99)  # the restarted process's model, built before the crash
        LEDGERS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=RECOVERY_NODE_ROUNDS, epochs=1)
        wait_for(lambda: bool(journals[2].all_steps()), "recovery: the victim never journaled", timeout=NODE_DEADLINE_S)
        victim = nodes[2]
        t_crash = time.monotonic()
        victim.crash()
        journals[2].wait()
        resumed = Node.resume(fresh, datas[2], journals[2], **kw(2))
        t_resumed = time.monotonic()
        check(resumed.addr == victim.addr, f"recovery: resumed as {resumed.addr}, not {victim.addr}")
        resumed.start()
        resumed.resume_learning()
        nodes[2] = resumed
        first_train: list = []

        def finished() -> bool:
            wf = resumed.learning_workflow
            if not first_train and wf is not None and "TrainStage" in wf.history:
                first_train.append(time.monotonic() - t_crash)
            return all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes)

        wait_for(finished, "recovery: the federation did not finish after the crash", timeout=NODE_DEADLINE_S)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(_kernels.LAUNCHES)
        history = resumed.learning_workflow.history
        print(f"[recovery] resumed {resumed.addr} history {history}")
        check(history[0] == "ResumeStage" and history.count("TrainStage") >= 1
              and history.count("RoundFinishedStage") >= 1, f"recovery: the resumed Node ran {history}")
        after = nodes[0].learner.evaluate()
        check(np.isfinite(after["test_loss"]) and after["test_loss"] < before["test_loss"],
              f"recovery: the test loss did not fall ({before['test_loss']} -> {after['test_loss']})")
        finals = {nd.addr: canonical_params_hash(nd.learner.get_model().get_parameters()) for nd in nodes}
        commits = {}
        for nd in nodes:
            events = LEDGERS.peek(nd.addr).canonical_events()
            commits[nd.addr] = {e["round"]: e["hash"] for e in events if e["kind"] == "aggregate_committed"}
            print(f"[recovery] {nd.addr}: committed {sorted(commits[nd.addr].items())}, final {finals[nd.addr]}")
        if len(set(finals.values())) == 1:
            print(f"[recovery] the three final parameter sets are bit-equal ({next(iter(finals.values()))})")
        else:
            for addr, final in finals.items():
                last = commits[addr][max(commits[addr])] if commits[addr] else None
                check(final == last, f"recovery: {addr}'s final params {final} are not its last commit {last}")
            print("[recovery] the fleet closed a round the resumed Node sat out: each node's final params are the "
                  "last aggregate its own ledger committed (as the JAX package ends on the CPU)")
        print(f"[recovery] kernels {json.dumps(launches)} (rows 1-4 over the fits and evaluations of the crash run)")
        print(f"[recovery] {NODE_PEERS} LM Nodes, {RECOVERY_NODE_ROUNDS} rounds with a crash and Node.resume: "
              f"{seconds / RECOVERY_NODE_ROUNDS:.3f} s/round (host clock, {seconds:.3f} s); journal snapshots "
              f"{len(journal_s)}, {np.mean(journal_s) * 1e3:.1f} ms each (host copies; the write on its thread); "
              f"crash -> Node.resume {(t_resumed - t_crash) * 1e3:.1f} ms, crash -> first TrainStage of the resumed "
              f"Node {first_train[0] if first_train else float('nan'):.3f} s; peak device memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB) [{card}]")
    finally:
        for nd in nodes:
            nd.stop()
        for journal in journals:
            journal.close()
        InMemoryRegistry.reset()
        Settings.restore(snap)


def phase_recovery(card: str) -> None:
    """Phase 12d: checkpoint and recovery on the card (parts A-C:
    :func:`recovery_resume`, :func:`recovery_journal`,
    :func:`recovery_crash`), under a temporary root that the phase removes
    (also the working directory meanwhile, so the flight recorders' crash and
    stall dumps land there); prints the bytes written."""
    import os
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="p2pfl_recovery_")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        recovery_resume(card, root)
        gc.collect()
        recovery_journal(card, root)
        gc.collect()
        recovery_crash(card, root)
        print(f"[recovery] bytes under the temporary root at the end: {dir_bytes(root)}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


# The population phase (phase 12e): bench.py --population's engine and
# recovery arms (POP_BENCH_NODES / _COHORT, seed 42; POP_BENCH_ROUNDS' 10
# rounds cut to 4, to keep the whole smoke within its time limit).
# POP_ROUNDS: bench.py --population's 10 rounds, cut to 2 for the whole
# smoke's time limit (phase_sharded runs the same engine over ranks).
POP_NODES, POP_COHORT, POP_ROUNDS, POP_SEED = 100_000, 0.01, 2, 42
POP_REC_NODES, POP_REC_ROUNDS, POP_REC_KILL = 256, 6, 3


def phase_population(card: str) -> None:
    """Phase 12e: the sync population engine on the card. Engine arm:
    ``PopulationEngine(100_000, cohort_fraction=0.01, speed_tiers=(1, 1, 1,
    2, 5))`` at the bench's seed with the ledger attached, 2 rounds: the
    mean cohort fill times n equals K (1,000) within 1e-6, every snapshot
    peer but the observer's own row carries ``cohort_fill``, the final accuracy is finite; s/round, the
    host time of the schedules, ``fleet_health`` and the snapshot, peak
    memory. Recovery arm (n 256, cohort 0.25, seed + 1): a control runs 6
    rounds; a victim runs 3, ``save_to`` s and is closed; a fresh engine
    ``load_from`` s (-> 3) and runs 3 more: node 0's canonical hash equal to
    the control's, the accuracy delta exactly 0.0 pp, the replayed cohort
    fill equal."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population import PopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

    root = tempfile.mkdtemp(prefix="p2pfl_population_")
    snap_settings = Settings.snapshot()
    try:
        Settings.LEDGER_ENABLED = True
        LEDGERS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        eng = PopulationEngine(POP_NODES, cohort_fraction=POP_COHORT, seed=POP_SEED,
                               speed_tiers=(1.0, 1.0, 1.0, 2.0, 5.0), device="cuda")
        build_s = time.monotonic() - t0
        try:
            sched_s: list = []
            schedule = eng.schedule

            def timed_schedule(rounds: int):
                t = time.monotonic()
                out = schedule(rounds)
                sched_s.append(time.monotonic() - t)
                return out

            eng.schedule = timed_schedule
            led = eng.attach_ledger(run_id=f"population-n{POP_NODES}")
            res = eng.run(POP_ROUNDS, epochs=1)
            t = time.monotonic()
            eng.sim.fleet_health(res)
            health_s = time.monotonic() - t
            t = time.monotonic()
            snap = eng.snapshot(res, path=os.path.join(root, "federation_snapshot.json"))
            snap_s = time.monotonic() - t
            fill = eng.cohort_fill()
            k = eng.cohort_k
            commits = sum(1 for e in led.canonical_events() if e["kind"] == "aggregate_committed")
            peak = torch.cuda.max_memory_allocated()
        finally:
            eng.close()
            del eng
            gc.collect()
        check(abs(float(fill.mean()) * POP_NODES - k) <= 1e-6,
              f"population: mean cohort fill {fill.mean()} x {POP_NODES} != K {k}")
        shown = [p.get("cohort_fill") for name, p in snap["peers"].items() if name != "population-engine"]
        check(bool(shown) and all(v is not None for v in shown), f"population: snapshot peers lack cohort_fill {shown[:4]}")
        check(bool(np.isfinite(res.test_acc[-1])), f"population: final accuracy {res.test_acc[-1]}")
        print(f"[population] n={POP_NODES}, K={k}, {POP_ROUNDS} rounds: {res.seconds_per_round:.4f} s/round (host "
              f"clock; build {build_s:.2f} s); accuracy per round {[round(a, 4) for a in res.test_acc]}; mean fill x n "
              f"= {float(fill.mean()) * POP_NODES:.6f}; {len(shown)} snapshot peers with cohort_fill; "
              f"{commits} aggregate_committed events left in the ledger's ring of "
              f"{Settings.LEDGER_CAPACITY} (K contributions a round) [{card}]")
        print(f"[population] host time: schedule {sched_s[0]:.3f} s for {POP_ROUNDS} rounds "
              f"({sched_s[0] / POP_ROUNDS:.4f} s a round), fleet_health {health_s:.4f} s, snapshot {snap_s:.4f} s; "
              f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) [{card}]")

        spec = dict(cohort_fraction=0.25, seed=POP_SEED + 1, device="cuda")
        with PopulationEngine(POP_REC_NODES, **spec) as ref:
            ref_res = ref.run(POP_REC_ROUNDS)
            ref_acc = float(ref_res.test_acc[-1])
            ref_hash = canonical_params_hash(ref.gather_params(0))
            ref_fill = ref.cohort_fill()
        ck = FLCheckpointer(os.path.join(root, "ckpt"))
        with PopulationEngine(POP_REC_NODES, **spec) as victim:
            victim.run(POP_REC_KILL)
            check(victim.save_to(ck), "population: the checkpoint save failed")
        ck.wait()
        with PopulationEngine(POP_REC_NODES, **spec) as healed:
            restored = healed.load_from(ck)
            check(restored == POP_REC_KILL, f"population: restored {restored} rounds, expected {POP_REC_KILL}")
            rec_res = healed.run(POP_REC_ROUNDS - POP_REC_KILL)
            rec_acc = float(rec_res.test_acc[-1])
            rec_hash = canonical_params_hash(healed.gather_params(0))
            rec_fill = healed.cohort_fill()
        ck.close()
        delta_pp = abs(rec_acc - ref_acc) * 100.0
        check(rec_hash == ref_hash, f"population: the resumed hash {rec_hash} != the control's {ref_hash}")
        check(delta_pp == 0.0, f"population: accuracy delta {delta_pp} pp")
        check(np.array_equal(rec_fill, ref_fill), "population: the replayed cohort fill differs from the control's")
        print(f"[population] recovery arm (n={POP_REC_NODES}, killed after {POP_REC_KILL} of {POP_REC_ROUNDS} rounds): "
              f"node 0 {rec_hash} == control, accuracy {rec_acc:.4f} (delta {delta_pp} pp), cohort fill replayed equal; "
              f"bytes written {dir_bytes(root)}")
    finally:
        Settings.restore(snap_settings)
        shutil.rmtree(root, ignore_errors=True)


# The async population phase (phase 12f): bench.py --asyncpop's arms
# (ASYNCPOP_BENCH_NODES / _COHORT, seed 42, ASYNCPOP_BENCH_WINDOWS' 12
# windows cut to 6 for the whole smoke's time limit; the IID control, the
# flash crowd and one ceiling probe) and scripts/soak_check.py's drill.
ASYNC_WINDOWS, ASYNC_EVAL_EVERY = 4, 2
ASYNC_TIERS = (1.0, 1.0, 1.0, 2.0, 5.0)
ASYNC_CTL_NODES, ASYNC_CTL_WINDOWS = 256, 5
ASYNC_FC_NODES, ASYNC_FC_PERIOD = 4096, 8
ASYNC_CEIL_NODES, ASYNC_CEIL_K = 1_000_000, 2048
SOAK_NODES, SOAK_CHUNKS, SOAK_SEED = 64, 5, 20260807


def asyncpop_throughput(card: str, root: str) -> None:
    """Phase 12f, throughput arm (see the module docstring)."""
    import os

    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.parallel.simulation import simulated_barrier_time
    from p2pfl_tpu_torch.population import AsyncPopulationEngine
    from p2pfl_tpu_torch.population.arrivals import CLOSE_REASONS
    from p2pfl_tpu_torch.population.cohort import committee_schedule

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = AsyncPopulationEngine(POP_NODES, cohort_fraction=POP_COHORT, seed=POP_SEED, speed_tiers=ASYNC_TIERS,
                                device="cuda")
    build_s = time.monotonic() - t0
    try:
        sched_s: list = []
        schedule = eng.schedule

        def timed_schedule(*args, **kwargs):
            t = time.monotonic()
            out = schedule(*args, **kwargs)
            sched_s.append(time.monotonic() - t)
            return out

        eng.schedule = timed_schedule
        led = eng.attach_ledger(run_id=f"asyncpop-n{POP_NODES}")
        res = eng.run(ASYNC_WINDOWS, eval_every=ASYNC_EVAL_EVERY)
        t = time.monotonic()
        snap = eng.snapshot(res, path=os.path.join(root, "asyncpop_snapshot.json"))
        snap_s = time.monotonic() - t
        k, names, node_speed, plan = eng.cohort_k, eng.names, eng.node_speed, eng.plan.cohort_plan
        commits = sum(1 for e in led.canonical_events() if e["kind"] == "aggregate_committed")
        peak = torch.cuda.max_memory_allocated()
    finally:
        eng.close()
        del eng
        gc.collect()
    summ = res.summary()
    sched = res.schedule
    check(res.windows == ASYNC_WINDOWS and len(res.close_codes) == ASYNC_WINDOWS
          and all(int(c) in CLOSE_REASONS for c in res.close_codes), f"asyncpop: windows did not all close {summ}")
    max_lag = int(sched.lag[sched.present].max())
    check(max_lag <= int(Settings.ASYNCPOP_MAX_LAG), f"asyncpop: fold lag {max_lag} > ASYNCPOP_MAX_LAG")
    contribs = summ["contributions"]
    sync_rounds = max(1, int(np.ceil(contribs / k)))
    t = time.monotonic()
    sync_ticks = simulated_barrier_time(committee_schedule(plan, names, sync_rounds, start_round=0), node_speed)
    baseline_s = time.monotonic() - t
    async_tpt = contribs / max(summ["sim_time_ticks"], 1e-12)
    sync_tpt = sync_rounds * k / max(sync_ticks, 1e-12)
    speedup = async_tpt / max(sync_tpt, 1e-12)
    check(speedup >= 2.0, f"asyncpop: simulated throughput {speedup:.3f}x the sync barrier's (floor 2x)")
    check(bool(np.isfinite(res.test_acc[-1])), f"asyncpop: final accuracy {res.test_acc[-1]}")
    shown = [p.get("window_fill") for name, p in snap["peers"].items() if name != "asyncpop-engine"]
    check(bool(shown) and all(v is not None for v in shown), "asyncpop: snapshot peers lack window_fill")
    print(f"[asyncpop] throughput n={POP_NODES}, K={k}, {ASYNC_WINDOWS} windows: {res.seconds_per_window:.4f} "
          f"s/window (host clock; build {build_s:.2f} s), {contribs} contributions, fills {res.fills.tolist()}, "
          f"close reasons {summ['close_reasons']}, mean lag {summ['mean_lag']:.4f}, max lag {max_lag}; accuracy "
          f"{[round(a, 4) for a in res.test_acc]}; simulated throughput {async_tpt:.2f} vs the sync barrier's "
          f"{sync_tpt:.2f} contributions a tick ({speedup:.3f}x over {sync_rounds} rounds, {sync_ticks:.1f} ticks); "
          f"{commits} aggregate_committed events in the ledger [{card}]")
    print(f"[asyncpop] host time: schedule {sched_s[0]:.3f} s for {ASYNC_WINDOWS} windows "
          f"({sched_s[0] / ASYNC_WINDOWS:.4f} s a window), snapshot {snap_s:.4f} s, the sync baseline's schedule "
          f"{baseline_s:.3f} s; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def asyncpop_control_flash_ceiling(card: str) -> None:
    """Phase 12f, the IID control, flash-crowd and ceiling arms."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, PopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    ctl = dict(cohort_fraction=0.25, seed=POP_SEED + 1, samples_per_node=16, hidden=(16,), device="cuda")
    with PopulationEngine(ASYNC_CTL_NODES, **ctl) as sync_eng:
        sync_res = sync_eng.run(ASYNC_CTL_WINDOWS)
        sync_acc, sync_hash = float(sync_res.test_acc[-1]), canonical_params_hash(sync_eng.gather_params(0))
    with AsyncPopulationEngine(ASYNC_CTL_NODES, **ctl) as async_eng:
        async_res = async_eng.run(ASYNC_CTL_WINDOWS)
        async_acc, async_hash = float(async_res.test_acc[-1]), canonical_params_hash(async_eng.global_params())
    delta_pp = abs(async_acc - sync_acc) * 100.0
    check(async_hash == sync_hash, f"asyncpop: IID control hash {async_hash} != the sync engine's {sync_hash}")
    check(delta_pp == 0.0, f"asyncpop: IID control accuracy delta {delta_pp} pp")
    print(f"[asyncpop] IID control n={ASYNC_CTL_NODES}, {ASYNC_CTL_WINDOWS} windows: {async_hash} == the sync "
          f"engine's, accuracy {async_acc:.4f} (delta {delta_pp} pp); {async_res.seconds_per_window:.4f} s/window "
          f"against {sync_res.seconds_per_round:.4f} s/round [{card}]")

    fc_windows = 3 * ASYNC_FC_PERIOD
    with AsyncPopulationEngine(ASYNC_FC_NODES, cohort_fraction=0.05, seed=POP_SEED + 2, speed_tiers=ASYNC_TIERS,
                               trace="flash", trace_period=ASYNC_FC_PERIOD, device="cuda") as fc:
        fc_k, patience = fc.cohort_k, fc.plan.resolved()[2]
        fc_res = fc.run(fc_windows, eval_every=fc_windows)
    sched, summ = fc_res.schedule, fc_res.summary()
    spike = np.arange(fc_windows) % ASYNC_FC_PERIOD < max(1, ASYNC_FC_PERIOD // 5)
    for p in range(3):
        rows = slice(p * ASYNC_FC_PERIOD, (p + 1) * ASYNC_FC_PERIOD)
        check(fc_res.fills[rows][spike[rows]].sum() > 0 and fc_res.fills[rows][~spike[rows]].sum() > 0,
              f"asyncpop: flash crowd period {p} stopped folding {fc_res.fills.tolist()}")
    fc_lag = int(sched.lag[sched.present].max())
    max_queue, bound = int(sched.queue_depth.max()), (patience + 1) * fc_k
    check(summ["close_reasons"]["stall"] <= fc_windows // 2, f"asyncpop: flash crowd stalled {summ}")
    check(fc_lag <= int(Settings.ASYNCPOP_MAX_LAG), f"asyncpop: flash crowd lag {fc_lag}")
    check(max_queue <= bound, f"asyncpop: flash crowd queue {max_queue} > the stall-patience bound {bound}")
    print(f"[asyncpop] flash crowd n={ASYNC_FC_NODES}, K={fc_k}, period {ASYNC_FC_PERIOD}, {fc_windows} windows: "
          f"{summ['contributions']} contributions, fills {fc_res.fills.tolist()}, close reasons "
          f"{summ['close_reasons']}, max lag {fc_lag} <= {Settings.ASYNCPOP_MAX_LAG}, max queue {max_queue} <= "
          f"{bound}, {int(sched.dropped.sum())} dropped; {fc_res.seconds_per_window:.4f} s/window [{card}]")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with AsyncPopulationEngine(ASYNC_CEIL_NODES, cohort_fraction=ASYNC_CEIL_K / ASYNC_CEIL_NODES, seed=POP_SEED + 3,
                               speed_tiers=ASYNC_TIERS, samples_per_node=8, feature_dim=16, state_dtype="bfloat16",
                               device="cuda") as ceil:
        build_s = time.monotonic() - t0
        ceil_res = ceil.run(2, eval_every=4)
        dtype = next(iter(ceil.history.values())).dtype
    total_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    check(ceil_res.windows == 2 and bool(np.isfinite(ceil_res.test_acc[-1])), "asyncpop: the ceiling probe failed")
    check(dtype == torch.bfloat16, f"asyncpop: the ceiling ring is {dtype}")
    print(f"[asyncpop] ceiling n={ASYNC_CEIL_NODES}, K={ASYNC_CEIL_K}, bf16 ring: {ceil_res.seconds_per_window:.4f} "
          f"s/window (fills {ceil_res.fills.tolist()}), build {build_s:.2f} s, {total_s:.2f} s in all; peak device "
          f"memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def asyncpop_supervisor(card: str, root: str) -> None:
    """Phase 12f, supervisor arm: ``scripts/soak_check.py``'s drill on both
    port engines, on the card, and on each a real out-of-memory error in
    the middle of a chunk."""
    import os

    import torch

    from p2pfl_tpu_torch.chaos.plane import ChaosPlane
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.parallel import simulation
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, EngineSupervisor, PopulationEngine, async_engine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    shape = dict(samples_per_node=8, feature_dim=8, hidden=(8,), batch_size=4, cohort_fraction=0.25, cohort_min=4,
                 seed=SOAK_SEED, device="cuda")
    kinds = ("kill", "oom", "sigterm")
    faults = ChaosPlane().plan_host_faults(SOAK_CHUNKS, seed=SOAK_SEED, kinds=kinds)

    def final_hash(engine) -> str:
        return canonical_params_hash(engine.global_params() if hasattr(engine, "global_params")
                                     else engine.gather_params(0))

    for label, cls in (("population", PopulationEngine), ("async", AsyncPopulationEngine)):
        def factory(**kw):
            return cls(**{"num_nodes": SOAK_NODES, **shape, **kw})

        t0 = time.monotonic()
        with factory() as ctrl:
            # The training calls of the first round (window); the next one
            # lies inside the second, where the mid-chunk drill fails.
            first = ctrl.cohort_k if cls is PopulationEngine else int(ctrl.schedule(1).fill()[0])
            ctrl.run(SOAK_CHUNKS)
            control = final_hash(ctrl)
        reports = []
        for run in ("first", "replay"):
            with FLCheckpointer(os.path.join(root, f"soak-{label}-{run}"), max_to_keep=2) as ck, \
                    EngineSupervisor(factory, ck, node=f"soak-{label}", faults=faults, backoff_s=0.0) as sup:
                rep = sup.run(SOAK_CHUNKS, chunk=1)
                check(not rep.parked and rep.completed == SOAK_CHUNKS, f"supervisor {label}: {rep.park_reason}")
                check({ev.kind for ev in rep.faults_executed} == set(kinds), f"supervisor {label}: faults {rep}")
                healed = final_hash(sup.engine)
            check(healed == control, f"supervisor {label}: healed hash {healed} != the control's {control}")
            reports.append(rep)
        check(reports[0].events == reports[1].events, f"supervisor {label}: the replay's event log diverged")
        print(f"[asyncpop] supervisor {label} (n={SOAK_NODES}, {SOAK_CHUNKS} chunks, faults "
              f"{[(ev.when, ev.kind) for ev in faults]}): healed to the control's {control}, restarts "
              f"{reports[0].restarts}, {len(reports[0].events)} events identical on replay, journal "
              f"{reports[0].journal_s / max(1, reports[0].journals) * 1000:.1f} ms each, "
              f"{time.monotonic() - t0:.2f} s [{card}]")
        # A real out-of-memory error from the card's allocator inside the
        # second round (window) of a three-round chunk: the engine drops its
        # part-written state and the supervisor heals it from the journal.
        module = simulation if cls is PopulationEngine else async_engine
        real_step, calls = module.local_train_step, []

        def step(*a, **kw):
            calls.append(1)
            if len(calls) == first + 1:
                torch.empty(1 << 42, dtype=torch.uint8, device="cuda")  # 4 TiB: more than the card holds
            return real_step(*a, **kw)

        module.local_train_step = step
        try:
            with FLCheckpointer(os.path.join(root, f"midchunk-{label}"), max_to_keep=2) as ck, \
                    EngineSupervisor(factory, ck, node=f"midchunk-{label}", backoff_s=0.0) as sup:
                rep = sup.run(SOAK_CHUNKS, chunk=3)
                healed = final_hash(sup.engine)
        finally:
            module.local_train_step = real_step
        check(len(calls) > first + 1 and not rep.parked and rep.completed == SOAK_CHUNKS
              and rep.restarts == {"oom": 1}, f"supervisor {label} mid-chunk: {rep.restarts} {rep.park_reason}")
        check(healed == control, f"supervisor {label} mid-chunk: healed hash {healed} != the control's {control}")
        print(f"[asyncpop] supervisor {label} mid-chunk: the card's OutOfMemoryError at training call {first + 1} "
              f"(round / window 2 of a 3-chunk) classified oom, healed to the control's hash [{card}]")

    class FailingEngine(PopulationEngine):
        def run(self, *a, **kw):
            raise RuntimeError("synthetic permanent chunk failure")

    def failing(**kw):
        return FailingEngine(**{"num_nodes": 8, **shape, "cohort_fraction": 0.5, "cohort_min": 2, **kw})

    logs = []
    for run in ("first", "replay"):
        with FLCheckpointer(os.path.join(root, f"soak-degrade-{run}"), max_to_keep=2) as ck, \
                EngineSupervisor(failing, ck, node="soak-degrade", max_retries=0, backoff_s=0.0,
                                 degrade="cohort") as sup:
            rep = sup.run(SOAK_CHUNKS, chunk=4)
        check(rep.parked and [a for a, _ in rep.degrade_steps] == ["chunks", "chunks", "cohort"],
              f"supervisor degrade: {rep.degrade_steps} parked={rep.parked}")
        logs.append(rep.events)
    check(logs[0] == logs[1], "supervisor degrade: the ladder's replay diverged")
    print(f"[asyncpop] supervisor degrade ladder: {[a for a, _ in rep.degrade_steps]} -> park, {len(logs[0])} "
          f"events identical on replay [{card}]")


def asyncpop_devobs(card: str) -> None:
    """Phase 12f, devobs arm: the async engine's aux stream on the card."""
    import os

    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.population import AsyncPopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    kw = dict(cohort_fraction=0.25, seed=POP_SEED + 4, speed_tiers=ASYNC_TIERS, device="cuda")
    hashes = {}
    for on in (True, False):
        with Settings.overridden(DEVOBS_ENABLED=on), AsyncPopulationEngine(ASYNC_CTL_NODES, **kw) as eng:
            res = eng.run(6, eval_every=6, windows_per_call=2)
            hashes[on] = canonical_params_hash(eng.global_params())
            extras, sketches = eng.devobs_summary()
        if on:
            secs_on = res.seconds_per_window
            counts = {m: int(sk.count) for m, sk in sketches.items()}
        else:
            secs_off = res.seconds_per_window
    check(hashes[True] == hashes[False], f"asyncpop devobs: on {hashes[True]} != off {hashes[False]}")
    check(counts.get("update_norm", 0) > 0 and counts.get("train_loss", 0) > 0, f"asyncpop devobs: sketches {counts}")
    with Settings.overridden(DEVOBS_ENABLED=True, DEVOBS_NAN_INJECT_ROUND=3, DEVOBS_TRIP_ACTION="park"), \
            AsyncPopulationEngine(ASYNC_CTL_NODES, **kw) as eng:
        res = eng.run(6, eval_every=6, windows_per_call=2)
        parked_at = eng.completed_windows
    trip = res.tripped
    check(trip is not None and trip["kind"] == "nonfinite" and trip["round"] == 3 and res.windows == 4
          and parked_at == 4, f"asyncpop devobs: trip {trip}, {res.windows} windows")
    check(bool(trip.get("bundle")) and os.path.exists(trip["bundle"]), f"asyncpop devobs: no bundle {trip}")
    print(f"[asyncpop] devobs n={ASYNC_CTL_NODES}: on / off hash equal {hashes[True]}, sketches {counts}, "
          f"{secs_on:.4f} / {secs_off:.4f} s/window; NaN at window 3 parked after window {parked_at} "
          f"(chunk {trip['chunk']}), bundle {os.path.basename(trip['bundle'])} [{card}]")


def phase_asyncpop(card: str) -> None:
    """Phase 12f: the async population engine and the engine supervisor on
    the card (see the module docstring), in a temporary working directory
    that the phase removes (park bundles and flight-recorder dumps land
    there)."""
    import os
    import shutil
    import tempfile

    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    root = tempfile.mkdtemp(prefix="p2pfl_asyncpop_")
    cwd = os.getcwd()
    os.chdir(root)
    snap_settings = Settings.snapshot()
    try:
        Settings.LEDGER_ENABLED = True
        Settings.DOCTOR_BUNDLE_DIR = os.path.join(root, "bundles")
        LEDGERS.reset()
        asyncpop_throughput(card, root)
        gc.collect()
        asyncpop_control_flash_ceiling(card)
        gc.collect()
        asyncpop_supervisor(card, root)
        gc.collect()
        asyncpop_devobs(card)
        print(f"[asyncpop] bytes under the temporary root at the end: {dir_bytes(root)}")
    finally:
        Settings.restore(snap_settings)
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def phase_parity() -> None:
    """The port's wire-vs-fused contract on the card: a ``ParityScenario``
    (8 MLP nodes, full committee, 3 rounds, one signflip node) through the
    wire's model plane (``run_frames``: ``ParityLearner.fit``, dense frames,
    a fresh handle's ``set_parameters(bytes)``, ``CanonicalFedAvg``), through
    real port Nodes over the in-memory transport (``run_wire``: inline fits
    on the nodes' stage threads, all on the card) and through ``run_fused``
    with the ledger attached: every round's hash equal, and
    ``scripts/parity_diff.py`` passes each wire node's ledger against the
    fused one."""
    import shutil
    import tempfile

    from p2pfl_tpu_torch.parity import ParityScenario, run_frames, run_fused, run_wire
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, TRAJECTORY_KINDS

    scn = ParityScenario(n_nodes=8, rounds=3, byzantine={3: "signflip"})
    tmp = tempfile.mkdtemp(prefix="p2pfl_parity_")
    try:
        LEDGERS.reset()
        t0 = time.monotonic()
        frames = run_frames(scn, device="cuda")
        t1 = time.monotonic()
        wire = run_wire(scn, ledger_dir=tmp, device="cuda")
        t2 = time.monotonic()
        fused = run_fused(scn, ledger_dir=tmp, device="cuda")
        t3 = time.monotonic()
        print(f"[parity] {scn.n_nodes} MLP nodes, {scn.rounds} rounds, node 3 signflip: wire model plane "
              f"{t1 - t0:.2f} s, {scn.n_nodes} port Nodes over the in-memory transport {t2 - t1:.2f} s, fused "
              f"{t3 - t2:.2f} s")
        for r in range(scn.rounds):
            a, b = frames["hashes"].get(r), fused["hashes"].get(r)
            nodes = {wire["hashes"][name].get(r) for name in scn.node_names}
            same = a == b and nodes == {b} and a
            print(f"[parity] round {r}: model plane {a} fused {b} Nodes {sorted(map(str, nodes))} "
                  f"{'equal' if same else 'DIFFER'}")
            check(a is not None and a == b, f"parity: round {r}'s aggregate hashes differ between the wire and fused")
            check(nodes == {b}, f"parity: round {r}'s Node hashes {nodes} differ from the fused round's {b}")

        def trajectory(events):
            return [{k: v for k, v in e.items() if k != "seq"} for e in events if e["kind"] in TRAJECTORY_KINDS]

        check(trajectory(frames["events"]) == trajectory(fused["events"]), "parity: the two ledgers' trajectories differ")
        print(f"[parity] ledgers: {len(trajectory(frames['events']))} trajectory events, equal")
        for name in scn.node_names:
            out = subprocess.run([sys.executable, "scripts/parity_diff.py", wire["ledgers"][name], fused["ledger"]],
                                 capture_output=True, text=True, timeout=120)
            check(out.returncode == 0, f"parity: parity_diff {name} against the fused ledger exited {out.returncode}: "
                  f"{out.stdout[-1500:]}{out.stderr[-500:]}")
        print(f"[parity] scripts/parity_diff.py: each of the {scn.n_nodes} Nodes' ledgers against the fused round's, "
              f"exit 0")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hub_offline() -> None:
    """Keep the Hugging Face hub offline in this process, its caches under
    ``build/`` (its libraries read these settings when imported): the card's
    machine has no network, and ``mnist()`` tries the hub first."""
    import os

    os.environ.update(HF_HUB_OFFLINE="1", HF_DATASETS_OFFLINE="1",
                      HF_HOME=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "hf_home"))


def phase_campaign(card: str) -> None:
    """The campaign's check prefix, the sentinel and ``mnist()`` on the card
    (docstring phase 13a)."""
    import importlib
    import os

    import numpy as np

    from p2pfl_tpu_torch.analysis.runtime import SENTINEL
    from p2pfl_tpu_torch.campaigns import run_campaign, sample_campaign
    from p2pfl_tpu_torch.campaigns.engine import BASELINE_HASH_FAMILIES
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import mnist, synthetic_mnist
    from p2pfl_tpu_torch.population.scenarios import run_scenario_wire

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "torch_campaign_fixtures", "campaign_baseline.json")) as f:
        fixture = json.load(f)
    seed, k = int(Settings.CAMPAIGN_SEED), int(Settings.CAMPAIGN_CHECK_SCENARIOS)
    check((fixture["campaign_seed"], fixture["check_scenarios"]) == (seed, k),
          f"campaign: the fixture's prefix {fixture['campaign_seed']}/{fixture['check_scenarios']} is not {seed}/{k}")
    t0 = time.monotonic()
    rep = run_campaign(seed=seed, n_scenarios=k, device="cuda", emit=lambda m: print(f"[campaign] {m}"))
    print(f"[campaign] {rep['campaign']}: {len(rep['scenarios'])} scenarios on {card} in "
          f"{time.monotonic() - t0:.1f} s, violations {rep['violations_total']}")
    sampled = sample_campaign(seed, k)
    check(len(rep["scenarios"]) == len(fixture["scenarios"]) == k, "campaign: scenario count differs from the fixture")
    for cs, got, want in zip(sampled, rep["scenarios"], fixture["scenarios"]):
        where = f"{got['family']}[{got['index']}]"
        print(f"[campaign] {where}: verdict {got['verdict']}, parity {got.get('parity_status')}, wire "
              f"{got.get('wire_seconds')} s, fused {got.get('fused_seconds')} s, all {got['seconds']} s"
              + (f", violations {got['violations']}" if got.get("violations") else "")
              + (f", error {got['error']}" if got.get("error") else ""))
        check(got["verdict"] == "ok" and got.get("parity_status") == "OK", f"campaign: {where} is not ok")
        check(cs.key == got["key"] == want["key"], f"campaign: {where}'s key differs from the fixture's")
        if got["family"] in BASELINE_HASH_FAMILIES:
            check(got["wire_hashes"] == got["fused_hashes"] and len(got["wire_hashes"]) == cs.scenario.rounds,
                  f"campaign: {where}'s wire hashes {got['wire_hashes']} differ from the fused {got['fused_hashes']}")
            same = got["wire_hashes"] == want["wire_hashes"]
            print(f"[campaign] {where}: wire == fused hashes over {len(got['wire_hashes'])} rounds on the card; "
                  f"{'equal to' if same else 'not'} the host's committed hashes")
        if want.get("adaptive_decisions") is not None:
            mine = got["adaptive"]["decisions"]
            ladder = [(d["round"], d["attack"]) for d in mine]
            check(ladder == [(d["round"], d["attack"]) for d in want["adaptive_decisions"]],
                  f"campaign: {where}'s attack ladder {ladder} differs from the fixture's")
            print(f"[campaign] {where}: ladder {[a for _, a in ladder]}, rejections "
                  f"{[d['rejections'] for d in mine]} (fixture {[d['rejections'] for d in want['adaptive_decisions']]})")
    check(rep["ok"], "campaign: the report is not ok")

    cs = next(c for c in sampled if c.family == "baseline")
    t0 = time.monotonic()
    with SENTINEL.patched():
        wire = run_scenario_wire(cs.scenario, device="cuda")
        stats, cycle = SENTINEL.stats(), SENTINEL.find_cycle()
    print(f"[campaign] sentinel: {cs.family}[{cs.index}]'s wire run ({cs.scenario.n_nodes} Nodes, "
          f"{cs.scenario.rounds} rounds) in {time.monotonic() - t0:.1f} s: {stats['locks']} instrumented locks, "
          f"{stats['edges']} order edges, cycle {cycle}")
    check(len(wire["stitched"]) > 0, "campaign: the sentinel's wire run committed nothing")
    check(cycle is None, f"campaign: lock-order cycle {cycle}")
    check(stats["edges"] > 0, "campaign: the sentinel recorded no nested acquisition")

    hub_offline()
    t0 = time.monotonic()
    got, want = mnist(), synthetic_mnist()
    same = all(np.array_equal(a, b) for train in (True, False)
               for a, b in zip(got.export_arrays(train), want.export_arrays(train)))
    try:
        have = importlib.import_module("datasets").__version__
    except ImportError:
        have = None
    print(f"[campaign] mnist(): {got.get_num_samples()} train / {got.get_num_samples(False)} test rows in "
          f"{time.monotonic() - t0:.2f} s, equal to synthetic_mnist(): {same}; datasets "
          + (f"{have} imported (hub offline)" if have else "not installed"))
    check(same, "campaign: mnist() did not return the synthetic arrays")


# The nodes axis over ranks: slice 1's LM for MULTIRANK_ROUNDS scheduled
# rounds (after a warm-up round) in W processes. Round 0's committee sits on
# both halves of the population (every rank trains), round 1's on nodes 0-3
# (rank 0 of two trains all four, rank 1 none).
MULTIRANK_SCHEDULE = ((5, 0, 6, 2), (1, 3, 0, 2))
MULTIRANK_ROUNDS = len(MULTIRANK_SCHEDULE)
MULTIRANK_DEADLINE_S = 420.0
MULTIRANK_FLAG = "--rank-worker"
#: ``phase_multirank``'s one-process run of slice 1's LM, kept when it ran in
#: this process: ``phase_sharded``'s nodes arm is the same run (its reference).
ONE_PROCESS_LM: dict = {}


def multirank_sim(mesh=None):
    """Slice 1's full-width flash LM population (phase 3's data and seeds)
    on ``mesh`` (None: this one process)."""
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda")
    train, xt = lm_data(5)
    return MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE, batch_size=BATCH, lr=LR,
                          seed=1, task="lm", mesh=mesh, device="cuda")


def multirank_run(sim) -> dict:
    """Warm-up round and MULTIRANK_ROUNDS scheduled rounds; what one rank
    (or the one process) saw."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()
    res = sim.run(rounds=MULTIRANK_ROUNDS, epochs=1, warmup=True, committee_schedule=np.asarray(MULTIRANK_SCHEDULE))
    launches = {name: _kernels.LAUNCHES[name] for name in KERNEL_ROWS}
    final = sim.final_model(0).params  # over ranks: broadcast by the rank that holds node 0
    dev = sim.device
    return {
        "s_per_round": res.seconds_per_round, "test_loss": res.test_loss, "hash": canonical_params_hash(final),
        "launches": launches, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "rank_members": sim.rank_members, "gather_bytes": sim.gather_bytes,
        "device": f"{dev} {torch.cuda.get_device_name(dev)}", "cards_seen": torch.cuda.device_count(),
    }


def multirank_rank(out_dir: str) -> int:
    """One rank of a ``phase_multirank`` arm, started by ``launch`` with
    torchrun's variables: join (the backend by ``initialize_multihost``'s
    rule), run :func:`multirank_run` on the rank mesh, write the result."""
    import torch
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = initialize_multihost(device="cuda")
    mesh = make_mesh()
    out = multirank_run(multirank_sim(mesh))
    out.update(rank=joined["rank"], world=joined["world"], backend=joined["backend"])
    with open(os.path.join(out_dir, f"rank{joined['rank']}.json"), "w") as f:
        json.dump(out, f)
    shutdown_multihost()
    print(f"[multirank] rank {joined['rank']} of {joined['world']} done", flush=True)
    return 0


def phase_multirank(card: str) -> dict:
    """The nodes axis over ranks on the card: slice 1's LM run by W rank
    processes against the same run in this process. With two or more cards,
    min(cards, 4) NCCL ranks, one card each; with one card, two gloo ranks
    sharing it and a one-rank NCCL world. Each rank's final hash must equal
    the one-process run's, rows 1-4 must launch on every rank (rows 1, 3, 4
    exactly 32 times a member it trained, row 2 four times a round it
    evaluated), every rank must exit 0 and the test loss fall. Returns each
    arm's launches per rank."""
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.parallel.launch import launch

    print(f"[multirank] {card}")
    ref = multirank_run(multirank_sim())
    ONE_PROCESS_LM.update(ref)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[multirank] one process: {ref['s_per_round']:.4f} s/round, test loss {ref['test_loss']}, hash "
          f"{ref['hash'][:23]}, peak {ref['peak_bytes']} bytes, launches {json.dumps(ref['launches'])}")
    cards = torch.cuda.device_count()
    arms = [("nccl", min(cards, 4))] if cards >= 2 else [("gloo", 2), ("nccl", 1)]
    per_member = KERNEL_ROWS["flash_fwd"][1] // COMMITTEE
    evals = MULTIRANK_ROUNDS + 1  # the warm-up round evaluates too
    seen = {}
    for backend, world in arms:
        label = f"{backend}{world}"
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.monotonic()
            runs = launch([sys.executable, os.path.abspath(__file__), MULTIRANK_FLAG, tmp], world,
                          timeout_s=MULTIRANK_DEADLINE_S, cwd=os.path.dirname(os.path.abspath(__file__)))
            wall = time.monotonic() - t0
            for rank, (rc, out) in enumerate(runs):
                if rc != 0:
                    print(out[-6000:])
                check(rc == 0, f"{label} rank {rank} exited {rc}")
            got = []
            for rank in range(world):
                with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                    got.append(json.load(f))
        print(f"[multirank] {label}: backend {got[0]['backend']}, W {world}, {wall:.1f} s for the world (start to "
              f"exit), {card}")
        for g in got:
            print(f"[multirank] {label} rank {g['rank']}: {g['s_per_round']:.4f} s/round, all-gathered bytes per "
                  f"round {g['gather_bytes']}, peak {g['peak_bytes']} bytes ({g['peak_bytes'] / 2**30:.2f} GiB), "
                  f"members per rank per round {g['rank_members']}, device {g['device']} of {g['cards_seen']} "
                  f"seen, test loss {g['test_loss']}, hash {g['hash'][:23]}, launches {json.dumps(g['launches'])}")
            check(g["backend"] == backend and g["world"] == world, f"{label}: rank {g['rank']} joined {g['backend']}")
            check(g["hash"] == ref["hash"], f"{label} rank {g['rank']}: final hash differs from the one process's")
            check(all(np.isfinite(g["test_loss"])) and g["test_loss"][-1] < g["test_loss"][0],
                  f"{label} rank {g['rank']}: test loss not finite and falling: {g['test_loss']}")
            check(g["test_loss"] == ref["test_loss"], f"{label} rank {g['rank']}: test loss differs")
            per = NODES // world
            trained = sum(node // per == g["rank"] for row in (MULTIRANK_SCHEDULE[0], *MULTIRANK_SCHEDULE)
                          for node in row)
            for name in KERNEL_ROWS:
                want = evals * KERNEL_ROWS[name][1] if name == "flash_fwd_no_lse" else trained * per_member
                check(g["launches"][name] > 0, f"{label} rank {g['rank']}: {name} never launched")
                check(g["launches"][name] == want,
                      f"{label} rank {g['rank']}: {name} launched {g['launches'][name]} times, expected {want}")
        seen[label] = {name: [g["launches"][name] for g in got] for name in KERNEL_ROWS}
    return seen



# The seq and stage axes over ranks: the ring phase's model, data and steps
# with its sequence over W ranks (one shard a rank), and the pipeline phase's
# flash LM, batch and steps with one stage a rank. With one card two gloo
# ranks share it and their exchanges go through host memory; with two or
# more, min(cards, 4) NCCL ranks, one card each. Each is held against the
# same run in this process at W virtual shards or stages.
SEQSTAGE_FLAG = "--seqstage-worker"
SEQSTAGE_DEADLINE_S = 420.0
# The ranked ring's loss may differ from the one process's: its loss and
# gradients are summed over the ranks in another order (bf16 compute, f32
# sums), and Adam's first steps divide a gradient by its own magnitude.
SEQSTAGE_LOSS_BAR = 1e-2


def seqstage_arm(cards: int) -> tuple:
    """``(backend, W)`` of the seq / stage arm on a host with ``cards`` cards."""
    return ("nccl", min(cards, 4)) if cards >= 2 else ("gloo", 2)


def ring_ppermute_bytes(world: int) -> int:
    """The bytes that reach each rank through ``ppermute`` in one ranked ring
    train step: per layer, W - 1 rotations of a (k, v) shard (bf16) in the
    carry kernel's forward, W - 1 more in the backward's rematerialized
    forward, and W - 1 of their cotangents (bf16) back; plus the first token
    of the right neighbour (int32) for the shifted targets."""
    kv = 2 * RING_BATCH * (RING_SEQ // world) * HEADS * (EMBED // HEADS) * 2
    return 3 * LAYERS * (world - 1) * kv + RING_BATCH * 4


def pp_ppermute_bytes(world: int, rank: int, grad: bool = True) -> int:
    """The bytes that reach stage ``rank`` through ``ppermute`` in one
    pipelined pass: a microbatch's activation (bf16) from the stage before
    (not on stage 0), and with ``grad`` its cotangent from the stage after
    (not on the last stage), for each of the ``PP_MICRO`` microbatches."""
    act = (BATCH // PP_MICRO) * SEQ_LEN * EMBED * 2
    return PP_MICRO * act * ((rank > 0) + (grad and rank < world - 1))


def tree_hash(tree: dict) -> str:
    """sha256 of a flat dict of tensors' names and bytes, in key order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(tree[k].detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def seqstage_ring(mesh) -> dict:
    """The ring phase's run on ``mesh`` (a ranked ``seq`` axis, or W virtual
    shards): the first-step logits (no grad; this rank's shard over ranks),
    then a warm-up and ``RING_STEPS`` Adam steps, every count set to 0
    before the steps and read after."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step,
        sequence_parallel_apply,
        shard_tokens,
    )
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    model = transformer_lm_model(0, RING_SEQ, VOCAB, LAYERS, HEADS, EMBED, "ring_flash", "seq", device=mesh.device)
    rng = np.random.default_rng(7)
    x = (rng.integers(0, VOCAB, size=(RING_BATCH, 1)) + np.arange(RING_SEQ)) % VOCAB
    tokens = shard_tokens(x.astype(np.int32), mesh)
    with torch.no_grad():
        logits = sequence_parallel_apply(model.apply, mesh)(model.params, tokens)
    opt = adam(LR)
    params, state = model.params, opt.init(model.params)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()
    params, state, loss = step(params, state, tokens)  # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(RING_STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    return {"logits": logits, "losses": [float(v) for v in losses], "s_per_step": (time.monotonic() - t0) / RING_STEPS,
            "launches": dict(_kernels.LAUNCHES),
            "bytes_per_step": collectives.STATS["ppermute_bytes"] / (RING_STEPS + 1),
            "peak": torch.cuda.max_memory_allocated(), "hash": canonical_params_hash(params)}


def seqstage_pipeline(mesh) -> dict:
    """The pipeline phase's run (:func:`pipelined_steps`) of the flash LM on
    ``mesh`` (a ranked ``stage`` axis, or W virtual stages)."""
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.pipeline import make_pipelined_transformer_lm

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device=mesh.device)
    pp_params, apply_fn = make_pipelined_transformer_lm(model, mesh, PP_MICRO)
    return pipelined_steps(apply_fn, pp_params, pp_tokens())


def pp_rank_view(params: dict, rank: int) -> dict:
    """The leaves a stage rank holds of the one process's flat pipelined
    params: the replicated ones and stage ``rank``'s slice."""
    return {k: (v[rank:rank + 1] if k.startswith("stages/") else v) for k, v in params.items()}


def seqstage_rank(out_dir: str) -> int:
    """One rank of ``phase_seqstage``, started by ``launch`` with torchrun's
    variables: join (the backend by ``initialize_multihost``'s rule), run
    the ring over a ranked ``seq`` axis and the pipeline over a ranked
    ``stage`` axis, hold each rank's logits to this process's reference
    (``<dir>/ring_logits<r>.pt``, ``<dir>/pp_logits.pt``), write the result."""
    import torch
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = initialize_multihost(device="cuda")
    rank, world = joined["rank"], joined["world"]
    out = {"rank": rank, "world": world, "backend": joined["backend"], "cards_seen": torch.cuda.device_count()}
    for arm, run, axis, ref in (("ring", seqstage_ring, "seq", f"ring_logits{rank}.pt"),
                                ("pipeline", seqstage_pipeline, "stage", "pp_logits.pt")):
        mesh = make_mesh((world,), (axis,))
        got = run(mesh)
        want = torch.load(os.path.join(out_dir, ref), map_location=mesh.device)
        logits = got.pop("logits")
        got["logits_err"] = float((logits - want).abs().max()) if logits.shape == want.shape else float("inf")
        got["logits_finite"] = bool(torch.isfinite(logits).all())
        got["device"] = f"{mesh.device} {torch.cuda.get_device_name(mesh.device)}"
        if arm == "pipeline":
            params = got.pop("params")
            got["hash"] = tree_hash(params)
            got["replicated_hash"] = tree_hash({k: v for k, v in params.items() if not k.startswith("stages/")})
            got["shapes"] = sorted(got["shapes"])
        out[arm] = got
        del logits, want
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_multihost()
    print(f"[seqstage] rank {rank} of {world} done", flush=True)
    return 0


def phase_seqstage(card: str) -> dict:
    """The seq and stage axes over ranks on the card (docstring phase 13c):
    the ring and the pipeline in this process at W virtual shards / stages,
    then in W rank processes of this script (``--seqstage-worker DIR``).
    Returns each arm's launches per rank under the kernel rows' names."""
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.parallel.launch import launch
    from p2pfl_tpu_torch.parallel.mesh import Mesh

    backend, world = seqstage_arm(torch.cuda.device_count())
    label = f"{backend}{world}"
    print(f"[seqstage] {card}: {label}, ring {RING_BATCH} x {RING_SEQ} tokens over seq = {world}, pipeline "
          f"{BATCH} x {SEQ_LEN} in {PP_MICRO} microbatches over stage = {world}")
    ring_ref = seqstage_ring(Mesh({"seq": world}, device="cuda"))
    pp_ref = seqstage_pipeline(Mesh({"stage": world}, device="cuda"))
    print(f"[seqstage] one process, seq = {world} virtual shards: {ring_ref['s_per_step']:.4f} s/step, loss per step "
          f"{ring_ref['losses']}, hash {ring_ref['hash'][:23]}, peak {ring_ref['peak']} bytes")
    print(f"[seqstage] one process, stage = {world} virtual stages: {pp_ref['s_per_step']:.4f} s/step, loss per "
          f"step {pp_ref['losses']}, peak {pp_ref['peak']} bytes")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        for r, shard in enumerate(ring_ref.pop("logits").chunk(world, dim=1)):
            torch.save(shard.contiguous(), os.path.join(tmp, f"ring_logits{r}.pt"))
        torch.save(pp_ref.pop("logits"), os.path.join(tmp, "pp_logits.pt"))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        runs = launch([sys.executable, os.path.abspath(__file__), SEQSTAGE_FLAG, tmp], world,
                      timeout_s=SEQSTAGE_DEADLINE_S, cwd=root)
        wall = time.monotonic() - t0
        for rank, (rc, out) in enumerate(runs):
            if rc != 0:
                print(out[-6000:])
            check(rc == 0, f"seqstage {label} rank {rank} exited {rc}")
        got = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                got.append(json.load(f))
    print(f"[seqstage] {label}: {wall:.1f} s for the world (start to exit), {card}")
    per_stage = LAYERS // world
    micro = [BATCH // PP_MICRO, SEQ_LEN, HEADS, EMBED // HEADS]
    want_pp = {"flash_fwd": per_stage * PP_MICRO * PP_STEPS, "flash_bwd_dq": per_stage * PP_MICRO * PP_STEPS,
               "flash_bwd_dkv": per_stage * PP_MICRO * PP_STEPS, "flash_fwd_no_lse": per_stage * PP_MICRO,
               "flash_carry": 0}
    ref_params = pp_ref["params"]
    for g in got:
        r, ring, pp = g["rank"], g["ring"], g["pipeline"]
        check(g["backend"] == backend and g["world"] == world, f"seqstage {label}: rank {r} joined {g['backend']}")
        ring_bytes = ring_ppermute_bytes(world)
        print(f"[seqstage] {label} rank {r} ring: backend {g['backend']}, W {world}, device {ring['device']} of "
              f"{g['cards_seen']} seen, {ring['s_per_step']:.4f} s/step, ppermute bytes per step "
              f"{ring['bytes_per_step']:.0f} (predicted {ring_bytes}), peak {ring['peak']} bytes "
              f"({ring['peak'] / 2**30:.2f} GiB), first-step logits shard max_abs_err={ring['logits_err']:.3e} "
              f"tol 6e-2, loss per step {ring['losses']}, hash {ring['hash'][:23]}, launches "
              f"{json.dumps(ring['launches'])}")
        check(ring["logits_finite"] and ring["logits_err"] <= 6e-2, f"seqstage ring rank {r}: logits disagree")
        check(all(np.isfinite(ring["losses"])) and ring["losses"][-1] < ring["losses"][0],
              f"seqstage ring rank {r}: loss not finite and falling: {ring['losses']}")
        gap = max(abs(a - b) for a, b in zip(ring["losses"], ring_ref["losses"]))
        print(f"[seqstage] {label} rank {r} ring: loss gap to one process {gap:.3e} (bar {SEQSTAGE_LOSS_BAR})")
        check(gap <= SEQSTAGE_LOSS_BAR, f"seqstage ring rank {r}: loss {gap:.3e} from the one process's")
        check(ring["hash"] == got[0]["ring"]["hash"], f"seqstage ring rank {r}: parameters differ from rank 0's")
        check(ring["bytes_per_step"] == ring_bytes, f"seqstage ring rank {r}: {ring['bytes_per_step']} ppermute "
              f"bytes a step, predicted {ring_bytes}")
        folds = LAYERS * (r + 1) * (RING_STEPS + 1)
        check(ring["launches"]["flash_carry"] == folds,
              f"seqstage ring rank {r}: flash_carry launched {ring['launches']['flash_carry']} times, expected "
              f"{folds} ({LAYERS} layers x {r + 1} folds x {RING_STEPS + 1} steps)")
        check(all(ring["launches"][n] == 0 for n in KERNEL_ROWS), f"seqstage ring rank {r}: rows 1-4 launched")
        pp_bytes = PP_STEPS * pp_ppermute_bytes(world, r) + pp_ppermute_bytes(world, r, grad=False)
        same = pp["hash"] == tree_hash(pp_rank_view(ref_params, r))
        print(f"[seqstage] {label} rank {r} pipeline: device {pp['device']}, {pp['s_per_step']:.4f} s/step (the "
              f"first included), ppermute bytes {pp['bytes']} over the no-grad forward and {PP_STEPS} steps "
              f"(predicted {pp_bytes}), peak {pp['peak']} bytes ({pp['peak'] / 2**30:.2f} GiB), logits "
              f"max_abs_err={pp['logits_err']:.3e}, loss per step {pp['losses']}, final parameters "
              f"{'bit-equal to' if same else 'NOT equal to'} the one process's stage {r}, launches "
              f"{json.dumps(pp['launches'])}, q shapes {pp['shapes']}")
        check(pp["logits_finite"] and pp["logits_err"] == 0.0, f"seqstage pipeline rank {r}: logits differ")
        check(pp["losses"] == pp_ref["losses"], f"seqstage pipeline rank {r}: losses differ from the one process's")
        check(same, f"seqstage pipeline rank {r}: final parameters differ from the one process's")
        check(pp["replicated_hash"] == got[0]["pipeline"]["replicated_hash"],
              f"seqstage pipeline rank {r}: replicated parameters differ from rank 0's")
        check(pp["bytes"] == pp_bytes,
              f"seqstage pipeline rank {r}: {pp['bytes']} ppermute bytes, predicted {pp_bytes}")
        check(pp["shapes"] == [micro], f"seqstage pipeline rank {r}: kernels ran at {pp['shapes']}")
        for name, n in want_pp.items():
            check(pp["launches"][name] == n, f"seqstage pipeline rank {r}: {name} launched {pp['launches'][name]} "
                  f"times, expected {n}")
    return {"flash_carry": {label: [g["ring"]["launches"]["flash_carry"] for g in got]},
            **{name + PP_SUFFIX: {label: [g["pipeline"]["launches"][name] for g in got]} for name in KERNEL_ROWS}}


# The expert and model axes over ranks (docstring phase 13d): the MoE phase's
# LM with its experts split over W ranks, and the slice's flash LM round
# with every kernel split on its output dimension over W model ranks. With
# one card two gloo ranks share it (the exchanges of CUDA tensors go through
# host memory); with two or more, min(cards, 4) NCCL ranks, one card each.
# Each is held against the same run in this process.
EXPERTMODEL_FLAG = "--expertmodel-worker"
EXPERTMODEL_DEADLINE_S = 420.0
# The model arm's depth: one scheduled round (and its warm-up round); the
# gloo arm cuts the sequences a node to one batch (one step a member), the
# NCCL arm keeps the slice's SEQS. The width is the slice's.
EM_ROUNDS, EM_GLOO_SEQS = 1, BATCH
EM_SCHEDULE = ((5, 0, 6, 2),)
# Bars against the one process: first-step logits (as the ring's), the loss
# per step and the eval loss (as the ring's), and the parameters: the L2 of
# their difference over the L2 of the run's own update (a kernel slice or a
# sum in the wrong place moves them by the update itself; the sums over
# ranks in another order move bf16 gradients by an ulp, which Adam turns into
# sign flips of near-zero elements).
EM_LOGITS_BAR, EM_LOSS_BAR, EM_PARAMS_RTOL = 6e-2, 1e-2, 1e-1


def em_tp_bytes(batch: int) -> tuple:
    """``(gathered, summed)`` bytes of one column-parallel flash LM pass over
    ``batch`` x ``SEQ_LEN`` tokens (bf16 activations): the forward gathers
    the embedding, each layer's qkv (3E), proj (E), mlp_in (4E) and mlp_out
    (E) outputs and the logits (V); a training pass's backward sums the
    input cotangents of each column-parallel layer (qkv, proj and mlp_in
    read E, mlp_out 4E; lm_head E) and of the two biased layers' biases
    (mlp_in 4E, mlp_out E)."""
    tokens = batch * SEQ_LEN
    gathered = tokens * 2 * (EMBED + LAYERS * 9 * EMBED + VOCAB)
    summed = tokens * 2 * (LAYERS * 7 * EMBED + EMBED) + LAYERS * 5 * EMBED * 2
    return gathered, summed


def em_ep_bytes() -> int:
    """Bytes one expert-parallel MoE train step sums over the ranks: per
    routed block the forward's partial combine [T, E] (bf16), and in the
    backward the tokens' [T, E] (bf16) and the gate's [T] (f32) cotangents."""
    t = BATCH * SEQ_LEN
    return (LAYERS // 2) * (2 * t * EMBED * 2 + t * 4)


def update_rel(got: dict, want: dict, start: dict) -> float:
    """``||got - want|| / ||want - start||`` over every leaf (L2, f64)."""
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float(((want[k].double() - start[k].double()) ** 2).sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


def em_expert(mesh) -> dict:
    """The MoE phase's LM and batch on ``mesh`` (a ranked ``expert`` axis, or
    one process): a warm-up step (its logits kept) and ``MOE_STEPS`` Adam
    steps on loss + 0.01 aux, every count set to 0 before the steps."""
    import torch
    from p2pfl_tpu_torch.models.moe import moe_lm_apply_with_aux, moe_lm_model, shard_moe_params
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam, apply_updates
    from p2pfl_tpu_torch.parallel import collectives

    model = moe_lm_model(seed=0, seq_len=SEQ_LEN, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                         embed_dim=EMBED, num_experts=MOE_EXPERTS, attention_kind="flash", device=mesh.device)
    params = start = shard_moe_params(model.params, mesh)
    apply = moe_lm_apply_with_aux(model.module)
    (x, _, _), _ = lm_data(13)
    tokens = torch.from_numpy(x[0, :BATCH]).to(mesh.device)
    opt = adam(LR)
    state = opt.init(params)

    def step(params, state):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with mesh.bind():
            logits, aux = apply(leaves, tokens)
            loss = causal_lm_loss(logits, tokens) + MOE_AUX * aux
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        return apply_updates(params, updates), state, loss.detach(), logits.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()
    params, state, loss, logits = step(params, state)  # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(MOE_STEPS):
        params, state, loss, _ = step(params, state)
        losses.append(loss)
    torch.cuda.synchronize()
    return {"logits": logits, "losses": [float(v) for v in losses], "s_per_step": (time.monotonic() - t0) / MOE_STEPS,
            "launches": dict(_kernels.LAUNCHES), "sum_bytes": collectives.STATS["sum_bytes"],
            "peak": torch.cuda.max_memory_allocated(mesh.device), "params": params, "start": start}


def em_model(mesh, seqs: int) -> dict:
    """The slice's flash LM population on ``mesh`` (``{"nodes": 1, "model":
    W}`` over ranks, or None: one process) with ``seqs`` sequences a node:
    a warm-up round and ``EM_ROUNDS`` rounds of ``EM_SCHEDULE``, every count
    set to 0 before; the whole final model of node 0."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda" if mesh is None else mesh.device)
    start = {k: v.clone() for k, v in model.params.items()}
    train, xt = lm_data(5, seqs)
    sim = MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE, batch_size=BATCH, lr=LR,
                         seed=1, task="lm", mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()
    res = sim.run(rounds=EM_ROUNDS, epochs=1, warmup=True, committee_schedule=np.asarray(EM_SCHEDULE))
    launches = dict(_kernels.LAUNCHES)
    stats = dict(collectives.STATS)
    final = sim.final_model(0).params
    dev = sim.device
    out = {"s_per_round": res.seconds_per_round, "test_loss": res.test_loss, "hash": canonical_params_hash(final),
           "launches": launches, "gather_dim_bytes": stats["gather_dim_bytes"], "sum_bytes": stats["sum_bytes"],
           "peak": torch.cuda.max_memory_allocated(dev), "params": final, "start": start,
           "local_bytes": sum(v.numel() * v.element_size() for v in sim.params_stack.values())}
    sim.close()
    return out


def expertmodel_rank(out_dir: str) -> int:
    """One rank of ``phase_expertmodel``, started by ``launch`` with
    torchrun's variables: join (the backend by ``initialize_multihost``'s
    rule), run the expert arm on ``make_mesh((W,), ("expert",))`` and the
    model arm on ``make_mesh((1, W), ("nodes", "model"))``, hold each to
    this process's reference (``<dir>/expert.pt``, ``<dir>/model.pt``), and
    write the result."""
    import torch
    from p2pfl_tpu_torch.parallel import collectives
    from p2pfl_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = initialize_multihost(device="cuda")
    rank, world = joined["rank"], joined["world"]
    seqs = EM_GLOO_SEQS if joined["backend"] == "gloo" else SEQS
    out = {"rank": rank, "world": world, "backend": joined["backend"], "cards_seen": torch.cuda.device_count(),
           "seqs": seqs}
    mesh = make_mesh((world,), ("expert",))
    got = em_expert(mesh)
    ref = torch.load(os.path.join(out_dir, "expert.pt"), map_location=mesh.device)
    got["logits_err"] = float((got.pop("logits") - ref["logits"]).abs().max())
    local = got.pop("params")
    got["shapes"] = {k: list(v.shape) for k, v in local.items() if ".moe.w" in k}
    got["replicated_hash"] = tree_hash({k: v for k, v in local.items() if ".moe.w" not in k})
    whole = {k: (collectives.all_gather_dim(v, 0, mesh.group) if ".moe.w" in k else v) for k, v in local.items()}
    got["params_rel"] = update_rel(whole, ref["params"], ref["start"])
    got["experts_max_err"] = max(float((whole[k] - ref["params"][k]).abs().max()) for k in whole if ".moe.w" in k)
    got["device"] = f"{mesh.device} {torch.cuda.get_device_name(mesh.device)}"
    got.pop("start")
    out["expert"] = got
    del ref, whole, local
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, world), ("nodes", "model"))
    got = em_model(mesh, seqs)
    ref = torch.load(os.path.join(out_dir, f"model{seqs}.pt"), map_location=mesh.device)
    final = got.pop("params")
    got["params_rel"] = update_rel(final, ref["params"], ref["start"])
    got["params_max_err"] = max(float((final[k] - ref["params"][k]).abs().max()) for k in final)
    got["device"] = f"{mesh.device} {torch.cuda.get_device_name(mesh.device)}"
    got.pop("start")
    out["model"] = got
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_multihost()
    print(f"[expertmodel] rank {rank} of {world} done", flush=True)
    return 0


def phase_expertmodel(card: str) -> dict:
    """The expert and model axes over ranks on the card (docstring phase
    13d): each arm in this process, then in W rank processes of this script
    (``--expertmodel-worker DIR``). Returns each arm's launches per rank
    under the kernel rows' names."""
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.parallel.launch import launch
    from p2pfl_tpu_torch.parallel.mesh import Mesh

    backend, world = seqstage_arm(torch.cuda.device_count())
    label = f"{backend}{world}"
    seqs = EM_GLOO_SEQS if backend == "gloo" else SEQS
    steps = seqs // BATCH  # a member's steps in a round
    gather_step, sum_step = em_tp_bytes(BATCH)
    gather_eval, _ = em_tp_bytes(EVAL_SEQS)
    rounds = EM_ROUNDS + 1  # the warm-up round runs every member and the eval too
    want_gather = rounds * (COMMITTEE * steps * gather_step + gather_eval)
    # Plus each timed round's device observatory: a member's squared update norm (f32) summed over the ranks.
    want_sum = rounds * COMMITTEE * steps * sum_step + EM_ROUNDS * COMMITTEE * 4
    want_ep = (MOE_STEPS + 1) * em_ep_bytes()
    print(f"[expertmodel] {card}: {label}; expert arm: the MoE LM ({MOE_EXPERTS} experts, {MOE_EXPERTS // world} a "
          f"rank) at batch {BATCH} x {SEQ_LEN}, a warm-up and {MOE_STEPS} Adam steps, {em_ep_bytes()} bytes summed a "
          f"step; model arm: the flash LM round on nodes 1 x model {world}, {seqs} sequences a node, "
          f"{EM_ROUNDS} round + warm-up, {gather_step} bytes gathered and {sum_step} summed a train step, "
          f"{gather_eval} gathered an eval")
    ref_ep = em_expert(Mesh({"expert": world}, device="cuda"))
    ref_tp = em_model(None, seqs)
    print(f"[expertmodel] one process, expert arm: {ref_ep['s_per_step']:.4f} s/step, loss per step "
          f"{ref_ep['losses']}, peak {ref_ep['peak']} bytes")
    print(f"[expertmodel] one process, model arm: {ref_tp['s_per_round']:.4f} s/round, test loss "
          f"{ref_tp['test_loss']}, hash {ref_tp['hash'][:23]}, peak {ref_tp['peak']} bytes, launches "
          f"{json.dumps({n: ref_tp['launches'][n] for n in KERNEL_ROWS})}")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        torch.save({k: ref_ep[k] for k in ("logits", "params", "start")}, os.path.join(tmp, "expert.pt"))
        torch.save({k: ref_tp[k] for k in ("params", "start")}, os.path.join(tmp, f"model{seqs}.pt"))
        for ref in (ref_ep, ref_tp):
            for k in ("logits", "params", "start"):
                ref.pop(k, None)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        runs = launch([sys.executable, os.path.abspath(__file__), EXPERTMODEL_FLAG, tmp], world,
                      timeout_s=EXPERTMODEL_DEADLINE_S, cwd=root)
        wall = time.monotonic() - t0
        for rank, (rc, out) in enumerate(runs):
            if rc != 0:
                print(out[-6000:])
            check(rc == 0, f"expertmodel {label} rank {rank} exited {rc}")
        got = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                got.append(json.load(f))
    print(f"[expertmodel] {label}: {wall:.1f} s for the world (start to exit), {card}")
    per_step = {"flash_fwd": LAYERS, "flash_bwd_dq": LAYERS, "flash_bwd_dkv": LAYERS, "flash_fwd_no_lse": 0,
                "flash_carry": 0}
    for g in got:
        r, ep, tp = g["rank"], g["expert"], g["model"]
        check(g["backend"] == backend and g["world"] == world, f"expertmodel {label}: rank {r} joined {g['backend']}")
        print(f"[expertmodel] {label} rank {r} expert: backend {g['backend']}, W {world}, device {ep['device']} of "
              f"{g['cards_seen']} seen, experts {ep['shapes']}, {ep['s_per_step']:.4f} s/step, summed bytes "
              f"{ep['sum_bytes']} (predicted {want_ep}), peak {ep['peak']} bytes ({ep['peak'] / 2**30:.2f} GiB), "
              f"first-step logits max_abs_err={ep['logits_err']:.3e} tol {EM_LOGITS_BAR}, loss per step "
              f"{ep['losses']}, gathered parameters {ep['params_rel']:.3e} of the update (bar {EM_PARAMS_RTOL}), "
              f"experts max_abs_err={ep['experts_max_err']:.3e}, launches {json.dumps(ep['launches'])}")
        check(ep["logits_err"] <= EM_LOGITS_BAR, f"expertmodel expert rank {r}: logits disagree")
        check(all(np.isfinite(ep["losses"])) and ep["losses"][-1] < ep["losses"][0],
              f"expertmodel expert rank {r}: loss not finite and falling: {ep['losses']}")
        gap = max(abs(a - b) for a, b in zip(ep["losses"], ref_ep["losses"]))
        check(gap <= EM_LOSS_BAR, f"expertmodel expert rank {r}: loss {gap:.3e} from the one process's")
        check(ep["replicated_hash"] == got[0]["expert"]["replicated_hash"],
              f"expertmodel expert rank {r}: replicated leaves differ from rank 0's")
        check(ep["params_rel"] <= EM_PARAMS_RTOL, f"expertmodel expert rank {r}: parameters {ep['params_rel']:.3e} "
              "of the update from the one process's")
        check(all(s[0] == MOE_EXPERTS // world for s in ep["shapes"].values()), f"expertmodel expert rank {r}: "
              f"holds experts {ep['shapes']}")
        check(ep["sum_bytes"] == want_ep, f"expertmodel expert rank {r}: {ep['sum_bytes']} bytes summed, predicted "
              f"{want_ep}")
        for name, n in per_step.items():
            want = n * (MOE_STEPS + 1)
            check(ep["launches"][name] == want, f"expertmodel expert rank {r}: {name} launched "
                  f"{ep['launches'][name]} times, expected {want}")
        print(f"[expertmodel] {label} rank {r} model: device {tp['device']}, {tp['s_per_round']:.4f} s/round, "
              f"gathered bytes {tp['gather_dim_bytes']} (predicted {want_gather}), summed bytes {tp['sum_bytes']} "
              f"(predicted {want_sum}), population {tp['local_bytes']} bytes a rank, peak {tp['peak']} bytes "
              f"({tp['peak'] / 2**30:.2f} GiB), test loss {tp['test_loss']} (one process {ref_tp['test_loss']}, bar "
              f"{EM_LOSS_BAR}), final parameters {tp['params_rel']:.3e} of the update (bar {EM_PARAMS_RTOL}), "
              f"max_abs_err={tp['params_max_err']:.3e}, hash {tp['hash'][:23]}, launches "
              f"{json.dumps({n: tp['launches'][n] for n in KERNEL_ROWS})}")
        check(all(np.isfinite(tp["test_loss"])), f"expertmodel model rank {r}: test loss not finite")
        gap = max(abs(a - b) for a, b in zip(tp["test_loss"], ref_tp["test_loss"]))
        check(gap <= EM_LOSS_BAR, f"expertmodel model rank {r}: eval loss {gap:.3e} from the one process's")
        check(tp["params_rel"] <= EM_PARAMS_RTOL, f"expertmodel model rank {r}: parameters {tp['params_rel']:.3e} "
              "of the update from the one process's")
        check(tp["hash"] == got[0]["model"]["hash"], f"expertmodel model rank {r}: final hash differs from rank 0's")
        check(tp["gather_dim_bytes"] == want_gather and tp["sum_bytes"] == want_sum,
              f"expertmodel model rank {r}: {tp['gather_dim_bytes']} / {tp['sum_bytes']} bytes gathered / summed, "
              f"predicted {want_gather} / {want_sum}")
        for name in KERNEL_ROWS:
            check(tp["launches"][name] > 0 and tp["launches"][name] == ref_tp["launches"][name],
                  f"expertmodel model rank {r}: {name} launched {tp['launches'][name]} times, the one process "
                  f"{ref_tp['launches'][name]}")
    return {f"expert_{label}": {name: [g["expert"]["launches"][name] for g in got] for name in KERNEL_ROWS},
            f"model_{label}": {name: [g["model"]["launches"][name] for g in got] for name in KERNEL_ROWS}}


# Sharded checkpoints over ranks (docstring phase 13e): two worlds of W rank
# processes of this script (``--sharded-worker DIR A|B``), the rank layout of
# phase_seqstage's (one card: two gloo ranks sharing it; two or more: min(cards,
# 4) NCCL ranks). World A runs every arm and saves after every round or
# chunk; world B resumes every arm from A's first save. The one-process
# references run in this process.
SHARDED_FLAG = "--sharded-worker"
SHARDED_DEADLINE_S = 420.0
SHARDED_POP_ROUNDS = 2
# The async arm's depth: 2 windows in chunks of 1 (a save, then a resume
# from it), to keep the phase under 240 s and the whole smoke under 1100 s.
SHARDED_WINDOWS, SHARDED_WINDOW_CHUNK = 2, 1


def sharded_sim(mesh=None, seqs: int = SEQS):
    """Phase 3's flash LM population (its data and seeds, ``seqs`` sequences a
    node) on ``mesh`` (a ``nodes`` or ``{"nodes": 1, "model": W}`` rank
    mesh, or None: this one process)."""
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda" if mesh is None else mesh.device)
    train, xt = lm_data(5, seqs)
    return MeshSimulation(model, train, test_data=(xt, None), train_set_size=COMMITTEE, batch_size=BATCH, lr=LR,
                          seed=1, task="lm", mesh=mesh, device="cuda")


def state_hash(state: dict) -> str:
    """sha256 over a state tree's leaves (their paths and bytes, in order)."""
    import hashlib

    import torch
    from p2pfl_tpu_torch.management.checkpoint import _flatten

    flat: dict = {}
    _flatten(state, "", flat)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_bytes(state: dict) -> int:
    """The tensor bytes of a state tree (what a one-process step stores)."""
    from p2pfl_tpu_torch.management.checkpoint import _flatten

    flat: dict = {}
    _flatten(state, "", flat)
    return sum(t.numel() * t.element_size() for t in flat.values())


def counted(fn, stats: list):
    """``fn`` that appends the collective bytes each of its calls moved
    (``all_gather_bytes``, ``gather_dim_bytes``) to ``stats``."""
    from p2pfl_tpu_torch.parallel import collectives

    def call(*args, **kwargs):
        before = dict(collectives.STATS)
        out = fn(*args, **kwargs)
        stats.append({k: collectives.STATS[k] - before[k] for k in ("all_gather_bytes", "gather_dim_bytes")})
        return out

    return call


def sharded_arm_start() -> None:
    import torch
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()


def sharded_nodes(mesh, root: str, mode: str) -> dict:
    """The LM over the ``nodes`` axis: world A a warm-up and the 2 rounds of
    MULTIRANK_SCHEDULE, saving after each; world B step 1 and round 2."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    ck = FLCheckpointer(os.path.join(root, "lm_nodes"), max_to_keep=2)
    sim = sharded_sim(mesh)
    saves, loads = [], []
    sim.save_to = counted(sim.save_to, saves)
    sched = list(MULTIRANK_SCHEDULE) if mode == "A" else list(MULTIRANK_SCHEDULE[1:])
    sharded_arm_start()
    if mode == "B":
        counted(sim.load_from, loads)(ck, step=1)
    res = sim.run(rounds=len(sched), epochs=1, warmup=True, committee_schedule=np.asarray(sched),
                  checkpointer=ck if mode == "A" else None)
    ck.wait()
    lo, hi = sim.slab
    rows = [sched[0], *sched]  # the warm-up round trains the first row's members too
    return {"s_per_round": res.seconds_per_round, "test_loss": res.test_loss,
            "hash": canonical_params_hash(sim.final_model(0).params),
            "launches": {n: _kernels.LAUNCHES[n] for n in KERNEL_ROWS}, "peak": torch.cuda.max_memory_allocated(),
            "trained": sum(lo <= node < hi for row in rows for node in row), "evals": len(rows),
            "rank_members": sim.rank_members, "last_save": ck.last_save if mode == "A" else None,
            "last_load": ck.last_load if mode == "B" else None, "stats": saves + loads}


def sharded_model(mesh, root: str, mode: str, seqs: int) -> dict:
    """The LM on ``{"nodes": 1, "model": W}`` at ``seqs`` sequences a node:
    world A rounds 1 and 2, saving after each (the gathered state's hash
    after each); world B step 1 and round 2."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.ops import _kernels

    ck = FLCheckpointer(os.path.join(root, "lm_model"), max_to_keep=2)
    sim = sharded_sim(mesh, seqs)
    saves, loads, hashes, seconds = [], [], [], 0.0
    sim.save_to = counted(sim.save_to, saves)
    sharded_arm_start()
    rows = MULTIRANK_SCHEDULE if mode == "A" else MULTIRANK_SCHEDULE[1:]
    if mode == "B":
        counted(sim.load_from, loads)(ck, step=1)
    for row in rows:  # a round a call: world A hashes its gathered state after each save
        res = sim.run(rounds=1, epochs=1, warmup=False, committee_schedule=np.asarray([row]),
                      checkpointer=ck if mode == "A" else None)
        seconds += res.seconds_total
        hashes.append(state_hash(sim.state_dict()))  # beside the save's write, on its thread
    ck.wait()
    return {"s_per_round": seconds / len(rows), "hashes": hashes, "rounds": len(rows),
            "launches": {n: _kernels.LAUNCHES[n] for n in KERNEL_ROWS}, "peak": torch.cuda.max_memory_allocated(),
            "last_save": ck.last_save if mode == "A" else None, "last_load": ck.last_load if mode == "B" else None,
            "stats": saves + loads}


def sharded_engines(mesh, root: str, mode: str) -> dict:
    """Both engines at 100,000 nodes over ``mesh`` (None: this process):
    ``PopulationEngine`` for SHARDED_POP_ROUNDS rounds a round a chunk,
    ``AsyncPopulationEngine`` for SHARDED_WINDOWS windows in chunks of
    SHARDED_WINDOW_CHUNK. World A saves after each chunk; world B resumes
    from the first save; the one process runs them through."""
    import torch
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer
    from p2pfl_tpu_torch.population import AsyncPopulationEngine, PopulationEngine
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    out: dict = {}
    ck = FLCheckpointer(os.path.join(root, "pop_sync"), max_to_keep=2) if mesh is not None else None
    saves, loads = [], []
    sharded_arm_start()
    eng = PopulationEngine(POP_NODES, cohort_fraction=POP_COHORT, seed=POP_SEED, mesh=mesh, device="cuda")
    if mode == "B":
        counted(eng.load_from, loads)(ck, step=1)
    members, seconds = [], 0.0
    for _ in range(SHARDED_POP_ROUNDS if mode != "B" else SHARDED_POP_ROUNDS - 1):
        res = eng.run(1)
        seconds += res.seconds_total
        members += eng.sim.rank_members
        if mode == "A":
            counted(eng.save_to, saves)(ck)
            ck.wait()
    out["sync"] = {"hash": canonical_params_hash(eng.gather_params(0)), "s_per_round": seconds / max(1, len(members)),
                   "rank_members": members, "peak": torch.cuda.max_memory_allocated(),
                   "last_save": ck.last_save if mode == "A" else None,
                   "last_load": ck.last_load if mode == "B" else None, "stats": saves + loads}
    if mesh is None:  # the one-process step's tensor bytes, which the shards add up to
        out["sync"]["step_bytes"] = state_bytes(eng.sim.shard_state())
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ck = FLCheckpointer(os.path.join(root, "pop_async"), max_to_keep=2) if mesh is not None else None
    saves, loads = [], []
    sharded_arm_start()
    eng = AsyncPopulationEngine(POP_NODES, cohort_fraction=POP_COHORT, seed=POP_SEED, speed_tiers=ASYNC_TIERS,
                                mesh=mesh, device="cuda")
    if mode == "B":
        counted(eng.load_from, loads)(ck, step=SHARDED_WINDOW_CHUNK)
    members, seconds, windows = [], 0.0, 0
    for _ in range(SHARDED_WINDOWS // SHARDED_WINDOW_CHUNK - (mode == "B")):
        res = eng.run(SHARDED_WINDOW_CHUNK, eval_every=SHARDED_WINDOW_CHUNK, windows_per_call=SHARDED_WINDOW_CHUNK)
        seconds += res.seconds_total
        windows += res.windows
        members += eng.rank_members
        if mode == "A":
            counted(eng.save_to, saves)(ck)
            ck.wait()
    out["async"] = {"hash": canonical_params_hash(eng.global_params()), "s_per_window": seconds / max(1, windows),
                    "rank_members": members, "peak": torch.cuda.max_memory_allocated(),
                    "last_save": ck.last_save if mode == "A" else None,
                    "last_load": ck.last_load if mode == "B" else None, "stats": saves + loads}
    if mesh is None:
        out["async"]["step_bytes"] = state_bytes(eng.shard_state())
    eng.close()
    return out


def sharded_rank(out_dir: str, mode: str) -> int:
    """One rank of ``phase_sharded``'s world ``mode`` (A or B), started by
    ``launch`` with torchrun's variables: every arm on this rank, its
    result written to ``<dir>/<mode>_rank<r>.json``."""
    import torch
    from p2pfl_tpu_torch.parallel.mesh import Mesh, initialize_multihost, make_mesh, shutdown_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = initialize_multihost(device="cuda")
    rank, world = joined["rank"], joined["world"]
    mesh = make_mesh()
    seqs = EM_GLOO_SEQS if joined["backend"] == "gloo" else SEQS
    out = {"rank": rank, "world": world, "backend": joined["backend"], "seqs": seqs,
           "device": f"{mesh.device} {torch.cuda.get_device_name(mesh.device)}"}
    out["nodes"] = sharded_nodes(mesh, out_dir, mode)
    gc.collect()
    torch.cuda.empty_cache()
    out["model"] = sharded_model(Mesh({"nodes": 1, "model": world}, device=mesh.device, group=mesh.group), out_dir,
                                 mode, seqs)
    gc.collect()
    torch.cuda.empty_cache()
    out["engines"] = sharded_engines(mesh, out_dir, mode)
    with open(os.path.join(out_dir, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_multihost()
    print(f"[sharded] world {mode} rank {rank} of {world} done", flush=True)
    return 0


def sharded_world(mode: str, tmp: str, world: int, label: str) -> list:
    """Launch world ``mode`` and read its ranks' results (each rank must exit 0)."""
    from p2pfl_tpu_torch.parallel.launch import launch

    t0 = time.monotonic()
    runs = launch([sys.executable, os.path.abspath(__file__), SHARDED_FLAG, tmp, mode], world,
                  timeout_s=SHARDED_DEADLINE_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - t0
    for rank, (rc, out) in enumerate(runs):
        if rc != 0:
            print(out[-6000:])
        check(rc == 0, f"sharded {label} world {mode} rank {rank} exited {rc}")
    got = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{mode}_rank{rank}.json")) as f:
            got.append(json.load(f))
    print(f"[sharded] {label} world {mode}: {wall:.1f} s for the world (start to exit)")
    return got


def phase_sharded(card: str) -> dict:
    """Sharded checkpoints and both engines over ranks on the card (docstring
    phase 13e). Returns each world's launches per rank under the kernel
    rows' names."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from p2pfl_tpu_torch.management.checkpoint import FLCheckpointer

    backend, world = seqstage_arm(torch.cuda.device_count())
    label = f"{backend}{world}"
    seqs = EM_GLOO_SEQS if backend == "gloo" else SEQS
    per_member = KERNEL_ROWS["flash_fwd"][1] // COMMITTEE
    print(f"[sharded] {card}: {label}; the LM over nodes (8 nodes, committee 4, {SEQS} x {SEQ_LEN} tokens a node) and "
          f"over nodes 1 x model {world} ({seqs} sequences a node), PopulationEngine and AsyncPopulationEngine at "
          f"{POP_NODES} nodes")
    # The one-process references: the uninterrupted runs (the nodes arm's is
    # phase_multirank's, when it ran in this process).
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    ref = ONE_PROCESS_LM or multirank_run(sharded_sim())
    ref_hash = ref["hash"]
    source = " (phase_multirank's run)" if ONE_PROCESS_LM else ""
    print(f"[sharded] one process, nodes arm{source}: {ref['s_per_round']:.4f} s/round, hash {ref_hash[:23]}, peak "
          f"{ref['peak_bytes']} B")
    gc.collect()
    torch.cuda.empty_cache()
    ref_eng = sharded_engines(None, "", "one")
    print(f"[sharded] one process, engines: sync {ref_eng['sync']['s_per_round']:.4f} s/round, async "
          f"{ref_eng['async']['s_per_window']:.4f} s/window, hashes {ref_eng['sync']['hash'][:23]} / "
          f"{ref_eng['async']['hash'][:23]}")
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"[sharded] {free} B free under build/")
        got_a = sharded_world("A", tmp, world, label)
        # This process restores world A's W-rank steps: the nodes arm's step 1
        # (then round 2), the model arm's step 1 (its gathered state).
        sim = sharded_sim()
        one_step_bytes = state_bytes(sim.shard_state())
        ck = FLCheckpointer(os.path.join(tmp, "lm_nodes"), max_to_keep=2)
        sim.load_from(ck, step=1)
        one_load = dict(ck.last_load)
        sim.run(rounds=1, epochs=1, warmup=False, committee_schedule=np.asarray(MULTIRANK_SCHEDULE[1:]))
        one_resumed_hash = canonical_params_hash(sim.final_model(0).params)
        del sim
        gc.collect()
        torch.cuda.empty_cache()
        sim = sharded_sim(None, seqs)
        sim.load_from(FLCheckpointer(os.path.join(tmp, "lm_model"), max_to_keep=2), step=1)
        one_model_hash = state_hash(sim.state_dict())
        one_model_bytes = state_bytes(sim.shard_state())
        del sim
        gc.collect()
        torch.cuda.empty_cache()
        got_b = sharded_world("B", tmp, world, label)
    print(f"[sharded] one process restoring world A's {world}-rank nodes step 1: load {one_load['load_ms']:.1f} ms "
          f"({one_load['tensor_bytes']} B from {len(one_load['files'])} files), round 2 -> hash "
          f"{one_resumed_hash[:23]}")
    check(one_resumed_hash == ref_hash, "sharded: the one process resumed from the W-rank step differs")
    want_model = got_a[0]["model"]["hashes"]
    check(one_model_hash == want_model[0], "sharded: the model arm's step 1 restored in one process differs from "
          "world A's gathered state")
    for g in got_a + got_b:
        check(g["backend"] == backend and g["world"] == world, f"sharded: rank {g['rank']} joined {g['backend']}")
    # Each arm's step: every rank's shard and rank 0's replicated leaves hold
    # the one-process step's tensor bytes, no leaf twice and none left out.
    for arm, save_of, one_bytes in (
            ("nodes", lambda g: g["nodes"]["last_save"], one_step_bytes),
            ("model", lambda g: g["model"]["last_save"], one_model_bytes),
            ("sync engine", lambda g: g["engines"]["sync"]["last_save"], ref_eng["sync"]["step_bytes"]),
            ("async engine", lambda g: g["engines"]["async"]["last_save"], ref_eng["async"]["step_bytes"])):
        saves = [save_of(g) for g in got_a]
        shards = [sv["tensor_bytes"] for sv in saves]
        repl = saves[0]["replicated_tensor_bytes"]
        print(f"[sharded] {arm} arm step: shards {shards} B + replicated {repl} B = {sum(shards) + repl} B (one "
              f"process {one_bytes} B); files {[sv['file_bytes'] for sv in saves]} B [{card}]")
        check(sum(shards) + repl == one_bytes, f"sharded: the {arm} arm's shards do not add up to the one-process step")
    for mode, got in (("A", got_a), ("B", got_b)):
        for g in got:
            r, nodes, model, eng = g["rank"], g["nodes"], g["model"], g["engines"]
            save = nodes["last_save"] or {}
            load = nodes["last_load"] or {}
            print(f"[sharded] {label} world {mode} rank {r} nodes arm: {nodes['s_per_round']:.4f} s/round, members "
                  f"per rank per round {nodes['rank_members']}, save host-copy {save.get('host_copy_ms', 0):.1f} ms "
                  f"write {save.get('write_ms', 0):.1f} ms commit-wait {save.get('commit_wait_ms', 0):.1f} ms "
                  f"({save.get('file_bytes', 0)} B), load {load.get('load_ms', 0):.1f} ms ({load.get('files')}), "
                  f"peak {nodes['peak']} B, hash {nodes['hash'][:23]}, launches {json.dumps(nodes['launches'])}, "
                  f"device {g['device']} [{card}]")
            check(nodes["hash"] == ref_hash, f"sharded {mode} rank {r}: the nodes arm's hash differs from one process's")
            for name in KERNEL_ROWS:  # a rank that holds none of a round's members launches no training kernel
                want = nodes["evals"] * KERNEL_ROWS[name][1] if name == "flash_fwd_no_lse" else (
                    nodes["trained"] * per_member)
                check(nodes["launches"][name] == want,
                      f"sharded {mode} rank {r}: {name} launched {nodes['launches'][name]} times, expected {want}")
            msave = model["last_save"] or {}
            mload = model["last_load"] or {}
            print(f"[sharded] {label} world {mode} rank {r} model arm: {model['s_per_round']:.4f} s/round, save "
                  f"host-copy {msave.get('host_copy_ms', 0):.1f} ms write {msave.get('write_ms', 0):.1f} ms "
                  f"commit-wait {msave.get('commit_wait_ms', 0):.1f} ms ({msave.get('file_bytes', 0)} B), load "
                  f"{mload.get('load_ms', 0):.1f} ms, peak {model['peak']} B, launches {json.dumps(model['launches'])}")
            check(model["hashes"][-1] == want_model[-1], f"sharded {mode} rank {r}: the model arm's gathered state "
                  "differs from world A's step 2")
            steps = seqs // BATCH
            for name in KERNEL_ROWS:
                want = model["rounds"] * (LAYERS if name == "flash_fwd_no_lse" else COMMITTEE * steps * LAYERS)
                check(model["launches"][name] == want,
                      f"sharded {mode} rank {r}: model {name} launched {model['launches'][name]}, expected {want}")
            for arm, unit in (("sync", "s_per_round"), ("async", "s_per_window")):
                e = eng[arm]
                esave, eload = e["last_save"] or {}, e["last_load"] or {}
                print(f"[sharded] {label} world {mode} rank {r} {arm} engine: {e[unit]:.4f} {unit.replace('_per_', '/')}, "
                      f"members per rank {e['rank_members']}, save write {esave.get('write_ms', 0):.1f} ms "
                      f"commit-wait {esave.get('commit_wait_ms', 0):.1f} ms ({esave.get('tensor_bytes', 0)} B), load "
                      f"{eload.get('load_ms', 0):.1f} ms, peak {e['peak']} B, hash {e['hash'][:23]}")
                check(e["hash"] == ref_eng[arm]["hash"], f"sharded {mode} rank {r}: the {arm} engine's hash differs")
            for what, stats in (("nodes", nodes["stats"]), ("model", model["stats"]),
                                ("sync", eng["sync"]["stats"]), ("async", eng["async"]["stats"])):
                check(bool(stats) and all(s["all_gather_bytes"] == 0 and s["gather_dim_bytes"] == 0 for s in stats),
                      f"sharded {mode} rank {r}: {what} save_to / load_from gathered {stats}")
        for arm in ("nodes", "model"):
            for name in KERNEL_ROWS:
                check(sum(g[arm]["launches"][name] for g in got) > 0, f"sharded {mode}: the {arm} arm never "
                      f"launched {name}")
    return {f"sharded_{arm}_{mode}_{label}": {name: [g[arm]["launches"][name] for g in got] for name in KERNEL_ROWS}
            for mode, got in (("A", got_a), ("B", got_b)) for arm in ("nodes", "model")}


def phase_longcontext() -> dict:
    """``python -m p2pfl_tpu_torch.examples.longcontext --attention flash``
    at its defaults, in this process so that its kernel launches count;
    returns {"<name>_d16_lc": launches}."""
    from p2pfl_tpu_torch.examples import longcontext
    from p2pfl_tpu_torch.ops import _kernels

    args = longcontext.build_parser().parse_args(["--attention", "flash"])
    _kernels.reset_launches()
    res = longcontext.run(args)
    launches = dict(_kernels.LAUNCHES)
    print(f"[longcontext] {res}; kernels {json.dumps(launches)}")
    check(res["final_token_loss"] < res["first_token_loss"], "longcontext: the token loss did not fall")
    for name in KERNEL_ROWS:
        check(launches[name] > 0, f"longcontext: {name} was never launched")
    return {name + LC_SUFFIX: launches[name] for name in KERNEL_ROWS}


def phase_entry() -> None:
    """``entry()``'s forward on the card: [64, 10] finite logits; on a
    seeded random batch, the card's logits within four bf16 ulps of the
    largest of the CPU's (cuBLAS and the CPU round bf16 activations in their
    own order; the zero batch meets zero biases and holds no weight)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.entry import entry

    forward, (params, x) = entry()
    out = forward(params, x)
    torch.cuda.synchronize()
    print(f"[entry] forward on {x.device}: logits {tuple(out.shape)} {out.dtype}")
    check(out.device.type == "cuda" and tuple(out.shape) == (64, 10) and bool(torch.isfinite(out).all()),
          "entry: the forward did not give [64, 10] finite logits on the card")
    xr = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 28, 28)).astype(np.float32))
    cpu_forward, (cpu_params, _) = entry(device="cpu")
    ref = cpu_forward(cpu_params, xr)
    got = forward(params, xr.cuda()).cpu()
    tol = 4 * 2.0 ** (float(torch.floor(torch.log2(ref.abs().max()))) - 7)
    err = float((got - ref).abs().max())
    print(f"[entry] a seeded random batch: card against CPU max_abs_err {err:.3e} (tol {tol:g}, four bf16 ulps "
          f"of the largest logit {float(ref.abs().max()):.4f})")
    check(err <= tol, "entry: the card's logits disagree with the CPU's on a random batch")


def phase_kernels_wide(label: str, head_dims: dict, seed: int) -> dict:
    """Rows 1-5 at each head size of ``head_dims`` (head size -> heads, the
    LM's width over them: [8, 1024, H, D], the eval forward at [16, 1024, H,
    D], one ring chunk [2, 1024, H, D]) in bf16 and f32, held to the bars of
    phases 2 and 5 and timed beside aten; returns {"<name>_d<D>": row}."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    rows: dict = {}
    for d, heads in head_dims.items():
        rows.update(narrow_rows(label, narrow_suffix(d), d, heads, BATCH, EVAL_SEQS, SEQ_LEN,
                                (torch.bfloat16, torch.float32), True, gen))
    return rows


def phase_wide_paths() -> dict:
    """The slice's LM and the ring trainer at width 512 over 2 heads (D 256)
    and over 1 head (D 512), each LM after a warm-up round; returns their
    launches under the ``_d256`` / ``_d512`` rows' names."""
    dims = {**D256_HEAD_DIMS, **D512_HEAD_DIMS}
    return head_size_paths("wide-paths", [(d, h, d * h) for d, h in dims.items()], warm=tuple(dims))


def phase_kernels_chunked() -> dict:
    """Rows 1-5 above the largest compiled head size (the bf16 forward and
    backward pair on the grouped tensor-core kernels, the rest on the chunked
    kernels), in bf16 and f32, held to the bars of phases 2 and 5 and timed
    beside whatever fused library call takes the shape
    (``library_above_512``): at D 1024 over 1 head at the chunked-paths
    phase's shapes ([8, 1024, 1, 1024], the eval forward at [16, ...], the
    carry at one ring chunk [2, 1024, 1, 1024]), and at D 600 (zero-padded
    to 640) at [1, 1024, 1, 600]; returns {"<name>_d1024": row} (the D 600
    rows are printed only: no path runs them)."""
    import torch

    gen = torch.Generator().manual_seed(20)
    rows: dict = {}
    for d, heads in D1024_HEAD_DIMS.items():
        rows.update(narrow_rows("d1024", narrow_suffix(d), d, heads, BATCH, EVAL_SEQS, SEQ_LEN,
                                (torch.bfloat16, torch.float32), True, gen))
    narrow_rows("d1024", narrow_suffix(CHUNKED_PADDED_DIM), CHUNKED_PADDED_DIM, 1, 1, 1, SEQ_LEN,
                (torch.bfloat16, torch.float32), True, gen)
    return rows


def phase_carry_one_launch() -> None:
    """In a process of its own each (``carry_call_kernels``), one bf16 carry
    call at [2, 1024, 1, 512] must be one CUDA kernel, the grouped carry, and
    one at [2, 1024, 16, 32] the narrow carry: no pad or slice copies."""
    calls = (("carry-grouped", [RING_BATCH, RING_SHARD, 1, 512], "flash_carry_grouped_sm90_kernel"),
             ("carry-narrow", [RING_BATCH, RING_SHARD, EMBED // 32, 32], "flash_carry_narrow_sm90_kernel"))
    for label, shape, kernel in calls:
        names = in_fresh_process(f"carry_call_kernels({shape})")
        print(f"[{label}] one call of flash_carry at {shape} bf16: CUDA kernels {names}")
        check(len(names) == 1 and kernel in names[0], f"the carry call at {shape} is not {kernel} alone: {names}")


def phase_chunked_paths() -> dict:
    """The slice's LM (after a warm-up round) and the ring trainer at width
    1024 over 1 head (D 1024: the bf16 forward and backward pair on the
    grouped kernels, the rest on the chunked ones), cut to one layer;
    returns their launches under the ``_d1024`` rows' names."""
    return head_size_paths("chunked-paths", [(d, h, d * h) for d, h in D1024_HEAD_DIMS.items()], CHUNKED_LAYERS,
                           warm=tuple(D1024_HEAD_DIMS))


def phase_topk_ties() -> None:
    """The three top-k encoders (and ``topk_select``) on inputs whose
    magnitudes tie at the k-th place, on the card and on the CPU: the same
    lowest-index members, values, scales and residuals (the rule of
    ``jax.lax.top_k``, which the CPU tests hold the port to)."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.ops import compression as comp

    rng = np.random.default_rng(8)
    size, k = 1 << 20, 104_858
    grid = rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32), size)
    cases = {
        "grid": (grid, (0.25 * rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), size)).astype(np.float32)),
        "zeros": (np.where(rng.random(size) < 0.05, grid, 0.0).astype(np.float32), np.zeros(size, np.float32)),
    }
    for case, (delta, residual) in cases.items():
        acc = np.abs(delta + residual)
        kth = np.sort(acc)[::-1][k - 1]
        out = {}
        for dev in ("cuda", "cpu"):
            d, r = torch.from_numpy(delta).to(dev), torch.from_numpy(residual).to(dev)
            got = {"select": comp.topk_select(d + r, k), "bf16": comp.ef_topk_encode(d, r, k, "bf16")}
            for bits in (8, 4):
                idx, q, scale, res = comp.ef_topk_quant_encode(d, r, k, bits)
                got[f"int{bits}"] = (idx, q, torch.tensor(scale), res)
            out[dev] = {name: [t.cpu() for t in ts] for name, ts in got.items()}
        for name in out["cpu"]:
            same = all(torch.equal(a, b) for a, b in zip(out["cuda"][name], out["cpu"][name]))
            print(f"[topk-ties] {case} ({int((acc == kth).sum())} elements tie at the k-th magnitude {kth:g}, "
                  f"k {k}): {name} card == CPU {'ok' if same else 'FAIL'}")
            check(same, f"top-k {name} on tied inputs ({case}): the card differs from the CPU")


def cnn_model_f(dev):
    from p2pfl_tpu_torch.models.cnn import cnn_model

    return cnn_model(seed=0, device=dev)


def phase_cnn(parts: list) -> None:
    """The CNN round on phase 7's MNIST data (committee 4, batch 64), then
    held on the card against the CPU as phase 7 holds the MLP."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    model = cnn_model_f("cuda")
    print(f"[cnn] CNN conv32-pool-conv64-pool-dense128 ({sum(p.numel() for p in model.params.values())} params, "
          f"{model.module.compute_dtype}); {MLP_NODES} nodes x {MLP_SAMPLES} samples, committee {MLP_COMMITTEE}")
    with MeshSimulation(model, parts, train_set_size=MLP_COMMITTEE, batch_size=MLP_BATCH, seed=1,
                        device="cuda") as sim:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        res = sim.run(rounds=CNN_ROUNDS, epochs=1, warmup=True)
        launches = dict(_kernels.LAUNCHES)
    print(f"[cnn] {CNN_ROUNDS} rounds: {res.seconds_per_round:.4f} s/round; test loss {res.test_loss}, accuracy "
          f"{res.test_acc}; max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; kernels "
          f"{json.dumps(launches)} (the CNN runs none of the port's kernels)")
    check(all(np.isfinite(res.test_loss)), "CNN: non-finite test loss")
    check(res.test_loss[-1] < res.test_loss[0], "CNN: test loss did not fall over the rounds")
    check(res.test_acc[-1] > 0.5, f"CNN: final test accuracy {res.test_acc[-1]} is not above 0.5")
    device_parity("cnn", parts, {}, {}, make_model=cnn_model_f)


def phase_cifar(profiling: bool) -> None:
    """``examples/cifar.py`` at its defaults with ``--rounds 2 --cost-analysis``
    on the card (s/round, peak memory, per-round test accuracy, the counted
    FLOPs of a round and the rate they give at that s/round; with ``profiling``, one
    more run of the example with ``--rounds 1`` under torch.profiler); then
    at f64 compute the ResNet-18's loss gradients on one batch (each leaf
    within 1e-5 of its largest gradient) and one scheduled round at 4 nodes
    (32 samples each, 32 x 32), on the card against the CPU, as phase 7
    holds the MLP."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.examples import cifar
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_cifar10
    from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
    from p2pfl_tpu_torch.models.resnet import resnet18_model
    from p2pfl_tpu_torch.ops import _kernels

    args = cifar.build_parser().parse_args(["--rounds", str(CIFAR_ROUNDS), "--seed", "1", "--cost-analysis"])
    print(f"[cifar] examples/cifar.py: {args.nodes} nodes x {args.samples_per_node} samples ({args.image_size} x "
          f"{args.image_size}), committee {args.train_set_size}, batch {args.batch_size}, {args.aggregator}, "
          f"Dirichlet {args.alpha}, {args.rounds} rounds after a warm-up round")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = cifar.run(args)
    peak = torch.cuda.max_memory_allocated()
    print(f"[cifar] {res['sec_per_round']:.4f} s/round; test accuracy per round {res['test_acc']}; "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); kernels {json.dumps(dict(_kernels.LAUNCHES))}"
          f" (ResNet-18 runs none of the port's kernels)")
    check(len(res["test_acc"]) == CIFAR_ROUNDS and all(np.isfinite(res["test_acc"])),
          "cifar: missing or non-finite test accuracy")
    cost = res["cost_analysis"]
    check(cost is not None and cost["flops_per_round"] > 0, "cifar: --cost-analysis returned no FLOPs")
    print(f"[cifar] --cost-analysis: {cost['flops_per_round'] / 1e12:.4f} TFLOP/round, "
          f"{cost['bytes_accessed_per_round'] / 1e9:.3f} GB counted per round; "
          f"{cost['flops_per_round'] / res['sec_per_round'] / 1e12:.3f} TFLOP/s at {res['sec_per_round']:.4f} "
          f"s/round on {nvidia_smi()}")
    if profiling:
        phase_profile("cifar: examples/cifar.py --rounds 1 (set-up, the warm-up round and one round)",
                      lambda: cifar.run(cifar.build_parser().parse_args(["--rounds", "1", "--seed", "2"])))
    data = synthetic_cifar10(n_train=4 * 32, n_test=256, seed=42)
    parts = data.generate_partitions(4, RandomIIDPartitionStrategy)
    # At f64 compute. In f32 the ResNet's gradient is itself ill-conditioned
    # (GroupNorm's E[x^2] - E[x]^2, as flax computes it, over 18 layers): on
    # the CPU its f32 and f64 gradients differ by 3.1e-3 of the worst leaf's
    # largest, and the card's f32 one by 8.8e-3 from the CPU's, where at f64
    # the two agree within 1.2e-7 (the f32 logits' cast bounds that).
    x, y = (torch.from_numpy(a) for a in parts[0].export_arrays(True))
    grads = {}
    for dev in ("cuda", "cpu"):
        with Settings.overridden(COMPUTE_DTYPE="float64"):
            model = resnet18_model(seed=0, device=dev)
        leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.items()}
        loss = softmax_cross_entropy(model.apply(leaves, x.to(dev)), y.to(dev).long(), torch.ones(len(y), device=dev))
        grads[dev] = {k: g.cpu() for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}
    worst = max(float((grads["cuda"][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for k, g in grads["cpu"].items())
    print(f"[cifar] ResNet-18 loss gradients at f64 compute on one batch of 32, card against CPU: worst leaf "
          f"differs by {worst:.3e} of its largest gradient (tol 1e-5)")
    check(worst <= 1e-5, "resnet18: the card's gradients disagree with the CPU's")
    device_parity("resnet18", parts, {}, {}, make_model=lambda dev: resnet18_model(seed=0, device=dev),
                  schedule=((0, 1, 2, 3),), batch=32, n_test=256, compute="float64")


class ShapeLog:
    """While open, records the q shape of every kernel launch of rows 1-4
    (wrapping the wrappers of ``_kernels``, which still count)."""

    NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def __enter__(self):
        from p2pfl_tpu_torch.ops import _kernels

        self.shapes, self.saved = set(), {n: getattr(_kernels, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def wrapped(q, *args, _fn=fn, **kw):
                self.shapes.add(tuple(q.shape))
                return _fn(q, *args, **kw)
            setattr(_kernels, n, wrapped)
        return self

    def __exit__(self, *exc):
        from p2pfl_tpu_torch.ops import _kernels

        for n, fn in self.saved.items():
            setattr(_kernels, n, fn)


def phase_moe(profiling: bool) -> dict:
    """``moe_lm_model`` at the federated LM's widths with flash attention
    (bf16): its logits against dense attention's on a small input, then
    ``MOE_STEPS`` Adam steps on loss + 0.01 aux at batch ``BATCH`` and an
    eval forward at ``EVAL_SEQS``, with every count set to 0 before and read
    after; the kernels must run at rows 1-4's shapes (with ``profiling``,
    one more step under torch.profiler). Returns the launches."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.model_handle import ModelHandle
    from p2pfl_tpu_torch.models.moe import MoETransformerLM, moe_lm_apply_with_aux, moe_lm_model
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam, apply_updates

    model = moe_lm_model(seed=0, seq_len=SEQ_LEN, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                         embed_dim=EMBED, num_experts=MOE_EXPERTS, attention_kind="flash", device="cuda")
    n_params = sum(p.numel() for p in model.params.values())
    cap = max(1, int(1.25 * BATCH * SEQ_LEN / MOE_EXPERTS))
    print(f"[moe] MoETransformerLM flash {LAYERS}L ({LAYERS // 2} routed)/{EMBED}d/{HEADS}h, {MOE_EXPERTS} experts, "
          f"vocab {VOCAB}: {n_params} params; dispatch [T, X, C] = [{BATCH * SEQ_LEN}, {MOE_EXPERTS}, {cap}] "
          f"({BATCH * SEQ_LEN * MOE_EXPERTS * cap} elements a routed layer)")
    # Reference on a small input at f32 compute, where no token's routing can
    # flip on rounding (in bf16 a token whose top two router probabilities
    # nearly tie may take another expert under another attention kernel):
    # the flash model (the f32 kernels) against dense attention.
    with torch.device("meta"):
        flash32, dense32 = (MoETransformerLM(VOCAB, LAYERS, HEADS, EMBED, MOE_EXPERTS, attention_kind=kind,
                                             compute_dtype=torch.float32) for kind in ("flash", "dense"))
    toks = torch.randint(0, VOCAB, (2, 256), generator=torch.Generator().manual_seed(3)).cuda()
    with torch.no_grad():
        got = ModelHandle(model.params, flash32).apply(model.params, toks)
        ref = ModelHandle(model.params, dense32).apply(model.params, toks)
    err = float((got - ref).abs().max())
    print(f"[moe] f32 flash vs dense logits on [2, 256]: max_abs_err={err:.3e} tol 1e-4")
    check(bool(torch.isfinite(got).all()) and err <= 1e-4, "MoE: flash logits disagree with dense attention")

    (x, _, _), xt = lm_data(13)
    tokens = torch.from_numpy(x[0, :BATCH]).cuda()
    test = torch.from_numpy(xt).cuda()
    apply = moe_lm_apply_with_aux(model.module)
    opt = adam(LR)
    params, state, losses, auxes = dict(model.params), opt.init(model.params), [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()

    def step(params, state):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits, aux = apply(leaves, tokens)
        loss = causal_lm_loss(logits, tokens) + MOE_AUX * aux
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        return apply_updates(params, updates), state, loss.detach(), aux.detach()

    with ShapeLog() as log:
        t0 = time.monotonic()
        for _ in range(MOE_STEPS):
            params, state, loss, aux = step(params, state)
            losses.append(loss)
            auxes.append(aux)
        torch.cuda.synchronize()
        step_s = (time.monotonic() - t0) / MOE_STEPS
        with torch.no_grad():
            t0 = time.monotonic()
            eval_loss = causal_lm_loss(model.apply(params, test), test)
            torch.cuda.synchronize()
            eval_s = time.monotonic() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses, auxes = [float(v) for v in losses], [float(v) for v in auxes]
    print(f"[moe] {MOE_STEPS} Adam steps at batch {BATCH}: {step_s:.4f} s/step (the first included; host clock "
          f"ending in torch.cuda.synchronize()); loss + {MOE_AUX} aux per step {losses}, aux {auxes}; eval at "
          f"batch {EVAL_SEQS}: loss {float(eval_loss):.4f} in {eval_s:.4f} s")
    print(f"[moe] max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB); kernels {json.dumps(launches)}; "
          f"q shapes {sorted(log.shapes)}")
    check(all(np.isfinite(losses)) and np.isfinite(float(eval_loss)), "MoE: non-finite loss")
    check(losses[-1] < losses[0], "MoE: the loss did not fall over the steps")
    check(log.shapes <= {(BATCH, SEQ_LEN, HEADS, EMBED // HEADS), (EVAL_SEQS, SEQ_LEN, HEADS, EMBED // HEADS)},
          f"MoE: kernels ran at shapes {sorted(log.shapes)}, not rows 1-4's")
    expected = {"flash_fwd": MOE_PER_STEP * MOE_STEPS, "flash_bwd_dq": MOE_PER_STEP * MOE_STEPS,
                "flash_bwd_dkv": MOE_PER_STEP * MOE_STEPS, "flash_fwd_no_lse": LAYERS, "flash_carry": 0}
    for name, n in expected.items():
        check(launches[name] == n, f"MoE: {name} launched {launches[name]} times, expected {n}")
    if profiling:
        phase_profile("moe: one train step", lambda: step(params, state))
    return {name: launches[name] for name in KERNEL_ROWS}


def phase_kernels_pipeline() -> dict:
    """Rows 1-4 at the pipeline's microbatch shape [2, 1024, 8, 64] (bf16,
    the tensor-core kernels), the eval forward there too, held to phase 2's
    bars and timed beside aten; returns {"<name>_pp": row}."""
    import torch

    return narrow_rows("pp-kernels", PP_SUFFIX, EMBED // HEADS, HEADS, BATCH // PP_MICRO, BATCH // PP_MICRO,
                       SEQ_LEN, (torch.bfloat16,), False, torch.Generator().manual_seed(17))


def pp_flat(tree: dict) -> dict:
    """Pipelined LM params ``{group: {name: t}}`` as ``{"group/name": t}``."""
    return {f"{group}/{name}": t for group, leaves in tree.items() for name, t in leaves.items()}


def pp_nested(leaves: dict) -> dict:
    out: dict = {}
    for key, t in leaves.items():
        group, name = key.split("/", 1)
        out.setdefault(group, {})[name] = t
    return out


def pipelined_steps(apply_fn, pp_params: dict, tokens) -> dict:
    """The pipelined LM's no-grad forward, then ``PP_STEPS`` Adam steps
    through the pipeline, every count set to 0 before and read after:
    logits, losses, s/step (the first step included), final flat params,
    launches, the q shapes of rows 1-4, peak memory and ppermute bytes."""
    import torch
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.optim import adam, apply_updates
    from p2pfl_tpu_torch.parallel import collectives

    opt = adam(LR)
    params = pp_flat(pp_params)
    state = opt.init(params)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    collectives.reset_stats()
    with ShapeLog() as log:
        with torch.no_grad():
            logits = apply_fn(pp_params, tokens)
        t0 = time.monotonic()
        for _ in range(PP_STEPS):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = causal_lm_loss(apply_fn(pp_nested(leaves), tokens), tokens)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
            losses.append(loss.detach())
        torch.cuda.synchronize()
        step_s = (time.monotonic() - t0) / PP_STEPS
    return {"logits": logits, "losses": [float(v) for v in losses], "s_per_step": step_s, "params": params,
            "launches": dict(_kernels.LAUNCHES), "shapes": log.shapes, "peak": torch.cuda.max_memory_allocated(),
            "bytes": collectives.STATS["ppermute_bytes"]}


def phase_pipeline() -> dict:
    """``make_pipelined_transformer_lm`` of the flash LM over ``PP_STAGES``
    stages of one layer, a batch of ``BATCH`` in ``PP_MICRO`` microbatches:
    its logits against the unpipelined model's (bf16 bar: 2^-5 of the
    largest logit), then ``PP_STEPS`` Adam steps through the pipeline, with
    every count set to 0 before the pipelined runs and read after; the
    kernels must run at [2, 1024, 8, 64]. Returns the launches under the
    ``_pp`` rows' names."""
    import numpy as np
    import torch
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.mesh import Mesh
    from p2pfl_tpu_torch.parallel.pipeline import make_pipelined_transformer_lm

    model = transformer_lm_model(seed=0, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                                 attention_kind="flash", device="cuda")
    mesh = Mesh({"stage": PP_STAGES}, device="cuda")
    pp_params, apply_fn = make_pipelined_transformer_lm(model, mesh, PP_MICRO)
    tokens = pp_tokens()
    with torch.no_grad():
        ref = model.apply(model.params, tokens)
    micro = (BATCH // PP_MICRO, SEQ_LEN, HEADS, EMBED // HEADS)
    print(f"[pipeline] TransformerLM flash over {mesh}: {LAYERS // PP_STAGES} layer(s) a stage, batch {BATCH} in "
          f"{PP_MICRO} microbatches (kernels at {list(micro)})")
    run = pipelined_steps(apply_fn, pp_params, tokens)
    launches, losses, got = run["launches"], run["losses"], run["logits"]
    tol = 2.0 ** -5 * float(ref.abs().max())
    err = float((got - ref).abs().max())
    print(f"[pipeline] pipelined vs unpipelined logits on [{BATCH}, {SEQ_LEN}]: max_abs_err={err:.3e} tol {tol:.3e} "
          f"(2^-5 of the largest logit)")
    print(f"[pipeline] {PP_STEPS} Adam steps: {run['s_per_step']:.4f} s/step (the first included); loss per step "
          f"{losses}; max_memory_allocated {run['peak']} bytes ({run['peak'] / 2**30:.2f} GiB); kernels "
          f"{json.dumps(launches)}; q shapes {sorted(run['shapes'])}")
    check(bool(torch.isfinite(got).all()) and err <= tol, "pipeline: the pipelined logits disagree with the model's")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "pipeline: the loss did not fall over the steps")
    check(run["shapes"] == {micro}, f"pipeline: kernels ran at shapes {sorted(run['shapes'])}, expected {list(micro)}")
    expected = {"flash_fwd": PP_PER_PASS * PP_STEPS, "flash_bwd_dq": PP_PER_PASS * PP_STEPS,
                "flash_bwd_dkv": PP_PER_PASS * PP_STEPS, "flash_fwd_no_lse": PP_PER_PASS, "flash_carry": 0}
    for name, n in expected.items():
        check(launches[name] == n, f"pipeline: {name} launched {launches[name]} times, expected {n}")
    return {name + PP_SUFFIX: launches[name] for name in KERNEL_ROWS}


def pp_tokens():
    """The pipeline's batch: ``BATCH`` sequences of phase 3's data (seed 14),
    on the card."""
    import torch

    (x, _, _), _ = lm_data(14)
    return torch.from_numpy(x[0, :BATCH]).cuda()


def phase_dryrun() -> None:
    """``dryrun_multichip(4)`` on the card: every phase prints its OK line."""
    import contextlib
    import io

    from p2pfl_tpu_torch.entry import dryrun_multichip

    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[dryrun] {line}")
    print(f"[dryrun] {time.monotonic() - t0:.1f} s")
    check(sum(" OK" in line for line in lines) == 5, "dryrun_multichip: not every phase printed its OK line")


def phase_profile(label: str, run) -> None:
    """``run()`` (one more round or step) under torch.profiler: device time by
    kernel class, the wall time under the profiler, and the device's busy
    share of it (an upper bound on idle, since tracing slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [(name, us) for us, name in cuda_kernels(prof)]
    check(bool(kernels), "the profiler recorded no CUDA kernel")
    classes: dict = {}
    by_name: dict = {}
    for name, us in kernels:
        low = name.lower()
        cls = ("flash kernels (this port)" if "flash_" in low and "kernel" in low
               else "GEMM (cuBLAS)" if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma", "cublas"))
               else "memcpy/memset" if "memcpy" in low or "memset" in low
               else "elementwise/reduction/other")
        classes[cls] = classes.get(cls, 0.0) + us
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(classes.values())
    print(f"[profile] {label} under torch.profiler: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), {len(kernels)} kernel launches")
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cls}: {us / 1e3:.1f} ms ({us / busy:.1%} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   top: {us / 1e3:8.2f} ms  {name[:110]}")


def time_phases() -> None:
    """Make every ``phase_*`` function print its own wall time when it
    returns or fails (``[time] <phase>: <s> s``), so that the script's time
    limit can be kept phase by phase."""
    import functools

    def timed(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                print(f"[time] {fn.__name__}: {time.monotonic() - t0:.1f} s")
        return run

    for name in [n for n in globals() if n.startswith("phase_")]:
        globals()[name] = timed(globals()[name])


def row_source(name: str, d: int, sm90_source: str) -> str:
    """The source of the bf16 kernel that row ``name`` runs at head size
    ``d``: the narrow forward's, backward pair's or carry's where
    ``kernel_route`` names them (wherever the wrapper hands the kernel a
    head size below 64), else
    ``sm90_source`` (the D = 64 tensor-core kernel's) at D <= 64, the
    grouped carry's above 64, the wide forward's or backward pair's at 128
    and 256, the grouped forward's or backward pair's above 256."""
    import torch
    from p2pfl_tpu_torch.ops import _kernels

    kd, route = _kernels.kernel_route(name, torch.bfloat16, d)
    forward = name in _kernels.FORWARDS
    if route == _kernels.NARROW and name == "flash_carry":
        return SOURCE_CARRY_NARROW
    if route == _kernels.NARROW:
        return SOURCE_FWD_NARROW if forward else SOURCE_BWD_NARROW
    if kd == _kernels.SM90_HEAD_DIM:
        return sm90_source
    if name == "flash_carry":
        return SOURCE_CARRY_GROUPED
    if kd > _kernels.SM90_GROUPED_ABOVE:
        return SOURCE_FWD_GROUPED if forward else SOURCE_BWD_GROUPED
    return SOURCE_FWD_WIDE if forward else SOURCE_BWD_WIDE


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on the card", file=sys.stderr)
        return 1
    try:
        import p2pfl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the p2pfl_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [MULTIRANK_FLAG]:  # one rank of phase_multirank
        return multirank_rank(sys.argv[2])
    if sys.argv[1:2] == [SEQSTAGE_FLAG]:  # one rank of phase_seqstage
        return seqstage_rank(sys.argv[2])
    if sys.argv[1:2] == [EXPERTMODEL_FLAG]:  # one rank of phase_expertmodel
        return expertmodel_rank(sys.argv[2])
    if sys.argv[1:2] == [SHARDED_FLAG]:  # one rank of phase_sharded
        return sharded_rank(sys.argv[2], sys.argv[3])
    from p2pfl_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hub_offline()
    time_phases()
    try:
        card = phase_env()
        rows = phase_kernels()
        rows.update(phase_carry())
        profiling = "--profile" in sys.argv[1:]
        launches, sim = phase_slice()
        if profiling:
            phase_profile("slice: one round", lambda: sim.run(rounds=1, warmup=False))
        del sim
        gc.collect()  # the population's state must not count in the ring's peak memory
        # Early in the process: its later profiler sessions were seen to record no kernel.
        phase_telemetry(card)
        gc.collect()
        ring_launches, ring_step = phase_ring()
        launches.update(ring_launches)
        if profiling:
            phase_profile("ring: one train step", ring_step)
        del ring_step
        gc.collect()
        rows.update(phase_kernels_narrow())
        rows.update(phase_kernels_classifier())
        rows.update(phase_kernels_c1())
        rows.update(phase_kernels_wide("d256", D256_HEAD_DIMS, 16))
        rows.update(phase_kernels_wide("d512", D512_HEAD_DIMS, 18))
        rows.update(phase_kernels_chunked())
        phase_carry_one_launch()
        launches.update(phase_narrow_paths())
        launches.update(phase_wide_paths())
        launches.update(phase_chunked_paths())
        parts = mlp_partitions()
        phase_mlp(parts, profiling)
        phase_cnn(parts)
        launches.update(phase_classifier())
        phase_options(parts)
        fitted, anchor = phase_learner()
        phase_wire(fitted, anchor)
        phase_transport(fitted, anchor, card)
        phase_native(card, fitted)
        del fitted, anchor
        gc.collect()
        phase_node(card)
        gc.collect()
        phase_secagg(card)
        gc.collect()
        phase_recovery(card)
        gc.collect()
        phase_population(card)
        gc.collect()
        phase_asyncpop(card)
        gc.collect()
        phase_topk_ties()
        phase_parity()
        phase_campaign(card)
        gc.collect()
        multirank_launches = phase_multirank(card)
        gc.collect()
        seqstage_launches = phase_seqstage(card)
        gc.collect()
        multirank_launches.update(phase_expertmodel(card))
        gc.collect()
        multirank_launches.update(phase_sharded(card))
        gc.collect()
        rows.update(phase_kernels_longcontext())
        launches.update(phase_longcontext())
        phase_entry()
        phase_cifar(profiling)
        gc.collect()
        moe_launches = phase_moe(profiling)
        gc.collect()
        rows.update(phase_kernels_pipeline())
        launches.update(phase_pipeline())
        phase_dryrun()
        phase_sdpa_kernels(rows)
        phase_sass(_kernels.library_path(), _kernels._find_nvcc())  # last: see the docstring's phase 1
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    kernels = {**KERNEL_ROWS, **RING_KERNEL_ROWS}
    # Rows 1-5 at head size 64: launches on the slice (the carry: the ring);
    # rows 1-4 also carry the MoE LM's launches at the same shapes, and the
    # launches of each rank of the nodes, expert and model axes' arms and of
    # the sharded checkpoints' worlds (sharded_<arm>_<world>_<backend><W>);
    # the carry those of each rank of the ring over ranks.
    table = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **({"launches_moe": moe_launches[name]} if name in moe_launches else {}),
         "launches_per_rank": ({arm: counts[name] for arm, counts in multirank_launches.items()}
                               if name in KERNEL_ROWS else seqstage_launches[name]),
         **rows[name]}
        for name, (replaces, _, source) in kernels.items()
    ]
    # The narrow rows: the bf16 forward on SOURCE_FWD_NARROW, the backward
    # pair on SOURCE_BWD_NARROW and the carry on SOURCE_CARRY_NARROW at the
    # true D; the f32 numbers beside them are the CUDA-core instances of
    # SOURCE_F32.
    table += [
        {"name": name + narrow_suffix(d), "route": "cuda", "source": row_source(name, d, source), "replaces": replaces,
         "launches": launches[name + narrow_suffix(d)], **rows[name + narrow_suffix(d)], "source_f32": SOURCE_F32}
        for d in NARROW_HEAD_DIMS for name, (replaces, _, source) in kernels.items()
    ]
    # Head sizes 48, 128, 256, 512 and 1024: bf16 at 48 the forward on
    # SOURCE_FWD_NARROW, the backward pair on SOURCE_BWD_NARROW and the carry
    # on SOURCE_CARRY_NARROW, the forward at 128 and 256 on
    # SOURCE_FWD_WIDE's and the backward pair on SOURCE_BWD_WIDE's, the
    # forward at 512 and 1024 on SOURCE_FWD_GROUPED's and the backward pair on
    # SOURCE_BWD_GROUPED's, the carry from 128 on SOURCE_CARRY_GROUPED's; f32
    # on SOURCE_F32's instances, at 1024 on SOURCE_CHUNKED's.
    table += [
        {"name": name + narrow_suffix(d), "route": "cuda", "source": row_source(name, d, source),
         "replaces": replaces, "launches": launches[name + narrow_suffix(d)], **rows[name + narrow_suffix(d)],
         "source_f32": SOURCE_CHUNKED if d > _kernels.MAX_HEAD_DIM else SOURCE_F32}
        for d in (*C1_HEAD_DIMS, *D256_HEAD_DIMS, *D512_HEAD_DIMS, *D1024_HEAD_DIMS)
        for name, (replaces, _, source) in kernels.items()
    ]
    # The classifier's (D 32) and the longcontext example's (D 16) shapes,
    # the forward on SOURCE_FWD_NARROW and the backward pair on
    # SOURCE_BWD_NARROW, as their paths run them, and the pipeline's
    # microbatches (D 64), with each stage rank's launches.
    table += [
        {"name": name + suffix, "route": "cuda", "source": row_source(name, d, source), "replaces": replaces,
         "launches": launches[name + suffix], **rows[name + suffix],
         **({"launches_per_rank": seqstage_launches[name + suffix]} if suffix == PP_SUFFIX else {})}
        for suffix, d in ((CLS_SUFFIX, 32), (LC_SUFFIX, 16), (PP_SUFFIX, 64))
        for name, (replaces, _, source) in KERNEL_ROWS.items()
    ]
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
